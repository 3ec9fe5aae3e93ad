"""The slice as a whole: ``get_runner(reduced parallax-lm, ...).run(batch)``
in the port against the JAX package's runner, from the same parameters and
batches, over 3 steps.

Tolerances: at f32 (param and compute dtype f32, OPSW on) the losses agree
to rtol 1e-5 — GEMM summation order differs, and Adam turns those last
bits into slightly different updates. At the default bf16 they agree to
2e-2. The census metrics (embed_rows/_unique/_dropped) are equal."""
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.transform import get_runner as jget_runner
from repro.data import SyntheticLM
from repro.utils.tree import named_leaves
import repro_torch.configs as tc
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import get_runner
from repro_torch.utils.tree import named_parameters
from repro_torch.weights import load_reference_params

SEQ, BATCH, STEPS = 16, 4, 3
F32 = dict(param_dtype="float32", compute_dtype="float32")
CASES = {
    "f32": (F32, 1e-5),
    "bf16_default": ({}, 2e-2),
    "f32_no_local_agg": (dict(F32, local_agg=False), 1e-5),
    "f32_capped_drops": (dict(F32, capacity_mode="capped",
                              capacity_factor=0.5, zipf_a=1.3), 1e-5),
    "f32_momentum_ema": (dict(F32, optimizer="momentum", ema_decay=0.9,
                              learning_rate=1e-2), 1e-5),
    "f32_no_opsw": (dict(F32, opsw=False), 1e-5),
}
METRICS = ("embed_rows", "embed_unique", "embed_dropped")


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_reference(case):
    kw, rtol = CASES[case]
    jcfg = reduced(get_config("parallax-lm"))
    jr = jget_runner(jcfg, ShapeConfig("t", SEQ, BATCH, "train"),
                     RunConfig(**kw), seed=0)
    named = {n: np.asarray(a) for n, a in named_leaves(jr.state.params)}
    tr = get_runner(tc.reduced(tc.get_config("parallax-lm")),
                    tc.ShapeConfig("t", SEQ, BATCH, "train"),
                    tc.RunConfig(**kw), device="cpu",
                    params=load_reference_params(named, "cpu"))
    assert tr.plan.tables() == jr.plan.tables()
    ds = SyntheticLM(jcfg.vocab_size, SEQ, BATCH, seed=0)
    dropped = 0.0
    for i in range(STEPS):
        batch = ds.batch(i)
        jm, tm = jr.run(batch), tr.run(batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=rtol, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                                   rtol=rtol, err_msg=f"step {i}")
        for k in METRICS:
            assert float(tm[k]) == float(jm[k]), (i, k)
        dropped += float(tm["embed_dropped"])
        assert tr.state.step == i + 1
    if case == "f32_capped_drops":
        assert dropped > 0          # the capped buffer really overflowed


def test_seeded_init_is_deterministic():
    cfg = tc.reduced(tc.get_config("parallax-lm"))
    shape = tc.ShapeConfig("t", 8, 2, "train")
    a, b, c = (get_runner(cfg, shape, tc.RunConfig(), seed=s, device="cpu")
               for s in (0, 0, 1))
    pa, pb, pc = (named_parameters(r.model) for r in (a, b, c))
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert not torch.equal(pa["embed"], pc["embed"])
    assert torch.count_nonzero(pa["layers.bias"]) == 0   # zeros init


@pytest.mark.parametrize("kw,where", [
    (dict(heartbeat=True), "slice 7"),
    (dict(max_staleness=2), "slice 7"),
    (dict(kernel_autotune=True), "slice 8"),
    (dict(verify_contract=True), "slice 8"),
])
def test_unported_options_are_refused(kw, where):
    with pytest.raises(NotImplementedError, match=where):
        get_runner(tc.reduced(tc.get_config("parallax-lm")),
                   tc.ShapeConfig("t", 8, 2, "train"), tc.RunConfig(**kw),
                   device="cpu")


def test_mesh_is_refused():
    """What is not a process mesh is refused: an object that is no mesh,
    and a MeshShape, which plans (analyze) but holds no process groups.
    Meshes run in tests/test_torch_mesh_correctness.py."""
    from repro_torch.launch.mesh import MeshShape
    cfg = tc.reduced(tc.get_config("parallax-lm"))
    shape = tc.ShapeConfig("t", 8, 2, "train")
    with pytest.raises(TypeError, match="launch/mesh.py"):
        get_runner(cfg, shape, tc.RunConfig(), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="make_mesh"):
        get_runner(cfg, shape, tc.RunConfig(),
                   mesh=MeshShape((2, 2), ("data", "model")), device="cpu")


def test_device_defaults_to_the_card():
    """No device means the card; without one the runner fails rather than
    moving to the CPU on its own."""
    cfg = tc.reduced(tc.get_config("parallax-lm"))
    shape = tc.ShapeConfig("t", 8, 2, "train")
    rt = Runtime(cfg, tc.RunConfig(), shape)
    assert rt.device == torch.device("cuda")
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        get_runner(cfg, shape, tc.RunConfig())
