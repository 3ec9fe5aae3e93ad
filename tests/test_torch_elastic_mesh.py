"""The elastic half on gloo process meshes (runtime/trainer.py,
launch/mesh.py), against the JAX package where it runs here:

* ``shrink_mesh`` / ``grow_mesh`` on (4, 2) ranks: the kept ranks keep
  their positions, the round trip restores the grid, the new meshes'
  groups work, floors and overlaps as the reference's;
* the reference's reprice scenario (reduced phi3 at vocab 256, α 0.3,
  (4, 1) -> (3, 1)): ``allreduce`` -> ``mpi_gatherv``; the losses within
  rtol 1e-5 of the JAX package's run from the same step-0 state, and the
  plans at both world sizes equal to the reference's;
* the auto-remesh on a sustained straggle ((4, 2) -> (3, 2)): the
  pre-remesh losses bit for bit a never-straggled run's, the rest within
  the reference's 5e-2, the first post-remesh step bit for bit a fresh
  trainer's on the shrunk mesh from the same state; throughput recovers;
* the evict -> readmit -> restore cycle of the reference's
  ``test_manifest_plan_restore_across_a_grow`` (which fails on this JAX);
* ``Trainer.heartbeat_fn``: the same injected per-slot beats on (4, 1)
  name the same slice at the same steps in both packages, and the port
  evicts it at the reference's escalation step;
The attribution, the re-admission inside a run and the jitter fallback
are the elastic benchmark's phases: tests/test_torch_elastic_bench.py.

Rank functions in tests/_torch_elastic_ranks.py.
"""
import numpy as np
import pytest
import torch

import _torch_elastic_ranks as ER
from conftest import distributed_run
from repro_torch.launch.mesh import spawn

pytestmark = pytest.mark.distributed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shrink_and_grow_on_process_groups():
    out = spawn(ER.shrink_grow, 8, "gloo", timeout=120)
    for r, o in enumerate(out):
        assert o["m3"] == [[0, 1], [4, 5], [6, 7]]
        assert o["m3_shape"] == {"data": 3, "model": 2}
        assert o["m3_member"] == (r not in (2, 3))
        assert o["m4"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
        assert o["m4_coords"] == {"data": r // 2, "model": r % 2}
        assert o["m4_sum"] == sum(range(8))
        assert o["overlap_raises"] and o["floored"]
        # (3, 2)'s 2 data, 3 model and 1 whole-grid groups; of (4, 2)'s
        # the 2 data, the 1 model ([2, 3]) and the 1 whole-grid groups
        # (3, 2) lacks; nothing more on the second round trip
        assert o["groups_made"] == (10, 10) and o["groups_reused"]
        assert o["m4b_sum"] == sum(range(8))
    # each shrunk data group sums its model column's three kept ranks
    assert [out[r]["m3_sum"] for r in (0, 1, 4, 5, 6, 7)] == \
        [10.0, 13.0, 10.0, 13.0, 10.0, 13.0]
    assert out[4]["m3_coords"] == {"data": 1, "model": 0}


REPRICE_CODE = """
from repro.checkpoint.ckpt import save_checkpoint
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.core.runtime import Runtime
from repro.core.transform import analyze
from repro.data import SyntheticLM
from repro.launch.mesh import shrink_mesh
from repro.models.model import build_model
from repro.runtime.trainer import Trainer, TrainerConfig

cfg = reduced(get_config("phi3-medium-14b"), vocab=256)
shape = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
rc = RunConfig(attention_impl="naive", remat="none", param_dtype="float32",
               compute_dtype="float32", wire_dtype="float32",
               link_latency=0.0, table_alpha=(("embed", 0.3),))
ds = SyntheticLM(cfg.vocab_size, 32, 8)
mesh = make_mesh((4, 1), ("data", "model"))
t = Trainer(cfg, shape, rc, TrainerConfig(total_steps=2), ds, mesh=mesh)
save_checkpoint(CKPT, 0, t._canonical_state())
tables4 = t.plan.tables()
pre = []
with use_mesh(mesh):
    t.run(on_metrics=lambda s, m: pre.append(float(m["loss"])))
mesh3 = shrink_mesh(mesh, drop_axis_index=3)
rt3 = Runtime(cfg, rc, shape, mesh=mesh3)
fresh3 = analyze(build_model(cfg, rt3), rt3).tables()
t.remesh(mesh3)
t.tcfg = TrainerConfig(total_steps=4)
post = []
with use_mesh(mesh3):
    t.run(on_metrics=lambda s, m: post.append(float(m["loss"])))
print("RESULT:" + json.dumps({
    "tables4": tables4, "tables3": t.plan.tables(), "fresh3": fresh3,
    "pre": pre, "post": post}))
"""


def test_remesh_reprices_methods_like_the_reference(tmp_path):
    """α 0.3 on (D, 1): mpi_gatherv's 2(N-1)αb is dearer than the dense
    all-reduce's 2(N-1)/N·b at N = 4 and cheaper at N = 3, so the shrink
    flips the method, in both packages."""
    ref = distributed_run(REPRICE_CODE.replace("CKPT", repr(str(tmp_path))),
                          devices=8, timeout=600)
    out = spawn(ER.reprice, 4, "gloo", args=(str(tmp_path),), timeout=300)
    for o in out:
        assert o["method4"] == "allreduce"
        assert o["tables4"] == ref["tables4"]
        np.testing.assert_allclose(o["pre"], ref["pre"], rtol=1e-5)
    live = [o for o in out if o["live"]]
    assert [o["rank"] for o in live] == [0, 1, 2]
    assert out[3]["post"] == []                  # evicted: trains nothing
    for o in live:
        assert o["method3"] == "mpi_gatherv"
        assert o["shape3"] == {"data": 3, "model": 1}
        assert o["tables3"] == ref["tables3"] == ref["fresh3"]
        # 8 sequences do not divide 3 replicas: the batch axes fall back
        # to none and every rank runs the whole batch, as the reference's
        assert o["bucket3"] is None or o["bucket3"]["replicas"] == 1
        np.testing.assert_allclose([l for _, l in o["post"]], ref["post"],
                                   rtol=1e-5)


def test_auto_remesh_on_sustained_straggle_keeps_trajectory(tmp_path):
    base = spawn(ER.straggle, 8, "gloo", args=(False, None), timeout=300)
    out = spawn(ER.straggle, 8, "gloo", args=(True, str(tmp_path)),
                timeout=300)
    r = out[0]["remesh_at"]
    assert r >= ER.SLOW_FROM + 3                 # >= sustained slow steps
    for o in out:
        assert o["live"] == (o["rank"] < 6)      # data slice 3 evicted
        assert o["remesh_at"] == r
    lead, want = out[0], [h["loss"] for h in base[0]["hist"]]
    assert lead["remeshes"] == 1 and lead["step"] == ER.STEPS
    assert lead["mesh_after"] == {"data": 3, "model": 2}
    # re-priced for the smaller world: per-replica tokens grew
    assert lead["tables1"]["embed"]["capacity"] != \
        lead["tables0"]["embed"]["capacity"]
    assert lead["manifest"]["mesh"] == {"data": 4, "model": 2}
    assert "embed" in lead["manifest"]["plan"]
    assert lead["latest"] == ER.STEPS
    got = [h["loss"] for h in lead["hist"]]
    assert got[:r] == want[:r]                   # bit for bit
    assert max(abs(a - b) for a, b in zip(got[r:], want[r:])) < 5e-2
    # the first step on (3, 2) equals a fresh trainer's there from the
    # same state and plan
    assert abs(lead["fresh_loss"][0] - got[r]) <= 1e-6
    dts = [h["step_time_s"] for h in lead["hist"]]
    assert np.median(dts[r + 1:]) < 0.5 * np.median(dts[ER.SLOW_FROM:r])


def test_manifest_plan_restore_across_a_grow(tmp_path):
    out = spawn(ER.evict_readmit, 8, "gloo", args=(str(tmp_path),),
                timeout=300)
    for o in out:
        assert o["shrunk"] == {"data": 3, "model": 2}
        assert o["grown"] == {"data": 4, "model": 2}
        assert o["probation"] == 3               # the returned slice
        assert o["remeshes"] == 1 and o["regrows"] == 1
        assert o["evicted_left"] == 0 and o["step"] == 10
        assert o["latest"] == 10 and o["restored"] == 10
        assert o["cap_restored"] == o["cap_saved"] != o["cap_estimate"]
        assert len(o["after"]) == 2 and np.all(np.isfinite(o["after"]))
    assert out[0]["evicted"] == [6, 7]           # one (model = 2) slice
    assert [o["live_after_shrink"] for o in out] == [True] * 6 + [False] * 2
    # the evicted ranks train steps 1-4 and 9-10, the others every step,
    # and all agree
    lead = dict(out[0]["losses"])
    assert sorted(lead) == list(range(1, 11))
    for o in out[6:]:
        assert [s for s, _ in o["losses"]] == [1, 2, 3, 4, 9, 10]
        assert all(lead[s] == v for s, v in o["losses"])


BEAT_CODE = """
import inspect
import repro.runtime.monitor as M
from repro.configs import RunConfig, ShapeConfig, get_config, reduced
from repro.data import SyntheticLM
from repro.runtime.trainer import Trainer, TrainerConfig

class _Ticks:
    def __init__(self):
        self.t = 0.0
    def perf_counter(self):
        self.t += 0.005
        return self.t

M.time = _Ticks()
BEATS
cfg = reduced(get_config("phi3-medium-14b"), vocab=256)
shape = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
rc = RunConfig(attention_impl="naive", remat="none", param_dtype="float32",
               compute_dtype="float32", wire_dtype="float32",
               link_latency=0.0, heartbeat=True)
mesh = make_mesh((4, 1), ("data", "model"))
t = Trainer(cfg, shape, rc, TrainerConfig(total_steps=STEPS),
            SyntheticLM(cfg.vocab_size, 32, 8), mesh=mesh)
t.monitor.sustained = 3
t.monitor.min_samples = 4
t.heartbeat_fn = slow_slot_beats
hist = []
with use_mesh(mesh):
    t.run(on_metrics=lambda s, m: hist.append(
        [s, m.get("straggler_slice"), t.monitor.remesh_suggested]))
print("RESULT:" + json.dumps({"hist": hist}))
"""


def test_heartbeat_fn_attributes_the_slice_the_reference_names():
    """The same injected per-slot beats (``Trainer.heartbeat_fn``) in both
    packages on (4, 1), with a steady monitor clock: the port names the
    same slice at each step and escalates at the same step as the
    reference, and evicts that slice there. (The reference's run does not
    remesh: its shrink fails on this JAX; the escalation and the slice
    are what it decides before the shrink.)"""
    import inspect
    code = BEAT_CODE.replace("BEATS", inspect.getsource(ER.slow_slot_beats))
    ref = distributed_run(code.replace("STEPS", str(ER.BEAT_STEPS)),
                          devices=4, timeout=600)["hist"]
    out = spawn(ER.beat_attribution, 4, "gloo", timeout=300)
    at = next(s for s, _, hot in ref if hot)       # the first escalation
    assert dict((s, sl) for s, sl, _ in ref)[at] == 2
    for o in out:
        assert o["evicted"] == [[at, 2, 2]]          # step, index, slot
        assert o["live"] == (o["rank"] != 2)
    lead = out[0]
    assert lead["shape"] == {"data": 3, "model": 1}
    assert [h[:3] for h in lead["hist"] if h[0] < at] == \
        [h for h in ref if h[0] < at]
    assert next(h[0] for h in lead["hist"] if h[3]) == at
    assert lead["hist"][-1][3] == 1                  # one eviction
    assert lead["hist"][-1][0] == ER.BEAT_STEPS


def test_remesh_moves_zero1_state_whole():
    """Under ZeRO-1 the moments are cut over ``data``: a shrink gathers
    the leaving rank's blocks too and a grow hands the whole state back;
    the losses equal zero_stage 0's over the same schedule bit for bit."""
    zero = spawn(ER.zero_remesh, 2, "gloo", args=(1,), timeout=300)
    plain = spawn(ER.zero_remesh, 2, "gloo", args=(0,), timeout=300)
    assert zero[0]["zero_stage"] == 1 and plain[0]["zero_stage"] == 0
    assert zero[0]["losses"] == plain[0]["losses"]
    assert [s for s, _ in zero[0]["losses"]] == list(range(1, 7))
    assert [s for s, _ in zero[1]["losses"]] == [1, 2, 5, 6]


def test_stale_buffers_ride_zero1_and_the_fused_apply():
    """The stale flip and its drain under ZeRO-1 equal zero_stage 0's
    fused apply bit for bit; the buffer holds the last aggregate inside
    the window and is zero after the drain."""
    zero = spawn(ER.stale_zero, 2, "gloo", args=(1,), timeout=300)
    fused = spawn(ER.stale_zero, 2, "gloo", args=(0,), timeout=300)
    for z, f in zip(zero, fused):
        assert z["zero_stage"] == 1 and f["fused"] and not z["fused"]
        assert z["losses"] == f["losses"]
        assert z["ages"] == f["ages"] == [None, None, 1, 1, None, None]
        assert z["buffered"] > 0 and z["drained"] == f["drained"] == 0.0
