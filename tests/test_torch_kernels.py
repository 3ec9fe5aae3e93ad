"""The port's plain embedding gather/scatter equal the JAX package's oracles
(kernels/ref.py) AND its Pallas kernels in interpret mode, bit for bit, at
f32 and bf16. The CUDA kernels themselves run only on the card
(chip_smoke.py holds them against these plain versions there); here the
wrappers must take the plain path for CPU tensors and refuse anything they
cannot launch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embed_gather import embed_gather as pallas_gather
from repro.kernels.embed_scatter import embed_scatter_add as pallas_scatter
from repro_torch import compat
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.weights import to_numpy, to_torch
from test_kernels import _deduped_ids

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _table(seed, vs, e, dtype):
    a = np.random.default_rng(seed).standard_normal((vs, e)).astype(np.float32)
    ja = jnp.asarray(a).astype(DTYPES[dtype][0])
    return ja, to_torch(np.asarray(ja), "cpu")


def _bits(x) -> np.ndarray:
    """Raw bytes of a jax array or tensor, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    a = np.asarray(x)
    return a.view(np.int16).tobytes() if a.dtype.name == "bfloat16" \
        else a.tobytes()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("vs,e,n,offset", [
    (16, 8, 12, 0), (64, 32, 40, 64), (33, 12, 20, 33), (40, 100, 9, 5)])
def test_gather_matches_reference_and_pallas(vs, e, n, offset, dtype):
    """Unowned ids on both sides of the shard, sentinels, E not a multiple
    of 8."""
    jt, tt = _table(vs * e + n, vs, e, dtype)
    ids = np.random.default_rng(n).integers(-vs, 3 * vs + offset, size=n)
    ids[-1] = 4 * vs + offset                     # a sentinel past the shard
    ids = ids.astype(np.int32)
    want = jref.embed_gather_ref(jt, jnp.asarray(ids), offset)
    pallas = pallas_gather(jt, jnp.asarray(ids), offset, interpret=True)
    got = ops.embed_gather(tt, torch.from_numpy(ids), offset)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (n, e)
    assert _bits(got) == _bits(want) == _bits(pallas)
    assert _bits(tref.embed_gather_ref(tt, torch.from_numpy(ids), offset)) \
        == _bits(want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("vs,e,n", [(16, 8, 8), (64, 32, 40), (33, 12, 20),
                                    (50, 100, 16)])
def test_scatter_matches_reference_and_pallas(vs, e, n, dtype):
    """Dedupe-buffer ids (sorted, unique among owned, with negatives,
    ids >= vs and sentinel padding) from the reference's own generator."""
    key = jax.random.key(vs * e + n)
    ids = np.array(_deduped_ids(jax.random.fold_in(key, 1), n, -vs, 2 * vs))
    rows = np.random.default_rng(vs + n).standard_normal((n, e)) \
        .astype(np.float32)
    jrows = jnp.asarray(rows).astype(DTYPES[dtype][0])
    want = jref.embed_scatter_add_ref(jnp.asarray(ids), jrows, vs)
    pallas = pallas_scatter(jnp.asarray(ids), jrows, vs, interpret=True)
    trows = to_torch(np.asarray(jrows), "cpu")
    got = ops.embed_scatter_add(torch.from_numpy(ids), trows, vs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (vs, e)
    assert _bits(got) == _bits(want) == _bits(pallas)


def test_scatter_ref_accumulates_repeats_like_reference():
    """The plain scatter also serves the raw token stream (local_agg off),
    whose ids repeat: it must add in the reference's order."""
    rng = np.random.default_rng(0)
    ids = rng.integers(-3, 20, size=64).astype(np.int32)
    rows = rng.standard_normal((64, 6)).astype(np.float32)
    want = jref.embed_scatter_add_ref(jnp.asarray(ids), jnp.asarray(rows), 16)
    got = tref.embed_scatter_add_ref(torch.from_numpy(ids),
                                     torch.from_numpy(rows), 16)
    assert _bits(got) == _bits(want)


def test_cpu_path_does_not_count_launches():
    ops.reset_launch_counts()
    t = torch.zeros((4, 8))
    ids = torch.tensor([0, 3, 9], dtype=torch.int32)
    ops.embed_gather(t, ids)
    ops.embed_scatter_add(ids, torch.ones((3, 8)), 4)
    assert ops.launch_counts() == {"embed_gather": 0, "embed_scatter_add": 0,
                                   "flash_attention": 0,
                                   "flash_attention_tc": 0, "wkv": 0,
                                   "wkv_tc": 0, "wkv_step": 0}


@pytest.mark.parametrize("bad", ["ids_dtype", "ids_rank", "table_dtype",
                                 "table_rank"])
def test_gather_wrapper_refuses_what_the_kernel_does_not_take(bad):
    table = torch.zeros((8, 4))
    ids = torch.zeros(3, dtype=torch.int32)
    if bad == "ids_dtype":
        ids = ids.long()
    elif bad == "ids_rank":
        ids = ids.reshape(1, 3)
    elif bad == "table_dtype":
        table = table.double()
    else:
        table = table.reshape(-1)
    with pytest.raises(ValueError):
        ops.embed_gather(table, ids)


@pytest.mark.parametrize("bad", ["ids_len", "rows_dtype", "negative_vs"])
def test_scatter_wrapper_refuses_what_the_kernel_does_not_take(bad):
    ids = torch.zeros(3, dtype=torch.int32)
    rows = torch.zeros((3, 4))
    vs = 8
    if bad == "ids_len":
        ids = torch.zeros(2, dtype=torch.int32)
    elif bad == "rows_dtype":
        rows = rows.half()
    else:
        vs = -1
    with pytest.raises(ValueError):
        ops.embed_scatter_add(ids, rows, vs)


def test_wrappers_raise_off_cpu_without_a_kernel():
    """A tensor that is neither on the CPU nor on the card is refused, never
    routed to the plain version."""
    table = torch.zeros((8, 4), device="meta")
    ids = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        ops.embed_gather(table, ids)
    with pytest.raises(NotImplementedError):
        ops.embed_scatter_add(ids, torch.zeros((3, 4), device="meta"), 8)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """On a machine without the CUDA toolkit the kernel build fails loudly
    (the wrapper then raises); nothing pretends to run the kernel."""
    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("embed_gather")


def test_library_names_carry_the_source_hash():
    a = _build.library_path("embed_gather")
    b = _build.library_path("embed_scatter_add")
    assert a.parent == b.parent == _build.BUILD_DIR
    assert a.name.startswith("embed_gather-") and a.suffix == ".so"
    assert a != b


def test_to_torch_round_trips_bf16_bits():
    a = jnp.asarray(np.random.default_rng(1).standard_normal(33)
                    .astype(np.float32)).astype(jnp.bfloat16)
    t = to_torch(np.asarray(a), "cpu")
    assert t.dtype == torch.bfloat16
    assert _bits(t) == _bits(a)
    np.testing.assert_array_equal(to_numpy(t), np.asarray(a, np.float32))
