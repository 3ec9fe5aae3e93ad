"""The routes of the port's embedding kernels, checked on the CPU.

``ops.gather_route`` sends every full-width table of the repo's models to
the bulk kernel (csrc/embed_gather_bulk.cu) and the rows it cannot take
(not whole 16-byte units, too wide, a misaligned base) to the element
kernel. ``ops.scatter_partition`` cuts [0, Vs) into the one-pass scatter's
block ranges, which must cover every row exactly once. Plain emulations of
both kernels' index schedules check them, and the wrapper's CPU path
(the plain scatter) equals the JAX reference and its Pallas kernel in
interpret mode for ids out of order and for a buffer with no owned id.
The kernels themselves run only on the card (chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embed_scatter import embed_scatter_add as pallas_scatter
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.weights import to_torch

THREADS = 256          # csrc/embed_scatter_fused.cu kThreads


@pytest.mark.parametrize("arch", ["parallax-lm", "phi3-medium-14b",
                                  "rwkv6-7b"])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_full_width_tables_take_the_bulk_route(arch, itemsize):
    row_bytes = get_config(arch).d_model * itemsize
    assert ops.gather_route(row_bytes, 0) == "bulk"
    assert ops.gather_route(row_bytes, 1 << 20) == "bulk"


@pytest.mark.parametrize("row_bytes,ptr", [
    (200, 0),             # E = 100 in bf16: not whole 16-byte units
    (8, 0),               # narrower than one unit
    (32768 + 16, 0),      # wider than the bulk ring's slots allow
    (1024, 2),            # the main path's row, a base off by one bf16
    (10240, 8)])          # phi3's row, a base off by one 8-byte word
def test_other_rows_take_the_element_route(row_bytes, ptr):
    assert ops.gather_route(row_bytes, ptr) == "element"


def test_a_view_off_a_16_byte_boundary_takes_the_element_route():
    buf = torch.zeros(64 * 512 + 1, dtype=torch.bfloat16)
    aligned = buf[:64 * 512].view(64, 512)
    shifted = buf[1:].view(64, 512)
    assert ops.gather_route(1024, aligned.data_ptr()) == "bulk"
    assert ops.gather_route(1024, shifted.data_ptr()) == "element"


def _ranges(vs, e, n):
    per_block, grid = ops.scatter_partition(vs, e, n)
    # the kernel's rule: block b owns [b * R, min((b + 1) * R, Vs))
    return per_block, grid, [(b * per_block, min((b + 1) * per_block, vs))
                             for b in range(grid)]


@pytest.mark.parametrize("vs,e,n", [
    (800_000, 512, 2560),     # the main path's table and dedupe buffer
    (0, 512, 2560),           # an empty shard: no block
    (5, 512, 2560),           # fewer rows than one block holds
    (1000, 512, 2560),        # a ragged last block (31 of 32 rows, then 8)
    (1000, 100, 7),           # a narrow row: more rows per block
    (3, 70_000, 1),           # a row wider than a block's 64 KB
    (800_000, 512, 1_000_000),    # many ids: blocks grow with N
    (10_000_000, 512, 10_000_000)])   # ... up to the 8,192-row map
def test_scatter_partition_covers_each_row_once(vs, e, n):
    per_block, grid, ranges = _ranges(vs, e, n)
    assert 1 <= per_block <= 8192
    covered = np.zeros(vs, np.int8)
    for lo, hi in ranges:
        assert lo < hi, "an empty block"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert grid == -(-vs // per_block)
    # a block reads at most a quarter of its output bytes in ids, unless
    # the map's cap stops it
    assert 16 * n <= per_block * 4 * e or per_block == 8192


def test_scatter_partition_at_the_main_path():
    assert ops.scatter_partition(800_000, 512, 2560) == (32, 25_000)


def test_scatter_partition_refuses_a_bad_request():
    with pytest.raises(ValueError):
        ops.scatter_partition(-1, 8, 4)
    with pytest.raises(ValueError):
        ops.scatter_partition(8, 0, 4)


@pytest.mark.parametrize("e", [1, 4, 100, 512, 1284, 4096])
@pytest.mark.parametrize("count", [1, 3, 32, 33])
def test_scatter_walk_writes_each_unit_once(e, count):
    """The one-pass kernel's write loop (warp w of kThreads / 32 takes rows
    w, w + 8, ...; lane l stores units l, l + 32, ... of a row: 4 floats
    where E % 4 == 0, else 1), emulated: every unit of the block's range
    is stored once."""
    units = e // 4 if e % 4 == 0 else e
    seen = np.zeros((count, units), np.int64)
    for t in range(THREADS):
        for r in range(t >> 5, count, THREADS // 32):
            for c in range(t & 31, units, 32):
                seen[r, c] += 1
    assert (seen == 1).all()


def _bulk_launch(n, row_bytes, sms=132):
    """The bulk kernel's host sizing (repro_embed_gather_bulk), emulated:
    (lanes per block, grid, dynamic shared memory per block)."""
    lanes = min(-(-n // sms), (232448 - 1024 - 256 - row_bytes) // row_bytes,
                32)
    smem = 256 + row_bytes * (1 + lanes)
    per_sm = min(232448 // (smem + 1024), 32)
    return lanes, min(-(-n // lanes), sms * per_sm), smem


@pytest.mark.parametrize("n,row_bytes,path", [
    (2560, 1024, True),                           # the main path
    (2048, 10240, True), (4, 10240, True),        # phi3 prefill and decode
    (2048, 8192, True), (4, 8192, True),          # rwkv6 prefill and decode
    (2048, 20480, False), (300, 400, False), (1, 16, False),
    (1, 32768, False), (200_000, 32768, False), (1_000_000, 1024, False)])
def test_gather_copiers_take_each_id_once(n, row_bytes, path):
    """Lane l of block b copies ids q, q + Q, ... (q = b * L + l, Q = G * L):
    every id exactly once, each block within the shared memory a block may
    use, and at the paths' shapes one id per copier."""
    lanes, grid, smem = _bulk_launch(n, row_bytes)
    assert 1 <= lanes <= 32 and smem <= 232448 - 1024
    copies = np.zeros(n, np.int64)
    nq = grid * lanes
    for q in range(min(nq, n)):
        copies[q::nq] += 1
    assert (copies == 1).all()
    assert nq >= n or not path


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["owned_out_of_order", "no_owned_id",
                                  "half_owned_shuffled"])
def test_scatter_without_sorted_ids_matches_reference_and_pallas(case,
                                                                 dtype):
    """ops.embed_scatter_add on the CPU, the reference's oracle and its
    Pallas kernel agree bit for bit on dedupe buffers in any order: owned
    ids shuffled with unowned ones; a ps shard that owns none of them (M =
    8, the ids of other shards only); half owned, shuffled (M = 2)."""
    vs, e, n = 48, 16, 40
    rng = np.random.default_rng(sum(map(ord, case + dtype)))
    if case == "owned_out_of_order":
        ids = rng.permutation(np.concatenate([
            rng.choice(vs, 30, replace=False), [-3, -1, vs, vs + 5,
                                                2 * vs, 2 * vs, 2 * vs,
                                                2 * vs, 2 * vs, 2 * vs]]))
    elif case == "no_owned_id":
        ids = np.sort(rng.choice(7 * vs, n, replace=False)) + vs
    else:
        ids = rng.permutation(rng.choice(2 * vs, n, replace=False))
    ids = ids.astype(np.int32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jrows = jnp.asarray(rng.standard_normal((n, e)).astype(np.float32)) \
        .astype(jdt)
    want = jref.embed_scatter_add_ref(jnp.asarray(ids), jrows, vs)
    pallas = pallas_scatter(jnp.asarray(ids), jrows, vs, interpret=True)
    got = ops.embed_scatter_add(torch.from_numpy(ids),
                                to_torch(np.asarray(jrows), "cpu"), vs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (vs, e)
    assert _bits(got) == _bits(want) == _bits(pallas)
    owned = ((ids >= 0) & (ids < vs)).sum()
    assert (np.abs(np.asarray(want)).sum(1) > 0).sum() == owned
