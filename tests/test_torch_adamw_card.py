"""The AdamW kernels of csrc/adamw.cu on the card: ``ops.adamw_update_``
bit for bit against the eager chain it replaces (``ref.adamw_update_ref``
run on the same card, the same clip factor given to both) at parallax-lm's
and phi3-medium-14b's largest leaves, over odd sizes at misaligned offsets
(a bucket segment) in every dtype pair, and through the optimizer
(``update`` against ``update_fused`` on one bucket plan); ``ops.
grad_sq_norm`` within 1e-6 of an f64 sum, the same bits run after run and
at any alignment. Every test needs a card and skips without one: the
kernels have no CPU or interpret mode (tests/test_torch_optim.py holds
their plain versions on the CPU). On the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_adamw_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import buckets
from repro_torch.kernels import ops, ref
from repro_torch.optim.optimizer import adamw, fuse_state, unfuse_state

pytestmark = pytest.mark.card

B1, B2, EPS, LR = 0.9, 0.95, 1e-8, 1e-3
# the two cells' largest leaves: parallax-lm's (800,000, 512) tables and
# phi3-medium-14b's MLP weight stacked over 8 layers
BIG = {"lm1b_table": (800_000, 512), "phi3_mlp": (8, 5120, 17920)}
DT = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/adamw.cu has no CPU or "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _corrections(step: int) -> tuple:
    t = torch.tensor(step, dtype=torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    return (float(1.0 - f32(B1) ** t), float(1.0 - f32(B2) ** t))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    torch.cuda.synchronize()
    if not torch.equal(_bits(a), _bits(b)):
        diff = int((_bits(a) != _bits(b)).sum())
        raise AssertionError(f"{what}: {diff} of {a.numel()} elements "
                             "differ in their bits")


def _offset(n: int, dtype, off: int, dev) -> torch.Tensor:
    """n elements of ``dtype`` starting ``off`` elements into a buffer
    (off 0: a 16-byte aligned base)."""
    return torch.empty(n + off, dtype=dtype, device=dev)[off:]


def _steps(p, m, v, gdt, steps, *, clip, wd, gen, out_gdt=None):
    """``steps`` updates of the kernel on (p, m, v) and of the eager chain
    on a copy, the same gradients and clip factor to both; compared after
    step 1 and after the last."""
    want = [t.clone() for t in (p, m, v)]
    scale = torch.tensor(0.37, device=p.device) if clip else None
    for step in range(1, steps + 1):
        g = torch.randn(p.shape, generator=gen, device=p.device).mul_(3.0)
        g = g.to(gdt)
        bc1, bc2 = _corrections(step)
        kw = dict(scale=scale, bc1=bc1, bc2=bc2, lr=LR, wd=wd, b1=B1,
                  b2=B2, eps=EPS)
        ops.adamw_update_(p, g, m, v, gdt=out_gdt, **kw)
        ref.adamw_update_ref(*want[:1], g, *want[1:],
                             gdt=out_gdt or g.dtype, **kw)
        del g
        if step in (1, steps):
            for name, a, b in zip("pmv", (p, m, v), want):
                _same(a, b, f"step {step}: {name}")


@pytest.mark.parametrize("case", ["clip", "no_clip_wd"])
@pytest.mark.parametrize("leaf", list(BIG))
def test_update_is_the_eager_chain_at_the_cells_leaves(dev, leaf, case):
    """bf16 p and g, f32 m and v at a cell's largest leaf: p, m, v after 1
    and 10 steps equal the eager chain's bit for bit (the cells' own
    config clips and does not decay; the other case decays unclipped)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = BIG[leaf]
    p = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    m = torch.zeros(shape, device=dev)
    v = torch.zeros(shape, device=dev)
    launches = ops.adamw_update_.launches
    _steps(p, m, v, torch.bfloat16, 10, clip=case == "clip",
           wd=None if case == "clip" else 0.01, gen=gen)
    assert ops.adamw_update_.launches - launches == 10


@pytest.mark.parametrize("gdt", ["own", "to_p"])
@pytest.mark.parametrize("pair", ["bf16_bf16", "bf16_f32", "f32_bf16",
                                  "f32_f32"])
@pytest.mark.parametrize("offsets", [(0, 3), (1, 3), (0, 0), (2, 5)])
def test_update_at_odd_sizes_and_misaligned_offsets(dev, pair, gdt,
                                                    offsets):
    """1,000,003 elements, p at ``offsets[0]`` and g, m, v at
    ``offsets[1]`` elements into their buffers (a bucket member's segment:
    its own parameter, slices of the flat wire and moment buffers), every
    (p, g) dtype pair, the gradient held in its own dtype or cast to p's:
    3 clipped, decayed steps equal the eager chain's bit for bit."""
    pdt, g_dt = (DT[x] for x in pair.split("_"))
    n, (po, so) = 1_000_003, offsets
    gen = torch.Generator(device=dev).manual_seed(7)
    p = _offset(n, pdt, po, dev)
    p.copy_(torch.randn(n, generator=gen, device=dev))
    m, v = _offset(n, torch.float32, so, dev), _offset(n, torch.float32, so,
                                                        dev)
    m.copy_(torch.randn(n, generator=gen, device=dev).mul_(0.01))
    v.copy_(torch.rand(n, generator=gen, device=dev).mul_(0.01))
    _steps(p, m, v, g_dt, 3, clip=True, wd=0.01, gen=gen,
           out_gdt=pdt if gdt == "to_p" else None)


def test_update_through_non_contiguous_views(dev):
    """p, m and v as transposed views (a remesh or a restore may hand over
    views): the kernel writes through them, bit for bit the eager chain's,
    each still the same storage."""
    gen = torch.Generator(device=dev).manual_seed(9)
    shape = (517, 300)
    p = torch.randn(shape[::-1], generator=gen, device=dev).to(
        torch.bfloat16).t()
    m = torch.zeros(shape[::-1], device=dev).t()
    v = torch.zeros(shape[::-1], device=dev).t()
    ptrs = [t.data_ptr() for t in (p, m, v)]
    assert not p.is_contiguous()
    _steps(p, m, v, torch.bfloat16, 3, clip=True, wd=0.01, gen=gen)
    assert [t.data_ptr() for t in (p, m, v)] == ptrs


SHAPES = {"a": (1001, 3), "b": (7,), "c": (64, 33), "d": (4099,),
          "table": (300, 16)}
NAMES = list(SHAPES)
BUCKET_IDX = [(3, 2), (1, 0)]


def _bucket_plan() -> buckets.BucketPlan:
    bs = []
    for idx in BUCKET_IDX:
        sizes = tuple(int(np.prod(SHAPES[NAMES[i]])) for i in idx)
        bs.append(buckets.Bucket(key=("allreduce", "bfloat16", ()), idx=idx,
                                 sizes=sizes, nbytes=sum(sizes) * 2))
    return buckets.BucketPlan(
        buckets=bs, batch_axes=("data",), replicas=4,
        n_params=sum(len(b.idx) for b in bs),
        wire_bytes=sum(b.nbytes for b in bs), bucket_bytes=1 << 20)


def test_update_equals_update_fused_on_a_bucket_plan(dev):
    """bf16 parameters and wire, clipping that acts and a weight-decay
    mask: 3 steps of ``update`` on the sliced-back gradients and of
    ``update_fused`` on the flat buffers (members at odd offsets) give the
    same grad norms, parameters and moments bit for bit, every leaf on
    the kernels."""
    bp = _bucket_plan()
    mask = {"a": 1.0, "b": 0.0, "c": 0.5, "d": 1.0, "table": 0.0}
    opt = adamw(1e-2, weight_decay=0.1, clip_norm=0.05, wd_mask=mask)

    def params():
        gen = torch.Generator(device=dev).manual_seed(0)
        return {n: torch.nn.Parameter(torch.randn(
            s, generator=gen, device=dev).to(torch.bfloat16))
            for n, s in SHAPES.items()}
    per = opt.init(params())
    fused = fuse_state(opt.init(params()), bp)
    ops.reset_launch_counts()
    for step in range(3):
        gen = torch.Generator(device=dev).manual_seed(100 + step)
        local = {n: torch.randn(s, generator=gen, device=dev).to(
            torch.bfloat16) for n, s in SHAPES.items()}
        bufs, grads = [], {"table": local["table"]}
        for b in bp.buckets:
            members = [local[NAMES[i]] for i in b.idx]
            buf = buckets._flat_wire(b, members, 1.0)
            bufs.append(buf)
            for i, g in zip(b.idx, buckets._slice_back(b, buf, members)):
                grads[NAMES[i]] = g
        grads = {n: grads[n] for n in NAMES}
        per, m1 = opt.update(per, grads)
        fused, m2 = opt.update_fused(fused, grads, bufs, bp)
        _same(m1["grad_norm"], m2["grad_norm"], f"step {step}: grad_norm")
        assert float(m1["grad_norm"]) > 0.05          # clipping acts
    counts = ops.launch_counts()
    assert counts["adamw_update_"] == counts["grad_sq_norm"] \
        == 2 * 3 * len(NAMES)
    back = unfuse_state(fused, bp)
    for n in NAMES:
        _same(fused.params[n], per.params[n], f"param {n}")
        _same(back.m[n], per.m[n], f"m {n}")
        _same(back.v[n], per.v[n], f"v {n}")


@pytest.mark.parametrize("case", ["lm1b_table_bf16", "phi3_mlp_bf16",
                                  "odd_f32", "odd_bf16"])
def test_norm_partial_within_1e6_of_an_f64_sum(dev, case):
    gen = torch.Generator(device=dev).manual_seed(11)
    if case.startswith("odd"):
        shape, dtype = (1_000_003,), DT[case.split("_")[1]]
    else:
        shape, dtype = BIG[case.removesuffix("_bf16")], torch.bfloat16
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    got = ops.grad_sq_norm(g)
    want = float(g.double().square().sum())
    assert got.dtype == torch.float32 and got.dim() == 0
    rel = abs(float(got) - want) / want
    assert rel <= 1e-6, (case, float(got), want, rel)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_norm_repeats_bit_for_bit_at_any_alignment(dev, dtype):
    """Two runs on one leaf, and runs on copies of it 1 and 3 elements
    past a 16-byte boundary (a bucket segment's view), give one bit
    pattern; small sizes and a single element too."""
    gen = torch.Generator(device=dev).manual_seed(13)
    for n in (50_000_017, 4099, 9, 1):
        g = torch.randn(n, generator=gen, device=dev).to(DT[dtype])
        first = ops.grad_sq_norm(g)
        _same(ops.grad_sq_norm(g), first, f"n {n}: second run")
        for off in (1, 3):
            view = _offset(n, g.dtype, off, dev)
            view.copy_(g)
            _same(ops.grad_sq_norm(view), first, f"n {n}: offset {off}")
