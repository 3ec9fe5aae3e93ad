"""The arithmetic of the WKV kernels' bf16 tensor-core route
(kernels/csrc/wkv_tc.cu) and one-token step route (kernels/csrc/wkv_step.cu),
which run only on the card, written out here in plain PyTorch and held
against the JAX package's Pallas kernel (interpret mode), the model's
``_chunk_wkv``, and the port's ``wkv_chunked_ref`` and ``wkv_ref``; the
wrapper's route choice, its alignment check, its launch counts and the
build's header hashing.

``tc_emulation`` follows the tc kernel step by step: chunks of
C = min(chunk, S) tokens padded with zero rows to a multiple of 16, f32
cumsum and factors with the reference's clamps, every f32 operand of a
product split into a bf16 hi and lo part (lo = bf16(x - hi)), each product
as hi hi + lo hi + hi lo (two terms where the other operand is v, exact in
bf16) with f32 accumulation, A masked to its strictly lower part before its
split, the output rounded to bf16 once. It lives in this file only; no path
runs it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.wkv import wkv as pallas_wkv
from repro.models.rwkv import _chunk_wkv
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.weights import to_numpy, to_torch

BAR = 5e-2          # the reference tests' bf16 tolerance
CLAMP = 80.0


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _split_mm(a: torch.Tensor, b: torch.Tensor, *, split_b: bool = True,
              split: bool = True):
    """a @ b as the kernel issues it: bf16 hi and lo parts, hi hi + lo hi
    (+ hi lo), the lo terms summed apart, f32 accumulation. ``split=False``
    keeps the hi parts only: plain bf16 operands."""
    ah, bh = _bf(a), _bf(b)
    if not split:
        return ah @ bh
    al = _bf(a - ah)
    lo = al @ bh
    if split_b:
        lo = lo + ah @ _bf(b - bh)
    return ah @ bh + lo


def tc_emulation(r, k, v, lw, bonus, state, chunk: int = 32, *,
                 split: bool = True) -> tuple:
    """The tensor-core route's arithmetic on (B, S, H, 64) bf16 r, k, v and
    bf16|f32 lw; returns (out bf16, final state f32). ``split=False``
    models the same kernel with plain bf16 operands."""
    b, s, h, e = r.shape
    c = min(chunk, s)
    cp = -(-c // 16) * 16
    rt, kt, vt, lt = (x.float().permute(0, 2, 1, 3) for x in (r, k, v, lw))
    u = bonus.float()[None, :, None, :]
    st = state.float().clone()
    lower = torch.tril(torch.ones((cp, cp), dtype=torch.bool), diagonal=-1)
    outs = []
    for t0 in range(0, s, c):
        n = min(c, s - t0)

        def tile(x):
            out = torch.zeros((b, h, cp, e))
            out[:, :, :n] = x[:, :, t0:t0 + n]
            return out
        rj, kj, vj, lj = (tile(x) for x in (rt, kt, vt, lt))
        cum = torch.cumsum(lj, dim=2)
        tot = cum[:, :, -1:]
        qf = rj * torch.exp(torch.clamp(cum - lj, -CLAMP, 0.0))
        kf = kj * torch.exp(torch.clamp(-cum, 0.0, CLAMP))
        kd = kj * torch.exp(torch.clamp(tot - cum, -CLAMP, CLAMP))
        a = torch.where(lower, _split_mm(qf, kf.transpose(-1, -2),
                                         split=split), 0.0)
        diag = torch.sum(rj * u * kj, dim=-1, keepdim=True)
        intra = _split_mm(a, vj, split_b=False, split=split) + diag * vj
        outs.append((_split_mm(qf, st, split=split) + intra)[:, :, :n])
        st = st * torch.exp(torch.clamp(tot, -CLAMP, 0.0)).transpose(-1, -2) \
            + _split_mm(kd.transpose(-1, -2), vj, split_b=False, split=split)
    out = torch.cat(outs, dim=2).permute(0, 2, 1, 3)
    return out.to(r.dtype), st


def step_formula(r, k, v, lw, bonus, state) -> tuple:
    """The step route's update for one token (S = 1): out_c = sum_e r_e
    S_ec + (sum_e r_e u_e k_e) v_c; S_ec <- S_ec exp(clip(lw_e, -80, 0)) +
    k_e v_c; f32 throughout, out in r's dtype."""
    r0, k0, v0, l0 = (x[:, 0].float() for x in (r, k, v, lw))   # (B, H, E)
    st = state.float()
    diag = torch.sum(r0 * bonus.float() * k0, dim=-1, keepdim=True)
    out = torch.einsum("bhe,bhec->bhc", r0, st) + diag * v0
    new = st * torch.exp(torch.clamp(l0, -CLAMP, 0.0))[..., None] \
        + k0[..., :, None] * v0[..., None, :]
    return out[:, None].to(r.dtype), new


def _inputs(seed, b, s, h, lw_dtype, e=64, decay=(0.5, -1.0), bonus=0.1,
            state=0.1, dtype="bfloat16"):
    """r, k, v (0.5 N), lw = -exp(a N + c), an f32 bonus and state, drawn
    with numpy as the reference's test_wkv_sweep draws them; r, k, v in
    ``dtype``, lw in ``lw_dtype``. Returns (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, e)).astype(np.float32) * 0.5
               for _ in range(3))
    a, c = decay
    lw = -np.exp(rng.standard_normal((b, s, h, e)).astype(np.float32) * a + c)
    u = rng.standard_normal((h, e)).astype(np.float32) * bonus
    st = rng.standard_normal((b, h, e, e)).astype(np.float32) * state
    jd = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
    ja = [jnp.asarray(x).astype(jd[dtype]) for x in (r, k, v)] + \
        [jnp.asarray(lw).astype(jd[lw_dtype]), jnp.asarray(u),
         jnp.asarray(st)]
    ta = [to_torch(np.asarray(x), "cpu") for x in ja]
    return ja, ta


def _close(got, want, tol=BAR):
    if isinstance(want, torch.Tensor):
        want = to_numpy(want)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# (b, h) for each sequence length: B 1-2, H 1-3
SHAPES = {2: (2, 3), 17: (1, 2), 31: (2, 1), 100: (1, 3), 200: (2, 2)}


@pytest.mark.parametrize("lw_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s", sorted(SHAPES))
@pytest.mark.parametrize("chunk", [16, 32, 48, 64])
def test_tc_arithmetic_within_the_bf16_bar(chunk, s, lw_dtype):
    b, h = SHAPES[s]
    ja, ta = _inputs(chunk + s, b, s, h, lw_dtype)
    out, st = tc_emulation(*ta, chunk=chunk)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, s, h, 64)
    assert st.dtype == torch.float32 and bool(torch.isfinite(st).all())
    want_o, want_s = pallas_wkv(*ja, chunk=chunk, interpret=True)
    _close(out, want_o)
    _close(st, want_s)
    mo, ms = _chunk_wkv(*ja, chunk)
    _close(out, mo)
    _close(st, ms)
    for fn in (lambda *a: tref.wkv_chunked_ref(*a, chunk=chunk),
               tref.wkv_ref):
        want_o, want_s = fn(*ta)
        _close(out, want_o)
        _close(st, want_s)


@pytest.mark.parametrize("chunk", [1, 20])
def test_tc_arithmetic_at_chunks_off_the_tile(chunk):
    """A chunk that is not a multiple of the 16-row tile is padded with
    zero rows inside the kernel: the same chunk boundaries as the
    reference."""
    ja, ta = _inputs(chunk, 2, 100, 2, "float32")
    out, st = tc_emulation(*ta, chunk=chunk)
    want_o, want_s = pallas_wkv(*ja, chunk=chunk, interpret=True)
    _close(out, want_o)
    _close(st, want_s)
    want_o, want_s = tref.wkv_chunked_ref(*ta, chunk=chunk)
    _close(out, want_o)
    _close(st, want_s)


@pytest.mark.parametrize("lw_dtype", ["bfloat16", "float32"])
def test_tc_arithmetic_where_the_clamps_bite(lw_dtype):
    """chunk * |lw| > 80: held against the chunked forms only, where the
    sequential recurrence differs by design."""
    ja, ta = _inputs(9, 1, 96, 2, lw_dtype, decay=(0.1, 1.1), bonus=0.2)
    assert float(-ta[3][:, :32].float().sum(dim=1).min()) > 80
    out, st = tc_emulation(*ta, chunk=32)
    want_o, want_s = tref.wkv_chunked_ref(*ta, chunk=32)
    _close(out, want_o)
    _close(st, want_s)
    mo, ms = _chunk_wkv(*ja, 32)
    _close(out, mo)
    _close(st, ms)
    _close(out, pallas_wkv(*ja, chunk=32, interpret=True)[0])
    seq_o, _ = tref.wkv_ref(*ta)
    assert float((out.float() - seq_o.float()).abs().max()) > 1e-1


def test_tc_error_does_not_grow_with_the_prompt():
    """One 2,048-token prompt (64 chunks), as the rwkv6 prefill runs it."""
    _, ta = _inputs(11, 1, 2048, 1, "float32")
    out, st = tc_emulation(*ta, chunk=32)
    want_o, want_s = tref.wkv_chunked_ref(*ta, chunk=32)
    _close(out, want_o)
    _close(st, want_s)
    head = float((out[:, :64].float() - want_o[:, :64].float()).abs().max())
    tail = float((out[:, -64:].float() - want_o[:, -64:].float()).abs().max())
    assert tail <= 2 * max(head, 2 ** -7)


def test_split_operands_keep_a_slow_decay_in_the_bar():
    """Why the kernel splits every f32 operand into bf16 hi and lo parts:
    with a slow decay (|lw| ~ e^-6) the state grows over a 2,048-token
    prompt, and plain bf16 operands put the output past the 5e-2 bar, while
    the split ones keep it inside."""
    _, ta = _inputs(13, 1, 2048, 1, "float32", decay=(0.5, -6.0))
    want_o, want_s = tref.wkv_chunked_ref(*ta, chunk=32)
    out, st = tc_emulation(*ta, chunk=32)
    _close(out, want_o)
    _close(st, want_s)
    plain, _ = tc_emulation(*ta, chunk=32, split=False)
    excess = (plain.float() - want_o.float()).abs() \
        / (BAR + BAR * want_o.float().abs())
    assert float(excess.max()) > 1


def test_tc_emulation_is_not_the_plain_version():
    """The emulation's split products differ from the f32 reference by
    more than nothing, though far inside the bar: the tests above hold the
    design, not a copy of the reference."""
    _, ta = _inputs(3, 1, 200, 2, "float32")
    _, st = tc_emulation(*ta, chunk=32)
    _, want = tref.wkv_chunked_ref(*ta, chunk=32)
    assert 0 < float((st - want).abs().max()) < BAR / 100


@pytest.mark.parametrize("lw_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("e", [16, 32, 64])
def test_step_formula_is_the_one_token_chunk(e, lw_dtype):
    """At S = 1 the chunk form reduces to the step route's update: within
    1e-6 of wkv_chunked_ref and the JAX wkv at f32."""
    ja, ta = _inputs(5 + e, 4, 1, 3, lw_dtype, e=e, bonus=0.2, state=0.3,
                     dtype="float32")
    out, st = step_formula(*ta)
    want_o, want_s = tref.wkv_chunked_ref(*ta, chunk=32)
    _close(out, want_o, 1e-6)
    _close(st, want_s, 1e-6)
    pall_o, pall_s = pallas_wkv(*ja, interpret=True)
    _close(out, pall_o, 1e-6)
    _close(st, pall_s, 1e-6)


ROUTES = [(torch.bfloat16, 64, 2048, "tc"), (torch.bfloat16, 64, 2, "tc"),
          (torch.bfloat16, 64, 1, "step"), (torch.float32, 64, 1, "step"),
          (torch.bfloat16, 16, 1, "step"), (torch.float32, 64, 2048, "scalar"),
          (torch.bfloat16, 32, 100, "scalar"),
          (torch.bfloat16, 16, 100, "scalar"),
          (torch.float32, 16, 7, "scalar")]


@pytest.mark.parametrize("dtype,e,s,want", ROUTES)
def test_route_is_a_function_of_dtype_head_size_and_length(dtype, e, s, want):
    assert ops.wkv_route(dtype, e, s) == want


@pytest.mark.parametrize("dtype,s", [(torch.bfloat16, 40),
                                     (torch.bfloat16, 1),
                                     (torch.float32, 40)])
def test_cpu_path_counts_no_launch_on_any_route(dtype, s):
    _, ta = _inputs(2, 1, s, 2, "float32")
    ta = [x.to(dtype) for x in ta[:3]] + ta[3:]
    ops.reset_launch_counts()
    out, st = ops.wkv(*ta)
    want_o, want_s = tref.wkv_chunked_ref(*ta)
    assert torch.equal(out, want_o) and torch.equal(st, want_s)
    assert all(n == 0 for n in ops.launch_counts().values())
    assert ops.wkv.launches_tc == 0 and ops.wkv.launches_step == 0


@pytest.mark.parametrize("view", ["contiguous", "offset", "odd_stride",
                                  "wide_rows", "one_row"])
def test_tc_alignment_check(view):
    """The tc route's TMA maps take 16-byte aligned base pointers and b, s,
    h strides (a dimension of size 1 has no stride to check): which views
    the wrapper would refuse."""
    base = torch.zeros(4 * 40 * 3 * 80, dtype=torch.bfloat16)
    if view == "contiguous":
        t, bad = base[:2 * 40 * 3 * 64].view(2, 40, 3, 64), False
    elif view == "offset":                 # base pointer off by 2 bytes
        t, bad = base[1:1 + 40 * 3 * 64].view(1, 40, 3, 64), True
    elif view == "odd_stride":             # rows 68 elements (136 B) apart
        t, bad = base.as_strided((1, 40, 3, 64), (0, 3 * 68, 68, 1)), True
    elif view == "wide_rows":              # a slice of wider rows: 160 B
        t, bad = base.view(4, 40, 3, 80)[..., :64], False
    else:                                  # S = H = 1: only b is stepped
        t, bad = base.as_strided((2, 1, 1, 64), (64, 5, 3, 1)), False
    assert ops._wkv_tc_misaligned([t]) == ([0] if bad else [])


@pytest.mark.parametrize("name,headers", [("wkv_tc", ["sm90.cuh"]),
                                          ("wkv_step", []), ("wkv", [])])
def test_build_covers_each_route_and_its_headers(name, headers):
    """Each route's kernel has its own library, hashed over its source and
    every local header it includes."""
    srcs = [p.name for p in _build.sources(name)]
    assert srcs == [_build.KERNELS[name][0]] + headers
    assert _build.library_path(name).stem.startswith(
        _build.KERNELS[name][0].removesuffix(".cu") + "-")
