"""The port's WKV (kernels/ref.py and the ``ops.wkv`` wrapper) against the
JAX package: the chunked plain version (the wrapper's CPU path) against the
Pallas kernel in interpret mode and the model's ``_chunk_wkv``, and the
sequential plain version against ``ref.wkv_ref``, at the reference tests'
sweep and bars (1e-4 at f32, 5e-2 at bf16; tests/test_kernels.py); chunk
invariance; a one-token (decode) call; and cases with chunk * |lw| > 80,
where the clamps make the chunked form differ from the sequential one and
the port must follow the reference kernel. The CUDA kernel itself runs only
on the card, where chip_smoke.py holds it against the same plain
versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.wkv import wkv as pallas_wkv
from repro.models.rwkv import _chunk_wkv
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.weights import to_numpy, to_torch

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(seed, b, s, h, e, dtype="float32", decay=(0.5, -1.0),
            bonus=0.1, state=0.1):
    """r, k, v (scaled normals), lw = -exp(N * a + c) and an f32 bonus and
    state, drawn with numpy as test_wkv_sweep draws them; r, k, v and lw in
    ``dtype``. Returns (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, e)).astype(np.float32) * 0.5
               for _ in range(3))
    a, c = decay
    lw = -np.exp(rng.standard_normal((b, s, h, e)).astype(np.float32) * a + c)
    u = rng.standard_normal((h, e)).astype(np.float32) * bonus
    st = rng.standard_normal((b, h, e, e)).astype(np.float32) * state
    jd = DTYPES[dtype][0]
    ja = [jnp.asarray(x).astype(jd) for x in (r, k, v, lw)] + \
        [jnp.asarray(u), jnp.asarray(st)]
    ta = [to_torch(np.asarray(x), "cpu") for x in ja]
    return ja, ta


def _close(got, want, tol):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,e,chunk", [(1, 64, 2, 16, 16),
                                           (2, 100, 3, 32, 32),
                                           (1, 31, 1, 64, 32)])
def test_plain_versions_match_reference(b, s, h, e, chunk, dtype):
    ja, ta = _inputs(s + e, b, s, h, e, dtype)
    tol = TOL[dtype]
    out, st = tref.wkv_chunked_ref(*ta, chunk=chunk)
    want_o, want_s = pallas_wkv(*ja, chunk=chunk, interpret=True)
    assert out.dtype == DTYPES[dtype][1] and st.dtype == torch.float32
    _close(out, want_o, tol)
    _close(st, want_s, tol)
    seq_o, seq_s = tref.wkv_ref(*ta)
    ref_o, ref_s = jref.wkv_ref(*ja)
    assert seq_o.dtype == DTYPES[dtype][1]
    _close(seq_o, ref_o, tol)
    _close(seq_s, ref_s, tol)
    # the two plain versions agree, as the kernel and its oracle do
    _close(out, to_numpy(seq_o), tol)
    _close(st, to_numpy(seq_s), tol)


def test_chunk_invariance():
    """Chunk size is an implementation detail: 16 against 48."""
    ja, ta = _inputs(3, 1, 96, 2, 16, decay=(1.0, -1.5), bonus=0.0,
                     state=0.0)
    o16, s16 = tref.wkv_chunked_ref(*ta, chunk=16)
    o48, s48 = tref.wkv_chunked_ref(*ta, chunk=48)
    _close(o16, to_numpy(o48), 1e-4)
    _close(s16, to_numpy(s48), 1e-4)
    want_o, want_s = pallas_wkv(*ja, chunk=48, interpret=True)
    _close(o16, want_o, 1e-4)
    _close(s16, want_s, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_token_step_matches_reference(dtype):
    """S = 1, a decode step: the chunk shrinks to one token; the model's
    ``_chunk_wkv`` pads it to 32 and computes the same."""
    ja, ta = _inputs(5, 4, 1, 2, 16, dtype, bonus=0.2, state=0.3)
    tol = TOL[dtype]
    out, st = ops.wkv(*ta)
    assert tuple(out.shape) == (4, 1, 2, 16)
    _close(out, pallas_wkv(*ja, interpret=True)[0], tol)
    mo, ms = _chunk_wkv(*ja, 32)
    _close(out, mo, tol)
    _close(st, ms, tol)
    _close(st, jref.wkv_ref(*ja)[1], tol)


def _chunk_f64(r, k, v, lw, u, st, chunk):
    """A numpy float64 transcription of the reference's chunk form
    (``_chunk_wkv``: pad to the chunk, cumsum, clamps at 80, the three
    products, the state update): the formula's value without f32
    rounding."""
    r, k, v, lw, u, st = (np.asarray(x, np.float64) for x in
                          (r, k, v, lw, u, st))
    s = r.shape[1]
    pad = ((0, 0), (0, (-s) % chunk), (0, 0), (0, 0))
    r, k, v, lw = (np.pad(a, pad) for a in (r, k, v, lw))
    mask = np.tril(np.ones((chunk, chunk), bool), -1)
    outs = []
    for c0 in range(0, r.shape[1], chunk):
        rj, kj, vj, lwj = (a[:, c0:c0 + chunk] for a in (r, k, v, lw))
        cum = np.cumsum(lwj, axis=1)
        qf = rj * np.exp(np.clip(cum - lwj, -80, 0))
        kf = kj * np.exp(np.clip(-cum, 0, 80))
        s_tt = np.where(mask, np.einsum("bthe,bihe->bhti", qf, kf), 0.0)
        out = np.einsum("bhti,bihe->bthe", s_tt, vj)
        out += np.einsum("bthe,bthe->bth", rj * u, kj)[..., None] * vj
        out += np.einsum("bthe,bhef->bthf", qf, st)
        tot = cum[:, -1]
        kdec = kj * np.exp(np.clip(tot[:, None] - cum, -80, 80))
        st = st * np.exp(np.clip(tot, -80, 0))[..., None] \
            + np.einsum("bthe,bthf->bhef", kdec, vj)
        outs.append(out)
    return np.concatenate(outs, axis=1)[:, :s], st


@pytest.mark.parametrize("decay", [(0.2, 1.0), (0.3, 1.5)])
def test_clamped_chunks_compute_the_reference_form(decay):
    """chunk * |lw| > 80 (|lw| ~ e^1.0 and e^1.5 at chunk 32): the clamps
    at 80 bite and the chunked form leaves the sequential recurrence; the
    port computes the reference's chunked form, within 1e-4 of its float64
    value. There the e^{+-80} factors amplify f32 rounding: the JAX
    package's own f32 result (Pallas kernel and ``_chunk_wkv`` alike) is
    within the bar of that value at the milder decay and 3-5 times outside
    it at the stronger one, so the port is held against the JAX functions
    at the milder decay and against the float64 value at both."""
    ja, ta = _inputs(9, 1, 70, 2, 16, decay=decay, bonus=0.2)
    assert float(-ta[3][:, :32].sum(dim=1).min()) > 80
    out, st = tref.wkv_chunked_ref(*ta, chunk=32)
    want_o, want_s = _chunk_f64(*(to_numpy(t) for t in ta), 32)
    _close(out, want_o, 1e-4)
    _close(st, want_s, 1e-4)
    seq_o, _ = tref.wkv_ref(*ta)
    assert float((out - seq_o).abs().max()) > 1e-2
    if decay == (0.2, 1.0):
        _close(out, pallas_wkv(*ja, chunk=32, interpret=True)[0], 1e-4)
        mo, ms = _chunk_wkv(*ja, 32)
        _close(out, mo, 1e-4)
        _close(st, ms, 1e-4)


def test_wrapper_cpu_path_is_the_chunked_version_and_counts_nothing():
    _, ta = _inputs(2, 2, 40, 2, 32)
    ops.reset_launch_counts()
    out, st = ops.wkv(*ta, chunk=16)
    want_o, want_s = tref.wkv_chunked_ref(*ta, chunk=16)
    assert torch.equal(out, want_o) and torch.equal(st, want_s)
    assert ops.launch_counts()["wkv"] == 0


def test_wrapper_reads_strided_views():
    """(B, S, H, E) views of a wider (B, S, H * E * 2) buffer, as the model
    reshapes its projections: the same result as contiguous copies."""
    _, ta = _inputs(4, 1, 20, 2, 16)
    wide = [torch.cat([t, t], dim=-1) for t in ta[:4]]
    views = [w[..., :16] for w in wide]
    assert not views[0].is_contiguous()
    got = ops.wkv(*views, *ta[4:])
    want = ops.wkv(*ta)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _bad_cases():
    _, (r, k, v, lw, u, st) = _inputs(1, 1, 8, 2, 16)
    return {
        "kv_dtype": (r, k.double(), v, lw, u, st, {}),
        "int_lw": (r, k, v, lw.int(), u, st, {}),
        "bonus_bf16": (r, k, v, lw, u.bfloat16(), st, {}),
        "bonus_shape": (r, k, v, lw, u[:1], st, {}),
        "state_bf16": (r, k, v, lw, u, st.bfloat16(), {}),
        "state_shape": (r, k, v, lw, u, st[:, :1], {}),
        "lw_shape": (r, k, v, lw[:, :4], u, st, {}),
        "chunk_0": (r, k, v, lw, u, st, {"chunk": 0}),
        "chunk_65": (r, k, v, lw, u, st, {"chunk": 65}),
        "empty_seq": (r[:, :0], k[:, :0], v[:, :0], lw[:, :0], u, st, {}),
    }


@pytest.mark.parametrize("bad", sorted(_bad_cases()))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    *args, kw = _bad_cases()[bad]
    with pytest.raises(ValueError):
        ops.wkv(*args, **kw)


def test_wrapper_raises_off_cpu_without_a_kernel(monkeypatch):
    """A meta tensor (the dry-run's) is never routed to the plain version,
    nor to a kernel: the wrapper returns empty meta tensors of the
    output's and the final state's shapes and dtypes, and counts the
    chunk form's products. Inputs on two devices are refused."""
    def boom(*a, **k):
        raise AssertionError("a meta call reached a kernel or its plain "
                             "version")
    for name in ("wkv_chunked_ref", "wkv_ref"):
        monkeypatch.setattr(tref, name, boom)
    monkeypatch.setattr(ops._build, "load", boom)
    _, ta = _inputs(1, 1, 8, 2, 16)
    meta = [t.to("meta") for t in ta]
    with ops.meta_flops() as count:
        out, st = ops.wkv(*meta)
    assert out.device.type == "meta" and out.dtype == meta[0].dtype
    assert tuple(out.shape) == tuple(meta[0].shape)
    assert st.dtype == torch.float32 and tuple(st.shape) == \
        tuple(meta[-1].shape)
    assert count["flops"] == ops.wkv_flops(1, 8, 2, 16, 32) > 0
    with pytest.raises(ValueError):
        ops.wkv(meta[0], *ta[1:])
