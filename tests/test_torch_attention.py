"""The port's attention (models/attention.py) and its flash-attention
wrapper (kernels/ops.py) against the JAX package: RoPE, the KV expansion,
naive, chunked and per-slot decode attention at rtol 1e-5 in f32; the
wrapper's plain version (the CPU path) against the Pallas kernel in
interpret mode and against ``flash_attention_ref`` at the reference tests'
tolerances (tests/test_kernels.py). The CUDA kernel itself runs only on the
card, where chip_smoke.py holds it against the same plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.weights import to_numpy, to_torch

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(seed, shape, dtype="float32"):
    """The same normal numbers as a jax array and a torch tensor."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ja = jnp.asarray(a).astype(DTYPES[dtype][0])
    return ja, to_torch(np.asarray(ja), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _qmaps(h, kv):
    return jattn.make_qmap(h, kv, h), tattn.make_qmap(h, kv, h)


# ---------------------------------------------------------------------------
# the model-side functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_matches_reference(per_slot):
    jx, tx = _pair(0, (2, 8, 4, 16))
    pos = np.arange(8, dtype=np.int32)
    if per_slot:
        pos = np.stack([pos + 3, pos + 11])
    _close(tattn.rope(tx, torch.from_numpy(pos), 10000.0),
           jattn.rope(jx, jnp.asarray(pos), 10000.0), 1e-5)


@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4), (6, 3), (8, 1)])
def test_qmap_and_expand_kv_match_bitwise(h, kv):
    jmap, tmap = _qmaps(h, kv)
    assert (jmap is None) == (tmap is None)
    if jmap is not None:
        assert np.asarray(jmap).tolist() == tmap.tolist()
    jk, tk = _pair(1, (2, 5, kv, 16))
    got = to_numpy(tattn._expand_kv(tk, tmap))
    want = np.asarray(jattn._expand_kv(jk, jmap))
    assert got.shape == (2, 5, h, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("causal,q_offset,sq,sk,chunk", [
    (True, 0, 12, 12, 5), (True, 4, 8, 12, 4), (False, 0, 7, 13, 6),
    (True, 0, 16, 16, 1024)])
def test_attention_matches_reference(impl, causal, q_offset, sq, sk, chunk):
    jq, tq = _pair(2, (2, sq, 4, 16))
    jk, tk = _pair(3, (2, sk, 2, 16))
    jv, tv = _pair(4, (2, sk, 2, 16))
    jmap, tmap = _qmaps(4, 2)
    want = jattn.attention(jq, jk, jv, impl=impl, causal=causal, chunk=chunk,
                           q_offset=q_offset, qmap=jmap)
    got = tattn.attention(tq, tk, tv, impl=impl, causal=causal, chunk=chunk,
                          q_offset=q_offset, qmap=tmap)
    assert tuple(got.shape) == (2, sq, 4, 16) and got.dtype == torch.float32
    _close(got, want, 1e-5)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_attention_matches_reference(per_slot):
    jq, tq = _pair(5, (3, 1, 4, 16))
    jk, tk = _pair(6, (3, 20, 2, 16))
    jv, tv = _pair(7, (3, 20, 2, 16))
    jmap, tmap = _qmaps(4, 2)
    if per_slot:      # one empty slot, one mid, one full
        jl, tl = jnp.asarray([1, 9, 20], jnp.int32), torch.tensor(
            [1, 9, 20], dtype=torch.int32)
    else:
        jl, tl = 13, 13
    want = jattn.decode_attention(jq, jk, jv, jl, qmap=jmap)
    got = tattn.decode_attention(tq, tk, tv, tl, qmap=tmap)
    _close(got, want, 1e-5)


def test_pallas_dispatch_drops_q_offset_like_the_reference():
    """``attention(impl="pallas")`` ignores q_offset and chunk in both
    packages: the kernel masks from position 0."""
    jq, tq = _pair(8, (1, 8, 4, 16))
    jk, tk = _pair(9, (1, 12, 2, 16))
    jv, tv = _pair(10, (1, 12, 2, 16))
    jmap, tmap = _qmaps(4, 2)
    want = jattn.attention(jq, jk, jv, impl="pallas", q_offset=4, chunk=4,
                           qmap=jmap)
    got = tattn.attention(tq, tk, tv, impl="pallas", q_offset=4, chunk=4,
                          qmap=tmap)
    _close(got, want, 2e-5)
    no_offset = tattn.attention(tq, tk, tv, impl="naive", qmap=tmap)
    _close(got, to_numpy(no_offset), 2e-5)


def test_unknown_impl_is_refused():
    t = torch.zeros((1, 2, 2, 16))
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(t, t, t, impl="flash")


# ---------------------------------------------------------------------------
# the kernel wrapper's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,d", [(1, 128, 1, 64), (1, 200, 2, 128),
                                     (2, 64, 8, 32), (2, 16, 4, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_wrapper_matches_pallas_and_ref(b, s, h, d, causal, dtype):
    jq, tq = _pair(s * h + causal, (b, s, h, d), dtype)
    jk, tk = _pair(s * h + 1, (b, s, h, d), dtype)
    jv, tv = _pair(s * h + 2, (b, s, h, d), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (b, s, h, d)
    pallas = pallas_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                          interpret=True)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    tol = 2e-6 if dtype == "float32" else 2e-2
    _close(got, want, tol)
    _close(got, pallas, 2e-5 if dtype == "float32" else 2e-2)


def test_flash_wrapper_cross_lengths():
    """Sq != Sk without a causal mask (tests/test_kernels.py's case)."""
    jq, tq = _pair(11, (2, 96, 2, 64))
    jk, tk = _pair(12, (2, 160, 2, 64))
    jv, tv = _pair(13, (2, 160, 2, 64))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    _close(got, pallas_flash(jq, jk, jv, causal=False, block_q=64,
                             block_k=64, interpret=True), 2e-5)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=False), 2e-5)


def test_flash_wrapper_reads_strided_views():
    """Views with a contiguous head dim (a transposed (B, H, S, D) buffer)
    give what contiguous copies give."""
    _, base = _pair(14, (3, 2, 4, 24, 16))
    q, k, v = (base[i].transpose(1, 2) for i in range(3))   # (2, 24, 4, 16)
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_cpu_path_does_not_count_launches():
    ops.reset_launch_counts()
    t = torch.zeros((1, 4, 2, 16))
    ops.flash_attention(t, t, t)
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "heads", "dtype_mix",
                                 "dtype", "empty_k"])
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 6, 2, 16))
    v = torch.zeros((1, 6, 2, 16))
    if bad == "rank":
        q = q.reshape(4, 2, 16)
    elif bad == "kv_shape":
        v = torch.zeros((1, 5, 2, 16))
    elif bad == "heads":
        k = v = torch.zeros((1, 6, 3, 16))
    elif bad == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:
        k = v = torch.zeros((1, 0, 2, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)


def test_flash_wrapper_raises_off_cpu_without_a_kernel():
    """A tensor neither on the CPU nor on the card is refused, never routed
    to the plain version."""
    t = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(NotImplementedError):
        ops.flash_attention(t, t, t)


def test_ref_matches_reference_ref_at_a_ragged_shape():
    jq, tq = _pair(15, (1, 37, 3, 32))
    jk, tk = _pair(16, (1, 37, 3, 32))
    jv, tv = _pair(17, (1, 37, 3, 32))
    _close(tref.flash_attention_ref(tq, tk, tv, causal=True),
           jref.flash_attention_ref(jq, jk, jv, causal=True), 2e-6)
