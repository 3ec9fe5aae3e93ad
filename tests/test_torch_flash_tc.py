"""The arithmetic of flash attention's bf16 tensor-core route
(kernels/csrc/flash_attention_tc.cu), which runs only on the card, emulated
here in plain PyTorch and held against the JAX package's Pallas kernel
(interpret mode) and the port's ``flash_attention_ref`` at the reference's
2e-2 bf16 bar; the wrapper's route choice, its TMA strides and the build's
header hashing.

The emulation follows the kernel step by step: bf16 operands with f32
products, the scale D^-0.5 (times log2 e) applied to the f32 scores after
Q K^T, 128 x 128 tiles with online rescaling in base 2, a causal q tile
stopping at its diagonal tile, -1e30 masks, P rounded to bf16 before P V,
l summing the rounded P, and acc / max(l, 1e-30). It lives in this file
only; no path runs it."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.weights import to_numpy, to_torch

BM = BN = 128
NEG_INF = -1e30
BAR = 2e-2          # the reference tests' bf16 tolerance


def tc_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool) -> torch.Tensor:
    """The tensor-core kernel's arithmetic on (B, S, H, D) bf16 tensors."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * \
        torch.tensor(math.log2(math.e), dtype=torch.float32)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B,H,S,D)
    pad = (-sk) % BN                       # TMA's zero rows past Sk
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    out = torch.empty((b, h, sq, d), dtype=torch.float32)
    for q0 in range(0, sq, BM):
        rows = qf[:, :, q0:q0 + BM]
        qpos = q0 + torch.arange(rows.shape[2])[:, None]
        m = torch.full(rows.shape[:3], NEG_INF)
        l = torch.zeros(rows.shape[:3])
        acc = torch.zeros(rows.shape)
        n_tiles = -(-sk // BN)
        if causal:
            n_tiles = min(n_tiles, (q0 + BM - 1) // BN + 1)
        for it in range(n_tiles):
            k0 = it * BN
            kt, vt = kf[:, :, k0:k0 + BN], vf[:, :, k0:k0 + BN]
            t = (rows @ kt.transpose(-1, -2)) * scale_log2
            kpos = k0 + torch.arange(BN)[None, :]
            ok = (kpos < sk) & ((kpos <= qpos) if causal else True)
            t = torch.where(ok, t, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, t.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(t - m_new[..., None]).bfloat16().float()
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vt
            m = m_new
        out[:, :, q0:q0 + BM] = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _pair(seed, shape):
    """The same bf16 numbers as a jax array and a torch tensor."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    return ja, to_torch(np.asarray(ja), "cpu")


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = to_numpy(want)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# (b, sq, sk, h, causal): ragged S 200 both ways, Sq != Sk causal both
# ways, an 8-row q tile (the engine's smallest bucket) and a one-row one
CASES = {
    "s200_causal": (1, 200, 200, 2, True),
    "s200_full": (1, 200, 200, 2, False),
    "sq96_sk160_causal": (2, 96, 160, 2, True),
    "sq160_sk96_causal": (2, 160, 96, 2, True),
    "sq8_causal": (1, 8, 8, 3, True),
    "sq1_sk40_full": (1, 1, 40, 3, False),
}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", list(CASES))
def test_tc_arithmetic_within_the_bf16_bar(case, d):
    b, sq, sk, h, causal = CASES[case]
    seed = 10 * sq + sk + d
    jq, tq = _pair(seed, (b, sq, h, d))
    jk, tk = _pair(seed + 1, (b, sk, h, d))
    jv, tv = _pair(seed + 2, (b, sk, h, d))
    got = tc_emulation(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, sq, h, d)
    assert bool(torch.isfinite(got).all())
    pallas = pallas_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                          interpret=True)
    _close(got, pallas, BAR)
    _close(got, tref.flash_attention_ref(tq, tk, tv, causal=causal), BAR)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal), BAR)


def test_tc_emulation_is_not_the_plain_version():
    """The emulation rounds P to bf16 and so differs from the f32-P
    reference by more than f32 rounding, though inside the bar: the test
    above holds the design, not a copy of the reference."""
    _, tq = _pair(1, (1, 200, 2, 128))
    _, tk = _pair(2, (1, 200, 2, 128))
    _, tv = _pair(3, (1, 200, 2, 128))
    got = tc_emulation(tq, tk, tv, causal=True).float()
    want = tref.flash_attention_ref(tq, tk, tv, causal=True).float()
    assert 0 < float((got - want).abs().max()) < BAR


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_is_a_function_of_dtype_and_head_dim(dtype, d):
    want = "tc" if dtype == torch.bfloat16 and d in (64, 128) else "scalar"
    assert ops.flash_route(dtype, d) == want


def test_cpu_path_counts_no_tensor_core_launch():
    ops.reset_launch_counts()
    t = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16)
    ops.flash_attention(t, t, t)
    assert ops.flash_attention.launches == 0
    assert ops.flash_attention.launches_tc == 0


@pytest.mark.parametrize("view", ["contiguous", "transposed", "b1_h1_s1"])
def test_tma_strides(view):
    """The b, s, h strides the tensor maps get: the tensor's own, except
    that a size-1 dimension takes the packed stride (it is never
    stepped)."""
    if view == "contiguous":
        t = torch.zeros((2, 5, 3, 64))
        assert ops._tma_strides(t) == list(t.stride()[:3])
    elif view == "transposed":
        t = torch.zeros((2, 3, 5, 128)).transpose(1, 2)
        assert ops._tma_strides(t) == [3 * 5 * 128, 128, 5 * 128]
    else:
        t = torch.zeros(1000).as_strided((1, 1, 1, 64), (7, 5, 3, 1))
        assert ops._tma_strides(t) == [64, 64, 64]


def test_build_hashes_every_local_header(tmp_path, monkeypatch):
    """A kernel split into a .cu and the headers it includes rebuilds when
    any of them changes."""
    srcs = _build.sources("flash_attention_tc")
    assert [p.name for p in srcs] == ["flash_attention_tc.cu", "sm90.cuh"]
    for name in ("flash_attention_tc.cu", "sm90.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("flash_attention_tc")
    with open(tmp_path / "sm90.cuh", "a") as f:
        f.write("\n// changed\n")
    after = _build.library_path("flash_attention_tc")
    assert before != after and before.stem.startswith("flash_attention_tc-")
