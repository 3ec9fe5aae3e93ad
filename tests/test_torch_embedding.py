"""The port's dedupe and lookup against the JAX package's: ``_dedupe`` is
exact (uids, inv, dropped, n_unique) across capacity, local_agg and
exact/capped; ``lookup``'s forward and table gradient are bitwise equal at
f32 and bf16 — the bar of test_kernels.py::
test_lookup_pallas_matches_jnp_bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding as jemb
from repro_torch.core import embedding as temb
from repro_torch.weights import to_torch

VOCAB = 64


def _ids(seed, n, vocab=VOCAB, zipf=False):
    rng = np.random.default_rng(seed)
    if zipf:
        return ((rng.zipf(1.3, size=n) - 1) % vocab).astype(np.int32)
    return rng.integers(0, vocab, size=n).astype(np.int32)


@pytest.mark.parametrize("local_agg", [True, False])
@pytest.mark.parametrize("capacity", [1, 7, 16, 40, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_dedupe_exact(capacity, local_agg, seed):
    ids = _ids(seed, 48, zipf=bool(seed))
    want = jemb._dedupe(jnp.asarray(ids), capacity, VOCAB, local_agg)
    got = temb._dedupe(torch.from_numpy(ids), capacity, VOCAB, local_agg)
    for w, g, what in zip(want, got, ("uids", "inv", "dropped", "n_unique")):
        assert g.dtype == torch.int32, what
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)


def _ctxs(dtype_name, wire, local_agg, exact):
    jw = jnp.dtype(wire)
    tw = {"float32": torch.float32, "bfloat16": torch.bfloat16}[wire]
    jctx = jemb.EmbedCtx(mesh=None, method="dense", batch_axes=(),
                         model_axis="", vocab_padded=VOCAB, wire_dtype=jw,
                         local_agg=local_agg, exact=exact)
    tctx = temb.EmbedCtx(method="dense", vocab_padded=VOCAB, wire_dtype=tw,
                         local_agg=local_agg, exact=exact)
    return jctx, tctx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("local_agg,exact,capacity", [
    (True, True, 0), (True, False, 9), (False, True, 0)])
def test_lookup_forward_and_grad_bitwise(dtype, wire, local_agg, exact,
                                         capacity):
    b, s, e = 3, 12, 16
    rng = np.random.default_rng(7)
    table_np = rng.standard_normal((VOCAB, e)).astype(np.float32)
    jt = jnp.asarray(table_np).astype(jnp.dtype(dtype))
    tt = to_torch(np.asarray(jt), "cpu")
    ids = _ids(3, b * s, zipf=True).reshape(b, s)
    # a cotangent with distinct rows, so the segment-sum order matters
    ct = rng.standard_normal((b, s, e)).astype(np.float32)
    jctx, tctx = _ctxs(dtype, wire, local_agg, exact)

    def jloss(t):
        out, m = jemb.lookup(t, jnp.asarray(ids), ctx=jctx, capacity=capacity)
        return jnp.sum(out.astype(jnp.float32) * ct), (out, m)

    (jval, (jout, jm)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jt)

    tp = tt.clone().requires_grad_(True)
    tout, tm = temb.lookup(tp, torch.from_numpy(ids), ctx=tctx,
                           capacity=capacity)
    tval = torch.sum(tout.float() * torch.from_numpy(ct))
    tval.backward()

    assert tout.dtype == tt.dtype and tp.grad.dtype == tt.dtype
    np.testing.assert_array_equal(tout.detach().float().numpy(),
                                  np.asarray(jout, np.float32))
    np.testing.assert_array_equal(tp.grad.float().numpy(),
                                  np.asarray(jgrad, np.float32))
    for k in ("embed_rows", "embed_dropped", "embed_unique"):
        assert float(tm[k]) == float(jm[k]), k


def test_capped_capacity_drops_and_reports():
    """Overflowed ids read as zero rows and are counted as dropped."""
    table = torch.ones((VOCAB, 8))
    ids = torch.arange(16, dtype=torch.int32).reshape(1, 16)
    _, tctx = _ctxs("float32", "float32", True, False)
    out, m = temb.lookup(table, ids, ctx=tctx, capacity=10)
    assert int(m["embed_dropped"]) == 6 and int(m["embed_rows"]) == 10
    got = out[0].sum(-1)
    assert (got == 8).sum() == 10 and (got == 0).sum() == 6


def test_local_agg_off_off_the_cpu_takes_the_plain_scatter(monkeypatch):
    """Repeated ids (the raw token stream of local_agg=False) take the
    accumulating plain scatter on every device, as the reference takes its
    jnp oracle there; the unique-id kernel is never called for them."""
    _, tctx = _ctxs("float32", "float32", False, True)
    ids = torch.tensor([1, 1, 2], dtype=torch.int32, device="meta")
    rows = torch.zeros((3, 4), device="meta")
    calls = []
    plain = temb.ref.embed_scatter_add_ref

    def spy(*args):
        calls.append(args[0].device)
        return plain(*args)

    def kernel(*_):
        raise AssertionError("the unique-id kernel took repeated ids")

    monkeypatch.setattr(temb.ref, "embed_scatter_add_ref", spy)
    monkeypatch.setattr(temb.ops, "embed_scatter_add", kernel)
    out = temb._scatter_rows(ids, rows, 8, tctx)
    assert calls == [torch.device("meta")]
    assert out.device.type == "meta" and tuple(out.shape) == (8, 4)
    assert out.dtype == torch.float32


def test_mesh_methods_are_refused():
    """A mesh method (ps) with no mesh in its context is refused: the
    exchanges run on a ``launch/mesh.py`` mesh (tests/test_torch_mesh_*)."""
    ctx = temb.EmbedCtx(method="ps", vocab_padded=VOCAB,
                        wire_dtype=torch.float32, local_agg=True)
    with pytest.raises(ValueError, match="exchanges over a mesh"):
        temb.lookup(torch.zeros((VOCAB, 4)),
                    torch.zeros((1, 4), dtype=torch.int32),
                    ctx=ctx, capacity=4)
