"""The port's exchanges on gloo process meshes against the JAX package's on
fake-device meshes of the same shape, from the same numpy inputs.

* The lookup (pull and push) under ``ps``, ``ps_gather``, ``mpi_gatherv``
  and a dense-routed ``allreduce`` table, on (data 2, model 2) and (data
  1, model 4): the forward rows, the table gradient (the push's exchange
  included; the dense-routed table's gradient is summed over the replicas
  as the step's exchange does) and the census, within rtol 1e-6 at f32.
* ``sharded_xent`` and its gradient, within 1e-6.
* The bucketed all-reduce equals per-tensor all-reduces, issued from the
  gradient hooks or after the backward; ``_two_level_psum`` on a (pod 2,
  data 2) mesh equals one flat all-reduce; the model-axis autograd pair.

The port's ranks are spawned processes (``launch/mesh.py::spawn``); the
reference runs in a subprocess with fake XLA devices
(``conftest.distributed_run``).
"""
import numpy as np
import pytest
import torch

from conftest import distributed_run
from repro_torch.core import buckets, collectives as coll
from repro_torch.core import embedding as temb
from repro_torch.core.xent import sharded_xent
from repro_torch.launch.mesh import make_mesh, spawn

pytestmark = pytest.mark.distributed

MESHES = [(2, 2), (1, 4)]
METHODS = ["ps", "ps_gather", "mpi_gatherv", "allreduce"]
VP, VOCAB, E, B, S = 64, 61, 8, 4, 8
TOL = dict(rtol=1e-6, atol=1e-7)


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "table": rng.standard_normal((VP, E)).astype(np.float32),
        # few distinct ids: repeats within and across replicas
        "ids": rng.integers(0, VOCAB, size=(B, S)).astype(np.int32) // 3,
        "d_out": rng.standard_normal((B, S, E)).astype(np.float32),
        "logits": (3 * rng.standard_normal((B, S, VP))).astype(np.float32),
        "labels": rng.integers(0, VOCAB, size=(B, S)).astype(np.int32),
        "g": rng.standard_normal((B, S)).astype(np.float32),
    }


_REF = """
import jax.numpy as jnp
from repro.core import embedding as jemb
from repro.core.xent import sharded_xent
inp = {{k: np.asarray(v) for k, v in {inputs}.items()}}
out = {{}}
for shape in {meshes}:
    mesh = make_mesh(shape, ("data", "model"))
    key = "x".join(map(str, shape))
    with use_mesh(mesh):
        for method in {methods}:
            ctx = jemb.EmbedCtx(mesh=mesh, method=method, batch_axes=("data",),
                                model_axis="model", vocab_padded={vp},
                                wire_dtype=jnp.float32, local_agg=True)

            @jax.jit
            def run(table, ids, d_out):
                f = lambda t: jemb.lookup(t, ids, ctx=ctx, capacity=8)
                rows, vjp, m = jax.vjp(f, table, has_aux=True)
                return rows, vjp(d_out)[0], m["embed_unique"], m["embed_rows"]

            rows, d_table, uniq, nrows = run(*(jnp.asarray(inp[k]) for k in
                                               ("table", "ids", "d_out")))
            out[key + "|" + method] = {{
                "rows": np.asarray(rows).tolist(),
                "d_table": np.asarray(d_table).tolist(),
                "unique": float(uniq), "rows_metric": int(nrows)}}

        @jax.jit
        def xent(logits, labels, g):
            f = lambda lg: sharded_xent(lg, labels, mesh=mesh,
                                        model_axis="model",
                                        batch_axes=("data",), vocab={vocab})
            loss, vjp = jax.vjp(f, logits)
            return loss, vjp(g)[0]

        loss, d_logits = xent(*(jnp.asarray(inp[k]) for k in
                                ("logits", "labels", "g")))
        out[key + "|xent"] = {{"loss": np.asarray(loss).tolist(),
                              "d_logits": np.asarray(d_logits).tolist()}}
print("RESULT:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    inputs = {k: v.tolist() for k, v in _inputs().items()}
    code = _REF.format(inputs=repr(inputs), meshes=repr(MESHES),
                       methods=repr(METHODS), vp=VP, vocab=VOCAB)
    return distributed_run(code, devices=4, timeout=300)


def _port_rank(rank, world, shape):
    """One rank of the port's lookups and loss on ``shape``."""
    m = make_mesh(shape, ("data", "model"), device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    d, mm = m.coords["data"], m.coords["model"]
    b_loc, vs = B // shape[0], VP // shape[1]
    rows_sl = slice(d * b_loc, (d + 1) * b_loc)
    out = {}
    for method in METHODS:
        ctx = temb.EmbedCtx(method=method, vocab_padded=VP,
                            wire_dtype=torch.float32, local_agg=True,
                            mesh=m, batch_axes=("data",), model_axis="model")
        table = inp["table"]
        if method in ("ps", "ps_gather"):
            table = table[mm * vs:(mm + 1) * vs]
        table = table.clone().requires_grad_()
        rows, metrics = temb.lookup(table, inp["ids"][rows_sl], ctx=ctx,
                                    capacity=8)
        rows.backward(inp["d_out"][rows_sl])
        grad = table.grad
        if method == "allreduce":
            grad = coll.all_reduce(grad, "data", m)    # the step's dense exchange
        out[method] = {"rows": rows.detach().numpy(),
                       "d_table": grad.numpy(),
                       "unique": float(metrics["embed_unique"]),
                       "rows_metric": int(metrics["embed_rows"])}
    logits = inp["logits"][rows_sl, :, mm * vs:(mm + 1) * vs].clone()
    logits.requires_grad_()
    loss = sharded_xent(logits, inp["labels"][rows_sl], mesh=m,
                        model_axis="model", batch_axes=("data",), vocab=VOCAB)
    loss.backward(inp["g"][rows_sl])
    out["xent"] = {"loss": loss.detach().numpy(),
                   "d_logits": logits.grad.numpy()}
    return {"coords": (d, mm), **out}


@pytest.fixture(scope="module")
def port():
    return {shape: spawn(_port_rank, shape[0] * shape[1], "gloo",
                         args=(shape,), timeout=240)
            for shape in MESHES}


def _assemble(ranks, shape, field, method):
    """The global value of ``field`` from every rank's piece."""
    by = {r["coords"]: r[method][field] for r in ranks}
    if field == "rows" or (method == "xent" and field == "loss"):
        for d in range(shape[0]):       # the model ranks agree
            for mm in range(shape[1]):
                np.testing.assert_array_equal(by[(d, mm)], by[(d, 0)])
        return np.concatenate([by[(d, 0)] for d in range(shape[0])])
    if field == "d_logits":
        return np.concatenate([np.concatenate(
            [by[(d, mm)] for mm in range(shape[1])], axis=-1)
            for d in range(shape[0])])
    # d_table: every replica holds the same exchanged gradient
    for d in range(shape[0]):
        for mm in range(shape[1]):
            np.testing.assert_array_equal(by[(d, mm)], by[(0, mm)])
    if method in ("ps", "ps_gather"):
        return np.concatenate([by[(0, mm)] for mm in range(shape[1])])
    return by[(0, 0)]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("method", METHODS)
def test_lookup_matches_reference(reference, port, shape, method):
    want = reference["x".join(map(str, shape)) + "|" + method]
    ranks = port[shape]
    np.testing.assert_allclose(_assemble(ranks, shape, "rows", method),
                               np.asarray(want["rows"]), **TOL)
    np.testing.assert_allclose(_assemble(ranks, shape, "d_table", method),
                               np.asarray(want["d_table"]), **TOL)
    # the census: each replica's count, averaged over the replicas by the
    # step's fused metrics all-reduce (a dense-routed table: the global one)
    uniq = np.mean([r[method]["unique"] for r in ranks])
    assert uniq == want["unique"]
    assert {r[method]["rows_metric"] for r in ranks} == {want["rows_metric"]}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_xent_matches_reference(reference, port, shape):
    want = reference["x".join(map(str, shape)) + "|xent"]
    ranks = port[shape]
    np.testing.assert_allclose(_assemble(ranks, shape, "loss", "xent"),
                               np.asarray(want["loss"]), rtol=1e-6)
    np.testing.assert_allclose(_assemble(ranks, shape, "d_logits", "xent"),
                               np.asarray(want["d_logits"]),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the dense exchange
# ---------------------------------------------------------------------------

SIZES = [(3, 5), (7,), (2, 2, 2)]


def _bucket_rank(rank, world):
    m = make_mesh((4, 1), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(rank)
    grads = [torch.randn(s, generator=gen) for s in SIZES]
    b = buckets.Bucket(key=("allreduce", "float32", ()), idx=(2, 1, 0),
                       sizes=tuple(g.numel() for g in grads[::-1]),
                       nbytes=4 * sum(g.numel() for g in grads))
    bp = buckets.BucketPlan(buckets=[b], batch_axes=("data",), replicas=4,
                            n_params=3, wire_bytes=b.nbytes, bucket_bytes=0)
    fused = buckets._exchange_bucket(b, grads[::-1], 0.25, bp, m)
    per_tensor = [coll.all_reduce((g * 0.25), "data", m) for g in grads[::-1]]
    # the same exchange issued from the gradient hooks during a backward
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SIZES]
    ov = buckets.OverlapExchange(bp, params, m)
    ov.begin()
    sum((p * g).sum() for p, g in zip(params, grads)).backward()
    hooked = ov.finish()
    return {"fused": [t.numpy() for t in fused],
            "per_tensor": [t.numpy() for t in per_tensor],
            "hooked": [hooked[i].numpy() for i in (2, 1, 0)]}


def test_bucketed_all_reduce_equals_per_tensor():
    for r in spawn(_bucket_rank, 4, "gloo", timeout=240):
        for a, b, c in zip(r["fused"], r["per_tensor"], r["hooked"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(a, c)


def _two_level_rank(rank, world):
    m = make_mesh((2, 2), ("pod", "data"), device="cpu")
    # integer-valued, so every summation order gives the same bits; an odd
    # length exercises the padding to the local replica count
    buf = torch.arange(7, dtype=torch.float32) * (rank + 1)
    two = buckets._two_level_psum(buf, ("pod", "data"), 2, m)
    flat = coll.all_reduce(buf, ("pod", "data"), m)
    # the model-axis pair: copy_to's gradient is the all-reduce over the
    # axis, reduce_from's forward is
    x = torch.full((3,), float(rank), requires_grad=True)
    (coll.copy_to(x, "data", m) * (rank + 1)).sum().backward()
    y = coll.reduce_from(torch.full((3,), float(rank)), "data", m)
    return {"two": two.numpy(), "flat": flat.numpy(), "dx": x.grad.numpy(),
            "y": y.numpy(), "coords": (m.coords["pod"], m.coords["data"])}


def test_two_level_psum_equals_flat_all_reduce():
    for r in spawn(_two_level_rank, 4, "gloo", timeout=240):
        np.testing.assert_array_equal(r["two"], r["flat"])
        np.testing.assert_array_equal(
            r["flat"], np.arange(7, dtype=np.float32) * 10)
        pod, data = r["coords"]
        pair = [2 * pod + d for d in range(2)]        # ranks of its data axis
        np.testing.assert_array_equal(r["dx"], np.full(3, sum(
            q + 1 for q in pair), np.float32))
        np.testing.assert_array_equal(r["y"], np.full(3, sum(pair),
                                                      np.float32))
