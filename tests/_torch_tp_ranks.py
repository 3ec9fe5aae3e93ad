"""The ranks of tests/test_torch_tp_mesh.py and test_torch_serve_mesh.py:
spawned processes (``launch/mesh.py::spawn``) that train and serve the
reduced dense transformer with its attention and MLP tensor-parallel over
``model`` on a gloo process mesh. They import the port alone, not the JAX
package."""
import math

import numpy as np
import torch

import repro_torch.configs as tc
from repro_torch.core import collectives as coll
from repro_torch.core import sp
from repro_torch.core.plan import entry_axes
from repro_torch.core.transform import get_runner
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.server import (Request, Server, ServerConfig,
                                        _gather_slots)
from repro_torch.utils.roofline import Hardware
from repro_torch.weights import (gather_state, load_reference_params,
                                 shard_state)

SEQ, BATCH, STEPS = 32, 8, 3
# the reference test's RunConfig (tests/test_perf_paths.py)
KW = dict(attention_impl="naive", remat="none", param_dtype="float32",
          compute_dtype="float32", wire_dtype="float32")
# a record whose link makes the sequence-local K/V branch the cheaper one
# at any width (kv_local_favorable's other branch)
FREE_LINK = Hardware(link_bw=1e30)


def cfg(arch: str, **kw):
    return tc.reduced(tc.get_config(arch), **kw)


def batches(vocab: int, seq=SEQ, batch=BATCH, steps=STEPS):
    ds = SyntheticLM(vocab, seq, batch)
    return [ds.batch(i) for i in range(steps)]


def _placed(runner) -> dict:
    """This rank's parameter bytes beside the plan's parameter term, and
    each tensor-parallel leaf's share of its whole."""
    plan, mesh = runner.plan, runner.rt.mesh
    own = dict(runner.model.named_parameters())
    whole = dict(runner.model.param_specs())
    got = want = 0
    shares = {}
    for n, p in plan.params.items():
        t = own[n]
        got += t.numel() * t.element_size()
        shards = math.prod(mesh.axes_size(a) for a in p.placement
                           if a is not None)
        want += math.prod(whole[n].shape) * t.element_size() / shards
        if not p.sparse and n != "head" and any(
                "model" in entry_axes(e) for e in p.placement):
            # a tensor-parallel block's leaf (not a vocab-sharded table)
            shares[n] = t.numel() / math.prod(whole[n].shape)
    return {"bytes": got, "plan_bytes": want, "shares": shares,
            "held_is_placement": all(p.held == p.placement
                                     for p in plan.params.values())}


def train_rank(rank, world, mesh_shape, cases):
    """``cases``: [(key, arch, flags, named params, cfg overrides, local
    K/V forced)]. Each case's 3 steps on this rank of ``mesh_shape``."""
    m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    out = {}
    for key, arch, flags, named, over, local_kv in cases:
        c = cfg(arch, **over)
        if local_kv:
            sp.HW = FREE_LINK
        try:
            r = get_runner(c, tc.ShapeConfig("tiny", SEQ, BATCH, "train"),
                           tc.RunConfig(**KW, **flags), mesh=m,
                           params=load_reference_params(named, "cpu"))
            losses = [float(r.run(b)["loss"]) for b in batches(c.vocab_size)]
            chose = sp.kv_local_favorable(r.rt, c)
            # a checkpoint's gather-and-cut through the placements
            state = r.state
            whole = gather_state(state, r.plan, m)
            back = shard_state(whole, r.plan, m, dict(
                (n, s_.shape) for n, s_ in r.model.param_specs()))
            round_trip = all(
                tuple(whole.params[n].shape) == tuple(s_.shape)
                and torch.equal(back.params[n], state.params[n])
                and torch.equal(back.m[n], state.m[n])
                for n, s_ in r.model.param_specs())
        finally:
            sp.HW = Hardware()
        out[key] = {"loss": losses, "kv_local": chose,
                    "round_trip": round_trip,
                    "strategy": r.rt.resolved_strategy, **_placed(r)}
    return out


# ---------------------------------------------------------------------------
# the serve mesh
# ---------------------------------------------------------------------------

def _gathered(rt, logits: torch.Tensor) -> torch.Tensor:
    """This rank's (B/D, S, V/M) logits -> the whole (B, S, V) ones."""
    if rt.vocab_shards > 1:
        logits = coll.all_gather(logits, "model", rt.mesh, dim=-1)
    return logits[..., :rt.model_cfg.vocab_size]


def drive(sv, script: list) -> dict:
    """Run ``script`` through the engine's own steps and record the whole
    logits: ("prefill", slot, prompt) admits a prompt into a slot (on the
    data rank that owns it), ("decode", active slots) runs one decode step
    over the batch. The same script drives a one-device server. Returns
    the logits, the sampled tokens and the cache's per-rank shape."""
    rt = sv.rt
    rec = []
    prefill_fn, decode_fn = sv.model.prefill_cache_fn, sv.model.decode_fn

    def prefill_logits(tokens):
        logits, kv = prefill_fn(tokens)
        rec.append(_gathered(rt, logits))
        return logits, kv

    def decode_logits(cache, tokens, lens):
        logits, cache = decode_fn(cache, tokens, lens)
        rec.append(_gather_slots(sv.rt, _gathered(rt, logits)))
        return logits, cache

    sv.model.prefill_cache_fn = prefill_logits
    sv.model.decode_fn = decode_logits
    out = {"prefill": {}, "decode": [], "tokens": []}
    try:
        for op in script:
            if op[0] == "prefill":
                _, slot, prompt = op
                lb = 8
                while lb < len(prompt):
                    lb *= 2
                padded = torch.zeros((1, lb), dtype=torch.int32)
                padded[0, :len(prompt)] = torch.tensor(prompt)
                j = slot - sv._first
                if 0 <= j < sv._local:
                    rec.clear()
                    sv._prefill(sv.cache, sv.lens, sv.tok, padded,
                                len(prompt), j, sv._gen)
                    out["prefill"][slot] = rec[-1][0, :len(prompt)].clone()
                first = _gather_slots(sv.rt, sv.tok)[:, 0]
                out["tokens"].append(first.tolist())
            else:
                active = torch.zeros(sv.scfg.max_batch, dtype=torch.bool)
                active[list(op[1])] = True
                rec.clear()
                *_, toks = sv._decode(
                    sv.cache, sv.lens, sv.tok,
                    active[sv._first:sv._first + sv._local], sv._gen)
                out["decode"].append(rec[-1][:, 0].clone())
                out["tokens"].append(
                    _gather_slots(sv.rt, toks).tolist())
    finally:
        sv.model.prefill_cache_fn = prefill_fn
        sv.model.decode_fn = decode_fn
    out["cache_shape"] = [tuple(c.shape) for c in sv.cache]
    out["lens"] = _gather_slots(sv.rt, sv.lens).tolist()
    return out


def serve_rank(rank, world, runs, named, scfg_kw, script, prompts, new):
    """``runs``: [(mesh shape, arch)], each on this rank of a mesh of
    ``world`` ranks: the logits of ``script`` (``drive``), then a fresh
    engine's greedy tokens for ``prompts`` through
    ``run_until_drained``."""
    out = {}
    for mesh_shape, arch in runs:
        m = make_mesh(mesh_shape, ("data", "model"), device="cpu")
        c = cfg(arch)
        rc = tc.RunConfig(**KW)
        params = load_reference_params(named[arch], "cpu")
        sv = Server(c, rc, ServerConfig(**scfg_kw), mesh=m, params=params)
        res = drive(sv, script)
        # a slot whose positions all lie on other ranks: this rank's
        # decode over an empty block of the cache stays finite
        res["finite"] = all(bool(torch.isfinite(t).all())
                            for t in res["decode"])
        sv = Server(c, rc, ServerConfig(**scfg_kw), mesh=m, params=params)
        for i, p in enumerate(prompts):
            sv.submit(Request(i, np.asarray(p, np.int32),
                              max_new_tokens=new))
        done = sv.run_until_drained()
        res["served"] = {r.uid: list(r.out_tokens) for r in done}
        res["stats"] = {k: sv.stats[k] for k in ("prefill_calls",
                                                 "cross_slot_mismatches")}
        res["prefill"] = {k: v.numpy() for k, v in res["prefill"].items()}
        res["decode"] = [t.numpy() for t in res["decode"]]
        out[(mesh_shape, arch)] = res
    return out
