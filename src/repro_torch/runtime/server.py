"""Serving engine: batched prefill + persistent slot-paged decode (the port
of ``repro/runtime/server.py``), on one device or a process mesh.

  admission   one prefill step per request: the full forward over the
              bucket-padded prompt collects every layer's K/V, inserts the
              rows into the live decode cache at the request's slot,
              samples the first token on the device and sets the slot's
              length. Prompts are padded to power-of-two buckets, so an
              engine sees few distinct prefill shapes.
  decode      one step over the whole batch with per-slot device state: a
              (B,) length vector (each slot masks exactly its own valid
              cache prefix), a (B, 1) pending-token buffer fed from the
              previous step's device-side sample, and a host-provided
              occupancy mask.
  host work   a staging thread pads and buckets queued prompts off the
              critical path; a detokenize thread materializes sampled tokens
              (``.cpu()`` on the default stream, after the kernels that
              produced them), records TTFT and per-token times, and flags
              completions — the decode loop never blocks on a device->host
              copy.

``stats`` keeps the reference's keys; ``prefill_traces`` and
``decode_traces`` count the first call per padded shape, which is what the
reference's ``jit`` traces. The serve path is planned (``analyze()`` at the
decode ShapeConfig), so ``Plan.tables()`` carries each table's serve
pricing.

``ToyServer`` is the pre-engine loop (teacher-forced token-at-a-time
prefill through the shared decode step, one shared cache_len, greedy
argmax) — the baseline, and the loop for the recurrent families and
seamless.

Everything runs on ``device`` (default: the card).

On a process mesh (``launch/mesh.py::make_mesh``; every rank builds the
``Server`` with the same arguments and submits the same requests) the
weights are this rank's shards over ``model`` (the attention and MLP run
tensor-parallel, the head is vocab-sharded; a server holds its weights
whole over the batch axes), the slots are split over the batch axes
(max_batch/D on each data rank) and the decode cache is this rank's
(n_layers, B/D, S/M, KV, hd) block, as the reference's
``cache_pspec_tree`` places it. Every rank runs the same host scheduler
on the same stream, in step: no staging or detokenize thread (their
timing would differ between ranks); a slot's prefill runs on the model
ranks of the data rank that owns it, and each step's tokens are
all-gathered over the batch axes, so every rank's bookkeeping sees every
slot. Greedy sampling takes the argmax over the vocab shards; a draw
gathers the logits on every rank, whose generators share the seed.
``ToyServer`` runs on a process mesh the same way (the recurrent carries
at each rank's share of the units, channels or heads).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import collectives as coll
from repro_torch.core.plan import gate_groups, model_part
from repro_torch.core.runtime import Runtime
from repro_torch.core.transform import (analyze, init_params_, load_params_,
                                        make_decode_step,
                                        make_serve_decode_step,
                                        make_serve_prefill_step,
                                        place_params_, sample_tokens)
from repro_torch.launch.mesh import Mesh, MeshShape
from repro_torch.models.model import build_model
from repro_torch.utils.tree import named_parameters

MIN_BUCKET = 8


def bucket_len(prompt_len: int, max_seq: int, lo: int = MIN_BUCKET) -> int:
    """Power-of-two prompt-length bucket (capped at the cache length)."""
    b = lo
    while b < prompt_len:
        b *= 2
    return min(b, max_seq)


def prefill_buckets(max_seq: int, lo: int = MIN_BUCKET) -> list:
    """Every bucket a ``max_seq`` engine can see."""
    out, b = [], lo
    while b < max_seq:
        out.append(b)
        b *= 2
    return out + [max_seq]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False
    # ---- timing (seconds, time.perf_counter clock) ----
    t_submit: float = 0.0
    t_first: float = 0.0          # first generated token materialized (TTFT)
    token_times: list = field(default_factory=list)

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit if self.t_first else float("inf")


@dataclass
class ServerConfig:
    max_batch: int = 8
    max_seq: int = 256
    greedy: bool = True           # device-side argmax; False -> temperature
    temperature: float = 1.0      # categorical sampling when greedy=False


def _setup(model_cfg, run_cfg, scfg, mesh, params, seed, device, *,
           paged: bool):
    """Runtime, model (parameters filled), plan — shared by both engines.
    ``paged``: the engine needs a positional KV cache; refuse a family
    without one before any parameter is drawn. On a process mesh the
    parameters are this rank's shards of the one-device ones (the same
    draw from ``seed``, or ``params`` cut): the plan's placements with the
    batch axes dropped (a ZeRO-3 placement from the memory escalation
    prices optimizer bytes a server never holds)."""
    if isinstance(mesh, MeshShape) and not isinstance(mesh, Mesh):
        raise ValueError(f"{mesh!r} holds no process groups: a server "
                         "runs on a launch/mesh.py::make_mesh mesh")
    shape = ShapeConfig("serve", scfg.max_seq, scfg.max_batch, "decode")
    rt = Runtime(model_cfg, run_cfg, shape, mesh=mesh, device=device)
    model = build_model(model_cfg, rt)
    if paged and model.prefill_cache_fn is None:
        raise ValueError(
            f"family {model_cfg.family!r} cannot be bucket-prefilled "
            "exactly (recurrent carry under padding) — use ToyServer")
    plan = analyze(model, rt)
    rt.plan = plan
    mesh_plan = None
    if mesh is not None:
        for name, spec in model.param_specs():
            p = plan.params[name]
            p.held = model_part(p.placement)
            p.groups = gate_groups(name, spec.axes, p.held)
        place_params_(model, plan, mesh)
        mesh_plan = plan
    if params is None:
        init_params_(model, seed, mesh_plan)
    else:
        load_params_(model, params, mesh_plan)
    model.requires_grad_(False)
    return rt, model, plan


def _gather_slots(rt, x: torch.Tensor) -> torch.Tensor:
    """Every data rank's slots of ``x`` (this rank's (B/D, ...)) -> (B,
    ...) on every rank."""
    if rt.mesh is None:
        return x
    return coll.all_gather(x, tuple(rt.batch_axes), rt.mesh)


class Server:
    """The engine: batched prefill, slot-paged decode, threaded admission
    and detokenization. Requires a family with a positional KV cache
    (``model.prefill_cache_fn``); recurrent families use ``ToyServer``.

    ``params``: {dotted_name: tensor} to serve (e.g. another server's
    ``params``, or ``weights.load_reference_params``); None draws a seeded
    init."""

    def __init__(self, model_cfg: ModelConfig, run_cfg: RunConfig,
                 scfg: ServerConfig, mesh=None, params=None, seed: int = 0,
                 *, device=None):
        self.rt, self.model, self.plan = _setup(
            model_cfg, run_cfg, scfg, mesh, params, seed, device, paged=True)
        self.scfg = scfg
        self.params = named_parameters(self.model)
        rt = self.rt
        dev = rt.device

        b, s = scfg.max_batch, scfg.max_seq
        self.cache = self.model.init_cache(b, s)
        # this rank's slots: [first, first + local) of the max_batch
        self._local = rt.cache_shard(b, s)[0]
        self._first = (rt.mesh.index(rt.batch_axes) * self._local
                       if rt.mesh is not None else 0)
        self.lens = torch.zeros((self._local,), dtype=torch.int32,
                                device=dev)
        self.tok = torch.zeros((self._local, 1), dtype=torch.int32,
                               device=dev)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed + 1)

        self.stats = {"prefill_calls": 0, "prefill_traces": 0,
                      "decode_steps": 0, "decode_traces": 0,
                      "buckets": set(), "cross_slot_mismatches": 0}
        self._prefill = make_serve_prefill_step(
            self.model, rt, self.plan, greedy=scfg.greedy,
            temperature=scfg.temperature)
        self._decode = make_serve_decode_step(
            self.model, rt, self.plan, max_seq=s, greedy=scfg.greedy,
            temperature=scfg.temperature)

        # ---- slot bookkeeping (host) ----
        self.slot_req: list = [None] * b
        self.completed: list = []

        # ---- threads: admission staging + detokenize/completion ----
        self.queue: deque = deque()
        self._qcv = threading.Condition()
        self._staged: deque = deque()             # (req, padded, plen)
        self._pending = 0                         # submitted, not completed
        self._freed: deque = deque()              # slots to recycle
        self._detok_q: deque = deque()
        self._detok_cv = threading.Condition()
        self._inflight = 0
        self._stop = False
        self._thread_err: list = []
        # a process mesh runs the host work in step on every rank
        self._sync = rt.mesh is not None
        if not self._sync:
            self._admitter = threading.Thread(target=self._admit_worker,
                                              daemon=True)
            self._detok = threading.Thread(target=self._detok_worker,
                                           daemon=True)
            self._admitter.start()
            self._detok.start()

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        if len(req.prompt) >= self.scfg.max_seq:
            raise ValueError(f"prompt ({len(req.prompt)}) must leave room "
                             f"for generation (max_seq {self.scfg.max_seq})")
        req.t_submit = time.perf_counter()
        with self._qcv:
            self._pending += 1
            self.queue.append(req)
            self._qcv.notify()

    def close(self):
        """Stop both threads and wait for them."""
        self._stop = True
        if self._sync:
            return
        with self._qcv:
            self._qcv.notify_all()
        with self._detok_cv:
            self._detok_cv.notify_all()
        self._admitter.join(timeout=10)
        self._detok.join(timeout=10)

    # ------------------------------------------------------------------
    # admission staging thread: pad + bucket prompts off the decode path
    def _stage(self, req: Request) -> tuple:
        plen = len(req.prompt)
        lb = bucket_len(plen, self.scfg.max_seq)
        padded = np.zeros((1, lb), np.int32)
        padded[0, :plen] = req.prompt
        return req, padded, plen

    def _admit_worker(self):
        try:
            while not self._stop:
                with self._qcv:
                    while not self.queue and not self._stop:
                        self._qcv.wait(0.1)
                    if self._stop:
                        return
                    req = self.queue.popleft()
                self._staged.append(self._stage(req))
        except BaseException as e:            # surfaced in the serve loop
            self._thread_err.append(e)

    # detokenize thread: the only place device results are materialized
    def _consume(self, arr, mapping):
        vals = arr.cpu().numpy()              # waits HERE, not in step()
        now = time.perf_counter()
        for idx, slot, req in mapping:
            if req.done:
                continue                      # slot kept decoding past done
            tok = int(vals[idx])
            if tok < 0:
                # the decode step stamps -1 on inactive slots; one in an
                # active mapping means slot state leaked
                self.stats["cross_slot_mismatches"] += 1
                continue
            req.out_tokens.append(tok)
            req.token_times.append(now)
            if not req.t_first:
                req.t_first = now
            plen = len(req.prompt)
            if len(req.out_tokens) >= req.max_new_tokens or \
                    plen + len(req.out_tokens) >= self.scfg.max_seq:
                req.done = True
                self.completed.append(req)
                self._freed.append(slot)
                with self._qcv:
                    self._pending -= 1

    def _detok_worker(self):
        try:
            while True:
                with self._detok_cv:
                    while not self._detok_q and not self._stop:
                        self._detok_cv.wait(0.1)
                    if self._detok_q:
                        item = self._detok_q.popleft()
                    elif self._stop:
                        return
                    else:
                        continue
                self._consume(*item)
                with self._detok_cv:
                    self._inflight -= 1
                    self._detok_cv.notify_all()
        except BaseException as e:
            self._thread_err.append(e)

    def _push_detok(self, arr, mapping):
        if self._sync:
            self._consume(arr, mapping)
            return
        with self._detok_cv:
            self._detok_q.append((arr, mapping))
            self._inflight += 1
            self._detok_cv.notify()

    def _check_threads(self):
        if self._thread_err:
            raise RuntimeError("server worker thread died") \
                from self._thread_err[0]

    # ------------------------------------------------------------------
    def _admit(self) -> int:
        """One prefill per staged request into free slots (on a mesh, run
        by the model ranks of the slot's data rank)."""
        if self._sync:
            while self.queue:
                self._staged.append(self._stage(self.queue.popleft()))
        admitted = []
        for i in range(self.scfg.max_batch):
            if self.slot_req[i] is not None or not self._staged:
                continue
            req, padded, plen = self._staged.popleft()
            self.slot_req[i] = req
            lb = padded.shape[1]
            self.stats["prefill_calls"] += 1
            if lb not in self.stats["buckets"]:
                self.stats["prefill_traces"] += 1
            self.stats["buckets"].add(lb)
            first = None
            j = i - self._first
            if 0 <= j < self._local:
                tokens = torch.from_numpy(padded).to(self.rt.device)
                self.cache, self.lens, self.tok, first = self._prefill(
                    self.cache, self.lens, self.tok, tokens, plen, j,
                    self._gen)
            admitted.append((i, req, first))
        if admitted and self.rt.replicas > 1:
            # the first tokens of every data rank's slots
            toks = _gather_slots(self.rt, self.tok)[:, 0]
            self._push_detok(toks, [(i, i, req) for i, req, _ in admitted])
        else:
            for i, req, first in admitted:
                self._push_detok(first, [(0, i, req)])
        return len(admitted)

    def step(self) -> int:
        """One engine iteration: recycle slots, admit, one decode step.
        Returns the number of active slots."""
        self._check_threads()
        while self._freed:
            self.slot_req[self._freed.popleft()] = None
        self._admit()
        active_idx = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active_idx:
            return 0
        active = np.zeros(self.scfg.max_batch, bool)
        active[active_idx] = True
        active = active[self._first:self._first + self._local]
        if self.stats["decode_steps"] == 0:
            self.stats["decode_traces"] += 1      # one shape: traced once
        self.cache, self.lens, self.tok, out = self._decode(
            self.cache, self.lens, self.tok,
            torch.from_numpy(active).to(self.rt.device), self._gen)
        self.stats["decode_steps"] += 1
        self._push_detok(
            _gather_slots(self.rt, out),
            [(i, i, self.slot_req[i]) for i in active_idx])
        # bound the run-ahead so a lagging detokenizer can't let the loop
        # burn steps decoding slots that already completed
        with self._detok_cv:
            while self._inflight > 2 * self.scfg.max_batch:
                self._detok_cv.wait(0.05)
        return len(active_idx)

    def run_until_drained(self, max_iters: int = 10_000) -> list:
        it = 0
        while self._pending > 0 and it < max_iters:
            if self.step() == 0:
                # nothing on the device: staging or detok is catching up
                time.sleep(0.0002)
                self._check_threads()
            it += 1
        # let in-flight detok finish so timings/completions are final
        with self._detok_cv:
            while self._inflight > 0 and not self._thread_err:
                self._detok_cv.wait(0.1)
        self._check_threads()
        while self._freed:
            self.slot_req[self._freed.popleft()] = None
        return self.completed


# ---------------------------------------------------------------------------
# the pre-engine loop: baseline + recurrent families
# ---------------------------------------------------------------------------

class ToyServer:
    """Teacher-forced token-at-a-time prefill through the shared decode
    step, one shared cache_len, greedy argmax — the loop the engine
    replaced. Admission costs O(prompt_len) blocking steps that stall every
    active slot, and the shared ``cache_len`` makes every slot attend over
    ``slot_pos.max()`` positions.

    On a process mesh it runs as ``Server`` does: every rank builds it
    with the same arguments, submits the same requests and runs the same
    host schedule in step (one ``cache_len`` over all slots); the slots
    are split over the batch axes, each rank stepping its own with its
    block of the cache (the recurrent carries at its share of the units,
    channels or heads; the K/V positions over ``model``); the greedy
    token is taken over the vocab shards and every data rank's tokens are
    all-gathered, so every rank's bookkeeping sees every slot."""

    def __init__(self, model_cfg: ModelConfig, run_cfg: RunConfig,
                 scfg: ServerConfig, mesh=None, params=None, seed: int = 0,
                 *, device=None):
        self.rt, self.model, self.plan = _setup(
            model_cfg, run_cfg, scfg, mesh, params, seed, device, paged=False)
        rt = self.rt
        self.scfg = scfg
        self.params = named_parameters(self.model)
        self.cache = self.model.init_cache(scfg.max_batch, scfg.max_seq)
        # this rank's slots: [first, first + local) of the max_batch
        self._local = scfg.max_batch // max(rt.replicas, 1)
        self._first = (rt.mesh.index(rt.batch_axes) * self._local
                       if rt.mesh is not None else 0)
        self.decode_step = make_decode_step(self.model, rt, self.plan)
        self.slot_req: list = [None] * scfg.max_batch
        self.slot_pos = np.zeros(scfg.max_batch, np.int32)
        self.queue: deque = deque()
        self.completed: list = []
        self._tokens = np.zeros((scfg.max_batch, 1), np.int32)
        self.stats = {"prefill_calls": 0, "decode_steps": 0}

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _admit(self):
        for i in range(self.scfg.max_batch):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.popleft()
                self.slot_req[i] = req
                self.stats["prefill_calls"] += 1
                # teacher-forced prefill: prompt tokens one by one through
                # the decode step; the other slots' pending tokens are kept
                # aside (zeroed per step) and restored before the next
                # shared decode step
                pending = self._tokens.copy()
                for t in req.prompt[:-1]:
                    self._tokens[:] = 0
                    self._tokens[i, 0] = t
                    self._step_device()
                    self.slot_pos[i] += 1
                self._tokens[:] = pending
                self._tokens[i, 0] = req.prompt[-1]

    def _step_device(self):
        # one shared cache_len: a homogeneous-position batch; per-slot
        # positions are tracked on the host. This rank's slots' tokens are
        # copied to the device before the host buffer changes again.
        mine = self._tokens[self._first:self._first + self._local].copy()
        logits, self.cache = self.decode_step(
            self.cache, torch.from_numpy(mine).to(self.rt.device),
            int(self.slot_pos.max()))
        return logits

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        """(B/D, 1, V/M) logits -> every slot's greedy token (B,), on the
        host: the first maximum over the vocab shards, every data rank's
        slots gathered."""
        rt = self.rt
        if rt.mesh is None:
            return logits[:, 0, :].argmax(dim=-1).cpu().numpy()
        nxt = sample_tokens(logits[:, 0, :], greedy=True, temperature=1.0,
                            rt=rt)
        return _gather_slots(rt, nxt).cpu().numpy()

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One decode iteration over all active slots; returns #active."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        logits = self._step_device()
        self.stats["decode_steps"] += 1
        nxt = self._greedy(logits)
        now = time.perf_counter()
        for i in active:
            req = self.slot_req[i]
            tok = int(nxt[i])
            req.out_tokens.append(tok)
            req.token_times.append(now)
            if not req.t_first:
                req.t_first = now
            self.slot_pos[i] += 1
            self._tokens[i, 0] = tok
            if len(req.out_tokens) >= req.max_new_tokens or \
                    self.slot_pos[i] >= self.scfg.max_seq - 1:
                req.done = True
                self.completed.append(req)
                self.slot_req[i] = None
                self.slot_pos[i] = 0
                self._tokens[i, 0] = 0
        return len(active)

    def run_until_drained(self, max_iters: int = 10_000) -> list:
        it = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and it < max_iters:
            self.step()
            it += 1
        return self.completed
