"""Fault-tolerant checkpoints (the port of ``repro/checkpoint/ckpt.py``),
in the JAX package's on-disk layout, so that a checkpoint written by
either package restores in the other.

Layout (one directory per step):
    ckpt_dir/
      step_00000100.tmp/        # written first
        manifest.json           # {"step", "extra", "leaves": [{"path",
                                #   "key", "shape", "dtype", "none"}]}
        shard_0_0.npz           # every leaf as a full logical tensor
      step_00000100/            # the rename commits the checkpoint

A leaf is named as the reference's ``named_leaves`` names a ``TrainState``
leaf: ``step``, then ``params.<name>``, ``m.<name>``, ``v.<name>``,
``ema.<name>`` in flatten order (a ``None`` part has no leaves). bf16 is
stored as a ``uint16`` view and its logical dtype recorded, through
torch's 16-bit view (no numpy bf16 type needed).

Guarantees:
  * atomicity: a reader sees only committed checkpoints (the tmp dir is
    renamed after the manifest is synced; a crash leaves only ``.tmp``);
  * elasticity: leaves are whole tensors, so a checkpoint restores onto
    any mesh (``weights.shard_state`` cuts them, ``build_step`` does it);
  * async: ``AsyncCheckpointer`` copies the state to the host on the
    caller's thread and writes in a background thread, with retries.

On a mesh the caller gathers the state whole on every rank
(``weights.gather_state``) and one rank writes (runtime/trainer.py).
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
from dataclasses import replace
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.optimizer import TrainState
from repro_torch.utils.dtypes import dtype_name
from repro_torch.weights import STATE_PARTS

log = logging.getLogger("repro_torch.ckpt")

_NUMPY = {"float32": np.float32, "float16": np.float16, "int32": np.int32,
          "int64": np.int64}
_TORCH = {"float32": torch.float32, "float16": torch.float16,
          "int32": torch.int32, "int64": torch.int64}


def state_leaves(state: TrainState) -> list:
    """[(path, leaf)] as the reference's ``named_leaves`` lists a
    TrainState: ``step`` first, then each part's leaves in flatten order
    (the order of the port's parameter dicts)."""
    out = [("step", state.step)]
    for part in STATE_PARTS:
        tree = getattr(state, part)
        for n, t in (tree or {}).items():
            out.append((f"{part}.{n}", t))
    return out


def _to_numpy(leaf) -> tuple:
    """A leaf -> (numpy array as stored, logical dtype name)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, np.int32), "int32"      # the step counter
    t = leaf.detach().cpu()
    name = dtype_name(t.dtype) if t.dtype.is_floating_point else \
        str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _to_torch(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(
                torch.bfloat16).to(device)
    if dtype not in _TORCH:
        raise ValueError(f"unsupported checkpoint dtype {dtype!r}")
    return torch.from_numpy(np.ascontiguousarray(arr, _NUMPY[dtype])).to(
        device)


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState,
                    extra: Optional[dict] = None) -> str:
    """Write ``state`` (canonical, whole leaves) atomically; returns the
    committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    arrays = {}
    for i, (path, leaf) in enumerate(state_leaves(state)):
        arr, dtype = _to_numpy(leaf)
        key = f"a{i}"
        arrays[key] = arr
        manifest["leaves"].append({"path": path, "key": key,
                                   "shape": list(arr.shape), "dtype": dtype,
                                   "none": False})
    np.savez(os.path.join(tmp, "shard_0_0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):          # an idempotent re-save of a step
        shutil.rmtree(final)
    os.rename(tmp, final)              # the commit
    return final


_STEP_DIR = re.compile(r"^step_(\d{8,})$")   # the step_%08d writer's names


def _committed_steps(ckpt_dir: str) -> list:
    """Step numbers of committed checkpoints, ignoring what this writer
    could not have produced: stray files, in-flight ``.tmp`` dirs and
    unpadded ``step_7``-style names."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_DIR.match(d)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, state_like: TrainState,
                       step: Optional[int] = None, device="cpu"
                       ) -> tuple:
    """Read a checkpoint into the structure of ``state_like`` (its leaf
    names; a leaf the checkpoint lacks keeps ``state_like``'s tensor).
    Every restored leaf is the whole tensor on ``device``; on a mesh
    ``build_step`` cuts this rank's shards. -> (state, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    with np.load(os.path.join(d, "shard_0_0.npz")) as data:
        def leaf(path, like):
            ent = by_path.get(path)
            if ent is None or ent.get("none"):
                return like
            return _to_torch(data[ent["key"]], ent["dtype"], device)

        ent = by_path.get("step")
        step_val = int(data[ent["key"]]) if ent else state_like.step
        parts = {}
        for part in STATE_PARTS:
            tree = getattr(state_like, part)
            parts[part] = None if tree is None else {
                n: leaf(f"{part}.{n}", t) for n, t in tree.items()}
    state = replace(state_like, step=step_val, **parts)
    return state, manifest["step"], manifest.get("extra", {})


def gc_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    for s in _committed_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def host_snapshot(state: TrainState) -> TrainState:
    """A copy of ``state`` on the host that no later step can touch: the
    port's steps update parameters and moments in place, and ``.cpu()`` of
    a CPU tensor is the same storage, so every leaf is cloned."""
    parts = {part: None if getattr(state, part) is None else
             {n: t.detach().to("cpu", copy=True)
              for n, t in getattr(state, part).items()}
             for part in STATE_PARTS}
    return replace(state, step=int(state.step), **parts)


class AsyncCheckpointer:
    """Snapshot to the host, then write in a background thread; at most
    one write in flight.

    A failed background write is retried up to ``retries`` times with
    exponential backoff (``backoff * 2**attempt`` seconds) before the
    failure is kept for the next ``wait()``; ``total_retries`` counts the
    retries (the monitor's ``ckpt_retries``). ``snapshot_seconds`` and
    ``write_seconds`` time the last save's two halves (the host copy on
    the caller's thread, the committed write in the background)."""

    def __init__(self, ckpt_dir: str, keep: int = 3, retries: int = 3,
                 backoff: float = 0.05):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.retries = retries
        self.backoff = backoff
        self.total_retries = 0
        self._thread: Optional[threading.Thread] = None
        self.last_committed: Optional[int] = None
        self._error: Optional[BaseException] = None
        self.snapshot_seconds: Optional[float] = None
        self.write_seconds: Optional[float] = None

    @property
    def error(self) -> Optional[BaseException]:
        """The last background-write failure, without consuming it."""
        return self._error

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_sync(self, step: int, state: TrainState,
                  extra: Optional[dict] = None) -> None:
        """Commit on the caller's thread: wait out any write in flight
        (a stale background failure is logged and dropped, not raised),
        write, collect old checkpoints, record the commit."""
        try:
            self.wait()
        except Exception:
            log.exception("discarding stale async checkpoint failure "
                          "before synchronous save of step %d", step)
        save_checkpoint(self.ckpt_dir, step, state, extra)
        gc_checkpoints(self.ckpt_dir, self.keep)
        self.last_committed = step

    def save(self, step: int, state: TrainState,
             extra: Optional[dict] = None) -> None:
        self.wait()
        # the snapshot is taken here, so training may overwrite the live
        # tensors in place as soon as this returns
        t0 = time.perf_counter()
        snap = host_snapshot(state)
        self.snapshot_seconds = time.perf_counter() - t0

        def work():
            t1 = time.perf_counter()
            for attempt in range(self.retries + 1):
                try:
                    save_checkpoint(self.ckpt_dir, step, snap, extra)
                    gc_checkpoints(self.ckpt_dir, self.keep)
                    self.last_committed = step
                    self.write_seconds = time.perf_counter() - t1
                    return
                except BaseException as e:
                    if attempt >= self.retries:
                        self._error = e      # raised by the next wait()
                        return
                    self.total_retries += 1
                    log.warning(
                        "background checkpoint write of step %d failed "
                        "(%s: %s); retry %d/%d", step, type(e).__name__, e,
                        attempt + 1, self.retries)
                    time.sleep(self.backoff * (2 ** attempt))

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
