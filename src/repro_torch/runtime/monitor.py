"""Step-time monitoring: throughput accounting and straggler escalation
(the port of ``repro/runtime/monitor.py``, pure Python, whole).

In synchronous data-parallel training a straggling host slows every step
(the collective waits). Stragglers show as step-time outliers; the
monitor flags sustained regressions and, past ``sustained`` consecutive
outliers and outside the post-remesh ``cooldown``, escalates to
``remesh_suggested``. Restore and rebuild pauses (``note_recovery``) drop
the in-flight timing sample and the outlier run, so recovery never reads
as a straggler.

The heartbeat attribution (``note_heartbeats``, ``straggler_slice``), the
remesh / re-growth bookkeeping (``note_remesh``, ``note_regrow``,
probation) and the jitter fallback's signals (``stale_suggested``,
``stale_recovered``) come along whole; nothing in the port acts on them
until the elasticity slice (ROADMAP slice 7): the trainer refuses the
knobs that would.

The monitor also carries the replan loop's telemetry (the observed α,
each plan hot-swap), the per-table overflow EMA (``note_overflow``), the
async checkpointer's errors and retries, the live plan's bucketed
exchange and the analytic optimizer-apply seconds, all in the per-step
stats dict.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StepMonitor:
    window: int = 50
    straggler_factor: float = 2.0     # step > factor x median => outlier
    sustained: int = 5                # consecutive outliers => straggler
    min_samples: int = 10             # window fill before outlier detection
    cooldown: int = 0                 # steps after a remesh before the
                                      # monitor may suggest another (0 = none)
    jitter_enter: float = 0.3         # outlier fraction that suggests the
                                      # stale fallback (below eviction)
    jitter_exit: float = 0.1          # outlier fraction that suggests
                                      # flipping back to synchronous
    heartbeat_decay: float = 0.5      # per-slice heartbeat EMA decay
    times: collections.deque = field(default_factory=collections.deque)
    _last: Optional[float] = None     # start() timestamp; None = no sample
    _outlier_run: int = 0
    _outlier_flags: collections.deque = field(
        default_factory=collections.deque)   # windowed outlier bits (jitter)
    total_steps: int = 0
    total_tokens: int = 0
    observed_alpha: Optional[float] = None   # latest measured sparse α
    replans: int = 0                         # plan hot-swaps so far
    remeshes: int = 0                        # elastic mesh shrinks so far
    regrows: int = 0                         # elastic mesh re-growths so far
    stale_flips: int = 0                     # sync<->stale plan flips so far
    ckpt_retries: int = 0                    # background ckpt write retries
    heartbeats: dict = field(default_factory=dict)  # slice -> step-time EMA
    _slot_runs: dict = field(default_factory=dict)  # slice -> outlier run
    _probation: Optional[tuple] = None       # (slice, until_step, sustained)
    _probation_trip: Optional[int] = None    # slice that re-straggled on
                                             # probation (fast re-evict)
    _stale_on: bool = False                  # live plan has stale tables
    _last_remesh_step: Optional[int] = None  # total_steps at the last remesh
    ckpt_error: Optional[str] = None         # background checkpoint failure
    exchange: Optional[dict] = None          # bucketed-exchange accounting
                                             # (core/buckets.py stats)
    apply_seconds: Optional[float] = None    # analytic optimizer-apply cost
                                             # (state bytes / HBM bandwidth,
                                             # fused-apply aware)
    overflow: Optional[dict] = None          # per-table embed_dropped EMA
                                             # (rows silently zeroed / step)

    def start(self):
        self._last = time.perf_counter()

    def note_alpha(self, alpha: float):
        self.observed_alpha = float(alpha)

    def note_replan(self):
        self.replans += 1

    def note_remesh(self):
        """An elastic remesh landed: count it, arm the cooldown, and clear
        the timing window + outlier run — step times on the shrunken mesh
        are a different regime, and old-mesh medians would mis-attribute
        the first post-remesh (recompile) steps as fresh outliers."""
        self.remeshes += 1
        self._last_remesh_step = self.total_steps
        self.times.clear()
        self._outlier_run = 0
        self._outlier_flags.clear()
        self.heartbeats.clear()
        self._slot_runs.clear()
        self._probation = None
        self._probation_trip = None

    def note_regrow(self, slot: Optional[int] = None,
                    probation_steps: int = 0, probation_sustained: int = 2):
        """An elastic re-growth landed (an evicted host was re-admitted):
        count it and reset the escalation window + cooldown origin exactly
        like ``note_remesh`` — the grown world is a new step-time regime,
        and without the reset a grow immediately followed by jitter would
        double-escalate off pre-grow medians. Additionally arm a probation
        window on the re-admitted slice ``slot``: for ``probation_steps``
        steps, ``probation_sustained`` consecutive outlier heartbeats from
        that slice escalate straight to ``remesh_suggested`` — no second
        full ``sustained`` run, no cooldown wait."""
        self.regrows += 1
        self._last_remesh_step = self.total_steps
        self.times.clear()
        self._outlier_run = 0
        self._outlier_flags.clear()
        self.heartbeats.clear()
        self._slot_runs.clear()
        self._probation_trip = None
        self._probation = None
        if slot is not None and probation_steps > 0:
            self._probation = (int(slot), self.total_steps + probation_steps,
                               max(int(probation_sustained), 1))

    def note_heartbeats(self, beats: dict):
        """Fold decoded per-slice heartbeat scalars ({data-slice index ->
        step seconds}) into the attribution state: per-slice EMAs plus
        per-slice outlier runs (a slice is an outlier when its EMA exceeds
        ``straggler_factor`` x the median of the *other* slices). While a
        probation window is armed, the probationer re-straggling for
        ``probation_sustained`` beats trips the fast re-evict."""
        d = self.heartbeat_decay
        for slot, v in beats.items():
            slot = int(slot)
            old = self.heartbeats.get(slot)
            self.heartbeats[slot] = float(v) if old is None else \
                d * old + (1.0 - d) * float(v)
        if len(self.heartbeats) < 2:
            return
        for slot, ema in self.heartbeats.items():
            others = [v for s, v in self.heartbeats.items() if s != slot]
            others.sort()
            n = len(others)
            med = others[n // 2] if n % 2 else \
                0.5 * (others[n // 2 - 1] + others[n // 2])
            if med > 0 and ema > self.straggler_factor * med:
                self._slot_runs[slot] = self._slot_runs.get(slot, 0) + 1
            else:
                self._slot_runs[slot] = 0
        if self._probation is not None:
            slot, until, sustained = self._probation
            if self.total_steps > until:
                self._probation = None
            elif self._slot_runs.get(slot, 0) >= sustained:
                self._probation_trip = slot

    def straggler_slice(self) -> Optional[int]:
        """Name the slow data slice, when the heartbeats attribute one: the
        probation tripper if armed, else the slice whose outlier run meets
        ``sustained``. None = no attribution (the trainer falls back to its
        by-convention drop)."""
        if self._probation_trip is not None:
            return self._probation_trip
        best = None
        for slot, run in self._slot_runs.items():
            if run >= self.sustained and (best is None or run > best[1]):
                best = (slot, run)
        return best[0] if best else None

    def note_stale_flip(self, on: bool):
        """A sync<->stale plan flip landed (the jitter fallback): record the
        live mode and clear the jitter window so the hysteresis refills
        under the new plan before the opposite flip can fire."""
        self._stale_on = bool(on)
        self.stale_flips += 1
        self._outlier_flags.clear()

    def note_ckpt_retries(self, total: int):
        """Surface the async checkpointer's cumulative transient-write
        retry count (checkpoint/ckpt.py backoff loop) in the stats."""
        self.ckpt_retries = int(total)

    def note_recovery(self):
        """A restore/rebuild pause happened (checkpoint restore, failed-step
        retry): drop the in-flight timing sample and reset the outlier run
        so recovery latency doesn't count toward the straggler escalation."""
        self._outlier_run = 0
        self._last = None

    def note_ckpt_error(self, err: Optional[BaseException]):
        """Surface a background checkpoint failure in the per-step stats
        (previously only raised on the *next* wait(), i.e. up to ckpt_every
        steps after the bytes stopped reaching disk)."""
        self.ckpt_error = None if err is None else \
            f"{type(err).__name__}: {err}"

    def note_overflow(self, dropped: dict):
        """Record the per-table overflow EMA ({table: dropped rows/step}) —
        visible in stats before the capacity-growth replan fires, and its
        decay back to ~0 is the growth loop's success signal."""
        self.overflow = {k: float(v) for k, v in dropped.items()} \
            if dropped else None

    def note_exchange(self, stats: Optional[dict]):
        """Record the live plan's dense-exchange shape: bucket count, fused
        wire bytes, and per-step collective launches (None = per-tensor)."""
        self.exchange = dict(stats) if stats else None

    def note_apply(self, seconds: Optional[float]):
        """Record the analytic optimizer-apply cost for the live plan —
        total HBM traffic of the update (params/moments/EMA read+write,
        grads read, plus the unflatten->reflatten round trip the fused
        bucket-apply skips) over the hardware model's bandwidth."""
        self.apply_seconds = None if seconds is None else float(seconds)

    def stop(self, tokens: int = 0) -> dict:
        # a cleared _last means note_recovery dropped the in-flight sample
        # (the pause spans a restore, not a training step): keep the
        # throughput accounting but record no timing sample for it
        dt = time.perf_counter() - self._last if self._last is not None \
            else None
        self._last = None
        if dt is not None:
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.popleft()
        self.total_steps += 1
        self.total_tokens += tokens
        med = self.median()
        is_outlier = dt is not None and len(self.times) >= self.min_samples \
            and dt > self.straggler_factor * med
        self._outlier_run = self._outlier_run + 1 if is_outlier else 0
        if dt is not None and len(self.times) >= self.min_samples:
            self._outlier_flags.append(is_outlier)
            if len(self._outlier_flags) > self.window:
                self._outlier_flags.popleft()
        dt = dt or 0.0
        stats = {
            "step_time_s": dt,
            "median_s": med,
            "tokens_per_s": tokens / dt if dt > 0 else 0.0,
            "straggler_suspected": self.straggler_suspected,
            "remesh_suggested": self.remesh_suggested,
            "replans": self.replans,
            "remeshes": self.remeshes,
            "regrows": self.regrows,
        }
        if self.heartbeats:
            stats["heartbeats"] = dict(self.heartbeats)
            slot = self.straggler_slice()
            if slot is not None:
                stats["straggler_slice"] = slot
        if self._probation is not None:
            stats["probation_slice"] = self._probation[0]
        if self._outlier_flags:
            stats["jitter_ratio"] = self.jitter_ratio
        if self._stale_on or self.stale_flips:
            stats["stale_mode"] = self._stale_on
            stats["stale_flips"] = self.stale_flips
        if self.ckpt_retries:
            stats["ckpt_retries"] = self.ckpt_retries
        if self.observed_alpha is not None:
            stats["observed_alpha"] = self.observed_alpha
        if self.ckpt_error is not None:
            stats["ckpt_error"] = self.ckpt_error
        if self.overflow is not None:
            # per-table {table: dropped-rows EMA}; scalar max under its own
            # key so it can't shadow the raw per-step embed_dropped metric
            stats["overflow"] = dict(self.overflow)
            stats["overflow_rows"] = max(self.overflow.values(), default=0.0)
        if self.exchange is not None:
            stats["n_collectives"] = self.exchange["n_collectives_dense"]
            stats["exchange"] = self.exchange
            # topology-aware schedule surfacing: how many buckets ride the
            # two-level inter-host schedule, and whether the exchange is
            # overlap-issued inside the backward
            if "n_two_level" in self.exchange:
                stats["n_two_level"] = self.exchange["n_two_level"]
            if "overlap" in self.exchange:
                stats["overlap"] = self.exchange["overlap"]
            # sparse row-buffer pushes issued at gradient readiness inside
            # the backward (0 with overlap off or no gatherv tables)
            if "n_overlapped_sparse" in self.exchange:
                stats["n_overlapped_sparse"] = \
                    self.exchange["n_overlapped_sparse"]
        if self.apply_seconds is not None:
            stats["apply_seconds"] = self.apply_seconds
        return stats

    def median(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        n = len(s)
        if n % 2:
            return s[n // 2]
        return 0.5 * (s[n // 2 - 1] + s[n // 2])

    @property
    def straggler_suspected(self) -> bool:
        return self._outlier_run >= self.sustained

    @property
    def jitter_ratio(self) -> float:
        """Fraction of recent (window-filled) steps that were outliers —
        the signal for the bounded-staleness fallback: high ratio without a
        *sustained* run means intermittent contention, not a dead host."""
        if not self._outlier_flags:
            return 0.0
        return sum(self._outlier_flags) / len(self._outlier_flags)

    @property
    def stale_suggested(self) -> bool:
        """Sustained jitter below the eviction threshold: flip sparse
        tables to bounded-stale pushes instead of evicting anyone."""
        if self._stale_on or self.straggler_suspected:
            return False
        if len(self._outlier_flags) < self.min_samples:
            return False
        return self.jitter_ratio >= self.jitter_enter

    @property
    def stale_recovered(self) -> bool:
        """The jitter drained while the stale fallback was live: flip the
        tables back to synchronous (hysteresis: exit below jitter_exit)."""
        if not self._stale_on:
            return False
        if len(self._outlier_flags) < self.min_samples:
            return False
        return self.jitter_ratio <= self.jitter_exit

    @property
    def remesh_suggested(self) -> bool:
        """Escalation: a sustained outlier run outside the remesh cooldown.
        The trainer pairs this signal with a concrete shrink proposal
        (launch/mesh.shrink_mesh) before acting. A probation trip — the
        re-admitted slice re-straggled inside its probation window —
        escalates immediately, bypassing both the full sustained run and
        the cooldown (the first escalation already vetted this host)."""
        if self._probation_trip is not None:
            return True
        attributed = any(r >= self.sustained
                         for r in self._slot_runs.values())
        if not (self.straggler_suspected or attributed):
            return False
        if self.cooldown and self._last_remesh_step is not None and \
                self.total_steps - self._last_remesh_step < self.cooldown:
            return False
        return True
