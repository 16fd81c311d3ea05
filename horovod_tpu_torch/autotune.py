"""Autotuner: runtime search over performance knobs (port of
``horovod_tpu/autotune.py``).

A rebuild of the reference's ``ParameterManager``
(``horovod/common/parameter_manager.cc``, ``parameter_manager.h:42-110``):
while training runs, each candidate knob configuration is scored by the
observed collective throughput (bytes/sec), the space is explored, and
the best configuration is kept. ``HVD_AUTOTUNE_STRATEGY`` picks the
search:

* ``coordinate`` (default): cyclic coordinate search over the discrete
  grids;
* ``bayesian``: the reference's GP + expected-improvement loop
  (:mod:`horovod_tpu_torch.optim.bayes`) over the same grids, with
  ``HVD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE`` as the GP noise.

The tuned knobs are the JAX package's that have a consumer in the port:
``FUSION_THRESHOLD`` (wire-buffer size: ``collectives._fusion_layout``),
``CYCLE_TIME`` and ``PENDING_CYCLE_TIME`` (the fusion cycle's pace and the
negotiation service's tick), ``MAX_INFLIGHT_FLUSHES`` and
``PIPELINE_CHUNKS`` (the pipelined executor), ``BUCKET_BYTES`` (the
optimizer's gradient buckets), ``STEP_CAPTURE``, ``QOS_QUANTUM`` and
``QOS_WINDOW``, ``HIERARCHICAL_ALLREDUCE`` and ``CACHE_CAPACITY``. They
move through the knob override table (``envs.set_override``), whose epoch
drops the dispatch plans and captured steps that baked the old values.
The JAX package's ``GSPMD_CACHE`` knob has no consumer in the port yet.

Knobs pinned in the environment are fixed and not tuned, as in the
reference. The first ``HVD_AUTOTUNE_WARMUP_SAMPLES`` samples are
discarded, each sample scores ``HVD_AUTOTUNE_STEPS_PER_SAMPLE`` recorded
collectives, and the search stops after
``HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES`` samples or when a pass improves
nothing. ``HVD_AUTOTUNE_LOG`` writes one CSV row a sample.

Every rank must apply the same knob values (a two-level allreduce on one
rank and a flat one on another hang), so rank 0 averages the scores and
decides, and the decision travels over the launcher's KV store
(:class:`KVScoreSync`, the analog of ``Controller::SynchronizeParameters``).
"""

from __future__ import annotations

import csv
import json
import math
import threading
import time

import numpy as np

from .utils import envs
from .utils import logging as hvd_logging

KB = 1024
MB = 1024 * 1024

DEFAULT_WARMUP_SAMPLES = 3       # parameter_manager.h:42-110
DEFAULT_STEPS_PER_SAMPLE = 10
DEFAULT_MAX_SAMPLES = 40
DEFAULT_GP_NOISE = 0.8           # reference HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE
_EI_TOL = 1e-3                   # bayesian: converged when EI stays below
_EI_PATIENCE = 2                 # ... for this many consecutive proposals


class Tunable:
    """One knob: a discrete candidate grid plus an applier."""

    def __init__(self, knob: str, candidates, apply_fn=None):
        self.knob = knob
        self.candidates = list(candidates)
        self.apply_fn = apply_fn
        self.fixed = envs.is_env_fixed(knob)
        self.index = 0

    @property
    def value(self):
        return self.candidates[self.index]

    def apply(self):
        envs.set_override(self.knob, self.value)
        if self.apply_fn is not None:
            self.apply_fn(self.value)


def _default_tunables() -> list[Tunable]:
    return [
        Tunable(envs.FUSION_THRESHOLD,
                [1 * MB, 4 * MB, 16 * MB, 64 * MB, 128 * MB, 256 * MB]),
        # CYCLE_TIME now drives TWO consumers: the dynamic engine's
        # negotiation tick AND the fusion-cycle flush pace of queued
        # async collectives (ops/fusion_cycle.py; both re-read the knob
        # live, so tuned values take effect between flushes).
        Tunable(envs.CYCLE_TIME, [1.0, 2.5, 5.0, 10.0, 20.0, 40.0]),
        # Flush pace while work is in flight (fusion cycle) / in-flight
        # negotiation tick floor (engine service).
        Tunable(envs.PENDING_CYCLE_TIME, [0.5, 1.0, 2.0, 5.0]),
        # Pipelined flush executor slots (ops/fusion_cycle.py): first
        # candidate = the default so enabling autotune changes nothing at
        # sample 0; 1 = synchronous executor. Safe to tune per-process
        # tier because slot count never changes flush composition or
        # program issue order (single FIFO dispatch thread), but decisions
        # still sync through rank 0 like every knob.
        Tunable(envs.MAX_INFLIGHT_FLUSHES, [envs.DEFAULT_MAX_INFLIGHT_FLUSHES,
                                            1, 4]),
        # Chunk count for the large-buffer wire pipeline (single-
        # controller only — multi-process plans keep the joined-
        # compatible one-program composition, so tuning it cannot
        # desynchronize programs). Flipping it bumps the envs override
        # epoch, which rebuilds the chunked dispatch plans.
        Tunable(envs.PIPELINE_CHUNKS, [envs.DEFAULT_PIPELINE_CHUNKS, 2, 8]),
        # Gradient bucket size for the eager backward-pass overlap
        # (consumer: optim/_bucketed_allreduce, which re-reads the knob
        # per update). First candidate = the default so enabling autotune
        # changes nothing at sample 0. Bucket layout is a pure function
        # of leaf sizes + this knob, and decisions sync through rank 0,
        # so multi-process composition stays rank-deterministic.
        Tunable(envs.BUCKET_BYTES, [envs.DEFAULT_BUCKET_BYTES,
                                    8 * MB, 16 * MB, 32 * MB, 128 * MB]),
        # Step capture-and-replay (ops/step_capture.py). Default-off
        # first so enabling autotune changes nothing at sample 0; when
        # the tuner flips it on, marked steps record once and replay as
        # one cached program. Flipping the override bumps the envs
        # epoch, which drops cached step plans — a stale capture can
        # never survive a knob change.
        Tunable(envs.STEP_CAPTURE, [0, 1]),
        # Multi-tenant QoS pacing (qos.py; consumed live per gate pump,
        # inert with HVD_QOS=0). Defaults first so enabling autotune
        # changes nothing at sample 0. Safe to tune: quantum/window only
        # re-pace the gate's DETERMINISTIC grant schedule (decisions
        # sync through rank 0 like every knob, and both are pure-config
        # inputs to the grant order, never completion timing).
        Tunable(envs.QOS_QUANTUM, [envs.DEFAULT_QOS_QUANTUM,
                                   16 * 1024, 256 * 1024]),
        Tunable(envs.QOS_WINDOW, [envs.DEFAULT_QOS_WINDOW, 2, 8]),
        Tunable(envs.HIERARCHICAL_ALLREDUCE, [0, 1]),
        # Dispatch-plan/response cache on/off, the reference's cache_enabled
        # tunable (parameter_manager.cc CacheEnabledParameter). Default-on
        # first so enabling autotune never starts with caching disabled;
        # consumer: ops/dispatch_cache (reads the knob per call; flipping
        # the override flushes plans via the envs epoch).
        Tunable(envs.CACHE_CAPACITY, [envs.DEFAULT_CACHE_CAPACITY, 0]),
    ]


class _BayesianSearch:
    """GP + expected-improvement proposals over the active tunables'
    index space (reference ``BayesianOptimization`` driven by
    ``ParameterManager::TuneParameters``). Proposals are continuous
    index vectors rounded to the nearest grid point, so the decision
    payload stays the same index-state the coordinate strategy and the
    KV sync already speak."""

    def __init__(self, active, seed: int = 0):
        import itertools

        from .optim.bayes import BayesianOptimization
        self._bo = BayesianOptimization(
            [(0.0, float(len(t.candidates) - 1)) for t in active],
            alpha=envs.get_float(envs.AUTOTUNE_GAUSSIAN_PROCESS_NOISE,
                                 DEFAULT_GP_NOISE),
            seed=seed)
        # EI is maximized over the exact knob grid: continuous proposals
        # rounded to a coarse grid collapse onto the incumbent and never
        # explore. Grids too large to enumerate are sampled per proposal
        # instead (see _candidates) — a lexicographic prefix would
        # silently bar every high-index value of the leading knobs.
        self._sizes = [len(t.candidates) for t in active]
        total = math.prod(self._sizes)
        if total <= 4096:
            self._grid = np.array(
                list(itertools.product(*[range(s) for s in self._sizes])),
                float)
        else:
            self._grid = None
            self._rng = np.random.default_rng(seed)
        self._ei_low = 0

    def _candidates(self, incumbent) -> np.ndarray:
        """EI candidate set for one proposal. Small grids are enumerated
        exactly; larger ones get a FRESH uniform draw each call (a frozen
        init-time sample would confine every proposal to its points)
        mixed with the incumbent's coordinate
        neighborhood so local refinement stays reachable."""
        if self._grid is not None:
            return self._grid
        fresh = np.column_stack(
            [self._rng.integers(0, s, size=3584) for s in self._sizes]
        ).astype(float)
        # one-coordinate perturbations of the best state seen so far
        base = np.asarray(incumbent, float)
        neigh = []
        for d, s in enumerate(self._sizes):
            for v in (base[d] - 1, base[d] + 1):
                if 0 <= v < s:
                    p = base.copy()
                    p[d] = v
                    neigh.append(p)
        rows = [fresh, np.atleast_2d(base)]
        if neigh:
            rows.append(np.vstack(neigh))
        return np.vstack(rows)

    def propose(self, mgr: "ParameterManager", score: float) -> dict:
        """Observe ``score`` for the CURRENT state, propose the next."""
        active_idx = [mgr.tunables.index(t) for t in mgr._active]
        self._bo.add_sample([float(mgr._state()[i]) for i in active_idx],
                            score)
        incumbent = [float(mgr._best_state[i]) for i in active_idx]
        x_next, ei = self._bo.next_sample(
            candidates=self._candidates(incumbent))
        if math.isfinite(ei) and len(self._bo._y) >= 5:
            self._ei_low = self._ei_low + 1 if ei < _EI_TOL else 0
            if self._ei_low >= _EI_PATIENCE:
                return {"state": mgr._best_state, "converged": True}
        next_state = list(mgr._best_state)
        for pos, t, v in zip(active_idx, mgr._active, x_next):
            next_state[pos] = int(np.clip(round(v),
                                          0, len(t.candidates) - 1))
        return {"state": next_state, "converged": False}


class ParameterManager:
    """Samples bytes/sec and searches the knob grid (coordinate descent
    or the GP/EI loop, per ``HVD_AUTOTUNE_STRATEGY``)."""

    def __init__(self, tunables: list[Tunable] | None = None, *,
                 warmup_samples: int | None = None,
                 steps_per_sample: int | None = None,
                 max_samples: int | None = None,
                 log_path: str | None = None,
                 sync=None):
        self.tunables = tunables if tunables is not None else _default_tunables()
        self.warmup_samples = (warmup_samples if warmup_samples is not None
                               else envs.get_int(envs.AUTOTUNE_WARMUP_SAMPLES,
                                                 DEFAULT_WARMUP_SAMPLES))
        self.steps_per_sample = (steps_per_sample if steps_per_sample is not None
                                 else envs.get_int(envs.AUTOTUNE_STEPS_PER_SAMPLE,
                                                   DEFAULT_STEPS_PER_SAMPLE))
        self.max_samples = (max_samples if max_samples is not None
                            else envs.get_int(envs.AUTOTUNE_BAYES_OPT_MAX_SAMPLES,
                                              DEFAULT_MAX_SAMPLES))
        self.log_path = (log_path if log_path is not None
                         else envs.get(envs.AUTOTUNE_LOG))
        self._sync = sync  # rank-0 decision broadcast; see _synced_decision
        self._mu = threading.Lock()
        self._bytes = 0
        self._steps = 0
        self._sample_start = time.monotonic()
        self._sample_idx = 0
        self._active = [t for t in self.tunables if not t.fixed
                        and len(t.candidates) > 1]
        self._coord = 0          # which tunable is being swept
        self._cand = 0           # candidate index under trial
        self._best_score = None
        self._best_state = [t.index for t in self.tunables]
        self._pass_improved = False
        self.converged = not self._active
        self.strategy = (envs.get(envs.AUTOTUNE_STRATEGY, "coordinate")
                         or "coordinate").lower()
        if self.strategy not in ("coordinate", "bayesian"):
            hvd_logging.warning(
                "unknown HVD_AUTOTUNE_STRATEGY %r; valid values are "
                "'coordinate' and 'bayesian' — falling back to coordinate",
                self.strategy)
            self.strategy = "coordinate"
        self._bayes = (_BayesianSearch(self._active)
                       if self.strategy == "bayesian" and self._active
                       else None)
        self._log_writer = None
        if self.log_path:
            f = open(self.log_path, "w", newline="")
            self._log_writer = csv.writer(f)
            self._log_writer.writerow(
                ["sample", "score_bytes_per_sec", "warmup", "converged"]
                + [t.knob for t in self.tunables])
            self._log_file = f
        for t in self.tunables:
            t.apply()

    # -- recording ---------------------------------------------------------

    def record(self, nbytes: int) -> None:
        """Account one eager collective's wire payload; sample boundaries
        land every ``steps_per_sample`` records. Cheap: one lock, two adds."""
        if self.converged:
            return
        with self._mu:
            self._bytes += int(nbytes)
            self._steps += 1
            if self._steps < self.steps_per_sample:
                return
            elapsed = time.monotonic() - self._sample_start
            score = self._bytes / max(elapsed, 1e-9)
            self._bytes = 0
            self._steps = 0
            self._end_sample(score)
            self._sample_start = time.monotonic()

    # -- search ------------------------------------------------------------

    def _state(self) -> list[int]:
        return [t.index for t in self.tunables]

    def _apply_state(self, state: list[int]) -> None:
        for t, i in zip(self.tunables, state):
            t.index = i
            t.apply()

    def _end_sample(self, score: float) -> None:
        warmup = self._sample_idx < self.warmup_samples
        self._log(score, warmup)
        self._sample_idx += 1
        if warmup:
            return
        decision = self._synced_decision(score)
        self._apply_state(decision["state"])
        if decision["converged"]:
            self._finish(decision["state"])

    def _local_decision(self, score: float) -> dict:
        """Advance the search by one scored sample."""
        if self._best_score is None or score > self._best_score:
            self._best_score = score
            self._best_state = self._state()
            self._pass_improved = True
        if self._sample_idx - self.warmup_samples >= self.max_samples:
            return {"state": self._best_state, "converged": True}
        if self._bayes is not None:
            return self._bayes.propose(self, score)
        # move to the next candidate of the current coordinate, or the next
        # coordinate (restarting from the best state found so far)
        tun = self._active[self._coord]
        self._cand += 1
        if self._cand >= len(tun.candidates):
            self._cand = 0
            self._coord += 1
            if self._coord >= len(self._active):
                # full pass done
                if not self._pass_improved:
                    return {"state": self._best_state, "converged": True}
                self._pass_improved = False
                self._coord = 0
        next_state = list(self._best_state)
        active_tun = self._active[self._coord]
        pos = self.tunables.index(active_tun)
        next_state[pos] = self._cand
        return {"state": next_state, "converged": False}

    def _synced_decision(self, score: float) -> dict:
        """Single process: decide locally. Multi-process: rank 0 averages
        everyone's score for the sample and broadcasts the decision
        (``Controller::SynchronizeParameters`` analog)."""
        if self._sync is None:
            return self._local_decision(score)
        return self._sync(self._sample_idx, score, self._local_decision)

    def _finish(self, state: list[int]) -> None:
        self.converged = True
        self._apply_state(state)
        hvd_logging.info(
            "autotune converged after %d samples: %s (score %.3g B/s)",
            self._sample_idx,
            {t.knob: t.value for t in self.tunables}, self._best_score or 0)
        self._log(self._best_score or 0.0, False)
        if self._log_writer:
            self._log_file.close()
            self._log_writer = None

    def _log(self, score: float, warmup: bool) -> None:
        if not self._log_writer:
            return
        self._log_writer.writerow(
            [self._sample_idx, f"{score:.1f}", int(warmup), int(self.converged)]
            + [t.value for t in self.tunables])
        self._log_file.flush()

    def current_config(self) -> dict:
        return {t.knob: t.value for t in self.tunables}


class KVScoreSync:
    """Rank-0 decide + broadcast over the launcher KV store."""

    def __init__(self, kv, world_size: int, rank: int,
                 prefix: str = "autotune", timeout: float = 600.0):
        self.kv = kv
        self.world_size = world_size
        self.rank = rank
        self.prefix = prefix
        self.timeout = timeout

    def __call__(self, sample_idx: int, score: float, local_decision) -> dict:
        self.kv.put(f"{self.prefix}/score/{sample_idx}/{self.rank}",
                    repr(float(score)).encode())
        if self.rank == 0:
            gather = getattr(self.kv, "gather", None)
            if gather is not None:  # one server-side round (KVClient)
                got = gather(f"{self.prefix}/score/{sample_idx}",
                             self.world_size, timeout=self.timeout)
                total = sum(float(v.decode()) for v in got.values())
            else:  # plain mapping-style stores (tests)
                total = 0.0
                for r in range(self.world_size):
                    data = self.kv.wait(
                        f"{self.prefix}/score/{sample_idx}/{r}",
                        timeout=self.timeout)
                    total += float(data.decode())
            decision = local_decision(total / self.world_size)
            self.kv.put(f"{self.prefix}/decision/{sample_idx}",
                        json.dumps(decision).encode())
        else:
            data = self.kv.wait(f"{self.prefix}/decision/{sample_idx}",
                                timeout=self.timeout)
            decision = json.loads(data.decode())
        # everyone has read sample_idx's keys before anyone writes
        # sample_idx+2 (a rank must finish its own idx+1 reads first), so
        # deleting the previous sample's keys bounds KV memory
        if sample_idx > 0:
            try:
                self.kv.delete(
                    f"{self.prefix}/score/{sample_idx - 1}/{self.rank}")
                if self.rank == 0:
                    self.kv.delete(f"{self.prefix}/decision/{sample_idx - 1}")
            except Exception:  # hvdlint: disable=silent-except
                pass  # best-effort memory bound; stale keys are harmless
        return decision


# ---------------------------------------------------------------------------
# process-wide manager (mirrors engine_service's lazy singleton)
# ---------------------------------------------------------------------------

_manager: ParameterManager | None = None
_manager_lock = threading.Lock()
_checked = False


def get_manager() -> ParameterManager | None:
    """The process's autotuner, or None when HVD_AUTOTUNE is off."""
    global _manager, _checked
    if _manager is not None or _checked:
        return _manager
    with _manager_lock:
        if _manager is not None or _checked:
            return _manager
        _checked = True
        if not envs.get_bool(envs.AUTOTUNE):
            return None
        sync = None
        from . import runtime
        if runtime.is_initialized() and runtime.size() > 1:
            kv_addr = envs.get(envs.KV_ADDR)
            if not kv_addr:
                # Without a decision channel each process would explore the
                # grid independently — and a per-process flip of
                # HIERARCHICAL_ALLREDUCE changes the SPMD program, which
                # deadlocks the job. Refuse rather than risk it (the
                # reference likewise tunes through the controller,
                # SynchronizeParameters).
                hvd_logging.warning(
                    "HVD_AUTOTUNE requested but this multi-process job has "
                    "no launcher KV store to synchronize decisions; "
                    "autotuning disabled (set HVD_KV_ADDR, HVD_KV_PORT and "
                    "HVD_SECRET_KEY to a runner.http_kv.KVServer to "
                    "enable)")
                return None
            from .runner.http_kv import KVClient
            kv = KVClient(kv_addr, envs.get_int(envs.KV_PORT, 0),
                          secret=envs.get(envs.SECRET_KEY))
            sync = KVScoreSync(kv, runtime.size(), runtime.rank())
        _manager = ParameterManager(sync=sync)
        hvd_logging.info("autotune enabled: %s", _manager.current_config())
    return _manager


def record(nbytes: int) -> None:
    """Hot-path hook called by the eager collectives."""
    mgr = get_manager() if envs.get_bool(envs.AUTOTUNE) else None
    if mgr is not None:
        mgr.record(nbytes)


def reset() -> None:
    """Tear down (tests / elastic re-init)."""
    global _manager, _checked
    with _manager_lock:
        if _manager is not None:
            for t in _manager.tunables:
                envs.clear_override(t.knob)
            if _manager._log_writer:
                _manager._log_file.close()
        _manager = None
        _checked = False
