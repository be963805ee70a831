"""Streaming scheduler service — the batch sweep as a continuous pipeline.

A port of ``repro.stream.service``.  Stages:

  arrivals        ``ScenarioRequest``s from a trace (or prepared
                  ``FitnessFn``s from a client like ``serve.engine``)
  analysis        bounded host thread pool (``AnalysisPool``) producing
                  Job Analysis Tables concurrently with device compute
  admission       ready scenarios are grouped by *compatibility key*
                  (same (G, A) tables, objective, kernel flag, budget —
                  everything a row batch is specialized on), padded to a
                  power-of-two bucket, and dispatched through the SAME
                  row function ``run_sweep`` uses
                  (``repro_torch.core.sweep.row_executable``): one
                  makespan-kernel launch per generation and batch.
                  SLO-aware (default): queues dispatch in (priority
                  class, slack) order, a held partial flushes early when
                  an urgent member's slack runs out, and anytime mode
                  splits deadline-carrying scenarios into a fast interim
                  row plus a silent memo-bound refinement
  device          up to ``max_inflight`` batches issued but not yet
                  routed.  The host issues a batch's whole generation
                  loop before the dispatch call returns (the loop is
                  Python), so a batch's ``dispatch_s`` is stamped before
                  its first launch and a CUDA event recorded after its
                  last one marks its end; the next batch's issue overlaps
                  only what the card still has queued
  router          results come off the device in dispatch order (wait on
                  the batch's event, then one read-back) and are routed
                  back to their requests with full timing stamps;
                  ``compute_metrics`` turns them into service metrics

Bit-identity guarantee
----------------------
A streamed scenario's schedule is **bitwise** a standalone
``run_strategy`` / ``run_sweep`` row with the same (scenario, seed,
budget) on the same device: each row draws from its own generator seeded
with ``request.seed`` and runs the same per-row search the sweep runs,
and rows are independent (padding repeats the last real row; its results
are sliced off).  Batching, bucket padding and arrival order therefore
change only *when* a schedule is computed, never *what* it is.

The pool builds every ``FitnessFn`` on the host; a batch's tables are
stacked there and copied to the service's ``device`` in one go.  Rows
run on one card: sharding them over several is ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, wait
from typing import (Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core.encoding import Population, to_host
from repro_torch.core.fitness import FitnessFn, FitnessParams, ObjectiveSpec
from repro_torch.core.magma import MagmaConfig, SearchResult
from repro_torch.core.pareto import ParetoFront, pareto_front
from repro_torch.core.strategies import (SearchStrategy, WarmStart,
                                         plan_generations)
from repro_torch.core.sweep import (_pad_rows, _resolve_strategy,
                                    row_executable)
from repro_torch.lint.runtime import transfer_sanitizer
from repro_torch.memo.engine import row_view
from repro_torch.obs import (FlightRecorder, NULL_SPAN, NULL_TRACER,
                             ObsConfig, RunClock, Tracer, as_obs_config)
from repro_torch.obs import capture as _flight_capture
from repro_torch.stream.admission import AdmissionQueues
from repro_torch.stream.analysis import AnalysisPool, ReadyScenario
from repro_torch.stream.metrics import StreamMetrics, compute_metrics
from repro_torch.stream.workloads import (ScenarioRequest, TraceConfig,
                                          generate_trace)


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Pipeline shape knobs.

    batch_rows        admission cap: at most this many scenarios per
                      device dispatch (batches are padded up to a
                      power-of-two bucket <= batch_rows, so only
                      O(log batch_rows) batch shapes exist per
                      compatibility key)
    analysis_workers  host threads running the Job Analyzer
    max_inflight      device batches issued but not yet routed; 2 =
                      double buffering (the next batch's copies and
                      issue overlap what the card still has queued of
                      the current one)
    max_devices       cards to shard each batch over (None: one).  More
                      than one raises at the service's construction:
                      sharding is ROADMAP Queue 1 item 12
    realtime          replay trace arrival times on the wall clock; False
                      (default) replays as-fast-as-possible — arrival is
                      the submission instant, the open-loop throughput
                      benchmark mode
    max_hold_s        liveness bound on partial-batch holding: a partial
                      batch normally waits for in-flight analyses to fill
                      it, but under sustained load of *other*
                      compatibility keys those analyses never will — once
                      the oldest held scenario has waited this long it
                      dispatches bucket-padded regardless
    slo_aware         order admission by (priority class, slack) instead
                      of deepest-queue-first, and flush a held partial
                      early when an urgent member's slack runs out (the
                      *hold* is preempted, never in-flight device work).
                      With no priorities/deadlines on the trace the
                      ordering degenerates to deepest-first, so the
                      default changes nothing for SLO-free workloads;
                      False is the priority-blind baseline
    slo_margin_s      an urgent member whose slack (arrival + deadline -
                      now) has shrunk to this margin flushes its held
                      partial immediately
    anytime_budget    anytime mode (needs a memo and slo_aware): a
                      deadline-carrying scenario missing the memo
                      dispatches TWICE — a short-budget interim row at
                      this budget, routed to the caller fast, and a
                      silent full-budget refinement that lands in the
                      memo (idempotent record), so the next arrival of
                      the same scenario replays the refined schedule for
                      free.  Both rows are ordinary rows: the interim is
                      bitwise a standalone search at the anytime budget,
                      the refinement one at the full budget.  None
                      disables the split
    transfer_guard    run each batch's dispatch region — the
                      non-blocking copies of its tables to the card and
                      the issue of its generation loop — under
                      ``repro_torch.lint.runtime.transfer_sanitizer``
                      (``torch.cuda.set_sync_debug_mode("error")``): a
                      host<->device synchronisation sneaking onto the hot
                      path raises instead of silently stalling the issue.
                      Host-side batch assembly (stacking, pinning) comes
                      before the guarded region and the route's wait and
                      read-back after it.  Off by default (sanitizer, not
                      behavior)
    obs               observability (``repro_torch.obs.ObsConfig``, a
                      plain dict of its fields, or None = disabled).
                      Enabled, the service traces one span tree per
                      scenario (admit/analyze/queue_wait/dispatch/device/
                      route + memo spans), runs a flight recorder, and
                      feeds the process metrics registry.  All host-side:
                      schedules stay bitwise the same
    """
    batch_rows: int = 8
    analysis_workers: int = 2
    max_inflight: int = 2
    max_devices: Optional[int] = None
    realtime: bool = False
    max_hold_s: float = 0.25
    slo_aware: bool = True
    slo_margin_s: float = 0.05
    anytime_budget: Optional[int] = None
    transfer_guard: bool = False
    obs: Union[ObsConfig, Dict, None] = None

    def __post_init__(self):
        for field in ("batch_rows", "analysis_workers", "max_inflight"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, got "
                                 f"{getattr(self, field)}")
        if self.max_devices is not None and self.max_devices < 1:
            raise ValueError(f"max_devices must be >= 1 or None, got "
                             f"{self.max_devices}")
        if self.max_hold_s < 0:
            raise ValueError(f"max_hold_s must be >= 0, got "
                             f"{self.max_hold_s}")
        if self.slo_margin_s < 0:
            raise ValueError(f"slo_margin_s must be >= 0, got "
                             f"{self.slo_margin_s}")
        if self.anytime_budget is not None:
            if self.anytime_budget < 1:
                raise ValueError(f"anytime_budget must be >= 1 or None, "
                                 f"got {self.anytime_budget}")
            if not self.slo_aware:
                raise ValueError("anytime_budget needs slo_aware=True: "
                                 "the interim/refinement split is part of "
                                 "deadline-aware admission")
        as_obs_config(self.obs)      # validate shape/values early


class CompatKey(NamedTuple):
    """Everything a row batch is specialized on — only scenarios
    agreeing on all of it may share a device batch.  A NamedTuple, so it
    also unpacks positionally (``base, G, A, use_kernel, objective,
    budget, is_warm = compat_key``).  ``objective`` is the fit's
    canonical ``ObjectiveSpec`` (a bare-name fit and a 1-tuple-spec fit
    group into the same batch)."""
    strategy: SearchStrategy
    group_size: int
    num_accels: int
    use_kernel: bool
    objective: Optional[ObjectiveSpec]
    budget: int
    warm: bool


@dataclasses.dataclass(frozen=True)
class PreparedScenario:
    """A client-supplied, already-analyzed scenario (e.g. serve.engine's
    submesh tables): skips the analysis stage, enters admission
    directly."""
    fit: FitnessFn
    seed: int
    uid: int = 0
    budget: Optional[int] = None     # None: the service's default
    strategy: Union[SearchStrategy, str, None] = None  # None: the service's
    priority: str = "normal"         # SLO class (workloads.PRIORITY_CLASSES)
    deadline_s: Optional[float] = None   # SLO latency budget from admission


@dataclasses.dataclass
class StreamResult:
    """One routed schedule + the request's trip through the pipeline
    (timestamps are offsets from the run's start)."""
    request: ScenarioRequest
    best_fitness: float
    best_accel: np.ndarray
    best_prio: np.ndarray
    history_best: np.ndarray
    n_samples: int
    arrival_s: float
    analysis_start_s: float
    ready_s: float
    dispatch_s: float
    done_s: float
    # schedule-memo provenance: an exact hit was replayed from the store
    # (no device dispatch — dispatch_s == done_s == the admission
    # instant); a warm-seeded row searched from a transferred population
    # (on an exact hit the flag says how the STORED row was solved)
    memo_exact: bool = False
    warm_seeded: bool = False
    # the sampling budget this schedule was actually computed at — the
    # request's budget, except for an anytime interim (the short anytime
    # budget) or an exact hit of a refined record (the refined budget)
    budget: int = 0
    anytime_interim: bool = False
    # the converged population (multi-objective rows and memoized
    # strategies emit one) — ``repro_torch.core.pareto.pareto_front``
    # turns it into the request's ParetoFront
    final_population: Optional[Population] = None

    @property
    def latency_s(self) -> float:
        """Schedule latency: arrival -> schedule routed back."""
        return self.done_s - self.arrival_s

    @property
    def deadline_met(self) -> Optional[bool]:
        """Whether the schedule was routed within its SLO deadline
        (None when the request carries no deadline)."""
        deadline = getattr(self.request, "deadline_s", None)
        if deadline is None:
            return None
        return self.latency_s <= deadline

    def to_search_result(self) -> SearchResult:
        """The row as the ``SearchResult`` a standalone search returns."""
        T = len(self.history_best)
        per_gen = self.n_samples // max(T, 1)
        return SearchResult(
            best_fitness=self.best_fitness,
            best_accel=self.best_accel, best_prio=self.best_prio,
            history_samples=per_gen * np.arange(1, T + 1),
            history_best=np.asarray(self.history_best, dtype=np.float64),
            n_samples=self.n_samples,
            wall_time_s=self.done_s - self.dispatch_s,
        )


@dataclasses.dataclass
class _BatchRecord:
    """Router-side record of one device dispatch (feeds the metrics).
    ``issued_s`` is when the host finished issuing the batch's launches:
    ``issued_s - dispatch_s`` is the host's issue time, ``done_s -
    dispatch_s`` the batch's dispatch-to-done window."""
    dispatch_s: float
    done_s: float
    rows: int
    padded_rows: int
    num_devices: int
    compat_key: Tuple
    issued_s: float = 0.0


@dataclasses.dataclass
class _Inflight:
    out: tuple                      # device tensors, possibly still computing
    members: List[ReadyScenario]
    dispatch_s: float
    padded_rows: int
    num_devices: int
    compat_key: Tuple
    issued_s: float = 0.0
    done: Optional[torch.cuda.Event] = None   # recorded after the last
                                              # launch (None on the CPU)


def _stack_fields(rows: Sequence[tuple], device: torch.device
                  ) -> Tuple[torch.Tensor, ...]:
    """Stack each field of ``rows`` (tuples of tensors) along a new
    leading axis: on ``device`` when every row already lives there (a
    prepared fit on the card), else on the host."""
    out = []
    for i in range(len(rows[0])):
        xs = [r[i] for r in rows]
        if not all(x.device == device for x in xs):
            xs = [x.cpu() for x in xs]
        out.append(torch.stack(xs))
    return tuple(out)


class StreamingScheduler:
    """The streaming multi-tenant scheduling service.

    One instance holds the analysis pool (and its shared profile caches)
    and runs every batch on ``device`` ("cuda" unless the caller asks for
    the CPU), so a long-lived service warms its batch shapes once and
    then keeps the card fed.

        svc = StreamingScheduler(budget=2_000)
        results = svc.run(generate_trace(TraceConfig(num_scenarios=32)))
        print(svc.last_metrics.summary())
    """

    def __init__(self,
                 strategy: Union[SearchStrategy, str, None] = None,
                 cfg: Optional[MagmaConfig] = None,
                 budget: int = 2_000,
                 stream: Optional[StreamConfig] = None,
                 memo=None,
                 device: Union[str, torch.device] = "cuda"):
        self.stream = stream or StreamConfig()
        self.budget = int(budget)
        self.device = torch.device(device)
        if self.stream.max_devices is not None and \
                self.stream.max_devices > 1:
            raise NotImplementedError(
                f"sharding stream batches over {self.stream.max_devices} "
                "cards is ROADMAP Queue 1 item 12; use max_devices=None "
                "or 1")
        # the schedule memo (repro_torch.memo.ScheduleMemo) consulted at
        # admission: exact hits are answered from the store and NEVER
        # enter the dispatch queue; misses are warm-seeded from the
        # nearest stored scenario when the family has one.  Every routed
        # row is recorded back (with its converged population), so a
        # long-lived service computes most schedules once.  The memo sees
        # every row on the service's device (its route), whatever device
        # the row's tables were built on.
        self.memo = memo
        if self.stream.anytime_budget is not None and memo is None:
            raise ValueError(
                "anytime mode needs a memo: the background refinement's "
                "whole purpose is landing in the store for the next "
                "arrival — without one its result would be discarded")
        self._strategy = _resolve_strategy(strategy, cfg)
        if not self._strategy.device_resident:
            raise ValueError(
                f"strategy {self._strategy.name!r} is host-only; the "
                "streaming service batches scenarios onto the device "
                "and cannot run host-loop searches")
        # run-relative clock shared by result timestamps AND the span
        # tracer, so a trace file lines up with StreamResult fields
        self.clock = RunClock()
        self.obs = as_obs_config(self.stream.obs)
        if self.obs.enabled:
            self.tracer = Tracer(capacity=self.obs.trace_capacity,
                                 clock=self.clock, worker=self.obs.worker)
            self.flight: Optional[FlightRecorder] = FlightRecorder(
                max_events=self.obs.flight_events,
                dump_dir=self.obs.flight_dir,
                worker=self.obs.worker, clock=self.clock)
            if self.memo is not None:
                self.memo.tracer = self.tracer
        else:
            self.tracer = NULL_TRACER
            self.flight = None
        self.pool = AnalysisPool(self.stream.analysis_workers,
                                 clock=self._clock, tracer=self.tracer)
        self.last_metrics: Optional[StreamMetrics] = None
        self.last_batches: List[_BatchRecord] = []   # @locked:_run_lock
        self._refined = 0            # @locked:_run_lock  silent refinements
        # generations summed over every batch this service dispatched,
        # warmups included: on a card, its makespan kernel launches
        self.dispatched_generations = 0   # @locked:_run_lock
        # the last run's AdmissionQueues (counters: enqueued/dispatched/
        # stolen/depth/peak/early_flushes)  @locked:_run_lock
        self.last_admission: Optional[AdmissionQueues] = None

        # one run at a time: the clock zero, batch records, and metrics
        # are per-run state, so concurrent clients (several engines
        # sharing one service) serialize here rather than corrupt them
        self._run_lock = threading.Lock()

    # -- clock ----------------------------------------------------------------
    def _clock(self) -> float:
        return self.clock()

    def _begin_run(self) -> None:
        """Reset per-run state: the clock zero, batch records, and (when
        observability is on) the span buffer.  @holds:_run_lock"""
        self.clock.reset()
        self.last_batches = []
        self._refined = 0
        if self.obs.enabled and self.obs.clear_per_run:
            self.tracer.clear()

    # -- admission helpers ----------------------------------------------------
    def _resolve_override(self, strategy) -> SearchStrategy:
        if strategy is None:
            return self._strategy
        strategy = _resolve_strategy(strategy, None)
        if not strategy.device_resident:
            raise ValueError(
                f"strategy {strategy.name!r} is host-only and cannot be "
                "streamed; run it per problem via run_strategy")
        return strategy

    def _compat_key(self, ready: ReadyScenario) -> CompatKey:
        """The scenario's :class:`CompatKey`.  Warm-seeded rows take an
        extra WarmStart input, so the warm flag is a compatibility axis
        too."""
        fit = ready.fit
        budget = ready.request.budget or self.budget
        return CompatKey(
            strategy=self._resolve_override(ready.strategy),
            group_size=fit.group_size, num_accels=fit.num_accels,
            use_kernel=fit.use_kernel, objective=fit.objective_spec,
            budget=budget, warm=ready.warm is not None)

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.stream.batch_rows)

    def _memo_fit(self, fit: FitnessFn):
        """``fit`` as the memo sees a row solved by this service: its
        tables on the service's device, the route the row runs."""
        return row_view(fit.params, num_accels=fit.num_accels,
                        objective=fit.objective_spec, device=self.device)

    # -- SLO ordering ---------------------------------------------------------
    # the ordering policy (class rank / slack / early flush / member
    # take-order) lives in repro_torch.stream.admission.AdmissionQueues
    def _admission(self) -> AdmissionQueues:
        s = self.stream
        return AdmissionQueues(batch_rows=s.batch_rows,
                               slo_aware=s.slo_aware,
                               max_hold_s=s.max_hold_s,
                               slo_margin_s=s.slo_margin_s)

    def _keep_population(self, strategy: SearchStrategy) -> bool:
        """Whether dispatches emit converged populations: memo attached
        and the strategy hands populations off, OR the strategy is
        multi-objective — its archive population IS the deliverable (the
        ParetoFront is extracted from it)."""
        return ((self.memo is not None and strategy.supports_init_population)
                or getattr(strategy, "multi_objective", False))

    def _dispatch(self, compat_key: CompatKey, members: List[ReadyScenario]
                  ) -> _Inflight:
        """Assemble one batch and issue its generation loop on the
        service's device.  @holds:_run_lock"""
        base, G, A, use_kernel, objective, budget, is_warm = compat_key
        warm_seeded = bool(is_warm)     # compat-key flag, not key material
        t_dispatch = self.tracer.now() if self.tracer.enabled else 0.0
        strategy = base.bind(A)
        generations, evolve_last = plan_generations(budget,
                                                    strategy.ask_size)
        self.dispatched_generations += generations
        padded = self._bucket(len(members))   # one card: no shards
        ndev = 1
        dev = self.device
        cuda = dev.type == "cuda"

        # host batch assembly: stack the members' tables (and warm
        # starts), pad to the bucket by repeating the last row, and pin
        # what is on the host so the copies below run asynchronously
        seeds = np.asarray([m.request.seed for m in members], dtype=np.int64)
        params = FitnessParams(*_stack_fields(
            [tuple(m.fit.params) for m in members], dev))
        warm = None
        if warm_seeded:
            warm = WarmStart(
                accel=torch.stack([torch.as_tensor(
                    np.asarray(m.warm.accel), dtype=torch.int32)
                    for m in members]),
                prio=torch.stack([torch.as_tensor(
                    np.asarray(m.warm.prio), dtype=torch.float32)
                    for m in members]),
                jitter=torch.as_tensor(
                    np.asarray([m.warm.jitter for m in members],
                               dtype=np.float32)))
        params, seeds, warm = _pad_rows(params, seeds, padded, warm)
        host = tuple(params) + (() if warm is None else tuple(warm))
        if cuda:
            host = tuple(x if x.device == dev else x.pin_memory()
                         for x in host)
        fn, _ = row_executable(
            strategy, generations, evolve_last, G, objective, ndev, dev,
            keep_population=self._keep_population(base))

        # dispatch_s is stamped before the first launch: the host issues
        # the whole generation loop before fn returns, so a stamp after
        # it would leave only the tail where the card lags the host
        dispatch_s = self._clock()
        done = None
        with transfer_sanitizer(self.stream.transfer_guard and cuda):
            xs = tuple(x.to(dev, non_blocking=True) for x in host)
            n_params = len(params)
            out = fn(seeds, FitnessParams(*xs[:n_params]),
                     WarmStart(*xs[n_params:]) if warm_seeded else None)
            if cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
        inf = _Inflight(out=out, members=members, dispatch_s=dispatch_s,
                        padded_rows=padded, num_devices=ndev,
                        compat_key=compat_key, issued_s=self._clock(),
                        done=done)
        if self.tracer.enabled:
            # host-side stamps only — the device span is emitted at route
            # time, when its end is known
            for m in members:
                uid = m.request.uid
                self.tracer.emit("queue_wait",
                                 m.admitted_s or m.ready_s, t_dispatch,
                                 scope=uid)
                self.tracer.emit("dispatch", t_dispatch, inf.issued_s,
                                 scope=uid, rows=len(members),
                                 bucket=padded, devices=ndev,
                                 warm=warm_seeded)
            if self.flight is not None:
                self.flight.note("dispatch", rows=len(members),
                                 bucket=padded, devices=ndev,
                                 uids=[m.request.uid for m in members])
        return inf

    @staticmethod
    def _wait(inf: _Inflight) -> None:
        """Block until the batch's last launch has finished on the card
        (the counterpart of ``jax.block_until_ready``; on the CPU the
        batch finished inside its dispatch)."""
        if inf.done is not None:
            inf.done.synchronize()

    def _route_finished(self, inflight: deque,
                        results: List[StreamResult]) -> bool:
        """Route every head batch whose end event reports done, in order;
        ``Event.query()`` does not synchronise.  On the CPU (no event) a
        batch finished inside its dispatch and nothing is routed here, so
        the loop keeps the reference's order.  Returns whether any batch
        was routed.  @holds:_run_lock"""
        routed = False
        while inflight and inflight[0].done is not None \
                and inflight[0].done.query():
            self._route(inflight.popleft(), results)
            routed = True
        return routed

    def _prepared_ready(self, p: PreparedScenario) -> ReadyScenario:
        """A client-supplied scenario as an admission-queue entry (the
        synthetic request carries the placeholder provenance fields)."""
        now = self._clock()
        req = ScenarioRequest(
            uid=p.uid, arrival_s=now, mix="<prepared>",
            setting="<prepared>", bw_gb=p.fit.bw_sys / 1024 ** 3,
            group_size=p.fit.group_size, seed=p.seed,
            objective=p.fit.objective_spec.token, budget=p.budget,
            priority=p.priority, deadline_s=p.deadline_s)
        return ReadyScenario(request=req, fit=p.fit, analysis_start_s=now,
                             ready_s=now,
                             strategy=self._resolve_override(p.strategy))

    def _route(self, inf: _Inflight, results: List[StreamResult]) -> None:
        """Wait for a batch, read it back in one copy and route rows.
        The wait and the read-back synchronise with the card, so they run
        outside the transfer guard.  @holds:_run_lock"""
        self._wait(inf)
        done = self._clock()
        outs = to_host(*inf.out)
        bf, ba, bp, hist = outs[:4]
        pops = outs[4:6] if len(outs) >= 6 else None
        base, _, A, _, _, budget, is_warm = inf.compat_key
        strategy = base.bind(A)
        generations, _ = plan_generations(budget, strategy.ask_size)
        n_samples = strategy.ask_size * generations
        for i, m in enumerate(inf.members):
            if m.silent:
                # anytime background refinement: recorded below, never
                # routed — the caller already has (or will get) the
                # interim schedule
                self._refined += 1
            else:
                res = StreamResult(
                    request=m.request,
                    best_fitness=float(bf[i]),
                    best_accel=ba[i], best_prio=bp[i], history_best=hist[i],
                    n_samples=n_samples,
                    arrival_s=m.request.arrival_s,
                    analysis_start_s=m.analysis_start_s,
                    ready_s=m.ready_s,
                    dispatch_s=inf.dispatch_s,
                    done_s=done,
                    warm_seeded=is_warm,
                    budget=budget,
                    anytime_interim=m.anytime,
                    final_population=(Population(accel=pops[0][i],
                                                 prio=pops[1][i])
                                      if pops is not None else None),
                )
                results.append(res)
                if self.flight is not None \
                        and res.deadline_met is False \
                        and self.obs.dump_on_deadline_miss:
                    self.flight.on_deadline_miss(
                        m.request.uid, res.latency_s,
                        m.request.deadline_s)
            if self.memo is not None:
                self.memo.record(
                    self._memo_fit(m.fit), strategy, budget,
                    m.request.seed,
                    {"best_fitness": bf[i], "best_accel": ba[i],
                     "best_prio": bp[i], "history_best": hist[i]},
                    population=((pops[0][i], pops[1][i])
                                if pops is not None else None),
                    family=m.request.mix, warm=m.warm,
                    scope=m.request.uid)
        self.last_batches.append(_BatchRecord(
            dispatch_s=inf.dispatch_s, done_s=done, rows=len(inf.members),
            padded_rows=inf.padded_rows, num_devices=inf.num_devices,
            compat_key=inf.compat_key, issued_s=inf.issued_s))
        if self.tracer.enabled:
            t_routed = self.tracer.now()
            for m in inf.members:
                uid = m.request.uid
                self.tracer.emit("device", inf.dispatch_s, done,
                                 scope=uid, rows=len(inf.members),
                                 devices=inf.num_devices)
                self.tracer.emit("route", done, t_routed, scope=uid,
                                 silent=m.silent)
            if self.flight is not None:
                self.flight.note("route", rows=len(inf.members),
                                 device_s=done - inf.dispatch_s)

    # -- the pipeline ---------------------------------------------------------
    def run(self,
            requests: Sequence[ScenarioRequest] = (),
            prepared: Sequence[PreparedScenario] = ()
            ) -> List[StreamResult]:
        """Drive the full pipeline over a trace (plus any prepared
        scenarios) and return results ordered by request uid.  Metrics for
        the run land in ``self.last_metrics``.  One run executes at a
        time (per-run clock/metrics state); concurrent callers serialize.
        """
        with self._run_lock:
            with _flight_capture(self.flight, "stream.run"):
                return self._run(requests, prepared)

    def _admit(self, ready: ReadyScenario, queues: AdmissionQueues,
               results: List[StreamResult], sp) -> None:
        """Admission of one analyzed scenario: memo consult, anytime
        split, queue push.  ``sp`` is the open ``admit`` span (outcome
        args land on it; the no-op handle when tracing is off).
        @holds:_run_lock"""
        uid = ready.request.uid
        budget = ready.request.budget or self.budget
        if self.memo is not None:
            strategy = self._resolve_override(ready.strategy)
            hit = self.memo.lookup(self._memo_fit(ready.fit), strategy,
                                   budget, ready.request.seed, scope=uid)
            if hit is not None:
                # exact hit: the stored schedule IS the answer,
                # bit-for-bit — no device dispatch, the request never
                # enters a queue (dispatch_s == done_s == now)
                now = self._clock()
                results.append(StreamResult(
                    request=ready.request,
                    best_fitness=float(hit.best_fitness),
                    best_accel=np.asarray(hit.best_accel),
                    best_prio=np.asarray(hit.best_prio),
                    history_best=np.asarray(hit.history_best),
                    n_samples=hit.n_samples,
                    arrival_s=ready.request.arrival_s,
                    analysis_start_s=ready.analysis_start_s,
                    ready_s=ready.ready_s,
                    dispatch_s=now, done_s=now,
                    memo_exact=True,
                    # provenance, not a second hit: the counters
                    # treat exact and warm as disjoint (exact wins)
                    warm_seeded=hit.warm_seeded,
                    budget=budget,
                    final_population=(
                        None if hit.population is None else
                        Population(accel=hit.population[0],
                                   prio=hit.population[1])),
                ))
                sp.set(outcome="memo_exact")
                return
            # miss: seed from the nearest stored scenario of the
            # same transfer family, when one exists (the memo's
            # donor-distance guard refuses far donors — cold init)
            ready.warm = self.memo.warm_start(
                self._memo_fit(ready.fit), strategy,
                family=ready.request.mix, scope=uid)
        anytime = self.stream.anytime_budget
        if anytime is not None and anytime < budget \
                and ready.request.deadline_s is not None:
            # anytime split: the caller gets a short-budget interim
            # schedule fast; a silent full-budget twin refines in
            # the background and lands in the memo, upgrading the
            # NEXT arrival of this scenario to an exact replay of
            # the refined schedule
            interim = dataclasses.replace(
                ready,
                request=dataclasses.replace(ready.request,
                                            budget=anytime),
                anytime=True)
            if self.tracer.enabled:
                interim.admitted_s = self._clock()
            queues.push(self._compat_key(interim), interim)
            ready.silent = True
        if self.tracer.enabled:
            ready.admitted_s = self._clock()
        queues.push(self._compat_key(ready), ready)
        sp.set(outcome="queued", warm=ready.warm is not None,
               split=ready.silent)

    def _run(self, requests, prepared) -> List[StreamResult]:
        """The pipeline body (entered by ``run()``).  @holds:_run_lock"""
        self._begin_run()
        realtime = self.stream.realtime

        to_submit = deque(sorted(requests, key=lambda r: (r.arrival_s, r.uid)))
        queues = self._admission()
        self.last_admission = queues      # counters readable post-run
        inflight: deque = deque()
        futs = set()
        results: List[StreamResult] = []

        def admit(ready: ReadyScenario):
            if self.tracer.enabled:
                with self.tracer.span("admit", scope=ready.request.uid) as sp:
                    self._admit(ready, queues, results, sp)
            else:
                self._admit(ready, queues, results, NULL_SPAN)

        for p in prepared:
            admit(self._prepared_ready(p))

        while to_submit or futs or queues or inflight:
            progressed = False

            # 1. feed due arrivals into the analysis pool
            while to_submit and (not realtime
                                 or to_submit[0].arrival_s <= self._clock()):
                req = to_submit.popleft()
                if not realtime:
                    # as-fast-as-possible replay: arrival == submission
                    req = dataclasses.replace(req, arrival_s=self._clock())
                futs.add(self.pool.submit(req))
                progressed = True

            # 2. drain finished analyses into the admission queues
            if futs:
                done, futs = wait(futs, timeout=0)
                for f in done:
                    admit(f.result())
                    progressed = bool(done) or progressed

            # 3. admission: FULL batches whenever a queue has them; while
            # any analysis is in flight, partials are HELD — analyses
            # complete in milliseconds and fill the batch, whereas a
            # small row-batch wastes a generation loop's host issue on
            # few rows.  With nothing being analyzed (stream draining, or
            # sparse realtime arrivals), partials go out bucket-padded
            # rather than letting the device idle — and a partial that
            # _must_flush (oldest member waited max_hold_s, or an urgent
            # member's slack ran out) dispatches regardless, so a rare
            # compatibility key cannot starve behind a sustained stream
            # of other keys.  SLO-aware: queues go out in (class rank,
            # slack, -depth) order — batch work never delays an urgent
            # schedule; blind (slo_aware=False): deepest queue first so
            # batches fill out.  (Policy + accounting live in
            # AdmissionQueues.)  Before each dispatch, the head batches
            # the card has already finished are routed: a dispatch
            # returns only once the host has issued the whole generation
            # loop, so a finished head left in flight would wait one more
            # batch's issue for its rows.
            progressed = self._route_finished(inflight, results) or progressed
            while len(inflight) < self.stream.max_inflight:
                key = queues.select(self._clock(), bool(futs))
                if key is None:
                    break          # hold the partials: more is coming
                self._route_finished(inflight, results)
                inflight.append(self._dispatch(key, queues.take(key)))
                progressed = True

            # 4. route: block on the head batch when the pipeline is full
            if inflight and len(inflight) >= self.stream.max_inflight:
                self._route(inflight.popleft(), results)
                progressed = True

            if not progressed:
                if inflight:
                    # nothing else to do until the head batch finishes
                    # (held partials dispatch right after it routes)
                    self._route(inflight.popleft(), results)
                elif futs:         # analyses still running: wait for one
                    wait(futs, timeout=0.01, return_when=FIRST_COMPLETED)
                elif realtime and to_submit:
                    time.sleep(min(0.01, max(
                        0.0, to_submit[0].arrival_s - self._clock())))

        wall = self._clock()
        results.sort(key=lambda r: r.request.uid)
        queues.check()               # enqueued == dispatched+stolen+depth
        self.last_metrics = compute_metrics(results, self.last_batches, wall,
                                            refinements=self._refined,
                                            admission=queues)
        return results

    def run_trace(self, trace: TraceConfig) -> List[StreamResult]:
        """Generate ``trace`` and run it through the pipeline."""
        return self.run(generate_trace(trace))

    def warmup(self, requests: Sequence[ScenarioRequest] = (),
               prepared: Sequence[PreparedScenario] = ()
               ) -> "StreamingScheduler":
        """Run every (compatibility key, bucket) batch shape the given
        workload can hit once and discard the results (and pre-fill the
        analyzer profile caches).

        Nothing is compiled per shape here, but the first batch of a
        process still pays one-time costs: the makespan kernel's library
        (built by ``nvcc`` at first use and loaded), the allocator's
        blocks for each shape, the cached constants on the device.
        Greedy admission makes batch sizes timing-dependent, so warming
        every bucket keeps those costs out of the timed run.
        """
        from repro_torch.costmodel import get_setting
        with self._run_lock:
            # one representative per batch-relevant signature (derivable
            # without analysis), so warming a big trace costs a few
            # analyses.  Anytime mode adds the short-budget interim
            # signature for every deadline-carrying request
            reps: Dict[Tuple, ScenarioRequest] = {}
            anytime = self.stream.anytime_budget
            for req in requests:
                variants = [req]
                if anytime is not None and req.deadline_s is not None \
                        and anytime < (req.budget or self.budget):
                    variants.append(
                        dataclasses.replace(req, budget=anytime))
                for rq in variants:
                    sig = (rq.group_size,
                           get_setting(rq.setting).num_sub_accels,
                           rq.objective, rq.budget or self.budget)
                    reps.setdefault(sig, rq)
            seen: Dict[Tuple, ReadyScenario] = {}

            def note(r: ReadyScenario):
                seen.setdefault(self._compat_key(r), r)
                strategy = self._resolve_override(r.strategy)
                if self.memo is not None and \
                        strategy.bind(r.fit.num_accels).\
                        supports_init_population:
                    # memo near-hits dispatch with a warm input: warm that
                    # shape too (zero-jitter dummy seed; warmup results
                    # are discarded)
                    bound = strategy.bind(r.fit.num_accels)
                    G = r.fit.group_size
                    w = WarmStart(
                        accel=np.zeros((bound.ask_size, G), np.int32),
                        prio=np.full((bound.ask_size, G), 0.5, np.float32),
                        jitter=np.float32(0.0))
                    rw = dataclasses.replace(r, warm=w)
                    seen.setdefault(self._compat_key(rw), rw)

            for req in reps.values():
                note(self.pool.analyze(req))
            for p in prepared:
                note(self._prepared_ready(p))
            for key, ready in seen.items():
                bucket = 1
                while True:
                    members = [ready] * min(bucket, self.stream.batch_rows)
                    self._wait(self._dispatch(key, members))
                    if bucket >= self.stream.batch_rows:
                        break
                    bucket *= 2
            self.pool.prestart()         # worker threads spawn lazily
            self.last_batches = []       # warmup dispatches are not metrics
            return self

    def run_serial(self, requests: Sequence[ScenarioRequest],
                   shared_cache: bool = False) -> List[StreamResult]:
        """The pre-stream workflow as a baseline: analyze EVERY scenario
        first (host, one at a time), then sweep the batches (device), with
        no overlap anywhere.  ``shared_cache=False`` (default) gives each
        scenario a fresh ``JobAnalyzer`` (no cross-scenario profile
        reuse); ``shared_cache=True`` grants the baseline the stream's
        shared digest cache, isolating the *pipelining* contribution from
        the *cache* contribution.  Same admission grouping, same row
        function, bitwise the same results either way.  Metrics land in
        ``self.last_metrics``."""
        with self._run_lock:
            with _flight_capture(self.flight, "stream.run_serial"):
                return self._run_serial(requests, shared_cache)

    def _run_serial(self, requests, shared_cache) -> List[StreamResult]:
        """Serial baseline body (``run_serial()``).  @holds:_run_lock"""
        self._begin_run()          # serial baseline: no anytime splits
        results: List[StreamResult] = []

        # every request is on hand when the batch starts (the same
        # as-fast-as-possible convention the pipelined run uses), so all
        # arrivals stamp at t~0 — a scenario analyzed late has been
        # *waiting*, and its schedule latency must say so
        now = self._clock()
        ready: List[ReadyScenario] = [
            self.pool.analyze(dataclasses.replace(req, arrival_s=now),
                              fresh_analyzer=not shared_cache)
            for req in sorted(requests, key=lambda r: (r.arrival_s, r.uid))]

        queues: Dict[Tuple, deque] = {}
        for r in ready:
            queues.setdefault(self._compat_key(r), deque()).append(r)
        for key, q in queues.items():
            while q:
                members = [q.popleft()
                           for _ in range(min(len(q),
                                              self.stream.batch_rows))]
                # dispatch-then-route immediately: the device never has a
                # second batch issued behind the current one
                self._route(self._dispatch(key, members), results)

        wall = self._clock()
        results.sort(key=lambda r: r.request.uid)
        self.last_metrics = compute_metrics(results, self.last_batches, wall,
                                            refinements=self._refined)
        return results

    def schedule_prepared(self, fit: FitnessFn, seed: int = 0,
                          budget: Optional[int] = None,
                          strategy: Union[SearchStrategy, str, None] = None,
                          priority: str = "normal",
                          deadline_s: Optional[float] = None
                          ) -> StreamResult:
        """Schedule ONE prepared scenario through the stream (the
        ``serve.engine`` client path).  Without a memo, bitwise a
        standalone ``run_strategy`` with the same seed, budget and
        (device-resident) strategy on the service's device.  With a
        memo, a re-seen scenario replays the service's previous answer
        and a first-seen one may be warm-seeded from a stored population
        — only cold-solved (never-warm-seeded) scenarios keep the
        standalone bit-identity (see
        ``repro_torch.memo.ScheduleMemo.lookup``).  ``priority`` /
        ``deadline_s`` are the caller's SLO (serve.engine passes its
        tenants' strictest); under anytime mode a deadline-carrying
        first-seen scenario returns the interim schedule while the
        full-budget refinement lands in the memo."""
        return self.run(prepared=[PreparedScenario(
            fit=fit, seed=seed, budget=budget, strategy=strategy,
            priority=priority, deadline_s=deadline_s)])[0]

    def schedule_front(self, fit: FitnessFn, seed: int = 0,
                       budget: Optional[int] = None,
                       strategy: Union[SearchStrategy, str, None] = "nsga2",
                       priority: str = "normal",
                       deadline_s: Optional[float] = None) -> ParetoFront:
        """Schedule one prepared multi-column scenario and return its
        Pareto frontier — the streamed twin of ``M3E.search_front``.
        ``fit`` carries the vector ``ObjectiveSpec``; the strategy must
        be ``multi_objective`` (default nsga2).  The front is extracted
        host-side from the routed archive population by re-evaluating it
        through ``fit.objectives`` — every front point bitwise a
        standalone evaluation — and memo replays of a re-seen frontier
        request rebuild the identical front from the stored population.
        """
        strat = self._resolve_override(strategy)
        if not getattr(strat, "multi_objective", False):
            raise ValueError(
                f"strategy {strat.name!r} is single-objective; "
                "schedule_front needs a multi_objective strategy "
                "such as 'nsga2'")
        res = self.schedule_prepared(fit, seed=seed, budget=budget,
                                     strategy=strategy, priority=priority,
                                     deadline_s=deadline_s)
        if res.final_population is None:
            raise RuntimeError(
                "schedule_front got a result without a population "
                "(a memo record stored without one?)")
        return pareto_front(fit, res.final_population,
                            n_samples=res.n_samples,
                            wall_time_s=res.done_s - res.dispatch_s)

    def export_trace(self, path: str) -> str:
        """Write the current span buffer as a Chrome trace-event file
        (Perfetto-loadable; ``python -m repro_torch.obs <path>``
        summarizes it).  Meaningful only with ``StreamConfig.obs``
        enabled — a disabled tracer exports an empty trace."""
        from repro_torch.obs.export import write_chrome_trace
        return write_chrome_trace(path, self.tracer.spans(),
                                  meta={"service": "repro_torch.stream",
                                        "worker": self.obs.worker})

    def close(self) -> None:
        self.pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
