"""Fleet router — compat-keyed partitioning + work-stealing front door.

The router is the fleet's single admission point.  It partitions an
arrival trace across per-worker
:class:`~repro_torch.stream.admission.AdmissionQueues` by *compatibility
signature* — the statics a row batch is specialized on that are
derivable WITHOUT analysis:
``(group_size, num_sub_accels, objective, budget)``.  Scenarios sharing
a signature land on the same worker, so that worker's own admission
stage can batch them onto one executable; a signature's home worker is
chosen greedily (least-loaded at first sight) and sticky afterwards.

Work-stealing: a skewed trace loads workers unevenly (that is the
benchmark's whole point), so when a worker goes idle — queues empty,
nothing outstanding on its pipe — the router moves work to it from the
deepest victim.  What moves is WHOLE HELD PARTIALS (entire per-key
queues, via ``AdmissionQueues.steal``): never device-in-flight work,
never a fraction of a partial (compat grouping survives the move), and
least-urgent queues first, so the SLO ordering invariants hold on
both sides of the theft.  Bit-identity is untouched by construction —
a schedule depends only on (scenario, seed), not on which worker's
pipeline ran it.

Single-threaded: the router runs in the caller's thread; worker reader
threads only enqueue parsed messages onto the fleet inbox.  The
per-worker queues are therefore router-private state (no lock), and
each worker's counters satisfy the AdmissionQueues invariant
``enqueued == dispatched + stolen + depth`` at every step
(checked after every run).

A port of ``repro.fleet.router`` (pure Python over the port's
``stream.admission`` queues): on the same scripted inputs its partitions,
steals and counters are the reference's.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fleet.metrics import compute_fleet_metrics
from repro_torch.fleet.worker import (decode_array, encode_prepared,
                                      encode_request)
from repro_torch.obs import NULL_TRACER, as_obs_config, get_tracer
from repro_torch.stream.admission import AdmissionQueues


@dataclasses.dataclass
class _Held:
    """One routed scenario held in a front queue (the AdmissionQueues
    member duck type: .request / .ready_s / .silent)."""
    request: object               # ScenarioRequest (or the prepared shim)
    ready_s: float
    payload: Dict                 # wire-encoded, ready to send
    kind: str                     # "request" | "prepared"
    silent: bool = False


@dataclasses.dataclass
class FleetResult:
    """One schedule as served by the fleet (arrays bitwise the port's
    standalone row for the same (scenario, seed) on the same device
    type)."""
    request: object
    worker_id: str
    best_fitness: float
    best_accel: np.ndarray
    best_prio: np.ndarray
    history_best: np.ndarray
    n_samples: int
    budget: int
    memo_exact: bool
    warm_seeded: bool
    anytime_interim: bool
    arrival_s: float              # router clock: admitted to a queue
    done_s: float                 # router clock: schedule received back

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s

    @property
    def deadline_met(self) -> Optional[bool]:
        deadline = getattr(self.request, "deadline_s", None)
        if deadline is None:
            return None
        return self.latency_s <= deadline

    def to_search_result(self):
        """The row as the ``SearchResult`` a standalone search returns
        (the ``StreamResult`` conversion, fleet-served)."""
        from repro_torch.core.magma import SearchResult
        T = len(self.history_best)
        per_gen = self.n_samples // max(T, 1)
        return SearchResult(
            best_fitness=float(self.best_fitness),
            best_accel=np.asarray(self.best_accel),
            best_prio=np.asarray(self.best_prio),
            history_samples=per_gen * np.arange(1, T + 1),
            history_best=np.asarray(self.history_best, dtype=np.float64),
            n_samples=self.n_samples,
            wall_time_s=self.done_s - self.arrival_s,
        )


class WorkerQueue:
    """Router-side state for one worker: its front admission queues +
    what is outstanding on its pipe."""

    def __init__(self, handle, batch_rows: int, slo_aware: bool,
                 max_hold_s: float, slo_margin_s: float):
        self.handle = handle
        self.queues: AdmissionQueues = AdmissionQueues(
            batch_rows=batch_rows, slo_aware=slo_aware,
            max_hold_s=max_hold_s, slo_margin_s=slo_margin_s)
        self.sent = 0                 # members shipped to the worker

    @property
    def worker_id(self) -> str:
        return self.handle.worker_id

    @property
    def load(self) -> int:
        """Assignment load: held + already shipped (a worker with a
        deep pipe is not 'empty' just because its front queues are)."""
        return self.queues.depth + self.handle.outstanding


class FleetRouter:
    """One run's routing state (a fresh router per ``Fleet.run``)."""

    def __init__(self, workers, inbox: "queue.Queue",
                 chunk_rows: int = 16, max_outstanding: int = 2,
                 steal: bool = True, default_budget: int = 2_000,
                 stream: Optional[Dict] = None, obs=None,
                 recv_timeout_s: float = 600.0):
        stream = stream or {}
        self.obs = as_obs_config(obs)
        # the router traces on the process-wide tracer (its clock is
        # process-epoch, not the run-relative service clock — router
        # spans are infra, scoped by uid only where one exists)
        self.tracer = get_tracer() if self.obs.enabled else NULL_TRACER
        self.chunk_rows = int(chunk_rows)
        self.max_outstanding = int(max_outstanding)
        self.steal = bool(steal)
        self.default_budget = int(default_budget)
        self.recv_timeout_s = float(recv_timeout_s)
        self.inbox = inbox
        self.wq: List[WorkerQueue] = [
            WorkerQueue(w,
                        batch_rows=int(stream.get("batch_rows", 8)),
                        slo_aware=bool(stream.get("slo_aware", True)),
                        max_hold_s=float(stream.get("max_hold_s", 0.25)),
                        slo_margin_s=float(stream.get("slo_margin_s",
                                                      0.05)))
            for w in workers]
        self._home: Dict[Tuple, int] = {}      # compat signature -> worker
        self._chunk_id = 0
        self._chunk_members: Dict[Tuple[str, int], List[_Held]] = {}
        self.steals = 0
        self.stolen_members = 0
        self.last_metrics = None
        self._t0 = time.perf_counter()

    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    # -- partitioning ---------------------------------------------------------
    def _signature(self, req) -> Tuple:
        """The pre-analysis compatibility signature: every axis of the
        worker-side CompatKey derivable from the request alone."""
        from repro_torch.costmodel import get_setting
        return ("trace", req.group_size,
                get_setting(req.setting).num_sub_accels,
                req.objective, req.budget or self.default_budget)

    def _prepared_signature(self, enc: Dict) -> Tuple:
        G = enc["params"]["lat"]["shape"][-2]
        objective = (None if enc["objective"] is None
                     else tuple(enc["objective"]))
        return ("prepared", G, enc["num_accels"], objective,
                enc["budget"] or self.default_budget)

    def _assign(self, sig: Tuple) -> WorkerQueue:
        """Sticky greedy placement: a signature keeps its home worker
        (batches keep forming there); a NEW signature goes to the least
        loaded worker right now."""
        i = self._home.get(sig)
        if i is None:
            i = min(range(len(self.wq)), key=lambda j: self.wq[j].load)
            self._home[sig] = i
        return self.wq[i]

    def _admit(self, held: _Held, sig: Tuple) -> None:
        self._assign(sig).queues.push(sig, held)

    # -- chunk assembly / stealing --------------------------------------------
    def _assemble(self, w: WorkerQueue) -> List[_Held]:
        """Pull up to chunk_rows members off a worker's front queues in
        SLO order (most urgent signature first — AdmissionQueues.select
        with nothing pending dispatches immediately)."""
        members: List[_Held] = []
        now = self._clock()
        while len(members) < self.chunk_rows:
            key = w.queues.select(now, analyses_pending=False)
            if key is None:
                break
            members.extend(w.queues.take(key))
        return members

    def _steal_into(self, thief: WorkerQueue) -> None:
        """Refill an idle worker from the deepest victim's held tail."""
        victim = max(self.wq, key=lambda w: w.queues.depth)
        if victim is thief or victim.queues.depth == 0:
            return
        # about half the victim's held work, but never less than one
        # full partial (an idle worker deserves at least one batch),
        # never more than a chunk
        budget = min(self.chunk_rows,
                     max(victim.queues.batch_rows,
                         victim.queues.depth // 2))
        with self.tracer.span("fleet.steal", thief=thief.worker_id,
                              victim=victim.worker_id) as sp:
            moved = victim.queues.steal(budget, self._clock())
            if not moved:
                sp.set(members=0)
                return
            self.steals += 1
            n = 0
            for key, members in moved:
                n += len(members)
                self.stolen_members += len(members)
                self._home[key] = self.wq.index(thief)  # future arrivals too
                for m in members:
                    thief.queues.push(key, m)
            sp.set(members=n)
        victim.queues.check()
        thief.queues.check()

    def _ship(self, w: WorkerQueue, members: List[_Held]) -> None:
        self._chunk_id += 1
        with self.tracer.span("fleet.ship", worker=w.worker_id,
                              chunk=self._chunk_id, members=len(members)):
            msg = {"cmd": "run", "chunk": self._chunk_id,
                   "requests": [m.payload for m in members
                                if m.kind == "request"],
                   "prepared": [m.payload for m in members
                                if m.kind == "prepared"]}
            self._chunk_members[(w.worker_id, self._chunk_id)] = members
            w.handle.send(msg)
        w.handle.outstanding += 1
        w.sent += len(members)

    # -- the routing loop -----------------------------------------------------
    def run(self, requests: Sequence = (), prepared: Sequence = ()
            ) -> List[FleetResult]:
        self._t0 = time.perf_counter()
        now = self._clock()
        # admit everything up front (as-fast-as-possible trace replay,
        # the same convention StreamingScheduler.run uses); arrival is
        # the admission instant on the ROUTER clock
        for req in sorted(requests, key=lambda r: (r.arrival_s, r.uid)):
            self._admit(_Held(request=dataclasses.replace(req,
                                                          arrival_s=now),
                              ready_s=now, payload=encode_request(
                                  dataclasses.replace(req, arrival_s=now)),
                              kind="request"),
                        self._signature(req))
        for p in prepared:
            enc = encode_prepared(p)
            held = _Held(request=_PreparedShim(p, now), ready_s=now,
                         payload=enc, kind="prepared")
            self._admit(held, self._prepared_signature(enc))

        total = sum(w.queues.depth for w in self.wq)
        results: List[FleetResult] = []
        while len(results) < total:
            self._dispatch_round()
            wid, msg = self._recv()
            if msg.get("ok") == "done":
                w = self._by_id(wid)
                w.handle.outstanding -= 1
                members = self._chunk_members.pop((wid, msg["chunk"]))
                results.extend(self._decode(wid, members, msg))
            elif msg.get("ok") in ("error", "eof"):
                raise RuntimeError(f"fleet worker {wid} failed: {msg}")
        wall = self._clock()
        for w in self.wq:
            w.queues.check()
        results.sort(key=lambda r: r.request.uid)
        self.last_metrics = compute_fleet_metrics(
            results, self._worker_stats(), wall,
            steals=self.steals, stolen_members=self.stolen_members,
            router_peak_depth=max((w.queues.peak_depth for w in self.wq),
                                  default=0))
        return results

    def _dispatch_round(self) -> None:
        """Ship chunks to every worker with pipe capacity; steal for
        workers that drained."""
        for w in self.wq:
            if w.handle.outstanding >= self.max_outstanding:
                continue
            if w.queues.depth == 0 and self.steal \
                    and w.handle.outstanding == 0:
                self._steal_into(w)
            while w.handle.outstanding < self.max_outstanding:
                members = self._assemble(w)
                if not members:
                    break
                self._ship(w, members)

    def _recv(self, timeout: Optional[float] = None) -> Tuple[str, Dict]:
        timeout = self.recv_timeout_s if timeout is None else timeout
        try:
            return self.inbox.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                "fleet router: no worker message within "
                f"{timeout:.0f}s (outstanding="
                f"{[(w.worker_id, w.handle.outstanding) for w in self.wq]})")

    def _by_id(self, wid: str) -> WorkerQueue:
        for w in self.wq:
            if w.worker_id == wid:
                return w
        raise KeyError(wid)

    def _decode(self, wid: str, members: List[_Held], msg: Dict
                ) -> List[FleetResult]:
        done = self._clock()
        sp = self.tracer.span("fleet.route", worker=wid,
                              chunk=msg.get("chunk"),
                              members=len(members))
        by_uid = {m.request.uid: m for m in members}
        out = []
        for d in msg["results"]:
            m = by_uid[d["uid"]]
            out.append(FleetResult(
                request=m.request, worker_id=wid,
                best_fitness=d["best_fitness"],
                best_accel=decode_array(d["best_accel"]),
                best_prio=decode_array(d["best_prio"]),
                history_best=decode_array(d["history_best"]),
                n_samples=d["n_samples"], budget=d["budget"],
                memo_exact=d["memo_exact"],
                warm_seeded=d["warm_seeded"],
                anytime_interim=d["anytime_interim"],
                arrival_s=m.request.arrival_s, done_s=done))
        sp.finish()
        return out

    def _worker_stats(self) -> Dict[str, Dict]:
        """Per-worker rollups for THIS run ('stats' round trip,
        non-destructive; worker counters are process-lifetime, so the
        handle keeps a snapshot and the router reports the delta)."""
        for w in self.wq:
            w.handle.send({"cmd": "stats"})
        stats: Dict[str, Dict] = {}
        pending = {w.worker_id for w in self.wq}
        while pending:
            wid, msg = self._recv(timeout=min(60.0, self.recv_timeout_s))
            if msg.get("ok") == "stats":
                stats[wid] = self._delta(self._by_id(wid).handle,
                                         msg.get("stats", {}))
                pending.discard(wid)
            elif msg.get("ok") in ("error", "eof"):
                raise RuntimeError(f"fleet worker {wid} failed: {msg}")
        for w in self.wq:
            stats.setdefault(w.worker_id, {})
            stats[w.worker_id]["router_sent"] = w.sent
            stats[w.worker_id]["router_stolen_from"] = w.queues.stolen
        return stats

    @staticmethod
    def _delta(handle, now: Dict) -> Dict:
        """This run's share of a worker's lifetime counters (peaks stay
        lifetime maxima — a max has no meaningful delta)."""
        prev = getattr(handle, "stats_snapshot", None) or {}
        handle.stats_snapshot = now
        out = dict(now)
        for k in ("chunks", "scenarios", "run_wall_s", "early_flushes",
                  "refinements"):
            out[k] = now.get(k, 0) - prev.get(k, 0)
        pm = prev.get("memo") or {}
        out["memo"] = {k: v - pm.get(k, 0)
                       for k, v in (now.get("memo") or {}).items()}
        return out


class _PreparedShim:
    """Request-like view of a PreparedScenario for routing/scoring."""

    def __init__(self, p, now: float):
        self.uid = p.uid
        self.arrival_s = now
        self.priority = p.priority
        self.deadline_s = p.deadline_s
