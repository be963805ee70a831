"""Admission queues — the stream's held-work structure.

A port of ``repro.stream.admission`` (pure Python: the same pushes at the
same ``now`` values give the same decisions and counters).  The queues
are a class of their own so that a router can own several sets and steal
held partials between them (``repro_torch.fleet.router``): compat-keyed
deques, the SLO-aware selection policy
(queue score / early flush / member take-order), and exact accounting.

Accounting contract
-------------------
Every member pushed is eventually dispatched by THIS queue set, stolen
to another, or still held::

    enqueued == dispatched + stolen + depth        (``check()``)

A held partial that is stolen leaves ``depth`` and enters ``stolen``
only — it is NOT counted dispatched here (the thief's queues count it
when they dispatch it), and a partial flushed early is dispatched
exactly once with ``early_flushes`` incremented as a *reason* tag, not
a second count.  Deriving all four numbers from one structure means a
member that leaves a queue by flush-preemption can never be counted
twice.

Members are duck-typed: anything with ``.request`` (carrying
``priority`` / ``deadline_s`` / ``arrival_s`` / ``uid``), ``.ready_s``
and ``.silent`` queues here — the scheduler's ``ReadyScenario``, or a
router's held-request shim.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Generic, Hashable, List, Optional, Tuple, TypeVar

import numpy as np

K = TypeVar("K", bound=Hashable)
M = TypeVar("M")

#: class rank: urgent < normal < batch < silent refinement (anytime
#: background rows soak only device slack)
PRIO_RANK = {"urgent": 0, "normal": 1, "batch": 2}
SILENT_RANK = 3


def member_rank(m) -> int:
    if getattr(m, "silent", False):
        return SILENT_RANK
    return PRIO_RANK.get(getattr(m.request, "priority", "normal"), 1)


def member_slack(m, now: float) -> float:
    """Seconds until the member's SLO deadline (inf without one)."""
    deadline = getattr(m.request, "deadline_s", None)
    if deadline is None or getattr(m, "silent", False):
        return np.inf
    return m.request.arrival_s + deadline - now


class AdmissionQueues(Generic[K, M]):
    """Compat-keyed held work + the admission policy + the counters.

    One instance per dispatching worker (the scheduler's run loop) or
    per routed partition (the fleet router's per-worker front queues).
    Not internally locked: the scheduler uses it from its single
    pipeline thread, the router under its own lock (@locked there).
    """

    def __init__(self, batch_rows: int = 8, slo_aware: bool = True,
                 max_hold_s: float = 0.25, slo_margin_s: float = 0.05):
        self.batch_rows = int(batch_rows)
        self.slo_aware = bool(slo_aware)
        self.max_hold_s = float(max_hold_s)
        self.slo_margin_s = float(slo_margin_s)
        self._queues: Dict[K, deque] = {}
        # the accounting quadruple (see module docstring)
        self.enqueued = 0
        self.dispatched = 0
        self.stolen = 0
        self.depth = 0
        self.peak_depth = 0
        self.early_flushes = 0
        self._flush_key: Optional[K] = None

    # -- structure ------------------------------------------------------------
    def push(self, key: K, member: M) -> None:
        self._queues.setdefault(key, deque()).append(member)
        self.enqueued += 1
        self.depth += 1
        self.peak_depth = max(self.peak_depth, self.depth)

    def __bool__(self) -> bool:
        return any(self._queues.values())

    def __len__(self) -> int:
        return self.depth

    def keys(self) -> List[K]:
        return [k for k, q in self._queues.items() if q]

    def check(self) -> None:
        """Assert the accounting invariant (cheap; tests call it after
        every run, the router after every steal)."""
        assert self.enqueued == self.dispatched + self.stolen + self.depth, (
            f"admission accounting broken: enqueued={self.enqueued} != "
            f"dispatched={self.dispatched} + stolen={self.stolen} + "
            f"depth={self.depth}")

    # -- policy ---------------------------------------------------------------
    def queue_score(self, q, now: float) -> Tuple[int, float, int]:
        """Admission order among non-empty queues: most urgent class
        first, then least slack, then deepest (numbers only — compat
        keys themselves don't order)."""
        return (min(member_rank(m) for m in q),
                min(member_slack(m, now) for m in q),
                -len(q))

    def must_flush(self, q, now: float) -> bool:
        """Whether a held partial goes out NOW: its oldest member has
        waited past max_hold_s (liveness), or an urgent member's slack
        is down to the margin — the hold is preempted (in-flight device
        work never is)."""
        if now - min(m.ready_s for m in q) > self.max_hold_s:
            return True
        return any(member_rank(m) == 0
                   and member_slack(m, now) <= self.slo_margin_s
                   for m in q)

    def select(self, now: float, analyses_pending: bool) -> Optional[K]:
        """The key to dispatch next, or None to keep holding.

        FULL batches go whenever a queue has them; while work is still
        being analyzed (``analyses_pending``) partials are held to fill
        — except a partial that ``must_flush``.  SLO-aware: queues go in
        (class rank, slack, -depth) order; blind: deepest first.
        """
        ready = [(len(q), k) for k, q in self._queues.items() if q]
        if not ready:
            return None
        self._flush_key = None
        if self.slo_aware:
            # indices sorted on scores so ties never compare the compat
            # keys (strategies/None don't order)
            order = sorted(
                range(len(ready)),
                key=lambda i: self.queue_score(
                    self._queues[ready[i][1]], now))
            for i in order:
                depth, k = ready[i]
                if depth >= self.batch_rows or not analyses_pending:
                    return k
                if self.must_flush(self._queues[k], now):
                    self._flush_key = k
                    return k
            return None
        depth, k = max(ready, key=lambda x: x[0])
        if depth >= self.batch_rows or not analyses_pending:
            return k
        stale = [kk for _, kk in ready
                 if now - min(m.ready_s for m in self._queues[kk])
                 > self.max_hold_s]
        if stale:
            self._flush_key = stale[0]
            return stale[0]
        return None

    def take(self, key: K) -> List[M]:
        """Pull up to batch_rows members of ``key`` for dispatch.
        SLO-aware: the most urgent (class rank, absolute deadline, uid)
        members first; blind: FIFO.  Counts them dispatched."""
        q = self._queues[key]
        k = min(len(q), self.batch_rows)
        if not self.slo_aware:
            take = [q.popleft() for _ in range(k)]
        else:
            def member_key(m):
                deadline = getattr(m.request, "deadline_s", None)
                absolute = (np.inf
                            if deadline is None or getattr(m, "silent", False)
                            else m.request.arrival_s + deadline)
                return (member_rank(m), absolute, m.request.uid)

            take = sorted(q, key=member_key)[:k]
            taken = {id(m) for m in take}
            rest = [m for m in q if id(m) not in taken]
            q.clear()
            q.extend(rest)
        self.dispatched += len(take)
        self.depth -= len(take)
        if key == self._flush_key and take:
            self.early_flushes += 1     # reason tag — not a second count
        self._flush_key = None
        return take

    # -- stealing -------------------------------------------------------------
    def steal(self, max_members: int, now: float
              ) -> List[Tuple[K, List[M]]]:
        """Give up held partials for another queue set, least urgent
        first.

        Only HELD work moves — never anything already taken for
        dispatch.  The unit of theft is a whole *partial*: up to
        ``batch_rows`` same-key members (what would have formed one
        device batch here forms one device batch at the thief, so
        compat grouping survives the move).  Keys are surrendered in
        REVERSE queue-score order (most relaxed first) and, within a
        key, the members the victim would have dispatched LAST go
        first — an urgent near-deadline member is the last thing to pay
        a migration latency, preserving the SLO ordering invariants on
        both sides.  A partial bigger than the remaining allowance is
        not split below batch size; stops before exceeding
        ``max_members``."""
        if max_members <= 0:
            return []
        victims = sorted([k for k, q in self._queues.items() if q],
                         key=lambda k: self.queue_score(self._queues[k], now),
                         reverse=True)
        out: List[Tuple[K, List[M]]] = []
        left = int(max_members)
        for k in victims:
            q = self._queues[k]
            while q:
                part = min(len(q), self.batch_rows)
                if part > left:
                    break
                if self.slo_aware:
                    def member_key(m):
                        deadline = getattr(m.request, "deadline_s", None)
                        absolute = (np.inf if deadline is None
                                    or getattr(m, "silent", False)
                                    else m.request.arrival_s + deadline)
                        return (member_rank(m), absolute, m.request.uid)

                    # least-urgent `part` members leave
                    members = sorted(q, key=member_key)[-part:]
                    taken = {id(m) for m in members}
                    rest = [m for m in q if id(m) not in taken]
                    q.clear()
                    q.extend(rest)
                else:
                    # FIFO victim: the tail (newest) members leave
                    members = [q.pop() for _ in range(part)][::-1]
                self.stolen += len(members)
                self.depth -= len(members)
                left -= len(members)
                out.append((k, members))
            if left <= 0:
                break
        return out
