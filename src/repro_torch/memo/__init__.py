"""repro_torch.memo — persistent schedule memo: compute most schedules once.

Content-addressed reuse of solved mapping problems, in two tiers:

  exact hit   the scenario + strategy + protocol + seed + route
              fingerprint matches a stored row: the schedule is replayed
              bit for bit with no search and no kernel launch
              (``ScheduleMemo.lookup``);
  near hit    same transfer family (``(G, A)`` shape, strategy,
              objective, route, task family) with different tables: the
              nearest stored scenario donates its converged population
              as a ``WarmStart`` seed consumed by
              ``SearchStrategy.init`` (``ScheduleMemo.warm_start``) —
              the paper's Section V-C warm start generalized to
              nearest-fingerprint lookup.

Backed by :class:`MemoStore` — an append-only, multi-process-safe
on-disk store (npz payloads + JSONL index, LRU byte-budget eviction,
compaction; the reference's layout, so either package reads the other's
directories) or pure in-memory when no path is given.  Clients:
``repro_torch.core.sweep.run_sweep(memo=...)`` records every solved row,
and ``M3E(memo=...)`` routes single searches and ``search_front``
through it.
"""
from repro_torch.memo.fingerprint import (family_key, feature_vector,
                                          scenario_digest,
                                          search_fingerprint,
                                          strategy_signature)
from repro_torch.memo.store import (MemoLayoutError, MemoRecord, MemoStore,
                                    read_layout)
from repro_torch.memo.engine import (MemoHit, MemoStats, RowSpec,
                                     ScheduleMemo, row_view)

__all__ = [
    "family_key", "feature_vector", "scenario_digest",
    "search_fingerprint", "strategy_signature",
    "MemoLayoutError", "MemoRecord", "MemoStore", "read_layout",
    "MemoHit", "MemoStats", "RowSpec", "ScheduleMemo", "row_view",
]
