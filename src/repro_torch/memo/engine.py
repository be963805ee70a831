"""ScheduleMemo — exact-hit replay and warm-start transfer over a MemoStore.

The fastest search is the one you skip (MARS, arXiv:2307.12234): a
service re-sees the same and near-same mapping problems constantly.  The
memo turns every solved row into reusable knowledge:

  exact hit   the full search fingerprint matches
              (:func:`repro_torch.memo.fingerprint.search_fingerprint`):
              the stored schedule IS the answer, bit for bit, and no
              search (no kernel launch) runs.  ``lookup`` returns a
              :class:`MemoHit` whose arrays equal the standalone
              ``run_strategy`` / ``run_sweep`` row byte for byte.
  near hit    same transfer family (``(G, A)`` + strategy + objective +
              route + task family) but different tables: the nearest
              stored scenario (L2 over table features) donates its
              converged population as a
              :class:`~repro_torch.core.strategies.WarmStart`, seeded in
              the strategy's ``init`` from the row's own generator, so a
              warm-seeded search differs from a cold one only in its
              initial population.  Donation is *guarded*: a nearest donor
              whose feature distance exceeds ``max_donor_dist`` is
              refused (cold init instead), because a far donor's
              converged population can trap the search in its own basin
              and make the seeded run WORSE than cold (cross-group Mix
              transfer).

One ``ScheduleMemo`` may back several clients at once (``M3E.search``,
``run_sweep`` recording): the store is locked, and recording the same
fingerprint twice is idempotent.  A port of ``repro.memo.engine``; the
fingerprints carry the route and the generator's seed where the
reference's carry its key (see ``repro_torch.memo.fingerprint``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.encoding import to_host
from repro_torch.core.fitness import (FitnessParams, ObjectiveLike,
                                      as_objective_spec)
from repro_torch.core.strategies import WarmStart, plan_generations
from repro_torch.memo.fingerprint import (family_key, feature_vector,
                                          search_fingerprint,
                                          strategy_signature)
from repro_torch.memo.store import MemoRecord, MemoStore
from repro_torch.obs.profiler import stage
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class MemoHit:
    """An exact-hit replay: the stored row, bit for bit.

    ``warm_seeded`` says how the stored row was solved: ``False`` means
    the replay is bitwise the standalone cold search with this
    fingerprint; ``True`` means it is bitwise what the memoized service
    previously *returned* for this request (a warm-seeded search).
    ``population`` is the converged hand-off when the record carries one.
    """
    fingerprint: str
    best_fitness: float
    best_accel: np.ndarray      # (G,) int32
    best_prio: np.ndarray       # (G,) float32
    history_best: np.ndarray    # (T,) float64
    generations: int
    n_samples: int
    warm_seeded: bool = False
    population: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def to_search_result(self):
        """The replay as the ``SearchResult`` the skipped search would
        have returned (``wall_time_s=0.0``: nothing ran; the population,
        if any, as host arrays)."""
        from repro_torch.core.encoding import Population
        from repro_torch.core.magma import SearchResult
        per_gen = self.n_samples // max(self.generations, 1)
        return SearchResult(
            best_fitness=float(self.best_fitness),
            best_accel=np.asarray(self.best_accel),
            best_prio=np.asarray(self.best_prio),
            history_samples=per_gen * np.arange(1, self.generations + 1),
            history_best=np.asarray(self.history_best, dtype=np.float64),
            n_samples=self.n_samples,
            wall_time_s=0.0,
            final_population=(None if self.population is None else
                              Population(accel=self.population[0],
                                         prio=self.population[1])),
        )


@dataclasses.dataclass
class MemoStats:
    exact_hits: int = 0
    near_hits: int = 0
    misses: int = 0
    records: int = 0
    # exact hits whose stored record was solved by a DIFFERENT origin
    # (another fleet worker's ``ScheduleMemo(origin=...)``): the
    # cross-worker reuse the shared store exists for.  Always a subset
    # of exact_hits; 0 when origins are unset.
    foreign_hits: int = 0

    def summary(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class RowSpec(NamedTuple):
    """One row's tables and the statics its search ran with: the
    ``fit``-like object the memo's methods take (a ``FitnessFn`` is the
    other).  ``device`` is where the row was solved: it picks the
    route."""
    params: FitnessParams
    num_accels: int
    objective: object
    device: torch.device


def row_view(params: FitnessParams, *, num_accels: int,
             objective: ObjectiveLike, device) -> RowSpec:
    """Adapt a single row's ``FitnessParams`` slice and the device its
    search ran on to the ``fit``-like object the memo APIs take.
    ``objective`` may be a bare name, an ``ObjectiveSpec``, or None; the
    fingerprint layer canonicalizes."""
    return RowSpec(params=params, num_accels=int(num_accels),
                   objective=as_objective_spec(objective),
                   device=torch.device(device))


def route(fit) -> bool:
    """The route a search of ``fit`` runs: True (the makespan kernel) on a
    card, False (its plain version) on the CPU."""
    return torch.device(fit.device).type == "cuda"


class ScheduleMemo:
    """Content-addressed schedule memo (exact replay + warm transfer).

        memo = ScheduleMemo(MemoStore("/var/cache/repro-memo",
                                      byte_budget=1 << 30))
        hit = memo.lookup(fit, strategy, budget=2_000, seed=7)
        if hit is None:
            ws = memo.warm_start(fit, strategy, family=group.task)
            res = run_strategy(strategy, fit, budget=2_000, seed=7,
                               init_population=ws, keep_population=True,
                               device=fit.device)
            memo.record(fit, strategy, 2_000, 7, res,
                        population=res.final_population,
                        family=group.task, warm=ws)

    ``fit`` is a ``FitnessFn`` or a :class:`RowSpec`; its ``device``
    picks the route.  ``jitter`` is the warm-start priority noise scale
    (Section V-C: re-randomize the low bits to preserve diversity);
    ``near=False`` disables warm transfer (exact replay only).
    ``max_donor_dist`` is the donor-distance guard (``None`` disables it:
    any stored population donates).
    """

    #: Default donor-distance guard, the reference's calibration on S2
    #: Mix task groups (G=24, feature dim 8A+2): donors at d <= 2.1 left
    #: a short-budget warm search no worse than cold, donors at d >= 3.7
    #: (cross-group transfer) dragged it as low as 0.13x cold.
    MAX_DONOR_DIST = 3.0

    def __init__(self, store: Optional[MemoStore] = None,
                 jitter: float = 0.02, near: bool = True,
                 max_donor_dist: Optional[float] = MAX_DONOR_DIST,
                 origin: Optional[str] = None):
        # NOT `store or MemoStore()`: an empty MemoStore is len()==0 and
        # would be silently replaced by a fresh in-memory one
        self.store = store if store is not None else MemoStore()
        self.jitter = float(jitter)
        self.near = bool(near)
        self.max_donor_dist = (None if max_donor_dist is None
                               else float(max_donor_dist))
        # provenance stamp for shared stores: records carry the origin
        # that solved them, and an exact hit on a record some OTHER origin
        # solved counts as a foreign hit (fleet workers pass their id)
        self.origin = origin
        self.stats = MemoStats()
        self._lock = threading.Lock()
        # span tracer (repro_torch.obs); the default never records
        self.tracer = NULL_TRACER

    # -- key plumbing ---------------------------------------------------------
    @staticmethod
    def _protocol(strategy, budget: int) -> Tuple[int, bool, int]:
        generations, evolve_last = plan_generations(int(budget),
                                                    strategy.ask_size)
        return generations, evolve_last, strategy.ask_size

    @staticmethod
    def _seed(seed: Union[int, np.integer]) -> int:
        """The row's generator seed (the port seeds generators, it has no
        key arrays)."""
        if not isinstance(seed, (int, np.integer)) or isinstance(seed, bool):
            raise TypeError(f"the memo keys a row on its integer seed; got "
                            f"{type(seed).__name__}")
        return int(seed)

    def fingerprint(self, fit, strategy, budget: int, seed: int) -> str:
        """The exact-hit content address of one search row."""
        strategy = strategy.bind(fit.num_accels)
        generations, evolve_last, _ = self._protocol(strategy, budget)
        return search_fingerprint(
            fit.params, self._seed(seed), strategy,
            generations=generations, evolve_last=evolve_last,
            use_kernel=route(fit), objective=fit.objective)

    # -- exact hit ------------------------------------------------------------
    def lookup(self, fit, strategy, budget: int, seed: int,
               scope: Optional[int] = None) -> Optional[MemoHit]:
        """Replay of a previously solved row, or None.

        A hit replays the stored schedule bit for bit.  When the stored
        row was solved *cold* that equals the standalone
        ``run_strategy`` / ``run_sweep`` row for this fingerprint; when it
        was *warm-seeded* it equals what the memoized service returned
        the first time (idempotent replay).  ``scope`` is the request
        the ``memo.lookup`` span belongs to (the stream passes its uid).
        """
        sp = stage("memo.lookup", self.tracer, scope=scope)
        with sp:
            fp = self.fingerprint(fit, strategy, budget, seed)
            rec = self.store.get(fp)
            with self._lock:
                if rec is None:
                    self.stats.misses += 1
                    sp.set(outcome="miss")
                    return None
                self.stats.exact_hits += 1
                origin = rec.meta.get("origin")
                foreign = origin is not None and origin != self.origin
                self.stats.foreign_hits += foreign
            sp.set(outcome="foreign_hit" if foreign else "hit")
            return MemoHit(
                fingerprint=fp,
                best_fitness=float(
                    np.asarray(rec.arrays["best_fitness"]).reshape(-1)[0]),
                best_accel=rec.arrays["best_accel"],
                best_prio=rec.arrays["best_prio"],
                history_best=rec.arrays["history_best"],
                generations=int(rec.meta.get(
                    "generations", len(rec.arrays["history_best"]))),
                n_samples=int(rec.meta.get("n_samples", 0)),
                warm_seeded=bool(rec.meta.get("warm_seeded", False)),
                population=((rec.arrays["pop_accel"],
                             rec.arrays["pop_prio"])
                            if rec.has_population else None),
            )

    # -- near hit -------------------------------------------------------------
    def donor(self, fit, strategy, family: str = ""
              ) -> Tuple[Optional[MemoRecord], float]:
        """The nearest stored record of ``fit``'s transfer family that
        carries a population, and its feature distance (``inf`` for a
        record that never saw tables); ``(None, inf)`` when there is none.
        On ties the newest record wins.  No guard, no statistics."""
        strategy = strategy.bind(fit.num_accels)
        fam = family_key(fit.params, strategy, use_kernel=route(fit),
                         objective=fit.objective, family=family)
        cands = [r for r in self.store.family(fam) if r.has_population]
        if not cands:
            return None, np.inf
        feats = feature_vector(fit.params)
        best, best_d = None, np.inf
        for r in cands:       # insertion order: on ties, newest wins
            rf = r.features
            d = (float(np.linalg.norm(rf - feats))
                 if rf is not None and rf.shape == feats.shape
                 else np.inf)  # population-only record (no tables)
            if best is None or d <= best_d:
                best, best_d = r, d
        return best, best_d

    def warm_start(self, fit, strategy, family: str = "",
                   scope: Optional[int] = None) -> Optional[WarmStart]:
        """Nearest-fingerprint population transfer, or None.

        Only strategies that accept an ``init_population``
        (``supports_init_population``) can be seeded; candidates are the
        family's stored records that carry a converged population, ranked
        by L2 distance between table feature vectors (:meth:`donor`).
        The nearest donor must also pass the ``max_donor_dist`` guard:
        beyond it (or when the candidate never saw tables and has no
        features) transfer is refused and the caller falls back to cold
        init.  The population is resized on the host to the strategy's
        ask size (row tiling); the jitter is drawn in ``init``.
        """
        sp = stage("memo.warm_start", self.tracer, scope=scope)
        with sp:
            strategy = strategy.bind(fit.num_accels)
            if not (self.near and strategy.supports_init_population):
                sp.set(outcome="unsupported")
                return None
            best, best_d = self.donor(fit, strategy, family)
            if best is None:
                sp.set(outcome="no_donor")
                return None
            if self.max_donor_dist is not None and \
                    not best_d <= self.max_donor_dist:
                sp.set(outcome="refused")  # too far to trust: cold init
                return None
            with self._lock:
                self.stats.near_hits += 1
            sp.set(outcome="seeded")
            P = strategy.ask_size
            accel = _resize_rows(best.arrays["pop_accel"],
                                 P).astype(np.int32)
            prio = _resize_rows(best.arrays["pop_prio"],
                                P).astype(np.float32)
            return WarmStart(accel=accel, prio=prio,
                             jitter=np.float32(self.jitter))

    # -- recording ------------------------------------------------------------
    def record(self, fit, strategy, budget: int, seed: int, row,
               population=None, family: str = "", warm=None,
               scope: Optional[int] = None) -> str:
        """Store one solved row (idempotent per fingerprint).

        ``row`` is anything with ``best_fitness`` / ``best_accel`` /
        ``best_prio`` / ``history_best`` (a ``SearchResult`` or a plain
        dict); ``population`` is the converged ``(accel, prio)`` hand-off
        enabling near-hit transfer (None records the schedule only).
        Tensors among them are read back to the host in one transfer.
        ``warm`` is the ``WarmStart`` the row was seeded with, if any:
        the record is flagged ``warm_seeded`` so ``lookup`` can tell
        cold-search bit-identity from service-idempotent replay.
        ``scope`` is the request the ``memo.record`` span belongs to.
        Returns the fingerprint.
        """
        with stage("memo.record", self.tracer, scope=scope,
                   warm_seeded=warm is not None):
            strategy = strategy.bind(fit.num_accels)
            generations, evolve_last, P = self._protocol(strategy, budget)
            fp = self.fingerprint(fit, strategy, budget, seed)
            get = (row.get if isinstance(row, dict)
                   else lambda k: getattr(row, k))
            names = ["best_fitness", "best_accel", "best_prio",
                     "history_best"]
            values = [get(k) for k in names]
            if population is not None:
                names += ["pop_accel", "pop_prio"]
                values += list(population[:2])
            arrays = dict(zip(names, _host_arrays(values)))
            arrays["best_fitness"] = np.asarray(arrays["best_fitness"],
                                                dtype=np.float32)
            arrays["features"] = feature_vector(fit.params)
            fam = family_key(fit.params, strategy, use_kernel=route(fit),
                             objective=fit.objective, family=family)
            self.store.put(MemoRecord(
                fingerprint=fp, family=fam, arrays=arrays,
                meta={"strategy": strategy_signature(strategy),
                      "generations": generations,
                      "evolve_last": evolve_last,
                      "n_samples": generations * P,
                      "budget": int(budget),
                      "family": family,
                      "warm_seeded": warm is not None,
                      "origin": self.origin}))
            with self._lock:
                self.stats.records += 1
            return fp

    def __len__(self) -> int:
        return len(self.store)


def _host_arrays(values):
    """numpy arrays of ``values``; the tensors among them read back in
    one transfer (:func:`~repro_torch.core.encoding.to_host`)."""
    out = [v if isinstance(v, torch.Tensor) else np.asarray(v)
           for v in values]
    idx = [i for i, v in enumerate(out) if isinstance(v, torch.Tensor)]
    if idx:
        for i, host in zip(idx, to_host(*(out[i] for i in idx))):
            out[i] = host
    return out


def _resize_rows(x: np.ndarray, rows: int) -> np.ndarray:
    """Resize a (P_src, G) population to (rows, G) by tiling/truncating
    whole rows — deterministic, shape-static (host-side)."""
    x = np.asarray(x)
    if x.shape[0] == rows:
        return x
    reps = -(-rows // x.shape[0])
    return np.tile(x, (reps, 1))[:rows]
