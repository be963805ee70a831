"""Concurrency harness — hammer the shared-state hot spots, assert exact.

Run: ``python -m repro_torch.lint.race [--ops-per-owner N] [--threads T]``

Two phases, both with *deterministic* expected states so every assertion
is bit-exact (no "roughly consistent" checks that let lost updates hide):

* **MemoStore ownership race.**  T threads plus one real subprocess each
  own a disjoint slice of fingerprints and replay a deterministic
  put/discard script against ONE shared on-disk store, with periodic
  ``refresh()``/``compact()`` thrown in (and auto-compaction firing on
  its own).  Because ids are disjoint and replay is last-wins, the final
  index must agree exactly with each owner's script replayed serially:
  a lost ``put`` line, a lost ``del`` tombstone (the compaction-window
  bug), or a corrupted index all break the equality.  Verified three
  ways: a pure-JSON serial replay of ``index.jsonl``, a fresh
  :class:`~repro_torch.memo.store.MemoStore` load, and payload bytes
  against regenerated arrays.

* **AnalysisPool determinism race.**  The same scenario requests
  analyzed concurrently (shared per-setting ``JobAnalyzer`` caches,
  profile-cache contention) and serially must produce bit-identical
  fitness tables.

A separate single-process eviction phase exercises the LRU byte budget
(evictions append tombstones, so they would violate the ownership
invariant if run concurrently — by design the race phase runs without a
budget).

A port of ``repro.lint.race`` against the port's ``MemoStore`` and
``stream/analysis.py::AnalysisPool``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

PAYLOAD_N = 6          # floats per record: tiny, the index is the story
RECS_PER_OWNER = 8     # live fingerprints each owner cycles through


# ---------------------------------------------------------------------------
# deterministic ownership scripts
# ---------------------------------------------------------------------------
def owner_ops(worker: int, n_ops: int,
              n_recs: int = RECS_PER_OWNER) -> List[Tuple[str, str, int]]:
    """The op script for one owner: ``(op, fingerprint, version)``.

    Pure function of ``(worker, n_ops)`` so the verifier can replay it.
    Every 5th op is a discard; versions strictly increase so last-wins
    replay has a unique right answer per fingerprint.
    """
    ops = []
    for j in range(n_ops):
        r = (j * 7 + worker) % n_recs
        fp = f"w{worker}r{r}"
        if j % 5 == 4:
            ops.append(("del", fp, j))
        else:
            ops.append(("put", fp, j))
    return ops


def payload(worker: int, fp: str, version: int) -> Dict[str, np.ndarray]:
    """Bit-reproducible arrays keyed by (owner, fingerprint, version)."""
    r = int(fp.rsplit("r", 1)[1])
    x = (np.arange(PAYLOAD_N, dtype=np.float32) * (version + 1)
         + worker * 1000 + r * 10)
    return {"x": x}


def expected_state(worker: int, n_ops: int,
                   n_recs: int = RECS_PER_OWNER) -> Dict[str, int]:
    """Serial replay of one owner's script: fingerprint -> final version."""
    state: Dict[str, int] = {}
    for op, fp, ver in owner_ops(worker, n_ops, n_recs):
        if op == "put":
            state[fp] = ver
        else:
            state.pop(fp, None)
    return state


def run_owner(path: str, worker: int, n_ops: int,
              n_recs: int = RECS_PER_OWNER) -> None:
    """Replay one owner's script against the shared store (worker body
    for both the thread owners and the subprocess owner)."""
    from repro_torch.memo.store import MemoRecord, MemoStore
    store = MemoStore(path)
    for j, (op, fp, ver) in enumerate(owner_ops(worker, n_ops, n_recs)):
        if op == "put":
            store.put(MemoRecord(fingerprint=fp, family=(f"fam{worker}",),
                                 arrays=payload(worker, fp, ver),
                                 meta={"v": ver, "w": worker}))
        else:
            store.discard(fp)
        # cross-process visibility + compaction churn, mid-script
        if j % 67 == 66:
            store.refresh()
        if j % 151 == 150:
            store.compact()


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------
def replay_index(path: str) -> Dict[str, Dict]:
    """Pure-JSON last-wins replay of index.jsonl: fp -> final put event.

    Independent of MemoStore's loader, so loader bugs and index bugs
    can't cancel each other out.
    """
    live: Dict[str, Dict] = {}
    with open(os.path.join(path, "index.jsonl")) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            ev = json.loads(raw)     # a torn line here IS a finding
            if ev["op"] == "put":
                live[ev["fp"]] = ev
            elif ev["op"] == "del":
                live.pop(ev["fp"], None)
    return live


def verify_store(path: str, n_owners: int, n_ops: int,
                 n_recs: int = RECS_PER_OWNER) -> List[str]:
    """Every ownership invariant; returns human-readable violations."""
    from repro_torch.memo.store import MemoStore
    errors: List[str] = []
    want: Dict[str, Tuple[int, int]] = {}        # fp -> (worker, version)
    for w in range(n_owners):
        for fp, ver in expected_state(w, n_ops, n_recs).items():
            want[fp] = (w, ver)

    idx = replay_index(path)
    if set(idx) != set(want):
        lost = sorted(set(want) - set(idx))
        ghost = sorted(set(idx) - set(want))
        if lost:
            errors.append(f"index lost puts: {lost}")
        if ghost:
            errors.append(f"index resurrected tombstoned records: {ghost}")
    for fp in set(idx) & set(want):
        w, ver = want[fp]
        got = idx[fp].get("meta", {}).get("v")
        if got != ver:
            errors.append(f"index {fp}: version {got}, want {ver} "
                          "(stale line won the replay)")

    fresh = MemoStore(path)
    with fresh._lock:
        loaded = {fp: rec for fp, rec in fresh._records.items()}
    if set(loaded) != set(idx):
        errors.append("loader/index divergence: "
                      f"{sorted(set(loaded) ^ set(idx))}")
    for fp, rec in loaded.items():
        if fp not in want:
            continue
        w, ver = want[fp]
        ref = payload(w, fp, ver)["x"]
        got = rec.arrays.get("x")
        if got is None or got.dtype != ref.dtype \
                or not np.array_equal(got, ref):
            errors.append(f"payload {fp}: bytes differ from serial replay")
        if rec.meta.get("v") != ver:
            errors.append(f"loaded {fp}: meta version {rec.meta.get('v')}, "
                          f"want {ver}")
    return errors


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def memo_race(path: str, threads: int = 3, ops_per_owner: int = 250,
              use_subprocess: bool = True) -> int:
    """Interleave the owners; raise AssertionError on any violation.
    Returns total ops executed."""
    n_owners = threads + (1 if use_subprocess else 0)
    errs: List[BaseException] = []

    def body(w):
        try:
            run_owner(path, w, ops_per_owner)
        except BaseException as e:       # surfaced below, never swallowed
            errs.append(e)

    ts = [threading.Thread(target=body, args=(w,), name=f"owner-{w}")
          for w in range(threads)]
    proc = None
    if use_subprocess:
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.lint.race", "--owner",
             str(threads), "--dir", path, "--ops-per-owner",
             str(ops_per_owner)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if proc is not None:
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(
                f"subprocess owner failed (rc={proc.returncode}):\n"
                f"{err.decode(errors='replace')}")
    if errs:
        raise errs[0]
    violations = verify_store(path, n_owners, ops_per_owner)
    if violations:
        raise AssertionError("memo race violations:\n  "
                             + "\n  ".join(violations))
    return n_owners * ops_per_owner


def eviction_phase(path: str, budget_records: int = 4) -> None:
    """Single-process LRU budget stress: the survivor set and byte count
    must match the deterministic LRU prediction."""
    from repro_torch.memo.store import MemoRecord, MemoStore
    one = payload(0, "w0r0", 0)["x"].nbytes
    store = MemoStore(path, byte_budget=budget_records * one)
    n = 12
    for ver in range(n):
        fp = f"ev{ver}"
        store.put(MemoRecord(fingerprint=fp, family=("ev",),
                             arrays=payload(0, f"w0r{ver % 8}", ver),
                             meta={"v": ver}))
    assert store.total_bytes <= budget_records * one
    assert sorted(store._records) == sorted(
        f"ev{v}" for v in range(n - budget_records, n)), \
        f"LRU survivors wrong: {sorted(store._records)}"
    fresh = MemoStore(path)
    assert sorted(fresh._records) == sorted(store._records), \
        "eviction tombstones did not persist"


def analysis_race(threads: int = 4, n_jobs: int = 10) -> int:
    """Concurrent AnalysisPool results must be bit-identical to serial."""
    import torch

    from repro_torch.stream.analysis import AnalysisPool, analyze_serial
    from repro_torch.stream.workloads import TraceConfig, generate_trace
    reqs = generate_trace(TraceConfig(
        num_scenarios=n_jobs, group_size=10, settings=("S2", "S3"),
        bw_ladder_gb=(1.0, 16.0), seed=7))
    with AnalysisPool(workers=threads) as pool:
        futs = [pool.submit(r) for r in reqs]
        conc = [f.result() for f in futs]
    serial = analyze_serial(reqs)
    for c, s in zip(conc, serial):
        assert c.request.uid == s.request.uid
        cl, sl = tuple(c.fit.params), tuple(s.fit.params)
        assert len(cl) == len(sl)
        for a, b in zip(cl, sl):
            assert a.dtype == b.dtype and torch.equal(a, b)
    return len(reqs)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint.race",
        description="Concurrency harness: MemoStore ownership race, "
                    "LRU eviction, AnalysisPool determinism.")
    ap.add_argument("--dir", default=None,
                    help="store directory (default: a fresh tempdir)")
    ap.add_argument("--threads", type=int, default=3,
                    help="thread owners (one subprocess owner is added)")
    ap.add_argument("--ops-per-owner", type=int, default=250)
    ap.add_argument("--no-subprocess", action="store_true")
    ap.add_argument("--skip-analysis", action="store_true",
                    help="memo phases only (no torch import)")
    ap.add_argument("--owner", type=int, default=None,
                    help=argparse.SUPPRESS)     # subprocess entry
    args = ap.parse_args(argv)

    if args.owner is not None:                  # child mode
        run_owner(args.dir, args.owner, args.ops_per_owner)
        return 0

    import tempfile
    path = args.dir or tempfile.mkdtemp(prefix="repro-race-")
    total = memo_race(path, threads=args.threads,
                      ops_per_owner=args.ops_per_owner,
                      use_subprocess=not args.no_subprocess)
    owners = ("threads only" if args.no_subprocess
              else "threads + 1 process")
    print(f"memo race: {total} interleaved ops over "
          f"{args.threads + (0 if args.no_subprocess else 1)} owners "
          f"({owners}) — index exact vs serial replay")
    eviction_phase(tempfile.mkdtemp(prefix="repro-race-ev-"))
    print("eviction: LRU survivor set exact, tombstones persisted")
    if not args.skip_analysis:
        n = analysis_race()
        print(f"analysis pool: {n} concurrent analyses bit-equal serial")
    print("repro_torch.lint.race: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
