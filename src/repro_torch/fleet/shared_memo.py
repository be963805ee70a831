"""Sharded shared memo — one fingerprint-prefix-sharded store per fleet.

A fleet of scheduler workers shares a single :class:`~repro_torch.memo.store.
MemoStore` directory on a shared filesystem so every schedule is
computed once *fleet-wide*: worker A records a solved row, worker B's
next ``refresh()`` folds it in and replays it as an exact hit (or
donates its population as a warm start) without ever dispatching a
search.  At fleet record counts the v1 single ``index.jsonl`` becomes
the bottleneck — every writer appends to one file, every compaction
locks out every other process, and every refresh stats the whole thing
— so the v2 layout splits the index 16 ways by fingerprint prefix:

    <path>/memo_layout.json        {"version": 2, "shards": 16}
    <path>/index-<h>.jsonl         h = the fingerprint's first hex char
    <path>/payload/<fp>.npz        unchanged (fingerprint-addressed)

Each shard is an ordinary :class:`MemoStore` with its own index file,
byte cursor, flock discipline, and compaction lock (shard-local locks:
appends to ``index-3.jsonl`` never contend with a compaction of
``index-c.jsonl``), sharing the one payload directory.  SHA-256
fingerprints are uniform over the prefix, so shards stay balanced
without any placement logic.

Migration: opening a directory that still holds a v1 ``index.jsonl``
splits it in place ONCE (under a cross-process lock): every line is
appended to its prefix shard, the marker is written, and the old index
is renamed to ``index.jsonl.v1``.  Records round-trip bit-identically —
the payloads never move, only index lines are re-filed.  A v1
``MemoStore`` opening a migrated directory raises
:class:`~repro_torch.memo.store.MemoLayoutError` naming the layout
version it found, instead of silently seeing an empty store.

A copy of ``repro.fleet.shared_memo`` (standard library and numpy only)
over the port's ``MemoStore``, whose on-disk layout is the reference's:
a v2 directory written by either package opens in the other with equal
records.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.memo.store import (LAYOUT_MARKER, MemoLayoutError,
                                    MemoRecord, MemoStore, read_layout)

NUM_SHARDS = 16       # one hex character of the SHA-256 fingerprint

_MIGRATE_LOCK = "migrate.lock"
_MIGRATE_STALE_S = 300.0     # a migration is seconds; treat a lock this
                             # old as a dead process's leftover


def shard_of(fingerprint: str) -> int:
    """Which shard a fingerprint lives in (its first hex character)."""
    return int(fingerprint[0], 16)


def _shard_index_name(h: int) -> str:
    return f"index-{h:x}.jsonl"


class ShardedMemoStore:
    """The v2 fingerprint-prefix-sharded :class:`MemoStore` drop-in.

    Same API surface the :class:`~repro_torch.memo.engine.ScheduleMemo` uses
    (``put``/``get``/``family``/``discard``/``refresh``/``compact``/
    ``len``/``in``/``total_bytes``), implemented over ``NUM_SHARDS``
    shard stores.  Thread-safety and multi-process safety are inherited
    per shard; cross-shard operations (``family``, ``__len__``) take no
    global lock — they see each shard at *some* consistent point, which
    is the same guarantee concurrent readers of a single store get
    between two appends.

    ``byte_budget`` is split evenly across shards (each shard evicts LRU
    against its slice; uniform fingerprints make the slices fill
    evenly).  ``path=None`` is rejected — an in-memory store has nothing
    to share; use a plain ``MemoStore()``.
    """

    def __init__(self, path: str, byte_budget: Optional[int] = None):
        if not path:
            raise ValueError(
                "ShardedMemoStore needs a directory path: sharing is the "
                "point — use MemoStore() for an in-memory store")
        self.path = os.path.abspath(path)
        self.byte_budget = byte_budget
        os.makedirs(os.path.join(self.path, "payload"), exist_ok=True)
        self._ensure_layout()
        per_shard = (None if byte_budget is None
                     else max(1, -(-int(byte_budget) // NUM_SHARDS)))
        self._shards: List[MemoStore] = [
            MemoStore(self.path, byte_budget=per_shard,
                      index_name=_shard_index_name(h))
            for h in range(NUM_SHARDS)]

    # -- layout / migration ---------------------------------------------------
    def _marker_path(self) -> str:
        return os.path.join(self.path, LAYOUT_MARKER)

    def _v1_index(self) -> str:
        return os.path.join(self.path, "index.jsonl")

    def _write_marker(self) -> None:
        # atomic create-or-overwrite: concurrent openers all write the
        # same bytes, so last-wins is harmless.  Each writes its own
        # temporary file: with one shared name, the opener that renames
        # second finds the name already gone
        fd, tmp = tempfile.mkstemp(dir=self.path, prefix=LAYOUT_MARKER,
                                   suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({"version": 2, "shards": NUM_SHARDS}, f)
        os.replace(tmp, self._marker_path())

    def _ensure_layout(self) -> None:
        """Validate the marker, migrating a v1 index in place if found.

        Exactly-once across processes via an ``O_EXCL`` lock file (the
        compaction-lock discipline): the winner migrates, losers wait for
        the marker to appear.  Crash-safe ordering — shard lines are
        appended first (replayed puts are idempotent last-wins, so a
        re-run after a crash merely rewrites them), the marker second,
        the old index renamed away last; any interrupted step re-runs
        cleanly on the next open.
        """
        layout = read_layout(self.path)
        if layout is not None:
            if layout.get("version") != 2 or \
                    layout.get("shards") != NUM_SHARDS:
                raise MemoLayoutError(
                    f"{self.path} has memo layout {layout}; this build "
                    f"reads v2 with {NUM_SHARDS} shards")
            # marker present but the old index still there: a migrator
            # died between marker write and rename — its lines are
            # already sharded (the marker is written after), finish the
            # rename for it
            if os.path.exists(self._v1_index()):
                self._finish_v1_rename()
            return
        if not os.path.exists(self._v1_index()):
            self._write_marker()     # fresh directory: stamp and go
            return
        self._migrate_v1()

    def _finish_v1_rename(self) -> None:
        try:
            os.replace(self._v1_index(), self._v1_index() + ".v1")
        except FileNotFoundError:
            pass                     # another opener finished it first

    def _migrate_v1(self) -> None:
        lockfile = os.path.join(self.path, _MIGRATE_LOCK)
        while True:
            try:
                fd = os.open(lockfile, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                # another process is migrating: wait for its marker (or
                # reclaim a stale lock the same way compaction does)
                try:
                    if time.time() - os.path.getmtime(lockfile) \
                            > _MIGRATE_STALE_S:
                        os.unlink(lockfile)
                        continue
                except FileNotFoundError:
                    continue
                time.sleep(0.05)
                if read_layout(self.path) is not None:
                    return self._ensure_layout()
        try:
            os.close(fd)
            if read_layout(self.path) is not None:   # lost an earlier race
                return self._ensure_layout()
            # split the v1 index by fingerprint prefix.  Lines are
            # replayed in file order into each shard, so per-fingerprint
            # last-wins ordering (duplicate puts, del tombstones) is
            # preserved exactly — order across DIFFERENT fingerprints
            # never mattered, and same-fingerprint lines share a shard.
            outs: Dict[int, List[str]] = {h: [] for h in range(NUM_SHARDS)}
            with open(self._v1_index(), "rb") as f:
                for raw in f.read().splitlines():
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        ev = json.loads(raw)
                        h = shard_of(ev["fp"])
                    except (json.JSONDecodeError, KeyError, ValueError,
                            IndexError):
                        continue     # torn tail line: payload survives
                    outs[h].append(raw.decode())
            for h, lines in outs.items():
                if not lines:
                    continue
                with open(os.path.join(self.path, _shard_index_name(h)),
                          "a") as f:
                    f.write("\n".join(lines) + "\n")
            self._write_marker()
            self._finish_v1_rename()
        finally:
            try:
                os.unlink(lockfile)
            except FileNotFoundError:
                pass

    # -- sharded delegation ---------------------------------------------------
    def _shard(self, fingerprint: str) -> MemoStore:
        return self._shards[shard_of(fingerprint)]

    def put(self, rec: MemoRecord) -> None:
        self._shard(rec.fingerprint).put(rec)

    def get(self, fingerprint: str) -> Optional[MemoRecord]:
        return self._shard(fingerprint).get(fingerprint)

    def discard(self, fingerprint: str) -> None:
        self._shard(fingerprint).discard(fingerprint)

    def family(self, family: Tuple) -> List[MemoRecord]:
        """A transfer family's live records across every shard.

        Per-shard insertion order, concatenated in shard order — the
        near-hit ranking is distance-based, so cross-shard order only
        breaks exact-distance ties differently than a v1 store would.
        """
        out: List[MemoRecord] = []
        for s in self._shards:
            out.extend(s.family(family))
        return out

    def refresh(self) -> int:
        """Fold in other workers' appends: one stat per shard (the
        per-index byte cursors make unchanged shards free — no open, no
        parse), tail-parse only the shards that grew."""
        return sum(s.refresh() for s in self._shards)

    def compact(self) -> None:
        for s in self._shards:
            s.compact()

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._shard(fingerprint)

    @property
    def total_bytes(self) -> int:
        return sum(s.total_bytes for s in self._shards)
