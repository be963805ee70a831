"""Persistent memo store — append-only npz payload shards + a JSONL index.

Layout (``path`` is a directory; ``path=None`` keeps everything in RAM):

    <path>/index.jsonl          one JSON line per event, append-only:
                                {"op": "put", "fp": ..., "family": [...],
                                 "meta": {...}, "nbytes": N}
                                {"op": "del", "fp": ...}
    <path>/payload/<fp>.npz     the record's arrays (schedule, converged
                                population, feature vector)

Why this shape:

  append-only + atomic   payloads are written to a temp file and
                         ``os.replace``d into place; index lines are
                         single small ``O_APPEND`` writes (atomic on
                         POSIX), so concurrent writer processes never
                         interleave partial records and a reader never
                         sees a half-written payload — at worst an index
                         line whose payload is still in flight, which
                         the loader skips.
  last-wins replay       loading replays the index in order; a duplicate
                         ``put`` (two processes solving the same
                         scenario) or a ``del`` tombstone simply
                         overwrites — no locking needed to read.
  LRU byte budget        ``byte_budget`` caps the payload bytes held;
                         inserts evict least-recently-*used* records
                         (lookups refresh recency), appending ``del``
                         tombstones and unlinking payloads.
  compaction             tombstones and overwritten lines accumulate;
                         ``compact()`` rewrites the index atomically to
                         exactly the live records (auto-triggered when
                         the event count outgrows the live count 4x).
                         Cross-process compaction is excluded by a
                         best-effort lock file; a line another process
                         appends inside the tiny snapshot->replace window
                         can be dropped from the index (its payload file
                         survives), which costs a recomputation, never a
                         wrong replay.

The store knows nothing about schedules — it maps fingerprint -> record
(arrays + metadata) and answers family scans.
``repro_torch.memo.engine`` gives the records meaning.  Pure numpy and
the standard library: the on-disk layout is ``repro.memo.store``'s, so a
directory written by either package opens in the other with equal
records.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

try:
    import fcntl
except ImportError:          # non-POSIX: appends fall back to the
    fcntl = None             # inode-check + compaction-rescue path

_COMPACT_SLACK = 4          # compact when events > live records * this

#: On-disk layout marker (``<path>/memo_layout.json``).  Absent = the v1
#: single-file layout this module owns; ``{"version": 2, ...}`` = the
#: fingerprint-prefix-sharded layout
#: ``repro_torch.fleet.shared_memo`` owns.
LAYOUT_MARKER = "memo_layout.json"


class MemoLayoutError(RuntimeError):
    """The store directory uses a different on-disk layout version than
    the opener understands (e.g. a v1 ``MemoStore`` opening a directory
    the sharded v2 store migrated)."""


def read_layout(path: str) -> Optional[Dict]:
    """The directory's layout marker, or None (v1 / fresh directory)."""
    try:
        with open(os.path.join(path, LAYOUT_MARKER)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


@dataclasses.dataclass
class MemoRecord:
    """One solved row: content address, transfer class, payload arrays.

    ``arrays`` holds the bit-exact schedule (``best_fitness`` as a 0-d
    f32, ``best_accel``/``best_prio``/``history_best``) and, when the
    strategy hands one off, the converged population
    (``pop_accel``/``pop_prio``) plus the ``features`` vector near-hit
    lookup ranks by.  ``meta`` is small JSON-able provenance (strategy
    signature, generations, n_samples, seed/budget when known).
    """
    fingerprint: str
    family: Tuple
    arrays: Dict[str, np.ndarray]
    meta: Dict

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.arrays.values()))

    @property
    def features(self) -> Optional[np.ndarray]:
        return self.arrays.get("features")

    @property
    def has_population(self) -> bool:
        return "pop_accel" in self.arrays and "pop_prio" in self.arrays


class MemoStore:
    """Fingerprint -> :class:`MemoRecord`, optionally disk-backed.

    Thread-safe (one lock around the in-memory state); multi-process
    safe for the append path by construction (atomic payload replace +
    O_APPEND index lines) — concurrent ``compact()`` from two processes
    is excluded by a best-effort lock file.  ``refresh()`` folds in
    records other processes appended since the last load.
    """

    def __init__(self, path: Optional[str] = None,
                 byte_budget: Optional[int] = None,
                 index_name: str = "index.jsonl"):
        self.path = os.path.abspath(path) if path else None
        self.byte_budget = byte_budget
        # which JSONL file this store replays.  The default is the v1
        # single-file layout; the sharded v2 store opens one MemoStore
        # per "index-<h>.jsonl" shard (all sharing the payload dir).
        self.index_name = index_name
        if self.path and index_name == "index.jsonl":
            layout = read_layout(self.path)
            if layout is not None and layout.get("version", 1) != 1:
                raise MemoLayoutError(
                    f"{self.path} uses memo layout v{layout.get('version')}"
                    f" ({layout.get('shards', '?')}-way sharded index); a "
                    "plain MemoStore only reads the v1 single-file layout "
                    "— open it with repro_torch.fleet.shared_memo."
                    "ShardedMemoStore instead")
        self._lock = threading.RLock()
        # fingerprint -> MemoRecord, LRU order (last = most recent)
        self._records: "OrderedDict[str, MemoRecord]" = OrderedDict()  # @locked:_lock
        # family -> [fingerprint] (insertion order; rebuilt on load)
        self._families: Dict[Tuple, List[str]] = {}  # @locked:_lock
        self._bytes = 0              # @locked:_lock
        self._index_events = 0       # @locked:_lock  index lines (live+dead)
        self._index_pos = 0          # @locked:_lock  bytes consumed by refresh
        self._index_ino = None       # @locked:_lock  inode those bytes came from
        if self.path:
            os.makedirs(os.path.join(self.path, "payload"), exist_ok=True)
            self.refresh()

    # -- paths ----------------------------------------------------------------
    def _index_path(self) -> str:
        return os.path.join(self.path, self.index_name)

    def _payload_path(self, fp: str) -> str:
        return os.path.join(self.path, "payload", f"{fp}.npz")

    # -- disk primitives ------------------------------------------------------
    @staticmethod
    def _flock(fd: int, op: int) -> bool:
        """Best-effort advisory lock; False when the platform or the
        filesystem doesn't support it (callers degrade gracefully)."""
        if fcntl is None:
            return False
        try:
            fcntl.flock(fd, op)
            return True
        except OSError:
            return False

    def _append_line(self, obj: Dict) -> None:
        """Append one index line (atomic O_APPEND write).  @holds:_lock"""
        line = (json.dumps(obj, separators=(",", ":")) + "\n").encode()
        while True:
            fd = os.open(self._index_path(),
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            locked = False
            try:
                # shared lock + liveness check close the compaction
                # window: a concurrent _compact_locked holds the
                # exclusive lock on the live inode across its
                # refresh->replace, so once WE hold the shared lock on
                # an fd that still IS the path's inode, the compactor
                # either already consumed our line or cannot replace
                # until we finish writing.  A write that would land on
                # a dead (just-replaced) inode retries on the new file.
                locked = self._flock(fd, fcntl.LOCK_SH if fcntl else 0)
                try:
                    st_path = os.stat(self._index_path())
                except FileNotFoundError:
                    continue                     # mid-replace: retry
                if st_path.st_ino != os.fstat(fd).st_ino:
                    continue                     # dead inode: reopen
                os.write(fd, line)  # one small O_APPEND write: atomic
                break
            finally:
                if locked:
                    fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)
        # deliberately do NOT advance _index_pos: with O_APPEND this line
        # may land after other processes' lines we have not consumed yet,
        # and skipping len(line) bytes from the old cursor would start
        # the next refresh() mid-way through THEIR data.  refresh()
        # re-reading our own line is an idempotent overwrite.
        self._index_events += 1

    def _write_payload(self, fp: str, arrays: Dict[str, np.ndarray]) -> None:
        final = self._payload_path(fp)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(final),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, final)   # atomic: readers see old or new, whole
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _load_payload(self, fp: str) -> Optional[Dict[str, np.ndarray]]:
        try:
            with np.load(self._payload_path(fp)) as z:
                return {k: z[k] for k in z.files}
        except (FileNotFoundError, OSError, ValueError):
            return None              # in-flight or vanished: skip

    # -- in-memory index maintenance ------------------------------------------
    def _insert(self, rec: MemoRecord) -> None:
        """@holds:_lock"""
        old = self._records.pop(rec.fingerprint, None)
        if old is not None:
            self._bytes -= old.nbytes
            self._forget_family(old)
        self._records[rec.fingerprint] = rec
        self._families.setdefault(rec.family, []).append(rec.fingerprint)
        self._bytes += rec.nbytes

    def _forget_family(self, rec: MemoRecord) -> None:
        """@holds:_lock"""
        fps = self._families.get(rec.family)
        if fps is not None:
            try:
                fps.remove(rec.fingerprint)
            except ValueError:
                pass
            if not fps:
                del self._families[rec.family]

    def _drop(self, fp: str, tombstone: bool) -> None:
        """@holds:_lock"""
        rec = self._records.pop(fp, None)
        if rec is None:
            return
        self._bytes -= rec.nbytes
        self._forget_family(rec)
        if self.path:
            try:
                os.unlink(self._payload_path(fp))
            except FileNotFoundError:
                pass
            if tombstone:
                self._append_line({"op": "del", "fp": fp})

    def _evict_over_budget(self) -> None:
        """@holds:_lock"""
        if self.byte_budget is None:
            return
        while self._bytes > self.byte_budget and len(self._records) > 1:
            oldest = next(iter(self._records))   # least recently used
            self._drop(oldest, tombstone=True)

    # -- public API -----------------------------------------------------------
    def put(self, rec: MemoRecord) -> None:
        """Insert (or overwrite) a record; evicts LRU past the budget."""
        arrays = {k: np.ascontiguousarray(v) for k, v in rec.arrays.items()}
        rec = MemoRecord(fingerprint=rec.fingerprint,
                         family=tuple(rec.family), arrays=arrays,
                         meta=dict(rec.meta))
        with self._lock:
            if self.path:
                self._write_payload(rec.fingerprint, arrays)
                self._append_line({
                    "op": "put", "fp": rec.fingerprint,
                    "family": list(rec.family), "meta": rec.meta,
                    "nbytes": rec.nbytes})
            self._insert(rec)
            self._evict_over_budget()
            if (self.path and self._index_events
                    > max(len(self._records), 1) * _COMPACT_SLACK):
                self._compact_locked()

    def get(self, fingerprint: str) -> Optional[MemoRecord]:
        """Exact lookup; refreshes the record's LRU recency."""
        with self._lock:
            rec = self._records.get(fingerprint)
            if rec is not None:
                self._records.move_to_end(fingerprint)
            return rec

    def family(self, family: Tuple) -> List[MemoRecord]:
        """All live records of a transfer family, insertion order."""
        with self._lock:
            return [self._records[fp]
                    for fp in self._families.get(tuple(family), [])
                    if fp in self._records]

    def discard(self, fingerprint: str) -> None:
        with self._lock:
            self._drop(fingerprint, tombstone=True)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __contains__(self, fingerprint: str) -> bool:
        with self._lock:
            return fingerprint in self._records

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def refresh(self) -> int:
        """Replay index lines appended since the last load (other
        processes' inserts/evictions).  Returns events consumed.

        Tail-only by construction: the byte cursor (``_index_pos``) marks
        how far this store has consumed its index file, so a refresh
        parses only the appended tail — never the whole file — and an
        inode change (another process compacted) falls back to a full
        rescan of the replacement index.  The no-change probe below makes
        the idle case one ``stat`` with no ``open`` at all, which is what
        keeps consult-before-every-lookup cheap on a large shared store
        (the fleet's shard stores refresh on every chunk)."""
        if not self.path:
            return 0
        with self._lock:
            try:
                st0 = os.stat(self._index_path())
            except FileNotFoundError:
                return 0
            if (self._index_ino is not None
                    and st0.st_ino == self._index_ino
                    and st0.st_size == self._index_pos):
                # unchanged: same inode, not a byte past our cursor.  A
                # line landing between this stat and return is caught by
                # the next refresh — append-only writes can only grow
                # the file, never mutate consumed bytes.
                return 0
            try:
                f = open(self._index_path(), "rb")
            except FileNotFoundError:
                return 0
            with f:
                # fstat the OPEN fd, so inode/size describe exactly the
                # file being read even if it is replaced concurrently
                st = os.fstat(f.fileno())
                if (self._index_ino is not None
                        and st.st_ino != self._index_ino) \
                        or st.st_size < self._index_pos:
                    # the index was atomically replaced (another process
                    # compacted) or shrank: our byte cursor refers to the
                    # dead inode, and resuming mid-file would parse from
                    # an arbitrary offset and silently miss records.
                    # Rebuild from scratch — the new index IS the
                    # complete live state.
                    self._records.clear()
                    self._families.clear()
                    self._bytes = 0
                    self._index_pos = 0
                    self._index_events = 0
                self._index_ino = st.st_ino
                f.seek(self._index_pos)
                data = f.read()
                self._index_pos = f.tell()
            n = 0
            for raw in data.splitlines():
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    ev = json.loads(raw)
                except json.JSONDecodeError:
                    continue         # torn tail line: next refresh gets it
                n += 1
                # _index_events is NOT incremented here: our own appends
                # were counted at _append_line time and are re-read by
                # refresh (the cursor does not advance on append), so
                # counting again would double them and trigger
                # compaction at ~half the intended slack.  Others'
                # lines go momentarily uncounted — compaction merely
                # waits for the next local appends, never rewrites early.
                if ev.get("op") == "del":
                    rec = self._records.pop(ev["fp"], None)
                    if rec is not None:
                        self._bytes -= rec.nbytes
                        self._forget_family(rec)
                elif ev.get("op") == "put":
                    live = self._records.get(ev["fp"])
                    if (live is not None
                            and live.nbytes == ev.get("nbytes")
                            and live.meta == ev.get("meta", {})
                            and live.family == tuple(ev["family"])):
                        # our own (or an identical) line re-read: skip
                        # the redundant npz load and leave LRU recency
                        # alone.  The line must be indistinguishable
                        # from the live record — size alone is NOT
                        # enough (a same-size overwrite with different
                        # meta would silently keep the stale meta);
                        # same fp + size + family + meta means the same
                        # content-addressed record.
                        continue
                    arrays = self._load_payload(ev["fp"])
                    if arrays is None:
                        continue
                    self._insert(MemoRecord(
                        fingerprint=ev["fp"], family=tuple(ev["family"]),
                        arrays=arrays, meta=ev.get("meta", {})))
            self._evict_over_budget()
            return n

    def compact(self) -> None:
        """Rewrite the index to exactly the live records (atomic)."""
        if not self.path:
            return
        with self._lock:
            self._compact_locked()

    _LOCK_STALE_S = 60.0       # a compaction takes ms; a minute-old lock
                               # is a dead process's leftover

    def _compact_locked(self) -> None:
        """@holds:_lock (cross-process exclusion via the lock file)"""
        # shard stores compact independently: one lock per index file
        # (the legacy name is kept for the v1 single-file layout)
        lockfile = os.path.join(
            self.path, "compact.lock" if self.index_name == "index.jsonl"
            else f"{self.index_name}.compact.lock")
        try:
            fd = os.open(lockfile, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # another process is compacting — unless the lock is stale
            # (its owner died between O_EXCL and the finally-unlink, and
            # leaving it would silently disable compaction forever).
            # Reclaim via rename: exactly ONE process wins the rename,
            # and staleness is judged on the file actually grabbed —
            # unlink-after-stat would let two reclaimers race and one of
            # them delete the other's fresh lock.
            try:
                import time
                claimed = lockfile + ".reclaim"
                os.rename(lockfile, claimed)      # single winner
                if time.time() - os.path.getmtime(claimed) \
                        < self._LOCK_STALE_S:
                    os.rename(claimed, lockfile)  # live lock: restore it
                    return
                os.unlink(claimed)
                fd = os.open(lockfile,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except (FileNotFoundError, FileExistsError, OSError):
                return          # lost the reclaim race: skip this round
        try:
            os.close(fd)
            # hold an fd on the OLD index inode across the replace: a
            # line another process appends inside the snapshot->replace
            # window lands on this inode, not the new file, and without
            # the fd it would vanish with the inode.  A lost "put" only
            # costs a recomputation, but a lost "del" tombstone would
            # RESURRECT an evicted record on the next rebuild.  Where
            # flock works, the exclusive lock closes the window outright
            # (appenders hold a shared lock while writing and retry onto
            # the new file when their inode dies); the tail rescue below
            # covers no-flock filesystems.
            try:
                old = open(self._index_path(), "rb")
            except FileNotFoundError:
                old = None
            ex_locked = (old is not None
                         and self._flock(old.fileno(),
                                         fcntl.LOCK_EX if fcntl else 0))
            # fold in index lines other processes appended since our
            # last refresh BEFORE snapshotting: the rewrite below keeps
            # exactly self._records, and anything unseen would otherwise
            # be dropped from the index (orphaning its payloads).  Under
            # the exclusive lock this read is complete — no appender can
            # land another line on this inode until we release.
            self.refresh()
            snap_pos = self._index_pos      # refresh() consumed up to here
            try:
                fd2, tmp = tempfile.mkstemp(dir=self.path, suffix=".idx")
                try:
                    with os.fdopen(fd2, "w") as f:
                        for rec in self._records.values():
                            f.write(json.dumps(
                                {"op": "put", "fp": rec.fingerprint,
                                 "family": list(rec.family),
                                 "meta": rec.meta, "nbytes": rec.nbytes},
                                separators=(",", ":")) + "\n")
                        f.flush()
                        # cursor from the tmp fd BEFORE the replace:
                        # stat()ing the path afterwards would also count
                        # bytes other processes append to the new index
                        # in between, and skipping those on the next
                        # refresh() would silently miss their records
                        st = os.fstat(f.fileno())
                except BaseException:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    raise
                os.replace(tmp, self._index_path())
                self._index_pos = st.st_size
                self._index_ino = st.st_ino
                self._index_events = len(self._records)
                # rescue the window: replay every complete line appended
                # to the old inode after our snapshot cursor onto the
                # new index (O_APPEND writes are whole lines, so the
                # tail parses cleanly; _append_line leaves _index_pos
                # alone, so the next refresh() folds them into memory)
                if old is not None:
                    old.seek(snap_pos)
                    for raw in old.read().splitlines():
                        raw = raw.strip()
                        if not raw:
                            continue
                        try:
                            ev = json.loads(raw)
                        except json.JSONDecodeError:
                            continue
                        self._append_line(ev)
            finally:
                if old is not None:
                    if ex_locked:
                        fcntl.flock(old.fileno(), fcntl.LOCK_UN)
                    old.close()
        finally:
            try:
                os.unlink(lockfile)
            except FileNotFoundError:
                pass
