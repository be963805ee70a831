"""Fleet launcher — N scheduler workers as subprocesses.

Each worker is a fresh interpreter (``subprocess.Popen`` running
``repro_torch.fleet.worker.main``, never a fork, so no CUDA context
crosses a fork) running one :class:`~repro_torch.stream.StreamingScheduler`.
With ``device="cuda"`` (the default) each worker is pinned with
``CUDA_VISIBLE_DEVICES`` to one card, round-robin over the cards the
parent sees, or with ``devices_per_worker=k`` to a group of k: worker i
takes cards ``i*k .. i*k+k-1`` of the visible list, wrapping round, and
its stream shards every batch over them.  On a host with one card every
worker shares card 0, and the card time-slices between their contexts.
With ``device="cpu"`` the workers run on the CPU with one torch thread
each (a group of k is k ``cpu`` entries), which is how the tests bring
up a real subprocess fleet on a laptop.

    cfg = FleetConfig(num_workers=2, budget=300)
    with launch_fleet(cfg) as fleet:
        results = fleet.run(generate_trace(TraceConfig(...)))
        print(fleet.last_metrics.summary())

``distributed=True`` joins the workers into one ``torch.distributed``
process group at ``init`` (rank = worker index, NCCL on ``cuda``, gloo on
``cpu``, at a ``tcp://127.0.0.1`` address the launcher picks), as the
reference's ``jax.distributed.initialize`` does.  Scheduling stays
process-local, so rows stay bitwise; a worker that fails to join raises,
and the fleet never carries on without it.

``launch_fleet`` blocks until every worker reports ready (imports and
device init), so ``run`` measures scheduling, not startup.  A port of
``repro.fleet.launch``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.worker import PREFIX


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet shape + the per-worker service knobs.

    num_workers         scheduler processes
    devices_per_worker  devices a worker shards its batches over (None:
                        one card, or the CPU)
    budget / strategy   the per-worker StreamingScheduler defaults
    stream              StreamConfig field overrides for every worker
                        (dict, e.g. {"batch_rows": 4})
    memo_path           shared ShardedMemoStore directory (None: no memo)
    memo_near           near-hit warm seeding from the shared store.
                        OFF by default: a warm-seeded row searches from
                        a transferred population and is bitwise the
                        memoized warm search, NOT the cold standalone
                        row — the fleet's hard guarantee
    chunk_rows          max scenarios the router sends a worker per chunk
    max_outstanding     chunks in flight per worker (2 = the pipe's
                        double buffering: the next chunk rides the wire
                        while the current one computes)
    steal               work-stealing on (False: static partition only)
    distributed         join the workers into one torch.distributed
                        process group (rank = worker index; address on
                        localhost); every worker must join
    ready_timeout_s     max wait for any worker reply: startup (imports
                        + device), a warmup, or the next message of a run
                        (a hung worker fails the call, not the caller)
    obs                 repro_torch.obs.ObsConfig (or field dict) shipped
                        to every worker's StreamingScheduler AND used by
                        the router itself (None: observability off)
    recompile_guard     arm a process-lifetime RecompileGuard in every
                        worker; ``mark_warm()`` sets the boundary and
                        ``worker_stats()`` reports
                        compiles / recompiles_post_warmup (kernel
                        library builds and generation-step captures;
                        compile_names / post_warmup name them)
    device              "cuda" (cards a worker, round-robin) or "cpu"
    """
    num_workers: int = 2
    devices_per_worker: Optional[int] = None
    budget: int = 2_000
    strategy: Optional[str] = None
    stream: Optional[Dict] = None
    memo_path: Optional[str] = None
    memo_near: bool = False
    chunk_rows: int = 16
    max_outstanding: int = 2
    steal: bool = True
    distributed: bool = False
    ready_timeout_s: float = 120.0
    obs: Optional[Dict] = None
    recompile_guard: bool = False
    device: str = "cuda"

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got "
                             f"{self.num_workers}")
        if self.devices_per_worker is not None \
                and self.devices_per_worker < 1:
            raise ValueError("devices_per_worker must be >= 1 or None")
        if self.chunk_rows < 1 or self.max_outstanding < 1:
            raise ValueError("chunk_rows and max_outstanding must be >= 1")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{self.device!r}")
        from repro_torch.obs import as_obs_config
        as_obs_config(self.obs)       # validate shape/values early


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_devices(i: int, k: Optional[int], cards: List[str]
                   ) -> Tuple[Optional[str], Optional[List[str]]]:
    """Worker ``i``'s ``CUDA_VISIBLE_DEVICES`` and its stream's device
    list for groups of ``k`` cards (None: one card, round-robin) out of
    the visible ``cards`` (empty: the CPU).  A card named twice in a
    group is listed once in the environment and twice in the devices."""
    if not cards:
        return None, None if k is None else ["cpu"] * k
    if k is None:
        return cards[i % len(cards)], None
    group = [cards[(i * k + j) % len(cards)] for j in range(k)]
    unique = list(dict.fromkeys(group))
    return (",".join(unique),
            [f"cuda:{unique.index(c)}" for c in group])


def _visible_cards() -> List[str]:
    """The card ids this process may hand to workers: its own
    ``CUDA_VISIBLE_DEVICES`` list when set, else every card it sees."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c.strip() for c in env.split(",") if c.strip()]
    import torch
    return [str(i) for i in range(torch.cuda.device_count())]


class WorkerHandle:
    """One worker subprocess: stdin for commands, a reader thread
    draining stdout protocol lines into the fleet's shared inbox."""

    def __init__(self, worker_id: str, proc: subprocess.Popen,
                 inbox: "queue.Queue[Tuple[str, Dict]]"):
        self.worker_id = worker_id
        self.proc = proc
        self._inbox = inbox
        self.outstanding = 0          # chunks sent, not yet done
        self.stats: Dict = {}         # final worker-side rollup (on stop)
        self.stats_snapshot: Optional[Dict] = None   # router delta base
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        for line in self.proc.stdout:
            if line.startswith(PREFIX):
                try:
                    self._inbox.put((self.worker_id,
                                     json.loads(line[len(PREFIX):])))
                except json.JSONDecodeError:
                    pass              # torn line at kill time
        self._inbox.put((self.worker_id, {"ok": "eof"}))

    def send(self, msg: Dict) -> None:
        self.proc.stdin.write(json.dumps(msg) + "\n")
        self.proc.stdin.flush()

    def close(self, timeout: float = 10.0) -> None:
        try:
            if self.proc.poll() is None:
                self.send({"cmd": "stop"})
                self.proc.stdin.close()
                self.proc.wait(timeout=timeout)
        except (BrokenPipeError, OSError, subprocess.TimeoutExpired):
            self.proc.kill()
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait()


class Fleet:
    """A running fleet: worker handles + the router front door.

    ``run`` routes a trace through the fleet and returns
    :class:`~repro_torch.fleet.router.FleetResult`s ordered by uid;
    ``last_metrics`` holds the run's
    :class:`~repro_torch.fleet.metrics.FleetMetrics`.
    """

    def __init__(self, cfg: FleetConfig):
        self.cfg = cfg
        self.inbox: "queue.Queue[Tuple[str, Dict]]" = queue.Queue()
        self.workers: List[WorkerHandle] = []
        self.last_metrics = None
        cards: List[str] = []
        if cfg.device == "cuda":
            cards = _visible_cards()
            # build the generation loop's kernels once here, so N
            # workers do not each run nvcc on the same sources (they load
            # the libraries the builds left, keyed on the sources' hash)
            from repro_torch.kernels import _build
            for name in ("makespan", "draws"):
                _build.load(name)
        group = (f"tcp://127.0.0.1:{_free_port()}" if cfg.distributed
                 else None)
        try:
            for i in range(cfg.num_workers):
                self.workers.append(self._spawn(i, cards))
            # every init goes out before the first wait: distributed
            # workers wait for each other inside init_process_group
            for i, w in enumerate(self.workers):
                w.send(self._init_msg(i, cards, group))
            self._await(self.workers, "ready", cfg.ready_timeout_s,
                        "startup")
        except BaseException:
            self.close()
            raise

    # -- startup --------------------------------------------------------------
    def _spawn(self, i: int, cards: List[str]) -> WorkerHandle:
        env = dict(os.environ)
        # the worker must import the SAME repro_torch the parent runs,
        # regardless of the parent's cwd-relative PYTHONPATH
        import repro_torch
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env["PYTHONPATH"] = (root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else root)
        visible, _ = worker_devices(i, self.cfg.devices_per_worker, cards)
        if visible is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible
        # the worker's main() (what ``python -m repro_torch.fleet.worker``
        # runs), entered without runpy re-executing a module the package
        # import already loaded
        proc = subprocess.Popen(
            [sys.executable, "-u", "-c", "import sys; from repro_torch."
             "fleet.worker import main; sys.exit(main())"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            text=True)
        return WorkerHandle(f"w{i}", proc, self.inbox)

    def _init_msg(self, i: int, cards: List[str],
                  group: Optional[str]) -> Dict:
        cfg = self.cfg
        obs = None
        if cfg.obs is not None:
            from repro_torch.obs import as_obs_config
            obs = dataclasses.asdict(as_obs_config(cfg.obs))
        _, devices = worker_devices(i, cfg.devices_per_worker, cards)
        return {"cmd": "init", "worker_id": f"w{i}",
                "budget": cfg.budget, "strategy": cfg.strategy,
                "stream": cfg.stream or {}, "memo_path": cfg.memo_path,
                "memo_near": cfg.memo_near, "obs": obs,
                "recompile_guard": cfg.recompile_guard,
                "device": cfg.device, "devices": devices,
                "distributed": None if group is None else {
                    "init_method": group, "rank": i,
                    "world_size": cfg.num_workers,
                    "timeout_s": cfg.ready_timeout_s}}

    def _await(self, workers: Sequence[WorkerHandle], reply: str,
               timeout_s: float, what: str) -> Dict[str, Dict]:
        """Wait for ``reply`` from every worker in ``workers`` (their
        messages by worker id); a worker error, a dead worker or the
        deadline raises."""
        deadline = time.monotonic() + timeout_s
        pending = {w.worker_id for w in workers}
        got: Dict[str, Dict] = {}
        while pending:
            try:
                wid, msg = self.inbox.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(
                    f"fleet {what}: workers {sorted(pending)} silent for "
                    f"{timeout_s:.0f}s") from None
            if msg.get("ok") == reply:
                pending.discard(wid)
                got[wid] = msg
            elif msg.get("ok") in ("error", "eof"):
                raise RuntimeError(f"fleet worker {wid} failed at "
                                   f"{what}: {msg}")
        return got

    # -- serving --------------------------------------------------------------
    def run(self, requests: Sequence = (), prepared: Sequence = (),
            steal: Optional[bool] = None):
        """Route one trace (and/or prepared scenarios) through the
        fleet; results come back uid-ordered, metrics land in
        ``last_metrics``.  ``steal`` overrides the config's
        work-stealing flag for this run only."""
        from repro_torch.fleet.router import FleetRouter
        router = FleetRouter(self.workers, self.inbox,
                             chunk_rows=self.cfg.chunk_rows,
                             max_outstanding=self.cfg.max_outstanding,
                             steal=(self.cfg.steal if steal is None
                                    else bool(steal)),
                             default_budget=self.cfg.budget,
                             stream=self.cfg.stream or {},
                             obs=self.cfg.obs,
                             recv_timeout_s=self.cfg.ready_timeout_s)
        results = router.run(requests, prepared=prepared)
        self.last_metrics = router.last_metrics
        return results

    def warmup(self, requests: Sequence, prepared: Sequence = ()) -> None:
        """Warm every worker over a trace (and/or prepared scenarios):
        each worker runs its service's ``warmup`` (every admission bucket
        of every signature), so a following ``mark_warm()`` boundary is
        airtight — nothing is left for the measured runs to load,
        capture or allocate first."""
        from repro_torch.fleet.worker import encode_prepared, encode_request
        for w in self.workers:
            w.send({"cmd": "warmup",
                    "requests": [encode_request(r) for r in requests],
                    "prepared": [encode_prepared(p) for p in prepared]})
        self._await(self.workers, "warmed", self.cfg.ready_timeout_s,
                    "warmup")

    def mark_warm(self) -> None:
        """Tell every worker its RecompileGuard warmup is over: compiles
        so far were deliberate, any later one shows up in
        ``worker_stats()`` as ``recompiles_post_warmup``.  No-op for
        workers launched without ``recompile_guard``."""
        for w in self.workers:
            w.send({"cmd": "warm_boundary"})
        self._await(self.workers, "warm", 60.0, "warm_boundary")

    def worker_stats(self) -> Dict[str, Dict]:
        """Raw lifetime worker rollups (a 'stats' round trip to every
        worker; unlike the router's per-run deltas these are the
        process-lifetime counters, including ``makespan_launches``, which
        equals ``dispatched_generations`` plus ``warm_launches`` (one a
        ``graph_captures``), ``draws_launches``, which equals
        ``magma_tells`` on a card, and, with the guard armed, ``compiles`` /
        ``compile_names`` / ``recompiles_post_warmup`` /
        ``post_warmup``)."""
        for w in self.workers:
            w.send({"cmd": "stats"})
        got = self._await(self.workers, "stats", 60.0, "stats")
        return {wid: msg.get("stats", {}) for wid, msg in got.items()}

    def close(self) -> None:
        for w in self.workers:
            w.close()
        # collect final worker rollups (already enqueued by stop replies)
        while True:
            try:
                wid, msg = self.inbox.get_nowait()
            except queue.Empty:
                break
            if msg.get("ok") == "stopped":
                for w in self.workers:
                    if w.worker_id == wid:
                        w.stats = msg.get("stats", {})

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def launch_fleet(cfg: Optional[FleetConfig] = None, **overrides) -> Fleet:
    """Bring up a fleet (blocking until every worker is ready).  Keyword
    overrides patch ``cfg`` (or a default one): ``launch_fleet(
    num_workers=4, device="cpu")``."""
    if cfg is None:
        cfg = FleetConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return Fleet(cfg)
