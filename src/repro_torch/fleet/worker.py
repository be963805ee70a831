"""Fleet worker — one scheduler process serving chunks over stdio.

``python -m repro_torch.fleet.worker`` is the subprocess the launcher
spawns: it builds ONE long-lived
:class:`~repro_torch.stream.StreamingScheduler` on this process's device
and serves "run" commands — each a chunk of held partials the router
assembled — returning every schedule over the same pipe.  The worker is
deliberately dumb: all placement policy (partitioning, stealing) lives in
the router; the worker just runs the unchanged stream pipeline, which is
what makes every fleet schedule bitwise the port's standalone row.  A port
of ``repro.fleet.worker``.

Wire protocol (JSON lines)
--------------------------
Parent -> worker (stdin): ``{"cmd": "init"|"run"|"warmup"|"stats"|
"warm_boundary"|"stop", ...}``.
Worker -> parent (stdout): lines prefixed ``@fleet `` — anything else on
stdout (library prints, banners, ``nvcc`` chatter) is ignored by the
parent, so a chatty dependency cannot corrupt the protocol.  Arrays cross
as ``{"dtype", "shape", "b64"}`` (raw little-endian bytes, base64): bit
exact by construction, no text round-off.  ``best_fitness`` crosses as a
Python float — f32 widens to f64 exactly and ``json`` round-trips f64
exactly (repr shortest-round-trip), so equality survives the pipe.

Device: the init message's ``device`` ("cuda" unless the caller asks for
"cpu").  A "cuda" worker that finds no card raises at init — it never
falls back to the CPU.  The launcher pins each worker to its card, or its
group of cards, with ``CUDA_VISIBLE_DEVICES``; the message's ``devices``
(a group's list, cards named as this process sees them) become its
stream's shard devices.  A "cpu" worker runs one torch thread, so that
several share a host's cores.

Process group: with the message's ``distributed`` set, the worker joins
the fleet's ``torch.distributed`` group at init (its rank, the world
size and a ``tcp://`` address the launcher picked; NCCL on a card, gloo
on the CPU), and waits until every rank has joined or the timeout
passes, which raises: a fleet never runs with a worker missing.
Scheduling stays process-local, so rows are unchanged.

Memo: with a shared store configured the worker opens the SAME
:class:`~repro_torch.fleet.shared_memo.ShardedMemoStore` directory as
every other worker and stamps its records ``origin=<worker_id>``; it
calls ``store.refresh()`` before each chunk, so schedules solved by one
worker replay as exact hits on any other (counted in
``MemoStats.foreign_hits``).
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

PREFIX = "@fleet "


# -- array / scenario codec (also imported by the router side) ----------------
def encode_array(x) -> Dict:
    """A tensor (on any device) or array on the wire, its shape kept — a
    0-d table field stays 0-d (``np.ascontiguousarray`` alone would make
    it 1-d, and a (1,) ``bw_sys`` would stack into (R, 1))."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return {"dtype": x.dtype.str, "shape": list(x.shape),
            "b64": base64.b64encode(np.ascontiguousarray(x).tobytes()
                                    ).decode("ascii")}


def decode_array(d: Dict) -> np.ndarray:
    buf = base64.b64decode(d["b64"])
    return np.frombuffer(buf, dtype=np.dtype(d["dtype"])) \
             .reshape(d["shape"]).copy()


def encode_request(req) -> Dict:
    return dataclasses.asdict(req)


def decode_request(d: Dict):
    from repro_torch.stream.workloads import ScenarioRequest
    return ScenarioRequest(**d)


def encode_prepared(p) -> Dict:
    """A :class:`~repro_torch.stream.service.PreparedScenario` on the
    wire: the analyzed tables (``FitnessParams`` fields, bit exact) +
    executable statics.  Strategy overrides cross by NAME only — a custom
    strategy instance is not portable across processes."""
    fit = p.fit
    strategy = p.strategy
    if strategy is not None and not isinstance(strategy, str):
        strategy = strategy.name
    spec = fit.objective_spec
    return {
        "params": {k: encode_array(v)
                   for k, v in fit.params._asdict().items()},
        "num_accels": int(fit.num_accels),
        "use_kernel": bool(fit.use_kernel),
        "objective": None if spec is None else list(spec.names),
        "seed": int(p.seed), "uid": int(p.uid),
        "budget": p.budget, "strategy": strategy,
        "priority": p.priority, "deadline_s": p.deadline_s,
    }


class _WireFit:
    """The fit-like adapter a decoded prepared scenario schedules as:
    exactly the attribute surface admission / dispatch / memo touch (the
    ``FitnessFn`` duck type — host tables + executable statics)."""

    def __init__(self, params, num_accels: int, use_kernel: bool,
                 objective_names: Optional[List[str]]):
        import torch

        from repro_torch.core.fitness import FitnessParams, ObjectiveSpec
        self.params = FitnessParams(**{k: torch.from_numpy(v)
                                       for k, v in params.items()})
        self.num_accels = int(num_accels)
        self.use_kernel = bool(use_kernel)
        self.objective_spec = (None if objective_names is None
                               else ObjectiveSpec(tuple(objective_names)))
        self.objective = self.objective_spec
        self.group_size = int(self.params.lat.shape[-2])
        self.bw_sys = float(self.params.bw_sys)


def decode_prepared(d: Dict):
    from repro_torch.stream.service import PreparedScenario
    fit = _WireFit({k: decode_array(v) for k, v in d["params"].items()},
                   d["num_accels"], d["use_kernel"], d["objective"])
    return PreparedScenario(fit=fit, seed=d["seed"], uid=d["uid"],
                            budget=d["budget"], strategy=d["strategy"],
                            priority=d["priority"],
                            deadline_s=d["deadline_s"])


def encode_result(r) -> Dict:
    return {
        "uid": int(r.request.uid),
        "best_fitness": float(r.best_fitness),
        "best_accel": encode_array(r.best_accel),
        "best_prio": encode_array(r.best_prio),
        "history_best": encode_array(r.history_best),
        "n_samples": int(r.n_samples),
        "budget": int(r.budget),
        "memo_exact": bool(r.memo_exact),
        "warm_seeded": bool(r.warm_seeded),
        "anytime_interim": bool(r.anytime_interim),
    }


# -- the worker process -------------------------------------------------------
def _emit(msg: Dict) -> None:
    sys.stdout.write(PREFIX + json.dumps(msg) + "\n")
    sys.stdout.flush()


def join_group(spec: Dict, device) -> str:
    """Join the fleet's process group as ``spec`` says: a TCP store at its
    address (rank 0 serves it), the backend for ``device``, and a wait on
    the store until every rank has checked in.  Returns the backend."""
    import datetime
    from urllib.parse import urlparse

    import torch.distributed as dist
    url = urlparse(spec["init_method"])
    rank, world = int(spec["rank"]), int(spec["world_size"])
    timeout = datetime.timedelta(seconds=float(spec["timeout_s"]))
    store = dist.TCPStore(url.hostname, url.port, world,
                          is_master=rank == 0, timeout=timeout)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    store.set(f"fleet/joined/{rank}", "1")
    store.wait([f"fleet/joined/{r}" for r in range(world)], timeout)
    return backend


class _Worker:
    def __init__(self, init: Dict):
        import torch
        self.worker_id = str(init.get("worker_id", "w?"))
        device = torch.device(init.get("device", "cuda"))
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"fleet worker {self.worker_id} asked for {device} but "
                "sees no CUDA card (CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        if device.type == "cpu":
            torch.set_num_threads(1)
        self.group = None
        if init.get("distributed"):
            spec = init["distributed"]
            self.group = {"rank": int(spec["rank"]),
                          "world_size": int(spec["world_size"]),
                          "backend": join_group(spec, device)}
        # the guard goes up first, so the kernel library's load at the
        # first batch (or at warmup) is counted as a compile
        self.guard = None
        if init.get("recompile_guard"):
            # process-lifetime observer: entered once, never exited (the
            # process exit tears its listeners down with it); the router
            # marks the warmup boundary via the "warm_boundary" command,
            # after which stats report any violations
            from repro_torch.lint.runtime import RecompileGuard
            self.guard = RecompileGuard(label=self.worker_id).__enter__()
        from repro_torch.stream.service import (StreamConfig,
                                                StreamingScheduler)
        self.memo = None
        memo_path = init.get("memo_path")
        if memo_path:
            from repro_torch.fleet.shared_memo import ShardedMemoStore
            from repro_torch.memo import ScheduleMemo
            # near=False by default: near-hit warm seeding searches from
            # a transferred population, which is bitwise the memoized
            # WARM search but not the cold standalone row — the fleet's
            # hard guarantee.  memo_near=True opts into cross-worker warm
            # starts where convergence matters more.
            self.memo = ScheduleMemo(ShardedMemoStore(memo_path),
                                     near=bool(init.get("memo_near", False)),
                                     origin=self.worker_id)
        stream_d = dict(init.get("stream") or {})
        if init.get("devices"):
            stream_d["devices"] = tuple(init["devices"])
        obs = init.get("obs")
        if obs:
            # the fleet's ObsConfig rides the init message as a dict;
            # per-worker defaults: spans carry THIS worker's id, and the
            # ring accumulates across chunks (each chunk is one service
            # run — clearing per run would keep only the last chunk)
            obs = dict(obs)
            obs.setdefault("worker", self.worker_id)
            obs["clear_per_run"] = bool(obs.get("clear_per_run", False))
            stream_d["obs"] = obs
        stream = StreamConfig(**stream_d)
        self.svc = StreamingScheduler(strategy=init.get("strategy"),
                                      budget=int(init.get("budget", 2000)),
                                      stream=stream, memo=self.memo,
                                      device=device)
        if self.guard is not None and self.svc.flight is not None:
            self.svc.flight.attach_guard(self.guard)
        self.chunks = 0
        self.scenarios = 0
        self.run_wall_s = 0.0
        self.peak_depth = 0
        self.early_flushes = 0
        self.refinements = 0
        _emit({"ok": "ready", "worker": self.worker_id,
               "device": str(device),
               "devices": torch.cuda.device_count(),
               "shards": [str(d) for d in self.svc.devices],
               "group": self.group})

    def handle_run(self, msg: Dict) -> None:
        requests = [decode_request(d) for d in msg.get("requests", ())]
        prepared = [decode_prepared(d) for d in msg.get("prepared", ())]
        if self.memo is not None:
            # fold in every record other workers landed since our last
            # chunk — this is the moment a foreign schedule becomes an
            # exact hit here (one stat per unchanged shard)
            self.memo.store.refresh()
        t0 = time.perf_counter()
        results = self.svc.run(requests, prepared=prepared)
        wall = time.perf_counter() - t0
        self.chunks += 1
        self.scenarios += len(results)
        self.run_wall_s += wall
        aq = self.svc.last_admission
        if aq is not None:
            self.peak_depth = max(self.peak_depth, aq.peak_depth)
            self.early_flushes += aq.early_flushes
        self.refinements += self.svc._refined
        _emit({"ok": "done", "chunk": msg.get("chunk"),
               "results": [encode_result(r) for r in results],
               "wall_s": wall})

    def handle_warmup(self, msg: Dict) -> None:
        """The service's own ``warmup`` over a decoded trace and prepared
        scenarios: every (compatibility key, bucket) shape greedy
        admission could hit runs once, so the kernel library, the
        generation loops' graphs and the allocator's blocks are in place
        before the measured runs."""
        self.svc.warmup([decode_request(d)
                         for d in msg.get("requests", ())],
                        prepared=[decode_prepared(d)
                                  for d in msg.get("prepared", ())])
        _emit({"ok": "warmed"})

    def warm_boundary(self) -> None:
        """Everything compiled so far was deliberate warmup; from here a
        compile is a violation the stats will report."""
        if self.guard is not None:
            self.guard.warmup()

    def stats(self) -> Dict:
        from repro_torch.core.strategies import graphs
        from repro_torch.kernels import draws
        from repro_torch.kernels.makespan import LAUNCHES
        memo = (self.memo.stats.summary() if self.memo is not None else {})
        # this process's makespan and draw kernel launches (the warm
        # generation's before each graph capture among them) and MAGMA's
        # tells: the parent's counters cannot see a worker's
        totals = graphs.totals()
        d = {"worker": self.worker_id, "chunks": self.chunks,
             "scenarios": self.scenarios, "run_wall_s": self.run_wall_s,
             "peak_depth": self.peak_depth,
             "early_flushes": self.early_flushes,
             "refinements": self.refinements, "memo": memo,
             "makespan_launches": LAUNCHES["makespan"],
             "draws_launches": draws.LAUNCHES["draws"],
             "magma_tells": graphs.tells().get("magma", 0),
             "dispatched_generations": self.svc.dispatched_generations,
             "graph_captures": totals["captures"],
             "warm_launches": totals["warm_launches"],
             "shards": [str(d) for d in self.svc.devices],
             "group": self.group}
        if self.guard is not None:
            # library builds and generation-step captures, by name
            d["compiles"] = len(self.guard.compiles)
            d["compile_names"] = list(self.guard.compiles)
            d["recompiles_post_warmup"] = len(self.guard.post_warmup)
            d["post_warmup"] = self.guard.post_warmup
        return d


def main() -> int:
    worker: Optional[_Worker] = None
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        msg = json.loads(line)
        cmd = msg.get("cmd")
        try:
            if cmd == "init":
                worker = _Worker(msg)
            elif cmd == "run":
                worker.handle_run(msg)
            elif cmd == "stats":
                _emit({"ok": "stats", "stats": worker.stats()
                       if worker is not None else {}})
            elif cmd == "warmup":
                worker.handle_warmup(msg)
            elif cmd == "warm_boundary":
                if worker is not None:
                    worker.warm_boundary()
                _emit({"ok": "warm"})
            elif cmd == "stop":
                _emit({"ok": "stopped", "stats": worker.stats()
                       if worker is not None else {}})
                break
            else:
                _emit({"ok": "error", "error": f"unknown cmd {cmd!r}"})
        except Exception as e:                    # protocol-visible failure
            _emit({"ok": "error", "cmd": cmd, "error": repr(e),
                   "where": traceback.format_exc(limit=-4)})
            if cmd == "init":
                return 1
    if worker is not None:
        worker.svc.close()
        if worker.group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    # line-buffer stdout even when piped, so protocol lines flush promptly
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
