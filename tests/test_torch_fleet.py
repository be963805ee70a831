"""Port parity: the scheduling fleet, ``repro_torch.fleet``.

Against the reference on the same inputs (exact):

  - ``AdmissionQueues``' steal semantics over scripted pushes, takes and
    steals (the structure the router moves work with);
  - the router's partitions, steals and counters over fake in-process
    worker handles, and ``compute_fleet_metrics`` on the same results;
  - the wire codec's array encoding;
  - v2 sharded memo directories read across the packages both ways.

The port's own guarantees, on the CPU: ``shard_of`` and
``ShardedMemoStore`` (round trip, refresh, discard, the v1 -> v2
migration done once, the versioned error for v1 readers, the budget
split), a bitwise codec round trip, ``FleetConfig`` validation with the
port's raises, and a real 2-worker ``device="cpu"`` subprocess fleet:
every row bitwise the port's standalone row, steals happen, a steal-free
rerun replays cross-worker exact hits (``foreign_hits >= 1``), and the
serving engine's ``fleet=`` schedule is bitwise its in-process one.
"""
import dataclasses
import os
import queue

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import repro.fleet as ref_fleet  # noqa: E402
import repro.stream as ref_stream  # noqa: E402
from repro.fleet import router as ref_router  # noqa: E402
from repro.fleet import worker as ref_worker  # noqa: E402
from repro.memo import MemoRecord as RefRecord  # noqa: E402
from repro.memo import MemoStore as RefStore  # noqa: E402
from repro.stream import admission as ref_admission  # noqa: E402
from repro_torch.core.strategies import get_strategy, run_strategy  # noqa: E402
from repro_torch.fleet import (FleetConfig, NUM_SHARDS,  # noqa: E402
                               ShardedMemoStore, compute_fleet_metrics,
                               launch_fleet, shard_of)
from repro_torch.fleet import worker  # noqa: E402
from repro_torch.fleet import router as port_router  # noqa: E402
from repro_torch.fleet.router import FleetRouter  # noqa: E402
from repro_torch.memo import (MemoLayoutError, MemoRecord,  # noqa: E402
                              MemoStore, read_layout)
from repro_torch.stream import (PreparedScenario, ScenarioRequest,  # noqa: E402
                                TraceConfig, analyze_serial,
                                generate_trace)
from repro_torch.stream import admission  # noqa: E402

BUDGET = 120
# a subprocess fleet that hangs fails its test within these bounds
FLEET_TIMEOUTS = dict(ready_timeout_s=60.0)


# ---------------------------------------------------------------------------
# admission queues: steal semantics against the reference
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Req:
    uid: int
    arrival_s: float = 0.0
    priority: str = "normal"
    deadline_s: object = None


@dataclasses.dataclass
class _Member:
    request: _Req
    ready_s: float = 0.0
    silent: bool = False


def _script(seed):
    """A deterministic op script: pushes onto 3 keys with mixed classes
    and deadlines, interleaved with selects, takes and steals."""
    rng = np.random.default_rng(seed)
    ops, uid = [], 0
    for step in range(60):
        r = rng.random()
        now = step * 0.05
        if r < 0.6:
            prio = ("urgent", "normal", "batch")[rng.integers(3)]
            dl = None if rng.random() < 0.4 else float(rng.uniform(0.1, 3))
            ops.append(("push", f"k{rng.integers(3)}", uid, prio, dl,
                        now, bool(rng.random() < 0.1)))
            uid += 1
        elif r < 0.8:
            ops.append(("take", now, bool(rng.random() < 0.5)))
        else:
            ops.append(("steal", int(rng.integers(1, 9)), now))
    return ops


def _replay(mod, ops, slo_aware):
    q = mod.AdmissionQueues(batch_rows=3, slo_aware=slo_aware,
                            max_hold_s=0.2, slo_margin_s=0.05)
    log = []
    for op in ops:
        if op[0] == "push":
            _, key, uid, prio, dl, now, silent = op
            q.push(key, _Member(_Req(uid, now, prio, dl), now, silent))
        elif op[0] == "take":
            key = q.select(op[1], analyses_pending=op[2])
            log.append(("take", key, None if key is None else
                        [m.request.uid for m in q.take(key)]))
        else:
            moved = q.steal(op[1], now=op[2])
            log.append(("steal", [(k, [m.request.uid for m in ms])
                                  for k, ms in moved]))
        q.check()
        log.append((q.enqueued, q.dispatched, q.stolen, q.depth,
                    q.peak_depth, q.early_flushes))
    return log


@pytest.mark.parametrize("slo_aware", [True, False], ids=["slo", "fifo"])
@pytest.mark.parametrize("seed", range(4))
def test_steal_semantics_equal_reference(seed, slo_aware):
    ops = _script(seed)
    mine = _replay(admission, ops, slo_aware)
    assert mine == _replay(ref_admission, ops, slo_aware)
    assert any(e[0] == "steal" and e[1] for e in mine
               if isinstance(e[0], str))


# ---------------------------------------------------------------------------
# sharded shared memo: layout, migration, old readers, both packages
# ---------------------------------------------------------------------------
def _rec(fp, family=("fam",), n=16, cls=MemoRecord):
    rng = np.random.default_rng(int(fp[:8], 16) % (2 ** 31))
    return cls(fingerprint=fp, family=family,
               arrays={"best_fitness": np.float32(rng.uniform()),
                       "best_accel": rng.integers(
                           0, 4, size=n).astype(np.int32)},
               meta={"seed": 1})


def _fps(n):
    """n fingerprints spread across shards (first char = hex prefix)."""
    return [f"{i % 16:x}deadbee{i:04d}" for i in range(n)]


def test_shard_of_covers_all_prefixes():
    assert [shard_of(f"{h:x}00") for h in range(16)] == list(range(16))
    assert NUM_SHARDS == 16 == ref_fleet.NUM_SHARDS
    assert all(shard_of(fp) == ref_fleet.shard_of(fp) for fp in _fps(40))


def test_sharded_roundtrip_refresh_discard(tmp_path):
    path = str(tmp_path / "memo")
    a = ShardedMemoStore(path)
    fps = _fps(32)
    for fp in fps:
        a.put(_rec(fp, family=("fam", shard_of(fp) % 2)))
    assert len(a) == 32
    assert read_layout(path) == {"version": 2, "shards": NUM_SHARDS}

    b = ShardedMemoStore(path)                 # second worker, same dir
    assert len(b) == 32
    for fp in fps:
        np.testing.assert_array_equal(b.get(fp).arrays["best_accel"],
                                      a.get(fp).arrays["best_accel"])
    assert sorted(r.fingerprint for r in b.family(("fam", 0))) \
        == sorted(fp for fp in fps if shard_of(fp) % 2 == 0)

    b.put(_rec("0feed0001"))                   # b appends, a refreshes
    assert "0feed0001" not in a
    assert a.refresh() >= 1
    assert "0feed0001" in a
    assert a.refresh() == 0                    # cursors: second stat free

    a.discard(fps[0])
    c = ShardedMemoStore(path)
    assert fps[0] not in c and len(c) == 32    # 31 live + b's append


def test_v1_index_migrates_in_place_once(tmp_path):
    path = str(tmp_path / "memo")
    v1 = MemoStore(path)
    fps = _fps(24)
    for fp in fps:
        v1.put(_rec(fp))
    v1.discard(fps[3])                         # the tombstone survives
    expect = {fp: v1.get(fp).arrays["best_accel"]
              for fp in fps if fp != fps[3]}

    v2 = ShardedMemoStore(path)                # migrates on open
    assert not os.path.exists(os.path.join(path, "index.jsonl"))
    assert os.path.exists(os.path.join(path, "index.jsonl.v1"))
    assert read_layout(path)["version"] == 2
    assert len(v2) == 23 and fps[3] not in v2
    for fp, accel in expect.items():           # bitwise round trip
        np.testing.assert_array_equal(v2.get(fp).arrays["best_accel"],
                                      accel)
    again = ShardedMemoStore(path)             # reopen: no second split
    assert len(again) == 23
    shard_files = [f for f in os.listdir(path) if f.startswith("index-")]
    assert 0 < len(shard_files) <= NUM_SHARDS


def test_old_reader_gets_versioned_error(tmp_path):
    path = str(tmp_path / "memo")
    ShardedMemoStore(path).put(_rec("0abc0000"))
    with pytest.raises(MemoLayoutError,
                       match="v2.*repro_torch.fleet.*ShardedMemoStore"):
        MemoStore(path)


def test_sharded_rejects_memory_store_and_bad_layout(tmp_path):
    with pytest.raises(ValueError, match="directory path"):
        ShardedMemoStore("")
    path = str(tmp_path / "memo")
    os.makedirs(path)
    with open(os.path.join(path, "memo_layout.json"), "w") as f:
        f.write('{"version": 3, "shards": 2}')
    with pytest.raises(MemoLayoutError, match="version.*3"):
        ShardedMemoStore(path)


def test_shard_budget_split(tmp_path):
    st = ShardedMemoStore(str(tmp_path / "memo"),
                          byte_budget=NUM_SHARDS * 1024)
    assert all(s.byte_budget == 1024 for s in st._shards)
    st.put(_rec("0aa00000"))
    assert st.total_bytes > 0
    st.compact()                               # per-shard locks: no clash
    assert "0aa00000" in ShardedMemoStore(str(tmp_path / "memo"))


def _same_records(a, b, fps):
    assert len(a) == len(b) == len(fps)
    for fp in fps:
        ra, rb = a.get(fp), b.get(fp)
        assert tuple(ra.family) == tuple(rb.family) and ra.meta == rb.meta
        assert sorted(ra.arrays) == sorted(rb.arrays)
        for k in ra.arrays:
            assert ra.arrays[k].dtype == rb.arrays[k].dtype
            np.testing.assert_array_equal(ra.arrays[k], rb.arrays[k])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_v2_directories_cross_read(tmp_path, writer):
    """A v2 directory written by either package opens in the other with
    equal records (and a v1 directory the other package migrates)."""
    path = str(tmp_path / "memo")
    fps = _fps(20)
    if writer == "port":
        w = ShardedMemoStore(path)
        cls = MemoRecord
    else:
        w = ref_fleet.ShardedMemoStore(path)
        cls = RefRecord
    for fp in fps:
        w.put(_rec(fp, family=("fam", shard_of(fp) % 3), cls=cls))
    w.discard(fps[5])
    live = [fp for fp in fps if fp != fps[5]]
    _same_records(ShardedMemoStore(path), ref_fleet.ShardedMemoStore(path),
                  live)
    v1 = str(tmp_path / "v1")
    src = (MemoStore if writer == "port" else RefStore)(v1)
    for fp in live:
        src.put(_rec(fp, cls=cls))
    other = (ref_fleet.ShardedMemoStore if writer == "port"
             else ShardedMemoStore)(v1)        # the other package migrates
    _same_records(other, src, live)


# ---------------------------------------------------------------------------
# router + metrics over fake in-process worker handles, against the reference
# ---------------------------------------------------------------------------
class _FakeHandle:
    """Worker-handle stand-in: answers every chunk synchronously with
    per-uid sentinel rows, so routing / stealing is testable without
    subprocesses or devices."""

    def __init__(self, worker_id, inbox, enc):
        self.worker_id = worker_id
        self._inbox = inbox
        self._enc = enc
        self.outstanding = 0
        self.stats_snapshot = None
        self.scenarios = 0

    def send(self, msg):
        if msg["cmd"] == "run":
            rows = []
            for p in msg["requests"] + msg["prepared"]:
                self.scenarios += 1
                rows.append({
                    "uid": p["uid"], "best_fitness": float(p["uid"]),
                    "best_accel": self._enc(np.full(3, p["uid"], np.int32)),
                    "best_prio": self._enc(np.arange(3, dtype=np.int32)),
                    "history_best": self._enc(np.zeros(2)),
                    "n_samples": 8, "budget": BUDGET, "memo_exact": False,
                    "warm_seeded": False, "anytime_interim": False})
            self._inbox.put((self.worker_id,
                             {"ok": "done", "chunk": msg["chunk"],
                              "results": rows}))
        elif msg["cmd"] == "stats":
            self._inbox.put((self.worker_id, {"ok": "stats", "stats": {
                "scenarios": self.scenarios, "chunks": 1,
                "memo": {"exact_hits": self.scenarios // 2,
                         "foreign_hits": self.scenarios // 4}}}))


def _trace(cls, n, group_size=8, setting="S1", uid0=0, **kw):
    return [cls(uid=uid0 + i, arrival_s=0.0, mix="Light", setting=setting,
                bw_gb=4.0, group_size=group_size, seed=uid0 + i, **kw)
            for i in range(n)]


ROUTER_CASES = {
    "skewed": lambda cls: _trace(cls, 16),
    "two_signatures": lambda cls: (_trace(cls, 6, group_size=8)
                                   + _trace(cls, 6, group_size=10,
                                            uid0=100)),
    "classes": lambda cls: (_trace(cls, 7, priority="urgent",
                                   deadline_s=30.0)
                            + _trace(cls, 9, setting="S3", uid0=50,
                                     priority="batch")
                            + _trace(cls, 5, group_size=12, uid0=80)),
}


def _route(router_mod, request_cls, enc, case, steal, workers=2,
           chunk_rows=4):
    inbox = queue.Queue()
    handles = [_FakeHandle(f"w{i}", inbox, enc) for i in range(workers)]
    router = router_mod.FleetRouter(handles, inbox, chunk_rows=chunk_rows,
                                    max_outstanding=1, steal=steal,
                                    default_budget=BUDGET,
                                    stream={"batch_rows": 4})
    results = router.run(ROUTER_CASES[case](request_cls))
    m = router.last_metrics
    timed = ("wall_s", "scenarios_per_sec", "latency_p50_s",
             "latency_p99_s", "per_worker_rate")
    return ([(r.request.uid, r.worker_id, r.best_fitness) for r in results],
            router.steals, router.stolen_members,
            sorted((str(k), v) for k, v in router._home.items()),
            {k: v for k, v in m.summary().items() if k not in timed})


@pytest.mark.parametrize("steal", [True, False], ids=["steal", "static"])
@pytest.mark.parametrize("workers", [2, 3])
@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_equals_reference(case, workers, steal):
    mine = _route(port_router, ScenarioRequest, worker.encode_array, case,
                  steal, workers=workers)
    theirs = _route(ref_router, ref_stream.ScenarioRequest,
                    ref_worker.encode_array, case, steal, workers=workers)
    assert mine == theirs
    uids = [u for u, _, _ in mine[0]]
    assert uids == sorted(uids) and len(uids) == len(set(uids))
    if case == "skewed":
        assert (mine[1] >= 1) == steal         # one signature: steal or idle


def test_router_steal_rehomes_signature():
    inbox = queue.Queue()
    handles = [_FakeHandle(f"w{i}", inbox, worker.encode_array)
               for i in range(2)]
    router = FleetRouter(handles, inbox, chunk_rows=4, max_outstanding=1,
                         steal=True, default_budget=BUDGET,
                         stream={"batch_rows": 4})
    router.run(_trace(ScenarioRequest, 16))
    sig = router._signature(_trace(ScenarioRequest, 1)[0])
    assert router._home[sig] == 1              # arrivals follow the thief
    assert handles[1].scenarios > 0


@dataclasses.dataclass
class _Res:
    request: _Req
    arrival_s: float
    done_s: float

    @property
    def latency_s(self):
        return self.done_s - self.arrival_s

    @property
    def deadline_met(self):
        d = self.request.deadline_s
        return None if d is None else self.latency_s <= d


@pytest.mark.parametrize("seed", range(3))
def test_compute_fleet_metrics_equals_reference(seed):
    rng = np.random.default_rng(seed)
    results = [_Res(_Req(i, deadline_s=(None if rng.random() < 0.5
                                        else float(rng.uniform(0.1, 1)))),
                    0.0, float(rng.uniform(0.01, 1.5)))
               for i in range(int(rng.integers(5, 30)))]
    stats = {f"w{i}": {"chunks": int(rng.integers(1, 5)),
                       "scenarios": int(rng.integers(1, 20)),
                       "run_wall_s": float(rng.uniform(0.1, 2)),
                       "memo": {"exact_hits": int(rng.integers(0, 5)),
                                "foreign_hits": int(rng.integers(0, 3)),
                                "records": int(rng.integers(0, 9))},
                       "router_sent": int(rng.integers(0, 20))}
             for i in range(int(rng.integers(1, 5)))}
    kw = dict(steals=int(rng.integers(0, 4)), stolen_members=3,
              router_peak_depth=7)
    mine = compute_fleet_metrics(results, stats, 2.5, **kw)
    theirs = ref_fleet.compute_fleet_metrics(results, stats, 2.5, **kw)
    assert mine.summary() == theirs.summary()


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------
def json_roundtrip(d):
    import json
    return json.loads(json.dumps(d))


def types_row(res, uid):
    import types
    return types.SimpleNamespace(
        request=types.SimpleNamespace(uid=uid), budget=BUDGET,
        memo_exact=False, warm_seeded=False, anytime_interim=False,
        **{k: getattr(res, k) for k in ("best_fitness", "best_accel",
                                        "best_prio", "history_best",
                                        "n_samples")})


def test_codec_roundtrip_is_bitwise():
    arrays = [np.arange(7, dtype=np.int32), np.float32(0.1) * np.ones((2, 3)),
              np.array([np.nextafter(np.float32(1), np.float32(2))],
                       np.float32), np.linspace(0, 1, 5), np.zeros((0, 4))]
    for x in arrays:
        enc = worker.encode_array(x)
        assert enc == ref_worker.encode_array(x)     # the same wire bytes
        y = worker.decode_array(json_roundtrip(enc))
        assert y.dtype == np.asarray(x).dtype and y.shape == np.shape(x)
        np.testing.assert_array_equal(y, x)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 3
    assert worker.encode_array(t) == ref_worker.encode_array(t.numpy())

    fit = analyze_serial(generate_trace(TraceConfig(
        num_scenarios=1, group_size=8, seed=2, settings=("S2",))))[0].fit
    p = PreparedScenario(fit=fit, seed=5, uid=9, budget=BUDGET,
                         strategy=get_strategy("magma"), priority="urgent",
                         deadline_s=0.5)
    q = worker.decode_prepared(json_roundtrip(worker.encode_prepared(p)))
    for a, b in zip(fit.params, q.fit.params):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (q.seed, q.uid, q.budget, q.strategy, q.priority, q.deadline_s) \
        == (5, 9, BUDGET, "magma", "urgent", 0.5)
    assert (q.fit.num_accels, q.fit.group_size, q.fit.bw_sys,
            q.fit.objective_spec) == (fit.num_accels, fit.group_size,
                                      float(np.float32(fit.bw_sys)),
                                      fit.objective_spec)

    res = run_strategy(get_strategy("magma"), fit, budget=BUDGET, seed=5,
                       device="cpu")
    row = types_row(res, uid=9)
    d = json_roundtrip(worker.encode_result(row))
    assert d["best_fitness"] == res.best_fitness     # f32 -> f64 -> JSON
    for k in ("best_accel", "best_prio", "history_best"):
        got = worker.decode_array(d[k])
        assert got.dtype == np.asarray(getattr(res, k)).dtype
        np.testing.assert_array_equal(got, getattr(res, k))


# ---------------------------------------------------------------------------
# FleetConfig
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,exc,match", [
    (dict(num_workers=0), ValueError, "num_workers"),
    (dict(devices_per_worker=0), ValueError, "devices_per_worker"),
    (dict(chunk_rows=0), ValueError, "chunk_rows"),
    (dict(max_outstanding=0), ValueError, "max_outstanding"),
    (dict(device="tpu"), ValueError, "device"),
    (dict(obs={"trace_capacity": 0}), ValueError, "trace_capacity"),
])
def test_fleet_config_validation(kw, exc, match):
    with pytest.raises(exc, match=match):
        FleetConfig(**kw)
    assert FleetConfig().device == "cuda"          # the card by default
    assert FleetConfig(devices_per_worker=1).devices_per_worker == 1
    assert FleetConfig(devices_per_worker=2, distributed=True).distributed


def test_worker_device_groups():
    """Worker i's ``CUDA_VISIBLE_DEVICES`` and shard devices: one card
    round-robin, or a group of k cards wrapping round the visible list (a
    card named twice is visible once and sharded twice); k ``cpu``
    entries off a card."""
    from repro_torch.fleet.launch import worker_devices
    cards = ["0", "1", "2", "3"]
    assert worker_devices(1, None, cards) == ("1", None)
    assert worker_devices(5, None, cards) == ("1", None)
    assert worker_devices(1, 2, cards) == ("2,3", ["cuda:0", "cuda:1"])
    assert worker_devices(1, 3, cards) == ("3,0,1",
                                           ["cuda:0", "cuda:1", "cuda:2"])
    assert worker_devices(1, 2, ["0"]) == ("0", ["cuda:0", "cuda:0"])
    assert worker_devices(0, 2, []) == (None, ["cpu", "cpu"])
    assert worker_devices(0, None, []) == (None, None)


def test_worker_that_cannot_join_the_group_raises():
    """A worker whose peers never join fails its init within the
    timeout: the fleet never runs with a worker missing."""
    import torch.distributed as dist
    from repro_torch.fleet.launch import _free_port
    spec = {"init_method": f"tcp://127.0.0.1:{_free_port()}", "rank": 0,
            "world_size": 2, "timeout_s": 2.0}
    with pytest.raises(Exception):
        worker.join_group(spec, torch.device("cpu"))
    assert not dist.is_initialized()


def test_worker_without_a_card_raises_at_init(monkeypatch):
    """A "cuda" worker on a host without a card fails the fleet's
    startup: it never carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from repro_torch.kernels import _build
    # the parent's one build of the makespan kernel needs nvcc: skip it,
    # so that the worker itself must refuse
    monkeypatch.setattr(_build, "load", lambda name: None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_fleet(FleetConfig(num_workers=1, budget=BUDGET,
                                 **FLEET_TIMEOUTS))


@pytest.mark.parametrize("openers", [2, 4])
def test_concurrent_openers_of_a_fresh_directory(tmp_path, monkeypatch,
                                                 openers):
    """Every worker of a fleet opens the shared store at start-up, at the
    same time, on a directory that is still empty: each stamps the layout
    marker, and none may fail.  The openers are held at the marker's
    rename until all of them have written their temporary file, the
    interleaving under which a shared temporary name is already gone for
    all but the first."""
    import threading

    from repro_torch.fleet import shared_memo
    path = str(tmp_path / "memo")
    gate = threading.Barrier(openers, timeout=30)
    real_replace = os.replace

    def replace(src, dst):
        if os.path.basename(dst) == shared_memo.LAYOUT_MARKER:
            gate.wait()
        return real_replace(src, dst)

    monkeypatch.setattr(shared_memo.os, "replace", replace)
    errors = []

    def open_store():
        try:
            ShardedMemoStore(path)
        except BaseException as e:       # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=open_store) for _ in range(openers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    monkeypatch.undo()
    assert not errors, errors
    assert read_layout(path) == {"version": 2, "shards": NUM_SHARDS}
    assert not [n for n in os.listdir(path) if n.endswith(".tmp")]
    assert len(ShardedMemoStore(path)) == 0


# ---------------------------------------------------------------------------
# end to end: a real 2-worker CPU fleet (subprocess workers)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    """One fleet brought up once (startup dominates): a skewed trace
    routed twice — run 1 with stealing, run 2 steal-free so every
    scenario lands on its home worker and replays the shared memo — and
    the live fleet for the engine test."""
    memo = str(tmp_path_factory.mktemp("fleet") / "memo")
    trace = generate_trace(TraceConfig(
        num_scenarios=12, group_size=8, seed=5, settings=("S1", "S2"),
        mixes=("Light",), bw_ladder_gb=(1.0, 4.0)))
    cfg = FleetConfig(num_workers=2, budget=BUDGET,
                      stream={"batch_rows": 4}, memo_path=memo,
                      chunk_rows=4, device="cpu", recompile_guard=True,
                      **FLEET_TIMEOUTS)
    with launch_fleet(cfg) as fleet:
        fleet.warmup(trace[:2])
        fleet.mark_warm()
        r1 = fleet.run(trace)
        m1 = fleet.last_metrics
        r2 = fleet.run(trace, steal=False)
        m2 = fleet.last_metrics
        yield dict(trace=trace, memo=memo, r1=r1, m1=m1, r2=r2, m2=m2,
                   fleet=fleet, stats=fleet.worker_stats())


def test_fleet_covers_trace_and_steals(fleet_runs):
    trace, r1, m1 = fleet_runs["trace"], fleet_runs["r1"], fleet_runs["m1"]
    assert [r.request.uid for r in r1] == [t.uid for t in trace]
    assert m1.num_workers == 2 and m1.num_scenarios == len(trace)
    assert m1.steals >= 1 and m1.stolen_members >= 1
    assert all(n > 0 for n in m1.per_worker_scenarios)
    assert {r.worker_id for r in r1} == {"w0", "w1"}
    assert m1.scenarios_per_sec > 0 and m1.wall_s > 0
    assert 0 < m1.latency_p50_s <= m1.latency_p99_s


def test_fleet_rows_bitwise_standalone(fleet_runs):
    """THE fleet guarantee: whichever worker served a scenario (stolen or
    not), its schedule is the port's standalone row for (scenario,
    seed) on the same device type."""
    r1 = fleet_runs["r1"]
    assert not any(r.warm_seeded for r in r1)  # memo_near off: cold rows
    for r in r1:
        fit = analyze_serial([r.request])[0].fit
        ref = run_strategy(get_strategy("magma"), fit, budget=BUDGET,
                           seed=r.request.seed, device="cpu")
        assert r.best_fitness == ref.best_fitness
        np.testing.assert_array_equal(r.best_accel, ref.best_accel)
        np.testing.assert_array_equal(r.best_prio, ref.best_prio)
        np.testing.assert_array_equal(r.history_best, ref.history_best)
        sr = r.to_search_result()
        assert sr.best_fitness == ref.best_fitness
        np.testing.assert_array_equal(sr.history_samples,
                                      ref.history_samples)
        assert sr.n_samples == ref.n_samples


def test_fleet_rerun_replays_cross_worker_memo_hits(fleet_runs):
    r1, r2, m2 = fleet_runs["r1"], fleet_runs["r2"], fleet_runs["m2"]
    for a, b in zip(r1, r2):
        assert a.best_fitness == b.best_fitness
        np.testing.assert_array_equal(a.best_accel, b.best_accel)
        np.testing.assert_array_equal(a.history_best, b.history_best)
    assert m2.memo_exact_hits == len(r2) and all(r.memo_exact for r in r2)
    assert m2.memo_foreign_hits >= 1
    assert 0.0 < m2.cross_worker_hit_rate <= 1.0


def test_fleet_shared_store_and_worker_stats(fleet_runs):
    memo, r1 = fleet_runs["memo"], fleet_runs["r1"]
    assert read_layout(memo) == {"version": 2, "shards": NUM_SHARDS}
    store = ShardedMemoStore(memo)
    assert len(store) == len(r1)               # one record per scenario
    origins = {rec.meta["origin"]
               for s in store._shards for rec in s._records.values()}
    assert origins == {"w0", "w1"}
    with pytest.raises(MemoLayoutError):
        MemoStore(memo)
    stats = fleet_runs["stats"]
    assert sorted(stats) == ["w0", "w1"]
    for s in stats.values():
        # on the CPU the plain version runs: no kernel launch, no load
        assert s["makespan_launches"] == 0 and s["dispatched_generations"] > 0
        assert s["compiles"] == 0 and s["recompiles_post_warmup"] == 0
    assert sum(s["scenarios"] for s in stats.values()) == 2 * len(r1)


@pytest.mark.parametrize("kw", [dict(devices_per_worker=2),
                                dict(distributed=True)],
                         ids=["groups_of_2", "process_group"])
def test_fleet_device_groups_and_process_group_rows_bitwise(kw):
    """A 2-worker CPU fleet whose workers shard their batches over two
    devices each, and one whose workers join one gloo process group:
    every row is the standalone search's."""
    trace = generate_trace(TraceConfig(
        num_scenarios=8, group_size=8, seed=7, settings=("S1",),
        mixes=("Light",), bw_ladder_gb=(1.0, 4.0)))
    cfg = FleetConfig(num_workers=2, budget=BUDGET,
                      stream={"batch_rows": 4}, chunk_rows=4, device="cpu",
                      **kw, **FLEET_TIMEOUTS)
    with launch_fleet(cfg) as fleet:
        res = fleet.run(trace)
        stats = fleet.worker_stats()
    assert [r.request.uid for r in res] == [t.uid for t in trace]
    for r in res:
        fit = analyze_serial([r.request])[0].fit
        ref = run_strategy(get_strategy("magma"), fit, budget=BUDGET,
                           seed=r.request.seed, device="cpu")
        assert r.best_fitness == ref.best_fitness
        np.testing.assert_array_equal(r.best_accel, ref.best_accel)
        np.testing.assert_array_equal(r.history_best, ref.history_best)
    for i, w in enumerate(sorted(stats)):
        s = stats[w]
        if "devices_per_worker" in kw:
            assert s["shards"] == ["cpu", "cpu"] and s["group"] is None
        else:
            assert s["shards"] == ["cpu"]
            assert s["group"] == {"rank": i, "world_size": 2,
                                  "backend": "gloo"}


def test_engine_fleet_schedule_bitwise_in_process(fleet_runs):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve import engine

    def make(**kw):
        tenants = [engine.Tenant(a, get_smoke_config(a),
                                 get_model(get_smoke_config(a),
                                           device="meta"))
                   for a in ("falcon-mamba-7b", "zamba2-1.2b")]
        return engine.MultiTenantEngine(tenants, budget=BUDGET, seed=3,
                                        decode_window=4, device="cpu", **kw)

    reqs = [("falcon-mamba-7b", 16, 6), ("zamba2-1.2b", 12, 5)]
    via_fleet = make(fleet=fleet_runs["fleet"])
    local = make()
    a = via_fleet.schedule(via_fleet.jobs_for_requests(reqs))
    b = local.schedule(local.jobs_for_requests(reqs))
    assert a["stream"].worker_id in ("w0", "w1")
    assert not a["stream"].memo_exact
    for k in ("best_accel", "best_prio", "history_best", "history_samples"):
        np.testing.assert_array_equal(getattr(a["result"], k),
                                      getattr(b["result"], k))
    assert a["result"].best_fitness == b["result"].best_fitness
    assert a["queues"] == b["queues"] and a["makespan_s"] == b["makespan_s"]
    assert via_fleet._stream is None           # no in-process stream built
    local.close()


def test_engine_warmup_runs_each_bucket_of_its_job_group(fleet_runs):
    """``MultiTenantEngine.warmup``: through a fleet every worker
    dispatches each admission bucket of the job group's shape once, cold
    and warm-input (the workers hold a memo), recording nothing; in
    process the engine's own stream does the same, cold only.  On a card
    each of those first batches captures its generation step, so a
    schedule after the warmup captures nothing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.strategies import plan_generations
    from repro_torch.models.registry import get_model
    from repro_torch.serve import engine

    def make(**kw):
        tenants = [engine.Tenant(a, get_smoke_config(a),
                                 get_model(get_smoke_config(a),
                                           device="meta"))
                   for a in ("falcon-mamba-7b", "zamba2-1.2b")]
        return engine.MultiTenantEngine(tenants, budget=BUDGET, seed=3,
                                        decode_window=4, device="cpu", **kw)

    reqs = [("falcon-mamba-7b", 10, 3), ("zamba2-1.2b", 9, 4)]
    def buckets(batch_rows):                     # rows 1, 2, 4, ...
        return 1 + int(np.log2(batch_rows))

    gens = plan_generations(BUDGET, get_strategy("magma").ask_size)[0]
    fleet = fleet_runs["fleet"]
    records = len(ShardedMemoStore(fleet_runs["memo"]))
    before = fleet.worker_stats()
    via_fleet = make(fleet=fleet)
    via_fleet.warmup(via_fleet.jobs_for_requests(reqs))
    after = fleet.worker_stats()
    for w in ("w0", "w1"):
        assert (after[w]["dispatched_generations"]
                - before[w]["dispatched_generations"]) == 2 * buckets(4) * gens
        assert after[w]["scenarios"] == before[w]["scenarios"]
    assert len(ShardedMemoStore(fleet_runs["memo"])) == records
    assert via_fleet._stream is None
    local = make()
    local.warmup(local.jobs_for_requests(reqs))
    svc = local.stream_service()
    want = buckets(svc.stream.batch_rows) * gens
    assert svc.dispatched_generations == want
    local.warmup(local.jobs_for_requests(reqs), method="herald_like")
    assert svc.dispatched_generations == want      # host-only: nothing
    local.close()
