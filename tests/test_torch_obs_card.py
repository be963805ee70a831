"""The card's own timeline inside the port, on the CPU.

The timing events of ``repro_torch.core.strategies.cardtime`` exist only
on a card; here a fake event source stands in (each event takes the host
clock when recorded), so every path that records, settles and anchors
them runs.  Held here:

  - every always-on counter advances by one search, loop or batch per
    call (``repro_search_*``, ``repro_loop_*``, ``repro_stream_*``,
    ``repro_compile_seconds_total``), and nothing is counted without
    events;
  - the stream's batch records carry ``card_start_s <= card_end_s <=
    done_s``, and its device busy time is their union;
  - each of the benchmark's nine readers of these counters, on a
    hand-made registry, gives its value, and None without its counters;
  - with ``obs`` on, a search's span tree has ``search.prepare``,
    ``search.loop``, ``search.readback`` and ``search.card``, and a
    stream request has ``card_queue``;
  - under ``torch.profiler`` (CPU activity) the stages are CPU ranges
    named ``repro.<stage>``, not user annotations: ``repro.search.prepare``
    encloses the analysis' ops and lies within 50 us of its span; with no
    profiler active no range is made at all.
"""
import gc
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.m3e import M3E  # noqa: E402
from repro_torch.core.fitness import FitnessFn  # noqa: E402
from repro_torch.core.job_analyzer import JobAnalyzer  # noqa: E402
from repro_torch.core.strategies import cardtime  # noqa: E402
from repro_torch.core.sweep import SweepConfig, run_sweep  # noqa: E402
from repro_torch.costmodel import GB, get_setting  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import get_tracer, interval_union_s  # noqa: E402
from repro_torch.obs import profiler as obs_profiler  # noqa: E402
from repro_torch.obs import registry as obs_registry  # noqa: E402
from repro_torch.obs.profiler import stage  # noqa: E402
from repro_torch.stream import (StreamConfig, StreamingScheduler,  # noqa: E402
                                TraceConfig, generate_trace)
from repro_torch.workloads import build_task_groups  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUDGET = 200                       # MAGMA P=100: two generations
TRACE = TraceConfig(num_scenarios=6, group_size=12, settings=("S2",),
                    mixes=("Light",), bw_ladder_gb=(1.0, 16.0), seed=4)


class FakeEvent:
    """A timing event on the host's clock: done once recorded."""

    def __init__(self):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return self.t is not None

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def registry(monkeypatch):
    """A fresh process registry for the test."""
    reg = obs_registry.MetricsRegistry()
    monkeypatch.setattr(obs_registry, "_DEFAULT_REGISTRY", reg)
    return reg


@pytest.fixture
def events(monkeypatch):
    """Timing events on the CPU, from the fake source."""
    monkeypatch.setattr(cardtime, "_new_event", lambda device: FakeEvent())


def _totals(reg):
    return {name: sum(s["value"] for s in m["series"])
            for name, m in reg.snapshot().items() if m["kind"] == "counter"}


def _group(seed=0):
    return build_task_groups("Mix", group_size=12, seed=seed)[0]


def _m3e(**kw):
    return M3E(get_setting("S2"), bw_sys=16 * GB, device="cpu", **kw)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------
def test_a_search_counts_once_with_its_loop(registry, events):
    m3e = _m3e()
    for n in (1, 2):
        res = m3e.search(_group(n), budget=BUDGET, seed=n)
        t = _totals(registry)
        assert t["repro_search_total"] == n
        assert t["repro_loop_total"] == n
        assert t["repro_loop_generations_total"] == 2 * n
        assert t["repro_loop_graph_nodes_total"] == 0      # eager on the CPU
        assert 0 < res.card_time_s < res.wall_time_s
        assert t["repro_search_card_seconds_total"] == pytest.approx(
            t["repro_loop_card_seconds_total"])
        assert 0 < t["repro_search_prepare_seconds_total"] \
            < t["repro_search_seconds_total"]
        assert t["repro_search_card_seconds_total"] \
            < t["repro_search_seconds_total"]


def test_without_events_nothing_is_timed(registry):
    res = _m3e().search(_group(), budget=BUDGET, seed=1)
    assert res.card_time_s is None
    t = _totals(registry)
    assert t["repro_search_total"] == 1
    assert not any(k.startswith("repro_loop_") for k in t)
    assert "repro_search_card_seconds_total" not in t


@pytest.mark.parametrize("ndev", [1, 2])
def test_a_sweep_chunk_counts_one_loop_a_shard(registry, events, ndev):
    table = JobAnalyzer(get_setting("S2")).analyze(_group().jobs)
    fits = [FitnessFn(table, bw_sys=b * GB, device="cpu") for b in (1, 16)]
    res = run_sweep(fits, budget=BUDGET, seeds=[3, 4], device="cpu",
                    sweep=SweepConfig(chunk_rows=4,
                                      devices=("cpu",) * ndev))
    t = _totals(registry)
    assert res.num_chunks == 1
    assert t["repro_loop_total"] == ndev
    assert t["repro_loop_generations_total"] == 2 * ndev
    assert 0 < t["repro_loop_card_seconds_total"] < res.wall_time_s * ndev


def test_stream_batches_carry_card_intervals(registry, events):
    svc = StreamingScheduler(budget=BUDGET, device="cpu",
                             stream=StreamConfig(batch_rows=4))
    svc.run(generate_trace(TRACE))
    batches = svc.last_batches
    assert batches
    for b in batches:
        assert b.dispatch_s <= b.card_start_s <= b.card_end_s <= b.done_s
    t = _totals(registry)
    assert t["repro_stream_batches_total"] == len(batches)
    assert t["repro_loop_total"] == len(batches)
    assert t["repro_stream_batch_card_seconds_total"] == pytest.approx(
        sum(b.card_end_s - b.card_start_s for b in batches))
    assert t["repro_stream_route_lag_seconds_total"] == pytest.approx(
        sum(b.done_s - b.card_end_s for b in batches))
    busy = interval_union_s([(b.card_start_s, b.card_end_s)
                             for b in batches])
    m = svc.last_metrics
    assert m.device_busy_s == busy             # card time, not host windows
    assert t["repro_stream_card_busy_seconds_total"] == pytest.approx(busy)
    assert t["repro_stream_run_seconds_total"] == pytest.approx(m.wall_s)
    svc.run(generate_trace(TRACE))
    assert _totals(registry)["repro_stream_batches_total"] == \
        len(batches) + len(svc.last_batches)
    svc.close()


def test_stream_without_events_keeps_host_windows(registry):
    svc = StreamingScheduler(budget=BUDGET, device="cpu",
                             stream=StreamConfig(batch_rows=4))
    svc.run(generate_trace(TRACE))
    assert all(b.card_start_s is None for b in svc.last_batches)
    assert svc.last_metrics.device_busy_s == interval_union_s(
        [(b.dispatch_s, b.done_s) for b in svc.last_batches])
    t = _totals(registry)
    assert t["repro_stream_batches_total"] == len(svc.last_batches)
    assert "repro_stream_card_busy_seconds_total" not in t
    svc.close()


def test_compile_events_count_seconds_by_kind(registry):
    _build.notify_compile("cuda graph magma R=1 gens=2", 0.5)
    _build.notify_compile("cuda graph magma R=8 gens=2", 0.25)
    _build.notify_compile("makespan", 1.5)
    c = registry.counter("repro_compile_seconds_total")
    assert c.value(kind="graph") == 0.75 and c.value(kind="kernel") == 1.5


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------
HAND_MADE = {
    "repro_loop_total": 4, "repro_loop_card_seconds_total": 0.1,
    "repro_loop_generations_total": 400,
    "repro_loop_graph_nodes_total": 48000,
    "repro_search_total": 5, "repro_search_seconds_total": 0.15,
    "repro_search_prepare_seconds_total": 0.01,
    "repro_search_card_seconds_total": 0.125,
    "repro_stream_batches_total": 10,
    "repro_stream_batch_card_seconds_total": 0.4,
    "repro_stream_card_queue_seconds_total": 0.05,
    "repro_stream_route_lag_seconds_total": 0.02,
    "repro_stream_card_busy_seconds_total": 3.0,
    "repro_stream_run_seconds_total": 4.0,
}
READERS = {
    "loop_card_ms": (25.0, ["repro_loop_total"]),
    "graph_nodes_per_gen": (120.0, ["repro_loop_graph_nodes_total"]),
    "prepare_ms": (2.0, ["repro_search_prepare_seconds_total"]),
    "search_host_ms": (5.0, ["repro_search_card_seconds_total"]),
    "batch_card_ms": (40.0, ["repro_stream_batches_total"]),
    "card_queue_ms": (5.0, ["repro_stream_card_queue_seconds_total"]),
    "route_lag_ms": (2.0, ["repro_stream_route_lag_seconds_total"]),
    "card_idle_frac.stream": (0.25, ["repro_stream_run_seconds_total"]),
    "compile_s": (1.75, ["repro_compile_seconds_total"]),
}


def _reader(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from m3ebench.spec import Bench
    return Bench.load(ROOT).reader(name)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_hand_made_registry(registry, monkeypatch, name):
    want, needs = READERS[name]
    read = _reader(name)
    assert read(None) is None                    # nothing counted yet
    for k, v in HAND_MADE.items():
        registry.counter(k).inc(v)
    c = registry.counter("repro_compile_seconds_total")
    c.inc(1.5, kind="kernel")
    c.inc(0.25, kind="graph")
    assert read(None) == pytest.approx(want)
    fresh = obs_registry.MetricsRegistry()     # the same, less what it needs
    for k, v in HAND_MADE.items():
        if k not in needs:
            fresh.counter(k).inc(v)
    monkeypatch.setattr(obs_registry, "_DEFAULT_REGISTRY", fresh)
    assert read(None) is None


# ---------------------------------------------------------------------------
# spans, and the stages on the profiler's timeline
# ---------------------------------------------------------------------------
def _names_since(n):
    return [s.name for s in get_tracer().spans()[n:]]


def test_a_search_span_tree(events):
    n = len(get_tracer().spans())
    _m3e(obs={"enabled": True}).search(_group(), budget=BUDGET, seed=2)
    names = _names_since(n)
    assert names[:3] == ["search.prepare", "search.loop", "search.readback"]
    assert names[3:] == ["search.card"]
    card, back = get_tracer().spans()[-1], get_tracer().spans()[-2]
    assert card.end_s >= back.end_s - 1e-6
    n = len(get_tracer().spans())
    _m3e().search(_group(), budget=BUDGET, seed=2)           # obs off
    assert _names_since(n) == []


def test_a_stream_request_has_card_queue(events):
    svc = StreamingScheduler(budget=BUDGET, device="cpu", stream=StreamConfig(
        batch_rows=4, obs={"enabled": True}))
    trace = generate_trace(TRACE)
    svc.run(trace)
    by = {}
    for s in svc.tracer.spans():
        if s.scope is not None:
            by.setdefault(s.scope, {})[s.name] = s
    for r in trace:
        tree = by[r.uid]
        queue, device = tree["card_queue"], tree["device"]
        assert queue.start_s == tree["dispatch"].end_s
        assert queue.end_s == max(queue.start_s, device.start_s)
        assert device.end_s == tree["route"].start_s
    assert {"stream.run"} <= {s.name for s in svc.tracer.spans()
                              if s.scope is None}
    svc.close()


def _ops(prof, name):
    return [e for e in prof.events() if e.name == name]


def test_stages_are_cpu_ranges_on_the_profiler_timeline():
    from torch.profiler import ProfilerActivity, profile
    m3e = _m3e(obs={"enabled": True})
    group = _group(3)
    n = len(get_tracer().spans())
    gc.disable()                        # no collection between the pairs
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for name in ("first", "probe"):   # the first range starts late
                with stage(name, get_tracer()):
                    torch.ones(1)
            m3e.search(group, budget=BUDGET, seed=3)
    finally:
        gc.enable()
    spans = {s.name: s for s in get_tracer().spans()[n:]}
    (probe,) = _ops(prof, "repro.probe")
    (prep,) = _ops(prof, "repro.search.prepare")
    assert _ops(prof, "repro.search.loop") and \
        _ops(prof, "repro.search.readback")
    for e in (probe, prep):
        assert not e.is_user_annotation
    # the range on the span clock, through the probe's pair
    offset = spans["probe"].start_s - probe.time_range.start * 1e-6
    span = spans["search.prepare"]
    assert abs(prep.time_range.start * 1e-6 + offset - span.start_s) < 50e-6
    assert abs(prep.time_range.end * 1e-6 + offset - span.end_s) < 50e-6
    inside = [e for e in prof.events() if e.name.startswith("aten::")
              and prep.time_range.start <= e.time_range.start
              and e.time_range.end <= prep.time_range.end]
    assert inside                       # the tables are built inside it


def test_no_profiler_no_range(monkeypatch, events):
    made = []

    def counting(name):
        made.append(name)
        return None

    monkeypatch.setattr(obs_profiler, "_record_function", counting)
    _m3e().search(_group(), budget=BUDGET, seed=1)
    svc = StreamingScheduler(budget=BUDGET, device="cpu",
                             stream=StreamConfig(batch_rows=4))
    svc.run(generate_trace(TRACE))
    assert made == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _m3e().search(_group(), budget=BUDGET, seed=1)
        svc.run(generate_trace(TRACE))
    svc.close()
    assert {"repro.search.prepare", "repro.search.loop",
            "repro.search.readback", "repro.stream.run", "repro.admit",
            "repro.dispatch", "repro.route"} <= set(made)
