"""Port parity: ``repro_torch.obs`` and ``repro_torch.lint.runtime``.

The obs modules use the standard library and numpy only, so the port's
are copies and are held to the reference's outputs exactly: the tail
statistics, the metrics registry's Prometheus text and snapshot, the
Chrome trace of the reference's golden spans (``golden_obs_trace.json``,
read, never written), the JSONL round trip and the summaries, the flight
recorder's dumps, and ``ObsConfig``'s validation.  The transfer
sanitizer is held to its contract with the CUDA calls faked: it sets the
sync-debug mode to "error" for its scope and restores the previous mode,
and it does nothing when disabled or without a card.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import repro.obs as ref_obs  # noqa: E402
import repro.obs.__main__ as ref_cli  # noqa: E402
from repro.obs.registry import MetricsRegistry as RefRegistry  # noqa: E402
import repro_torch.obs.__main__ as obs_cli  # noqa: E402
from repro_torch.lint import runtime  # noqa: E402
from repro_torch.obs import (FlightRecorder, ObsConfig, Span,  # noqa: E402
                             as_obs_config, format_summary, interval_union_s,
                             p50_s, p99_s, quantile_s, read_trace, summarize,
                             to_chrome_trace, write_chrome_trace, write_jsonl)
from repro_torch.obs.registry import MetricsRegistry  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

# the reference's golden fixture (tests/test_obs.py::_FIXTURE_SPANS)
_FIXTURE = [
    ("analyze", 0.0, 0.5, 0, "main", {"mix": "Light"}),
    ("sweep.chunk", 0.125, 0.25, None, "main", {"chunk": 0}),
    ("device", 0.5, 1.25, 0, "w1", {}),
    ("route", 1.25, 1.5, 1, "w1", {}),
]


def _spans(cls, rows=_FIXTURE):
    return [cls(name, start, end, scope=scope, worker=worker,
                args=dict(args))
            for name, start, end, scope, worker, args in rows]


def _random_spans(seed, n=40):
    rng = np.random.default_rng(seed)
    names = ("analyze", "admit", "queue_wait", "dispatch", "device", "route",
             "memo.lookup", "sweep.chunk")
    rows = []
    for _ in range(n):
        start = float(rng.uniform(0, 2))
        rows.append((names[int(rng.integers(len(names)))], start,
                     start + float(rng.uniform(0, 0.5)),
                     None if rng.random() < 0.2 else int(rng.integers(6)),
                     ("main", "w1", "w2")[int(rng.integers(3))],
                     {"rows": int(rng.integers(1, 9))}))
    return rows


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_tail_statistics_equal_reference(seed):
    rng = np.random.default_rng(seed)
    xs = rng.exponential(0.1, int(rng.integers(1, 130)))
    for q in (50, 90, 99):
        assert quantile_s(xs, q) == ref_obs.quantile_s(xs, q)
    assert p50_s(xs) == ref_obs.p50_s(xs)
    assert p99_s(xs) == ref_obs.p99_s(xs)
    starts = rng.uniform(0, 5, 20)
    iv = list(zip(starts, starts + rng.uniform(0, 1, 20)))
    assert interval_union_s(iv) == ref_obs.interval_union_s(iv)
    assert p99_s([]) == ref_obs.p99_s([]) == 0.0
    assert interval_union_s([]) == 0.0


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def _fill(reg):
    c = reg.counter("repro_stream_scenarios_total", "Scenarios routed")
    c.inc(3)
    c.inc(2)
    hits = reg.counter("repro_stream_memo_hits_total", "Memo wins by kind")
    hits.inc(4, kind="exact")
    hits.inc(1, kind="warm")
    g = reg.gauge("repro_stream_device_idle_fraction", "Idle share")
    g.set(0.25)
    g.set(0.125, worker="w1")
    h = reg.histogram("repro_stream_latency_seconds", "Latency")
    for v in (0.001, 0.02, 0.3, 4.0, 0.02):
        h.observe(v)
    h.observe(0.5, priority="urgent")
    return reg


def test_registry_prometheus_text_and_snapshot_equal_reference():
    port, ref = _fill(MetricsRegistry()), _fill(RefRegistry())
    assert port.prometheus_text() == ref.prometheus_text()
    assert port.snapshot() == ref.snapshot()
    assert port.json(sort_keys=True) == ref.json(sort_keys=True)
    port.reset()
    assert port.prometheus_text() == RefRegistry().prometheus_text()


def test_registry_rejects_a_kind_change_like_reference():
    messages = []
    for reg in (MetricsRegistry(), RefRegistry()):
        reg.counter("x_total")
        with pytest.raises(TypeError) as err:
            reg.gauge("x_total")
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------
def test_chrome_trace_golden_file():
    doc = to_chrome_trace(_spans(Span), meta={"service": "test"})
    with open(os.path.join(HERE, "golden_obs_trace.json")) as f:
        golden = json.load(f)
    assert doc == golden


@pytest.mark.parametrize("seed", range(3))
def test_chrome_trace_and_summary_equal_reference(seed):
    rows = _random_spans(seed)
    port, ref = _spans(Span, rows), _spans(ref_obs.Span, rows)
    assert to_chrome_trace(port, meta={"k": seed}) == \
        ref_obs.to_chrome_trace(ref, meta={"k": seed})
    assert summarize(port) == ref_obs.summarize(ref)
    assert format_summary(summarize(port)) == \
        ref_obs.format_summary(ref_obs.summarize(ref))


def test_files_round_trip_and_cli(tmp_path, capsys):
    spans = _spans(Span)
    cpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "t.jsonl")
    write_chrome_trace(cpath, spans, meta={"k": "v"})
    write_jsonl(jpath, spans)
    ref_c, ref_j = str(tmp_path / "r.json"), str(tmp_path / "r.jsonl")
    ref_obs.write_chrome_trace(ref_c, _spans(ref_obs.Span), meta={"k": "v"})
    ref_obs.write_jsonl(ref_j, _spans(ref_obs.Span))
    for mine, theirs in ((cpath, ref_c), (jpath, ref_j)):
        with open(mine) as a, open(theirs) as b:
            assert a.read() == b.read()
        back = read_trace(mine)
        assert [(s.name, s.scope, s.worker, s.args or {}) for s in back] \
            == [(s.name, s.scope, s.worker, s.args) for s in spans]
    summ = summarize(read_trace(jpath))
    assert summ["span_count"] == 4 and summ["scenarios"] == 2
    assert summ["end_to_end_p99_ms"] == pytest.approx(1250.0)
    assert obs_cli.main([jpath]) == 0
    mine = capsys.readouterr().out
    assert ref_cli.main([jpath]) == 0
    assert mine == capsys.readouterr().out and "critical path" in mine
    assert obs_cli.main(["--json", cpath]) == 0
    assert json.loads(capsys.readouterr().out)["span_count"] == 4


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def _payload(recorder):
    with open(recorder.dumps[-1]) as f:
        payload = json.load(f)
    return payload


def test_flight_dumps_equal_reference(tmp_path):
    ticks = iter(np.arange(100) * 0.5)
    ref_ticks = iter(np.arange(100) * 0.5)
    port = FlightRecorder(max_events=3, dump_dir=str(tmp_path / "p"),
                          clock=lambda: float(next(ticks)))
    ref = ref_obs.FlightRecorder(max_events=3, dump_dir=str(tmp_path / "r"),
                                 clock=lambda: float(next(ref_ticks)))
    for fr in (port, ref):
        for i in range(5):
            fr.note("e", i=i)
        fr.note("dispatch", worker="w1", rows=4)
        with pytest.raises(RuntimeError):
            with fr.capture("unit"):
                raise RuntimeError("boom")
        fr.on_deadline_miss(7, 0.5, 0.25)
    assert port.snapshot() == ref.snapshot()
    assert [e["i"] for e in port.snapshot()["main"][:1]] == [4]
    assert len(port.dumps) == len(ref.dumps) == 2
    mine, theirs = _payload(port), _payload(ref)
    for key in ("reason", "context", "events"):
        assert mine[key] == theirs[key]
    assert mine["reason"] == "deadline_miss"


def test_flight_guard_hook_dumps_post_warmup_compiles(tmp_path):
    class Guard:
        def add_listener(self, fn):
            self.fn = fn

    fr = FlightRecorder(dump_dir=str(tmp_path))
    guard = Guard()
    fr.attach_guard(guard)
    guard.fn("warm", False)
    assert fr.dumps == []
    guard.fn("late", True)
    assert _payload(fr)["reason"] == "post_warmup_recompile"
    assert _payload(fr)["context"]["executable"] == "late"


# ---------------------------------------------------------------------------
# ObsConfig
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [
    dict(trace_capacity=0), dict(flight_events=0), dict(no_such_field=1)])
def test_obs_config_validation_equal_reference(bad):
    with pytest.raises(Exception) as mine:
        as_obs_config(bad)
    with pytest.raises(Exception) as theirs:
        ref_obs.as_obs_config(bad)
    assert type(mine.value) is type(theirs.value)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(TypeError):
        as_obs_config(3)
    assert as_obs_config(None) == ObsConfig()
    cfg = ObsConfig(enabled=True, worker="w3")
    assert as_obs_config(cfg) is cfg
    assert as_obs_config({"enabled": True, "worker": "w3"}) == cfg
    assert ref_obs.as_obs_config({"enabled": True}).enabled


# ---------------------------------------------------------------------------
# transfer sanitizer
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_cuda(monkeypatch):
    """A card, as far as the sanitizer can tell: its mode calls recorded."""
    state = {"mode": 0, "calls": []}

    def set_mode(mode):
        state["calls"].append(mode)
        state["mode"] = mode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: state["mode"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    return state


def test_transfer_sanitizer_sets_and_restores_the_mode(fake_cuda):
    fake_cuda["mode"] = 1
    with runtime.transfer_sanitizer():
        assert fake_cuda["mode"] == "error"
    assert fake_cuda["mode"] == 1
    with pytest.raises(ValueError):
        with runtime.transfer_sanitizer(True):
            raise ValueError("inside")
    assert fake_cuda["mode"] == 1
    assert fake_cuda["calls"] == ["error", 1, "error", 1]
    with runtime.transfer_sanitizer(False):
        pass
    assert fake_cuda["calls"] == ["error", 1, "error", 1]


def test_transfer_sanitizer_is_a_no_op_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(mode):
        raise AssertionError("no card: the mode must not be touched")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    with runtime.transfer_sanitizer(True):
        x = torch.ones(3).sum().item()
    assert x == 3.0
