"""Port parity: the streaming scheduling service, ``repro_torch.stream``.

Against the reference on the same inputs (exact):

  - ``generate_trace`` field by field (poisson, bursty and batch traces,
    priorities, ``slo_by_class``, ``flexible``, ``batch_scale_max``), and
    the configs' validation;
  - ``AnalysisPool.analyze``'s tables, bitwise;
  - ``AdmissionQueues``' decisions and counters over scripted pushes at
    injected clocks;
  - ``compute_metrics``' ``summary()`` on the same synthetic results.

The port's own guarantees, on the CPU (the counterparts of
``tests/test_stream.py``): every streamed row is bitwise the port's
``run_strategy`` and its ``run_sweep`` row, with padding and several
compatibility keys; prepared scenarios, strategy overrides, SLO ordering,
the urgent flush, anytime rows, the memo's disjoint counters and the
span trees with observability on.

The whole slice against the reference: one trace through both services'
``run_serial`` gives the same requests and the same batches; the
packages draw from different random streams, so the best-fitness
geomean is held within ``RATIO_TOL`` (measured by running this file as a
script: ``PYTHONPATH=src JAX_PLATFORMS=cpu python
tests/test_torch_stream.py``).

The serving engine as a stream client: MAGMA schedules bitwise a direct
``run_strategy``, ``out["stream"]`` is the ``StreamResult``, ``memo=``
replays a re-seen job group with no dispatch, ``schedule_front`` gives
the same front as a direct search, ``close()`` shuts only a stream the
engine built, and the executed tokens are those of the direct schedule.
"""
import collections
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import repro.stream as ref_stream  # noqa: E402
from repro.stream import admission as ref_admission  # noqa: E402
from repro.stream import analysis as ref_analysis  # noqa: E402
from repro_torch.core.m3e import geomean  # noqa: E402
from repro_torch.core.pareto import pareto_front  # noqa: E402
from repro_torch.core.strategies import get_strategy, run_strategy  # noqa: E402
from repro_torch.core.sweep import run_sweep  # noqa: E402
from repro_torch.memo import ScheduleMemo  # noqa: E402
from repro_torch.stream import (AnalysisPool, PRIORITY_CLASSES,  # noqa: E402
                                PreparedScenario, ScenarioRequest,
                                StreamConfig, StreamResult,
                                StreamingScheduler, TraceConfig,
                                analyze_serial, compute_metrics,
                                generate_trace)
from repro_torch.stream import admission, analysis  # noqa: E402

BUDGET = 300
QUICK = dict(group_size=12, bw_ladder_gb=(1.0, 16.0), settings=("S1", "S2"),
             mixes=("Heavy", "Light"))
STAGES = ("analyze", "admit", "queue_wait", "dispatch", "device", "route")
# the whole-slice trace (the reference's tests/test_stream.py fixture)
SLICE = dict(num_scenarios=8, seed=3, **QUICK)
# best-fitness geomean, port over reference, on the SLICE trace at BUDGET:
# 0.9718-1.0124 over trace seeds 0-9 (seed 3: 1.0124), measured on the CPU
# by running this file as a script; the limit is ~1.8x the widest
RATIO_TOL = 0.05


def _svc(**kw):
    return StreamingScheduler(budget=kw.pop("budget", BUDGET),
                              device="cpu", **kw)


def _assert_rows_equal(got, want):
    assert got.best_fitness == want.best_fitness
    np.testing.assert_array_equal(got.best_accel, want.best_accel)
    np.testing.assert_array_equal(got.best_prio, want.best_prio)
    np.testing.assert_array_equal(got.history_best, want.history_best)


def _standalone(fit, seed, budget=BUDGET, strategy="magma"):
    return run_strategy(get_strategy(strategy), fit, budget=budget,
                        seed=seed, device="cpu")


# ---------------------------------------------------------------------------
# exact parity with the reference
# ---------------------------------------------------------------------------
TRACES = [
    dict(num_scenarios=24, arrival="poisson", rate_hz=16.0, seed=1, **QUICK),
    dict(num_scenarios=24, arrival="bursty", rate_hz=4.0, burst_size=3.0,
         seed=2, **QUICK),
    dict(num_scenarios=12, arrival="batch", seed=3, **QUICK),
    dict(num_scenarios=20, arrival="poisson", seed=9,
         priorities=("urgent", "batch", "batch"),
         slo_by_class=(("urgent", 0.2), ("normal", 1.0)),
         batch_scale_max=4, **QUICK),
    dict(num_scenarios=16, arrival="bursty", seed=5, flexible=True,
         objectives=("throughput", "latency", "edp"),
         priorities=("urgent", "normal", "batch"),
         slo_by_class=(("batch", 3.0),), batch_scale_max=2),
    dict(),
]


@pytest.mark.parametrize("cfg", TRACES, ids=range(len(TRACES)))
def test_trace_equals_reference(cfg):
    mine = generate_trace(TraceConfig(**cfg))
    theirs = ref_stream.generate_trace(ref_stream.TraceConfig(**cfg))
    assert [dataclasses.asdict(r) for r in mine] == \
        [dataclasses.asdict(r) for r in theirs]
    assert mine == generate_trace(TraceConfig(**cfg))


BAD_CONFIGS = [
    ("trace", dict(arrival="lumpy")), ("trace", dict(num_scenarios=0)),
    ("trace", dict(rate_hz=0.0)), ("trace", dict(batch_scale_max=0)),
    ("trace", dict(priorities=())), ("trace", dict(priorities=("gold",))),
    ("trace", dict(slo_by_class=(("gold", 1.0),))),
    ("trace", dict(slo_by_class=(("urgent", 0.0),))),
    ("stream", dict(batch_rows=0)), ("stream", dict(analysis_workers=0)),
    ("stream", dict(max_inflight=0)), ("stream", dict(max_devices=0)),
    ("stream", dict(max_hold_s=-1.0)), ("stream", dict(slo_margin_s=-0.1)),
    ("stream", dict(anytime_budget=0)),
    ("stream", dict(anytime_budget=100, slo_aware=False)),
    ("stream", dict(obs={"trace_capacity": 0})), ("stream", dict(obs=3)),
    ("request", dict(priority="gold")), ("request", dict(deadline_s=-1.0)),
    ("request", dict(objective="no_such_objective")),
    ("mix", dict(mixes=("NoSuchMix",))),
]


def _build(mod, kind, kw):
    if kind == "trace":
        return mod.TraceConfig(**kw)
    if kind == "stream":
        return mod.StreamConfig(**kw)
    if kind == "mix":
        return mod.generate_trace(mod.TraceConfig(**kw))
    return mod.ScenarioRequest(**dict(
        dict(uid=0, arrival_s=0.0, mix="Light", setting="S2", bw_gb=1.0,
             group_size=8, seed=0), **kw))


@pytest.mark.parametrize("kind,kw", BAD_CONFIGS,
                         ids=[f"{k}-{next(iter(kw))}" for k, kw in
                              BAD_CONFIGS])
def test_config_validation_equal_reference(kind, kw):
    import repro_torch.stream as port_stream
    with pytest.raises(Exception) as mine:
        _build(port_stream, kind, kw)
    with pytest.raises(Exception) as theirs:
        _build(ref_stream, kind, kw)
    assert type(mine.value) is type(theirs.value)
    if kind in ("trace", "stream"):
        assert str(mine.value) == str(theirs.value)


def test_analysis_tables_bitwise_reference():
    reqs = generate_trace(TraceConfig(num_scenarios=6, seed=2,
                                      batch_scale_max=3, **QUICK))
    reqs.append(dataclasses.replace(reqs[0], uid=99, flexible=True,
                                    group_size=6))
    with AnalysisPool(workers=2) as pool:
        mine = [f.result() for f in [pool.submit(r) for r in reqs]]
    theirs = ref_stream.analyze_serial(reqs)
    for a, b in zip(mine, theirs):
        assert a.request == reqs[mine.index(a)]
        assert a.fit.device.type == "cpu"
        for name in ("lat", "bw", "energy", "flops"):
            got, want = getattr(a.fit.table, name), getattr(b.fit.table, name)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert a.fit.bw_sys == b.fit.bw_sys
        assert a.fit.objective_spec.token == b.fit.objective_spec.token
    serial = analyze_serial(reqs)
    for a, b in zip(mine, serial):
        assert torch.equal(a.fit.params.lat, b.fit.params.lat)


def test_scale_jobs_equals_reference():
    from repro.workloads import build_task_groups as ref_groups
    from repro_torch.workloads import build_task_groups
    jobs = build_task_groups("HeavyLight", group_size=10, seed=4)[0].jobs
    ref_jobs = ref_groups("HeavyLight", group_size=10, seed=4)[0].jobs
    for scale in (1, 3):
        got = analysis.scale_jobs(jobs, scale)
        want = ref_analysis.scale_jobs(ref_jobs, scale)
        assert [dataclasses.asdict(j.layer) for j in got] == \
            [dataclasses.asdict(j.layer) for j in want]


def _admission_script(mod, seed):
    """Pushes, selects, takes and steals drawn from ``seed`` at injected
    clocks; returns every decision and the counters after each step."""
    rng = np.random.default_rng(seed)
    q = mod.AdmissionQueues(batch_rows=3, slo_aware=seed % 3 != 2,
                            max_hold_s=0.2, slo_margin_s=0.05)
    log, now, uid = [], 0.0, 0
    for _ in range(80):
        now += float(rng.uniform(0.0, 0.08))
        op = rng.random()
        if op < 0.55:
            key = ("key", int(rng.integers(3)))
            deadline = (None if rng.random() < 0.4
                        else float(rng.uniform(0.02, 1.0)))
            member = types.SimpleNamespace(
                request=types.SimpleNamespace(
                    uid=uid, priority=PRIORITY_CLASSES[int(rng.integers(3))],
                    deadline_s=deadline, arrival_s=now),
                ready_s=now, silent=bool(rng.random() < 0.1))
            uid += 1
            q.push(key, member)
            log.append(("push", key))
        elif op < 0.9:
            key = q.select(now, bool(rng.random() < 0.5))
            taken = (None if key is None
                     else [m.request.uid for m in q.take(key)])
            log.append(("select", key, taken))
        else:
            stolen = q.steal(int(rng.integers(1, 6)), now)
            log.append(("steal", [(k, [m.request.uid for m in ms])
                                  for k, ms in stolen]))
        q.check()
        log.append((q.enqueued, q.dispatched, q.stolen, q.depth,
                    q.peak_depth, q.early_flushes, len(q), bool(q),
                    sorted(q.keys())))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_admission_decisions_equal_reference(seed):
    assert _admission_script(admission, seed) == \
        _admission_script(ref_admission, seed)


def _fake_results(seed):
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(int(rng.integers(1, 30))):
        prio = PRIORITY_CLASSES[int(rng.integers(3))]
        t0 = float(rng.uniform(0, 1))
        ready = t0 + float(rng.uniform(0, 0.2))
        out.append(types.SimpleNamespace(
            request=types.SimpleNamespace(
                uid=uid, priority=prio,
                deadline_s=None if rng.random() < 0.5
                else float(rng.uniform(0.1, 1.0))),
            latency_s=float(rng.exponential(0.4)),
            analysis_start_s=t0, ready_s=ready if rng.random() < 0.8 else t0,
            memo_exact=bool(rng.random() < 0.2),
            warm_seeded=bool(rng.random() < 0.3),
            anytime_interim=bool(rng.random() < 0.1)))
    batches = []
    for _ in range(int(rng.integers(0, 8))):
        d = float(rng.uniform(0, 2))
        rows = int(rng.integers(1, 9))
        batches.append(types.SimpleNamespace(
            dispatch_s=d, done_s=d + float(rng.uniform(0, 0.5)), rows=rows,
            padded_rows=int(2 ** np.ceil(np.log2(rows)))))
    return out, batches


@pytest.mark.parametrize("seed", range(4))
def test_compute_metrics_summary_equals_reference(seed):
    results, batches = _fake_results(seed)
    queues = []
    for mod in (admission, ref_admission):
        q = mod.AdmissionQueues(batch_rows=2)
        for r in results[:5]:
            q.push("k", types.SimpleNamespace(request=types.SimpleNamespace(
                uid=r.request.uid, arrival_s=0.0), ready_s=0.0))
        q.take("k")
        queues.append(q)
    for admit in ((None, None), tuple(queues)):
        mine = compute_metrics(results, batches, wall_s=2.5, refinements=2,
                               admission=admit[0])
        theirs = ref_stream.compute_metrics(results, batches, wall_s=2.5,
                                            refinements=2,
                                            admission=admit[1])
        assert mine.summary() == theirs.summary()


# ---------------------------------------------------------------------------
# the pipeline: bitwise rows and metrics
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def streamed():
    trace = generate_trace(TraceConfig(**SLICE))
    svc = _svc(stream=StreamConfig(batch_rows=4, analysis_workers=2))
    results = svc.run(trace)
    return trace, svc, results


def test_stream_results_cover_trace(streamed):
    trace, _, results = streamed
    assert [r.request.uid for r in results] == [t.uid for t in trace]
    for r in results:
        assert np.isfinite(r.best_fitness)
        assert r.ready_s >= r.analysis_start_s
        assert r.done_s >= r.dispatch_s >= 0
        assert r.latency_s > 0


def test_streamed_rows_bitwise_run_strategy_and_run_sweep(streamed):
    _, _, results = streamed
    for r in results:
        fit = analyze_serial([r.request])[0].fit
        _assert_rows_equal(r, _standalone(fit, r.request.seed))
        sw = run_sweep([fit], budget=BUDGET, seeds=[r.request.seed],
                       device="cpu")
        assert r.best_fitness == sw.best_fitness[0, 0]
        np.testing.assert_array_equal(r.best_accel, sw.best_accel[0, 0])
        np.testing.assert_array_equal(r.history_best, sw.history_best[0, 0])


def test_stream_metrics_and_accounting(streamed):
    _, svc, results = streamed
    m = svc.last_metrics
    assert m.num_scenarios == len(results)
    assert 0 < m.latency_p50_s <= m.latency_p99_s
    assert 0.0 <= m.device_idle_frac <= 1.0
    assert m.device_busy_s <= m.wall_s + 1e-9
    assert m.num_batches >= 2 and 0 < m.mean_batch_fill <= 1.0
    for b in svc.last_batches:
        assert b.dispatch_s <= b.issued_s <= b.done_s
        assert b.num_devices == 1
    aq = svc.last_admission
    aq.check()
    assert aq.enqueued == aq.dispatched == len(results)
    assert aq.stolen == 0 and aq.depth == 0
    assert m.queue_peak_depth == aq.peak_depth > 0
    assert m.early_flushes == aq.early_flushes


def test_padding_and_compat_keys_keep_rows_bitwise():
    """Three G=8 rows share a batch padded to the bucket of 4 (the last row
    repeated); a G=10 row takes a batch of its own; S1 and S2 (both four
    sub-accelerators) share a key: the tables are row data."""
    reqs = [ScenarioRequest(uid=0, arrival_s=0.0, mix="Light", setting="S1",
                            bw_gb=4.0, group_size=8, seed=1),
            ScenarioRequest(uid=1, arrival_s=0.0, mix="Light", setting="S2",
                            bw_gb=4.0, group_size=8, seed=2),
            ScenarioRequest(uid=2, arrival_s=0.0, mix="Heavy", setting="S1",
                            bw_gb=1.0, group_size=8, seed=3),
            ScenarioRequest(uid=3, arrival_s=0.0, mix="Light", setting="S1",
                            bw_gb=4.0, group_size=10, seed=4)]
    svc = _svc(stream=StreamConfig(batch_rows=4))
    results = svc.run_serial(reqs)
    shapes = sorted((b.compat_key.group_size, b.rows, b.padded_rows)
                    for b in svc.last_batches)
    assert shapes == [(8, 3, 4), (10, 1, 1)]
    for r in results:
        fit = analyze_serial([r.request])[0].fit
        _assert_rows_equal(r, _standalone(fit, r.request.seed))
    piped = _svc(stream=StreamConfig(batch_rows=4)).run(reqs)
    for a, b in zip(piped, results):
        _assert_rows_equal(a, b)


class _FakeEvent:
    """A batch's end event as the run loop sees it on a card."""

    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        pass


@pytest.mark.parametrize("done", [True, False], ids=["done", "pending"])
def test_finished_head_is_routed_before_the_next_dispatch(done, monkeypatch):
    """A head batch whose end event reports done is routed before the next
    batch is issued; one still pending is routed blocking at
    ``max_inflight`` (the reference's order).  Rows stay bitwise and the
    admission counters balance either way."""
    trace = generate_trace(TraceConfig(
        num_scenarios=8, seed=4, group_size=8, settings=("S1",),
        mixes=("Light",), bw_ladder_gb=(4.0,)))
    prepared = [PreparedScenario(fit=r.fit, seed=r.request.seed,
                                 uid=r.request.uid)
                for r in analyze_serial(trace)]
    cfg = StreamConfig(batch_rows=2, max_inflight=2)
    svc = _svc(stream=cfg)
    order = []
    dispatch, route = svc._dispatch, svc._route

    def fake_dispatch(key, members):
        inf = dispatch(key, members)
        order.append(("dispatch", inf.members[0].request.uid))
        inf.done = _FakeEvent(done)
        return inf

    def spy_route(inf, results):
        order.append(("route", inf.members[0].request.uid))
        route(inf, results)

    monkeypatch.setattr(svc, "_dispatch", fake_dispatch)
    monkeypatch.setattr(svc, "_route", spy_route)
    results = svc.run(prepared=prepared)
    heads = [uid for kind, uid in order if kind == "dispatch"]
    assert len(heads) == 4
    for a, b in zip(heads, heads[1:]):
        routed = order.index(("route", a))
        issued = order.index(("dispatch", b))
        assert (routed < issued) if done else (routed > issued)
    for a, b in zip(results, _svc(stream=cfg).run(prepared=prepared)):
        _assert_rows_equal(a, b)
    aq = svc.last_admission
    aq.check()
    assert aq.enqueued == aq.dispatched == len(results) == 8
    assert aq.stolen == 0 and aq.depth == 0


def test_run_serial_warmup_and_shared_cache_keep_rows(streamed):
    trace, _, results = streamed
    svc = _svc(stream=StreamConfig(batch_rows=4))
    svc.warmup(trace)
    assert svc.last_batches == []
    for shared in (False, True):
        for a, b in zip(svc.run_serial(trace, shared_cache=shared), results):
            _assert_rows_equal(a, b)
    assert svc.last_metrics.num_scenarios == len(trace)


def test_prepared_scenarios_and_strategy_override():
    fit = analyze_serial(generate_trace(
        TraceConfig(num_scenarios=1, seed=4, **QUICK)))[0].fit
    svc = _svc()
    for name in ("magma", "stdga"):
        res = svc.schedule_prepared(fit, seed=7, strategy=name)
        ref = _standalone(fit, 7, strategy=name)
        _assert_rows_equal(res, ref)
        sr = res.to_search_result()
        np.testing.assert_array_equal(sr.history_samples,
                                      ref.history_samples)
        np.testing.assert_array_equal(sr.history_best, ref.history_best)
        assert sr.n_samples == ref.n_samples


def test_host_only_strategy_and_several_cards_rejected():
    with pytest.raises(ValueError, match="host-only"):
        _svc(strategy="herald_like")
    fit = analyze_serial(generate_trace(
        TraceConfig(num_scenarios=1, seed=0, **QUICK)))[0].fit
    with pytest.raises(ValueError, match="host-only"):
        _svc().schedule_prepared(fit, strategy="cmaes")
    with pytest.raises(NotImplementedError, match="item 12"):
        _svc(stream=StreamConfig(max_devices=2))
    with pytest.raises(ValueError, match="memo"):
        _svc(stream=StreamConfig(anytime_budget=100))


def test_realtime_replay_orders_arrivals():
    trace = generate_trace(TraceConfig(num_scenarios=4, rate_hz=200.0,
                                       seed=6, **QUICK))
    svc = _svc(stream=StreamConfig(batch_rows=2, realtime=True))
    results = svc.run(trace)
    assert len(results) == 4
    for r, t in zip(results, trace):
        assert r.arrival_s == t.arrival_s       # trace offsets preserved
        assert r.done_s >= t.arrival_s


# ---------------------------------------------------------------------------
# SLO-aware admission, anytime rows, the memo
# ---------------------------------------------------------------------------
def _slo_req(uid, bw=16.0, mix="Light", group_size=12, seed=5,
             priority="normal", deadline_s=None):
    return ScenarioRequest(uid=uid, arrival_s=0.0, mix=mix, setting="S2",
                           bw_gb=bw, group_size=group_size, seed=seed,
                           priority=priority, deadline_s=deadline_s)


def test_deadline_ordered_dispatch():
    fits = [analyze_serial([_slo_req(i, bw=bw, seed=20 + i)])[0].fit
            for i, bw in enumerate((1.0, 4.0, 8.0, 16.0))]
    prepared = [
        PreparedScenario(fit=fits[0], seed=20, uid=0, priority="batch"),
        PreparedScenario(fit=fits[1], seed=21, uid=1, priority="normal"),
        PreparedScenario(fit=fits[2], seed=22, uid=2, priority="urgent",
                         deadline_s=10.0),
        PreparedScenario(fit=fits[3], seed=23, uid=3, priority="urgent",
                         deadline_s=5.0)]
    svc = _svc(stream=StreamConfig(batch_rows=2))
    results = svc.run(prepared=prepared)
    r = {res.request.uid: res for res in results}
    assert sorted(r) == [0, 1, 2, 3]
    assert all(b.rows == 2 for b in svc.last_batches)
    assert max(r[2].dispatch_s, r[3].dispatch_s) \
        <= min(r[0].dispatch_s, r[1].dispatch_s)
    assert r[2].dispatch_s == r[3].dispatch_s      # same batch
    for res in results:
        _assert_rows_equal(res, _standalone(prepared[res.request.uid].fit,
                                            res.request.seed))


def test_urgent_flush_preempts_held_partial():
    trace = [_slo_req(uid, bw=bw, seed=30 + uid)
             for uid, bw in ((1, 1.0), (2, 16.0))]
    fit = analyze_serial([_slo_req(0, bw=4.0, seed=29)])[0].fit
    urgent = PreparedScenario(fit=fit, seed=29, uid=0, priority="urgent",
                              deadline_s=1e-6)
    svc = _svc(stream=StreamConfig(batch_rows=4, analysis_workers=1))
    res = {r.request.uid: r for r in svc.run(trace, prepared=[urgent])}
    first = min(svc.last_batches, key=lambda b: b.dispatch_s)
    assert first.rows == 1                      # the flushed urgent partial
    assert res[0].dispatch_s == first.dispatch_s
    assert res[0].dispatch_s < min(res[1].dispatch_s, res[2].dispatch_s)
    m = svc.last_metrics
    assert m.num_with_deadline == 1 and m.deadline_misses == 1
    assert m.slo_attainment == 0.0
    assert res[0].deadline_met is False and res[1].deadline_met is None

    blind = _svc(stream=StreamConfig(batch_rows=4, analysis_workers=1,
                                     slo_aware=False, max_hold_s=30.0))
    bres = {r.request.uid: r for r in blind.run(trace, prepared=[urgent])}
    assert min(blind.last_batches, key=lambda b: b.dispatch_s).rows == 3
    _assert_rows_equal(bres[0], res[0])
    _assert_rows_equal(res[0], _standalone(fit, 29))


def test_anytime_interim_then_refined():
    ANYTIME = 60
    fit = analyze_serial([_slo_req(0, seed=40)])[0].fit
    strat = get_strategy("magma")
    memo = ScheduleMemo(near=False)
    svc = _svc(memo=memo, stream=StreamConfig(anytime_budget=ANYTIME))

    res1 = svc.schedule_prepared(fit, seed=5, priority="urgent",
                                 deadline_s=2.0)
    assert res1.anytime_interim and res1.budget == ANYTIME
    _assert_rows_equal(res1, _standalone(fit, 5, budget=ANYTIME))
    m = svc.last_metrics
    assert m.anytime_interims == 1 and m.anytime_refinements == 1

    refined = _standalone(fit, 5)
    hit = memo.lookup(fit, strat, BUDGET, 5)
    assert hit is not None and not hit.warm_seeded
    _assert_rows_equal(hit, refined)

    res2 = svc.schedule_prepared(fit, seed=5, priority="urgent",
                                 deadline_s=2.0)
    assert res2.memo_exact and res2.budget == BUDGET
    assert not res2.anytime_interim
    _assert_rows_equal(res2, refined)
    m2 = svc.last_metrics
    assert m2.num_batches == 0
    assert m2.anytime_interims == 0 and m2.anytime_refinements == 0

    res3 = svc.schedule_prepared(fit, seed=7)
    assert not res3.anytime_interim and res3.budget == BUDGET
    _assert_rows_equal(res3, _standalone(fit, 7))


def test_memo_counters_are_disjoint_and_exact_hits_skip_dispatch():
    ra = _slo_req(0, bw=16.0, seed=50)            # Light @ 16 GB/s
    rb = _slo_req(1, bw=8.0, seed=51)             # near sibling
    rh = _slo_req(2, mix="Heavy", group_size=10, seed=52)  # other family
    memo = ScheduleMemo()
    svc = _svc(memo=memo, stream=StreamConfig(batch_rows=4))

    first = svc.run([ra])[0]
    m1 = svc.last_metrics
    assert m1.memo_exact_hits == 0 and m1.memo_warm_hits == 0
    fit_a = analyze_serial([ra])[0].fit
    _assert_rows_equal(first, _standalone(fit_a, 50))

    res = {r.request.uid: r for r in svc.run([ra, rb, rh])}
    m2 = svc.last_metrics
    assert res[0].memo_exact and not res[0].warm_seeded
    assert res[1].warm_seeded and not res[1].memo_exact
    assert not res[2].memo_exact and not res[2].warm_seeded
    cold = sum(not r.memo_exact and not r.warm_seeded for r in res.values())
    assert m2.memo_exact_hits == 1 and m2.memo_warm_hits == 1 and cold == 1
    assert sum(b.rows for b in svc.last_batches) == 2   # no row for ra
    _assert_rows_equal(res[0], first)

    res3 = svc.run([rb])[0]
    m3 = svc.last_metrics
    assert res3.memo_exact and res3.warm_seeded
    assert m3.memo_exact_hits == 1 and m3.memo_warm_hits == 0
    assert m3.num_batches == 0
    _assert_rows_equal(res3, res[1])


def test_all_deadlines_expired_and_empty_trace():
    trace = generate_trace(TraceConfig(
        num_scenarios=3, seed=11, priorities=("urgent",),
        slo_by_class=(("urgent", 1e-9),), **QUICK))
    svc = _svc(stream=StreamConfig(batch_rows=4))
    results = svc.run(trace)
    m = svc.last_metrics
    assert m.num_with_deadline == 3 and m.deadline_misses == 3
    assert m.slo_attainment == 0.0
    assert all(r.deadline_met is False for r in results)
    assert m.latency_p99_urgent_s > 0.0 and m.latency_p99_normal_s == 0.0
    assert svc.run([]) == []
    assert svc.last_metrics.num_with_deadline == 0


# ---------------------------------------------------------------------------
# observability: bitwise rows, complete span trees, memo spans with scope
# ---------------------------------------------------------------------------
def test_obs_on_keeps_rows_and_traces_every_scenario(streamed, tmp_path):
    trace, _, results = streamed
    memo = ScheduleMemo(near=False)        # cold rows: bitwise the plain run
    svc = _svc(memo=memo, stream=StreamConfig(
        batch_rows=4, analysis_workers=2, obs={"enabled": True}))
    traced = svc.run(trace)
    for a, b in zip(traced, results):
        _assert_rows_equal(a, b)
    assert memo.tracer is svc.tracer
    by_uid = collections.defaultdict(dict)
    memo_spans = collections.defaultdict(list)
    for s in svc.tracer.spans():
        if s.name.startswith("memo."):
            memo_spans[s.scope].append(s.name)
        elif s.scope is not None and s.name in STAGES:
            assert s.name not in by_uid[s.scope], (s.scope, s.name)
            by_uid[s.scope][s.name] = s
    for r, res in zip(trace, traced):
        tree = by_uid[r.uid]
        assert sorted(tree) == sorted(STAGES), (r.uid, sorted(tree))
        for a, b in zip(STAGES, STAGES[1:]):
            assert tree[b].start_s >= tree[a].start_s - 1e-9, (r.uid, a, b)
        assert tree["device"].end_s == pytest.approx(res.done_s, abs=1e-6)
        assert sorted(memo_spans[r.uid]) == ["memo.lookup", "memo.record",
                                             "memo.warm_start"]
    path = svc.export_trace(str(tmp_path / "stream.json"))
    from repro_torch.obs import read_trace, summarize
    assert summarize(read_trace(path))["scenarios"] == len(trace)

    svc.run(trace)                         # replay: exact hits only
    hits = [s for s in svc.tracer.spans() if s.name == "memo.lookup"]
    assert len(hits) == len(trace)
    assert all(s.args.get("outcome") == "hit" for s in hits)


def test_flight_dump_on_deadline_miss(tmp_path):
    trace = generate_trace(TraceConfig(num_scenarios=2, seed=7, **QUICK))
    trace = [dataclasses.replace(r, deadline_s=1e-4) for r in trace]
    svc = _svc(budget=64, stream=StreamConfig(
        batch_rows=2, analysis_workers=1,
        obs={"enabled": True, "flight_dir": str(tmp_path)}))
    results = svc.run(trace)
    assert all(r.deadline_met is False for r in results)
    assert len(svc.flight.dumps) == len(results)


# ---------------------------------------------------------------------------
# the whole slice against the reference
# ---------------------------------------------------------------------------
def _both_serial(trace_kw, budget=BUDGET):
    cfg = dict(batch_rows=4, analysis_workers=1)
    mine_svc = _svc(budget=budget, stream=StreamConfig(**cfg))
    ref_svc = ref_stream.StreamingScheduler(
        budget=budget, stream=ref_stream.StreamConfig(**cfg))
    mine = mine_svc.run_serial(generate_trace(TraceConfig(**trace_kw)))
    theirs = ref_svc.run_serial(ref_stream.generate_trace(
        ref_stream.TraceConfig(**trace_kw)))
    return mine_svc, mine, ref_svc, theirs


def _grouping(svc):
    return [(b.compat_key[1], b.compat_key[2], b.compat_key[5],
             b.compat_key[6], b.rows, b.padded_rows)
            for b in svc.last_batches]


def test_whole_slice_against_reference():
    mine_svc, mine, ref_svc, theirs = _both_serial(SLICE)
    assert [r.request.uid for r in mine] == [r.request.uid for r in theirs]
    assert [dict(dataclasses.asdict(r.request), arrival_s=0.0)
            for r in mine] == [dict(dataclasses.asdict(t.request),
                                    arrival_s=0.0) for t in theirs]
    assert _grouping(mine_svc) == _grouping(ref_svc)
    assert all(r.n_samples == t.n_samples for r, t in zip(mine, theirs))
    ratio = geomean([r.best_fitness for r in mine]) / \
        geomean([t.best_fitness for t in theirs])
    assert abs(ratio - 1.0) <= RATIO_TOL, ratio


def measure_ratio_spread(seeds=range(10)):
    """The measurement behind ``RATIO_TOL``: the whole-slice geomean
    ratio, port over reference, for the SLICE trace at trace seeds
    ``seeds``."""
    ratios = []
    for seed in seeds:
        _, mine, _, theirs = _both_serial(dict(SLICE, seed=seed))
        ratios.append(geomean([r.best_fitness for r in mine]) /
                      geomean([t.best_fitness for t in theirs]))
        print(f"trace seed {seed}: geomean ratio {ratios[-1]:.4f}")
    print(f"min {min(ratios):.4f} max {max(ratios):.4f}")


# ---------------------------------------------------------------------------
# the serving engine as a stream client
# ---------------------------------------------------------------------------
SERVE_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")
SERVE_REQUESTS = [("falcon-mamba-7b", 16, 6), ("zamba2-1.2b", 12, 5),
                  ("falcon-mamba-7b", 9, 3)]


def _engine(device_models=False, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve import engine
    tenants = []
    for i, arch in enumerate(SERVE_ARCHS):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        if device_models:
            gen = torch.Generator().manual_seed(i)
            with torch.no_grad():
                model = get_model(cfg, device="cpu", generator=gen)
        else:
            model = get_model(cfg, device="meta")
        tenants.append(engine.Tenant(arch, cfg, model))
    return engine.MultiTenantEngine(tenants, budget=300, decode_window=4,
                                    seed=3, device="cpu", **kw)


def test_engine_schedules_through_the_stream_bitwise():
    eng = _engine()
    jobs = eng.jobs_for_requests(SERVE_REQUESTS)
    out = eng.schedule(jobs)
    assert isinstance(out["stream"], StreamResult)
    assert out["stream"].request.mix == "<prepared>"
    from repro_torch.core.fitness import FitnessFn
    fit = FitnessFn(out["table"], bw_sys=eng.system_bw, device="cpu")
    want = run_strategy(get_strategy("magma"), fit, budget=300, seed=3,
                        device="cpu")
    _assert_rows_equal(out["result"], want)
    np.testing.assert_array_equal(out["result"].history_samples,
                                  want.history_samples)
    assert eng.schedule(jobs, method="ai_mt_like")["stream"] is None
    assert eng.stream_service().device == torch.device("cpu")
    eng.close()


def test_engine_memo_replays_a_reseen_job_group():
    eng = _engine(memo=ScheduleMemo())
    first = eng.schedule(eng.jobs_for_requests(SERVE_REQUESTS))
    assert not first["stream"].memo_exact
    again = eng.schedule(eng.jobs_for_requests(SERVE_REQUESTS))
    assert again["stream"].memo_exact
    assert eng.stream_service().last_metrics.num_batches == 0
    assert again["local_queues"] == first["local_queues"]
    _assert_rows_equal(again["result"], first["result"])
    eng.close()


def test_engine_schedule_front_equals_a_direct_search():
    from repro_torch.core.fitness import FitnessFn
    eng = _engine()
    jobs = eng.jobs_for_requests(SERVE_REQUESTS)
    out = eng.schedule_front(jobs)
    fit = FitnessFn(eng.analyze(jobs), bw_sys=eng.system_bw,
                    objective=("latency", "energy", "edp"), device="cpu")
    res = run_strategy(get_strategy("nsga2"), fit, budget=300, seed=3,
                       keep_population=True, device="cpu")
    want = pareto_front(fit, res.final_population)
    front = out["front"]
    assert front.names == want.names
    np.testing.assert_array_equal(front.objectives, want.objectives)
    np.testing.assert_array_equal(front.accel, want.accel)
    np.testing.assert_array_equal(front.prio, want.prio)
    with pytest.raises(ValueError, match="single-objective"):
        eng.schedule_front(jobs, method="magma")
    eng.close()


def test_engine_close_shuts_only_its_own_stream():
    shared = _svc()
    eng = _engine(stream=shared)
    eng.schedule(eng.jobs_for_requests(SERVE_REQUESTS[:1]))
    eng.close()
    assert eng.stream_service() is shared
    assert not shared.pool._pool._shutdown
    shared.close()

    with _engine() as own:
        own.schedule(own.jobs_for_requests(SERVE_REQUESTS[:1]))
        built = own.stream_service()
    assert own._stream is None and built.pool._pool._shutdown


def test_engine_executed_tokens_equal_the_direct_schedule():
    eng = _engine(device_models=True)
    jobs = eng.jobs_for_requests(SERVE_REQUESTS)
    rng = np.random.default_rng(0)
    prompts = {j.uid: rng.integers(0, 256, (1, j.seq)).astype(np.int32)
               for j in jobs if j.phase == "prefill"}
    out = eng.schedule(jobs, execute=True, prompts=prompts)
    from repro_torch.core.encoding import decode_to_lists
    from repro_torch.core.fitness import FitnessFn
    fit = FitnessFn(eng.analyze(jobs), bw_sys=eng.system_bw, device="cpu")
    res = _standalone(fit, 3)
    local = decode_to_lists(res.best_accel, res.best_prio,
                            len(eng.submeshes))
    assert out["local_queues"] == local
    want = eng.execute(jobs, [[int(jobs[i].uid) for i in q] for q in local],
                       prompts)
    assert sorted(out["outputs"]) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(out["outputs"][uid], want[uid])
    eng.close()


if __name__ == "__main__":
    measure_ratio_spread()
