"""Port parity: ``repro_torch.train.fault`` (straggler watchdog, re-mesh
plans, elastic controller) against ``repro.train.fault``, decision for
decision on the same inputs, and the reference's own cases."""
import numpy as np
import pytest

pytest.importorskip("torch")
jfault = pytest.importorskip("repro.train.fault")

from repro_torch.train.fault import (ElasticController, MeshPlan,  # noqa: E402
                                     StragglerWatchdog, plan_remesh)


def _times(seed, steps, n_hosts):
    """Seeded per-host step times with slow hosts and missing heartbeats."""
    rng = np.random.default_rng(seed)
    t = rng.lognormal(0.0, 0.1, (steps, n_hosts))
    slow = rng.random((steps, n_hosts)) < 0.08
    t[slow] *= rng.uniform(2.0, 12.0, slow.sum())
    missing = rng.random((steps, n_hosts)) < 0.03
    return t, missing


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("grace,threshold", [(1, 2.0), (3, 2.0), (2, 1.5)])
def test_watchdog_flags_equal_reference(seed, grace, threshold):
    t, _ = _times(seed, 30, 8)
    ours = StragglerWatchdog(8, grace_steps=grace, threshold=threshold)
    ref = jfault.StragglerWatchdog(8, grace_steps=grace, threshold=threshold)
    for row in t:
        assert ours.observe(row) == ref.observe(row)
        np.testing.assert_array_equal(ours.ewma, ref.ewma)
    assert ours.observe_missing([1, 4]) == ref.observe_missing([1, 4])


@pytest.mark.parametrize("multi_pod", [True, False])
@pytest.mark.parametrize("model_axis,chips_per_pod",
                         [(16, 256), (4, 16), (2, 8), (8, 64)])
def test_plan_remesh_equals_reference(multi_pod, model_axis, chips_per_pod):
    for healthy in list(range(0, 3 * chips_per_pod + 2)) + [511, 512, 1000]:
        ours = plan_remesh(healthy, model_axis, chips_per_pod, multi_pod)
        ref = jfault.plan_remesh(healthy, model_axis, chips_per_pod,
                                 multi_pod)
        if ref is None:
            assert ours is None, healthy
            continue
        assert (ours.shape, ours.axis_names, ours.n_chips, ours.valid) == \
            (ref.shape, ref.axis_names, ref.n_chips, ref.valid), healthy


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("chips_per_host,model_axis", [(4, 4), (4, 16),
                                                       (1, 2)])
def test_elastic_controller_decisions_equal_reference(seed, chips_per_host,
                                                      model_axis):
    n_hosts = 8
    t, missing = _times(100 + seed, 25, n_hosts)
    ours = ElasticController(n_hosts, chips_per_host, model_axis)
    ref = jfault.ElasticController(n_hosts, chips_per_host, model_axis)
    for row, miss in zip(t, missing):
        times = {h: float(row[h]) for h in range(n_hosts) if not miss[h]}
        a, b = ours.step(times), ref.step(times)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.shape, a.axis_names, a.n_chips) == \
                (b.shape, b.axis_names, b.n_chips)
        assert ours.dead == ref.dead


def test_straggler_watchdog_flags_slow_host():
    wd = StragglerWatchdog(n_hosts=8, grace_steps=3)
    base = np.ones(8)
    assert wd.observe(base) == []
    slow = base.copy()
    slow[3] = 10.0
    flagged = []
    for _ in range(4):
        flagged = wd.observe(slow)
    assert flagged == [3]


def test_plan_remesh_shrinks_gracefully():
    p = plan_remesh(512, model_axis=16, chips_per_pod=256)
    assert p.shape == (2, 16, 16)
    p = plan_remesh(511, model_axis=16, chips_per_pod=256)
    assert p.shape == (16, 16) and p.n_chips == 256
    p = plan_remesh(200, model_axis=16)
    assert p.shape == (12, 16)
    assert plan_remesh(10, model_axis=16) is None
    assert MeshPlan((1, 2), ("data", "model"), 2).valid


def test_elastic_controller_end_to_end():
    ec = ElasticController(n_hosts=8, chips_per_host=4, model_axis=4)
    assert ec.step({h: 1.0 for h in range(8)}) is None
    # host 2 stops heartbeating -> immediate re-mesh plan
    plan = ec.step({h: 1.0 for h in range(8) if h != 2})
    assert plan is not None and plan.n_chips == 28 // 4 * 4
