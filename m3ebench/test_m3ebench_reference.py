"""The benchmark's plain reference against the program's plain path.

The reference is a frozen copy: these tests pin that, today, it gives
the program's tables, job groups and decode exactly and its makespans to
float32 rounding, and that its lower bound holds under any mapping of
both configurations."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from m3ebench.reference import costmodel, schedule, zoo  # noqa: E402

CONFIGS = ("s4_mix_g100", "s2_mix_g100")
GB = 1024 ** 3


def config(name):
    with open(ROOT / "m3ebench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def random_mappings(rng, n, G, A):
    return (rng.integers(0, A, (n, G)).astype(np.int32),
            rng.random((n, G)).astype(np.float32))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 1])
def test_tables_equal_the_programs(name, seed):
    from repro_torch.core.job_analyzer import JobAnalyzer
    from repro_torch.costmodel import get_setting
    from repro_torch.workloads import build_task_groups
    cfg = config(name)
    group = build_task_groups(cfg["task"], cfg["group_size"], seed=seed)[0]
    want = JobAnalyzer(get_setting(cfg["setting"])).analyze(group.jobs)
    jobs = zoo.job_group(cfg["models"], cfg["group_size"], seed)
    got = schedule.tables(jobs, costmodel.sub_accels(cfg["sub_accels"]))
    assert np.array_equal(got.lat, want.lat)
    assert np.array_equal(got.bw, want.bw)
    assert got.flops == want.total_flops


@pytest.mark.parametrize("task", ["Mix", "Vision", "Lang", "Recom",
                                  "Heavy", "Light", "HeavyLight"])
def test_job_groups_equal_the_programs(task):
    from repro_torch.workloads import TASK_MODELS, build_task_groups
    for seed in (0, 3, 12345):
        got = zoo.job_group(TASK_MODELS[task], 100, seed)
        want = build_task_groups(task, 100, seed=seed)[0].jobs
        assert [(l.kind, l.N, l.K, l.C, l.Y, l.X, l.R, l.S, l.stride)
                for l in got] == [
            (j.layer.kind, j.layer.N, j.layer.K, j.layer.C, j.layer.Y,
             j.layer.X, j.layer.R, j.layer.S, j.layer.stride) for j in want]


def test_batch_scale_equals_the_programs():
    from repro_torch.stream.analysis import scale_jobs
    from repro_torch.workloads import TASK_MODELS, build_task_groups
    want = scale_jobs(build_task_groups("Mix", 40, seed=5)[0].jobs, 3)
    got = schedule.scale_batch(zoo.job_group(TASK_MODELS["Mix"], 40, 5), 3)
    assert [(l.N, l.Y) for l in got] == [(j.layer.N, j.layer.Y)
                                         for j in want]


@pytest.mark.parametrize("A", [4, 8])
def test_decode_equals_the_programs(A):
    from repro_torch.core.encoding import decode
    rng = np.random.default_rng(A)
    accel, prio = random_mappings(rng, 64, 100, A)
    prio[:, ::7] = 0.5                    # ties break by job id
    queue, count = schedule.decode(accel, prio, A)
    want = decode(torch.from_numpy(accel), torch.from_numpy(prio), A)
    assert np.array_equal(count, want.count.numpy())
    for n in range(64):
        for a in range(A):
            c = count[n, a]
            assert np.array_equal(queue[n, a, :c],
                                  want.queue[n, a, :c].numpy())
            assert np.all(queue[n, a, c:] == -1)


def test_decode_refuses_genes_out_of_range():
    with pytest.raises(ValueError):
        schedule.decode(np.array([[0, 4]]), np.array([[0.1, 0.2]]), 4)


def _tables_and_mappings(name, n, seed):
    cfg = config(name)
    subs = costmodel.sub_accels(cfg["sub_accels"])
    t = schedule.tables(zoo.job_group(cfg["models"], cfg["group_size"], seed),
                        subs)
    accel, prio = random_mappings(np.random.default_rng(seed), n,
                                  cfg["group_size"], len(subs))
    return cfg, subs, t, accel, prio


@pytest.mark.parametrize("name", CONFIGS)
def test_makespans_equal_the_programs_oracle_and_plain_path(name):
    from repro_torch.core.bw_allocator import (simulate_numpy,
                                               simulate_population)
    cfg, subs, t, accel, prio = _tables_and_mappings(name, 32, 3)
    A = len(subs)
    queue, count = schedule.decode(accel, prio, A)
    for bw in cfg["bandwidths_gb"]:
        bw_sys = bw * GB
        got = schedule.makespans(queue, count, t.lat[None].repeat(32, 0),
                                 t.bw[None].repeat(32, 0),
                                 np.full(32, bw_sys))
        oracle = [simulate_numpy([list(queue[n, a, :count[n, a]])
                                  for a in range(A)], t.lat, t.bw, bw_sys)
                  for n in range(8)]
        np.testing.assert_allclose(got[:8], oracle, rtol=1e-9)
        plain = simulate_population(
            torch.from_numpy(accel), torch.from_numpy(prio),
            torch.from_numpy(t.lat), torch.from_numpy(t.bw), bw_sys,
            A).numpy()
        np.testing.assert_allclose(got, plain, rtol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_lower_bound_holds_under_random_mappings(name):
    cfg, subs, t, accel, prio = _tables_and_mappings(name, 256, 11)
    queue, count = schedule.decode(accel, prio, len(subs))
    for bw in cfg["bandwidths_gb"] + [0.25, 1024]:
        ms = schedule.makespans(queue, count, t.lat[None].repeat(256, 0),
                                t.bw[None].repeat(256, 0),
                                np.full(256, bw * GB))
        lb = schedule.lower_bound(t.lat, t.bw, bw * GB)
        assert np.all(lb <= ms * (1 + 1e-12))


@pytest.mark.parametrize("name", CONFIGS)
def test_lower_bound_holds_for_one_job_a_queue_and_a_single_queue(name):
    """The bound's three terms each bind: every job on its fastest
    array, and every job queued on one array."""
    cfg, subs, t, _, _ = _tables_and_mappings(name, 1, 2)
    G, A = t.lat.shape
    fastest = t.lat.argmin(axis=1).astype(np.int32)[None]
    prio = np.linspace(0, 1, G, dtype=np.float32)[None]
    for accel in (fastest, np.zeros((1, G), np.int32)):
        queue, count = schedule.decode(accel, prio, A)
        for bw in (0.25 * GB, 1024 * GB):
            ms = schedule.makespans(queue, count, t.lat[None], t.bw[None],
                                    np.array([bw]))
            assert schedule.lower_bound(t.lat, t.bw, bw) <= ms[0] * (
                1 + 1e-12)


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.0e9, -2.5e-7],
                 dtype=np.float32)
    got = schedule.to_bfloat16(x)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(got, want)


def test_bfloat16_makespans_differ_from_float64():
    cfg, subs, t, accel, prio = _tables_and_mappings("s4_mix_g100", 16, 4)
    queue, count = schedule.decode(accel, prio, len(subs))
    args = (queue, count, t.lat[None].repeat(16, 0),
            t.bw[None].repeat(16, 0), np.full(16, 256.0 * GB))
    exact = schedule.makespans(*args)
    low = schedule.makespans(*args, rnd=schedule.to_bfloat16)
    gap = np.abs(low - exact) / exact
    assert gap.max() > 1e-3 and gap.max() < 0.2
