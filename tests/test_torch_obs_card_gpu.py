"""The card's own timeline on the card: the timing events around a search's
generation loop agree with the union of its kernels under CUPTI (the
events read in a process no profiler has run in); the
profiler ranges of the port's stages are CPU-only (a profile with them
holds the same CUDA-typed events as one without, and no user
annotation); every stream batch's card interval lies inside its host
stamps.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``cuda`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py
"""
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.m3e import M3E  # noqa: E402
from repro_torch.costmodel import GB, get_setting  # noqa: E402
from repro_torch.obs import interval_union_s  # noqa: E402
from repro_torch.obs import profiler as obs_profiler  # noqa: E402
from repro_torch.stream import (ScenarioRequest, StreamConfig,  # noqa: E402
                                StreamingScheduler)
from repro_torch.workloads import build_task_groups  # noqa: E402

BUDGET = 10_000                     # the benchmark's search: G=100, P=100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _m3e(cuda):
    return M3E(get_setting("S4"), bw_sys=256 * GB, device=cuda)


def _group(seed):
    return build_task_groups("Mix", group_size=100, seed=seed)[0]


def _profile(fn, cpu):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return out, prof, dev


def _union_s(events):
    return interval_union_s([(e.time_range.start * 1e-6,
                              e.time_range.end * 1e-6) for e in events])


# a fresh process: once a profiler session has run, every later replay of
# a large graph in that process runs slower (17-20% for a search on an
# H100 with torch 2.11), which the events see and the profiled kernels
# do not
_MEASURE = r"""
import json, sys
import torch
sys.path.insert(0, "src")
from m3ebench import trace
from repro_torch.core.m3e import M3E
from repro_torch.costmodel import GB, get_setting
from repro_torch.workloads import build_task_groups
m3e = M3E(get_setting("S4"), bw_sys=256 * GB, device="cuda")
def group(s):
    return build_task_groups("Mix", group_size=100, seed=s)[0]
for s in (1, 2):
    m3e.search(group(s), budget=10_000, seed=s)        # captures
events = {s: [m3e.search(group(s), budget=10_000, seed=s).card_time_s
              for _ in range(3)] for s in (3, 4)}
union = {s: trace.busy_s(trace.profile(
    lambda: m3e.search(group(s), budget=10_000, seed=s)).device)
    for s in (3, 4)}
print(json.dumps({"events": events, "union": union}))
"""


@pytest.mark.gpu
def test_loop_events_agree_with_the_kernels_union(cuda):
    """A search's loop time by its timing events, unprofiled, against the
    union of its kernels under CUPTI (which read 1-2% long)."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", _MEASURE], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for s, events in got["events"].items():
        event, union = statistics.median(events), got["union"][s]
        assert abs(event - union) <= 0.03 * union, (s, events, union)


@pytest.mark.gpu
def test_stage_ranges_stay_off_the_device_timeline(cuda, monkeypatch):
    m3e = _m3e(cuda)
    group = _group(4)
    m3e.search(group, budget=BUDGET, seed=4)
    _, on, dev_on = _profile(
        lambda: m3e.search(group, budget=BUDGET, seed=4), cpu=True)
    assert {"repro.search.prepare", "repro.search.loop",
            "repro.search.readback"} <= {e.name for e in on.events()}
    monkeypatch.setattr(obs_profiler, "_record_function", lambda name: None)
    _, off, dev_off = _profile(
        lambda: m3e.search(group, budget=BUDGET, seed=4), cpu=True)
    assert not any(e.name.startswith("repro.") for e in off.events())
    assert len(dev_on) == len(dev_off)
    assert _union_s(dev_on) == pytest.approx(_union_s(dev_off), rel=0.03)
    for prof in (on, off):
        assert not [e.name for e in prof.events()
                    if e.device_type.name == "CUDA"
                    and getattr(e, "is_user_annotation", False)]
    assert not [e.name for e in dev_on if e.name.startswith("repro.")]


@pytest.mark.gpu
def test_stream_card_intervals_lie_inside_the_host_stamps(cuda):
    reqs = [ScenarioRequest(uid=i, arrival_s=0.01 * i, mix="Mix",
                            setting="S4", bw_gb=256.0, group_size=100,
                            seed=100 + i) for i in range(24)]
    svc = StreamingScheduler(budget=BUDGET, device=cuda,
                             stream=StreamConfig(batch_rows=8,
                                                 realtime=True))
    svc.warmup(reqs[:1])
    svc.run(reqs)
    svc.close()
    assert svc.last_batches
    for b in svc.last_batches:
        assert b.card_start_s is not None
        assert b.card_start_s <= b.card_end_s <= b.done_s
    m = svc.last_metrics
    assert m.device_busy_s == interval_union_s(
        [(b.card_start_s, b.card_end_s) for b in svc.last_batches])
