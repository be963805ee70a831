"""Port parity: scenario inputs.  The job groups and the job-analysis tables
of ``repro_torch`` are bitwise those of ``repro`` for every Table III
setting and every paper task, at the paper's group size."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.core.job_analyzer import JobAnalyzer as RefAnalyzer  # noqa: E402
from repro.costmodel import get_setting as ref_setting  # noqa: E402
from repro.workloads import build_task_groups as ref_groups  # noqa: E402
from repro_torch.core.job_analyzer import JobAnalyzer  # noqa: E402
from repro_torch.costmodel import get_setting  # noqa: E402
from repro_torch.workloads import build_task_groups  # noqa: E402

SETTINGS = ["S1", "S2", "S3", "S4", "S5", "S6"]
TASKS = ["Vision", "Lang", "Recom", "Mix"]


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("task", TASKS)
def test_job_analysis_tables_bitwise(setting, task):
    ref_group = ref_groups(task, group_size=100, seed=0)[0]
    group = build_task_groups(task, group_size=100, seed=0)[0]
    assert [(j.uid, j.model, dataclasses.astuple(j.layer))
            for j in group.jobs] == \
        [(j.uid, j.model, dataclasses.astuple(j.layer))
         for j in ref_group.jobs]

    ref = RefAnalyzer(ref_setting(setting)).analyze(ref_group.jobs)
    got = JobAnalyzer(get_setting(setting)).analyze(group.jobs)
    assert got.num_accels == ref.num_accels
    for name in ("lat", "bw", "energy", "flops"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.total_flops == ref.total_flops


@pytest.mark.parametrize("seed", [1, 7])
def test_group_seeds_rotate_identically(seed):
    ref = ref_groups("Mix", group_size=37, num_groups=2, seed=seed)
    got = build_task_groups("Mix", group_size=37, num_groups=2, seed=seed)
    assert [[j.layer.name for j in g.jobs] for g in got] == \
        [[j.layer.name for j in g.jobs] for g in ref]
