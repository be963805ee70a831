"""Port parity: the serving launcher (``repro_torch.launch.serve``).

``main(["--device", "cpu", ...])`` at smoke size against the reference's
``repro.launch.serve.main`` with the same flags.  The reference engine is
wrapped to record what its launcher asks of it: the requests, the jobs,
every schedule and, with ``--execute``, the prompts (its execution is
replaced by a stub: the reference decodes eagerly, minutes at this size,
and ``tests/test_torch_serve.py`` already holds executed tokens against
the JAX engine's).  The request mix, the jobs, the prompts and the
heuristic schedules' queues and makespans must be equal; the port's own
``--execute`` must answer every decode window.  MAGMA's schedule is
checked for coverage only: the packages draw from other random streams.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.launch import serve as jlaunch  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import count_params, get_model  # noqa: E402

FLAGS = ["--requests", "6", "--budget", "200", "--seed", "3"]


def _reference(monkeypatch, argv):
    """Run the reference launcher's ``main`` with ``argv``; returns what
    its engine saw and gave (requests, jobs, schedules, prompts, queues
    handed to ``execute``) and its printed lines."""
    seen = {"schedules": []}

    class Recording(jengine.MultiTenantEngine):
        def jobs_for_requests(self, requests):
            seen["requests"] = list(requests)
            seen["jobs"] = super().jobs_for_requests(requests)
            return seen["jobs"]

        def schedule(self, jobs, method=None, **kw):
            out = super().schedule(jobs, method=method, **kw)
            seen["schedules"].append((method, out))
            return out

        def execute(self, jobs, queues, prompts):
            seen["executed"] = (queues, prompts)
            return {0: np.zeros((1, 8), np.int32)}

    monkeypatch.setattr(jlaunch, "MultiTenantEngine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jlaunch.main()
    return seen


def _port(argv):
    lines = []
    out = serve.main(["--device", "cpu"] + argv, log_fn=lines.append)
    return out, lines


def test_requests_jobs_and_heuristics_equal_the_reference(monkeypatch,
                                                          capsys):
    argv = FLAGS + ["--method", "herald_like"]
    ref = _reference(monkeypatch, argv)
    ref_lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[serve]")]
    out, lines = _port(argv)
    assert out["requests"] == ref["requests"]
    assert [vars(j) for j in out["jobs"]] == [vars(j) for j in ref["jobs"]]
    assert [m for m, _ in out["schedules"]] == \
        [m for m, _ in ref["schedules"]] == \
        ["herald_like", "herald_like", "ai_mt_like"]
    for (_, got), (_, want) in zip(out["schedules"], ref["schedules"]):
        assert got["queues"] == want["queues"]
        assert got["makespan_s"] == want["makespan_s"]
        assert got["throughput_flops"] == want["throughput_flops"]
    assert lines == ref_lines       # the same report, line for line


def test_execute_draws_the_reference_prompts_and_answers_every_window(
        monkeypatch):
    argv = FLAGS + ["--method", "herald_like", "--execute"]
    ref = _reference(monkeypatch, argv)
    out, lines = _port(argv)
    queues, prompts = ref["executed"]
    assert out["executed"]["queues"] == queues
    assert sorted(out["prompts"]) == sorted(prompts)
    for uid, want in prompts.items():
        np.testing.assert_array_equal(out["prompts"][uid], want)
    decodes = {j.uid: j for j in out["jobs"] if j.phase == "decode"}
    assert sorted(out["outputs"]) == sorted(decodes)
    vocab = {t: e.cfg.vocab for t, e in out["engine"].tenants.items()}
    for uid, toks in out["outputs"].items():
        job = decodes[uid]
        assert toks.shape == (1, job.tokens) and toks.dtype == np.int32
        assert ((toks >= 0) & (toks < vocab[job.tenant])).all()
    assert lines[-1].startswith(f"[serve] executed {len(decodes)} decode "
                                "jobs; sample tokens:")


def test_default_flow_schedules_every_job_with_magma_first():
    out, lines = _port(FLAGS)
    names = [t for t in out["engine"].tenants]
    assert names == ["granite-3-2b", "qwen2-moe-a2.7b", "falcon-mamba-7b"]
    assert [m for m, _ in out["schedules"]] == \
        ["magma", "herald_like", "ai_mt_like"]
    uids = sorted(j.uid for j in out["jobs"])
    for _, sched in out["schedules"]:
        assert sorted(u for q in sched["queues"] for u in q) == uids
        assert sched["makespan_s"] > 0 and np.isfinite(sched["makespan_s"])
    assert "outputs" not in out and len(lines) == 4


def test_full_tenants_take_the_published_configs(monkeypatch):
    """``full=True`` builds each tenant from its published config in bf16
    through the kernels (built here on ``meta``: shapes only)."""
    seen = []

    def meta_model(cfg, device, generator):
        seen.append((cfg, torch.device(device), generator.initial_seed()))
        return get_model(cfg, device="meta")

    monkeypatch.setattr(serve, "get_model", meta_model)
    tenants = serve.build_tenants(["granite-3-2b", "qwen2-moe-a2.7b"], 5,
                                  device="cpu", full=True)
    assert [s[2] for s in seen] == [5, 6]
    for t in tenants:
        assert t.cfg.dtype == "bfloat16" and t.cfg.use_flash
        assert sum(p.numel() for p in t.model.parameters()) == \
            count_params(t.cfg)
    assert count_params(tenants[1].cfg) == 14_835_091_456
    smoke = serve.build_tenants(["falcon-mamba-7b"], device="cpu")
    assert smoke[0].cfg.dtype == "float32" and not smoke[0].cfg.use_flash
    assert smoke[0].cfg.num_layers == 2


def test_launcher_refuses_a_missing_card():
    """Without ``--device cpu`` the launcher serves on the card, and
    fails where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        serve.main(["--requests", "1"], log_fn=lambda *_: None)
