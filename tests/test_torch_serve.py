"""Port parity: the multi-tenant serving engine.

Two smoke tenants, falcon-mamba-7b (SSM) and zamba2-1.2b (hybrid), in
float32; and the serving launcher's mix, granite-3-2b (dense),
qwen2-moe-a2.7b (MoE) and falcon-mamba-7b.  The reference initialises
them; their weights are carried into the port with
``repro_torch.convert.model_from_numpy``.  Both engines see the same
requests, and the same numpy-drawn prompts.

  - Job costs and the ``analyze`` tables (lat, bw, energy, flops) are
    bitwise the JAX engine's: the TPU cost model is a copy.
  - ``execute`` on the same jobs, queues and prompts gives the JAX
    engine's greedy tokens exactly.
  - The port's engine schedules through its own ``run_strategy`` on the
    CPU here; every job is scheduled once.  The one-shot heuristics
    (``herald_like``, ``ai_mt_like``) give the reference's queues and
    makespans exactly.
  - ``schedule_front`` returns a non-dominated set of complete schedules,
    as the reference's ``tests/test_serve.py`` holds it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import module as jmodule  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.core.bw_allocator import simulate_numpy  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]
REQUESTS = [("falcon-mamba-7b", 16, 6), ("zamba2-1.2b", 12, 5),
            ("falcon-mamba-7b", 9, 3), ("zamba2-1.2b", 20, 4)]
ENGINE_KW = dict(budget=400, decode_window=4, seed=0)


@pytest.fixture(scope="module")
def tenants():
    """(JAX tenants, port tenants with use_flash=True, port tenants with
    use_flash=False), all sharing the reference's smoke weights."""
    jt, flash, plain = [], [], []
    for i, arch in enumerate(ARCHS):
        jcfg = jsmoke(arch).replace(dtype="float32")
        jm = jget_model(jcfg)
        values, _ = jmodule.split(jm.init(jax.random.PRNGKey(i)))
        values = jax.tree.map(np.asarray, values)
        jt.append(jengine.Tenant(arch, jcfg, values, jm))
        for out, use_flash in ((flash, True), (plain, False)):
            cfg = get_smoke_config(arch).replace(dtype="float32",
                                                 use_flash=use_flash)
            out.append(engine.Tenant(arch, cfg,
                                     model_from_numpy(cfg, values, "cpu")))
    return jt, flash, plain


def _engines(tenants, **kw):
    jt, flash, _ = tenants
    return (jengine.MultiTenantEngine(jt, jengine.default_submeshes(),
                                      **ENGINE_KW, **kw),
            engine.MultiTenantEngine(flash, engine.default_submeshes(),
                                     device="cpu", **ENGINE_KW, **kw))


def _prompts(jobs, seed=0):
    rng = np.random.default_rng(seed)
    return {j.uid: rng.integers(0, 256, (1, j.seq)).astype(np.int32)
            for j in jobs if j.phase == "prefill"}


MIXED = ["granite-3-2b", "qwen2-moe-a2.7b", "falcon-mamba-7b"]
MIXED_REQUESTS = [("granite-3-2b", 14, 6), ("qwen2-moe-a2.7b", 11, 5),
                  ("falcon-mamba-7b", 9, 3), ("qwen2-moe-a2.7b", 17, 4),
                  ("granite-3-2b", 8, 2)]


@pytest.fixture(scope="module")
def mixed():
    """(JAX tenants, port tenants) of the launcher's three families,
    sharing the reference's smoke weights."""
    jt, pt = [], []
    for i, arch in enumerate(MIXED):
        jcfg = jsmoke(arch).replace(dtype="float32")
        jm = jget_model(jcfg)
        values, _ = jmodule.split(jm.init(jax.random.PRNGKey(10 + i)))
        values = jax.tree.map(np.asarray, values)
        jt.append(jengine.Tenant(arch, jcfg, values, jm))
        cfg = get_smoke_config(arch).replace(dtype="float32", use_flash=True)
        pt.append(engine.Tenant(arch, cfg,
                                model_from_numpy(cfg, values, "cpu")))
    return (jengine.MultiTenantEngine(jt, jengine.default_submeshes(),
                                      **ENGINE_KW),
            engine.MultiTenantEngine(pt, engine.default_submeshes(),
                                     device="cpu", **ENGINE_KW))


@pytest.mark.parametrize("arch", ARCHS + ["granite-3-2b", "qwen2-moe-a2.7b",
                                          "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("phase,seq,tokens", [
    ("prefill", 512, 512), ("prefill", 17, 17), ("decode", 520, 8),
    ("decode", 33, 1)])
def test_job_costs_bitwise_full_configs(arch, phase, seq, tokens):
    from repro.configs import get_config as jget_config
    assert engine.job_costs(get_config(arch), phase, 1, seq, tokens) == \
        jengine.job_costs(jget_config(arch), phase, 1, seq, tokens)


def test_jobs_and_analyze_tables_bitwise(tenants):
    jeng, eng = _engines(tenants)
    jjobs, jobs = jeng.jobs_for_requests(REQUESTS), \
        eng.jobs_for_requests(REQUESTS)
    assert [vars(j) for j in jobs] == [vars(j) for j in jjobs]
    jtab, tab = jeng.analyze(jjobs), eng.analyze(jobs)
    for name in ("lat", "bw", "energy", "flops"):
        got, want = getattr(tab, name), getattr(jtab, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert tab.num_accels == jtab.num_accels == 8
    assert tab.total_flops == jtab.total_flops


def test_schedule_covers_every_job_once(tenants):
    _, eng = _engines(tenants)
    jobs = eng.jobs_for_requests(REQUESTS * 2)
    out = eng.schedule(jobs)
    scheduled = sorted(uid for q in out["queues"] for uid in q)
    assert scheduled == sorted(j.uid for j in jobs)
    assert out["stream"] is None and "outputs" not in out
    assert out["makespan_s"] > 0 and np.isfinite(out["makespan_s"])
    assert out["makespan_s"] == simulate_numpy(
        out["local_queues"], out["table"].lat, out["table"].bw,
        eng.system_bw)
    # MAGMA beats (or ties) a naive round robin over the submeshes
    A = len(eng.submeshes)
    rr = [list(range(a, len(jobs), A)) for a in range(A)]
    naive = simulate_numpy(rr, out["table"].lat, out["table"].bw,
                           eng.system_bw)
    assert out["makespan_s"] <= naive * 1.02


def test_schedule_rejects_missing_prompts_and_unknown_methods(tenants):
    _, eng = _engines(tenants)
    jobs = eng.jobs_for_requests(REQUESTS[:1])
    with pytest.raises(ValueError, match="prompts"):
        eng.schedule(jobs, execute=True)
    with pytest.raises(ValueError, match="unknown strategy"):
        eng.schedule(jobs, method="no_such_method")


def test_execute_gives_the_reference_tokens(tenants):
    jeng, eng = _engines(tenants)
    jjobs, jobs = jeng.jobs_for_requests(REQUESTS), \
        eng.jobs_for_requests(REQUESTS)
    prompts = _prompts(jobs)
    out = eng.schedule(jobs, execute=True, prompts=prompts)
    decode_uids = sorted(j.uid for j in jobs if j.phase == "decode")
    assert sorted(out["outputs"]) == decode_uids
    want = jeng.execute(jjobs, out["queues"], prompts)
    assert sorted(want) == decode_uids
    for uid in decode_uids:
        job = next(j for j in jobs if j.uid == uid)
        assert out["outputs"][uid].shape == (1, job.tokens)
        np.testing.assert_array_equal(out["outputs"][uid], want[uid])


def test_kernel_and_plain_scan_give_equal_tokens(tenants):
    _, flash, plain = tenants
    outs = []
    for tlist in (flash, plain):
        eng = engine.MultiTenantEngine(tlist, device="cpu", **ENGINE_KW)
        jobs = eng.jobs_for_requests(REQUESTS[:2])
        outs.append(eng.schedule(jobs, execute=True,
                                 prompts=_prompts(jobs, 1))["outputs"])
    assert sorted(outs[0]) == sorted(outs[1])
    for uid in outs[0]:
        np.testing.assert_array_equal(outs[0][uid], outs[1][uid])


def test_execute_equals_a_plain_greedy_decode(tenants):
    """The engine's tokens for one request equal a prefill and greedy
    decode run without the engine."""
    _, flash, _ = tenants
    eng = engine.MultiTenantEngine(flash, device="cpu", **ENGINE_KW)
    jobs = eng.jobs_for_requests([("zamba2-1.2b", 12, 6)])
    prompts = _prompts(jobs, 2)
    out = eng.schedule(jobs, execute=True, prompts=prompts)
    toks = np.concatenate([out["outputs"][j.uid] for j in jobs
                           if j.phase == "decode"], axis=1)
    model = eng.tenants["zamba2-1.2b"].model
    logits, cache = model.prefill(
        {"tokens": torch.as_tensor(prompts[jobs[0].uid]).long()}, 18)
    cur = torch.argmax(logits[:, -1], -1)[:, None]
    want = []
    for pos in range(12, 18):
        logits, cache = model.decode_step(cache, cur, pos)
        cur = torch.argmax(logits[:, -1], -1)[:, None]
        want.append(int(cur[0, 0]))
    np.testing.assert_array_equal(toks[0], np.array(want))


def test_tenant_slo_strictest():
    with pytest.raises(ValueError, match="priority"):
        engine.TenantSLO(priority="gold")
    with pytest.raises(ValueError, match="deadline_s"):
        engine.TenantSLO(deadline_s=0.0)
    from repro.stream.workloads import PRIORITY_CLASSES
    assert engine.PRIORITY_CLASSES == PRIORITY_CLASSES
    tenants = []
    for arch, slo in zip(ARCHS, (engine.TenantSLO("batch", 9.0),
                                 engine.TenantSLO("urgent", 2.5))):
        cfg = get_smoke_config(arch)
        tenants.append(engine.Tenant(arch, cfg,
                                     get_model(cfg, device="meta"), slo))
    eng = engine.MultiTenantEngine(tenants, device="cpu")
    jobs = eng.jobs_for_requests([(ARCHS[0], 8, 2), (ARCHS[1], 8, 2)])
    slo = eng.slo_for(jobs)
    assert slo.priority == "urgent" and slo.deadline_s == 2.5
    slo0 = eng.slo_for([j for j in jobs if j.tenant == ARCHS[0]])
    assert slo0.priority == "batch" and slo0.deadline_s == 9.0
    assert eng.slo_for([]) == engine.TenantSLO()


# ---------------------------------------------------------------------------
# dense and MoE tenants beside an SSM one (the serving launcher's mix)
# ---------------------------------------------------------------------------
def test_mixed_jobs_and_analyze_tables_bitwise(mixed):
    jeng, eng = mixed
    jjobs, jobs = jeng.jobs_for_requests(MIXED_REQUESTS), \
        eng.jobs_for_requests(MIXED_REQUESTS)
    assert [vars(j) for j in jobs] == [vars(j) for j in jjobs]
    jtab, tab = jeng.analyze(jjobs), eng.analyze(jobs)
    for name in ("lat", "bw", "energy", "flops"):
        got, want = getattr(tab, name), getattr(jtab, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("method", ["herald_like", "ai_mt_like"])
def test_heuristic_schedules_equal_the_reference(mixed, method):
    jeng, eng = mixed
    jjobs, jobs = jeng.jobs_for_requests(MIXED_REQUESTS * 2), \
        eng.jobs_for_requests(MIXED_REQUESTS * 2)
    want, got = jeng.schedule(jjobs, method=method), \
        eng.schedule(jobs, method=method)
    assert got["queues"] == want["queues"]
    assert got["local_queues"] == want["local_queues"]
    assert got["makespan_s"] == want["makespan_s"]
    assert got["throughput_flops"] == want["throughput_flops"]


def test_mixed_execute_gives_the_reference_tokens(mixed):
    jeng, eng = mixed
    jjobs, jobs = jeng.jobs_for_requests(MIXED_REQUESTS), \
        eng.jobs_for_requests(MIXED_REQUESTS)
    prompts = _prompts(jobs, 3)
    out = eng.schedule(jobs, execute=True, prompts=prompts)
    want = jeng.execute(jjobs, out["queues"], prompts)
    decode_uids = sorted(j.uid for j in jobs if j.phase == "decode")
    assert sorted(out["outputs"]) == sorted(want) == decode_uids
    for uid in decode_uids:
        np.testing.assert_array_equal(out["outputs"][uid], want[uid])


def test_schedule_front_serves_the_frontier(mixed):
    """As the reference's ``tests/test_serve.py`` checks its own: the
    profile table carries a real energy column, and ``schedule_front``
    returns a non-dominated set of complete schedules."""
    from repro_torch.core.pareto import non_dominated_mask

    _, eng = mixed
    reqs = [("granite-3-2b", 128, 8)] * 3 + [("falcon-mamba-7b", 64, 8)] * 3
    jobs = eng.jobs_for_requests(reqs)
    table = eng.analyze(jobs)
    assert table.energy is not None and (table.energy > 0).all()
    subs = [s.name for s in eng.submeshes]
    tp16, tp4 = subs.index("tp16_a"), subs.index("tp4_a")
    assert (table.lat[:, tp16] < table.lat[:, tp4]).all()
    assert (table.energy[:, tp16] > table.energy[:, tp4]).all()

    out = eng.schedule_front(jobs)
    front = out["front"]
    assert front.names == ("latency", "energy", "edp")
    assert len(front) >= 1 and len(out["points"]) == len(front)
    assert non_dominated_mask(front.objectives).all()
    all_uids = sorted(j.uid for j in jobs)
    for pt in out["points"]:
        assert sorted(u for q in pt["queues"] for u in q) == all_uids
        assert pt["makespan_s"] > 0 and np.isfinite(pt["makespan_s"])
        assert set(pt["objectives"]) == {"latency", "energy", "edp"}
    with pytest.raises(ValueError, match="single-objective"):
        eng.schedule_front(jobs, method="magma")
