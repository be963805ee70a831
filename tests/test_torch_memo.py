"""Port parity: the schedule memo (``repro_torch.memo``) and the warm-start
seeding of the strategies.

Against the reference on the same inputs: ``scenario_digest``,
``family_key`` (the port's CPU route against the reference's
``use_kernel=False``), ``feature_vector`` and ``objective_token`` give
the same bytes; the donor guard picks the same donor and makes the same
accept/refuse decision on the same records; ``seed_population`` is
bitwise the reference's given the reference's normal draws; and a store
directory written by either package opens in the other with equal
records.  ``search_fingerprint`` must differ from the reference's (the
port hashes its seed under a backend tag, the reference its key words)
and between the CPU and the card route.

The port's own guarantees, held bitwise on the CPU as
``tests/test_memo.py`` holds the reference's: an exact hit replays the
stored row; ``run_sweep(memo=...)`` records rows equal to the standalone
searches; a warm-seeded search differs from the cold one only in its
initial population (every row's generator leaves ``init`` in the state a
cold init leaves it in, and the host-stepped loop equals the device
loop); zero jitter is a pure transfer.  No pinned constants of the
reference's tests are used.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.core.fitness import FitnessFn as RefFitnessFn  # noqa: E402
from repro.core.fitness import ObjectiveSpec as RefObjectiveSpec  # noqa: E402
from repro.core.fitness import objective_token as ref_token  # noqa: E402
from repro.core.job_analyzer import table_from_arrays as ref_table  # noqa: E402
from repro.core.m3e import M3E as RefM3E  # noqa: E402
from repro.core.magma import MagmaConfig as RefMagmaConfig  # noqa: E402
from repro.core.strategies import MagmaStrategy as RefMagma  # noqa: E402
from repro.core.strategies import run_strategy as ref_run  # noqa: E402
from repro.core.strategies.base import seed_population as ref_seed_pop  # noqa: E402
from repro.costmodel import get_setting as ref_setting  # noqa: E402
from repro import memo as ref_memo  # noqa: E402
from repro.workloads import build_task_groups as ref_groups  # noqa: E402
from repro_torch.core import M3E  # noqa: E402
from repro_torch.core.encoding import (Population,  # noqa: E402
                                       random_population, row_generators)
from repro_torch.core.fitness import (FitnessFn, ObjectiveSpec,  # noqa: E402
                                      objective_token)
from repro_torch.core.job_analyzer import table_from_arrays  # noqa: E402
from repro_torch.core.magma import MagmaConfig, magma_search  # noqa: E402
from repro_torch.core.strategies import (MagmaStrategy,  # noqa: E402
                                         NSGA2Strategy, WarmStart,
                                         get_strategy, run_strategy,
                                         seed_population)
from repro_torch.core.strategies.driver import rows_hand_off  # noqa: E402
from repro_torch.core.sweep import SweepConfig, run_rows, run_sweep  # noqa: E402
from repro_torch.costmodel import GB, get_setting  # noqa: E402
from repro_torch.memo import (MemoLayoutError, MemoRecord,  # noqa: E402
                              MemoStore, ScheduleMemo, family_key,
                              feature_vector, row_view, scenario_digest)
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.workloads import build_task_groups  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = 300
CFG = MagmaConfig(population=20)
REF_CFG = RefMagmaConfig(population=20)


def _arrays(seed, G, A):
    """The reference test's synthetic scenario recipe
    (``tests/test_memo.py::_fitness``)."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(1e-4, 5e-3, size=(G, A))
    bw = rng.uniform(1e8, 2e9, size=(G, A))
    energy = rng.uniform(1e-3, 1e-1, size=(G, A))
    return lat, bw, rng.uniform(1e9, 1e10, size=G), energy


def _pair(seed=0, G=12, A=3, bw_sys=2.0, objective="throughput"):
    """(port FitnessFn on the CPU, reference FitnessFn) on the same
    tables."""
    lat, bw, flops, energy = _arrays(seed, G, A)
    return (FitnessFn(table_from_arrays(lat, bw, flops, energy),
                      bw_sys=bw_sys * GB, objective=objective, device="cpu"),
            RefFitnessFn(ref_table(lat, bw, flops, energy),
                         bw_sys=bw_sys * GB, objective=objective))


def _fitness(**kw):
    return _pair(**kw)[0]


def _strategy():
    return MagmaStrategy(cfg=CFG)


def _assert_same_result(a, b):
    assert a.best_fitness == b.best_fitness
    for name in ("best_accel", "best_prio", "history_best"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


# ---------------------------------------------------------------------------
# fingerprints against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("objective", ["throughput", "edp",
                                       ("latency", "energy")])
@pytest.mark.parametrize("seed,G,A", [(0, 12, 3), (5, 24, 8)])
def test_digest_family_features_byte_equal_reference(objective, seed, G, A):
    port, ref = _pair(seed=seed, G=G, A=A, objective=objective)
    s, rs = _strategy().bind(A), RefMagma(cfg=REF_CFG).bind(A)
    assert scenario_digest(port.params, num_accels=A, use_kernel=False,
                           objective=port.objective) == \
        ref_memo.scenario_digest(ref.params, num_accels=A, use_kernel=False,
                                 objective=ref.objective)
    for fam in ("", "Mix"):
        assert family_key(port.params, s, use_kernel=False,
                          objective=port.objective, family=fam) == \
            ref_memo.family_key(ref.params, rs, use_kernel=False,
                                objective=ref.objective, family=fam)
    got, want = feature_vector(port.params), ref_memo.feature_vector(
        ref.params)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("objective", [
    None, "throughput", "edp", ("latency",), ("latency", "energy", "edp")])
def test_objective_token_equals_reference(objective):
    assert objective_token(objective) == ref_token(objective)
    if objective is not None:
        names = (objective,) if isinstance(objective, str) else objective
        assert objective_token(ObjectiveSpec(tuple(names))) == \
            ref_token(RefObjectiveSpec(tuple(names)))


def test_search_fingerprint_differs_from_reference_and_across_routes():
    port, ref = _pair(seed=2)
    fp = ScheduleMemo().fingerprint(port, _strategy(), BUDGET, 0)
    assert fp != ref_memo.ScheduleMemo().fingerprint(
        ref, RefMagma(cfg=REF_CFG), BUDGET, 0)
    card = row_view(port.params, num_accels=3, objective=port.objective,
                    device="cuda")
    cpu = row_view(port.params, num_accels=3, objective=port.objective,
                   device="cpu")
    memo = ScheduleMemo()
    assert memo.fingerprint(cpu, _strategy(), BUDGET, 0) == fp
    assert memo.fingerprint(card, _strategy(), BUDGET, 0) != fp
    s = _strategy().bind(3)
    assert family_key(port.params, s, use_kernel=True,
                      objective="throughput") != \
        family_key(port.params, s, use_kernel=False, objective="throughput")


def test_fingerprint_exactness_and_sensitivity():
    memo = ScheduleMemo()
    fit = _fitness(seed=0)
    s = _strategy()
    fp = memo.fingerprint(fit, s, BUDGET, 0)
    assert fp == memo.fingerprint(_fitness(seed=0), s, BUDGET, 0)
    assert fp == memo.fingerprint(fit, s, BUDGET, np.int64(0))
    # seed, tables, protocol, strategy config: each changes the address
    assert fp != memo.fingerprint(fit, s, BUDGET, 1)
    assert fp != memo.fingerprint(_fitness(seed=1), s, BUDGET, 0)
    assert fp != memo.fingerprint(fit, s, BUDGET + CFG.population, 0)
    assert fp != memo.fingerprint(
        fit, MagmaStrategy(cfg=MagmaConfig(population=20, elite_frac=0.2)),
        BUDGET, 0)
    assert fp != memo.fingerprint(fit, get_strategy("de", population=20),
                                  BUDGET, 0)
    # budgets planning to the same (generations, evolve_last) share it
    assert memo.fingerprint(fit, s, BUDGET + 1, 0) == \
        memo.fingerprint(fit, s, BUDGET + 19, 0)
    for bad in (np.asarray(jax.random.PRNGKey(0)), 0.0, True):
        with pytest.raises(TypeError, match="seed"):
            memo.fingerprint(fit, s, BUDGET, bad)


# ---------------------------------------------------------------------------
# the persistent store
# ---------------------------------------------------------------------------
def _rec(fp, family=("fam",), n=64, meta=None, cls=MemoRecord):
    rng = np.random.default_rng(sum(fp.encode()))
    return cls(fingerprint=fp, family=family,
               arrays={"best_fitness": np.float32(rng.uniform()),
                       "best_accel": rng.integers(0, 4, size=n)
                       .astype(np.int32),
                       "pop_accel": rng.integers(0, 4, size=(4, n))
                       .astype(np.int32),
                       "pop_prio": rng.uniform(size=(4, n))
                       .astype(np.float32)},
               meta=meta or {"k": 1})


def _assert_same_records(a, b):
    assert sorted(r for r in _fps(a)) == sorted(r for r in _fps(b))
    for fp in _fps(a):
        ra, rb = a.get(fp), b.get(fp)
        assert rb is not None and ra.meta == rb.meta
        assert tuple(ra.family) == tuple(rb.family)
        assert sorted(ra.arrays) == sorted(rb.arrays)
        for k in ra.arrays:
            np.testing.assert_array_equal(ra.arrays[k], rb.arrays[k])
            assert np.asarray(ra.arrays[k]).dtype == \
                np.asarray(rb.arrays[k]).dtype


def _fps(store):
    return list(store._records)


def test_store_roundtrip(tmp_path):
    path = str(tmp_path / "memo")
    st = MemoStore(path)
    for i in range(5):
        st.put(_rec(f"fp{i}", family=("fam", i % 2)))
    st2 = MemoStore(path)
    assert len(st2) == 5
    _assert_same_records(st, st2)
    assert {r.fingerprint for r in st2.family(("fam", 0))} == \
        {"fp0", "fp2", "fp4"}
    st2.discard("fp0")
    assert "fp0" not in st2 and len(st2) == 4
    assert "fp0" not in MemoStore(path)   # tombstone persisted


def test_store_lru_eviction_and_compaction(tmp_path):
    path = str(tmp_path / "memo")
    one = _rec("probe").nbytes
    st = MemoStore(path, byte_budget=3 * one)
    for i in range(3):
        st.put(_rec(f"fp{i}"))
    st.get("fp0")                         # refresh fp0's recency
    st.put(_rec("fp3"))                   # evicts fp1 (LRU), not fp0
    assert "fp0" in st and "fp1" not in st
    assert st.total_bytes <= 3 * one
    st.compact()
    with open(os.path.join(path, "index.jsonl")) as f:
        lines = [ln for ln in f if ln.strip()]
    assert len(lines) == len(st) == 3
    assert not os.path.exists(os.path.join(path, "payload", "fp1.npz"))
    assert sorted(r.fingerprint for r in MemoStore(path).family(("fam",))) \
        == ["fp0", "fp2", "fp3"]


def test_store_cross_process_append_and_refresh(tmp_path):
    path = str(tmp_path / "memo")
    st = MemoStore(path)
    st.put(_rec("local"))
    code = textwrap.dedent(f"""
        import numpy as np
        from repro_torch.memo import MemoRecord, MemoStore
        st = MemoStore({path!r})
        assert "local" in st               # sees the parent's record
        st.put(MemoRecord(fingerprint="remote", family=("fam",),
                          arrays={{"x": np.arange(8)}}, meta={{}}))
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert "remote" not in st             # not yet folded in
    st.refresh()
    assert "remote" in st
    np.testing.assert_array_equal(st.get("remote").arrays["x"], np.arange(8))


def test_store_refresh_survives_interleaved_appends(tmp_path):
    path = str(tmp_path / "memo")
    b = MemoStore(path)
    a = MemoStore(path)
    a.put(_rec("from-a"))
    b.put(_rec("from-b"))
    assert "from-a" not in b
    b.refresh()
    assert "from-a" in b and "from-b" in b
    a.refresh()
    assert "from-b" in a


def test_store_refresh_survives_foreign_compaction(tmp_path):
    path = str(tmp_path / "memo")
    a, b = MemoStore(path), MemoStore(path)
    a.put(_rec("r0"))
    a.put(_rec("r1"))
    a.discard("r0")
    b.refresh()
    assert "r1" in b and "r0" not in b
    a.compact()                           # index replaced, smaller file
    a.put(_rec("r2"))
    b.refresh()                           # inode changed: rebuild
    assert "r2" in b and "r1" in b and "r0" not in b
    # a stale compaction lock (dead process) must not disable compaction
    lock = os.path.join(path, "compact.lock")
    open(lock, "w").close()
    os.utime(lock, (1, 1))
    a.compact()
    assert not os.path.exists(lock)
    assert "r2" in MemoStore(path)


def test_store_refuses_the_sharded_layout(tmp_path):
    path = tmp_path / "memo"
    path.mkdir()
    (path / "memo_layout.json").write_text('{"version": 2, "shards": 16}')
    with pytest.raises(MemoLayoutError, match="v2"):
        MemoStore(str(path))


def test_in_memory_store_has_no_disk():
    st = MemoStore()
    st.put(_rec("fp0"))
    assert "fp0" in st and st.path is None
    st.compact()
    assert st.refresh() == 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_directories_cross_packages(tmp_path, writer):
    """A directory either package writes (puts, an overwrite, a
    tombstone, a compaction) opens in the other with equal records."""
    path = str(tmp_path / "memo")
    cls, other = ((ref_memo.MemoStore, MemoStore) if writer == "reference"
                  else (MemoStore, ref_memo.MemoStore))
    rec = ref_memo.MemoRecord if writer == "reference" else MemoRecord
    st = cls(path)
    for i in range(4):
        st.put(_rec(f"fp{i}", family=("magma", 12, 3, False, "throughput",
                                       "Mix" if i % 2 else ""), cls=rec))
    st.put(_rec("fp1", meta={"k": 2}, cls=rec))
    st.discard("fp2")
    st.compact()
    st.put(_rec("fp9", cls=rec))
    _assert_same_records(st, other(path))


def test_memo_records_cross_packages(tmp_path):
    """A ScheduleMemo recording into a reference-written directory keeps
    the reference's records readable by the reference, and the port's
    records carry the reference's array names and meta keys."""
    path = str(tmp_path / "memo")
    port, ref = _pair(seed=3)
    ref_res = ref_run(RefMagma(cfg=REF_CFG), ref, budget=BUDGET, seed=0,
                      keep_population=True)
    ref_memo.ScheduleMemo(ref_memo.MemoStore(path)).record(
        ref, RefMagma(cfg=REF_CFG), BUDGET, 0, ref_res,
        population=ref_res.final_population, family="Light")
    res = run_strategy(_strategy(), port, budget=BUDGET, seed=0,
                       keep_population=True, device="cpu")
    memo = ScheduleMemo(MemoStore(path))
    memo.record(port, _strategy(), BUDGET, 0, res,
                population=res.final_population, family="Light")
    back = ref_memo.MemoStore(path)
    assert len(back) == 2
    recs = back.family(ref_memo.family_key(
        ref.params, RefMagma(cfg=REF_CFG).bind(3), use_kernel=False,
        objective="throughput", family="Light"))
    assert len(recs) == 2                 # one family: tables + route equal
    a, b = recs
    assert sorted(a.arrays) == sorted(b.arrays)
    assert sorted(a.meta) == sorted(b.meta)
    np.testing.assert_array_equal(a.features, b.features)


# ---------------------------------------------------------------------------
# exact hit: bitwise replay
# ---------------------------------------------------------------------------
def test_memo_exact_hit_replays_bitwise():
    memo = ScheduleMemo()
    memo.tracer = Tracer()
    fit = _fitness(seed=3)
    s = _strategy()
    ref = run_strategy(s, fit, budget=BUDGET, seed=5, keep_population=True,
                       device="cpu")
    memo.record(fit, s, BUDGET, 5, ref, population=ref.final_population)
    hit = memo.lookup(fit, s, BUDGET, 5)
    assert hit is not None and not hit.warm_seeded
    res = hit.to_search_result()
    _assert_same_result(res, ref)
    np.testing.assert_array_equal(res.history_samples, ref.history_samples)
    assert res.n_samples == ref.n_samples and res.wall_time_s == 0.0
    np.testing.assert_array_equal(res.final_population.accel,
                                  ref.final_population.accel.numpy())
    assert memo.lookup(fit, s, BUDGET, 6) is None          # other seed
    assert memo.stats.exact_hits == 1 and memo.stats.misses == 1
    spans = [(sp.name, (sp.args or {}).get("outcome"))
             for sp in memo.tracer.spans()]
    assert spans == [("memo.record", None), ("memo.lookup", "hit"),
                     ("memo.lookup", "miss")]


@pytest.mark.parametrize("chunk_rows", [None, 3])
def test_run_sweep_records_rows_standalone_identical(chunk_rows):
    memo = ScheduleMemo()
    fns = [_fitness(seed=i, bw_sys=b) for i, b in enumerate((1.0, 16.0))]
    seeds = [0, 3]
    res = run_sweep(fns, budget=BUDGET, seeds=seeds, cfg=CFG, memo=memo,
                    memo_family=["a", "b"],
                    sweep=SweepConfig(chunk_rows=chunk_rows), device="cpu")
    assert len(memo) == 4 and memo.stats.records == 4
    for i, fn in enumerate(fns):
        for k, seed in enumerate(seeds):
            hit = memo.lookup(fn, _strategy(), BUDGET, seed)
            assert hit is not None and hit.population is not None
            assert hit.best_fitness == res.best_fitness[i, k]
            np.testing.assert_array_equal(hit.best_accel,
                                          res.best_accel[i, k])
            np.testing.assert_array_equal(hit.best_prio, res.best_prio[i, k])
            np.testing.assert_array_equal(hit.history_best,
                                          res.history_best[i, k])
            alone = magma_search(fn, budget=BUDGET, cfg=CFG, seed=seed,
                                 device="cpu", keep_population=True)
            _assert_same_result(hit.to_search_result(), alone)
            np.testing.assert_array_equal(hit.population[0],
                                          alone.final_population.accel)
            np.testing.assert_array_equal(hit.population[1],
                                          alone.final_population.prio)
        # the family tags came through, one per scenario
        assert memo.warm_start(fns[i], _strategy(), family="ab"[i]) \
            is not None
    with pytest.raises(ValueError, match="memo_family"):
        run_sweep(fns, budget=BUDGET, cfg=CFG, memo=memo,
                  memo_family=["a"], device="cpu")


def test_sweep_records_no_population_for_strategies_without_hand_off():
    memo = ScheduleMemo()
    fns = [_fitness(seed=i) for i in range(2)]
    res = run_sweep(fns, budget=BUDGET, seeds=[1], strategy="de", memo=memo,
                    device="cpu")
    hit = memo.lookup(fns[1], get_strategy("de"), BUDGET, 1)
    assert hit is not None and hit.population is None
    assert hit.best_fitness == res.best_fitness[1, 0]


def test_m3e_memo_search_and_replay():
    memo = ScheduleMemo()
    m3e = M3E(get_setting("S2"), bw_sys=1 * GB, memo=memo, device="cpu")
    group = build_task_groups("Lang", group_size=12, seed=0)[0]
    cold = M3E(get_setting("S2"), bw_sys=1 * GB, device="cpu").search(
        group, budget=BUDGET, seed=0, strategy_kwargs={"cfg": CFG})
    r1 = m3e.search(group, budget=BUDGET, seed=0,
                    strategy_kwargs={"cfg": CFG})
    _assert_same_result(r1, cold)          # empty memo: the cold search
    r2 = m3e.search(group, budget=BUDGET, seed=0,
                    strategy_kwargs={"cfg": CFG})
    assert r2.wall_time_s == 0.0
    _assert_same_result(r2, r1)
    assert memo.stats.exact_hits == 1
    # a fresh memo over the same store hits too
    again = M3E(get_setting("S2"), bw_sys=1 * GB, device="cpu",
                memo=ScheduleMemo(memo.store)).search(
        group, budget=BUDGET, seed=0, strategy_kwargs={"cfg": CFG})
    _assert_same_result(again, r1)
    assert again.wall_time_s == 0.0


def test_m3e_explicit_init_population_bypasses_memo():
    memo = ScheduleMemo()
    m3e = M3E(get_setting("S2"), bw_sys=1 * GB, memo=memo, device="cpu")
    group = build_task_groups("Lang", group_size=12, seed=0)[0]
    fit = m3e.prepare(group)
    gen = torch.Generator()
    gen.manual_seed(42)
    pop = random_population(gen, CFG.population, fit.group_size,
                            fit.num_accels, "cpu")
    seeded = m3e.search(group, budget=BUDGET, seed=0,
                        strategy_kwargs={"cfg": CFG}, init_population=pop)
    assert len(memo) == 0 and memo.stats.records == 0
    plain = m3e.search(group, budget=BUDGET, seed=0,
                       strategy_kwargs={"cfg": CFG})
    cold = M3E(get_setting("S2"), bw_sys=1 * GB, device="cpu").search(
        group, budget=BUDGET, seed=0, strategy_kwargs={"cfg": CFG})
    _assert_same_result(plain, cold)
    assert seeded.history_best[0] != cold.history_best[0]


def test_m3e_search_front_through_the_memo():
    memo = ScheduleMemo()
    m3e = M3E(get_setting("S2"), bw_sys=1 * GB, memo=memo, device="cpu")
    group = build_task_groups("Mix", group_size=12, seed=0)[0]
    plain = M3E(get_setting("S2"), bw_sys=1 * GB, device="cpu").search_front(
        group, budget=200, seed=0, strategy_kwargs={"population": 20})
    f1 = m3e.search_front(group, budget=200, seed=0,
                          strategy_kwargs={"population": 20})
    f2 = m3e.search_front(group, budget=200, seed=0,
                          strategy_kwargs={"population": 20})
    for f in (f1, f2):
        np.testing.assert_array_equal(f.objectives, plain.objectives)
        np.testing.assert_array_equal(f.accel, plain.accel)
    assert f2.wall_time_s == 0.0 and memo.stats.exact_hits == 1


# ---------------------------------------------------------------------------
# near hit: warm-start transfer in init
# ---------------------------------------------------------------------------
def test_warm_start_returned_only_for_matching_family():
    memo = ScheduleMemo()
    fit = _fitness(seed=0)
    s = _strategy()
    ref = run_strategy(s, fit, budget=BUDGET, seed=0, keep_population=True,
                       device="cpu")
    memo.record(fit, s, BUDGET, 0, ref, population=ref.final_population,
                family="Light")
    sib = _fitness(seed=7)                 # same (G, A), other tables
    ws = memo.warm_start(sib, s, family="Light")
    assert isinstance(ws, WarmStart)
    assert ws.accel.shape == (s.ask_size, fit.group_size)
    assert ws.accel.dtype == np.int32 and ws.prio.dtype == np.float32
    assert memo.warm_start(sib, s, family="Heavy") is None
    assert memo.warm_start(_fitness(G=8), s, family="Light") is None
    assert memo.warm_start(sib, get_strategy("de"), family="Light") is None
    assert ScheduleMemo(memo.store, near=False).warm_start(
        sib, s, family="Light") is None
    # the card route is another family: a CPU row never seeds it
    card = row_view(sib.params, num_accels=3, objective="throughput",
                    device="cuda")
    assert memo.warm_start(card, s, family="Light") is None
    # a larger ask size tiles the donor's rows
    big = memo.warm_start(sib, MagmaStrategy(MagmaConfig(population=50)),
                          family="Light")
    assert big.accel.shape == (50, 12)
    np.testing.assert_array_equal(big.accel[20:40], big.accel[:20])


def test_warm_seeded_search_differs_only_in_init_population():
    memo = ScheduleMemo()
    fit = _fitness(seed=0)
    s = _strategy()
    ref = run_strategy(s, fit, budget=BUDGET * 3, seed=0,
                       keep_population=True, device="cpu")
    memo.record(fit, s, BUDGET * 3, 0, ref, population=ref.final_population,
                family="Light")
    sib = _fitness(seed=9)
    ws = memo.warm_start(sib, s, family="Light")
    warm = run_strategy(s, sib, budget=BUDGET, seed=1, init_population=ws,
                        device="cpu")
    cold = run_strategy(s, sib, budget=BUDGET, seed=1, device="cpu")
    again = run_strategy(s, sib, budget=BUDGET, seed=1, init_population=ws,
                         device="cpu")
    _assert_same_result(warm, again)
    loop = run_strategy(s, sib, budget=BUDGET, seed=1, init_population=ws,
                        engine="loop", device="cpu")
    _assert_same_result(warm, loop)
    assert warm.history_best[0] != cold.history_best[0]


@pytest.mark.parametrize("kind", ["magma", "nsga2"])
@pytest.mark.parametrize("hand_off", ["warm", "population"])
def test_generators_after_init_same_warm_and_cold(kind, hand_off):
    """The RNG invariant: whatever ``init`` is handed, every row's
    generator leaves it in the state a cold init leaves it in."""
    fit = _fitness(seed=1)
    s = (MagmaStrategy(CFG) if kind == "magma"
         else NSGA2Strategy(pop_size=20)).bind(3)
    rows = FitnessParams_rows(fit, 2)
    seeds = [4, 11]
    cold_gens = row_generators(seeds, "cpu")
    s.init(cold_gens, rows)
    rng = np.random.default_rng(0)
    accel = rng.integers(0, 3, (2, 20, 12)).astype(np.int32)
    prio = rng.random((2, 20, 12)).astype(np.float32)
    if hand_off == "warm":
        hand = WarmStart(accel=torch.as_tensor(accel),
                         prio=torch.as_tensor(prio),
                         jitter=torch.tensor([0.02, 0.5]))
    else:
        hand = Population(torch.as_tensor(accel), torch.as_tensor(prio))
    warm_gens = row_generators(seeds, "cpu")
    state = s.init(warm_gens, rows, init_population=hand)
    for a, b in zip(cold_gens, warm_gens):
        assert torch.equal(a.get_state(), b.get_state())
    if kind == "magma" and hand_off == "population":
        assert torch.equal(state.accel, hand.accel)
        assert torch.equal(state.prio, hand.prio)


def FitnessParams_rows(fit, R):
    from repro_torch.core.fitness import FitnessParams
    return FitnessParams(*(torch.stack([t] * R) for t in fit.params))


def test_sweep_warm_rows_equal_standalone_warm_runs():
    """``run_rows(warm=...)``: every row, seeded with its own WarmStart,
    equals the standalone run_strategy with that WarmStart, chunked with
    a partial last chunk."""
    fns = [_fitness(seed=i) for i in range(3)]
    s = _strategy().bind(3)
    rng = np.random.default_rng(5)
    warm = WarmStart(accel=rng.integers(0, 3, (3, 20, 12)).astype(np.int32),
                     prio=rng.random((3, 20, 12)).astype(np.float32),
                     jitter=np.float32(0.05))
    from repro_torch.core.fitness import stack_fitness_params
    seeds = [7, 8, 9]
    rr = run_rows(stack_fitness_params(fns), seeds, strategy=s,
                  generations=BUDGET // 20, evolve_last=False,
                  objective=fns[0].objective_spec,
                  sweep=SweepConfig(chunk_rows=2), warm=warm, device="cpu")
    for i, fn in enumerate(fns):
        one = WarmStart(warm.accel[i], warm.prio[i], warm.jitter)
        alone = run_strategy(s, fn, budget=BUDGET, seed=seeds[i],
                             init_population=one, device="cpu")
        assert rr.best_fitness[i] == alone.best_fitness
        np.testing.assert_array_equal(rr.best_accel[i], alone.best_accel)
        np.testing.assert_array_equal(rr.history_best[i], alone.history_best)


def test_zero_jitter_warm_start_is_pure_transfer():
    memo = ScheduleMemo(jitter=0.0)
    fit = _fitness(seed=4)
    s = _strategy()
    ref = run_strategy(s, fit, budget=BUDGET, seed=0, keep_population=True,
                       device="cpu")
    memo.record(fit, s, BUDGET, 0, ref, population=ref.final_population,
                family="x")
    ws = memo.warm_start(fit, s, family="x")
    hand = rows_hand_off(ws, "cpu")
    state = s.bind(3).init(row_generators([2], "cpu"),
                           FitnessParams_rows(fit, 1), init_population=hand)
    assert torch.equal(state.accel[0], ref.final_population.accel)
    assert torch.equal(state.prio[0], torch.clamp(ref.final_population.prio,
                                                  0.0, 0.999))
    warm = run_strategy(s, fit, budget=BUDGET, seed=2, init_population=ws,
                        device="cpu")
    assert warm.history_best[0] >= ref.best_fitness


@pytest.mark.parametrize("shape", [(20, 12), (3, 20, 12), (100, 100)])
@pytest.mark.parametrize("jitter", [0.02, 0.0, 0.5])
def test_seed_population_bitwise_reference(shape, jitter):
    """With the reference's normal draws injected, the port's warm seed
    is the reference's bit for bit (accel clipped to A-1, prio clipped to
    [0, 0.999])."""
    A = 4
    rng = np.random.default_rng(len(shape) * 7 + int(jitter * 100))
    accel = rng.integers(0, A + 2, shape).astype(np.int32)
    prio = rng.random(shape).astype(np.float32)
    prio.reshape(-1)[:3] = [0.999, 0.9995, 0.0]
    key = jax.random.PRNGKey(shape[0])
    ra, rp = ref_seed_pop(accel, prio, np.float32(jitter), key, A)
    # lint: disable=L001(the port must be fed the very draws of this key)
    noise = np.array(jax.random.normal(key, prio.shape))
    pa, pp = seed_population(torch.as_tensor(accel), torch.as_tensor(prio),
                             np.float32(jitter), torch.as_tensor(noise), A)
    assert pa.dtype == torch.int32 and pp.dtype == torch.float32
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))


# ---------------------------------------------------------------------------
# the donor-distance guard, against the reference's decisions
# ---------------------------------------------------------------------------
def _decide(memo, fit, strategy, family):
    ws = memo.warm_start(fit, strategy, family=family)
    return None if ws is None else (np.asarray(ws.accel), np.asarray(ws.prio))


def _same_decision(port_memo, ref_memo_, port_fit, ref_fit, family):
    got = _decide(port_memo, port_fit, _strategy(), family)
    want = _decide(ref_memo_, ref_fit, RefMagma(cfg=REF_CFG), family)
    assert (got is None) == (want is None)
    if got is not None:                    # the same donor's rows
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    return got is not None


def _record_same_rows(port_memo, ref_memo_, pairs, family):
    """Record one row per scenario pair in both memos, with the same
    schedule and population arrays (so a chosen donor is identifiable
    by its rows)."""
    for i, (port, ref) in enumerate(pairs):
        rng = np.random.default_rng(100 + i)
        G = port.group_size
        row = {"best_fitness": np.float32(i + 1.0),
               "best_accel": rng.integers(0, 3, G).astype(np.int32),
               "best_prio": rng.random(G).astype(np.float32),
               "history_best": np.arange(3.0)}
        pop = (rng.integers(0, 3, (20, G)).astype(np.int32),
               rng.random((20, G)).astype(np.float32))
        port_memo.record(port, _strategy(), BUDGET, i, row, population=pop,
                         family=family)
        ref_memo_.record(ref, RefMagma(cfg=REF_CFG), BUDGET, i, row,
                         population=pop, family=family)


@pytest.mark.parametrize("max_dist", [ScheduleMemo.MAX_DONOR_DIST, 1.0, None])
def test_donor_guard_same_donor_and_decision_as_reference(max_dist):
    port_memo, ref_m = ScheduleMemo(max_donor_dist=max_dist), \
        ref_memo.ScheduleMemo(max_donor_dist=max_dist)
    donors = [_pair(seed=s, bw_sys=b) for s, b in ((0, 1.0), (1, 16.0),
                                                    (2, 4.0))]
    _record_same_rows(port_memo, ref_m, donors, "Light")
    accepted = 0
    for seed, bw in ((7, 1.0), (8, 64.0), (9, 4.0), (10, 0.1)):
        port, ref = _pair(seed=seed, bw_sys=bw)
        accepted += _same_decision(port_memo, ref_m, port, ref, "Light")
        best, d = port_memo.donor(port, _strategy(), "Light")
        dists = [np.linalg.norm(ref_memo.feature_vector(r.params)
                                - ref_memo.feature_vector(ref.params))
                 for _, r in donors]
        assert d == min(dists)
    assert port_memo.stats.near_hits == ref_m.stats.near_hits == accepted


def test_donor_guard_featureless_records_like_reference():
    """A population-only record sits at d = inf: both guards refuse it,
    and ``max_donor_dist=None`` donates it in both packages."""
    port, ref = _pair(seed=3)
    fam = family_key(port.params, _strategy().bind(3), use_kernel=False,
                     objective="throughput", family="NoFeat")
    arrays = {"pop_accel": np.zeros((4, 12), dtype=np.int32),
              "pop_prio": np.full((4, 12), 0.5, dtype=np.float32)}
    stores = (MemoStore(), ref_memo.MemoStore())
    stores[0].put(MemoRecord("featureless", fam, dict(arrays), {}))
    stores[1].put(ref_memo.MemoRecord("featureless", fam, dict(arrays), {}))
    for max_dist, want in ((ScheduleMemo.MAX_DONOR_DIST, False),
                           (None, True)):
        assert _same_decision(ScheduleMemo(stores[0],
                                           max_donor_dist=max_dist),
                              ref_memo.ScheduleMemo(stores[1],
                                                    max_donor_dist=max_dist),
                              port, ref, "NoFeat") is want


def test_mix_cross_group_guard_like_reference():
    """The case the guard exists for (``tests/test_memo.py:431-480``):
    a donor converged on Mix group 0 transfers to the same group one BW
    step away and is refused for group 2 at 1 GB/s, in both packages;
    the refused warm path is the cold search bitwise."""
    G, BUD, SHORT = 24, 600, 240
    strat, ref_strat = MagmaStrategy(MagmaConfig(population=30)), \
        RefMagma(RefMagmaConfig(population=30))
    groups = build_task_groups("Mix", group_size=G, num_groups=4, seed=0)
    rgroups = ref_groups("Mix", group_size=G, num_groups=4, seed=0)

    def fits(i, bw):
        return (M3E(get_setting("S2"), bw_sys=bw * GB,
                    device="cpu").prepare(groups[i]),
                RefM3E(ref_setting("S2"), bw_sys=bw * GB).prepare(rgroups[i]))

    donor, near, far = fits(0, 16), fits(0, 8), fits(2, 1)
    dv = feature_vector(donor[0].params)
    d_near = float(np.linalg.norm(feature_vector(near[0].params) - dv))
    d_far = float(np.linalg.norm(feature_vector(far[0].params) - dv))
    assert d_near <= ScheduleMemo.MAX_DONOR_DIST < d_far
    memo, rmemo = ScheduleMemo(), ref_memo.ScheduleMemo()
    res = run_strategy(strat, donor[0], budget=BUD, seed=0,
                       keep_population=True, device="cpu")
    memo.record(donor[0], strat, BUD, 0, res,
                population=res.final_population, family="Mix")
    rres = ref_run(ref_strat, donor[1], budget=BUD, seed=0,
                   keep_population=True)
    rmemo.record(donor[1], ref_strat, BUD, 0, rres,
                 population=rres.final_population, family="Mix")
    for port, ref, want in ((near[0], near[1], True), (far[0], far[1], False)):
        got = memo.warm_start(port, strat, family="Mix") is not None
        assert got is want
        assert (rmemo.warm_start(ref, ref_strat, family="Mix")
                is not None) is want
    assert memo.donor(far[0], strat, "Mix")[1] == pytest.approx(d_far)
    cold = run_strategy(strat, far[0], budget=SHORT, seed=13, device="cpu")
    same = run_strategy(strat, far[0], budget=SHORT, seed=13, device="cpu",
                        init_population=memo.warm_start(far[0], strat,
                                                        family="Mix"))
    _assert_same_result(same, cold)


def measure_near_hit_ratios(setting="S4", bw=256, G=100, budget=10_000,
                            short=1_000, seeds=tuple(range(8))):
    """Near hits through both packages on the CPU: Mix group 0's record
    (a ``budget``-sample search) offered to sibling groups 1-4.  Per
    sibling: the donor distance and the guard's outcome in each package;
    per seed of ``seeds``, the warm/cold best-fitness ratio of
    ``short``-sample searches in each package, seeded with its own donor
    and with the other package's donor (the same population through the
    other package's ``init``); the geomean of each column; and the
    geomean best fitness of the warm search's first generation (the
    transfer itself); and the spread: each column's standard deviation
    of log ratios, and the port/reference geomean ratio with a 95%
    interval (normal, unpaired: the packages' seeds draw other streams),
    each with its own donor and with the same donor.  Prints one line per
    seed and a few per sibling."""
    from repro.core.strategies import WarmStart as RefWarmStart
    from repro_torch.core.m3e import geomean
    groups = build_task_groups("Mix", group_size=G, num_groups=5, seed=0)
    rgroups = ref_groups("Mix", group_size=G, num_groups=5, seed=0)
    port = M3E(get_setting(setting), bw_sys=bw * GB, device="cpu")
    ref = RefM3E(ref_setting(setting), bw_sys=bw * GB)
    s, rs = MagmaStrategy(), RefMagma()
    memo, rmemo = ScheduleMemo(), ref_memo.ScheduleMemo()
    fit, rfit = port.prepare(groups[0]), ref.prepare(rgroups[0])
    res = run_strategy(s, fit, budget=budget, seed=0, keep_population=True,
                       device="cpu")
    memo.record(fit, s, budget, 0, res, population=res.final_population,
                family="Mix")
    rres = ref_run(rs, rfit, budget=budget, seed=0, keep_population=True)
    rmemo.record(rfit, rs, budget, 0, rres,
                 population=rres.final_population, family="Mix")
    for i in range(1, 5):
        fit, rfit = port.prepare(groups[i]), ref.prepare(rgroups[i])
        d = memo.donor(fit, s, "Mix")[1]
        ws, rws = (memo.warm_start(fit, s, family="Mix"),
                   rmemo.warm_start(rfit, rs, family="Mix"))
        print(f"{setting} {bw} GB/s Mix group {i}: donor distance {d:.4f}, "
              f"{'seeded' if ws is not None else 'refused'} (reference "
              f"{'seeded' if rws is not None else 'refused'})")
        if ws is None or rws is None:
            continue
        # each package's donor in the other's types
        ws_ref = RefWarmStart(accel=np.asarray(rws.accel, np.int32),
                              prio=np.asarray(rws.prio, np.float32),
                              jitter=np.float32(rws.jitter))
        rws_port = RefWarmStart(accel=ws.accel, prio=ws.prio,
                                jitter=ws.jitter)

        def port_best(n, init, k):
            return run_strategy(s, fit, budget=n, seed=k, device="cpu",
                                init_population=init).best_fitness

        def ref_best(n, init, k):
            return float(ref_run(rs, rfit, budget=n, seed=k,
                                 init_population=init).best_fitness)
        cols = {"port": [], "port_refdonor": [], "ref": [],
                "ref_portdonor": []}
        for k in seeds:
            pc, rc = port_best(short, None, k), ref_best(short, None, k)
            cols["port"].append(port_best(short, ws, k) / pc)
            cols["port_refdonor"].append(port_best(short, ws_ref, k) / pc)
            cols["ref"].append(ref_best(short, rws, k) / rc)
            cols["ref_portdonor"].append(ref_best(short, rws_port, k) / rc)
            print(f"  seed {k}: warm/cold port {cols['port'][-1]:.4f} "
                  f"(reference's donor {cols['port_refdonor'][-1]:.4f}), "
                  f"reference {cols['ref'][-1]:.4f} (port's donor "
                  f"{cols['ref_portdonor'][-1]:.4f})")
        p0 = geomean([port_best(s.ask_size, ws, k) for k in seeds])
        r0 = geomean([ref_best(rs.ask_size, rws, k) for k in seeds])
        print(f"  group {i}, seeds {seeds[0]}-{seeds[-1]}: geomean warm/cold "
              + ", ".join(f"{c} {geomean(v):.4f}" for c, v in cols.items())
              + f"; first warm generation port {p0:.4e}, reference "
              f"{r0:.4e}")
        logs = {c: np.log(np.asarray(v)) for c, v in cols.items()}
        print("    log sd " + ", ".join(f"{c} {v.std(ddof=1):.4f}"
                                        for c, v in logs.items()))
        for what, a, b in (("own donors", "port", "ref"),
                           ("port's donor", "port", "ref_portdonor"),
                           ("reference's donor", "port_refdonor", "ref")):
            d = logs[a].mean() - logs[b].mean()
            se = np.sqrt(logs[a].var(ddof=1) / len(seeds)
                         + logs[b].var(ddof=1) / len(seeds))
            print(f"    port/reference, {what}: {np.exp(d):.4f} "
                  f"[{np.exp(d - 1.96 * se):.4f}, "
                  f"{np.exp(d + 1.96 * se):.4f}]")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_memo.py
    # ~8 minutes for the 64 seeds that settle the 256 GB/s comparison
    measure_near_hit_ratios(seeds=tuple(range(64)))
    measure_near_hit_ratios(bw=1)
