"""Port parity: the Section V-C warm-start engine (``WarmStartEngine``,
``M3E(warm_start=...)``) and Table V.

The engine's own contract is held as ``tests/test_warmstart.py`` holds
the reference's: transfer beats random init, a mismatched group size or
an unseen task type falls back to random init, and records are
content-addressed (latest wins).

Table V runs through both packages by one protocol, the reference
script's (``benchmarks/tableV_warmstart.py``) at a cut size: S2 at
1 GB/s, Mix groups of G=40, P=40, epochs (0, 1, 10, 20), instances 1-4,
over TABLE_V_SEEDS task-group seeds.  The two packages draw different
random streams, so the test compares the seed means of the Trf-0-ep
fraction of the full search and of gain0 (Trf-0-ep over Raw).  Measured
on the CPU by running this file as a script, over four disjoint sets of
six group seeds, the port-minus-reference difference of the mean
Trf-0-ep fraction lay within [-0.0364, +0.0497] and the port/reference
ratio of the mean gain0 within [0.9279, 1.0274] with MAGMA's
counter-based draws ([+0.0016, +0.0375] and [0.9316, 1.0151] with the
per-row generator draws before them, when the tolerances were set at
twice the widest): FRAC_TOL 0.075 and GAIN_RTOL 0.14.  Both packages
must also meet the reference script's own assertion, gain0 > 1.1 and
full_frac > 0.75, at every seed.  The protocol seeds the searches and
the random individuals the same way whatever the groups, so those sets
share each package's draws; with the draws moved with the group seed
(the script's second reading) the difference lay within [-0.0694,
+0.0129] and the gain0 ratio within [0.9450, 0.9872] ([-0.0715, +0.0076]
and [0.9399, 0.9915] before).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.core import M3E as RefM3E  # noqa: E402
from repro.core import MagmaConfig as RefMagmaConfig  # noqa: E402
from repro.core.encoding import random_population as ref_random  # noqa: E402
from repro.core.warmstart import WarmStartEngine as RefEngine  # noqa: E402
from repro.costmodel import get_setting as ref_setting  # noqa: E402
from repro.workloads import build_task_groups as ref_groups  # noqa: E402
from repro_torch.core import M3E, MagmaConfig, WarmStartEngine  # noqa: E402
from repro_torch.core.encoding import random_population  # noqa: E402
from repro_torch.costmodel import GB, get_setting  # noqa: E402
from repro_torch.workloads import build_task_groups  # noqa: E402

TABLE_V = dict(setting="S2", task="Mix", group_size=40, pop=40,
               epochs=(0, 1, 10, 20), n_insts=4)
TABLE_V_SEEDS = tuple(range(6))
FRAC_TOL = 0.075
GAIN_RTOL = 0.14


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_warmstart_transfer_beats_random_init():
    """Trf-0-ep (warm-started, 1 generation) > Raw (random, 1 generation)."""
    ws = WarmStartEngine()
    m3e = M3E(get_setting("S2"), bw_sys=1 * GB, warm_start=ws, device="cpu")
    groups = build_task_groups("Lang", group_size=40, num_groups=2, seed=0)
    cfg = MagmaConfig(population=40)
    m3e.search(groups[0], budget=2000, seed=0, strategy_kwargs={"cfg": cfg})
    assert ws.has("Lang")
    warm = m3e.search(groups[1], budget=40, seed=1,
                      strategy_kwargs={"cfg": cfg})
    cold = M3E(get_setting("S2"), bw_sys=1 * GB, device="cpu").search(
        groups[1], budget=40, seed=1, strategy_kwargs={"cfg": cfg})
    assert warm.best_fitness > cold.best_fitness


def test_warmstart_ignores_mismatched_group_size():
    ws = WarmStartEngine()
    ws.remember("Vision", random_population(_gen(0), 8, 10, 4, "cpu"))
    assert ws.init_population("Vision", _gen(1), 20, 4) is None
    assert ws.init_population("Recom", _gen(1), 10, 4) is None
    pop = ws.init_population("Vision", _gen(1), 10, 4)
    assert pop is not None and tuple(pop.accel.shape) == (8, 10)
    assert float(pop.prio.min()) >= 0.0 and float(pop.prio.max()) < 1.0


def test_warmstart_init_is_a_pure_function_of_generator_and_store():
    """Same seed, same bits; another seed, another jitter; the accel
    genome transfers un-jittered (clipped to the accelerator count)."""
    ws = WarmStartEngine()
    src = random_population(_gen(0), 8, 10, 6, "cpu")
    ws.remember("Vision", src)
    p1 = ws.init_population("Vision", _gen(3), 10, 4)
    p2 = ws.init_population("Vision", _gen(3), 10, 4)
    assert torch.equal(p1.accel, p2.accel) and torch.equal(p1.prio, p2.prio)
    p3 = ws.init_population("Vision", _gen(4), 10, 4)
    assert not torch.equal(p1.prio, p3.prio)
    assert torch.equal(p1.accel, torch.clamp_max(src.accel, 3))
    assert p1.accel.dtype == torch.int32 and p1.prio.dtype == torch.float32


def test_warmstart_remember_is_content_addressed():
    """Re-remembering the identical population is a no-op overwrite in
    the backing memo store; new knowledge appends (latest wins)."""
    ws = WarmStartEngine()
    pop = random_population(_gen(0), 8, 10, 4, "cpu")
    ws.remember("Lang", pop)
    ws.remember("Lang", pop)
    assert len(ws.store) == 1
    pop2 = random_population(_gen(9), 8, 10, 4, "cpu")
    ws.remember("Lang", pop2)
    assert len(ws.store) == 2
    got = ws.init_population("Lang", _gen(1), 10, 4)
    base = torch.clamp(pop2.prio, 0.0, 0.999)
    assert float((got.prio - base).abs().max()) < 0.2


def test_warmstart_records_match_the_reference_store():
    """The same population remembered by both engines gives the same
    content address (the records are interchangeable on disk)."""
    accel = np.random.default_rng(0).integers(0, 4, (8, 10)).astype(np.int32)
    prio = np.random.default_rng(1).random((8, 10)).astype(np.float32)
    ref, port = RefEngine(), WarmStartEngine()
    from repro.core.encoding import Population as RefPopulation
    ref.remember("Mix", RefPopulation(accel=accel, prio=prio))
    port.remember("Mix", (torch.as_tensor(accel), torch.as_tensor(prio)))
    (r,), (p,) = ref.store.family(("warmstart", "Mix")), \
        port.store.family(("warmstart", "Mix"))
    assert r.fingerprint == p.fingerprint and r.meta == p.meta


# ---------------------------------------------------------------------------
# Table V through both packages
# ---------------------------------------------------------------------------
def table_v(port: bool, seed: int, setting="S2", task="Mix", group_size=40,
            pop=40, epochs=(0, 1, 10, 20), n_insts=4, draw_offset=0):
    """The protocol of ``benchmarks/tableV_warmstart.py:35-80`` on task
    groups drawn with ``seed``, through the port (``port=True``, on the
    CPU) or the reference.  The script seeds the searches with 0 and the
    instance number and the random individuals with 100 + the instance
    number, whatever the groups; ``draw_offset`` adds to all of them.
    Returns (raw, {epoch: finals}, full)."""
    if port:
        m3e = M3E(get_setting(setting), bw_sys=1 * GB,
                  warm_start=WarmStartEngine(), device="cpu")
        groups = build_task_groups(task, group_size=group_size,
                                   num_groups=n_insts + 1, seed=seed)
        cfg = MagmaConfig(population=pop)

        def rand(i, fit):
            r = random_population(_gen(100 + i + draw_offset), 32,
                                  fit.group_size, fit.num_accels, "cpu")
            return float(fit(r.accel, r.prio).mean())
    else:
        m3e = RefM3E(accel=ref_setting(setting), bw_sys=1 * GB,
                     warm_start=RefEngine())
        groups = ref_groups(task, group_size=group_size,
                            num_groups=n_insts + 1, seed=seed)
        cfg = RefMagmaConfig(population=pop)

        def rand(i, fit):
            r = ref_random(jax.random.PRNGKey(100 + i + draw_offset), 32,
                           fit.group_size, fit.num_accels)
            return float(np.mean(np.asarray(fit(r.accel, r.prio))))
    m3e.search(groups[0], method="magma", budget=pop * max(epochs),
               seed=draw_offset, strategy_kwargs={"cfg": cfg})
    raws, finals = [], {e: [] for e in epochs}
    for i in range(1, n_insts + 1):
        raws.append(rand(i, m3e.prepare(groups[i])))
        for e in epochs:
            res = m3e.search(groups[i], method="magma",
                             budget=max(pop * e, pop), seed=i + draw_offset,
                             strategy_kwargs={"cfg": cfg})
            finals[e].append(res.history_best[0] if e == 0
                             else res.best_fitness)
    finals = {e: np.array(v) for e, v in finals.items()}
    return np.array(raws), finals, finals[max(epochs)]


def table_v_summary(raw, finals, full):
    """(mean Trf-0-ep fraction of full, gain0) as the script computes."""
    return (float(np.mean(finals[0] / full)),
            float(np.mean(finals[0] / raw)))


def _table_v_means(port: bool, seeds):
    fracs, gains = [], []
    for seed in seeds:
        frac, gain = table_v_summary(*table_v(port, seed, **TABLE_V))
        assert gain > 1.1 and frac > 0.75, (port, seed, gain, frac)
        fracs.append(frac)
        gains.append(gain)
    return float(np.mean(fracs)), float(np.mean(gains))


def test_table_v_fractions_match_reference():
    port_frac, port_gain = _table_v_means(True, TABLE_V_SEEDS)
    ref_frac, ref_gain = _table_v_means(False, TABLE_V_SEEDS)
    assert abs(port_frac - ref_frac) <= FRAC_TOL, (port_frac, ref_frac)
    assert port_gain == pytest.approx(ref_gain, rel=GAIN_RTOL), \
        (port_gain, ref_gain)


def measure_table_v_spread(n_sets=4):
    """The measurement behind FRAC_TOL and GAIN_RTOL: both packages'
    seed means over ``n_sets`` disjoint sets of group seeds, and where a
    difference comes from: the port/reference ratios of the mean first
    warm generation (Trf-0-ep's numerator), of the mean full search (its
    denominator) and of the mean Raw.  Then the same sets with the
    searches' and Raw's seeds moved with each group seed: the protocol
    keeps them fixed, so every set reuses each package's draws."""
    k = len(TABLE_V_SEEDS)
    for draws in (False, True):
        for s in range(n_sets):
            seeds = range(k * s, k * s + k)
            means, parts = {}, {}
            for port in (True, False):
                runs = [table_v(port, seed,
                                draw_offset=1000 * seed if draws else 0,
                                **TABLE_V) for seed in seeds]
                sums = [table_v_summary(*r) for r in runs]
                assert all(g > 1.1 and f > 0.75 for f, g in sums), sums
                means[port] = np.mean(sums, axis=0)
                parts[port] = np.array([
                    np.mean([r[1][0] for r in runs]),
                    np.mean([r[2] for r in runs]),
                    np.mean([r[0] for r in runs])])
            (pf, pg), (rf, rg) = means[True], means[False]
            first, full, raw = parts[True] / parts[False]
            print(f"group seeds {seeds.start}-{seeds.stop - 1}"
                  f"{', draws moved' if draws else ''}: Trf-0-ep fraction "
                  f"port {pf:.4f} reference {rf:.4f} (diff {pf - rf:+.4f}); "
                  f"gain0 port {pg:.4f} reference {rg:.4f} (ratio "
                  f"{pg / rg:.4f})")
            print(f"  port/reference mean Trf-0-ep fitness {first:.4f}, "
                  f"mean full search {full:.4f}, mean Raw {raw:.4f}")


def measure_raw_distribution(n=2048, n_sets=4):
    """Raw (the mean fitness of random individuals) at ``n`` individuals
    a table, on the instance tables of the first ``n_sets`` sets of
    group seeds: the port/reference ratio of each package's own draws,
    and the port's draws through both packages' fitness."""
    ratios, same = [], []
    for seed in range(len(TABLE_V_SEEDS) * n_sets):
        groups = build_task_groups("Mix", group_size=40, num_groups=5,
                                   seed=seed)
        rgroups = ref_groups("Mix", group_size=40, num_groups=5, seed=seed)
        for i in range(1, 5):
            fit = M3E(get_setting("S2"), bw_sys=1 * GB,
                      device="cpu").prepare(groups[i])
            rfit = RefM3E(ref_setting("S2"), bw_sys=1 * GB).prepare(
                rgroups[i])
            p = random_population(_gen(1000 * seed + i), n, 40,
                                  fit.num_accels, "cpu")
            r = ref_random(jax.random.PRNGKey(1000 * seed + i), n, 40,
                           rfit.num_accels)
            port = float(fit(p.accel, p.prio).mean())
            ratios.append(port / float(np.mean(np.asarray(
                rfit(r.accel, r.prio)))))
            same.append(float(np.mean(np.asarray(rfit(
                np.asarray(p.accel), np.asarray(p.prio))))) / port)
    print(f"Raw at {n} individuals, {len(ratios)} tables: port/reference "
          f"mean {np.mean(ratios):.4f} (by table {min(ratios):.4f}-"
          f"{max(ratios):.4f}); the port's draws through the reference's "
          f"fitness / the port's {np.mean(same):.8f}")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_warmstart.py
    measure_table_v_spread()
    measure_raw_distribution()
