"""The check that decides ``correct``, shown to fail.

At a size a CPU test run holds: the control (the reference put in the
program's place in bfloat16) reads above every cell's ``fitness_gap``
limit while the program reads below it, and a run driven through the
harness with the timed path broken underneath comes out not correct,
once for each fault a cell can have: an answer altered where it is
produced, a search step that returns its state unchanged, half of a
batch left out (in the sweep within one bandwidth: rows copying rows,
rows sharing one generator, the kernel scoring half of its
individuals)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from m3ebench import control, run  # noqa: E402
from m3ebench.spec import Bench  # noqa: E402
from m3ebench.tiny import tiny_bench  # noqa: E402

CELLS = ("search.s4_mix", "sweep.s2_mix", "stream.s4_mix")
# limits that suit the small copy: with groups of 60 and 10 generations
# a sound search reads ~1.3x the bound at the 90th percentile, a stalled
# one 6x and more
SMALL = {"fitness_gap": 1e-4, "makespan_over_bound_p90": 2.5,
         "duplicate_answers": 0, "malformed": 0, "missing": 0,
         "compiles_in_window": 0}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(tmp_path):
    return tiny_bench(tmp_path, group_size=60, budget=1000, limits=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_limit_the_program_below(tmp_path, cell):
    limit = Bench.load(ROOT).limits(cell)["fitness_gap"]
    bench = tiny_bench(tmp_path, group_size=30, budget=500)
    for row in control.readings(bench, cell, [3, 2 ** 33 + 4], 0.5,
                                device="cpu"):
        assert row["schedules"] > 0
        assert row["fitness_gap"] < limit < row["control.fitness_gap"]
        assert row["altered.fitness_gap"] > limit
        assert row["duplicate_answers"] == 0
        assert row["copied.duplicate_answers"] >= row["schedules"] // 2
        assert row["stalled.makespan_over_bound_p90"] >= \
            row["makespan_over_bound_p90"] * (1 - 1e-6)


def _run(bench, cell):
    return run.run_cell(bench, cell, 77, 0.8, False, "cpu")


@pytest.mark.parametrize("cell", ["search.s4_mix", "sweep.s2_mix"])
def test_sound_runs_are_correct(small, cell):
    out = _run(small, cell)
    assert out["correct"] is True, out["checks"]


def test_an_answer_altered_where_produced_is_caught(small, monkeypatch):
    from repro_torch.core.m3e import M3E
    search = M3E.search

    def altered(self, *a, **k):
        res = search(self, *a, **k)
        res.best_accel = res.best_accel.copy()
        res.best_accel[0] = (res.best_accel[0] + 1) % 8
        return res

    monkeypatch.setattr(M3E, "search", altered)
    out = _run(small, "search.s4_mix")
    assert out["correct"] is False
    assert out["checks"]["fitness_gap"]["value"] > SMALL["fitness_gap"]


def test_a_step_that_returns_its_state_unchanged_is_caught(small,
                                                          monkeypatch):
    from repro_torch.core.strategies.magma_strategy import MagmaStrategy
    monkeypatch.setattr(MagmaStrategy, "tell",
                        lambda self, state, fitness: state)
    for cell in ("search.s4_mix", "sweep.s2_mix"):
        out = _run(small, cell)
        assert out["correct"] is False
        assert out["checks"]["makespan_over_bound_p90"]["value"] > \
            SMALL["makespan_over_bound_p90"]


def test_half_of_a_sweep_left_out_is_caught(small, monkeypatch):
    from repro_torch.core import sweep as sweep_mod
    run_sweep = sweep_mod.run_sweep

    def half(*a, **k):
        res = run_sweep(*a, **k)
        S, K = res.best_fitness.shape
        for f in ("best_fitness", "best_accel", "best_prio",
                  "history_best"):
            x = getattr(res, f).reshape((S * K,) + getattr(res, f).shape[2:])
            x[S * K // 2:] = x[:S * K - S * K // 2].copy()
        return res

    monkeypatch.setattr(sweep_mod, "run_sweep", half)
    out = _run(small, "sweep.s2_mix")
    assert out["correct"] is False
    assert out["checks"]["fitness_gap"]["value"] > SMALL["fitness_gap"]


def _per_bandwidth(res):
    """The sweep's result as (bandwidth, seed, ...) views of each field."""
    return [getattr(res, f) for f in ("best_fitness", "best_accel",
                                      "best_prio", "history_best")]


def test_rows_copying_rows_of_their_bandwidth_are_caught(small,
                                                         monkeypatch):
    """Rows 8-15 of each bandwidth return rows 0-7's schedules: every
    answer is right for its group and bandwidth, and a copy."""
    from repro_torch.core import sweep as sweep_mod
    run_sweep = sweep_mod.run_sweep

    def copied(*a, **k):
        res = run_sweep(*a, **k)
        half = res.best_fitness.shape[1] // 2
        for x in _per_bandwidth(res):
            x[:, half:2 * half] = x[:, :half].copy()
        return res

    monkeypatch.setattr(sweep_mod, "run_sweep", copied)
    out = _run(small, "sweep.s2_mix")
    assert out["correct"] is False
    assert out["checks"]["fitness_gap"]["value"] < SMALL["fitness_gap"]
    assert out["checks"]["duplicate_answers"]["value"] >= \
        out["attempted"] // 2


def test_rows_sharing_one_generator_are_caught(small, monkeypatch):
    """Every row of a sweep seeded from the first row's seed: each
    bandwidth's rows all run one search."""
    from repro_torch.core import sweep as sweep_mod
    gens = sweep_mod.row_generators
    monkeypatch.setattr(sweep_mod, "row_generators",
                        lambda seeds, device: gens([seeds[0]] * len(seeds),
                                                   device))
    out = _run(small, "sweep.s2_mix")
    assert out["correct"] is False
    assert out["checks"]["fitness_gap"]["value"] < SMALL["fitness_gap"]
    assert out["checks"]["duplicate_answers"]["value"] > 0


@pytest.mark.parametrize("fill", ["zero", "copy"])
def test_the_kernel_scoring_half_of_a_bandwidths_rows_is_caught(
        small, monkeypatch, fill):
    """The fitness of rows 8-15 of each bandwidth's 16 never computed:
    left at zero, or read as rows 0-7's."""
    from repro_torch.core.strategies import graphs
    evaluate = graphs.evaluate_params
    per = small.traffic("sweep")["seeds_per_scenario"]

    def half(*a, **k):
        fit = evaluate(*a, **k).clone()
        for r in range(fit.shape[0]):
            if r % per >= per // 2:
                fit[r] = 0 if fill == "zero" else fit[r - per // 2]
        return fit

    monkeypatch.setattr(graphs, "evaluate_params", half)
    out = _run(small, "sweep.s2_mix")
    assert out["correct"] is False
    c = out["checks"]
    assert (c["malformed"]["value"] > 0 if fill == "zero"
            else c["fitness_gap"]["value"] > SMALL["fitness_gap"])


def test_half_of_a_stream_batch_left_out_is_caught(small, monkeypatch):
    from repro_torch.stream.service import StreamingScheduler
    route = StreamingScheduler._route

    def half(self, inf, results):
        n = len(results)
        route(self, inf, results)
        got = len(results) - n
        del results[n + (got + 1) // 2:]

    monkeypatch.setattr(StreamingScheduler, "_route", half)
    out = _run(small, "stream.s4_mix")
    assert out["correct"] is False
    assert out["checks"]["missing"]["value"] > 0
    assert out["failed"] > 0


def test_schedules_of_the_sweep_carry_their_own_bandwidth(small):
    """The sweep's answers are judged each at its own row's bandwidth:
    an answer read at another row's bandwidth reads as wrong."""
    from m3ebench import judge, loadgen
    cell = small.cell("sweep.s2_mix")
    cfg = small.config(cell["config"])
    entry = loadgen.make_entry(small, cfg, small.traffic(cell["traffic"]), 5,
                               "cpu")
    answers = entry.answers(entry.call(entry.window_rng))
    asked = len(answers)
    numbers, _ = judge.judge(cfg, answers, asked, 0)
    assert numbers["fitness_gap"] < SMALL["fitness_gap"]
    answers[0].bw_sys = answers[-1].bw_sys
    numbers, _ = judge.judge(cfg, answers, asked, 0)
    assert numbers["fitness_gap"] > SMALL["fitness_gap"]
