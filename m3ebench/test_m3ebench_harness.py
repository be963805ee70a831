"""The harness on the CPU: arguments, the result line, cells found by
name in data, the import check, the roofline arithmetic, the trace
readers and ``BENCHMARK.json`` against the contract it is written to."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from m3ebench import peaks, run, trace  # noqa: E402
from m3ebench.spec import Bench  # noqa: E402
from m3ebench.tiny import tiny_bench  # noqa: E402

LOOSE = {"fitness_gap": 1e-4, "makespan_over_bound_p90": 100.0,
         "duplicate_answers": 0, "malformed": 0, "missing": 0,
         "compiles_in_window": 0}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_parse_takes_a_runs_arguments():
    a = run.parse(["--workload", "search.s4_mix", "--seed",
                   str(2 ** 33 + 3), "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "search.s4_mix", 2 ** 33 + 3, 10.0, 1)
    assert run.parse(["--workload", "w", "--seed", "1",
                      "--seconds", "2"]).trace == 0


@pytest.mark.parametrize("argv", [
    ["--seed", "1", "--seconds", "1"],
    ["--workload", "w", "--seconds", "1"],
    ["--workload", "w", "--seed", "1", "--seconds", "0"],
    ["--workload", "w", "--seed", "1", "--seconds", "1", "--trace", "2"],
])
def test_parse_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit):
        run.parse(argv)


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "search.s4_mix", "--seed", "1",
                     "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_import_check_compares_whole_top_level_names():
    assert run.banned_modules({"repro": 0, "repro.core.m3e": 0}) == ["repro"]
    assert run.banned_modules({"repro_torch": 0,
                               "repro_torch.core.m3e": 0}) == []
    assert run.banned_modules({"jax.numpy": 0, "jaxlib": 0, "flax": 0,
                               "jaxtyping": 0}) == ["flax", "jax", "jaxlib"]


@pytest.mark.parametrize("cell", ["search.s4_mix", "sweep.s2_mix",
                                  "stream.s4_mix"])
def test_result_line_schema(tmp_path, cell):
    bench = tiny_bench(tmp_path, group_size=12, budget=300, limits=LOOSE)
    out = run.run_cell(bench, cell, 2 ** 32 + 9, 0.6, False, "cpu")
    json.dumps(out, allow_nan=False)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = {m["name"] for m in bench.metrics(cell, False)}
    assert set(out["metrics"]) == want and "setup_s" in want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(LOOSE)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    # a tiny group's search can meet its bound, where the ratio reads 1 up
    # to rounding: the same allowance as the bound's own tests
    assert 0 < out["metrics"]["quality_vs_bound"]["value"] <= 1 + 1e-12


def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    bench = tiny_bench(tmp_path, group_size=12, budget=200, limits=LOOSE)
    here = bench.here
    cfg = json.loads((tmp_path / "m3ebench/configs/s2_mix_g100.json")
                     .read_text())
    cfg.update(name="s2_dummy", bandwidths_gb=[2])
    (here / "configs" / "s2_dummy.json").write_text(json.dumps(cfg))
    (here / "traffic" / "dummy_search.json").write_text(json.dumps(
        {"entry": "search"}))
    (here / "limits" / "dummy.s2.json").write_text(json.dumps(LOOSE))
    (here / "metrics" / "dummy_searches.py").write_text(
        "def read(ctx):\n    return float(ctx.window.calls)\n")
    bench.doc["configs"].append({
        "name": "s2_dummy", "source": "https://arxiv.org/abs/2104.13997",
        "file": "m3ebench/configs/s2_dummy.json", "reduced": [],
        "why": "a dummy"})
    bench.doc["workloads"].append({
        "name": "dummy.s2", "config": "s2_dummy",
        "traffic": "dummy_search", "chips": 1, "why": "a dummy"})
    bench.doc["end_to_end"].append({
        "name": "dummy_searches", "unit": "calls", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["dummy.s2"]})
    out = run.run_cell(bench, "dummy.s2", 5, 0.5, False, "cpu")
    assert out["correct"] is True
    assert out["metrics"]["dummy_searches"]["value"] == out["attempted"]
    assert "samples_per_s" not in out["metrics"]
    with pytest.raises(KeyError):
        bench.cell("no.such.cell")


def test_an_entry_added_as_a_file_is_found_by_name(tmp_path):
    """A traffic mix that names a new entry point, ``entries/<name>.py``,
    brings its own loop and its own judge; no existing file changes."""
    bench = tiny_bench(tmp_path, group_size=12, budget=200, limits=LOOSE)
    here = bench.here
    (here / "entries" / "ticks.py").write_text(
        "from m3ebench.loadgen import ClosedLoop\n"
        "class Entry(ClosedLoop):\n"
        "    rows = 2\n"
        "    def call(self, rng):\n"
        "        self.calls += 1\n"
        "        return int(rng.integers(0, 9))\n"
        "    def answers(self, got):\n"
        "        return [got, got]\n"
        "    @staticmethod\n"
        "    def judge(config, answers, attempted, compiles):\n"
        "        return ({'missing': float(attempted - len(answers)),\n"
        "                 'compiles_in_window': float(compiles)}, [])\n")
    (here / "traffic" / "ticks.json").write_text(json.dumps(
        {"entry": "ticks"}))
    (here / "limits" / "ticks.s2.json").write_text(json.dumps(
        {"missing": 0, "compiles_in_window": 0}))
    bench.doc["workloads"].append({
        "name": "ticks.s2", "config": "s2_mix_g100", "traffic": "ticks",
        "chips": 1, "why": "a dummy"})
    out = run.run_cell(bench, "ticks.s2", 5, 0.2, False, "cpu")
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["checks"]) == {"missing", "compiles_in_window"}
    assert set(out["metrics"]) == {"setup_s"}
    (here / "traffic" / "ticks.json").write_text(json.dumps(
        {"entry": "no_such_entry"}))
    with pytest.raises(FileNotFoundError):
        run.run_cell(bench, "ticks.s2", 5, 0.2, False, "cpu")


def test_makespan_roofline_arithmetic():
    ops, nbytes = peaks.makespan_work(100, 8, 100)
    assert ops == 100 * 100 * 68 and nbytes == 80000 + 3200 + 400
    ms, which = peaks.makespan_bound_ms(100, 8, 100)
    assert which == "bytes"
    assert ms == pytest.approx(83600 / 3.35e12 * 1e3)
    ms, which = peaks.bound_ms(67e9, 1.0)
    assert which == "operations" and ms == pytest.approx(1.0)
    ops, nbytes = peaks.makespan_work(4800, 4, 100)
    assert ops == 4800 * 100 * 36
    assert nbytes == 2 * 4800 * 100 * 4 + 4800 * 4 * 4 + 4800 * 4


def test_trace_readers_on_hand_made_ops():
    Op = trace.Op
    dev = [Op("a", 0, 10), Op("b", 5, 20), Op("c", 30, 40)]
    assert trace.busy_s(dev) == pytest.approx(30e-6)
    assert trace.top_ops(dev + [Op("a", 50, 70)], 2) == [
        ("a", pytest.approx(30e-6)), ("b", pytest.approx(15e-6))]
    host = [Op("outer", 0, 100), Op("aten::copy_", 22, 28)]
    assert trace.idle_gaps(dev, host) == [("aten::copy_",
                                           pytest.approx(10e-6))]
    # a long host op still running covers a later gap after inner ops ended
    host = [Op("cudaGraphLaunch", 0, 100), Op("aten::a", 1, 2),
            Op("aten::b", 21, 23), Op("late", 35, 50)]
    assert trace.idle_gaps(dev, host) == [("cudaGraphLaunch",
                                           pytest.approx(10e-6))]
    assert trace.idle_gaps(dev, []) == [("host outside any recorded op",
                                         pytest.approx(10e-6))]
    assert trace.launches([Op("cudaGraphLaunch", 0, 1),
                           Op("cudaLaunchKernel", 1, 2),
                           Op("aten::add", 2, 3)]) == 2


def test_split_batches_cuts_at_the_widest_gap():
    Op = trace.Op
    ops, t = [], 0.0
    for b in range(3):
        for name in ["copy", "init"] + ["makespan_kernel", "x"] * 2 + [
                "unload"]:
            ops.append(Op(f"{name}{b}" if name != "makespan_kernel"
                          else name, t, t + 1))
            t += 1.5
        t += 100.0                         # the host between batches
    got = trace.split_batches(ops, 2)
    assert [len(b) for b in got] == [7, 7, 7]
    assert all(o.name.endswith(str(i)) or o.name == "makespan_kernel"
               for i, b in enumerate(got) for o in b)
    with pytest.raises(ValueError):
        trace.split_batches(ops, 4)


def test_benchmark_json_keeps_to_the_contract():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = Bench.load(ROOT)
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["m3ebench"] and 1 <= doc["run_seconds"] <= 51
    assert len(doc["command"]) <= 32
    names = set()
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("m3ebench/")
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
        names.add(c["name"])
    used = set()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names
        used.add(w["config"])
        bench.traffic(w["traffic"])
        assert set(bench.limits(w["name"])) >= {
            "fitness_gap", "makespan_over_bound_p90", "duplicate_answers",
            "malformed", "missing", "compiles_in_window"}
    assert used == names
    metrics = doc["end_to_end"] + doc["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in doc["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(bench.reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in doc["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in doc["workloads"]:
        got = bench.metrics(w["name"], False)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert bench.metrics(w["name"], True)
    assert len(json.dumps(doc)) < 64 * 1024
