"""The port's race harness and ``RecompileGuard``.

* ``repro_torch.lint.race``: the MemoStore ownership race (threads and a
  subprocess owner, >= 1000 interleaved put / discard / refresh / compact
  ops; the final index exact against each owner's script replayed
  serially), the LRU eviction phase and the AnalysisPool determinism
  race (concurrent tables bitwise the serial ones); a directory the
  port's race wrote passes the reference's verifier too.
* ``RecompileGuard``: fed by ``repro_torch.kernels._build``'s load hook
  (through a stub build: no ``nvcc`` here) and by dynamo's compile
  callbacks; raises ``RecompileError`` naming what was built after the
  boundary, stays quiet before it, and reports to a flight recorder.
"""
import pathlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.lint import race  # noqa: E402
from repro_torch.lint.runtime import RecompileError, RecompileGuard  # noqa: E402
from repro_torch.obs import FlightRecorder, get_registry  # noqa: E402


@pytest.mark.parametrize("use_subprocess", [True, False],
                         ids=["threads+process", "threads"])
def test_memo_ownership_race(tmp_path, use_subprocess):
    total = race.memo_race(str(tmp_path), threads=3, ops_per_owner=250,
                           use_subprocess=use_subprocess)
    assert total == (4 if use_subprocess else 3) * 250


def test_race_directory_passes_the_reference_verifier(tmp_path):
    """The port's store writes the reference's layout: the reference's own
    verifier (pure-JSON replay, its loader, payload bytes) agrees."""
    ref_race = pytest.importorskip("repro.lint.race")
    race.memo_race(str(tmp_path), threads=2, ops_per_owner=120,
                   use_subprocess=False)
    assert ref_race.verify_store(str(tmp_path), 2, 120) == []
    assert race.replay_index(str(tmp_path)) == \
        ref_race.replay_index(str(tmp_path))


def test_eviction_lru_exact(tmp_path):
    race.eviction_phase(str(tmp_path))


def test_analysis_pool_concurrent_equals_serial():
    assert race.analysis_race(threads=4, n_jobs=6) == 6


def test_race_cli(tmp_path, capsys):
    assert race.main(["--dir", str(tmp_path), "--threads", "2",
                      "--ops-per-owner", "60", "--no-subprocess",
                      "--skip-analysis"]) == 0
    assert "repro_torch.lint.race: OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# RecompileGuard
# ---------------------------------------------------------------------------
@pytest.fixture
def stub_build(monkeypatch):
    """``_build.load`` with a stub compile (no nvcc here) and an empty
    library cache, so every name loads once."""
    built = []

    def compile_(name):
        built.append(name)
        return _build.BuiltLibrary(lib=None, path=pathlib.Path(name),
                                   ptxas_log="", build_seconds=0.25)

    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "_loaded", {})
    return built


def test_guard_counts_kernel_loads_and_raises_after_warmup(stub_build):
    g = RecompileGuard(label="unit")
    with pytest.raises(RecompileError) as exc:
        with g:
            _build.load("makespan")
            g.warmup()
            _build.load("makespan")          # reused: no event
            _build.load("ssm_scan")          # first load after warmup
    msg = str(exc.value)
    assert "after warmup" in msg and "[unit]" in msg and "ssm_scan" in msg
    assert g.compiles == ["makespan", "ssm_scan"]
    assert g.warmup_compiles == ["makespan"]
    assert g.post_warmup == ["ssm_scan"]
    assert stub_build == ["makespan", "ssm_scan"]


def test_guard_quiet_before_boundary_and_detached_after_exit(stub_build):
    with RecompileGuard() as g:
        _build.load("a")
        _build.load("b")
    assert g.compiles == ["a", "b"] and g.post_warmup == []
    _build.load("c")                         # listener removed on exit
    assert g.compiles == ["a", "b"]
    with RecompileGuard() as quiet:
        quiet.warmup()
        _build.load("a")                     # cached: not a compile
    assert quiet.compiles == []


def test_guard_feeds_flight_recorder_and_registry(stub_build, tmp_path):
    flight = FlightRecorder(dump_dir=str(tmp_path), worker="w0")
    g = RecompileGuard(label="fleet-w0")
    flight.attach_guard(g)
    with pytest.raises(RecompileError):
        with g:
            _build.load("warm")
            g.warmup()
            _build.load("late")
    events = flight.snapshot()["w0"]
    assert [e["executable"] for e in events] == ["warm", "late"]
    assert [e["post_warmup"] for e in events] == [False, True]
    assert len(flight.dumps) == 1 and "post_warmup" in flight.dumps[0]
    series = {(r["labels"]["guard"], r["labels"]["phase"]): r["value"]
              for r in get_registry().snapshot()[
                  "repro_jit_compiles_total"]["series"]}
    assert series[("fleet-w0", "warmup")] == 1
    assert series[("fleet-w0", "post_warmup")] == 1


def test_guard_counts_dynamo_recompiles():
    @torch.compile(backend="eager")
    def scale_rows(x, n):
        return x * n

    g = RecompileGuard(label="dynamo")
    with pytest.raises(RecompileError) as exc:
        with g:
            scale_rows(torch.ones(4), 2)
            g.warmup()
            scale_rows(torch.ones(4), 2)     # cached: fine
            scale_rows(torch.ones(4), 3)     # a changed constant retraces
    assert len(g.warmup_compiles) == 1
    assert len(g.post_warmup) == 1
    assert g.post_warmup[0].startswith("torch.compile ")
    assert "scale_rows" in str(exc.value)
