"""The port's static analyzer (``repro_torch.lint``: core, checkers, CLI).

- Parity: on the shared fixtures (``tests/lint_fixtures/bad_l004.py``,
  ``bad_l005.py``, ``good.py``), on syntax errors and on pragmas, the
  port's ``lint_text`` gives exactly the (rule, line) findings of the
  reference's ``repro.lint.lint_text``: both linters read the port's
  sources, so a pragma means the same to both.
- The torch rules, on inline snippets (strings, so the reference's
  self-hosting test over ``tests/`` stays clean): L001 global-generator
  draws, L002 host syncs in the dispatch region, L003 impure strategy
  state; each bad snippet trips its rule, each good one is silent.
- Mutations of the port's own code: ``.item()`` in the driver's
  ``scan_steps`` and in the generation step a CUDA graph captures
  (``strategies/graphs.py``), and a ``torch.rand`` without a generator in
  MAGMA's ``ask`` are found.
- Self-hosting: ``src/repro_torch`` and the linter itself are
  strict-clean, and ``python -m repro_torch.lint src/repro_torch
  --strict`` exits 0.
"""
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.lint import CHECKERS, RULES, lint_text, run

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")
FIXTURES = os.path.join(HERE, "lint_fixtures")


def _lint(code):
    return lint_text("<test>", textwrap.dedent(code))


def _rules(findings):
    return sorted({f.rule for f in findings})


def _pairs(findings):
    return [(f.rule, f.line) for f in findings]


# ---------------------------------------------------------------------------
# parity with the reference's linter
# ---------------------------------------------------------------------------
_LOCKED = '''
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._cache = {}   # @locked:_lock
    def put(self, k, v):
'''
PARITY_SNIPPETS = {
    "syntax-error": "def f(:\n    pass\n",
    "syntax-error-eof": "x = (1,\n",
    "pragma-with-reason": _LOCKED + (
        "        self._cache[k] = v  # lint: disable=L004(test)\n"),
    "pragma-line-above": _LOCKED + (
        "        # lint: disable=L004(test)\n        self._cache[k] = v\n"),
    "pragma-without-reason": _LOCKED + (
        "        self._cache[k] = v  # lint: disable=L004\n"),
    "pragma-other-rule": _LOCKED + (
        "        self._cache[k] = v  # lint: disable=L005(test)\n"),
    "pragma-two-rules": _LOCKED + (
        "        self._cache[k] = v  # lint: disable=L004(a), L005(b)\n"),
    "l000-unsuppressable":
        "x = 1  # lint: disable=L001  # lint: disable=L000(hush)\n",
    "pragma-in-string": 's = "# lint: disable=L004"\n',
    "unlocked-write": _LOCKED + "        self._cache[k] = v\n",
}


@pytest.mark.parametrize("name", ["bad_l004.py", "bad_l005.py", "good.py"])
def test_fixture_findings_equal_the_reference(name):
    ref = pytest.importorskip("repro.lint")
    path = os.path.join(FIXTURES, name)
    with open(path) as f:
        text = f.read()
    want = _pairs(ref.lint_text(path, text))
    assert _pairs(lint_text(path, text)) == want
    assert bool(want) == name.startswith("bad")


@pytest.mark.parametrize("name", list(PARITY_SNIPPETS))
def test_syntax_errors_and_pragmas_equal_the_reference(name):
    ref = pytest.importorskip("repro.lint")
    text = PARITY_SNIPPETS[name]
    assert _pairs(lint_text("<t>", text)) == \
        _pairs(ref.lint_text("<t>", text))


def test_rule_ids_are_the_reference_ids():
    ref = pytest.importorskip("repro.lint")
    assert set(RULES) == set(ref.RULES)
    assert set(CHECKERS) == set(RULES) - {"L000"}
    assert RULES["L001"] == "global-generator-draw"
    assert RULES["L002"] == "host-sync-in-dispatch"


# ---------------------------------------------------------------------------
# the torch rules
# ---------------------------------------------------------------------------
_STRATEGY = '''
import time
import torch
from repro_torch.core.strategies.base import SearchStrategy
class S(SearchStrategy):
    def tell(self, state, fitness, n: int = 3):
{body}
        return state
'''


def _in_tell(*body):
    return _STRATEGY.format(body="\n".join("        " + b for b in body))


BAD = {
    # L001: the global generator
    "rand": ("import torch\ndef f(n, dev):\n"
             "    return torch.rand((n,), device=dev)\n", ["L001"]),
    "randn_like": "import torch\ndef f(x):\n    return torch.randn_like(x)\n",
    "randperm-none": ("import torch\ndef f(n):\n"
                      "    return torch.randperm(n, generator=None)\n"),
    "multinomial": "def f(p):\n    return p.multinomial(1)\n",
    "normal_": "def f(w):\n    w.normal_(0.0, 1.0)\n",
    "nn.init": ("import torch\ndef f(w):\n"
                "    torch.nn.init.kaiming_uniform_(w)\n"),
    "manual_seed": "import torch\ntorch.manual_seed(0)\n",
    "cuda.manual_seed_all": ("import torch\ndef f():\n"
                             "    torch.cuda.manual_seed_all(0)\n"),
    # L002: host syncs in the dispatch region
    "if": (_in_tell("if fitness.max() > 0:", "    state = state + 1"),
           ["L002"]),
    "item": _in_tell("best = fitness.max().item()"),
    "tolist": _in_tell("best = fitness.tolist()"),
    "cpu": _in_tell("best = fitness.cpu()"),
    "numpy": _in_tell("best = state.numpy()"),
    "int": _in_tell("i = int(fitness.argmax())"),
    "bool": _in_tell("ok = bool(fitness.any())"),
    "assert": _in_tell("assert fitness.min() >= 0"),
    "ifexp": _in_tell("state = state if fitness.sum() > 0 else -state"),
    "nonzero": _in_tell("idx = torch.nonzero(fitness)"),
    "unique": _in_tell("u = fitness.unique()"),
    "where-1": _in_tell("idx = torch.where(fitness > 0)"),
    "mask-index": _in_tell("best = fitness[fitness > 0]"),
    "mask-name": _in_tell("keep = ~(fitness < 0)", "best = state[keep]"),
    "mask-store": _in_tell("fitness[torch.isnan(fitness)] = 0.0"),
    "synchronize": _in_tell("torch.cuda.synchronize()"),
    "marked": ("import torch\n# lint: dispatch\ndef f(x):\n"
               "    return x.sum().item()\n", ["L002"]),
    "marked-def-line": ("def f(x):  # lint: dispatch\n"
                        "    return x.tolist()\n", ["L002"]),
    "marked-decorated": ("import functools\n# lint: dispatch\n"
                         "@functools.wraps(print)\ndef f(x):\n"
                         "    return x.cpu()\n", ["L002"]),
    "stepped": ('''
        def steps(state, n: int):
            for _ in range(n):
                if state.sum() > 0:
                    state = state - 1
                yield
            return state

        def run(state):
            return run_interleaved([steps(state, 3)])
        ''', ["L002"]),
    # L003: impure strategy state
    "self-mutation": _in_tell("self.calls = 1"),
    "clock": _in_tell("t0 = time.perf_counter()"),
    "reseed-in-step": (_in_tell("torch.manual_seed(0)"), ["L001", "L003"]),
    "setattr": _in_tell("object.__setattr__(self, 'best', fitness)"),
    "clock-in-marked": ("import time\nclass Svc:\n    # lint: dispatch\n"
                        "    def run(self, x):\n"
                        "        t0 = time.perf_counter()\n"
                        "        return x, t0\n", ["L003"]),
    # L005: a tensor's bytes into a digest
    "numpy-tobytes": ("import hashlib\ndef tensor_digest(t):\n"
                      "    return hashlib.sha256(t.numpy().tobytes())"
                      ".hexdigest()\n", ["L005"]),
}

GOOD = {
    "rand-generator": ("import torch\ndef f(n, dev, gen):\n"
                       "    return torch.rand((n,), device=dev, "
                       "generator=gen)\n"),
    "generator-seed": ("import torch\ndef f(seed, dev):\n"
                       "    g = torch.Generator(device=dev)\n"
                       "    g.manual_seed(int(seed))\n"
                       "    return torch.Generator().manual_seed(seed)\n"),
    "inplace-generator": ("def f(w, gen):\n"
                          "    w.uniform_(0, 1, generator=gen)\n"),
    "init-deterministic": ("import torch\ndef f(w):\n"
                           "    torch.nn.init.zeros_(w)\n"),
    "kwargs": "import torch\ndef f(kw):\n    return torch.rand(3, **kw)\n",
    "host-param": _in_tell("if n > 2:", "    state = state * 2"),
    "shape": _in_tell("if fitness.shape[0] > 1 and fitness.dim() == 2:",
                      "    state = state * 2"),
    "is-none": _in_tell("if state is None:", "    state = fitness"),
    "where-3": _in_tell("state = torch.where(fitness > 0, fitness, state)"),
    "index-by-ints": _in_tell("best = fitness[:, fitness.argmax(-1)]"),
    "host-strategy": ('''
        from repro_torch.core.strategies.base import SearchStrategy
        class HostS(SearchStrategy):
            def tell(self, state, fitness):
                self.best = float(fitness.max().item())
                return state
        '''),
    "unmarked": "def f(x):\n    return x.sum().item()\n",
    # a marked method is not a strategy: its object may keep counters
    "marked-counter": ("class Svc:\n    # lint: dispatch\n"
                       "    def run(self, x):\n"
                       "        self.calls += 1\n        return x\n"),
    "pure-ask": ('''
        from repro_torch.core.strategies.base import SearchStrategy
        class S(SearchStrategy):
            def ask(self, state):
                state = state._replace(step=state.step + 1)
                return state, state.accel, state.prio
        '''),
    "digest-le": ("import hashlib\ndef tensor_digest(t):\n"
                  "    b = t.numpy().astype('<f4').tobytes()\n"
                  "    return hashlib.sha256(b).hexdigest()\n"),
}


def _expected(name):
    case = BAD[name]
    if isinstance(case, tuple):
        return case
    rule = ("L001" if name in ("randn_like", "randperm-none", "multinomial",
                               "normal_", "nn.init", "manual_seed",
                               "cuda.manual_seed_all") else
            "L003" if name in ("self-mutation", "clock", "setattr") else
            "L002")
    return case, [rule]


@pytest.mark.parametrize("name", list(BAD))
def test_bad_snippet_trips_its_rule(name):
    code, rules = _expected(name)
    assert _rules(_lint(code)) == rules


@pytest.mark.parametrize("name", list(GOOD))
def test_good_snippet_is_silent(name):
    assert _lint(GOOD[name]) == []


def test_pragma_suppresses_a_torch_rule():
    code = ("import torch\ndef f(n):\n"
            "    return torch.rand(n)  # lint: disable=L001(a test)\n")
    assert _lint(code) == []


# ---------------------------------------------------------------------------
# mutations of the port's own code
# ---------------------------------------------------------------------------
def _mutate(rel, anchor, line):
    """``rel``'s text with ``line`` inserted after the line holding
    ``anchor``, and the inserted line's number."""
    path = os.path.join(PORT, *rel.split("/"))
    with open(path) as f:
        lines = f.read().split("\n")
    at = next(i for i, s in enumerate(lines) if anchor in s)
    indent = lines[at + 1][:len(lines[at + 1]) - len(lines[at + 1].lstrip())]
    lines.insert(at + 1, indent + line)
    return path, "\n".join(lines), at + 2


def test_item_in_scan_steps_is_found():
    path, text, line = _mutate("core/strategies/driver.py",
                               "hist[:, g:g + sp[0]] = step.run(",
                               "top = hist.max().item()")
    assert lint_text(path, open(path).read()) == []
    got = [f for f in lint_text(path, text) if f.line == line]
    assert {f.rule for f in got} == {"L002"}
    assert all("scan_steps" in f.message for f in got)


def test_item_in_the_captured_generation_step_is_found():
    """The generation a CUDA graph captures is in the dispatch region: a
    host sync there would fail the capture on the card."""
    path, text, line = _mutate("core/strategies/graphs.py",
                               "fit = self.eval_fn(accel, prio)",
                               "best = fit.max().item()")
    assert lint_text(path, open(path).read()) == []
    got = [f for f in lint_text(path, text) if f.line == line]
    assert [f.rule for f in got] == ["L002"]
    assert "generation" in got[0].message


def test_global_draw_in_a_strategy_ask_is_found():
    path, text, line = _mutate(
        "core/strategies/magma_strategy.py", "def ask(self, state",
        "noise = torch.rand((4,), device=state.accel.device)")
    got = [f for f in lint_text(path, text) if f.line == line]
    assert [f.rule for f in got] == ["L001"]


def test_store_annotations_are_load_bearing():
    """Stripping ``@holds`` from the port's MemoStore gives L004
    findings: the annotations (and the port's L004) are live."""
    path = os.path.join(PORT, "memo", "store.py")
    with open(path) as f:
        text = f.read()
    stripped = text.replace('"""@holds:_lock"""', '"""stripped"""')
    assert stripped != text
    assert any(f.rule == "L004" for f in lint_text(path, stripped))


def test_dispatch_marks_reach_the_generation_path():
    """The per-generation functions outside a strategy carry ``# lint:
    dispatch``: stripping the marks silences a finding inside one."""
    path, text, line = _mutate("core/encoding.py", "P, G = accel.shape",
                               "n = int(prio.max())")
    assert [f.rule for f in lint_text(path, text)
            if f.line == line] == ["L002"]
    unmarked = text.replace("# lint: dispatch", "#")
    assert [f for f in lint_text(path, unmarked) if f.line == line] == []


# ---------------------------------------------------------------------------
# self-hosting
# ---------------------------------------------------------------------------
def test_port_is_strict_clean():
    findings = run([PORT])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_linter_lints_itself_clean():
    findings = run([os.path.join(PORT, "lint")])
    assert findings == [], "\n".join(f.render() for f in findings)


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.lint", *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def test_cli_strict_exits_zero_on_the_port():
    proc = _cli("src/repro_torch", "--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("0 findings (strict)")


def test_cli_strict_exit_codes_and_select(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD["rand"][0])
    proc = _cli(str(bad), "--strict")
    assert proc.returncode == 1 and "L001" in proc.stdout, proc.stdout
    assert _cli(str(bad)).returncode == 0                  # report-only
    assert _cli(str(bad), "--strict", "--select", "L004").returncode == 0
    assert _cli(str(bad), "--select", "L999").returncode == 2


def test_linter_imports_neither_torch_nor_jax():
    """The analyzer reads source text: it runs on the card's host (no
    JAX) and anywhere without importing torch."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.lint.__main__; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'jax', 'repro')))"],
        env=env, capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"
