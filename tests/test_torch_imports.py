"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``."""
import ast
import os

import pytest

pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_port_package_is_walked():
    files = _port_files()
    for part in (("kernels", "makespan.py"), ("memo", "engine.py"),
                 ("memo", "store.py"), ("memo", "fingerprint.py"),
                 ("obs", "trace.py"), ("core", "warmstart.py"),
                 ("launch", "serve.py"), ("launch", "train.py"),
                 ("launch", "mesh.py"), ("launch", "shardings.py"),
                 ("dist", "sharding.py"), ("dist", "compression.py"),
                 ("train", "fault.py"), ("lint", "core.py"),
                 ("lint", "checkers.py"), ("lint", "__main__.py")):
        assert os.path.join(PORT, *part) in files
    assert len(files) > 20


def test_mesh_rank_processes_import_only_the_port():
    """The gloo ranks of ``test_torch_mesh_train.py`` run
    ``_torch_mesh_worker``: it must not load JAX or the reference."""
    path = os.path.join(HERE, "_torch_mesh_worker.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert not [m for m in mods if _forbidden(m)]
    assert any(m.startswith("repro_torch") for m in mods)
