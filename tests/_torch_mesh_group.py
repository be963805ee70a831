"""What the port's mesh tests (``tests/test_torch_mesh_*.py``) share: the
gloo group of CPU ranks that runs their jobs (``spawn``) and the
single-device runs the jobs are held against.

Each test module starts its own groups in its own module fixture, so
``pytest -n N --dist loadfile`` runs the modules on different workers.
A group's ranks run ``_torch_mesh_worker.run`` on a ``file://`` store
under the test's temporary directory (no ports, so parallel test workers
never clash).  Every group has a deadline, and its ranks' collectives a
timeout (``collective_timeout``) that no wait for a rank still in its
previous job should reach, so a hung rank fails the tests instead of
hanging them; when a group fails, the error says what each rank was
doing, for how long, and the wall of every job it finished.  A group
that ends prints its wall and each job's (the slowest rank's), which
``pytest -s`` shows: the way to measure a module's ``IDLE_S`` and
``JOB_IDLE_S``.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_worker as W  # noqa: E402


def _progress(store, world, t0):
    """One line a rank: what it is doing, since when, and the walls of the
    jobs it finished."""
    lines = []
    for r in range(world):
        try:
            with open(W.progress_path(store, r)) as f:
                p = json.load(f)
        except (OSError, ValueError):
            lines.append(f"  rank {r}: not started")
            continue
        done = ", ".join(f"{n} {w:.1f} s" for n, w in p["done"])
        doing = (f"{p['doing']} for {time.time() - p['since']:.1f} s"
                 if p["doing"] else "finished")
        lines.append(f"  rank {r}: {doing}; done: {done or 'nothing'}")
    return (f"after {time.monotonic() - t0:.1f} s:\n" + "\n".join(lines))


def collective_timeout(margin, job_idle_s):
    """How long a rank's collective may wait: ``margin`` times the
    longest job's wall on an idle host (a rank waits at most for the
    others to finish the job before), and never under gloo's 60 s that
    the group had before."""
    return max(60.0, margin * job_idle_s)


def spawn(world, d, jobs, deadline_s, collective_s):
    """Run ``jobs`` ((name, job, kwargs) each) on ``world`` gloo ranks;
    {name: [result of each rank]}.  Every collective of a rank waits at
    most ``collective_s``, and every rank is killed when the group is
    still running after ``deadline_s``."""
    import torch.multiprocessing as mp
    store = os.path.join(d, f"store{world}")
    t0 = time.monotonic()
    ctx = mp.spawn(W.run, args=(world, store, d, jobs, collective_s),
                   nprocs=world, join=False)
    try:
        while True:
            try:
                if ctx.join(timeout=1.0):
                    break
            except Exception as e:      # a rank raised or died
                raise RuntimeError(
                    f"{world}-rank group failed {_progress(store, world, t0)}"
                    f"\n{e}") from None
            if time.monotonic() - t0 > deadline_s:
                raise TimeoutError(
                    f"{world}-rank group still running at its deadline of "
                    f"{deadline_s} s, {_progress(store, world, t0)}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = {}
    for name, _, _ in jobs:
        out[name] = [torch.load(os.path.join(d, f"{name}_{r}.pt"),
                                weights_only=False) for r in range(world)]
    print(f"{world}-rank group: wall {time.monotonic() - t0:.1f} s, "
          f"deadline {deadline_s} s, collective timeout {collective_s} s; "
          "jobs: " + ", ".join(
              f"{n} {max(r['wall_s'] for r in ranks):.1f} s"
              for n, ranks in out.items()))
    return out


def ok(runs, name):
    """The per-rank results of job ``name``, failing on a rank's error."""
    ranks = runs["res"][name]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"{name} rank {r}:\n{res['error']}"
    return ranks


def reference_weights(arch, path, **overrides):
    """The reference's float32 smoke weights of ``arch`` (seed 0, config
    ``overrides``), carried into the port and saved as a state dict;
    (JAX model, value tree)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import module as jmodule
    from repro.models import registry as jregistry
    from repro_torch.convert import model_from_numpy

    jm = jregistry.get_model(jsmoke(arch).replace(dtype="float32",
                                                  **overrides))
    values, _ = jmodule.split(jm.init(jax.random.PRNGKey(0)))
    values = jax.tree.map(np.asarray, values)
    torch.save(model_from_numpy(W.smoke_cfg(arch, **overrides), values,
                                "cpu").state_dict(), path)
    return jm, values


def meshless_step(cfg, weights, seq, batch=None):
    """The meshless port's loss and {name: gradient} on ``batch`` (batch 0
    of ``cfg``'s seeded stream when None)."""
    from repro_torch.train.data import TokenStream
    model = W._model(cfg, weights)
    if batch is None:
        batch = TokenStream(cfg, W.BATCH, seq, seed=0).batch_at(0)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def grads_within(got, want, rel=1e-5):
    """Every gradient of ``want`` matched within ``rel`` x its max|g|."""
    for name, g in want.items():
        scale = float(g.abs().max()) or 1.0
        assert float((got[name] - g).abs().max()) <= rel * scale, name


def reference_leaf(tree, name, shape):
    """The numpy leaf of the reference's value tree that the port's
    parameter ``name`` holds: a per-layer module's index takes that layer
    of the stacked leaf, and a block stacked ``(1, ...)`` (the hybrid's
    shared block) gives its one entry."""
    node, index = tree, None
    for part in name.split("."):
        if part.isdigit():
            index = int(part)
        else:
            node = node[part] if isinstance(node, dict) else \
                getattr(node, part)
    leaf = np.asarray(node)
    if index is not None:
        leaf = leaf[index]
    elif leaf.shape != tuple(shape) and leaf.shape[1:] == tuple(shape):
        leaf = leaf[0]
    assert leaf.shape == tuple(shape), name
    return leaf


def reference_step(jm, values, cfg, seq, batch=None):
    """The reference's loss and gradients (``jax.grad``) on ``batch``
    (batch 0 of ``cfg``'s seeded stream when None)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro_torch.train.data import TokenStream

    if batch is None:
        batch = TokenStream(cfg, W.BATCH, seq, seed=0).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.value_and_grad(lambda v: jm.loss(v, jb)[0])(
        jax.tree.map(jnp.asarray, values))


def within_reference(loss, grads, jloss, jgrads):
    """A mesh run's loss within rtol 1e-4 of the reference's and each of
    its gradients within 1e-5 x the reference's largest |g|."""
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    want = {k: reference_leaf(jgrads, k, g.shape) for k, g in grads.items()}
    gmax = max(float(np.abs(g).max()) for g in want.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=1e-5 * gmax, err_msg=name)
