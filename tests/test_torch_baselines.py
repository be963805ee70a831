"""Port parity: the host-side Table IV baselines — the hand heuristics, the
numpy black-box optimizers and the RL mappers.

- Heuristics: ``herald_like`` / ``ai_mt_like`` give the reference's accel
  and prio genomes exactly and its fitness at rtol 1e-5.
- Host optimizers: the port's loop and the reference's run with the same
  numpy seed and one shared fitness callable (the reference's
  ``FitnessFn``, its output handed to both), so the only difference is
  the loops' code; ``history_best`` and the best genomes must agree
  exactly (we state rtol 1e-6 and measure 0).
- RL: the deterministic parts at 1e-5 -- ``_prep_tables``,
  ``_features``, ``_returns``, the policy forward with the reference's
  ``init_policy`` weights carried across (``convert.policy_from_numpy``),
  the A2C and PPO2 losses (rtol 1e-5) and gradients (1e-5 max|g| per
  leaf) for one injected rollout, and one whole update (parameters within
  1e-5, a hundredth of what PPO2's four Adam epochs at lr 2.5e-4 can move
  a parameter: a gradient element near 0 can take the other sign, 2.7e-6
  measured); ``RMSProp`` at rtol 1e-6 over 5 steps.  The whole search is
  statistical: the best-fitness geomean over eight seeds within
  ``RL_RATIO_TOL`` of the reference's, at one batch of 200 episodes of
  the initial policy (the reference retraces its rollout every batch, ~1
  s here, so more batches are too slow for this suite; the best of 20
  episodes spread too far to hold anything).  ``measure_rl_ratio_spread``
  is the measurement behind the tolerance: over five disjoint sets of
  eight seeds the ratio ranged over 0.9570-1.0025, for both methods (one
  batch: the same initial policy and draws).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import heuristics as ref_heur  # noqa: E402
from repro.core import rl as ref_rl  # noqa: E402
from repro.core.m3e import M3E as RefM3E  # noqa: E402
from repro.core.optimizers import blackbox as ref_opt  # noqa: E402
from repro.costmodel import get_setting as ref_setting  # noqa: E402
from repro.train import optimizer as ref_train_opt  # noqa: E402
from repro.workloads import build_task_groups as ref_groups  # noqa: E402
from repro_torch.convert import policy_from_numpy  # noqa: E402
from repro_torch.core import heuristics, rl  # noqa: E402
from repro_torch.core.m3e import M3E, geomean  # noqa: E402
from repro_torch.core.optimizers import blackbox as opt  # noqa: E402
from repro_torch.costmodel import GB, get_setting  # noqa: E402
from repro_torch.train.optimizer import AdamW, RMSProp  # noqa: E402
from repro_torch.workloads import build_task_groups  # noqa: E402

RL_SEEDS = range(8)
RL_BUDGET = 200
RL_RATIO_TOL = 0.06


def _problem(setting="S2", task="Mix", G=20, bw=16):
    ref = RefM3E(ref_setting(setting), bw_sys=bw * GB)
    port = M3E(get_setting(setting), bw_sys=bw * GB, device="cpu")
    return (ref.prepare(ref_groups(task, group_size=G, seed=0)[0]),
            port.prepare(build_task_groups(task, group_size=G, seed=0)[0]),
            ref, port)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# heuristics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("setting,task", [("S2", "Mix"), ("S4", "Vision"),
                                          ("S3", "Mix")])
@pytest.mark.parametrize("name", ["herald_like", "ai_mt_like"])
def test_heuristics_equal_reference(setting, task, name):
    ref_fit, fit, _, _ = _problem(setting, task)
    want = getattr(ref_heur, name)(ref_fit)
    got = getattr(heuristics, name)(fit)
    np.testing.assert_array_equal(got.best_accel, want.best_accel)
    np.testing.assert_array_equal(got.best_prio, want.best_prio)
    assert got.best_fitness == pytest.approx(want.best_fitness, rel=1e-5)
    assert got.n_samples == 1 and got.history_best.shape == (1,)


# ---------------------------------------------------------------------------
# host optimizers on one shared fitness
# ---------------------------------------------------------------------------
class _Shared:
    """The reference's FitnessFn behind the port's fitness interface:
    both loops see the same fitness values."""

    def __init__(self, ref_fit):
        self.ref = ref_fit
        self.group_size = ref_fit.group_size
        self.num_accels = ref_fit.num_accels
        self.device = torch.device("cpu")

    def __call__(self, accel, prio):
        out = np.asarray(self.ref(jnp.asarray(np.asarray(accel)),
                                  jnp.asarray(np.asarray(prio))))
        return torch.as_tensor(out.copy()) \
            if isinstance(accel, torch.Tensor) else out


@pytest.mark.parametrize("name", ["random_search", "std_ga",
                                  "differential_evolution", "pso", "cma_es",
                                  "tbpsa"])
@pytest.mark.parametrize("setting", ["S2", "S3"])
def test_host_optimizer_trajectories_equal_reference(name, setting):
    ref_fit, _, _, _ = _problem(setting, G=12)
    shared = _Shared(ref_fit)
    want = getattr(ref_opt, name)(shared, budget=600, seed=5)
    got = getattr(opt, name)(shared, budget=600, seed=5)
    np.testing.assert_allclose(got.history_best, want.history_best,
                               rtol=1e-6)
    np.testing.assert_array_equal(got.history_samples, want.history_samples)
    np.testing.assert_array_equal(got.best_accel, want.best_accel)
    np.testing.assert_array_equal(got.best_prio, want.best_prio)
    assert got.n_samples == want.n_samples


def test_host_optimizers_evaluate_on_the_fitness_device():
    ref_fit, fit, _, _ = _problem(G=12)
    got = opt.cma_es(fit, budget=300, seed=1)
    again = float(ref_fit(jnp.asarray(got.best_accel[None]),
                          jnp.asarray(got.best_prio[None]))[0])
    assert again == pytest.approx(got.best_fitness, rel=1e-5)


# ---------------------------------------------------------------------------
# RL: the deterministic parts
# ---------------------------------------------------------------------------
def _policy(G=12, A=4, seed=0):
    ref_fit, fit, _, _ = _problem("S2" if A == 4 else "S3", G=G)
    ref_params = ref_rl.init_policy(jax.random.PRNGKey(seed), 3 * A + 1, A)
    return ref_fit, fit, ref_params, policy_from_numpy(_np(ref_params),
                                                       "cpu")


def _rollout_inputs(seed, B, G, A):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, A, (B, G)).astype(np.int32),
            rng.normal(size=(B, G)).astype(np.float32),
            rng.uniform(0.5, 2.0, B).astype(np.float32))


@pytest.mark.parametrize("A", [4, 8])
def test_rl_tables_features_returns_and_policy_equal_reference(A):
    ref_fit, fit, ref_params, params = _policy(A=A)
    lat_n, bw_n = rl._prep_tables(fit)
    r_lat, r_bw = ref_rl._prep_tables(ref_fit)
    np.testing.assert_array_equal(lat_n.numpy(), np.asarray(r_lat))
    np.testing.assert_array_equal(bw_n.numpy(), np.asarray(r_bw))
    G = lat_n.shape[0]
    load = np.random.default_rng(A).uniform(0, 3, A).astype(np.float32)
    for g in (0, 5, G - 1):
        want = ref_rl._features(r_lat, r_bw, jnp.asarray(load),
                                jnp.int32(g), G)
        got = rl._features(lat_n, bw_n, torch.as_tensor(load), g, G)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    want = ref_rl._returns(jnp.float32(1.7), G, 0.99)
    got = rl._returns(torch.tensor(1.7), G, 0.99)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    obs = np.random.default_rng(1).normal(size=(5, 3 * A + 1)).astype(
        np.float32)
    for head, x in (("torso", obs), ("critic", obs)):
        want = ref_rl._mlp(getattr(ref_params, head), jnp.asarray(obs))
        got = rl._mlp(params, head, torch.as_tensor(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    h = np.tanh(np.asarray(ref_rl._mlp(ref_params.torso, jnp.asarray(obs))))
    for head in ("accel_head", "prio_head"):
        want = ref_rl._mlp(getattr(ref_params, head), jnp.asarray(h))
        got = rl._mlp(params, head, torch.as_tensor(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def _ref_losses(p, accel, z, rewards, lat_n, bw_n, A, gamma, logp_old=None):
    G = lat_n.shape[0]

    def per_ep(acc_e, z_e, r_e, lo_e):
        logp, v, ent = ref_rl._replay_logp(p, acc_e, z_e, lat_n, bw_n, A)
        ret = ref_rl._returns(r_e, G, gamma)
        adv = jax.lax.stop_gradient(ret - v)
        if lo_e is None:
            pg = -(logp * adv).mean()
        else:
            adv = (adv - adv.mean()) / (adv.std() + 1e-6)
            ratio = jnp.exp(logp - lo_e)
            pg = -jnp.minimum(ratio * adv,
                              jnp.clip(ratio, 0.8, 1.2) * adv).mean()
        return pg + 0.5 * jnp.mean((v - ret) ** 2) - 0.01 * ent.mean()
    if logp_old is None:
        return jax.vmap(lambda a, b, c: per_ep(a, b, c, None))(
            accel, z, rewards).mean()
    return jax.vmap(per_ep)(accel, z, rewards, logp_old).mean()


def _assert_tree_close(got, want_tree, rel_to_max):
    want = policy_from_numpy(_np(want_tree), "cpu")
    for k, w in want.items():
        g = got[k].numpy()
        scale = float(np.abs(w.numpy()).max()) if rel_to_max else 1.0
        np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                   atol=1e-5 * max(scale, 1e-30)
                                   if rel_to_max else 1e-5, err_msg=k)


@pytest.mark.parametrize("A", [4, 8])
@pytest.mark.parametrize("algo", ["a2c", "ppo2"])
def test_rl_losses_gradients_and_update_equal_reference(A, algo):
    ref_fit, fit, ref_params, params = _policy(A=A, seed=A)
    lat_n, bw_n = rl._prep_tables(fit)
    r_lat, r_bw = ref_rl._prep_tables(ref_fit)
    accel, z, rewards = _rollout_inputs(A, 6, lat_n.shape[0], A)
    ja, jz, jr = jnp.asarray(accel), jnp.asarray(z), jnp.asarray(rewards)
    ta, tz, tr = map(torch.as_tensor, (accel, z, rewards))
    if algo == "a2c":
        ref_loss = lambda p: _ref_losses(p, ja, jz, jr, r_lat, r_bw, A, 0.99)
        loss = lambda p: rl.a2c_loss(p, ta, tz, tr, lat_n, bw_n, A, 0.99)
    else:
        lo = jax.vmap(lambda a, b: ref_rl._replay_logp(
            ref_params, a, b, r_lat, r_bw, A)[0])(ja, jz)
        with torch.no_grad():
            t_lo = rl._replay_logp(params, ta, tz, lat_n, bw_n, A)[0]
        np.testing.assert_allclose(t_lo.numpy(), np.asarray(lo), rtol=1e-5,
                                   atol=1e-5)
        ref_loss = lambda p: _ref_losses(p, ja, jz, jr, r_lat, r_bw, A, 0.99,
                                         logp_old=lo)
        loss = lambda p: rl.ppo_loss(p, ta, tz, tr, t_lo, lat_n, bw_n, A,
                                     0.99)
    want = float(ref_loss(ref_params))
    got = float(loss(params))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    _assert_tree_close(rl._grads(loss, params), jax.grad(ref_loss)(ref_params),
                       rel_to_max=True)

    if algo == "a2c":
        ref_opt_ = ref_train_opt.RMSProp(lr=7e-4)
        want_p, _ = ref_rl._a2c_update(ref_params, ref_opt_.init(ref_params),
                                       ja, jz, jr, r_lat, r_bw, A, 0.99)
        o = RMSProp(lr=7e-4)
        got_p, _ = rl._a2c_update(params, o.init(params), ta, tz, tr, lat_n,
                                  bw_n, A, 0.99, o)
    else:
        ref_opt_ = ref_train_opt.AdamW(lr=2.5e-4)
        want_p, _ = ref_rl._ppo_update(ref_params, ref_opt_.init(ref_params),
                                       ja, jz, jr, r_lat, r_bw, A, 0.99)
        o = AdamW(lr=2.5e-4)
        got_p, _ = rl._ppo_update(params, o.init(params), ta, tz, tr, lat_n,
                                  bw_n, A, 0.99, o)
    _assert_tree_close(got_p, want_p, rel_to_max=False)


def test_rmsprop_five_steps_equal_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 3), "b": (5,), "c": ()}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    ref, port = ref_train_opt.RMSProp(lr=1e-3), RMSProp(lr=1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    js, ts = ref.init(jp), port.init(tp)
    for _ in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32) * 1e-2
                 for k, s in shapes.items()}
        ju, js = ref.update({k: jnp.asarray(v) for k, v in grads.items()},
                            js)
        jp = ref_train_opt.apply_updates(jp, ju)
        tu, ts = port.update({k: torch.as_tensor(v) for k, v in grads.items()},
                             ts)
        for k in shapes:
            tp[k] = tp[k] + tu[k]
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                       rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# RL: whole searches, statistically
# ---------------------------------------------------------------------------
def _rl_ratio(method, seeds):
    ref_fit, fit, _, _ = _problem(G=10)
    want = [getattr(ref_rl, method)(ref_fit, budget=RL_BUDGET, seed=s,
                                    batch=RL_BUDGET).best_fitness
            for s in seeds]
    got = []
    for s in seeds:
        res = getattr(rl, method)(fit, budget=RL_BUDGET, seed=s,
                                  batch=RL_BUDGET)
        assert res.n_samples == RL_BUDGET
        again = float(fit(torch.as_tensor(res.best_accel[None]),
                          torch.as_tensor(res.best_prio[None]))[0])
        assert again == pytest.approx(res.best_fitness, rel=1e-6)
        got.append(res.best_fitness)
    return geomean(got) / geomean(want)


# one method: at one batch a2c and ppo2 draw the same initial policy and
# episodes (their update runs after the batch), so their ratios are equal
@pytest.mark.parametrize("method", ["a2c"])
def test_rl_search_geomean_matches_reference(method):
    ratio = _rl_ratio(method, RL_SEEDS)
    assert abs(ratio - 1.0) <= RL_RATIO_TOL, ratio


def test_rl_search_learns_on_the_port():
    _, fit, _, _ = _problem(G=10)
    res = rl.a2c(fit, budget=200, seed=0)
    assert res.history_best.shape == (10,)
    assert np.all(np.diff(res.history_best) >= 0)
    assert np.all(np.isfinite(res.history_best))


def measure_rl_ratio_spread(n_sets=5):
    """The measurement behind ``RL_RATIO_TOL``: the geomean ratio over
    ``n_sets`` disjoint sets of eight seeds, per method."""
    for method in ("a2c", "ppo2"):
        ratios = [_rl_ratio(method, range(8 * k, 8 * k + 8))
                  for k in range(n_sets)]
        print(f"{method}: port/reference geomean ratios "
              f"{', '.join(f'{r:.4f}' for r in ratios)}")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_baselines.py
    measure_rl_ratio_spread()
