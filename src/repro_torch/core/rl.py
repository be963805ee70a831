"""RL baseline mappers — A2C and PPO2 (Table IV), in PyTorch.

The episode builds a schedule job-by-job: at step g the policy observes
job g's per-accelerator (no-stall latency, required BW) plus the running
per-accelerator load, and emits (i) a categorical sub-accelerator choice and
(ii) a Gaussian priority (squashed to [0,1]).  The terminal reward is the
group throughput of the completed schedule (normalized by a random-schedule
baseline so gradients are scale-free).

Policy/critic: 3 MLP layers x 128 (Table IV), held as a dict of tensors
(``"torso.0.w"``, ...; ``repro_torch.convert.policy_from_numpy`` carries
the reference's ``init_policy`` weights across).  A2C uses RMSProp lr
7e-4, discount 0.99; PPO2 uses Adam lr 2.5e-4, clip 0.2, discount 0.99.
One "sample" of the paper's 10K budget = one full-schedule evaluation =
one episode.

On the search's device (the fitness' device): a batch of episodes rolls
out as a loop over the G jobs with the batch's episodes side by side
(their random numbers drawn up front from the search's generator; see
``_rollout`` for how the step is kept short), the batch's fitness is one
evaluation, and the update replays the recorded
actions for every step at once -- each step's load is an exclusive
cumulative sum of the recorded placements, which adds the same numbers in
the same order as the reference's step loop -- and differentiates with
autograd.  The reward normaliser, ``_features``, ``_returns`` and
``_prep_tables`` are the reference's.  The best schedule is folded on the
device and read back once, at the end.
"""
from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core.encoding import random_population
from repro_torch.core.fitness import FitnessFn
from repro_torch.core.magma import SearchResult
from repro_torch.train.optimizer import AdamW, RMSProp, apply_updates

_HID = 128
Tree = Dict[str, torch.Tensor]
# the reference's PolicyParams fields and each one's layer widths
# (feat = the observation width, A = the sub-accelerators)
HEADS = ("torso", "accel_head", "prio_head", "critic")


def _sizes(feat_dim: int, num_accels: int):
    return {"torso": [feat_dim, _HID, _HID],
            "accel_head": [_HID, _HID, num_accels],
            "prio_head": [_HID, _HID, 1],
            "critic": [feat_dim, _HID, _HID, 1]}


def init_policy(gen: torch.Generator, feat_dim: int,
                num_accels: int) -> Tree:
    """He-initialised weights and zero biases, as the reference's
    ``init_policy``, drawn from ``gen`` on its device; ``log_std`` 0."""
    dev = gen.device
    params: Tree = {}
    for head, sizes in _sizes(feat_dim, num_accels).items():
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            params[f"{head}.{i}.w"] = torch.randn(
                (a, b), generator=gen, device=dev) * math.sqrt(2.0 / a)
            params[f"{head}.{i}.b"] = torch.zeros((b,), device=dev)
    params["log_std"] = torch.zeros((), device=dev)
    return params


def _mlp(params: Tree, head: str, x: torch.Tensor) -> torch.Tensor:
    n = sum(1 for k in params if k.startswith(head + ".")) // 2
    for i in range(n):
        x = x @ params[f"{head}.{i}.w"] + params[f"{head}.{i}.b"]
        if i + 1 < n:
            x = torch.tanh(x)
    return x


def _features(lat_n, bw_n, load, g, G):
    """Observation at step ``g``: job g's tables, the load (..., A)
    normalized by its max, and the progress g / G -> (..., 3A + 1).  For
    a tensor of steps ``g`` (S,), load is (..., S, A): every step's
    observation at once."""
    g = torch.as_tensor(g, device=load.device)
    prog = (g.to(torch.float32) / G)[..., None]
    shape = load.shape
    return torch.cat([lat_n[g].expand(shape), bw_n[g].expand(shape),
                      load / (load.amax(dim=-1, keepdim=True) + 1e-6),
                      prog.expand(shape[:-1] + (1,))], dim=-1)


@torch.no_grad()
def _rollout(params: Tree, gen: torch.Generator, lat_n, bw_n,
             num_accels: int, batch: int):
    """``batch`` episodes side by side -> (accel (B, G) int32, prio (B, G)
    f32, z (B, G) f32, the pre-sigmoid priority draws).

    The step loop is what the host issues G times a batch, so it is kept
    short: the observation's job and progress columns go through the
    torso's first layer for every step at once (only the load columns are
    added step by step), the two heads' first layers run as one product,
    and the Gumbel noise of the categorical draw and the priority noise
    are drawn for the whole episode up front and folded into the heads'
    last biases.  Same distributions as ``_replay_logp``'s policy."""
    G, A = lat_n.shape
    dev = lat_n.device
    u = torch.rand((G, batch, A), generator=gen, device=dev)
    noise = torch.randn((G, batch, 1), generator=gen, device=dev)
    w0 = params["torso.0.w"]
    prog = torch.arange(G, dtype=torch.float32, device=dev)[:, None] / G
    static = torch.addmm(params["torso.0.b"],
                         torch.cat([lat_n, bw_n, prog], dim=1),
                         torch.cat([w0[:2 * A], w0[3 * A:]]))
    w_load = w0[2 * A:3 * A]
    heads_w = torch.cat([params["accel_head.0.w"], params["prio_head.0.w"]],
                        dim=1)
    heads_b = torch.cat([params["accel_head.0.b"], params["prio_head.0.b"]])
    logit_b = params["accel_head.1.b"] - torch.log(
        -torch.log(u.clamp_min(1e-20)))                       # + Gumbel
    z_b = params["prio_head.1.b"] + torch.exp(params["log_std"]) * noise
    load = torch.zeros((batch, A), device=dev)
    acts = torch.empty((G, batch), dtype=torch.int64, device=dev)
    zs = torch.empty((G, batch, 1), device=dev)
    for g in range(G):
        loadn = load / (load.amax(dim=1, keepdim=True) + 1e-6)
        h = torch.tanh(torch.addmm(static[g], loadn, w_load))
        h = torch.tanh(torch.addmm(params["torso.1.b"], h,
                                   params["torso.1.w"]))
        hh = torch.tanh(torch.addmm(heads_b, h, heads_w))
        a = torch.argmax(torch.addmm(logit_b[g], hh[:, :_HID],
                                     params["accel_head.1.w"]), dim=1,
                         out=acts[g])
        torch.addmm(z_b[g], hh[:, _HID:], params["prio_head.1.w"],
                    out=zs[g])
        load.scatter_add_(1, a[:, None], lat_n[g][a][:, None])
    z = zs[..., 0].T
    return acts.T.to(torch.int32), torch.sigmoid(z), z.contiguous()


def _returns(reward, G, gamma):
    """A single terminal reward discounted back through the episode:
    reward (...,) -> (..., G)."""
    disc = gamma ** torch.arange(G - 1, -1, -1, dtype=torch.float32,
                                 device=reward.device)
    return reward[..., None] * disc


def _prep_tables(fitness_fn: FitnessFn):
    lat = np.log10(np.maximum(fitness_fn.table.lat, 1e-12))
    bw = np.log10(np.maximum(fitness_fn.table.bw, 1e-3))
    lat_n = (lat - lat.mean()) / (lat.std() + 1e-6)
    bw_n = (bw - bw.mean()) / (bw.std() + 1e-6)
    dev = fitness_fn.device
    return (torch.as_tensor(lat_n, dtype=torch.float32, device=dev),
            torch.as_tensor(bw_n, dtype=torch.float32, device=dev))


def _replay_logp(params: Tree, accel, z, lat_n, bw_n, num_accels: int):
    """logp / values / entropy of recorded episodes (B, G) under
    ``params``, every step at once -> three (B, G) tensors."""
    B, G = accel.shape
    a = accel.long()
    placed = lat_n[torch.arange(G, device=a.device), a]          # (B, G)
    c = torch.zeros((B, G, num_accels), device=a.device).scatter(
        2, a[..., None], placed[..., None])
    load = torch.cat([torch.zeros_like(c[:, :1]),
                      torch.cumsum(c, dim=1)[:, :-1]], dim=1)
    obs = _features(lat_n, bw_n, load, torch.arange(G, device=a.device),
                    G)
    h = torch.tanh(_mlp(params, "torso", obs))
    logits = _mlp(params, "accel_head", h)
    logsm = torch.log_softmax(logits, dim=-1)
    logp_a = torch.gather(logsm, -1, a[..., None])[..., 0]
    mean = _mlp(params, "prio_head", h)[..., 0]
    log_std = params["log_std"]
    std = torch.exp(log_std)
    logp_p = (-0.5 * ((z - mean) / std) ** 2
              - log_std - 0.5 * math.log(2 * math.pi))
    v = _mlp(params, "critic", obs)[..., 0]
    ent = -torch.sum(torch.softmax(logits, dim=-1) * logsm, dim=-1)
    return logp_a + logp_p, v, ent


def a2c_loss(params: Tree, accel, z, rewards, lat_n, bw_n, num_accels: int,
             gamma: float) -> torch.Tensor:
    """The reference's A2C loss, averaged over the batch's episodes."""
    logp, v, ent = _replay_logp(params, accel, z, lat_n, bw_n, num_accels)
    ret = _returns(rewards, accel.shape[1], gamma)
    adv = (ret - v).detach()
    return (-(logp * adv).mean(dim=1) + 0.5 * ((v - ret) ** 2).mean(dim=1)
            - 0.01 * ent.mean(dim=1)).mean()


def ppo_loss(params: Tree, accel, z, rewards, logp_old, lat_n, bw_n,
             num_accels: int, gamma: float, clip: float = 0.2
             ) -> torch.Tensor:
    """The reference's PPO2 clipped loss, averaged over the episodes."""
    logp, v, ent = _replay_logp(params, accel, z, lat_n, bw_n, num_accels)
    ret = _returns(rewards, accel.shape[1], gamma)
    adv = (ret - v).detach()
    adv = (adv - adv.mean(dim=1, keepdim=True)) / (
        adv.std(dim=1, unbiased=False, keepdim=True) + 1e-6)
    ratio = torch.exp(logp - logp_old)
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    return (-surr.mean(dim=1) + 0.5 * ((v - ret) ** 2).mean(dim=1)
            - 0.01 * ent.mean(dim=1)).mean()


def _grads(loss_fn, params: Tree) -> Tree:
    live = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    grads = torch.autograd.grad(loss_fn(live), list(live.values()))
    return dict(zip(live, grads))


def _a2c_update(params, opt_state, accel, z, rewards, lat_n, bw_n,
                num_accels, gamma, opt):
    grads = _grads(lambda p: a2c_loss(p, accel, z, rewards, lat_n, bw_n,
                                      num_accels, gamma), params)
    updates, opt_state = opt.update(grads, opt_state)
    return apply_updates(params, updates), opt_state


def _ppo_update(params, opt_state, accel, z, rewards, lat_n, bw_n,
                num_accels, gamma, opt):
    with torch.no_grad():
        logp_old, _, _ = _replay_logp(params, accel, z, lat_n, bw_n,
                                      num_accels)
    for _ in range(4):  # PPO epochs
        grads = _grads(lambda p: ppo_loss(p, accel, z, rewards, logp_old,
                                          lat_n, bw_n, num_accels, gamma),
                       params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
    return params, opt_state


def _run_rl(fitness_fn: FitnessFn, budget: int, seed: int, batch: int,
            update_fn, opt, gamma: float) -> SearchResult:
    dev = fitness_fn.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lat_n, bw_n = _prep_tables(fitness_fn)
    G, A = fitness_fn.group_size, fitness_fn.num_accels
    params = init_policy(gen, 2 * A + A + 1, A)
    opt_state = opt.init(params)

    # reward normalizer: mean random-schedule fitness
    rnd = random_population(gen, 32, G, A, dev)
    scale = float(np.mean(fitness_fn(rnd.accel, rnd.prio).cpu().numpy())) \
        + 1e-9

    t0 = time.perf_counter()
    n = -(-budget // batch)
    bf = torch.full((), float("-inf"), device=dev)
    ba = torch.zeros((G,), dtype=torch.int32, device=dev)
    bp = torch.zeros((G,), dtype=torch.float32, device=dev)
    hist = torch.empty((n,), dtype=torch.float32, device=dev)
    for step in range(n):
        accel, prio, z = _rollout(params, gen, lat_n, bw_n, A, batch)
        fits = fitness_fn(accel, prio)
        params, opt_state = update_fn(params, opt_state, accel, z,
                                      fits / scale, lat_n, bw_n, A, gamma,
                                      opt)
        i = torch.argmax(fits, dim=-1, keepdim=True)
        better = fits[i][0] > bf
        bf = torch.where(better, fits[i][0], bf)
        ba = torch.where(better, accel[i][0], ba)
        bp = torch.where(better, prio[i][0], bp)
        hist[step] = bf
    return SearchResult(best_fitness=float(bf.cpu()),
                        best_accel=ba.cpu().numpy(),
                        best_prio=bp.cpu().numpy(),
                        history_samples=batch * np.arange(1, n + 1),
                        history_best=hist.cpu().numpy().astype(np.float64),
                        n_samples=batch * n,
                        wall_time_s=time.perf_counter() - t0)


def a2c(fitness_fn: FitnessFn, budget: int = 10_000, seed: int = 0,
        batch: int = 20, gamma: float = 0.99) -> SearchResult:
    return _run_rl(fitness_fn, budget, seed, batch, _a2c_update,
                   RMSProp(lr=7e-4), gamma)


def ppo2(fitness_fn: FitnessFn, budget: int = 10_000, seed: int = 0,
         batch: int = 20, gamma: float = 0.99) -> SearchResult:
    return _run_rl(fitness_fn, budget, seed, batch, _ppo_update,
                   AdamW(lr=2.5e-4), gamma)
