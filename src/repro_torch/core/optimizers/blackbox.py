"""Black-box baseline optimizers (Table IV): random search, stdGA, DE,
CMA-ES, TBPSA, PSO.

Hyper-parameters follow Table IV where the paper states them:
  stdGA  mutation 0.1, crossover 0.1
  DE     local/global differential weights 0.8
  CMA-ES elite group = best half
  TBPSA  initial population 50, size adapts
  PSO    w_global = w_parent = 0.8, momentum 1.6

These are deliberately the *standard* algorithms — the paper's point is that
MAGMA's domain-aware operators beat them on this search space.  CMA-ES and
TBPSA are faithful-in-structure reimplementations (full covariance CMA;
population-size-adaptive ES), not bindings to nevergrad.

The numpy random streams and arithmetic are those of
``repro.core.optimizers.blackbox``; fitness batches go to the
``FitnessFn``'s device.  ``random``/``std_ga``/``de``/``pso`` also have
device-resident ask/tell ports in ``repro_torch.core.strategies.blackbox``
(same algorithms and Table-IV hyper-parameters, torch generators instead
of numpy), which ``M3E.search`` and the sweeps run; the host loops here
are their executable references.  ``cma_es`` and ``tbpsa`` are the live
implementations, registered host-only
(``repro_torch.core.strategies.host`` says why).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.fitness import FitnessFn
from repro_torch.core.magma import SearchResult
from repro_torch.core.optimizers.base import Recorder, eval_x


def random_search(fitness_fn: FitnessFn, budget: int = 10_000, seed: int = 0,
                  batch: int = 100) -> SearchResult:
    rng = np.random.default_rng(seed)
    d = 2 * fitness_fn.group_size
    rec = Recorder()
    while rec.samples < budget:
        X = rng.random((min(batch, budget - rec.samples), d))
        rec.record(X, eval_x(fitness_fn, X))
    return rec.result(fitness_fn.num_accels)


def std_ga(fitness_fn: FitnessFn, budget: int = 10_000, seed: int = 0,
           population: int = 100, mutation_rate: float = 0.1,
           crossover_rate: float = 0.1, elite_frac: float = 0.1) -> SearchResult:
    """Standard GA: whole-genome single-point crossover + uniform mutation."""
    rng = np.random.default_rng(seed)
    d = 2 * fitness_fn.group_size
    n_elite = max(1, int(elite_frac * population))
    X = rng.random((population, d))
    rec = Recorder()
    while rec.samples < budget:
        fits = eval_x(fitness_fn, X)
        rec.record(X, fits)
        order = np.argsort(-fits)
        elites = X[order[:n_elite]]
        children = []
        while len(children) < population - n_elite:
            dad, mom = elites[rng.integers(n_elite, size=2)]
            child = dad.copy()
            if rng.random() < crossover_rate:
                p = rng.integers(1, d)
                child[p:] = mom[p:]
            mask = rng.random(d) < mutation_rate
            child[mask] = rng.random(mask.sum())
            children.append(child)
        X = np.vstack([elites, np.array(children)])
    return rec.result(fitness_fn.num_accels)


def differential_evolution(fitness_fn: FitnessFn, budget: int = 10_000,
                           seed: int = 0, population: int = 100,
                           f_weight: float = 0.8, cr: float = 0.8) -> SearchResult:
    """DE/rand/1/bin with F = CR = 0.8 (Table IV's 'weighting ... 0.8')."""
    rng = np.random.default_rng(seed)
    d = 2 * fitness_fn.group_size
    X = rng.random((population, d))
    fits = eval_x(fitness_fn, X)
    rec = Recorder()
    rec.record(X, fits)
    while rec.samples < budget:
        idx = np.array([rng.choice(population, 3, replace=False)
                        for _ in range(population)])
        a, b, c = X[idx[:, 0]], X[idx[:, 1]], X[idx[:, 2]]
        mutant = np.clip(a + f_weight * (b - c), 0, 1)
        cross = rng.random((population, d)) < cr
        cross[np.arange(population), rng.integers(d, size=population)] = True
        trial = np.where(cross, mutant, X)
        tfits = eval_x(fitness_fn, trial)
        rec.record(trial, tfits)
        better = tfits > fits
        X[better] = trial[better]
        fits[better] = tfits[better]
    return rec.result(fitness_fn.num_accels)


def pso(fitness_fn: FitnessFn, budget: int = 10_000, seed: int = 0,
        population: int = 100, w_global: float = 0.8, w_parent: float = 0.8,
        momentum: float = 1.6) -> SearchResult:
    rng = np.random.default_rng(seed)
    d = 2 * fitness_fn.group_size
    X = rng.random((population, d))
    V = (rng.random((population, d)) - 0.5) * 0.1
    pbest, pbest_f = X.copy(), np.full(population, -np.inf)
    gbest, gbest_f = X[0].copy(), -np.inf
    rec = Recorder()
    while rec.samples < budget:
        fits = eval_x(fitness_fn, X)
        rec.record(X, fits)
        imp = fits > pbest_f
        pbest[imp], pbest_f[imp] = X[imp], fits[imp]
        if fits.max() > gbest_f:
            gbest_f = float(fits.max())
            gbest = X[np.argmax(fits)].copy()
        r1, r2 = rng.random((2, population, d))
        V = (momentum * V + w_parent * r1 * (pbest - X)
             + w_global * r2 * (gbest - X))
        V = np.clip(V, -0.5, 0.5)
        X = np.clip(X + V, 0, 1)
    return rec.result(fitness_fn.num_accels)


def cma_es(fitness_fn: FitnessFn, budget: int = 10_000, seed: int = 0,
           population: int = 50, sigma0: float = 0.3) -> SearchResult:
    """Full-covariance CMA-ES; elite group = best half (Table IV)."""
    rng = np.random.default_rng(seed)
    d = 2 * fitness_fn.group_size
    lam = population
    mu = lam // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w /= w.sum()
    mu_eff = 1.0 / np.sum(w ** 2)

    cc = (4 + mu_eff / d) / (d + 4 + 2 * mu_eff / d)
    cs = (mu_eff + 2) / (d + mu_eff + 5)
    c1 = 2 / ((d + 1.3) ** 2 + mu_eff)
    cmu = min(1 - c1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((d + 2) ** 2 + mu_eff))
    damps = 1 + 2 * max(0.0, np.sqrt((mu_eff - 1) / (d + 1)) - 1) + cs
    chi_n = np.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d ** 2))

    mean = rng.random(d)
    sigma = sigma0
    C = np.eye(d)
    pc = np.zeros(d)
    ps = np.zeros(d)
    rec = Recorder()
    while rec.samples < budget:
        # eigendecomposition (d=200: ~ms)
        Dvals, B = np.linalg.eigh(C)
        Dvals = np.sqrt(np.maximum(Dvals, 1e-20))
        Z = rng.standard_normal((lam, d))
        Y = Z @ np.diag(Dvals) @ B.T
        X = np.clip(mean + sigma * Y, 0, 1)
        fits = eval_x(fitness_fn, X)
        rec.record(X, fits)
        order = np.argsort(-fits)[:mu]
        y_w = (w[:, None] * Y[order]).sum(axis=0)
        mean = np.clip(mean + sigma * y_w, 0, 1)
        # step-size path
        C_inv_sqrt = B @ np.diag(1 / Dvals) @ B.T
        ps = (1 - cs) * ps + np.sqrt(cs * (2 - cs) * mu_eff) * (C_inv_sqrt @ y_w)
        sigma *= np.exp((cs / damps) * (np.linalg.norm(ps) / chi_n - 1))
        sigma = float(np.clip(sigma, 1e-8, 1.0))
        # covariance path
        hsig = (np.linalg.norm(ps) / np.sqrt(1 - (1 - cs) ** (2 * rec.samples / lam))
                < (1.4 + 2 / (d + 1)) * chi_n)
        pc = (1 - cc) * pc + hsig * np.sqrt(cc * (2 - cc) * mu_eff) * y_w
        rank1 = np.outer(pc, pc)
        rank_mu = sum(wi * np.outer(y, y) for wi, y in zip(w, Y[order]))
        C = (1 - c1 - cmu) * C + c1 * rank1 + cmu * rank_mu
        C = (C + C.T) / 2
    return rec.result(fitness_fn.num_accels)


def tbpsa(fitness_fn: FitnessFn, budget: int = 10_000, seed: int = 0,
          init_population: int = 50) -> SearchResult:
    """Test-based population-size adaptation ES (nevergrad-style, simplified).

    (mu/lam) ES with per-coordinate sigma; the population grows when the
    Wilcoxon-like progress test fails (noisy/stalled) and shrinks when
    progress is clear.
    """
    rng = np.random.default_rng(seed)
    d = 2 * fitness_fn.group_size
    lam = init_population
    mean = rng.random(d)
    sigma = np.full(d, 0.3)
    prev_best = -np.inf
    rec = Recorder()
    while rec.samples < budget:
        lam_now = int(min(lam, max(budget - rec.samples, 4)))
        X = np.clip(mean + sigma * rng.standard_normal((lam_now, d)), 0, 1)
        fits = eval_x(fitness_fn, X)
        rec.record(X, fits)
        mu = max(1, lam_now // 4)
        order = np.argsort(-fits)[:mu]
        new_mean = X[order].mean(axis=0)
        spread = X[order].std(axis=0)
        sigma = 0.9 * sigma + 0.1 * np.maximum(spread, 1e-3)
        mean = new_mean
        # population-size test: stalled -> grow, improving -> shrink
        if fits.max() <= prev_best * (1 + 1e-6):
            lam = min(lam * 2, 400)
        else:
            lam = max(init_population, int(lam * 0.84))
        prev_best = max(prev_best, float(fits.max()))
    return rec.result(fitness_fn.num_accels)
