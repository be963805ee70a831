"""Multi-tenant serving launcher, ported from ``repro.launch.serve``:
MAGMA as the production scheduler.

    python -m repro_torch.launch.serve --tenants granite-3-2b,qwen2-moe-a2.7b \
        --requests 24 [--method magma] [--execute] [--full] \
        [--device cuda|cpu]

Builds the tenants, synthesizes a batched request mix, schedules the job
group with the chosen mapper (MAGMA by default; any Table IV method via
--method), prints the makespan and throughput against the Herald-like
and AI-MT-like baselines, and with --execute runs the schedule for real.
The request mix and the prompts are drawn from one
``np.random.default_rng(seed)`` in the reference's order (requests, then
prompts), so they equal the reference launcher's.

Without --full the tenants are the smoke configs in float32, as in the
reference, which has only that mode.  --full takes each tenant's
published config in bf16 with ``use_flash=True`` (the SSM prefill's
selective-scan kernel), weights drawn on the device from a
``torch.Generator`` seeded with ``seed + i`` for the i-th tenant: the
same code path then serves full-width models on the card, where the
reference notes that its identical path drives real TPU submeshes.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import (MultiTenantEngine, Tenant,
                                      default_submeshes)

BASELINES = ("herald_like", "ai_mt_like")


def build_tenants(arch_ids: Sequence[str], seed: int = 0, *,
                  device="cuda", full: bool = False) -> List[Tenant]:
    """One tenant per arch: the smoke config in float32, or with ``full``
    the published config in bf16 through the kernels; tenant i's weights
    come from a generator on ``device`` seeded with ``seed + i``."""
    tenants = []
    for i, arch in enumerate(arch_ids):
        cfg = (get_config(arch).replace(use_flash=True) if full
               else get_smoke_config(arch).replace(dtype="float32"))
        gen = torch.Generator(device=device).manual_seed(seed + i)
        with torch.no_grad():
            model = get_model(cfg, device=device, generator=gen)
        tenants.append(Tenant(arch, cfg, model))
    return tenants


def run(tenants: Sequence[Tenant], *, requests: int = 24,
        method: str = "magma", budget: int = 2000, execute: bool = False,
        seed: int = 0, device="cuda", log_fn=print) -> Dict:
    """The launcher's flow on built tenants.  Returns the engine, the
    requests (tenant, prompt, generated tokens), the jobs, the schedules
    as (method, ``schedule`` output) pairs (``method``, then the two
    baselines), and with ``execute`` the executed schedule, the prompts
    and the generated tokens (decode-job uid -> (1, window) int32)."""
    engine = MultiTenantEngine(tenants, default_submeshes(), budget=budget,
                               seed=seed, device=device)
    names = [t.name for t in tenants]
    rng = np.random.default_rng(seed)
    reqs = [(names[i % len(names)],
             int(rng.integers(64, 512)), int(rng.integers(16, 64)))
            for i in range(requests)]
    jobs = engine.jobs_for_requests(reqs)
    log_fn(f"[serve] {len(reqs)} requests -> {len(jobs)} jobs on "
           f"{len(engine.submeshes)} submeshes")
    schedules = []
    for m in (method,) + BASELINES:
        out = engine.schedule(jobs, method=m)
        schedules.append((m, out))
        log_fn(f"[serve] {m:12s} makespan={out['makespan_s'] * 1e3:8.2f} ms"
               f"  throughput={out['throughput_flops'] / 1e12:8.2f} TFLOP/s")
    result = {"engine": engine, "requests": reqs, "jobs": jobs,
              "schedules": schedules}
    if execute:
        out = engine.schedule(jobs, method=method)
        vocab = min(t.cfg.vocab for t in tenants)
        prompts = {j.uid: rng.integers(0, vocab, (1, j.seq))
                   for j in jobs if j.phase == "prefill"}
        gen = engine.execute(jobs, out["queues"], prompts)
        log_fn(f"[serve] executed {len(gen)} decode jobs; "
               f"sample tokens: {list(gen.values())[0][:, :8]}")
        result.update(executed=out, prompts=prompts, outputs=gen)
    return result


def main(argv: Optional[List[str]] = None, log_fn=print) -> Dict:
    """Parse ``argv``, build the tenants on ``--device`` and ``run``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--tenants", default="granite-3-2b,qwen2-moe-a2.7b,"
                                         "falcon-mamba-7b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--method", default="magma")
    ap.add_argument("--budget", type=int, default=2000)
    ap.add_argument("--execute", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="published configs in bf16 through the kernels "
                         "(a card's worth of weights) instead of the smoke "
                         "configs in float32")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    arch_ids = [a for a in args.tenants.split(",") if a in ARCH_IDS]
    tenants = build_tenants(arch_ids, args.seed, device=args.device,
                            full=args.full)
    return run(tenants, requests=args.requests, method=args.method,
               budget=args.budget, execute=args.execute, seed=args.seed,
               device=args.device, log_fn=log_fn)


if __name__ == "__main__":
    main()
