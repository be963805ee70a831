"""Multi-tenant serving engine whose job->submesh scheduler is MAGMA.

Ported from ``repro.serve.engine``.  The paper's technique as a framework
feature, with the JAX package's hardware adaptation (its DESIGN.md §3):

  sub-accelerator  ->  submesh (tp x dp slice of a TPU pod)
  job              ->  (tenant, phase) unit: a prefill of a request batch,
                       or a decode window of T tokens
  system BW        ->  shared host->pod ingress that all submeshes contend
                       for
  job analysis     ->  TPU roofline cost model (``costmodel.tpu``, copied
                       unchanged): no-stall latency = max(compute, HBM)
                       term; required BW = host-visible bytes / latency

The cost model stays the TPU one so that the tables, and with them the
schedules, are the JAX engine's bit for bit.  The engine batches requests
into job groups, profiles them against every submesh, runs MAGMA (the
port's ``run_strategy``, on ``device``) or any other registered method
(the host heuristics and RL included) and returns the mapping and its
BW-allocator makespan; ``schedule_front`` co-searches several objectives
and returns the frontier of complete schedules.  ``schedule(...,
execute=True)`` also runs the jobs: each tenant's model (dense, MoE, SSM
or hybrid) serves its prefills and decode windows on the tenant's device,
the SSM prefills through the CUDA selective-scan kernel on the card.

As in the JAX engine, the engine is a *client* of the stream service
(``repro_torch.stream``): every device-resident method is scheduled via
``StreamingScheduler.schedule_prepared`` (the engine's tables enter the
admission queue as a prepared scenario and run through the sweep's row
function on the engine's device), which is bitwise a direct
``run_strategy`` with the same seed and budget; ``out["stream"]`` is the
routed ``StreamResult``.  Host-only methods (heuristics, RL) keep
``run_strategy``'s host loop and return ``"stream": None``.  Only
strategies in the port's registry are accepted.  With ``fleet=`` (a
``repro_torch.fleet.Fleet``) the device-resident methods are served by
the fleet's workers instead of the in-process stream: the prepared
tables cross to a worker bit exactly and the schedule is bitwise the
in-process one, ``out["stream"]`` then being the ``FleetResult``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.bw_allocator import simulate_numpy
from repro_torch.core.encoding import decode_to_lists
from repro_torch.core.fitness import FitnessFn
from repro_torch.core.job_analyzer import table_from_arrays
from repro_torch.costmodel.tpu import TPUSubmesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import count_active_params
from repro_torch.stream import (PRIORITY_CLASSES, StreamConfig,
                                StreamingScheduler)


@dataclasses.dataclass
class Submesh:
    """One schedulable slice of the pod."""
    name: str
    tp: int
    dp: int = 1

    @property
    def cost(self) -> TPUSubmesh:
        return TPUSubmesh(self.name, tp=self.tp, dp=self.dp)


def default_submeshes() -> List[Submesh]:
    """A heterogeneous carving of one 256-chip pod: big TP slices for
    latency-critical prefill, small slices for decode — the TPU analogue of
    the paper's HB/LB heterogeneous cores."""
    return [Submesh("tp16_a", 16), Submesh("tp16_b", 16),
            Submesh("tp8_a", 8), Submesh("tp8_b", 8),
            Submesh("tp4_a", 4), Submesh("tp4_b", 4),
            Submesh("tp4_c", 4), Submesh("tp4_d", 4)]


@dataclasses.dataclass(frozen=True)
class TenantSLO:
    """Per-tenant service-level objective: ``priority`` is one of
    ``PRIORITY_CLASSES`` and ``deadline_s`` the scheduling-latency budget.
    A job group spanning several tenants is scheduled at the STRICTEST
    member SLO (``MultiTenantEngine.slo_for``)."""
    priority: str = "normal"
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(f"unknown priority {self.priority!r}; "
                             f"expected one of {PRIORITY_CLASSES}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0 or None, got "
                             f"{self.deadline_s}")


@dataclasses.dataclass
class Tenant:
    """A served model: ``model`` (``TransformerLM`` for the dense and MoE
    families, ``MambaLM`` / ``HybridLM`` for SSM and hybrid) holds its
    weights on its device."""
    name: str
    cfg: ModelConfig
    model: torch.nn.Module
    slo: Optional[TenantSLO] = None  # None: normal priority, no deadline


@dataclasses.dataclass
class ServeJob:
    uid: int
    tenant: str
    phase: str                      # 'prefill' | 'decode'
    batch: int                      # requests in the job
    seq: int                        # prompt len (prefill) / ctx len (decode)
    tokens: int                     # tokens produced/processed
    flops: float = 0.0
    hbm_bytes: float = 0.0
    host_bytes: float = 0.0


def job_costs(cfg: ModelConfig, phase: str, batch: int, seq: int,
              tokens: int) -> Tuple[float, float, float]:
    """(flops, hbm_bytes, host_bytes) for one job, from the model config."""
    n_active = count_active_params(cfg)
    bpe = 2  # bf16
    if phase == "prefill":
        flops = 2.0 * n_active * batch * seq
        hbm = n_active * bpe + batch * seq * cfg.d_model * bpe
        host = batch * seq * 4 + batch * seq * cfg.d_model * bpe * 0.0 \
            + batch * 4  # token ids in, last-logit ids out
        if cfg.family in ("vlm", "encdec"):
            host += batch * seq * cfg.d_model * bpe  # embeddings cross PCIe
    else:
        flops = 2.0 * n_active * batch * tokens
        kv_heads = max(cfg.n_kv_heads, 1)
        kv = (2 * cfg.num_layers * batch * seq * kv_heads * cfg.hd * bpe
              if cfg.n_heads else
              cfg.num_layers * batch * cfg.inner * cfg.ssm_state * 4)
        hbm = tokens * (n_active * bpe + kv)
        host = batch * tokens * 2 * 4
    return float(flops), float(hbm), float(host)


class MultiTenantEngine:
    def __init__(self, tenants: Sequence[Tenant],
                 submeshes: Optional[Sequence[Submesh]] = None,
                 system_bw: float = 64e9, group_size: int = 64,
                 decode_window: int = 32, budget: int = 2_000,
                 method: str = "magma", seed: int = 0,
                 stream=None, memo=None, fleet=None,
                 device: Union[str, torch.device] = "cuda"):
        self.tenants = {t.name: t for t in tenants}
        self.submeshes = list(submeshes or default_submeshes())
        self.system_bw = float(system_bw)
        self.group_size = group_size
        self.decode_window = decode_window
        self.budget = budget
        self.method = method
        self.seed = seed
        self.device = torch.device(device)   # where the search runs
        self._uid = 0
        # the stream service this engine schedules through (shared so many
        # engines can feed one admission queue); lazily built, on the
        # engine's device, when the first device-resident method is
        # scheduled
        self._stream = stream
        self._owns_stream = False
        # schedule memo (repro_torch.memo.ScheduleMemo) consulted by the
        # stream at admission: a re-seen job group replays its stored
        # mapping bitwise with no search; near-same groups warm-start.
        # Only applies to the service this engine creates — an injected
        # ``stream`` keeps whatever memo it was built with.
        self.memo = memo
        # fleet-backed option: an injected ``repro_torch.fleet.Fleet``
        # serves device-resident methods instead of an in-process stream
        # (its workers' device, not the engine's, runs the search).  The
        # fleet is the injector's to launch and close.
        self.fleet = fleet

    def stream_service(self):
        """The ``repro_torch.stream.StreamingScheduler`` this engine is a
        client of (created on first use, on the engine's device, unless
        one was injected)."""
        if self._stream is None:
            # no trace analysis happens on this path (scenarios arrive
            # prepared), so a minimal analysis pool suffices
            self._stream = StreamingScheduler(
                budget=self.budget,
                stream=StreamConfig(analysis_workers=1),
                memo=self.memo, device=self.device)
            self._owns_stream = True
        return self._stream

    def close(self) -> None:
        """Shut down the stream service this engine created (an injected,
        shared service is the injector's to close)."""
        if self._owns_stream and self._stream is not None:
            self._stream.close()
            self._stream = None
            self._owns_stream = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- job construction -----------------------------------------------------
    def jobs_for_requests(self, requests: Sequence[Tuple[str, int, int]]
                          ) -> List[ServeJob]:
        """requests: (tenant, prompt_len, gen_len) -> prefill + decode jobs."""
        jobs: List[ServeJob] = []
        for tenant, prompt, gen in requests:
            cfg = self.tenants[tenant].cfg
            f, h, p = job_costs(cfg, "prefill", 1, prompt, prompt)
            jobs.append(ServeJob(self._uid, tenant, "prefill", 1, prompt,
                                 prompt, f, h, p))
            self._uid += 1
            done = 0
            while done < gen:
                w = min(self.decode_window, gen - done)
                ctx = prompt + done + w
                f, h, p = job_costs(cfg, "decode", 1, ctx, w)
                jobs.append(ServeJob(self._uid, tenant, "decode", 1, ctx, w,
                                     f, h, p))
                self._uid += 1
                done += w
        return jobs

    def slo_for(self, jobs: Sequence[ServeJob]) -> TenantSLO:
        """The strictest SLO across the tenants appearing in ``jobs``:
        highest priority class, smallest deadline.  Tenants without an
        SLO contribute the (normal, no-deadline) default."""
        slos = [self.tenants[j.tenant].slo or TenantSLO()
                for j in jobs] or [TenantSLO()]
        priority = min((s.priority for s in slos),
                       key=PRIORITY_CLASSES.index)
        deadlines = [s.deadline_s for s in slos if s.deadline_s is not None]
        return TenantSLO(priority=priority,
                         deadline_s=min(deadlines) if deadlines else None)

    # -- analysis + scheduling --------------------------------------------------
    def analyze(self, jobs: Sequence[ServeJob]):
        """Job-analysis table over (job x submesh) from the TPU cost model,
        with an energy column (``TPUSubmesh.energy_j``: whole-slice board
        power x duration)."""
        G, A = len(jobs), len(self.submeshes)
        lat = np.zeros((G, A))
        bw = np.zeros((G, A))
        en = np.zeros((G, A))
        for g, job in enumerate(jobs):
            for a, sm in enumerate(self.submeshes):
                l, b = sm.cost.profile(job.flops, job.hbm_bytes,
                                       job.host_bytes)
                lat[g, a] = l
                bw[g, a] = b
                en[g, a] = sm.cost.energy_j(l)
        flops = np.array([j.flops for j in jobs])
        return table_from_arrays(lat, bw, flops, energy=en)

    def schedule(self, jobs: Sequence[ServeJob],
                 method: Optional[str] = None,
                 execute: bool = False,
                 prompts: Optional[Dict[int, np.ndarray]] = None) -> Dict:
        """Profile, search, and map ``jobs`` onto the submeshes.

        Device-resident methods go through the stream service (prepared
        scenario -> admission queue -> the sweep's row function on the
        engine's device), under the job group's strictest tenant SLO;
        that is bitwise a direct ``run_strategy`` with the same seed and
        budget, and ``"stream"`` holds the routed ``StreamResult``.
        Host-only methods run their own loops (``"stream": None``).  With
        ``execute=True`` the scheduled jobs also run for real
        (``prompts`` maps prefill-job uid -> token array) and the
        generated tokens come back under ``"outputs"``."""
        from repro_torch.core.strategies import get_strategy, run_strategy
        if execute and prompts is None:
            raise ValueError("execute=True needs prompts "
                             "(prefill-job uid -> token array)")
        table = self.analyze(jobs)
        fit = FitnessFn(table, bw_sys=self.system_bw, device=self.device)
        strategy = get_strategy(method or self.method)
        stream_res = None
        if strategy.device_resident:
            slo = self.slo_for(jobs)
            if self.fleet is not None:
                stream_res = self.fleet.run(prepared=[
                    self._prepared(jobs, fit, strategy)])[0]
            else:
                stream_res = self.stream_service().schedule_prepared(
                    fit, seed=self.seed, budget=self.budget,
                    strategy=strategy, priority=slo.priority,
                    deadline_s=slo.deadline_s)
            res = stream_res.to_search_result()
        else:
            res = run_strategy(strategy, fit, budget=self.budget,
                               seed=self.seed, device=self.device)
        local = decode_to_lists(res.best_accel, res.best_prio,
                                len(self.submeshes))
        makespan = simulate_numpy(local, table.lat, table.bw, self.system_bw)
        # map group-local job indices back to engine-global job uids
        queues = [[int(jobs[i].uid) for i in q] for q in local]
        out = {
            "result": res,
            "queues": queues,
            "local_queues": local,
            "makespan_s": float(makespan),
            "throughput_flops": table.total_flops / max(makespan, 1e-30),
            "table": table,
            "stream": stream_res,
        }
        if execute:
            out["outputs"] = self.execute(jobs, queues, prompts)
        return out

    def _prepared(self, jobs: Sequence[ServeJob], fit: FitnessFn,
                  strategy):
        """The prepared scenario :meth:`schedule` sends a fleet."""
        from repro_torch.stream import PreparedScenario
        slo = self.slo_for(jobs)
        return PreparedScenario(fit=fit, seed=self.seed, budget=self.budget,
                                strategy=strategy, priority=slo.priority,
                                deadline_s=slo.deadline_s)

    def warmup(self, jobs: Sequence[ServeJob],
               method: Optional[str] = None) -> None:
        """Warm the search path for job groups of ``jobs``' shape: the
        stream service's ``warmup`` (with ``fleet=``, every worker's)
        runs each batch shape such a group can hit once, so a later
        :meth:`schedule` of that shape builds and captures nothing (on a
        card a shape's first batch captures its generation loop as a
        CUDA graph).  Host-only methods have nothing to warm."""
        from repro_torch.core.strategies import get_strategy
        strategy = get_strategy(method or self.method)
        if not strategy.device_resident:
            return
        fit = FitnessFn(self.analyze(jobs), bw_sys=self.system_bw,
                        device=self.device)
        prepared = [self._prepared(jobs, fit, strategy)]
        if self.fleet is not None:
            self.fleet.warmup((), prepared=prepared)
        else:
            self.stream_service().warmup(prepared=prepared)

    def schedule_front(self, jobs: Sequence[ServeJob],
                       objectives: Sequence[str] = ("latency", "energy",
                                                    "edp"),
                       method: str = "nsga2") -> Dict:
        """Co-search several serving objectives at once -> the frontier.

        Same profile tables as :meth:`schedule` (the energy column comes
        from whole-slice board power), a vector objective, routed through
        ``stream_service().schedule_front`` under the job group's
        strictest tenant SLO: the row keeps its converged population and
        ``pareto_front`` extracts the front from it, as
        ``M3E.search_front`` does.  Returns the ``ParetoFront`` plus, for
        each front point, the decoded queues and simulated makespan:
        every candidate is a complete schedule."""
        table = self.analyze(jobs)
        fit = FitnessFn(table, bw_sys=self.system_bw,
                        objective=tuple(objectives), device=self.device)
        slo = self.slo_for(jobs)
        front = self.stream_service().schedule_front(
            fit, seed=self.seed, budget=self.budget, strategy=method,
            priority=slo.priority, deadline_s=slo.deadline_s)
        points = []
        for k in range(len(front)):
            pt = front.point(k)
            local = decode_to_lists(pt["accel"], pt["prio"],
                                    len(self.submeshes))
            makespan = simulate_numpy(local, table.lat, table.bw,
                                      self.system_bw)
            points.append({
                "objectives": {n: pt[n] for n in front.names},
                "queues": [[int(jobs[i].uid) for i in q] for q in local],
                "makespan_s": float(makespan),
            })
        return {"front": front, "points": points, "table": table}

    # -- execution (functional correctness on the scheduled order) -------------
    def execute(self, jobs: Sequence[ServeJob], queues: List[List[int]],
                prompts: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        """Run the scheduled jobs for real, in per-chain phase order.

        ``prompts``: prefill-job uid -> (1, prompt_len) token array.
        Returns uid -> generated token ids (greedy, int32) for decode jobs.
        State (cache) is keyed per tenant-request chain.  A decode window's
        tokens stay on the card until the window ends."""
        outputs: Dict[int, np.ndarray] = {}
        chains: Dict[str, Dict] = {}
        by_uid = {j.uid: j for j in jobs}
        order = [uid for q in queues for uid in q]
        # execution must respect per-chain phase order; queue order decides
        # inter-chain interleaving (the scheduler's freedom)
        for uid in sorted(order):
            job = by_uid[uid]
            model = self.tenants[job.tenant].model
            chain = chains.setdefault(job.tenant, {})
            if job.phase == "prefill":
                toks = torch.as_tensor(np.asarray(prompts[uid]),
                                       dtype=torch.long, device=model.device)
                total = job.seq + sum(
                    j.tokens for j in jobs
                    if j.tenant == job.tenant and j.phase == "decode")
                logits, cache = model.prefill({"tokens": toks}, total)
                chain["cache"] = cache
                chain["pos"] = job.seq
                chain["last"] = torch.argmax(logits[:, -1], dim=-1)
            else:
                cache, pos = chain["cache"], chain["pos"]
                cur = chain["last"][:, None]
                outs = []
                for _ in range(job.tokens):
                    logits, cache = model.decode_step(cache, cur, pos)
                    cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
                    outs.append(cur)
                    pos += 1
                chain.update(cache=cache, pos=pos, last=cur[:, 0])
                outputs[uid] = torch.cat(outs, dim=1).to(
                    torch.int32).cpu().numpy()
        return outputs
