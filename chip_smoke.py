#!/usr/bin/env python3
"""Build and drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure raises and exits non-zero:

  1. device   the torch version, the card, and its name and power limit as
              nvidia-smi reports them; fails without a CUDA device
  2. build    nvcc builds every kernel from csrc/, one nvcc per source, all
              started together (the seconds and the -Xptxas -v reports
              are printed, and each kernel instantiation's registers and
              spill bytes)
  3. check    every kernel against its plain PyTorch version on the card:
              the makespan kernel at the main path's shapes and at edge
              cases, plus the float64 oracle, bitwise population-size
              invariance and a per-row bw_sys launch (4 rows of 100, four
              bandwidths) bitwise equal to four one-row launches; the selective-scan kernel at the reference
              tests' shapes (float32 and bf16 inputs), at the two
              serving shapes, at falcon-mamba's width with phase 14's
              prompt lengths and at phase 15's two evaluation shapes
              ((1, 2048, 8192, 16) and (4, 2048, 4096, 64), float32 and
              bf16), plus bitwise batch-row independence (Bt=2, and the
              Bt=4 evaluation shape); the flash kernel at the reference
              tests' shapes, ragged S, the three evaluation shapes
              (granite, danube, and zamba2's shared block at (4, 2048,
              32/32 heads, 64)) and the bf16 kernel's edges
              (FLASH_EDGES), plus bitwise batch-row independence
  4. main     the M3E mapper end to end: S4 with a Mix group of 100 jobs,
              bw_sys = 256 GB/s, MAGMA with the paper's 10K-sample budget
              (P=100, 100 generations), four seeds; each search must
              launch the makespan kernel once per generation, and its best
              individual, re-evaluated by the plain version on the CPU,
              must reproduce its best fitness
  5. timing   the makespan kernel's device time (a CUDA graph of its
              launches replayed) and its time issued from the host
              (CUDA events around Python launches), its plain version's,
              beside the least time the card could take for the same
              work, and one more search under torch.profiler: the
              device's busy share of the search and the kernel's part;
              the per-row bw_sys launch's device time at N = 4 x 100 and
              3 x 100 (a sweep chunk) beside its bound
  6. serve    the serving engine end to end: falcon-mamba-7b and
              zamba2-1.2b at full published width and depth, bf16, random
              weights from a seeded generator, use_flash=True;
              MultiTenantEngine(...).schedule(jobs, method="magma",
              execute=True) for two requests per tenant (512-token
              prompts, 32 generated tokens, decode windows of 8); every job
              scheduled once, every decode window answered, the scan kernel
              launched once per SSM layer of every prefill and the makespan
              kernel once per MAGMA generation; walls of the scheduling, of
              each prefill and per decoded token
  7. model    kernel path against plain path (use_flash=False, the same
              weights): falcon-mamba-7b at full width, 4 layers, float32,
              must give prefill logits within MODEL_F32_ATOL and the same
              greedy tokens over the whole decode; at full depth in bf16
              the difference and the token agreement are reported
  8. timing   the scan kernel's device and host-issued times (as in
              phase 5) and its plain version's at both serving shapes
              beside their bounds, and one served
              request under torch.profiler: the device's busy share and
              the scan kernel's part of it
  9. train    the serving models freed, repro_torch.launch.train for
              granite-3-2b at full published width and depth, bf16, random
              weights from a seeded generator, --steps 4 --batch 4 --seq
              2048 with the launcher's own TrainConfig: per step the loss,
              grad norm, ms, tokens/s, peak device memory and the model
              FLOPs' share of the card's bf16 dense peak (mfu); losses and
              grad norms finite, grad norms non-zero, parameters changed,
              no flash launch (training runs the plain attention, as in
              the reference); then, at full width with 4 layers, 4 steps
              straight must equal bitwise 2 steps, checkpoint, restore, 2
              more (in a temporary directory under build/, deleted after)
 10. eval     the trained granite with use_flash=True: model.loss under
              torch.no_grad() on stream.batch_at(10_000), 40 flash
              launches; h2o-danube-3-4b at full width and depth, bf16,
              B=1, S=8192 (window 4096), 24 launches; at full width with 4
              layers in float32 each model's flash and plain routes give
              losses within EVAL_F32_ATOL; at full depth in bf16 their
              difference is reported
 11. timing   CUDA-event times of the flash kernel, its plain version and
              torch's scaled_dot_product_attention at both evaluation
              shapes beside their bounds and the kernel's useful TFLOP/s
              (4 D per unmasked pair over its time), and one granite
              training step
              under torch.profiler: the device's busy share and the top
              device ops
 12. compare  the paper's Fig. 9 protocol at full width (G=100, 10K
              samples): S2 at 16 GB/s and S4 at 256 GB/s, each with the
              Vision and Mix groups, and all eleven Table IV methods.
              magma, stdga, de, pso and random run one run_sweep per
              setting (2 tasks x 2 seeds = 4 rows, chunks of 3) that
              must launch the makespan kernel once per generation and
              chunk and whose every row must equal bitwise the same
              search run alone by run_strategy; cmaes, tbpsa, a2c, ppo2,
              herald_like and ai_mt_like run through M3E.search (one
              seed: HOST_SEEDS); every best individual is re-evaluated
              by the plain version on the CPU (rtol 1e-4).  Prints the
              Fig. 9 table normalized to MAGMA, the geomean MAGMA
              advantage per method and their order (reported, not
              asserted), each method's wall, each sweep's wall beside
              its rows run one by one, one MAGMA sweep under
              torch.profiler (the device's busy share, device ops per
              generation and chunk), and the phase's wall

 13. memo     the schedule memo and the Section V-C warm start through
              M3E(memo=ScheduleMemo(MemoStore(<fresh dir under build/>)))
              and M3E(warm_start=WarmStartEngine()) at full width: S4 at
              256 GB/s, a Mix group of 100, 10K samples; the first
              memoized solve must equal M3E.search bitwise, the second
              (and one from a reopened store) must replay it bitwise with
              wall_time_s 0 and no makespan launch (the lookup's wall is
              printed beside the search's); run_sweep(memo=) over phase
              12's S4 setting must record its 4 rows, each replay equal
              bitwise to its sweep row and its standalone search, at one
              launch per generation and chunk; a 1K-sample row solved
              on the CPU must not hit on the card; Mix group 0's record
              is offered to 4 sibling groups (donor distance, the guard's
              outcome and the warm/cold ratio at 1K samples printed; a
              refused donor must give the cold search bitwise, a seeded
              search must be deterministic and equal its loop engine);
              Table V (benchmarks/tableV_warmstart.py:35-80) on S4 at
              1 GB/s, Mix G=100, P=100, epochs (0, 1, 30, 100),
              instances 1-4 must meet gain0 > 1.1 and full_frac > 0.75
 14. launch   the serving launcher (repro_torch.launch.serve, the
              reference's src/repro/launch/serve.py) at full published
              width in bf16 through the kernels: build_tenants(...,
              full=True) for granite-3-2b (dense), qwen2-moe-a2.7b (MoE,
              2,433,373,388 active of 14,835,091,456 params) and
              falcon-mamba-7b, then its flow for --requests 6 --execute
              --seed 0: MAGMA, herald_like and ai_mt_like schedules and
              the MAGMA schedule executed; every schedule places every
              job once, with one makespan launch per MAGMA generation and
              one per heuristic, the scan launched once per falcon
              prefill layer, no flash launch, every decode window
              answered inside its tenant's vocabulary; the makespan
              kernel against its plain version on one population of the
              engine's own tables (G=15, A=8, P=100); each tenant's
              prefill walls and ms per decoded token beside its HBM
              bound, the MoE prefills' dropped share; the reference's
              decode criterion (decode == teacher-forced forward to
              relative 5e-3, MoE at a drop-free capacity) held at 4
              layers in float32 for granite and qwen2-moe and reported
              at full depth in bf16, with the routed experts that differ
              between decode and forward counted.  It runs right after
              phase 3, before the process's first torch.profiler session:
              one session leaves later host-bound decode steps slower.
              After phase 13 granite and qwen2-moe are rebuilt, the same
              fixed decode probe is read again (after phases 5, 8, 11 and
              12's profiler sessions) and one qwen2-moe decoded token is
              profiled
 15. families the SSM, hybrid and encoder-decoder families, right after
              phase 14 (also before the first profiler session): trained
              in bf16 with use_flash=False -- zamba2-1.2b (--steps 2
              --batch 1 --seq 512) and seamless-m4t-medium (--steps 4
              --batch 2 --seq 1024) at full width and depth through
              repro_torch.launch.train, falcon-mamba-7b at full width
              with 4 layers through train.loop.train (full depth with
              AdamW state does not fit one card) -- with per-step loss,
              grad norm, ms, tokens/s and peak memory, finite losses,
              non-zero grad norms, every weight matrix changed and no
              kernel launched; evaluated with use_flash=True under
              torch.no_grad() on batch_at(10_000): falcon-mamba-7b at
              full depth B=1 S=2048 (64 scan launches), the trained
              zamba2 B=4 S=2048 (38 scan and 7 flash launches), the
              trained seamless B=2 S=1024 (none); the kernel route
              against the plain route at full width in float32
              (falcon-mamba 4 layers, zamba2 7 layers: within
              EVAL_F32_ATOL) and at full depth in bf16 at S=512
              (reported); the scan kernel's device and host-issued times
              at both evaluation shapes and the flash kernel's and SDPA's
              at zamba2's, beside their bounds.  After phase 14's profiled
              token one zamba2 training step and the zamba2 and
              falcon-mamba evaluations are profiled: the device's busy
              share, its ops, the host's wall per op and the kernels' part
 16. stream   the streaming scheduling service (repro_torch.stream) right
              after phase 15 (also before the first profiler session): a
              32-scenario Poisson trace at G=100 and 10K samples (S2 and
              S4, three mixes, 1-64 GB/s, batch scales 1-8) through a
              warmed-up StreamingScheduler three ways (run_serial with a
              fresh analyzer per scenario, with the shared cache, and the
              pipelined run): scenarios/s, device idle share, latency
              p50 / p99, batches and fill, each batch's host issue time
              beside its dispatch-to-done window; every pipelined row
              bitwise its serial twins and a standalone run_strategy;
              then SLO admission (a bursty S2 trace, deadlines from a
              blind probe's p50) blind and SLO-aware with anytime rows at
              2,500 samples: urgent p99 and attainment, every aware row
              bitwise a standalone search at its budget, every
              refinement in the memo one at 10K, admission counters
              balanced; every warmup and run at one makespan launch per
              generation and batch.  Phase 14's launcher now schedules
              MAGMA through the engine's stream service: each MAGMA
              schedule carries its StreamResult and equals a direct
              run_strategy.  At the script's end (after every other
              profiler session) one more pipelined run of the trace is
              profiled: the card's own busy share (the union of its CUDA
              kernel intervals over the run's wall) beside the stream's
              device_idle_frac, whose windows count host issue as busy
 17. fleet    the scheduling fleet (repro_torch.fleet) right after phase
              16: phase 16's trace generator at 64 scenarios through 1-,
              2- and 4-worker fleets on the one card (each worker its own
              interpreter, CUDA context and StreamingScheduler; fresh
              shared ShardedMemoStores; warmed up and run once on a
              disjoint-seed twin first) and through one in-process stream:
              scenarios/s, latency p50 / p99, steals, each worker's
              makespan launches; the 2-worker fleet's rows bitwise
              standalone run_strategy and the in-process stream's; on a
              one-signature 24-scenario trace its steal-free rerun
              replays every row with at least one cross-worker exact hit,
              arrays bitwise run 1's; every worker at one makespan launch
              per generation and batch and no build after its warmup;
              MultiTenantEngine(fleet=) bitwise its in-process schedule

The counts of every kernel are set to 0 before each main path (the M3E
searches, the served batch, phases 9-10 together, "train_eval", the
comparison, "compare", the memo phase, "memo", the launcher, "launch",
phase 15's training and evaluation, "families", phase 16, "stream", and
phase 17, "fleet", whose makespan count adds the launches every fleet
worker reports to this process's) and read after it.
It prints a JSON line with one entry per kernel, the card's name and
power limit, and last the line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --stream-ab ROOT [ROOT ...]

runs phase 16's serial and pipelined modes STREAM_AB_REPS times each,
alternating, for each checkout ROOT in that order, each in a process of
its own with this file's measuring code (two versions of the stream held
on one card in one call: ``git archive`` the other version into a
directory under build/).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-4, 1e-5          # tests/test_makespan_parity.py:29
ORACLE_REL = 2e-3                # float32 simulators vs the float64 oracle
SSM_TOL_F32, SSM_TOL_BF16 = 1e-4, 5e-2   # tests/test_kernels.py:112-127
MODEL_F32_ATOL = 1e-3            # 4-layer f32 logits, kernel vs plain scan
FLASH_TOL_F32, FLASH_TOL_BF16 = 2e-5, 2e-2   # tests/test_kernels.py:78
# bf16 outside the reference's sweep (outputs ~0.03 at the evaluation
# shapes, where 2e-2 would hold nothing): the f32 limit plus one bf16
# rounding step of the output (spacing <= 2^-7 |x|), since both sides
# round an f32 result that agrees to FLASH_TOL_F32
FLASH_BF16_STEP = 2.0 ** -7
EVAL_F32_ATOL = 1e-4             # 4-layer f32 loss, flash vs plain route
# the bf16 kernel's edges, held to FLASH_TOL_F32 + FLASH_BF16_STEP |want|:
# (B, S, Hq, Hkv, D, window, causal, q/k/v packed in one tensor); rows of
# 40 bytes at D=20 are not 16-byte aligned, a window of 300 ends inside
# 64-key tiles, S=1 is one row of one tile
FLASH_EDGES = [(2, 77, 4, 2, 20, 0, True, True),
               (1, 300, 8, 2, 120, 0, True, True),
               (1, 1000, 4, 2, 64, 300, True, False),
               (2, 1, 4, 2, 64, 0, True, False),
               (1, 1, 2, 1, 120, 0, False, False),
               (1, 200, 4, 2, 120, 0, False, False)]
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
# expf results on the SFU: 16 per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0), 132 SMs at
# the 1,980 MHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
GB = 1024 ** 3
SERVE_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")
PROMPT, GENERATE, WINDOW = 512, 32, 8
TRAIN_ARCH, EVAL_ARCH = "granite-3-2b", "h2o-danube-3-4b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 2048
EVAL_BATCH, EVAL_SEQ = 1, 8192
# phase 12: the Fig. 9 protocol (benchmarks/fig09_heterogeneous.py:15-19)
# and Table IV's methods (benchmarks/common.py:24-25)
FIG9_SETTINGS = (("S2", 16), ("S4", 256))      # setting, bw_sys in GB/s
FIG9_TASKS = ("Vision", "Mix")
DEVICE_METHODS = ("magma", "stdga", "de", "pso", "random")
HOST_METHODS = ("cmaes", "tbpsa", "a2c", "ppo2", "herald_like", "ai_mt_like")
COMPARE_SEEDS = (0, 1)
COMPARE_CHUNK_ROWS = 3       # 4 rows a sweep: the last chunk is partial
# the cut this script takes to finish in half its time limit: the host
# methods (an RL search at 10K samples takes ~30 s on the card) run one
# seed; G and the budget are never cut
HOST_SEEDS = (0,)
# a host search launches the makespan kernel once per fitness batch: one
# per entry of its history, plus, for the RL mappers, the batch of 32
# random schedules that sets the reward scale
HOST_EXTRA_BATCHES = {"a2c": 1, "ppo2": 1}
# phase 13: the schedule memo and the Section V-C warm start; Table V's
# protocol (benchmarks/tableV_warmstart.py:35-80) at full width
MEMO_NEAR_GROUPS = 5         # Mix group 0 donates to groups 1-4
TABLE_V_SETTING, TABLE_V_BW = "S4", 1          # bw_sys in GB/s
TABLE_V_POP, TABLE_V_INSTS = 100, 4
TABLE_V_EPOCHS = (0, 1, 30, 100)
# phase 14: the serving launcher (src/repro/launch/serve.py:37-38, :59) at
# full width: its default tenants, its default budget and window
LAUNCH_ARCHS = ("granite-3-2b", "qwen2-moe-a2.7b", "falcon-mamba-7b")
LAUNCH_REQUESTS, LAUNCH_SEED = 6, 0
LAUNCH_PROBE_TOKENS = 16     # greedy tokens of the per-token decode probe
QWEN_ACTIVE_PARAMS = 2_433_373_388   # repro.models.registry's own count
# tests/test_models.py::test_decode_matches_full_forward: B=2, S=24, MoE at
# a drop-free capacity factor, relative 5e-3 (over the real vocabulary:
# the padded entries' -1e30 would set the scale)
DECODE_B, DECODE_S, DECODE_REL = 2, 24, 5e-3
# phase 15: the SSM, hybrid and encoder-decoder families trained and
# evaluated: (arch, steps, batch, seq, layers or None for full depth);
# falcon-mamba-7b is cut to 4 layers (its full depth with AdamW state
# does not fit one card)
FAMILY_TRAIN = (("zamba2-1.2b", 2, 1, 512, None),
                ("seamless-m4t-medium", 4, 2, 1024, None),
                ("falcon-mamba-7b", 2, 1, 512, 4))
# (arch, batch, seq) of each use_flash=True evaluation
FAMILY_EVAL = (("falcon-mamba-7b", 1, 2048), ("zamba2-1.2b", 4, 2048),
               ("seamless-m4t-medium", 2, 1024))
# f32 kernel-vs-plain comparisons: (arch, layers); zamba2 at 7 layers
# applies its shared block twice
FAMILY_F32_LAYERS = (("falcon-mamba-7b", 4), ("zamba2-1.2b", 7))
FAMILY_PLAIN_SEQ = 512       # full depth bf16: both routes at this length
# phase 16: the streaming service (repro_torch.stream) at the paper's G=100
# and 10K samples, on benchmarks/perf_stream.py's trace shape (three
# mixes, two settings, the 1-64 GB/s ladder, tenant batch scales 1-8)
STREAM_TRACE = dict(num_scenarios=32, arrival="poisson", rate_hz=100.0,
                    mixes=("Heavy", "Light", "HeavyLight"),
                    settings=("S2", "S4"),
                    bw_ladder_gb=(1.0, 4.0, 16.0, 64.0), group_size=100,
                    batch_scale_max=8, seed=0)
STREAM_BUDGET, STREAM_ANYTIME = 10_000, 2_500
STREAM_PRIORITIES = ("urgent", "normal", "batch", "batch")
# phase 17: phase 16's trace generator at 64 scenarios through 1-, 2- and
# 4-worker fleets on the one card (chunks of one batch, two in flight a
# worker); the memo gate's steal-prone trace puts all of its scenarios on
# one signature (S4), so the 2-worker fleet's first dispatch round steals
# (benchmarks/perf_fleet.py's skewed-trace construction)
STREAM_AB_REPS = 5           # --stream-ab: serial / pipelined pairs a root
FLEET_SCENARIOS = 64
FLEET_WORKERS = (1, 2, 4)
FLEET_SKEW = dict(STREAM_TRACE, num_scenarios=24, settings=("S4",), seed=7)
FLEET_ENGINE_REQUESTS = (("granite-3-2b", 300, 40),
                         ("qwen2-moe-a2.7b", 200, 48),
                         ("falcon-mamba-7b", 354, 32))


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled):
    """A readable name for one instantiation of the port's kernels."""
    import re
    m = re.search(r"flash_fwd_mma_kernelILi(\d+)E", mangled)
    if m:
        return f"bf16 tensor cores D<={m.group(1)}"
    m = re.search(r"flash_fwd_kernelIfLi(\d+)E", mangled)
    if m:
        return f"f32 CUDA cores D<={m.group(1)}"
    m = re.search(r"makespan_kernelILi(\d+)E", mangled)
    if m:
        return f"groups of {m.group(1)} lanes"
    m = re.search(r"ssm_scan_kernelI(\w+?)Li(\d+)ELi(\d+)E", mangled)
    if m:
        types = m.group(1)
        x_f32 = types.startswith("f")
        rest = types[1:] if x_f32 else types[len("13__nv_bfloat16"):]
        return (f"x {'f32' if x_f32 else 'bf16'} B/C "
                f"{'f32' if rest == 'f' else 'bf16'}, {m.group(2)} states "
                f"a lane, {m.group(3)} lanes")
    return None


def compare(got, want, what):
    """Max abs / rel error of ``got`` against ``want``; fails outside
    rtol 1e-4 / atol 1e-5."""
    import torch
    got, want = got.double().cpu(), want.double().cpu()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite makespans")
    err = (got - want).abs()
    rel = err / want.abs().clamp_min(1e-30)
    ok = bool((err <= ATOL + RTOL * want.abs()).all())
    check(ok, f"{what}: kernel disagrees with the plain version "
              f"(max abs {float(err.max())}, max rel {float(rel.max())})")
    return float(err.max()), float(rel.max())


def ptxas_json(entries):
    return {k: dict(zip(("registers", "spill_store_bytes",
                         "spill_load_bytes"), v)) for k, v in entries.items()}


def time_cuda(fn, reps, warmup):
    """Mean ms per call of ``fn`` on the card, by CUDA events around calls
    issued back to back from Python (the host-issued figure)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def makespan_bound_ms(P, A, G):
    """Least time for one population makespan: the queue slots the
    simulation reads (an individual's counts sum to G, so 2*G f32 of its
    padded (A, G) lat/bw tables), its A counts, and its makespan written
    once, against P*G events of (8A + 4) f32 operations (A-way sum, alloc,
    runtime max+div, A-way min, rem mul+sub+max; scale max+div+min and the
    clock add per individual)."""
    nbytes = 2 * P * G * 4 + P * A * 4 + P * 4
    ops = P * G * (8 * A + 4)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def ssm_bound_ms(Bt, L, D, N, x_bytes, bc_bytes):
    """Least time for one selective scan: x (x_bytes each), dt (f32) and
    y (f32) once per (b, t, d), A (f32) once, B and C (bc_bytes each) once
    per (b, t, n) and the final state h (f32) once, against its operations:
    Bt*L*D*N expf on the SFU and Bt*L*D*(6N + 1) other f32 operations
    (per state dt*A, decay*h, u*B, their sum, h*C and its sum into y; per
    channel u = dt*x).  The larger of the three times."""
    nbytes = (Bt * L * D * (x_bytes + 8) + D * N * 4
              + 2 * Bt * L * N * bc_bytes + Bt * D * N * 4)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = max(Bt * L * D * N / SFU_EXP_PER_S,
                 Bt * L * D * (6 * N + 1) / F32_OPS_PER_S)
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def compare_tol(got, want, tol, what, rtol=None):
    """Max abs / rel error; fails outside atol = ``tol`` and rtol =
    ``rtol`` (default ``tol``: the reference's
    np.testing.assert_allclose(atol=tol, rtol=tol))."""
    import torch
    rtol = tol if rtol is None else rtol
    got, want = got.double().cpu(), want.double().cpu()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - want).abs()
    rel = err / want.abs().clamp_min(1e-30)
    check(bool((err <= tol + rtol * want.abs()).all()),
          f"{what}: kernel disagrees with the plain version (max abs "
          f"{float(err.max())}, max rel {float(rel.max())}, atol {tol}, "
          f"rtol {rtol})")
    return float(err.max()), float(rel.max())


def causal_pairs(S, window):
    """Unmasked (query, key) pairs of one causal head (window 0: none)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_ops(B, S, Hq, D, window):
    """Useful operations of one causal attention call: 4 * D (the two
    products) per unmasked pair of every (b, h)."""
    return 4 * B * Hq * D * causal_pairs(S, window)


def flash_bound_ms(B, S, Hq, Hkv, D, window):
    """Least time for one causal bf16 attention call: q and o (B, S, Hq,
    D) and k, v (B, S, Hkv, D) moved once, against ``flash_ops`` at the
    bf16 tensor-core peak."""
    nbytes = (2 * B * S * Hq * D + 2 * B * S * Hkv * D) * 2
    ops = flash_ops(B, S, Hq, D, window)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def flash_inputs(dev, seed, B, S, Hq, Hkv, D, dtype, packed=False):
    """q (B, S, Hq, D), k and v (B, S, Hkv, D), N(0, 1); ``packed``: strided
    views of one (B, S, Hq + 2 Hkv, D) tensor, as a fused projection
    gives them."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if packed:
        qkv = torch.randn((B, S, Hq + 2 * Hkv, D), generator=gen,
                          device=dev).to(dtype)
        return qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    return tuple(torch.randn((B, S, h, D), generator=gen, device=dev)
                 .to(dtype) for h in (Hq, Hkv, Hkv))


def flash_checks(dev, fa, flash_ref, sync):
    """Phase 3 for the flash kernel: against its plain version at the
    reference tests' shapes, ragged S at D=20 and D=160, and the three
    evaluation shapes, in float32 and bf16; the bf16 kernel's edges
    (``FLASH_EDGES``); and bitwise row independence.  In bf16 the
    reference sweep's shapes are held to the reference tests' limit, the
    others to FLASH_TOL_F32 plus FLASH_BF16_STEP relative.  Returns (max
    abs, max rel) errors and the bf16 evaluation inputs."""
    import torch
    errs, main = [], {}
    sweep = [(2, 64, 4, 2, 32, 0, True), (1, 128, 8, 8, 64, 0, True),
             (2, 96, 4, 1, 16, 24, True), (1, 64, 6, 2, 128, 16, True),
             (1, 64, 4, 2, 32, 0, False)]
    evaluation = {"granite": (TRAIN_BATCH, TRAIN_SEQ, 32, 8, 64, 0, True),
                  "danube": (EVAL_BATCH, EVAL_SEQ, 32, 8, 120, 4096, True),
                  # phase 15: zamba2's shared block, Hq = Hkv
                  "zamba2": (4, 2048, 32, 32, 64, 0, True)}
    ragged = [(2, 33, 4, 2, 20, 0, True), (1, 97, 4, 2, 160, 0, True),
              (1, 77, 2, 1, 160, 40, False)]
    cases = sweep + ragged + list(evaluation.values())
    at = {len(sweep) + len(ragged) + j: key
          for j, key in enumerate(evaluation)}
    for i, (B, S, Hq, Hkv, D, window, causal) in enumerate(cases):
        bf16_tol = ((FLASH_TOL_BF16, FLASH_TOL_BF16) if i < len(sweep)
                    else (FLASH_TOL_F32, FLASH_BF16_STEP))
        for dtype, (tol, rtol) in (
                (torch.float32, (FLASH_TOL_F32, FLASH_TOL_F32)),
                (torch.bfloat16, bf16_tol)):
            q, k, v = flash_inputs(dev, 300 + i, B, S, Hq, Hkv, D, dtype)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            sync()
            want = flash_ref(q, k, v, causal=causal, window=window)
            what = (f"flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                    f"window={window} causal={causal} "
                    f"{str(dtype).split('.')[-1]}")
            errs.append(compare_tol(got.float(), want.float(), tol, what,
                                    rtol))
            rms = float(want.double().pow(2).mean().sqrt())
            print(f"[check] {what}: max abs {errs[-1][0]:.3e} rel "
                  f"{errs[-1][1]:.3e} (atol {tol:g}, rtol {rtol:g}; "
                  f"output rms {rms:.3e})")
            del got, want
            if i in at and dtype == torch.bfloat16:
                main[at[i]] = ((q, k, v), dict(causal=causal, window=window))
    for i, (B, S, Hq, Hkv, D, window, causal, packed) in enumerate(
            FLASH_EDGES):
        q, k, v = flash_inputs(dev, 350 + i, B, S, Hq, Hkv, D,
                               torch.bfloat16, packed)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        sync()
        want = flash_ref(q, k, v, causal=causal, window=window)
        what = (f"flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                f"window={window} causal={causal} bfloat16"
                f"{' packed qkv views' if packed else ''}")
        errs.append(compare_tol(got.float(), want.float(), FLASH_TOL_F32,
                                what, FLASH_BF16_STEP))
        print(f"[check] {what}: max abs {errs[-1][0]:.3e} rel "
              f"{errs[-1][1]:.3e} (atol {FLASH_TOL_F32:g}, rtol "
              f"{FLASH_BF16_STEP:g})")
    q, k, v = flash_inputs(dev, 400, 2, 150, 8, 2, 120, torch.bfloat16)
    out2 = fa.flash_attention(q, k, v, window=40)
    for b in range(2):
        out1 = fa.flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                  window=40)
        check(torch.equal(out2[b:b + 1], out1),
              f"flash_attention: row {b} of a B=2 launch differs bitwise "
              "from its B=1 launch")
    print("[check] flash_attention B=2 rows == two B=1 launches, bitwise")
    return errs, main


def model_flops(n_params, cfg, B, S):
    """Model FLOPs of one training step: 6 N T plus three times the
    forward attention products (4 D per unmasked pair, every head and
    layer), as repro's registry.model_flops counts them."""
    att = flash_ops(B, S, cfg.n_heads, cfg.hd,
                    cfg.sliding_window) * cfg.num_layers
    return 6.0 * n_params * B * S + 3.0 * att


def train_phase(dev, fa):
    """Phase 9: the launcher at full width and depth, then the 4-layer
    checkpoint restart.  Returns (model, stream, per-step records,
    restart summary)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import count_params, get_model
    from repro_torch.train.data import TokenStream
    from repro_torch.train.loop import TrainConfig, train

    args = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--device", str(dev),
            "--seed", "0"]
    t0 = time.perf_counter()
    model, state, hist = launch_train.main(args)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    wall = time.perf_counter() - t0
    cfg = model.cfg
    n = count_params(cfg)
    check(sum(p.numel() for p in model.parameters()) == n,
          f"{cfg.name}: parameter count")
    flops = model_flops(n, cfg, TRAIN_BATCH, TRAIN_SEQ)
    records = []
    for h in hist:
        rec = dict(h, ms=h["wall_s"] * 1e3,
                   tokens_per_s=h["tokens"] / h["wall_s"],
                   mfu=flops / h["wall_s"] / BF16_OPS_PER_S)
        records.append(rec)
        peak = ("not measured" if h["peak_bytes"] is None
                else f"{h['peak_bytes'] / GB:.2f} GiB")
        print(f"[train] {cfg.name} step {h['step']}: loss {h['loss']:.6f} "
              f"grad norm {h['grad_norm']:.6f} lr {h['lr']:.3e} "
              f"{rec['ms']:.3f} ms {rec['tokens_per_s']:.1f} tokens/s "
              f"peak {peak} mfu {rec['mfu']:.4f}")
    check(len(hist) == TRAIN_STEPS, f"{len(hist)} training steps, want "
                                    f"{TRAIN_STEPS}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              and h["grad_norm"] > 0 for h in hist),
          "training: a loss or grad norm is not finite, or a grad norm is 0")
    check(fa.LAUNCHES["flash_attention"] == 0,
          "training launched the flash kernel (it runs the plain route)")
    fresh = get_model(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    moved = [(p.dim(), not torch.equal(p, f)) for p, f in
             zip(model.parameters(), fresh.parameters())]
    del fresh
    matrices = [c for d, c in moved if d == 2]
    vectors = [c for d, c in moved if d == 1]
    check(all(matrices), f"training changed {sum(matrices)} of the "
                         f"{len(matrices)} weight matrices, want all")
    print(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n:,} params in {cfg.dtype}; {TRAIN_STEPS} steps "
          f"of {TRAIN_BATCH}x{TRAIN_SEQ} tokens in {wall:.3f} s including "
          f"init; {sum(matrices)}/{len(matrices)} weight matrices and "
          f"{sum(vectors)}/{len(vectors)} norm scales changed; flash "
          "launches 0")

    # checkpoint restart at full width, 4 layers
    cfg4 = cfg.replace(num_layers=4)
    stream = TokenStream(cfg4, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    tc = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    quiet = dict(log_every=0, log_fn=lambda *_: None)

    def fresh4():
        return get_model(cfg4, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1))

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        straight = train(fresh4(), tc, stream, TRAIN_STEPS, **quiet)
        snap = {k: v.detach().clone() for k, v in straight.params.items()}
        del straight
        train(fresh4(), tc, stream, TRAIN_STEPS // 2, checkpoint_dir=tmp,
              **quiet)
        resumed = train(fresh4(), tc, stream, TRAIN_STEPS,
                        checkpoint_dir=tmp, **quiet)
        on_disk = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(tmp) for f in fs)
        check(resumed.step == TRAIN_STEPS and all(
            torch.equal(snap[k], v) for k, v in resumed.params.items()),
            "checkpoint restart: 2 + restore + 2 steps differ bitwise from "
            "4 steps straight")
        restart = {"layers": 4, "steps": TRAIN_STEPS, "bitwise": True,
                   "checkpoint_bytes_on_disk": on_disk,
                   "wall_s": time.perf_counter() - t0}
        print(f"[train] checkpoint restart at full width, 4 layers: 4 steps "
              f"straight == 2 + checkpoint + restore + 2, bitwise "
              f"({on_disk / GB:.2f} GiB of checkpoints on disk, "
              f"{restart['wall_s']:.3f} s)")
        del resumed, snap
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    model.cfg = cfg
    del state
    return model, records, restart


EVALS = [("granite", TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ),
         ("danube", EVAL_ARCH, EVAL_BATCH, EVAL_SEQ)]


def eval_batch(dev, cfg, B, S):
    """``TokenStream(cfg, B, S, seed=0).batch_at(10_000)`` on ``dev``, the
    batch examples/train_lm.py evaluates on."""
    import torch
    from repro_torch.train.data import TokenStream
    return {k: torch.as_tensor(v, device=dev) for k, v in
            TokenStream(cfg, B, S, seed=0).batch_at(10_000).items()}


def eval_loss(model, cfg, batch, fa):
    """(loss under torch.no_grad() with ``cfg``, flash launches, wall s)."""
    import torch
    dev = batch["tokens"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model.cfg = cfg
    before = fa.LAUNCHES["flash_attention"]
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss = float(model.loss(batch)[0])
    sync()
    return loss, fa.LAUNCHES["flash_attention"] - before, \
        time.perf_counter() - t0


def free(dev):
    import gc

    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def eval_phase(dev, fa, trained):
    """Phase 10: the trained granite and a full danube through the flash
    route, with launch counts, and the plain route beside it (reported).
    Returns the phase's summary."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import count_params, get_model

    out = {}
    for key, arch, B, S in EVALS:
        if key == "granite":
            model, cfg = trained, trained.cfg
        else:
            cfg = get_config(arch)
            model = get_model(cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(2))
        batch = eval_batch(dev, cfg, B, S)
        lf, launched, wall = eval_loss(model, cfg.replace(use_flash=True),
                                       batch, fa)
        check(np.isfinite(lf), f"{arch} eval: non-finite loss")
        check(launched == cfg.num_layers,
              f"{arch} eval: {launched} flash launches, want one per layer "
              f"({cfg.num_layers})")
        lp, plain_launched, plain_wall = eval_loss(
            model, cfg.replace(use_flash=False), batch, fa)
        check(plain_launched == 0, f"{arch}: the plain route launched the "
                                   "flash kernel")
        out[key] = {"arch": arch, "params": count_params(cfg), "B": B,
                    "S": S, "window": cfg.sliding_window, "loss_flash": lf,
                    "flash_launches": launched, "wall_s": wall,
                    "loss_plain_bf16": lp, "plain_wall_s": plain_wall,
                    "full_depth_bf16_abs_diff": abs(lf - lp)}
        print(f"[eval] {arch} full width and depth, bf16, B={B} S={S}: loss "
              f"{lf:.6f} with use_flash=True ({launched} flash launches, "
              f"{wall * 1e3:.3f} ms), {lp:.6f} on the plain route "
              f"({plain_wall * 1e3:.3f} ms); |diff| {abs(lf - lp):.3e} "
              "(reported, not required)")
        model.cfg = cfg
        del model, batch
        free(dev)
    return out


def compare_routes(dev, fa, evals):
    """Phase 10, the comparison: at full width with 4 layers in float32,
    each model's flash and plain routes on the same weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    for key, arch, B, S in EVALS:
        cfg = get_config(arch).replace(num_layers=4, dtype="float32")
        model = get_model(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(3))
        batch = eval_batch(dev, cfg, B, S)
        lf, launched, _ = eval_loss(model, cfg.replace(use_flash=True),
                                    batch, fa)
        lp, _, _ = eval_loss(model, cfg.replace(use_flash=False), batch, fa)
        diff = abs(lf - lp)
        check(launched == 4 and diff <= EVAL_F32_ATOL,
              f"{arch} 4 layers f32: flash loss {lf} vs plain {lp} "
              f"(|diff| {diff}, tol {EVAL_F32_ATOL}; {launched} launches)")
        evals[key]["f32_4_layers"] = {"loss_flash": lf, "loss_plain": lp,
                                      "abs_diff": diff}
        print(f"[eval] {arch} full width, 4 layers, f32, B={B} S={S}: "
              f"flash {lf:.7f} plain {lp:.7f} |diff| {diff:.3e} (tol "
              f"{EVAL_F32_ATOL})")
        del model, batch
        free(dev)


def flash_timing(fa, flash_ref, main_inputs, time_fn):
    """Phase 11: kernel, plain version and torch's SDPA at both
    evaluation shapes, beside the bound."""
    import torch
    import torch.nn.functional as F
    out = {}
    for key, ((q, k, v), kw) in main_inputs.items():
        B, S, Hq, D = q.shape
        Hkv = k.shape[2]
        k_ms = time_fn(lambda: fa.flash_attention(q, k, v, **kw), 10, 2)
        p_ms = time_fn(lambda: flash_ref(q, k, v, **kw), 3, 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if kw["window"]:
            pos = torch.arange(S, device=q.device)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - kw["window"])

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=kw["causal"], enable_gqa=True)
        got = fa.flash_attention(q, k, v, **kw)
        try:
            lib = library()
        except RuntimeError as err:       # no backend takes these inputs
            raise RuntimeError(f"scaled_dot_product_attention refused the "
                               f"{key} inputs: {err}") from err
        lib_err = float((lib.transpose(1, 2).float() - got.float())
                        .abs().max())
        del lib, got
        l_ms = time_fn(library, 10, 2)
        b_ms, b_by = flash_bound_ms(B, S, Hq, Hkv, D, kw["window"])
        tflops = flash_ops(B, S, Hq, D, kw["window"]) / k_ms / 1e9
        out[key] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "tflops": tflops,
                    "library_max_abs_diff": lib_err,
                    "shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
                              "window": kw["window"]}}
        print(f"[timing] flash_attention {key} B={B} S={S} Hq={Hq} "
              f"Hkv={Hkv} D={D} window={kw['window']} bf16: kernel "
              f"{k_ms:.6f} ms, plain {p_ms:.6f} ms, "
              f"scaled_dot_product_attention {l_ms} ms (max abs diff to "
              f"the kernel {lib_err}), bound {b_ms:.6f} ms ({b_by}); "
              f"kernel {k_ms / b_ms:.1f}x the bound, {tflops:.1f} useful "
              "TFLOP/s")
    return out


def profile_train_step(dev):
    """Phase 11: one granite training step (full width and depth, after a
    warm-up step) under torch.profiler: wall, device busy share, top
    device ops."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.train.data import TokenStream
    from repro_torch.launch.train import train_config
    from repro_torch.train.loop import init_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    model = get_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    step = make_train_step(model, train_config(TRAIN_STEPS))
    state, _ = step(init_state(model), stream.batch_at(0))
    batch = stream.batch_at(1)
    prof = device_profile(dev, lambda: step(state, batch))
    del state, model
    if prof is None:
        print("[profile] the profiler saw no device time: device busy share "
              "not measured")
        return None
    print(f"[profile] one {TRAIN_ARCH} training step ({TRAIN_BATCH}x"
          f"{TRAIN_SEQ} tokens): wall {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['device_busy_ms']:.3f} ms ({prof['device_busy_share']:.1%})"
          f" over {prof['device_ops']} device ops")
    for k, v in prof["top_kernels_ms"]:
        print(f"[profile]   {v:10.3f} ms  {k[:100]}")
    return prof


def compare_phase(dev, mk, budget=10_000, group_size=100):
    """Phase 12: the paper's Fig. 9 comparison through the port's entry
    points on ``dev``.  Every device-resident method runs one
    ``run_sweep`` per setting (its two tasks x COMPARE_SEEDS rows in
    chunks of COMPARE_CHUNK_ROWS) that must launch the makespan kernel
    once per generation and chunk, and whose rows must equal bitwise the
    same searches run one by one with ``run_strategy``; the host methods
    run through ``M3E.search``.  Every best individual, re-evaluated by
    the plain version on the CPU, must give its best fitness at rtol
    1e-4.  Every part's makespan launches are counted against what it
    must launch (a host search: one per fitness batch, i.e. per entry of
    its history, and the RL reward scale's batch); the phase's total is returned for ``main`` to hold
    against the path's count.  Returns the phase's summary."""
    import torch
    from repro_torch.core.fitness import FitnessFn
    from repro_torch.core.m3e import M3E, geomean
    from repro_torch.core.strategies import (get_strategy, plan_generations,
                                             run_strategy)
    from repro_torch.core.sweep import SweepConfig, run_sweep
    from repro_torch.costmodel import get_setting
    from repro_torch.workloads import build_task_groups

    t_phase = time.perf_counter()
    groups = {t: build_task_groups(t, group_size=group_size, seed=0)[0]
              for t in FIG9_TASKS}
    m3es, fits, cpu_fits, labels = {}, {}, {}, []
    for setting, bw in FIG9_SETTINGS:
        m3es[setting] = M3E(get_setting(setting), bw_sys=bw * GB, device=dev)
        for task in FIG9_TASKS:
            label = f"{task}-{setting}-bw{bw}"
            labels.append(label)
            fits[label] = m3es[setting].prepare(groups[task])
            cpu_fits[label] = FitnessFn(fits[label].table, bw_sys=bw * GB,
                                        device="cpu")

    def reevaluate(label, method, best, accel, prio):
        again = float(cpu_fits[label](torch.as_tensor(accel[None]),
                                      torch.as_tensor(prio[None]))[0])
        check(np.isfinite(best) and best > 0
              and abs(again - best) <= RTOL * abs(best),
              f"compare {method} {label}: best fitness {best}, the plain "
              f"version on the CPU gives {again}")

    best = {label: {} for label in labels}
    method_wall, sweeps, method_launches = {}, [], {}
    for method in DEVICE_METHODS:
        strategy = get_strategy(method)
        generations = plan_generations(budget, strategy.ask_size)[0]
        method_wall[method] = 0.0
        method_launches[method] = 0
        for setting, bw in FIG9_SETTINGS:
            rows = [lab for lab in labels if lab.endswith(f"{setting}-bw{bw}")]
            before = mk.LAUNCHES["makespan"]
            t0 = time.perf_counter()
            res = run_sweep([fits[lab] for lab in rows], budget=budget,
                            seeds=COMPARE_SEEDS, strategy=strategy,
                            sweep=SweepConfig(chunk_rows=COMPARE_CHUNK_ROWS),
                            device=dev)
            sweep_wall = time.perf_counter() - t0
            launched = mk.LAUNCHES["makespan"] - before
            check(launched == generations * res.num_chunks,
                  f"compare {method} {setting}: {launched} makespan launches "
                  f"for {res.rows} rows in {res.num_chunks} chunks, want one "
                  f"per generation and chunk ({generations * res.num_chunks})")
            before = mk.LAUNCHES["makespan"]
            t0 = time.perf_counter()
            alone = {(s, k): run_strategy(strategy, fits[lab], budget=budget,
                                          seed=seed, device=dev)
                     for s, lab in enumerate(rows)
                     for k, seed in enumerate(COMPARE_SEEDS)}
            seq_wall = time.perf_counter() - t0
            alone_launched = mk.LAUNCHES["makespan"] - before
            check(alone_launched == generations * len(alone),
                  f"compare {method} {setting}: {alone_launched} makespan "
                  f"launches for {len(alone)} standalone searches, want "
                  f"{generations * len(alone)}")
            method_launches[method] += launched + alone_launched
            for (s, k), one in alone.items():
                check(res.best_fitness[s, k] == one.best_fitness
                      and np.array_equal(res.best_accel[s, k], one.best_accel)
                      and np.array_equal(res.best_prio[s, k], one.best_prio)
                      and np.array_equal(res.history_best[s, k],
                                         one.history_best),
                      f"compare {method} {setting}: sweep row [{s}, {k}] "
                      "differs from the standalone run_strategy")
            for s, lab in enumerate(rows):
                best[lab][method] = [float(x) for x in res.best_fitness[s]]
                for k in range(len(COMPARE_SEEDS)):
                    reevaluate(lab, method, float(res.best_fitness[s, k]),
                               res.best_accel[s, k], res.best_prio[s, k])
            method_wall[method] += sweep_wall
            sweeps.append({"method": method, "setting": setting,
                           "rows": res.rows, "chunks": res.num_chunks,
                           "padded_rows": res.padded_rows,
                           "launches": launched, "generations": generations,
                           "sweep_wall_s": sweep_wall,
                           "sequential_wall_s": seq_wall,
                           "chunk_wall_s": res.chunk_wall_s})
            print(f"[compare] {method} {setting}: run_sweep of {res.rows} "
                  f"rows in {res.num_chunks} chunks of {res.chunk_rows} "
                  f"({res.padded_rows - res.rows} padding): wall "
                  f"{sweep_wall:.4f} s, makespan launches {launched}; the "
                  f"same rows one by one {seq_wall:.4f} s; rows == "
                  f"standalone run_strategy, bitwise")
    before = mk.LAUNCHES["makespan"]
    profile = profile_sweep(dev, fits, labels, budget)
    profile_launches = mk.LAUNCHES["makespan"] - before
    want = next(sw["launches"] for sw in sweeps
                if sw["method"] == "magma" and sw["setting"] == "S4")
    check(profile_launches == want,
          f"compare: the profiled sweep launched {profile_launches} makespan "
          f"kernels, the same sweep unprofiled {want}")
    for method in HOST_METHODS:
        method_wall[method] = 0.0
        method_launches[method] = 0
        for setting, bw in FIG9_SETTINGS:
            for task in FIG9_TASKS:
                label = f"{task}-{setting}-bw{bw}"
                vals = []
                for seed in HOST_SEEDS:
                    before = mk.LAUNCHES["makespan"]
                    res = m3es[setting].search(groups[task], method=method,
                                               budget=budget, seed=seed)
                    launched = mk.LAUNCHES["makespan"] - before
                    batches = (len(res.history_samples)
                               + HOST_EXTRA_BATCHES.get(method, 0))
                    check(launched == batches,
                          f"compare {method} {label}: {launched} makespan "
                          f"launches for {batches} fitness batches")
                    method_launches[method] += launched
                    method_wall[method] += res.wall_time_s
                    reevaluate(label, method, res.best_fitness,
                               res.best_accel, res.best_prio)
                    vals.append(res.best_fitness)
                best[label][method] = vals
        print(f"[compare] {method}: {len(labels) * len(HOST_SEEDS)} "
              f"searches through M3E.search, wall {method_wall[method]:.4f} s")

    methods = DEVICE_METHODS + HOST_METHODS
    mean = {lab: {m: float(np.mean(best[lab][m])) for m in methods}
            for lab in labels}
    print("[compare] Fig. 9 (best throughput normalized to magma; magma "
          "in GFLOP/s):")
    print("[compare] problem," + ",".join(methods) + ",magma_GFLOPs")
    for lab in labels:
        norm = mean[lab]["magma"]
        print(f"[compare] {lab}," + ",".join(
            f"{mean[lab][m] / norm:.4f}" for m in methods)
            + f",{norm / 1e9:.1f}")
    advantage = {m: geomean([mean[lab]["magma"] / mean[lab][m]
                             for lab in labels])
                 for m in methods if m != "magma"}
    order = sorted(methods, key=lambda m: -geomean(
        [mean[lab][m] for lab in labels]))
    print("[compare] geomean MAGMA advantage: " + ", ".join(
        f"{m} {v:.4f}" for m, v in advantage.items()))
    print(f"[compare] methods by geomean best fitness: {' > '.join(order)}")
    print("[compare] wall per method (s): " + ", ".join(
        f"{m} {w:.3f}" for m, w in method_wall.items()))
    launches = sum(method_launches.values()) + profile_launches
    print("[compare] makespan launches per method (sweeps and standalone "
          "rows, or fitness batches): " + ", ".join(
              f"{m} {n}" for m, n in method_launches.items())
          + f"; profiled sweep {profile_launches}; phase {launches}")
    total = time.perf_counter() - t_phase
    print(f"[compare] cuts: host methods at {len(HOST_SEEDS)} seed(s) "
          f"({len(COMPARE_SEEDS)} for device methods); G={group_size} and "
          f"budget={budget} not cut; phase wall {total:.3f} s")
    return {"best_fitness": best, "normalized": {
                lab: {m: mean[lab][m] / mean[lab]["magma"] for m in methods}
                for lab in labels},
            "magma_advantage": advantage, "order": order,
            "method_wall_s": method_wall, "sweeps": sweeps,
            "launches": launches, "launches_by_method": method_launches,
            "profile_launches": profile_launches,
            "seeds": {"device": list(COMPARE_SEEDS),
                      "host": list(HOST_SEEDS)},
            "profile": profile, "phase_wall_s": total}


def profile_sweep(dev, fits, labels, budget):
    """One MAGMA sweep of the S4 rows under torch.profiler: its wall, the
    device's busy share, the device ops per generation and chunk, and the
    makespan kernel's part (None where the profiler sees no device)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    from repro_torch.core.sweep import SweepConfig, run_sweep

    rows = [fits[lab] for lab in labels if "-S4-" in lab]
    with profile(activities=profiler_activities(dev)) as prof:
        res = run_sweep(rows, budget=budget, seeds=COMPARE_SEEDS,
                        sweep=SweepConfig(chunk_rows=COMPARE_CHUNK_ROWS),
                        device=dev)
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not on_card:
        print("[compare] the profiler saw no device time: the sweep's busy "
              "share not measured")
        return None
    wall_ms = res.wall_time_s * 1e3
    busy_ms = sum(e.device_time_total for e in on_card) / 1e3
    mk_ms = sum(e.device_time_total for e in on_card
                if "makespan_kernel" in e.name) / 1e3
    per_gen = len(on_card) / (res.generations * res.num_chunks)
    print(f"[compare] traced magma sweep ({res.rows} rows, {res.num_chunks} "
          f"chunks of {res.chunk_rows}): wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}) over {len(on_card)} "
          f"device ops ({per_gen:.1f} a generation and chunk), makespan "
          f"kernel {mk_ms:.3f} ms")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_ops": len(on_card),
            "device_ops_per_generation_and_chunk": per_gen,
            "makespan_kernel_ms": mk_ms}


def same_result(a, b):
    """Two search results bitwise equal (best, genomes, history)."""
    return (a.best_fitness == b.best_fitness
            and np.array_equal(a.best_accel, b.best_accel)
            and np.array_equal(a.best_prio, b.best_prio)
            and np.array_equal(a.history_best, b.history_best))


def table_v(dev, group_size, pop=TABLE_V_POP, epochs=TABLE_V_EPOCHS,
            n_insts=TABLE_V_INSTS):
    """Table V through ``M3E(warm_start=WarmStartEngine())``: a full
    search on Mix instance 0 fills the cache, then instances 1..n_insts
    are searched for each number of epochs from the transferred
    population; Raw is the mean fitness of 32 random individuals.
    Returns the fractions of the full search and the script's two
    summary numbers."""
    import torch
    from repro_torch.core import M3E, MagmaConfig, WarmStartEngine
    from repro_torch.core.encoding import random_population
    from repro_torch.costmodel import get_setting
    from repro_torch.workloads import build_task_groups

    m3e = M3E(get_setting(TABLE_V_SETTING), bw_sys=TABLE_V_BW * GB,
              warm_start=WarmStartEngine(), device=dev)
    groups = build_task_groups("Mix", group_size=group_size,
                               num_groups=n_insts + 1, seed=0)
    kw = {"strategy_kwargs": {"cfg": MagmaConfig(population=pop)}}
    m3e.search(groups[0], budget=pop * max(epochs), seed=0, **kw)
    raws, finals = [], {e: [] for e in epochs}
    for i in range(1, n_insts + 1):
        fit = m3e.prepare(groups[i])
        gen = torch.Generator(device=dev)
        gen.manual_seed(100 + i)
        rnd = random_population(gen, 32, fit.group_size, fit.num_accels, dev)
        raws.append(float(fit(rnd.accel, rnd.prio).mean()))
        for e in epochs:
            res = m3e.search(groups[i], budget=max(pop * e, pop), seed=i, **kw)
            finals[e].append(res.history_best[0] if e == 0
                             else res.best_fitness)
    full = np.array(finals[max(epochs)])
    fracs = {"Raw": list(np.array(raws) / full)}
    for e in epochs:
        fracs[f"Trf-{e}-ep"] = list(np.array(finals[e]) / full)
    return {"fractions": {k: [float(x) for x in v] for k, v in fracs.items()},
            "gain0": float(np.mean(np.array(finals[0]) / np.array(raws))),
            "full_frac": float(np.mean(np.array(finals[0]) / full))}


def memo_phase(dev, mk, budget=10_000, group_size=100):
    """Phase 13: the schedule memo and the Section V-C warm start through
    the port's entry points on ``dev``: exact hits replay bitwise with no
    makespan launch (also from a reopened store), a memoized sweep
    records its rows, a row solved on the CPU never hits on ``dev``, near
    hits keep the reference's invariants, and Table V at full width meets
    the reference script's own assertion.  Returns the phase's
    summary."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core import M3E
    from repro_torch.core.fitness import FitnessFn
    from repro_torch.core.strategies import (MagmaStrategy, plan_generations,
                                             run_strategy)
    from repro_torch.core.sweep import SweepConfig, run_sweep
    from repro_torch.costmodel import get_setting
    from repro_torch.memo import MemoStore, ScheduleMemo
    from repro_torch.workloads import build_task_groups

    t_phase = time.perf_counter()
    strategy = MagmaStrategy()
    small = budget // 10          # the route and near-hit rows: 1K samples
    groups = build_task_groups("Mix", group_size=group_size,
                               num_groups=MEMO_NEAR_GROUPS, seed=0)
    s4 = get_setting("S4")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="memo_phase_",
                                 dir=os.path.join(ROOT, "build"))
    out = {}
    try:
        # 1. exact hit: first solve == the un-memoized search, the second
        # replays it with no launch, and so does a reopened store
        plain = M3E(s4, bw_sys=256 * GB, device=dev).search(
            groups[0], budget=budget, seed=0)
        memo = ScheduleMemo(MemoStore(store_dir))
        m3e = M3E(s4, bw_sys=256 * GB, memo=memo, device=dev)
        before = mk.LAUNCHES["makespan"]
        first = m3e.search(groups[0], budget=budget, seed=0)
        first_launches = mk.LAUNCHES["makespan"] - before
        check(same_result(first, plain),
              "memo: the first memoized solve differs from M3E.search")
        replays = []
        for name, mm in (("same memo", m3e),
                         ("reopened store", M3E(
                             s4, bw_sys=256 * GB, device=dev,
                             memo=ScheduleMemo(MemoStore(store_dir))))):
            before = mk.LAUNCHES["makespan"]
            t0 = time.perf_counter()
            again = mm.search(groups[0], budget=budget, seed=0)
            wall = time.perf_counter() - t0
            launched = mk.LAUNCHES["makespan"] - before
            check(launched == 0 and again.wall_time_s == 0.0
                  and same_result(again, plain),
                  f"memo: replay from the {name} launched {launched} "
                  f"kernels, wall_time_s {again.wall_time_s}, or differs")
            replays.append({"from": name, "m3e_search_wall_ms": wall * 1e3,
                            "launches": launched})
        fit = m3e.prepare(groups[0])
        lookups = []
        for _ in range(5):
            t0 = time.perf_counter()
            hit = memo.lookup(fit, strategy, budget, 0)
            lookups.append((time.perf_counter() - t0) * 1e3)
        check(hit is not None, "memo: lookup misses a recorded row")
        lookup_ms = float(np.median(lookups))
        print(f"[memo] exact hit S4/Mix G={group_size} budget={budget}: "
              f"first solve {first.wall_time_s * 1e3:.3f} ms "
              f"({first_launches} makespan launches) == M3E.search "
              f"({plain.wall_time_s * 1e3:.3f} ms), bitwise; lookup "
              f"{lookup_ms:.3f} ms (median of 5); replayed M3E.search "
              + ", ".join(f"{r['from']} {r['m3e_search_wall_ms']:.3f} ms "
                          f"({r['launches']} launches)" for r in replays)
              + "; bitwise")
        out["exact_hit"] = {"search_wall_ms": plain.wall_time_s * 1e3,
                            "first_solve_ms": first.wall_time_s * 1e3,
                            "first_launches": first_launches,
                            "lookup_ms": lookup_ms,
                            "lookup_ms_all": lookups, "replays": replays}

        # 2. a memoized sweep over phase 12's S4 setting
        setting, bw = FIG9_SETTINGS[-1]
        fits = [M3E(get_setting(setting), bw_sys=bw * GB,
                    device=dev).prepare(build_task_groups(
                        t, group_size=group_size, seed=0)[0])
                for t in FIG9_TASKS]
        sweep_memo = ScheduleMemo()
        before = mk.LAUNCHES["makespan"]
        res = run_sweep(fits, budget=budget, seeds=COMPARE_SEEDS,
                        sweep=SweepConfig(chunk_rows=COMPARE_CHUNK_ROWS),
                        memo=sweep_memo, memo_family=list(FIG9_TASKS),
                        device=dev)
        launched = mk.LAUNCHES["makespan"] - before
        generations = plan_generations(budget, strategy.ask_size)[0]
        check(sweep_memo.stats.records == res.rows == 4
              and launched == generations * res.num_chunks,
              f"memo sweep: {sweep_memo.stats.records} rows recorded of "
              f"{res.rows}, {launched} launches in {res.num_chunks} chunks")
        for s, fit_s in enumerate(fits):
            for k, seed in enumerate(COMPARE_SEEDS):
                hit = sweep_memo.lookup(fit_s, strategy, budget, seed)
                alone = run_strategy(strategy, fit_s, budget=budget,
                                     seed=seed, device=dev)
                check(hit is not None
                      and hit.best_fitness == res.best_fitness[s, k]
                      and np.array_equal(hit.best_accel, res.best_accel[s, k])
                      and np.array_equal(hit.history_best,
                                         res.history_best[s, k])
                      and same_result(hit.to_search_result(), alone),
                      f"memo sweep: row [{s}, {k}] replay differs from the "
                      "sweep row or the standalone search")
        print(f"[memo] run_sweep(memo=) {setting}/{bw} GB/s "
              f"{'+'.join(FIG9_TASKS)} x seeds {COMPARE_SEEDS}: "
              f"{sweep_memo.stats.records} rows recorded, {launched} "
              f"makespan launches in {res.num_chunks} chunks; every "
              "lookup == its sweep row == its standalone search, bitwise")
        out["sweep"] = {"rows_recorded": sweep_memo.stats.records,
                        "launches": launched, "chunks": res.num_chunks,
                        "wall_s": res.wall_time_s}

        # 3. route separation: a row solved on the CPU and recorded in a
        # memo hits neither exactly nor near on the card
        if dev.type == "cuda":   # the CPU is one route: a rehearsal skips it
            route_memo = ScheduleMemo()
            cpu_fit = FitnessFn(fit.table, bw_sys=256 * GB, device="cpu")
            cpu_res = run_strategy(strategy, cpu_fit, budget=small, seed=0,
                                   device="cpu", keep_population=True)
            route_memo.record(cpu_fit, strategy, small, 0, cpu_res,
                              population=cpu_res.final_population,
                              family="Mix")
            check(route_memo.lookup(cpu_fit, strategy, small, 0) is not None
                  and route_memo.lookup(fit, strategy, small, 0) is None
                  and route_memo.warm_start(fit, strategy,
                                            family="Mix") is None,
                  "memo route: the CPU-solved row hit on the card")
            before = mk.LAUNCHES["makespan"]
            card_res = M3E(s4, bw_sys=256 * GB, memo=route_memo,
                           device=dev).search(groups[0], budget=small,
                                              seed=0)
            launched = mk.LAUNCHES["makespan"] - before
            check(launched == plan_generations(small, strategy.ask_size)[0]
                  and same_result(card_res, run_strategy(
                      strategy, fit, budget=small, seed=0, device=dev)),
                  f"memo route: the card search after a CPU record launched "
                  f"{launched} kernels or is not the cold search")
            print(f"[memo] route: a {small}-sample row solved on the CPU "
                  f"(best {cpu_res.best_fitness:.6e}) hits neither exactly "
                  f"nor near on {dev}; the card solves it cold ({launched} "
                  f"launches, best {card_res.best_fitness:.6e})")
            out["route"] = {"cpu_best": cpu_res.best_fitness,
                            "card_best": card_res.best_fitness,
                            "card_launches": launched}

        # 4. near hits: Mix group 0's converged population (step 1's
        # record) offered to four sibling groups
        near = []
        for i in range(1, MEMO_NEAR_GROUPS):
            sib = m3e.prepare(groups[i])
            donor, dist = memo.donor(sib, strategy, family="Mix")
            ws = memo.warm_start(sib, strategy, family="Mix")
            cold = run_strategy(strategy, sib, budget=small, seed=i,
                                device=dev)
            warm = run_strategy(strategy, sib, budget=small, seed=i,
                                device=dev, init_population=ws)
            if ws is None:
                check(same_result(warm, cold),
                      f"memo near: group {i}'s refused donor did not give "
                      "the cold search")
            else:
                again = run_strategy(strategy, sib, budget=small, seed=i,
                                     device=dev, init_population=ws)
                loop = run_strategy(strategy, sib, budget=small, seed=i,
                                    device=dev, init_population=ws,
                                    engine="loop")
                check(same_result(warm, again) and same_result(warm, loop),
                      f"memo near: group {i}'s warm search is not "
                      "deterministic or its loop engine differs")
            outcome = "seeded" if ws is not None else "refused"
            ratio = warm.best_fitness / cold.best_fitness
            near.append({"group": i, "donor_dist": dist, "outcome": outcome,
                         "warm_over_cold": ratio})
            print(f"[memo] near hit Mix group {i}: donor distance "
                  f"{dist:.4f} (guard {memo.max_donor_dist}), {outcome}; "
                  f"warm/cold best fitness at {small} samples {ratio:.4f}")
        out["near"] = near
        out["stats"] = memo.stats.summary()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)

    # 5. Table V at full width
    t0 = time.perf_counter()
    tv = table_v(dev, group_size)
    tv_wall = time.perf_counter() - t0
    print(f"[memo] Table V ({TABLE_V_SETTING}, {TABLE_V_BW} GB/s, Mix, "
          f"G={group_size}, P={TABLE_V_POP}, epochs {TABLE_V_EPOCHS}), "
          f"fraction of the full search per instance 1-{TABLE_V_INSTS}:")
    for row, vals in tv["fractions"].items():
        print(f"[memo]   {row}," + ",".join(f"{v:.4f}" for v in vals))
    print(f"[memo]   gain0 (Trf-0-ep over Raw) {tv['gain0']:.4f}, full_frac "
          f"(Trf-0-ep over full) {tv['full_frac']:.4f}; wall "
          f"{tv_wall:.3f} s")
    check(tv["gain0"] > 1.1 and tv["full_frac"] > 0.75,
          f"Table V: gain0 {tv['gain0']} and full_frac {tv['full_frac']}, "
          "want > 1.1 and > 0.75 (benchmarks/tableV_warmstart.py:80)")
    out["table_v"] = dict(tv, wall_s=tv_wall)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[memo] memo stats {out['stats']}; phase wall "
          f"{out['phase_wall_s']:.3f} s")
    return out


def profiler_activities(dev):
    """What torch.profiler records here: the card's activity alone (its
    kernels, with their names and intervals, are all the script reads;
    recording every host op as well would slow the profiled work and the
    parsing of its events), or the host on the CPU."""
    from torch.profiler import ProfilerActivity
    return ([ProfilerActivity.CUDA] if dev.type == "cuda"
            else [ProfilerActivity.CPU])


def device_profile(dev, fn, top_n=10, parts=()):
    """``fn()`` under torch.profiler: (wall ms, device busy ms, device ops,
    the ``top_n`` device ops by time and, for each name in ``parts``, the
    device ms and ops of the ops whose names hold it), or None where the
    profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=profiler_activities(dev)) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not on_card:
        return None
    by_name = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "device_ops": len(on_card),
           "top_kernels_ms": [[k[:80], v] for k, v in top]}
    for part in parts:
        ops = [e for e in on_card if part in e.name]
        out.setdefault("parts", {})[part] = {
            "ms": sum(e.device_time_total for e in ops) / 1e3,
            "ops": len(ops)}
    return out


def drop_free(cfg):
    """``cfg`` with a MoE capacity no routing can overflow.  The
    reference's test takes capacity_factor 8.0, its smoke config's
    n_experts: C = ceil(T k cf / n_experts) = T k there, and an expert
    receives at most T of a group's T k pairs.  At full width (60 experts,
    top-4) 8.0 gives C = 13 of 96 pairs, and random weights send most
    tokens to a few experts, so the same guarantee takes cf = n_experts."""
    return cfg.replace(capacity_factor=float(max(cfg.n_experts, 1)))


def decode_vs_forward(model, dev, seed):
    """The reference's decode criterion on ``model``: DECODE_S tokens
    decoded one by one from an empty cache against the teacher-forced
    forward's logits; max abs difference over the forward's max abs, over
    the real vocabulary.  Returns (that ratio, routes): for a MoE model
    the routed experts that differ between the two runs, as (token,
    layer) pairs whose top-k set differs and as expert choices, each
    beside its total; None for a dense model."""
    import torch
    from repro_torch.models import layers as L
    cfg = model.cfg
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (DECODE_B, DECODE_S)), device=dev)
    picked, plain_moe = [], L.moe

    def recording_moe(p, x, **kw):
        xg = x.reshape(1, -1, x.shape[-1]) if kw["group_tokens"] else x
        r = L.moe_routing(p, xg, n_experts=kw["n_experts"],
                          top_k=kw["top_k"],
                          capacity_factor=kw["capacity_factor"])
        picked.append(r.top_e.reshape(x.shape[0], x.shape[1], -1))
        return plain_moe(p, x, **kw)

    L.moe = recording_moe
    try:
        with torch.no_grad():
            ref = model._logits(model.hidden_states(
                model.embed_inputs({"tokens": tokens}))[0])
            cache = model.init_cache(DECODE_B, DECODE_S)
            outs = []
            for t in range(DECODE_S):
                logits, cache = model.decode_step(cache, tokens[:, t:t + 1],
                                                  t)
                outs.append(logits[:, 0])
    finally:
        L.moe = plain_moe
    dec = torch.stack(outs, dim=1)[..., :cfg.vocab]
    ref = ref[..., :cfg.vocab]
    check(bool(torch.isfinite(dec).all()), f"{cfg.name}: non-finite decode")
    rel = float((dec - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
    if not picked:
        return rel, None
    n = cfg.num_layers               # the forward's calls, then decode's
    fwd = torch.stack(picked[:n])                          # (n, B, S, K)
    step = torch.stack(picked[n:]).reshape(DECODE_S, n, DECODE_B, -1)
    step = step.permute(1, 2, 0, 3)                        # (n, B, S, K)
    shared = (fwd[..., :, None] == step[..., None, :]).any(-1).sum(-1)
    k = fwd.shape[-1]
    return rel, {"token_layers_differing": int((shared < k).sum()),
                 "token_layers": shared.numel(),
                 "choices_differing": int((k - shared).sum()),
                 "choices": fwd.numel()}


def routes_line(routes):
    if routes is None:
        return ""
    return (f"; routed experts differing from the forward's: "
            f"{routes['token_layers_differing']} of "
            f"{routes['token_layers']} (token, layer) pairs, "
            f"{routes['choices_differing']} of {routes['choices']} choices")


def decode_probe_ms(model, prompt, dev, n=LAUNCH_PROBE_TOKENS, warmup=2):
    """Median wall (ms) of ``n`` greedy tokens decoded one by one after
    ``prompt``'s prefill and ``warmup`` tokens: phase 14 reads it before
    the process's first profiler session and again after phase 13."""
    import torch
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    seq = prompt.shape[1]
    with torch.no_grad():
        logits, cache = model.prefill({"tokens": prompt}, seq + warmup + n)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        walls = []
        for pos in range(seq, seq + warmup + n):
            sync()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(cache, cur, pos)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
            sync()
            walls.append(time.perf_counter() - t0)
    return float(np.median(walls[warmup:])) * 1e3


def launch_phase(dev, mk, ssm, fa, full=True):
    """Phase 14: the serving launcher's flow (``repro_torch.launch.serve``)
    at full published width on ``dev``: granite-3-2b (dense),
    qwen2-moe-a2.7b (MoE) and falcon-mamba-7b (SSM) in bf16 through the
    kernels, LAUNCH_REQUESTS requests, MAGMA against herald_like and
    ai_mt_like, then the MAGMA schedule executed.  The kernels' counts are
    set to 0 just before the launcher runs and read just after.  Checks
    every schedule's coverage and makespan launches (one per MAGMA
    generation, one per heuristic), the scan's (one per falcon prefill
    layer), no flash launch, and every decode window's tokens; holds the
    makespan kernel against its plain version on the engine's own tables;
    prints each tenant's prefill walls and ms per decoded token beside its
    HBM bound, the decode probe, and the MoE prefill's dropped share; then
    the reference's decode criterion, reported at full depth in bf16 and
    held at 4 layers in float32.  Run it before any profiler session of
    the process.  ``full=False`` takes the smoke configs (a CPU
    rehearsal).  Returns the phase's summary and, per tenant, the prompt
    its decode probe took (for ``launch_profile``)."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.bw_allocator import queue_tables, simulate_tables
    from repro_torch.core.encoding import decode, random_population
    from repro_torch.core.fitness import FitnessFn
    from repro_torch.core.strategies import plan_generations
    from repro_torch.launch import serve as launcher
    from repro_torch.models import layers as L
    from repro_torch.models.registry import (count_active_params,
                                             count_params, get_model)
    from repro_torch.serve.engine import MultiTenantEngine

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    tenants = launcher.build_tenants(LAUNCH_ARCHS, LAUNCH_SEED, device=dev,
                                     full=full)
    sync()
    out["build_s"] = time.perf_counter() - t0
    weight_bytes = {}
    for t in tenants:
        n = count_params(t.cfg)
        check(sum(p.numel() for p in t.model.parameters()) == n,
              f"{t.name}: parameter count")
        weight_bytes[t.name] = sum(p.numel() * p.element_size()
                                   for p in t.model.parameters())
        print(f"[launch] {t.name} ({t.cfg.family}): {t.cfg.num_layers} "
              f"layers, d_model {t.cfg.d_model}, {n:,} params in "
              f"{t.cfg.dtype} ({weight_bytes[t.name] / 1e9:.2f} GB)")
    qwen = dict((t.name, t) for t in tenants)["qwen2-moe-a2.7b"]
    active = count_active_params(qwen.cfg)
    check(not full or active == QWEN_ACTIVE_PARAMS,
          f"qwen2-moe-a2.7b: {active:,} active params, want "
          f"{QWEN_ACTIVE_PARAMS:,}")
    held = (torch.cuda.memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)
    print(f"[launch] built in {out['build_s']:.3f} s; qwen2-moe-a2.7b "
          f"active params {active:,}; device memory held {held:.2f} GiB")

    # the launcher's flow: every schedule's launches, every call's wall
    parts, walls = [], {t.name: {"prefill": [], "decode": []}
                        for t in tenants}
    plain_schedule = MultiTenantEngine.schedule

    def counted_schedule(self, jobs, method=None, **kw):
        before = mk.LAUNCHES["makespan"]
        res = plain_schedule(self, jobs, method=method, **kw)
        parts.append((method or self.method,
                      mk.LAUNCHES["makespan"] - before, res))
        return res

    def timed(fn, phase, name):
        def run(*args, **kwargs):
            sync()
            t1 = time.perf_counter()
            res = fn(*args, **kwargs)
            sync()
            walls[name][phase].append(time.perf_counter() - t1)
            return res
        return run

    for t in tenants:
        t.model.prefill = timed(t.model.prefill, "prefill", t.name)
        t.model.decode_step = timed(t.model.decode_step, "decode", t.name)
    MultiTenantEngine.schedule = counted_schedule
    try:
        mk.reset_launches()
        ssm.reset_launches()
        fa.reset_launches()
        t0 = time.perf_counter()
        res = launcher.run(tenants, requests=LAUNCH_REQUESTS, execute=True,
                           seed=LAUNCH_SEED, device=dev,
                           log_fn=lambda m: print(m.replace("[serve]",
                                                            "[launch]")))
        sync()
        out["run_wall_s"] = time.perf_counter() - t0
        counts = {"makespan": mk.LAUNCHES["makespan"],
                  "ssm_scan": ssm.LAUNCHES["ssm_scan"],
                  "flash_attention": fa.LAUNCHES["flash_attention"]}
    finally:
        MultiTenantEngine.schedule = plain_schedule
        for t in tenants:
            del t.model.prefill, t.model.decode_step
    jobs, engine = res["jobs"], res["engine"]
    uids = sorted(j.uid for j in jobs)
    generations = plan_generations(engine.budget, 100)[0]
    want_parts = [("magma", generations), ("herald_like", 1),
                  ("ai_mt_like", 1), ("magma", generations)]
    check([(m, n) for m, n, _ in parts] == want_parts,
          f"launch: schedules and their makespan launches "
          f"{[(m, n) for m, n, _ in parts]}, want {want_parts}")
    for method, _, sched in parts:
        check(sorted(u for q in sched["queues"] for u in q) == uids,
              f"launch: the {method} schedule does not place every job once")
    check(parts[-1][2] is res["executed"], "launch: the executed schedule "
                                           "is not the last one")
    # MAGMA went through the engine's stream service (a prepared scenario,
    # one row a batch): each MAGMA schedule carries its StreamResult and
    # equals a direct run_strategy with the engine's seed and budget; the
    # heuristics ran on the host (these launches are not the path's)
    from repro_torch.core.strategies import get_strategy, run_strategy
    direct = run_strategy(
        get_strategy("magma"), FitnessFn(parts[0][2]["table"],
                                         bw_sys=engine.system_bw,
                                         device=dev),
        budget=engine.budget, seed=engine.seed, device=dev)
    for method, _, sched in parts:
        sr = sched["stream"]
        if method != "magma":
            check(sr is None, f"launch: {method} went through the stream")
            continue
        check(sr is not None and sr.budget == engine.budget
              and not sr.memo_exact and sr.request.mix == "<prepared>",
              "launch: a MAGMA schedule did not go through the stream")
        check(same_result(sched["result"], direct),
              "launch: the streamed MAGMA schedule differs from a direct "
              "run_strategy")
    out["stream_schedules"] = [
        {"dispatch_to_done_s": sc["stream"].done_s - sc["stream"].dispatch_s,
         "latency_s": sc["stream"].latency_s}
        for m, _, sc in parts if m == "magma"]
    print(f"[launch] {sum(m == 'magma' for m, _, _ in parts)} MAGMA "
          "schedules through the engine's stream service, each bitwise a "
          "direct run_strategy; dispatch-to-done "
          + ", ".join(f"{x['dispatch_to_done_s'] * 1e3:.3f}"
                      for x in out["stream_schedules"]) + " ms")
    engine.close()
    prefills = [j for j in jobs if j.phase == "prefill"]
    layers = {t.name: t.cfg.num_layers for t in tenants}
    want_ssm = sum(layers[j.tenant] for j in prefills
                   if j.tenant == "falcon-mamba-7b") if full else 0
    want = {"makespan": sum(n for _, n in want_parts), "ssm_scan": want_ssm,
            "flash_attention": 0}
    check(counts == want, f"launch path launches {counts}, want {want}")
    decodes = {j.uid: j for j in jobs if j.phase == "decode"}
    check(sorted(res["outputs"]) == sorted(decodes),
          "launch: the outputs do not cover every decode window")
    for uid, toks in res["outputs"].items():
        vocab = engine.tenants[decodes[uid].tenant].cfg.vocab
        check(toks.shape == (1, decodes[uid].tokens)
              and bool(((toks >= 0) & (toks < vocab)).all()),
              f"launch: decode job {uid} gave {toks.shape} tokens")
    out.update(counts=counts, jobs=len(jobs),
               requests=[list(r) for r in res["requests"]],
               generated=sum(j.tokens for j in decodes.values()),
               schedules=[{"method": m, "makespan_launches": n,
                           "makespan_s": sc["makespan_s"],
                           "throughput_flops": sc["throughput_flops"],
                           "search_wall_s": sc["result"].wall_time_s}
                          for m, n, sc in parts])
    print(f"[launch] {len(res['requests'])} requests "
          f"{res['requests']}, {len(jobs)} jobs, "
          f"{out['generated']} generated tokens; launcher wall "
          f"{out['run_wall_s']:.3f} s; launches {counts}")

    # the makespan kernel at the launcher's shape, on one population of the
    # engine's own tables (these launches are not the path's)
    fit = FitnessFn(engine.analyze(jobs), bw_sys=engine.system_bw,
                    device=dev)
    pop = random_population(torch.Generator(device=dev).manual_seed(
        LAUNCH_SEED), 100, fit.group_size, fit.num_accels, dev)
    sched = decode(pop.accel, pop.prio, fit.num_accels)
    qlat, qbw = queue_tables(sched, fit.params.lat, fit.params.bw)
    qlat, qbw = qlat.contiguous(), qbw.contiguous()
    what = (f"launcher tables G={fit.group_size} A={fit.num_accels} "
            "P=100")
    got = mk.makespan(qlat, qbw, sched.count, fit.params.bw_sys)
    sync()
    out["makespan_check"] = compare(
        got, simulate_tables(qlat, qbw, sched.count, fit.params.bw_sys),
        what)
    print(f"[check] {what}: max abs {out['makespan_check'][0]:.3e} "
          f"max rel {out['makespan_check'][1]:.3e}")

    # each tenant's prefill and decode walls beside its HBM bound
    out["tenants"] = {}
    for t in tenants:
        w = walls[t.name]
        bound = weight_bytes[t.name] / HBM_BYTES_PER_S * 1e3
        row = {"prompts": [j.seq for j in prefills if j.tenant == t.name],
               "prefill_s": w["prefill"],
               "decode_ms_median": float(np.median(w["decode"])) * 1e3,
               "decode_ms_mean": float(np.mean(w["decode"])) * 1e3,
               "decoded": len(w["decode"]), "bound_ms": bound}
        if t.cfg.n_experts:
            row["routed_bound_ms"] = (count_active_params(t.cfg) * 2
                                      / HBM_BYTES_PER_S * 1e3)
        out["tenants"][t.name] = row
        print(f"[launch] {t.name}: prefill of "
              + ", ".join(f"{p} tokens {s * 1e3:.3f} ms"
                          for p, s in zip(row["prompts"], row["prefill_s"]))
              + f"; decode {row['decode_ms_median']:.3f} ms per token "
              f"(median of {row['decoded']}, mean {row['decode_ms_mean']:.3f})"
              f", HBM bound {bound:.3f} ms (weights once)"
              + (f", {row['routed_bound_ms']:.3f} ms for the routed experts "
                 "alone" if t.cfg.n_experts else ""))

    # the MoE prefills' tokens dropped over capacity, and the busiest
    # expert's share of a layer's (token, expert) pairs
    dropped, busiest = [0, 0], []
    plain_moe = L.moe

    def counting_moe(p, x, **kw):
        group = kw.get("group_tokens", False)
        xg = x.reshape(1, -1, x.shape[-1]) if group else x
        r = L.moe_routing(p, xg, n_experts=kw["n_experts"],
                          top_k=kw["top_k"],
                          capacity_factor=kw["capacity_factor"])
        dropped[0] += int((~r.keep).sum())
        dropped[1] += r.keep.numel()
        busiest.append(float(torch.bincount(r.top_e.reshape(-1)).max())
                       / r.keep.numel())
        return plain_moe(p, x, **kw)

    L.moe = counting_moe
    try:
        for j in prefills:
            if j.tenant == qwen.name:
                qwen.model.prefill({"tokens": torch.as_tensor(
                    np.asarray(res["prompts"][j.uid]), device=dev)}, j.seq)
    finally:
        L.moe = plain_moe
    out["moe_prefill_dropped_share"] = dropped[0] / dropped[1]
    out["moe_busiest_expert_share"] = [min(busiest), max(busiest)]
    print(f"[launch] qwen2-moe-a2.7b prefills: {dropped[0]} of {dropped[1]} "
          f"(token, expert) pairs dropped over capacity "
          f"({out['moe_prefill_dropped_share']:.4%}), capacity factor "
          f"{qwen.cfg.capacity_factor}; the busiest expert takes "
          f"{min(busiest):.2%}-{max(busiest):.2%} of a layer's pairs "
          f"(1/{qwen.cfg.n_experts} = {1 / qwen.cfg.n_experts:.2%} if "
          "balanced)")

    # the fixed decode probe, before any profiler session of the process
    probe_prompts = {}
    for t in tenants[:2]:
        first = next(j for j in prefills if j.tenant == t.name)
        probe_prompts[t.name] = torch.as_tensor(
            np.asarray(res["prompts"][first.uid]), device=dev)
        ms = decode_probe_ms(t.model, probe_prompts[t.name], dev)
        out["tenants"][t.name]["probe_ms"] = ms
        print(f"[launch] {t.name} decode probe ({first.seq}-token prompt, "
              f"median of {LAUNCH_PROBE_TOKENS} tokens) before any profiler "
              f"session: {ms:.3f} ms per token")

    # the reference's decode criterion: reported at full depth in bf16...
    out["decode_rel_full_depth"] = {}
    for t in tenants:
        if t.cfg.family not in ("dense", "moe"):
            continue
        cfg = t.model.cfg
        t.model.cfg = drop_free(cfg)
        rel, routes = decode_vs_forward(t.model, dev, seed=21)
        t.model.cfg = cfg
        out["decode_rel_full_depth"][t.name] = rel
        if routes is not None:
            out["decode_routes_full_depth"] = routes
        print(f"[launch] {t.name} full depth, {cfg.dtype}: decode vs "
              f"teacher-forced logits, max abs diff / max abs {rel:.3e} "
              f"(reported; the f32 limit is {DECODE_REL})"
              + routes_line(routes))
    del tenants, engine, res, parts, qwen
    free(dev)

    # ... and held at 4 layers in float32
    out["decode_rel_f32_4_layers"] = {}
    for arch in LAUNCH_ARCHS[:2]:
        base = get_config(arch) if full else get_smoke_config(arch)
        cfg = drop_free(base.replace(num_layers=4, dtype="float32"))
        model = get_model(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(7))
        rel, routes = decode_vs_forward(model, dev, seed=22)
        del model
        free(dev)
        out["decode_rel_f32_4_layers"][arch] = rel
        if routes is not None:
            out["decode_routes_f32_4_layers"] = routes
        check(rel < DECODE_REL, f"{arch} 4 layers f32: decode vs "
                                f"teacher-forced {rel:.3e}, limit "
                                f"{DECODE_REL}")
        print(f"[launch] {arch} full width, 4 layers, f32: decode vs "
              f"teacher-forced logits {rel:.3e} (limit {DECODE_REL})"
              + routes_line(routes))
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[launch] phase wall {out['phase_wall_s']:.3f} s")
    return out, probe_prompts


def launch_profile(dev, probe_prompts, launch_out):
    """The end of phase 14, after phase 13: granite-3-2b and
    qwen2-moe-a2.7b rebuilt as phase 14 built them, the decode probe read
    again on the same prompts (now after the profiler sessions of phases
    5, 8, 11 and 12) beside phase 14's reading, then one qwen2-moe decoded
    token under the profiler: the device's busy share and its top ops.
    Adds its readings to ``launch_out``."""
    import torch
    from repro_torch.launch import serve as launcher
    t_part = time.perf_counter()
    tenants = launcher.build_tenants(LAUNCH_ARCHS[:2], LAUNCH_SEED,
                                     device=dev, full=True)
    for t in tenants:
        ms = decode_probe_ms(t.model, probe_prompts[t.name], dev)
        row = launch_out["tenants"][t.name]
        row["probe_ms_after_profilers"] = ms
        print(f"[launch] {t.name} decode probe after the profiler sessions "
              f"of phases 5, 8, 11 and 12: {ms:.3f} ms per token (before "
              f"any: {row['probe_ms']:.3f})")
    qwen = tenants[1].model
    prompt = probe_prompts[tenants[1].name]
    seq = prompt.shape[1]
    with torch.no_grad():
        logits, cache = qwen.prefill({"tokens": prompt}, seq + 4)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for pos in range(seq, seq + 2):                 # warm-up tokens
            logits, cache = qwen.decode_step(cache, cur, pos)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        prof = device_profile(dev, lambda: qwen.decode_step(cache, cur,
                                                            seq + 2))
    launch_out["profile_qwen_token"] = prof
    if prof is None:
        print("[profile] the profiler saw no device time: device busy share "
              "not measured")
    else:
        print(f"[profile] one qwen2-moe-a2.7b decoded token: wall "
              f"{prof['wall_ms']:.3f} ms, device busy "
              f"{prof['device_busy_ms']:.3f} ms "
              f"({prof['device_busy_share']:.1%}) over {prof['device_ops']} "
              "device ops")
        for k, v in prof["top_kernels_ms"]:
            print(f"[profile]   {v:10.3f} ms  {k[:100]}")
    del tenants, qwen, cache, logits
    free(dev)
    launch_out["profile_part_wall_s"] = time.perf_counter() - t_part
    print(f"[launch] rebuilt probe and profile wall "
          f"{launch_out['profile_part_wall_s']:.3f} s")


def family_step_records(name, hist):
    """Print and return one record per training step of ``hist``."""
    records = []
    for h in hist:
        rec = dict(h, ms=h["wall_s"] * 1e3,
                   tokens_per_s=h["tokens"] / h["wall_s"])
        records.append(rec)
        peak = ("not measured" if h["peak_bytes"] is None
                else f"{h['peak_bytes'] / GB:.2f} GiB")
        print(f"[families] train {name} step {h['step']}: loss "
              f"{h['loss']:.6f} grad norm {h['grad_norm']:.6f} lr "
              f"{h['lr']:.3e} {rec['ms']:.3f} ms {rec['tokens_per_s']:.1f} "
              f"tokens/s peak {peak}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              and h["grad_norm"] > 0 for h in hist),
          f"{name} training: a loss or grad norm is not finite, or a grad "
          "norm is 0")
    return records


def family_loss(model, cfg, batch, ssm, fa):
    """``eval_loss`` with the scan's launches too: (loss, (scan, flash)
    launches, wall s)."""
    before = ssm.LAUNCHES["ssm_scan"]
    loss, flashes, wall = eval_loss(model, cfg, batch, fa)
    return loss, (ssm.LAUNCHES["ssm_scan"] - before, flashes), wall


def families_phase(dev, ssm, fa):
    """Phase 15: the SSM, hybrid and encoder-decoder families through the
    trainer and through evaluation with ``use_flash=True``.

    1. Training (bf16, random weights from a seeded generator, the
       launcher's TrainConfig, ``use_flash=False``: the kernels have no
       gradient, as in the reference): zamba2-1.2b and seamless-m4t-medium
       at full width and depth through ``repro_torch.launch.train.main``;
       falcon-mamba-7b at full width with 4 layers through
       ``train.loop.train``.  Full depth does not fit one card: 7.0 B bf16
       parameters and gradients plus f32 AdamW moments need ~84 GB before
       activations; it waits for the sharded trainer (ROADMAP Queue 1
       item 12).  Losses finite, grad norms non-zero, every weight matrix
       changed, no kernel launched.
    2. Evaluation under ``torch.no_grad()`` on ``batch_at(10_000)``:
       falcon-mamba-7b at full depth (one scan launch a layer), the
       trained zamba2 (one scan a Mamba layer, one flash launch an
       application of the shared block) and the trained seamless (no
       launch).  The path's counts are read here.
    3. Kernel route against plain route on the same weights: at full
       width in float32 with FAMILY_F32_LAYERS, within EVAL_F32_ATOL; at
       full depth in bf16 at FAMILY_PLAIN_SEQ tokens (the plain scan is a
       Python loop over time), reported.

    Returns (summary, the path's launches {"ssm_scan", "flash_attention"}
    after step 2)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import count_params, get_model
    from repro_torch.train.data import TokenStream
    from repro_torch.train.loop import train

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    out = {"train": {}, "eval": {}, "routes": {}}
    trained = {}

    def launches():
        return (ssm.LAUNCHES["ssm_scan"], fa.LAUNCHES["flash_attention"])

    # 1. train
    for arch, steps, B, S, layers in FAMILY_TRAIN:
        before = launches()
        t0 = time.perf_counter()
        if layers is None:
            model, _, hist = launch_train.main(
                ["--arch", arch, "--steps", str(steps), "--batch", str(B),
                 "--seq", str(S), "--device", str(dev), "--seed", "0"],
                log_fn=lambda *_: None)
            cfg = model.cfg
        else:
            cfg = get_config(arch).replace(num_layers=layers)
            model = get_model(cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(0))
            hist = []
            train(model, launch_train.train_config(steps),
                  TokenStream(cfg, B, S, seed=0), steps, log_every=0,
                  log_fn=lambda *_: None, history=hist)
        sync()
        wall = time.perf_counter() - t0
        check(launches() == before, f"{arch} training launched a kernel "
                                    "(it runs use_flash=False)")
        check(len(hist) == steps, f"{arch}: {len(hist)} training steps, want "
                                  f"{steps}")
        records = family_step_records(arch, hist)
        fresh = get_model(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        moved = [not torch.equal(p, f) for p, f in
                 zip(model.parameters(), fresh.parameters()) if p.dim() == 2]
        del fresh
        check(all(moved), f"{arch}: training changed {sum(moved)} of the "
                          f"{len(moved)} weight matrices, want all")
        n = count_params(cfg)
        out["train"][arch] = {"layers": cfg.num_layers, "params": n,
                              "B": B, "S": S, "steps": records,
                              "wall_s": wall}
        print(f"[families] train {arch}: {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {n:,} params in {cfg.dtype}; {steps} steps of "
              f"{B}x{S} tokens in {wall:.3f} s including init; "
              f"{len(moved)}/{len(moved)} weight matrices changed; scan and "
              "flash launches 0")
        if layers is None:
            trained[arch] = model
        del model, hist
        free(dev)

    # 2. evaluate through the kernels
    models = dict(trained)
    for arch, B, S in FAMILY_EVAL:
        if arch in models:
            model = models[arch]
            cfg = model.cfg
        else:
            cfg = get_config(arch)
            model = get_model(cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(2))
            models[arch] = model
        batch = eval_batch(dev, cfg, B, S)
        loss, (scans, flashes), wall = family_loss(
            model, cfg.replace(use_flash=True), batch, ssm, fa)
        model.cfg = cfg
        mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
        apps = model.n_apps if cfg.family == "hybrid" else 0
        check(np.isfinite(loss), f"{arch} eval: non-finite loss")
        check((scans, flashes) == (mamba, apps),
              f"{arch} eval: (scan, flash) launches {(scans, flashes)}, "
              f"want {(mamba, apps)}")
        out["eval"][arch] = {"params": count_params(cfg), "B": B, "S": S,
                             "loss": loss, "scan_launches": scans,
                             "flash_launches": flashes, "wall_s": wall}
        print(f"[families] eval {arch} full width and depth, bf16, B={B} "
              f"S={S}: loss {loss:.6f} with use_flash=True, {scans} scan "
              f"and {flashes} flash launches, {wall * 1e3:.3f} ms")
        del batch
    counts = {"ssm_scan": ssm.LAUNCHES["ssm_scan"],
              "flash_attention": fa.LAUNCHES["flash_attention"]}

    # 3. kernel route against plain route
    for arch, _, S in FAMILY_EVAL[:2]:
        model = models[arch]
        cfg = model.cfg
        batch = eval_batch(dev, cfg, 1, FAMILY_PLAIN_SEQ)
        lk, _, wk = family_loss(model, cfg.replace(use_flash=True), batch,
                                ssm, fa)
        lp, (plain_scans, plain_flashes), wp = family_loss(model, cfg, batch,
                                                           ssm, fa)
        check((plain_scans, plain_flashes) == (0, 0),
              f"{arch}: the plain route launched a kernel")
        out["routes"][arch + " bf16"] = {
            "layers": cfg.num_layers, "B": 1, "S": FAMILY_PLAIN_SEQ,
            "loss_kernel": lk, "loss_plain": lp, "abs_diff": abs(lk - lp),
            "kernel_wall_s": wk, "plain_wall_s": wp}
        print(f"[families] {arch} full depth, bf16, B=1 S={FAMILY_PLAIN_SEQ} "
              f"(both routes at this length, not the evaluation's {S}: the "
              f"plain scan is a Python loop over time): kernel route "
              f"{lk:.6f} ({wk * 1e3:.3f} ms), plain {lp:.6f} "
              f"({wp * 1e3:.3f} ms), |diff| {abs(lk - lp):.3e} (reported, "
              "not required)")
        del batch
    del models, trained, model
    free(dev)
    evals = {arch: (B, S) for arch, B, S in FAMILY_EVAL}
    for arch, layers in FAMILY_F32_LAYERS:
        cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
        model = get_model(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(3))
        B, S = evals[arch]
        batch = eval_batch(dev, cfg, B, S)
        lk, (scans, flashes), _ = family_loss(
            model, cfg.replace(use_flash=True), batch, ssm, fa)
        lp, plain_launched, _ = family_loss(model, cfg, batch, ssm, fa)
        diff = abs(lk - lp)
        want = (layers, model.n_apps if cfg.family == "hybrid" else 0)
        check((scans, flashes) == want and plain_launched == (0, 0)
              and diff <= EVAL_F32_ATOL,
              f"{arch} {layers} layers f32: kernel loss {lk} vs plain {lp} "
              f"(|diff| {diff}, tol {EVAL_F32_ATOL}; launches kernel route "
              f"{(scans, flashes)}, want {want}, plain {plain_launched})")
        out["routes"][f"{arch} f32 {layers} layers"] = {
            "layers": layers, "B": B, "S": S, "loss_kernel": lk,
            "loss_plain": lp, "abs_diff": diff}
        print(f"[families] {arch} full width, {layers} layers, f32, B={B} "
              f"S={S}: kernel route {lk:.7f} plain {lp:.7f} |diff| "
              f"{diff:.3e} (tol {EVAL_F32_ATOL})")
        del model, batch
        free(dev)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[families] phase wall {out['phase_wall_s']:.3f} s")
    return out, counts


def families_profile(dev, families_out):
    """The end of phase 15, after every other profiler session of the
    process: one zamba2-1.2b training step as phase 15 takes it (B=1,
    S=512, the launcher's schedule, after one warm step), then, with
    ``use_flash=True`` under ``torch.no_grad()``, one evaluation of the
    same model (B=4, S=2048) and one of falcon-mamba-7b at full depth
    (B=1, S=2048), each after a warm one, under torch.profiler: the wall,
    the device's busy share, its ops, the host's wall per device op, the
    top ops and the scan's and flash kernel's part.  Adds the readings to
    ``families_out["profile"]``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_config
    from repro_torch.models.registry import get_model
    from repro_torch.train.data import TokenStream
    from repro_torch.train.loop import init_state, make_train_step

    t_part = time.perf_counter()
    out = families_out["profile"] = {}
    parts = ("ssm_scan_kernel", "flash_fwd")

    def show(what, prof):
        out[what] = prof
        if prof is None:
            print(f"[profile] {what}: the profiler saw no device time: "
                  "device busy share not measured")
            return
        prof["host_us_per_device_op"] = (prof["wall_ms"] * 1e3
                                         / prof["device_ops"])
        print(f"[profile] {what}: wall {prof['wall_ms']:.3f} ms, device "
              f"busy {prof['device_busy_ms']:.3f} ms "
              f"({prof['device_busy_share']:.1%}) over "
              f"{prof['device_ops']} device ops, "
              f"{prof['host_us_per_device_op']:.2f} us of wall a device op")
        for part, v in prof["parts"].items():
            print(f"[profile]   {part}: {v['ops']} launches, "
                  f"{v['ms']:.3f} ms ({v['ms'] / prof['wall_ms']:.1%} of "
                  "the wall)")
        for k, v in prof["top_kernels_ms"]:
            print(f"[profile]   {v:10.3f} ms  {k[:100]}")

    arch, steps, B, S, _ = FAMILY_TRAIN[0]
    cfg = get_config(arch)
    model = get_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    stream = TokenStream(cfg, B, S, seed=0)
    step = make_train_step(model, train_config(steps))
    state, _ = step(init_state(model), stream.batch_at(0))
    batch = stream.batch_at(1)
    show(f"train {arch} B={B} S={S}",
         device_profile(dev, lambda: step(state, batch), parts=parts))
    del state, step, batch
    free(dev)
    models = {arch: model}
    for arch, B, S in FAMILY_EVAL[:2]:
        if arch not in models:
            models[arch] = get_model(get_config(arch), device=dev,
                                     generator=torch.Generator(
                                         device=dev).manual_seed(2))
        model = models[arch]
        cfg = model.cfg
        batch = eval_batch(dev, cfg, B, S)
        model.cfg = cfg.replace(use_flash=True)
        with torch.no_grad():
            model.loss(batch)
            show(f"eval {arch} B={B} S={S}",
                 device_profile(dev, lambda: model.loss(batch), parts=parts))
        model.cfg = cfg
        del batch
    del models, model
    free(dev)
    out["part_wall_s"] = time.perf_counter() - t_part
    print(f"[families] profile wall {out['part_wall_s']:.3f} s")


def stream_phase(dev, mk, budget=STREAM_BUDGET, anytime=STREAM_ANYTIME,
                 trace_kw=None):
    """Phase 16: the streaming scheduling service (``repro_torch.stream``)
    on ``dev``, at STREAM_TRACE's full width unless ``trace_kw`` cuts it.

    (a) Pipelining: the trace through one warmed-up service
        (batch_rows=8, two analysis workers, max_inflight=2) three ways:
        ``run_serial`` with a fresh analyzer per scenario, with the shared
        profile cache, and ``run`` (the pipeline); per mode scenarios/s,
        the device's idle share, latency p50 / p99, batches and fill, and
        each batch's host issue time beside its dispatch-to-done window.
        Every pipelined row must equal bitwise its serial twins and a
        standalone ``run_strategy`` on ``dev`` with its seed and budget.
    (b) SLO admission and anytime rows (benchmarks/perf_stream.py:182-300,
        one rep): a bursty trace on S2 whose deadlines are scaled by a
        priority-blind probe's p50 latency (urgent 1x, normal 2x, batch
        none), run priority-blind and SLO-aware (anytime at ``anytime``
        samples, ``ScheduleMemo(near=False)``), both single-buffered.
        Urgent p99 and attainment of both are printed; every aware row
        must equal bitwise a standalone search at the budget it reports,
        every interim's refinement in the memo one at the full budget,
        and each run's admission counters must balance.

    Every warmup and run is checked for its makespan launches (one per
    generation and batch).  Returns the phase's summary; its "launches"
    is the makespan launches the phase must have made: the warmups', the
    runs' batches' and the standalone checks'."""
    from repro_torch.core.fitness import FitnessFn
    from repro_torch.core.strategies import (get_strategy, plan_generations,
                                             run_strategy)
    from repro_torch.costmodel import get_setting
    from repro_torch.memo import ScheduleMemo
    from repro_torch.stream import (StreamConfig, StreamingScheduler,
                                    TraceConfig, analyze_serial,
                                    generate_trace)

    trace_kw = dict(STREAM_TRACE if trace_kw is None else trace_kw)
    t_phase = time.perf_counter()
    strat = get_strategy("magma")
    out = {"trace": dict(trace_kw), "budget": budget,
           "anytime_budget": anytime}
    expected = [0]

    def gens(b):
        return plan_generations(b, strat.ask_size)[0]

    def counted(what, fn, want):
        """Run ``fn``; its makespan launches must be ``want(result)``."""
        before = mk.LAUNCHES["makespan"]
        res = fn()
        launched = mk.LAUNCHES["makespan"] - before
        n = want(res)
        check(launched == n, f"stream: {what} launched the makespan kernel "
                             f"{launched} times, want {n}")
        expected[0] += launched
        return res

    def batch_launches(svc):
        return sum(gens(b.compat_key.budget) for b in svc.last_batches)

    def warmup_launches(svc, trace):
        """One dispatch per (compatibility key, bucket): the keys are the
        trace's (G, A, budget) signatures (an anytime interim's too), twice
        with a memo (cold and warm-input rows)."""
        sigs = set()
        for r in trace:
            A = get_setting(r.setting).num_sub_accels
            full = r.budget or svc.budget
            sigs.add((r.group_size, A, full))
            a = svc.stream.anytime_budget
            if a is not None and r.deadline_s is not None and a < full:
                sigs.add((r.group_size, A, a))
        buckets, b = 1, 1
        while b < svc.stream.batch_rows:
            b *= 2
            buckets += 1
        return ((2 if svc.memo is not None else 1) * buckets
                * sum(gens(bud) for _, _, bud in sigs))

    def warm(svc, trace, what):
        t0 = time.perf_counter()
        counted(f"{what} warmup", lambda: svc.warmup(trace),
                lambda _: warmup_launches(svc, trace))
        return time.perf_counter() - t0

    def card_fit(fit):
        return FitnessFn(fit.table, bw_sys=fit.bw_sys, objective=fit.objective,
                         device=dev)

    def summary(svc, mode):
        m = svc.last_metrics
        row = {k: getattr(m, k) for k in (
            "num_scenarios", "wall_s", "scenarios_per_sec", "latency_p50_s",
            "latency_p99_s", "device_busy_s", "device_idle_frac",
            "analysis_busy_s", "num_batches", "mean_batch_fill")}
        row["batches"] = [{"rows": b.rows, "padded_rows": b.padded_rows,
                           "budget": b.compat_key.budget,
                           "issue_s": b.issued_s - b.dispatch_s,
                           "window_s": b.done_s - b.dispatch_s}
                          for b in svc.last_batches]
        print(f"[stream] {mode}: {m.num_scenarios} scenarios in "
              f"{m.wall_s:.3f} s, {m.scenarios_per_sec:.3f} scenarios/s, "
              f"device idle {m.device_idle_frac:.4f}, latency p50 "
              f"{m.latency_p50_s:.3f} s p99 {m.latency_p99_s:.3f} s, "
              f"{m.num_batches} batches, fill {m.mean_batch_fill:.3f}")
        print(f"[stream] {mode} batches, rows: host issue / dispatch-to-done "
              "ms: " + ", ".join(f"{b['rows']}: {b['issue_s'] * 1e3:.1f} / "
                                 f"{b['window_s'] * 1e3:.1f}"
                                 for b in row["batches"]))
        return row

    def admission_balances(svc, n, what):
        q = svc.last_admission
        check(q.enqueued == q.dispatched + q.stolen + q.depth
              and q.depth == 0 and q.enqueued >= n,
              f"stream: {what} admission counters enqueued {q.enqueued}, "
              f"dispatched {q.dispatched}, stolen {q.stolen}, depth "
              f"{q.depth}")

    # (a) pipelining
    trace = generate_trace(TraceConfig(**trace_kw))
    svc = StreamingScheduler(budget=budget, device=dev,
                             stream=StreamConfig(batch_rows=8,
                                                 analysis_workers=2,
                                                 max_inflight=2))
    out["warmup_s"] = warm(svc, trace, "pipelining")
    runs, modes = {}, {}
    for mode, shared in (("serial", False), ("serial_shared", True),
                         ("pipelined", None)):
        svc.pool.reset()         # every mode starts with cold caches
        fn = ((lambda: svc.run(trace)) if shared is None else
              (lambda sh=shared: svc.run_serial(trace, shared_cache=sh)))
        runs[mode] = counted(mode, fn, lambda _: batch_launches(svc))
        modes[mode] = summary(svc, mode)
        check([r.request.uid for r in runs[mode]]
              == sorted(r.uid for r in trace)
              and all(np.isfinite(r.best_fitness) and r.n_samples == budget
                      for r in runs[mode]),
              f"stream: {mode} does not route every scenario once")
    admission_balances(svc, len(trace), "pipelined")
    for mode in ("serial_shared", "pipelined"):
        for a, b in zip(runs[mode], runs["serial"]):
            check(same_result(a, b), f"stream: {mode} row {a.request.uid} "
                                     "differs from its serial twin")
    piped = runs["pipelined"]
    for r, rd in zip(piped, analyze_serial([r.request for r in piped],
                                           pool=svc.pool)):
        ref = counted("a standalone check", lambda: run_strategy(
            strat, card_fit(rd.fit), budget=budget, seed=r.request.seed,
            device=dev), lambda _: gens(budget))
        check(same_result(r, ref), f"stream: row {r.request.uid} differs "
                                   "from its standalone run_strategy")
    print(f"[stream] all {len(piped)} pipelined rows bitwise equal to their "
          "two serial twins and to standalone run_strategy on the card")
    out["pipelining"] = modes
    out["pipelined_over_serial"] = (modes["pipelined"]["scenarios_per_sec"]
                                    / modes["serial"]["scenarios_per_sec"])
    out["pipelined_over_serial_shared"] = (
        modes["pipelined"]["scenarios_per_sec"]
        / modes["serial_shared"]["scenarios_per_sec"])
    print(f"[stream] pipelined / serial throughput "
          f"{out['pipelined_over_serial']:.3f}, / serial with the shared "
          f"cache {out['pipelined_over_serial_shared']:.3f}")
    svc.close()

    # (b) SLO admission and anytime rows
    slo_kw = dict(trace_kw, arrival="bursty", burst_size=8.0,
                  settings=("S2",))
    cfg = dict(batch_rows=8, analysis_workers=2, max_inflight=1)
    probe_trace = generate_trace(TraceConfig(**slo_kw))
    probe = StreamingScheduler(budget=budget, device=dev,
                               stream=StreamConfig(slo_aware=False, **cfg))
    warm(probe, probe_trace, "probe")
    counted("the probe", lambda: probe.run(probe_trace),
            lambda _: batch_launches(probe))
    scale = probe.last_metrics.latency_p50_s
    probe.close()
    slo = (("urgent", 1.0 * scale), ("normal", 2.0 * scale))
    trace_b = generate_trace(TraceConfig(priorities=STREAM_PRIORITIES,
                                         slo_by_class=slo, **slo_kw))
    blind = StreamingScheduler(budget=budget, device=dev,
                               stream=StreamConfig(slo_aware=False, **cfg))
    aware = StreamingScheduler(
        budget=budget, device=dev, memo=ScheduleMemo(near=False),
        stream=StreamConfig(anytime_budget=anytime, slo_margin_s=scale,
                            **cfg))
    warm(blind, trace_b, "blind")
    warm(aware, trace_b, "aware")
    blind.pool.reset()
    aware.pool.reset()
    sides = {}
    for tag, side in (("blind", blind), ("aware", aware)):
        res = counted(tag, lambda sv=side: sv.run(trace_b),
                      lambda _, sv=side: batch_launches(sv))
        admission_balances(side, len(trace_b), tag)
        m = side.last_metrics
        sides[tag] = dict(summary(side, f"slo {tag}"),
                          latency_p99_urgent_s=m.latency_p99_urgent_s,
                          slo_attainment=m.slo_attainment,
                          deadline_misses=m.deadline_misses,
                          num_with_deadline=m.num_with_deadline,
                          anytime_interims=m.anytime_interims,
                          anytime_refinements=m.anytime_refinements,
                          early_flushes=m.early_flushes)
        print(f"[stream] slo {tag}: urgent p99 "
              f"{m.latency_p99_urgent_s:.3f} s, attainment "
              f"{m.slo_attainment:.4f} ({m.deadline_misses} of "
              f"{m.num_with_deadline} missed), interims "
              f"{m.anytime_interims}, refinements {m.anytime_refinements}, "
              f"early flushes {m.early_flushes}")
        if tag == "aware":
            aware_results = res
    ready = {rd.request.uid: rd for rd in analyze_serial(
        [r.request for r in aware_results], pool=aware.pool)}
    n_interim = 0
    for r in aware_results:
        fit = card_fit(ready[r.request.uid].fit)
        ref = counted("a standalone check", lambda: run_strategy(
            strat, fit, budget=r.budget, seed=r.request.seed, device=dev),
            lambda _: gens(r.budget))
        check(same_result(r, ref), f"stream: aware row {r.request.uid} "
                                   f"differs from a standalone search at "
                                   f"its budget {r.budget}")
        if r.anytime_interim:
            n_interim += 1
            hit = aware.memo.lookup(fit, strat, budget, r.request.seed)
            full = counted("a standalone check", lambda: run_strategy(
                strat, fit, budget=budget, seed=r.request.seed, device=dev),
                lambda _: gens(budget))
            check(hit is not None and same_result(hit, full),
                  f"stream: the refinement of {r.request.uid} in the memo "
                  "differs from a standalone full-budget search")
    check(n_interim == sides["aware"]["anytime_interims"]
          == sides["aware"]["anytime_refinements"],
          "stream: anytime interims and refinements do not pair up")
    print(f"[stream] all {len(aware_results)} aware rows bitwise equal to "
          f"standalone searches at their budgets ({n_interim} interims at "
          f"{anytime} samples, their {n_interim} refinements in the memo "
          f"at {budget})")
    out["slo"] = {"probe_p50_s": scale, "deadlines_s": dict(slo),
                  "blind": sides["blind"], "aware": sides["aware"]}
    blind.close()
    aware.close()
    out["launches"] = expected[0]
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[stream] phase wall {out['phase_wall_s']:.3f} s, makespan "
          f"launches {out['launches']}")
    return out


def fleet_phase(dev, mk, budget=STREAM_BUDGET, trace_kw=None,
                workers=FLEET_WORKERS, skew_kw=None):
    """Phase 17: the scheduling fleet (``repro_torch.fleet``) on the card.

    Phase 16's trace generator at FLEET_SCENARIOS scenarios (``trace_kw``
    cuts it) through a fleet of each size in ``workers``, all on ``dev``'s
    card (a worker is its own interpreter with its own CUDA context; the
    card time-slices between them), and through one in-process
    ``StreamingScheduler`` beside them.  Every side gets a fresh shared
    ``ShardedMemoStore`` (near hits off), the service's exhaustive
    ``warmup`` over the trace and a run of a disjoint-seed twin of it
    before the measured run; each fleet arms ``RecompileGuard`` in its
    workers and marks the boundary after its warmups.  Reported per side:
    scenarios/s, latency p50 / p99, steals, and each worker's makespan
    launches.  Gates:

    * every row of the 2-worker fleet is bitwise the standalone
      ``run_strategy`` on the card for its (scenario, seed), and equal to
      the in-process stream's;
    * ``benchmarks/perf_fleet.py:19-27``'s replay gate on FLEET_SKEW (one
      signature, so the first dispatch round steals): a steal-free rerun
      through the same 2-worker fleet replays every row from the shared
      store with at least one cross-worker exact hit (``foreign_hits``),
      every array bitwise run 1's, and run 1's rows bitwise standalone;
    * every worker's makespan launches equal one per generation and batch
      it dispatched (warmups included), and no worker built anything after
      its warmup boundary;
    * ``MultiTenantEngine(fleet=)`` schedules a launcher-style job group
      (FLEET_ENGINE_REQUESTS over the published configs on ``meta``)
      bitwise as the in-process engine does.

    Returns the phase's summary: "launches_workers" (every fleet worker's
    makespan launches, summed), "launches_parent" (this process's, which
    must equal the in-process stream's, the standalone checks' and the
    in-process engine's generations)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core.fitness import FitnessFn
    from repro_torch.core.strategies import (get_strategy, plan_generations,
                                             run_strategy)
    from repro_torch.fleet import FleetConfig, ShardedMemoStore, launch_fleet
    from repro_torch.memo import ScheduleMemo
    from repro_torch.stream import (StreamConfig, StreamingScheduler,
                                    TraceConfig, analyze_serial,
                                    generate_trace)

    t_phase = time.perf_counter()
    trace_kw = (dict(STREAM_TRACE, num_scenarios=FLEET_SCENARIOS)
                if trace_kw is None else dict(trace_kw))
    skew_kw = dict(FLEET_SKEW if skew_kw is None else skew_kw)
    trace = generate_trace(TraceConfig(**trace_kw))
    twin = generate_trace(TraceConfig(**dict(trace_kw,
                                             seed=trace_kw["seed"] + 1000)))
    skew = generate_trace(TraceConfig(**skew_kw))
    stream_kw = dict(batch_rows=8, analysis_workers=2, max_inflight=2)
    strat = get_strategy("magma")
    gens = plan_generations(budget, strat.ask_size)[0]
    parent = [0]                     # makespan launches this process owes
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fleet_phase_", dir=build)
    out = {"trace": trace_kw, "skew_trace": skew_kw, "budget": budget,
           "stream": stream_kw, "fleets": {}}

    def side_row(m, wall_what):
        row = {k: getattr(m, k) for k in (
            "num_scenarios", "wall_s", "scenarios_per_sec", "latency_p50_s",
            "latency_p99_s")}
        print(f"[fleet] {wall_what}: {m.num_scenarios} scenarios in "
              f"{m.wall_s:.3f} s, {m.scenarios_per_sec:.3f} scenarios/s, "
              f"latency p50 {m.latency_p50_s:.3f} s p99 "
              f"{m.latency_p99_s:.3f} s")
        return row

    def standalone(r):
        fit = analyze_serial([r.request])[0].fit
        parent[0] += gens
        return run_strategy(strat, FitnessFn(fit.table, bw_sys=fit.bw_sys,
                                             objective=fit.objective,
                                             device=dev),
                            budget=budget, seed=r.request.seed, device=dev)

    try:
        # the in-process stream beside the fleets
        svc = StreamingScheduler(
            budget=budget, device=dev, stream=StreamConfig(**stream_kw),
            memo=ScheduleMemo(ShardedMemoStore(os.path.join(tmp, "inproc")),
                              near=False))
        svc.warmup(trace)
        svc.run(twin)
        local = svc.run(trace)
        out["in_process"] = side_row(svc.last_metrics, "in-process stream")
        parent[0] += svc.dispatched_generations
        svc.close()

        worker_launches = 0
        for n in workers:
            cfg = FleetConfig(num_workers=n, budget=budget, device="cuda"
                              if dev.type == "cuda" else "cpu",
                              stream=stream_kw, chunk_rows=8,
                              max_outstanding=2,
                              memo_path=os.path.join(tmp, f"fleet{n}"),
                              recompile_guard=True, ready_timeout_s=300.0)
            t0 = time.perf_counter()
            with launch_fleet(cfg) as fleet:
                up_s = time.perf_counter() - t0
                fleet.warmup(trace)
                fleet.run(twin)
                fleet.mark_warm()
                before = fleet.worker_stats()
                res = fleet.run(trace)
                m = fleet.last_metrics
                row = side_row(m, f"{n}-worker fleet")
                measured = after = fleet.worker_stats()
                check([r.request.uid for r in res]
                      == sorted(t.uid for t in trace),
                      f"fleet: the {n}-worker fleet does not route every "
                      "scenario once")
                row.update(startup_s=up_s, steals=m.steals,
                           stolen_members=m.stolen_members,
                           per_worker_scenarios=list(m.per_worker_scenarios))
                if n == 2:
                    out["gates"] = fleet_gates(dev, fleet, res, local, skew,
                                               standalone, budget)
                    out["engine"] = fleet_engine_gate(dev, fleet)
                    parent[0] += out["engine"]["in_process_generations"]
                    after = fleet.worker_stats()
            row["workers"] = {}
            for wid in sorted(after):
                a, b, c = after[wid], before[wid], measured[wid]
                # on the CPU the plain version runs: no kernel launch
                check(a["makespan_launches"] == (
                    a["dispatched_generations"] if dev.type == "cuda"
                    else 0) and a["dispatched_generations"] > 0,
                      f"fleet: {n}-worker {wid} launched the makespan kernel "
                      f"{a['makespan_launches']} times over "
                      f"{a['dispatched_generations']} generations x batches")
                check(a["recompiles_post_warmup"] == 0,
                      f"fleet: {n}-worker {wid} built "
                      f"{a['recompiles_post_warmup']} libraries after its "
                      "warmup")
                worker_launches += a["makespan_launches"]
                row["workers"][wid] = {
                    "makespan_launches": a["makespan_launches"],
                    "measured_run_launches": (c["makespan_launches"]
                                              - b["makespan_launches"]),
                    "scenarios_measured": c["scenarios"] - b["scenarios"],
                    "compiles": a["compiles"]}
            print(f"[fleet] {n}-worker: steals {m.steals} "
                  f"({m.stolen_members} members), per worker "
                  f"{list(m.per_worker_scenarios)}, startup {up_s:.2f} s, "
                  "makespan launches (lifetime / measured run) "
                  + ", ".join(f"{w}: {v['makespan_launches']} / "
                              f"{v['measured_run_launches']}"
                              for w, v in row["workers"].items()))
            out["fleets"][n] = row
        one = out["fleets"][workers[0]]["scenarios_per_sec"]
        out["scaling"] = {n: out["fleets"][n]["scenarios_per_sec"] / one
                          for n in workers}
        out["fleet_over_in_process"] = {
            n: out["fleets"][n]["scenarios_per_sec"]
            / out["in_process"]["scenarios_per_sec"] for n in workers}
        print("[fleet] scenarios/s over the 1-worker fleet: "
              + ", ".join(f"{n}: {v:.3f}" for n, v in out["scaling"].items())
              + "; over the in-process stream: "
              + ", ".join(f"{n}: {v:.3f}" for n, v in
                          out["fleet_over_in_process"].items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(mk.LAUNCHES["makespan"] == parent[0],
          f"fleet: this process launched the makespan kernel "
          f"{mk.LAUNCHES['makespan']} times, want {parent[0]}")
    out["launches_workers"] = worker_launches
    out["launches_parent"] = parent[0]
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[fleet] phase wall {out['phase_wall_s']:.3f} s, makespan "
          f"launches: workers {worker_launches}, this process {parent[0]}")
    return out


def fleet_gates(dev, fleet, res, local, skew, standalone, budget):
    """Phase 17's row and memo-replay gates on the 2-worker fleet (see
    ``fleet_phase``)."""
    for r, want in zip(res, local):
        check(r.request.uid == want.request.uid and same_result(r, want),
              f"fleet: row {r.request.uid} differs from the in-process "
              "stream's")
        check(same_result(r, standalone(r)), f"fleet: row {r.request.uid} "
                                             "differs from its standalone "
                                             "run_strategy")
    print(f"[fleet] all {len(res)} 2-worker rows bitwise equal to "
          "standalone run_strategy on the card and to the in-process stream")
    run1 = fleet.run(skew)
    m1 = fleet.last_metrics
    run2 = fleet.run(skew, steal=False)
    m2 = fleet.last_metrics
    check(m1.steals >= 1, "fleet: the skewed trace's first run did not "
                          "steal")
    for a, b in zip(run1, run2):
        check(same_result(a, b) and b.memo_exact,
              f"fleet: replayed row {a.request.uid} is not run 1's exact "
              "hit")
        check(same_result(a, standalone(a)), f"fleet: skewed row "
                                             f"{a.request.uid} differs from "
                                             "its standalone run_strategy")
    check(m2.memo_foreign_hits >= 1 and m2.memo_exact_hits == len(skew),
          f"fleet: the steal-free replay hit {m2.memo_exact_hits} of "
          f"{len(skew)} rows, {m2.memo_foreign_hits} of them cross-worker")
    print(f"[fleet] replay gate: run 1 stole {m1.stolen_members} of "
          f"{len(skew)} rows ({m1.steals} steals); the steal-free rerun "
          f"replayed {m2.memo_exact_hits} exact hits, "
          f"{m2.memo_foreign_hits} cross-worker, every array bitwise run "
          "1's and standalone")
    return {"rows_bitwise": len(res), "skew_steals": m1.steals,
            "skew_stolen_members": m1.stolen_members,
            "replay_exact_hits": m2.memo_exact_hits,
            "replay_foreign_hits": m2.memo_foreign_hits,
            "cross_worker_hit_rate": m2.cross_worker_hit_rate,
            "replay_wall_s": m2.wall_s}


def fleet_engine_gate(dev, fleet):
    """Phase 17's engine gate: one launcher-style job group scheduled by
    MAGMA through ``MultiTenantEngine(fleet=)`` and in process, on the
    published configs (weights on ``meta``: nothing executes)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import MultiTenantEngine, Tenant
    tenants = [Tenant(a, get_config(a), get_model(get_config(a),
                                                  device="meta"))
               for a in dict.fromkeys(r[0] for r in FLEET_ENGINE_REQUESTS)]
    via, here = (MultiTenantEngine(tenants, device=dev, fleet=fleet),
                 MultiTenantEngine(tenants, device=dev))
    a = via.schedule(via.jobs_for_requests(FLEET_ENGINE_REQUESTS))
    b = here.schedule(here.jobs_for_requests(FLEET_ENGINE_REQUESTS))
    check(same_result(a["result"], b["result"])
          and a["queues"] == b["queues"] and via._stream is None,
          "fleet: the engine's fleet= schedule differs from its in-process "
          "schedule")
    gens = here.stream_service().dispatched_generations
    here.close()
    print(f"[fleet] engine: fleet= schedule of {len(a['queues'])} queues "
          f"({sum(map(len, a['queues']))} jobs, served by "
          f"{a['stream'].worker_id}) bitwise the in-process schedule")
    return {"jobs": sum(map(len, a["queues"])),
            "worker": a["stream"].worker_id, "in_process_generations": gens}


def stream_card_busy(dev, budget=STREAM_BUDGET, trace_kw=None):
    """The card's own busy share over one pipelined phase 16 run, beside
    the stream's ``device_idle_frac`` (which counts a batch's host issue
    as busy: its window opens before the first launch).  Phase 16's
    service and trace, warmed up; one unprofiled pipelined run, then one
    under torch.profiler: the union of its CUDA kernel intervals over
    that run's wall.  Taken at the script's end: one
    profiler session slows every later host-bound phase."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile
    from repro_torch.stream import (StreamConfig, StreamingScheduler,
                                    TraceConfig, generate_trace,
                                    interval_union_s)

    trace = generate_trace(TraceConfig(**(STREAM_TRACE if trace_kw is None
                                          else trace_kw)))
    svc = StreamingScheduler(budget=budget, device=dev,
                             stream=StreamConfig(batch_rows=8,
                                                 analysis_workers=2,
                                                 max_inflight=2))
    svc.warmup(trace)
    svc.pool.reset()
    svc.run(trace)
    plain = svc.last_metrics
    svc.pool.reset()
    with profile(activities=profiler_activities(dev)) as prof:
        svc.run(trace)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    m = svc.last_metrics
    svc.close()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"wall_s": m.wall_s, "device_idle_frac": m.device_idle_frac,
           "unprofiled_wall_s": plain.wall_s,
           "unprofiled_device_idle_frac": plain.device_idle_frac,
           "device_ops": len(on_card)}
    if not on_card:
        print("[stream] card busy share: the profiler saw no device time: "
              "not measured")
        out["card_busy_share"] = None
        return out
    busy_s = interval_union_s([(e.time_range.start, e.time_range.end)
                               for e in on_card]) / 1e6
    out.update(card_busy_s=busy_s, card_busy_share=busy_s / m.wall_s)
    print(f"[stream] card busy share of a pipelined run: {busy_s:.4f} s of "
          f"{m.wall_s:.3f} s = {out['card_busy_share']:.4f} over "
          f"{len(on_card)} device ops (device_idle_frac "
          f"{m.device_idle_frac:.4f}, i.e. windows busy "
          f"{1 - m.device_idle_frac:.4f}; unprofiled run "
          f"{plain.wall_s:.3f} s, device_idle_frac "
          f"{plain.device_idle_frac:.4f})")
    return out


def stream_reps(dev, reps=STREAM_AB_REPS, budget=STREAM_BUDGET,
                trace_kw=None):
    """Phase 16's serial (a fresh analyzer per scenario) and pipelined
    runs, ``reps`` times each in alternating order, through one warmed-up
    service on ``dev``: each run's scenarios/s, latency p50 / p99, batch
    count and the most any batch's window ran past its host issue, and
    the medians.  Uses only ``repro_torch.stream``'s public API, so it
    measures any checkout that has the stream (``--stream-ab``)."""
    from repro_torch.stream import (StreamConfig, StreamingScheduler,
                                    TraceConfig, generate_trace)
    trace = generate_trace(TraceConfig(**(STREAM_TRACE if trace_kw is None
                                          else trace_kw)))
    svc = StreamingScheduler(budget=budget, device=dev,
                             stream=StreamConfig(batch_rows=8,
                                                 analysis_workers=2,
                                                 max_inflight=2))
    svc.warmup(trace)
    runs = {"serial": [], "pipelined": []}
    for i in range(reps):
        for mode in (("serial", "pipelined") if i % 2 == 0
                     else ("pipelined", "serial")):
            svc.pool.reset()             # every run starts with cold caches
            if mode == "serial":
                svc.run_serial(trace)
            else:
                svc.run(trace)
            m = svc.last_metrics
            runs[mode].append({
                "scenarios_per_sec": m.scenarios_per_sec,
                "latency_p50_s": m.latency_p50_s,
                "latency_p99_s": m.latency_p99_s,
                "num_batches": m.num_batches,
                "window_past_issue_ms": 1e3 * max(
                    b.done_s - b.issued_s for b in svc.last_batches)})
    svc.close()
    out = dict(runs, ratios=[p["scenarios_per_sec"] / s["scenarios_per_sec"]
                             for s, p in zip(runs["serial"],
                                             runs["pipelined"])])
    out["median"] = {mode: {k: float(np.median([r[k] for r in rs]))
                            for k in rs[0]} for mode, rs in runs.items()}
    out["median"]["ratio"] = float(np.median(out["ratios"]))
    return out


def stream_ab(roots):
    """``python3 chip_smoke.py --stream-ab ROOT [ROOT ...]``: for each
    checkout ROOT in the order given, one process that builds ROOT's
    makespan kernel and runs :func:`stream_reps` (this file's measuring
    code over ROOT's ``repro_torch``), then one JSON line with every run
    and the medians.  Holds two versions of the stream on one card in one
    call (for example the parent commit from ``git archive`` under
    ``build/``, then this checkout, this checkout, the parent)."""
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    child = (
        "import json, os, sys\n"
        "import torch\n"
        "root, here = os.path.abspath(sys.argv[1]), sys.argv[2]\n"
        "sys.path[:0] = [here, os.path.join(root, 'src')]\n"
        "import chip_smoke\n"
        "from repro_torch.kernels import _build\n"
        "_build.load('makespan')\n"
        "out = chip_smoke.stream_reps(torch.device('cuda', 0))\n"
        "print('[stream-ab] ' + json.dumps(dict(root=root, **out)))\n")
    runs = []
    print(f"[device] {smi_line()}")
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", child, root, ROOT],
                              capture_output=True, text=True, check=False)
        print(proc.stderr[-4000:], end="", file=sys.stderr)
        check(proc.returncode == 0, f"the stream runs of {root} failed")
        runs += [json.loads(line[len("[stream-ab] "):])
                 for line in proc.stdout.splitlines()
                 if line.startswith("[stream-ab] ")]
        r, med = runs[-1], runs[-1]["median"]
        print(f"[stream-ab] {r['root']}: pipelined / serial "
              + " ".join(f"{x:.4f}" for x in r["ratios"])
              + f" (median {med['ratio']:.4f}); medians: serial "
              f"{med['serial']['scenarios_per_sec']:.3f} scenarios/s, p50 "
              f"{med['serial']['latency_p50_s']:.4f} s; pipelined "
              f"{med['pipelined']['scenarios_per_sec']:.3f} scenarios/s, p50 "
              f"{med['pipelined']['latency_p50_s']:.4f} s, windows up to "
              f"{med['pipelined']['window_past_issue_ms']:.2f} ms past "
              "their issue")
    print(json.dumps({"stream_ab": runs}))
    return 0


def families_timing(ssm, fa, flash_ref, scan_inputs, flash_inputs_z):
    """Phase 15's timing: the scan kernel at both evaluation shapes and
    the flash kernel at zamba2's shared block, each as device time (a CUDA
    graph replayed) and as issued from the host (CUDA events), beside its
    plain version, its bound and (flash) torch's SDPA."""
    from repro_torch.kernels._variants import graph_ms
    from repro_torch.kernels.ref import ssm_scan_ref
    out = {}
    for key, args in scan_inputs.items():
        Bt, L, D = args[0].shape
        N = args[2].shape[1]
        k_ms = graph_ms(lambda: ssm.ssm_scan(*args), 10)
        h_ms = time_cuda(lambda: ssm.ssm_scan(*args), 20, 3)
        p_ms = time_cuda(lambda: ssm_scan_ref(*args), 1, 1)
        b_ms, b_by = ssm_bound_ms(Bt, L, D, N, args[0].element_size(),
                                  args[3].element_size())
        out[key] = {"ms": k_ms, "ms_host_issued": h_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "shape": {"Bt": Bt, "L": L, "D": D, "N": N}}
        print(f"[timing] ssm_scan {key} Bt={Bt} L={L} D={D} N={N} bf16 "
              f"x/B/C: kernel {k_ms:.6f} ms on the device ({h_ms:.6f} ms "
              f"issued from the host), plain {p_ms:.6f} ms, bound "
              f"{b_ms:.6f} ms ({b_by}); library call: none")
    # phase 11's timing (host-issued CUDA events; plain version, SDPA,
    # bound), then the kernel's device time
    (q, k, v), kw = flash_inputs_z
    flash = flash_timing(fa, flash_ref, {"zamba2": flash_inputs_z},
                         time_cuda)["zamba2"]
    flash["ms_host_issued"] = flash["ms"]
    flash["ms"] = graph_ms(lambda: fa.flash_attention(q, k, v, **kw), 20)
    flash["tflops"] *= flash["ms_host_issued"] / flash["ms"]
    out["flash_zamba2"] = flash
    print(f"[timing] flash_attention zamba2: kernel {flash['ms']:.6f} ms on "
          f"the device, {flash['ms'] / flash['bound_ms']:.1f}x the bound")
    return out


def main():
    import torch

    # -- 1. device --------------------------------------------------------
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "no CUDA device: this script measures "
                                     "the port on the card and nothing else")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[device] {name} x{torch.cuda.device_count()}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.bw_allocator import (queue_tables, simulate_numpy,
                                               simulate_tables)
    from repro_torch.core.encoding import (decode, decode_to_lists,
                                           random_population)
    from repro_torch.core.fitness import FitnessFn
    from repro_torch.core.m3e import M3E
    from repro_torch.costmodel import get_setting
    from repro_torch.kernels import _build
    from repro_torch.kernels._variants import graph_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import makespan as mk
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.kernels.ref import (flash_attention_ref, ssm_inputs,
                                         ssm_scan_ref)
    from repro_torch.workloads import build_task_groups
    from concurrent.futures import ThreadPoolExecutor

    def reset_counts():
        mk.reset_launches()
        ssm.reset_launches()
        fa.reset_launches()

    # -- 2. build ---------------------------------------------------------
    names = ("makespan", "ssm_scan", "flash_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(_build.load, names))
    print(f"[build] {', '.join(names)} in {time.perf_counter() - t0:.2f} s "
          "wall, built together")
    for kname, built in zip(names, builds):
        print(f"[build] {kname}: {built.path.name} (nvcc "
              f"{built.build_seconds:.2f} s"
              f"{'' if built.build_seconds else ', reused'})")
        for line in built.ptxas_log.splitlines():
            if line.strip():
                print(f"[build]   {line.strip()}")
    ptxas = {kname: _build.ptxas_report(built.ptxas_log, kernel_label)
             for kname, built in zip(names, builds)}
    for kname, entries in ptxas.items():
        for entry, (regs, spill_st, spill_ld) in entries.items():
            print(f"[build] {kname} {entry}: {regs} registers, {spill_st} "
                  f"bytes spill stores, {spill_ld} bytes spill loads")

    # -- 3. kernel check --------------------------------------------------
    group = build_task_groups("Mix", group_size=100, seed=0)[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def scenario_tables(setting, P, bw_sys=256 * GB):
        fit = M3E(get_setting(setting), bw_sys=bw_sys,
                  device=dev).prepare(group)
        pop = random_population(gen, P, fit.group_size, fit.num_accels, dev)
        sched = decode(pop.accel, pop.prio, fit.num_accels)
        qlat, qbw = queue_tables(sched, fit.params.lat, fit.params.bw)
        return (fit, pop, qlat.contiguous(), qbw.contiguous(), sched.count,
                fit.params.bw_sys)

    def random_tables(seed, P, G, A, one_accel=False):
        rng = np.random.default_rng(seed)
        lat = rng.uniform(0.05, 5.0, (G, A))
        bw = rng.uniform(0.01, 10.0, (G, A))
        accel = (np.zeros((P, G), np.int32) if one_accel
                 else rng.integers(0, A, (P, G)).astype(np.int32))
        prio = rng.random((P, G)).astype(np.float32)
        sched = decode(torch.as_tensor(accel, device=dev),
                       torch.as_tensor(prio, device=dev), A)
        qlat, qbw = queue_tables(sched, torch.as_tensor(lat, device=dev).float(),
                                 torch.as_tensor(bw, device=dev).float())
        return qlat.contiguous(), qbw.contiguous(), sched.count, lat

    errs = []

    def kernel_vs_plain(qlat, qbw, count, bw_sys, what):
        got = mk.makespan(qlat, qbw, count, bw_sys)
        torch.cuda.synchronize()
        want = simulate_tables(qlat, qbw, count, bw_sys)
        errs.append(compare(got, want, what))
        print(f"[check] {what}: max abs {errs[-1][0]:.3e} "
              f"max rel {errs[-1][1]:.3e}")
        return got

    main_cases = {}
    for setting in ("S4", "S6"):
        fit, pop, qlat, qbw, count, bw_sys = scenario_tables(setting, 100)
        main_cases[setting] = (fit, pop, qlat, qbw, count, bw_sys)
        kernel_vs_plain(qlat, qbw, count, bw_sys,
                        f"Mix G=100 {setting} A={fit.num_accels} P=100")
    # the last is phase 14's: the launcher's 15 jobs on 8 submeshes
    for seed, (G, A, P, bw_sys) in enumerate([(37, 5, 7, 3.0), (130, 3, 8, 10.0),
                                              (12, 9, 5, 1.0),
                                              (15, 8, 100, 4.0)]):
        qlat, qbw, count, _ = random_tables(seed, P, G, A)
        kernel_vs_plain(qlat, qbw, count, bw_sys, f"G={G} A={A} P={P}")
    qlat, qbw, count, _ = random_tables(10, 2, 1, 3)
    kernel_vs_plain(qlat, qbw, count, 2.0, "single job G=1 A=3 P=2")
    qlat, qbw, count, lat = random_tables(11, 3, 19, 4, one_accel=True)
    kernel_vs_plain(qlat, qbw, count, 5.0, "empty queues G=19 A=4 P=3")
    serial = mk.makespan(qlat, qbw, count, 1e9).double().cpu()
    check(bool(torch.allclose(serial, torch.full_like(serial, lat[:, 0].sum()),
                              rtol=RTOL)),
          "empty queues: a serial queue with ample BW must take the sum of "
          "its latencies")
    qlat, qbw, count, _ = random_tables(12, 4, 23, 6)
    kernel_vs_plain(qlat, qbw, count, 0.05, "BW-saturated G=23 A=6 P=4")

    fit, pop, qlat, qbw, count, bw_sys = main_cases["S4"]
    big = scenario_tables("S4", 4096)
    big_q = [t.clone() for t in big[2:5]]
    big_q[0][:100], big_q[1][:100], big_q[2][:100] = qlat, qbw, count
    out_big = kernel_vs_plain(big_q[0], big_q[1], big_q[2], bw_sys,
                              "Mix G=100 S4 A=8 P=4096")
    out_100 = mk.makespan(qlat, qbw, count, bw_sys)
    check(torch.equal(out_big[:100], out_100),
          "P-invariance: out[:100] of the P=4096 launch differs bitwise "
          "from the P=100 launch")
    print("[check] P=4096 out[:100] == P=100 out, bitwise")

    # per-row bw_sys, as a sweep chunk launches it: R = 4 rows of P = 100
    # (each its own population, four bandwidths) against four one-row
    # launches (bitwise) and the plain version
    row_bw = torch.tensor([16 * GB, 64 * GB, 256 * GB, 1024 * GB],
                          dtype=torch.float32, device=dev)
    rows_q = [scenario_tables("S4", 100)[2:5] for _ in range(4)]
    rq = [torch.cat([q[i] for q in rows_q]).contiguous() for i in range(3)]
    out_rows = kernel_vs_plain(rq[0], rq[1], rq[2], row_bw,
                               "per-row bw_sys R=4 x P=100 S4 A=8 G=100")
    for r, q in enumerate(rows_q):
        one = mk.makespan(q[0], q[1], q[2], row_bw[r:r + 1])
        check(torch.equal(out_rows[r * 100:(r + 1) * 100], one),
              f"per-row bw_sys: row {r} of the R=4 launch differs bitwise "
              "from its one-row launch")
    print("[check] per-row bw_sys R=4 rows == four one-row launches, "
          "bitwise")

    table = fit.table
    bw_host = float(fit.bw_sys)
    oracle_rel = 0.0
    accel_h, prio_h = pop.accel.cpu().numpy(), pop.prio.cpu().numpy()
    out_h = out_100.double().cpu().numpy()
    for p in range(8):
        want = simulate_numpy(decode_to_lists(accel_h[p], prio_h[p],
                                              fit.num_accels),
                              table.lat, table.bw, bw_host)
        rel = abs(out_h[p] - want) / abs(want)
        check(rel <= ORACLE_REL, f"float64 oracle: individual {p} off by "
                                 f"{rel:.3e} ({out_h[p]} vs {want})")
        oracle_rel = max(oracle_rel, rel)
    print(f"[check] 8 individuals vs the float64 oracle: max rel "
          f"{oracle_rel:.3e} (limit {ORACLE_REL})")

    # the selective scan: the reference tests' shapes, then the two serving
    # shapes (bf16 x/B/C and f32 dt/A, as the model path gives them)
    ssm_errs, ssm_main = [], {}
    ssm_cases = [(2, 40, 64, 4, torch.float32), (1, 129, 256, 16, torch.float32),
                 (2, 16, 128, 8, torch.float32), (1, 64, 384, 64, torch.float32),
                 (1, 32, 128, 16, torch.bfloat16),
                 (1, PROMPT, 8192, 16, torch.bfloat16),
                 (1, PROMPT, 4096, 64, torch.bfloat16),
                 # falcon-mamba's prefills in phase 14: L not a multiple of
                 # the kernel's 512-step chunk
                 (1, 201, 8192, 16, torch.bfloat16),
                 (1, 354, 8192, 16, torch.bfloat16)]
    # phase 15's evaluations: falcon-mamba-7b at B=1 and zamba2-1.2b at B=4
    # (Mamba-2's A broadcast to (Di, N)), S=2048
    eval_scans = {"falcon_eval": (1, 2048, 8192, 16),
                  "zamba2_eval": (4, 2048, 4096, 64)}
    ssm_cases += [shape + (low,) for shape in eval_scans.values()
                  for low in (torch.float32, torch.bfloat16)]
    ssm_eval = {}
    for i, (Bt, L, D, N, low) in enumerate(ssm_cases):
        args = ssm_inputs(dev, 100 + i, Bt, L, D, N, low)
        y, h = ssm.ssm_scan(*args)
        torch.cuda.synchronize()
        yr, hr = ssm_scan_ref(*args)
        tol = SSM_TOL_F32 if low == torch.float32 else SSM_TOL_BF16
        what = (f"ssm_scan Bt={Bt} L={L} D={D} N={N} "
                f"{str(low).split('.')[-1]} x/B/C")
        ey, eh = compare_tol(y, yr, tol, what + " y"), \
            compare_tol(h, hr, tol, what + " h")
        ssm_errs += [ey, eh]
        print(f"[check] {what}: y max abs {ey[0]:.3e} rel {ey[1]:.3e}; "
              f"h max abs {eh[0]:.3e} rel {eh[1]:.3e} (tol {tol})")
        if L == PROMPT:
            ssm_main["falcon" if N == 16 else "zamba2"] = args
        for key, shape in eval_scans.items():
            if (Bt, L, D, N) == shape and low == torch.bfloat16:
                ssm_eval[key] = args
        del y, h, yr, hr
    # bitwise batch-row independence: a Bt=2 launch, and the Bt=4 launch
    # of zamba2's evaluation shape
    for args2 in (ssm_inputs(dev, 200, 2, 96, 512, 64, torch.bfloat16),
                  ssm_eval["zamba2_eval"]):
        y2, h2 = ssm.ssm_scan(*args2)
        Bt = args2[0].shape[0]
        for b in range(Bt):
            x, dt, A, B, C = args2
            y1, h1 = ssm.ssm_scan(x[b:b + 1].contiguous(),
                                  dt[b:b + 1].contiguous(), A,
                                  B[b:b + 1].contiguous(),
                                  C[b:b + 1].contiguous())
            check(torch.equal(y2[b:b + 1], y1) and
                  torch.equal(h2[b:b + 1], h1),
                  f"ssm_scan: row {b} of a Bt={Bt} launch "
                  f"{tuple(x.shape)} differs bitwise from its Bt=1 launch")
        print(f"[check] ssm_scan Bt={Bt} rows == {Bt} Bt=1 launches, "
              f"bitwise ({tuple(args2[0].shape)}, N={args2[2].shape[1]})")
        del y2, h2
    flash_errs, flash_main = flash_checks(dev, fa, flash_attention_ref,
                                          torch.cuda.synchronize)
    flash_zamba2 = flash_main.pop("zamba2")

    # -- 14. launch: the serving launcher at full width -------------------
    # taken here, before the process's first profiler session (phase 5):
    # one session slows every later host-bound decode step; the profiled
    # token comes last (launch_profile)
    launch_out, probe_prompts = launch_phase(dev, mk, ssm, fa)
    launch_counts = launch_out["counts"]
    errs.append(launch_out["makespan_check"])
    print(f"[launch] launch path launches: {launch_counts}")
    free(dev)

    # -- 15. families: SSM, hybrid and encoder-decoder training and eval --
    # also before the first profiler session: the plain scan's training
    # step is host-bound
    reset_counts()
    families_out, fam = families_phase(dev, ssm, fa)
    family_counts = dict(fam, makespan=mk.LAUNCHES["makespan"])
    want = {"ssm_scan": sum(families_out["eval"][a]["scan_launches"]
                            for a in families_out["eval"]),
            "flash_attention": families_out["eval"]["zamba2-1.2b"][
                "flash_launches"], "makespan": 0}
    check(family_counts == want and want["ssm_scan"] == 64 + 38
          and want["flash_attention"] == 7,
          f"families launches {family_counts}, want {want} (64 + 38 scan, "
          "7 flash)")
    print(f"[families] families path launches: {family_counts}")
    families_out["timing"] = families_timing(ssm, fa, flash_attention_ref,
                                             ssm_eval, flash_zamba2)
    del ssm_eval, flash_zamba2
    free(dev)

    # -- 16. stream: the streaming service at full width ------------------
    # also before the first profiler session: its walls are host walls
    reset_counts()
    stream_out = stream_phase(dev, mk)
    stream_counts = {"makespan": mk.LAUNCHES["makespan"],
                     "ssm_scan": ssm.LAUNCHES["ssm_scan"],
                     "flash_attention": fa.LAUNCHES["flash_attention"]}
    want = {"makespan": stream_out["launches"], "ssm_scan": 0,
            "flash_attention": 0}
    check(stream_counts == want and want["makespan"] > 0,
          f"stream launches {stream_counts}, want {want}")
    print(f"[stream] stream path launches: {stream_counts}")
    free(dev)

    # -- 17. fleet: the scheduling fleet's workers on the one card --------
    # also before the first profiler session: its walls are host walls
    reset_counts()
    fleet_out = fleet_phase(dev, mk)
    fleet_counts = {"makespan": (fleet_out["launches_workers"]
                                 + mk.LAUNCHES["makespan"]),
                    "ssm_scan": ssm.LAUNCHES["ssm_scan"],
                    "flash_attention": fa.LAUNCHES["flash_attention"]}
    want = {"makespan": (fleet_out["launches_workers"]
                         + fleet_out["launches_parent"]),
            "ssm_scan": 0, "flash_attention": 0}
    check(fleet_counts == want and fleet_out["launches_workers"] > 0,
          f"fleet launches {fleet_counts}, want {want} (workers' "
          f"{fleet_out['launches_workers']} + this process's)")
    print(f"[fleet] fleet path launches: {fleet_counts} (the workers' "
          f"{fleet_out['launches_workers']} makespan launches included)")
    free(dev)

    # -- 4. main path -----------------------------------------------------
    setting, budget, bw_sys_main = "S4", 10_000, 256 * GB
    m3e = M3E(get_setting(setting), bw_sys=bw_sys_main, device=dev)
    cpu_fit = FitnessFn(table, bw_sys=bw_sys_main, device="cpu")
    walls = []
    reset_counts()
    for seed in range(4):
        before = mk.LAUNCHES["makespan"]
        res = m3e.search(group, method="magma", budget=budget, seed=seed)
        launched = mk.LAUNCHES["makespan"] - before
        walls.append(res.wall_time_s)
        print(f"[main] S4/Mix G=100 P=100 budget={budget} seed={seed}: best "
              f"throughput {res.best_fitness:.6e} FLOP/s, wall "
              f"{res.wall_time_s:.4f} s, makespan launches {launched}")
        check(launched == 100, f"seed {seed}: {launched} makespan launches, "
                               "want one per generation (100)")
        check(res.n_samples == budget and res.history_best.shape == (100,)
              and bool(np.all(np.isfinite(res.history_best)))
              and bool(np.all(np.diff(res.history_best) >= 0)),
              f"seed {seed}: malformed search history")
        again = float(cpu_fit(torch.as_tensor(res.best_accel[None]),
                              torch.as_tensor(res.best_prio[None]))[0])
        check(abs(again - res.best_fitness) <= RTOL * abs(res.best_fitness),
              f"seed {seed}: best individual re-evaluated on the CPU gives "
              f"{again}, the search reported {res.best_fitness}")
        mapping = m3e.describe_mapping(res)
        check(sorted(sum(mapping, [])) == list(range(100)),
              f"seed {seed}: the best mapping does not place every job once")
    launches = mk.LAUNCHES["makespan"]
    check(ssm.LAUNCHES["ssm_scan"] == 0
          and fa.LAUNCHES["flash_attention"] == 0,
          "the M3E searches launched the scan or the flash kernel")
    print(f"[main] makespan kernel launches over 4 searches: {launches}")

    # -- 5. timing --------------------------------------------------------
    P, A, G = qlat.shape
    bq = big_q

    def run_100():
        return mk.makespan(qlat, qbw, count, bw_sys)

    def run_4096():
        return mk.makespan(bq[0], bq[1], bq[2], bw_sys)

    ms, ms_big = graph_ms(run_100, 200), graph_ms(run_4096, 100)
    host_ms = time_cuda(run_100, 200, 20)
    host_big = time_cuda(run_4096, 100, 10)
    plain_ms = time_cuda(lambda: simulate_tables(qlat, qbw, count, bw_sys),
                         10, 2)
    bound_ms, bound_by = makespan_bound_ms(P, A, G)
    plain_big = time_cuda(lambda: simulate_tables(bq[0], bq[1], bq[2],
                                                  bw_sys), 5, 1)
    bound_big, by_big = makespan_bound_ms(4096, A, G)
    print(f"[timing] makespan P={P} A={A} G={G}: kernel {ms:.6f} ms on the "
          f"device ({host_ms:.6f} ms issued from the host), plain "
          f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}); "
          f"P=4096: kernel {ms_big:.6f} ms on the device ({host_big:.6f} ms "
          f"from the host), plain {plain_big:.6f} ms, bound {bound_big:.6f} "
          f"ms ({by_big}); library call: none")
    print(f"[timing] search wall s per seed: {walls}")
    per_row = {}
    for R in (4, 3):
        n = R * 100
        args = (rq[0][:n], rq[1][:n], rq[2][:n], row_bw[:R])
        r_ms = graph_ms(lambda: mk.makespan(*args), 200)
        r_bound, r_by = makespan_bound_ms(n, A, G)
        per_row[f"R{R}xP100"] = {"ms": r_ms, "bound_ms": r_bound,
                                 "bound_by": r_by, "N": n}
        print(f"[timing] makespan per-row bw_sys R={R} x P=100 (N={n}): "
              f"kernel {r_ms:.6f} ms on the device, bound {r_bound:.6f} "
              f"ms ({r_by})")

    # where a search's time goes: one more search under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import profile
    with profile(activities=profiler_activities(dev)) as prof:
        traced = m3e.search(group, method="magma", budget=budget, seed=0)
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    profile_out = None
    if on_card:
        busy_ms = sum(e.device_time_total for e in on_card) / 1e3
        mk_ms = sum(e.device_time_total for e in on_card
                    if "makespan_kernel" in e.name) / 1e3
        wall_ms = traced.wall_time_s * 1e3
        profile_out = {"search_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                       "device_busy_share": busy_ms / wall_ms,
                       "makespan_kernel_ms": mk_ms,
                       "device_ops": len(on_card)}
        print(f"[profile] traced search: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}) over "
              f"{len(on_card)} device ops, makespan kernel {mk_ms:.3f} ms")
    else:
        print("[profile] the profiler saw no device time: device busy share "
              "not measured")

    # -- 6. serve ----------------------------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.core.strategies import plan_generations
    from repro_torch.models.registry import count_params, get_model
    from repro_torch.serve import MultiTenantEngine, Tenant, default_submeshes

    weights = torch.Generator(device=dev)
    weights.manual_seed(0)
    tenants = []
    for arch in SERVE_ARCHS:
        cfg = get_config(arch).replace(use_flash=True)
        t0 = time.perf_counter()
        model = get_model(cfg, device=dev, generator=weights)
        torch.cuda.synchronize()
        n = count_params(cfg)
        check(sum(p.numel() for p in model.parameters()) == n,
              f"{arch}: parameter count")
        print(f"[serve] {arch}: {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, d_inner {cfg.inner}, N {cfg.ssm_state}, "
              f"{n:,} params in {cfg.dtype} ({n * 2 / 1e9:.2f} GB), random "
              f"init {time.perf_counter() - t0:.2f} s")
        tenants.append(Tenant(arch, cfg, model))
    layers = {t.name: t.cfg.num_layers for t in tenants}
    engine = MultiTenantEngine(tenants, default_submeshes(),
                               decode_window=WINDOW, seed=0, device=dev)
    generations = plan_generations(engine.budget, 100)[0]

    def serve(requests, what, seed=0):
        """One schedule(..., execute=True) of ``requests`` with prompts
        drawn from ``seed``; checks its coverage and launch counts, returns
        (jobs, out, wall s, (ssm_scan, makespan) launches)."""
        jobs = engine.jobs_for_requests(requests)
        draw = np.random.default_rng(seed)
        prompts = {j.uid: draw.integers(0, engine.tenants[j.tenant].cfg.vocab,
                                        (1, j.seq))
                   for j in jobs if j.phase == "prefill"}
        reset_counts()
        t0 = time.perf_counter()
        out = engine.schedule(jobs, method="magma", execute=True,
                              prompts=prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (ssm.LAUNCHES["ssm_scan"], mk.LAUNCHES["makespan"])
        check(fa.LAUNCHES["flash_attention"] == 0,
              f"{what}: serving launched the flash kernel")
        check(sorted(u for q in out["queues"] for u in q)
              == sorted(j.uid for j in jobs),
              f"{what}: a job is not scheduled exactly once")
        decodes = {j.uid: j for j in jobs if j.phase == "decode"}
        check(sorted(out["outputs"]) == sorted(decodes),
              f"{what}: the outputs do not cover every decode window")
        for uid, toks in out["outputs"].items():
            vocab = engine.tenants[decodes[uid].tenant].cfg.vocab
            check(toks.shape == (1, decodes[uid].tokens)
                  and bool(((toks >= 0) & (toks < vocab)).all()),
                  f"{what}: decode job {uid} gave {toks.shape} tokens")
        want = sum(layers[j.tenant] for j in jobs if j.phase == "prefill")
        check(counts == (want, generations),
              f"{what}: launches (ssm_scan, makespan) = {counts}, want "
              f"({want}, {generations})")
        print(f"[serve] {what}: {len(jobs)} jobs on {len(engine.submeshes)} "
              f"submeshes, schedule+execute wall {wall:.3f} s (search "
              f"{out['result'].wall_time_s:.3f} s), launches ssm_scan "
              f"{counts[0]} makespan {counts[1]}")
        return jobs, out, wall, counts

    requests = [(arch, PROMPT, GENERATE) for arch in SERVE_ARCHS
                for _ in range(2)]
    jobs, served, serve_wall, serve_counts = serve(requests, "main")
    # the same requests again, each prefill and decode step timed alone
    phase_walls = {"prefill": [], "decode": []}

    def timed(fn, phase, arch):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            phase_walls[phase].append((arch, time.perf_counter() - t0))
            return out
        return run

    for t in tenants:
        t.model.prefill = timed(t.model.prefill, "prefill", t.name)
        t.model.decode_step = timed(t.model.decode_step, "decode", t.name)
    _, again, timed_wall, _ = serve(requests, "timed")
    for t in tenants:
        del t.model.prefill, t.model.decode_step
    check(all(np.array_equal(a, b) for a, b in
              zip(served["outputs"].values(), again["outputs"].values())),
          "serving the same requests twice gave other tokens")
    serve_out = {"schedule_wall_s": serve_wall, "timed_wall_s": timed_wall,
                 "makespan_s": served["makespan_s"],
                 "search_wall_s": served["result"].wall_time_s}
    for arch in SERVE_ARCHS:
        pre = [w for a, w in phase_walls["prefill"] if a == arch]
        dec = [w for a, w in phase_walls["decode"] if a == arch]
        serve_out[arch] = {"prefill_s": pre,
                           "decode_s_per_token_median": float(np.median(dec)),
                           "decode_s_per_token_mean": float(np.mean(dec))}
        print(f"[serve] {arch}: prefill of {PROMPT} tokens "
              f"{', '.join(f'{w * 1e3:.3f}' for w in pre)} ms; decode "
              f"{np.median(dec) * 1e3:.3f} ms per token (median of "
              f"{len(dec)}, mean {np.mean(dec) * 1e3:.3f})")

    # -- 7. whole model: kernel path against plain path -------------------
    def greedy(model, cfg, prompt):
        """Prefill logits and GENERATE greedy tokens of ``model`` run with
        ``cfg`` (the same weights; cfg.use_flash picks the scan)."""
        model.cfg = cfg
        logits, cache = model.prefill({"tokens": prompt},
                                      PROMPT + GENERATE)
        first = logits.clone()
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks = []
        for pos in range(PROMPT, PROMPT + GENERATE):
            logits, cache = model.decode_step(cache, cur, pos)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
            toks.append(cur)
        return first, torch.cat(toks, dim=1).cpu()

    rng = np.random.default_rng(1)
    cfg32 = get_config("falcon-mamba-7b").replace(
        num_layers=4, dtype="float32", use_flash=True)
    m32 = get_model(cfg32, device=dev, generator=weights)
    prompt = torch.as_tensor(rng.integers(0, cfg32.vocab, (1, PROMPT)),
                             device=dev)
    reset_counts()
    lk, tk = greedy(m32, cfg32, prompt)
    check(ssm.LAUNCHES["ssm_scan"] == 4, "f32 model: the kernel path did "
                                         "not launch the scan kernel")
    lp, tp = greedy(m32, cfg32.replace(use_flash=False), prompt)
    check(ssm.LAUNCHES["ssm_scan"] == 4, "f32 model: the plain path "
                                         "launched the scan kernel")
    check(bool(torch.isfinite(lk).all()), "f32 model: non-finite logits")
    model_diff = float((lk - lp).abs().max())
    check(model_diff <= MODEL_F32_ATOL,
          f"f32 model: prefill logits differ by {model_diff} "
          f"(tol {MODEL_F32_ATOL})")
    check(torch.equal(tk, tp), f"f32 model: greedy tokens differ: "
                              f"{tk.tolist()} vs {tp.tolist()}")
    print(f"[model] falcon-mamba-7b full width, 4 layers, f32: prefill "
          f"logits max abs diff {model_diff:.3e} (tol {MODEL_F32_ATOL}, "
          f"logits max abs {float(lk.abs().max()):.3f}); {GENERATE} greedy "
          "tokens equal")
    del m32
    full_depth = {}
    for t in tenants:
        prompt = torch.as_tensor(rng.integers(0, t.cfg.vocab, (1, PROMPT)),
                                 device=dev)
        lk, tk = greedy(t.model, t.cfg, prompt)
        lp, tp = greedy(t.model, t.cfg.replace(use_flash=False), prompt)
        t.model.cfg = t.cfg
        agree = int((tk == tp).sum())
        same = (tk == tp)[0].tolist() + [False]
        full_depth[t.name] = {"logits_max_abs_diff": float((lk - lp).abs()
                                                           .max()),
                              "logits_max_abs": float(lk.abs().max()),
                              "tokens_equal": agree, "tokens": GENERATE,
                              "first_difference": same.index(False)}
        print(f"[model] {t.name} full depth, bf16 (reported, not "
              f"required): prefill logits max abs diff "
              f"{full_depth[t.name]['logits_max_abs_diff']:.3e} (logits "
              f"max abs {full_depth[t.name]['logits_max_abs']:.3f}), "
              f"{agree}/{GENERATE} greedy tokens equal, first difference "
              f"at token {same.index(False)}")

    # -- 8. timing: the scan kernel, and where a served request's time goes
    ssm_times = {}
    for key, args in ssm_main.items():
        Bt, L, D = args[0].shape
        N = args[2].shape[1]
        k_ms = graph_ms(lambda: ssm.ssm_scan(*args), 50)
        h_ms = time_cuda(lambda: ssm.ssm_scan(*args), 100, 10)
        p_ms = time_cuda(lambda: ssm_scan_ref(*args), 3, 1)
        b_ms, b_by = ssm_bound_ms(Bt, L, D, N, args[0].element_size(),
                                  args[3].element_size())
        ssm_times[key] = (k_ms, p_ms, b_ms, b_by, (Bt, L, D, N), h_ms)
        print(f"[timing] ssm_scan {key} Bt={Bt} L={L} D={D} N={N} bf16 "
              f"x/B/C: kernel {k_ms:.6f} ms on the device ({h_ms:.6f} ms "
              f"issued from the host), plain {p_ms:.6f} ms, bound "
              f"{b_ms:.6f} ms ({b_by}); library call: none")

    with profile(activities=profiler_activities(dev)) as prof:
        t0 = time.perf_counter()
        traced_jobs, traced_out, _, _ = serve(
            [(SERVE_ARCHS[0], PROMPT, GENERATE)], "profiled")
        traced_wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    serve_profile = None
    if on_card:
        busy_ms = sum(e.device_time_total for e in on_card) / 1e3
        by_name = {}
        for e in on_card:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.device_time_total / 1e3
        ssm_ms = sum(v for k, v in by_name.items() if "ssm_scan_kernel" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        serve_profile = {"wall_ms": traced_wall_ms, "device_busy_ms": busy_ms,
                         "device_busy_share": busy_ms / traced_wall_ms,
                         "ssm_kernel_ms": ssm_ms,
                         "ssm_share_of_busy": ssm_ms / busy_ms,
                         "device_ops": len(on_card),
                         "top_kernels_ms": [[k[:80], v] for k, v in top]}
        print(f"[profile] one served {SERVE_ARCHS[0]} request ({PROMPT} + "
              f"{GENERATE} tokens): wall {traced_wall_ms:.3f} ms, device "
              f"busy {busy_ms:.3f} ms ({busy_ms / traced_wall_ms:.1%}) over "
              f"{len(on_card)} device ops, ssm_scan kernel {ssm_ms:.3f} ms "
              f"({ssm_ms / busy_ms:.1%} of busy)")
        for k, v in top:
            print(f"[profile]   {v:10.3f} ms  {k[:100]}")
    else:
        print("[profile] the profiler saw no device time: device busy share "
              "not measured")

    # -- 9. train, 10. eval: the dense slice ------------------------------
    del tenants, engine, traced_jobs, traced_out, jobs, served, again
    free(dev)
    reset_counts()
    trained, train_steps, restart = train_phase(dev, fa)
    evals = eval_phase(dev, fa, trained)
    train_eval_counts = {"makespan": mk.LAUNCHES["makespan"],
                         "ssm_scan": ssm.LAUNCHES["ssm_scan"],
                         "flash_attention": fa.LAUNCHES["flash_attention"]}
    want = {"makespan": 0, "ssm_scan": 0, "flash_attention": 40 + 24}
    check(train_eval_counts == want,
          f"train_eval launches {train_eval_counts}, want {want}")
    print(f"[eval] train_eval path launches: {train_eval_counts}")
    del trained
    free(dev)
    compare_routes(dev, fa, evals)

    # -- 11. timing: the flash kernel, and where a training step goes -----
    flash_times = flash_timing(fa, flash_attention_ref, flash_main,
                               time_cuda)
    del flash_main
    free(dev)
    train_profile = profile_train_step(dev)

    # -- 12. compare: the Fig. 9 grid, every Table IV method -------------
    free(dev)
    reset_counts()
    compared = compare_phase(dev, mk)
    compare_counts = {"makespan": mk.LAUNCHES["makespan"],
                      "ssm_scan": ssm.LAUNCHES["ssm_scan"],
                      "flash_attention": fa.LAUNCHES["flash_attention"]}
    check(compare_counts["ssm_scan"] == 0
          and compare_counts["flash_attention"] == 0
          and compare_counts["makespan"] == compared["launches"] > 0,
          f"compare launches {compare_counts}: want the makespan kernel "
          f"{compared['launches']} times (the phase's parts) and no other")
    print(f"[compare] compare path launches: {compare_counts}")

    # -- 13. memo: exact replay, memoized sweeps, warm starts, Table V ----
    reset_counts()
    memo_out = memo_phase(dev, mk)
    memo_counts = {"makespan": mk.LAUNCHES["makespan"],
                   "ssm_scan": ssm.LAUNCHES["ssm_scan"],
                   "flash_attention": fa.LAUNCHES["flash_attention"]}
    check(memo_counts["ssm_scan"] == 0
          and memo_counts["flash_attention"] == 0
          and memo_counts["makespan"] > 0,
          f"memo launches {memo_counts}: want the makespan kernel and no "
          "other")
    print(f"[memo] memo path launches: {memo_counts}")

    # -- 14, its end: the decode probe again, one profiled MoE token -----
    free(dev)
    launch_profile(dev, probe_prompts, launch_out)
    del probe_prompts

    # -- 15, its end: a zamba2 training step and two evaluations profiled -
    families_profile(dev, families_out)

    # -- 16, its end: the card's own busy share in a pipelined stream run -
    stream_out["card_busy"] = stream_card_busy(dev)

    max_abs = max(e[0] for e in errs)
    max_rel = max(e[1] for e in errs)
    k_ms, p_ms, b_ms, b_by, shape, kh_ms = ssm_times["falcon"]
    z_ms, zp_ms, zb_ms, _, z_shape, zh_ms = ssm_times["zamba2"]
    gt, dt_ = flash_times["granite"], flash_times["danube"]
    kernels = [{
        "name": "makespan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/makespan.cu",
        "replaces": "src/repro/kernels/makespan.py:36",
        "launches": launches + serve_counts[1] + compare_counts["makespan"]
        + memo_counts["makespan"] + launch_counts["makespan"]
        + stream_counts["makespan"] + fleet_counts["makespan"],
        "launches_by_path": {"m3e_search": launches,
                             "serve": serve_counts[1],
                             "train_eval": train_eval_counts["makespan"],
                             "compare": compare_counts["makespan"],
                             "memo": memo_counts["makespan"],
                             "launch": launch_counts["makespan"],
                             "families": family_counts["makespan"],
                             "stream": stream_counts["makespan"],
                             "fleet": fleet_counts["makespan"]},
        "launches_per_search": launches // 4,
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "ms_host_issued": host_ms,
        "shape": {"P": P, "A": A, "G": G},
        "ms_p4096": ms_big, "ms_p4096_host_issued": host_big,
        "plain_ms_p4096": plain_big, "bound_ms_p4096": bound_big,
        "ptxas": ptxas_json(ptxas["makespan"]),
        "search_wall_s": walls, "profile": profile_out,
        "per_row_bw_sys": per_row, "compare": compared, "memo": memo_out,
        "stream": stream_out, "fleet": fleet_out, "ok": True,
    }, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:28",
        "launches": serve_counts[0] + launch_counts["ssm_scan"]
        + family_counts["ssm_scan"],
        "launches_by_path": {"m3e_search": 0, "serve": serve_counts[0],
                             "train_eval": train_eval_counts["ssm_scan"],
                             "compare": 0, "memo": 0,
                             "launch": launch_counts["ssm_scan"],
                             "families": family_counts["ssm_scan"],
                             "stream": stream_counts["ssm_scan"],
                             "fleet": fleet_counts["ssm_scan"]},
        "launches_per_eval": {a: e["scan_launches"] for a, e in
                              families_out["eval"].items()},
        "eval_shapes": {k: v for k, v in families_out["timing"].items()
                        if k != "flash_zamba2"},
        "max_abs_err": max(e[0] for e in ssm_errs),
        "max_rel_err": max(e[1] for e in ssm_errs),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "ms_host_issued": kh_ms,
        "shape": dict(zip(("Bt", "L", "D", "N"), shape)),
        "ms_zamba2": z_ms, "ms_zamba2_host_issued": zh_ms,
        "plain_ms_zamba2": zp_ms, "bound_ms_zamba2": zb_ms,
        "ptxas": ptxas_json(ptxas["ssm_scan"]),
        "shape_zamba2": dict(zip(("Bt", "L", "D", "N"), z_shape)),
        "serve": serve_out, "model_f32_logits_max_abs_diff": model_diff,
        "full_depth_bf16": full_depth, "profile": serve_profile,
        "launch": launch_out, "families": families_out, "ok": True,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": train_eval_counts["flash_attention"]
        + family_counts["flash_attention"],
        "launches_by_path": {"m3e_search": 0, "serve": 0,
                             "train_eval": train_eval_counts[
                                 "flash_attention"], "compare": 0,
                             "memo": 0,
                             "launch": launch_counts["flash_attention"],
                             "families": family_counts["flash_attention"],
                             "stream": stream_counts["flash_attention"],
                             "fleet": fleet_counts["flash_attention"]},
        "launches_per_eval": dict(
            {k: v["flash_launches"] for k, v in evals.items()},
            zamba2=families_out["eval"]["zamba2-1.2b"]["flash_launches"]),
        "zamba2": families_out["timing"]["flash_zamba2"],
        "max_abs_err": max(e[0] for e in flash_errs),
        "max_rel_err": max(e[1] for e in flash_errs),
        "ms": gt["ms"], "plain_ms": gt["plain_ms"], "bound_ms": gt["bound_ms"],
        "bound_by": gt["bound_by"], "library_ms": gt["library_ms"],
        "tflops": gt["tflops"], "shape": gt["shape"],
        "ms_danube": dt_["ms"], "plain_ms_danube": dt_["plain_ms"],
        "bound_ms_danube": dt_["bound_ms"], "tflops_danube": dt_["tflops"],
        "library_ms_danube": dt_["library_ms"], "shape_danube": dt_["shape"],
        "ptxas": ptxas_json(ptxas["flash_attention"]),
        "train": {"steps": train_steps, "restart": restart,
                  "profile": train_profile},
        "eval": evals, "ok": True,
    }]
    print(f"[device] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--stream-ab"]:
        sys.exit(stream_ab(sys.argv[2:]))
    sys.exit(main())
