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
              tests' shapes (float32 and bf16 inputs) and at the two
              serving shapes, plus bitwise batch-row independence; the
              flash kernel at the reference tests' shapes, ragged S, the
              two evaluation shapes and the bf16 kernel's edges
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

The counts of every kernel are set to 0 before each main path (the M3E
searches, the served batch, phases 9-10 together, "train_eval", and the
comparison, "compare") and read after it.  It prints a JSON line with one
entry per kernel, the card's name and power limit, and last the line
``{"ok": true, "device": {...}}``.
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
    reference tests' shapes, ragged S at D=20 and D=160, and the two
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
                  "danube": (EVAL_BATCH, EVAL_SEQ, 32, 8, 120, 4096, True)}
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.train.data import TokenStream
    from repro_torch.train.loop import TrainConfig, init_state, \
        make_train_step

    cfg = get_config(TRAIN_ARCH)
    model = get_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    step = make_train_step(model, TrainConfig(
        lr=3e-4, warmup_steps=max(TRAIN_STEPS // 10, 5),
        total_steps=TRAIN_STEPS))
    state, _ = step(init_state(model), stream.batch_at(0))
    batch = stream.batch_at(1)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    del state, model
    if not on_card:
        print("[profile] the profiler saw no device time: device busy share "
              "not measured")
        return None
    busy_ms = sum(e.device_time_total for e in on_card) / 1e3
    by_name = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"[profile] one {TRAIN_ARCH} training step ({TRAIN_BATCH}x"
          f"{TRAIN_SEQ} tokens): wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}) over {len(on_card)} "
          f"device ops")
    for k, v in top:
        print(f"[profile]   {v:10.3f} ms  {k[:100]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_ops": len(on_card),
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


def compare_phase(dev, mk, budget=10_000, group_size=100):
    """Phase 12: the paper's Fig. 9 comparison through the port's entry
    points on ``dev``.  Every device-resident method runs one
    ``run_sweep`` per setting (its two tasks x COMPARE_SEEDS rows in
    chunks of COMPARE_CHUNK_ROWS) that must launch the makespan kernel
    once per generation and chunk, and whose rows must equal bitwise the
    same searches run one by one with ``run_strategy``; the host methods
    run through ``M3E.search``.  Every best individual, re-evaluated by
    the plain version on the CPU, must give its best fitness at rtol
    1e-4.  Returns the phase's summary."""
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
    method_wall, sweeps = {}, []
    for method in DEVICE_METHODS:
        strategy = get_strategy(method)
        generations = plan_generations(budget, strategy.ask_size)[0]
        method_wall[method] = 0.0
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
            t0 = time.perf_counter()
            alone = {(s, k): run_strategy(strategy, fits[lab], budget=budget,
                                          seed=seed, device=dev)
                     for s, lab in enumerate(rows)
                     for k, seed in enumerate(COMPARE_SEEDS)}
            seq_wall = time.perf_counter() - t0
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
    profile = profile_sweep(dev, fits, labels, budget)
    for method in HOST_METHODS:
        method_wall[method] = 0.0
        for setting, bw in FIG9_SETTINGS:
            for task in FIG9_TASKS:
                label = f"{task}-{setting}-bw{bw}"
                vals = []
                for seed in HOST_SEEDS:
                    res = m3es[setting].search(groups[task], method=method,
                                               budget=budget, seed=seed)
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
    total = time.perf_counter() - t_phase
    print(f"[compare] cuts: host methods at {len(HOST_SEEDS)} seed(s) "
          f"({len(COMPARE_SEEDS)} for device methods); G={group_size} and "
          f"budget={budget} not cut; phase wall {total:.3f} s")
    return {"best_fitness": best, "normalized": {
                lab: {m: mean[lab][m] / mean[lab]["magma"] for m in methods}
                for lab in labels},
            "magma_advantage": advantage, "order": order,
            "method_wall_s": method_wall, "sweeps": sweeps,
            "seeds": {"device": list(COMPARE_SEEDS),
                      "host": list(HOST_SEEDS)},
            "profile": profile, "phase_wall_s": total}


def profile_sweep(dev, fits, labels, budget):
    """One MAGMA sweep of the S4 rows under torch.profiler: its wall, the
    device's busy share, the device ops per generation and chunk, and the
    makespan kernel's part (None where the profiler sees no device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.sweep import SweepConfig, run_sweep

    rows = [fits[lab] for lab in labels if "-S4-" in lab]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if dev.type == "cuda" else [ProfilerActivity.CPU]) as prof:
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
    for seed, (G, A, P, bw_sys) in enumerate([(37, 5, 7, 3.0), (130, 3, 8, 10.0),
                                              (12, 9, 5, 1.0)]):
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
                 (1, PROMPT, 4096, 64, torch.bfloat16)]
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
    args2 = ssm_inputs(dev, 200, 2, 96, 512, 64, torch.bfloat16)
    y2, h2 = ssm.ssm_scan(*args2)
    for b in range(2):
        x, dt, A, B, C = args2
        y1, h1 = ssm.ssm_scan(x[b:b + 1].contiguous(), dt[b:b + 1].contiguous(),
                              A, B[b:b + 1].contiguous(),
                              C[b:b + 1].contiguous())
        check(torch.equal(y2[b:b + 1], y1) and torch.equal(h2[b:b + 1], h1),
              f"ssm_scan: row {b} of a Bt=2 launch differs bitwise from its "
              "Bt=1 launch")
    print("[check] ssm_scan Bt=2 rows == two Bt=1 launches, bitwise")
    flash_errs, flash_main = flash_checks(dev, fa, flash_attention_ref,
                                          torch.cuda.synchronize)

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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
          and compare_counts["makespan"] > 0,
          f"compare launches {compare_counts}: want the makespan kernel "
          "and no other")
    print(f"[compare] compare path launches: {compare_counts}")

    max_abs = max(e[0] for e in errs)
    max_rel = max(e[1] for e in errs)
    k_ms, p_ms, b_ms, b_by, shape, kh_ms = ssm_times["falcon"]
    z_ms, zp_ms, zb_ms, _, z_shape, zh_ms = ssm_times["zamba2"]
    gt, dt_ = flash_times["granite"], flash_times["danube"]
    kernels = [{
        "name": "makespan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/makespan.cu",
        "replaces": "src/repro/kernels/makespan.py:36",
        "launches": launches + serve_counts[1] + compare_counts["makespan"],
        "launches_by_path": {"m3e_search": launches,
                             "serve": serve_counts[1],
                             "train_eval": train_eval_counts["makespan"],
                             "compare": compare_counts["makespan"]},
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
        "per_row_bw_sys": per_row, "compare": compared, "ok": True,
    }, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:28",
        "launches": serve_counts[0],
        "launches_by_path": {"m3e_search": 0, "serve": serve_counts[0],
                             "train_eval": train_eval_counts["ssm_scan"],
                             "compare": 0},
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
        "full_depth_bf16": full_depth, "profile": serve_profile, "ok": True,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": train_eval_counts["flash_attention"],
        "launches_by_path": {"m3e_search": 0, "serve": 0,
                             "train_eval": train_eval_counts[
                                 "flash_attention"], "compare": 0},
        "launches_per_eval": {k: v["flash_launches"] for k, v in
                              evals.items()},
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
    sys.exit(main())
