#!/usr/bin/env python3
"""Build and drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure raises and exits non-zero:

  1. device   the torch version, the card, and its name and power limit as
              nvidia-smi reports them; fails without a CUDA device
  2. build    nvcc builds every kernel of the main path from csrc/ (the
              seconds and the -Xptxas -v report are printed)
  3. check    every kernel against its plain PyTorch version on the card,
              at the main path's shapes and at edge cases, plus the
              float64 oracle and bitwise population-size invariance
  4. main     the M3E mapper end to end: S4 with a Mix group of 100 jobs,
              bw_sys = 256 GB/s, MAGMA with the paper's 10K-sample budget
              (P=100, 100 generations), four seeds; each search must
              launch the makespan kernel once per generation, and its best
              individual, re-evaluated by the plain version on the CPU,
              must reproduce its best fitness
  5. timing   CUDA-event times of each kernel and its plain version,
              beside the least time the card could take for the same work,
              and one more search under torch.profiler: the device's busy
              share of the search and the makespan kernel's part of it

It prints a JSON line with one entry per kernel, the card's name and power
limit, and last the line ``{"ok": true, "device": {...}}``.
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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
GB = 1024 ** 3


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def time_cuda(fn, reps, warmup):
    """Mean ms per call of ``fn`` on the card, by CUDA events."""
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
    from repro_torch.kernels import makespan as mk
    from repro_torch.workloads import build_task_groups

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.load("makespan")
    print(f"[build] makespan: {built.path.name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {built.build_seconds:.2f} s"
          f"{'' if built.build_seconds else ', reused'})")
    for line in built.ptxas_log.splitlines():
        if line.strip():
            print(f"[build]   {line.strip()}")

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

    # -- 4. main path -----------------------------------------------------
    setting, budget, bw_sys_main = "S4", 10_000, 256 * GB
    m3e = M3E(get_setting(setting), bw_sys=bw_sys_main, device=dev)
    cpu_fit = FitnessFn(table, bw_sys=bw_sys_main, device="cpu")
    walls = []
    mk.reset_launches()
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
    print(f"[main] makespan kernel launches over 4 searches: {launches}")

    # -- 5. timing --------------------------------------------------------
    P, A, G = qlat.shape
    ms = time_cuda(lambda: mk.makespan(qlat, qbw, count, bw_sys), 200, 20)
    plain_ms = time_cuda(lambda: simulate_tables(qlat, qbw, count, bw_sys),
                         10, 2)
    bound_ms, bound_by = makespan_bound_ms(P, A, G)
    bq = big_q
    ms_big = time_cuda(lambda: mk.makespan(bq[0], bq[1], bq[2], bw_sys),
                       100, 10)
    plain_big = time_cuda(lambda: simulate_tables(bq[0], bq[1], bq[2],
                                                  bw_sys), 5, 1)
    bound_big, by_big = makespan_bound_ms(4096, A, G)
    print(f"[timing] makespan P={P} A={A} G={G}: kernel {ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}); "
          f"P=4096: kernel {ms_big:.6f} ms, plain {plain_big:.6f} ms, bound "
          f"{bound_big:.6f} ms ({by_big}); library call: none")
    print(f"[timing] search wall s per seed: {walls}")

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

    max_abs = max(e[0] for e in errs)
    max_rel = max(e[1] for e in errs)
    kernels = [{
        "name": "makespan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/makespan.cu",
        "replaces": "src/repro/kernels/makespan.py:36",
        "launches": launches, "launches_per_search": launches // 4,
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "shape": {"P": P, "A": A, "G": G},
        "ms_p4096": ms_big, "plain_ms_p4096": plain_big,
        "bound_ms_p4096": bound_big,
        "search_wall_s": walls, "profile": profile_out, "ok": True,
    }]
    print(f"[device] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
