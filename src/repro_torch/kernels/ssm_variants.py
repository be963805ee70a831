"""Where the selective-scan kernel's time goes: the kernel as it is beside
ablated builds, each with one part of the per-step work taken out, timed
on the card at the two serving shapes.

    PYTHONPATH=src python -m repro_torch.kernels.ssm_variants [--reps N]
    PYTHONPATH=src python -m repro_torch.kernels.ssm_variants --tunings

An ablated build computes a wrong result on purpose (only its time is
read); the build as it is is checked against the plain version first.
The ablations are text edits of ``csrc/ssm_scan.cu`` made at run time, so
the source keeps no switches for them.  ``--tunings`` adds builds with
other choices of the kernel's parameters (the decay's exponential, chunk,
registers, unrolling), each checked against the plain version.  Builds go
to ``build/kernels/ssm_variants`` (one ``nvcc`` per variant, all started
together).  Each variant is timed on the device, as a CUDA graph of its
launches; the builds that compute the right result (as it is, the other
exponential, the tunings) and the plain float32 version are held to a
float64 scan, and their largest errors printed.  Prints the card's
``nvidia-smi`` name and power limit, then one JSON line of ms per variant
and shape.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from repro_torch.kernels import _build, _variants
from repro_torch.kernels import ssm_scan as ssm
from repro_torch.kernels.ref import ssm_inputs
from repro_torch.models.mamba import selective_scan

# name -> edits, each (text in the source, its replacement), applied together
ABLATIONS: Dict[str, tuple] = {
    # no global loads: the shared buffers keep what they held
    "no_staging_loads": (("    issue_chunk(t0 + 2 * kChunk);\n", ""),
                         ("  issue_chunk(kChunk);\n", ""),
                         ("  issue_chunk(0);\n", "")),
    # the decay's exponential: expf (an FMA polynomial) -> __expf
    # (ex2.approx on the SFU)
    "exp_swapped": (("expf(dtv * a[k])", "__expf(dtv * a[k])"),),
    # y's partial sums neither reduced over the lanes nor stored (their
    # products are kept alive by a store that never runs)
    "no_y_reduce": (
        ("    if (ci > 0) reduce_chunk(t0 - kChunk, kChunk);\n",
         "    if (sP[tid] == 1.2345f) y[0] = sP[tid];\n"),
        ("  reduce_chunk((nchunks - 1) * kChunk, L - (nchunks - 1) * "
         "kChunk);\n", "")),
    # the chunk is not widened to f32: the walk reads what the buffers
    # held (timing only)
    "no_widening": (("    {\n      // B and C: per (step, lane)",
                     "    if (L < 0) {\n      // B and C: per (step, lane)"),),
    # no barriers between the phases of a chunk (timing only)
    "no_barriers": (
        ("    __syncthreads();       // ... for every thread; the last walk "
         "is done\n", ""),
        ("    __syncthreads();       // the f32 chunk is ready; slot ci & 1 "
         "is free\n", "")),
    # no recurrence: h_t no longer depends on h_{t-1} (the decay is still
    # computed and used)
    "no_state_update": (("h[k] = fmaf(decay, h[k], u * bc[k]);",
                         "h[k] = decay + u * bc[k];"),),
}
# name -> edits, as ABLATIONS: builds that still compute the right result
# with another choice of the kernel's parameters (--tunings)
TUNINGS: Dict[str, tuple] = {
    # the decay by ex2.approx(dt * (A * log2 e)): one FMUL and one SFU op
    "ex2_decay": (
        ("\n// cp.async of U bytes",
         "\nconstexpr float kLog2e = 1.4426950408889634f;\n"
         "__device__ __forceinline__ float ex2_approx(float v) {\n"
         "  float r;\n"
         "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(r) : \"f\"(v));\n"
         "  return r;\n"
         "}\n\n// cp.async of U bytes"),
        (" * N + n] : 0.0f;", " * N + n] * kLog2e : 0.0f;"),
        ("expf(dtv * a[k])", "ex2_approx(dtv * a[k])")),
    "chunk_16": (("constexpr int kChunk = 32;", "constexpr int kChunk = 16;"),),
    "min_blocks_4": (("constexpr int kMinBlocks = 6;",
                      "constexpr int kMinBlocks = 4;"),),
    "min_blocks_8": (("constexpr int kMinBlocks = 6;",
                      "constexpr int kMinBlocks = 8;"),),
    "unroll_4": (("#pragma unroll 8\n", "#pragma unroll 4\n"),),
    "unroll_16": (("#pragma unroll 8\n", "#pragma unroll 16\n"),),
}
# (Bt, L, D, N) of chip_smoke.py's serving shapes, bf16 x/B/C
SHAPES = {"falcon-mamba": (1, 512, 8192, 16), "zamba2": (1, 512, 4096, 64)}
TOL_BF16 = 5e-2        # tests/test_kernels.py:127


def variant_sources(tunings: bool = False) -> Dict[str, str]:
    """{variant: CUDA source}: "as_is", one per ablation and, with
    ``tunings``, one per tuning."""
    return _variants.ablated_sources(
        (_build.CSRC / "ssm_scan.cu").read_text(),
        {**ABLATIONS, **(TUNINGS if tunings else {})}, "ssm_scan.cu")


def scan_f64(x, dt, A, B, C) -> torch.Tensor:
    """y of the selective scan of these inputs in float64: the yardstick
    that the kernel's builds and the plain float32 version are held to."""
    x, dt, A, B, C = (t.double() for t in (x, dt, A, B, C))
    h = torch.zeros(x.shape[0], x.shape[2], A.shape[1], dtype=torch.float64,
                    device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + \
            (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tunings", action="store_true",
                    help="also time the TUNINGS builds (checked against "
                         "the plain version, as the build as it is)")
    args = ap.parse_args(argv)
    smi = _variants.card_line()
    print(f"[ssm-variants] {smi}", flush=True)
    libs = _variants.build_all(variant_sources(args.tunings),
                               "ssm_variants")
    for name in libs:
        report = _build.ptxas_report(
            (_build.BUILD_DIR / "ssm_variants" / f"lib{name}.ptxas.txt")
            .read_text(), lambda mangled: mangled)
        print(f"[ssm-variants] {name}: ptxas {len(report)} kernels, "
              f"{max(r for r, _, _ in report.values())} registers at most, "
              f"{sum(st for _, st, _ in report.values())} bytes of spill "
              "stores in all", flush=True)
    dev = torch.device("cuda")
    data = {key: ssm_inputs(dev, i, *shape)
            for i, (key, shape) in enumerate(SHAPES.items())}
    exact = {key: scan_f64(*a) for key, a in data.items()}
    errors: Dict[str, Dict[str, float]] = {"plain": {
        key: float((selective_scan(*a)[0].double() - exact[key]).abs().max())
        for key, a in data.items()}}
    loader = ssm._library
    times: Dict[str, Dict[str, float]] = {}
    try:
        for name, lib in libs.items():
            ssm._library = lambda lib=lib: ssm._bind(lib)
            times[name] = {}
            for key, a in data.items():
                def run(a=a):
                    return ssm.ssm_scan_cuda(*a)
                if name in ("as_is", "exp_swapped") or name in TUNINGS:
                    errors.setdefault(name, {})[key] = float(
                        (run()[0].double() - exact[key]).abs().max())
                    (y, h), (yr, hr) = run(), selective_scan(*a)
                    for got, want in ((y, yr), (h, hr)):
                        if not bool(((got - want).abs() <= TOL_BF16 * (
                                1 + want.abs())).all()):
                            raise RuntimeError(f"build {name} disagrees "
                                               f"with the plain version "
                                               f"({key})")
                times[name][key] = _variants.graph_ms(run, args.reps)
            print(f"[ssm-variants] {name}: " + ", ".join(
                f"{k} {v:.6f} ms" for k, v in times[name].items()),
                flush=True)
    finally:
        ssm._library = loader
    print("[ssm-variants] y max abs error against a float64 scan: " + "; "
          .join(f"{name} " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
                for name, e in errors.items()), flush=True)
    print(json.dumps({"card": smi, "ms": times, "y_max_abs_error_vs_f64": errors}))
    return times


if __name__ == "__main__":
    main()
