"""Where the flash kernel's bf16 time goes: the kernel as it is beside
ablated builds, each with one part of the per-tile work taken out, timed
on the card at the two evaluation shapes.

    PYTHONPATH=src python -m repro_torch.kernels.flash_variants [--reps N]
    PYTHONPATH=src python -m repro_torch.kernels.flash_variants --p-rounding

An ablated build computes a wrong result on purpose (only its time is
read); the build as it is is checked against the plain version first.
The ablations are text edits of ``csrc/flash_attention.cu`` made at run
time, so the source keeps no switches for them; an edit whose text is no
longer in the source fails loudly.  Builds go to ``build/kernels/variants``
(one ``nvcc`` per variant, all started together).  Prints the card's
``nvidia-smi`` name and power limit, then one JSON line of ms per variant
and shape.

``--p-rounding`` runs on the CPU instead and measures why the bf16 kernel
splits P: attention with its softmax weights rounded before P.V (to bf16,
to fp16, or split into bf16 hi + lo), held against the plain version by
the ratio of each output's error to the bf16 limit 2e-5 + 2^-7 |want|.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, _variants
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref

# name -> (text in the source, its replacement); all in the bf16 kernel
ABLATIONS: Dict[str, Tuple[str, str]] = {
    "no_tile_loads": (
        "      load_tile<kDk, kKeys>(sK + nxt, k, p.kss, k0 + kKeys, S, D, "
        "mp.vec_k);\n"
        "      load_tile<kDk, kKeys>(sV + nxt, v, p.vss, k0 + kKeys, S, D, "
        "mp.vec_v);\n", ""),
    "no_qk_mma": (
        "        mma_bf16(s[2 * jp], qf[kk], kb[0], kb[1]);\n"
        "        mma_bf16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);\n",
        "        s[2 * jp][0] += __uint_as_float(kb[0] & kb[2]);\n"),
    "no_pv_mma": (
        "        mma_bf16(o[2 * np], hi, vb[0], vb[1]);\n"
        "        mma_bf16(o[2 * np + 1], hi, vb[2], vb[3]);\n"
        "        mma_bf16(o[2 * np], lo, vb[0], vb[1]);\n"
        "        mma_bf16(o[2 * np + 1], lo, vb[2], vb[3]);\n",
        "        o[2 * np][0] += __uint_as_float(hi[0] ^ lo[1] ^ vb[0] ^ "
        "vb[3]);\n"),
    "no_lo_mma": (
        "        mma_bf16(o[2 * np], lo, vb[0], vb[1]);\n"
        "        mma_bf16(o[2 * np + 1], lo, vb[2], vb[3]);\n", ""),
}
# (B, S, Hq, Hkv, D, window), causal, as chip_smoke.py's phase 11
SHAPES = {"granite": (4, 2048, 32, 8, 64, 0),
          "danube": (1, 8192, 32, 8, 120, 4096)}


# the bf16 limit outside the reference's sweep (chip_smoke.py)
TOL, STEP = 2e-5, 2.0 ** -7
# (S, D, window) of the P-rounding measurement, causal, N(0, 1) bf16 inputs
P_ROUNDING_SHAPES = ((2048, 64, 0), (2048, 120, 1024))


def round_p(p: torch.Tensor, mode: str) -> torch.Tensor:
    """The f32 softmax weights as P.V would see them under ``mode``."""
    if mode == "f32":
        return p
    if mode in ("bf16", "fp16"):
        low = torch.bfloat16 if mode == "bf16" else torch.float16
        return p.to(low).float()
    if mode == "split":
        hi = p.to(torch.bfloat16).float()
        return hi + (p - hi).to(torch.bfloat16).float()
    raise ValueError(f"unknown P rounding {mode!r}")


def p_rounding_error(q, k, v, mode: str, *, causal: bool = True,
                     window: int = 0) -> Tuple[float, float]:
    """(max over outputs of error / limit, share of outputs over the
    limit) of bf16 attention whose P is rounded by ``mode`` before P.V,
    against ``flash_attention_ref``.  Dense, with the row max and sum in
    f32 as the kernel keeps them; q (B, S, Hq, D), k, v (B, S, Hkv, D)."""
    B, S, Hq, D = q.shape
    group = Hq // k.shape[2]
    kr = torch.repeat_interleave(k, group, dim=2).float()
    vr = torch.repeat_interleave(v, group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / D ** 0.5
    pos = torch.arange(S)
    ok = torch.ones((S, S), dtype=torch.bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window:
        ok &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~ok, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", round_p(p, mode), vr)
    got = (o / p.sum(dim=-1).transpose(1, 2)[..., None]).to(q.dtype)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    ratio = (got.float() - want.float()).abs() / (TOL + STEP
                                                  * want.float().abs())
    return float(ratio.max()), float((ratio > 1).float().mean())


def p_rounding_table(seed: int = 0, heads: int = 4):
    """{(S, D, window): {mode: (max error / limit, share over it)}} on the
    CPU, N(0, 1) bf16 inputs from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for S, D, window in P_ROUNDING_SHAPES:
        q, k, v = (torch.randn((1, S, heads, D), generator=gen).bfloat16()
                   for _ in range(3))
        out[(S, D, window)] = {
            mode: p_rounding_error(q, k, v, mode, window=window)
            for mode in ("f32", "bf16", "fp16", "split")}
    return out


def variant_sources() -> Dict[str, str]:
    """{variant: CUDA source}: "as_is" and one per ablation."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    return _variants.ablated_sources(
        src, {name: (edit,) for name, edit in ABLATIONS.items()},
        "flash_attention.cu")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--p-rounding", action="store_true",
                    help="measure P's rounding on the CPU instead")
    args = ap.parse_args(argv)
    if args.p_rounding:
        table = p_rounding_table()
        for (S, D, window), modes in table.items():
            print(f"[p-rounding] S={S} D={D} window={window} causal: " +
                  ", ".join(f"{m} max {r:.3f}x the limit, {share:.2%} over"
                            for m, (r, share) in modes.items()), flush=True)
        return table
    smi = _variants.card_line()
    print(f"[variants] {smi}", flush=True)
    libs = _variants.build_all(variant_sources(), "variants")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = {key: (tuple(torch.randn((B, S, h, D), generator=gen,
                                      device=dev).bfloat16()
                          for h in (Hq, Hkv, Hkv)), window)
              for key, (B, S, Hq, Hkv, D, window) in SHAPES.items()}
    loader = fa._library
    times: Dict[str, Dict[str, float]] = {}
    try:
        for name, lib in libs.items():
            fa._library = lambda lib=lib: fa._bind(lib)
            times[name] = {}
            for key, ((q, k, v), window) in inputs.items():
                def run():
                    return fa.flash_attention_cuda(q, k, v, window=window)
                if name == "as_is":
                    got = run().float()
                    want = flash_attention_ref(q, k, v, window=window).float()
                    if not bool(((got - want).abs() <= TOL + STEP
                                 * want.abs()).all()):
                        raise RuntimeError(f"the kernel as it is disagrees "
                                           f"with the plain version ({key})")
                times[name][key] = _variants.time_ms(run, args.reps)
            print(f"[variants] {name}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in times[name].items()),
                flush=True)
    finally:
        fa._library = loader
    print(json.dumps({"card": smi, "ms": times}))
    return times


if __name__ == "__main__":
    main()
