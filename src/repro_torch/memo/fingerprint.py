"""Scenario fingerprints — content addresses for solved mapping problems.

The memo's exact-hit guarantee is bit-identity: a stored schedule may be
replayed without a search ONLY when everything that determined the
computed bits is identical.  The fingerprint is a SHA-256 digest over
that set:

  scenario tables   the f32 ``FitnessParams`` leaves the evaluator reads
                    (lat/bw/energy tables, system BW, FLOPs, objective
                    code); names and provenance are excluded, so two
                    requests that analyze to identical tables share one
                    memo entry
  static config     group size, accelerator count, objective name, route
  strategy          the bound strategy's frozen-dataclass ``repr`` (name
                    + every hyper-parameter; equal configs hash equal)
  search protocol   (generations, evolve_last), derived from the budget
                    as ``plan_generations`` derives it
  generator         the row's seed under a backend tag

The route is the simulator a search runs: ``use_kernel=True`` on a card
(the makespan kernel, fed by a Philox generator), ``False`` on the CPU
(the plain version, fed by a Mersenne-Twister generator).  The two agree
only to ~1e-4 and draw different streams, so a row solved on the CPU
never exact-hits on the card and near hits stay within a route too.

:func:`scenario_digest`, :func:`family_key` and :func:`feature_vector`
give the same bytes as ``repro.memo.fingerprint`` on the same tables (the
CPU route against the reference's ``use_kernel=False``).
:func:`search_fingerprint` differs from the reference's by design: the
reference hashes raw threefry key words, the port its seed under the
``torch|rng=...`` tag, so no record exact-hits across the two packages.

Near hits relax the tables: :func:`family_key` keeps only the shape +
task-family axes a transferred population is valid across (same ``(G,
A)``, strategy, objective, route — Section V-C's transfer argument), and
:func:`feature_vector` summarizes the tables so the nearest stored
scenario (L2 over log-scale column statistics) donates its converged
population.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

from repro_torch.core.encoding import to_host
from repro_torch.core.fitness import FitnessParams, objective_token


def strategy_signature(strategy) -> str:
    """Stable identity of a bound strategy: frozen dataclasses repr as
    ``Name(field=value, ...)``, so equal configs produce equal signatures
    and any hyper-parameter change produces a new one.  A strategy that
    draws its generations from a stream of its own (``draw_stream``:
    MAGMA's counter-based Philox4x32-10, ``repro_torch.kernels.draws``)
    names it too, so a record of an earlier stream never exact-hits."""
    stream = getattr(strategy, "draw_stream", None)
    return repr(strategy) + (f"|draws={stream}" if stream else "")


def _table_bytes(params: FitnessParams) -> bytes:
    """The evaluator-visible scenario content, canonicalized: every leaf
    as little-endian f32 bytes, plus the objective code as i32."""
    lat, bw, bw_sys, flops, energy, code = to_host(*params)
    h = [np.ascontiguousarray(np.asarray(leaf, dtype=np.float32))
         .astype("<f4").tobytes()
         for leaf in (lat, bw, bw_sys, flops, energy)]
    h.append(np.asarray(code, dtype=np.int32).astype("<i4").tobytes())
    return b"".join(h)


def scenario_digest(params: FitnessParams, *, num_accels: int,
                    use_kernel: bool, objective) -> str:
    """Digest of one scenario's cost-relevant content (no search axes).

    ``use_kernel`` is the route (True on a card).  ``objective`` may be a
    bare name, an ``ObjectiveSpec``, or None (the dynamic select); it is
    canonicalized to its token.
    """
    sha = hashlib.sha256()
    G, A = int(params.lat.shape[-2]), int(params.lat.shape[-1])
    sha.update(f"scenario|G={G}|A={A}|num_accels={num_accels}"
               f"|kernel={bool(use_kernel)}"
               f"|objective={objective_token(objective)}"
               .encode())
    sha.update(_table_bytes(params))
    return sha.hexdigest()


def generator_tag(seed: int, use_kernel: bool) -> str:
    """The backend tag of a row's generator: PyTorch's Philox on a card,
    its Mersenne Twister on the CPU, seeded with ``seed``."""
    rng = "philox" if use_kernel else "mt19937"
    return f"torch|rng={rng}|seed={int(seed)}"


def search_fingerprint(params: FitnessParams, seed: int, strategy, *,
                       generations: int, evolve_last: bool,
                       use_kernel: bool, objective) -> str:
    """Content address of one (scenario, strategy, protocol, seed, route)
    row."""
    sha = hashlib.sha256()
    sha.update(scenario_digest(params, num_accels=strategy.num_accels,
                               use_kernel=use_kernel,
                               objective=objective).encode())
    sha.update(f"|{strategy_signature(strategy)}"
               f"|gens={int(generations)}|last={bool(evolve_last)}|"
               .encode())
    sha.update(generator_tag(seed, use_kernel).encode())
    return sha.hexdigest()


def family_key(params: FitnessParams, strategy, *, use_kernel: bool,
               objective, family: str = "") -> Tuple:
    """The transfer-validity class of a scenario (near-hit candidates).

    A converged population is transferable across scenarios that share
    the encoding shape and the task-type distribution: same ``(G, A)``,
    same strategy *kind* (the genome layout), same objective and route,
    same task family string (``JobGroup.task`` — "" when the caller has
    no provenance, which still groups by shape).
    """
    G, A = int(params.lat.shape[-2]), int(params.lat.shape[-1])
    return (strategy.name, G, A, bool(use_kernel),
            str(objective_token(objective)), str(family))


def feature_vector(params: FitnessParams) -> np.ndarray:
    """Compact table summary for nearest-fingerprint lookup.

    Per accelerator column: mean/std/min/max of log10 latency and of
    log10 required BW, plus the log10 system BW and log10 total FLOPs —
    ``(8A + 2,)`` float64.  Log scale because the tables span decades
    (1 GB/s vs 64 GB/s scenarios must be *far*, not negligibly close to
    everything).  Same family => same ``A`` => same length, so L2
    distance is well-defined within a family.
    """
    def col_stats(x):
        lx = np.log10(np.maximum(np.asarray(x, dtype=np.float64), 1e-30))
        return np.concatenate([lx.mean(0), lx.std(0), lx.min(0), lx.max(0)])

    lat, bw, bw_sys, flops, _, _ = to_host(*params)
    extras = np.log10(np.maximum(np.asarray(
        [float(bw_sys), float(flops)], dtype=np.float64), 1e-30))
    return np.concatenate([col_stats(lat), col_stats(bw), extras])
