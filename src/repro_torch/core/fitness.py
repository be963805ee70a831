"""Fitness evaluation — decode + BW-allocate + objective, over populations.

The evaluator is built once per (Job Analysis Table, system BW, objective)
and then called inside the optimization loop on whole (P, G) populations.

Two call forms exist:

  - ``FitnessFn(...)`` — the object-style evaluator the mappers use.
  - ``evaluate_params(params, accel, prio, ...)`` — a functional form over
    the scenario data (``FitnessParams``: lat/bw tables, system BW, FLOPs,
    objective code) held as tensors.

Objectives (Section IV-C) are registry-backed: :func:`register_objective`
adds a named column function, and an :class:`ObjectiveSpec` names one or
several registered objectives.  A scalar spec evaluates through
:func:`evaluate_params`; a multi-column spec evaluates through
:func:`evaluate_objectives` to a ``(P, M)`` objective matrix.

Makespans always go through ``repro_torch.kernels.ops.population_makespan``:
on a CUDA device that is the hand-written makespan kernel, on the CPU its
plain PyTorch version.  ``FitnessFn.use_kernel`` is accepted for signature
parity with ``repro.core.fitness`` and changes nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.bw_allocator import throughput
from repro_torch.core.job_analyzer import JobAnalysisTable
from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------------------
# objective registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ObjectiveInfo:
    """Registry entry: one named objective column.

    ``fn(params, ms, en) -> (P,)`` maps the scenario data plus the
    per-candidate makespans ``ms`` (None when ``needs_makespan`` is False)
    and total energies ``en`` (None when ``needs_energy`` is False) to a
    higher-is-better fitness column.  ``code`` is the stable integer the
    dynamic (per-scenario) select dispatches on; codes are assigned in
    registration order and never reassigned.
    """
    name: str
    code: int
    fn: Callable[..., torch.Tensor]
    needs_energy: bool = False
    needs_makespan: bool = True
    description: str = ""


_OBJECTIVES: Dict[str, ObjectiveInfo] = {}


def register_objective(name: str, fn: Callable[..., torch.Tensor], *,
                       needs_energy: bool = False,
                       needs_makespan: bool = True,
                       description: str = "",
                       overwrite: bool = False) -> ObjectiveInfo:
    """Register a named objective column.

    ``fn(params, ms, en)`` maps a ``FitnessParams`` plus the shared
    per-candidate makespans/energies to a ``(P,)`` higher-is-better column.
    Re-registering an existing name requires ``overwrite=True`` and keeps
    its code.
    """
    if name in _OBJECTIVES:
        if not overwrite:
            raise ValueError(f"objective {name!r} is already registered")
        code = _OBJECTIVES[name].code
    else:
        code = len(_OBJECTIVES)
    info = ObjectiveInfo(name=name, code=code, fn=fn,
                         needs_energy=bool(needs_energy),
                         needs_makespan=bool(needs_makespan),
                         description=description)
    _OBJECTIVES[name] = info
    return info


def objective_info(name: str) -> ObjectiveInfo:
    """Metadata for a registered objective; unknown names raise a
    ``ValueError`` listing what is registered."""
    if name not in _OBJECTIVES:
        raise ValueError(
            f"unknown objective {name!r}; registered objectives: "
            f"{', '.join(available_objectives())}")
    return _OBJECTIVES[name]


def available_objectives() -> Tuple[str, ...]:
    """Registered objective names in code (registration) order."""
    return tuple(sorted(_OBJECTIVES, key=lambda n: _OBJECTIVES[n].code))


def registered_objectives() -> Tuple[ObjectiveInfo, ...]:
    """All registry entries in code order (the dynamic-select order)."""
    return tuple(sorted(_OBJECTIVES.values(), key=lambda i: i.code))


# the paper's four (Section IV-C), at codes 0..3 as in repro.core.fitness
register_objective(
    "throughput", lambda params, ms, en: throughput(params.flops, ms),
    description="group FLOPs / makespan (the paper's default)")
register_objective(
    "latency", lambda params, ms, en: -ms,
    description="negated makespan")
register_objective(
    "energy", lambda params, ms, en: -en,
    needs_energy=True, needs_makespan=False,
    description="negated total assignment energy (order-free)")
register_objective(
    "edp", lambda params, ms, en: -en * ms,
    needs_energy=True,
    description="negated energy-delay product")


# ---------------------------------------------------------------------------
# ObjectiveSpec
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """A frozen, registry-backed objective: one or more named columns."""
    names: Tuple[str, ...]

    def __post_init__(self):
        names = tuple(self.names)
        object.__setattr__(self, "names", names)
        if not names:
            raise ValueError("ObjectiveSpec needs at least one objective")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objectives in {names}")
        for n in names:
            objective_info(n)        # raises listing what is registered

    @property
    def num_objectives(self) -> int:
        return len(self.names)

    @property
    def is_scalar(self) -> bool:
        return len(self.names) == 1

    @property
    def token(self) -> str:
        """Canonical string identity: the bare name for a scalar spec,
        ``pareto:a+b`` for a multi-column one."""
        if self.is_scalar:
            return self.names[0]
        return "pareto:" + "+".join(self.names)

    @property
    def needs_energy(self) -> bool:
        return any(objective_info(n).needs_energy for n in self.names)

    @property
    def codes(self) -> Tuple[int, ...]:
        return tuple(objective_info(n).code for n in self.names)

    def infos(self) -> Tuple[ObjectiveInfo, ...]:
        return tuple(objective_info(n) for n in self.names)


ObjectiveLike = Union[str, Sequence[str], ObjectiveSpec, None]


def as_objective_spec(objective: ObjectiveLike) -> Optional[ObjectiveSpec]:
    """Coerce a bare name / name sequence / spec to an ``ObjectiveSpec``
    (``None`` stays ``None`` — the dynamic per-scenario select)."""
    if objective is None or isinstance(objective, ObjectiveSpec):
        return objective
    if isinstance(objective, str):
        return ObjectiveSpec((objective,))
    return ObjectiveSpec(tuple(objective))


def objective_token(objective: ObjectiveLike) -> Optional[str]:
    """The canonical string the memo keys on: scalar specs and bare names
    collapse to the same token (``None`` passes through)."""
    spec = as_objective_spec(objective)
    return None if spec is None else spec.token


class FitnessParams(NamedTuple):
    """Scenario data — everything the fitness needs besides genomes —
    as tensors on the search's device.  Stacked for R scenarios (a sweep
    chunk), every field gains a leading R axis: lat/bw/energy (R, G, A),
    bw_sys/flops/objective_code (R,) (objective_code (R, M) for a
    multi-column spec)."""
    lat: torch.Tensor             # (G, A) f32 no-stall latencies
    bw: torch.Tensor              # (G, A) f32 required bandwidths
    bw_sys: torch.Tensor          # ()     f32 system bandwidth
    flops: torch.Tensor           # ()     f32 total group FLOPs
    energy: torch.Tensor          # (G, A) f32 (zeros when table has none)
    objective_code: torch.Tensor  # () i32 registry code — (M,) for a
    #                               multi-column ObjectiveSpec


def _row_view(params: FitnessParams) -> FitnessParams:
    """Per-row scalars as (R, 1), so that an objective column
    ``fn(params, ms, en)`` broadcasts them over each row's (R, P)
    candidates exactly as over a single scenario's (P,)."""
    if params.lat.dim() == 2:          # one scenario, no row axis
        return params
    return params._replace(bw_sys=params.bw_sys[:, None],
                           flops=params.flops[:, None],
                           objective_code=params.objective_code[:, None])


# lint: dispatch
def population_energies(energy: torch.Tensor,
                        accel: torch.Tensor) -> torch.Tensor:
    """Total group energy (J) of each assignment — order-free (Section
    IV-C alternative objectives): (G, A) tables with (P, G) genomes give
    (P,); (R, G, A) with (R, P, G) give (R, P)."""
    if energy.dim() == 2:
        jobs = torch.arange(energy.shape[0], device=energy.device)
        return energy[jobs, accel.long()].sum(dim=-1)
    R, P, G = accel.shape
    rows = torch.arange(R, device=energy.device)[:, None, None]
    jobs = torch.arange(G, device=energy.device)[None, None, :]
    return energy[rows, jobs, accel.long()].sum(dim=-1)


# lint: dispatch
def _population_makespans(params: FitnessParams, accel, prio, *,
                          num_accels: int) -> torch.Tensor:
    return kops.population_makespan(accel, prio, params.lat, params.bw,
                                    params.bw_sys, num_accels)


# lint: dispatch
def evaluate_params(params: FitnessParams, accel: torch.Tensor,
                    prio: torch.Tensor, *, num_accels: int,
                    objective: ObjectiveLike = None) -> torch.Tensor:
    """(P,) fitness values — higher is better for every objective — or
    (R, P) for R stacked scenarios (``params`` with a leading row axis,
    genomes (R, P, G)).

    ``objective`` may be a registered name (or a 1-column
    ``ObjectiveSpec``), in which case only that column is computed, or
    ``None``, in which case the column is selected element-wise by
    ``params.objective_code``.  Multi-column specs go through
    :func:`evaluate_objectives` instead.
    """
    spec = as_objective_spec(objective)
    # lint: disable=L002(the objective spec is a host object)
    if spec is not None and not spec.is_scalar:
        raise ValueError(
            f"evaluate_params is scalar; objective {spec.token!r} has "
            f"{spec.num_objectives} columns — use evaluate_objectives")
    if spec is not None:
        info = objective_info(spec.names[0])
        # lint: disable=L002(the objective spec is a host object)
        ms = (_population_makespans(params, accel, prio,
                                    num_accels=num_accels)
              if info.needs_makespan else None)
        # lint: disable=L002(the objective spec is a host object)
        en = (population_energies(params.energy, accel)
              if info.needs_energy else None)
        return info.fn(_row_view(params), ms, en)

    # dynamic objective: select on the code over every registered column;
    # walking the columns backwards gives the first matching code priority
    ms = _population_makespans(params, accel, prio, num_accels=num_accels)
    en = population_energies(params.energy, accel)
    infos = registered_objectives()
    params = _row_view(params)
    code = params.objective_code
    out = infos[-1].fn(params, ms, en)
    for info in reversed(infos[:-1]):
        out = torch.where(code == info.code, info.fn(params, ms, en), out)
    return out


# lint: dispatch
def evaluate_objectives(params: FitnessParams, accel: torch.Tensor,
                        prio: torch.Tensor, *, num_accels: int,
                        objective: ObjectiveLike = None) -> torch.Tensor:
    """(P, M) objective matrix ((R, P, M) for stacked scenarios) —
    column ``j`` is ``objective.names[j]``,
    higher is better, and equal to the scalar :func:`evaluate_params` of
    that name alone (the shared makespans/energies are computed once).

    ``objective`` must coerce to a static ``ObjectiveSpec``.
    """
    spec = as_objective_spec(objective)
    if spec is None:
        raise ValueError(
            "evaluate_objectives needs a static ObjectiveSpec (or name "
            "sequence); the dynamic objective=None form is scalar-only")
    infos = spec.infos()
    # lint: disable=L002(the objective spec is a host object)
    ms = (_population_makespans(params, accel, prio, num_accels=num_accels)
          if any(i.needs_makespan for i in infos) else None)
    # lint: disable=L002(the objective spec is a host object)
    en = (population_energies(params.energy, accel)
          if any(i.needs_energy for i in infos) else None)
    view = _row_view(params)
    return torch.stack([info.fn(view, ms, en) for info in infos], dim=-1)


def stack_fitness_params(fns: Sequence["FitnessFn"]) -> FitnessParams:
    """Stack the params of several same-shape FitnessFns along axis 0."""
    if not fns:
        raise ValueError("need at least one scenario")
    G, A = fns[0].params.lat.shape
    for f in fns[1:]:
        if tuple(f.params.lat.shape) != (G, A):
            raise ValueError(
                f"scenario tables must share (G, A)={G, A}; "
                f"got {tuple(f.params.lat.shape)}")
        if f.num_accels != fns[0].num_accels:
            raise ValueError("scenarios must share num_accels")
    return FitnessParams(*(torch.stack([f.params[i].cpu() for f in fns])
                           for i in range(len(FitnessParams._fields))))


class ProblemSpec(NamedTuple):
    """A normalized scenario batch: the stacked tables (on the host, so
    that a sweep copies each chunk to the card as it needs it) plus what
    a row search is specialized on.

    ``objective`` is the shared ``ObjectiveSpec`` when every scenario
    agrees, else ``None`` (the per-row select on ``objective_code``).
    The reference's ``use_kernel`` field is dropped: the device decides
    (the makespan kernel on a card, its plain version on the CPU), so
    every row of a batch takes the same simulator by construction."""
    params: FitnessParams
    num_accels: int
    objective: Optional[ObjectiveSpec]


def normalize_scenarios(scenarios, num_accels: Optional[int] = None
                        ) -> ProblemSpec:
    """Validate a scenario grid into a :class:`ProblemSpec`.

    ``scenarios`` is either an already-stacked ``FitnessParams`` (leading
    scenario axis; ``num_accels`` required) or a sequence of same-shape
    ``FitnessFn``s, which are stacked here.
    """
    if isinstance(scenarios, FitnessParams):
        if num_accels is None:
            raise ValueError("num_accels is required with raw FitnessParams")
        return ProblemSpec(FitnessParams(*(t.cpu() for t in scenarios)),
                           num_accels, None)
    fns = list(scenarios)
    # resolve the shared objective BEFORE stacking: a mixed multi/scalar
    # batch must fail with the objective diagnosis, not a shape error from
    # stacking ()-vs-(M,) objective_code leaves
    specs = {f.objective_spec for f in fns}
    if len(specs) == 1:
        objective = specs.pop()
    else:
        if any(not s.is_scalar for s in specs):
            raise ValueError(
                "a scenario batch with mixed objectives falls back to the "
                "dynamic per-scenario select, which is scalar-only; "
                "multi-column ObjectiveSpec scenarios must all share one "
                f"spec (got {sorted(s.token for s in specs)})")
        objective = None
    return ProblemSpec(stack_fitness_params(fns), fns[0].num_accels,
                       objective)


@dataclasses.dataclass
class FitnessFn:
    """The evaluator of one scenario, with its tables on ``device``.

    ``use_kernel`` is kept for signature parity with
    ``repro.core.fitness.FitnessFn``: on a CUDA device the makespans always
    go through the hand-written kernel, on the CPU through its plain
    PyTorch version.
    """
    table: JobAnalysisTable
    bw_sys: float
    # a registered name ('throughput' | 'latency' | 'energy' | 'edp' | any
    # register_objective'd name), a sequence of names, or an ObjectiveSpec
    objective: ObjectiveLike = "throughput"
    use_kernel: bool = False
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.bw_sys = float(self.bw_sys)
        self.device = torch.device(self.device)
        spec = as_objective_spec(self.objective)
        if spec is None:
            raise ValueError("FitnessFn needs a concrete objective "
                             "(name, name sequence, or ObjectiveSpec)")
        self.objective_spec = spec
        self._A = int(self.table.num_accels)
        has_energy = getattr(self.table, "energy", None) is not None
        if spec.needs_energy and not has_energy:
            raise ValueError(
                f"objective {spec.token!r} needs an energy column, "
                "but the job analysis table has none")
        codes = spec.codes

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        lat = f32(self.table.lat)
        self.params = FitnessParams(
            lat=lat,
            bw=f32(self.table.bw),
            bw_sys=f32(self.bw_sys),
            flops=f32(float(self.table.total_flops)),
            energy=f32(self.table.energy) if has_energy
            else torch.zeros_like(lat),
            objective_code=torch.as_tensor(
                codes[0] if spec.is_scalar else codes, dtype=torch.int32,
                device=self.device),
        )

    def makespans(self, accel: torch.Tensor, prio: torch.Tensor
                  ) -> torch.Tensor:
        return _population_makespans(self.params, accel, prio,
                                     num_accels=self._A)

    def energies(self, accel: torch.Tensor) -> torch.Tensor:
        """(P,) total group energy (J) of each assignment — order-free
        (Section IV-C alternative objectives)."""
        if getattr(self.table, "energy", None) is None:
            raise ValueError("the job analysis table has no energy column")
        return population_energies(self.params.energy, accel)

    def __call__(self, accel: torch.Tensor, prio: torch.Tensor
                 ) -> torch.Tensor:
        """(P,) fitness values — higher is better for every objective.
        Scalar specs only; a multi-column spec evaluates via
        :meth:`objectives`."""
        return evaluate_params(self.params, accel, prio,
                               num_accels=self._A,
                               objective=self.objective_spec)

    def objectives(self, accel: torch.Tensor, prio: torch.Tensor
                   ) -> torch.Tensor:
        """(P, M) objective matrix for this scenario's spec (M=1 for a
        scalar spec)."""
        return evaluate_objectives(self.params, accel, prio,
                                   num_accels=self._A,
                                   objective=self.objective_spec)

    @property
    def num_objectives(self) -> int:
        return self.objective_spec.num_objectives

    @property
    def num_accels(self) -> int:
        return self._A

    @property
    def group_size(self) -> int:
        return self.table.group_size
