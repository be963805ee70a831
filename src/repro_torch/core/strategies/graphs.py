"""The shared ask/tell loop as a CUDA graph: the card's counterpart of
the reference's whole-search ``lax.scan`` under ``jit``.

The reference runs every device-resident search as one compiled program
(``repro.core.strategies.driver``: the whole loop one ``lax.scan`` under
``jax.jit``, one asynchronous call a search).  The port captures a
search's whole generation loop -- each generation ask -> evaluate ->
fold best -> history -> tell -- once per shape as a CUDA graph and
replays it, so the host issues one graph launch a search instead of
every operation of every generation:

* :class:`GenerationStep` is the static-buffer step.  It reads the carry
  (the strategy state's tensors, which hold the current population, and
  the best-so-far ``bf`` / ``ba`` / ``bp``) and the fitness tables from
  fixed tensors and writes the next carry back into them with ``copy_``.
  The strategies stay functional: what ``tell`` returns is copied into
  the static state.  The fold and the tell are those of
  ``driver.scan_steps``.  A search loads its tables, initial state and
  generator states into the step, runs its span(s), and takes copies of
  the carry out after the last.
* A *span* is ``(n, tell_last)``: n generations, each telling except
  the last when ``tell_last`` is False (a spent budget), each writing
  its best-so-far into column j of the step's static ``(R, n)``
  history of that span.  A search is one span of all its generations
  (:func:`plan_spans`), or spans of K generations and a remainder where
  a strategy sets ``graph_span = K``; K = 1 is one graph a generation.
* On a card a span is captured before its first replay: a warm
  generation runs eagerly on the loaded state (the kernels' libraries
  are built and loaded, the operator CDF copied to the card once, the
  allocator's first blocks made), its kernel launches counted in
  ``makespan.LAUNCHES`` (and MAGMA's ``draws.LAUNCHES``) like any
  other; the state is loaded again and the span captured on a side
  stream (``capture_error_mode="thread_local"``: the stream's and the
  fleet's other threads may use the card meanwhile).  The loop itself
  is not run eagerly first.  A step's spans share one memory pool: each
  writes only into the static carry and its own history, so any may run
  after any other.  On the CPU, and on a card through
  ``driver._search(capture=False)``, the same span runs eagerly: the
  plain version.  Nothing falls back: a capture
  that fails raises.
* A graph reads every tensor it was captured with by its address, so
  each must live as long as the step: the step owns its carry, tables,
  histories and generators, and a constant the body takes from a cache
  (MAGMA's operator CDF, ``magma._operator_cdf``) comes from one that
  never evicts.
* MAGMA draws a generation from its state's key and counter in one
  kernel launch that reads both from device memory
  (``repro_torch.kernels.draws``): the carry holds them like any other
  state tensor.  The other strategies draw each row from its own
  ``torch.Generator``.  A step owns R generators, registered to its
  graphs; a search copies its rows' generator states into them before
  its first span and back after its last, so a graph captured under
  one search's seeds serves any other's.  Under capture a random kernel
  reads its seed and base offset from device memory that each replay
  first fills from the generator's state (two small fills a row), and
  the replay advances the generator by the sum of the increments the
  captured calls made: the same increments the eager calls make, so a
  replay draws bitwise what the eager generations draw.
* Steps are cached by :class:`StepKey`: the strategy (by value: equal
  configurations share a step), R, P, G, A, the objective, whether it
  is multi-objective, the device and the tables' and state's shapes; a
  step holds one graph a span, so a graph's key is the ``StepKey`` and
  ``(n, tell_last)``.  A stream's compatibility key fixes the budget,
  so it warms one graph a (compatibility key, bucket), as the reference
  compiles one executable a (key, bucket).  ``scan_steps`` yields after
  each span, so ``run_interleaved`` issues one replay a shard in turn.
  A loop checks a step out and returns it once its last span is issued,
  so two loops of one key live at once (two shards on one card) get a
  step each.  :func:`clear` drops the cache.
* A capture is the port's compile event: it is reported as
  ``"cuda graph <key label> gens=<n>"`` through
  ``repro_torch.kernels._build.notify_compile``, which
  ``RecompileGuard`` counts.  The kernels' launches inside a capture go
  to the graph's own count (``_build.counted_into``), which each replay
  adds to their counts (``makespan.LAUNCHES``, ``draws.LAUNCHES``): one
  launch a generation each, as eagerly.  :func:`totals` counts the
  captures, the warm generations' launches and the spans run, so a
  check can hold ``makespan.LAUNCHES`` to its generations plus one warm
  generation a capture; :func:`tells` counts each strategy's tells that
  ran (spans, warm generations and ``driver``'s host-stepped loop), so a
  check can hold ``draws.LAUNCHES`` to MAGMA's.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.encoding import take_rows
from repro_torch.core.fitness import (FitnessParams, ObjectiveSpec,
                                      evaluate_objectives, evaluate_params)
from repro_torch.kernels import _build

__all__ = ["StepKey", "GenerationStep", "row_eval_fn", "step_key",
           "plan_spans", "checkout", "checkin", "steps_info", "totals",
           "tells", "count_tells", "clear"]

#: (n, tell_last): n generations, the last telling only when tell_last
Span = Tuple[int, bool]


def plan_spans(generations: int, tell_last: bool,
               span: Optional[int] = None) -> List[Span]:
    """The spans a loop of ``generations`` runs, in order: one of all of
    them (``span`` None), else ``span`` generations each and a remainder;
    only the loop's last generation may skip its tell."""
    k = generations if span is None else max(1, min(int(span), generations))
    full, rest = divmod(generations, k)
    spans = [(k, True)] * full + ([(rest, True)] if rest else [])
    spans[-1] = (spans[-1][0], tell_last)
    return spans


def row_eval_fn(strategy, params: FitnessParams,
                objective: Optional[ObjectiveSpec]):
    """(R, P, G) genomes -> (R, P) fitness, or the (R, P, M) objective
    matrix for a multi-objective strategy, over row-stacked ``params``.
    ``objective`` None selects each row's column by its objective code."""
    if getattr(strategy, "multi_objective", False):
        def eval_fn(accel, prio):
            return evaluate_objectives(params, accel, prio,
                                       num_accels=strategy.num_accels,
                                       objective=objective)
    else:
        def eval_fn(accel, prio):
            return evaluate_params(params, accel, prio,
                                   num_accels=strategy.num_accels,
                                   objective=objective)
    return eval_fn


def _is_gens(value) -> bool:
    return (isinstance(value, tuple) and len(value) > 0
            and all(isinstance(g, torch.Generator) for g in value))


def state_tensors(state) -> List[torch.Tensor]:
    """The tensors of a strategy state (a NamedTuple of tensors and one
    tuple of row generators), in field order."""
    if not (isinstance(state, tuple) and hasattr(state, "_fields")):
        raise TypeError(f"a strategy state must be a NamedTuple; got "
                        f"{type(state).__name__}")
    out = []
    for name, value in zip(state._fields, state):
        if isinstance(value, torch.Tensor):
            out.append(value)
        elif not _is_gens(value):
            raise TypeError(
                f"{type(state).__name__}.{name} is a "
                f"{type(value).__name__}: the generation step carries "
                "tensors and the row generators only")
    return out


def state_gens(state) -> Tuple[torch.Generator, ...]:
    """The row generators a strategy state carries."""
    found = [value for value in state if _is_gens(value)]
    if len(found) != 1:
        raise TypeError(f"{type(state).__name__} must carry one tuple of "
                        f"row generators; found {len(found)}")
    return found[0]


def with_tensors(state, tensors, gens):
    """``state`` with its tensors replaced, in order, by ``tensors`` and
    its generators by ``gens``."""
    it = iter(tensors)
    return type(state)(*(tuple(gens) if _is_gens(v) else next(it)
                         for v in state))


class StepKey(NamedTuple):
    """What a captured generation is specialised on."""
    strategy: object                   # bound; a frozen dataclass
    rows: int                          # R
    ask_size: int                      # P
    group_size: int                    # G
    num_accels: int                    # A
    objective: Optional[ObjectiveSpec]  # None: each row's own code
    multi_objective: bool
    device: str
    tensors: Tuple                     # (shape, dtype) of tables + state

    def label(self) -> str:
        obj = "per-row" if self.objective is None else self.objective.token
        return (f"{self.strategy.name} R={self.rows} P={self.ask_size} "
                f"G={self.group_size} A={self.num_accels} {obj} "
                f"{self.device}")


def step_key(strategy, params: FitnessParams, state,
             objective: Optional[ObjectiveSpec], group_size: int
             ) -> StepKey:
    tensors = list(params) + state_tensors(state)
    return StepKey(
        strategy=strategy, rows=int(params.lat.shape[0]),
        ask_size=strategy.ask_size, group_size=group_size,
        num_accels=strategy.num_accels, objective=objective,
        multi_objective=bool(getattr(strategy, "multi_objective", False)),
        device=str(params.lat.device),
        tensors=tuple((tuple(t.shape), t.dtype) for t in tensors))


class GenerationStep:
    """The static-buffer generation step of one :class:`StepKey` (see the
    module docstring), with a CUDA graph a span once captured."""

    def __init__(self, key: StepKey, strategy, params: FitnessParams,
                 state, objective: Optional[ObjectiveSpec]):
        dev = params.lat.device
        R, G = key.rows, key.group_size
        self.key, self.strategy, self.device = key, strategy, dev
        self.multi_objective = key.multi_objective
        self.params = FitnessParams(*(torch.empty_like(x) for x in params))
        self.gens = tuple(torch.Generator(device=dev) for _ in range(R))
        self.state = with_tensors(
            state, [torch.empty_like(t) for t in state_tensors(state)],
            self.gens)
        self.bf = torch.empty((R,), dtype=torch.float32, device=dev)
        self.ba = torch.empty((R, G), dtype=torch.int32, device=dev)
        self.bp = torch.empty((R, G), dtype=torch.float32, device=dev)
        self.carry = state_tensors(self.state) + [self.bf, self.ba, self.bp]
        self._storages = {t.untyped_storage().data_ptr() for t in self.carry}
        self.eval_fn = row_eval_fn(strategy, self.params, objective)
        # span -> its (R, n) history; span -> (graph, the kernel launches
        # captured into it)
        self.hists: Dict[Span, torch.Tensor] = {}
        self.graphs: Dict[Span, Tuple[torch.cuda.CUDAGraph,
                                      Dict[str, int]]] = {}
        self.nodes: Dict[Span, int] = {}     # span -> its graph's nodes
        self.pool = None
        self.captures: List[dict] = []
        self.busy = False                  # @locked:_LOCK

    # lint: dispatch
    def load(self, state, params: FitnessParams) -> None:
        """A search's tables, initial state and generator states in; the
        best-so-far reset."""
        for dst, src in zip(self.params, params):
            dst.copy_(src)
        for dst, src in zip(state_tensors(self.state), state_tensors(state)):
            dst.copy_(src)
        self.bf.fill_(float("-inf"))
        self.ba.zero_()
        self.bp.zero_()
        for mine, theirs in zip(self.gens, state_gens(state)):
            mine.set_state(theirs.get_state())

    # lint: dispatch
    def body(self, tell: bool) -> None:
        """One generation on the static carry, the next carry copied in."""
        self._store(*self.generation(self.state, self.bf, self.ba, self.bp,
                                     tell))

    # lint: dispatch
    def span_body(self, span: Span) -> None:
        """The span's generations on the static carry, each one's
        best-so-far into its column of the span's history."""
        n, tell_last = span
        hist = self.hist(span)
        for j in range(n):
            self.body(j + 1 < n or tell_last)
            hist[:, j] = self.bf

    def hist(self, span: Span) -> torch.Tensor:
        """The span's static (R, n) history, made on first use."""
        if span not in self.hists:
            self.hists[span] = torch.empty((self.key.rows, span[0]),
                                           dtype=torch.float32,
                                           device=self.device)
        return self.hists[span]

    # lint: dispatch
    def generation(self, state, bf, ba, bp, tell: bool):
        """ask -> evaluate -> fold best -> tell (when ``tell``) over a
        carry: the next ``(state, [bf, ba, bp])``."""
        state, accel, prio = self.strategy.ask(state)
        fit = self.eval_fn(accel, prio)
        col = fit[..., 0] if self.multi_objective else fit
        i = torch.argmax(col, dim=-1, keepdim=True)          # (R, 1)
        top = torch.gather(col, 1, i)[:, 0]
        better = top > bf
        bf = torch.where(better, top, bf)
        ba = torch.where(better[:, None], take_rows(accel, i)[:, 0], ba)
        bp = torch.where(better[:, None], take_rows(prio, i)[:, 0], bp)
        if tell:
            state = self.strategy.tell(state, fit)
        return state, [bf, ba, bp]

    # lint: dispatch
    def _store(self, state, best: List[torch.Tensor]) -> None:
        if state_gens(state) is not self.gens:
            raise RuntimeError(f"{type(state).__name__} came back with "
                               "other generators than the step's")
        values = state_tensors(state) + best
        srcs = []
        for dst, src in zip(self.carry, values):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise TypeError(
                    f"{self.key.strategy.name}: a state tensor came back "
                    f"{tuple(src.shape)} {src.dtype}, the carry holds "
                    f"{tuple(dst.shape)} {dst.dtype}")
            # a view of the carry (DE's tell hands its trial back) is
            # copied first: a copy before it may overwrite what it reads
            # lint: disable=L002(a storage address is host metadata)
            if src is not dst and \
                    src.untyped_storage().data_ptr() in self._storages:
                src = src.clone()
            srcs.append(src)
        for dst, src in zip(self.carry, srcs):
            if src is not dst:
                dst.copy_(src)

    def prepare(self, spans: Sequence[Span], state,
                params: FitnessParams) -> None:
        """Capture the graphs of ``spans`` the step lacks, the step
        loaded with ``state`` / ``params`` (and so again after)."""
        for span in dict.fromkeys(spans):
            if span in self.graphs:
                continue
            warm: Dict[str, int] = {}
            tell = span[0] > 1 or span[1]
            with _build.counted_into(warm):      # the warm generation
                self.body(tell)
            _build.add_launches(warm)
            count_tells(self.key.strategy.name, self.device,
                        1 if tell else 0)
            self.load(state, params)
            self._capture(span, warm)

    def _capture(self, span: Span, warm: Dict[str, int]) -> None:
        dev = self.device
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.gens:
            graph.register_generator_state(gen)
        self.hist(span)                      # outside the graph's pool
        launches: Dict[str, int] = {}
        with _CAPTURE_LOCK, torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            with torch.cuda.stream(side), _build.counted_into(launches):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    self.span_body(span)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass              # the body's error is the one to see
                    raise
                graph.capture_end()
            nodes = _node_count(graph)
            graph.instantiate()
            seconds = time.perf_counter() - t0
            pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            torch.cuda.current_stream(dev).wait_stream(side)
        if self.pool is None:
            self.pool = graph.pool()
        self.graphs[span] = (graph, launches)
        self.nodes[span] = nodes or 0
        label = f"{self.key.label()} gens={span[0]}" + (
            "" if span[1] else " last")
        self.captures.append({"label": label, "generations": span[0],
                              "seconds": seconds, "nodes": nodes,
                              "pool_bytes": pool_bytes,
                              "launches": dict(launches),
                              "warm_launches": dict(warm)})
        with _LOCK:
            _TOTALS["captures"] += 1
            _TOTALS["warm_launches"] += warm.get("makespan", 0)
        _build.notify_compile("cuda graph " + label, seconds)

    # lint: dispatch
    def run(self, span: Span, capture: bool) -> torch.Tensor:
        """The span: a replay of its graph, or its eager body; returns
        its static history (valid until the step's next run)."""
        if capture:
            graph, launches = self.graphs[span]
            graph.replay()
            _build.add_launches(launches)
        else:
            self.span_body(span)
        with _LOCK:
            _TOTALS["runs"] += 1
        n, tell_last = span
        # lint: disable=L002(a span is a host tuple)
        told = n if tell_last else n - 1
        count_tells(self.key.strategy.name, self.device, told)
        return self.hists[span]

    # lint: dispatch
    def unload(self, gens):
        """Copies of the carry out: ``(bf, ba, bp, state)``, the state
        carrying ``gens``, which are set to where the step's stand."""
        for theirs, mine in zip(gens, self.gens):
            theirs.set_state(mine.get_state())
        *st, bf, ba, bp = [t.clone() for t in self.carry]
        return bf, ba, bp, with_tensors(self.state, st, gens)


_CUDA_DRIVER = []


def _node_count(graph: "torch.cuda.CUDAGraph") -> Optional[int]:
    """The nodes of a captured, kept graph (the CUDA driver API's
    ``cuGraphGetNodes``); None where ``libcuda`` cannot be loaded."""
    import ctypes
    if not _CUDA_DRIVER:
        try:
            _CUDA_DRIVER.append(ctypes.CDLL("libcuda.so.1"))
        except OSError:
            _CUDA_DRIVER.append(None)
    if _CUDA_DRIVER[0] is None:
        return None
    n = ctypes.c_size_t(0)
    err = _CUDA_DRIVER[0].cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
_STEPS: Dict[StepKey, List[GenerationStep]] = {}        # @locked:_LOCK
_TOTALS = {"captures": 0, "warm_launches": 0, "runs": 0}  # @locked:_LOCK
_TELLS: Dict[Tuple[str, str], int] = {}                   # @locked:_LOCK


def checkout(strategy, params: FitnessParams, state,
             objective: Optional[ObjectiveSpec],
             group_size: int) -> GenerationStep:
    """A step of this search's key that no live loop holds, made if
    there is none; give it back with :func:`checkin`."""
    key = step_key(strategy, params, state, objective, group_size)
    with _LOCK:
        for step in _STEPS.get(key, ()):
            if not step.busy:
                step.busy = True
                return step
    step = GenerationStep(key, strategy, params, state, objective)
    with _LOCK:
        step.busy = True
        _STEPS.setdefault(key, []).append(step)
    return step


def checkin(step: GenerationStep) -> None:
    with _LOCK:
        step.busy = False


def steps_info() -> List[dict]:
    """One record a cached step: its key's label, the spans it has run,
    its graphs (one a span) and their captures (generations, seconds,
    nodes, pool bytes, launches captured)."""
    with _LOCK:
        steps = [s for group in _STEPS.values() for s in group]
    return [{"label": s.key.label(), "spans": sorted(s.hists),
             "graphs": len(s.graphs), "captures": list(s.captures)}
            for s in steps]


def totals() -> Dict[str, int]:
    """Over the process's life: the graphs captured (``"captures"``),
    the makespan launches of the warm generation before each
    (``"warm_launches"``, which ``makespan.LAUNCHES`` counts too) and
    the spans run (``"runs"``: a replay on a card, the eager span
    elsewhere)."""
    with _LOCK:
        return dict(_TOTALS)


def count_tells(strategy_name: str, device: torch.device, n: int) -> None:
    """``n`` tells of the strategy named ``strategy_name`` ran on
    ``device``."""
    if n:
        key = (strategy_name, torch.device(device).type)
        with _LOCK:
            _TELLS[key] = _TELLS.get(key, 0) + n


def tells(device_type: str = "cuda") -> Dict[str, int]:
    """Over the process's life, by strategy name: the tells that ran on
    devices of ``device_type``, in spans (eager or replayed), in the warm
    generation before each capture and in ``driver``'s host-stepped
    loop.  On a card MAGMA's draw kernel launches once a tell that has
    children to draw for (``draws.LAUNCHES``)."""
    with _LOCK:
        return {name: n for (name, dt), n in _TELLS.items()
                if dt == device_type}


def clear() -> None:
    """Drop every cached step no loop holds (their graphs and pools)."""
    with _LOCK:
        for key in list(_STEPS):
            kept = [s for s in _STEPS[key] if s.busy]
            if kept:
                _STEPS[key] = kept
            else:
                del _STEPS[key]
