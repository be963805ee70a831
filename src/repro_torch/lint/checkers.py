"""The port's five checkers (L001..L005): the torch counterparts of
``repro.lint.checkers``, under the reference's rule IDs.

The reference's L001 follows ``jax.random`` keys and its L002 looks
inside ``jax.jit`` functions and ``lax.scan`` bodies: the port has
neither, so those checks never fire on its code.  The hazards behind
them are the port's too: a draw from torch's global generator instead of
the row's ``torch.Generator`` breaks the rule that a sweep, stream or
fleet row is bitwise its standalone search, and a host sync in the
dispatch region stalls the card and rules out capturing the generation
loop as a CUDA graph.  L004 and L005 are language-agnostic copies.

**The dispatch region** (L002, L003): the ``init`` / ``ask`` / ``tell``
methods of ``SearchStrategy`` subclasses (not ``Host*``, whose loop
runs on the host by design); the functions whose calls a module hands to
``run_interleaved`` (the generators the driver steps, such as
``strategies/driver.py::scan_steps``); and functions marked
``# lint: dispatch`` (``repro_torch.lint.core``).  A value is
tensor-derived when it flows from a parameter, as in the reference:
``self``, parameters annotated ``int``, ``float``, ``bool`` or ``str``
(or tuples and ``Optional`` of those) and parameters whose default is a
number or a string are host values, and so are shape, dtype and device
attributes, ``len()`` / ``isinstance()`` and ``is None`` tests.

L001  global-generator-draw
    A torch random op with no ``generator=``: ``torch.rand``, ``randn``,
    ``randint``, ``randperm``, ``multinomial``, ``bernoulli``,
    ``normal``, ``poisson``, the ``*_like`` forms, the methods
    ``.multinomial`` / ``.bernoulli`` and the in-place ``.uniform_``,
    ``.normal_``, ``.random_``, ``.bernoulli_``, ``.exponential_``,
    ``.cauchy_``, ``.log_normal_``, ``.geometric_``, and the random
    ``torch.nn.init`` functions.  So is reseeding the global generator
    (``torch.manual_seed``, ``torch.cuda.manual_seed[_all]``,
    ``torch.seed``) in library code.  The counterpart of key reuse:
    both draw from a stream the row does not own::

        # bad: the global generator; another caller's draw shifts this one
        noise = torch.rand((R, P), device=dev)
        torch.manual_seed(seed)

        # good: the row's own stream
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.rand((R, P), device=dev, generator=gen)

L002  host-sync-in-dispatch
    In the dispatch region: ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()`` on a tensor-derived value, ``torch.cuda.synchronize``
    and ``.synchronize()``, the data-dependent shapes (``nonzero``,
    ``argwhere``, ``unique``, ``masked_select``, one-argument
    ``torch.where``, indexing by a boolean mask), and ``if`` / ``while``
    / a conditional expression / ``assert`` / ``bool()`` / ``int()`` /
    ``float()`` on a tensor-derived value::

        # bad: each waits for the card, once a generation
        def tell(self, state, fitness):
            if fitness.max() > state.best_fit.max():
                best = fitness[fitness > 0]

        # good: the decision stays on the device
        def tell(self, state, fitness):
            better = fitness.amax(-1) > state.best_fit
            best = torch.where(better, fitness.amax(-1), state.best_fit)

L003  impure-strategy-state
    As the reference's, with the dispatch region in place of scan
    bodies: in a strategy's ``init`` / ``ask`` / ``tell``, mutation of
    ``self`` and ``object.__setattr__``; in the whole region, ``global``
    / ``nonlocal`` and host APIs (clocks, ``np.random`` / ``random``,
    ``print``, ``open``, ``torch.manual_seed``).  Host syncs, the
    reference's ``.item()`` / ``float()`` / ``bool()`` among them, and
    ``torch.cuda.synchronize`` are L002's alone, so each gives one
    finding::

        # bad
        def ask(self, state):
            self.calls += 1
            t0 = time.perf_counter()

        # good: everything the step needs lives in the returned state
        def ask(self, state):
            return state._replace(calls=state.calls + 1), accel, prio

L004  unlocked-shared-mutation
    Writes to ``# @locked:<name>`` attributes outside ``with
    self.<name>:`` or a ``@holds:<name>`` method (the reference's)::

        # bad
        def put(self, k, v):
            self._cache[k] = v          # declared  # @locked:_lock

        # good
        def put(self, k, v):
            with self._lock:
                self._cache[k] = v

L005  fingerprint-dtype-drift
    Digest inputs that depend on native byte order or the hash seed (the
    reference's), in ``memo/fingerprint.py`` and in functions named
    ``*fingerprint*`` / ``*digest*``; a tensor's ``.numpy().tobytes()``
    is such an input::

        # bad
        sha.update(t.numpy().tobytes())
        sha.update(str(hash(key)).encode())

        # good
        sha.update(t.numpy().astype("<f4").tobytes())
        sha.update(repr(key).encode())
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.lint.core import Finding, SourceFile, checker

# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str:
    """``torch.cuda.synchronize`` for the matching Attribute chain; '' when
    the expression is not a plain dotted name (calls and subscripts break
    it, leaving the last attribute)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def iter_functions(tree: ast.AST) -> Iterator[Tuple[ast.AST, Optional[str]]]:
    """Every (sync/async) function in the module with its enclosing class
    name (None at module level; nested functions inherit the class of the
    method they are defined in)."""
    def walk(node: ast.AST, cls: Optional[str]) -> Iterator:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, cls
                yield from walk(child, cls)
            else:
                yield from walk(child, cls)
    yield from walk(tree, None)


def param_names(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


_HOST_TYPES = {"int", "float", "bool", "str", "Optional", "Tuple", "tuple",
               "None"}


def _host_annotation(ann: Optional[ast.AST]) -> bool:
    """An annotation naming only host scalar types (``int``, ``bool``,
    ``Optional[int]``, ``Tuple[int, ...]``, ...)."""
    if ann is None:
        return False
    names = {dotted_name(n).split(".")[-1] for n in ast.walk(ann)
             if isinstance(n, (ast.Name, ast.Attribute))}
    consts = [n for n in ast.walk(ann) if isinstance(n, ast.Constant)]
    return bool(names) and names <= _HOST_TYPES and all(
        c.value is None or c.value is Ellipsis for c in consts)


def host_params(fn: ast.AST) -> Set[str]:
    """Parameters that hold host values: ``self`` / ``cls`` / ``_``, those
    annotated with host scalar types, and those defaulting to a number
    or a string."""
    a = fn.args
    positional = a.posonlyargs + a.args
    defaults = [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
    pairs = list(zip(positional, defaults)) + list(zip(a.kwonlyargs,
                                                       a.kw_defaults))
    out = {"self", "cls", "_"}
    for p, default in pairs:
        literal = (isinstance(default, ast.Constant)
                   and isinstance(default.value, (int, float, str))
                   and default.value is not None)
        if literal or _host_annotation(p.annotation):
            out.add(p.arg)
    return out


# attributes whose access yields host metadata, not device values
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                 "requires_grad", "layout", "placements", "device_mesh"}
# calls whose result is host-static regardless of argument taint
_STATIC_CALLS = {"len", "isinstance", "type", "getattr", "hasattr", "repr",
                 "id", "callable", "range"}
# tensor methods that read host metadata
_STATIC_METHODS = {"dim", "size", "numel", "nelement", "element_size",
                   "stride", "is_contiguous", "is_floating_point",
                   "get_device", "data_ptr"}


def expr_tainted(node: ast.AST, tainted: Set[str]) -> bool:
    """Whether evaluating ``node`` touches a tensor-derived value: any
    tainted Name flows through, EXCEPT under shape/dtype/device metadata
    access, static-returning builtins, or ``is (not) None`` checks."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return False
        return expr_tainted(node.value, tainted)
    if isinstance(node, ast.Call):
        fname = dotted_name(node.func)
        if fname in _STATIC_CALLS or (isinstance(node.func, ast.Attribute)
                                      and node.func.attr in _STATIC_METHODS):
            return False
        parts = [expr_tainted(a, tainted) for a in node.args]
        parts += [expr_tainted(kw.value, tainted) for kw in node.keywords]
        if not isinstance(node.func, ast.Name):
            parts.append(expr_tainted(node.func, tainted))
        return any(parts)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
        return any(expr_tainted(c, tainted)
                   for c in [node.left] + node.comparators)
    return any(expr_tainted(c, tainted) for c in ast.iter_child_nodes(node))


def _propagate_taint(fn: ast.AST, tainted: Set[str]) -> None:
    """Fixpoint over simple assignments: names bound to tainted
    expressions become tainted."""
    for _ in range(8):
        grew = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets, value = [node.target], node.value
            else:
                continue
            if value is None or not expr_tainted(value, tainted):
                continue
            for t in targets:
                names = [t] if isinstance(t, ast.Name) else [
                    el for el in getattr(t, "elts", [])
                    if isinstance(el, ast.Name)]
                for n in names:
                    if n.id not in tainted:
                        tainted.add(n.id)
                        grew = True
        if not grew:
            return


def _tainted_names(fn: ast.AST) -> Set[str]:
    tainted = set(param_names(fn)) - host_params(fn)
    _propagate_taint(fn, tainted)
    return tainted


# ---------------------------------------------------------------------------
# the dispatch region
# ---------------------------------------------------------------------------

_STRATEGY_METHODS = {"init", "ask", "tell"}


def _strategy_classes(tree: ast.AST) -> Set[str]:
    """Classes in the SearchStrategy protocol, minus the host-loop
    adapters (``Host*``)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        bases = {dotted_name(b).split(".")[-1] for b in node.bases}
        if ("SearchStrategy" in bases or "Strategy" in bases) \
                and not node.name.startswith("Host"):
            out.add(node.name)
    return out


def stepped_names(tree: ast.AST) -> Set[str]:
    """Names of the functions whose calls this module hands to
    ``run_interleaved`` (the generators the driver steps)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and dotted_name(node.func).split(".")[-1]
                == "run_interleaved"):
            continue
        for arg in node.args:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Call):
                    name = dotted_name(sub.func)
                    if name:
                        out.add(name.split(".")[-1])
    return out


def dispatch_functions(sf: SourceFile
                       ) -> Iterator[Tuple[ast.AST, str, bool]]:
    """(function, where, whether it is a strategy's init / ask / tell)
    for every function of the dispatch region."""
    strategies = _strategy_classes(sf.tree)
    stepped = stepped_names(sf.tree)
    for fn, cls in iter_functions(sf.tree):
        if cls in strategies and fn.name in _STRATEGY_METHODS:
            yield fn, f"{cls}.{fn.name}", True
        elif fn.name in stepped:
            yield fn, f"stepped generator {fn.name}", False
        elif sf.marked_dispatch(fn):
            yield fn, f"dispatch function {fn.name}", False


# ---------------------------------------------------------------------------
# L001 — global-generator-draw
# ---------------------------------------------------------------------------

_DRAWS = {"rand", "randn", "randint", "randperm", "multinomial", "bernoulli",
          "normal", "poisson", "rand_like", "randn_like", "randint_like"}
_DRAW_METHODS = {"multinomial", "bernoulli", "uniform_", "normal_",
                 "random_", "bernoulli_", "exponential_", "cauchy_",
                 "log_normal_", "geometric_"}
_INIT_DRAWS = {"uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
               "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
               "orthogonal_", "sparse_"}
_RESEEDS = {"torch.manual_seed", "torch.random.manual_seed", "torch.seed",
            "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
            "torch.cuda.seed", "torch.cuda.seed_all"}


def _has_generator(call: ast.Call) -> bool:
    """A ``generator=`` that is not None, or a ``**kwargs`` that may hold
    one."""
    for kw in call.keywords:
        if kw.arg is None:
            return True
        if kw.arg == "generator":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is None)
    return False


def _draw_kind(call: ast.Call) -> str:
    """What global-generator draw ``call`` is ('' when none)."""
    fname = dotted_name(call.func)
    parts = fname.split(".")
    if fname in _RESEEDS:
        return "reseed"
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in _DRAWS:
        return "draw"
    if parts[-1] in _INIT_DRAWS and len(parts) >= 2 and parts[-2] == "init":
        return "draw"
    if isinstance(call.func, ast.Attribute) and parts[-1] in _DRAW_METHODS \
            and parts[0] != "torch":
        return "draw"
    return ""


@checker("L001")
def check_global_generator_draw(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        kind = _draw_kind(node)
        fname = dotted_name(node.func) or "call"
        if kind == "reseed":
            findings.append(Finding(
                sf.path, node.lineno, "L001",
                f"`{fname}()` reseeds torch's global generator — every "
                f"other draw in the process shifts; seed a "
                f"torch.Generator the caller owns"))
        elif kind == "draw" and not _has_generator(node):
            findings.append(Finding(
                sf.path, node.lineno, "L001",
                f"`{fname}()` draws from torch's global generator — pass "
                f"the row's torch.Generator as generator="))
    return findings


# ---------------------------------------------------------------------------
# L002 — host-sync-in-dispatch
# ---------------------------------------------------------------------------

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_DYNAMIC_SHAPE = {"nonzero", "argwhere", "unique", "unique_consecutive",
                  "masked_select"}
_MASK_CALLS = {"isnan", "isinf", "isfinite", "isneginf", "isposinf", "bool",
               "logical_not", "logical_and", "logical_or", "logical_xor",
               "eq", "ne", "gt", "lt", "ge", "le"}


def _is_mask(node: ast.AST, masks: Set[str], tainted: Set[str]) -> bool:
    """Whether ``node`` is plausibly a boolean tensor: a comparison of a
    tensor-derived value, a ``~`` / ``&`` / ``|`` / ``^`` of masks, a
    predicate call, or a name bound to one."""
    if isinstance(node, ast.Name):
        return node.id in masks
    if isinstance(node, ast.Compare):
        return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                       for op in node.ops) and expr_tainted(node, tainted)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_mask(node.operand, masks, tainted)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return (_is_mask(node.left, masks, tainted)
                or _is_mask(node.right, masks, tainted))
    if isinstance(node, ast.Call):
        return (dotted_name(node.func).split(".")[-1] in _MASK_CALLS
                and expr_tainted(node, tainted))
    return False


def _mask_names(fn: ast.AST, tainted: Set[str]) -> Set[str]:
    masks: Set[str] = set()
    for _ in range(4):
        size = len(masks)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _is_mask(node.value, masks, tainted):
                masks.add(node.targets[0].id)
        if len(masks) == size:
            break
    return masks


@checker("L002")
def check_host_sync_in_dispatch(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for fn, where, _ in dispatch_functions(sf):
        tainted = _tainted_names(fn)
        findings.extend(_l002_flag(sf, fn, where, tainted,
                                   _mask_names(fn, tainted)))
    return findings


def _l002_flag(sf: SourceFile, fn: ast.AST, where: str, tainted: Set[str],
               masks: Set[str]) -> List[Finding]:
    findings: List[Finding] = []

    def emit(line: int, what: str) -> None:
        findings.append(Finding(
            sf.path, line, "L002",
            f"{what} in {where} — a host sync in the dispatch region "
            f"stalls the card"))

    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While)):
            if expr_tainted(node.test, tainted):
                kind = "if" if isinstance(node, ast.If) else "while"
                emit(node.lineno, f"Python `{kind}` on a tensor-derived "
                                  f"value")
        elif isinstance(node, ast.IfExp):
            if expr_tainted(node.test, tainted):
                emit(node.lineno, "conditional expression on a "
                                  "tensor-derived value")
        elif isinstance(node, ast.Assert):
            if expr_tainted(node.test, tainted):
                emit(node.lineno, "`assert` on a tensor-derived value")
        elif isinstance(node, ast.Subscript):
            index = node.slice
            parts = index.elts if isinstance(index, ast.Tuple) else [index]
            if expr_tainted(node.value, tainted) and any(
                    _is_mask(p, masks, tainted) for p in parts):
                emit(node.lineno, "indexing by a boolean mask (a "
                                  "data-dependent shape)")
        elif isinstance(node, ast.Call):
            _l002_call(node, tainted, emit)
    return findings


def _l002_call(node: ast.Call, tainted: Set[str], emit) -> None:
    fname = dotted_name(node.func)
    tail = fname.split(".")[-1]
    method = isinstance(node.func, ast.Attribute)
    receiver = node.func.value if method else None
    if fname in ("bool", "int", "float") and node.args:
        if any(expr_tainted(a, tainted) for a in node.args):
            emit(node.lineno, f"`{fname}()` of a tensor-derived value")
    elif fname == "torch.cuda.synchronize" or (
            method and tail == "synchronize"):
        emit(node.lineno, f"`{fname or tail}()`")
    elif fname in {f"torch.{n}" for n in _DYNAMIC_SHAPE} or (
            fname == "torch.where" and len(node.args) == 1
            and not node.keywords):
        emit(node.lineno, f"`{fname}()` (a data-dependent shape)")
    elif method and tail in _DYNAMIC_SHAPE and not fname.startswith(
            "torch.") and expr_tainted(receiver, tainted):
        emit(node.lineno, f"`.{tail}()` (a data-dependent shape)")
    elif method and tail in _SYNC_METHODS and expr_tainted(receiver,
                                                           tainted):
        emit(node.lineno, f"`.{tail}()` of a tensor-derived value")


# ---------------------------------------------------------------------------
# L003 — impure-strategy-state
# ---------------------------------------------------------------------------

# host APIs with no business inside a pure strategy step
_BANNED_CALL_PREFIXES = ("time.", "datetime.", "np.random.", "numpy.random.",
                         "random.")
_BANNED_CALL_NAMES = {"print", "perf_counter", "monotonic", "input", "open",
                      "torch.manual_seed"}


@checker("L003")
def check_impure_strategy_state(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for fn, where, strategy in dispatch_functions(sf):
        for node in ast.walk(fn):
            if strategy and isinstance(node, (ast.Assign, ast.AugAssign,
                                              ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    base = t
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    if isinstance(base, ast.Attribute) \
                            and isinstance(base.value, ast.Name) \
                            and base.value.id == "self":
                        findings.append(Finding(
                            sf.path, node.lineno, "L003",
                            f"mutation of self.{base.attr} in {where} — "
                            f"strategy state must live in the returned "
                            f"state, not on the object"))
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                findings.append(Finding(
                    sf.path, node.lineno, "L003",
                    f"{type(node).__name__.lower()} write in {where}"))
            elif isinstance(node, ast.Call):
                findings.extend(_l003_call(sf, node, where, strategy))
    return findings


def _l003_call(sf: SourceFile, node: ast.Call, where: str,
               strategy: bool) -> List[Finding]:
    fname = dotted_name(node.func)
    tail = fname.split(".")[-1]
    if fname.startswith(_BANNED_CALL_PREFIXES) \
            or fname in _BANNED_CALL_NAMES:
        return [Finding(sf.path, node.lineno, "L003",
                        f"host API `{fname}()` in {where} — impure (a "
                        f"replayed or captured step would not repeat it)")]
    if strategy and tail == "__setattr__" and fname.startswith("object."):
        return [Finding(sf.path, node.lineno, "L003",
                        f"object.__setattr__ in {where} — frozen-"
                        f"dataclass mutation is still mutation")]
    return []


# ---------------------------------------------------------------------------
# L004 — unlocked-shared-mutation
# ---------------------------------------------------------------------------

_MUTATOR_METHODS = {"append", "appendleft", "extend", "insert", "add",
                    "remove", "discard", "pop", "popleft", "popitem",
                    "clear", "update", "setdefault", "move_to_end",
                    "sort", "reverse"}


@checker("L004")
def check_unlocked_shared_mutation(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_l004_class(sf, node))
    return findings


def _l004_class(sf: SourceFile, cls: ast.ClassDef) -> List[Finding]:
    decls: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        lock = sf.locked_decls.get(node.lineno)
        if lock is None and getattr(node, "end_lineno", None):
            for ln in range(node.lineno, node.end_lineno + 1):
                lock = sf.locked_decls.get(ln)
                if lock:
                    break
        if not lock:
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                decls[t.attr] = lock
            elif isinstance(t, ast.Name):
                decls[t.id] = lock
    if not decls:
        return []

    findings: List[Finding] = []
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if item.name == "__init__":
                continue               # construction precedes sharing
            held = set(sf.holds_for(item))
            _l004_walk(sf, item.body, decls, held, item.name, findings)
    return findings


def _l004_walk(sf: SourceFile, stmts, decls: Dict[str, str],
               held: Set[str], method: str,
               findings: List[Finding]) -> None:
    for stmt in stmts:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            newly = set()
            for it in stmt.items:
                name = dotted_name(it.context_expr)
                if name.startswith("self."):
                    newly.add(name[len("self."):])
                elif name:
                    newly.add(name)
            _l004_walk(sf, stmt.body, decls, held | newly, method, findings)
            continue
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        _l004_check_stmt(sf, stmt, decls, held, method, findings)
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                _l004_walk(sf, sub, decls, held, method, findings)
        for h in getattr(stmt, "handlers", []) or []:
            _l004_walk(sf, h.body, decls, held, method, findings)


def _l004_check_stmt(sf: SourceFile, stmt: ast.AST,
                     decls: Dict[str, str], held: Set[str], method: str,
                     findings: List[Finding]) -> None:
    def emit(line: int, attr: str) -> None:
        lock = decls[attr]
        findings.append(Finding(
            sf.path, line, "L004",
            f"write to self.{attr} (declared @locked:{lock}) in "
            f"{method}() outside `with self.{lock}:` — mark the method "
            f"@holds:{lock} if the caller owns the lock"))

    def locked_attr_of(t: ast.AST) -> Optional[str]:
        base = t
        while isinstance(base, ast.Subscript):
            base = base.value
        if isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" and base.attr in decls:
            return base.attr
        return None

    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for t in targets:
            attr = locked_attr_of(t)
            if attr is not None and decls[attr] not in held:
                emit(stmt.lineno, attr)
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            attr = locked_attr_of(t)
            if attr is not None and decls[attr] not in held:
                emit(stmt.lineno, attr)
    # mutating method calls on a locked attribute — scan only this
    # statement's own expressions (compound statements recurse through
    # _l004_walk so nested `with lock:` bodies keep their held set)
    if isinstance(stmt, (ast.If, ast.While)):
        roots: List[ast.AST] = [stmt.test]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        roots = [stmt.iter]
    elif isinstance(stmt, ast.Try):
        roots = []
    else:
        roots = [stmt]
    for root in roots:
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                if node.func.attr not in _MUTATOR_METHODS:
                    continue
                attr = locked_attr_of(node.func.value)
                if attr is not None and decls[attr] not in held:
                    emit(node.lineno, attr)


# ---------------------------------------------------------------------------
# L005 — fingerprint-dtype-drift
# ---------------------------------------------------------------------------


def _in_byte_scope(sf: SourceFile, fn: ast.AST) -> bool:
    norm = sf.path.replace("\\", "/")
    if norm.endswith("memo/fingerprint.py"):
        return True
    name = fn.name.lower()
    return "fingerprint" in name or "digest" in name


def _has_le_astype(node: ast.AST) -> bool:
    """Whether the value chain under ``.tobytes()`` pins an explicit
    little-endian dtype via ``.astype("<..")``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr == "astype" and sub.args:
            a = sub.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                    and a.value.startswith("<"):
                return True
    return False


@checker("L005")
def check_fingerprint_dtype_drift(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for fn, _cls in iter_functions(sf.tree):
        if not _in_byte_scope(sf, fn):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func)
            if fname == "hash":
                findings.append(Finding(
                    sf.path, node.lineno, "L005",
                    f"builtin hash() feeding {fn.name}() — salted per "
                    f"process (PYTHONHASHSEED); digest bits would change "
                    f"across runs"))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "tobytes":
                if not _has_le_astype(node.func.value):
                    findings.append(Finding(
                        sf.path, node.lineno, "L005",
                        f".tobytes() without an explicit little-endian "
                        f".astype('<f4'/'<i4'/'<u4') in {fn.name}() — "
                        f"raw buffers (a tensor's .numpy() included) drift "
                        f"with input dtype and native byte order"))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "astype" and node.args:
                a = node.args[0]
                byte_order_free = (
                    isinstance(a, ast.Constant)
                    and isinstance(a.value, str)
                    and not a.value.startswith("<"))
                if byte_order_free:
                    findings.append(Finding(
                        sf.path, node.lineno, "L005",
                        f".astype({a.value!r}) in {fn.name}() leaves "
                        f"byte order native — use the '<'-prefixed "
                        f"little-endian spelling for digest inputs"))
    return findings
