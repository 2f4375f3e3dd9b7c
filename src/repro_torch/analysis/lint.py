"""The port's AST lint rules for the hot path and the registries.

The counterpart of ``repro.analysis.lint``, with torch spellings.  On the
card a run of steps is captured in a CUDA graph and replayed: a host sync
inside a captured step raises during the capture (or, outside one, stalls
every step), and a Python branch on a tensor's value is frozen at capture,
so a replay takes the branch the capture took whatever the data says.  So
these rules matter more here than on the reference.  ``ruff`` checks only
syntax-level correctness (see ruff.toml); this module implements the
repo-specific rules over a lightweight static call graph:

RL001  no host sync (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
       ``float()`` / ``int()`` / ``bool()`` of a tensor,
       ``torch.cuda.synchronize``, ``print``, ``np.asarray``) in functions
       reachable from the step bodies (a call-graph walk from the engine's
       phases, the sharded and dense steps, the segment that
       ``FusedBackend`` captures, and the registries' per-step methods),
RL002  no Python ``if`` / ``while`` on a tensor in those same bodies,
RL003  registry-plugin conformance: every ``@register``-ed delivery /
       stimulus / plasticity rule and every ``StreamProbe`` construction
       statically matches its protocol signature (names, arity, return
       annotation; the port's ``StreamProbe.init`` takes the device),
RL004  dtype discipline: no float64 (``torch.float64``, ``torch.double``,
       ``np.float64``, ``dtype=float``) in device code
       (``repro_torch/core/``, ``kernels/``, ``api/``),
RL005  shared-mutable-state heuristics for the serve layer and the probes:
       module-level dicts/lists/sets mutated outside a ``threading.Lock`` /
       ``RLock`` ``with`` block.

The walk never imports the linted code: everything is ``ast``-level.
Reachability is deliberately an over-approximation (a nested function of
a hot function is hot, and the registries' per-step methods are roots in
their own right).  Host-side code swept in by it is grandfathered in the
port's baseline, ``src/repro_torch/analysis/baseline.json``, with a reason
each, rather than special-cased here (see ``repro_torch.analysis.report``).
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.report import Finding

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

#: qualname fnmatch patterns whose matches seed the hot-path walk: the
#: engine's step phases, the sharded and dense steps, the segment
#: ``FusedBackend`` captures in its graphs (the closure it captures, and the
#: steps it reaches through ``self._step``), and the per-step entry points of
#: every registry: delivery ``deliver``, stimulus ``compile`` (its nested
#: gates run each step) and ``Drive``'s per-step draw, plasticity ``step``,
#: the probes' reducers, every kernel wrapper, and the spans and counters
#: (``perf/trace.py``) the step and the loop open.
DEFAULT_ROOTS: Tuple[str, ...] = (
    "repro_torch.core.engine.update_phase",
    "repro_torch.core.engine.fused_update_phase",
    "repro_torch.core.engine.fused_plastic_update_phase",
    "repro_torch.core.engine.deliver_phase",
    "repro_torch.core.engine.make_step",
    "repro_torch.core.distributed.update_shard",
    "repro_torch.core.distributed.deliver_shard",
    "repro_torch.core.distributed.sharded_step",
    "repro_torch.core.distributed.make_dense_step",
    "repro_torch.api.backends.*._segment",
    "repro_torch.api.backends.FusedBackend._graph.segment",
    "repro_torch.api.backends.*._fused_step",
    "repro_torch.api.backends.*._split_step",
    "repro_torch.api.backends.*._sharded_step",
    "repro_torch.core.delivery.*.deliver",
    "repro_torch.core.stimulus.*.compile",
    "repro_torch.core.stimulus.Drive.__call__",
    "repro_torch.core.plasticity.*.step",
    "repro_torch.api.probes.*.fn",
    "repro_torch.api.probes.*.update",
    "repro_torch.api.probes.*.init",
    "repro_torch.kernels.*",
    "repro_torch.perf.trace.*",
)

#: parameter names treated as tensors for RL001 / RL002 (the step state and
#: its pieces); anything assigned from them, or from a torch call, is a
#: tensor too.
DEFAULT_TRACED_PARAMS = frozenset({
    "state", "sim", "carry", "carries", "scs", "spiked", "spk", "ring",
    "weights", "w", "ps", "key", "keys", "t", "arrivals", "net", "ctx",
    "x", "v", "V", "I_ex", "I_in",
    "I_ext", "refrac", "ovf", "live", "ids", "ext", "in_ex", "in_in",
    "i_dc", "neuron_state", "spiked_prev", "spiked_global", "st",
    "t_step", "s", "W",
})

#: path substrings defining the RL004 device-code scan (module-wide, not
#: just hot functions).  ``repro_torch/validate`` is host-side and out of
#: scope.
DEFAULT_DTYPE_SCOPES: Tuple[str, ...] = (
    "repro_torch/core/", "repro_torch/kernels/", "repro_torch/api/",
)

#: path substrings scanned by RL005 (module-level shared mutable state).
#: ``api/probes.py`` rides along: its interning tables are process-wide
#: and reached from the server's threads; so does ``perf/trace.py``, whose
#: span buffer and counters every thread writes.
DEFAULT_SHARED_STATE_SCOPES: Tuple[str, ...] = (
    "repro_torch/serve/", "repro_torch/api/probes.py",
    "repro_torch/perf/trace.py",
)

#: protocol base classes checked by RL003 (resolved by simple name in the
#: indexed sources, so fixture files can define their own minimal bases).
DEFAULT_PROTOCOL_BASES: Tuple[str, ...] = (
    "DeliveryStrategy", "Stimulus", "PlasticityRule",
)

#: ``StreamProbe(...)`` callables' positional arity: the port's ``init``
#: takes the device the carry lives on (the reference's takes nothing).
STREAM_PROBE_ARITY = {"init": 1, "update": 2}

_MUTATORS = frozenset({"append", "add", "update", "setdefault", "pop",
                       "popitem", "clear", "extend", "remove", "insert",
                       "discard"})
#: a tensor's attributes and methods whose value is host metadata: reading
#: them neither syncs nor depends on the data
_SHAPE_ATTRS = frozenset({"shape", "dtype", "ndim", "size", "name", "device",
                          "is_cuda", "numel", "dim", "data_ptr", "stride",
                          "is_contiguous", "layout"})
_MUTABLE_CTORS = frozenset({"dict", "list", "set", "OrderedDict",
                            "defaultdict", "WeakSet", "WeakValueDictionary",
                            "Counter", "deque"})


@dataclasses.dataclass(frozen=True)
class LintConfig:
    roots: Tuple[str, ...] = DEFAULT_ROOTS
    traced_params: frozenset = DEFAULT_TRACED_PARAMS
    dtype_scopes: Tuple[str, ...] = DEFAULT_DTYPE_SCOPES
    shared_state_scopes: Tuple[str, ...] = DEFAULT_SHARED_STATE_SCOPES
    protocol_bases: Tuple[str, ...] = DEFAULT_PROTOCOL_BASES
    rules: Tuple[str, ...] = ("RL001", "RL002", "RL003", "RL004", "RL005")


# ---------------------------------------------------------------------------
# Module / function index
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FuncInfo:
    qualname: str                   # "repro_torch.core.engine.update_phase"
    node: ast.AST                   # FunctionDef | AsyncFunctionDef
    module: "ModuleInfo"
    class_name: Optional[str]       # immediately enclosing class, if any


@dataclasses.dataclass
class ClassInfo:
    qualname: str
    node: ast.ClassDef
    module: "ModuleInfo"
    base_names: Tuple[str, ...]     # simple names of the declared bases
    methods: Dict[str, FuncInfo]


@dataclasses.dataclass
class ModuleInfo:
    path: str                       # repo-relative posix path
    modname: str                    # dotted module name
    tree: ast.Module
    imports: Dict[str, str]         # local alias -> dotted target
    functions: Dict[str, FuncInfo]  # qualname -> info (nested included)
    classes: Dict[str, ClassInfo]   # simple name -> info


def module_name_for(path: str) -> str:
    """Dotted module name of a source path (``src/<pkg>/...`` aware)."""
    norm = path.replace(os.sep, "/")
    if "/src/" in norm:
        norm = norm.split("/src/", 1)[1]
    elif norm.startswith("src/"):
        norm = norm[len("src/"):]
    else:
        return os.path.splitext(os.path.basename(norm))[0]
    norm = norm[:-3] if norm.endswith(".py") else norm
    parts = norm.split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _collect_imports(tree: ast.Module) -> Dict[str, str]:
    """Alias -> dotted-target map, walking the whole module (function-level
    imports included: the hot path uses them to break cycles)."""
    imports: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imports[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                imports[a.asname or a.name] = f"{node.module}.{a.name}"
    return imports


def index_module(path: str, repo_root: str = ".") -> ModuleInfo:
    rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    mod = ModuleInfo(path=rel, modname=module_name_for(rel), tree=tree,
                     imports=_collect_imports(tree), functions={},
                     classes={})

    def visit(node, prefix: str, class_name: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}.{child.name}"
                mod.functions[q] = FuncInfo(q, child, mod, class_name)
                visit(child, q, None)
            elif isinstance(child, ast.ClassDef):
                q = f"{prefix}.{child.name}"
                bases = tuple(_simple_name(b) for b in child.bases)
                ci = ClassInfo(q, child, mod,
                               tuple(b for b in bases if b), {})
                mod.classes[child.name] = ci
                visit(child, q, child.name)
                for fq, fi in mod.functions.items():
                    if fq.startswith(q + ".") and "." not in \
                            fq[len(q) + 1:]:
                        ci.methods[fq.rsplit(".", 1)[1]] = fi
    visit(tree, mod.modname, None)
    return mod


def _simple_name(node) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _dotted(node) -> Optional[str]:
    """Render a Name/Attribute chain as ``a.b.c`` (None when dynamic)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---------------------------------------------------------------------------
# Hot-path reachability
# ---------------------------------------------------------------------------

def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function's subtree, excluding nested FunctionDef bodies
    (nested functions are hot in their own right and checked separately --
    walking them here would double-report)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _call_targets(fi: FuncInfo) -> Iterable[str]:
    """Resolvable qualnames this function (including its nested closures)
    calls: bare names through the import map / module scope, ``self.x``
    through the enclosing class, ``alias.x`` through module imports."""
    mod = fi.module
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            tgt = mod.imports.get(f.id)
            if tgt:
                yield tgt
            yield f"{mod.modname}.{f.id}"
        elif isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name):
                if base.id == "self" and fi.class_name:
                    yield f"{mod.modname}.{fi.class_name}.{f.attr}"
                tgt = mod.imports.get(base.id)
                if tgt:
                    yield f"{tgt}.{f.attr}"
            else:
                dotted = _dotted(f)
                if dotted:
                    root = dotted.split(".", 1)[0]
                    tgt = mod.imports.get(root)
                    if tgt:
                        yield dotted.replace(root, tgt, 1)


def hot_functions(modules: Sequence[ModuleInfo],
                  roots: Sequence[str]) -> Dict[str, FuncInfo]:
    """Transitive closure of the root patterns over the static call graph
    (+ lexical nesting: a hot function's inner defs are hot)."""
    by_qual: Dict[str, FuncInfo] = {}
    for m in modules:
        by_qual.update(m.functions)
    hot: Dict[str, FuncInfo] = {}
    work: List[FuncInfo] = []
    for q, fi in by_qual.items():
        if any(fnmatch.fnmatch(q, pat) for pat in roots):
            hot[q] = fi
            work.append(fi)
    while work:
        fi = work.pop()
        candidates: List[str] = []
        # lexically nested defs
        candidates.extend(q for q in fi.module.functions
                          if q.startswith(fi.qualname + "."))
        candidates.extend(_call_targets(fi))
        for q in candidates:
            tgt = by_qual.get(q)
            if tgt is not None and q not in hot:
                hot[q] = tgt
                work.append(tgt)
    return hot


# ---------------------------------------------------------------------------
# RL001 -- host syncs in hot code
# ---------------------------------------------------------------------------

_NP_ALIASES = ("numpy", "np")
_HOST_SYNC_NP = frozenset({"asarray", "array"})


def _np_roots(mod: ModuleInfo) -> Set[str]:
    return {alias for alias, tgt in mod.imports.items() if tgt == "numpy"} \
        | {a for a in _NP_ALIASES if a not in mod.imports}


#: tensor methods that copy a value to the host (and wait for the card)
_HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
#: builtins that read a tensor's value to the host
_HOST_SYNC_BUILTINS = frozenset({"float", "int", "bool"})


def check_rl001(fi: FuncInfo, seeds: frozenset) -> List[Finding]:
    out = []
    np_roots = _np_roots(fi.module)
    traced = _traced_names(fi, seeds)

    def involves_traced(expr) -> bool:
        # a tensor Name used as a value (its shape, dtype or device is host
        # metadata, so those attribute subtrees are skipped)
        for n in _walk_skipping_static_attrs(expr):
            if isinstance(n, ast.Name) and n.id in traced:
                return True
        return False

    def finding(node, what):
        return Finding("RL001", fi.module.path, node.lineno, fi.qualname,
                       f"host-sync op in step-reachable code: {what}")

    for node in _own_nodes(fi.node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        dotted = _dotted(f) or ""
        if isinstance(f, ast.Name):
            if f.id == "print":
                out.append(finding(node, "print()"))
            elif f.id in _HOST_SYNC_BUILTINS and node.args \
                    and involves_traced(node.args[0]):
                out.append(finding(node, f"{f.id}() on a tensor reads it "
                                         f"to the host"))
        elif dotted.endswith("cuda.synchronize"):
            out.append(finding(node, "torch.cuda.synchronize()"))
        elif isinstance(f, ast.Attribute):
            if f.attr in _HOST_SYNC_METHODS and not node.args \
                    and involves_traced(f.value):
                out.append(finding(node, f".{f.attr}()"))
            elif f.attr in _HOST_SYNC_NP and isinstance(f.value, ast.Name) \
                    and f.value.id in np_roots and node.args \
                    and involves_traced(node.args[0]):
                out.append(finding(
                    node, f"{f.value.id}.{f.attr}() on a tensor "
                          f"materialises on the host"))
    return out


# ---------------------------------------------------------------------------
# RL002 -- Python control flow on traced values
# ---------------------------------------------------------------------------

def _walk_skipping_static_attrs(expr) -> Iterable[ast.AST]:
    """Walk an expression, pruning the subtrees that are host metadata
    (``x.shape`` / ``x.dtype`` / ``x.device`` ... of a tensor is a Python
    value, known without reading the tensor)."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Attribute) and node.attr in _SHAPE_ATTRS:
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


#: dotted call prefixes whose results are tensors
_TENSOR_CALL_PREFIXES = ("torch.", "F.")
#: ... except these, which answer on the host
_HOST_TORCH_CALLS = ("torch.device", "torch.cuda.", "torch.is_tensor",
                     "torch.Generator", "torch.get_default_dtype",
                     "torch.finfo", "torch.iinfo", "torch.Size",
                     "torch.distributed.", "torch.is_grad_enabled")


def _is_tensor_call(dotted: str) -> bool:
    return dotted.startswith(_TENSOR_CALL_PREFIXES) \
        and not dotted.startswith(_HOST_TORCH_CALLS)


def _traced_names(fi: FuncInfo, seeds: frozenset) -> Set[str]:
    """Forward taint pass: seed params + assignments whose RHS mentions a
    tensor name or calls a torch function that makes a tensor (shape /
    dtype / device introspection prunes the taint: those are host
    values)."""
    args = fi.node.args
    params = [a.arg for a in (args.posonlyargs + args.args
                              + args.kwonlyargs)]
    traced = {p for p in params if p in seeds}

    def rhs_traced(expr) -> bool:
        for n in _walk_skipping_static_attrs(expr):
            if isinstance(n, ast.Name) and n.id in traced:
                return True
            if isinstance(n, ast.Call):
                if _is_tensor_call(_dotted(n.func) or ""):
                    return True
        return False

    for _ in range(2):                    # two passes: simple chains settle
        for node in _own_nodes(fi.node):
            targets = ()
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = (node.target,), node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = (node.target,), node.value
            else:
                continue
            if not rhs_traced(value):
                continue
            for t in targets:
                # a store into an item or an attribute names no new
                # tensor (``cache[key] = torch.zeros(...)`` leaves ``key``
                # and the dict host values)
                if isinstance(t, (ast.Subscript, ast.Attribute)):
                    continue
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        traced.add(n.id)
    return traced


def _test_is_static(test, traced: Set[str]) -> bool:
    """True when every tensor-name use in the test is shape / None /
    type introspection (host values, the same at every replay)."""
    exempt_calls = {"isinstance", "hasattr", "len", "getattr", "callable"}

    def uses(node) -> bool:
        # a bare tensor Name (not behind .shape/.dtype/... and not an
        # `is None` comparison / isinstance operand)
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in exempt_calls:
                return False
        if isinstance(node, ast.Attribute) and node.attr in _SHAPE_ATTRS:
            return False
        if isinstance(node, ast.Name):
            return node.id in traced
        return any(uses(c) for c in ast.iter_child_nodes(node))

    return not uses(test)


def check_rl002(fi: FuncInfo, seeds: frozenset) -> List[Finding]:
    traced = _traced_names(fi, seeds)
    out = []
    for node in _own_nodes(fi.node):
        if isinstance(node, (ast.If, ast.While)):
            if not _test_is_static(node.test, traced):
                kind = "if" if isinstance(node, ast.If) else "while"
                names = sorted({n.id for n in ast.walk(node.test)
                                if isinstance(n, ast.Name)
                                and n.id in traced})
                out.append(Finding(
                    "RL002", fi.module.path, node.lineno, fi.qualname,
                    f"Python `{kind}` on tensor value(s) "
                    f"{', '.join(names)} in step-reachable code (frozen at "
                    f"capture) -- use torch.where"))
    return out


# ---------------------------------------------------------------------------
# RL003 -- registry-plugin conformance
# ---------------------------------------------------------------------------

def _is_registered(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        name = _simple_name(dec.func if isinstance(dec, ast.Call) else dec)
        if name == "register":
            return True
    return False


def _positional_params(fn: ast.AST) -> List[str]:
    args = fn.args
    return [a.arg for a in (args.posonlyargs + args.args)]


def _required_arity(fn: ast.AST) -> int:
    args = fn.args
    pos = args.posonlyargs + args.args
    return len(pos) - len(args.defaults)


def _annotation_str(fn: ast.AST) -> Optional[str]:
    if fn.returns is None:
        return None
    try:
        return ast.unparse(fn.returns).strip("\"'")
    except Exception:
        return None


def check_rl003(modules: Sequence[ModuleInfo],
                protocol_bases: Sequence[str]) -> List[Finding]:
    # protocol base -> {method name: FuncInfo} (first definition wins)
    bases: Dict[str, ClassInfo] = {}
    for m in modules:
        for name, ci in m.classes.items():
            if name in protocol_bases and name not in bases:
                bases[name] = ci
    out: List[Finding] = []
    for m in modules:
        for ci in m.classes.values():
            proto = next((bases[b] for b in ci.base_names if b in bases),
                         None)
            if proto is None or ci is proto or not _is_registered(ci.node):
                continue
            out.extend(_check_class_against(ci, proto))
        out.extend(_check_stream_probes(m))
    return out


def _is_subtype_name(sub: str, base: str, mod: ModuleInfo,
                     depth: int = 5) -> bool:
    """True when class ``sub`` (by simple name, resolved in the module's
    index) transitively declares ``base`` among its bases -- covariant
    return annotations are conformant."""
    if sub == base:
        return True
    ci = mod.classes.get(sub)
    if ci is None or depth <= 0:
        return False
    return any(_is_subtype_name(b, base, mod, depth - 1)
               for b in ci.base_names)


def _check_class_against(ci: ClassInfo, proto: ClassInfo) -> List[Finding]:
    out = []
    for mname, base_fi in proto.methods.items():
        if mname.startswith("__") or mname in ("to_dict", "from_dict"):
            continue
        sub_fi = ci.methods.get(mname)
        base_params = _positional_params(base_fi.node)
        if sub_fi is None:
            # abstract protocol methods (raise NotImplementedError in the
            # base body) must be overridden; concrete ones may be inherited
            if _raises_not_implemented(base_fi.node):
                out.append(Finding(
                    "RL003", ci.module.path, ci.node.lineno, ci.qualname,
                    f"registered plugin does not implement required "
                    f"protocol method {proto.node.name}.{mname}"
                    f"({', '.join(base_params[1:])})"))
            continue
        sub_params = _positional_params(sub_fi.node)
        n_req = _required_arity(sub_fi.node)
        if sub_params[:len(base_params)] != base_params \
                or n_req > len(base_params):
            out.append(Finding(
                "RL003", ci.module.path, sub_fi.node.lineno,
                sub_fi.qualname,
                f"signature mismatch vs {proto.node.name}.{mname}: "
                f"expected ({', '.join(base_params)}), "
                f"got ({', '.join(sub_params)})"))
        base_ret = _annotation_str(base_fi.node)
        sub_ret = _annotation_str(sub_fi.node)
        if base_ret in ("Any", "typing.Any", "object", "None"):
            base_ret = None       # base promises nothing; any return is fine
        if base_ret and sub_ret and not _is_subtype_name(
                _strip_quals(sub_ret), _strip_quals(base_ret), ci.module):
            out.append(Finding(
                "RL003", ci.module.path, sub_fi.node.lineno,
                sub_fi.qualname,
                f"return annotation mismatch vs {proto.node.name}."
                f"{mname}: expected {base_ret!r}, got {sub_ret!r}"))
    return out


def _strip_quals(ann: str) -> str:
    return ann.split("[", 1)[0].rsplit(".", 1)[-1]


def _raises_not_implemented(fn: ast.AST) -> bool:
    """True for *required* abstract protocol methods: a bare ``raise
    NotImplementedError``.  A messaged ``raise NotImplementedError("...")``
    marks an *optional capability* (the repo convention -- e.g.
    ``DeliveryStrategy.localize`` explains which strategies lack a shard
    transform), which plugins may legitimately leave unimplemented."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Raise):
            exc = node.exc
            if exc is None:
                continue
            if isinstance(exc, ast.Name) \
                    and exc.id == "NotImplementedError":
                return True
            if isinstance(exc, ast.Call) and not exc.args \
                    and _simple_name(exc.func) == "NotImplementedError":
                return True
    return False


def _check_stream_probes(mod: ModuleInfo) -> List[Finding]:
    """StreamProbe(...) constructions: ``update`` must be a 2-arg
    callable, ``init`` a 1-arg one (the device), ``needs`` one of
    "spiked" | "ctx"."""
    out = []
    local_defs = {fi.node.name: fi for fi in mod.functions.values()}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if _simple_name(node.func) != "StreamProbe":
            continue
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        for field, want in STREAM_PROBE_ARITY.items():
            val = kw.get(field)
            if isinstance(val, ast.Name) and val.id in local_defs:
                fn = local_defs[val.id].node
                got = len(_positional_params(fn))
                if got != want:
                    out.append(Finding(
                        "RL003", mod.path, fn.lineno,
                        local_defs[val.id].qualname,
                        f"StreamProbe {field}= callable must take exactly "
                        f"{want} argument(s), got {got}"))
            elif isinstance(val, ast.Lambda):
                got = len(val.args.posonlyargs + val.args.args)
                if got != want:
                    out.append(Finding(
                        "RL003", mod.path, val.lineno, "<lambda>",
                        f"StreamProbe {field}= callable must take exactly "
                        f"{want} argument(s), got {got}"))
        needs = kw.get("needs")
        if isinstance(needs, ast.Constant) and needs.value not in (
                "spiked", "ctx"):
            out.append(Finding(
                "RL003", mod.path, needs.lineno, "<StreamProbe>",
                f"StreamProbe needs= must be 'spiked' or 'ctx', "
                f"got {needs.value!r}"))
    return out


# ---------------------------------------------------------------------------
# RL004 -- dtype discipline
# ---------------------------------------------------------------------------

def _enclosing_symbol(mod: ModuleInfo, lineno: int) -> str:
    best = "<module>"
    best_span = None
    for q, fi in mod.functions.items():
        end = getattr(fi.node, "end_lineno", fi.node.lineno)
        if fi.node.lineno <= lineno <= end:
            span = end - fi.node.lineno
            if best_span is None or span < best_span:
                best, best_span = q, span
    return best


_F64_ATTRS = frozenset({"float64", "double", "complex128", "float128"})


def check_rl004(mod: ModuleInfo) -> List[Finding]:
    out = []
    seen: Set[int] = set()
    for node in ast.walk(mod.tree):
        bad = None
        if isinstance(node, ast.Attribute) and node.attr in _F64_ATTRS:
            dotted = _dotted(node)
            # ``x.double`` alone is a method, not the dtype (``.double()``
            # is spelled out below); ``torch.double`` / ``np.double`` are
            if node.attr != "double" or (dotted or "").split(".")[0] in (
                    "torch", "np", "numpy"):
                bad = dotted or node.attr
        elif isinstance(node, ast.Name) and node.id == "float64":
            bad = "float64"
        elif isinstance(node, ast.keyword) and node.arg == "dtype" \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "float":
            bad = "dtype=float"
        if bad is None or node.lineno in seen:
            continue
        seen.add(node.lineno)
        out.append(Finding(
            "RL004", mod.path, node.lineno,
            _enclosing_symbol(mod, node.lineno),
            f"{bad} in device-code scope -- the engine is f32/bf16; "
            f"double precision silently promotes the whole expression"))
    return out


# ---------------------------------------------------------------------------
# RL005 -- shared mutable state without a lock (serve layer)
# ---------------------------------------------------------------------------

def _module_level_mutables(mod: ModuleInfo) -> Dict[str, int]:
    names: Dict[str, int] = {}
    for node in mod.tree.body:
        targets = ()
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = (node.target,), node.value
        if value is None:
            continue
        is_mut = isinstance(value, (ast.Dict, ast.List, ast.Set,
                                    ast.ListComp, ast.DictComp,
                                    ast.SetComp))
        if isinstance(value, ast.Call):
            name = _simple_name(value.func)
            is_mut = name in _MUTABLE_CTORS
        if not is_mut:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                names[t.id] = node.lineno
    return names


def _is_lockish(expr) -> bool:
    dotted = _dotted(expr if not isinstance(expr, ast.Call)
                     else expr.func) or ""
    return "lock" in dotted.lower()


def check_rl005(mod: ModuleInfo) -> List[Finding]:
    shared = _module_level_mutables(mod)
    if not shared:
        return []
    out = []

    def mutated_name(node) -> Optional[str]:
        # X[k] = / del X[k] / X[k] += ...
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in shared:
                    return t.value.id
        if isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in shared:
                    return t.value.id
        # X.append(...) etc.
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in shared:
            return node.func.value.id
        return None

    def walk(node, locked: bool):
        for child in ast.iter_child_nodes(node):
            child_locked = locked
            if isinstance(child, ast.With):
                if any(_is_lockish(item.context_expr)
                       for item in child.items):
                    child_locked = True
            name = mutated_name(child)
            if name is not None and not locked:
                # the reference's words, so that either package's report
                # of one finding reads the same
                out.append(Finding(
                    "RL005", mod.path, child.lineno,
                    _enclosing_symbol(mod, child.lineno),
                    f"module-level mutable {name!r} mutated outside a "
                    f"threading.Lock/RLock `with` block \u2014 the serve "
                    f"layer multiplexes threads over shared state"))
            walk(child, child_locked)

    walk(mod.tree, locked=False)
    return out


# ---------------------------------------------------------------------------
# Unreachable-module detection (the dead-weight report)
# ---------------------------------------------------------------------------

def module_import_graph(modules: Sequence[ModuleInfo],
                        package: str = "repro_torch") -> Dict[str, Set[str]]:
    known = {m.modname for m in modules}
    graph: Dict[str, Set[str]] = {}
    for m in modules:
        deps: Set[str] = set()
        for tgt in m.imports.values():
            if not tgt.startswith(package + ".") and tgt != package:
                continue
            # "a.b.c" may be module.attr -- credit the longest known prefix
            parts = tgt.split(".")
            for end in range(len(parts), 0, -1):
                cand = ".".join(parts[:end])
                if cand in known:
                    deps.add(cand)
                    break
            # importing a submodule executes every ancestor __init__
            for end in range(1, len(parts)):
                anc = ".".join(parts[:end])
                if anc in known:
                    deps.add(anc)
        graph[m.modname] = deps
    return graph


def unreachable_modules(modules: Sequence[ModuleInfo],
                        entry_modules: Sequence[str],
                        package: str = "repro_torch") -> List[str]:
    """Modules under ``package`` not reachable from the entry set: the
    dead-weight candidates.

    Roots are the named entry modules plus every indexed module *outside*
    the package (entry scripts: examples, benchmarks -- whatever they
    import is alive by definition).  Only ``package.*`` modules are ever
    reported."""
    graph = module_import_graph(modules, package)
    in_pkg = {m for m in graph
              if m == package or m.startswith(package + ".")}
    seen: Set[str] = set()
    work = [e for e in entry_modules if e in graph]
    work.extend(m for m in graph if m not in in_pkg)
    while work:
        cur = work.pop()
        if cur in seen:
            continue
        seen.add(cur)
        work.extend(graph.get(cur, ()))
        # a reachable module makes its ancestor packages reachable too
        parts = cur.split(".")
        for end in range(1, len(parts)):
            anc = ".".join(parts[:end])
            if anc in graph and anc not in seen:
                work.append(anc)
    return sorted(in_pkg - seen)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def iter_py_files(paths: Sequence[str]) -> List[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def index_paths(paths: Sequence[str],
                repo_root: str = ".") -> List[ModuleInfo]:
    return [index_module(f, repo_root) for f in iter_py_files(paths)]


def lint_modules(modules: Sequence[ModuleInfo],
                 config: Optional[LintConfig] = None) -> List[Finding]:
    config = config or LintConfig()
    findings: List[Finding] = []
    rules = set(config.rules)
    hot = hot_functions(modules, config.roots)
    for fi in hot.values():
        if "RL001" in rules:
            findings.extend(check_rl001(fi, config.traced_params))
        if "RL002" in rules:
            findings.extend(check_rl002(fi, config.traced_params))
    if "RL003" in rules:
        findings.extend(check_rl003(modules, config.protocol_bases))
    seen_rl004: Set[Tuple[str, int]] = set()
    for m in modules:
        if "RL004" in rules and any(s in m.path
                                    for s in config.dtype_scopes):
            for f in check_rl004(m):
                if (f.path, f.line) not in seen_rl004:
                    seen_rl004.add((f.path, f.line))
                    findings.append(f)
        if "RL005" in rules and any(s in m.path
                                    for s in config.shared_state_scopes):
            findings.extend(check_rl005(m))
    # RL004 findings for hot functions in out-of-scope modules
    if "RL004" in rules:
        for fi in hot.values():
            m = fi.module
            if any(s in m.path for s in config.dtype_scopes):
                continue
            for f in check_rl004(m):
                if f.symbol == fi.qualname \
                        and (f.path, f.line) not in seen_rl004:
                    seen_rl004.add((f.path, f.line))
                    findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths: Sequence[str], config: Optional[LintConfig] = None,
               repo_root: str = ".") -> List[Finding]:
    """Index and lint ``paths`` (files or directories)."""
    return lint_modules(index_paths(paths, repo_root), config)
