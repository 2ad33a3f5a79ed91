"""AST checks: host reads inside the port's op functions, and the static
arm of the concurrency checker.

Counterpart of paddle_tpu/analysis/astlint.py. Two arms:

* **The host arm** (`check_module_source`). An op function registered
  with `core.registry.register_op` runs on the card's stream, and on the
  card its segment is captured into a CUDA graph and replayed. Inside
  it, a host read of a tensor stalls the stream until the card catches
  up, and fails a capture outright; a host value computed there is
  frozen into the graph at capture. Flagged, on the op's tensors (its
  parameters after `ctx` and the names assigned from them):

  * ``host-sync``: `.item()`, `.tolist()`, `.cpu()`, `.numpy()`, and
    `np.asarray` / `np.array` of a tensor;
  * ``host-scalar``: `bool()` / `int()` / `float()` of a tensor;
  * ``device-sync``: `torch.cuda.synchronize()`;
  * ``impure-time`` / ``impure-random``: a host clock or an unseeded
    host random draw, frozen into a captured graph.

  An op registered with `host=<reason>` declares that it runs on the
  host (its segment is split there) and is not scanned. An intentional
  host boundary elsewhere is marked on its line with
  `# host-ok: <reason>`.

* **The concurrency arm** (`check_concurrency_source`), the same rules
  and markers as the JAX package's:

  * `# guarded_by(<lock>)` on a `self.<field> = ...` line declares the
    field lock-protected; touching it in another method outside a
    `with self.<lock>:` block is a `guarded-by-static` finding. Escapes:
    `# holds(<lock>)` on the `def` line (the caller holds it),
    `# unlocked-ok: <reason>` on the access line.
  * raw `threading.Lock()/RLock()/Condition()/Semaphore()` construction
    outside the `make_lock` factory -> `raw-threading-lock`
    (`# lock-ok: <reason>` escapes);
  * `.acquire(` call sites -> `lock-no-with` (same escape);
  * `threading.Thread(...)` with no `.join(` on its binding in the
    module and no `# thread-ok: <reason>` marker -> `thread-unbounded`;
  * `time.time()` where durations are measured -> `wall-clock-fake-clock`
    (`# wallclock-ok: <reason>` escapes an intentional wall stamp).

`lint_package(root)` runs both arms over every module of a package.
"""
import ast
import os
import re

HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# a tensor's metadata: Python values known on the host without a read
METADATA = frozenset({"shape", "dtype", "device", "ndim", "size", "dim",
                      "numel", "stride", "is_cuda", "layout",
                      "requires_grad", "is_contiguous", "element_size"})
HOST_ARRAY_CALLS = frozenset({
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "np.ascontiguousarray", "numpy.ascontiguousarray",
})
SCALAR_BUILTINS = frozenset({"float", "int", "bool"})
DEVICE_SYNC_CALLS = frozenset({"torch.cuda.synchronize",
                               "cuda.synchronize"})
IMPURE_TIME_CALLS = frozenset({
    "time.time", "time.monotonic", "time.perf_counter",
    "time.process_time", "datetime.datetime.now", "datetime.datetime.utcnow",
})
IMPURE_RANDOM_PREFIXES = ("random.", "np.random.", "numpy.random.")
# host RNG that is explicitly seeded / constructed is a deliberate
# constant, not a bare draw
RANDOM_ALLOWED = frozenset({
    "random.Random", "np.random.RandomState", "numpy.random.RandomState",
    "np.random.default_rng", "numpy.random.default_rng",
    "np.random.seed", "numpy.random.seed",
})

ALLOW_MARKER = "# host-ok"


class Finding:
    """One rule hit inside a scanned function."""

    __slots__ = ("rule", "func", "lineno", "detail")

    def __init__(self, rule, func, lineno, detail):
        self.rule = rule
        self.func = func
        self.lineno = lineno
        self.detail = detail

    def __repr__(self):
        return f"Finding({self.rule}, {self.func}:{self.lineno}, {self.detail})"

    def to_dict(self):
        return {"rule": self.rule, "func": self.func,
                "lineno": self.lineno, "detail": self.detail}


def _dotted(node):
    """`np.random.rand` -> "np.random.rand"; None when not a name chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root_name(node):
    """Root variable of an expression, through subscripts and method
    calls (x[0] -> x, x.float() -> x). Attribute reads and metadata
    calls (x.shape, x.size(0)) return None: they are not host reads."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            if node.func.attr in METADATA:
                return None
            node = node.func.value
        else:
            break
    if isinstance(node, ast.Name):
        return node.id
    return None


def _names_in(node):
    """Names an expression reads as tensors (not through metadata)."""
    out = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Attribute) and n.attr in METADATA:
            continue
        if isinstance(n, ast.Name):
            out.add(n.id)
        stack.extend(ast.iter_child_nodes(n))
    return out


def iter_registered_op_functions(tree):
    """Yield (op_type_or_None, FunctionDef, tensor_param_names) for every
    function decorated with @register_op(...) and no `host=` in a parsed
    module."""
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for deco in node.decorator_list:
            target = deco.func if isinstance(deco, ast.Call) else deco
            name = _dotted(target)
            if name is None or name.split(".")[-1] != "register_op":
                continue
            if isinstance(deco, ast.Call) and any(
                    k.arg == "host" for k in deco.keywords):
                break               # a declared host op
            op_type = None
            if isinstance(deco, ast.Call) and deco.args and \
                    isinstance(deco.args[0], ast.Constant):
                op_type = deco.args[0].value
            params = [a.arg for a in node.args.args[1:]]  # skip ctx
            if node.args.vararg is not None:
                params.append(node.args.vararg.arg)
            yield op_type, node, params
            break


def _tainted(fn_node, params):
    """The op's tensor names: its parameters and every name assigned
    (or looped over) from an expression that reads one, to a fixed
    point."""
    traced = set(params)
    binds = []
    for node in ast.walk(fn_node):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if node.value is not None:
                binds.append((targets, node.value))
        elif isinstance(node, (ast.For, ast.comprehension)):
            binds.append(([node.target], node.iter))
    changed = True
    while changed:
        changed = False
        for targets, value in binds:
            if _names_in(value) & traced:
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and n.id not in traced:
                            traced.add(n.id)
                            changed = True
    return traced


def check_function(fn_node, traced_params, source_lines=None,
                   func_label=None):
    """Scan one op function's body. traced_params: the names bound to
    its tensors. source_lines: the module's lines, for `# host-ok`."""
    label = func_label or fn_node.name
    traced = _tainted(fn_node, traced_params)
    findings = []

    def allowed(lineno):
        if source_lines is None:
            return False
        idx = lineno - 1
        return 0 <= idx < len(source_lines) and \
            ALLOW_MARKER in source_lines[idx]

    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call) or allowed(node.lineno):
            continue
        dotted = _dotted(node.func)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in HOST_METHODS and not node.args:
            root = _root_name(node.func.value)
            if root in traced:
                findings.append(Finding(
                    "host-sync", label, node.lineno,
                    f"{root}.{node.func.attr}() copies a tensor to the "
                    f"host: it stalls the stream and fails a CUDA-graph "
                    f"capture; keep it a tensor"))
        elif dotted in HOST_ARRAY_CALLS and node.args:
            root = _root_name(node.args[0])
            if root in traced:
                findings.append(Finding(
                    "host-sync", label, node.lineno,
                    f"{dotted}({root}) copies a tensor to the host; use "
                    f"torch"))
        elif isinstance(node.func, ast.Name) and \
                node.func.id in SCALAR_BUILTINS and node.args:
            root = _root_name(node.args[0])
            if root in traced:
                findings.append(Finding(
                    "host-scalar", label, node.lineno,
                    f"{node.func.id}({root}) reads a tensor's value on "
                    f"the host (a sync, and a capture failure); keep it "
                    f"a 0-d tensor"))
        elif dotted in DEVICE_SYNC_CALLS:
            findings.append(Finding(
                "device-sync", label, node.lineno,
                f"{dotted}() waits for the whole card inside an op and "
                f"is illegal during a CUDA-graph capture"))
        elif dotted in IMPURE_TIME_CALLS:
            findings.append(Finding(
                "impure-time", label, node.lineno,
                f"{dotted}() is read once at capture and frozen into the "
                f"replayed graph"))
        elif dotted is not None and dotted not in RANDOM_ALLOWED and \
                dotted.startswith(IMPURE_RANDOM_PREFIXES):
            findings.append(Finding(
                "impure-random", label, node.lineno,
                f"{dotted}() draws host randomness, frozen into a "
                f"captured graph; draw from the op's torch generator"))
    return findings


def check_module_source(source, path="<module>", include_plain_funcs=()):
    """Scan a module's registered op functions (and any named plain
    functions, checked for the host-sync, time and random rules with no
    tensor names) and return all findings."""
    tree = ast.parse(source, filename=path)
    lines = source.splitlines()
    findings = []
    for op_type, fn, params in iter_registered_op_functions(tree):
        label = f"{path}::{fn.name}" + (f" (op {op_type!r})"
                                        if op_type else "")
        findings.extend(check_function(fn, params, lines, label))
    if include_plain_funcs:
        wanted = set(include_plain_funcs)
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name in wanted:
                findings.extend(check_function(
                    node, (), lines, f"{path}::{node.name}"))
    return findings


# ---------------------------------------------------------------------
# the concurrency arm
# ---------------------------------------------------------------------
GUARDED_BY_RE = re.compile(r"#\s*guarded_by\(([A-Za-z_]\w*)\)")
HOLDS_RE = re.compile(r"#\s*holds\(([A-Za-z_]\w*)\)")
LOCK_OK_MARKER = "# lock-ok"
THREAD_OK_MARKER = "# thread-ok"
UNLOCKED_OK_MARKER = "# unlocked-ok"
WALLCLOCK_OK_MARKER = "# wallclock-ok"

RAW_LOCK_CTORS = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
})
WALL_CLOCK_CALLS = frozenset({"time.time"})


def _enclosing_funcs(tree):
    """id(node) -> name of the innermost enclosing function."""
    parents = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(fn):
                parents[id(sub)] = fn.name
    return parents


def _marked(lines, node, marker):
    """Is `marker` present on any source line the node spans? (a
    multi-line constructor may carry the marker on any of its lines)."""
    end = getattr(node, "end_lineno", node.lineno) or node.lineno
    for ln in range(node.lineno, end + 1):
        if 0 <= ln - 1 < len(lines) and marker in lines[ln - 1]:
            return True
    return False


def _collect_guarded_fields(cls_node, lines):
    """{field: lock} from `# guarded_by(<lock>)` comments on
    `self.<field> = ...` assignment lines anywhere in the class."""
    guarded = {}
    for node in ast.walk(cls_node):
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self":
                idx = node.lineno - 1
                if 0 <= idx < len(lines):
                    m = GUARDED_BY_RE.search(lines[idx])
                    if m:
                        guarded[t.attr] = m.group(1)
    return guarded


def _check_guarded_class(cls_node, lines, path, findings):
    guarded = _collect_guarded_fields(cls_node, lines)
    if not guarded:
        return

    def line(lineno):
        idx = lineno - 1
        return lines[idx] if 0 <= idx < len(lines) else ""

    for fn in cls_node.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name == "__init__":
            continue            # construction precedes sharing
        label = f"{path}::{cls_node.name}.{fn.name}"
        holds = set(HOLDS_RE.findall(line(fn.lineno)))

        def visit(node, active, label=label, holds=holds):
            if isinstance(node, ast.With):
                inner = set(active)
                for item in node.items:
                    d = _dotted(item.context_expr)
                    if d and d.startswith("self."):
                        inner.add(d[5:])
                    visit(item.context_expr, active)
                for child in node.body:
                    visit(child, inner)
                return
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self":
                field = node.attr
                lock = guarded.get(field)
                src = line(node.lineno)
                if lock is not None and lock not in active and \
                        lock not in holds and \
                        UNLOCKED_OK_MARKER not in src and \
                        not GUARDED_BY_RE.search(src):
                    findings.append(Finding(
                        "guarded-by-static", label, node.lineno,
                        f"self.{field} is # guarded_by({lock}) but is "
                        f"touched outside `with self.{lock}:` — hold "
                        f"the lock, mark the def `# holds({lock})`, or "
                        f"annotate the line `# unlocked-ok: <reason>`"))
            for child in ast.iter_child_nodes(node):
                visit(child, active)

        for stmt in fn.body:
            visit(stmt, set())


def check_concurrency_source(source, path="<module>", *,
                             lock_rules=True, thread_rule=True,
                             guarded_rule=True, wallclock_rule=False):
    """The static concurrency sweep over one module. Which rules apply
    is the caller's policy (`lint_package` applies all of them); the
    grammar and escapes are fixed here."""
    tree = ast.parse(source, filename=path)
    lines = source.splitlines()
    findings = []
    parents = _enclosing_funcs(tree)

    # thread bindings: which names ever get .join(...) in this module
    joined = set(re.findall(r"(\w+)\s*\.join\(", source))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            fname = parents.get(id(node), "-")
            if lock_rules and dotted in RAW_LOCK_CTORS and \
                    not _marked(lines, node, LOCK_OK_MARKER):
                findings.append(Finding(
                    "raw-threading-lock", fname, node.lineno,
                    f"{dotted}() constructed directly — use "
                    f"analysis.concurrency.make_lock/make_rlock/"
                    f"make_condition so PT_FLAGS_concurrency_check can "
                    f"track it (`# lock-ok: <reason>` to opt out)"))
            elif lock_rules and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "acquire" and \
                    not _marked(lines, node, LOCK_OK_MARKER):
                findings.append(Finding(
                    "lock-no-with", fname, node.lineno,
                    f"{_dotted(node.func) or '<expr>.acquire'}() — "
                    f"acquire locks with `with` so every exit path "
                    f"releases (`# lock-ok: <reason>` to opt out)"))
            elif thread_rule and dotted == "threading.Thread" and \
                    not _marked(lines, node, THREAD_OK_MARKER):
                bound = None
                for a in ast.walk(tree):
                    if isinstance(a, ast.Assign) and \
                            any(sub is node for sub in ast.walk(a.value)):
                        for t in a.targets:
                            if isinstance(t, ast.Attribute):
                                bound = t.attr
                            elif isinstance(t, ast.Name):
                                bound = t.id
                if bound is not None and bound not in joined:
                    # joined through a loop alias?
                    # (`for t in self._threads: t.join()`)
                    for m in re.finditer(
                            r"for\s+(\w+)\s+in\s+(?:self\.)?"
                            + re.escape(bound) + r"\b", source):
                        if m.group(1) in joined:
                            joined.add(bound)
                            break
                if bound is None or bound not in joined:
                    findings.append(Finding(
                        "thread-unbounded", fname, node.lineno,
                        f"threading.Thread bound to "
                        f"{bound or '<no name>'} has no .join() in "
                        f"this module — give it a bounded stop path "
                        f"or document the lifecycle with "
                        f"`# thread-ok: <reason>`"))
            elif wallclock_rule and dotted in WALL_CLOCK_CALLS and \
                    not _marked(lines, node, WALLCLOCK_OK_MARKER):
                findings.append(Finding(
                    "wall-clock-fake-clock", fname, node.lineno,
                    f"{dotted}() in a fake-clock-tested module — "
                    f"inject the clock (or `# wallclock-ok: <reason>` "
                    f"for an intentional wall stamp)"))
        elif guarded_rule and isinstance(node, ast.ClassDef):
            _check_guarded_class(node, lines, path, findings)
    return findings


def lint_package(root, skip=("analysis/astlint.py",)):
    """Both arms over every .py module under `root` (every concurrency
    rule, the wall-clock rule included). Returns {relative path:
    [Finding]} for the modules with findings. `skip`: relative paths not
    scanned (this module's own rule tables name what they flag)."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith(("_", ".")))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if rel in skip:
                continue
            with open(path, encoding="utf-8") as f:
                source = f.read()
            found = check_module_source(source, rel)
            found += check_concurrency_source(source, rel,
                                              wallclock_rule=True)
            if found:
                out[rel] = found
    return out
