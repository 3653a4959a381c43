"""The invariant rules: each one machine-checks a contract that previously
existed only as prose in CHANGES.md / ARCHITECTURE.md.

Rules are deliberately lexical/AST-level — no type inference, no
cross-module call graphs. Where a contract genuinely needs an exemption
(coordinator stamping, an executable-cache constructor), the site carries
an inline ``# lint: allow(<rule>) <reason>`` so the exemption is visible,
reasoned, and enumerable, instead of the rule being quietly weakened.

The port's own copy of ``corda_tpu/analysis/rules.py``. The six rules keep
their names, contracts and escape hatches; where a rule named JAX's idiom
it names the port's counterpart: ``no-jit-in-hotpath`` flags the per-call
kernel builds and compiles (``torch.utils.cpp_extension.load`` /
``load_inline``, ``ops/_build``'s ``load`` / ``build_all``,
``torch.compile``) and the mesh constructor ``make_mesh``, and
``no-blocking-under-lock`` counts a device ``synchronize`` where the
reference counts ``block_until_ready``.
"""

from __future__ import annotations

import ast

from .engine import FileContext, Finding, Rule

__all__ = ["ALL_RULES"]


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> str:
    """'self._db.conn.execute'-style dotted text for Name/Attribute chains
    ('' when the expression is not a plain chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _last_attr(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1] if dotted else ""


class _Imports:
    """Module-alias table for one file: which local names refer to the
    ``time`` / ``datetime`` / obs ``trace`` / obs ``telemetry`` modules,
    and which bare names are from-imported clock functions."""

    def __init__(self, tree: ast.AST):
        self.time_aliases: set[str] = set()
        self.datetime_aliases: set[str] = set()
        self.obs_trace_aliases: set[str] = set()
        self.telemetry_aliases: set[str] = set()
        self.clock_names: dict[str, str] = {}   # local name -> origin fn
        self.record_names: set[str] = set()     # from obs.trace import record
        # local name -> "inc" | "observe"  (from obs.telemetry import ...)
        self.metric_fn_names: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    if a.name == "time":
                        self.time_aliases.add(local)
                    elif a.name == "datetime":
                        self.datetime_aliases.add(local)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == "time":
                    for a in node.names:
                        self.clock_names[a.asname or a.name] = a.name
                elif mod == "datetime":
                    for a in node.names:
                        if a.name in ("datetime", "date"):
                            self.datetime_aliases.add(a.asname or a.name)
                elif mod.endswith("obs") or mod.endswith("obs.trace") \
                        or mod.endswith("obs.telemetry"):
                    for a in node.names:
                        if a.name == "trace":
                            self.obs_trace_aliases.add(a.asname or a.name)
                        elif a.name == "telemetry":
                            self.telemetry_aliases.add(a.asname or a.name)
                        elif a.name == "record" and mod.endswith("trace"):
                            self.record_names.add(a.asname or a.name)
                        elif a.name in ("inc", "observe") and \
                                mod.endswith("telemetry"):
                            self.metric_fn_names[a.asname or a.name] = a.name


_EPOCH_ATTRS = ("time", "time_ns")
_MONO_ATTRS = ("monotonic", "monotonic_ns", "perf_counter",
               "perf_counter_ns")
_DATETIME_ATTRS = ("now", "utcnow", "today")


def _clock_kind(call: ast.Call, imports: _Imports) -> str | None:
    """'epoch' | 'mono' | None for a Call node."""
    func = call.func
    if isinstance(func, ast.Name):
        origin = imports.clock_names.get(func.id)
        if origin in _EPOCH_ATTRS:
            return "epoch"
        if origin in _MONO_ATTRS:
            return "mono"
        return None
    dotted = _dotted(func)
    if not dotted or "." not in dotted:
        return None
    root, attr = dotted.split(".", 1)[0], _last_attr(dotted)
    if root in imports.time_aliases:
        if attr in _EPOCH_ATTRS:
            return "epoch"
        if attr in _MONO_ATTRS:
            return "mono"
    if root in imports.datetime_aliases and attr in _DATETIME_ATTRS:
        return "epoch"
    return None


def _walk_skip_functions(body) -> list[ast.AST]:
    """Every node under ``body`` WITHOUT descending into nested function or
    class definitions — their bodies execute at call time, not here."""
    out: list[ast.AST] = []
    stack = list(body)
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


def _in_decorator(ctx: FileContext, node: ast.AST, fn: ast.AST) -> bool:
    """Is ``node`` inside one of ``fn``'s decorator expressions (rather
    than its body)? A module-level ``fn = torch.compile(...)``-style decorator
    call parents to the FunctionDef it decorates, which must not count as
    'inside a function'."""
    cur = node
    while cur is not None and ctx.parents.get(cur) is not fn:
        cur = ctx.parents.get(cur)
    if cur is None:
        return False
    return any(cur is d or cur in ast.walk(d)
               for d in getattr(fn, "decorator_list", ()))


def _enclosing_class(ctx: FileContext, node: ast.AST) -> str:
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        cur = ctx.parents.get(cur)
    return ""


# ---------------------------------------------------------------------------
# Rule 1: no-wallclock-in-apply
# ---------------------------------------------------------------------------


class NoWallclockInApply(Rule):
    """Replicated state machines never read clocks: every replica must
    compute the same result from the same command, so expiry/TTL decisions
    compare command-carried ``issued_at`` stamps, never a local clock
    (ARCHITECTURE.md, sharded-notary TTL contract). In the consensus
    modules, epoch reads (``time.time``/``datetime.now``) are findings
    everywhere — coordinator stamping sites are the explicit, reasoned
    exceptions — and inside apply-path functions even monotonic reads are
    findings (apply must be a pure function of the command + db state)."""

    name = "no-wallclock-in-apply"
    contract = ("replicas never read clocks: apply paths are deterministic "
                "functions of (command, db); TTL expiry compares "
                "command-carried issued_at stamps")
    hint = ("carry the timestamp in the command (coordinator-stamped "
            "issued_at) and compare stamps; if this IS a coordinator "
            "stamping site, add an allow comment naming the rule with "
            "the why")
    scope = ("node/services/raft.py", "node/services/sharding.py")

    APPLY_ROOTS = ("make_apply_command",)

    def _in_apply_scope(self, ctx: FileContext, node: ast.AST) -> bool:
        for fn in ctx.enclosing_functions(node):
            name = fn.name
            if (name == "apply" or name.startswith("_apply")
                    or name in self.APPLY_ROOTS):
                return True
        return False

    def check(self, ctx: FileContext) -> list[Finding]:
        imports = _Imports(ctx.tree)
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _clock_kind(node, imports)
            if kind is None:
                continue
            if kind == "epoch":
                out.append(ctx.finding(
                    self, node,
                    f"epoch clock read ({_dotted(node.func) or 'time'}) in "
                    "a consensus module — replicas that re-apply this path "
                    "would diverge"))
            elif self._in_apply_scope(ctx, node):
                out.append(ctx.finding(
                    self, node,
                    "monotonic clock read inside an apply-path function — "
                    "apply must be deterministic in (command, db state)"))
        return out


# ---------------------------------------------------------------------------
# Rule 2: no-silent-except
# ---------------------------------------------------------------------------


class NoSilentExcept(Rule):
    """A broad ``except Exception: pass`` on a verify/notarise path can
    swallow the exact infrastructure fault the degrade machinery exists to
    surface (crypto.provider.degrade_device, node_metrics counters). Broad
    handlers must narrow the exception, count the event, or route to the
    degrade path — silence is never a handling strategy."""

    name = "no-silent-except"
    contract = ("broad exception handlers on production paths must narrow, "
                "count, or degrade — never silently pass")
    hint = ("narrow the except to the exceptions this site can actually "
            "absorb, bump a node_metrics/stats counter, or call the "
            "degrade path; best-effort tooling sites carry an allow() "
            "with the reason")

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        if isinstance(t, ast.Name):
            return t.id in ("Exception", "BaseException")
        if isinstance(t, ast.Tuple):
            return any(isinstance(e, ast.Name)
                       and e.id in ("Exception", "BaseException")
                       for e in t.elts)
        return False

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node):
                continue
            if all(isinstance(s, ast.Pass) for s in node.body):
                out.append(ctx.finding(
                    self, node,
                    "broad except with a silent pass body swallows every "
                    "failure class, including the ones the degrade path "
                    "must see"))
        return out


# ---------------------------------------------------------------------------
# Rule 3: no-jit-in-hotpath
# ---------------------------------------------------------------------------


class NoJitInHotpath(Rule):
    """One build of each kernel library and mesh: ``nvcc`` through
    ``torch.utils.cpp_extension.load`` / ``load_inline`` or ``ops/_build``,
    ``torch.compile``, or mesh construction inside a per-batch call path
    recompiles (seconds) or re-checks the devices on the hot path — the p99
    collapse class PAPERS.md attributes to recompilation hazards. Such
    calls belong at module level, behind a functools cache, or inside a
    keyed-cache constructor (``ops/kernels._fn``, which carries its own
    allow())."""

    name = "no-jit-in-hotpath"
    contract = ("one build of each kernel library and mesh: never compile "
                "a kernel or construct a mesh inside a per-batch path")
    hint = ("hoist to module level, decorate the builder with "
            "functools.lru_cache/cache, or route through the keyed "
            "library cache (ops/kernels._fn over ops/_build.load)")

    # Matched by the call's last attribute (or bare name).
    JIT_NAMES = ("load_inline", "build_all", "make_mesh")
    # Matched by the call's dotted suffix: ``load`` and ``compile`` alone
    # are too common (json.load, re.compile) to name a build.
    JIT_DOTTED = ("cpp_extension.load", "_build.load", "torch.compile")
    CACHE_DECORATORS = ("lru_cache", "cache")

    def _is_jit_call(self, call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in self.JIT_NAMES
        dotted = _dotted(func)
        if _last_attr(dotted) in self.JIT_NAMES:
            return True
        return any(dotted == d or dotted.endswith("." + d)
                   for d in self.JIT_DOTTED)

    def _cached_builder(self, fn: ast.AST) -> bool:
        for dec in getattr(fn, "decorator_list", ()):
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = target.id if isinstance(target, ast.Name) \
                else _last_attr(_dotted(target))
            if name in self.CACHE_DECORATORS:
                return True
        return False

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not self._is_jit_call(node):
                continue
            enclosing = [fn for fn in ctx.enclosing_functions(node)
                         if not _in_decorator(ctx, node, fn)]
            if not enclosing:
                continue  # module level: compiled once at import
            if any(self._cached_builder(fn) for fn in enclosing):
                continue  # functools-cached builder: one construction per key
            out.append(ctx.finding(
                self, node,
                f"{_dotted(node.func) or 'jit'}() constructed inside "
                f"{enclosing[0].name}() — a per-call kernel build or mesh "
                "construction recompiles or re-checks devices on the hot "
                "path"))
        return out


# ---------------------------------------------------------------------------
# Rules 4+5 share lock identification
# ---------------------------------------------------------------------------


_LOCK_CTORS = ("Lock", "RLock", "Condition")

# Locks whose PURPOSE is to serialize I/O on a shared connection: holding
# them across sqlite calls is the design (single-writer architecture,
# node/services/persistence.py), not a hazard. Matched by dotted suffix.
_IO_SERIALIZATION_LOCKS = ("db.lock", "db.aux_lock", "aux_lock",
                           "_db.lock", "_db.aux_lock")


class _LockTable:
    """Per-file lock inventory: attribute/variable names assigned a
    threading.Lock/RLock/Condition, with Condition names kept separately
    (their .wait() releases the lock and is exempt from blocking checks)."""

    def __init__(self, tree: ast.AST):
        self.lock_attrs: set[str] = set()
        self.condition_attrs: set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            func = node.value.func
            ctor = func.id if isinstance(func, ast.Name) \
                else _last_attr(_dotted(func))
            if ctor not in _LOCK_CTORS:
                continue
            for target in node.targets:
                name = _last_attr(_dotted(target))
                if not name:
                    continue
                if ctor == "Condition":
                    self.condition_attrs.add(name)
                self.lock_attrs.add(name)

    def is_lock_expr(self, expr: ast.AST) -> str:
        """Dotted text when ``with <expr>:`` acquires a known lock, else
        ''. Falls back to the textual convention (last attribute contains
        'lock') so locks constructed in another file still count."""
        dotted = _dotted(expr)
        if not dotted:
            return ""
        attr = _last_attr(dotted)
        if attr in self.lock_attrs or "lock" in attr.lower():
            return dotted
        return ""


def _is_io_serialization_lock(dotted: str) -> bool:
    return any(dotted.endswith(sfx) for sfx in _IO_SERIALIZATION_LOCKS)


class NoBlockingUnderLock(Rule):
    """Socket, sqlite, or device-dispatch I/O while holding a
    general-purpose mutex turns every contender on that lock into a convoy
    behind the I/O's tail latency — a p99 hazard per-stage tracing can only
    attribute after the fact. Locks guard state, not I/O: copy under the
    lock, perform the I/O outside it. Locks whose documented purpose IS
    I/O serialization (the sqlite single-writer ``db.lock``/``aux_lock``)
    are exempt by name."""

    name = "no-blocking-under-lock"
    contract = ("never hold a general-purpose threading.Lock across "
                "socket/sqlite/device I/O — copy under the lock, do the "
                "I/O outside")
    hint = ("move the blocking call outside the with-block (snapshot the "
            "state under the lock), hand the work to the owning thread, "
            "or — when the lock's purpose IS the I/O serialization — "
            "allow() the with-statement with that reason")

    SOCKET_ATTRS = ("sendall", "recv", "recv_into", "accept", "connect",
                    "connect_ex", "makefile", "create_connection",
                    "wrap_socket")
    # Project framing helpers that wrap sendall/recv on a passed socket.
    FRAMING_FNS = ("send_frame", "_send_frame", "recv_frame", "_recv_frame",
                   "recv_exact", "_recv_exact")
    SQL_ATTRS = ("execute", "executemany", "executescript", "commit",
                 "fetchone", "fetchall")
    DEVICE_ATTRS = ("verify_batch", "verify_packed", "pack_device", "warm",
                    "synchronize")

    def _blocking_call(self, call: ast.Call, imports: _Imports) -> str:
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in self.FRAMING_FNS:
                return func.id
            if imports.clock_names.get(func.id) == "sleep":
                return func.id
            return ""
        dotted = _dotted(func)
        attr = _last_attr(dotted)
        prefix = dotted[: -(len(attr) + 1)] if "." in dotted else ""
        if attr in self.SOCKET_ATTRS or attr in self.FRAMING_FNS:
            return dotted
        if attr in self.DEVICE_ATTRS:
            return dotted
        if attr == "sleep" and dotted.split(".", 1)[0] in \
                imports.time_aliases:
            return dotted
        if attr in self.SQL_ATTRS and any(
                tok in prefix for tok in ("conn", "db", "cursor")):
            return dotted
        return ""

    def check(self, ctx: FileContext) -> list[Finding]:
        table = _LockTable(ctx.tree)
        imports = _Imports(ctx.tree)
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.With):
                continue
            lock_exprs = [table.is_lock_expr(item.context_expr)
                          for item in node.items]
            lock_exprs = [e for e in lock_exprs
                          if e and not _is_io_serialization_lock(e)]
            if not lock_exprs:
                continue
            blocking: list[str] = []
            for sub in _walk_skip_functions(node.body):
                if not isinstance(sub, ast.Call):
                    continue
                name = self._blocking_call(sub, imports)
                if not name:
                    continue
                # cond.wait() RELEASES the lock while blocked — exempt on
                # the condition this with-statement holds.
                if _last_attr(name) == "wait":
                    continue
                if any(name.startswith(e + ".") for e in lock_exprs):
                    continue
                blocking.append(f"{name}():{sub.lineno}")
            if blocking:
                out.append(ctx.finding(
                    self, node,
                    f"blocking call(s) {', '.join(sorted(set(blocking)))} "
                    f"while holding {' + '.join(lock_exprs)}"))
        return out


class LockOrder(Rule):
    """Deadlock freedom by construction: the static lock-acquisition graph
    (lock A held while acquiring lock B, per class) must stay acyclic, and
    a non-reentrant Lock must never be acquired while already held. The
    sidecar scheduler, feeder, and Raft streams put 32 threading sites
    across 12 files on these edges — a cycle introduced by a future PR is
    a hang that only reproduces under load."""

    name = "lock-order"
    contract = ("the static lock-acquisition graph is acyclic and no "
                "plain Lock is re-acquired while held")
    hint = ("acquire locks in one global order (sort before acquiring, as "
            "the 2PC coordinator does with shard groups), or restructure "
            "so one thread owns the state")

    def check(self, ctx: FileContext) -> list[Finding]:
        table = _LockTable(ctx.tree)
        out: list[Finding] = []
        edges: dict[tuple[str, str], int] = {}  # (outer, inner) -> line

        def walk(body, held: list[tuple[str, int]], cls: str) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    walk(stmt.body, [], cls)
                    continue
                if isinstance(stmt, ast.ClassDef):
                    walk(stmt.body, [], f"{cls}.{stmt.name}" if cls
                         else stmt.name)
                    continue
                if isinstance(stmt, ast.With):
                    acquired = []
                    for item in stmt.items:
                        dotted = table.is_lock_expr(item.context_expr)
                        if not dotted:
                            continue
                        qual = f"{cls}:{dotted}" if cls else dotted
                        for outer, _line in held + acquired:
                            if outer == qual and _last_attr(dotted) not in \
                                    table.condition_attrs:
                                out.append(ctx.finding(
                                    self, stmt,
                                    f"{dotted} re-acquired while already "
                                    "held — a plain threading.Lock "
                                    "self-deadlocks here"))
                            elif outer != qual:
                                edges.setdefault((outer, qual), stmt.lineno)
                        acquired.append((qual, stmt.lineno))
                    walk(stmt.body, held + acquired, cls)
                    continue
                # Recurse into compound statements' bodies while keeping
                # the held stack (if/for/while/try/match all hold the lock).
                for attr in ("body", "orelse", "finalbody", "handlers",
                             "cases"):
                    sub = getattr(stmt, attr, None)
                    if isinstance(sub, list) and sub:
                        inner = []
                        for s in sub:
                            inner.extend(s.body if hasattr(s, "body")
                                         and not isinstance(s, ast.stmt)
                                         else [s])
                        walk(inner, held, cls)

        walk(list(getattr(ctx.tree, "body", ())), [], "")

        # Cycle detection over the per-file edge set.
        graph: dict[str, set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
        seen_cycles: set[frozenset] = set()
        for start in list(graph):
            stack = [(start, [start])]
            while stack:
                cur, path = stack.pop()
                for nxt in graph.get(cur, ()):
                    if nxt == start:
                        cyc = frozenset(path)
                        if cyc in seen_cycles:
                            continue
                        seen_cycles.add(cyc)
                        line = edges.get((cur, start), 1)
                        loop = " -> ".join(path + [start])
                        out.append(Finding(
                            self.name, ctx.path, line,
                            f"lock-order cycle: {loop}",
                            hint=self.hint,
                            code=ctx.line_text(line)))
                    elif nxt not in path:
                        stack.append((nxt, path + [nxt]))
        return out


# ---------------------------------------------------------------------------
# Rule 6: trace-stage-registry
# ---------------------------------------------------------------------------


class TraceStageRegistry(Rule):
    """``stage_breakdown`` attributes latency by exact span-name match; a
    span recorded under an unregistered name silently vanishes from the
    bench breakdown (no error — a missing stage). Every literal span name
    passed to ``_obs.record(...)`` must come from the obs stage registry
    (corda_tpu_torch/obs/stages.py). The telemetry plane has the same failure
    shape with the opposite sign: ``_tm.inc``/``_tm.observe`` on a name
    the registry never pre-interned RAISES at runtime — possibly only on
    a rare error path — so literal metric names must come from
    obs/telemetry.py's single-source-of-truth name registry too."""

    name = "trace-stage-registry"
    contract = ("every recorded span name is registered in obs/stages.py "
                "and every telemetry counter/histogram name in "
                "obs/telemetry.py, so breakdowns never silently drop a "
                "stage and metric updates never raise on a rare path")
    hint = ("register the name in corda_tpu_torch/obs/stages.py (breakdown "
            "stages get a slot in STAGES) or in obs/telemetry.py's "
            "COUNTER_NAMES/HISTOGRAM_NAMES, or reuse a registered name")
    exclude = ("obs/", "analysis/")

    def _registry(self):
        from ..obs import stages

        return stages.SPAN_NAMES, stages.SPAN_NAME_PREFIXES

    def _metric_registry(self):
        from ..obs import telemetry

        return telemetry.METRIC_NAMES

    def _is_record_call(self, call: ast.Call, imports: _Imports) -> bool:
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in imports.record_names
        dotted = _dotted(func)
        if _last_attr(dotted) != "record":
            return False
        root = dotted.split(".", 1)[0]
        return root in imports.obs_trace_aliases

    def _is_metric_call(self, call: ast.Call, imports: _Imports) -> bool:
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in imports.metric_fn_names
        dotted = _dotted(func)
        if _last_attr(dotted) not in ("inc", "observe"):
            return False
        root = dotted.split(".", 1)[0]
        return root in imports.telemetry_aliases

    def check(self, ctx: FileContext) -> list[Finding]:
        imports = _Imports(ctx.tree)
        track_spans = bool(imports.obs_trace_aliases or imports.record_names)
        track_metrics = bool(imports.telemetry_aliases
                             or imports.metric_fn_names)
        if not track_spans and not track_metrics:
            return []
        names, prefixes = self._registry()
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if track_metrics and self._is_metric_call(node, imports):
                if not node.args:
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str) and \
                        arg.value not in self._metric_registry():
                    out.append(ctx.finding(
                        self, arg,
                        f"metric name {arg.value!r} is not pre-interned in "
                        "obs/telemetry.py — inc/observe raises ValueError "
                        "here at runtime"))
                continue
            if not track_spans or not self._is_record_call(node, imports):
                continue
            if not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                name = arg.value
                if name in names or name.startswith(prefixes):
                    continue
                out.append(ctx.finding(
                    self, arg,
                    f"span name {name!r} is not in the obs stage registry "
                    "— stage_breakdown would silently drop it"))
            elif isinstance(arg, ast.JoinedStr) and arg.values:
                first = arg.values[0]
                if isinstance(first, ast.Constant) and \
                        isinstance(first.value, str):
                    piece = first.value
                    if not piece.startswith(prefixes):
                        out.append(ctx.finding(
                            self, arg,
                            f"dynamic span name starting {piece!r} matches "
                            "no registered prefix (obs/stages.py "
                            "SPAN_NAME_PREFIXES)"))
            # Non-literal names (variables) are checked at the site that
            # builds the literal; the registry rule stays lexical.
        return out


ALL_RULES: tuple[Rule, ...] = (
    NoWallclockInApply(),
    NoSilentExcept(),
    NoJitInHotpath(),
    NoBlockingUnderLock(),
    LockOrder(),
    TraceStageRegistry(),
)
