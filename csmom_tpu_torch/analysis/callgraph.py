"""Alias-aware project call graph and per-object lock identities.

Counterpart of :mod:`csmom_tpu.analysis.callgraph`: the whole-program
layer the project-scope rules share.

- **module naming**: every scanned file gets a dotted module name from
  its repo-relative path (``csmom_tpu_torch/serve/router.py`` ->
  ``csmom_tpu_torch.serve.router``; ``__init__.py`` names its package);
- **function index**: module functions, class methods and nested defs,
  each a :class:`FunctionInfo` with a stable qualified name;
- **call resolution**: call sites resolve through the per-file alias
  maps (absolute and relative imports, one re-export hop), ``self``
  methods with single-base inheritance, ``self.attr.method()`` through
  the types ``__init__`` assigns, and local ``x = ClassName(...)``
  bindings;
- **lock identities**: every ``self._lock = threading.Lock()`` is a
  node (``module.Class._lock``), module-level locks likewise;
  ``threading.Condition(self._lock)`` aliases the lock it wraps;
- **held-lock regions**: per function, which calls run while which
  locks are held, and which locks are taken while others are held;
- **bounded closures**: ``acquired_closure`` (locks a call may take,
  with the call chain as evidence) and ``blocking_reach`` (the first
  chain to a blocking primitive), memoized and cut at
  :data:`MAX_CHAIN_DEPTH` hops.

Resolution is static and best-effort: callables stored in dicts,
``**kwargs`` forwarding and monkeypatching are invisible, and closures
stop at :data:`MAX_CHAIN_DEPTH`.  A miss makes a rule quieter, never
wrong about what it reports.  Stdlib-only and clock-free.
"""

from __future__ import annotations

import ast
import dataclasses
import os

__all__ = [
    "CallSite",
    "ClassInfo",
    "FunctionInfo",
    "MAX_CHAIN_DEPTH",
    "ProjectContext",
    "module_name_for",
]

# interprocedural closures stop after this many call hops: deep enough
# for every real chain in the tree (the longest serve-path chain is 4),
# shallow enough that a pathological call web cannot make the sweep
# quadratic
MAX_CHAIN_DEPTH = 6

_LOCK_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
}

# attribute names that read as indefinite blocking primitives when
# called on ANY receiver (socket family, thread joins, engine dispatch).
# ``Condition.wait`` is deliberately absent: it RELEASES the lock it
# waits on, which is the one blocking call that is correct under a lock.
BLOCKING_ATTRS = frozenset({
    "send", "sendall", "recv", "recv_into", "connect", "accept",
    "dispatch",
})


def module_name_for(rel: str) -> str:
    """Dotted module name for a repo-relative path (posix or native)."""
    rel = rel.replace(os.sep, "/")
    if rel.endswith(".py"):
        rel = rel[:-3]
    if rel.endswith("/__init__"):
        rel = rel[: -len("/__init__")]
    return rel.replace("/", ".")


@dataclasses.dataclass
class CallSite:
    """One call made by one function: where, to what (as resolved)."""

    line: int
    callee: str | None = None   # qname of a resolved project function
    origin: str | None = None   # dotted origin for external/unresolved
    attr: str | None = None     # raw trailing name (``.sendall`` etc.)
    has_args: bool = False      # any positional/keyword argument present
    held: tuple = ()            # lock ids held at the call site
    anon_held: int = 0          # locally-scoped/anonymous locks held


@dataclasses.dataclass
class ClassInfo:
    """One project class: bases, attribute types, and lock attributes."""

    qname: str
    module: str
    name: str
    node: ast.ClassDef
    rel: str
    bases: tuple = ()           # project-resolved base class qnames
    attr_types: dict = dataclasses.field(default_factory=dict)
    lock_attrs: dict = dataclasses.field(default_factory=dict)
    # condition attr -> the lock attr it wraps (None = its own lock)
    cond_alias: dict = dataclasses.field(default_factory=dict)
    methods: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FunctionInfo:
    """One function/method/nested def and its analyzed body."""

    qname: str
    module: str
    cls: str | None             # owning class qname, None for functions
    name: str
    node: ast.AST
    ctx: object                 # the owning FileContext
    rel: str
    line: int
    calls: list = dataclasses.field(default_factory=list)
    # (outer lock id, inner lock id, line): a DIRECT nested acquisition
    order_pairs: list = dataclasses.field(default_factory=list)
    # (lock id, line): every structured acquisition this body makes
    acquires: list = dataclasses.field(default_factory=list)
    nested: dict = dataclasses.field(default_factory=dict)


class ProjectContext:
    """The whole-program index the project-scope rules share.

    Construction is cheap (it keeps references); the graph is built on
    first access so a project rule that never touches it (the
    compile-surface check) costs nothing.
    """

    def __init__(self, contexts: dict, repo: str):
        self.contexts = contexts        # rel -> FileContext (parse slots)
        self.repo = repo
        self.run = None                 # attached by run_lint
        self._built = False
        self.modules: dict = {}         # dotted module -> FileContext
        self.functions: dict = {}       # qname -> FunctionInfo
        self.classes: dict = {}         # qname -> ClassInfo
        self.module_locks: dict = {}    # lock id -> kind
        self.lock_kinds: dict = {}      # every lock id -> kind
        self._rel_aliases: dict = {}    # rel -> relative-import overlay
        self._closure_memo: dict = {}
        self._blocking_memo: dict = {}
        self._resolve_memo: dict = {}
        self.serve_batch_factories: list = []   # qnames bound as batch_fn

    # ------------------------------------------------------------ report --

    def report(self, rule: str, rel: str, line: int, message: str,
               chain: tuple = ()) -> None:
        """Route a project finding through the owning file's pragma
        machinery (so ``lint: allow[...]`` works for project rules
        exactly like file rules); files outside the scan report raw."""
        slot = self.contexts.get(rel)
        if slot is not None:
            slot.report(rule, line, message, chain=chain)
        else:
            self.run.report(rule, rel, line, message, chain=chain)

    def scanned_rels(self) -> set:
        return {rel.replace(os.sep, "/") for rel in self.contexts}

    # ------------------------------------------------------------- build --

    def build(self) -> "ProjectContext":
        if self._built:
            return self
        self._built = True
        for rel, ctx in self.contexts.items():
            if getattr(ctx, "tree", None) is None:
                continue                # cache-replayed slot, no parse
            mod = module_name_for(rel)
            self.modules[mod] = ctx
            self._rel_aliases[rel] = self._relative_imports(ctx, mod)
        for mod, ctx in self.modules.items():
            self._index_module(mod, ctx)
        for mod, ctx in self.modules.items():
            self._resolve_bases(mod, ctx)
        for info in list(self.functions.values()):
            self._analyze_body(info)
        # the callables registered as ``batch_fn=<name>`` (a keyword
        # anywhere in a module): the factories whose inner functions are
        # the serve scorers, a graph root of helper-hygiene
        for mod, ctx in self.modules.items():
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                for kw in node.keywords:
                    if kw.arg == "batch_fn" and isinstance(kw.value,
                                                           ast.Name):
                        q = self.resolve_dotted(
                            self._origin_of(ctx, kw.value)
                            or f"{mod}.{kw.value.id}")
                        if q:
                            self.serve_batch_factories.append(q)
        return self

    @staticmethod
    def _relative_imports(ctx, mod: str) -> dict:
        """Local name -> absolute dotted origin for relative imports
        (``from . import b`` / ``from .helpers import slow_push``) —
        the one import form the per-file alias map cannot resolve,
        because only the project layer knows the file's package."""
        is_pkg = ctx.rel.replace(os.sep, "/").endswith("__init__.py")
        pkg_parts = mod.split(".") if is_pkg else mod.split(".")[:-1]
        out: dict = {}
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.ImportFrom) and node.level > 0):
                continue
            base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
            if node.module:
                base = base + node.module.split(".")
            for a in node.names:
                out[a.asname or a.name] = ".".join(base + [a.name])
        return out

    def _origin_of(self, ctx, node):
        """Alias-map resolution, relative imports included."""
        if isinstance(node, ast.Name):
            overlay = self._rel_aliases.get(ctx.rel, {})
            if node.id in overlay:
                return overlay[node.id]
            return ctx.imports.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._origin_of(ctx, node.value)
            return f"{base}.{node.attr}" if base else None
        return ctx.resolve(node)

    # ------------------------------------------------------------ indexing

    def _index_module(self, mod: str, ctx) -> None:
        for node in ctx.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(mod, None, f"{mod}.{node.name}", node,
                                   ctx)
            elif isinstance(node, ast.ClassDef):
                self._index_class(mod, node, ctx)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                kind = _LOCK_CTORS.get(
                    self._origin_of(ctx, node.value.func) or "")
                if kind:
                    lid = f"{mod}.{node.targets[0].id}"
                    self.module_locks[lid] = kind
                    self.lock_kinds[lid] = kind

    def _index_class(self, mod: str, node: ast.ClassDef, ctx) -> None:
        qname = f"{mod}.{node.name}"
        info = ClassInfo(qname=qname, module=mod, name=node.name,
                         node=node, rel=ctx.rel)
        self.classes[qname] = info
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                m = self._add_function(mod, qname,
                                       f"{qname}.{item.name}", item, ctx)
                info.methods[item.name] = m.qname
        # self-type inference + lock identities: every ``self.X = ...``
        # in ANY method (``__init__`` is just the usual home)
        for item in ast.walk(node):
            if not (isinstance(item, ast.Assign) and len(item.targets) == 1
                    and isinstance(item.targets[0], ast.Attribute)
                    and isinstance(item.targets[0].value, ast.Name)
                    and item.targets[0].value.id == "self"):
                continue
            attr = item.targets[0].attr
            if not isinstance(item.value, ast.Call):
                continue
            origin = self._origin_of(ctx, item.value.func)
            kind = _LOCK_CTORS.get(origin or "")
            if kind == "condition":
                wrapped = None
                if (item.value.args
                        and isinstance(item.value.args[0], ast.Attribute)
                        and isinstance(item.value.args[0].value, ast.Name)
                        and item.value.args[0].value.id == "self"):
                    wrapped = item.value.args[0].attr
                info.cond_alias[attr] = wrapped
                if wrapped is None:
                    # a bare Condition() wraps an RLock (CPython
                    # default) — reentrant; a Condition over an
                    # unresolvable lock expression keeps kind
                    # "condition" (unknown backing: the rule stays
                    # quiet rather than call legal code a deadlock)
                    lid = f"{qname}.{attr}"
                    own_kind = ("rlock" if not item.value.args
                                else "condition")
                    info.lock_attrs[attr] = own_kind
                    self.lock_kinds[lid] = own_kind
            elif kind:
                info.lock_attrs[attr] = kind
                self.lock_kinds[f"{qname}.{attr}"] = kind
            elif origin:
                tcls = self._class_for_origin(origin, ctx)
                if tcls:
                    info.attr_types[attr] = tcls

    def _class_for_origin(self, origin: str, ctx) -> str | None:
        # ``self._svc = ServeService(...)``: ServeService may be local
        # to the module or imported — try the local class first
        mod = module_name_for(ctx.rel)
        if f"{mod}.{origin}" in self.classes or "." not in origin:
            return (f"{mod}.{origin}"
                    if f"{mod}.{origin}" in self.classes else None)
        return origin if origin in self.classes else None

    def _add_function(self, mod, cls, qname, node, ctx) -> FunctionInfo:
        info = FunctionInfo(qname=qname, module=mod, cls=cls,
                            name=node.name, node=node, ctx=ctx,
                            rel=ctx.rel, line=node.lineno)
        self.functions[qname] = info
        for sub in ast.iter_child_nodes(node):
            self._index_nested(info, sub)
        return info

    def _index_nested(self, parent: FunctionInfo, node) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and sub is not parent.node:
                q = f"{parent.qname}.{sub.name}"
                if q not in self.functions:
                    child = FunctionInfo(
                        qname=q, module=parent.module, cls=parent.cls,
                        name=sub.name, node=sub, ctx=parent.ctx,
                        rel=parent.rel, line=sub.lineno)
                    self.functions[q] = child
                    parent.nested[sub.name] = q

    def _resolve_bases(self, mod: str, ctx) -> None:
        for node in ctx.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            info = self.classes[f"{mod}.{node.name}"]
            bases = []
            for b in node.bases:
                origin = self._origin_of(ctx, b)
                name = b.id if isinstance(b, ast.Name) else None
                cand = None
                if origin and origin in self.classes:
                    cand = origin
                elif name and f"{mod}.{name}" in self.classes:
                    cand = f"{mod}.{name}"
                elif origin:
                    cand = self._reexport_class(origin)
                if cand:
                    bases.append(cand)
            info.bases = tuple(bases)

    def _reexport_class(self, dotted: str, depth: int = 0) -> str | None:
        """Follow one re-export hop for class names (``from core import
        LintRule`` re-exported through a package ``__init__``)."""
        if depth > 3 or dotted in self.classes:
            return dotted if dotted in self.classes else None
        head, _, tail = dotted.rpartition(".")
        ctx = self.modules.get(head)
        if ctx is None:
            return None
        target = (self._rel_aliases.get(ctx.rel, {}).get(tail)
                  or ctx.imports.get(tail))
        return self._reexport_class(target, depth + 1) if target else None

    # ----------------------------------------------------- call resolution

    def _method_lookup(self, cls_qname: str, name: str,
                       depth: int = 0) -> str | None:
        info = self.classes.get(cls_qname)
        if info is None or depth > 4:
            return None
        if name in info.methods:
            return info.methods[name]
        for b in info.bases:
            hit = self._method_lookup(b, name, depth + 1)
            if hit:
                return hit
        return None

    def resolve_dotted(self, dotted: str, depth: int = 0) -> str | None:
        """Dotted origin -> function qname (one re-export hop, class
        constructor -> ``__init__``, ``Module.Class.method``)."""
        if depth > 4 or not dotted:
            return None
        key = dotted
        if key in self._resolve_memo and depth == 0:
            return self._resolve_memo[key]
        out = None
        if dotted in self.functions:
            out = dotted
        else:
            parts = dotted.split(".")
            for i in range(len(parts) - 1, 0, -1):
                mod = ".".join(parts[:i])
                ctx = self.modules.get(mod)
                if ctx is None:
                    continue
                attrs = parts[i:]
                if len(attrs) == 1:
                    q = f"{mod}.{attrs[0]}"
                    if q in self.functions:
                        out = q
                    elif q in self.classes:
                        out = self._method_lookup(q, "__init__")
                    else:
                        target = (self._rel_aliases.get(ctx.rel, {})
                                  .get(attrs[0])
                                  or ctx.imports.get(attrs[0]))
                        if target and target != dotted:
                            out = self.resolve_dotted(target, depth + 1)
                elif len(attrs) == 2:
                    cls_q = f"{mod}.{attrs[0]}"
                    if cls_q in self.classes:
                        out = self._method_lookup(cls_q, attrs[1])
                break
        if depth == 0:
            self._resolve_memo[key] = out
        return out

    # ------------------------------------------------------- body analysis

    def _lock_identity(self, info: FunctionInfo, expr,
                       local_locks: set) -> tuple:
        """``(lock_id | None, lockish)`` for a with-item/receiver.

        ``lock_id`` is a graph node (per-class attr or module lock);
        ``lockish`` True means "this is a lock even if anonymous" (a
        locally-created lock, a ``state['lock']`` subscript) — held for
        blocking checks, invisible to the order graph."""
        cls = self.classes.get(info.cls) if info.cls else None
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and cls is not None):
            attr = expr.attr
            if attr in cls.cond_alias:
                wrapped = cls.cond_alias[attr]
                return (f"{cls.qname}.{wrapped or attr}", True)
            if attr in cls.lock_attrs:
                return (f"{cls.qname}.{attr}", True)
            if "lock" in attr.lower():
                # a lock attr assigned outside this class body (mixin,
                # late init): still a per-object identity
                lid = f"{cls.qname}.{attr}"
                self.lock_kinds.setdefault(lid, "lock")
                return (lid, True)
            return (None, False)
        if isinstance(expr, ast.Name):
            lid = f"{info.module}.{expr.id}"
            if lid in self.module_locks:
                return (lid, True)
            if expr.id in local_locks:
                return (None, True)
            return (None, "lock" in expr.id.lower())
        if isinstance(expr, ast.Subscript):
            s = expr.slice
            if (isinstance(s, ast.Constant) and isinstance(s.value, str)
                    and "lock" in s.value.lower()):
                return (None, True)
        if isinstance(expr, ast.Attribute) and "lock" in expr.attr.lower():
            return (None, True)
        return (None, False)

    def _analyze_body(self, info: FunctionInfo) -> None:
        ctx = info.ctx
        cls = self.classes.get(info.cls) if info.cls else None

        # local inference: ``x = ClassName(...)`` and local lock ctors
        local_types: dict = {}
        local_locks: set = set()
        for node in self._own_walk(info.node):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                origin = self._origin_of(ctx, node.value.func)
                name = node.targets[0].id
                if origin in _LOCK_CTORS:
                    local_locks.add(name)
                elif origin:
                    tcls = self._class_for_origin(origin, ctx)
                    if tcls:
                        local_types[name] = tcls
                elif (isinstance(node.value.func, ast.Name)
                        and f"{info.module}.{node.value.func.id}"
                        in self.classes):
                    local_types[name] = (
                        f"{info.module}.{node.value.func.id}")

        def resolve_call(call: ast.Call) -> CallSite:
            f = call.func
            site = CallSite(line=call.lineno,
                            has_args=bool(call.args or call.keywords))
            if isinstance(f, ast.Name):
                site.attr = f.id
                if f.id in info.nested:
                    site.callee = info.nested[f.id]
                    return site
                if f"{info.module}.{f.id}" in self.functions:
                    site.callee = f"{info.module}.{f.id}"
                    return site
                if f"{info.module}.{f.id}" in self.classes:
                    site.callee = self._method_lookup(
                        f"{info.module}.{f.id}", "__init__")
                    site.origin = f"{info.module}.{f.id}"
                    return site
                origin = self._origin_of(ctx, f)
                site.origin = origin
                if origin:
                    site.callee = self.resolve_dotted(origin)
                return site
            if isinstance(f, ast.Attribute):
                site.attr = f.attr
                recv = f.value
                if isinstance(recv, ast.Name) and recv.id == "self" \
                        and cls is not None:
                    site.callee = self._method_lookup(cls.qname, f.attr)
                    return site
                if (isinstance(recv, ast.Attribute)
                        and isinstance(recv.value, ast.Name)
                        and recv.value.id == "self" and cls is not None):
                    tcls = cls.attr_types.get(recv.attr)
                    if tcls:
                        site.callee = self._method_lookup(tcls, f.attr)
                        return site
                if isinstance(recv, ast.Name) and recv.id in local_types:
                    site.callee = self._method_lookup(
                        local_types[recv.id], f.attr)
                    return site
                origin = self._origin_of(ctx, f)
                site.origin = origin
                if origin:
                    site.callee = self.resolve_dotted(origin)
                return site
            return site

        def scan(node, held: tuple, anon: int) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return              # deferred body: its own FunctionInfo
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_ids, new_anon = [], 0
                for item in node.items:
                    lid, lockish = self._lock_identity(
                        info, item.context_expr, local_locks)
                    if lid is not None:
                        new_ids.append((lid, node.lineno))
                    elif lockish:
                        new_anon += 1
                for i, (lid, line) in enumerate(new_ids):
                    info.acquires.append((lid, line))
                    for outer in held:
                        info.order_pairs.append((outer, lid, line))
                    # ``with a, b:`` acquires left-to-right — the same
                    # ordering constraint as nesting
                    for later, lline in new_ids[i + 1:]:
                        info.order_pairs.append((lid, later, lline))
                # the with-items themselves may contain calls (made
                # BEFORE the new locks are held)
                for item in node.items:
                    for sub in ast.walk(item.context_expr):
                        if isinstance(sub, ast.Call):
                            site = resolve_call(sub)
                            site.held, site.anon_held = held, anon
                            info.calls.append(site)
                for stmt in node.body:
                    scan(stmt, held + tuple(l for l, _ in new_ids),
                         anon + new_anon)
                return
            if isinstance(node, ast.Call):
                site = resolve_call(node)
                site.held, site.anon_held = held, anon
                info.calls.append(site)
            for child in ast.iter_child_nodes(node):
                scan(child, held, anon)

        for child in ast.iter_child_nodes(info.node):
            scan(child, (), 0)

    @staticmethod
    def _own_walk(fn_node):
        """Walk one function's own body, not descending into nested
        defs/lambdas (those are separate FunctionInfo nodes)."""
        stack = list(ast.iter_child_nodes(fn_node))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    # --------------------------------------------------------- closures --

    def acquired_closure(self, qname: str) -> dict:
        """lock id -> evidence chain (tuple of qnames ending at the
        acquiring function) for every lock ``qname`` may acquire,
        directly or through ≤ MAX_CHAIN_DEPTH call hops."""
        return self._closure(qname, (), 0)

    def _closure(self, qname: str, path: tuple, depth: int) -> dict:
        if qname in self._closure_memo:
            return self._closure_memo[qname]
        if depth > MAX_CHAIN_DEPTH or qname in path:
            return {}
        info = self.functions.get(qname)
        if info is None:
            return {}
        out: dict = {}
        for lid, _line in info.acquires:
            out.setdefault(lid, (qname,))
        for site in info.calls:
            if site.callee and site.callee in self.functions:
                sub = self._closure(site.callee, path + (qname,),
                                    depth + 1)
                for lid, chain in sub.items():
                    out.setdefault(lid, (qname,) + chain)
        if depth == 0:
            self._closure_memo[qname] = out
        return out

    def blocking_reach(self, qname: str) -> tuple | None:
        """``(chain, leaf description, line-in-first-hop)`` for the
        first blocking primitive reachable from ``qname`` (its own body
        included), or None.  ``chain`` is the qname path; the leaf names
        the primitive (``time.sleep``, ``.sendall``, a timeout-less
        ``join``...)."""
        return self._blocking(qname, (), 0)

    def _blocking(self, qname: str, path: tuple, depth: int):
        if qname in self._blocking_memo:
            return self._blocking_memo[qname]
        if depth > MAX_CHAIN_DEPTH or qname in path:
            return None
        info = self.functions.get(qname)
        if info is None:
            return None
        out = None
        for site in info.calls:
            leaf = self._blocking_leaf(site)
            if leaf:
                out = ((qname,), leaf, site.line)
                break
        if out is None:
            for site in info.calls:
                if site.callee and site.callee in self.functions:
                    sub = self._blocking(site.callee, path + (qname,),
                                         depth + 1)
                    if sub:
                        out = ((qname,) + sub[0], sub[1], site.line)
                        break
        if depth == 0:
            self._blocking_memo[qname] = out
        return out

    @staticmethod
    def _blocking_leaf(site: CallSite) -> str | None:
        if site.origin and (site.origin == "time.sleep"
                            or site.origin.endswith(".sleep")):
            return site.origin
        if site.callee is None and site.attr in BLOCKING_ATTRS:
            return f".{site.attr}"
        if site.callee is None and site.attr == "join" \
                and not site.has_args:
            return ".join (timeout-less)"
        return None
