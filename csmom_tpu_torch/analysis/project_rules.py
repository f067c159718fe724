"""The project-scope lint rules, on the call graph of
:mod:`csmom_tpu_torch.analysis.callgraph`, registered as kind-``lint``
engines like the per-file set.

Counterpart of :mod:`csmom_tpu.analysis.project_rules`, with its three
rules:

- **lock-order**: held-lock sets propagate over the call graph.  It
  reports a cycle in the global lock acquisition-order graph (lock A
  held while a chain takes B, and elsewhere B held while a chain takes
  A: the two-thread deadlock no single file shows), a blocking call
  (sleep, socket send/recv, engine dispatch, a join without timeout)
  reached under a held lock through one or more call hops, and a
  non-reentrant lock taken again through a chain (the one-lock cycle).
- **helper-hygiene**: the interprocedural twin of tracer-hygiene and
  donation-safety.  A helper that prints, reads a clock, writes a
  global, copies to the host (``np.asarray``, ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``), synchronizes the card or
  calls a donated surface is flagged at every call site of a shard's
  function (the local function handed to ``parallel/compat.py::
  shard_map``) or of a registered ``batch_fn`` scorer that can reach it
  within :data:`~csmom_tpu_torch.analysis.callgraph.MAX_CHAIN_DEPTH`
  hops.  What lies lexically inside the root is the per-file rule's.
- **compile-surface**: every dispatchable (endpoint, bucket) shape the
  serving tier admits (``registry.serve_endpoints()`` x the
  ``serve/buckets.py`` grid, the arithmetic of
  ``health.expected_entry_names``) is declared warm by a registered
  feeder's torch-free ``manifest_names_fn``.  It reads live registry
  state, so it is ``cacheable = False`` and ``needs_graph = False``.  On
  a toy tree (the fixture packages) it checks the ``LINT_SURFACE``
  literals instead, with the same arithmetic.

Stdlib-only and clock-free.
"""

from __future__ import annotations

import ast

from csmom_tpu_torch.analysis.callgraph import MAX_CHAIN_DEPTH, ProjectContext
from csmom_tpu_torch.analysis.core import ProjectRule, RunContext
from csmom_tpu_torch.analysis.rules import (
    DEVICE_SYNCS,
    HOST_MATERIALIZE,
    HOST_METHODS,
)

__all__ = [
    "CompileSurface",
    "HelperHygiene",
    "LockOrder",
    "register_project_rules",
]


def _chain_text(chain) -> str:
    return " -> ".join(chain)


# --------------------------------------------------------------------------
# lock-order
# --------------------------------------------------------------------------

class LockOrder(ProjectRule):
    """Global lock acquisition-order cycles and blocking calls hidden
    behind helpers: the two deadlock shapes no per-file rule can see."""

    id = "lock-order"
    description = ("whole-program lock discipline: the global lock "
                   "acquisition-order graph (held-lock sets propagated "
                   "over the call graph) must be acyclic, and no blocking "
                   "call (sleep/socket/dispatch/timeout-less join) may be "
                   "reachable under a held lock through any call chain")

    def run_project(self, project: ProjectContext, run: RunContext) -> None:
        project.build()
        # edge (A, B) -> evidence: (rel, line, description)
        edges: dict = {}

        def add_edge(a, b, rel, line, desc):
            if a != b:
                edges.setdefault((a, b), (rel, line, desc))

        for info in project.functions.values():
            for outer, inner, line in info.order_pairs:
                if outer == inner:
                    # a lexically nested re-acquisition (add_edge drops
                    # self-edges; the chain-based check below only sees
                    # interprocedural ones)
                    # "rlock" is reentrant; "condition" means unknown
                    # backing (an unresolvable Condition arg) — stay
                    # quiet rather than call legal code a deadlock
                    if project.lock_kinds.get(outer, "lock") not in (
                            "rlock", "condition"):
                        project.report(
                            self.id, info.rel, line,
                            f"{outer} is re-acquired inside its own "
                            f"with-block in {info.qname} — a "
                            "non-reentrant lock self-deadlocks here")
                    continue
                add_edge(outer, inner, info.rel, line,
                         f"{info.qname} acquires {inner} while "
                         f"holding {outer}")
            for site in info.calls:
                if not site.held and not site.anon_held:
                    continue
                # blocking work behind >= 1 call hop (the leaf case is
                # the per-file lock-discipline rule's finding).  An
                # ANONYMOUS lock (locally created, e.g. the router's
                # per-request state dict lock) has no order-graph node,
                # but blocking under it serializes its waiters all the
                # same
                if site.callee and site.callee in project.functions:
                    held_desc = (site.held[-1] if site.held
                                 else "a locally-scoped lock")
                    reach = project.blocking_reach(site.callee)
                    if reach is not None:
                        chain, leaf, _ = reach
                        full = (info.qname,) + chain
                        project.report(
                            self.id, info.rel, site.line,
                            f"blocking call ({leaf}) reached while "
                            f"holding {held_desc} via "
                            f"{_chain_text(full)} — every thread "
                            "contending this lock serializes behind the "
                            "hidden wait; move the blocking work outside "
                            "the critical section", chain=full)
                if not site.held:
                    continue
                if site.callee and site.callee in project.functions:
                    for lock, chain in project.acquired_closure(
                            site.callee).items():
                        full = (info.qname,) + chain
                        for held in site.held:
                            if held == lock:
                                kind = project.lock_kinds.get(lock, "lock")
                                if kind not in ("rlock", "condition"):
                                    project.report(
                                        self.id, info.rel, site.line,
                                        f"{lock} is re-acquired through "
                                        f"{_chain_text(full)} while "
                                        "already held — a non-reentrant "
                                        "lock self-deadlocks here",
                                        chain=full)
                            else:
                                add_edge(held, lock, info.rel, site.line,
                                         f"{_chain_text(full)} acquires "
                                         f"{lock} while {info.qname} "
                                         f"holds {held}")

        self._report_cycles(project, edges)

    def _report_cycles(self, project: ProjectContext, edges: dict) -> None:
        graph: dict = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        for scc in _sccs(graph):
            if len(scc) < 2:
                continue
            members = sorted(scc)
            evidence = sorted(
                ((a, b), ev) for (a, b), ev in edges.items()
                if a in scc and b in scc)
            (rel, line, _desc) = evidence[0][1]
            lines = "; ".join(ev[2] for _, ev in evidence[:4])
            project.report(
                self.id, rel, line,
                f"lock acquisition-order cycle between "
                f"{{{', '.join(members)}}}: {lines} — two threads "
                "taking these locks in opposite orders deadlock; pick "
                "ONE global order and restructure the off-order "
                "acquisition")


def _sccs(graph: dict):
    """Tarjan strongly-connected components (iterative)."""
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    out: list = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(graph.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                out.append(scc)
    return out


# --------------------------------------------------------------------------
# compile-surface
# --------------------------------------------------------------------------

class CompileSurface(ProjectRule):
    """Every dispatchable (endpoint, bucket) shape has a warmed manifest
    entry, as a static fact."""

    id = "compile-surface"
    description = ("every dispatchable shape warmed, as a static fact: "
                   "registry serve endpoints x serve/buckets.py grid must "
                   "be covered by a registered manifest feeder's "
                   "torch-free manifest_names_fn for every bucket profile")
    cacheable = False       # reads live registry state
    needs_graph = False     # never touches the call graph

    def run_project(self, project: ProjectContext, run: RunContext) -> None:
        toy = self._toy_surfaces(project)
        if toy is not None:
            self._check_toy(project, toy)
            return
        rels = project.scanned_rels()
        if ("csmom_tpu_torch/registry/core.py" not in rels
                or "csmom_tpu_torch/serve/buckets.py" not in rels):
            return      # a partial sweep cannot honestly judge coverage
        self._check_live(project)

    # ------------------------------------------------------------ live --

    def _check_live(self, project: ProjectContext) -> None:
        from csmom_tpu_torch.registry import ensure_builtin
        from csmom_tpu_torch.serve import buckets

        reg = ensure_builtin()
        anchor_rel = "csmom_tpu_torch/serve/buckets.py"
        anchor_line = self._profiles_line(project, anchor_rel)
        for profile in sorted(buckets.PROFILES):
            expected = self._expected_names(profile)
            declared = reg.manifest_entry_names(profile)
            feeders = sum(1 for spec in reg.specs()
                          if profile in spec.profiles
                          and spec.manifest_names_fn)
            if feeders == 0:
                project.report(
                    self.id, anchor_rel, anchor_line,
                    f"bucket profile {profile!r} has no registered "
                    "manifest feeder declaring warm coverage "
                    "(manifest_names_fn): every serve dispatch on this "
                    "profile would be a cold first call in the serving "
                    "window; register the "
                    "feeder (registry/builtin.py serve.buckets) or drop "
                    "the profile")
                continue
            missing = sorted(expected - declared)
            if missing:
                project.report(
                    self.id, anchor_rel, anchor_line,
                    f"{len(missing)} of {len(expected)} dispatchable "
                    f"(endpoint, bucket) shapes on profile {profile!r} "
                    "have no warmed manifest entry (first missing: "
                    f"{missing[0]}): a dispatch at that shape is a "
                    "cold first call in the serving window by "
                    "construction; cover it "
                    "in the profile's manifest feeder or shrink the "
                    "bucket grid")

    @staticmethod
    def _expected_names(profile: str) -> set:
        """The dispatchable world, derived from bucket geometry +
        registry endpoints (the same arithmetic as
        ``health.expected_entry_names``, which tests pin against this)."""
        from csmom_tpu_torch.serve.health import expected_entry_names

        return expected_entry_names(profile)

    @staticmethod
    def _slot_tree(project: ProjectContext, rel: str,
                   marker: str | None = None):
        """The slot's AST — rebuilt from the slot's retained source (or
        disk, for out-of-sweep paths) when the slot is parse-free (a
        warm-cache CachedSlot), so this rule's verdicts and anchors are
        identical cold and warm.  ``marker`` gates the parse on a cheap
        substring check first (a warm full-tree sweep must not re-parse
        150 files to learn none declares a toy surface)."""
        import os

        ctx = project.contexts.get(rel)
        tree = getattr(ctx, "tree", None)
        if tree is not None:
            return tree
        src = getattr(ctx, "src", None)
        if src is None:
            path = rel if os.path.isabs(rel) else os.path.join(
                project.repo, rel)
            try:
                with open(path, encoding="utf-8") as f:
                    src = f.read()
            except (OSError, ValueError):
                return None
        if marker is not None and marker not in src:
            return None
        try:
            return ast.parse(src)
        except (SyntaxError, ValueError):
            return None

    def _profiles_line(self, project: ProjectContext, rel: str) -> int:
        """The PROFILES assignment line in serve/buckets.py — the
        finding anchor (and therefore any pragma match), cache-blind."""
        tree = self._slot_tree(project, rel)
        if tree is None:
            return 1
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "PROFILES"
                    for t in node.targets):
                return node.lineno
        return 1

    # ------------------------------------------------------------- toy --

    def _toy_surfaces(self, project: ProjectContext):
        """Merged ``LINT_SURFACE`` literal declarations across the
        scanned files (the fixture form of the registry/bucket/manifest
        world), or None when the scan declares none."""
        merged: dict = {}
        anchor = None
        for rel in sorted(project.contexts):
            tree = self._slot_tree(project, rel, marker="LINT_SURFACE")
            if tree is None:
                continue
            for node in tree.body:
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == "LINT_SURFACE"):
                    continue
                try:
                    val = ast.literal_eval(node.value)
                except ValueError:
                    continue
                if not isinstance(val, dict):
                    continue
                for k, v in val.items():
                    if k == "warmed":
                        merged.setdefault("warmed", set()).update(v)
                    else:
                        merged[k] = v
                if "endpoints" in val and anchor is None:
                    anchor = (rel, node.lineno)
        if not merged:
            return None
        merged["_anchor"] = anchor or (next(iter(sorted(
            project.contexts))), 1)
        return merged

    def _check_toy(self, project: ProjectContext, toy: dict) -> None:
        rel, line = toy["_anchor"]
        needed = ("endpoints", "months", "asset_buckets", "batch_buckets")
        absent = [k for k in needed if k not in toy]
        if absent:
            project.report(
                self.id, rel, line,
                f"LINT_SURFACE declarations are incomplete: missing "
                f"{absent} — the toy surface must declare the full "
                "(endpoints x buckets) world to be checkable")
            return
        warmed = toy.get("warmed", set())
        M = toy["months"]
        missing = sorted(
            f"serve.{kind}.b{B}@{A}x{M}"
            for kind in toy["endpoints"]
            for B in toy["batch_buckets"] for A in toy["asset_buckets"]
            if f"serve.{kind}.b{B}@{A}x{M}" not in warmed)
        if missing:
            project.report(
                self.id, rel, line,
                f"{len(missing)} dispatchable (endpoint, bucket) "
                "shape(s) have no warmed manifest entry (first missing: "
                f"{missing[0]}): a cold first call in the serving "
                "window by construction")


# --------------------------------------------------------------------------
# helper-hygiene
# --------------------------------------------------------------------------

class HelperHygiene(ProjectRule):
    """Host syncs and donations hidden behind helpers: flagged at every
    root call site that can reach them (bounded depth)."""

    id = "helper-hygiene"
    description = ("interprocedural tracer-hygiene + donation-safety: a "
                   "helper that prints, reads a clock, copies to the host, "
                   "synchronizes the card, writes a global, or calls a "
                   "donated surface is flagged at every shard_map / "
                   "ServeSurface batch_fn call site that can reach it "
                   "(bounded depth, alias map reused)")

    def run_project(self, project: ProjectContext, run: RunContext) -> None:
        project.build()
        self._taint_memo: dict = {}
        reported: set = set()
        for root in self._roots(project):
            self._sweep_root(project, root, reported)

    @staticmethod
    def _roots(project: ProjectContext) -> list:
        """The local functions handed to ``shard_map`` and the registered
        ``batch_fn`` factories with the scorers they define."""
        roots: set = set()
        for info in project.functions.values():
            for site in info.calls:
                if not ((site.origin or "").endswith("shard_map")
                        or (site.callee is None and site.attr == "shard_map")):
                    continue
                for sub in ProjectContext._own_walk(info.node):
                    if (isinstance(sub, ast.Call) and sub.lineno == site.line
                            and sub.args and isinstance(sub.args[0], ast.Name)):
                        q = (info.nested.get(sub.args[0].id)
                             or project.resolve_dotted(
                                 f"{info.module}.{sub.args[0].id}"))
                        if q:
                            roots.add(q)
        for q in project.serve_batch_factories:
            factory = project.functions.get(q)
            if factory is not None:
                roots.update(factory.nested.values())
                roots.add(q)
        return sorted(roots)

    def _direct_taints(self, project: ProjectContext, qname: str) -> list:
        if qname in self._taint_memo:
            return self._taint_memo[qname]
        info = project.functions.get(qname)
        out: list = []
        if info is None:
            self._taint_memo[qname] = out
            return out
        globals_declared: set = set()
        for sub in ProjectContext._own_walk(info.node):
            if isinstance(sub, ast.Global):
                globals_declared |= set(sub.names)
        for sub in ProjectContext._own_walk(info.node):
            if isinstance(sub, (ast.Assign, ast.AugAssign)):
                tgts = (sub.targets if isinstance(sub, ast.Assign)
                        else [sub.target])
                for t in tgts:
                    if isinstance(t, ast.Name) and t.id in globals_declared:
                        out.append(("global write", sub.lineno, t.id))
        for site in info.calls:
            origin = site.origin or ""
            if site.callee is None and site.attr == "print":
                out.append(("print (host I/O)", site.line, "print"))
            elif origin.startswith("time.") or origin.endswith(".mono_now_s"):
                out.append(("clock read", site.line, origin))
            elif origin in HOST_MATERIALIZE:
                out.append(("host materialization", site.line, origin))
            elif origin in DEVICE_SYNCS:
                out.append(("device sync", site.line, origin))
            elif (site.callee is None and not site.has_args
                    and site.attr in HOST_METHODS
                    and not origin.startswith("numpy.")):
                out.append(("host copy", site.line, f".{site.attr}()"))
            if site.attr and "donated" in site.attr:
                out.append(("donated-buffer entry call", site.line,
                            site.attr))
        self._taint_memo[qname] = out
        return out

    def _sweep_root(self, project: ProjectContext, root: str,
                    reported: set) -> None:
        if project.functions.get(root) is None:
            return
        # breadth-first over the project's call edges, depth >= 1 only:
        # what lies lexically inside the root is tracer-hygiene's
        seen = {root}
        frontier = [(root, (root,), None)]
        for _depth in range(MAX_CHAIN_DEPTH):
            nxt = []
            for qname, chain, first_site in frontier:
                fi = project.functions.get(qname)
                if fi is None:
                    continue
                for site in fi.calls:
                    callee = site.callee
                    if not callee or callee not in project.functions \
                            or callee in seen:
                        continue
                    seen.add(callee)
                    entry_site = first_site or (fi.rel, site.line)
                    for kind, tline, detail in self._direct_taints(project,
                                                                   callee):
                        key = (root, callee, kind, detail)
                        if key in reported:
                            continue
                        reported.add(key)
                        full = chain + (callee,)
                        rel, line = entry_site
                        project.report(
                            self.id, rel, line,
                            f"traced function {root} reaches "
                            f"{kind} ({detail}) in {callee} "
                            f"(line {tline}) via {_chain_text(full)} — a "
                            "helper does not hide a host sync: it runs on "
                            "every call of the shard function or scorer",
                            chain=full)
                    nxt.append((callee, chain + (callee,), entry_site))
            frontier = nxt
            if not frontier:
                break


# --------------------------------------------------------------------------
# registration
# --------------------------------------------------------------------------

PROJECT_RULES = (LockOrder, HelperHygiene, CompileSurface)


def register_project_rules() -> None:
    """Register the project-scope rules as kind-``lint`` engines
    (import-idempotent, as the per-file set)."""
    from csmom_tpu_torch.registry import REGISTRY, EngineSpec

    for cls in PROJECT_RULES:
        REGISTRY.register(
            EngineSpec(name=cls.id, kind="lint",
                       description=cls.description, rule_cls=cls),
            replace=True)


register_project_rules()
