"""The per-file lint rules, registered as kind-``lint`` engines.

Counterpart of :mod:`csmom_tpu.analysis.rules`.  One registration
enrolls a rule in ``python -m csmom_tpu_torch.cli lint``, the tier-1
sweep, ``registry list`` and the fixture self-test.  Four rules:

- **clock-discipline**: wall-clock reads, alias-aware (``from time
  import time as _t; _t()``, ``import time as tt; tt.time()``,
  ``getattr(time, "time")()`` and local rebinds resolve to one origin),
  with per-layer tiers: serve timing is ``mono_now_s`` only, the stream
  data plane reads no clock at all (event time only), the wall-free tier
  reads no wall clock, and everything else routes wall needs through
  ``utils.deadline``.  A prose mention of the wall-clock idiom in a
  comment or docstring carries a pragma.
- **lock-discipline**: ``threading`` locks acquired outside ``with`` or
  try-finally, and blocking calls (socket send/recv, ``sleep``, engine
  dispatch) made while a lock is held.
- **dial-discipline**: the one-shot ``proto.request_once`` (a connection
  per call) serves probes and one-shot admin or lifecycle ops only; a
  request hot path dispatches over the pooled channels.
- **enumeration-drift**: no module-level ``ENDPOINTS``/``..._ENTRIES``/
  ``WORKLOADS``/``..._STRATEGIES`` table outside
  ``csmom_tpu_torch/registry/``, and every literal ``checkpoint("x")``
  round-trips with ``chaos.plan.KNOWN_POINTS``, both ways.

The reference's tracer-hygiene and donation-safety rules guard XLA
tracing and buffer donation, which eager torch has neither of, and are
not ported (ROADMAP.md, known difference 49).

Stdlib-only: a sweep imports no torch.  Rule messages spell pragma
examples with ``{`` placeholders so this module's own source never parses
as a pragma.
"""

from __future__ import annotations

import ast
import os
import re

from csmom_tpu_torch.analysis.core import (
    FileContext,
    LintRule,
    RunContext,
    default_sources,
)

__all__ = [
    "ClockDiscipline",
    "DialDiscipline",
    "EnumerationDrift",
    "LockDiscipline",
    "UNPORTED_POINT_OWNERS",
    "banned_enumeration_name",
    "register_builtin_rules",
]


def _posix(rel: str) -> str:
    return rel.replace(os.sep, "/")


# --------------------------------------------------------------------------
# clock-discipline
# --------------------------------------------------------------------------

class ClockDiscipline(LintRule):
    """Per-layer clock tiers, alias-aware."""

    id = "clock-discipline"
    description = ("wall-clock reads route through utils.deadline; serve "
                   "timing is mono_now_s-only; the stream data plane reads "
                   "no clock at all; the wall-free tier reads no wall clock "
                   "(alias-aware: from-imports, module aliases, getattr "
                   "and rebinds resolve to one origin)")

    # prose layer: the wall-clock call idiom quoted in comments or
    # docstrings justifies itself with a pragma
    MENTION_RE = re.compile(
        r"time\.time\(\)|datetime(?:\.datetime)?\.now\(\s*\)")

    # serve and replay timing: every clock read goes through mono_now_s,
    # so the clock a queue expires on is the clock its artifact measures
    # on.  The request-tracing stages, the fabric's deadlines and
    # failover, the fleet observatory's series and the elastic
    # controller's windows all live on that one monotonic timeline
    MONO_ONLY_FILES = (
        "csmom_tpu_torch/serve/__init__.py",
        "csmom_tpu_torch/serve/buckets.py",
        "csmom_tpu_torch/serve/queue.py",
        "csmom_tpu_torch/serve/batcher.py",
        "csmom_tpu_torch/serve/engine.py",
        "csmom_tpu_torch/serve/service.py",
        "csmom_tpu_torch/serve/loadgen.py",
        "csmom_tpu_torch/serve/proto.py",
        "csmom_tpu_torch/serve/health.py",
        "csmom_tpu_torch/serve/worker.py",
        "csmom_tpu_torch/serve/router.py",
        "csmom_tpu_torch/serve/supervisor.py",
        "csmom_tpu_torch/serve/slo.py",
        "csmom_tpu_torch/serve/cache.py",
        "csmom_tpu_torch/cli/serve.py",
        "csmom_tpu_torch/stream/replay.py",
        "csmom_tpu_torch/cli/replay.py",
        "csmom_tpu_torch/obs/trace.py",
        "csmom_tpu_torch/serve/fabric.py",
        "csmom_tpu_torch/obs/fleet.py",
        "csmom_tpu_torch/cli/fleet.py",
        "csmom_tpu_torch/serve/fleet.py",
    )

    # the stream data plane runs on event time: bar stamps and version
    # counters only; a clock read here is a lateness decision taken off
    # the event-time axis
    NO_CLOCK_FILES = (
        "csmom_tpu_torch/stream/__init__.py",
        "csmom_tpu_torch/stream/ring.py",
        "csmom_tpu_torch/stream/ingest.py",
        "csmom_tpu_torch/stream/incremental.py",
    )

    # verdicts reproducible from committed evidence alone: the ledger,
    # its regression verdicts, the memory report and the trace renderer
    WALL_FREE_FILES = (
        "csmom_tpu_torch/obs/ledger.py",
        "csmom_tpu_torch/obs/regress.py",
        "csmom_tpu_torch/obs/memstats.py",
        "csmom_tpu_torch/cli/ledger.py",
        "csmom_tpu_torch/cli/trace.py",
    )

    def start_run(self, run: RunContext) -> None:
        for rel in (self.MONO_ONLY_FILES + self.NO_CLOCK_FILES
                    + self.WALL_FREE_FILES):
            path = os.path.join(run.repo, rel)
            # only meaningful against a tree that HAS the layer (a test
            # repo with one doctored module must not spam missing-file
            # findings for every other tier entry)
            if not os.path.isfile(path) and os.path.isdir(
                    os.path.dirname(path)):
                run.report(self.id, rel, 1,
                           "tier contract names a missing module: update "
                           "the tier lists in analysis/rules.py")

    def start_file(self, ctx: FileContext) -> None:
        rel = _posix(ctx.rel)
        self._mono_only = rel in self.MONO_ONLY_FILES
        self._no_clock = rel in self.NO_CLOCK_FILES
        self._contract = (self._mono_only or self._no_clock
                          or rel in self.WALL_FREE_FILES)
        if self._contract:
            # a tier module cannot pragma its way out of its contract —
            # report around the suppression machinery on purpose
            for p in ctx.pragmas:
                if p.rule == self.id:
                    ctx.run.report(
                        self.id, ctx.rel, p.line,
                        "clock tiers are contracts, not defaults: a "
                        "serve/stream/ledger module must not carry a "
                        "clock-discipline pragma")

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if self._no_clock and isinstance(node, (ast.Import, ast.ImportFrom)):
            mod = (node.module if isinstance(node, ast.ImportFrom)
                   else None)
            names = [a.name for a in node.names]
            if mod == "time" or "time" in names:
                ctx.report(self.id, node.lineno,
                           "the streaming data plane is event-time only — "
                           "it must not import the time module")
            if (mod or "").endswith("deadline") and any(
                    a.name == "mono_now_s" for a in node.names):
                ctx.report(self.id, node.lineno,
                           "the streaming data plane reads NO clock, not "
                           "even mono_now_s — lateness and ordering come "
                           "from tick stamps")
        if (self._no_clock and isinstance(node, ast.Name)
                and node.id == "mono_now_s"):
            ctx.report(self.id, node.lineno,
                       "mono_now_s in the event-time-only data plane")
        if not isinstance(node, ast.Call):
            return
        origin = ctx.resolve_call(node)
        if origin is None:
            return
        if origin == "time.time":
            ctx.report(self.id, node.lineno,
                       "bare wall-clock read (resolves to time.time) — "
                       "use utils.deadline.wall_now_s / file_age_s / "
                       "marker_fresh, or mono_now_s for durations")
        elif (origin == "datetime.datetime.now" and not node.args
                and not node.keywords):
            ctx.report(self.id, node.lineno,
                       "argless datetime.now is a wall-clock read — "
                       "pass a timezone for identity stamps "
                       "(datetime.now with timezone.utc) or use the "
                       "utils.deadline helpers")
        elif self._mono_only and origin == "time.monotonic":
            ctx.report(self.id, node.lineno,
                       "inline time.monotonic in a mono_now_s-only "
                       "module — serve/replay timing goes through "
                       "utils.deadline.mono_now_s so one clock rules "
                       "deadlines AND recorded latencies")
        elif self._no_clock and (origin.startswith("time.")
                                 or origin.endswith(".mono_now_s")):
            ctx.report(self.id, node.lineno,
                       f"clock read ({origin}) in the event-time-only "
                       "stream data plane")

    def finish_file(self, ctx: FileContext) -> None:
        for kind, line0, text in ctx.tokens:
            for m in self.MENTION_RE.finditer(text):
                line = line0 + text[: m.start()].count("\n")
                ctx.report(
                    self.id, line,
                    f"prose mention of the wall-clock idiom in a {kind} — "
                    "justify it in place with a pragma "
                    f"(lint: allow{'[' + self.id + ']'} <why>) or drop it")


def _callable_name(func: ast.AST) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


# --------------------------------------------------------------------------
# lock-discipline
# --------------------------------------------------------------------------

class LockDiscipline(LintRule):
    """Locks leave scope only through with/try-finally, and never guard
    a blocking call (the serving tier's exactly-once terminal
    transitions serialize on these locks)."""

    id = "lock-discipline"
    description = ("threading locks acquired only via with/try-finally, "
                   "and no blocking call (socket send/recv, sleep, engine "
                   "dispatch) while a lock is held")

    BLOCKING = ("sleep", "send", "sendall", "recv", "recv_into",
                "connect", "accept", "dispatch", "score", "request")

    @staticmethod
    def _lock_expr(node) -> bool:
        if isinstance(node, ast.Name):
            return "lock" in node.id.lower()
        if isinstance(node, ast.Attribute):
            return "lock" in node.attr.lower()
        if isinstance(node, ast.Subscript):
            s = node.slice
            return (isinstance(s, ast.Constant) and isinstance(s.value, str)
                    and "lock" in s.value.lower())
        return False

    @staticmethod
    def _recv_text(node) -> str:
        try:
            return ast.unparse(node)
        except Exception:  # pragma: no cover - unparse is total on 3.9+
            return ast.dump(node)

    def _released_in(self, stmts, receiver: str) -> bool:
        for s in stmts:
            for sub in ast.walk(s):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "release"
                        and self._recv_text(sub.func.value) == receiver):
                    return True
        return False

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        # --- bare .acquire() outside with / try-finally -------------------
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"
                and self._lock_expr(node.func.value)):
            receiver = self._recv_text(node.func.value)
            if not self._acquire_is_disciplined(node, receiver, ctx):
                ctx.report(self.id, node.lineno,
                           f"{receiver}.acquire() without with/"
                           "try-finally — a raise between acquire and "
                           "release deadlocks every later waiter")
        # --- blocking call while a lock is held ---------------------------
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                self._lock_expr(i.context_expr) for i in node.items):
            self._scan_lock_body(node, ctx)

    def _acquire_is_disciplined(self, call, receiver: str,
                                ctx: FileContext) -> bool:
        # disciplined iff some enclosing Try releases this receiver in
        # its finalbody, the very next sibling statement is such a Try,
        # or the acquire is the TEST of an ``if lock.acquire(...):``
        # whose body opens with such a Try — the canonical
        # try-lock-then-finally-release idiom (the channel's read baton)
        stmt = call
        while (stmt in ctx.parents
               and not isinstance(stmt, ast.stmt)):
            stmt = ctx.parents[stmt]
        if (isinstance(stmt, ast.If) and stmt.body
                and any(sub is call for sub in ast.walk(stmt.test))
                and isinstance(stmt.body[0], ast.Try)
                and self._released_in(stmt.body[0].finalbody, receiver)):
            return True
        node = stmt
        while node in ctx.parents:
            parent = ctx.parents[node]
            if isinstance(parent, ast.Try) and self._released_in(
                    parent.finalbody, receiver):
                return True
            for field in ("body", "orelse", "finalbody"):
                body = getattr(parent, field, None)
                if isinstance(body, list) and node in body:
                    i = body.index(node)
                    if (i + 1 < len(body)
                            and isinstance(body[i + 1], ast.Try)
                            and self._released_in(body[i + 1].finalbody,
                                                  receiver)):
                        return True
            node = parent
        return False

    def _scan_lock_body(self, with_node, ctx: FileContext) -> None:
        def scan(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue  # deferred bodies do not run under the lock
                if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                        self._lock_expr(i.context_expr)
                        for i in child.items):
                    continue  # a nested lock-with gets its own visit
                if isinstance(child, ast.Call):
                    name = _callable_name(child.func)
                    origin = ctx.resolve_call(child)
                    if (name in self.BLOCKING
                            or origin == "time.sleep"):
                        ctx.report(
                            self.id, child.lineno,
                            f"blocking call ({name}) with a lock held — "
                            "every thread contending this lock "
                            "serializes behind the wait; move the "
                            "blocking work outside the critical "
                            "section")
                scan(child)

        for stmt in with_node.body:
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                         ast.Call):
                name = _callable_name(stmt.value.func)
                if name in self.BLOCKING:
                    ctx.report(
                        self.id, stmt.lineno,
                        f"blocking call ({name}) with a lock held — "
                        "move it outside the critical section")
                    continue
            scan(stmt)


# --------------------------------------------------------------------------
# dial-discipline
# --------------------------------------------------------------------------

class DialDiscipline(LintRule):
    """No dial-per-call transport on request hot paths.

    The pooled multiplexed channel (``proto.ChannelPool``) is the
    transport for score dispatch; ``proto.request_once`` (and its alias
    ``proto.request``) opens a fresh connection per call, which on a
    request path puts a connection in front of every request.  One-shot
    calls stay legal where a fresh connection is the point: probes (a
    probe measures the peer's ability to accept), lifecycle and admin ops
    (stats, drain, stop: they must not ride a channel the request path
    might sever), and the supervisor and health modules that own them.
    Alias-aware: ``from csmom_tpu_torch.serve.proto import request_once
    as r; r(...)`` resolves to the same origin."""

    id = "dial-discipline"
    description = ("proto.request_once (dial-per-call) is for probes "
                   "and one-shot admin ops only: request hot paths "
                   "(router/fabric dispatch) use the pooled multiplexed "
                   "channels")

    # the one-shot origins (``request`` is request_once's alias)
    ONE_SHOT_ORIGINS = ("csmom_tpu_torch.serve.proto.request_once",
                        "csmom_tpu_torch.serve.proto.request")

    # admin and probe modules that own the one-shot pattern
    ALLOWED_FILES = (
        "csmom_tpu_torch/serve/supervisor.py",
        "csmom_tpu_torch/serve/health.py",
    )

    # probe and lifecycle functions stay legal anywhere (router_stats on
    # the fabric supervisor, CLI self-probes)
    ALLOWED_FN_RE = re.compile(
        r"probe|stats|liveness|readiness|drain|stop|lifecycle|admin",
        re.IGNORECASE)

    def _enclosing_fn(self, node: ast.AST, ctx: FileContext):
        cur = node
        while cur in ctx.parents:
            cur = ctx.parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
        return None

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if not isinstance(node, ast.Call):
            return
        origin = ctx.resolve_call(node)
        name = _callable_name(node.func)
        if origin is not None:
            # a resolved origin is the truth: a foreign helper that
            # merely SHARES the name request_once is not our transport
            if origin not in self.ONE_SHOT_ORIGINS:
                return
        elif name != "request_once":
            return
        rel = _posix(ctx.rel)
        if rel in self.ALLOWED_FILES:
            return
        fn = self._enclosing_fn(node, ctx)
        if fn is not None and self.ALLOWED_FN_RE.search(fn.name):
            return
        where = f" (in {fn.name!r})" if fn is not None else ""
        ctx.report(
            self.id, node.lineno,
            f"dial-per-call transport{where}: request_once opens a "
            "fresh connection per call — request hot paths dispatch "
            "over proto.ChannelPool (persistent multiplexed channels); "
            "if this is genuinely a probe or one-shot admin op, name "
            "the function for what it is (probe/stats/drain/stop) or "
            "justify in place with a pragma")


# --------------------------------------------------------------------------
# enumeration-drift
# --------------------------------------------------------------------------

_BANNED_ENUMS = ("ENDPOINTS", "ENTRIES", "WORKLOADS", "STRATEGIES")

# vocabulary points whose only call sites are in modules not ported yet,
# by the ROADMAP.md Queue 1 item that owns them: the round trip skips
# them until that item lands (and then flags the entry here)
UNPORTED_POINT_OWNERS = {
    "bench.probe": "8b",
    "bench.compile": "8b",
    "bench.row": "8b",
    "bench.finish": "8b",
    "bench.land": "8b",
    "mini.start": "8c",
    "mini.row": "8c",
    "mini.finish": "8c",
}


def banned_enumeration_name(name: str) -> bool:
    """Module-level names that read as an engine, endpoint, workload or
    entry enumeration: parallel tables beside the registry."""
    up = name.upper().lstrip("_")
    return any(up == b or up.endswith("_" + b) for b in _BANNED_ENUMS)


class EnumerationDrift(LintRule):
    """The registry stays the only table; the checkpoint vocabulary
    stays bound to its call sites (both directions)."""

    id = "enumeration-drift"
    description = ("no ENDPOINTS/…_ENTRIES/WORKLOADS/…_STRATEGIES "
                   "enumerations outside csmom_tpu_torch/registry/, and every "
                   "checkpoint(\"x\") literal round-trips with "
                   "chaos.plan.KNOWN_POINTS")

    def __init__(self):
        from csmom_tpu_torch.chaos.plan import KNOWN_POINTS

        self._vocab = tuple(KNOWN_POINTS)

    def cache_salt(self) -> str:
        """Verdicts depend on the live checkpoint vocabulary, not just
        the scanned sources: changing KNOWN_POINTS invalidates every
        cached not-in-vocab verdict, both directions."""
        return repr(self._vocab)

    def start_run(self, run: RunContext) -> None:
        self._points_seen: dict = {}
        self._vocab_site: tuple | None = None

    def start_file(self, ctx: FileContext) -> None:
        self._cur_points: dict = {}
        self._cur_vocab: int | None = None

    def file_facts(self, ctx: FileContext):
        """The cross-file state this file contributes (the cache
        contract): its checkpoint call sites and, for chaos/plan.py, the
        KNOWN_POINTS anchor line, so a cache-replayed file still feeds
        the whole-run vocabulary round trip."""
        if not self._cur_points and self._cur_vocab is None:
            return None
        return {"points": dict(self._cur_points),
                "vocab_line": self._cur_vocab}

    def absorb_facts(self, rel: str, facts, run: RunContext) -> None:
        for point, line in (facts.get("points") or {}).items():
            self._points_seen.setdefault(point, (rel, line))
        if facts.get("vocab_line") is not None:
            self._vocab_site = (rel, facts["vocab_line"])

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        rel = _posix(ctx.rel)
        if (isinstance(node, (ast.Assign, ast.AnnAssign))
                and isinstance(ctx.parents.get(node), ast.Module)
                and not rel.startswith("csmom_tpu_torch/registry/")):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and banned_enumeration_name(
                        t.id):
                    ctx.report(
                        self.id, node.lineno,
                        f"module-level enumeration {t.id!r} outside "
                        "csmom_tpu_torch/registry/: register engines "
                        "instead of growing a parallel table beside the "
                        "registry")
        if (isinstance(node, ast.Assign) and rel.endswith("chaos/plan.py")
                and any(isinstance(t, ast.Name) and t.id == "KNOWN_POINTS"
                        for t in node.targets)):
            self._cur_vocab = node.lineno
        if isinstance(node, ast.Call):
            name = _callable_name(node.func)
            if (name in ("checkpoint", "_chaos") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                point = node.args[0].value
                self._cur_points.setdefault(point, node.lineno)
                if "*" not in point and point not in self._vocab:
                    ctx.report(
                        self.id, node.lineno,
                        f"checkpoint point {point!r} is not in "
                        "chaos.plan.KNOWN_POINTS: add it there (the "
                        "vocabulary is the checkpoint inventory; an "
                        "undeclared point is invisible to fault plans)")

    def finish_run(self, run: RunContext) -> None:
        if self._vocab_site is None:
            return  # a sweep that never read the vocabulary's home
        scanned = {_posix(r) for r in run.scanned}
        whole = {_posix(os.path.relpath(p, run.repo))
                 for p in default_sources(run.repo)}
        if not whole <= scanned:
            # a partial sweep (--paths csmom_tpu_torch/chaos) sees the
            # vocabulary but not every call site; only a sweep of the
            # whole package can call an entry dead
            return
        rel, line = self._vocab_site
        for point, owner in UNPORTED_POINT_OWNERS.items():
            if point not in self._vocab or point in self._points_seen:
                run.report(
                    self.id, rel, line,
                    f"plan point {point!r} is listed as owned by item "
                    f"{owner} in UNPORTED_POINT_OWNERS, but "
                    + ("it left KNOWN_POINTS" if point not in self._vocab
                       else "a checkpoint call site uses it now")
                    + ": drop it from that table")
        for point in self._vocab:
            if (point not in self._points_seen
                    and point not in UNPORTED_POINT_OWNERS):
                run.report(
                    self.id, rel, line,
                    f"plan point {point!r} is in KNOWN_POINTS but no "
                    "checkpoint call site uses it: dead vocabulary; drop "
                    "it or restore the call site")


# --------------------------------------------------------------------------
# registration
# --------------------------------------------------------------------------

BUILTIN_RULES = (ClockDiscipline, LockDiscipline, EnumerationDrift,
                 DialDiscipline)


def register_builtin_rules() -> None:
    """Register the per-file rules as kind-``lint`` engines
    (import-idempotent)."""
    from csmom_tpu_torch.registry import REGISTRY, EngineSpec

    for cls in BUILTIN_RULES:
        REGISTRY.register(
            EngineSpec(name=cls.id, kind="lint",
                       description=cls.description, rule_cls=cls),
            replace=True)


register_builtin_rules()
