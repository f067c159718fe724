"""The per-file lint rules, registered as kind-``lint`` engines.

Counterpart of :mod:`csmom_tpu.analysis.rules`, with its six rules.
One registration enrolls a rule in ``python -m csmom_tpu_torch.cli
lint``, the tier-1 sweep, ``registry list`` and the fixture self-test.

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

Two more guard the card's launch queue and the donation contract:

- **tracer-hygiene**: inside a function called once a dispatch (the
  local function handed to :func:`csmom_tpu_torch.parallel.compat.
  shard_map`, or a scorer a registered ``ServeSurface`` ``batch_fn``
  factory returns, and any def nested in one), no ``print``, no clock
  read, no mutable-global write (the shard threads share it), and no
  host sync on a parameter: ``.item()``, ``float()``/``int()``/
  ``bool()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray``,
  or ``torch.cuda.synchronize()``.  On the card each one stalls the
  launch queue on every call;
- **donation-safety**: a tensor passed to a donated surface (a callable
  whose name contains ``donated``, or a call with ``donate_panels=True``
  at the positions the surface consumes) is not read later in the same
  scope: the call left it empty (:mod:`csmom_tpu_torch.utils.donation`),
  so a read is a wrong number, not an error.

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
    "DonationSafety",
    "EnumerationDrift",
    "LockDiscipline",
    "TracerHygiene",
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
# tracer-hygiene
# --------------------------------------------------------------------------

def _is_shard_map(origin: str | None, raw_name: str | None) -> bool:
    if origin is not None:
        return origin.endswith("shard_map")
    return raw_name == "shard_map"


# host syncs: numpy copies of a parameter, conversions of a parameter to
# a Python number, tensor methods that copy to the host
HOST_MATERIALIZE = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}
HOST_NUMBERS = ("float", "int", "bool")
HOST_METHODS = ("item", "tolist", "cpu", "numpy")
DEVICE_SYNCS = {"torch.cuda.synchronize"}


def _param_names(fn) -> list:
    a = fn.args
    names = [p.arg for p in getattr(a, "posonlyargs", [])]
    names += [p.arg for p in a.args]
    names += [p.arg for p in a.kwonlyargs]
    return names


def _root_name(node) -> str | None:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class TracerHygiene(LintRule):
    """Host syncs inside the functions called once a dispatch: each one
    stalls the card's launch queue on every call."""

    id = "tracer-hygiene"
    description = ("no print/clock/float()/.item()/.cpu()/np.asarray-on-"
                   "params/torch.cuda.synchronize/global-writes inside "
                   "functions passed to shard_map or returned by a "
                   "registered ServeSurface batch_fn")

    def start_file(self, ctx: FileContext) -> None:
        tree = ctx.tree
        defs_by_name: dict = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs_by_name.setdefault(node.name, []).append(node)

        roots: list = []

        def mark(node) -> None:
            if node not in roots:
                roots.append(node)

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if _is_shard_map(ctx.resolve_call(node),
                             _callable_name(node.func)) and node.args:
                target = node.args[0]
                if isinstance(target, ast.Lambda):
                    mark(target)
                elif isinstance(target, ast.Name):
                    for d in defs_by_name.get(target.id, []):
                        mark(d)
            for kw in node.keywords:
                if kw.arg == "batch_fn" and isinstance(kw.value, ast.Name):
                    # a registered ServeSurface factory: the functions it
                    # defines are the scorers
                    for factory in defs_by_name.get(kw.value.id, []):
                        for sub in ast.walk(factory):
                            if sub is not factory and isinstance(
                                    sub, (ast.FunctionDef, ast.Lambda)):
                                mark(sub)

        # a def nested inside a root runs inside it
        for node in list(roots):
            for sub in ast.walk(node):
                if sub is not node and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                    mark(sub)

        reported: set = set()

        def flag(line, msg):
            if (line, msg) not in reported:
                reported.add((line, msg))
                ctx.report(self.id, line, msg)

        stall = "a host sync stalls the card's launch queue on every call"
        for fn in roots:
            params = set(_param_names(fn))
            fname = getattr(fn, "name", "<lambda>")
            globals_declared: set = set()
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Global):
                    globals_declared |= set(sub.names)
            for sub in ast.walk(fn):
                if isinstance(sub, (ast.Assign, ast.AugAssign)):
                    tgts = (sub.targets if isinstance(sub, ast.Assign)
                            else [sub.target])
                    for t in tgts:
                        if (isinstance(t, ast.Name)
                                and t.id in globals_declared):
                            flag(sub.lineno,
                                 f"traced function {fname!r} writes "
                                 f"global {t.id!r} — the shard threads "
                                 "share it: count under a lock, or return "
                                 "the value")
                if not isinstance(sub, ast.Call):
                    continue
                name = _callable_name(sub.func)
                origin = ctx.resolve_call(sub)
                first = sub.args[0] if sub.args else None
                on_param = isinstance(first, ast.Name) and first.id in params
                if isinstance(sub.func, ast.Name) and name == "print":
                    flag(sub.lineno,
                         f"print inside traced function {fname!r} — host "
                         "I/O once a dispatch: log outside the shard "
                         "function or the scorer")
                elif origin is not None and (origin.startswith("time.")
                                             or origin.endswith(
                                                 ".mono_now_s")):
                    flag(sub.lineno,
                         f"clock read ({origin}) inside traced function "
                         f"{fname!r} — the host clock does not see the "
                         "device's time: time the call from outside")
                elif origin in DEVICE_SYNCS:
                    flag(sub.lineno,
                         f"{origin}() inside traced function {fname!r} — "
                         f"{stall}")
                elif origin in HOST_MATERIALIZE and on_param:
                    flag(sub.lineno,
                         f"{origin} on traced parameter {first.id!r} in "
                         f"{fname!r} — a copy to the host: {stall}")
                elif (isinstance(sub.func, ast.Name)
                        and name in HOST_NUMBERS and len(sub.args) == 1
                        and on_param):
                    flag(sub.lineno,
                         f"{name}() on traced parameter {first.id!r} in "
                         f"{fname!r} — {stall}")
                elif (isinstance(sub.func, ast.Attribute)
                        and name in HOST_METHODS and not sub.args):
                    root = _root_name(sub.func.value)
                    if root is not None and root in params:
                        flag(sub.lineno,
                             f".{name}() on traced parameter {root!r} in "
                             f"{fname!r} — device->host copy: {stall}")


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
# them until that item lands (and then flags the entry here).  Empty
# since the bench and capture tier came: every point has a call site
UNPORTED_POINT_OWNERS: dict = {}


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
# donation-safety
# --------------------------------------------------------------------------

# the positions a ``donate_panels=True`` call consumes, by callable name;
# another callable given the flag consumes every positional argument
DONATE_PANELS_POSITIONS = {
    "jk_grid_backtest": (0, 1),
    "grid_net_of_costs": (0, 1),
    "hysteresis_event_backtest": (0, 1, 2),
}


class DonationSafety(LintRule):
    """No read of a tensor after it was passed to a donated surface."""

    id = "donation-safety"
    description = ("a tensor passed to a donated surface (a *donated* "
                   "callable, donate_panels=True, or utils.donation.consume) "
                   "is consumed and reads "
                   "as empty — reading it afterwards in the same scope is a "
                   "wrong number, not an error")

    @staticmethod
    def _panel_positions(call: ast.Call) -> tuple | None:
        """The positions a ``donate_panels=True`` call consumes, or None
        when the call donates nothing this way."""
        for kw in call.keywords:
            if (kw.arg == "donate_panels" and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True):
                return DONATE_PANELS_POSITIONS.get(
                    _callable_name(call.func) or "",
                    tuple(range(len(call.args))))
        return None

    def start_file(self, ctx: FileContext) -> None:
        scopes = [ctx.tree] + [n for n in ast.walk(ctx.tree)
                               if isinstance(n, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef))]
        for scope in scopes:
            self._scan_scope(scope, ctx)

    @staticmethod
    def _scope_walk(scope):
        """Walk one scope, not descending into nested defs (their
        bindings and execution order are not this scope's)."""
        stack = (list(scope.body) if hasattr(scope, "body")
                 else list(ast.iter_child_nodes(scope)))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue  # a nested def is its own scope
            stack.extend(ast.iter_child_nodes(node))

    def _scan_scope(self, scope, ctx: FileContext) -> None:
        donated_fns: set = set()   # local names bound to a donated callable
        donating_calls: list = []  # (call node, indices | None = all)

        for node in self._scope_walk(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and "donated" in (_callable_name(node.value.func) or ""):
                donated_fns.add(node.targets[0].id)

        for node in self._scope_walk(scope):
            if not isinstance(node, ast.Call):
                continue
            name = _callable_name(node.func) or ""
            maker = (_callable_name(node.func.func) or ""
                     if isinstance(node.func, ast.Call) else "")
            if ((isinstance(node.func, ast.Name) and node.func.id in donated_fns)
                    or "donated" in name or "donated" in maker
                    or (ctx.resolve_call(node) or "").endswith(
                        "utils.donation.consume")):
                # a donated callable (or the donation primitive itself):
                # every positional tensor is consumed
                donating_calls.append((node, None))
                continue
            idxs = self._panel_positions(node)
            if idxs:
                donating_calls.append((node, idxs))

        for call, idxs in donating_calls:
            indices = range(len(call.args)) if idxs is None else idxs
            end = getattr(call, "end_lineno", call.lineno)
            fn_txt = _callable_name(call.func) or "the donated entry"
            for i in indices:
                if i >= len(call.args) or not isinstance(call.args[i],
                                                         ast.Name):
                    continue
                buf = call.args[i].id
                # a rebind on the call's own line (``v = fn(v, m)``) or
                # later retires the name: reads past it are a new tensor
                rebound_at = min(
                    (n.lineno for n in self._scope_walk(scope)
                     if isinstance(n, ast.Name) and n.id == buf
                     and isinstance(n.ctx, ast.Store)
                     and n.lineno >= end), default=float("inf"))
                for n in self._scope_walk(scope):
                    if (isinstance(n, ast.Name) and n.id == buf
                            and isinstance(n.ctx, ast.Load)
                            and end < n.lineno < rebound_at
                            and n is not call.args[i]):
                        ctx.report(
                            self.id, n.lineno,
                            f"{buf!r} is read after being donated to "
                            f"{fn_txt} (line {call.lineno}) — the call "
                            "consumed the tensor, which now reads as empty; "
                            "copy it first or use the undonated call")


# --------------------------------------------------------------------------
# registration
# --------------------------------------------------------------------------

BUILTIN_RULES = (ClockDiscipline, TracerHygiene, LockDiscipline,
                 DonationSafety, EnumerationDrift, DialDiscipline)


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
