"""Single-pass, alias-aware AST lint framework.

Counterpart of :mod:`csmom_tpu.analysis.core`, the machinery every rule
of the port's sweep runs on:

- **one parse per file**: ``ast.parse`` and one ``tokenize`` pass build a
  :class:`FileContext` (tree, parent links, alias map, comment and
  string tokens, pragmas), and every registered rule works off that one
  context;
- **alias-aware resolution**: :meth:`FileContext.resolve` follows
  ``import time as _t``, ``from time import time as t``, simple
  ``name = time.time`` rebinds and ``getattr(time, "time")`` down to a
  canonical dotted origin (``"time.time"``);
- **scoped suppressions**: a ``# lint: allow[<rule>] <reason>`` pragma
  suppresses findings of its rule on its own line, and a standalone
  pragma comment also the line below it.  A pragma that suppresses
  nothing is itself a finding (``stale-pragma``);
- **rules are registry engines**: rules register as kind-``lint``
  engines (:mod:`csmom_tpu_torch.registry`), which enrolls them in
  ``python -m csmom_tpu_torch.cli lint``, the tier-1 sweep,
  ``registry list`` and the fixture self-test;
- **two scopes**: a rule declares ``scope = "file"`` (one file at a
  time) or ``scope = "project"`` (a :class:`ProjectRule`, run once over
  the whole scanned set with the call graph of
  :mod:`csmom_tpu_torch.analysis.callgraph`).  Project rules join a
  sweep under ``run_lint(project=True)`` / ``lint --project``, or when
  named;
- **an incremental cache** (:mod:`csmom_tpu_torch.analysis.cache`):
  per-file results keyed by content blake2b, project results by the
  sorted digest set; suppression replays through the live pragma
  machinery, so a cached sweep and a fresh one agree line for line.

What differs from the reference: the default scope is the port's
package (:func:`default_sources`), and the cache lives under
``build/csmom_tpu_torch/lint_cache/``.

Stdlib-only and clock-free: the sweep imports neither torch nor any
engine module, and its verdicts follow from the tree alone (the CLI
injects a monotonic ``timer`` for per-rule timings).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize

__all__ = [
    "FileContext",
    "Finding",
    "LintReport",
    "LintRule",
    "Pragma",
    "ProjectRule",
    "RunContext",
    "default_sources",
    "run_lint",
]

# the pragma grammar: the ``#`` is optional so a docstring line can carry
# its own suppression (comments cannot exist inside string literals)
PRAGMA_RE = re.compile(r"lint:\s*allow\[([A-Za-z0-9_-]+)\]\s*(.*?)\s*$")

STALE_PRAGMA_RULE = "stale-pragma"

# the package the default sweep walks
PACKAGE = "csmom_tpu_torch"

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect at one source line (repo-relative path).

    ``chain`` is the project-rule evidence trail (the qualified-name
    call path from the reported site to the defect's leaf); empty for
    single-file findings."""

    rule: str
    path: str
    line: int
    message: str
    chain: tuple = ()

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "chain": list(self.chain)}


@dataclasses.dataclass
class Pragma:
    """One in-file suppression; ``used`` counts the findings it ate."""

    rule: str
    line: int
    reason: str
    used: int = 0
    standalone: bool = False    # a no-code line: also covers line + 1


class LintRule:
    """Base class for registered rules.

    Hooks (all optional overrides):

    - ``start_file(ctx)`` — per-file precomputation off the shared parse
      (rules needing multi-phase context — "which functions are traced"
      — do their whole analysis here; the tree is already parsed);
    - ``visit(node, ctx)`` — called once per AST node on the shared
      walk;
    - ``finish_file(ctx)`` — per-file wrap-up (token-stream checks);
    - ``start_run(run)`` / ``finish_run(run)`` — cross-file state
      (e.g. the checkpoint-vocabulary coverage check);
    - ``file_facts(ctx)`` / ``absorb_facts(rel, facts, run)`` — the
      cache contract for cross-file rules: ``file_facts`` returns the
      JSON-able per-file state the rule mined (cached alongside the
      findings), ``absorb_facts`` folds one file's facts into the run
      (called on BOTH the live and the cache-replay path, so the rule
      has one accumulation code path).

    Report through ``ctx.report(self.id, line, message)`` (pragma-aware)
    or ``run.report(...)`` for findings anchored outside the current
    file.
    """

    id: str = "?"
    description: str = ""
    scope: str = "file"         # "file" | "project"
    # project-scope only: False makes run_lint re-run the rule live on
    # every sweep instead of replaying the project cache (the
    # compile-surface registry check).  A FILE-scope rule whose
    # verdicts depend on runtime state must override cache_salt()
    # instead — per-file entries are keyed by it.
    cacheable: bool = True

    def cache_salt(self) -> str:
        """Extra material for the sweep-cache key: any runtime input
        this rule's verdicts depend on beyond the scanned sources (e.g.
        enumeration-drift's checkpoint vocabulary).  Default: none."""
        return ""

    def start_run(self, run: "RunContext") -> None:  # pragma: no cover
        pass

    def start_file(self, ctx: "FileContext") -> None:
        pass

    def visit(self, node: ast.AST, ctx: "FileContext") -> None:
        pass

    def finish_file(self, ctx: "FileContext") -> None:
        pass

    def file_facts(self, ctx: "FileContext"):
        return None

    def absorb_facts(self, rel: str, facts, run: "RunContext") -> None:
        pass

    def finish_run(self, run: "RunContext") -> None:  # pragma: no cover
        pass


class ProjectRule(LintRule):
    """A whole-program rule: one ``run_project`` pass over the scanned
    set, with the :class:`~csmom_tpu_torch.analysis.callgraph.ProjectContext`
    (call graph, lock identities) shared across every project rule.

    ``needs_graph = False`` lets a rule that only reads the scanned
    file SET (the compile-surface registry cross-check) skip forcing a
    parse of cache-hit files."""

    scope = "project"
    needs_graph = True

    def run_project(self, project, run: "RunContext") -> None:
        raise NotImplementedError


class _Slot:
    """The pragma machinery one scanned file owns — shared by the full
    :class:`FileContext` and the parse-free cache-replay slot."""

    def __init__(self, rel: str, run: "RunContext"):
        self.rel = rel
        self.run = run
        self.pragmas: list = []
        self._pragma_by_line: dict = {}
        self.recording = False
        self.raw_log: list = []

    def _index_pragmas(self) -> None:
        for p in self.pragmas:
            # a pragma covers its own line; a STANDALONE pragma (a
            # comment/prose line carrying no code) also covers the line
            # below it.  A trailing pragma on an offending line must NOT
            # leak onto the next line — a second, unjustified defect
            # there would ship silently.
            self._pragma_by_line.setdefault((p.rule, p.line), []).append(p)
            if p.standalone:
                self._pragma_by_line.setdefault((p.rule, p.line + 1),
                                                []).append(p)

    def pragma_records(self) -> list:
        return [{"rule": p.rule, "line": p.line, "reason": p.reason,
                 "standalone": p.standalone} for p in self.pragmas]

    # -------------------------------------------------------------- report

    def report(self, rule: str, line: int, message: str,
               chain: tuple = ()) -> None:
        if self.recording:
            self.raw_log.append({"rule": rule, "line": line,
                                 "message": message,
                                 "chain": list(chain)})
        if self.run._project_log is not None:
            self.run._project_log.append(
                {"rule": rule, "rel": self.rel, "line": line,
                 "message": message, "chain": list(chain),
                 "bypass": False})
        self._apply(rule, line, message, chain)

    def _apply(self, rule: str, line: int, message: str,
               chain: tuple = ()) -> None:
        f = Finding(rule=rule, path=self.rel, line=line, message=message,
                    chain=tuple(chain))
        for p in self._pragma_by_line.get((rule, line), []):
            p.used += 1
            self.run.suppressed.append(f)
            return
        self.run.findings.append(f)

    def replay(self, raw: list) -> None:
        """Feed cached raw findings back through the LIVE suppression
        machinery (a ``bypass`` record was reported around pragmas on
        purpose — replay preserves that)."""
        for e in raw:
            if e.get("bypass"):
                self.run.findings.append(Finding(
                    rule=e["rule"], path=self.rel, line=e["line"],
                    message=e["message"], chain=tuple(e.get("chain", ()))))
            else:
                self._apply(e["rule"], e["line"], e["message"],
                            tuple(e.get("chain", ())))

    def finish(self, known_rules: set, active_rules: set) -> None:
        """Stale/unknown pragma findings — the framework's own rule.

        Unknown-ness is judged against every REGISTERED rule; staleness
        only against the rules that actually ran (a ``--rule`` filtered
        sweep cannot honestly call another rule's pragma unused)."""
        for p in self.pragmas:
            if p.rule not in known_rules:
                self.run.findings.append(Finding(
                    rule=STALE_PRAGMA_RULE, path=self.rel, line=p.line,
                    message=f"pragma names unknown rule {p.rule!r} "
                            f"(registered: {sorted(known_rules)})"))
            elif p.rule in active_rules and p.used == 0:
                self.run.findings.append(Finding(
                    rule=STALE_PRAGMA_RULE, path=self.rel, line=p.line,
                    message=f"unused suppression: no {p.rule} finding on "
                            "this line or the next — drop the pragma "
                            "(a stale allowance is the hole the next "
                            "regression walks through)"))


class CachedSlot(_Slot):
    """A cache-hit file: pragmas rebuilt from the cache record, no
    parse, no tokens — exists so suppression and stale-pragma checks
    behave identically to a fresh run."""

    tree = None

    def __init__(self, rel: str, pragma_records: list, run: "RunContext"):
        super().__init__(rel, run)
        self.pragmas = [Pragma(rule=p["rule"], line=p["line"],
                               reason=p.get("reason", ""),
                               standalone=bool(p.get("standalone")))
                        for p in pragma_records]
        self._index_pragmas()


class FileContext(_Slot):
    """Everything the rules share about one file: ONE parse, one token
    scan, one alias map — N rule visitors."""

    def __init__(self, path: str, rel: str, src: str, run: "RunContext"):
        super().__init__(rel, run)
        self.path = path
        self.src = src
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=rel)
        self.parents: dict = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.imports = self._build_alias_map(self.tree)
        self.tokens, self._code_lines = self._scan_tokens(src)
        self.pragmas = self._scan_pragmas()
        self._index_pragmas()

    # ------------------------------------------------------------ aliases --

    @staticmethod
    def _build_alias_map(tree: ast.AST) -> dict:
        """Local name -> dotted origin, from imports at ANY scope plus
        simple single-target rebinds (``t = time.time``).  Bindings are
        applied in SOURCE order (``ast.walk`` is breadth-first, which
        would let an early nested-function rebind beat a later
        module-level one), so later bindings win the way a reader
        expects; the map stays deliberately scope-blind beyond that."""
        amap: dict = {}

        def resolve(node):
            if isinstance(node, ast.Name):
                return amap.get(node.id)
            if isinstance(node, ast.Attribute):
                base = resolve(node.value)
                return f"{base}.{node.attr}" if base else None
            return None

        bindings = sorted(
            (node for node in ast.walk(tree)
             if isinstance(node, (ast.Import, ast.ImportFrom, ast.Assign))),
            key=lambda n: (n.lineno, n.col_offset))
        for node in bindings:
            if isinstance(node, ast.Import):
                for a in node.names:
                    amap[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                if node.module:
                    for a in node.names:
                        amap[a.asname or a.name] = f"{node.module}.{a.name}"
            elif (len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                origin = resolve(node.value)
                if origin is not None:
                    amap[node.targets[0].id] = origin
                else:
                    # a later rebind to something untracked retires the
                    # alias — keeping it would flag the NEW binding's
                    # calls as the old origin's
                    amap.pop(node.targets[0].id, None)
        return amap

    def resolve(self, node) -> str | None:
        """The dotted origin a name/attribute/getattr-dodge denotes, or
        None for locals the alias map does not track."""
        if isinstance(node, ast.Name):
            return self.imports.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            return f"{base}.{node.attr}" if base else None
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Name) and f.id == "getattr"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)):
                base = self.resolve(node.args[0])
                return f"{base}.{node.args[1].value}" if base else None
        return None

    def resolve_call(self, call: ast.Call) -> str | None:
        """What callable a Call invokes (alias- and getattr-aware)."""
        return self.resolve(call.func)

    # ------------------------------------------------------------- tokens --

    # token types that do not make a line "code" (a pragma on a line
    # holding only these is standalone and may cover the line below)
    _NONCODE_TOKENS = frozenset({
        tokenize.COMMENT, tokenize.STRING, tokenize.NL, tokenize.NEWLINE,
        tokenize.INDENT, tokenize.DEDENT, tokenize.ENDMARKER,
    })

    @classmethod
    def _scan_tokens(cls, src: str) -> tuple:
        """One tokenize pass: ``(kind, line, text)`` for every comment
        and string token (the prose layer textual rules scan without
        re-reading the file), plus the set of line numbers that carry
        actual code tokens."""
        out = []
        code_lines: set = set()
        try:
            for tok in tokenize.generate_tokens(io.StringIO(src).readline):
                if tok.type == tokenize.COMMENT:
                    out.append(("comment", tok.start[0], tok.string))
                elif tok.type == tokenize.STRING:
                    out.append(("string", tok.start[0], tok.string))
                elif tok.type not in cls._NONCODE_TOKENS:
                    code_lines.update(range(tok.start[0], tok.end[0] + 1))
        except tokenize.TokenError:  # pragma: no cover - ast.parse passed
            pass
        return out, code_lines

    def _scan_pragmas(self) -> list:
        pragmas = []
        for i, line in enumerate(self.lines, start=1):
            m = PRAGMA_RE.search(line)
            if m:
                pragmas.append(Pragma(rule=m.group(1), line=i,
                                      reason=m.group(2),
                                      standalone=i not in self._code_lines))
        return pragmas


class RunContext:
    """Cross-file state for one sweep."""

    def __init__(self, repo: str):
        self.repo = repo
        self.findings: list = []
        self.suppressed: list = []
        self.scanned: list = []       # repo-relative paths, scan order
        self._slot = None             # the file currently being swept
        self._project_log = None      # raw project findings (cache feed)

    def report(self, rule: str, rel: str, line: int, message: str,
               chain: tuple = ()) -> None:
        self.findings.append(Finding(rule=rule, path=rel, line=line,
                                     message=message, chain=tuple(chain)))
        # pragma-bypassing reports anchored at the CURRENT file must
        # survive a cache replay too — log them raw, marked bypass
        if (self._slot is not None and self._slot.recording
                and rel == self._slot.rel):
            self._slot.raw_log.append(
                {"rule": rule, "line": line, "message": message,
                 "chain": list(chain), "bypass": True})
        elif self._project_log is not None:
            self._project_log.append(
                {"rule": rule, "rel": rel, "line": line,
                 "message": message, "chain": list(chain), "bypass": True})


@dataclasses.dataclass
class LintReport:
    """One sweep's outcome; ``findings`` are the UNSUPPRESSED defects
    (stale pragmas included — an unused allowance fails the sweep)."""

    findings: list
    suppressed: list
    files: int
    rules: tuple
    project: bool = False
    cache: dict = dataclasses.field(
        default_factory=lambda: {"enabled": False})
    rule_timings_s: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "schema_version": 2,
            "ok": self.ok,
            "files_scanned": self.files,
            "rules": list(self.rules),
            "project": self.project,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "cache": dict(self.cache),
            "rule_timings_s": {k: round(v, 6)
                               for k, v in self.rule_timings_s.items()},
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def default_sources(repo: str | None = None) -> list:
    """The sweep's default scope: every Python file of the port's
    package, its examples included.  ``chip_smoke.py`` and the tests
    stay outside it: their probes and tables are a harness's."""
    repo = repo or _REPO
    files = []
    for dirpath, dirnames, names in os.walk(os.path.join(repo, PACKAGE)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(p for p in files if os.path.isfile(p))


def _expand_paths(paths) -> list:
    out = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isdir(p):
            for dirpath, dirnames, names in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                out += [os.path.join(dirpath, n) for n in sorted(names)
                        if n.endswith(".py")]
        else:
            out.append(p)
    return out


def _registered_specs():
    from csmom_tpu_torch.registry import lint_rules

    return lint_rules()


def _registered_rules():
    return [spec.rule_cls() for spec in _registered_specs()]


def run_lint(paths=None, rules=None, rule: str | None = None,
             repo: str | None = None, project: bool = False,
             cache: bool | None = None, cache_dir: str | None = None,
             timer=None) -> LintReport:
    """Run the registered rule set (or ``rules`` instances) over
    ``paths`` (default: the port's package, :func:`default_sources`).

    ``rule`` filters to one rule id; unknown ids raise with the known
    set named.  ``project=True`` adds the registered project-scope
    rules (whole-program: call graph, lock order, compile-surface
    coverage); a project rule named explicitly (via ``rules`` or
    ``rule``) runs regardless of the flag.  The incremental cache is on
    by default for registered-rule sweeps (``cache=False`` bypasses;
    explicit ``rules`` instances are never cached — their state is not
    part of the key).  ``timer`` (a monotonic-seconds callable) enables
    per-rule timings; this module never reads a clock itself.
    """
    repo = repo or _REPO
    explicit_rules = rules is not None
    if rules is None:
        rules = _registered_rules()
    if rule is not None:
        known = [r.id for r in rules]
        rules = [r for r in rules if r.id == rule]
        if not rules:
            raise KeyError(f"unknown lint rule {rule!r}; registered rules: "
                           f"{known}")
    if not explicit_rules and rule is None and not project:
        rules = [r for r in rules
                 if getattr(r, "scope", "file") == "file"]
    file_rules = [r for r in rules if getattr(r, "scope", "file") == "file"]
    project_rules = [r for r in rules
                     if getattr(r, "scope", "file") == "project"]

    timings: dict = {}

    def timed(rid, fn, *a):
        if timer is None:
            return fn(*a)
        t0 = timer()
        try:
            return fn(*a)
        finally:
            timings[rid] = timings.get(rid, 0.0) + (timer() - t0)

    files = (default_sources(repo) if paths is None
             else _expand_paths(paths))
    run = RunContext(repo)
    active_rules = {r.id for r in rules}
    known_rules = (active_rules | {STALE_PRAGMA_RULE}
                   | {s.name for s in _registered_specs()})
    for r in rules:
        timed(r.id, r.start_run, run)

    sweep_cache = None
    if cache is not False and not explicit_rules:
        from csmom_tpu_torch.analysis.cache import SweepCache

        # per-file entries are keyed by the FILE-scope rule set only
        # (project rules never produce per-file-phase findings), so a
        # plain sweep and a --project sweep share one warm cache
        # instead of thrashing it; the project key folds the project
        # rule ids in separately
        import inspect

        pkg_dir = os.path.dirname(os.path.abspath(__file__))
        plugin_sources = set()
        for r in rules:
            try:
                src_file = inspect.getsourcefile(type(r))
            except TypeError:       # pragma: no cover - builtin class
                src_file = None
            if src_file and os.path.dirname(
                    os.path.abspath(src_file)) != pkg_dir:
                plugin_sources.add(os.path.abspath(src_file))
        sweep_cache = SweepCache(
            repo, sorted(r.id for r in file_rules), cache_dir,
            salts=[f"{r.id}:{r.cache_salt()}" for r in file_rules
                   if r.cache_salt()],
            extra_sources=sorted(plugin_sources))

    # read every file once: the digest is the cache key and the source
    # feeds the parse on a miss
    from csmom_tpu_torch.analysis.cache import content_digest

    entries = []
    for path in files:
        rel = (os.path.relpath(path, repo)
               if os.path.commonpath([os.path.abspath(path), repo]) == repo
               else path)
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except (OSError, ValueError) as e:     # ValueError: bad encoding
            run.findings.append(Finding(
                rule="parse-error", path=rel, line=1,
                message=f"unparseable source: {e}"))
            continue
        entries.append((path, rel, src, content_digest(src)))

    # project cache: keyed by the sorted digest set; rules that read
    # runtime state (cacheable=False) always run live
    cached_project = None
    pkey = None
    if sweep_cache is not None and project_rules:
        pkey = sweep_cache.project_key(
            [(rel, d) for _, rel, _, d in entries],
            sorted(pr.id for pr in project_rules))
        cached_project = sweep_cache.lookup_project(pkey)
    live_project = [pr for pr in project_rules
                    if not (pr.cacheable and cached_project is not None
                            and pr.id in cached_project)]
    # a live graph-needing project rule forces a parse even of
    # cache-hit files (the call graph is built from the trees)
    need_trees = any(getattr(pr, "needs_graph", True)
                     for pr in live_project)

    slots: dict = {}
    for path, rel, src, digest in entries:
        # out-of-repo files (tmp fixtures, absolute --paths) are not
        # cached: their keys are absolute paths that would accrete in
        # the repo's cache file forever
        cache_this = sweep_cache is not None and not os.path.isabs(rel)
        hit = sweep_cache.lookup(rel, digest) if cache_this else None
        if hit is not None and not need_trees:
            slot = CachedSlot(rel, hit.get("pragmas", []), run)
        else:
            try:
                slot = FileContext(path, rel, src, run)
            except (SyntaxError, ValueError) as e:
                run.findings.append(Finding(
                    rule="parse-error", path=rel,
                    line=getattr(e, "lineno", 1) or 1,
                    message=f"unparseable source: {e}"))
                continue
        run.scanned.append(rel)
        # every sweep already read the source (the digest needs it) —
        # keep it on the slot so project rules that inspect parse-free
        # CachedSlots (compile-surface's LINT_SURFACE scan) reuse it
        # instead of re-reading the whole tree from disk warm
        slot.src = src
        slots[rel] = slot
        run._slot = slot
        if hit is not None:
            slot.replay(hit.get("raw", []))
            facts = hit.get("facts", {})
            for r in file_rules:
                if r.id in facts:
                    r.absorb_facts(rel, facts[r.id], run)
        else:
            slot.recording = True
            for r in file_rules:
                timed(r.id, r.start_file, slot)
            if timer is None:
                for node in ast.walk(slot.tree):
                    for r in file_rules:
                        r.visit(node, slot)
            else:
                # timing at phase granularity (rule-outer), not per
                # node: two clock reads per (node x rule) measurably
                # slow the path whose whole point is speed
                nodes = list(ast.walk(slot.tree))
                for r in file_rules:
                    t0 = timer()
                    for node in nodes:
                        r.visit(node, slot)
                    timings[r.id] = (timings.get(r.id, 0.0)
                                     + (timer() - t0))
            for r in file_rules:
                timed(r.id, r.finish_file, slot)
            facts = {}
            for r in file_rules:
                fact = r.file_facts(slot)
                if fact is not None:
                    facts[r.id] = fact
                    r.absorb_facts(rel, fact, run)
            slot.recording = False
            if cache_this:
                sweep_cache.store(rel, digest, slot.raw_log,
                                  slot.pragma_records(), facts)
        run._slot = None

    for r in file_rules:
        timed(r.id, r.finish_run, run)

    if project_rules:
        from csmom_tpu_torch.analysis.callgraph import ProjectContext

        pc = ProjectContext(slots, repo)
        pc.run = run
        project_store: dict = {}
        project_ran_live = False
        for pr in project_rules:
            if (cached_project is not None and pr.cacheable
                    and pr.id in cached_project):
                for e in cached_project[pr.id]:
                    slot = slots.get(e.get("rel"))
                    if slot is not None and not e.get("bypass"):
                        slot._apply(e["rule"], e["line"], e["message"],
                                    tuple(e.get("chain", ())))
                    else:
                        run.findings.append(Finding(
                            rule=e["rule"], path=e.get("rel", "?"),
                            line=e["line"], message=e["message"],
                            chain=tuple(e.get("chain", ()))))
                project_store[pr.id] = cached_project[pr.id]
            else:
                run._project_log = []
                timed(pr.id, pr.run_project, pc, run)
                if pr.cacheable:
                    project_store[pr.id] = run._project_log
                    project_ran_live = True
                run._project_log = None
        # store only when a cacheable rule actually ran live: a fully
        # warm sweep must not rewrite sweep.json just to re-save what
        # it read (the dirty flag exists to make warm runs I/O-free)
        if (sweep_cache is not None and pkey is not None
                and project_ran_live):
            cacheable_ids = {pr.id for pr in project_rules if pr.cacheable}
            if cacheable_ids <= set(project_store):
                sweep_cache.store_project(pkey, project_store)

    for slot in slots.values():
        slot.finish(known_rules, active_rules)
    run.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if sweep_cache is not None:
        sweep_cache.save()
    return LintReport(
        findings=run.findings, suppressed=run.suppressed,
        files=len(run.scanned), rules=tuple(r.id for r in rules),
        project=bool(project_rules),
        cache=(sweep_cache.stats() if sweep_cache is not None
               else {"enabled": False}),
        rule_timings_s=timings)
