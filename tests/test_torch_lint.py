"""The port's static-analysis sweep (``python -m csmom_tpu_torch.cli lint``),
the counterpart of ``tests/test_lint.py``.

- **the tier-1 sweep**: the port's package is clean at project scope,
  and ``lint --format json`` emits the reference's schema_version-2
  report (its own validator accepts it);
- **the fixture self-test**: every registered rule fires on its bad
  fixture under ``tests/fixtures/lint_torch/`` (a file for per-file
  rules, a package for project rules) and stays silent on the clean twin;
- **held against the reference**: ``csmom_tpu.analysis`` on its own
  fixtures and the port on its copies report the same findings and
  suppressions (rule, line, call chain, the statement of the defect);
- **pragma semantics**: a live pragma suppresses exactly its finding, an
  unused or unknown one is itself a finding, and a clock-tier module
  cannot pragma out of its tier;
- **the incremental cache**: identical findings warm and cold, a warm
  sweep at least 5x faster, invalidated by content, vocabulary and rule
  changes, bypassed by ``--no-cache``;
- **the registry**: rules are kind-``lint`` engines (a toy rule
  registered at run time joins the sweep), and the lock audit pins the
  port's lock-order edges.

All nine of the reference's rules are ported: tracer-hygiene,
donation-safety and helper-hygiene guard the host syncs of a shard's
function or a batch scorer and the reads of donated tensors, and run
through the same self-test and reference parity as the other six, on
translated fixtures.  ``rehearse`` gates its start on this sweep
(``tests/test_torch_rehearse_matrix.py``).
"""

import json
import os
import subprocess
import sys
import time

import pytest

from csmom_tpu_torch.analysis import run_lint
from csmom_tpu_torch.analysis.core import STALE_PRAGMA_RULE, LintRule
from csmom_tpu_torch.registry import lint_rules, register_engine, unregister_engine

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIX = os.path.join(_REPO, "tests", "fixtures", "lint_torch")
_PKG = "csmom_tpu_torch"

RULES = ["clock-discipline", "tracer-hygiene", "lock-discipline",
         "donation-safety", "enumeration-drift", "dial-discipline",
         "lock-order", "helper-hygiene", "compile-surface"]


def _fixture(name: str) -> str:
    return os.path.join(_FIX, name)


def _rule_fixture_pair(rule_id: str) -> tuple:
    """(bad, clean) fixture paths: ``<stem>_bad.py`` single files for
    per-file rules, ``<stem>_bad/`` packages for project rules."""
    stem = rule_id.replace("-", "_")
    for suffix in ("", ".py"):
        bad = _fixture(f"{stem}_bad{suffix}")
        clean = _fixture(f"{stem}_clean{suffix}")
        if os.path.exists(bad) or os.path.exists(clean):
            return bad, clean
    return _fixture(f"{stem}_bad.py"), _fixture(f"{stem}_clean.py")


# ------------------------------------------------------ the tier-1 sweep ---

def test_lint_sweep_is_clean_on_the_committed_tree():
    """The gate: no unsuppressed finding over the port's package at
    project scope.  A failure names every offender as path:line: [rule]
    message; fix it, or justify it with an in-file pragma that then
    suppresses something."""
    rep = run_lint(project=True)
    assert rep.findings == [], (
        "lint found defects on the committed tree:\n  "
        + "\n  ".join(str(f) for f in rep.findings))
    assert rep.files > 100, "the sweep lost its default scope"
    assert rep.project is True
    assert set(rep.rules) == {s.name for s in lint_rules()} == set(RULES)
    # the justified suppressions stay visible: the writer locks that
    # exist to serialize a socket's sends, the backfill lock's spawns,
    # the clock-skew fault and the dying process's dump
    assert rep.suppressed
    assert all(f.rule in ("clock-discipline", "lock-discipline",
                          "lock-order")
               for f in rep.suppressed)


def test_the_default_scope_is_the_ports_package():
    """Every Python file of the package, examples included; the smoke
    script, the tests and the reference stay outside."""
    from csmom_tpu_torch.analysis import default_sources

    rels = [os.path.relpath(p, _REPO) for p in default_sources()]
    assert rels and all(r.startswith(_PKG + os.sep) for r in rels)
    assert os.path.join(_PKG, "examples", "north_star_grid.py") in rels
    assert os.path.join(_PKG, "analysis", "core.py") in rels
    assert "chip_smoke.py" not in rels


def test_pragmas_carry_the_references_reasons():
    """Each suppression sits where the reference's counterpart sits and
    gives its reason."""
    rep = run_lint(project=True)
    got = sorted((f.path.replace(os.sep, "/"), f.rule) for f in rep.suppressed)
    assert got == [
        (f"{_PKG}/chaos/inject.py", "clock-discipline"),
        (f"{_PKG}/chaos/plan.py", "clock-discipline"),
        (f"{_PKG}/serve/fleet.py", "lock-order"),
        (f"{_PKG}/serve/proto.py", "lock-order"),
        (f"{_PKG}/serve/proto.py", "lock-order"),
        (f"{_PKG}/utils/deadline.py", "lock-discipline"),
    ]


def test_cli_lint_json_is_wired_and_clean(capsys):
    """``lint --project --format json`` exits 0 on the committed tree and
    emits the schema_version-2 report, which the reference's artifact
    validator accepts closed-world."""
    from csmom_tpu.chaos import invariants as inv
    from csmom_tpu_torch.cli.main import main

    rc = main(["lint", "--project", "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert report["ok"] is True
    assert report["schema_version"] == 2
    assert report["project"] is True
    assert report["findings"] == []
    assert report["files_scanned"] > 100
    assert set(report["rules"]) == {s.name for s in lint_rules()}
    assert report["cache"]["enabled"] in (True, False)
    for s in report["suppressed"]:
        assert {"rule", "path", "line", "message", "chain"} <= set(s)
    assert inv.detect_kind(report) == "lint"
    assert inv.validate(report) == []
    assert any("unknown v2 keys" in v for v in inv.validate(
        {**report, "surprise": 1}))
    assert any("disagrees" in v for v in inv.validate(
        {**report, "ok": False}))


def test_cli_lint_json_alias_still_works(capsys):
    """``--json`` is an alias for ``--format json``."""
    from csmom_tpu_torch.cli.main import main

    rc = main(["lint", "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["schema_version"] == 2


def test_cli_lint_explicit_format_beats_the_json_alias(capsys):
    from csmom_tpu_torch.cli.main import main

    bad = _fixture("clock_discipline_bad.py")
    rc = main(["lint", "--format", "github", "--json", "--paths", bad,
               "--no-cache"])
    out = capsys.readouterr().out
    assert rc == 1 and "::error file=" in out


def test_cli_lint_github_format_emits_workflow_annotations(capsys):
    from csmom_tpu_torch.cli.main import main

    bad = _fixture("lock_discipline_bad.py")
    rc = main(["lint", "--format", "github", "--paths", bad])
    out = capsys.readouterr().out
    assert rc == 1
    lines = [ln for ln in out.splitlines() if ln.startswith("::error ")]
    assert lines, out
    assert any("file=" in ln and "line=11" in ln
               and "title=lint:lock-discipline" in ln for ln in lines)

    rc = main(["lint", "--format", "github", "--paths",
               _fixture("lock_discipline_clean.py")])
    out = capsys.readouterr().out
    assert rc == 0 and "::error" not in out


def test_cli_lint_reports_findings_with_file_line_and_rule(capsys):
    from csmom_tpu_torch.cli.main import main

    bad = _fixture("lock_discipline_bad.py")
    rc = main(["lint", "--paths", bad])
    out = capsys.readouterr().out
    assert rc == 1
    assert "lock_discipline_bad.py:11" in out
    assert "[lock-discipline]" in out

    rc = main(["lint", "--json", "--paths", bad])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1 and report["ok"] is False
    f0 = report["findings"][0]
    assert set(f0) == {"rule", "path", "line", "message", "chain"}


def test_cli_lint_rule_filter_and_rules_listing(capsys):
    from csmom_tpu_torch.cli.main import main

    rc = main(["lint", "--rule", "lock-discipline",
               "--paths", _fixture("clock_discipline_bad.py")])
    capsys.readouterr()
    assert rc == 0  # the clock offenses are not lock-discipline's

    rc = main(["lint", "--rule", "no-such-rule"])
    err = capsys.readouterr().err
    assert rc == 2 and "no-such-rule" in err

    rc = main(["lint", "--rules"])
    out = capsys.readouterr().out
    assert rc == 0
    for spec in lint_rules():
        assert spec.name in out


def test_a_sweep_imports_neither_torch_nor_the_reference():
    """The command computes nothing on a device: a whole project sweep
    in a fresh interpreter leaves torch and every csmom_tpu module
    unimported, and needs no card."""
    code = ("import sys\n"
            "from csmom_tpu_torch.cli.main import main\n"
            "rc = main(['lint', '--project', '--no-cache', '--format', 'json'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'csmom_tpu', 'jax'))\n"
            "print('RESULT', rc, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         env={**os.environ, "PYTHONPATH": _REPO,
                              "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=120).stdout
    assert out.strip().splitlines()[-1] == "RESULT 0 []"


# ------------------------------------------- the fixture self-test harness -

@pytest.mark.parametrize("rule_id", RULES)
def test_every_registered_rule_fires_on_bad_and_not_on_clean(rule_id):
    """Each registered rule fires on its bad fixture and stays silent on
    the clean twin; a project rule proves itself on a package of several
    files."""
    spec = {s.name: s for s in lint_rules()}[rule_id]
    bad, clean = _rule_fixture_pair(rule_id)
    assert os.path.exists(bad), f"rule {rule_id} ships no bad fixture at {bad}"
    assert os.path.exists(clean), f"rule {rule_id} ships no clean twin"
    if getattr(spec.rule_cls, "scope", "file") == "project":
        assert os.path.isdir(bad)
        assert len([n for n in os.listdir(bad) if n.endswith(".py")]) >= 2
    rep = run_lint(paths=[bad], rules=[spec.rule_cls()])
    assert [f for f in rep.findings if f.rule == rule_id], (
        f"rule {rule_id} stayed silent on its bad fixture")
    rep = run_lint(paths=[clean], rules=[spec.rule_cls()])
    assert [f for f in rep.findings if f.rule == rule_id] == [], (
        f"rule {rule_id} fires on its clean twin: "
        + "; ".join(str(f) for f in rep.findings))


# ------------------------------------- held against the reference's lint ---

_REF_FIX = os.path.join(_REPO, "tests", "fixtures", "lint")


def _rule_classes(rule_id: str) -> tuple:
    """(the reference's rule class, the port's) for ``rule_id``."""
    from csmom_tpu.analysis import project_rules as ref_project
    from csmom_tpu.analysis import rules as ref_rules
    from csmom_tpu_torch.analysis import project_rules, rules

    name = "".join(w.capitalize() for w in rule_id.split("-"))
    for ref_mod, mod in ((ref_rules, rules), (ref_project, project_rules)):
        if hasattr(mod, name):
            return getattr(ref_mod, name), getattr(mod, name)
    raise KeyError(rule_id)


def _as_reference(text: str) -> str:
    """The port's names in ``text`` rewritten to the reference's: the
    package and the fixture directory."""
    return text.replace("tests.fixtures.lint_torch.", "tests.fixtures.lint.") \
        .replace(_PKG, "csmom_tpu")


def _statement(msg: str, reference: bool) -> str:
    """A message's text before its advice, which follows the first " — "
    in the reference's wording."""
    if not reference:
        msg = _as_reference(msg)
    return msg.split(" — ")[0]


def _held_to_the_reference(ref_rep, rep) -> None:
    """The same findings and suppressions in both reports, by rule, line
    and call chain; the port words some advice differently, so each of
    its messages need only start with the reference's statement."""
    for ref_side, side in ((ref_rep.findings, rep.findings),
                           (ref_rep.suppressed, rep.suppressed)):
        def sites(fs, reference):
            return sorted((f.rule, f.line, tuple(
                c if reference else _as_reference(c) for c in f.chain))
                for f in fs)

        assert sites(side, False) == sites(ref_side, True)
        # a line may carry several findings of one rule (a helper that
        # prints and reads a clock): each port finding matches one of the
        # reference's statements there, each statement used once
        said: dict = {}
        for f in ref_side:
            said.setdefault((f.rule, f.line), []).append(
                _statement(f.message, True))
        for f in side:
            msg = _statement(f.message, False)
            refs = said[(f.rule, f.line)]
            ref = next((r for r in refs if _as_reference(f.message).startswith(r)
                        or msg == r), None)
            assert ref is not None, (
                f"{f.rule} at line {f.line}: the port says {msg!r}, the "
                f"reference {refs!r}")
            refs.remove(ref)


@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule_id", RULES)
def test_every_rule_agrees_with_the_reference_on_its_fixtures(rule_id, kind):
    """The reference's rule on its fixture and the port's on the port's
    copy report the same findings: the same rule, line and call chain,
    the port's message starting with the reference's statement of the
    defect."""
    ref_cls, cls = _rule_classes(rule_id)
    bad, clean = _rule_fixture_pair(rule_id)
    path = bad if kind == "bad" else clean
    ref_path = os.path.join(_REF_FIX, os.path.relpath(path, _FIX))
    from csmom_tpu.analysis import run_lint as ref_run_lint

    ref_rep = ref_run_lint(paths=[ref_path], rules=[ref_cls()])
    rep = run_lint(paths=[path], rules=[cls()])
    if kind == "bad":
        assert ref_rep.findings, f"the reference's {rule_id} found nothing"
    _held_to_the_reference(ref_rep, rep)


# one source, written for each package: pragma and alias semantics
_SHARED_SOURCES = {
    "pragma_live": None,
    "stale_pragma": None,
    "trailing_pragma": (
        "import time\n\n\n"
        "def two():\n"
        "    a = time.time()  # lint: allow[clock-discipline] this one\n"
        "    b = time.time()\n"
        "    return a + b\n"),
    "standalone_pragma": (
        "import threading\nimport time\n\n_L = threading.Lock()\n\n\n"
        "def f():\n"
        "    with _L:\n"
        "        # lint: allow[lock-discipline] a bounded wait\n"
        "        time.sleep(0.1)\n"
        "        time.sleep(0.2)\n"),
    "alias_order": (
        "import time\n\n\n"
        "def other():\n"
        "    t = time.time\n"
        "    return t\n\n\n"
        "t = len\n"
        'x = t("abc")\n'),
    "unknown_rule": "# lint: allow[no-such-rule] why not\nX = 1\n",
    "clean_clock": (
        "from {pkg}.utils.deadline import mono_now_s\n\n\n"
        "def f():\n"
        "    return mono_now_s()\n"),
}


@pytest.mark.parametrize("name", sorted(_SHARED_SOURCES))
def test_pragma_and_alias_semantics_agree_with_the_reference(name, tmp_path):
    """The four per-file rules of each package, over one source written
    for it (the committed pragma fixtures, or a source with the package
    name filled in): the same findings and the same suppressions."""
    from csmom_tpu.analysis import run_lint as ref_run_lint

    ids = ["clock-discipline", "lock-discipline", "dial-discipline",
           "enumeration-drift"]
    pairs = [_rule_classes(r) for r in ids]
    src = _SHARED_SOURCES[name]
    if src is None:
        ref_path = os.path.join(_REF_FIX, f"{name}.py")
        path = _fixture(f"{name}.py")
    else:
        (tmp_path / "ref").mkdir()
        (tmp_path / "port").mkdir()
        ref_path = str(tmp_path / "ref" / f"{name}.py")
        path = str(tmp_path / "port" / f"{name}.py")
        with open(ref_path, "w") as fh:
            fh.write(src.format(pkg="csmom_tpu"))
        with open(path, "w") as fh:
            fh.write(src.format(pkg=_PKG))
    ref_rep = ref_run_lint(paths=[ref_path], rules=[r() for r, _ in pairs])
    rep = run_lint(paths=[path], rules=[c() for _, c in pairs])
    _held_to_the_reference(ref_rep, rep)


def test_clock_discipline_catches_every_alias_form():
    from csmom_tpu_torch.analysis.rules import ClockDiscipline

    rep = run_lint(paths=[_fixture("clock_discipline_bad.py")],
                   rules=[ClockDiscipline()])
    assert sorted(f.line for f in rep.findings) == [11, 12, 13, 14, 16, 17]


def test_dial_discipline_flags_hot_paths_and_spares_probes():
    """Every one-shot dial on the bad fixture fires, the probe, stats and
    drain twin stays silent, and the port's serving tier sweeps clean
    without a pragma."""
    from csmom_tpu_torch.analysis.rules import DialDiscipline

    rep = run_lint(paths=[_fixture("dial_discipline_bad.py")],
                   rules=[DialDiscipline()])
    assert len(rep.findings) == 3, rep.findings
    assert all("dial-per-call" in f.message for f in rep.findings)
    rep = run_lint(paths=[_fixture("dial_discipline_clean.py")],
                   rules=[DialDiscipline()])
    assert rep.findings == []
    serve = os.path.join(_REPO, _PKG, "serve")
    rep = run_lint(paths=[serve], rules=[DialDiscipline()])
    assert rep.findings == [], rep.findings
    assert rep.suppressed == []


def test_lock_discipline_accepts_try_finally_and_with():
    from csmom_tpu_torch.analysis.rules import LockDiscipline

    rep = run_lint(paths=[_fixture("lock_discipline_clean.py")],
                   rules=[LockDiscipline()])
    assert rep.findings == []
    rep = run_lint(paths=[_fixture("lock_discipline_bad.py")],
                   rules=[LockDiscipline()])
    kinds = sorted(f.message.split("(")[0] for f in rep.findings)
    assert len(rep.findings) == 3  # bare acquire, sleep, sendall
    assert any("acquire" in k for k in kinds)


# ---------------------------------------------- the whole-program rules ---

def test_lock_order_catches_what_the_per_file_rule_cannot():
    """The bad package's order cycle and its helper-hidden blocking call
    are invisible to lock-discipline and caught at project scope."""
    from csmom_tpu_torch.analysis.project_rules import LockOrder
    from csmom_tpu_torch.analysis.rules import LockDiscipline

    bad = _fixture("lock_order_bad")
    per_file = run_lint(paths=[bad], rules=[LockDiscipline()])
    assert per_file.findings == [], str(per_file.findings)
    rep = run_lint(paths=[bad], rules=[LockOrder()])
    msgs = " | ".join(f.message for f in rep.findings)
    assert "acquisition-order cycle" in msgs
    assert "blocking call (time.sleep)" in msgs and "slow_push" in msgs
    assert any(len(f.chain) >= 2 for f in rep.findings)


def test_lock_order_flags_reacquisition_through_a_chain(tmp_path):
    from csmom_tpu_torch.analysis.project_rules import LockOrder

    p = tmp_path / "re.py"
    p.write_text(
        "import threading\n\n\n"
        "class A:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n\n"
        "    def outer(self):\n"
        "        with self._lock:\n"
        "            self.inner()\n\n"
        "    def inner(self):\n"
        "        with self._lock:\n"
        "            return 1\n")
    rep = run_lint(paths=[str(p)], rules=[LockOrder()])
    assert any("re-acquired" in f.message for f in rep.findings)

    p.write_text(p.read_text().replace("threading.Lock()",
                                       "threading.RLock()"))
    rep = run_lint(paths=[str(p)], rules=[LockOrder()])
    assert rep.findings == [], rep.findings


def test_lock_order_covers_anonymous_local_locks(tmp_path):
    from csmom_tpu_torch.analysis.project_rules import LockOrder

    (tmp_path / "a.py").write_text(
        "import threading\n\n"
        "from .b import push\n\n\n"
        "def drive():\n"
        "    state = {'lock': threading.Lock()}\n"
        "    with state['lock']:\n"
        "        push(state)\n")
    (tmp_path / "b.py").write_text(
        "import time\n\n\ndef push(state):\n    time.sleep(0.01)\n")
    rep = run_lint(paths=[str(tmp_path)], rules=[LockOrder()])
    assert any("locally-scoped lock" in f.message
               and "time.sleep" in f.message for f in rep.findings), (
        rep.findings)


def test_lock_order_multi_item_with_orders_left_to_right(tmp_path):
    from csmom_tpu_torch.analysis.project_rules import LockOrder

    p = tmp_path / "multi.py"
    p.write_text(
        "import threading\n\n\n"
        "class M:\n"
        "    def __init__(self):\n"
        "        self._a_lock = threading.Lock()\n"
        "        self._b_lock = threading.Lock()\n\n"
        "    def fwd(self):\n"
        "        with self._a_lock, self._b_lock:\n"
        "            return 1\n\n"
        "    def rev(self):\n"
        "        with self._b_lock:\n"
        "            with self._a_lock:\n"
        "                return 2\n")
    rep = run_lint(paths=[str(p)], rules=[LockOrder()])
    assert any("acquisition-order cycle" in f.message
               for f in rep.findings), rep.findings

    p2 = tmp_path / "self.py"
    p2.write_text(
        "import threading\n\n\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n\n"
        "    def broken(self):\n"
        "        with self._lock:\n"
        "            with self._lock:\n"
        "                return 1\n")
    rep = run_lint(paths=[str(p2)], rules=[LockOrder()])
    assert any("re-acquired inside its own with-block" in f.message
               for f in rep.findings), rep.findings


def test_bare_condition_is_rlock_backed_and_reentrant(tmp_path):
    from csmom_tpu_torch.analysis.project_rules import LockOrder

    p = tmp_path / "cv.py"
    p.write_text(
        "import threading\n\n\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self._cv_lock = threading.Condition()\n\n"
        "    def outer(self):\n"
        "        with self._cv_lock:\n"
        "            self.inner()\n\n"
        "    def inner(self):\n"
        "        with self._cv_lock:\n"
        "            return 1\n")
    rep = run_lint(paths=[str(p)], rules=[LockOrder()])
    assert rep.findings == [], rep.findings


def test_condition_aliases_the_lock_it_wraps(tmp_path):
    from csmom_tpu_torch.analysis.project_rules import LockOrder

    p = tmp_path / "cond.py"
    p.write_text(
        "import threading\n\n\n"
        "class Q:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._nonempty = threading.Condition(self._lock)\n\n"
        "    def broken(self):\n"
        "        with self._lock:\n"
        "            self.wake()\n\n"
        "    def wake(self):\n"
        "        with self._nonempty:\n"
        "            return 1\n")
    rep = run_lint(paths=[str(p)], rules=[LockOrder()])
    assert any("re-acquired" in f.message for f in rep.findings), (
        rep.findings)


def test_project_findings_respect_pragmas(tmp_path):
    a = tmp_path / "a.py"
    a.write_text(
        "import threading\n\n"
        "from .b import helper\n\n\n"
        "class A:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n\n"
        "    def run(self):\n"
        "        with self._lock:\n"
        "            # lint: allow[lock-order] startup only, no traffic\n"
        "            helper()\n")
    (tmp_path / "b.py").write_text(
        "import time\n\n\ndef helper():\n    time.sleep(0.01)\n")
    from csmom_tpu_torch.analysis.project_rules import LockOrder

    rep = run_lint(paths=[str(tmp_path)], rules=[LockOrder()])
    assert rep.findings == [], rep.findings
    assert [s.rule for s in rep.suppressed] == ["lock-order"]


def _project_context():
    from csmom_tpu_torch.analysis.callgraph import ProjectContext
    from csmom_tpu_torch.analysis.core import (
        FileContext,
        RunContext,
        default_sources,
    )

    run = RunContext(_REPO)
    slots = {}
    for p in default_sources():
        rel = os.path.relpath(p, _REPO)
        with open(p, encoding="utf-8") as f:
            slots[rel] = FileContext(p, rel, f.read(), run)
    pc = ProjectContext(slots, _REPO)
    pc.run = run
    return pc.build()


def test_committed_tree_lock_audit_is_pinned():
    """The port's cross-lock acquisition orders are exactly the
    reference's four, renamed: the admission queue's lock over the
    metrics lock, and the elastic tier's backfill lock over its probe
    path's leaves, each one-directional.  The kernels' launch lock, the
    kernel build lock and the shard barrier's lock add none.  The
    router's lock never nests, and the supervisor's restart path spawns
    and probes outside its event lock.  A new edge is a new global
    ordering constraint; this test makes adding one deliberate."""
    pc = _project_context()
    edges = set()
    for info in pc.functions.values():
        for outer, inner, _line in info.order_pairs:
            edges.add((outer, inner))
        for s in info.calls:
            if s.held and s.callee in pc.functions:
                for lock in pc.acquired_closure(s.callee):
                    for h in s.held:
                        if h != lock:
                            edges.add((h, lock))
    backfill = f"{_PKG}.serve.fleet.FleetController._backfill_lock"
    assert edges == {(f"{_PKG}.serve.queue.AdmissionQueue._lock",
                      f"{_PKG}.obs.metrics._LOCK"),
                     (backfill, f"{_PKG}.chaos.inject._STATE_LOCK"),
                     (backfill, f"{_PKG}.serve.fleet.FleetController._lock"),
                     (backfill, f"{_PKG}.serve.proto._PARTITION_LOCK"),
                     }, sorted(edges)
    assert not any(e[1] == backfill for e in edges)
    router_lock = f"{_PKG}.serve.router.Router._lock"
    assert not any(router_lock in e for e in edges)
    for lock in (f"{_PKG}.ops.kernels._LAUNCH_LOCK", f"{_PKG}.ops.build._LOCK"):
        assert lock in pc.lock_kinds
        assert not any(lock in e for e in edges)
    sup = f"{_PKG}.serve.supervisor.PoolSupervisor"
    for fn in ("_restart", "_spawn", "_probe_until_ready"):
        assert pc.acquired_closure(f"{sup}.{fn}").keys() <= {
            f"{sup}._lock", f"{_PKG}.chaos.inject._STATE_LOCK",
            f"{_PKG}.obs.metrics._LOCK",
            f"{_PKG}.serve.proto._PARTITION_LOCK"}
    for info in pc.functions.values():
        for s in info.calls:
            if s.callee in (f"{sup}._spawn", f"{sup}._probe_until_ready"):
                assert not s.held, (info.qname, s.line)


def test_compile_surface_fails_when_a_manifest_entry_is_deregistered():
    """The committed registry passes; the serve feeder with one entry
    name dropped fails the sweep at serve/buckets.py; a feeder declaring
    no names fails with the no-feeder message."""
    import dataclasses

    from csmom_tpu_torch.registry import ensure_builtin

    reg = ensure_builtin()
    spec = reg.get("serve.buckets", kind="compile")
    orig_names = spec.manifest_names_fn

    rep = run_lint(project=True, rule="compile-surface")
    assert rep.findings == [], rep.findings

    try:
        reg.register(dataclasses.replace(
            spec, manifest_names_fn=lambda p: set(
                sorted(orig_names(p))[:-1])), replace=True)
        rep = run_lint(project=True, rule="compile-surface")
        assert any("no warmed manifest entry" in f.message
                   and f.path == f"{_PKG}/serve/buckets.py"
                   for f in rep.findings), rep.findings

        reg.register(dataclasses.replace(spec, manifest_names_fn=None),
                     replace=True)
        rep = run_lint(project=True, rule="compile-surface")
        assert any("no registered manifest feeder" in f.message
                   for f in rep.findings), rep.findings
    finally:
        reg.register(spec, replace=True)
    rep = run_lint(project=True, rule="compile-surface")
    assert rep.findings == []


def test_compile_surface_registry_and_health_agree():
    from csmom_tpu_torch.registry import manifest_entry_names
    from csmom_tpu_torch.serve.health import expected_entry_names

    for profile in ("serve", "serve-smoke"):
        declared = manifest_entry_names(profile)
        expected = expected_entry_names(profile)
        assert expected <= declared, (
            f"profile {profile}: dispatchable shapes missing warm "
            f"coverage: {sorted(expected - declared)[:3]}")


def test_compile_surface_anchor_is_identical_warm_and_cold(tmp_path):
    import dataclasses

    from csmom_tpu_torch.registry import ensure_builtin

    reg = ensure_builtin()
    spec = reg.get("serve.buckets", kind="compile")
    orig_names = spec.manifest_names_fn
    cache_dir = str(tmp_path / "c")
    try:
        reg.register(dataclasses.replace(
            spec, manifest_names_fn=lambda p: set(
                sorted(orig_names(p))[:-1])), replace=True)
        cold = run_lint(project=True, rule="compile-surface",
                        cache_dir=cache_dir)
        warm = run_lint(project=True, rule="compile-surface",
                        cache_dir=cache_dir)
        assert warm.cache["hits"] == warm.files
        assert cold.findings and warm.findings
        assert ([(f.path, f.line) for f in cold.findings]
                == [(f.path, f.line) for f in warm.findings])
        assert cold.findings[0].line > 1   # the real PROFILES line
    finally:
        reg.register(spec, replace=True)


def test_compile_surface_toy_check_is_identical_warm_and_cold(tmp_path):
    cache_dir = str(tmp_path / "c")
    bad = _fixture("compile_surface_bad")
    cold = run_lint(paths=[bad], project=True, cache_dir=cache_dir)
    warm = run_lint(paths=[bad], project=True, cache_dir=cache_dir)
    for rep in (cold, warm):
        assert any(f.rule == "compile-surface"
                   and "no warmed manifest entry" in f.message
                   for f in rep.findings), rep.findings
    assert ([(f.path, f.line) for f in cold.findings]
            == [(f.path, f.line) for f in warm.findings])


# ---------------------------------------------- the incremental cache ------

def test_cache_lives_in_the_ports_build_directory(tmp_path):
    """The sweep cache is a file of the port's own, never the
    reference's ``.csmom_lint_cache/``."""
    from csmom_tpu_torch.analysis.cache import SweepCache

    sc = SweepCache(str(tmp_path), ["clock-discipline"])
    assert sc.path == os.path.join(str(tmp_path), "build", _PKG, "lint_cache",
                                   "sweep.json")
    repo = tmp_path / "repo"
    (repo / _PKG).mkdir(parents=True)
    mod = repo / _PKG / "m.py"
    mod.write_text("X = 1\n")
    run_lint(paths=[str(mod)], repo=str(repo))
    assert (repo / "build" / _PKG / "lint_cache" / "sweep.json").is_file()
    assert not (repo / ".csmom_lint_cache").exists()


def test_cache_coexists_across_rule_filtered_sweeps(tmp_path):
    cache_dir = str(tmp_path / "c")
    run_lint(project=True, cache_dir=cache_dir)              # warm full
    run_lint(rule="clock-discipline", cache_dir=cache_dir)   # filtered
    again = run_lint(project=True, cache_dir=cache_dir)
    assert again.cache["hits"] == again.files, again.cache
    assert again.cache["project_hit"] is True


def test_fully_warm_project_sweep_does_not_rewrite_the_cache(tmp_path):
    cache_dir = str(tmp_path / "c")
    run_lint(project=True, cache_dir=cache_dir)
    path = os.path.join(cache_dir, "sweep.json")
    before = os.stat(path).st_mtime_ns
    warm = run_lint(project=True, cache_dir=cache_dir)
    assert warm.cache["hits"] == warm.files
    assert os.stat(path).st_mtime_ns == before, "warm sweep rewrote sweep.json"


def test_cache_second_sweep_is_faster_and_byte_identical(tmp_path):
    """On an unchanged tree the warm project sweep is at least 5x faster
    than the cold one, and the reports agree finding for finding."""
    cache_dir = str(tmp_path / "lintcache")
    t0 = time.monotonic()
    cold = run_lint(project=True, cache_dir=cache_dir)
    t1 = time.monotonic()
    warm = run_lint(project=True, cache_dir=cache_dir)
    t2 = time.monotonic()
    assert cold.cache["misses"] > 100 and cold.cache["hits"] == 0
    assert warm.cache["hits"] == warm.files and warm.cache["misses"] == 0
    assert warm.cache["project_hit"] is True
    assert [str(f) for f in cold.findings] == [str(f) for f in warm.findings]
    assert ([str(s) for s in cold.suppressed]
            == [str(s) for s in warm.suppressed])
    cold_s, warm_s = t1 - t0, max(t2 - t1, 1e-9)
    assert cold_s / warm_s >= 5.0, (
        f"cache speedup only {cold_s / warm_s:.1f}x "
        f"({cold_s:.3f}s -> {warm_s:.3f}s)")


def test_cache_invalidates_on_content_change_and_honors_no_cache(tmp_path):
    repo = tmp_path / "repo"
    (repo / _PKG).mkdir(parents=True)
    mod = repo / _PKG / "m.py"
    mod.write_text("X = 1\n")
    cache_dir = str(tmp_path / "c")
    r1 = run_lint(paths=[str(mod)], repo=str(repo), cache_dir=cache_dir)
    assert r1.findings == []
    r2 = run_lint(paths=[str(mod)], repo=str(repo), cache_dir=cache_dir)
    assert r2.cache["hits"] == 1
    mod.write_text("import time\nX = time.time()\n")
    r3 = run_lint(paths=[str(mod)], repo=str(repo), cache_dir=cache_dir)
    assert r3.cache["hits"] == 0 and r3.cache["misses"] == 1
    assert [f.rule for f in r3.findings] == ["clock-discipline"]
    r4 = run_lint(paths=[str(mod)], repo=str(repo), cache_dir=cache_dir,
                  cache=False)
    assert r4.cache == {"enabled": False}
    assert [f.rule for f in r4.findings] == ["clock-discipline"]


def test_cached_sweep_replays_suppressions_and_cross_file_facts():
    rep = run_lint(project=True)
    rep2 = run_lint(project=True)
    assert len(rep2.suppressed) == len(rep.suppressed) > 0
    assert rep2.findings == rep.findings == []


def test_vocabulary_change_invalidates_cached_enumeration_verdicts(
        tmp_path, monkeypatch):
    import csmom_tpu_torch.chaos.plan as plan

    repo = tmp_path / "repo"
    (repo / _PKG).mkdir(parents=True)
    mod = repo / _PKG / "m.py"
    mod.write_text('def f(checkpoint):\n    checkpoint("zzz.bogus")\n')
    cache_dir = str(tmp_path / "c")
    r1 = run_lint(paths=[str(mod)], repo=str(repo), cache_dir=cache_dir)
    assert [f.rule for f in r1.findings] == ["enumeration-drift"]
    monkeypatch.setattr(plan, "KNOWN_POINTS",
                        tuple(plan.KNOWN_POINTS) + ("zzz.bogus",))
    r2 = run_lint(paths=[str(mod)], repo=str(repo), cache_dir=cache_dir)
    assert r2.findings == [], str(r2.findings)


def test_damaged_cache_with_valid_marker_reads_as_cold(tmp_path):
    from csmom_tpu_torch.analysis.cache import SweepCache

    repo = tmp_path / "repo"
    (repo / _PKG).mkdir(parents=True)
    mod = repo / _PKG / "m.py"
    mod.write_text("X = 1\n")
    cache_dir = tmp_path / "c"
    cache_dir.mkdir()
    for alien in (
            {"format": 2, "files": {"a.py": [1]}, "project": [1]},
            {"format": 2, "files": {"a.py": {"sig": {"digest": "d",
             "raw": [{"line": 1}], "pragmas": [], "facts": {}}}},
             "project": {}},
            {"format": 2, "files": {}, "project": {"k": {"r": [None]}}},
    ):
        (cache_dir / "sweep.json").write_text(json.dumps(alien))
        sc = SweepCache(str(repo), ["clock-discipline"],
                        directory=str(cache_dir))
        assert sc.lookup("a.py", "d") is None
        assert sc.lookup_project("k") is None
        rep = run_lint(paths=[str(mod)], repo=str(repo),
                       cache_dir=str(cache_dir))
        assert rep.findings == [] and rep.cache["hits"] == 0


def test_editing_a_plugin_rule_source_invalidates_its_cached_verdicts(
        tmp_path):
    import importlib.util

    plug = tmp_path / "plug_rule_torch.py"
    plug.write_text(
        "from csmom_tpu_torch.analysis.core import LintRule\n\n\n"
        "class PlugRule(LintRule):\n"
        "    id = 'plug-rule'\n"
        "    description = 'test-only plugin rule'\n\n"
        "    def finish_file(self, ctx):\n"
        "        pass\n")
    spec = importlib.util.spec_from_file_location("plug_rule_torch", str(plug))
    module = importlib.util.module_from_spec(spec)
    sys.modules["plug_rule_torch"] = module
    spec.loader.exec_module(module)
    register_engine(name="plug-rule", kind="lint", rule_cls=module.PlugRule,
                    description="test-only plugin rule")
    try:
        repo = tmp_path / "repo"
        (repo / _PKG).mkdir(parents=True)
        mod = repo / _PKG / "m.py"
        mod.write_text("X = 1\n")
        cache_dir = str(tmp_path / "c")
        run_lint(paths=[str(mod)], repo=str(repo), cache_dir=cache_dir)
        warm = run_lint(paths=[str(mod)], repo=str(repo), cache_dir=cache_dir)
        assert warm.cache["hits"] == 1
        plug.write_text(plug.read_text() + "# tightened\n")
        cold = run_lint(paths=[str(mod)], repo=str(repo), cache_dir=cache_dir)
        assert cold.cache["hits"] == 0 and cold.cache["misses"] == 1
    finally:
        unregister_engine("plug-rule", kind="lint")
        sys.modules.pop("plug_rule_torch", None)


def test_cli_no_cache_flag_is_wired(capsys):
    from csmom_tpu_torch.cli.main import main

    rc = main(["lint", "--no-cache", "--format", "json",
               "--paths", _fixture("lock_discipline_clean.py")])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["cache"] == {"enabled": False}


def test_cli_records_sweep_seconds_on_the_metrics_gauge(capsys):
    from csmom_tpu_torch import obs
    from csmom_tpu_torch.cli.main import main
    from csmom_tpu_torch.obs import metrics

    obs.arm(None, run_id="lint-unit", proc="t")
    try:
        rc = main(["lint", "--paths", _fixture("lock_discipline_clean.py")])
        capsys.readouterr()
        assert rc == 0
        v = metrics.gauge("lint.sweep_s").value
        assert isinstance(v, float) and v > 0.0
    finally:
        obs.disarm()
        metrics.reset()


# ------------------------------------------------------- pragma semantics --

def test_live_pragma_suppresses_and_is_not_stale():
    rep = run_lint(paths=[_fixture("pragma_live.py")])
    assert rep.findings == []
    assert len(rep.suppressed) == 1
    assert rep.suppressed[0].rule == "clock-discipline"


def test_stale_pragma_is_itself_a_finding():
    rep = run_lint(paths=[_fixture("stale_pragma.py")])
    assert [f.rule for f in rep.findings] == [STALE_PRAGMA_RULE]
    assert "unused suppression" in rep.findings[0].message


def test_trailing_pragma_does_not_leak_onto_the_next_line(tmp_path):
    p = tmp_path / "two.py"
    p.write_text(
        "import time\n\n\n"
        "def two():\n"
        "    a = time.time()  # lint: allow[clock-discipline] this one\n"
        "    b = time.time()\n"
        "    return a + b\n")
    rep = run_lint(paths=[str(p)])
    assert [f.line for f in rep.findings] == [6], rep.findings
    assert [s.line for s in rep.suppressed] == [5]


def test_alias_map_applies_bindings_in_source_order(tmp_path):
    p = tmp_path / "alias.py"
    p.write_text(
        "import time\n\n\n"
        "def other():\n"
        "    t = time.time\n"
        "    return t\n\n\n"
        "t = len\n"
        'x = t("abc")\n')
    rep = run_lint(paths=[str(p)])
    assert rep.findings == [], rep.findings


def test_unknown_rule_in_pragma_is_a_finding(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("# lint: allow[no-such-rule] why not\nX = 1\n")
    rep = run_lint(paths=[str(p)])
    assert any(f.rule == STALE_PRAGMA_RULE
               and "unknown rule" in f.message for f in rep.findings)


def test_a_pragma_of_an_unported_rule_is_unknown(tmp_path):
    """Every rule of the reference is registered here now: a pragma naming
    tracer-hygiene is a known rule's, so on a line with nothing to
    suppress it is stale, not unknown, while a rule no package has is
    still unknown."""
    p = tmp_path / "x.py"
    p.write_text("# lint: allow[tracer-hygiene] nothing here\nX = 1\n")
    rep = run_lint(paths=[str(p)])
    stale = [f for f in rep.findings if f.rule == STALE_PRAGMA_RULE]
    assert stale and not any("unknown rule" in f.message for f in stale)
    p.write_text("# lint: allow[xla-hygiene] not a rule\nX = 1\n")
    rep = run_lint(paths=[str(p)])
    assert any(f.rule == STALE_PRAGMA_RULE and "unknown rule" in f.message
               for f in rep.findings)


def test_clock_tier_modules_cannot_pragma_out(tmp_path):
    ring = tmp_path / _PKG / "stream" / "ring.py"
    ring.parent.mkdir(parents=True)
    ring.write_text(
        "# lint: allow[clock-discipline] please let me\n"
        f"from {_PKG}.utils.deadline import mono_now_s\n")
    rep = run_lint(paths=[str(ring)], repo=str(tmp_path))
    assert any("must not carry a clock-discipline pragma" in f.message
               for f in rep.findings), rep.findings
    assert rep.findings


def test_unparseable_source_is_a_finding_not_a_crash(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def broken(:\n")
    rep = run_lint(paths=[str(p)])
    assert [f.rule for f in rep.findings] == ["parse-error"]


def test_non_utf8_source_is_a_finding_not_a_crash(tmp_path):
    p = tmp_path / "latin.py"
    p.write_bytes(b"# caf\xe9\nX = 1\n")
    rep = run_lint(paths=[str(p)])
    assert [f.rule for f in rep.findings] == ["parse-error"]


# ------------------------------------------- registry + gate integration ---

def test_builtin_rules_are_registry_citizens():
    names = [s.name for s in lint_rules()]
    assert names == RULES
    for s in lint_rules():
        assert s.kind == "lint" and s.rule_cls is not None
        assert s.description
    scopes = {s.name: getattr(s.rule_cls, "scope", "file")
              for s in lint_rules()}
    assert {n for n, sc in scopes.items() if sc == "project"} == {
        "lock-order", "helper-hygiene", "compile-surface"}


def test_project_rules_join_only_project_sweeps():
    plain = run_lint(paths=[_fixture("lock_discipline_clean.py")])
    assert set(plain.rules) == {"clock-discipline", "tracer-hygiene",
                                "lock-discipline", "donation-safety",
                                "enumeration-drift", "dial-discipline"}
    assert plain.project is False
    via_flag = run_lint(paths=[_fixture("lock_discipline_clean.py")],
                        project=True)
    assert "lock-order" in via_flag.rules and via_flag.project is True
    via_rule = run_lint(paths=[_fixture("lock_order_bad")],
                        rule="lock-order")
    assert via_rule.project is True
    assert [f for f in via_rule.findings if f.rule == "lock-order"]


def test_cli_rules_listing_marks_project_scope(capsys):
    from csmom_tpu_torch.cli.main import main

    rc = main(["lint", "--rules"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "lock-order  [project]" in out
    assert "compile-surface  [project]" in out
    assert "helper-hygiene  [project]" in out
    assert "9 rules registered" in out


def test_toy_rule_registered_at_runtime_joins_the_sweep(tmp_path, capsys):
    """Register once and a rule is in run_lint, its pragmas and
    ``registry list``, with no other file edited."""

    class NoTodo(LintRule):
        id = "no-todo-markers"
        description = "test-only toy rule: comments must not say TODO"

        def finish_file(self, ctx):
            for kind, line, text in ctx.tokens:
                if kind == "comment" and "TODO" in text:
                    ctx.report(self.id, line, "TODO marker in a comment")

    register_engine(name=NoTodo.id, kind="lint", rule_cls=NoTodo,
                    description=NoTodo.description)
    try:
        assert NoTodo.id in [s.name for s in lint_rules()]
        p = tmp_path / "t.py"
        p.write_text("x = 1  # TODO remove\n")
        rep = run_lint(paths=[str(p)])
        assert any(f.rule == NoTodo.id for f in rep.findings)
        p.write_text("# lint: allow[no-todo-markers] grandfathered\n"
                     "x = 1  # TODO remove\n")
        rep = run_lint(paths=[str(p)])
        assert not [f for f in rep.findings if f.rule == NoTodo.id]
        from csmom_tpu_torch.cli.main import main

        rc = main(["registry", "list", "--kind", "lint"])
        out = capsys.readouterr().out
        assert rc == 0 and NoTodo.id in out
    finally:
        unregister_engine(NoTodo.id, kind="lint")
    assert NoTodo.id not in [s.name for s in lint_rules()]


def test_checkpoint_vocabulary_round_trips_on_the_full_sweep():
    """Both directions of the vocabulary check over the whole package: it
    round-trips, and a doctored dead entry is caught at KNOWN_POINTS."""
    from csmom_tpu_torch.analysis.rules import EnumerationDrift

    rep = run_lint(rules=[EnumerationDrift()])
    assert rep.findings == []

    ghost = EnumerationDrift()
    ghost._vocab = ghost._vocab + ("ghost.point",)
    rep = run_lint(rules=[ghost])
    assert any("ghost.point" in f.message
               and f.path.endswith("chaos/plan.py")
               for f in rep.findings), rep.findings


def test_unported_points_are_named_with_their_owner(monkeypatch):
    """Every vocabulary point has a call site since the bench tooling
    and the capture tier came (``bench.*`` in ``bench.py``, ``mini.*``
    in ``chaos/minibench.py``), so the owners table is empty and the
    round trip covers all of them.  The table's guard still holds: an
    entry that left the vocabulary, or whose call site exists, is
    flagged so the table cannot go stale."""
    from csmom_tpu_torch.analysis import rules
    from csmom_tpu_torch.chaos.plan import KNOWN_POINTS

    assert rules.UNPORTED_POINT_OWNERS == {}
    assert {"bench.probe", "bench.compile", "bench.row", "bench.finish",
            "bench.land", "mini.start", "mini.row",
            "mini.finish"} <= set(KNOWN_POINTS)
    rep = run_lint(rules=[rules.EnumerationDrift()])
    assert rep.findings == []
    owners = {"mini.row": "8c", "serve.dispatch": "8b"}  # live call sites
    monkeypatch.setattr(rules, "UNPORTED_POINT_OWNERS", owners)
    rep = run_lint(rules=[rules.EnumerationDrift()])
    assert sorted(f.message.split("'")[1] for f in rep.findings) == [
        "mini.row", "serve.dispatch"]
    assert all("call site uses it now" in f.message for f in rep.findings)


def test_lint_is_a_device_free_subcommand():
    from csmom_tpu_torch.cli.main import _DEVICE_FREE_COMMANDS

    assert "lint" in _DEVICE_FREE_COMMANDS


# ------------------------------ the host syncs and donations of the card ---

def test_tracer_hygiene_flags_the_torch_host_syncs(tmp_path):
    """Beyond the reference's escapes: ``int()``/``bool()`` of a
    parameter, ``.tolist()``/``.cpu()``/``.numpy()`` on one and
    ``torch.cuda.synchronize()``, inside a registered scorer; host values
    of the enclosing factory stay legal."""
    p = tmp_path / "scorer.py"
    p.write_text(
        "import torch\n\n"
        "from csmom_tpu_torch.registry.core import ServeSurface\n\n\n"
        "def make(params):\n"
        "    n = int(params['n_bins'])\n\n"
        "    def fn(values, mask):\n"
        "        a = int(values)\n"
        "        b = bool(mask)\n"
        "        c = values[0].tolist()\n"
        "        d = mask.cpu()\n"
        "        e = values.numpy()\n"
        "        torch.cuda.synchronize()\n"
        "        return a + b + c + d + e + n\n\n"
        "    return fn\n\n\n"
        "S = ServeSurface(batch_fn=make, stub_fn=make)\n")
    from csmom_tpu_torch.analysis.rules import TracerHygiene

    rep = run_lint(paths=[str(p)], rules=[TracerHygiene()])
    got = sorted((f.line, f.message.split(" — ")[0]) for f in rep.findings)
    assert got == [
        (10, "int() on traced parameter 'values' in 'fn'"),
        (11, "bool() on traced parameter 'mask' in 'fn'"),
        (12, ".tolist() on traced parameter 'values' in 'fn'"),
        (13, ".cpu() on traced parameter 'mask' in 'fn'"),
        (14, ".numpy() on traced parameter 'values' in 'fn'"),
        (15, "torch.cuda.synchronize() inside traced function 'fn'"),
    ]


def test_donation_safety_reads_donate_panels_positions(tmp_path):
    """``donate_panels=True`` consumes the positions its surface
    consumes: the grid's panel pair, the hysteresis engine's three
    panels; ``consume`` itself consumes all; a rebind retires a name."""
    p = tmp_path / "caller.py"
    p.write_text(
        "from csmom_tpu_torch.backtest.event import hysteresis_event_backtest\n"
        "from csmom_tpu_torch.backtest.grid import jk_grid_backtest\n"
        "from csmom_tpu_torch.utils.donation import consume\n\n\n"
        "def grid(p, m, Js, Ks):\n"
        "    g = jk_grid_backtest(p, m, Js, Ks, donate_panels=True)\n"
        "    return g, Js, Ks, m\n\n\n"
        "def hyst(p, v, s, adv, vol):\n"
        "    r = hysteresis_event_backtest(p, v, s, adv, vol, donate_panels=True)\n"
        "    return r, adv, s\n\n\n"
        "def plain(p, m, Js, Ks):\n"
        "    g = jk_grid_backtest(p, m, Js, Ks, donate_panels=False)\n"
        "    return g, p\n\n\n"
        "def raw(a, b):\n"
        "    x, y = consume(a, b)\n"
        "    b = x\n"
        "    return a, b, y\n")
    from csmom_tpu_torch.analysis.rules import DonationSafety

    rep = run_lint(paths=[str(p)], rules=[DonationSafety()])
    got = sorted((f.line, f.message.split(" — ")[0]) for f in rep.findings)
    assert got == [
        (8, "'m' is read after being donated to jk_grid_backtest (line 7)"),
        (13, "'s' is read after being donated to hysteresis_event_backtest "
             "(line 12)"),
        (24, "'a' is read after being donated to consume (line 22)"),
    ]


def test_helper_hygiene_flags_a_host_copy_behind_a_scorer(tmp_path):
    """A registered ``batch_fn`` factory's scorer that reaches ``.item()``
    or ``torch.cuda.synchronize()`` through a helper is flagged at its
    call site; the factory's own host work is not a scorer's."""
    pkg = tmp_path / "toy"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "helpers.py").write_text(
        "import torch\n\n\n"
        "def peek(x):\n"
        "    return x.sum().item()\n\n\n"
        "def wait():\n"
        "    torch.cuda.synchronize()\n")
    (pkg / "engine.py").write_text(
        "from csmom_tpu_torch.registry.core import ServeSurface\n\n"
        "from .helpers import peek, wait\n\n\n"
        "def make(params):\n"
        "    def fn(values, mask):\n"
        "        total = peek(values)\n"
        "        wait()\n"
        "        return values * total\n\n"
        "    return fn\n\n\n"
        "S = ServeSurface(batch_fn=make, stub_fn=make)\n")
    from csmom_tpu_torch.analysis.project_rules import HelperHygiene

    rep = run_lint(paths=[str(pkg)], rules=[HelperHygiene()], repo=str(tmp_path))
    got = sorted((f.line, f.message.split(" reaches ")[1].split(" in ")[0])
                 for f in rep.findings)
    assert got == [(8, "host copy (.item())"),
                   (9, "device sync (torch.cuda.synchronize)")]
