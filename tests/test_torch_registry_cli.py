"""The port's ``registry list`` against ``csmom registry list``: the same
endpoint names, the same strategy zoo, the compile engines (item 8a,
ported) and the lint rules (item 8d, ported), each with its scope."""

import argparse

import pytest

from csmom_tpu.cli.registry import cmd_registry as ref_cmd_registry
from csmom_tpu_torch.cli.main import main


def _ref(capsys, **kw):
    args = dict(action="list", kind=None, endpoints=False, terse=False)
    args.update(kw)
    rc = ref_cmd_registry(argparse.Namespace(**args))
    return rc, capsys.readouterr().out


def test_endpoints_print_exactly_the_references(capsys):
    assert main(["registry", "list", "--endpoints"]) == 0
    port = capsys.readouterr().out
    rc, ref = _ref(capsys, endpoints=True)
    assert rc == 0 and port == ref
    assert port.split() == ["momentum", "turnover", "backtest",
                            "low_volatility", "zscore_combo"]


def _section(text, kind):
    """The engine names listed under ``kind`` in a registry listing."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith(f"{kind} ("))
    names = []
    for ln in lines[start + 1:]:
        if not ln.strip():
            break
        if not ln.startswith(" " * 24):
            names.append(ln.split()[0])
    return lines[start], names


def _reference_builtin_section(text, kind):
    """The reference's section without the plugins that other tests of
    the same process register in its global strategy zoo (the reference's
    own tests leave theirs registered): its builtin engines only."""
    from csmom_tpu import registry as ref_registry

    head, names = _section(text, kind)
    if kind != "strategy":
        return head, names
    builtin = {n for n, cls in ref_registry.strategies().items()
               if cls.__module__ == "csmom_tpu.strategy.builtin"}
    names = [n for n in names if n in builtin]
    return f"{kind} ({len(names)}):", names


@pytest.mark.parametrize("kind", ["serve", "strategy"])
def test_list_names_the_references_engines_of_each_kind(kind, capsys):
    assert main(["registry", "list", "--kind", kind]) == 0
    port = capsys.readouterr().out
    rc, ref = _ref(capsys, kind=kind)
    assert rc == 0
    assert _section(port, kind) == _reference_builtin_section(ref, kind)
    assert len(_section(port, kind)[1]) == {"serve": 5, "strategy": 8}[kind]
    if kind == "serve":
        rows = [ln.split() for ln in port.splitlines()[1:11:2]]
        assert [r[1:] for r in rows] == [["serve", "loadgen", "donated",
                                          "sharded"]] * 5


def test_list_covers_both_kinds_and_terse_drops_descriptions(capsys):
    assert main(["registry", "list"]) == 0
    full = capsys.readouterr().out
    assert main(["registry", "list", "--terse"]) == 0
    terse = capsys.readouterr().out
    assert "serve (5):" in full and "compile (10):" in full
    assert "strategy (8):" in full and "lint (9):" in full
    assert "32 engines registered" in full
    assert len(terse.splitlines()) == len(full.splitlines()) - 32


def test_compile_kind_lists_its_engines(capsys):
    """Kind ``compile`` (item 8a) is ported: it lists the ten engines,
    ``mesh.grid`` (item 7a) and ``mesh.serve`` (item 7b) among them, each
    with a sharded variant."""
    assert main(["registry", "list", "--kind", "compile"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("compile (10):") and "grid.jk" in out
    surfaces = {ln.split()[0]: ln.split()[1:] for ln in out.splitlines()
                if ln.startswith("  ") and not ln.startswith(" " * 24)}
    assert "mesh.serve" in surfaces
    assert [n for n, s in surfaces.items() if "sharded" not in s] == []


@pytest.mark.parametrize("kind,item", [("lint", "8d")])
def test_unported_kinds_exit_2_naming_their_item(kind, item, capsys):
    """Kind ``lint`` was refused until its item (8d) ported it: it now
    lists the reference's nine rules in its order, each with its scope,
    and exits 0."""
    assert main(["registry", "list", "--kind", kind]) == 0
    out = capsys.readouterr().out
    head, names = _section(out, kind)
    rc, ref = _ref(capsys, kind=kind)
    assert rc == 0 and (head, names) == _section(ref, kind)
    assert head == "lint (9):"
    assert names == ["clock-discipline", "tracer-hygiene", "lock-discipline",
                     "donation-safety", "enumeration-drift", "dial-discipline",
                     "lock-order", "helper-hygiene", "compile-surface"]
    scopes = {ln.split()[0]: ln.split()[-1] for ln in out.splitlines()
              if ln.startswith("  ") and not ln.startswith(" " * 24)}
    project = ("lock-order", "helper-hygiene", "compile-surface")
    assert scopes == {n: "scope:project" if n in project else "scope:file"
                      for n in names}


def _rows(text, kind):
    """``{name: surfaces}`` of the engines listed under ``kind``."""
    _, names = _section(text, kind)
    return {ln.split()[0]: ln.split()[1:] for ln in text.splitlines()
            if ln.startswith("  ") and not ln.startswith(" " * 24)
            and ln.split()[0] in names}


@pytest.mark.parametrize("kind", ["serve", "compile"])
def test_rows_equal_the_references_donated_and_sharded_included(kind, capsys):
    """Each serve and compile row lists the reference's surfaces:
    ``donated`` on every serve engine and on ``grid.jk`` and
    ``event.panel``, in the reference's place, under the port's names
    (profile ``bench-gpu``; ``sharded`` where the reference has its
    ``sharded:stub``, every port engine having a sharded variant)."""
    assert main(["registry", "list", "--kind", kind]) == 0
    port = _rows(capsys.readouterr().out, kind)
    rc, ref = _ref(capsys, kind=kind)
    want = {name: [w.replace("sharded:stub", "sharded")
                   .replace("bench-tpu", "bench-gpu") for w in ws]
            for name, ws in _rows(ref, kind).items()}
    assert rc == 0 and port == want
    donated = sorted(n for n, ws in port.items() if "donated" in ws)
    assert donated == sorted({"serve": want, "compile": ["grid.jk", "event.panel"]}[kind])


def test_unknown_action_exits_2(capsys):
    assert main(["registry", "show"]) == 2
    assert "try: list" in capsys.readouterr().err
