"""The port's landing rules (``csmom_tpu_torch/chaos/capture_lib.sh``).

The port keeps its own copy of the reference's
``benchmarks/capture_lib.sh``; ``rehearse`` sources the copy and never
``benchmarks/``.  Every case of the reference's
``tests/test_capture_lib.py`` runs here against the port's copy, with
that case's assertions, and again against the reference's library in a
directory of its own: the two leave byte-equal files.  The rules: a
partial never blocks its own upgrade, a full capture is never displaced,
a partial never claims the done-marker, a short write never lands, and
``_measured_rows`` sizes a partial as ``invariants.measured_rows`` does.
"""

import json
import os
import subprocess

import pytest

from csmom_tpu_torch.chaos import invariants as inv

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_LIB = os.path.join(_REPO, "csmom_tpu_torch", "chaos", "capture_lib.sh")
REF_LIB = os.path.join(_REPO, "benchmarks", "capture_lib.sh")

FULL = json.dumps({"metric": "grid16_scaling", "rows": [1, 2, 3]})
PARTIAL = json.dumps({"metric": "grid16_scaling", "rows": [1],
                      "partial": "deadline hit"})


class _Shell:
    def __init__(self, lib, cwd):
        self.lib, self.cwd = lib, cwd

    def __call__(self, body):
        return subprocess.run(
            ["bash", "-c", f'log() {{ :; }}; . "{self.lib}"; {body}'],
            cwd=self.cwd, capture_output=True, text=True, timeout=30,
        )


def _write(path, *lines):
    path.write_text("".join(f"{ln}\n" for ln in lines))


def case_land_artifact_extracts_last_json_line(sh, tmp_path):
    raw = tmp_path / "raw.log"
    _write(raw, "noise", '{"point": 1}', FULL)
    r = sh(f'land_artifact "{raw}" "{tmp_path}/art.json"')
    assert r.returncode == 0, r.stderr
    art = json.loads((tmp_path / "art.json").read_text())
    assert art["rows"] == [1, 2, 3]


def case_land_artifact_never_overwrites_full_with_anything(sh, tmp_path):
    art = tmp_path / "art.json"
    art.write_text(FULL)
    raw = tmp_path / "raw.log"
    for newer in (PARTIAL, json.dumps({"metric": "x", "rows": []})):
        _write(raw, newer)
        sh(f'land_artifact "{raw}" "{art}"')
        assert json.loads(art.read_text())["rows"] == [1, 2, 3]


def case_land_artifact_upgrades_partial_with_full(sh, tmp_path):
    art = tmp_path / "art.json"
    art.write_text(json.dumps(json.loads(PARTIAL), indent=1))
    raw = tmp_path / "raw.log"
    _write(raw, FULL)
    sh(f'land_artifact "{raw}" "{art}"')
    got = json.loads(art.read_text())
    assert "partial" not in got and got["rows"] == [1, 2, 3]


def case_land_artifact_partial_does_not_refresh_equal_partial(sh, tmp_path):
    """A newer partial with no more measured rows never churns the landed
    artifact."""
    art = tmp_path / "art.json"
    art.write_text(json.dumps(json.loads(PARTIAL), indent=1))
    raw = tmp_path / "raw.log"
    _write(raw, json.dumps({"metric": "grid16_scaling", "rows": [9],
                            "partial": "deadline hit"}))
    sh(f'land_artifact "{raw}" "{art}"')
    assert json.loads(art.read_text())["rows"] == [1]


def case_land_artifact_richer_partial_upgrades_thinner_partial(sh, tmp_path):
    """A deadline-hit capture that measured strictly more rows than the
    landed partial is an upgrade; thinner over richer still refuses;
    ``phases`` records count the same way."""
    art = tmp_path / "art.json"
    art.write_text(json.dumps(json.loads(PARTIAL), indent=1))  # 1 row
    raw = tmp_path / "raw.log"
    _write(raw, json.dumps({"metric": "grid16_scaling", "rows": [9, 10],
                            "partial": "deadline hit"}))
    sh(f'land_artifact "{raw}" "{art}"')
    assert json.loads(art.read_text())["rows"] == [9, 10]
    _write(raw, PARTIAL)
    sh(f'land_artifact "{raw}" "{art}"')
    assert json.loads(art.read_text())["rows"] == [9, 10]
    art2 = tmp_path / "art2.json"
    art2.write_text(json.dumps({"metric": "grid_phases", "phases": [1],
                                "partial": "deadline hit"}))
    _write(raw, json.dumps({"metric": "grid_phases", "phases": [1, 2, 3],
                            "partial": "deadline hit"}))
    sh(f'land_artifact "{raw}" "{art2}"')
    assert json.loads(art2.read_text())["phases"] == [1, 2, 3]


def case_land_artifact_counts_rows_nested_under_extra(sh, tmp_path):
    """bench-child and minibench partials carry their rows under
    extra.rows; the shell counter sizes them as measured_rows does."""
    art = tmp_path / "art.json"
    old = {"metric": "m", "value": 1.0,
           "extra": {"rows": [{"r": 0}], "partial": "deadline hit"}}
    art.write_text(json.dumps(old))
    raw = tmp_path / "raw.log"
    richer = {"metric": "m", "value": 2.0,
              "extra": {"rows": [{"r": 0}, {"r": 1}], "partial": "deadline hit"}}
    assert inv.measured_rows(richer) == 2 > inv.measured_rows(old)
    assert inv.upgrade_ok(old, richer) == []
    _write(raw, json.dumps(richer))
    sh(f'land_artifact "{raw}" "{art}"')
    assert len(json.loads(art.read_text())["extra"]["rows"]) == 2
    _write(raw, json.dumps({"metric": "m", "value": 1.0,
                            "extra": {"rows": [{"r": 9}], "partial": "deadline hit"}}))
    sh(f'land_artifact "{raw}" "{art}"')
    assert len(json.loads(art.read_text())["extra"]["rows"]) == 2


def case_land_artifact_refuses_truncated_post_write(sh, tmp_path):
    """A tmp file truncated between the formatter and the rename (ENOSPC)
    never lands, and an existing artifact stays untouched."""
    art = tmp_path / "art.json"
    art.write_text(json.dumps(json.loads(PARTIAL), indent=1))
    raw = tmp_path / "raw.log"
    _write(raw, FULL)
    r = sh(f'CSMOM_FAULT_LAND_TRUNCATE_BYTES=15 land_artifact "{raw}" "{art}"')
    assert r.returncode == 0
    assert json.loads(art.read_text())["rows"] == [1]  # prior intact
    assert not (tmp_path / "art.json.tmp").exists()
    sh(f'land_artifact "{raw}" "{art}"')
    assert json.loads(art.read_text())["rows"] == [1, 2, 3]


def case_promote_capture_full_claims_done_marker(sh, tmp_path):
    raw = tmp_path / "scaling_raw.log"
    _write(tmp_path / "scaling_raw.log.tmp", '{"point": 1}', FULL)
    r = sh(f'promote_capture sc "{raw}" "{tmp_path}/art.json"')
    assert r.returncode == 0, r.stderr
    assert raw.exists() and not (tmp_path / "scaling_raw.log.tmp").exists()
    assert json.loads((tmp_path / "art.json").read_text())["rows"] == [1, 2, 3]


def case_promote_capture_partial_keeps_done_marker_absent(sh, tmp_path):
    raw = tmp_path / "scaling_raw.log"
    _write(tmp_path / "scaling_raw.log.tmp", PARTIAL)
    sh(f'promote_capture sc "{raw}" "{tmp_path}/art.json"')
    assert not raw.exists()
    assert (tmp_path / "scaling_raw.log.partial").exists()
    assert json.loads((tmp_path / "art.json").read_text())["rows"] == [1]
    _write(tmp_path / "scaling_raw.log.tmp", FULL)
    sh(f'promote_capture sc "{raw}" "{tmp_path}/art.json"')
    assert raw.exists()
    got = json.loads((tmp_path / "art.json").read_text())
    assert "partial" not in got and got["rows"] == [1, 2, 3]


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_landing_case_on_both_libraries(case, tmp_path):
    trees = []
    for label, lib in (("port", PORT_LIB), ("reference", REF_LIB)):
        box = tmp_path / label
        box.mkdir()
        case(_Shell(lib, box), box)
        trees.append(_tree(box))
    assert trees[0] == trees[1]
    assert len(CASES) == 9


def test_the_port_sources_its_own_copy():
    from csmom_tpu_torch.cli import rehearse

    assert rehearse._CAPTURE_LIB == PORT_LIB
    with open(PORT_LIB) as f:
        text = f.read()
    assert "benchmarks/" not in text
    for fn in ("_measured_rows()", "land_artifact()", "promote_capture()"):
        assert fn in text
