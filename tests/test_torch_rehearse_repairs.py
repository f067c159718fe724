"""The repairs ``rehearse`` needed, each pinned on the CPU.

- ``PoolSupervisor.extra_env``: merged last into every spawned process's
  environment, as the reference's (the router tier's supervisor too).
- The kernel-library self-heal in ``ops/build.py``: a library whose
  content digest is missing or does not match is evicted and rebuilt,
  never loaded; a second failure raises; a good library is never
  rebuilt; the warm-up's record carries ``self_healed``.  This machine has
  no ``nvcc``: a stub compiler writes a fixed byte file, bytes are flipped
  with the port's own ``corrupt_file`` chaos action, and ``ctypes.CDLL``
  is stubbed (the file is not a real library).
- ``CSMOM_JIT_CACHE`` as the build directory, read by every module that
  builds into it or reads from it; unset, empty or ``0`` keeps
  ``build/csmom_tpu_torch/``.
"""

import os
import subprocess
import sys

import pytest

from csmom_tpu.serve import supervisor as ref_supervisor
from csmom_tpu_torch.chaos import inject
from csmom_tpu_torch.ops import build
from csmom_tpu_torch.serve import fabric, health, supervisor

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GOOD = b"\x7fELF fixed library bytes " * 64
_EXTRA = {"CSMOM_REHEARSE_PROBE": "router-tier-only", "CSMOM_FAULT_STATE": "/x"}


# -------------------------------------------------------------- extra_env ---

def _sup(module, tmp_path, sub):
    cfg = module.PoolConfig(n_workers=1, profile="serve-smoke", engine="stub",
                            ready_timeout_s=30.0)
    return module.PoolSupervisor(cfg, str(tmp_path / sub))


def test_extra_env_is_merged_last_as_in_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("CSMOM_FAULT_STATE", "/inherited")
    mine, theirs = _sup(supervisor, tmp_path, "p"), _sup(ref_supervisor,
                                                          tmp_path, "r")
    assert mine.extra_env == theirs.extra_env == {}
    assert mine._spawn_env()["CSMOM_FAULT_STATE"] == "/inherited"
    mine.extra_env.update(_EXTRA)
    theirs.extra_env.update(_EXTRA)
    got, want = mine._spawn_env(), theirs._spawn_env()
    assert {k: got[k] for k in _EXTRA} == {k: want[k] for k in _EXTRA} == _EXTRA
    assert got["PYTHONPATH"] == want["PYTHONPATH"]
    assert "CSMOM_REHEARSE_PROBE" not in os.environ
    # the router tier's supervisor is the same machinery
    rsup = fabric.RouterSupervisor(
        supervisor.PoolConfig(n_workers=1, profile="serve-smoke",
                              engine="stub"),
        str(tmp_path / "routers"), str(tmp_path / "routes.json"))
    rsup.extra_env["CSMOM_REHEARSE_PROBE"] = "r"
    assert rsup._spawn_env()["CSMOM_REHEARSE_PROBE"] == "r"


def _environ_of(pid):
    with open(f"/proc/{pid}/environ", "rb") as f:
        pairs = (item.split(b"=", 1) for item in f.read().split(b"\0") if item)
    return {k.decode(): v.decode() for k, v in pairs}


@pytest.mark.parametrize("module", [supervisor, ref_supervisor],
                         ids=["port", "reference"])
def test_extra_env_reaches_a_spawned_stub_worker(tmp_path, module):
    sup = _sup(module, tmp_path, "pool")
    sup.extra_env.update(_EXTRA)
    try:
        sup.start()
        (h,) = sup.handles
        env = _environ_of(h.proc.pid)
        assert {k: env[k] for k in _EXTRA} == _EXTRA
    finally:
        sup.stop()
    assert h.proc.poll() is not None


# ------------------------------------------------------- build directory ---

@pytest.mark.parametrize("value", [None, "", "0"])
def test_unset_empty_or_zero_keeps_the_default_build_dir(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(build.CACHE_ENV, raising=False)
    else:
        monkeypatch.setenv(build.CACHE_ENV, value)
    assert build.build_dir() == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "csmom_tpu_torch")


def test_csmom_jit_cache_redirects_every_build_path(tmp_path, monkeypatch):
    from csmom_tpu_torch import native
    from csmom_tpu_torch.compile import aot

    box = tmp_path / "jit-cache"
    monkeypatch.setenv(build.CACHE_ENV, str(box))
    assert build.build_dir() == box
    for name in build.KERNELS:
        assert build.library_path(name).parent == box
    assert native.library_path().parent == box
    assert aot.report_dir("rehearse") == str(box / "warmup" / "rehearse")
    ready, reason = health.cache_readiness()
    assert not ready and str(box) in reason
    # a relative path is taken from the working directory it is read in
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(build.CACHE_ENV, "rel")
    assert build.build_dir() == tmp_path / "rel"


@pytest.mark.parametrize("sweep", ["k1_sweep", "k2_sweep"])
def test_the_kernel_sweeps_build_under_the_build_dir(tmp_path, monkeypatch,
                                                     sweep):
    import importlib

    mod = importlib.import_module(f"csmom_tpu_torch.{sweep}")
    monkeypatch.setenv(build.CACHE_ENV, str(tmp_path))

    class Seen(Exception):
        pass

    def capture(name, variants, out_dir):
        raise Seen(out_dir)

    monkeypatch.setattr(mod, "build_variants", capture)
    with pytest.raises(Seen) as e:
        mod.sweep()
    assert e.value.args[0] == tmp_path / sweep


# -------------------------------------------------------------- self-heal ---

class _Nvcc:
    """A stand-in for ``nvcc``'s process: writes fixed bytes to its -o."""

    runs = []

    def __init__(self, cmd, **kw):
        self.out = cmd[cmd.index("-o") + 1]
        self.returncode = 0

    def communicate(self):
        with open(self.out, "wb") as f:
            f.write(_GOOD)
        _Nvcc.runs.append(self.out)
        return "stub nvcc: ptxas info", None


class _Lib:
    def __init__(self, path):
        with open(path, "rb") as f:
            self.loaded = f.read()
        self.csmom_error_string = lambda code: b""


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    monkeypatch.setenv(build.CACHE_ENV, str(tmp_path / "jit-cache"))
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _Nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", _Lib)
    monkeypatch.setattr(build, "_LIBS", {})
    _Nvcc.runs = []
    return tmp_path / "jit-cache"


def _fresh_process(monkeypatch):
    """What a new process sees: no library loaded yet."""
    monkeypatch.setattr(build, "_LIBS", {})


def _corrupt_every_file(monkeypatch, tmp_path):
    """Arm the corrupt-aot-cache fault and pass its checkpoint."""
    plan = tmp_path / "plan.toml"
    plan.write_text('name = "corrupt"\nseed = 15\n\n[[fault]]\n'
                    'point = "warmup.entry"\naction = "corrupt_file"\n'
                    'path = "$CSMOM_JIT_CACHE/*"\n')
    monkeypatch.setenv("CSMOM_FAULT_PLAN", str(plan))
    monkeypatch.setenv("CSMOM_FAULT_STATE", str(tmp_path / "state"))
    inject.reset()
    try:
        inject.checkpoint("warmup.entry", entry="x")
    finally:
        monkeypatch.delenv("CSMOM_FAULT_PLAN")
        inject.reset()


def test_build_writes_the_librarys_digest_beside_it(stub_build):
    name = "decile_partial_sums"
    assert set(build.build((name,))) == {name}
    lib = build.library_path(name)
    assert lib.read_bytes() == _GOOD
    assert build.digest_path(lib).name == lib.name + ".sha256"
    assert build.intact(lib)
    assert sorted(p.name for p in stub_build.iterdir()) == [
        lib.name, lib.name + ".sha256"]


def test_a_corrupt_library_is_evicted_rebuilt_and_never_loaded(
        stub_build, tmp_path, monkeypatch):
    name = "decile_partial_sums"
    build.load(name)                       # pass 1: built and loaded
    lib = build.library_path(name)
    assert len(_Nvcc.runs) == 1 and build.libraries_healed() == []
    healed0, built0 = len(build.libraries_healed()), build.libraries_built()
    _corrupt_every_file(monkeypatch, tmp_path)
    assert lib.read_bytes() != _GOOD and not build.intact(lib)
    _fresh_process(monkeypatch)
    loaded = build.load(name)              # pass 2: healed
    assert loaded.loaded == _GOOD          # the corrupt bytes never mapped
    assert build.libraries_healed()[healed0:] == [name]
    assert build.libraries_built() - built0 == 1 and len(_Nvcc.runs) == 2
    assert build.intact(lib)


def test_a_missing_or_unreadable_digest_counts_as_corruption(stub_build,
                                                             monkeypatch):
    name = "cohort_partial_sums"
    build.build((name,))
    lib = build.library_path(name)
    build.digest_path(lib).unlink()
    healed0 = len(build.libraries_healed())
    assert build.load(name).loaded == _GOOD
    assert build.libraries_healed()[healed0:] == [name]
    build.digest_path(lib).write_bytes(b"\xff\xfe not text")
    _fresh_process(monkeypatch)
    build.load(name)
    assert build.libraries_healed()[healed0:] == [name, name]


def test_a_good_library_is_never_rebuilt(stub_build, monkeypatch):
    name = "decile_partial_sums"
    build.load(name)
    healed0, built0 = len(build.libraries_healed()), build.libraries_built()
    for _ in range(3):
        _fresh_process(monkeypatch)
        assert build.load(name).loaded == _GOOD
    assert build.libraries_built() == built0 and len(_Nvcc.runs) == 1
    assert len(build.libraries_healed()) == healed0


def test_a_check_that_passes_when_made_again_evicts_nothing(stub_build,
                                                            monkeypatch):
    """A reader that finds the library between another process's two
    os.replace calls sees a mismatch once: the second read decides."""
    name = "decile_partial_sums"
    build.build((name,))
    lib = build.library_path(name)
    mtime = lib.stat().st_mtime_ns
    reads = []
    real = build.intact

    def once_torn(path):
        reads.append(path)
        return len(reads) > 1 and real(path)

    monkeypatch.setattr(build, "intact", once_torn)
    healed0 = len(build.libraries_healed())
    build.load(name)
    assert len(reads) == 2 and len(_Nvcc.runs) == 1
    assert lib.stat().st_mtime_ns == mtime
    assert len(build.libraries_healed()) == healed0


def test_a_second_failure_after_the_rebuild_raises(stub_build, monkeypatch):
    monkeypatch.setattr(build, "intact", lambda path: False)
    healed0 = len(build.libraries_healed())
    with pytest.raises(RuntimeError, match="fails its digest check") as e:
        build.load("decile_partial_sums")
    assert "stub nvcc: ptxas info" in str(e.value)
    assert "decile_partial_sums" not in build._LIBS
    assert len(build.libraries_healed()) == healed0


def test_a_failing_rebuild_raises_with_the_compilers_output(stub_build,
                                                            monkeypatch):
    name = "decile_partial_sums"
    build.build((name,))
    build.digest_path(build.library_path(name)).unlink()

    class Broken(_Nvcc):
        def communicate(self):
            self.returncode = 1
            return "error: stub nvcc refused", None

    monkeypatch.setattr(subprocess, "Popen", Broken)
    with pytest.raises(RuntimeError, match="stub nvcc refused"):
        build.load(name)


def test_warmup_records_the_heal(monkeypatch):
    """An entry whose libraries were healed while it warmed is recorded
    ``self_healed`` (the reference's string) with ``cache_hit`` false, and
    the report counts such entries."""
    from csmom_tpu_torch.compile import aot

    heals = []

    def healing():
        heals.append("decile_partial_sums")
        return list(heals)

    monkeypatch.setattr(build, "libraries_healed", healing)
    rep = aot.warmup(profiles=("smoke",), include_golden_event=False,
                     write_report=False, device="cpu")
    assert rep["n_errors"] == 0 and rep["n_entries"] > 0
    assert rep["n_self_healed"] == rep["n_entries"]
    assert rep["n_cache_hits"] == 0
    for e in rep["entries"]:
        assert e["cache_hit"] is False
        assert e["self_healed"] == ("corrupt cache entry evicted and "
                                    "recompiled cold")


def test_a_subprocess_sees_the_sandboxed_build_dir(tmp_path):
    """The warm-up scenario's processes take the directory from the
    environment they are given, not from the checkout."""
    code = ("from csmom_tpu_torch.ops import build; "
            "print(build.library_path('decile_partial_sums').parent)")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=60, check=True, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": _REPO,
             "CSMOM_JIT_CACHE": str(tmp_path / "box")}).stdout.strip()
    assert out == str(tmp_path / "box")
