"""Fault plans: seeded, serializable descriptions of what to break where.

Counterpart of ``csmom_tpu.chaos.plan``, copied.  A plan is a list of
:class:`Fault` objects, each bound to a named checkpoint
(:func:`csmom_tpu_torch.chaos.inject.checkpoint` call sites).  Plans
serialize to TOML and arm through the ``CSMOM_FAULT_PLAN`` environment
variable, a path to a ``.toml`` file or the TOML text itself (anything
containing a newline or ``[[fault]]``), so one assignment arms a whole
process tree.

``seed`` drives every randomized choice a fault makes through
``random.Random``, so a plan reproduces the same damage byte for byte.
Hit counting is per process; cross-process scoping uses ``role``.

TOML shape::

    name = "crash-one-batch"
    seed = 1

    [[fault]]
    point = "serve.dispatch"    # checkpoint name (fnmatch pattern ok)
    action = "fail"             # see Fault.ACTIONS
    role = "any"                # supervisor | child | warmup | any
    after = 0                   # skip this many matching hits first
    max_fires = 1               # fire at most this many times (0 = every)
    # action-specific keys: seconds, path, bytes, code, errno, text
"""

from __future__ import annotations

import dataclasses
import os
from fnmatch import fnmatch

__all__ = ["Fault", "FaultPlan", "load_active_plan", "PLAN_ENV"]

PLAN_ENV = "CSMOM_FAULT_PLAN"

# The plan-point vocabulary, the reference's whole set, so that a plan
# written for it loads here.  The port's call sites are the serve.*
# points of the queue, the cache, the batcher and the service.
KNOWN_POINTS = (
    "bench.probe", "bench.compile", "bench.row", "bench.finish",
    "bench.land",
    "warmup.entry", "aot.compile",
    "mini.start", "mini.row", "mini.finish",
    "serve.admit", "serve.coalesce", "serve.dispatch", "serve.cache",
    "serve.transport",
    "pool.route", "pool.hedge", "pool.spawn",
    "stream.tick", "stream.ingest", "stream.serve",
)

_ROLES = ("any", "supervisor", "child", "warmup")


def _toml_module():
    try:
        import tomllib  # 3.11+ stdlib
    except ModuleNotFoundError:  # pragma: no cover - 3.10 image
        import tomli as tomllib
    return tomllib


def _toml_value(v) -> str:
    """One scalar as TOML source (bools are lowercase; strings escape via
    the JSON rules, which TOML basic strings share)."""
    import json

    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return json.dumps(v)
    return repr(v)


def current_role() -> str:
    """Which process of a capture tree this is, from
    ``CSMOM_BENCH_CHILD`` / ``CSMOM_BENCH_WARMUP``; any other process
    (a CLI run, the service) is the supervisor."""
    if os.environ.get("CSMOM_BENCH_WARMUP"):
        return "warmup"
    if os.environ.get("CSMOM_BENCH_CHILD"):
        return "child"
    return "supervisor"


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fault: fire ``action`` at the ``after+1``-th .. hit of ``point``.

    ``point`` is matched with :func:`fnmatch.fnmatch`, so
    ``point = "bench.*"`` hits every bench checkpoint.  ``max_fires = 0``
    means "every matching hit".
    """

    point: str
    action: str
    role: str = "any"
    after: int = 0
    max_fires: int = 1
    global_once: bool = False  # fire once across the whole PROCESS TREE
                               # (file-marker claim in CSMOM_FAULT_STATE):
                               # per-process counters cannot express
                               # that, a new process starts at 0
    # action parameters (unused ones stay at their defaults)
    seconds: float = 0.0     # sleep
    path: str = ""           # corrupt_file / truncate_file glob (env-expanded)
    bytes: int = 64          # truncate_file: size to keep
    code: int = 1            # exit: status
    errno_: int = 28         # raise_oserror: errno (default ENOSPC)
    text: str = "chaos"      # stdout_noise payload / fail reason

    ACTIONS = (
        "kill",           # SIGKILL this process, right now (external cap)
        "exit",           # os._exit(code) — a crash that skips cleanup
        "sleep",          # hang for `seconds` (a stall)
        "trip_deadline",  # fire the armed deadline guard immediately
        # lint: allow[clock-discipline] documents what the skew fault perturbs
        "clock_skew",     # jump time.time() by `seconds`; monotonic clocks
                          # must shield every deadline from this
        "corrupt_file",   # seeded byte-flips over files matching `path`
        "truncate_file",  # cut files matching `path` to `bytes` bytes
        "raise_oserror",  # raise OSError(errno_) at the checkpoint (ENOSPC)
        "stdout_noise",   # concurrent writer racing the trailing JSON line
        "fail",           # return "fail" for the caller to interpret
        # stream-replay tick faults: like "fail", these are
        # RESULT faults the caller interprets: the replay feed holds the
        # tick back (late/out-of-order arrival), re-offers it
        # (duplicate), or discards it (gap); "version_skew" makes a
        # serve probe answer from a stale panel snapshot, which the
        # service's version gate must refuse
        "tick_late",
        "tick_dup",
        "tick_drop",
        "version_skew",
        # serve result-cache fault, caller-interpreted at the
        # serve.cache checkpoint: the cache plants an entry under the
        # looked-up key stamped BELOW the version floor; the get path's
        # floor check must refuse it (stale_blocked), never serve it
        "cache_poison",
        # network faults, caller-interpreted at the
        # serve.transport checkpoint (serve/proto.py): "conn_reset"
        # raises a connection reset into the dispatcher's failover
        # handling, "net_delay" stalls the transport by
        # CSMOM_CHAOS_NET_DELAY_S (an induced straggler for the hedging
        # policy to route around), and "partition" cuts the firing
        # process off from the peer address for CSMOM_CHAOS_PARTITION_S.
        # On persistent channels a partition SEVERS every live
        # channel to the peer — in-flight requests reason-close into
        # failover, not just new dials refused — until it heals
        "conn_reset",
        "net_delay",
        "partition",
    )

    def validate(self) -> None:
        if self.action not in self.ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r} (expected one of "
                f"{', '.join(self.ACTIONS)})"
            )
        if self.role not in _ROLES:
            raise ValueError(
                f"unknown fault role {self.role!r} (expected one of "
                f"{', '.join(_ROLES)})"
            )
        if self.after < 0 or self.max_fires < 0:
            raise ValueError("after/max_fires must be >= 0")

    def matches(self, point: str, hit_index: int, role: str) -> bool:
        """Does this fault fire for the ``hit_index``-th (0-based) matching
        visit of ``point`` in a process with ``role``?"""
        if self.role not in ("any", role):
            return False
        if not fnmatch(point, self.point):
            return False
        if hit_index < self.after:
            return False
        if self.max_fires and hit_index >= self.after + self.max_fires:
            return False
        return True

    def to_toml(self) -> str:
        lines = ["[[fault]]",
                 f"point = {_toml_value(self.point)}",
                 f"action = {_toml_value(self.action)}"]
        defaults = Fault(point="", action="kill")
        for f in dataclasses.fields(self):
            if f.name in ("point", "action"):
                continue
            v = getattr(self, f.name)
            if v != getattr(defaults, f.name):
                key = "errno" if f.name == "errno_" else f.name
                lines.append(f"{key} = {_toml_value(v)}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A named, seeded set of faults (the unit a rehearsal runs)."""

    name: str
    faults: tuple
    seed: int = 0

    def validate(self) -> None:
        if not self.name:
            raise ValueError("fault plan needs a name")
        for f in self.faults:
            f.validate()

    def to_toml(self) -> str:
        head = f'name = "{self.name}"\nseed = {self.seed}\n'
        return head + "\n" + "\n\n".join(f.to_toml() for f in self.faults) + "\n"

    @classmethod
    def from_toml(cls, text: str) -> "FaultPlan":
        raw = _toml_module().loads(text)
        known = {f.name for f in dataclasses.fields(Fault)} | {"errno"}
        faults = []
        for i, entry in enumerate(raw.get("fault", [])):
            bad = set(entry) - known
            if bad:
                raise ValueError(
                    f"fault #{i}: unknown keys {sorted(bad)} (a typo'd "
                    "fault key must not silently become a no-op)"
                )
            if "errno" in entry:
                entry = dict(entry, errno_=entry.pop("errno"))
            faults.append(Fault(**entry))
        plan = cls(
            name=str(raw.get("name", "")),
            seed=int(raw.get("seed", 0)),
            faults=tuple(faults),
        )
        plan.validate()
        return plan

    @classmethod
    def from_env_value(cls, value: str) -> "FaultPlan":
        """Resolve the ``CSMOM_FAULT_PLAN`` value: a path unless it looks
        like inline TOML (contains a newline or a ``[[fault]]`` table)."""
        if "\n" in value or "[[fault]]" in value:
            return cls.from_toml(value)
        with open(value) as f:
            return cls.from_toml(f.read())


def load_active_plan() -> "FaultPlan | None":
    """The armed plan, or None.  Raises loudly on an unparseable plan — a
    rehearsal that silently ran fault-free would certify nothing."""
    value = os.environ.get(PLAN_ENV, "")
    if not value:
        return None
    return FaultPlan.from_env_value(value)
