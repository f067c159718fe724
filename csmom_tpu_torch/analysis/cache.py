"""Incremental sweep cache.

Counterpart of :mod:`csmom_tpu.analysis.cache`.  It remembers, per
file, everything a sweep needs to skip the parse:

- the file's **content blake2b** (the key: a byte-identical file gets
  byte-identical findings);
- the **raw findings** the file-scope rules reported, before pragmas,
  so a replay routes them through the live pragma machinery;
- the file's **pragmas** (rule, line, standalone-ness);
- per-rule **facts**: the cross-file state a rule mines from one file
  (enumeration-drift's checkpoint call sites), absorbed again on replay.

Project-scope results are keyed by the blake2b of the sorted per-file
digest set: any one file changing invalidates the whole project entry.
Rules that read runtime state (compile-surface's registry check) declare
``cacheable = False`` and always run live.  Every key also folds in the
``analysis/`` package's own sources and the active rule ids, so editing
a rule invalidates its cached verdicts.

Storage is one JSON file, ``build/csmom_tpu_torch/lint_cache/sweep.json``
under the scanned repo root (gitignored; ``--no-cache`` bypasses it), a
file of its own, so this sweep and the reference's never read or rewrite
each other's.  Writes are atomic (tmp + rename), and a damaged or alien
cache file reads as empty: the cache only ever changes the sweep's
speed.
"""

from __future__ import annotations

import hashlib
import json
import os

__all__ = ["CACHE_SUBDIR", "SweepCache", "content_digest"]

# the cache's directory under the repo root
CACHE_SUBDIR = ("build", "csmom_tpu_torch", "lint_cache")

_FORMAT = 2

# how many differently-keyed entries coexist per file / for the project
# slot: enough for the sweep mixes one tree realistically runs (the full
# gate, a --rule filter or two), small enough that the cache file stays
# bounded
_SIGS_PER_FILE = 4
_PROJECT_SLOTS = 4


def content_digest(src: bytes | str) -> str:
    if isinstance(src, str):
        src = src.encode("utf-8")
    return hashlib.blake2b(src, digest_size=16).hexdigest()


def _analysis_signature(rule_ids, salts=(), extra_sources=()) -> str:
    """blake2b over the active rule ids, their runtime cache salts
    (``LintRule.cache_salt`` — e.g. the checkpoint vocabulary the
    enumeration-drift verdicts depend on), the analysis package's own
    sources, AND any out-of-package rule sources (plugin rules
    registered through the kind-``lint`` registry path) — a rule edit,
    a different rule mix, or a changed runtime input is a different
    sweep."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(sorted(rule_ids)).encode("utf-8"))
    h.update(repr(sorted(salts)).encode("utf-8"))
    pkg = os.path.dirname(os.path.abspath(__file__))
    own = [os.path.join(pkg, name) for name in sorted(os.listdir(pkg))
           if name.endswith(".py")]
    for path in own + sorted(extra_sources):
        try:
            with open(path, "rb") as f:
                h.update(f.read())
        except OSError:  # pragma: no cover - unreadable rule source
            pass
    return h.hexdigest()


def _finding_rec(e) -> bool:
    return (isinstance(e, dict) and isinstance(e.get("rule"), str)
            and isinstance(e.get("line"), int)
            and isinstance(e.get("message"), str)
            and isinstance(e.get("chain", []), list)
            and isinstance(e.get("rel", ""), str))


def _pragma_rec(p) -> bool:
    return (isinstance(p, dict) and isinstance(p.get("rule"), str)
            and isinstance(p.get("line"), int))


def _file_entry(e) -> bool:
    return (isinstance(e, dict) and isinstance(e.get("digest"), str)
            and isinstance(e.get("raw"), list)
            and all(_finding_rec(r) for r in e["raw"])
            and isinstance(e.get("pragmas"), list)
            and all(_pragma_rec(p) for p in e["pragmas"])
            and isinstance(e.get("facts"), dict)
            and all(isinstance(k, str) for k in e["facts"]))


def _sane(data) -> bool:
    """True when *data* is structurally a cache this code could have
    written.  The format marker alone is not enough: a truncated or
    hand-edited file (or a future version reusing the marker) must read
    as COLD, never crash a replay — the cache may only ever change the
    sweep's speed."""
    if not (isinstance(data, dict) and data.get("format") == _FORMAT
            and isinstance(data.get("files"), dict)
            and isinstance(data.get("project", {}), dict)):
        return False
    for rel, sigs in data["files"].items():
        if not (isinstance(rel, str) and isinstance(sigs, dict)
                and all(isinstance(s, str) and _file_entry(e)
                        for s, e in sigs.items())):
            return False
    for key, rules in data.get("project", {}).items():
        if not (isinstance(key, str) and isinstance(rules, dict)
                and all(isinstance(rid, str) and isinstance(lst, list)
                        and all(_finding_rec(e) for e in lst)
                        for rid, lst in rules.items())):
            return False
    return True


class SweepCache:
    """One repo's sweep cache: load once, query per file, save once."""

    def __init__(self, repo: str, rule_ids, directory: str | None = None,
                 salts=(), extra_sources=()):
        self.dir = directory or os.path.join(repo, *CACHE_SUBDIR)
        self.path = os.path.join(self.dir, "sweep.json")
        self.sig = _analysis_signature(rule_ids, salts, extra_sources)
        self.hits = 0
        self.misses = 0
        self.project_hit = False
        self._dirty = False
        self._data = {"format": _FORMAT, "files": {}, "project": {}}
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
            if _sane(data):
                self._data = data
                self._data.setdefault("project", {})
        except (OSError, ValueError):
            pass    # cold, damaged, or alien: start empty

    # ------------------------------------------------------------ per-file

    # entries live per (rel, rule-set signature): a ``--rule`` filtered
    # sweep and the full tier-1 gate coexist in one warm cache instead
    # of evicting each other on every alternation

    def lookup(self, rel: str, digest: str) -> dict | None:
        entry = (self._data["files"].get(rel) or {}).get(self.sig)
        if isinstance(entry, dict) and entry.get("digest") == digest:
            self.hits += 1
            return entry
        self.misses += 1
        return None

    def store(self, rel: str, digest: str, raw: list, pragmas: list,
              facts: dict) -> None:
        sigs = self._data["files"].setdefault(rel, {})
        sigs.pop(self.sig, None)        # re-insert last = newest
        sigs[self.sig] = {"digest": digest, "raw": raw,
                          "pragmas": pragmas, "facts": facts}
        while len(sigs) > _SIGS_PER_FILE:
            sigs.pop(next(iter(sigs)))
        self._dirty = True

    # ------------------------------------------------------------- project

    def project_key(self, digests, rule_ids=()) -> str:
        h = hashlib.blake2b(digest_size=16)
        h.update(self.sig.encode("utf-8"))
        h.update(repr(sorted(rule_ids)).encode("utf-8"))
        for rel, digest in sorted(digests):
            h.update(f"{rel}\0{digest}\n".encode("utf-8"))
        return h.hexdigest()

    def lookup_project(self, key: str) -> dict | None:
        entry = (self._data.get("project") or {}).get(key)
        if isinstance(entry, dict):
            self.project_hit = True
            return entry
        return None

    def store_project(self, key: str, rules: dict) -> None:
        slots = self._data.setdefault("project", {})
        slots.pop(key, None)
        slots[key] = rules
        while len(slots) > _PROJECT_SLOTS:
            slots.pop(next(iter(slots)))
        self._dirty = True

    # ---------------------------------------------------------------- save

    def save(self) -> None:
        if not self._dirty:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self._data, f)
            os.replace(tmp, self.path)
        except OSError:  # pragma: no cover - read-only checkout
            pass         # a cache that cannot persist is just cold

    def stats(self) -> dict:
        return {"enabled": True, "hits": self.hits,
                "misses": self.misses, "project_hit": self.project_hit}
