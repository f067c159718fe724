"""CI-backed regression verdicts over raw repeat samples.

Counterpart of :mod:`csmom_tpu.obs.regress`.  A "run B is slower than
run A" claim from one wall-clock sample each is the unquantified kind of
claim the paper's Newey-West t-stats exist to prevent, so a leg's repeat
samples get the treatment the monthly spreads get, through the port's
own inference code (:func:`csmom_tpu_torch.analytics.bootstrap.
block_bootstrap`): a circular block bootstrap of the mean (blocks,
because consecutive timing reps share thermal and cache state the way
consecutive months share autocorrelation), percentile CIs, and an
interval-overlap test between the candidate and reference runs.

Verdict vocabulary (what :mod:`csmom_tpu_torch.cli.ledger` prints and
gates on):

``regression``
    Confirmed: both runs carry enough raw samples, the bootstrap CIs are
    disjoint in the bad direction, and the point change exceeds
    ``min_rel``.  The only sample-based verdict that fails the gate.
``improvement``
    The mirror image: disjoint CIs in the good direction.
``no-change``
    Overlapping CIs, or a change smaller than ``min_rel``.  Noise never
    fails a gate.
``suspect``
    Point values moved past ``suspect_rel`` but at least one side has no
    (or too few) raw samples, so no CI can back the claim.  Reported,
    never gate-failing.
``point-delta``
    Below the change threshold without CI backing.
``memory-growth`` / ``memory-shrink``
    The deterministic axis: memory bytes are exact per (shape, backend),
    so a tolerance band replaces the bootstrap.

Only :func:`bootstrap_mean_ci` touches torch, lazily; it runs where
``device=`` says, the card when ``None`` (raising without one), in f64
with 64-bit resample draws.  Everything else is plain Python, so the
ledger CLI imports without torch.
"""

from __future__ import annotations

__all__ = [
    "bootstrap_mean_ci",
    "compare",
    "compare_memory",
    "compare_points",
    "compare_samples",
    "default_block_len",
    "GATE_FAILING",
    "MIN_SAMPLES",
]

# sample-count floor for a CI to mean anything: below this the bootstrap
# quantiles are dominated by the handful of distinct resample means
MIN_SAMPLES = 5

# verdicts that fail `ledger gate`
GATE_FAILING = ("regression", "memory-growth")

# the single source for the verdict thresholds: the function defaults and
# the CLI's --min-rel/--suspect-rel/--mem-tol defaults read these
DEFAULT_MIN_REL = 0.05      # practical-significance floor (CI verdicts)
DEFAULT_SUSPECT_REL = 0.10  # point-delta drift worth flagging
DEFAULT_MEM_TOL = 0.10      # tolerated relative memory growth


def default_block_len(n: int) -> int:
    """n^(1/3) block rule (the stationary-bootstrap rate), floored at 1:
    short enough that a 5-rep leg still mixes, long enough that
    back-to-back reps sharing cache state stay together."""
    return max(1, int(round(n ** (1.0 / 3.0))))


def bootstrap_mean_ci(samples, n_resamples: int = 1000,
                      block_len: int | None = None,
                      ci_level: float = 0.95, seed: int = 0,
                      device=None) -> dict:
    """Percentile CI of the mean of ``samples`` by the port's circular
    block bootstrap (every resample in one batched gather), on
    ``device`` (``None``: the card).

    The samples are f64 and the resample starts are drawn as int64 from
    ``random.PRNGKey(seed)``: the JAX package's draws with 64-bit types
    on.  Returns ``{"n", "point", "lo", "hi", "block_len",
    "n_resamples", "ci_level"}`` with plain floats.
    """
    import torch

    from csmom_tpu_torch import random
    from csmom_tpu_torch.analytics.bootstrap import block_bootstrap
    from csmom_tpu_torch.device import resolve_device

    xs = [float(s) for s in samples]
    if not xs:
        raise ValueError("bootstrap_mean_ci needs at least one sample")
    dev = resolve_device(device)
    bl = default_block_len(len(xs)) if block_len is None else block_len
    x = torch.tensor(xs, dtype=torch.float64, device=dev)
    res = block_bootstrap(
        x, torch.ones(len(xs), dtype=torch.bool, device=dev),
        random.PRNGKey(seed, device=dev), n_samples=n_resamples,
        block_len=bl, ci_level=ci_level, index_dtype=torch.int64,
    )
    lo, hi = (float(v) for v in res.mean_ci.cpu())
    return {
        "n": len(xs),
        "point": float(res.mean_point),
        "lo": lo,
        "hi": hi,
        "block_len": bl,
        "n_resamples": int(n_resamples),
        "ci_level": float(ci_level),
    }


def _rel_change(cand: float, ref: float) -> float:
    if ref == 0:
        return float("inf") if cand != ref else 0.0
    return (cand - ref) / abs(ref)


def _is_worse(rel: float, direction: str) -> bool:
    return rel > 0 if direction == "lower" else rel < 0


def compare_samples(cand_samples, ref_samples, direction: str = "lower",
                    min_rel: float = DEFAULT_MIN_REL, n_resamples: int = 1000,
                    ci_level: float = 0.95, seed: int = 0,
                    device=None) -> dict:
    """Sampled-vs-sampled verdict: bootstrap both means on ``device``,
    test CI overlap.

    ``direction`` is which way is better for this metric: ``"lower"``
    for walls and bytes, ``"higher"`` for throughput.  A regression is
    only confirmed when the intervals are disjoint in the bad direction
    and the point change exceeds ``min_rel``: both the statistical and
    the practical significance bar.
    """
    cand = bootstrap_mean_ci(cand_samples, n_resamples=n_resamples,
                             ci_level=ci_level, seed=seed, device=device)
    ref = bootstrap_mean_ci(ref_samples, n_resamples=n_resamples,
                            ci_level=ci_level, seed=seed + 1, device=device)
    rel = _rel_change(cand["point"], ref["point"])
    if direction == "lower":
        cand_worse_disjoint = cand["lo"] > ref["hi"]
        cand_better_disjoint = cand["hi"] < ref["lo"]
    else:
        cand_worse_disjoint = cand["hi"] < ref["lo"]
        cand_better_disjoint = cand["lo"] > ref["hi"]
    if cand_worse_disjoint and abs(rel) >= min_rel:
        verdict = "regression"
    elif cand_better_disjoint and abs(rel) >= min_rel:
        verdict = "improvement"
    else:
        verdict = "no-change"
    return {
        "verdict": verdict,
        "basis": "bootstrap-ci",
        "rel_change": rel,
        "worse": _is_worse(rel, direction),
        "direction": direction,
        "candidate": cand,
        "reference": ref,
    }


def compare_points(cand_value: float, ref_value: float,
                   direction: str = "lower",
                   suspect_rel: float = DEFAULT_SUSPECT_REL,
                   reason: str = "no raw samples",
                   n_cand: int = 1, n_ref: int = 1) -> dict:
    """Point-vs-point comparison: delta only, never a confirmed verdict.

    Without enough repeat samples there is no interval, so the worst
    this can say is ``suspect``: an invitation to re-measure, not a gate
    failure.  ``n_cand``/``n_ref`` report each side's true raw-sample
    count (a bare aggregate counts as 1) so the run that is actually
    short is the one re-measured."""
    rel = _rel_change(cand_value, ref_value)
    worse = _is_worse(rel, direction)
    verdict = "suspect" if worse and abs(rel) >= suspect_rel else "point-delta"
    return {
        "verdict": verdict,
        "basis": f"point-delta ({reason}: CI not computable)",
        "rel_change": rel,
        "worse": worse,
        "direction": direction,
        "candidate": {"point": float(cand_value), "n": max(n_cand, 1)},
        "reference": {"point": float(ref_value), "n": max(n_ref, 1)},
    }


def compare_memory(cand_bytes: int, ref_bytes: int,
                   tol_rel: float = DEFAULT_MEM_TOL) -> dict:
    """Deterministic memory verdict: byte counts are exact per (shape,
    backend), so growth past the tolerance band is a confirmed
    ``memory-growth`` with no bootstrap.  A changed workload or platform
    changes the ledger key instead; only an unexplained growth (same
    shape, same backend, more bytes) fails."""
    rel = _rel_change(float(cand_bytes), float(ref_bytes))
    if rel > tol_rel:
        verdict = "memory-growth"
    elif rel < -tol_rel:
        verdict = "memory-shrink"
    else:
        verdict = "no-change"
    return {
        "verdict": verdict,
        "basis": f"exact-bytes (tolerance ±{tol_rel:.0%})",
        "rel_change": rel,
        "worse": rel > tol_rel,
        "direction": "lower",
        "candidate": {"point": float(cand_bytes), "n": 1},
        "reference": {"point": float(ref_bytes), "n": 1},
    }


def compare(cand_value, ref_value, cand_samples=None, ref_samples=None,
            direction: str = "lower", min_rel: float = DEFAULT_MIN_REL,
            suspect_rel: float = DEFAULT_SUSPECT_REL,
            min_samples: int = MIN_SAMPLES, n_resamples: int = 1000,
            seed: int = 0, device=None) -> dict:
    """Dispatch: the CI comparison on ``device`` when both sides carry
    enough raw samples, an honest point delta otherwise (with the reason
    in ``basis``)."""
    n_c = len(cand_samples) if cand_samples else 0
    n_r = len(ref_samples) if ref_samples else 0
    if n_c >= min_samples and n_r >= min_samples:
        return compare_samples(cand_samples, ref_samples,
                               direction=direction, min_rel=min_rel,
                               n_resamples=n_resamples, seed=seed,
                               device=device)
    if n_c or n_r:
        # name each side's count: the run to re-measure is the one that
        # is actually short, not the one that happens to be newer
        reason = (f"candidate has {n_c} raw sample(s), reference has "
                  f"{n_r} (< {min_samples} floor on at least one side)")
    else:
        reason = "no raw samples on either side"
    return compare_points(cand_value, ref_value, direction=direction,
                          suspect_rel=suspect_rel, reason=reason,
                          n_cand=n_c, n_ref=n_r)
