"""Incremental momentum/turnover: O(assets) per bar, exact by construction.

Counterpart of ``csmom_tpu.stream.incremental``, copied (numpy only).
The batch engines (:mod:`csmom_tpu_torch.signals.momentum`,
:mod:`csmom_tpu_torch.signals.turnover`) recompute a full ``[A, T]``
panel per call; a live stream closes one bar at a time.  These updaters
carry exactly the running state the last-column signal needs (forward
filled prices, validity counts, cumulative turnover sums) and advance it
in O(A) per closed bar.

**Exactness is the contract, not a tolerance.**  Every arithmetic step
reproduces the full recompute operation for operation (same divides,
same selects, same accumulation order), so the incremental output after
any interleaving of in-order ticks equals the numpy mirrors below bit
for bit, in float32 and float64.  Late merges rewrite history, which
running sums cannot absorb exactly: the updater goes ``dirty`` and
rebuilds from the next snapshot instead of patching.  Integer counts
use add/subtract running sums (exact); the float turnover cumsum is
append-only in the same order as ``np.cumsum``.

**Reconciliation** is the safety net the replay harness runs
periodically: recompute the full panel through the mirror, compare bit
for bit, and on any drift rebuild from scratch and count the event.
The mirrors are held against the port's engines in the tests: the
momentum mirror equals :func:`csmom_tpu_torch.signals.momentum.momentum`
bit for bit on the CPU (the same elementwise IEEE operations), the
turnover mirror equals :func:`csmom_tpu_torch.signals.turnover.
turnover_features` within float-association tolerance (torch's cumsum
may associate differently from a sequential sum).

Time discipline: event time only; this module reads no clock.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "IncrementalMomentum",
    "IncrementalTurnover",
    "full_momentum_np",
    "full_turnover_np",
    "nan_equal",
]

TRADING_DAYS_PER_MONTH = 21.0  # signals.turnover's constant


# ----------------------------------------------------------- full mirrors --
#
# numpy transcriptions of the signal engines, operation for operation.
# They are the reconciliation references: sequential, deterministic, and
# (for momentum) bitwise-identical to the engines on the CPU because every
# step is an elementwise IEEE op with no reassociation freedom.

def _nan(dtype):
    return np.asarray(np.nan, dtype=dtype)


def padded_prices_np(prices: np.ndarray, mask: np.ndarray) -> tuple:
    """numpy mirror of :func:`signals.momentum.padded_prices`."""
    M = prices.shape[1]
    idx = np.arange(M)
    last = np.maximum.accumulate(np.where(mask, idx, -1), axis=1)
    seen = last >= 0
    filled = np.take_along_axis(
        np.where(mask, prices, _nan(prices.dtype)),
        np.clip(last, 0, M - 1), axis=1)
    return np.where(seen, filled, _nan(prices.dtype)), seen


def _ret_valid_np(prices: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Validity plane of :func:`signals.momentum.monthly_returns`."""
    filled, seen = padded_prices_np(prices, mask)
    prev = np.roll(filled, 1, axis=1)
    prev_seen = np.roll(seen, 1, axis=1)
    prev_seen[:, 0] = False
    with np.errstate(invalid="ignore"):
        return prev_seen & (prev != 0.0)


def full_momentum_np(prices: np.ndarray, mask: np.ndarray,
                     lookback: int = 12, skip: int = 1) -> tuple:
    """numpy mirror of :func:`signals.momentum.momentum` (full panel)."""
    prices = np.asarray(prices)
    mask = np.asarray(mask, bool)
    A, M = prices.shape
    ret_valid = _ret_valid_np(prices, mask)
    filled, _ = padded_prices_np(prices, mask)
    t = np.arange(M)
    hi = t - skip
    lo = t - skip - lookback
    in_range = lo >= 0
    bad = (~ret_valid).astype(np.int32)
    badc = np.concatenate(
        [np.zeros((A, 1), np.int32), np.cumsum(bad, axis=1)], axis=1)
    hi_c = np.clip(hi, 0, M - 1)
    lo_c = np.clip(lo + 1, 0, M - 1)
    window_bad = badc[:, hi_c + 1] - badc[:, lo_c]
    p_hi = filled[:, hi_c]
    p_lo = filled[:, np.clip(lo, 0, M - 1)]
    with np.errstate(invalid="ignore"):
        valid = in_range[None, :] & (window_bad == 0) & (p_lo != 0.0)
        one = np.asarray(1.0, dtype=prices.dtype)
        mom = np.where(
            valid, p_hi / np.where(valid, p_lo, one) - one,
            _nan(prices.dtype))
    return mom, valid


def full_turnover_np(volume: np.ndarray, vmask: np.ndarray,
                     shares: np.ndarray, lookback: int = 3) -> tuple:
    """numpy mirror of ``signals.turnover.turnover_features``'s
    ``turn_avg`` leg (adv -> turnover -> trailing NaN-skipping mean).

    The rolling mean uses SEQUENTIAL prefix sums (``np.cumsum``), which
    is the accumulation order the incremental updater reproduces exactly;
    the engine's cumsum may associate differently, so engine parity is a
    tolerance check, mirror parity is bitwise.
    """
    volume = np.asarray(volume)
    vmask = np.asarray(vmask, bool)
    dtype = volume.dtype
    so = np.asarray(shares, dtype=dtype)[:, None]
    with np.errstate(invalid="ignore"):
        adv = volume / np.asarray(TRADING_DAYS_PER_MONTH, dtype=dtype)
        so_ok = np.isfinite(so) & (so > 0)
        turn_valid = vmask & so_ok
        one = np.asarray(1.0, dtype=dtype)
        turn = np.where(turn_valid,
                        adv / np.where(so_ok, so, one), _nan(dtype))
        filled = np.where(turn_valid, np.nan_to_num(turn), 0.0).astype(dtype)
    A, M = filled.shape
    cs = np.concatenate(
        [np.zeros((A, 1), dtype), np.cumsum(filled, axis=1)], axis=1)
    cn = np.concatenate(
        [np.zeros((A, 1), dtype),
         np.cumsum(turn_valid.astype(dtype), axis=1)], axis=1)
    lo = np.maximum(np.arange(M) + 1 - lookback, 0)
    s = cs[:, 1:] - cs[:, lo]
    n = cn[:, 1:] - cn[:, lo]
    out_valid = n >= 1
    with np.errstate(invalid="ignore"):
        mean = s / np.maximum(n, one)
        out = np.where(out_valid, mean, _nan(dtype))
    return out, out_valid


def nan_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Bitwise-for-values equality with NaN == NaN (the reconciliation
    comparison: same dtype, same values, same NaN pattern)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(np.array_equal(a, b, equal_nan=True)))


# ------------------------------------------------------ incremental state --

class _UpdaterBase:
    """Shared consume/rebuild/reconcile plumbing.

    ``anchor`` is the global bar index the running prefix state is
    anchored at: 0 for a fresh updater, the snapshot's window start
    after any rebuild.  Reconciliation is only bitwise-comparable when
    the reference recompute shares that anchor — once the ring's window
    slides past it (bar count exceeds ring capacity), a window-anchored
    recompute legitimately differs from the live state: its forward
    fills start blind at the window edge and its float prefix sums
    carry no common prefix to cancel.  So reconcile re-anchors first
    (counted in ``reanchors``) and cross-checks the live state against
    the re-anchored one within a documented float-cancellation
    tolerance: real corruption still surfaces as drift, while anchor
    mismatch alone never does."""

    def __init__(self, n_assets: int, dtype):
        self.n_assets = int(n_assets)
        self.dtype = np.dtype(dtype)
        self.consumed = 0          # bars consumed (global index of next)
        self.anchor = 0            # global bar the prefix state starts at
        self.dirty = False         # a late merge rewrote consumed history
        self.rebuilds = 0
        self.reanchors = 0         # window slid past anchor at reconcile
        self.reconciliations = 0
        self.drift_events = 0

    def mark_dirty(self) -> None:
        """A consumed bar changed under us (late merge): running state no
        longer describes the panel — rebuild at the next sync point."""
        self.dirty = True

    # subclasses: _reset(), _consume(values_col, mask_col), _reference(snapshot)

    def update(self, values_col: np.ndarray, mask_col: np.ndarray) -> None:
        """Consume one closed bar column (O(A)).  Skipped while dirty —
        the pending rebuild replays everything exactly."""
        if self.dirty:
            self.consumed += 1  # the bar exists; rebuild will cover it
            return
        self._consume(np.asarray(values_col, self.dtype),
                      np.asarray(mask_col, bool))
        self.consumed += 1

    def sync(self, snapshot) -> None:
        """Bring state level with ``snapshot``: rebuild if dirty OR if
        the ring window has moved past the consumed frontier (bars were
        evicted unseen — the forward-fill carry would silently skip
        them), else consume any not-yet-consumed closed bars."""
        if self.dirty or snapshot.first_bar_index > self.consumed:
            self.rebuild(snapshot)
            return
        end = snapshot.first_bar_index + snapshot.n_bars
        v, m = self._snapshot_field(snapshot)
        for g in range(max(self.consumed, snapshot.first_bar_index), end):
            j = g - snapshot.first_bar_index
            self._consume(np.asarray(v[:, j], self.dtype), m[:, j])
            self.consumed = g + 1

    def rebuild(self, snapshot) -> None:
        """Replay the exact mirror recurrence over the snapshot window —
        the rebuild-from-scratch path late merges and detected drift
        both take.  Re-anchors the prefix state at the window start."""
        self._reset()
        self.anchor = snapshot.first_bar_index
        self.consumed = snapshot.first_bar_index
        self.dirty = False
        self.rebuilds += 1
        self.sync(snapshot)

    def _cross_atol(self) -> np.ndarray | float:
        """Per-asset absolute tolerance for the live-vs-re-anchored
        cross-check.  0.0 where the last-bar value depends only on
        in-window data (momentum: identical forward fills wherever the
        window recompute is valid, so bitwise); overridden where the
        state carries globally-anchored float prefix sums whose common
        prefix cancels only in exact arithmetic (turnover)."""
        return 0.0

    def reconcile(self, snapshot) -> dict:
        """Full-panel recompute vs the running state.  On drift: count
        it and rebuild from scratch.  Returns the verdict.

        Anchored case (window still starts at our anchor): bitwise, as
        ever.  Slid-window case: capture the live last-bar state, then
        REBUILD from the snapshot (a re-anchor, counted — not drift:
        the anchors differing is the ring doing its job) and compare
        (a) the re-anchored incremental recurrence against the
        vectorized mirror bitwise, and (b) the live state against the
        re-anchored one on lanes both call valid, within
        :meth:`_cross_atol` — (a) proves the recurrence, (b) catches
        real corruption of the long-running state."""
        self.sync(snapshot)
        self.reconciliations += 1
        reanchored = snapshot.first_bar_index != self.anchor
        live_val = live_ok = None
        atol = 0.0
        if reanchored:
            live_val, live_ok = self.current()
            atol = self._cross_atol()
            self.reanchors += 1
            self.rebuild(snapshot)
        ref_val, ref_ok = self._reference(snapshot)
        cur_val, cur_ok = self.current()
        drift = not (nan_equal(cur_val, ref_val[:, -1])
                     and bool(np.array_equal(cur_ok, ref_ok[:, -1])))
        if reanchored and not drift:
            both = live_ok & cur_ok
            if both.any():
                diff = np.abs(live_val[both] - cur_val[both])
                tol = np.broadcast_to(np.asarray(atol), live_ok.shape)[both]
                if not bool(np.all(diff <= tol)):
                    drift = True
        if drift:
            self.drift_events += 1
            if not reanchored:
                self.rebuild(snapshot)  # re-anchored path already rebuilt
        return {"drift": drift, "bars": snapshot.n_bars,
                "version": snapshot.version, "reanchored": reanchored}

    def stats(self) -> dict:
        return {
            "consumed_bars": self.consumed,
            "rebuilds": self.rebuilds,
            "reanchors": self.reanchors,
            "reconciliations": self.reconciliations,
            "drift_events": self.drift_events,
        }


class IncrementalMomentum(_UpdaterBase):
    """Running (J, skip) compounded momentum at the latest closed bar.

    State per asset: the forward-filled price carry, the seen flag, a
    ``(lookback + skip + 1)``-deep ring of filled prices, a matching
    ring of per-return badness bits, and an integer running sum of
    badness over the formation window — add the entering return,
    subtract the leaving one, exact in integers.
    """

    def __init__(self, n_assets: int, lookback: int = 12, skip: int = 1,
                 dtype=np.float64, field: str = "price"):
        super().__init__(n_assets, dtype)
        if lookback < 1 or skip < 0:
            raise ValueError("need lookback >= 1, skip >= 0")
        self.lookback = int(lookback)
        self.skip = int(skip)
        self.field = field
        self._W = self.lookback + self.skip + 1   # filled-price ring depth
        self._reset()

    def _reset(self) -> None:
        A, W = self.n_assets, self._W
        self._filled = np.full(A, np.nan, self.dtype)   # carry
        self._seen = np.zeros(A, bool)
        self._filled_ring = np.full((A, W), np.nan, self.dtype)
        self._bad_ring = np.ones((A, W), np.int32)      # return-badness bits
        self._bad_sum = np.full(A, self.lookback, np.int32)
        self._t = 0                                     # bars consumed here
        self._mom = np.full(A, np.nan, self.dtype)
        self._ok = np.zeros(A, bool)

    def _snapshot_field(self, snapshot):
        return snapshot.values[self.field], snapshot.mask[self.field]

    def _consume(self, values_col: np.ndarray, mask_col: np.ndarray) -> None:
        t = self._t
        W = self._W
        # return at index t (vs t-1): valid iff seen-before and carry != 0
        with np.errstate(invalid="ignore"):
            ret_ok = self._seen & (self._filled != 0.0)
        bad = (~ret_ok).astype(np.int32)  # t == 0 is all-bad, like the mirror
        new_filled = np.where(mask_col, values_col, self._filled)
        self._seen = self._seen | mask_col
        self._filled = new_filled

        # running badness over returns (t-skip-lookback, t-skip]: the
        # entering return is index t-skip, the leaving one t-skip-lookback
        col = t % W
        self._filled_ring[:, col] = new_filled
        self._bad_ring[:, col] = bad
        ent = t - self.skip
        lev = t - self.skip - self.lookback
        self._bad_sum += self._ring_bad(ent) - self._ring_bad(lev)

        hi = t - self.skip
        lo = t - self.skip - self.lookback
        if lo < 0:
            self._mom = np.full(self.n_assets, np.nan, self.dtype)
            self._ok = np.zeros(self.n_assets, bool)
        else:
            p_hi = self._ring_filled(hi)
            p_lo = self._ring_filled(lo)
            with np.errstate(invalid="ignore"):
                valid = (self._bad_sum == 0) & (p_lo != 0.0)
                one = np.asarray(1.0, dtype=self.dtype)
                self._mom = np.where(
                    valid, p_hi / np.where(valid, p_lo, one) - one,
                    _nan(self.dtype))
            self._ok = valid
        self._t = t + 1

    def _ring_bad(self, idx: int) -> np.ndarray:
        if idx < 0:
            # pre-history returns are bad by definition (the mirror's
            # leading pct_change NaN); they only enter the running sum
            # while the window is still partly before bar 0, where the
            # signal is invalid anyway — the constant keeps the sum
            # aligned so it is exact the instant the window materializes
            return np.ones(self.n_assets, np.int32)
        return self._bad_ring[:, idx % self._W]

    def _ring_filled(self, idx: int) -> np.ndarray:
        return self._filled_ring[:, idx % self._W]

    def _reference(self, snapshot) -> tuple:
        v, m = self._snapshot_field(snapshot)
        return full_momentum_np(np.asarray(v, self.dtype), m,
                                self.lookback, self.skip)

    def current(self) -> tuple:
        """(mom[A], valid[A]) at the latest consumed bar."""
        return self._mom.copy(), self._ok.copy()


class IncrementalTurnover(_UpdaterBase):
    """Running trailing-``lookback`` turnover mean at the latest bar.

    State per asset: the cumulative sum of filled turnover values and
    the cumulative valid count, appended in the SAME order as
    ``np.cumsum`` (bitwise-identical float sequence), plus a
    ``lookback``-deep ring of past cumulative values for the window's
    left edge — the trailing sum is two reads and a subtract, exactly
    the prefix-difference the mirror computes.
    """

    def __init__(self, n_assets: int, shares, lookback: int = 3,
                 dtype=np.float64, field: str = "volume"):
        super().__init__(n_assets, dtype)
        if lookback < 1:
            raise ValueError("need lookback >= 1")
        self.lookback = int(lookback)
        self.field = field
        self._shares = np.asarray(shares, dtype=self.dtype)
        if self._shares.shape != (self.n_assets,):
            raise ValueError(
                f"shares must be [A]={self.n_assets}, got "
                f"{self._shares.shape}")
        self._reset()

    def _reset(self) -> None:
        A, L = self.n_assets, self.lookback
        self._cs = np.zeros(A, self.dtype)       # cumulative filled sum
        self._cn = np.zeros(A, self.dtype)       # cumulative valid count
        self._cs_ring = np.zeros((A, L + 1), self.dtype)
        self._cn_ring = np.zeros((A, L + 1), self.dtype)
        self._t = 0
        self._avg = np.full(A, np.nan, self.dtype)
        self._ok = np.zeros(A, bool)

    def _snapshot_field(self, snapshot):
        return snapshot.values[self.field], snapshot.mask[self.field]

    def _cross_atol(self):
        """The trailing mean is a difference of globally-anchored float
        prefix sums; re-anchoring drops the common prefix, which cancels
        exactly only in exact arithmetic.  Bound the float residue by a
        few ulps of the prefix magnitude per asset — generous enough to
        never flag the anchor change, tight enough that genuine state
        corruption (which is O(signal), not O(ulp)) still reads as
        drift."""
        eps = np.finfo(self.dtype).eps
        return 32.0 * eps * (np.abs(self._cs) + 1.0)

    def _consume(self, values_col: np.ndarray, mask_col: np.ndarray) -> None:
        t = self._t
        L = self.lookback
        so = self._shares
        with np.errstate(invalid="ignore"):
            adv = values_col / np.asarray(TRADING_DAYS_PER_MONTH,
                                          dtype=self.dtype)
            so_ok = np.isfinite(so) & (so > 0)
            valid = mask_col & so_ok
            one = np.asarray(1.0, dtype=self.dtype)
            turn = np.where(valid, adv / np.where(so_ok, so, one),
                            _nan(self.dtype))
            filled = np.where(valid, np.nan_to_num(turn),
                              0.0).astype(self.dtype)
        # cumulative state at prefix index t (BEFORE adding this column)
        # parks in the ring so the window's left edge c[t+1-L] stays
        # readable; the additions below are the np.cumsum order exactly
        self._cs_ring[:, t % (L + 1)] = self._cs
        self._cn_ring[:, t % (L + 1)] = self._cn
        self._cs = self._cs + filled
        self._cn = self._cn + valid.astype(self.dtype)
        lo = max(t + 1 - L, 0)
        cs_lo = self._cs_ring[:, lo % (L + 1)] if t + 1 - L > 0 \
            else np.zeros(self.n_assets, self.dtype)
        cn_lo = self._cn_ring[:, lo % (L + 1)] if t + 1 - L > 0 \
            else np.zeros(self.n_assets, self.dtype)
        s = self._cs - cs_lo
        n = self._cn - cn_lo
        out_valid = n >= 1
        with np.errstate(invalid="ignore"):
            one = np.asarray(1.0, dtype=self.dtype)
            mean = s / np.maximum(n, one)
            self._avg = np.where(out_valid, mean, _nan(self.dtype))
        self._ok = out_valid
        self._t = t + 1

    def _reference(self, snapshot) -> tuple:
        v, m = self._snapshot_field(snapshot)
        return full_turnover_np(np.asarray(v, self.dtype), m,
                                self._shares, self.lookback)

    def current(self) -> tuple:
        """(turn_avg[A], valid[A]) at the latest consumed bar."""
        return self._avg.copy(), self._ok.copy()
