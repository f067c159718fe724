"""Plain reference of the Jegadeesh-Titman J x K grid, in NumPy.

It starts from the raw daily panel that the benchmark made and works out
everything the program derives again: the month-end panel, the padded
monthly returns, the (J, skip) formation signals, the decile labels, each
cohort's long-short return at every horizon, the 1/K overlapping holding
spreads and the four statistics of each (J, K) cell.

Precision: the formation signal is the float32 price ratio the
configuration states (``p[t-skip] / p[t-skip-J] - 1`` on the float32
panel), so the ranking sees the values the configuration defines; every
sum, mean and statistic is float64.  It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def month_end_panel(values, mask, times):
    """Daily ``(values f[A, T], mask bool[A, T], times datetime64[T])`` ->
    ``(prices f[A, M], listed bool[A, M])``: each calendar month's last
    observed close, by a segmented maximum of observed day indices."""
    months = np.asarray(times).astype("datetime64[M]")
    starts = np.flatnonzero(np.r_[True, months[1:] != months[:-1]])
    day = np.where(mask, np.arange(values.shape[1])[None, :], -1)
    last = np.maximum.reduceat(day, starts, axis=1)              # [A, M]
    listed = last >= starts[None, :]
    prices = np.take_along_axis(values, np.clip(last, 0, None), axis=1)
    return np.where(listed, prices, np.nan), listed


def forward_fill(prices, listed):
    """The last observed month-end price at or before each month (NaN
    before the first) and whether one exists."""
    A, M = prices.shape
    filled = np.full_like(prices, np.nan)
    seen = np.zeros((A, M), dtype=bool)
    cur = np.full(A, np.nan, dtype=prices.dtype)
    have = np.zeros(A, dtype=bool)
    for t in range(M):
        cur = np.where(listed[:, t], prices[:, t], cur)
        have = have | listed[:, t]
        filled[:, t] = cur
        seen[:, t] = have
    return filled, seen


def rank_labels(signal, ok, n_bins):
    """Rows ``[R, A]``: label ``min(B - 1, floor(r * B / n))`` for the
    1-based rank r among the row's n valid lanes, ties by position;
    -1 where not valid."""
    order = np.lexsort((np.where(ok, signal, 0), ~ok), axis=-1)
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(1, signal.shape[-1] + 1)[None, :]
                      .repeat(signal.shape[0], 0), axis=-1)
    n = ok.sum(axis=-1, keepdims=True)
    labels = np.minimum((rank * n_bins) // np.maximum(n, 1), n_bins - 1)
    return np.where(ok, labels, -1)


def grid(values, mask, times, Js, Ks, skip, n_bins, freq_per_year):
    """The grid's result table from the raw daily panel.

    Returns a dict of float64 arrays: ``spreads [nJ, nK, M]`` (NaN where
    not live), ``valid`` bool ``[nJ, nK, M]``, ``mean``, ``sharpe``,
    ``t``, ``nw_t`` ``[nJ, nK]``, and ``members [M]``, the number of
    (J, asset) pairs in the two extreme deciles at each formation month.
    """
    values = np.asarray(values)
    p32, listed = month_end_panel(values, np.asarray(mask), times)
    filled32, seen = forward_fill(p32, listed)
    A, M = p32.shape
    H = max(Ks)

    # padded monthly returns: ret[t] = filled[t] / filled[t-1] - 1
    filled = filled32.astype(np.float64)
    ret_ok = np.zeros((A, M), dtype=bool)
    ret_ok[:, 1:] = seen[:, :-1] & (filled[:, :-1] != 0)
    ret = np.zeros((A, M))
    ret[:, 1:] = np.where(ret_ok[:, 1:], filled[:, 1:]
                          / np.where(ret_ok[:, 1:], filled[:, :-1], 1.0) - 1.0, 0.0)

    # still listed at the formation window's end
    last_obs = np.where(listed, np.arange(M)[None, :], -1).max(axis=1)
    t = np.arange(M)
    listed_at = last_obs[:, None] >= (t - skip)[None, :]

    labels = np.full((len(Js), A, M), -1, dtype=np.int64)
    for j, J in enumerate(Js):
        sig = np.full((A, M), np.nan, dtype=np.float32)
        ok = np.zeros((A, M), dtype=bool)
        for m in range(skip + J, M):
            hi, lo = m - skip, m - skip - J
            window_ok = ret_ok[:, lo + 1:hi + 1].all(axis=1)
            p_lo = filled32[:, lo]
            ok[:, m] = window_ok & (p_lo != 0) & listed_at[:, m]
            with np.errstate(invalid="ignore", divide="ignore"):
                sig[:, m] = filled32[:, hi] / p_lo - np.float32(1.0)
        lab = rank_labels(sig.T, ok.T, n_bins)                   # [M, A]
        labels[j] = lab.T

    # cohort long-short return R[j, s, h-1] from the members' returns at s+h
    nJ = len(Js)
    R = np.zeros((nJ, M, H))
    R_ok = np.zeros((nJ, M, H), dtype=bool)
    for j in range(nJ):
        bot = (labels[j] == 0).astype(np.float64)
        top = (labels[j] == n_bins - 1).astype(np.float64)
        for h in range(1, H + 1):
            r_h = ret[:, h:]                                     # returns at s+h
            v_h = ret_ok[:, h:].astype(np.float64)
            means = []
            for side in (bot, top):
                s_sum = (side[:, :M - h] * r_h).sum(axis=0)
                s_cnt = (side[:, :M - h] * v_h).sum(axis=0)
                means.append((s_sum / np.maximum(s_cnt, 1), s_cnt > 0))
            (m_bot, ok_bot), (m_top, ok_top) = means
            R[j, :M - h, h - 1] = m_top - m_bot
            R_ok[j, :M - h, h - 1] = ok_top & ok_bot

    # holding month m: the mean over h = 1..K of the cohort formed at m-h
    nK = len(Ks)
    spreads = np.full((nJ, nK, M), np.nan)
    live = np.zeros((nJ, nK, M), dtype=bool)
    for k, K in enumerate(Ks):
        total = np.zeros((nJ, M))
        ok = np.ones((nJ, M), dtype=bool)
        for h in range(1, K + 1):
            src = t - h
            inside = src >= 0
            srcc = np.clip(src, 0, M - 1)
            total += np.where(inside[None, :], R[:, srcc, h - 1], 0.0)
            ok &= inside[None, :] & R_ok[:, srcc, h - 1]
        live[:, k] = ok
        spreads[:, k] = np.where(ok, total / K, np.nan)

    mean, sharpe, tstat, nw = (np.full((nJ, nK), np.nan) for _ in range(4))
    for j in range(nJ):
        for k, K in enumerate(Ks):
            v = live[j, k]
            x = spreads[j, k][v]
            n = x.size
            if n == 0:
                continue
            mu = x.mean()
            mean[j, k] = mu
            if n < 2:
                continue
            sd = x.std(ddof=1)
            if sd > 0:
                sharpe[j, k] = mu * freq_per_year / (sd * np.sqrt(freq_per_year))
                tstat[j, k] = mu / (sd / np.sqrt(n))
            # Newey-West over the full month axis, absent months as zeros
            u = np.where(v, np.nan_to_num(spreads[j, k]) - mu, 0.0)
            L = min(K, n - 1)
            lrv = (u * u).sum() / n
            for lag in range(1, L + 1):
                lrv += 2.0 * (1.0 - lag / (L + 1.0)) * (u[lag:] * u[:-lag]).sum() / n
            se = np.sqrt(max(lrv, 0.0) / n)
            if se > 0:
                nw[j, k] = mu / se

    members = ((labels == 0) | (labels == n_bins - 1)).sum(axis=(0, 1))
    return {"spreads": spreads, "valid": live, "mean": mean, "sharpe": sharpe,
            "t": tstat, "nw_t": nw, "members": members}
