"""The data-in glue: CSV caches or a packed panel -> month-end panels.

Counterpart of :func:`csmom_tpu.api.monthly_price_panel`.  The daily panels
are read on the host (the CSV ingest or a memmapped pack), handed to the
device once, and aggregated to month ends there by the port's
:func:`~csmom_tpu_torch.panel.calendar.month_end_aggregate` and
:func:`~csmom_tpu_torch.panel.calendar.segment_sum_panel`.
"""

from __future__ import annotations

from csmom_tpu_torch.device import resolve_device
from csmom_tpu_torch.panel import ingest
from csmom_tpu_torch.panel.calendar import (
    month_end_aggregate,
    month_end_segments,
    segment_sum_panel,
)
from csmom_tpu_torch.panel.pack import is_packed, load_packed
from csmom_tpu_torch.panel.panel import Panel


def monthly_price_panel(data_dir: str, tickers, field: str = "adj_close",
                        daily_df=None, device=None, dtype=None):
    """Daily CSV caches OR a packed panel directory -> month-end panels.

    Returns ``(prices Panel[A, M], volume Panel[A, M])`` with month-end
    timestamps and host arrays, as the reference does.  ``data_dir`` is a
    CSV cache directory (read by :func:`~csmom_tpu_torch.panel.ingest.load_daily`)
    or a packed directory (:func:`~csmom_tpu_torch.panel.pack.is_packed`),
    memmapped with no CSV parsing; pass ``daily_df`` (a canonical long
    frame) to reuse an already-loaded universe.  ``tickers`` selects a
    subset of a pack; an empty or None universe takes every packed ticker.

    The aggregation runs on ``device``: ``"cuda"`` by default, raising
    without a card unless ``device="cpu"`` is passed.  ``dtype`` defaults
    to the daily panel's own (float64 from the CSV ingest, the stored type
    from a pack); monthly volumes are summed in float64 whatever it is.
    A month is a valid volume observation iff at least one daily bar
    existed in it.
    """
    dev = resolve_device(device)
    if daily_df is None and is_packed(data_dir):
        bundle = load_packed(data_dir)
        if isinstance(bundle, Panel):  # single-field pack: no volume leg
            raise ValueError(
                f"packed panel {data_dir} holds only {bundle.name!r}; the "
                f"monthly pipeline needs {field!r} and 'volume' — repack "
                "with both fields (pack_csv_cache writes both)"
            )
        for need in (field, "volume"):
            if need not in bundle:
                raise ValueError(
                    f"packed panel {data_dir} lacks field {need!r} "
                    f"(has {', '.join(bundle.fields)}) — repack with it"
                )
        price_daily = bundle[field]
        vol_daily = bundle["volume"]
        if tickers:
            want = set(tickers)
            missing = sorted(want - set(price_daily.tickers))
            if missing:
                raise ValueError(
                    f"packed panel {data_dir} lacks {len(missing)} requested "
                    f"tickers: {','.join(missing[:8])}"
                )
            # sorted, as the CSV path's pivot orders them: both sources give
            # the same rows for the same request
            keep = sorted(t for t in price_daily.tickers if t in want)
            price_daily = price_daily.select_assets(keep)
            vol_daily = vol_daily.select_assets(keep)
    else:
        df = daily_df if daily_df is not None else ingest.load_daily(data_dir, tickers)
        price_daily = ingest.long_to_panel(df, field, time_col="date")
        vol_daily = ingest.long_to_panel(df, "volume", time_col="date",
                                         tickers=price_daily.tickers,
                                         times=price_daily.times)
    seg, month_ends = month_end_segments(price_daily.times)
    m = len(month_ends)

    pv, pm = price_daily.tensors(device=dev, dtype=dtype)
    prices_m, mask_m = month_end_aggregate(pv, pm, seg, m)
    vv, vm = vol_daily.tensors(device=dev, dtype=dtype)
    vol_m = segment_sum_panel(vv, vm, seg, m)
    # a phantom 0 with mask=True would rank pre-listing months into the
    # bottom volume decile of a turnover sort
    vol_obs = segment_sum_panel(vm.to(vv.dtype), vm, seg, m) > 0

    prices = Panel(values=prices_m.cpu().numpy(), mask=mask_m.cpu().numpy(),
                   tickers=price_daily.tickers, times=month_ends,
                   name=f"month_end_{field}")
    volume = Panel(values=vol_m.cpu().numpy(), mask=vol_obs.cpu().numpy(),
                   tickers=price_daily.tickers, times=month_ends,
                   name="monthly_volume")
    return prices, volume


def synthetic_minute_frame(daily_df, minutes_per_day: int = 390, seed: int = 0):
    """Synthetic 1-minute bars from daily OHLCV, as a canonical long frame
    (counterpart of :func:`csmom_tpu.api.synthetic_minute_frame`, host
    numpy and pandas): a linear open->close path x (1 + N(0, 5e-4)) noise
    and a sin^2 U-curve of volume, one ``synthetic_minute_bars`` call per
    universe."""
    import numpy as np
    import pandas as pd

    from csmom_tpu_torch.panel.synthetic import synthetic_minute_bars

    if daily_df is None or len(daily_df) == 0:
        return pd.DataFrame(columns=["datetime", "ticker", "price", "volume"])

    tickers = sorted(daily_df["ticker"].unique())
    days = np.sort(daily_df["date"].unique())
    open_p = ingest.long_to_panel(daily_df, "open", "date", tickers, days)
    close_p = ingest.long_to_panel(daily_df, "close", "date", tickers, days)
    vol_p = ingest.long_to_panel(daily_df, "volume", "date", tickers, days)

    ok = np.isfinite(open_p.values) & np.isfinite(close_p.values)
    vols = np.where(np.isfinite(vol_p.values) & (vol_p.values > 0), vol_p.values, 1.0)
    prices, volumes = synthetic_minute_bars(
        np.nan_to_num(open_p.values), np.nan_to_num(close_p.values), vols,
        minutes_per_day=minutes_per_day, seed=seed,
    )

    minute_offsets = (np.timedelta64(9 * 60 + 30, "m")
                      + np.arange(minutes_per_day) * np.timedelta64(1, "m"))
    stamps = days.astype("datetime64[D]")[None, :, None] + minute_offsets[None, None, :]
    A, D, T = prices.shape
    keep = np.broadcast_to(ok[:, :, None], (A, D, T))
    tick = np.broadcast_to(np.asarray(tickers, dtype=object)[:, None, None], (A, D, T))
    return pd.DataFrame(
        {
            "datetime": np.broadcast_to(stamps, (A, D, T))[keep],
            "ticker": tick[keep],
            "price": prices[keep],
            "volume": volumes[keep].astype(float),
        }
    )


def daily_risk_maps(daily_df, tickers):
    """Per-asset ADV and daily-return vol vectors with the reference's
    fallbacks (host numpy): ADV = mean daily volume (100,000 when missing
    or <= 0); vol = std (ddof=1) of daily pct_change of adj_close (0.02).
    An asset absent from the daily frame gets both fallbacks."""
    import numpy as np

    from csmom_tpu_torch.backtest.event import DEFAULT_ADV, DEFAULT_VOL

    adv = np.full(len(tickers), DEFAULT_ADV)
    vol = np.full(len(tickers), DEFAULT_VOL)
    if daily_df is not None and len(daily_df):
        adv_s = daily_df.groupby("ticker")["volume"].mean()
        ret = daily_df.groupby("ticker")["adj_close"].pct_change()
        vol_s = ret.groupby(daily_df["ticker"]).std()
        for i, t in enumerate(tickers):
            a = adv_s.get(t, np.nan)
            if np.isfinite(a) and a > 0:
                adv[i] = float(a)
            v = vol_s.get(t, np.nan)
            if np.isfinite(v) and v > 0:
                vol[i] = float(v)
    return adv, vol


INTRADAY_MODELS = ("ridge", "online_ridge", "elastic_net", "lasso", "mlp")


def intraday_pipeline(
    minute_df,
    daily_df,
    window_minutes: int = 30,
    n_splits: int = 3,
    alpha: float | None = None,
    size_shares: int = 50,
    threshold: float = 1e-5,
    cash0: float = 1_000_000.0,
    dtype=None,
    model: str = "ridge",
    l1_ratio: float = 0.5,
    latency_bars: int = 0,
    device=None,
):
    """Minute bars -> features -> model scores -> event backtest, on the
    device (counterpart of :func:`csmom_tpu.api.intraday_pipeline`).

    ``model`` is ``'ridge'`` (the reference's), ``'online_ridge'``
    (leak-free walk-forward), ``'elastic_net'`` / ``'lasso'`` (``alpha``
    and ``l1_ratio`` apply) or ``'mlp'`` (``alpha`` is its weight decay).
    ``alpha=None`` resolves per model: 1.0 for ridge and online ridge,
    1e-8 for elastic net and lasso, 1e-4 for the MLP.  ``dtype`` defaults
    to ``torch.float64``, the reference's default.  The host compacts the
    frame and hands the compacted panels and the risk maps to the device
    once; the rest is :func:`intraday_on_device`, on ``device``:
    ``"cuda"`` by default, raising without a card unless ``device="cpu"``
    is passed.

    Returns ``(EventResult, fit, compact, dense_score, dense_price,
    dense_valid)``; ``fit`` is the model's fit (RidgeFit for the batch
    linear family, OnlineRidgeFit, or MLPFit; each carries ``scores``,
    ``cv_mse`` and ``n_train``) and the dense panels are ``[A, T]``
    tensors on the device over the global minute axis.
    """
    import torch

    from csmom_tpu_torch.signals.intraday import compact_minutes

    dev = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    _check_model(model)
    if minute_df is None or len(minute_df) == 0:
        # no live intraday data -> synthesize minutes from daily bars
        minute_df = synthetic_minute_frame(daily_df)
        if len(minute_df) == 0:
            raise ValueError(
                "intraday_pipeline: no intraday rows and no daily bars to "
                "synthesize a fallback from"
            )
    compact = compact_minutes(minute_df)
    result, fit, dense_score, dense_price, dense_valid = intraday_on_device(
        *intraday_panels(compact, *daily_risk_maps(daily_df, compact.tickers),
                         dev, dtype),
        window_minutes=window_minutes, n_splits=n_splits, alpha=alpha,
        size_shares=size_shares, threshold=threshold, cash0=cash0,
        model=model, l1_ratio=l1_ratio, latency_bars=latency_bars,
    )
    return result, fit, compact, dense_score, dense_price, dense_valid


def intraday_panels(compact, adv, vol, device, dtype):
    """A :class:`~csmom_tpu_torch.signals.intraday.CompactMinutePanel` and
    its risk maps (host arrays) on ``device``, in ``dtype``: the positional
    arguments of :func:`intraday_on_device`, ``(price, volume, row_valid,
    time_idx, n_minutes, adv, vol)``."""
    import torch

    return (torch.as_tensor(compact.price, dtype=dtype).to(device),
            torch.as_tensor(compact.volume, dtype=dtype).to(device),
            torch.as_tensor(compact.row_valid).to(device),
            torch.as_tensor(compact.time_idx).to(device),
            len(compact.times),
            torch.as_tensor(adv, dtype=dtype).to(device),
            torch.as_tensor(vol, dtype=dtype).to(device))


def _check_model(model: str) -> None:
    if model not in INTRADAY_MODELS:
        raise ValueError(
            f"unknown model {model!r} (expected 'ridge', 'online_ridge', "
            f"'elastic_net', 'lasso', or 'mlp')"
        )


def intraday_on_device(
    price,
    volume,
    row_valid,
    time_idx,
    n_minutes: int,
    adv,
    vol,
    *,
    window_minutes: int = 30,
    n_splits: int = 3,
    alpha: float | None = None,
    size_shares: int = 50,
    threshold: float = 1e-5,
    cash0: float = 1_000_000.0,
    model: str = "ridge",
    l1_ratio: float = 0.5,
    latency_bars: int = 0,
):
    """The intraday pipeline's device work, from compacted panels resident
    on the device to the event backtest: minute features and the next-row
    label, the model's fit and scores, the scores scattered onto the
    minute axis, and
    :func:`~csmom_tpu_torch.backtest.event.event_backtest`.

    ``price``, ``volume`` (f[A, R], in the pipeline's dtype),
    ``row_valid`` (bool[A, R]) and ``time_idx`` (int[A, R], each row's
    minute on the global axis of ``n_minutes``) are a
    :class:`~csmom_tpu_torch.signals.intraday.CompactMinutePanel`'s arrays
    on the device, ``adv`` and ``vol`` (f[A]) the risk maps; the other
    arguments are :func:`intraday_pipeline`'s.  Nothing is uploaded here.

    Phase spans (:func:`csmom_tpu_torch.obs.spans.span`), opened one after
    another and before the engine's own ``event.*``: ``intraday.features``
    (features and label), ``intraday.fit`` (scaler, folds, final fit,
    scores) and ``intraday.scatter`` (the dense panels), each with the
    host-known attributes ``rows`` (A·R) and ``features``; the fit's adds
    ``solves`` (a batch model's fold fits and final fit) and ``model``.
    A ridge call adds its ``n_splits + 1`` solves to the counter
    ``ridge.solves`` (:mod:`csmom_tpu_torch.obs.metrics`, armed only).

    Returns ``(EventResult, fit, dense_score, dense_price, dense_valid)``,
    :func:`intraday_pipeline`'s results but ``compact``.
    """
    import torch

    from csmom_tpu_torch.backtest.event import event_backtest
    from csmom_tpu_torch.models import (
        as_ridge_fit,
        elastic_net_time_series_cv,
        mlp_time_series_cv,
        online_ridge_scores,
        ridge_time_series_cv,
    )
    from csmom_tpu_torch.obs.metrics import counter
    from csmom_tpu_torch.obs.spans import span
    from csmom_tpu_torch.signals.intraday import (
        FEATURE_NAMES,
        minute_features,
        next_row_return,
    )

    _check_model(model)
    if alpha is None:
        alpha = {"ridge": 1.0, "online_ridge": 1.0, "mlp": 1e-4}.get(model, 1e-8)
    A, R = price.shape
    shape = dict(rows=A * R, features=len(FEATURE_NAMES))
    with span("intraday.features", **shape):
        feats, feat_valid = minute_features(price, volume, row_valid,
                                            window=window_minutes)
        y, y_valid = next_row_return(price, feat_valid)

    solves = 0 if model == "online_ridge" else n_splits + 1
    with span("intraday.fit", **shape, solves=solves, model=model):
        if model == "ridge":
            fit = ridge_time_series_cv(feats, y, y_valid, n_splits=n_splits,
                                       alpha=alpha)
            counter("ridge.solves").inc(solves)
        elif model == "online_ridge":
            fit = online_ridge_scores(feats, y, y_valid, n_splits=n_splits,
                                      alpha=alpha)
        elif model in ("elastic_net", "lasso"):
            enet = elastic_net_time_series_cv(
                feats, y, y_valid, n_splits=n_splits, alpha=alpha,
                l1_ratio=1.0 if model == "lasso" else l1_ratio,
            )
            if int(enet.n_nonzero) == 0:
                import logging

                logging.getLogger("csmom_tpu_torch.api").warning(
                    "%s with alpha=%g zeroed every coefficient — scores are the "
                    "intercept only and the strategy will be (nearly) flat; "
                    "minute-return labels are ~1e-4, so useful l1 penalties are "
                    "~1e-9..1e-7", model, alpha,
                )
            fit = as_ridge_fit(enet)
        else:
            fit = mlp_time_series_cv(feats, y, y_valid, n_splits=n_splits,
                                     weight_decay=alpha)
    del feats, y

    with span("intraday.scatter", **shape):
        dense_score, dense_price, dense_valid = scatter_to_minutes(
            time_idx, n_minutes, y_valid, (fit.scores, price))
        score0 = torch.nan_to_num(dense_score)
    result = event_backtest(
        dense_price,
        dense_valid,
        score0,
        adv,
        vol,
        size_shares=size_shares,
        threshold=threshold,
        cash0=cash0,
        latency_bars=latency_bars,
    )
    return result, fit, dense_score, dense_price, dense_valid


def scatter_to_minutes(time_idx, n_minutes: int, y_valid, values):
    """Compacted ``[A, R]`` rows onto the global minute axis ``[A, T]``,
    ``T = n_minutes``, by ``time_idx`` (int[A, R] on ``y_valid``'s
    device, each row's minute): each tensor of ``values`` (NaN off the
    modeling rows), then the mask of modeling rows.  Padded and non-model
    rows go to a spill column that is sliced off; every other target cell
    is hit at most once."""
    import torch

    dev = y_valid.device
    A, R = y_valid.shape
    T = n_minutes
    rows = torch.arange(A, device=dev)[:, None].expand(A, R)
    cols = torch.where(y_valid, time_idx.long(), T)
    out = []
    for vals in values:
        dense = torch.full((A, T + 1), float("nan"), dtype=vals.dtype, device=dev)
        dense[rows, cols] = vals
        out.append(dense[:, :T])
    dense_valid = torch.zeros((A, T + 1), dtype=torch.bool, device=dev)
    dense_valid[rows, cols] = y_valid
    return (*out, dense_valid[:, :T])
