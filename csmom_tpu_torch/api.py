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
