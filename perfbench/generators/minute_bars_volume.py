"""Compacted minute bars with volumes for the intraday pipeline, made on the
device from the seed.

Each name's minute log-returns are an MA(1), ``r_t = e_t + theta * e_{t-1}``
with ``e_t ~ N(0, s)`` (the bid-ask bounce of Roll (1984), J. Finance
39(4): a small negative autocorrelation that a ridge fit on lagged
returns can learn), over the quarter's regular-session minutes; a small
share of (name, minute) cells carry no bar.  Minute volumes are the name's
ADV over the session's minutes, times a U-shaped intraday profile, times
lognormal noise, rounded to whole shares.  The bars are then compacted as
``csmom_tpu_torch.signals.intraday.compact_minutes`` lays them out: row j
of a name is its j-th bar, padded to the longest name, each row mapped to
the global minute axis (the minutes at which some name has a bar).
Everything is drawn with a ``torch.Generator`` on the device in
whole-panel calls, in the configuration's float type.
"""

from __future__ import annotations

import math

import torch


def make(cfg: dict, seed: int, device) -> dict:
    """``{"price": f[A, R], "volume": f[A, R]`` (NaN on padding),
    ``"row_valid": bool[A, R], "time_idx": i32[A, R]`` (each row's minute on
    the axis, 0 on padding), ``"n_minutes": int, "adv": f[A], "vol": f[A]}``
    with ``vol`` the name's daily volatility, ``s * sqrt(minutes_per_day)``."""
    A = int(cfg["n_assets"])
    M = int(cfg["minutes_per_day"])
    T = int(cfg["n_days"]) * M
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def uniform(lo_hi, shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                           dtype=dtype)

    p0 = uniform(cfg["start_price_range"], (A, 1))
    sigma = uniform(cfg["minute_vol_range"], (A, 1))
    e = torch.randn((A, T + 1), generator=gen, device=device, dtype=dtype).mul_(sigma)
    r = e[:, 1:] + float(cfg["ma1_theta"]) * e[:, :-1]
    del e
    price = torch.exp(torch.cumsum(r, dim=1)).mul_(p0)
    del r
    present = torch.rand((A, T), generator=gen, device=device,
                         dtype=dtype) >= float(cfg["missing_share"])

    lo, hi = (math.log(x) for x in cfg["adv_range"])
    adv = torch.exp(uniform((lo, hi), (A,)))
    x = (torch.arange(T, device=device, dtype=dtype) % M) / ((M - 1) / 2) - 1.0
    depth = float(cfg["volume_profile_depth"])
    profile = (1.0 + depth * x * x) / (1.0 + depth / 3.0)   # mean 1 over a day
    sd = float(cfg["volume_noise_sd"])
    noise = torch.randn((A, T), generator=gen, device=device, dtype=dtype)
    noise = torch.exp(noise.mul_(sd).sub_(sd * sd / 2.0))
    volume = torch.round(noise.mul_(profile).mul_(adv[:, None] / M)).clamp_(min=1.0)
    del noise

    # the minute axis: minutes at which some name has a bar
    on_axis = present.any(dim=0)
    axis_idx = torch.cumsum(on_axis, dim=0) - 1
    counts = present.sum(dim=1)
    R = int(counts.max())
    # each name's bars first, in minute order (a stable sort of "no bar")
    order = torch.sort((~present).to(torch.int8), dim=1, stable=True).indices[:, :R]
    row_valid = torch.arange(R, device=device)[None, :] < counts[:, None]
    price = torch.where(row_valid, torch.gather(price, 1, order), torch.nan)
    volume = torch.where(row_valid, torch.gather(volume, 1, order), torch.nan)
    time_idx = torch.where(row_valid, axis_idx[order], 0).to(torch.int32)
    return {"price": price, "volume": volume, "row_valid": row_valid,
            "time_idx": time_idx, "n_minutes": int(on_axis.sum()),
            "adv": adv, "vol": sigma[:, 0] * math.sqrt(M)}
