"""Dense minute panels for the event engines, made on the device from the seed.

Each name's minute prices are a log random walk over the quarter's
regular-session minutes, a small share of (name, minute) cells carry no
bar, and each bar carries a model score.  Everything is drawn with a
``torch.Generator`` on the device in whole-panel calls, in the
configuration's float type.
"""

from __future__ import annotations

import torch


def make(cfg: dict, seed: int, device) -> dict:
    """``{"price": f[A, T] (NaN without a bar), "valid": bool[A, T],
    "score": f[A, T] (0 without a bar), "adv": f[A], "vol": f[A]}`` with
    ``T = n_days * minutes_per_day``."""
    A = int(cfg["n_assets"])
    T = int(cfg["n_days"]) * int(cfg["minutes_per_day"])
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def uniform(lo_hi, shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                           dtype=dtype)

    p0 = uniform(cfg["start_price_range"], (A, 1))
    sigma = uniform(cfg["minute_vol_range"], (A, 1))
    steps = torch.randn((A, T), generator=gen, device=device, dtype=dtype)
    price = torch.exp(torch.cumsum(steps.mul_(sigma), dim=1)).mul_(p0)
    del steps
    valid = torch.rand((A, T), generator=gen, device=device,
                       dtype=dtype) >= float(cfg["missing_share"])
    price = torch.where(valid, price, torch.nan)
    score = torch.randn((A, T), generator=gen, device=device, dtype=dtype)
    score = torch.where(valid, score.mul_(float(cfg["score_sd"])), 0.0)
    adv = torch.full((A,), float(cfg["adv_shares"]), dtype=dtype, device=device)
    vol = torch.full((A,), float(cfg["daily_vol"]), dtype=dtype, device=device)
    return {"price": price, "valid": valid, "score": score, "adv": adv,
            "vol": vol}
