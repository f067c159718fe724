"""Daily close panels for the J x K grid, made on the device from the seed.

The same process as the repository's synthetic generator (a geometric
Brownian motion per stock, a third of the stocks listing late and a third
delisting early), drawn with a ``torch.Generator`` on the panel's device in
a few whole-panel calls, in the configuration's float type, so a
north-star panel takes well under a second of set-up.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def business_days(start: str, n_days: int) -> np.ndarray:
    """``n_days`` weekdays from ``start``, as ``datetime64[ns]``."""
    start_d = np.datetime64(start, "D")
    days = np.arange(start_d, start_d + np.timedelta64(n_days * 2, "D"))
    dow = (days.view("int64") + 4) % 7
    return days[dow < 5][:n_days].astype("datetime64[ns]")


def make(cfg: dict, seed: int, device) -> dict:
    """``{"values": f[A, T] (NaN where unlisted), "mask": bool[A, T],
    "times": datetime64[ns][T]}`` for the configuration ``cfg``."""
    A, T = int(cfg["n_assets"]), int(cfg["n_days"])
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def uniform(lo_hi, shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                           dtype=dtype)

    vol = uniform(cfg["annual_vol_range"], (A, 1)) / math.sqrt(252.0)
    drift = uniform(cfg["annual_drift_range"], (A, 1)) / 252.0
    steps = torch.randn((A, T), generator=gen, device=device, dtype=dtype)
    log_p = torch.cumsum(steps.mul_(vol).add_(drift), dim=1)
    values = torch.exp(log_p.sub_(log_p[:, :1].clone())).mul_(float(cfg["start_price"]))
    del steps, log_p

    mask = torch.ones((A, T), dtype=torch.bool, device=device)
    if cfg.get("listing_gaps"):
        third = A // 3
        t = torch.arange(T, device=device)
        starts = torch.randint(0, T // 2, (third, 1), generator=gen, device=device)
        ends = torch.randint(T // 2, T, (third, 1), generator=gen, device=device)
        mask[:third] = t[None, :] >= starts
        mask[third:2 * third] = t[None, :] < ends
        values = torch.where(mask, values, torch.nan)
    return {"values": values, "mask": mask,
            "times": business_days(cfg["start"], T)}
