"""Serve shape buckets: the closed set of shapes a dispatch may take.

Counterpart of ``csmom_tpu.serve.buckets``, copied.  A request arrives
with its own universe size; the service pads every micro-batch up to
the nearest entry of a small fixed grid of (batch, assets) buckets at
one canonical month count, so the set of dispatchable shapes is closed
and enumerable: the engine warms every one of them at start-up
(building and loading each kernel the shapes launch, and filling the
caching allocator), after which nothing is built inside the serving
window (counted per run and recorded in the artifact).

The cost is padded lanes (masked out, so results are exact); the
``pad_fraction`` field of every artifact keeps that overhead honest.
Bucket steps bound the waste (< 4x on the asset axis, < 2x between
batch steps).

Stdlib-only.  The endpoint set is not here: endpoints are registered
engines (:func:`csmom_tpu_torch.registry.serve_endpoints`), and this
module owns only shape geometry.
"""

from __future__ import annotations

import bisect
import dataclasses

__all__ = ["BucketSpec", "PROFILES", "bucket_spec"]


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One closed shape grid: (batch buckets) x (asset buckets) x months."""

    name: str
    months: int                 # canonical history length M (time axis)
    asset_buckets: tuple        # ascending A buckets requests pad up to
    batch_buckets: tuple        # ascending B buckets micro-batches pad up to
    dtype: str = "float32"      # the serve compute dtype

    def asset_bucket_for(self, n_assets: int) -> int | None:
        """Smallest asset bucket holding ``n_assets``; None = too large
        (the service rejects at admission — an unserveable shape must
        fail at the door, not compile on the dispatch path)."""
        if n_assets <= 0:
            return None
        i = bisect.bisect_left(self.asset_buckets, n_assets)
        return self.asset_buckets[i] if i < len(self.asset_buckets) else None

    def batch_bucket_for(self, n_requests: int) -> int:
        """Smallest batch bucket holding ``n_requests`` (the batcher never
        gathers more than ``max_batch`` requests, so this always fits)."""
        i = bisect.bisect_left(self.batch_buckets, n_requests)
        return self.batch_buckets[min(i, len(self.batch_buckets) - 1)]

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    @property
    def max_assets(self) -> int:
        return self.asset_buckets[-1]

    def shapes(self):
        """Every dispatchable (B, A, months) — the closed world the serve
        manifest profile enumerates and warmup compiles."""
        return [(b, a, self.months)
                for b in self.batch_buckets for a in self.asset_buckets]


PROFILES = {
    # the production grid: five years of months, universes to 128 names,
    # batches to 8 requests — 6 shapes per endpoint
    "serve": BucketSpec(
        name="serve", months=60, asset_buckets=(32, 128),
        batch_buckets=(1, 4, 8),
    ),
    # the tier-1/smoke grid: tiny shapes, every code path — 2 shapes per
    # endpoint, compiles in seconds on CPU
    "serve-smoke": BucketSpec(
        name="serve-smoke", months=24, asset_buckets=(8,),
        batch_buckets=(1, 4),
    ),
}


def bucket_spec(profile: str) -> BucketSpec:
    try:
        return PROFILES[profile]
    except KeyError:
        raise ValueError(
            f"unknown serve bucket profile {profile!r}: use one of "
            f"{sorted(PROFILES)}"
        ) from None
