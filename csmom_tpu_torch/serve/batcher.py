"""Adaptive micro-batch coalescer: deadline-aware continuous batching.

Counterpart of ``csmom_tpu.serve.batcher``, copied.  The batcher turns
the queue's per-request panels into the closed set of shapes the engine
warmed (:mod:`csmom_tpu_torch.serve.buckets`), deciding adaptively when
to fire (continuous batching in the manner of Orca, Yu et al., OSDI
2022, adapted to padded shape buckets):

- **fire early when a deadline is at risk**: before every wait the
  queue reports the smallest remaining deadline budget among gatherable
  requests; under the risk margin (an EMA of recent batch service walls
  times a safety factor, plus a floor) the batch fires now;
- **refill the instant the engine frees**: when the previous dispatch
  returns and work is already queued, the next micro-batch collects
  with a zero window (fire reason ``refill``);
- **coalesce only when idle**: a request arriving at an idle service
  waits at most ``max_wait_s`` for co-batchable company.

Every dispatch pads onto the warmed bucket grid: each request's asset
axis up to the smallest asset bucket that holds it (padded lanes carry
a False mask) and the batch axis up to the smallest batch bucket
(padding rows are all-masked dummies).  Adaptivity changes when a batch
fires, never what shapes exist.  The fire reasons (``full`` /
``deadline_risk`` / ``window`` / ``refill``) are counted into the
artifact's ``batches`` block.

Numpy-only: the batch is padded into host arrays ``[B, A, M]`` and the
engine (:mod:`csmom_tpu_torch.serve.engine`) moves it to the device.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from csmom_tpu_torch.serve.buckets import BucketSpec
from csmom_tpu_torch.serve.queue import AdmissionQueue

__all__ = ["Batcher", "Microbatch"]

# deadline-risk margin: fire early when a queued deadline's remaining
# budget <= SAFETY * (batch service EMA) + FLOOR.  SAFETY covers pad/
# fan-out overhead around the engine call; FLOOR covers the cold start
# before any batch has been measured.
RISK_SAFETY = 2.0
RISK_FLOOR_S = 0.002


@dataclasses.dataclass
class Microbatch:
    """One coalesced, padded dispatch unit."""

    kind: str
    requests: list               # live (non-expired) requests, batch order
    batch_bucket: int            # B: padded batch rows
    asset_bucket: int            # A: padded asset lanes
    values: np.ndarray           # f32[B, A, M]
    mask: np.ndarray             # bool[B, A, M]
    fire_reason: str = "window"  # why collect fired (see queue.collect)

    @property
    def pad_fraction(self) -> float:
        """Fraction of dispatched (batch, asset) lanes that are padding —
        the honesty metric for the bucket grid."""
        used = sum(r.n_assets for r in self.requests)
        total = self.batch_bucket * self.asset_bucket
        return round(1.0 - used / total, 4) if total else 0.0


class Batcher:
    """Coalesce queued requests into padded bucket-shaped micro-batches,
    deciding WHEN to fire adaptively (deadline risk, refill, window)."""

    def __init__(self, spec: BucketSpec, max_wait_s: float = 0.01):
        self.spec = spec
        self.max_wait_s = max_wait_s
        self._lock = threading.Lock()
        self._service_ema_s: float | None = None
        self.fire_reasons: dict = {}

    def note_service_wall(self, wall_s: float) -> None:
        """Feed one batch's dispatch wall into the risk-margin EMA (the
        service calls this after every engine call, crash or not)."""
        with self._lock:
            ema = self._service_ema_s
            self._service_ema_s = (wall_s if ema is None
                                   else 0.8 * ema + 0.2 * wall_s)

    def risk_margin_s(self) -> float:
        """How much remaining deadline budget a queued request needs for
        waiting to still be safe: below this, fire immediately."""
        with self._lock:
            ema = self._service_ema_s or 0.0
        return RISK_SAFETY * ema + RISK_FLOOR_S

    def next_batch(self, queue: AdmissionQueue,
                   stop: threading.Event) -> Microbatch | None:
        """Block for the next micro-batch; None when ``stop`` is set (or
        every gathered request had already expired, or padding failed).

        Continuous-batching refill: when work is already queued at entry
        (the engine just freed with a backlog), collect runs with a zero
        window and fires immediately with everything gatherable — the
        idle-arrival coalescing window only applies when the queue was
        empty.

        Padding failure is CONTAINED here, not propagated: once requests
        have been taken off the queue, an escaping exception would kill
        the worker thread with those requests never reaching a terminal
        state — exactly the silent drop the accounting invariant exists
        to forbid.  A batch that cannot be padded terminates rejected
        (with the reason) and the worker lives on.
        """
        from csmom_tpu_torch.chaos.inject import checkpoint
        from csmom_tpu_torch.obs import metrics

        window_s = 0.0 if queue.depth() > 0 else self.max_wait_s
        reqs, reason = queue.collect(self.spec.max_batch, window_s, stop,
                                     risk_s=self.risk_margin_s())
        if not reqs:
            return None
        with self._lock:
            self.fire_reasons[reason] = self.fire_reasons.get(reason, 0) + 1
        checkpoint("serve.coalesce", kind=reqs[0].kind, n=len(reqs),
                   fire=reason)
        for r in reqs:
            # stage boundary: taken off the queue -> batch formed (the
            # coalesce bookkeeping); padding time gets its own clock next
            if r.trace is not None:
                r.trace.mark("coalesce").set(fire_reason=reason,
                                             batch_n=len(reqs))
        try:
            mb = self.pad(reqs)
            mb.fire_reason = reason
            for r in reqs:
                if r.trace is not None:
                    r.trace.mark("pad").set(
                        bucket=f"{mb.batch_bucket}x{mb.asset_bucket}")
            return mb
        except Exception as e:
            metrics.counter("serve.pad_failures").inc()
            reason_s = f"could not pad batch ({type(e).__name__}: {e})"[:200]
            for r in reqs:
                queue.finish_rejected(r, reason_s)
            return None

    def fire_reason_counts(self) -> dict:
        with self._lock:
            return dict(sorted(self.fire_reasons.items()))

    def pad(self, reqs: list) -> Microbatch:
        """Pad ``reqs`` (same endpoint, each ``values/mask`` = [A_i, M])
        into one bucket-shaped array pair."""
        kind = reqs[0].kind
        B = self.spec.batch_bucket_for(len(reqs))
        A = self.spec.asset_bucket_for(max(r.n_assets for r in reqs))
        if A is None:  # service.submit rejects oversize at the door
            raise ValueError(
                f"request exceeds the largest asset bucket "
                f"{self.spec.max_assets}")
        M = self.spec.months
        dtype = np.dtype(self.spec.dtype)
        values = np.zeros((B, A, M), dtype=dtype)
        mask = np.zeros((B, A, M), dtype=bool)
        for b, r in enumerate(reqs):
            v = np.asarray(r.values, dtype=dtype)
            m = np.asarray(r.mask, dtype=bool)
            if v.shape != (r.n_assets, M):
                raise ValueError(
                    f"request {r.req_id}: values shape {v.shape} does not "
                    f"match (n_assets={r.n_assets}, months={M})")
            if m.shape != v.shape:
                raise ValueError(
                    f"request {r.req_id}: mask shape {m.shape} does not "
                    f"match the values panel {v.shape}")
            values[b, :r.n_assets] = v
            mask[b, :r.n_assets] = m
        return Microbatch(kind=kind, requests=list(reqs), batch_bucket=B,
                          asset_bucket=A, values=values, mask=mask)
