"""The aggregation kernels of both engines, with their plain versions.

Counterpart of :mod:`csmom_tpu.ops.pallas_kernels`:

- :func:`decile_partial_sums` (K1) replaces ``decile_partial_sums_pallas``
  — the monthly engine's per-(bin, month) sums and counts;
- :func:`cohort_partial_sums` (K2) replaces ``cohort_partial_sums_pallas``
  — the grid's cohort x horizon sums and counts, every J in one launch.

Each wrapper checks its inputs (on every device), then launches the CUDA
kernel for CUDA tensors (``csrc/<name>.cu``, built on first use) or runs
the plain PyTorch version beside it for CPU tensors.  Nothing falls back:
a CUDA tensor either goes through the kernel or raises.  Each wrapper's
``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from csmom_tpu_torch.ops import build

# the Pallas cohort kernel's limit at its default time tile
MAX_HOLD = 128
# enough blocks to fill 132 SMs a few times over
_TARGET_BLOCKS = 528


def _check_float(ret, what: str):
    if ret.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"{what}: ret must be float32 or float64, got {ret.dtype} "
            "(bf16 kernels are not written yet)"
        )


def _check_launchable(*tensors, what: str):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {dev}")


def _stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _chunks(A: int, base_blocks: int, min_chunk: int) -> tuple:
    """(chunk size, chunk count) for the asset axis: enough chunks that
    ``base_blocks * n_chunks`` fills the card, each at least ``min_chunk``
    assets.  Depends on shapes only, so the summation order is fixed."""
    want = -(-_TARGET_BLOCKS // max(base_blocks, 1))
    n = max(1, min(want, -(-A // min_chunk), 65535 // max(base_blocks, 1)))
    chunk = -(-A // n)
    return chunk, -(-A // chunk)


# -- K1: per-(bin, month) sums ---------------------------------------------

def decile_partial_sums_plain(ret, labels, n_bins: int):
    """One-hot form: ``(sums f[B, M], counts f[B, M])`` in ret's dtype."""
    bins = torch.arange(n_bins, dtype=labels.dtype, device=labels.device)
    member = labels[None, :, :] == bins[:, None, None]     # [B, A, M]
    sums = (member * ret[None, :, :]).sum(dim=1)
    counts = member.sum(dim=1).to(ret.dtype)
    return sums, counts


def decile_partial_sums(ret, labels, n_bins: int):
    """Per-(bin, month) sums of ``ret`` and member counts over assets.

    Args:
      ret: f32/f64[A, M] returns, zeroed at non-members.
      labels: i32[A, M] bin ids, -1 where unranked or invalid.
      n_bins: B >= 1; labels outside ``[0, B)`` join no bin.

    Returns ``(sums f[B, M], counts f[B, M])`` in ret's dtype.
    """
    what = "decile_partial_sums"
    _check_float(ret, what)
    if labels.dtype != torch.int32:
        raise TypeError(f"{what}: labels must be int32, got {labels.dtype}")
    if ret.dim() != 2 or labels.shape != ret.shape:
        raise ValueError(f"{what}: ret {tuple(ret.shape)} and labels "
                         f"{tuple(labels.shape)} must be the same [A, M]")
    if int(n_bins) < 1:
        raise ValueError(f"{what}: n_bins must be >= 1, got {n_bins}")
    _check_launchable(ret, labels, what=what)
    if ret.device.type == "cpu":
        return decile_partial_sums_plain(ret, labels, n_bins)

    A, M = ret.shape
    sums = torch.empty((n_bins, M), dtype=ret.dtype, device=ret.device)
    counts = torch.empty_like(sums)
    if A == 0 or M == 0:
        return sums.zero_(), counts.zero_()
    base = -(-M // 128) * -(-n_bins // 16)
    chunk, n_chunks = _chunks(A, base, 16)
    part_sums = torch.empty((n_chunks, n_bins, M), dtype=ret.dtype,
                            device=ret.device)
    part_counts = torch.empty((n_chunks, n_bins, M), dtype=torch.int32,
                              device=ret.device)
    lib = build.load("decile_partial_sums")
    fn = (lib.csmom_decile_partial_sums_f32 if ret.dtype == torch.float32
          else lib.csmom_decile_partial_sums_f64)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    code = fn(labels.data_ptr(), ret.data_ptr(), part_sums.data_ptr(),
              part_counts.data_ptr(), sums.data_ptr(), counts.data_ptr(),
              A, M, int(n_bins), chunk, ret.device.index or 0, _stream(ret))
    build.check(lib, code, what)
    decile_partial_sums.launches += 1
    return sums, counts


decile_partial_sums.launches = 0


# -- K2: cohort x horizon sums ---------------------------------------------

def cohort_partial_sums_plain(ret, ret_valid, labels, n_bins: int,
                              max_hold: int):
    """Rolled form over any leading axes of ``labels [..., A, M]``:
    ``(sums f[..., 2, M, H], counts f[..., 2, M, H])``."""
    M = ret.shape[-1]
    top = labels == (n_bins - 1)
    bot = labels == 0
    rf = torch.where(ret_valid, torch.nan_to_num(ret), 0.0)
    count_dtype = torch.promote_types(rf.dtype, torch.float32)
    months = torch.arange(M, device=ret.device)
    sums, counts = [], []
    for h in range(1, max_hold + 1):
        # member return h months after formation: ret[:, s+h]
        r_h = torch.roll(rf, -h, dims=-1)
        v_h = torch.roll(ret_valid, -h, dims=-1) & (months < M - h)
        side_s, side_c = [], []
        for mem in (bot, top):
            m = mem & v_h
            side_s.append(torch.where(m, r_h, 0.0).sum(dim=-2))
            side_c.append(m.sum(dim=-2).to(count_dtype))
        sums.append(torch.stack(side_s, dim=-2))
        counts.append(torch.stack(side_c, dim=-2))
    return torch.stack(sums, dim=-1), torch.stack(counts, dim=-1)


def cohort_partial_sums(ret, ret_valid, labels, n_bins: int = 10,
                        max_hold: int = 12):
    """Cohort forward-return sums and counts for every J at once.

    Args:
      ret: f32/f64[A, M] next-month returns (raw; NaN allowed).
      ret_valid: bool[A, M].
      labels: i32[nJ, A, M] decile ids at formation, -1 = unranked.
      n_bins: B; side 0 is label 0, side 1 is label B-1.
      max_hold: H, 1 <= H <= 128.

    Returns ``(sums f[nJ, 2, M, H], counts f[nJ, 2, M, H])``; horizon
    h-1 of formation month s holds the members' returns at s+h, and
    months past the panel end contribute nothing.
    """
    what = "cohort_partial_sums"
    if max_hold > MAX_HOLD:
        raise ValueError(f"{what}: max_hold={max_hold} must be <= {MAX_HOLD}")
    if max_hold < 1:
        raise ValueError(f"{what}: max_hold={max_hold} must be >= 1")
    _check_float(ret, what)
    if labels.dtype != torch.int32:
        raise TypeError(f"{what}: labels must be int32, got {labels.dtype}")
    if ret_valid.dtype != torch.bool:
        raise TypeError(f"{what}: ret_valid must be bool, got {ret_valid.dtype}")
    if (ret.dim() != 2 or ret_valid.shape != ret.shape or labels.dim() != 3
            or labels.shape[1:] != ret.shape):
        raise ValueError(f"{what}: need ret/ret_valid [A, M] and labels "
                         f"[nJ, A, M], got {tuple(ret.shape)}, "
                         f"{tuple(ret_valid.shape)}, {tuple(labels.shape)}")
    _check_launchable(ret, ret_valid, labels, what=what)
    if ret.device.type == "cpu":
        return cohort_partial_sums_plain(ret, ret_valid, labels, n_bins,
                                         max_hold)

    nJ, A, M = labels.shape
    H = int(max_hold)
    sums = torch.empty((nJ, 2, M, H), dtype=ret.dtype, device=ret.device)
    counts = torch.empty_like(sums)
    if nJ == 0 or A == 0 or M == 0:
        return sums.zero_(), counts.zero_()
    base = -(-M // 128) * -(-H // 4) * nJ
    chunk, n_chunks = _chunks(A, base, 32)
    part_sums = torch.empty((n_chunks, nJ, 2, H, M), dtype=ret.dtype,
                            device=ret.device)
    part_counts = torch.empty((n_chunks, nJ, 2, H, M), dtype=torch.int32,
                              device=ret.device)
    lib = build.load("cohort_partial_sums")
    fn = (lib.csmom_cohort_partial_sums_f32 if ret.dtype == torch.float32
          else lib.csmom_cohort_partial_sums_f64)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    code = fn(labels.data_ptr(), ret.data_ptr(), ret_valid.data_ptr(),
              part_sums.data_ptr(), part_counts.data_ptr(), sums.data_ptr(),
              counts.data_ptr(), nJ, A, M, H, int(n_bins), chunk,
              ret.device.index or 0, _stream(ret))
    build.check(lib, code, what)
    cohort_partial_sums.launches += 1
    return sums, counts


cohort_partial_sums.launches = 0


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    decile_partial_sums.launches = 0
    cohort_partial_sums.launches = 0
