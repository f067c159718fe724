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

The wrappers may be called from several threads at once (the shards of
:func:`csmom_tpu_torch.parallel.compat.shard_map`): each launch runs
under ``torch.cuda.device`` of its tensors (the runtime launches on the
thread's current device), and the C call and its count are made under
one lock, so no increment is lost and no thread changes a kernel's
shared-memory limit between another's setting and its launch.  The
launch is asynchronous, so the lock is held for the host side only.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from csmom_tpu_torch.ops import build

# the Pallas cohort kernel's limit at its default time tile
MAX_HOLD = 128


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


# each C entry point's arguments: pointers, then ints, then the stream
_ARGTYPES = {
    "decile_partial_sums": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                           + [ctypes.c_void_p],
    "cohort_partial_sums": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16
                           + [ctypes.c_void_p],
}


@functools.cache
def _entry(name: str, dtype: torch.dtype):
    """(library, C entry point) of kernel ``name`` for ``dtype``, its
    ctypes signature set once, when the library is loaded."""
    lib = build.load(name)
    fn = getattr(lib, f"csmom_{name}_" + ("f32" if dtype == torch.float32
                                          else "f64"))
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return lib, fn


def _stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# held around every C launch and every change of a launch count
_LAUNCH_LOCK = threading.RLock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under the launch lock."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def _launch(wrapper, lib, fn, t, what: str, *args) -> None:
    """Call the C entry point ``fn(*args, device, stream)`` for ``t``'s
    device under the launch lock, raise on its error code, and count
    one launch of ``wrapper``."""
    with _LAUNCH_LOCK, torch.cuda.device(t.device):
        code = fn(*args, t.device.index or 0, _stream(t))
        build.check(lib, code, what)
        count_launch(wrapper)


# -- K1: per-(bin, month) sums ---------------------------------------------

# K1's launch plan (csrc/decile_partial_sums.cu holds the same constants
# and re-checks every plan against the shapes)
_K1_LANES = 8         # month lanes per block, at most: V months each
_K1_THREADS = 128     # threads per block: lanes x asset groups
_K1_CLUSTER = 8       # asset slices per cluster: the portable cluster size
_K1_MIN_BLOCKS = 132  # one block on each of the H100's 132 SMs
_K1_GROUP_BINS = 16   # bins per block, at most; more go in groups
_GRID_Y_MAX = 65535


def _k1_smem(nb: int, lanes: int, groups: int, itemsize: int) -> int:
    """K1's dynamic shared memory: every thread's (sum, count) slot per
    (bin, month), ``2 * itemsize`` bytes each, then the block's sums and
    int32 counts of ``nb`` bins x ``lanes * V`` months."""
    v = 16 // itemsize
    return nb * v * lanes * groups * 2 * itemsize + nb * lanes * v * (itemsize + 4)


@functools.lru_cache(maxsize=64)
def _decile_plan(A: int, M: int, B: int, itemsize: int) -> dict:
    """K1's launch geometry, from the shapes alone (so the summation order
    is fixed).

    A thread takes ``v = 16 // itemsize`` consecutive months of a row (one
    16-byte load of returns where the row allows) and the assets ``g, g +
    groups, ...`` of its block's slice.  A block is ``lanes`` x ``groups``
    = 128 threads over a tile of ``lanes * v`` months and one of
    ``cluster`` slices of the asset axis; the slices of a tile form one
    thread block cluster, so ``grid[0] == cluster * month tiles``.  A
    block holds ``nb = min(B, 16)`` bins, and ``grid[1]`` runs over the
    ``ceil(B / nb)`` bin groups.  Lanes halve from 8 (a warp reads 128
    bytes of a row in f32) until the grid has at least 132 blocks or one
    lane is left.  ``smem`` is the dynamic shared
    memory (:func:`_k1_smem`).  Raises ``ValueError`` when the bin groups
    exceed the grid's y limit.  Cached by shape: callers must not change
    the dict.
    """
    nb = min(B, _K1_GROUP_BINS)
    n_bg = -(-B // nb)
    if n_bg > _GRID_Y_MAX:
        raise ValueError(f"decile_partial_sums: n_bins={B}, at most "
                         f"{_GRID_Y_MAX * _K1_GROUP_BINS} (bin groups of "
                         f"{_K1_GROUP_BINS} on the grid's y axis)")
    v = 16 // itemsize
    lanes = _K1_LANES
    while lanes > 1 and _K1_CLUSTER * -(-M // (lanes * v)) * n_bg < _K1_MIN_BLOCKS:
        lanes //= 2
    groups = _K1_THREADS // lanes
    return {
        "v": v, "lanes": lanes, "groups": groups, "nb": nb,
        "cluster": _K1_CLUSTER,
        "grid": (_K1_CLUSTER * -(-M // (lanes * v)), n_bg),
        "smem": _k1_smem(nb, lanes, groups, itemsize),
    }


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
    A, M = ret.shape
    plan = _decile_plan(A, M, int(n_bins), ret.element_size())
    if ret.device.type == "cpu":
        return decile_partial_sums_plain(ret, labels, n_bins)

    sums = torch.empty((n_bins, M), dtype=ret.dtype, device=ret.device)
    counts = torch.empty_like(sums)
    if A == 0 or M == 0:
        return sums.zero_(), counts.zero_()
    lib, fn = _entry("decile_partial_sums", ret.dtype)
    _launch(decile_partial_sums, lib, fn, ret, what,
            labels.data_ptr(), ret.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), A, M, int(n_bins), plan["v"], plan["lanes"],
            plan["groups"], plan["nb"], plan["cluster"], *plan["grid"],
            plan["smem"])
    return sums, counts


decile_partial_sums.launches = 0
# the CUDA kernels one call launches, by name (csrc/decile_partial_sums.cu)
decile_partial_sums.device_kernels = ("decile_tile_kernel",)


# -- K2: cohort x horizon sums ---------------------------------------------

# K2's launch plan (csrc/cohort_partial_sums.cu holds the same constants
# and re-checks every plan against the shapes)
_K2_TS = 32          # formation months per block
_K2_TA = 32          # assets per staged tile
_K2_HC = 16          # horizons per chunk, held in registers
_K2_W = 48           # staged months per ret/valid row: TS + HC, 16-aligned
_K2_JG = 8           # Js per block, at most
_K2_THREADS = 256    # threads per block: groups of assets fill it
_K2_CLUSTER = 8      # asset slices per cluster: the portable cluster size
_K2_STAGES = 2       # staged tiles in flight
_K2_MIN_BLOCKS = 264  # two blocks on each of the H100's 132 SMs
# a thread keeps both sides' counts in one uint32, 16 bits each, so an
# asset slice holds at most this many assets
_K2_SLICE_MAX = 65535
MAX_ASSETS = _K2_CLUSTER * _K2_SLICE_MAX


def _k2_smem(jg: int, hc: int, groups: int, itemsize: int,
             stages: int = _K2_STAGES) -> int:
    """K2's dynamic shared memory: the larger of ``stages`` staged tiles
    (ret, labels, valid) plus two tiles in use (r and valid, 2 x itemsize
    each) and the cluster reduction's buffers (sums and int32 counts of
    the block's ``groups`` x outputs)."""
    stage = _K2_TA * _K2_W * itemsize + jg * _K2_TA * _K2_TS * 4 + _K2_TA * _K2_W
    tiles = stages * stage + 2 * _K2_TA * _K2_W * 2 * itemsize
    reduce = groups * jg * 2 * _K2_TS * hc * (itemsize + 4)
    return max(tiles, reduce)


@functools.lru_cache(maxsize=64)
def _cohort_plan(nJ: int, A: int, M: int, H: int, itemsize: int) -> dict:
    """K2's launch geometry, from the shapes alone (so the summation order
    is fixed).

    A block owns ``ts`` formation months, a group of ``jg`` Js, one chunk
    of ``hc`` horizons and one of ``cluster`` slices of the asset axis,
    which it walks in staged tiles of ``ta`` assets.  Its threads are
    ``groups`` x ``jg`` x ``ts``: one per (asset group, j, month), each
    group summing every ``groups``-th asset of a tile.  The slices of one
    (month tile, J group, horizon chunk) form one thread block cluster,
    so ``grid[0] == cluster``; ``grid[2]`` runs over the J groups, each
    with its ``ceil(H / hc)`` horizon chunks.  The J group halves from
    ``min(nJ, 8)`` until the grid has at least 264 blocks (two per SM) or
    one J is left.  ``smem`` is the dynamic shared memory
    (:func:`_k2_smem`).  Raises ``ValueError`` for more than
    ``MAX_ASSETS`` assets.  Cached by shape: callers must not change the
    dict.
    """
    if A > MAX_ASSETS:
        raise ValueError(f"cohort_partial_sums: A={A} assets, at most "
                         f"{MAX_ASSETS} ({_K2_CLUSTER} asset slices of "
                         f"{_K2_SLICE_MAX}, the kernel's 16-bit counts)")
    hc = min(H, _K2_HC)
    n_hc = -(-H // hc)
    n_mt = -(-M // _K2_TS)
    jg = max(1, min(nJ, _K2_JG))
    while jg > 1 and n_mt * -(-nJ // jg) * n_hc * _K2_CLUSTER < _K2_MIN_BLOCKS:
        jg = -(-jg // 2)
    groups = max(1, _K2_THREADS // (jg * _K2_TS))
    return {
        "ts": _K2_TS, "ta": _K2_TA, "jg": jg, "hc": hc, "groups": groups,
        "cluster": _K2_CLUSTER,
        "grid": (_K2_CLUSTER, n_mt, -(-nJ // jg) * n_hc),
        "smem": _k2_smem(jg, hc, groups, itemsize),
    }


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

    At most ``MAX_ASSETS`` assets (``ValueError`` above, on every device).

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
    nJ, A, M = labels.shape
    H = int(max_hold)
    plan = _cohort_plan(nJ, A, M, H, ret.element_size())  # refuses A > MAX_ASSETS
    if ret.device.type == "cpu":
        return cohort_partial_sums_plain(ret, ret_valid, labels, n_bins,
                                         max_hold)

    sums = torch.empty((nJ, 2, M, H), dtype=ret.dtype, device=ret.device)
    counts = torch.empty_like(sums)
    if nJ == 0 or A == 0 or M == 0:
        return sums.zero_(), counts.zero_()
    lib, fn = _entry("cohort_partial_sums", ret.dtype)
    _launch(cohort_partial_sums, lib, fn, ret, what,
            labels.data_ptr(), ret.data_ptr(), ret_valid.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), nJ, A, M, H, int(n_bins),
            plan["ts"], plan["ta"], plan["jg"], plan["hc"], plan["groups"],
            plan["cluster"], *plan["grid"], plan["smem"])
    return sums, counts


cohort_partial_sums.launches = 0
# the CUDA kernels one call launches, by name (csrc/cohort_partial_sums.cu)
cohort_partial_sums.device_kernels = ("cohort_tile_kernel",)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    with _LAUNCH_LOCK:
        decile_partial_sums.launches = 0
        cohort_partial_sums.launches = 0
