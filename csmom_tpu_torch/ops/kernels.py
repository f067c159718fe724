"""The aggregation kernels of both engines, with their plain versions.

Counterpart of :mod:`csmom_tpu.ops.pallas_kernels`:

- :func:`decile_partial_sums` (K1) replaces ``decile_partial_sums_pallas``
  — the monthly engine's per-(bin, month) sums and counts;
- :func:`cohort_partial_sums` (K2) replaces ``cohort_partial_sums_pallas``
  — the grid's cohort x horizon sums and counts, every J in one launch;
- :func:`rank_labels` (K3) replaces no TPU kernel (the JAX package's rank
  mode sorts in XLA) — ``mode="rank"`` labels of every (lead, month) row
  of a ``[..., A, M]`` panel in one launch, in place of a transposed
  copy, an int64 sort and its boundary passes;
- :func:`ridge_moments` (K4) replaces no TPU kernel (the JAX package
  leaves its ridge to XLA) — the intraday ridge fit with its expanding
  time-series CV from one pass of segment co-moments over the design and
  one pass of scores, in place of the harness's ~30 masked passes.

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
import math
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
    "rank_labels": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p],
    "ridge_moments": [ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 3 + [ctypes.c_double] * 3
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
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


# -- K3: rank-mode labels ---------------------------------------------------

# K3's instances (threads, items), by capacity: a row of A lanes takes the
# smallest that holds it (csrc/rank_labels.cu holds the same list and
# re-checks every plan against the row width)
_RANK_PLANS = ((128, 1), (128, 4), (256, 4), (256, 8), (256, 12), (512, 8),
               (512, 16))
# the widest row K3 takes; wider rows take the plain sort path
RANK_MAX_LANES = _RANK_PLANS[-1][0] * _RANK_PLANS[-1][1]


def rank_route(A: int, dtype: torch.dtype, device) -> str:
    """Where ``mode="rank"`` labels of rows of ``A`` lanes are computed:
    ``"plain"`` for a CPU tensor (:func:`rank_labels_plain`), ``"kernel"``
    (K3) for a CUDA row of at most :data:`RANK_MAX_LANES` lanes, ``"sort"``
    (the plain sort, on the card) for a wider one.  Raises ``TypeError``
    for a dtype other than float32/float64 and ``ValueError`` for another
    device type."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rank_labels: x must be float32 or float64, got {dtype}")
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise ValueError(f"rank_labels: unsupported device {device}")
    return "kernel" if A <= RANK_MAX_LANES else "sort"


def _rank_plan(A: int) -> tuple:
    """K3's ``(threads, items)`` for rows of ``A <= RANK_MAX_LANES`` lanes:
    the smallest instance of :data:`_RANK_PLANS` that holds a row."""
    return next(p for p in _RANK_PLANS if p[0] * p[1] >= A)


def rank_labels_plain(x, valid, n_bins: int):
    """The plain version: the panel's months as rows ``[..., M, A]``
    through :func:`~csmom_tpu_torch.ops.ranking._rank_labels` (one stable
    sort), ``(labels i32[..., A, M], n_eff i32[..., M])``."""
    # imported here: the ranking module imports this one
    from csmom_tpu_torch.ops.ranking import _assign_panel_rows

    return _assign_panel_rows(x, valid, n_bins, "rank")


def rank_labels(x, valid, n_bins: int = 10):
    """``mode="rank"`` decile labels of every date of ``[..., A, M]``
    panels: ``floor(pct_rank * n_bins)`` capped at ``n_bins - 1``, ties by
    position, over each (lead, month) row's valid lanes.

    Args:
      x: f32/f64[..., A, M] (any strides; NaN allowed at invalid lanes).
      valid: bool[..., A, M] (any strides).
      n_bins: B >= 1.

    Returns ``(labels i32[..., A, M] with -1 at invalid lanes, n_eff
    i32[..., M] = min(valid lanes, B))``, the same bits on every route
    (:func:`rank_route`).  Rows wider than :data:`RANK_MAX_LANES` on the
    card take the plain sort and add to ``rank_labels.wide_rows``.
    """
    what = "rank_labels"
    if valid.dtype != torch.bool:
        raise TypeError(f"{what}: valid must be bool, got {valid.dtype}")
    if x.dim() < 2 or valid.shape != x.shape:
        raise ValueError(f"{what}: x {tuple(x.shape)} and valid "
                         f"{tuple(valid.shape)} must be the same [..., A, M]")
    if x.device != valid.device:
        raise ValueError(f"{what}: inputs on {x.device} and {valid.device}")
    if int(n_bins) < 1:
        raise ValueError(f"{what}: n_bins must be >= 1, got {n_bins}")
    A, M = x.shape[-2:]
    lead = x.shape[:-2]
    route = rank_route(A, x.dtype, x.device)
    if route != "kernel":
        if route == "sort":
            with _LAUNCH_LOCK:
                rank_labels.wide_rows += x.numel() // A
        return rank_labels_plain(x, valid, int(n_bins))

    # views where the strides allow (a stride-0 lead axis included)
    L = math.prod(lead)
    x3, v3 = x.reshape(L, A, M), valid.reshape(L, A, M)
    labels = torch.empty((L, A, M), dtype=torch.int32, device=x.device)
    n_eff = torch.empty((L, M), dtype=torch.int32, device=x.device)
    if A == 0:
        n_eff.zero_()
    elif L and M:
        # the kernel writes every label and every row's n_eff
        threads, items = _rank_plan(A)
        lib, fn = _entry("rank_labels", x.dtype)
        _launch(rank_labels, lib, fn, x, what,
                x3.data_ptr(), v3.data_ptr(), labels.data_ptr(),
                n_eff.data_ptr(), L, A, M, int(n_bins), *x3.stride(),
                *v3.stride(), threads, items)
    return labels.reshape(*lead, A, M), n_eff.reshape(*lead, M)


rank_labels.launches = 0
# rows of calls routed to the plain sort on the card (A > RANK_MAX_LANES)
rank_labels.wide_rows = 0
# the CUDA kernels one call launches, by name (csrc/rank_labels.cu)
rank_labels.device_kernels = ("rank_labels_kernel",)


# -- K4: the ridge fit from segment co-moments ------------------------------

# K4's launch plan (csrc/ridge_moments.cu holds the same constants and
# re-checks every plan against the row count)
_K4_TILE = 1024        # rows a block stages at once: 256 threads x 4 rows
_K4_MAX_BLOCKS = 528   # moment blocks at most: four on each of 132 SMs
# the kernel's widths: the five minute features, up to 32 folds
RIDGE_FEATURES = 5
RIDGE_MAX_SPLITS = 32
# a segment partial's floats: the means of the features and the label,
# then their 21 co-moments
_K4_PARTIAL = 27


def _ridge_plan(N: int) -> tuple:
    """K4's ``(blocks, tiles a block)`` for ``N`` rows, from the row count
    alone (so the summation order is fixed): the rows' ``ceil(N / 1024)``
    tiles in at most 528 contiguous chunks of equal tile counts, the last
    one shorter; ``(1, 0)`` for no rows."""
    tiles = -(-N // _K4_TILE)
    if tiles == 0:
        return 1, 0
    per = -(-tiles // min(tiles, _K4_MAX_BLOCKS))
    return -(-tiles // per), per


def ridge_segments(valid, n_splits: int, train_frac: float,
                   train_frac_small: float, small_threshold: int, dtype):
    """The rows' segments of the expanding time-series CV, as the harness
    (``models/ridge.py::time_series_cv_harness``) lays its folds out:
    ``(seg i64[A*R], n_train i32[])``.  The training rows are the valid
    rows whose global ordinal (valid rows before them in (asset, row)
    order) is below ``n_train = floor(n_total * frac)`` (computed in
    ``dtype``; ``frac`` is ``train_frac_small`` at or below
    ``small_threshold`` rows); with ``ts = n_train // (n_splits + 1)``,
    segment 0 holds ordinals ``[0, n_train - n_splits * ts)`` and segments
    1..n_splits the following blocks of ``ts``.  ``seg`` is -1 off the
    training rows."""
    vf = valid.reshape(-1)
    ordinal = torch.cumsum(vf, 0) - 1
    n_total = torch.sum(vf)
    frac = torch.where(n_total > small_threshold,
                       torch.tensor(train_frac, dtype=dtype, device=vf.device),
                       torch.tensor(train_frac_small, dtype=dtype, device=vf.device))
    n_train = torch.floor(n_total.to(dtype) * frac).to(torch.int32)
    ts = torch.div(n_train, n_splits + 1, rounding_mode="floor")
    b1 = n_train - n_splits * ts
    seg = torch.where(ordinal < b1, 0,
                      1 + torch.div(ordinal - b1, torch.clamp(ts, min=1),
                                    rounding_mode="floor"))
    return torch.where(vf & (ordinal < n_train), seg, -1), n_train


def _chan(a, b):
    """Merge of ``(n, mean [..., C], M2 [..., C, C])`` moment sets,
    elementwise over the leading axes: Chan et al.'s pairwise formula,
    exact where one side is empty (mean and M2 zero)."""
    (na, ma, Ma), (nb, mb, Mb) = a, b
    n = na + nb
    f = nb.to(ma.dtype) / torch.clamp(n, min=1).to(ma.dtype)
    g = na.to(ma.dtype) * f
    d = mb - ma
    return (n, ma + d * f[..., None],
            Ma + Mb + d[..., :, None] * d[..., None, :] * g[..., None, None])


def segment_moments_plain(Z, seg, n_seg: int, tile: int = _K4_TILE):
    """Each segment's ``(n i64[S], mean [S, C], M2 [S, C, C])`` of the rows
    ``Z [N, C]``: per tile of ``tile`` rows two passes (the mean, then the
    centred products), then the tiles merged in a pairwise tree with
    :func:`_chan`."""
    N, C = Z.shape
    T = max(-(-N // tile), 1)
    pad = T * tile - N
    Zt = torch.nn.functional.pad(Z, (0, 0, 0, pad)).reshape(T, tile, C)
    st = torch.nn.functional.pad(seg, (0, pad), value=-1).reshape(T, tile)
    ns, means, m2s = [], [], []
    for s in range(n_seg):
        w = st == s
        n = w.sum(1)
        Zw = torch.where(w[..., None], Zt, 0)
        mean = Zw.sum(1) / torch.clamp(n, min=1).to(Z.dtype)[:, None]
        Zc = torch.where(w[..., None], Zt - mean[:, None], 0)
        ns.append(n)
        means.append(mean)
        m2s.append(Zc.transpose(1, 2) @ Zc)
    n, mean, M2 = torch.stack(ns), torch.stack(means), torch.stack(m2s)
    while n.shape[1] > 1:
        h = n.shape[1] // 2
        merged = _chan((n[:, :2 * h:2], mean[:, :2 * h:2], M2[:, :2 * h:2]),
                       (n[:, 1:2 * h:2], mean[:, 1:2 * h:2], M2[:, 1:2 * h:2]))
        n, mean, M2 = (torch.cat([m, x[:, 2 * h:]], 1)
                       for m, x in zip(merged, (n, mean, M2)))
    return n[:, 0], mean[:, 0], M2[:, 0]


def ridge_from_moments(n, mean, M2, alpha: float):
    """The ridge fits with their expanding CV from segment moments ``(n
    [S], mean [S, F + 1], M2 [S, F + 1, F + 1])`` (features, then the
    label): ``(coef f[S, F], intercept f[S], scale_mean f[F], scale_std
    f[F], cv_mse f[S - 1])``.  The scaler is the union of every segment
    (ddof 0, std -> 1 where at most ``1e-12 max(|mean|, 1)``); fit k solves
    the scaled, centred normal equations of segments 0..k plus ``alpha
    I``, and fold k's MSE on segment k + 1 follows from that segment's
    moments in closed form (0 where it is empty); the last fit, on every
    segment, is the final one."""
    S, C = mean.shape
    F = C - 1
    unions = [(n[0], mean[0], M2[0])]
    for s in range(1, S):
        unions.append(_chan(unions[-1], (n[s], mean[s], M2[s])))
    nU, mU, MU = (torch.stack(u) for u in zip(*unions))
    m = mU[-1, :F]
    std = torch.sqrt(torch.diagonal(MU[-1])[:F]
                     / torch.clamp(nU[-1], min=1).to(mean.dtype))
    std = torch.where(std > 1e-12 * torch.clamp(m.abs(), min=1.0), std, 1.0)
    eye = torch.eye(F, dtype=mean.dtype, device=mean.device)
    G = MU[:, :F, :F] / (std[:, None] * std[None, :]) + alpha * eye
    beta = torch.linalg.solve_ex(G, MU[:, :F, F] / std).result
    icept = mU[:, F] - (((mU[:, :F] - m) / std) * beta).sum(-1)
    # fold k (fit k) on segment k + 1
    bp, Mt = beta[:-1] / std, M2[1:]
    q = (torch.einsum("ki,kij,kj->k", bp, Mt[:, :F, :F], bp)
         - 2 * (bp * Mt[:, :F, F]).sum(-1) + Mt[:, F, F])
    d = (((mean[1:, :F] - m) / std) * beta[:-1]).sum(-1) + icept[:-1] - mean[1:, F]
    nt = n[1:]
    cv = torch.where(nt > 0, torch.clamp(q, min=0) / torch.clamp(nt, min=1).to(q.dtype)
                     + d * d, 0.0)
    return beta, icept, m, std, cv


def ridge_moments_plain(features, y, valid, n_splits: int, alpha: float,
                        train_frac: float, train_frac_small: float,
                        small_threshold: int, tile: int = _K4_TILE):
    """K4's arithmetic in PyTorch: :func:`ridge_segments`, the segments'
    moments of ``[nan_to_num(features), nan_to_num(y)]`` by tile
    (:func:`segment_moments_plain`), :func:`ridge_from_moments`, then the
    scores.  Returns :func:`ridge_moments`' tuple."""
    A, R, F = features.shape
    dt = features.dtype
    seg, n_train = ridge_segments(valid, n_splits, train_frac, train_frac_small,
                                  small_threshold, dt)
    Xf = torch.nan_to_num(features.reshape(A * R, F))
    Z = torch.cat([Xf, torch.nan_to_num(y.reshape(A * R, 1))], 1)
    moments = segment_moments_plain(Z, seg, n_splits + 1, tile)
    coefs, icepts, mean, std, cv = ridge_from_moments(*moments, alpha)
    coef, icept = coefs[-1], icepts[-1]
    scores = (((Xf - mean) / std) @ coef + icept).reshape(A, R)
    return (coef, icept, mean, std, cv, torch.where(valid, scores, torch.nan),
            n_train)


def ridge_moments(features, y, valid, n_splits: int = 3, alpha: float = 1.0,
                  train_frac: float = 0.7, train_frac_small: float = 0.6,
                  small_threshold: int = 100):
    """Ridge regression with expanding time-series CV over the training
    rows, and the scores of every valid row: the fit of
    ``models/ridge.py::time_series_cv_harness`` with its ridge solver, from
    segment co-moments (:func:`ridge_segments`, :func:`ridge_from_moments`).

    Args:
      features: f32/f64[A, R, F] (NaN allowed; read with ``nan_to_num``).
      y: [A, R] labels in the features' dtype.
      valid: bool[A, R] modeling rows.
      n_splits: CV folds, at least 1.
      alpha: the ridge penalty.
      train_frac, train_frac_small, small_threshold: the training block's
        share of the valid rows, and the small-panel rule.

    Returns ``(coef f[F], intercept f[], scale_mean f[F], scale_std f[F],
    cv_mse f[n_splits], scores f[A, R] with NaN off the valid rows,
    n_train i32[])``, on the inputs' device, with no wait on the host.  A
    CUDA call is one launch of K4 (four CUDA kernels) and adds its A * R
    rows to ``ridge_moments.rows``; it takes F = 5 and n_splits <= 32
    (``ValueError`` otherwise, on the card only).
    """
    what = "ridge_moments"
    _check_float(features, what)
    if y.dtype != features.dtype:
        raise TypeError(f"{what}: y is {y.dtype}, features {features.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"{what}: valid must be bool, got {valid.dtype}")
    if (features.dim() != 3 or y.shape != features.shape[:2]
            or valid.shape != y.shape):
        raise ValueError(f"{what}: need features [A, R, F], y and valid [A, R], "
                         f"got {tuple(features.shape)}, {tuple(y.shape)}, "
                         f"{tuple(valid.shape)}")
    if int(n_splits) < 1:
        raise ValueError(f"{what}: n_splits must be >= 1, got {n_splits}")
    A, R, F = features.shape
    dev = features.device
    if y.device != dev or valid.device != dev:
        raise ValueError(f"{what}: inputs on {dev}, {y.device} and {valid.device}")
    if dev.type == "cpu":
        return ridge_moments_plain(features, y, valid, int(n_splits), float(alpha),
                                   float(train_frac), float(train_frac_small),
                                   int(small_threshold))
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if F != RIDGE_FEATURES or int(n_splits) > RIDGE_MAX_SPLITS:
        raise ValueError(f"{what}: the kernel takes {RIDGE_FEATURES} features and "
                         f"at most {RIDGE_MAX_SPLITS} splits, got {F} and {n_splits}")
    # contiguous and 16-byte aligned: the kernel stages rows with 16-byte copies
    x, yy, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                else t.clone(memory_format=torch.contiguous_format)
                for t in (features, y, valid))
    N, S = A * R, int(n_splits) + 1
    blocks, per = _ridge_plan(N)
    dt = features.dtype
    counts = torch.empty(blocks, dtype=torch.int32, device=dev)
    part = torch.empty((S, blocks, _K4_PARTIAL), dtype=dt, device=dev)
    part_n = torch.empty((S, blocks), dtype=torch.int64, device=dev)
    fit = torch.empty(3 * F + 1 + S - 1, dtype=dt, device=dev)
    n_train = torch.empty((), dtype=torch.int32, device=dev)
    scores = torch.empty((A, R), dtype=dt, device=dev)
    lib, fn = _entry("ridge_moments", dt)
    _launch(ridge_moments, lib, fn, x, what,
            x.data_ptr(), yy.data_ptr(), v.data_ptr(), counts.data_ptr(),
            part.data_ptr(), part_n.data_ptr(), fit.data_ptr(), n_train.data_ptr(),
            scores.data_ptr(), N, S, blocks, per, float(alpha), float(train_frac),
            float(train_frac_small), int(small_threshold))
    with _LAUNCH_LOCK:
        ridge_moments.rows += N
    return (fit[:F], fit[F], fit[F + 1:2 * F + 1], fit[2 * F + 1:3 * F + 1],
            fit[3 * F + 1:], scores, n_train)


ridge_moments.launches = 0
# rows of the design the kernel has passed over (A * R a call)
ridge_moments.rows = 0
# the CUDA kernels one call launches, by name (csrc/ridge_moments.cu)
ridge_moments.device_kernels = ("ridge_count_kernel", "ridge_moments_kernel",
                                "ridge_solve_kernel", "ridge_score_kernel")


def reset_launches() -> None:
    """Set every kernel's launch count, K3's wide-row count and K4's row
    count to 0."""
    with _LAUNCH_LOCK:
        decile_partial_sums.launches = 0
        cohort_partial_sums.launches = 0
        rank_labels.launches = 0
        rank_labels.wide_rows = 0
        ridge_moments.launches = 0
        ridge_moments.rows = 0
