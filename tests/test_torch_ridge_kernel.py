"""Kernel K4 (``ops/kernels.py::ridge_moments``, ``csrc/ridge_moments.cu``):
its arithmetic emulated in NumPy (blocks, tiles, each thread's shifted
sums, the fixed merge trees, the Cholesky solves) against the plain
version, its plan against the source, and its input checks.

The ``card`` cases run only on a CUDA card (skipped here); this file
imports no JAX, so on the card it runs without the suite's conftest:
``python -m pytest --noconftest -m card tests/test_torch_ridge_kernel.py``.

Tolerances of the kernel against the plain version.  Both compute the
same segment moments and the same closed form; they differ in the order
of their sums (a thread's shifted sums over its rows and Chan merges in
the kernel's trees, against two passes a tile and a pairwise tree of
tiles) and in the solve (Cholesky against LU).  Each moment moves by a
few units of rounding times the rows' spread about the shift, and the
fit by that times the condition number of G (under 10 on these designs,
whose features are independent): f64 ``1e-12`` of each quantity's scale
(the coefficients' and intercept's largest magnitude, each CV MSE, the
scores' RMS), f32 ``1e-4`` (a unit of f32 rounding is 6e-8; the f32
moments over ~10^5 rows carry a few hundred of them).  Where the features
sit far from zero against their spread, the inputs themselves hold only
``u max_f |m_f| / s_f`` of that spread (the design offset to 5e6 with a
spread of 1e2 holds it to 1e-11): every tolerance is multiplied by
``kappa = 1 + max_f |m_f| / s_f``.  A score is ``((x - m) / s) . coef +
intercept``, and so is the intercept's centring term: one unit of
rounding in ``m`` moves them by ``u sum_f |m_f| / s_f |coef_f|``, so that
sum joins the scale of the scores and of the intercept.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from csmom_tpu_torch import models
from csmom_tpu_torch.ops import kernels

torch.set_num_threads(2)

SRC = Path(kernels.__file__).resolve().parent.parent / "csrc" / "ridge_moments.cu"
F64_REL, F32_REL = 1e-12, 1e-4


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC.read_text()).group(1))


THREADS, ROWS, WARPS = _const("kThreads"), _const("kRows"), _const("kThreads") // 32
TILE = THREADS * ROWS


def _design(seed, A, R, holes=0.15, offset=0.0, spread=1.0, n_valid=None,
            dtype=np.float64):
    """A seeded ``[A, R, 5]`` design, labels linear in it plus noise, NaN at
    the invalid rows (``holes`` of them at random, or all past the first
    ``n_valid`` of the flattened panel)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(A, R, 5))
    X = offset + spread * z
    y = z @ np.array([0.3, -0.2, 0.1, 0.05, -0.4]) * 1e-3 + rng.normal(0, 1e-3, (A, R))
    if n_valid is None:
        valid = rng.random((A, R)) >= holes
    else:
        valid = (np.arange(A * R) < n_valid).reshape(A, R)
    X[~valid], y[~valid] = np.nan, np.nan
    return (torch.from_numpy(X.astype(dtype)), torch.from_numpy(y.astype(dtype)),
            torch.from_numpy(valid))


# -- the kernel's steps in NumPy ---------------------------------------------

C = 6  # columns: five features, the label


def _zero():
    return [0, np.zeros(C), np.zeros((C, C))]


def _merge(a, b):
    """csrc::merge: Chan's formula, b into a."""
    (na, ma, Ma), (nb, mb, Mb) = a, b
    n = na + nb
    f = nb / (n if n > 0 else 1)
    g = na * f
    d = mb - ma
    return [n, ma + d * f, Ma + Mb + np.outer(d, d) * g]


def _block_tree(moms):
    """csrc::block_merge's order: lanes 16, 8, 4, 2, 1 within each warp
    (each level reading the lanes' values before it), then warps 0..7."""
    warps = []
    for w in range(WARPS):
        lanes = moms[32 * w:32 * w + 32]
        for off in (16, 8, 4, 2, 1):
            lanes = [(_merge(lanes[i], lanes[i + off]) if i + off < 32 else lanes[i])
                     for i in range(32)]
        warps.append(lanes[0])
    r = warps[0]
    for w in warps[1:]:
        r = _merge(r, w)
    return r


class _Threads:
    """Each thread's count, shift K and shifted sums (csrc::Acc)."""

    def __init__(self):
        self.n = np.zeros(THREADS, np.int64)
        self.k = np.zeros((THREADS, C))
        self.s1 = np.zeros((THREADS, C))
        self.s2 = np.zeros((THREADS, C, C))

    def add(self, take, z):
        first = take & (self.n == 0)
        self.k[first] = z[first]
        d = np.where(take[:, None], z - self.k, 0.0)
        self.s1 += d
        self.s2 += d[:, :, None] * d[:, None, :]
        self.n += take

    def moments(self):
        out = []
        for t in range(THREADS):
            n = int(self.n[t])
            nn = n if n > 0 else 1
            mean = self.k[t] + self.s1[t] / nn if n else np.zeros(C)
            out.append([n, mean, self.s2[t] - np.outer(self.s1[t], self.s1[t]) / nn])
        return out


def _cholesky_solve(G, b):
    """csrc::spd_solve."""
    F = len(b)
    L = np.zeros((F, F))
    for j in range(F):
        L[j, j] = math.sqrt(G[j, j] - L[j, :j] @ L[j, :j])
        for i in range(j + 1, F):
            L[i, j] = (G[j, i] - L[i, :j] @ L[j, :j]) / L[j, j]
    w = np.zeros(F)
    for i in range(F):
        w[i] = (b[i] - L[i, :i] @ w[:i]) / L[i, i]
    beta = np.zeros(F)
    for i in reversed(range(F)):
        beta[i] = (w[i] - L[i + 1:, i] @ beta[i + 1:]) / L[i, i]
    return beta


def _k4_emulate(features, y, valid, n_splits, alpha=1.0, frac=0.7, frac_small=0.6,
                small=100, max_blocks=None):
    """K4's four kernels on a CPU design, step by step, in f64: the plan
    (``max_blocks`` caps the blocks below the kernel's 528 so that small
    designs give chunks of several tiles), each chunk's valid count, each
    block's walk with every thread's shifted sums and its flushes at
    segment changes, the solve block's merge trees, unions, scaler,
    Cholesky fits and closed-form MSEs, and the scores.  Returns
    :func:`kernels.ridge_moments`' tuple as NumPy values."""
    A, R, F = features.shape
    N = A * R
    x = np.nan_to_num(features.numpy().reshape(N, F).astype(np.float64))
    yy = np.nan_to_num(y.numpy().reshape(N).astype(np.float64))
    v = valid.numpy().reshape(N)
    blocks, per = kernels._ridge_plan(N)
    if max_blocks is not None and per:
        tiles = -(-N // TILE)
        per = -(-tiles // min(tiles, max_blocks))
        blocks = -(-tiles // per)
    n_tiles = -(-N // TILE)
    counts = [int(v[b * per * TILE:min(N, (b + 1) * per * TILE)].sum()) for b in range(blocks)]
    total = sum(counts)
    n_train = int(math.floor(total * (frac if total > small else frac_small)))
    S = n_splits + 1
    ts = n_train // S
    b1 = n_train - n_splits * ts

    def seg_of(o):
        return 0 if o < b1 else 1 + (o - b1) // ts

    part = [[None] * blocks for _ in range(S)]
    for b in range(blocks):
        base, cur = sum(counts[:b]), -1
        seg_part = [_zero() for _ in range(S)]
        th = _Threads()
        for tile in range(b * per, min(n_tiles, (b + 1) * per)):
            if base >= n_train:
                break
            rows = tile * TILE + np.arange(TILE)
            inside = rows < N
            vv = np.zeros(TILE, bool)
            vv[inside] = v[rows[inside]]
            ordinal = base + np.cumsum(vv) - vv
            cnt = int(vv.sum())
            if cnt:
                lo, hi = seg_of(base), seg_of(min(base + cnt, n_train) - 1)
                for s in range(lo, hi + 1):
                    if s != cur:
                        if cur >= 0:
                            seg_part[cur] = _merge(seg_part[cur], _block_tree(th.moments()))
                        th, cur = _Threads(), s
                    for q in range(ROWS):
                        r = q * THREADS + np.arange(THREADS)
                        segs = np.array([seg_of(o) if o < n_train else -1 for o in ordinal[r]])
                        take = vv[r] & (ordinal[r] < n_train) & ((lo == hi) | (segs == s))
                        z = np.zeros((THREADS, C))
                        ok = inside[r]
                        z[ok, :F] = x[rows[r][ok]]
                        z[ok, F] = yy[rows[r][ok]]
                        th.add(take, z)
            base += cnt
        if cur >= 0:
            seg_part[cur] = _merge(seg_part[cur], _block_tree(th.moments()))
        for s in range(S):
            part[s][b] = seg_part[s]

    seg = []
    for s in range(S):
        moms = []
        for t in range(THREADS):
            m = _zero()
            for i in range(t, blocks, THREADS):
                m = _merge(m, part[s][i])
            moms.append(m)
        seg.append(_merge(_zero(), _block_tree(moms)))
    U = seg[0]
    for s in range(1, S):
        U = _merge(U, seg[s])
    m = U[1][:F]
    sd = np.sqrt(np.diag(U[2])[:F] / (U[0] if U[0] > 0 else 1))
    sd = np.where(sd > 1e-12 * np.maximum(np.abs(m), 1.0), sd, 1.0)
    U, cv = seg[0], []
    for k in range(S):
        if k:
            U = _merge(U, seg[k])
        G = U[2][:F, :F] / np.outer(sd, sd) + alpha * np.eye(F)
        beta = _cholesky_solve(G, U[2][:F, F] / sd)
        icept = U[1][F] - ((U[1][:F] - m) / sd) @ beta
        if k == S - 1:
            break
        te = seg[k + 1]
        if te[0] == 0:
            cv.append(0.0)
            continue
        bp = beta / sd
        q = bp @ te[2][:F, :F] @ bp - 2 * bp @ te[2][:F, F] + te[2][F, F]
        d = ((te[1][:F] - m) / sd) @ beta + icept - te[1][F]
        cv.append(max(q, 0.0) / te[0] + d * d)
    scores = np.where(v, ((x - m) / sd) @ beta + icept, np.nan).reshape(A, R)
    return beta, icept, m, sd, np.array(cv), scores, n_train


def _assert_close_fit(got, want, rel, what=""):
    """The fit's quantities within ``rel`` times kappa of their scales (see
    the module docstring); ``n_train`` equal."""
    coef, icept, mean, std, cv, scores, n_train = (np.asarray(g, np.float64) for g in got)
    wc, wi, wm, ws, wcv, wsc, wn = (np.asarray(w, np.float64) for w in want)
    assert int(n_train) == int(wn), what
    rel = rel * (1 + float(np.max(np.abs(wm) / ws)))
    scale = max(np.abs(wc).max(), abs(float(wi)))
    lever = float(np.sum(np.abs(wm) / ws * np.abs(wc)))
    assert np.abs(coef - wc).max() <= rel * scale, (what, "coef", coef, wc)
    assert abs(float(icept) - float(wi)) <= rel * (scale + lever), (what, "intercept")
    assert np.abs(mean - wm).max() <= rel * np.abs(wm).max(), (what, "mean")
    assert np.abs(std - ws).max() <= rel * np.abs(ws).max(), (what, "std")
    assert (np.abs(cv - wcv) <= rel * np.abs(wcv)).all(), (what, "cv_mse", cv, wcv)
    ok = np.isfinite(wsc)
    assert np.array_equal(np.isfinite(scores), ok), (what, "score rows")
    if ok.any():
        rms = np.sqrt(np.mean(wsc[ok] ** 2))
        assert np.abs(scores[ok] - wsc[ok]).max() <= rel * (rms + lever), (what, "scores")


def _plain(X, y, valid, n_splits, **kw):
    return kernels.ridge_moments_plain(X, y, valid, n_splits, kw.get("alpha", 1.0), 0.7,
                                       0.6, 100, **{k: v for k, v in kw.items()
                                                    if k == "tile"})


# designs whose walks reach every branch of the kernel: chunks of several
# tiles, tiles of several segments (ts far below a tile), a block stopping
# at n_train, a row count off the tile, the small-panel rule, empty test
# segments, features offset far from their spread
EMULATED = {
    "chunks_of_tiles": (dict(seed=1, A=4, R=1500), 3, 2),
    "tiny_segments": (dict(seed=2, A=2, R=700, holes=0.4), 5, None),
    "one_tile": (dict(seed=3, A=1, R=1000), 2, None),
    "small_panel": (dict(seed=4, A=1, R=150, holes=0.5), 3, None),
    "empty_tests": (dict(seed=5, A=1, R=30, n_valid=6), 4, None),
    "offset": (dict(seed=6, A=3, R=900, offset=1e7, spread=1e3), 3, 3),
}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_k4_emulation_equals_the_plain_version(case):
    spec, n_splits, max_blocks = EMULATED[case]
    X, y, valid = _design(**spec)
    got = _k4_emulate(X, y, valid, n_splits, max_blocks=max_blocks)
    want = [t.numpy() for t in _plain(X, y, valid, n_splits)]
    _assert_close_fit(got, want, F64_REL, case)


@pytest.mark.parametrize("tile", [1, 7, 64, 1024, 4096])
def test_the_plain_version_does_not_depend_on_its_tiles(tile):
    """Per-tile moments merged pairwise give the fit of one tile's two
    passes, to rounding, whatever the tile."""
    X, y, valid = _design(11, 3, 700, offset=5e6, spread=1e2)
    want = [t.numpy() for t in _plain(X, y, valid, 3, tile=3 * 700)]
    got = [t.numpy() for t in _plain(X, y, valid, 3, tile=tile)]
    _assert_close_fit(got, want, F64_REL, f"tile {tile}")


def test_chan_merge_is_exact_against_an_empty_side():
    rng = np.random.default_rng(0)
    a = (torch.tensor(7), torch.from_numpy(rng.normal(size=C)),
         torch.from_numpy(rng.normal(size=(C, C))))
    empty = (torch.tensor(0), torch.zeros(C, dtype=torch.float64),
             torch.zeros(C, C, dtype=torch.float64))
    for left, right in ((a, empty), (empty, a)):
        n, mean, M2 = kernels._chan(left, right)
        assert int(n) == 7 and torch.equal(mean, a[1]) and torch.equal(M2, a[2])


def test_segments_are_the_harness_folds():
    """Segment k + 1 is fold k's test block and segments 0..k its training
    rows, as ``time_series_cv_harness`` masks them."""
    _, _, valid = _design(13, 3, 500, holes=0.3)
    seg, n_train = kernels.ridge_segments(valid, 4, 0.7, 0.6, 100, torch.float64)
    vf = valid.reshape(-1)
    ordinal = torch.cumsum(vf, 0) - 1
    train = vf & (ordinal < n_train)
    ts = int(n_train) // 5
    assert torch.equal(seg >= 0, train)
    for i in range(4):
        start = int(n_train) - (4 - i) * ts
        assert torch.equal((seg >= 0) & (seg <= i), train & (ordinal < start))
        assert torch.equal(seg == i + 1, train & (ordinal >= start) & (ordinal < start + ts))


def test_the_plan_covers_every_tile_and_the_source_agrees():
    src = SRC.read_text()
    assert TILE == kernels._K4_TILE
    assert _const("kMaxBlocks") == kernels._K4_MAX_BLOCKS
    assert _const("kMaxSegments") == kernels.RIDGE_MAX_SPLITS + 1
    assert _const("kF") == kernels.RIDGE_FEATURES
    assert "kVals = kC + kM2" in src and kernels._K4_PARTIAL == 6 + 21
    for name in ("csmom_ridge_moments_f32", "csmom_ridge_moments_f64"):
        assert f"int {name}(" in src
    for name in kernels.ridge_moments.device_kernels:
        assert f"{name}(" in src
    assert "ridge_moments" in kernels.build.KERNELS
    assert kernels._ridge_plan(0) == (1, 0)
    for N in [1, 1023, 1024, 1025, 528 * 1024, 528 * 1024 + 1, 11_500_000, 10**9]:
        blocks, per = kernels._ridge_plan(N)
        tiles = -(-N // TILE)
        assert 1 <= blocks <= kernels._K4_MAX_BLOCKS
        assert (blocks - 1) * per < tiles <= blocks * per


def test_a_cpu_fit_runs_the_plain_version_and_launches_nothing():
    X, y, valid = _design(17, 2, 300)
    kernels.reset_launches()
    fit = models.ridge_time_series_cv(X, y, valid)
    want = _plain(X, y, valid, 3)
    for got, w in zip((fit.coef, fit.intercept, fit.scale_mean, fit.scale_std,
                       fit.cv_mse, fit.scores, fit.n_train), want):
        assert torch.equal(got.nan_to_num(), w.nan_to_num()) and got.dtype == w.dtype
    assert fit.n_train.dtype == torch.int32 and fit.scores.shape == (2, 300)
    assert kernels.ridge_moments.launches == 0 and kernels.ridge_moments.rows == 0


def test_bad_inputs_raise():
    X, y, valid = _design(19, 2, 40)
    with pytest.raises(TypeError, match="float32 or float64"):
        kernels.ridge_moments(X.to(torch.bfloat16), y, valid)
    with pytest.raises(TypeError, match="y is"):
        kernels.ridge_moments(X, y.float(), valid)
    with pytest.raises(TypeError, match="valid must be bool"):
        kernels.ridge_moments(X, y, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="need features"):
        kernels.ridge_moments(X[0], y, valid)
    with pytest.raises(ValueError, match="need features"):
        kernels.ridge_moments(X, y[:, :3], valid)
    with pytest.raises(ValueError, match="n_splits"):
        kernels.ridge_moments(X, y, valid, n_splits=0)
    with pytest.raises(ValueError, match="inputs on"):
        kernels.ridge_moments(X, y, valid.to("meta"))


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 runs only there")
    return torch.device("cuda")


def _bits(t):
    """A tensor's bits, so that NaN scores compare equal to themselves."""
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spec,n_splits", [
    (dict(seed=21, A=500, R=2301), 3),                      # 1123.5 tiles
    (dict(seed=22, A=7, R=1000, holes=0.5), 5),
    (dict(seed=23, A=1, R=30, n_valid=6), 4),               # empty test segments
    (dict(seed=24, A=40, R=3001, offset=1e7, spread=1e3), 3),
], ids=["cell_width", "gappy", "tiny", "offset"])
def test_k4_on_the_card_equals_the_plain_version(card, spec, n_splits, dtype):
    X, y, valid = _design(**spec, dtype=dtype)
    want = [t.numpy() for t in _plain(X, y, valid, n_splits)]
    dev = [t.to(card) for t in (X, y, valid)]
    kernels.reset_launches()
    got = kernels.ridge_moments(*dev, n_splits=n_splits)
    again = kernels.ridge_moments(*dev, n_splits=n_splits)
    torch.cuda.synchronize()
    assert kernels.ridge_moments.launches == 2
    assert kernels.ridge_moments.rows == 2 * X.shape[0] * X.shape[1]
    for a, b in zip(got, again):
        assert torch.equal(_bits(a), _bits(b))
    rel = F32_REL if dtype == np.float32 else F64_REL
    _assert_close_fit([t.cpu().numpy() for t in got], want, rel)


def _misaligned(t):
    """``t`` on its device as a contiguous view 8 bytes past a 16-byte
    boundary (or one byte, for bool)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    k = next(i for i in range(1, 17) if (buf.data_ptr() + i * t.element_size()) % 16)
    view = buf[k:k + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.card
def test_the_fit_on_the_card_goes_through_k4(card):
    X, y, valid = _design(25, 3, 800)
    kernels.reset_launches()
    fit = models.ridge_time_series_cv(X.to(card), y.to(card), valid.to(card))
    torch.cuda.synchronize()
    assert kernels.ridge_moments.launches == 1
    assert kernels.ridge_moments.rows == 3 * 800
    assert fit.scores.device.type == "cuda" and fit.n_train.dtype == torch.int32
    # inputs off a 16-byte boundary are copied before the kernel stages them
    odd = [_misaligned(t.to(card)) for t in (X, y, valid)]
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in odd)
    again = kernels.ridge_moments(*odd)
    for a, b in zip((fit.coef, fit.intercept, fit.cv_mse, fit.scores), again[:2] + again[4:6]):
        assert torch.equal(_bits(a), _bits(b))
    with pytest.raises(ValueError, match="the kernel takes 5 features"):
        kernels.ridge_moments(X[..., :4].to(card), y.to(card), valid.to(card))
