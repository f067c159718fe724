"""The port's kernel modules on the CPU: the plain versions of K1 and K2
against the reference's XLA forms and its Pallas kernels (interpret mode),
and the wrappers' input checks (the CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.backtest.grid import _cohort_partial_sums as jax_cohort
from csmom_tpu.backtest.monthly import decile_partial_sums as jax_decile
from csmom_tpu.ops.pallas_kernels import (
    cohort_partial_sums_pallas,
    decile_partial_sums_pallas,
)
from csmom_tpu_torch import k1_sweep, k2_sweep
from csmom_tpu_torch.backtest import grid, monthly
from csmom_tpu_torch.ops import kernels

torch.set_num_threads(2)

# the reference's own tolerance between its kernel forms (f64)
TOL = dict(rtol=1e-10, atol=1e-13)


def _k1_case(seed, a, m, n_bins):
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, n_bins, size=(a, m)).astype(np.int32)
    valid = rng.random((a, m)) > 0.2
    labels = np.where(valid, labels, -1).astype(np.int32)
    ret_z = np.where(labels >= 0, rng.normal(size=(a, m)), 0.0)
    return labels, ret_z


def _k2_case(seed, a, m, n_bins=5):
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, n_bins, size=(a, m)).astype(np.int32)
    valid = rng.random((a, m)) > 0.25
    ret = np.where(valid, rng.normal(0, 0.02, size=(a, m)), np.nan)
    return labels, ret, valid


@pytest.mark.parametrize("a,m,n_bins", [(16, 24, 10), (256, 128, 10),
                                        (300, 130, 10), (37, 7, 10),
                                        (50, 40, 3)])
def test_k1_plain_matches_xla(a, m, n_bins):
    labels, ret_z = _k1_case(a * m, a, m, n_bins)
    ws, wc = jax_decile(jnp.asarray(ret_z), jnp.asarray(labels >= 0),
                        jnp.asarray(labels), n_bins)
    # the wrapper on a CPU tensor runs the plain version
    for fn in (kernels.decile_partial_sums_plain, kernels.decile_partial_sums):
        s, c = fn(torch.as_tensor(ret_z), torch.as_tensor(labels), n_bins)
        assert s.dtype == c.dtype == torch.float64 and s.shape == (n_bins, m)
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), **TOL)
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc, dtype=np.float64))


def test_k1_all_invalid():
    labels = np.full((20, 16), -1, dtype=np.int32)
    s, c = kernels.decile_partial_sums(torch.zeros(20, 16, dtype=torch.float64),
                                       torch.as_tensor(labels), 5)
    assert (s == 0).all() and (c == 0).all()


def test_k1_engine_form_matches_xla():
    """backtest.monthly.decile_partial_sums (folding + K1) == the reference's
    xla form on raw inputs: NaN returns at invalid slots, int32 counts."""
    rng = np.random.default_rng(5)
    labels = rng.integers(-1, 10, size=(60, 30)).astype(np.int32)
    valid = rng.random((60, 30)) > 0.3
    ret = np.where(valid, rng.normal(size=(60, 30)), np.nan)
    ws, wc = jax_decile(jnp.asarray(ret), jnp.asarray(valid), jnp.asarray(labels), 10)
    for impl in ("kernel", "plain"):
        s, c = monthly.decile_partial_sums(torch.as_tensor(ret), torch.as_tensor(valid),
                                           torch.as_tensor(labels), 10, impl=impl)
        assert c.dtype == torch.int32
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), **TOL)
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc))


def test_k1_plain_matches_pallas_interpret():
    labels, ret_z = _k1_case(1, 37, 7, 10)
    ps, pc = decile_partial_sums_pallas(jnp.asarray(ret_z), jnp.asarray(labels),
                                        n_bins=10, interpret=True)
    s, c = kernels.decile_partial_sums_plain(torch.as_tensor(ret_z),
                                             torch.as_tensor(labels), 10)
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), **TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(pc))


@pytest.mark.parametrize("a,m,h", [(37, 50, 6), (130, 300, 12), (64, 20, 12)])
def test_k2_plain_matches_xla(a, m, h):
    labels, ret, valid = _k2_case(a + m + h, a, m)
    ws, wc = jax_cohort(jnp.asarray(labels), jnp.asarray(ret), jnp.asarray(valid), 5, h)
    s, c = kernels.cohort_partial_sums_plain(torch.as_tensor(ret), torch.as_tensor(valid),
                                             torch.as_tensor(labels), 5, h)
    assert s.shape == (2, m, h)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), **TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(wc, dtype=np.float64))


def test_k2_batched_wrapper_equals_per_j():
    """labels [nJ, A, M]: one wrapper call == the reference per J."""
    rng = np.random.default_rng(9)
    labels = rng.integers(-1, 10, size=(3, 40, 30)).astype(np.int32)
    _, ret, valid = _k2_case(9, 40, 30)
    s, c = kernels.cohort_partial_sums(torch.as_tensor(ret), torch.as_tensor(valid),
                                       torch.as_tensor(labels), 10, 7)
    assert s.shape == (3, 2, 30, 7)
    for j in range(3):
        ws, wc = jax_cohort(jnp.asarray(labels[j]), jnp.asarray(ret),
                            jnp.asarray(valid), 10, 7)
        np.testing.assert_allclose(s[j].numpy(), np.asarray(ws), **TOL)
        np.testing.assert_array_equal(c[j].numpy(), np.asarray(wc, dtype=np.float64))
    gs, gc = grid._cohort_partial_sums(torch.as_tensor(labels), torch.as_tensor(ret),
                                       torch.as_tensor(valid), 10, 7)
    assert torch.equal(gs, s) and torch.equal(gc, c)


def test_k2_plain_matches_pallas_interpret():
    labels, ret, valid = _k2_case(2, 37, 50)
    ps, pc = cohort_partial_sums_pallas(jnp.asarray(ret), jnp.asarray(valid),
                                        jnp.asarray(labels), n_bins=5, max_hold=6,
                                        interpret=True)
    s, c = kernels.cohort_partial_sums_plain(torch.as_tensor(ret), torch.as_tensor(valid),
                                             torch.as_tensor(labels), 5, 6)
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), **TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(pc))


def _k1_args(**over):
    args = dict(ret=torch.zeros(8, 16, dtype=torch.float64),
                labels=torch.zeros(8, 16, dtype=torch.int32), n_bins=10)
    args.update(over)
    return args


def _k2_args(**over):
    args = dict(ret=torch.zeros(8, 16, dtype=torch.float64),
                ret_valid=torch.ones(8, 16, dtype=torch.bool),
                labels=torch.zeros(1, 8, 16, dtype=torch.int32), n_bins=10,
                max_hold=12)
    args.update(over)
    return args


@pytest.mark.parametrize("fn,args,exc,match", [
    (kernels.decile_partial_sums, _k1_args(ret=torch.zeros(8, 16, dtype=torch.bfloat16)),
     TypeError, "bf16"),
    (kernels.decile_partial_sums, _k1_args(labels=torch.zeros(8, 16, dtype=torch.int64)),
     TypeError, "int32"),
    (kernels.decile_partial_sums, _k1_args(labels=torch.zeros(8, 15, dtype=torch.int32)),
     ValueError, "same"),
    (kernels.decile_partial_sums, _k1_args(n_bins=0), ValueError, "n_bins"),
    (kernels.decile_partial_sums,
     _k1_args(ret=torch.zeros(16, 8, dtype=torch.float64).T,
              labels=torch.zeros(16, 8, dtype=torch.int32).T),
     ValueError, "contiguous"),
    (kernels.cohort_partial_sums, _k2_args(max_hold=200), ValueError, "max_hold"),
    (kernels.cohort_partial_sums, _k2_args(ret=torch.zeros(8, 16, dtype=torch.float16)),
     TypeError, "float32 or float64"),
    (kernels.cohort_partial_sums, _k2_args(labels=torch.zeros(8, 16, dtype=torch.int32)),
     ValueError, "nJ, A, M"),
    (kernels.cohort_partial_sums, _k2_args(ret_valid=torch.ones(8, 16)),
     TypeError, "bool"),
    (kernels.cohort_partial_sums, _k2_args(max_hold=129), ValueError, "max_hold"),
    (kernels.cohort_partial_sums, _k2_args(max_hold=0), ValueError, "max_hold"),
    (kernels.cohort_partial_sums,
     _k2_args(labels=torch.zeros(1, 8, 16, dtype=torch.int64)), TypeError, "int32"),
    (kernels.cohort_partial_sums,
     _k2_args(labels=torch.zeros(1, 8, 15, dtype=torch.int32)), ValueError, "nJ, A, M"),
])
def test_wrappers_reject_bad_inputs(fn, args, exc, match):
    before = (kernels.decile_partial_sums.launches, kernels.cohort_partial_sums.launches)
    with pytest.raises(exc, match=match):
        fn(**args)
    assert (kernels.decile_partial_sums.launches,
            kernels.cohort_partial_sums.launches) == before


def test_cpu_path_launches_no_kernel():
    kernels.reset_launches()
    labels, ret_z = _k1_case(3, 16, 24, 10)
    kernels.decile_partial_sums(torch.as_tensor(ret_z), torch.as_tensor(labels), 10)
    labels2, ret, valid = _k2_case(3, 16, 24)
    kernels.cohort_partial_sums(torch.as_tensor(ret), torch.as_tensor(valid),
                                torch.as_tensor(labels2)[None], 5, 6)
    assert kernels.decile_partial_sums.launches == 0
    assert kernels.cohort_partial_sums.launches == 0


def test_unknown_impl_raises():
    t = torch.zeros(4, 6, dtype=torch.float64)
    v = torch.ones(4, 6, dtype=torch.bool)
    lab = torch.zeros(4, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match="impl"):
        monthly.decile_partial_sums(t, v, lab, 10, impl="xla")
    with pytest.raises(ValueError, match="impl"):
        grid._cohort_partial_sums(lab, t, v, 10, 3, impl="pallas")


# K2's launch plan: the north star, A < cluster size, ragged months, the
# horizon chunk edges and both float widths
_PLAN_SHAPES = [(4, 3000, 696), (1, 5, 33), (5, 7, 31), (4, 3001, 697),
                (2, 40, 200), (1, 1, 1), (12, 3000, 696)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("H", [1, 12, 16, 17, 128])
@pytest.mark.parametrize("nJ,A,M", _PLAN_SHAPES)
def test_cohort_plan_fits_the_card(nJ, A, M, H, itemsize):
    p = kernels._cohort_plan(nJ, A, M, H, itemsize)
    assert p["smem"] <= 232_448                 # an H100 block's shared memory
    assert 1 <= p["cluster"] <= 8               # the portable cluster size
    assert p["grid"][0] % p["cluster"] == 0
    assert p["grid"][1] * p["ts"] >= M > (p["grid"][1] - 1) * p["ts"]
    assert 1 <= p["jg"] <= min(nJ, 8) and 1 <= p["hc"] <= 16
    assert p["groups"] * p["jg"] * p["ts"] <= 256  # the kernel's launch bounds
    # grid[2] runs over the J groups, each with its horizon chunks of hc
    n_jgroups = -(-nJ // p["jg"])
    assert p["grid"][2] % n_jgroups == 0
    chunks = [range(c * p["hc"] + 1, min(H, (c + 1) * p["hc"]) + 1)
              for c in range(p["grid"][2] // n_jgroups)]
    covered = [h for chunk in chunks for h in chunk]
    assert covered == list(range(1, H + 1))     # every horizon exactly once


@pytest.mark.parametrize("itemsize", [4, 8])
def test_cohort_plan_north_star_fills_the_card(itemsize):
    p = kernels._cohort_plan(4, 3000, 696, 12, itemsize)
    blocks = p["grid"][0] * p["grid"][1] * p["grid"][2]
    assert blocks >= 264                         # two blocks per SM on 132 SMs
    assert p["hc"] == 12 and p["cluster"] == 8


def test_cohort_plan_depends_on_shapes_only():
    assert kernels._cohort_plan(4, 3000, 696, 12, 4) == \
        kernels._cohort_plan(4, 3000, 696, 12, 4)
    assert kernels._cohort_plan(4, 3000, 696, 12, 4)["grid"] == (8, 22, 2)


def test_cohort_refuses_more_assets_than_its_counts_hold():
    """A thread keeps both sides' counts in 16 bits each, so an asset slice
    holds at most 65535 assets: 8 slices, 524,280 assets.  The plan and
    the wrapper refuse more, on every device."""
    assert kernels.MAX_ASSETS == 8 * 65535
    kernels._cohort_plan(1, kernels.MAX_ASSETS, 1, 12, 4)
    with pytest.raises(ValueError, match="524280"):
        kernels._cohort_plan(1, kernels.MAX_ASSETS + 1, 1, 12, 4)
    a = kernels.MAX_ASSETS + 1
    kernels.reset_launches()
    with pytest.raises(ValueError, match="at most 524280"):
        kernels.cohort_partial_sums(torch.zeros(a, 1), torch.ones(a, 1, dtype=torch.bool),
                                    torch.zeros(1, a, 1, dtype=torch.int32), 10, 12)
    assert kernels.cohort_partial_sums.launches == 0


@pytest.mark.parametrize("name", sorted(k2_sweep.VARIANTS))
def test_k2_sweep_variants_edit_the_kernel_source(name):
    """Every build variant of the K2 sweep applies to the kernel as it
    stands: each edit matches once and changes the source."""
    src = k2_sweep.SOURCE.read_text()
    out = k2_sweep.variant_source(src, name)
    assert (out == src) == (name == "main")
    if name != "main":  # an edit that no longer matches stops the sweep
        old = k2_sweep.VARIANTS[name][1][0][0]
        with pytest.raises(ValueError, match="expects"):
            k2_sweep.variant_source(src.replace(old, ""), name)


# K1's launch plan: the north star, ragged months (M odd, M = 2 mod 4),
# M below one tile and M = 1, A below the cluster size and A = 1
_K1_SHAPES = [(3000, 696), (3001, 697), (300, 130), (37, 7), (5, 31),
              (7, 30), (1, 1), (64, 3), (12, 4000)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B", [1, 3, 5, 10, 16, 20, 33])
@pytest.mark.parametrize("A,M", _K1_SHAPES)
def test_decile_plan_fits_the_card(A, M, B, itemsize):
    p = kernels._decile_plan(A, M, B, itemsize)
    threads = p["lanes"] * p["groups"]
    assert p["v"] * itemsize == 16                    # one 16-byte load of returns
    assert threads % 32 == 0 and threads <= 256       # the kernel's launch bounds
    assert 32 % p["lanes"] == 0                       # a warp holds whole groups
    assert 1 <= p["cluster"] <= 8                     # the portable cluster size
    assert p["smem"] <= 232_448                       # an H100 block's shared memory
    gx, gy = p["grid"]
    assert gx % p["cluster"] == 0 and gx < 2**31 and gy <= 65535
    tm = p["lanes"] * p["v"]
    assert (gx // p["cluster"]) * tm >= M > (gx // p["cluster"] - 1) * tm
    # a block holds up to 16 bins; more go in groups on the grid's y axis
    assert p["nb"] == min(B, 16) and threads == 128
    assert (gy - 1) * p["nb"] < B <= gy * p["nb"]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_decile_plan_north_star_fills_the_card(itemsize):
    p = kernels._decile_plan(3000, 696, 10, itemsize)
    blocks = p["grid"][0] * p["grid"][1]
    assert blocks >= 132                              # a block on every SM
    assert p["nb"] == 10 and p["cluster"] == 8
    assert p["lanes"] * p["v"] * itemsize >= 128      # a warp reads 128 B of a return row
    # bytes in flight: a round of 4 assets' loads per thread, >= 16 KB per SM
    in_flight = blocks * p["lanes"] * p["groups"] * 4 * p["v"] * (4 + itemsize)
    assert in_flight / 132 >= 16 * 1024
    # every block resident at once: 5 of them fit an SM's 228 KB
    assert p["smem"] * -(-blocks // 132) <= 228 * 1024


def test_decile_plan_depends_on_shapes_only():
    assert kernels._decile_plan(3000, 696, 10, 4) == kernels._decile_plan(3000, 696, 10, 4)
    assert kernels._decile_plan(3000, 696, 10, 4)["grid"] == (176, 1)
    assert kernels._decile_plan(3000, 696, 10, 4)["lanes"] == 8
    assert kernels._decile_plan(3000, 696, 10, 8)["lanes"] == 8


def test_decile_refuses_more_bin_groups_than_the_grid_holds():
    """Bins go in groups of 16 on the grid's y axis: at most 65535 x 16
    bins.  The plan and the wrapper refuse more, on every device."""
    kernels._decile_plan(1, 1, 65535 * 16, 4)
    with pytest.raises(ValueError, match="at most 1048560"):
        kernels._decile_plan(1, 1, 65535 * 16 + 1, 4)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="at most 1048560"):
        kernels.decile_partial_sums(torch.zeros(1, 1), torch.zeros(1, 1, dtype=torch.int32),
                                    65535 * 16 + 1)
    assert kernels.decile_partial_sums.launches == 0


def _k1_emulate(labels, ret, B, plan, vec, unroll=8):
    """The CUDA kernel's index map, in numpy: which thread reads which
    panel slot (flat index, as the kernel addresses it), in which order the
    partials meet, and which rank stores which output.  Returns (sums,
    counts, reads per slot and bin group, stores per output)."""
    A, M = labels.shape
    V, lanes, groups, nb, C = (plan[k] for k in ("v", "lanes", "groups", "nb", "cluster"))
    gx, gy = plan["grid"]
    tm, per = lanes * V, -(-A // C)
    flat_l, flat_r = labels.ravel(), ret.ravel()
    reads = np.zeros((gy, A * M), dtype=int)
    stores = np.zeros((B, M), dtype=int)
    sums, counts = np.zeros((B, M)), np.zeros((B, M))
    for by in range(gy):
        bin0 = by * nb
        nbg = min(nb, B - bin0)                      # this block's bins
        for t0 in range(0, gx, C):                   # one cluster: a month tile
            mt0 = (t0 // C) * tm
            part = np.zeros((C, 2, nb, tm))
            for rank in range(C):
                a_lo = min(A, rank * per)
                a_hi = min(A, a_lo + per)
                for g in range(groups):
                    for lane in range(lanes):
                        m0, a0 = mt0 + lane * V, a_lo + g
                        n = -(-(a_hi - a0) // groups) if a0 < a_hi and m0 < M else 0
                        nv = V if vec else min(V, M - m0)
                        for i in range(0, n, unroll):
                            for u in range(unroll):
                                if i + u >= n:
                                    continue
                                for v in range(nv):
                                    idx = (a0 + (i + u) * groups) * M + m0 + v
                                    reads[by, idx] += 1
                                    b = flat_l[idx] - bin0
                                    if 0 <= b < nbg:
                                        part[rank, 0, b, lane * V + v] += flat_r[idx]
                                        part[rank, 1, b, lane * V + v] += 1
            n_out = nbg * tm
            share = -(-n_out // C)
            for rank in range(C):
                for o in range(rank * share, min(n_out, rank * share + share)):
                    b, m = bin0 + o // tm, mt0 + o % tm
                    if m < M:
                        stores[b, m] += 1
                        sums[b, m] = part[:, 0, o // tm, o % tm].sum()
                        counts[b, m] = part[:, 1, o // tm, o % tm].sum()
    return sums, counts, reads, stores


# ragged panels: A below the cluster size, M odd or = 2 mod 4, M below
# one tile, B above every compiled bin count; labels >= B and < -1
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("A,M,B", [(37, 7, 10), (5, 31, 3), (3, 30, 20), (1, 1, 1),
                                   (40, 33, 5), (9, 64, 12), (70, 24, 10), (2, 6, 5)])
def test_decile_kernel_map_covers_every_slot_once(A, M, B, itemsize):
    rng = np.random.default_rng(A * 1000 + M + B)
    labels = rng.integers(-3, B + 3, size=(A, M)).astype(np.int32)
    ret = np.where((labels >= 0) & (labels < B), rng.normal(size=(A, M)), 0.0)
    plan = kernels._decile_plan(A, M, B, itemsize)
    ws, wc = kernels.decile_partial_sums_plain(torch.as_tensor(ret),
                                               torch.as_tensor(labels), B)
    # the kernel takes 16-byte loads only where every row allows them
    for vec in ([False, True] if M % plan["v"] == 0 else [False]):
        s, c, reads, stores = _k1_emulate(labels, ret, B, plan, vec)
        assert (reads == 1).all()                     # every slot once per bin group
        assert (stores == 1).all()                    # every output stored once
        np.testing.assert_array_equal(c, wc.numpy())
        np.testing.assert_allclose(s, ws.numpy(), **TOL)


def test_decile_kernel_map_dead_lanes_take_nothing():
    """M = 530 in f32: 16-month tiles, so lanes 1-3 of the last tile
    (months 532-543) start past the panel end.  They must read nothing:
    a read there would land on the next row's slots, read twice."""
    A, M = 3, 530
    plan = kernels._decile_plan(A, M, 10, 4)
    tm = plan["lanes"] * plan["v"]
    assert plan["lanes"] > 1 and (plan["grid"][0] // plan["cluster"]) * tm - M >= 2 * plan["v"]
    labels = np.zeros((A, M), dtype=np.int32)
    s, c, reads, _ = _k1_emulate(labels, np.ones((A, M)), 10, plan, vec=False)
    assert (reads == 1).all() and (c[0] == A).all() and (s[0] == A).all()


@pytest.mark.parametrize("name", sorted(k1_sweep.VARIANTS))
def test_k1_sweep_variants_edit_the_kernel_source(name):
    """Every build variant of the K1 sweep applies to the kernel as it
    stands: each edit matches once and changes the source."""
    src = k1_sweep.SOURCE.read_text()
    out = k1_sweep.k1_source(name)
    assert (out == src) == (name == "main")
    for old, _ in k1_sweep.VARIANTS[name][1]:  # an edit that no longer matches stops the sweep
        with pytest.raises(ValueError, match="expects"):
            k2_sweep.variant_source(src.replace(old, ""), name, k1_sweep.VARIANTS,
                                    k1_sweep.SOURCE)
