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
from csmom_tpu_torch import k2_sweep
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
