"""The port's decile assignment against csmom_tpu on the hard cases: ties,
signed zeros, valid infinities, all-invalid / single-lane / constant
cross-sections, and several bin counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmom_tpu.ops import ranking as jrank
from csmom_tpu_torch.ops import ranking

torch.set_num_threads(2)


def _hard_panel(seed, a=41):
    """[A, 12] signal panel, one hard case per date column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(a, 12))
    valid = np.ones((a, 12), bool)
    x[:, 1] = rng.integers(0, 4, size=a)                      # heavy ties
    x[:, 2] = rng.choice([-0.0, 0.0, 1.0, -1.0], size=a)      # signed zeros
    x[:5, 3], x[5:8, 3] = np.inf, -np.inf                     # valid infinities
    valid[:, 4] = False                                       # all invalid
    valid[:, 5] = False
    valid[17, 5] = True                                       # one valid lane
    x[:, 6] = 2.5                                             # constant
    x[:, 7] = rng.choice([1.0, 2.0], size=a)                  # two values
    valid[:, 8] = rng.random(a) > 0.3                         # scattered invalid
    valid[:, 9] = False
    valid[[2, 9, 30], 9] = True                               # three valid
    x[:, 10] = np.round(rng.normal(size=a), 1)                # rounded ties
    x[::3, 11] = np.inf                                       # inf ties + rest
    x[:, 8][~valid[:, 8]] = 1e9                               # finite but masked
    x = np.where(valid | (np.arange(12) == 8), x, np.nan)
    return x, valid


@pytest.mark.parametrize("mode", ["qcut", "rank"])
@pytest.mark.parametrize("n_bins", [3, 5, 10])
def test_decile_assign_panel_matches_jax(mode, n_bins):
    x, valid = _hard_panel(n_bins)
    labels, n_eff = ranking.decile_assign_panel(
        torch.as_tensor(x), torch.as_tensor(valid), n_bins=n_bins, mode=mode)
    jl, jn = jrank.decile_assign_panel(jnp.asarray(x), jnp.asarray(valid),
                                       n_bins=n_bins, mode=mode)
    assert labels.dtype == torch.int32 and n_eff.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(n_eff.numpy(), np.asarray(jn))
    # the degenerate columns: no valid lane / single lane / constant
    assert (labels[:, 4] == -1).all()
    if mode == "qcut":
        assert (labels[:, 5] == -1).all() and (labels[:, 6] == -1).all()


@pytest.mark.parametrize("mode", ["qcut", "rank"])
def test_decile_assign_f32(mode):
    x, valid = _hard_panel(7)
    x32 = x.astype(np.float32)
    labels, n_eff = ranking.decile_assign_panel(
        torch.as_tensor(x32), torch.as_tensor(valid), n_bins=10, mode=mode)
    jl, jn = jrank.decile_assign_panel(jnp.asarray(x32), jnp.asarray(valid),
                                       n_bins=10, mode=mode)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(n_eff.numpy(), np.asarray(jn))


def test_batched_leading_axis_equals_per_slice():
    """[nJ, A, M] ranks as nJ independent panels (the grid's batch axis)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 25, 9))
    valid = rng.random((3, 25, 9)) > 0.2
    x = np.where(valid, x, np.nan)
    labels, n_eff = ranking.decile_assign_panel(
        torch.as_tensor(x), torch.as_tensor(valid), n_bins=5, mode="rank")
    assert labels.shape == (3, 25, 9) and n_eff.shape == (3, 9)
    for j in range(3):
        jl, jn = jrank.decile_assign_panel(jnp.asarray(x[j]), jnp.asarray(valid[j]),
                                           n_bins=5, mode="rank")
        np.testing.assert_array_equal(labels[j].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(n_eff[j].numpy(), np.asarray(jn))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sortable_bits_same_total_order(dtype):
    """Signed int64 keys order lanes exactly as the reference's unsigned
    keys: -0.0 ties +0.0, invalid lanes sort strictly above +inf."""
    x = np.array([3.0, -0.0, 0.0, np.inf, -np.inf, -1e-300, 1e-300, 2.0,
                  -7.5, np.inf, 0.0, 5.0], dtype=dtype)
    valid = np.ones(x.shape, bool)
    valid[[7, 11]] = False
    key, nbits = ranking.sortable_bits(torch.as_tensor(x), torch.as_tensor(valid))
    jkey, jbits = jrank.sortable_bits(jnp.asarray(x), jnp.asarray(valid))
    assert nbits == jbits
    jk = np.asarray(jkey).astype(np.uint64)
    k = key.numpy()
    np.testing.assert_array_equal(np.argsort(k, kind="stable"),
                                  np.argsort(jk, kind="stable"))
    np.testing.assert_array_equal(k[:, None] == k[None, :], jk[:, None] == jk[None, :])
    assert k[1] == k[2] and k[7] > k[3] and k[7] == k[11]


def test_unknown_and_unported_modes_raise():
    x = torch.zeros(4, 3, dtype=torch.float64)
    v = torch.ones(4, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown mode"):
        ranking.decile_assign_panel(x, v, mode="nope")
    with pytest.raises(NotImplementedError, match="hist"):
        ranking.decile_assign_panel(x, v, mode="hist")
