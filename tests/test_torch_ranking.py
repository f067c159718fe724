"""The port's decile assignment against csmom_tpu on the hard cases: ties,
signed zeros, valid infinities, all-invalid / single-lane / constant
cross-sections, and several bin counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis import given, settings
from hypothesis import strategies as st

from csmom_tpu.ops import ranking as jrank
from csmom_tpu_torch.ops import ranking
from csmom_tpu_torch.parallel.histrank import histogram_rank_labels

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
    """An unknown mode raises; 'hist' gives rank's labels, and its
    collective (asset-sharded) form runs only inside shard_map, where it
    gives them too."""
    from csmom_tpu_torch.parallel.compat import P, shard_map
    from csmom_tpu_torch.parallel.mesh import auto_mesh

    x = torch.zeros(4, 3, dtype=torch.float64)
    v = torch.ones(4, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown mode"):
        ranking.decile_assign_panel(x, v, mode="nope")
    hist, _ = ranking.decile_assign_panel(x, v, mode="hist")
    rank, _ = ranking.decile_assign_panel(x, v, mode="rank")
    assert torch.equal(hist, rank)
    with pytest.raises(RuntimeError, match="outside shard_map"):
        histogram_rank_labels(x, v, 10, axis_name="assets")
    spec = P("assets", None)
    sharded = shard_map(lambda a, b: histogram_rank_labels(a, b, 10, "assets"),
                        mesh=auto_mesh(2, device="cpu"), in_specs=(spec, spec),
                        out_specs=spec)(x, v)
    assert torch.equal(sharded, rank)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_bins", [1, 2, 3, 5, 10])
def test_hist_mode_matches_jax_and_rank(dtype, n_bins):
    """mode='hist' equals the reference's hist labels and the port's rank
    labels on every hard column (ties, signed zeros, infinities, months
    with fewer valid lanes than bins, all-invalid months)."""
    x, valid = _hard_panel(n_bins + 11)
    x = x.astype(dtype)
    labels, n_eff = ranking.decile_assign_panel(
        torch.as_tensor(x), torch.as_tensor(valid), n_bins=n_bins, mode="hist")
    rank, rank_n = ranking.decile_assign_panel(
        torch.as_tensor(x), torch.as_tensor(valid), n_bins=n_bins, mode="rank")
    # the reference's hist labels equal its rank labels by construction
    # (its own tests hold them so); its hist compiles 8 or 16 unrolled
    # radix rounds, so one case a width takes it and the rest take rank
    jmode = "hist" if (n_bins, dtype) in ((10, np.float64), (3, np.float32)) else "rank"
    jl, jn = jrank.decile_assign_panel(jnp.asarray(x), jnp.asarray(valid),
                                       n_bins=n_bins, mode=jmode)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(n_eff.numpy(), np.asarray(jn))
    assert torch.equal(labels, rank) and torch.equal(n_eff, rank_n)
    # the public [A, M] form, and a coarser and finer radix
    for bpr in (2, 4, 8):
        np.testing.assert_array_equal(
            histogram_rank_labels(torch.as_tensor(x), torch.as_tensor(valid),
                                  n_bins, bits_per_round=bpr).numpy(),
            np.asarray(jl))


@settings(max_examples=30, deadline=None)
@given(
    n_bins=st.sampled_from([3, 10, 16]),
    f32=st.booleans(),
    p_valid=st.sampled_from([0.05, 0.3, 0.9]),
    data=st.data(),
)
def test_hist_equals_rank_property(n_bins, f32, p_valid, data):
    """Random [24, 3] panels drawn from few distinct values (ties), with
    NaNs and masked lanes, often fewer valid lanes than bins: hist == rank
    == the reference's rank.  One panel shape keeps the reference to one
    compile per bin count."""
    a, m = 24, 3
    values = st.sampled_from([-1.5, -0.0, 0.0, 0.25, 0.25, 2.0, np.inf,
                              -np.inf, np.nan, 7.0])
    x = np.array(data.draw(st.lists(values, min_size=a * m, max_size=a * m)),
                 dtype=np.float32 if f32 else np.float64).reshape(a, m)
    u = np.array(data.draw(st.lists(st.floats(0, 1), min_size=a * m,
                                    max_size=a * m))).reshape(a, m)
    valid = (u < p_valid) & ~np.isnan(x)
    hist, _ = ranking.decile_assign_panel(torch.as_tensor(x), torch.as_tensor(valid),
                                          n_bins=n_bins, mode="hist")
    rank, _ = ranking.decile_assign_panel(torch.as_tensor(x), torch.as_tensor(valid),
                                          n_bins=n_bins, mode="rank")
    jl, _ = jrank.decile_assign_panel(jnp.asarray(x), jnp.asarray(valid),
                                      n_bins=n_bins, mode="rank")
    np.testing.assert_array_equal(hist.numpy(), rank.numpy())
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jl))


@pytest.mark.parametrize("mode", ["qcut", "rank", "hist"])
def test_sector_labels_match_jax(mode):
    """Rank within sector, pooled label space; negative ids unranked."""
    rng = np.random.default_rng(17)
    a, m, s = 70, 15, 4
    x = rng.normal(size=(a, m))
    x[:, 3] = rng.integers(0, 3, size=a)                      # ties
    valid = rng.random((a, m)) > 0.2
    valid[:, 5] = False                                       # all invalid
    x = np.where(valid, x, np.nan)
    sid = rng.integers(-1, s, size=a)
    sid[:6] = 2                                               # one big sector
    labels, n_eff = ranking.sector_decile_assign_panel(
        torch.as_tensor(x), torch.as_tensor(valid), torch.as_tensor(sid), s,
        n_bins=5, mode=mode)
    # port's hist against the reference's rank: the same labels, without
    # compiling the reference's radix once per sector
    jmode = "rank" if mode == "hist" else mode
    jl, jn = jrank.sector_decile_assign_panel(
        jnp.asarray(x), jnp.asarray(valid), jnp.asarray(sid, dtype=jnp.int32), s,
        n_bins=5, mode=jmode)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(n_eff.numpy(), np.asarray(jn))
    assert (labels.numpy()[sid < 0] == -1).all()
    one, one_n = ranking.sector_decile_assign(
        torch.as_tensor(x[:, 3]), torch.as_tensor(valid[:, 3]),
        torch.as_tensor(sid), s, n_bins=5, mode=mode)
    jo, jon = jrank.sector_decile_assign(
        jnp.asarray(x[:, 3]), jnp.asarray(valid[:, 3]),
        jnp.asarray(sid, dtype=jnp.int32), s, n_bins=5, mode=jmode)
    np.testing.assert_array_equal(one.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(one_n.numpy(), np.asarray(jon))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", ["qcut", "rank", "hist"])
def test_one_date_decile_assign_matches_jax(mode, dtype):
    """The 1-D ``decile_assign`` on each hard cross-section of the panel."""
    x, valid = _hard_panel(7)
    x = x.astype(dtype)
    for col in range(x.shape[1]):
        for n_bins in (3, 10):
            lab, n_eff = ranking.decile_assign(torch.as_tensor(x[:, col]),
                                               torch.as_tensor(valid[:, col]),
                                               n_bins=n_bins, mode=mode)
            jlab, jn = jrank.decile_assign(jnp.asarray(x[:, col]),
                                           jnp.asarray(valid[:, col]),
                                           n_bins=n_bins, mode=mode)
            assert lab.dtype == torch.int32 and lab.shape == (x.shape[0],)
            np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
            assert int(n_eff) == int(jn) and n_eff.ndim == 0
