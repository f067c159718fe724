"""The port's score models against csmom_tpu in float64 on seeded minute
features: ridge, elastic net and lasso on the shared time-series-CV
harness, online ridge, and the MLP (its initialization, one AdamW step,
a full fit, and weights carried from a JAX-trained fit).

Tolerances: f64 ``rtol=1e-10, atol=1e-13`` and integers equal, except
the MLP's full fits, held at scores ``rtol=1e-9, atol=1e-13`` and
``cv_mse`` / ``train_mse`` at ``rtol=1e-10``: 500 AdamW steps through
ReLU layers carry the matmuls' different summation orders (largest drift
measured on the 31,200-row golden frame: scores 9.1e-15 absolute, the
MSEs 1.4e-14 relative; scores near 0 make the relative error of a score
up to 2e-9).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from csmom_tpu import models as jmodels
from csmom_tpu.models import mlp as jmlp
from csmom_tpu.models import ridge as jridge
from csmom_tpu.signals import intraday as jintraday
from csmom_tpu_torch import models
from csmom_tpu_torch.models import mlp
from csmom_tpu_torch.models.ridge import _linear_predict

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-13, equal_nan=True)
MLP_SCORE_TOL = dict(rtol=1e-9, atol=1e-13, equal_nan=True)
MLP_MSE_TOL = dict(rtol=1e-10, atol=0)


def _features(seed, A, R):
    """Minute features and labels of seeded random walks with unequal row
    counts, as numpy arrays (the JAX package computes them)."""
    rng = np.random.default_rng(seed)
    price = 100 * np.exp(np.cumsum(rng.normal(0, 1e-3, (A, R)), 1))
    vol = rng.integers(100, 10_000, (A, R)).astype(float)
    rv = np.arange(R)[None] < rng.integers(R * 2 // 3, R + 1, A)[:, None]
    price, vol = np.where(rv, price, np.nan), np.where(rv, vol, np.nan)
    f, fv = jintraday.minute_features(jnp.asarray(price), jnp.asarray(vol),
                                      jnp.asarray(rv), window=30)
    y, yv = jintraday.next_row_return(jnp.asarray(price), fv)
    return np.asarray(f), np.asarray(y), np.asarray(yv)


@pytest.fixture(scope="module", params=[(3, 4, 300), (11, 2, 40)],
                ids=["4x300", "2x40-small"])
def data(request):
    return _features(*request.param)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_fit(got, want, fields, tol=TOL):
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **tol, err_msg=f)


LINEAR = ("coef", "intercept", "scale_mean", "scale_std", "cv_mse", "scores")


@pytest.mark.parametrize("n_splits,alpha", [(3, 1.0), (5, 10.0)])
def test_ridge_equals_the_reference(data, n_splits, alpha):
    want = jmodels.ridge_time_series_cv(*data, n_splits=n_splits, alpha=alpha)
    got = models.ridge_time_series_cv(*_t(*data), n_splits=n_splits, alpha=alpha)
    assert got.n_train.dtype == torch.int32
    assert int(got.n_train) == int(want.n_train)
    _assert_fit(got, want, LINEAR)


@pytest.mark.parametrize("alpha,l1_ratio", [(1e-8, 0.5), (1e-8, 1.0), (3e-7, 1.0),
                                            (1e-3, 0.5)])
def test_elastic_net_and_lasso_equal_the_reference(data, alpha, l1_ratio):
    want = jmodels.elastic_net_time_series_cv(*data, alpha=alpha, l1_ratio=l1_ratio)
    got = models.elastic_net_time_series_cv(*_t(*data), alpha=alpha, l1_ratio=l1_ratio)
    assert got.n_nonzero.dtype == torch.int32
    assert int(got.n_nonzero) == int(want.n_nonzero)
    assert int(got.n_train) == int(want.n_train)
    _assert_fit(got, want, LINEAR)
    as_ridge = models.as_ridge_fit(got)
    assert isinstance(as_ridge, models.RidgeFit) and as_ridge.scores is got.scores


def test_elastic_net_zeroes_every_coefficient_at_a_large_penalty():
    data = _features(3, 4, 300)
    got = models.elastic_net_time_series_cv(*_t(*data), alpha=1e-3, l1_ratio=1.0)
    assert int(got.n_nonzero) == 0 == int(jmodels.elastic_net_time_series_cv(
        *data, alpha=1e-3, l1_ratio=1.0).n_nonzero)


@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("burn_in", [0, 30])
def test_online_ridge_equals_the_reference(data, standardize, burn_in):
    want = jmodels.online_ridge_scores(*data, standardize=standardize, burn_in=burn_in)
    got = models.online_ridge_scores(*_t(*data), standardize=standardize,
                                     burn_in=burn_in)
    assert int(got.n_train) == int(want.n_train)
    np.testing.assert_array_equal(np.isfinite(got.scores.numpy()),
                                  np.isfinite(np.asarray(want.scores)))
    _assert_fit(got, want, LINEAR)


@pytest.mark.parametrize("sizes", [(5, 32, 16, 1), (5, 1), (5, 8, 1)])
def test_mlp_init_equals_the_reference(sizes):
    key = jax.random.PRNGKey(0)
    want = jmlp._init_params(key, sizes, jnp.float64)
    got = mlp.init_params(torch.as_tensor(np.asarray(key).astype(np.int64)), sizes)
    assert len(got) == len(want)
    for (gw, gb), (ww, wb) in zip(got, want):
        assert np.array_equal(gw.numpy(), np.asarray(ww))
        assert np.array_equal(gb.numpy(), np.asarray(wb))
    # the head is zero behind hidden layers; a lone linear layer is drawn
    assert (np.asarray(want[-1][0]) == 0).all() == (len(sizes) > 2)


def test_one_adamw_step_equals_optax():
    rng = np.random.default_rng(4)
    params = [(rng.normal(size=(5, 8)), rng.normal(size=8)),
              (rng.normal(size=(8, 1)), rng.normal(size=1))]
    grads = [(rng.normal(size=(5, 8)), rng.normal(size=8)),
             (rng.normal(size=(8, 1)) * 1e-6, rng.normal(size=1) * 1e3)]
    opt = optax.adamw(1e-2, weight_decay=1e-4)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    tp = [torch.tensor(a) for pair in params for a in pair]
    mu = [torch.zeros_like(p) for p in tp]
    nu = [torch.zeros_like(p) for p in tp]
    bc1, bc2 = mlp.bias_corrections(3, torch.float64, "cpu")
    for k in range(3):
        upd, state = opt.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.tensor(a) for pair in grads for a in pair]
        mlp.adamw_step(tp, tg, mu, nu, bc1[k], bc2[k], 1e-2, 1e-4)
        for got, want in zip(tp, [a for pair in jp for a in pair]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                       atol=1e-15)


@pytest.fixture(scope="module")
def mlp_fits():
    data = _features(3, 4, 300)
    want = jmodels.mlp_time_series_cv(*data)
    got = models.mlp_time_series_cv(*_t(*data))
    return data, want, got


def test_mlp_fit_equals_the_reference(mlp_fits):
    _, want, got = mlp_fits
    assert int(got.n_train) == int(want.n_train)
    _assert_fit(got, want, ("scale_mean", "scale_std"))
    _assert_fit(got, want, ("scores",), MLP_SCORE_TOL)
    _assert_fit(got, want, ("cv_mse", "train_mse"), MLP_MSE_TOL)
    for (gw, gb), (ww, wb) in zip(mlp.params_to_numpy(got.params), want.params):
        np.testing.assert_allclose(gw, np.asarray(ww), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(gb, np.asarray(wb), rtol=1e-8, atol=1e-12)


def test_mlp_without_hidden_layers_equals_the_reference():
    data = _features(11, 2, 40)
    want = jmodels.mlp_time_series_cv(*data, hidden=(), n_steps=200)
    got = models.mlp_time_series_cv(*_t(*data), hidden=(), n_steps=200)
    assert len(got.params.layers) == 1
    _assert_fit(got, want, ("scores",), MLP_SCORE_TOL)
    _assert_fit(got, want, ("cv_mse", "train_mse"), MLP_MSE_TOL)


def test_jax_trained_mlp_scores_the_same_rows_in_the_port(mlp_fits):
    (feats, y, valid), want, _ = mlp_fits
    model = mlp.params_from_numpy([(np.asarray(W), np.asarray(b))
                                   for W, b in want.params], device="cpu")
    assert [tuple(layer.weight.shape) for layer in model.layers] == [(32, 5), (16, 32),
                                                                     (1, 16)]
    Xs = (np.nan_to_num(feats.reshape(-1, 5)) - np.asarray(want.scale_mean)) / \
        np.asarray(want.scale_std)
    with torch.no_grad():
        got = model(torch.from_numpy(Xs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmlp._forward(want.params, jnp.asarray(Xs))),
                               rtol=1e-12, atol=1e-18)
    back = mlp.params_to_numpy(model)
    for (gw, gb), (ww, wb) in zip(back, want.params):
        assert np.array_equal(gw, np.asarray(ww)) and np.array_equal(gb, np.asarray(wb))


def test_linear_fits_load_from_the_reference(data):
    """A JAX fit's arrays loaded with ``from_numpy`` score the reference's
    rows as the reference did."""
    feats, y, valid = data
    Xf = np.nan_to_num(feats.reshape(-1, 5))
    for jfit, cls in ((jmodels.ridge_time_series_cv(*data), models.RidgeFit),
                      (jmodels.elastic_net_time_series_cv(*data), models.ElasticNetFit),
                      (jmodels.online_ridge_scores(*data, standardize=False),
                       models.OnlineRidgeFit)):
        fit = cls.from_numpy(device="cpu",
                             **{f.name: np.asarray(getattr(jfit, f.name))
                                for f in dataclasses.fields(jfit)})
        assert int(fit.n_train) == int(jfit.n_train)
        if cls is models.OnlineRidgeFit:   # final weights on raw features
            Xa = torch.from_numpy(Xf)
        else:
            Xa = (torch.from_numpy(Xf) - fit.scale_mean) / fit.scale_std
        pred = _linear_predict((fit.coef, fit.intercept), Xa).numpy()
        if cls is models.OnlineRidgeFit:
            want = Xf @ np.asarray(jfit.coef) + np.asarray(jfit.intercept)
        else:
            want = np.asarray(jfit.scores).reshape(-1)
        ok = valid.reshape(-1)
        np.testing.assert_allclose(pred[ok], want[ok], **TOL)


def test_harness_is_shared(data):
    """Ridge's harness with the ridge solver is the public ridge fit."""
    t = _t(*data)
    params, mean, std, cv, scores, n_train, w = models.ridge.time_series_cv_harness(
        *t, solver=lambda Xs, yf, w: models.ridge._masked_ridge(Xs, yf, w, 1.0),
        n_splits=3, train_frac=0.7, train_frac_small=0.6, small_threshold=100)
    want = jridge.ridge_time_series_cv(*data)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want.scores), **TOL)
    assert int(w.sum()) == int(n_train) == int(want.n_train)
