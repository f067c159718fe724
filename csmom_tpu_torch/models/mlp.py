"""MLP score model on the shared time-series-CV harness.

Counterpart of :mod:`csmom_tpu.models.mlp`: a small multilayer perceptron
over the five minute-bar features, on the scaler / expanding-fold /
score-everything scaffold of
:func:`csmom_tpu_torch.models.ridge.time_series_cv_harness`.  Training is
full-batch AdamW for a fixed step count; gradients come from autograd on
the reference's loss ``sum(w * (pred - y)**2) / max(sum(w), 1)``, and the
optimizer applies optax's ``adamw`` update in optax's order (Adam moments,
bias correction, then decoupled weight decay, then the learning rate),
which ``torch.optim.AdamW`` does not.

Parameters are initialized from :func:`csmom_tpu_torch.random.normal` on
an explicit ``PRNGKey(seed)`` — the JAX package's He-normal draw — on the
CPU, then moved to the data's device, so every device starts from the
same weights.

Weights carry across both packages: the JAX package stores a layer as
``W [in, out]``, ``nn.Linear`` as ``[out, in]``; :func:`params_from_numpy`
and :func:`params_to_numpy` transpose.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from csmom_tpu_torch import random
from csmom_tpu_torch.device import resolve_device
from csmom_tpu_torch.models.ridge import time_series_cv_harness

# optax.adamw's defaults (b1, b2, eps; eps_root is 0)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class MLP(nn.Module):
    """ReLU hidden layers and a linear head, one score per row."""

    def __init__(self, sizes, dtype=torch.float64, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(i, o, dtype=dtype, device=device)
            for i, o in zip(sizes[:-1], sizes[1:]))

    def forward(self, X):
        # h @ W.T + b as a product then a sum (the JAX package's order),
        # not nn.Linear's fused addmm
        h = X
        for layer in self.layers[:-1]:
            h = torch.relu(h @ layer.weight.T + layer.bias)
        head = self.layers[-1]
        return (h @ head.weight.T + head.bias)[:, 0]


def params_from_numpy(params, device=None) -> MLP:
    """The port's :class:`MLP` carrying the JAX package's weights: ``params``
    is a list of ``(W [in, out], b [out])`` numpy arrays (a ``csmom_tpu``
    ``MLPFit.params``); the model keeps their dtype.  ``device`` is cuda by
    default and raises without a card unless ``device="cpu"``."""
    return _mlp_of([(torch.tensor(np.array(W)), torch.tensor(np.array(b)))
                    for W, b in params], resolve_device(device))


def _mlp_of(params, device) -> MLP:
    """An :class:`MLP` on ``device`` holding ``(W [in, out], b [out])``
    tensors, with autograd off."""
    sizes = (params[0][0].shape[0],) + tuple(W.shape[1] for W, _ in params)
    mlp = MLP(sizes, dtype=params[0][0].dtype, device=device)
    with torch.no_grad():
        for layer, (W, b) in zip(mlp.layers, params):
            layer.weight.copy_(W.T)
            layer.bias.copy_(b)
    return mlp.requires_grad_(False)


def params_to_numpy(mlp: MLP) -> list:
    """The JAX package's layout of an :class:`MLP`'s weights: a list of
    ``(W [in, out], b [out])`` numpy arrays."""
    return [(layer.weight.detach().T.cpu().numpy().copy(),
             layer.bias.detach().cpu().numpy().copy()) for layer in mlp.layers]


@dataclasses.dataclass(frozen=True)
class MLPFit:
    params: MLP                # the trained model (params_to_numpy: JAX layout)
    scale_mean: torch.Tensor   # f[F]
    scale_std: torch.Tensor    # f[F]
    cv_mse: torch.Tensor       # f[n_splits]
    scores: torch.Tensor       # f[A, R]
    n_train: torch.Tensor      # i32
    train_mse: torch.Tensor    # f[] final-model MSE on its training rows


def init_params(key, sizes, dtype=torch.float64):
    """He-normal hidden weights, zero biases, and a zero output layer (so
    the first prediction is exactly 0), as the JAX package draws them:
    one ``split`` of ``key`` per layer, ``normal(sub, (fan_in, fan_out))
    * sqrt(2 / fan_in)``.  A list of ``(W [in, out], b [out])`` tensors on
    the key's device."""
    params = []
    n_layers = len(sizes) - 1
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        key, sub = random.split(key)
        if i == n_layers - 1 and n_layers > 1:
            w = torch.zeros((fan_in, fan_out), dtype=dtype, device=key.device)
        else:
            w = random.normal(sub, (fan_in, fan_out), dtype) * torch.sqrt(
                torch.tensor(2.0 / fan_in, dtype=dtype, device=key.device))
        params.append((w, torch.zeros((fan_out,), dtype=dtype, device=key.device)))
    return params


def _bias_correction(decay: float, count: int, dtype):
    """``1 - decay**count`` in the moments' float type (optax's, which
    the JAX package computes in its default float)."""
    if dtype == torch.float64:
        return 1.0 - decay ** count
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def bias_corrections(n_steps: int, dtype, device):
    """optax's ``1 - b**count`` for steps 1..n_steps of both moments, as
    two tensors ``[n_steps]`` on ``device`` (one copy each, so no step
    copies a divisor to the device, and a division by a tensor divides
    where a Python number would be multiplied by its reciprocal on CUDA)."""
    return tuple(
        torch.tensor([_bias_correction(b, k, dtype) for k in range(1, n_steps + 1)],
                     dtype=dtype, device=device)
        for b in (_B1, _B2))


def adamw_step(params, grads, mu, nu, bc1, bc2, learning_rate, weight_decay):
    """One optax ``adamw`` update in place, with this step's bias
    corrections ``bc1``/``bc2`` (:func:`bias_corrections`); ``mu``/``nu``
    are the moment tensors beside ``params``.  Each line is one
    multi-tensor operation over every parameter (the same arithmetic, per
    element, as optax's per-leaf updates)."""
    f = torch
    f._foreach_mul_(mu, _B1)                                   # b1*m + (1-b1)*g
    f._foreach_add_(mu, f._foreach_mul(grads, 1 - _B1))
    f._foreach_mul_(nu, _B2)                                   # b2*v + (1-b2)*g*g
    f._foreach_add_(nu, f._foreach_mul(f._foreach_mul(grads, grads), 1 - _B2))
    den = f._foreach_div(nu, bc2)                              # sqrt(v_hat) + eps
    f._foreach_sqrt_(den)
    f._foreach_add_(den, _EPS)
    u = f._foreach_div(mu, bc1)                                # m_hat / den
    f._foreach_div_(u, den)
    f._foreach_add_(u, f._foreach_mul(params, weight_decay))  # + decay * p
    f._foreach_mul_(u, -1 * learning_rate)                     # * -lr
    f._foreach_add_(params, u)


def _fit_mlp(Xs, y, w, key, hidden, n_steps, learning_rate, weight_decay):
    """Full-batch AdamW for a fixed step count on rows weighted by w (0/1).

    Returns the trained :class:`MLP`, detached from autograd."""
    dt = Xs.dtype
    sizes = (Xs.shape[1],) + tuple(hidden) + (1,)
    mlp = _mlp_of(init_params(key, sizes, dt), Xs.device).requires_grad_(True)
    params = list(mlp.parameters())
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    bc1, bc2 = bias_corrections(n_steps, dt, Xs.device)
    n = torch.clamp(torch.sum(w), min=1.0)
    for k in range(n_steps):
        loss = torch.sum(w * (mlp(Xs) - y) ** 2) / n
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            adamw_step(params, grads, mu, nu, bc1[k], bc2[k], learning_rate,
                       weight_decay)
    return mlp.requires_grad_(False)


def _predict(mlp, Xs):
    with torch.no_grad():
        return mlp(Xs)


def mlp_time_series_cv(
    features,
    y,
    valid,
    n_splits: int = 3,
    hidden: tuple = (32, 16),
    n_steps: int = 500,
    learning_rate: float = 1e-2,
    weight_decay: float = 1e-4,
    seed: int = 0,
    train_frac: float = 0.7,
    train_frac_small: float = 0.6,
    small_threshold: int = 100,
) -> MLPFit:
    """Scale -> expanding-window CV -> final MLP -> score full history.

    Args:
      features: f[A, R, F] compacted feature tensor (padded rows arbitrary).
      y: f[A, R] next-row return labels.
      valid: bool[A, R] modeling rows.
      hidden: hidden-layer widths; ``()`` is a linear model trained by
        gradient descent.
      n_steps: fixed full-batch AdamW steps per fit (per fold + final).
      seed: the ``PRNGKey`` of every fit's initialization.
    """
    key = random.PRNGKey(seed)
    solver = lambda Xs, yf, w: _fit_mlp(  # noqa: E731
        Xs, yf, w, key, hidden, n_steps, learning_rate, weight_decay)
    mlp, mean, std, cv_mse, scores, n_train, w_tr = time_series_cv_harness(
        features, y, valid, solver=solver, n_splits=n_splits,
        train_frac=train_frac, train_frac_small=train_frac_small,
        small_threshold=small_threshold, predict=_predict,
    )
    # final-model training error, from the harness's own scores and mask
    A, R = y.shape
    sf = torch.nan_to_num(scores.reshape(A * R))
    yf = torch.nan_to_num(y.reshape(A * R))
    train_mse = torch.sum(w_tr * (sf - yf) ** 2) / torch.clamp(torch.sum(w_tr), min=1.0)
    return MLPFit(params=mlp, scale_mean=mean, scale_std=std, cv_mse=cv_mse,
                  scores=scores, n_train=n_train, train_mse=train_mse)
