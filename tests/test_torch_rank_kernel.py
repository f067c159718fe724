"""Kernel K3 (``ops/kernels.py::rank_labels``, ``csrc/rank_labels.cu``):
its arithmetic emulated in NumPy against the plain sort, its route by
shape, its plan against the source, and its input checks.

The ``card`` case runs only on a CUDA card (skipped here); this file
imports no JAX, so on the card it runs without the suite's conftest:
``python -m pytest --noconftest -m card tests/test_torch_rank_kernel.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hypothesis import given, settings
from hypothesis import strategies as st

from csmom_tpu_torch.ops import kernels
from csmom_tpu_torch.ops.ranking import _rank_labels, decile_assign_panel

torch.set_num_threads(2)

SRC = Path(kernels.__file__).resolve().parent.parent / "csrc" / "rank_labels.cu"


def _k3_emulate(x, valid, n_bins):
    """K3's steps on an ``[A, M]`` NumPy panel, a month at a time: the
    radix key of each valid lane (bits, -0.0 folded, negatives flipped),
    the valid lanes first in lane order and all-ones pads after, a stable
    sort of the whole row, then ``min(B - 1, (r + 1) * B // n)`` for the
    first ``n`` outputs.  Returns ``(labels i32[A, M], n_eff i32[M])``."""
    A, M = x.shape
    wide = x.dtype == np.float64
    u = np.uint64 if wide else np.uint32
    sign = u(1 << (63 if wide else 31))
    bits = x.view(u).copy()
    bits[(bits & ~sign) == 0] = 0
    key = np.where(bits & sign, ~bits, bits | sign)
    threads, items = kernels._rank_plan(max(A, 1))
    cap = threads * items
    labels = np.full((A, M), -1, np.int32)
    n_eff = np.zeros(M, np.int32)
    for m in range(M):
        lanes = np.nonzero(valid[:, m])[0]
        n = len(lanes)
        n_eff[m] = min(n, n_bins)
        if n == 0:
            continue
        row_key = np.full(cap, ~u(0), u)
        row_pos = np.zeros(cap, np.int64)
        row_key[:n], row_pos[:n] = key[lanes, m], lanes
        order = np.argsort(row_key, kind="stable")[:n]
        r = np.arange(n, dtype=np.int64)
        labels[row_pos[order], m] = np.minimum(n_bins - 1, (r + 1) * n_bins // n)
    return labels, n_eff


def _nan_bits(dtype):
    """Valid NaNs of every kind: quiet, negative, and the largest payload,
    whose radix key is all ones (the pads' key)."""
    if dtype == np.float32:
        return np.array([0x7FC00000, 0xFFC00000, 0x7FFFFFFF, 0x7F800001],
                        np.uint32).view(np.float32)
    return np.array([0x7FF8000000000000, 0xFFF8000000000000,
                     0x7FFFFFFFFFFFFFFF, 0x7FF0000000000001],
                    np.uint64).view(np.float64)


@st.composite
def _panels(draw):
    dtype = draw(st.sampled_from([np.float32, np.float64]))
    A = draw(st.integers(1, 40))
    M = draw(st.integers(1, 6))
    pool = np.concatenate([
        np.array([-0.0, 0.0, np.inf, -np.inf, 1.0, -1.0, 2.5, -2.5, 1e-30,
                  -1e-30, 3.0e38], dtype), _nan_bits(dtype)])
    picks = draw(st.lists(st.integers(0, len(pool) + 3), min_size=A * M,
                          max_size=A * M))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    x = np.array([pool[p] if p < len(pool) else rng.normal() for p in picks],
                 dtype).reshape(A, M)
    valid = np.array(draw(st.lists(st.booleans(), min_size=A * M,
                                   max_size=A * M)), bool).reshape(A, M)
    if M > 1:
        valid[:, 0] = False                        # a month with no valid lane
    B = draw(st.sampled_from([2, 3, 5, 10]))
    return x, valid, B


@settings(max_examples=150, deadline=None)
@given(_panels())
def test_k3_emulation_equals_the_plain_sort(case):
    x, valid, B = case
    want, want_n = _k3_emulate(x, valid, B)
    labels, n_eff = kernels.rank_labels(torch.from_numpy(x),
                                        torch.from_numpy(valid), B)
    assert labels.dtype == torch.int32 and n_eff.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), want)
    np.testing.assert_array_equal(n_eff.numpy(), want_n)
    # and the rows form of the plain version, one month a row
    rows = _rank_labels(torch.from_numpy(x.T.copy()),
                        torch.from_numpy(valid.T.copy()), B)
    np.testing.assert_array_equal(rows.numpy().T, want)


def _max_nan_case(dtype):
    """A row whose two valid lanes hold the NaN of the largest payload,
    whose key equals the invalid lanes' (all ones), with invalid lanes
    before each: the plain sort once let them take the boundary slots and
    labelled both lanes 4."""
    bits = (np.array([0x7FFFFFFFFFFFFFFF], np.uint64).view(np.float64)
            if dtype == np.float64 else
            np.array([0x7FFFFFFF], np.uint32).view(np.float32))
    x = np.array([2.0, bits[0], 1.0, bits[0], 1.0], dtype)[:, None]
    valid = np.array([False, True, False, True, False])[:, None]
    return x, valid, [-1, 2, -1, 4, -1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_invalid_lanes_never_enter_the_order(dtype):
    x, valid, want = _max_nan_case(dtype)
    labels, n_eff = kernels.rank_labels(torch.from_numpy(x),
                                        torch.from_numpy(valid), 5)
    assert labels[:, 0].tolist() == want and n_eff.tolist() == [2]
    assert _k3_emulate(x, valid, 5)[0][:, 0].tolist() == want


@pytest.mark.parametrize("A, dtype, device, route", [
    (1, torch.float32, "cpu", "plain"),
    (8193, torch.float64, "cpu", "plain"),
    (0, torch.float32, "cuda", "kernel"),
    (128, torch.float32, "cuda", "kernel"),
    (3000, torch.float32, "cuda", "kernel"),
    (8192, torch.float64, "cuda", "kernel"),
    (8193, torch.float32, "cuda", "sort"),
    (100_000, torch.float64, "cuda:1", "sort"),
])
def test_the_route_is_a_function_of_width_dtype_and_device(A, dtype, device,
                                                            route):
    assert kernels.rank_route(A, dtype, device) == route
    assert kernels.rank_route(A, dtype, torch.device(device)) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.int32])
def test_the_route_refuses_other_dtypes_on_every_device(dtype):
    for device in ("cpu", "cuda"):
        with pytest.raises(TypeError, match="float32 or float64"):
            kernels.rank_route(128, dtype, device)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.rank_route(128, torch.float32, "meta")


def test_each_width_takes_the_smallest_plan_and_the_source_agrees():
    src = SRC.read_text()
    body = re.search(r"kPlans\[\]\[2\] = \{(.*?)\};", src, re.S).group(1)
    plans = tuple((int(a), int(b))
                  for a, b in re.findall(r"\{(\d+),\s*(\d+)\}", body))
    assert plans == kernels._RANK_PLANS
    assert f"kMaxLanes = {kernels.RANK_MAX_LANES};" in src
    caps = [t * i for t, i in plans]
    assert caps == sorted(caps) and kernels.RANK_MAX_LANES == caps[-1] == 8192
    for A in [1, 127, 128, 129, 512, 513, 1024, 2048, 3000, 3072, 3073, 4096,
              8191, 8192]:
        t, i = kernels._rank_plan(A)
        assert t * i >= A and t % 32 == 0
        smaller = [p for p in plans if p[0] * p[1] < t * i]
        assert all(p[0] * p[1] < A for p in smaller)
    # one instance per plan and dtype, and the C entry points the wrapper names
    assert src.count("return launch_plan<T, ") == len(plans)
    for name in ("csmom_rank_labels_f32", "csmom_rank_labels_f64"):
        assert f"int {name}(" in src
    assert "rank_labels" in kernels.build.KERNELS


def test_a_cpu_panel_takes_the_plain_path_and_launches_nothing():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 50, 24)))
    valid = torch.from_numpy(rng.random((3, 50, 24)) > 0.2)
    kernels.reset_launches()
    labels, n_eff = decile_assign_panel(x, valid, n_bins=10, mode="rank")
    want, want_n = kernels.rank_labels_plain(x, valid, 10)
    assert torch.equal(labels, want) and torch.equal(n_eff, want_n)
    assert labels.shape == (3, 50, 24) and n_eff.shape == (3, 24)
    assert kernels.rank_labels.launches == 0
    assert kernels.rank_labels.wide_rows == 0


def test_a_stride_zero_lead_and_a_single_date_are_ranked_in_place():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(30, 9)))
    valid = torch.from_numpy(rng.random((3, 30, 9)) > 0.3)
    labels, n_eff = kernels.rank_labels(x.expand(3, 30, 9), valid, 5)
    want, want_n = kernels.rank_labels_plain(x.expand(3, 30, 9).contiguous(),
                                             valid, 5)
    assert torch.equal(labels, want) and torch.equal(n_eff, want_n)
    from csmom_tpu_torch.ops.ranking import decile_assign

    one, one_n = decile_assign(x[:, 4], valid[0, :, 4], n_bins=5, mode="rank")
    assert torch.equal(one, want[0, :, 4]) and int(one_n) == int(want_n[0, 4])


def test_rows_routed_to_the_sort_are_counted(monkeypatch):
    monkeypatch.setattr(kernels, "rank_route", lambda A, dtype, device: "sort")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 40, 7)).astype(np.float32))
    valid = torch.from_numpy(rng.random((2, 40, 7)) > 0.1)
    kernels.reset_launches()
    labels, _ = kernels.rank_labels(x, valid, 10)
    assert torch.equal(labels, kernels.rank_labels_plain(x, valid, 10)[0])
    assert kernels.rank_labels.wide_rows == 2 * 7
    assert kernels.rank_labels.launches == 0
    kernels.reset_launches()
    assert kernels.rank_labels.wide_rows == 0


def test_bad_inputs_raise():
    x = torch.zeros(8, 4)
    v = torch.ones(8, 4, dtype=torch.bool)
    with pytest.raises(TypeError, match="float32 or float64"):
        kernels.rank_labels(x.to(torch.bfloat16), v, 10)
    with pytest.raises(TypeError, match="float32 or float64"):
        decile_assign_panel(x.to(torch.int64), v, mode="rank")
    with pytest.raises(TypeError, match="valid must be bool"):
        kernels.rank_labels(x, v.to(torch.uint8), 10)
    with pytest.raises(ValueError, match="inputs on"):
        kernels.rank_labels(x, v.to("meta"), 10)
    with pytest.raises(ValueError, match="same"):
        kernels.rank_labels(x, v[:, :3], 10)
    with pytest.raises(ValueError, match="same"):
        kernels.rank_labels(x[0], v[0], 10)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="n_bins"):
            kernels.rank_labels(x, v, bad)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 runs only there")
    return torch.device("cuda")


def _panel(rng, shape, dtype):
    x = rng.normal(size=shape)
    x[..., ::7, :] = np.round(x[..., ::7, :], 1)           # ties
    valid = rng.random(shape) > 0.15
    x = np.where(valid, x, np.nan)
    return torch.from_numpy(x.astype(dtype)), torch.from_numpy(valid)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(4, 3000, 696), (1, 40), (127, 33),
                                   (2, 128, 480), (8192, 20), (8193, 3)])
def test_k3_on_the_card_equals_the_plain_sort(card, shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x, valid = _panel(rng, shape, dtype)
    want, want_n = kernels.rank_labels_plain(x, valid, 10)
    xc, vc = x.to(card), valid.to(card)
    kernels.reset_launches()
    got, got_n = kernels.rank_labels(xc, vc, 10)
    again, again_n = kernels.rank_labels(xc, vc, 10)
    torch.cuda.synchronize()
    wide = shape[-2] > kernels.RANK_MAX_LANES
    assert kernels.rank_labels.launches == (0 if wide else 2)
    rows = x.numel() // shape[-2]
    assert kernels.rank_labels.wide_rows == (2 * rows if wide else 0)
    assert torch.equal(got.cpu(), want) and torch.equal(got_n.cpu(), want_n)
    assert torch.equal(got, again) and torch.equal(got_n, again_n)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k3_on_the_card_keeps_invalid_lanes_out_of_the_order(card, dtype):
    x, valid, want = _max_nan_case(dtype)
    labels, _ = kernels.rank_labels(torch.from_numpy(x).to(card),
                                    torch.from_numpy(valid).to(card), 5)
    assert labels[:, 0].tolist() == want
