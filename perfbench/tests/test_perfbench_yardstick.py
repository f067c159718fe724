"""The roofline counts, the trace's reduction and the metric readers, on
numbers written into the tests."""

from __future__ import annotations

import types

import numpy as np
import pytest

from perfbench.metrics._yardstick import bound_s, event_bytes, k2_bound_inputs
from perfbench.run import load_reader
from perfbench.trace import BETWEEN_CALLS, BETWEEN_OPS, NamedStretch, Trace

H100 = "NVIDIA H100 80GB HBM3"

# chip_smoke.py's k2_bound_inputs on labels int32 [3, 50, 40] drawn from
# torch.Generator().manual_seed(5) in [-1, 10), returns f32 [50, 40],
# n_bins 10, H 12: these members per formation month, and its result
MEMBERS = [34, 26, 26, 29, 23, 23, 24, 33, 33, 29, 33, 20, 24, 33, 32, 24, 29,
           12, 31, 17, 22, 24, 26, 26, 26, 22, 25, 29, 27, 26, 33, 28, 26, 26,
           26, 27, 35, 32, 25, 25]


def test_k2_counts_equal_the_smokes():
    assert k2_bound_inputs((3, 50, 40), MEMBERS, 4, 12) == (57040, 21336)


def test_k2_bytes_at_the_north_star():
    nbytes, _ = k2_bound_inputs((4, 3000, 696), np.zeros(696), 4, 12)
    assert nbytes == 44_382_528                      # 44.38 MB
    assert bound_s(nbytes, 0, H100) == pytest.approx(nbytes / 3.35e12)
    assert bound_s(nbytes, 0, "some other card") is None


def test_event_bytes_follow_the_shapes():
    A, T = 500, 23_400
    inputs = A * T * (4 + 1 + 4) + 2 * A * 4          # price, valid, score; adv, vol
    outputs = A * T * (4 + 1 + 4) + T * (4 + 1 + 4 + 4) + A * 4
    assert event_bytes(A, T, 4) == inputs + outputs + 14 * 4


OPS = [("k1", 10.0, 30.0), ("Memcpy DtoH (Device -> Pinned)", 25.0, 40.0),
       ("cohort_tile_kernel<float, 12>", 160.0, 200.0),
       ("cohort_tile_kernel<float, 12>", 300.0, 310.0)]


def _trace():
    # two calls over 320 us of wall: kernels k1 (10-30), a copy (25-40), and
    # K2 twice (160-200, 300-310)
    return Trace(n_calls=2, wall_us=320.0, device_ops=OPS,
                 idle_gaps=[["aten::sort", 120e-6], ["aten::cat", 100e-6]])


def test_trace_busy_kernels_and_breakdown():
    t = _trace()
    assert t.busy_us() == 30.0 + 40.0 + 10.0
    assert t.kernel_count() == 3 and t.kernel_us() == 70.0
    assert t.kernel_count("cohort_tile_kernel") == 2
    b = t.breakdown()
    assert b["device_ops"][0] == ["cohort_tile_kernel<float, 12>", 50e-6]
    assert b["idle_gaps"] == [["aten::sort", 120e-6], ["aten::cat", 100e-6]]


def test_named_stretch_gaps_and_their_owners():
    n = NamedStretch(calls=[(150.0, 320.0), (0.0, 100.0)], device_ops=OPS,
                     host_ops=[("aten::cat", 210.0, 290.0), ("aten::sort", 40.0, 90.0)])
    assert n.gaps() == [(0.0, 10.0), (40.0, 160.0), (200.0, 300.0), (310.0, 320.0)]
    assert n.gap_owner(40.0, 160.0) == "aten::sort"
    assert n.gap_owner(200.0, 300.0) == "aten::cat"
    assert n.gap_owner(0.0, 10.0) == BETWEEN_OPS
    assert n.gap_owner(105.0, 140.0) == BETWEEN_CALLS
    assert dict(n.idle_gaps()) == pytest.approx(
        {"aten::sort": 120e-6, "aten::cat": 100e-6, BETWEEN_OPS: 20e-6})
    assert NamedStretch(calls=[], device_ops=[], host_ops=[]).idle_gaps() == []


def _ctx(trace, **work):
    return types.SimpleNamespace(trace=trace, work=work, device_kind=H100,
                                 calls=10, window_s=1.0, setup_s=2.0, call_s=160e-6)


def test_readers_on_a_trace():
    t = _trace()
    assert load_reader("launches_per_call.engine").read(_ctx(t)) == 1.5
    # 40 us busy a call over an untraced call's 160 us
    assert load_reader("idle_share.engine").read(_ctx(t)) == pytest.approx(75.0)
    assert load_reader("idle_share.event").read(_ctx(t)) == pytest.approx(75.0)
    assert load_reader("device_ms_per_call.event").read(_ctx(t)) == pytest.approx(0.035)
    k2 = {"labels_shape": (3, 50, 40), "members": MEMBERS, "ret_itemsize": 4, "H": 12}
    share = load_reader("k2_roofline").read(_ctx(t, k2=k2))
    # two K2 launches, 50 us in all: 25 us a launch
    assert share == pytest.approx(100 * (57040 / 3.35e12) / 25e-6)
    eb = event_bytes(16, 180, 4)
    share = load_reader("event_roofline").read(_ctx(t, event_bytes=eb))
    assert share == pytest.approx(100 * (eb / 3.35e12) / 35e-6)
    assert load_reader("engine_call_ms").read(_ctx(t)) == 100.0
    assert load_reader("event_call_ms").read(_ctx(t)) == 100.0
    assert load_reader("setup_s").read(_ctx(t)) == 2.0


@pytest.mark.parametrize("name", ["launches_per_call.engine", "idle_share.engine",
                                  "k2_roofline", "device_ms_per_call.event",
                                  "idle_share.event", "event_roofline"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert load_reader(name).read(_ctx(None)) is None
    empty = Trace(n_calls=3, wall_us=10.0, device_ops=[])
    assert load_reader(name).read(_ctx(empty, k2=None)) is None
