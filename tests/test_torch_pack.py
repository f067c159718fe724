"""The port's packed panels against csmom_tpu's: the same layout (version 1),
so a pack written by either package loads in the other with equal values,
masks, tickers, times and field order; round trips, memmapped loads,
single-field packs, the CSV cache conversion in f32, and the memmapped
hand-off to tensors.  Also the Panel snapshot (.npz) across packages."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from csmom_tpu.panel import pack as jpack
from csmom_tpu.panel.panel import Panel as JPanel
from csmom_tpu.panel.panel import PanelBundle as JBundle
from csmom_tpu_torch.panel import pack
from csmom_tpu_torch.panel.panel import Panel, PanelBundle

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
UNIVERSE = os.path.join(FIXTURES, "universe")
UNIVERSE_TICKERS = sorted(n.split("_")[0] for n in os.listdir(UNIVERSE))


def _arrays(seed, A=7, T=40):
    rng = np.random.default_rng(seed)
    vals = rng.normal(100, 10, size=(A, T))
    vals[rng.random((A, T)) < 0.2] = np.nan
    vol = np.abs(rng.normal(1e6, 1e5, size=(A, T)))
    times = np.arange("2020-01-01", T, dtype="datetime64[D]").astype("datetime64[ns]")
    return vals, vol, tuple(f"T{i}" for i in range(A)), times


def _bundle(cls_panel, cls_bundle, seed, fields=("adj_close", "volume")):
    vals, vol, tickers, times = _arrays(seed)
    src = {"adj_close": vals, "volume": vol, "close": vals * 1.01}
    panels = {f: cls_panel.from_dense(src[f], tickers, times, name=f) for f in fields}
    if len(panels) == 1:
        return next(iter(panels.values()))
    return cls_bundle(panels=panels, tickers=tickers, times=times)


def _assert_same(got, want):
    """Two loads (a Panel or a bundle, of either package) hold the same data."""
    if hasattr(want, "panels"):
        assert got.fields == want.fields
        assert got.tickers == want.tickers
        np.testing.assert_array_equal(got.times, want.times)
        for f in want.fields:
            _assert_same(got[f], want[f])
        return
    assert np.asarray(got.values).tobytes() == np.asarray(want.values).tobytes()
    assert np.asarray(got.values).dtype == np.asarray(want.values).dtype
    np.testing.assert_array_equal(np.asarray(got.mask), np.asarray(want.mask))
    assert got.tickers == want.tickers and got.name == want.name
    np.testing.assert_array_equal(got.times, want.times)
    assert got.times.dtype == want.times.dtype


@pytest.mark.parametrize("fields", [("adj_close", "volume"), ("adj_close",),
                                    ("volume", "close", "adj_close")])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_packs_interchange_in_both_directions(tmp_path, fields, writer):
    port_obj = _bundle(Panel, PanelBundle, 3, fields)
    ref_obj = _bundle(JPanel, JBundle, 3, fields)
    out = str(tmp_path / "p")
    if writer == "port":
        pack.save_packed(port_obj, out)
    else:
        jpack.save_packed(ref_obj, out)
    assert pack.is_packed(out) and jpack.is_packed(out)
    assert json.load(open(os.path.join(out, "meta.json")))["version"] == 1
    got, want = pack.load_packed(out), jpack.load_packed(out)
    assert isinstance(got, Panel if len(fields) == 1 else PanelBundle)
    _assert_same(got, want)
    if len(fields) == 1:
        _assert_same(got, port_obj)
    else:   # a pack holds its fields in sorted order
        assert got.fields == tuple(sorted(fields))
        for f in fields:
            _assert_same(got[f], port_obj[f])
    # the two writers write the same files, byte for byte
    other = str(tmp_path / "q")
    (jpack.save_packed(ref_obj, other) if writer == "port"
     else pack.save_packed(port_obj, other))
    for name in sorted(os.listdir(out)):
        assert open(os.path.join(out, name), "rb").read() == \
            open(os.path.join(other, name), "rb").read(), name


def test_load_is_memmapped_and_eager_on_request(tmp_path):
    pack.save_packed(_bundle(Panel, PanelBundle, 4), str(tmp_path / "p"))
    q = pack.load_packed(str(tmp_path / "p"))
    assert isinstance(q["adj_close"].values, np.memmap)
    assert isinstance(q["adj_close"].mask, np.memmap)
    eager = pack.load_packed(str(tmp_path / "p"), mmap=False)
    assert not isinstance(eager["adj_close"].values, np.memmap)
    _assert_same(eager, q)


def test_refusals_and_orphan_cleanup(tmp_path):
    b = _bundle(Panel, PanelBundle, 5, ("adj_close", "volume", "close"))
    out = pack.save_packed(b, str(tmp_path / "p"))
    pack.save_packed(b["adj_close"], out)   # repack with fewer fields
    assert sorted(os.listdir(out)) == ["adj_close.mask.npy", "adj_close.values.npy",
                                       "meta.json", "times.npy"]
    meta = json.load(open(os.path.join(out, "meta.json")))
    meta["version"] = 99
    json.dump(meta, open(os.path.join(out, "meta.json"), "w"))
    with pytest.raises(ValueError, match="version 99"):
        pack.load_packed(out)
    px = b["adj_close"]
    other = Panel.from_dense(px.values[:, :-1], px.tickers, px.times[:-1], name="close")
    with pytest.raises(ValueError, match="shared calendar"):
        pack.save_packed(PanelBundle(panels={"adj_close": px, "close": other},
                                     tickers=px.tickers, times=px.times),
                         str(tmp_path / "bad"))
    with pytest.raises(ValueError, match="empty bundle"):
        pack.save_packed(PanelBundle(panels={}, tickers=(), times=px.times),
                         str(tmp_path / "empty"))


@pytest.mark.parametrize("dtype", [None, np.float32])
def test_pack_csv_cache_equals_the_reference(tmp_path, dtype):
    out, jout = str(tmp_path / "port"), str(tmp_path / "ref")
    pack.pack_csv_cache(UNIVERSE, UNIVERSE_TICKERS, out, dtype=dtype)
    jpack.pack_csv_cache(UNIVERSE, UNIVERSE_TICKERS, jout, dtype=dtype)
    got, want = pack.load_packed(out), jpack.load_packed(jout)
    _assert_same(got, want)
    assert got["adj_close"].values.dtype == (dtype or np.float64)
    for name in sorted(os.listdir(out)):
        assert open(os.path.join(out, name), "rb").read() == \
            open(os.path.join(jout, name), "rb").read(), name
    with pytest.raises(ValueError, match="no readable daily caches"):
        pack.pack_csv_cache(UNIVERSE, ["NOPE"], str(tmp_path / "none"))


def test_memmapped_pack_to_tensors_copies_once_without_warning(tmp_path):
    b = _bundle(Panel, PanelBundle, 6)
    pack.save_packed(b, str(tmp_path / "p"))
    q = pack.load_packed(str(tmp_path / "p"))["adj_close"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        v, m = q.tensors(device="cpu")
        v32, _ = q.tensors(device="cpu", dtype=torch.float32)
    assert v.dtype == torch.float64 and m.dtype == torch.bool
    np.testing.assert_array_equal(v.numpy(), b["adj_close"].values)
    np.testing.assert_array_equal(m.numpy(), b["adj_close"].mask)
    np.testing.assert_array_equal(v32.numpy(), b["adj_close"].values.astype(np.float32))
    v += 1.0   # the tensor owns its memory: the file mapping is untouched
    np.testing.assert_array_equal(np.asarray(q.values), b["adj_close"].values)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_panel_snapshot_interchanges(tmp_path, writer):
    vals, _, tickers, times = _arrays(8)
    p = Panel.from_dense(vals, tickers, times, name="adj_close")
    jp = JPanel.from_dense(vals, tickers, times, name="adj_close")
    path = (p if writer == "port" else jp).save(str(tmp_path / "snap"))
    assert path.endswith(".npz")
    _assert_same(Panel.load(path), JPanel.load(path))
    _assert_same(Panel.load(path), p)
