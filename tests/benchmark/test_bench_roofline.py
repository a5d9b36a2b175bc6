"""Compulsory counts, peaks and the per-layer readers' arithmetic."""

import json
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.counts import least_seconds, stage_counts
from benchmark.trace import Reduction
from benchmark.view import View

ROOT = Path(__file__).resolve().parents[2]
KITTI = json.loads(
    (ROOT / "benchmark/configs/kitti2015_census_sgm8_d128.json").read_text()
)
H100 = "NVIDIA H100 80GB HBM3"


def test_kitti_counts_by_hand():
    n = 375 * 1242
    c = stage_counts(KITTI)
    assert c["cost_volume"] == (2 * n * 62 + 2 * n * 128 * 2, 2 * n + n * 128)
    assert c["sgm"] == (9 * n * 128 * 8, 3 * n * 128)
    assert c["select_post"] == (3 * n * 128 + 38 * n, 2 * n * 128 + 5 * n)


def test_least_time_takes_the_larger_bound():
    peaks = harness.load_peaks(H100)
    ops, nbytes = stage_counts(KITTI)["sgm"]
    assert least_seconds(ops, nbytes, peaks) == pytest.approx(ops / 6.7e13)
    ops, nbytes = stage_counts(KITTI)["cost_volume"]
    assert least_seconds(ops, nbytes, peaks) == pytest.approx(nbytes / 3.35e12)


def test_unknown_device_kind_raises():
    with pytest.raises(KeyError, match="no peaks"):
        harness.load_peaks("NVIDIA A100-SXM4-40GB")
    with pytest.raises(KeyError):
        harness.load_peaks("cpu")


def _view(layer_s, frames=10, window=0.1, busy=None, spans=None, peaks=True):
    red = Reduction(
        window_s=window, busy_s=busy or {0: 0.08}, layer_s=layer_s,
        op_s={}, gap_s={},
    )
    return View(
        reduction=red, frames_traced=frames, frames_window=100,
        span_s=spans or {}, counts=stage_counts(KITTI),
        peaks=harness.load_peaks(H100) if peaks else None, chips=1,
    )


def read(name, view):
    return harness.load_reader(name)(view)


def test_roofline_share():
    view = _view({"sgm": 0.025})           # 2.5 ms per frame
    assert read("sgm_ms", view) == pytest.approx(2.5)
    share = read("sgm_roofline", view)
    assert share == pytest.approx(100 * (9 * 375 * 1242 * 128 * 8 / 6.7e13) / 2.5e-3)
    assert 0 < share < 100


def test_readers_return_none_without_data():
    view = _view({}, peaks=False)
    for name in ("cost_volume_ms", "cost_volume_roofline", "sgm_roofline",
                 "select_post_ms", "frame_mfu"):
        assert read(name, view) is None, name
    empty = View(None, 0, 0, {}, stage_counts(KITTI), None, 1)
    assert read("device_idle_pct", empty) is None


def test_idle_share_is_the_mean_over_cards():
    view = _view({}, busy={0: 0.08, 1: 0.06}, window=0.1)
    assert read("device_idle_pct", view) == pytest.approx(30.0)


def test_frame_mfu():
    view = _view({"sgm": 0.01}, frames=10, window=0.1)
    ops = sum(o for o, _ in stage_counts(KITTI).values())
    assert read("frame_mfu", view) == pytest.approx(100 * ops * 10 / (6.7e13 * 0.1))
