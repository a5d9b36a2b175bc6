"""Scaling-efficiency harness tests (SURVEY.md §3.5, BASELINE.json:5).

Real multi-host hardware is unavailable in CI; these runs on the 8 fake
CPU devices validate the INSTRUMENT — that scaling_report builds the right
meshes, times them, and emits sane rows — not the hardware scaling curve.
"""

import jax
import pytest

from stereo_tpu import StereoConfig
from stereo_tpu.eval.scaling import scaling_report


CFG = StereoConfig(
    cost_fn="census", num_disparities=8, num_paths=4, subpixel=False,
    lr_check=False, median_filter=False,
)


def test_scaling_report_batch_axis():
    rows = scaling_report(
        CFG, image_shape=(32, 48), device_counts=[1, 2, 4, 8], iters=2
    )
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    prev_batch = 0
    for r in rows:
        assert set(r) == {
            "devices", "batch", "fps", "fps_per_device", "efficiency",
        }
        assert r["fps"] > 0
        assert r["batch"] == r["devices"]  # frames_per_device=1, no tiles
        assert r["batch"] > prev_batch
        prev_batch = r["batch"]
        assert 0 < r["efficiency"] < 10  # sane, not asserted linear on CPU
        assert r["fps_per_device"] == pytest.approx(
            r["fps"] / r["devices"], rel=1e-3
        )
    assert rows[0]["efficiency"] == 1.0  # by definition at the base count


def test_scaling_report_with_tiles():
    """tiles_per_device folds ('ty','tx') under the batch axis: 4 devices
    as 1 frame x 2x2 tiles, 8 devices as 2 frames x 2x2 tiles."""
    rows = scaling_report(
        CFG, image_shape=(32, 48), device_counts=[4, 8],
        tiles_per_device=(2, 2), iters=2,
    )
    assert [r["devices"] for r in rows] == [4, 8]
    assert [r["batch"] for r in rows] == [1, 2]
    for r in rows:
        assert r["fps"] > 0


def test_scaling_report_respects_available_devices():
    """Default device_counts never exceed what exists."""
    rows = scaling_report(CFG, image_shape=(32, 48), iters=1)
    assert all(r["devices"] <= len(jax.devices()) for r in rows)
    assert rows[0]["devices"] == 1
