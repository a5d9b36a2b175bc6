"""LR consistency and median-filter tests."""

import numpy as np

from stereo_tpu.config import StereoConfig
from stereo_tpu.ops import lr_consistency, median_3x3, right_disparity_from_volume


def test_median_matches_numpy():
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 60, size=(9, 12)).astype(np.float32)
    got = np.array(median_3x3(d))
    p = np.pad(d, 1, mode="edge")
    want = np.empty_like(d)
    for y in range(d.shape[0]):
        for x in range(d.shape[1]):
            want[y, x] = np.median(p[y : y + 3, x : x + 3])
    np.testing.assert_allclose(got, want)


def test_lr_consistency_consistent_maps():
    """A constant-disparity scene is perfectly LR-consistent in-frame."""
    h, w, d0 = 6, 20, 4
    disp_l = np.full((h, w), float(d0), dtype=np.float32)
    disp_r = np.full((h, w), float(d0), dtype=np.float32)
    cfg = StereoConfig(lr_tau=1.0)
    ok = np.array(lr_consistency(disp_l, disp_r, cfg))
    assert bool(ok[:, d0:].all())
    assert not bool(ok[:, :d0].any())  # left border maps out of frame


def test_lr_consistency_rejects_mismatch():
    h, w = 4, 16
    disp_l = np.full((h, w), 3.0, dtype=np.float32)
    disp_r = np.full((h, w), 8.0, dtype=np.float32)  # inconsistent
    cfg = StereoConfig(lr_tau=1.0)
    ok = np.array(lr_consistency(disp_l, disp_r, cfg))
    assert not bool(ok.any())


def test_right_disparity_from_volume_constant_scene():
    """Volume with a clean minimum plane at d0 yields right disp = d0 where
    the re-indexed sample is in frame."""
    h, w, nd = 5, 18, 6
    d0 = 2
    s = np.full((h, w, nd), 500, dtype=np.int32)
    s[:, :, d0] = 5
    cfg = StereoConfig()
    disp_r = np.array(right_disparity_from_volume(s, cfg))
    np.testing.assert_array_equal(disp_r[:, : w - d0], float(d0))


def test_median_pallas_matches_golden():
    """The 19-comparator exchange network equals numpy's median over the
    edge-replicated 3x3 window, incl. edges and odd extents."""
    from stereo_tpu.ops.postprocess import median_3x3

    rng = np.random.default_rng(0)
    for shape in [(37, 150), (8, 13), (1, 5)]:
        disp = rng.normal(size=shape).astype(np.float32)
        p = np.pad(disp, 1, mode="edge")
        win = np.stack(
            [p[dy:dy + shape[0], dx:dx + shape[1]]
             for dy in range(3) for dx in range(3)]
        )
        np.testing.assert_array_equal(
            np.array(median_3x3(disp)), np.median(win, axis=0)
        )
