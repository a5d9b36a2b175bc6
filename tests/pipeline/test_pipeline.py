"""End-to-end pipeline tests on synthetic pairs with exact ground truth
(SURVEY.md §4.2: random-dot stereograms give exactly recoverable disparity)."""

import numpy as np
import pytest

from stereo_tpu import PRESETS, StereoConfig, build_pipeline, compute_disparity
from stereo_tpu.data import make_pair
from stereo_tpu.eval import evaluate_disparity


def _run(pair, cfg):
    res = compute_disparity(pair.left, pair.right, cfg)
    return evaluate_disparity(
        np.array(res.disp),
        pair.gt_disp,
        pair.gt_valid,
        np.array(res.valid),
        deltas=(0.5, 1.0, 3.0),
    )


def test_exact_recovery_constant_disparity():
    """Random-dot constant-shift pair: every valid pixel exactly recovered."""
    pair = make_pair((48, 96), max_disp=10, kind="constant", seed=0)
    cfg = StereoConfig(
        cost_fn="census",
        num_disparities=16,
        num_paths=4,
        subpixel=False,
        median_filter=False,
    )
    m = _run(pair, cfg)
    assert m["bad0.5"] == 0.0
    assert m["epe"] == 0.0
    assert m["density"] > 0.98


def test_exact_recovery_steps():
    pair = make_pair((64, 96), max_disp=12, kind="steps", seed=1)
    cfg = StereoConfig(
        cost_fn="census", num_disparities=16, num_paths=4, subpixel=False
    )
    m = _run(pair, cfg)
    assert m["bad1"] < 0.01
    assert m["density"] > 0.95


@pytest.mark.parametrize("paths", [0, 4, 8])
def test_quality_threshold_shapes(paths):
    """Frozen regression thresholds per SURVEY.md §7 step 2."""
    pair = make_pair((96, 160), max_disp=12, kind="shapes", seed=2)
    cfg = StereoConfig(
        cost_fn="census", num_disparities=16, num_paths=paths, subpixel=True
    )
    m = _run(pair, cfg)
    assert m["bad3"] < 0.02, m
    assert m["density"] > 0.9, m


def test_sad_pipeline_quality():
    pair = make_pair((96, 160), max_disp=12, kind="shapes", seed=3)
    cfg = StereoConfig(
        cost_fn="sad", sad_window=(9, 9), num_disparities=16, num_paths=0,
        subpixel=False,
    )
    m = _run(pair, cfg)
    assert m["bad3"] < 0.03, m


def test_lr_exact_matches_reindex_on_clean_scene():
    """Cheap re-indexed LR-check and the exact second pass must both keep a
    clean scene dense."""
    pair = make_pair((64, 128), max_disp=10, kind="constant", seed=4)
    base = StereoConfig(
        cost_fn="census", num_disparities=16, num_paths=4, subpixel=False,
        median_filter=False,
    )
    m_fast = _run(pair, base.replace(lr_exact=False))
    m_exact = _run(pair, base.replace(lr_exact=True))
    assert m_fast["density"] > 0.95
    assert m_exact["density"] > 0.95
    assert m_fast["bad0.5"] == 0.0
    assert m_exact["bad0.5"] == 0.0


def test_all_presets_build_and_run_tiny():
    """Every named preset (BASELINE.json configs 1-5) traces and runs."""
    pair = make_pair((40, 72), max_disp=6, kind="shapes", seed=5)
    for name, preset in PRESETS.items():
        cfg = preset.replace(num_disparities=8)
        fn = build_pipeline(cfg)
        res = fn(pair.left, pair.right)
        assert res.disp.shape == pair.left.shape, name
        assert res.valid.dtype == bool, name


def test_adaptive_p2_runs():
    pair = make_pair((48, 80), max_disp=8, kind="shapes", seed=6)
    cfg = StereoConfig(
        num_disparities=16, num_paths=4, adaptive_p2=True, p2_min=20
    )
    m = _run(pair, cfg)
    assert m["bad3"] < 0.05


def test_fill_occlusions_raises_density():
    """cfg.fill_occlusions wires native.fill_invalid_lr into
    host_postprocess (SURVEY.md C11): filled pixels become estimates, so
    density rises to ~1 while the error metrics stay sane."""
    from stereo_tpu.pipeline.pipeline import host_postprocess

    pair = make_pair((64, 128), max_disp=12, kind="shapes", seed=8)
    cfg = StereoConfig(cost_fn="census", num_disparities=16, num_paths=4)
    res = compute_disparity(pair.left, pair.right, cfg)
    d0, v0 = host_postprocess(res.disp, res.valid, cfg)
    d1, v1 = host_postprocess(
        res.disp, res.valid, cfg.replace(fill_occlusions=True)
    )
    assert v1.sum() > v0.sum()
    assert v1.all()  # every row has at least one valid pixel here
    # already-valid pixels are untouched by the fill
    np.testing.assert_array_equal(d1[v0], d0[v0])
    m0 = evaluate_disparity(d0, pair.gt_disp, pair.gt_valid, v0)
    m1 = evaluate_disparity(d1, pair.gt_disp, pair.gt_valid, v1)
    assert m1["density"] > m0["density"]
    assert m1["bad3"] < 0.10, m1


def test_pipeline_is_jittable_and_cached():
    import jax

    pair = make_pair((32, 64), max_disp=6, kind="constant", seed=7)
    cfg = StereoConfig(num_disparities=8, num_paths=4)
    fn = build_pipeline(cfg)
    r1 = fn(pair.left, pair.right)
    r2 = fn(pair.left, pair.right)
    np.testing.assert_array_equal(np.array(r1.disp), np.array(r2.disp))


@pytest.mark.parametrize(
    "cfg",
    [
        # config-1 shape: SAD + WTA-only (no SGM, so no kernel)
        StereoConfig(cost_fn="sad", sad_window=(9, 9), num_disparities=16,
                     num_paths=0, subpixel=False),
        # SAD and rank costs through the SGM kernel
        StereoConfig(cost_fn="sad", sad_window=(5, 5), num_disparities=16,
                     num_paths=8),
        StereoConfig(cost_fn="rank", census_window=(5, 5),
                     num_disparities=16, num_paths=4),
    ],
    ids=["sad-wta", "sad-sgm8", "rank-sgm4"],
)
def test_sad_rank_pallas_paths_bit_identical(cfg):
    """Every cost_fn through the SGM kernel matches the golden pipeline
    bit-exactly."""
    pair = make_pair((32, 64), max_disp=8, kind="shapes", seed=11)
    g = build_pipeline(cfg.replace(backend="jnp"))(pair.left, pair.right)
    p = build_pipeline(cfg.replace(backend="pallas_interpret"))(
        pair.left, pair.right
    )
    np.testing.assert_array_equal(np.array(g.disp), np.array(p.disp))
    np.testing.assert_array_equal(np.array(g.valid), np.array(p.valid))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_kernel_bit_identical(preset):
    """Each preset's full pipeline (its cost, paths, P2 rule, uniqueness,
    subpixel and LR check) through the SGM kernel matches the golden scan
    bit-exactly on a small pair."""
    pair = make_pair((16, 40), max_disp=8, kind="shapes", seed=5)
    cfg = PRESETS[preset]
    g = build_pipeline(cfg.replace(backend="jnp"))(pair.left, pair.right)
    p = build_pipeline(cfg.replace(backend="pallas_interpret"))(
        pair.left, pair.right
    )
    np.testing.assert_array_equal(np.array(g.disp), np.array(p.disp))
    np.testing.assert_array_equal(np.array(g.valid), np.array(p.valid))


def test_speckle_rel_scales_with_resolution():
    """cfg.speckle_rel expresses the speckle threshold as a fraction of
    H*W: at the same fraction, the small and large frames must remove
    blobs proportionally (a fixed pixel count tuned at suite scale
    under-removes at full res — docs/tuning.md)."""
    import numpy as np

    from stereo_tpu.config import StereoConfig
    from stereo_tpu.pipeline.pipeline import host_postprocess

    def frame(h, w, blob):
        disp = np.zeros((h, w), np.float32)
        valid = np.ones((h, w), bool)
        disp[2 : 2 + blob, 2 : 2 + blob] = 30.0  # isolated wrong blob
        return disp, valid

    cfg = StereoConfig(speckle_rel=0.01, speckle_tau=2.0)
    # small frame: 6x6=36 blob > 1% of 40x60=24 -> kept
    d, v = host_postprocess(*frame(40, 60, 6), cfg)
    assert v[4, 4]
    # large frame: same 36-px blob < 1% of 120x180=216 -> removed
    d, v = host_postprocess(*frame(120, 180, 6), cfg)
    assert not v[4, 4]
    # absolute knob still max'es in
    cfg2 = StereoConfig(speckle_max_size=50, speckle_rel=0.0001)
    d, v = host_postprocess(*frame(40, 60, 6), cfg2)
    assert not v[4, 4]
