"""Distributed-pipeline tests on the 8-fake-CPU-device mesh (SURVEY.md §4.3).

The exact (reshard) mode must be bit-identical to the single-device golden
pipeline; the halo mode must be bit-identical wherever its exactness
guarantees hold (WTA-only pipelines; halos covering the image) and close on
general scenes.
"""

import jax
import numpy as np
import pytest

from stereo_tpu import StereoConfig, TileConfig, compute_disparity
from stereo_tpu.data import make_pair
from stereo_tpu.parallel import (
    build_exact_pipeline,
    build_halo_pipeline,
    make_tile_mesh,
)


@pytest.fixture(scope="module")
def mesh42():
    assert jax.device_count() >= 8, "tests need 8 fake CPU devices"
    return make_tile_mesh(jax.devices()[:8], mesh_shape=(4, 2))


def _golden(pair, cfg):
    res = compute_disparity(pair.left, pair.right, cfg)
    return np.array(res.disp), np.array(res.valid)


def test_exact_mode_bit_identical(mesh42):
    pair = make_pair((64, 96), max_disp=10, kind="shapes", seed=0)
    cfg = StereoConfig(num_disparities=16, num_paths=8, subpixel=True)
    fn = build_exact_pipeline(cfg, mesh42)
    disp, valid = fn(pair.left, pair.right)
    g_disp, g_valid = _golden(pair, cfg)
    np.testing.assert_array_equal(np.array(disp), g_disp)
    np.testing.assert_array_equal(np.array(valid), g_valid)


def test_exact_mode_4path_no_subpixel(mesh42):
    pair = make_pair((48, 64), max_disp=8, kind="slant", seed=1)
    cfg = StereoConfig(
        num_disparities=8, num_paths=4, subpixel=False, median_filter=False
    )
    fn = build_exact_pipeline(cfg, mesh42)
    disp, valid = fn(pair.left, pair.right)
    g_disp, g_valid = _golden(pair, cfg)
    np.testing.assert_array_equal(np.array(disp), g_disp)
    np.testing.assert_array_equal(np.array(valid), g_valid)


def test_halo_mode_wta_bit_identical(mesh42):
    """num_paths=0: every stage is local given the halo -> bit-identical."""
    pair = make_pair((64, 96), max_disp=10, kind="shapes", seed=2)
    cfg = StereoConfig(
        cost_fn="census", num_disparities=16, num_paths=0, subpixel=True
    )
    fn = build_halo_pipeline(cfg, mesh42)
    disp, valid = fn(pair.left, pair.right)
    g_disp, g_valid = _golden(pair, cfg)
    np.testing.assert_array_equal(np.array(disp), g_disp)
    np.testing.assert_array_equal(np.array(valid), g_valid)


def test_halo_mode_full_coverage_bit_identical(mesh42):
    """A halo covering the whole image makes even SGM exact — validates the
    halo/carry machinery independently of the warm-up approximation."""
    pair = make_pair((32, 48), max_disp=6, kind="shapes", seed=3)
    cfg = StereoConfig(num_disparities=8, num_paths=8, subpixel=True)
    tile_cfg = TileConfig(mesh_shape=(4, 2), halo=64)
    fn = build_halo_pipeline(cfg, mesh42, tile_cfg)
    disp, valid = fn(pair.left, pair.right)
    g_disp, g_valid = _golden(pair, cfg)
    np.testing.assert_array_equal(np.array(disp), g_disp)
    np.testing.assert_array_equal(np.array(valid), g_valid)


def test_halo_mode_sgm_close_on_scene(mesh42):
    """Default warm-up halo: bounded-error vs golden (SURVEY.md §7 part 3)."""
    pair = make_pair((96, 128), max_disp=12, kind="shapes", seed=4)
    cfg = StereoConfig(num_disparities=16, num_paths=4, subpixel=False)
    fn = build_halo_pipeline(cfg, mesh42)
    disp, valid = fn(pair.left, pair.right)
    disp, valid = np.array(disp), np.array(valid)
    g_disp, g_valid = _golden(pair, cfg)
    both = valid & g_valid
    mismatch = (np.abs(disp - g_disp) > 1)[both].mean()
    assert mismatch < 0.01, f"halo-mode disparity mismatch {mismatch:.4f}"


def test_halo_mode_nondivisible_extent(mesh42):
    """Image extents that don't divide the mesh get padded and cropped."""
    pair = make_pair((50, 70), max_disp=6, kind="constant", seed=5)
    cfg = StereoConfig(
        num_disparities=8, num_paths=0, subpixel=False, median_filter=False
    )
    fn = build_halo_pipeline(cfg, mesh42)
    disp, valid = fn(pair.left, pair.right)
    g_disp, g_valid = _golden(pair, cfg)
    assert disp.shape == (50, 70)
    np.testing.assert_array_equal(np.array(disp), g_disp)
    np.testing.assert_array_equal(np.array(valid), g_valid)


def test_batch_axis_mesh():
    mesh = make_tile_mesh(jax.devices()[:8], mesh_shape=(2, 2), batch=2)
    assert mesh.shape == {"batch": 2, "ty": 2, "tx": 2}


def test_banded_single_device():
    """Row-band processing: exact horizontal behavior, bounded-error bands;
    with a full-frame halo it is exact."""
    from stereo_tpu.parallel.bands import build_banded_pipeline

    pair = make_pair((64, 96), max_disp=10, kind="shapes", seed=11)
    cfg = StereoConfig(num_disparities=16, num_paths=8)
    g = compute_disparity(pair.left, pair.right, cfg)

    # halo covering the whole frame -> bit-identical
    fn = build_banded_pipeline(cfg, (64, 96), n_bands=4, halo=64)
    res = fn(pair.left, pair.right)
    np.testing.assert_array_equal(np.array(res.disp), np.array(g.disp))

    # default warm-up halo -> small bounded error
    fn2 = build_banded_pipeline(cfg, (64, 96), n_bands=4)
    res2 = fn2(pair.left, pair.right)
    both = np.array(res2.valid) & np.array(g.valid)
    mismatch = (np.abs(np.array(res2.disp) - np.array(g.disp)) > 1)[both].mean()
    assert mismatch < 0.02, mismatch


def test_patched_rows_and_cols():
    """Row x column patches with static offsets: exact with covering halos,
    bounded error with warm-up halos."""
    from stereo_tpu.parallel.bands import build_banded_pipeline

    pair = make_pair((64, 128), max_disp=10, kind="shapes", seed=12)
    cfg = StereoConfig(num_disparities=16, num_paths=8)
    g = compute_disparity(pair.left, pair.right, cfg)

    fn = build_banded_pipeline(cfg, (64, 128), n_bands=2, n_cols=2, halo=128)
    res = fn(pair.left, pair.right)
    np.testing.assert_array_equal(np.array(res.disp), np.array(g.disp))
    np.testing.assert_array_equal(np.array(res.valid), np.array(g.valid))

    fn2 = build_banded_pipeline(cfg, (64, 128), n_bands=2, n_cols=2)
    res2 = fn2(pair.left, pair.right)
    both = np.array(res2.valid) & np.array(g.valid)
    mismatch = (np.abs(np.array(res2.disp) - np.array(g.disp)) > 1)[both].mean()
    assert mismatch < 0.02, mismatch


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret"])
def test_halo_mode_pallas_matches_golden_tiles(mesh42, backend):
    """Halo tiles are masked (SGM carries restart at the frame's edges, not
    the tile's), which the SGM kernel does not serve: a forced kernel
    backend raises instead of silently running the golden scan."""
    pair = make_pair((64, 96), max_disp=10, kind="shapes", seed=2)
    cfg = StereoConfig(
        num_disparities=16, num_paths=8, subpixel=True, lr_check=True,
        backend=backend,
    )
    with pytest.raises(NotImplementedError, match="unmasked"):
        build_halo_pipeline(cfg, mesh42)(pair.left, pair.right)


def test_exact_mode_adaptive_p2_bit_identical(mesh42):
    """Adaptive P2 through the exact (reshard) distributed mode."""
    pair = make_pair((48, 64), max_disp=8, kind="shapes", seed=6)
    cfg = StereoConfig(
        num_disparities=16, num_paths=8, adaptive_p2=True, p2_min=20,
        subpixel=True,
    )
    fn = build_exact_pipeline(cfg, mesh42)
    disp, valid = fn(pair.left, pair.right)
    g_disp, g_valid = _golden(pair, cfg)
    np.testing.assert_array_equal(np.array(disp), g_disp)
    np.testing.assert_array_equal(np.array(valid), g_valid)


def test_halo_mode_pallas_adaptive_p2_matches_golden_tiles():
    """A 1x1 tile grid is the whole frame: no mask, so the adaptive-P2 SGM
    kernel runs inside shard_map and matches the golden scan bit-for-bit."""
    pair = make_pair((40, 72), max_disp=10, kind="shapes", seed=7)
    cfg = StereoConfig(
        num_disparities=16, num_paths=8, adaptive_p2=True, p2_min=20,
        subpixel=True, lr_check=True,
    )
    mesh1 = make_tile_mesh(jax.devices()[:1], mesh_shape=(1, 1))
    fn_g = build_halo_pipeline(cfg.replace(backend="jnp"), mesh1)
    fn_p = build_halo_pipeline(cfg.replace(backend="pallas_interpret"), mesh1)
    dg, vg = fn_g(pair.left, pair.right)
    dp, vp = fn_p(pair.left, pair.right)
    np.testing.assert_array_equal(np.array(vp), np.array(vg))
    np.testing.assert_array_equal(np.array(dp), np.array(dg))


def test_dplane_cost_sharding_bit_identical(mesh42):
    """P3 disparity-plane sharding: the cost volume is built D-sharded
    over all 8 devices, then XLA all_to_alls it to the spatial shardings
    the SGM pass families request — values must be bit-identical to the
    single-device golden pipeline (shardings move data, not values)."""
    pair = make_pair((48, 64), max_disp=10, kind="shapes", seed=11)
    cfg = StereoConfig(num_disparities=16, num_paths=8, subpixel=True)
    fn = build_exact_pipeline(cfg, mesh42, dplane_cost=True)
    disp, valid = fn(pair.left, pair.right)
    g_disp, g_valid = _golden(pair, cfg)
    np.testing.assert_array_equal(np.array(disp), g_disp)
    np.testing.assert_array_equal(np.array(valid), g_valid)


def test_dplane_cost_sharding_wta_only(mesh42):
    """num_paths=0 stays D-sharded through WTA selection: XLA realizes the
    argmin over the sharded D axis as a cross-device (min, argmin)
    combine. Exercises the P3 path with no spatial reshard at all."""
    pair = make_pair((48, 64), max_disp=10, kind="slant", seed=12)
    cfg = StereoConfig(
        num_disparities=16, num_paths=0, subpixel=True, median_filter=False
    )
    fn = build_exact_pipeline(cfg, mesh42, dplane_cost=True)
    disp, valid = fn(pair.left, pair.right)
    g_disp, g_valid = _golden(pair, cfg)
    np.testing.assert_array_equal(np.array(disp), g_disp)
    np.testing.assert_array_equal(np.array(valid), g_valid)


def test_stitched_columns_zero_penalty_bit_identical():
    """LR stitching (warm-up-only column overlap): with
    P1=P2=0 SGM carries no scan state, so the ONLY banded approximation
    (warm-up truncation) vanishes and the stitched runner must reproduce
    the whole-frame pipeline bit for bit — costs frame-true via
    right_context, the right-view map min-combined from owned-source
    partials + spills, boundary strips re-gated in XLA."""
    from stereo_tpu.parallel.bands import build_banded_pipeline

    pair = make_pair((48, 384), max_disp=12, kind="shapes", seed=3)
    for kw in [
        dict(num_disparities=16, num_paths=8, p1=0, p2=0),
        dict(num_disparities=32, num_paths=8, p1=0, p2=0, min_disparity=3,
             uniqueness_ratio=0.15),
    ]:
        cfg = StereoConfig(**kw)
        g = compute_disparity(pair.left, pair.right, cfg)
        for n_cols in (2, 3):
            for backend in ("auto", "pallas_interpret"):
                fn = build_banded_pipeline(
                    cfg.replace(backend=backend), (48, 384),
                    n_bands=2, n_cols=n_cols, lr_stitch=True,
                )
                r = fn(pair.left, pair.right)
                np.testing.assert_array_equal(
                    np.array(r.disp), np.array(g.disp)
                )
                np.testing.assert_array_equal(
                    np.array(r.valid), np.array(g.valid)
                )


def test_stitched_columns_bounded_error_and_default():
    """With real penalties the stitched runner is the DEFAULT for
    census+re-index-LR column patching; its error vs the whole frame stays
    within the usual warm-up envelope, and golden vs Pallas-interpret
    patches compose bit-identically."""
    from stereo_tpu.parallel.bands import build_banded_pipeline

    pair = make_pair((64, 256), max_disp=10, kind="shapes", seed=12)
    cfg = StereoConfig(num_disparities=16, num_paths=8)
    g = compute_disparity(pair.left, pair.right, cfg)

    # default (lr_stitch=None) engages stitching for this config
    fn = build_banded_pipeline(cfg, (64, 256), n_bands=2, n_cols=2)
    r = fn(pair.left, pair.right)
    fi = build_banded_pipeline(
        cfg.replace(backend="pallas_interpret"), (64, 256),
        n_bands=2, n_cols=2,
    )
    ri = fi(pair.left, pair.right)
    np.testing.assert_array_equal(np.array(r.disp), np.array(ri.disp))
    np.testing.assert_array_equal(np.array(r.valid), np.array(ri.valid))

    both = np.array(r.valid) & np.array(g.valid)
    mm = (np.abs(np.array(r.disp) - np.array(g.disp)) > 1)[both].mean()
    vdiff = (np.array(r.valid) != np.array(g.valid)).mean()
    assert mm < 0.02, mm
    assert vdiff < 0.02, vdiff


def test_stitched_rejects_unsupported_configs():
    from stereo_tpu.parallel.bands import build_banded_pipeline

    with pytest.raises(ValueError, match="lr_stitch"):
        build_banded_pipeline(
            StereoConfig(num_disparities=16, cost_fn="sad"),
            (64, 256), n_bands=2, n_cols=2, lr_stitch=True,
        )
    with pytest.raises(ValueError, match="lr_stitch"):
        build_banded_pipeline(
            StereoConfig(num_disparities=16), (64, 256),
            n_bands=2, n_cols=1, lr_stitch=True,
        )


def test_stitched_tiles_zero_penalty_bit_identical(mesh42):
    """Tiled LR stitching (tiling.make_stitched_tile_fn): with P1=P2=0 the
    warm-up approximation vanishes and the stitched halo pipeline must be
    bit-identical to the untiled pipeline — owned-source partials + spills
    exchanged over 'tx' reassemble the exact right-view map."""
    pair = make_pair((48, 256), max_disp=12, kind="shapes", seed=3)
    for kw in [
        dict(num_disparities=16, num_paths=8, p1=0, p2=0),
        dict(num_disparities=32, num_paths=8, p1=0, p2=0, min_disparity=3,
             uniqueness_ratio=0.15),
    ]:
        cfg = StereoConfig(**kw)
        g_disp, g_valid = _golden(pair, cfg)
        for backend in ("auto", "jnp"):
            fn = build_halo_pipeline(
                cfg.replace(backend=backend), mesh42, lr_stitch=True
            )
            r = fn(pair.left, pair.right)
            np.testing.assert_array_equal(np.array(r.disp), g_disp)
            np.testing.assert_array_equal(np.array(r.valid), g_valid)


def test_stitched_tiles_default_and_bounded_error(mesh42):
    """The stitched regime is the DEFAULT for census + re-index-LR tile
    grids; its error vs the untiled pipeline stays within the legacy
    halo mode's envelope."""
    pair = make_pair((48, 256), max_disp=12, kind="shapes", seed=7)
    cfg = StereoConfig(num_disparities=16, num_paths=8)
    g_disp, g_valid = _golden(pair, cfg)
    r = build_halo_pipeline(cfg, mesh42)(pair.left, pair.right)
    both = np.array(r.valid) & g_valid
    mm = (np.abs(np.array(r.disp) - g_disp) > 1)[both].mean()
    vdiff = (np.array(r.valid) != g_valid).mean()
    assert mm < 0.02, mm
    assert vdiff < 0.02, vdiff
    # unsupported configs raise when forced
    with pytest.raises(ValueError, match="lr_stitch"):
        build_halo_pipeline(
            StereoConfig(num_disparities=16, cost_fn="sad"), mesh42,
            lr_stitch=True,
        )(pair.left, pair.right)


def test_stitched_tiles_large_min_disparity(mesh42):
    """Regression (round-3 review): reach - halo exceeding the spill width
    SP used to slice the spill wrongly and crash at trace time; positions
    below -SP have no in-tile source, so the map's leading columns are
    prev-tile-only and must start BIG."""
    from stereo_tpu import TileConfig

    pair = make_pair((32, 384), max_disp=4, kind="shapes", seed=1)
    cfg = StereoConfig(num_disparities=16, num_paths=8, min_disparity=120,
                       p1=0, p2=0)
    tile_cfg = TileConfig(mesh_shape=(4, 2), halo=4)
    g_disp, g_valid = _golden(pair, cfg)
    fn = build_halo_pipeline(cfg, mesh42, tile_cfg, lr_stitch=True)
    r = fn(pair.left, pair.right)
    np.testing.assert_array_equal(np.array(r.disp), g_disp)
    np.testing.assert_array_equal(np.array(r.valid), g_valid)
