"""Model-zoo tests: every family builds, runs, and meets quality gates."""

import numpy as np
import pytest

from stereo_tpu import StereoConfig
from stereo_tpu.data import make_pair
from stereo_tpu.eval import evaluate_disparity
from stereo_tpu.models import MODELS, get_model


CFG = StereoConfig(cost_fn="census", num_disparities=32, num_paths=4)


def _quality(model, pair):
    fn = model.build()
    res = fn(pair.left, pair.right)
    return evaluate_disparity(
        np.array(res.disp), pair.gt_disp, pair.gt_valid, np.array(res.valid)
    )


def test_registry_lists_all():
    assert set(MODELS) == {"classic", "block_matching", "pyramid"}


def test_classic_model():
    pair = make_pair((96, 160), max_disp=24, kind="shapes", seed=0)
    m = _quality(get_model("classic", cfg=CFG), pair)
    assert m["bad3"] < 0.02, m


def test_block_matching_model():
    pair = make_pair((96, 160), max_disp=24, kind="shapes", seed=1)
    cfg = StereoConfig(cost_fn="sad", num_disparities=32, subpixel=False)
    m = _quality(get_model("block_matching", cfg=cfg), pair)
    assert m["bad3"] < 0.05, m


def test_pyramid_model_quality():
    # The pyramid family trades accuracy at discontinuities for ~D/R less
    # work (see models/pyramid.py); the gate reflects that documented trade
    # on this discontinuity-heavy synthetic scene.
    pair = make_pair((96, 160), max_disp=24, kind="shapes", seed=2)
    m = _quality(get_model("pyramid", cfg=CFG, residual_range=16), pair)
    assert m["bad3"] < 0.10, m
    assert m["density"] > 0.85, m


def test_pyramid_smooth_scene_near_exact():
    """On smooth disparity fields the pyramid matches classic closely."""
    pair = make_pair((96, 160), max_disp=24, kind="slant", seed=9)
    m = _quality(get_model("pyramid", cfg=CFG, residual_range=16), pair)
    assert m["bad3"] < 0.01, m


def test_pyramid_tracks_classic():
    """Pyramid must stay within a few x of classic's error on easy scenes."""
    pair = make_pair((96, 160), max_disp=20, kind="steps", seed=3)
    mc = _quality(get_model("classic", cfg=CFG), pair)
    mp = _quality(get_model("pyramid", cfg=CFG), pair)
    assert mp["bad3"] <= max(0.05, 6 * mc["bad3"] + 0.02), (mc, mp)


def test_model_describe():
    d = get_model("pyramid", cfg=CFG).describe()
    assert d["model"] == "pyramid" and d["D"] == 32


def test_pyramid_residual_volume_matches_bruteforce():
    """The residual volume equals a per-pixel Hamming loop, including
    frame-edge clipping and bases larger than x (index underflow)."""
    import jax.numpy as jnp

    from stereo_tpu.models.pyramid import _residual_cost_volume
    from stereo_tpu.ops import census_transform

    rng = np.random.default_rng(11)
    h, w, r = 6, 20, 8
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    cl = np.asarray(census_transform(jnp.asarray(left), (7, 9)))
    cr = np.asarray(census_transform(jnp.asarray(right), (7, 9)))
    base = rng.integers(0, 30, size=(h, w)).astype(np.int32)
    got = np.asarray(
        _residual_cost_volume(
            jnp.asarray(cl), jnp.asarray(cr), jnp.asarray(base), r // 2, r
        )
    )
    want = np.zeros((h, w, r), np.int32)
    for y in range(h):
        for x in range(w):
            for o in range(r):
                src = min(max(x - base[y, x] - (o - r // 2), 0), w - 1)
                bits = np.bitwise_xor(cl[y, x], cr[y, src])
                want[y, x, o] = sum(bin(int(b)).count("1") for b in bits)
    np.testing.assert_array_equal(got, want)


def test_pyramid_kernel_matches_golden():
    """The pyramid's coarse and residual aggregations through the SGM
    kernel (interpret mode) are bit-identical to the golden scan."""
    pair = make_pair((24, 48), max_disp=10, kind="shapes", seed=4)
    cfg = StereoConfig(cost_fn="census", num_disparities=16, num_paths=8)
    outs = [
        get_model("pyramid", cfg=cfg.replace(backend=b)).build()(
            pair.left, pair.right
        )
        for b in ("jnp", "pallas_interpret")
    ]
    np.testing.assert_array_equal(np.array(outs[0].disp), np.array(outs[1].disp))
    np.testing.assert_array_equal(np.array(outs[0].valid), np.array(outs[1].valid))
