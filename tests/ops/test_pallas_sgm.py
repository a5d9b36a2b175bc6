"""Triton SGM kernel vs the golden scan (kernel in interpret mode on the CPU).

The kernel is compiled for the GPU only on the card (chip_smoke.py compares
it there at full width); here the interpreter runs the same kernel body.
Shapes, dtypes and the CUDA lowering are in test_pallas_sgm_wrapper.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_tpu.config import StereoConfig
from stereo_tpu.ops import cost_volume, sgm_aggregate
from stereo_tpu.ops.pallas.sgm_kernel import sgm_aggregate_pallas

P2_MODES = {
    "fixed": {},
    "adaptive": dict(adaptive_p2=True, p2_min=17),
    "adaptive_floor12": dict(adaptive_p2=True, p2_min=17, adaptive_grad_floor=12),
}
COSTS = {
    "census": dict(cost_fn="census", census_window=(5, 5)),
    "rank": dict(cost_fn="rank", census_window=(5, 5)),
    "sad": dict(cost_fn="sad", sad_window=(3, 3)),
}


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    right = np.roll(left, -3, axis=1) // 2 + rng.integers(
        0, 128, size=(h, w)
    ).astype(np.uint8)
    return jnp.asarray(left), jnp.asarray(right)


def _check(cost, cfg, image=None):
    got = sgm_aggregate_pallas(cost, cfg, image=image, interpret=True)
    want = sgm_aggregate(cost.astype(jnp.int32), cfg, image=image)
    assert got.dtype == jnp.int32 and got.shape == want.shape
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("p2_mode", sorted(P2_MODES))
@pytest.mark.parametrize("cost_fn", sorted(COSTS))
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("paths", [4, 8])
def test_kernel_matches_golden(paths, d, cost_fn, p2_mode):
    """Real cost volumes (their value ranges and int8/int16 reads) through
    every path set, disparity width and P2 rule."""
    left, right = _pair(4, 7, seed=paths + d)
    cfg = StereoConfig(
        num_disparities=d, num_paths=paths, p1=7, p2=100,
        **COSTS[cost_fn], **P2_MODES[p2_mode],
    )
    _check(cost_volume(left, right, cfg), cfg, image=left)
