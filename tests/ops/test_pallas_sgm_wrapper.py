"""Triton SGM kernel wrapper: shapes, dtypes, accumulator and lowering.

The kernel runs in interpret mode on the CPU; ``test_kernel_lowers_for_cuda``
checks that the Triton lowering accepts it at full width.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_tpu.config import StereoConfig
from stereo_tpu.ops import sgm_aggregate
from stereo_tpu.ops.pallas.sgm_kernel import _acc_dtype, sgm_aggregate_pallas


def _check(cost, cfg, image=None):
    got = sgm_aggregate_pallas(cost, cfg, image=image, interpret=True)
    want = sgm_aggregate(cost.astype(jnp.int32), cfg, image=image)
    assert got.dtype == jnp.int32 and got.shape == want.shape
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize(
    "shape",
    [(1, 9, 24), (9, 1, 16), (3, 17, 40), (17, 3, 8), (2, 2, 5), (6, 5, 33)],
    ids=lambda s: "x".join(map(str, s)),
)
def test_kernel_odd_shapes(shape):
    """Single-row/column frames, frames taller than wide, and D that is not
    a power of two (masked lane padding)."""
    rng = np.random.default_rng(sum(shape))
    cost = jnp.asarray(rng.integers(0, 25, size=shape).astype(np.int32))
    img = jnp.asarray(rng.integers(0, 256, size=shape[:2]).astype(np.uint8))
    cfg = StereoConfig(
        num_disparities=shape[2], num_paths=8, p1=5, p2=40,
        adaptive_p2=True, p2_min=9,
    )
    _check(cost, cfg, image=img)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.int32])
def test_kernel_accepts_integer_dtypes(dtype):
    rng = np.random.default_rng(3)
    cost = rng.integers(0, 25, size=(5, 6, 16)).astype(dtype)
    cfg = StereoConfig(num_disparities=16, num_paths=4, p1=3, p2=20)
    _check(jnp.asarray(cost), cfg)


def test_kernel_zero_penalties():
    """P1 = P2 = 0: every path cost equals the unary cost."""
    rng = np.random.default_rng(2)
    cost = rng.integers(0, 25, size=(6, 9, 16)).astype(np.int32)
    cfg = StereoConfig(num_disparities=16, num_paths=8, p1=0, p2=0)
    got = sgm_aggregate_pallas(jnp.asarray(cost), cfg, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), cost * 8)


def test_kernel_int32_accumulator_when_sum_exceeds_int16():
    """A P2 large enough that 8 path costs overflow int16 switches S to
    int32 and stays exact."""
    cfg = StereoConfig(num_disparities=16, num_paths=8, p1=300, p2=5000,
                       cost_fn="sad", sad_window=(3, 3))
    assert _acc_dtype(cfg) == jnp.int32
    rng = np.random.default_rng(4)
    cost = jnp.asarray(rng.integers(0, 256, size=(5, 7, 16)).astype(np.int32))
    _check(cost, cfg)


@pytest.mark.parametrize(
    "kw, dtype",
    [
        (dict(), jnp.int16),
        (dict(cost_fn="sad"), jnp.int16),
        (dict(adaptive_p2=True, p2_min=200), jnp.int16),
        (dict(p2=4200), jnp.int32),
        (dict(num_paths=4, p2=7000), jnp.int16),
        (dict(adaptive_p2=True, p2=120, p2_min=5000), jnp.int32),
    ],
)
def test_accumulator_dtype_bound(kw, dtype):
    """int16 exactly when num_paths * (max unary cost + max P2) < 2^15."""
    assert _acc_dtype(StereoConfig(**kw)) == dtype


def test_kernel_num_paths_zero_returns_cost():
    cost = jnp.arange(2 * 3 * 4, dtype=jnp.int32).reshape(2, 3, 4)
    out = sgm_aggregate_pallas(cost, StereoConfig(num_paths=0), interpret=True)
    assert out is cost


def test_kernel_adaptive_p2_requires_image():
    cfg = StereoConfig(num_disparities=16, adaptive_p2=True)
    with pytest.raises(ValueError, match="image"):
        sgm_aggregate_pallas(jnp.zeros((4, 4, 16), jnp.int32), cfg,
                             interpret=True)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize(
    "shape, cost_fn",
    [((375, 1242, 128), "census"), ((555, 900, 64), "sad")],
    ids=["kitti", "middlebury-sad"],
)
def test_kernel_lowers_for_cuda(shape, cost_fn, adaptive):
    """The Triton lowering accepts every primitive of the kernel at full
    width (compiling the Triton module needs the card)."""
    cfg = StereoConfig(
        cost_fn=cost_fn, num_disparities=shape[2], num_paths=8,
        adaptive_p2=adaptive,
    )
    fn = jax.jit(functools.partial(sgm_aggregate_pallas, cfg=cfg))
    lowered = fn.trace(
        jax.ShapeDtypeStruct(shape, jnp.int32),
        image=jax.ShapeDtypeStruct(shape[:2], jnp.uint8),
    ).lower(lowering_platforms=("cuda",))
    assert lowered.as_text().count("__gpu$xla.gpu.triton") == 8
