"""Which SGM implementation each call kind gets (pipeline.aggregate).

The rule: the Triton kernel on the GPU for unmasked, unconstrained
aggregation; the golden scan for masked tiles, the exact reshard and every
call on another platform; a forced kernel backend raises rather than falls
back. ``jax.default_backend`` is patched to stand in for the card, and a spy
stands in for the compiled kernel, which only the card can run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_tpu import StereoConfig, compute_disparity
from stereo_tpu.data import make_pair
from stereo_tpu.ops import sgm_aggregate
from stereo_tpu.ops.pallas import sgm_kernel
from stereo_tpu.pipeline import pipeline
from stereo_tpu.pipeline.pipeline import _sgm_kernel_mode

CFG = StereoConfig(num_disparities=16, num_paths=8)
MASK = jnp.ones((4, 4), bool)
CONSTRAIN = (lambda t: t, lambda t: t)


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


@pytest.fixture
def kernel_calls(monkeypatch):
    """Record compiled-kernel calls; answer with the golden scan."""
    calls = []

    def spy(cost, cfg, image=None, interpret=False):
        calls.append(interpret)
        return sgm_aggregate(cost.astype(jnp.int32), cfg, image=image)

    monkeypatch.setattr(sgm_kernel, "sgm_aggregate_pallas", spy)
    return calls


@pytest.mark.parametrize(
    "valid, constrain, want",
    [(None, None, False), (MASK, None, None), (None, CONSTRAIN, None),
     (MASK, CONSTRAIN, None)],
    ids=["frame", "masked", "constrained", "both"],
)
def test_auto_on_gpu(on_gpu, valid, constrain, want):
    assert _sgm_kernel_mode(CFG, valid, constrain) is want


@pytest.mark.parametrize("backend", ["auto", "jnp", "pallas_interpret"])
def test_off_gpu(backend):
    want = True if backend == "pallas_interpret" else None
    assert _sgm_kernel_mode(CFG.replace(backend=backend), None, None) is want


@pytest.mark.parametrize("backend", ["jnp", "auto", "pallas", "pallas_interpret"])
def test_no_paths_no_kernel(on_gpu, backend):
    cfg = CFG.replace(num_paths=0, backend=backend)
    assert _sgm_kernel_mode(cfg, MASK, CONSTRAIN) is None


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret"])
@pytest.mark.parametrize(
    "valid, constrain", [(MASK, None), (None, CONSTRAIN)],
    ids=["masked", "constrained"],
)
def test_forced_backend_raises_on_unsupported_call(on_gpu, backend, valid,
                                                   constrain):
    with pytest.raises(NotImplementedError, match="unmasked"):
        _sgm_kernel_mode(CFG.replace(backend=backend), valid, constrain)


def test_forced_compiled_kernel_raises_off_gpu():
    with pytest.raises(NotImplementedError, match="GPU"):
        _sgm_kernel_mode(CFG.replace(backend="pallas"), None, None)


def test_forced_compiled_kernel_on_gpu(on_gpu):
    assert _sgm_kernel_mode(CFG.replace(backend="pallas"), None, None) is False


@pytest.mark.parametrize("lr_exact", [False, True])
def test_auto_pipeline_calls_kernel_for_every_view(on_gpu, kernel_calls,
                                                   lr_exact):
    """auto on the GPU never falls back for whole frames: the left view and,
    with exact LR, the flipped right view both reach the kernel."""
    pair = make_pair((16, 40), max_disp=6, kind="shapes", seed=1)
    cfg = CFG.replace(lr_exact=lr_exact)
    got = compute_disparity(pair.left, pair.right, cfg)
    assert kernel_calls == [False] * (2 if lr_exact else 1)
    want = compute_disparity(pair.left, pair.right, cfg.replace(backend="jnp"))
    np.testing.assert_array_equal(np.asarray(got.disp), np.asarray(want.disp))


def test_auto_pipeline_masked_tile_stays_golden(on_gpu, kernel_calls):
    pair = make_pair((16, 40), max_disp=6, kind="shapes", seed=2)
    valid = np.ones((16, 40), bool)
    valid[:, :3] = False
    compute_disparity(pair.left, pair.right, CFG, valid=jnp.asarray(valid))
    assert kernel_calls == []


def test_auto_pipeline_rect_tile_stays_golden(on_gpu, kernel_calls):
    """A rectangular tile of a larger frame carries an in-frame mask."""
    pair = make_pair((16, 40), max_disp=6, kind="shapes", seed=3)
    compute_disparity(
        pair.left, pair.right, CFG, x_offset=-4, y_offset=-2,
        image_width=60, image_height=30,
    )
    assert kernel_calls == []


def test_auto_pyramid_residual_uses_kernel(on_gpu, kernel_calls):
    from stereo_tpu.models import get_model

    pair = make_pair((16, 40), max_disp=6, kind="shapes", seed=4)
    get_model("pyramid", cfg=CFG)._forward(pair.left, pair.right)
    assert kernel_calls == [False, False]   # coarse pass + residual volume


def test_aggregate_is_the_pipeline_entry(on_gpu, kernel_calls):
    vol = jnp.zeros((4, 5, 16), jnp.int32)
    pipeline.aggregate(vol, CFG)
    pipeline.aggregate(vol, CFG, valid=jnp.ones((4, 5), bool))
    assert kernel_calls == [False]


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="backend"):
        StereoConfig(backend="triton")
