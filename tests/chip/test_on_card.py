"""The compiled SGM kernel on the card vs the golden scan on the card.

Marked ``chip``: these skip without a GPU. On the card:
``STEREO_ON_CHIP=1 python -m pytest -m chip tests/chip``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_tpu import PRESETS, StereoConfig, build_pipeline
from stereo_tpu.data import make_pair
from stereo_tpu.ops import cost_volume, sgm_aggregate
from stereo_tpu.ops.pallas.sgm_kernel import sgm_aggregate_pallas

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("paths, d", [(4, 64), (8, 128), (8, 48)])
def test_compiled_kernel_matches_golden(chip, paths, d, adaptive):
    pair = make_pair((120, 200), max_disp=d // 2, kind="shapes", seed=d)
    cfg = StereoConfig(
        num_disparities=d, num_paths=paths, census_window=(9, 7),
        adaptive_p2=adaptive, adaptive_grad_floor=12, p2_min=30,
    )
    vol = cost_volume(pair.left, pair.right, cfg)
    got = sgm_aggregate_pallas(vol, cfg, image=pair.left)
    want = sgm_aggregate(vol, cfg, image=jnp.asarray(pair.left))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_on_card_match_golden(chip, preset):
    pair = make_pair((96, 160), max_disp=12, kind="shapes", seed=1)
    cfg = PRESETS[preset].replace(num_disparities=32)
    k = build_pipeline(cfg)(pair.left, pair.right)
    g = build_pipeline(cfg.replace(backend="jnp"))(pair.left, pair.right)
    np.testing.assert_array_equal(np.asarray(k.valid), np.asarray(g.valid))
    np.testing.assert_array_equal(np.asarray(k.disp), np.asarray(g.disp))
