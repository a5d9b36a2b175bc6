"""The benchmark's plain reference and pair generator against the program,
at small sizes on the CPU (the SGM kernel in the Pallas interpreter)."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.gen import make_pair, pair_seed
from benchmark.reference import jitted, params_from_config, speckle

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = sorted(p.stem for p in (ROOT / "benchmark" / "configs").glob("*.json"))
SHAPE = (40, 96)


def _stereo(name, d=16):
    body = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    stereo = dict(body["stereo"], num_disparities=d)
    return stereo


def _program_config(stereo, backend):
    from stereo_tpu import StereoConfig

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in stereo.items()}
    return StereoConfig(**dict(kw, backend=backend))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_pipeline(name, seed):
    """Reference = build_pipeline with the interpreted SGM kernel, exactly,
    and the speckle filter = host_postprocess's."""
    from stereo_tpu import build_pipeline
    from stereo_tpu.pipeline.pipeline import host_postprocess

    stereo = _stereo(name)
    cfg = _program_config(stereo, "pallas_interpret")
    p = params_from_config(stereo)
    pair = make_pair(SHAPE, 12, seed=pair_seed(seed, 3))
    got = build_pipeline(cfg)(pair.left, pair.right)
    want = jitted(p)(pair.left, pair.right)
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got.disp), np.asarray(want[0]),
                               rtol=0, atol=1e-4)
    _, got_valid = host_postprocess(np.asarray(got.disp), np.asarray(got.valid), cfg)
    np.testing.assert_array_equal(got_valid, speckle(np.asarray(want[0]),
                                                     np.asarray(want[1]), p))


def test_control_differs():
    """The int4 control moves many disparities at the configuration's D cut."""
    stereo = _stereo(CONFIGS[0])
    pair = make_pair(SHAPE, 12, seed=5)
    d8, v8 = jitted(params_from_config(stereo))(pair.left, pair.right)
    d4, v4 = jitted(params_from_config(stereo, cost_bits=4))(pair.left, pair.right)
    assert np.mean(np.abs(np.asarray(d8) - np.asarray(d4)) > 0.01) > 0.05


def test_generator_copy_matches_program():
    from stereo_tpu.data import make_pair as program_pair

    for seed in (0, pair_seed(2**31 + 7, 1)):
        a = make_pair((64, 160), 40, "shapes", "cloud", seed=seed)
        b = program_pair((64, 160), 40, kind="shapes", texture="cloud", seed=seed)
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.right, b.right)


def test_pair_seed_takes_any_whole_number():
    seeds = {pair_seed(s, 0) for s in (0, 1, -1, 2**31 + 5, 2**40)}
    assert len(seeds) == 5
    assert pair_seed(7, 3) == pair_seed(7, 3)


def test_params_refuse_what_the_reference_lacks():
    stereo = _stereo(CONFIGS[0])
    with pytest.raises(NotImplementedError):
        params_from_config(dict(stereo, adaptive_p2=True))
    with pytest.raises(KeyError):
        params_from_config(dict(stereo, new_knob=1))
