"""Stereo ops: golden jnp implementations + the SGM GPU kernel.

Each op has a pure-jnp reference implementation (the oracle, SURVEY.md §2.3
I6). SGM aggregation, the hot path, also has a Triton kernel for the GPU
under ``stereo_tpu.ops.pallas``; the pipeline layer picks between them.
"""

from .census import census_transform, hamming_distance
from .cost import box_sum, census_cost_volume, cost_volume, sad_cost_volume
from .postprocess import (
    apply_postprocess,
    lr_consistency,
    median_3x3,
    right_disparity_from_volume,
)
from .sgm import sgm_aggregate
from .wta import wta_disparity

__all__ = [
    "census_transform",
    "hamming_distance",
    "box_sum",
    "cost_volume",
    "census_cost_volume",
    "sad_cost_volume",
    "sgm_aggregate",
    "wta_disparity",
    "apply_postprocess",
    "lr_consistency",
    "median_3x3",
    "right_disparity_from_volume",
]
