"""stereo_tpu — real-time stereo-depth engine in JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of the
OpenCL C++ reference Batshaw/Real-Time-Stereo-Matching- (see SURVEY.md):
census/SAD matching cost -> H x W x D cost volume -> 4/8-path SGM
aggregation -> fused WTA + subpixel -> LR consistency -> median filter,
scaled over device meshes via shard_map tiling with halo exchange.
"""

from .config import (
    KITTI_SGM8_128,
    KITTI_STREAM_MULTIHOST,
    MIDDLEBURY_CENSUS_SGM4_64,
    MIDDLEBURY_FULL_256_TILED,
    PRESETS,
    TSUKUBA_SAD16,
    StereoConfig,
    TileConfig,
)
from .pipeline.pipeline import StereoResult, build_pipeline, compute_disparity

__version__ = "0.1.0"

__all__ = [
    "StereoConfig",
    "TileConfig",
    "StereoResult",
    "build_pipeline",
    "compute_disparity",
    "PRESETS",
    "TSUKUBA_SAD16",
    "MIDDLEBURY_CENSUS_SGM4_64",
    "KITTI_SGM8_128",
    "MIDDLEBURY_FULL_256_TILED",
    "KITTI_STREAM_MULTIHOST",
]
