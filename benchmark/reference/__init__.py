"""Plain reference of the pipeline under test (imports nothing of it)."""

from .stereo import Params, frame, jitted, params_from_config, speckle

__all__ = ["Params", "frame", "jitted", "params_from_config", "speckle"]
