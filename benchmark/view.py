"""What a per-layer metric reader sees: the reduced trace and host spans.

Each ``benchmark/metrics/<name>.py`` defines ``read(view)`` and returns a
number, or None when the run has nothing for it to read (then the metric is
left out of the result line, never reported as 0).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .counts import least_seconds
from .trace import Reduction


@dataclasses.dataclass
class View:
    reduction: Optional[Reduction]   # the traced stretch of the window
    frames_traced: int               # frames completed in that stretch
    frames_window: int               # frames completed in the whole window
    span_s: Dict[str, float]         # host span seconds over the window
    counts: Dict[str, Tuple[float, float]]  # compulsory (ops, bytes)/frame
    peaks: Optional[dict]            # the card's row of peaks.json
    chips: int

    def layer_ms(self, layer: str) -> Optional[float]:
        """Device ms per frame of a layer, summed over the cards."""
        if self.reduction is None or not self.frames_traced:
            return None
        s = self.reduction.layer_s.get(layer)
        return 1e3 * s / self.frames_traced if s else None

    def roofline_pct(self, layer: str) -> Optional[float]:
        """Least time of the layer's compulsory work over its device time."""
        ms = self.layer_ms(layer)
        if ms is None or self.peaks is None or layer not in self.counts:
            return None
        ops, nbytes = self.counts[layer]
        return 100.0 * least_seconds(ops, nbytes, self.peaks) * 1e3 / ms
