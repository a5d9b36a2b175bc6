"""Mesh construction and multi-process bring-up (SURVEY.md §2.2 P8).

The reference is a single-process, single-device OpenCL program with no
distributed layer at all (SURVEY.md §1.1); everything here is new scope. No
custom transport is built: `jax.distributed.initialize` brings up processes,
and XLA hands `ppermute`/`all_gather`/`all_to_all`/`psum` to NCCL, over
NVLink between the cards of a host (SURVEY.md §5 "distributed communication
backend"). Every card reaches every other at the same rate, so mesh shapes
follow the algorithm (tile rows vs columns), not a physical topology.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the JAX distributed runtime (no-op for single process).

    Nothing detects a cluster automatically: callers pass the coordinator
    address (``localhost:<port>`` on one host), the process count and this
    process's id (SURVEY.md §4.3).
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def _factor2(n: int) -> Tuple[int, int]:
    """Most-square (a, b) with a * b = n, a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def make_tile_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
    batch: int = 1,
) -> Mesh:
    """Mesh over ('batch', 'ty', 'tx').

    'ty'/'tx' tile image rows/columns (SURVEY.md P2); 'batch' shards frames
    of a video stream (P1). With mesh_shape=None the non-batch devices are
    factored as square as possible, favoring 'ty' (row tiling needs no
    disparity-aware halo, see parallel/tiling.py).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % batch:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    if mesh_shape is None:
        a, b = _factor2(n // batch)
        mesh_shape = (b, a)  # favor more row tiles
    ty, tx = mesh_shape
    if batch * ty * tx != n:
        raise ValueError(f"batch*ty*tx={batch*ty*tx} != {n} devices")
    import numpy as np

    dev_array = np.array(devices).reshape(batch, ty, tx)
    return Mesh(dev_array, ("batch", "ty", "tx"))
