"""Distribution layer: meshes, exact resharding, halo tiling, streaming.

All new scope — the reference is single-process single-device
(SURVEY.md §1.1). Strategies (SURVEY.md §2.2): P1 batch data parallelism
(stream.py), P2 spatial tile parallelism with halo exchange + P5 ring-style
neighbor ppermute (tiling.py), P6 Ulysses-style reshard between SGM pass
families (exact.py), P8 mesh/collectives plumbing (mesh.py).
"""

from .exact import build_exact_pipeline
from .mesh import initialize_multihost, make_tile_mesh
from .tiling import build_halo_pipeline

__all__ = [
    "build_exact_pipeline",
    "build_halo_pipeline",
    "make_tile_mesh",
    "initialize_multihost",
]

from .stream import StreamRunner, build_stream_pipeline  # noqa: E402

__all__ += ["StreamRunner", "build_stream_pipeline"]

from .bands import build_banded_pipeline  # noqa: E402

__all__ += ["build_banded_pipeline"]
