"""Exact multi-device pipeline via sharding constraints (Ulysses analog, P6).

SGM's two pass families want conflicting layouts: row scans want full rows
device-local, column/diagonal scans want full columns (of the possibly
sheared volume) device-local. Instead of cross-device sequential wavefronts,
this mode resharding the cost volume between pass families — exactly the
Ulysses head<->sequence trick (SURVEY.md §2.2 P6): annotate the inputs of
each family with `with_sharding_constraint` and let XLA insert the
`all_to_all` (NCCL over NVLink on one host).

Because every scan runs complete and device-local, the result is
**bit-identical** to the single-device golden pipeline — the property the
distributed tests assert (SURVEY.md §4.3). Bounded-error halo tiling (P2/P5)
lives in parallel/tiling.py; benchmarks compare the two.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import StereoConfig
from ..pipeline.pipeline import StereoResult, compute_disparity


def _annotators(mesh: Mesh):
    """(rows_local, cols_local) pytree annotators for sgm_aggregate.

    rows_local shards axis 0 (H) over every non-batch mesh device, keeping
    full rows local; cols_local shards axis 1 (W or sheared Wp). Leaves of
    rank 2 ([H, W] masks/images) and rank 3 ([H, W, D] volumes) both get
    their leading spatial axes from the same spec.
    """
    axes = ("ty", "tx")

    def make(axis: int):
        def annotate(tree):
            def one(x):
                if x is None:
                    return None
                spec = [None] * x.ndim
                spec[axis] = axes
                return jax.lax.with_sharding_constraint(
                    x, NamedSharding(mesh, P(*spec))
                )

            return jax.tree_util.tree_map(one, tree, is_leaf=lambda v: v is None)

        return annotate

    return make(0), make(1)


def build_exact_pipeline(
    cfg: StereoConfig,
    mesh: Mesh,
    donate: bool = False,
    dplane_cost: bool = False,
):
    """Jitted ``(left, right) -> StereoResult`` distributed over ``mesh``.

    Inputs arrive row-sharded; outputs are replicated (the "all-gather
    per-tile disparity maps" of BASELINE.json:5, realized as an XLA
    all_gather inserted by the output sharding).

    ``dplane_cost=True`` enables P3 disparity-plane sharding (SURVEY.md
    §2.2): the cost volume is built D-SHARDED over all mesh devices —
    each device materializes only its D/n_devices disparity slab, bounding
    per-device memory during construction of e.g. the 1.5G-cell config-4
    volume — then XLA all_to_alls it to the spatial shardings the SGM
    pass families request. SGM itself is never D-sharded: the recurrence's
    per-step min_k couples all disparities, so a D-sharded scan would need
    a collective per pixel step (the trade-off SURVEY.md P3 documents;
    hence "default OFF"). WTA-only configs (num_paths=0) stay D-sharded
    through selection, where XLA turns the lane reductions into a
    cross-device (min, argmin) combine. Output is bit-identical either
    way — sharding annotations move data, not values.
    """
    rows_local, cols_local = _annotators(mesh)
    if dplane_cost:
        axes = ("ty", "tx")

        def dplanes(vol):
            return jax.lax.with_sharding_constraint(
                vol, NamedSharding(mesh, P(None, None, axes))
            )

        # Cost planes need full rows of both images (plane d reads right
        # pixels x - d), so inputs stay replicated in dplane mode.
        constrain = (rows_local, cols_local, dplanes)
        in_annotate = lambda t: jax.lax.with_sharding_constraint(
            t, NamedSharding(mesh, P())
        )
    else:
        constrain = (rows_local, cols_local)
        in_annotate = rows_local

    def fn(left, right):
        left = in_annotate(left)
        right = in_annotate(right)
        return compute_disparity(left, right, cfg, constrain=constrain)

    out_sharding = StereoResult(
        disp=NamedSharding(mesh, P()), valid=NamedSharding(mesh, P())
    )
    donate_argnums = (0, 1) if donate else ()
    return jax.jit(
        fn, out_shardings=out_sharding, donate_argnums=donate_argnums
    )
