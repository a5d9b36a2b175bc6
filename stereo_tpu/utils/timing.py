"""Steady-state device timing (SURVEY.md §2.3 I4).

``chained_seconds_per_call`` runs K calls inside ONE jitted ``fori_loop``
with a value dependency between iterations (so XLA can neither hoist nor
overlap them) and fetches a scalar that depends on every output element, so
the clock stops only after all chained work is done. Per-call time =
total / K: the device's steady-state time per call without per-call host
dispatch. A host loop that waits on each call with ``block_until_ready``
measures the latency a caller sees instead (chip_smoke.py prints that).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def _result_scalar(res) -> jnp.ndarray:
    leaves = jax.tree_util.tree_leaves(res)
    acc = jnp.float32(0)
    for leaf in leaves:
        # The scalar must depend on EVERY element of every output. A corner
        # element is NOT enough: inside the jitted chain XLA sees end-to-end
        # and dead-code-eliminates whole subcomputations that don't feed the
        # fetched value — slice-of-concatenate keeps only the first patch of
        # a banded/patched pipeline (measured 7.7x optimistic on a 6-patch
        # frame). A full sum is O(output) work — negligible next to the
        # O(H*W*D) volume compute being timed.
        acc = acc + jnp.sum(leaf).astype(jnp.float32)
    return acc


def chained_seconds_per_call(
    fn: Callable,
    args: Sequence,
    iters: int = 30,
    repeats: int = 3,
) -> float:
    """Median seconds per call of ``fn(*args)`` with chained iterations."""

    def chained(acc0, *xs):
        def body(_, acc):
            # Perturb the first argument by a value XLA cannot prove to be
            # zero (it is: acc is finite), forcing a fresh dependent call.
            bump = jnp.where(jnp.isinf(acc), 1, 0).astype(xs[0].dtype)
            ys = (xs[0] + bump,) + tuple(xs[1:])
            res = fn(*ys)
            return acc + _result_scalar(res)

        return jax.lax.fori_loop(0, iters, body, acc0)

    cj = jax.jit(chained)
    xs = tuple(jnp.asarray(a) for a in args)
    acc0 = jnp.float32(0)
    float(np.asarray(jax.device_get(cj(acc0, *xs))))  # compile + warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(np.asarray(jax.device_get(cj(acc0, *xs))))
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))
