"""Plain reference of the census + SGM pipeline the benchmark checks against.

Written from the published method (census transform, Hamming cost,
Hirschmueller's semi-global matching, winner-take-all with a parabola fit,
uniqueness and left-right checks, a 3x3 median, then the speckle filter) in
straightforward ``jax.numpy``. It imports nothing of the program under test.

Differences in form from the program, none in result:

* the census descriptor is kept as one boolean plane per neighbour, and the
  Hamming distance counts unequal planes, with no bit packing;
* every SGM path, diagonals included, is a ``lax.scan`` along rows or
  columns, and a diagonal's predecessor is the previous row shifted by one
  column, with no sheared copy of the volume;
* the speckle filter (``speckle``) labels connected components of a graph
  with scipy, on the host.

Memory: at 1988x2880 with D=256 a frame takes about 25 GB of temporaries
(two int16 copies of the cost volume, one path's int16 output and the int32
sum), which one H100 holds once the program's own arrays are freed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

#: Step of each SGM path: the predecessor of (y, x) is (y - dy, x - dx). The
#: first four make the 4-path set.
PATHS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1), (1, -1), (-1, 1))

_INF = 1 << 20  # above any path cost: the neighbour beyond either end of D


@dataclasses.dataclass(frozen=True)
class Params:
    """The settings of a configuration file's ``stereo`` group that the
    reference implements; anything else there must keep its default."""

    census_window: Tuple[int, int]
    num_disparities: int
    num_paths: int
    p1: int
    p2: int
    uniqueness_ratio: float
    subpixel: bool
    lr_check: bool
    lr_tau: float
    median_filter: bool
    speckle_max_size: int = 0
    speckle_rel: float = 0.0
    speckle_tau: float = 2.0
    #: Bits kept of each matching cost. 8 is what the configurations state
    #: (an int8 volume); 4 is the control, an int4 volume that keeps
    #: cost // 4 and scales it back.
    cost_bits: int = 8

    @property
    def max_cost(self) -> int:
        return self.census_window[0] * self.census_window[1] - 1

    def speckle_size(self, h: int, w: int) -> int:
        return max(
            self.speckle_max_size, int(round(self.speckle_rel * h * w))
        )


#: Settings the reference does not implement, with the only value it accepts.
_FIXED = {
    "cost_fn": "census",
    "min_disparity": 0,
    "adaptive_p2": False,
    "lr_exact": False,
    "fill_occlusions": False,
}

#: Settings that do not change the result (how the program computes it).
_IGNORED = ("backend", "cost_dtype", "sad_window", "p2_min",
            "adaptive_grad_floor")


def params_from_config(stereo: dict, cost_bits: int = 8) -> Params:
    """Params from a configuration file's ``stereo`` group."""
    fields = {f.name for f in dataclasses.fields(Params)}
    kw = {}
    for key, value in stereo.items():
        if key in _FIXED:
            if value != _FIXED[key]:
                raise NotImplementedError(
                    f"the reference implements {key}={_FIXED[key]!r} only"
                )
        elif key in fields:
            kw[key] = tuple(value) if key == "census_window" else value
        elif key not in _IGNORED:
            raise KeyError(f"unknown stereo setting {key!r}")
    return Params(cost_bits=cost_bits, **kw)


def census_planes(img: jnp.ndarray, window: Tuple[int, int]) -> jnp.ndarray:
    """[K, H, W] bool: neighbour k (row-major, centre skipped) is strictly
    darker than the centre. Borders replicate the edge pixel."""
    wy, wx = window
    ry, rx = wy // 2, wx // 2
    h, w = img.shape
    img = img.astype(jnp.int32)
    padded = jnp.pad(img, ((ry, ry), (rx, rx)), mode="edge")
    planes = [
        padded[dy:dy + h, dx:dx + w] < img
        for dy in range(wy)
        for dx in range(wx)
        if (dy, dx) != (ry, rx)
    ]
    return jnp.stack(planes)


def cost_volume(left, right, p: Params) -> jnp.ndarray:
    """[D, H, W] int16: Hamming distance between the left pixel's census
    planes and those of right pixel x - d; the largest cost where x - d
    leaves the frame."""
    h, w = left.shape
    d = p.num_disparities
    bl = census_planes(left, p.census_window)
    br = jnp.pad(census_planes(right, p.census_window), ((0, 0), (0, 0), (d, 0)))
    xs = jnp.arange(w)[None, :]

    def one(dd):
        shifted = jax.lax.dynamic_slice_in_dim(br, d - dd, w, axis=2)
        c = jnp.sum(bl != shifted, axis=0, dtype=jnp.int32)
        c = jnp.where(xs < dd, p.max_cost, c)
        drop = p.max_cost.bit_length() - p.cost_bits
        if drop > 0:
            c = (c >> drop) << drop
        return c.astype(jnp.int16)

    return jax.lax.map(one, jnp.arange(d))


def _path(cost_hwd, cost_whd, p: Params, dy: int, dx: int) -> jnp.ndarray:
    """L_r for one path r = (dy, dx), as [H, W, D] int16.

    L_r(p, d) = C(p, d) + min(L(q, d), L(q, d-1) + P1, L(q, d+1) + P1,
    min_k L(q, k) + P2) - min_k L(q, k), with q = p - r; L_r = C where q
    lies outside the frame.
    """
    if dy == 0:
        seq = cost_whd if dx > 0 else cost_whd[::-1]   # steps along x
        shift = 0
    else:
        seq = cost_hwd if dy > 0 else cost_hwd[::-1]   # steps along y
        shift = dx   # predecessor column on the previous row: x - dx
    _, lines, d = seq.shape
    line = jnp.arange(lines)

    def step(carry, c):
        prev, started = carry
        c = c.astype(jnp.int32)
        if shift > 0:
            pred = jnp.concatenate([prev[:1], prev[:-1]], axis=0)
            ok = started & (line >= 1)
        elif shift < 0:
            pred = jnp.concatenate([prev[1:], prev[-1:]], axis=0)
            ok = started & (line < lines - 1)
        else:
            pred = prev
            ok = jnp.broadcast_to(started, (lines,))
        m = jnp.min(pred, axis=1, keepdims=True)
        inf = jnp.full_like(pred[:, :1], _INF)
        below = jnp.concatenate([inf, pred[:, :-1]], axis=1)   # L(d - 1)
        above = jnp.concatenate([pred[:, 1:], inf], axis=1)    # L(d + 1)
        cand = jnp.minimum(
            jnp.minimum(pred, jnp.minimum(below, above) + p.p1), m + p.p2
        )
        cur = jnp.where(ok[:, None], c + cand - m, c)
        return (cur, jnp.asarray(True)), cur.astype(jnp.int16)

    init = (jnp.zeros((lines, d), jnp.int32), jnp.asarray(False))
    _, out = jax.lax.scan(step, init, seq)
    if dy == 0:
        out = out if dx > 0 else out[::-1]
        return jnp.swapaxes(out, 0, 1)
    return out if dy > 0 else out[::-1]


def aggregate(cost_dhw, p: Params) -> jnp.ndarray:
    """S = sum of L_r over the configured paths, [H, W, D] int32."""
    cost_hwd = jnp.transpose(cost_dhw, (1, 2, 0))
    if p.num_paths == 0:
        return cost_hwd.astype(jnp.int32)
    cost_whd = jnp.transpose(cost_dhw, (2, 1, 0))
    s = jnp.zeros(cost_hwd.shape, jnp.int32)
    for dy, dx in PATHS[: p.num_paths]:
        s = s + _path(cost_hwd, cost_whd, p, dy, dx).astype(jnp.int32)
    return s


def select(s, p: Params):
    """Winner-take-all with parabola fit, uniqueness and left-right checks,
    then the 3x3 median of the disparity map. Returns (disp f32, valid)."""
    h, w, d = s.shape
    ds = jnp.arange(d)
    c0 = jnp.min(s, axis=-1)
    d0 = jnp.argmin(s, axis=-1).astype(jnp.int32)   # first of equal minima
    valid = jnp.ones((h, w), bool)

    if p.uniqueness_ratio > 0:
        far = jnp.abs(ds[None, None, :] - d0[..., None]) > 1
        c2 = jnp.min(jnp.where(far, s, jnp.iinfo(jnp.int32).max), axis=-1)
        valid = valid & (
            c2.astype(jnp.float32)
            > c0.astype(jnp.float32) * jnp.float32(1.0 + p.uniqueness_ratio)
        )

    disp = d0.astype(jnp.float32)
    if p.subpixel and d > 1:
        def at(k):
            idx = jnp.clip(k, 0, d - 1)[..., None]
            return jnp.take_along_axis(s, idx, axis=-1)[..., 0].astype(
                jnp.float32
            )

        cm, cp, cc = at(d0 - 1), at(d0 + 1), c0.astype(jnp.float32)
        denom = cp + cm - 2.0 * cc
        offset = jnp.where(
            denom > 0, (cm - cp) / (2.0 * jnp.maximum(denom, 1.0)), 0.0
        )
        offset = jnp.clip(offset, -0.5, 0.5)
        interior = (d0 > 0) & (d0 < d - 1)
        disp = disp + jnp.where(interior, offset, 0.0)

    if p.lr_check:
        # Right-view costs: S_R(y, xr, d) = S(y, xr + d, d), out of frame
        # where xr + d >= W; its first minimum is the right-view winner.
        xs = jnp.arange(w)
        src = xs[:, None] + ds[None, :]
        s_r = jnp.take_along_axis(
            s, jnp.minimum(src, w - 1)[None, :, :], axis=1
        )
        s_r = jnp.where((src < w)[None], s_r, jnp.iinfo(jnp.int32).max)
        d_r = jnp.argmin(s_r, axis=-1).astype(jnp.int32)
        xr = xs[None, :] - d0
        d_r_at = jnp.take_along_axis(d_r, jnp.clip(xr, 0, w - 1), axis=1)
        lr_ok = jnp.abs(d0 - d_r_at).astype(jnp.float32) <= jnp.float32(
            p.lr_tau
        )
        valid = valid & lr_ok & (xr >= 0)

    if p.median_filter:
        padded = jnp.pad(disp, ((1, 1), (1, 1)), mode="edge")
        nine = jnp.stack(
            [padded[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
        )
        disp = jnp.sort(nine, axis=0)[4]
    return disp, valid


def frame(left, right, p: Params):
    """The device part of the pipeline for one pair: (disp, valid)."""
    return select(aggregate(cost_volume(left, right, p), p), p)


@functools.lru_cache(maxsize=None)
def jitted(p: Params):
    """One compiled reference per setting (shapes specialise it further)."""
    return jax.jit(functools.partial(frame, p=p))


def speckle(disp: np.ndarray, valid: np.ndarray, p: Params) -> np.ndarray:
    """Valid mask after the speckle filter: 4-connected components of valid
    pixels whose neighbours differ by at most speckle_tau are dropped when
    they hold fewer than speckle_size pixels."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    h, w = disp.shape
    size = p.speckle_size(h, w)
    valid = np.asarray(valid, bool)
    if size <= 0:
        return valid
    d = np.asarray(disp, np.float32)
    tau = np.float32(p.speckle_tau)
    idx = np.arange(h * w).reshape(h, w)
    right = valid[:, 1:] & valid[:, :-1] & (np.abs(d[:, 1:] - d[:, :-1]) <= tau)
    down = valid[1:] & valid[:-1] & (np.abs(d[1:] - d[:-1]) <= tau)
    a = np.concatenate([idx[:, :-1][right], idx[:-1][down]])
    b = np.concatenate([idx[:, 1:][right], idx[1:][down]])
    graph = coo_matrix((np.ones(a.size, np.int8), (a, b)), shape=(h * w,) * 2)
    _, label = connected_components(graph, directed=False)
    sizes = np.bincount(label, weights=valid.ravel(), minlength=label.max() + 1)
    return valid & (sizes[label] >= size).reshape(h, w)
