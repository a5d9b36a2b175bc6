"""Census transform (golden jnp implementation).

Reference behavior (reconstructed, SURVEY.md §2.1 C2): per-pixel window
compared against the center pixel, packed into a bitstring descriptor —
robust to radiometric differences between the two cameras.

Design: the window comparison unrolls into a static Python loop over
offsets (the window is a static config), each offset a cheap shifted
compare; bits pack into one or two uint32 words. XLA fuses the whole
transform into a handful of elementwise ops.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def census_transform(img: jnp.ndarray, window: Tuple[int, int]) -> jnp.ndarray:
    """Census descriptor per pixel.

    Args:
      img: [H, W] image (uint8 or float); comparisons use raw values.
      window: (rows, cols), both odd. Bits = rows*cols - 1 (center skipped),
        must be <= 64.

    Returns:
      [H, W, n_words] uint32 descriptor, n_words = ceil(bits / 32). Bit k of
      the descriptor is 1 iff the k-th off-center neighbor (row-major order)
      is strictly less than the center pixel. Borders use edge replication,
      matching the usual real-time-SGM convention.
    """
    wy, wx = window
    if wy % 2 == 0 or wx % 2 == 0:
        raise ValueError("census window dims must be odd")
    bits = wy * wx - 1
    if bits > 64:
        raise ValueError("census descriptor limited to 64 bits")
    n_words = (bits + 31) // 32

    ry, rx = wy // 2, wx // 2
    img = img.astype(jnp.int32)
    padded = jnp.pad(img, ((ry, ry), (rx, rx)), mode="edge")
    h, w = img.shape

    words = [jnp.zeros((h, w), dtype=jnp.uint32) for _ in range(n_words)]
    bit = 0
    for dy in range(wy):
        for dx in range(wx):
            if dy == ry and dx == rx:
                continue  # skip center
            neighbor = padded[dy : dy + h, dx : dx + w]
            b = (neighbor < img).astype(jnp.uint32)
            words[bit // 32] = words[bit // 32] | (b << jnp.uint32(bit % 32))
            bit += 1
    return jnp.stack(words, axis=-1)


def hamming_distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamming distance between census descriptors.

    Args:
      a, b: [..., n_words] uint32 descriptors.

    Returns:
      [...] int32 popcount(XOR) summed over words.
    """
    x = jnp.bitwise_xor(a, b)
    from jax import lax

    return jnp.sum(lax.population_count(x).astype(jnp.int32), axis=-1)


def rank_transform(img: jnp.ndarray, window: Tuple[int, int]) -> jnp.ndarray:
    """Rank transform: count of window neighbors strictly below the center.

    The scalar cousin of census (Zabih & Woodfill 1994 [K]); cost is the
    absolute rank difference. Robust to radiometric changes like census,
    cheaper (one int per pixel), slightly less discriminative.
    """
    wy, wx = window
    if wy % 2 == 0 or wx % 2 == 0:
        raise ValueError("rank window dims must be odd")
    ry, rx = wy // 2, wx // 2
    img32 = img.astype(jnp.int32)
    padded = jnp.pad(img32, ((ry, ry), (rx, rx)), mode="edge")
    h, w = img.shape
    rank = jnp.zeros((h, w), dtype=jnp.int32)
    for dy in range(wy):
        for dx in range(wx):
            if dy == ry and dx == rx:
                continue
            neighbor = padded[dy : dy + h, dx : dx + w]
            rank = rank + (neighbor < img32).astype(jnp.int32)
    return rank
