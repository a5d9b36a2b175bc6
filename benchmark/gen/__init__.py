"""Seeded input generation for the benchmark (a frozen copy, see pairs.py)."""

from .pairs import Pair, make_pair, pair_seed

__all__ = ["Pair", "make_pair", "pair_seed"]
