"""Cost volume (ops/cost.py, ops/census.py): device ms per frame."""


def read(view):
    return view.layer_ms("cost_volume")
