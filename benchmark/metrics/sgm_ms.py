"""SGM aggregation (the sgm_path_* kernels): device ms per frame."""


def read(view):
    return view.layer_ms("sgm")
