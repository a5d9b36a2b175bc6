"""WTA, subpixel, uniqueness, LR check and median (ops/wta.py,
ops/postprocess.py): device ms per frame."""


def read(view):
    return view.layer_ms("select_post")
