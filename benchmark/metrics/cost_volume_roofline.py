"""Cost volume: least time of its compulsory work (counts.py) over its
device time, in percent."""


def read(view):
    return view.roofline_pct("cost_volume")
