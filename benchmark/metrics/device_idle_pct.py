"""Share of the traced window in which a card ran nothing, mean over the
cards used, in percent."""


def read(view):
    red = view.reduction
    if red is None or not red.busy_s or red.window_s <= 0:
        return None
    busy = sum(red.busy_s.values()) / len(red.busy_s)
    return 100.0 * (1.0 - busy / red.window_s)
