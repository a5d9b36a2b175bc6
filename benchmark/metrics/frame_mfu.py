"""Whole frames against the peak: compulsory operations of all stages
(counts.py) times frames completed in the traced window, over the ALU peak
of the cards used times the window, in percent."""


def read(view):
    red = view.reduction
    if red is None or view.peaks is None or not view.frames_traced:
        return None
    ops = sum(o for o, _ in view.counts.values())
    peak = view.peaks["alu_ops_per_s"] * view.chips * red.window_s
    return 100.0 * ops * view.frames_traced / peak
