"""Reduction of a profiler trace to device busy time, idle gaps and layers.

Input: the ``.xplane.pb`` that ``jax.profiler`` writes, read with
``jax.profiler.ProfileData``, and the optimized HLO text of each program the
window ran (``compiled.as_text()``).

* Device events are those on the ``Stream ...`` lines of each
  ``/device:GPU:<n>`` plane: kernels and memory copies.
* Busy time is the union of a card's event intervals inside the traced
  window (the host span ``traced_window``); idle is the rest of the window.
* Each kernel is attributed to a layer. A layer file
  (``benchmark/layers/<layer>.json``) names kernel-name prefixes (the SGM
  kernel's ``sgm_path_*``, the copies' ``Memcpy*``) and program modules. A
  fusion kernel carries its HLO instruction's name (``.`` written as ``_``);
  the instruction's ``stack_frame_id`` resolves, through the HLO text's
  ``StackFrames``/``FileLocations``/``FileNames`` tables, to the innermost
  ``stereo_tpu/`` module that built it. Kernels that match no layer are
  ``other``.
* Each idle gap is named by the innermost benchmark host span open at its
  middle (``upload``, ``dispatch``, ``wait``, ``download``, ``host_post``,
  ``next_batch``).
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Host spans the benchmark writes around its calls into the program.
SPAN_NAMES = ("upload", "dispatch", "wait", "download", "host_post",
              "next_batch")
WINDOW_SPAN = "traced_window"
OTHER = "other"
_PACKAGE = "stereo_tpu/"


@dataclasses.dataclass
class Event:
    card: int
    name: str
    start: float  # seconds, on the trace's clock
    end: float


@dataclasses.dataclass
class Reduction:
    window_s: float
    busy_s: Dict[int, float]            # per card
    layer_s: Dict[str, float]           # summed over cards
    op_s: Dict[Tuple[str, str], float]  # (layer, kernel) summed over cards
    gap_s: Dict[str, float]             # idle seconds by host span, all cards

    def top_ops(self, n: int = 10) -> List[list]:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:n]
        return [[f"{layer}:{name}", s] for (layer, name), s in ops]

    def top_gaps(self, n: int = 10) -> List[list]:
        gaps = sorted(self.gap_s.items(), key=lambda kv: -kv[1])[:n]
        return [[name, s] for name, s in gaps]


# --------------------------------------------------------------------------
# Trace reading
# --------------------------------------------------------------------------


def device_events(prof) -> List[Event]:
    out = []
    for plane in prof.planes:
        m = re.fullmatch(r"/device:GPU:(\d+)", plane.name)
        if not m:
            continue
        card = int(m.group(1))
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                start = ev.start_ns * 1e-9
                out.append(Event(card, ev.name, start,
                                 start + ev.duration_ns * 1e-9))
    return out


def host_spans(prof, names: Iterable[str]) -> List[Event]:
    wanted = set(names)
    out = []
    for plane in prof.planes:
        if not plane.name.startswith("/host:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.name in wanted:
                    start = ev.start_ns * 1e-9
                    out.append(Event(-1, ev.name, start,
                                     start + ev.duration_ns * 1e-9))
    return out


# --------------------------------------------------------------------------
# HLO attribution
# --------------------------------------------------------------------------

_SECTION = re.compile(r"^(FileNames|FunctionNames|FileLocations|StackFrames)$")
_ROW = re.compile(r"^(\d+)\s+(.*)$")
_COMPUTATION = re.compile(r"^(?:ENTRY\s+)?%?([^\s(]+)\s*\(.*\{\s*$")
_INSTRUCTION = re.compile(r"^\s+(?:ROOT\s+)?%?([^\s=]+)\s*=\s*(.*)$")
_CALLS = re.compile(r"calls=\{?([^}\s,]+(?:,\s*%[^}\s,]+)*)\}?")
_FRAME = re.compile(r"stack_frame_id=(\d+)")


def kernel_modules(hlo_text: str) -> Dict[str, str]:
    """Kernel name -> innermost ``stereo_tpu/...`` module that built it."""
    tables: Dict[str, Dict[int, str]] = {}
    section = None
    comps: Dict[str, List[Tuple[str, Optional[int], List[str]]]] = {}
    comp = None
    for line in hlo_text.splitlines():
        if _SECTION.match(line):
            section = line.strip()
            tables[section] = {}
            continue
        if section is not None:
            row = _ROW.match(line)
            if row:
                tables[section][int(row.group(1))] = row.group(2)
                continue
            section = None
        head = _COMPUTATION.match(line)
        if head:
            comp = head.group(1)
            comps[comp] = []
            continue
        ins = _INSTRUCTION.match(line)
        if ins and comp is not None:
            rest = ins.group(2)
            frame = _FRAME.search(rest)
            calls = _CALLS.search(rest)
            called = (
                [c.strip().lstrip("%") for c in calls.group(1).split(",")]
                if calls else []
            )
            comps[comp].append(
                (ins.group(1), int(frame.group(1)) if frame else None, called)
            )

    files = {
        k: v.strip().strip('"') for k, v in tables.get("FileNames", {}).items()
    }
    locs = {
        k: int(re.search(r"file_name_id=(\d+)", v).group(1))
        for k, v in tables.get("FileLocations", {}).items()
    }
    frames = {}
    for k, v in tables.get("StackFrames", {}).items():
        loc = int(re.search(r"file_location_id=(\d+)", v).group(1))
        parent = int(re.search(r"parent_frame_id=(\d+)", v).group(1))
        # The text prints a frame's parent one above its id; 0 ends the chain.
        frames[k] = (loc, parent - 1)

    def module_of_frame(fid: Optional[int]) -> Optional[str]:
        seen = set()
        while fid and fid in frames and fid not in seen:
            seen.add(fid)
            loc, parent = frames[fid]
            path = files.get(locs.get(loc, -1), "")
            at = path.find(_PACKAGE)
            if at >= 0:
                return path[at:]
            fid = parent
        return None

    def module_of_comp(name: str, depth: int = 0) -> Optional[str]:
        votes = collections.Counter()
        for _, fid, called in comps.get(name, ()):
            mod = module_of_frame(fid)
            if mod is None and called and depth < 3:
                mod = module_of_comp(called[0], depth + 1)
            if mod:
                votes[mod] += 1
        return votes.most_common(1)[0][0] if votes else None

    out = {}
    for instrs in comps.values():
        for name, fid, called in instrs:
            mod = module_of_frame(fid)
            if mod is None and called:
                mod = module_of_comp(called[0])
            if mod:
                out[name.replace(".", "_").replace("-", "_")] = mod
    return out


def layer_of(kernel: str, modules: Dict[str, str], layers: Dict[str, dict]) -> str:
    for layer in sorted(layers):
        if any(kernel.startswith(p) for p in layers[layer].get("kernels", ())):
            return layer
    mod = modules.get(kernel)
    if mod:
        for layer in sorted(layers):
            if mod in layers[layer].get("modules", ()):
                return layer
    return OTHER


# --------------------------------------------------------------------------
# Interval arithmetic
# --------------------------------------------------------------------------


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float):
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def _span_at(t: float, spans: Sequence[Event]) -> str:
    open_ = [s for s in spans if s.start <= t <= s.end and s.name in SPAN_NAMES]
    if not open_:
        return "no benchmark span"
    return min(open_, key=lambda s: s.end - s.start).name


def reduce(prof, modules: Dict[str, str], layers: Dict[str, dict],
           cards: Optional[Sequence[int]] = None) -> Reduction:
    """Reduce one trace to busy time, per-layer device time and idle gaps.

    ``cards``: the devices the run used (default: those with events).
    """
    events = device_events(prof)
    spans = host_spans(prof, SPAN_NAMES + (WINDOW_SPAN,))
    window = [s for s in spans if s.name == WINDOW_SPAN]
    if window:
        lo, hi = window[0].start, window[0].end
    elif events:
        lo, hi = min(e.start for e in events), max(e.end for e in events)
    else:
        raise ValueError("the trace holds no device events and no window")
    if cards is None:
        cards = sorted({e.card for e in events})
    busy_s, layer_s = {}, collections.Counter()
    op_s, gap_s = collections.Counter(), collections.Counter()
    layer_cache: Dict[str, str] = {}
    for card in cards:
        intervals = []
        for e in events:
            if e.card != card:
                continue
            a, b = max(e.start, lo), min(e.end, hi)
            if b <= a:
                continue
            intervals.append((a, b))
            layer = layer_cache.get(e.name)
            if layer is None:
                layer = layer_cache[e.name] = layer_of(e.name, modules, layers)
            layer_s[layer] += b - a
            op_s[(layer, e.name)] += b - a
        busy = merge(intervals)
        busy_s[card] = sum(b - a for a, b in busy)
        for a, b in gaps(busy, lo, hi):
            gap_s[_span_at((a + b) / 2, spans)] += b - a
    return Reduction(
        window_s=hi - lo, busy_s=busy_s, layer_s=dict(layer_s),
        op_s=dict(op_s), gap_s=dict(gap_s),
    )
