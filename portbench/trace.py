"""Reading a `torch.profiler` trace of the device's activity in the
measured window.

The window is profiled for the device alone (no host operations are
recorded: recording them slows the host loop, which sets the pace, by
about three times).  The device's busy time is the union of its events'
spans (kernels, copies and sets); each idle gap between them is named by
the device operation that ends it, which is the work the host was
preparing while the device waited.  Kernel names are shortened to their
function's name, without template arguments and parameters.
"""

from __future__ import annotations

import collections
import dataclasses

__all__ = ["Trace", "short_name", "busy_seconds", "idle_gaps", "name_gaps",
           "read"]

_TOP = 10
_ANON = "(anonymous namespace)::"


def short_name(name: str) -> str:
    """A kernel's function name: ``void ns::f<T>(args)`` -> ``ns::f``."""
    name = name.replace(_ANON, "")
    if name.startswith("void "):
        name = name[5:]
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            if ch == "(" and depth == 0:
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


@dataclasses.dataclass
class Trace:
    """The device's side of a traced window."""

    busy_s: float                 # union of the device events' spans
    device_events: int            # how many the device ran
    by_name: dict                 # short name -> [seconds, count]
    gaps: list                    # [["before <op>", seconds]], longest

    def top_ops(self, n: int = _TOP) -> list:
        """The `n` device operations that took most time, [[name, s]]."""
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name, s] for name, (s, _) in rows]

    def kernel(self, names) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose function is one of
        `names` (the last part of the short name)."""
        s = c = 0
        for name, (sec, cnt) in self.by_name.items():
            if name.rsplit("::", 1)[-1] in names:
                s += sec
                c += cnt
        return s, c


def _merged(spans):
    """The union of (start, end) spans as sorted disjoint spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_seconds(spans, per_second: float = 1e9) -> float:
    """The length of the union of (start, end) spans, in seconds."""
    return sum(e - s for s, e in _merged(spans)) / per_second


def idle_gaps(spans) -> list[tuple]:
    """The (start, end) gaps between the union's spans, in time order."""
    merged = _merged(spans)
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:])]


def name_gaps(events, per_second: float = 1e9, top: int = _TOP) -> list:
    """[["before <name>", seconds]] summed by name over the idle gaps
    between device `events` (start, end, name), each gap named by the
    event that ends it; the longest `top`."""
    events = sorted(events)
    total = collections.defaultdict(float)
    reach = None
    for s, e, name in events:
        if reach is not None and s > reach:
            total[f"before {name}"] += (s - reach) / per_second
        reach = e if reach is None else max(reach, e)
    return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:top]]


def read(prof, torch) -> Trace:
    """The `Trace` of a finished `torch.profiler.profile`, from its raw
    events (no Python event objects are built: a window holds hundreds of
    thousands of launches)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = []
    names = {}
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        s, dur, raw = e.start_ns(), e.duration_ns(), e.name()
        name = names.get(raw)
        if name is None:
            name = names[raw] = short_name(raw)
        events.append((s, s + dur, name))
        by_name[name][0] += dur / 1e9
        by_name[name][1] += 1
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    return Trace(busy_s=busy_seconds([(s, e) for s, e, _ in events]),
                 device_events=len(events), by_name=dict(by_name),
                 gaps=name_gaps(events))
