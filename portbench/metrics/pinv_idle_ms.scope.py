"""Milliseconds a cell in which the device ran nothing while the host was inside the
program's ``mset2.train.pinv`` span (the eigh pseudo-inverse: cuSOLVER syevd's host
loop and its synchronizes): the traced window's idle time, intersected with that
span's host ranges."""

import re

SPAN = re.compile(r"^mset2\.train\.pinv$")


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(run):
    t = run.trace
    if t is None or not run.units:
        return None
    lo, hi = t.window
    ranges = _merged((max(h.start, lo), min(h.end, hi)) for h in t.host if SPAN.search(h.name))
    if not ranges:
        return None
    busy = t.busy_intervals()
    covered, j = 0, 0
    for s, e in ranges:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    idle = sum(e - s for s, e in ranges) - covered
    return idle * 1e-6 / run.units
