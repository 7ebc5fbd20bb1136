"""The traced window: a ``torch.profiler`` trace reduced to what the
per-layer readers and the result's ``device`` and ``breakdown`` need.

The harness marks its own spans with ``record_function``: ``bench.window``
around the measured window, ``bench.compile`` around each call into the
compiler and ``bench.search`` around its call into the search.  A gap in
the device's activity is put down to the innermost host event that spans
its middle.
"""
from __future__ import annotations

WINDOW = "bench.window"


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def short_name(name: str) -> str:
    """``void (anonymous namespace)::alloc_scan_kernel<2>(unsigned char
    const*, ...)`` -> ``alloc_scan_kernel``; other names as they are."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip() or name


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict:
    """``window_s``, ``busy_s`` (the union of device activity inside the
    window), per device operation its count and seconds, and the idle gaps
    by the host event they fall in."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            # a user annotation's range on the device is no device work
            if not ev.is_user_annotation():
                device.append((start, end, ev.name()))
        else:
            host.append((start, end, ev.name(), ev.start_thread_id()))
    spans = [h for h in host if h[2] == WINDOW]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1, _, thread = spans[0]
    # the harness's thread: where the window's calls run
    host = [h[:3] for h in host if h[3] == thread]
    ops = {}
    inside = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        op = ops.setdefault(short_name(name), [0, 0])
        op[0] += 1
        op[1] += e - s
    busy = _merge(inside)
    gaps = []
    t = w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_ops": {k: {"count": c, "seconds": ns / 1e9}
                       for k, (c, ns) in ops.items()},
        "idle_by_host": _attribute(gaps, host),
    }


def _segments(host) -> list:
    """The host's timeline as ``(start, end, innermost event)`` pieces, from
    the events of one thread (nested; a child cut at its parent's end)."""
    segs, stack, t = [], [], None
    for s, e, name in sorted(host, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            segs.append((t, end, nm))
            t = end
        if stack:
            segs.append((t, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        stack.append((e, name))
        t = s
    while stack:
        end, nm = stack.pop()
        segs.append((t, end, nm))
        t = end
    return [(a, b, n) for a, b, n in segs if b > a]


def _attribute(gaps, host) -> dict:
    """Seconds of device idleness by the innermost host event at each
    moment of each gap."""
    segs = _segments(host)
    out = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b, name = segs[k]
            overlap = min(b, g1) - max(a, g0)
            if overlap > 0:
                out[name] = out.get(name, 0) + overlap / 1e9
            k += 1
    return out


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
