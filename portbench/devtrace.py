"""The device's side of a traced window, from the profiler's Chrome trace
(CUPTI activity records of the card).

Only the device's own records count: kernels, copies and memsets.  Busy
time is the union of their intervals, so that overlapping streams are not
counted twice.  The breakdown gives the operations that took most time
and the longest idle gaps between them, each named after the operation
that ended it.
"""

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace_path):
    """``[(start_us, end_us, name)]`` of the device records, by start."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e.get("name", "?"))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    out.sort()
    return out


def summarize(events, window_s, top=10):
    """``busy_s``, ``window_s``, ``records`` and the ``breakdown``
    (``device_ops``, ``idle_gaps``: at most ``top`` ``[name, seconds]``
    each)."""
    busy_us = 0.0
    gaps = []
    by_name = {}
    cur_start = cur_end = None
    for start, end, name in events:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy_us += cur_end - cur_start
            gaps.append((start - cur_end, name))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps.sort(key=lambda g: -g[0])
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "records": len(events),
        "breakdown": {
            "device_ops": [[name[:120], us / 1e6] for name, us in ops],
            "idle_gaps": [[f"idle before {name[:100]}", us / 1e6]
                          for us, name in gaps[:top]],
        },
    }
