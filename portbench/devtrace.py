"""The device's side of a traced window, from the profiler's Chrome trace
(CUPTI activity records of the cards).

Only the device's own records count: kernels, copies and memsets, each on
its card (``args.device``, else the record's ``pid``).  A card's busy time
is the union of its records' intervals, so that overlapping streams are
not counted twice; ``busy_s`` is the mean over the cards that recorded.
The breakdown gives the operations that took most time, summed over the
cards, and the longest idle gaps between them, each named after the
operation that ended it (and, over several cards, after its card).
"""

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _card(event):
    card = (event.get("args") or {}).get("device", event.get("pid"))
    try:
        return int(card)
    except (TypeError, ValueError):
        return str(card)


def device_events(trace_path):
    """``[(start_us, end_us, name, card)]`` of the device records, by
    start."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e.get("name", "?"), _card(e))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    out.sort(key=lambda e: e[:3] + (str(e[3]),))
    return out


def _union(events):
    """A card's busy microseconds and its idle gaps ``[(us, name)]``."""
    busy_us = 0.0
    gaps = []
    cur_start = cur_end = None
    for start, end, name in events:
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
    return busy_us, gaps


def summarize(events, window_s, top=10):
    """``busy_s`` (the mean over the cards), ``window_s``, ``records`` and
    the ``breakdown`` (``device_ops``, ``idle_gaps``: at most ``top``
    ``[name, seconds]`` each); over several cards also ``busy_s_per_card``,
    in card order."""
    by_name = {}
    by_card = {}
    for start, end, name, card in events:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        by_card.setdefault(card, []).append((start, end, name))
    cards = sorted(by_card, key=lambda c: (isinstance(c, str), c))
    busy_us, gaps = [], []
    for card in cards:
        busy, card_gaps = _union(by_card[card])
        busy_us.append(busy)
        label = f"card {card}: " if len(cards) > 1 else ""
        gaps += [(us, f"{label}idle before {name[:100]}")
                 for us, name in card_gaps]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps.sort(key=lambda g: -g[0])
    out = {
        "busy_s": (sum(busy_us) / len(busy_us) if busy_us else 0.0) / 1e6,
        "window_s": window_s,
        "records": len(events),
        "breakdown": {
            "device_ops": [[name[:120], us / 1e6] for name, us in ops],
            "idle_gaps": [[name, us / 1e6] for us, name in gaps[:top]],
        },
    }
    if len(cards) > 1:
        out["busy_s_per_card"] = [us / 1e6 for us in busy_us]
    return out
