"""The device readings of a traced window over one card and several:
``devtrace`` against its one-card form, and the two device readers on
traces whose cards are busy at different times."""

import json

import pytest

from portbench import devtrace, spec
from portbench.harness import Window

ONE_CARD_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def one_card_events(trace_path):
    """The one-card form of ``devtrace.device_events``: every device
    record, whatever its card."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e.get("name", "?"))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in ONE_CARD_CATS]
    out.sort()
    return out


def one_card_summarize(events, window_s, top=10):
    """The one-card form of ``devtrace.summarize``: the union of every
    record's interval."""
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


def _record(ts, dur, name, cat="kernel", device=0, pid=None):
    args = {} if device is None else {"device": device, "stream": 7}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": device if pid is None else pid, "tid": 7, "args": args}


def _write(tmp_path, records):
    path = tmp_path / "trace.json"
    host = [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.5,
             "dur": 9e6, "pid": 1234, "tid": 1}]
    path.write_text(json.dumps({"traceEvents": host + records}))
    return str(path)


def _one_card_trace():
    """Overlapping streams, repeated names, ties, a long name and more
    idle gaps than the breakdown keeps, on card 0."""
    long = "void_at::native::" + "x" * 200
    recs = []
    t = 1000.0
    for i in range(40):
        name = ("indexFuncLargeIndex", "radixSort", long, "memcpy")[i % 4]
        cat = "gpu_memcpy" if name == "memcpy" else "kernel"
        recs.append(_record(t, 10.0 + 0.37 * i, name, cat))
        if i % 3 == 0:  # a second stream, overlapping
            recs.append(_record(t + 2.5, 20.0, "elementwise"))
        t += 15.0 + (7.0 * i) % 23
    recs.append(_record(t, 0.0, "memset", "gpu_memset"))
    recs.append(_record(1000.0, 10.0, "indexFuncLargeIndex"))  # a tie
    return recs


def test_one_card_reads_as_the_one_card_form(tmp_path):
    path = _write(tmp_path, _one_card_trace())
    new = devtrace.summarize(devtrace.device_events(path), 51.25)
    old = one_card_summarize(one_card_events(path), 51.25)
    assert new == old
    assert json.dumps(new) == json.dumps(old)  # the same keys, in order
    assert len(old["breakdown"]["idle_gaps"]) == 10
    empty = _write(tmp_path, [])
    assert (devtrace.summarize(devtrace.device_events(empty), 3.0)
            == one_card_summarize(one_card_events(empty), 3.0))


def test_one_card_device_readers_read_as_before(tmp_path):
    path = _write(tmp_path, _one_card_trace())
    old = one_card_summarize(one_card_events(path), 0.004)
    new = devtrace.summarize(devtrace.device_events(path), 0.004)
    least = [1e-4, 2.5e-5]
    idle, roof = _readers(new, least)
    assert idle == 100.0 * (1.0 - old["busy_s"] / old["window_s"])
    assert roof == 100.0 * sum(least) / old["busy_s"]


def _two_cards():
    """Card 0 busy over the window's first half, card 1 over its second:
    never both at once, never both idle."""
    recs = []
    for i in range(50):
        recs.append(_record(1e4 * i, 1e4, "kernA", device=0))
        recs.append(_record(5e5 + 1e4 * i, 1e4, "kernB", device=1))
    return recs


def _readers(device, least_s):
    cell = spec.Cell("taxi10m.dashboard-c8")
    view = Window([], device["window_s"], [], device, least_s)
    return (cell.reader("device_idle").read(view),
            cell.reader("agg_roofline").read(view))


def test_two_cards_busy_in_turn_read_each_cards_idle(tmp_path):
    path = _write(tmp_path, _two_cards())
    events = devtrace.device_events(path)
    assert {e[3] for e in events} == {0, 1}
    dev = devtrace.summarize(events, 1.0)
    assert dev["busy_s_per_card"] == pytest.approx([0.5, 0.5])
    assert dev["busy_s"] == pytest.approx(0.5)
    # the union of both cards would read the whole window busy
    union = one_card_summarize(one_card_events(path), 1.0)
    assert union["busy_s"] == pytest.approx(1.0)
    idle, _roof = _readers(dev, [0.1])
    assert idle == pytest.approx(50.0)
    assert _readers(union, [0.1])[0] == pytest.approx(0.0)
    assert dev["records"] == 100
    assert dev["breakdown"]["device_ops"] == [
        ["kernA", pytest.approx(0.5)], ["kernB", pytest.approx(0.5)]]


def test_two_cards_idle_gaps_name_their_card(tmp_path):
    recs = [_record(0.0, 10.0, "a", device=0),
            _record(110.0, 10.0, "b", device=0),   # card 0 idle 100 us
            _record(0.0, 10.0, "c", device=1),
            _record(50.0, 10.0, "d", device=1)]    # card 1 idle 40 us
    dev = devtrace.summarize(devtrace.device_events(_write(tmp_path, recs)),
                             1.0)
    assert dev["breakdown"]["idle_gaps"] == [
        ["card 0: idle before b", pytest.approx(1e-4)],
        ["card 1: idle before d", pytest.approx(4e-5)]]
    assert dev["busy_s_per_card"] == pytest.approx([2e-5, 2e-5])


def test_two_cards_roofline_stays_within_a_hundred(tmp_path):
    # both cards busy at once over the window's first half, each at its
    # bound: one card's least time of the whole is 1.0 card-second
    recs = [_record(1e4 * i, 1e4, "kern", device=d)
            for i in range(50) for d in (0, 1)]
    path = _write(tmp_path, recs)
    dev = devtrace.summarize(devtrace.device_events(path), 1.0)
    least = [0.25, 0.75]
    _idle, roof = _readers(dev, least)
    assert 0.0 < roof <= 100.0
    assert roof == pytest.approx(100.0)
    # over the union of both cards' records it would read twice the bound
    union = one_card_summarize(one_card_events(path), 1.0)
    assert _readers(union, least)[1] == pytest.approx(200.0)


def test_a_record_without_a_device_falls_back_to_its_pid(tmp_path):
    recs = [_record(0.0, 10.0, "a", device=0),
            _record(0.0, 30.0, "b", device=None, pid=3),
            _record(40.0, 10.0, "c", device=None, pid=3)]
    events = devtrace.device_events(_write(tmp_path, recs))
    assert sorted(e[3] for e in events) == [0, 3, 3]
    dev = devtrace.summarize(events, 1.0)
    assert dev["busy_s_per_card"] == pytest.approx([1e-5, 4e-5])
    assert dev["busy_s"] == pytest.approx(2.5e-5)
    assert dev["breakdown"]["idle_gaps"] == [
        ["card 3: idle before c", pytest.approx(1e-5)]]


class _Executor:
    def __init__(self, devices):
        self.devices = devices
        self.device = devices[0]


class _Node:
    def __init__(self, devices):
        self.executor = _Executor(devices)


@pytest.mark.parametrize("peaks,expected", [
    ({"cuda:0": 1132302848}, {"memory_peak_bytes": 1132302848}),
    ({"cuda:0": 300, "cuda:1": 900, "cuda:2": 100, "cuda:3": 500},
     {"memory_peak_bytes": 900,
      "memory_peak_bytes_per_card": [300, 900, 100, 500]}),
])
def test_memory_peak_is_the_fullest_cards(monkeypatch, peaks, expected):
    import torch

    from portbench import node

    devices = tuple(torch.device(d) for d in peaks)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: peaks[str(d)])
    assert node.memory_peaks(_Node(devices)) == expected
    # a card that the executor repeats is read once
    assert node.memory_peaks(_Node(devices[:1] * 4)) == {
        "memory_peak_bytes": peaks["cuda:0"]}
