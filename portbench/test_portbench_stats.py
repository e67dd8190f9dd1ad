"""``qps`` and ``p95_ms`` over every request of a window."""

import math
import os
import threading
import time

import pytest

from portbench import spec, stats

HERE = os.path.dirname(os.path.abspath(__file__))


def test_percentile_interpolates_and_counts_failures():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95)
    assert stats.percentile([1.0] * 99 + [math.inf], 95) == pytest.approx(1.0)
    assert stats.percentile([1.0] * 90 + [math.inf] * 10, 95) == math.inf
    assert stats.percentile([], 95) is None


def test_window_counts_completions_inside_and_walls_of_all_sent():
    recs = [{"ok": True, "sent": 0.0, "done": 0.5},
            {"ok": True, "sent": 0.5, "done": 1.0},
            # sent inside, done after the close: its wall counts, not its
            # completion
            {"ok": True, "sent": 1.5, "done": 3.0},
            {"ok": False, "sent": 1.0, "done": 1.2}]
    m = stats.window_metrics(recs, 0.0, 2.0)
    assert m["qps"] == pytest.approx(1.0)
    assert m["p95_ms"] == math.inf


class FakeServer:
    """One worker: requests are served one at a time, 2 ms each; the first
    request served after ``stall_at`` holds it ``stall_s`` longer, as a
    stalled worker would."""

    def __init__(self, stall_at, stall_s):
        self.lock = threading.Lock()
        self.stall_at = stall_at
        self.stall_s = stall_s

    def ask(self, rpc, query):
        with self.lock:
            time.sleep(0.002)
            if self.stall_s and time.perf_counter() >= self.stall_at:
                time.sleep(self.stall_s)
                self.stall_s = 0.0
        return {"ok": True}


def _window(stall_s, clients=8, seconds=0.5):
    loop = spec.Cell("taxi10m.dashboard-c8").loop()
    records, lock = [], threading.Lock()

    def record(i, q, sent, done, answer, error):
        with lock:
            records.append({"ok": error is None, "sent": sent, "done": done})

    def stream():
        while True:
            yield {"shape": "s"}

    start = time.perf_counter() + 0.02
    end = start + seconds
    server = FakeServer(start + seconds / 3, stall_s)
    # the clients as threads here: each runs the loop as its process would
    threads = [threading.Thread(target=loop.run_client,
                                args=(None, stream(), server.ask, record,
                                      start, end))
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    return stats.window_metrics(records, start, end)


def test_an_injected_stall_moves_qps_and_p95():
    clean = _window(0.0)
    # 8 queries wait 0.3 s of a 0.5 s window: more than 5% of all sent
    stalled = _window(0.3)
    assert stalled["qps"] < 0.8 * clean["qps"]
    assert stalled["p95_ms"] > max(100.0, 3 * clean["p95_ms"])
