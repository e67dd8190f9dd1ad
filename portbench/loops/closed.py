"""A closed loop: the client sends its next query as soon as the previous
one has answered, with no think time, until the window closes.  A query
in flight at the close is waited for; only queries sent inside the window
count.  Each client runs this in its own thread, with its own ``RPC``."""

import time


def run_client(rpc, stream, ask, record, start_at, end_at):
    """Drive one client's ``rpc`` over its query iterator ``stream`` from
    ``start_at`` to ``end_at`` (``time.perf_counter``).
    ``ask(rpc, query)`` sends one query; ``record(index, query, sent, done,
    answer, error)`` keeps what it returned."""
    delay = start_at - time.perf_counter()
    if delay > 0:
        time.sleep(delay)
    index = 0
    while True:
        sent = time.perf_counter()
        if sent >= end_at:
            return
        query = next(stream)
        answer = error = None
        try:
            answer = ask(rpc, query)
        except Exception as exc:  # a failed query is counted, not fatal
            error = f"{type(exc).__name__}: {exc}"
        record(index, query, sent, time.perf_counter(), answer, error)
        index += 1
