"""``dispatch_wait_ms``: the controller's share of a query's wall, mean
over the autopsies (``rpc.autopsy``) of the window's last queries, in ms:
the segments ``admission_wait``, ``batch_window_wait``, ``plan`` and
``dispatch`` (which holds the wait for a busy worker).  Layer: the
controller (``controller``, ``plan/admission``, ``plan/bundle``)."""

SEGMENTS = ("admission_wait", "batch_window_wait", "plan", "dispatch")


def read(window):
    if not window.autopsies:
        return None
    total = sum(float(a["segments"].get(s, 0.0))
                for a in window.autopsies for s in SEGMENTS)
    return 1e3 * total / len(window.autopsies)
