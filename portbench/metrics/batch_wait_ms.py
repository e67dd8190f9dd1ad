"""``batch_wait_ms``: the time a query spent staged in the controller's
micro-batch window, the autopsy segment ``batch_window_wait``, mean over
the autopsies of the window's last queries, in ms.  Layer: the controller
(``controller``, ``plan/bundle``)."""


def read(window):
    if not window.autopsies:
        return None
    total = sum(float(a["segments"].get("batch_window_wait", 0.0))
                for a in window.autopsies)
    return 1e3 * total / len(window.autopsies)
