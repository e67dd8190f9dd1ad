"""``agg_roofline``: the least time the aggregations of the window's
queries could take on one card (``portbench/roofline.py``, summed over
the queries the cards computed), as a share of the cards' summed busy time
over the traced window (cards × the mean ``busy_s``), in %: both sides
are card-seconds.  Layer: the kernels (``ops/onehot``,
``csrc/onehot_groupby.cu``, ``ops/groupby``).  Nothing to read without a
device trace, or where the cards computed no query."""


def read(window):
    device = window.device
    if not device or device["busy_s"] <= 0 or not window.least_s:
        return None
    cards = len(device.get("busy_s_per_card") or [device["busy_s"]])
    return 100.0 * sum(window.least_s) / (cards * device["busy_s"])
