"""``agg_roofline``: the least time the aggregations of the window's
queries could take on the card (``portbench/roofline.py``, summed over the
queries the card computed), as a share of the card's busy time over the
traced window, in %.  Layer: the kernels (``ops/onehot``,
``csrc/onehot_groupby.cu``, ``ops/groupby``).  Nothing to read without a
device trace, or where the card computed no query."""


def read(window):
    device = window.device
    if not device or device["busy_s"] <= 0 or not window.least_s:
        return None
    return 100.0 * sum(window.least_s) / device["busy_s"]
