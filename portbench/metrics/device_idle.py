"""``device_idle``: the share of the traced window in which no kernel,
copy or memset ran on a card (the union of its records' intervals, from
the worker's ``torch.profiler`` CUDA trace), averaged over the cards, in
%: 1 − the mean busy time ÷ the window.  Layer: the device.  Nothing to
read without a device trace."""


def read(window):
    device = window.device
    if not device or device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - device["busy_s"] / device["window_s"])
