"""The ``h2d_mb`` reader on windows made by hand: the autopsies' tagged
upload bytes of the layout and of the mask, per query, on a card only."""

import pytest

from portbench import harness, spec

DEVICE = {"busy_s": 1.0, "window_s": 2.0, "records": 3, "breakdown": {}}


def _window(autopsies, device=DEVICE):
    return harness.Window([], 2.0, autopsies, device, [])


def _autopsy(**tagged):
    record = {"segments": {"h2d_transfer": 0.01}, "wall_s": 0.1}
    if tagged:
        record["tagged"] = {seg: {"bytes": n} for seg, n in tagged.items()}
    return record


def _read(window):
    return spec.Cell("taxi10m.dashboard-c8", spec.ROOT).reader(
        "h2d_mb").read(window)


def test_h2d_mb_sums_the_layout_and_the_mask_per_query():
    window = _window([
        _autopsy(h2d_transfer=16_000_000, filter=33_000_000,
                 d2h_fetch=5_000),
        _autopsy(h2d_transfer=0, filter=0),        # the working set held all
        _autopsy(h2d_transfer=2_000_000),
    ])
    assert _read(window) == pytest.approx((49.0 + 0.0 + 2.0) / 3)


@pytest.mark.parametrize("window", [
    _window([_autopsy(h2d_transfer=1)], device=None),   # off a card
    _window([]),                                         # no autopsies
    _window([_autopsy(), _autopsy()]),                   # no tagged bytes
])
def test_h2d_mb_reads_nothing_without_its_inputs(window):
    assert _read(window) is None
