"""The shared dashboard's cell, ``taxi10m.dashboard-w40``, rehearsed on the
CPU, and its four readers on windows made by hand: autopsies that the
program's own attribution (``obs.slo.attribute``) builds from timelines
of a shared scan, of a bundle run member by member and of a query that
launched alone.  A scan's bytes and worker time count once, however many
members it served."""

import pytest

from portbench import harness, rehearse, spec

CELL = "taxi10m.dashboard-w40"
ROWS = 200_000
READERS = ("bundle_members", "batch_wait_ms", "member_worker_ms",
           "member_h2d_mb")
DEVICE = {"busy_s": 1.0, "window_s": 2.0, "records": 3, "breakdown": {}}
#: the scan behind the timelines: 40 ms staged, then 50 ms of filter (its
#: mask's upload) and 50 ms of kernel on the worker, inside its calc span
STAGED_S, FILTER_S, KERNEL_S = 0.040, 0.050, 0.050
SCAN_BYTES = 40_000_000


def test_traced_rehearsal_reports_the_bundle_layers(tmpdir_env):
    result = rehearse.rehearse(CELL, 2**31 + 41, 2.0, ROWS, trace=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    # member_h2d_mb reads only a card's traced window
    assert set(result["metrics"]) == {"bundle_members", "batch_wait_ms",
                                      "member_worker_ms"}
    assert result["metrics"]["bundle_members"]["value"] > 1.0
    assert result["metrics"]["batch_wait_ms"]["value"] > 0.0


def test_untraced_rehearsal_reports_the_end_to_end_metrics(tmpdir_env):
    result = rehearse.rehearse(CELL, 2**31 + 42, 2.0, ROWS)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"qps", "setup_s"}


def _span(name, start, duration, **tags):
    return {"trace_id": "t", "span_id": f"{name}-{start}", "name": name,
            "start_ts": 100.0 + start, "duration_s": duration,
            "tags": tags}


def _autopsy(members=1, path=None, share=None, staged=None):
    """The attribution record of one query: staged for ``STAGED_S`` when
    ``staged`` plans shared its flush, then a calc of ``FILTER_S`` +
    ``KERNEL_S`` that uploaded ``SCAN_BYTES``.  A bundle member's worker
    spans carry its ``share`` (the controller's demux), and the calc span
    the worker's ``path``."""
    from bqueryd_tpu_torch.obs import slo

    worker = {} if share is None else {"bundle_share": share}
    calc_tags = dict(worker)
    if path is not None:
        calc_tags.update(members=members, path=path)
    t0 = STAGED_S if staged else 0.0
    spans = [
        _span("groupby", 0.0, t0 + FILTER_S + KERNEL_S + 0.01),
        _span("calc", t0, FILTER_S + KERNEL_S, **calc_tags),
        _span("filter", t0, FILTER_S, bytes=SCAN_BYTES, **worker),
        _span("kernel", t0 + FILTER_S, KERNEL_S, **worker),
    ]
    timeline = {"trace_id": "t", "ok": True, "spans": spans}
    if staged:
        spans.append(_span("batch_window", 0.0, STAGED_S))
        timeline["batch"] = {"staged": staged, "members": members}
    return slo.attribute(timeline)


def _read(name, autopsies, device=DEVICE):
    window = harness.Window([], 2.0, autopsies, device, [])
    return spec.Cell(CELL, spec.ROOT).reader(name).read(window)


def _shared(k, staged=8):
    return [_autopsy(k, "shared", round(1.0 / k, 6), staged)
            for _ in range(k)]


SCAN_MS = 1e3 * (FILTER_S + KERNEL_S)


@pytest.mark.parametrize("k", [2, 4, 16])
def test_a_shared_scan_counts_its_bytes_and_worker_time_once(k):
    autopsies = _shared(k)
    assert all(a["batch"] == {"staged": 8, "members": k, "shared_scan": True}
               for a in autopsies)
    assert _read("bundle_members", autopsies) == pytest.approx(k)
    assert _read("batch_wait_ms", autopsies) == pytest.approx(1e3 * STAGED_S)
    # the k members' shares add up to the scan's, once
    assert k * _read("member_worker_ms", autopsies) == pytest.approx(
        SCAN_MS, rel=1e-4)
    assert k * _read("member_h2d_mb", autopsies) == pytest.approx(
        SCAN_BYTES / 1e6, rel=1e-4)


@pytest.mark.parametrize("staged", [None, 8])
def test_a_query_that_ran_alone_counts_in_full(staged):
    autopsies = [_autopsy(1, staged=staged)]
    assert ("batch" in autopsies[0]) == bool(staged)
    assert _read("member_worker_ms", autopsies) == pytest.approx(SCAN_MS)
    assert _read("member_h2d_mb", autopsies) == pytest.approx(
        SCAN_BYTES / 1e6)
    assert _read("batch_wait_ms", autopsies) == pytest.approx(
        1e3 * STAGED_S if staged else 0.0)
    assert _read("bundle_members", autopsies) == (1.0 if staged else None)


def test_a_bundle_run_member_by_member_computed_each_query_alone():
    """Its members' shares are their own walls' (here 1/4 each): the
    scan's time still counts once, and no query rode a shared scan."""
    autopsies = [_autopsy(4, "members", 0.25, 8) for _ in range(4)]
    assert all(not a["batch"]["shared_scan"] for a in autopsies)
    assert _read("bundle_members", autopsies) == 1.0
    assert 4 * _read("member_worker_ms", autopsies) == pytest.approx(SCAN_MS)


def test_a_mixed_window_takes_the_mean_per_query():
    autopsies = _shared(4) + [_autopsy(1, staged=8)]
    assert _read("bundle_members", autopsies) == pytest.approx(
        (4 * 4 + 1) / 5)
    assert _read("member_worker_ms", autopsies) == pytest.approx(
        (SCAN_MS + SCAN_MS) / 5, rel=1e-4)
    assert _read("member_h2d_mb", autopsies) == pytest.approx(
        2 * SCAN_BYTES / 1e6 / 5, rel=1e-4)


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_without_autopsies(name):
    assert _read(name, []) is None


def test_member_h2d_mb_reads_nothing_off_a_card():
    assert _read("member_h2d_mb", _shared(4), device=None) is None
