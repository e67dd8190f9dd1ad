"""The port's fleet capacity model (``bqueryd_tpu_torch.obs.capacity``)
against the JAX package's, and on port clusters.

``tests/test_capacity.py``'s pure cases (μ from histogram deltas, restart
rebasing, the stage clocks, rate windows, states and hysteresis, the knee
and headroom, the M/G/1 prediction and drift, the shadow advisor, the kill
switch, the gauges, the health scorer's rebase) run on both packages, and
the same seeded sequences of heartbeats, arrivals, dispatches and waits
give equal ``evaluate()`` and ``snapshot()`` records in both.  Then on
port nodes (the JAX package's node and client names pointed at the port's
for the case, ``on_port``): ``rpc.capacity()`` end to end, a worker
restarted mid-burst, the disabled stub, and
``tests/test_cluster_resilience.py``'s autopsy of a failover and its two
capacity cases (a killed and a wedged worker).
"""

import inspect
import os
import sys

import numpy as np
import pytest

import test_capacity as ref_capacity
import test_cluster_resilience as ref_resilience
from bqueryd_tpu.obs import capacity as jax_capacity
from bqueryd_tpu_torch.obs import capacity as port_capacity
from bqueryd_tpu_torch.obs import health as port_health
from tests.torch_fixtures import (  # noqa: F401
    CPUWorkerNode,
    FrameRPC,
    disarmed_port_chaos,
    fresh_port_calibration,
    on_port,
)
from test_capacity import capacity_cluster  # noqa: F401

PACKAGES = ("jax", "port")


@pytest.fixture
def on_package(monkeypatch):
    """``on_package("port")`` points ``tests/test_capacity.py``'s
    ``capacity`` and ``bqueryd_tpu.obs.health`` at the port's."""
    def use(pkg):
        if pkg != "port":
            return
        import bqueryd_tpu.obs as jax_obs

        monkeypatch.setattr(ref_capacity, "capacity", port_capacity)
        monkeypatch.setitem(sys.modules, "bqueryd_tpu.obs.health",
                            port_health)
        monkeypatch.setattr(jax_obs, "health", port_health)
    return use


PURE_CASES = [
    "test_service_totals_parses_and_defends",
    "test_mu_from_histogram_deltas",
    "test_restart_reset_rebases_not_poisons",
    "test_out_of_order_snapshot_is_not_a_restart",
    "test_idle_heartbeats_leave_moments_alone",
    "test_cv2_from_bucket_spread",
    "test_pipeline_busy_bottleneck_and_reset_guard",
    "test_rate_window_cold_start_and_trim",
    "test_classify_thresholds",
    "test_hysteresis_holds_then_flips",
    "test_fleet_knee_headroom_and_coverage",
    "test_mg1_prediction_measured_and_drift",
    "test_remove_worker_shrinks_fleet_mu",
    "test_advisor_scale_up_at_saturation",
    "test_advisor_silent_when_idle_and_at_low_load",
    "test_advisor_scale_down_when_overprovisioned",
    "test_advisor_rebalance_on_shard_skew",
    "test_advice_emitted_once_per_change_and_counted",
    "test_shed_offers_do_not_inflate_the_knee",
    "test_pid_change_is_an_exact_restart_signal",
    "test_advisor_sizes_against_usable_workers",
    "test_kill_switch_disables_taps_and_evaluate",
    "test_fleet_gauges_and_snapshot_json_safe",
    "test_health_scorer_rebases_on_worker_restart",
]


@pytest.fixture
def fast_knobs(monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_CAPACITY_HYSTERESIS_S", "0")
    monkeypatch.setenv("BQUERYD_TPU_CAPACITY_WINDOW_S", "30")


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", PURE_CASES)
def test_reference_capacity_case(case, pkg, on_package, monkeypatch,
                                 fast_knobs):
    on_package(pkg)
    fn = getattr(ref_capacity, case)
    given = {"monkeypatch": monkeypatch, "fast_knobs": None}
    fn(*(given[p] for p in inspect.signature(fn).parameters))


def test_tables_and_defaults_match_reference():
    for name in ("SERVICE_FAMILY", "STATE_CODES", "EWMA_ALPHA",
                 "DEFAULT_WINDOW_S", "DEFAULT_RHO_WARM",
                 "DEFAULT_RHO_SATURATED", "DEFAULT_HYSTERESIS_S",
                 "DEFAULT_TARGET_RHO"):
        assert getattr(port_capacity, name) == getattr(jax_capacity, name)


# -- equal records from the same sequences ----------------------------------------

def _drive(mod, seed, workers, restart_at=None, remove_at=None):
    """A seeded sequence of heartbeats (cumulative histograms, stage
    clocks, pids, a wedge), arrivals, launches, dispatches and measured
    waits; the model's evaluation after each beat and its snapshot."""
    rng = np.random.default_rng(seed)
    advice = []
    model = mod.CapacityModel(on_advice=advice.append)
    t0 = 1_000_000.0
    totals = {w: [0, 0.0, [0] * 5] for w in workers}
    busy = {w: {"decode": 0.0, "kernel": 0.0, "merge": 0.0}
            for w in workers}
    evaluations = []
    for beat in range(1, 25):
        now = t0 + beat
        for w in workers:
            if restart_at == beat and w == workers[0]:
                totals[w] = [0, 0.0, [0] * 5]
                busy[w] = {k: 0.0 for k in busy[w]}
            done = int(rng.integers(0, 20))
            service = float(rng.gamma(2.0, 0.01)) * done
            totals[w][0] += done
            totals[w][1] += service
            totals[w][2][int(rng.integers(0, 5))] += done
            for stage in busy[w]:
                busy[w][stage] += float(rng.random()) * 0.3
            snap = {mod.SERVICE_FAMILY: [{
                "buckets": [0.005, 0.01, 0.05, 0.25],
                "counts": list(totals[w][2]),
                "sum": totals[w][1],
            }]}
            pid = 100 + (1 if restart_at and beat >= restart_at
                         and w == workers[0] else 0)
            if remove_at is None or beat < remove_at or w != workers[-1]:
                model.absorb_worker(
                    w, snap, pipeline_busy={"busy_seconds": dict(busy[w])},
                    wedged=bool(w == workers[-1] and beat > 18), pid=pid,
                    now=now)
        if remove_at == beat:
            model.remove_worker(workers[-1])
        for q in range(int(rng.integers(0, 30))):
            cls = ("interactive", "default", "batch")[q % 3]
            model.observe_arrival(cls, now=now)
            if q % 4:
                model.observe_launch(now=now)
                model.observe_dispatch(
                    workers[q % len(workers)],
                    [f"s{int(rng.integers(0, 6))}"], now=now)
        model.observe_queue_wait(float(rng.exponential(0.02)))
        evaluations.append(model.evaluate(now=now))
    return evaluations, model.snapshot(), advice, model.worker_resets()


@pytest.mark.parametrize("seed,workers,restart_at,remove_at", [
    (1, ("w1",), None, None),
    (2, ("w1", "w2", "w3"), None, None),
    (3, ("w1", "w2"), 9, None),
    (4, ("w1", "w2", "w3"), None, 12),
    (5, ("w1", "w2", "w3", "w4"), 6, 15),
])
def test_capacity_records_match_reference(monkeypatch, seed, workers,
                                          restart_at, remove_at):
    monkeypatch.setenv("BQUERYD_TPU_CAPACITY_HYSTERESIS_S", "2")
    monkeypatch.setenv("BQUERYD_TPU_CAPACITY_WINDOW_S", "10")
    jax_out = _drive(jax_capacity, seed, workers, restart_at, remove_at)
    port_out = _drive(port_capacity, seed, workers, restart_at, remove_at)
    assert port_out == jax_out
    assert port_out[1]["fleet"]["workers"] >= 1


# -- port clusters ------------------------------------------------------------------

E2E_CASES = [
    "test_rpc_capacity_e2e",
    "test_worker_restart_mid_burst_rebases_model",
    "test_capacity_disabled_serves_stub",
]


@pytest.mark.parametrize("case", E2E_CASES)
def test_reference_capacity_e2e_on_port(case, on_port, capacity_cluster,
                                        monkeypatch):
    fn = getattr(ref_capacity, case)
    if "monkeypatch" in inspect.signature(fn).parameters:
        fn(capacity_cluster, monkeypatch)
    else:
        fn(capacity_cluster)


RESILIENCE_CASES = [
    "test_autopsy_attributes_failover_backoff",
    "test_capacity_kill_worker_shrinks_fleet_mu_and_advises_scale_up",
    "test_capacity_wedge_device_shrinks_fleet_mu_and_advises_scale_up",
]


@pytest.mark.parametrize("case", RESILIENCE_CASES)
def test_reference_resilience_case_on_port(case, on_port, tmp_path,
                                           monkeypatch):
    fn = getattr(ref_resilience, case)
    url = f"mem://torch-capacity-{os.urandom(4).hex()}"
    if "monkeypatch" in inspect.signature(fn).parameters:
        fn(tmp_path, url, monkeypatch)
    else:
        fn(tmp_path, url)
