"""Fixtures shared by the port's test modules, imported by name into each
module that uses them (``tests/conftest.py`` resets only the JAX
package's process-global state)."""

import pytest


@pytest.fixture(autouse=True)
def fresh_port_calibration():
    """An empty process-global calibration store for each test: the walls
    one test's executor or engine records must not steer a later test's
    hints and routes, whatever the order the tests run in."""
    from bqueryd_tpu_torch.plan import calibrate

    calibrate._reset_for_tests()
    yield


@pytest.fixture(autouse=True)
def disarmed_port_chaos():
    """The port's fault injection disarmed and its counters zeroed around
    each test: a plan armed by one test must not fire in another's
    cluster."""
    from bqueryd_tpu_torch import chaos

    chaos._reset_for_tests()
    yield
    chaos._reset_for_tests()
