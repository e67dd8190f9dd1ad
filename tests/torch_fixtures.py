"""Fixtures shared by the port's test modules, imported by name into each
module that uses them (``tests/conftest.py`` resets only the JAX
package's process-global state), and the swap that runs the reference's
cluster cases on port nodes (:func:`on_port`)."""

import sys

import pandas as pd
import pytest

from bqueryd_tpu_torch import worker as port_worker


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


class CPUWorkerNode(port_worker.WorkerNode):
    """The port's calc worker on the CPU."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(*args, **kwargs)


class FrameRPC:
    """The port's ``RPC`` with its ``(order, columns)`` answers as the
    DataFrames the reference's cases read; every other verb passes
    through."""

    def __init__(self, *args, **kwargs):
        from bqueryd_tpu_torch import rpc as port_rpc

        self._rpc = port_rpc.RPC(*args, **kwargs)

    @staticmethod
    def _frame(result):
        order, cols = result
        return pd.DataFrame({c: list(cols[c]) if cols[c].dtype == object
                             else cols[c] for c in order}, columns=order)

    def groupby(self, *args, **kwargs):
        return self._frame(self._rpc.groupby(*args, **kwargs))

    def query(self, *args, **kwargs):
        return self._frame(self._rpc.query(*args, **kwargs))

    def __getattr__(self, name):
        return getattr(self._rpc, name)


#: the JAX package's modules that are replaced whole by the port's
#: during a swapped case (their functions are imported by name)
PORT_MODULES = ("blob", "download", "storage.bcolz_v1")


@pytest.fixture
def on_port(monkeypatch):
    """The JAX package's names that the reference's cases import point at
    the port's for the test's duration: the nodes (the calc worker on the
    CPU), the client (answers as DataFrames), the messages, ``chaos``,
    the store, ``zip_to_file`` and the blob, download and bcolz v1
    modules; nodes advertise 127.0.0.1."""
    import importlib

    import bqueryd_tpu
    import bqueryd_tpu.controller as jax_controller
    import bqueryd_tpu.coordination as jax_coordination
    import bqueryd_tpu.messages as jax_messages
    import bqueryd_tpu.rpc as jax_rpc
    import bqueryd_tpu.utils.net as jax_net
    import bqueryd_tpu.worker as jax_worker
    from bqueryd_tpu_torch import chaos as port_chaos
    from bqueryd_tpu_torch import controller as port_controller
    from bqueryd_tpu_torch import coordination as port_coordination
    from bqueryd_tpu_torch import messages as port_messages
    from bqueryd_tpu_torch import rpc as port_rpc
    from bqueryd_tpu_torch.utils import net as port_net

    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    monkeypatch.setattr(jax_controller, "ControllerNode",
                        port_controller.ControllerNode)
    monkeypatch.setattr(jax_controller, "MAX_DISPATCH_RETRIES",
                        port_controller.MAX_DISPATCH_RETRIES)
    for name in ("CalcMessage", "ErrorMessage", "WorkerRegisterMessage",
                 "RPCMessage", "TicketDoneMessage"):
        monkeypatch.setattr(jax_messages, name, getattr(port_messages, name))
    monkeypatch.setattr(jax_worker, "WorkerNode", CPUWorkerNode)
    for name in ("DownloaderNode", "MoveBcolzNode"):
        monkeypatch.setattr(jax_worker, name, getattr(port_worker, name))
    monkeypatch.setattr(jax_rpc, "RPC", FrameRPC)
    monkeypatch.setattr(jax_rpc, "RPCError", port_rpc.RPCError)
    monkeypatch.setattr(bqueryd_tpu, "chaos", port_chaos)
    monkeypatch.setattr(jax_coordination, "coordination_store",
                        port_coordination.coordination_store)
    monkeypatch.setattr(jax_net, "zip_to_file", port_net.zip_to_file)
    for name in PORT_MODULES:
        port = importlib.import_module(f"bqueryd_tpu_torch.{name}")
        parent, _, leaf = f"bqueryd_tpu.{name}".rpartition(".")
        monkeypatch.setitem(sys.modules, f"bqueryd_tpu.{name}", port)
        monkeypatch.setattr(importlib.import_module(parent), leaf, port,
                            raising=False)
