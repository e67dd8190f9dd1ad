"""The port's kernel-build and device-memory profiling
(``bqueryd_tpu_torch.obs.profile``): the reference's names and snapshot
keys over the port's compile costs.

The kernel library's builds are accounted with a stand-in ``nvcc`` where
there is none (a library on disk is a hit, an ``nvcc`` run a miss with its
seconds and release, each load counted); ``instrument`` counts calls per
name and shape signature with analytic bytes and flops, evicts the least
recently called entry (``tests/test_obs_forensics.py``'s case, on both
packages), and passes through under the kill switch; the build directory
follows ``BQUERYD_TPU_COMPILE_CACHE`` (the reference's case, on both
packages); ``runtime_versions`` and the memory readers make no CUDA call
in a process without a CUDA context.
"""

import json
import os
import stat
import sys
import types

import pytest
import torch

import test_obs_forensics as ref_forensics
from bqueryd_tpu_torch import obs as port_obs
from bqueryd_tpu_torch.obs import profile
from bqueryd_tpu_torch.ops import onehot
from tests.torch_fixtures import (  # noqa: F401
    disarmed_port_chaos,
    fresh_port_calibration,
)

PACKAGES = ("jax", "port")


@pytest.fixture
def fresh_profiler():
    prof = profile._reset_for_tests()
    yield prof
    profile._reset_for_tests()


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", [
    "test_program_registry_evicts_least_recently_called",
    "test_compile_cache_info_follows_env",
])
def test_reference_profile_case(case, pkg, monkeypatch, tmp_path):
    if pkg == "port":
        monkeypatch.setattr(ref_forensics, "profile", profile)
    fn = getattr(ref_forensics, case)
    if case.startswith("test_compile_cache"):
        fn(monkeypatch, tmp_path)
    else:
        fn(monkeypatch)


# -- the kernel library's builds -----------------------------------------------------

FAKE_NVCC = """#!{python}
import sys
if "--version" in sys.argv:
    print("nvcc: NVIDIA (R) Cuda compiler driver")
    print("Cuda compilation tools, release 12.4, V12.4.131")
    sys.exit(0)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"not a real library")
print("ptxas info    : fake", file=sys.stderr)
"""


class _FakeLib:
    """What ``ctypes.CDLL`` returns for the stand-in library: every
    symbol a settable callable."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace(restype=None, argtypes=None)
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_toolchain(monkeypatch, tmp_path, fresh_profiler):
    """A stand-in nvcc, a build directory of the test's own (through
    ``BQUERYD_TPU_COMPILE_CACHE``) and a ctypes loader that accepts the
    stand-in library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build_dir = tmp_path / "kernels"
    monkeypatch.setenv("BQUERYD_TPU_COMPILE_CACHE", str(build_dir))
    monkeypatch.setattr(onehot, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(onehot.ctypes, "CDLL", lambda path: _FakeLib())
    monkeypatch.setattr(onehot, "_lib", None)
    monkeypatch.setattr(onehot, "_LOADS", [0])
    return build_dir


def test_build_counts_a_miss_then_hits_and_keeps_the_release(
        fake_toolchain, fresh_profiler):
    path = onehot.build()
    assert os.path.dirname(path) == str(fake_toolchain)
    snap = fresh_profiler.snapshot()
    assert (snap["persistent_cache_misses"],
            snap["persistent_cache_hits"]) == (1, 0)
    assert sum(snap["compile_seconds"]["counts"]) == 1
    assert fresh_profiler.nvcc_release == "release 12.4, V12.4.131"
    assert onehot.build() == path
    assert onehot.build() == path
    snap = fresh_profiler.snapshot()
    assert (snap["persistent_cache_misses"],
            snap["persistent_cache_hits"]) == (1, 2)
    # only a miss observes the compile histogram
    assert sum(snap["compile_seconds"]["counts"]) == 1
    # a process that finds the library on disk still learns the release
    profile._reset_for_tests()
    onehot.build()
    assert profile.profiler().nvcc_release == "release 12.4, V12.4.131"
    assert profile.runtime_versions()["nvcc"] == "release 12.4, V12.4.131"


def test_library_load_is_counted_once(fake_toolchain, fresh_profiler):
    onehot._library()
    onehot._library()
    assert fresh_profiler.library_loads == 1
    assert onehot._LOADS == [1]
    assert fresh_profiler.snapshot()["library_loads"] == 1


def test_a_call_that_loads_the_library_is_a_compile(fake_toolchain,
                                                    fresh_profiler):
    def first_launch(x):
        onehot._library()
        return x

    wrapped = profile.instrument("ops.first", first_launch)
    wrapped(torch.zeros(4))
    wrapped(torch.zeros(4))
    (entry,) = fresh_profiler.snapshot()["programs"]
    assert entry["calls"] == 2 and entry["compiles"] == 1
    assert entry["last_compile_s"] is not None


def test_build_without_the_cache_goes_to_a_directory_of_its_own(
        fake_toolchain, fresh_profiler, monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_COMPILE_CACHE", "0")
    monkeypatch.setattr(profile, "_private_build_dir", [])
    path = onehot.build()
    assert not path.startswith(str(fake_toolchain))
    assert os.path.dirname(path) == profile.kernel_build_dir()
    assert profile.compile_cache_info() == {
        "enabled": False, "path": None, "writable": False}


def test_default_build_directory_is_build_kernels(monkeypatch):
    monkeypatch.delenv("BQUERYD_TPU_COMPILE_CACHE", raising=False)
    info = profile.compile_cache_info()
    assert info["enabled"] is True
    assert info["path"].endswith(os.path.join("build", "kernels"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert info["path"] == os.path.join(repo, "build", "kernels")
    assert profile.kernel_build_dir() == info["path"]


# -- instrument ----------------------------------------------------------------------

def test_instrument_counts_calls_per_name_and_shape(fresh_profiler):
    def contraction(codes, rows, n_rows, n_groups):
        return torch.zeros(n_rows, n_groups)

    wrapped = profile.instrument(
        "ops.test_rows_dot", contraction,
        cost=lambda args, _k: 2 * int(args[2]) * int(args[0].shape[0]))
    codes = torch.zeros(100, dtype=torch.int32)
    rows = torch.zeros(3, 100, dtype=torch.bfloat16)
    for _ in range(3):
        wrapped(codes, rows, 3, 8)
    wrapped(codes[:50], rows[:, :50], 3, 8)
    snap = fresh_profiler.snapshot()
    assert (snap["jit_cache_misses"], snap["jit_cache_hits"]) == (2, 2)
    by_sig = {p["signature"]: p for p in snap["programs"]}
    entry = by_sig["ops.test_rows_dot(int32[100];bfloat16[3,100];3;8)"]
    assert entry["calls"] == 3 and entry["jit_cache_hits"] == 2
    assert entry["compiles"] == 0
    assert entry["flops"] == 2 * 3 * 100
    # each tensor argument read once, the output written once
    assert entry["bytes_accessed"] == 100 * 4 + 300 * 2 + 3 * 8 * 4
    assert sum(p["calls"] for p in snap["programs"]
               if p["name"] == "ops.test_rows_dot") == 4
    assert fresh_profiler.last_program("ops.test_")["calls"] == 1
    json.dumps(snap)


def test_instrument_signature_of_tuples_and_keywords(fresh_profiler):
    wrapped = profile.instrument("ops.pt", lambda *a, **k: None)
    wrapped(torch.zeros(5, dtype=torch.int64),
            (torch.zeros(5), torch.zeros(5, dtype=torch.int32)),
            ("sum", "max"), 7, strategy=None)
    (entry,) = fresh_profiler.snapshot()["programs"]
    assert entry["signature"] == (
        "ops.pt(int64[5];(float32[5],int32[5]);('sum', 'max');7;None)")


def test_instrument_respects_the_kill_switches(fresh_profiler, monkeypatch):
    wrapped = profile.instrument("ops.off", lambda x: x + 1)
    port_obs.set_enabled(False)
    try:
        assert wrapped(1) == 2
    finally:
        port_obs.set_enabled(True)
    monkeypatch.setenv("BQUERYD_TPU_COMPILE_PROFILE", "0")
    assert wrapped(2) == 3
    monkeypatch.setenv("BQUERYD_TPU_METRICS", "0")
    monkeypatch.delenv("BQUERYD_TPU_COMPILE_PROFILE")
    assert wrapped(3) == 4
    assert fresh_profiler.snapshot()["programs_tracked"] == 0
    assert wrapped.__name__ == "off" and wrapped.__wrapped__(0) == 1


def test_instrument_never_fails_the_call(fresh_profiler):
    def bad_cost(args, kwargs):
        raise RuntimeError("cost model broke")

    wrapped = profile.instrument("ops.robust", lambda x: x, cost=bad_cost)
    assert wrapped(5) == 5
    assert fresh_profiler.snapshot()["programs_tracked"] == 0


def test_kernel_wrapper_calls_are_instrumented_with_their_cost(
        fresh_profiler):
    """``partial_tables`` and the contraction it reaches are counted per
    shape, the contraction with one multiply-add per stacked-row element;
    on the CPU the wrapper takes its plain version, and launches
    nothing."""
    from bqueryd_tpu_torch import ops

    onehot.reset_launch_counts()
    codes = torch.tensor([0, 1, 2, 1, 0, 2, 2], dtype=torch.int64)
    values = torch.arange(7, dtype=torch.int64)
    ops.partial_tables(codes, (values,), ("sum",), 3, strategy="matmul!")
    names = {p["name"]: p for p in fresh_profiler.snapshot()["programs"]}
    assert "ops.partial_tables" in names
    (kernel,) = [p for n, p in names.items() if n.startswith("ops.onehot")]
    n_rows = int(kernel["signature"].split(";")[2])
    assert kernel["flops"] == 2 * n_rows * 7
    assert onehot.onehot_rows_dot.launches == 0


def test_bind_exposes_the_profile_on_a_registry(fresh_profiler):
    registry = port_obs.MetricsRegistry()
    fresh_profiler.bind(registry)
    fresh_profiler.record_build(hit=False, seconds=2.5)
    fresh_profiler.record_build(hit=True)
    text = registry.render()
    for line in ("bqueryd_tpu_persistent_cache_misses 1",
                 "bqueryd_tpu_persistent_cache_hits 1",
                 "bqueryd_tpu_compile_seconds_count 1",
                 "bqueryd_tpu_device_bytes_in_use nan"):
        assert line in text
    assert registry.lint() == []


# -- no CUDA call without a CUDA context --------------------------------------------

@pytest.fixture
def cuda_forbidden(monkeypatch):
    """Every torch.cuda reader raises, and torch reports no context."""
    def boom(*args, **kwargs):
        raise AssertionError("a CUDA call in a process without a context")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    for name in ("get_device_name", "memory_stats", "mem_get_info",
                 "current_device", "device_count", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, boom)


def test_runtime_versions_report_torch_without_a_cuda_call(cuda_forbidden):
    versions = profile.runtime_versions()
    assert versions["torch"] == torch.__version__
    assert versions["torch_cuda"] == torch.version.cuda
    assert "numpy" in versions
    assert "device" not in versions
    json.dumps(versions)


def test_memory_readers_make_no_cuda_call(cuda_forbidden, fresh_profiler):
    assert fresh_profiler.memory_sample() is None
    assert fresh_profiler.device_memory() == []
    registry = port_obs.MetricsRegistry()
    fresh_profiler.bind(registry)
    assert "bqueryd_tpu_device_peak_bytes_in_use nan" in registry.render()


def test_controller_process_never_imports_torch(tmp_path):
    """A controller's profile (runtime versions, build directory, its
    debug bundle) reads no torch: the module is not even imported."""
    import subprocess

    code = (
        "import sys, os\n"
        "os.environ['BQUERYD_TPU_IP'] = '127.0.0.1'\n"
        "from bqueryd_tpu_torch.controller import ControllerNode\n"
        "from bqueryd_tpu_torch.obs import profile\n"
        f"c = ControllerNode(coordination_url='mem://x', "
        f"runfile_dir={str(tmp_path)!r})\n"
        "info = c.get_info(); bundle = c.build_debug_bundle()\n"
        "assert 'torch' in info['runtime'], info['runtime']\n"
        "assert 'torch_cuda' not in info['runtime']\n"
        "assert bundle['controller']['compile_cache']['path']\n"
        "c.stop()\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
