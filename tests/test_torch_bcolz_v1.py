"""The port's bcolz v1 reader and import against the reference's cases.

``tests/test_bcolz_v1.py``'s cases run on ``bqueryd_tpu_torch.storage``'s
``bcolz_v1`` and ``native`` (its module globals swapped for the port's),
with its hand-made chunks: the blosclz vectors through both decoders,
shuffled, bit-shuffled, memcpyed and unsplit chunks, the carray and
ctable readers and corrupt input.  The import and the CLI run on the
port's ctable and query engine.  Then the two packages side by side: the
port's Python and native decoders give the JAX package's bytes for every
chunk kind; both packages' ``import_ctable`` write tables whose columns
read equal (dtype and values) through both readers; and the CLI
``import`` runs as a process that loads no torch.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import test_bcolz_v1 as ref
from bqueryd_tpu.storage import bcolz_v1 as jax_bcolz
from bqueryd_tpu.storage import native as jax_native
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch.storage import bcolz_v1 as port_bcolz
from bqueryd_tpu_torch.storage import native as port_native
from bqueryd_tpu_torch.storage.codec import _bitunshuffle
from bqueryd_tpu_torch.storage.ctable import ctable as port_ctable
from tests.torch_fixtures import native_libs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ported(monkeypatch):
    monkeypatch.setattr(ref, "bcolz_v1", port_bcolz)
    monkeypatch.setattr(ref, "native", port_native)


VECTORS = ["test_literal_run", "test_rle_match", "test_overlapping_match",
           "test_extended_length", "test_far_distance"]


@pytest.mark.parametrize("decoder", ["py", "native"])
@pytest.mark.parametrize("vector", VECTORS)
def test_reference_blosclz_vector_on_port(vector, decoder, ported):
    decoders = dict(ref._decoders())
    assert port_native.blosc_available(), "the native lib lacks Blosc"
    getattr(ref.TestBloscLZVectors(), vector)(decoder, decoders[decoder])


CASES = [
    "test_python_and_native_chunk_decoders_agree",
    "test_bitshuffled_chunk_decoders_agree",
    "test_read_carray_bitshuffle_roundtrip",
    "test_memcpyed_chunk",
    "test_unsplit_typesize_above_16",
    "test_read_carray_roundtrip",
    "test_read_carray_raw_leftover",
    "test_read_ctable_matches_pandas",
    "test_read_carray_datetime_and_float",
]


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_port(case, ported, tmp_path):
    fn = getattr(ref, case)
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()


@pytest.mark.parametrize("decoder", ["py", "native"])
def test_reference_corrupt_input_on_port(decoder, ported):
    ref.test_chunk_decoders_survive_corrupt_input(decoder)


def test_bitunshuffle_inverts_the_scalar_reference():
    """The port's bit-unshuffle recovers what the independent port of the
    bitshuffle library's scalar pipeline shuffled, for every typesize
    class and the unshuffled tail (the reference case's grid)."""
    rng = np.random.default_rng(11)
    for typesize in (1, 2, 3, 4, 8, 16):
        for nelems in (8, 64, 133):
            data = rng.integers(
                0, 256, nelems * typesize, dtype=np.uint8
            ).tobytes() + b"\x7f" * (typesize // 2)
            shuffled = ref.scalar_bitshuffle_reference(data, typesize)
            assert _bitunshuffle(shuffled, typesize) == data


def _chunks():
    """One chunk of every kind the fixture writer makes."""
    rng = np.random.default_rng(21)
    ints = rng.integers(0, 50, 4096).astype(np.int64)
    floats = rng.normal(size=2048).astype(np.float32)
    bools = rng.random(4096) < 0.2
    strings = np.array([f"name-{i % 9:019d}".encode() for i in range(600)],
                       dtype="|S24")
    return {
        "shuffled int64": ref.build_blosc_chunk(ints.tobytes(), 8),
        "bitshuffled int64": ref.build_blosc_chunk(ints.tobytes(), 8,
                                                   bitshuffle=True),
        "bitshuffled float32": ref.build_blosc_chunk(floats.tobytes(), 4,
                                                     bitshuffle=True),
        "bitshuffled bool": ref.build_blosc_chunk(bools.tobytes(), 1,
                                                  bitshuffle=True),
        "memcpyed": ref.build_blosc_chunk(ints.tobytes(), 8, mode="memcpy"),
        "unsplit |S24": ref.build_blosc_chunk(strings.tobytes(), 24),
        "leftover block": ref.build_blosc_chunk(ints[:1001].tobytes(), 8,
                                                blocksize=4096),
    }


@pytest.mark.usefixtures("native_libs")
@pytest.mark.parametrize("kind", list(_chunks()))
def test_decoders_match_the_jax_package_byte_for_byte(kind):
    chunk = _chunks()[kind]
    want = jax_bcolz._blosc_decode_chunk_py(chunk)
    assert port_bcolz._blosc_decode_chunk_py(chunk) == want
    assert port_bcolz.decode_chunk(chunk) == jax_bcolz.decode_chunk(chunk)
    assert port_native.blosc_available() and jax_native.blosc_available()
    nbytes, typesize, flags = port_native.blosc_info(chunk)
    assert (nbytes, typesize, flags) == jax_native.blosc_info(chunk)
    assert port_native.blosc_decode(chunk, nbytes) == want


def test_reference_import_end_to_end_on_port(tmp_path):
    """``test_import_ctable_end_to_end`` on the port: logical values equal
    the source's, a groupby over the converted table equals NumPy's, and
    the v1 attrs are kept."""
    from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
    from bqueryd_tpu_torch.parallel import hostmerge

    frame = ref._taxi_frame()
    src, dst = str(tmp_path / "legacy.bcolz"), str(tmp_path / "conv.bcolz")
    ref.write_bcolz_v1_ctable(src, frame)
    assert port_bcolz.import_ctable(src, dst) == len(frame["fare_cents"])
    t = port_ctable(dst)
    for name, values in frame.items():
        want = (np.char.decode(values, "utf-8") if values.dtype.kind == "S"
                else values)
        np.testing.assert_array_equal(np.asarray(t.column(name)), want)
    assert t.kind("vendor") == "dict"
    query = GroupByQuery(["passenger_count"], [["fare_cents", "sum", "s"]],
                         [], aggregate=True)
    payload = QueryEngine(device="cpu").execute_local(t, query)
    order, cols = hostmerge.finalize_table(
        hostmerge.merge_payloads([payload]))
    keys, sums = cols["passenger_count"], cols["s"]
    uniq = np.unique(frame["passenger_count"])
    want = [frame["fare_cents"][frame["passenger_count"] == k].sum()
            for k in uniq]
    np.testing.assert_array_equal(sums[np.argsort(keys)], want)
    assert t.attrs.get("bcolz_v1_attrs") == {"origin": "fixture"}


def test_imports_of_both_packages_read_equal_through_both_readers(tmp_path):
    frame = ref._taxi_frame(n=2345)
    src = str(tmp_path / "legacy.bcolz")
    ref.write_bcolz_v1_ctable(src, frame, chunklen=500)
    jax_dst, port_dst = str(tmp_path / "jax.bcolz"), str(tmp_path / "p.bcolz")
    assert jax_bcolz.import_ctable(src, jax_dst) == 2345
    assert port_bcolz.import_ctable(src, port_dst) == 2345
    tables = [reader(path) for reader in (jax_ctable, port_ctable)
              for path in (jax_dst, port_dst)]
    for name in frame:
        cols = [np.asarray(t.column(name)) for t in tables]
        for col in cols[1:]:
            assert col.dtype == cols[0].dtype, name
            np.testing.assert_array_equal(col, cols[0])
        # the stored dictionaries and kinds agree too
        assert len({t.kind(name) for t in tables}) == 1
    assert port_ctable(port_dst).dictionary("vendor") == jax_ctable(
        jax_dst).dictionary("vendor")
    assert all(t.attrs.get("bcolz_v1_attrs") == {"origin": "fixture"}
               for t in tables)


def test_reference_cli_import_on_port(tmp_path, monkeypatch):
    from bqueryd_tpu_torch import node

    monkeypatch.setattr(ref, "bcolz_v1", port_bcolz)
    frame = {"a": np.arange(50, dtype=np.int64)}
    src, dst = str(tmp_path / "legacy.bcolz"), str(tmp_path / "out.bcolz")
    ref.write_bcolz_v1_ctable(src, frame, chunklen=16)
    assert node.main(["import", src, dst]) == 0
    np.testing.assert_array_equal(np.asarray(port_ctable(dst).column("a")),
                                  frame["a"])
    with pytest.raises(SystemExit):
        node.main(["import", str(tmp_path / "out.bcolz"),
                   str(tmp_path / "again.bcolz")])


_CLI_IMPORT = """
import json, sys
from bqueryd_tpu_torch import node
rc = node.main(["import", sys.argv[1], sys.argv[2]])
heavy = sorted(m for m in sys.modules
               if m.split(".")[0] in ("torch", "pandas", "jax", "bqueryd_tpu"))
print(json.dumps({"rc": rc, "heavy": heavy}))
"""


def test_cli_import_process_loads_no_device(tmp_path):
    """``bqueryd-tpu-torch import`` is host work: the process converts the
    table without importing torch (so no device), pandas or JAX."""
    frame = {"k": np.arange(700, dtype=np.int64) % 5,
             "s": np.array([b"ab", b"cd"] * 350, dtype="|S2")}
    src, dst = str(tmp_path / "legacy.bcolz"), str(tmp_path / "out.bcolzs")
    ref.write_bcolz_v1_ctable(src, frame, chunklen=128)
    out = subprocess.run(
        [sys.executable, "-c", _CLI_IMPORT, src, dst], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, check=True,
    ).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert result == {"rc": 0, "heavy": []}
    t = port_ctable(dst)
    np.testing.assert_array_equal(np.asarray(t.column("k")), frame["k"])
    assert list(np.asarray(t.column("s"))) == ["ab", "cd"] * 350
