"""The port's NetCDF classic reader (rdycore_tpu_torch/io/netcdf3.py)
against the JAX package's (rdycore_tpu/io/netcdf3.py) on the CPU: files
written here, CDF-1 and CDF-2, without record variables, with one and
with several (interleaved, each record slab padded to 4 bytes), global
and variable attributes of every type, and character arrays. Dimensions,
attributes, variable descriptions and every variable's values must be
equal; the values also equal what was written.
"""

import numpy as np
import pytest

from rdycore_tpu.io.netcdf3 import NetCDF3File as JaxNetCDF3File
from rdycore_tpu_torch.io.netcdf3 import NetCDF3File
from tools.torch_flood_files import write_netcdf3


def variables(records, rng):
    """(dims, variables, expected values) of a file with `records`
    record variables (0, 1 or 3) over 4 records."""
    dims = [("n", 5), ("m", 3), ("len_name", 7)]
    if records:
        dims.append(("time_step", 0))
    names = np.zeros((3, 7), dtype="S1")
    for i, s in enumerate((b"one", b"two", b"three")):
        names[i, : len(s)] = np.frombuffer(s, dtype="S1")
    vs = [
        ("f8", ("n", "m"), rng.standard_normal((5, 3)),
         {"units": "m", "scale": np.float32(0.5)}),
        ("f4", ("m",), rng.standard_normal(3).astype(np.float32)),
        ("i4", ("n",), rng.integers(-2**31, 2**31 - 1, 5).astype(np.int32),
         {"ids": np.arange(3, dtype=np.int32)}),
        ("i2", ("m",), np.array([-3, 0, 7], np.int16)),  # padded to 8 bytes
        ("i1", ("n",), np.arange(-2, 3, dtype=np.int8)),  # padded to 8
        ("names", ("m", "len_name"), names),
        ("scalar", (), np.array(2.5)),
    ]
    if records >= 1:
        vs.append(("time_whole", ("time_step",), np.arange(4.0) * 0.5))
    if records >= 3:
        vs.append(("rec_i2", ("time_step", "m"),
                   rng.integers(-100, 100, (4, 3)).astype(np.int16)))
        vs.append(("rec_f4", ("time_step", "n", "m"),
                   rng.standard_normal((4, 5, 3)).astype(np.float32)))
    return dims, vs


@pytest.mark.parametrize("records", [0, 1, 3])
@pytest.mark.parametrize("version", [1, 2])
def test_reader_matches_the_jax_package(tmp_path, version, records):
    rng = np.random.default_rng(version * 10 + records)
    dims, vs = variables(records, rng)
    path = str(tmp_path / "f.nc")
    write_netcdf3(path, dims, vs, {"title": "a test", "version":
                                   np.float64(8.5)}, version)
    port, jax = NetCDF3File(path), JaxNetCDF3File(path)
    assert port.numrecs == jax.numrecs == (4 if records else 0)
    assert port.dims == jax.dims == dims
    assert port.attrs.keys() == jax.attrs.keys() == {"title", "version"}
    assert port.attrs["title"] == jax.attrs["title"] == "a test"
    assert np.array_equal(port.attrs["version"], jax.attrs["version"])
    assert list(port.variables) == list(jax.variables) == [v[0] for v in vs]
    for name, _, want, *attrs in vs:
        p, j = port.variables[name], jax.variables[name]
        assert (p.dims, p.shape, p.dtype, p.begin, p.vsize, p.is_record) == (
            j.dims, j.shape, j.dtype, j.begin, j.vsize, j.is_record)
        for k, v in (attrs[0] if attrs else {}).items():
            assert np.array_equal(np.asarray(p.attrs[k]),
                                  np.asarray(j.attrs[k]))
        got = port.read(name)
        assert got.dtype == jax.read(name).dtype
        assert np.array_equal(got, jax.read(name))
        assert np.array_equal(got, np.asarray(want).reshape(got.shape))


def test_not_a_netcdf_file_is_refused(tmp_path):
    path = tmp_path / "f.nc"
    path.write_bytes(b"HDF\x01" + bytes(12))
    for cls in (NetCDF3File, JaxNetCDF3File):
        with pytest.raises(ValueError, match="not a NetCDF classic file"):
            cls(str(path))
