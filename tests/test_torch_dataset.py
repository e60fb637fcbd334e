"""The port's own copy of the lightweight Dataset
(``pyspeedy_tpu_torch/utils/dataset.py``): the cases of tests/test_dataset.py
(NetCDF round-trip, merge alignment including non-monotonic coordinates,
selection) on the port's copy, the JAX package's bundled files (NetCDF4
through h5py, NetCDF3 through scipy) read as the JAX package's copy reads
them, and the port's NetCDF3 copy of the boundary conditions.

The JAX package's ``pyspeedy_tpu/data/example_bc.nc`` is a NetCDF4 (HDF5)
file, which takes h5py to read. The port ships the same variables, values,
dimensions and attributes as a NetCDF3 file,
``pyspeedy_tpu_torch/data/example_bc.nc``, which scipy reads, so that
``Speedy.set_bc()`` with the bundled files needs no h5py (a machine may have
PyTorch and scipy but not h5py). write_netcdf3 below writes it, and a test
holds the committed file to its output byte for byte. Rewrite it from the
NetCDF4 original, from the repository root, where h5py is installed:

    python -m tests.test_torch_dataset
"""

import numpy as np
import pytest

from pyspeedy_tpu.utils import dataset as JDS
from pyspeedy_tpu_torch import (JAX_PACKAGE_DATA_DIR, PACKAGE_DATA_DIR,
                                example_bc_file, example_sst_anomaly_file)
from pyspeedy_tpu_torch.utils.dataset import (Dataset, Variable, merge,
                                              open_dataset, to_netcdf)

BC_SOURCE = JAX_PACKAGE_DATA_DIR / "example_bc.nc"
BC_TARGET = PACKAGE_DATA_DIR / "example_bc.nc"


def write_netcdf3(ds: Dataset, path) -> None:
    """Every variable of `ds` into a NetCDF3 file, with its type,
    dimensions and attributes as they are (Dataset.to_netcdf narrows float64
    to float32; this does not). A 1-D variable named after a dimension of
    the others, of that dimension's size, is that dimension's coordinate:
    the h5py reader labels a NetCDF4 dimension scale's own axis "dim_0"."""
    from scipy.io import netcdf_file

    named = {d: s for v in ds.variables.values()
             for d, s in zip(v.dims, v.data.shape) if not d.startswith("dim_")}
    dims = {name: ((name,) if v.data.ndim == 1
                   and named.get(name) == v.data.shape[0] else v.dims)
            for name, v in ds.variables.items()}
    sizes = {}
    for name, v in ds.variables.items():
        sizes.update(zip(dims[name], v.data.shape))
    with netcdf_file(str(path), "w", version=2) as f:
        for dim, size in sizes.items():
            f.createDimension(dim, size)
        for name, v in ds.variables.items():
            var = f.createVariable(name, v.data.dtype.newbyteorder(">"),
                                   dims[name])
            var[...] = v.data
            for key, val in v.attrs.items():
                setattr(var, key, val)


def _mk(time_val, ens=None, lev_desc=True):
    lev = np.array([0.9, 0.5, 0.1]) if lev_desc else np.array([0.1, 0.5, 0.9])
    shape = (1, 3, 2, 4) if ens is None else (1, 1, 3, 2, 4)
    dims = ("time", "lev", "lat", "lon") if ens is None else (
        "time", "ens", "lev", "lat", "lon")
    rng = np.random.default_rng(int(time_val) + (ens or 0))
    coords = {
        "time": Variable(("time",), np.array([np.datetime64(
            f"1982-01-{int(time_val):02d}")])),
        "lev": Variable(("lev",), lev),
        "lat": Variable(("lat",), np.array([-45.0, 45.0])),
        "lon": Variable(("lon",), np.arange(4.0)),
    }
    if ens is not None:
        coords["ens"] = Variable(("ens",), np.array([ens], dtype="int32"))
    return Dataset(
        data_vars={"t": Variable(dims, rng.random(shape).astype("f4"),
                                 {"units": "K"})},
        coords=coords)


@pytest.mark.parametrize("writer", ["method", "function"])
def test_netcdf_roundtrip(tmp_path, writer):
    ds = _mk(2)
    path = str(tmp_path / "out.nc")
    if writer == "method":
        ds.to_netcdf(path)
    else:
        to_netcdf(ds, path)
    back = open_dataset(path)
    np.testing.assert_allclose(back["t"].data, ds["t"].data)
    assert back["t"].attrs["units"] == "K"
    assert back["time"].attrs["units"].startswith("days since 1982-01-02")
    np.testing.assert_allclose(back["lev"].data, ds.coords["lev"].data)
    # The JAX package's copy reads the same file to the same values.
    jback = JDS.open_dataset(path)
    assert np.array_equal(jback["t"].data, back["t"].data)


def test_merge_time_series():
    merged = merge([_mk(1), _mk(2), _mk(3)])
    assert merged["t"].data.shape == (3, 3, 2, 4)
    np.testing.assert_allclose(merged["t"].data[1], _mk(2)["t"].data[0])


def test_merge_ens_preserves_descending_lev():
    # Member datasets carry a descending lev coordinate; merge must keep the
    # order and place member data on the right ens rows.
    m0, m1 = _mk(2, ens=0), _mk(2, ens=1)
    merged = merge([m0, m1])
    assert merged["t"].data.shape == (1, 2, 3, 2, 4)
    np.testing.assert_allclose(merged.coords["lev"].data,
                               np.array([0.9, 0.5, 0.1]))
    np.testing.assert_allclose(merged.sel(ens=1)["t"].data, m1["t"].data[:, 0])


def test_reindex_and_transpose():
    ds = _mk(2, lev_desc=False)
    rev = ds.reindex(lev=ds.coords["lev"].data[::-1])
    np.testing.assert_allclose(rev.coords["lev"].data,
                               np.array([0.9, 0.5, 0.1]))
    np.testing.assert_allclose(rev["t"].data[:, 0], ds["t"].data[:, 2])
    tr = rev.transpose("lev", "time", "lat", "lon")
    assert tr["t"].dims == ("lev", "time", "lat", "lon")


def test_squeeze_and_drop_vars():
    ds = _mk(2, ens=1)
    sq = ds.squeeze(dim="ens", drop=True)
    assert sq["t"].dims == ("time", "lev", "lat", "lon")
    assert "ens" not in sq.coords
    assert "t" not in ds.drop_vars("t").keys()


@pytest.mark.parametrize("which", ["bc", "sst_anomaly"])
def test_bundled_files_read_as_the_jax_package_reads_them(which):
    """The JAX package's example_bc.nc is NetCDF4 (h5py), sst_anomaly.nc
    NetCDF3 (scipy): every variable, its dims and attributes as the JAX
    package's copy reads them."""
    path = (str(JAX_PACKAGE_DATA_DIR / "example_bc.nc") if which == "bc"
            else example_sst_anomaly_file())
    with open(path, "rb") as f:
        magic = f.read(4)
    assert magic.startswith(b"\x89HDF" if which == "bc" else b"CDF")
    ours, theirs = open_dataset(path), JDS.open_dataset(path)
    assert set(ours.variables) == set(theirs.variables)
    for name, v in theirs.variables.items():
        assert ours[name].dims == v.dims, name
        assert np.array_equal(ours[name].data, v.data), name
        assert set(ours[name].attrs) == set(v.attrs), name
    assert ("orog" if which == "bc" else "ssta") in ours.keys()


def _same_values(x, y):
    if isinstance(x, str):
        return x == y
    x, y = np.asarray(x).ravel(), np.asarray(y).ravel()
    return (x.dtype.newbyteorder("=") == y.dtype.newbyteorder("=")
            and np.array_equal(x, y, equal_nan=x.dtype.kind == "f"))


def test_the_netcdf3_copy_holds_the_bundled_boundary_conditions(tmp_path):
    """example_bc_file() is the NetCDF3 copy of the JAX package's NetCDF4
    example_bc.nc: every variable with the same values, type and
    attributes, the coordinates as coordinates; and it is the file
    write_netcdf3 writes from the original, byte for byte."""
    assert example_bc_file() == str(BC_TARGET)
    with open(example_bc_file(), "rb") as f:
        assert f.read(3) == b"CDF"
    original = open_dataset(str(BC_SOURCE))
    copy = open_dataset(example_bc_file())
    assert set(copy.variables) == set(original.variables)
    assert set(copy.coords) == {"lon", "lat", "time"}
    for name, v in original.variables.items():
        w = copy[name]
        assert w.dims == (v.dims if name not in copy.coords else (name,))
        assert _same_values(w.data, v.data), name
        assert set(w.attrs) == set(v.attrs), name
        for key, val in v.attrs.items():
            assert _same_values(w.attrs[key], val), (name, key)
    again = tmp_path / "bc.nc"
    write_netcdf3(original, again)
    assert again.read_bytes() == BC_TARGET.read_bytes()


if __name__ == "__main__":
    write_netcdf3(open_dataset(str(BC_SOURCE)), BC_TARGET)
    print(f"wrote {BC_TARGET} from {BC_SOURCE}")
