"""Minimal NetCDF classic (CDF-1/CDF-2) reader, record variables included.

Exodus II mesh files are NetCDF classic files; the reference reads them
through PETSc's ExodusII support. netCDF4 is not a dependency, so the
classic format (a simple big-endian TLV layout) is parsed directly, each
variable with one `np.frombuffer`. The counterpart of the JAX package's
io/netcdf3.py, with the same results.
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

_NC_BYTE = 1
_NC_CHAR = 2
_NC_SHORT = 3
_NC_INT = 4
_NC_FLOAT = 5
_NC_DOUBLE = 6

_DTYPE = {
    _NC_BYTE: np.dtype(">i1"),
    _NC_CHAR: np.dtype("S1"),
    _NC_SHORT: np.dtype(">i2"),
    _NC_INT: np.dtype(">i4"),
    _NC_FLOAT: np.dtype(">f4"),
    _NC_DOUBLE: np.dtype(">f8"),
}

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C


class NcVar(NamedTuple):
    name: str
    dims: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: np.dtype
    attrs: Dict[str, object]
    begin: int
    vsize: int
    is_record: bool


class NetCDF3File:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._data = f.read()
        magic = self._data[:4]
        if magic[:3] != b"CDF" or magic[3] not in (1, 2):
            raise ValueError(f"{path}: not a NetCDF classic file")
        self._offsize = 8 if magic[3] == 2 else 4
        self._pos = 4
        self.numrecs = self._u32()
        self.dims: List[Tuple[str, int]] = []
        self.attrs: Dict[str, object] = {}
        self.variables: Dict[str, NcVar] = {}
        self._parse_dims()
        self.attrs = self._parse_attrs()
        self._parse_vars()

    # ---- low-level readers ----
    def _u32(self) -> int:
        v = struct.unpack(">I", self._data[self._pos : self._pos + 4])[0]
        self._pos += 4
        return v

    def _u64(self) -> int:
        v = struct.unpack(">Q", self._data[self._pos : self._pos + 8])[0]
        self._pos += 8
        return v

    def _offset(self) -> int:
        return self._u64() if self._offsize == 8 else self._u32()

    def _name(self) -> str:
        n = self._u32()
        s = self._data[self._pos : self._pos + n].decode("utf-8")
        self._pos += n + ((4 - n % 4) % 4)  # padded to 4 bytes
        return s

    # ---- header sections ----
    def _parse_dims(self):
        tag = self._u32()
        n = self._u32()
        if tag == 0 and n == 0:
            return
        if tag != _NC_DIMENSION:
            raise ValueError("bad dim_list tag")
        for _ in range(n):
            name = self._name()
            length = self._u32()
            self.dims.append((name, length))

    def _parse_attrs(self) -> Dict[str, object]:
        tag = self._u32()
        n = self._u32()
        attrs: Dict[str, object] = {}
        if tag == 0 and n == 0:
            return attrs
        if tag != _NC_ATTRIBUTE:
            raise ValueError("bad att_list tag")
        for _ in range(n):
            name = self._name()
            nc_type = self._u32()
            nelems = self._u32()
            dt = _DTYPE[nc_type]
            nbytes = nelems * dt.itemsize
            raw = self._data[self._pos : self._pos + nbytes]
            self._pos += nbytes + ((4 - nbytes % 4) % 4)
            if nc_type == _NC_CHAR:
                attrs[name] = raw.decode("utf-8", "replace").rstrip("\x00")
            else:
                attrs[name] = np.frombuffer(raw, dtype=dt)
        return attrs

    def _parse_vars(self):
        tag = self._u32()
        n = self._u32()
        if tag == 0 and n == 0:
            return
        if tag != _NC_VARIABLE:
            raise ValueError("bad var_list tag")
        for _ in range(n):
            name = self._name()
            ndims = self._u32()
            dimids = [self._u32() for _ in range(ndims)]
            attrs = self._parse_attrs()
            nc_type = self._u32()
            vsize = self._u32()
            begin = self._offset()
            dim_names = tuple(self.dims[d][0] for d in dimids)
            shape = tuple(self.dims[d][1] for d in dimids)
            is_record = bool(ndims) and self.dims[dimids[0]][1] == 0 and (
                self.dims[dimids[0]][0] == "time_step"
                or self.dims[dimids[0]][1] == 0
            )
            self.variables[name] = NcVar(
                name, dim_names, shape, _DTYPE[nc_type], attrs, begin, vsize,
                is_record,
            )

    # ---- data access ----
    def read(self, name: str) -> np.ndarray:
        v = self.variables[name]
        shape = list(v.shape)
        if v.is_record:
            shape[0] = self.numrecs
            rec_vars = [x for x in self.variables.values() if x.is_record]
            if len(rec_vars) > 1:
                # records are interleaved: one record = the concatenation
                # of every record variable's per-record slab, each padded
                # to 4 bytes (the header vsize is that padded size); with
                # a single record variable there is no padding and the
                # fast contiguous path below applies
                recsize = sum(x.vsize for x in rec_vars)
                per_rec = int(np.prod(shape[1:])) if len(shape) > 1 else 1
                nbytes = per_rec * v.dtype.itemsize
                chunks = [
                    self._data[
                        v.begin + r * recsize : v.begin + r * recsize + nbytes
                    ]
                    for r in range(self.numrecs)
                ]
                arr = np.frombuffer(b"".join(chunks), dtype=v.dtype).reshape(
                    shape
                )
                if v.dtype.kind == "S":
                    return arr
                return arr.astype(arr.dtype.newbyteorder("="))
        count = int(np.prod(shape)) if shape else 1
        raw = self._data[v.begin : v.begin + count * v.dtype.itemsize]
        arr = np.frombuffer(raw, dtype=v.dtype).reshape(shape)
        if v.dtype.kind == "S":
            return arr
        return arr.astype(arr.dtype.newbyteorder("="))
