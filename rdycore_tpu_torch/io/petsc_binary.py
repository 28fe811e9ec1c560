"""PETSc binary Vec reader/writer.

The reference reads initial conditions, rainfall, boundary values and
elevations from PETSc binary Vec files (share/conditions/*.bin) via
VecLoad / RDyReadOneDOF*VecFromBinaryFile (src/rdydata.c). Format
(big-endian): per vector, [classid=1211214 (int), nrows (int), nrows f64
values]; ints are 4 bytes in int32 builds and 8 bytes in int64 builds
(both fixture flavors ship in share/). A file may contain several
concatenated vectors.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

VEC_FILE_CLASSID = 1211214
MAT_FILE_CLASSID = 1211216


def read_petsc_vecs(path: str) -> List[np.ndarray]:
    """Read all Vec records in a PETSc binary file (auto-detects int size)."""
    with open(path, "rb") as f:
        data = f.read()

    # detect int width from the first classid
    if len(data) >= 4 and struct.unpack(">i", data[:4])[0] == VEC_FILE_CLASSID:
        int_fmt, int_size = ">i", 4
    elif len(data) >= 8 and struct.unpack(">q", data[:8])[0] == VEC_FILE_CLASSID:
        int_fmt, int_size = ">q", 8
    else:
        raise ValueError(f"{path}: not a PETSc binary Vec file")

    vecs = []
    off = 0
    while off + 2 * int_size <= len(data):
        classid = struct.unpack(int_fmt, data[off : off + int_size])[0]
        if classid != VEC_FILE_CLASSID:
            break
        rows = struct.unpack(
            int_fmt, data[off + int_size : off + 2 * int_size]
        )[0]
        off += 2 * int_size
        vals = np.frombuffer(data[off : off + rows * 8], dtype=">f8").astype(
            np.float64
        )
        if len(vals) != rows:
            raise ValueError(f"{path}: truncated Vec record ({len(vals)}/{rows})")
        vecs.append(vals)
        off += rows * 8
    if not vecs:
        raise ValueError(f"{path}: no Vec records found")
    return vecs


def read_petsc_vec(path: str) -> np.ndarray:
    """Read the first Vec in a PETSc binary file."""
    return read_petsc_vecs(path)[0]


def write_petsc_vec(path: str, values: np.ndarray, int64: bool = False) -> None:
    """Write one Vec in PETSc binary format (for fixtures/round-trips)."""
    values = np.asarray(values, dtype=np.float64)
    int_fmt = ">q" if int64 else ">i"
    with open(path, "wb") as f:
        f.write(struct.pack(int_fmt, VEC_FILE_CLASSID))
        f.write(struct.pack(int_fmt, values.size))
        f.write(values.astype(">f8").tobytes())
