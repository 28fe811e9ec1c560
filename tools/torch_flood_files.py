#!/usr/bin/env python3
"""The files of a flood deck for rdycore_tpu_torch: mesh files in Exodus II
(NetCDF classic, CDF-2) and Gmsh 4.1 ASCII, hourly rain rasters and a
stage series in PETSc binary, and the YAML deck that names them.

    python3 tools/torch_flood_files.py OUTDIR [--nx 1448] [--ny 996]
                                       [--seed 0] [--dt 0.25] [--stop 3720]

writes into OUTDIR valley.exo, valley.msh, rain/<date>:<HH>-00.int32.bin
(two hours), stage.bin and flood.yaml, and prints the command lines that
run the deck. The valley is 20.48 km x 14.08 km of `structured_tri(nx,
ny)` (2,884,416 triangles of legs about 14.1 m at the default size): a bed
falling 2.048 m towards the outlet at x = 20.48 km and rising 5 m to each
side, with a parabolic channel 2 m deep and 600 m wide along its axis.
The mesh has two element blocks (1 channel, 2 floodplain) and four side
sets (1 upstream wall at x = 0, 2 side walls at y = 0 and y = 14.08 km,
3 downstream wall at x = 20.48 km beside the channel, 4 the outlet across
the channel there). Cells (within each block) and vertices are written in
an order shuffled from `--seed`: a worst case for locality, not the order
a mesher writes.

The writers (`write_netcdf3`, `write_exodus`, `write_gmsh`,
`write_raster`) are test tools for decks and fixtures, not API of the
port.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import struct
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the valley
LX, LY = 20480.0, 14080.0
SLOPE = 1e-4  # along x, falling towards the outlet
BANK_RISE = 5.0  # from the axis to each side wall
CHANNEL_DEPTH, CHANNEL_WIDTH = 2.0, 600.0
H_CHANNEL = 1.0  # initial depth in the channel block [m]
# rain: two hourly rasters of 1 km cells, rates in m/s growing along x
# (hour 0: 50-100 mm/h; hour 1: 20-40 mm/h), and the outlet's depth series
RAIN_CELL = 1024.0
RAIN_MM_PER_H = (100.0, 40.0)
STAGE = ((0.0, 0.8), (1800.0, 0.9), (3600.0, 1.0))
START_DATE = (2017, 8, 26)  # the JAX CLI's default for raster rain

_NC_TYPES = {np.dtype("int8"): 1, np.dtype("S1"): 2, np.dtype("int16"): 3,
             np.dtype("int32"): 4, np.dtype("float32"): 5,
             np.dtype("float64"): 6}


def write_netcdf3(path: str, dims: Sequence[Tuple[str, int]],
                  variables: Sequence[tuple], attrs: Optional[dict] = None,
                  version: int = 2) -> None:
    """A NetCDF classic file: CDF-1 (version 1, 32-bit offsets) or CDF-2
    (version 2, 64-bit offsets). dims: (name, length), length 0 for the
    record dimension. variables: (name, dim names, array[, attrs]); a
    record variable's first dimension is the record dimension and its
    array's first axis the records. Arrays are int8, S1 (characters),
    int16, int32, float32 or float64."""
    dim_ids = {name: i for i, (name, _) in enumerate(dims)}
    rec_dim = next((name for name, n in dims if n == 0), None)
    numrecs = 0
    vars_ = []
    for v in variables:
        name, vdims, arr = v[0], tuple(v[1]), np.asarray(v[2])
        vattrs = v[3] if len(v) > 3 else {}
        if arr.dtype not in _NC_TYPES:
            arr = arr.astype({"i": np.int32, "u": np.int32,
                              "f": np.float64}[arr.dtype.kind])
        is_rec = bool(vdims) and vdims[0] == rec_dim
        if is_rec:
            numrecs = max(numrecs, arr.shape[0])
        vars_.append((name, vdims, arr, vattrs, is_rec))
    n_rec_vars = sum(v[4] for v in vars_)

    def padded(n):
        return n + (-n % 4)

    def name_bytes(s):
        b = s.encode()
        return struct.pack(">I", len(b)) + b + b"\0" * (-len(b) % 4)

    def attr_bytes(a):
        if not a:
            return struct.pack(">II", 0, 0)
        out = struct.pack(">II", 0x0C, len(a))
        for k, val in a.items():
            if isinstance(val, str):
                raw, typ, n = val.encode(), 2, len(val.encode())
            else:
                arr = np.atleast_1d(np.asarray(val))
                typ, n = _NC_TYPES[arr.dtype], arr.size
                raw = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
            out += name_bytes(k) + struct.pack(">II", typ, n) + raw
            out += b"\0" * (-len(raw) % 4)
        return out

    def slab(arr, is_rec):
        per = int(np.prod(arr.shape[1:] if is_rec else arr.shape))
        n = per * arr.dtype.itemsize
        return n if (is_rec and n_rec_vars == 1) else padded(n)

    def header(begins):
        out = b"CDF" + bytes([version]) + struct.pack(">I", numrecs)
        if dims:
            out += struct.pack(">II", 0x0A, len(dims))
            for name, n in dims:
                out += name_bytes(name) + struct.pack(">I", n)
        else:
            out += struct.pack(">II", 0, 0)
        out += attr_bytes(attrs)
        if not vars_:
            return out + struct.pack(">II", 0, 0)
        out += struct.pack(">II", 0x0B, len(vars_))
        for (name, vdims, arr, vattrs, is_rec), begin in zip(vars_, begins):
            out += name_bytes(name) + struct.pack(">I", len(vdims))
            out += b"".join(struct.pack(">I", dim_ids[d]) for d in vdims)
            out += attr_bytes(vattrs)
            out += struct.pack(">II", _NC_TYPES[arr.dtype],
                               slab(arr, is_rec))
            out += struct.pack(">Q" if version == 2 else ">I", begin)
        return out

    off = len(header([0] * len(vars_)))
    begins = []
    for _, _, arr, _, is_rec in vars_:
        if not is_rec:
            begins.append(off)
            off += slab(arr, False)
        else:
            begins.append(None)
    recsize = 0
    for i, (_, _, arr, _, is_rec) in enumerate(vars_):
        if is_rec:
            begins[i] = off + recsize
            recsize += slab(arr, True)
    with open(path, "wb") as f:
        f.write(header(begins))
        for _, _, arr, _, is_rec in vars_:
            if not is_rec:
                raw = _big_endian(arr).tobytes()
                f.write(raw + b"\0" * (-len(raw) % 4))
        for r in range(numrecs):
            for _, _, arr, _, is_rec in vars_:
                if is_rec:
                    raw = _big_endian(arr[r : r + 1]).tobytes()
                    f.write(raw + b"\0" * (slab(arr, True) - len(raw)))


def _big_endian(arr):
    arr = np.asarray(arr)
    return np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">")))


@dataclasses.dataclass
class SideSet:
    """Cells and their local sides (side k joins vertices k and k + 1 of
    the cell); written with the planar side numbering (k + 1) or, with
    `shell`, the shell one (k + 3)."""

    id: int
    name: str
    cells: np.ndarray
    sides: np.ndarray
    shell: bool = False


@dataclasses.dataclass
class MeshFile:
    """What a mesh file holds: vertices [NV, 3], cells [C, 4] (0-based, -1
    padded), each cell's element block id (blocks contiguous in cell order,
    each of one cell type), the blocks' names ("" for none) and the side
    sets."""

    points: np.ndarray
    cells: np.ndarray
    cell_block: np.ndarray
    block_names: Dict[int, str]
    side_sets: List[SideSet]

    def blocks(self):
        """(block id, first cell, count, vertices per cell) in cell order,
        one entry per run of one block and one cell type."""
        nv = (self.cells >= 0).sum(axis=1)
        key = self.cell_block.astype(np.int64) * 8 + nv
        starts = np.concatenate([[0], np.nonzero(np.diff(key))[0] + 1])
        ends = np.concatenate([starts[1:], [len(key)]])
        return [(int(self.cell_block[s]), int(s), int(e - s), int(nv[s]))
                for s, e in zip(starts, ends)]

    def side_pairs(self, ss: SideSet) -> np.ndarray:
        """The vertex pairs [n, 2] of a side set's sides."""
        nv = (self.cells[ss.cells] >= 0).sum(axis=1)
        a = self.cells[ss.cells, ss.sides]
        b = self.cells[ss.cells, (ss.sides + 1) % nv]
        return np.stack([a, b], axis=1)


def _char_rows(names: Sequence[str], width: int = 33) -> np.ndarray:
    out = np.zeros((len(names), width), dtype="S1")
    for i, name in enumerate(names):
        raw = name.encode()[: width - 1]
        out[i, : len(raw)] = np.frombuffer(raw, dtype="S1")
    return out


def write_exodus(path: str, mf: MeshFile, version: int = 2) -> None:
    """An Exodus II file of mf: one element block per block id (of one
    cell type), coordx/coordy/coordz, eb_prop1/eb_names, and a side set of
    each SideSet (elem_ss, side_ss, ss_prop1/ss_names)."""
    blocks = mf.blocks()
    ids = [b[0] for b in blocks]
    if len(set(ids)) != len(ids):
        raise ValueError("an Exodus block holds one contiguous run of one "
                         "cell type")
    dims = [("len_name", 33), ("num_dim", 3),
            ("num_nodes", len(mf.points)), ("num_elem", len(mf.cells)),
            ("num_el_blk", len(blocks)), ("time_step", 0)]
    variables = [("time_whole", ("time_step",), np.zeros(0, np.float64))]
    for axis, name in enumerate(("coordx", "coordy", "coordz")):
        variables.append((name, ("num_nodes",),
                          np.ascontiguousarray(mf.points[:, axis],
                                               dtype=np.float64)))
    variables.append(("eb_prop1", ("num_el_blk",),
                      np.asarray(ids, np.int32), {"name": "ID"}))
    variables.append(("eb_names", ("num_el_blk", "len_name"),
                      _char_rows([mf.block_names.get(i, "") for i in ids])))
    for b, (_, start, count, npe) in enumerate(blocks, start=1):
        dims += [(f"num_el_in_blk{b}", count), (f"num_nod_per_el{b}", npe)]
        conn = mf.cells[start : start + count, :npe].astype(np.int32) + 1
        variables.append((f"connect{b}", (f"num_el_in_blk{b}",
                                          f"num_nod_per_el{b}"), conn,
                          {"elem_type": "TRI3" if npe == 3 else "QUAD4"}))
    if mf.side_sets:
        dims.append(("num_side_sets", len(mf.side_sets)))
        variables.append(("ss_prop1", ("num_side_sets",),
                          np.asarray([s.id for s in mf.side_sets], np.int32),
                          {"name": "ID"}))
        variables.append(("ss_names", ("num_side_sets", "len_name"),
                          _char_rows([s.name for s in mf.side_sets])))
        for k, ss in enumerate(mf.side_sets, start=1):
            dims.append((f"num_side_ss{k}", len(ss.cells)))
            variables.append((f"elem_ss{k}", (f"num_side_ss{k}",),
                              np.asarray(ss.cells, np.int32) + 1))
            variables.append((f"side_ss{k}", (f"num_side_ss{k}",),
                              np.asarray(ss.sides, np.int32)
                              + (3 if ss.shell else 1)))
    write_netcdf3(path, dims, variables,
                  {"api_version": np.float32(8.0), "version":
                   np.float32(8.0), "floating_point_word_size":
                   np.int32(8), "file_size": np.int32(1),
                   "title": "rdycore_tpu_torch flood deck"}, version)


def _rows(fmt: str, arr: np.ndarray) -> str:
    """Each row of arr through fmt, one line each, in one % operation."""
    if not len(arr):
        return ""
    return ((fmt + "\n") * len(arr)) % tuple(arr.ravel().tolist())


def write_gmsh(path: str, mf: MeshFile,
               node_tags: Optional[np.ndarray] = None) -> None:
    """A Gmsh 4.1 ASCII file of mf: a physical surface (one entity) per
    block, a physical curve (one entity, 2-node lines) per side set,
    `$PhysicalNames` for the named ones, one node block (tags node_tags,
    default 1..NV; coordinates with 17 significant digits, exact)."""
    nvt = len(mf.points)
    tags = (np.arange(1, nvt + 1) if node_tags is None
            else np.asarray(node_tags, np.int64))
    blocks = mf.blocks()
    block_ids = sorted(set(b[0] for b in blocks))
    named = [(2, i, mf.block_names[i]) for i in block_ids
             if mf.block_names.get(i)]
    named += [(1, s.id, s.name) for s in mf.side_sets if s.name]
    out = ["$MeshFormat\n4.1 0 8\n$EndMeshFormat\n"]
    if named:
        out.append(f"$PhysicalNames\n{len(named)}\n")
        out += [f'{d} {t} "{n}"\n' for d, t, n in named]
        out.append("$EndPhysicalNames\n")
    out.append(f"$Entities\n0 {len(mf.side_sets)} {len(block_ids)} 0\n")
    out += [f"{s.id} 0 0 0 0 0 0 1 {s.id} 0\n" for s in mf.side_sets]
    out += [f"{i} 0 0 0 0 0 0 1 {i} 0\n" for i in block_ids]
    out.append("$EndEntities\n")
    out.append(f"$Nodes\n1 {nvt} {tags.min()} {tags.max()}\n2 "
               f"{block_ids[0]} 0 {nvt}\n")
    out.append(_rows("%d", tags[:, None]))
    out.append(_rows("%.17g %.17g %.17g", mf.points))
    out.append("$EndNodes\n")
    elems = []
    tag = 1
    for ss in mf.side_sets:
        pairs = tags[mf.side_pairs(ss)]
        elems.append((1, ss.id, 1, np.concatenate(
            [np.arange(tag, tag + len(pairs))[:, None], pairs], axis=1)))
        tag += len(pairs)
    for bid, start, count, npe in blocks:
        conn = tags[mf.cells[start : start + count, :npe]]
        elems.append((2, bid, 2 if npe == 3 else 3, np.concatenate(
            [np.arange(tag, tag + count)[:, None], conn], axis=1)))
        tag += count
    out.append(f"$Elements\n{len(elems)} {tag - 1} 1 {tag - 1}\n")
    for dim, etag, etype, rows in elems:
        out.append(f"{dim} {etag} {etype} {len(rows)}\n")
        out.append(_rows(" ".join(["%d"] * rows.shape[1]), rows))
    out.append("$EndElements\n")
    with open(path, "w") as f:
        f.write("".join(out))


def write_raster(path: str, values: np.ndarray, xlc: float, ylc: float,
                 cellsize: float, int64: bool = False) -> None:
    """A raster dataset in PETSc binary: [ncols, nrows, xlc, ylc, cellsize]
    then the values [nrows, ncols] row by row (rdyforcing_dataset.c)."""
    from rdycore_tpu_torch.io.petsc_binary import write_petsc_vec

    nrows, ncols = values.shape
    write_petsc_vec(path, np.concatenate(
        [[ncols, nrows, xlc, ylc, cellsize], np.ravel(values)]), int64=int64)


# ------------------------------------------------------------ the valley
def valley_bed(x, y):
    """Vertex bed elevation [m] of the valley."""
    r = np.abs(y - LY / 2) / (CHANNEL_WIDTH / 2)
    channel = CHANNEL_DEPTH * np.maximum(0.0, 1.0 - r * r)
    return SLOPE * (LX - x) + BANK_RISE * np.abs(y - LY / 2) / (LY / 2) \
        - channel


def valley_mesh(nx: int = 1448, ny: int = 996):
    """The valley as generated, in the generator's order: `structured_tri`
    with the bed on its vertices."""
    from rdycore_tpu_torch.mesh import structured_tri

    return structured_tri(nx, ny, 0.0, LX, 0.0, LY, z_fn=valley_bed)


def valley_file(mesh, seed: int = 0):
    """(MeshFile, cperm, vperm) of the generated valley with its cells
    (channel block first, each block shuffled) and vertices shuffled from
    seed: file cell i is generated cell cperm[i], file vertex j generated
    vertex vperm[j]."""
    rng = np.random.default_rng(seed)
    in_channel = (np.abs(mesh.cell_centroid[:, 1] - LY / 2)
                  < CHANNEL_WIDTH / 2)
    cperm = np.concatenate([rng.permutation(np.nonzero(in_channel)[0]),
                            rng.permutation(np.nonzero(~in_channel)[0])])
    vperm = rng.permutation(mesh.num_vertices)
    vinv = np.empty_like(vperm)
    vinv[vperm] = np.arange(len(vperm))
    cinv = np.empty_like(cperm)
    cinv[cperm] = np.arange(len(cperm))
    cv = mesh.cell_vertices[cperm]
    cells = np.where(cv >= 0, vinv[np.maximum(cv, 0)], -1)
    cell_block = np.where(in_channel[cperm], 1, 2)

    # boundary edges -> side sets by their midpoints
    Ei = mesh.num_internal_edges
    eb = np.arange(Ei, mesh.num_edges)
    left = mesh.edge_cells[eb, 0]
    side = np.argmax(mesh.cell_edges[left] == eb[:, None], axis=1)
    mid = mesh.points[mesh.edge_vertices[eb], :2].mean(axis=1)
    tol = 1e-6 * LX
    at_outlet_x = np.abs(mid[:, 0] - LX) < tol
    across = np.abs(mid[:, 1] - LY / 2) < CHANNEL_WIDTH / 2
    which = np.select(
        [np.abs(mid[:, 0]) < tol,
         (np.abs(mid[:, 1]) < tol) | (np.abs(mid[:, 1] - LY) < tol),
         at_outlet_x & ~across, at_outlet_x & across], [1, 2, 3, 4], 0)
    if (which == 0).any():
        raise ValueError("a boundary edge lies on no wall")
    names = {1: "upstream", 2: "sides", 3: "downstream", 4: "outlet"}
    side_sets = []
    for sid in (1, 2, 3, 4):
        sel = np.nonzero(which == sid)[0]
        side_sets.append(SideSet(sid, names[sid], cinv[left[sel]],
                                 side[sel]))
    mf = MeshFile(mesh.points[vperm], cells.astype(np.int32), cell_block,
                  {1: "channel", 2: "floodplain"}, side_sets)
    return mf, cperm, vperm


def generated_with_labels(out: dict):
    """The generated valley of `write_flood_files`' result, in the
    generator's order, with the file's element blocks as regions
    (`__id_<block>`) and side sets as boundaries (`__id_<set>`): the same
    deck in the order the generator numbers cells."""
    from rdycore_tpu_torch.mesh import build_mesh

    mesh, mf, cperm, vperm = (out[k] for k in ("mesh", "file", "cperm",
                                                "vperm"))
    regions = {f"__id_{b}": np.sort(cperm[mf.cell_block == b]).astype(
        np.int32) for b in np.unique(mf.cell_block)}
    boundary = {f"__id_{ss.id}": vperm[mf.side_pairs(ss)]
                for ss in mf.side_sets}
    return build_mesh(mesh.points, mesh.cell_vertices, regions=regions,
                      boundary_edges=boundary)


def rain_rasters() -> List[np.ndarray]:
    """The two hourly rain rasters [nrows, ncols] in m/s over 1 km cells
    (cell centres from 512 m)."""
    ncols, nrows = int(LX // RAIN_CELL), int(LY // RAIN_CELL) + 1
    ramp = 0.5 + 0.5 * np.arange(ncols) / (ncols - 1)
    return [np.tile(mm / 1000.0 / 3600.0 * ramp, (nrows, 1))
            for mm in RAIN_MM_PER_H]


def flood_deck(mesh_file: str, dt: float, stop: float, interval: float,
               ordering: str = "file", series: int = 0) -> dict:
    """The flood deck as a config dictionary: f32, euler, the channel
    block wet (H_CHANNEL), the floodplain dry, Manning 0.03 / 0.06,
    reflecting walls and a Dirichlet depth at the outlet (the stage
    series' first value, replaced through --homogeneous-bc-file)."""
    deck = {
        "physics": {"flow": {"mode": "swe"}},
        "numerics": {"spatial": "fv", "temporal": "euler", "riemann": "roe",
                     "precision": "single", "cell_ordering": ordering},
        "logging": {"level": "none"},
        "time": {"stop": stop, "unit": "seconds", "time_step": dt,
                 "coupling_interval": interval},
        "grid": {"file": mesh_file},
        "output": {"format": "none"},
        "regions": [{"name": "channel", "grid_region_id": 1},
                    {"name": "floodplain", "grid_region_id": 2}],
        "surface_composition": [
            {"region": "channel", "material": "river"},
            {"region": "floodplain", "material": "field"}],
        "materials": [
            {"name": "river", "properties": {"manning": {"value": 0.03}}},
            {"name": "field", "properties": {"manning": {"value": 0.06}}}],
        "initial_conditions": [{"region": "channel", "flow": "river"},
                               {"region": "floodplain", "flow": "dry"}],
        "boundaries": [{"name": n, "grid_boundary_id": i} for i, n in
                       ((1, "upstream"), (2, "sides"), (3, "downstream"),
                        (4, "outlet"))],
        "boundary_conditions": [{"boundaries": ["outlet"],
                                 "flow": "stage"}],
        "flow_conditions": [
            {"name": "river", "type": "dirichlet", "height": H_CHANNEL,
             "x_momentum": 0, "y_momentum": 0},
            {"name": "dry", "type": "dirichlet", "height": 0.0,
             "x_momentum": 0, "y_momentum": 0},
            {"name": "stage", "type": "dirichlet", "height": STAGE[0][1],
             "x_momentum": 0, "y_momentum": 0}],
    }
    if series:
        deck["output"]["time_series"] = {"boundary_fluxes": series}
    return deck


def write_flood_files(outdir: str, nx: int = 1448, ny: int = 996,
                      seed: int = 0, gmsh: bool = True, mesh=None) -> dict:
    """Write the valley's mesh files, rain rasters and stage series into
    outdir; returns their paths, the generated mesh and the shuffles."""
    import datetime

    from rdycore_tpu_torch.forcing import dataset_filename
    from rdycore_tpu_torch.io.petsc_binary import write_petsc_vec

    os.makedirs(os.path.join(outdir, "rain"), exist_ok=True)
    mesh = valley_mesh(nx, ny) if mesh is None else mesh
    mf, cperm, vperm = valley_file(mesh, seed)
    paths = {"exodus": os.path.join(outdir, "valley.exo"),
             "rain": os.path.join(outdir, "rain"),
             "stage": os.path.join(outdir, "stage.bin")}
    write_exodus(paths["exodus"], mf)
    if gmsh:
        paths["gmsh"] = os.path.join(outdir, "valley.msh")
        write_gmsh(paths["gmsh"], mf)
    start = datetime.datetime(*START_DATE)
    for hour, values in enumerate(rain_rasters()):
        write_raster(dataset_filename(paths["rain"], start + datetime.
                                      timedelta(hours=hour)),
                     values, RAIN_CELL / 2, RAIN_CELL / 2, RAIN_CELL)
    write_petsc_vec(paths["stage"], np.ravel(STAGE))
    return {"paths": paths, "mesh": mesh, "file": mf, "cperm": cperm,
            "vperm": vperm}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--nx", type=int, default=1448)
    ap.add_argument("--ny", type=int, default=996)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dt", type=float, default=0.25)
    ap.add_argument("--stop", type=float, default=3720.0)
    args = ap.parse_args(argv)

    import yaml

    out = write_flood_files(args.outdir, args.nx, args.ny, args.seed)
    deck = flood_deck("valley.exo", args.dt, args.stop, 120.0, "rcm",
                      series=int(round(120.0 / args.dt)))
    path = os.path.join(args.outdir, "flood.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(deck, f, sort_keys=False)
    print(f"{out['mesh'].num_cells} cells; run it with\n"
          f"  python -m rdycore_tpu_torch {path} [--cpu] --raster-rain-dir "
          f"{out['paths']['rain']} --homogeneous-bc-file outlet=stage.bin")
    return 0


if __name__ == "__main__":
    sys.exit(main())
