"""Gmsh 4.1 ASCII (.msh) reader.

The reference loads .msh files through DMPlex (`-dm_plex_filename`,
rdydm.c:82-110); physical surface groups become cell regions and physical
curve groups become boundary edge sets, which is how the reference maps
grid_region_id / grid_boundary_id (rdysetup.c:201-503).

The counterpart of the JAX package's mesh/gmsh.py for the subset RDycore
uses (2-D meshes of triangles and quads, physical names, format 4.x
ASCII), with the same Mesh. The small sections are read line by line; the
node and element sections, millions of lines at full size, are each
parsed by one numpy call and walked block by block as arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .core import Mesh, build_mesh

# nodes per element of each Gmsh element type (the Gmsh 4.1 format's
# table); the reader keeps 2-node lines, 3-node triangles and 4-node quads
# and skips the rest, whose lines it must still step over
_NODES_PER_ELEMENT = {
    1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5, 8: 3, 9: 6, 10: 9, 11: 10,
    12: 27, 13: 18, 14: 14, 15: 1, 16: 8, 17: 20, 18: 15, 19: 13, 20: 9,
    21: 10, 22: 12, 23: 15, 24: 15, 25: 21, 26: 4, 27: 5, 28: 6, 29: 20,
    30: 35, 31: 56,
}


def read_gmsh(path: str) -> Mesh:
    with open(path, "r") as f:
        text = f.read()
    sections = _split_sections(text)

    if "MeshFormat" not in sections:
        raise ValueError(f"{path}: not a Gmsh file")
    version = sections["MeshFormat"].split()[0]
    if not version.startswith("4"):
        raise ValueError(f"{path}: unsupported Gmsh format {version} (need 4.x)")

    # physical names: (dim, id) -> name
    phys_names: Dict[tuple, str] = {}
    if "PhysicalNames" in sections:
        lines = _lines(sections["PhysicalNames"])
        n = int(lines[0])
        for line in lines[1 : 1 + n]:
            parts = line.split(maxsplit=2)
            dim, tag = int(parts[0]), int(parts[1])
            name = parts[2].strip().strip('"')
            phys_names[(dim, tag)] = name

    # entities: (dim, entity_tag) -> [physical tags]
    entity_phys: Dict[tuple, list] = {}
    if "Entities" in sections:
        lines = _lines(sections["Entities"])
        counts = list(map(int, lines[0].split()))
        np_, nc, ns = counts[0], counts[1], counts[2]
        ln = 1
        for _ in range(np_):  # points: tag x y z numPhys phys...
            parts = lines[ln].split()
            ln += 1
            tag = int(parts[0])
            nphys = int(parts[4])
            entity_phys[(0, tag)] = [int(x) for x in parts[5 : 5 + nphys]]
        for dim, cnt in ((1, nc), (2, ns)):
            for _ in range(cnt):
                parts = lines[ln].split()
                ln += 1
                tag = int(parts[0])
                nphys = int(parts[7])
                entity_phys[(dim, tag)] = [int(x) for x in parts[8 : 8 + nphys]]

    # nodes: one float parse of the section; tags are exact in float64
    vals = _numbers(sections["Nodes"], np.float64)
    nblocks, max_tag = int(vals[0]), int(vals[3])
    coords = np.zeros((max_tag + 1, 3))
    seen = np.zeros(max_tag + 1, dtype=bool)
    p = 4
    for _ in range(nblocks):
        edim, parametric, nb = int(vals[p]), int(vals[p + 2]), int(vals[p + 3])
        p += 4
        tags = vals[p : p + nb].astype(np.int64)
        p += nb
        width = 3 + (edim if parametric and edim > 0 else 0)
        xyz = vals[p : p + nb * width].reshape(nb, width)[:, :3]
        p += nb * width
        coords[tags] = xyz
        seen[tags] = True
    tag_ids = np.nonzero(seen)[0]
    remap = -np.ones(max_tag + 1, dtype=np.int64)
    remap[tag_ids] = np.arange(len(tag_ids))
    points = coords[tag_ids]

    # elements: one integer parse of the section
    vals = _numbers(sections["Elements"], np.int64)
    nblocks = int(vals[0])
    p = 4
    cells = []  # [n, 4] vertex tags, -1 padded
    cell_entity = []
    seg_tags = []
    seg_nodes = []
    for _ in range(nblocks):
        edim, etag, etype, nb = (int(x) for x in vals[p : p + 4])
        p += 4
        if etype not in _NODES_PER_ELEMENT:
            raise ValueError(f"{path}: unknown Gmsh element type {etype}")
        width = 1 + _NODES_PER_ELEMENT[etype]
        nodes = vals[p : p + nb * width].reshape(nb, width)[:, 1:]
        p += nb * width
        if etype == 1 and edim == 1:  # 2-node line
            seg_tags.append(np.full(nb, etag, dtype=np.int64))
            seg_nodes.append(nodes)
        elif etype == 2 and edim == 2:  # 3-node triangle
            cells.append(np.concatenate(
                [nodes, -np.ones((nb, 1), np.int64)], axis=1))
            cell_entity.append(np.full(nb, etag, dtype=np.int64))
        elif etype == 3 and edim == 2:  # 4-node quad
            cells.append(nodes)
            cell_entity.append(np.full(nb, etag, dtype=np.int64))
        # points and higher-order elements are ignored

    cell_vertices = (np.concatenate(cells) if cells
                     else np.zeros((0, 4), np.int64))
    pad = cell_vertices < 0
    cell_vertices = np.where(pad, 0, remap[np.where(pad, 0, cell_vertices)])
    cell_vertices = np.where(pad, -1, cell_vertices).astype(np.int32)
    cell_entity = (np.concatenate(cell_entity) if cell_entity
                   else np.zeros(0, np.int64))

    # map surface entities -> physical region ids -> named regions
    regions: Dict[str, np.ndarray] = {}
    for ent in np.unique(cell_entity):
        for phys in entity_phys.get((2, int(ent)), []):
            name = phys_names.get((2, phys), f"region_{phys}")
            ids = np.nonzero(cell_entity == ent)[0].astype(np.int32)
            regions.setdefault(name, []).append(ids)  # type: ignore[arg-type]
            regions.setdefault(f"__id_{phys}", []).append(ids)  # type: ignore[arg-type]
    regions = {k: np.sort(np.concatenate(v)) for k, v in regions.items()}

    # boundary curves -> physical boundary sets (vertex pairs), in the
    # order the segments appear in the file
    boundary: Dict[str, list] = {}
    if seg_tags:
        seg_tag = np.concatenate(seg_tags)
        pairs = remap[np.concatenate(seg_nodes)[:, :2]]
        # curves in order of their first segment, as a walk over the
        # segments meets them; a set holds its curves' segments in file order
        first = np.unique(seg_tag, return_index=True)[1]
        for etag in seg_tag[np.sort(first)]:
            sel = np.nonzero(seg_tag == etag)[0]
            for phys in entity_phys.get((1, int(etag)), []):
                name = phys_names.get((1, phys), f"boundary_{phys}")
                for key in (name, f"__id_{phys}"):
                    boundary.setdefault(key, []).append(sel)
        boundary = {k: pairs[np.sort(np.concatenate(v))]
                    for k, v in boundary.items()}
    boundary = {k: np.asarray(v, dtype=np.int64) for k, v in boundary.items()}

    return build_mesh(points, cell_vertices, regions=regions, boundary_edges=boundary)


def _split_sections(text: str) -> Dict[str, str]:
    """The body of each `$Name` ... `$EndName` section, as text (a section
    starts at a line that starts with `$`)."""
    sections = {}
    pos = 0 if text.startswith("$") else text.find("\n$")
    while pos >= 0:
        start = text.index("$", pos)
        eol = text.find("\n", start)
        eol = len(text) if eol < 0 else eol
        name = text[start + 1 : eol].strip()
        if name and not name.startswith("End"):
            end = text.find(f"\n$End{name}", eol - 1)
            end = len(text) if end < 0 else end
            sections[name] = text[eol + 1 : end]
            eol = end + 1
        pos = text.find("\n$", eol - 1) if eol < len(text) else -1
    return sections


def _lines(body: str) -> list:
    return [line.strip() for line in body.splitlines() if line.strip()]


def _numbers(body: str, dtype) -> np.ndarray:
    """Every whitespace-separated number of a section, in one call."""
    return np.fromstring(body, dtype=dtype, sep=" ")
