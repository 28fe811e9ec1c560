from .core import MAX_CELL_EDGES, Mesh, build_mesh, load_mesh_npz, save_mesh_npz
from .generate import refine_uniform, structured_quad, structured_tri
from .gmsh import read_gmsh

__all__ = [
    "MAX_CELL_EDGES",
    "Mesh",
    "build_mesh",
    "load_mesh_npz",
    "read_gmsh",
    "refine_uniform",
    "save_mesh_npz",
    "structured_quad",
    "structured_tri",
]
