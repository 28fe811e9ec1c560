"""The JAX package's public surface that rdycore_tpu_torch has not ported
yet (ROADMAP fault 20), checked on the CPU without a JAX compile: every
public member of the JAX Simulation exists on the port's, and each one the
port lacks raises NotImplementedError naming its ROADMAP item; every
option of the JAX CLI is accepted by the port's, and each one it lacks
exits with status 2 naming its item.
"""

import ast
import os

import numpy as np
import pytest

from rdycore_tpu_torch import Simulation
from rdycore_tpu_torch.__main__ import _NOT_PORTED_OPTIONS, main
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.mesh import structured_quad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ITEM_18 = "ROADMAP queue 1 item 18"
ITEM_5B = "ROADMAP queue 1 item 5b"
# member -> (how it is reached, the arguments of a call, its ROADMAP item)
NOT_PORTED = {
    "rebuild_on_mesh": ("method", (None,), "ROADMAP queue 1 item 14"),
    "write_checkpoint": ("method", ("x.h5",), ITEM_5B),
    "read_checkpoint": ("method", ("x.h5",), ITEM_5B),
    "restarted": ("property", (), ITEM_5B),
    "from_file": ("classmethod", ("deck.yaml",), ITEM_18),
    "set_momentum_source": ("method", (np.zeros(12),), ITEM_18),
    "set_regional_momentum_source": ("method", ("all", 0.0, 0.0), ITEM_18),
    "set_regional_manning_n": ("method", ("all", 0.02), ITEM_18),
    "boundary_names": ("property", (), ITEM_18),
    "get_num_boundary_conditions": ("method", (), ITEM_18),
    "get_boundary_id": ("method", ("left",), ITEM_18),
    "get_boundary_condition_flow_type": ("method", ("left",), ITEM_18),
    "get_boundary_edge_centers": ("method", ("left",), ITEM_18),
    "get_boundary_edge_centroids": ("method", ("left",), ITEM_18),
    "get_boundary_cells": ("method", ("left",), ITEM_18),
    "get_boundary_cell_centroids": ("method", ("left",), ITEM_18),
    "get_boundary_cell_natural_ids": ("method", ("left",), ITEM_18),
    "get_num_global_cells": ("method", (), ITEM_18),
    "convert_time": ("staticmethod", (1.0, "seconds", "hours"), ITEM_18),
    "get_time_unit": ("method", (), ITEM_18),
    "get_version": ("method", (), ITEM_18),
    "set_log_file": ("method", ("log.txt",), ITEM_18),
    "get_build_configuration": ("method", (), ITEM_18),
    "create_prognostic_array": ("method", (), ITEM_18),
    "create_one_dof_array": ("method", (), ITEM_18),
    "read_one_dof_vec_from_binary": ("method", ("v.bin",), ITEM_18),
    "write_one_dof_vec_to_binary": ("method", ("v.bin", np.zeros(12)),
                                    ITEM_18),
}


def public_members(path):
    """The public names a class Simulation defines in the source at path
    (methods, properties and members assigned in its body)."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    cls = next(n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef) and n.name == "Simulation")
    names = set()
    for node in cls.body:
        if isinstance(node, ast.FunctionDef):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.fixture(scope="module")
def sim():
    cfg = config_from_dict({"time": {"stop": 0.01, "time_step": 0.001},
                            "logging": {"level": "none"}}).validate()
    return Simulation(cfg, mesh=structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0),
                      device="cpu")


def test_every_public_member_of_the_jax_simulation_exists(sim):
    jax_names = public_members("rdycore_tpu/simulation.py")
    missing = {n for n in jax_names - public_members(
        "rdycore_tpu_torch/simulation.py")}
    # the JAX package's state property q is the port's state attribute
    assert missing == {"q"} and sim.q.shape == (3, 12)
    assert jax_names - {"q"} >= set(NOT_PORTED)


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_unported_members_raise_naming_their_item(sim, name):
    kind, args, item = NOT_PORTED[name]
    with pytest.raises(NotImplementedError, match=item):
        if kind == "property":
            getattr(sim, name)
        elif kind in ("classmethod", "staticmethod"):
            getattr(Simulation, name)(*args)
        else:
            getattr(sim, name)(*args)


@pytest.mark.parametrize("argv, item", [
    (["--mms"], "item 8"),
    (["--constant-rain-rate", "1e-6"], "item 5d"),
    (["--homogeneous-rain-file", "rain.bin"], "item 5d"),
    (["--temporally-interpolate-rain"], "item 5d"),
    (["--raster-rain-dir", "rain/"], "item 5d"),
    (["--homogeneous-bc-file", "right=bc.bin"], "item 5d"),
    (["--amr-dataset-dir", "amr/"], "item 14"),
    (["--amr-area-threshold", "0.2"], "item 14"),
    (["--pause"], "item 18"),
])
def test_unported_cli_options_exit_naming_their_item(argv, item, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["deck.yaml", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{argv[0]} is not ported" in err and f"ROADMAP queue 1 {item}" in err


def cli_options(path):
    """The --options a CLI source at path adds to its parser."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    return {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
            == "add_argument" and n.args and isinstance(n.args[0], ast.Constant)
            and n.args[0].value.startswith("--")}


def test_every_jax_cli_option_is_accepted():
    port = cli_options("rdycore_tpu_torch/__main__.py") | {
        opt for opt, _, _ in _NOT_PORTED_OPTIONS}
    assert cli_options("rdycore_tpu/__main__.py") <= port
