"""The JAX package's public surface on rdycore_tpu_torch (ROADMAP fault
20), checked on the CPU without a JAX compile: every public member of the
JAX Simulation exists on the port's, and the last one ported
(`rebuild_on_mesh`, with AMR, item 14) runs; every option of the JAX CLI
is accepted by the port's, the AMR options (the last ported, item 14) and
the forcing options run. The members the port has are held against the
JAX package's in tests/test_torch_coupling_surface.py, AMR in
tests/test_torch_amr*.py.
"""

import ast
import os

import numpy as np
import pytest

from rdycore_tpu_torch import Simulation
from rdycore_tpu_torch.__main__ import main
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.io.petsc_binary import read_petsc_vec
from rdycore_tpu_torch.mesh import refine_uniform, structured_quad
from tests.test_torch_forcing import box
from tests.test_torch_forcing_cli import write_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the member ported last, with the ROADMAP item that ported it: until then
# it raised NotImplementedError naming that item
PORTED_LAST = {"rebuild_on_mesh": "item 14"}


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
    # q is a property in both packages (the port's gathers the state
    # from its shards or rank strips, ROADMAP item 16)
    assert missing == set() and sim.q.shape == (3, 12)
    assert jax_names - {"q"} >= set(PORTED_LAST)


@pytest.mark.parametrize("name", sorted(PORTED_LAST))
def test_unported_members_raise_naming_their_item(name):
    """No member raises naming its item any more: rebuild_on_mesh builds
    the simulation anew on another mesh, keeping the time state."""
    cfg = config_from_dict({"time": {"stop": 0.01, "time_step": 0.001},
                            "logging": {"level": "none"}}).validate()
    sim = Simulation(cfg, mesh=structured_quad(4, 3, 0.0, 1.0, 0.0, 1.0),
                     device="cpu")
    sim.advance()
    t, step = sim.t, sim.step
    getattr(sim, name)(refine_uniform(sim.mesh), np.full(48, 0.02))
    assert sim.num_cells == 48 and sim.q.shape == (3, 48)
    assert (sim.t, sim.step) == (t, step)
    assert np.array_equal(sim.get_manning_n(), np.full(48, 0.02))


@pytest.mark.parametrize("argv, item", [
    (["--amr-dataset-dir", "{tmp}/amr"], "item 14"),
    (["--amr-area-threshold", "0.2"], "item 14"),
])
def test_unported_cli_options_exit_naming_their_item(argv, item, tmp_path,
                                                     capsys):
    """The AMR options no longer exit naming their item: each runs a deck
    to its end (a dataset directory without datasets refines nothing;
    tests/test_torch_amr_cli.py refines with datasets)."""
    os.makedirs(tmp_path / "amr")
    deck = box(tmp_path)
    assert main([deck, "--cpu", *[a.format(tmp=tmp_path) for a in argv]]) \
        == 0
    assert f"ROADMAP queue 1 {item}" not in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--constant-rain-rate", "1e-4"],
    ["--homogeneous-rain-file", "rain.bin"],
    ["--homogeneous-rain-file", "rain.bin", "--temporally-interpolate-rain"],
    ["--raster-rain-dir", "{tmp}/rasters"],
    ["--homogeneous-bc-file", "outlet=stage.bin"],
])
def test_forcing_cli_options_run(argv, tmp_path):
    """The forcing options, refused until they were ported, run a deck
    and change its end state (held against the JAX CLI in
    tests/test_torch_forcing_cli.py)."""
    os.makedirs(tmp_path / "rasters")
    write_datasets(tmp_path)
    deck = box(tmp_path)
    with open(deck, "a") as f:
        f.write("output: {format: binary, output_interval: 20}\n")
    ends = []
    for name, extra in (("plain", []), ("forced", argv)):
        out = str(tmp_path / name)
        assert main([deck, "--cpu", "--output-dir", out,
                     *[a.format(tmp=tmp_path) for a in extra]]) == 0
        last = sorted(f for f in os.listdir(out) if f.endswith(".bin"))[-1]
        ends.append(read_petsc_vec(os.path.join(out, last)))
    assert np.isfinite(ends[1]).all() and not np.array_equal(*ends)


def cli_options(path):
    """The --options a CLI source at path adds to its parser."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    return {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
            == "add_argument" and n.args and isinstance(n.args[0], ast.Constant)
            and n.args[0].value.startswith("--")}


def test_every_jax_cli_option_is_accepted():
    assert cli_options("rdycore_tpu/__main__.py") <= cli_options(
        "rdycore_tpu_torch/__main__.py")
