"""The JAX package's public surface that rdycore_tpu_torch has not ported
yet (ROADMAP fault 20), checked on the CPU without a JAX compile: every
public member of the JAX Simulation exists on the port's, and each one the
port lacks (`rebuild_on_mesh`, with AMR) raises NotImplementedError naming
its ROADMAP item; every option of the JAX CLI is accepted by the port's,
each one it lacks (AMR's) exits with status 2 naming its item, and the
forcing options run. The members
the port has are held against the JAX package's in
tests/test_torch_coupling_surface.py.
"""

import ast
import os

import numpy as np
import pytest

from rdycore_tpu_torch import Simulation
from rdycore_tpu_torch.__main__ import _NOT_PORTED_OPTIONS, main
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.io.petsc_binary import read_petsc_vec
from rdycore_tpu_torch.mesh import structured_quad
from tests.test_torch_forcing import box
from tests.test_torch_forcing_cli import write_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# member -> (how it is reached, the arguments of a call, its ROADMAP item)
NOT_PORTED = {
    "rebuild_on_mesh": ("method", (None,), "ROADMAP queue 1 item 14"),
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
    (["--amr-dataset-dir", "amr/"], "item 14"),
    (["--amr-area-threshold", "0.2"], "item 14"),
])
def test_unported_cli_options_exit_naming_their_item(argv, item, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["deck.yaml", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{argv[0]} is not ported" in err and f"ROADMAP queue 1 {item}" in err


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
    port = cli_options("rdycore_tpu_torch/__main__.py") | {
        opt for opt, _, _ in _NOT_PORTED_OPTIONS}
    assert cli_options("rdycore_tpu/__main__.py") <= port
