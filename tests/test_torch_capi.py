"""The port's embedded C API (rdycore_tpu_torch/capi/) on the CPU.

`capi/build.py` compiles the port's shim (the rdytpu_* symbols of the JAX
package's csrc/capi.c, driving rdycore_tpu_torch.capi_bridge) and links the
JAX package's unchanged C host csrc/test_capi.c against it: the host's
create -> per interval set rain, advance, read h and hu -> checkpoint and
one-DOF round trips -> destroy loop runs the port on the CPU
(RDYTPU_PLATFORM=cpu) on a small dam break, unstructured and on the raster
(the floodplain dry, so that the host's 1 um/s of rain is held in float32
and the volume grows as the host requires), and prints its three OK lines.
The bridge's timings (RDYTPU_TIMINGS) name every call of the loop. A
missing deck exits non-zero. Skipped only without a C compiler or
python3-config, as tests/test_capi.py is.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from rdycore_tpu_torch.mesh import structured_quad
from rdycore_tpu_torch.mesh.core import save_mesh_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = os.path.join(REPO, "csrc", "test_capi.c")

DECK = """
physics: {flow: {mode: swe}}
numerics: {spatial: fv, temporal: euler, riemann: roe, precision: single,
           edge_flux_backend: %s}
logging: {level: none}
time: {stop: 0.05, unit: seconds, time_step: 0.001, coupling_interval: 0.01}
output: {format: none}
grid: {file: dam_break.npz}
regions:
  - {name: reservoir, grid_region_id: 1}
  - {name: floodplain, grid_region_id: 2}
surface_composition:
  - {region: reservoir, material: smooth}
  - {region: floodplain, material: smooth}
materials: [{name: smooth, properties: {manning: {value: 0.018}}}]
initial_conditions:
  - {region: reservoir, flow: column}
  - {region: floodplain, flow: dry_bed}
flow_conditions:
  - {name: column, type: dirichlet, height: 0.25, x_momentum: 0, y_momentum: 0}
  - {name: dry_bed, type: dirichlet, height: 0, x_momentum: 0, y_momentum: 0}
"""


@pytest.fixture(scope="module")
def host():
    if not (shutil.which("cc") or shutil.which("gcc")):
        pytest.skip("no C compiler")
    if not shutil.which("python3-config"):
        pytest.skip("no python3-config (embedding headers unavailable)")
    from rdycore_tpu_torch.capi import build

    path = build.build_host(HOST)
    assert build.build_host(HOST) == path  # built once, then reused
    return path


def env_for(tmp_path):
    env = dict(os.environ, RDYTPU_PLATFORM="cpu",
               RDYTPU_TIMINGS=str(tmp_path / "timings.jsonl"))
    env.pop("PYTHONPATH", None)  # the shim puts the checkout on sys.path
    return env


@pytest.mark.parametrize("backend", ["xla", "fused_structured"])
def test_unchanged_c_host_runs_the_port(host, tmp_path, backend):
    save_mesh_npz(structured_quad(
        128, 32, 0.0, 2.0, 0.0, 0.5,
        region_fn=lambda cx, cy: np.where(cx < 1.0, 1, 2)),
        str(tmp_path / "dam_break.npz"))
    deck = tmp_path / "deck.yaml"
    deck.write_text(DECK % backend)
    r = subprocess.run(
        [host, str(deck), str(tmp_path / "ckpt.bin"),
         str(tmp_path / "onedof.bin")],
        capture_output=True, text=True, env=env_for(tmp_path), timeout=120)
    assert r.returncode == 0, f"\n{r.stdout}\n{r.stderr}"
    ok = [line for line in r.stdout.splitlines() if line.startswith("OK:")]
    assert len(ok) == 3, r.stdout
    assert ok[0].startswith("OK: 5 intervals, 50 steps, t=0.05")
    assert "checkpoint round-trip bitwise" in ok[1]
    assert "one-DOF vec round-trip + set_initial_conditions" in ok[2]
    report = json.loads((tmp_path / "timings.jsonl").read_text())
    assert report["steps"] == 50 and report["device"] == "cpu"
    calls = {k: len(v) for k, v in report["timers"].items()}
    assert calls["advance"] == calls["set_domain_water_source"] == 5
    assert calls["write_checkpoint"] == calls["read_checkpoint"] == 1
    # CPU tensors take the plain versions: no kernel launches
    assert not any(report["launches"].values())
    # the embedded interpreter is this one's installation
    assert report["python"]["prefix"] == sys.prefix


def test_c_host_exits_nonzero_on_a_missing_deck(host, tmp_path):
    r = subprocess.run([host, str(tmp_path / "nope.yaml")],
                       capture_output=True, text=True, env=env_for(tmp_path),
                       timeout=120)
    assert r.returncode != 0
    assert "FileNotFoundError" in r.stderr
