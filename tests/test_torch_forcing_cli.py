"""The port's CLI forcing options against the JAX package's CLI on the
CPU: each of --constant-rain-rate, --homogeneous-rain-file (with and
without --temporally-interpolate-rain), --raster-rain-dir (hourly rasters
from the default start date, the deck having no time.date) and
--homogeneous-bc-file BOUNDARY=FILE runs a small f64 Exodus deck to its
end through both packages' `main`; the binary outputs (natural order)
agree to 1e-12 and the forcing moved the state.
"""

import datetime
import os

import numpy as np
import pytest

from rdycore_tpu.__main__ import main as jax_main
from rdycore_tpu_torch.__main__ import main
from rdycore_tpu_torch.forcing import dataset_filename
from rdycore_tpu_torch.io.petsc_binary import read_petsc_vec, write_petsc_vec
from tests.test_torch_forcing import box
from tools.torch_flood_files import write_raster

START = datetime.datetime(2017, 8, 26)


def write_datasets(tmp_path):
    write_petsc_vec(str(tmp_path / "rain.bin"),
                    [0.0, 1e-4, 0.01, 3e-4, 0.015, 0.0])
    write_petsc_vec(str(tmp_path / "stage.bin"), [0.0, 0.3, 0.01, 0.7])
    rng = np.random.default_rng(0)
    for hour in range(2):
        write_raster(dataset_filename(str(tmp_path / "rasters"), START +
                                      datetime.timedelta(hours=hour)),
                     rng.uniform(0, 1e-3, (3, 5)), 0.4, 0.25, 0.8)


OPTIONS = {
    "constant": ["--constant-rain-rate", "2e-4"],
    "homogeneous": ["--homogeneous-rain-file", "rain.bin"],
    "interpolated": ["--homogeneous-rain-file", "rain.bin",
                     "--temporally-interpolate-rain"],
    "raster": ["--raster-rain-dir", "{tmp}/rasters"],
    "bc": ["--homogeneous-bc-file", "outlet=stage.bin"],
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_forcing_option_runs_as_the_jax_cli(tmp_path, option):
    os.makedirs(tmp_path / "rasters")
    write_datasets(tmp_path)
    deck = box(tmp_path)
    with open(deck, "a") as f:
        f.write("output: {format: binary, output_interval: 20}\n")
    argv = [a.format(tmp=tmp_path) for a in OPTIONS[option]]
    outs = {}
    for name, run in (("port", main), ("jax", jax_main)):
        out = str(tmp_path / name)
        assert run([deck, "--cpu", "--output-dir", out, *argv]) == 0
        files = sorted(f for f in os.listdir(out) if f.endswith(".bin"))
        outs[name] = [read_petsc_vec(os.path.join(out, f)) for f in files]
    assert len(outs["port"]) == len(outs["jax"]) == 2  # steps 0 and 20
    for got, want in zip(outs["port"], outs["jax"]):
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    first, last = outs["port"]
    assert np.abs(last - first).max() > 1e-6
