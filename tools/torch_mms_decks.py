#!/usr/bin/env python3
"""Decks for the MMS driver (`python -m rdycore_tpu_torch deck.yaml --mms`).

The reference's MMS decks (driver/tests/swe_roe/mms_*.yaml) are not in this
repository, so the port's tests and `chip_smoke.py` phase 10 use their own
smooth, always-wet manufactured solution of the same form: analytic h, u,
v, z and n and their derivatives written out by hand as expressions of x,
y, t and constants (docs/config.md:121-129), on the domain [0, LX] x [0,
LY]:

    h  = H (2 + sin(A x) sin(B y)) exp(t/T)
    u  = U cos(A x) cos(B y) exp(-t/T)
    v  = V sin(A x) sin(B y) exp(-t/T)
    z  = Z cos(A x) cos(B y)
    n  = N (2 + cos(A x) sin(B y))
    c0 = C (2 + cos(A x) cos(B y)) exp(-t/T)
    c1 = C (2 + sin(A x) cos(B y)) exp(t/T)

with A = 2 pi / LX and B = 2 pi / LY. tests/test_torch_mms.py holds every
derivative against a central difference of its own expression.

    python3 tools/torch_mms_decks.py OUTDIR [--nx 32 --ny 22] [--tri]
        [--second-order] [--sediment N] [--refinements 2] [--dt S]
        [--stop S]

writes OUTDIR/mms.yaml and its base mesh OUTDIR/mms_base.npz (a
structured quad or triangle mesh on [0, 4] x [0, 2.75]); then
`python -m rdycore_tpu_torch OUTDIR/mms.yaml --mms --cpu` runs it.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

LX, LY = 4.0, 2.75  # the domain [m]: the dam break's 4 m x 2.75 m

CONSTANTS = {
    "H": 0.05,  # depth scale [m]: h in [0.05, 0.15] e^(t/T)
    "U": 0.1,  # velocity scales [m/s]
    "V": 0.08,
    "Z": 0.01,  # bed amplitude [m]
    "N": 0.02,  # Manning scale [s/m^(1/3)]: n in [0.02, 0.06]
    "C": 1e-3,  # sediment concentration scale
    "T": 20.0,  # time scale [s]
    "A": 2.0 * math.pi / LX,
    "B": 2.0 * math.pi / LY,
}

SWE = {
    "h": "H*(2 + sin(A*x)*sin(B*y))*exp(t/T)",
    "dhdx": "H*A*cos(A*x)*sin(B*y)*exp(t/T)",
    "dhdy": "H*B*sin(A*x)*cos(B*y)*exp(t/T)",
    "dhdt": "H*(2 + sin(A*x)*sin(B*y))*exp(t/T)/T",
    "u": "U*cos(A*x)*cos(B*y)*exp(-t/T)",
    "dudx": "-U*A*sin(A*x)*cos(B*y)*exp(-t/T)",
    "dudy": "-U*B*cos(A*x)*sin(B*y)*exp(-t/T)",
    "dudt": "-U*cos(A*x)*cos(B*y)*exp(-t/T)/T",
    "v": "V*sin(A*x)*sin(B*y)*exp(-t/T)",
    "dvdx": "V*A*cos(A*x)*sin(B*y)*exp(-t/T)",
    "dvdy": "V*B*sin(A*x)*cos(B*y)*exp(-t/T)",
    "dvdt": "-V*sin(A*x)*sin(B*y)*exp(-t/T)/T",
    "z": "Z*cos(A*x)*cos(B*y)",
    "dzdx": "-Z*A*sin(A*x)*cos(B*y)",
    "dzdy": "-Z*B*cos(A*x)*sin(B*y)",
    "n": "N*(2 + cos(A*x)*sin(B*y))",
}

SEDIMENT = {
    "c0": "C*(2 + cos(A*x)*cos(B*y))*exp(-t/T)",
    "dc0dx": "-C*A*sin(A*x)*cos(B*y)*exp(-t/T)",
    "dc0dy": "-C*B*cos(A*x)*sin(B*y)*exp(-t/T)",
    "dc0dt": "-C*(2 + cos(A*x)*cos(B*y))*exp(-t/T)/T",
    "c1": "C*(2 + sin(A*x)*cos(B*y))*exp(t/T)",
    "dc1dx": "C*A*cos(A*x)*cos(B*y)*exp(t/T)",
    "dc1dy": "-C*B*sin(A*x)*sin(B*y)*exp(t/T)",
    "dc1dt": "C*(2 + sin(A*x)*cos(B*y))*exp(t/T)/T",
}

# the reference's enforced rates: first order (mms_conv_study.yaml:50-60,
# BASELINE.md:16: h and hu; hv has no published row) and MUSCL
# (mms_conv_study_second_order.yaml:57-69, tests/test_mms.py:52-55)
FIRST_ORDER_RATES = {"h": {"L1": 0.94, "L2": 0.95, "Linf": 0.94},
                     "hu": {"L1": 0.91, "L2": 0.93, "Linf": 0.77}}
SECOND_ORDER_RATES = {"h": {"L1": 1.40, "L2": 1.20, "Linf": 0.80},
                      "hu": {"L1": 1.30, "L2": 1.30, "Linf": 0.85},
                      "hv": {"L1": 1.30, "L2": 1.30, "Linf": 0.85}}


def mms_deck(mesh_file: str, dt: float, stop: float, refinements: int = 0,
             second_order: bool = False, temporal: str = "euler",
             num_sediment: int = 0, riemann: str = "roe",
             expected_rates=None, precision: str = "double") -> dict:
    """The deck (a dict for `config_from_dict`, or YAML) of the MMS study
    on the base mesh `mesh_file`: `refinements` uniform refinements, dt
    and stop in seconds, the expected rates of the order's thresholds
    unless given."""
    if expected_rates is None:
        expected_rates = (SECOND_ORDER_RATES if second_order
                          else FIRST_ORDER_RATES)
    mms = {"constants": dict(CONSTANTS), "swe": dict(SWE)}
    if num_sediment:
        mms["sediment"] = {k: e for k, e in SEDIMENT.items()
                           if int(k.lstrip("d")[1]) < num_sediment}
    if refinements:
        mms["convergence"] = {"num_refinements": refinements,
                              "base_refinement": 0,
                              "expected_rates": expected_rates}
    deck = {
        "physics": {"flow": {"mode": "swe"}},
        "numerics": {"spatial": "fv", "temporal": temporal,
                     "riemann": riemann, "precision": precision},
        "time": {"stop": stop, "unit": "seconds",
                 "time_step": dt},
        "grid": {"file": mesh_file},
        "mms": mms,
    }
    if second_order:
        deck["numerics"].update(second_order=True, limiter="minmod")
    if num_sediment:
        deck["physics"]["sediment"] = {"num_classes": num_sediment}
    return deck


def base_mesh(nx: int, ny: int, tri: bool = False):
    """The structured base mesh of the domain: nx x ny quads, or their
    2 nx ny triangles."""
    from rdycore_tpu_torch.mesh import structured_quad, structured_tri

    make = structured_tri if tri else structured_quad
    return make(nx, ny, 0.0, LX, 0.0, LY)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=22)
    ap.add_argument("--tri", action="store_true")
    ap.add_argument("--second-order", action="store_true")
    ap.add_argument("--sediment", type=int, default=0)
    ap.add_argument("--refinements", type=int, default=2)
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument("--stop", type=float, default=0.1)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import yaml

    from rdycore_tpu_torch.mesh import save_mesh_npz

    os.makedirs(args.outdir, exist_ok=True)
    save_mesh_npz(base_mesh(args.nx, args.ny, args.tri),
                  os.path.join(args.outdir, "mms_base.npz"))
    deck = mms_deck("mms_base.npz", args.dt, args.stop, args.refinements,
                    args.second_order, "ssprk2" if args.second_order
                    else "euler", args.sediment)
    with open(os.path.join(args.outdir, "mms.yaml"), "w") as f:
        yaml.safe_dump(deck, f, sort_keys=False)
    print(os.path.join(args.outdir, "mms.yaml"))


if __name__ == "__main__":
    sys.exit(main())
