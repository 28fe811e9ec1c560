"""The second-order row-strip raster stepper (K2 MUSCL in strip mode, 3
halo rows, the faces of one halo row beyond each inner strip boundary for
the halo cells' donor factors), on the CPU, in float32: minmod with the
positivity limiter under ssprk2 in 4 strips against the JAX package's
sharded stepper (`second_order=True`) in interpret mode, and against the
port's single strip bit for bit, also under euler and rk4 with van Leer.
Deck and feeding as in tests/test_torch_strips_euler.py; as in the
single-device MUSCL tests (tests/test_torch_muscl_raster.py), h_anuga =
1e-3, the cells within two of the reflecting wall are deep (ROADMAP fault
17) and the state agrees with the JAX package's to 2e-6 absolute. A
donor factor below 1 is checked on a strip boundary row, where the halo
cell's factor decides the flux.
"""

import numpy as np
import pytest
import torch

from rdycore_tpu_torch.ops.kernels.raster_muscl import (
    donor_factors,
    raster_muscl_faces_plain,
)
from rdycore_tpu_torch.ops.kernels.raster_step import StructuredPlan
from rdycore_tpu_torch.ops.strips import split_rows, strip_layout

from test_torch_strips_euler import (
    DX,
    NX,
    NY,
    WALLS,
    assert_bitwise,
    assert_matches_jax,
    run_jax,
    run_port,
    strip_raster,
)

H_ANUGA = 1e-3
MUSCL = dict(second_order=True, limiter="minmod")


def test_muscl_strips_match_jax_and_the_single_strip():
    q, geo, bcv, src = strip_raster(18, deep_walls=True)
    res, out = run_port(q, geo, bcv, src, 4, "ssprk2", H_ANUGA, **MUSCL)
    assert_matches_jax(run_jax(q, geo, bcv, src, 4, "ssprk2", H_ANUGA,
                               **MUSCL), out, res)
    one, _ = run_port(q, geo, bcv, src, 1, "ssprk2", H_ANUGA, **MUSCL)
    assert_bitwise(one, res)
    # the limiter acts on the cells next to a strip boundary: the donor
    # factors of the halo face rows of the initial state at this dt
    plan = StructuredPlan(NX, NY, DX, DX, 1e-7, H_ANUGA, *WALLS)
    strips = strip_layout(NY, 4, 3)
    bufs = split_rows(torch.as_tensor(q.reshape(3, -1)), strips,
                      ["cpu"] * 4, NX)
    bct = {k: torch.as_tensor(v) for k, v in bcv.items()}
    s = strips[1]
    b = bufs[1]
    bc1 = {"left": bct["left"][:, s.row0 - 3:s.row0 + s.rows + 3],
           "right": bct["right"][:, s.row0 - 3:s.row0 + s.rows + 3]}
    fx, fy, _ = raster_muscl_faces_plain(plan, b, bc1, "minmod", s)
    sp = donor_factors(plan, b, fx, fy, torch.tensor(0.02), s)
    assert float(sp[0].min()) < 1.0 and float(sp[-1].min()) < 1.0


@pytest.mark.parametrize("scheme, limiter, P", [("euler", "minmod", 2),
                                                ("rk4", "van_leer", 4)])
def test_muscl_strips_match_the_single_strip(scheme, limiter, P):
    q, geo, bcv, src = strip_raster(19, deep_walls=True)
    kw = dict(second_order=True, limiter=limiter)
    res, _ = run_port(q, geo, bcv, src, P, scheme, H_ANUGA, **kw)
    one, _ = run_port(q, geo, bcv, src, 1, scheme, H_ANUGA, **kw)
    assert_bitwise(one, res)
    assert np.isfinite(res.q.numpy()).all()
