"""Raster backward Euler at second order (`edge_flux_backend:
fused_structured`, `temporal: beuler`, `second_order: true`) of
rdycore_tpu_torch against the JAX package's, on the CPU, in f32.

One step of tests/test_torch_beuler_raster.py's deck (a dam front, 2 m
against 1 m, over a wavy bed in a closed 128x16 box, Manning 0.02) at 2
Newton iterations of GMRES(2): the port's step through `Simulation` (K2
MUSCL's plain rhs mode, JVPs through the first-order float32
`StructuredSWEOperator`) against the JAX package's `newton_beuler_solve`
with the JAX package's own residual and JVPs, as its Simulation wires
them (structured_step.py:921-960): F the rhs mode of its fused raster
kernel at second order (interpret mode), F_lin its first-order
`build_structured_operator` twin.

Jitted whole, that solve lowers the interpret-mode kernel once for each
of its five call sites (about 20 s), so its pieces are compiled once
ahead of time and the JAX solver runs eagerly around them
(`jax.disable_jit`): F is the JAX stepper's beuler step with a solver
that returns F(u), and F_lin a `jax.custom_jvp` whose rule calls the
compiled jax.jvp of the twin.

The state agrees to 2e-6 relative to 1 + |q| (the two packages' second-
order rhs differ by float32 rounding), and the Newton residual
||u - u^n - dt F(u)|| of both packages falls by the same factor, to 1e-3
of it: the JAX package converges as slowly as the port (ROADMAP fault
21). Run as a script from the repo root, it prints both packages'
residual reductions at other Newton sizes, on this deck or on
chip_smoke.py phase 9's closed dam break (256x32 cells of 1/512 m at a
Courant number of about 2), with tests/conftest.py's JAX settings:

    JAX_PLATFORMS=cpu PYTHONPATH=. python \\
        tests/test_torch_beuler_raster_jax.py [--deck wavy|dam_break] \\
        [--newton 6] [--krylov 16]
"""

import argparse
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rdycore_tpu.timestepping as jax_timestepping
from rdycore_tpu.config.yaml_input import config_from_dict as jax_config
from rdycore_tpu.mesh import structured_quad as jax_quad
from rdycore_tpu.ops.pallas.structured_step import GC
from rdycore_tpu.simulation import Simulation as JaxSimulation
from rdycore_tpu_torch import Simulation, timestepping
from rdycore_tpu_torch.config.yaml_input import config_from_dict
from rdycore_tpu_torch.mesh import structured_quad

from test_torch_beuler_raster import DT, z_fn


class Deck(NamedTuple):
    """A closed raster box with a dam at x_dam: h_left | h_right at rest."""
    nx: int
    ny: int
    lx: float
    ly: float
    z_fn: Optional[Callable]
    h_left: float
    h_right: float
    x_dam: float
    manning: float
    dt: float

    def config(self):
        return {"numerics": {"temporal": "beuler", "precision": "single",
                             "edge_flux_backend": "fused_structured",
                             "second_order": True},
                "time": {"stop": self.dt, "time_step": self.dt,
                         "coupling_interval": 1.0},
                "logging": {"level": "none"}}

    def mesh(self, quad):
        return quad(self.nx, self.ny, 0, self.lx, 0, self.ly,
                    z_fn=self.z_fn)

    def state(self, mesh):
        q0 = np.zeros((3, mesh.num_cells), np.float32)
        q0[0] = np.where(mesh.cell_centroid[:, 0] < self.x_dam,
                         self.h_left, self.h_right)
        return q0


DECKS = {
    # tests/test_torch_beuler_raster.py's deck
    "wavy": Deck(128, 16, 32.0, 4.0, z_fn, 2.0, 1.0, 16.0, 0.02, DT),
    # chip_smoke.py phase 9's closed dam break on tools/
    # torch_beuler_newton.py's 256x32 cut (cells of 1/512 m, Courant ~2)
    "dam_break": Deck(256, 32, 0.5, 1 / 16, None, 0.25, 0.05, 0.25, 0.018,
                      0.0025),
}


def jax_pieces(deck):
    """(F, F_lin, q0) of the JAX package's raster beuler step at second
    order: F the fused kernel's rhs mode, F_lin the structured twin with
    a compiled JVP; both callable inside `jax.disable_jit`."""
    mesh = deck.mesh(jax_quad)
    sim = JaxSimulation(jax_config(deck.config()).validate(), mesh=mesh)
    q0 = deck.state(mesh)
    sim.set_solution(q0)
    sim.set_manning_n(np.full(mesh.num_cells, deck.manning))
    st = sim._structured
    assert st["kind"] == "fused" and st["lin_op"] is not None
    nx, ny, ty = st["nx"], st["ny"], st["plan"].gr
    dt = np.float32(deck.dt)
    u0 = jnp.asarray(q0)

    def step_rhs(u):  # the stepper's step, its solver returning F(u)
        q3 = u.reshape(3, ny, nx)
        planes = [jnp.pad(q3[k], ((ty, ty), (GC, GC))) for k in range(3)]
        out = st["adv"](*planes, np.float32(0.0), dt, np.int32(1), dt,
                        src=None, bc_vals=None)
        return jnp.stack([o[ty:ty + ny, GC:GC + nx].reshape(-1)
                          for o in out[:3]])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_timestepping, "newton_beuler_solve",
                   lambda F, F_lin, q, dt: F(q))
        f_compiled = jax.jit(step_rhs).lower(u0).compile()
    es3 = jnp.zeros((3, ny, nx), jnp.float32)

    def F_twin(u):  # structured_step.py:951-954
        rhs3, _ = st["lin_op"].apply(u.reshape(3, ny, nx), dt, es3)
        return rhs3.reshape(3, -1).astype(jnp.float32)

    jvp_compiled = jax.jit(
        lambda u, v: jax.jvp(F_twin, (u,), (v,))).lower(u0, u0).compile()

    def F(u):
        with jax.disable_jit(False):
            return f_compiled(u)

    @jax.custom_jvp
    def F_lin(u):
        return F_twin(u)

    @F_lin.defjvp
    def _(primals, tangents):
        with jax.disable_jit(False):
            return jvp_compiled(primals[0], tangents[0])

    return F, F_lin, q0


def jax_step(deck, F, F_lin, q0, newton_iters, krylov_m):
    with jax.disable_jit():
        u = jax_timestepping.newton_beuler_solve(
            F, F_lin, jnp.asarray(q0), np.float32(deck.dt),
            newton_iters=newton_iters, krylov_m=krylov_m)
    return np.asarray(u)


def port_step(deck, q0, newton_iters, krylov_m):
    mesh = deck.mesh(structured_quad)
    sim = Simulation(config_from_dict(deck.config()).validate(), mesh=mesh,
                     device="cpu")
    sim.set_solution(q0.astype(np.float64))
    sim.set_manning_n(np.full(mesh.num_cells, deck.manning))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timestepping, "NEWTON_ITERS", newton_iters)
        mp.setattr(timestepping, "KRYLOV_M", krylov_m)
        sim.run()
    assert sim.step == 1 and sim._structured["op"].second_order
    return sim.get_solution()


def residual(deck, F, q0, u):
    """||u - u^n - dt F(u)||, F the JAX package's residual."""
    return float(np.linalg.norm(u - q0 - np.float32(deck.dt) * np.asarray(
        F(jnp.asarray(u, jnp.float32)))))


def test_raster_muscl_beuler_matches_jax():
    deck = DECKS["wavy"]
    F, F_lin, q0 = jax_pieces(deck)
    u_jax = jax_step(deck, F, F_lin, q0, 2, 2)
    u_port = port_step(deck, q0, 2, 2)
    assert np.isfinite(u_port).all()
    rel = np.abs(u_port - u_jax) / (1.0 + np.abs(u_jax))
    assert rel.max() < 2e-6, rel.max()
    assert np.abs(u_jax - q0).max() > 1e-3  # the step moved the front
    r0 = residual(deck, F, q0, q0)
    r_jax = residual(deck, F, q0, u_jax)
    r_port = residual(deck, F, q0, u_port)
    assert r_jax < 1e-2 * r0
    assert r_port == pytest.approx(r_jax, rel=1e-3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deck", choices=sorted(DECKS), default="wavy")
    ap.add_argument("--newton", type=int, default=6)
    ap.add_argument("--krylov", type=int, default=16)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    deck = DECKS[args.deck]
    F, F_lin, q0 = jax_pieces(deck)
    r0 = residual(deck, F, q0, q0)
    for name, u in (
            ("JAX package", jax_step(deck, F, F_lin, q0, args.newton,
                                     args.krylov)),
            ("port", port_step(deck, q0, args.newton, args.krylov))):
        r = residual(deck, F, q0, u)
        print(f"{args.deck}, {name}: {args.newton} Newton iterations of "
              f"GMRES({args.krylov}): residual {r0:.4e} -> {r:.4e} "
              f"({r / r0:.4e} of its start)")


if __name__ == "__main__":
    main()
