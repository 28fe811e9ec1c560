"""Thacker's bowl under MUSCL with the positivity limiter (euler, f64) in
rdycore_tpu_torch against the JAX package, on the CPU: the state after 60
steps on 40 x 40 quads at a Courant number near 0.25, where the drying
front has the limiter acting, equal to 1e-10 relative.

Run as a script, it prints one package's run of the bowl in chunks of
steps (finite?, min h, the chunk's largest Courant number), the check of
ROADMAP fault 22 (MUSCL under forward Euler diverges at full size):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_thacker_jax.py \\
        --package jax --n 1696 --dt 6.6e-4 --chunk 200

(`--package torch` runs the port's plain versions on the CPU;
`tools/torch_thacker.py` runs the port on the card.)
"""

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rdycore_tpu.mesh import structured_quad as jax_structured_quad
from rdycore_tpu.operator import build_operator as jax_build_operator
from rdycore_tpu.timestepping import make_interval_advancer as jax_advancer
from rdycore_tpu_torch.operator import build_operator
from rdycore_tpu_torch.timestepping import make_interval_advancer
from tools.torch_thacker import H0, HALF_WIDTH, thacker_case


def jax_case(n):
    """The JAX package's operator (MUSCL) on the bowl, and (h0, T)."""
    mesh, _, _, _, T, h0 = thacker_case(n)
    L = HALF_WIDTH
    jmesh = jax_structured_quad(
        n, n, -L, L, -L, L, z_fn=lambda x, y: -H0 * (1.0 - (x * x + y * y)))
    assert np.array_equal(jmesh.cell_z, mesh.cell_z)
    op = jax_build_operator(jmesh, mannings_n=np.zeros(jmesh.num_cells),
                            second_order=True)
    return mesh, op, h0, T


def jax_adv(op):
    """The JAX package's jitted euler advancer (n_steps static)."""
    return jax.jit(jax_advancer(op, "euler", accumulate=False),
                   static_argnums=4)


def test_muscl_bowl_matches_jax():
    n, dt, steps = 40, 0.025, 60  # dx 0.11 m: a Courant number near 0.25,
    # to t = 1.5 s, where the drying front has the limiter acting
    mesh, jop, h0, T = jax_case(n)
    qj = jnp.zeros((3, h0.size)).at[0].set(h0)
    rj = jax_adv(jop)(jop.arrays, qj, 0.0, dt, steps, T,
                      jop.zero_boundary_values(), jnp.zeros_like(qj))
    op = build_operator(mesh, mannings_n=np.zeros(mesh.num_cells),
                        second_order=True, device="cpu")
    q0 = torch.zeros((3, mesh.num_cells), dtype=torch.float64)
    q0[0] = torch.as_tensor(h0)
    rt = make_interval_advancer(op, "euler", accumulate=False)(
        q0, 0.0, dt, steps, T, op.zero_boundary_values(),
        torch.zeros_like(q0))
    want = np.asarray(rj.q)
    got = rt.q.numpy()
    assert np.isfinite(got).all()
    assert float(rt.t) == float(rj.t)
    for k in range(3):
        scale = float(np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-10 * scale, k


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--package", choices=("jax", "torch"), default="jax")
    ap.add_argument("--n", type=int, default=1696)
    ap.add_argument("--dt", type=float, default=6.6e-4)
    ap.add_argument("--chunk", type=int, default=200)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    mesh, jop, h0, T = jax_case(args.n)
    n_steps = int(np.ceil(T / args.dt))
    print(f"{args.package}: MUSCL euler on the {args.n}x{args.n} bowl, dt "
          f"{args.dt} s, {n_steps} steps", flush=True)
    if args.package == "jax":
        adv = jax_adv(jop)
        q = jnp.zeros((3, mesh.num_cells)).at[0].set(h0)
    else:
        op = build_operator(mesh, mannings_n=np.zeros(mesh.num_cells),
                            second_order=True, device="cpu")
        tadv = make_interval_advancer(op, "euler", accumulate=False)
        q = torch.zeros((3, mesh.num_cells), dtype=torch.float64)
        q[0] = torch.as_tensor(h0)
    t, done, t0 = 0.0, 0, time.time()
    while done < n_steps:
        k = min(args.chunk, n_steps - done)
        if args.package == "jax":
            res = adv(jop.arrays, q, t, args.dt, k, T,
                      jop.zero_boundary_values(), jnp.zeros_like(q))
        else:
            res = tadv(q, t, args.dt, k, T, op.zero_boundary_values(),
                       torch.zeros_like(q))
        q, t, done = res.q, float(res.t), done + k
        qn = np.asarray(q)
        finite = bool(np.isfinite(qn).all())
        print(f"  step {done} t {t:.5f}: finite {finite}, min h "
              f"{np.nanmin(qn[0]):.3e}, max Courant "
              f"{float(res.max_courant):.4g}; {time.time() - t0:.0f} s",
              flush=True)
        if not finite:
            break


if __name__ == "__main__":
    sys.exit(main())
