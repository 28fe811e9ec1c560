#!/usr/bin/env python3
"""Smoke run of rdycore_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N] [--steps N]

Phases, each printing as it goes; any failure exits non-zero:

1. Card and build: the card's name and power limit, torch's CUDA, the
   triton and nvcc versions, and a fresh nvcc build of every kernel of the
   package (one nvcc per source, all started together), with each
   kernel's registers, shared memory and spills.
2. Kernels against their plain PyTorch versions on the card, with a random
   wet/dry state made with numpy from --seed. On a 256x176 quad mesh and a
   triangle mesh, in f32 and f64, with all three BC codes (Dirichlet values
   non-zero): K1a swe_edge_flux; K1b swe_cell_stage in stage mode for each
   ssprk3 stage and in rhs mode, with each source method; K1c
   courant_argmax, including a constructed tie whose index must be exact,
   and (f32 and f64) NaN, infinities, signed zeros, one value, odd sizes
   and slices off a 16-byte boundary, its (max, index, run fold) exactly
   the plain version's. K1c must be one device kernel per call, by
   torch.profiler, here and at each main path's shapes (phases 3, 4, 8).
   On a 256x176 raster, in f32: K2 swe_raster_step with a Dirichlet left
   wall (non-zero values), critical outflow on the right and bottom and a
   reflecting top, the rain plane off and on, in stage mode for each
   ssprk3 stage and in rhs mode with the primitives, and its per-block
   Courant maxima folded by K1c. Tolerance, relative to each output's
   largest magnitude: 1e-12 in f64, 2e-5 in f32 (nvcc contracts
   multiply-adds into FMAs; CUDA's pow, cbrt and rsqrt are not PyTorch's).
3. The unstructured main path at full size: the dam break of
   examples/dam_break.yaml (reservoir at x < Lx/2 with h = 0.25 m,
   floodplain h = 0.05 m, Manning n = 0.018, critical outflow on the right,
   reflecting walls elsewhere, euler, dt = 0.0005 s, boundary-flux time
   series on) in f32 on a 2048x1408 raster of 1/512 m cells (4 m x 2.75 m,
   2,883,584 cells; a spacing exact in binary, which the raster detection
   of phase 4 needs), built once with the package's own mesh generator
   for phases 3 and 4. 10 steps through `Simulation` on the kernels are
   held against 10 steps on the plain versions (every row of q and of the
   accumulators, and the Courant number, to relative 1e-4); then --steps
   steps through `Simulation.advance` and `run` with every launch count set
   to 0 just before: h must be finite and >= 0, the volume lost must equal the
   outflow through the accumulated boundary fluxes (to 1e-4 of the initial
   volume, summed in f64 on the host), and K1a, K1b and K1c must have been
   launched once per step and K2 never. Then each kernel is timed at the
   path's shapes (device time per call, from torch.profiler) beside its
   plain version, its bound and, where one PyTorch call computes the same
   function, that call. Phases 4-6 drive their paths the same way
   (`run_main_path`).
4. The raster main path at full size: the same deck and mesh with
   `edge_flux_backend: fused_structured`. 10 steps on the kernels against
   10 steps on the plain versions: every row of q and of the
   accumulators, and the Courant number, to relative 1e-4. Then --steps steps
   with the launch counts set to 0 just before, the same checks of the
   state and the volume budget, and K2, K1c and K1a (on the boundary edges,
   for the boundary-flux accumulator) launched once per step each and K1b
   never. ssprk3 and rk4 then run a few dozen steps each (K2 in stage mode
   with qA, and in rhs mode, at full size). At this path's shapes, K2 (in
   stage and rhs mode), K1c on K2's block maxima and K1a on the boundary
   edges alone are held against their plain versions (2e-5; the Courant
   fold exact) and timed like the others.

5. Tracers (two sediment classes with Hairsine-Rose sources and salinity,
   NT = 3 tracer rows, ndof = 6). At 256x176 (quad and triangle meshes,
   f32 and f64, Roe and upwind-Roe, all three BC codes with non-zero
   Dirichlet tracer masses): K1a and K1b (each ssprk3 stage and rhs mode,
   source methods semi-implicit and none) at NT = 3, and K2 at NT = 3 on
   the raster (rain on, each stage and rhs mode), against their plain
   versions, tolerances as in phase 2. Then, on each main path at full
   size, the dam break with sediment in the reservoir and one salt
   concentration everywhere: 10 steps on the kernels against 10 on the
   plain versions (every row of q and of the accumulators, and the Courant
   number, to relative 1e-4); --steps euler steps with the launch counts
   set to 0 just before (K1a, K1b and K1c once per unstructured step; K2,
   K1c and boundary-only K1a once per raster step); h finite and >= 0,
   every row finite, the volume budget, and on the unstructured path the
   salinity mass budget (mass lost = accumulated outflow of its row, to
   1e-4 of the initial mass); the NT = 3 kernels held against their plain
   versions at the path's shapes and timed like the others.

6. Second order (MUSCL with the positivity limiter, flow only). At
   256x176 (quad and triangle meshes, f32 and f64, every BC code,
   h_anuga = 1e-3): K3a swe_muscl_grad, K1a in MUSCL mode for each
   limiter, K3b swe_positivity_drain and swe_positivity_scale (on a state
   where some donor factor is below 1, and with dt = 0), and on the raster
   K2 MUSCL swe_raster_muscl_step (one launch per stage: each limiter, in
   each ssprk3 stage and rhs mode, rain off and on, at a step where some
   donor factor is below 1, with its tile maxima and their K1c fold),
   against their plain versions, tolerances as in phase 2. Then, on each main path at full size, the dam break at
   second order (minmod, ssprk2, dt = 0.00025 s, a Courant number near
   0.4, the floodplain dry): 10 steps on the kernels against 10 on the
   plain versions (every row of q and of the accumulators, and the
   Courant number, to relative 1e-4), with the number of cells whose
   donor factor fell below 1 in each stage of the plain run; --steps
   steps with the launch counts set to 0 just before (per step 2 each of
   K3a, K1a, K3b drain, K3b scale and K1b and 1 K1c; on the raster 2 K2
   MUSCL, 1 K1c and 1 boundary-only K1a); h finite and >= -1e-7, the
   volume kept to 1e-4 (the front does not reach the outflow wall); each
   kernel of the path held against its plain version at the path's shapes
   (K3b drain and scale, and K2 MUSCL, also at 40 times the step, where
   the limiter acts) and timed like the others.

7. Well-balancing. At 256x176 (quad and triangle meshes over the bumpy
   bed z = 0.035 (1 + sin 4 pi x sin 4 pi y), f32 and f64, every BC code;
   phase 7a): K1a in HR mode (NT = 0 and 3, Roe and upwind-Roe), K1b in HR
   mode (each ssprk3 stage and rhs mode, each source method, NT = 0 and
   3), K5 swe_eta_vertex and K1a's BS2002 correction (first order and
   each limiter, h_anuga = 1e-3), against their plain versions,
   tolerances as in phase 2. Then, on a 1448x996 triangle mesh over the
   dam break's 4 m x 2.75 m (2,884,416 cells) with its vertices on that
   bed, the dam break set through `Simulation.set_height` (eta 0.25 m for
   x < 2 m; beyond, 0.05 m for HR, whose bump tops stay dry, and 0.1 m
   for BS2002, which diverges over dry bump tops in both packages, ROADMAP
   fault 19), Manning 0.018, critical outflow on the right, dt 0.0002 s,
   f32, three runs through `run_main_path`: HR euler, BS2002 euler, and
   BS2002 with MUSCL minmod and the positivity limiter under ssprk2 (h >=
   -1e-7). Each: 10 steps against the plain versions, exact launches
   (K5 before every K1a under BS2002), h >= 0, the volume budget, the
   kernels held against their plain versions and timed at the path's
   shapes. Last, a lake at rest on the same mesh, all walls reflecting:
   HR at eta 0.05 m (a fifth of the cells dry) must keep the momentum
   rows of `apply` below 1e-4; BS2002 at eta 0.1 m keeps no lake at rest
   (fault 19), so its rows and its max |hu|, |hv| after 100 steps are
   printed.

8. Row strips (the raster in parallel.n_devices = 4 strips of 352 rows,
   all on the one card through an explicit device list; halo rows copied
   between stages). The phase-4 deck in strips through `run_main_path`: 10
   steps on the kernels against the plain strip versions (1e-4, every
   row); then --steps euler steps with the launch counts set to 0 just
   before (K2, K1c and boundary-only K1a once per strip and step), the
   state and volume checks, and the end state bit for bit phase 4's
   single strip (q, t, Courant number, boundary-flux accumulator); wall
   ms/step beside phase 4's. Then phase 5's NT = 3 deck (euler) and phase
   6's second-order deck (ssprk2) for 24 steps each in strips, bit for
   bit their single strips, with exact launches (K2 MUSCL 2 per strip
   and step). Each strip kernel (K2 or K2 MUSCL in
   strip mode, K1c, K1a) launched on an inner strip of the final state is
   held against its plain version (2e-5; the Courant fold exact) and
   timed beside its bound, and the halo exchange is timed per stage.

9. The implicit and IMEX schemes at full size. (a) ark_imex (ARS(2,2,2),
   Manning friction solved per cell at each DIRK stage) on phase 3's deck:
   100 steps through `run_main_path` (10 against the linearization twin,
   every row to 1e-4; exact launches: K1a and K1b twice a step, K1c once;
   the volume budget). (b) beuler (6 Newton iterations of GMRES(16),
   residuals on the kernels, JVPs by forward-mode AD through the twin) on
   phase 3's mesh and dam break with every wall reflecting, dt 0.0025 s (a
   Courant number of about 2, printed, > 1 required): 1 step (one
   coupling interval) with exact launches (K1a and K1b 25 times a step,
   K1c once), held against the same step with plain residuals (2e-5
   relative to 1 +
   |q|), h finite and >= -1e-6, the closed box's volume to 1e-5; one more
   step split by CUDA events into residual kernels, JVPs and glue, with
   its Newton residual norm beside its start. (c) The raster (K2 in rhs
   mode 25 times a step, K1c and boundary K1a once; JVPs through the
   plain `structured` operator): 1 step on the kernels, exact launches
   and the closed box. (d) The raster at second order (K2 MUSCL in rhs
   mode, minmod), likewise. Each path's kernels are held against their
   plain versions and timed at its shapes.

10. The MMS driver (`mms.MMSDriver`, what `python -m rdycore_tpu_torch
   deck.yaml --mms` runs) in f64 on the manufactured solution of
   tools/torch_mms_decks.py over 4 m x 2.75 m, its base mesh written to an
   .npz as a user's deck names it, with the launch counts set to 0 just
   before each study and exact launches over all its levels' steps: a
   Dirichlet BC on every boundary edge whose values, and the sources on
   every row, are evaluated on the card at each step's half time, per-cell
   Manning values. (b) First order (euler) on 128x88 quads refined 4 times
   to 2,883,584 cells: each level's norms and times, the rates, which must
   beat the reference's first-order thresholds for h and hu (hv's printed
   without one); 10 steps of the finest level on the kernels against the
   plain versions (every row to 1e-10, K1a, K1b and K1c once a step). (c)
   Second order (MUSCL minmod with the positivity limiter, ssprk2) on
   structured_tri(64, 44) refined 4 times to 1,441,792 triangles, the
   rates against the reference's second-order thresholds. (d) Two
   sediment classes (Roe), 128x88 quads refined 3 times to 720,896, the
   rates printed beside the first-order thresholds. For each, a step of
   the finest level split by CUDA events into the analytic forcing and the
   kernels, and (a) each kernel at the finest level's shapes (K1a with
   the analytic Dirichlet values, K1b in stage mode with the sources)
   against its plain version (1e-12) and timed beside its bound. (e)
   Thacker's bowl (tests/test_thacker.py's deck, tools/torch_thacker.py)
   on 1696x1696 quads (2,876,416 cells), f64, one period under euler:
   first order at a Courant number near 0.28 (h >= 0, the mass to 1e-11,
   the front moved, L1/mean < 0.08, the momenta back near 0); then first
   order and MUSCL at half that dt (MUSCL diverges at the full dt in both
   packages, ROADMAP fault 22), MUSCL finite and its error at most 1.05
   times first order's. Exact launches in each run, the cells whose donor
   factor fell below 1 in each quarter period of the MUSCL run, and the
   MUSCL path's kernels held and timed at its shapes.

11. The coupler's path at full size: phase 3-4's mesh written once as an
   .npz, the dam break with every wall reflecting and the floodplain dry
   (f32, euler, dt 0.0005 s, coupling intervals of 10 steps) in a raster
   and an unstructured deck. (a) The JAX package's unchanged C host
   csrc/test_capi.c, compiled against the port's embedded C API
   (rdycore_tpu_torch/capi/, `python3-config --embed`), on each deck for
   40 steps with a binary checkpoint: its three OK lines, exact launches
   (K2 and K1c, or K1a, K1b and K1c, once a step), the wall ms of a
   coupling interval split by the bridge's host timers into set source,
   advance and get fields, and the seconds to write and read the 69 MB
   checkpoint. Where this machine cannot embed CPython, the same sequence
   runs through capi_bridge in this process after a line "c_host: not
   built (<reason>)". (b) Restart: 40 steps with `checkpoint.interval:
   20` (`CheckpointMonitor` writes step 20 mid-run), then a run from that
   file through `restart.file` to step 40, bit for bit in q, t and step,
   on the raster, the raster in 4 strips on the one card and the mesh;
   each C host path's kernels held against their plain versions and timed
   at its shapes. (c) Regional Manning values and momentum sources (on the
   wet reservoir) on the unstructured deck: 10 steps on the kernels
   against the plain versions (2e-5, every row); `set_regional_manning_n` timed on both decks (the
   raster rebuilds its backend).

12. Mesh files, RCM and the forcing datasets on the valley of
   tools/torch_flood_files.py: `structured_tri(1448, 996)` over 20.48 km x
   14.08 km (2,884,416 triangles of legs about 14.1 m), a bed falling to
   the outlet and rising to the side walls, a parabolic channel; two
   element blocks (channel, floodplain) and four side sets (three walls
   and the outlet). (a) It is written as Exodus (CDF-2) and Gmsh 4.1 with
   its cells and vertices shuffled from a seed (the worst case for
   locality, not a mesher's order) and read back by the port's readers,
   the two meshes equal array for array; `build_mesh` on the native
   builder and on its numpy plain versions, equal array for array; the
   seconds of each, and of RCM. (b) 200 euler steps (dt 0.25 s, the
   channel 1 m deep, the floodplain dry, a Dirichlet depth at the outlet)
   in file order and under `cell_ordering: rcm` through `run_main_path`
   (10 steps against the plain versions, exact launches, h >= 0, the
   volume budget), the two end states by natural id to 1e-5, each order's
   K1a, K1b and K1c held against their plain versions and timed beside
   their bounds. (c) The flood through the
   CLI's `main` (what `python -m rdycore_tpu_torch` runs): the Exodus deck
   under RCM, two hourly rain rasters (--raster-rain-dir) and the outlet's
   depth series (--homogeneous-bc-file), coupling intervals of 120 s, to t
   = 3720 s: exact launches, the Courant number (<= 0.5), h finite and
   >= 0, the volume change against rain in minus outflow to 1e-3 of the
   rain, the rain's rate switching at 3600 s, wall seconds split into
   setup, steps and forcing. (d) The dam break of phases 3-4 as an .npz
   with every wall reflecting on fused_structured with
   --constant-rain-rate 2e-3 m/s for 40 steps through the CLI's `main`:
   the rain in K2's rain plane, exact launches, the state against the
   plain versions to 1e-4, the volume gained against the rain (within
   float32's rounding of the reservoir's uniform depth), and K2 with the
   rain plane held against its plain version and timed.

13. Ensembles, AMR and the profiling harness on phase 3's dam break, its
   mesh written once as an .npz (phases 11-13 read it). (a) A four-member
   ensemble on the shared grid through `EnsembleSimulation` (Manning n
   0.012, 0.018, 0.024, 0.030; members 2 and 3 with a reservoir of 0.20
   and 0.30 m; f32, euler, dt 0.0005 s, coupling intervals of 50 steps):
   10 steps of each member on the kernels against 10 on the plain
   versions (every row of q and of the accumulators, and the Courant
   number, to relative 1e-4); then 200 steps with the launch counts set to
   0 just before, K1a, K1b and K1c launched 4 times a step; each member's
   h finite and >= 0 and its volume budget (1e-4); each member against a
   solo `Simulation` of its deck (1e-6, its largest difference printed);
   the members apart; setup seconds, wall ms per interval and ms per
   member-step beside the solo runs' and phase 3's. (b) AMR twice
   through the CLI's `main` (`--amr-dataset-dir`, `--amr-area-threshold
   2e-6`) on phase 3's deck at dt 0.0001 s, intervals of 40 steps, 240
   steps: minute 0's dataset marks the 256 columns within 0.25 m of the
   dam (3,976,192 cells after it), minute 2's the 128 within 0.125 m of x
   = 3 m (4,528,128): each event's cells, the volume across it (1e-6,
   summed in f64), exact launches, the Courant number (<= 0.5), h finite
   and >= 0, the volume budget against the outflow over the three meshes
   (1e-4), 10 steps on the kernels against the plain versions on the final
   mesh (1e-4); seconds of `refine_marked` and of the rebuild, the peak
   device memory, ms/step on each mesh; K1a, K1b and K1c held and timed
   at the mixed mesh's shapes. (c) `profiling.preload` after an interval
   restores the state bit for bit; `StepTimer`'s steady cell-updates/s
   beside phase 3's; `profiling.trace` writes a Chrome trace naming K1a,
   K1b and K1c.

14. Multi-process runs (parallel/): ranks started with the spawn start
   method over a FileStore (`parallel.comm.spawn`), each loading the
   kernel libraries phase 1 built. (a) Phase 3's dam break with
   `partitioning: auto` (RCM) in 2 ranks sharing the card over gloo (NCCL
   refuses two ranks on one card; the halo goes through host buffers),
   one shard each: per rank the mesh and setup seconds, owned, ghost and
   frontier cells; 10 steps on the kernels against the plain versions
   (every row to 1e-4); the same 10 steps bit for bit one process on the
   RCM order (q, t, Courant number and edge, boundary fluxes); a 200-step
   interval timed between CUDA events (ms/step per rank), the rank's
   peak device memory, K1a, K1b and
   K1c launched once a step per rank, h >= 0 and the volume budget; the
   halo exchange's ms per stage (the transport's under gloo:
   point-to-point buffers through pinned host memory), beside the same
   halo by one all-gather (`DistTransport.exchange_gather`, NCCL's; the
   ghost rows checked equal), timed in the order p2p, all-gather,
   all-gather, p2p. (b) Phase 6's second-order deck (MUSCL
   ssprk2, 3 rings of ghosts), 24 steps bit for bit one process on the
   RCM order, exact launches. (c) Phase 4's raster in one row strip per
   rank, each strip's buffer kept by its rank across intervals: --steps
   steps bit for bit phase 4's end state, ms/step and the strip exchange
   per rank, exact launches (K2, K1c, boundary K1a once a step). (d) One
   NCCL rank (its Courant pair gathered over NCCL, an exchange with no
   peer): 10 steps bit for bit one process. Rank 0's kernels (K1a, K1b,
   K1c; the MUSCL path's K3a, K1a, K3b drain and scale, K1b, K1c; the
   strip's K2, K1c, K1a) are held against their plain versions at its
   shapes and timed beside their bounds.

15. What the shards run since ROADMAP item 16b, in 2 gloo ranks sharing
   the card (`phase_shards_16b`, `shards_16b_rank`). (a) Phase 7's BS2002
   deck (1448x996 triangles, 2,884,416 cells, the bumpy bed, f32,
   `partitioning: auto`): per rank the owned, ghost, vertex-ring ghost
   and frontier cells; 10 steps on the kernels against the shards'
   plain versions (every row of q to 1e-4), and bit for bit one process
   on the RCM order (q, t, Courant number and edge, boundary fluxes); a
   100-step interval timed between CUDA events beside one card's, K5,
   K1a, K1b and K1c once a step per rank, h >= 0 and the volume budget,
   the exchange per stage; then BS2002 with MUSCL (ssprk2) for 24 steps bit for bit,
   with the owned cells whose donor factor falls below 1 over dt and 40
   dt. (b) Phase 9's closed dam break under beuler (DT_BEULER, one
   interval of BEULER_STEPS): within 1e-4 (relative to 1 + |q|) of phase
   9b's step on one card, by natural id, K1a and K1b 25 times a step and
   K1c once,
   the collectives a step, the closed box's volume; one more step split
   by CUDA events into residual kernels, JVPs, global sums and glue, with
   the global Newton residual before and after. (c) 13b's AMR run through
   the CLI in 2 shards (`partitioning: none`, every rank reading the
   datasets): after each event q, t and step bit for bit 13b's
   one-process run, the volume across it, `refine_marked` and rebuild
   seconds, peak device memory; K1a, K1b and K1c once a step. Rank 0's
   kernels at its shard's shapes (K5, K1a BS2002, K1b and K1c; the MUSCL
   path's; K1a and K1b in rhs mode and K1c under beuler) are held
   against their plain versions and timed beside their bounds.

Before the last line it prints the card's name and power limit and a JSON
line {"kernels": [...]} with one row per kernel and path ("path":
"unstructured", "raster", "unstructured+tracers", "raster+tracers" (these
two with "nt": 3), "unstructured+muscl", "raster+muscl",
"unstructured+hr", "unstructured+bs2002", "unstructured+bs2002+muscl",
"raster+strips4", "raster+strips4+tracers", "raster+strips4+muscl",
"unstructured ark_imex", "unstructured beuler", "raster beuler", "raster
beuler+muscl", "unstructured mms", "unstructured mms+muscl", "unstructured
mms+sediment", "unstructured thacker+muscl", "coupler raster",
"coupler unstructured", "exodus file order", "exodus rcm", "raster+rain",
"unstructured ensemble4", "unstructured amr", "unstructured sharded",
"unstructured sharded+muscl", "raster strips, ranks", "unstructured
sharded+bs2002", "unstructured sharded+bs2002+muscl" or "unstructured
sharded beuler" (these six with "ranks"), these twenty-one with
"launches_per_step", phase 10's
with "dtype": "float64", phase 11's with the C host's launches; a
strip row names its strip [row0, rows, halo_lo, halo_hi]),
each with that path's own launches, times and bound, and "timers" naming
the timer of each time ("profiler", or "cuda events" where torch.profiler
recorded no device time); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
L2_BYTES = 50e6  # H100 L2: a call repeated on one input finds some there
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}  # non-tensor
TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
DT = 0.0005
# floating-point operations per item, counted from the CUDA sources (sqrt,
# divide, pow and cbrt count as one each)
OPS_PER_EDGE = 165  # K1a: two regularizations, ghost state, Roe, mask
OPS_PER_CELL = 80  # K1b: 4-slot divergence, semi-implicit sources, stage
OPS_PER_VALUE = 1  # K1c: one comparison per Courant value
# K2: the work of the function, each face once: two Roe solves (~140
# each) per cell, one regularization and square root, the divergence,
# sources, stage update and Courant maxima
OPS_PER_RASTER_CELL = 360
DX = 1.0 / 512.0  # cell size of the full-size raster [m]
H_RESERVOIR, H_FLOODPLAIN = 0.25, 0.05  # initial depths [m]
# phase 5: two sediment classes (their concentrations in the reservoir)
# and salinity (one concentration everywhere)
NT, NUM_SEDIMENT = 3, 2
SEDIMENT_C = (2e-3, 1e-3)
SALINITY_C = 1e-3
# operations per item that the tracers add, counted from the CUDA sources:
# K1a two concentrations and the advected wave per tracer; K1b its gather,
# Hairsine-Rose, stage and primitive; K2 one concentration, two faces'
# waves (each face once), the divergence, sources and stage
OPS_PER_TRACER = {"swe_edge_flux": 25, "swe_cell_stage": 20,
                  "swe_raster_step": 60}
# phase 6: the second-order dam break (dry floodplain, minmod, ssprk2)
DT_MUSCL = 0.00025
LIMITERS = ("minmod", "van_leer", "none")
# operations per item of the second-order kernels, counted from the CUDA
# sources: K3a per cell (4 slots of 3 differences and 6 multiply-adds);
# K1a in MUSCL mode per edge (K1a's plus two sides' 3 extrapolations and
# limited slopes); K3b per cell (4 slots, the factor) and per edge (the
# donor test, 3 products); K2 MUSCL per cell, each face once: two MUSCL
# faces (about 190 each: six limited slopes, two regularizations and
# square roots, Roe), two gradients, the donor factor, the divergence,
# sources and stage
OPS_PER_GRAD_CELL = 60
OPS_PER_MUSCL_EDGE = 225
OPS_PER_DRAIN_CELL = 16
OPS_PER_SCALE_EDGE = 4
OPS_PER_MUSCL_RASTER_CELL = 500
# phase 7: well-balancing on a 1448x996 triangle mesh over a bumpy bed
# (2,884,416 cells over the dam break's 4 m x 2.75 m), dt for a Courant
# number of about 0.3-0.5
WB_NX, WB_NY = 1448, 996
DT_WB = 0.0002
WB_INTERVAL_STEPS = 100  # steps per coupling interval
H_WB_SUBMERGED = 0.1  # a floodplain level above every bump [m]
# operations the well-balancing modes add, counted from the CUDA sources:
# K1a HR per interior edge (two bed gathers, the higher bed, two
# reconstructed depths, the inner mask); K1a BS2002 per edge (two eta
# gathers, dhv, the correction of two rows); K1b HR per slot (the
# neighbour, its reconstructed depth, the pressure term, two products);
# K5 per (vertex, cell) pair (eta_cell with a cube or square root, the sum)
OPS_PER_HR_EDGE = 8
OPS_PER_BS_EDGE = 10
OPS_PER_HR_SLOT = 14
OPS_PER_ETA_PAIR = 30
_CSRC = "rdycore_tpu_torch/ops/kernels/csrc/"
SOURCES = {"swe_edge_flux": _CSRC + "swe_edge_flux.cu",
           "swe_cell_stage": _CSRC + "swe_cell_stage.cu",
           "courant_argmax": _CSRC + "courant_argmax.cu",
           "swe_raster_step": _CSRC + "swe_raster_step.cu",
           "swe_muscl_grad": _CSRC + "swe_muscl_grad.cu",
           "swe_positivity_drain": _CSRC + "swe_positivity.cu",
           "swe_positivity_scale": _CSRC + "swe_positivity.cu",
           "swe_raster_muscl_step": _CSRC + "swe_raster_muscl.cu",
           "swe_eta_vertex": _CSRC + "swe_eta_vertex.cu"}
_SLOTTED = "rdycore_tpu/ops/pallas/slotted.py"
# the per-shard kernel call of the row-strip sharded raster stepper
_SHARDED = "rdycore_tpu/ops/pallas/structured_step.py:1211"
REPLACES = {"swe_edge_flux": _SLOTTED + ":2463",
            "swe_cell_stage": _SLOTTED + ":2463",
            "courant_argmax": _SLOTTED + ":2463",
            "swe_raster_step": "rdycore_tpu/ops/pallas/structured_step.py:172",
            "swe_muscl_grad": _SLOTTED + ":3066",
            "swe_positivity_drain": _SLOTTED + ":1597",
            "swe_positivity_scale": _SLOTTED + ":1654",
            "swe_raster_muscl_step":
                "rdycore_tpu/ops/pallas/structured_step.py:341",
            "swe_eta_vertex": "rdycore_tpu/ops/pallas/routed.py:264"}


# steady-state (ms/step, cell-updates/s) of each path `run_main_path` drove,
# and the final state of phase 4's raster run, which phase 8 must reproduce
STEADY = {}
REFERENCE = {}
STRIPS = 4  # phase 8: row strips on the one card
# phase 9: ark_imex steps and their coupling interval (in steps); beuler's
# dt (a Courant number of about 2 on the dam break: sqrt(g 0.25 m) * dt /
# (1/512 m)) and steps
IMEX_STEPS, IMEX_INTERVAL_STEPS = 100, 50
DT_BEULER = 0.0025
BEULER_STEPS = 1  # one coupling interval
# phase 10: the MMS studies' dt (a Courant number near 0.34 on the finest
# quads, 1/512 m; 0.28 on the finest triangles, legs of 1/256 m; 0.34 on
# the sediment ladder's finest quads, 1/256 m) and end time; Thacker's
# bowl on THACKER_N^2 quads at a Courant number near 0.28 (and half it)
MMS_DT, MMS_TRI_DT, MMS_SED_DT, MMS_STOP = 5e-4, 2e-4, 1e-3, 0.2
# the base meshes over 4 m x 2.75 m (128 x 88 quads of 1/32 m; 64 x 44
# quads of 1/16 m, each split in two triangles) and the refinements of
# 10b, 10c and 10d: 2,883,584 quads, 1,441,792 triangles, 720,896 quads
MMS_QUADS, MMS_TRIS, MMS_REFINE = (128, 88), (64, 44), (4, 4, 3)
THACKER_N, THACKER_DT = 1696, 6.6e-4
# phase 11: the C host's steps and coupling interval (in steps), and the
# restart test's checkpoint step N of 2N
COUPLER_STEPS, COUPLER_INTERVAL, RESTART_N = 40, 10, 20


def log(*args):
    print(*args, flush=True)


def final_state(sim):
    """(q, t, Courant number, boundary-flux accumulator) of a run."""
    return (sim.get_solution(), sim.t, sim.prev_max_courant,
            sim.bflux_accum.copy())


def same_state(a, b):
    """Whether two `final_state`s are equal bit for bit."""
    return (np.array_equal(a[0], b[0]) and a[1] == b[1] and a[2] == b[2]
            and np.array_equal(a[3], b[3]))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    want = want.double()
    scale = float(want.abs().max()) if want.numel() else 1.0
    err = float((got.double() - want).abs().max()) if want.numel() else 0.0
    return err / max(scale, 1e-30)


def abs_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def cuda_ms(fn, reps=20) -> float:
    """Mean milliseconds per call of fn() between CUDA events: device time,
    or the host's launch time where that is longer."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_us(evt) -> float:
    """Self device time of a torch.profiler average, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_events(prof):
    """(device us, count, name) of every device activity (kernels, copies)
    that torch.profiler recorded."""
    return [(device_us(e), e.count, e.key) for e in prof.key_averages()
            if device_us(e) > 0.0 and "CUDA" in str(getattr(e, "device_type",
                                                             ""))]


def device_time(fn, reps=20):
    """(mean device milliseconds per call of fn(), the timer that gave
    them): the device time of every kernel and copy it launches, from
    torch.profiler ("profiler"), the larger of two sessions: a session on
    that card has missed a whole run's events (once in four runs) and,
    more often, part of them (a time below the kernel's bytes bound).
    Where neither session records device time, the time between CUDA
    events ("cuda events"), which counts the host's launch time where
    that is longer."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    totals = []
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            totals.append(sum(e[0] for e in events) / 1e3 / reps)
    if totals:
        return max(totals), "profiler"
    log("  torch.profiler recorded no device time twice: timing between "
        "CUDA events instead")
    return cuda_ms(fn, reps), "cuda events"


def check_one_kernel(fn, what, calls=3, sessions=5):
    """Fail unless fn() launches exactly one device kernel a call, by
    torch.profiler over `calls` calls: the CUDA runtime's kernel launches
    number `calls`, and the device records no kernel but one. A session on
    that card may leave out some or all of a run's device records, never
    the runtime calls; one that records no kernel is taken again, up to
    `sessions` times."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.key.startswith(("cudaLaunchKernel",
                                            "cuLaunchKernel")))
        kernels = {name: n for _, n, name in device_events(prof)}
        if kernels:
            break
    log(f"  {what}: {launches} kernel launches over {calls} calls, device "
        f"records {kernels}")
    if launches != calls or len(kernels) > 1:
        raise SystemExit(f"{what}: not one kernel per call")


def device_ms(fn, reps=20) -> float:
    """The milliseconds of `device_time`, for the log."""
    return device_time(fn, reps)[0]


# ------------------------------------------------------------------ phase 1
def phase_build():
    from rdycore_tpu_torch.ops.kernels import build

    log("== phase 1: card and build")
    log(f"card: {nvidia_smi_line()}")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    try:
        import triton

        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not installed")
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    t0 = time.perf_counter()
    built = build.build_all(force=True)
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s wall "
        f"(per source: "
        f"{', '.join(f'{k} {v[0]:.2f} s' for k, v in built.items())})")
    for name, (_, report) in built.items():
        log(f"  ptxas {name}: {' | '.join(ptxas_summary(report))}")
    from rdycore_tpu_torch.mesh import build as mesh_build

    t0 = time.perf_counter()
    lib = mesh_build.library()
    log(f"native mesh library ({mesh_build.compiler()}, "
        f"{' '.join(mesh_build.FLAGS)}): {lib} in "
        f"{time.perf_counter() - t0:.2f} s")


def ptxas_summary(report):
    """'kernel<args>: R registers, S B shared memory, P B spilled' of each
    entry function in nvcc's -Xptxas -v report whose tracer count is 0 or
    NT (the others are the same source at other counts); a MUSCL instance
    names its limiter code, a K2 or K2 MUSCL instance its tile (its shared
    memory: the static, and the dynamic that the kernel reports,
    `smem_bytes` of raster_step and raster_muscl)."""
    from rdycore_tpu_torch.ops.kernels import raster_muscl, raster_step

    out, entry, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry and "spill stores" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if entry and m:
            k = re.search(r"\d+([a-z_]+_kernel)(I\w+?EE|E)", entry)
            counts = re.findall(r"Li(\d+)E", entry)
            lims, wb, tile = [], [], []
            if "edge_flux" in entry:
                counts, lims, wb = counts[:1], counts[1:2], counts[2:3]
            if "raster_muscl" in entry:
                tile, lims, counts = [int(c) for c in counts[:2]], \
                    counts[2:3], []
            if "raster_step" in entry:
                tile, counts = [int(c) for c in counts[:2]], counts[2:3]
            if k and (not counts or int(counts[0]) in (0, NT)):
                args = k.group(2)
                what = ["f64" if args.startswith("Id") else "f32"]
                what += [f"tile {tile[0]}x{tile[1]}"] if tile else []
                what += [f"nt {c}" for c in counts[:1]]
                what += [f"limiter {c}" for c in lims if c != "0"]
                what += [{"1": "hr", "2": "bs2002"}[c] for c in wb
                         if c != "0"]
                flags = re.findall(r"Lb(\d)", args)
                if "1" in flags:
                    what += ["hr" if "cell_stage" in entry else "upwind"]
                spills = re.findall(r"(\d+) bytes spill", spill)
                smem = int(re.search(r"(\d+) bytes smem", line).group(1)
                           if "bytes smem" in line else 0)
                if tile:  # a tile lives in dynamic shared memory
                    smem += (raster_muscl.smem_bytes()
                             if "raster_muscl" in entry
                             else raster_step.smem_bytes(int(counts[0])))
                out.append(f"{k.group(1)}<{', '.join(what)}>: {m.group(1)} "
                           f"regs, {smem} B shared memory, "
                           f"{sum(map(int, spills))} B spilled")
            entry = None
    return out


# ------------------------------------------------------------------ phase 2
def random_state(op, rng, dtype, dev):
    C, Eb = op.num_cells, op.num_boundary_edges
    h = rng.uniform(0.05, 1.0, C)
    h = np.where(rng.uniform(size=C) < 0.25, rng.uniform(0, 5e-8, C), h)
    h = np.where(rng.uniform(size=C) < 0.1, 0.0, h)
    q = np.stack([h, h * rng.normal(0, 0.4, C), h * rng.normal(0, 0.4, C)])
    bv = np.stack([rng.uniform(0.1, 0.6, Eb), rng.normal(0, 0.1, Eb),
                   rng.normal(0, 0.1, Eb)])
    ext = rng.normal(0.0, 1e-3, (3, C))

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return t(q), t(bv), t(ext)


def phase_kernels(seed, errs, dev):
    from rdycore_tpu_torch.mesh import structured_quad, structured_tri
    from rdycore_tpu_torch.operator import build_operator
    from rdycore_tpu_torch.ops.kernels.cell_stage import (
        swe_cell_stage, swe_cell_stage_plain)
    from rdycore_tpu_torch.ops.kernels.courant import (
        courant_argmax, courant_argmax_plain)
    from rdycore_tpu_torch.ops.kernels.edge_flux import (
        swe_edge_flux, swe_edge_flux_plain)
    from rdycore_tpu_torch.ops.kernels.raster_step import (
        StructuredPlan, swe_raster_step, swe_raster_step_plain)
    from rdycore_tpu_torch.ops.structured import FUSED_STAGES
    from rdycore_tpu_torch.timestepping import _FUSED_STEP_STAGES

    log("== phase 2: kernels against their plain versions on the card")
    rng = np.random.default_rng(seed)
    meshes = {
        "quad 256x176": structured_quad(256, 176, 0.0, 0.512, 0.0, 0.352),
        "tri 128x88": structured_tri(128, 88, 0.0, 0.512, 0.0, 0.352),
    }
    bc = {"left": 0, "right": 2, "top": 1, "bottom": 0}  # all three codes
    failures = []

    def check(kernel, what, got, want, dtype):
        r, a = rel_err(got, want), abs_err(got, want)
        errs[kernel] = max(errs.get(kernel, 0.0), a)
        ok = r <= TOL[dtype]
        log(f"  {kernel:15s} {what:48s} rel {r:.3e} abs {a:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {what}")

    for mname, mesh in meshes.items():
        for dtype in (torch.float32, torch.float64):
            tag = f"{mname} {str(dtype)[6:]}"
            n = rng.uniform(0.01, 0.05, mesh.num_cells)
            op = build_operator(mesh, bc_types=bc, mannings_n=n, dtype=dtype,
                                device=dev)
            a = op.arrays
            q, bv, ext = random_state(op, rng, dtype, dev)
            # K1a
            fk, ck = swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga)
            fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
            check("swe_edge_flux", f"{tag} flux", fk, fp, dtype)
            check("swe_edge_flux", f"{tag} courant", ck, cp, dtype)
            # K1b, on the plain flux so that errors do not compound
            dt = torch.tensor(0.002, dtype=dtype, device=dev)
            qA, _, _ = random_state(op, rng, dtype, dev)
            for method in (0, 1, 2):
                kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                          xq2018_threshold=op.xq2018_threshold,
                          source_method=method)
                modes = [("rhs", dict(emit_prim=True))] + [
                    (f"stage {i + 1}", dict(stage=s, qA=qA if i else None,
                                            emit_prim=True))
                    for i, s in enumerate(_FUSED_STEP_STAGES["ssprk3"])
                ]
                for mode, extra in modes:
                    ok_ = swe_cell_stage(a, fp, q, dt, ext, **kw, **extra)
                    op_ = swe_cell_stage_plain(a, fp, q, dt, ext, **kw,
                                               **extra)
                    for field in ("q_out", "flux_div", "rhs", "prim"):
                        if getattr(op_, field) is not None:
                            check("swe_cell_stage",
                                  f"{tag} src{method} {mode} {field}",
                                  getattr(ok_, field), getattr(op_, field),
                                  dtype)
            # K1c: random values, then a constructed tie
            for what, x in (("random", cp.clone()), ("tie", cp.clone())):
                if what == "tie":
                    i1, i2 = sorted(rng.choice(x.numel(), 2, replace=False))
                    x[i2] = x[i1] = x.max() + 1.0
                run = (torch.zeros((), dtype=dtype, device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev))
                mk, ik = courant_argmax(x, dt, *run)
                mp, ip = courant_argmax_plain(x)
                exact = (float(mk) == float(mp) and int(ik) == int(ip)
                         and float(run[0]) == float(mp * dt)
                         and int(run[1]) == int(ip))
                if what == "tie":
                    exact = exact and int(ik) == int(i1)
                errs["courant_argmax"] = max(
                    errs.get("courant_argmax", 0.0), abs(float(mk) - float(mp)))
                log(f"  {'courant_argmax':15s} {tag + ' ' + what:48s} "
                    f"idx {int(ik)} (plain {int(ip)}) "
                    f"{'ok' if exact else 'FAIL'}")
                if not exact:
                    failures.append(f"courant_argmax {tag} {what}")
    # K1c: NaN, infinities, signed zeros, one value, odd sizes and slices
    # that start off a 16-byte boundary, against the plain version exactly
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(rng.uniform(0, 1, 70_001), dtype=dtype,
                            device=dev)
        nan = x.clone()
        nan[[5, 60_000]] = float("nan")
        cases = {"n=1": x[:1], "n=4097": x[:4097], "nan": nan,
                 "+inf tie": torch.tensor([1.0, float("inf"), 3.0,
                                           float("inf")], dtype=dtype,
                                          device=dev),
                 "-inf": torch.full((9,), -float("inf"), dtype=dtype,
                                    device=dev),
                 "signed zeros": torch.tensor([-0.0, 0.0, -0.0],
                                              dtype=dtype, device=dev),
                 **{f"slice at +{o}": x[o:] for o in (1, 2, 3)}}
        dt = torch.tensor(0.5, dtype=dtype, device=dev)
        for what, v in cases.items():
            run = (torch.full((), 0.25, dtype=dtype, device=dev),
                   torch.full((), -1, dtype=torch.int32, device=dev))
            run_p = tuple(r.clone() for r in run)
            mk, ik = courant_argmax(v, dt, *run)
            mp, ip = courant_argmax_plain(v, dt, *run_p)
            exact = ((float(mk) == float(mp) or (np.isnan(float(mk))
                                                 and np.isnan(float(mp))))
                     and int(ik) == int(ip) and int(run[1]) == int(run_p[1])
                     and (torch.equal(run[0], run_p[0])
                          or bool(run[0].isnan() and run_p[0].isnan())))
            log(f"  {'courant_argmax':15s} {str(dtype)[6:] + ' ' + what:48s} "
                f"idx {int(ik)} (plain {int(ip)}) {'ok' if exact else 'FAIL'}")
            if not exact:
                failures.append(f"courant_argmax {dtype} {what}")
    check_one_kernel(lambda: courant_argmax(x, dt, *run),
                     "courant_argmax on 70,001 values")
    # K2 on a 256x176 raster, f32
    nx, ny = 256, 176
    f32 = torch.float32

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=f32, device=dev)

    h = rng.uniform(0.05, 1.0, nx * ny)
    h = np.where(rng.uniform(size=h.size) < 0.25, rng.uniform(0, 5e-8, h.size),
                 h)
    h = np.where(rng.uniform(size=h.size) < 0.1, 0.0, h)
    q = t([h, h * rng.normal(0, 0.4, h.size), h * rng.normal(0, 0.4, h.size)])
    qA = t([h[::-1], h * rng.normal(0, 0.4, h.size), np.zeros(h.size)])
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.002, 0.002, 1e-7, 0.0, bc_left=0,
                          bc_right=2, bc_bottom=2, bc_top=1)
    bc_vals = {"left": t([rng.uniform(0.1, 0.6, ny), rng.normal(0, 0.1, ny),
                          rng.normal(0, 0.1, ny)])}
    dt = torch.tensor(0.002, dtype=f32, device=dev)
    modes = [("rhs", dict(emit_prim=True))] + [
        (f"stage {i + 1}", dict(stage=s, qA=qA if i else None,
                                emit_prim=True))
        for i, s in enumerate(FUSED_STAGES["ssprk3"])
    ]
    for rain in (False, True):
        src = t(rng.uniform(0.0, 1e-2, (ny, nx))) if rain else None
        for mode, extra in modes:
            tag = f"raster 256x176 f32 rain {'on' if rain else 'off'} {mode}"
            got = swe_raster_step(plan, q, *geo, dt, src=src, bc_vals=bc_vals,
                                  **extra)
            want = swe_raster_step_plain(plan, q, *geo, dt, src=src,
                                         bc_vals=bc_vals, **extra)
            for field in ("out", "prim", "cmax"):
                check("swe_raster_step", f"{tag} {field}",
                      getattr(got, field), getattr(want, field), f32)
            run = (torch.zeros((), dtype=f32, device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev))
            courant_argmax(got.cmax, dt, *run)
            check("swe_raster_step", f"{tag} courant fold", run[0],
                  want.cmax.max() * dt, f32)
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")


# ------------------------------------------------------------------ phase 3
def dam_break_dict(steps, backend="xla", scheme="euler"):
    """The dam-break deck of both main paths as a config dictionary."""
    return {
        "physics": {"flow": {"mode": "swe"}},
        "numerics": {"spatial": "fv", "temporal": scheme, "riemann": "roe",
                     "precision": "single", "edge_flux_backend": backend},
        "logging": {"level": "none"},
        "time": {"stop": steps * DT, "unit": "seconds", "time_step": DT,
                 "coupling_interval": 0.1},
        "output": {"format": "none", "time_series": {"boundary_fluxes": 100}},
        "regions": [{"name": "reservoir", "grid_region_id": 1},
                    {"name": "floodplain", "grid_region_id": 2}],
        "surface_composition": [
            {"region": "reservoir", "material": "smooth"},
            {"region": "floodplain", "material": "smooth"}],
        "materials": [{"name": "smooth",
                       "properties": {"manning": {"value": 0.018}}}],
        "initial_conditions": [{"region": "reservoir", "flow": "column"},
                               {"region": "floodplain", "flow": "wet_bed"}],
        "boundaries": [{"name": "left", "grid_boundary_id": 1},
                       {"name": "right", "grid_boundary_id": 2}],
        "boundary_conditions": [{"boundaries": ["right"], "flow": "outflow"}],
        "flow_conditions": [
            {"name": "column", "type": "dirichlet", "height": H_RESERVOIR,
             "x_momentum": 0, "y_momentum": 0},
            {"name": "wet_bed", "type": "dirichlet", "height": H_FLOODPLAIN,
             "x_momentum": 0, "y_momentum": 0},
            {"name": "outflow", "type": "critical-outflow"}],
    }


def dam_break_config(steps, backend="xla", scheme="euler"):
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    return config_from_dict(dam_break_dict(steps, backend, scheme)).validate()


def tracer_dam_break_config(steps, backend="xla", scheme="euler"):
    """The dam break with two sediment classes and salinity (ndof = 6): the
    reservoir holds sediment, and salt has one concentration everywhere
    (the initial conditions give tracer masses h*c)."""
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    d = dam_break_dict(steps, backend, scheme)
    d["physics"].update({"sediment": {"num_classes": 2}, "salinity": True})
    d["initial_conditions"] = [
        {"region": "reservoir", "flow": "column", "sediment": "mud",
         "salinity": "salt_deep"},
        {"region": "floodplain", "flow": "wet_bed", "salinity": "salt_shallow"}]
    d["sediment_conditions"] = [{
        "name": "mud", "c0": {"value": H_RESERVOIR * SEDIMENT_C[0]},
        "c1": {"value": H_RESERVOIR * SEDIMENT_C[1]}}]
    d["salinity_conditions"] = [
        {"name": "salt_deep", "concentration": H_RESERVOIR * SALINITY_C},
        {"name": "salt_shallow", "concentration": H_FLOODPLAIN * SALINITY_C}]
    return config_from_dict(d).validate()


def plain_operator(op):
    """The operator's linearization twin (`operator.linearization_twin`:
    every kernel replaced by its plain version, run on the card's tensors),
    for holding the kernels' run against. Its `donor_counts` collects, per
    positivity pass, the number of cells whose donor factor is below 1."""
    from rdycore_tpu_torch.operator import LinearizationTwin
    from rdycore_tpu_torch.ops.kernels.muscl import (
        positivity_drain_plain, positivity_scale_plain)

    class PlainSWEOperator(LinearizationTwin):
        donor_counts = []

        def limit_positivity(self, flux, h, dt):
            s = positivity_drain_plain(self.arrays, flux, h, dt)
            self.donor_counts.append(int((s < 1.0).sum()))
            return positivity_scale_plain(self.arrays, flux, s)

    return PlainSWEOperator(**{f.name: getattr(op, f.name)
                               for f in dataclasses.fields(op)})


def edge_flux_bytes(Ei, Eb, q_bytes, s, ndof=3):
    """Bytes K1a must move over Ei interior and Eb boundary edges, reading
    q_bytes of the state (ndof rows): each input read once, each output
    written once."""
    E = Ei + Eb
    return (q_bytes + Ei * (4 + 4 + s + s) + Eb * (4 + s + s + 1 + ndof * s)
            + E * s + ndof * (E + 1) * s + E * s)


def courant_bytes(n, s):
    """Bytes K1c must move to fold n Courant values into the running
    maximum: the values, dt, and the running maximum and index."""
    return n * s + s + 4


def kernel_bytes(op, q_bytes, s, rhs=False):
    """Bytes each kernel must move at the main path's configuration (euler
    stage with primitives, no external source; with `rhs`, K1b in rhs mode
    writing flux_div, rhs and primitives), over the operator's ndof rows:
    each input read once, each output written once."""
    C, Ei, Eb = op.num_cells, op.num_internal_edges, op.num_boundary_edges
    E, K, nd = Ei + Eb, op.arrays.cell_edges.shape[1], op.ndof
    k1b = (nd * (E + 1) * s + C * K * (4 + s) + q_bytes + s + 3 * C * s
           + q_bytes * (3 if rhs else 2))
    return {"swe_edge_flux": edge_flux_bytes(Ei, Eb, q_bytes, s, nd),
            "swe_cell_stage": k1b, "courant_argmax": courant_bytes(E, s)}


def raster_step_bytes(C, ndof, blocks, s):
    """Bytes K2 must move in an euler stage with the primitives: q and the
    three geometry planes read, out and prim written, the block maxima."""
    return s * ((3 * ndof + 3) * C + blocks + 1)


def kernel_row(card, name, path, fns, launches, err, nbytes, nops, dtype,
               replaces=REPLACES, **extra):
    """One entry of the {"kernels": [...]} line, logged. fns = (the
    kernel's call, its plain version's, one PyTorch call that computes the
    same function or None), each timed here; the bound from nbytes and
    nops; "timers" names the timer that gave each time (`device_time`, or
    CUDA events where its time is under the HBM time of the bytes beyond
    the L2's 50 MB; the plain version's between CUDA events)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nops / PEAK_OPS_PER_S[dtype]
    # all but the L2's worth of the bytes come from HBM: a time under this
    # floor means that both profiler sessions dropped records of the call
    t_floor = 1e3 * max(nbytes - L2_BYTES, 0.0) / HBM_BYTES_PER_S
    # the plain version (hundreds of small launches a call, host-bound)
    # between CUDA events: the profiler's two sessions over it cost a
    # second or more a row
    times = [None if f is None else
             (cuda_ms(f, reps=5), "cuda events") if i == 1 else
             device_time(f, reps=20) for i, f in enumerate(fns)]
    for i, (f, t) in enumerate(zip(fns, times)):
        if t is not None and t[0] < t_floor:
            log(f"  {name}: profiler time {t[0]:.4f} ms under the "
                f"{t_floor:.4f} ms that HBM takes for the bytes the L2 "
                "cannot hold; timing between CUDA events instead")
            times[i] = (cuda_ms(f), "cuda events")
    ms, plain_ms, lib_ms = (None if t is None else t[0] for t in times)
    row = {
        "name": name, "path": path, "route": "cuda", "source": SOURCES[name],
        "replaces": replaces[name], "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, **extra,
        "timers": {k: None if t is None else t[1] for k, t in
                   zip(("ms", "plain_ms", "library_ms"), times)},
    }
    log(f"  [{card}] {name} on the {path} path: device {ms:.4f} ms/call "
        f"(between CUDA events {cuda_ms(fns[0]):.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({nbytes / 1e6:.3f} MB, {nops / 1e9:.4f} Gop), bound/time "
        f"{100 * row['bound_ms'] / ms:.1f}%, "
        + (f"one PyTorch call {lib_ms:.4f} ms" if lib_ms is not None
           else "no single PyTorch call computes it"))
    return row


def dam_break_mesh(nx=2048, ny=1408):
    """The full-size raster of both main paths."""
    from rdycore_tpu_torch.mesh import structured_quad

    lx, ly = nx * DX, ny * DX
    t0 = time.perf_counter()
    mesh = structured_quad(nx, ny, 0.0, lx, 0.0, ly,
                           region_fn=lambda cx, cy: np.where(cx < lx / 2, 1, 2))
    log(f"== mesh: {nx}x{ny} raster of {DX} m cells, {mesh.num_cells} cells, "
        f"{mesh.num_edges} edges in {time.perf_counter() - t0:.2f} s")
    return mesh


MESH_NPZ = {}  # id of a mesh -> the .npz written of it


def dam_break_npz(mesh, link):
    """Phases 11-13's .npz of the dam-break mesh, written once (some 10 s
    at full size) into output/chip_smoke_mesh/, and linked as `link`."""
    import os

    from rdycore_tpu_torch.mesh import save_mesh_npz

    path = MESH_NPZ.get(id(mesh))
    if path is None or not os.path.exists(path):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "output", "chip_smoke_mesh", "dam_break.npz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t0 = time.perf_counter()
        save_mesh_npz(mesh, path)
        log(f"  mesh written once as .npz in {time.perf_counter() - t0:.2f} "
            "s (phases 11-13 read it)")
        MESH_NPZ[id(mesh)] = path
    os.symlink(path, link)


def check_launches(path, launches, expected):
    """Fail unless the path launched each kernel exactly as expected (a
    kernel that `expected` does not name: never)."""
    log(f"  launches over the {path}: {launches}")
    unknown = set(expected) - set(launches)
    expected = {k: expected.get(k, 0) for k in launches}
    if unknown or launches != expected:
        raise SystemExit(f"{path}: launches {launches}, expected {expected}")


def check_state_and_budget(sim, q0, area, min_h=0.0):
    """h finite and >= min_h, and the volume lost (from the initial state
    q0) equal to the outflow through the accumulated boundary fluxes, to
    1e-4 of the initial volume."""
    h = sim.get_height()
    if not (np.all(np.isfinite(sim.get_solution())) and h.min() >= min_h):
        raise SystemExit(f"bad state: finite={np.isfinite(h).all()}, "
                         f"min h {h.min()}")
    v0 = float(np.sum(q0[0] * area))
    v1 = float(np.sum(h.astype(np.float64) * area))
    lens = sim.operator.arrays.bnd_len.cpu().numpy().astype(np.float64)
    outflow = float(np.sum(sim.bflux_accum[0] * lens))
    budget = abs((v0 - v1) - outflow) / v0
    log(f"  volume: initial {v0:.9e} m^3, final {v1:.9e}, lost {v0 - v1:.6e}, "
        f"outflow {outflow:.6e}, budget error {budget:.3e} of the initial "
        f"volume")
    if not budget <= 1e-4:
        raise SystemExit(f"volume budget error {budget} > 1e-4")
    if not outflow > 0.0:
        raise SystemExit("no outflow through the critical-outflow boundary")


def rows_rel_err(a, b):
    """The worst over rows of each row's error relative to its largest
    magnitude (a row of zeros in both counts 0)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return max(rel_err(a[k], b[k]) for k in range(a.shape[0]))


def vector_rel_err(a, b):
    """Like `rows_rel_err`, but the momentum rows (1 and 2) relative to
    the larger of their two largest magnitudes: where the flow runs along
    x, hv is float32 rounding noise (1e-9 on phase 13b's mixed mesh, whose
    triangles break the raster's symmetry) that no row-wise bound fits."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    errs = [rel_err(a[k], b[k]) for k in range(a.shape[0])]
    mom = max(float(b[1:3].double().abs().max()), 1e-30)
    for k in (1, 2):
        errs[k] = abs_err(a[k], b[k]) / mom
    return max(errs)


def path_operator(sim):
    """The operator whose kernels the simulation's steps launch (the first
    strip's, on a strip deck)."""
    if not sim._structured:
        return sim.operator
    op = sim._structured["op"]
    return op[0] if isinstance(op, list) else op


def run_main_path(path, make_sim, steps, per_step, check):
    """Drive one main path at full size through `Simulation`, as a user
    does. make_sim(n, plain=False) builds the deck for n steps (its kernels
    replaced by their plain versions when `plain`). 10 steps on the kernels
    are held against 10 on the plain versions: every row of q and of the
    accumulators, and the Courant number, to relative 1e-4. Then `steps`
    steps through advance and run, with every launch count set to 0 just
    before: each kernel must have been launched per_step[name] times a step
    (a kernel per_step does not name: never), and check(sim, q0) (q0 the
    initial state in f64) must pass. Returns the simulation and the
    launches."""
    from rdycore_tpu_torch.ops import kernels

    card = nvidia_smi_line()
    sim_k, sim_p = make_sim(10), make_sim(10, plain=True)
    sim_k.run()
    sim_p.run()
    torch.cuda.synchronize()
    if sim_k.step != 10 or sim_p.step != 10:
        raise SystemExit(f"10-step runs took {sim_k.step}/{sim_p.step} steps")
    r10 = {"q": rows_rel_err(sim_k.q, sim_p.q)}
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        r10[name] = rows_rel_err(getattr(sim_k, name), getattr(sim_p, name))
    ck, cp = sim_k.prev_max_courant, sim_p.prev_max_courant
    r10["courant"] = abs(ck - cp) / max(abs(cp), 1e-30)
    log(f"  10 steps, kernels vs plain versions (worst row): "
        + ", ".join(f"{k} {v:.3e}" for k, v in r10.items())
        + f"; courant {ck:.9f} vs {cp:.9f}")
    counts = path_operator(sim_p).donor_counts
    if counts:
        log(f"  cells with donor factor s < 1 (plain run, per stage): first "
            f"step {counts[:2]}, all 10 steps {sum(counts)} over "
            f"{len(counts)} stages")
    if not all(v <= 1e-4 for v in r10.values()):
        raise SystemExit(f"10-step {path} run differs from plain: {r10}")
    del sim_k, sim_p

    t0 = time.perf_counter()
    sim = make_sim(steps)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    q0 = sim.get_solution().astype(np.float64)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sim.advance()  # first interval: the kernel libraries load
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    s_first = sim.step
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    n_steady = sim.step - s_first
    if sim.step != steps:
        raise SystemExit(f"{path} took {sim.step} steps, expected {steps}")
    check_launches(path, launches,
                   {k: n * steps for k, n in per_step.items()})
    check(sim, q0)
    rate = n_steady * sim.q.shape[1] / t_steady
    STEADY[path] = (1e3 * t_steady / n_steady, rate)
    log(f"  [{card}] setup {t_setup:.2f} s; first interval {t_first:.3f} s "
        f"({s_first} steps); steady state {t_steady:.3f} s for {n_steady} "
        f"steps = {1e3 * t_steady / n_steady:.4f} ms/step, {rate:.4e} "
        f"cell-updates/s; max Courant {sim.prev_max_courant:.4f}")
    return sim, launches


def unstructured_simulation(steps, dev, mesh, plain=False,
                            config=dam_break_config):
    """The dam break (`config`) on the unstructured path, its kernels
    replaced by their plain versions when `plain`."""
    from rdycore_tpu_torch import Simulation

    sim = Simulation(config(steps), mesh=mesh, device=dev)
    if plain:
        sim.operator = plain_operator(sim.operator)
    return sim


def phase_main(steps, errs, dev, mesh):
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain

    log(f"== phase 3: unstructured main path, dam break on {mesh.num_cells:,} "
        "cells, f32")
    card = nvidia_smi_line()
    sim, launches = run_main_path(
        "unstructured main path",
        lambda n, plain=False: unstructured_simulation(n, dev, mesh, plain),
        steps, {"swe_edge_flux": 1, "swe_cell_stage": 1, "courant_argmax": 1},
        lambda sim, q0: check_state_and_budget(sim, q0, mesh.cell_area))

    # each kernel at the main path's shapes: time, plain time, bound
    op, q, bv = sim.operator, sim.q, sim.boundary_values
    a, s = op.arrays, q.element_size()
    dt = torch.tensor(DT, dtype=q.dtype, device=dev)
    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
              xq2018_threshold=op.xq2018_threshold,
              source_method=op.source_method)
    stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
    flux, courant = op.edge_flux(q, bv)
    fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
    ok_ = op.cell_stage(flux, q, dt, None, **stage)
    op_ = swe_cell_stage_plain(a, flux, q, dt, None, **kw, **stage)
    run = (torch.zeros((), dtype=q.dtype, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    mk, ik = op.courant_max(courant, dt, *run)
    mp, ip = courant_argmax_plain(courant)
    checks = {
        "swe_edge_flux": max(rel_err(flux, fp), rel_err(courant, cp)),
        "swe_cell_stage": max(rel_err(ok_.q_out, op_.q_out),
                              rel_err(ok_.prim, op_.prim)),
    }
    main_abs = {
        "swe_edge_flux": max(abs_err(flux, fp), abs_err(courant, cp)),
        "swe_cell_stage": max(abs_err(ok_.q_out, op_.q_out),
                              abs_err(ok_.prim, op_.prim)),
        "courant_argmax": abs(float(mk) - float(mp)),
    }
    log(f"  full-size kernels vs plain: {checks}; courant idx {int(ik)} "
        f"(plain {int(ip)})")
    if any(r > TOL[q.dtype] for r in checks.values()) or int(ik) != int(ip):
        raise SystemExit("full-size kernel check failed")
    check_one_kernel(lambda: op.courant_max(courant, dt, *run),
                     f"courant_argmax on {courant.numel():,} edge values")

    calls = {
        "swe_edge_flux": (
            lambda: op.edge_flux(q, bv),
            lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga),
            None),
        "swe_cell_stage": (
            lambda: op.cell_stage(flux, q, dt, None, **stage),
            lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw, **stage),
            None),
        "courant_argmax": (
            lambda: op.courant_max(courant, dt, *run),
            lambda: courant_argmax_plain(courant, dt, *run),
            lambda: torch.max(courant, 0)),
    }
    nbytes = kernel_bytes(op, q.numel() * s, s)
    nops = {"swe_edge_flux": OPS_PER_EDGE * op.num_edges,
            "swe_cell_stage": OPS_PER_CELL * op.num_cells,
            "courant_argmax": OPS_PER_VALUE * op.num_edges}
    rows = [kernel_row(card, name, "unstructured", fns, launches[name],
                       max(errs.get(name, 0.0), main_abs[name]),
                       nbytes[name], nops[name], q.dtype)
            for name, fns in calls.items()]
    # rhs mode (rk4 and apply), and apply = K1a + K1c + K1b rhs
    pop = plain_operator(op)
    rhs_ms = device_ms(lambda: op.cell_stage(flux, q, dt, None,
                                             emit_prim=True))
    rhs_plain = device_ms(lambda: pop.cell_stage(flux, q, dt, None,
                                                 emit_prim=True), reps=5)
    rhs_bound = 1e3 * kernel_bytes(op, q.numel() * s, s, rhs=True)[
        "swe_cell_stage"] / HBM_BYTES_PER_S
    apply_ms = device_ms(lambda: op.apply(q, dt, bv, None))
    apply_plain = device_ms(lambda: pop.apply(q, dt, bv, None), reps=5)
    apply_bound = (rows[0]["bound_ms"] + rows[2]["bound_ms"] + rhs_bound)
    log(f"  [{card}] swe_cell_stage in rhs mode: device {rhs_ms:.4f} ms/call, "
        f"plain {rhs_plain:.4f} ms, bound {rhs_bound:.4f} ms; "
        f"SWEOperator.apply (K1a + K1c + K1b rhs): device {apply_ms:.4f} ms, "
        f"plain {apply_plain:.4f} ms, sum of its kernels' bounds "
        f"{apply_bound:.4f} ms")
    kern_ms = sum(r["ms"] for r in rows)
    log(f"  [{card}] kernel device time per step {kern_ms:.4f} ms")
    return rows


def plain_raster_operator(op):
    """The raster path's operator with every kernel replaced by its plain
    version (run on the card's tensors); `donor_counts` as for
    `plain_operator`, per second-order step or stage."""
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_muscl import (
        TILE, donor_factors, raster_muscl_faces_plain,
        raster_muscl_update_plain)
    from rdycore_tpu_torch.ops.kernels.raster_step import (
        RasterStepOut, block_max, swe_raster_step_plain)
    from rdycore_tpu_torch.ops.structured import FusedStructuredOperator

    class PlainFusedStructuredOperator(FusedStructuredOperator):
        donor_counts = []

        def step(self, q, dt, src=None, bc_vals=None, **mode):
            if self.second_order:
                # raster_muscl_step_plain's parts, to count the donors
                fx, fy, own = raster_muscl_faces_plain(
                    self.plan, q, bc_vals, self.limiter, self.strip)
                s = donor_factors(self.plan, q, fx, fy, dt, self.strip)
                self.donor_counts.append(int((s < 1.0).sum()))
                out, prim = raster_muscl_update_plain(
                    self.plan, q, fx, fy, self.dz_dx, self.dz_dy,
                    self.mannings_n, dt, src=src, strip=self.strip, **mode)
                return RasterStepOut(out, prim, block_max(
                    own, self.plan.nx, own.shape[0], TILE))
            return swe_raster_step_plain(
                self.plan, q, self.dz_dx, self.dz_dy, self.mannings_n, dt,
                src=src, bc_vals=bc_vals, num_sediment=self.num_sediment,
                upwind=self.riemann == "upwind_roe", strip=self.strip,
                **mode)

        def courant_max(self, cmax_blocks, dt, run_max, run_idx):
            return courant_argmax_plain(cmax_blocks, dt, run_max, run_idx)

        def boundary_fluxes(self, q, bv_edges):
            flux, _ = swe_edge_flux_plain(self.bnd, q, bv_edges,
                                          self.plan.tiny_h, self.plan.h_anuga)
            return flux[:, :-1]

    return PlainFusedStructuredOperator(**{f.name: getattr(op, f.name)
                                           for f in dataclasses.fields(op)})


def raster_simulation(steps, dev, mesh, scheme="euler", plain=False,
                      config=dam_break_config):
    """The dam break (`config`) with edge_flux_backend: fused_structured."""
    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.ops.structured import make_fused_structured_stepper

    sim = Simulation(config(steps, "fused_structured", scheme),
                     mesh=mesh, device=dev)
    st = sim._structured
    if st["kind"] != "fused":
        raise SystemExit(f"the raster deck took the {st['kind']} path")
    if plain:
        st["op"] = plain_raster_operator(st["op"])
        st["adv"] = make_fused_structured_stepper(
            st["op"], st["scheme"], accumulate=st["accumulate"],
            lin_op=st["lin_op"])
    return sim


def phase_raster(steps, errs, dev, mesh):
    from rdycore_tpu_torch.ops import kernels
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_step import swe_raster_step_plain

    log(f"== phase 4: raster main path (fused_structured), dam break on "
        f"{mesh.num_cells:,} cells, f32")
    card = nvidia_smi_line()
    area = mesh.cell_area
    sim, launches = run_main_path(
        "raster main path",
        lambda n, plain=False: raster_simulation(n, dev, mesh, plain=plain),
        steps, {"swe_edge_flux": 1, "courant_argmax": 1, "swe_raster_step": 1},
        lambda sim, q0: check_state_and_budget(sim, q0, area))
    # phase 8 runs the same steps in row strips and must end here bit for
    # bit
    REFERENCE["raster"] = final_state(sim)

    # ssprk3 (stage mode with qA) and rk4 (rhs mode) at full size
    for scheme, per_step in (("ssprk3", 3), ("rk4", 4)):
        n = 24
        s2 = raster_simulation(n, dev, mesh, scheme)
        q0 = s2.get_solution().astype(np.float64)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s2.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_launches(f"raster {scheme} run of {n} steps",
                       {k.__name__: k.launches for k in kernels.KERNELS}, {
                           "swe_edge_flux": n, "courant_argmax": n,
                           "swe_raster_step": per_step * n})
        check_state_and_budget(s2, q0, area)
        log(f"  [{card}] raster {scheme}: {n} steps in {wall:.3f} s "
            f"(first interval included) = {1e3 * wall / n:.4f} ms/step")
        del s2

    # each kernel at the main path's shapes against its plain version: K2
    # in an euler stage with the primitives and in rhs mode, K1c on that
    # stage's block maxima, K1a on the boundary edges
    op, q = sim._structured["op"], sim.q
    bv = sim.boundary_values.to(q.dtype)
    th, ta = op.plan.tiny_h, op.plan.h_anuga
    C, Eb = q.shape[1], op.bnd.bnd_left.shape[0]
    dt = torch.tensor(DT, dtype=q.dtype, device=dev)
    modes = {"stage": dict(stage=(0.0, 1.0, 1.0), emit_prim=True),
             "rhs": dict(emit_prim=True)}
    # K2's phase 2 errors count too (phase 2 ran K1a and K1c at other shapes)
    main_abs = {"swe_raster_step": errs.get("swe_raster_step", 0.0)}
    for mode, kw in modes.items():
        got = op.step(q, dt, **kw)
        want = swe_raster_step_plain(op.plan, q, op.dz_dx, op.dz_dy,
                                     op.mannings_n, dt, **kw)
        r = max(rel_err(g, w) for g, w in zip(got, want))
        main_abs["swe_raster_step"] = max(
            main_abs["swe_raster_step"],
            max(abs_err(g, w) for g, w in zip(got, want)))
        log(f"  full-size swe_raster_step vs plain, {mode} mode: rel {r:.3e}")
        if not r <= TOL[q.dtype]:
            raise SystemExit("full-size raster kernel check failed")
        if mode == "stage":
            blocks = got.cmax
    run = (torch.zeros((), dtype=q.dtype, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    mk, ik = op.courant_max(blocks, dt, *run)
    mp, ip = courant_argmax_plain(blocks)
    exact = (float(mk) == float(mp) and int(ik) == int(ip)
             and float(run[0]) == float(mp * dt))
    main_abs["courant_argmax"] = abs(float(mk) - float(mp))
    log(f"  full-size courant_argmax on {blocks.numel()} block maxima vs "
        f"plain: max {float(mk):.9f} (plain {float(mp):.9f}), idx {int(ik)} "
        f"(plain {int(ip)}) {'ok' if exact else 'FAIL'}")
    if not exact:
        raise SystemExit("full-size raster Courant fold differs from plain")
    check_one_kernel(lambda: op.courant_max(blocks, dt, *run),
                     f"courant_argmax on {blocks.numel():,} block maxima")
    fk = op.boundary_fluxes(q, bv)
    fp = swe_edge_flux_plain(op.bnd, q, bv, th, ta)[0][:, :-1]
    rb = max(rel_err(fk[k], fp[k]) for k in range(3))
    main_abs["swe_edge_flux"] = abs_err(fk, fp)
    log(f"  full-size swe_edge_flux on the {Eb} boundary edges vs plain: "
        f"rel {rb:.3e} (worst of the h, hu, hv rows)")
    if not rb <= TOL[q.dtype]:
        raise SystemExit("full-size raster boundary-flux check failed")

    calls = {
        "swe_raster_step": (
            lambda: op.step(q, dt, **modes["stage"]),
            lambda: swe_raster_step_plain(op.plan, q, op.dz_dx, op.dz_dy,
                                          op.mannings_n, dt, **modes["stage"]),
            None),
        "swe_edge_flux": (
            lambda: op.boundary_fluxes(q, bv),
            lambda: swe_edge_flux_plain(op.bnd, q, bv, th, ta),
            None),
        "courant_argmax": (
            lambda: op.courant_max(blocks, dt, *run),
            lambda: courant_argmax_plain(blocks, dt, *run),
            lambda: torch.max(blocks, 0)),
    }
    s = q.element_size()
    # K2: q, the three geometry planes, out and prim, the block maxima;
    # K1a: the boundary cells' state and the boundary edges' arrays
    nbytes = {
        "swe_raster_step": raster_step_bytes(C, 3, blocks.numel(), s),
        "swe_edge_flux": edge_flux_bytes(
            0, Eb, 3 * s * int(torch.unique(op.bnd.bnd_left).numel()), s),
        "courant_argmax": courant_bytes(blocks.numel(), s),
    }
    nops = {"swe_raster_step": OPS_PER_RASTER_CELL * C,
            "swe_edge_flux": OPS_PER_EDGE * Eb,
            "courant_argmax": OPS_PER_VALUE * blocks.numel()}
    # K1a stands in for the edge kernel on the boundary edges; K1c folds
    # the per-tile Courant maxima that the raster step kernel writes
    replaces = dict(REPLACES,
                    swe_edge_flux="rdycore_tpu/ops/pallas/slotted.py:1254",
                    courant_argmax=REPLACES["swe_raster_step"])
    rows = [kernel_row(card, name, "raster", fns, launches[name],
                       main_abs[name], nbytes[name], nops[name], q.dtype,
                       replaces)
            for name, fns in calls.items()]
    log(f"  [{card}] swe_raster_step in rhs mode: device "
        f"{device_ms(lambda: op.step(q, dt, **modes['rhs'])):.4f} ms/call; "
        "no single PyTorch call computes it")
    return rows


# ------------------------------------------------------------------ phase 5
def tracer_rows(q, bv, ext, rng):
    """q, bv and ext of random_state with NT tracer rows: masses h*c in q,
    Dirichlet masses in bv, small external sources in ext."""
    def add(x, rows):
        return torch.cat([x, torch.as_tensor(rows, dtype=x.dtype,
                                             device=x.device)])

    C, Eb = q.shape[1], bv.shape[1]
    h, hb = q[0].cpu().numpy(), bv[0].cpu().numpy()
    return (add(q, h * rng.uniform(0.0, 0.5, (NT, C))),
            add(bv, hb * rng.uniform(0.0, 0.2, (NT, Eb))),
            add(ext, rng.normal(0.0, 1e-4, (NT, C))))


def phase_tracer_kernels(seed, errs, dev):
    """K1a, K1b and K2 at NT = 3 against their plain versions at 256x176,
    Roe and upwind-Roe, every BC code."""
    from rdycore_tpu_torch.mesh import structured_quad, structured_tri
    from rdycore_tpu_torch.operator import build_operator
    from rdycore_tpu_torch.ops.kernels.cell_stage import (
        swe_cell_stage, swe_cell_stage_plain)
    from rdycore_tpu_torch.ops.kernels.edge_flux import (
        swe_edge_flux, swe_edge_flux_plain)
    from rdycore_tpu_torch.ops.kernels.raster_step import (
        StructuredPlan, swe_raster_step, swe_raster_step_plain)
    from rdycore_tpu_torch.ops.structured import FUSED_STAGES
    from rdycore_tpu_torch.timestepping import _FUSED_STEP_STAGES

    log(f"== phase 5a: the NT = {NT} kernels ({NUM_SEDIMENT} sediment "
        "classes and salinity) against their plain versions")
    rng = np.random.default_rng(seed + 5)
    meshes = {
        "quad 256x176": structured_quad(256, 176, 0.0, 0.512, 0.0, 0.352),
        "tri 128x88": structured_tri(128, 88, 0.0, 0.512, 0.0, 0.352),
    }
    bc = {"left": 0, "right": 2, "top": 1, "bottom": 0}  # all three codes
    failures = []

    def check(kernel, what, got, want, dtype):
        r, a = rel_err(got, want), abs_err(got, want)
        key = f"{kernel} nt{NT}"
        errs[key] = max(errs.get(key, 0.0), a)
        ok = r <= TOL[dtype] and got.shape == want.shape
        log(f"  {kernel:15s} {what:56s} rel {r:.3e} abs {a:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {what}")

    for mname, mesh in meshes.items():
        for dtype in (torch.float32, torch.float64):
            for riemann in ("roe", "upwind_roe"):
                tag = f"{mname} {str(dtype)[6:]} {riemann}"
                upwind = riemann == "upwind_roe"
                op = build_operator(
                    mesh, bc_types=bc,
                    mannings_n=rng.uniform(0.01, 0.05, mesh.num_cells),
                    num_tracers=NT, num_sediment=NUM_SEDIMENT,
                    riemann=riemann, dtype=dtype, device=dev)
                a = op.arrays
                q, bv, ext = tracer_rows(*random_state(op, rng, dtype, dev),
                                         rng)
                qA, _, _ = tracer_rows(*random_state(op, rng, dtype, dev),
                                       rng)
                fk, ck = swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga,
                                       upwind)
                fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h,
                                             op.h_anuga, upwind)
                check("swe_edge_flux", f"{tag} flux", fk, fp, dtype)
                check("swe_edge_flux", f"{tag} courant", ck, cp, dtype)
                dt = torch.tensor(0.002, dtype=dtype, device=dev)
                for method in (0, 2):
                    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                              xq2018_threshold=op.xq2018_threshold,
                              source_method=method,
                              num_sediment=NUM_SEDIMENT)
                    modes = [("rhs", dict(emit_prim=True))] + [
                        (f"stage {i + 1}",
                         dict(stage=st, qA=qA if i else None, emit_prim=True))
                        for i, st in enumerate(_FUSED_STEP_STAGES["ssprk3"])]
                    for mode, extra in modes:
                        got = swe_cell_stage(a, fp, q, dt, ext, **kw, **extra)
                        want = swe_cell_stage_plain(a, fp, q, dt, ext, **kw,
                                                    **extra)
                        for field in ("q_out", "flux_div", "rhs", "prim"):
                            if getattr(want, field) is not None:
                                check("swe_cell_stage",
                                      f"{tag} src{method} {mode} {field}",
                                      getattr(got, field),
                                      getattr(want, field), dtype)
    # K2 at NT = 3 on a 256x176 raster, f32, the rain plane on
    nx, ny = 256, 176
    f32 = torch.float32

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=f32, device=dev)

    h = rng.uniform(0.05, 1.0, nx * ny)
    h = np.where(rng.uniform(size=h.size) < 0.25, rng.uniform(0, 5e-8, h.size),
                 h)
    h = np.where(rng.uniform(size=h.size) < 0.1, 0.0, h)
    q = t(np.concatenate([[h, h * rng.normal(0, 0.4, h.size),
                           h * rng.normal(0, 0.4, h.size)],
                          h * rng.uniform(0.0, 0.5, (NT, h.size))]))
    qA = q.flip(1).contiguous()
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.002, 0.002, 1e-7, 0.0, bc_left=0,
                          bc_right=2, bc_bottom=2, bc_top=1)
    hl = rng.uniform(0.1, 0.6, ny)
    bc_vals = {"left": t(np.concatenate([
        [hl, rng.normal(0, 0.1, ny), rng.normal(0, 0.1, ny)],
        hl * rng.uniform(0.0, 0.2, (NT, ny))]))}
    src = t(rng.uniform(0.0, 1e-2, (ny, nx)))
    dt = torch.tensor(0.002, dtype=f32, device=dev)
    modes = [("rhs", dict(emit_prim=True))] + [
        (f"stage {i + 1}", dict(stage=st, qA=qA if i else None,
                                emit_prim=True))
        for i, st in enumerate(FUSED_STAGES["ssprk3"])]
    for upwind in (False, True):
        for mode, extra in modes:
            tag = (f"raster 256x176 f32 {'upwind_roe' if upwind else 'roe'} "
                   f"{mode}")
            kw = dict(src=src, bc_vals=bc_vals, num_sediment=NUM_SEDIMENT,
                      upwind=upwind, **extra)
            got = swe_raster_step(plan, q, *geo, dt, **kw)
            want = swe_raster_step_plain(plan, q, *geo, dt, **kw)
            for field in ("out", "prim", "cmax"):
                check("swe_raster_step", f"{tag} {field}",
                      getattr(got, field), getattr(want, field), f32)
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"tracer kernel checks failed: {failures}")


def tracer_simulation(steps, backend, dev, mesh, plain=False):
    """The sediment and salinity dam break on `backend`, its kernels
    replaced by their plain versions when `plain`."""
    if backend == "fused_structured":
        return raster_simulation(steps, dev, mesh, plain=plain,
                                 config=tracer_dam_break_config)
    return unstructured_simulation(steps, dev, mesh, plain,
                                   tracer_dam_break_config)


def phase_tracers(steps, errs, dev, mesh):
    """Both main paths with NT = 3 at full size (`run_main_path`), with the
    sediment moved, the volume and (unstructured) the salinity budget
    checked, and each NT = 3 kernel timed at the path's shapes."""
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_step import swe_raster_step_plain

    card = nvidia_smi_line()
    area = mesh.cell_area
    rows = []
    for path, backend in (("unstructured", "xla"),
                          ("raster", "fused_structured")):
        log(f"== phase 5: {path} main path with {NUM_SEDIMENT} sediment "
            f"classes and salinity (ndof {3 + NT}), {mesh.num_cells:,} "
            "cells, f32")
        raster = backend == "fused_structured"

        def check(sim, q0):
            if sim.ndof != 3 + NT:
                raise SystemExit(f"tracer run has ndof {sim.ndof}")
            check_state_and_budget(sim, q0, area)
            q1 = sim.get_solution().astype(np.float64)
            moved = np.abs(q1[3:3 + NUM_SEDIMENT]
                           - q0[3:3 + NUM_SEDIMENT]).max()
            log(f"  sediment moved by up to {moved:.3e} (mass h*c)")
            if not moved > 0.0:
                raise SystemExit("the sediment rows did not move")
            if raster:
                return
            # salinity is passive: mass lost = accumulated outflow
            m0 = float(np.sum(q0[3 + NUM_SEDIMENT] * area))
            m1 = float(np.sum(q1[3 + NUM_SEDIMENT] * area))
            lens = sim.operator.arrays.bnd_len.cpu().numpy().astype(
                np.float64)
            out = float(np.sum(sim.bflux_accum[3 + NUM_SEDIMENT] * lens))
            budget = abs((m0 - m1) - out) / m0
            log(f"  salinity mass: initial {m0:.9e}, final {m1:.9e}, lost "
                f"{m0 - m1:.6e}, outflow {out:.6e}, budget error "
                f"{budget:.3e} of the initial mass")
            if not (budget <= 1e-4 and out > 0.0):
                raise SystemExit(f"salinity budget error {budget}, "
                                 f"outflow {out}")

        sim, launches = run_main_path(
            f"{path} main path with tracers",
            lambda n, plain=False: tracer_simulation(n, backend, dev, mesh,
                                                     plain),
            steps, {"swe_edge_flux": 1, "courant_argmax": 1,
                    "swe_raster_step" if raster else "swe_cell_stage": 1},
            check)

        # the NT = 3 kernels at the path's shapes: held against their plain
        # versions, then timed beside them and their bounds
        q, bv = sim.q, sim.boundary_values
        s = q.element_size()
        dt = torch.tensor(DT, dtype=q.dtype, device=dev)
        stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
        if raster:
            op = sim._structured["op"]
            C = q.shape[1]
            got = op.step(q, dt, **stage)
            want = swe_raster_step_plain(
                op.plan, q, op.dz_dx, op.dz_dy, op.mannings_n, dt,
                num_sediment=op.num_sediment, **stage)
            r = max(rel_err(g, w) for g, w in zip(got, want))
            err = {"swe_raster_step": max(abs_err(g, w)
                                          for g, w in zip(got, want))}
            calls = {"swe_raster_step": (
                lambda: op.step(q, dt, **stage),
                lambda: swe_raster_step_plain(
                    op.plan, q, op.dz_dx, op.dz_dy, op.mannings_n, dt,
                    num_sediment=op.num_sediment, **stage), None)}
            nbytes = {"swe_raster_step": raster_step_bytes(
                C, 3 + NT, got.cmax.numel(), s)}
            nops = {"swe_raster_step": (OPS_PER_RASTER_CELL + NT *
                                        OPS_PER_TRACER["swe_raster_step"]) * C}
        else:
            op = sim.operator
            a = op.arrays
            kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                      xq2018_threshold=op.xq2018_threshold,
                      source_method=op.source_method,
                      num_sediment=op.num_sediment)
            flux, courant = op.edge_flux(q, bv)
            fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
            ok_ = op.cell_stage(flux, q, dt, None, **stage)
            op_ = swe_cell_stage_plain(a, flux, q, dt, None, **kw, **stage)
            r = max(rel_err(flux, fp), rel_err(courant, cp),
                    rel_err(ok_.q_out, op_.q_out), rel_err(ok_.prim, op_.prim))
            err = {"swe_edge_flux": max(abs_err(flux, fp),
                                        abs_err(courant, cp)),
                   "swe_cell_stage": max(abs_err(ok_.q_out, op_.q_out),
                                         abs_err(ok_.prim, op_.prim))}
            calls = {
                "swe_edge_flux": (
                    lambda: op.edge_flux(q, bv),
                    lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h,
                                                op.h_anuga), None),
                "swe_cell_stage": (
                    lambda: op.cell_stage(flux, q, dt, None, **stage),
                    lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw,
                                                 **stage), None)}
            nbytes = kernel_bytes(op, q.numel() * s, s)
            nops = {name: (base + NT * OPS_PER_TRACER[name]) * n
                    for name, base, n in (
                        ("swe_edge_flux", OPS_PER_EDGE, op.num_edges),
                        ("swe_cell_stage", OPS_PER_CELL, op.num_cells))}
        log(f"  full-size NT = {NT} kernels vs plain on the {path} path: "
            f"rel {r:.3e}")
        if not r <= TOL[q.dtype]:
            raise SystemExit(f"full-size {path} tracer kernel check failed")
        rows += [kernel_row(card, name, f"{path}+tracers", fns,
                            launches[name],
                            max(errs.get(f"{name} nt{NT}", 0.0), err[name]),
                            nbytes[name], nops[name], q.dtype, nt=NT)
                 for name, fns in calls.items()]
        # rhs mode (rk4): K2, or K1b and SWEOperator.apply (K1a + K1c +
        # K1b rhs), at NT = 3
        if raster:
            def rhs_plain():
                return swe_raster_step_plain(
                    op.plan, q, op.dz_dx, op.dz_dy, op.mannings_n, dt,
                    num_sediment=op.num_sediment, emit_prim=True)

            log(f"  [{card}] swe_raster_step at NT = {NT} in rhs mode: device "
                f"{device_ms(lambda: op.step(q, dt, emit_prim=True)):.4f} "
                f"ms/call, plain {device_ms(rhs_plain, reps=5):.4f} ms, bound "
                f"{rows[-1]['bound_ms']:.4f} ms")
        else:
            pop = plain_operator(op)
            rhs_ms = device_ms(lambda: op.cell_stage(flux, q, dt, None,
                                                     emit_prim=True))
            rhs_plain = device_ms(lambda: pop.cell_stage(
                flux, q, dt, None, emit_prim=True), reps=5)
            rhs_bound = 1e3 * kernel_bytes(op, q.numel() * s, s, rhs=True)[
                "swe_cell_stage"] / HBM_BYTES_PER_S
            apply_ms = device_ms(lambda: op.apply(q, dt, bv, None))
            apply_plain = device_ms(lambda: pop.apply(q, dt, bv, None),
                                    reps=5)
            apply_bound = (rows[-2]["bound_ms"] + rhs_bound + 1e3 *
                           courant_bytes(op.num_edges, s) / HBM_BYTES_PER_S)
            log(f"  [{card}] swe_cell_stage at NT = {NT} in rhs mode: device "
                f"{rhs_ms:.4f} ms/call, plain {rhs_plain:.4f} ms, bound "
                f"{rhs_bound:.4f} ms; SWEOperator.apply at NT = {NT} (K1a + "
                f"K1c + K1b rhs): device {apply_ms:.4f} ms, plain "
                f"{apply_plain:.4f} ms, sum of its kernels' bounds "
                f"{apply_bound:.4f} ms")
        del sim
    return rows


# ------------------------------------------------------------------ phase 6
def muscl_bytes(op, q_bytes, s):
    """Bytes the second-order unstructured kernels must move at the
    operator's shapes (flow only): each input read once, each output
    written once."""
    C, Ei, Eb = op.num_cells, op.num_internal_edges, op.num_boundary_edges
    E, K = Ei + Eb, op.arrays.cell_edges.shape[1]
    return {
        # q, cell_edges, the two coefficient planes, both cell ids of each
        # interior edge; grad out
        "swe_muscl_grad": q_bytes + C * K * (4 + 2 * s) + 8 * Ei + 6 * C * s,
        # K1a's, plus the gradients and four offsets per interior edge
        "swe_edge_flux": edge_flux_bytes(Ei, Eb, q_bytes, s) + 6 * C * s
        + 4 * Ei * s,
        # the h-flux row, cell_edges, coefficients, h and dt; s out
        "swe_positivity_drain": (E + 1) * s + C * K * (4 + s) + 2 * C * s + s,
        # three flux rows read and written, the donor ids, the factors
        "swe_positivity_scale": 6 * E * s + 8 * Ei + 4 * Eb + C * s,
    }


def raster_muscl_bytes(nx, ny, tiles, s, strip=None, qA=False):
    """Bytes K2 MUSCL must move over ny owned rows in an euler stage with
    the primitives (qA: the stage that also reads qA): K2's, reading q,
    the three geometry planes and dt and writing out, prim and the tile
    maxima; on a strip, also the halo rows of q."""
    halo = 0 if strip is None else strip.halo_lo + strip.halo_hi
    C = nx * ny
    return s * (3 * (ny + halo) * nx + 3 * C + 1 + 6 * C + tiles
                + (3 * C if qA else 0))


def phase_muscl_kernels(seed, errs, dev):
    """K3a, K1a in MUSCL mode (each limiter), K3b drain and scale (a state
    where some donor factor is below 1) on quad and triangle meshes in f32
    and f64, and K2 MUSCL (each limiter; each ssprk3 stage and rhs mode,
    rain off and on) on a raster, against their plain versions at
    256x176. The random wet/dry state has layers thinner than tiny_h, and
    a MUSCL face between such a cell and a wet one can be thin with a
    momentum that is not: with h_anuga = 0 its u = hu/h, and with it the
    flux and Courant coefficient, changes by orders of magnitude with the
    last bit of h (FMA contraction on the card, none in PyTorch), so these
    checks take h_anuga = 1e-3, which bounds u."""
    from rdycore_tpu_torch.mesh import structured_quad, structured_tri
    from rdycore_tpu_torch.operator import build_operator
    from rdycore_tpu_torch.ops.kernels import muscl as mk
    from rdycore_tpu_torch.ops.kernels import raster_muscl as rm
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax
    from rdycore_tpu_torch.ops.kernels.edge_flux import (
        swe_edge_flux, swe_edge_flux_plain)
    from rdycore_tpu_torch.ops.kernels.raster_step import StructuredPlan
    from rdycore_tpu_torch.ops.structured import FUSED_STAGES
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients

    log("== phase 6a: the second-order kernels against their plain "
        "versions")
    rng = np.random.default_rng(seed + 6)
    meshes = {
        "quad 256x176": structured_quad(256, 176, 0.0, 0.512, 0.0, 0.352),
        "tri 128x88": structured_tri(128, 88, 0.0, 0.512, 0.0, 0.352),
    }
    bc = {"left": 0, "right": 2, "top": 1, "bottom": 0}  # all three codes
    failures = []

    def check(kernel, what, got, want, dtype, key=None):
        r, a = rel_err(got, want), abs_err(got, want)
        key = key or kernel
        errs[key] = max(errs.get(key, 0.0), a)
        ok = r <= TOL[dtype] and got.shape == want.shape
        log(f"  {kernel:23s} {what:48s} rel {r:.3e} abs {a:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {what}")

    for mname, mesh in meshes.items():
        for dtype in (torch.float32, torch.float64):
            tag = f"{mname} {str(dtype)[6:]}"
            op = build_operator(
                mesh, bc_types=bc,
                mannings_n=rng.uniform(0.01, 0.05, mesh.num_cells),
                h_anuga=1e-3, second_order=True, dtype=dtype, device=dev)
            a = op.arrays
            q, bv, _ = random_state(op, rng, dtype, dev)
            gp = ls_gradients(a, q)
            check("swe_muscl_grad", f"{tag} grad", mk.swe_muscl_grad(a, q),
                  gp, dtype)
            for lim in LIMITERS:
                fk, ck = swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga,
                                       grad=gp, limiter=lim)
                fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                             grad=gp, limiter=lim)
                for what, g, w in (("flux", fk, fp), ("courant", ck, cp)):
                    check("swe_edge_flux", f"{tag} muscl {lim} {what}", g, w,
                          dtype, "swe_edge_flux muscl")
            # K3b on the plain minmod flux: a fifth of the cells start dry
            fp, _ = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                        grad=gp, limiter="minmod")
            for dt_s in (0.002, 0.0):
                dt = torch.tensor(dt_s, dtype=dtype, device=dev)
                sk = mk.swe_positivity_drain(a, fp, q[0], dt)
                sp = mk.positivity_drain_plain(a, fp, q[0], dt)
                check("swe_positivity_drain", f"{tag} dt {dt_s} s", sk, sp,
                      dtype)
                n_lim = int((sp < 1.0).sum())
                log(f"    cells with s < 1: {n_lim} of {op.num_cells}")
                if not (n_lim > 0 and bool(torch.isfinite(sk).all())):
                    failures.append(f"swe_positivity_drain {tag} limiter "
                                    "idle or not finite")
                check("swe_positivity_scale", f"{tag} dt {dt_s} flux",
                      mk.swe_positivity_scale(a, fp.clone(), sp),
                      mk.positivity_scale_plain(a, fp.clone(), sp), dtype)
    # K2 MUSCL on a 256x176 raster, f32
    nx, ny = 256, 176
    f32 = torch.float32

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=f32, device=dev)

    h = rng.uniform(0.05, 1.0, nx * ny)
    h = np.where(rng.uniform(size=h.size) < 0.25, rng.uniform(0, 5e-8, h.size),
                 h)
    h = np.where(rng.uniform(size=h.size) < 0.1, 0.0, h)
    q = t([h, h * rng.normal(0, 0.4, h.size), h * rng.normal(0, 0.4, h.size)])
    qA = t([h[::-1], h * rng.normal(0, 0.4, h.size), np.zeros(h.size)])
    geo = [t(rng.normal(0, 0.01, (ny, nx))), t(rng.normal(0, 0.01, (ny, nx))),
           t(rng.uniform(0.01, 0.05, (ny, nx)))]
    plan = StructuredPlan(nx, ny, 0.002, 0.002, 1e-7, 1e-3, bc_left=0,
                          bc_right=2, bc_bottom=2, bc_top=1)
    bc_vals = {"left": t([rng.uniform(0.1, 0.6, ny), rng.normal(0, 0.1, ny),
                          rng.normal(0, 0.1, ny)])}
    dt = torch.tensor(0.002, dtype=f32, device=dev)
    modes = [("rhs", dict(emit_prim=True))] + [
        (f"stage {i + 1}", dict(stage=st, qA=qA if i else None,
                                emit_prim=True))
        for i, st in enumerate(FUSED_STAGES["ssprk3"])
    ]
    fx, fy, _ = rm.raster_muscl_faces_plain(plan, q, bc_vals, "minmod")
    n_lim = int((rm.donor_factors(plan, q, fx, fy, dt) < 1.0).sum())
    log(f"    raster cells with s < 1: {n_lim} of {nx * ny}")
    if not n_lim > 0:
        failures.append("swe_raster_muscl_step limiter idle")
    for lim in LIMITERS:
        for rain in (False, True):
            src = t(rng.uniform(0.0, 1e-2, (ny, nx))) if rain else None
            for mode, extra in modes:
                tag = f"raster {lim} rain {'on' if rain else 'off'} {mode}"
                got = rm.swe_raster_muscl_step(plan, q, *geo, dt, bc_vals,
                                               lim, src=src, **extra)
                want = rm.raster_muscl_step_plain(plan, q, *geo, dt,
                                                  bc_vals, lim, src=src,
                                                  **extra)
                for field, g, w in zip(("out", "prim", "cmax"), got, want):
                    check("swe_raster_muscl_step", f"{tag} {field}", g, w,
                          f32)
        run = (torch.zeros((), dtype=f32, device=dev),
               torch.zeros((), dtype=torch.int32, device=dev))
        courant_argmax(got.cmax, dt, *run)
        check("swe_raster_muscl_step", f"raster 256x176 {lim} courant fold",
              run[0], want.cmax.max() * dt, f32)
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"second-order kernel checks failed: {failures}")


def muscl_dam_break_config(steps, backend="xla", scheme="ssprk2"):
    """The dam break at second order (minmod) with the positivity limiter
    and a DRY floodplain, ssprk2, dt = DT_MUSCL (Courant number about
    0.4)."""
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    d = dam_break_dict(steps, backend, scheme)
    d["numerics"].update(second_order=True, limiter="minmod")
    d["time"].update(time_step=DT_MUSCL, stop=steps * DT_MUSCL)
    d["flow_conditions"][1]["height"] = 0.0
    return config_from_dict(d).validate()


def muscl_simulation(steps, backend, dev, mesh, plain=False):
    """The second-order dam break on `backend`, its kernels replaced by
    their plain versions when `plain`."""
    if backend == "fused_structured":
        return raster_simulation(steps, dev, mesh, "ssprk2", plain,
                                 muscl_dam_break_config)
    return unstructured_simulation(steps, dev, mesh, plain,
                                   muscl_dam_break_config)


def phase_muscl(steps, errs, dev, mesh):
    """Both main paths at second order at full size (`run_main_path`, with
    the state and the volume kept), and each kernel of the path held
    against its plain version and timed at the path's shapes."""
    from rdycore_tpu_torch.ops.kernels import muscl as mk
    from rdycore_tpu_torch.ops.kernels import raster_muscl as rm
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients

    card = nvidia_smi_line()
    area = mesh.cell_area
    rows = []

    def check(sim, q0):
        """h finite and >= -1e-7, the volume kept to 1e-4 (the front does
        not reach the outflow wall)."""
        hq = sim.get_height()
        v0 = float(np.sum(q0[0] * area))
        v1 = float(np.sum(hq.astype(np.float64) * area))
        lens = sim.operator.arrays.bnd_len.cpu().numpy().astype(np.float64)
        outflow = float(np.sum(sim.bflux_accum[0] * lens))
        kept = abs(v1 - v0) / v0
        finite = bool(np.isfinite(sim.get_solution()).all())
        log(f"  state: finite {finite}, min h {hq.min():.3e}; volume initial "
            f"{v0:.9e} m^3, final {v1:.9e}, change {kept:.3e} of the initial "
            f"volume, outflow {outflow:.3e}")
        if not (finite and hq.min() >= -1e-7 and kept <= 1e-4):
            raise SystemExit("second-order state or volume failed")

    for path, backend in (("unstructured", "xla"),
                          ("raster", "fused_structured")):
        raster = backend == "fused_structured"
        log(f"== phase 6: {path} main path at second order (MUSCL minmod, "
            f"positivity limiter, ssprk2, dt {DT_MUSCL} s, dry floodplain), "
            f"{mesh.num_cells:,} cells, f32")
        if raster:  # two launches a step; K1a for the accumulator
            per_step = {"swe_raster_muscl_step": 2, "courant_argmax": 1,
                        "swe_edge_flux": 1}
        else:  # two stages of K3a, K1a, K3b drain and scale, K1b
            per_step = {k: 2 for k in (
                "swe_muscl_grad", "swe_edge_flux", "swe_positivity_drain",
                "swe_positivity_scale", "swe_cell_stage")}
            per_step["courant_argmax"] = 1
        sim, launches = run_main_path(
            f"second-order {path} main path",
            lambda n, plain=False: muscl_simulation(n, backend, dev, mesh,
                                                    plain),
            steps, per_step, check)

        # each kernel of the path at its shapes: held against its plain
        # version on the final state, then timed
        q, bv = sim.q, sim.boundary_values
        s = q.element_size()
        dt = torch.tensor(DT_MUSCL, dtype=q.dtype, device=dev)
        # a step 40 times longer, so that the limiter acts at full size
        dt_long = torch.tensor(40 * DT_MUSCL, dtype=q.dtype, device=dev)
        run = (torch.zeros((), dtype=q.dtype, device=dev),
               torch.zeros((), dtype=torch.int32, device=dev))
        stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
        if raster:
            op = sim._structured["op"]
            plan = op.plan
            geo = (op.dz_dx, op.dz_dy, op.mannings_n)
            # K2 MUSCL at dt and at 40 times dt, where the donor factors
            # fall below 1
            got = [op.step(q, t, **stage) for t in (dt, dt_long)]
            want = [rm.raster_muscl_step_plain(plan, q, *geo, t, None,
                                               op.limiter, **stage)
                    for t in (dt, dt_long)]
            mk_, ik = op.courant_max(got[0].cmax, dt, *run)
            mp, ip = courant_argmax_plain(got[0].cmax)
            fbk = op.boundary_fluxes(q, bv)
            fbp = swe_edge_flux_plain(op.bnd, q, bv, plan.tiny_h,
                                      plan.h_anuga)[0][:, :-1]
            pairs = {
                "swe_raster_muscl_step": [
                    gw for g, w in zip(got, want) for gw in zip(g, w)],
                "swe_edge_flux": [(fbk[k], fbp[k]) for k in range(3)],
            }
            fp = rm.raster_muscl_faces_plain(plan, q, None, op.limiter)
            n_lim = int((rm.donor_factors(plan, q, *fp[:2], dt_long)
                         < 1.0).sum())
            blocks = got[0].cmax
            calls = {
                "swe_raster_muscl_step": (
                    lambda: op.step(q, dt, **stage),
                    lambda: rm.raster_muscl_step_plain(
                        plan, q, *geo, dt, None, op.limiter, **stage),
                    None),
                "courant_argmax": (
                    lambda: op.courant_max(blocks, dt, *run),
                    lambda: courant_argmax_plain(blocks, dt, *run),
                    lambda: torch.max(blocks, 0)),
                "swe_edge_flux": (
                    lambda: op.boundary_fluxes(q, bv),
                    lambda: swe_edge_flux_plain(op.bnd, q, bv, op.plan.tiny_h,
                                                op.plan.h_anuga),
                    None),
            }
            Eb = op.bnd.bnd_left.shape[0]
            nbytes = {"swe_raster_muscl_step": raster_muscl_bytes(
                plan.nx, plan.ny, blocks.numel(), s)}
            nbytes["courant_argmax"] = courant_bytes(blocks.numel(), s)
            nbytes["swe_edge_flux"] = edge_flux_bytes(
                0, Eb, 3 * s * int(torch.unique(op.bnd.bnd_left).numel()), s)
            C = q.shape[1]
            nops = {"swe_raster_muscl_step": OPS_PER_MUSCL_RASTER_CELL * C,
                    "courant_argmax": OPS_PER_VALUE * blocks.numel(),
                    "swe_edge_flux": OPS_PER_EDGE * Eb}
            replaces = dict(
                REPLACES, courant_argmax=REPLACES["swe_raster_muscl_step"],
                swe_edge_flux=_SLOTTED + ":1254")
        else:
            op = sim.operator
            a = op.arrays
            kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                      xq2018_threshold=op.xq2018_threshold,
                      source_method=op.source_method)
            gk = op.muscl_grad(q)
            gp = ls_gradients(a, q)
            flux, courant = op.edge_flux(q, bv, gp)
            fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                         grad=gp, limiter=op.limiter)
            # K3b at dt and at 40 times dt, where the donor factors fall
            # below 1: drain on the same flux, scale on the same factors
            sk = mk.swe_positivity_drain(a, fp, q[0], dt)
            drain, scale = [], []
            for t in (dt, dt_long):
                s_p = mk.positivity_drain_plain(a, fp, q[0], t)
                drain.append((mk.swe_positivity_drain(a, fp, q[0], t), s_p))
                scale.append((mk.swe_positivity_scale(a, fp.clone(), s_p),
                              mk.positivity_scale_plain(a, fp.clone(), s_p)))
            n_lim = int((drain[1][1] < 1.0).sum())
            ok_ = op.cell_stage(fp, q, dt, None, **stage)
            op_ = swe_cell_stage_plain(a, fp, q, dt, None, **kw, **stage)
            mk_, ik = op.courant_max(cp, dt, *run)
            mp, ip = courant_argmax_plain(cp)
            pairs = {
                "swe_muscl_grad": [(gk, gp)],
                "swe_edge_flux": [(flux, fp), (courant, cp)],
                "swe_positivity_drain": drain,
                "swe_positivity_scale": scale,
                "swe_cell_stage": [(ok_.q_out, op_.q_out),
                                   (ok_.prim, op_.prim)],
            }
            calls = {
                "swe_muscl_grad": (lambda: op.muscl_grad(q),
                                   lambda: ls_gradients(a, q), None),
                "swe_edge_flux": (
                    lambda: op.edge_flux(q, bv, gk),
                    lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h,
                                                op.h_anuga, grad=gk,
                                                limiter=op.limiter),
                    None),
                "swe_positivity_drain": (
                    lambda: mk.swe_positivity_drain(a, flux, q[0], dt),
                    lambda: mk.positivity_drain_plain(a, flux, q[0], dt),
                    None),
                "swe_positivity_scale": (
                    lambda: mk.swe_positivity_scale(a, flux, sk),
                    lambda: mk.positivity_scale_plain(a, flux, sk),
                    None),
                "swe_cell_stage": (
                    lambda: op.cell_stage(flux, q, dt, None, **stage),
                    lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw,
                                                 **stage),
                    None),
                "courant_argmax": (
                    lambda: op.courant_max(courant, dt, *run),
                    lambda: courant_argmax_plain(courant, dt, *run),
                    lambda: torch.max(courant, 0)),
            }
            nbytes = muscl_bytes(op, q.numel() * s, s)
            base = kernel_bytes(op, q.numel() * s, s)
            nbytes["swe_cell_stage"] = base["swe_cell_stage"]
            nbytes["courant_argmax"] = base["courant_argmax"]
            C, E, Ei = op.num_cells, op.num_edges, op.num_internal_edges
            nops = {"swe_muscl_grad": OPS_PER_GRAD_CELL * C,
                    "swe_edge_flux": OPS_PER_EDGE * (E - Ei)
                    + OPS_PER_MUSCL_EDGE * Ei,
                    "swe_positivity_drain": OPS_PER_DRAIN_CELL * C,
                    "swe_positivity_scale": OPS_PER_SCALE_EDGE * E,
                    "swe_cell_stage": OPS_PER_CELL * C,
                    "courant_argmax": OPS_PER_VALUE * E}
            replaces = dict(REPLACES, swe_edge_flux=_SLOTTED + ":3180",
                            swe_cell_stage=_SLOTTED + ":1441")
        rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
        err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
        rel["courant_argmax"] = abs(float(mk_) - float(mp)) / float(mp)
        err["courant_argmax"] = abs(float(mk_) - float(mp))
        log(f"  full-size kernels vs plain on the second-order {path} path "
            f"(relative): {rel}; courant idx {int(ik)} (plain {int(ip)}); "
            f"cells with s < 1 at dt x40: {n_lim}")
        if not (all(v <= TOL[q.dtype] for v in rel.values()) and n_lim > 0
                and int(ik) == int(ip)):
            raise SystemExit(f"full-size second-order {path} kernel check "
                             "failed")
        for name, fns in calls.items():
            # phase 6a's errors of the same kernel in the same mode count
            key = ("swe_edge_flux muscl"
                   if name == "swe_edge_flux" and not raster else name)
            rows.append(kernel_row(
                card, name, f"{path}+muscl", fns, launches[name],
                max(err[name], errs.get(key, 0.0)), nbytes[name],
                nops[name], q.dtype, replaces))
        del sim
    return rows


# ------------------------------------------------------------------ phase 7
def wb_bed(x, y):
    """The bumpy bed of phase 7 at the vertices: 0 to 0.07 m, bumps 0.25 m
    across."""
    return 0.035 * (1.0 + np.sin(4 * np.pi * x) * np.sin(4 * np.pi * y))


def eta_pairs(bs):
    """The (vertex, cell) pairs K5 gathers: the non-padding entries of
    vertex_cells."""
    return int((bs.vertex_cells < bs.z1.shape[0]).sum())


def wb_bytes(op, q_bytes, s):
    """Bytes the well-balanced kernels must move at the operator's shapes
    (each input read once, each output written once): K1a's plus the cell
    beds (HR) or the endpoint ids and beds and the vertex eta (BS2002);
    K1b's in stage mode less the bed slopes plus the interior edges' ids
    and normals, the boundary normals and the cell beds (HR); K5's ids,
    counts, sorted beds, depths and output."""
    C, Ei, Eb = op.num_cells, op.num_internal_edges, op.num_boundary_edges
    E = Ei + Eb
    base = kernel_bytes(op, q_bytes, s)
    out = dict(base)
    if op.well_balancing_hr:
        out["swe_edge_flux"] = base["swe_edge_flux"] + C * s
        out["swe_cell_stage"] = (base["swe_cell_stage"] - 2 * C * s
                                 + Ei * (8 + 2 * s) + Eb * 2 * s + C * s)
    if op.well_balancing_bs2002:
        NV, K = op.arrays.bs2002.vertex_cells.shape
        extra = E * (8 + 2 * s) + NV * s
        out["swe_edge_flux"] = base["swe_edge_flux"] + extra
        out["swe_eta_vertex"] = NV * K * 4 + 2 * NV * s + 4 * C * s
        if op.second_order:
            m = muscl_bytes(op, q_bytes, s)
            out.update({k: m[k] for k in m})
            out["swe_edge_flux"] = m["swe_edge_flux"] + extra
    return out


def wb_ops(op, eta_pairs_n=0):
    """Operations of the well-balanced kernels, counted from the CUDA
    sources (see OPS_PER_*)."""
    C, Ei, E = op.num_cells, op.num_internal_edges, op.num_edges
    K = op.arrays.cell_edges.shape[1]
    out = {"swe_edge_flux": OPS_PER_EDGE * E,
           "swe_cell_stage": OPS_PER_CELL * C,
           "courant_argmax": OPS_PER_VALUE * E}
    if op.well_balancing_hr:
        out["swe_edge_flux"] += OPS_PER_HR_EDGE * Ei
        out["swe_cell_stage"] += OPS_PER_HR_SLOT * K * C
    if op.well_balancing_bs2002:
        out["swe_eta_vertex"] = OPS_PER_ETA_PAIR * eta_pairs_n
        out["swe_edge_flux"] += OPS_PER_BS_EDGE * E
        if op.second_order:
            out["swe_edge_flux"] += (OPS_PER_MUSCL_EDGE - OPS_PER_EDGE) * Ei
            out["swe_muscl_grad"] = OPS_PER_GRAD_CELL * C
            out["swe_positivity_drain"] = OPS_PER_DRAIN_CELL * C
            out["swe_positivity_scale"] = OPS_PER_SCALE_EDGE * E
    return out


def phase_wb_kernels(seed, errs, dev):
    """K1a in HR mode (NT = 0 and 3, Roe and upwind-Roe), K1a's BS2002
    correction (first order and each limiter), K1b in HR mode (each ssprk3
    stage and rhs mode, each source method; NT = 0 and 3) and K5 on quad and
    triangle meshes over the bumpy bed of phase 7, in f32 and f64 with
    every BC code, against their plain versions at 256x176. The BS2002
    checks take h_anuga = 1e-3, for the MUSCL faces' sake (phase 6a)."""
    from rdycore_tpu_torch.mesh import structured_quad, structured_tri
    from rdycore_tpu_torch.operator import build_operator
    from rdycore_tpu_torch.ops.kernels.cell_stage import (
        swe_cell_stage, swe_cell_stage_plain)
    from rdycore_tpu_torch.ops.kernels.edge_flux import (
        swe_edge_flux, swe_edge_flux_plain)
    from rdycore_tpu_torch.ops.kernels.eta_vertex import swe_eta_vertex
    from rdycore_tpu_torch.ops.swe.bs2002 import eta_vertices
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients
    from rdycore_tpu_torch.timestepping import _FUSED_STEP_STAGES

    log("== phase 7a: the well-balancing kernels against their plain "
        "versions")
    rng = np.random.default_rng(seed + 7)
    meshes = {
        "quad 256x176": structured_quad(256, 176, 0.0, 0.512, 0.0, 0.352,
                                        z_fn=wb_bed),
        "tri 128x88": structured_tri(128, 88, 0.0, 0.512, 0.0, 0.352,
                                     z_fn=wb_bed),
    }
    bc = {"left": 0, "right": 2, "top": 1, "bottom": 0}  # all three codes
    failures = []

    def check(kernel, what, got, want, dtype, key):
        r, a = rel_err(got, want), abs_err(got, want)
        errs[key] = max(errs.get(key, 0.0), a)
        ok = r <= TOL[dtype] and got.shape == want.shape
        log(f"  {kernel:15s} {what:52s} rel {r:.3e} abs {a:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {what}")

    for mname, mesh in meshes.items():
        for dtype in (torch.float32, torch.float64):
            tag = f"{mname} {str(dtype)[6:]}"
            n = rng.uniform(0.01, 0.05, mesh.num_cells)
            for nt, riemann in ((0, "roe"), (NT, "roe"), (NT, "upwind_roe")):
                op = build_operator(mesh, bc_types=bc, mannings_n=n,
                                    num_tracers=nt,
                                    num_sediment=min(nt, NUM_SEDIMENT),
                                    riemann=riemann, well_balancing_hr=True,
                                    dtype=dtype, device=dev)
                a = op.arrays
                q, bv, ext = random_state(op, rng, dtype, dev)
                if nt:
                    q, bv, ext = tracer_rows(q, bv, ext, rng)
                up = riemann == "upwind_roe"
                t = f"{tag} nt {nt} {riemann}"
                fk, ck = swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga, up,
                                       hr=True)
                fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                             up, hr=True)
                check("swe_edge_flux", f"{t} hr flux", fk, fp, dtype,
                      "swe_edge_flux hr")
                check("swe_edge_flux", f"{t} hr courant", ck, cp, dtype,
                      "swe_edge_flux hr")
                if up:
                    continue
                dt = torch.tensor(0.002, dtype=dtype, device=dev)
                qA = random_state(op, rng, dtype, dev)[0]
                if nt:
                    qA = tracer_rows(qA, bv, ext, rng)[0]
                for method in ((0, 1, 2) if nt == 0 else (0, 2)):
                    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                              xq2018_threshold=op.xq2018_threshold,
                              source_method=method,
                              num_sediment=op.num_sediment, hr=True)
                    modes = [("rhs", dict(emit_prim=True))] + [
                        (f"stage {i + 1}", dict(stage=s, qA=qA if i else None,
                                                emit_prim=True))
                        for i, s in enumerate(_FUSED_STEP_STAGES["ssprk3"])]
                    for mode, extra in modes:
                        g = swe_cell_stage(a, fp, q, dt, ext, **kw, **extra)
                        w = swe_cell_stage_plain(a, fp, q, dt, ext, **kw,
                                                 **extra)
                        for field in ("q_out", "flux_div", "rhs", "prim"):
                            if getattr(w, field) is not None:
                                check("swe_cell_stage",
                                      f"{t} hr src{method} {mode} {field}",
                                      getattr(g, field), getattr(w, field),
                                      dtype, "swe_cell_stage hr")
            op = build_operator(mesh, bc_types=bc, mannings_n=n,
                                h_anuga=1e-3, second_order=True,
                                well_balancing_bs2002=True, dtype=dtype,
                                device=dev)
            a = op.arrays
            q, bv, _ = random_state(op, rng, dtype, dev)
            ev = eta_vertices(a.bs2002, q[0], op.tiny_h)
            check("swe_eta_vertex", f"{tag} eta_v",
                  swe_eta_vertex(a.bs2002, q[0], op.tiny_h), ev, dtype,
                  "swe_eta_vertex")
            gp = ls_gradients(a, q)
            for lim in (None,) + LIMITERS:
                grad = None if lim is None else gp
                kw = dict(grad=grad, limiter=lim or "minmod", bs=a.bs2002,
                          eta_v=ev)
                fk, ck = swe_edge_flux(a, q, bv, op.tiny_h, op.h_anuga, **kw)
                fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                             **kw)
                key = "swe_edge_flux bs2002" + (" muscl" if lim else "")
                mode = f"muscl {lim}" if lim else "first order"
                check("swe_edge_flux", f"{tag} bs2002 {mode} flux", fk, fp,
                      dtype, key)
                check("swe_edge_flux", f"{tag} bs2002 {mode} courant", ck,
                      cp, dtype, key)
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"well-balancing kernel checks failed: {failures}")


def wb_mesh():
    """The triangle mesh of phase 7 over the dam break's 4 m x 2.75 m, its
    vertices on the bumpy bed, one region of every cell."""
    from rdycore_tpu_torch.mesh import structured_tri

    t0 = time.perf_counter()
    mesh = structured_tri(WB_NX, WB_NY, 0.0, 2048 * DX, 0.0, 1408 * DX,
                          z_fn=wb_bed)
    mesh.regions["__id_1"] = np.arange(mesh.num_cells, dtype=np.int32)
    log(f"== mesh: structured_tri({WB_NX}, {WB_NY}) over a bumpy bed of "
        f"{mesh.cell_z.min():.4f}-{mesh.cell_z.max():.4f} m (cell beds), "
        f"{mesh.num_cells} cells, {mesh.num_edges} edges, "
        f"{mesh.num_vertices} vertices in {time.perf_counter() - t0:.2f} s")
    return mesh


def wb_config(steps, wb, dt, scheme="euler", second_order=False,
              outflow=True):
    """The phase-7 deck: one region, still water set by `wb_simulation`,
    Manning 0.018, critical outflow on the right (or reflecting walls
    only), reflecting walls elsewhere, boundary-flux accumulators on,
    f32."""
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    d = dam_break_dict(steps, "xla", scheme)
    d["physics"]["flow"]["well_balancing"] = wb
    d["numerics"].update(second_order=second_order, limiter="minmod")
    d["time"].update(time_step=dt, stop=steps * dt,
                     coupling_interval=WB_INTERVAL_STEPS * dt)
    d["regions"] = [{"name": "domain", "grid_region_id": 1}]
    d["surface_composition"] = [{"region": "domain", "material": "smooth"}]
    d["initial_conditions"] = [{"region": "domain", "flow": "still"}]
    d["flow_conditions"] = [
        {"name": "still", "type": "dirichlet", "height": 0.0,
         "x_momentum": 0, "y_momentum": 0},
        {"name": "outflow", "type": "critical-outflow"}]
    if not outflow:
        d["boundaries"], d["boundary_conditions"] = [], []
    return config_from_dict(d).validate()


def wb_simulation(steps, dev, mesh, eta, plain=False, **deck):
    """A phase-7 deck whose depths are set, as a coupler sets them, to
    max(eta(x) - cell_z, 0); its kernels replaced by their plain versions
    when `plain`."""
    from rdycore_tpu_torch import Simulation

    sim = Simulation(wb_config(steps, **deck), mesh=mesh, device=dev)
    sim.set_height(np.maximum(eta(mesh.cell_centroid[:, 0]) - mesh.cell_z,
                              0.0))
    if plain:
        sim.operator = plain_operator(sim.operator)
    return sim


def dam_eta(floodplain):
    """The dam break's free surface as a function of x: 0.25 m for x < 2 m,
    `floodplain` beyond."""
    return lambda x: np.where(x < 1024 * DX, H_RESERVOIR, floodplain)


def wb_kernel_rows(card, path, op, q, bv, dt, launches, errs, **extra):
    """Each kernel of a well-balanced path (`op`, its state q and boundary
    values bv, its step dt): held against its plain version on q, then
    timed beside its bound; the {"kernels": ...} rows of `path`, with
    `extra` in each."""
    from rdycore_tpu_torch.ops.kernels import muscl as mk
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.swe.bs2002 import eta_vertices
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients

    dev, muscl = q.device, op.second_order
    a, s = op.arrays, q.element_size()
    run = (torch.zeros((), dtype=q.dtype, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
              xq2018_threshold=op.xq2018_threshold,
              source_method=op.source_method, hr=op.well_balancing_hr)
    wb_kw = dict(hr=op.well_balancing_hr, bs=a.bs2002)
    pairs, calls = {}, {}
    eta_v = grad = None
    if op.well_balancing_bs2002:
        eta_v = op.eta_vertices(q[0])
        ev = eta_vertices(a.bs2002, q[0], op.tiny_h)
        pairs["swe_eta_vertex"] = [(eta_v, ev)]
        calls["swe_eta_vertex"] = (
            lambda: op.eta_vertices(q[0]),
            lambda: eta_vertices(a.bs2002, q[0], op.tiny_h), None)
        wb_kw["eta_v"] = ev
    if muscl:
        grad = op.muscl_grad(q)
        gp = ls_gradients(a, q)
        pairs["swe_muscl_grad"] = [(grad, gp)]
        calls["swe_muscl_grad"] = (lambda: op.muscl_grad(q),
                                   lambda: ls_gradients(a, q), None)
        wb_kw.update(grad=gp, limiter=op.limiter)
    flux, courant = op.edge_flux(q, bv, wb_kw.get("grad"),
                                 wb_kw.get("eta_v"))
    fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                 **wb_kw)
    pairs["swe_edge_flux"] = [(flux, fp), (courant, cp)]
    calls["swe_edge_flux"] = (
        lambda: op.edge_flux(q, bv, grad, eta_v),
        lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga,
                                    **dict(wb_kw, eta_v=eta_v,
                                           grad=grad)),
        None)
    if muscl:
        sk = mk.swe_positivity_drain(a, fp, q[0], dt)
        sp = mk.positivity_drain_plain(a, fp, q[0], dt)
        pairs["swe_positivity_drain"] = [(sk, sp)]
        pairs["swe_positivity_scale"] = [(
            mk.swe_positivity_scale(a, fp.clone(), sp),
            mk.positivity_scale_plain(a, fp.clone(), sp))]
        calls["swe_positivity_drain"] = (
            lambda: mk.swe_positivity_drain(a, flux, q[0], dt),
            lambda: mk.positivity_drain_plain(a, flux, q[0], dt), None)
        calls["swe_positivity_scale"] = (
            lambda: mk.swe_positivity_scale(a, flux, sk),
            lambda: mk.positivity_scale_plain(a, flux, sk), None)
    ok_ = op.cell_stage(fp, q, dt, None, **stage)
    op_ = swe_cell_stage_plain(a, fp, q, dt, None, **kw, **stage)
    pairs["swe_cell_stage"] = [(ok_.q_out, op_.q_out),
                               (ok_.prim, op_.prim)]
    calls["swe_cell_stage"] = (
        lambda: op.cell_stage(flux, q, dt, None, **stage),
        lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw,
                                     **stage), None)
    mk_, ik = op.courant_max(cp, dt, *run)
    mp, ip = courant_argmax_plain(cp)
    calls["courant_argmax"] = (
        lambda: op.courant_max(courant, dt, *run),
        lambda: courant_argmax_plain(courant, dt, *run),
        lambda: torch.max(courant, 0))
    rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
    err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
    rel["courant_argmax"] = abs(float(mk_) - float(mp)) / float(mp)
    err["courant_argmax"] = abs(float(mk_) - float(mp))
    log(f"  full-size kernels vs plain on the {path} path (relative): "
        f"{rel}; courant idx {int(ik)} (plain {int(ip)})")
    if not (all(v <= TOL[q.dtype] for v in rel.values())
            and int(ik) == int(ip)):
        raise SystemExit(f"full-size {path} kernel check failed")
    n_pairs = eta_pairs(a.bs2002) if a.bs2002 is not None else 0
    nbytes = wb_bytes(op, q.numel() * s, s)
    nops = wb_ops(op, n_pairs)
    mode = ("hr" if op.well_balancing_hr else
            "bs2002 muscl" if muscl else "bs2002")
    keys = {"swe_edge_flux": f"swe_edge_flux {mode}",
            "swe_cell_stage": ("swe_cell_stage hr"
                               if op.well_balancing_hr
                               else "swe_cell_stage")}
    replaces = dict(
        REPLACES, swe_edge_flux=_SLOTTED + (":3180" if muscl else ":1254"),
        swe_cell_stage=_SLOTTED + ":1441")
    return [kernel_row(
        card, name, path, fns, launches[name],
        max(err[name], errs.get(keys.get(name, name), 0.0)),
        nbytes[name], nops[name], q.dtype, replaces, **extra)
        for name, fns in calls.items()]


def phase_wb(steps, errs, dev, mesh):
    """The well-balanced main paths at full size (`run_main_path`): HR
    euler, BS2002 euler, and BS2002 with MUSCL and the positivity limiter
    under ssprk2; each kernel of the path held against its plain version
    and timed at the path's shapes; then a lake at rest on the same
    mesh."""
    card = nvidia_smi_line()
    area = mesh.cell_area
    rows = []
    # HR floods a floodplain whose bump tops are dry; BS2002 one whose bumps
    # are submerged: over dry bump tops BS2002 diverges in both packages
    # (ROADMAP fault 19)
    runs = (
        ("unstructured+hr", dict(wb="hydrostatic_reconstruction", dt=DT_WB),
         H_FLOODPLAIN,
         {"swe_edge_flux": 1, "swe_cell_stage": 1, "courant_argmax": 1}),
        ("unstructured+bs2002", dict(wb="bs2002", dt=DT_WB), H_WB_SUBMERGED,
         {"swe_eta_vertex": 1, "swe_edge_flux": 1, "swe_cell_stage": 1,
          "courant_argmax": 1}),
        ("unstructured+bs2002+muscl",
         dict(wb="bs2002", dt=DT_WB, scheme="ssprk2", second_order=True),
         H_WB_SUBMERGED,
         dict({k: 2 for k in ("swe_eta_vertex", "swe_muscl_grad",
                              "swe_edge_flux", "swe_positivity_drain",
                              "swe_positivity_scale", "swe_cell_stage")},
              courant_argmax=1)),
    )
    for path, deck, floodplain, per_step in runs:
        muscl = deck.get("second_order", False)
        log(f"== phase 7: {path} main path, the dam break over a bumpy bed "
            f"({deck['wb']}, {deck.get('scheme', 'euler')}, dt "
            f"{deck['dt']} s, floodplain eta {floodplain} m), "
            f"{mesh.num_cells:,} cells, f32")

        def check(sim, q0, muscl=muscl):
            check_state_and_budget(sim, q0, area, -1e-7 if muscl else 0.0)

        sim, launches = run_main_path(
            path, lambda n, plain=False: wb_simulation(
                n, dev, mesh, dam_eta(floodplain), plain, **deck),
            steps, per_step, check)

        # each kernel of the path at its shapes: held against its plain
        # version on the final state, then timed
        op, q, bv = sim.operator, sim.q, sim.boundary_values
        dt = torch.tensor(deck["dt"], dtype=q.dtype, device=dev)
        path_rows = wb_kernel_rows(card, path, op, q, bv, dt, launches, errs)
        rows += path_rows
        # SWEOperator.apply (the rk4 rhs, the TPU's fused rhs kernel with
        # its well-balancing branch): the edge phase, K1c and K1b rhs
        pop = plain_operator(op)
        apply_ms = device_ms(lambda: op.apply(q, dt, bv, None))
        apply_plain = device_ms(lambda: pop.apply(q, dt, bv, None), reps=5)
        log(f"  [{card}] SWEOperator.apply on the {path} path: device "
            f"{apply_ms:.4f} ms, plain {apply_plain:.4f} ms, sum of its "
            f"kernels' stage-mode bounds "
            f"{sum(r['bound_ms'] for r in path_rows):.4f} ms")
        del sim
    lake_at_rest(dev, mesh)
    return rows


def lake_at_rest(dev, mesh):
    """A lake at rest on the phase-7 mesh, all walls reflecting: HR at eta
    0.05 m (partly dry), BS2002 at eta 0.1 m (submerged). The momentum rows
    of `apply` and, after 100 steps, max |hu|, |hv|. HR must keep the
    rows below 1e-4 (the bound of the JAX package's f32 test,
    tests/test_pallas.py:424-441); BS2002 keeps no lake at rest, in
    either package (ROADMAP fault 19): its numbers are printed (those
    without well-balancing, printed beside them before, are cut from the
    script's time)."""
    card = nvidia_smi_line()
    lake_steps = 100
    for wb, level in (("hydrostatic_reconstruction", H_FLOODPLAIN),
                      ("bs2002", H_WB_SUBMERGED)):
        sim = wb_simulation(lake_steps, dev, mesh,
                            lambda x: np.full_like(x, level),
                            wb=wb, dt=DT_WB, outflow=False)
        dry = float(np.mean(sim.get_height() == 0.0))
        r = sim.operator.apply(
            sim.q, torch.tensor(DT_WB, dtype=sim.q.dtype, device=dev),
            sim.boundary_values, None)
        rhs = float(r.rhs[1:3].abs().max())
        sim.run()
        torch.cuda.synchronize()
        hu = float(np.abs(sim.get_x_momentum()).max())
        hv = float(np.abs(sim.get_y_momentum()).max())
        log(f"  [{card}] lake at rest at eta {level} m ({dry:.3f} of the "
            f"cells dry), {wb}: momentum rhs of apply {rhs:.4e}; after "
            f"{sim.step} steps max |hu| {hu:.4e}, max |hv| {hv:.4e}")
        del sim
        if wb == "hydrostatic_reconstruction" and not rhs < 1e-4:
            raise SystemExit(f"HR lake at rest: momentum rhs {rhs} >= 1e-4")
        if not all(np.isfinite(v) for v in (rhs, hu, hv)):
            raise SystemExit(f"{wb} lake at rest is not finite: "
                             f"{(rhs, hu, hv)}")


# ------------------------------------------------------------------ phase 8
def strip_simulation(steps, dev, mesh, scheme="euler", plain=False,
                     config=dam_break_config):
    """`config`'s dam break on fused_structured in STRIPS row strips, all
    on the one card (parallel.n_devices with an explicit device list), its
    kernels replaced by their plain versions when `plain`."""
    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.ops.structured import make_fused_structured_stepper

    cfg = config(steps, "fused_structured", scheme)
    cfg.parallel.n_devices = STRIPS
    sim = Simulation(cfg, mesh=mesh, device=dev,
                     strip_devices=[dev] * STRIPS)
    st = sim._structured
    if not st.get("strips") or len(st["op"]) != STRIPS:
        raise SystemExit("the strip deck did not take the row-strip path")
    if plain:
        st["op"] = [plain_raster_operator(o) for o in st["op"]]
        st["adv"] = make_fused_structured_stepper(
            st["op"], st["scheme"], accumulate=st["accumulate"])
    return sim


def strip_kernel_rows(card, sim, path, launches, dev, dt, nt=0):
    """The kernels of a strip run, each launched on an inner strip (halo
    rows on both sides) of the run's final state, held against its plain
    version there and timed beside its bound: the {"kernels": ...} rows of
    `path`; and the halo exchange of all strips, timed per stage."""
    from rdycore_tpu_torch.ops.strips import exchange, split_rows

    f32 = torch.float32
    ops = sim._structured["op"]
    strips = [o.strip for o in ops]
    nx = ops[0].plan.nx
    bufs = split_rows(sim.q.to(f32), strips, [dev] * STRIPS, nx)
    op, b, st = ops[1], bufs[1], strips[1]
    bv = sim.boundary_values.to(f32)[:, op.bnd_idx]
    extra = dict(strip=list(st), strips=STRIPS, **({"nt": nt} if nt else {}))
    rows = strip_rows(card, op, b, bv, path, launches, dev, dt, nt, extra)
    ex_ms, timer = device_time(lambda: exchange(bufs, strips, nx))
    ex_bytes = sum(2 * 4 * b.shape[0] * (s.halo_lo + s.halo_hi) * nx
                   for b, s in zip(bufs, strips))
    log(f"  [{card}] halo exchange on the {path} path ({2 * (STRIPS - 1)} "
        f"copies of {st.halo_lo} rows of {b.shape[0]} state rows): device "
        f"{ex_ms:.4f} ms per stage ({timer}), {ex_bytes / 1e6:.3f} MB "
        f"moved, bound {1e3 * ex_bytes / HBM_BYTES_PER_S:.4f} ms")
    return rows


def strip_rows(card, op, b, bv, path, launches, dev, dt, nt, extra):
    """The {"kernels": ...} rows of one strip's kernels (`op`, its buffer
    b and its boundary edges' values bv), each held against its plain
    version on b and timed beside its bound; `extra` joins each row."""
    from rdycore_tpu_torch.ops.kernels import raster_muscl as rm
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_step import swe_raster_step_plain

    f32 = torch.float32
    plan, st = op.plan, op.strip
    nx = plan.nx
    geo = (op.dz_dx, op.dz_dy, op.mannings_n)
    dt_t = torch.tensor(dt, dtype=f32, device=dev)
    stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
    sz, C = 4, st.rows * nx
    if op.second_order:
        got = op.step(b, dt_t, **stage)
        want = rm.raster_muscl_step_plain(plan, b, *geo, dt_t, None,
                                          op.limiter, st, **stage)
        pairs = {"swe_raster_muscl_step": [
            (st.owned(got.out), st.owned(want.out)),
            (got.prim, want.prim), (got.cmax, want.cmax)]}
        blocks = got.cmax
        calls = {"swe_raster_muscl_step": (
            lambda: op.step(b, dt_t, **stage),
            lambda: rm.raster_muscl_step_plain(plan, b, *geo, dt_t, None,
                                               op.limiter, st, **stage),
            None)}
        nbytes = {"swe_raster_muscl_step": raster_muscl_bytes(
            nx, st.rows, blocks.numel(), sz, st)}
        nops = {"swe_raster_muscl_step": OPS_PER_MUSCL_RASTER_CELL * C}
        kernel_names = ("swe_raster_muscl_step",)
    else:
        got = op.step(b, dt_t, **stage)
        want = swe_raster_step_plain(plan, b, *geo, dt_t,
                                     num_sediment=op.num_sediment, strip=st,
                                     **stage)
        pairs = {"swe_raster_step": [
            (st.owned(got.out), st.owned(want.out)),
            (got.prim, want.prim), (got.cmax, want.cmax)]}
        blocks = got.cmax
        calls = {"swe_raster_step": (
            lambda: op.step(b, dt_t, **stage),
            lambda: swe_raster_step_plain(
                plan, b, *geo, dt_t, num_sediment=op.num_sediment, strip=st,
                **stage), None)}
        # K2's bytes over the owned rows, and the halo rows it reads
        nbytes = {"swe_raster_step": raster_step_bytes(
            C, 3 + nt, blocks.numel(), sz)
            + sz * (3 + nt) * (st.halo_lo + st.halo_hi) * nx}
        nops = {"swe_raster_step": (
            OPS_PER_RASTER_CELL + nt * OPS_PER_TRACER["swe_raster_step"]) * C}
        kernel_names = ("swe_raster_step",)
    # K1c on the strip's block maxima, K1a on its boundary edges
    run = (torch.zeros((), dtype=f32, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    mk, ik = op.courant_max(blocks, dt_t, *run)
    mp, ip = courant_argmax_plain(blocks)
    th, ta = plan.tiny_h, plan.h_anuga
    fbk = op.boundary_fluxes(b[:3], bv[:3])
    fbp = swe_edge_flux_plain(op.bnd, b[:3], bv[:3], th, ta)[0][:, :-1]
    pairs["swe_edge_flux"] = [(fbk[r], fbp[r]) for r in range(3)]
    rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
    err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
    exact = float(mk) == float(mp) and int(ik) == int(ip)
    err["courant_argmax"] = abs(float(mk) - float(mp))
    log(f"  strip {list(st)} kernels vs plain on the {path} path "
        f"(relative): {rel}; Courant fold {'exact' if exact else 'DIFFERS'}")
    if not (exact and all(v <= TOL[f32] for v in rel.values())):
        raise SystemExit(f"{path} strip kernel check failed")
    check_one_kernel(lambda: op.courant_max(blocks, dt_t, *run),
                     f"courant_argmax on a strip's {blocks.numel():,} block "
                     "maxima")
    Eb = op.bnd.bnd_left.shape[0]
    calls["courant_argmax"] = (lambda: op.courant_max(blocks, dt_t, *run),
                               lambda: courant_argmax_plain(blocks, dt_t,
                                                            *run),
                               lambda: torch.max(blocks, 0))
    calls["swe_edge_flux"] = (
        lambda: op.boundary_fluxes(b[:3], bv[:3]),
        lambda: swe_edge_flux_plain(op.bnd, b[:3], bv[:3], th, ta), None)
    nbytes["courant_argmax"] = courant_bytes(blocks.numel(), sz)
    nbytes["swe_edge_flux"] = edge_flux_bytes(
        0, Eb, 3 * sz * int(torch.unique(op.bnd.bnd_left).numel()), sz)
    nops["courant_argmax"] = OPS_PER_VALUE * blocks.numel()
    nops["swe_edge_flux"] = OPS_PER_EDGE * Eb
    replaces = dict(REPLACES, courant_argmax=_SHARDED,
                    swe_edge_flux=_SLOTTED + ":1254",
                    **{k: _SHARDED for k in kernel_names})
    # the strip modes run only here: their own errors
    return [kernel_row(card, name, path, fns, launches[name], err[name],
                       nbytes[name], nops[name], f32, replaces, **extra)
            for name, fns in calls.items()]


def phase_strips(steps, dev, mesh):
    """Phase 8: the raster main path in STRIPS row strips on the one card,
    bit for bit phase 4's single strip, then the tracer and second-order
    decks in strips against their single strips, and each strip kernel
    held against its plain version and timed at a strip's shapes."""
    from rdycore_tpu_torch.ops import kernels

    card = nvidia_smi_line()
    area = mesh.cell_area
    path = f"raster+strips{STRIPS}"
    log(f"== phase 8: raster main path in {STRIPS} row strips on one card "
        f"(fused_structured, parallel.n_devices: {STRIPS}, an explicit "
        f"device list), dam break on {mesh.num_cells:,} cells, f32")

    def check(sim, q0):
        check_state_and_budget(sim, q0, area)
        same = same_state(final_state(sim), REFERENCE["raster"])
        log(f"  {STRIPS} strips against phase 4's single strip after "
            f"{sim.step} steps (q, t, Courant number, boundary-flux "
            f"accumulator): {'bit for bit' if same else 'DIFFERENT'}")
        if not same:
            raise SystemExit(f"{path} differs from the single strip")

    main = f"raster main path in {STRIPS} strips"
    sim, launches = run_main_path(
        main, lambda n, plain=False: strip_simulation(n, dev, mesh,
                                                      plain=plain),
        steps, {"swe_raster_step": STRIPS, "courant_argmax": STRIPS,
                "swe_edge_flux": STRIPS}, check)
    (one_ms, one_rate), (ms, rate) = STEADY["raster main path"], STEADY[main]
    log(f"  [{card}] steady state: {STRIPS} strips {ms:.4f} ms/step, "
        f"{rate:.4e} cell-updates/s; phase 4's single strip {one_ms:.4f} "
        f"ms/step, {one_rate:.4e} cell-updates/s")
    rows = strip_kernel_rows(card, sim, path, launches, dev, DT)
    del sim
    # the tracer and second-order decks, a few dozen steps each
    n = 24
    for tag, config, scheme, dt, per_step in (
            ("tracers", tracer_dam_break_config, "euler", DT,
             {"swe_raster_step": 1, "courant_argmax": 1,
              "swe_edge_flux": 1}),
            ("muscl", muscl_dam_break_config, "ssprk2", DT_MUSCL,
             {"swe_raster_muscl_step": 2,
              "courant_argmax": 1, "swe_edge_flux": 1})):
        one = raster_simulation(n, dev, mesh, scheme, config=config)
        one.run()
        four = strip_simulation(n, dev, mesh, scheme, config=config)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        four.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        check_launches(f"{path}+{tag} run of {n} steps", launches,
                       {k: STRIPS * v * n for k, v in per_step.items()})
        same = same_state(final_state(four), final_state(one))
        finite = bool(np.isfinite(four.get_solution()).all())
        log(f"  [{card}] {path}+{tag} ({scheme}): {n} steps in {wall:.3f} s "
            f"(first interval included); against the single strip (q, t, "
            f"Courant number, boundary-flux accumulator): "
            f"{'bit for bit' if same else 'DIFFERENT'}; finite {finite}")
        if not (same and finite and four.step == n):
            raise SystemExit(f"{path}+{tag} differs from the single strip")
        rows += strip_kernel_rows(card, four, f"{path}+{tag}", launches,
                                  dev, dt, nt=NT if tag == "tracers" else 0)
        del one, four
    return rows


# ------------------------------------------------------------------ phase 9
def imex_dam_break_config(steps, backend="xla", scheme="ark_imex"):
    """Phase 3's dam break (Manning 0.018, critical outflow on the right)
    under ARS(2,2,2) ARK-IMEX, coupling intervals of 50 steps."""
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    d = dam_break_dict(steps, backend, scheme)
    d["time"]["coupling_interval"] = IMEX_INTERVAL_STEPS * DT
    return config_from_dict(d).validate()


def closed_dam_break_config(steps, backend="xla", scheme="beuler",
                            second_order=False):
    """Phase 3's dam break with every wall reflecting (a closed box) at
    dt = DT_BEULER, coupling intervals of two steps; second order: MUSCL
    minmod with the positivity limiter."""
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    d = dam_break_dict(steps, backend, scheme)
    d["boundary_conditions"] = []
    d["time"].update(time_step=DT_BEULER, stop=steps * DT_BEULER,
                     coupling_interval=2 * DT_BEULER)
    if second_order:
        d["numerics"].update(second_order=True, limiter="minmod")
    return config_from_dict(d).validate()


def check_closed_box(sim, q0, area):
    """h finite and >= -1e-6, and the volume of the closed box kept to
    1e-5 of the initial volume (every GMRES update is a sum of Krylov
    vectors, each of zero net volume in a closed box; f32 sums)."""
    hq = sim.get_height()
    finite = bool(np.isfinite(sim.get_solution()).all())
    v0 = float(np.sum(q0[0] * area))
    v1 = float(np.sum(hq.astype(np.float64) * area))
    kept = abs(v1 - v0) / v0
    log(f"  state: finite {finite}, min h {hq.min():.3e}; volume initial "
        f"{v0:.9e} m^3, final {v1:.9e}, change {kept:.3e} of the initial "
        f"volume; max Courant {sim.prev_max_courant:.4f}")
    if not (finite and hq.min() >= -1e-6 and kept <= 1e-5):
        raise SystemExit("beuler state or closed-box volume failed")
    if not sim.prev_max_courant > 1.0:
        raise SystemExit(f"beuler ran at a Courant number "
                         f"{sim.prev_max_courant} <= 1")


def run_beuler_path(path, make_sim, steps, per_step, check,
                    plain_bound=2e-5):
    """Drive a beuler path at full size through `Simulation`: its first
    coupling interval (up to 2 steps) with plain residuals (make_sim(n,
    plain=True): the kernels replaced by their plain versions, the JVPs
    through the twin either way), kept aside; then every launch count set
    to 0, and the path on the kernels: its first coupling interval, held
    to the plain run to `plain_bound` relative to 1 + |q| (2e-5: the JAX
    package's bound for kernel against XLA residuals; None: no plain run,
    the kernels held at the path's shapes by its rows alone), and the
    remaining steps; exact launches per step over all `steps` (the counted
    window holds the path's run alone); then check(sim, q0). Returns the
    simulation, the launches and the wall milliseconds per step."""
    from rdycore_tpu_torch.ops import kernels

    card = nvidia_smi_line()
    if plain_bound is not None:
        plain = make_sim(steps, plain=True)
        plain.advance()
        torch.cuda.synchronize()
        qp, c_plain, n_plain = (plain.get_solution(),
                                plain.prev_max_courant, plain.step)
        del plain
    sim = make_sim(steps)
    q0 = sim.get_solution().astype(np.float64)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sim.advance()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    n_first = sim.step
    if plain_bound is not None:
        qk = sim.get_solution()
        rel = float((np.abs(qk - qp) / (1.0 + np.abs(qp))).max())
        log(f"  {n_first} steps, kernel residuals vs plain residuals: max "
            f"|dq| / (1 + |q|) {rel:.3e}; Courant "
            f"{sim.prev_max_courant:.6f} vs {c_plain:.6f}")
        if not (n_first == n_plain == min(steps, 2) and rel <= plain_bound):
            raise SystemExit(f"{path}: kernel residuals differ from plain: "
                             f"{rel}")
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    t_rest = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    if sim.step != steps:
        raise SystemExit(f"{path} took {sim.step} steps, expected {steps}")
    check_launches(path, launches,
                   {k: n * steps for k, n in per_step.items()})
    check(sim, q0)
    ms = 1e3 * (t_first + t_rest) / steps
    log(f"  [{card}] {steps} steps in {t_first + t_rest:.3f} s wall = "
        f"{ms:.1f} ms/step (the first interval, {n_first} steps with the "
        f"libraries' loads, {t_first:.3f} s)")
    return sim, launches, ms


def beuler_split(card, path, first, F, F_lin, u, dt):
    """One more backward-Euler step from u, each residual (`first`, the
    step's Courant and diagnostics call, and F) and each JVP (through
    F_lin) between CUDA events: ms of the step split into residual
    kernels, JVPs, and the GMRES and line-search glue (the rest), and the
    residual norm ||u1 - u - dt F(u1)|| after the last Newton iteration
    beside its starting value ||dt F(u)||."""
    from rdycore_tpu_torch.timestepping import newton_beuler_solve

    spans = {"residual": [], "jvp": []}

    def timed(kind, fn):
        def g(x):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fn(x)
            e1.record()
            spans[kind].append((e0, e1))
            return out
        return g

    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    timed("residual", first)(u)
    u1 = newton_beuler_solve(timed("residual", F), timed("jvp", F_lin), u,
                             dt)
    e1.record()
    torch.cuda.synchronize()
    total = e0.elapsed_time(e1)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    glue = total - ms["residual"] - ms["jvp"]
    r0 = float(torch.linalg.vector_norm(dt * F(u)))
    r1 = float(torch.linalg.vector_norm(u1 - u - dt * F(u1)))
    log(f"  [{card}] {path} step split (CUDA events): {total:.1f} ms = "
        f"residual kernels {ms['residual']:.1f} ms ({len(spans['residual'])}"
        f" calls) + JVPs {ms['jvp']:.1f} ms ({len(spans['jvp'])} calls) + "
        f"GMRES and line-search glue {glue:.1f} ms; Newton residual "
        f"||u - u^n - dt F(u)|| {r0:.4e} at u^n -> {r1:.4e} "
        f"({r1 / r0:.3e})")
    if not (np.isfinite(r1) and r1 < r0):
        raise SystemExit(f"{path}: the Newton residual did not fall")
    return dict(step_ms=total, residual_ms=ms["residual"],
                jvp_ms=ms["jvp"], glue_ms=glue, residual_start=r0,
                residual_end=r1)


def unstructured_rows(card, path, op, q, bv, dt, launches, per_step, errs,
                      prim=True):
    """K1a, K1b in rhs mode and K1c of an unstructured rhs-mode path
    (`apply` and `rhs`) at its shapes: held against their plain versions
    on (q, bv) and timed; the {"kernels": ...} rows of `path`."""
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain

    a, s = op.arrays, q.element_size()
    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
              xq2018_threshold=op.xq2018_threshold,
              source_method=op.source_method)
    flux, courant = op.edge_flux(q, bv)
    fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
    ok_ = op.cell_stage(fp, q, dt, None, emit_prim=prim)
    op_ = swe_cell_stage_plain(a, fp, q, dt, None, emit_prim=prim, **kw)
    mk, ik = op.courant_max(cp)
    mp, ip = courant_argmax_plain(cp)
    pairs = {"swe_edge_flux": [(flux, fp), (courant, cp)],
             "swe_cell_stage": [(ok_.flux_div, op_.flux_div),
                                (ok_.rhs, op_.rhs)]
             + ([(ok_.prim, op_.prim)] if prim else [])}
    rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
    err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
    err["courant_argmax"] = abs(float(mk) - float(mp))
    log(f"  full-size kernels vs plain on the {path} path (relative): "
        f"{rel}; courant idx {int(ik)} (plain {int(ip)})")
    if not (all(v <= TOL[q.dtype] for v in rel.values())
            and int(ik) == int(ip)):
        raise SystemExit(f"full-size {path} kernel check failed")
    run = (torch.zeros((), dtype=q.dtype, device=q.device),
           torch.zeros((), dtype=torch.int32, device=q.device))
    calls = {
        "swe_edge_flux": (
            lambda: op.edge_flux(q, bv),
            lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga),
            None),
        "swe_cell_stage": (
            lambda: op.cell_stage(flux, q, dt, None, emit_prim=prim),
            lambda: swe_cell_stage_plain(a, flux, q, dt, None,
                                         emit_prim=prim, **kw),
            None),
        "courant_argmax": (
            lambda: op.courant_max(courant, dt, *run),
            lambda: courant_argmax_plain(courant, dt, *run),
            lambda: torch.max(courant, 0)),
    }
    q_bytes = q.numel() * s
    nbytes = kernel_bytes(op, q_bytes, s, rhs=True)
    if not prim:  # rhs mode writes flux_div and rhs alone
        nbytes["swe_cell_stage"] -= q_bytes
    nops = {"swe_edge_flux": OPS_PER_EDGE * op.num_edges,
            "swe_cell_stage": OPS_PER_CELL * op.num_cells,
            "courant_argmax": OPS_PER_VALUE * op.num_edges}
    return [kernel_row(card, name, path, fns, launches[name],
                       max(err[name], errs.get(name, 0.0)), nbytes[name],
                       nops[name], q.dtype,
                       launches_per_step=per_step[name])
            for name, fns in calls.items()]


def raster_rhs_rows(card, path, sim, launches, per_step, errs):
    """K2 (or K2 MUSCL) in rhs mode, K1c on its block maxima and K1a on
    the boundary edges at the raster path's shapes: held against their
    plain versions on the final state and timed; the rows of `path`."""
    from rdycore_tpu_torch.ops.kernels import raster_muscl as rm
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_step import (
        swe_raster_step_plain)

    op, q = sim._structured["op"], sim.q
    bv = sim.boundary_values.to(q.dtype)
    plan, s, C = op.plan, q.element_size(), q.shape[1]
    geo = (op.dz_dx, op.dz_dy, op.mannings_n)
    dt = torch.tensor(DT_BEULER, dtype=q.dtype, device=q.device)
    k2 = "swe_raster_muscl_step" if op.second_order else "swe_raster_step"
    if op.second_order:
        def plain():
            return rm.raster_muscl_step_plain(plan, q, *geo, dt, None,
                                              op.limiter)
    else:
        def plain():
            return swe_raster_step_plain(plan, q, *geo, dt)
    got, want = op.step(q, dt), plain()
    blocks = got.cmax
    run = (torch.zeros((), dtype=q.dtype, device=q.device),
           torch.zeros((), dtype=torch.int32, device=q.device))
    mk, ik = op.courant_max(blocks, dt, *run)
    mp, ip = courant_argmax_plain(blocks)
    fk = op.boundary_fluxes(q, bv)
    fp = swe_edge_flux_plain(op.bnd, q, bv, plan.tiny_h,
                             plan.h_anuga)[0][:, :-1]
    pairs = {k2: [(got.out, want.out), (got.cmax, want.cmax)],
             "swe_edge_flux": [(fk[k], fp[k]) for k in range(3)]}
    rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
    err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
    exact = float(mk) == float(mp) and int(ik) == int(ip)
    err["courant_argmax"] = abs(float(mk) - float(mp))
    log(f"  full-size kernels vs plain on the {path} path (relative): {rel};"
        f" Courant fold {'exact' if exact else 'DIFFERS'}")
    if not (exact and all(v <= TOL[q.dtype] for v in rel.values())):
        raise SystemExit(f"full-size {path} kernel check failed")
    calls = {
        k2: (lambda: op.step(q, dt), plain, None),
        "courant_argmax": (lambda: op.courant_max(blocks, dt, *run),
                           lambda: courant_argmax_plain(blocks, dt, *run),
                           lambda: torch.max(blocks, 0)),
        "swe_edge_flux": (
            lambda: op.boundary_fluxes(q, bv),
            lambda: swe_edge_flux_plain(op.bnd, q, bv, plan.tiny_h,
                                        plan.h_anuga), None),
    }
    Eb = op.bnd.bnd_left.shape[0]
    # rhs mode: q (K2 MUSCL: and its two-row halos, none on one strip),
    # the three geometry planes and dt read; rhs and the tile maxima
    # written
    nbytes = {k2: s * ((3 + 3 + 3) * C + 1 + blocks.numel()),
              "courant_argmax": courant_bytes(blocks.numel(), s),
              "swe_edge_flux": edge_flux_bytes(
                  0, Eb, 3 * s * int(torch.unique(op.bnd.bnd_left).numel()),
                  s)}
    nops = {k2: (OPS_PER_MUSCL_RASTER_CELL if op.second_order
                 else OPS_PER_RASTER_CELL) * C,
            "courant_argmax": OPS_PER_VALUE * blocks.numel(),
            "swe_edge_flux": OPS_PER_EDGE * Eb}
    replaces = dict(REPLACES, courant_argmax=REPLACES[k2],
                    swe_edge_flux=_SLOTTED + ":1254")
    return [kernel_row(card, name, path, fns, launches[name],
                       max(err[name], errs.get(name, 0.0)), nbytes[name],
                       nops[name], q.dtype, replaces,
                       launches_per_step=per_step[name])
            for name, fns in calls.items()]


def phase_implicit(errs, dev, mesh):
    """Phase 9: the IMEX and implicit schemes at full size. (a) ark_imex on
    the unstructured path (`run_main_path`); (b) beuler on the
    unstructured path (against plain residuals, then one more step split
    into residual kernels, JVPs and glue, `beuler_split`), (c) on the
    raster and (d) on the raster at second order (the kernels' step
    alone), all through `run_beuler_path` in a closed box at a Courant
    number above 1. The rows of each path name it and carry its launches
    per step."""
    from rdycore_tpu_torch.operator import linearization_twin

    card = nvidia_smi_line()
    area = mesh.cell_area
    rows, splits = [], {}

    log(f"== phase 9a: ark_imex (ARS(2,2,2), implicit Manning friction) on "
        f"the unstructured path, dam break on {mesh.num_cells:,} cells, f32")
    imex_step = {"swe_edge_flux": 2, "swe_cell_stage": 2,
                 "courant_argmax": 1}
    sim, launches = run_main_path(
        "unstructured ark_imex path",
        lambda n, plain=False: unstructured_simulation(
            n, dev, mesh, plain, config=imex_dam_break_config),
        IMEX_STEPS, imex_step,
        lambda sim, q0: check_state_and_budget(sim, q0, area))
    # the explicit part's operator: friction-free K1b
    op = dataclasses.replace(sim.operator, source_method=2)
    dt = torch.tensor(DT, dtype=sim.q.dtype, device=dev)
    rows += unstructured_rows(card, "unstructured ark_imex", op, sim.q,
                              sim.boundary_values, dt, launches, imex_step,
                              errs)
    del sim

    beuler_step = {"swe_edge_flux": 25, "swe_cell_stage": 25,
                   "courant_argmax": 1}
    log(f"== phase 9b: beuler (Newton-GMRES, kernel residuals, twin JVPs) "
        f"on the unstructured path, closed dam break on {mesh.num_cells:,} "
        f"cells, dt {DT_BEULER} s, f32")
    sim, launches, wall = run_beuler_path(
        "unstructured beuler path",
        lambda n, plain=False: unstructured_simulation(
            n, dev, mesh, plain, config=closed_dam_break_config),
        BEULER_STEPS, beuler_step,
        lambda sim, q0: check_closed_box(sim, q0, area))
    op, bv, q = sim.operator, sim.boundary_values, sim.q
    # 15b's reference: the state (in the mesh's own order) and wall ms
    REFERENCE["beuler"] = (sim.get_solution(), wall)
    dt = torch.tensor(DT_BEULER, dtype=q.dtype, device=dev)
    twin = linearization_twin(op)
    splits["unstructured beuler"] = dict(wall_ms_per_step=wall, **beuler_split(
        card, "unstructured beuler", lambda u: op.apply(u, dt, bv, None),
        lambda u: op.rhs(u, dt, bv, None),
        lambda u: twin.rhs(u, dt, bv, None), q, dt))
    rows += unstructured_rows(card, "unstructured beuler", op, q, bv, dt,
                              launches, beuler_step, errs, prim=False)
    del sim, twin

    for tag, second_order in (("raster beuler", False),
                              ("raster beuler+muscl", True)):
        k2 = "swe_raster_muscl_step" if second_order else "swe_raster_step"
        per_step = {k2: 25, "courant_argmax": 1, "swe_edge_flux": 1}
        order = (" at second order (K2 MUSCL rhs, minmod)" if second_order
                 else "")
        log(f"== phase 9{'d' if second_order else 'c'}: beuler on the raster"
            f"{order}, closed dam break on {mesh.num_cells:,} cells, dt "
            f"{DT_BEULER} s, f32")

        def make(n, plain=False, so=second_order):
            return raster_simulation(
                n, dev, mesh, "beuler", plain,
                lambda k, b, s: closed_dam_break_config(k, b, s, so))

        # the raster's beuler steps are the script's dearest (17-18 s each
        # on the card, host-bound JVPs): the kernels' step alone, K2's rhs
        # mode held at the path's shapes by its rows (the plain-residual
        # step and the step split were measured on the card before,
        # PERF.md)
        sim, launches, wall = run_beuler_path(
            f"{tag} path", make, BEULER_STEPS, per_step,
            lambda sim, q0: check_closed_box(sim, q0, area), None)
        splits[tag] = dict(wall_ms_per_step=wall)
        rows += raster_rhs_rows(card, tag, sim, launches, per_step, errs)
        del sim
    log(f"  [{card}] beuler steps (ms): {json.dumps(splits)}")
    return rows


# ----------------------------------------------------------------- phase 10
def mms_deck_config(dt, stop, refinements, mesh_file, **deck):
    """The MMS deck of tools/torch_mms_decks.py (f64) on `mesh_file`."""
    from rdycore_tpu_torch.config.yaml_input import config_from_dict
    from tools.torch_mms_decks import mms_deck

    return config_from_dict(mms_deck(mesh_file, dt, stop, refinements,
                                     **deck)).validate()


def stage_table(scheme):
    """The stage coefficients of a stage-mode scheme."""
    from rdycore_tpu_torch.timestepping import _FUSED_STEP_STAGES

    return _FUSED_STEP_STAGES[scheme]


def mms_step_split(card, path, level, reps=20):
    """One MMS step at the level's shapes, repeated, split by CUDA events
    into the analytic forcing (bc_fn and src_fn at the half-step time) and
    each kernel group of its stages (the edge phase: K1a, with K3a and K3b
    at second order; K1c; K1b), as the step loop calls them. Returns
    {part: ms per step}."""
    op, q = level.op, level.q0
    stages = stage_table(level.problem.config.numerics.temporal)
    dt = q.new_full((), level.dt)
    tt = q.new_full((), 0.25 * level.t_final)
    cmax = q.new_zeros(())
    cedge = torch.zeros((), dtype=torch.int32, device=q.device)
    parts = ("forcing", "edge phase", "K1c", "K1b")
    spans = {k: [] for k in parts}

    def timed(kind, fn):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn()
        e1.record()
        spans[kind].append((e0, e1))
        return out

    def step():
        t_half = tt + 0.5 * dt
        bv, es = timed("forcing", lambda: (level.bc_fn(t_half),
                                           level.src_fn(t_half)))
        qs = q
        for i, coeffs in enumerate(stages):
            flux, courant = timed("edge phase",
                                  lambda: op.fluxes(qs, bv, dt))
            if i == 0:
                timed("K1c", lambda: op.courant_max(courant, dt, cmax,
                                                    cedge))
            qA = {"qA": q} if i else {}
            qs = timed("K1b", lambda: op.cell_stage(
                flux, qs, dt, es, stage=coeffs, **qA).q_out)

    step()
    torch.cuda.synchronize()
    spans = {k: [] for k in parts}
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        step()
    e1.record()
    torch.cuda.synchronize()
    ms = {k: sum(a.elapsed_time(b) for a, b in v) / reps
          for k, v in spans.items()}
    ms["step"] = e0.elapsed_time(e1) / reps
    kern = ms["edge phase"] + ms["K1c"] + ms["K1b"]
    log(f"  [{card}] {path} step split on {q.shape[1]:,} cells (CUDA "
        f"events, {reps} steps): {ms['step']:.4f} ms = forcing "
        f"{ms['forcing']:.4f} + kernels {kern:.4f} (edge phase "
        f"{ms['edge phase']:.4f}, K1c {ms['K1c']:.4f}, K1b {ms['K1b']:.4f})"
        f"; forcing {100 * ms['forcing'] / ms['step']:.1f}% of the step")
    return ms


def mms_rows(card, path, op, q, bv, es, dt, launches, per_step, errs,
             emit_prim=False):
    """Each kernel of an unstructured stage-mode path (K3a and K3b at
    second order, K1a, K1b with the sources es, K1c) at its shapes on
    (q, bv): held against its plain version (1e-12 relative in f64, the
    Courant fold exact) and timed beside its bound; the rows of `path`."""
    from rdycore_tpu_torch.ops.kernels import muscl as mk
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients

    a, s, nt = op.arrays, q.element_size(), op.num_tracers
    upwind = op.riemann == "upwind_roe"
    kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
              xq2018_threshold=op.xq2018_threshold,
              source_method=op.source_method, num_sediment=op.num_sediment)
    stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=emit_prim)
    run = (q.new_zeros(()), torch.zeros((), dtype=torch.int32,
                                        device=q.device))
    pairs, calls = {}, {}
    gk = gp = None
    if op.second_order:
        gk, gp = op.muscl_grad(q), ls_gradients(a, q)
        pairs["swe_muscl_grad"] = [(gk, gp)]
        calls["swe_muscl_grad"] = (lambda: op.muscl_grad(q),
                                   lambda: ls_gradients(a, q), None)

    def edge_plain(grad):
        return swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga, upwind,
                                   grad, op.limiter)

    flux, courant = op.edge_flux(q, bv, gp)
    fp, cp = edge_plain(gp)
    pairs["swe_edge_flux"] = [(flux, fp), (courant, cp)]
    calls["swe_edge_flux"] = (lambda: op.edge_flux(q, bv, gk),
                              lambda: edge_plain(gk), None)
    if op.second_order:
        sk = mk.swe_positivity_drain(a, fp, q[0], dt)
        sp = mk.positivity_drain_plain(a, fp, q[0], dt)
        pairs["swe_positivity_drain"] = [(sk, sp)]
        pairs["swe_positivity_scale"] = [(
            mk.swe_positivity_scale(a, fp.clone(), sp),
            mk.positivity_scale_plain(a, fp.clone(), sp))]
        calls["swe_positivity_drain"] = (
            lambda: mk.swe_positivity_drain(a, flux, q[0], dt),
            lambda: mk.positivity_drain_plain(a, flux, q[0], dt), None)
        calls["swe_positivity_scale"] = (
            lambda: mk.swe_positivity_scale(a, flux, sk),
            lambda: mk.positivity_scale_plain(a, flux, sk), None)
    ok_ = op.cell_stage(fp, q, dt, es, **stage)
    op_ = swe_cell_stage_plain(a, fp, q, dt, es, **kw, **stage)
    pairs["swe_cell_stage"] = [(ok_.q_out, op_.q_out)] + (
        [(ok_.prim, op_.prim)] if emit_prim else [])
    calls["swe_cell_stage"] = (
        lambda: op.cell_stage(flux, q, dt, es, **stage),
        lambda: swe_cell_stage_plain(a, flux, q, dt, es, **kw, **stage),
        None)
    mk_, ik = op.courant_max(cp, dt, *run)
    mp, ip = courant_argmax_plain(cp)
    calls["courant_argmax"] = (
        lambda: op.courant_max(courant, dt, *run),
        lambda: courant_argmax_plain(courant, dt, *run),
        lambda: torch.max(courant, 0))
    rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
    err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
    err["courant_argmax"] = abs(float(mk_) - float(mp))
    exact = float(mk_) == float(mp) and int(ik) == int(ip)
    log(f"  kernels vs plain at the {path} path's shapes (relative): {rel};"
        f" Courant fold {'exact' if exact else 'DIFFERS'}")
    if not (exact and all(v <= TOL[q.dtype] for v in rel.values())):
        raise SystemExit(f"{path}: a kernel differs from its plain version")

    q_bytes = q.numel() * s
    base = kernel_bytes(op, q_bytes, s)
    nbytes = muscl_bytes(op, q_bytes, s) if op.second_order else {}
    nbytes["swe_edge_flux"] = nbytes.get("swe_edge_flux",
                                         base["swe_edge_flux"])
    # K1b's base bytes write q_out and the primitives and read no
    # sources: add the sources where es is given, drop the primitives
    # where they are not asked for
    nbytes["swe_cell_stage"] = (base["swe_cell_stage"]
                                + (q_bytes if es is not None else 0)
                                - (0 if emit_prim else q_bytes))
    nbytes["courant_argmax"] = base["courant_argmax"]
    C, E, Ei = op.num_cells, op.num_edges, op.num_internal_edges
    edge_ops = (OPS_PER_EDGE * (E - Ei) + OPS_PER_MUSCL_EDGE * Ei
                if op.second_order else OPS_PER_EDGE * E)
    nops = {"swe_muscl_grad": OPS_PER_GRAD_CELL * C,
            "swe_edge_flux": edge_ops
            + OPS_PER_TRACER["swe_edge_flux"] * nt * E,
            "swe_positivity_drain": OPS_PER_DRAIN_CELL * C,
            "swe_positivity_scale": OPS_PER_SCALE_EDGE * E,
            "swe_cell_stage": (OPS_PER_CELL + OPS_PER_TRACER[
                "swe_cell_stage"] * nt) * C,
            "courant_argmax": OPS_PER_VALUE * E}
    replaces = (dict(REPLACES, swe_edge_flux=_SLOTTED + ":3180",
                     swe_cell_stage=_SLOTTED + ":1441")
                if op.second_order else REPLACES)
    extra = {"nt": nt} if nt else {}
    rows = [kernel_row(card, name, path, fns, launches[name],
                       max(err[name], errs.get(name, 0.0)), nbytes[name],
                       nops[name], q.dtype, replaces,
                       launches_per_step=per_step[name], **extra)
            for name, fns in calls.items()]
    for row in rows:
        row["dtype"] = str(q.dtype).replace("torch.", "")
    return rows


def mms_study(card, path, cfg, dev, per_step):
    """Drive the MMS driver (`MMSDriver`, as `python -m rdycore_tpu_torch
    deck.yaml --mms` does) over the deck's ladder on the card, with every
    launch count set to 0 just before: each kernel must have been launched
    per_step[name] times a step over all levels' steps (a kernel per_step
    does not name: never). Logs each level's norms and times and the
    rates; returns (driver, verdict, launches)."""
    from rdycore_tpu_torch.mms import MMSDriver
    from rdycore_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    drv = MMSDriver(cfg, device=dev)
    ok = drv.run(log=lambda *a: log("  " + " ".join(map(str, a))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    steps = sum(r.n_steps for r in drv.results)
    check_launches(f"{path} ladder ({steps} steps over "
                   f"{len(drv.results)} levels)", launches,
                   {k: n * steps for k, n in per_step.items()})
    for r in drv.results:
        log(f"  [{card}] {path} level N = {r.num_cells:,}: {r.n_steps} "
            f"steps, setup {r.setup_seconds:.2f} s, run {r.run_seconds:.3f}"
            f" s = {1e3 * r.run_seconds / r.n_steps:.4f} ms/step "
            f"({r.n_steps * r.num_cells / r.run_seconds:.4e} "
            f"cell-updates/s, the norms' copy back included)")
    rates = {k: [float(x) for x in v] for k, v in drv.rates.items()}
    log(f"  [{card}] {path}: {'PASS' if ok else 'FAIL'}; rates "
        f"{json.dumps(rates)}; the whole study {wall:.1f} s")
    return drv, ok, launches


def check_plain_steps(path, level, steps=10):
    """`steps` steps of the level on the kernels, with exact launches
    (K1a, K1b and K1c once a step at first order), held against the same
    steps on the plain versions: every row to 1e-10 relative."""
    from rdycore_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    rk = level.advance(n_steps=steps)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    check_launches(f"{path}, {steps} steps of the finest level", launches,
                   {k: steps for k in ("swe_edge_flux", "swe_cell_stage",
                                       "courant_argmax")})
    rp = level.advance(n_steps=steps, op=plain_operator(level.op))
    err = rows_rel_err(rk.q, rp.q)
    log(f"  {steps} steps of the finest level, kernels vs plain versions "
        f"(worst row): {err:.3e}")
    if not err <= 1e-10:
        raise SystemExit(f"{path}: {steps} steps differ from plain: {err}")
    return rk.q


def phase_thacker(card, errs, dev):
    """Phase 10e: Thacker's bowl (tests/test_thacker.py's deck,
    `tools/torch_thacker.py`) on THACKER_N^2 quads, f64, one period under
    euler. First order at dt = THACKER_DT (a Courant number near 0.28): h
    finite and >= 0, the mass to 1e-11, the front moved, L1/mean < 0.08,
    the momenta back near 0. (MUSCL minmod with the positivity limiter at
    that dt diverges in both packages, ROADMAP fault 22; the run that
    showed it on the card before, PERF.md, is cut from the script's
    time.) At
    dt / 2 MUSCL is held to the test's rule against first order at the
    same dt: finite, its error at most 1.05 times first order's. For the
    MUSCL run, the cells whose donor factor fell below 1 in each quarter
    period; exact
    launches in every run; the MUSCL path's kernels held and timed at its
    shapes."""
    from rdycore_tpu_torch.constants import GRAVITY
    from rdycore_tpu_torch.operator import build_operator
    from rdycore_tpu_torch.ops import kernels
    from rdycore_tpu_torch.timestepping import make_interval_advancer
    from tools.torch_thacker import (ETA0, H0, counting_operator,
                                     thacker_case, thacker_eta)

    t0 = time.perf_counter()
    mesh, r2, w, A, T, h0 = thacker_case(THACKER_N)
    log(f"== phase 10e: Thacker's bowl on {THACKER_N}x{THACKER_N} quads "
        f"({mesh.num_cells:,} cells), f64, mesh in "
        f"{time.perf_counter() - t0:.2f} s")
    area = mesh.cell_area
    first = {"swe_edge_flux": 1, "swe_cell_stage": 1, "courant_argmax": 1}
    second = dict(first, swe_muscl_grad=1, swe_positivity_drain=1,
                  swe_positivity_scale=1)

    def run(second_order, dt):
        """One period on the kernels: (end state on the card, launches,
        L1/mean, the operator)."""
        tag = (f"{'MUSCL' if second_order else 'first order'} at dt {dt} "
               "s")
        t0 = time.perf_counter()
        op = build_operator(mesh, mannings_n=np.zeros(mesh.num_cells),
                            second_order=second_order, dtype=torch.float64,
                            device=dev)
        n_steps = int(np.ceil(T / dt))
        if second_order:  # one limiter pass a step under euler
            op = counting_operator(
                op, mesh.num_cells, 4,
                lambda k: min(3, int(k * dt / (T / 4))))
        q0 = torch.zeros((3, mesh.num_cells), dtype=torch.float64,
                         device=dev)
        q0[0] = torch.as_tensor(h0, device=dev)
        t_setup = time.perf_counter() - t0
        adv = make_interval_advancer(op, "euler")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = adv(q0, q0.new_full((), 0.0), q0.new_full((), dt), n_steps,
                  q0.new_full((), T), op.zero_boundary_values(),
                  torch.zeros_like(q0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        check_launches(f"Thacker bowl, {tag}", launches,
                       {k: v * n_steps for k, v in
                        (second if second_order else first).items()})
        h1 = res.q[0].cpu().numpy()
        wet = (h0 > 1e-4) | (h1 > 1e-4)
        l1 = float(np.abs(h1 - h0)[wet].mean() / h0[wet].mean())
        log(f"  [{card}] {tag}: setup {t_setup:.2f} s, {n_steps} steps to "
            f"T = {T:.6f} s in {wall:.3f} s = {1e3 * wall / n_steps:.4f} "
            f"ms/step, {n_steps * mesh.num_cells / wall:.4e} cell-updates/s;"
            f" finite {bool(torch.isfinite(res.q).all())}, max Courant "
            f"{float(res.max_courant):.4g}, L1/mean {l1:.6g}, min h "
            f"{np.nanmin(h1):.3e}")
        if second_order:
            cells = [int(c) for c in op.below.sum(dim=1).cpu()]
            events = [int(e) for e in op.events.cpu()]
            log(f"  [{card}] {tag}: cells whose donor factor fell below 1 "
                f"in each quarter period {cells} of {mesh.num_cells:,} "
                f"(cell-steps {events})")
        return res.q, launches, l1, op

    q1, _, l1, _ = run(False, THACKER_DT)
    h1 = q1[0].cpu().numpy()
    m0, m1 = float((h0 * area).sum()), float((h1 * area).sum())
    h_mid = np.maximum(thacker_eta(r2, T / 2.0, w, A) - mesh.cell_z, 0.0)
    moved = int(((h_mid > 0) != (h0 > 0)).sum())
    hu_max = float(q1[1].abs().max())
    hu_bound = 0.5 * ETA0 * np.sqrt(GRAVITY * H0) * H0 + 1e-4
    mass = abs(m1 - m0) / m0
    log(f"  first order: mass change {mass:.3e} of the initial, {moved} "
        f"cells change wetness by half a period, max |hu| {hu_max:.3e} "
        f"(bound {hu_bound:.3e})")
    if not (np.isfinite(h1).all() and h1.min() >= 0.0 and mass <= 1e-11
            and moved > 50 and l1 < 0.08 and hu_max < hu_bound):
        raise SystemExit("Thacker bowl at first order failed")
    del q1

    dt = THACKER_DT / 2
    _, _, l1_first, _ = run(False, dt)
    q, launches, l1_muscl, op = run(True, dt)
    if not (bool(torch.isfinite(q).all()) and l1_muscl <= 1.05 * l1_first):
        raise SystemExit(f"Thacker bowl with MUSCL at dt {dt} failed: "
                         f"L1/mean {l1_muscl} against first order's "
                         f"{l1_first}")
    return mms_rows(card, "unstructured thacker+muscl", op, q,
                    op.zero_boundary_values(), None, q.new_full((), dt),
                    launches, second, errs, emit_prim=True)


def phase_mms(errs, dev):
    """Phase 10: the MMS driver on the card in f64. (a) and (b): the
    first-order study on quads to 2,883,584 cells, its rates against the
    reference's thresholds, 10 steps of its finest level against the plain
    versions, its step split into kernels and forcing, and its kernels at
    the finest level's shapes; (c) the second-order study (MUSCL minmod,
    positivity limiter, ssprk2) on triangles to 1,441,792 cells; (d) two
    sediment classes to 720,896 quads; (e) Thacker's bowl."""
    import tempfile

    from rdycore_tpu_torch.mesh import save_mesh_npz
    from tools.torch_mms_decks import base_mesh

    card = nvidia_smi_line()
    rows, splits = [], {}
    first = {"swe_edge_flux": 1, "swe_cell_stage": 1, "courant_argmax": 1}
    second = {k: 2 for k in ("swe_muscl_grad", "swe_edge_flux",
                             "swe_positivity_drain", "swe_positivity_scale",
                             "swe_cell_stage")}
    second["courant_argmax"] = 1
    studies = (
        # (phase, path, base (nx, ny, triangles), refinements, dt, deck,
        #  launches a step, whether the rates must pass)
        ("10b", "unstructured mms", (*MMS_QUADS, False), MMS_REFINE[0],
         MMS_DT, {}, first, True),
        ("10c", "unstructured mms+muscl", (*MMS_TRIS, True), MMS_REFINE[1],
         MMS_TRI_DT, dict(second_order=True, temporal="ssprk2"), second,
         True),
        ("10d", "unstructured mms+sediment", (*MMS_QUADS, False),
         MMS_REFINE[2], MMS_SED_DT, dict(num_sediment=2), first, False),
    )
    with tempfile.TemporaryDirectory() as tmp:
        for tag, path, (nx, ny, tri), refs, dt, deck, per_step, must in \
                studies:
            mesh_file = f"{tmp}/{path.replace(' ', '_')}.npz"
            save_mesh_npz(base_mesh(nx, ny, tri), mesh_file)
            cfg = mms_deck_config(dt, MMS_STOP, refs, mesh_file, **deck)
            cells = (2 if tri else 1) * nx * ny * 4 ** refs
            log(f"== phase {tag}: the MMS driver, {path}, f64, "
                f"{nx}x{ny} {'triangle pairs' if tri else 'quads'} refined "
                f"{refs} times (to {cells:,} cells), dt {dt} s, t "
                f"{MMS_STOP} s, {cfg.numerics.temporal}")
            drv, ok, launches = mms_study(card, path, cfg, dev, per_step)
            if must and not ok:
                raise SystemExit(f"{path}: the rates miss the thresholds")
            level = drv.last_level
            q = level.q0
            if tag == "10b":
                q = check_plain_steps(path, level)
            splits[path] = mms_step_split(card, path, level)
            t = q.new_full((), 0.5 * level.t_final)
            rows += mms_rows(card, path, level.op, q, level.bc_fn(t),
                             level.src_fn(t), q.new_full((), level.dt),
                             launches, per_step, errs)
            del drv, level, q
    rows += phase_thacker(card, errs, dev)
    log(f"  [{card}] MMS step splits (ms): {json.dumps(splits)}")
    return rows


# ----------------------------------------------------------------- phase 11
def coupler_dict(steps, backend, work):
    """The coupler's dam break (phases 3-4's mesh, reservoir, Manning and
    dt): every wall reflecting and the floodplain dry, so that the C host's
    1 um/s of rain lands on cells whose float32 depth holds it; coupling
    intervals of COUPLER_INTERVAL steps; output (checkpoints) in `work`."""
    d = dam_break_dict(steps, backend)
    d["time"]["coupling_interval"] = COUPLER_INTERVAL * DT
    d["output"] = {"format": "none", "directory": work}
    d["grid"] = {"file": "coupler.npz"}
    d["boundaries"], d["boundary_conditions"] = [], []
    d["flow_conditions"] = [fc for fc in d["flow_conditions"]
                            if fc["name"] != "outflow"]
    d["flow_conditions"][1]["height"] = 0.0
    return d


def coupler_config(steps, backend, work, **extra):
    from rdycore_tpu_torch.config.yaml_input import config_from_dict

    d = coupler_dict(steps, backend, work)
    d.update(extra)
    return config_from_dict(d).validate()


def c_host_run(host, deck, work, tag):
    """The unchanged csrc/test_capi.c (or, where no host was built, the
    same sequence through capi_bridge in this process) on `deck`: its three
    OK lines, and the bridge's report (host seconds of each call, launches,
    steps)."""
    import os

    ckpt = os.path.join(work, f"c_host_{tag}.bin")
    onedof = os.path.join(work, f"c_host_{tag}_onedof.bin")
    timings = os.path.join(work, f"c_host_{tag}.jsonl")
    t0 = time.perf_counter()
    if host is not None:
        env = dict(os.environ, RDYTPU_TIMINGS=timings)
        env.pop("RDYTPU_PLATFORM", None)
        r = subprocess.run([host, deck, ckpt, onedof], capture_output=True,
                           text=True, env=env, timeout=600)
        out, code = r.stdout, r.returncode
        if code != 0:
            log(r.stderr[-4000:])
    else:
        out, code = bridge_sequence(deck, ckpt, onedof, timings)
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        log(f"  c_host {tag}: {line}")
    ok = [line for line in out.splitlines() if line.startswith("OK:")]
    if code != 0 or len(ok) != 3:
        raise SystemExit(f"c_host on the {tag} deck: exit {code}, "
                         f"{len(ok)} OK lines")
    with open(timings) as f:
        report = json.loads(f.read().splitlines()[-1])
    return report, wall, os.path.getsize(ckpt)


def bridge_sequence(deck, ckpt, onedof, timings):
    """csrc/test_capi.c's sequence through capi_bridge in this process (for
    a machine that cannot embed CPython): (stdout, exit code)."""
    import os

    from rdycore_tpu_torch import capi_bridge as b

    os.environ["RDYTPU_TIMINGS"] = timings
    lines = []
    try:
        h = b.create(deck)
        n = b.num_cells(h)
        area = np.frombuffer(b.get_cell_areas(h))
        vol0 = float(np.sum(np.frombuffer(b.get_height(h)) * area))
        rain, t_prev, intervals = np.full(n, 1e-6).tobytes(), -1.0, 0
        while not b.finished(h):
            b.set_domain_water_source(h, rain)
            b.advance(h)
            t = b.time(h)
            hh = np.frombuffer(b.get_height(h))
            hu = np.frombuffer(b.get_x_momentum(h))
            if not (t > t_prev and np.isfinite(hh).all() and hh.min() >= 0
                    and np.isfinite(hu).all()):
                return "\n".join(lines), 1
            t_prev, intervals = t, intervals + 1
        vol1 = float(np.sum(hh * area))
        lines.append(f"OK: {intervals} intervals, {b.step(h)} steps, "
                     f"t={t_prev:g}, volume {vol0:g} -> {vol1:g}")
        if not vol1 > vol0:
            return "\n".join(lines), 1
        b.write_checkpoint(h, ckpt)
        b.read_checkpoint(h, ckpt)
        if np.frombuffer(b.get_height(h)).tobytes() != hh.tobytes():
            return "\n".join(lines), 1
        lines.append("OK: checkpoint round-trip bitwise")
        b.write_one_dof_vec(h, onedof, hh.tobytes())
        q = b.get_solution(h)
        b.set_initial_conditions(h, q)
        if (b.read_one_dof_vec(h, onedof) != hh.tobytes()
                or b.get_height(h) != np.frombuffer(q)[::3].tobytes()):
            return "\n".join(lines), 1
        lines.append("OK: one-DOF vec round-trip + set_initial_conditions")
        b.destroy(h)
    finally:
        del os.environ["RDYTPU_TIMINGS"]
    return "\n".join(lines), 0


def coupler_rows(card, path, sim, launches, errs, dt=DT, src=None,
                 per_step=1):
    """The kernels of a path at its shapes (the coupler's, phase 11, and
    phases 12's and 13's), on the final state of a run of its deck, held
    against their plain versions and timed: K1a, K1b in an euler stage of
    `dt` with the primitives and K1c (unstructured), or K2 in that stage
    (with the rain plane `src` [ny, nx] where given) and K1c on its tile
    maxima (raster); the rows of `path`, each kernel launched `per_step`
    times a step."""
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.kernels.raster_step import swe_raster_step_plain

    q = sim.q.to(torch.float32)
    s, dev = q.element_size(), q.device
    dt = torch.tensor(dt, dtype=q.dtype, device=dev)
    stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
    run = (torch.zeros((), dtype=q.dtype, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    replaces = REPLACES
    if sim._structured is None:
        op, bv = sim.operator, sim.boundary_values
        a = op.arrays
        kw = dict(tiny_h=op.tiny_h, h_anuga=op.h_anuga,
                  xq2018_threshold=op.xq2018_threshold,
                  source_method=op.source_method)
        flux, courant = op.edge_flux(q, bv)
        fp, cp = swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga)
        ok_ = op.cell_stage(flux, q, dt, None, **stage)
        op_ = swe_cell_stage_plain(a, flux, q, dt, None, **kw, **stage)
        values = courant
        pairs = {"swe_edge_flux": [(flux, fp), (courant, cp)],
                 "swe_cell_stage": [(ok_.q_out, op_.q_out),
                                    (ok_.prim, op_.prim)]}
        calls = {
            "swe_edge_flux": (
                lambda: op.edge_flux(q, bv),
                lambda: swe_edge_flux_plain(a, q, bv, op.tiny_h, op.h_anuga),
                None),
            "swe_cell_stage": (
                lambda: op.cell_stage(flux, q, dt, None, **stage),
                lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw,
                                             **stage), None)}
        nbytes = kernel_bytes(op, q.numel() * s, s)
        nops = {"swe_edge_flux": OPS_PER_EDGE * op.num_edges,
                "swe_cell_stage": OPS_PER_CELL * op.num_cells}
    else:
        op = sim._structured["op"]
        geo = (op.dz_dx, op.dz_dy, op.mannings_n)
        stage["src"] = src
        got = op.step(q, dt, **stage)
        want = swe_raster_step_plain(op.plan, q, *geo, dt, **stage)
        values = got.cmax
        pairs = {"swe_raster_step": list(zip(got, want))}
        calls = {"swe_raster_step": (
            lambda: op.step(q, dt, **stage),
            lambda: swe_raster_step_plain(op.plan, q, *geo, dt, **stage),
            None)}
        C = q.shape[1]
        nbytes = {"swe_raster_step": raster_step_bytes(C, 3, values.numel(),
                                                       s)
                  + (0 if src is None else C * s)}
        nops = {"swe_raster_step": OPS_PER_RASTER_CELL * C}
        replaces = dict(REPLACES, courant_argmax=REPLACES["swe_raster_step"])
    mk, ik = op.courant_max(values, dt, *run)
    mp, ip = courant_argmax_plain(values)
    rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
    err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
    err["courant_argmax"] = abs(float(mk) - float(mp))
    exact = float(mk) == float(mp) and int(ik) == int(ip)
    log(f"  full-size kernels vs plain on the {path} path (relative): {rel};"
        f" Courant fold {'exact' if exact else 'DIFFERS'}")
    if not (exact and all(v <= TOL[q.dtype] for v in rel.values())):
        raise SystemExit(f"full-size {path} kernel check failed")
    run = (torch.zeros((), dtype=q.dtype, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    calls["courant_argmax"] = (lambda: op.courant_max(values, dt, *run),
                               lambda: courant_argmax_plain(values, dt, *run),
                               lambda: torch.max(values, 0))
    nbytes["courant_argmax"] = courant_bytes(values.numel(), s)
    nops["courant_argmax"] = OPS_PER_VALUE * values.numel()
    return [kernel_row(card, name, path, fns, launches[name],
                       max(err[name], errs.get(name, 0.0)), nbytes[name],
                       nops[name], q.dtype, replaces,
                       launches_per_step=per_step)
            for name, fns in calls.items()]


def restart_equivalence(tag, backend, dev, mesh, work, per_step,
                        strips=None):
    """Run A: 2N steps with checkpoint.interval N (`CheckpointMonitor`
    writes step N mid-run); run B: restart.file from that checkpoint to
    step 2N. B must end bit for bit where A does (q, t, step), and A launch
    each kernel per_step times a step (per strip). Returns run A, its
    launches and the seconds of A's setup and run, and B's."""
    import os

    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.io.writers import attach_output_monitors
    from rdycore_tpu_torch.ops import kernels

    def make(**extra):
        cfg = coupler_config(2 * RESTART_N, backend, work, **extra)
        if strips:
            cfg.parallel.n_devices = strips
        return Simulation(cfg, mesh=mesh, device=dev,
                          strip_devices=[dev] * strips if strips else None)

    prefix = f"restart_{tag.replace(' ', '_')}"
    t0 = time.perf_counter()
    a = make(checkpoint={"format": "binary", "interval": RESTART_N,
                         "prefix": prefix})
    attach_output_monitors(a)
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    a.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    check_launches(f"coupler {tag} run A ({2 * RESTART_N} steps)", launches,
                   {k: n * (strips or 1) * 2 * RESTART_N
                    for k, n in per_step.items()})
    ckpt = os.path.join(work, f"{prefix}.rdycore.r.{RESTART_N:04d}.bin")
    t3 = time.perf_counter()
    b = make(restart={"file": ckpt})
    t4 = time.perf_counter()
    if not (b.restarted and b.step == RESTART_N):
        raise SystemExit(f"{tag}: the restart is at step {b.step}")
    b.run()
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    same = (a.step == b.step == 2 * RESTART_N and a.t == b.t
            and torch.equal(a.q, b.q))
    log(f"  coupler {tag}: run A {2 * RESTART_N} steps with a mid-run "
        f"checkpoint at step {RESTART_N} (setup {t1 - t0:.2f} s, run "
        f"{t2 - t1:.3f} s); run B from {os.path.basename(ckpt)} (setup and "
        f"restore {t4 - t3:.2f} s, run {t5 - t4:.3f} s); B against A (q, t "
        f"{b.t!r}, step {b.step}): {'bit for bit' if same else 'DIFFERENT'}")
    if not same:
        raise SystemExit(f"coupler {tag}: the restart differs from run A")
    del b
    return a, launches


def phase_coupler(errs, dev, mesh):
    """Phase 11: the coupler's path at full size. (a) The JAX package's
    unchanged C host csrc/test_capi.c linked against the port's embedded C
    API (rdycore_tpu_torch/capi/) on the raster and the unstructured deck:
    its OK lines, exact launches, the host ms of each part of a coupling
    interval and the seconds to write and read the binary checkpoint. (b)
    Restart from a mid-run checkpoint bit for bit on the raster, the raster
    in 4 strips on the one card and the unstructured mesh. (c) The regional
    Manning and momentum setters on the unstructured deck: 10 steps on the
    kernels against the plain versions; `set_regional_manning_n` timed on
    the raster, whose Manning plane it rebuilds."""
    import os
    import shutil

    from rdycore_tpu_torch.capi import build

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output",
                        "chip_smoke_coupler")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    log(f"== phase 11: the coupler's path, dam break on {mesh.num_cells:,} "
        f"cells (every wall reflecting, dry floodplain), f32, euler, dt {DT} "
        f"s, coupling intervals of {COUPLER_INTERVAL} steps")
    dam_break_npz(mesh, os.path.join(work, "coupler.npz"))
    decks = {}
    for tag, backend in (("raster", "fused_structured"),
                         ("unstructured", "xla")):
        decks[tag] = os.path.join(work, f"coupler_{tag}.yaml")
        with open(decks[tag], "w") as f:  # JSON is YAML
            json.dump(coupler_dict(COUPLER_STEPS, backend, work), f)

    log("== phase 11a: the unchanged C host csrc/test_capi.c against the "
        "port's embedded C API")
    host = None
    try:
        cflags, ldflags = build.embed_flags()
        log(f"  {build.python_config()} --embed: {' '.join(cflags)} | "
            f"{' '.join(ldflags)}; sys.prefix {sys.prefix} (base "
            f"{sys.base_prefix})")
        t0 = time.perf_counter()
        host = build.build_host(os.path.join("csrc", "test_capi.c"))
        log(f"  built the shim and the host in {time.perf_counter() - t0:.2f}"
            f" s: {host}")
    except build.EmbedUnavailable as e:
        log(f"c_host: not built ({e}); the same sequence runs through "
            "capi_bridge in this process")
    torch.cuda.empty_cache()  # room for the host's own process
    per_step = {"raster": {"swe_raster_step": 1, "courant_argmax": 1},
                "unstructured": {"swe_edge_flux": 1, "swe_cell_stage": 1,
                                 "courant_argmax": 1}}
    c_host = {}
    for tag in ("raster", "unstructured"):
        report, wall, size = c_host_run(host, decks[tag], work, tag)
        tm = report["timers"]
        n = len(tm["advance"])
        mean_ms = {k: 1e3 * sum(v) / len(v) for k, v in tm.items()}
        split = {
            "set_source_ms": mean_ms["set_domain_water_source"],
            "advance_ms": mean_ms["advance"],
            "advance_ms_after_the_first": 1e3 * sum(tm["advance"][1:])
            / max(n - 1, 1),
            "get_fields_ms": mean_ms["get_height"]
            + mean_ms["get_x_momentum"],
        }
        c_host[tag] = dict(split, intervals=n, wall_s=wall,
                           checkpoint_bytes=size,
                           write_checkpoint_s=tm["write_checkpoint"][0],
                           read_checkpoint_s=tm["read_checkpoint"][0],
                           python=report["python"])
        log(f"  [{card}] c_host {tag}: {n} coupling intervals of "
            f"{COUPLER_INTERVAL} steps, wall ms per interval: set source "
            f"{split['set_source_ms']:.3f}, advance {split['advance_ms']:.3f}"
            f" ({split['advance_ms_after_the_first']:.3f} after the first), "
            f"get fields (h, hu) {split['get_fields_ms']:.3f}; checkpoint of "
            f"{size:,} bytes written in {tm['write_checkpoint'][0]:.3f} s, "
            f"read in {tm['read_checkpoint'][0]:.3f} s; the host process "
            f"{wall:.2f} s; embedded Python {report['python']}")
        check_launches(f"c_host {tag} ({report['steps']} steps)",
                       report["launches"],
                       {k: v * report["steps"]
                        for k, v in per_step[tag].items()})
        c_host[tag]["launches"] = report["launches"]
    log(f"  [{card}] c_host: {json.dumps(c_host)}")

    log(f"== phase 11b: restart from a mid-run checkpoint, bit for bit "
        f"({2 * RESTART_N} steps, checkpoint at {RESTART_N})")
    rows = []
    for tag, backend, strips in (("raster", "fused_structured", None),
                                 (f"raster+strips{STRIPS}",
                                  "fused_structured", STRIPS),
                                 ("unstructured", "xla", None)):
        key = tag.split("+")[0]
        sim, _ = restart_equivalence(tag, backend, dev, mesh, work,
                                     per_step[key], strips)
        if strips is None:  # the rows of the C host's paths, its launches
            rows += coupler_rows(card, f"coupler {tag}", sim,
                                 c_host[tag]["launches"], errs)
        del sim

    log("== phase 11c: regional Manning and momentum sources on the "
        "unstructured deck, 10 steps against the plain versions")
    from rdycore_tpu_torch import Simulation

    def setters(sim):
        """Manning values on the floodplain; momentum sources on the wet
        reservoir only: on a dry cell (h = 0) a source makes momentum
        without depth, whose float32 rounding the next steps amplify
        (1e-3 of the row between f32 and f64 on the CPU, kernels or not),
        and a y source of 2 m^2/s^2 keeps the hv row well above the
        rounding of the dam break's fluxes."""
        n = sim.num_cells
        rng = np.random.default_rng(11)
        sim.set_regional_manning_n("floodplain",
                                   rng.uniform(0.01, 0.05, n // 2))
        sim.set_regional_momentum_source("reservoir", 0, 0.02)
        hv_src = np.linspace(-2.0, 2.0, n)
        hv_src[sim.region_cells["floodplain"]] = 0.0
        sim.set_momentum_source(2, hv_src)

    runs = []
    for plain in (False, True):
        sim = Simulation(coupler_config(10, "xla", work), mesh=mesh,
                         device=dev)
        if plain:
            sim.operator = plain_operator(sim.operator)
        setters(sim)
        sim.run()
        runs.append(sim)
    torch.cuda.synchronize()
    worst = rows_rel_err(runs[0].q, runs[1].q)
    moved = float((runs[0].q[2] != 0).float().mean())  # the reservoir
    log(f"  10 steps with the setters, kernels vs plain versions (worst row, "
        f"relative): {worst:.3e} (tolerance {TOL[torch.float32]}); share of "
        f"cells with hv != 0: {moved:.3f}")
    if not (worst <= TOL[torch.float32] and runs[0].step == 10
            and moved >= 0.5):
        raise SystemExit("coupler setters: the kernels differ from plain")
    del runs
    for tag, backend in (("raster", "fused_structured"),
                         ("unstructured", "xla")):
        sim = Simulation(coupler_config(10, backend, work), mesh=mesh,
                         device=dev)
        times = []
        for k in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.set_regional_manning_n("floodplain", 0.02 + 0.01 * k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        sim.run()
        if not np.isfinite(sim.get_solution()).all():
            raise SystemExit(f"coupler {tag}: not finite after the setter")
        log(f"  [{card}] set_regional_manning_n on the {tag} deck: "
            + ", ".join(f"{1e3 * t:.2f}" for t in times) + " ms (3 calls)")
        del sim
    shutil.rmtree(work, ignore_errors=True)
    log(f"  [{card}] phase 11: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ------------------------------------------------------------------ phase 12
# the valley of tools/torch_flood_files.py: 1448 x 996 squares of legs about
# 14.1 m, each split in two triangles (2,884,416 cells); dt for a Courant
# number near 0.3 (printed, at most 0.5 required); 12b's steps and
# coupling interval; 12c's end (past the rain rasters' switch at hour 1)
# and coupling interval; 12d's rain on the dam break: 1e-6 m a step, some
# 67 half-ulps of float32 at the reservoir's 0.25 m
FLOOD_NX, FLOOD_NY = 1448, 996
FLOOD_DT = 0.25
FLOOD_STEPS, FLOOD_INTERVAL_STEPS = 200, 50
FLOOD_STOP, FLOOD_COUPLING = 3720.0, 120.0
RAIN_RATE, RAIN_STEPS = 2e-3, 40
ORDERS = ("exodus file order", "exodus rcm")


def same_mesh(a, b) -> bool:
    """Whether two meshes are equal array for array (labels as dicts)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            if x.keys() != y.keys() or not all(
                    np.array_equal(x[k], y[k]) for k in x):
                return False
        elif isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


class plain_mesh_builder:
    """Within it, `build_mesh` takes the numpy plain versions of the native
    builder's geometry and edges (mesh/core.py)."""

    def __enter__(self):
        from rdycore_tpu_torch.mesh import core, native

        def geometry(points, cv, nv):
            area, cen = core._polygon_areas_centroids(points, cv, nv)
            dzdx, dzdy = core._cell_slopes(points, cv, nv, cen)
            return area, cen, dzdx, dzdy, core._vertex_mean_z(points, cv, nv)

        self.saved = native, native.cell_geometry, native.extract_edges
        native.cell_geometry, native.extract_edges = (geometry,
                                                      core._extract_edges)

    def __exit__(self, *exc):
        native, native.cell_geometry, native.extract_edges = self.saved


def bandwidth(mesh) -> str:
    """max and mean |left - right| over the interior edges."""
    ec = mesh.edge_cells[: mesh.num_internal_edges].astype(np.int64)
    d = np.abs(ec[:, 0] - ec[:, 1])
    return f"max {int(d.max()):,}, mean {d.mean():.1f}"


def timed(what, fn):
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    log(f"  {what}: {dt:.2f} s")
    return out, dt


def phase_files_read(work):
    """12a: the valley written as Exodus and Gmsh files, read by the port,
    the native builder against its numpy plain versions, RCM."""
    import os

    from rdycore_tpu_torch.mesh import build as native_build
    from rdycore_tpu_torch.mesh import build_mesh, native, read_gmsh
    from rdycore_tpu_torch.mesh.core import rcm_reorder
    from rdycore_tpu_torch.mesh.exodus import read_exodus
    from tools.torch_flood_files import (
        generated_with_labels, valley_mesh, write_flood_files)

    card = nvidia_smi_line()
    log(f"== phase 12a: the valley ({FLOOD_NX}x{FLOOD_NY} squares of two "
        "triangles over 20.48 km x 14.08 km) as Exodus (CDF-2) and Gmsh 4.1 "
        "files, cells and vertices shuffled (a worst case, not a mesher's "
        f"order); card {card}")
    native._lib = None
    lib, _ = timed(f"native mesh library ({native_build.compiler()}; built "
                   "in phase 1, found by the hash of its source, compiler, "
                   "machine and flags)", native_build.library)
    log(f"  {lib}")
    gen, t_gen = timed("generated mesh (structured_tri, native builder)",
                       lambda: valley_mesh(FLOOD_NX, FLOOD_NY))
    out, _ = timed("written: Exodus, Gmsh, rain rasters, stage series",
                   lambda: write_flood_files(work, mesh=gen))
    paths = out["paths"]
    for k in ("exodus", "gmsh"):
        log(f"  {paths[k]}: {os.path.getsize(paths[k]) / 1e6:.1f} MB")
    exo, t_exo = timed("read_exodus (NetCDF reader + build_mesh)",
                       lambda: read_exodus(paths["exodus"]))
    msh, t_msh = timed("read_gmsh (one numpy parse per section + "
                       "build_mesh)", lambda: read_gmsh(paths["gmsh"]))
    if not same_mesh(exo, msh):
        raise SystemExit("the Exodus and Gmsh meshes differ")
    log(f"  Exodus and Gmsh meshes equal array for array: {exo.num_cells:,} "
        f"cells, {exo.num_edges:,} edges, regions "
        f"{sorted(k for k in exo.regions if not k.startswith('__'))}, "
        f"boundaries {sorted(k for k in exo.boundaries if not k.startswith('__'))}")
    labels = dict(regions=exo.regions, boundary_edges={
        k: exo.edge_vertices[v] for k, v in exo.boundaries.items()})
    built, t_native = timed("build_mesh, native (the file mesh's points, "
                            "cells and labels)", lambda: build_mesh(
                                exo.points, exo.cell_vertices, **labels))
    with plain_mesh_builder():
        plain, t_plain = timed("build_mesh, numpy plain versions", lambda:
                               build_mesh(exo.points, exo.cell_vertices,
                                          **labels))
    if not (same_mesh(built, plain) and same_mesh(built, exo)):
        raise SystemExit("native and plain mesh builds differ")
    log("  native and plain builds equal array for array")
    perm, t_order = timed("rdy_rcm_order", lambda: native.rcm_order(
        exo.num_cells, exo.edge_cells[:, 0], exo.edge_cells[:, 1]))
    rcm, t_rcm = timed("rcm_reorder (order + build_mesh)",
                       lambda: rcm_reorder(exo))
    labelled = generated_with_labels(out)
    log(f"  [{card}] setup s: generate {t_gen:.2f}, read Exodus {t_exo:.2f}, "
        f"read Gmsh {t_msh:.2f}, build native {t_native:.2f} vs numpy "
        f"{t_plain:.2f}, RCM {t_order:.2f} + rebuild {t_rcm - t_order:.2f}")
    log(f"  bandwidth |left - right| over interior edges: file order "
        f"{bandwidth(exo)}; rcm {bandwidth(rcm)}; generated "
        f"{bandwidth(labelled)}")
    return out, exo, labelled


def flood_config(steps, ordering, work):
    from rdycore_tpu_torch.config.yaml_input import config_from_dict
    from tools.torch_flood_files import flood_deck

    import os

    return config_from_dict(flood_deck(
        os.path.join(work, "valley.exo"), FLOOD_DT, steps * FLOOD_DT,
        FLOOD_INTERVAL_STEPS * FLOOD_DT, ordering,
        series=FLOOD_INTERVAL_STEPS)).validate()


def phase_files_order(errs, dev, work, exo):
    """12b: 200 euler steps of the valley deck in file order and under
    RCM through `run_main_path`, the end states by natural id, and the
    kernels at each order's shapes (the generator's order, timed beside
    them before, is cut from the script's time)."""
    from rdycore_tpu_torch import Simulation

    card = nvidia_smi_line()
    log(f"== phase 12b: what cell order costs: {FLOOD_STEPS} euler steps of "
        f"the valley (channel 1 m deep, floodplain dry, outlet depth "
        f"{0.8} m), dt {FLOOD_DT} s, f32, {exo.num_cells:,} cells")
    per_step = {"swe_edge_flux": 1, "swe_cell_stage": 1, "courant_argmax": 1}
    decks = {ORDERS[0]: ("file", exo), ORDERS[1]: ("rcm", exo)}
    ends, rows = {}, []
    for path in ORDERS:
        ordering, mesh = decks[path]

        def make_sim(n, plain=False):
            sim = Simulation(flood_config(n, ordering, work), mesh=mesh,
                             device=dev)
            if plain:
                sim.operator = plain_operator(sim.operator)
            return sim

        log(f"== phase 12b: {path}")
        sim, launches = run_main_path(
            path, make_sim, FLOOD_STEPS, per_step,
            lambda sim, q0: check_state_and_budget(sim, q0,
                                                   sim.mesh.cell_area))
        # by natural id (file order)
        ends[path] = sim.get_solution()[:, np.argsort(
            sim.get_natural_ids())]
        path_rows = coupler_rows(card, path, sim, launches, errs,
                                 dt=FLOOD_DT)
        rows += path_rows
        ms, rate = STEADY[path]
        log(f"  [{card}] {path}: {ms:.4f} ms/step, {rate:.4e} "
            "cell-updates/s; per launch "
            + ", ".join(f"{r['name']} {r['ms']:.4f} ms (bound "
                        f"{r['bound_ms']:.4f}, {100 * r['bound_ms'] / r['ms']:.1f}%)"
                        for r in path_rows))
        del sim
    for path in ORDERS[1:]:
        err = rows_rel_err(ends[path], ends[ORDERS[0]])
        bits = np.array_equal(ends[path], ends[ORDERS[0]])
        log(f"  end state of {path} against file order, by natural id: "
            f"worst row {err:.3e} relative, "
            f"{'bit for bit' if bits else 'not bit for bit'}")
        if not err <= 1e-5:
            raise SystemExit(f"{path} differs from file order: {err}")
    return rows


def phase_files_flood(dev, work, out):
    """12c: the flood run through the CLI's main (what python -m
    rdycore_tpu_torch runs): RCM, raster rain, the outlet's depth series,
    to t = 3720 s; h, the volume budget, the rain's hourly switch, wall s
    split into steps and forcing."""
    import os

    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.__main__ import main as cli_main
    from rdycore_tpu_torch.forcing import Forcing
    from rdycore_tpu_torch.ops import kernels
    from tools.torch_flood_files import flood_deck

    card = nvidia_smi_line()
    paths = out["paths"]
    deck = os.path.join(work, "flood.yaml")
    with open(deck, "w") as f:  # JSON is YAML
        json.dump(flood_deck("valley.exo", FLOOD_DT, FLOOD_STOP,
                             FLOOD_COUPLING, "rcm",
                             series=int(FLOOD_COUPLING / FLOOD_DT)), f)
    argv = [deck, "--raster-rain-dir", paths["rain"],
            "--homogeneous-bc-file", f"outlet={paths['stage']}"] + (
                ["--cpu"] if dev.type == "cpu" else [])
    log(f"== phase 12c: the flood run through the CLI: python -m "
        f"rdycore_tpu_torch {' '.join(os.path.relpath(a) for a in argv)} "
        f"(euler, f32, RCM, dt {FLOOD_DT} s, coupling {FLOOD_COUPLING} s, "
        f"to t = {FLOOD_STOP} s)")
    rec = {"sim": None, "intervals": [], "apply_s": 0.0, "rate": 0.0}
    advance, apply = Simulation.advance, Forcing.apply

    def volume(sim):
        return float((sim.q[0].double() * rec["area"]).sum())

    def timed_apply(self, sim, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply(self, sim, t)
        torch.cuda.synchronize()
        rec["apply_s"] += time.perf_counter() - t0
        if rec["sim"] is None:
            rec["sim"] = sim
            rec["area"] = torch.as_tensor(sim.mesh.cell_area,
                                          device=sim.q.device)
            rec["v0"] = volume(sim)
            rec["t_setup"] = time.perf_counter() - rec["t_start"]
        rec["rate"] = float((sim.ext_src[0].double() * rec["area"]).sum())

    def timed_advance(self):
        t_start = self.t
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance(self)
        torch.cuda.synchronize()
        rec["intervals"].append(dict(
            t0=t_start, t1=self.t, steps_s=time.perf_counter() - t0,
            rate=rec["rate"], courant=self.prev_max_courant))

    Simulation.advance, Forcing.apply = timed_advance, timed_apply
    kernels.reset_launch_counts()
    rec["t_start"] = time.perf_counter()
    try:
        rc = cli_main(argv)
    finally:
        Simulation.advance, Forcing.apply = advance, apply
    torch.cuda.synchronize()
    wall = time.perf_counter() - rec["t_start"]
    sim = rec["sim"]
    if rc != 0 or sim is None:
        raise SystemExit(f"the CLI returned {rc}")
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    check_launches("flood run", launches, {
        "swe_edge_flux": sim.step, "swe_cell_stage": sim.step,
        "courant_argmax": sim.step})
    h = sim.get_height()
    if not (np.isfinite(sim.get_solution()).all() and h.min() >= 0.0):
        raise SystemExit(f"flood run: finite "
                         f"{np.isfinite(sim.get_solution()).all()}, min h "
                         f"{h.min()}")
    iv = rec["intervals"]
    rain = sum(i["rate"] * (i["t1"] - i["t0"]) for i in iv)
    lens = sim.operator.arrays.bnd_len.cpu().numpy().astype(np.float64)
    outflow = float(np.sum(sim.bflux_accum[0] * lens))
    gained = volume(sim) - rec["v0"]
    budget = abs(gained - (rain - outflow)) / rain
    before = [i["rate"] for i in iv if i["t1"] <= 3600.0]
    after = [i["rate"] for i in iv if i["t0"] >= 3600.0]
    courant = max(i["courant"] for i in iv)
    steps_s = sum(i["steps_s"] for i in iv)
    log(f"  {sim.step} steps to t = {sim.t} s in {len(iv)} intervals; max "
        f"Courant {courant:.4f}; h finite, min {h.min():.3e}, max "
        f"{h.max():.4f} m")
    log(f"  rain in {rain:.6e} m^3 (rate {before[0]:.4f} m^3/s to 3600 s, "
        f"{after[0]:.4f} after: x{after[0] / before[0]:.4f}), outflow "
        f"{outflow:.6e} m^3, volume change {gained:.6e} m^3; budget error "
        f"{budget:.3e} of the rain")
    log(f"  [{card}] CLI wall {wall:.2f} s = setup (read Exodus, RCM, "
        f"Simulation) {rec['t_setup']:.2f} + steps {steps_s:.2f} "
        f"({1e3 * steps_s / sim.step:.4f} ms/step, "
        f"{sim.step * sim.num_cells / steps_s:.4e} cell-updates/s) + forcing "
        f"{rec['apply_s']:.2f} ({1e3 * rec['apply_s'] / (len(iv) + 1):.1f} "
        f"ms per interval: the raster and stage setters) + the rest")
    if not courant <= 0.5:
        raise SystemExit(f"Courant number {courant} > 0.5")
    if not budget <= 1e-3:
        raise SystemExit(f"flood volume budget error {budget} > 1e-3")
    if not (len(set(before)) == 1 and len(set(after)) == 1
            and abs(after[0] / before[0] - 0.4) < 0.01):
        raise SystemExit(f"rain did not switch at 3600 s: {before} {after}")
    if not outflow > 0.0:
        raise SystemExit("no outflow through the outlet")


def phase_files_rain(errs, dev, work, mesh):
    """12d: the dam break as an .npz on fused_structured with
    --constant-rain-rate, 40 steps through the CLI's main against the same
    run on the plain versions; the rain plane's K2 at full size."""
    import os

    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.__main__ import main as cli_main
    from rdycore_tpu_torch.config.yaml_input import load_config
    from rdycore_tpu_torch.forcing import ConstantRain, Forcing, attach_forcing
    from rdycore_tpu_torch.ops import kernels

    card = nvidia_smi_line()
    log(f"== phase 12d: rain on the raster: the dam break ({mesh.num_cells:,} "
        f"cells, every wall reflecting) as .npz on fused_structured, "
        f"--constant-rain-rate {RAIN_RATE} m/s ({RAIN_RATE * DT:.1e} m a "
        f"step), {RAIN_STEPS} steps")
    dam_break_npz(mesh, os.path.join(work, "dam_break.npz"))
    d = dam_break_dict(RAIN_STEPS, "fused_structured")
    d["grid"] = {"file": "dam_break.npz"}
    # every wall reflecting: the volume gained is the rain's
    d["boundaries"], d["boundary_conditions"] = [], []
    d["flow_conditions"] = d["flow_conditions"][:2]
    d["time"]["coupling_interval"] = 20 * DT
    deck = os.path.join(work, "rain.yaml")
    with open(deck, "w") as f:
        json.dump(d, f)
    sims = []
    advance = Simulation.advance

    def keep(self):
        if not sims:
            sims.append(self)
            self.v0 = float(np.sum(self.get_height().astype(np.float64)
                                   * self.mesh.cell_area))
        advance(self)

    Simulation.advance = keep
    kernels.reset_launch_counts()
    try:
        rc = cli_main([deck, "--constant-rain-rate", str(RAIN_RATE)]
                      + (["--cpu"] if dev.type == "cpu" else []))
    finally:
        Simulation.advance = advance
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    if rc != 0 or not sims:
        raise SystemExit(f"the CLI returned {rc}")
    sim = sims[0]
    check_launches("raster rain run", launches, {
        "swe_raster_step": RAIN_STEPS, "courant_argmax": RAIN_STEPS,
        "swe_edge_flux": RAIN_STEPS})
    st = sim._structured
    if not (st["kind"] == "fused" and st["with_src"]):
        raise SystemExit("the rain did not reach K2's rain plane")
    plain = raster_simulation(RAIN_STEPS, dev, mesh, plain=True,
                              config=lambda *_: load_config(deck))
    attach_forcing(plain, Forcing(constant_rain=ConstantRain(RAIN_RATE)))
    plain.run()
    err = {"q": rows_rel_err(sim.q, plain.q),
           "bflux_accum": rows_rel_err(sim.bflux_accum, plain.bflux_accum)}
    area = sim.mesh.cell_area
    v0, v1 = sim.v0, float(np.sum(sim.get_height().astype(np.float64) * area))
    rain = RAIN_RATE * area.sum() * sim.t
    budget = abs((v1 - v0) - rain) / rain
    # the reservoir's depth is uniform, so each step's float32 rounding of
    # h + rain is the same on all its cells: up to half an ulp of its depth
    # against the rain of a step
    bound = 0.5 * float(np.spacing(np.float32(H_RESERVOIR))) / (
        RAIN_RATE * DT)
    log(f"  {RAIN_STEPS} steps on the kernels vs the plain versions (worst "
        f"row): {err}; rain {rain:.6e} m^3, volume change {v1 - v0:.6e} "
        f"(walls closed): budget error {budget:.3e} of the rain (float32 "
        f"rounding bound {bound:.3e})")
    if not (all(v <= 1e-4 for v in err.values()) and budget <= bound):
        raise SystemExit("raster rain run check failed")
    plan = st["op"].plan
    src = sim.ext_src[0].reshape(plan.ny, plan.nx).to(torch.float32)
    return coupler_rows(card, "raster+rain", sim, launches, errs, src=src)


def phase_files(errs, dev, dam_mesh):
    """Phase 12: mesh files, RCM, the native builder and the forcing
    datasets on the valley's Exodus and Gmsh files (12a-12c) and rain on
    the raster (12d)."""
    import os
    import shutil

    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output",
                        "chip_smoke_files")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out, exo, labelled = phase_files_read(work)
    rows = phase_files_order(errs, dev, work, exo)
    del exo, labelled
    phase_files_flood(dev, work, out)
    rows += phase_files_rain(errs, dev, work, dam_mesh)
    shutil.rmtree(work, ignore_errors=True)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ----------------------------------------------------------------- phase 13
# (a) the four-member ensemble on phase 3's deck: each member's Manning n,
# and the reservoir depth ("column") of the members that override it; the
# run's steps and coupling interval (in steps)
ENSEMBLE_N = (0.012, 0.018, 0.024, 0.030)
ENSEMBLE_COLUMN = (None, None, 0.20, 0.30)
ENSEMBLE_STEPS, ENSEMBLE_INTERVAL = 200, 50
# (b) AMR through the CLI on phase 3's deck: dt (the Courant number stays
# <= 0.5 on the quad fans: a small fan triangle's diagonal edge has 4
# sqrt(2) times a quad's edge-to-area ratio, 0.45 in the 0.25 m reservoir),
# steps, coupling interval (in steps), the area
# threshold (the base cells are 3.81e-6 m^2, their red children 9.5e-7: a
# cell refines at most once), the columns each minute's dataset marks
# (minute, x centre, half width [m]) and the cells after each event
AMR_DT, AMR_STEPS, AMR_INTERVAL = 0.0001, 240, 40
AMR_THRESHOLD = 2e-6
AMR_BANDS = ((0, 2.0, 0.25), (2, 3.0, 0.125))
AMR_CELLS = (3_976_192, 4_528_128)
# (c) profiling: phase 3's deck for this many steps (coupling intervals of
# 200 steps: one before `preload`, one inside it, three under StepTimer)
PROFILE_STEPS = 800
K1 = ("swe_edge_flux", "swe_cell_stage", "courant_argmax")


def ensemble_dict(steps, npz):
    """Phase 3's deck on the mesh file `npz` with an ensemble section: each
    member overrides material "smooth" with its Manning n, and members 2
    and 3 flow condition "column" with their reservoir depth; coupling
    intervals of ENSEMBLE_INTERVAL steps."""
    d = dam_break_dict(steps)
    d["grid"] = {"file": npz}
    d["time"]["coupling_interval"] = ENSEMBLE_INTERVAL * DT
    members = []
    for i, (n, h) in enumerate(zip(ENSEMBLE_N, ENSEMBLE_COLUMN)):
        m = {"name": f"member_{i}", "materials": [
            {"name": "smooth", "properties": {"manning": {"value": n}}}]}
        if h is not None:
            m["flow_conditions"] = [{"name": "column", "type": "dirichlet",
                                     "height": h, "x_momentum": 0,
                                     "y_momentum": 0}]
        members.append(m)
    d["ensemble"] = {"size": len(members), "members": members}
    return d


def step_errors(a, b):
    """Relative differences of two runs' (Simulations') q, accumulators
    (worst row) and Courant numbers."""
    r = {"q": rows_rel_err(a.q, b.q)}
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        r[name] = rows_rel_err(getattr(a, name), getattr(b, name))
    ca, cb = a.prev_max_courant, b.prev_max_courant
    r["courant"] = abs(ca - cb) / max(abs(cb), 1e-30)
    return r


def phase_ensemble(errs, dev, npz):
    """13a: the four-member ensemble on a shared grid through
    `EnsembleSimulation`: 10 steps on the kernels against 10 on the plain
    versions for every member, then ENSEMBLE_STEPS steps with exact
    launches (K1a, K1b and K1c once a member-step), each member's state
    and volume budget, each member against its solo Simulation, the
    members apart from one another; the rows of "unstructured
    ensemble4"."""
    import dataclasses

    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.config.yaml_input import config_from_dict
    from rdycore_tpu_torch.ensemble import EnsembleSimulation, member_config
    from rdycore_tpu_torch.ops import kernels
    from rdycore_tpu_torch.simulation import load_mesh_file
    from rdycore_tpu_torch.timestepping import make_interval_advancer

    card = nvidia_smi_line()
    size = len(ENSEMBLE_N)

    def cfg(steps):
        return config_from_dict(ensemble_dict(steps, npz)).validate()

    log(f"== phase 13a: a {size}-member ensemble (Manning n {ENSEMBLE_N}, "
        f"reservoir {[h or H_RESERVOIR for h in ENSEMBLE_COLUMN]} m) on a "
        f"shared grid, phase 3's deck, f32, euler, dt {DT} s, coupling "
        f"intervals of {ENSEMBLE_INTERVAL} steps")
    t0 = time.perf_counter()
    ens = EnsembleSimulation(cfg(ENSEMBLE_STEPS), device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    # 10 steps of each member on the kernels, as the ensemble's advancer
    # takes them, against 10 on the plain versions through the ensemble
    plain = EnsembleSimulation(cfg(10), device=dev)
    for m in plain.members:
        m.operator = plain_operator(m.operator)
    plain.run()
    for i, (m, mp) in enumerate(zip(ens.members, plain.members)):
        res = make_interval_advancer(m.operator, "euler")(
            m.q, m.t, m.dt, 10, 10 * m.dt, m.boundary_values, m.ext_src)
        r = {"q": rows_rel_err(res.q, mp.q)}
        for name in ("bflux_accum", "accum_sol", "accum_prim"):
            r[name] = rows_rel_err(getattr(res, name).cpu(),
                                   getattr(mp, name))
        cp = mp.prev_max_courant
        r["courant"] = abs(float(res.max_courant) - cp) / max(abs(cp), 1e-30)
        log(f"  member {i}: 10 steps, kernels vs plain versions (worst row): "
            + ", ".join(f"{k} {v:.3e}" for k, v in r.items()))
        if not (mp.step == 10 and all(v <= 1e-4 for v in r.values())):
            raise SystemExit(f"ensemble member {i} differs from plain: {r}")
    del plain, res, mp

    q0 = [m.get_solution().astype(np.float64) for m in ens.members]
    kernels.reset_launch_counts()
    walls = []
    while not ens.finished:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ens.advance()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    check_launches(f"ensemble's {ENSEMBLE_STEPS} steps", launches,
                   {k: size * ENSEMBLE_STEPS for k in K1})
    area = ens.members[0].mesh.cell_area
    for i, m in enumerate(ens.members):
        log(f"  member {i}: step {m.step}, t {m.t:.6f} s, max Courant "
            f"{m.prev_max_courant:.4f}")
        if m.step != ENSEMBLE_STEPS:
            raise SystemExit(f"member {i} took {m.step} steps")
        check_state_and_budget(m, q0[i], area)
    apart = [rows_rel_err(m.q, ens.members[0].q) for m in ens.members[1:]]
    log(f"  members 1-{size - 1} against member 0 (worst row): "
        + ", ".join(f"{v:.3e}" for v in apart))
    if not min(apart) > 1e-3:
        raise SystemExit("the ensemble's members do not differ")
    mesh = load_mesh_file(npz)
    solo_err, solo_walls = [], []
    for i, m in enumerate(ens.members):
        solo = Simulation(member_config(cfg(ENSEMBLE_STEPS), i), device=dev,
                          mesh=dataclasses.replace(mesh))
        while not solo.finished:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solo.advance()
            torch.cuda.synchronize()
            solo_walls.append(time.perf_counter() - t0)
        solo_err.append(max(rows_rel_err(m.q, solo.q),
                            rows_rel_err(m.bflux_accum, solo.bflux_accum)))
        del solo
    log(f"  each member against its solo Simulation ({ENSEMBLE_STEPS} steps;"
        f" worst row of q and the boundary fluxes): "
        + ", ".join(f"{v:.3e}" for v in solo_err))
    if not max(solo_err) <= 1e-6:
        raise SystemExit(f"members differ from their solo runs: {solo_err}")
    steady = walls[1:] or walls
    interval_ms = 1e3 * sum(steady) / len(steady)
    member_step = interval_ms / (ENSEMBLE_INTERVAL * size)
    n = ENSEMBLE_STEPS // ENSEMBLE_INTERVAL
    solo_steady = [w for k, w in enumerate(solo_walls) if k % n]
    solo_ms = 1e3 * sum(solo_steady) / len(solo_steady) / ENSEMBLE_INTERVAL
    phase3_ms = STEADY.get("unstructured main path", (float("nan"),))[0]
    log(f"  [{card}] setup {t_setup:.2f} s for {size} members; wall ms per "
        f"interval of {ENSEMBLE_INTERVAL} steps: "
        + ", ".join(f"{1e3 * w:.2f}" for w in walls)
        + f" (steady {interval_ms:.2f}); {member_step:.4f} ms per "
        f"member-step against the solo runs' {solo_ms:.4f} ms/step (the same "
        f"intervals, the first of each left out) and phase 3's "
        f"{phase3_ms:.4f} (intervals of 200 steps)")
    return coupler_rows(card, f"unstructured ensemble{size}", ens.members[0],
                        launches, errs, per_step=size)


def amr_inputs(work, mesh, dev, P=1):
    """13b's inputs in `work` (which holds dam_break.npz): the datasets of
    minutes 0 and 2 on `mesh` and phase 3's deck at dt AMR_DT (in P shards
    under `partitioning: none` where P > 1); the CLI's argv."""
    import datetime
    import os

    from rdycore_tpu_torch.forcing import dataset_filename
    from rdycore_tpu_torch.io.petsc_binary import write_petsc_vec

    amr_dir = os.path.join(work, "amr")
    if not os.path.isdir(amr_dir):
        os.makedirs(amr_dir)
        x = mesh.cell_centroid[:, 0]
        for minute, centre, half in AMR_BANDS:
            band = np.abs(x - centre) < half
            write_petsc_vec(dataset_filename(
                amr_dir, datetime.datetime(2011, 1, 1)
                + datetime.timedelta(minutes=minute)),
                band.astype(np.float64))
            log(f"  dataset of minute {minute}: {int(band.sum()):,} cells "
                f"with |x - {centre}| < {half} m")
    d = dam_break_dict(AMR_STEPS)
    d["grid"] = {"file": "dam_break.npz"}
    d["time"].update(stop=AMR_STEPS * AMR_DT, time_step=AMR_DT,
                     coupling_interval=AMR_INTERVAL * AMR_DT)
    if P > 1:
        d["parallel"] = {"n_devices": P, "partitioning": "none"}
    deck = os.path.join(work, "amr.yaml" if P == 1 else f"amr_{P}.yaml")
    with open(deck, "w") as f:  # JSON is YAML
        json.dump(d, f)
    return [deck, "--amr-dataset-dir", amr_dir, "--amr-area-threshold",
            str(AMR_THRESHOLD)] + (["--cpu"] if dev.type == "cpu" else [])


def phase_amr(errs, dev, work, mesh):
    """13b: AMR twice through the CLI's main on phase 3's deck (dt
    AMR_DT): the datasets of minutes 0 and 2 mark bands of columns (the
    state after each event kept for phase 15c); each
    event's cells, the volume across it, exact launches, the Courant
    number, h and the volume budget against the outflow over all three
    meshes, 10 steps on the kernels against the plain versions on the
    final mesh; the rows of "unstructured amr"."""
    import os

    from rdycore_tpu_torch import Simulation, amr
    from rdycore_tpu_torch.__main__ import main as cli_main
    from rdycore_tpu_torch.ops import kernels
    from rdycore_tpu_torch.timestepping import make_interval_advancer

    card = nvidia_smi_line()
    argv = amr_inputs(work, mesh, dev)
    log(f"== phase 13b: AMR through the CLI: python -m rdycore_tpu_torch "
        f"{' '.join(os.path.relpath(a) if os.sep in a else a for a in argv)}"
        f" (phase 3's deck, f32, euler, dt {AMR_DT} s, {AMR_STEPS} steps in "
        f"intervals of {AMR_INTERVAL})")

    def volume(sim):
        return float(np.sum(sim.get_height().astype(np.float64)
                            * sim.mesh.cell_area))

    def outflow(sim):
        lens = sim.operator.arrays.bnd_len.cpu().numpy().astype(np.float64)
        return float(np.sum(sim.bflux_accum[0] * lens))

    rec = {"sim": None, "intervals": [], "events": [], "refine_s": [],
           "rebuild": []}
    advance, perform = Simulation.advance, Simulation.perform_amr
    rebuild, refine = Simulation.rebuild_on_mesh, amr.refine_marked

    def first(self):
        if rec["sim"] is None:
            rec["sim"], rec["v0"] = self, volume(self)

    def timed_advance(self):
        first(self)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance(self)
        torch.cuda.synchronize()
        rec["intervals"].append((self.num_cells, time.perf_counter() - t0,
                                 self.prev_max_courant))

    def timed_perform(self):
        first(self)
        ev = dict(before=self.num_cells, marked=int(self._amr_marked.sum()),
                  v_before=volume(self), out_before=outflow(self))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perform(self)
        torch.cuda.synchronize()
        ev.update(after=self.num_cells, seconds=time.perf_counter() - t0,
                  v_after=volume(self))
        rec["events"].append(ev)
        # phase 15c's reference: the state just after the event
        REFERENCE.setdefault("amr_events", []).append(
            (self.get_solution(), self.t, self.step))

    def timed_refine(m, marked):
        t0 = time.perf_counter()
        out = refine(m, marked)
        rec["refine_s"].append(time.perf_counter() - t0)
        return out

    def timed_rebuild(self, new_mesh, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rebuild(self, new_mesh, n)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(self.device) / 1e9
                if self.device.type == "cuda" else float("nan"))
        rec["rebuild"].append((time.perf_counter() - t0, peak))

    Simulation.advance, Simulation.perform_amr = timed_advance, timed_perform
    Simulation.rebuild_on_mesh, amr.refine_marked = timed_rebuild, timed_refine
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = cli_main(argv)
    finally:
        Simulation.advance, Simulation.perform_amr = advance, perform
        Simulation.rebuild_on_mesh, amr.refine_marked = rebuild, refine
    t_cli = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    sim = rec["sim"]
    if rc != 0 or sim is None:
        raise SystemExit(f"the CLI returned {rc}")
    check_launches(f"AMR run's {AMR_STEPS} steps", launches,
                   {k: AMR_STEPS for k in K1})
    for ev, refine_s, (rebuild_s, peak) in zip(
            rec["events"], rec["refine_s"], rec["rebuild"]):
        dv = abs(ev["v_after"] - ev["v_before"]) / ev["v_before"]
        ev["volume_rel"] = dv
        log(f"  [{card}] event: {ev['marked']:,} cells marked, "
            f"{ev['before']:,} -> {ev['after']:,} cells; refine_marked "
            f"{refine_s:.2f} s, rebuild {rebuild_s:.2f} s, perform_amr "
            f"{ev['seconds']:.2f} s; peak device memory {peak:.2f} GB; "
            f"volume {ev['v_before']:.9e} -> {ev['v_after']:.9e} m^3 "
            f"(relative {dv:.2e})")
    cells = tuple(ev["after"] for ev in rec["events"])
    if cells != AMR_CELLS or not all(ev["volume_rel"] <= 1e-6
                                     for ev in rec["events"]):
        raise SystemExit(f"refinement events: cells {cells}, expected "
                         f"{AMR_CELLS}, or the volume moved")
    courant = max(c for _, _, c in rec["intervals"])
    by_cells = {}
    for n, wall, _ in rec["intervals"]:
        by_cells.setdefault(n, []).append(wall)
    for n, walls in by_cells.items():
        log(f"  [{card}] {n:,} cells: "
            + ", ".join(f"{1e3 * w / AMR_INTERVAL:.4f}" for w in walls)
            + " ms/step (each interval of "
            f"{AMR_INTERVAL} steps, its read-back included)")
    log(f"  [{card}] 2,883,584 cells: phase 3's "
        f"{STEADY.get('unstructured main path', (float('nan'),))[0]:.4f} "
        f"ms/step (dt {DT} s); the CLI run {t_cli:.2f} s in all; max Courant"
        f" {courant:.4f}")
    h = sim.get_height()
    v1 = volume(sim)
    out = sum(ev["out_before"] for ev in rec["events"]) + outflow(sim)
    budget = abs((rec["v0"] - v1) - out) / rec["v0"]
    log(f"  volume: initial {rec['v0']:.9e} m^3, final {v1:.9e}, lost "
        f"{rec['v0'] - v1:.6e}, outflow over the three meshes {out:.6e}, "
        f"budget error {budget:.3e} of the initial volume")
    if not (sim.step == AMR_STEPS and np.isfinite(sim.get_solution()).all()
            and h.min() >= 0.0 and budget <= 1e-4 and out > 0.0
            and courant <= 0.5):
        raise SystemExit(f"AMR run: step {sim.step}, min h {h.min()}, budget "
                         f"{budget}, outflow {out}, Courant {courant}")
    t1 = sim.t + 10 * AMR_DT
    res, ms = [], []
    for op in (sim.operator, plain_operator(sim.operator)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res.append(make_interval_advancer(op, "euler")(
            sim.q, sim.t, AMR_DT, 10, t1, sim.boundary_values, sim.ext_src))
        torch.cuda.synchronize()
        ms.append(1e2 * (time.perf_counter() - t0))
    log(f"  [{card}] 10 steps on the {sim.num_cells:,}-cell mesh without "
        f"the read-back: {ms[0]:.4f} ms/step on the kernels, {ms[1]:.4f} "
        "on the plain versions")
    r = {name: vector_rel_err(getattr(res[0], name), getattr(res[1], name))
         for name in ("q", "bflux_accum", "accum_sol", "accum_prim")}
    ck, cp = float(res[0].max_courant), float(res[1].max_courant)
    r["courant"] = abs(ck - cp) / max(abs(cp), 1e-30)
    q_max = res[1].q.abs().amax(dim=1).tolist()
    q_err = (res[0].q - res[1].q).abs().amax(dim=1).tolist()
    log(f"  10 steps on the {sim.num_cells:,}-cell mesh, kernels vs plain "
        f"versions (momentum rows against the momentum's scale): "
        + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
        + "; q's rows h, hu, hv: largest " + ", ".join(
            f"{v:.3e}" for v in q_max) + ", largest difference " + ", ".join(
            f"{v:.3e}" for v in q_err))
    if not all(v <= 1e-4 for v in r.values()):
        raise SystemExit(f"AMR mesh: kernels differ from plain: {r}")
    del res
    return coupler_rows(card, "unstructured amr", sim, launches, errs,
                        dt=AMR_DT)


def phase_profiling(dev, mesh, work):
    """13c: profiling.py on phase 3's deck: `preload` after an interval
    puts the state back bit for bit; `StepTimer`'s steady cell-updates/s
    beside phase 3's; `trace` writes a Chrome trace naming K1a, K1b and
    K1c."""
    import os

    from rdycore_tpu_torch.profiling import StepTimer, preload, trace

    card = nvidia_smi_line()
    log(f"== phase 13c: profiling.py on phase 3's deck ({PROFILE_STEPS} "
        "steps, intervals of 200)")
    sim = unstructured_simulation(PROFILE_STEPS, dev, mesh)
    sim.advance()

    def state():
        return (sim.q.clone(), sim.t, sim.step, sim.dt, sim.prev_max_courant,
                sim.prev_courant_edge, sim.bflux_accum.copy(),
                sim.accum_sol.copy(), sim.accum_prim.copy(), sim.accum_time)

    before = state()
    seconds = preload(sim)
    after = state()
    same = (torch.equal(before[0], after[0]) and before[1:6] == after[1:6]
            and all(np.array_equal(a, b) for a, b in zip(before[6:9],
                                                         after[6:9]))
            and before[9] == after[9])
    log(f"  preload: one interval in {seconds:.3f} s; the state after it "
        f"{'bit for bit' if same else 'DIFFERS from'} the state before (q, "
        "t, step, dt, Courant number and edge, accumulators)")
    if not same:
        raise SystemExit("preload did not restore the state")
    timer = StepTimer(sim)
    sim.add_monitor(timer)
    sim.run()
    summary = timer.summary()
    rate = STEADY.get("unstructured main path", (0.0, float("nan")))[1]
    log(f"  [{card}] StepTimer: {json.dumps(summary)}; phase 3's "
        f"{rate:.4e} cell-updates/s")
    if not (sim.step == PROFILE_STEPS and summary["steady_intervals"] >= 2):
        raise SystemExit(f"StepTimer: {summary}")
    names = {"K1a": "swe_edge_flux_kernel", "K1b": "swe_cell_stage_kernel",
             "K1c": "courant_argmax_kernel"}
    for attempt in range(3):  # a profiler session may drop device records
        logdir = os.path.join(work, f"trace{attempt}")
        short = unstructured_simulation(10, dev, mesh)
        with trace(logdir):
            short.run()
        path = os.path.join(logdir, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        seen = {k: sum(1 for e in events if v in e.get("name", ""))
                for k, v in names.items()}
        log(f"  trace(): {os.path.getsize(path):,} bytes, {len(events):,} "
            f"events; kernel events over 10 steps {seen}")
        if all(seen.values()):
            return
    raise SystemExit("the trace names no K1a, K1b or K1c events")


def phase_ensemble_amr(errs, dev, mesh):
    """Phase 13: a four-member ensemble (13a), AMR twice through the CLI
    (13b) and the profiling harness (13c), on phase 3's mesh written as an
    .npz."""
    import os
    import shutil

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "output", "chip_smoke_ensemble")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    npz = os.path.join(work, "dam_break.npz")
    dam_break_npz(mesh, npz)
    rows = phase_ensemble(errs, dev, npz)
    rows += phase_amr(errs, dev, work, mesh)
    phase_profiling(dev, mesh, work)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(os.path.join(root, "output", "chip_smoke_mesh"),
                  ignore_errors=True)
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ----------------------------------------------------------------- phase 14
RANKS = 2  # 14a-c: ranks sharing the one card, over gloo
RANK_STEPS = 200  # 14a: the timed interval
RANK_MUSCL_STEPS = 24  # 14b
RANK_TIMEOUT = 600.0  # the process group's timeout [s]
_SHARD_REPLACES = {  # the JAX sharded path's per-shard kernels
    "swe_edge_flux": _SLOTTED + ":2899", "swe_cell_stage": _SLOTTED + ":2899",
    "courant_argmax": _SLOTTED + ":2899"}
_SHARD_MUSCL_REPLACES = {
    "swe_muscl_grad": _SLOTTED + ":3146", "swe_edge_flux": _SLOTTED + ":3342",
    "swe_positivity_drain": _SLOTTED + ":1632",
    "swe_positivity_scale": _SLOTTED + ":1781",
    "swe_cell_stage": _SLOTTED + ":2342", "courant_argmax": _SLOTTED + ":2342"}


def sharded_config(steps, ranks, config=dam_break_config,
                   partitioning="auto"):
    """`config`'s deck in `ranks` shards, RCM-banded for the split
    (parallel.partitioning: auto), or on a mesh ordered already ("none")."""
    cfg = config(steps)
    cfg.parallel.n_devices = ranks
    cfg.parallel.partitioning = partitioning
    return cfg


def rcm_config(steps, config=dam_break_config):
    """`config`'s deck on one device in the shards' cell order."""
    cfg = config(steps)
    cfg.numerics.cell_ordering = "rcm"
    return cfg


def run_state(sim):
    """`final_state` and the Courant number's edge (collective in a run of
    several ranks)."""
    return final_state(sim) + (sim.prev_courant_edge,)


def same_run(a, b):
    return same_state(a[:4], b[:4]) and a[4] == b[4]


def events_ms(fn, reps=1):
    """Milliseconds per call of fn() between CUDA events, after a device
    synchronization (the host's time where that is longer)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def shard_rows(card, path, op, q, bv, launches, steps, muscl):
    """The kernels of one shard (`op`, its state q with fresh ghost rows,
    its boundary values bv) held against their plain versions at the
    shard's shapes (2e-5 relative, the Courant fold exact) and timed
    beside their bounds: the {"kernels": ...} rows of `path`."""
    from rdycore_tpu_torch.ops.kernels import muscl as mk
    from rdycore_tpu_torch.ops.kernels.cell_stage import swe_cell_stage_plain
    from rdycore_tpu_torch.ops.kernels.courant import courant_argmax_plain
    from rdycore_tpu_torch.ops.kernels.edge_flux import swe_edge_flux_plain
    from rdycore_tpu_torch.ops.swe.muscl import ls_gradients

    dev, a, s = q.device, op.arrays, q.element_size()
    dt = torch.tensor(DT_MUSCL if muscl else DT, dtype=q.dtype, device=dev)
    th, ta = op.tiny_h, op.h_anuga
    kw = dict(tiny_h=th, h_anuga=ta, xq2018_threshold=op.xq2018_threshold,
              source_method=op.source_method)
    stage = dict(stage=(0.0, 1.0, 1.0), emit_prim=True)
    run = (torch.zeros((), dtype=q.dtype, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    pairs, calls = {}, {}
    if muscl:
        gk, gp = op.muscl_grad(q), ls_gradients(a, q)
        flux, courant = op.edge_flux(q, bv, gp)
        fp, cp = swe_edge_flux_plain(a, q, bv, th, ta, grad=gp,
                                     limiter=op.limiter)
        sp = mk.positivity_drain_plain(a, fp, q[0], dt)
        pairs["swe_muscl_grad"] = [(gk, gp)]
        pairs["swe_positivity_drain"] = [
            (mk.swe_positivity_drain(a, fp, q[0], dt), sp)]
        pairs["swe_positivity_scale"] = [
            (mk.swe_positivity_scale(a, fp.clone(), sp),
             mk.positivity_scale_plain(a, fp.clone(), sp))]
        calls["swe_muscl_grad"] = (lambda: op.muscl_grad(q),
                                   lambda: ls_gradients(a, q), None)
        calls["swe_edge_flux"] = (
            lambda: op.edge_flux(q, bv, gk),
            lambda: swe_edge_flux_plain(a, q, bv, th, ta, grad=gk,
                                        limiter=op.limiter), None)
        calls["swe_positivity_drain"] = (
            lambda: mk.swe_positivity_drain(a, flux, q[0], dt),
            lambda: mk.positivity_drain_plain(a, flux, q[0], dt), None)
        calls["swe_positivity_scale"] = (
            lambda: mk.swe_positivity_scale(a, flux, sp),
            lambda: mk.positivity_scale_plain(a, flux, sp), None)
    else:
        flux, courant = op.edge_flux(q, bv)
        fp, cp = swe_edge_flux_plain(a, q, bv, th, ta)
        calls["swe_edge_flux"] = (
            lambda: op.edge_flux(q, bv),
            lambda: swe_edge_flux_plain(a, q, bv, th, ta), None)
    pairs["swe_edge_flux"] = [(flux, fp), (courant, cp)]
    ok_ = op.cell_stage(fp, q, dt, None, **stage)
    op_ = swe_cell_stage_plain(a, fp, q, dt, None, **kw, **stage)
    pairs["swe_cell_stage"] = [(ok_.q_out, op_.q_out), (ok_.prim, op_.prim)]
    calls["swe_cell_stage"] = (
        lambda: op.cell_stage(flux, q, dt, None, **stage),
        lambda: swe_cell_stage_plain(a, flux, q, dt, None, **kw, **stage),
        None)
    mk_, ik = op.courant_max(cp, dt, *run)
    mp, ip = courant_argmax_plain(cp)
    calls["courant_argmax"] = (
        lambda: op.courant_max(courant, dt, *run),
        lambda: courant_argmax_plain(courant, dt, *run),
        lambda: torch.max(courant, 0))
    rel = {k: max(rel_err(g, w) for g, w in v) for k, v in pairs.items()}
    err = {k: max(abs_err(g, w) for g, w in v) for k, v in pairs.items()}
    err["courant_argmax"] = abs(float(mk_) - float(mp))
    exact = float(mk_) == float(mp) and int(ik) == int(ip)
    log(f"  shard kernels vs plain on the {path} path (relative): {rel}; "
        f"Courant fold {'exact' if exact else 'DIFFERS'}")
    if not (exact and all(v <= TOL[q.dtype] for v in rel.values())):
        raise SystemExit(f"{path} shard kernel check failed")
    C, E, Ei = op.num_cells, op.num_edges, op.num_internal_edges
    nbytes = kernel_bytes(op, q.numel() * s, s)
    nops = {"swe_edge_flux": OPS_PER_EDGE * E,
            "swe_cell_stage": OPS_PER_CELL * C,
            "courant_argmax": OPS_PER_VALUE * E}
    replaces = dict(REPLACES, **_SHARD_REPLACES)
    if muscl:
        mb = muscl_bytes(op, q.numel() * s, s)
        nbytes.update({k: mb[k] for k in mb})
        nops.update(swe_muscl_grad=OPS_PER_GRAD_CELL * C,
                    swe_edge_flux=OPS_PER_EDGE * (E - Ei)
                    + OPS_PER_MUSCL_EDGE * Ei,
                    swe_positivity_drain=OPS_PER_DRAIN_CELL * C,
                    swe_positivity_scale=OPS_PER_SCALE_EDGE * E)
        replaces.update(_SHARD_MUSCL_REPLACES)
    extra = dict(ranks=RANKS, shard_cells=C, launches_per_step={
        k: v / steps for k, v in launches.items() if v})
    return [kernel_row(card, name, path, fns, launches[name], err[name],
                       nbytes[name], nops[name], q.dtype, replaces, **extra)
            for name, fns in calls.items()]


def rank_device():
    """The card of this rank (spawn made it the current device)."""
    return torch.device("cuda", torch.cuda.current_device())


def rank_phase(rank, world, steps):
    """Phase 14a-c in one of `world` ranks on the one card (gloo): what
    the parent compares, and rank 0's kernel rows."""
    import torch.distributed as dist

    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.ops import kernels

    dev = rank_device()
    card = nvidia_smi_line()
    out = {"rank": rank, "rows": []}
    t0 = time.perf_counter()
    mesh = dam_break_mesh()
    out["mesh_s"] = time.perf_counter() - t0

    # (a) phase 3's dam break in shards
    t0 = time.perf_counter()
    sim = Simulation(sharded_config(10 + RANK_STEPS, world), mesh=mesh,
                     device=dev)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    sh = sim._sharded
    u = sh.units[0]
    plan = sh.plans[rank]
    out["ghosts"], out["frontier"] = len(plan.ghosts), plan.frontier
    out["owned"] = plan.nown
    q0 = sim.get_solution().astype(np.float64)
    rmesh = sim.mesh  # RCM's order: the later decks take it as it is
    plain = Simulation(sharded_config(10, world, partitioning="none"),
                       mesh=rmesh, device=dev)
    plain._sharded.ops[u] = plain_operator(plain._sharded.ops[u])
    sim.coupling_interval = 10 * DT
    sim.advance()
    plain.run()
    err = {"q": rows_rel_err(sim.q, plain.q)}
    for name in ("bflux_accum", "accum_sol", "accum_prim"):
        err[name] = rows_rel_err(getattr(sim, name), getattr(plain, name))
    ck, cp = sim.prev_max_courant, plain.prev_max_courant
    err["courant"] = abs(ck - cp) / max(abs(cp), 1e-30)
    out["a_err"] = err
    out["a10"] = run_state(sim)
    del plain
    torch.cuda.reset_peak_memory_stats(dev)
    sim.coupling_interval = RANK_STEPS * DT
    kernels.reset_launch_counts()
    dist.barrier()
    t0 = time.perf_counter()
    out["a_ms"] = events_ms(sim.advance) / RANK_STEPS
    out["a_wall_ms"] = 1e3 * (time.perf_counter() - t0) / RANK_STEPS
    out["a_launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    # this rank's shard, its operator and accumulators: no global array
    out["a_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    check_state_and_budget(sim, q0, sim.mesh.cell_area)
    q = sim._qs[u]
    tr = sh.transport
    ghosts = torch.arange(plan.nown, plan.nown + len(plan.ghosts),
                          device=dev)
    tr.exchange(u, q)
    want = q.index_select(1, ghosts)
    q.index_fill_(1, ghosts, -1.0)
    tr.exchange_gather(q)
    out["a_gather_same"] = bool(torch.equal(q.index_select(1, ghosts),
                                            want))
    times = {"p2p": [], "gather": []}
    for mode in ("p2p", "gather", "gather", "p2p"):
        dist.barrier()
        times[mode].append(events_ms(
            (lambda: tr.exchange(u, q)) if mode == "p2p"
            else (lambda: tr.exchange_gather(q)), reps=20))
    out["a_exchange_ms"] = float(np.mean(times["p2p"]))
    out["a_gather_ms"] = float(np.mean(times["gather"]))
    out["a_exchange_runs"] = times
    if rank == 0:
        out["rows"] += shard_rows(card, "unstructured sharded", sh.ops[u], q,
                                  sim._bvs[u], out["a_launches"], RANK_STEPS,
                                  False)
    dist.barrier()
    del sim, q

    # (b) phase 6's second-order deck in shards: three rings of ghosts
    sim = Simulation(sharded_config(RANK_MUSCL_STEPS, world,
                                    muscl_dam_break_config, "none"),
                     mesh=rmesh, device=dev)
    sh = sim._sharded
    out["b_rings"] = sh.plans[rank].rings
    kernels.reset_launch_counts()
    sim.run()
    out["b_launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    out["b"] = run_state(sim)
    if rank == 0:
        out["rows"] += shard_rows(card, "unstructured sharded+muscl",
                                  sh.ops[u], sim._qs[u], sim._bvs[u],
                                  out["b_launches"], RANK_MUSCL_STEPS, True)
    dist.barrier()
    del sim

    # (c) phase 4's raster in one row strip per rank
    cfg = dam_break_config(steps, "fused_structured")
    cfg.parallel.n_devices = world
    sim = Simulation(cfg, mesh=mesh, device=dev)
    rs = sim._rank_strip
    out["c_strip"] = list(rs.strip)
    kernels.reset_launch_counts()
    dist.barrier()
    t0 = time.perf_counter()
    total = events_ms(sim.run)
    out["c_wall_ms"] = 1e3 * (time.perf_counter() - t0) / steps
    out["c_ms"] = total / steps
    out["c_launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    out["c"] = final_state(sim)
    dist.barrier()
    out["c_exchange_ms"] = events_ms(lambda: rs.exchange([rs.buf]), reps=20)
    if rank == 0:
        op = sim._structured["op"]
        bv = sim.boundary_values.to(dev, torch.float32)[:, op.bnd_idx.to(dev)]
        out["rows"] += strip_rows(
            card, op, rs.buf, bv, "raster strips, ranks", out["c_launches"],
            dev, DT, 0, dict(strip=list(rs.strip), strips=world, ranks=world,
                             launches_per_step={
                                 k: v / steps for k, v in
                                 out["c_launches"].items() if v}))
    dist.barrier()
    return out


def nccl_rank(rank, world, backend):
    """Phase 14d in the one rank of an NCCL group: phase 3's deck, 10
    steps, its one shard exchanging with no peer and its Courant pair
    gathered over NCCL."""
    import torch.distributed as dist

    from rdycore_tpu_torch import Simulation

    sim = Simulation(dam_break_config(10), mesh=dam_break_mesh(),
                     device=rank_device())
    if sim._sharded is None or dist.get_backend() != backend:
        raise SystemExit(f"14d: the {backend} rank did not take the shard "
                         "path")
    sim.run()
    return run_state(sim)


def phase_ranks(steps, dev, mesh):
    """Phase 14: multi-process runs on the one card: (a)-(c) in RANKS
    ranks over gloo (NCCL refuses two ranks on one card), (d) one NCCL
    rank. Returns the rows of rank 0's kernels."""
    import os
    import tempfile

    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.mesh.core import rcm_reorder
    from rdycore_tpu_torch.parallel.comm import spawn

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    log(f"== phase 14: {RANKS} ranks on one card over gloo (14a-c), one "
        f"NCCL rank (14d); dam break on {mesh.num_cells:,} cells, f32")
    refs = {}
    rmesh = rcm_reorder(mesh)  # the shards' cell order
    for key, steps_, config in (("a", 10, dam_break_config),
                                ("b", RANK_MUSCL_STEPS,
                                 muscl_dam_break_config)):
        ref = Simulation(config(steps_), mesh=rmesh, device=dev)
        ref.run()
        refs[key] = run_state(ref)
        del ref
    one = Simulation(dam_break_config(10), mesh=mesh, device=dev)
    one.run()
    refs["d"] = run_state(one)
    del one, rmesh
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output")
    os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=base) as store:
        t0 = time.perf_counter()
        got = spawn(rank_phase, RANKS, "gloo", store, args=(steps,),
                    timeout=RANK_TIMEOUT, device="cuda:0")
        t_gloo = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_d = spawn(nccl_rank, 1, "nccl", store, args=("nccl",),
                      timeout=RANK_TIMEOUT, device="cuda:0")[0]
        t_nccl = time.perf_counter() - t0
    bad = []
    for r in got:
        k = r["rank"]
        a_ok = all(v <= 1e-4 for v in r["a_err"].values())
        same = {key: same_run(r[key], refs[key[0]]) for key in ("a10", "b")}
        same["c"] = same_state(r["c"], REFERENCE["raster"])
        log(f"  [{card}] rank {k}: mesh {r['mesh_s']:.2f} s, setup "
            f"{r['setup_s']:.2f} s (operator on the host, partition, the "
            f"shard to the card); {r['owned']:,} owned cells, "
            f"{r['ghosts']:,} ghosts, {r['frontier']:,} frontier cells "
            f"(MUSCL rings {r['b_rings']})")
        log(f"  rank {k} 14a: 10 steps, kernels vs plain (worst row) "
            + ", ".join(f"{n} {v:.3e}" for n, v in r["a_err"].items())
            + f"; against one process on the RCM order (q, t, Courant "
            f"number and edge, boundary fluxes): "
            f"{'bit for bit' if same['a10'] else 'DIFFERENT'}")
        log(f"  [{card}] rank {k} 14a: {RANK_STEPS}-step interval "
            f"{r['a_ms']:.4f} ms/step between CUDA events "
            f"({r['a_wall_ms']:.4f} ms wall), peak device memory "
            f"{r['a_peak_gb']:.3f} GB; exchange "
            f"{r['a_exchange_ms']:.4f} ms per stage (point-to-point "
            f"{r['a_exchange_runs']['p2p']}), one all-gather "
            f"{r['a_gather_ms']:.4f} ({r['a_exchange_runs']['gather']}; "
            f"the same ghost rows: {r['a_gather_same']}); launches "
            f"{r['a_launches']}")
        log(f"  rank {k} 14b: {RANK_MUSCL_STEPS} second-order steps against "
            f"one process on the RCM order: "
            f"{'bit for bit' if same['b'] else 'DIFFERENT'}; launches "
            f"{r['b_launches']}")
        log(f"  [{card}] rank {k} 14c: strip {r['c_strip']}, {steps} steps "
            f"{r['c_ms']:.4f} ms/step between CUDA events "
            f"({r['c_wall_ms']:.4f} ms wall), exchange "
            f"{r['c_exchange_ms']:.4f} ms per stage; against phase 4's "
            f"single strip (q, t, Courant number, boundary fluxes): "
            f"{'bit for bit' if same['c'] else 'DIFFERENT'}; launches "
            f"{r['c_launches']}")
        check_launches(f"rank {k} 14a", r["a_launches"], {
            "swe_edge_flux": RANK_STEPS, "swe_cell_stage": RANK_STEPS,
            "courant_argmax": RANK_STEPS})
        n = RANK_MUSCL_STEPS
        check_launches(f"rank {k} 14b", r["b_launches"], {
            "swe_muscl_grad": 2 * n, "swe_edge_flux": 2 * n,
            "swe_positivity_drain": 2 * n, "swe_positivity_scale": 2 * n,
            "swe_cell_stage": 2 * n, "courant_argmax": n})
        check_launches(f"rank {k} 14c", r["c_launches"], {
            "swe_raster_step": steps, "courant_argmax": steps,
            "swe_edge_flux": steps})
        if not (a_ok and all(same.values()) and r["a_gather_same"]):
            bad.append(k)
    one_ms = STEADY["unstructured main path"][0]
    raster_ms = STEADY["raster main path"][0]
    log(f"  [{card}] one process, one card: unstructured {one_ms:.4f} "
        f"ms/step, raster {raster_ms:.4f} ms/step (phases 3 and 4)")
    same_d = same_run(got_d, refs["d"])
    log(f"  14d: one NCCL rank, 10 steps against one process (q, t, "
        f"Courant number and edge, boundary fluxes): "
        f"{'bit for bit' if same_d else 'DIFFERENT'}")
    log(f"  phase 14: {RANKS} gloo ranks {t_gloo:.1f} s, the NCCL rank "
        f"{t_nccl:.1f} s, in all {time.perf_counter() - t_phase:.1f} s")
    if bad or not same_d:
        raise SystemExit(f"phase 14 failed: ranks {bad}, 14d {same_d}")
    return got[0]["rows"]


# ----------------------------------------------------------------- phase 15
SHARD_WB_STEPS = 100  # 15a: the timed BS2002 interval after the first 10
SHARD_WB_MUSCL_STEPS = 24  # 15a: BS2002 with MUSCL, ssprk2
# 15b: beuler's launches a step (row 5's: K1a and K1b in rhs mode 25
# times, K1c once)
BEULER_STEP = {"swe_edge_flux": 25, "swe_cell_stage": 25,
               "courant_argmax": 1}


def wb_shard_simulation(steps, dev, mesh, ranks, partitioning, eta,
                        **deck):
    """A phase-7 deck in `ranks` shards (a process group of that size),
    its depths set to max(eta(x) - cell_z, 0) on the simulation's own cell
    order (RCM's under partitioning: auto; the setter is collective)."""
    from rdycore_tpu_torch import Simulation

    cfg = wb_config(steps, **deck)
    cfg.parallel.n_devices = ranks
    cfg.parallel.partitioning = partitioning
    sim = Simulation(cfg, mesh=mesh, device=dev)
    m = sim.mesh
    sim.set_height(np.maximum(eta(m.cell_centroid[:, 0]) - m.cell_z, 0.0))
    return sim


def wb_rcm_simulation(steps, dev, rmesh, eta, **deck):
    """The same deck on one device, on the shards' (RCM) cell order."""
    from rdycore_tpu_torch import Simulation

    sim = Simulation(wb_config(steps, **deck), mesh=rmesh, device=dev)
    sim.set_height(np.maximum(eta(rmesh.cell_centroid[:, 0])
                              - rmesh.cell_z, 0.0))
    return sim


def limited_cells(op, q, bv, dt, nown):
    """The owned cells of a shard state q (fresh ghosts) whose donor factor
    is below 1 over dt (K3b drain's plain version)."""
    from rdycore_tpu_torch.ops.kernels.muscl import positivity_drain_plain

    flux, _ = op.edge_flux(q, bv, op.muscl_grad(q), op.eta_vertices(q[0]))
    s = positivity_drain_plain(op.arrays, flux, q[0], dt)
    return int((s[:nown] < 1.0).sum())


def sharded_beuler_split(card, sh, u, q, bv, dt):
    """One more backward-Euler step of unit u of the shards `sh` from q,
    each residual, each JVP and each global sum between CUDA events: ms
    of the step split into residual kernels (the exchanges inside), JVPs
    (theirs inside), global sums and glue (the rest); the collectives of
    the step; the global Newton residual norm after the last iteration
    beside its start (collective: every rank calls it)."""
    from rdycore_tpu_torch.operator import linearization_twin
    from rdycore_tpu_torch.timestepping import (
        newton_beuler_solve,
        with_exchange,
    )

    def ex(x):
        sh.exchange(u, x)

    op = with_exchange(sh.ops[u], ex)
    twin = with_exchange(linearization_twin(sh.ops[u]), ex)
    spans = {"residual": [], "jvp": [], "global sum": []}

    def timed(kind, fn):
        def g(*x):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fn(*x)
            e1.record()
            spans[kind].append((e0, e1))
            return out
        return g

    def F(x):
        return op.rhs(x, dt, bv, None)

    def gdot(a, b):
        return sh.gdot(u, a, b)

    counts = dict(sh.counts)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    timed("residual", lambda x: op.apply(x, dt, bv, None))(q)
    u1 = newton_beuler_solve(
        timed("residual", F),
        timed("jvp", lambda x: twin.rhs(x, dt, bv, None)), q, dt,
        timed("global sum", gdot))
    e1.record()
    torch.cuda.synchronize()
    total = e0.elapsed_time(e1)
    calls = {k: sh.counts[k] - counts[k] for k in counts}
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    glue = total - sum(ms.values())
    r = dt * F(q)
    r0 = float(torch.sqrt(gdot(r, r)))
    r = u1 - q - dt * F(u1)
    r1 = float(torch.sqrt(gdot(r, r)))
    log(f"  [{card}] sharded beuler step split (CUDA events): {total:.1f} ms"
        f" = residual kernels {ms['residual']:.1f} ms "
        f"({len(spans['residual'])} calls) + JVPs {ms['jvp']:.1f} ms "
        f"({len(spans['jvp'])} calls) + global sums "
        f"{ms['global sum']:.1f} ms ({len(spans['global sum'])} calls) + "
        f"glue {glue:.1f} ms; collectives {calls}; global Newton residual "
        f"{r0:.4e} at u^n -> {r1:.4e} ({r1 / r0:.3e})")
    if not (np.isfinite(r1) and r1 < r0):
        raise SystemExit("sharded beuler: the Newton residual did not fall")
    return dict(step_ms=total, residual_ms=ms["residual"], jvp_ms=ms["jvp"],
                global_sum_ms=ms["global sum"], glue_ms=glue,
                collectives=calls, residual_start=r0, residual_end=r1)


def amr_rank_run(argv):
    """The CLI's main on `argv` in this rank (13b's run in shards): the
    state, time and step after each refinement event (collective), the
    volume across it, `refine_marked` and rebuild seconds and the peak
    device memory of the rebuild, the launches and the final state."""
    from rdycore_tpu_torch import Simulation, amr
    from rdycore_tpu_torch.__main__ import main as cli_main
    from rdycore_tpu_torch.ops import kernels

    def volume(sim):
        return float(np.sum(sim.get_height().astype(np.float64)
                            * sim.mesh.cell_area))

    rec = {"events": [], "refine_s": [], "rebuild": [], "sim": None}
    perform, rebuild = Simulation.perform_amr, Simulation.rebuild_on_mesh
    refine = amr.refine_marked

    def timed_perform(self):
        rec["sim"] = self
        v0 = volume(self)
        perform(self)
        rec["events"].append(dict(state=(self.get_solution(), self.t,
                                         self.step),
                                  v_before=v0, v_after=volume(self),
                                  cells=self.num_cells))

    def timed_refine(m, marked):
        t0 = time.perf_counter()
        out = refine(m, marked)
        rec["refine_s"].append(time.perf_counter() - t0)
        return out

    def timed_rebuild(self, new_mesh, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rebuild(self, new_mesh, n)
        torch.cuda.synchronize()
        rec["rebuild"].append((time.perf_counter() - t0,
                               torch.cuda.max_memory_allocated(self.device)
                               / 1e9))

    Simulation.perform_amr, Simulation.rebuild_on_mesh = (timed_perform,
                                                          timed_rebuild)
    amr.refine_marked = timed_refine
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = cli_main(argv)
    finally:
        Simulation.perform_amr, Simulation.rebuild_on_mesh = (perform,
                                                              rebuild)
        amr.refine_marked = refine
    sim = rec.pop("sim")
    rec.update(rc=rc, seconds=time.perf_counter() - t0,
               launches={k.__name__: k.launches for k in kernels.KERNELS},
               final=(sim.get_solution(), sim.t, sim.step),
               transport=type(sim._sharded.transport).__name__)
    return rec


def shards_16b_rank(rank, world, argv):
    """Phase 15a-c in one of `world` gloo ranks on the one card: what the
    parent compares, and rank 0's kernel rows."""
    import torch.distributed as dist

    from rdycore_tpu_torch import Simulation
    from rdycore_tpu_torch.ops import kernels

    dev = rank_device()
    card = nvidia_smi_line()
    out = {"rank": rank, "rows": []}
    eta = dam_eta(H_WB_SUBMERGED)
    bs = dict(wb="bs2002", dt=DT_WB)

    # (a) phase 7's BS2002 deck in shards (partitioning: auto, RCM)
    t0 = time.perf_counter()
    mesh = wb_mesh()
    sim = wb_shard_simulation(10 + SHARD_WB_STEPS, dev, mesh, world, "auto",
                              eta, **bs)
    torch.cuda.synchronize()
    out["a_setup_s"] = time.perf_counter() - t0
    del mesh
    sh = sim._sharded
    u = sh.units[0]
    plan = sh.plans[rank]
    out.update(owned=plan.nown, ghosts=len(plan.ghosts),
               vertex_ghosts=plan.vertex_ghosts, frontier=plan.frontier,
               neighbours=sorted(plan.recv))
    rmesh = sim.mesh
    q0 = sim.get_solution().astype(np.float64)
    qs0 = {u: sim._qs[u].clone()}
    sim.coupling_interval = 10 * DT_WB
    sim.advance()
    # the same 10 steps of the shards on the plain versions (an interval
    # of their own, without the accumulators)
    kernel_op = sh.ops[u]
    sh.ops[u] = plain_operator(kernel_op)
    plain = sh.make_interval_fn("euler", accumulate=False,
                                ext_sources=False)(
        qs0, 0.0, DT_WB, 10, 10 * DT_WB, sim._bvs, sim._ess)
    sh.ops[u] = kernel_op
    err = {"q": rows_rel_err(sim.q, sh.gather_state(plain.qs,
                                                    torch.device("cpu")))}
    ck, cp = sim.prev_max_courant, plain.max_courant
    err["courant"] = abs(ck - cp) / max(abs(cp), 1e-30)
    out["a_err"] = err
    out["a10"] = run_state(sim)
    del plain, qs0
    torch.cuda.reset_peak_memory_stats(dev)
    sim.coupling_interval = SHARD_WB_STEPS * DT_WB
    kernels.reset_launch_counts()
    dist.barrier()
    t0 = time.perf_counter()
    out["a_ms"] = events_ms(sim.advance) / SHARD_WB_STEPS
    out["a_wall_ms"] = 1e3 * (time.perf_counter() - t0) / SHARD_WB_STEPS
    out["a_launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    out["a_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    check_state_and_budget(sim, q0, rmesh.cell_area)
    q = sim._qs[u]
    tr = sh.transport
    dist.barrier()
    out["a_exchange_ms"] = events_ms(lambda: tr.exchange(u, q), reps=20)
    if rank == 0:
        dt = torch.tensor(DT_WB, dtype=q.dtype, device=dev)
        out["rows"] += wb_kernel_rows(
            card, "unstructured sharded+bs2002", sh.ops[u], q, sim._bvs[u],
            dt, out["a_launches"], {}, ranks=world, shard_cells=q.shape[1],
            launches_per_step={k: v / SHARD_WB_STEPS for k, v in
                               out["a_launches"].items() if v})
    dist.barrier()
    del sim, q

    # (a) then BS2002 with MUSCL and the positivity limiter (ssprk2)
    sim = wb_shard_simulation(SHARD_WB_MUSCL_STEPS, dev, rmesh, world,
                              "none", eta, scheme="ssprk2",
                              second_order=True, **bs)
    sh = sim._sharded
    kernels.reset_launch_counts()
    sim.run()
    out["a2_launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    out["a2"] = run_state(sim)
    out["a2_rings"] = sh.plans[rank].rings
    q = sim._qs[u]
    sh.transport.exchange(u, q)
    op = sh.ops[u]
    out["a2_limited"] = [
        limited_cells(op, q, sim._bvs[u],
                      torch.tensor(k * DT_WB, dtype=q.dtype, device=dev),
                      sh.plans[rank].nown) for k in (1, 40)]
    if rank == 0:
        dt = torch.tensor(DT_WB, dtype=q.dtype, device=dev)
        out["rows"] += wb_kernel_rows(
            card, "unstructured sharded+bs2002+muscl", op, q, sim._bvs[u],
            dt, out["a2_launches"], {}, ranks=world, shard_cells=q.shape[1],
            launches_per_step={k: v / SHARD_WB_MUSCL_STEPS for k, v in
                               out["a2_launches"].items() if v})
    dist.barrier()
    del sim, q, op, rmesh

    # (b) phase 9's closed dam break under beuler
    mesh = dam_break_mesh()
    sim = Simulation(sharded_config(BEULER_STEPS, world,
                                    closed_dam_break_config),
                     mesh=mesh, device=dev)
    del mesh
    sh = sim._sharded
    u = sh.units[0]
    q0 = sim.get_solution().astype(np.float64)
    counts = dict(sh.counts)
    kernels.reset_launch_counts()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    out["b_wall_ms"] = 1e3 * (time.perf_counter() - t0) / BEULER_STEPS
    out["b_launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    out["b_collectives"] = {k: (sh.counts[k] - counts[k]) / BEULER_STEPS
                            for k in counts}
    out["b"] = run_state(sim)
    out["b_natural"] = sim.get_natural_ids()
    check_closed_box(sim, q0, sim.mesh.cell_area)
    q, bv = sim._qs[u], sim._bvs[u]
    dt = torch.tensor(DT_BEULER, dtype=q.dtype, device=dev)
    dist.barrier()
    out["b_split"] = sharded_beuler_split(card, sh, u, q, bv, dt)
    sh.transport.exchange(u, q)  # collective: every rank
    if rank == 0:
        rows = unstructured_rows(card, "unstructured sharded beuler",
                                 sh.ops[u], q, bv, dt, out["b_launches"],
                                 BEULER_STEP, {}, prim=False)
        for r in rows:
            r.update(ranks=world, shard_cells=q.shape[1])
        out["rows"] += rows
    dist.barrier()
    del sim, q, bv

    # (c) 13b's AMR run through the CLI in shards (partitioning: none)
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    out["c"] = amr_rank_run(argv)
    dist.barrier()
    return out


def phase_shards_16b(dev, mesh):
    """Phase 15: what the shards did not run before (ROADMAP item 16b), in
    RANKS gloo ranks sharing the one card: (a) BS2002, first order and
    with MUSCL, (b) beuler, (c) AMR through the CLI; the parent's
    one-process references. Returns rank 0's kernel rows."""
    import os
    import shutil
    import tempfile

    from rdycore_tpu_torch.mesh.core import rcm_reorder
    from rdycore_tpu_torch.parallel.comm import spawn

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    log(f"== phase 15: {RANKS} gloo ranks on one card: (a) BS2002 in shards "
        f"(phase 7's deck, first order and MUSCL), (b) beuler in shards "
        f"(phase 9's closed box), (c) AMR in shards through the CLI "
        f"(13b's run), f32")
    eta = dam_eta(H_WB_SUBMERGED)
    bs = dict(wb="bs2002", dt=DT_WB)
    refs = {}
    rwb = rcm_reorder(wb_mesh())
    ref = wb_rcm_simulation(10 + SHARD_WB_STEPS, dev, rwb, eta, **bs)
    ref.coupling_interval = 10 * DT_WB
    ref.advance()
    refs["a10"] = run_state(ref)
    ref.coupling_interval = SHARD_WB_STEPS * DT_WB
    one_ms = {"a": events_ms(ref.advance) / SHARD_WB_STEPS}
    ref = wb_rcm_simulation(SHARD_WB_MUSCL_STEPS, dev, rwb, eta,
                            scheme="ssprk2", second_order=True, **bs)
    ref.run()
    refs["a2"] = run_state(ref)
    del ref, rwb
    # 15b against phase 9b's step on one card (the mesh's own order)
    q_one, one_ms["b"] = REFERENCE["beuler"]
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "output", "chip_smoke_shards")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dam_break_npz(mesh, os.path.join(work, "dam_break.npz"))
    argv = amr_inputs(work, mesh, dev, RANKS)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "output")) as st:
        t0 = time.perf_counter()
        got = spawn(shards_16b_rank, RANKS, "gloo", st, args=(argv,),
                    timeout=RANK_TIMEOUT, device="cuda:0")
        t_ranks = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(os.path.join(root, "output", "chip_smoke_mesh"),
                  ignore_errors=True)
    amr_ref = REFERENCE.get("amr_events", [])
    bad = []
    for r in got:
        k = r["rank"]
        a_ok = all(v <= 1e-4 for v in r["a_err"].values())
        same = {key: same_run(r[key], refs[key]) for key in ("a10", "a2")}
        qb = np.empty_like(q_one)
        qb[:, r["b_natural"]] = r["b"][0]
        b_rel = float((np.abs(qb - q_one) / (1.0 + np.abs(q_one))).max())
        c = r["c"]
        c_same = [np.array_equal(ev["state"][0], want[0])
                  and ev["state"][1:] == want[1:]
                  for ev, want in zip(c["events"], amr_ref)]
        c_ok = (c["rc"] == 0 and len(c_same) == len(amr_ref) == 2
                and all(c_same) and c["transport"] == "DistTransport"
                and all(abs(ev["v_after"] - ev["v_before"]) / ev["v_before"]
                        <= 1e-6 for ev in c["events"]))
        log(f"  rank {k} 15a: {r['owned']:,} owned cells, {r['ghosts']:,} "
            f"ghosts of which {r['vertex_ghosts']:,} BS2002 vertex-ring "
            f"ghosts, {r['frontier']:,} frontier cells, neighbours "
            f"{r['neighbours']}; setup {r['a_setup_s']:.2f} s (mesh, RCM, "
            f"operator and partition on the host); 10 steps, kernels vs "
            f"plain (worst row) " + ", ".join(
                f"{n} {v:.3e}" for n, v in r["a_err"].items())
            + "; against one process on the RCM order (q, t, Courant "
            f"number and edge, boundary fluxes): "
            f"{'bit for bit' if same['a10'] else 'DIFFERENT'}")
        log(f"  [{card}] rank {k} 15a: {SHARD_WB_STEPS}-step interval "
            f"{r['a_ms']:.4f} ms/step between CUDA events "
            f"({r['a_wall_ms']:.4f} ms wall; one card on the same deck "
            f"{one_ms['a']:.4f}), peak device memory {r['a_peak_gb']:.3f} "
            f"GB, exchange {r['a_exchange_ms']:.4f} ms a stage; launches "
            f"{r['a_launches']}")
        log(f"  rank {k} 15a: {SHARD_WB_MUSCL_STEPS} BS2002 MUSCL ssprk2 "
            f"steps (rings {r['a2_rings']}) against one process on the RCM "
            f"order: {'bit for bit' if same['a2'] else 'DIFFERENT'}; owned "
            f"cells whose donor factor is below 1 at the end, over dt and "
            f"40 dt: {r['a2_limited']}; launches {r['a2_launches']}")
        sp = r["b_split"]
        log(f"  [{card}] rank {k} 15b: beuler, {BEULER_STEPS} step(s) "
            f"against phase 9b's on one card (by natural id): max |dq| / "
            f"(1 + |q|) {b_rel:.3e}; {r['b_wall_ms']:.1f} ms/step wall (one "
            f"card {one_ms['b']:.1f}); collectives a step {r['b_collectives']};"
            f" launches {r['b_launches']}; one more step split: "
            f"{json.dumps({k2: v for k2, v in sp.items()})}")
        log(f"  [{card}] rank {k} 15c: the CLI's AMR run in shards (rc "
            f"{c['rc']}, {c['transport']}) {c['seconds']:.1f} s; events "
            + "; ".join(
                f"{ev['cells']:,} cells, volume {ev['v_before']:.9e} -> "
                f"{ev['v_after']:.9e}, refine_marked {rs:.2f} s, rebuild "
                f"{rb:.2f} s, peak device memory {pk:.3f} GB"
                for ev, rs, (rb, pk) in zip(c["events"], c["refine_s"],
                                            c["rebuild"]))
            + f"; after each event against the one-process run (q, t, "
            f"step): {c_same}; launches {c['launches']}")
        check_launches(f"rank {k} 15a", r["a_launches"], {
            "swe_eta_vertex": SHARD_WB_STEPS,
            "swe_edge_flux": SHARD_WB_STEPS,
            "swe_cell_stage": SHARD_WB_STEPS,
            "courant_argmax": SHARD_WB_STEPS})
        n = SHARD_WB_MUSCL_STEPS
        check_launches(f"rank {k} 15a MUSCL", r["a2_launches"], dict(
            {key: 2 * n for key in ("swe_eta_vertex", "swe_muscl_grad",
                                    "swe_edge_flux", "swe_positivity_drain",
                                    "swe_positivity_scale",
                                    "swe_cell_stage")},
            courant_argmax=n))
        check_launches(f"rank {k} 15b", r["b_launches"],
                       {key: v * BEULER_STEPS
                        for key, v in BEULER_STEP.items()})
        check_launches(f"rank {k} 15c", c["launches"],
                       {key: AMR_STEPS for key in K1})
        if not (a_ok and all(same.values()) and b_rel <= 1e-4 and c_ok):
            bad.append(k)
    log(f"  phase 15: the ranks {t_ranks:.1f} s (spawn included), in all "
        f"{time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise SystemExit(f"phase 15 failed: ranks {bad}")
    return got[0]["rows"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 1
    import rdycore_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    errs = {}
    seconds = {}

    def timed(name, fn, *a):
        """fn(*a), its seconds kept under `name`."""
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("1", phase_build)
    dev = torch.device("cuda")
    timed("2", phase_kernels, args.seed, errs, dev)
    mesh = dam_break_mesh()
    # one row per kernel and path, each with that path's own launches
    rows = timed("3", phase_main, args.steps, errs, dev, mesh)
    rows += timed("4", phase_raster, args.steps, errs, dev, mesh)
    timed("5 kernels", phase_tracer_kernels, args.seed, errs, dev)
    rows += timed("5", phase_tracers, args.steps, errs, dev, mesh)
    timed("6 kernels", phase_muscl_kernels, args.seed, errs, dev)
    rows += timed("6", phase_muscl, args.steps, errs, dev, mesh)
    timed("7 kernels", phase_wb_kernels, args.seed, errs, dev)
    rows += timed("7", lambda: phase_wb(args.steps, errs, dev, wb_mesh()))
    rows += timed("8", phase_strips, args.steps, dev, mesh)
    rows += timed("9", phase_implicit, errs, dev, mesh)
    rows += timed("11", phase_coupler, errs, dev, mesh)
    rows += timed("12", phase_files, errs, dev, mesh)
    rows += timed("13", phase_ensemble_amr, errs, dev, mesh)
    rows += timed("14", phase_ranks, args.steps, dev, mesh)
    rows += timed("15", phase_shards_16b, dev, mesh)
    del mesh
    rows += timed("10", phase_mms, errs, dev)
    log(f"seconds by phase: {json.dumps(seconds)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
