"""Smoke run of pdebench_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, all at
once), holds each against its plain PyTorch version at the shapes of the
main paths (the stencil kernel's device time from a CUDA graph replay,
beside its callers' apply_grid_w time), then drives the main paths through
`OracleSolver(device="cuda")` and checks their errors against the
recorded values:

  Poisson     `poisson_basic` (P1, 121 x 121 lattice) and
              `poisson_p3_variable_kappa_mild` (P3, 241 x 241, 37 taps):
              the stencil kernel and the fused inner CG
  Helmholtz   `helmholtz_basic_k5` (121 x 121, k = 5) and
              `helmholtz_k12_exponential_mode` (161 x 161, k = 12): the
              stencil kernel, the fused Richardson preconditioner and the
              fused Arnoldi cycle
  Elasticity  `linear_elasticity_nu010` (P2, 121 x 121 nodes) and
              `linear_elasticity_nu030` (P2, 161 x 161): the stencil
              kernel's block form (the f64 outer residual, one launch per
              block apply) and the fused block inner CG
  3-D         `poisson_3d_smooth_trig` (P2, 33^3 lattice, 65 taps) and
              `poisson_3d_kappa_expr` (P2, 29^3): the fused inner CG;
              `helmholtz_3d_k1_trig` (P2, 33^3, k = 1): the fused Arnoldi
              cycle; the same case at mesh resolution 12 (25^3): the fused
              Richardson preconditioner; the stencil kernel on 3-D
              lattices (the f64 outer residual, and the f32 applies of the
              PyTorch GMRES)
  Navier-     `navier_stokes_low_re` (nu = 1, Stokes init) and
  Stokes      `navier_stokes_basic` (nu = 0.1, continuation), P2-P1 at
              resolution 48 (97 x 97 velocity nodes, 21,219 dofs): the
              whole-device Newton, its saddle FGMRES preconditioned by the
              fused dynamic-weight block V-cycle (97/49/25/13 hierarchy
              rebuilt from every Newton step's convected Jacobian), the
              saddle apply's velocity block on the stencil kernel's block
              form
  Heat        `heat_large_kappa_fast_diffusion` (P1 121^2, 20 steps) and
              `heat_3d_basic_decay` (P2 29^3, 20 steps): the fused inner
              CG at 12 PCG steps a round on the hierarchy of A = M + dt K,
              the stencil kernel (the f64 mass apply each step, the f64
              outer residual); `heat_basic` (P1 101^2, padded: the PyTorch
              V-cycle, the stencil kernel in every level)
  Biharmonic  `biharmonic_polynomial_zero_bc` (121^2: the fused inner CG,
              two solves a case) and `biharmonic_basic_sin` (141^2, padded)
  Convection- `convdiff_high_pe` (161^2, SUPG, steady) and
  diffusion   `convdiff_parabolic_basic_manufactured` (91^2, 5 steps): GMRES
              with the PyTorch V-cycle of the operator's own hierarchy, the
              stencil kernel in it and in the f64 residual and mass apply
  Reaction-   `reaction_diffusion_linear_basic` (P1 121^2, 50 steps: heat's
  diffusion   step loop, the fused inner CG at 12 PCG steps a round),
              `reaction_diffusion_cubic_manufactured` (P1 121^2, 40 steps)
              and `reaction_diffusion_allen_cahn_p2` (P2 181^2, 40 steps):
              a Newton solve a step, the Jacobian's per-step stencil
              weights from the bilinear weight map, GMRES(15) with the
              PyTorch V-cycle of the constant part's hierarchy; the
              stencil kernel in every apply (f32 step weights, their f64
              cast in the outer, the f64 mass and stiffness applies)
  Burgers     `burgers_square_v1` (P2 257^2, 10 steps): per-step
              advection weights, GMRES(20) with the PyTorch V-cycle, the
              stencil kernel in every apply
  Stokes      `stokes_basic` (P2-P1 129^2 velocity nodes, 37,507 dofs) and
              `stokes_p3p2_taylor_hood` (P3-P2 145^2, 51,459 dofs):
              MINRES-IR with the block-diagonal saddle preconditioner, the
              fused Richardson chain (2 V-cycles) per velocity component
              in every application, the stencil kernel's d = 2 block form
              in every lattice saddle apply (P2-P1); `stokes_3d_basic`
              (P2-P1 17^3, 15,468 dofs): MINRES-IR with the diagonal
              preconditioner, the stencil kernel's d = 3 block form in
              every saddle apply
  Wave        `wave_lshape_trig_cos` (P2, masked 177^2 lattice, 40 steps)
              and `wave_tjunc_cos2` (P2, masked non-square 105 x 161, 40
              steps): Newmark steps, the fused inner CG at 12 PCG steps a
              round on the masked hierarchy of A = M / dt^2 + c^2 K / 4,
              the stencil kernel (the f64 mass and stiffness applies each
              step, the f64 outer residual); `wave_lshape_exp_decay` (P2,
              masked 171^2, 60 steps: padded, the PyTorch V-cycle)
  Off the     `poisson_circle_sinsin` (distmesh circle, P2, 23,009 dofs:
  lattice     SA-AMG CG-IR), `poisson_star_5pt_sinsin` (17,911 dofs) and
              `poisson_periodic_trig` (periodic_square, 16,384 dofs):
              float64 Jacobi CG below the AMG gate;
              `biharmonic_circle_test_v1` (116,900 dofs: AMG, GMRES-IR, two
              solves), `helmholtz_square_square_hole` (P1, 44,501 dofs:
              AMG on the shifted Laplacian, FGMRES-IR) and
              `le_exp_multiconn_circle_hole` (34,864 dofs: rigid-body AMG,
              CG-IR); no kernel of the table runs there (the reference's
              route is XLA): the V-cycle (16a) is checked against its CPU
              twin and itself, bit for bit
  Cell-local  `wave_annulus_trig` (P2, 83,400 dofs: the step loop on the
  (17)        cell-local operators, CG-IR with a float32 SA-AMG V-cycle of
              the step matrix, built once) and `wave_multiconn_circ_trig`
              at resolution 48 (below the AMG gate: Jacobi CG-IR);
              `burgers_circle_v1` and the thin t_junction's
              `burgers_tjunction_v1` (each step's cell batch on the device,
              Jacobi GMRES(60)-IR), `rd_dumbbell_allencahn` (Newton, the
              Jacobian's cell batch), `rd_annulus_linear` (Jacobi CG-IR),
              `convdiff_periodic_square_highfreq_supg` (SA-AMG on the SPD
              surrogate, FGMRES-IR); (17b) Stokes with the saddle AMG (one SA-AMG
              V-cycle of the velocity block) on a signed-distance mesh, a
              masked l_shape lattice and unit_cube. No kernel of the table
              runs there; the two solves of a case give the same grid, bit
              for bit
  3-D elas-   `le_3d_basic` (P2, 21^3 nodes, 27,783 dofs) and
  ticity (18) `le_3d_multifreq_mms` (25^3, 46,875 dofs) on unit_cube block
              lattices: CG preconditioned by the PyTorch block V-cycle,
              every level apply and the f64 residual on the stencil
              kernel's d = 3 block form (18k: the form at 25^3 against its
              plain version); the two solves give the same grid, bit for bit
  Darcy (18b) the elliptic form on `poisson_basic`'s mesh and solution
              (the fused inner CG) and the mixed RT1 x DG1 form at res 16
              (the host LU)
  Hyper-      hyperelasticity (the stretch, Newton-CG on the autodiff
  elasticity, energy) and Cahn-Hilliard (mass conservation, Newton with a
  Cahn-       Jacobi GMRES a step) at the JAX package's test resolutions
  Hilliard    and at 64, the checks of its tests; no kernel of the table
  (18c)       runs there; two solves give the same grid, bit for bit
  Harness     `poisson_basic` through scripts/torch_run_benchmark.py's
  (19)        run_single_case: the oracle on the card (the stencil kernel
              and the fused inner CG), the mock agent serving the torch
              guide's quick-start in the sandbox on the card, the gates;
              then the oracle runner CLI in a process of its own on the
              same case, its grid against the harness run's
  Multi-      `poisson_p2` (P2, 201^2), `linear_elasticity_exponential_
  device      gradients` (P1 block, 151^2) and `poisson_3d_smooth_trig` (P2,
  (20)        33^3) at full size through dispatch's halo route
              (PDEBENCH_TPU_HALO=1) on 2 and 4 ranks sharing the card, one
              process each: every stripe apply one stencil kernel launch,
              the stripes against the whole-lattice launch bit for bit, the
              grids against the single-device solve's; the multi-device
              dry run's legs (parallel/dryrun.py) in the 4-rank launch
  Route       the reference's switches, each set for its path only:
  switches    `burgers_square_v1` (P2 257^2) under PDEBENCH_TPU_FUSED=
  (21)        arnoldi (kernel #6 is each round's whole Arnoldi cycle, the
              step's constrained float32 weights its operator), under
              PDEBENCH_TPU_STEP_RICH=1 (kernel #3 preconditions the GMRES)
              and under PDEBENCH_TPU_STEP_OUTER=cell (the exact float64
              cell batch as the outer: the case's record);
              `helmholtz_basic_k5` and the own-operator
              `convdiff_elliptic_medium_pe_diagonal_high_freq` (P1 161^2)
              under PDEBENCH_TPU_FUSED=arnoldi (kernel #6); `poisson_basic`
              under PDEBENCH_TPU_WARM_REPEATS=3 (the fastest of 3 warm
              passes); 21a holds the new callers' kernels against their
              plain versions at those shapes

Each path runs with the launch counters set to 0 just before it and read
just after; a kernel of the path that never launched fails the run. One
line per phase; any failure raises and exits non-zero. The last lines are
the card's name and power limit, a JSON object with per-kernel launches,
errors, times and bounds, and the contract line {"ok": true, "device": ...}.

Needs a CUDA device, nvcc (CUDA_HOME or /usr/local/cuda) and the
repository checkout around this file; imports neither jax nor
pdebench_tpu.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
POISSON = {
    # case id -> (recorded baseline_error, relative tolerance, outer
    # rounds of 25 fused PCG steps the solve takes to reach rtol 1e-10).
    # poisson_basic takes 3: its second round leaves the residual just
    # above the tolerance (8.22e-12) in the float32 sums of the plain
    # version. Witness (scripts/torch_ir_rounds.py poisson_basic, on the
    # card, one fixed load vector; PERF.md §6): the plain version's
    # second round leaves 1.28e-11, the kernel's 1.70e-11 (the kernel
    # rounds each tap product as the plain version does); fused
    # multiply-adds in every tap sum reach 7.77e-12 and 2 rounds
    "poisson_basic": (1.924806820736457e-4, 1e-6, 3),
    "poisson_p3_variable_kappa_mild": (3.75760311692739e-9, 1e-5, 3),
}
HELMHOLTZ = {
    # case id -> (recorded baseline_error, relative tolerance, inner on
    # the card, outer rounds of one GMRES(30) cycle each)
    "helmholtz_basic_k5": (6.517975839100497e-4, 1e-6, "gmres+fused-richardson-cuda", 4),
    "helmholtz_k12_exponential_mode": (3.1268822007046e-4, 1e-6, "fused-gmres-cuda", 3),
}
ELASTICITY = {
    # case id -> (recorded baseline_error, relative tolerance, outer
    # rounds of 25 fused block PCG steps to rtol 1e-10)
    "linear_elasticity_nu010": (1.5773824748707618e-06, 1e-6, 2),
    "linear_elasticity_nu030": (3.2893239815322345e-06, 1e-6, 3),
}
# 3-D lattices: case id -> (baseline_error, relative tolerance, inner on
# the card, outer rounds, steps per round). The errors are the recorded
# ones, except for "helmholtz_3d_k1_trig@12": that case at mesh resolution
# 12 (15,625 dofs, between the 8,000 of the shifted-Laplacian hierarchy
# and the 20,000 of the whole fused Arnoldi cycle, where no dataset case
# sits), held to the reference's CPU run of the same configuration on its
# lattice route (PDEBENCH_TPU_FORCE_STENCIL=1; tests/test_torch_lattice3d.py
# checks the number). The load vectors sum in a fixed order
# (ScalarContext.load_vector), so every solve of a case sees the same
# right-hand side and takes the same rounds.
LATTICE_3D = {
    "poisson_3d_smooth_trig": (2.4147996840258627e-4, 1e-6, "fused-cg-cuda", 2, 25),
    "poisson_3d_kappa_expr": (3.7355568479364103e-4, 1e-6, "fused-cg-cuda", 2, 25),
    "helmholtz_3d_k1_trig": (2.416098792334167e-4, 1e-6, "fused-gmres-cuda", 2, 30),
    "helmholtz_3d_k1_trig@12": (1.4542538224140384e-4, 1e-6, "gmres+fused-richardson-cuda", 2, 30),
}
# Navier-Stokes: case id -> (recorded baseline_error, relative
# tolerance). A Newton stop at rtol 1e-10 may move the solution by ~1e-10,
# an error of ~3e-6 by up to ~3e-5 relative; the card reads 4.99e-10 and
# 2.62e-8 on every solve (its sums run in a fixed order), so 1e-6 holds
# with a margin of 38 over the larger
NAVIER_STOKES = {
    "navier_stokes_low_re": (3.041429902434237e-06, 1e-6),
    "navier_stokes_basic": (3.0425996199305986e-06, 1e-6),
}
# Heat, biharmonic and convection-diffusion: case id -> (recorded
# baseline_error, relative tolerance, inner on the card). Their outer
# rounds (per step in a step loop) are printed and must be the same on
# every solve of a case: the load vectors and the mass apply sum in a
# fixed order
HEAT_2D = {
    "heat_large_kappa_fast_diffusion": (4.25500140632074e-4, 1e-6, "fused-cg-cuda"),
    "heat_basic": (1.3235693420538648e-4, 1e-6, "stencil-cg"),
}
HEAT_3D = {"heat_3d_basic_decay": (3.6806817825953483e-4, 1e-6, "fused-cg-cuda")}
BIHARMONIC = {
    "biharmonic_polynomial_zero_bc": (2.4851356778642905e-4, 1e-6, "fused-cg-cuda"),
    "biharmonic_basic_sin": (2.6046594462895913e-4, 1e-6, "stencil-cg"),
}
CONVDIFF = {
    "convdiff_high_pe": (5.438225968157223e-5, 1e-6, "gmres+vcycle"),
    "convdiff_parabolic_basic_manufactured": (7.050554387484011e-4, 1e-6, "gmres+vcycle"),
}
# Reaction-diffusion and Burgers: case id -> (recorded baseline_error,
# relative tolerance, inner on the card). Per step, the outer rounds (a
# linear reaction) or the Newton and linear iterations must be the same
# on every solve of a case: the step weights, loads and applies sum in a
# fixed order
REACTION_DIFFUSION = {
    "reaction_diffusion_linear_basic": (0.0011817187220116857, 1e-6, "fused-cg-cuda"),
    "reaction_diffusion_cubic_manufactured": (0.00015643892527901734, 1e-6, "gmres+vcycle"),
    "reaction_diffusion_allen_cahn_p2": (0.0004699686748745913, 1e-6, "gmres+vcycle"),
}
# burgers_square_v1 is held to the JAX package's CPU run of the case as it
# solves it today, 0.0019299427200282846 (`scripts/transient_record_check.py
# --cell-outer burgers_square_v1`): its record, 0.0019275595522773154, was
# written while the package's per-step outer was the exact cell-based f64
# apply, which that script's second solve reproduces to 2.2e-7; today's
# outer (and the port's) applies the float32 step weights cast to f64, and
# converges to that operator (PERF.md §6, the reaction-diffusion and Burgers findings)
BURGERS = {"burgers_square_v1": (0.0019299427200282846, 1e-6, "gmres+vcycle")}
# Stokes: case id -> (recorded baseline_error, relative tolerance, inner
# on the card). MINRES-IR stops at rtol 1e-10 of the saddle residual; the
# MINRES iterations must be the same on every solve of a case (every sum
# of the solve runs in a fixed order). stokes_p3p2_taylor_hood's error,
# 2.28e-8, is so small that where MINRES stops moves it by 1e-4: the exact
# discrete solution (the host LU) gives 2.2814588133063066e-08, 8.9e-5 from
# the record, and the JAX package's own CPU run of the case
# 2.282309096721528e-08, 2.8e-4 from it (PERF.md §6, PR 12); 1e-4 holds
# the card to the record as closely as the record holds to the exact answer
STOKES_2D = {
    "stokes_basic": (1.2921167378456228e-06, 1e-5, "minres+fused-richardson-cuda"),
    "stokes_p3p2_taylor_hood": (2.281664383347875e-08, 1e-4, "minres+fused-richardson-cuda"),
}
STOKES_3D = {"stokes_3d_basic": (0.0012933509802431167, 1e-5, "minres+diag")}
# Wave on masked lattices: case id -> (recorded baseline_error, relative
# tolerance, inner on the card). The l_shape cases' P2 lattices are 177^2
# (trig_cos: unpadded, kernel #2) and 171^2 (exp_decay: padded, the
# PyTorch V-cycle); wave_tjunc_cos2's is the non-square 105 x 161, unpadded.
# Per step, the outer rounds must be the same on every solve of a case
WAVE_LSHAPE = {
    "wave_lshape_trig_cos": (0.0014678201154129035, 1e-6, "fused-cg-cuda"),
    "wave_lshape_exp_decay": (0.0005927714535132296, 1e-6, "stencil-cg"),
}
WAVE_TJUNC = {"wave_tjunc_cos2": (0.0017096777485136867, 1e-6, "fused-cg-cuda")}
# The route off the lattice (signed-distance and periodic meshes): case id
# -> (recorded baseline_error, relative tolerance, inner on the card). No
# kernel runs there: SA-AMG's V-cycle and the cell-local operator are
# PyTorch ops, every sum in a fixed order, so the iterations must be the
# same on every solve of a case. helmholtz_square_square_hole's record is
# the JAX package's host LU (its CPU branch below 80,000 dofs); the card
# answers it with AMG-FGMRES-IR on the shifted Laplacian
OFF_LATTICE = {
    "poisson_circle_sinsin": (6.804050372901661e-07, 1e-5, "amg-cg-ir"),
    "poisson_star_5pt_sinsin": (9.398797001236839e-07, 1e-5, "jacobi-cg"),
    "poisson_periodic_trig": (1.7207050610398467e-05, 1e-5, "jacobi-cg"),
    "biharmonic_circle_test_v1": (4.98519719553631e-08, 1e-5, "amg-gmres-ir"),
    "helmholtz_square_square_hole": (4.303553589698658e-05, 1e-5, "amg-gmres-ir"),
    "le_exp_multiconn_circle_hole": (3.5360035049831796e-06, 1e-5, "amg-cg-ir"),
}
# The cell-local step loops and the last SA-AMG preconditioners (phase
# 17, off the lattice): case id -> (recorded baseline_error, relative
# tolerance, inner on the card). Their records were written by the JAX
# package on another machine's distmesh output; RECORD_TOL_MESH covers
# what that alone moves (PERF.md §6: up to 7e-5). Wave on AMG-CG-IR
# from 20,000 dofs on (wave_annulus_trig, 83,400 dofs); below, Jacobi
# CG-IR: no dataset wave case off the lattice has fewer than 20,000 dofs,
# so wave_multiconn_circ_trig at mesh resolution 48 (~9,000 dofs), held to
# the JAX package's CPU run of that configuration,
# 0.0003145111997973872 (`scripts/transient_record_check.py --today
# --resolution 48 wave_multiconn_circ_trig`: its host LU, the exact
# discrete answer the card's refinement approaches to rtol 1e-10). Two of
# the cases first named for this phase took most of its time, mostly in
# host meshing (on an H100, PERF.md §6: rd_circle_allencahn 59.6 s and
# convdiff_annulus_diag_supg 123.2 s for 2 solves, 25 s and 41-43 s of
# t_setup a solve): the same routes run here on rd_dumbbell_allencahn
# (6,728 dofs) and convdiff_periodic_square_highfreq_supg (102,400 dofs
# on periodic_square, which no mesher has to fill)
RECORD_TOL_MESH = 1e-4
CELL_LOCAL = {
    "wave_annulus_trig": (0.001530442978718416, RECORD_TOL_MESH, "amg-cg-ir"),
    "wave_multiconn_circ_trig@48": (0.0003145111997973872, 1e-5, "jacobi-cg-ir"),
    "burgers_circle_v1": (0.0016821368533185108, RECORD_TOL_MESH, "jacobi-gmres-ir"),
    "rd_dumbbell_allencahn": (0.00030446930124667043, RECORD_TOL_MESH, "jacobi-gmres-ir"),
    "rd_annulus_linear": (0.00028702038340679386, RECORD_TOL_MESH, "jacobi-cg-ir"),
    # the thin t_junction: rectilinear, but under 40% of its box, so no
    # lattice. Held to the JAX package's CPU run of the case today,
    # 0.0004959819577386328 (`scripts/transient_record_check.py --today
    # burgers_tjunction_v1`): its record, 0.0004960251368039803, sits
    # 8.7e-5 from both packages (on an H100, PERF.md §6: the card 5.2e-8 from
    # today's reference), a stale record on an exact rectilinear mesh
    "burgers_tjunction_v1": (0.0004959819577386328, 1e-6, "jacobi-gmres-ir"),
    # SA-AMG on the SPD surrogate eps K + SUPG(eps = 0), FGMRES-IR
    "convdiff_periodic_square_highfreq_supg": (0.00017900894652586634, RECORD_TOL_MESH,
                                               "amg-gmres-ir"),
}
# Stokes off the GMG preconditioner at 20,000 dofs and more: MINRES-IR with
# one SA-AMG V-cycle of the velocity block, one case of each group (a
# signed-distance mesh, whose no-exact re-solve at resolution 128 takes
# the same route; a masked lattice; unit_cube)
STOKES_AMG = {
    "stokes_exp_multi_connected_off_center_source": (0.0006628130965917609, RECORD_TOL_MESH,
                                                     "minres+amg"),
    "stokes_exp_lshape_trifreq_flow": (7.086023784365608e-06, 1e-5, "minres+amg"),
    "stokes_3d_multifreq": (0.1929079144510536, 1e-5, "minres+amg"),
}
# 3-D elasticity on unit_cube block lattices (phase 18): case id ->
# (recorded baseline_error, relative tolerance, inner on the card, pc_used).
# le_3d_basic is 21^3 P2 nodes (27,783 dofs, hierarchy 21^3 -> 11^3 -> 6^3
# coarse), le_3d_multifreq_mms 25^3 (46,875 dofs, the largest 3-D
# elasticity case: 25^3 -> 13^3 -> 7^3 -> 4^3): CG preconditioned by the
# PyTorch block V-cycle, every level apply and the f64 residual one launch
# of the stencil kernel's d = 3 block form
LE_3D = {
    "le_3d_basic": (0.0010009789573300774, 1e-6, "stencil-cg", "gmg+stencil-ir32"),
    "le_3d_multifreq_mms": (0.001278049716574264, 1e-6, "stencil-cg", "gmg+stencil-ir32"),
}
# Darcy (phase 18b): the elliptic form on poisson_basic's mesh (unit_square
# res 120, P1, 14,641 dofs) with its kappa and its manufactured solution as
# p: Poisson's problem, so poisson_basic's record, and kernel #2 as its inner;
# the mixed RT1 x DG1 form at res 16 on the host LU, held to the JAX
# package's CPU run of that configuration (the reference's
# tests/test_mixed_pdes.py::test_darcy_rt1_convergence_order at res 16)
DARCY = {
    "darcy:poisson_basic": (1.924806820736457e-4, 1e-6, "fused-cg-cuda"),
    "darcy:rt1@16": (0.0034248804530593066, 1e-6, "host-lu"),
}
# The multi-device module (phase 20): case id -> the kernels line's entry
# of the stencil kernel on its stripes. Full dataset size: poisson_p2 (res
# 100 P2, a 201^2 lattice, 40,401 dofs), linear_elasticity_exponential_
# gradients (res 150 P1, 151^2 x 2, 45,602 dofs), poisson_3d_smooth_trig
# (res 16 P2, 33^3, 35,937 dofs), through dispatch's halo route on 2 and 4
# ranks sharing the card (gloo, every row and scalar through pinned host
# buffers: NCCL refuses two ranks on one device). The grid is held to the
# single-device grid by parallel/dryrun.check_halo_route
HALO = {
    "poisson_p2": "stencil_apply_2d_halo",
    "linear_elasticity_exponential_gradients": "stencil_apply_block_2d_halo",
    "poisson_3d_smooth_trig": "stencil_apply_3d_halo",
}
HALO_RANKS = (2, 4)
# The reference's route switches (phase 21): phase -> (the switches, case
# id -> (baseline_error, relative tolerance, inner on the card), the
# step_outer a per-step case reports, the kernels-line entries and the
# counters they read). burgers_square_v1's hierarchy 257 -> 129 -> 65 ->
# 33 -> 17 is unpadded; on the fused routes it is held to today's JAX run
# as phase 13 is, under the cell outer to its record, which the JAX
# package wrote on that outer. convdiff_elliptic_medium_pe_diagonal_high_
# freq (P1 161^2, eps 0.05, beta (3, 3), no SUPG) is an own-operator
# hierarchy on which the whole fused cycle converges; on the SUPG and P2
# cases the fused cycle's 2-V-cycle preconditioner stalls (PERF.md §6), as
# the reference found on its TPU
BURGERS_TODAY = BURGERS["burgers_square_v1"][0]
SWITCHES = (
    ("21", {"PDEBENCH_TPU_FUSED": "arnoldi"},
     {"burgers_square_v1": (BURGERS_TODAY, 1e-6, "fused-gmres-step-cuda")}, "stencil",
     {"gmg_fused_gmres_step": "gmg_fused_gmres", "stencil_apply_2d_step": "stencil_apply"}),
    ("21b", {"PDEBENCH_TPU_STEP_RICH": "1"},
     {"burgers_square_v1": (BURGERS_TODAY, 1e-6, "gmres+fused-richardson-step-cuda")}, "stencil",
     {"gmg_fused_richardson_step": "gmg_fused_richardson", "stencil_apply_2d_step": "stencil_apply"}),
    ("21c", {"PDEBENCH_TPU_STEP_OUTER": "cell"},
     {"burgers_square_v1": (0.0019275595522773154, 1e-6, "gmres+vcycle")}, "cell",
     {"stencil_apply_2d_step": "stencil_apply"}),
    ("21d", {"PDEBENCH_TPU_FUSED": "arnoldi"},
     {"helmholtz_basic_k5": (6.517975839100497e-4, 1e-6, "fused-gmres-cuda")}, None,
     {"gmg_fused_gmres_k5": "gmg_fused_gmres", "stencil_apply_2d": "stencil_apply"}),
    ("21e", {"PDEBENCH_TPU_FUSED": "arnoldi"},
     {"convdiff_elliptic_medium_pe_diagonal_high_freq": (0.0005868791058644835, 1e-6, "fused-gmres-cuda")},
     None, {"gmg_fused_gmres_own": "gmg_fused_gmres", "stencil_apply_2d": "stencil_apply"}),
)
OWN_OPERATOR = "convdiff_elliptic_medium_pe_diagonal_high_freq"
# the best of this many warm passes (PDEBENCH_TPU_WARM_REPEATS, phase 21f)
WARM_REPEATS = 3
# the inner routes that launch no kernel of the table: off the lattice and
# the host LU
OFF_LATTICE_ROUTES = ("amg-", "jacobi-", "host-")
# whole-case solves per case on each main path: two hold a case's counts
# equal from solve to solve and keep the script's wall time near ~400 s
SOLVES = 2
TOL_F64 = 1e-12  # stencil kernel vs plain, max |diff| / max |plain|
TOL_F32 = 1e-5
# fused inner CG vs plain: f32 sums in another order through 25 PCG
# steps (the tolerance tests/test_gmg_fused.py holds the Pallas kernel to)
TOL_CG = 2e-4
# one PCG step (z = alpha V(r)), a Richardson chain of 1 or 2 V-cycles,
# one Arnoldi step (V, H, beta): f32 sums in another order through one or
# two V-cycles, where a fault in the V-cycle shows at full size
TOL_VCYCLE = 1e-5
# linearity of the Richardson chain (tests/test_gmg_fused.py)
TOL_LINEAR = 2e-4
# the whole Arnoldi cycle: float MGS in another order parts the two
# recurrences after a few steps, so the cycle is held by its residual
# against the true operator: below RESID_MAX and within RESID_RATIO of
# the plain version's
RESID_MAX = 0.1
RESID_RATIO = 2.0
# residuals below this are float32 Gram-Schmidt rounding, where no ratio
# holds: the ratio is taken to the larger. Witness
# (scripts/torch_gmres_floor.py; PERF.md §7): at k = 1 in 3-D, M A is close
# to the identity, and the kernel's and the plain version's float32
# recurrences both lose orthogonality within ~7 steps and stall at ~1e-6
# while the float64 one goes on to 1e-15; their Arnoldi relations hold to
# the same ~5e-7, and which stalls lower is rounding (kernel over plain
# 0.5x to 2.9x measured)
RESID_FLOOR = 1e-5
ARNOLDI_STEPS = 30

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 and float64 outside the
# tensor cores
HBM_BYTES_S = 3.35e12
FLOPS_S = {torch.float32: 67e12, torch.float64: 34e12}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn, calls: int = 20, samples: int = 5) -> float:
    """CUDA-event time per call: `calls` back-to-back calls between two
    events, median over `samples` such runs, after one warm-up call. For
    a launch-bound kernel this is the host's per-call cost."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# -- bounds: the least time the card could take for the same work ---------


def bound(nbytes: float, flops: float, dtype) -> dict:
    """max(bytes / HBM rate, flops / peak rate) in ms, and which bounds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FLOPS_S[dtype]
    return dict(
        bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


def _taps_flops(K: int, n: int) -> int:
    return 2 * K * n  # one multiply and one add per tap and point


def vcycle_flops(fused) -> int:
    """Operations of one V-cycle on a fused hierarchy: per level, x = D r,
    r - A x, restriction (9 taps per coarse point, 27 in 3-D),
    prolongation and its add (at most 4 taps per fine point, 8 in 3-D),
    post-smoothing x + D (r - A x); on the coarsest level, x = D r and
    COARSE_SWEEPS - 1 Jacobi sweeps."""
    from pdebench_tpu_torch.solvers.gmg_fused import COARSE_SWEEPS

    total = 0
    dim = len(fused.shape)
    shapes = [(W.shape[0], W[0].numel()) for W in fused.W]
    for (K, n), (_, nc) in zip(shapes[:-1], shapes[1:]):
        total += n + (_taps_flops(K, n) + n) + 2 * 3**dim * nc + (2 * 2**dim * n + n)
        total += _taps_flops(K, n) + 3 * n
    K, n = shapes[-1]
    return total + n + (COARSE_SWEEPS - 1) * (_taps_flops(K, n) + 3 * n)


def hierarchy_bytes(fused) -> int:
    return sum(W.numel() * 4 + D.numel() * 4 for W, D in zip(fused.W, fused.D))


def chain_flops(fused, cycles: int) -> int:
    K0, n0 = fused.W[0].shape[0], fused.sites
    return cycles * vcycle_flops(fused) + (cycles - 1) * (_taps_flops(K0, n0) + 2 * n0)


def cg_bound(fused) -> dict:
    K0, n0 = fused.W[0].shape[0], fused.sites
    step = _taps_flops(K0, n0) + 4 * n0 + 6 * n0 + vcycle_flops(fused)
    flops = vcycle_flops(fused) + 2 * n0 + fused.inner_iters * step
    return bound(hierarchy_bytes(fused) + 2 * 4 * n0, flops, torch.float32)


def block_vcycle_flops(fused) -> int:
    """Operations of one block (d = 2) V-cycle: as vcycle_flops with 8 per
    tap and site for a 2 x 2 block apply, 6 per site for a 2 x 2 D
    product and the transfers and updates on both components."""
    from pdebench_tpu_torch.solvers.gmg_fused import COARSE_SWEEPS

    shapes = [(W.shape[0], W.shape[-2] * W.shape[-1]) for W in fused.W]
    total = 6 * shapes[0][1]  # x = D r on level 0
    for (K, n), (_, nc) in zip(shapes[:-1], shapes[1:]):
        # r - A x, restriction and x_c = D r_c, prolongation and its add,
        # post-smoothing x + D (r - A x)
        total += (8 * K * n + 2 * n) + 2 * (2 * 9 * nc) + 6 * nc + 2 * (2 * 4 * n + n)
        total += 8 * K * n + 10 * n
    K, n = shapes[-1]
    return total + (COARSE_SWEEPS - 1) * (8 * K * n + 10 * n)


def block_cg_bound(fused) -> dict:
    """r read and z written once (two components), the hierarchy read
    once; per PCG step the block apply, two dots, the updates and a block
    V-cycle."""
    K0, n0 = fused.W[0].shape[0], fused.shape[0] * fused.shape[1]
    v = block_vcycle_flops(fused)
    step = 8 * K0 * n0 + 4 * n0 + 8 * n0 + v + 4 * n0 + 4 * n0
    flops = v + 4 * n0 + fused.inner_iters * step
    return bound(hierarchy_bytes(fused) + 2 * 2 * 4 * n0, flops, torch.float32)


def dyn_block_bound(lv, cycles: int) -> dict:
    """Kernel #5 on levels lv [(W, D)]: every level's W and D read once, r
    read and z written once (two components); operations of `cycles`
    block V-cycles on those levels and the fine-level residual and update
    between cycles."""
    from types import SimpleNamespace

    W0 = lv[0][0]
    K0, n0 = W0.shape[0], W0.shape[-2] * W0.shape[-1]
    v = block_vcycle_flops(SimpleNamespace(W=[W for W, _ in lv]))
    flops = cycles * v + (cycles - 1) * (8 * K0 * n0 + 4 * n0)
    nbytes = sum(W.numel() * 4 + D.numel() * 4 for W, D in lv) + 2 * 2 * 4 * n0
    return bound(nbytes, flops, torch.float32)


def richardson_bound(fused) -> dict:
    n0 = fused.sites
    return bound(hierarchy_bytes(fused) + 2 * 4 * n0, chain_flops(fused, fused.inner_iters), torch.float32)


def gmres_bound(fg) -> dict:
    """Inputs r, W_op and the hierarchy read once; outputs V, H, beta
    written once. Operations: the preconditioned r, then per step j the
    operator apply, the preconditioner, j + 1 Gram-Schmidt terms (a dot
    and an axpy each), two norms and the scaling of V[j+1]."""
    from pdebench_tpu_torch.solvers.gmg_fused import PRECOND_CYCLES

    m, n0, Kop = fg.m, fg.sites, len(fg.op_offsets)
    precond = chain_flops(fg, PRECOND_CYCLES)
    flops = precond + 3 * n0
    for j in range(m):
        flops += _taps_flops(Kop, n0) + precond + n0 + (j + 1) * 4 * n0 + 4 * n0 + 2 * n0
    nbytes = hierarchy_bytes(fg) + 4 * n0 * (1 + Kop + m + 1) + 4 * (m * (m + 1) + 1)
    return bound(nbytes, flops, torch.float32)


# -- the cases' operators --------------------------------------------------


def load_cases(ids):
    """Configs by id; "<case>@<n>" is the case at mesh resolution n."""
    cases = {}
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        for line in fh:
            c = json.loads(line)
            cases[c["id"]] = c["oracle_config"]
    out = {}
    for key in ids:
        cid, _, res = key.partition("@")
        out[key] = copy.deepcopy(cases[cid])
        if res:
            out[key]["mesh"]["resolution"] = int(res)
    return out


def darcy_cases(cases):
    """The configurations of DARCY: poisson_basic's with the pde replaced
    by Darcy's elliptic form (its kappa, its manufactured solution as p),
    and the mixed RT1 x DG1 form at res 16."""
    pb = copy.deepcopy(cases["poisson_basic"])
    pde = pb["pde"]
    pb["pde"] = {"type": "darcy", "coefficients": copy.deepcopy(pde.get("coefficients", {})),
                 "manufactured_solution": {"p": pde["manufactured_solution"]["u"]}}
    rt1 = {
        "pde": {"type": "darcy", "formulation": "mixed",
                "coefficients": {"kappa": {"type": "constant", "value": 1.0}},
                "manufactured_solution": {"p": "sin(pi*x)*sin(pi*y)"}},
        "domain": {"type": "unit_square"},
        "mesh": {"resolution": 16},
        "fem": {"family": "RT", "degree_u": 2, "degree_p": 1},
        "bc": {},
        "output": {"grid": {"bbox": [0, 1, 0, 1], "nx": 40, "ny": 40}},
        "oracle_solver": {"ksp_type": "preonly", "pc_type": "lu"},
    }
    return {"darcy:poisson_basic": pb, "darcy:rt1@16": rt1}


def poisson_operator(config, device):
    """The case's f32 lattice operator with its GMG hierarchy attached,
    built through the port's setup path."""
    from pdebench_tpu_torch.fem.assemble import local_stiffness
    from pdebench_tpu_torch.oracle import base, scalar
    from pdebench_tpu_torch.solvers.gmg import attach_lattice_gmg

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, pde["manufactured_solution"]["u"])
    ctx = scalar.setup_scalar(config, device)
    kappa = base.coefficient_fn(pde["coefficients"]["kappa"], ctx.dim, device)
    lat = scalar.maybe_lattice32(ctx, local_stiffness(ctx.cb, kappa(ctx.qpts())))
    mask = ctx.mask.cpu().numpy()
    attach_lattice_gmg(lat, mask)
    return lat, mask


def helmholtz_operator(config, device):
    """The case's f32 lattice operator K - k^2 M with its shifted-
    Laplacian hierarchy, the lattice mask and the true constrained
    weights, built through the port's setup path."""
    from pdebench_tpu_torch.fem.assemble import local_mass, local_stiffness
    from pdebench_tpu_torch.oracle import helmholtz, scalar
    from pdebench_tpu_torch.solvers.gmg import attach_lattice_gmg
    from pdebench_tpu_torch.solvers.stencil import constrain_step_weights

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, pde["manufactured_solution"]["u"])
    k2 = float(pde["pde_params"]["k"]) ** 2
    ctx = scalar.setup_scalar(config, device)
    lat = scalar.maybe_lattice32(ctx, local_stiffness(ctx.cb) - k2 * local_mass(ctx.cb))
    mask = ctx.mask.cpu().numpy()
    attach_lattice_gmg(lat, mask, A_override=helmholtz.shifted_laplacian(ctx, k2))
    keep = torch.as_tensor(
        1.0 - lat.lattice.embed_np(mask, True).astype(np.float32), device=device
    ).reshape(lat.shape)
    return lat, mask, constrain_step_weights(lat.W, lat.offsets, keep)


def elasticity_operator(config, device, rough=False):
    """The case's f32 block lattice operator with its block GMG
    hierarchy attached, built through the port's setup path. `rough`
    multiplies the shear modulus by a cell-wise factor between 1/2 and 2
    (from a seed): with constant Lame parameters every per-site 2 x 2 tap
    block is symmetric, so only a rough one shows a transposed block
    read."""
    from pdebench_tpu_torch.fem.assemble import local_elasticity
    from pdebench_tpu_torch.oracle import linear_elasticity, scalar
    from pdebench_tpu_torch.solvers.gmg import attach_lattice_gmg

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, list(pde["manufactured_solution"]["u"]))
    lam, mu = linear_elasticity.lame_from_params(pde["pde_params"])
    ctx = scalar.setup_scalar(config, device, ncomp=-1)
    if rough:
        n = ctx.mesh.n_cells
        mu = mu * np.exp(np.random.default_rng(1).uniform(np.log(0.5), np.log(2.0), n))
    lat = scalar.maybe_block_lattice32(ctx, local_elasticity(ctx.cb, mu, lam))
    mask = ctx.mask.cpu().numpy()
    attach_lattice_gmg(lat, mask)
    return lat, mask


def heat_operator(config, device):
    """A heat case's step operators as its oracle builds them: the f32
    lattice of A = M + dt K with its GMG hierarchy, the lattice mask, and
    its mass weight map with the f64 mass weights, as a lattice operator
    for stencil_line."""
    from types import SimpleNamespace

    from pdebench_tpu_torch.oracle import base, heat, scalar
    from pdebench_tpu_torch.solvers.stencil import lattice_weight_map

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, pde["manufactured_solution"]["u"])
    ctx = scalar.setup_scalar(config, device)
    A, M = heat.step_matrices(ctx, pde, base.time_params(pde)[2])
    lat, _, _, _, _ = heat.step_operators(ctx, A, (M,), "cg", heat.INNER_ITERS)
    wm = lattice_weight_map(lat.lattice, ctx.space.dofmap_scalar)
    mass = SimpleNamespace(shape=wm.shape, offsets=wm.offsets, pad=wm.pad, plan=wm.plan,
                           apply_grid_w=wm.apply_grid)
    W64 = torch.as_tensor(wm.weights_np(M), device=device)
    return lat, ctx.mask.cpu().numpy(), (mass, W64)


def rd_operator(config, device):
    """A linear reaction-diffusion case's step lattice as its oracle
    builds it (A = M / dt + eps K + alpha M with its hierarchy) and the
    lattice mask."""
    from pdebench_tpu_torch.oracle import heat, reaction_diffusion as rd, scalar
    from pdebench_tpu_torch.oracle.convection_diffusion import transient_time

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, pde["manufactured_solution"]["u"])
    ctx = scalar.setup_scalar(config, device)
    params = pde["pde_params"]
    R_sym, _ = rd.reaction_expr(params["reaction"])
    dt = transient_time(pde["time"])[2]
    A, _, M, _ = rd.step_matrices(ctx.cb, dt, float(params.get("epsilon", 1.0)), R_sym)
    lat, _, _, _, _ = heat.step_operators(ctx, A, (M,), "cg", heat.INNER_ITERS)
    return lat, ctx.mask.cpu().numpy()


def wave_operator(config, device):
    """A wave case's step operators as its oracle builds them: the f32
    lattice of A = M / dt^2 + c^2 K / 4 with its GMG hierarchy (on a
    masked lattice), the lattice mask, and the weight map of its f64 mass
    and stiffness applies as a lattice operator for stencil_line, with
    both weight sets."""
    from types import SimpleNamespace

    from pdebench_tpu_torch.fem.assemble import local_mass, local_stiffness
    from pdebench_tpu_torch.oracle import base, heat, scalar, wave
    from pdebench_tpu_torch.solvers.stencil import lattice_weight_map

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, pde["manufactured_solution"]["u"])
    ctx = scalar.setup_scalar(config, device)
    dt = base.time_params(pde)[2]
    c2 = float(pde.get("pde_params", {}).get("c", 1.0)) ** 2
    M, K = local_mass(ctx.cb), local_stiffness(ctx.cb)
    A = M / (dt * dt) + wave.THETA * c2 * K
    lat, _, _, _, _ = heat.step_operators(ctx, A, (M, K), "cg", heat.INNER_ITERS)
    wm = lattice_weight_map(lat.lattice, ctx.space.dofmap_scalar)
    wlat = SimpleNamespace(shape=wm.shape, offsets=wm.offsets, pad=wm.pad, plan=wm.plan,
                           apply_grid_w=wm.apply_grid)
    Ws = [torch.as_tensor(wm.weights_np(a), device=device) for a in (M, K)]
    return lat, ctx.mask.cpu().numpy(), (wlat, Ws)


def step_weight_operator(config, device):
    """A per-step operator's pieces as its oracle builds them, at the
    case's first step: burgers_square_v1's advection weights W_c + W(u0)
    or a nonlinear reaction's Jacobian weights W_c + W(R'(u0)). Returns
    the weight map, the bilinear map, its device stack, W_c (float32)
    and the lattice-shaped float32 field of the step."""
    from pdebench_tpu_torch.oracle import base, burgers, reaction_diffusion as rd, scalar
    from pdebench_tpu_torch.oracle.convection_diffusion import transient_time

    pde = config["pde"]
    u_exact = pde["manufactured_solution"]["u"]
    ctx = scalar.setup_scalar(scalar.override_bc_with_mms(config, u_exact), device)
    u0 = torch.as_tensor(base.interpolate_nodal(ctx.space, u_exact, t=0.0), device=device)
    if pde["type"] == "burgers":
        dt = base.time_params(pde)[2]
        A_pre, _ = burgers.step_matrices(ctx.cb, dt, float(pde["pde_params"]["nu"]))
        A_c, T, field = A_pre, (lambda: burgers.advection_tensor(ctx.cb)), u0
    else:
        params = pde["pde_params"]
        R_sym, _ = rd.reaction_expr(params["reaction"])
        dt = transient_time(pde["time"])[2]
        A_pre, A_c, _, _ = rd.step_matrices(ctx.cb, dt, float(params.get("epsilon", 1.0)), R_sym)
        T, field = (lambda: rd.mass_tensor(ctx.cb)), rd.reaction_fns(R_sym)[1](u0)
    lat, wm, bwm = scalar.bilinear_step_lattice(ctx, A_pre, T)
    W_c = torch.as_tensor(wm.weights_np(A_c), device=device).to(torch.float32)
    u_lat = lat.lattice.embed(field.to(torch.float32), 0.0).reshape(wm.shape)
    return wm, bwm, bwm.device_stack(device), W_c, u_lat, lat, ctx.mask.cpu().numpy()


def convdiff_operator(config, device):
    """A steady convection-diffusion case without SUPG as its oracle
    builds it: the f32 lattice of eps K + advection with the hierarchy
    coarsened from that operator itself, the lattice mask and the
    constrained float32 weights (the fused cycle's operator)."""
    from pdebench_tpu_torch.fem import symbolic
    from pdebench_tpu_torch.fem.assemble import local_advection, local_stiffness
    from pdebench_tpu_torch.oracle import scalar
    from pdebench_tpu_torch.solvers.gmg import attach_lattice_gmg
    from pdebench_tpu_torch.solvers.stencil import constrain_step_weights

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, pde["manufactured_solution"]["u"])
    params = pde["pde_params"]
    if params.get("stabilization", "none") != "none":
        raise ValueError("convdiff_operator builds the operator without SUPG")
    ctx = scalar.setup_scalar(config, device)
    qpts = ctx.qpts()
    beta_q = np.stack([symbolic.lambdify_numpy(b, ctx.dim)(qpts) for b in params["beta"]], axis=-1)
    A = float(params["epsilon"]) * local_stiffness(ctx.cb) + local_advection(ctx.cb, beta_q)
    lat = scalar.maybe_lattice32(ctx, A)
    mask = ctx.mask.cpu().numpy()
    attach_lattice_gmg(lat, mask)
    keep = torch.as_tensor(
        1.0 - lat.lattice.embed_np(mask, True).astype(np.float32), device=device
    ).reshape(lat.shape)
    return lat, mask, constrain_step_weights(lat.W, lat.offsets, keep)


def lattice_rhs(lat, mask, rng, device):
    """A random dof residual, zero on constrained dofs, in the lattice's
    flat layout (site-major, component-minor for block lattices)."""
    emb = lat.embedding
    r = rng.standard_normal(emb.n_dof)
    r[mask] = 0.0
    return torch.as_tensor(emb.embed_np(r.astype(np.float32), 0.0), device=device)


def allclose_scale(got, want, tol):
    """(max abs diff, scale, ok) of torch.allclose at rtol = tol and atol
    = tol * max |want|."""
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff, scale, bool(torch.allclose(got, want, rtol=tol, atol=tol * scale))


def true_residual(lat, W, r_lat, z, offsets=None, pad=None):
    """||r - W z|| / ||r|| on a 2-D or 3-D lattice; the taps are the
    lattice's unless given."""
    from pdebench_tpu_torch.solvers import stencil_kernel

    offsets = lat.offsets if offsets is None else offsets
    pad = lat.pad if pad is None else pad
    Az = stencil_kernel.stencil_plain(z.reshape(lat.shape), W, offsets, pad).reshape(-1)
    return float(torch.linalg.norm(r_lat - Az) / torch.linalg.norm(r_lat))


# -- phases ------------------------------------------------------------------


def cluster_line(fused) -> str:
    """A cluster kernel's launch shape after its first launch: the
    cluster, each CTA's dynamic shared memory and l*, the finest level
    CTA 0 solves in shared memory."""
    c = fused._cuda
    return (f"cluster of {c['cluster']} CTAs, {c['smem']} B shared memory each, l* = {c['lstar']} "
            f"(CTA 0 solves levels {c['lstar']}..{len(fused.W) - 1})")


def graph_ms(fn, calls: int = 20, samples: int = 5) -> float:
    """Device time per call: `calls` calls captured in one CUDA graph,
    replayed between two events, median over `samples` replays. No host
    work between the launches: for a launch-bound kernel this is the
    kernel's own time on the card."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def stencil_line(phase, name, cid, lat, W, u, plain, tol, report, nbytes, flops,
                 report_dtype=torch.float64):
    """One stencil apply on the card against its plain version: the
    wrapper's time (median_ms around the plan's call, the kernels line's
    `ms`, as for every kernel), its device time (graph_ms, `device_ms`),
    the caller-level apply_grid_w time (median_ms, `caller_ms`), the plain
    version's, the bound; reported under `name` at its first call in
    `report_dtype`."""
    from pdebench_tpu_torch.solvers import stencil_kernel

    before = stencil_kernel.LAUNCHES
    yk = lat.apply_grid_w(W, u)  # CUDA tensors: one kernel launch
    launched = stencil_kernel.LAUNCHES - before
    yp = plain(u, W, lat.offsets, lat.pad)
    torch.cuda.synchronize()
    err = float((yk - yp).abs().max() / yp.abs().max())
    ms = median_ms(lambda: lat.plan(W, u))
    device_ms = graph_ms(lambda: lat.plan(W, u))
    caller_ms = median_ms(lambda: lat.apply_grid_w(W, u))
    plain_ms = median_ms(lambda: plain(u, W, lat.offsets, lat.pad))
    b = bound(nbytes * W.element_size(), flops, W.dtype)
    tag = f"{'x'.join(map(str, u.shape))} K={len(lat.offsets)} pad={lat.pad} {str(W.dtype)[6:]}"
    say(phase, f"{name} {cid} {tag}: max rel diff {err:.3e} (tol {tol:g}), {launched} launch; "
               f"kernel {ms:.4f} ms (events), {device_ms:.4f} ms (device, graph replay), "
               f"apply_grid_w {caller_ms:.4f} ms (caller, events), plain {plain_ms:.4f} ms, "
               f"bound {b['bound_ms']:.2e} ms "
               f"({b['bound_by']})")
    if not err <= tol or launched != 1:
        raise AssertionError(f"{name} disagrees or launched {launched} times at {cid} {tag}: {err}")
    if name not in report and W.dtype == report_dtype:
        report[name] = dict(max_abs_err=float((yk - yp).abs().max()), ms=ms, plain_ms=plain_ms,
                            device_ms=device_ms, caller_ms=caller_ms, **b)


def check_stencil(ops, rng, dev, report):
    """The scalar stencil kernel on each lattice, f64 (the outer residual)
    and f32; reported under stencil_apply_2d and stencil_apply_3d, at the
    first case of each dimension."""
    from pdebench_tpu_torch.solvers import stencil_kernel

    for cid, lat in ops.items():
        n, K = int(np.prod(lat.shape)), len(lat.offsets)
        for W, tol in ((lat.W_f64, TOL_F64), (lat.W, TOL_F32)):
            u = torch.as_tensor(rng.standard_normal(lat.shape), device=dev).to(W.dtype)
            stencil_line("2", f"stencil_apply_{len(lat.shape)}d", cid, lat, W, u,
                         stencil_kernel.stencil_plain, tol, report, (K + 2) * n, _taps_flops(K, n))


def check_block_stencil(ops, rng, dev, report):
    """The d = 2 block stencil kernel on each block lattice, f64 and f32:
    elasticity's operators (W_f64 for the outer residual) and the
    Navier-Stokes velocity block (weights of a Jacobian); reported under
    stencil_apply_block_2d at the first case. Bound: the K d^2 n weights
    and 2 d n of u and y; 2 operations a tap and coupling, d n adds."""
    from pdebench_tpu_torch.solvers import stencil_kernel

    for cid, (lat, weights) in ops.items():
        n, K = int(np.prod(lat.shape)), len(lat.offsets)
        for W, tol in zip(weights, (TOL_F64, TOL_F32)):
            u = torch.as_tensor(rng.standard_normal(lat.shape + (2,)), device=dev).to(W.dtype)
            stencil_line("2", "stencil_apply_block_2d", cid, lat, W, u,
                         stencil_kernel.block_stencil_plain, tol, report,
                         K * 4 * n + 2 * 2 * n, 4 * _taps_flops(K, n) + 2 * n)


def check_wave_kernels(ops, rng, dev, report):
    """Kernel #1's f64 mass and stiffness applies of each wave case on its
    masked lattice, the field embedded as the oracle embeds it (absent
    sites zero), reported under stencil_apply_2d_masked (the first case)
    and _nonsquare (the second); kernel #2 at one PCG step and at 12 on
    each case's masked hierarchy."""
    from pdebench_tpu_torch.solvers import stencil_kernel

    names = ("stencil_apply_2d_masked", "stencil_apply_2d_masked_nonsquare")
    for name, (cid, (lat, _, (wlat, Ws))) in zip(names, ops.items()):
        n, K = int(np.prod(wlat.shape)), len(wlat.offsets)
        for what, W64 in zip(("mass", "stiffness"), Ws):
            v = torch.as_tensor(rng.standard_normal(lat.lattice.n_dof), device=dev)
            u = lat.lattice.embed(v, 0.0).reshape(wlat.shape)
            stencil_line("3i", name, f"{cid} ({what}, f64)", wlat, W64, u,
                         stencil_kernel.stencil_plain, TOL_F64, report, (K + 2) * n,
                         _taps_flops(K, n))
    check_fused_cg({cid: (lat, mask) for cid, (lat, mask, _) in ops.items()}, rng, dev, report,
                   dict(zip(ops, ("gmg_fused_cg_masked", "gmg_fused_cg_masked_nonsquare"))),
                   iters=12, phase="3i")


def ns_velocity_block(prob, rng):
    """navier_stokes_basic's velocity block as a lattice operator for
    stencil_line: its weight map (offsets, plan, apply) and the block
    weights of the Jacobian at a random velocity (not symmetric per
    site), f64 and f32."""
    from types import SimpleNamespace

    wm = prob.sst.wmapA
    x = torch.as_tensor(rng.standard_normal(prob.nu_dofs + prob.np_dofs), device=prob.device)
    W64 = wm.weights(prob.jacobian(x, prob.nu))
    lat = SimpleNamespace(shape=wm.shape, offsets=wm.offsets, pad=wm.pad, plan=wm.plan,
                          apply_grid_w=wm.apply_grid)
    return lat, (W64, W64.float())


def check_fused_cg(ops, rng, dev, report, report_as, iters=25, phase="3"):
    """One PCG step (the V-cycle's arithmetic, tightly), then the main
    path's `iters` (25 for Poisson and biharmonic, 12 a round of a heat
    step) on each case's own hierarchy; the readings of the case report_as
    names go into the kernels line under that name."""
    from pdebench_tpu_torch.solvers import gmg_fused

    for cid, (lat, mask) in ops.items():
        r_lat = lattice_rhs(lat, mask, rng, dev)
        step = gmg_fused.build_fused_inner_cg(lat.gmg, 1, dev)
        zk, zp = step(r_lat), step.plain(r_lat)
        torch.cuda.synchronize()
        diff, scale, ok = allclose_scale(zk, zp, TOL_VCYCLE)
        say(phase, f"fused_inner_cg {cid} 1 PCG step: max abs diff {diff:.3e} "
                   f"(scale {scale:.3e}, rtol=atol/scale={TOL_VCYCLE:g})")
        if not ok:
            raise AssertionError(f"fused V-cycle step disagrees on {cid}: {diff}")

        fused = gmg_fused.build_fused_inner_cg(lat.gmg, iters, dev)
        zk = fused(r_lat)  # CUDA tensor: the kernel
        zp = fused.plain(r_lat)
        torch.cuda.synchronize()
        diff, scale, ok = allclose_scale(zk, zp, TOL_CG)
        # the correction must solve the constrained fine system
        W0 = lat.gmg.levels[0]
        rel = true_residual(lat, W0.W, r_lat, zk, W0.offsets, W0.pad)
        ms = median_ms(lambda: fused(r_lat), calls=5, samples=3)
        plain_ms = median_ms(lambda: fused.plain(r_lat), calls=1, samples=3)
        b = cg_bound(fused)
        say(phase, f"fused_inner_cg {cid} {iters} PCG steps, {len(fused.W)} levels "
                   f"{[tuple(W.shape) for W in fused.W]}, {cluster_line(fused)}: "
                   f"max abs diff {diff:.3e} (scale {scale:.3e}, rtol=atol/scale={TOL_CG:g}) "
                   f"residual {rel:.2e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                   f"bound {b['bound_ms']:.2e} ms ({b['bound_by']})")
        if not ok or not rel < 1e-3:
            raise AssertionError(f"fused inner CG disagrees on {cid}: {diff}, residual {rel}")
        if cid in report_as:
            report[report_as[cid]] = dict(max_abs_err=diff, ms=ms, plain_ms=plain_ms, **b)


def check_richardson(ops, rng, dev, report, report_as, phase="3b"):
    """Kernel #3 on each case's hierarchy (the Helmholtz surrogates, the
    Stokes velocity block's scalar stiffness): 1 and 2 cycles per element,
    linearity, times at the main path's 2 cycles."""
    from pdebench_tpu_torch.solvers import gmg_fused

    for cid, (lat, mask, _) in ops.items():
        for cycles in (1, 2):
            rich = gmg_fused.build_fused_richardson(lat.gmg, cycles, dev)
            r1, r2 = lattice_rhs(lat, mask, rng, dev), lattice_rhs(lat, mask, rng, dev)
            z1 = rich(r1)  # CUDA tensor: the kernel
            zp = rich.plain(r1)
            torch.cuda.synchronize()
            diff, scale, ok = allclose_scale(z1, zp, TOL_VCYCLE)
            lin, _, lin_ok = allclose_scale(rich(r1 + 2.0 * r2), z1 + 2.0 * rich(r2), TOL_LINEAR)
            say(phase, f"fused_richardson {cid} {cycles} cycle(s) {len(rich.W)} levels "
                      f"{[tuple(W.shape) for W in rich.W]}: max abs diff {diff:.3e} (scale "
                      f"{scale:.3e}, rtol=atol/scale={TOL_VCYCLE:g}); linearity max abs diff "
                      f"{lin:.3e} (tol {TOL_LINEAR:g} of scale)")
            if not ok or not lin_ok:
                raise AssertionError(f"fused Richardson disagrees on {cid}, {cycles} cycles: "
                                     f"{diff}, linearity {lin}")
        ms = median_ms(lambda: rich(r1), calls=20, samples=5)
        plain_ms = median_ms(lambda: rich.plain(r1), calls=2, samples=3)
        b = richardson_bound(rich)
        say(phase, f"fused_richardson {cid} 2 cycles, {cluster_line(rich)}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.3f} ms, "
                  f"bound {b['bound_ms']:.2e} ms ({b['bound_by']})")
        if cid in report_as:
            report[report_as[cid]] = dict(max_abs_err=diff, ms=ms, plain_ms=plain_ms, **b)


def check_gmres(ops, rng, dev, report, report_as, phase="3c"):
    """Kernel #6 on each case's hierarchy with the TRUE constrained
    weights (a Helmholtz surrogate's, or an own-operator hierarchy's level
    0): one step per element, then the whole cycle by its true-operator
    residual, times at the main path's m = 30."""
    from pdebench_tpu_torch.solvers import gmg_fused

    for cid, (lat, mask, W32c) in ops.items():
        r = lattice_rhs(lat, mask, rng, dev)
        one = gmg_fused.build_fused_inner_gmres(lat.gmg, 1, dev, lat.offsets)
        got, want = one.raw(r, W32c), one.plain_raw(r, W32c)  # kernel, plain
        torch.cuda.synchronize()
        err_v = None
        for name, g, w in zip(("V", "H", "beta"), got, want):
            diff, scale, ok = allclose_scale(g, w, TOL_VCYCLE)
            say(phase, f"fused_gmres {cid} m=1 {name}: max abs diff {diff:.3e} (scale "
                      f"{scale:.3e}, rtol=atol/scale={TOL_VCYCLE:g})")
            if not ok:
                raise AssertionError(f"fused Arnoldi step disagrees on {cid} in {name}: {diff}")
            err_v = diff if name == "V" else err_v

        fg = gmg_fused.build_fused_inner_gmres(lat.gmg, ARNOLDI_STEPS, dev, lat.offsets)
        rel = true_residual(lat, W32c, r, fg(r, W32c))
        rel_plain = true_residual(lat, W32c, r, fg.plain(r, W32c))
        ms = median_ms(lambda: fg.raw(r, W32c), calls=5, samples=3)
        plain_ms = median_ms(lambda: fg.plain_raw(r, W32c), calls=1, samples=3)
        b = gmres_bound(fg)
        say(phase, f"fused_gmres {cid} m={ARNOLDI_STEPS} {len(fg.W)} levels, {cluster_line(fg)}: "
                  f"true-operator residual kernel {rel:.3e}, plain {rel_plain:.3e} (kernel below "
                  f"{RESID_MAX:g} and {RESID_RATIO:g}x max(plain, {RESID_FLOOR:g})); kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, "
                  f"bound {b['bound_ms']:.2e} ms ({b['bound_by']})")
        if not (rel < RESID_MAX and rel <= RESID_RATIO * max(rel_plain, RESID_FLOOR)):
            raise AssertionError(f"fused Arnoldi cycle on {cid}: residual {rel} vs plain {rel_plain}")
        if cid in report_as:
            report[report_as[cid]] = dict(max_abs_err=err_v, ms=ms, plain_ms=plain_ms, **b)


def check_block_cg(ops, rng, dev, report):
    """Kernel #4 on each elasticity case's block hierarchy: one PCG step
    (the block V-cycle, tightly), the main path's 25 with a true residual
    against the constrained level 0, and the Richardson mode at 1 and 2
    cycles with its linearity."""
    from pdebench_tpu_torch.solvers import gmg_fused

    for cid, (lat, mask) in ops.items():
        r_lat = lattice_rhs(lat, mask, rng, dev)
        step = gmg_fused.build_fused_block_inner_cg(lat.gmg, 1, dev)
        zk, zp = step(r_lat), step.plain(r_lat)  # kernel, plain
        torch.cuda.synchronize()
        diff, scale, ok = allclose_scale(zk, zp, TOL_VCYCLE)
        say("3d", f"fused_block_cg {cid} 1 PCG step: max abs diff {diff:.3e} "
                  f"(scale {scale:.3e}, rtol=atol/scale={TOL_VCYCLE:g})")
        if not ok:
            raise AssertionError(f"fused block V-cycle step disagrees on {cid}: {diff}")

        fused = gmg_fused.build_fused_block_inner_cg(lat.gmg, 25, dev)
        zk = fused(r_lat)
        zp = fused.plain(r_lat)
        torch.cuda.synchronize()
        diff, scale, ok = allclose_scale(zk, zp, TOL_CG)
        # the correction must solve the constrained fine block system
        # (level 0 of the hierarchy, applied by the plain version)
        r_pl = fused._to_planes(r_lat)
        rel = float(torch.linalg.norm(r_pl - fused._apply(0, fused._to_planes(zk)))
                    / torch.linalg.norm(r_pl))
        ms = median_ms(lambda: fused(r_lat), calls=5, samples=3)
        plain_ms = median_ms(lambda: fused.plain(r_lat), calls=1, samples=3)
        b = block_cg_bound(fused)
        say("3d", f"fused_block_cg {cid} {len(fused.W)} levels {[tuple(W.shape) for W in fused.W]}, "
                  f"{cluster_line(fused)}: "
                  f"max abs diff {diff:.3e} (scale {scale:.3e}, rtol=atol/scale={TOL_CG:g}) "
                  f"residual {rel:.2e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {b['bound_ms']:.2e} ms ({b['bound_by']})")
        if not ok or not rel < 1e-3:
            raise AssertionError(f"fused block inner CG disagrees on {cid}: {diff}, residual {rel}")
        if cid == "linear_elasticity_nu010":
            report["gmg_fused_block_cg"] = dict(max_abs_err=diff, ms=ms, plain_ms=plain_ms, **b)
        # CTA 0 on the coarsest level alone: the same result bit for bit,
        # where it solves more than that level by default
        if fused._cuda["lstar"] < len(fused.W) - 1:
            other = gmg_fused.build_fused_block_inner_cg(lat.gmg, 25, dev, cta_levels=1)
            same = bool(torch.equal(other(r_lat), zk))
            say("3d", f"fused_block_cg {cid} with CTA 0 on the coarsest level alone: bitwise "
                      f"equal {same}")
            if not same:
                raise AssertionError(f"fused block inner CG differs on {cid} with CTA 0 on the "
                                     f"coarsest level alone")
        else:
            say("3d", f"fused_block_cg {cid}: CTA 0 takes the coarsest level alone by default, "
                      f"no second build to compare")

        for cycles in (1, 2):
            rich = gmg_fused.build_fused_block_inner_cg(lat.gmg, cycles, dev, mode="richardson")
            r1, r2 = lattice_rhs(lat, mask, rng, dev), lattice_rhs(lat, mask, rng, dev)
            z1 = rich(r1)
            zp = rich.plain(r1)
            torch.cuda.synchronize()
            diff, scale, ok = allclose_scale(z1, zp, TOL_VCYCLE)
            lin, _, lin_ok = allclose_scale(rich(r1 + 2.0 * r2), z1 + 2.0 * rich(r2), TOL_LINEAR)
            say("3d", f"fused_block_richardson {cid} {cycles} cycle(s): max abs diff {diff:.3e} "
                      f"(scale {scale:.3e}, rtol=atol/scale={TOL_VCYCLE:g}); linearity max abs "
                      f"diff {lin:.3e} (tol {TOL_LINEAR:g} of scale)")
            if not ok or not lin_ok:
                raise AssertionError(f"fused block Richardson disagrees on {cid}, {cycles} "
                                     f"cycles: {diff}, linearity {lin}")


def skew_dinv(fused, rng):
    """Add an antisymmetric part to every level's 2 x 2 smoother blocks,
    in place, and return its size relative to max |D|. The diagonal
    blocks of a symmetric operator are symmetric, so only skewed ones
    show D[b, a] read for D[a, b]."""
    for D in fused.D:
        u = torch.as_tensor(rng.uniform(0.0, 0.2, D.shape[-2:]), dtype=D.dtype, device=D.device)
        s = D.abs().max() * u
        D[0, 1] += s
        D[1, 0] -= s
    D = fused.D[0]
    return float((D[0, 1] - D[1, 0]).abs().max() / D.abs().max())


def check_block_transpose(lat, mask, rng, dev):
    """One block PCG step on a hierarchy whose tap blocks are not
    symmetric per site (a rough shear modulus) and whose smoother blocks
    are skewed: the check that sees W[k, b, a] read for W[k, a, b], or
    D[b, a] for D[a, b]."""
    from pdebench_tpu_torch.solvers import gmg_fused

    W = lat.gmg.levels[0].W
    asym = float((W - W.transpose(-1, -2)).abs().max() / W.abs().max())
    r_lat = lattice_rhs(lat, mask, rng, dev)
    step = gmg_fused.build_fused_block_inner_cg(lat.gmg, 1, dev)
    skew = skew_dinv(step, rng)
    zk, zp = step(r_lat), step.plain(r_lat)
    torch.cuda.synchronize()
    diff, scale, ok = allclose_scale(zk, zp, TOL_VCYCLE)
    say("3d", f"fused_block_cg rough-mu {lat.shape} lattice (tap-block asymmetry {asym:.2e} "
              f"of max |W|, smoother skew {skew:.2e} of max |D|) 1 PCG step: max abs diff "
              f"{diff:.3e} (scale {scale:.3e}, rtol=atol/scale={TOL_VCYCLE:g})")
    if not (asym > 1e-2 and skew > 1e-2) or not ok:
        raise AssertionError(f"fused block V-cycle step on rough mu: asymmetry {asym}, "
                             f"skew {skew}, diff {diff}")


def random_block_weights(offsets, shape, rng):
    """Random block weights (K, *shape, 2, 2) on a lattice's taps, not
    symmetric per site and skewed in their diagonal blocks: taps reaching
    outside the lattice zero, diagonal blocks dominant (a stable
    block-Jacobi smoother)."""
    K = len(offsets)
    W = rng.standard_normal((K,) + tuple(shape) + (2, 2))
    grids = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    for k, off in enumerate(offsets):
        ok = np.ones(shape, dtype=bool)
        for g, o, n in zip(grids, off, shape):
            ok &= (g + o >= 0) & (g + o < n)
        W[k][~ok] = 0.0
        if all(o == 0 for o in off):
            # dominant, and skewed: D[0, 1] and D[1, 0] differ by ~4K
            W[k] += 4 * K * np.eye(2) + 2 * K * np.array([[0.0, 1.0], [-1.0, 0.0]])
    return W


def check_dyn_block(prob, rng, dev, report):
    """Kernel #5 on a Navier-Stokes case's hierarchy (the main path's
    shapes), against its plain version at 1 and 2 cycles, on weight sets
    called one after another on the same spec: the convected Jacobian at
    the Stokes solution (its per-site blocks are not symmetric: N1 carries
    du_a/dx_b), the Jacobian at twice that state, a skewed random block
    stencil, then the first set again. A kernel that kept a stale weight
    set, or read W[k, b, a] or D[b, a], fails one of them."""
    from pdebench_tpu_torch.solvers import gmg_fused

    sst, spec = prob.sst, prob.spec
    x1 = prob.stokes_direct(prob.nu)
    wm = sst.wmapA
    W_rand = random_block_weights(wm.offsets, sst.fine, rng)
    sets = [
        ("J(Stokes)", wm.weights(prob.jacobian(x1, prob.nu)).float()),
        ("J(2 x Stokes)", wm.weights(prob.jacobian(2.0 * x1, prob.nu)).float()),
        ("skewed random", torch.as_tensor(W_rand, dtype=torch.float32, device=dev)),
    ]
    levels = [(name, prob.levels(W)) for name, W in sets]
    levels.append(("J(Stokes) again", levels[0][1]))
    # asymmetry of the fine level's 2 x 2 tap blocks and smoother blocks:
    # max |T[0, 1] - T[1, 0]| / max (|T[0, 1]| + |T[1, 0]|), 0 for symmetric
    # blocks, 1 for antisymmetric ones
    def asymmetry(T, a):
        t01, t10 = T.select(a, 0).select(a, 1), T.select(a, 1).select(a, 0)
        return float((t01 - t10).abs().max() / (t01.abs() + t10.abs()).max())

    asym = {name: [asymmetry(lv[0][0], 1), asymmetry(lv[0][1], 0)] for name, lv in levels[:3]}
    keep = prob.keep_node32[..., None]
    for cycles in (1, 2):
        fused = gmg_fused.build_fused_dyn_block_vcycle(spec, cycles, dev)
        r = (torch.as_tensor(rng.standard_normal(sst.fine + (2,)), dtype=torch.float32,
                             device=dev) * keep).reshape(-1)
        outs = []
        for name, lv in levels:
            zk, zp = fused(r, lv), fused.plain(r, lv)  # kernel, plain
            torch.cuda.synchronize()
            diff, scale, ok = allclose_scale(zk, zp, TOL_VCYCLE)
            outs.append(zp)
            say("3e", f"fused_dyn_block_vcycle {cycles} cycle(s) {len(lv)} levels "
                      f"{[tuple(W.shape) for W, _ in lv]} {name}: max abs diff {diff:.3e} "
                      f"(scale {scale:.3e}, rtol=atol/scale={TOL_VCYCLE:g})")
            if not ok:
                raise AssertionError(f"fused dyn block V-cycle disagrees on {name}, "
                                     f"{cycles} cycles: {diff}")
            if name == "J(Stokes)" and cycles == 1:
                err = diff
        # the weight sets must part the outputs, or a stale set would not show
        apart = float((outs[0] - outs[1]).abs().max() / outs[0].abs().max())
        say("3e", f"fused_dyn_block_vcycle {cycles} cycle(s): J(Stokes) and J(2 x Stokes) "
                  f"outputs {apart:.3e} apart (of scale); asymmetry of the fine W and D "
                  f"blocks {asym}")
        if not (apart > 1e-2 and min(asym["skewed random"]) > 0.1):
            raise AssertionError(f"weight sets too close to tell apart: {apart}, {asym}")
    fused = gmg_fused.build_fused_dyn_block_vcycle(spec, 1, dev)
    lv = levels[0][1]
    ms = median_ms(lambda: fused(r, lv), calls=20, samples=5)
    plain_ms = median_ms(lambda: fused.plain(r, lv), calls=2, samples=3)
    b = dyn_block_bound(lv, 1)
    say("3e", f"fused_dyn_block_vcycle 1 cycle (the main path's), cluster of "
              f"{fused._cuda['cluster']} CTAs, {fused._cuda['smem']} B shared memory each: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.2e} ms ({b['bound_by']})")
    report["gmg_fused_dyn_block_vcycle"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b)


def check_step_weights(ops, rng, dev, report):
    """The per-step weight build (PyTorch, no kernel of its own) on the
    card at the main path's shapes: its float32 weights bit for bit the
    same on a second call and as the CPU build's (the same IEEE
    operations: exact float64 products, one float32 rounding an add), its
    time (events) and its device kernels a build (profiler); then kernel
    #1 with those weights, their f64 cast (the outer) and f32 (the inner),
    against its plain version, reported as stencil_apply_2d_step at the
    first case."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pdebench_tpu_torch.solvers import stencil_kernel

    for cid, (wm, bwm, P, W_c, u_lat, *_) in ops.items():
        W = W_c + bwm.weights_w(P, u_lat)
        again = W_c + bwm.weights_w(P, u_lat)
        W_cpu = W_c.cpu() + bwm.weights_w(bwm.device_stack("cpu"), u_lat.cpu())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bwm.weights_w(P, u_lat)
            torch.cuda.synchronize()
        kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        ms = median_ms(lambda: bwm.weights_w(P, u_lat), calls=5, samples=3)
        # P's float32 entries of the structurally nonzero pairs, u and W
        # once each (the zero planes of the grouped stack are not work)
        G, K, n = P.P.shape
        b = bound((len(bwm.pairs) + 1 + K) * n * 4, 2 * len(bwm.pairs) * n, torch.float32)
        say("3g", f"weights_w {cid} {'x'.join(map(str, wm.shape))} K={K} pairs={len(bwm.pairs)} "
                  f"G={G}: the same on a second call {torch.equal(W, again)}, as the CPU build "
                  f"{torch.equal(W.cpu(), W_cpu)}; {ms:.4f} ms a build (events), {kernels} device "
                  f"kernels a build (profiler), bound {b['bound_ms']:.2e} ms ({b['bound_by']})")
        if not (torch.equal(W, again) and torch.equal(W.cpu(), W_cpu)):
            raise AssertionError(f"the step weights of {cid} moved between builds or devices")
        lat = SimpleNamespace(shape=wm.shape, offsets=wm.offsets, pad=wm.pad, plan=wm.plan,
                              apply_grid_w=wm.apply_grid)
        for Wx, tol in ((W.double(), TOL_F64), (W, TOL_F32)):
            u = torch.as_tensor(rng.standard_normal(wm.shape), device=dev).to(Wx.dtype)
            stencil_line("3g", "stencil_apply_2d_step", cid, lat, Wx, u, stencil_kernel.stencil_plain,
                         tol, report, (K + 2) * n, _taps_flops(K, n))


def check_step_gmres(cid, ops, m, rng, dev, report, report_as):
    """Kernel #6 with a per-step operator (phase 21a): the step's float32
    weights W_c + W(u) constrained on the card (their own offsets) on the
    constant part's hierarchy: one step per element, then the whole
    m-step cycle by its true-operator residual, its time beside the
    constraint's (one call a step on the main path)."""
    from pdebench_tpu_torch.solvers import gmg_fused
    from pdebench_tpu_torch.solvers.stencil import constrain_step_weights

    wm, bwm, P, W_c, u_lat, lat, mask = ops
    W = W_c + bwm.weights_w(P, u_lat)
    keep = torch.as_tensor(
        1.0 - lat.lattice.embed_np(mask, True).astype(np.float32), device=dev
    ).reshape(wm.shape)
    W32c = constrain_step_weights(W, wm.offsets, keep)
    c_ms = median_ms(lambda: constrain_step_weights(W, wm.offsets, keep), calls=5, samples=3)
    K, n = len(wm.offsets), int(np.prod(wm.shape))
    c_b = bound((2 * K + 1) * n * 4, 2 * K * n, torch.float32)
    r = lattice_rhs(lat, mask, rng, dev)
    one = gmg_fused.build_fused_inner_gmres(lat.gmg, 1, dev, wm.offsets)
    got, want = one.raw(r, W32c), one.plain_raw(r, W32c)
    torch.cuda.synchronize()
    err_v = None
    for name, g, w in zip(("V", "H", "beta"), got, want):
        diff, scale, ok = allclose_scale(g, w, TOL_VCYCLE)
        say("21a", f"fused_gmres step {cid} m=1 {name}: max abs diff {diff:.3e} (scale "
                   f"{scale:.3e}, rtol=atol/scale={TOL_VCYCLE:g})")
        if not ok:
            raise AssertionError(f"fused Arnoldi step on {cid}'s step weights disagrees in {name}: {diff}")
        err_v = diff if name == "V" else err_v
    fg = gmg_fused.build_fused_inner_gmres(lat.gmg, m, dev, wm.offsets)
    rel = true_residual(lat, W32c, r, fg(r, W32c), wm.offsets, wm.pad)
    rel_plain = true_residual(lat, W32c, r, fg.plain(r, W32c), wm.offsets, wm.pad)
    ms = median_ms(lambda: fg.raw(r, W32c), calls=5, samples=3)
    plain_ms = median_ms(lambda: fg.plain_raw(r, W32c), calls=1, samples=3)
    b = gmres_bound(fg)
    say("21a", f"fused_gmres step {cid} {'x'.join(map(str, wm.shape))} K={K} m={m} {len(fg.W)} levels, "
               f"{cluster_line(fg)}: true-operator residual kernel {rel:.3e}, plain {rel_plain:.3e}; "
               f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.2e} ms "
               f"({b['bound_by']}); constrain_step_weights {c_ms:.4f} ms a step (events), bound "
               f"{c_b['bound_ms']:.2e} ms ({c_b['bound_by']})")
    if not (rel < RESID_MAX and rel <= RESID_RATIO * max(rel_plain, RESID_FLOOR)):
        raise AssertionError(f"fused Arnoldi cycle on {cid}'s step weights: residual {rel} vs plain {rel_plain}")
    report[report_as] = dict(max_abs_err=err_v, ms=ms, plain_ms=plain_ms, **b)


def with_env(env, fn, *args, **kwargs):
    """fn(*args, **kwargs) with the environment variables `env` set, and
    removed (or restored) after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn(*args, **kwargs)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def drive_warm_repeats(solver, cid, config, record, tol, phase):
    """poisson_basic with one warm pass, then with WARM_REPEATS
    (PDEBENCH_TPU_WARM_REPEATS): the passes reported, t_warm the fastest
    of the case's own passes (so at most its first, a single pass), the
    error unchanged. The single-pass solve's t_warm is printed beside it;
    it is another solve's sample, so the fastest of 3 passes lands below
    it only with a chance of 3 in 4 when the passes spread alike."""
    from pdebench_tpu_torch.oracle import base

    runs = {}
    for n in (1, WARM_REPEATS):
        base.clear_setup_caches()
        res = with_env({"PDEBENCH_TPU_WARM_REPEATS": str(n)}, solver.solve, copy.deepcopy(config))
        info = res.solver_info
        passes = info["warm_pass_s"]
        rel = abs(res.baseline_error - record) / record
        say(phase, f"{cid} PDEBENCH_TPU_WARM_REPEATS={n}: warm passes {info['warm_passes']} "
                   f"({', '.join(f'{t:.5f}' for t in passes)} s), t_warm {info['t_warm']:.5f} s, "
                   f"cold {info['t_cold']:.4f} s; baseline_error {res.baseline_error!r} (rel {rel:.2e})")
        if (info["warm_passes"] != n or len(passes) != n or info["t_warm"] != min(passes)
                or not rel <= tol):
            raise AssertionError(f"{cid} under PDEBENCH_TPU_WARM_REPEATS={n}: {info}")
        runs[n] = info
    say(phase, f"{cid}: t_warm over {WARM_REPEATS} passes {runs[WARM_REPEATS]['t_warm']:.5f} s, its "
               f"first pass {runs[WARM_REPEATS]['warm_pass_s'][0]:.5f} s, the single-pass solve's "
               f"{runs[1]['t_warm']:.5f} s")


def stokes_kernel_ops(prob_2d, prob_3d, rng, dev, report):
    """(3h) Kernel #3 on stokes_basic's velocity hierarchy (the scalar
    stiffness times nu, constrained where any component is), 1 and 2
    cycles; #1's d = 3 block form on stokes_3d_basic's A-block weights (the
    vector Laplacian, f64 and f32) and on random 3 x 3 weights (not
    symmetric per site: a transposed read shows only there). Bound of the
    d = 3 apply: the 9 K n weights and 3 n of u and y; 2 operations a tap
    and coupling, 2 adds a row."""
    from types import SimpleNamespace

    from pdebench_tpu_torch.oracle import mixed
    from pdebench_tpu_torch.solvers import stencil_kernel

    V = prob_2d.ctx.V
    node_mask = prob_2d.mask_np[: V.ndof].reshape(-1, V.ncomp).any(axis=1)
    lat = SimpleNamespace(gmg=prob_2d.parts.gmg, embedding=mixed.velocity_lattice(V))
    check_richardson({"stokes_basic": (lat, node_mask, None)}, rng, dev, report,
                     {"stokes_basic": "gmg_fused_richardson_stokes"}, phase="3h")
    wm = prob_3d.sst.wmapA
    lat3 = SimpleNamespace(shape=wm.shape, offsets=wm.offsets, pad=wm.pad, plan=wm.plan,
                           apply_grid_w=wm.apply_grid)
    n, K = int(np.prod(wm.shape)), len(wm.offsets)
    W_rand = torch.as_tensor(rng.standard_normal(tuple(prob_3d.WA64.shape)), device=dev)
    for W, tol in ((prob_3d.WA64, TOL_F64), (prob_3d.WA64.float(), TOL_F32), (W_rand, TOL_F64),
                   (W_rand.float(), TOL_F32)):
        u = torch.as_tensor(rng.standard_normal(wm.shape + (3,)), device=dev).to(W.dtype)
        stencil_line("3h", "stencil_apply_block_3d", "stokes_3d_basic", lat3, W, u,
                     stencil_kernel.block_stencil_plain, tol, report, K * 9 * n + 2 * 3 * n,
                     9 * _taps_flops(K, n) + 6 * n)


def check_block3_elasticity(config, rng, dev, report):
    """(18k) The stencil kernel's d = 3 block form at le_3d_multifreq_mms'
    25^3 lattice (65 taps): the f32 apply of the refinement's inner
    operator (the V-cycle's finest level applies its constrained copy, of
    the same shape and taps), reported under
    stencil_apply_block_3d_elasticity, and the f64 apply of the outer
    residual. Bound: the 9 K n weights and 6 n of u and y; 2 operations a
    tap and coupling, 2 adds a row."""
    from pdebench_tpu_torch.fem.assemble import local_elasticity
    from pdebench_tpu_torch.oracle import linear_elasticity, scalar
    from pdebench_tpu_torch.solvers import stencil_kernel

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, list(pde["manufactured_solution"]["u"]))
    lam, mu = linear_elasticity.lame_from_params(pde["pde_params"])
    ctx = scalar.setup_scalar(config, dev, ncomp=-1)
    lat = scalar.maybe_block_lattice32(ctx, local_elasticity(ctx.cb, mu, lam))
    n, K = int(np.prod(lat.shape)), len(lat.offsets)
    for W, tol, dtype in ((lat.W, TOL_F32, torch.float32), (lat.W_f64, TOL_F64, torch.float64)):
        u = torch.as_tensor(rng.standard_normal(lat.grid_shape), device=dev).to(dtype)
        stencil_line("18k", "stencil_apply_block_3d_elasticity", "le_3d_multifreq_mms", lat, W, u,
                     stencil_kernel.block_stencil_plain, tol, report, K * 9 * n + 2 * 3 * n,
                     9 * _taps_flops(K, n) + 6 * n, report_dtype=torch.float32)


# Hyperelasticity and Cahn-Hilliard (phase 18c): the configurations of the
# JAX package's tests/test_northstar_pdes.py (the stretch at its resolution
# 10, Cahn-Hilliard's mass conservation at its 16), and each at resolution
# 64; each solve held to what that test asserts
def hyper_stretch(resolution):
    return {
        "pde": {"type": "hyperelasticity", "pde_params": {"E": 1.0, "nu": 0.3},
                "body_force": ["0", "0"]},
        "domain": {"type": "unit_square"},
        "mesh": {"resolution": resolution, "cell_type": "triangle"},
        "fem": {"family": "Lagrange", "degree": 1},
        "bc": {"dirichlet": [{"on": "x0", "value": ["0", "0"]},
                             {"on": "x1", "value": ["0.2", "0"]}]},
        "output": {"field": "displacement_magnitude",
                   "grid": {"bbox": [0, 1, 0, 1], "nx": 20, "ny": 20}},
        "oracle_solver": {"rtol": 1e-9, "max_it": 40},
    }


def cahn_hilliard_mass(resolution):
    return {
        "pde": {"type": "cahn_hilliard", "pde_params": {"lambda": 1e-2, "M": 1.0},
                "time": {"t0": 0.0, "t_end": 5e-5, "dt": 5e-6},
                "initial_condition": "random", "seed": 3},
        "domain": {"type": "unit_square"},
        "mesh": {"resolution": resolution, "cell_type": "triangle"},
        "fem": {"family": "Lagrange", "degree": 1},
        "bc": {},
        "output": {"grid": {"bbox": [0, 1, 0, 1], "nx": 24, "ny": 24}},
        "oracle_solver": {"rtol": 1e-8},
    }


def hyper_checks(grid, info):
    """tests/test_northstar_pdes.py::test_hyperelasticity_stretch_converges"""
    return (info["residual"] < 1e-6 and abs(np.nanmax(grid) - 0.2) < 0.02
            and info["inner"] == "newton-cg(autodiff)")


def cahn_hilliard_checks(grid, info):
    """tests/test_northstar_pdes.py::test_cahn_hilliard_mass_conservation"""
    return (abs(np.nanmean(grid) - 0.63) < 0.02 and np.nanmin(grid) > -0.5
            and np.nanmax(grid) < 1.5 and info["residual"] < 1e-8
            and info["inner"] == "jacobi-gmres")


NORTHSTAR = {
    "hyperelasticity_stretch@10": (hyper_stretch(10), hyper_checks),
    "hyperelasticity_stretch@64": (hyper_stretch(64), hyper_checks),
    "cahn_hilliard_mass@16": (cahn_hilliard_mass(16), cahn_hilliard_checks),
    "cahn_hilliard_mass@64": (cahn_hilliard_mass(64), cahn_hilliard_checks),
}


def drive_northstar(solver, cases, want, phase):
    """SOLVES whole-case solves per configuration through OracleSolver,
    setup caches cleared before each: a finite grid of the case's shape,
    the reference test's checks, the same Newton (and linear) iterations
    on every solve and the same grid bit for bit. No kernel of the table
    runs there: the energy's derivatives, the applies and GMRES are
    PyTorch ops, every sum in a fixed order."""
    from pdebench_tpu_torch.oracle import base

    for cid, (config, checks) in want.items():
        warm, counts, grids = [], set(), []
        for _ in range(SOLVES):
            base.clear_setup_caches()
            res = solver.solve(copy.deepcopy(config))
            info = res.solver_info
            grid = np.asarray(res.reference)
            its = (info.get("iterations"), info.get("newton_per_step"), info.get("linear_iterations"))
            say(phase, f"{cid}: {res.num_dofs} dofs; baseline_time {res.baseline_time:.4f} s, "
                       f"t_setup {info['t_setup']:.4f} s, warm solve {info['t_warm']:.4f} s, "
                       f"cold {info['t_cold']:.4f} s; inner {info['inner']}, Newton iterations "
                       f"{info.get('iterations', info.get('newton_iterations'))}"
                       + (f" (per step {info['newton_per_step']}, GMRES iterations per step "
                          f"{info['linear_iterations']})" if "newton_per_step" in info else "")
                       + f", residual {info['residual']!r}; grid max {float(np.nanmax(grid))!r}, "
                       f"mean {float(np.nanmean(grid))!r}")
            check_grid(cid, config, grid)
            if not checks(grid, info):
                raise AssertionError(f"{cid}: the reference test's checks fail: {info}")
            counts.add(repr(its))
            grids.append(grid)
            warm.append(info["t_warm"])
        if len(counts) != 1:
            raise AssertionError(f"{cid}: the iterations moved between solves: {counts}")
        same_bits(phase, cid, grids)
        say(phase, f"{cid} over {SOLVES} solves: warm solve median "
                   f"{statistics.median(warm):.4f} s ({min(warm):.4f}-{max(warm):.4f})")


def same_bits(phase, cid, grids) -> None:
    """The grids of a case's solves, equal bit for bit (NaN where the
    first is), or an AssertionError."""
    first = grids[0]
    same = all(np.array_equal(first, g, equal_nan=True) for g in grids[1:])
    say(phase, f"{cid}: the {len(grids)} solves' grids equal bit for bit: {same}")
    if not same:
        raise AssertionError(f"{cid}: the grids of the solves differ")


def drive_stokes(solver, cases, want, phase, bitwise=False):
    """SOLVES whole-case Stokes solves per case through OracleSolver, setup
    caches cleared before each: the error within its tolerance of the
    record, a finite grid of the case's shape, the inner asserted, no
    unconverged solve, kernel #1 launched in every solve (the lattice and
    3-D saddle applies) and #3 in every solve of a fused-richardson case,
    and the same MINRES iterations on every solve (with `bitwise`, the
    same grid bit for bit)."""
    from pdebench_tpu_torch.oracle import base
    from pdebench_tpu_torch.solvers import gmg_fused, stencil_kernel

    for cid, (ref_err, tol, inner_want) in want.items():
        warm, total, its_seen, grids = [], [], set(), []
        for _ in range(SOLVES):
            base.clear_setup_caches()
            before = stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES_RICHARDSON
            res = solver.solve(cases[cid])
            n1 = stencil_kernel.LAUNCHES - before[0]
            n3 = gmg_fused.LAUNCHES_RICHARDSON - before[1]
            info = res.solver_info
            grid = np.asarray(res.reference)
            rel = abs(res.baseline_error - ref_err) / ref_err
            say(phase, f"{cid}: baseline_error {res.baseline_error!r} (recorded "
                       f"{ref_err!r}, rel {rel:.2e}, tol {tol:g}); baseline_time "
                       f"{res.baseline_time:.4f} s, t_setup {info['t_setup']:.4f} s, "
                       f"warm solve {info['t_warm']:.4f} s, cold {info['t_cold']:.4f} s; "
                       f"inner {info.get('inner')}, layout {info.get('saddle_layout')}, MINRES "
                       f"iterations {info.get('iterations')}, restarts {info.get('restarts')}, "
                       f"residual {info.get('residual')!r}; launches in this solve (cold and "
                       f"warm runs): #1 {n1}, #3 {n3}")
            check_grid(cid, cases[cid], grid)
            if not rel <= tol:
                raise AssertionError(f"{cid}: baseline_error off by {rel:.2e}")
            if info.get("inner") != inner_want or "iterative_failed" in info or "amg_failed" in info:
                raise AssertionError(f"{cid}: inner {info.get('inner')}, {info}")
            grids.append(grid)
            # P3-P2's flat saddle apply is the cell-based one: no #1 there
            needs_1 = info.get("saddle_layout") == "lattice" or inner_want == "minres+diag"
            if (needs_1 and n1 < 1) or ("fused-richardson" in inner_want and n3 < 1):
                raise AssertionError(f"{cid}: kernel launches #1 {n1}, #3 {n3}")
            its_seen.add((info["iterations"], info["restarts"]))
            warm.append(info["t_warm"])
            total.append(res.baseline_time)
        if len(its_seen) != 1:
            raise AssertionError(f"{cid}: the MINRES iterations moved between solves: {its_seen}")
        if bitwise:
            same_bits(phase, cid, grids)
        say(phase, f"{cid} over {SOLVES} solves: warm solve median "
                   f"{statistics.median(warm):.4f} s ({min(warm):.4f}-{max(warm):.4f}), "
                   f"baseline_time median {statistics.median(total):.4f} s "
                   f"({min(total):.4f}-{max(total):.4f})")


def drive_ns(solver, cases, want, phase):
    """SOLVES whole-case Navier-Stokes solves per case through
    OracleSolver, setup caches cleared before each: the error within its
    tolerance of the record, a finite grid of the case's shape, the fused
    route, no failed linear solve."""
    from pdebench_tpu_torch.oracle import base
    from pdebench_tpu_torch.solvers import gmg_fused

    for cid, (ref_err, tol) in want.items():
        warm, total = [], []
        for _ in range(SOLVES):
            base.clear_setup_caches()
            before = gmg_fused.LAUNCHES_DYN_BLOCK
            res = solver.solve(cases[cid])
            info = res.solver_info
            grid = np.asarray(res.reference)
            rel = abs(res.baseline_error - ref_err) / ref_err
            say(phase, f"{cid}: baseline_error {res.baseline_error!r} (recorded "
                       f"{ref_err!r}, rel {rel:.2e}, tol {tol:g}); baseline_time "
                       f"{res.baseline_time:.4f} s, t_setup {info['t_setup']:.4f} s, "
                       f"warm solve {info['t_warm']:.4f} s, cold {info['t_cold']:.4f} s; "
                       f"inner {info.get('inner')}, linear solves {info['iterations']}, "
                       f"Krylov iterations {info['kry_its']}, residual {info['residual']!r}; "
                       f"kernel #5 launches in this solve (cold and warm runs) "
                       f"{gmg_fused.LAUNCHES_DYN_BLOCK - before}")
            g = cases[cid]["output"]["grid"]
            shape = (g["ny"], g["nx"])
            if grid.shape != shape or not np.isfinite(grid).all():
                raise AssertionError(f"{cid}: bad grid {grid.shape}, expected {shape}")
            if not rel <= tol:
                raise AssertionError(f"{cid}: baseline_error off by {rel:.2e}")
            if info.get("inner") != "newton-fgmres+fused-dyn-vcycle-cuda" or "iterative_failed" in info:
                raise AssertionError(f"{cid}: inner {info.get('inner')}, {info}")
            warm.append(info["t_warm"])
            total.append(res.baseline_time)
        say(phase, f"{cid} over {SOLVES} solves: warm solve median "
                   f"{statistics.median(warm):.4f} s ({min(warm):.4f}-{max(warm):.4f}), "
                   f"baseline_time median {statistics.median(total):.4f} s "
                   f"({min(total):.4f}-{max(total):.4f})")


def drive(solver, cases, want, phase):
    """SOLVES whole-case solves per case through OracleSolver, setup
    caches cleared before each; every check of the case must hold."""
    from pdebench_tpu_torch.oracle import base

    for cid, (ref_err, tol, inner_want, outer_want, steps) in want.items():
        warm, total = [], []
        for _ in range(SOLVES):
            base.clear_setup_caches()
            res = solver.solve(cases[cid])
            info = res.solver_info
            grid = np.asarray(res.reference)
            rel = abs(res.baseline_error - ref_err) / ref_err
            outer = info.get("iterations", 0) // steps
            say(phase, f"{cid}: baseline_error {res.baseline_error!r} (recorded "
                       f"{ref_err!r}, rel {rel:.2e}, tol {tol:g}); baseline_time "
                       f"{res.baseline_time:.4f} s, t_setup {info['t_setup']:.4f} s, "
                       f"warm solve {info['t_warm']:.4f} s, cold {info['t_cold']:.4f} s; "
                       f"inner {info.get('inner')}, outer {outer}, residual "
                       f"{info.get('residual')}")
            g = cases[cid]["output"]["grid"]
            shape = tuple(g[k] for k in ("nz", "ny", "nx") if k in g)
            if grid.shape != shape or not np.isfinite(grid).all():
                raise AssertionError(f"{cid}: bad grid {grid.shape}, expected {shape}")
            if not rel <= tol:
                raise AssertionError(f"{cid}: baseline_error off by {rel:.2e}")
            if info.get("inner") != inner_want or "iterative_failed" in info:
                raise AssertionError(f"{cid}: inner {info.get('inner')}, {info}")
            if outer != outer_want:
                raise AssertionError(f"{cid}: {outer} outer rounds, expected {outer_want}")
            warm.append(info["t_warm"])
            total.append(res.baseline_time)
        say(phase, f"{cid} over {SOLVES} solves: warm solve median "
                   f"{statistics.median(warm):.4f} s ({min(warm):.4f}-{max(warm):.4f}), "
                   f"baseline_time median {statistics.median(total):.4f} s "
                   f"({min(total):.4f}-{max(total):.4f})")


def check_grid(cid, config, grid):
    """The case's output grid shape, finite values inside the domain, and
    NaN exactly outside it: nowhere on unit_square and unit_cube, on part
    of the grid's box for the masked domains (l_shape, t_junction)."""
    g = config["output"]["grid"]
    shape = tuple(g[k] for k in ("nz", "ny", "nx") if k in g)
    outside = np.isnan(grid)
    masked = config["domain"]["type"] not in ("unit_square", "unit_cube", "periodic_square")
    if (grid.shape != shape or not np.isfinite(grid[~outside]).all() or outside.all()
            or outside.any() != masked):
        raise AssertionError(f"{cid}: bad grid {grid.shape} (expected {shape}), "
                             f"{int(outside.sum())} NaN, {int(np.isinf(grid).sum())} inf")


def drive_cases(solver, cases, want, phase, bitwise=False, step_outer=None):
    """SOLVES whole-case solves per case of the heat, biharmonic,
    convection-diffusion, reaction-diffusion, Burgers and wave paths and
    of the route off the lattice, setup caches cleared before each: the
    error within its tolerance of the record, a finite grid of the case's
    shape, the inner asserted, no unconverged solve, kernel #1 launched in
    every solve on a lattice (the route off the lattice runs no kernel)
    and #2 in every solve of a fused-cg-cuda case, and the same outer
    rounds (per step in a step loop; the Newton
    and linear iterations per step in a Newton loop; the iterations of a
    solve off the lattice) on every solve (with `bitwise`, the same grid
    bit for bit; with `step_outer`, the per-step outer every solve
    reports)."""
    from pdebench_tpu_torch.oracle import base
    from pdebench_tpu_torch.solvers import gmg_fused, stencil_kernel

    for cid, (ref_err, tol, inner_want, *pc_want) in want.items():
        warm, total, rounds_seen, grids = [], [], set(), []
        for _ in range(SOLVES):
            base.clear_setup_caches()
            before = stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES
            res = solver.solve(cases[cid])
            n1, n2 = stencil_kernel.LAUNCHES - before[0], gmg_fused.LAUNCHES - before[1]
            info = res.solver_info
            grid = np.asarray(res.reference)
            rel = abs(res.baseline_error - ref_err) / ref_err
            if "newton_iterations" in info:
                rounds = (info["newton_iterations"], info["linear_iterations"])
                counts = (f"{info['num_steps']} steps, Newton iterations per step {rounds[0]}, "
                          f"linear iterations per step {rounds[1]}")
            elif "outer_rounds" in info:
                rounds = info["outer_rounds"]
                counts = f"{info['num_steps']} steps, outer rounds per step {rounds}"
            else:
                rounds = info.get("iterations")
                counts = f"iterations {rounds}"
            say(phase, f"{cid}: baseline_error {res.baseline_error!r} (recorded "
                       f"{ref_err!r}, rel {rel:.2e}, tol {tol:g}); baseline_time "
                       f"{res.baseline_time:.4f} s, t_setup {info['t_setup']:.4f} s, "
                       f"warm solve {info['t_warm']:.4f} s, cold {info['t_cold']:.4f} s; "
                       f"inner {info.get('inner')}, " + counts
                       + f", residual {info.get('residual')}"
                       + (f", host LU: {info['host_lu']}" if "host_lu" in info else "")
                       + (f", step outer {info['step_outer']}" if "step_outer" in info else "")
                       + (f", pc {info['pc_used']}, levels (shape, taps) {info.get('gmg_levels')}"
                          if pc_want else "")
                       + f"; launches in this solve (cold and warm runs): #1 {n1}, #2 {n2}")
            check_grid(cid, cases[cid], grid)
            if not rel <= tol:
                raise AssertionError(f"{cid}: baseline_error off by {rel:.2e}")
            if (info.get("inner") != inner_want or "iterative_failed" in info
                    or (pc_want and info.get("pc_used") != pc_want[0])
                    or (step_outer is not None and info.get("step_outer") != step_outer)):
                raise AssertionError(f"{cid}: inner {info.get('inner')}, {info}")
            on_lattice = not inner_want.startswith(OFF_LATTICE_ROUTES)
            if (on_lattice and n1 < 1) or (inner_want == "fused-cg-cuda" and n2 < 1):
                raise AssertionError(f"{cid}: kernel launches #1 {n1}, #2 {n2}")
            rounds_seen.add(repr(rounds))
            grids.append(grid)
            warm.append(info["t_warm"])
            total.append(res.baseline_time)
        if len(rounds_seen) != 1:
            raise AssertionError(f"{cid}: the outer rounds moved between solves: {rounds_seen}")
        if bitwise:
            same_bits(phase, cid, grids)
        say(phase, f"{cid} over {SOLVES} solves: warm solve median "
                   f"{statistics.median(warm):.4f} s ({min(warm):.4f}-{max(warm):.4f}), "
                   f"baseline_time median {statistics.median(total):.4f} s "
                   f"({min(total):.4f}-{max(total):.4f})")


def check_amg_vcycle(config, dev):
    """(16a) SA-AMG's V-cycle on the card: the hierarchy of the case's
    constrained stiffness built on the host, once with its levels on the
    card and once on the CPU; one V-cycle of each on the same seeded
    residual within TOL_F64 / TOL_F32 relative, twice on the card bit for
    bit, its CUDA-event time beside a bound: every level's A, P and P^T
    (values and 4-byte column indices, padding not counted) and the
    coarsest level's dense inverse read once, over the HBM rate."""
    from pdebench_tpu_torch.fem.assemble import LocalOperator, local_stiffness
    from pdebench_tpu_torch.oracle import base, scalar
    from pdebench_tpu_torch.solvers import amg

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, pde["manufactured_solution"]["u"])
    ctx = scalar.setup_scalar(config, "cpu")
    kappa = base.coefficient_fn(pde.get("coefficients", {}).get("kappa"), ctx.dim, "cpu")
    K = torch.as_tensor(local_stiffness(ctx.cb, kappa(ctx.qpts())))
    A = LocalOperator(K, ctx.space.dofmap_scalar, ctx.space.ndof).to_scipy()
    mask = ctx.mask.numpy()
    t0 = time.perf_counter()
    M64, M32, hier = amg.setup_amg_masked_pair(A, mask, device=dev)
    t_setup = time.perf_counter() - t0
    C64, C32, _ = amg.setup_amg_masked_pair(A, mask)
    for i, lv in enumerate(hier.levels):
        say("16a", f"level {i}: {lv.A.shape[0]} rows, nnz A {lv.A.nnz} P {lv.P.nnz} "
                   f"(P^T {lv.R.nnz}), padded row widths A {lv.A.cols.shape[1]} P "
                   f"{lv.P.cols.shape[1]} P^T {lv.R.cols.shape[1]}, omega {lv.omega:.6f}")
    say("16a", f"coarsest level {hier.coarse_inv.shape[0]} rows (dense pseudo-inverse); host "
               f"setup with the levels on the card {t_setup:.3f} s")
    r = np.random.default_rng(16).standard_normal(A.shape[0])
    for dtype, M, C, tol in ((torch.float64, M64, C64, TOL_F64), (torch.float32, M32, C32, TOL_F32)):
        rd = torch.as_tensor(r, device=dev).to(dtype)
        z1, z2 = M(rd), M(rd)
        zc = C(torch.as_tensor(r).to(dtype))
        err = float((z1.cpu() - zc).abs().max() / zc.abs().max())
        if not torch.equal(z1, z2):
            raise AssertionError(f"AMG V-cycle ({dtype}): two calls on the card differ")
        if not err <= tol:
            raise AssertionError(f"AMG V-cycle ({dtype}): {err:.3e} from its CPU twin")
        item = torch.finfo(dtype).bits // 8
        nnz = sum(lv.A.nnz + lv.P.nnz + lv.R.nnz for lv in hier.levels)
        padded = sum(lv.A.cols.numel() + lv.P.cols.numel() + lv.R.cols.numel() for lv in hier.levels)
        nbytes = nnz * (item + 4) + hier.coarse_inv.numel() * item
        ms = median_ms(lambda: M(rd))
        say("16a", f"V-cycle {str(dtype)[6:]}: max rel diff to the CPU twin {err:.3e} (tol {tol:g}), "
                   f"bit-identical on a second call; {ms:.4f} ms a call (CUDA events), bound "
                   f"{1e3 * nbytes / HBM_BYTES_S:.4f} ms ({nbytes} bytes: nnz {nnz}, stored "
                   f"with padding {padded})")


def guide_quickstart() -> str:
    """The torch library guide's quick-start Poisson solver, verbatim."""
    import re

    path = os.path.join(ROOT, "pdebench_tpu_torch", "docs", "PDEBENCH_TPU_TORCH_GUIDE.md")
    with open(path) as fh:
        blocks = re.findall(r"```python\n(.*?)```", fh.read(), flags=re.S)
    return next(b for b in blocks if "local_stiffness(cb, kappa_q)" in b)


def drive_harness(case_id, config, record, tol):
    """(19) The benchmark harness on the card: torch_run_benchmark's
    run_single_case on `case_id` with the mock agent serving the torch
    guide's quick-start (PDEBENCH_MOCK_RESPONSE_FILE), library "torch",
    device "cuda", results in a temporary directory; the launch counters
    set to 0 just before it and returned just after. Fails if the oracle
    gave the sentinel, its baseline_error is off the record by more than
    `tol` relative, the agent's run is not exec_valid or its error is above
    target_error. Then the oracle runner CLI in a subprocess on the same
    case: its reference.npy against the harness run's grid."""
    import tempfile

    from pdebench_tpu_torch.solvers import gmg_fused, stencil_kernel

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_run_benchmark as trb

    case = next(c for c in trb.load_benchmark_cases(
        trb.find_data_file("v2", None), [case_id], None, "torch"))
    with tempfile.TemporaryDirectory() as tmp:
        resp = os.path.join(tmp, "response.md")
        with open(resp, "w") as fh:
            fh.write("```python\n" + guide_quickstart() + "```\n")
        before = os.environ.get("PDEBENCH_MOCK_RESPONSE_FILE")
        os.environ["PDEBENCH_MOCK_RESPONSE_FILE"] = resp
        try:
            stencil_kernel.LAUNCHES = gmg_fused.LAUNCHES = 0
            t0 = time.perf_counter()
            result = trb.run_single_case(case, "mock", None, trb.Path(tmp) / "results", "torch",
                                         timeout_sec=300, device="cuda")
            wall = time.perf_counter() - t0
            counts = {"stencil_apply": stencil_kernel.LAUNCHES, "gmg_fused_cg": gmg_fused.LAUNCHES}
        finally:
            if before is None:
                os.environ.pop("PDEBENCH_MOCK_RESPONSE_FILE", None)
            else:
                os.environ["PDEBENCH_MOCK_RESPONSE_FILE"] = before
        cache = os.path.join(str(trb.oracle_cache_dir(trb.Path(tmp) / "results", "torch", "cuda")),
                             f"{case_id}.json")
        with open(cache) as fh:
            oracle = json.load(fh)
        if oracle.get("reference") is None:
            raise AssertionError(f"(19) the oracle gave the sentinel: {oracle}")
        grid = np.array([np.nan if v is None else v for v in oracle["reference"]],
                        dtype=np.float64).reshape(oracle["reference_shape"])
        rel = abs(oracle["error"] - record) / record
        info = oracle["solver_info"]
        say("19", f"harness run of {case_id} in {wall:.1f} s: gate {result['status']}, "
                  f"fail_reason {result['fail_reason']}, oracle time {oracle['time']:.4f} s "
                  f"(inner {info.get('inner')}), agent time {result['time']:.4f} s, agent error "
                  f"{result['error']!r} (target {result['target_error']!r}), oracle "
                  f"baseline_error {oracle['error']!r} (recorded {record!r}, rel {rel:.2e}, "
                  f"tol {tol:g}); launches {counts}")
        check_grid(case_id, config, grid)
        if not rel <= tol:
            raise AssertionError(f"(19) oracle baseline_error off the record by {rel:.2e}")
        if not result["gate_breakdown"]["exec_valid"]:
            raise AssertionError(f"(19) the agent's run is not exec_valid: "
                                 f"{result.get('error_message')}\n{result.get('stderr')}")
        if result["error"] is None or not result["error"] <= result["target_error"]:
            raise AssertionError(f"(19) agent error {result['error']} above target "
                                 f"{result['target_error']}")
        for name, n in counts.items():
            if n < 1:
                raise AssertionError(f"(19) {name} never launched in the harness run: {counts}")

        # the runner CLI, a process of its own, on the same case
        spec = os.path.join(tmp, "case.json")
        with open(spec, "w") as fh:
            json.dump(case, fh)
        out = os.path.join(tmp, "runner")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pdebench_tpu_torch.oracle.runner", spec, out],
            capture_output=True, text=True, cwd=ROOT, timeout=300,
        )
        t_cli = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"(19) runner CLI failed ({proc.returncode}): {proc.stderr[-2000:]}")
        cli = np.load(os.path.join(out, "reference.npy"))
        with open(os.path.join(out, "meta.json")) as fh:
            meta = json.load(fh)
        same = np.array_equal(cli, grid, equal_nan=True)
        diff = float(np.nanmax(np.abs(cli - grid))) if cli.shape == grid.shape else float("nan")
        say("19", f"runner CLI in {t_cli:.1f} s: baseline_error {meta['baseline_error']!r}, "
                  f"reference.npy {'equals the harness grid bit for bit' if same else 'differs from the harness grid'}"
                  f" (max |diff| {diff:.3e}; inner {meta['solver_info'].get('inner')} vs "
                  f"{info.get('inner')}, iterations {meta['solver_info'].get('iterations')} vs "
                  f"{info.get('iterations')})")
        if not (cli.shape == grid.shape and np.nanmax(np.abs(cli - grid)) <= 1e-8 * np.nanmax(np.abs(grid))):
            raise AssertionError(f"(19) runner CLI grid off the harness grid by {diff:.3e}")
    return counts


def halo_lattice(config, device):
    """The case's f32 lattice operator (scalar, or block for elasticity),
    built through the port's setup path, without a hierarchy."""
    from pdebench_tpu_torch.fem.assemble import local_elasticity, local_stiffness
    from pdebench_tpu_torch.oracle import base, linear_elasticity, scalar

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, pde["manufactured_solution"]["u"])
    if pde["type"] == "linear_elasticity":
        lam, mu = linear_elasticity.lame_from_params(pde["pde_params"])
        ctx = scalar.setup_scalar(config, device, ncomp=-1)
        return scalar.maybe_block_lattice32(ctx, local_elasticity(ctx.cb, mu, lam))
    ctx = scalar.setup_scalar(config, device)
    kappa = base.coefficient_fn(pde["coefficients"]["kappa"], ctx.dim, device)
    return scalar.maybe_lattice32(ctx, local_stiffness(ctx.cb, kappa(ctx.qpts())))


def sweep_records(ids):
    """The recorded baseline_error of each case (results/oracle_sweep_progress.jsonl)."""
    out = {}
    with open(os.path.join(ROOT, "results", "oracle_sweep_progress.jsonl")) as fh:
        for line in fh:
            r = json.loads(line)
            if r.get("case_id") in ids and r.get("ok"):
                out[r["case_id"]] = r["baseline_error"]
    return out


def drive_halo(cases, dev, report, launches):
    """Phase 20, the multi-device module on ranks sharing the card. (20a)
    the stencil kernel on a middle rank's extended stripe at 4 ranks
    against its plain version (the kernels line's numbers), and each
    case's stripes on 2 and 4 ranks, gathered, against the whole-lattice
    launch bit for bit, one launch a rank; (20b) the three cases at full
    size through dispatch's halo route (every rank an
    OracleSolver(device="cuda").solve) against the single-device solve on
    this process; (20c) the dry run's legs (dryrun_multichip(4, "cuda"))
    in the 4-rank launch, after 20b's. The launches of the 20b solves (each
    rank's count from 0 just before) are the main path's. The bound counts
    the function on the owned rows: their weights and output, u over the
    extended stripe."""
    from types import SimpleNamespace

    from pdebench_tpu_torch.oracle import OracleSolver
    from pdebench_tpu_torch.parallel import Group, HaloStencilOperator, launch
    from pdebench_tpu_torch.parallel.dryrun import (
        HALO_GRID_TOL, check_halo_route, dryrun_legs, halo_apply, oracle_solve, run_legs,
    )
    from pdebench_tpu_torch.solvers import stencil_kernel

    rng = np.random.default_rng(20)
    records = sweep_records(set(HALO))
    lats, us, wholes = {}, {}, {}
    for cid, name in HALO.items():
        lat = lats[cid] = halo_lattice(cases[cid], dev)
        hop = HaloStencilOperator.from_lattice_operator(lat, Group(1, 4, dev))
        plan = hop.plan
        n_ext, K = int(np.prod(plan.shape)), len(hop.offsets)
        n = n_ext // plan.shape[0] * hop.stripes.local  # the owned sites
        block = hop.ncomp > 1
        u_ext = torch.as_tensor(rng.standard_normal(plan.u_shape), device=dev)
        stencil_line("20a", name, f"{cid} (a middle rank's stripe of 4)",
                     SimpleNamespace(apply_grid_w=plan, plan=plan, offsets=hop.offsets, pad=hop.pad),
                     hop.W, u_ext,
                     stencil_kernel.block_stencil_plain if block else stencil_kernel.stencil_plain,
                     TOL_F64, report,
                     K * 4 * n + 2 * (n_ext + n) if block else K * n + n_ext + n,
                     4 * _taps_flops(K, n) + 2 * n if block else _taps_flops(K, n))
        us[cid] = rng.standard_normal(lat.grid_shape)
        wholes[cid] = lat.apply_grid_w(lat.W_f64, torch.as_tensor(us[cid], device=dev)).cpu().numpy()
    single = {}
    for cid in HALO:
        t0 = time.perf_counter()
        single[cid] = OracleSolver(device=dev).solve(copy.deepcopy(cases[cid]))
        info = single[cid].solver_info
        say("20b", f"{cid} on one device: inner {info['inner']}, baseline_error "
                   f"{single[cid].baseline_error!r}, t_warm {info['t_warm']:.4f} s "
                   f"({time.perf_counter() - t0:.1f} s with setup)")
    for ranks in HALO_RANKS:
        legs = [(halo_apply, (lats[cid].W_f64.cpu().numpy(), lats[cid].offsets, lats[cid].ncomp,
                              us[cid])) for cid in HALO]
        legs += [(oracle_solve, (copy.deepcopy(cases[cid]),)) for cid in HALO]
        if ranks == 4:
            legs.append((dryrun_legs, ()))
        t0 = time.perf_counter()
        out = launch(run_legs, ranks, dev.type, legs)
        say("20", f"{ranks} ranks sharing the card: the launch (spawn, setup, applies, 3 cases"
                  f"{', the dry run' if ranks == 4 else ''}) took {time.perf_counter() - t0:.1f} s")
        for cid, got in zip(HALO, out[:len(HALO)]):
            diff = float(np.abs(got["y"] - wholes[cid]).max())
            say("20a", f"{cid} {'x'.join(map(str, lats[cid].grid_shape))} on {ranks} ranks: "
                       f"max |halo - whole-lattice| {diff:.3e}, stencil kernel launches per rank "
                       f"{got['launches']}")
            if not np.array_equal(got["y"], wholes[cid]) or got["launches"] != [1] * ranks:
                raise AssertionError(f"halo apply of {cid} on {ranks} ranks: diff {diff}, "
                                     f"launches {got['launches']}")
        for cid, got in zip(HALO, out[len(HALO):2 * len(HALO)]):
            info = got["solver_info"]
            check_grid(cid, cases[cid], got["grid"])
            rel = check_halo_route(cid, got, single[cid].reference, ranks)
            rec = records[cid]
            say("20b", f"{cid} on {ranks} ranks: pc_used {info['pc_used']} ({info['halo_backend']}), "
                       f"{info['iterations']} CG iterations, residual {info['residual']:.3e}, grid "
                       f"{rel:.3e} from the single-device grid (tol {HALO_GRID_TOL:g}), "
                       f"baseline_error {got['baseline_error']!r} ({abs(got['baseline_error'] - rec) / rec:.2e} "
                       f"from the record {rec!r}), t_warm {info['t_warm']:.4f} s, of it exchange "
                       f"{info['halo_exchange_s']:.4f} s and reductions {info['halo_reduce_s']:.4f} s "
                       f"(rank 0), stencil kernel launches per rank {got['launches']}")
            launches[HALO[cid]] = launches.get(HALO[cid], 0) + sum(got["launches"])
        if ranks == 4:
            say("20c", f"dryrun_multichip(4, {dev.type!r})'s legs passed: {json.dumps(out[-1])}")


def main() -> int:
    t_start = time.perf_counter()
    # (0) the card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pdebench_tpu_torch import _build
    from pdebench_tpu_torch.oracle import OracleSolver
    from pdebench_tpu_torch.solvers import gmg_fused, stencil_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("0", f"torch {torch.__version__} cuda {torch.version.cuda} "
             f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # (1) build: one nvcc per source, all started together
    sources = ("stencil_apply", "gmg_fused_cg", "gmg_fused_gmres", "gmg_fused_block_cg",
               "gmg_fused_dyn_block")
    t0 = time.perf_counter()
    _build.load_all(sources)
    say("1", f"built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        usage = [ln.strip() for ln in _build.BUILD_LOG.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        say("1", f"{name}: " + " | ".join(usage))

    cases = load_cases(set(POISSON) | set(HELMHOLTZ) | set(ELASTICITY) | set(LATTICE_3D)
                       | set(NAVIER_STOKES) | set(HEAT_2D) | set(HEAT_3D) | set(BIHARMONIC)
                       | set(CONVDIFF) | set(REACTION_DIFFUSION) | set(BURGERS) | set(STOKES_2D)
                       | set(STOKES_3D) | set(WAVE_LSHAPE) | set(WAVE_TJUNC) | set(OFF_LATTICE)
                       | set(CELL_LOCAL) | set(STOKES_AMG) | set(LE_3D) | set(HALO)
                       | {OWN_OPERATOR})
    cases.update(darcy_cases(cases))
    p_ops = {cid: poisson_operator(cases[cid], dev) for cid in POISSON}
    h_ops = {cid: helmholtz_operator(cases[cid], dev) for cid in HELMHOLTZ}
    e_ops = {cid: elasticity_operator(cases[cid], dev) for cid in ELASTICITY}
    # 3-D kernel forms: kernel #2 on both Poisson hierarchies (33^3, 29^3),
    # #6 on helmholtz_3d_k1_trig's 33^3 surrogate hierarchy, #3 on the
    # 25^3 one of the same case at mesh resolution 12 (the main path's
    # only kernel #3 route in 3-D) and, as an extra check, on the 33^3 one
    p3_ops = {cid: poisson_operator(cases[cid], dev)
              for cid in ("poisson_3d_smooth_trig", "poisson_3d_kappa_expr")}
    h3_ops = {cid: helmholtz_operator(cases[cid], dev)
              for cid in ("helmholtz_3d_k1_trig", "helmholtz_3d_k1_trig@12")}
    rng = np.random.default_rng(0)
    report = {}

    # (2) stencil kernel vs plain at every path's shapes, 2-D and 3-D,
    # scalar and block (elasticity, the Navier-Stokes velocity block)
    check_stencil({cid: lat for cid, (lat, _) in p_ops.items()}
                  | {cid: lat for cid, (lat, _, _) in h_ops.items()}
                  | {cid: lat for cid, (lat, _) in p3_ops.items()}
                  | {cid: lat for cid, (lat, _, _) in h3_ops.items()}, rng, dev, report)
    from pdebench_tpu_torch.oracle.navier_stokes import NavierStokesProblem

    check_block_stencil(
        {cid: (lat, (lat.W_f64, lat.W)) for cid, (lat, _) in e_ops.items()}
        | {"navier_stokes_basic": ns_velocity_block(
            NavierStokesProblem(cases["navier_stokes_basic"], dev), rng)},
        rng, dev, report,
    )
    # (3) fused inner CG, (3b) fused Richardson, (3c) fused Arnoldi, (3d)
    # fused block inner CG vs plain; 2-D, then the 3-D forms
    check_fused_cg(p_ops, rng, dev, report, {"poisson_basic": "gmg_fused_cg"})
    check_richardson(h_ops, rng, dev, report, {"helmholtz_basic_k5": "gmg_fused_richardson"})
    check_gmres(h_ops, rng, dev, report, {"helmholtz_k12_exponential_mode": "gmg_fused_gmres",
                                          "helmholtz_basic_k5": "gmg_fused_gmres_k5"})
    check_fused_cg(p3_ops, rng, dev, report, {"poisson_3d_smooth_trig": "gmg_fused_cg_3d"})
    check_richardson(h3_ops, rng, dev, report, {"helmholtz_3d_k1_trig@12": "gmg_fused_richardson_3d"})
    check_gmres({"helmholtz_3d_k1_trig": h3_ops["helmholtz_3d_k1_trig"]}, rng, dev, report,
                {"helmholtz_3d_k1_trig": "gmg_fused_gmres_3d"})
    check_block_cg(e_ops, rng, dev, report)
    check_block_transpose(
        *elasticity_operator(cases["linear_elasticity_nu010"], dev, rough=True), rng, dev
    )
    # (3e) kernel #5 on navier_stokes_basic's hierarchy, with PyTorch's
    # default cuDNN TF32 setting from here on: the port's coarsening must
    # not depend on it
    torch.backends.cudnn.allow_tf32 = True
    check_dyn_block(NavierStokesProblem(cases["navier_stokes_basic"], dev), rng, dev, report)
    # (3f) kernel #2 on the mass-dominated hierarchies of heat's A = M + dt
    # K, one PCG step and the 12 of a heat round; kernel #1's f64 mass apply
    heat_ops = {cid: heat_operator(cases[cid], dev)
                for cid in ("heat_large_kappa_fast_diffusion", "heat_3d_basic_decay")}
    for cid, (lat, mask, (mass, W64)) in heat_ops.items():
        n, K = int(np.prod(mass.shape)), len(mass.offsets)
        u = torch.as_tensor(rng.standard_normal(mass.shape), device=dev)
        stencil_line("3f", f"stencil_apply_{len(mass.shape)}d", f"{cid} (mass, f64)", mass, W64,
                     u, stencil_kernel.stencil_plain, TOL_F64, report, (K + 2) * n,
                     _taps_flops(K, n))
    check_fused_cg({cid: (lat, mask) for cid, (lat, mask, _) in heat_ops.items()}, rng, dev,
                   report, {"heat_large_kappa_fast_diffusion": "gmg_fused_cg_heat",
                            "heat_3d_basic_decay": "gmg_fused_cg_heat_3d"}, iters=12, phase="3f")

    # (3g) the per-step weights of Burgers and of a reaction Jacobian, and
    # kernel #1 with them; kernel #2 at 12 PCG steps on the hierarchy of a
    # linear reaction's step operator
    sw_ops = {cid: step_weight_operator(cases[cid], dev)
              for cid in ("burgers_square_v1", "reaction_diffusion_allen_cahn_p2")}
    check_step_weights(sw_ops, rng, dev, report)
    # (21a) the new callers of kernels #6 and #3 (the route switches): #6
    # on burgers_square_v1's constrained step weights at its m = 20, #3's 2
    # V-cycles on its constant part's hierarchy, #6 on the own-operator
    # hierarchy of OWN_OPERATOR at m = 30
    from pdebench_tpu_torch.oracle import burgers

    bops = sw_ops["burgers_square_v1"]
    check_step_gmres("burgers_square_v1", bops, burgers.INNER_ITERS, rng, dev, report,
                     "gmg_fused_gmres_step")
    check_richardson({"burgers_square_v1": (bops[5], bops[6], None)}, rng, dev, report,
                     {"burgers_square_v1": "gmg_fused_richardson_step"}, phase="21a")
    check_gmres({OWN_OPERATOR: convdiff_operator(cases[OWN_OPERATOR], dev)}, rng, dev, report,
                {OWN_OPERATOR: "gmg_fused_gmres_own"}, phase="21a")
    del sw_ops, bops
    check_fused_cg({"reaction_diffusion_linear_basic": rd_operator(
        cases["reaction_diffusion_linear_basic"], dev)}, rng, dev, report,
        {"reaction_diffusion_linear_basic": "gmg_fused_cg_rd"}, iters=12, phase="3g")

    # (3h) kernel #3 on stokes_basic's velocity hierarchy, #1's d = 3 block
    # form on stokes_3d_basic's velocity block
    from pdebench_tpu_torch.oracle.stokes import StokesProblem

    stokes_kernel_ops(StokesProblem(cases["stokes_basic"], dev),
                      StokesProblem(cases["stokes_3d_basic"], dev), rng, dev, report)

    # (3i) wave on masked lattices: kernel #1's f64 mass and stiffness
    # applies on wave_lshape_trig_cos's 177^2 and wave_tjunc_cos2's 105 x 161
    # masked lattices (absent sites zero, as the oracle embeds them), and
    # kernel #2 at one PCG step and at wave's 12 on both masked hierarchies
    check_wave_kernels({cid: wave_operator(cases[cid], dev)
                        for cid in ("wave_lshape_trig_cos", "wave_tjunc_cos2")}, rng, dev, report)

    # (16a) SA-AMG's V-cycle on poisson_circle_sinsin's constrained
    # stiffness (23,009 dofs): the card against its CPU twin, and itself
    check_amg_vcycle(cases["poisson_circle_sinsin"], dev)

    # (18k) the stencil kernel's d = 3 block form on le_3d_multifreq_mms'
    # 25^3 lattice, f32 (the inner's operator and the V-cycle's finest
    # level) and f64 (the outer residual)
    check_block3_elasticity(cases["le_3d_multifreq_mms"], rng, dev, report)

    # (4) the Poisson main path, (5) the Helmholtz main path, (6) the
    # elasticity main path, (7) the 3-D main path, (8) the Navier-Stokes
    # main path: OracleSolver on the
    # card, the counters set to 0 just before each and read after; each
    # path maps its entries of the kernels line to the counters they read
    # (one stencil kernel: stencil_apply_2d, _3d and _block_2d are its
    # launches on the 2-D scalar, 3-D and block paths)
    solver = OracleSolver(device="cuda")
    launches = {}
    paths = (
        ("4", {cid: (e, t, "fused-cg-cuda", o, 25) for cid, (e, t, o) in POISSON.items()},
         {"stencil_apply_2d": "stencil_apply", "gmg_fused_cg": "gmg_fused_cg"}),
        ("5", {cid: (e, t, i, o, 30) for cid, (e, t, i, o) in HELMHOLTZ.items()},
         {"stencil_apply_2d": "stencil_apply", "gmg_fused_richardson": "gmg_fused_richardson",
          "gmg_fused_gmres": "gmg_fused_gmres"}),
        ("6", {cid: (e, t, "fused-block-cg-cuda", o, 25) for cid, (e, t, o) in ELASTICITY.items()},
         {"stencil_apply_block_2d": "stencil_apply", "gmg_fused_block_cg": "gmg_fused_block_cg"}),
        ("7", LATTICE_3D,
         {"stencil_apply_3d": "stencil_apply", "gmg_fused_cg_3d": "gmg_fused_cg",
          "gmg_fused_richardson_3d": "gmg_fused_richardson", "gmg_fused_gmres_3d": "gmg_fused_gmres"}),
        ("8", NAVIER_STOKES, {"stencil_apply_block_2d": "stencil_apply",
                              "gmg_fused_dyn_block_vcycle": "gmg_fused_dyn_block"}),
        # (9) heat in 2-D, (9b) in 3-D, (10) biharmonic, (11) convection-
        # diffusion
        ("9", HEAT_2D, {"stencil_apply_2d": "stencil_apply", "gmg_fused_cg_heat": "gmg_fused_cg"}),
        ("9b", HEAT_3D, {"stencil_apply_3d": "stencil_apply",
                         "gmg_fused_cg_heat_3d": "gmg_fused_cg"}),
        ("10", BIHARMONIC, {"stencil_apply_2d": "stencil_apply", "gmg_fused_cg": "gmg_fused_cg"}),
        ("11", CONVDIFF, {"stencil_apply_2d": "stencil_apply"}),
        # (12) reaction-diffusion, (13) Burgers
        ("12", REACTION_DIFFUSION, {"stencil_apply_2d_step": "stencil_apply",
                                    "gmg_fused_cg_rd": "gmg_fused_cg"}),
        ("13", BURGERS, {"stencil_apply_2d_step": "stencil_apply"}),
        # (14) Stokes on 2-D lattices, (14b) on 3-D ones
        ("14", STOKES_2D, {"stencil_apply_block_2d": "stencil_apply",
                           "gmg_fused_richardson_stokes": "gmg_fused_richardson"}),
        ("14b", STOKES_3D, {"stencil_apply_block_3d": "stencil_apply"}),
        # (15) wave on the masked l_shape lattices (square), (15b) on the
        # masked t_junction one (non-square)
        ("15", WAVE_LSHAPE, {"stencil_apply_2d_masked": "stencil_apply",
                             "gmg_fused_cg_masked": "gmg_fused_cg"}),
        ("15b", WAVE_TJUNC, {"stencil_apply_2d_masked_nonsquare": "stencil_apply",
                             "gmg_fused_cg_masked_nonsquare": "gmg_fused_cg"}),
        # (16) Poisson, biharmonic, Helmholtz and elasticity off the
        # lattice: SA-AMG or Jacobi Krylov, no kernel of the table
        ("16", OFF_LATTICE, {}),
        # (17) wave, Burgers, reaction-diffusion and steady convection-
        # diffusion off the lattice (the cell-local step loops, wave's and
        # the surrogate's SA-AMG), (17b) Stokes with the saddle AMG: no
        # kernel of the table; two solves of a case give the same bits
        ("17", CELL_LOCAL, {}),
        ("17b", STOKES_AMG, {}),
        # (18) 3-D elasticity on unit_cube block lattices: the d = 3 block
        # form in every level apply of the PyTorch block V-cycle and in the
        # f64 residual; (18b) Darcy, the elliptic form on kernel #2 and a
        # mixed form on the host LU; (18c) hyperelasticity and
        # Cahn-Hilliard, no kernel of the table
        ("18", LE_3D, {"stencil_apply_block_3d_elasticity": "stencil_apply"}),
        ("18b", DARCY, {"stencil_apply_2d": "stencil_apply", "gmg_fused_cg": "gmg_fused_cg"}),
        ("18c", NORTHSTAR, {}),
    )
    drive_path = {"8": drive_ns, "9": drive_cases, "9b": drive_cases, "10": drive_cases,
                  "11": drive_cases, "12": drive_cases, "13": drive_cases, "14": drive_stokes,
                  "14b": drive_stokes, "15": drive_cases, "15b": drive_cases, "16": drive_cases,
                  "17": lambda *a: drive_cases(*a, bitwise=True),
                  "17b": lambda *a: drive_stokes(*a, bitwise=True),
                  "18": lambda *a: drive_cases(*a, bitwise=True),
                  "18b": lambda *a: drive_cases(*a, bitwise=True), "18c": drive_northstar}
    for phase, want, entries in paths:
        stencil_kernel.LAUNCHES = 0
        gmg_fused.LAUNCHES = gmg_fused.LAUNCHES_RICHARDSON = gmg_fused.LAUNCHES_GMRES = 0
        gmg_fused.LAUNCHES_BLOCK = gmg_fused.LAUNCHES_BLOCK_RICHARDSON = 0
        gmg_fused.LAUNCHES_DYN_BLOCK = 0
        t_phase = time.perf_counter()
        drive_path.get(phase, drive)(solver, cases, want, phase)
        t_phase = time.perf_counter() - t_phase
        counts = {
            "stencil_apply": stencil_kernel.LAUNCHES,
            "gmg_fused_cg": gmg_fused.LAUNCHES,
            "gmg_fused_richardson": gmg_fused.LAUNCHES_RICHARDSON,
            "gmg_fused_gmres": gmg_fused.LAUNCHES_GMRES,
            "gmg_fused_block_cg": gmg_fused.LAUNCHES_BLOCK,
            "gmg_fused_block_richardson": gmg_fused.LAUNCHES_BLOCK_RICHARDSON,
            "gmg_fused_dyn_block": gmg_fused.LAUNCHES_DYN_BLOCK,
        }
        say(phase, f"kernel launches on this main path: {counts}; the phase took {t_phase:.1f} s")
        for entry, counter in entries.items():
            if counts[counter] < 1:
                raise AssertionError(f"{counter} never launched on main path {phase}: {counts}")
            launches[entry] = launches.get(entry, 0) + counts[counter]

    # (19) the benchmark harness on poisson_basic: the port's oracle (kernels
    # #1 and #2, the counters set to 0 just before the run) and the agent's
    # solver in the sandbox on the card; its entries report the kernels at
    # poisson_basic's shapes, measured in phases 2 and 3
    t_phase = time.perf_counter()
    counts = drive_harness("poisson_basic", cases["poisson_basic"], POISSON["poisson_basic"][0],
                           POISSON["poisson_basic"][1])
    say("19", f"kernel launches on this main path: {counts}; the phase took "
              f"{time.perf_counter() - t_phase:.1f} s")
    launches["stencil_apply_2d_harness"] = counts["stencil_apply"]
    launches["gmg_fused_cg_harness"] = counts["gmg_fused_cg"]
    report["stencil_apply_2d_harness"] = report["stencil_apply_2d"]
    report["gmg_fused_cg_harness"] = report["gmg_fused_cg"]

    # (20) the multi-device module: ranks sharing the card
    t_phase = time.perf_counter()
    drive_halo(cases, dev, report, launches)
    say("20", f"the phase took {time.perf_counter() - t_phase:.1f} s")

    # (21) the reference's route switches, each set for its path only
    for phase, env, want, step_outer, entries in SWITCHES:
        stencil_kernel.LAUNCHES = 0
        gmg_fused.LAUNCHES = gmg_fused.LAUNCHES_RICHARDSON = gmg_fused.LAUNCHES_GMRES = 0
        gmg_fused.LAUNCHES_BLOCK = gmg_fused.LAUNCHES_BLOCK_RICHARDSON = 0
        gmg_fused.LAUNCHES_DYN_BLOCK = 0
        t_phase = time.perf_counter()
        with_env(env, drive_cases, solver, cases, want, phase, bitwise=True, step_outer=step_outer)
        t_phase = time.perf_counter() - t_phase
        counts = {"stencil_apply": stencil_kernel.LAUNCHES, "gmg_fused_cg": gmg_fused.LAUNCHES,
                  "gmg_fused_richardson": gmg_fused.LAUNCHES_RICHARDSON,
                  "gmg_fused_gmres": gmg_fused.LAUNCHES_GMRES}
        say(phase, f"switches {env}: kernel launches on this main path: {counts}; the phase took "
                   f"{t_phase:.1f} s")
        for entry, counter in entries.items():
            if counts[counter] < 1:
                raise AssertionError(f"{counter} never launched on main path {phase}: {counts}")
            launches[entry] = launches.get(entry, 0) + counts[counter]
    t_phase = time.perf_counter()
    drive_warm_repeats(solver, "poisson_basic", cases["poisson_basic"], *POISSON["poisson_basic"][:2],
                       "21f")
    say("21f", f"the phase took {time.perf_counter() - t_phase:.1f} s")

    meta = {
        "stencil_apply_2d": ("stencil_apply.cu", "pdebench_tpu/solvers/stencil_pallas.py:131"),
        # the same kernel on 3-D lattices; the reference applies 3-D
        # stencils in XLA (LatticeOperator.apply_grid_w), not in Pallas
        "stencil_apply_3d": ("stencil_apply.cu", "pdebench_tpu/solvers/stencil.py:744"),
        # the same kernel's d = 2 block form; the reference applies block
        # stencils in XLA (BlockLatticeOperator.apply_grid_w, and the
        # Navier-Stokes BlockLatticeWeightMap.apply_grid at :658)
        "stencil_apply_block_2d": ("stencil_apply.cu", "pdebench_tpu/solvers/stencil.py:857"),
        "gmg_fused_cg": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        # mode "richardson" of the same pallas_call
        "gmg_fused_richardson": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        "gmg_fused_gmres": ("gmg_fused_gmres.cu", "pdebench_tpu/solvers/gmg_fused.py:1269"),
        "gmg_fused_block_cg": ("gmg_fused_block_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:723"),
        # the 3-D forms of the same pallas_calls (slab-packed `_Level3`
        # levels in the reference, native (nz, ny, nx) levels here)
        "gmg_fused_cg_3d": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        "gmg_fused_richardson_3d": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        "gmg_fused_gmres_3d": ("gmg_fused_gmres.cu", "pdebench_tpu/solvers/gmg_fused.py:1269"),
        "gmg_fused_dyn_block_vcycle": ("gmg_fused_dyn_block.cu", "pdebench_tpu/solvers/gmg_fused.py:934"),
        # the same pallas_call at heat's 12 PCG steps a round, on the
        # hierarchies of A = M + dt K (2-D P1 121^2, 3-D P2 29^3)
        "gmg_fused_cg_heat": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        "gmg_fused_cg_heat_3d": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        # the stencil kernel with per-step weights (Burgers' advection, a
        # reaction Jacobian: W_c + the bilinear map's build) and the
        # inner CG on a linear reaction's step hierarchy
        "stencil_apply_2d_step": ("stencil_apply.cu", "pdebench_tpu/solvers/stencil_pallas.py:131"),
        "gmg_fused_cg_rd": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        # mode "richardson" on the Stokes velocity block's scalar hierarchy
        # (2 V-cycles a component, the reference's saddle preconditioner)
        "gmg_fused_richardson_stokes": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        # the stencil kernel's d = 3 block form; the reference applies the
        # 3-D Stokes velocity block in XLA (BlockLatticeWeightMap.apply_grid)
        "stencil_apply_block_3d": ("stencil_apply.cu", "pdebench_tpu/solvers/stencil.py:658"),
        # wave's f64 mass and stiffness applies and its inner CG (12 PCG
        # steps a round) on masked lattices: l_shape's 177^2, t_junction's
        # non-square 105 x 161
        "stencil_apply_2d_masked": ("stencil_apply.cu", "pdebench_tpu/solvers/stencil_pallas.py:131"),
        "stencil_apply_2d_masked_nonsquare": ("stencil_apply.cu",
                                              "pdebench_tpu/solvers/stencil_pallas.py:131"),
        "gmg_fused_cg_masked": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        "gmg_fused_cg_masked_nonsquare": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        # the d = 3 block form on 3-D elasticity's lattices and block
        # levels; the reference applies them in XLA
        # (BlockLatticeOperator.apply_grid_w, the block V-cycle's levels)
        "stencil_apply_block_3d_elasticity": ("stencil_apply.cu",
                                              "pdebench_tpu/solvers/stencil.py:857"),
        # the harness run's oracle (phase 19): the same kernels on
        # poisson_basic's 121^2 lattice, launched from
        # scripts/torch_run_benchmark.py's run_single_case
        "stencil_apply_2d_harness": ("stencil_apply.cu", "pdebench_tpu/solvers/stencil_pallas.py:131"),
        "gmg_fused_cg_harness": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        # the stripe applies of dispatch's halo route (phase 20): the
        # reference's halo apply is XLA (dynamic_slice taps in shard_map)
        "stencil_apply_2d_halo": ("stencil_apply.cu", "pdebench_tpu/parallel/halo.py:101"),
        "stencil_apply_block_2d_halo": ("stencil_apply.cu", "pdebench_tpu/parallel/halo.py:101"),
        "stencil_apply_3d_halo": ("stencil_apply.cu", "pdebench_tpu/parallel/halo.py:101"),
        # the new callers of the route switches (phase 21): #6 with a
        # per-step operator (the reference's dispatch.py:223-258), #3 as the
        # per-step preconditioner (:326-342), #6 on a small surrogate and on
        # an own-operator hierarchy (:268-325)
        "gmg_fused_gmres_step": ("gmg_fused_gmres.cu", "pdebench_tpu/solvers/gmg_fused.py:1269"),
        "gmg_fused_richardson_step": ("gmg_fused_cg.cu", "pdebench_tpu/solvers/gmg_fused.py:434"),
        "gmg_fused_gmres_k5": ("gmg_fused_gmres.cu", "pdebench_tpu/solvers/gmg_fused.py:1269"),
        "gmg_fused_gmres_own": ("gmg_fused_gmres.cu", "pdebench_tpu/solvers/gmg_fused.py:1269"),
    }
    # library_ms: no single PyTorch call computes a spatially varying
    # multi-tap stencil, a (block) V-cycle chain, a (block) PCG solve or
    # an Arnoldi cycle
    kernels = [
        dict(name=name, route="cuda", source=f"pdebench_tpu_torch/csrc/{src}",
             replaces=rep, launches=launches[name], library_ms=None, **report[name])
        for name, (src, rep) in meta.items()
    ]
    say("end", f"wall time {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
