#!/usr/bin/env python3
"""Build and drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Run from anywhere inside a checkout (the package is found next to this
file).  Phases, each of which ends the run with a nonzero exit on failure:

1. device: the card, its power limit, torch and CUDA versions; TF32 off;
2. build: every CUDA source of the package, one nvcc each, all at once;
   each kernel's registers, spills and shared memory;
3. kernels against plain: each hand kernel against its plain torch version
   on the card, float32 and bfloat16 cores, at small shapes whose bonds do
   not fill the kernels' tiles (MPS D 40 and 20, MPO D 24 and 48), at the
   main-path shapes (for #1 and #2 also ``FLAGSHIP_WIDE``, every sample
   held), and at the edges of the kernels' reach: MPS rings
   shorter than a site (d 3 at D 120, d 20 at D 24) and x read in place
   (d 900), each for the closing chain (#1) and the carry-returning one (#2,
   float32 and bfloat16 carry); #1 and #2 on their streamed path at every
   bond above 128 (``STREAMED_MPS``: d 2 at D 129, 192, 256 and 520, d 3 at
   D 136, d 4 at D 256), asserting which path launched, and that path's
   yardstick (``mps_chain_streamed``) at the tensor-core shapes above
   (``SMALL_MPS``, ``UNALIGNED_MPS``, ``REACH_MPS``); MPO with W 1, 2, 4,
   5 (Heisenberg) and 8,
   one core buffer where two do not fit, and the cluster path where no
   one-CTA plan fits (d 2, W 7, D 50; d 1, W 9, D 55; Heisenberg at D 65,
   96 and 128; spin-1 Heisenberg at D 128; d 2, W 8, D 64; d 1, W 16,
   D 100), and the streamed path beyond both (``STREAMED_MPO``: d*W 17,
   18, 24 and 42, the spin-1 AKLT chain, Heisenberg at D 129 and 256, fp32
   d 15-16 with W 1 at D 113-128), each asserting which of the MPO
   kernel's paths launched;
4. main path through the user entry points: the three README examples
   through ``examples/torch/readme_examples.py``, the flagship batched ``MPS.evaluate`` (1000 sites x d 2
   x bond 64 x batch 4096, float32), the carry-returning evaluation at the
   same shape, the batched TFIM MPO expectation (50 sites x bond 64 x
   1000 parameter sets), the Heisenberg one at bond 128 (50 sites x
   1000 samples, #3's cluster path: ``cluster_main_path``) and the spin-1
   AKLT one at bond 64 (50 sites x 1000 samples, #3's streamed path:
   ``streamed_main_path``), and the flagship widened to bond 256 through
   ``MPS.evaluate(x, kernel="cuda")`` and ``mps_evaluate_epilogue`` (#1 and
   #2 on their streamed path, once each, the tensor-core path never:
   ``streamed_chain_main_path``); each kernel's
   launch count is zeroed just before its path and read just after, and a
   small sample of each is held against a float64 reference;
5. times: each kernel and its plain version with CUDA events (median of 7
   after a warm-up), beside the least time the card could take for
   fp32-accurate work (GEMMs as 3xTF32 on the tensor cores): #2 under both
   carries, #1 and #2 on their streamed path at ``FLAGSHIP_WIDE`` (N 1000,
   d 2, D 256, B 4096) beside ``mps_evaluate_auto``, #3's cluster path at
   the shape the exact-D kernel last
   timed (d 2, W 7, D 50) and at full width (Heisenberg, D 128, 50 sites,
   1000 samples), and its streamed path at ``STREAMED_TIMED`` (AKLT D 64,
   50 x 1000; Heisenberg D 256, 50 x 256) and, as a yardstick, at the
   cluster path's full width;
6. training paths at the JAX package's published widths: 3 log-MSE SGD
   steps (``make_train_step``) at 512 sites x d 2 x bond 64 x batch 1024 in
   bfloat16 and float32, the float32 step-0 gradient against float64, the
   trained MPS served under ``torch.no_grad()`` through #1 and held against
   the differentiable loop, one step at 511 sites (one site a step), 10
   Born-machine Adam steps at 64 sites x bond 64 x batch 4096, 4096 exact
   samples from the trained model, and a CP fit through ``fit_tn``; no
   training step may launch a hand kernel (they have no backward);
7. graph paths (``GRAPH``), none of which reaches a hand kernel: a
   4096-matrix mixed-bond chain through ``contract(optimize="greedy")`` on
   the bucketed lowering (plan items against steps, its warm time beside the
   per-step loop's, the float64 oracle, ``contract_expression`` and
   ``TN.compile(...).measure_compile()``); a random 3-regular network on the
   native greedy path against the oracle, and on the paths of
   ``"random-greedy"``, ``"random-greedy-128"`` and ``"auto-hq"`` (each
   searched twice, the same path both times); ``bp_contract`` on a 20,000-spin
   3-regular Ising model against its closed-form Bethe free energy (float64
   and float32); imaginary-time TFIM simple-update layers on a 16 x 16
   grid, card against CPU in float64, and the 3 x 3 anchor against exact
   diagonalization; ``bp_ground_state`` on a 32-site TFIM ring, card against
   CPU in float64; the chain's plan items must equal the JAX package's;
8. finite chains (``CHAINS``): two-site DMRG of the 100-site spin-1
   Heisenberg chain built through ``OpSum`` (bond 128, float64;
   the time of each sweep and its split between local solves, SVD splits and
   environment updates; the energy against ITensors.jl's published value),
   its ground state served on 4096 sampled configurations through
   ``MPS.evaluate`` under ``torch.no_grad()`` (#1, exactly one launch, held
   against the plain version); DMRG of the critical 100-site TFIM at bond 64
   against the free-fermion energy; ``dmrg_ensemble`` over 64 TFIM chains in
   one batched call, each against free fermions;
   ``tdvp1_evolve`` of the TFIM ground state under a field quench in
   complex128 (norm and energy conserved); ``itebd_ground_state`` at bond 32
   against -4/pi; an ``OpSum`` Heisenberg MPO against ``heisenberg_mpo``;
   and the split's 384 x 384 float64 SVD under cuSOLVER's drivers;
9. physics chains (``PHYSICS``): charge-masked DMRG of the half-filled 6 x 3
   Hubbard strip (36 spin-orbitals, bond 128 halved while two sweeps' class
   SVDs would not fit the budget; C, each sweep's time and the split's
   share; monotone energies, ``cores * (1 - masks) == 0`` exactly, the
   sector's particle numbers) and its 3 x 2 anchor against sector ED; the
   ground state served as float32 on 4096 ``sample_canonical`` draws
   through #1 (one launch, held against the plain version); TCI of a
   damped cosine on 2^40 points (integral against the closed form of the
   Riemann sum) and the QFT of its 16-bit samples against numpy.fft;
   ``quantics_to_dense`` of the 20-bit quantics MPS as float32 through #1
   (one launch; against the plain version and the float64 samples; #1's
   time at that shape beside its bound); W^II Lindblad evolution of the
   dephased 20-site XXZ chain, the batched correction-vector grid (32
   frequencies) on a 32-site Heisenberg ground state and a 32-trajectory
   MCWF ensemble, each card against CPU; no other path launches a kernel;
10. infinite chains and chemistry (``INFINITE``): VUMPS of the spin-1
   Heisenberg chain (``InfiniteOpSum``, bond grown to 128) against White &
   Huse's energy, the Haldane gap at k = pi by ``excitation_minimum_cell``
   against Haegeman et al., the dense ``excitation_spectrum`` at bond 12
   card against CPU; ``hubbard_vumps`` at half filling with bonds grown to
   128 (the largest halved while over budget) against Lieb-Wu, no entry
   outside the masks; the H8 chain in STO-3G by ``chemistry_dmrg_u1`` at
   bond 128 (monotone, below RHF, N exact) and by ``chemistry_dmrg`` at
   bond 128 against its exact bond-256 run, its ground state served as
   float32 through #1 (one launch, held against the plain version);
   frozen-core water (RHF against the published value, DMRG against FCI);
   ``umps_mpo_evolve`` of the infinite TFIM, card against CPU.

11. 2D and finite temperature (``TWO_D``): CTMRG of the Ising model at
   beta_c (chi 128) against Onsager, card against CPU, and its magnetization
   at beta 0.5 (chi 64) against Yang; TRG (chi 64) and HOTRG (chi 32) against
   Onsager, the HOTRG internal energy by autodiff against Onsager's; the
   critical TFIM MERA (chi 4, sweeps cut to the budget) against -4/pi and the
   sigma dimension 1/8 and held to the JAX package's readings after the same
   sweeps, then ``expand_mera`` to chi 6; ``thermal_itebd`` (bond 64, beta 2)
   card against CPU and against the exact integrals, ``thermal_wii``; the
   thermal IBC correlator of the XX chain against the exact Wick oracle and
   the T = 0 one on a VUMPS Heisenberg ground state, card against CPU; pure
   dephasing against its closed form and ``ness_infinite`` card against CPU;
   the square-root-Boltzmann iPEPS against Yang and ``ipeps_ground_state``
   (D 3, chi 36) card against CPU; ``cp_als`` and ``tucker_hooi`` on 256^3
   tensors against the noise floor, card against CPU.  No path may launch a
   hand kernel.
12. unit cells, iPEPS optimizers, fermionic PEPS and PEPS sampling
   (``PEPS2D``): the directional cell CTMRG of the checkerboard Ising
   antiferromagnet (chi 64) against Onsager-Yang, card against CPU at chi
   16, and the row correlation length above T_c against the exact axial
   value; the checkerboard simple update of the Heisenberg model (D 3, chi
   36) below the D 2 value and above QMC with an alternating staggered
   moment, D 2 card against CPU; ``ipeps_cell_scan`` over 16 TFIM fields in
   one batched program (ordered below h_c, paramagnetic above, two members
   against the unbatched call); the full update and the variational cell
   flow of the Heisenberg model below the simple update, and the C4v
   variational TFIM; the commuting-Ising purification against Onsager and
   Yang; ``fpeps_energy`` against Fock ED, the finite fermionic gradient
   ground state against ED, the p-wave iPEPS against the BdG integral and
   the checkerboard Hubbard antiferromagnet; 4096 exact samples of a 6 x 6
   PEPS against its marginals, the GHZ Born machine and VMC of the 2 x 2
   TFIM against ED.  No path may launch a hand kernel.
13. the 3D family and tree tensor networks (``THREE_D``): 3D HOTRG at
   bench.py's ``bench_hotrg3d`` configuration (chi 12, 10 steps) in float32
   (effective TFLOP/s) and float64, at chi 16 with its peak device memory,
   and the JAX test's closed forms (decoupled chains and layers, the low- and
   high-temperature series, the autodiff energy against central differences,
   the checkerboard flow against the uniform one), card against CPU; the
   cubic-lattice iPEPS of the 3D TFIM against perturbation theory; the
   commuting 3D purification against the classical bond correlation;
   ``ttn_dmrg`` of the 4 x 4 and 8 x 8 snake TFIM against the chain DMRG,
   ``ttn_ground_state`` card against CPU and against ED, and
   ``ttn_tdvp_evolve`` against dense exponentiation.  No path may launch a
   hand kernel.
14. the parallel layer (``PARALLEL``) in a world of one rank over NCCL,
   initialized and destroyed inside the phase, on meshes whose every axis
   has size 1: ``sharded_mps_forward`` at one rank's share of the flagship
   on the dp 4 x sp 2 layout (500 sites x d 2 x bond 64 x batch 1024, fp32;
   its time and peak device memory) in split format against
   ``MPS.evaluate`` (#1, the one launch of the phase); the sharded,
   tensor-parallel and pipelined SGD steps at ``TRAIN`` (3 steps each, the
   first update against ``make_train_step``'s); ``fit_born_machine_sharded``
   at ``BORN`` against ``fit_born_machine``; ``dmrg_uniform_tp`` and
   ``dmrg_realspace`` on the TFIM chain at bond 64 against ``dmrg_uniform``
   (and the tp DMRG at 8 sites against the CPU); ``dmrg_ensemble_sharded``,
   ``ipeps_cell_scan_sharded`` and ``cv_greens_function_sharded`` against
   their batched single-device paths.

The second-to-last line of output is the ``{"kernels": [...]}`` summary, the
last ``{"ok": true, "device": {...}}``.  ``--physics-only``
(``--infinite-only``, ``--2d-only``, ``--peps-only``, ``--3d-only``,
``--parallel-only``) runs phases 1, 2 and 9 (10, 11, 12, 13, 14) alone and
prints neither.  ``--examples-only [name ...]`` runs phases 1 and 2, then
every ``examples/torch/*.py`` script (or those named) on the card, each in
its own process (``examples_phase``), and ends with the ``{"ok": true,
...}`` line.  ``--mpo-times [CHECKOUT [TAG ...]]`` runs phase 1, then times
#3 with the ``contractn_tpu_torch`` of another checkout (default this one)
at ``MPO_TIMED``'s shapes (or the tagged ones), one JSON line each with the
path that launched
(``mpo_times``): two versions of the kernel on one card in one call, the
other unpacked into a directory that ``.gitignore`` lists (``git
archive``), run parent, change, change, parent.  ``--mps-times [CHECKOUT
[TAG ...]]`` does the same for #1 and #2 at ``MPS_TIMED``'s shapes
(``mps_times``: ``FLAGSHIP``, also through the streamed yardstick, and
``FLAGSHIP_WIDE`` and bond 256 at batches 16-256 and at d 16, each beside
``mps_evaluate_auto``; checkouts before the streamed chain path refuse
bond 256 and lack the yardstick, their refusal logged).  Without a GPU, or
without the package beside this file, it exits nonzero and prints no result.
"""

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# Main-path shapes (the JAX package's benchmark configurations)
FLAGSHIP = {"n_sites": 1000, "phys": 2, "bond": 64, "batch": 4096}
MPO_BENCH = {"n_sites": 50, "bond": 64, "batch": 1000}
SMALL_MPS = {"n_sites": 37, "phys": 3, "bond": 40, "batch": 70}
UNALIGNED_MPS = {"n_sites": 9, "phys": 2, "bond": 20, "batch": 33}  # bf16 row of 40 B
SMALL_MPO = {"n_sites": 7, "bond": 24, "batch": 9}
RAGGED_MPO = {"n_sites": 6, "bond": 48, "batch": 5}  # not a multiple of 32
# Edges of the kernels' reach (see the headers of csrc/mps_chain_tc.cu and
# csrc/mpo_env.cu): each runs a code path the shapes above do not
REACH_MPS = (
    {"n_sites": 9, "phys": 3, "bond": 120, "batch": 40},  # fp32 ring of 2 < d
    {"n_sites": 11, "phys": 20, "bond": 24, "batch": 50},  # ring of 8 < d
    {"n_sites": 5, "phys": 900, "bond": 4, "batch": 40},  # x read in place
)
# Bonds above the tensor-core path's reach (128), which #1 and #2 take on
# their streamed path: just past it, d 2 up to D 520, d 3 and 4.  200 rows
# make four row tiles, the last one ragged.  A bf16 comparison counts only
# the samples whose chain is conditioned within 1 / TOL_BF16, and phase 3
# logs how many did.
STREAMED_MPS = tuple({"n_sites": 3, "phys": d, "bond": bond, "batch": 200, "path": "streamed"}
                     for d, bond in ((2, 129), (2, 192), (2, 256), (3, 136), (4, 256),
                                     (2, 520)))
# The flagship widened to bond 256 (524 MB of fp32 cores), the DMRG bond of
# the JAX package's docs: #1 and #2 on the streamed path on the main path
# (phase 4) and timed (phase 5)
FLAGSHIP_WIDE = {**FLAGSHIP, "bond": 256, "path": "streamed"}
REACH_MPO = (
    {"n_sites": 5, "bond": 48, "batch": 16, "mpo": "heisenberg"},  # W 5, fp32 one buffer
    {"n_sites": 5, "bond": 24, "batch": 16, "mpo": "heisenberg"},  # W 5 at D <= 32
    {"n_sites": 5, "bond": 64, "batch": 16, "mpo": (2, 4)},  # W 4 at D 64
    {"n_sites": 5, "bond": 64, "batch": 16, "mpo": (2, 2)},
    {"n_sites": 5, "bond": 64, "batch": 16, "mpo": (3, 1)},
    {"n_sites": 5, "bond": 40, "batch": 16, "mpo": (1, 8)},  # W 8
)
# Shapes no one-CTA plan of the MPO kernel holds, in either dtype: the
# FMA exact-D kernel took these until its cluster path replaced it
EXACT_MPO = (
    {"n_sites": 5, "bond": 50, "batch": 16, "mpo": (2, 7), "path": "cluster"},
    {"n_sites": 5, "bond": 55, "batch": 16, "mpo": (1, 9), "path": "cluster"},
)
EXACT_BENCH = {"n_sites": 50, "bond": 50, "batch": 1000, "mpo": (2, 7), "path": "cluster"}
# The cluster path's reach beyond D 64 and the shapes the card refused
# before it: Heisenberg (W 5) up to D 128, spin-1 Heisenberg (d 3, W 5,
# d*W 15) at D 128, d 2 with W 8 at D 64, d 1 with W 16 at D 100, d 1
# with W 3 at D 65.  A bf16 comparison counts only the samples whose close
# is conditioned within 1 / TOL_BF16: the Heisenberg shapes take 64 samples
# (with 16, one or two qualified at D 65-128), and the spin-1 chain is held
# in fp32 only (none of its 16 samples qualified in bf16, median condition
# 104), d 3 with W 5 in both dtypes on the random diagonal MPO instead.
CLUSTER_MPO = (
    {"n_sites": 5, "bond": 65, "batch": 64, "mpo": "heisenberg", "path": "cluster"},
    {"n_sites": 5, "bond": 96, "batch": 64, "mpo": "heisenberg", "path": "cluster"},
    {"n_sites": 5, "bond": 128, "batch": 64, "mpo": "heisenberg", "path": "cluster"},
    {"n_sites": 5, "bond": 128, "batch": 16, "mpo": "heisenberg_s1", "path": "cluster",
     "dtypes": (torch.float32,)},
    {"n_sites": 5, "bond": 128, "batch": 16, "mpo": (3, 5), "path": "cluster"},
    {"n_sites": 5, "bond": 64, "batch": 16, "mpo": (2, 8), "path": "cluster"},
    {"n_sites": 5, "bond": 100, "batch": 16, "mpo": (1, 16), "path": "cluster"},
    {"n_sites": 5, "bond": 65, "batch": 16, "mpo": (1, 3), "path": "cluster"},
)
# #3 at full width on the cluster path: the Heisenberg chain at kernel #1's
# and the DMRG runs' bond (6.55 GB of fp32 cores)
CLUSTER_BENCH = {"n_sites": 50, "bond": 128, "batch": 1000, "mpo": "heisenberg",
                 "path": "cluster"}
# Shapes neither on-chip path holds, which the streamed path takes: the
# card's former refusals (d 1 with W 17 at D 40; Heisenberg and d 1 with W 1
# at D 129), the smallest d*W above 16 (d 3, W 6), the spin-1 AKLT chain
# (d 3, W 14) and the random diagonal MPO of its (d, W) at D 64, d*W 24 at
# D 160, Heisenberg at D 256, and the fp32 shapes no cluster's layout fits
# (d 15 and 16 with W 1 at D 113 and 128).  A bf16 comparison counts only
# the samples whose close is conditioned within 1 / TOL_BF16: at D 129 that
# was 2-3% of Heisenberg samples and 6-16% of d 1, W 1 ones in CPU draws of
# these inputs, hence 256 and 128 samples.  Held in fp32 only: Heisenberg at
# D 256 (no sample of 256 qualified in bf16, median condition 230-260), and
# d 15-16 with W 1 (in bf16 the cluster path takes them).
STREAMED_MPO = (
    {"n_sites": 5, "bond": 40, "batch": 16, "mpo": (1, 17), "path": "streamed"},
    {"n_sites": 5, "bond": 129, "batch": 256, "mpo": "heisenberg", "path": "streamed"},
    {"n_sites": 5, "bond": 129, "batch": 128, "mpo": (1, 1), "path": "streamed"},
    {"n_sites": 5, "bond": 32, "batch": 16, "mpo": (3, 6), "path": "streamed"},
    {"n_sites": 5, "bond": 64, "batch": 16, "mpo": "aklt", "path": "streamed"},
    {"n_sites": 5, "bond": 64, "batch": 16, "mpo": (3, 14), "path": "streamed"},
    {"n_sites": 5, "bond": 160, "batch": 16, "mpo": (4, 6), "path": "streamed"},
    {"n_sites": 5, "bond": 256, "batch": 64, "mpo": "heisenberg", "path": "streamed",
     "dtypes": (torch.float32,)},
    {"n_sites": 5, "bond": 113, "batch": 16, "mpo": (15, 1), "path": "streamed",
     "dtypes": (torch.float32,)},
    {"n_sites": 5, "bond": 128, "batch": 16, "mpo": (16, 1), "path": "streamed",
     "dtypes": (torch.float32,)},
)
# #3 at full width on the streamed path: the AKLT chain at the main MPO
# shape (2.46 GB of fp32 cores), the main path's; and Heisenberg at bond
# 256, the batch cut to 256 (6.71 GB)
STREAMED_BENCH = {"n_sites": 50, "bond": 64, "batch": 1000, "mpo": "aklt", "path": "streamed"}
STREAMED_WIDE = {"n_sites": 50, "bond": 256, "batch": 256, "mpo": "heisenberg",
                 "path": "streamed"}
# Training paths at the JAX package's published widths: the log-MSE SGD step
# (bench.py:224-267) and the Born machine's exact-NLL Adam step
# (bench.py:270-300); 511 sites is the odd length whose loss runs one site a
# step, the case that once took the kernel and lost its gradient
TRAIN = {"n_sites": 512, "phys": 2, "bond": 64, "batch": 1024, "steps": 3, "lr": 1e-3}
TRAIN_ODD_SITES = 511
BORN = {"n_sites": 64, "bond": 64, "batch": 4096, "steps": 10, "lr": 1e-3}
FIT_TN_STEPS = 60
# Graph paths (phase 7).  LOWERING: an open chain of matrices whose bonds
# alternate 48 and 64 in blocks of 12 (not uniform, so the chain route
# declines it and the pairwise steps are lowered into buckets).  NATIVE: a
# random 3-regular network contracted on the native greedy path and held
# against the float64 numpy oracle; the native path's cost depends on the
# seed (9.5e7 to 3e12 FLOPs over seeds 0-39), and seed 7 (7.3e8 FLOPs,
# largest intermediate 1.0e6 elements) keeps the oracle's unblocked
# np.einsum to a few seconds.
# ISING: the Ising model on a random 3-regular multigraph at beta 0.2, whose
# Bethe free energy is known in closed form.  GRID: imaginary-time TFIM
# simple update on an open grid, card against CPU (2 layers, the fewest
# whose bonds reach max_bond, so truncation is held; 3 until phase 14, 5
# until phase 12); ANCHOR: the
# same on 3 x 3 against exact diagonalization (6 layers a step size, 15
# until phase 14: 8.4e-5 from exact on the card against the 1e-2 limit).  RING: bp_ground_state on a
# TFIM ring, card against CPU (30 descent steps, 50 until the random-greedy
# path joined this phase).  The random-greedy path runs on NATIVE's network.
GRAPH = {
    "lowering": {"n_mats": 4096, "dims": (48, 64), "block": 12, "reps": 2,
                 "jax_plan_items": 1047},
    "native": {"n_nodes": 64, "degree": 3, "bond": 4, "seed": 7},
    "ising": {"n_spins": 20000, "beta": 0.2, "timed_sweeps": 10},
    "grid": {"side": 16, "h": 3.0, "tau": 0.05, "layers": 2, "max_bond": 8},
    "anchor": {"side": 3, "h": 3.0, "taus": (0.2, 0.1, 0.05, 0.02),
               "layers": 6, "max_bond": 4},
    "ring": {"n_sites": 32, "h": 2.0, "bond": 8, "steps": 30, "n_sweeps": 10,
             "lr": 0.02},
}
# Finite-chain paths (phase 8).  SPIN1: the spin-1 Heisenberg chain of
# ITensors.jl's documented DMRG example (N 100, 5 sweeps; its bond schedule
# rises to 200, cut here to one cap of 128, kernel #1's reach, and to 2
# sweeps to make room for phase 13, 3 until then: the second sweep lands
# within 5e-10 of the third), whose ground energy the example prints as
# about -138.94.  TFIM: the critical open chain, held against the
# free-fermion energy (3 sweeps, 5 until phase 13: on the CPU the second
# sweep lands 6e-9 to 2e-8 from it, the third 2e-15).  ENSEMBLE: 64 TFIM chains over a field scan in one
# batched search (2 sweeps, 3 until phase 13, 4 until phase 11: on the CPU
# the worst member is 3.7e-9 from free fermions after two; 24 sites, 32 until
# phase 14, when the search took 22.1-23.3 s).  QUENCH: single-site TDVP
# from the TFIM ground state (h 1 -> 0.5) in complex128, 1 step (2 until
# phase 13, 3 until phase 12, 6 until phase 11; at 10, 64.2 s, with LINDBLAD at 10 too, the
# whole script took 767.1 s on an H100, over its 750 s budget, PERF.md §6).
# ITEBD: the infinite critical chain against -4/pi to the JAX test's 5e-4.
# OPSUM: an OpSum-built Heisenberg MPO against heisenberg_mpo through
# rayleigh.
CHAINS = {
    "spin1": {"n_sites": 100, "bond": 128, "sweeps": 2, "serve_batch": 4096,
              "published": -138.94, "published_tol": 0.01, "seed": 3},
    "tfim": {"n_sites": 100, "h": 1.0, "bond": 64, "sweeps": 3, "rtol": 1e-8,
             "seed": 4},
    "ensemble": {"n_members": 64, "h": (0.5, 1.5), "n_sites": 24, "bond": 32,
                 "sweeps": 2, "rtol": 1e-7, "seed": 5},
    "quench": {"h": 0.5, "dt": 0.05, "steps": 1, "drift_tol": 1e-7,
               "norm_tol": 1e-10},
    "itebd": {"bond": 32, "tol": 5e-4},
    "opsum": {"n_sites": 100, "bond": 16, "rtol": 1e-10, "seed": 6},
    "svd": {"rows": 384, "reps": 5},
}
# Physics chains (phase 9).  HUBBARD: the half-filled (9 up, 9 down) 6 x 3
# open strip of 36 spin-orbitals at ITensors.jl's 2D Hubbard example's
# lattice and couplings (Nx 6, Ny 3, U 4, t 1; the example is a cylinder and
# hubbard2d_mpo builds open strips, so its energy is no oracle here), by
# charge-masked DMRG at bond 128, halved while two sweeps' class SVDs would
# not fit the budget; ANCHOR: the 3 x 2 sector against exact
# diagonalization.  TCI: exp(-x) cos(2 pi 50 x) on 2^40 points against the
# closed form of its Riemann sum, and the QFT of its 16-bit samples against
# numpy.fft.  DENSE: the 20-bit quantics MPS evaluated on every grid point
# through #1.  LINDBLAD: the dephased XXZ chain by W^II, card against CPU,
# 1 step (not 20; at 10 the card and CPU runs took 79.7 s, and the script
# went over its budget, see QUENCH above; 2 until phase 14, when the two
# steps took 3.5 s on the card and 12.2 s on the CPU; 4 until phase 12, 6
# until phase 11).  The trace
# is an overlap with vec(I), whose norm is 2^(n/2): a 2-norm rounding of
# rho of relative size e moves it by up to e 2^(n/2) ||rho|| (about 2e-11 a
# step at 20 sites on the card, growing with the bond, while the discarded
# weight stays below 1e-12), so its tolerance is scaled by that condition
# number, as the kernels' agreement is.
# CV: the batched correction-vector grid on a 32-site Heisenberg ground
# state (found in 2 DMRG sweeps, 4 until phase 14, when they took 7.0 s; card
# and CPU start from the same one), card against CPU at one of the 32
# frequencies, the middle one, omega = 1.55, inside the spectrum (every 16th
# until phase 14, every 8th until phase 13; each frequency is an
# independent member of the batch; the CPU takes 77 s for all 32 at CG 16;
# CG 24 per solve, 32 until phase 12, 64 until phase 11; one sweep, two
# until phase 12).
# At eta 0.1 the local systems (K^2 + eta^2) have condition numbers near
# 1e5, the fixed-depth CG does not converge, and the truncated ALS result
# is determined only to about 1e-7..1e-5 in float64 (a 1e-15 relative
# perturbation of the ground state moves it that far on a CPU), so the card
# must agree with the CPU to 1e-8 or to ten times that spread, measured in
# the same run.  MCWF: a trajectory ensemble of the damped TFIM, card
# against CPU on the same host draws; 32 trajectories, not 64 (64 took 55 s
# on the card and 31 s on the CPU), 1 step of 0.1 (2 until phase 14, when
# the path took 17.9 s; 6 until phase 12, 10 until phase 11, when it took
# 58.8 s).  The bond cap 16 binds (bond 64 moves a
# trajectory's record by 3e-5), so the truncated result is determined only
# as far as near-degenerate singular values at the cut allow: the card must
# agree with the CPU to 1e-10 or to ten times the CPU's own spread under a
# 1e-15 nudge of the start, measured in the same run, with equal jump
# counts.
PHYSICS = {
    "hubbard": {"lx": 6, "ly": 3, "n_up": 9, "n_dn": 9, "t": 1.0, "u": 4.0,
                "bond": 128, "min_bond": 16, "sweeps": 2, "budget_s": 90.0,
                "lanczos_iters": 40, "seed": 21, "serve_batch": 4096,
                "anchor": {"lx": 3, "ly": 2, "n_up": 3, "n_dn": 3, "bond": 96,
                           "sweeps": 2, "tol": 1e-8}},
    "tci": {"n_bits": 40, "freq": 50.0, "max_bond": 16, "tol": 1e-10, "rtol": 1e-9,
            "qft_bits": 16, "qft_tol": 1e-10},
    "dense": {"n_bits": 20, "freq": 50.0, "tol": 1e-5},
    "lindblad": {"n_sites": 20, "steps": 1, "dt": 0.01, "jz": 0.5, "gamma": 0.3,
                 "max_bond": 64, "trace_tol": 1e-10, "tol": 1e-10},
    "cv": {"n_sites": 32, "bond": 32, "dmrg_sweeps": 2, "n_omegas": 32,
           "omegas": (0.0, 3.0), "eta": 0.1, "sweeps": 1, "cg_iters": 24,
           "cpu_at": (16,), "tol": 1e-8, "seed": 22},
    "mcwf": {"n_sites": 16, "n_traj": 32, "steps": 1, "t": 0.1, "h": 1.0,
             "gamma": 0.2, "max_bond": 16, "tol": 1e-10, "seed": 23},
}
# The same paths at a size the CPU rehearses in seconds
# (tests/test_torch_dynamical.py)
PHYSICS_TINY = {
    "hubbard": {"lx": 2, "ly": 2, "n_up": 2, "n_dn": 2, "t": 1.0, "u": 4.0,
                "bond": 32, "min_bond": 16, "sweeps": 2, "budget_s": 60.0,
                "lanczos_iters": 30, "seed": 21, "serve_batch": 64,
                "anchor": {"lx": 2, "ly": 1, "n_up": 1, "n_dn": 1, "bond": 8,
                           "sweeps": 2, "tol": 1e-8}},
    "tci": {"n_bits": 24, "freq": 5.0, "max_bond": 8, "tol": 1e-10, "rtol": 1e-9,
            "qft_bits": 6, "qft_tol": 1e-10},
    "dense": {"n_bits": 8, "freq": 5.0, "tol": 1e-5},
    "lindblad": {"n_sites": 4, "steps": 2, "dt": 0.01, "jz": 0.5, "gamma": 0.3,
                 "max_bond": 16, "trace_tol": 1e-10, "tol": 1e-10},
    "cv": {"n_sites": 6, "bond": 4, "dmrg_sweeps": 2, "n_omegas": 3,
           "omegas": (0.0, 3.0), "eta": 0.1, "sweeps": 1, "cg_iters": 4,
           "cpu_at": (0, 2), "tol": 1e-8, "seed": 22},
    "mcwf": {"n_sites": 4, "n_traj": 3, "steps": 3, "t": 0.3, "h": 1.0,
             "gamma": 0.2, "max_bond": 4, "tol": 1e-10, "seed": 23},
}
# Infinite chains and chemistry (phase 10).  HALDANE: the spin-1 Heisenberg
# chain of MPSKit.jl's documented "Haldane gap" example, its MPO built by
# InfiniteOpSum: VUMPS with the bond grown 32 -> 64 -> 128 (each stage from
# the last one's AL, zero-padded, plus noise), the bond-128 energy per site
# against White & Huse's -1.401484038971 (PRB 48, 3844, 1993); the gap at
# k = pi by excitation_minimum_cell on the largest grown ground whose solve
# fits its budget (20 s, 40 until phase 11; not under bond 32), against
# Haegeman et al.'s 0.41047925
# (PRB 85, 100408, 2012); the dense excitation_spectrum on a bond-12 ground,
# card against CPU over all bands.  HUBBARD: hubbard_vumps (u 4, t 1, half
# filling, the d = 16 folded cell) with bonds grown to 128, the largest
# halved while its timed estimate exceeds the budget, against Lieb-Wu
# (-0.573729 at u 4).  H_CHAIN: the linear hydrogen chain in STO-3G at 1.8
# bohr, near the equilibrium of the Simons Collaboration hydrogen-chain
# benchmark (Motta et al., PRX 7, 031059, 2017); H8, not H10: the
# charge-blocked MPO compile (host AutoMPO and block SVDs) of H10's 18,300
# terms takes 113.7 s on the card machine's host, over the 60 s allowed
# (scripts/time_chemistry_mpo.py; PERF.md §6).  RHF, then chemistry_dmrg_u1
# at bond 128 (energies non-increasing, below RHF, N exact, no leaks), held
# within 1e-4 Ha to the JAX package's electronic masked-route energy at the
# same size (u1_ref, from scripts/chemistry_u1_reference.py 8 128 4: the
# route stops at a level that depends on its start only slightly); and the
# penalty route chemistry_dmrg on the same operator at bond 128 against its
# own run at bond 256, which holds every Schmidt rank of 16 spin-orbitals
# (exact).  The two routes are not held to each other: the masked route
# splits its slots among the charge classes by u1_bond_charges, as the JAX
# package does, and at bond 128 stays 2.0e-2 Ha above the exact energy (its
# distance is printed).  The ground state is served
# through #1.  WATER: frozen-core STO-3G water at the experimental geometry,
# RHF against the published -74.9630 and DMRG at bond 24 against FCI.
# EVOLVE: imaginary-time umps_mpo_evolve of the infinite TFIM at h 1.5 from a
# product state, bond 16, card against CPU.
INFINITE = {
    "haldane": {"schedule": (32, 64, 128), "iters": 60, "lanczos_iters": 40,
                "noise": 1e-3, "e_ref": -1.401484038971, "e_tol": 1e-8,
                "gap_ref": 0.41047925, "gap_tol": 1e-4, "gap_min_bond": 32,
                "gap_iters": 60, "gap_budget_s": 20.0, "dense_bond": 12,
                "dense_tol": 1e-10, "seed": 21},
    "hubbard": {"u": 4.0, "t": 1.0, "bond_dims": (16, 32, 64, 128), "iters": 40,
                "lanczos_iters": 40, "budget_s": 40.0, "min_bond": 32, "tol": 1e-4,
                "seed": 22},
    "h_chain": {"n_atoms": 8, "r": 1.8, "bond": 128, "full_bond": 256, "sweeps": 4,
                "pen_tol": 1e-4, "u1_ref": -11.93065637789795, "u1_tol": 1e-4,
                "serve_batch": 4096, "seed": 23},
    "water": {"angle": 104.52, "r_oh": 0.9572 / 0.52917721067, "bond": 24,
              "sweeps": 4, "rhf_ref": -74.9630, "rhf_tol": 2e-3, "fci_tol": 1e-7},
    "evolve": {"h": 1.5, "bond": 16, "t": 0.5, "steps": 5, "tol": 1e-10},
}
# The same paths at a size the CPU rehearses in seconds
# (tests/test_torch_vumps.py).  H4's penalty route runs at bond 8, below the
# 16 that holds every Schmidt rank, where it lies 1.5e-4 above the exact
# energy: its tolerance there is 1e-3.
INFINITE_TINY = {
    "haldane": {**INFINITE["haldane"], "schedule": (6, 8), "iters": 30, "e_tol": 1e-2,
                "gap_tol": 2e-2, "gap_min_bond": 6, "gap_iters": 20, "dense_bond": 3,
                "gap_budget_s": 5.0},
    "hubbard": {**INFINITE["hubbard"], "bond_dims": (8,), "iters": 3, "min_bond": 8,
                "tol": 1.0, "budget_s": 30.0},
    "h_chain": {**INFINITE["h_chain"], "n_atoms": 4, "bond": 8, "full_bond": 16,
                "pen_tol": 1e-3, "u1_ref": -4.57759881903517, "serve_batch": 64},
    "water": INFINITE["water"],
    "evolve": {**INFINITE["evolve"], "bond": 4, "steps": 2},
}
# 2D and finite temperature (phase 11).  The widths are those users of these
# methods run on one card; every path is held to a closed form and, where a
# float64 CPU run is affordable, the card to the port on the CPU.
# CTMRG: the square-lattice Ising model exactly at beta_c, chi 128, 300
# iterations, against Onsager's ln z_c = ln(2)/2 + 2G/pi (G Catalan's
# constant), card against CPU over the first 100 iterations (all 300 until
# the streamed MPO path's checks joined phases 3-5: the CPU took 10.05 s of
# them, the card 1.14 s, agreeing to 6.7e-16); at beta 0.5 from the
# fixed-spin boundary (ising_boundary), chi 64, the magnetization against
# Yang's (1 - sinh(2 beta)^-4)^(1/8).  TRG: beta
# 0.4, chi 64 (every split a full SVD of a 4096 x 4096 matrix), 12 steps (a
# 4096-site block: the free energy is converged in the steps to 2e-8 at chi
# 16 on the CPU, and each step costs two 2 s SVDs on the card), against
# Onsager's integral.  HOTRG: beta_c, chi 32 (the merge's largest
# intermediates chi^5 = 3.4e7 elements, 268 MB in float64; chi 48 would
# need 2.0 GB each and chi^7 = 5.9e11 operations a merge), against the
# closed form; ising_internal_energy_ad at beta 0.4, chi 24, against
# Onsager's internal energy.  MERA: the critical TFIM at chi 4 from a numpy
# start (mera_start), swept as far as the budget allows (75 sweeps, 150
# until phase 14, 300 until phase 13, 1000 until phase 12), against -4/pi and the Ising sigma
# dimension 1/8, and held to the JAX package's energy and sigma dimension
# after the same sweeps from the same start (e_ref, dim_ref:
# scripts/mera_reference.py 75 4 0, 4.9 s on a development CPU); then expand_mera to chi 6, the
# same state to 1e-8, and a few sweeps there.  THERMAL: thermal_itebd of the
# critical TFIM at bond 64, beta 2, dbeta 0.01 (0.005 until phase 13),
# energy and ln Z against tfim_exact_thermal (the energy is second order in
# dbeta; ln Z from the norm accumulation carries a first-order bias: -1.27e-4
# at dbeta 0.005, -2.49e-4 at 0.01 on the CPU, against its 1e-3), card
# against CPU to beta 0.5 (to beta 2 until the streamed MPO path's checks
# joined phases 3-5, when the CPU took 5.73 s, the card 2.87 s); thermal_wii
# at bond 64 against the same integrals.  IBC: ibc_thermal_correlator of the
# XX chain at bond 64 against the exact infinite free-fermion Wick oracle
# (xx_wick below; 2 steps, 4 until phase 13, 6 until phase 12); ibc_dynamic_correlator on a
# VUMPS ground state of the spin-1/2 Heisenberg chain at bond 64, card
# against CPU (one step, two until phase 12).  LINDBLAD: pure dephasing
# against exp(-2 gamma t); ness_infinite of the dephased TFIM at bond 32,
# card against CPU (one chunk, two until phase 12).  IPEPS: the
# square-root-Boltzmann Ising iPEPS magnetization against Yang at chi 64;
# ipeps_ground_state of the 2D TFIM at D 3 (q 9), chi 36, with the default
# 500-step schedule, card against CPU (CTMRG 60 iterations, 100 until
# phase 13, 200 until phase 12).
# FACTORIZE: cp_als (rank 16, 100 steps) and tucker_hooi (ranks 32) on 256^3
# tensors of that rank plus noise, against the noise floor, card against CPU.
TWO_D = {
    "ctmrg": {"chi": 128, "iters": 300, "cpu_iters": 100, "tol": 1e-6, "mag_beta": 0.5,
              "mag_chi": 64, "mag_iters": 200, "mag_tol": 1e-9},
    "trg": {"beta": 0.4, "chi": 64, "steps": 12, "tol": 1e-7},
    "hotrg": {"chi": 32, "steps": 30, "tol": 1e-7, "ad_beta": 0.4, "ad_chi": 24,
              "ad_steps": 24, "ad_tol": 1e-4},
    "mera": {"chi": 4, "sweeps": 75, "cpu_sweeps": 3, "big_chi": 6, "big_sweeps": 10,
             "e_ref": -1.1686341287681872, "dim_ref": 1.2165372767921243, "ref_tol": 1e-8,
             "seed": 0},
    "thermal": {"beta": 2.0, "cpu_beta": 0.5, "bond": 64, "dbeta": 0.01, "e_tol": 1e-5,
                "lz_tol": 1e-3, "wii_dbeta": 0.02, "wii_tol": 3e-4},
    "ibc": {"beta": 1.0, "bond": 64, "dbeta": 0.02, "n_sites": 8, "site": 3,
            "dt": 0.05, "steps": 2, "tol": 2e-4, "heis_iters": 40, "heis_tol": 1e-4,
            "heis_sites": 8, "heis_steps": 1, "seed": 31},
    "lindblad": {"gamma": 0.35, "t": 0.5, "h": 1.2, "rate": 0.7, "bond": 32,
                 "t_chunk": 1.0, "max_chunks": 1, "steps_per_unit": 6},
    "ipeps": {"beta": 0.5, "chi": 64, "iters": 200, "mag_tol": 1e-8, "h": 3.5,
              "bond": 3, "gs_chi": 36, "gs_iters": 60},
    "factorize": {"dim": 256, "rank": 16, "steps": 100, "noise": 1e-3, "cpu_steps": 3,
                  "tucker": 32, "tucker_steps": 10, "seed": 32},
}
# The same paths at a size the CPU rehearses in seconds
# (tests/test_torch_ipeps.py); the closed forms are looser there.
TWO_D_TINY = {
    "ctmrg": {**TWO_D["ctmrg"], "chi": 8, "iters": 30, "cpu_iters": 10, "tol": 2e-2,
              "mag_chi": 8, "mag_iters": 40, "mag_tol": 1e-6},
    "trg": {**TWO_D["trg"], "chi": 6, "steps": 12, "tol": 1e-3},
    "hotrg": {**TWO_D["hotrg"], "chi": 6, "steps": 12, "tol": 2e-2, "ad_chi": 6,
              "ad_steps": 10, "ad_tol": 5e-2},
    "mera": {**TWO_D["mera"], "chi": 3, "sweeps": 4, "cpu_sweeps": 2, "big_chi": 4,
             "big_sweeps": 1},
    "thermal": {**TWO_D["thermal"], "beta": 0.4, "cpu_beta": 0.2, "bond": 4, "dbeta": 0.05,
                "e_tol": 1e-2, "lz_tol": 1e-2, "wii_dbeta": 0.1, "wii_tol": 2e-2},
    "ibc": {**TWO_D["ibc"], "bond": 4, "dbeta": 0.1, "n_sites": 4, "site": 1, "steps": 1,
            "tol": 5e-2, "heis_iters": 4, "heis_tol": 2.0, "heis_sites": 4, "heis_steps": 1},
    "lindblad": {**TWO_D["lindblad"], "bond": 4, "max_chunks": 1, "steps_per_unit": 2},
    "ipeps": {**TWO_D["ipeps"], "chi": 4, "iters": 20, "mag_tol": 1e-2, "bond": 2,
              "gs_chi": 4, "gs_iters": 10},
    "factorize": {**TWO_D["factorize"], "dim": 12, "rank": 3, "steps": 6, "tucker": 3,
                  "tucker_steps": 2},
}
# Unit cells, iPEPS optimizers, fermionic PEPS and PEPS sampling (phase 12),
# at the JAX tests' widths or larger; these paths are launch- and
# decomposition-bound on the card (PERF.md §6), so depth is cut to the
# phase's budget, each cut noted here.  CELL_CTMRG: the Ising
# antiferromagnet on the 2x2 checkerboard at beta 0.5 under a staggered field
# 1e-4, chi 64 (40 iterations, not 120), its staggered magnetization against
# Onsager-Yang (the JAX test's 2e-4, the field's shift), card against CPU at
# chi 16 (cuSOLVER against LAPACK); the row-channel correlation length of
# the Ising model at beta 0.3 (chi 64, 50 iterations) against 1/(ln coth
# beta - 2 beta).  CELL_SU: the unrotated Heisenberg model by the
# checkerboard simple update, the JAX test's D 2, chi 12 (250 sweeps, not
# its 500; CTMRG 40 iterations, not 120) card against CPU, then D 3 (200
# sweeps, not 500), chi 36 (10 iterations, 20 until phase 14, not 150; the
# energy unchanged to every printed digit on the card; energy and moments in
# one environment) below it and above QMC's -0.669437, the staggered moment
# equal on every site and alternating.  SCAN: 16 TFIM fields over h 2-4 at
# D 2, chi 16 (10 iterations, 20 until phase 14, not 120) in one batched
# call, ordered below h
# 2.95 and paramagnetic above 3.3 (the D 2 simple update stays ordered up
# to about 3.3, above the exact h_c 3.04: the fields between are printed),
# the last member against the unbatched call (two until phase 13).  FULL_UPDATE: the Heisenberg
# model at D 2, chi 16 from the JAX test's simple-update state, 15 steps of
# 0.02 (the JAX test: 200 steps of 0.1 down to 0.01; 10 steps of 0.1 rise
# above the simple update).  VARIATIONAL: the checkerboard Heisenberg flow
# at D 2, chi 16, 35 steps (not 100) of 2 untaped and 2 differentiated
# CTMRG iterations (not 8 and 6; the trajectories agree, CHANGES.md), its
# start and end measured in 30 iterations (not 120; converged to 1e-15),
# below the simple update by 1e-3 and above QMC; the C4v TFIM flow at h 3, 20
# steps (not 120).  THERMAL2D: the commuting Ising purification at beta 0.6
# against Onsager and Yang (chi 16, 40 iterations, not 80).  FERMIONS:
# fpeps_energy on a random 3x3 BdG state against Fock ED; fpeps_ground_state
# on the 2x3 BdG lattice within 1.5% of ED (100 steps, not the JAX test's
# 120); fipeps_ground_state of the p-wave model within 1% of the BdG
# integral (50 steps, 60 until phase 14, not 200, of 2 and 2 iterations,
# not 8 and 4; 6.9e-3 above it after 50 on the card); the checkerboard Hubbard AFM at U 8
# (10 steps, 20 until phase 14, not the JAX test's 35, of 2 and 2
# iterations, not 8 and 4; after 10 on the card E + U/2 -0.131, filling
# 1.002, staggered n_up 0.994).  SAMPLING: 4096 samples of a random positive 6x6 D 2 PEPS at chi 8
# against its marginals (by projected norms) and peps_log_prob; the GHZ Born
# machine (100 steps, not 250); VMC of the 2x2 TFIM: its estimators over
# every configuration equal the dense Rayleigh quotient, and 100 sampled
# steps of 256 draws land within 2.5% of ED (sampled descent from this
# start stalls 1.5-1.8% above ED in both packages, CHANGES.md; exact-weight
# descent from other starts reaches 1e-5).
PEPS2D = {
    "cell_ctmrg": {"beta": 0.5, "eps": 1e-4, "chi": 64, "iters": 40, "mag_tol": 2e-4,
                   "xi_beta": 0.3, "xi_chi": 64, "xi_iters": 50, "xi_tol": 0.02,
                   "cpu_chi": 16, "cpu_iters": 60, "cpu_tol": 1e-10},
    "cell_su": {"bond": 3, "chi": 36, "iters": 10, "schedule": ((0.1, 100), (0.02, 100)),
                "mom_tol": 1e-6, "moment": (0.25, 0.5), "cpu_bond": 2, "cpu_chi": 12,
                "cpu_iters": 40, "cpu_schedule": ((0.1, 100), (0.02, 100), (0.005, 50)),
                "cpu_tol": 1e-8},
    "scan": {"n": 16, "h": (2.0, 4.0), "bond": 2, "chi": 16, "iters": 10, "h_c": 3.04,
             "schedule": ((0.1, 150), (0.02, 150), (0.005, 80)), "ordered_below": 2.95,
             "ordered": 0.3, "para_above": 3.3, "para": 1e-3, "members": (15,),
             "tol": 1e-10},
    "full_update": {"bond": 2, "chi": 16, "iters": 40, "ctm_iters": 30,
                    "su_schedule": ((0.1, 100), (0.02, 100), (0.005, 60)),
                    "schedule": ((0.02, 15),), "gain": 5e-5},
    "variational": {"bond": 2, "chi": 16, "steps": 35, "lr": 3e-3, "env_iters": 30,
                    "refresh_iters": 2, "grad_iters": 2,
                    "su_schedule": ((0.1, 150), (0.02, 150), (0.005, 80)),
                    "gain": 1e-3, "trace_tol": 1e-4, "readme": -0.6622, "tfim_h": 3.0,
                    "tfim_steps": 20},
    "thermal2d": {"beta": 0.6, "bond": 2, "n_steps": 6, "chi": 16, "iters": 40,
                  "e_tol": 1e-10, "m_tol": 1e-8},
    "fermions": {
        "bdg": {"ly": 3, "lx": 3, "seed": 2, "t": 1.0, "mu": 0.3, "delta": 0.6, "tol": 1e-12},
        "fpeps": {"ly": 2, "lx": 3, "t": 1.0, "mu": 1.0, "delta": 0.6, "chi": 12,
                  "steps": 100, "lr": 3e-2, "tol": 0.015},
        "fipeps": {"t": 1.0, "mu": -4.4, "delta": 1.0, "chi": 12, "steps": 50, "lr": 2e-2,
                   "refresh_iters": 2, "grad_iters": 2, "env_iters": 60,
                   "tol": 1e-2, "readme": "0.4%"},
        "hubbard": {"u": 8.0, "chi": 12, "steps": 10, "lr": 1e-2, "refresh_iters": 2,
                    "grad_iters": 2, "env_iters": 60, "fill_tol": 0.05, "stagger": 0.6},
    },
    "sampling": {"rows": 6, "cols": 6, "bond": 2, "chi": 8, "n": 4096, "seed": 41,
                 "sites": ((0, 0), (3, 3)), "lp_tol": 1e-6, "sigmas": 5.0,
                 "ghz_steps": 100, "ghz_chi": 8, "ghz_lr": 0.05, "ghz_tol": 1e-3,
                 "ghz_samples": 64, "ghz_uniform": 1.0, "vmc_steps": 100,
                 "vmc_samples": 256, "vmc_lr": 0.05, "vmc_tol": 0.025},
}
# The same paths at a size the CPU rehearses in seconds
# (tests/test_torch_peps2d_smoke.py); the closed forms are looser there.
PEPS2D_TINY = {
    "cell_ctmrg": {**PEPS2D["cell_ctmrg"], "chi": 8, "iters": 30, "mag_tol": 1e-3,
                   "xi_chi": 8, "xi_iters": 30, "xi_tol": 0.1, "cpu_chi": 4, "cpu_iters": 10},
    "cell_su": {**PEPS2D["cell_su"], "chi": 9, "iters": 10, "schedule": ((0.1, 30),),
                "mom_tol": 1e-2, "moment": (0.0, 0.5), "cpu_chi": 4, "cpu_iters": 10,
                "cpu_schedule": ((0.1, 30),)},
    "scan": {**PEPS2D["scan"], "n": 3, "chi": 4, "iters": 20, "members": (0,),
             "schedule": ((0.1, 60),)},
    "full_update": {**PEPS2D["full_update"], "chi": 4, "iters": 10, "ctm_iters": 10,
                    "su_schedule": ((0.1, 30),), "schedule": ((0.1, 1),), "gain": -1.0},
    "variational": {**PEPS2D["variational"], "chi": 4, "steps": 1, "env_iters": 10,
                    "refresh_iters": 1, "grad_iters": 1, "su_schedule": ((0.1, 30),),
                    "gain": -1.0, "trace_tol": 1.0, "tfim_steps": 2},
    "thermal2d": {**PEPS2D["thermal2d"], "chi": 4, "iters": 20, "e_tol": 1e-8},
    "fermions": {
        "bdg": {**PEPS2D["fermions"]["bdg"], "ly": 2, "lx": 2},
        "fpeps": {**PEPS2D["fermions"]["fpeps"], "ly": 2, "lx": 2, "chi": 4, "steps": 2,
                  "tol": 10.0},
        "fipeps": {**PEPS2D["fermions"]["fipeps"], "chi": 4, "steps": 2, "refresh_iters": 1,
                   "grad_iters": 1, "env_iters": 10, "tol": 10.0},
        "hubbard": {**PEPS2D["fermions"]["hubbard"], "chi": 4, "steps": 2, "refresh_iters": 1,
                    "grad_iters": 1, "env_iters": 10, "fill_tol": 1.0, "stagger": 0.0},
    },
    "sampling": {**PEPS2D["sampling"], "rows": 3, "cols": 3, "chi": 4, "n": 256,
                 "sites": ((0, 0), (1, 1)),
                 "lp_tol": 1e-8, "ghz_steps": 5, "ghz_tol": 10.0, "ghz_samples": 8,
                 "ghz_uniform": 0.0,
                 "vmc_steps": 2, "vmc_samples": 16, "vmc_tol": 10.0},
}
# The 3D family and tree tensor networks (phase 13).  FLOW: bench.py's own
# bench_hotrg3d configuration (beta 0.2, ising3d_tensor_smooth, chi 12, 10
# steps, float32; its TFLOP/s counted as bench.py counts them, steps x 3 x 2
# chi^11) and the same flow in float64 on the card, then chi 16 (3 steps,
# float32, held to float64), a width the TPU could not hold, with its peak
# device memory.  ANCHORS: the JAX test's closed forms at its chi (4-6),
# steps and tolerances in float64, card against CPU where the truncation is
# not degenerate.  IPEPS: the cubic TFIM at examples/three_dimensions.py's
# sizes (D 2, chi 6, its 380-sweep schedule, 20 flow steps) against
# perturbation theory at h 0.5 and 8, card against CPU at h 0.5.  THERMAL:
# the commuting purification at beta 0.3 (D 2, chi 6; three seed merges and
# 19 steps) against the classical bond correlation (22 steps), card against
# CPU.  TTN: ttn_dmrg of the 4x4 snake TFIM (h 3.5, chi 32, the JAX test's 5
# sweeps) against the chain DMRG (bond 48, 2 sweeps, not 6: converged to
# 1e-14) within the JAX test's 2e-6; the 8x8 snake (chi 32, 4 sweeps)
# against the chain at bond 64 (2 sweeps, 1.1e-5 from its 12-sweep value):
# the chi-32 tree converges 5.8e-4 above the chain (10 sweeps; 8.9e-4 after
# 4), so it is held at 1.5e-3, not 1e-5 (PERF.md §6).  ADAM:
# ttn_ground_state of the 8-site TFIM (chi 16) card against CPU over its
# first 50 steps, then 2000 steps (not the JAX test's 3000: 4.7e-5 above ED
# against its 1e-4; 1500 steps, whose cosine schedule decays sooner, ended
# 9.3e-5 above it on the card) against ED.  TDVP: ttn_tdvp_evolve (chi 16, dt 0.05, the
# JAX test's 8 real-time steps) against dense exponentiation.
THREE_D = {
    "flow": {"beta": 0.2, "chi": 12, "steps": 10, "big_chi": 16, "big_steps": 3},
    "anchors": {"chi": 4, "steps": 25, "layers_chi": 6, "high_t_chi": 5, "ad_steps": 20,
                "ab_steps": 22, "chains_tol": 1e-13, "layers_tol": 4e-4, "low_t_tol": 1e-6,
                "high_t_tol": 3e-5, "ad_tol": 2e-4, "fd_tol": 5e-6, "ab_tol": 1e-7,
                "tol": 1e-10},
    "ipeps": {"bond": 2, "chi": 6, "steps": 20, "fields": (0.5, 8.0), "cpu_fields": (0.5,),
              "tol": 2e-3, "schedule": ((0.1, 150), (0.02, 150), (0.005, 80))},
    "thermal": {"beta": 0.3, "bond": 2, "n_steps": 3, "chi": 6, "steps": 19, "tol": 1e-9},
    "ttn": {"h": 3.5, "chi": 32, "sweeps": 5, "chain_bond": 48, "chain_sweeps": 2,
            "rtol": 2e-6, "big_side": 8, "big_sweeps": 4, "big_bond": 64,
            "big_chain_sweeps": 2, "big_rtol": 1.5e-3, "seed": 51},
    "adam": {"n": 8, "h": 1.05, "chi": 16, "steps": 2000, "lr": 0.02, "cpu_steps": 50,
             "tol": 1e-4, "seed": 52},
    "tdvp": {"n": 8, "h": 1.05, "chi": 16, "dt": 0.05, "steps": 8, "seed": 53, "tol": 1e-10},
}
# The same paths at a size the CPU rehearses in seconds; the closed forms are
# looser there (a few flow steps are far from the thermodynamic limit).
THREE_D_TINY = {
    "flow": {"beta": 0.2, "chi": 4, "steps": 3, "big_chi": 5, "big_steps": 2},
    "anchors": {**THREE_D["anchors"], "steps": 8, "layers_chi": 4, "high_t_chi": 4,
                "ad_steps": 6, "ab_steps": 5, "chains_tol": 1.0, "layers_tol": 1.0,
                "low_t_tol": 1.0, "high_t_tol": 1.0, "ad_tol": 1.0, "fd_tol": 1.0,
                "ab_tol": 1.0},
    "ipeps": {**THREE_D["ipeps"], "chi": 4, "steps": 4, "schedule": ((0.1, 20),),
              "tol": 10.0},
    "thermal": {**THREE_D["thermal"], "n_steps": 1, "steps": 3},
    "ttn": {**THREE_D["ttn"], "chi": 4, "sweeps": 2, "chain_bond": 8, "chain_sweeps": 2,
            "rtol": 1.0, "big_side": 4, "big_sweeps": 1, "big_bond": 8,
            "big_chain_sweeps": 2, "big_rtol": 1.0},
    "adam": {**THREE_D["adam"], "chi": 4, "steps": 20, "cpu_steps": 5, "tol": 10.0},
    "tdvp": {**THREE_D["tdvp"], "steps": 1},
}
# The parallel layer (phase 14), in a world of one rank over NCCL (a second
# rank on one GPU is a duplicate GPU to NCCL), every mesh axis of size 1,
# within 30 s of the card's time.  FORWARD: one rank's share of the flagship
# on the JAX package's dp 4 x sp 2 layout (README): 500 sites, batch 1024; its
# (B, N, D, D) site matrices take 8.4 GB.  TRAIN and BORN: the published
# widths of phase 6; TRAIN's tolerance holds the update on the well-
# conditioned samples (see par_train_path; the first card runs measured
# 9.6e-5, 4.0e-4 and 8.8e-5 there for the sharded, tp and pipelined steps, and
# 5.7e-5 for make_train_step's own float32 update against its float64 one),
# BORN is held in float64 (par_born_path): the first update and the first 3
# losses to 1e-10 of the largest (in float32 the two Adams part by 6.6e-3 of
# the largest loss on the card, a third of its whole fall over the 10 steps,
# and in float64 by 5.6e-4 after 10 steps, Adam's trajectory being chaotic
# at these widths; the losses 0-2 part by 0, 0 and 3.0e-14 on a CPU).  The
# DMRG paths
# keep the widths of phases 8-12 and cut depth: TFIM bond 64
# (CHAINS["tfim"]) at 16 sites, not 100, 1 sweep, not 3, Lanczos 20, not 40
# (at 32 sites, 2 sweeps and Lanczos 40 the tp DMRG took 13.1 s and
# dmrg_uniform 6.1 s); the ensemble's 64 members at bond 32
# (CHAINS["ensemble"]) at 8 sites, not 24, and 1 sweep, not 2 (12 sites took
# 3.1 s a call); the 16 scan fields at D 2, chi 16 (PEPS2D["scan"]) with 5
# simple-update steps, not 380, and 1 CTMRG iteration, not 20 (20 and 2 took
# 5.0 s a call); the 32-frequency correction-vector grid at bond 32
# (PHYSICS["cv"]) on an 8-site chain, not 32.  Each is held against its
# single-device counterpart on the card; the real-space DMRG against the free
# fermions, both its last parallel iteration before the serial polish (to
# 1e-6: the card read 5.1e-8 there, and a single dmrg_uniform sweep alone
# reaches 1e-12, so the final energy does not witness the parallel sweeps)
# and its final energy; the tp DMRG also at 8 sites against the CPU.
PARALLEL = {
    "forward": {"n_sites": 500, "phys": 2, "bond": 64, "batch": 1024, "check": 64,
                "seed": 61},
    "train": {**TRAIN, "seed": 62, "tol": 1e-3},
    "born": {**BORN, "seed": 63, "held": 3, "tol": 1e-10},
    "tp_dmrg": {"n_sites": 16, "h": 1.0, "bond": 64, "sweeps": 1, "iters": 20,
                "tol": 1e-10, "seed": 64, "cpu_sites": 8, "cpu_bond": 8},
    "rs_dmrg": {"outer": 2, "final": 1, "tol": 1e-8, "parallel_tol": 1e-6},
    "ensemble": {**CHAINS["ensemble"], "n_sites": 8, "sweeps": 1, "tol": 1e-12},
    "scan": {**PEPS2D["scan"], "schedule": ((0.1, 5),), "iters": 1, "tol": 1e-10},
    "cv": {**PHYSICS["cv"], "n_sites": 8, "tol": 1e-10},
}
# The same paths at a size the CPU rehearses in seconds
# (tests/test_torch_parallel.py) and the card tests run.
PARALLEL_TINY = {
    "forward": {"n_sites": 12, "phys": 2, "bond": 8, "batch": 16, "check": 8, "seed": 61},
    "train": {"n_sites": 12, "phys": 2, "bond": 8, "batch": 16, "steps": 2, "lr": 1e-3,
              "seed": 62, "tol": 1e-3},
    "born": {"n_sites": 6, "bond": 4, "batch": 64, "steps": 3, "lr": 1e-2, "seed": 63,
             "held": 3, "tol": 1e-10},
    "tp_dmrg": {**PARALLEL["tp_dmrg"], "n_sites": 6, "bond": 8, "sweeps": 2, "iters": 20,
                "cpu_sites": 4, "cpu_bond": 4},
    "rs_dmrg": PARALLEL["rs_dmrg"],
    "ensemble": {**PARALLEL["ensemble"], "n_members": 3, "n_sites": 6, "bond": 4},
    "scan": {**PARALLEL["scan"], "n": 2, "chi": 4, "schedule": ((0.1, 5),), "iters": 2},
    "cv": {**PARALLEL["cv"], "n_sites": 6, "bond": 4, "n_omegas": 4},
}
TOL_LOWERING_LOG = 1e-5  # relative, float32 chain against the float64 oracle
TOL_BETHE = {torch.float64: 1e-10, torch.float32: 1e-5}  # relative, ln Z
TOL_CARD_VS_CPU = 1e-8  # float64 simple update and descent, card against CPU

# Relative Frobenius error of the step-0 float32 gradient against the float64
# gradient of the same loss on the same (float32) parameters, over the samples
# whose log|psi| is determined at float32 (see grad_check, PERF.md)
TOL_GRAD = 1e-3
# |sampler log p - mps_log_prob| on the same samples: two float32 chains in
# two gauges (right-canonical and as trained) over 64 sites, each rounding at
# about 1e-7 of |log p| ~ 44 nats per site
TOL_LOGP_F32 = 2e-3
TOL_LOGP_F64 = 1e-9

# Agreement of log|psi| between a kernel and its plain version, scaled by
# each sample's condition number (see mps_condition, condition, PERF.md)
TOL_F32 = 2e-3  # float32 throughout
# bf16 operands or carry: where the two versions' fp32 values straddle a bf16
# rounding boundary they round apart by one bf16 ulp (2**-8); allow 8 such
# ulps per unit of condition
TOL_BF16 = 8 * 2.0 ** -8

# Peak rates of an H100 SXM (NVIDIA data sheet, dense), the card this script
# is written for.  fp32-accurate GEMMs run as 3xTF32: three TF32 passes.
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12  # fp32 outside the tensor cores (elementwise work)
PEAK_BYTES = 3.35e12


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- helpers


def log_abs(amp, log_scale):
    """log|psi| from a split pair, in float64 on the host."""
    return (torch.log(amp.double().abs()) + log_scale.double()).cpu()


def condition(terms):
    """Condition number of a closing sum over the last axis, sum|t| / |sum t|:
    how much a relative error in the terms is amplified in the sum."""
    return (terms.abs().sum(-1) / terms.sum(-1).abs()).double().cpu()


def mps_condition(cores, left, right, x):
    """How much the chain amplifies a relative rounding error, per sample.

    At every interface n between sites, psi = l_n . r_n with l_n the sites
    before it applied to ``left`` and r_n the sites after it applied to
    ``right``.  Rounding at site n perturbs psi relative to |l_n| |r_n|, so
    the amplification is max_n |l_n| |r_n| / |psi| -- large where the two
    halves of the chain are nearly orthogonal at some interface, even when
    the final close is not.  Computed in float64.
    """
    c, xs = cores.double(), x.double()
    n_sites, batch = c.shape[0], x.shape[0]

    def unit(v):
        return v / v.norm(dim=1, keepdim=True)

    def apply_site(vec, n, from_left):
        u = (torch.einsum("bi,kij->bkj", vec, c[n]) if from_left
             else torch.einsum("kij,bj->bki", c[n], vec))
        return unit(torch.einsum("bk,bkj->bj", xs[:, n], u))

    back = torch.empty((n_sites + 1, batch, c.shape[2]), dtype=torch.float32,
                       device=c.device)
    rho = unit(right.double().expand(batch, -1))
    back[n_sites] = rho
    for n in range(n_sites - 1, -1, -1):
        rho = apply_site(rho, n, from_left=False)
        back[n] = rho
    ell = unit(left.double().expand(batch, -1))
    cos = (ell * back[0].double()).sum(1).abs()
    for n in range(n_sites):
        ell = apply_site(ell, n, from_left=True)
        cos = torch.minimum(cos, (ell * back[n + 1].double()).sum(1).abs())
    return (1.0 / cos).cpu()


def compare_split(got, ref, tol, what, cond):
    """Hold a kernel's split output against its plain version.

    |d log|psi|| must stay within ``tol * cond`` and the signs must agree,
    on every sample where that bound is below 1 (``cond <= 1 / tol``): there
    the amplitude is determined at this precision; beyond it the sums cancel
    and rounding decides the digits.  Returns the largest |d log|psi||
    over the compared samples.
    """
    lg, lr = log_abs(*got), log_abs(*ref)
    if not (torch.isfinite(lg).all() and torch.isfinite(lr).all()):
        raise AssertionError(f"{what}: non-finite log|psi|")
    err = (lg - lr).abs()
    keep = tol * cond <= 1
    if not keep.any():
        raise AssertionError(f"{what}: no sample is conditioned well enough to compare")
    ratio = float((err / (tol * cond))[keep].max())
    signs = bool((torch.sign(got[0].double().cpu())
                  == torch.sign(ref[0].double().cpu()))[keep].all())
    worst = float(err[keep].max())
    med = float(err[keep].median())
    log(f"  {what}: max |d log|psi|| = {worst:.3e} (median {med:.1e}) "
        f"over {int(keep.sum())}/{keep.numel()} samples (median cond "
        f"{float(cond.median()):.3g}); max error/tolerance "
        f"{ratio:.3f} (tol {tol:.3g} x cond); signs agree: {signs}")
    if ratio > 1 or not signs:
        raise AssertionError(f"{what}: kernel and plain version disagree")
    return worst


def cuda_time(fn, reps=7):
    """Median milliseconds of ``fn()`` on the card (CUDA events, warm-up first)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound_ms(gemm_flops, elem_flops, nbytes, dtype=torch.float32):
    """Least time for fp32-accurate work on the card: the largest of the GEMM
    FLOPs on the tensor cores (3 TF32 passes for fp32 operands, one bf16
    pass for bf16), the elementwise FLOPs on the fp32 units and the bytes
    over HBM bandwidth.  Returns ``(ms, "operations" | "bytes")``."""
    t_gemm = (3 * gemm_flops / PEAK_TF32 if dtype == torch.float32
              else gemm_flops / PEAK_BF16)
    t_ops = max(t_gemm, elem_flops / PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ---------------------------------------------------------------- inputs


def mps_inputs(shape, device, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    n, d, bond, batch = shape["n_sites"], shape["phys"], shape["bond"], shape["batch"]
    scale = 1.0 / math.sqrt(d * bond)
    cores = scale * torch.randn((n, d, bond, bond), generator=gen, device=device)
    cores = cores.to(dtype)
    left = torch.randn(bond, generator=gen, device=device)
    right = torch.randn(bond, generator=gen, device=device)
    x = torch.randn((batch, n, d), generator=gen, device=device)
    return cores, left, right, x


def mpo_inputs(shape, device, dtype, seed):
    """A uniform MPO, per-sample MPS cores and a ones boundary.

    ``shape["mpo"]`` names the MPO: ``"tfim"`` (W 3, the default),
    ``"heisenberg"`` (W 5), ``"heisenberg_s1"`` (spin 1, d 3, W 5),
    ``"aklt"`` (spin 1, d 3, W 14), or
    ``(d, W)`` for a random uniform one that is
    diagonal in the physical index with nonnegative entries and boundaries,
    so that the environments stay positive semidefinite and their close is
    well conditioned enough to compare at bf16 precision.
    """
    from contractn_tpu_torch.models import MPO, heisenberg_mpo, tfim_mpo

    gen = torch.Generator(device=device).manual_seed(seed)
    n, bond, batch = shape["n_sites"], shape["bond"], shape["batch"]
    kind = shape.get("mpo", "tfim")
    d = mpo_dims(shape)[0]
    scale = 1.0 / math.sqrt(d * bond)
    cores = (scale * torch.randn((batch, n, d, bond, bond), generator=gen,
                                 device=device)).to(dtype)
    ones = torch.ones(bond, device=device)
    if kind == "tfim":
        mpo = tfim_mpo(n, dtype=torch.float32, device=device)
    elif kind == "heisenberg":
        mpo = heisenberg_mpo(n, dtype=torch.float32, device=device)
    elif kind == "heisenberg_s1":
        mpo = spin1_heisenberg_mpo(n, device)
    elif kind == "aklt":
        mpo = aklt_mpo(n, device)
    else:
        wdim = kind[1]
        core = torch.zeros((d, d, wdim, wdim), device=device)
        for p in range(d):
            core[p, p] = torch.randn((wdim, wdim), generator=gen, device=device).abs()
        ends = 0.5 + torch.rand((2, wdim), generator=gen, device=device)
        mpo = MPO((core / math.sqrt(wdim)).expand(n, -1, -1, -1, -1).contiguous(),
                  ends[0], ends[1])
    return mpo, cores, ones


# ---------------------------------------------------------------- phases


def spin1_heisenberg_mpo(n, device):
    """The spin-1 Heisenberg chain ``sum S.S`` as a uniform real MPO (d 3,
    W 5): ``S.S = Sz Sz + (S+ S- + S- S+) / 2``."""
    from contractn_tpu_torch.models import MPO
    from contractn_tpu_torch.models.autompo import spin_ops

    ops = {k: torch.tensor(v, dtype=torch.float32, device=device)
           for k, v in spin_ops(1).items() if k in ("I", "Sz", "S+", "S-")}
    core = torch.zeros((3, 3, 5, 5), device=device)
    core[:, :, 0, 0] = ops["I"]
    core[:, :, 4, 4] = ops["I"]
    core[:, :, 0, 1], core[:, :, 1, 4] = ops["S+"], 0.5 * ops["S-"]
    core[:, :, 0, 2], core[:, :, 2, 4] = ops["S-"], 0.5 * ops["S+"]
    core[:, :, 0, 3], core[:, :, 3, 4] = ops["Sz"], ops["Sz"]
    ends = torch.eye(5, device=device)
    return MPO(core.expand(n, -1, -1, -1, -1).contiguous(), ends[0], ends[4])


def aklt_mpo(n, device, dtype=torch.float32):
    """The spin-1 AKLT chain ``sum S.S + (S.S)^2 / 3`` as a uniform real MPO
    (d 3, W 14).  With ``S.S = sum_a g_a O_a O'_a``, ``O = (Sz, S+, S-)``,
    ``O' = (Sz, S-, S+)`` and ``g = (1, 1/2, 1/2)``: channel 0 starts and 13
    ends (``I`` on both diagonals), channels 1-3 carry ``O_a`` to
    ``g_a O'_a`` and channels 4-12 ``O_a O_b`` to ``g_a g_b O'_a O'_b / 3``.
    The open chain's ground energy is ``-2/3`` a bond."""
    from contractn_tpu_torch.models import MPO
    from contractn_tpu_torch.models.autompo import spin_ops

    ops = {k: torch.tensor(v, dtype=torch.float64) for k, v in spin_ops(1).items()
           if k in ("I", "Sz", "S+", "S-")}
    left, right = (ops["Sz"], ops["S+"], ops["S-"]), (ops["Sz"], ops["S-"], ops["S+"])
    g = (1.0, 0.5, 0.5)
    core = torch.zeros((3, 3, 14, 14), dtype=torch.float64)
    core[:, :, 0, 0] = core[:, :, 13, 13] = ops["I"]
    for a in range(3):
        core[:, :, 0, 1 + a], core[:, :, 1 + a, 13] = left[a], g[a] * right[a]
        for b in range(3):
            c = 4 + 3 * a + b
            core[:, :, 0, c] = left[a] @ left[b]
            core[:, :, c, 13] = g[a] * g[b] / 3 * (right[a] @ right[b])
    core = core.to(device, dtype)
    ends = torch.eye(14, dtype=dtype, device=device)
    return MPO(core.expand(n, -1, -1, -1, -1).contiguous(), ends[0], ends[13])


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi, torch.cuda.get_device_name(0)


def phase_build():
    from contractn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    built = sorted(logs) or "nothing (up to date)"
    log(f"built {built} in {time.perf_counter() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        log(f"  {name}:")
        for fn, regs, spill_st, spill_ld, smem in ptxas_report(text):
            log(f"    {fn}: {regs} registers, spills {spill_st}/{spill_ld} bytes "
                f"(stores/loads), {smem} bytes static shared memory")


def ptxas_report(text):
    """``(kernel, registers, spill stores, spill loads, static smem)`` for each
    ``__global__`` function in an ``nvcc -Xptxas -v`` report."""
    rows, fn, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((_demangle(fn), int(m.group(1)), *spill,
                         int(smem.group(1)) if smem else 0))
            fn, spill = None, (0, 0)
    return rows


def _demangle(name):
    """A short readable name for a mangled kernel template instance."""
    base = re.search(r"(mps_tc_kernel|mps_streamed_\w+?_kernel|mpo_env_kernel|"
                     r"mpo_env_cluster_kernel|streamed_\w+?_kernel)", name)
    args = re.findall(r"L[ib](\d+)E", name)
    dtype = "bf16" if "nv_bfloat16" in name else "f32"
    return f"{base.group(1) if base else name}<{','.join([dtype, *args])}>"


def kernel_smem(device):
    """Dynamic shared memory per CTA at the main-path shapes, from the
    kernels' own layout functions."""
    import ctypes

    from contractn_tpu_torch.ops import cuda_mpo, cuda_mps

    mps = cuda_mps.tc_library()
    mpo = cuda_mpo.library()
    d, bond = FLAGSHIP["phys"], FLAGSHIP["bond"]
    mpo_shapes = [(*mpo_dims(s), s["bond"])
                  for s in (MPO_BENCH, *EXACT_MPO, *CLUSTER_MPO, *STREAMED_MPO)]
    for s in (FLAGSHIP_WIDE, *STREAMED_MPS):
        p, b = s["phys"], s["bond"]
        work = ctypes.c_longlong()
        mps.cn_mps_streamed_workspace(b, s["batch"], ctypes.byref(work))
        paths = "/".join(cuda_mps.PATHS[mps.cn_mps_path(bf16, p, b)] for bf16 in (0, 1))
        log(f"  #1 and #2 d={p} D={b}: {paths} path (fp32/bf16), "
            f"{work.value} bytes of workspace for B={s['batch']}")
    for bf16, tag in ((0, "fp32"), (1, "bf16")):
        log(f"  #1 and #2 (one layout) {tag} d={d} D={bond}: "
            f"{mps.cn_mps_evaluate_smem(bf16, d, bond)} bytes dynamic shared memory")
        for p, w, b in mpo_shapes:
            path = cuda_mpo.PATHS[mpo.cn_mpo_env_path(bf16, p, b, w)]
            padded = (f", bond padded to {mpo.cn_mpo_env_bond(bf16, p, b, w)}"
                      if path == "cluster" else "")
            per = "CTA(s) of the ket GEMMs" if path == "streamed" else "CTA(s)"
            log(f"  #3 cn_mpo_env {tag} d={p} D={b} W={w}: {path} path, "
                f"{mpo.cn_mpo_env_cluster(bf16, p, b, w)} {per} a sample{padded}, "
                f"{mpo.cn_mpo_env_smem(bf16, p, b, w)} bytes shared memory a CTA")


def mpo_dims(shape):
    """``(d, W)`` of the MPO that ``shape["mpo"]`` names."""
    kind = shape.get("mpo", "tfim")
    return {"tfim": (2, 3), "heisenberg": (2, 5), "heisenberg_s1": (3, 5),
            "aklt": (3, 14)}.get(kind, kind)


def phase_kernels_vs_plain(device):
    """Every kernel against its plain version, small and main-path shapes
    and the edges of each kernel's reach."""
    errors = {}
    mps_shapes = [("small", SMALL_MPS, 1), ("main", FLAGSHIP, 1), ("main wide", FLAGSHIP_WIDE, 1),
                  ("D=20", UNALIGNED_MPS, 7)]
    mps_shapes += [(f"d={s['phys']} D={s['bond']}", s, 8) for s in REACH_MPS + STREAMED_MPS]
    timed = {"main": ("mps_evaluate", "mps_evaluate_epilogue"), "main wide": CHAIN_STREAMED_TIMED}
    for tag, shape, seed in mps_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            err1, err2 = compare_chains(shape, device, dtype, f"{tag} {dtype}", seed)
            if tag in timed and dtype == torch.float32:
                errors[timed[tag][0]], errors[timed[tag][1]] = err1, err2
    # the streamed path where the tensor-core path runs, beside it
    for s in (SMALL_MPS, UNALIGNED_MPS, *REACH_MPS):
        for dtype in (torch.float32, torch.bfloat16):
            compare_streamed_yardstick(s, device, dtype, f"d={s['phys']} D={s['bond']} {dtype}",
                                       seed=10)
    mpo_shapes = [(tag, shape) for tag, shape in
                  (("small", SMALL_MPO), ("ragged", RAGGED_MPO), ("main", MPO_BENCH))]
    mpo_shapes += [(f"{s['mpo']} D={s['bond']}", s)
                   for s in REACH_MPO + EXACT_MPO + CLUSTER_MPO + STREAMED_MPO]
    for tag, shape in mpo_shapes:
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            if dtype not in shape.get("dtypes", (dtype,)):
                continue
            err = compare_mpo_env(shape, device, dtype, tol, f"#3 mpo_env {tag} {dtype}")
            if tag == "main" and dtype == torch.float32:
                errors["mpo_env"] = err
            if dtype == torch.float32:  # the timed cluster and streamed shapes' (d, W, D)
                for key, bench in {**CLUSTER_TIMED, **STREAMED_TIMED}.items():
                    if (shape.get("mpo"), shape["bond"]) == (bench["mpo"], bench["bond"]):
                        errors[key] = err
    return errors


def compare_chains(shape, device, dtype, what, seed):
    """Kernels #1 and #2 against their plain versions on one input: #1's
    amplitudes, and #2's carry under a float32 and a bfloat16 carry, closed
    with ``right`` in float32 (as the main path closes it).  Each launch
    must count once.  Returns the largest |d log|psi|| of #1 and of #2
    under the float32 carry."""
    from contractn_tpu_torch.ops import cuda_epilogue, cuda_mps

    cores, left, right, x = mps_inputs(shape, device, dtype, seed=seed)
    cond = mps_condition(cores, left, right, x)
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    path = shape.get("path", "tensor_core")
    before = cuda_mps.cuda_mps_evaluate.launches_by_path[path]
    got = cuda_mps.cuda_mps_evaluate(cores, left, right, x)
    assert cuda_mps.cuda_mps_evaluate.launches_by_path[path] == before + 1, (
        f"#1 did not launch on the {path} path")
    err1 = compare_split(got, cuda_mps.mps_evaluate_plain(cores, left, right, x), tol,
                         f"#1 mps_evaluate {what}", cond)
    errs = {}
    for acc in (torch.float32, torch.bfloat16):
        before = cuda_epilogue.epilogue_chain.launches_by_path[path]
        got = cuda_epilogue.epilogue_chain(cores, left, x, acc)
        assert cuda_epilogue.epilogue_chain.launches_by_path[path] == before + 1, (
            f"#2 did not launch on the {path} path")
        assert got[0].dtype == acc and got[0].shape == (x.shape[0], cores.shape[2])
        ref = cuda_epilogue.epilogue_chain_plain(cores, left, x, acc)
        close = [(v.float() @ right, lg) for v, lg in (got, ref)]
        errs[acc] = compare_split(close[0], close[1],
                                  tol if acc == torch.float32 else TOL_BF16,
                                  f"#2 epilogue {what} acc {acc}", cond)
    return err1, errs[torch.float32]


def compare_streamed_yardstick(shape, device, dtype, what, seed):
    """The chain kernels' streamed path through ``mps_chain_streamed`` (at
    a shape the entries give the tensor-core path) against the plain
    versions: the close (#1) and the carry under both carries (#2), each
    launch counted once."""
    from contractn_tpu_torch.ops import cuda_epilogue, cuda_mps

    cores, left, right, x = mps_inputs(shape, device, dtype, seed=seed)
    cond = mps_condition(cores, left, right, x)
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    for acc in (None, torch.float32, torch.bfloat16):
        before = cuda_mps.mps_chain_streamed.launches
        got = cuda_mps.mps_chain_streamed(cores, left, right, x, acc)
        assert cuda_mps.mps_chain_streamed.launches == before + 1, "the yardstick did not launch"
        if acc is None:
            ref = cuda_mps.mps_evaluate_plain(cores, left, right, x)
        else:
            assert got[0].dtype == acc and got[0].shape == (x.shape[0], cores.shape[2])
            ref = cuda_epilogue.epilogue_chain_plain(cores, left, x, acc)
            got, ref = [(v.float() @ right, lg) for v, lg in (got, ref)]
        compare_split(got, ref, TOL_BF16 if acc == torch.bfloat16 else tol,
                      f"streamed yardstick {what} {'close' if acc is None else acc}", cond)


def compare_mpo_env(shape, device, dtype, tol, what, seed=3):
    """Kernel #3 against its plain version: the closed environments as split
    pairs, tolerance ``tol`` per unit of the close's condition number.  The
    launch must count once, on the path ``shape["path"]`` names (the
    tensor-core one by default)."""
    from contractn_tpu_torch.ops import cuda_mpo
    from contractn_tpu_torch.ops.cuda_mpo import mpo_entries

    mpo, cores, ones = mpo_inputs(shape, device, dtype, seed=seed)
    wdim, bond = mpo.cores.shape[3], shape["bond"]
    env0 = torch.einsum("w,i,k->wik", mpo.left, ones, ones).reshape(-1, bond)
    entries = mpo_entries(mpo)
    weight = torch.einsum("w,i,k->wik", mpo.right, ones, ones).reshape(-1)
    path = shape.get("path", "tensor_core")
    before = cuda_mpo.mpo_env.launches, dict(cuda_mpo.mpo_env.launches_by_path)
    got = cuda_mpo.mpo_env(cores, env0, entries, wdim)
    assert cuda_mpo.mpo_env.launches == before[0] + 1
    assert cuda_mpo.mpo_env.launches_by_path[path] == before[1][path] + 1, (
        f"{what}: the {path} path did not launch")
    ref = cuda_mpo.mpo_env_plain(cores, env0, entries, wdim)
    close = [(env.reshape(env.shape[0], -1) @ weight, lg) for env, lg in (got, ref)]
    return compare_split(close[0], close[1], tol, what,
                         condition(ref[0].reshape(ref[0].shape[0], -1) * weight))


def reset_counters():
    from contractn_tpu_torch.ops import cuda_epilogue, cuda_mpo, cuda_mps

    for fn in (cuda_mps.cuda_mps_evaluate, cuda_epilogue.epilogue_chain, cuda_mpo.mpo_env):
        fn.launches = 0
        for path in fn.launches_by_path:
            fn.launches_by_path[path] = 0


def read_counters():
    from contractn_tpu_torch.ops import cuda_epilogue, cuda_mpo, cuda_mps

    counts = {}
    for name, fn in (("mps_evaluate", cuda_mps.cuda_mps_evaluate),
                     ("mps_evaluate_epilogue", cuda_epilogue.epilogue_chain),
                     ("mpo_env", cuda_mpo.mpo_env)):
        counts[name] = fn.launches
        counts.update({f"{name}.{path}": n for path, n in fn.launches_by_path.items()})
    return counts


def _example(name):
    """The module ``examples/torch/<name>.py`` of the checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def readme_examples(device):
    """The README's three examples through the port's example script
    (``examples/torch/readme_examples.py``) on ``device``."""
    import numpy as np

    ex = _example("readme_examples")
    out = ex.copy_tensor_example(device)
    assert out.device.type == device.type
    np.testing.assert_allclose(out.cpu().numpy(), [1.0, 0.99 ** 100], rtol=1e-10)

    # random factors: on np.eye both results are symmetric in their output
    # indices, and a wrong output order would pass
    mats = [np.random.default_rng(i).standard_normal((4, 10)) for i in range(3)]
    cp, tucker = ex.einsum_string_example(mats)
    assert cp.einsum_str == "ac,ad,ae->cde", cp.einsum_str
    assert tucker.einsum_str == "abc,ae,bf,cg->efg", tucker.einsum_str
    np.testing.assert_allclose(cp.contract(device=device).cpu().numpy(),
                               np.einsum("ac,ad,ae->cde", *mats), rtol=1e-10)
    np.testing.assert_allclose(tucker.contract(device=device).cpu().numpy(),
                               np.einsum("abc,ae,bf,cg->efg", np.ones((4,) * 3), *mats),
                               rtol=1e-10)

    plain, mant, log_scale = ex.stable_contraction_example(device)
    assert bool(plain.isinf().all())
    np.testing.assert_allclose(mant.cpu().numpy(), [1.0, 1.0, 1.0], rtol=1e-10)
    assert abs(float(log_scale) - 1000 * math.log(3.0)) < 1e-8, float(log_scale)
    log(f"  README examples on {device}: copy-101, CP/Tucker strings and values, "
        f"1000-link chain log = {float(log_scale):.10f}")


def main_path(device, flagship=FLAGSHIP, mpo_shape=MPO_BENCH, check=16):
    """The user-facing main path; returns ``{path: (counts, seconds)}``.

    Each path runs with every launch count zeroed just before it and read
    just after; ``check`` samples of each are held against float64.
    """
    from contractn_tpu_torch.models import MPS
    from contractn_tpu_torch.ops import mps_evaluate
    from contractn_tpu_torch.ops.cuda_epilogue import mps_evaluate_epilogue

    runs = {}
    drive = _drive_into(runs, device)
    drive("readme", lambda: readme_examples(device))

    n, d, bond, batch = (flagship[k] for k in ("n_sites", "phys", "bond", "batch"))
    gen = torch.Generator(device=device).manual_seed(0)
    mps = MPS.random(n, d, bond, generator=gen, device=device)
    x = torch.randn((batch, n, d), generator=gen, device=device)
    amp, lg = drive("mps_evaluate", lambda: mps.evaluate(x))
    ref = mps_evaluate(mps.cores.double(), mps.left.double(), mps.right.double(),
                       x[:check].double())
    cond = mps_condition(mps.cores, mps.left, mps.right, x[:check])
    _check_reference("MPS.evaluate", (amp, lg), ref, batch, cond)
    amp2, lg2 = drive("mps_evaluate_epilogue",
                      lambda: mps_evaluate_epilogue(mps.cores, mps.left, mps.right, x))
    _check_reference("mps_evaluate_epilogue", (amp2, lg2), ref, batch, cond)

    mpo_expectation_path(drive, "mpo_expectation", device, mpo_shape, check)
    return runs


def cluster_main_path(device, shape=CLUSTER_BENCH, check=16):
    """#3's cluster path as a user reaches it: the batched Heisenberg
    expectation at bond 128 (``shape``), its launch counts zeroed just
    before and read just after; returns ``{path: (counts, seconds)}``."""
    runs = {}
    mpo_expectation_path(_drive_into(runs, device), "mpo_expectation_cluster", device, shape, check)
    return runs


def streamed_main_path(device, shape=STREAMED_BENCH, check=16):
    """#3's streamed path as a user reaches it: the batched spin-1 AKLT
    expectation (d 3, W 14, bond 64: ``shape``), its launch counts zeroed
    just before and read just after; returns ``{path: (counts, seconds)}``."""
    runs = {}
    mpo_expectation_path(_drive_into(runs, device), "mpo_expectation_streamed", device, shape,
                         check)
    return runs


def streamed_chain_main_path(device, shape=FLAGSHIP_WIDE, check=16):
    """#1 and #2 on their streamed path as a user reaches them: the flagship
    widened to bond 256 (``shape``) through ``MPS.evaluate(x,
    kernel="cuda")`` and ``mps_evaluate_epilogue``, each with its launch
    counts zeroed just before and read just after, ``check`` samples held
    against float64; returns ``{path: (counts, seconds)}``."""
    from contractn_tpu_torch.models import MPS
    from contractn_tpu_torch.ops import mps_evaluate
    from contractn_tpu_torch.ops.cuda_epilogue import mps_evaluate_epilogue

    runs = {}
    drive = _drive_into(runs, device)
    n, d, bond, batch = (shape[k] for k in ("n_sites", "phys", "bond", "batch"))
    gen = torch.Generator(device=device).manual_seed(1)
    mps = MPS.random(n, d, bond, generator=gen, device=device)
    x = torch.randn((batch, n, d), generator=gen, device=device)
    amp, lg = drive("mps_evaluate_streamed", lambda: mps.evaluate(x, kernel="cuda"))
    ref = mps_evaluate(mps.cores.double(), mps.left.double(), mps.right.double(),
                       x[:check].double())
    cond = mps_condition(mps.cores, mps.left, mps.right, x[:check])
    _check_reference(f"MPS.evaluate at D={bond}", (amp, lg), ref, batch, cond)
    amp2, lg2 = drive("mps_evaluate_epilogue_streamed",
                      lambda: mps_evaluate_epilogue(mps.cores, mps.left, mps.right, x))
    _check_reference(f"mps_evaluate_epilogue at D={bond}", (amp2, lg2), ref, batch, cond)
    return runs


def _drive_into(runs, device):
    """``drive(name, fn)``: run ``fn`` with every launch count zeroed just
    before and read just after, into ``runs[name] = (counts, seconds)``."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def drive(name, fn):
        reset_counters()
        t0 = time.perf_counter()
        out = fn()
        sync()
        runs[name] = (read_counters(), time.perf_counter() - t0)
        return out

    return drive


def mpo_expectation_path(drive, name, device, shape, check, seed=4):
    """``mpo_expectation_cuda`` at ``shape`` through ``drive``; its first
    ``check`` samples held against float64 ``MPO.expectation``."""
    from contractn_tpu_torch.models import MPO, MPS
    from contractn_tpu_torch.ops import mpo_expectation_cuda
    from contractn_tpu_torch.ops.cuda_mpo import mpo_entries, mpo_env_plain

    mpo, cores, ones = mpo_inputs(shape, device, torch.float32, seed=seed)
    val, lv = drive(name, lambda: mpo_expectation_cuda(mpo, cores, ones, ones))
    mpo64 = MPO(mpo.cores.double(), mpo.left.double(), mpo.right.double())
    refs = [mpo64.expectation(MPS(c.double(), ones.double(), ones.double()))
            for c in cores[:check]]
    ref_mpo = (torch.stack([r[0] for r in refs]), torch.stack([r[1] for r in refs]))
    wdim, bond = mpo.cores.shape[3], shape["bond"]
    env0 = torch.einsum("w,i,k->wik", mpo.left, ones, ones).reshape(-1, bond)
    env, _ = mpo_env_plain(cores[:check], env0, mpo_entries(mpo), wdim)
    weight = torch.einsum("w,i,k->wik", mpo.right, ones, ones).reshape(-1)
    _check_reference(f"batched MPO expectation ({name})", (val, lv), ref_mpo, shape["batch"],
                     condition(env.reshape(env.shape[0], -1) * weight))


def _check_reference(what, got, ref, batch, cond):
    """Shape and finiteness of a path's output, and agreement of its first
    samples with a float64 reference (tolerance as for the kernels)."""
    amp, lg = got
    assert amp.shape == (batch,) and lg.shape == (batch,), (what, amp.shape)
    assert bool(torch.isfinite(amp).all() and torch.isfinite(lg).all()), what
    k = ref[0].shape[0]
    compare_split((amp[:k], lg[:k]), ref, TOL_F32,
                  f"{what} ({batch} finite) vs float64", cond)


def training_paths(device, smi, train=TRAIN, odd_sites=TRAIN_ODD_SITES, born=BORN,
                   fit_steps=FIT_TN_STEPS, check=16):
    """The training paths through the user entry points; returns
    ``{path: (counts, seconds)}``.

    Each path runs with every launch count zeroed just before it and read
    just after: no training step may launch a hand kernel (they have no
    backward), and serving the trained MPS under ``torch.no_grad()`` must
    launch #1.  Per-step host-clock times end in a synchronize.
    """
    from contractn_tpu_torch import TN
    from contractn_tpu_torch.models import MPS
    from contractn_tpu_torch.models.born import (
        born_machine, born_nll, fit_born_machine, mps_log_prob)
    from contractn_tpu_torch.models.sampling import sample
    from contractn_tpu_torch.ops.scan import mps_evaluate_auto
    from contractn_tpu_torch.parallel import fit_tn, make_train_step

    runs = {}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def drive(name, fn):
        reset_counters()
        out, secs = timed(fn)
        runs[name] = (read_counters(), secs)
        return out

    n, d, bond, batch = (train[k] for k in ("n_sites", "phys", "bond", "batch"))
    step = make_train_step(lr=train["lr"])

    def train_steps(mps, x, y, tag):
        losses = []
        for i in range(train["steps"]):
            (mps, loss), secs = timed(lambda: step(mps, x, y))
            losses.append(float(loss))
            log(f"  train {tag} step {i}: {1e3 * secs:.1f} ms, loss {losses[-1]:.6g} ({smi})")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train {tag}: non-finite loss {losses}")
        return mps

    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        gen = torch.Generator(device=device).manual_seed(11)
        mps = MPS.random(n, d, bond, dtype=dtype, generator=gen, device=device)
        x = torch.randn((batch, n, d), generator=gen, device=device).to(dtype)
        y = torch.zeros((batch,), dtype=dtype, device=device)
        if dtype == torch.float32:
            grad_check(mps, x, y)
        mps = drive(f"train_{tag}", lambda: train_steps(mps, x, y, tag))

    # serving the trained float32 model: under no_grad, #1 once, held
    # against the differentiable loop
    amp, lg = drive("serve_trained", lambda: _no_grad(lambda: mps.evaluate(x)))
    assert amp.shape == (batch,) and bool(torch.isfinite(amp).all() and torch.isfinite(lg).all())
    ref = _no_grad(lambda: mps_evaluate_auto(mps.cores, mps.left, mps.right, x[:check]))
    compare_split((amp[:check], lg[:check]), ref, TOL_F32,
                  "trained MPS: #1 vs the differentiable loop",
                  mps_condition(mps.cores, mps.left, mps.right, x[:check]))

    gen = torch.Generator(device=device).manual_seed(12)
    odd = MPS.random(odd_sites, d, bond, generator=gen, device=device)
    x_odd = torch.randn((batch, odd_sites, d), generator=gen, device=device)
    y_odd = torch.zeros((batch,), device=device)
    new, loss = drive("train_odd", lambda: step(odd, x_odd, y_odd))
    moved = float((new.cores - odd.cores).abs().max())
    log(f"  train {odd_sites} sites, one site a step: {1e3 * runs['train_odd'][1]:.1f} ms, "
        f"loss {float(loss):.6g}, largest update {moved:.3e} ({smi})")
    if not (math.isfinite(float(loss)) and moved > 0):
        raise AssertionError(f"{odd_sites}-site step: no gradient reached the cores")

    nb, bb, batch_b, steps_b = (born[k] for k in ("n_sites", "bond", "batch", "steps"))
    gen = torch.Generator(device=device).manual_seed(13)
    model = born_machine(nb, 2, bb, dtype=torch.float32, generator=gen, device=device)
    data = torch.randint(0, 2, (batch_b, nb), generator=gen, device=device)
    nll0 = float(_no_grad(lambda: born_nll(model, data)))
    model, losses = drive("born_fit", lambda: fit_born_machine(
        model, data, steps=steps_b, lr=born["lr"]))
    nll1 = float(_no_grad(lambda: born_nll(model, data)))
    log(f"  Born fit {nb} x {bb} x {batch_b}: {steps_b} Adam steps in "
        f"{runs['born_fit'][1]:.3f} s, the process's first; NLL {nll0:.6f} -> "
        f"{nll1:.6f} ({smi})")
    if not (bool(torch.isfinite(losses).all()) and nll1 < nll0):
        raise AssertionError(f"Born fit: NLL {nll0} -> {nll1}, losses {losses.tolist()}")

    def born_steps():  # one step a call, each timed: the steady state
        secs = [timed(lambda: fit_born_machine(model, data, steps=1, lr=born["lr"]))[1]
                for _ in range(3)]
        log(f"  Born step {nb} x {bb} x {batch_b}, one fit_born_machine(steps=1) "
            f"call each: {', '.join(f'{1e3 * t:.1f}' for t in secs)} ms ({smi})")

    drive("born_step", born_steps)

    samples, logp = drive("sample", lambda: sample(model, batch_b, generator=gen))
    assert samples.shape == (batch_b, nb) and samples.device.type == device.type
    err32 = float((logp - _no_grad(lambda: mps_log_prob(model, samples))).abs().max())
    m64 = MPS(model.cores.double(), model.left.double(), model.right.double())
    s64, logp64 = sample(m64, check, generator=gen)
    err64 = float((logp64 - mps_log_prob(m64, s64)).abs().max())
    log(f"  sample {batch_b} from the trained Born machine: {runs['sample'][1]:.3f} s "
        f"({smi}); |log p - mps_log_prob| max {err32:.3e} in fp32 (tol {TOL_LOGP_F32}), "
        f"{err64:.3e} in fp64 (tol {TOL_LOGP_F64})")
    if err32 > TOL_LOGP_F32 or err64 > TOL_LOGP_F64:
        raise AssertionError("sampler log p disagrees with mps_log_prob")

    rng = torch.Generator().manual_seed(0)
    factors = [torch.randn((2, 4), generator=rng, dtype=torch.float64) for _ in range(3)]
    target = torch.einsum("ra,rb,rc->abc", *factors).to(device)
    tn = TN()
    hub = tn.add_copy_node(3, dim=3)
    for i in range(3):
        tn.connect_nodes(hub, tn.add_dense_node(
            0.3 * torch.randn((3, 4), generator=rng, dtype=torch.float64)), i, 0)

    def cp_loss(out, target):
        mant, log_scale = out
        return torch.mean((mant * torch.exp(log_scale) - target) ** 2)

    trace = drive("fit_tn", lambda: fit_tn(
        tn, lambda p: torch.optim.Adam(p, lr=0.05), cp_loss, steps=fit_steps,
        batch=(target,), device=device))
    devices = {p.device.type for p in tn.params}
    log(f"  fit_tn CP: loss {trace[0]:.4g} -> {trace[-1]:.4g} in {fit_steps} Adam steps, "
        f"{runs['fit_tn'][1]:.3f} s; node tensors on {sorted(devices)} ({smi})")
    if not (trace[-1] < trace[0] and devices == {device.type}):
        raise AssertionError("fit_tn did not train, or moved the node tensors")

    for path, (counts, _) in runs.items():
        # on the CPU (a rehearsal) the wrappers run their plain versions
        want = int(path == "serve_trained" and device.type == "cuda")
        if counts["mps_evaluate"] != want or any(  # kernels, not their per-path counts
                v for k, v in counts.items() if k != "mps_evaluate" and "." not in k):
            raise AssertionError(f"path {path}: launches {counts}")
    return runs


def _no_grad(fn):
    with torch.no_grad():
        return fn()


def grad_check(mps, x, y):
    """The float32 gradient of the log-MSE loss against float64 on the same
    parameters and data, as relative Frobenius error over cores, left and
    right together.

    As for log|psi| (``compare_split``), the check holds on the samples whose
    log|psi| is determined at float32 precision (``TOL_F32 * cond <= 1``):
    there it must stay within ``TOL_GRAD``.  The whole batch's error is
    reported beside it; it is set by the worst-conditioned samples, whose
    gradients (1/psi) are both the largest and the least accurate.
    """
    from contractn_tpu_torch.models import MPS
    from contractn_tpu_torch.parallel import loss_fn

    def rel_err(idx):
        grads = {}
        for dtype in (torch.float32, torch.float64):
            params = [t.detach().to(dtype).requires_grad_(True)
                      for t in (mps.cores, mps.left, mps.right)]
            loss = loss_fn(MPS(*params), x[idx].to(dtype), y[idx].to(dtype))
            grads[dtype] = torch.cat([g.reshape(-1)
                                      for g in torch.autograd.grad(loss, params)])
        g32, g64 = grads[torch.float32].double(), grads[torch.float64]
        return float((g32 - g64).norm() / g64.norm())

    cond = mps_condition(mps.cores, mps.left, mps.right, x)
    keep = torch.nonzero(TOL_F32 * cond <= 1)[:, 0].to(x.device)
    rel_all, rel = rel_err(torch.arange(x.shape[0], device=x.device)), rel_err(keep)
    log(f"  step-0 gradient, fp32 vs fp64, relative Frobenius error: {rel:.3e} over the "
        f"{keep.numel()}/{x.shape[0]} samples with {TOL_F32} x cond <= 1 (tol {TOL_GRAD}); "
        f"{rel_all:.3e} over the whole batch (cond median {float(cond.median()):.3g}, "
        f"max {float(cond.max()):.3g})")
    if not rel <= TOL_GRAD:
        raise AssertionError(f"fp32 gradient off by {rel:.3e} relative")
    return rel


# ---------------------------------------------------------------- phase 7

SX = ((0.0, 1.0), (1.0, 0.0))
SZ = ((1.0, 0.0), (0.0, -1.0))


def graph_paths(device, smi, sizes=GRAPH):
    """Phase 7: the graph paths through the user entry points; returns
    ``{path: (counts, seconds)}``.  Each path runs with every launch count
    zeroed just before it and read just after: none may launch a hand
    kernel (none of them reaches one)."""
    runs = {}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def drive(name, fn):
        reset_counters()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        runs[name] = (read_counters(), time.perf_counter() - t0)
        return out

    drive("lowering", lambda: lowering_path(device, smi, sizes["lowering"]))
    drive("native_greedy", lambda: native_path(device, smi, sizes["native"]))
    drive("random_greedy", lambda: random_greedy_path(device, smi, sizes["native"]))
    t0 = time.perf_counter()
    ising = ising_tn(sizes["ising"]["n_spins"], sizes["ising"]["beta"])
    log(f"  Ising network built on the host in {time.perf_counter() - t0:.1f} s "
        f"({smi})")
    for dtype in (torch.float64, torch.float32):
        drive(f"bp_ising_{str(dtype)[6:]}",
              lambda: ising_path(device, smi, sizes["ising"], ising, dtype))
    drive("simple_update", lambda: simple_update_path(device, smi, sizes["grid"]))
    drive("simple_update_anchor",
          lambda: anchor_path(device, smi, sizes["anchor"]))
    drive("bp_ground_state", lambda: descent_path(device, smi, sizes["ring"]))
    for path, (counts, _) in runs.items():
        if any(counts.values()):
            raise AssertionError(f"path {path}: hand-kernel launches {counts}")
    return runs


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lowering_path(device, smi, cfg):
    """A mixed-dimension chain through ``contract(optimize="greedy")``: the
    bucketed plan against the per-step loop, the float64 oracle, and the
    same signature through ``contract_expression`` and ``TN.compile``."""
    import dataclasses

    import numpy as np

    from contractn_tpu_torch import contract, contract_expression
    from contractn_tpu_torch.compiler import engine
    from contractn_tpu_torch.models.decompositions import matrix_chain_tn
    from contractn_tpu_torch.symbols import get_symbol

    n, (d0, d1), block = cfg["n_mats"], cfg["dims"], cfg["block"]
    dims = [d0 if (i // block) % 2 == 0 else d1 for i in range(n + 1)]
    rng = np.random.default_rng(21)  # as tests/test_engine.py:498 draws them
    mats64 = [rng.standard_normal((dims[i], dims[i + 1])) * 0.5 for i in range(n)]
    mats = [torch.from_numpy(m.astype(np.float32)).to(device) for m in mats64]
    einstr = ",".join(get_symbol(i) + get_symbol(i + 1) for i in range(n)) \
        + "->" + get_symbol(0) + get_symbol(n)
    shapes = tuple(m.shape for m in mats64)

    (mant, lg), secs = _timed(lambda: contract(
        einstr, *mats, split_format=True, optimize="greedy"), device)
    plan = engine._plan(einstr, shapes, "greedy", None)
    if plan.route != "steps" or plan.buckets is None:
        raise AssertionError(f"lowering: the chain did not reach the buckets "
                             f"(route {plan.route})")
    kinds = {}
    for item in plan.buckets.plan:
        kinds[item["kind"]] = kinds.get(item["kind"], 0) + 1
    _, ref_log = contract(einstr, *mats64, split_format=True, optimize="greedy",
                          backend="numpy")
    err = abs(float(lg) - float(ref_log))
    rel = err / abs(float(ref_log))
    finite = bool(torch.isfinite(mant).all())
    log(f"  lowering: {n} matrices, bonds {d0}/{d1} in blocks of {block}, fp32: "
        f"{len(plan.buckets)} plan items for {len(plan.steps)} steps {kinds}; "
        f"plan built in {plan.build_ms:.1f} ms; first call {1e3 * secs:.1f} ms "
        f"({smi}); log {float(lg):.10g} vs float64 oracle {float(ref_log):.10g} "
        f"(absolute {err:.3e}, relative {rel:.3e}, tol {TOL_LOWERING_LOG})")
    if not (finite and mant.shape == (d0, dims[-1]) and rel <= TOL_LOWERING_LOG):
        raise AssertionError("lowering: result disagrees with the float64 oracle")
    if n == 4096 and len(plan.buckets) != cfg["jax_plan_items"]:
        raise AssertionError(f"lowering: {len(plan.buckets)} plan items, the JAX "
                             f"package plans {cfg['jax_plan_items']}")

    loop_plan = dataclasses.replace(plan, buckets=None)
    times = {"bucketed": [], "per-step loop": []}
    for _ in range(cfg["reps"]):
        for name, p in (("bucketed", plan), ("per-step loop", loop_plan)):
            (out, out_log), t = _timed(lambda: engine._run(p, mats), device)
            times[name].append(1e3 * t)
            if abs(float(out_log) - float(lg)) > 1e-4 * abs(float(lg)):
                raise AssertionError(f"lowering: the {name} run disagrees")
    log("  lowering warm times (host clock ending in a synchronize): "
        + "; ".join(f"{k} {', '.join(f'{t:.1f}' for t in v)} ms"
                    for k, v in times.items()) + f" ({smi})")

    expr = contract_expression(einstr, *shapes, split_format=True,
                               optimize="greedy")
    (_, e_log), secs = _timed(lambda: expr(*mats), device)
    tn = matrix_chain_tn(mats)
    compiled = tn.compile(split_format=True, optimize="greedy")
    stats = compiled.measure_compile()
    _, c_log = compiled()
    for what, value in (("contract_expression", e_log), ("TN.compile", c_log)):
        if abs(float(value) - float(lg)) > 1e-4 * abs(float(lg)):
            raise AssertionError(f"lowering: {what} disagrees ({float(value)})")
    log(f"  contract_expression call {1e3 * secs:.1f} ms; TN.compile(...)"
        f".measure_compile(): {stats} ({smi})")


def native_path(device, smi, cfg):
    """A random regular network on the native greedy path, against the
    float64 oracle on the same path."""
    import numpy as np

    from contractn_tpu_torch.models.decompositions import random_regular_tn
    from contractn_tpu_torch.native import native_available

    if not native_available():
        raise AssertionError("native path optimizer: could not build or load it")
    tn, _ = random_regular_tn(cfg["n_nodes"], cfg["degree"], cfg["bond"],
                              rng=np.random.default_rng(cfg["seed"]))
    info = tn.contraction_info(optimize="native-greedy")
    (mant, lg), secs = _timed(lambda: tn.contract(
        split_format=True, optimize="native-greedy", device=device), device)
    ref_m, ref_l = tn.contract(split_format=True, optimize="native-greedy",
                               backend="numpy")
    got = math.log(abs(float(mant))) + float(lg)
    want = math.log(abs(float(ref_m))) + float(ref_l)
    same_sign = (float(mant) > 0) == (float(ref_m) > 0)
    log(f"  native-greedy: random 3-regular, {cfg['n_nodes']} nodes, bond "
        f"{cfg['bond']}, seed {cfg['seed']}: {info.flops:.3e} FLOPs, largest "
        f"intermediate {info.largest_intermediate:.3e} elements; {1e3 * secs:.1f} ms "
        f"on the card (float64, path search included, {smi}); log|Z| {got:.12g} vs "
        f"oracle {want:.12g}")
    if not (same_sign and abs(got - want) <= 1e-9 * abs(want)):
        raise AssertionError("native-greedy contraction disagrees with the oracle")


def random_greedy_path(device, smi, cfg):
    """opt_einsum's random-greedy family on the native path's network: each
    strategy's log|Z| on the card in float64 against the numpy oracle on the
    same path, each search run twice (the same path both times), and each
    path's cost beside greedy's and native greedy's."""
    import numpy as np

    from contractn_tpu_torch.compiler.engine import _parse
    from contractn_tpu_torch.compiler.paths import find_path
    from contractn_tpu_torch.models.decompositions import random_regular_tn

    tn, _ = random_regular_tn(cfg["n_nodes"], cfg["degree"], cfg["bond"],
                              rng=np.random.default_rng(cfg["seed"]))
    einstr, pack = tn._compiled_spec()
    shapes = tuple(tuple(int(d) for d in t.shape) for t in pack(tn.params, ()))
    terms, output = _parse(einstr)
    for name in ("greedy", "native-greedy"):
        info = tn.contraction_info(optimize=name)
        log(f"  {name}: {info.flops:.4e} FLOPs, largest intermediate "
            f"{info.largest_intermediate:.4e} elements")
    paths = {}
    for name in ("random-greedy", "random-greedy-128", "auto-hq"):
        t0 = time.perf_counter()
        paths[name] = find_path.__wrapped__(tuple(terms), output, shapes, name, None)
        search = time.perf_counter() - t0
        if name != "auto-hq" and find_path.__wrapped__(
                tuple(terms), output, shapes, name, None) != paths[name]:
            raise AssertionError(f"{name}: a second search found another path")
        info = tn.contraction_info(optimize=name)
        (mant, lg), secs = _timed(lambda: tn.contract(
            split_format=True, optimize=name, device=device), device)
        ref_m, ref_l = tn.contract(split_format=True, optimize=name, backend="numpy")
        got = math.log(abs(float(mant))) + float(lg)
        want = math.log(abs(float(ref_m))) + float(ref_l)
        same_sign = (float(mant) > 0) == (float(ref_m) > 0)
        log(f"  {name}: {info.flops:.4e} FLOPs, largest intermediate "
            f"{info.largest_intermediate:.4e} elements; search {search:.3f} s on the "
            f"host, contraction {1e3 * secs:.1f} ms on the card (float64, {smi}); "
            f"log|Z| {got:.12g} vs oracle {want:.12g}")
        if not (same_sign and abs(got - want) <= 1e-9 * abs(want)):
            raise AssertionError(f"{name} contraction disagrees with the oracle")
    if paths["auto-hq"] != paths["random-greedy-128"]:
        raise AssertionError("auto-hq above 16 operands is not random-greedy-128")


def ising_tn(n_spins, beta, seed=0):
    """Ising model on a random 3-regular multigraph: ``n_spins`` copy nodes
    (degree 3, dim 2) paired by a seeded configuration model, one dense
    2 x 2 bond node (numpy, float64) per edge."""
    import numpy as np

    from contractn_tpu_torch import TN

    bond = np.array([[math.exp(beta), math.exp(-beta)],
                     [math.exp(-beta), math.exp(beta)]])
    stubs = np.repeat(np.arange(n_spins), 3)
    np.random.default_rng(seed).shuffle(stubs)
    tn = TN()
    spins = [tn.add_copy_node(3, dim=2, name=f"v{i}") for i in range(n_spins)]
    mode_next = [0] * n_spins
    for k in range(0, len(stubs), 2):
        a, b = int(stubs[k]), int(stubs[k + 1])
        e = tn.add_dense_node(bond, name=f"e{k // 2}")
        tn.connect_nodes(spins[a], e, mode_next[a], 0)
        mode_next[a] += 1
        tn.connect_nodes(spins[b], e, mode_next[b], 1)
        mode_next[b] += 1
    return tn


def ising_path(device, smi, cfg, tn, dtype):
    """``bp_contract`` on the 3-regular Ising model ``tn`` with its bond
    tensors in ``dtype``: ln Z_BP must equal the closed form
    ``N ln 2 + (3N/2) ln cosh(beta)``."""
    from contractn_tpu_torch import bp_contract
    from contractn_tpu_torch.compiler.bp import BPGraph

    n, beta = cfg["n_spins"], cfg["beta"]
    for node in tn.nodes():
        if not node.is_copy:
            node.tensor = node.tensor.astype(str(dtype)[6:])
    (phase, lg), secs = _timed(lambda: bp_contract(tn, device=device), device)
    got = math.log(abs(float(phase))) + float(lg)
    analytic = n * math.log(2) + 1.5 * n * math.log(math.cosh(beta))
    rel = abs(got - analytic) / analytic
    graph, plan_s = _timed(lambda: BPGraph(tn, device=device), device)
    stacks = graph.stacks()
    (iters, _, _), solve = _timed(lambda: graph.fixed_point(stacks, 1e-12, 200, 0.0),
                                  device)
    k = cfg["timed_sweeps"]
    _, swept = _timed(lambda: graph.sweeps(stacks, k, 0.0), device)
    log(f"  bp_contract, Ising on a random 3-regular multigraph, {n} spins + "
        f"{3 * n // 2} bonds, beta {beta}, {str(dtype)[6:]}: ln Z {got:.12g} vs "
        f"{analytic:.12g} (relative {rel:.3e}, tol {TOL_BETHE[dtype]}); call "
        f"{1e3 * secs:.1f} ms; plan {1e3 * plan_s:.1f} ms, {len(graph.groups)} node "
        f"groups; {iters} sweep(s) to the fixed point in {1e3 * solve:.1f} ms; "
        f"{1e3 * swept / k:.3f} ms a sweep over {k} sweeps ({smi})")
    if not rel <= TOL_BETHE[dtype]:
        raise AssertionError("Bethe free energy disagrees with the closed form")


def grid_tn(side, device):
    """|0...0> on an open side x side grid, bond 1, physical mode first,
    node tensors on ``device``; returns ``(tn, pairs, coordination)``."""
    from contractn_tpu_torch import TN

    tn = TN()
    names, coord = {}, {}
    for x in range(side):
        for y in range(side):
            deg = sum([x > 0, x < side - 1, y > 0, y < side - 1])
            t = torch.zeros((2,) + (1,) * deg, dtype=torch.float64, device=device)
            t[(0,) * (deg + 1)] = 1.0
            names[(x, y)] = f"g{x}_{y}"
            coord[names[(x, y)]] = deg
            tn.add_dense_node(t, name=names[(x, y)])
    mode_next = {k: 1 for k in names}
    pairs = []
    for x in range(side):
        for y in range(side):
            for nb in ((x + 1, y), (x, y + 1)):
                if nb in names:
                    a, b = (x, y), nb
                    tn.connect_nodes(names[a], names[b], mode_next[a], mode_next[b])
                    mode_next[a] += 1
                    mode_next[b] += 1
                    pairs.append((names[a], names[b]))
    return tn, pairs, coord


def tfim_bond_terms(pairs, coord, h):
    """Per-bond TFIM terms, the field split by coordination."""
    import numpy as np

    sx, sz, eye = np.array(SX), np.array(SZ), np.eye(2)
    return [(a, b, -np.kron(sz, sz) - (h / coord[a]) * np.kron(sx, eye)
             - (h / coord[b]) * np.kron(eye, sx)) for a, b in pairs]


def simple_update(device, cfg, side):
    """``layers`` imaginary-time TFIM layers of every nearest-neighbour gate
    through ``bp_apply_gates``, then the BP energy per site from
    ``bp_measure``; returns ``(energy per site, spectra, seconds, measure
    seconds)``."""
    from contractn_tpu_torch import bp_apply_gates, bp_measure, gate_from_term

    tn, pairs, coord = grid_tn(side, device)
    terms = tfim_bond_terms(pairs, coord, cfg["h"])
    taus = cfg["taus"] if "taus" in cfg else (cfg["tau"],)
    t0 = time.perf_counter()
    for tau in taus:
        gates = [(gate_from_term(h2, tau, imaginary=True, device=device), a, b)
                 for a, b, h2 in terms]
        for _ in range(cfg["layers"]):
            tn, spectra = bp_apply_gates(tn, gates, max_bond=cfg["max_bond"],
                                         renormalize=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, bond_vals = bp_measure(tn, bonds=terms)
    energy = sum(v.real for v in bond_vals) / side ** 2
    return tn, energy, spectra, t1 - t0, time.perf_counter() - t1


def simple_update_path(device, smi, cfg):
    """The grid on the card and on the CPU, both float64: energies and
    normalized spectra agree to ``TOL_CARD_VS_CPU``."""
    side = cfg["side"]
    out = {}
    for dev in (device, torch.device("cpu")):
        _, e, spectra, secs, msecs = simple_update(dev, cfg, side)
        out[dev.type] = (e, spectra)
        n_gates = 2 * side * (side - 1)
        log(f"  simple update {side} x {side} on {dev.type}, float64, "
            f"{cfg['layers']} layers x {n_gates} gates, max_bond {cfg['max_bond']}: "
            f"{secs:.2f} s ({1e3 * secs / (cfg['layers'] * n_gates):.2f} ms a gate); "
            f"bp_measure {1e3 * msecs:.1f} ms; energy per site {e:.12f}; bonds "
            f"{sorted({len(s) for s in spectra})} ({smi})")
    (e_card, s_card), (e_cpu, s_cpu) = out[device.type], out["cpu"]
    worst = max((float((torch.sort(a.cpu())[0] - torch.sort(b)[0]).abs().max())
                 if a.shape == b.shape else math.inf) for a, b in zip(s_card, s_cpu))
    log(f"  card vs CPU: energy per site differs by {abs(e_card - e_cpu):.3e}, "
        f"spectra by {worst:.3e} (tol {TOL_CARD_VS_CPU})")
    if not (abs(e_card - e_cpu) <= TOL_CARD_VS_CPU and worst <= TOL_CARD_VS_CPU):
        raise AssertionError("simple update: card and CPU disagree")


def anchor_path(device, smi, cfg):
    """The 3 x 3 simple-update anchor on the card: the true energy of the
    evolved network within 1% of exact diagonalization."""
    import numpy as np

    side = cfg["side"]
    tn, e_bp, _, secs, _ = simple_update(device, cfg, side)
    n = side * side
    sx, sz = np.array(SX), np.array(SZ)

    def op(o, i):
        m = np.eye(1)
        for j in range(n):
            m = np.kron(m, o if j == i else np.eye(2))
        return m

    hd = np.zeros((2 ** n, 2 ** n))
    for x in range(side):
        for y in range(side):
            i = x * side + y
            for nx, ny in ((x + 1, y), (x, y + 1)):
                if nx < side and ny < side:
                    hd -= op(sz, i) @ op(sz, nx * side + ny)
            hd -= cfg["h"] * op(sx, i)
    e0 = np.linalg.eigvalsh(hd)[0]
    mant, _ = tn.contract(split_format=True)
    psi = mant.double().cpu().numpy().reshape(-1)
    psi = psi / np.linalg.norm(psi)
    e_true = float(psi @ hd @ psi)
    rel = abs(e_true - e0) / abs(e0)
    log(f"  simple-update anchor {side} x {side} on the card: {secs:.2f} s; true "
        f"energy {e_true:.8f} vs exact {e0:.8f} (relative {rel:.2e}, tol 1e-2); "
        f"BP energy {e_bp * n:.8f} ({smi})")
    if not rel < 1e-2:
        raise AssertionError("simple-update anchor: not within 1% of exact")


def ring_tn(n, chi, seed, device):
    """A TFIM ring of (2, chi, chi) tensors, modes (phys, right, left)."""
    from contractn_tpu_torch import TN

    gen = torch.Generator().manual_seed(seed)
    tn = TN()
    for i in range(n):
        t = 0.3 * torch.randn((2, chi, chi), generator=gen, dtype=torch.float64)
        tn.add_dense_node(t.to(device), name=f"s{i}")
    for i in range(n):
        tn.connect_nodes(f"s{i}", f"s{(i + 1) % n}", 1, 2)
    return tn


def descent_path(device, smi, cfg):
    """``bp_ground_state`` on a TFIM ring, on the card and on the CPU in
    float64: the energy trajectories agree to ``TOL_CARD_VS_CPU``."""
    import numpy as np

    from contractn_tpu_torch import bp_ground_state

    n = cfg["n_sites"]
    sx, sz = np.array(SX), np.array(SZ)
    bonds = [(f"s{i}", f"s{(i + 1) % n}", -np.kron(sz, sz)) for i in range(n)]
    local = [(f"s{i}", -cfg["h"] * sx) for i in range(n)]
    out = {}
    for dev in (device, torch.device("cpu")):
        tn = ring_tn(n, cfg["bond"], 31, dev)
        (_, energies), secs = _timed(lambda: bp_ground_state(
            tn, bonds, local, steps=cfg["steps"], lr=cfg["lr"],
            n_sweeps=cfg["n_sweeps"]), dev)
        out[dev.type] = energies.cpu()
        log(f"  bp_ground_state, TFIM ring of {n} at bond {cfg['bond']}, h "
            f"{cfg['h']}, {cfg['n_sweeps']} sweeps, float64 on {dev.type}: "
            f"{cfg['steps']} steps in {secs:.2f} s ({1e3 * secs / cfg['steps']:.1f} "
            f"ms a step); energy per site {float(energies[0]) / n:.8f} -> "
            f"{float(energies[-1]) / n:.8f} ({smi})")
    diff = float((out[device.type] - out["cpu"]).abs().max())
    log(f"  card vs CPU: energies differ by at most {diff:.3e} (tol {TOL_CARD_VS_CPU})")
    if not (diff <= TOL_CARD_VS_CPU and out["cpu"][-1] < out["cpu"][0]):
        raise AssertionError("bp_ground_state: card and CPU disagree, or no descent")


# ---------------------------------------------------------------- phase 8


def tfim_free_fermion(n, h, j=1.0):
    """Ground energy of the open TFIM ``-J sum ZZ - h sum X`` on ``n`` sites:
    minus the sum of the positive eigenvalues of the 2N x 2N chiral
    Bogoliubov matrix ``[[0, B], [B^T, 0]]``, ``B = h 1 + J (superdiagonal)``
    (numpy ``eigh``, float64)."""
    import numpy as np

    b = h * np.eye(n) + j * np.eye(n, k=1)
    m = np.block([[np.zeros((n, n)), b], [b.T, np.zeros((n, n))]])
    vals = np.linalg.eigvalsh(m)
    return -float(vals[vals > 0].sum())


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


class SweepSplit:
    """Synchronizing host-clock timers around the three stages of a
    ``models.dmrg`` sweep (local solve, SVD split, environment update), and
    the start of each sweep; the stages sync the card anyway (a host read a
    solve, cuSOLVER's own syncs), so the timers add little."""

    STAGES = {"_local_ground_penalized": "local solve", "_split_theta": "SVD split",
              "_update_left": "environments", "_update_right": "environments"}

    def __init__(self, device, n_sites):
        import importlib

        # the module, not the function the package exports under its name
        self.mod = importlib.import_module("contractn_tpu_torch.models.dmrg")
        self.per_sweep = 2 * (n_sites - 1)
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        self.seconds = dict.fromkeys(self.STAGES.values(), 0.0)
        self.solves, self.marks, self.saved = 0, [], {}

    def __enter__(self):
        for name, stage in self.STAGES.items():
            fn = self.saved[name] = getattr(self.mod, name)
            setattr(self.mod, name, self._timed(fn, stage))
        return self

    def _timed(self, fn, stage):
        def run(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            if stage == "local solve":
                if self.solves % self.per_sweep == 0:
                    self.marks.append(t0)
                self.solves += 1
            out = fn(*args, **kwargs)
            self.sync()
            self.seconds[stage] += time.perf_counter() - t0
            return out
        return run

    def __exit__(self, *exc):
        self.sync()
        self.marks.append(time.perf_counter())
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)

    def sweep_seconds(self):
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def finite_chains(device, smi, sizes=CHAINS):
    """Phase 8: the DMRG family, TDVP and iTEBD through the user entry points;
    returns ``{path: (counts, seconds)}``.  Each path runs with every launch
    count zeroed just before it and read just after; only serving the
    ground state under ``torch.no_grad()`` may launch a hand kernel (#1,
    exactly once)."""
    runs = {}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def drive(name, fn):
        reset_counters()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        runs[name] = (read_counters(), time.perf_counter() - t0)
        return out

    ground = drive("dmrg_spin1", lambda: spin1_dmrg(device, smi, sizes["spin1"]))
    drive("serve_spin1", lambda: serve_ground_state(device, smi, sizes["spin1"], ground))
    tfim_ground = drive("dmrg_tfim", lambda: tfim_oracle(device, smi, sizes["tfim"]))
    drive("dmrg_ensemble", lambda: ensemble_path(device, smi, sizes["ensemble"]))
    drive("tdvp1_quench", lambda: quench_path(device, smi, sizes["quench"], tfim_ground))
    drive("itebd", lambda: itebd_path(device, smi, sizes["itebd"]))
    drive("opsum_heisenberg", lambda: opsum_path(device, smi, sizes["opsum"]))
    if device.type == "cuda":
        svd_drivers(device, smi, sizes["svd"])
    for path, (counts, _) in runs.items():
        want = {"mps_evaluate": 1} if (path == "serve_spin1" and device.type == "cuda") else {}
        got = {k: v for k, v in counts.items() if v and "." not in k}
        if got != want:
            raise AssertionError(f"path {path}: hand-kernel launches {counts}, want {want}")
    return runs


def spin1_dmrg(device, smi, cfg):
    """The spin-1 Heisenberg chain built through OpSum, two-site DMRG from a
    random MPS at the full bond, with the split of each sweep."""
    from contractn_tpu_torch.models import MPS, OpSum, dmrg, spin_ops

    n, bond = cfg["n_sites"], cfg["bond"]
    h = OpSum()
    for i in range(n - 1):
        h += (1.0, "Sz", i, "Sz", i + 1)
        h += (0.5, "S+", i, "S-", i + 1)
        h += (0.5, "S-", i, "S+", i + 1)
    mpo = h.to_mpo(n, d=3, ops=spin_ops(1), device=device)
    mps0 = MPS.random(n, 3, bond, dtype=torch.float64,
                      generator=_gen(device, cfg["seed"]), device=device)
    with SweepSplit(device, n) as split:
        ground, energy, trace = dmrg(mpo, mps0, max_bond=bond, sweeps=cfg["sweeps"])
    sweeps = split.sweep_seconds()
    total = sum(sweeps)
    gap = energy - cfg["published"]
    log(f"  spin-1 Heisenberg (OpSum, W {mpo.cores.shape[3]}), {n} sites, d 3, "
        f"max_bond {bond}, float64, {cfg['sweeps']} sweeps from a random bond-{bond} "
        f"MPS: sweep times {', '.join(f'{t:.2f}' for t in sweeps)} s ({smi})")
    log(f"    energy trace {', '.join(f'{e:.10f}' for e in trace)}; final {energy:.10f}; "
        f"ITensors.jl's example prints about {cfg['published']}: gap {gap:+.5f}")
    other = total - sum(split.seconds.values())
    log("    split of the sweeps: " + ", ".join(
        f"{k} {v:.2f} s ({100 * v / total:.1f}%)" for k, v in split.seconds.items())
        + f", other {other:.2f} s ({100 * other / total:.1f}%); "
        f"{split.solves} local solves, one host read each (the Lanczos tridiagonal "
        f"or the dense solve's eigenvalue)")
    if not (math.isfinite(energy) and abs(gap) <= cfg["published_tol"]
            and trace[-1] <= trace[0] + 1e-9 * abs(trace[0])):
        raise AssertionError("spin-1 DMRG: energy off the published value")
    return ground


def serve_ground_state(device, smi, cfg, ground):
    """The ground state's amplitudes on sampled configurations, through
    ``MPS.evaluate`` under ``torch.no_grad()`` (#1 on the card), held against
    the plain version with the condition-scaled check."""
    from contractn_tpu_torch.models import MPS
    from contractn_tpu_torch.models.sampling import sample
    from contractn_tpu_torch.ops.cuda_mps import mps_evaluate_plain

    samples, _ = sample(ground, cfg["serve_batch"], generator=_gen(device, 11))
    x = torch.nn.functional.one_hot(samples, ground.phys_dim).to(torch.float32)
    served = MPS(ground.cores.float(), ground.left.float(), ground.right.float())
    reset_counters()
    with torch.no_grad():
        got = served.evaluate(x)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    launches = read_counters()["mps_evaluate"]
    ref = mps_evaluate_plain(served.cores, served.left, served.right, x)
    cond = mps_condition(served.cores, served.left, served.right, x)
    log(f"  served the spin-1 ground state ({ground.n_sites} sites, d 3, bond "
        f"{ground.bond_dim}, as float32) on {x.shape[0]} sampled configurations: "
        f"#1 launches {launches}")
    compare_split(got, ref, TOL_F32, "ground state through #1 vs plain", cond)
    if device.type == "cuda" and launches != 1:
        raise AssertionError(f"serving the ground state launched #1 {launches} times")


def tfim_oracle(device, smi, cfg):
    """DMRG on the critical open TFIM chain against the free-fermion energy."""
    from contractn_tpu_torch.models import MPS, dmrg, tfim_mpo

    n, bond = cfg["n_sites"], cfg["bond"]
    mps0 = MPS.random(n, 2, bond, dtype=torch.float64,
                      generator=_gen(device, cfg["seed"]), device=device)
    t0 = time.perf_counter()
    ground, energy, trace = dmrg(tfim_mpo(n, h=cfg["h"], device=device), mps0,
                                 max_bond=bond, sweeps=cfg["sweeps"])
    secs = time.perf_counter() - t0
    exact = tfim_free_fermion(n, cfg["h"])
    rel = abs(energy - exact) / abs(exact)
    log(f"  TFIM h {cfg['h']}, {n} sites, max_bond {bond}, float64: {cfg['sweeps']} "
        f"sweeps in {secs:.2f} s ({smi}); energy {energy:.12f} vs free fermions "
        f"{exact:.12f} (relative {rel:.2e}, tol {cfg['rtol']})")
    if not rel <= cfg["rtol"]:
        raise AssertionError("TFIM DMRG disagrees with the free-fermion energy")
    return ground


def ensemble_path(device, smi, cfg):
    """One batched search over a field scan, each member against its
    free-fermion energy."""
    import numpy as np

    from contractn_tpu_torch.models import MPS, dmrg_ensemble, stack_pytrees, tfim_mpo

    k, n, bond = cfg["n_members"], cfg["n_sites"], cfg["bond"]
    hs = np.linspace(cfg["h"][0], cfg["h"][1], k)
    gen = _gen(device, cfg["seed"])
    mpos = stack_pytrees([tfim_mpo(n, h=float(h), device=device) for h in hs])
    mps0s = stack_pytrees([MPS.random(n, 2, bond, dtype=torch.float64, generator=gen,
                                      device=device) for _ in hs])
    t0 = time.perf_counter()
    _, energies, traces = dmrg_ensemble(mpos, mps0s, sweeps=cfg["sweeps"])
    energies = energies.cpu().numpy()
    secs = time.perf_counter() - t0
    exact = np.array([tfim_free_fermion(n, float(h)) for h in hs])
    rel = np.abs(energies - exact) / np.abs(exact)
    log(f"  dmrg_ensemble: {k} TFIM chains, h {hs[0]}..{hs[-1]}, {n} sites, bond "
        f"{bond}, {cfg['sweeps']} sweeps in one batched call: {secs:.2f} s ({smi}); "
        f"max relative error vs free fermions {rel.max():.2e} at h {hs[rel.argmax()]:.4f} "
        f"(tol {cfg['rtol']})")
    if not (traces.shape == (k, cfg["sweeps"]) and rel.max() <= cfg["rtol"]):
        raise AssertionError("dmrg_ensemble: a member disagrees with free fermions")


def quench_path(device, smi, cfg, ground):
    """Single-site TDVP of the TFIM ground state under a field quench, in
    complex128: the norm and the energy are conserved."""
    from contractn_tpu_torch.models import rayleigh, tdvp1_evolve, tfim_mpo

    mpo = tfim_mpo(ground.n_sites, h=cfg["h"], device=device)
    e0 = rayleigh(mpo, ground)
    t0 = time.perf_counter()
    out, energies = tdvp1_evolve(mpo, ground, cfg["dt"], cfg["steps"])
    secs = time.perf_counter() - t0
    norm = float(out.norm_squared(split_format=False).real)
    drift = max(abs(e - e0) for e in energies) / abs(e0)
    log(f"  tdvp1_evolve quench h 1 -> {cfg['h']}, {ground.n_sites} sites, bond "
        f"{ground.bond_dim}, {out.cores.dtype}: {cfg['steps']} steps of dt {cfg['dt']} "
        f"in {secs:.2f} s ({1e3 * secs / cfg['steps']:.0f} ms a step, {smi}); "
        f"<psi|psi> - 1 = {norm - 1:.2e} (tol {cfg['norm_tol']}), energy {e0:.10f}, "
        f"largest relative drift {drift:.2e} (tol {cfg['drift_tol']})")
    if not (out.cores.dtype == torch.complex128 and abs(norm - 1) <= cfg["norm_tol"]
            and drift <= cfg["drift_tol"]):
        raise AssertionError("TDVP quench: norm or energy not conserved")


def itebd_path(device, smi, cfg):
    """iTEBD of the infinite critical TFIM against -4/pi."""
    from contractn_tpu_torch.models import itebd_ground_state, tfim_bond_term

    t0 = time.perf_counter()
    state, energy = itebd_ground_state(tfim_bond_term(), cfg["bond"], device=device)
    secs = time.perf_counter() - t0
    err = abs(energy + 4 / math.pi)
    log(f"  itebd_ground_state(tfim, bond {cfg['bond']}), default schedule (1200 "
        f"steps, 2400 SVDs): {secs:.2f} s ({smi}); energy {energy:.8f} vs -4/pi "
        f"{-4 / math.pi:.8f} (error {err:.2e}, tol {cfg['tol']})")
    if not (state["cores"].device.type == device.type and err <= cfg["tol"]):
        raise AssertionError("iTEBD disagrees with -4/pi")


def opsum_path(device, smi, cfg):
    """An OpSum-built Heisenberg MPO against ``heisenberg_mpo`` on a random
    state."""
    from contractn_tpu_torch.models import MPS, OpSum, heisenberg_mpo, rayleigh

    n = cfg["n_sites"]
    h = OpSum()
    for i in range(n - 1):  # X X + Y Y = 2 (S+ S- + S- S+) in the Pauli basis
        h += (2.0, "S+", i, "S-", i + 1)
        h += (2.0, "S-", i, "S+", i + 1)
        h += (1.0, "Z", i, "Z", i + 1)
    t0 = time.perf_counter()
    built = h.to_mpo(n, device=device)
    secs = time.perf_counter() - t0
    psi = MPS.random(n, 2, cfg["bond"], dtype=torch.float64,
                     generator=_gen(device, cfg["seed"]), device=device)
    got, want = rayleigh(built, psi), rayleigh(heisenberg_mpo(n, device=device), psi)
    rel = abs(got - want) / abs(want)
    log(f"  OpSum Heisenberg, {n} sites: compiled to W {built.cores.shape[3]} in "
        f"{secs:.2f} s ({smi}); rayleigh {got:.12f} vs heisenberg_mpo {want:.12f} "
        f"(relative {rel:.1e}, tol {cfg['rtol']})")
    if not (built.cores.shape[3] == 5 and rel <= cfg["rtol"]):
        raise AssertionError("OpSum Heisenberg disagrees with heisenberg_mpo")


def svd_drivers(device, smi, cfg):
    """The two-site split's SVD at its bulk size (d 3, D 128: 384 x 384,
    float64) under each of cuSOLVER's drivers."""
    rows = cfg["rows"]
    a = torch.randn((rows, rows), dtype=torch.float64, device=device,
                    generator=_gen(device, 12))
    times = {}
    for driver in (None, "gesvdj", "gesvda"):
        times[driver or "default"] = cuda_time(
            lambda: torch.linalg.svd(a, full_matrices=False, driver=driver),
            reps=cfg["reps"])
    log(f"  torch.linalg.svd {rows} x {rows} float64 (CUDA events, median of "
        f"{cfg['reps']}): " + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
        + f" ({smi})")




# ---------------------------------------------------------------- phase 9


class U1SplitTimer:
    """Synchronizing host-clock timers around the charge-aligned split of
    ``models.u1`` (one batched SVD of the C class-masked blocks) and the
    start of each sweep of the masked DMRG."""

    def __init__(self, device, n_sites):
        import importlib

        self.mod = importlib.import_module("contractn_tpu_torch.models.u1")
        self.per_sweep = 2 * (n_sites - 1)
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        self.split_s, self.calls, self.marks, self.saved = 0.0, 0, [], None

    def __enter__(self):
        self.saved = self.mod._u1_splitter

        def timed_factory(*args):
            inner = self.saved(*args)

            def splitter(theta, i, to_left):
                self.sync()
                t0 = time.perf_counter()
                if self.calls % self.per_sweep == 0:
                    self.marks.append(t0)
                self.calls += 1
                out = inner(theta, i, to_left)
                self.sync()
                self.split_s += time.perf_counter() - t0
                return out
            return splitter

        self.mod._u1_splitter = timed_factory
        return self

    def __exit__(self, *exc):
        self.sync()
        self.marks.append(time.perf_counter())
        self.mod._u1_splitter = self.saved

    def sweep_seconds(self):
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def physics_chains(device, smi, sizes=PHYSICS):
    """Phase 9: the U(1) layer, quantics and TCI, open systems and
    correction vectors through the user entry points; returns ``{path:
    (counts, seconds)}``.  Each path runs with every launch count zeroed
    just before it and read just after; only serving the Hubbard ground
    state and evaluating the 20-bit quantics MPS may launch a hand kernel
    (#1, exactly once each)."""
    runs = {}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def drive(name, fn):
        reset_counters()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        runs[name] = (read_counters(), time.perf_counter() - t0)
        return out

    ground = drive("hubbard_sector", lambda: hubbard_path(device, smi, sizes["hubbard"]))
    drive("serve_hubbard", lambda: serve_ground(device, ground,
                                                sizes["hubbard"]["serve_batch"], "Hubbard"))
    drive("quantics_tci", lambda: quantics_tci_path(device, smi, sizes["tci"]))
    dense = drive("quantics_dense", lambda: quantics_dense_path(device, smi, sizes["dense"]))
    if device.type == "cuda":
        time_quantics_kernel(smi, *dense)
    drive("lindblad_wii", lambda: lindblad_path(device, smi, sizes["lindblad"]))
    drive("cv_spectral", lambda: cv_path(device, smi, sizes["cv"]))
    drive("mcwf", lambda: mcwf_path(device, smi, sizes["mcwf"]))
    served = ("serve_hubbard", "quantics_dense")
    for path, (counts, _) in runs.items():
        want = {"mps_evaluate": 1} if (path in served and device.type == "cuda") else {}
        got = {k: v for k, v in counts.items() if v and "." not in k}
        if got != want:
            raise AssertionError(f"path {path}: hand-kernel launches {counts}, want {want}")
    return runs


def hubbard_bond(device, cfg):
    """The largest bond, from ``cfg["bond"]`` down by halving, whose two
    sweeps of class SVDs fit half the budget: the split at the middle bond
    is timed at each candidate.  Returns ``(bond, C)``."""
    from contractn_tpu_torch.models import hubbard_phys_charges, u1

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    phys, a = hubbard_phys_charges(cfg["lx"], cfg["ly"])
    n = 2 * cfg["lx"] * cfg["ly"]
    bond = cfg["bond"]
    while True:
        charges = u1.u1_bond_charges(n, phys, cfg["n_up"] * a + cfg["n_dn"], bond)
        split = u1._split_masks(charges, phys, device)
        splitter = u1._u1_splitter(split, 2, bond)
        theta = torch.randn((2, 2, bond, bond), dtype=torch.float64, device=device,
                            generator=_gen(device, 5))
        mid = n // 2 - 1
        splitter(theta, mid, True)  # warm-up
        sync()
        t0 = time.perf_counter()
        splitter(theta, mid, True)
        sync()
        secs = time.perf_counter() - t0
        n_cls = split[0].shape[1]
        est = secs * 2 * (n - 1) * cfg["sweeps"]
        log(f"  U(1) split at bond {bond}: C = {n_cls} charge classes, one batched "
            f"torch.linalg.svd of {n_cls} x {2 * bond} x {2 * bond} float64 in "
            f"{1e3 * secs:.1f} ms; {cfg['sweeps']} sweeps' {2 * (n - 1)} splits each "
            f"~{est:.1f} s (half the budget: {0.5 * cfg['budget_s']:.0f} s)")
        if est <= 0.5 * cfg["budget_s"] or bond // 2 < cfg["min_bond"]:
            return bond, n_cls
        log(f"    over budget: bond {bond} -> {bond // 2}")
        bond //= 2


def hubbard_path(device, smi, cfg):
    """Charge-masked DMRG of the half-filled Hubbard strip: per-sweep times
    and the split's share, monotone energies, the exact mask identity, the
    sector's particle numbers, and the small anchor against sector ED."""
    import numpy as np

    from contractn_tpu_torch.models import (hubbard_dmrg_sector, hubbard_sector_ed,
                                            spin_densities)

    lx, ly, nu, nd = cfg["lx"], cfg["ly"], cfg["n_up"], cfg["n_dn"]
    n = 2 * lx * ly
    bond, n_cls = hubbard_bond(device, cfg)
    with U1SplitTimer(device, n) as timer:
        mps, energy, energies, masks = hubbard_dmrg_sector(
            lx, ly, nu, nd, bond, t=cfg["t"], u=cfg["u"], sweeps=cfg["sweeps"],
            lanczos_iters=cfg["lanczos_iters"], generator=_gen(device, cfg["seed"]),
            device=device)
    sweeps = timer.sweep_seconds()
    total = sum(sweeps)
    trace = energies.cpu().numpy()
    leak = int(torch.count_nonzero(mps.cores * (1 - masks)))
    up, dn = spin_densities(mps, lx, ly)
    log(f"  hubbard_dmrg_sector {lx} x {ly}, N_up {nu}, N_dn {nd} ({n} spin-orbitals), "
        f"t {cfg['t']}, U {cfg['u']}, bond {bond}, C = {n_cls}, float64, "
        f"{cfg['sweeps']} sweeps: sweep times {', '.join(f'{s:.2f}' for s in sweeps)} s "
        f"({smi}); the split's share {100 * timer.split_s / total:.1f}% "
        f"({timer.split_s:.2f} s, {timer.calls} batched SVD calls)")
    log(f"    energy trace {', '.join(f'{e:.10f}' for e in trace)}; entries outside "
        f"the masks {leak}; sum <n_up> {up.sum():.12f}, sum <n_dn> {dn.sum():.12f}")
    monotone = all(b <= a + 1e-10 * abs(a) for a, b in zip(trace, trace[1:]))
    if not (monotone and leak == 0 and abs(up.sum() - nu) <= 1e-10
            and abs(dn.sum() - nd) <= 1e-10 and np.isfinite(trace).all()):
        raise AssertionError("Hubbard sector DMRG: energies, masks or densities off")
    an = cfg["anchor"]
    t0 = time.perf_counter()
    _, e_anchor, _, _ = hubbard_dmrg_sector(
        an["lx"], an["ly"], an["n_up"], an["n_dn"], an["bond"], t=cfg["t"], u=cfg["u"],
        sweeps=an["sweeps"], lanczos_iters=cfg["lanczos_iters"],
        generator=_gen(device, cfg["seed"] + 1), device=device)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_ed = hubbard_sector_ed(an["lx"], an["ly"], an["n_up"], an["n_dn"], cfg["t"], cfg["u"])
    secs_ed = time.perf_counter() - t0
    gap = abs(float(e_anchor) - e_ed)
    log(f"    anchor {an['lx']} x {an['ly']} (N_up {an['n_up']}, N_dn {an['n_dn']}), bond "
        f"{an['bond']}, {an['sweeps']} sweeps: {float(e_anchor):.12f} in {secs:.2f} s vs "
        f"sector ED {e_ed:.12f} ({secs_ed:.1f} s on the host): |dE| {gap:.2e} "
        f"(tol {an['tol']})")
    if gap > an["tol"]:
        raise AssertionError("Hubbard anchor disagrees with sector ED")
    return mps


def _damped_cosine(freq):
    import numpy as np

    w = 2 * np.pi * freq
    return lambda x: np.exp(-x) * np.cos(w * x)


def quantics_tci_path(device, smi, cfg):
    """TCI on a 2^40-point grid: its integral against the closed form of the
    Riemann sum; the QFT of the 16-bit samples against numpy.fft."""
    import numpy as np

    from contractn_tpu_torch.models import (function_mps, function_tci, qft_mps,
                                            quantics_integral, quantics_to_dense)

    f = _damped_cosine(cfg["freq"])
    n = cfg["n_bits"]
    t0 = time.perf_counter()
    mps, info = function_tci(f, n, max_bond=cfg["max_bond"], tol=cfg["tol"],
                             device=device)
    got = quantics_integral(mps).real
    secs = time.perf_counter() - t0
    # sum_j dx e^{z x_j}, z = -1 + 2 pi i freq: a geometric series
    z = complex(-1.0, 2 * np.pi * cfg["freq"])
    dx = 2.0 ** -n
    exact = (dx * (1 - np.exp(z)) / -np.expm1(z * dx)).real
    rel = abs(got - exact) / abs(exact)
    log(f"  function_tci exp(-x) cos(2 pi {cfg['freq']:g} x) on 2^{n} points: ranks "
        f"max {max(info.ranks)}, {info.n_evals} evaluations, {info.sweeps} sweeps, "
        f"certified error {info.error:.1e}, in {secs:.2f} s ({smi}); integral "
        f"{got:.15e} vs closed form {exact:.15e} (relative {rel:.1e}, tol {cfg['rtol']})")
    nq = cfg["qft_bits"]
    t0 = time.perf_counter()
    q = qft_mps(function_mps(f, nq, device=device))
    vals = quantics_to_dense(q).cpu().numpy()
    secs = time.perf_counter() - t0
    samples = f(np.arange(2 ** nq) / 2 ** nq)
    ref = np.sqrt(2 ** nq) * np.fft.ifft(samples)
    err = np.abs(vals - ref).max() / np.abs(ref).max()
    log(f"  qft_mps of the {nq}-bit samples (bond {q.bond_dim}, complex128): {secs:.2f} s "
        f"({smi}); max |QFT - sqrt(N) ifft| / max |.| = {err:.1e} (tol {cfg['qft_tol']})")
    if not (rel <= cfg["rtol"] and err <= cfg["qft_tol"]):
        raise AssertionError("TCI integral or QFT off")


def quantics_dense_path(device, smi, cfg):
    """The 20-bit quantics MPS cast to float32 on every grid point through
    ``quantics_to_dense`` (#1 on the card), against the plain version and
    the float64 samples.  Returns the kernel's inputs for timing."""
    import numpy as np

    from contractn_tpu_torch.models import MPS, function_mps, quantics_to_dense
    from contractn_tpu_torch.models.quantics import _one_hot_bits
    from contractn_tpu_torch.ops.cuda_mps import mps_evaluate_plain

    f = _damped_cosine(cfg["freq"])
    n = cfg["n_bits"]
    m = function_mps(f, n, device=device)
    m32 = MPS(m.cores.float(), m.left.float(), m.right.float())
    with torch.no_grad():
        dense = quantics_to_dense(m32)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    launches = read_counters()["mps_evaluate"]
    weights = _one_hot_bits(n, torch.float32, device)
    ref = mps_evaluate_plain(m32.cores, m32.left, m32.right, weights)
    cond = mps_condition(m32.cores, m32.left, m32.right, weights)
    log(f"  quantics_to_dense of function_mps(f, {n}) as float32 ({2 ** n} rows x {n} "
        f"sites x d 2, bond {m.bond_dim}): #1 launches {launches}")
    compare_split((dense, torch.zeros_like(dense)), ref, TOL_F32,
                  "quantics samples through #1 vs plain", cond)
    samples = f(np.arange(2 ** n) / 2 ** n)
    err = np.abs(dense.double().cpu().numpy() - samples).max() / np.abs(samples).max()
    log(f"    max |float32 samples - float64 f(x_j)| / max |f| = {err:.1e} "
        f"(tol {cfg['tol']})")
    if err > cfg["tol"] or (device.type == "cuda" and launches != 1):
        raise AssertionError("quantics_to_dense through #1 off")
    return m32.cores, m32.left, m32.right, weights


def time_quantics_kernel(smi, cores, left, right, weights):
    """#1 at the quantics shape with CUDA events, beside its bound."""
    from contractn_tpu_torch.ops import cuda_mps

    batch, n, d = weights.shape
    bond = cores.shape[-1]
    ms = cuda_time(lambda: cuda_mps.cuda_mps_evaluate(cores, left, right, weights))
    plain = cuda_time(lambda: cuda_mps.mps_evaluate_plain(cores, left, right, weights),
                      reps=3)
    bms, by = bound_ms(batch * n * 2 * d * bond * bond, batch * n * (2 * d * bond + 3 * bond),
                       4 * (cores.numel() + weights.numel() + 2 * bond) + 8 * batch)
    log(f"    #1 at the quantics shape ({batch} x {n} x d {d}, bond {bond}): kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bms:.3f} ms ({by}) ({smi})")


def lindblad_path(device, smi, cfg):
    """W^II Lindblad evolution of the dephased XXZ chain: the trace stays 1
    and every <Z_i> agrees between the card and the CPU."""
    import numpy as np

    from contractn_tpu_torch.models import (density_expectation, density_trace,
                                            lindblad_evolve_wii, mpo_from_bond_term,
                                            vectorized_product_state)

    x = np.array([[0.0, 1.0], [1.0, 0.0]])
    y = np.array([[0.0, -1j], [1j, 0.0]])
    z = np.diag([1.0, -1.0])
    h2 = (np.kron(x, x) + np.kron(y, y)).real + cfg["jz"] * np.kron(z, z)
    n = cfg["n_sites"]
    neel = [np.array([0.0, 1.0]) if i % 2 == 0 else np.array([1.0, 0.0]) for i in range(n)]

    def run(dev):
        h = mpo_from_bond_term(h2, n, dtype=torch.complex128, device=dev)
        t0 = time.perf_counter()
        rho = lindblad_evolve_wii(vectorized_product_state(neel, device=dev), h,
                                  cfg["dt"] * cfg["steps"], cfg["steps"],
                                  jumps=[math.sqrt(cfg["gamma"]) * z],
                                  max_bond=cfg["max_bond"])
        zs = np.array([density_expectation(rho, z, i).real for i in range(n)])
        tr = density_trace(rho)
        val, lg = rho.norm_squared()
        # the trace's condition: ||vec(I)|| ||rho|| / |Tr rho|
        cond = 2.0 ** (n / 2) * math.sqrt(float(val.real) * math.exp(float(lg))) / abs(tr)
        return rho, tr, cond, zs, time.perf_counter() - t0

    rho, tr, cond, zs, secs = run(device)
    _, tr_cpu, cond_cpu, zs_cpu, secs_cpu = run(torch.device("cpu"))
    err = np.abs(zs - zs_cpu).max()
    log(f"  lindblad_evolve_wii dephased XXZ (jz {cfg['jz']}, gamma {cfg['gamma']}), {n} "
        f"sites, {cfg['steps']} steps of dt {cfg['dt']}, max_bond {cfg['max_bond']} "
        f"(bond {rho.bond_dim}): {secs:.2f} s on the card, {secs_cpu:.2f} s on the CPU "
        f"({smi}); |Tr rho - 1| {abs(tr - 1):.1e} on the card, {abs(tr_cpu - 1):.1e} on "
        f"the CPU (tol {cfg['trace_tol']} x cond {cond:.4g}); max |<Z_i> card - CPU| "
        f"{err:.1e} (tol {cfg['tol']}), <Z_0> {zs[0]:.10f}")
    if not (abs(tr - 1) <= cfg["trace_tol"] * cond and err <= cfg["tol"]
            and abs(tr_cpu - 1) <= cfg["trace_tol"] * cond_cpu):
        raise AssertionError("Lindblad W^II: trace or card against CPU off")


def cv_path(device, smi, cfg):
    """The batched correction-vector grid (one leading frequency axis, one
    batched SVD a split) for S^z at the middle of a Heisenberg ground state,
    card against CPU."""
    import numpy as np

    from contractn_tpu_torch.models import (MPS, cv_spectral_function_batched, dmrg,
                                            heisenberg_mpo)
    from contractn_tpu_torch.models import dynamical

    n, bond = cfg["n_sites"], cfg["bond"]
    h = heisenberg_mpo(n, device=device)
    mps0 = MPS.random(n, 2, bond, dtype=torch.float64, generator=_gen(device, cfg["seed"]),
                      device=device)
    t0 = time.perf_counter()
    ground, e0, _ = dmrg(h, mps0, max_bond=bond, sweeps=cfg["dmrg_sweeps"])
    secs_dmrg = time.perf_counter() - t0
    omegas = np.linspace(*cfg["omegas"], cfg["n_omegas"])
    sz = np.diag([0.5, -0.5])
    kw = dict(sweeps=cfg["sweeps"], cg_iters=cfg["cg_iters"])
    batches = []
    real_split = dynamical._split_theta

    def spy(theta, max_bond, to_left):
        batches.append(theta.shape[0])
        return real_split(theta, max_bond, to_left)

    dynamical._split_theta = spy
    try:
        t0 = time.perf_counter()
        card = cv_spectral_function_batched(h, ground, e0, sz, n // 2, omegas, cfg["eta"], **kw)
        secs = time.perf_counter() - t0
    finally:
        dynamical._split_theta = real_split
    cpu = torch.device("cpu")
    sub = list(cfg["cpu_at"])
    h_cpu = heisenberg_mpo(n, device=cpu)
    ground_cpu = MPS(ground.cores.to(cpu), ground.left.to(cpu), ground.right.to(cpu))
    t0 = time.perf_counter()
    host = cv_spectral_function_batched(h_cpu, ground_cpu, e0, sz, n // 2, omegas[sub],
                                        cfg["eta"], **kw)
    secs_cpu = time.perf_counter() - t0
    # how far float64 determines this computation: a 1e-15 relative nudge
    noise = torch.randn(ground_cpu.cores.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(cfg["seed"]))
    nudged = MPS(ground_cpu.cores * (1 + 1e-15 * noise), ground_cpu.left, ground_cpu.right)
    host_nudged = cv_spectral_function_batched(h_cpu, nudged, e0, sz, n // 2, omegas[sub],
                                               cfg["eta"], **kw)
    scale = np.abs(host).max()
    spread = np.abs(host_nudged - host).max() / scale
    err = np.abs(card[sub] - host).max() / scale
    tol = max(cfg["tol"], 10 * spread)
    one_batch = batches == [len(omegas)] * (2 * (n - 1) * cfg["sweeps"])
    log(f"  cv_spectral_function_batched: {len(omegas)} frequencies, S^z at site {n // 2} "
        f"of the {n}-site Heisenberg ground state (dmrg bond {bond}, {secs_dmrg:.2f} s, "
        f"E0 {e0:.10f}), eta {cfg['eta']}, {cfg['sweeps']} ALS sweeps, CG {cfg['cg_iters']}: "
        f"{secs:.2f} s on the card, {secs_cpu:.2f} s on the CPU for {len(host)} of the "
        f"frequencies ({smi}); {len(batches)} splits, each one batched SVD over all "
        f"frequencies: {one_batch}; max |S card - S CPU| / max |S| = {err:.1e}; the CPU's "
        f"own spread under a 1e-15 nudge {spread:.1e} (tol max({cfg['tol']}, 10 x spread) "
        f"= {tol:.1e})")
    if not (one_batch and err <= tol):
        raise AssertionError("batched correction vectors: card against CPU off")


def mcwf_path(device, smi, cfg):
    """An MCWF trajectory ensemble of the damped TFIM, card against CPU on
    the same host draws."""
    import numpy as np

    from contractn_tpu_torch.models import MPS, mcwf_ensemble, tfim_bond_term

    n = cfg["n_sites"]
    h2 = tfim_bond_term(1.0, cfg["h"])
    lower = np.array([[0.0, 1.0], [0.0, 0.0]])
    jumps = [(math.sqrt(cfg["gamma"]) * lower, j) for j in range(n)]
    z = np.diag([1.0, -1.0])

    def run(dev, nudge=0.0):
        cores = torch.zeros((n, 2, 1, 1), dtype=torch.float64)
        cores[:, 1] = 1.0  # all down: the damping has work to do
        cores += nudge * torch.randn(cores.shape, dtype=torch.float64,
                                     generator=torch.Generator().manual_seed(cfg["seed"]))
        one = torch.ones((1,), dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        mean, jumps_total = mcwf_ensemble(
            MPS(cores.to(dev), one, one.clone()), h2, jumps, cfg["t"], cfg["steps"], z,
            cfg["n_traj"], max_bond=cfg["max_bond"],
            generator=torch.Generator().manual_seed(cfg["seed"]),
            measure_every=cfg["steps"])
        return mean, jumps_total, time.perf_counter() - t0

    mean, n_jumps, secs = run(device)
    mean_cpu, n_jumps_cpu, secs_cpu = run(torch.device("cpu"))
    mean_nudged, _, _ = run(torch.device("cpu"), nudge=1e-15)
    err = np.abs(mean - mean_cpu).max()
    spread = np.abs(mean_nudged - mean_cpu).max()
    tol = max(cfg["tol"], 10 * spread)
    log(f"  mcwf_ensemble damped TFIM (h {cfg['h']}, gamma {cfg['gamma']}), {n} sites, "
        f"{cfg['n_traj']} trajectories x {cfg['steps']} steps, max_bond {cfg['max_bond']}: "
        f"{secs:.2f} s on the card, {secs_cpu:.2f} s on the CPU ({smi}); jumps "
        f"{n_jumps} / {n_jumps_cpu}; mean <Z> at t {cfg['t']} {mean[-1].mean():.6f}; max "
        f"|card - CPU| {err:.1e}; the CPU's own spread under a 1e-15 nudge {spread:.1e} "
        f"(tol max({cfg['tol']}, 10 x spread) = {tol:.1e})")
    if not (n_jumps == n_jumps_cpu and err <= tol):
        raise AssertionError("MCWF ensemble: card against CPU off")


def infinite_chains(device, smi, sizes=INFINITE):
    """Phase 10: the infinite-chain layer (VUMPS, quasiparticle excitations,
    charge-masked VUMPS, uniform W^II evolution) and quantum-chemistry DMRG
    through the user entry points; returns ``{path: (counts, seconds)}``.
    Each path runs with every launch count zeroed just before it and read
    just after; only serving the hydrogen-chain ground state may launch a
    hand kernel (#1, exactly once)."""
    runs = {}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def drive(name, fn):
        reset_counters()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        runs[name] = (read_counters(), time.perf_counter() - t0)
        return out

    mpo, grounds = drive("haldane_vumps", lambda: haldane_vumps(device, smi,
                                                                sizes["haldane"]))
    drive("haldane_gap", lambda: haldane_gap(device, smi, sizes["haldane"], mpo, grounds))
    drive("haldane_dense", lambda: haldane_dense(device, smi, sizes["haldane"], mpo))
    drive("hubbard_vumps", lambda: hubbard_infinite(device, smi, sizes["hubbard"]))
    ground = drive("h_chain_dmrg", lambda: h_chain_path(device, smi, sizes["h_chain"]))
    drive("serve_h_chain", lambda: serve_ground(device, ground, sizes["h_chain"]["serve_batch"],
                                                "hydrogen-chain"))
    drive("water_anchor", lambda: water_anchor(device, smi, sizes["water"]))
    drive("umps_evolve", lambda: umps_evolve_path(device, smi, sizes["evolve"]))
    for path, (counts, _) in runs.items():
        want = ({"mps_evaluate": 1} if (path == "serve_h_chain" and device.type == "cuda")
                else {})
        got = {k: v for k, v in counts.items() if v and "." not in k}
        if got != want:
            raise AssertionError(f"path {path}: hand-kernel launches {counts}, want {want}")
    return runs


def haldane_mpo(device):
    """The spin-1 Heisenberg bulk core built through ``InfiniteOpSum``, as a
    one-core MPO (the form ``vumps`` reads)."""
    from contractn_tpu_torch.models import MPO, InfiniteOpSum, spin_ops

    h = InfiniteOpSum()
    h.add(1.0, "Sz", 0, "Sz", 1)
    h.add(0.5, "S+", 0, "S-", 1)
    h.add(0.5, "S-", 0, "S+", 1)
    w = h.to_umpo(d=3, ops=spin_ops(1), dtype=torch.float64, device=device)
    ends = torch.eye(w.shape[2], dtype=torch.float64, device=device)
    return MPO(w[None], ends[0], ends[-1])


def _grown_start(prev, bond, gen, noise):
    """A bond-``bond`` start core: the previous stage's left-isometric core,
    zero-padded, plus standard-normal ``noise`` from ``gen``."""
    al = prev["al"]
    a0 = torch.zeros((al.shape[0], bond, bond), dtype=al.dtype, device=al.device)
    a0[:, :al.shape[1], :al.shape[2]] = al
    return a0 + noise * torch.randn(a0.shape, dtype=al.dtype, device=al.device,
                                    generator=gen)


def haldane_vumps(device, smi, cfg):
    """VUMPS of the spin-1 Heisenberg chain, the bond grown through
    ``cfg["schedule"]`` (each stage started from the last one's AL), the
    final energy per site against White & Huse's value."""
    from contractn_tpu_torch.models import vumps

    mpo = haldane_mpo(device)
    gen = _gen(device, cfg["seed"])
    grounds, prev = {}, None
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for bond in cfg["schedule"]:
        a0 = None if prev is None else _grown_start(prev, bond, gen, cfg["noise"])
        t0 = time.perf_counter()
        prev = vumps(mpo, bond, iters=cfg["iters"], lanczos_iters=cfg["lanczos_iters"],
                     generator=gen, a0=a0, device=device)
        sync()
        secs = time.perf_counter() - t0
        grounds[bond] = (prev, secs)
        log(f"  vumps spin-1 Heisenberg (InfiniteOpSum, W {mpo.cores.shape[3]}), bond "
            f"{bond}, float64: {len(prev['energies'])} iterations in {secs:.2f} s "
            f"({smi}); energy per site {prev['energy']:.13f} (White & Huse "
            f"{cfg['e_ref']}: {prev['energy'] - cfg['e_ref']:+.2e}); gradient norm "
            f"{prev['gradient_norm']:.2e}")
    err = abs(prev["energy"] - cfg["e_ref"])
    if not err <= cfg["e_tol"]:
        raise AssertionError(f"Haldane chain: energy {prev['energy']} is {err:.2e} from "
                             f"{cfg['e_ref']} (tol {cfg['e_tol']})")
    return mpo, grounds


def _as_cell(ground):
    """A one-site VUMPS ground as the cell form the cell excitations read."""
    return {"als": (ground["al"],), "ars": (ground["ar"],), "cs": (ground["c"],),
            "acs": (ground["ac"],), "energy": ground["energy"]}


def haldane_gap(device, smi, cfg, mpo, grounds):
    """The Haldane gap at k = pi by ``excitation_minimum_cell`` on the
    largest grown ground whose solve fits the budget: timed at the smallest
    allowed bond, then run at the largest stage whose estimate (twice that
    time) fits what is left."""
    import numpy as np

    from contractn_tpu_torch.models import excitation_minimum_cell

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    bonds = [b for b in sorted(grounds) if b >= cfg["gap_min_bond"]]

    def solve(bond):
        t0 = time.perf_counter()
        gap, _ = excitation_minimum_cell(_as_cell(grounds[bond][0]), [mpo.cores[0]], np.pi,
                                         iters=cfg["gap_iters"],
                                         generator=_gen(device, cfg["seed"] + 1))
        sync()
        secs = time.perf_counter() - t0
        log(f"  excitation_minimum_cell at k = pi on the bond-{bond} ground: gap "
            f"{gap:.10f} in {secs:.2f} s ({smi}); Haegeman et al. {cfg['gap_ref']}: "
            f"distance {abs(gap - cfg['gap_ref']):.2e}")
        return gap, secs

    bond = bonds[0]
    gap, secs = solve(bond)
    left = cfg["gap_budget_s"] - secs
    fits = [b for b in bonds[1:] if 2.0 * secs <= left]
    if fits:
        bond = fits[-1]
        gap, _ = solve(bond)
    dist = abs(gap - cfg["gap_ref"])
    log(f"    Haldane gap at bond {bond}: {gap:.10f}, distance {dist:.2e} "
        f"(tol {cfg['gap_tol']})")
    if not dist <= cfg["gap_tol"]:
        raise AssertionError(f"Haldane gap {gap} is {dist:.2e} from {cfg['gap_ref']}")


def _ground_to(ground, device):
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in ground.items()}


def haldane_dense(device, smi, cfg, mpo):
    """The dense ``excitation_spectrum`` (every band at k = pi) on a bond-12
    Haldane ground, card against CPU on the same ground tensors (the
    tangent basis and the GMRES environment solves run on each)."""
    import numpy as np

    from contractn_tpu_torch.models import MPO, vumps
    from contractn_tpu_torch.models.excitations import excitation_spectrum

    bond = cfg["dense_bond"]
    ground = vumps(mpo, bond, iters=cfg["iters"], lanczos_iters=cfg["lanczos_iters"],
                   generator=_gen(device, cfg["seed"] + 2), device=device)
    cpu = torch.device("cpu")
    mpo_cpu = MPO(mpo.cores.cpu(), mpo.left.cpu(), mpo.right.cpu())
    out, secs = {}, {}
    for dev, g, m in ((device, ground, mpo), (cpu, _ground_to(ground, cpu), mpo_cpu)):
        t0 = time.perf_counter()
        out[dev.type] = excitation_spectrum(g, m, np.pi).cpu().numpy()
        secs[dev.type] = time.perf_counter() - t0
    diff = float(np.abs(out[device.type] - out["cpu"]).max())
    log(f"  excitation_spectrum at k = pi on a bond-{bond} Haldane ground: "
        f"{out['cpu'].size} bands (one batched GMRES a channel), card "
        f"{secs[device.type]:.2f} s, CPU {secs['cpu']:.2f} s ({smi}); lowest "
        f"{out['cpu'][0]:.10f}; max |card - CPU| over all bands {diff:.2e} "
        f"(tol {cfg['dense_tol']})")
    if not diff <= cfg["dense_tol"]:
        raise AssertionError("dense excitation spectrum: card and CPU disagree")


def hubbard_schedule(device, cfg):
    """The bond schedule of ``hubbard_vumps``: ``cfg["bond_dims"]``, the
    largest halved while its timed estimate (two VUMPS iterations of the
    folded cell at that bond, times ``cfg["iters"]``) exceeds the budget."""
    from contractn_tpu_torch.models import (MPO, block_mpo, hubbard_chain_cell,
                                            hubbard_relative_charges, vumps_u1)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    cell4 = hubbard_chain_cell(t=cfg["t"], u=cfg["u"], device=device)
    cell16 = block_mpo(MPO(cell4.cores[0].expand((2,) + tuple(cell4.cores.shape[1:])),
                           cell4.left, cell4.right), 2)
    dims = list(cfg["bond_dims"])
    while True:
        bond = dims[-1]
        vumps_u1(cell16, bond, hubbard_relative_charges(), iters=1,
                 lanczos_iters=cfg["lanczos_iters"], generator=_gen(device, 3))
        sync()
        t0 = time.perf_counter()
        vumps_u1(cell16, bond, hubbard_relative_charges(), iters=2,
                 lanczos_iters=cfg["lanczos_iters"], generator=_gen(device, 3))
        sync()
        est = (time.perf_counter() - t0) / 2 * cfg["iters"]
        log(f"  hubbard_vumps at bond {bond}: ~{est:.1f} s for {cfg['iters']} "
            f"iterations (budget {cfg['budget_s']:.0f} s)")
        if est <= cfg["budget_s"] or len(dims) == 1 or bond // 2 < cfg["min_bond"]:
            return dims
        log(f"    over budget: bond {bond} -> {bond // 2}")
        dims = [b for b in dims if b < bond] or [bond // 2]


def hubbard_infinite(device, smi, cfg):
    """``hubbard_vumps`` at half filling (d = 16 folded cell, charge-masked),
    the bond grown to the largest the budget allows, against Lieb-Wu; no
    entry outside the charge masks."""
    from contractn_tpu_torch.models import hubbard_vumps, lieb_wu_energy

    dims = hubbard_schedule(device, cfg)
    t0 = time.perf_counter()
    res = hubbard_vumps(cfg["u"], t=cfg["t"], bond_dims=tuple(dims), iters=cfg["iters"],
                        lanczos_iters=cfg["lanczos_iters"],
                        generator=_gen(device, cfg["seed"]), device=device)
    secs = time.perf_counter() - t0
    exact = lieb_wu_energy(cfg["u"], cfg["t"])
    mask = res["sector"]["site_mask"]
    leak = sum(int(torch.count_nonzero(res[k] * (1 - mask))) for k in ("al", "ar", "ac"))
    leak += int(torch.count_nonzero(res["c"] * (1 - res["sector"]["bond_mask"])))
    err = abs(res["energy_per_site"] - exact)
    log(f"  hubbard_vumps U {cfg['u']}, t {cfg['t']}, half filling, bonds "
        f"{' -> '.join(map(str, dims))} (reached {dims[-1]}), float64: {secs:.2f} s "
        f"({smi}); energy per site {res['energy_per_site']:.10f} vs Lieb-Wu "
        f"{exact:.10f}: {err:.2e} (tol {cfg['tol']}); gradient norm "
        f"{res['gradient_norm']:.2e}; entries outside the masks {leak}")
    if not (err <= cfg["tol"] and leak == 0):
        raise AssertionError("infinite Hubbard chain: energy or masks off")


def h_chain_integrals(cfg):
    """MO-basis integrals, the RHF total energy and the nuclear repulsion of
    the linear hydrogen chain (host numpy)."""
    from contractn_tpu_torch.models import chemistry as chem

    syms, xyz = chem.h_chain_geometry(cfg["n_atoms"], cfg["r"])
    basis, charges = chem.sto3g_basis(syms, xyz)
    s, hcore, eri, e_nuc = chem.molecular_integrals(basis, charges, xyz)
    e_hf, c, _ = chem.restricted_hartree_fock(s, hcore, eri, cfg["n_atoms"])
    h1, g2 = chem.mo_transform(hcore, eri, c)
    return h1, g2, e_hf + e_nuc, e_nuc


def h_chain_path(device, smi, cfg):
    """RHF, then the charge-masked ``chemistry_dmrg_u1`` of the hydrogen
    chain (energies non-increasing over the sweeps, below RHF, N exact,
    never below the exact energy, and at the JAX package's energy for this
    route), and the penalty route ``chemistry_dmrg`` on the same operator
    at the same bond, held against its own run at the bond that holds every
    Schmidt rank of the chain (exact)."""
    import importlib

    from contractn_tpu_torch.models import chemistry as chem

    u1 = importlib.import_module("contractn_tpu_torch.models.u1")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    n = cfg["n_atoms"]
    h1, g2, e_rhf, e_nuc = h_chain_integrals(cfg)
    t0 = time.perf_counter()
    mpo = chem.chemistry_mpo(h1, g2, symmetric=True, device=device)
    sync()
    t_mpo = time.perf_counter() - t0
    log(f"  H{n} STO-3G, {cfg['r']} bohr spacing: {2 * n} spin-orbitals, {n} electrons, "
        f"{len(chem.chemistry_terms(h1, g2))} terms; RHF {e_rhf:.10f}; charge-blocked "
        f"MPO (W {mpo.cores.shape[3]}) compiled in {t_mpo:.1f} s (host AutoMPO and "
        f"compression, {smi})")
    traces, real = [], u1.dmrg_u1

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        traces.append(out[2].cpu())
        return out

    u1.dmrg_u1 = recording
    try:
        t0 = time.perf_counter()
        e_u1, mps, _, masks = chem.chemistry_dmrg_u1(
            h1, g2, n, bond_dim=cfg["bond"], sweeps=cfg["sweeps"], mpo=mpo,
            generator=_gen(device, cfg["seed"]), device=device)
        sync()
        t_u1 = time.perf_counter() - t0
    finally:
        u1.dmrg_u1 = real
    trace = [float(e) for e in traces[0]]
    pen = {}
    for bond in (cfg["bond"], cfg["full_bond"]):
        t0 = time.perf_counter()
        pen[bond], _, _ = chem.chemistry_dmrg(h1, g2, n, max_bond=bond,
                                              sweeps=cfg["sweeps"], mpo=mpo, device=device)
        sync()
        pen[bond] = (pen[bond], time.perf_counter() - t0)
    e_pen, t_pen = pen[cfg["bond"]]
    e_full, t_full = pen[cfg["full_bond"]]
    occ = mps.site_expectations(torch.diag(torch.tensor(
        [0.0, 1.0], dtype=mps.cores.dtype, device=device))).sum()
    leak = int(torch.count_nonzero(mps.cores * (1 - masks)))
    log(f"    chemistry_dmrg_u1 bond {cfg['bond']}, {cfg['sweeps']} sweeps: {t_u1:.2f} s "
        f"({smi}); energy trace {', '.join(f'{e + e_nuc:.10f}' for e in trace)} "
        f"(total); final {e_u1 + e_nuc:.10f}, {e_u1 + e_nuc - e_rhf:+.6f} from RHF; "
        f"<N> {float(occ):.12f}, entries outside the masks {leak}")
    log(f"    chemistry_dmrg (penalty route, same operator): bond {cfg['bond']} "
        f"{e_pen + e_nuc:.10f} in {t_pen:.2f} s, bond {cfg['full_bond']} (every "
        f"Schmidt rank of {2 * n} spin-orbitals) {e_full + e_nuc:.10f} in {t_full:.2f} s: "
        f"|difference| {abs(e_pen - e_full):.2e} (tol {cfg['pen_tol']}); the masked "
        f"route at bond {cfg['bond']} lies {e_u1 - e_full:+.2e} above (its slots are "
        f"split among the charge classes by u1_bond_charges) and "
        f"{e_u1 - cfg['u1_ref']:+.2e} from the JAX package's {cfg['u1_ref']!r} "
        f"(electronic; tol {cfg['u1_tol']})")
    monotone = all(b <= a + 1e-10 * abs(a) for a, b in zip(trace, trace[1:]))
    if not (monotone and e_u1 + e_nuc < e_rhf and leak == 0
            and abs(float(occ) - n) <= 1e-10 and e_u1 >= e_full - 1e-8
            and abs(e_u1 - cfg["u1_ref"]) <= cfg["u1_tol"]
            and abs(e_pen - e_full) <= cfg["pen_tol"]):
        raise AssertionError("hydrogen chain DMRG: energies, sector or routes off")
    return mps


def serve_ground(device, ground, batch, what):
    """A ground state as float32 on configurations drawn by
    ``sample_canonical``, through ``MPS.evaluate`` under ``torch.no_grad()``
    (#1 on the card, exactly once), held against the plain version."""
    from contractn_tpu_torch.models import MPS, right_canonicalize, sample_canonical
    from contractn_tpu_torch.ops.cuda_mps import mps_evaluate_plain

    rc, _ = right_canonicalize(ground)
    samples, _ = sample_canonical(rc, batch, generator=_gen(device, 17))
    x = torch.nn.functional.one_hot(samples, ground.phys_dim).to(torch.float32)
    served = MPS(ground.cores.float(), ground.left.float(), ground.right.float())
    reset_counters()
    with torch.no_grad():
        got = served.evaluate(x)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_counters()["mps_evaluate"]
    ref = mps_evaluate_plain(served.cores, served.left, served.right, x)
    cond = mps_condition(served.cores, served.left, served.right, x)
    log(f"  served the {what} ground state ({ground.n_sites} sites, d "
        f"{ground.phys_dim}, bond {ground.bond_dim}, as float32) on {x.shape[0]} "
        f"configurations from sample_canonical: #1 launches {launches}")
    compare_split(got, ref, TOL_F32, f"{what} ground state through #1 vs plain", cond)
    if device.type == "cuda" and launches != 1:
        raise AssertionError(f"serving the {what} state launched #1 {launches} times")


def water_anchor(device, smi, cfg):
    """Frozen-core STO-3G water: RHF against the published value, DMRG
    against the independent determinant FCI."""
    import numpy as np

    from contractn_tpu_torch.models import chemistry as chem
    from contractn_tpu_torch.models import gaussians as gau

    half = np.deg2rad(cfg["angle"]) / 2.0
    r = cfg["r_oh"]
    xyz = np.array([[0.0, 0.0, 0.0], [r * np.sin(half), 0.0, r * np.cos(half)],
                    [-r * np.sin(half), 0.0, r * np.cos(half)]])
    basis, ch = gau.sto3g_shell_basis(["O", "H", "H"], xyz)
    s, hcore, eri, e_nuc = gau.molecular_integrals_general(basis, ch, xyz)
    e_hf, c, _ = chem.restricted_hartree_fock(s, hcore, eri, 10)
    h1, g2 = chem.mo_transform(hcore, eri, c)
    h1a, ga, _ = gau.freeze_core(h1, g2, 1)
    t0 = time.perf_counter()
    e_fci = chem.fci_ground(h1a, ga, n_elec=8)
    t_fci = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_dmrg, _, _ = chem.chemistry_dmrg(h1a, ga, 8, max_bond=cfg["bond"],
                                       sweeps=cfg["sweeps"], device=device)
    t_dmrg = time.perf_counter() - t0
    d_rhf = abs(e_hf + e_nuc - cfg["rhf_ref"])
    d_fci = abs(e_dmrg - e_fci)
    log(f"  frozen-core H2O STO-3G: RHF {e_hf + e_nuc:.6f} vs published "
        f"{cfg['rhf_ref']} ({d_rhf:.1e}, tol {cfg['rhf_tol']}); chemistry_dmrg bond "
        f"{cfg['bond']} {t_dmrg:.2f} s ({smi}) vs FCI ({t_fci:.2f} s on the host): "
        f"|dE| {d_fci:.2e} (tol {cfg['fci_tol']})")
    if not (d_rhf <= cfg["rhf_tol"] and d_fci <= cfg["fci_tol"]):
        raise AssertionError("water anchor: RHF or DMRG off")


def umps_evolve_path(device, smi, cfg):
    """Imaginary-time ``umps_mpo_evolve`` of the infinite TFIM from a
    product state, card against CPU through gauge-invariant local values."""
    import numpy as np

    from contractn_tpu_torch.models import correlate, expect_local, tfim_mpo
    from contractn_tpu_torch.models.mpo_evolution import umps_mpo_evolve

    cpu = torch.device("cpu")
    h_core = tfim_mpo(2, h=cfg["h"], device=cpu).cores[0].numpy()
    v = np.array([np.cos(0.3), np.sin(0.3)])
    x = np.array([[0.0, 1.0], [1.0, 0.0]])
    z = np.diag([1.0, -1.0])
    vals, secs = {}, {}
    for dev in (device, cpu):
        t0 = time.perf_counter()
        core = umps_mpo_evolve(v[:, None, None], h_core, cfg["t"], cfg["steps"],
                               cfg["bond"], imag=True, device=dev)
        secs[dev.type] = time.perf_counter() - t0
        core = core.cpu()
        vals[dev.type] = np.array([expect_local(core, x, device=cpu),
                                   expect_local(core, z, device=cpu),
                                   correlate(core, z, z, [1, 3], device=cpu)[1]])
    diff = float(np.abs(vals[device.type] - vals["cpu"]).max())
    log(f"  umps_mpo_evolve TFIM h {cfg['h']}, imaginary time {cfg['t']} in "
        f"{cfg['steps']} steps, bond {cfg['bond']}: card {secs[device.type]:.2f} s, "
        f"CPU {secs['cpu']:.2f} s ({smi}); <X>, <Z>, <Z_0 Z_3>_c "
        f"{', '.join(f'{float(np.real(a)):.10f}' for a in vals['cpu'])}; "
        f"max |card - CPU| {diff:.2e} (tol {cfg['tol']})")
    if not diff <= cfg["tol"]:
        raise AssertionError("uniform W^II evolution: card and CPU disagree")


# ---------------------------------------------------------------- phase 11


CATALAN = 0.9159655941772190
BETA_C = 0.5 * math.log(1.0 + math.sqrt(2.0))


def onsager_log_z(beta, n=3000):
    """Onsager's ln z per site of the square-lattice Ising model (the double
    integral by the trapezoid rule; at beta_c the closed form ln(2)/2 + 2G/pi,
    where the integrand touches log 0)."""
    import numpy as np

    if abs(beta - BETA_C) < 1e-12:
        return 0.5 * math.log(2.0) + 2.0 * CATALAN / math.pi
    th = np.linspace(0.0, np.pi, n)
    t1, t2 = np.meshgrid(th, th)
    f = np.log(np.cosh(2 * beta) ** 2 - np.sinh(2 * beta) * (np.cos(t1) + np.cos(t2)))
    return math.log(2.0) + float(np.trapezoid(np.trapezoid(f, th, axis=1), th)) / (
        2.0 * math.pi ** 2)


def yang_magnetization(beta):
    return (1.0 - math.sinh(2.0 * beta) ** -4) ** 0.125


def onsager_energy(beta):
    """Onsager's internal energy per site u = -coth(2b) [1 + (2 tanh^2(2b) - 1)
    (2/pi) K(k1)], k1 = 2 sinh(2b) / cosh^2(2b) (K by the AGM)."""
    t2 = math.tanh(2.0 * beta)
    k1 = 2.0 * math.sinh(2.0 * beta) / math.cosh(2.0 * beta) ** 2
    a, b = 1.0, math.sqrt(1.0 - k1 * k1)
    for _ in range(60):
        a, b = 0.5 * (a + b), math.sqrt(a * b)
    return -(1.0 / t2) * (1.0 + (2.0 * t2 * t2 - 1.0) * (2.0 / math.pi) * (math.pi / (2.0 * a)))


def xx_wick(beta, n_sites, site, dt, steps, n_k=4001):
    """<Z_j(t) Z_site>_beta of the INFINITE XX chain (h = (XX + YY)/2): Z = 2n - 1
    is string-free under Jordan-Wigner, so Wick's theorem gives 4 A B with A =
    int f e^{i eps t - i k r} dk/2pi, B = int (1 - f) e^{-i eps t + i k r}
    dk/2pi, eps_k = 2 cos k, f the Fermi function (numpy)."""
    import numpy as np

    ks = np.linspace(-np.pi, np.pi, n_k)
    eps = 2.0 * np.cos(ks)
    f = 1.0 / (1.0 + np.exp(beta * eps))
    out = np.zeros((n_sites, steps + 1), complex)
    for k in range(steps + 1):
        t = k * dt
        for j in range(n_sites):
            r = j - site
            a = np.trapezoid(f * np.exp(1j * eps * t - 1j * ks * r), ks) / (2 * np.pi)
            b = np.trapezoid((1 - f) * np.exp(-1j * eps * t + 1j * ks * r), ks) / (2 * np.pi)
            out[j, k] = 4.0 * a * b
    return out


def mera_start(chi, d, seed):
    """A MERA start as ``mera_ground_state`` draws one (identity
    disentanglers, random isometries), from a numpy generator, so that the
    card, the CPU and the JAX package (scripts/mera_reference.py) start
    alike."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chi1 = min(d ** 3, chi)

    def isometry(out_dim, in_dim):
        q, _ = np.linalg.qr(rng.normal(size=(in_dim, out_dim)))
        return q.T

    def eye4(m):
        return np.eye(m * m).reshape(m, m, m, m)

    return {"u": [eye4(d), eye4(chi1)],
            "w": [isometry(chi1, d ** 3).reshape(chi1, d, d, d),
                  isometry(chi, chi1 ** 3).reshape(chi, chi1, chi1, chi1)],
            "u_s": eye4(chi),
            "w_s": isometry(chi, chi ** 3).reshape(chi, chi, chi, chi)}


def two_d_paths(device, smi, sizes=TWO_D):
    """Phase 11: the 2D classical RG family, MERA, single-site iPEPS, tensor
    factorizations and the finite-temperature and infinite-boundary layer
    through the user entry points; returns ``{path: (counts, seconds)}``.
    Each path runs with every launch count zeroed just before it and read
    just after: none of them reaches a hand kernel, so none may launch one."""
    runs = {}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def drive(name, fn):
        reset_counters()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        runs[name] = (read_counters(), time.perf_counter() - t0)
        return out

    drive("ctmrg", lambda: ctmrg_path(device, smi, sizes["ctmrg"]))
    drive("trg", lambda: trg_path(device, smi, sizes["trg"]))
    drive("hotrg", lambda: hotrg_path(device, smi, sizes["hotrg"]))
    drive("mera", lambda: mera_path(device, smi, sizes["mera"]))
    drive("thermal", lambda: thermal_path(device, smi, sizes["thermal"]))
    drive("ibc_thermal", lambda: ibc_thermal_path(device, smi, sizes["ibc"]))
    drive("ibc_dynamic", lambda: ibc_dynamic_path(device, smi, sizes["ibc"]))
    drive("lindblad_infinite", lambda: lindblad_infinite_path(device, smi,
                                                              sizes["lindblad"]))
    drive("ipeps", lambda: ipeps_path(device, smi, sizes["ipeps"]))
    drive("factorize", lambda: factorize_path(device, smi, sizes["factorize"]))
    for path, (counts, _) in runs.items():
        if any(counts.values()):
            raise AssertionError(f"path {path}: hand-kernel launches {counts}")
    return runs


def _check(what, err, tol):
    if not err <= tol:
        raise AssertionError(f"{what}: {err:.3e} over its tolerance {tol:.1e}")


def _on(devices, fn):
    """``fn(dev)`` on each device, each call timed on the host clock ending
    in a synchronize; returns ``({device type: result}, {device type:
    seconds})``."""
    out, secs = {}, {}
    for dev in devices:
        out[dev.type], secs[dev.type] = _timed(lambda: fn(dev), dev)
    return out, secs


def ctmrg_path(device, smi, cfg):
    """CTMRG of the Ising model at beta_c (card and CPU against Onsager's
    closed form) and the symmetry-broken magnetization at beta 0.5."""
    from contractn_tpu_torch.models import (ctmrg_environment, free_energy_per_site,
                                            ising_tensor)
    from contractn_tpu_torch.models.ctmrg import expectation, ising_boundary

    exact = onsager_log_z(BETA_C)
    lz, secs = _timed(lambda: free_energy_per_site(
        ising_tensor(BETA_C, device=device), cfg["chi"], cfg["iters"]), device)
    err = abs(lz - exact)
    vals, cpu_secs = _on((device, torch.device("cpu")), lambda dev: free_energy_per_site(
        ising_tensor(BETA_C, device=dev), cfg["chi"], cfg["cpu_iters"]))
    log(f"  CTMRG Ising at beta_c, chi {cfg['chi']}, {cfg['iters']} iterations: "
        f"ln z {lz!r}, Onsager {exact!r}, |diff| {err:.3e} (tol {cfg['tol']}); card "
        f"{secs:.2f} s ({smi}); over {cfg['cpu_iters']} iterations card "
        f"{cpu_secs[device.type]:.2f} s, CPU {cpu_secs['cpu']:.2f} s, |card - CPU| "
        f"{abs(vals[device.type] - vals['cpu']):.3e} (tol {TOL_CARD_VS_CPU})")
    _check("CTMRG free energy against Onsager", err, cfg["tol"])
    _check("CTMRG free energy, card against CPU",
           abs(vals[device.type] - vals["cpu"]), TOL_CARD_VS_CPU)
    b = cfg["mag_beta"]
    m, secs = _timed(lambda: expectation(
        ising_tensor(b, device=device), ising_tensor(b, field_op=[1.0, -1.0], device=device),
        cfg["mag_chi"], iters=cfg["mag_iters"], boundary=ising_boundary(b, device=device)),
        device)
    err = abs(m - yang_magnetization(b))
    log(f"  CTMRG magnetization at beta {b}, chi {cfg['mag_chi']}: {m!r}, Yang "
        f"{yang_magnetization(b)!r}, |diff| {err:.3e} (tol {cfg['mag_tol']}); {secs:.2f} s")
    _check("CTMRG magnetization against Yang", err, cfg["mag_tol"])
    c, t = ctmrg_environment(ising_tensor(b, device=device), cfg["mag_chi"], iters=1)
    if c.device != device or t.shape != (cfg["mag_chi"], 2, cfg["mag_chi"]):
        raise AssertionError("CTMRG environment off the card or misshapen")


def trg_path(device, smi, cfg):
    """Levin-Nave TRG at beta 0.4 against Onsager's integral."""
    from contractn_tpu_torch.models import ising_tensor, trg_log_z

    b = cfg["beta"]
    got, secs = _timed(lambda: trg_log_z(ising_tensor(b, device=device), cfg["chi"],
                                         steps=cfg["steps"]), device)
    exact = onsager_log_z(b)
    log(f"  TRG Ising at beta {b}, chi {cfg['chi']}, {cfg['steps']} steps: ln z {got!r}, "
        f"Onsager {exact!r}, |diff| {abs(got - exact):.3e} (tol {cfg['tol']}); "
        f"{secs:.2f} s, {secs / cfg['steps']:.3f} s a step ({smi})")
    _check("TRG free energy against Onsager", abs(got - exact), cfg["tol"])


def hotrg_path(device, smi, cfg):
    """HOTRG at beta_c against the closed form, and the internal energy by
    autodiff through the flow against Onsager's."""
    from contractn_tpu_torch.models import hotrg_log_z, ising_internal_energy_ad, ising_tensor

    exact = onsager_log_z(BETA_C)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    got, secs = _timed(lambda: hotrg_log_z(ising_tensor(BETA_C, device=device), cfg["chi"],
                                           steps=cfg["steps"]), device)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else 0.0
    log(f"  HOTRG Ising at beta_c, chi {cfg['chi']}, {cfg['steps']} steps: ln z {got!r}, "
        f"|diff| from the closed form {abs(got - exact):.3e} (tol {cfg['tol']}); {secs:.2f} s, "
        f"peak device memory {peak:.2f} GiB ({smi})")
    _check("HOTRG free energy against Onsager", abs(got - exact), cfg["tol"])
    b = cfg["ad_beta"]
    u, secs = _timed(lambda: ising_internal_energy_ad(b, cfg["ad_chi"], cfg["ad_steps"]),
                     device)
    log(f"  HOTRG internal energy by autodiff at beta {b}, chi {cfg['ad_chi']}, "
        f"{cfg['ad_steps']} steps: {u!r}, Onsager {onsager_energy(b)!r}, |diff| "
        f"{abs(u - onsager_energy(b)):.3e} (tol {cfg['ad_tol']}); {secs:.2f} s")
    _check("HOTRG autodiff energy against Onsager", abs(u - onsager_energy(b)), cfg["ad_tol"])


def mera_path(device, smi, cfg):
    """The ternary MERA of the critical TFIM: card against CPU over the first
    sweeps, then the full run against -4/pi, the sigma dimension 1/8 and the
    JAX package's readings after the same sweeps; expand_mera to a larger
    bond, the same state, and a few sweeps there."""
    import numpy as np

    from contractn_tpu_torch.convert import state_from_numpy
    from contractn_tpu_torch.models import (expand_mera, mera_energy, mera_ground_state,
                                            scaling_dimensions)
    from contractn_tpu_torch.models.itebd import tfim_h2

    exact = -4.0 / math.pi
    start = mera_start(cfg["chi"], 2, cfg["seed"])
    h2 = tfim_h2()

    def run(dev, sweeps, init=None):
        return mera_ground_state(torch.from_numpy(h2).to(dev), cfg["chi"], sweeps=sweeps,
                                 init=init or state_from_numpy(start, device=dev))

    short, secs = _on((device, torch.device("cpu")), lambda dev: run(dev, cfg["cpu_sweeps"]))
    diff = abs(short[device.type][1] - short["cpu"][1])
    log(f"  MERA chi {cfg['chi']}, {cfg['cpu_sweeps']} sweeps: card {secs[device.type]:.2f} s, "
        f"CPU {secs['cpu']:.2f} s; |card - CPU| {diff:.3e} (tol {TOL_CARD_VS_CPU})")
    _check("MERA energy, card against CPU", diff, TOL_CARD_VS_CPU)
    (params, e), secs = _timed(lambda: run(device, cfg["sweeps"]), device)
    dim = float(scaling_dimensions(params, n=2)[1])
    log(f"  MERA chi {cfg['chi']}, {cfg['sweeps']} sweeps (the JAX test sweeps 12,000; cut to "
        f"the budget): {secs:.2f} s, {1e3 * secs / cfg['sweeps']:.2f} ms a sweep ({smi}); "
        f"energy {e!r}, above -4/pi by {e - exact:.3e} (the JAX test's tol 3e-4); sigma "
        f"dimension {dim!r}, from 1/8 by {abs(dim - 0.125):.3e} (the JAX test's tol 0.02); "
        f"the JAX package after the same sweeps: {cfg['e_ref']!r}, {cfg['dim_ref']!r}")
    if e < exact - 1e-9:
        raise AssertionError("MERA energy below the exact -4/pi: not variational")
    _check("MERA energy against the JAX package's", abs(e - cfg["e_ref"]), cfg["ref_tol"])
    _check("MERA sigma dimension against the JAX package's", abs(dim - cfg["dim_ref"]),
           cfg["ref_tol"] ** 0.5)
    big = expand_mera(params, cfg["big_chi"], generator=_gen(device, cfg["seed"]))
    h2t = torch.from_numpy(h2).to(device)
    e_small, e_big = mera_energy(params, h2t, rho_iters=400), mera_energy(big, h2t,
                                                                          rho_iters=400)
    (big, e6), secs = _timed(lambda: mera_ground_state(h2t, cfg["big_chi"],
                                                       sweeps=cfg["big_sweeps"], init=big),
                             device)
    log(f"  expand_mera to chi {cfg['big_chi']}: energy {e_big!r} vs {e_small!r} at chi "
        f"{cfg['chi']} (|diff| {abs(e_big - e_small):.3e}, tol 1e-8); {cfg['big_sweeps']} "
        f"sweeps at chi {cfg['big_chi']} in {secs:.2f} s, {1e3 * secs / cfg['big_sweeps']:.2f} "
        f"ms a sweep: energy {e6!r}")
    _check("expand_mera: the embedded state's energy", abs(e_big - e_small), 1e-8)
    if e6 < exact - 1e-9 or not np.isfinite(e6):
        raise AssertionError("MERA at the larger bond: energy not variational")


def thermal_path(device, smi, cfg):
    """Purification iTEBD of the critical TFIM at finite temperature (card
    against CPU, energy and ln Z against the exact integrals) and the W^II
    purification of the same chain."""
    import numpy as np

    from contractn_tpu_torch.models import (tfim_exact_thermal, tfim_mpo,
                                            thermal_energy_density, thermal_itebd,
                                            thermal_wii, thermal_wii_correlate,
                                            thermal_wii_expectation)
    from contractn_tpu_torch.models.itebd import tfim_h2

    lz, e_exact = tfim_exact_thermal(cfg["beta"])
    h2 = tfim_h2()

    def run(dev, beta):
        st = thermal_itebd(torch.from_numpy(h2).to(dev), beta, cfg["bond"], dbeta=cfg["dbeta"])
        return thermal_energy_density(st, h2), st["log_z"]

    (e, lnz), secs = _timed(lambda: run(device, cfg["beta"]), device)
    vals, cpu_secs = _on((device, torch.device("cpu")), lambda dev: run(dev, cfg["cpu_beta"]))
    (e_c, lnz_c), (e_cpu, lnz_cpu) = vals[device.type], vals["cpu"]
    diff = max(abs(e_c - e_cpu), abs(lnz_c - lnz_cpu))
    log(f"  thermal_itebd TFIM h 1, beta {cfg['beta']}, bond {cfg['bond']}, dbeta "
        f"{cfg['dbeta']}: energy {e!r} (exact {e_exact!r}, |diff| {abs(e - e_exact):.3e}, tol "
        f"{cfg['e_tol']}), ln Z {lnz!r} (exact {lz!r}, |diff| {abs(lnz - lz):.3e}, tol "
        f"{cfg['lz_tol']}); card {secs:.2f} s ({smi}); to beta {cfg['cpu_beta']} card "
        f"{cpu_secs[device.type]:.2f} s, CPU {cpu_secs['cpu']:.2f} s, |card - CPU| "
        f"{diff:.3e} (tol {TOL_CARD_VS_CPU})")
    _check("thermal energy against the exact integral", abs(e - e_exact), cfg["e_tol"])
    _check("thermal ln Z against the exact integral", abs(lnz - lz), cfg["lz_tol"])
    _check("thermal_itebd, card against CPU", diff, TOL_CARD_VS_CPU)
    hc = tfim_mpo(2, device=device).cores[0]
    sx, sz = np.array(SX), np.array(SZ)
    core, secs = _timed(lambda: thermal_wii(hc, cfg["beta"], cfg["bond"],
                                            dbeta=cfg["wii_dbeta"]), device)
    zz = np.real(thermal_wii_correlate(core, sz, sz, [1])[0])
    ex = np.real(thermal_wii_expectation(core, sx))
    ez = np.real(thermal_wii_expectation(core, sz))
    e = -(zz + ez * ez) - ex
    log(f"  thermal_wii TFIM, beta {cfg['beta']}, bond {cfg['bond']}, dbeta "
        f"{cfg['wii_dbeta']}: energy {e!r} (|diff| from exact {abs(e - e_exact):.3e}, tol "
        f"{cfg['wii_tol']}); {secs:.2f} s ({smi})")
    _check("thermal_wii energy against the exact integral", abs(e - e_exact), cfg["wii_tol"])


def ibc_thermal_path(device, smi, cfg):
    """The finite-temperature dynamic correlator of the infinite XX chain
    against the exact Wick oracle."""
    import numpy as np

    from contractn_tpu_torch.models import ibc_thermal_correlator, mpo_from_bond_term, thermal_wii

    sy_im = np.array([[0.0, -1.0], [1.0, 0.0]])  # i sigma_y
    h2 = 0.5 * (np.kron(SX, SX) - np.kron(sy_im, sy_im))
    hc = mpo_from_bond_term(h2, 2, device=device).cores[0]
    core, secs_w = _timed(lambda: thermal_wii(hc, cfg["beta"], cfg["bond"],
                                              dbeta=cfg["dbeta"]), device)
    z = np.array(SZ)
    c, secs = _timed(lambda: ibc_thermal_correlator(
        core, hc, z, z, cfg["n_sites"], cfg["site"], cfg["dt"], cfg["steps"],
        max_bond=cfg["bond"]), device)
    want = xx_wick(cfg["beta"], cfg["n_sites"], cfg["site"], cfg["dt"], cfg["steps"])
    err = float(np.abs(c - want).max())
    log(f"  ibc_thermal_correlator XX chain, beta {cfg['beta']}, bond {cfg['bond']} "
        f"(thermal_wii {secs_w:.2f} s), window {cfg['n_sites']}, {cfg['steps']} steps of "
        f"{cfg['dt']}: {secs:.2f} s ({smi}); max |C - Wick| {err:.3e} (tol {cfg['tol']})")
    _check("thermal IBC correlator against the Wick oracle", err, cfg["tol"])


def ibc_dynamic_path(device, smi, cfg):
    """The T = 0 dynamic correlator on a VUMPS ground state of the spin-1/2
    Heisenberg chain, card against CPU from the same ground state."""
    import numpy as np

    from contractn_tpu_torch.convert import ground_from_numpy, ground_to_numpy
    from contractn_tpu_torch.models import heisenberg_mpo, ibc_dynamic_correlator, vumps

    mpo = heisenberg_mpo(2, device=device)
    ground, secs_v = _timed(lambda: vumps(mpo, cfg["bond"], iters=cfg["heis_iters"],
                                          generator=_gen(device, cfg["seed"])), device)
    host = ground_to_numpy(ground)
    z = np.diag([0.5, -0.5])
    n, site = cfg["heis_sites"], cfg["heis_sites"] // 2 - 1
    vals, secs = _on((device, torch.device("cpu")), lambda dev: ibc_dynamic_correlator(
        ground_from_numpy(host, device=dev), mpo.cores[0].to(dev), z, z, n, site, cfg["dt"],
        cfg["heis_steps"], max_bond=cfg["bond"]))
    diff = float(np.abs(vals[device.type] - vals["cpu"]).max())
    exact = 1.0 - 4.0 * math.log(2.0)  # XX + YY + ZZ in Pauli matrices: 4 (1/4 - ln 2)
    log(f"  VUMPS Heisenberg bond {cfg['bond']}, {cfg['heis_iters']} iterations: energy "
        f"{ground['energy']!r} (Bethe {exact!r}, |diff| {abs(ground['energy'] - exact):.3e}, "
        f"tol {cfg['heis_tol']}), {secs_v:.2f} s; "
        f"ibc_dynamic_correlator window {n}, {cfg['heis_steps']} steps: card "
        f"{secs[device.type]:.2f} s, CPU {secs['cpu']:.2f} s ({smi}); C(site, 0) "
        f"{float(vals['cpu'][site, 0].real)!r} (1/4); |card - CPU| {diff:.3e} (tol {TOL_CARD_VS_CPU})")
    _check("VUMPS Heisenberg energy against Bethe", abs(ground["energy"] - exact),
           cfg["heis_tol"])
    _check("IBC dynamic correlator, card against CPU", diff, TOL_CARD_VS_CPU)
    _check("IBC correlator at t = 0: <S^z S^z> on site", abs(vals["cpu"][site, 0] - 0.25), 1e-10)


def lindblad_infinite_path(device, smi, cfg):
    """Uniform Lindblad evolution: pure dephasing against its closed form,
    and the steady-state search of the dephased TFIM, card against CPU."""
    import numpy as np

    from contractn_tpu_torch.models import (lindblad_evolve_infinite, ness_infinite,
                                            product_density, tfim_mpo, trace_expect)

    sx, sz = np.array(SX), np.array(SZ)
    plus = 0.5 * (np.eye(2) + sx)
    g, t = cfg["gamma"], cfg["t"]
    out = lindblad_evolve_infinite(product_density(plus, device=device), None, jumps=[sz],
                                   rates=[g], t=t, n_steps=10, bond_dim=4)
    err = abs(trace_expect(out, sx) - math.exp(-2 * g * t))
    log(f"  pure dephasing: <X>(t) {trace_expect(out, sx).real!r} against exp(-2 gamma t) "
        f"{math.exp(-2 * g * t)!r}, |diff| {err:.3e} (tol 1e-12)")
    _check("pure dephasing against its closed form", err, 1e-12)
    vals, secs = _on((device, torch.device("cpu")), lambda dev: ness_infinite(
        tfim_mpo(2, h=cfg["h"], device=dev).cores[0], jumps=[sz], rates=[cfg["rate"]],
        rho0=product_density(plus, device=dev), bond_dim=cfg["bond"], t_chunk=cfg["t_chunk"],
        max_chunks=cfg["max_chunks"], steps_per_unit=cfg["steps_per_unit"]))
    diff = float(np.abs(vals[device.type]["rho1"] - vals["cpu"]["rho1"]).max())
    log(f"  ness_infinite TFIM h {cfg['h']} + dephasing {cfg['rate']}, bond {cfg['bond']}, "
        f"{cfg['max_chunks']} chunks of {cfg['t_chunk']}: card {secs[device.type]:.2f} s, CPU "
        f"{secs['cpu']:.2f} s ({smi}); drift {vals['cpu']['drift']:.3e} per unit time, rho1 "
        f"toward I/2 by {np.abs(vals['cpu']['rho1'] - 0.5 * np.eye(2)).max():.3e}; "
        f"|card - CPU| {diff:.3e} (tol {TOL_CARD_VS_CPU})")
    _check("ness_infinite, card against CPU", diff, TOL_CARD_VS_CPU)


def ipeps_path(device, smi, cfg):
    """The square-root-Boltzmann iPEPS against Yang, and the simple-update +
    CTMRG ground state of the 2D TFIM, card against CPU."""
    import numpy as np

    from contractn_tpu_torch.models import ipeps_expect_local, ipeps_ground_state, tfim_bond_term_2d

    b = cfg["beta"]
    bm = np.array([[math.exp(b / 2), math.exp(-b / 2)], [math.exp(-b / 2), math.exp(b / 2)]])
    vals, vecs = np.linalg.eigh(bm)
    w = vecs * np.sqrt(np.maximum(vals, 0.0))[None, :]
    a = torch.from_numpy(np.einsum("su,sl,sd,sr->suldr", w, w, w, w)).to(device)
    y = np.kron(w[0], w[0])
    boundary = tuple(torch.from_numpy(x).to(device)
                     for x in (np.outer(y, y), np.einsum("l,d,r->ldr", y, y, y)))
    m, secs = _timed(lambda: float(ipeps_expect_local(a, np.array(SZ), cfg["chi"],
                                                      iters=cfg["iters"], boundary=boundary)),
                     device)
    err = abs(m - yang_magnetization(b))
    log(f"  sqrt-Boltzmann iPEPS at beta {b}, chi {cfg['chi']}: <Z> {m!r}, Yang "
        f"{yang_magnetization(b)!r}, |diff| {err:.3e} (tol {cfg['mag_tol']}); {secs:.2f} s")
    _check("iPEPS magnetization against Yang", err, cfg["mag_tol"])
    res, secs = _on((device, torch.device("cpu")), lambda dev: (lambda a_e: (
        float(a_e[1]), float(ipeps_expect_local(a_e[0], np.array(SX), cfg["gs_chi"],
                                                iters=cfg["gs_iters"]))))(
        ipeps_ground_state(tfim_bond_term_2d(h=cfg["h"], device=dev), cfg["bond"],
                           cfg["gs_chi"], iters=cfg["gs_iters"])))
    (e, mx), (e_cpu, mx_cpu) = res[device.type], res["cpu"]
    diff = max(abs(e - e_cpu), abs(mx - mx_cpu))
    pt2 = -cfg["h"] - 1.0 / (2 * cfg["h"])
    log(f"  ipeps_ground_state 2D TFIM h {cfg['h']}, D {cfg['bond']}, chi {cfg['gs_chi']}: "
        f"energy {e!r} (second-order perturbation theory {pt2!r}), <X> {mx!r}; card "
        f"{secs[device.type]:.2f} s, CPU {secs['cpu']:.2f} s ({smi}); |card - CPU| "
        f"{diff:.3e} (tol {TOL_CARD_VS_CPU})")
    _check("iPEPS ground state, card against CPU", diff, TOL_CARD_VS_CPU)


class _HostDraws:
    """``torch.randn`` drawing from one numpy generator and moving the draw
    to the requested device, so that the card and the CPU start from the
    same random factors."""

    def __init__(self, seed):
        import numpy as np

        self.rng = np.random.default_rng(seed)

    def __enter__(self):
        self.real = torch.randn
        torch.randn = lambda shape, dtype=None, device=None, generator=None: torch.from_numpy(
            self.rng.normal(size=tuple(shape))).to(device, dtype)

    def __exit__(self, *exc):
        torch.randn = self.real


def factorize_path(device, smi, cfg):
    """CP-ALS and Tucker HOOI of 256^3 tensors of the fitted rank plus noise,
    against the noise floor; card against CPU over the first sweeps."""
    import numpy as np

    from contractn_tpu_torch.models import cp_als, tucker_hooi

    n, r, rt = cfg["dim"], cfg["rank"], cfg["tucker"]
    rng = np.random.default_rng(cfg["seed"])
    x_cp = np.einsum("ra,rb,rc->abc", *(rng.normal(size=(r, n)) for _ in range(3)),
                     optimize=True)
    x_cp += cfg["noise"] * np.linalg.norm(x_cp) / n ** 1.5 * rng.normal(size=(n, n, n))
    core = rng.normal(size=(rt, rt, rt))
    facs = [np.linalg.qr(rng.normal(size=(n, rt)))[0] for _ in range(3)]
    x_tk = np.einsum("abc,ia,jb,kc->ijk", core, *facs, optimize=True)
    noise = rng.normal(size=(n, n, n))
    x_tk += cfg["noise"] * np.linalg.norm(x_tk) / np.linalg.norm(noise) * noise

    def cp(dev, steps):
        with _HostDraws(cfg["seed"]):
            return cp_als(torch.from_numpy(x_cp).to(dev), r, steps=steps)[1].cpu().numpy()

    errs, secs = _timed(lambda: cp(device, cfg["steps"]), device)
    cpu_errs = cp(torch.device("cpu"), cfg["cpu_steps"])
    diff = float(np.abs(errs[:cfg["cpu_steps"]] - cpu_errs).max())
    log(f"  cp_als rank {r} on {n}^3 (noise {cfg['noise']:.0e} of the norm), {cfg['steps']} "
        f"sweeps: {secs:.2f} s ({smi}); relative error {float(errs[-1])!r} (noise floor "
        f"{cfg['noise']!r}); first {cfg['cpu_steps']} sweeps |card - CPU| {diff:.3e} "
        f"(tol {TOL_CARD_VS_CPU})")
    _check("cp_als, card against CPU", diff, TOL_CARD_VS_CPU)
    _check("cp_als above the noise floor", errs[-1] - cfg["noise"], 0.05 * cfg["noise"])
    vals, secs = _on((device, torch.device("cpu")), lambda dev: tucker_hooi(
        torch.from_numpy(x_tk).to(dev), (rt, rt, rt), steps=cfg["tucker_steps"])[2].cpu().numpy())
    diff = float(np.abs(vals[device.type] - vals["cpu"]).max())
    log(f"  tucker_hooi ranks {rt} on {n}^3, {cfg['tucker_steps']} sweeps: card "
        f"{secs[device.type]:.2f} s, CPU {secs['cpu']:.2f} s ({smi}); relative error "
        f"{float(vals[device.type][-1])!r} (noise floor {cfg['noise']!r}); |card - CPU| {diff:.3e} "
        f"(tol {TOL_CARD_VS_CPU})")
    _check("tucker_hooi, card against CPU", diff, TOL_CARD_VS_CPU)
    _check("tucker_hooi above the noise floor", vals[device.type][-1] - cfg["noise"], 0.0)


# --------------------------------------------------------------------- #
# Phase 12: unit cells, iPEPS optimizers, fermionic PEPS, PEPS sampling
# --------------------------------------------------------------------- #


def peps2d_paths(device, smi, sizes=PEPS2D):
    """Phase 12: the cell CTMRG, the checkerboard simple update and its
    batched scan, the full update, variational iPEPS, 2D thermal states,
    fermionic PEPS, and PEPS sampling, Born machines and VMC through the
    user entry points; returns ``{path: (counts, seconds)}``.  Each path runs
    with every launch count zeroed just before it and read just after: none
    of them reaches a hand kernel, so none may launch one."""
    runs = {}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def drive(name, fn):
        reset_counters()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        runs[name] = (read_counters(), time.perf_counter() - t0)

    drive("cell_ctmrg", lambda: cell_ctmrg_path(device, smi, sizes["cell_ctmrg"]))
    drive("cell_su", lambda: cell_su_path(device, smi, sizes["cell_su"]))
    drive("scan", lambda: cell_scan_path(device, smi, sizes["scan"]))
    drive("full_update", lambda: full_update_path(device, smi, sizes["full_update"]))
    drive("variational", lambda: variational_path(device, smi, sizes["variational"]))
    drive("thermal2d", lambda: thermal2d_path(device, smi, sizes["thermal2d"]))
    drive("fermions", lambda: fermions_path(device, smi, sizes["fermions"]))
    drive("sampling", lambda: sampling_path(device, smi, sizes["sampling"]))
    for path, (counts, _) in runs.items():
        if any(counts.values()):
            raise AssertionError(f"path {path}: hand-kernel launches {counts}")
    return runs


def afm_cell(beta, eps, device):
    """The classical Ising antiferromagnet on the 2x2 checkerboard: site and
    spin-impurity tensors of both sublattices (``B_AFM = W_A W_B^T``) under a
    staggered field ``eps``."""
    import numpy as np

    b_fm = np.array([[math.exp(beta), math.exp(-beta)], [math.exp(-beta), math.exp(beta)]])
    vals, vecs = np.linalg.eigh(b_fm)
    w = vecs * np.sqrt(np.maximum(vals, 0.0))[None, :]
    wa, wb = w, np.array([[0.0, 1.0], [1.0, 0.0]]) @ w
    spin = np.array([1.0, -1.0])

    def site(wm, p, s):
        return torch.from_numpy(np.einsum("s,s,su,sl,sd,sr->uldr", s, p, wm, wm, wm,
                                          wm)).to(device)

    pa, pb, one = np.exp(eps * spin), np.exp(-eps * spin), np.ones(2)
    a_a, a_b = site(wa, pa, one), site(wb, pb, one)
    i_a, i_b = site(wa, pa, spin), site(wb, pb, spin)
    return ((a_a, a_b), (a_b, a_a)), ((i_a, i_b), (i_b, i_a))


def cell_ctmrg_path(device, smi, cfg):
    """The staggered magnetization of the checkerboard antiferromagnet
    against Onsager-Yang (card, and card against CPU), and the row-channel
    correlation length above T_c against the exact axial value."""
    from contractn_tpu_torch.models import (ctmrg_cell, ising_tensor, row_transfer_spectrum,
                                            site_expectation)

    b = cfg["beta"]

    def moments(dev, chi, iters):
        cell, imps = afm_cell(b, cfg["eps"], dev)
        env = ctmrg_cell(cell, chi, iters=iters)
        return [[float(site_expectation(cell, env, imps[x][y], x, y)) for y in range(2)]
                for x in range(2)]

    ms, secs = _timed(lambda: moments(device, cfg["chi"], cfg["iters"]), device)
    exact = yang_magnetization(b)
    err = max(abs(abs(m) - exact) for row in ms for m in row)
    stagger = max(abs(ms[0][0] - ms[1][1]), abs(ms[1][0] - ms[0][1]), abs(ms[0][0] + ms[1][0]))
    log(f"  ctmrg_cell AFM checkerboard at beta {b}, chi {cfg['chi']}, {cfg['iters']} "
        f"iterations: moments {ms}, Yang {exact!r}, max |diff| {err:.3e} (tol "
        f"{cfg['mag_tol']}), alternation {stagger:.3e} (tol 1e-9); {secs:.2f} s ({smi})")
    _check("cell CTMRG staggered magnetization against Yang", err, cfg["mag_tol"])
    _check("cell CTMRG sublattice alternation", stagger, 1e-9)
    bx = cfg["xi_beta"]

    def xi():
        a = ising_tensor(bx, device=device)
        return row_transfer_spectrum(((a,),), ctmrg_cell(((a,),), cfg["xi_chi"],
                                                         iters=cfg["xi_iters"]))[1]

    got, secs = _timed(xi, device)
    exact = 1.0 / (math.log(1.0 / math.tanh(bx)) - 2.0 * bx)
    rel = abs(got - exact) / exact
    log(f"  row_transfer_spectrum Ising at beta {bx}, chi {cfg['xi_chi']}: xi {got!r}, exact "
        f"{exact!r}, relative |diff| {rel:.3e} (tol {cfg['xi_tol']}); {secs:.2f} s")
    _check("cell CTMRG correlation length against Onsager", rel, cfg["xi_tol"])
    res, secs = _on((device, torch.device("cpu")),
                    lambda dev: moments(dev, cfg["cpu_chi"], cfg["cpu_iters"]))
    diff = max(abs(x - y) for rx, ry in zip(res[device.type], res["cpu"])
               for x, y in zip(rx, ry))
    log(f"  ctmrg_cell AFM, chi {cfg['cpu_chi']}: card {secs[device.type]:.2f} s, CPU "
        f"{secs['cpu']:.2f} s; |card - CPU| {diff:.3e} (tol {cfg['cpu_tol']}; projector SVDs "
        f"by cuSOLVER against LAPACK)")
    _check("cell CTMRG magnetization, card against CPU", diff, cfg["cpu_tol"])


QMC_HEISENBERG = -0.669437  # Sandvik's QMC ground energy per site of the 2D AFM


def cell_su_path(device, smi, cfg):
    """The checkerboard simple update of the unrotated Heisenberg model: the
    JAX test's size card against CPU, then D 3 below it and above the QMC
    energy, with the staggered moment equal on every site and alternating
    (energy and moments read in one environment)."""
    import numpy as np

    from contractn_tpu_torch.models import (ctmrg_cell, heisenberg_bond_term_2d,
                                            ipeps_cell_ground_state, simple_update_cell,
                                            site_expectation, su_cell_absorb)
    from contractn_tpu_torch.models.ipeps import peps_double_layer
    from contractn_tpu_torch.models.ipeps_cell import cell_energy_from_env, checkerboard_cell

    res, secs = _on((device, torch.device("cpu")), lambda dev: float(ipeps_cell_ground_state(
        heisenberg_bond_term_2d(rotated=False, device=dev), cfg["cpu_bond"], cfg["cpu_chi"],
        schedule=cfg["cpu_schedule"], iters=cfg["cpu_iters"])[2]))
    e2, diff = res[device.type], abs(res[device.type] - res["cpu"])
    log(f"  ipeps_cell_ground_state Heisenberg D {cfg['cpu_bond']}, chi {cfg['cpu_chi']}: "
        f"energy {e2!r}; card {secs[device.type]:.2f} s, CPU {secs['cpu']:.2f} s ({smi}); "
        f"|card - CPU| {diff:.3e} (tol {cfg['cpu_tol']}; SVDs by cuSOLVER against LAPACK)")
    _check("cell simple update, card against CPU", diff, cfg["cpu_tol"])
    h2 = heisenberg_bond_term_2d(rotated=False, device=device)
    (a, b), su_secs = _timed(lambda: su_cell_absorb(*simple_update_cell(
        h2, cfg["bond"], schedule=cfg["schedule"])), device)

    def measure():
        cell = checkerboard_cell(a, b)
        env = ctmrg_cell(cell, cfg["chi"], iters=cfg["iters"])
        sites = ((a, b), (b, a))
        moms = [[[float(site_expectation(cell, env, peps_double_layer(sites[x][y], op), x, y))
                  for y in range(2)] for x in range(2)]
                for op in (np.diag([0.5, -0.5]), np.array([[0.0, 0.5], [0.5, 0.0]]))]
        return float(cell_energy_from_env(a, b, h2, cell, env)), moms

    (e3, (mz, mx)), secs = _timed(measure, device)
    mvec = [[math.hypot(mz[x][y], mx[x][y]) for y in range(2)] for x in range(2)]
    comp = mx if abs(mx[0][0]) > abs(mz[0][0]) else mz
    spread = max(abs(mvec[x][y] - mvec[0][0]) for x in range(2) for y in range(2))
    stagger = max(abs(comp[0][0] - comp[1][1]), abs(comp[0][0] + comp[0][1]),
                  abs(comp[0][1] - comp[1][0]))
    sweeps = sum(n for _, n in cfg["schedule"])
    log(f"  simple_update_cell + ctmrg_cell Heisenberg D {cfg['bond']}, {sweeps} sweeps "
        f"({su_secs:.2f} s), chi {cfg['chi']}, {cfg['iters']} iterations ({secs:.2f} s): "
        f"energy {e3!r} (QMC {QMC_HEISENBERG}, D {cfg['cpu_bond']} {e2!r}); moments "
        f"{mvec[0][0]!r} (spread {spread:.2e}), dominant component {comp} (alternation "
        f"{stagger:.2e}, tol {cfg['mom_tol']})")
    if not QMC_HEISENBERG < e3 < e2:
        raise AssertionError(f"D {cfg['bond']} energy {e3} outside ({QMC_HEISENBERG}, {e2})")
    _check("staggered moment equal on every site", spread, cfg["mom_tol"])
    _check("staggered moment alternation", stagger, cfg["mom_tol"])
    if not cfg["moment"][0] < mvec[0][0] < cfg["moment"][1]:
        raise AssertionError(f"staggered moment {mvec[0][0]} outside {cfg['moment']}")


def cell_scan_path(device, smi, cfg):
    """``ipeps_cell_scan`` over a TFIM field family in one batched program:
    ordered below h_c, paramagnetic above, two members equal to the
    unbatched pipeline."""
    import numpy as np

    from contractn_tpu_torch.models import (ipeps_cell_ground_state, ipeps_cell_scan,
                                            tfim_bond_term_2d)

    hs = np.linspace(*cfg["h"], cfg["n"])
    h2s = torch.stack([tfim_bond_term_2d(1.0, float(h), device=device) for h in hs])
    out, secs = _timed(lambda: ipeps_cell_scan(h2s, cfg["bond"], cfg["chi"],
                                               schedule=cfg["schedule"], iters=cfg["iters"],
                                               ops=(np.diag([1.0, -1.0]),)), device)
    mz = out["moments"][:, 0].abs().cpu().numpy()
    energy = out["energy"].cpu().numpy()
    lo, hi = cfg["ordered_below"], cfg["para_above"]
    ordered = float(min(m for h, m in zip(hs, mz) if h < lo))
    para = float(max(m for h, m in zip(hs, mz) if h > hi))
    log(f"  ipeps_cell_scan TFIM, {cfg['n']} fields over h {cfg['h']}, D {cfg['bond']}, chi "
        f"{cfg['chi']}: {secs:.2f} s, {secs / cfg['n']:.3f} s a member ({smi}); |<Z>| "
        f"{[round(float(m), 6) for m in mz]}; below h {lo}: min {ordered!r} (> "
        f"{cfg['ordered']}), above h {hi}: max {para!r} (< {cfg['para']}); exact h_c "
        f"{cfg['h_c']}, the fields between are printed, not held")
    if not ordered > cfg["ordered"]:
        raise AssertionError(f"scan: moment {ordered} below h_c, not ordered")
    _check("scan: paramagnetic moments", para, cfg["para"])
    for i in cfg["members"]:
        (_, _, e), usecs = _timed(lambda: ipeps_cell_ground_state(
            h2s[i], cfg["bond"], cfg["chi"], schedule=cfg["schedule"], iters=cfg["iters"]),
            device)
        diff = abs(float(e) - float(energy[i]))
        log(f"  unbatched member h {hs[i]:.4f}: energy {float(e)!r}, |scan - unbatched| "
            f"{diff:.3e} (tol {cfg['tol']}); {usecs:.2f} s against {secs / cfg['n']:.3f} s a "
            f"member in the scan")
        _check("scan member against the unbatched pipeline", diff, cfg["tol"])


def full_update_path(device, smi, cfg):
    """The fast full update of the Heisenberg model from the simple-update
    state: below it and above the QMC energy."""
    from contractn_tpu_torch.models import (cell_energy, full_update_ground_state,
                                            heisenberg_bond_term_2d, simple_update_cell,
                                            su_cell_absorb)

    h2 = heisenberg_bond_term_2d(device=device)
    ga, gb, lams = simple_update_cell(h2, cfg["bond"], schedule=cfg["su_schedule"])
    a0, b0 = su_cell_absorb(ga, gb, lams)
    e_su = float(cell_energy(a0, b0, h2, cfg["chi"], iters=cfg["iters"]))
    (_, _, e_fu), secs = _timed(lambda: full_update_ground_state(
        h2, cfg["bond"], cfg["chi"], schedule=cfg["schedule"], iters=cfg["iters"],
        init=(a0, b0), n_ctm=1, ctm_iters=cfg["ctm_iters"]), device)
    e_fu = float(e_fu)
    steps = sum(n for _, n in cfg["schedule"])
    log(f"  full_update_ground_state Heisenberg D {cfg['bond']}, chi {cfg['chi']}, {steps} "
        f"steps: E_FU {e_fu!r}, E_SU {e_su!r} (gain {e_su - e_fu:.3e}, needed "
        f"{cfg['gain']}), QMC {QMC_HEISENBERG}; {secs:.2f} s, {secs / steps:.3f} s a step "
        f"({smi})")
    if not (e_fu < e_su - cfg["gain"] and e_fu > QMC_HEISENBERG):
        raise AssertionError(f"full update {e_fu} not in ({QMC_HEISENBERG}, {e_su - cfg['gain']})")


def variational_path(device, smi, cfg):
    """Variational checkerboard iPEPS of the Heisenberg model (below the
    simple update, above QMC, a non-increasing trace) and C4v iPEPS of the
    TFIM (below its simple update)."""
    from contractn_tpu_torch.models import (cell_energy, heisenberg_bond_term_2d,
                                            ipeps_ground_state, simple_update_cell,
                                            su_cell_absorb, tfim_bond_term_2d,
                                            variational_ipeps, variational_ipeps_cell)

    sched = cfg["su_schedule"]
    h2 = heisenberg_bond_term_2d(rotated=False, device=device)
    a0, b0 = su_cell_absorb(*simple_update_cell(h2, cfg["bond"], schedule=sched))
    e_su = float(cell_energy(a0, b0, h2, cfg["chi"], iters=cfg["env_iters"]))
    (_, _, e_var, trace), secs = _timed(lambda: variational_ipeps_cell(
        h2, cfg["bond"], cfg["chi"], steps=cfg["steps"], lr=cfg["lr"],
        refresh_iters=cfg["refresh_iters"], grad_iters=cfg["grad_iters"], init=(a0, b0),
        env_iters=cfg["env_iters"]), device)
    rise = max([b - a for a, b in zip(trace, trace[1:])] + [0.0])
    log(f"  variational_ipeps_cell Heisenberg D {cfg['bond']}, chi {cfg['chi']}, "
        f"{cfg['steps']} steps: E {e_var!r} (E_SU {e_su!r}, gain {e_su - e_var:.3e}, needed "
        f"{cfg['gain']}; QMC {QMC_HEISENBERG}; the JAX package's README {cfg['readme']} at "
        f"more steps); trace {trace[0]!r} -> {trace[-1]!r}, largest rise {rise:.2e} (tol "
        f"{cfg['trace_tol']}); {secs:.2f} s, {secs / cfg['steps']:.3f} s a step ({smi})")
    if not (e_var < e_su - cfg["gain"] and e_var > QMC_HEISENBERG):
        raise AssertionError(f"variational cell energy {e_var} not in ({QMC_HEISENBERG}, "
                             f"{e_su - cfg['gain']})")
    _check("variational trace non-increasing", rise, cfg["trace_tol"])
    h2 = tfim_bond_term_2d(1.0, cfg["tfim_h"], device=device)
    _, e_su = ipeps_ground_state(h2, cfg["bond"], cfg["chi"], schedule=sched, iters=150)
    e_su = float(e_su)
    (_, e_var, trace), secs = _timed(lambda: variational_ipeps(
        h2, cfg["bond"], cfg["chi"], steps=cfg["tfim_steps"], lr=3e-3, su_schedule=sched),
        device)
    log(f"  variational_ipeps TFIM h {cfg['tfim_h']}, D {cfg['bond']}, chi {cfg['chi']}, "
        f"{cfg['tfim_steps']} steps: E {e_var!r}, E_SU {e_su!r} (gain {e_su - e_var:.3e}); "
        f"{secs:.2f} s")
    if not e_var < e_su:
        raise AssertionError(f"variational TFIM energy {e_var} not below {e_su}")


def thermal2d_path(device, smi, cfg):
    """The purification iPEPS of the commuting Ising model: Onsager's
    energy and Yang's magnetization."""
    import numpy as np

    from contractn_tpu_torch.models import (thermal2d_energy, thermal2d_site_expectation,
                                            thermal_ipeps_cell)

    b, z = cfg["beta"], np.diag([1.0, -1.0])
    h2 = torch.from_numpy(-np.kron(z, z)).to(device)

    def run():
        a, bb = thermal_ipeps_cell(h2, b, cfg["bond"], cfg["n_steps"])
        e = float(thermal2d_energy(a, bb, h2, cfg["chi"], iters=cfg["iters"]))
        ms = thermal2d_site_expectation(a, bb, z, cfg["chi"], iters=cfg["iters"])
        return e, [abs(float(v)) for row in ms for v in row]

    (e, ms), secs = _timed(run, device)
    e_err = abs(e - onsager_energy(b))
    m_err = max(abs(m - yang_magnetization(b)) for m in ms)
    log(f"  thermal_ipeps_cell commuting ZZ at beta {b}, D {cfg['bond']}, chi {cfg['chi']}: "
        f"energy {e!r}, Onsager {onsager_energy(b)!r}, |diff| {e_err:.3e} (tol "
        f"{cfg['e_tol']}); |<Z>| against Yang {m_err:.3e} (tol {cfg['m_tol']}); {secs:.2f} s "
        f"({smi})")
    _check("thermal 2D energy against Onsager", e_err, cfg["e_tol"])
    _check("thermal 2D magnetization against Yang", m_err, cfg["m_tol"])


def fermions_path(device, smi, cfg):
    """Fermionic PEPS: the boundary energy against Fock ED, the finite
    gradient ground state against ED, the p-wave iPEPS against the BdG
    integral, and the checkerboard Hubbard AFM."""
    import numpy as np

    from contractn_tpu_torch.models import (bdg_energy_2d, fipeps_ground_state, fpeps_energy,
                                            hubbard_cell_ground_state, random_fpeps)
    from contractn_tpu_torch.models.fswap import (fock_state, fpeps_ground_state,
                                                  hopping_fock_matrix)

    c = cfg["bdg"]
    tn, ph, pv = random_fpeps(c["ly"], c["lx"], seed=c["seed"])
    psi = fock_state(tn, ph, pv)
    h = hopping_fock_matrix(c["ly"], c["lx"], t=c["t"], mu=c["mu"], delta=c["delta"])
    want = float(psi @ (h @ psi)) / float(psi @ psi)
    got, secs = _timed(lambda: fpeps_energy(tn, ph, pv, t=c["t"], mu=c["mu"],
                                            delta=c["delta"], device=device), device)
    log(f"  fpeps_energy {c['ly']}x{c['lx']} BdG: {got!r}, Fock {want!r}, |diff| "
        f"{abs(got - want):.3e} (tol {c['tol']}); {secs:.2f} s ({smi})")
    _check("fpeps_energy against Fock ED", abs(got - want), c["tol"])
    c = cfg["fpeps"]
    e_ed = float(np.linalg.eigvalsh(hopping_fock_matrix(c["ly"], c["lx"], t=c["t"], mu=c["mu"],
                                                        delta=c["delta"]))[0])
    (_, e, tr), secs = _timed(lambda: fpeps_ground_state(
        c["ly"], c["lx"], t=c["t"], mu=c["mu"], delta=c["delta"], chi=c["chi"],
        steps=c["steps"], lr=c["lr"], seed=0, device=device), device)
    rel = (e - e_ed) / abs(e_ed)
    log(f"  fpeps_ground_state {c['ly']}x{c['lx']} D 2, chi {c['chi']}, {c['steps']} steps: "
        f"{e!r}, ED {e_ed!r}, relative {rel:.3e} (tol {c['tol']}, from above); {secs:.2f} s")
    if not (e >= e_ed - 1e-9 and rel < c["tol"]):
        raise AssertionError(f"fpeps ground state {e} against ED {e_ed}")
    c = cfg["fipeps"]
    want = bdg_energy_2d(c["t"], c["mu"], c["delta"])
    (_, e, dens, tr), secs = _timed(lambda: fipeps_ground_state(
        chi=c["chi"], t=c["t"], mu=c["mu"], delta=c["delta"], steps=c["steps"], lr=c["lr"],
        refresh_iters=c["refresh_iters"], grad_iters=c["grad_iters"], env_iters=c["env_iters"],
        seed=0, device=device), device)
    rel = (e - want) / abs(want)
    log(f"  fipeps_ground_state p-wave (t {c['t']}, mu {c['mu']}, delta {c['delta']}) D 2, "
        f"chi {c['chi']}, {c['steps']} steps: {e!r}, BdG {want!r}, relative {rel:.3e} (tol "
        f"{c['tol']}, from above; the JAX package's README {c['readme']}), density "
        f"{dens!r}; {secs:.2f} s, {secs / c['steps']:.3f} s a step")
    if not (e > want - 1e-8 and rel < c["tol"]):
        raise AssertionError(f"fipeps ground state {e} against BdG {want}")
    c = cfg["hubbard"]
    (_, _, e, obs, tr), secs = _timed(lambda: hubbard_cell_ground_state(
        chi=c["chi"], u=c["u"], steps=c["steps"], lr=c["lr"], refresh_iters=c["refresh_iters"],
        grad_iters=c["grad_iters"], env_iters=c["env_iters"], seed=0, device=device), device)
    corr = e + c["u"] / 2.0
    fill = obs["n_up"][0][0] + obs["n_dn"][0][0]
    stag = obs["n_up"][0][0] - obs["n_up"][1][0]
    log(f"  hubbard_cell_ground_state U {c['u']}, mu U/2, D 2, chi {c['chi']}, {c['steps']} "
        f"steps: E + U/2 {corr!r} (< 0), filling {fill!r}, staggered n_up {stag!r}, docc "
        f"{obs['docc'][0][0]!r}; {secs:.2f} s")
    if not (corr < 0.0 and abs(fill - 1.0) < c["fill_tol"] and stag > c["stagger"]):
        raise AssertionError(f"Hubbard cell: E + U/2 {corr}, filling {fill}, obs {obs}")


def sampling_path(device, smi, cfg):
    """Exact raster sampling of a random 6 x 6 PEPS against its marginals and
    log-probabilities, the GHZ Born machine, and VMC of the 2 x 2 TFIM
    against exact diagonalization."""
    import itertools

    import numpy as np

    from contractn_tpu_torch.models import (fit_peps_born, fit_peps_vmc, peps_born_machine,
                                            peps_log_prob, sample_peps, vmc_energy_and_grad)
    from contractn_tpu_torch.models.peps_born import peps_log_norm
    from contractn_tpu_torch.models.peps_vmc import peps_log_amp

    gen = torch.Generator(device=device).manual_seed(cfg["seed"])
    rows, cols, chi, n = cfg["rows"], cfg["cols"], cfg["chi"], cfg["n"]
    grid = peps_born_machine(rows, cols, bond_dim=cfg["bond"], generator=gen, device=device)
    (samples, log_p), secs = _timed(lambda: sample_peps(grid, n, chi, generator=gen), device)
    lp_err = float((log_p - peps_log_prob(grid, samples.long(), chi)).abs().max())
    log_z = float(peps_log_norm(grid, chi))
    worst = 0.0
    for r, c in cfg["sites"]:
        proj = [[t[1:] if (rr, cc) == (r, c) else t for cc, t in enumerate(row)]
                for rr, row in enumerate(grid)]
        p1 = math.exp(float(peps_log_norm(proj, chi)) - log_z)
        freq = float((samples[:, r, c] == 1).double().mean())
        sigma = math.sqrt(p1 * (1 - p1) / n)
        worst = max(worst, abs(freq - p1) / sigma)
        log(f"  marginal p(s_{r}{c} = 1) {p1!r}, empirical {freq!r} ({abs(freq - p1) / sigma:.2f}"
            f" sigma)")
    log(f"  sample_peps {rows}x{cols} D {cfg['bond']}, chi {chi}, {n} samples: {secs:.2f} s "
        f"({smi}); max |log p - peps_log_prob| {lp_err:.3e} (tol {cfg['lp_tol']}); worst "
        f"marginal {worst:.2f} sigma (tol {cfg['sigmas']})")
    _check("sampler log-probabilities against peps_log_prob", lp_err, cfg["lp_tol"])
    _check("sampled marginals (sigmas)", worst, cfg["sigmas"])
    data = torch.stack([torch.zeros((2, 3), dtype=torch.int64),
                        torch.ones((2, 3), dtype=torch.int64)]).to(device)
    born = peps_born_machine(2, 3, bond_dim=2, generator=gen, device=device)
    (born, losses), secs = _timed(lambda: fit_peps_born(
        born, data, steps=cfg["ghz_steps"], chi=cfg["ghz_chi"], lr=cfg["ghz_lr"]), device)
    nll = float(losses[-1])
    back, _ = sample_peps(born, cfg["ghz_samples"], cfg["ghz_chi"], generator=gen)
    flat = back.reshape(back.shape[0], -1)
    uniform = float((flat == flat[:, :1]).all(dim=1).double().mean())
    heads = float(flat[:, 0].double().mean())
    log(f"  fit_peps_born GHZ 2x3, {cfg['ghz_steps']} steps: NLL {nll!r}, ln 2 "
        f"{math.log(2.0)!r}, |diff| {abs(nll - math.log(2.0)):.3e} (tol {cfg['ghz_tol']}); "
        f"{cfg['ghz_samples']} samples back, share all-equal {uniform} (needed "
        f"{cfg['ghz_uniform']}), share of ones {heads:.3f}; {secs:.2f} s")
    _check("GHZ NLL against ln 2", abs(nll - math.log(2.0)), cfg["ghz_tol"])
    if uniform < cfg["ghz_uniform"] or (cfg["ghz_uniform"] and not 0.1 < heads < 0.9):
        raise AssertionError("GHZ samples are not the two configurations")
    z, x = np.diag([1.0, -1.0]), np.array([[0.0, 1.0], [1.0, 0.0]])
    h2 = -np.kron(z, z) - 0.75 * (np.kron(x, np.eye(2)) + np.kron(np.eye(2), x)) / 2.0
    cfgs = np.array(list(itertools.product([0, 1], repeat=4))).reshape(-1, 2, 2)
    ham = np.zeros((16, 16))
    for i1, i2 in [(0, 1), (2, 3), (0, 2), (1, 3)]:
        for s in range(16):
            bits = [(s >> (3 - k)) & 1 for k in range(4)]
            for p in range(2):
                for q in range(2):
                    t = list(bits)
                    t[i1], t[i2] = p, q
                    ham[s, sum(v << (3 - k) for k, v in enumerate(t))] += h2[
                        bits[i1] * 2 + bits[i2], p * 2 + q]
    e_ed = float(np.linalg.eigvalsh(ham)[0])
    vmc = [[0.3 + 0.5 * t for t in row] for row in peps_born_machine(
        2, 2, bond_dim=2, generator=gen, device=device)]
    cfgs = torch.from_numpy(cfgs).to(device)

    def exact(grid):
        """The VMC estimators over every configuration with its Born weight
        (the exact energy), and the dense Rayleigh quotient of the same
        amplitudes, which they must equal."""
        e, _, var = vmc_energy_and_grad(grid, cfgs, h2, h2,
                                        weights=torch.exp(peps_log_prob(grid, cfgs, 4)))
        amps = np.array([float(sg * torch.exp(lg)) for sg, lg in
                         (peps_log_amp(grid, c) for c in cfgs)])
        dense = float(amps @ ham @ amps / (amps @ amps))
        return float(e), float(var), abs(float(e) - dense)

    e0, _, _ = exact(vmc)
    (vmc, es), secs = _timed(lambda: fit_peps_vmc(
        vmc, h2, h2, steps=cfg["vmc_steps"], num_samples=cfg["vmc_samples"], chi=4,
        lr=cfg["vmc_lr"], generator=gen), device)
    e, var, identity = exact(vmc)
    rel = abs(e - e_ed) / abs(e_ed)
    log(f"  fit_peps_vmc 2x2 TFIM D 2, {cfg['vmc_steps']} steps of {cfg['vmc_samples']} "
        f"samples: exact energy of the result {e!r} (start {e0!r}; the estimators over every "
        f"configuration against the dense Rayleigh quotient {identity:.2e}, tol 1e-10), ED "
        f"{e_ed!r}, relative {rel:.3e} (tol {cfg['vmc_tol']}), variance {var:.3e}, last "
        f"sampled {es[-1]!r}; {secs:.2f} s, {secs / cfg['vmc_steps']:.3f} s a step")
    _check("VMC estimators against the dense Rayleigh quotient", identity, 1e-10)
    _check("VMC energy against ED", rel, cfg["vmc_tol"])


def three_d_ttn_paths(device, smi, sizes=THREE_D):
    """Phase 13: the 3D family (3D HOTRG, cubic iPEPS, 3D thermal
    purification) and tree tensor networks (TTN-DMRG, the Adam ground state,
    TTN-TDVP) through the user entry points; returns ``{path: (counts,
    seconds)}``.  Each path runs with every launch count zeroed just before it
    and read just after: the 3D merge is a plain GEMM chain outside any hand
    kernel, so no path may launch one."""
    runs = {}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def drive(name, fn):
        reset_counters()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        runs[name] = (read_counters(), time.perf_counter() - t0)

    drive("hotrg3d_flow", lambda: hotrg3d_flow_path(device, smi, sizes["flow"]))
    drive("hotrg3d_anchors", lambda: hotrg3d_anchor_path(device, smi, sizes["anchors"]))
    drive("ipeps3d", lambda: ipeps3d_path(device, smi, sizes["ipeps"]))
    drive("thermal3d", lambda: thermal3d_path(device, smi, sizes["thermal"]))
    drive("ttn_dmrg", lambda: ttn_dmrg_path(device, smi, sizes["ttn"]))
    drive("ttn_adam", lambda: ttn_adam_path(device, smi, sizes["adam"]))
    drive("ttn_tdvp", lambda: ttn_tdvp_path(device, smi, sizes["tdvp"]))
    for path, (counts, _) in runs.items():
        if any(counts.values()):
            raise AssertionError(f"path {path}: hand-kernel launches {counts}")
    return runs


def hotrg3d_flow_path(device, smi, cfg):
    """bench_hotrg3d's flow in float32 (effective TFLOP/s as bench.py counts
    them) and float64 on the card, then chi 16 with its peak memory."""
    from contractn_tpu_torch.models import hotrg3d_log_z, ising3d_tensor_smooth

    cuda = device.type == "cuda"
    a64 = ising3d_tensor_smooth(cfg["beta"], device=device)
    a32 = a64.float()
    chi, steps = cfg["chi"], cfg["steps"]
    hotrg3d_log_z(a32, chi, 1)  # warm-up: library handles and workspaces
    lz32, secs = _timed(lambda: hotrg3d_log_z(a32, chi, steps), device)
    flops = steps * 3 * 2 * chi ** 11  # bench.py:589
    log(f"  3D HOTRG (bench_hotrg3d) beta {cfg['beta']}, chi {chi}, {steps} steps, float32: "
        f"ln z {lz32!r}; {secs:.3f} s, {flops / secs / 1e12:.2f} TFLOP/s effective "
        f"({flops:.3e} FLOPs), {100 * flops / secs / PEAK_F32:.1f}% of the fp32 peak "
        f"{PEAK_F32 / 1e12:.0f} TFLOP/s ({smi})")
    lz64, secs64 = _timed(lambda: hotrg3d_log_z(a64, chi, steps), device)
    log(f"  the same flow in float64: ln z {lz64!r}; {secs64:.3f} s, "
        f"{flops / secs64 / 1e12:.2f} TFLOP/s effective; |float32 - float64| "
        f"{abs(lz32 - lz64):.3e} (tol {TOL_F32})")
    _check("3D HOTRG float32 ln z against float64", abs(lz32 - lz64), TOL_F32)
    big, big_steps = cfg["big_chi"], cfg["big_steps"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    lz_big, secs = _timed(lambda: hotrg3d_log_z(a32, big, big_steps), device)
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else 0.0
    flops = big_steps * 3 * 2 * big ** 11
    log(f"  chi {big}, {big_steps} steps, float32: ln z {lz_big!r}; {secs:.3f} s, "
        f"{flops / secs / 1e12:.2f} TFLOP/s effective; peak device memory {peak:.2f} GB "
        f"(two chi^8 float32 buffers: {2 * 4 * big ** 8 / 1e9:.2f} GB)")
    if cuda:  # the float32 run's cached blocks would not leave room for float64's
        torch.cuda.empty_cache()
    ref, secs = _timed(lambda: hotrg3d_log_z(a64, big, big_steps), device)
    log(f"  the same in float64: ln z {ref!r}; {secs:.3f} s, {flops / secs / 1e12:.2f} "
        f"TFLOP/s effective; |float32 - float64| {abs(lz_big - ref):.3e} (tol {TOL_F32})")
    _check(f"3D HOTRG chi {big} float32 against float64", abs(lz_big - ref), TOL_F32)


def ising3d_site(beta, device, h=0.0):
    """Cubic Ising site tensor and its sigma impurity, float64 on ``device``."""
    import numpy as np

    ch, sh = math.sqrt(math.cosh(beta)), math.sqrt(math.sinh(beta))
    w = np.array([[ch, sh], [ch, -sh]])
    weight = np.exp(h * np.array([1.0, -1.0]))
    ein = "s,su,sl,sd,sr,sf,sk->uldrfk"
    return tuple(torch.from_numpy(np.einsum(ein, s, w, w, w, w, w, w)).to(device)
                 for s in (weight, weight * np.array([1.0, -1.0])))


def hotrg3d_anchor_path(device, smi, cfg):
    """The JAX test's closed forms in float64, each on the card and the CPU."""
    from contractn_tpu_torch.models import (hotrg3d_ab_log_z, hotrg3d_log_z,
                                            ising3d_internal_energy_ad, ising3d_tensor_smooth)

    chi, steps, ad = cfg["chi"], cfg["steps"], cfg["ad_steps"]
    u_series = -3.0 + 12.0 * math.exp(-9.6) + 60.0 * math.exp(-16.0)  # beta 0.8

    def fd(dev):
        up, dn = (hotrg3d_log_z(ising3d_site(0.8 + d, dev)[0], chi, ad) for d in (1e-4, -1e-4))
        return -(up - dn) / 2e-4

    # (what, flow, closed form, its tolerance, card against CPU held?)  Where
    # a truncation cuts an exactly degenerate multiplet (two decoupled layers,
    # the low-temperature Z2 pairs under AD, the two tied sides of a == b),
    # which vectors are kept is cuSOLVER's or LAPACK's choice: those readings
    # are held to the closed form on both sides and their gap printed
    cases = (
        ("decoupled chains", lambda dev: hotrg3d_log_z(ising3d_tensor_smooth(
            0.0, beta_z=0.7, device=dev), chi, steps), math.log(2.0 * math.cosh(0.7)),
         cfg["chains_tol"], True),
        ("decoupled layers (Onsager), beta 0.2", lambda dev: hotrg3d_log_z(
            ising3d_tensor_smooth(0.2, beta_z=0.0, device=dev), cfg["layers_chi"], steps),
         onsager_log_z(0.2), cfg["layers_tol"], False),
        ("low-temperature series, beta 0.8", lambda dev: hotrg3d_log_z(
            ising3d_site(0.8, dev)[0], chi, steps),
         2.4 + math.exp(-9.6) + 3.0 * math.exp(-16.0), cfg["low_t_tol"], True),
        ("high-temperature series, beta 0.1", lambda dev: hotrg3d_log_z(
            ising3d_site(0.1, dev)[0], cfg["high_t_chi"], steps),
         math.log(2.0) + 3.0 * math.log(math.cosh(0.1)) + 3.0 * math.tanh(0.1) ** 4,
         cfg["high_t_tol"], True),
        ("AD internal energy, beta 0.8", lambda dev: ising3d_internal_energy_ad(
            0.8, chi, ad, device=dev), u_series, cfg["ad_tol"], False),
        ("central differences, beta 0.8", fd, u_series, cfg["fd_tol"], False),
        ("checkerboard a == b against the uniform flow", lambda dev: hotrg3d_ab_log_z(
            *(ising3d_site(0.3, dev, h=0.01)[0],) * 2, chi, cfg["ab_steps"]),
         hotrg3d_log_z(ising3d_site(0.3, torch.device("cpu"), h=0.01)[0], chi,
                       cfg["ab_steps"] + 3), cfg["ab_tol"], False),
    )
    for what, fn, want, tol, held in cases:
        vals, secs = _on((device, torch.device("cpu")), fn)
        diff = abs(vals[device.type] - vals["cpu"])
        for dev, got in vals.items():
            _check(f"3D HOTRG {what} ({dev})", abs(got - want), tol)
        got = vals[device.type]
        log(f"  {what}: {got!r}, closed form {want!r}, |diff| {abs(got - want):.3e} (tol "
            f"{tol}); card {secs[device.type]:.2f} s, CPU {secs['cpu']:.2f} s; |card - CPU| "
            f"{diff:.3e} " + (f"(tol {cfg['tol']})" if held else "(degenerate truncation)"))
        if held:
            _check(f"3D HOTRG {what}, card against CPU", diff, cfg["tol"])


def ipeps3d_path(device, smi, cfg):
    """Cubic-lattice iPEPS of the 3D TFIM in both perturbative limits, card
    against CPU."""
    from contractn_tpu_torch.models import ipeps3d_ground_state, tfim_bond_term_3d

    for h in cfg["fields"]:
        pt = -3.0 - h * h / 12.0 if h < 1.0 else -h - 3.0 / (4.0 * h)
        devices = (device,) + ((torch.device("cpu"),) if h in cfg["cpu_fields"] else ())
        vals, secs = _on(devices, lambda dev: ipeps3d_ground_state(
            tfim_bond_term_3d(1.0, h, device=dev), cfg["bond"], cfg["chi"],
            schedule=cfg["schedule"], steps=cfg["steps"])[1])
        e = vals[device.type]
        log(f"  ipeps3d_ground_state TFIM h {h}, D {cfg['bond']}, chi {cfg['chi']}, "
            f"{sum(n for _, n in cfg['schedule'])} sweeps, {cfg['steps']} flow steps: E/site "
            f"{e!r}, perturbation theory {pt!r}, |diff| {abs(e - pt):.3e} (tol {cfg['tol']}); "
            f"card {secs[device.type]:.2f} s ({smi})")
        _check(f"cubic iPEPS h {h} against perturbation theory", abs(e - pt), cfg["tol"])
        if "cpu" in vals:
            diff = abs(e - vals["cpu"])
            log(f"    CPU {secs['cpu']:.2f} s; |card - CPU| {diff:.3e} (tol {TOL_CARD_VS_CPU})")
            _check(f"cubic iPEPS h {h}, card against CPU", diff, TOL_CARD_VS_CPU)


def thermal3d_path(device, smi, cfg):
    """The commuting purification equals the classical 3D Ising model: its
    checkerboard bond correlation against the classical impurity flow (three
    more merges, the seed's), card against CPU."""
    import numpy as np

    from contractn_tpu_torch.models import (hotrg3d_bond_expectation, tfim_bond_term_3d,
                                            thermal3d_bond_expectation, thermal_ipeps3d)

    zz = np.kron(np.diag([1.0, -1.0]), np.diag([1.0, -1.0]))

    def run(dev):
        ga, gb, lams = thermal_ipeps3d(tfim_bond_term_3d(1.0, 0.0, device=dev), cfg["beta"],
                                       cfg["bond"], cfg["n_steps"])
        return thermal3d_bond_expectation(ga, gb, lams, zz, cfg["chi"], steps=cfg["steps"])

    vals, secs = _on((device, torch.device("cpu")), run)
    a, imp = ising3d_site(cfg["beta"], device)
    classical = hotrg3d_bond_expectation(a, imp, imp, cfg["chi"], cfg["steps"] + 3)
    q = vals[device.type]
    log(f"  thermal_ipeps3d commuting ZZ, beta {cfg['beta']}, D {cfg['bond']}, chi "
        f"{cfg['chi']}: <ZZ> {q!r}, classical {classical!r}, |diff| {abs(q - classical):.3e} "
        f"(tol {cfg['tol']}); card {secs[device.type]:.2f} s, CPU {secs['cpu']:.2f} s; "
        f"|card - CPU| {abs(q - vals['cpu']):.3e} (tol {TOL_CARD_VS_CPU})")
    _check("3D thermal <ZZ> against the classical flow", abs(q - classical), cfg["tol"])
    _check("3D thermal <ZZ>, card against CPU", abs(q - vals["cpu"]), TOL_CARD_VS_CPU)


def _sweep_marks(device):
    """Wraps ``krylov.lanczos_ground`` to record the host time (after a
    synchronize) of every root solve: ``ttn_dmrg`` starts each sweep with the
    one Lanczos solve whose start is a matrix.  Returns ``(marks, restore)``."""
    from contractn_tpu_torch.ops import krylov

    real = krylov.lanczos_ground
    marks = []

    def marked(matvec, v0, iters, *args, **kwargs):
        if v0.ndim == 2:
            if device.type == "cuda":
                torch.cuda.synchronize()
            marks.append(time.perf_counter())
        return real(matvec, v0, iters, *args, **kwargs)

    krylov.lanczos_ground = marked
    return marks, lambda: setattr(krylov, "lanczos_ground", real)


def ttn_dmrg_path(device, smi, cfg):
    """TTN-DMRG of the snake-flattened 2D TFIM against the chain DMRG on the
    same MPO, at 4 x 4 and 8 x 8."""
    from contractn_tpu_torch.models import MPS, dmrg, tfim2d_mpo, ttn_dmrg

    for side, sweeps, bond, chain_sweeps, rtol in (
            (4, cfg["sweeps"], cfg["chain_bond"], cfg["chain_sweeps"], cfg["rtol"]),
            (cfg["big_side"], cfg["big_sweeps"], cfg["big_bond"], cfg["big_chain_sweeps"],
             cfg["big_rtol"])):
        mpo = tfim2d_mpo(side, side, h=cfg["h"], device=device)
        marks, restore = _sweep_marks(device)
        try:
            (_, energies), secs = _timed(lambda: ttn_dmrg(
                mpo, cfg["chi"], generator=_gen(device, cfg["seed"]), sweeps=sweeps), device)
            end = time.perf_counter()
        finally:
            restore()
        per_sweep = [b - a for a, b in zip(marks, marks[1:] + [end])]
        n = side * side
        mps0 = MPS.random(n, 2, 16, dtype=torch.float64, generator=_gen(device, cfg["seed"]),
                          device=device)
        (_, e_chain, _), chain_secs = _timed(lambda: dmrg(mpo, mps0, max_bond=bond,
                                                          sweeps=chain_sweeps), device)
        e_chain = float(e_chain)
        rel = abs(energies[-1] - e_chain) / abs(e_chain)
        log(f"  ttn_dmrg {side}x{side} snake TFIM h {cfg['h']}, chi {cfg['chi']}, {sweeps} "
            f"sweeps: {energies[-1]!r} (sweeps {[f'{e:.10f}' for e in energies]}, "
            f"{secs:.2f} s, each sweep {[round(t, 3) for t in per_sweep]} s, {smi}); chain "
            f"dmrg bond {bond}, {chain_sweeps} sweeps: {e_chain!r} ({chain_secs:.2f} s); "
            f"relative {rel:.3e} (tol {rtol})")
        _check(f"ttn_dmrg {side}x{side} against the chain DMRG", rel, rtol)
        if any(b > a + 1e-10 for a, b in zip(energies, energies[1:])):
            raise AssertionError("ttn_dmrg sweep energies rose")


def _dense_tfim(n, h):
    import numpy as np

    x, z = np.array([[0.0, 1.0], [1.0, 0.0]]), np.diag([1.0, -1.0])

    def site(op, i):
        return np.kron(np.kron(np.eye(2 ** i), op), np.eye(2 ** (n - i - 1)))

    return (-sum(site(z, i) @ site(z, i + 1) for i in range(n - 1))
            - h * sum(site(x, i) for i in range(n)))


def ttn_adam_path(device, smi, cfg):
    """ttn_ground_state from one start (drawn on the host): card against CPU
    over the first Adam steps, then the full descent against ED."""
    import numpy as np

    from contractn_tpu_torch.models import tfim_mpo, ttn_ground_state

    def run(dev, steps):
        return ttn_ground_state(tfim_mpo(cfg["n"], h=cfg["h"], device=dev), cfg["chi"],
                                generator=torch.Generator().manual_seed(cfg["seed"]),
                                steps=steps, lr=cfg["lr"])[1].cpu().numpy()

    vals, secs = _on((device, torch.device("cpu")), lambda dev: run(dev, cfg["cpu_steps"]))
    diff = float(np.abs(vals[device.type] - vals["cpu"]).max())
    log(f"  ttn_ground_state n {cfg['n']}, chi {cfg['chi']}, first {cfg['cpu_steps']} Adam "
        f"steps: card {secs[device.type]:.2f} s, CPU {secs['cpu']:.2f} s; max |card - CPU| "
        f"{diff:.3e} (tol {TOL_CARD_VS_CPU})")
    _check("TTN Adam energies, card against CPU", diff, TOL_CARD_VS_CPU)
    energies, secs = _timed(lambda: run(device, cfg["steps"]), device)
    e0 = float(np.linalg.eigvalsh(_dense_tfim(cfg["n"], cfg["h"]))[0])
    err = float(energies[-1]) - e0
    log(f"  the full descent, {cfg['steps']} steps: {float(energies[-1])!r}, ED {e0!r}, above by "
        f"{err:.3e} (the JAX test's window (-1e-9, {cfg['tol']})); {secs:.2f} s, "
        f"{1e3 * secs / cfg['steps']:.2f} ms a step ({smi})")
    if not -1e-9 < err < cfg["tol"]:
        raise AssertionError("TTN Adam ground state outside the JAX test's window")


def ttn_tdvp_path(device, smi, cfg):
    """Real-time TTN-TDVP on the saturated manifold against dense
    exponentiation (exact, global phase included)."""
    import numpy as np

    from contractn_tpu_torch.models import random_ttn, tfim_mpo, ttn_tdvp_evolve, ttn_to_dense

    n, dt, steps = cfg["n"], cfg["dt"], cfg["steps"]
    params = random_ttn(n, 2, cfg["chi"], generator=_gen(device, cfg["seed"]))
    v0 = ttn_to_dense(params).cpu().numpy()
    (params, values), secs = _timed(lambda: ttn_tdvp_evolve(
        tfim_mpo(n, h=cfg["h"], device=device), params, dt, steps), device)
    w, u = np.linalg.eigh(_dense_tfim(n, cfg["h"]))
    want = u @ (np.exp(-1j * w * dt * steps) * (u.conj().T @ v0))
    err = float(np.linalg.norm(ttn_to_dense(params).cpu().numpy() - want))
    log(f"  ttn_tdvp_evolve n {n}, chi {cfg['chi']}, dt {dt}, {steps} real-time steps: "
        f"|psi - exp(-i t H) psi0| {err:.3e} (tol {cfg['tol']}); energy drift "
        f"{abs(values[-1] - values[0]):.3e}; {secs:.2f} s, {secs / steps:.3f} s a step ({smi})")
    _check("TTN-TDVP against dense exponentiation", err, cfg["tol"])


# ---------------------------------------------------------------- phase 14


class PathRuns(dict):
    """``{path: (counts, seconds)}``.  ``runs(name, fn)`` drives one path: every
    launch count zeroed just before it and read just after, host-clock seconds
    ending in a synchronize; returns ``fn()``."""

    def __init__(self, device):
        super().__init__()
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def __call__(self, name, fn):
        reset_counters()
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        self[name] = (read_counters(), time.perf_counter() - t0)
        return out

    def secs(self, name):
        return self[name][1]


def parallel_phase(device, smi, sizes=PARALLEL):
    """Phase 14: the parallel layer in a world of one rank, initialized here
    and destroyed at the end, over NCCL on the card and gloo for the CPU
    rehearsal (the backend follows ``device``); returns ``{path: (counts,
    seconds)}``."""
    import socket

    import torch.distributed as dist

    backend = "nccl" if device.type == "cuda" else "gloo"
    log(f"== 14. the parallel layer, one rank over {backend}")
    t14 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        t_init = time.perf_counter() - t14
        _, t_first = _timed(lambda: dist.all_reduce(torch.zeros(1, device=device)), device)
        log(f"  init_process_group({backend!r}, world size 1): {t_init:.2f} s; the first "
            f"collective (the communicator's set-up): {t_first:.2f} s")
        runs = parallel_paths(device, smi, sizes)
    finally:
        dist.destroy_process_group()
    for path, (counts, secs) in runs.items():
        log(f"  path {path}: {secs:.3f} s ({smi}), launches {counts}")
    log(f"phase 14: {time.perf_counter() - t14:.1f} s")
    return runs


def parallel_paths(device, smi, sizes=PARALLEL):
    """The parallel layer's entry points on meshes whose every axis has size
    1, each against its single-device counterpart; returns ``{path: (counts,
    seconds)}``.  Only the single-device evaluation that the sharded forward
    is held against may launch a hand kernel (#1, once): the sharded paths go
    through the tree product, the scans and the Krylov core, as the JAX
    package's do."""
    from contractn_tpu_torch.parallel import make_mesh

    runs = PathRuns(device)
    meshes = {axes: make_mesh(dict.fromkeys(axes, 1), device=device.type)
              for axes in (("dp", "sp"), ("dp", "sp", "tp"), ("pp",), ("tp",), ("sp",),
                           ("dp",))}
    par_forward_path(device, smi, sizes["forward"], runs, meshes)
    par_train_path(device, smi, sizes["train"], runs, meshes)
    par_born_path(device, smi, sizes["born"], runs, meshes)
    par_dmrg_path(device, smi, sizes["tp_dmrg"], sizes["rs_dmrg"], runs, meshes)
    par_ensemble_path(device, smi, sizes["ensemble"], runs, meshes)
    par_scan_path(device, smi, sizes["scan"], runs, meshes)
    par_cv_path(device, smi, sizes["cv"], runs, meshes)
    for path, (counts, _) in runs.items():
        want = int(path == "forward_reference" and device.type == "cuda")
        if counts["mps_evaluate"] != want or any(  # kernels, not their per-path counts
                v for k, v in counts.items() if k != "mps_evaluate" and "." not in k):
            raise AssertionError(f"path {path}: launches {counts}")
    return dict(runs)


def _max_rel(got, want):
    """max |got - want| / max |want|, in float64 on the host."""
    import numpy as np

    got, want = (np.asarray(t.detach().cpu().double() if isinstance(t, torch.Tensor) else t)
                 for t in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def par_forward_path(device, smi, cfg, runs, meshes):
    """``sharded_mps_forward`` at one rank's share of the flagship, held in
    split format against ``MPS.evaluate`` (#1) on the same inputs."""
    from contractn_tpu_torch.models import MPS
    from contractn_tpu_torch.parallel import sharded_mps_forward

    cores, left, right, x = mps_inputs(cfg, device, torch.float32, seed=cfg["seed"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    amp, lg = runs("sharded_forward", lambda: sharded_mps_forward(
        meshes[("dp", "sp")], cores, left, right, x))
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else 0.0
    ref = runs("forward_reference",
               lambda: _no_grad(lambda: MPS(cores, left, right).evaluate(x)))
    if not (amp.shape == (cfg["batch"],) and bool(torch.isfinite(amp).all()
                                                 and torch.isfinite(lg).all())):
        raise AssertionError("sharded_mps_forward: not finite, or the wrong shape")
    k = cfg["check"]
    compare_split((amp[:k], lg[:k]), (ref[0][:k], ref[1][:k]), TOL_F32,
                  "sharded_mps_forward vs MPS.evaluate (#1)",
                  mps_condition(cores, left, right, x[:k]))
    log(f"  sharded_mps_forward {cfg['n_sites']} sites x d {cfg['phys']} x bond "
        f"{cfg['bond']} x batch {cfg['batch']}, fp32, dp 1 x sp 1: "
        f"{runs.secs('sharded_forward'):.3f} s, peak device memory {peak:.2f} GB; "
        f"MPS.evaluate (#1) {runs.secs('forward_reference'):.3f} s ({smi})")


def par_train_path(device, smi, cfg, runs, meshes):
    """The sharded, tensor-parallel and pipelined SGD steps, 3 steps each on
    the full batch, timed; each also takes one step on the batch's
    well-conditioned samples, held against ``make_train_step``'s.

    The full batch's gradient is dominated by its worst-conditioned samples
    (1/psi), which float32 does not determine (``grad_check``): there two
    float32 implementations that reduce in different orders part by what
    float32 leaves open, and their distance is printed, not held.  On the
    samples with ``TOL_F32 x cond <= 1`` the update is held to
    ``cfg["tol"]`` or ten times the distance of ``make_train_step``'s own
    float32 update from its float64 one there, whichever is larger, measured
    in this run."""
    from contractn_tpu_torch.models import MPS
    from contractn_tpu_torch.parallel import (make_pipeline_train_step,
                                              make_sharded_train_step,
                                              make_tp_train_step, make_train_step)

    n, d, bond, batch, lr = (cfg[k] for k in ("n_sites", "phys", "bond", "batch", "lr"))
    gen = _gen(device, cfg["seed"])
    mps = MPS.random(n, d, bond, generator=gen, device=device)
    x = torch.randn((batch, n, d), generator=gen, device=device)
    y = torch.zeros((batch,), device=device)
    single = make_train_step(lr=lr)
    ref, ref_loss = runs("train_reference", lambda: single(mps, x, y))
    cond = mps_condition(mps.cores, mps.left, mps.right, x)
    keep = torch.nonzero(TOL_F32 * cond <= 1)[:, 0].to(device)
    xk, yk = x[keep], y[keep]
    ref_k, _ = single(mps, xk, yk)
    mps64 = MPS(*(t.double() for t in (mps.cores, mps.left, mps.right)))
    ref64_k, _ = single(mps64, xk.double(), yk.double())

    def update_err(new, want):
        """The update's distance from ``want``'s, relative to its largest
        entry, over cores, left and right together."""
        def update(m):
            return torch.cat([(getattr(m, k).double() - getattr(mps64, k)).reshape(-1)
                              for k in ("cores", "left", "right")])
        return _max_rel(update(new), update(want))

    spread = update_err(ref_k, ref64_k)
    tol = max(cfg["tol"], 10 * spread)
    log(f"  make_train_step {n} x {bond} x {batch} fp32: "
        f"{1e3 * runs.secs('train_reference'):.1f} ms, loss {float(ref_loss):.6g} ({smi}); "
        f"on the {keep.numel()}/{batch} samples with {TOL_F32} x cond <= 1 its update is "
        f"{spread:.2e} (of the largest entry) from the float64 step's, so the tolerance "
        f"there is max({cfg['tol']}, 10 x that) = {tol:.2e}; on the whole batch "
        f"{update_err(ref, single(mps64, x.double(), y.double())[0]):.2e}")
    steps = {"sharded": make_sharded_train_step(meshes[("dp", "sp")], lr=lr),
             "tp": make_tp_train_step(meshes[("dp", "sp", "tp")], lr=lr),
             "pipeline": make_pipeline_train_step(meshes[("pp",)], lr=lr)}
    for name, step in steps.items():
        def train():
            m, out = mps, []
            for _ in range(cfg["steps"]):
                (m, loss), secs = _timed(lambda: step(m, x, y), device)
                out.append((m, float(loss), secs))
            return out
        out = runs(f"train_{name}", train)
        err = update_err(step(mps, xk, yk)[0], ref_k)
        loss_err = abs(out[0][1] - float(ref_loss)) / abs(float(ref_loss))
        log(f"  train_{name} {n} x {bond} x {batch} fp32: steps "
            f"{', '.join(f'{1e3 * s:.1f}' for _, _, s in out)} ms, losses "
            f"{[round(v, 6) for _, v, _ in out]} ({smi}); against make_train_step: first "
            f"loss {loss_err:.2e} (tol {cfg['tol']}), first update "
            f"{update_err(out[0][0], ref):.2e} of its largest entry on the whole batch, "
            f"{err:.2e} on the well-conditioned samples (tol {tol:.2e})")
        if not all(math.isfinite(v) for _, v, _ in out):
            raise AssertionError(f"train_{name}: non-finite loss")
        _check(f"train_{name}: first loss against make_train_step", loss_err, cfg["tol"])
        _check(f"train_{name}: update on the well-conditioned samples", err, tol)


def par_born_path(device, smi, cfg, runs, meshes):
    """``fit_born_machine_sharded`` over dp 1 against the full-batch
    ``fit_born_machine``.  At these widths Adam's trajectory is chaotic: a
    perturbation at the rounding level grows about a thousandfold a step
    (its entries with gradients near ``eps``), and optax's Adam (the sharded
    fit) and torch's (``fit_born_machine``) round apart, so after 10 steps
    even their float64 losses part by about 5e-4.  The float32 run is timed
    and its distance printed; in float64, the first update's parameters and
    the first ``cfg["held"]`` losses (the loss function and the first updates,
    Adam's moments carried) are held to ``cfg["tol"]`` of the largest."""
    from contractn_tpu_torch.models import MPS
    from contractn_tpu_torch.models.born import born_machine, fit_born_machine
    from contractn_tpu_torch.parallel import fit_born_machine_sharded

    nb, bb, batch, steps = (cfg[k] for k in ("n_sites", "bond", "batch", "steps"))
    gen = _gen(device, cfg["seed"])
    model = born_machine(nb, 2, bb, dtype=torch.float32, generator=gen, device=device)
    data = torch.randint(0, 2, (batch, nb), generator=gen, device=device)
    _, want = runs("born_reference", lambda: fit_born_machine(model, data, steps=steps,
                                                              lr=cfg["lr"]))
    _, got = runs("born_sharded", lambda: fit_born_machine_sharded(
        model, data, meshes[("dp",)], steps=steps, lr=cfg["lr"]))
    model64 = MPS(*(t.double() for t in (model.cores, model.left, model.right)))
    held = cfg["held"]
    _, want64 = fit_born_machine(model64, data, steps=held, lr=cfg["lr"])
    _, got64 = fit_born_machine_sharded(model64, data, meshes[("dp",)], steps=held,
                                        lr=cfg["lr"])
    one_want, _ = fit_born_machine(model64, data, steps=1, lr=cfg["lr"])
    one_got, _ = fit_born_machine_sharded(model64, data, meshes[("dp",)], steps=1,
                                          lr=cfg["lr"])

    def update(m):
        return torch.cat([(getattr(m, k) - getattr(model64, k)).reshape(-1)
                          for k in ("cores", "left", "right")])

    err64 = _max_rel(got64, want64)
    err_update = _max_rel(update(one_got), update(one_want))
    log(f"  fit_born_machine_sharded {nb} x {bb} x {batch}, {steps} Adam steps, dp 1: "
        f"{runs.secs('born_sharded'):.3f} s (fit_born_machine "
        f"{runs.secs('born_reference'):.3f} s) fp32 ({smi}); NLL {float(got[0]):.6f} -> "
        f"{float(got[-1]):.6f}; fp32 losses against fit_born_machine's "
        f"{_max_rel(got, want):.2e} of the largest; fp64, losses "
        f"{[round(float(v), 10) for v in got64]}, the first {held} against "
        f"fit_born_machine's {err64:.2e} of the largest, the first update "
        f"{err_update:.2e} of its largest entry (tol {cfg['tol']})")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("fit_born_machine_sharded: non-finite loss")
    _check("sharded Born losses against fit_born_machine, float64", err64, cfg["tol"])
    _check("sharded Born first update against fit_born_machine's, float64", err_update,
           cfg["tol"])


def par_dmrg_path(device, smi, cfg, rs_cfg, runs, meshes):
    """``dmrg_uniform_tp`` on the TFIM chain against ``dmrg_uniform`` and
    ``dmrg_realspace`` against the free fermions, both before and after its
    serial polish; the tp DMRG also at a small size against the CPU."""
    from contractn_tpu_torch.models import MPS, dmrg_uniform, tfim_mpo
    from contractn_tpu_torch.parallel import dmrg_realspace, dmrg_uniform_tp

    n, bond, iters = cfg["n_sites"], cfg["bond"], cfg["iters"]
    mpo = tfim_mpo(n, h=cfg["h"], device=device)
    mps0 = MPS.random(n, 2, bond, dtype=torch.float64, generator=_gen(device, cfg["seed"]),
                      device=device)
    _, e_tp, tr_tp = runs("dmrg_tp", lambda: dmrg_uniform_tp(
        meshes[("tp",)], mpo, mps0, sweeps=cfg["sweeps"], lanczos_iters=iters))
    _, e_ref, tr_ref = runs("dmrg_tp_reference", lambda: dmrg_uniform(
        mpo, mps0, sweeps=cfg["sweeps"], lanczos_iters=iters))
    _, e_rs, es = runs("dmrg_realspace", lambda: dmrg_realspace(
        meshes[("sp",)], mpo, mps0, outer_iters=rs_cfg["outer"], lanczos_iters=iters,
        final_sweeps=rs_cfg["final"]))
    exact = tfim_free_fermion(n, cfg["h"])
    e_tp, e_ref, e_rs = float(e_tp), float(e_ref), float(e_rs)
    err_tp = max(abs(e_tp - e_ref) / abs(e_ref), _max_rel(tr_tp, tr_ref))
    err_rs = abs(e_rs - exact) / abs(exact)
    err_par = abs(float(es[-1]) - exact) / abs(exact)
    log(f"  dmrg_uniform_tp TFIM h {cfg['h']}, {n} sites, bond {bond}, {cfg['sweeps']} "
        f"sweeps, Lanczos {iters}, tp 1: {runs.secs('dmrg_tp'):.2f} s (dmrg_uniform "
        f"{runs.secs('dmrg_tp_reference'):.2f} s) ({smi}); energy {e_tp!r}, against "
        f"dmrg_uniform {err_tp:.2e} (tol {cfg['tol']}), against free fermions "
        f"{abs(e_tp - exact) / abs(exact):.2e}")
    log(f"  dmrg_realspace sp 1, {rs_cfg['outer']} parallel iterations and "
        f"{rs_cfg['final']} polish sweep: {runs.secs('dmrg_realspace'):.2f} s ({smi}); "
        f"energy {e_rs!r} (trace {[round(float(e), 8) for e in es]}), against free "
        f"fermions {err_rs:.2e} (tol {rs_cfg['tol']}), the last parallel iteration's "
        f"{err_par:.2e} (tol {rs_cfg['parallel_tol']}), against dmrg_uniform's "
        f"{cfg['sweeps']} sweeps {(e_rs - e_ref) / abs(e_ref):.2e}")
    _check("dmrg_uniform_tp against dmrg_uniform", err_tp, cfg["tol"])
    _check("dmrg_realspace's parallel iterations against free fermions", err_par,
           rs_cfg["parallel_tol"])
    _check("dmrg_realspace against free fermions", err_rs, rs_cfg["tol"])

    cpu = torch.device("cpu")
    n_c, b_c = cfg["cpu_sites"], cfg["cpu_bond"]
    small = MPS.random(n_c, 2, b_c, dtype=torch.float64, generator=_gen(device, cfg["seed"]),
                       device=device)
    _, e_card, _ = runs("dmrg_tp_small", lambda: dmrg_uniform_tp(
        meshes[("tp",)], tfim_mpo(n_c, h=cfg["h"], device=device), small, sweeps=2,
        lanczos_iters=iters))
    _, e_cpu, _ = dmrg_uniform(tfim_mpo(n_c, h=cfg["h"], device=cpu),
                               MPS(*(t.to(cpu) for t in (small.cores, small.left,
                                                          small.right))),
                               sweeps=2, lanczos_iters=iters)
    err = abs(float(e_card) - float(e_cpu)) / abs(float(e_cpu))
    log(f"  dmrg_uniform_tp at {n_c} sites, bond {b_c} on {device.type} against "
        f"dmrg_uniform on the CPU: {err:.2e} (tol {cfg['tol']})")
    _check("dmrg_uniform_tp against the CPU", err, cfg["tol"])


def par_ensemble_path(device, smi, cfg, runs, meshes):
    """``dmrg_ensemble_sharded`` over dp 1 against ``dmrg_ensemble``."""
    import numpy as np

    from contractn_tpu_torch.models import MPS, dmrg_ensemble, stack_pytrees, tfim_mpo
    from contractn_tpu_torch.parallel import dmrg_ensemble_sharded

    k, n, bond, sweeps = (cfg[key] for key in ("n_members", "n_sites", "bond", "sweeps"))
    hs = np.linspace(cfg["h"][0], cfg["h"][1], k)
    gen = _gen(device, cfg["seed"])
    mpos = stack_pytrees([tfim_mpo(n, h=float(h), device=device) for h in hs])
    mps0s = stack_pytrees([MPS.random(n, 2, bond, dtype=torch.float64, generator=gen,
                                      device=device) for _ in hs])
    _, got, _ = runs("ensemble_sharded", lambda: dmrg_ensemble_sharded(
        meshes[("dp",)], mpos, mps0s, sweeps=sweeps))
    _, want, _ = runs("ensemble_reference", lambda: dmrg_ensemble(mpos, mps0s, sweeps=sweeps))
    err = _max_rel(got, want)
    log(f"  dmrg_ensemble_sharded {k} TFIM chains, {n} sites, bond {bond}, {sweeps} sweep, "
        f"dp 1: {runs.secs('ensemble_sharded'):.2f} s (dmrg_ensemble "
        f"{runs.secs('ensemble_reference'):.2f} s) ({smi}); energies against dmrg_ensemble "
        f"{err:.2e} (tol {cfg['tol']})")
    _check("dmrg_ensemble_sharded against dmrg_ensemble", err, cfg["tol"])


def par_scan_path(device, smi, cfg, runs, meshes):
    """``ipeps_cell_scan_sharded`` over dp 1 against ``ipeps_cell_scan``."""
    import numpy as np

    from contractn_tpu_torch.models import ipeps_cell_scan, tfim_bond_term_2d
    from contractn_tpu_torch.parallel import ipeps_cell_scan_sharded

    hs = np.linspace(*cfg["h"], cfg["n"])
    h2s = torch.stack([tfim_bond_term_2d(1.0, float(h), device=device) for h in hs])
    kw = dict(schedule=cfg["schedule"], iters=cfg["iters"], ops=(np.diag([1.0, -1.0]),))
    got = runs("scan_sharded", lambda: ipeps_cell_scan_sharded(
        meshes[("dp",)], h2s, cfg["bond"], cfg["chi"], **kw))
    want = runs("scan_reference", lambda: ipeps_cell_scan(h2s, cfg["bond"], cfg["chi"], **kw))
    err = max(_max_rel(got[key], want[key]) for key in ("energy", "moments", "a", "b"))
    log(f"  ipeps_cell_scan_sharded {cfg['n']} TFIM fields, D {cfg['bond']}, chi "
        f"{cfg['chi']}, {cfg['schedule']}, {cfg['iters']} CTMRG iterations, dp 1: "
        f"{runs.secs('scan_sharded'):.2f} s (ipeps_cell_scan "
        f"{runs.secs('scan_reference'):.2f} s) ({smi}); energies, moments and sites "
        f"against ipeps_cell_scan {err:.2e} (tol {cfg['tol']})")
    _check("ipeps_cell_scan_sharded against ipeps_cell_scan", err, cfg["tol"])


def par_cv_path(device, smi, cfg, runs, meshes):
    """``cv_greens_function_sharded`` over dp 1 against
    ``cv_greens_function_batched`` on a Heisenberg ground state."""
    import numpy as np

    from contractn_tpu_torch.models import (MPS, cv_greens_function_batched, dmrg,
                                            heisenberg_mpo)
    from contractn_tpu_torch.parallel import cv_greens_function_sharded

    n, bond = cfg["n_sites"], cfg["bond"]
    h = heisenberg_mpo(n, device=device)
    mps0 = MPS.random(n, 2, bond, dtype=torch.float64, generator=_gen(device, cfg["seed"]),
                      device=device)
    (ground, e0, _), secs = _timed(lambda: dmrg(h, mps0, max_bond=bond,
                                                sweeps=cfg["dmrg_sweeps"]), device)
    omegas = np.linspace(*cfg["omegas"], cfg["n_omegas"])
    args = (h, ground, e0, np.diag([0.5, -0.5]), n // 2, omegas, cfg["eta"])
    kw = dict(sweeps=cfg["sweeps"], cg_iters=cfg["cg_iters"])
    got = runs("cv_sharded", lambda: cv_greens_function_sharded(meshes[("dp",)], *args, **kw))
    want = runs("cv_reference", lambda: cv_greens_function_batched(*args, **kw))
    err = _max_rel(got, want)
    log(f"  cv_greens_function_sharded {len(omegas)} frequencies on the {n}-site Heisenberg "
        f"ground state (dmrg bond {bond}, {secs:.2f} s), dp 1: {runs.secs('cv_sharded'):.2f} "
        f"s (cv_greens_function_batched {runs.secs('cv_reference'):.2f} s) ({smi}); against "
        f"the batched grid {err:.2e} (tol {cfg['tol']})")
    _check("cv_greens_function_sharded against the batched grid", err, cfg["tol"])


def phase_times(device):
    """Kernel and plain times at the main-path shapes, with the bound: #2
    under both carries, #3's cluster path at the shapes of
    ``CLUSTER_TIMED``, its streamed path at those of ``STREAMED_TIMED`` and,
    through ``mpo_env_streamed``, at ``CLUSTER_BENCH``."""
    from contractn_tpu_torch.ops import cuda_epilogue, cuda_mpo, cuda_mps

    out = {}
    n, d, bond, batch = (FLAGSHIP[k] for k in ("n_sites", "phys", "bond", "batch"))
    cores, left, right, x = mps_inputs(FLAGSHIP, device, torch.float32, seed=5)
    gemm = batch * n * 2 * d * bond * bond
    elem = batch * n * (2 * d * bond + 3 * bond)  # x-weighted sum, L1 mean, rescale
    in_bytes = 4 * (cores.numel() + x.numel() + 2 * bond)
    out["mps_evaluate"] = (
        cuda_time(lambda: cuda_mps.cuda_mps_evaluate(cores, left, right, x)),
        cuda_time(lambda: cuda_mps.mps_evaluate_plain(cores, left, right, x), reps=5),
        *bound_ms(gemm, elem, in_bytes + 8 * batch),
    )
    lib = cuda_mps.tc_library()
    rows, ld = lib.cn_mps_core_rows(bond), lib.cn_mps_core_ld(bond)
    pad = cuda_time(lambda: torch.nn.functional.pad(cores, (0, ld - bond, 0, rows - bond)))
    log(f"  #1 and #2 wrappers: the (N, d, {rows}, {ld}) layout copy of the cores "
        f"takes {pad:.3f} ms of each call")
    for acc, key in ((torch.float32, "mps_evaluate_epilogue"),
                     (torch.bfloat16, "mps_evaluate_epilogue, bf16 carry")):
        out_bytes = batch * (bond * torch.empty((), dtype=acc).element_size() + 4)
        out[key] = (
            cuda_time(lambda: cuda_epilogue.epilogue_chain(cores, left, x, acc)),
            cuda_time(lambda: cuda_epilogue.epilogue_chain_plain(cores, left, x, acc), reps=5),
            *bound_ms(gemm, elem, in_bytes - 4 * bond + out_bytes),
        )
    out.update(time_streamed_chains(device))
    out["mpo_env"] = time_mpo_env(MPO_BENCH, device, "tensor_core")
    for key, shape in CLUSTER_TIMED.items():
        out[key] = time_mpo_env(shape, device, "cluster")
    for key, shape in STREAMED_TIMED.items():
        out[key] = time_mpo_env(shape, device, "streamed")
    # the streamed path where the cluster path runs, beside it (the plain
    # version's time is the cluster entry's: the same operands)
    ms, _, bms, by = time_mpo_env(CLUSTER_BENCH, device, "streamed", yardstick=True)
    plain = next(out[key][1] for key, shape in CLUSTER_TIMED.items() if shape is CLUSTER_BENCH)
    out["mpo_env_streamed at CLUSTER_BENCH"] = (ms, plain, bms, by)
    for name, (ms, plain, bms, by) in out.items():
        log(f"  {name}: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {bms:.3f} ms ({by})")
    return out


def time_streamed_chains(device, shape=FLAGSHIP_WIDE):
    """#1 and #2 (float32 carry) on their streamed path at ``shape``, with
    the plain version, the bound and, logged beside them,
    ``mps_evaluate_auto``: the loop ``MPS.evaluate(kernel="auto")`` runs
    where it does not take the kernel.  Returns ``{name: (ms, plain_ms,
    bound_ms, bound_by)}`` keyed by ``CHAIN_STREAMED_TIMED``."""
    from contractn_tpu_torch.ops import cuda_epilogue, cuda_mps
    from contractn_tpu_torch.ops.scan import mps_evaluate_auto

    n, d, bond, batch = (shape[k] for k in ("n_sites", "phys", "bond", "batch"))
    cores, left, right, x = mps_inputs(shape, device, torch.float32, seed=5)
    gemm = batch * n * 2 * d * bond * bond
    elem = batch * n * (2 * d * bond + 3 * bond)
    in_bytes = 4 * (cores.numel() + x.numel() + 2 * bond)
    key1, key2 = CHAIN_STREAMED_TIMED
    out = {}
    before = (cuda_mps.cuda_mps_evaluate.launches_by_path["streamed"],
              cuda_epilogue.epilogue_chain.launches_by_path["streamed"])
    out[key1] = (
        cuda_time(lambda: cuda_mps.cuda_mps_evaluate(cores, left, right, x)),
        cuda_time(lambda: cuda_mps.mps_evaluate_plain(cores, left, right, x), reps=5),
        *bound_ms(gemm, elem, in_bytes + 8 * batch),
    )
    out[key2] = (
        cuda_time(lambda: cuda_epilogue.epilogue_chain(cores, left, x, torch.float32)),
        cuda_time(lambda: cuda_epilogue.epilogue_chain_plain(cores, left, x, torch.float32),
                  reps=5),
        *bound_ms(gemm, elem, in_bytes - 4 * bond + batch * (4 * bond + 4)),
    )
    assert (cuda_mps.cuda_mps_evaluate.launches_by_path["streamed"] > before[0]
            and cuda_epilogue.epilogue_chain.launches_by_path["streamed"] > before[1]), (
        "the streamed path did not launch")
    auto = cuda_time(lambda: mps_evaluate_auto(cores, left, right, x), reps=5)
    log(f"  #1 at N={n} d={d} D={bond} B={batch}: streamed path {out[key1][0]:.3f} ms, "
        f"mps_evaluate_auto (the loop kernel='auto' would otherwise run) {auto:.3f} ms")
    return out


def mpo_env_operands(shape, device, dtype):
    """``(cores, env0, entries, wdim)`` for a direct call of kernel #3 at
    ``shape`` (``mpo_inputs`` from seed 6 with a ones boundary)."""
    from contractn_tpu_torch.ops.cuda_mpo import mpo_entries

    mpo, cores, ones = mpo_inputs(shape, device, dtype, seed=6)
    env0 = torch.einsum("w,i,k->wik", mpo.left, ones, ones).reshape(-1, shape["bond"])
    return cores, env0, mpo_entries(mpo), mpo.cores.shape[3]


def time_mpo_env(shape, device, path, yardstick=False):
    """Kernel #3 and its plain version at ``shape``, float32, with the bound;
    the kernel must run on ``path`` (with ``yardstick``, the streamed path
    through ``mpo_env_streamed``, whatever path ``mpo_env`` would take, and
    the plain version is not timed: None)."""
    from contractn_tpu_torch.ops import cuda_mpo

    cores, env0, entries, wdim = mpo_env_operands(shape, device, torch.float32)
    b, n, d, bond = shape["batch"], shape["n_sites"], cores.shape[2], shape["bond"]
    if yardstick:
        before = cuda_mpo.mpo_env_streamed.launches
        ms = cuda_time(lambda: cuda_mpo.mpo_env_streamed(cores, env0, entries, wdim))
        assert cuda_mpo.mpo_env_streamed.launches > before, "the streamed path did not launch"
    else:
        before = cuda_mpo.mpo_env.launches_by_path[path]
        ms = cuda_time(lambda: cuda_mpo.mpo_env(cores, env0, entries, wdim))
        assert cuda_mpo.mpo_env.launches_by_path[path] > before, f"the {path} path did not launch"
    # per sample and site: d*W ket and W bra GEMMs; the mix and the rescale
    gemm_site = 4 * d * wdim * bond ** 3
    elem_site = 2 * len(entries) * bond ** 2 + 3 * wdim * bond ** 2
    return (
        ms,
        None if yardstick else
        cuda_time(lambda: cuda_mpo.mpo_env_plain(cores, env0, entries, wdim), reps=5),
        *bound_ms(b * n * gemm_site, b * n * elem_site,
                  4 * (cores.numel() + env0.numel() + b * (wdim * bond * bond + 1))),
    )


# #1 and #2 on their streamed path in phase 5 and in the kernels line, by name
CHAIN_STREAMED_TIMED = ("mps_evaluate, streamed path, D=256",
                        "mps_evaluate_epilogue, streamed path, D=256")
# --mps-times: (tag, shape, launcher) at which #1 and #2 are timed on one
# checkout, float32: the flagship, on the tensor-core path and on the
# streamed yardstick; the flagship widened to bond 256, and that bond at
# small batches and at d 16, each beside mps_evaluate_auto (the loop
# MPS.evaluate(kernel="auto") runs where it does not take the kernel).
# Checkouts before the streamed chain path refuse bond 256 and have no
# yardstick.
WIDE_SMALL_BATCH = tuple({**FLAGSHIP_WIDE, "batch": b} for b in (16, 64, 256))
WIDE_D16 = tuple({"n_sites": 100, "phys": 16, "bond": 256, "batch": b} for b in (16, 4096))
MPS_TIMED = (
    ("flagship", FLAGSHIP, "cuda_mps_evaluate"),
    ("flagship", FLAGSHIP, "epilogue_chain"),
    ("flagship_yardstick", FLAGSHIP, "mps_chain_streamed"),
    ("flagship_wide", FLAGSHIP_WIDE, "cuda_mps_evaluate"),
    ("flagship_wide", FLAGSHIP_WIDE, "epilogue_chain"),
    ("flagship_wide", FLAGSHIP_WIDE, "mps_evaluate_auto"),
    *((f"wide_{tag}{s['batch']}", s, launcher)
      for tag, shapes in (("b", WIDE_SMALL_BATCH), ("d16_b", WIDE_D16)) for s in shapes
      for launcher in ("cuda_mps_evaluate", "mps_evaluate_auto")),
)
# #3's cluster path in phase 5 and in the kernels line, by name
CLUSTER_TIMED = {"mpo_env, cluster path, d=2 W=7 D=50": EXACT_BENCH,
                 "mpo_env, cluster path, Heisenberg D=128": CLUSTER_BENCH}
# #3's streamed path in phase 5 and in the kernels line, by name
STREAMED_TIMED = {"mpo_env, streamed path, AKLT D=64": STREAMED_BENCH,
                  "mpo_env, streamed path, Heisenberg D=256": STREAMED_WIDE}
# --mpo-times: (tag, shape, dtype, launcher) at which #3 is timed on one
# checkout; "mpo_env_streamed" times the streamed path where the library
# picks another
MPO_TIMED = (
    ("exact_bench", EXACT_BENCH, torch.float32, "mpo_env"),
    *(("exact_mpo", s, dt, "mpo_env") for s in EXACT_MPO
      for dt in (torch.float32, torch.bfloat16)),
    ("cluster_bench", CLUSTER_BENCH, torch.float32, "mpo_env"),
    ("mpo_bench", MPO_BENCH, torch.float32, "mpo_env"),
    ("streamed_bench", STREAMED_BENCH, torch.float32, "mpo_env"),
    ("streamed_wide", STREAMED_WIDE, torch.float32, "mpo_env"),
    ("streamed_at_cluster_bench", CLUSTER_BENCH, torch.float32, "mpo_env_streamed"),
)


def mpo_times(smi, root, tags=()):
    """Kernel #3 of the checkout ``root`` at each shape of ``MPO_TIMED`` (or
    those whose tag is in ``tags``; CUDA events, median of 7 after a warm-up
    that also builds it), logged
    as one JSON line each with the path that launched, the card and the
    versions, after a digest of the shapes its on-chip paths take.  The
    inputs are this script's, so two checkouts see the same cores."""
    import hashlib

    from contractn_tpu_torch.ops import cuda_mpo

    if not Path(cuda_mpo.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {cuda_mpo.__file__}, not the package in {root}")
    device = torch.device("cuda", 0)
    # which shapes the on-chip paths take (d*W <= 16, D <= 128, both dtypes):
    # two checkouts with equal digests assign every such shape alike
    lib = cuda_mpo.library()
    on_chip = [(bf16, d, w, bond, path) for bf16 in (0, 1) for d in range(1, 17)
               for w in range(1, 16 // d + 1) for bond in range(1, 129)
               if (path := lib.cn_mpo_env_path(bf16, d, bond, w)) in (1, 2)]
    log(json.dumps({"on_chip_shapes": len(on_chip),
                    "digest": hashlib.sha256(repr(on_chip).encode()).hexdigest()[:16],
                    "root": root.name}))
    for tag, shape, dtype, launcher in MPO_TIMED:
        if tags and tag not in tags:
            continue
        cores, env0, entries, wdim = mpo_env_operands(shape, device, dtype)
        before = dict(cuda_mpo.mpo_env.launches_by_path)
        ms = cuda_time(lambda: getattr(cuda_mpo, launcher)(cores, env0, entries, wdim))
        path = ([p for p, k in cuda_mpo.mpo_env.launches_by_path.items() if k > before[p]]
                if launcher == "mpo_env" else [launcher])
        log(json.dumps({
            "shape": tag, "d": cores.shape[2], "W": wdim, "D": shape["bond"],
            "n_sites": shape["n_sites"], "batch": shape["batch"],
            "dtype": str(dtype).replace("torch.", ""), "path": path, "ms": ms,
            "root": root.name, "card": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}))
        del cores

def mps_times(smi, root, tags=()):
    """Kernels #1 and #2 of the checkout ``root`` at each shape of
    ``MPS_TIMED`` (or those whose tag is in ``tags``; CUDA events, median of
    7 after a warm-up that also builds them), logged as one JSON line each
    with the path that launched, or the checkout's refusal, after a digest
    of the shapes its tensor-core path takes (d 1-64, D 1-520, both
    dtypes).  The inputs are this script's, so two checkouts see the same
    cores."""
    import hashlib

    from contractn_tpu_torch.ops import cuda_epilogue, cuda_mps
    from contractn_tpu_torch.ops.scan import mps_evaluate_auto

    if not Path(cuda_mps.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {cuda_mps.__file__}, not the package in {root}")
    device = torch.device("cuda", 0)
    lib = cuda_mps.tc_library()
    tensor_core = [(bf16, d, bond) for bf16 in (0, 1) for d in range(1, 65)
                   for bond in range(1, 521) if lib.cn_mps_evaluate_smem(bf16, d, bond) >= 0]
    log(json.dumps({"tensor_core_shapes": len(tensor_core),
                    "digest": hashlib.sha256(repr(tensor_core).encode()).hexdigest()[:16],
                    "root": root.name}))
    closing = {"cuda_mps_evaluate": cuda_mps.cuda_mps_evaluate,
               "mps_chain_streamed": getattr(cuda_mps, "mps_chain_streamed", None),
               "mps_evaluate_auto": mps_evaluate_auto}
    for tag, shape, launcher in MPS_TIMED:
        if tags and tag not in tags:
            continue
        cores, left, right, x = mps_inputs(shape, device, torch.float32, seed=5)
        fn = closing.get(launcher, cuda_epilogue.epilogue_chain)
        call = ((lambda: fn(cores, left, right, x)) if launcher in closing
                else (lambda: fn(cores, left, x, torch.float32)))
        by_path = getattr(fn, "launches_by_path", None)
        before = dict(by_path or {})
        record = {"shape": tag, "launcher": launcher, "d": shape["phys"], "D": shape["bond"],
                  "n_sites": shape["n_sites"], "batch": shape["batch"], "dtype": "float32"}
        try:
            if fn is None:
                raise ValueError(f"this checkout has no {launcher}")
            record["ms"] = cuda_time(call)
            record["path"] = ([p for p, k in by_path.items() if k > before[p]]
                              if by_path is not None else launcher)
        except (ValueError, RuntimeError) as err:
            record["refused"] = str(err)
        log(json.dumps({**record, "root": root.name, "card": smi, "torch": torch.__version__,
                        "cuda": torch.version.cuda}))
        del cores, x


SOURCES = {
    "mps_evaluate": ("contractn_tpu_torch/csrc/mps_chain_tc.cu",
                     "contractn_tpu/ops/pallas_mps.py:152"),
    "mps_evaluate_epilogue": ("contractn_tpu_torch/csrc/mps_chain_tc.cu",
                              "contractn_tpu/ops/pallas_epilogue.py:128"),
    "mpo_env": ("contractn_tpu_torch/csrc/mpo_env.cu",
                "contractn_tpu/ops/pallas_mpo.py:134"),
}
PATH_OF = {"mps_evaluate": "mps_evaluate",
           "mps_evaluate_epilogue": "mps_evaluate_epilogue",
           "mpo_env": "mpo_expectation"}


def physics_phase(device, smi):
    log("== 9. physics chains")
    t9 = time.perf_counter()
    for path, (counts, secs) in physics_chains(device, smi).items():
        log(f"  path {path}: {secs:.3f} s ({smi}), launches {counts}")
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")


def infinite_phase(device, smi):
    log("== 10. infinite chains and chemistry")
    t10 = time.perf_counter()
    for path, (counts, secs) in infinite_chains(device, smi).items():
        log(f"  path {path}: {secs:.3f} s ({smi}), launches {counts}")
    log(f"phase 10: {time.perf_counter() - t10:.1f} s")


def two_d_phase(device, smi):
    log("== 11. 2D and finite temperature")
    t11 = time.perf_counter()
    for path, (counts, secs) in two_d_paths(device, smi).items():
        log(f"  path {path}: {secs:.3f} s ({smi}), launches {counts}")
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")


def peps_phase(device, smi):
    log("== 12. unit cells, iPEPS optimizers, fermionic PEPS, PEPS sampling")
    t12 = time.perf_counter()
    for path, (counts, secs) in peps2d_paths(device, smi).items():
        log(f"  path {path}: {secs:.3f} s ({smi}), launches {counts}")
    log(f"phase 12: {time.perf_counter() - t12:.1f} s")


def three_d_phase(device, smi):
    log("== 13. the 3D family and tree tensor networks")
    t13 = time.perf_counter()
    for path, (counts, secs) in three_d_ttn_paths(device, smi).items():
        log(f"  path {path}: {secs:.3f} s ({smi}), launches {counts}")
    log(f"phase 13: {time.perf_counter() - t13:.1f} s")


# Seconds an example script may take on the card, and how many run at once:
# the longest (renormalization's 14,000 MERA sweeps, hubbard_ipeps's 730
# gradient steps) take about 20 minutes each, one after another all 20 take
# longer than one call to the card may last, and each is bound by its own
# host thread, so four share the card's machine.
EXAMPLE_TIMEOUT = 2400
EXAMPLE_LANES = 4


def examples_phase(device, smi, names=()):
    """Every ``examples/torch/*.py`` (or those named) in its own process on
    ``device``, ``EXAMPLE_LANES`` at a time, each with ``EXAMPLE_TIMEOUT``:
    its seconds (while the others run) and last printed line are logged, its
    whole output written to ``build/examples/<name>.log``; raises if
    any script fails or runs out of time."""
    import os

    log(f"== examples: each examples/torch script in its own process, "
        f"{EXAMPLE_LANES} at a time")
    scripts = sorted((ROOT / "examples" / "torch").glob("*.py"))
    if names:
        scripts = [p for p in scripts if p.stem in names]
        if len(scripts) != len(set(names)):
            raise AssertionError(f"unknown example among {sorted(names)}")
    out_dir = ROOT / "build" / "examples"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, (str(ROOT), os.environ.get("PYTHONPATH"))))}

    def run(script):
        path = out_dir / f"{script.stem}.log"
        t0 = time.perf_counter()
        with open(path, "w") as out:
            try:
                rc = subprocess.run([sys.executable, str(script), "--device", device.type],
                                    cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
                                    timeout=EXAMPLE_TIMEOUT).returncode
                status = f"exit {rc}"
            except subprocess.TimeoutExpired:  # run() has killed it
                status = f"timed out after {EXAMPLE_TIMEOUT} s"
        secs = time.perf_counter() - t0
        lines = [line for line in path.read_text().splitlines() if line.strip()]
        log(f"  {script.name}: {secs:.1f} s, {status} ({smi}); last line: "
            f"{lines[-1].strip() if lines else '(none)'}")
        if status != "exit 0":
            log("    " + "\n    ".join(lines[-6:]))
            return script.name
        return None

    t_all = time.perf_counter()
    with ThreadPoolExecutor(EXAMPLE_LANES) as pool:
        failed = [name for name in pool.map(run, scripts) if name]
    log(f"examples: {len(scripts)} scripts in {time.perf_counter() - t_all:.1f} s")
    if failed:
        raise AssertionError(f"examples failed: {failed}")


def log_phase(n, t0, header):
    """Log phase ``n``'s seconds since ``t0`` and the next phase's header;
    returns the next phase's start."""
    log(f"phase {n}: {time.perf_counter() - t0:.1f} s")
    log(f"== {header}")
    return time.perf_counter()


def main():
    if not (ROOT / "contractn_tpu_torch" / "__init__.py").is_file():
        fail(f"no contractn_tpu_torch package beside {Path(__file__).name}; "
             "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    log("== 1. device")
    smi, card = phase_device()
    device = torch.device("cuda", 0)
    if len(sys.argv) >= 2 and sys.argv[1] in ("--mpo-times", "--mps-times"):
        root = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else ROOT
        sys.path.insert(0, str(root))
        (mpo_times if sys.argv[1] == "--mpo-times" else mps_times)(smi, root, sys.argv[3:])
        return
    log("== 2. build")
    phase_build()
    kernel_smem(device)
    only = {"--physics-only": physics_phase, "--infinite-only": infinite_phase,
            "--2d-only": two_d_phase, "--peps-only": peps_phase, "--3d-only": three_d_phase,
            "--parallel-only": parallel_phase}
    if len(sys.argv) == 2 and sys.argv[1] in only:  # phases 1, 2 and one more alone
        only[sys.argv[1]](device, smi)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return
    if len(sys.argv) >= 2 and sys.argv[1] == "--examples-only":
        examples_phase(device, smi, sys.argv[2:])
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
        return
    log("== 3. kernels against their plain versions")
    t3 = time.perf_counter()
    errors = phase_kernels_vs_plain(device)
    t4 = log_phase(3, t3, "4. main path")
    runs = main_path(device)
    runs.update(cluster_main_path(device))
    runs.update(streamed_main_path(device))
    runs.update(streamed_chain_main_path(device))
    for path, (counts, secs) in runs.items():
        log(f"  path {path}: {secs:.3f} s, launches {counts}")
    for kernel, path in PATH_OF.items():
        counts = runs[path][0]
        if counts[kernel] < 1:
            raise AssertionError(f"the {path} path never launched kernel {kernel}")
    for path, kernel in (("mps_evaluate", "mps_evaluate"),
                         ("mps_evaluate_epilogue", "mps_evaluate_epilogue")):
        if runs[path][0][f"{kernel}.tensor_core"] < 1:
            raise AssertionError(f"the flagship {path} path did not run the tensor-core path")
        wide = runs[f"{path}_streamed"][0]
        if (wide[f"{kernel}.streamed"], wide[f"{kernel}.tensor_core"]) != (1, 0):
            raise AssertionError(f"the bond-256 {path} path did not run the streamed path "
                                 f"alone, once: {wide}")
    if runs["mpo_expectation"][0]["mpo_env.tensor_core"] < 1:
        raise AssertionError("the MPO main path did not run #3's tensor-core path")
    if runs["mpo_expectation_cluster"][0]["mpo_env.cluster"] < 1:
        raise AssertionError("the bond-128 MPO path did not run #3's cluster path")
    streamed = runs["mpo_expectation_streamed"][0]
    if (streamed["mpo_env.streamed"], streamed["mpo_env.tensor_core"],
            streamed["mpo_env.cluster"]) != (1, 0, 0):
        raise AssertionError(f"the AKLT MPO path did not run #3's streamed path alone: {streamed}")
    t5 = log_phase(4, t4, "5. times")
    times = phase_times(device)
    kernels = []
    # (name, kernel, the run and the counter that hold its launches)
    entries = [(kernel, kernel, PATH_OF[kernel], kernel) for kernel in SOURCES
               if kernel != "mpo_env"]
    entries += [(key, kernel, f"{kernel}_streamed", f"{kernel}.streamed")
                for key, kernel in zip(CHAIN_STREAMED_TIMED,
                                       ("mps_evaluate", "mps_evaluate_epilogue"))]
    entries.append(("mpo_env", "mpo_env", "mpo_expectation", "mpo_env.tensor_core"))
    entries += [(key, "mpo_env", "mpo_expectation_cluster", "mpo_env.cluster")
                for key in CLUSTER_TIMED]
    entries += [(key, "mpo_env", "mpo_expectation_streamed", "mpo_env.streamed")
                for key in STREAMED_TIMED]
    for name, kernel, path, counter in entries:
        source, replaces = SOURCES[kernel]
        ms, plain, bms, by = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": runs[path][0][counter],
            "max_abs_err": errors[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
        })
    t6 = log_phase(5, t5, "6. training paths")
    for path, (counts, secs) in training_paths(device, smi).items():
        log(f"  path {path}: {secs:.3f} s, launches {counts}")
    t7 = log_phase(6, t6, "7. graph paths")
    for path, (counts, secs) in graph_paths(device, smi).items():
        log(f"  path {path}: {secs:.3f} s ({smi}), launches {counts}")
    t8 = log_phase(7, t7, "8. finite chains")
    for path, (counts, secs) in finite_chains(device, smi).items():
        log(f"  path {path}: {secs:.3f} s ({smi}), launches {counts}")
    log(f"phase 8: {time.perf_counter() - t8:.1f} s")
    physics_phase(device, smi)
    infinite_phase(device, smi)
    two_d_phase(device, smi)
    peps_phase(device, smi)
    three_d_phase(device, smi)
    parallel_phase(device, smi)
    log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
