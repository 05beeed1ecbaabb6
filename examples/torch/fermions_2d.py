"""Two-dimensional fermions, both ways, on the PyTorch port: JW-string
DMRG and fermionic PEPS.

1. A 4x4 BdG lattice solved by DMRG on the snake-Jordan-Wigner string
   MPO, against the exact Bogoliubov ground energy.
2. A fermionic PEPS ground state on 2x3 by gradient descent through the
   swap-gate boundary contraction, plus a long-range correlator.
3. An exact-U(1) sector scan of the XXZ chain with charge-masked cores.

Run with: ``python3 examples/torch/fermions_2d.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models import (
    MPS,
    dmrg_u1,
    dmrg_uniform,
    fermion2d_mpo,
    fpeps_correlator,
    free_fermion_energy_2d,
    xxz_mpo_u1,
)
from contractn_tpu_torch.models.fswap import fpeps_ground_state


def main(device="cuda"):
    # -- 1. 2D BdG lattice through the string-MPO route ---------------- #
    lx, ly, mu, delta = 4, 4, 1.0, 0.4
    mpo = fermion2d_mpo(lx, ly, 1.0, mu, delta, device=device)
    e_exact = free_fermion_energy_2d(lx, ly, 1.0, mu, delta)
    mps0 = MPS.random(lx * ly, 2, 24, dtype=torch.float64,
                      generator=torch.Generator(device).manual_seed(0), device=device)
    _, e, _ = dmrg_uniform(mpo, mps0, sweeps=6, lanczos_iters=30)
    print(f"4x4 BdG: DMRG {float(e):.6f}  exact {e_exact:.6f}  "
          f"(MPO width {mpo.cores.shape[-1]})")

    # -- 2. fermionic PEPS ground state + correlator ------------------- #
    tensors, e_fp, trace = fpeps_ground_state(
        2, 3, t=1.0, mu=1.0, delta=0.6, chi=12, steps=120, lr=3e-2,
        device=device)
    print(f"2x3 fPEPS D=2 ground energy: {float(e_fp):.6f} "
          f"(first/last of trace: {float(trace[0]):.4f} -> {float(trace[-1]):.4f})")
    bp = np.asarray([0, 1])
    phv = {(r, c): bp for r in range(2) for c in range(2)}
    pvv = {(r, c): bp for r in range(1) for c in range(3)}
    corr = fpeps_correlator(tensors, phv, pvv, (0, 0), (1, 2), device=device)
    print(f"  long-range <c+_(0,0) c_(1,2)> = {float(corr):+.6f} "
          "(Jordan-Wigner string across both rows)")

    # -- 3. exact-sector XXZ ------------------------------------------- #
    for q in (0, 2):
        _, e_q, _, _ = dmrg_u1(xxz_mpo_u1(8, device=device), q, bond_dim=16, sweeps=8)
        print(f"XXZ n=8, sector 2Sz={q}: E = {float(e_q):.8f} "
              "(conserved structurally)")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
