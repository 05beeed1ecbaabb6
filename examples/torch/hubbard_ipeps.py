"""The 2D Hubbard model in the thermodynamic limit: spinful fermionic
iPEPS by gradient descent through the fermionized cell CTMRG, on the
PyTorch port.

1. The exact U=0 anchor: with same-spin p-wave pairing the spinful
   model is two decoupled spinless BdG copies.  At the graded product
   bond (0, 1, 1, 0) (D=4) the gradient ground state reaches the exact
   two-copy k-space integral to ~0.1%, with equal spin densities and
   Wick-factorized double occupancy (the JAX package's recorded run: relerr 0.0014,
   n_up = n_dn = 0.0601, docc = 0.00359 vs n_up * n_dn = 0.00361).
2. An interacting run: switching on U > 0 from the U=0 optimum lowers
   the double occupancy and raises the energy by less than U * docc
   (the optimizer beats the rigid U=0 state).
3. The half-filled 2D Hubbard antiferromagnet (U=8, mu=U/2) on the
   checkerboard cell: staggered AFM order with a genuine superexchange
   energy gain (the JAX package's recorded 500-step run at D=2, chi=12:
   E + U/2 = -0.347 per site, staggered n_up 0.905/0.100, docc 0.044;
   the rigid Neel-dimer configuration sits at ~0 — D=2 captures about
   60% of the Heisenberg-limit estimate 2J(e_b - 1/4) ~ -0.58 at
   J = 4t^2/U, larger D closes the rest).

Run with: ``python3 examples/torch/hubbard_ipeps.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models import (
    hubbard_ipeps_energy,
    hubbard_ipeps_ground_state,
    hubbard_u0_energy,
)
from contractn_tpu_torch.models.fipeps_spin import (
    SZ,
    hubbard_cell_correlator,
    hubbard_cell_env,
    hubbard_cell_ground_state,
)


def main(device="cuda"):
    t, mu, delta = 1.0, -4.4, 1.0
    bp = (0, 1, 1, 0)  # graded product of two (0, 1) species bonds

    # -- 1. exact U=0 anchor: two decoupled spinless BdG copies ------- #
    want = hubbard_u0_energy(t=t, mu=mu, delta=delta)
    a0, e0, obs0, _ = hubbard_ipeps_ground_state(
        bond_parities=bp, chi=16, t=t, u=0.0, mu=mu, delta=delta,
        steps=150, lr=2e-2, seed=0, device=device)
    print(f"U=0:  E = {e0:+.6f}  exact 2x BdG = {want:+.6f}  "
          f"relerr = {abs(e0 - want) / abs(want):.2e}")
    print(f"      n_up = {obs0['n_up']:.4f}  n_dn = {obs0['n_dn']:.4f}  "
          f"docc = {obs0['docc']:.5f}  "
          f"(Wick: n_up*n_dn = {obs0['n_up'] * obs0['n_dn']:.5f})")

    # -- 2. interacting: warm-start from the U=0 optimum -------------- #
    u = 4.0
    a1, e1, obs1, _ = hubbard_ipeps_ground_state(
        bond_parities=bp, chi=16, t=t, u=u, mu=mu, delta=delta,
        steps=80, lr=1e-2, seed=0, init=a0, device=device)
    bp_arr = (np.asarray(bp),) * 4
    e_rigid, _ = hubbard_ipeps_energy(
        a0, bp_arr, chi=16, t=t, u=u, mu=mu, delta=delta)
    print(f"U={u}: E = {e1:+.6f}  rigid U=0 state = {e_rigid:+.6f}  "
          f"docc {obs0['docc']:.5f} -> {obs1['docc']:.5f}")
    assert e1 <= e_rigid + 1e-6  # optimizer beats the rigid state
    assert obs1["docc"] < obs0["docc"]  # U suppresses double occupancy

    # -- 3. half-filled AFM on the checkerboard cell ------------------ #
    u = 8.0
    a2, b2, e2, obs2, _ = hubbard_cell_ground_state(
        bond_parities=(0, 1), chi=12, t=1.0, u=u, steps=500, lr=1e-2,
        seed=0, device=device)
    stag = obs2["n_up"][0][0] - obs2["n_up"][1][0]
    print(f"AFM U={u}: E + U/2 = {e2 + u / 2:+.4f}  "
          f"staggered n_up = {obs2['n_up'][0][0]:.3f}/"
          f"{obs2['n_up'][1][0]:.3f}  docc = {obs2['docc'][0][0]:.4f}")
    assert e2 + u / 2 < -0.25  # genuine superexchange gain
    assert stag > 0.5  # AFM order

    # staggered spin-spin correlations along a row of the AFM state
    bp_arr2 = (np.asarray((0, 1)),) * 4
    sites = ((a2, b2), (b2, a2))
    env2 = hubbard_cell_env(sites, bp_arr2, chi=12)
    sc = hubbard_cell_correlator(sites, bp_arr2, env2, SZ, SZ,
                                 [1, 2, 3, 4])
    print("<Sz_0 Sz_r> connected:",
          " ".join(f"{v:+.4f}" for v in sc))
    assert sc[0] < 0 < sc[1]  # staggered AFM sign pattern


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
