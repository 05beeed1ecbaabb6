"""Three-dimensional tensor networks, end to end, on the PyTorch port.

One script, three workloads on the cubic lattice — the hardest setting
for tensor-network contraction (no exactly contractible structure):

1. CLASSICAL: 3D Ising free energy, autodiff internal energy, and the
   order parameter across the genuine 3D transition (beta_c ~ 0.2216),
   via 3D HOTRG (split-format log Z carry).
2. QUANTUM T = 0: the 3D transverse-field Ising model's ground state
   by cubic-lattice iPEPS simple update, measured by contracting the
   D^2 double layer with the SAME 3D HOTRG impurity flows.
3. QUANTUM T > 0: purification iPEPS with bipartite six-bond-class
   Trotter sweeps, measured through the checkerboard HOTRG — in the
   commuting limit the quantum <ZZ> must land exactly on the classical
   bond correlation computed in part 1's framework.

Run with: ``python3 examples/torch/three_dimensions.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models import (
    hotrg3d_bond_expectation,
    hotrg3d_expectation,
    hotrg3d_log_z,
    ipeps3d_ground_state,
    ising3d_internal_energy_ad,
    tfim_bond_term_3d,
    thermal3d_bond_expectation,
    thermal_ipeps3d,
)

X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.diag([1.0, -1.0])


def ising3d(beta, h=0.0, device="cuda"):
    ch, sh = np.sqrt(np.cosh(beta)), np.sqrt(np.sinh(beta))
    w = np.array([[ch, sh], [ch, -sh]])
    weight = np.exp(h * np.array([1.0, -1.0]))
    a = np.einsum("s,su,sl,sd,sr,sf,sk->uldrfk", weight, w, w, w, w,
                  w, w)
    imp = np.einsum("s,su,sl,sd,sr,sf,sk->uldrfk",
                    weight * np.array([1.0, -1.0]), w, w, w, w, w, w)
    return torch.as_tensor(a, device=device), torch.as_tensor(imp, device=device)


def main(device="cuda"):
    print("== 1. classical 3D Ising (HOTRG, chi=4) ==")
    for beta in (0.15, 0.2216, 0.3):
        a, imp = ising3d(beta, h=0.005, device=device)
        lz = hotrg3d_log_z(a, chi=4, steps=22)
        m = hotrg3d_expectation(a, imp, chi=4, steps=22)
        u = ising3d_internal_energy_ad(beta, chi=4, steps=18, device=device)
        print(f"  beta={beta:6.4f}  ln z = {lz:+.6f}   u = {u:+.4f}   "
              f"m = {m:+.4f}")
    print("  (order parameter switches on across beta_c ~ 0.2216)")

    print("== 2. 3D TFIM ground states (iPEPS D=2 + HOTRG environment) ==")
    for h, ref, tag in ((0.5, -3.0 - 0.5**2 / 12.0, "PT: -3 - h^2/12"),
                        (8.0, -8.0 - 3.0 / 32.0, "PT: -h - 3/(4h)")):
        _, e = ipeps3d_ground_state(tfim_bond_term_3d(1.0, h, device=device),
                                    bond_dim=2, chi=6, steps=20)
        print(f"  h={h:4.1f}  E/site = {float(e):+.5f}   ({tag} = {ref:+.5f})")

    print("== 3. finite temperature (purification + checkerboard HOTRG) ==")
    beta = 0.2
    h2 = tfim_bond_term_3d(1.0, 0.0, device=device)  # commuting limit: exact cross-check
    ga, gb, lams = thermal_ipeps3d(h2, beta, bond_dim=2, n_steps=3)
    q_zz = float(thermal3d_bond_expectation(ga, gb, lams, np.kron(Z, Z), chi=6,
                                            steps=20))
    a_cl, imp = ising3d(beta, device=device)
    c_zz = float(hotrg3d_bond_expectation(a_cl, imp, imp, chi=6, steps=20))
    print(f"  beta={beta}: quantum thermal <ZZ> = {q_zz:.10f}")
    print(f"             classical 3D Ising <ss> = {c_zz:.10f}")
    print(f"             |difference| = {abs(q_zz - c_zz):.2e}  "
          "(same network, two code paths)")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
