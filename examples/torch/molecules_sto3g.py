"""Real molecules beyond hydrogen: LiH and H2O with p orbitals.

The McMurchie-Davidson integral engine
(:mod:`contractn_tpu_torch.models.gaussians`) opens the second row: contracted
Cartesian Gaussians of any angular momentum, STO-3G shells through
fluorine, frozen-core reduction, and one-electron properties.  This
example runs the full pipeline on two textbook molecules:

* **LiH** — RHF, then frozen-core DMRG on the 10-spin-orbital active
  chain, against the independent determinant FCI (machine precision)
  and the published total energies (RHF -7.8620, FCI -7.8824 Ha).
* **H2O** at the experimental geometry — RHF total -74.963 Ha (the
  published STO-3G value), the SCF dipole 1.73 D, and frozen-core DMRG
  == FCI on the 12-site active space.

Run with: ``python3 examples/torch/molecules_sto3g.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models import chemistry as chem
from contractn_tpu_torch.models import gaussians as g

DEBYE = 2.541746  # e*a0 -> debye


def lih(device):
    print("LiH / STO-3G at R = 3.015 a0")
    xyz = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 3.015]])
    basis, charges = g.sto3g_shell_basis(["Li", "H"], xyz)
    s, hcore, eri, e_nuc = g.molecular_integrals_general(
        basis, charges, xyz
    )
    e_hf, c, _ = chem.restricted_hartree_fock(s, hcore, eri, 4)
    print(f"  RHF total  {e_hf + e_nuc:12.6f}  (published -7.8620)")
    h1, g2 = chem.mo_transform(hcore, eri, c)
    e_fci = chem.fci_ground(h1, g2, n_elec=4)
    print(f"  FCI total  {e_fci + e_nuc:12.6f}  (published -7.8824)")
    h1a, ga, e_core = g.freeze_core(h1, g2, 1)
    e_dmrg, mps, _ = chem.chemistry_dmrg(h1a, ga, 2, max_bond=16,
                                         sweeps=5, device=device)
    print(f"  frozen-core DMRG total {e_dmrg + e_core + e_nuc:12.6f}  "
          f"(|DMRG - FCI(active)| = "
          f"{abs(e_dmrg - chem.fci_ground(h1a, ga, n_elec=2)):.2e})")
    occ = c[:, :2]
    mu = g.dipole_moment(basis, charges, xyz, 2.0 * occ @ occ.T)
    print(f"  RHF dipole {np.linalg.norm(mu) * DEBYE:6.3f} D")


def water(device):
    print("\nH2O / STO-3G at the experimental geometry")
    half = np.deg2rad(104.52) / 2.0
    r = 0.9572 / 0.52917721067
    xyz = np.array(
        [
            [0.0, 0.0, 0.0],
            [r * np.sin(half), 0.0, r * np.cos(half)],
            [-r * np.sin(half), 0.0, r * np.cos(half)],
        ]
    )
    basis, charges = g.sto3g_shell_basis(["O", "H", "H"], xyz)
    s, hcore, eri, e_nuc = g.molecular_integrals_general(
        basis, charges, xyz
    )
    e_hf, c, _ = chem.restricted_hartree_fock(s, hcore, eri, 10)
    print(f"  RHF total  {e_hf + e_nuc:12.6f}  (published -74.9630)")
    occ = c[:, :5]
    mu = g.dipole_moment(basis, charges, xyz, 2.0 * occ @ occ.T)
    print(f"  RHF dipole {np.linalg.norm(mu) * DEBYE:6.3f} D "
          f"(published STO-3G ~1.73, experiment 1.85)")
    h1, g2 = chem.mo_transform(hcore, eri, c)
    h1a, ga, e_core = g.freeze_core(h1, g2, 1)
    e_fci = chem.fci_ground(h1a, ga, n_elec=8)
    print(f"  frozen-core FCI total  {e_fci + e_core + e_nuc:12.6f}")
    e_dmrg, _, _ = chem.chemistry_dmrg(h1a, ga, 8, max_bond=24,
                                       sweeps=5, device=device)
    print(f"  frozen-core DMRG total {e_dmrg + e_core + e_nuc:12.6f}  "
          f"(|DMRG - FCI| = {abs(e_dmrg - e_fci):.2e})")


def lithium_radical(device):
    print("\nLi atom (doublet) / STO-3G — open-shell pipeline")
    xyz = np.zeros((1, 3))
    basis, charges = g.sto3g_shell_basis(["Li"], xyz)
    s, hcore, eri, _ = g.molecular_integrals_general(basis, charges, xyz)
    e_u, (ca, cb), _ = chem.unrestricted_hartree_fock(s, hcore, eri, 2, 1)
    print(f"  UHF        {e_u:12.6f}  (published -7.315526)")
    c_no, occs = chem.uhf_natural_orbitals(s, ca, cb, 2, 1)
    print(f"  UNO occupations {np.round(occs, 6)}")
    h1, g2 = chem.mo_transform(hcore, eri, c_no)
    e_fci = chem.fci_ground(h1, g2, n_elec=3)
    e_dmrg, _, _ = chem.chemistry_dmrg(h1, g2, 3, max_bond=12, sweeps=4,
                                       device=device)
    print(f"  FCI        {e_fci:12.6f}")
    print(f"  DMRG       {e_dmrg:12.6f}  "
          f"(|DMRG - FCI| = {abs(e_dmrg - e_fci):.2e})")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    dev = torch.device(parser.parse_args().device)
    lih(dev)
    water(dev)
    lithium_radical(dev)
