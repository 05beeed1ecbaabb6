"""Quantum-chemistry DMRG: the H2 dissociation curve in STO-3G.

The classic failure mode of mean field: restricted Hartree-Fock forces
both electrons into one doubly-occupied orbital, so at dissociation it
mixes spurious ionic configurations and lands ~0.2 Ha above two free H
atoms.  DMRG on the same integrals captures the static correlation and
dissociates exactly to 2 x E(H/STO-3G) = -0.93316 Ha, matching FCI at
every bond length to machine precision.

Everything is in-framework: the s-type Gaussian integral engine, the
SCF, the fermionic AutoMPO compilation (Jordan-Wigner strings handled
by the per-site factor identity), the sector-penalized DMRG, and the
natural-orbital occupations from the MPS 1-RDM (watch them go 2/0 ->
1/1 as the bond stretches — the signature of static correlation).

Run with: ``python3 examples/torch/quantum_chemistry.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models import chemistry as chem

E_H_STO3G = -0.46658185  # one H atom in STO-3G (exact for this basis)


def h2_point(r, device):
    syms, xyz = chem.h_chain_geometry(2, r)
    basis, charges = chem.sto3g_basis(syms, xyz)
    S, hcore, eri, e_nuc = chem.molecular_integrals(basis, charges, xyz)
    e_hf, C, _ = chem.restricted_hartree_fock(S, hcore, eri, 2)
    h1, g = chem.mo_transform(hcore, eri, C)
    e_dmrg, mps, _ = chem.chemistry_dmrg(h1, g, 2, max_bond=8, sweeps=4,
                                          device=device)
    e_fci = chem.fci_ground(h1, g, n_elec=2)
    occ = chem.natural_occupations(mps)
    return e_hf + e_nuc, e_dmrg + e_nuc, e_fci + e_nuc, occ


def main(device="cuda"):
    print("H2 / STO-3G dissociation (energies in hartree)")
    print(f"{'R (a0)':>7} {'RHF':>10} {'DMRG':>10} {'FCI':>10} "
          f"{'nat. occ':>14}")
    for r in (1.0, 1.4011, 2.0, 3.0, 4.5, 6.0):
        e_hf, e_dmrg, e_fci, occ = h2_point(r, device)
        assert abs(e_dmrg - e_fci) < 1e-9
        print(f"{r:7.2f} {e_hf:10.5f} {e_dmrg:10.5f} {e_fci:10.5f} "
              f"  [{occ[0]:.3f}, {occ[1]:.3f}]")
    e_hf6, e_dmrg6, _, occ6 = h2_point(6.0, device)
    print(f"\ndissociation limit: DMRG {e_dmrg6:.5f} vs "
          f"2 x E(H) = {2 * E_H_STO3G:.5f}  "
          f"(RHF error: {e_hf6 - 2 * E_H_STO3G:+.3f} Ha)")
    assert abs(e_dmrg6 - 2 * E_H_STO3G) < 2e-3
    assert e_hf6 - 2 * E_H_STO3G > 0.1  # RHF's qualitative failure
    assert abs(occ6[0] - 1.0) < 0.1  # near-degenerate natural pair


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
