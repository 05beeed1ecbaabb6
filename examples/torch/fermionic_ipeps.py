"""Fermionic iPEPS in the thermodynamic limit, on the PyTorch port: the 2D
spinless p-wave superconductor, ground state by gradient descent through
the fermionized-double-layer CTMRG.

Run with: ``python3 examples/torch/fermionic_ipeps.py [--device cpu]``

The fermionic sign structure enters as CONSTANT tensors baked into the
double tensors (models/fipeps.py), so the infinite-lattice contraction,
energy patches, and the whole optimization are ordinary torch
programs — the same machinery as the bosonic variational iPEPS.
"""

import argparse

import torch

from contractn_tpu_torch.models import (
    bdg_energy_2d,
    fipeps_ground_state,
)

# gapped regime: real NN pairing is fully gapped for |mu| > 4
t, mu, delta = 1.0, -4.4, 1.0


def main(device="cuda"):
    exact = bdg_energy_2d(t, mu, delta)
    print(f"exact BdG ground energy per site: {exact:.8f}")

    a, e, dens, trace = fipeps_ground_state(
        bond_parities=(0, 1),  # D = 2: one even + one odd virtual state
        chi=12, t=t, mu=mu, delta=delta, steps=250, lr=2e-2, seed=0,
        device=device,
    )
    e, dens = float(e), float(dens)
    print(f"D=2 fermionic iPEPS: E = {e:.8f}  (+{(e-exact):.2e} above "
          f"exact, {(e-exact)/abs(exact):.3%})")
    print(f"density <n> = {dens:.6f}")
    print("last optimization energies:",
          [f"{float(x):.6f}" for x in trace[-3:]])
    assert e > exact - 1e-9  # variational from above


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
