"""The 2D Heisenberg antiferromagnet, end to end, on the PyTorch port.

Checkerboard simple update -> directional cell CTMRG measurement ->
gradient (variational) refinement through the environment -> staggered
moments.  Exact QMC reference: E = -0.669437 / site, m = 0.307.

Run with: ``python3 examples/torch/heisenberg_2d.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models import (
    cell_site_expectations,
    heisenberg_bond_term_2d,
    ipeps_cell_ground_state,
    variational_ipeps_cell,
)

D, CHI = 2, 12
SX = np.array([[0.0, 1.0], [1.0, 0.0]]) / 2.0
SZ = np.diag([0.5, -0.5])


def _real(v):
    return float(np.real(complex(v)))


def main(device="cuda"):
    h2 = heisenberg_bond_term_2d(rotated=False, device=device)  # bare J S.S (Neel frame)

    a, b, e_su = ipeps_cell_ground_state(
        h2, bond_dim=D, chi=CHI,
        schedule=((0.1, 200), (0.02, 200), (0.005, 100)), iters=120,
    )
    print(f"simple update   (D={D}): E/site = {_real(e_su):.6f}")

    pa, pb, e_var, trace = variational_ipeps_cell(
        h2, bond_dim=D, chi=CHI, steps=120, lr=2e-3)
    e_var = float(e_var)
    print(f"variational     (D={D}): E/site = {e_var:.6f}  "
          f"(gradient gain {_real(e_su) - e_var:+.4f}; "
          f"exact QMC -0.669437)")

    mx = cell_site_expectations(pa, pb, SX, chi=CHI, iters=120)
    mz = cell_site_expectations(pa, pb, SZ, chi=CHI, iters=120)
    print("\nstaggered moment pattern (|m|, SU(2) direction run-dependent):")
    for x in range(2):
        row = [np.hypot(_real(mx[x][y]), _real(mz[x][y]))
               * np.sign(_real(mx[x][y]) or 1.0)
               for y in range(2)]
        print("  ", [f"{v:+.4f}" for v in row])


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
