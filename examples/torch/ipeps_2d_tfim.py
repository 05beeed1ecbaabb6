"""2D quantum workflow on the PyTorch port: iPEPS simple update + CTMRG
measurement.

Ground state of the square-lattice transverse-field Ising model
``H = -J sum_<ij> Z Z - h sum_i X`` (critical field h_c ~ 3.044 J) at
D = 2, measured through the corner-transfer-matrix environment.

Run with: ``python3 examples/torch/ipeps_2d_tfim.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models.ipeps import (
    ipeps_expect_local,
    ipeps_ground_state,
    tfim_bond_term_2d,
)

SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SZ = np.diag([1.0, -1.0])


def main(device="cuda"):
    for h in (3.5, 5.0):
        a_site, energy = ipeps_ground_state(
            tfim_bond_term_2d(j=1.0, h=h, device=device), bond_dim=2, chi=8,
        )
        mx = float(np.real(complex(ipeps_expect_local(a_site, SX, chi=8))))
        # best product state: sin(theta) = h/4 while h < 4, else |+>
        e_mf = (-2.0 - h * h / 8) if h < 4 else -h
        e_pt2 = -h - 1.0 / (2 * h)  # large-field expansion
        print(
            f"2D TFIM h={h}: E/site = {float(energy):.5f}  "
            f"(mean-field {e_mf:.5f}, PT2 {e_pt2:.5f})   <X> = {mx:.4f}"
        )


def classical_crosscheck(device="cuda"):
    """The sqrt-Boltzmann iPEPS must reproduce Onsager-Yang exactly."""
    beta = 0.5
    b = np.array([[np.exp(beta / 2), np.exp(-beta / 2)],
                  [np.exp(-beta / 2), np.exp(beta / 2)]])
    vals, vecs = np.linalg.eigh(b)
    w = vecs * np.sqrt(np.maximum(vals, 0.0))[None, :]
    a_site = torch.as_tensor(np.einsum("su,sl,sd,sr->suldr", w, w, w, w),
                             device=device)
    y = np.kron(w[0], w[0])
    boundary = (torch.as_tensor(np.outer(y, y), device=device),
                torch.as_tensor(np.einsum("l,d,r->ldr", y, y, y), device=device))
    m = float(np.real(complex(ipeps_expect_local(a_site, SZ, chi=16,
                                                 boundary=boundary))))
    m_exact = (1.0 - np.sinh(2 * beta) ** -4) ** 0.125
    print(f"sqrt-Boltzmann iPEPS at beta={beta}: <Z> = {m:.8f} "
          f"(Onsager-Yang {m_exact:.8f})")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    dev = torch.device(parser.parse_args().device)
    main(dev)
    classical_crosscheck(dev)
