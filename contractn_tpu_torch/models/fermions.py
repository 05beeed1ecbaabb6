"""Spinless fermion chains through the Jordan-Wigner mapping.

Counterpart of ``contractn_tpu/models/fermions.py``.  Under Jordan-Wigner,
nearest-neighbour hopping and p-wave pairing carry no residual string, so

    ``H = sum_i [ -t (c^d_i c_{i+1} + h.c.)
                  + delta (c_i c_{i+1} + h.c.) - mu n_i ]``

is an anisotropic XY chain in a transverse field,

    ``H = sum_i [ -(t + delta)/2 X X - (t - delta)/2 Y Y ]
         - (mu/2) sum_i (1 - Z)``,

with ``n_i = (1 - Z_i)/2`` and real ``Y Y = -(iY)(iY)``.  ``delta = 0`` is
the free tight-binding chain, ``delta != 0`` the Kitaev chain.  The MPO is
built on the host and goes to ``device`` (default ``cuda``; raises without a
GPU unless ``device="cpu"``); the BdG oracle is host numpy.
"""

import numpy as np
import torch

from .dmrg import _ID, _SX, _SY_IM, _SZ
from .mpo import _uniform_mpo


def kitaev_chain_mpo(n_sites, t=1.0, delta=0.0, mu=0.0, dtype=torch.float64,
                     device=None):
    """MPO of the open Kitaev / tight-binding chain (see module doc).

    The constant ``-mu n/2`` shift is included, so the spectrum equals the
    fermion Hamiltonian's exactly.
    """
    jx = -(t + delta) / 2.0
    jy = -(t - delta) / 2.0
    # field term: -mu (1 - Z)/2 per site = -(mu/2) I + (mu/2) Z
    onsite = (mu / 2.0) * _SZ - (mu / 2.0) * _ID
    w = np.zeros((2, 2, 4, 4))
    w[:, :, 0, 0] = _ID
    w[:, :, 3, 3] = _ID
    w[:, :, 0, 1] = _SX
    w[:, :, 1, 3] = jx * _SX
    w[:, :, 0, 2] = _SY_IM
    w[:, :, 2, 3] = -jy * _SY_IM  # YY = -(iY)(iY)
    w[:, :, 0, 3] = onsite
    return _uniform_mpo(w, np.array([1.0, 0.0, 0.0, 0.0]),
                        np.array([0.0, 0.0, 0.0, 1.0]), n_sites, dtype, device)


def free_fermion_energy(n_sites, t=1.0, delta=0.0, mu=0.0):
    """Exact open-chain ground energy from the BdG spectrum (host float):
    ``E0 = (1/2) (tr A - sum_k eps_k)`` over the positive Bogoliubov modes of
    ``H_BdG = [[A, B], [-B, -A]]``."""
    a = np.zeros((n_sites, n_sites))
    b = np.zeros((n_sites, n_sites))
    for i in range(n_sites - 1):
        a[i, i + 1] = a[i + 1, i] = -t
        b[i, i + 1] = delta
        b[i + 1, i] = -delta
    np.fill_diagonal(a, -mu)
    h_bdg = np.block([[a, b], [-b, -a]])
    eps = np.linalg.eigvalsh(h_bdg)
    pos = eps[eps > 1e-14]
    return 0.5 * (np.trace(a) - np.sum(pos))
