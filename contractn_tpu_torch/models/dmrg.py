"""Standard Hamiltonians as MPOs.

From ``contractn_tpu/models/dmrg.py`` only ``tfim_mpo``,
``heisenberg_mpo`` and ``_rebuild_uniform`` are ported so far; the DMRG
solvers come in a later slice.
"""

import numpy as np
import torch

from .mpo import _uniform_mpo
from .mps import MPS

_SX = np.array([[0.0, 1.0], [1.0, 0.0]])
_SZ = np.array([[1.0, 0.0], [0.0, -1.0]])
_SY_IM = np.array([[0.0, -1.0], [1.0, 0.0]])  # -i * sigma_y (real);
# only ever used quadratically, where the overall sign cancels
_ID = np.eye(2)


def _rebuild_uniform(tensors, dtype):
    """Uniform stacked MPS from ragged ``(d, Din, Dout)`` site tensors
    (zero-padded bonds, ``e0`` boundaries), on the first tensor's device."""
    n = len(tensors)
    d = tensors[0].shape[0]
    bond = max(max(t.shape[1], t.shape[2]) for t in tensors)
    bond = max(bond, 1)
    device = tensors[0].device
    cores = torch.zeros((n, d, bond, bond), dtype=dtype, device=device)
    for i, t in enumerate(tensors):
        cores[i, :, :t.shape[1], :t.shape[2]] = t
    e0 = torch.zeros((bond,), dtype=dtype, device=device)
    e0[0] = 1.0
    return MPS(cores, e0, e0.clone())


def tfim_mpo(n_sites, j=1.0, h=1.0, dtype=torch.float64, device=None):
    """Transverse-field Ising chain ``H = -J sum Z Z - h sum X`` (W=3)."""
    w = np.zeros((2, 2, 3, 3))
    w[:, :, 0, 0] = _ID
    w[:, :, 2, 2] = _ID
    w[:, :, 0, 1] = _SZ
    w[:, :, 1, 2] = -j * _SZ
    w[:, :, 0, 2] = -h * _SX
    return _uniform_mpo(w, np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                        n_sites, dtype, device)


def heisenberg_mpo(n_sites, jx=1.0, jz=1.0, dtype=torch.float64, device=None):
    """XXZ Heisenberg chain
    ``H = sum Jx (X X + Y Y) + Jz Z Z`` (W=5, real representation:
    ``Y Y = -(iY)(iY)``)."""
    w = np.zeros((2, 2, 5, 5))
    w[:, :, 0, 0] = _ID
    w[:, :, 4, 4] = _ID
    w[:, :, 0, 1] = _SX
    w[:, :, 1, 4] = jx * _SX
    w[:, :, 0, 2] = _SY_IM
    w[:, :, 2, 4] = -jx * _SY_IM
    w[:, :, 0, 3] = _SZ
    w[:, :, 3, 4] = jz * _SZ
    return _uniform_mpo(w, np.array([1.0, 0, 0, 0, 0]), np.array([0, 0, 0, 0, 1.0]),
                        n_sites, dtype, device)
