"""DMRG-X: targeting ARBITRARY eigenstates by maximum overlap.

Counterpart of ``contractn_tpu/models/dmrgx.py``.  The many-body-localization
workhorse (Khemani-Pollmann-Sondhi): in an MBL phase every eigenstate has
area-law entanglement, so each is an MPS.  DMRG-X sweeps two-site updates
that pick the effective-Hamiltonian eigenvector with MAXIMUM OVERLAP against
the current local block: seeded with a product state, the iteration flows to
the exact eigenstate that state adiabatically connects to.  Each local
problem diagonalizes the dense two-site ``H_eff`` (full spectra are needed
for the overlap choice), which caps practical bonds at the dense-eigh scale.

The energy-variance certificate ``<H^2> - <H>^2`` (exact MPO algebra,
:func:`~.mpo.mpo_multiply`) measures eigenstate quality without reference
data.
"""

import numpy as np
import torch

from ..ops.linalg_ad import dense_eigh
from ..ops.stabilize import peinsum
from .dmrg import (
    _boundary,
    _dense_heff,
    _ragged_sites,
    _rebuild_uniform,
    _split_theta,
    _update_left,
    _update_right,
)
from .mpo import mpo_multiply, rayleigh

__all__ = ["dmrgx", "energy_variance"]


def energy_variance(mpo, mps):
    """``<H^2> - <H>^2`` — the eigenstate certificate (0 iff exact)."""
    e = rayleigh(mpo, mps)
    e2 = rayleigh(mpo_multiply(mpo, mpo), mps)
    return float(e2 - e * e)


def _local_max_overlap(L, w1, w2, R, theta0):
    """Eigenpair of the dense two-site H_eff with max ``|<v|theta0>|`` (one
    host read: the chosen index and its eigenvalue)."""
    d = w1.shape[0]
    dl, dr = L.shape[0], R.shape[0]
    vals, vecs = dense_eigh(_dense_heff(L, w1, w2, R))
    ovl = peinsum("dk,d->k", vecs.conj(), theta0.reshape(-1)).abs()
    k = int(torch.argmax(ovl))
    return float(vals[k]), vecs[:, k].reshape(d, d, dl, dr)


def dmrgx(mpo, mps0, sweeps=6, max_bond=None):
    """Converge ``mps0`` to the exact eigenstate it overlaps most.

    Args:
        mpo: Hermitian operator as an :class:`MPO`.
        mps0: the seed — e.g. a product state that is an eigenstate of the
            strong-disorder limit; it selects WHICH eigenstate the sweeps
            lock onto.
        sweeps: full back-and-forth passes.
        max_bond: bond cap (default: the seed's bond).  The dense local eigh
            is O((d^2 Dl Dr)^3): keep bonds at MBL scale.

    Returns ``(mps, energy, variance)``.
    """
    n = mps0.n_sites
    if n < 2:
        raise ValueError("dmrgx needs at least 2 sites")
    max_bond = max_bond or mps0.bond_dim
    sites = _ragged_sites(mps0)
    ws = [mpo.cores[i] for i in range(n)]
    L = [None] * (n + 1)
    R = [None] * (n + 1)
    L[0] = _boundary(mpo.left, sites[0].dtype, sites[0].device)
    R[n] = _boundary(mpo.right, sites[0].dtype, sites[0].device)
    for i in range(n - 1, 0, -1):
        R[i] = _update_right(R[i + 1], sites[i], ws[i])

    energy = np.inf
    for _ in range(sweeps):
        for i in range(n - 1):
            theta0 = peinsum("apj,bjq->abpq", sites[i], sites[i + 1])
            energy, theta = _local_max_overlap(L[i], ws[i], ws[i + 1],
                                               R[i + 2], theta0)
            sites[i], sites[i + 1] = _split_theta(theta, max_bond, to_left=True)
            L[i + 1] = _update_left(L[i], sites[i], ws[i])
        for i in range(n - 2, -1, -1):
            theta0 = peinsum("apj,bjq->abpq", sites[i], sites[i + 1])
            energy, theta = _local_max_overlap(L[i], ws[i], ws[i + 1],
                                               R[i + 2], theta0)
            sites[i], sites[i + 1] = _split_theta(theta, max_bond, to_left=False)
            R[i + 1] = _update_right(R[i + 2], sites[i + 1], ws[i + 1])

    # rebuild in the SITES' dtype: a complex MPO makes the local eigenvectors
    # complex even from a real seed, and casting back to the seed's dtype
    # would discard the imaginary parts
    out = _rebuild_uniform(sites, sites[0].dtype)
    return out, float(energy), energy_variance(mpo, out)
