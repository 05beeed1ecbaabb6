"""Strictly single-site DMRG with subspace expansion (DMRG3S).

Counterpart of ``contractn_tpu/models/dmrg3s.py``.  Hubig-McCulloch-
Schollwoeck single-site DMRG: each local solve optimizes ONE site tensor —
cost ``O(d D^3 W)`` per site against the two-site sweep's ``O(d^2 D^3 W)``
solve plus its ``(dD, dD)`` SVD — and bond growth is restored by *subspace
expansion*: before each truncation the active bond is enriched with the
mixing term ``P = alpha * L . W . M`` (mirrored with ``R`` on the way back).
The mixing strength decays geometrically over sweeps, so late sweeps are
pure Rayleigh-quotient descent.  Builds on the ragged-site machinery of
:mod:`.dmrg`.
"""

import numpy as np
import torch

from ..ops.krylov import lanczos_ground
from ..ops.linalg_ad import dense_eigh
from ..ops.stabilize import peinsum
from .dmrg import (
    _DENSE_EIGH_LIMIT,
    _boundary,
    _ragged_sites,
    _rebuild_uniform,
    _update_left,
    _update_right,
)
from .tdvp import _h1_matvec


def _ground_one_site(envs_l, w, envs_r, m0, iters=24):
    """Lowest eigenpair of the one-site effective Hamiltonian: dense eigh up
    to the shared size limit, Lanczos above (one host read either way)."""
    d, dl, dr = m0.shape
    dim = d * dl * dr
    if dim > _DENSE_EIGH_LIMIT:
        return lanczos_ground(lambda m: _h1_matvec(envs_l, w, envs_r, m), m0,
                              iters)
    # H[(a,i,j), (b,p,q)] = L[i,w,p] W[a,b,w,v] R[j,v,q]
    hmat = peinsum("iwp,abwv,jvq->aijbpq", envs_l, w, envs_r).reshape(dim, dim)
    vals, vecs = dense_eigh(0.5 * (hmat + hmat.conj().T))
    return float(vals[0]), vecs[:, 0].reshape(d, dl, dr)


def _scaled_mix(p, m, alpha):
    """Mixing term rescaled relative to the optimized site tensor."""
    pn = torch.linalg.norm(p.reshape(-1))
    mn = torch.linalg.norm(m.reshape(-1))
    return p * (alpha * mn / torch.clamp(pn, min=1e-300))


def _truncate(mat, max_bond):
    u, s, vh = torch.linalg.svd(mat, full_matrices=False)
    k = min(s.shape[0], max_bond)
    u, s, vh = u[:, :k], s[:k], vh[:k]
    s = s / torch.clamp(torch.linalg.norm(s), min=1e-300)
    return u, s.to(u.dtype), vh, k


def _expand_right(m, nxt, envs_l, w, alpha, max_bond):
    """Enrich the bond between ``m (d, Dl, Dr)`` and ``nxt (d, Dr, Dr2)``
    while moving right; returns the isometric replacement for ``m`` (bond
    grown up to ``max_bond``) and the updated next site."""
    d, dl, dr = m.shape
    wdim = w.shape[2]
    # P[a, i, (v, q)] = L[i,w,p] W[a,b,w,v] M[b,p,q]
    p = peinsum("iwp,abwv,bpq->aivq", envs_l, w, m)
    p = _scaled_mix(p.reshape(d, dl, wdim * dr), m, alpha)
    ext = torch.cat([m, p], dim=2)  # (d, Dl, Dr + W Dr)
    u, s, vh, k = _truncate(ext.reshape(d * dl, -1), max_bond)
    carry = s[:, None] * vh  # (k, Dr + W Dr)
    nxt_ext = torch.cat([nxt, torch.zeros((d, wdim * dr, nxt.shape[2]),
                                          dtype=nxt.dtype, device=nxt.device)],
                        dim=1)
    return u.reshape(d, dl, k), peinsum("kx,dxj->dkj", carry, nxt_ext)


def _expand_left(m, prv, w, envs_r, alpha, max_bond):
    """Mirror of :func:`_expand_right` while moving left."""
    d, dl, dr = m.shape
    wdim = w.shape[2]
    # P[a, (v, p), j] = W[a,b,v,u] M[b,p,q] R[j,u,q]
    p = peinsum("abvu,bpq,juq->avpj", w, m, envs_r)
    p = _scaled_mix(p.reshape(d, wdim * dl, dr), m, alpha)
    ext = torch.cat([m, p], dim=1)  # (d, Dl + W Dl, Dr)
    mat = ext.transpose(0, 1).reshape(dl + wdim * dl, d * dr)
    u, s, vh, k = _truncate(mat, max_bond)
    carry = u * s[None, :]  # (Dl + W Dl, k)
    prv_ext = torch.cat([prv, torch.zeros((d, prv.shape[1], wdim * dl),
                                          dtype=prv.dtype, device=prv.device)],
                        dim=2)
    new_m = vh.reshape(k, d, dr).transpose(0, 1)
    return new_m, peinsum("dpx,xk->dpk", prv_ext, carry)


def dmrg3s(mpo, mps0, max_bond=None, sweeps=6, mixing=1e-2, decay=0.5,
           lanczos_iters=24):
    """Single-site DMRG ground-state search with subspace expansion.

    Args:
        mpo: Hermitian Hamiltonian as an :class:`~.mpo.MPO`.
        mps0: initial state; may have a SMALLER bond than ``max_bond`` — the
            expansion grows bonds (plain single-site DMRG cannot).
        max_bond: bond cap (default ``mps0.bond_dim``).
        sweeps: full left-right + right-left sweeps.
        mixing: initial expansion strength ``alpha`` (relative to the
            optimized site's norm); decays by ``decay`` each sweep.
        decay: per-sweep geometric decay of ``alpha``.

    Returns:
        ``(ground_mps, energy, energies)`` as :func:`~.dmrg.dmrg`.
    """
    n = mps0.n_sites
    if n < 2:
        raise ValueError("dmrg3s needs at least 2 sites")
    max_bond = max_bond or mps0.bond_dim
    sites = _ragged_sites(mps0)
    ws = [mpo.cores[i] for i in range(n)]
    envs_l = [None] * (n + 1)
    envs_r = [None] * (n + 1)
    envs_l[0] = _boundary(mpo.left, sites[0].dtype, sites[0].device)
    envs_r[n] = _boundary(mpo.right, sites[0].dtype, sites[0].device)
    for i in range(n - 1, 0, -1):
        envs_r[i] = _update_right(envs_r[i + 1], sites[i], ws[i])

    energies = []
    energy = np.inf
    alpha = float(mixing)
    for _ in range(sweeps):
        for i in range(n - 1):  # left -> right, expand the right bond
            energy, m = _ground_one_site(envs_l[i], ws[i], envs_r[i + 1],
                                         sites[i], iters=lanczos_iters)
            sites[i], sites[i + 1] = _expand_right(
                m, sites[i + 1], envs_l[i], ws[i], alpha, max_bond)
            envs_l[i + 1] = _update_left(envs_l[i], sites[i], ws[i])
        for i in range(n - 1, 0, -1):  # right -> left, expand the left bond
            energy, m = _ground_one_site(envs_l[i], ws[i], envs_r[i + 1],
                                         sites[i], iters=lanczos_iters)
            sites[i], sites[i - 1] = _expand_left(
                m, sites[i - 1], ws[i], envs_r[i + 1], alpha, max_bond)
            envs_r[i] = _update_right(envs_r[i + 1], sites[i], ws[i])
        energies.append(energy)
        alpha *= decay

    return _rebuild_uniform(sites, mps0.cores.dtype), energy, energies
