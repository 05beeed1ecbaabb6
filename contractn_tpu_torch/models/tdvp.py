"""TDVP (two-site and single-site): real- and imaginary-time MPS evolution.

Counterpart of ``contractn_tpu/models/tdvp.py``.  The time-dependent
variational principle (Haegeman et al.) projects the Schrodinger flow onto
the MPS manifold, reusing the DMRG machinery of :mod:`.dmrg` (environments
and effective-Hamiltonian matvecs): one left-to-right sweep evolves each
two-site block forward by ``dt/2`` under ``H_eff`` and each single-site
center backward by ``dt/2`` under ``H1_eff``; the mirror sweep completes a
second-order symmetric step.  Local propagators are Krylov exponentials —
a fixed-length Lanczos on the state's device (:mod:`..ops.krylov`), then
``exp(c T) e1`` from the eigendecomposition of the small tridiagonal, which
is read to the host once and solved there (the one host read of a local
step).

Real time (``coef = -i dt / 2``) runs in complex128 from float64 states and
complex64 from float32 ones, and conserves norm and energy to integrator
order; imaginary time (``dt``) flows toward the ground state.

The SINGLE-site integrator (:func:`tdvp1_step`) never truncates: the bond
dimension never changes and real-time norm and energy are conserved to
Krylov tolerance.

The ``masks`` / ``theta_masks`` / ``splitter`` / ``bond_masks`` / ``orth``
hooks keep the evolution on a structural subspace (the exact-U(1) path of
the JAX package), as there.
"""

import numpy as np
import torch

from ..ops.krylov import lanczos_basis, tridiagonal_eigh
from ..ops.stabilize import peinsum
from .dmrg import (
    _boundary,
    _heff_matvec,
    _ragged_sites,
    _rebuild_uniform,
    _split_theta,
    _update_left,
    _update_right,
)
from .mpo import rayleigh as _rayleigh


def _h1_matvec(L, w, R, m):
    """One-site effective Hamiltonian: ``m (d, Dl, Dr) -> same shape``."""
    t = peinsum("iwp,Bpq->iwBq", L, m)
    t = peinsum("XBwv,iwBq->iXvq", w, t)
    return peinsum("kvq,iXvq->Xik", R, t)


def _h0_matvec(L, R, c):
    """Zero-site (bond) effective Hamiltonian: ``c (Dl, Dr) -> same``."""
    t = peinsum("iwp,pq->iwq", L, c)
    return peinsum("jwq,iwq->ij", R, t)


def _krylov_expm_apply(matvec, v0, coef, iters):
    """``exp(coef * H) v0`` through an ``iters``-dim Krylov space.

    ``coef`` may be complex (real time).  Exhausted steps carry the 1e30
    diagonal marker; the eigenvectors of their decoupled block have zero
    overlap with ``e1``, so their weights multiply 0.  In imaginary time a
    positive ``coef`` (backward half-steps) would overflow on the marker, so
    the exponent is clamped at 650.
    """
    basis, alphas, betas, nrm0 = lanczos_basis(matvec, v0, iters)
    vals, vecs = tridiagonal_eigh(alphas, betas)
    cdt = v0.dtype
    if isinstance(coef, complex) and not cdt.is_complex:
        cdt = torch.promote_types(cdt, torch.complex64)
    z = coef * vals
    expvals = np.exp(z) if cdt.is_complex else np.exp(np.minimum(z, 650.0))
    w = np.matmul(vecs, expvals * np.conj(vecs[0, :]))
    w = torch.from_numpy(np.asarray(w)).to(v0.device, cdt)
    out = peinsum("k,kd->d", w, basis[:-1].to(cdt))
    return (nrm0.to(cdt) * out).reshape(v0.shape)


def _masked_matvec(fn, mask):
    if mask is None:
        return fn
    return lambda t: mask.to(t.dtype) * fn(t)


def _evolve_two_site(L, w1, w2, R, theta, iters, coef, mask=None):
    """``mask`` (same shape as ``theta``, or None) keeps the whole Krylov
    basis on a structural subspace (the exact-U(1) hook)."""
    if mask is not None:
        theta = theta * mask.to(theta.dtype)
    mv = _masked_matvec(lambda t: _heff_matvec(L, w1, w2, R, t), mask)
    return _krylov_expm_apply(mv, theta, coef, iters)


def _evolve_one_site(L, w, R, iters, m, coef, mask=None):
    if mask is not None:
        m = m * mask.to(m.dtype)
    mv = _masked_matvec(lambda t: _h1_matvec(L, w, R, t), mask)
    return _krylov_expm_apply(mv, m, coef, iters)


def _evolve_zero_site(L, R, iters, c, coef, mask=None):
    if mask is not None:
        c = c * mask.to(c.dtype)
    mv = _masked_matvec(lambda x: _h0_matvec(L, R, x), mask)
    return _krylov_expm_apply(mv, c, coef, iters)


def _start(mpo, mps, imaginary, masks, name):
    """Sites, operator cores and edge environments of a sweep."""
    n = mps.n_sites
    if n < 2:
        raise ValueError(f"{name} needs at least 2 sites")
    masked = masks is not None
    if masked:
        # uniform static bond throughout: boundary structure lives in the
        # masks' dead slots
        from .ensemble import _boundary_env, _pad_boundary_sites

        padded = _pad_boundary_sites(mps) * masks.to(mps.cores.dtype)
        sites = [padded[i] for i in range(n)]
    else:
        sites = _ragged_sites(mps)
    if not imaginary:
        sites = [s.to(torch.promote_types(s.dtype, torch.complex64))
                 for s in sites]
    dt, device = sites[0].dtype, sites[0].device
    ws = [mpo.cores[i] for i in range(n)]
    L = [None] * (n + 1)
    R = [None] * (n + 1)
    if masked:
        bond = sites[0].shape[1]
        L[0] = _boundary_env(torch.as_tensor(mpo.left).to(device), bond, dt)
        R[n] = _boundary_env(torch.as_tensor(mpo.right).to(device), bond, dt)
    else:
        L[0] = _boundary(mpo.left, dt, device)
        R[n] = _boundary(mpo.right, dt, device)
    for i in range(n - 1, 0, -1):
        R[i] = _update_right(R[i + 1], sites[i], ws[i])
    return sites, ws, L, R


def _finish(mpo, sites):
    """Normalize the center (site 0), rebuild, and read the energy."""
    sites[0] = sites[0] / torch.clamp(torch.linalg.norm(sites[0]), min=1e-300)
    out = _rebuild_uniform(sites, sites[0].dtype)
    return out, _rayleigh(mpo, out)


def tdvp_step(mpo, mps, dt, max_bond=None, imaginary=False, iters=16,
              masks=None, theta_masks=None, splitter=None):
    """One symmetric second-order two-site TDVP step.

    Args:
        mpo: Hamiltonian as an :class:`~.mpo.MPO`.
        mps: current state.
        dt: time step (real scalar).
        max_bond: bond cap for the SVD splits (default: keep current).
        imaginary: evolve by ``exp(-dt H)`` instead of ``exp(-1j dt H)``.
        iters: Krylov dimension per local exponential.
        masks / theta_masks / splitter: structural-subspace hooks:
            ``masks (n, d, D, D)`` one-site masks, ``theta_masks (n-1, d, d,
            D, D)`` two-site block masks and a charge-aligned
            ``splitter(theta, i, to_left)`` replacing the plain SVD split.
            Masked runs require a uniform-bond state.

    Returns:
        ``(new_mps, energy)`` — the evolved state in uniform stacked form
        (normalized) and its energy (a host float).
    """
    max_bond = max_bond or mps.bond_dim
    fwd = -0.5 * dt if imaginary else -0.5j * dt
    bwd = -fwd
    masked = masks is not None
    if masked and (theta_masks is None or splitter is None):
        raise ValueError("masked tdvp_step needs theta_masks and splitter")
    sites, ws, L, R = _start(mpo, mps, imaginary, masks, "tdvp_step")

    def smask(i):
        return masks[i] if masked else None

    def tmask(i):
        return theta_masks[i] if masked else None

    def split(theta, i, to_left):
        if splitter is None:
            return _split_theta(theta, max_bond, to_left)
        t1, t2 = splitter(theta, i, to_left)
        return t1 * smask(i).to(t1.dtype), t2 * smask(i + 1).to(t2.dtype)

    def sweep(order, left_to_right):
        for idx, i in enumerate(order):
            theta = peinsum("apj,bjq->abpq", sites[i], sites[i + 1])
            theta = _evolve_two_site(L[i], ws[i], ws[i + 1], R[i + 2], theta,
                                     iters, fwd, mask=tmask(i))
            last_pair = idx == len(order) - 1
            sites[i], sites[i + 1] = split(theta, i, to_left=left_to_right)
            if left_to_right:
                L[i + 1] = _update_left(L[i], sites[i], ws[i])
                if not last_pair:
                    sites[i + 1] = _evolve_one_site(
                        L[i + 1], ws[i + 1], R[i + 2], iters, sites[i + 1],
                        bwd, mask=smask(i + 1))
            else:
                R[i + 1] = _update_right(R[i + 2], sites[i + 1], ws[i + 1])
                if not last_pair:
                    sites[i] = _evolve_one_site(L[i], ws[i], R[i + 1], iters,
                                                sites[i], bwd, mask=smask(i))

    n = len(sites)
    sweep(list(range(n - 1)), left_to_right=True)
    sweep(list(range(n - 2, -1, -1)), left_to_right=False)
    return _finish(mpo, sites)


def tdvp_evolve(mpo, mps0, dt, n_steps, max_bond=None, imaginary=False,
                iters=16, masks=None, theta_masks=None, splitter=None):
    """Evolve ``n_steps`` TDVP steps; returns ``(mps, [energies])``."""
    mps = mps0
    energies = []
    for _ in range(n_steps):
        mps, e = tdvp_step(mpo, mps, dt, max_bond=max_bond,
                           imaginary=imaginary, iters=iters, masks=masks,
                           theta_masks=theta_masks, splitter=splitter)
        energies.append(e)
    return mps, energies


def tdvp_evolve_driven(mpo_fn, mps0, dt, n_steps, max_bond=None, iters=16,
                       masks=None, theta_masks=None, splitter=None):
    """TDVP under a TIME-DEPENDENT Hamiltonian ``H(t)``.

    ``mpo_fn(t)`` returns the MPO at time ``t``; each step evolves by the
    MIDPOINT Hamiltonian ``H(t + dt/2)`` (the exponential-midpoint rule,
    globally second order for smooth drives).  Returns ``(mps, [energies])``
    with the instantaneous midpoint energies.
    """
    mps = mps0
    energies = []
    for k in range(n_steps):
        mps, e = tdvp_step(mpo_fn((k + 0.5) * dt), mps, dt, max_bond=max_bond,
                           imaginary=False, iters=iters, masks=masks,
                           theta_masks=theta_masks, splitter=splitter)
        energies.append(e)
    return mps, energies


def tdvp1_step(mpo, mps, dt, imaginary=False, iters=16, masks=None,
               bond_masks=None, orth=None):
    """One symmetric second-order SINGLE-site TDVP step (Haegeman et al.).

    The projection onto the fixed-bond manifold is exact: real-time
    evolution conserves norm and energy to Krylov tolerance and the bond
    never grows (start from the bond you want).  Left-to-right evolves each
    site forward ``dt/2`` with the bond center evolved backward ``dt/2``
    between sites (QR split), then the mirrored right-to-left half-sweep.

    ``masks (n, d, D, D)`` / ``bond_masks (n+1, D, D)`` / ``orth = (fwd,
    bwd)`` are the exact-U(1) hooks; masked runs require ``orth`` (a
    charge-aligned orthogonalizer replacing the plain QR) and a uniform-bond
    state.  Returns ``(new_mps, energy)`` like :func:`tdvp_step`.
    """
    fwd = -0.5 * dt if imaginary else -0.5j * dt
    bwd = -fwd
    masked = masks is not None
    if masked and (bond_masks is None or orth is None):
        raise ValueError(
            "masked tdvp1_step needs bond_masks and orth (plain QR junk "
            "columns corrupt masked environments)")
    sites, ws, L, R = _start(mpo, mps, imaginary, masks, "tdvp1_step")
    n = len(sites)

    def smask(i):
        return masks[i] if masked else None

    def bmask(b):
        return bond_masks[b] if masked else None

    def remask(t, m):
        return t if m is None else t * m.to(t.dtype)

    for i in range(n):  # left -> right
        sites[i] = _evolve_one_site(L[i], ws[i], R[i + 1], iters, sites[i],
                                    fwd, mask=smask(i))
        if i < n - 1:
            d, dl, dr = sites[i].shape
            mat = sites[i].reshape(d * dl, dr)
            q, r = orth[0](mat, i) if orth is not None else torch.linalg.qr(mat)
            sites[i] = remask(q.reshape(d, dl, -1), smask(i))
            L[i + 1] = _update_left(L[i], sites[i], ws[i])
            c = _evolve_zero_site(L[i + 1], R[i + 1], iters,
                                  remask(r, bmask(i + 1)), bwd,
                                  mask=bmask(i + 1))
            sites[i + 1] = peinsum("kp,dpq->dkq", c, sites[i + 1])

    for i in range(n - 1, -1, -1):  # right -> left, LQ splits
        sites[i] = _evolve_one_site(L[i], ws[i], R[i + 1], iters, sites[i],
                                    fwd, mask=smask(i))
        if i > 0:
            d, dl, dr = sites[i].shape
            # mat = C . Q with Q's rows orthonormal: QR the plain transpose
            mat = sites[i].transpose(0, 1).reshape(dl, d * dr).T
            q2, r2 = orth[1](mat, i) if orth is not None else torch.linalg.qr(mat)
            sites[i] = remask(q2.T.reshape(-1, d, dr).transpose(0, 1), smask(i))
            R[i] = _update_right(R[i + 1], sites[i], ws[i])
            c = _evolve_zero_site(L[i], R[i], iters, remask(r2.T, bmask(i)),
                                  bwd, mask=bmask(i))
            sites[i - 1] = peinsum("dpq,qk->dpk", sites[i - 1], c)

    return _finish(mpo, sites)


def tdvp1_evolve(mpo, mps0, dt, n_steps, imaginary=False, iters=16,
                 masks=None, bond_masks=None, orth=None):
    """Evolve ``n_steps`` single-site TDVP steps; ``(mps, [energies])``."""
    mps = mps0
    energies = []
    for _ in range(n_steps):
        mps, e = tdvp1_step(mpo, mps, dt, imaginary=imaginary, iters=iters,
                            masks=masks, bond_masks=bond_masks, orth=orth)
        energies.append(e)
    return mps, energies
