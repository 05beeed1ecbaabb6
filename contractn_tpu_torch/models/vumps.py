"""VUMPS: variational uniform MPS ground states.

Counterpart of ``contractn_tpu/models/vumps.py``.  The variational uniform
matrix product state algorithm (Zauner-Stauber et al.) finds infinite-chain
ground states directly in the thermodynamic limit: a single-site unit cell
in mixed canonical gauge ``(AL, AR, AC, C)`` is updated from the ground
states of two effective Hamiltonians built from quasi-fixed-point MPO
environments.  The output is a uniform core, so the :mod:`.umps`
observables apply to it.

One iteration:

1. left/right MPO environments ``FL, FR`` solved channel by channel for a
   triangular MPO; the corner (identity) channels need the
   energy-subtracted geometric series, solved by :func:`~..ops.krylov.gmres`
   on the ``(D^2,)`` transfer system with the divergent direction projected
   out;
2. ground states of ``H_AC`` (one site) and ``H_C`` (zero site) by the
   shared Lanczos (:mod:`..ops.krylov`, one host read a solve);
3. gauge update ``AL, AR`` from ``AC, C`` by SVD polar decompositions; the
   gradient norm ``|AC - AL C|`` is read on the host once an iteration.

The gauge fixed points (:func:`left_gauge`) run a fixed number of QR steps,
as the JAX package's ``fori_loop`` does, with no early exit.

Departure: the random start takes a ``torch.Generator`` (``generator=``)
where the JAX package takes a key, and ``a0=`` hands in the start core
itself, so that both packages can start from the same numbers.
"""

import numpy as np
import torch

from ..ops.krylov import gmres, lanczos_ground
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device, torch_dtype

# --------------------------------------------------------------------- #
# Mixed gauge
# --------------------------------------------------------------------- #


def _qr_pos(m):
    """QR with a positive diagonal of R (unique gauge)."""
    q, r = torch.linalg.qr(m)
    ph = torch.sgn(torch.diagonal(r, dim1=-2, dim2=-1))
    ph = torch.where(ph == 0, torch.ones_like(ph), ph)
    return q * ph[..., None, :], r * ph[..., :, None]


def left_gauge(a, iters=60):
    """Left-isometric ``AL (d, D, D)`` and its gauge ``L`` by ``iters``
    iterated QR steps of ``L A = AL L'``."""
    d, bond, _ = a.shape
    lmat = torch.eye(bond, dtype=a.dtype, device=a.device)
    al = torch.zeros_like(a)
    for _ in range(int(iters)):
        big = peinsum("ij,djk->dik", lmat, a).reshape(d * bond, bond)
        q, r = _qr_pos(big)
        lmat = r / torch.clamp(torch.linalg.norm(r), min=1e-300)
        al = q.reshape(d, bond, bond)
    return al, lmat


def right_gauge(a, iters=60):
    """Mirror: right-isometric ``AR`` with gauge ``R``."""
    ar_flip, rmat = left_gauge(a.transpose(1, 2), iters)
    return ar_flip.transpose(1, 2), rmat.T


def mixed_gauge(a, iters=60):
    """``(AL, AR, C)`` from a generic uniform core ``a``; the bond basis is
    fixed by the SVD of ``C`` (so ``C`` is diagonal, singular values sorted
    and normalized)."""
    al, lmat = left_gauge(a, iters)
    ar, rmat = right_gauge(a, iters)
    c = peinsum("ij,jk->ik", lmat, rmat)
    u, s, vh = torch.linalg.svd(c)
    s = s / torch.clamp(torch.linalg.norm(s), min=1e-300)
    al = peinsum("ai,dij,jb->dab", u.conj().T, al, u)
    ar = peinsum("ai,dij,jb->dab", vh, ar, vh.conj().T)
    return al, ar, torch.diag(s.to(a.dtype))


# --------------------------------------------------------------------- #
# Quasi-fixed-point MPO environments (triangular MPO, identity corners)
# --------------------------------------------------------------------- #


def _transfer_apply(al, x, left=True):
    """``T(x)`` for the AL (or AR) transfer operator on a ``(..., D, D)``."""
    if left:  # x' = sum_s AL_s^H x AL_s
        t = peinsum("...ij,djk->...dik", x, al)
        return peinsum("dji,...djk->...ik", al.conj(), t)
    t = peinsum("dij,...jk->...dik", al, x)
    return peinsum("...dik,dlk->...il", t, al.conj())


def _tr_pair(a, b):
    """``tr(a b)`` (the environment/density pairing), batched over ``b``."""
    return peinsum("ij,...ji->...", a, b)


def _t_mix_left(x, bra, ket, op):
    """Left-to-right MPO-dressed (mixed) transfer of ``x (..., D, D)``:
    ``sum_st op[s, t] bra_s^H x ket_t`` (any of ``x``, ``bra``, ``ket`` may
    carry leading batch axes)."""
    t = peinsum("...ij,...djk->...dik", x, ket)
    t = peinsum("sd,...dik->...sik", op, t)
    return peinsum("...sji,...sjk->...ik", bra.conj(), t)


def _t_mix_right(x, bra, ket, op):
    """Right-to-left mirror: ``sum_st op[s, t] ket_t x bra_s^H``."""
    t = peinsum("...dij,...jk->...dik", ket, x)
    t = peinsum("sd,...dik->...sik", op, t)
    return peinsum("...sik,...slk->...il", t, bra.conj())


def _t_dressed(x, core, op, left=True):
    """One MPO-dressed transfer step of ``x`` through ``core`` (channel
    element ``op (d, d)``)."""
    return (_t_mix_left if left else _t_mix_right)(x, core, core, op)


def _geometric_solve(core, b, density, left=True, tol=1e-10):
    """Quasi-fixed-point solve for a corner (identity) MPO channel:
    ``x - T(x) + tr(density x) I = b - tr(density b) I`` by GMRES, the
    energy-subtracted geometric series ``sum_k T^k b``.  ``T`` is the
    transfer map of the isometric core (left: adjoint fixed point
    ``density = C C^H``; right: the mirror with ``C^H C``)."""
    eye = torch.eye(core.shape[1], dtype=b.dtype, device=b.device)

    def matvec(x):
        return x - _transfer_apply(core, x, left=left) + _tr_pair(density, x) * eye

    rhs = b - _tr_pair(density, b) * eye
    sol, _ = gmres(matvec, rhs, tol=tol, atol=0.0, maxiter=200)
    return sol


def _interior_solve(core, b, op, left=True, tol=1e-10):
    """Solve ``x = b + T_op(x)`` for an interior diagonal channel whose
    dressed transfer map is a strict contraction (exponentially decaying
    interactions)."""
    sol, _ = gmres(lambda x: x - _t_dressed(x, core, op, left), b, tol=tol,
                   atol=0.0, maxiter=200)
    return sol


def _zero_channels(w):
    """Static sparsity of the MPO's channel blocks (host bool ``(W, W)``)."""
    return (w.abs().sum(dim=(0, 1)) == 0).cpu().numpy()


def mpo_environments(al, ar, c, w, tol=1e-10):
    """``(FL (W, D, D), FR (W, D, D), energy)`` for a triangular MPO cell.

    ``w (d, d, W, W)`` upper-triangular with identity at ``[0, 0]`` and
    ``[W-1, W-1]``.  The energy per site comes from the corner channels'
    divergence rate (a host float).
    """
    d, _, nw, _ = w.shape
    if nw < 2:
        raise ValueError(
            "mpo_environments needs a triangular MPO with W >= 2 "
            f"(identity corners); got W = {nw}"
        )
    bond = al.shape[1]
    dt = al.dtype
    rho_r = peinsum("ij,kj->ik", c, c.conj())  # C C^H
    rho_r = rho_r / torch.trace(rho_r)
    eye = torch.eye(bond, dtype=dt, device=al.device)
    is_zero = _zero_channels(w)

    fl = [None] * nw
    fl[0] = eye
    for a_idx in range(1, nw):
        b = torch.zeros((bond, bond), dtype=dt, device=al.device)
        for b_idx in range(a_idx):
            if fl[b_idx] is not None and not is_zero[b_idx, a_idx]:
                b = b + _t_dressed(fl[b_idx], al, w[:, :, b_idx, a_idx], True)
        if a_idx < nw - 1:
            if is_zero[a_idx, a_idx]:
                fl[a_idx] = b
            else:
                fl[a_idx] = _interior_solve(al, b, w[:, :, a_idx, a_idx],
                                            left=True, tol=tol)
        else:
            e_left = _tr_pair(rho_r, b)
            fl[a_idx] = _geometric_solve(al, b, rho_r, left=True, tol=tol)

    rho_l = peinsum("ji,jk->ik", c.conj(), c)  # C^H C
    rho_l = rho_l / torch.trace(rho_l)
    fr = [None] * nw
    fr[nw - 1] = eye
    for a_idx in range(nw - 2, -1, -1):
        b = torch.zeros((bond, bond), dtype=dt, device=al.device)
        for b_idx in range(a_idx + 1, nw):
            if fr[b_idx] is not None and not is_zero[a_idx, b_idx]:
                b = b + _t_dressed(fr[b_idx], ar, w[:, :, a_idx, b_idx], False)
        if a_idx > 0:
            if is_zero[a_idx, a_idx]:
                fr[a_idx] = b
            else:
                fr[a_idx] = _interior_solve(ar, b, w[:, :, a_idx, a_idx],
                                            left=False, tol=tol)
        else:
            e_right = _tr_pair(rho_l, b)
            fr[a_idx] = _geometric_solve(ar, b, rho_l, left=False, tol=tol)

    energy = 0.5 * torch.real(e_left + e_right)
    return torch.stack(fl), torch.stack(fr), float(energy)


# --------------------------------------------------------------------- #
# Effective Hamiltonians and the VUMPS loop
# --------------------------------------------------------------------- #


def _h_ac(fl, w, fr, ac):
    """``H_AC``: one-site effective Hamiltonian (leading batch axes of
    ``ac`` and of the environments broadcast)."""
    t = peinsum("...aij,...djk->...adik", fl, ac)
    t = peinsum("sdab,...adik->...bsik", w, t)
    return peinsum("...bsik,...bkl->...sil", t, fr)


def _h_c(fl, fr, c):
    """``H_C``: zero-site effective Hamiltonian."""
    t = peinsum("aij,jk->aik", fl, c)
    return peinsum("aik,akl->il", t, fr)


def _polar_left(m):
    """Left polar factor ``U`` of ``m = U P`` (``m`` tall), by SVD."""
    u, _, vh = torch.linalg.svd(m, full_matrices=False)
    return peinsum("ij,jk->ik", u, vh)


def _gauge_update(ac, c):
    """``(AL, AR, grad_norm)`` from ``(AC, C)`` (Zauner-Stauber polar form:
    ``AL = polar(AC) polar(C)^H``, AR mirrored)."""
    d_, bond = ac.shape[0], ac.shape[1]
    al = peinsum("ij,kj->ik", _polar_left(ac.reshape(d_ * bond, bond)),
                 _polar_left(c).conj()).reshape(d_, bond, bond)
    ar_mat = _polar_left(ac.transpose(1, 2).reshape(d_ * bond, bond))
    cr = _polar_left(c.T)
    ar = peinsum("ij,kj->ik", ar_mat, cr.conj()).reshape(
        d_, bond, bond).transpose(1, 2)
    grad = torch.linalg.norm(ac - peinsum("dij,jk->dik", al, c))
    return al, ar, grad


def vumps(mpo_cell, bond_dim, iters=60, d=None, dtype=torch.float64,
          lanczos_iters=40, generator=None, tol=1e-12, a0=None, device=None):
    """Ground state of an infinite chain, variationally, in uMPS form.

    Args:
        mpo_cell: an :class:`~.mpo.MPO` whose ``cores[0]`` is the repeated
            triangular bulk tensor (``tfim_mpo(2)``, ``heisenberg_mpo(2)``,
            ``InfiniteOpSum.to_umpo`` wrapped, ...).
        bond_dim: uMPS bond dimension.
        iters: VUMPS iterations (stops early once the gradient norm falls
            below 1e-11).
        generator: ``torch.Generator`` on ``device`` for the standard-normal
            start core (or the global one).
        a0: the start core ``(d, D, D)`` itself (overrides ``generator``).
        device: where to compute (default: the MPO's device).

    Returns:
        dict with ``al, ar, ac, c`` (mixed-gauge tensors), ``energy`` (per
        site), ``energies`` (trace) and ``gradient_norm``.
    """
    device = resolve_device(device, (mpo_cell.cores,))
    # a complex MPO silently cast to a real dtype is a WRONG Hamiltonian
    cores = mpo_cell.cores
    src = cores.dtype if isinstance(cores, torch.Tensor) else torch_dtype(
        np.asarray(cores).dtype)
    dtype = torch.promote_types(torch_dtype(dtype), src)
    w = as_tensor(cores[0], device, dtype)
    d = d or w.shape[0]
    if a0 is None:
        a0 = torch.randn((d, bond_dim, bond_dim), dtype=dtype, device=device,
                         generator=generator)
    else:
        a0 = as_tensor(a0, device, dtype)
    al, ar, c = mixed_gauge(a0)
    ac = peinsum("dij,jk->dik", al, c)

    energies = []
    grad_norm = np.inf
    for _ in range(int(iters)):
        fl, fr, energy = mpo_environments(al, ar, c, w, tol=tol)
        _, ac = lanczos_ground(lambda t: _h_ac(fl, w, fr, t), ac, lanczos_iters)
        _, c = lanczos_ground(lambda t: _h_c(fl, fr, t), c, lanczos_iters)
        al, ar, grad = _gauge_update(ac, c)
        grad_norm = float(grad)
        energies.append(energy)
        if grad_norm < 1e-11:
            break

    return {
        "al": al, "ar": ar, "ac": ac, "c": c,
        "energy": energies[-1], "energies": energies,
        "gradient_norm": grad_norm,
    }
