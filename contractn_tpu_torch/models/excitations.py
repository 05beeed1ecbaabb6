"""Quasiparticle excitations on uniform MPS: dispersion relations.

Counterpart of ``contractn_tpu/models/excitations.py``.  The tangent-space
excitation ansatz (Haegeman et al.; Vanderstraeten-Haegeman-Verstraete,
"Tangent-space methods for uniform matrix product states") builds momentum
eigenstates on a uMPS ground state,

    ``|Phi_k(B)> = sum_n e^{ikn}  ... AL AL [B]_n AR AR ...``

with ``B = VL @ X`` in the left-gauge-fixed tangent space (``VL`` spans the
null space of ``AL``), so the variational problem is a Hermitian
eigenproblem ``H_eff(k) X = omega X`` whose eigenvalues are excitation
energies above the ground state.  ``H_eff(k)`` has three parts: the on-site
map ``FL . W . FR`` on ``B``, and the left/right excitation environments
``LB``/``RB`` (channel-ordered triangular solves with a momentum phase on
every step, marginal corner modes pinned against ``C``).

The JAX package builds the dense ``H_eff`` by ``vmap`` over the ``(d-1)
D^2`` tangent basis vectors, each application running its own GMRES
solves.  Here the basis is a leading batch axis of every op: each channel's
solve is ONE batched :func:`~..ops.krylov.gmres` over all basis vectors
(every member stopping on its own residual), not ``(d-1) D^2`` serial
solves; :func:`spectral_weights` batches its overlaps the same way.
"""

import numpy as np
import torch

from ..ops.krylov import gmres
from ..ops.linalg_ad import dense_eigh
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor
from .vumps import _h_ac, _t_mix_left, _t_mix_right, mpo_environments, vumps


def _null_space_left(al):
    """``VL (d*D, (d-1)*D)``: orthonormal complement of the left isometry
    ``AL`` viewed as a ``(d*D, D)`` matrix."""
    d, bond, _ = al.shape
    q, _ = torch.linalg.qr(al.reshape(d * bond, bond), mode="complete")
    return q[:, bond:]


def _fro(a, b):
    """Frobenius pairing ``sum conj(a) b`` over the last two axes."""
    return (a.conj() * b).sum(dim=(-2, -1))


def _phase_solve(apply_t, b, phase, pvec=None, tol=1e-10):
    """Solve ``x = b + phase * T(x)`` by GMRES, batched over the leading axes
    of ``b (..., D, D)``.

    ``pvec`` projects out a marginal mode: for the identity corner channels
    the mixed transfer has eigenvalue 1 with both marginal vectors equal to
    ``C``, and the gauge fixing keeps every source orthogonal to it, so
    pinning the ``C`` component leaves the solution unchanged at ``k != 0``
    and makes the ``k = 0`` system well-conditioned.
    """
    if pvec is not None:
        nc = pvec / torch.linalg.norm(pvec)
        b = b - nc * _fro(nc, b)[..., None, None]

    def matvec(x):
        out = x - phase * apply_t(x)
        if pvec is not None:
            out = out + nc * _fro(nc, x)[..., None, None]
        return out

    sol, _ = gmres(matvec, b, tol=tol, atol=0.0, maxiter=200,
                   batch_ndim=b.dim() - 2)
    return sol


def _excitation_envs(al, ar, c, fl, fr, w, b, k, is_zero, eye_diag,
                     tol=1e-10):
    """``(LB, RB)``, each ``(..., W, D, D)``, for the batched ``b (..., d,
    D, D)``.  ``is_zero`` is the static MPO sparsity mask; ``eye_diag[ch]``
    flags identity diagonal (corner) channels, projected against ``C``."""
    nw = w.shape[2]
    ph_l = complex(np.exp(-1j * k))
    ph_r = complex(np.exp(+1j * k))
    zero = torch.zeros(b.shape[:-3] + b.shape[-2:], dtype=b.dtype,
                       device=b.device)

    lb = [None] * nw
    for ch in range(nw):
        src = zero
        for a_idx in range(ch + 1):
            if is_zero[a_idx][ch]:
                continue
            op = w[:, :, a_idx, ch]
            src = src + _t_mix_left(fl[a_idx], al, b, op)
            if a_idx < ch:
                src = src + _t_mix_left(lb[a_idx], al, ar, op)
        src = ph_l * src
        if is_zero[ch][ch]:
            lb[ch] = src
        else:
            op = w[:, :, ch, ch]
            lb[ch] = _phase_solve(lambda x, op=op: _t_mix_left(x, al, ar, op),
                                  src, ph_l, pvec=c if eye_diag[ch] else None,
                                  tol=tol)

    rb = [None] * nw
    for ch in range(nw - 1, -1, -1):
        src = zero
        for b_idx in range(ch, nw):
            if is_zero[ch][b_idx]:
                continue
            op = w[:, :, ch, b_idx]
            src = src + _t_mix_right(fr[b_idx], ar, b, op)
            if b_idx > ch:
                src = src + _t_mix_right(rb[b_idx], ar, al, op)
        src = ph_r * src
        if is_zero[ch][ch]:
            rb[ch] = src
        else:
            op = w[:, :, ch, ch]
            rb[ch] = _phase_solve(lambda x, op=op: _t_mix_right(x, ar, al, op),
                                  src, ph_r, pvec=c if eye_diag[ch] else None,
                                  tol=tol)

    return torch.stack(lb, dim=-3), torch.stack(rb, dim=-3)


def _heff_b(b, al, ar, c, fl, fr, w, k, is_zero, eye_diag, tol=1e-10):
    """The momentum-``k`` effective Hamiltonian on full ``B (..., d, D,
    D)`` tensors (before the tangent projection)."""
    lb, rb = _excitation_envs(al, ar, c, fl, fr, w, b, k, is_zero, eye_diag,
                              tol=tol)
    out = _h_ac(fl, w, fr, b)            # bra site == ket B site
    out = out + _h_ac(lb, w, fr, ar)     # B strictly left of bra site
    return out + _h_ac(fl, w, rb, al)    # B strictly right of bra site


def _heff_x(x, vl, al, ar, c, fl, fr, w, k, is_zero, eye_diag, tol=1e-10):
    """Apply the momentum-``k`` effective Hamiltonian to ``X (..., n_t,
    D)``."""
    d, bond, _ = al.shape
    b = peinsum("ij,...jk->...ik", vl, x).reshape(x.shape[:-2] + (d, bond, bond))
    out = _heff_b(b, al, ar, c, fl, fr, w, k, is_zero, eye_diag, tol=tol)
    return peinsum("ji,...jk->...ik", vl.conj(),
                   out.reshape(x.shape[:-2] + (d * bond, bond)))


def _dense_heff(vl, al, ar, c, fl, fr, w, k, is_zero, eye_diag, tol=1e-10):
    """Dense Hermitian ``H_eff(k)``: every tangent basis vector at once, as
    one batch."""
    n_t, bond = vl.shape[1], al.shape[1]
    n = n_t * bond
    basis = torch.eye(n, dtype=vl.dtype, device=vl.device).reshape(n, n_t, bond)
    cols = _heff_x(basis, vl, al, ar, c, fl, fr, w, k, is_zero, eye_diag,
                   tol=tol)
    h = cols.reshape(n, n).T
    return 0.5 * (h + h.conj().T)


def prepare_excitations(ground, mpo_cell, tol=1e-10):
    """Momentum-independent preparation: energy-subtracted MPO, ground
    environments, tangent basis, sparsity masks and the regularization
    constant ``lam0``, computed once and reused across every momentum."""
    al, ar, c = ground["al"], ground["ar"], ground["c"]
    e0 = ground["energy"]
    w = as_tensor(mpo_cell.cores[0], al.device).clone()
    d = w.shape[0]
    # subtract the ground energy density from the on-site channel so the
    # environments are finite and eigenvalues are excitation energies
    w[:, :, 0, -1] = w[:, :, 0, -1] - e0 * torch.eye(d, dtype=w.dtype,
                                                     device=w.device)
    cdt = torch.promote_types(al.dtype, torch.complex64)
    al, ar, c, w = (t.to(cdt) for t in (al, ar, c, w))
    fl, fr, _ = mpo_environments(al, ar, c, w, tol=tol)
    vl = _null_space_left(al)
    w_np = w.cpu().numpy()
    nw = w_np.shape[2]
    is_zero = tuple(tuple(bool(v) for v in row)
                    for row in (np.abs(w_np).sum(axis=(0, 1)) == 0.0))
    eye_diag = tuple(bool(np.allclose(w_np[:, :, ch, ch], np.eye(d)))
                     for ch in range(nw))
    ac = ground["ac"].to(cdt)
    lam0 = float(torch.real((ac.conj() * _h_ac(fl, w, fr, ac)).sum()
                            / (ac.conj() * ac).sum()))
    return {
        "al": al, "ar": ar, "c": c, "ac": ac, "w": w, "fl": fl,
        "fr": fr, "vl": vl, "is_zero": is_zero, "eye_diag": eye_diag,
        "lam0": lam0, "cdt": cdt,
    }


def excitation_spectrum(ground, mpo_cell, k, tol=1e-10, prep=None):
    """All quasiparticle bands at momentum ``k`` above a VUMPS ground state.

    Args:
        ground: the dict returned by :func:`~.vumps.vumps`.
        mpo_cell: the SAME MPO handed to VUMPS.
        k: momentum in ``[-pi, pi]``.
        prep: optional :func:`prepare_excitations` result, reused across
            momenta.

    Returns:
        ascending ``((d-1) D^2,)`` tensor of excitation energies relative to
        the ground state.
    """
    p = prep if prep is not None else prepare_excitations(ground, mpo_cell,
                                                          tol=tol)
    h = _dense_heff(p["vl"], p["al"], p["ar"], p["c"], p["fl"], p["fr"],
                    p["w"], float(k), p["is_zero"], p["eye_diag"], tol=tol)
    return dense_eigh(h)[0] - p["lam0"]


def quasiparticle_dispersion(mpo_cell, ks, bond_dim=12, ground=None,
                             n_bands=1, tol=1e-10, **vumps_kwargs):
    """Lowest ``n_bands`` excitation energies at each momentum (VUMPS once
    unless ``ground`` is given).  Returns ``(ground, omegas)`` with
    ``omegas`` a ``(len(ks), n_bands)`` numpy array."""
    if ground is None:
        ground = vumps(mpo_cell, bond_dim, **vumps_kwargs)
    prep = prepare_excitations(ground, mpo_cell, tol=tol)
    omegas = np.stack([
        excitation_spectrum(ground, mpo_cell, k, tol=tol,
                            prep=prep).cpu().numpy()[:n_bands]
        for k in ks
    ])
    return ground, omegas


# --------------------------------------------------------------------- #
# Spectral weights (dynamical structure factor poles)
# --------------------------------------------------------------------- #


def _e_left_mix(al, ar):
    """The (bra ``AL``, ket ``AR``) right-to-left mixed transfer and its
    Frobenius adjoint, batched over the leading axes of their argument."""

    def e_left(z):
        t = peinsum("sjk,...bk->...sbj", ar, z)
        return peinsum("sib,...sbj->...ij", al.conj(), t)

    def e_left_adj(y):
        return peinsum("sib,...ij,sjk->...bk", al, y, ar.conj())

    return e_left, e_left_adj


def _power_pair(f_right, f_left, bond, dtype, device, iters):
    """Dominant (right, left) eigenvectors of a marginal map and its
    adjoint by ``iters`` power steps from a fixed start."""
    def power(f):
        v = torch.ones((bond, bond), dtype=dtype, device=device)
        v = v + 0.3 * torch.arange(bond, device=device).to(dtype)[None, :]
        for _ in range(int(iters)):
            w = f(v)
            v = w / torch.clamp(torch.linalg.norm(w), min=1e-300)
        return v

    rv, lv = power(f_right), power(f_left)
    return rv, lv, _fro(lv, rv)


def _deflation_pair(al, ar, dtype, iters=80):
    """Dominant (right, left) eigenvectors of the marginal mixed transfer,
    computed once and shared by every overlap."""
    e_left, e_left_adj = _e_left_mix(al, ar)
    return _power_pair(e_left, e_left_adj, al.shape[1], dtype, al.device, iters)


def _overlap_g(b, al, ar, ac, op, k, defl, tol=1e-10):
    """``G(B) = <Phi_k(B)| O_k |GS>`` per site for a batch ``b (..., d, D,
    D)``: the on-site class and the strictly-left class (a deflated
    marginal-mode GMRES solve, ``e^{-ik}`` per step); the strictly-right
    class vanishes by the left gauge fixing."""
    oac = peinsum("st,tij->sij", op, ac)
    g = peinsum("...sij,sij->...", b.conj(), oac)
    z1 = peinsum("...sbc,skc->...bk", b.conj(), ar)
    phl = complex(np.exp(-1j * k))
    e_left, _ = _e_left_mix(al, ar)
    rv, lv, denom = defl

    def deflate(x):
        return x - rv * (_fro(lv, x) / denom)[..., None, None]

    geol = _phase_solve(lambda z: e_left(deflate(z)), deflate(z1), phl, tol=tol)
    return g + phl * peinsum("sab,sak,...bk->...", al.conj(), oac, deflate(geol))


def spectral_weights(ground, mpo_cell, op, k, tol=1e-10, prep=None):
    """Excitation energies and spectral weights of a one-site operator:
    ``S_O(k, w) = sum_a |<Phi_k(B_a)| O_k |GS>|^2 delta(w - w_a)`` in the
    tangent space.  ``prep`` (from :func:`prepare_excitations`) is reused
    across momenta, and caches the momentum-independent deflation pair.

    Returns ``(omegas, weights)``: ascending energies and matching per-site
    pole weights (tensors).
    """
    p = prep if prep is not None else prepare_excitations(ground, mpo_cell,
                                                          tol=tol)
    al, ar, c, ac, w = p["al"], p["ar"], p["c"], p["ac"], p["w"]
    vl, fl, fr, cdt = p["vl"], p["fl"], p["fr"], p["cdt"]
    d = w.shape[0]
    op = as_tensor(op, al.device, cdt)
    # subtract the disconnected part so G measures the CONNECTED weight
    op = op - (peinsum("st,tij,sij->", op, ac, ac.conj())
               / peinsum("sij,sij->", ac, ac.conj())) * torch.eye(
        d, dtype=cdt, device=al.device)
    h = _dense_heff(vl, al, ar, c, fl, fr, w, float(k), p["is_zero"],
                    p["eye_diag"], tol=tol)
    omegas, vecs = dense_eigh(h)
    n_t, bond = vl.shape[1], al.shape[1]
    n = n_t * bond
    basis = torch.eye(n, dtype=cdt, device=al.device).reshape(n, n_t, bond)
    defl = p.get("defl")
    if defl is None:
        defl = _deflation_pair(al, ar, cdt)
        p["defl"] = defl  # k-independent: cache for the next momentum
    b = peinsum("ij,...jk->...ik", vl, basis).reshape((n,) + tuple(al.shape))
    src = _overlap_g(b, al, ar, ac, op, float(k), defl, tol=tol)
    amps = peinsum("ji,j->i", vecs.conj(), src)
    return omegas - p["lam0"], amps.abs() ** 2


def unfolded_bands(mpo, kappas, op, block=2, bond_dim=16, ground=None,
                   tol=1e-10, **vumps_kwargs):
    """Extended-zone (per-site momentum) spectral map of a ``block``-periodic
    chain (ARPES-style band unfolding): per ``kappa`` the dominant pole's
    energy and its weight share of the per-site-momentum operator
    ``O(kappa) = sum_p e^{i kappa p} O_p`` on the folded chain.

    Returns ``(ground, omegas, weights)`` (numpy arrays).
    """
    from .mpo import block_mpo

    blocked = block_mpo(mpo, block)
    if ground is None:
        ground = vumps(blocked, bond_dim, **vumps_kwargs)
    prep = prepare_excitations(ground, blocked, tol=tol)
    op = np.asarray(op)
    d = op.shape[0]
    eye = np.eye(d)
    omegas_out, shares = [], []
    for kappa in kappas:
        kk = float(kappa)
        opf = np.zeros((d ** block, d ** block), complex)
        for p in range(block):
            m = np.eye(1)
            for q in range(block):
                m = np.kron(m, op if q == p else eye)
            opf = opf + np.exp(1j * kk * p) * m
        om, wt = spectral_weights(ground, blocked, opf, float(block) * kk,
                                  tol=tol, prep=prep)
        om, wt = om.cpu().numpy(), wt.cpu().numpy()
        idx = int(np.argmax(wt))
        omegas_out.append(float(om[idx]))
        total = float(np.sum(wt))
        shares.append(float(wt[idx]) / total if total > 0 else 0.0)
    return ground, np.asarray(omegas_out), np.asarray(shares)


def dynamic_structure_factor(ground, mpo_cell, op, ks, omegas, eta=0.05,
                             tol=1e-10):
    """Lorentzian-broadened ``S(k, w)`` map from the tangent-space poles:
    one :func:`spectral_weights` diagonalization per momentum; returns a
    ``(len(ks), len(omegas))`` numpy array."""
    ks = np.atleast_1d(np.asarray(ks, float))
    omegas = np.atleast_1d(np.asarray(omegas, float))
    out = np.zeros((ks.size, omegas.size))
    prep = prepare_excitations(ground, mpo_cell, tol=tol)
    for i, k in enumerate(ks):
        om, wt = spectral_weights(ground, mpo_cell, op, float(k), tol=tol,
                                  prep=prep)
        om, wt = om.cpu().numpy(), wt.cpu().numpy()
        lor = (eta / np.pi) / ((omegas[None, :] - om[:, None]) ** 2 + eta * eta)
        out[i] = np.matmul(wt, lor)
    return out
