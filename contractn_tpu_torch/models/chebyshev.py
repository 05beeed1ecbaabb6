"""Chebyshev / kernel-polynomial spectral functions on MPS.

Counterpart of ``contractn_tpu/models/chebyshev.py``.  The zero-temperature
spectral function ``S_O(w) = sum_n |<n|O|0>|^2 delta(w - (E_n - E_0))`` is
expanded in Chebyshev polynomials of the rescaled Hamiltonian
``H' = (H - b)/a`` (spectrum mapped into ``[-1+eps/2, 1-eps/2]``): the
moments ``mu_k = <0|O+ T_k(H') O|0>`` come from the MPS recurrence
``|t_{k+1}> = 2 H'|t_k> - |t_{k-1}>`` — one exact MPO application plus one
two-term combination with SVD compression per moment — and the spectrum is
rebuilt with the Jackson kernel (Holzner et al., PRB 83, 195115; Weisse et
al., RMP 78, 275).

:func:`chebyshev_moments` compresses adaptively (:func:`~.canonical.compress`,
host-side ranks); :func:`chebyshev_moments_scanned` uses the fixed-``chi``
compression (:func:`~.canonical.compress_fixed`), reads nothing on the host
inside the recurrence, and collects the moments once at the end.
"""

import math

import numpy as np
import torch

from ..ops.stabilize import peinsum
from .boundary import apply_mpo_to_mps
from .canonical import compress, compress_fixed, mps_add
from .mpo import MPO, mpo_sum
from .mps import MPS


def _identity_mpo(n, d, dtype, device):
    eye = torch.eye(d, dtype=dtype, device=device)[None, :, :, None, None]
    one = torch.ones((1,), dtype=dtype, device=device)
    return MPO(eye.expand(n, d, d, 1, 1).contiguous(), one, one)


def rescaled_mpo(h_mpo, bounds, eps=0.025):
    """``H' = (H - b)/a`` with the spectral window ``bounds = (emin, emax)``
    mapped into ``[-1 + eps/2, 1 - eps/2]``.  Returns ``(h_prime, a, b)``;
    loose bounds only cost resolution."""
    emin, emax = float(bounds[0]), float(bounds[1])
    if not emax > emin:
        raise ValueError("bounds must satisfy emax > emin")
    a = (emax - emin) / (2.0 - eps)
    b = (emax + emin) / 2.0
    n, d = h_mpo.cores.shape[0], h_mpo.cores.shape[1]
    ident = _identity_mpo(n, d, h_mpo.cores.dtype, h_mpo.cores.device)
    shifted = mpo_sum(h_mpo, MPO(ident.cores, -b * ident.left, ident.right))
    return MPO(shifted.cores, shifted.left / a, shifted.right), a, b


def apply_site_ops(mps, site_ops):
    """Apply one-site operators ``[(site, matrix), ...]`` to an MPS (exact,
    bond unchanged); matrices go to the MPS's device."""
    device = mps.cores.device
    ops = [(site, torch.as_tensor(np.asarray(op) if not isinstance(
        op, torch.Tensor) else op).to(device)) for site, op in site_ops]
    dt = mps.cores.dtype
    for _, op in ops:
        dt = torch.promote_types(dt, op.dtype)
    cores = mps.cores.to(dt).clone()
    for site, op in ops:
        cores[site] = peinsum("sS,SDE->sDE", op.to(dt), cores[site])
    return MPS(cores, mps.left.to(dt), mps.right.to(dt))


def _keep_scale(compressed):
    out, log_norm, _ = compressed
    return MPS(out.cores, out.left * math.exp(float(log_norm)), out.right)


def _inner_value(bra, ket):
    v, log = bra.inner(ket)
    return complex(v * torch.exp(log))


def chebyshev_moments(h_mpo, psi0, op_sites, n_moments, bounds, max_bond=32,
                      eps=0.025):
    """KPM moments ``mu_k = <0|O+ T_k(H') O|0>``, ``k < n_moments``.

    Args:
        h_mpo: Hamiltonian MPO.
        psi0: the reference state ``|0>`` (normalized MPS — usually a DMRG
            ground state).
        op_sites: the probe ``O`` as one-site factors ``[(site, matrix)]``.
        n_moments: number of moments ``N`` (resolution ``~ pi a / N``).
        bounds: spectral envelope ``(emin, emax)`` of ``H``.
        max_bond: SVD compression bond for the Chebyshev vectors.

    Returns ``(moments, a, b)``: complex numpy ``(N,)`` and the rescaling.
    """
    hp, a, b = rescaled_mpo(h_mpo, bounds, eps=eps)
    phi = apply_site_ops(psi0, op_sites)
    t_prev = phi
    moments = [_inner_value(phi, t_prev)]
    if n_moments == 1:
        return np.asarray(moments), a, b
    t_cur = _keep_scale(compress(apply_mpo_to_mps(hp, phi), max_bond=max_bond))
    moments.append(_inner_value(phi, t_cur))
    for _ in range(2, n_moments):
        ht = apply_mpo_to_mps(hp, t_cur)
        two_ht = MPS(ht.cores, 2.0 * ht.left, ht.right)
        neg_prev = MPS(t_prev.cores, -t_prev.left, t_prev.right)
        t_next = _keep_scale(mps_add(two_ht, neg_prev, max_bond=max_bond))
        moments.append(_inner_value(phi, t_next))
        t_prev, t_cur = t_cur, t_next
    return np.asarray(moments), a, b


def _pad_bond(mps, chi):
    """Zero-pad an MPS to uniform bond ``chi`` (exact embedding)."""
    n, d, db, _ = mps.cores.shape
    if db > chi:
        raise ValueError(f"bond {db} exceeds the target {chi}")
    cores = mps.cores.new_zeros((n, d, chi, chi))
    cores[:, :, :db, :db] = mps.cores
    left = mps.cores.new_zeros((chi,))
    left[:db] = mps.left
    right = mps.cores.new_zeros((chi,))
    right[:db] = mps.right
    return MPS(cores, left, right)


def chebyshev_moments_scanned(h_mpo, psi0, op_sites, n_moments, bounds,
                              max_bond=32, eps=0.025):
    """:func:`chebyshev_moments` with the fixed-``chi`` recurrence: each step
    is exact MPO application + direct sum + ``compress_fixed``, and the
    split-format moment pieces stay on the device until the end (one host
    read for the whole series).  Same truncation rank per step as the JAX
    package's ``lax.scan`` version."""
    hp, a, b = rescaled_mpo(h_mpo, bounds, eps=eps)
    phi = apply_site_ops(psi0, op_sites)
    dt = torch.promote_types(phi.cores.dtype, hp.cores.dtype)
    phi = MPS(phi.cores.to(dt), phi.left.to(dt), phi.right.to(dt))
    hp = MPO(hp.cores.to(dt), hp.left.to(dt), hp.right.to(dt))
    phi_p = _pad_bond(phi, max_bond)
    moments = [_inner_value(phi, phi)]
    if n_moments == 1:
        return np.asarray(moments), a, b

    def fixed(state):
        out, log_norm, _ = compress_fixed(state, max_bond)
        return MPS(out.cores, torch.exp(log_norm) * out.left, out.right)

    t_prev, t_cur = phi_p, fixed(apply_mpo_to_mps(hp, phi_p))
    moments.append(_inner_value(phi_p, t_cur))
    pieces = []
    for _ in range(int(n_moments) - 2):
        ht = apply_mpo_to_mps(hp, t_cur)
        summed = mps_add(MPS(ht.cores, 2.0 * ht.left, ht.right),
                         MPS(t_prev.cores, -t_prev.left, t_prev.right))
        t_prev, t_cur = t_cur, fixed(summed)
        pieces.append(phi_p.inner(t_cur))
    if pieces:
        vs, lgs = (torch.stack(p).cpu().numpy() for p in zip(*pieces))
        moments.extend((vs * np.exp(lgs)).tolist())
    return np.asarray(moments), a, b


def jackson_kernel(n_moments):
    """Jackson damping factors ``g_k`` (optimal positive kernel)."""
    k = np.arange(n_moments)
    q = np.pi / (n_moments + 1)
    return ((n_moments - k + 1) * np.cos(q * k)
            + np.sin(q * k) / np.tan(q)) / (n_moments + 1)


def spectral_function(moments, a, b, w_grid, e0=0.0, kernel="jackson"):
    """Reconstruct ``S(w)`` on ``w_grid`` from KPM moments (host numpy).

    ``w`` is measured relative to ``e0``: the reduced variable is
    ``x = (w + e0 - b)/a`` and the density carries the ``1/a`` Jacobian, so
    ``integral S(w) dw = mu_0``.  Points outside the reduced band are zero.
    """
    n_moments = len(moments)
    if kernel == "jackson":
        g = jackson_kernel(n_moments)
    elif kernel is None or kernel == "dirichlet":
        g = np.ones(n_moments)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    x = (np.asarray(w_grid, float) + e0 - b) / a
    inside = np.abs(x) < 1.0
    xs = np.clip(x, -1.0, 1.0)
    tk = np.cos(np.outer(np.arccos(xs), np.arange(n_moments)))
    coeff = g * np.real(np.asarray(moments))
    coeff[1:] *= 2.0
    dens = np.matmul(tk, coeff) / (
        np.pi * np.sqrt(np.maximum(1.0 - xs**2, 1e-300)))
    return np.where(inside, dens / a, 0.0)
