"""Correction-vector dynamical DMRG: spectral functions at fixed omega.

Counterpart of ``contractn_tpu/models/dynamical.py``.  With ``K = (w + E0) I
- H`` the resolvent splits into real arithmetic, ``1/(K + i eta) = (K - i
eta)/(K^2 + eta^2)``, so one Hermitian positive-definite solve

    ``(K^2 + eta^2) |y> = |b>,    |b> = B |0>``

yields the complex Green's function: ``Im G = -eta <b|y>``, ``Re G = <b|K
y>``.  The solve rides :func:`~.linsolve.mps_linear_solve`; ``K^2`` is exact
MPO algebra.

The whole frequency grid (:func:`cv_greens_function_batched`): ``A(w) = ((w
+ E0) - H)^2 + eta^2`` has frequency-INDEPENDENT cores — the shift enters
only through the left boundary vector — so every frequency shares one
operator with a ``(n_w, W)`` batch of left vectors.  The JAX package
``jit(vmap)``s the ALS over that batch; here the frequency is a leading
axis of every op of one two-site ALS sweep (environments, CG matvecs, and
the truncating SVD splits as one batched call), never a loop over
frequencies.
"""

import math

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor
from .boundary import apply_mpo_to_mps
from .canonical import compress_mpo
from .dmrg import (
    _heff_matvec,
    _ragged_sites,
    _split_theta,
    _update_left,
    _update_right,
)
from .linsolve import mps_linear_solve
from .mpo import MPO, mpo_multiply, mpo_sum
from .mps import MPS


def scale_mpo(mpo, c):
    """``c * O`` exactly, through the left boundary vector."""
    return MPO(mpo.cores, c * mpo.left, mpo.right)


def apply_site_operator(mps, op, site):
    """``(I x .. x op_site x .. x I) |mps>`` — a one-site operator applied on
    the physical leg (no bond growth)."""
    op = as_tensor(op, mps.cores.device)
    dt = torch.promote_types(op.dtype, mps.cores.dtype)
    cores = mps.cores.to(dt).clone()
    cores[site] = peinsum("st,tjq->sjq", op, cores[site])
    return MPS(cores, mps.left.to(dt), mps.right.to(dt))


def _identity(h_mpo):
    n, d = int(h_mpo.cores.shape[0]), int(h_mpo.cores.shape[1])
    return MPO.identity(n, d, dtype=h_mpo.cores.dtype, device=h_mpo.cores.device)


def shifted_normal_mpo(h_mpo, shift, eta, compress_bond=None):
    """``A = K^2 + eta^2`` with ``K = shift*I - H`` (Hermitian PD); returns
    ``(a_mpo, k_mpo)``, ``A`` compressed to ``compress_bond`` when given."""
    ident = _identity(h_mpo)
    k_mpo = mpo_sum(scale_mpo(ident, shift), scale_mpo(h_mpo, -1.0))
    a_mpo = mpo_sum(mpo_multiply(k_mpo, k_mpo), scale_mpo(ident, eta * eta))
    if compress_bond is not None:
        comp, log_norm, _ = compress_mpo(a_mpo, max_bond=compress_bond)
        a_mpo = MPO(comp.cores, math.exp(log_norm) * comp.left, comp.right)
    return a_mpo, k_mpo


def _inner(a, b):
    v, log = a.inner(b)
    return complex(v) * float(np.exp(float(log)))


def correction_vector(h_mpo, e0, b_mps, omega, eta, max_bond=None, sweeps=6,
                      cg_iters=64, compress_bond=None, x0=None):
    """Solve ``(K^2 + eta^2)|y> = |b>`` at ``K = (omega + e0) - H``.  Returns
    ``(y, g)``: the correction vector (a warm start for the next frequency)
    and ``g = <b|K|y> - i eta <b|y>``."""
    a_mpo, k_mpo = shifted_normal_mpo(h_mpo, omega + e0, eta,
                                      compress_bond=compress_bond)
    y, _ = mps_linear_solve(a_mpo, b_mps, x0=x0, sweeps=sweeps,
                            max_bond=max_bond, cg_iters=cg_iters)
    ky = apply_mpo_to_mps(k_mpo, y)
    return y, _inner(b_mps, ky) - 1j * eta * _inner(b_mps, y)


def cv_greens_function(h_mpo, ground, e0, op, site, omegas, eta, max_bond=None,
                       sweeps=6, cg_iters=64, compress_bond=None):
    """``G(w) = <0|B+ [w + E0 - H + i eta]^{-1} B|0>`` on a frequency grid,
    ``B`` a one-site operator at ``site``; consecutive frequencies
    warm-start from the previous correction vector.  Returns the complex
    numpy ``(len(omegas),)`` array, normalized by ``<0|0>``."""
    b_mps = apply_site_operator(ground, op, site)
    norm = _inner(ground, ground).real
    out = []
    y = None
    for w in np.atleast_1d(omegas):
        y, g = correction_vector(h_mpo, e0, b_mps, float(w), eta,
                                 max_bond=max_bond, sweeps=sweeps,
                                 cg_iters=cg_iters,
                                 compress_bond=compress_bond, x0=y)
        out.append(g / norm)
    return np.asarray(out)


def cv_spectral_function(h_mpo, ground, e0, op, site, omegas, eta, **kwargs):
    """``S(w) = -(1/pi) Im G(w)``, an eta-broadened local spectral
    function (kwargs as :func:`cv_greens_function`)."""
    g = cv_greens_function(h_mpo, ground, e0, op, site, omegas, eta, **kwargs)
    return -g.imag / np.pi


# --------------------------------------------------------------------- #
# The whole frequency grid as one batched computation
# --------------------------------------------------------------------- #


def _freq_family(h_mpo, eta):
    """Static ``(K, A)`` templates and the per-shift boundary-vector maps
    (host numpy)."""
    ident = _identity(h_mpo)
    k_t = mpo_sum(ident, scale_mpo(h_mpo, -1.0))  # shift = 1 template
    a_t = mpo_sum(mpo_multiply(k_t, k_t), scale_mpo(ident, eta * eta))
    h_left = h_mpo.left.detach().cpu().numpy()

    def k_left(shift):
        return np.concatenate([[shift], -h_left])

    def a_left(shift):
        kl = k_left(shift)
        return np.concatenate([np.kron(kl, kl), [eta * eta]])

    return k_t, a_t, k_left, a_left


def _bvdot(x, y):
    """Per-member ``Re <x, y>`` over the four block axes: ``(K,)``."""
    return torch.real((x.conj() * y).sum(dim=(-4, -3, -2, -1)))


def _bcast(v):
    return v[:, None, None, None, None]


def _local_cg_batched(L, w1, w2, R, rhs, theta0, iters):
    """Conjugate gradient on ``A_eff theta = rhs`` for every member of the
    leading axis at once (fixed iteration count, converged members masked,
    no host read)."""

    def matvec(t):
        return _heff_matvec(L, w1, w2, R, t)

    r = rhs - matvec(theta0)
    x, p = theta0, r
    rs = _bvdot(r, r)
    tol2 = 1e-28 * torch.clamp(_bvdot(rhs, rhs), min=1e-300)
    zero = torch.zeros_like(rs)
    for _ in range(iters):
        live = rs > tol2
        ap = matvec(p)
        denom = _bvdot(p, ap)
        alpha = torch.where(live & (denom > 0),
                            rs / torch.clamp(denom, min=1e-300), zero)
        x = x + _bcast(alpha).to(x.dtype) * p
        r = r - _bcast(alpha).to(x.dtype) * ap
        rs_new = _bvdot(r, r)
        beta = torch.where(live, rs_new / torch.clamp(rs, min=1e-300), zero)
        p = r + _bcast(beta).to(x.dtype) * p
        rs = rs_new
    return x


def _ovl_left(lg, b, y):
    return peinsum("...ab,dax,...dby->...xy", lg, b.conj(), y)


def _ovl_right(rg, b, y):
    return peinsum("...xy,dax,...dby->...ab", rg, b.conj(), y)


def _rhs(lg, b1, b2, rg):
    """The local two-site image of ``|b>`` for the current overlap
    environments (batched ``_penalty_vector``)."""
    t = peinsum("...ab,dax->...dxb", lg.conj(), b1)
    t = peinsum("...dxb,exy->...deby", t, b2)
    return peinsum("...deby,...yq->...debq", t, rg.conj())


def _solve_batched(a_cores, a_lefts, a_right, bs, sweeps, max_bond, cg_iters):
    """Two-site ALS for ``A |y_k> = |b>`` with the ``K`` left vectors
    ``a_lefts (K, W)`` of one shared operator, every op batched over
    ``K``."""
    n = len(bs)
    k = a_lefts.shape[0]
    dt = bs[0].dtype
    sites = [b.expand((k,) + tuple(b.shape)).clone() for b in bs]
    L = [None] * (n + 1)
    R = [None] * (n + 1)
    L[0] = a_lefts.to(dt)[:, None, :, None]
    R[n] = a_right.to(dt)[None, :, None]
    lb = [None] * (n + 1)
    rb = [None] * (n + 1)
    lb[0] = rb[n] = torch.ones((1, 1), dtype=dt, device=bs[0].device)
    for i in range(n - 1, 0, -1):
        R[i] = _update_right(R[i + 1], sites[i], a_cores[i])
        rb[i] = _ovl_right(rb[i + 1], bs[i], sites[i])

    def solve(i, to_left):
        theta0 = peinsum("...apj,...bjq->...abpq", sites[i], sites[i + 1])
        rhs = _rhs(lb[i], bs[i], bs[i + 1], rb[i + 2])
        theta = _local_cg_batched(L[i], a_cores[i], a_cores[i + 1], R[i + 2],
                                  rhs, theta0, cg_iters)
        t1, t2 = _split_theta(theta, max_bond, to_left=to_left)
        scale = torch.linalg.vector_norm(theta, dim=(-4, -3, -2, -1)).to(dt)
        scale = scale[:, None, None, None]
        sites[i], sites[i + 1] = (t1, scale * t2) if to_left else (scale * t1, t2)

    for _ in range(sweeps):
        for i in range(n - 1):
            solve(i, True)
            L[i + 1] = _update_left(L[i], sites[i], a_cores[i])
            lb[i + 1] = _ovl_left(lb[i], bs[i], sites[i])
        for i in range(n - 2, -1, -1):
            solve(i, False)
            R[i + 1] = _update_right(R[i + 2], sites[i + 1], a_cores[i + 1])
            rb[i + 1] = _ovl_right(rb[i + 2], bs[i + 1], sites[i + 1])
    return sites


def _overlap_batched(bs, ys):
    t = torch.ones((1, 1), dtype=bs[0].dtype, device=bs[0].device)
    for bi, yi in zip(bs, ys):
        t = peinsum("...xy,dxp,...dyq->...pq", t, bi.conj(), yi)
    return t[..., 0, 0]


def _sandwich_batched(bs, k_cores, k_lefts, k_right, ys):
    t = k_lefts.to(bs[0].dtype)[:, None, :, None]  # (K, bra, W, ket)
    for bi, ki, yi in zip(bs, k_cores, ys):
        t = peinsum("...iwp,...bpq->...iwbq", t, yi)
        t = peinsum("abwv,...iwbq->...iavq", ki, t)
        t = peinsum("aij,...iavq->...jvq", bi.conj(), t)
    return peinsum("...jvq,v->...jq", t, k_right)[..., 0, 0]


def cv_greens_function_batched(h_mpo, ground, e0, op, site, omegas, eta,
                               max_bond=None, sweeps=6, cg_iters=64):
    """The full frequency grid of ``G(w)`` as one batched computation.

    Same contract as :func:`cv_greens_function`; every frequency solves from
    ``x0 = b`` concurrently, the frequency a leading axis of every op (no
    operator compression: the squared bond ``(W+1)^2 + 1`` is static).
    Returns the complex numpy ``(len(omegas),)`` array.
    """
    omegas = np.atleast_1d(np.asarray(omegas, float))
    bky, by, norm = _cv_batched_terms(h_mpo, ground, e0, op, site, omegas, eta,
                                      max_bond, sweeps, cg_iters, slice(None))
    return (bky.cpu().numpy() - 1j * eta * by.cpu().numpy()) / norm


def _cv_batched_terms(h_mpo, ground, e0, op, site, omegas, eta, max_bond, sweeps,
                      cg_iters, members):
    """``(<b|K|y>, <b|y>, <g|g>)`` of the batched solve for the frequencies
    ``omegas[members]``: the per-frequency body a sharded grid runs on its
    slice."""
    b_mps = apply_site_operator(ground, op, site)
    bs = _ragged_sites(b_mps)
    norm = _inner(ground, ground).real
    k_t, a_t, k_left_fn, a_left_fn = _freq_family(h_mpo, eta)
    n = len(bs)
    max_bond = max_bond or b_mps.bond_dim
    device = bs[0].device
    shifts = omegas[members] + e0
    k_lefts = as_tensor(np.stack([k_left_fn(s) for s in shifts]), device)
    a_lefts = as_tensor(np.stack([a_left_fn(s) for s in shifts]), device)
    dt = bs[0].dtype
    a_cores = [a_t.cores[i].to(dt) for i in range(n)]
    k_cores = [k_t.cores[i].to(dt) for i in range(n)]
    ys = _solve_batched(a_cores, a_lefts, a_t.right, bs, int(sweeps),
                        int(max_bond), int(cg_iters))
    by = _overlap_batched(bs, ys)
    bky = _sandwich_batched(bs, k_cores, k_lefts, k_t.right.to(dt), ys)
    return bky, by, norm


def cv_spectral_function_batched(h_mpo, ground, e0, op, site, omegas, eta,
                                 **kwargs):
    """``-(1/pi) Im G`` over the grid, one batched computation."""
    g = cv_greens_function_batched(h_mpo, ground, e0, op, site, omegas, eta,
                                   **kwargs)
    return -g.imag / np.pi
