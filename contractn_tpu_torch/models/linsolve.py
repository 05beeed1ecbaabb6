"""Linear systems in MPS form: ``A |x> = |b>`` by two-site ALS.

Counterpart of ``contractn_tpu/models/linsolve.py``.  Given an MPO ``A``
(Hermitian positive definite) and an MPS ``|b>``, sweep a two-site window
minimizing ``(1/2) <x|A|x> - Re <b|x>`` — whose stationary point is the
solution — solving each local problem ``A_eff theta = b_eff`` by conjugate
gradients on the same environment matvec DMRG uses
(:func:`~.dmrg._heff_matvec`; the effective operator is never formed), and
splitting by SVD so the bond adapts up to ``max_bond``.  The CG runs a
fixed number of iterations with converged directions masked, not branched,
so it reads nothing on the host; a local solve reads its final residual.

General (non-Hermitian or indefinite) systems go through the normal
equations ``(A+ A) x = A+ b`` (:func:`normal_equations`).
"""

import math

import numpy as np
import torch

from ..ops.stabilize import peinsum
from .boundary import apply_mpo_to_mps
from .canonical import mps_add
from .dmrg import (
    _boundary,
    _heff_matvec,
    _ovl_left_update,
    _ovl_right_update,
    _penalty_vector,
    _ragged_sites,
    _rebuild_uniform,
    _split_theta,
    _update_left,
    _update_right,
)
from .mpo import mpo_dagger, mpo_multiply
from .mps import MPS


def _vdot_re(x, y):
    return torch.real((x.conj() * y).sum())


def _local_cg(L, w1, w2, R, rhs, theta0, iters):
    """Conjugate gradient on ``A_eff theta = rhs`` (Hermitian PD ``A_eff``
    applied through the DMRG environment matvec).  Static iteration count;
    converged directions are masked, not branched.  Returns ``(theta,
    residual norm)`` as tensors."""

    def matvec(t):
        return _heff_matvec(L, w1, w2, R, t)

    r = rhs - matvec(theta0)
    x, p = theta0, r
    rs = _vdot_re(r, r)
    tol2 = 1e-28 * torch.clamp(_vdot_re(rhs, rhs), min=1e-300)
    zero = torch.zeros((), dtype=rs.dtype, device=rs.device)
    for _ in range(iters):
        live = rs > tol2
        ap = matvec(p)
        denom = _vdot_re(p, ap)
        alpha = torch.where(live & (denom > 0),
                            rs / torch.clamp(denom, min=1e-300), zero).to(x.dtype)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _vdot_re(r, r)
        beta = torch.where(live, rs_new / torch.clamp(rs, min=1e-300),
                           zero).to(x.dtype)
        p = r + beta * p
        rs = rs_new
    return x, torch.sqrt(torch.clamp(rs, min=0.0))


def mps_linear_solve(a_mpo, b_mps, x0=None, sweeps=6, max_bond=None,
                     cg_iters=64):
    """Solve ``A |x> = |b>`` for Hermitian positive definite ``A``.

    Args:
        a_mpo: the operator (HPD; wrap general systems with
            :func:`normal_equations` first).
        b_mps: right-hand side.
        x0: initial guess (default: ``b``).
        sweeps: full left-right + right-left ALS sweeps.
        max_bond: solution bond cap (pass what the solution needs).
        cg_iters: local conjugate-gradient iterations.

    Returns ``(x, local_residuals)``: the solution MPS and the per-sweep
    final local CG residual (host floats; use :func:`linear_residual` for
    the true global residual).
    """
    n = b_mps.n_sites
    if n < 2:
        raise ValueError("mps_linear_solve needs at least 2 sites")
    if x0 is None:
        x0 = b_mps
    max_bond = max_bond or max(x0.bond_dim, b_mps.bond_dim)
    sites = _ragged_sites(x0)
    bs = _ragged_sites(b_mps)
    ws = [a_mpo.cores[i] for i in range(n)]
    dt = torch.promote_types(torch.promote_types(sites[0].dtype, bs[0].dtype),
                             ws[0].dtype)
    sites = [s.to(dt) for s in sites]
    bs = [b.to(dt) for b in bs]
    ws = [w.to(dt) for w in ws]
    device = sites[0].device

    L = [None] * (n + 1)
    R = [None] * (n + 1)
    L[0] = _boundary(a_mpo.left, dt, device)
    R[n] = _boundary(a_mpo.right, dt, device)
    lb = [None] * (n + 1)
    rb = [None] * (n + 1)
    lb[0] = rb[n] = torch.ones((1, 1), dtype=dt, device=device)
    for i in range(n - 1, 0, -1):
        R[i] = _update_right(R[i + 1], sites[i], ws[i])
        rb[i] = _ovl_right_update(rb[i + 1], bs[i], sites[i])

    def solve(i, to_left):
        theta0 = peinsum("apj,bjq->abpq", sites[i], sites[i + 1])
        rhs = _penalty_vector(lb[i], bs[i], bs[i + 1], rb[i + 2])
        theta, res = _local_cg(L[i], ws[i], ws[i + 1], R[i + 2], rhs, theta0,
                               int(cg_iters))
        t1, t2 = _split_theta(theta, max_bond, to_left=to_left)
        # _split_theta normalizes; restore the solution's scale
        scale = torch.linalg.norm(theta.reshape(-1)).to(dt)
        sites[i], sites[i + 1] = (t1, scale * t2) if to_left else (scale * t1, t2)
        return res

    residuals = []
    res = np.inf
    for _ in range(sweeps):
        for i in range(n - 1):
            res = solve(i, True)
            L[i + 1] = _update_left(L[i], sites[i], ws[i])
            lb[i + 1] = _ovl_left_update(lb[i], bs[i], sites[i])
        for i in range(n - 2, -1, -1):
            res = solve(i, False)
            R[i + 1] = _update_right(R[i + 2], sites[i + 1], ws[i + 1])
            rb[i + 1] = _ovl_right_update(rb[i + 2], bs[i + 1], sites[i + 1])
        residuals.append(float(res))
    return _rebuild_uniform(sites, dt), residuals


def normal_equations(a_mpo, b_mps, compress_bond=None):
    """``(A+ A, A+ b)`` for general systems: feed the pair to
    :func:`mps_linear_solve` (the normal operator is HPD whenever ``A`` has
    full column rank).  ``compress_bond`` optionally SVD-compresses the
    squared operator."""
    ada = mpo_multiply(mpo_dagger(a_mpo), a_mpo)
    if compress_bond is not None:
        from .canonical import compress_mpo

        ada, log_norm, _ = compress_mpo(ada, max_bond=compress_bond)
        ada = type(ada)(ada.cores, math.exp(float(log_norm)) * ada.left,
                        ada.right)
    return ada, apply_mpo_to_mps(mpo_dagger(a_mpo), b_mps)


def linear_residual(a_mpo, x_mps, b_mps):
    """True global relative residual ``||A x - b|| / ||b||`` via exact MPO
    application and MPS addition (no truncation); a host float."""
    ax = apply_mpo_to_mps(a_mpo, x_mps)
    diff = mps_add(ax, MPS(b_mps.cores, -b_mps.left, b_mps.right))
    dv, dl = diff.norm_squared()
    bv, bl = b_mps.norm_squared()
    num = 0.5 * (torch.log(torch.clamp(torch.real(dv), min=1e-300)) + dl)
    den = 0.5 * (torch.log(torch.clamp(torch.real(bv), min=1e-300)) + bl)
    return float(torch.exp(num - den))
