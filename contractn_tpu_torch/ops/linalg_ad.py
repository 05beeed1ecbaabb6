"""Degeneracy-safe linear-algebra backward rules for fixed-point autodiff.

Counterpart of ``contractn_tpu/ops/linalg_ad.py``.  Reverse-mode gradients
of ``eigh``/``svd`` contain ``1 / (lam_i - lam_j)`` factors that blow up on
degenerate spectra, and physical tensor networks are full of exact
degeneracies.  The standard cure (Liao-Liu-Wang-Xiang, "Differentiable
programming tensor networks", PRX 9, 031041; also peps-torch) is Lorentzian
broadening of the inverse gaps:

    ``1 / x  ->  x / (x^2 + eps)``

which leaves non-degenerate gradients untouched to ``O(eps)`` and
regularizes degenerate ones; the dropped component is a gauge rotation
inside the degenerate subspace, which cancels in any gauge-invariant
downstream quantity.

Real and complex inputs.  As in the JAX package, each backward is the exact
adjoint of the Lorentzian-broadened forward tangent map (the textbook JVP
formulas with ``1/gap`` broadened): the tangent map is linear in ``dA``, so
one ``torch.autograd.grad`` of it — which differentiates only matmuls, never
a decomposition — is its adjoint, in torch's complex convention.

Hermitian inputs are assumed already symmetrized (callers do
``0.5 * (m + m.H)``); the returned eigh gradient is Hermitian-projected.
"""

import torch

_EPS = 1e-12
# On the card, matrices wider than this on their short side go to cuSOLVER's
# QR-iteration ``gesvd``; up to it, torch's default (Jacobi, batched up to 32
# x 32, ``gesvd`` where Jacobi does not converge) is faster.  The crossover
# lies between 64 and 128 on an H100 in float64 (scripts/time_cell_svd.py,
# PERF.md §6).
_JACOBI_MAX = 64


def _h(x):
    return x.conj().transpose(-2, -1)


def _eigh_jvp_broadened(vals, vecs, dm, eps):
    """Broadened tangent of ``eigh`` at a Hermitian point.

    ``dvals_i = Re (V^H dM V)_ii``; ``dvecs = V (F o V^H dM V)`` with
    ``F_ij = 1/(lam_j - lam_i)`` Lorentzian-broadened (zero diagonal — the
    phase/sign gauge direction, dropped by convention).
    """
    vhdv = _h(vecs) @ dm @ vecs
    dvals = torch.real(torch.diagonal(vhdv))
    gap = vals[None, :] - vals[:, None]
    f = gap / (gap * gap + eps)
    dvecs = vecs @ (f.to(vecs.dtype) * vhdv)
    return dvals, dvecs


def _svd_jvp_broadened(u, s, vh, dm, eps):
    """Broadened tangent of the compact SVD (complex-safe), with every
    inverse — the ``1/(s_j^2 - s_i^2)`` gap factors and the ``1/s`` in the
    anti-Hermitian-diagonal and off-range terms — Lorentzian-broadened."""
    v = _h(vh)
    ut = _h(u)
    ds_mat = ut @ dm @ v
    ds = torch.real(torch.diagonal(ds_mat, dim1=-2, dim2=-1))

    s_j, s_i = s[..., None, :], s[..., :, None]
    gap = (s_j + s_i) * (s_j - s_i)  # s_j^2 - s_i^2, zero diagonal
    f = (gap / (gap * gap + eps)).to(dm.dtype)
    s_inv = (s / (s * s + eps)).to(dm.dtype)

    dss = s_j.to(dm.dtype) * ds_mat  # dS . diag(s)
    sds = s_i.to(dm.dtype) * ds_mat  # diag(s) . dS
    anti_diag = 0.5 * (ds_mat - _h(ds_mat)) * torch.diag_embed(s_inv)
    du = u @ (f * (dss + _h(dss)) + anti_diag)
    dv = v @ (f * (sds + _h(sds)))

    m_rows, n_cols = dm.shape[-2:]
    k = s.shape[-1]
    if m_rows > k:
        dav = dm @ v
        du = du + (dav - u @ (ut @ dav)) * s_inv[..., None, :]
    if n_cols > k:
        dahu = _h(dm) @ u
        dv = dv + (dahu - v @ (vh @ dahu)) * s_inv[..., None, :]
    return du, ds, _h(dv)


def _adjoint(tangent, shape, dtype, device, cotangents):
    """Adjoint of the linear ``tangent(dm)`` applied to ``cotangents``."""
    with torch.enable_grad():
        dm = torch.zeros(shape, dtype=dtype, device=device, requires_grad=True)
        outs = tangent(dm)
        pairs = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
        (gm,) = torch.autograd.grad([o for o, _ in pairs], dm,
                                    grad_outputs=[c for _, c in pairs],
                                    allow_unused=True)
    return torch.zeros(shape, dtype=dtype, device=device) if gm is None else gm


class _EighSafe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, eps):
        vals, vecs = dense_eigh(m)
        ctx.save_for_backward(vals, vecs)
        ctx.eps = eps
        return vals, vecs

    @staticmethod
    def backward(ctx, g_vals, g_vecs):
        vals, vecs = ctx.saved_tensors
        gm = _adjoint(lambda dm: _eigh_jvp_broadened(vals, vecs, dm, ctx.eps),
                      vecs.shape, vecs.dtype, vecs.device, (g_vals, g_vecs))
        # project onto the Hermitian tangent space (input contract)
        return 0.5 * (gm + _h(gm)), None


def small_svd(m):
    """Compact ``(u, s, vh) = svd(m)`` of a small matrix (or a batch of them,
    on the leading axes), on ``m``'s device: LAPACK on the CPU; on the card
    the cuSOLVER driver measured fastest for the size (:data:`_JACOBI_MAX`)."""
    driver = "gesvd" if m.is_cuda and min(m.shape[-2:]) > _JACOBI_MAX else None
    return torch.linalg.svd(m, full_matrices=False, driver=driver)


class _SvdSafe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, eps):
        u, s, vh = small_svd(m)
        ctx.save_for_backward(u, s, vh)
        ctx.eps = eps
        return u, s, vh

    @staticmethod
    def backward(ctx, g_u, g_s, g_vh):
        u, s, vh = ctx.saved_tensors
        shape = tuple(u.shape[:-1]) + tuple(vh.shape[-1:])
        gm = _adjoint(lambda dm: _svd_jvp_broadened(u, s, vh, dm, ctx.eps),
                      shape, u.dtype, u.device, (g_u, g_s, g_vh))
        return gm, None


def eigh_safe(m, eps=_EPS):
    """``(vals, vecs) = eigh(m)`` with a degeneracy-broadened backward.

    The forward is ``torch.linalg.eigh`` (through :func:`dense_eigh`, so a
    CPU matrix MKL's driver cannot diagonalize goes to numpy's LAPACK); only
    the reverse rule differs (Lorentzian-broadened eigenvalue gaps).  Real-symmetric or
    complex-Hermitian ``(n, n)`` input.  Returns a plain tuple.
    """
    return _EighSafe.apply(m, eps)


def svd_safe(m, eps=_EPS):
    """Compact ``(u, s, vh) = svd(m)`` with a degeneracy-broadened backward.

    The forward is :func:`small_svd`; the reverse
    rule broadens the ``1/(s_i^2 - s_j^2)`` gap factors and the ``1/s``
    inverses (rank deficiency).  Real or complex ``(..., m, n)`` input
    (leading axes are a batch).
    """
    return _SvdSafe.apply(m, eps)


def dense_eigh(h):
    """``torch.linalg.eigh`` of a dense Hermitian matrix, for the local
    solvers.  On the CPU, MKL's divide-and-conquer driver can fail to
    converge on the exactly degenerate spectra of zero-padded effective
    Hamiltonians (it raises ``LinAlgError`` on finite symmetric matrices
    that LAPACK's other builds diagonalize); there the same matrix goes
    through numpy's LAPACK.  On the card a failure still raises."""
    try:
        return torch.linalg.eigh(h)
    except torch.linalg.LinAlgError:
        if h.device.type != "cpu":
            raise
        import numpy as np

        vals, vecs = np.linalg.eigh(h.detach().numpy())
        return torch.from_numpy(vals), torch.from_numpy(vecs)
