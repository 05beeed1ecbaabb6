"""TRG: Levin-Nave tensor renormalization + GILT loop filtering.

Counterpart of ``contractn_tpu/models/trg.py``.  The original tensor
renormalization group (Levin & Nave, PRL 99, 120601): on a checkerboard,
every site tensor is SVD-split across one of its two diagonals, and the four
inner triangle pieces around alternate plaquettes contract into the coarse
tensor on the 45-degree rotated lattice (N -> N/2 sites per step).
O(chi^6) per step.

Geometry (axes ``a[u, l, d, r]``, matching :mod:`.hotrg` / the CTMRG Ising
builders): "even" sites split ``(u, r) | (d, l)``, "odd" sites ``(u, l) |
(d, r)``.  The four SVD bond legs become the coarse tensor's modes with the
rotated-frame assignment ``u' = NE, l' = NW, d' = SW, r' = SE``.

``gilt_eps > 0`` enables the uniform single-tensor GILT (graph-independent
local truncation, Hauru-Delcamp-Mizera PRB 97, 045111): before each split,
every lattice leg gets a near-identity matrix ``R = sum_a t'_a U_a`` from the
eigenpairs of the plaquette loop's leg-environment Gram matrix, with the
soft threshold ``t' = t s^2 / (s^2 + eps^2)``; ``R`` is SVD-split and its
halves absorbed into the adjacent tensors.  It cuts off-critical truncation
error and leaves the critical point as plain TRG has it (the JAX module's
docstring records the measurements).

Zero-padded static ``chi`` bonds; the flow is a plain loop of ``steps``
iterations on the tensor's device with the split-format carry ``g -> 2 g +
log c`` kept there (one host read at the end).
"""

import torch

from ..ops.linalg_ad import dense_eigh
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device

__all__ = ["trg_log_z"]


def _pad4(a, chi):
    pad = []
    for s in reversed(a.shape):
        pad += [0, chi - s]
    return torch.nn.functional.pad(a, pad)


def _split(mat, chi):
    """Rank-``chi`` SVD split ``mat ~ p1 @ p2.T`` (``p*: (n, chi)``).

    On the card the SVD runs cuSOLVER's QR-based ``gesvd``: torch's default
    there, the Jacobi ``gesvdj``, is slow on these fast-decaying spectra (a
    chi-64 step takes 12 s with it on an H100, 1.6 s with ``gesvd``)."""
    u, s, vh = torch.linalg.svd(mat, full_matrices=False,
                                driver="gesvd" if mat.is_cuda else None)
    rs = torch.sqrt(s[:chi]).to(u.dtype)
    return u[:, :chi] * rs[None, :], vh[:chi, :].T * rs[None, :]


def _trg_step(a, chi):
    """One Levin-Nave step: split both sublattices, contract plaquettes.

    ``a1[u, r, k] a2[d, l, k]`` (even) and ``b1[u, l, k] b2[d, r, k]``
    (odd); the coarse tensor collects (NE, NW, SW, SE) as its ``(u, l, d,
    r)``.
    """
    # even split: rows (u, r), cols (d, l)
    m_e = a.permute(0, 3, 2, 1).reshape(chi * chi, chi * chi)
    p1, p2 = _split(m_e, chi)
    a1 = p1.reshape(chi, chi, chi)  # [u, r, k]
    a2 = p2.reshape(chi, chi, chi)  # [d, l, k]
    # odd split: rows (u, l), cols (d, r)
    q1, q2 = _split(a.reshape(chi * chi, chi * chi), chi)
    b1 = q1.reshape(chi, chi, chi)  # [u, l, k]
    b2 = q2.reshape(chi, chi, chi)  # [d, r, k]

    # plaquette edges: L (left), B (bottom), R (right), T (top)
    # SW corner (even): a1[L, B, ka]   NW corner (odd): b2[L, T, kd]
    # SE corner (odd):  b1[R, B, kb]   NE corner (even): a2[R, T, kc]
    x = peinsum("LBa,LTd->BaTd", a1, b2)
    y = peinsum("RBb,RTc->BbTc", b1, a2)
    # (u', l', d', r') = (NE, NW, SW, SE) = (kc, kd, ka, kb)
    return peinsum("BaTd,BbTc->cdab", x, y)


def _closure(a):
    return peinsum("ulul->", a)


def _mean_abs(a):
    return torch.clamp(a.abs().mean(), min=1e-300)


def _trg_flow(a0, chi, steps, gilt_eps=0.0, gilt_reps=2):
    c0 = _mean_abs(a0)
    a, g = a0 / c0, torch.log(c0)
    for _ in range(int(steps)):
        if gilt_eps:
            a = _gilt_all_legs(a, gilt_eps, gilt_reps)
        a = _trg_step(a, chi)
        c = _mean_abs(a)
        a, g = a / c, 2.0 * g + torch.log(c)
    return (g + torch.log(_closure(a).abs())) / (2.0 ** steps)


def trg_log_z(a, chi, steps=30, gilt_eps=0.0, gilt_reps=2):
    """``log Z`` per site of the infinite square lattice by TRG (a host
    float).

    Args:
        a: site tensor ``(q, q, q, q)``, axes ``(u, l, d, r)``; a numpy
            array goes to ``cuda``.
        chi: static bond dimension of the flow.
        steps: coarse-graining steps (each halves the site count).
        gilt_eps: GILT threshold; ``0`` disables loop filtering.
        gilt_reps: GILT recursion count per step (the R matrices are
            re-derived on the already-filtered tensor).
    """
    a = as_tensor(a, resolve_device(None, (a,)))
    return float(_trg_flow(_pad4(a, chi), chi, int(steps), float(gilt_eps),
                           int(gilt_reps)))


# ------------------------------------------------------------------ #
# GILT: graph-independent local truncation of plaquette loops
# ------------------------------------------------------------------ #

def _doubled_corners(a):
    """Double-layer corner transfers of the plaquette loop, external legs
    traced with the conjugate layer.  Internal-leg pairs are kept as
    ``(ket, bra)``; returns (sw, se, ne, nw)."""
    ac = a.conj()
    # SW: internal (u -> left edge, r -> bottom edge); trace (l, d)
    sw = peinsum("uldr,ULdR->uUrR", a, ac)
    # SE: internal (u -> right edge, l -> bottom edge); trace (d, r)
    se = peinsum("uldr,ULdr->uUlL", a, ac)
    # NE: internal (d -> right edge, l -> top edge); trace (u, r)
    ne = peinsum("uldr,uLDr->dDlL", a, ac)
    # NW: internal (d -> left edge, r -> top edge); trace (u, l)
    nw = peinsum("uldr,ulDR->dDrR", a, ac)
    return sw, se, ne, nw


def _gilt_r(a, eps):
    """GILT R matrix for the BOTTOM leg of the plaquette loop: the Gram
    matrix ``M[(i i'), (j j')]`` of the leg environment, ``R = sum_a t'_a
    U_a`` with ``t = <I, U_a>`` softly thresholded.  Returned as ``R[i, j]``
    to insert on the cut leg (SW's r index times SE's l)."""
    chi = a.shape[0]
    sw, se, ne, nw = _doubled_corners(a)
    half = peinsum("uUrR,uUtT->rRtT", sw, nw)
    half = peinsum("rRtT,tTqQ->rRqQ", half, peinsum("dDlL->lLdD", ne))
    m = peinsum("rRqQ,qQlL->rRlL", half, se)
    # regroup the Gram: rows = (ket i, ket j), cols = (bra i', bra j')
    m = m.permute(0, 2, 1, 3).reshape(chi * chi, chi * chi)
    m = 0.5 * (m + m.conj().T)
    s2, u = dense_eigh(m)  # ascending, s2 = singular values^2
    s2 = torch.clamp(s2, min=0.0)
    eye = torch.eye(chi, dtype=a.dtype, device=a.device).reshape(chi * chi)
    t = peinsum("i,ia->a", eye, u.conj())
    s2n = s2 / torch.clamp(s2[-1], min=1e-300)
    tp = t * (s2n / (s2n + eps * eps)).to(t.dtype)
    return peinsum("ia,a->i", u, tp).reshape(chi, chi)


def _absorb_r(a, r):
    """Split ``r`` by SVD and absorb its halves into every r leg and every
    l leg (from the left) of ``a``."""
    u, s, vh = torch.linalg.svd(r)
    rs = torch.sqrt(s).to(u.dtype)
    a = peinsum("uldr,rx->uldx", a, u * rs[None, :])
    return peinsum("yl,uldr->uydr", rs[:, None] * vh, a)


def _gilt_all_legs(a, eps, reps):
    """Uniform single-tensor GILT: derive R for a horizontal leg and (by
    the 90-degree rotation) a vertical leg, split each, absorb the halves
    into every matching leg; repeat ``reps`` times."""
    for _ in range(reps):
        a = _absorb_r(a, _gilt_r(a, eps))
        # vertical legs: rotate so they sit horizontally, reuse
        ar = a.permute(1, 2, 3, 0)  # (u,l,d,r) <- (l,d,r,u)
        ar = _absorb_r(ar, _gilt_r(ar, eps))
        a = ar.permute(3, 0, 1, 2)
    return a
