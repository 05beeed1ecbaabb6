"""BP gauging: the Vidal gauge on arbitrary graph states.

Counterpart of ``contractn_tpu/compiler/bp_gauge.py``.  A quantum state is
an *open* network (dangling physical legs); its norm network is the doubled
layer ``T (x) conj(T)`` with the physical legs traced, and BP on that network
carries one ``chi x chi`` PSD matrix message per bond direction — the Gram
matrix of the subtree state vectors on that side.  From the two opposing
Gram matrices the bond's Schmidt data follows without contracting the
network: with roots ``M_a = Y_a^H Y_a`` (so ``X_a = conj(Y_a)``) and the SVD
``X_a X_b^T = U S V^H``, the Schmidt values across the bond are ``S`` and the
gauge transforms ``G_a = X_a^{-1} U``, ``G_b = X_b^{-1} conj(V)`` rotate the
two bond modes into the Schmidt basis: ``G_a diag(S) G_b^T = I`` — an exact
telescope for any invertible roots, so gauging never changes the state, on
trees or loopy graphs.  The loops change only the meaning of ``S``: exact
Schmidt values on trees, the BP/simple-update approximation otherwise
(Tindall & Fishman, SciPost Phys. 15, 222).

Design for the card: the fixed point is :class:`~.bp.BPGraph` on the
doubled network (ket groups; the doubled node is never built), and the
per-bond ``eigh``/``svd`` closures run as one batched
``torch.linalg.eigh``/``svd`` per group of bonds of equal ``chi``.
"""

import torch

from ..network import TN
from .bp import BPGraph


def _run_doubled(tn, tol, max_iter, damping, device):
    """BP fixed point of ``tn``'s norm network; returns ``(graph, iters,
    msgs, phase, log)``."""
    graph = BPGraph(tn, doubled=True, device=device)
    stacks = graph.stacks()
    iters, _, msgs = graph.fixed_point(stacks, tol, max_iter, damping)
    phase, log = graph.bethe(stacks, msgs)
    return graph, iters, msgs, phase, log


def bp_norm(tn, tol=1e-12, max_iter=200, damping=0.0, split_format=True,
            device=None):
    """BP approximation of ``<psi|psi>`` for an open network.

    Exact on trees; the Bethe approximation of the norm otherwise.
    Returns split format ``(mantissa, log)`` by default.
    """
    _, _, _, phase, log = _run_doubled(tn, tol, max_iter, damping, device)
    if split_format:
        return phase, log
    return phase * torch.exp(log)


def _bond_transforms(ma, mb, floor=1e-14):
    """Gauge transforms and Schmidt values of a batch of bonds.

    ``ma``/``mb`` are ``(n, chi, chi)`` stacks of the two opposing
    Gram-matrix messages, index order ``(ket, bra)``.  Eigendirections
    below ``floor`` (relative) are null directions of the subtree Gram
    matrix: the PSEUDO-inverse telescope acts as the identity on the state
    exactly, and dead directions report Schmidt weight exactly 0.
    """
    def herm(m):
        return 0.5 * (m + m.conj().transpose(-1, -2))

    wa, va = torch.linalg.eigh(herm(ma))
    wb, vb = torch.linalg.eigh(herm(mb))

    def roots(w):
        live = w > w.abs().amax(-1, keepdim=True) * floor
        r = torch.where(live, torch.sqrt(torch.clamp(w, min=0.0)), 0.0)
        r_inv = torch.where(live, 1.0 / torch.clamp(r, min=floor), 0.0)
        return r, r_inv

    ra, ra_inv = roots(wa)
    rb, rb_inv = roots(wb)
    # m = Y^H Y with Y = diag(sqrt w) V^H; the ket-side root is its
    # conjugate X = diag(sqrt w) V^T, X^+ = conj(V) diag(w^{-1/2}).
    xa = ra[..., :, None] * va.transpose(-1, -2)
    xb = rb[..., :, None] * vb.transpose(-1, -2)
    xa_inv = va.conj() * ra_inv[..., None, :]
    xb_inv = vb.conj() * rb_inv[..., None, :]
    u, s, vh = torch.linalg.svd(xa @ xb.transpose(-1, -2))
    ga = xa_inv @ u
    gb = xb_inv @ vh.transpose(-1, -2)
    return ga, gb, s


def _apply_mode(tensor, mat, mode):
    """Contract ``tensor``'s ``mode`` with ``mat[old, new]`` in place."""
    dtype = torch.promote_types(tensor.dtype, mat.dtype)
    moved = torch.tensordot(tensor.to(dtype), mat.to(dtype),
                            dims=([mode], [0]))
    return torch.movedim(moved, -1, mode)


def _rebuild(tn, new_tensors, bonds):
    """Same-topology TN over the transformed tensors.

    Nodes are re-added in ``tn.nodes()`` order, so the dangling-leg
    output order of :meth:`TN.contract` is by (node, mode) — identical
    to the original whenever it was built nodes-first.
    """
    out = TN()
    order = [n.name for n in tn.nodes()]
    for name, t in zip(order, new_tensors):
        out.add_dense_node(t, name=name)
    for _, ends in bonds:
        (pa, ia, _), (pb, ib, _) = ends
        out.connect_nodes(order[pa], order[pb], ia, ib)
    return out


def _bond_batches(graph, msgs, floor):
    """Per bond, ``(ga, gb, s)`` from one batched eigh/svd per ``chi``."""
    by_dim = {}
    for e, (dim, _) in enumerate(graph.bonds):
        by_dim.setdefault(dim, []).append(e)
    out = [None] * len(graph.bonds)
    for dim, es in by_dim.items():
        ma = torch.stack([graph.message(msgs, 2 * e) for e in es])
        mb = torch.stack([graph.message(msgs, 2 * e + 1) for e in es])
        ga, gb, s = _bond_transforms(ma, mb, floor)
        for k, e in enumerate(es):
            out[e] = (ga[k], gb[k], s[k])
    return out


def _gauge_internal(tn, tol, max_iter, damping, floor, device):
    """Gauged tensors + raw (unnormalized) bond weights, no TN rebuild.

    The absorbed root is ``sqrt(S)`` of the raw SVD values — the exact
    telescope scale; callers normalize for reporting.  Returns
    ``(tensors, bonds, weights)``.
    """
    graph, _, msgs, _, _ = _run_doubled(tn, tol, max_iter, damping, device)
    tensors = graph.node_tensors()
    weights = []
    for (ga, gb, s), (_, ends) in zip(_bond_batches(graph, msgs, floor),
                                      graph.bonds):
        root = torch.sqrt(s)
        for pos, mode, side in ends:
            g = ga if side == 0 else gb
            tensors[pos] = _apply_mode(tensors[pos], g * root[None, :], mode)
        weights.append(s)
    return tensors, graph.bonds, weights


def bp_gauge(tn, tol=1e-12, max_iter=200, damping=0.0, floor=1e-14,
             device=None):
    """Gauge an open network into the (symmetric) Vidal form via BP.

    Every bond is rotated into its Schmidt basis with ``sqrt(S)``
    absorbed on both sides, so the returned network contracts to the
    SAME state (exact telescope — trees and loopy graphs alike).  On
    trees the returned per-bond ``spectra`` are the exact Schmidt
    values of the state across that bond (normalized to unit 2-norm);
    on loopy graphs they are the BP quasi-canonical weights used by
    simple-update-style truncation.

    Returns:
        ``(gauged_tn, spectra)`` — ``spectra[i]`` belongs to the i-th
        non-dangling edge in ``tn.edges()`` order.
    """
    tensors, bonds, weights = _gauge_internal(
        tn, tol, max_iter, damping, floor, device)
    spectra = [s / torch.linalg.norm(s) for s in weights]
    return _rebuild(tn, tensors, bonds), spectra


def bp_truncate(tn, max_bond, cutoff=0.0, tol=1e-12, max_iter=200,
                damping=0.0, floor=1e-14, device=None):
    """Truncate every bond of an open network via BP gauging.

    Each bond is rotated into its (BP) Schmidt basis and the smallest
    weights dropped — down to ``max_bond``, plus any below ``cutoff``
    relative to the bond's largest weight.  On trees a single oversize
    bond is truncated optimally: the squared error equals the discarded
    ``sum(S^2)`` exactly.

    Returns:
        ``(truncated_tn, spectra)`` with the *kept* (renormalized to
        the full spectrum's 2-norm = 1) weights per bond.
    """
    graph, _, msgs, _, _ = _run_doubled(tn, tol, max_iter, damping, device)
    tensors = graph.node_tensors()
    transforms = _bond_batches(graph, msgs, floor)
    live = [None] * len(transforms)
    if cutoff > 0.0:  # one host read for every bond's count
        live = torch.stack([
            (s >= cutoff * s[0]).sum() for _, _, s in transforms
        ]).tolist()
    spectra = []
    for (ga, gb, s), (dim, ends), n_live in zip(transforms, graph.bonds,
                                                live):
        k = min(dim, max_bond)
        if n_live is not None:
            k = min(k, max(n_live, 1))
        root = torch.sqrt(s[:k])
        for pos, mode, side in ends:
            g = ga if side == 0 else gb
            tensors[pos] = _apply_mode(
                tensors[pos], g[:, :k] * root[None, :], mode)
        spectra.append(s[:k] / torch.linalg.norm(s))
    return _rebuild(tn, tensors, graph.bonds), spectra
