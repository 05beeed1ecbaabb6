"""BP simple update: gate dynamics on arbitrary graph states.

Counterpart of ``contractn_tpu/compiler/bp_update.py``.  With
:mod:`.bp_gauge` the network sits in the (quasi-)Vidal gauge — every bond
in its Schmidt basis with ``sqrt(S)`` absorbed on both sides.  Applying a
two-site gate is then the classic simple update, generalized from chains to
ANY graph: weight the two tensors' other bonds up to full ``S``, contract
the pair with the gate, SVD across the bond, truncate, divide the outer
weights back.  On trees this IS canonical TEBD; on loopy graphs it is the
simple-update approximation whose quality the BP fixed point controls.
Gates apply in order: the simple update is sequential by nature.

Departure from the JAX package, same result: the SVD runs on the
QR-reduced pair.  Each tensor is first split by a QR into an isometry over
its other bonds and a small core over (physical, shared bond); the gate and
the SVD act on the two cores, a ``(r_a d_a) x (r_b d_b)`` matrix, and the
isometries are multiplied back.  The singular values and the kept subspace
are those of the full ``(chi^3 d) x (chi^3 d)`` matrix the JAX package
decomposes (the isometries preserve both), at a fraction of its cost.
"""

import math

import torch

from ..utils.device import as_tensor, resolve_device
from ..utils.errors import TNError
from .bp_gauge import _gauge_internal, _rebuild

_FLOOR = 1e-14


def gate_from_term(h2, dt, d=2, imaginary=False, device=None):
    """Two-site Trotter gate ``exp(-i h2 dt)`` (or ``exp(-h2 dt)``).

    ``h2`` is the ``(d*d, d*d)`` bond term with row/column index order
    ``(site_a, site_b)``; the returned gate is ``(d, d, d, d)`` with
    axes ``(out_a, out_b, in_a, in_b)``, on ``device`` (default: ``h2``'s
    device if it is a torch tensor, else the GPU).
    """
    h2 = as_tensor(h2, resolve_device(device, (h2,)))
    if tuple(h2.shape) != (d * d, d * d):
        raise TNError(
            f"bond term must be ({d*d},{d*d}), got {tuple(h2.shape)}")
    factor = -dt if imaginary else -1j * dt
    return torch.linalg.matrix_exp(factor * h2).reshape(d, d, d, d)


def _mode_maps(tn, bonds):
    """Per-node mode->edge wiring."""
    order = [n.name for n in tn.nodes()]
    pos_of = {name: i for i, name in enumerate(order)}
    mode_edge = [dict() for _ in order]
    for e, (_, ends) in enumerate(bonds):
        for pos, mode, _ in ends:
            mode_edge[pos][mode] = e
    return order, pos_of, mode_edge


def _phys_mode(tensor, wiring):
    phys = [m for m in range(tensor.ndim) if m not in wiring]
    if len(phys) != 1:
        raise TNError(
            "gate application needs exactly one dangling (physical) mode "
            f"per node; found {len(phys)}")
    return phys[0]


def _weight_outer(t, wiring, skip_mode, weights, invert):
    """Multiply (or pseudo-divide) each non-center bond by sqrt(S)."""
    for mode, e in wiring.items():
        if mode == skip_mode:
            continue
        w = weights[e]
        root = torch.sqrt(w)
        if invert:
            live = w > torch.max(w) * _FLOOR
            root = torch.where(live, 1.0 / torch.clamp(root, min=_FLOOR), 0.0)
        shape = [1] * t.ndim
        shape[mode] = t.shape[mode]
        t = t * root.reshape(shape)
    return t


def _apply_one_gate(tensors, bonds, weights, mode_edge, gate,
                    pa, pb, max_bond, cutoff, unit_weights=False):
    """One simple-update gate on the pair ``(pa, pb)``, in place.

    ``unit_weights`` scales the new bond's singular values to unit 2-norm
    before they are absorbed and stored: it changes only the global scale
    of the state, which otherwise compounds from bond to bond."""
    shared = [e for m, e in mode_edge[pa].items()
              if any(p == pb for p, _, _ in bonds[e][1])]
    if len(shared) != 1:
        raise TNError(
            f"gate needs exactly one bond between the two nodes; found "
            f"{len(shared)}")
    e = shared[0]
    mode_a = next(m for m, ee in mode_edge[pa].items() if ee == e)
    mode_b = next(m for m, ee in mode_edge[pb].items() if ee == e)

    a = tensors[pa]
    b = tensors[pb]
    phys_a = _phys_mode(a, mode_edge[pa])
    phys_b = _phys_mode(b, mode_edge[pb])
    if tuple(gate.shape) != (a.shape[phys_a], b.shape[phys_b]) * 2:
        raise TNError(
            f"gate shape {tuple(gate.shape)} does not match physical dims "
            f"({a.shape[phys_a]}, {b.shape[phys_b]})")
    dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                gate.dtype)
    a, b, gate = a.to(dtype), b.to(dtype), gate.to(dtype)

    a = _weight_outer(a, mode_edge[pa], mode_a, weights, invert=False)
    b = _weight_outer(b, mode_edge[pb], mode_b, weights, invert=False)

    # permute to (others..., phys, bond) / (others..., bond, phys)
    others_a = [m for m in range(a.ndim) if m not in (phys_a, mode_a)]
    others_b = [m for m in range(b.ndim) if m not in (phys_b, mode_b)]
    a_perm = a.permute(others_a + [phys_a, mode_a])
    b_perm = b.permute(others_b + [mode_b, phys_b])
    shape_oa = a_perm.shape[:len(others_a)]
    shape_ob = b_perm.shape[:len(others_b)]
    da, db, chi = a.shape[phys_a], b.shape[phys_b], a.shape[mode_a]
    # QR over the other bonds: a = Qa Ra, b = Qb Rb
    qa, ra = torch.linalg.qr(a_perm.reshape(math.prod(shape_oa), da * chi))
    qb, rb = torch.linalg.qr(b_perm.reshape(math.prod(shape_ob), chi * db))
    ka, kb = ra.shape[0], rb.shape[0]
    core = torch.einsum("ipk,jkq->ipjq", ra.reshape(ka, da, chi),
                        rb.reshape(kb, chi, db))
    # the gate's input pair, outputs back in the same slots
    core = torch.einsum("ipjq,xypq->ixjy", core, gate)
    u, s, vh = torch.linalg.svd(core.reshape(ka * da, kb * db),
                                full_matrices=False)
    if unit_weights:
        s = s / torch.clamp(torch.linalg.norm(s), min=torch.finfo(s.dtype).tiny)
    smax = torch.clamp(torch.max(s), min=torch.finfo(s.dtype).tiny)
    live = int((s > smax * max(cutoff, _FLOOR)).sum())
    k = max(min(live, max_bond or live), 1)
    root = torch.sqrt(s[:k]).to(u.dtype)
    a_new = qa @ (u[:, :k] * root[None, :]).reshape(ka, da * k)
    b_new = qb @ (root[:, None] * vh[:k]).reshape(k, kb, db) \
        .permute(1, 0, 2).reshape(kb, k * db)
    # back to original mode orders (bond mode now dimension k)
    a_new = a_new.reshape(tuple(shape_oa) + (da, k)) \
        .permute(_inverse(others_a + [phys_a, mode_a]))
    b_new = b_new.reshape(tuple(shape_ob) + (k, db)) \
        .permute(_inverse(others_b + [mode_b, phys_b]))
    a_new = _weight_outer(a_new, mode_edge[pa], mode_a, weights, invert=True)
    b_new = _weight_outer(b_new, mode_edge[pb], mode_b, weights, invert=True)

    tensors[pa] = a_new
    tensors[pb] = b_new
    weights[e] = s[:k]
    bonds[e][0] = k


def _inverse(perm):
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return inv


def bp_apply_gates(tn, gates, max_bond=None, cutoff=0.0, tol=1e-12,
                   max_iter=200, damping=0.0, floor=1e-14,
                   renormalize=False, device=None):
    """Apply two-site gates to an open network, truncating via BP.

    The network is BP-gauged once, then each ``(gate, node_a, node_b)``
    in ``gates`` is applied in order by the simple update: exact (up to
    the ``max_bond``/``cutoff`` truncation) on trees, the simple-update
    approximation on loopy graphs.  ``gate`` has axes
    ``(out_a, out_b, in_a, in_b)`` — see :func:`gate_from_term`.

    ``renormalize=True`` rescales every tensor to mean ``|t| = 1``
    before returning — non-unitary (imaginary-time) gate layers grow
    tensor scales by ``~exp(tau |E|)`` PER LAYER, so long evolutions
    overflow float64 within a few dozen layers without it.  The state
    ray is unchanged; only the physically-irrelevant global scale is
    dropped (use split-format contraction if the scale matters).  With it,
    each new bond's singular values are also scaled to unit 2-norm before
    they are absorbed, since their raw scales compound from bond to bond
    across a layer (on a 16 x 16 grid they pass float64's range within one
    layer; the JAX package keeps the raw scales).  This changes neither the
    returned tensors nor the spectra, only what would overflow.

    Returns:
        ``(new_tn, spectra)`` — the updated network (same topology,
        possibly different bond dimensions; its tensors on the device of
        the computation) and the kept bond weights (each normalized to
        the unit 2-norm of its full spectrum).
    """
    tensors, bonds, weights = _gauge_internal(
        tn, tol, max_iter, damping, floor, device)
    bonds = [[dim, ends] for dim, ends in bonds]
    _, pos_of, mode_edge = _mode_maps(tn, bonds)
    dev = tensors[0].device if tensors else None
    for gate, na, nb in gates:
        na = na if isinstance(na, str) else na.name
        nb = nb if isinstance(nb, str) else nb.name
        if na not in pos_of or nb not in pos_of:
            raise TNError(f"unknown node in gate target ({na}, {nb})")
        _apply_one_gate(tensors, bonds, weights, mode_edge,
                        as_tensor(gate, dev), pos_of[na], pos_of[nb],
                        max_bond, cutoff, unit_weights=renormalize)
    if renormalize:
        tensors = [t / torch.clamp(t.abs().mean(), min=_FLOOR)
                   for t in tensors]
    spectra = [w / torch.linalg.norm(w) for w in weights]
    return _rebuild(tn, tensors, bonds), spectra
