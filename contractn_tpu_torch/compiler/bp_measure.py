"""BP expectation values on arbitrary open graph states.

Counterpart of ``contractn_tpu/compiler/bp_measure.py``.  At the
doubled-layer fixed point the incoming Gram-matrix messages ARE the (Bethe)
environment of every node, so any local observable is a single closed
contraction,

    ``<O_a>  = Z_a(O) / Z_a(I)``,
    ``<O_ab> = Z_ab(O) / Z_ab(I)``  (adjacent pair, shared bonds
                                     contracted exactly),

with ``Z`` = the node (pair) sandwiched between its own conjugate and the
incoming messages on every external virtual mode.  Exact on trees; the
standard BP/mean-field estimate on loopy graphs.  Operators address a
node's fused physical space (its dangling modes in order).

Design for the card: terms of one structure (node shapes, wiring and
operator shape) are closed together, one batched contraction per structure
(:class:`TermBatch`), so a lattice's hundreds of bond terms cost a handful
of launches.  Each closure contracts node by node — ket, its messages, bra —
then the operator (:func:`~.bp.lr_einsum`), so no outer product of messages
and no pair of open kets is ever formed.
"""

import string

import torch

from ..utils.device import as_tensor
from ..utils.errors import TNError
from .bp import lr_einsum
from .bp_gauge import _run_doubled

_LETTERS = string.ascii_letters[:-1]  # "Z" indexes the batch of terms


def _node_modes(graph, shapes):
    """Per node position: its modes, each ``("msg", incoming_slot)`` for a
    bond mode or ``("phys", dim)`` for a dangling (physical) mode."""
    incoming = {}
    for e, (_, ends) in enumerate(graph.bonds):
        for pos, mode, side in ends:
            incoming[(pos, mode)] = 2 * e + (1 - side)
    return [
        [("msg", incoming[(pos, mode)]) if (pos, mode) in incoming
         else ("phys", shape[mode]) for mode in range(len(shape))]
        for pos, shape in enumerate(shapes)
    ]


def _shared_bonds(modes_a, modes_b, name_a, name_b):
    """Bond ids of the edges an adjacent pair shares, keyed by the incoming
    slot at either end (slot ``v`` at b pairs with ``v ^ 1`` at a)."""
    slots_a = {v for k, v in modes_a if k == "msg"}
    shared = {}
    for k, v in modes_b:
        if k == "msg" and (v ^ 1) in slots_a:
            bid = len(shared)
            shared[v] = bid
            shared[v ^ 1] = bid
    if not shared:
        raise TNError(
            f"nodes '{name_a}' and '{name_b}' share no bond; "
            "bond terms need adjacent nodes")
    return shared


def _resolved(modes, shared):
    return [("bond", shared[v]) if k == "msg" and v in shared else (k, v)
            for k, v in modes]


def _closure(structure, with_op):
    """Index strings of one closure — per node its ket, its messages and its
    bra, then the operator — and the physical dims.  ``structure`` lists per
    node its modes as ``("msg", None)``, ``("bond", bid)`` or
    ``("phys", dim)``; every string leads with the batch index ``Z``."""
    it = iter(_LETTERS)
    subs = []
    ket_phys, bra_phys, phys_dims = [], [], []
    bond_sym = {}
    for modes in structure:
        ket, bra, msgs = [], [], []
        for kind, val in modes:
            if kind == "bond":
                if val not in bond_sym:
                    bond_sym[val] = (next(it), next(it))
                k, b = bond_sym[val]
            elif kind == "msg":
                k, b = next(it), next(it)
                msgs.append("Z" + k + b)
            else:  # phys
                k = next(it)
                b = next(it) if with_op else k
                ket_phys.append(k)
                bra_phys.append(b)
                phys_dims.append(val)
            ket.append(k)
            bra.append(b)
        subs += ["Z" + "".join(ket)] + msgs + ["Z" + "".join(bra)]
    if with_op:
        subs.append("Z" + "".join(bra_phys) + "".join(ket_phys))
    return subs, tuple(phys_dims)


def _structure(modes):
    return tuple(tuple((k, None if k == "msg" else v) for k, v in m)
                 for m in modes)


class TermBatch:
    """Terms of one structure, closed together: :meth:`values` gives
    ``Z(O) / Z(I)`` for each, as one batched contraction.

    ``terms`` is a list of ``(positions, resolved modes per node, op)``.
    """

    def __init__(self, graph, terms, device):
        _, first_modes, _ = terms[0]
        structure = _structure(first_modes)
        self.positions = [[t[0][i] for t in terms]
                          for i in range(len(first_modes))]
        self.msgs = []  # per node: (key, rows) of each external mode
        for i, modes in enumerate(first_modes):
            cols = [j for j, (k, _) in enumerate(modes) if k == "msg"]
            self.msgs.append([
                graph.layout.rows([t[1][i][j][1] for t in terms], device)
                for j in cols
            ])
        self.num, phys = _closure(structure, with_op=True)
        self.den, _ = _closure(structure, with_op=False)
        dim = 1
        for d in phys:
            dim *= d
        ops = [as_tensor(op, device) for _, _, op in terms]
        for op in ops:
            if tuple(op.shape) != (dim, dim):
                raise TNError(
                    f"operator shape {tuple(op.shape)} does not match the "
                    f"group's fused physical dimension {dim}")
        self.ops = torch.stack(ops).reshape((len(ops),) + phys * 2)

    def values(self, tensors, msgs):
        """``Z(O) / Z(I)`` of every term (node ``tensors`` in node order,
        ``msgs`` the flat message tensors of the doubled network)."""
        operands = []
        for pos, rows in zip(self.positions, self.msgs):
            t = torch.stack([tensors[p] for p in pos])
            operands += [t] + [msgs[key][r] for key, r in rows] + [t.conj()]
        den = lr_einsum(self.den, "Z", *operands)
        num = lr_einsum(self.num, "Z", *operands, self.ops)
        return num / den


def term_batches(graph, shapes, local=(), bonds=()):
    """Group the terms by structure; returns ``(batches, order)`` where
    ``order[i]`` is ``(batch index, row)`` of the i-th term (the local terms
    first, then the bond terms, each in input order)."""
    pos_of = {name: p for p, name in enumerate(graph.names)}
    modes_of = _node_modes(graph, shapes)

    def resolve(name):
        if name not in pos_of:
            raise TNError(f"unknown node '{name}'")
        return pos_of[name]

    terms = []
    for name, op in local:
        pos = resolve(name)
        terms.append(([pos], [modes_of[pos]], op))
    for name_a, name_b, op2 in bonds:
        pa, pb = resolve(name_a), resolve(name_b)
        shared = _shared_bonds(modes_of[pa], modes_of[pb], name_a, name_b)
        terms.append(([pa, pb], [_resolved(modes_of[pa], shared),
                                 _resolved(modes_of[pb], shared)], op2))
    grouped = {}
    order = []
    for term in terms:
        positions, modes, op = term
        key = (tuple(tuple(shapes[p]) for p in positions), _structure(modes),
               tuple(getattr(op, "shape", ())))
        members = grouped.setdefault(key, [])
        order.append((list(grouped).index(key), len(members)))
        members.append(term)
    batches = [TermBatch(graph, members, graph.device)
               for members in grouped.values()]
    return batches, order


def bp_measure(tn, local=(), bonds=(), tol=1e-12, max_iter=200,
               damping=0.0, device=None):
    """Local and adjacent-pair expectation values via one BP solve.

    Args:
        local: iterable of ``(node_name, op)`` — ``op`` acts on that
            node's fused physical (dangling) space, modes in order.
        bonds: iterable of ``(name_a, name_b, op2)`` — ``op2`` acts on
            the fused physical space of the ADJACENT pair (``name_a``'s
            physical modes first); every edge shared by the pair is
            contracted exactly inside the closure.
        device: where to compute (default: the node tensors' device, else
            the GPU).

    Returns:
        ``(local_values, bond_values)`` lists of Python complex numbers, in
        input order.  Exact on trees; the Bethe estimate on loopy graphs.
    """
    local, bonds = list(local), list(bonds)
    graph, _, msgs, _, _ = _run_doubled(tn, tol, max_iter, damping, device)
    tensors = graph.node_tensors()
    batches, order = term_batches(graph, [t.shape for t in tensors],
                                  local, bonds)
    values = [b.values(tensors, msgs) for b in batches]
    host = []
    if values:  # one host read for every value
        dtype = values[0].dtype
        for v in values[1:]:
            dtype = torch.promote_types(dtype, v.dtype)
        flat = torch.cat([v.to(dtype) for v in values]).cpu().tolist()
        starts = [0]
        for v in values:
            starts.append(starts[-1] + len(v))
        host = [complex(flat[starts[b] + r]) for b, r in order]
    return host[:len(local)], host[len(local):]
