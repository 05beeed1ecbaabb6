"""Belief-propagation (Bethe) contraction of closed tensor networks.

Counterpart of ``contractn_tpu/compiler/bp.py``.  Every bond edge carries
two directed messages ``m_{a->b}`` (a vector over the bond dimension); each
node refreshes its outgoing message on a mode by contracting its tensor with
the incoming messages on all *other* modes, and at the fixed point the
partition function is the Bethe assembly

    ``Z_BP = prod_a Z_a / prod_e Z_e``,

``Z_a`` = node tensor closed with all incoming messages, ``Z_e`` = overlap
of the two opposing messages on edge ``e``.  ``Z_BP`` is EXACT on trees and
the Bethe approximation on loopy graphs.  Messages are normalized to mean
``|m| = 1`` every sweep and ``Z`` is returned in split format ``(mantissa,
log)``.  Copy (hyperedge) nodes never materialize their delta tensor: their
leave-one-out products are exclusive forward/backward ``cumprod``.

Design for the card (:class:`BPGraph`): the JAX package unrolls the nodes
inside one jitted ``while_loop``; here the graph structure is planned once
per call and a sweep is a fixed number of batched ops per *node group*,
independent of the number of nodes:

* messages live in one flat tensor per bond dimension (``(n, chi)``; for the
  doubled networks of :mod:`.bp_gauge`, ``(n, chi, chi)`` matrices);
* nodes are grouped by signature — copy nodes by (degree, dim), dense nodes
  by shape, ket nodes of a doubled network by (shape, physical modes) — with
  their gather and scatter index tensors built once;
* a sweep gathers each group's inbound messages, computes every mode's
  leave-one-out contraction as one batched einsum over the group (a copy
  group: one cumprod pair over a ``(group, degree, dim)`` stack), scatters
  all outbound messages with one index per bond dimension, then damps and
  normalizes each flat tensor in one op.

Synchronous sweeps do not depend on the order of updates, so values and the
sweep count match the JAX package's; the convergence test is the same, one
device-to-host read of ``delta`` per sweep.  A doubled (norm) network's
node is never built: its ket tensor is contracted with the incoming
matrices and then with its own conjugate.
"""

import string
from functools import lru_cache

import numpy as np
import torch

from ..ops.stabilize import dot_precision, peinsum
from ..utils.device import as_tensor, real_dtype, resolve_device, torch_dtype
from ..utils.errors import TNError

_LETTERS = string.ascii_letters


def lr_einsum(subs, out, *operands):
    """Contract ``operands`` (index strings ``subs``) into ``out``, two at a
    time from the left.

    ``torch.einsum`` picks a contraction order only where opt_einsum is
    installed; this fixes it, so a node closed with its messages never
    forms their outer product.  Operands are promoted to one dtype, and
    float32 is refused under lowered matmul precision (as
    :func:`~..ops.stabilize.peinsum`).
    """
    dtype = operands[0].dtype
    for op in operands[1:]:
        dtype = torch.promote_types(dtype, op.dtype)
    if dot_precision(dtype) and \
            torch.get_float32_matmul_precision() != "highest":
        peinsum(f"{subs[0]}->{subs[0]}", operands[0])  # raises
    steps = _lr_steps(tuple(subs), out)
    cur = operands[0].to(dtype)
    for eq, op in zip(steps, operands[1:]):
        cur = torch.einsum(eq, cur, op.to(dtype))
    if len(steps) == len(operands):  # a final trace or permutation
        cur = torch.einsum(steps[-1], cur)
    return cur


@lru_cache(maxsize=None)
def _lr_steps(subs, out):
    """The pairwise equations of :func:`lr_einsum` (and a last one-operand
    equation where the result still needs reducing or permuting)."""
    steps = []
    cur = subs[0]
    for k in range(1, len(subs)):
        later = set(out).union(*subs[k + 1:])
        keep = "".join(dict.fromkeys(c for c in cur + subs[k] if c in later))
        steps.append(f"{cur},{subs[k]}->{keep}")
        cur = keep
    if cur != out:
        steps.append(f"{cur}->{out}")
    return tuple(steps)


def _node_tensor(node):
    return node.tensor if node.node_type == "dense" else node.base_node.tensor


def _check_edge(edge):
    if edge.var_dim:
        raise TNError(f"edge {edge.name} has undetermined dimension")
    if edge.name[0] == edge.name[1]:
        raise TNError(
            f"self-loop edge {edge.name}: BP cannot split a trace — "
            "contract it into the node first")


def _common(tensors, device):
    """Node tensors as torch tensors of one dtype on one device."""
    dev = resolve_device(device, tensors)
    dtypes = [torch_dtype(t.dtype) if not isinstance(t, torch.Tensor)
              else t.dtype for t in tensors]
    dtype = dtypes[0] if dtypes else torch.float64
    for dt in dtypes[1:]:
        dtype = torch.promote_types(dtype, dt)
    if not (dtype.is_floating_point or dtype.is_complex):
        dtype = torch.float64
    return dev, dtype


class _Layout:
    """Where each message slot lives: slot ``2*e + side`` (the message
    leaving side ``side`` of edge ``e``) is row ``row[s]`` of the flat
    tensor of its bond dimension ``key[s]``."""

    def __init__(self, dims, matrix):
        self.matrix = matrix
        self.key = [dims[s // 2] for s in range(2 * len(dims))]
        self.count = {}
        self.row = []
        for k in self.key:
            self.row.append(self.count.get(k, 0))
            self.count[k] = self.row[-1] + 1
        self.keys = sorted(self.count)

    def ones(self, dtype, device):
        return {
            k: torch.ones((n,) + ((k, k) if self.matrix else (k,)),
                          dtype=dtype, device=device)
            for k, n in self.count.items()
        }

    def rows(self, slots, device):
        """(key, row index tensor) of slots that share one bond dimension."""
        keys = {self.key[s] for s in slots}
        assert len(keys) == 1, keys
        return keys.pop(), torch.tensor([self.row[s] for s in slots],
                                        dtype=torch.long, device=device)

    def get(self, msgs, slot):
        return msgs[self.key[slot]][self.row[slot]]


class _CopyGroup:
    """Copy nodes of one (degree, dim): leave-one-out elementwise products."""

    def __init__(self, layout, inbound, outbound, device):
        self.key, self.inb = layout.rows(
            [s for row in inbound for s in row], device)
        self.inb = self.inb.reshape(len(inbound), -1)
        _, self.outb = layout.rows(
            [s for row in outbound for s in row], device)
        self.out_keys = [self.key]

    positions = ()

    def prepare(self, _stacked):
        return None

    def messages(self, _t, msgs):
        stack = msgs[self.key][self.inb]  # (G, degree, dim)
        ones = torch.ones_like(stack[:, :1])
        fwd = torch.cumprod(torch.cat([ones, stack[:, :-1]], 1), dim=1)
        bwd = torch.cumprod(
            torch.cat([ones, stack.flip(1)[:, :-1]], 1), dim=1).flip(1)
        return [(fwd * bwd).reshape(-1, stack.shape[-1])]

    def z(self, _t, msgs):
        return msgs[self.key][self.inb].prod(1).sum(-1)


class _DenseGroup:
    """Dense nodes of one shape; vector messages."""

    def __init__(self, layout, positions, inbound, outbound, device):
        self.positions = positions
        k = len(inbound[0])
        if k > len(_LETTERS) - 1:
            raise TNError(f"dense node of order {k} exceeds BP symbol budget")
        cols = list(zip(*inbound)) if k else []
        self.inb = [layout.rows(c, device) for c in cols]
        self.outb = [layout.rows(c, device)[1] for c in zip(*outbound)] \
            if k else []
        self.out_keys = [key for key, _ in self.inb]
        self.outb = torch.cat(self.outb) if self.outb else None

    def prepare(self, stacked):
        return stacked

    def _vectors(self, msgs):
        return [msgs[key][rows] for key, rows in self.inb]

    def messages(self, t, msgs):
        vecs = self._vectors(msgs)
        k = len(vecs)
        base = "Z" + _LETTERS[:k]
        out = []
        for i in range(k):
            subs = [base] + ["Z" + _LETTERS[j] for j in range(k) if j != i]
            ops = [t] + [vecs[j] for j in range(k) if j != i]
            out.append(lr_einsum(subs, "Z" + _LETTERS[i], *ops))
        return out

    def z(self, t, msgs):
        vecs = self._vectors(msgs)
        k = len(vecs)
        subs = ["Z" + _LETTERS[:k]] + ["Z" + _LETTERS[j] for j in range(k)]
        return lr_einsum(subs, "Z", t, *vecs)


class _KetGroup:
    """Nodes of a doubled (norm) network with one (shape, physical modes):
    the node is ``K conj(K)`` with the physical modes traced, never built.
    Matrix messages ``M[ket, bra]``."""

    def __init__(self, layout, positions, phys, bond_modes, inbound,
                 outbound, device):
        self.positions = positions
        self.perm = list(phys) + list(bond_modes)
        k = len(bond_modes)
        if 2 * k + 2 > len(_LETTERS):
            raise TNError(f"node order {k} exceeds the BP symbol budget")
        self.inb = [layout.rows(c, device) for c in zip(*inbound)] \
            if k else []
        outb = [layout.rows(c, device)[1] for c in zip(*outbound)] \
            if k else []
        self.out_keys = [key for key, _ in self.inb]
        self.outb = torch.cat(outb) if outb else None
        self.ket = _LETTERS[:k]
        self.bra = _LETTERS[k:2 * k]

    def prepare(self, stacked):
        """``(G, P, chi_1, ..., chi_k)``: physical modes fused in front."""
        t = stacked.permute([0] + [1 + m for m in self.perm])
        n_phys = len(self.perm) - len(self.ket)
        return t.reshape((t.shape[0], -1) + tuple(t.shape[1 + n_phys:]))

    def _mats(self, msgs):
        return [msgs[key][rows] for key, rows in self.inb]

    def _close(self, t, mats, skip, out):
        """``K`` closed with the incoming matrices on every bond mode but
        ``skip``, then with ``conj(K)`` (physical modes traced)."""
        subs = ["ZY" + self.ket]
        ops = [t]
        for j, m in enumerate(mats):
            if j != skip:
                subs.append("Z" + self.ket[j] + self.bra[j])
                ops.append(m)
        subs.append("ZY" + self.bra)
        ops.append(t.conj())
        return lr_einsum(subs, out, *ops)

    def messages(self, t, msgs):
        mats = self._mats(msgs)
        return [self._close(t, mats, i, "Z" + self.ket[i] + self.bra[i])
                for i in range(len(mats))]

    def z(self, t, msgs):
        return self._close(t, self._mats(msgs), None, "Z")


class BPGraph:
    """The BP structure of one network, planned once: node groups, the
    message layout and every gather/scatter index (see the module doc).

    ``doubled=False`` plans the closed network itself (vector messages);
    ``doubled=True`` plans its norm network ``T (x) conj(T)`` with the
    dangling (physical) modes traced and one matrix message per bond
    direction.  ``bonds`` lists, per bond edge in ``tn.edges()`` order,
    ``[dim, [(node_pos, mode, side), ...]]``.
    """

    def __init__(self, tn, doubled=False, device=None):
        by_name = tn._nodes
        edges = []
        for edge in tn.edges():
            n1, n2, _ = edge.name
            if by_name[n1].dangler or by_name[n2].dangler:
                if not doubled:
                    raise TNError(
                        "bp_contract needs a closed network (no dangling "
                        f"edges); edge {edge.name} is dangling")
                continue
            _check_edge(edge)
            edges.append(edge)
        edge_index = {e.name: i for i, e in enumerate(edges)}
        self.dims = [e.dim for e in edges]
        self.bonds = [[e.dim, []] for e in edges]
        self.names = []
        self.wiring = []  # per node: [(edge, inbound slot, outbound slot)]
        tensors = []
        signature = {}  # group key -> (positions, inbound, outbound, modes)
        for pos, node in enumerate(tn.nodes()):
            name = node.name
            self.names.append(name)
            kind = node.node_type
            if kind == "input":
                raise TNError(
                    f"{'bp_gauge/bp_norm' if doubled else 'bp_contract'} "
                    f"needs concrete tensors; input node '{name}' has none")
            if doubled and kind == "hyper":
                raise TNError(
                    "bp_gauge/bp_norm need dense tensors on every core; "
                    f"copy node '{name}' cannot absorb a gauge transform")
            wiring, phys, modes = [], [], []
            for mode, edge_name in enumerate(node.edge_names):
                e = edge_index.get(edge_name)
                if e is None:  # a dangling (physical) mode
                    phys.append(mode)
                    continue
                side = 0 if edge_name[0] == name else 1
                wiring.append((e, 2 * e + 1 - side, 2 * e + side))
                self.bonds[e][1].append((pos, mode, side))
                modes.append(mode)
            self.wiring.append(wiring)
            if kind == "hyper":
                key = ("copy", node.degree, node.dim)
                tensors.append(None)
            else:
                t = _node_tensor(node)
                tensors.append(t)
                key = ("ket", tuple(t.shape), tuple(phys)) if doubled \
                    else ("dense", tuple(t.shape))
            entry = signature.get(key)
            if entry is None:
                entry = signature[key] = ([], [], [], modes)
            entry[0].append(pos)
            entry[1].append([w[1] for w in wiring])
            entry[2].append([w[2] for w in wiring])
        self._tensors = tensors
        dense = [t for t in tensors if t is not None]
        self.device, self.dtype = _common(dense, device)
        self.layout = _Layout(self.dims, matrix=doubled)
        self.groups = []
        for key, (positions, inb, outb, modes) in signature.items():
            if key[0] == "copy":
                group = _CopyGroup(self.layout, inb, outb, self.device)
            elif key[0] == "dense":
                group = _DenseGroup(self.layout, positions, inb, outb,
                                    self.device)
            else:
                group = _KetGroup(self.layout, positions, key[2], modes,
                                  inb, outb, self.device)
            self.groups.append(group)
        # one scatter per bond dimension: the rows each group writes, in
        # group and mode order, and the permutation that sorts them
        written = {k: [] for k in self.layout.keys}
        self._order = []  # per group: list of keys of its outputs
        for group in self.groups:
            if isinstance(group, _CopyGroup):
                written[group.key].append(group.outb)
                self._order.append([group.key])
            else:
                g = len(group.positions)
                outs = group.outb.split(g) if group.outb is not None else []
                for key, rows in zip(group.out_keys, outs):
                    written[key].append(rows)
                self._order.append(list(group.out_keys))
        self._unsort = {
            k: torch.argsort(torch.cat(v)) for k, v in written.items() if v
        }
        # Bethe edge factors: the two opposing rows of every edge
        self._pairs = {}
        for e, dim in enumerate(self.dims):
            self._pairs.setdefault(dim, ([], []))
            self._pairs[dim][0].append(self.layout.row[2 * e])
            self._pairs[dim][1].append(self.layout.row[2 * e + 1])
        self._pairs = {
            k: (torch.tensor(a, device=self.device),
                torch.tensor(b, device=self.device))
            for k, (a, b) in self._pairs.items()
        }

    # -------------------------------------------------------------- tensors

    def node_tensors(self):
        """The network's node tensors (``tn.nodes()`` order; None for copy
        nodes) as torch tensors of the common dtype on the device."""
        return [None if t is None else as_tensor(t, self.device, self.dtype)
                for t in self._tensors]

    def stacks(self, tensors=None):
        """Per group, its nodes' tensors stacked (differentiable), from
        ``tensors`` in ``tn.nodes()`` order or, by default, the network's
        own (numpy ones stacked on the host and moved in one copy)."""
        out = []
        for group in self.groups:
            if not group.positions:
                out.append(None)
                continue
            if tensors is not None:
                stacked = torch.stack([tensors[p] for p in group.positions])
            else:
                raw = [self._tensors[p] for p in group.positions]
                if any(isinstance(t, torch.Tensor) for t in raw):
                    stacked = torch.stack(
                        [as_tensor(t, self.device, self.dtype) for t in raw])
                else:
                    stacked = as_tensor(np.stack([np.asarray(t) for t in raw]),
                                        self.device, self.dtype)
            out.append(group.prepare(stacked))
        return out

    # -------------------------------------------------------------- sweeps

    def init_messages(self):
        return self.layout.ones(self.dtype, self.device)

    def sweep(self, stacks, msgs, damping):
        """One synchronous sweep; returns the damped, normalized messages."""
        outs = {k: [] for k in self.layout.keys}
        for group, t, keys in zip(self.groups, stacks, self._order):
            for key, m in zip(keys, group.messages(t, msgs)):
                outs[key].append(m)
        new = {}
        for key, parts in outs.items():
            m = torch.cat(parts)[self._unsort[key]]
            m = (1.0 - damping) * m + damping * msgs[key]
            dims = tuple(range(1, m.ndim))
            s = m.abs().mean(dim=dims, keepdim=True)
            tiny = torch.finfo(real_dtype(m.dtype)).tiny
            new[key] = m / torch.clamp(s, min=tiny)
        return new

    def fixed_point(self, stacks, tol, max_iter, damping):
        """Sweeps until ``max|new - old| <= tol`` or ``max_iter``; returns
        ``(sweeps, delta, messages)``."""
        msgs = self.init_messages()
        i, delta = 0, float("inf")
        while i < max_iter and delta > tol:
            new = self.sweep(stacks, msgs, damping)
            delta = float(torch.stack(
                [(new[k] - msgs[k]).abs().max() for k in new]).max()) \
                if new else 0.0
            msgs = new
            i += 1
        return i, delta, msgs

    def sweeps(self, stacks, n_sweeps, damping):
        """Exactly ``n_sweeps`` sweeps (differentiable)."""
        msgs = self.init_messages()
        for _ in range(n_sweeps):
            msgs = self.sweep(stacks, msgs, damping)
        return msgs

    def bethe(self, stacks, msgs):
        """Split-format ``Z_BP = prod_a Z_a / prod_e Z_e``."""
        factors = [group.z(t, msgs).reshape(-1)
                   for group, t in zip(self.groups, stacks)]
        for key, (a, b) in self._pairs.items():
            m = msgs[key]
            prod = (m[a] * m[b]).reshape(a.shape[0], -1).sum(-1)
            factors.append(1.0 / prod)
        zs = torch.cat(factors)
        mag = zs.abs()
        log = torch.log(mag).sum()
        tiny = torch.finfo(mag.dtype).tiny
        phase = torch.prod(zs / torch.clamp(mag, min=tiny))
        return phase, log

    def message(self, msgs, slot):
        return self.layout.get(msgs, slot)


def _solve(tn, tol, max_iter, damping, device, doubled=False):
    graph = BPGraph(tn, doubled=doubled, device=device)
    stacks = graph.stacks()
    iters, delta, msgs = graph.fixed_point(stacks, tol, max_iter, damping)
    phase, log = graph.bethe(stacks, msgs)
    return graph, iters, msgs, phase, log


def bp_contract(tn, tol=1e-12, max_iter=200, damping=0.0,
                split_format=True, device=None):
    """Bethe/BP approximation of the closed network's contraction.

    Exact on trees (including copy nodes); the Bethe approximation on
    loopy graphs — e.g. on a single ring of matrices it returns
    ``lambda_max^N``, dropping the subleading eigenvalue orbits.

    Args:
        tn: a closed :class:`~contractn_tpu_torch.network.TN` (no danglers).
        tol: message convergence threshold (max-abs change of the
            normalized messages between synchronous sweeps).
        max_iter: sweep cap.
        damping: mix ``damping`` of the old message into each update —
            use ~0.5 on frustrated/oscillating loopy graphs.
        split_format: return ``(phase_mantissa, log)`` (default) or the
            dense scalar.
        device: where to compute; default: the node tensors' device, else
            the GPU (:mod:`..utils.device`).

    Returns:
        ``(mantissa, log)`` with ``value = mantissa * exp(log)``, or the
        dense scalar if ``split_format=False``.
    """
    _, _, _, phase, log = _solve(tn, tol, max_iter, damping, device)
    if split_format:
        return phase, log
    return phase * torch.exp(log)


def bp_environment(tn, node, tol=1e-12, max_iter=200, damping=0.0,
                   device=None):
    """Fixed-point incoming messages of ``node`` — its BP environment,
    one vector per tensor mode (exact single-mode environments on
    trees; the Bethe environment otherwise).  ``node`` may be a name or
    a Node.  Also returns the sweep count actually used."""
    name = node if isinstance(node, str) else node.name
    graph, iters, msgs, _, _ = _solve(tn, tol, max_iter, damping, device)
    try:
        pos = graph.names.index(name)
    except ValueError:
        raise TNError(f"No core node named '{name}' in this TN")
    return [graph.message(msgs, i) for (_, i, _) in graph.wiring[pos]], \
        int(iters)

