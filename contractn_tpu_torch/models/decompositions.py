"""Classic tensor-decomposition layouts as TN graphs.

Counterpart of ``contractn_tpu/models/decompositions.py``: one-call constructors
for CP and Tucker hubs, tensor rings, MPS and matrix chains and random
regular networks, all returning :class:`TN` graphs that contract through
the standard engine.  They build graphs on the host: node tensors are
kept as given (numpy arrays stay numpy until a contraction places them), and
:func:`random_regular_tn` draws from the same numpy ``Generator`` calls as
the JAX package's, so one seed builds the identical network in both.
"""

import numpy as np
import torch

from ..network import TN


def cp_tn(factors):
    """CP decomposition: a copy-tensor hub joined to ``len(factors)`` matrices.

    Each factor is ``(rank, out_dim)``; the contraction yields the full
    ``(out_1, ..., out_k)`` tensor ``sum_r prod_i F_i[r, :]``.  The hub is a
    hyperedge, so the rank index is fused — no ``rank^k`` diagonal tensor
    exists at any point.
    """
    factors = list(factors)
    if len(factors) < 2:
        raise ValueError("CP decompositions need at least 2 factor matrices")
    rank = factors[0].shape[0]
    if any(f.ndim != 2 or f.shape[0] != rank for f in factors):
        raise ValueError("CP factors must be (rank, out_dim) matrices")
    tn = TN()
    hub = tn.add_copy_node(len(factors), dim=rank)
    for i, f in enumerate(factors):
        node = tn.add_dense_node(f)
        tn.connect_nodes(hub, node, i, 0)
    return tn


def tucker_tn(core, factors):
    """Tucker decomposition: dense core with one factor matrix per mode.

    ``core`` is ``(r_1, ..., r_k)``; ``factors[i]`` is ``(r_i, out_i)``.
    """
    factors = list(factors)
    if core.ndim != len(factors):
        raise ValueError(
            f"Core has {core.ndim} modes but {len(factors)} factors given"
        )
    tn = TN()
    hub = tn.add_dense_node(core)
    for i, f in enumerate(factors):
        if f.shape[0] != core.shape[i]:
            raise ValueError(
                f"Factor {i} rank {f.shape[0]} != core dim {core.shape[i]}"
            )
        node = tn.add_dense_node(f)
        tn.connect_nodes(hub, node, i, 0)
    return tn


def mps_tn(tensors):
    """Open MPS chain as a TN graph.

    ``tensors[0]`` is ``(d, D)``, interior ``(d, D, D)``, last ``(d, D)``;
    contraction leaves one physical mode per site.
    """
    tensors = list(tensors)
    if len(tensors) < 2:
        raise ValueError("MPS chains need at least 2 cores")
    tn = TN()
    nodes = [tn.add_dense_node(t) for t in tensors]
    n = len(nodes)
    for i in range(n - 1):
        tn.connect_nodes(nodes[i], nodes[i + 1], -1, -2 if i != n - 2 else -1)
    return tn


def tensor_ring_tn(tensors):
    """Periodic MPS (tensor ring): every core is ``(d, D, D)``, bonds close
    into a cycle.  Exercises contraction paths with a loop."""
    tensors = list(tensors)
    if len(tensors) < 3:
        raise ValueError("Tensor rings need at least 3 cores")
    tn = TN()
    nodes = [tn.add_dense_node(t) for t in tensors]
    n = len(nodes)
    for i in range(n):
        # bond: right leg (axis 2) of node i to left leg (axis 1) of node i+1
        tn.connect_nodes(nodes[i], nodes[(i + 1) % n], 2, 1)
    return tn


def random_regular_tn(num_nodes, degree, bond_dim, rng=None, scale=None):
    """Random ``degree``-regular closed TN.

    Every node is a random order-``degree`` tensor; edges pair up node
    modes uniformly at random (configuration model, resampled until no
    mode pairs with its own node twice in a way that leaves self-loops —
    self-loops are allowed, parallel edges are allowed, exactly as in
    random regular multigraphs).  These graphs have no low-treewidth
    structure, so they exercise the contraction-path optimizer with
    genuinely nontrivial orderings.

    Returns ``(tn, nodes)``.
    """
    if (num_nodes * degree) % 2:
        raise ValueError("num_nodes * degree must be even")
    rng = rng or np.random.default_rng()
    if scale is None:
        scale = 1.0 / np.sqrt(bond_dim)
    tn = TN()
    nodes = [
        tn.add_dense_node(
            scale * rng.standard_normal((bond_dim,) * degree)
        )
        for _ in range(num_nodes)
    ]
    stubs = [(i, k) for i in range(num_nodes) for k in range(degree)]
    rng.shuffle(stubs)
    for a in range(0, len(stubs), 2):
        (i1, k1), (i2, k2) = stubs[a], stubs[a + 1]
        tn.connect_nodes(nodes[i1], nodes[i2], k1, k2)
    return tn, nodes


def matrix_chain_tn(matrices, left_vec=None, right_vec=None):
    """Vector-matrix-...-matrix chain (the README's 1000-link example),
    optionally capped with boundary vectors."""
    tn = TN()
    prev = None
    if left_vec is not None:
        prev = tn.add_dense_node(_as_node_tensor(left_vec))
    for m in matrices:
        node = tn.add_dense_node(m)
        if prev is not None:
            tn.connect_nodes(prev, node, -1, 0)
        prev = node
    if right_vec is not None:
        node = tn.add_dense_node(_as_node_tensor(right_vec))
        tn.connect_nodes(prev, node, -1, 0)
    return tn


def _as_node_tensor(value):
    """Torch tensors as they are (on their device), anything else as numpy."""
    return value if isinstance(value, torch.Tensor) else np.asarray(value)
