"""Checkpoint / serialization for tensor networks.

Counterpart of ``contractn_tpu/utils/checkpoint.py``, with the same file
layout, so that a file saved by either package loads in the other.  A TN is
exactly (graph topology, parameters):

* ``tn_spec(tn)`` captures the topology as a plain-JSON-serializable dict
  (node types, names, symbols, shapes, bonds) with parameters EXCLUDED;
* ``save_tn`` / ``load_tn`` persist spec + params to an ``.npz`` file
  (``__spec__`` holds the JSON, ``param_i`` the i-th dense node's tensor);
  ``load_tn`` puts the parameters on the device the caller names, by default
  the GPU (:mod:`.device`).

Rebuild order is deterministic: nodes are re-added in insertion order with
their original names and edge symbols, then bonds are re-connected, so the
restored TN produces byte-identical einsum strings.
"""

import json

import numpy as np
import torch

from ..network import TN
from .device import as_tensor, resolve_device

_SPEC_VERSION = 1


def tn_spec(tn):
    """Topology-only description of a TN as a JSON-serializable dict."""
    nodes = []
    for node in tn.nodes(as_iter=True, copy_nodes=True, danglers=False):
        entry = {"name": node.name, "type": node.node_type}
        if node.node_type == "hyper":
            entry["degree"] = node.degree
            entry["dim"] = node.dim
        elif node.node_type == "input":
            entry["shape"] = list(node._shape)
            entry["var_axes"] = list(node.var_axes)
        elif node.node_type == "clone":
            entry["base"] = node.base_node.name
        nodes.append(entry)

    bonds = []
    for edge in tn.edges(as_iter=True):
        if edge.dangler:
            continue
        n1, n2 = edge.nodes
        if n1.name == n2.name:
            # Self-loop (trace) edge: ONE node holds this edge id at two
            # distinct mode positions; Node.index would return the first
            # one for both ends, producing an unreconstructable spec.
            idxs = [i for i, en in enumerate(n1.edge_names)
                    if en == edge.name]
            index1, index2 = idxs[0], idxs[1]
        else:
            index1, index2 = n1.index(edge), n2.index(edge)
        bonds.append({
            "node1": n1.name,
            "index1": index1,
            "node2": n2.name,
            "index2": index2,
            "symbol": edge.symbol,
        })

    # Record the full per-node symbol layout so reconstruction is exact
    symbols = {
        node.name: list(node.edge_symbols)
        for node in tn.nodes(as_iter=True, copy_nodes=True, danglers=False)
    }
    return {
        "version": _SPEC_VERSION,
        "nodes": nodes,
        "bonds": bonds,
        "symbols": symbols,
    }


def tn_from_spec(spec, params):
    """Rebuild a TN from :func:`tn_spec` output and a parameter sequence
    (tensors are used as given)."""
    if spec.get("version") != _SPEC_VERSION:
        raise ValueError(f"Unsupported TN spec version {spec.get('version')}")
    tn = TN()
    params = list(params)
    p_idx = 0
    for entry in spec["nodes"]:
        name, ntype = entry["name"], entry["type"]
        if ntype == "dense":
            tn.add_dense_node(params[p_idx], name=name)
            p_idx += 1
        elif ntype == "clone":
            tn.add_duplicate_node(entry["base"], name=name)
        elif ntype == "hyper":
            tn.add_copy_node(entry["degree"], dim=entry["dim"], name=name)
        elif ntype == "input":
            tn.add_input_node(
                tuple(entry["shape"]),
                var_shape_axes=tuple(entry["var_axes"]),
                name=name,
            )
        else:
            raise ValueError(f"Unknown node type {ntype!r} in spec")
    if p_idx != len(params):
        raise ValueError(
            f"Spec has {p_idx} dense nodes but {len(params)} params given"
        )
    for bond in spec["bonds"]:
        tn.connect_nodes(
            bond["node1"], bond["node2"], bond["index1"], bond["index2"],
        )
    # Restore the recorded symbol layout exactly (allocation order during
    # reconstruction may differ from the original's history)
    _restore_symbols(tn, spec["symbols"])
    return tn


def _restore_symbols(tn, symbols):
    tn._bump()  # direct symbol rewrites invalidate cached compile specs
    for name, syms in symbols.items():
        node = tn[name]
        for idx, sym in enumerate(syms):
            edge = node[idx]
            if edge.symbol != sym:
                tn._release_symbol(edge.symbol)
                tn._claim_symbol(sym)
                edge._symbol = sym


def _host_array(tensor):
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def save_tn(path, tn):
    """Persist a TN (topology + parameters) to an ``.npz`` file."""
    spec = tn_spec(tn)
    arrays = {
        f"param_{i}": _host_array(p) for i, p in enumerate(tn.params)
    }
    np.savez(path, __spec__=json.dumps(spec), **arrays)


def load_tn(path, device=None):
    """Load a TN persisted with :func:`save_tn` (by either package), its
    parameters as torch tensors on ``device`` (default: the GPU; pass
    ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        spec = json.loads(str(data["__spec__"]))
        n_dense = sum(1 for n in spec["nodes"] if n["type"] == "dense")
        params = [as_tensor(data[f"param_{i}"], dev) for i in range(n_dense)]
    return tn_from_spec(spec, params)
