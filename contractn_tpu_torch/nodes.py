"""Typed nodes of a tensor network.

Counterpart of ``contractn_tpu/nodes.py``.  Five node types:

==========  ==============================================================
``dense``   Owns a parameter tensor; contributes one einsum operand.
``clone``   Weight-sharing duplicate of a dense node; contributes an
            operand aliasing the base node's parameter.
``hyper``   Copy tensor / hyperedge: an order-n generalized diagonal that
            is never materialized.  All of its edges share one einsum
            symbol, so it lowers to a repeated index instead of a tensor.
``input``   Placeholder whose tensor is supplied at contraction time; may
            have variable (``-1``) axes.
``dangler`` Synthetic terminator for an open mode.  Internal only; its
            symbol becomes an output index of the einsum string.
==========  ==============================================================

A dense node's tensor may be a torch tensor (it stays on its device) or a
numpy array (placed on a device when the network is contracted).
"""

from math import prod

from .edges import Edge
from .utils.errors import TNError, attribute_error_for, check_valid_tensor

NODE_TYPES = ("dense", "clone", "hyper", "input", "dangler")


def _shape_of(tensor):
    return tuple(int(d) for d in tensor.shape)


class Node:
    """Generic node of a TN. Created through ``TN.add_*_node`` methods."""

    __slots__ = (
        "tn",
        "name",
        "_node_type",
        "edge_names",  # ordered list of edge ids, one per tensor mode
        "_tensor",  # dense
        "_base_node",  # clone
        "_degree",  # hyper
        "_dim",  # hyper
        "_shape",  # input
        "_var_axes",  # input
    )

    def __init__(self, parent_tn, node_type, name, n_modes, **kwargs):
        if node_type not in NODE_TYPES:
            raise TNError(f"Unknown node type {node_type!r}; options: {NODE_TYPES}")
        self.tn = parent_tn
        self.name = name
        self._node_type = node_type
        self.edge_names = [None] * n_modes
        self._tensor = None
        self._base_node = None
        self._degree = None
        self._dim = None
        self._shape = None
        self._var_axes = None

        if node_type == "dense":
            tensor = kwargs.pop("tensor")
            check_valid_tensor(tensor)
            if n_modes != tensor.ndim:
                raise TNError(
                    f"Dense node has {n_modes} edge symbols but tensor of "
                    f"order {tensor.ndim}"
                )
            self._tensor = tensor

        elif node_type == "clone":
            base = kwargs.pop("base_node")
            if base.node_type != "dense":
                raise TNError(
                    "Duplicate nodes must be cloned from dense nodes, got "
                    f"base node of type '{base.node_type}'"
                )
            if n_modes != base.tensor.ndim:
                raise TNError("Clone edge-symbol count must match base tensor order")
            self._base_node = base

        elif node_type == "hyper":
            degree = kwargs.pop("degree")
            dim = kwargs.pop("dim", None)
            if not isinstance(degree, int) or degree <= 0:
                raise TNError("Copy (hyperedge) nodes must have positive degree")
            if n_modes != degree:
                raise TNError("Copy node edge-symbol count must equal its degree")
            if dim is not None and not isinstance(dim, int):
                raise TNError(f"Copy node dim must be an int or None, got {dim!r}")
            self._degree = degree
            self._dim = dim

        elif node_type == "input":
            shape = tuple(kwargs.pop("shape"))
            var_axes = tuple(kwargs.pop("var_axes", ()))
            if n_modes != len(shape):
                raise TNError("Input node edge-symbol count must match its shape")
            if len(set(var_axes)) != len(var_axes):
                raise TNError("Variable axes of an input node must be unique")
            if not all(0 <= va < n_modes for va in var_axes):
                raise TNError(
                    f"Variable axes {var_axes} out of range for order-{n_modes} input"
                )
            self._shape = shape
            self._var_axes = var_axes

        if kwargs:
            bad = sorted(kwargs)
            raise TypeError(
                f"Argument '{bad[0]}' not recognized for node_type '{node_type}'"
            )

    # ------------------------------------------------------------------ #
    # Type predicates
    # ------------------------------------------------------------------ #

    @property
    def node_type(self):
        return self._node_type

    @property
    def dangler(self):
        return self._node_type == "dangler"

    @property
    def is_copy(self):
        return self._node_type == "hyper"

    @property
    def G(self):
        """The owning TN's layout as a ``networkx.MultiGraph`` — the same
        snapshot as :meth:`TN.to_networkx` (mutating it does not mutate the
        TN; raises :class:`TNError` without networkx)."""
        return self.tn.to_networkx()

    # ------------------------------------------------------------------ #
    # Edges and symbols
    # ------------------------------------------------------------------ #

    @property
    def edges(self):
        """Ordered tuple of Edge objects, one per tensor mode."""
        get = self.tn._edges.__getitem__
        return tuple(get(en) for en in self.edge_names)

    @property
    def edge_symbols(self):
        """Ordered tuple of einsum symbols, one per tensor mode."""
        get = self.tn._edges.__getitem__
        return tuple(get(en).symbol for en in self.edge_names)

    @property
    def symbol(self):
        """The symbol of a dangling node's single edge (danglers only)."""
        if not self.dangler:
            raise TNError(
                "Only dangling nodes have a single .symbol; use "
                ".edge_symbols for core nodes"
            )
        return self.tn._edges[self.edge_names[0]].symbol

    def _dang_name(self, idx):
        """Name of the dangling node terminating mode ``idx``.

        Raises if the mode is already bonded to a core node.
        """
        n_modes = len(self.edge_names)
        if not -n_modes <= idx < n_modes:
            raise TNError(
                f"Mode index {idx} out of range for node "
                f"'{self.name}' with {n_modes} modes"
            )
        edge_id = self.edge_names[idx]
        other = edge_id[1] if edge_id[0] == self.name else edge_id[0]
        if not self.tn._nodes[other].dangler:
            raise TNError(
                f"Mode {idx} of node '{self.name}' is already connected "
                f"(to '{other}')"
            )
        return other

    @property
    def neighbors(self):
        """Nodes at the far end of each mode's edge, in mode order."""
        out = []
        for edge_id in self.edge_names:
            other = edge_id[1] if edge_id[0] == self.name else edge_id[0]
            out.append(self.tn._nodes[other])
        return tuple(out)

    def __getitem__(self, key):
        """Edge at mode ``key`` (negative indices allowed)."""
        return self.tn._edges[self.edge_names[key]]

    def index(self, edge):
        """Mode index of ``edge``; inverse of ``__getitem__``."""
        if isinstance(edge, Edge):
            edge = edge.name
        try:
            return self.edge_names.index(edge)
        except ValueError:
            raise TNError(f"Edge {edge!r} is not incident to node '{self.name}'")

    @property
    def dict(self):
        """Read-only attribute-dict snapshot of the node's state."""
        out = {
            "node_type": self._node_type,
            "edge_names": list(self.edge_names),
            "tn_node": self,
        }
        if self._node_type == "dense":
            out["tensor"] = self._tensor
        elif self._node_type == "clone":
            out["base_node"] = self._base_node
        elif self._node_type == "hyper":
            out["degree"] = self._degree
            out["dim"] = self._dim
        elif self._node_type == "input":
            out["_shape"] = self._shape
            out["var_axes"] = self._var_axes
        return out

    # ------------------------------------------------------------------ #
    # Shape logic
    # ------------------------------------------------------------------ #

    @property
    def ndim(self):
        return len(self.edge_names)

    @property
    def shape(self):
        """Tensor shape; ``-1`` marks a still-undetermined dimension."""
        nt = self._node_type
        if nt == "dense":
            return _shape_of(self._tensor)
        if nt == "clone":
            return _shape_of(self._base_node.tensor)
        if nt == "hyper":
            return (-1 if self._dim is None else self._dim,) * self._degree
        if nt == "input":
            return tuple(
                -1 if i in self._var_axes else d for i, d in enumerate(self._shape)
            )
        return (-1,)  # dangler

    @property
    def size(self):
        """Element count implied by the shape; None while any dim is variable."""
        if self._node_type == "dangler":
            return None
        shape = self.shape
        return None if any(d < 0 for d in shape) else prod(shape)

    @property
    def numel(self):
        """Elements actually stored in memory: nonzero only for dense nodes."""
        if self._node_type == "dense":
            return prod(_shape_of(self._tensor))
        return 0

    # ------------------------------------------------------------------ #
    # Type-specific attributes
    # ------------------------------------------------------------------ #

    @property
    def tensor(self):
        if self._node_type != "dense":
            raise attribute_error_for("dense", "tensor", self.name, self._node_type)
        return self._tensor

    @tensor.setter
    def tensor(self, array):
        if self._node_type != "dense":
            raise attribute_error_for("dense", "tensor", self.name, self._node_type)
        check_valid_tensor(array)
        if array.ndim != self.ndim:
            raise TNError(
                f"New tensor for node '{self.name}' has order {array.ndim}, "
                f"expected {self.ndim}"
            )
        self._tensor = array

    @property
    def base_node(self):
        if self._node_type != "clone":
            raise attribute_error_for("clone", "base_node", self.name, self._node_type)
        return self._base_node

    @property
    def degree(self):
        if self._node_type != "hyper":
            raise attribute_error_for("hyper", "degree", self.name, self._node_type)
        return self._degree

    @property
    def dim(self):
        if self._node_type != "hyper":
            raise attribute_error_for("hyper", "dim", self.name, self._node_type)
        return self._dim

    @property
    def var_axes(self):
        if self._node_type != "input":
            raise attribute_error_for("input", "var_axes", self.name, self._node_type)
        return self._var_axes

    def __repr__(self):
        return (
            f"Node(name={self.name!r}, node_type={self._node_type}, "
            f"degree={self.ndim})"
        )
