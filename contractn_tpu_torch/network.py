"""Tensor-network graph container.

Counterpart of ``contractn_tpu/network.py``.  ``TN`` owns the network
layout: typed nodes (dense / clone / hyper / input), synthetic dangling nodes
terminating every open mode, multigraph edges with dimensions and einsum
symbols, and the symbol-bookkeeping rules that turn a layout into an einsum
specification.  The graph layer is plain Python; only ``merge_nodes`` and
the contraction entry points touch tensors.

* Own adjacency structure (no networkx): node and edge bookkeeping is O(1)
  dict work.
* ``connect_nodes`` accepts node *names* as well as Node objects and verifies
  both modes are dangling.
* Copy-node symbol unification rewrites **all** edges incident to a connected
  copy cluster, so a hyperedge always lowers to one repeated einsum index.
* Contraction goes through :func:`contractn_tpu_torch.compiler.engine.contract`
  on the GPU unless the caller asks for the CPU.
"""

import heapq
from collections import Counter

import numpy as np
import torch

from .edges import Edge
from .nodes import Node
from .symbols import check_symbol, get_symbol, symbol_index
from .utils.device import as_tensor
from .utils.errors import TNError, check_valid_tensor


class TN:
    """A tensor network supporting copy nodes and weight sharing."""

    def __init__(self):
        # name -> Node, insertion-ordered, danglers interleaved after parents
        self._nodes = {}
        # (n1, n2, key) -> Edge, insertion-ordered
        self._edges = {}
        # name -> list of edge ids incident to the node (bond + dangling)
        self._incident = {}
        # sorted (n1, n2) pair -> next parallel-edge key
        self._pair_keys = {}
        # symbol -> number of edges currently carrying it
        self._symbol_counts = Counter()
        # Incremental gap-reuse allocator: min-heap of candidate free
        # indices below the high-water mark (lazily validated on pop).
        # Same allocation order as a full scan for the lowest free index,
        # but O(log n) per symbol instead of O(n).
        self._free_idxs = []
        self._next_idx = 0
        self._dang_id = 0
        self._num_cores = 0
        self._type_counts = Counter()
        # Topology-mutation counter: invalidates the cached einstring /
        # arg-packer spec (every structural primitive bumps it)
        self._mutation = 0
        self._spec_cache = None
        # base-node name -> number of clones referencing it (keeps the
        # merge_nodes guard O(1) per the graph-layer design invariant)
        self._clone_bases = Counter()

    # ------------------------------------------------------------------ #
    # Node construction
    # ------------------------------------------------------------------ #

    def add_dense_node(self, tensor, name=None, edge_symbols=None):
        """Add a dense (parameter-carrying) node.
        """
        check_valid_tensor(tensor)
        edge_symbols = self._new_edge_symbols("dense", tensor.ndim, edge_symbols)
        return self._init_node("dense", name, edge_symbols, tensor=tensor)

    def add_duplicate_node(self, base_node, name=None, edge_symbols=None):
        """Add a weight-sharing clone of an existing dense node.

        Clones participate in contraction by aliasing the base node's
        parameter slot.
        """
        if not isinstance(base_node, Node):
            base_node = self[base_node]
        edge_symbols = self._new_edge_symbols("clone", base_node.ndim, edge_symbols)
        self._clone_bases[base_node.name] += 1
        return self._init_node("clone", name, edge_symbols, base_node=base_node)

    def add_copy_node(self, degree, dim=None, name=None, edge_symbols=None):
        """Add a copy tensor (hyperedge) of the given degree.

        Copy tensors are never materialized: all their edges share a single
        einsum symbol, so an order-101 copy node costs nothing beyond the
        repeated index.
        """
        if isinstance(edge_symbols, str):
            edge_symbols = (edge_symbols,) * degree
        edge_symbols = self._new_edge_symbols("hyper", degree, edge_symbols)
        return self._init_node("hyper", name, edge_symbols, degree=degree, dim=dim)

    def add_input_node(self, shape, var_shape_axes=(), name=None, edge_symbols=None):
        """Add an input placeholder node; its tensor arrives at contract time.
        """
        edge_symbols = self._new_edge_symbols("input", len(shape), edge_symbols)
        return self._init_node(
            "input", name, edge_symbols, shape=shape, var_axes=var_shape_axes
        )

    def _bump(self):
        """Record a topology mutation (invalidates cached compile specs)."""
        self._mutation += 1

    def _init_node(self, node_type, name, edge_symbols, **kwargs):
        """Create a core node plus one dangler per mode; register everything."""
        self._bump()
        if node_type == "dangler":
            raise TNError("Dangling nodes are created internally only")
        name = self._new_node_name(name)
        node = Node(self, node_type, name, len(edge_symbols), **kwargs)
        self._register_node(node)
        self._num_cores += 1
        self._type_counts[node_type] += 1
        for i, sym in enumerate(edge_symbols):
            self._new_dangler(node, i, sym)
        return node

    def _register_node(self, node):
        self._nodes[node.name] = node
        self._incident[node.name] = []

    def _new_dangler(self, parent, idx, edge_symbol):
        """Terminate mode ``idx`` of ``parent`` with a fresh dangling node.

        Trusted internal fast path: ``parent`` was just validated (or the
        edge being restored was), the dangler is fresh, and its variable
        dim merges to the parent's — so the general ``_init_edge``
        validation is skipped (profiled: it dominated 10k-node builds).
        """
        self._bump()
        dang_name = f"_dangler_{self._dang_id}"
        self._dang_id += 1
        dangler = Node(self, "dangler", dang_name, 1)
        self._register_node(dangler)

        n1, n2 = parent.name, dang_name
        pair = (n1, n2) if n1 <= n2 else (n2, n1)
        key = self._pair_keys.get(pair, 0)
        self._pair_keys[pair] = key + 1
        edge_id = (n1, n2, key)
        edge = Edge(self, edge_id, parent.shape[idx], edge_symbol)
        self._edges[edge_id] = edge
        self._incident[n1].append(edge_id)
        self._incident[n2].append(edge_id)
        self._claim_symbol(edge_symbol)
        parent.edge_names[idx] = edge_id
        dangler.edge_names[0] = edge_id
        if parent.is_copy:
            self._cleanup_edge_symbols(parent)
        return edge_id

    # ------------------------------------------------------------------ #
    # Edge construction / removal
    # ------------------------------------------------------------------ #

    def _init_edge(self, node1, node2, idx1, idx2, edge_symbol):
        """Add an edge between two registered nodes along modes idx1/idx2.

        Handles variable-dimension merging (``-1`` = undetermined): two
        variables stay variable, a variable adopts the concrete dimension,
        and two concrete dimensions must agree.
        """
        self._bump()
        check_symbol(edge_symbol)
        for node, idx in ((node1, idx1), (node2, idx2)):
            if node.name not in self._nodes:
                raise TNError(f"Node '{node.name}' does not belong to this TN")
            if not -node.ndim <= idx < node.ndim:
                raise TNError(
                    f"Mode index {idx} out of range for order-{node.ndim} "
                    f"node '{node.name}'"
                )

        dim1, dim2 = node1.shape[idx1], node2.shape[idx2]
        if dim1 < 0 and dim2 < 0:
            new_dim = -1
        elif (dim1 < 0) != (dim2 < 0):
            new_dim = max(dim1, dim2)
        elif dim1 != dim2:
            raise TNError(
                f"Incompatible dimensions: mode {idx1} of '{node1.name}' has "
                f"dim {dim1}, mode {idx2} of '{node2.name}' has dim {dim2}"
            )
        else:
            new_dim = dim1

        n1, n2 = node1.name, node2.name
        pair = (n1, n2) if n1 <= n2 else (n2, n1)
        key = self._pair_keys.get(pair, 0)
        self._pair_keys[pair] = key + 1
        edge_id = (n1, n2, key)

        edge = Edge(self, edge_id, new_dim, edge_symbol)
        self._edges[edge_id] = edge
        self._incident[n1].append(edge_id)
        if n2 != n1:
            self._incident[n2].append(edge_id)
        self._claim_symbol(edge_symbol)

        node1.edge_names[idx1] = edge_id
        node2.edge_names[idx2] = edge_id

        # Copy-node clusters must present a single symbol on every edge
        if node1.is_copy or node2.is_copy:
            self._cleanup_edge_symbols(node1 if node1.is_copy else node2)

        return edge_id

    def _claim_symbol(self, symbol):
        """Mark one more edge as carrying ``symbol``."""
        self._symbol_counts[symbol] += 1
        if self._symbol_counts[symbol] == 1:
            idx = symbol_index(symbol)
            if idx >= self._next_idx:
                # user-specified symbol past the high-water mark: every
                # skipped index becomes a reusable gap
                for i in range(self._next_idx, idx):
                    heapq.heappush(self._free_idxs, i)
                self._next_idx = idx + 1

    def _release_symbol(self, symbol):
        """Drop one carrier of ``symbol``; recycle its index when unused."""
        self._symbol_counts[symbol] -= 1
        if self._symbol_counts[symbol] == 0:
            del self._symbol_counts[symbol]
            heapq.heappush(self._free_idxs, symbol_index(symbol))

    def _allocate_symbols(self, num_new):
        """``num_new`` fresh symbols: recycled gaps first, then extension."""
        out = []
        taken = set()
        while len(out) < num_new:
            symbol = None
            while self._free_idxs:
                idx = heapq.heappop(self._free_idxs)
                s = get_symbol(idx)
                if s not in self._symbol_counts and s not in taken:
                    symbol = s
                    break
            if symbol is None:
                symbol = get_symbol(self._next_idx)
                self._next_idx += 1
            out.append(symbol)
            taken.add(symbol)
        return tuple(out)

    def _drop_edge(self, edge_id):
        """Unregister an edge (symbol count, incidence, registry)."""
        self._bump()
        edge = self._edges.pop(edge_id)
        self._release_symbol(edge.symbol)
        n1, n2 = edge_id[:2]
        self._incident[n1].remove(edge_id)
        if n2 != n1:
            self._incident[n2].remove(edge_id)
        return edge

    def _drop_dangler(self, dang_name):
        """Remove a dangling node and its single edge."""
        self._bump()
        node = self._nodes[dang_name]
        if not node.dangler:
            raise TNError(f"'{dang_name}' is not a dangling node")
        for edge_id in list(self._incident[dang_name]):
            self._drop_edge(edge_id)
        del self._incident[dang_name]
        del self._nodes[dang_name]

    def connect_nodes(self, node1, node2, index1, index2, edge_symbol=None):
        """Bond two dangling modes together, consuming their danglers.

        ``node1``/``node2`` may be Node objects or node names.  The bond's
        symbol defaults to ``min`` of the two dangling symbols, which keeps
        generated einsum strings byte-compatible with the JAX package.
        """
        if not isinstance(node1, Node):
            node1 = self[node1]
        if not isinstance(node2, Node):
            node2 = self[node2]

        dang1 = node1._dang_name(index1)  # raises if mode already bonded
        dang2 = node2._dang_name(index2)
        if dang1 == dang2:
            raise TNError("Cannot connect a mode to itself")

        # Validate BEFORE consuming the danglers: a rejected connect must
        # leave the TN untouched (found by an end-to-end drive — the
        # dim check used to live in _init_edge only, after the danglers
        # were dropped, leaving the graph un-contractible on failure).
        for node in (node1, node2):
            if self._nodes.get(node.name) is not node:
                raise TNError(
                    f"Node '{node.name}' does not belong to this TN"
                )
        dim1, dim2 = node1.shape[index1], node2.shape[index2]
        if dim1 >= 0 and dim2 >= 0 and dim1 != dim2:
            raise TNError(
                f"Incompatible dimensions: mode {index1} of "
                f"'{node1.name}' has dim {dim1}, mode {index2} of "
                f"'{node2.name}' has dim {dim2}"
            )

        # direct single-edge lookups: building the full edge_symbols
        # tuple per call made connect_nodes O(deg) (profiled at 10k nodes)
        es1 = self._edges[node1.edge_names[index1]].symbol
        es2 = self._edges[node2.edge_names[index2]].symbol
        if edge_symbol is not None:
            check_symbol(edge_symbol)
            if edge_symbol in self._symbol_counts and edge_symbol not in (es1, es2):
                raise TNError(
                    f"Edge symbol '{edge_symbol}' already in use elsewhere"
                )
        else:
            edge_symbol = min(es1, es2)

        self._drop_dangler(dang1)
        self._drop_dangler(dang2)
        return self._init_edge(node1, node2, index1, index2, edge_symbol)

    def remove_edge(self, edge):
        """Break a single bond, restoring dangling modes on both ends."""
        self.remove_edges_from((edge,))

    def remove_edges_from(self, edge_set):
        """Break several bonds; already-dangling edges are left unchanged.

        Freed symbols become reusable before the replacement danglers are
        labeled.
        """
        edges = []
        for e in edge_set:
            if isinstance(e, tuple):
                e = self.get_edge(e)
            elif not isinstance(e, Edge):
                raise TypeError(f"Expected Edge or edge-id tuple, got {e!r}")
            edges.append(e)
        # Deterministic processing order (insertion order of the registry)
        order = {eid: i for i, eid in enumerate(self._edges)}
        seen = set()
        unique = []
        for e in edges:
            if e.name in order and e.name not in seen:
                seen.add(e.name)
                unique.append(e)
            elif e.name not in order:
                raise TNError(f"Edge {e.name!r} does not belong to this TN")
        unique.sort(key=lambda e: order[e.name])

        affected = []  # (node, mode index) pairs needing fresh danglers
        for e in unique:
            if e.dangler:
                continue  # open modes stay as they are
            n1, n2 = e.name[:2]
            if n1 == n2:
                # Self-loop (trace) edge: both modes of ONE node hold this
                # edge id; restore a dangler at each position
                node = self._nodes[n1]
                for idx, en in enumerate(node.edge_names):
                    if en == e.name:
                        affected.append((node, idx))
            else:
                for n in (n1, n2):
                    node = self._nodes[n]
                    affected.append((node, node.index(e)))

        for e in unique:
            if not e.dangler:
                self._drop_edge(e.name)

        new_symbols = self._allocate_symbols(len(affected))
        for (node, idx), sym in zip(affected, new_symbols):
            self._new_dangler(node, idx, sym)

        if any(node.is_copy for node, _ in affected):
            self._cleanup_edge_symbols()

    def merge_nodes(self, node1, node2, name=None):
        """Contract two dense nodes into one, in place (coarse-graining).

        All direct bonds between the pair (including parallel edges) are
        summed over and each node's internal self-loops are traced; every
        other mode survives on the merged node in order (``node1``'s modes
        then ``node2``'s), keeping its bond to its old peer.  Indices
        shared with the pair only through a copy-tensor cluster are NOT
        contracted — they remain hyperedge legs of the merged node.

        Returns the new dense node (named ``name`` or auto).  Note that
        dangler identities are refreshed, so the einsum output order may
        change.  Two numpy tensors merge with numpy; otherwise the merge
        runs in torch on the device of the torch operand.
        """
        if not isinstance(node1, Node):
            node1 = self[node1]
        if not isinstance(node2, Node):
            node2 = self[node2]
        if node1 is node2:
            raise TNError("merge_nodes needs two distinct nodes")
        for n in (node1, node2):
            if n.node_type != "dense":
                raise TNError(
                    f"merge_nodes only contracts dense nodes; '{n.name}' "
                    f"is '{n.node_type}'"
                )
        # A clone whose base disappears would leave the TN un-contractible
        for n in (node1, node2):
            if self._clone_bases.get(n.name, 0):
                raise TNError(
                    f"Cannot merge '{n.name}': it is the base of clone "
                    "nodes. Remove or re-base the clones first."
                )

        # Letter per EDGE (not per symbol): direct pair bonds/self-loops
        # share a letter across their two modes; everything else is unique.
        # Both einsum implementations accept only a-zA-Z.
        letters = {}

        def letter_of(edge_id):
            if edge_id not in letters:
                if len(letters) == 52:
                    raise TNError("merge_nodes supports at most 52 distinct edges")
                letters[edge_id] = get_symbol(len(letters))
            return letters[edge_id]

        pair = {node1.name, node2.name}
        sub1 = "".join(letter_of(e) for e in node1.edge_names)
        sub2 = "".join(letter_of(e) for e in node2.edge_names)
        survivors = []  # (letter, peer_name_or_None, peer_idx)
        for node in (node1, node2):
            for idx, edge_id in enumerate(node.edge_names):
                if set(edge_id[:2]) <= pair:
                    continue  # contracted: pair bond or internal self-loop
                other = (edge_id[1] if edge_id[0] == node.name
                         else edge_id[0])
                peer = self._nodes[other]
                if peer.dangler:
                    survivors.append((letter_of(edge_id), None, None))
                else:
                    survivors.append(
                        (letter_of(edge_id), other, peer.index(edge_id))
                    )
        out_letters = "".join(s[0] for s in survivors)
        merged = _einsum_pair(
            f"{sub1},{sub2}->{out_letters}", node1.tensor, node2.tensor
        )

        # Graph surgery through the invariant-preserving primitives:
        # break every bond of the pair, drop the pair, add the merged node
        bonds = {
            self._edges[e]
            for n in (node1, node2)
            for e in n.edge_names
            if not self._edges[e].dangler
        }
        if bonds:
            self.remove_edges_from(bonds)
        for n in (node1, node2):
            for e in list(n.edge_names):
                self._drop_dangler(
                    e[1] if e[0] == n.name else e[0]
                )
            del self._incident[n.name]
            del self._nodes[n.name]
            self._num_cores -= 1
            self._type_counts["dense"] -= 1
            self._bump()

        new_node = self.add_dense_node(merged, name=name)
        for mode, (_, peer_name, peer_idx) in enumerate(survivors):
            if peer_name is not None:
                self.connect_nodes(new_node, self[peer_name], mode, peer_idx)
        return new_node

    def get_edge(self, edge_id):
        """Resolve an ``(n1, n2, key)`` id (either node order) to its Edge."""
        if edge_id in self._edges:
            return self._edges[edge_id]
        flipped = (edge_id[1], edge_id[0], edge_id[2])
        if flipped in self._edges:
            return self._edges[flipped]
        raise TNError(f"No edge {edge_id!r} in this TN")

    # ------------------------------------------------------------------ #
    # Naming and symbols
    # ------------------------------------------------------------------ #

    def _new_node_name(self, name=None):
        if name is None:
            # "node_{num_cores}" naming; probe upward for TNs whose core
            # count shrank (e.g. merge_nodes)
            k = self._num_cores
            name = f"node_{k}"
            while name in self._nodes:
                k += 1
                name = f"node_{k}"
        if not isinstance(name, str):
            raise TypeError(f"Node names must be strings, got {name!r}")
        if name in self._nodes:
            raise TypeError(f"Node name '{name}' already in use")
        return name

    def _new_edge_symbols(self, node_type, degree, edge_symbols=None):
        """Validate user-specified symbols or allocate fresh ones.

        Unique symbols per mode for dense/clone/input nodes, a single shared
        symbol for all modes of a copy node.
        """
        if edge_symbols is not None:
            edge_symbols = tuple(edge_symbols)
            if len(edge_symbols) != degree:
                raise TNError(
                    f"Expected {degree} edge symbols, got {len(edge_symbols)}"
                )
            for es in edge_symbols:
                check_symbol(es)
            if node_type == "hyper":
                if degree > 0 and len(set(edge_symbols)) != 1:
                    raise TNError("Copy nodes must use one shared edge symbol")
            elif len(set(edge_symbols)) != degree:
                raise TNError(f"Edge symbols must be unique, got {edge_symbols}")
            clash = self.edge_symbols.intersection(edge_symbols)
            if clash:
                raise TypeError(f"Edge symbol '{clash.pop()}' already in use")
            return edge_symbols

        if degree == 0:
            if node_type == "hyper":
                raise TNError("Copy (hyperedge) nodes must have positive degree")
            return ()
        num_new = 1 if node_type == "hyper" else degree
        new_symbols = self._allocate_symbols(num_new)
        return new_symbols if num_new == degree else new_symbols * degree

    def _copy_cluster(self, start_name):
        """Connected component of ``start_name`` in the copy+dangler subgraph."""
        seen = {start_name}
        stack = [start_name]
        while stack:
            current = stack.pop()
            for edge_id in self._incident[current]:
                other = edge_id[1] if edge_id[0] == current else edge_id[0]
                if other in seen:
                    continue
                if self._nodes[other].node_type in ("hyper", "dangler"):
                    seen.add(other)
                    stack.append(other)
        return seen

    def _cleanup_edge_symbols(self, naughty_node=None):
        """Unify edge symbols across connected copy-node clusters.

        A connected cluster of copy nodes represents one hyperedge, so every
        edge incident to the cluster must carry the same einsum symbol.  The
        most common symbol among incident edges wins, and *all* incident
        edges are rewritten — including bonds to dense/input nodes — so the
        repeated-index invariant can never be violated.
        """
        self._bump()  # symbol rewrites change the einstring
        if naughty_node is not None:
            clusters = [self._copy_cluster(naughty_node.name)]
        else:
            remaining = {
                n for n, node in self._nodes.items() if node.is_copy
            }
            clusters = []
            while remaining:
                cluster = self._copy_cluster(next(iter(remaining)))
                clusters.append(cluster)
                remaining -= cluster

        for cluster in clusters:
            incident = []
            for n in cluster:
                for edge_id in self._incident[n]:
                    incident.append(edge_id)
            if not incident:
                continue
            counts = Counter(self._edges[eid].symbol for eid in incident)
            best = counts.most_common(1)[0][0]
            for eid in set(incident):
                edge = self._edges[eid]
                if edge.symbol != best:
                    self._release_symbol(edge.symbol)
                    self._claim_symbol(best)
                    edge._symbol = best

    # ------------------------------------------------------------------ #
    # Views
    # ------------------------------------------------------------------ #

    def nodes(self, as_iter=False, copy_nodes=True, danglers=False):
        """Nodes in insertion order, optionally filtering copies/danglers."""
        node_iter = (
            n
            for n in self._nodes.values()
            if (copy_nodes or not n.is_copy) and (danglers or not n.dangler)
        )
        return node_iter if as_iter else tuple(node_iter)

    def edges(self, as_iter=False):
        """Edges in insertion order."""
        edge_iter = iter(self._edges.values())
        return edge_iter if as_iter else tuple(edge_iter)

    @property
    def edge_symbols(self):
        """Set of einsum symbols currently in use."""
        return set(self._symbol_counts)

    @property
    def params(self):
        """Tuple of parameter tensors (dense nodes, insertion order)."""
        return tuple(
            n.tensor for n in self._nodes.values() if n.node_type == "dense"
        )

    @property
    def num_dense(self):
        return self._type_counts["dense"]

    @property
    def num_duplicate(self):
        return self._type_counts["clone"]

    @property
    def num_copy(self):
        return self._type_counts["hyper"]

    @property
    def num_input(self):
        return self._type_counts["input"]

    @property
    def num_cores(self):
        """Number of core (non-dangling) nodes."""
        return self._num_cores

    def __contains__(self, node):
        if isinstance(node, Node):
            node = node.name
        return node in self._nodes

    def __getitem__(self, name):
        if name not in self._nodes:
            raise TNError(f"No node named '{name}' in this TN")
        return self._nodes[name]

    def __repr__(self):
        return (
            f"TN(num_cores={self.num_cores}, dense={self.num_dense}, "
            f"clone={self.num_duplicate}, copy={self.num_copy}, "
            f"input={self.num_input}, edges={len(self._edges)})"
        )

    # ------------------------------------------------------------------ #
    # Contraction API (delegates to the compiler)
    # ------------------------------------------------------------------ #

    @property
    def einsum_str(self):
        """Einsum-style string describing the TN's contraction."""
        return self._compiled_spec()[0]

    def _compiled_spec(self):
        """Cached ``(einstring, arg_packer)`` for the current topology.

        Rebuilding the einstring and packer costs O(nodes) of interpreted
        Python per ``contract()`` call — dominant for warm re-contractions
        of large networks (the README 1000-link chain).  The cache keys on
        the mutation counter, which every structural primitive bumps.
        """
        if self._spec_cache is not None and \
                self._spec_cache[0] == self._mutation:
            return self._spec_cache[1], self._spec_cache[2]
        from .compiler.einstring import make_arg_packer, make_einstring

        einstr = make_einstring(self)
        pack = make_arg_packer(self)
        self._spec_cache = (self._mutation, einstr, pack)
        return einstr, pack

    def make_contract_fun(self, optimize="auto", split_format=False, **kwargs):
        """Build a reusable ``contract_fun(params, inputs)`` for this layout.

        The returned function runs the contraction eagerly in torch on the
        device chosen by :func:`~contractn_tpu_torch.compiler.engine.contract`
        (torch operands keep theirs; numpy ones go to ``cuda`` unless
        ``device=`` says otherwise); torch operands keep their autograd
        graph.  With ``split_format=True`` it returns ``(mantissa,
        log_scale)`` where ``mantissa`` has mean absolute value 1 and the
        true result equals ``mantissa * exp(log_scale)``.
        """
        from .compiler.engine import contract

        einstr, pack = self._compiled_spec()

        def contract_fun(params, inputs=()):
            operands = pack(params, inputs)
            return contract(
                einstr,
                *operands,
                optimize=optimize,
                split_format=split_format,
                **kwargs,
            )

        return contract_fun

    def contract(self, inputs=(), optimize="auto", split_format=False, **kwargs):
        """Contract the network into a dense tensor (or a split-format pair).

        ``kwargs`` go to :func:`~contractn_tpu_torch.compiler.engine.contract`
        (e.g. ``device="cpu"``).
        """
        fun = self.make_contract_fun(
            optimize=optimize, split_format=split_format, **kwargs
        )
        return fun(self.params, inputs)

    def copy(self):
        """Independent copy of this TN (topology rebuilt, parameters shared).

        Nodes are re-added in insertion order with their names, bonds are
        re-connected, and the recorded symbol layout is restored, so the copy
        produces a byte-identical einsum string.
        """
        out = TN()
        for node in self.nodes(as_iter=True):
            nt = node.node_type
            if nt == "dense":
                out.add_dense_node(node.tensor, name=node.name)
            elif nt == "clone":
                out.add_duplicate_node(node.base_node.name, name=node.name)
            elif nt == "hyper":
                out.add_copy_node(node.degree, dim=node.dim, name=node.name)
            else:
                out.add_input_node(
                    node._shape, var_shape_axes=node.var_axes, name=node.name
                )
        for edge in self.edges(as_iter=True):
            if edge.dangler:
                continue
            n1, n2 = edge.nodes
            if n1 is n2:  # self-loop: one node holds the id at two modes
                idx1, idx2 = [
                    i for i, en in enumerate(n1.edge_names) if en == edge.name
                ]
            else:
                idx1, idx2 = n1.index(edge), n2.index(edge)
            out.connect_nodes(n1.name, n2.name, idx1, idx2)
        out._bump()
        for node in self.nodes(as_iter=True):
            for idx, sym in enumerate(node.edge_symbols):
                edge = out[node.name][idx]
                if edge.symbol != sym:
                    out._release_symbol(edge.symbol)
                    out._claim_symbol(sym)
                    edge._symbol = sym
        return out


    # ------------------------------------------------------------------ #
    # Inspection and compiled contractions
    # ------------------------------------------------------------------ #

    def to_dot(self, max_nodes=500):
        """Graphviz DOT source for the layout.

        Node styling encodes type (dense = box, clone = dashed box,
        copy/hyper = small filled circle, input = house, dangler = point);
        bonds are labeled ``symbol:dim``.  Render with any graphviz
        install (``dot -Tsvg``); the method itself has no dependency.
        """
        style = {
            "dense": 'shape=box, style=filled, fillcolor="#cfe3ff"',
            "clone": 'shape=box, style="dashed,filled", '
                     'fillcolor="#e8f0ff"',
            "hyper": 'shape=circle, width=0.25, style=filled, '
                     'fillcolor="#222222", label=""',
            "input": 'shape=house, style=filled, fillcolor="#ffe9c7"',
            "dangler": "shape=point, width=0.06",
        }
        lines = [
            "graph TN {",
            "  layout=neato; overlap=false; splines=true;",
            '  edge [fontsize=9, color="#555555"];',
            "  node [fontsize=10];",
        ]
        shown = set()
        for i, node in enumerate(self.nodes(as_iter=True, danglers=True)):
            if i >= max_nodes:
                lines.append(f'  // ... {len(self._nodes) - i} more nodes')
                break
            attrs = style[node.node_type]
            if node.node_type in ("dense", "clone", "input"):
                shape = "x".join(str(d) for d in node.shape)
                attrs += f', label="{node.name}\\n({shape})"'
            lines.append(f'  "{node.name}" [{attrs}];')
            shown.add(node.name)
        for edge in self.edges(as_iter=True):
            n1, n2 = edge.name[:2]
            if n1 not in shown or n2 not in shown:
                continue
            dim = "?" if edge.dim < 0 else str(edge.dim)
            lines.append(
                f'  "{n1}" -- "{n2}" [label="{edge.symbol}:{dim}"];'
            )
        lines.append("}")
        return "\n".join(lines)

    def draw(self, max_nodes=50):
        """Compact text rendering of the layout (for quick inspection).

        One line per core node: type, shape, and each mode's einsum symbol
        with its peer (``*`` marks an open/dangling mode).
        """
        lines = [repr(self)]
        for i, node in enumerate(self.nodes(as_iter=True)):
            if i >= max_nodes:
                lines.append(f"  ... ({self.num_cores - max_nodes} more)")
                break
            modes = []
            for k in range(node.ndim):
                edge = node[k]
                other = edge.name[1] if edge.name[0] == node.name \
                    else edge.name[0]
                peer = "*" if self._nodes[other].dangler else other
                modes.append(f"{edge.symbol}:{peer}")
            shape = "x".join(str(s) for s in node.shape)
            lines.append(
                f"  {node.name} [{node.node_type} {shape or 'scalar'}] "
                + " ".join(modes)
            )
        return "\n".join(lines)

    def to_networkx(self):
        """Export the layout as a ``networkx.MultiGraph`` for inspection.

        Nodes carry ``node_type``; edges carry ``dim`` and ``symbol``.  The
        export is a snapshot: mutating it does not affect this TN.  networkx
        is not a dependency of this package: without it this raises
        :class:`TNError`.
        """
        try:
            import networkx as nx
        except ImportError as exc:
            raise TNError(
                "TN.to_networkx needs the networkx package, which is not "
                "installed"
            ) from exc

        g = nx.MultiGraph()
        for node in self._nodes.values():
            g.add_node(node.name, node_type=node.node_type)
        for edge in self._edges.values():
            n1, n2, key = edge.name
            g.add_edge(n1, n2, key=key, dim=edge.dim, symbol=edge.symbol)
        return g

    def compile(self, optimize="auto", split_format=False, **kwargs):
        """Build a reusable, introspectable compiled contraction.

        Returns a
        :class:`~contractn_tpu_torch.compiler.expression.CompiledContraction`
        — call it with ``(params, inputs)``, query ``.info()`` for the cost
        model, ``.measure_compile()`` for its staging times.
        """
        from .compiler.expression import CompiledContraction

        return CompiledContraction(
            self, optimize=optimize, split_format=split_format, **kwargs
        )

    def contraction_info(self, optimize="auto", inputs_shapes=None,
                         memory_limit=None):
        """Static cost model of this TN's contraction (FLOPs, largest
        intermediate, chosen path)."""
        from .utils.introspect import contraction_info

        return contraction_info(
            self, optimize=optimize, inputs_shapes=inputs_shapes,
            memory_limit=memory_limit,
        )

def _einsum_pair(subscripts, t1, t2):
    """``einsum`` of two node tensors: numpy for two numpy arrays, else
    torch on the torch operand's device."""
    if not isinstance(t1, torch.Tensor) and not isinstance(t2, torch.Tensor):
        return np.einsum(subscripts, np.asarray(t1), np.asarray(t2))
    device = (t1 if isinstance(t1, torch.Tensor) else t2).device
    ops = [t if isinstance(t, torch.Tensor) else as_tensor(t, device)
           for t in (t1, t2)]
    return torch.einsum(subscripts, *ops)
