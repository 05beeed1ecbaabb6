"""Pairwise contraction paths: opt_einsum's strategies, without opt_einsum.

The JAX package asks ``opt_einsum.contract_path`` for its pairwise steps
(``contractn_tpu/compiler/engine.py:_find_steps``).  opt_einsum is not a
dependency of this package, so its path strategies are ported here, in pure
Python, from opt_einsum 3.4.0 (``opt_einsum/paths.py``; Copyright (c) 2014
Daniel Smith, MIT License).  Each keeps opt_einsum's data structures, cost
functions, tie-breaking and memory-limit handling, so a strategy returns the
same path as opt_einsum's on the same signature:

* ``"greedy"`` (also ``"eager"``, ``"opportunistic"``) — Hadamard products
  first, then the pair of least ``size(result) - size(a) - size(b)``, ties
  broken by the larger then the smaller SSA id, then outer products
  smallest first; with a ``memory_limit`` it is ``"branch-1"``;
* ``"optimal"`` — exhaustive depth-first search, sieved by the best FLOP
  count so far;
* ``"branch-all"``, ``"branch-2"``, ``"branch-1"`` — branch and bound over
  all, the two best or the best candidate pair at each step;
* ``"dp"`` (also ``"dynamic-programming"``) — dynamic programming over
  connected subgraphs (minimize FLOPs, iterated cost cap, no outer
  products);
* ``"auto"`` — by operand count: ``optimal`` for 1–4, ``branch-all`` for
  5–6, ``branch-2`` for 7–8, ``branch-1`` for 9–14, ``greedy`` above;
* ``"random-greedy"`` / ``"random-greedy-128"`` — 32 / 128 greedy trials
  (opt_einsum 3.4.0's ``path_random.py``): trial 0 takes the least
  jittered cost, later ones draw among the 8 best candidates with
  Boltzmann weights; the path of fewest FLOPs is kept.  Trial ``r`` draws
  from its own ``random.Random(r)``, so the path is opt_einsum's (which
  seeds the global ``random`` with ``r``) and the same on every call in a
  process.  Another process may find another path, as opt_einsum does:
  Python seeds its string hashes per process, and the order in which the
  trials meet their candidates follows them;
* ``"auto-hq"`` — ``optimal`` for 1–5 operands, ``dp`` for 6–16,
  ``random-greedy-128`` above.

Besides opt_einsum's strategies, ``"native-greedy"`` is the C++ greedy
optimizer of :mod:`..native` (built with ``g++`` at first use; it raises
:class:`TNError` where the library cannot be built or loaded), and explicit
paths (opt_einsum's linear-id format, e.g. ``[(0, 1), (0, 1)]``) are
honoured as given.  As in ``opt_einsum.contract_path``, a signature of one
or two operands is contracted in one step whatever the strategy.  A
different path changes only the rounding of the result: the split-format
mantissa is renormalized after the last step.
"""

import bisect
import functools
import heapq
import itertools
import math
import random
from collections import Counter, defaultdict
from functools import lru_cache

from ..utils.errors import TNError
from ..utils.introspect import Timings
from ..utils.introspect import flop_count as _flop_count

NATIVE = "native-greedy"
_UNLIMITED_MEM = {-1, None, float("inf")}


def _size(indices, sizes):
    """opt_einsum's ``compute_size_by_dict``."""
    out = 1
    for i in indices:
        out *= sizes[i]
    return out


def ssa_to_linear(ssa_path):
    """Static-single-assignment ids -> positions in the shrinking list."""
    n = sum(map(len, ssa_path)) - len(ssa_path) + 1
    ids = list(range(n))
    path = []
    ssa = n
    for scon in ssa_path:
        con = sorted(bisect.bisect_left(ids, s) for s in scon)
        for j in reversed(con):
            ids.pop(j)
        ids.append(ssa)
        path.append(tuple(con))
        ssa += 1
    return path


# ----------------------------------------------------- optimal and branch


def _calc_k12_flops(inputs, output, remaining, i, j, sizes):
    """Indices and FLOPs of contracting ``inputs[i]`` with ``inputs[j]``."""
    k1, k2 = inputs[i], inputs[j]
    either = k1 | k2
    shared = k1 & k2
    keep = frozenset.union(output, *map(inputs.__getitem__, remaining - {i, j}))
    return either & keep, _flop_count(either, bool(shared - keep), 2, sizes)


def _oversize_flops(inputs, remaining, output, sizes):
    """FLOPs of contracting every remaining operand at once (what a path
    ends with where the memory limit forbids every pair)."""
    idx = frozenset.union(*map(inputs.__getitem__, remaining))
    return _flop_count(idx, bool(idx - output), len(remaining), sizes)


def optimal(inputs, output, sizes, memory_limit=None):
    """Exhaustive depth-first search over pair contractions (opt_einsum's
    ``optimal``)."""
    inputs_set = tuple(map(frozenset, inputs))
    output_set = frozenset(output)
    best = {"flops": float("inf"), "ssa_path": (tuple(range(len(inputs))),)}
    size_cache = {}
    result_cache = {}

    def iterate(path, remaining, inputs, flops):
        if len(remaining) == 1:
            best["flops"] = flops
            best["ssa_path"] = path
            return
        for i, j in itertools.combinations(remaining, 2):
            if i > j:
                i, j = j, i
            key = (inputs[i], inputs[j])
            try:
                k12, flops12 = result_cache[key]
            except KeyError:
                k12, flops12 = result_cache[key] = _calc_k12_flops(
                    inputs, output_set, remaining, i, j, sizes)
            new_flops = flops + flops12
            if new_flops >= best["flops"]:
                continue
            if memory_limit not in _UNLIMITED_MEM:
                try:
                    size12 = size_cache[k12]
                except KeyError:
                    size12 = size_cache[k12] = _size(k12, sizes)
                if size12 > memory_limit:
                    new_flops = flops + _oversize_flops(
                        inputs, remaining, output_set, sizes)
                    if new_flops < best["flops"]:
                        best["flops"] = new_flops
                        best["ssa_path"] = path + (tuple(remaining),)
                    continue
            iterate(path + ((i, j),), remaining - {i, j} | {len(inputs)},
                    inputs + (k12,), new_flops)

    iterate((), set(range(len(inputs))), inputs_set, 0)
    return ssa_to_linear(best["ssa_path"])


def branch(inputs, output, sizes, memory_limit=None, nbranch=None,
           cutoff_flops_factor=4):
    """Branch and bound over pair contractions (opt_einsum's ``BranchBound``
    with ``minimize="flops"`` and the ``"memory-removed"`` cost)."""
    inputs = tuple(map(frozenset, inputs))
    output = frozenset(output)
    best = {"flops": float("inf"), "size": float("inf")}
    best_progress = defaultdict(lambda: float("inf"))
    size_cache = {k: _size(k, sizes) for k in inputs}
    result_cache = {}

    def iterate(path, inputs, remaining, flops, size):
        if len(remaining) == 1:
            best.update(size=size, flops=flops, ssa_path=path)
            return

        def assess(k1, k2, i, j):
            try:
                k12, flops12 = result_cache[k1, k2]
            except KeyError:
                k12, flops12 = result_cache[k1, k2] = _calc_k12_flops(
                    inputs, output, remaining, i, j, sizes)
            try:
                size12 = size_cache[k12]
            except KeyError:
                size12 = size_cache[k12] = _size(k12, sizes)
            new_flops = flops + flops12
            new_size = max(size, size12)
            if not (new_flops, new_size) < (best["flops"], best["size"]):
                return None
            if new_flops < best_progress[len(inputs)]:
                best_progress[len(inputs)] = new_flops
            elif new_flops > cutoff_flops_factor * best_progress[len(inputs)]:
                return None
            if memory_limit not in _UNLIMITED_MEM and size12 > memory_limit:
                new_flops = flops + _oversize_flops(inputs, remaining, output,
                                                    sizes)
                if new_flops < best["flops"]:
                    best["flops"] = new_flops
                    best["ssa_path"] = path + (tuple(remaining),)
                return None
            cost = size12 - size_cache[inputs[i]] - size_cache[inputs[j]]
            return cost, flops12, new_flops, new_size, (i, j), k12

        candidates = []
        for outer in (False, True):
            for i, j in itertools.combinations(remaining, 2):
                if i > j:
                    i, j = j, i
                k1, k2 = inputs[i], inputs[j]
                if not outer and k1.isdisjoint(k2):
                    continue  # outer products only where nothing else is left
                candidate = assess(k1, k2, i, j)
                if candidate:
                    heapq.heappush(candidates, candidate)
            if candidates:
                break
        taken = 0
        while (nbranch is None or taken < nbranch) and candidates:
            _, _, new_flops, new_size, (i, j), k12 = heapq.heappop(candidates)
            iterate(path + ((i, j),), inputs + (k12,),
                    (remaining - {i, j}) | {len(inputs)}, new_flops, new_size)
            taken += 1

    iterate((), inputs, set(range(len(inputs))), 0, 0)
    return ssa_to_linear(best["ssa_path"])


branch_all = functools.partial(branch, nbranch=None)
branch_2 = functools.partial(branch, nbranch=2)
branch_1 = functools.partial(branch, nbranch=1)


# ------------------------------------------------------------------ greedy


def _memory_removed(size12, size1, size2, rng):
    """opt_einsum's default greedy cost, ``"memory-removed"``."""
    return size12 - size1 - size2


def _memory_removed_jitter(size12, size1, size2, rng):
    """opt_einsum's ``"memory-removed-jitter"``: the same cost times a
    ``gauss(1, 0.01)`` draw, which breaks ties and jumbles the order."""
    return rng.gauss(1.0, 0.01) * (size12 - size1 - size2)


def _greedy_candidate(output, sizes, remaining, footprints, dim_ref_counts,
                      k1, k2, cost_fn=_memory_removed, rng=None):
    either = k1 | k2
    two = k1 & k2
    one = either - two
    k12 = (either & output) | (two & dim_ref_counts[3]) | (one & dim_ref_counts[2])
    cost = cost_fn(_size(k12, sizes), footprints[k1], footprints[k2], rng)
    id1, id2 = remaining[k1], remaining[k2]
    if id1 > id2:
        k1, id1, k2, id2 = k2, id2, k1, id1
    return (cost, id2, id1), k1, k2, k12  # ids break ties deterministically


def _update_ref_counts(dim_to_keys, dim_ref_counts, dims):
    for dim in dims:
        count = len(dim_to_keys[dim])
        if count <= 1:
            dim_ref_counts[2].discard(dim)
            dim_ref_counts[3].discard(dim)
        elif count == 2:
            dim_ref_counts[2].add(dim)
            dim_ref_counts[3].discard(dim)
        else:
            dim_ref_counts[2].add(dim)
            dim_ref_counts[3].add(dim)


def ssa_greedy(inputs, output, sizes, choose_fn=None,
               cost_fn=_memory_removed, rng=None):
    """opt_einsum's ``ssa_greedy_optimize``; an SSA path.

    By default it takes the candidate of least ``"memory-removed"`` cost.
    ``choose_fn(queue, remaining, rng)`` replaces that choice (every
    candidate is then queued, not only each operand's best), ``cost_fn``
    the cost, and ``rng`` (a :class:`random.Random`) feeds both.
    Candidates are only formed between operands sharing an index, so the
    search scales with the number of operands per index, not with the
    operand count squared."""
    if len(inputs) == 1:
        return [(0,)]
    fs_inputs = [frozenset(x) for x in inputs]
    # an index held by every operand can only go at the last step
    output = frozenset(output) | frozenset.intersection(*fs_inputs)

    remaining = {}  # key -> ssa id
    ssa_ids = itertools.count(len(fs_inputs))
    ssa_path = []
    for ssa_id, key in enumerate(fs_inputs):  # Hadamard products first
        if key in remaining:
            ssa_path.append((remaining[key], ssa_id))
            remaining[key] = next(ssa_ids)
        else:
            remaining[key] = ssa_id

    dim_to_keys = defaultdict(set)
    for key in remaining:
        for dim in key - output:
            dim_to_keys[dim].add(key)
    dim_ref_counts = {
        count: {dim for dim, keys in dim_to_keys.items() if len(keys) >= count} - output
        for count in (2, 3)
    }
    footprints = {key: _size(key, sizes) for key in remaining}

    def push(k1, k2s):
        candidates = (_greedy_candidate(output, sizes, remaining, footprints,
                                        dim_ref_counts, k1, k2, cost_fn, rng)
                      for k2 in k2s)
        if choose_fn is None:
            heapq.heappush(queue, min(candidates))
        else:
            for candidate in candidates:
                heapq.heappush(queue, candidate)

    queue = []
    for dim_keys in dim_to_keys.values():
        dim_keys = sorted(dim_keys, key=remaining.__getitem__)
        for i, k1 in enumerate(dim_keys[:-1]):
            push(k1, dim_keys[1 + i:])

    while queue:
        if choose_fn is None:
            _, k1, k2, k12 = heapq.heappop(queue)
            if k1 not in remaining or k2 not in remaining:
                continue  # obsolete candidate
        else:
            chosen = choose_fn(queue, remaining, rng)
            if chosen is None:
                continue  # every popped candidate was obsolete
            _, k1, k2, k12 = chosen
        ssa_id1 = remaining.pop(k1)
        ssa_id2 = remaining.pop(k2)
        for dim in k1 - output:
            dim_to_keys[dim].remove(k1)
        for dim in k2 - output:
            dim_to_keys[dim].remove(k2)
        ssa_path.append((ssa_id1, ssa_id2))
        if k12 in remaining:
            ssa_path.append((remaining[k12], next(ssa_ids)))
        else:
            for dim in k12 - output:
                dim_to_keys[dim].add(k12)
        remaining[k12] = next(ssa_ids)
        _update_ref_counts(dim_to_keys, dim_ref_counts, k1 | k2 - output)
        footprints[k12] = _size(k12, sizes)
        k2s = {k2 for dim in k12 for k2 in dim_to_keys[dim]}
        k2s.discard(k12)
        if k2s:
            push(k12, list(k2s))

    # whatever is left shares no contractable index: outer products
    final = [(_size(key & output, sizes), ssa_id, key)
             for key, ssa_id in remaining.items()]
    heapq.heapify(final)
    _, ssa_id1, k1 = heapq.heappop(final)
    while final:
        _, ssa_id2, k2 = heapq.heappop(final)
        ssa_path.append((min(ssa_id1, ssa_id2), max(ssa_id1, ssa_id2)))
        k12 = (k1 | k2) & output
        _, ssa_id1, k1 = heapq.heappushpop(
            final, (_size(k12, sizes), next(ssa_ids), k12))
    return ssa_path


def greedy(inputs, output, sizes, memory_limit=None):
    """opt_einsum's ``greedy``: ``"branch-1"`` under a memory limit."""
    if memory_limit not in _UNLIMITED_MEM:
        return branch(inputs, output, sizes, memory_limit, nbranch=1)
    return ssa_to_linear(ssa_greedy(inputs, output, sizes))


# ----------------------------------------------------------- random greedy


def thermal_chooser(queue, remaining, rng):
    """opt_einsum's ``thermal_chooser`` at ``RandomGreedy``'s defaults: draw
    one of the 8 best live candidates with Boltzmann weights ``exp(-(c -
    c_min) / T)``, ``T = max(1, |c_min|)``, and push the others back."""
    choices = []
    while queue and len(choices) < 8:
        cost, k1, k2, k12 = heapq.heappop(queue)
        if k1 in remaining and k2 in remaining:  # else obsolete
            choices.append((cost, k1, k2, k12))
    if len(choices) <= 1:
        return choices[0] if choices else None
    cmin = choices[0][0][0]
    temperature = max(1, abs(cmin))
    energies = [math.exp(-(c[0][0] - cmin) / temperature) for c in choices]
    (chosen,) = rng.choices(range(len(choices)), weights=energies)
    chosen = choices.pop(chosen)
    for other in choices:
        heapq.heappush(queue, other)
    return chosen


def ssa_path_compute_cost(ssa_path, inputs, output, sizes):
    """FLOPs and largest intermediate of an SSA path (opt_einsum's cost)."""
    inputs = list(map(frozenset, inputs))
    output = frozenset(output)
    remaining = set(range(len(inputs)))
    total_cost = 0
    max_size = 0
    for i, j in ssa_path:
        k12, flops12 = _calc_k12_flops(inputs, output, remaining, i, j, sizes)
        remaining.discard(i)
        remaining.discard(j)
        remaining.add(len(inputs))
        inputs.append(k12)
        total_cost += flops12
        max_size = max(max_size, _size(k12, sizes))
    return total_cost, max_size


def _trial_greedy(r, inputs, output, sizes):
    """Trial ``r`` of the random greedy search: ``(ssa_path, flops, size)``.

    Trial 0 takes the least cost (the jittered greedy path).  Each trial
    draws from its own ``random.Random(r)``, whose ``choices`` and ``gauss``
    give what opt_einsum's draw after ``random.seed(r)``, and the global
    ``random`` state is left alone.
    """
    rng = random.Random(r)
    ssa_path = ssa_greedy(inputs, output, sizes,
                          None if r == 0 else thermal_chooser,
                          _memory_removed_jitter, rng)
    cost, size = ssa_path_compute_cost(ssa_path, inputs, output, sizes)
    return ssa_path, cost, size


def random_greedy(inputs, output, sizes, memory_limit=None, max_repeats=32):
    """opt_einsum's ``RandomGreedy`` with its defaults (the
    ``"memory-removed-jitter"`` cost, the thermal chooser, serial trials
    ``0 .. max_repeats - 1``, the path of fewest FLOPs kept, ties to the
    smaller intermediate, then to the earlier trial).  Like opt_einsum's,
    it ignores ``memory_limit``."""
    best = (float("inf"), float("inf"), None)
    for r in range(max_repeats):
        ssa_path, cost, size = _trial_greedy(r, inputs, output, sizes)
        if (cost, size) < best[:2]:
            best = (cost, size, ssa_path)
    return ssa_to_linear(best[2])


random_greedy_128 = functools.partial(random_greedy, max_repeats=128)


# ------------------------------------------------------ dynamic programming


def _tree_to_sequence(tree):
    """Contraction tree (nested tuples of input ids) -> linear-id path."""
    if isinstance(tree, int):
        return []
    c = [tree]  # remaining contractions
    t = []  # elementary tensors
    s = []  # the path, built back to front
    while c:
        j = c.pop(-1)
        s.insert(0, ())
        for i in sorted(i for i in j if isinstance(i, int)):
            s[0] += (sum(1 for q in t if q < i),)
            t.insert(s[0][-1], i)
        for i_tup in [i_tup for i_tup in j if not isinstance(i_tup, int)]:
            s[0] += (len(t) + len(c),)
            c.append(i_tup)
    return s


def _disconnected_subgraphs(inputs, output):
    """Groups of inputs connected through summation indices."""
    subgraphs = []
    unused = set(range(len(inputs)))
    i_sum = frozenset.union(*inputs) - output
    while unused:
        g = set()
        q = [unused.pop()]
        while q:
            j = q.pop()
            g.add(j)
            i_tmp = i_sum & inputs[j]
            n = {k for k in unused if i_tmp & inputs[k]}
            q.extend(n)
            unused.difference_update(n)
        subgraphs.append(frozenset(g))
    return subgraphs


def _bitmap_select(s, seq):
    return (x for x, b in zip(seq, bin(s)[:1:-1]) if b == "1")


def _dp_calc_legs(g, all_tensors, s, inputs, i1_cut_i2_wo_output, i1_union_i2):
    r = g & (all_tensors ^ s)  # tensors of g not in s
    i_r = frozenset.union(*_bitmap_select(r, inputs)) if r else frozenset()
    return i1_union_i2 - (i1_cut_i2_wo_output - i_r)


def dynamic_programming(inputs_, output_, sizes_, memory_limit=None):
    """opt_einsum's ``DynamicProgramming()`` (minimize FLOPs, iterated cost
    cap, no outer products; Phys. Rev. E 90, 033315)."""
    ind_counts = Counter(itertools.chain(*inputs_, output_))
    all_inds = tuple(ind_counts)
    symbol2int = {c: j for j, c in enumerate(all_inds)}
    inputs = [frozenset(symbol2int[c] for c in i) for i in inputs_]
    output = frozenset(symbol2int[c] for c in output_)
    canonical = {symbol2int[c]: v for c, v in sizes_.items() if c in symbol2int}
    size_dict = [canonical[j] for j in range(len(canonical))]
    naive_cost = len(inputs) * functools.reduce(lambda a, b: a * b, size_dict, 1)

    # indices on one operand only are summed by a single-term step first
    i_single = frozenset(i for i, c in enumerate(all_inds) if ind_counts[c] == 1)
    parsed, done, contractions = [], [], []
    for j, i in enumerate(inputs):
        reduced = i - i_single
        if not reduced and i:
            done.append((j,))
        else:
            parsed.append(reduced)
            contractions.append((j,) if reduced != i else j)
    inputs = parsed
    if not inputs:
        return _tree_to_sequence(functools.reduce(lambda x, y: (x, y), done))

    subgraph_contractions = done
    subgraph_sizes = [1] * len(done)
    all_tensors = (1 << len(inputs)) - 1
    for g in _disconnected_subgraphs(inputs, output):
        # x[n][bitmap of n tensors] = (indices, cost, contraction)
        x = [None] * 2 + [{} for _ in range(len(g) - 1)]
        x[1] = {1 << j: (inputs[j], 0, contractions[j]) for j in g}
        bitmap_g = functools.reduce(lambda a, b: a | b, (1 << j for j in g))
        subgraph_inds = frozenset.union(*_bitmap_select(bitmap_g, inputs))
        cost_cap = _size(subgraph_inds & output, size_dict)
        cost_increment = (max(min(map(size_dict.__getitem__, subgraph_inds)), 2)
                          if subgraph_inds else 2)
        while not x[-1]:
            for n in range(2, len(x[1]) + 1):
                xn = x[n]
                for m in range(1, n // 2 + 1):
                    for s1, (i1, cost1, contract1) in x[m].items():
                        for s2, (i2, cost2, contract2) in x[n - m].items():
                            if s1 & s2 or not (m != n - m or s1 < s2):
                                continue
                            cut = (i1 & i2) - output
                            if not cut:
                                continue  # no outer products
                            union = i1 | i2
                            cost = cost1 + cost2 + _size(union, size_dict)
                            if cost > cost_cap:
                                continue
                            s = s1 | s2
                            if s not in xn or cost < xn[s][1]:
                                i = _dp_calc_legs(bitmap_g, all_tensors, s,
                                                  inputs, cut, union)
                                mem = _size(i, size_dict)
                                if memory_limit is None or mem <= memory_limit:
                                    xn[s] = (i, cost, (contract1, contract2))
            if cost_cap > naive_cost and not x[-1]:
                raise TNError("dp: no contraction path within memory_limit")
            cost_cap = cost_increment * cost_cap
        i, _, contraction = next(iter(x[-1].values()))
        subgraph_contractions.append(contraction)
        subgraph_sizes.append(_size(i, size_dict))

    order = sorted(range(len(subgraph_sizes)), key=subgraph_sizes.__getitem__)
    tree = functools.reduce(lambda a, b: (a, b),
                            [subgraph_contractions[j] for j in order])
    return _tree_to_sequence(tree)


# ------------------------------------------------------------- dispatch


def auto(inputs, output, sizes, memory_limit=None):
    """opt_einsum's ``auto``: a strategy chosen by operand count."""
    n = len(inputs)
    fn = (optimal if n <= 4 else branch_all if n <= 6 else branch_2 if n <= 8
          else branch_1 if n <= 14 else greedy)
    return fn(inputs, output, sizes, memory_limit)


def auto_hq(inputs, output, sizes, memory_limit=None):
    """opt_einsum's ``auto-hq``: ``optimal`` for 1–5 operands, ``dp`` for
    6–16, ``random-greedy-128`` above."""
    n = len(inputs)
    fn = (optimal if n <= 5 else dynamic_programming if n <= 16
          else random_greedy_128)
    return fn(inputs, output, sizes, memory_limit)


STRATEGIES = {
    "auto": auto,
    "auto-hq": auto_hq,
    "optimal": optimal,
    "branch-all": branch_all,
    "branch-2": branch_2,
    "branch-1": branch_1,
    "greedy": greedy,
    "eager": greedy,
    "opportunistic": greedy,
    "dp": dynamic_programming,
    "dynamic-programming": dynamic_programming,
    "random-greedy": random_greedy,
    "random-greedy-128": random_greedy_128,
}


def _memory_arg(memory_limit, terms, output, sizes):
    """opt_einsum's ``_choose_memory_arg``."""
    if memory_limit == "max_input":
        return max(_size(t, sizes) for t in list(terms) + [output])
    if isinstance(memory_limit, str):
        raise TNError("memory_limit must be None, an int or 'max_input'")
    if memory_limit is None or memory_limit == -1:
        return None
    if memory_limit < 1:
        raise TNError("memory_limit must be larger than 0, or -1")
    return int(memory_limit)


def _explicit_path(path, n_inputs):
    """Validate an explicit linear-id path (numpy's leading tag allowed)."""
    path = [p for p in path if p != "einsum_path"]
    count = n_inputs
    out = []
    for step in path:
        step = tuple(int(i) for i in step)
        if not step or len(set(step)) != len(step) or \
                not all(0 <= i < count for i in step):
            raise TNError(f"Invalid contraction step {step} for {count} operands")
        count -= len(step) - 1
        out.append(step)
    if count != 1:
        raise TNError(
            f"Contraction path leaves {count} operands; it must end with one"
        )
    return tuple(out)


def steps_from_path(terms, output, path):
    """Pairwise steps ``((operand positions, step einsum string), ...)``.

    Positions are popped in descending order, matching the einsum string's
    term order; each intermediate keeps the indices still needed by the
    remaining operands or the output, and the last step emits ``output``.
    """
    inputs = list(terms)
    holders = Counter(ix for t in inputs for ix in set(t))  # terms holding ix
    keep = set(output)
    steps = []
    for k, step in enumerate(path):
        pos = tuple(sorted(step, reverse=True))
        taken = [inputs.pop(i) for i in pos]
        for t in taken:
            holders.subtract(set(t))
        if k == len(path) - 1:
            result = output
        else:
            result = "".join(
                dict.fromkeys(
                    ix for t in taken for ix in t
                    if ix in keep or holders[ix] > 0
                )
            )
        holders.update(set(result))
        inputs.append(result)
        steps.append((pos, ",".join(taken) + "->" + result))
    return tuple(steps)


@lru_cache(maxsize=None)
def find_path(terms, output, shapes, optimize, memory_limit):
    """Cached linear-id path for one ``(einsum, shapes, optimize)`` signature.

    ``terms`` and ``shapes`` are tuples; ``optimize`` is a strategy name
    (module doc) or an explicit path frozen to a tuple of tuples.
    """
    if not isinstance(optimize, str):
        return _explicit_path(optimize, len(terms))
    name = optimize.lower()
    if name not in STRATEGIES and name != NATIVE:
        raise TNError(
            f"Path strategy {optimize!r} is not available in this package; "
            f"use one of {sorted(STRATEGIES)}, '{NATIVE}' or an explicit path"
        )
    sizes = {}
    for term, shape in zip(terms, shapes):
        sizes.update(zip(term, shape))
    with Timings.measure("path_find"):
        if len(terms) <= 2:  # nothing to optimize (as opt_einsum.contract_path)
            return (tuple(range(len(terms))),)
        if name == NATIVE:
            from ..native import greedy_path as native_greedy_path

            return tuple(native_greedy_path(terms, output, sizes))
        limit = _memory_arg(memory_limit, terms, output, sizes)
        # frozensets built as opt_einsum.contract_path builds them: the
        # random trials draw in the iteration order of these sets
        path = STRATEGIES[name]([frozenset(t) for t in terms],
                                frozenset(output), sizes, limit)
        return tuple(tuple(step) for step in path)


@lru_cache(maxsize=None)
def find_steps(terms, output, shapes, optimize, memory_limit):
    """Cached pairwise steps for one ``(einsum, shapes, optimize)`` signature
    (arguments as for :func:`find_path`)."""
    path = find_path(terms, output, shapes, optimize, memory_limit)
    return steps_from_path(terms, output, path)
