"""Pairwise contraction paths without opt_einsum.

The JAX package asks ``opt_einsum.contract_path`` for its pairwise steps
(``contractn_tpu/compiler/engine.py:_find_steps``).  opt_einsum is not a
dependency of this package, so the path search lives here:

* :func:`greedy_path` — the greedy heuristic: identical index sets multiply
  first (Hadamard products), then pairs that share an index contract in
  order of least ``size(result) - size(a) - size(b)``, then the leftovers
  are joined by outer products, smallest first.  ``optimize="auto"`` and
  ``"greedy"`` both use it.
* ``"native-greedy"`` — the C++ greedy optimizer of :mod:`..native`
  (built with ``g++`` at first use); it raises :class:`TNError` where the
  library cannot be built or loaded.
* explicit paths (opt_einsum's linear-id format, e.g. ``[(0, 1), (0, 1)]``)
  are honoured as given.

Every other named strategy (``"optimal"``, ``"dp"``, ...) raises
:class:`TNError`.  A different path changes only the rounding of the result:
the split-format mantissa is renormalized after the last step.
"""

import heapq
from collections import Counter
import math
from functools import lru_cache

from ..utils.errors import TNError
from ..utils.introspect import Timings

_GREEDY_NAMES = ("auto", "greedy")
NATIVE = "native-greedy"


def _size(indices, sizes):
    return math.prod(sizes[i] for i in indices)


def greedy_path(terms, output, sizes, memory_limit=None):
    """Linear-id pairwise path for ``terms -> output`` (greedy heuristic).

    Args:
        terms: index strings, one per operand.
        output: output index string.
        sizes: index -> dimension.
        memory_limit: pairs whose result has more elements are not taken
            while contractions remain; the outer-product stage ignores it.
    """
    n = len(terms)
    if n == 1:
        return ((0,),)
    keys = [frozenset(t) for t in terms]
    # an index held by every operand can only go at the last step
    keep = frozenset(output) | frozenset.intersection(*keys)

    remaining = {}  # ssa id -> index set
    ssa_path = []
    next_id = n
    by_key = {}
    for i, key in enumerate(keys):
        if key in by_key:  # Hadamard product of identical index sets
            ssa_path.append((by_key[key], i))
            del remaining[by_key[key]]
            i = next_id
            next_id += 1
        by_key[key] = i
        remaining[i] = key

    holders = {}  # contractable index -> ssa ids holding it
    for i, key in remaining.items():
        for ix in key - keep:
            holders.setdefault(ix, set()).add(i)

    def result_key(a, b):
        ka, kb = remaining[a], remaining[b]
        out = set()
        for ix in ka | kb:
            if ix in keep or len(holders.get(ix, ())) > (ix in ka) + (ix in kb):
                out.add(ix)
        return frozenset(out)

    queue = []

    def push(a, b):
        a, b = min(a, b), max(a, b)
        k = result_key(a, b)
        size = _size(k, sizes)
        if memory_limit is not None and size > memory_limit:
            return
        cost = size - _size(remaining[a], sizes) - _size(remaining[b], sizes)
        heapq.heappush(queue, (cost, a, b))

    for ids in holders.values():
        ids = sorted(ids)
        for x, a in enumerate(ids):
            for b in ids[x + 1:]:
                push(a, b)
    while queue:
        _, a, b = heapq.heappop(queue)
        if a not in remaining or b not in remaining:
            continue
        key = result_key(a, b)
        for i in (a, b):
            for ix in remaining.pop(i) - keep:
                holders[ix].discard(i)
        c = next_id
        next_id += 1
        ssa_path.append((a, b))
        remaining[c] = key
        for ix in key - keep:
            holders[ix].add(c)
        for other in {o for ix in key - keep for o in holders[ix]} - {c}:
            push(c, other)

    # whatever is left shares no contractable index: outer products
    final = [(_size(k & keep, sizes), i) for i, k in remaining.items()]
    heapq.heapify(final)
    _, a = heapq.heappop(final)
    while final:
        _, b = heapq.heappop(final)
        key = result_key(a, b)
        del remaining[a], remaining[b]
        c = next_id
        next_id += 1
        ssa_path.append((min(a, b), max(a, b)))
        remaining[c] = key
        _, a = heapq.heappushpop(final, (_size(key & keep, sizes), c))
    return _ssa_to_linear(ssa_path, n)


def _ssa_to_linear(ssa_path, n_inputs):
    """Static-single-assignment ids -> positions in the shrinking list."""
    ids = list(range(n_inputs))
    path = []
    new_id = n_inputs
    for pair in ssa_path:
        pos = sorted(ids.index(s) for s in pair)
        for p in reversed(pos):
            ids.pop(p)
        ids.append(new_id)
        new_id += 1
        path.append(tuple(pos))
    return tuple(path)


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

    ``terms`` and ``shapes`` are tuples; ``optimize`` is ``"auto"``,
    ``"greedy"``, ``"native-greedy"`` or an explicit path frozen to a tuple of
    tuples.
    """
    if not isinstance(optimize, str):
        return _explicit_path(optimize, len(terms))
    if optimize not in _GREEDY_NAMES + (NATIVE,):
        raise TNError(
            f"Path strategy {optimize!r} is not available in this package; "
            f"use 'auto', 'greedy', '{NATIVE}' or an explicit path"
        )
    sizes = {}
    for term, shape in zip(terms, shapes):
        sizes.update(zip(term, shape))
    with Timings.measure("path_find"):
        if optimize == NATIVE:
            from ..native import greedy_path as native_greedy_path

            if len(terms) == 1:
                return ((0,),)
            return tuple(native_greedy_path(terms, output, sizes))
        return greedy_path(terms, output, sizes, memory_limit)


@lru_cache(maxsize=None)
def find_steps(terms, output, shapes, optimize, memory_limit):
    """Cached pairwise steps for one ``(einsum, shapes, optimize)`` signature
    (arguments as for :func:`find_path`)."""
    path = find_path(terms, output, shapes, optimize, memory_limit)
    return steps_from_path(terms, output, path)
