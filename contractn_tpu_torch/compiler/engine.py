"""Stabilized einsum contraction engine in PyTorch.

Counterpart of ``contractn_tpu/compiler/engine.py``.  Public entry point:
:func:`contract` — an einsum string plus operands, with ``split_format`` /
``optimize`` / ``memory_limit`` controls.

* The pairwise path is found **once per shape signature** (cached, see
  :mod:`.paths`); each call then runs the steps eagerly in torch, with a
  split-format rescale after every step.
* Long regular step runs (a level of identical pair contractions, a linear
  recurrence) are lowered by :mod:`.lowering` to one batched einsum or one
  loop over a pre-stacked operand each, with the same rescales in the same
  order.
* Long homogeneous matrix chains, ring traces and pure hyperedge (Hadamard)
  contractions are detected and rerouted to :mod:`..ops.chain`.
* Repeated *output* indices (a copy node with several dangling edges) are
  lowered by contracting the reduced output and scattering it onto the
  generalized diagonal.
* ``backend="numpy"`` runs the same step sequence eagerly in numpy — the
  float64 parity oracle.
* ``backend="tensorflow"`` takes TF tensors and Variables, computes through
  this engine and returns TF tensors that a ``tf.GradientTape`` records
  (:mod:`.interop`).

Departures from the JAX package: torch operands keep native autograd
instead of going through an interop bridge, and the computation runs on the
GPU unless the caller asks for the CPU (:mod:`..utils.device`).
"""

import time
from dataclasses import dataclass
from functools import lru_cache, reduce

import numpy as np
import torch

from ..ops.chain import (
    stabilized_chain_product,
    stabilized_hadamard_product,
    stabilized_ring_product,
)
from ..ops.stabilize import MIN_NORM, destabilize, stabilize
from ..utils.device import as_tensor, real_dtype, resolve_device
from ..utils.errors import TNError
from .lowering import lower
from .paths import find_steps

# Below this many chain links the general einsum path is used; above it the
# log-depth tree reduction takes over.
_CHAIN_THRESHOLD = 16

_ASCII = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def contract(*operands, **kwargs):
    """Stabilized einsum: ``contract(einstr, *tensors, **options)``.

    Args:
        einstr: Einsum string, first positional argument.  Copy-tensor
            hyperedges appear as a symbol repeated across terms and/or the
            output; repeated output symbols produce a generalized diagonal.
        *tensors: One array per einsum term (torch tensors, numpy arrays).
        split_format: If True return ``(mantissa, log_scale)`` with
            ``mean(|mantissa|) == 1`` and true result
            ``mantissa * exp(log_scale)``; if False return the dense result.
        optimize: a path strategy (``"auto"``, ``"greedy"``,
            ``"optimal"``, ``"dp"``, ``"random-greedy"``, ... as in
            opt_einsum, see :mod:`.paths`; or ``"native-greedy"``) or an
            explicit path list.
        memory_limit: optional bound on intermediate size (elements) for
            the path search.
        backend: ``"torch"`` (default, alias ``"auto"``), ``"numpy"`` for
            an eager float64-capable host oracle, or ``"tensorflow"``
            (TF tensors in and out, with tape gradients; needs
            tensorflow).
        device: where the torch backend computes.  Default: the torch
            operands' device, else ``cuda``; raises without a GPU unless
            ``device="cpu"`` is given.
        dtype: cast the operands to this dtype first.
        jit / use_blas / order / casting: accepted for signature
            compatibility; no-ops (the steps run eagerly, there is no
            trace to switch off).

    Returns:
        The contracted tensor, or ``(mantissa, log_scale)`` in split format.
    """
    if not operands or not isinstance(operands[0], str):
        raise TypeError("contract() expects an einsum string first argument")
    einstr, tensors = operands[0], operands[1:]
    if not tensors:
        raise TNError("contract() needs at least one operand")

    split_format = kwargs.pop("split_format", False)
    optimize = kwargs.pop("optimize", "auto")
    if optimize is True:
        optimize = "auto"
    memory_limit = kwargs.pop("memory_limit", None)
    backend = kwargs.pop("backend", "auto")
    device = kwargs.pop("device", None)
    dtype = kwargs.pop("dtype", None)
    kwargs.pop("jit", None)
    kwargs.pop("use_blas", None)
    kwargs.pop("order", None)
    kwargs.pop("casting", None)
    if kwargs:
        raise TypeError(
            "Did not understand the following kwargs: {}".format(sorted(kwargs))
        )
    if backend not in ("auto", "torch", "numpy", "tensorflow"):
        raise TNError(f"Unknown backend '{backend}'")

    einstr = einstr.replace(" ", "")
    shapes = tuple(tuple(int(d) for d in t.shape) for t in tensors)
    _validate(einstr, shapes)
    optimize = _freeze(optimize)

    if backend == "tensorflow":
        from .interop import tf_contract

        return tf_contract(einstr, tensors, dtype, optimize, memory_limit,
                           split_format, device=device)

    if backend == "numpy":
        arrays = [
            t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
            for t in tensors
        ]
        arrays = [np.asarray(t, dtype=dtype) for t in arrays]
        return _numpy_contract(einstr, arrays, optimize, memory_limit, split_format)

    dev = resolve_device(device, tensors)
    ops = [as_tensor(t, dev, dtype) for t in tensors]
    common = reduce(torch.promote_types, [t.dtype for t in ops])
    if not (common.is_floating_point or common.is_complex):
        common = torch.float64  # integer operands: exact in float64
    ops = [t.to(common) for t in ops]
    result, log_scale = _run(_plan(einstr, shapes, optimize, memory_limit), ops)
    if split_format:
        return result, log_scale
    return destabilize(result, log_scale)


# --------------------------------------------------------------------- #
# Validation and einstring utilities
# --------------------------------------------------------------------- #


def _parse(einstr):
    if "->" not in einstr:
        raise TNError(f"Einsum string must contain '->': {einstr!r}")
    lhs, output = einstr.split("->")
    terms = lhs.split(",") if lhs else []
    return terms, output


def _validate(einstr, shapes):
    terms, output = _parse(einstr)
    if len(terms) != len(shapes):
        raise TNError(
            f"Einsum string has {len(terms)} terms but {len(shapes)} "
            "operands were supplied"
        )
    sym_dims = {}
    for term, shape in zip(terms, shapes):
        if len(term) != len(shape):
            raise TNError(
                f"Term '{term}' has {len(term)} indices but operand has "
                f"shape {shape}"
            )
        for s, d in zip(term, shape):
            if s in sym_dims and sym_dims[s] != d:
                raise TNError(
                    f"Index '{s}' has conflicting dimensions "
                    f"{sym_dims[s]} and {d}"
                )
            sym_dims[s] = d
    for s in output:
        if s not in sym_dims:
            raise TNError(
                f"Output index '{s}' appears in no input term, so its "
                "dimension is undetermined (did you contract a copy node "
                "with only dangling edges?)"
            )
    return sym_dims


def _dedup_output(einstr):
    """Split a repeated-output einstring into (reduced einstring, full output).

    ``"a,ab->bb"`` becomes ``("a,ab->b", "bb")``; the engine contracts the
    reduced string and then embeds the result on the generalized diagonal.
    Returns ``(einstr, None)`` when the output has no repeats.
    """
    terms, output = _parse(einstr)
    unique = "".join(dict.fromkeys(output))
    if unique == output:
        return einstr, None
    return ",".join(terms) + "->" + unique, output


def _embed_diagonal(x, unique_out, full_out):
    """Scatter ``x`` (indexed by ``unique_out``) onto the diagonal positions
    of a tensor indexed by ``full_out`` (repeated labels = diagonal).

    Works on torch tensors and numpy arrays alike.  Example: ``x[a]`` with
    ``full_out == "aa"`` yields ``out[i, j] = x[i] * delta(i, j)``.
    ``unique_out`` must list the first occurrences of ``full_out``'s labels
    in order (what :func:`_dedup_output` produces).
    """
    is_torch = isinstance(x, torch.Tensor)
    labels = list(unique_out)
    for pos, s in enumerate(full_out):
        if pos < len(labels) and labels[pos] == s and s not in labels[:pos]:
            continue  # first occurrence, already in the right place
        first = labels.index(s)  # existing axis carrying this label
        d = x.shape[first]
        labels.insert(pos, s)
        mask_shape = [1] * (x.ndim + 1)
        mask_shape[first] = d
        mask_shape[pos] = d
        if is_torch:
            x = x.unsqueeze(pos)
            eye = torch.eye(d, dtype=x.dtype, device=x.device)
        else:
            x = np.expand_dims(x, pos)
            eye = np.eye(d, dtype=x.dtype)
        # Kronecker delta between the first-occurrence axis and the new one
        x = x * eye.reshape(mask_shape)
    return x


def _remap_ascii(step_str):
    """Map arbitrary einsum symbols of one step onto a-zA-Z.

    ``torch.einsum`` and ``np.einsum`` accept only ASCII letters, while a
    large network's symbols run into unicode.
    """
    mapping = {}
    out = []
    for ch in step_str:
        if ch in ",->":
            out.append(ch)
            continue
        if ch not in mapping:
            if len(mapping) >= len(_ASCII):
                raise TNError("Contraction step uses more than 52 distinct indices")
            mapping[ch] = _ASCII[len(mapping)]
        out.append(mapping[ch])
    return "".join(out)


def _freeze(optimize):
    if isinstance(optimize, (list, tuple)):
        return tuple(p if isinstance(p, str) else tuple(p) for p in optimize)
    return optimize


# --------------------------------------------------------------------- #
# Structure detectors (long chains, rings, pure hyperedges)
# --------------------------------------------------------------------- #


def _detect_chain(einstr, shapes):
    """Recognize ``v? M M ... M v?`` chains of identical square matrices.

    Returns ``(n_mats, first_is_vec, last_is_vec)`` or None.  Matches the
    canonical orientation the graph layer emits (``"a,ab,bc,...->z"``).
    """
    terms, output = _parse(einstr)
    if len(terms) < _CHAIN_THRESHOLD:
        return None
    first_is_vec = len(shapes[0]) == 1
    last_is_vec = len(shapes[-1]) == 1
    lo = 1 if first_is_vec else 0
    hi = len(terms) - 1 if last_is_vec else len(terms)
    mats = shapes[lo:hi]
    if len(mats) < _CHAIN_THRESHOLD:
        return None
    d = mats[0][0] if mats[0] else None
    if any(len(s) != 2 or s != (d, d) for s in mats):
        return None
    if first_is_vec and shapes[0] != (d,):
        return None
    if last_is_vec and shapes[-1] != (d,):
        return None
    for i, t in enumerate(terms):
        expected = 1 if (i == 0 and first_is_vec) or (
            i == len(terms) - 1 and last_is_vec
        ) else 2
        if len(t) != expected or len(set(t)) != expected:
            return None
        if i > 0 and t[0] != terms[i - 1][-1]:
            return None
    expected_out = ""
    if not first_is_vec:
        expected_out += terms[0][0]
    if not last_is_vec:
        expected_out += terms[-1][-1]
    if output != expected_out:
        return None
    return (hi - lo, first_is_vec, last_is_vec)


def _detect_ring(einstr, shapes):
    """Recognize cyclic matrix products ``"ab,bc,...,za->"`` (a trace)."""
    terms, output = _parse(einstr)
    if output != "" or len(terms) < _CHAIN_THRESHOLD:
        return False
    d = shapes[0][0] if shapes[0] else None
    if any(len(s) != 2 or s != (d, d) for s in shapes):
        return False
    for i, t in enumerate(terms):
        if len(t) != 2 or len(set(t)) != 2:
            return False
        if i > 0 and t[0] != terms[i - 1][-1]:
            return False
    return terms[0][0] == terms[-1][-1]


def _detect_hadamard(einstr, shapes):
    """Recognize pure hyperedge contractions ``"a,a,...,a->a"`` / ``"->"``.

    Returns None when not matched, else whether the output is summed.
    """
    terms, output = _parse(einstr)
    if len(terms) < 2:
        return None
    sym = terms[0]
    if len(sym) != 1 or any(t != sym for t in terms):
        return None
    if output not in ("", sym):
        return None
    if any(s != shapes[0] for s in shapes):
        return None
    return output == ""


# --------------------------------------------------------------------- #
# Planning (cached per signature) and execution
# --------------------------------------------------------------------- #


@dataclass(frozen=True)
class Plan:
    """How one signature runs: a structure ``route`` (``"chain"``,
    ``"hadamard"``, ``"ring"``) with its ``flags``, or the pairwise
    ``steps``, lowered to ``buckets`` where :mod:`.lowering` finds regular
    runs.  ``build_ms`` is what building it took (path search and lowering
    plan), measured when the signature was first planned."""

    route: str
    flags: tuple = ()
    steps: tuple = ()
    unique_out: str = ""
    full_out: str | None = None
    buckets: object = None
    build_ms: float = 0.0


@lru_cache(maxsize=None)
def _plan(einstr, shapes, optimize, memory_limit):
    """The cached :class:`Plan` of one signature."""
    t0 = time.perf_counter()
    reduced, full_out = _dedup_output(einstr)
    # Structure reroutes only fire for string strategies — an explicit
    # user-provided path is always honored via the pairwise steps.
    if full_out is None and isinstance(optimize, str):
        route = _route(reduced, shapes)
        if route is not None:
            return Plan(*route, build_ms=1e3 * (time.perf_counter() - t0))
    terms, unique_out = _parse(reduced)
    steps = find_steps(tuple(terms), unique_out, shapes, optimize, memory_limit)
    steps = tuple((inds, _remap_ascii(s)) for inds, s in steps)
    # Shape-bucketed lowering: long regular runs become one batched einsum
    # or one loop over a stacked operand each (None for irregular paths)
    buckets = lower(steps, len(shapes), shapes)
    return Plan("steps", (), steps, unique_out, full_out, buckets,
                1e3 * (time.perf_counter() - t0))


def _route(einstr, shapes):
    """``(route, flags)`` of a structure route the signature takes, or None."""
    chain = _detect_chain(einstr, shapes)
    if chain is not None:
        return "chain", chain[1:]
    hadamard = _detect_hadamard(einstr, shapes)
    if hadamard is not None:
        return "hadamard", (hadamard,)
    if _detect_ring(einstr, shapes):
        return "ring", ()
    return None


def _run(plan, ops):
    """Execute a plan on torch operands; returns ``(mantissa, log_scale)``."""
    if plan.route == "chain":
        first_is_vec, last_is_vec = plan.flags
        lo = 1 if first_is_vec else 0
        hi = len(ops) - 1 if last_is_vec else len(ops)
        mats = torch.stack(ops[lo:hi])
        left = ops[0] if first_is_vec else None
        right = ops[-1] if last_is_vec else None
        return stabilized_chain_product(mats, left=left, right=right)
    if plan.route == "hadamard":
        return stabilized_hadamard_product(torch.stack(ops), plan.flags[0])
    if plan.route == "ring":
        return stabilized_ring_product(torch.stack(ops))

    if plan.buckets is not None:
        result, log_scale = plan.buckets.run(ops)
    else:
        result, log_scale = _run_steps(plan.steps, ops)
    if plan.full_out is not None:
        result = _embed_diagonal(result, plan.unique_out, plan.full_out)
        # Re-normalize: embedding inserts zeros, changing the mean |elem|
        result, log_scale = stabilize(result, log_scale)
    return result, log_scale


def _run_steps(steps, ops):
    """The per-step loop: one einsum and one rescale a pairwise step."""
    ops = list(ops)
    log_scale = torch.zeros(
        (), dtype=real_dtype(ops[0].dtype), device=ops[0].device
    )
    for inds, step_str in steps:
        tmp = [ops.pop(i) for i in inds]
        new, log_scale = stabilize(torch.einsum(step_str, *tmp), log_scale)
        ops.append(new)
    return ops[0], log_scale


# --------------------------------------------------------------------- #
# Numpy oracle path (eager, float64-capable)
# --------------------------------------------------------------------- #


def _np_stabilize(tensor, log_scale):
    norm = np.sum(np.abs(tensor))
    rescale = norm / tensor.size
    if norm > MIN_NORM:
        tensor = tensor / rescale
        log_scale = log_scale + np.log(rescale)
    return tensor, log_scale


def _numpy_contract(einstr, tensors, optimize, memory_limit, split_format):
    reduced, full_out = _dedup_output(einstr)
    terms, unique_out = _parse(reduced)
    shapes = tuple(tuple(int(d) for d in t.shape) for t in tensors)
    steps = find_steps(tuple(terms), unique_out, shapes, optimize, memory_limit)
    ops = list(tensors)
    log_scale = np.zeros(())
    for inds, step_str in steps:
        tmp = [ops.pop(i) for i in inds]
        new = np.einsum(_remap_ascii(step_str), *tmp)
        new, log_scale = _np_stabilize(new, log_scale)
        ops.append(new)
    result = ops[0]
    if full_out is not None:
        result = _embed_diagonal(result, unique_out, full_out)
        result, log_scale = _np_stabilize(result, log_scale)
    if split_format:
        return result, log_scale
    return result * np.exp(log_scale)

