"""Split-format numerical stabilization.

Counterpart of ``contractn_tpu/ops/stabilize.py``.  After every pairwise
contraction the intermediate is rescaled so its mean absolute element is 1,
and the log of the accumulated rescale factor rides along in a scalar
register.  A 1000-term product that would overflow float32 by hundreds of
orders of magnitude is returned exactly as ``(mantissa, log_scale)``.

All branches are ``torch.where``-selected, so no rescale waits on the device
(no host round trip per step).

Precision policy: float32 work stays IEEE float32.  Nothing in this package
enables TF32 (``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``) or lowers
``torch.set_float32_matmul_precision`` below ``"highest"``;
``tests/test_torch_graph.py`` checks the source for it.  bfloat16 runs only
where the caller passes bfloat16 tensors.  :func:`dot_precision` and
:func:`peinsum` are the counterparts of the JAX package's: the precision a
contraction needs, and an einsum that refuses to run below it;
:func:`pmatmul` is the same check around ``torch.matmul``.
"""

import torch

from ..utils.errors import TNError

# Below this total L1 mass a tensor is considered negligible and is left
# unscaled (avoids division by ~0).
MIN_NORM = 1e-7


def dot_precision(*dtypes):
    """Float32 matmul precision the given operand dtypes need.

    ``"highest"`` (IEEE float32, no TF32 passes) when any operand is
    float32, float64 or complex; ``None`` for bfloat16/float16 operands,
    which the caller chose for speed.
    """
    for dt in dtypes:
        if dt in (torch.float32, torch.float64) or dt.is_complex:
            return "highest"
    return None


def _check_precision(*dtypes):
    if dot_precision(*dtypes) and torch.get_float32_matmul_precision() != "highest":
        raise TNError(
            "float32 matmul precision is lowered (TF32 is enabled); this "
            "package computes float32 as IEEE float32: call "
            "torch.set_float32_matmul_precision('highest')"
        )


def peinsum(subscripts, *operands):
    """``torch.einsum`` with the package's precision invariant and the JAX
    package's dtype promotion.

    Operands are promoted to one common dtype (``jnp.einsum`` promotes mixed
    dtypes; ``torch.einsum`` refuses them).  Where that dtype needs IEEE
    float32 (:func:`dot_precision`) and the process has lowered
    ``torch.get_float32_matmul_precision()`` (TF32 enabled), it raises
    :class:`TNError` instead of contracting at TF32 precision.
    """
    dtype = operands[0].dtype
    for op in operands[1:]:
        dtype = torch.promote_types(dtype, op.dtype)
    _check_precision(dtype)
    return torch.einsum(subscripts, *(op.to(dtype) for op in operands))


def pmatmul(a, b):
    """``torch.matmul`` under :func:`peinsum`'s precision check: float32,
    float64 and complex products refuse to run while TF32 is enabled.  For
    the large explicit GEMM chains (the 3D HOTRG merge) whose order must not
    be left to an einsum."""
    _check_precision(a.dtype, b.dtype)
    return torch.matmul(a, b)


def path_einsum(subscripts, *operands):
    """:func:`peinsum` of three or more operands along an optimized pairwise
    path.

    ``torch.einsum`` picks a contraction order only where opt_einsum is
    installed and otherwise contracts from the left, which for the ring
    diagrams of the 2D and MERA modules forms outer products many times the
    size of the result.  This takes the path from the package's own port of
    opt_einsum's ``"auto"`` strategy (:func:`~..compiler.paths.find_steps`,
    cached per signature), so the order is the same wherever it runs.
    """
    if len(operands) <= 2:
        return peinsum(subscripts, *operands)
    from ..compiler.paths import find_steps

    lhs, out = subscripts.replace(" ", "").split("->")
    steps = find_steps(tuple(lhs.split(",")), out,
                       tuple(tuple(op.shape) for op in operands), "auto", None)
    ops = list(operands)
    for pos, eq in steps:
        ops.append(peinsum(eq, *[ops.pop(i) for i in pos]))
    return ops[0]


def stabilize(tensor, log_scale):
    """Move the scale of ``tensor`` into ``log_scale``; mean|out| becomes 1.

    Returns ``(rescaled, new_log_scale)`` with
    ``rescaled * exp(new_log_scale) == tensor * exp(log_scale)``.
    """
    norm = tensor.abs().sum()
    rescale = norm / tensor.numel()
    safe = torch.where(norm > MIN_NORM, rescale, torch.ones_like(rescale))
    # safe == 1 when not applying, so the divide/log are no-ops there
    return tensor / safe, log_scale + torch.log(safe)


def stabilize_batched(tensor, log_scale, batch_ndim):
    """Per-slice stabilization over leading batch axes.

    ``tensor`` has ``batch_ndim`` leading batch dimensions; each slice gets
    its own rescale, and ``log_scale`` (shape = batch shape) accumulates the
    per-slice logs.
    """
    reduce_dims = tuple(range(batch_ndim, tensor.ndim))
    slice_size = 1
    for ax in reduce_dims:
        slice_size *= tensor.shape[ax]
    norm = tensor.abs().sum(dim=reduce_dims) if reduce_dims else tensor.abs()
    rescale = norm / slice_size
    safe = torch.where(norm > MIN_NORM, rescale, torch.ones_like(rescale))
    expand = safe.reshape(safe.shape + (1,) * len(reduce_dims))
    return tensor / expand, log_scale + torch.log(safe)


def destabilize(tensor, log_scale):
    """Fold the log-scale register back into the tensor."""
    return tensor * torch.exp(log_scale)
