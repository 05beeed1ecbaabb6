"""Autograd across libraries: ``contract()`` under torch and TensorFlow.

Counterpart of ``contractn_tpu/compiler/interop.py``.  This package computes
in torch, so torch operands keep their autograd graph through the engine
itself and :func:`torch_contract` is a thin call of it.  TensorFlow operands
go through :func:`tf_contract`:

* the forward converts the TF tensors (or Variables) to torch tensors on the
  resolved device (``cuda`` unless ``device=`` says otherwise), contracts
  them through the engine, and returns TF tensors, one per output (so split
  format gives two);
* ``tf.custom_gradient`` wraps it, so a ``tf.GradientTape`` watching the
  operands records the contraction; the gradient function re-runs the same
  plan on torch leaves (the forward is recomputed, as in the JAX bridge)
  and calls :func:`torch.autograd.grad` with the TF cotangents.

Complex operands follow the JAX bridge's convention: the TF cotangent is
pulled back as JAX's VJP pulls it back (``ct * f'(z)``, linear in ``ct``).
torch's backward is the conjugate of that (``ct * conj(f'(z))``), so the
bridge conjugates the cotangent on the way in and the gradient on the way
out.  Second-order gradients are not supported.

``tensorflow`` is imported inside these functions only; without it
``backend="tensorflow"`` raises :class:`TNError`.
"""

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.errors import TNError

__all__ = ["torch_contract", "tf_contract"]


def _contract(einstr, operands, dtype, optimize, memory_limit, split_format,
              device):
    from .engine import contract

    return contract(einstr, *operands, dtype=dtype, optimize=optimize,
                    memory_limit=memory_limit, split_format=split_format,
                    device=device)


def torch_contract(einstr, tensors, dtype, optimize, memory_limit,
                   split_format, wrap=None, device=None):
    """Contract torch operands with native autograd (the engine keeps the
    graph).  ``wrap``, if given, converts each output."""
    out = _contract(einstr, tensors, dtype, optimize, memory_limit,
                    split_format, device)
    if wrap is None:
        return out
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _tensorflow():
    try:
        import tensorflow as tf
    except ImportError:
        raise TNError(
            "backend='tensorflow' requested but tensorflow is not installed"
        ) from None
    return tf


def tf_contract(einstr, tensors, dtype, optimize, memory_limit, split_format,
                wrap=None, device=None):
    """Contract with ``tf.GradientTape`` support (called from
    ``contract(..., backend="tensorflow")``); returns TF tensors."""
    tf = _tensorflow()
    dev = resolve_device(device)
    if wrap is None:
        def wrap(r):
            return tf.convert_to_tensor(r.detach().cpu().numpy())

    def as_tf(t):
        # Variables go through convert_to_tensor so the tape links the read
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        return tf.convert_to_tensor(t)

    def leaves(xs, grad):
        ts = [torch.from_numpy(np.array(x.numpy())).to(dev) for x in xs]
        if grad:
            for t in ts:
                t.requires_grad_(t.is_floating_point() or t.is_complex())
        return ts

    @tf.custom_gradient
    def f(*xs):
        with torch.no_grad():
            out = _contract(einstr, leaves(xs, False), dtype, optimize,
                            memory_limit, split_format, dev)

        def grad(*dys):
            ts = leaves(xs, True)
            with torch.enable_grad():
                res = _contract(einstr, ts, dtype, optimize, memory_limit,
                                split_format, dev)
            res = res if isinstance(res, tuple) else (res,)
            cts = [torch.zeros_like(r) if dy is None
                   else torch.from_numpy(np.array(dy.numpy())).to(r).conj()
                   for r, dy in zip(res, dys)]
            used = [t for t in ts if t.requires_grad]
            gs = iter(torch.autograd.grad(res, used, cts, allow_unused=True))
            out_grads = []
            for t, x in zip(ts, xs):
                g = next(gs) if t.requires_grad else None
                g = (np.zeros(x.shape, x.dtype.as_numpy_dtype) if g is None
                     else g.conj().resolve_conj().cpu().numpy().astype(
                         x.dtype.as_numpy_dtype))
                out_grads.append(tf.convert_to_tensor(g))
            return out_grads

        if isinstance(out, tuple):
            return tuple(wrap(r) for r in out), grad
        return wrap(out), grad

    return f(*(as_tf(t) for t in tensors))
