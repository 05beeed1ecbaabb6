"""Carry parameters across between this package and the JAX package.

The JAX package's ``MPS`` and ``MPO`` hold their parameters as arrays; pass
them through ``numpy.asarray`` and hand them to ``mps_from_numpy`` /
``mpo_from_numpy`` to get this package's objects on ``device`` (default
``cuda``; raises without a GPU unless ``device="cpu"``), with the same dtype
and values.  ``mps_to_numpy`` / ``mpo_to_numpy`` go the other way, so
parameters trained here can be held against the JAX package.  The tests use
them so that both packages compute on identical data.
"""

import numpy as np
import torch

from .models.mpo import MPO
from .models.mps import MPS
from .utils.device import as_tensor, resolve_device


def _put(arrays, device):
    device = resolve_device(device)
    return [as_tensor(np.asarray(a), device) for a in arrays]


def mps_from_numpy(cores, left, right, device=None):
    """``MPS`` from ``(N, d, D, D)`` cores and ``(D,)`` boundary vectors."""
    return MPS(*_put((cores, left, right), device))


def mpo_from_numpy(cores, left, right, device=None):
    """``MPO`` from ``(N, d, d, W, W)`` cores and ``(W,)`` boundary vectors."""
    return MPO(*_put((cores, left, right), device))


def _host(tensors):
    out = []
    for t in tensors:
        t = t.detach().cpu()
        out.append((t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy())
    return tuple(out)


def mps_to_numpy(mps):
    """``(cores, left, right)`` of an ``MPS`` as numpy arrays on the host
    (bfloat16/float16 widen to float32, which numpy can hold)."""
    return _host((mps.cores, mps.left, mps.right))


def mpo_to_numpy(mpo):
    """``(cores, left, right)`` of an ``MPO`` as numpy arrays on the host."""
    return _host((mpo.cores, mpo.left, mpo.right))
