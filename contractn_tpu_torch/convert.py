"""Carry parameters across between this package and the JAX package.

The JAX package's ``MPS`` and ``MPO`` hold their parameters as arrays; pass
them through ``numpy.asarray`` and hand them to ``mps_from_numpy`` /
``mpo_from_numpy`` (a VUMPS ground dict to ``ground_from_numpy``) to get
this package's objects on ``device`` (default ``cuda``; raises without a
GPU unless ``device="cpu"``), with the same dtype and values.
``mps_to_numpy`` / ``mpo_to_numpy`` / ``ground_to_numpy`` go the other way, so
parameters trained here can be held against the JAX package.  The states the
2D and finite-temperature modules return (a thermal state dict, MERA
``params``, an IBC window), the 3D simple update's ``(gamma, lam)``, the 3D
thermal state ``(ga, gb, lams)`` and TTN ``params`` (``{"levels": [...],
"top": ...}``) — dicts, lists and tuples of arrays — cross with
``state_from_numpy`` / ``state_to_numpy``.  The tests use them so that both
packages compute on identical data.
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


_GROUND_TENSORS = ("al", "ar", "ac", "c")
_CELL_TENSORS = ("als", "ars", "acs", "cs")


def ground_from_numpy(ground, device=None):
    """A VUMPS ground dict of either package (``vumps`` / ``vumps_u1``:
    ``al, ar, ac, c``; ``vumps_cell`` / ``vumps_u1_cell``: the per-site
    tuples ``als, ars, acs, cs``) with its tensors as this package's tensors
    on ``device``; ``energy`` (and ``energies``, ``gradient_norm``) carried
    over as host floats, a charge ``sector`` rebuilt from its ladders."""
    device = resolve_device(device)
    out = {}
    for key in _GROUND_TENSORS:
        if key in ground:
            out[key] = as_tensor(np.asarray(ground[key]), device)
    for key in _CELL_TENSORS:
        if key in ground:
            out[key] = tuple(as_tensor(np.asarray(a), device) for a in ground[key])
    for key in ("energy", "energy_per_site", "gradient_norm"):
        if key in ground:
            out[key] = float(ground[key])
    if "energies" in ground:
        out["energies"] = [float(e) for e in ground["energies"]]
    sector = ground.get("sector")
    if sector is not None:
        bond = int(sector["bond_dim"])
        if "phys_list" in sector:
            from .models.u1_vumps_cell import u1_cell_sector

            out["sector"] = u1_cell_sector(
                [list(p) for p in sector["phys_list"]], bond,
                charges=[np.asarray(q) for q in sector["charges"]],
                device=device)
        else:
            from .models.u1_vumps import u1_uniform_sector

            out["sector"] = u1_uniform_sector(
                list(sector["phys_charges"]), bond,
                charges=np.asarray(sector["charges"]), device=device)
    return out


def ground_to_numpy(ground):
    """The tensors of a VUMPS ground dict (single-site or cell) as host numpy
    arrays, with ``energy`` as a float."""
    out = {"energy": float(ground["energy"])}
    for key in _GROUND_TENSORS:
        if key in ground:
            out[key] = _host((ground[key],))[0]
    for key in _CELL_TENSORS:
        if key in ground:
            out[key] = _host(ground[key])
    return out


def state_from_numpy(tree, device=None):
    """A state of nested dicts, lists and tuples with every array leaf (numpy
    or any array ``numpy.asarray`` reads, e.g. the JAX package's) as this
    package's tensor on ``device``; other leaves (floats, ints, strings) are
    kept as they are."""
    device = resolve_device(device)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return as_tensor(np.asarray(x), device)
        return x

    return put(tree)


def state_to_numpy(tree):
    """The inverse of :func:`state_from_numpy`: every tensor leaf of a
    nested dict/list/tuple state as a host numpy array."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _host((tree,))[0]
    return tree
