"""Device meshes over ``torch.distributed``.

Counterpart of ``contractn_tpu/parallel/mesh.py``.  The JAX package runs one
controller that lays named axes over its devices; here every rank of a
process group runs the same program (SPMD) and a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` whose ``mesh_dim_names``
are the JAX axis names.  A per-shard body that the JAX package writes
against an axis *name* takes the ``ProcessGroup`` of that mesh dimension
(``mesh.get_group(name)``): the axis size is the group's size and the axis
index the rank within it (:func:`axis_size`, :func:`axis_index`).

The caller initializes the default process group (``torchrun``, or
``torch.distributed.init_process_group``): NCCL for meshes on the GPUs,
gloo for meshes of CPU processes.  Nothing here initializes a group or
falls back to another backend or device.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.errors import TNError


def make_mesh(axis_sizes, devices=None, device="cuda"):
    """Build a :class:`DeviceMesh` from ``{"axis": size}`` specs.

    Args:
        axis_sizes: ordered mapping of axis name to size, e.g.
            ``{"dp": 4, "sp": 2}``.  The product must equal the device count.
        devices: optional list of global ranks (default: every rank of the
            default group), the counterpart of ``jax.devices()[:k]``.  Every
            rank of the default group must call this, members or not (the
            mesh's sub-groups are created collectively).
        device: ``"cuda"`` (the default; one GPU a rank) or ``"cpu"``.

    Returns:
        A mesh with the requested named axes.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise TNError(
            "make_mesh needs an initialized default process group: launch "
            "with torchrun or call torch.distributed.init_process_group first"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise TNError(
            "No CUDA device is available. Pass device='cpu' (over a gloo "
            "process group) to build a mesh of CPU processes."
        )
    if devices is None:
        devices = list(range(dist.get_world_size()))
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(
            f"Mesh axes {dict(axis_sizes)} need {total} devices, "
            f"got {len(devices)}"
        )
    grid = torch.tensor([int(r) for r in devices], dtype=torch.int64).reshape(sizes)
    return DeviceMesh(device.type, grid, mesh_dim_names=names)


def mesh_shape(mesh):
    """``{axis name: size}``, the counterpart of JAX's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_group(mesh, name):
    """The process group of one mesh axis, or ``None`` where the mesh has no
    such axis (every collective over ``None`` is the identity)."""
    if name is None or name not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(name)


def axis_size(group):
    """``jax.lax.axis_size``: the number of ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group):
    """``jax.lax.axis_index``: this rank's index in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def shard(t, group, dim):
    """This rank's block of ``t`` along ``dim`` (``in_specs``): the axis of
    ``t`` is split into ``axis_size(group)`` equal contiguous blocks."""
    n = axis_size(group)
    if n == 1:
        return t
    chunk = t.shape[dim] // n
    return t.narrow(dim, axis_index(group) * chunk, chunk)
