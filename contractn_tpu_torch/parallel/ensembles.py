"""Mesh-sharded model-layer ensembles.

Counterpart of ``contractn_tpu/parallel/ensembles.py``, for the two
embarrassingly parallel ensemble workloads:

* :func:`dmrg_ensemble_sharded` -- the batched uniform-shape DMRG of
  :func:`~contractn_tpu_torch.models.ensemble.dmrg_ensemble` with the
  ensemble axis laid over a mesh axis: on ``n`` ranks each runs ``K/n``
  ground-state searches with no collective until the final gather;
* :func:`ipeps_cell_scan_sharded` -- the 2D checkerboard phase scan of
  :func:`~contractn_tpu_torch.models.ipeps_cell.ipeps_cell_scan`, same layout.

Both call the same per-member cores the single-device paths batch
(``_dmrg_uniform_core`` with ``batch_ndim=1``, the port's form of the JAX
``vmap``, and ``_scan_core``).  Per-member results match the unsharded
ensemble at machine precision, not bitwise: batched kernels reduce in a
different order at local batch ``K/n``.
"""

import dataclasses

import torch

from ..models.ensemble import _dmrg_uniform_core
from ..models.ipeps_cell import _scan_core
from ..utils.device import as_tensor, resolve_device, torch_dtype
from ._collectives import all_gather
from .mesh import axis_group, mesh_shape, shard


def _check_batch(batch, mesh, axis, what):
    n_dev = mesh_shape(mesh)[axis]
    if batch % n_dev:
        raise ValueError(
            f"{what}={batch} must divide by the '{axis}' mesh axis "
            f"(size {n_dev})"
        )


def _map_fields(fn, obj):
    """``fn`` on every tensor field of an MPS/MPO (dataclass), or a tensor."""
    if dataclasses.is_dataclass(obj):
        return type(obj)(*(fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)))
    return fn(obj)


def dmrg_ensemble_sharded(mesh, mpos, mps0s, sweeps=4, lanczos_iters=40, axis="dp"):
    """:func:`~contractn_tpu_torch.models.ensemble.dmrg_ensemble` over a mesh.

    ``mpos`` / ``mps0s`` carry a leading ensemble axis ``K`` (build with
    :func:`~contractn_tpu_torch.models.ensemble.stack_pytrees`); ``K`` shards
    over mesh axis ``axis``.  Every rank passes the whole ensemble and
    returns the whole ``(ground_mpss, energies, traces)``, leading axis ``K``.
    """
    n_sites = mps0s.cores.shape[1]
    if n_sites < 2:
        raise ValueError("dmrg_ensemble_sharded needs at least 2 sites")
    _check_batch(mps0s.cores.shape[0], mesh, axis, "ensemble size K")
    group = axis_group(mesh, axis)
    local = [_map_fields(lambda t: shard(t, group, 0), obj) for obj in (mpos, mps0s)]
    mps, energies, traces = _dmrg_uniform_core(*local, int(sweeps), int(lanczos_iters),
                                               batch_ndim=1)

    def gather(t):
        return all_gather(t, group, tiled=True)

    return _map_fields(gather, mps), gather(energies), gather(traces)


def ipeps_cell_scan_sharded(mesh, h2_batch, bond_dim, chi, d=2,
                            schedule=((0.1, 150), (0.02, 150), (0.005, 80)),
                            iters=120, ops=(), dtype=torch.float64, init=None,
                            axis="dp"):
    """:func:`~contractn_tpu_torch.models.ipeps_cell.ipeps_cell_scan` over a
    mesh: the ``(B,)`` family of bond terms shards over ``axis``; gates,
    simple update, CTMRG environments and energies run on each rank's
    members with the per-member program of the unbatched path.

    ``h2_batch`` as a torch tensor keeps its device; numpy goes to the
    mesh's device type.  Returns the same dict (``a, b, energy, moments``),
    leading axis ``B``, on every rank.
    """
    dtype = torch_dtype(dtype)
    device = (h2_batch.device if isinstance(h2_batch, torch.Tensor)
              else resolve_device(mesh.device_type))
    h2_batch = as_tensor(h2_batch, device, dtype)
    _check_batch(h2_batch.shape[0], mesh, axis, "family size B")
    ops_arr = (torch.stack([as_tensor(o, device, dtype) for o in ops]) if ops
               else torch.zeros((0, d, d), dtype=dtype, device=device))
    if init is not None:
        init = tuple(as_tensor(t, device, dtype) for t in init)
    group = axis_group(mesh, axis)
    out = _scan_core(shard(h2_batch, group, 0), ops_arr, init, int(bond_dim), int(chi),
                     int(d), tuple((float(t), int(n)) for t, n in schedule), int(iters))
    a, b, energy, moments = (all_gather(t, group, tiled=True) for t in out)
    return {"a": a, "b": b, "energy": energy, "moments": moments}
