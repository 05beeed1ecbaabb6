"""Uniform-shape DMRG, batched over Hamiltonian ensembles.

Counterpart of ``contractn_tpu/models/ensemble.py``.  The ragged
:func:`~.dmrg.dmrg` sweep has site-dependent bond shapes; this module
rebuilds the two-site sweep with STATIC uniform shapes: every bond is padded
to the same ``D`` (zero rows/columns at the chain edges, the stacked
``(N, d, D, D)`` convention), and every local problem is solved by the
device-side Lanczos of :mod:`..ops.krylov` with a fixed iteration count.

The JAX package compiles the whole search into one ``lax.fori_loop``
program and ``vmap``s it over Hamiltonians.  Here the sweep is a Python
loop over sites whose every op carries the ensemble as a leading batch
axis: ``K`` Hamiltonians share each launch (batched einsums for the
matvecs and environments, one batched SVD of the ``K`` two-site blocks).
The ``K`` Lanczos tridiagonals of a local step are read to the host once
and solved there, the one host read of a step (``torch.linalg.eigh`` and
``svd`` synchronize with the host on the card anyway, and a host ``eigh`` of
``K`` small matrices is cheaper than cuSOLVER's).

Correctness of the padding: environments are built from the padded site
tensors, so padded directions carry exact zeros through every environment
update; the effective Hamiltonian annihilates the padded subspace, SVD
splits of a block supported on the physical subspace keep zero support on
the padding, and the Lanczos iterate never leaves the physical subspace.
"""

import dataclasses

import torch

from ..ops.krylov import lanczos_ground
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, real_dtype
from .dmrg import _heff_matvec, _split_theta, _update_left, _update_right
from .mps import MPS


def _pad_boundary_sites(mps):
    """Absorb the boundary vectors; keep the uniform ``(..., N, d, D, D)``
    shape.  Site 0 becomes ``l . A_0`` in bond row 0 (other rows zero), site
    N-1 becomes ``A_{N-1} . r`` in bond column 0; the stack contracts against
    unit boundary vectors ``e_0``."""
    cores = mps.cores
    left = as_tensor(mps.left, cores.device).to(cores.dtype)
    right = as_tensor(mps.right, cores.device).to(cores.dtype)
    first = peinsum("...i,...dij->...dj", left, cores[..., 0, :, :, :])
    last = peinsum("...dij,...j->...di", cores[..., -1, :, :, :], right)
    sites = cores.clone()
    sites[..., 0, :, :, :] = 0
    sites[..., 0, :, 0, :] = first
    sites[..., -1, :, :, :] = 0
    sites[..., -1, :, :, 0] = last
    return sites


def _boundary_env(vec, bond_dim, dtype):
    """``(..., D, W, D)`` environment holding ``vec`` at bond index
    ``(0, :, 0)``."""
    env = torch.zeros(tuple(vec.shape[:-1]) + (bond_dim, vec.shape[-1], bond_dim),
                      dtype=dtype, device=vec.device)
    env[..., 0, :, 0] = vec.to(dtype)
    return env


def _dmrg_uniform_core(mpo, mps0, sweeps, iters, solver=None, masks=None,
                       splitter=None, env_ops=None, batch_ndim=0):
    """The whole optimization over uniform shapes.

    ``batch_ndim`` leading axes of every MPO and MPS field are an ensemble
    of independent problems.  Hooks as in the JAX package:

    * ``solver(L, w1, w2, R, theta0) -> (energy, theta)`` overrides the local
      two-site ground-state solve;
    * ``masks (..., N, d, D, D)`` (0/1) constrains every site tensor to a
      block structure, with ``splitter(theta, i, to_left)`` replacing the
      two-site SVD split (a plain SVD orders the middle bond by singular
      value, not by the layout the masks encode);
    * ``env_ops = (boundary, update_left, update_right)`` overrides the
      environment construction and absorption.
    """
    sites = _pad_boundary_sites(mps0)
    if masks is not None:
        sites = sites * masks.to(sites.dtype)
    n, _, bond = sites.shape[batch_ndim:batch_ndim + 3]
    dt = torch.promote_types(sites.dtype, mpo.cores.dtype)
    sites = sites.to(dt)
    ws = mpo.cores.to(dt)
    device = sites.device

    def site(t, i):
        return t[(Ellipsis, i) + (slice(None),) * 3]

    def op(i):
        return ws[(Ellipsis, i) + (slice(None),) * 4]

    env_boundary, env_up_l, env_up_r = env_ops or (
        _boundary_env, _update_left, _update_right)
    envs_l = [None] * (n + 1)
    envs_r = [None] * (n + 1)
    envs_l[0] = env_boundary(as_tensor(mpo.left, device), bond, dt)
    envs_r[n] = env_boundary(as_tensor(mpo.right, device), bond, dt)
    for i in range(n - 1, 0, -1):  # R[i] absorbs sites i..n-1
        envs_r[i] = env_up_r(envs_r[i + 1], site(sites, i), op(i))
    sites = [site(sites, i) for i in range(n)]

    if solver is None:
        def solver(L, w1, w2, R, theta0):
            return lanczos_ground(lambda t: _heff_matvec(L, w1, w2, R, t),
                                  theta0, iters, batch_ndim=batch_ndim)

    if splitter is None:
        def splitter(theta, i, to_left):
            return _split_theta(theta, bond, to_left)

    def update(i, to_left):
        theta0 = peinsum("...apj,...bjq->...abpq", sites[i], sites[i + 1])
        energy, theta = solver(envs_l[i], op(i), op(i + 1), envs_r[i + 2],
                               theta0)
        t1, t2 = splitter(theta, i, to_left)
        if masks is not None:
            t1 = t1 * site(masks, i).to(t1.dtype)
            t2 = t2 * site(masks, i + 1).to(t2.dtype)
        sites[i], sites[i + 1] = t1, t2
        return energy

    energies = []
    for _ in range(sweeps):
        for i in range(n - 1):
            energy = update(i, True)
            envs_l[i + 1] = env_up_l(envs_l[i], sites[i], op(i))
        for i in range(n - 2, -1, -1):
            energy = update(i, False)
            envs_r[i + 1] = env_up_r(envs_r[i + 2], sites[i + 1], op(i + 1))
        energies.append(torch.as_tensor(energy, dtype=real_dtype(dt), device=device))

    sites = torch.stack(sites, dim=batch_ndim)
    e0 = torch.zeros(tuple(sites.shape[:batch_ndim]) + (bond,), dtype=dt,
                     device=device)
    e0[..., 0] = 1.0
    energies = torch.stack(energies, dim=-1)
    return MPS(sites, e0, e0.clone()), energies[..., -1], energies


def dmrg_uniform(mpo, mps0, sweeps=4, lanczos_iters=40):
    """Two-site DMRG with static uniform shapes.

    Same variational optimization as :func:`~.dmrg.dmrg` with
    ``max_bond = mps0.bond_dim``, but every local solve uses the fixed-length
    Lanczos (no dense-eigh small-problem path).

    Args:
        mpo: Hermitian Hamiltonian as an :class:`MPO` (uniform ``W``).
        mps0: initial state; its bond dimension is the optimization bond.
        sweeps: full left-right + right-left sweeps.
        lanczos_iters: Krylov depth per local solve (above the ragged path's
            24: the small edge blocks are solved by Lanczos too).

    Returns:
        ``(ground_mps, energy, energies)`` — device tensors; ``energies`` is
        the per-sweep trace, shape ``(sweeps,)``.
    """
    if mps0.n_sites < 2:
        raise ValueError("dmrg_uniform needs at least 2 sites")
    return _dmrg_uniform_core(mpo, mps0, int(sweeps), int(lanczos_iters))


def dmrg_ensemble(mpos, mps0s, sweeps=4, lanczos_iters=40):
    """Batched ground-state search over a Hamiltonian ensemble.

    ``mpos`` / ``mps0s`` are an :class:`MPO` / :class:`MPS` whose fields
    carry a leading ensemble axis ``K`` (build them with
    :func:`stack_pytrees`).  The ``K`` optimizations — e.g. a transverse-field
    scan ``[tfim_mpo(n, h=h) for h in hs]`` — run as one batched sweep: every
    launch serves all members.

    Returns ``(ground_mpss, energies, traces)`` with leading axis ``K``.
    """
    if mps0s.cores.shape[1] < 2:
        raise ValueError("dmrg_ensemble needs at least 2 sites")
    return _dmrg_uniform_core(mpos, mps0s, int(sweeps), int(lanczos_iters),
                              batch_ndim=1)


def stack_pytrees(items):
    """Stack a list of identically-shaped objects along a new leading axis.

    ``stack_pytrees([tfim_mpo(8, h=h) for h in hs])`` builds the ensemble
    :class:`MPO` for :func:`dmrg_ensemble`; works for :class:`MPS` lists,
    tensors, and tuples and lists of them the same way.
    """
    if not items:
        raise ValueError("stack_pytrees needs a non-empty list")
    first = items[0]
    if dataclasses.is_dataclass(first):
        return type(first)(*(
            stack_pytrees([getattr(it, f.name) for it in items])
            for f in dataclasses.fields(first)))
    if isinstance(first, (tuple, list)):
        return type(first)(stack_pytrees(list(xs)) for xs in zip(*items))
    return torch.stack([torch.as_tensor(it) for it in items])
