"""Tensor decomposition algorithms: CP-ALS and Tucker HOSVD/HOOI.

Counterpart of ``contractn_tpu/models/factorize.py``.  The graph builders
(:mod:`.decompositions`) lay CP and Tucker networks out; this module
computes a decomposition of a given dense tensor:

* :func:`cp_als` — alternating least squares for the canonical polyadic
  (PARAFAC) format.  Each mode update is one MTTKRP (a chain of batched
  GEMMs over the rank axis) plus an ``(R, R)`` solve; the sweep loop runs on
  the tensor's device and keeps each sweep's relative error there (one host
  read at the end).  The fit is computed from the factor Grams, never from a
  dense reconstruction.
* :func:`tucker_hosvd` — higher-order SVD: per-mode top singular subspaces
  of the unfoldings (through the ``(d, d)`` Gram eigendecomposition).
* :func:`tucker_hooi` — higher-order orthogonal iteration, refining HOSVD
  by alternating eigendecompositions of the PROJECTED tensor.

CP factors are ``(rank, dim_i)`` rows as :func:`~.decompositions.cp_tn`
expects, Tucker factors ``(r_i, dim_i)`` as
:func:`~.decompositions.tucker_tn` expects.

Departure: :func:`cp_als` draws its random start from ``generator=`` (a
``torch.Generator`` on the tensor's device) where the JAX package takes a
key.
"""

import torch

from ..ops.linalg_ad import dense_eigh
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device, real_dtype

_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _tensor(tensor):
    return as_tensor(tensor, resolve_device(None, (tensor,)))


def _mttkrp(x, factors, mode):
    """``G[r, i_mode] = sum_{other modes} X * prod_{j != mode} A_j[r,
    i_j]`` — contracted one factor at a time (never a materialized
    Khatri-Rao product)."""
    axes = _LETTERS[:x.ndim]
    out = None
    for j in range(x.ndim):
        if j == mode:
            continue
        lj = _LETTERS[j]
        if out is None:
            out = peinsum(f"{axes},r{lj}->r" + axes.replace(lj, ""), x,
                          factors[j])
            axes = "r" + axes.replace(lj, "")
        else:
            out = peinsum(f"{axes},r{lj}->" + axes.replace(lj, ""), out,
                          factors[j])
            axes = axes.replace(lj, "")
    return out  # (rank, dim_mode)


def _gram(factors, skip=None):
    rank = factors[0].shape[0]
    gram = torch.ones((rank, rank), dtype=factors[0].dtype,
                      device=factors[0].device)
    for j, a in enumerate(factors):
        if j != skip:
            gram = gram * peinsum("ri,si->rs", a.conj(), a)
    return gram


def _cp_als(x, factors, rank, steps, ridge):
    k = x.ndim
    x_norm2 = torch.real(torch.vdot(x.reshape(-1), x.reshape(-1)))
    eye_r = torch.eye(rank, dtype=x.dtype, device=x.device)
    factors = list(factors)
    rel_errs = []
    for _ in range(int(steps)):
        inner = torch.zeros((), dtype=x.dtype, device=x.device)
        for m in range(k):
            # Complex normal equations: M[r,s] = prod_{j != m}
            # <row_r(A_j), row_s(A_j)>, b = conj-MTTKRP; M A_m = b.
            g = _mttkrp(x, [f.conj() for f in factors], m)
            sol = torch.linalg.solve(_gram(factors, skip=m) + ridge * eye_r, g)
            norms = torch.sqrt((sol.abs() ** 2).sum(dim=1))
            scale = torch.where(norms > 0, norms, torch.ones_like(norms))
            # The full scale stays on the LAST-updated mode so the factor
            # list alone reconstructs the tensor.
            factors[m] = sol if m == k - 1 else sol / scale[:, None].to(sol.dtype)
            if m == k - 1:
                inner = (sol.conj() * g).sum()
        # ||X_hat||^2 from the Grams alone (no reconstruction)
        model_norm2 = torch.real(_gram(factors).sum())
        err2 = torch.clamp(x_norm2 - 2.0 * torch.real(inner) + model_norm2,
                           min=0.0)
        rel_errs.append(torch.sqrt(err2 / x_norm2))
    return factors, torch.stack(rel_errs)


def cp_als(tensor, rank, steps=100, generator=None, ridge=1e-12):
    """Canonical polyadic decomposition by alternating least squares.

    Args:
        tensor: dense tensor (any order >= 2, real or complex); a numpy
            array goes to ``cuda``.
        rank: CP rank of the fit.
        steps: number of full ALS sweeps.
        generator: ``torch.Generator`` on the tensor's device for the random
            start (default: a fresh one seeded with 0).
        ridge: Tikhonov floor on the ``(R, R)`` normal equations.

    Returns ``(factors, rel_errs)``: ``factors[i]`` is ``(rank, dim_i)``
    (the scale lives on the last mode), ``rel_errs`` the per-sweep relative
    Frobenius error ``||X - X_hat|| / ||X||`` (a 1-d tensor), non-increasing
    by the ALS property.
    """
    x = _tensor(tensor)
    if not 2 <= x.ndim <= 16:
        raise ValueError("cp_als supports tensor orders 2..16")
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    scale = float((x.abs() ** 2).mean()) ** (0.5 / x.ndim)
    init = [scale * torch.randn((int(rank), d), dtype=x.dtype, device=x.device,
                                generator=generator)
            for d in x.shape]
    return _cp_als(x, init, int(rank), int(steps), ridge)


def cp_reconstruct(factors):
    """Dense tensor from CP factors ``(rank, dim_i)``."""
    k = len(factors)
    spec = ",".join(f"r{_LETTERS[i]}" for i in range(k))
    return peinsum(f"{spec}->{_LETTERS[:k]}", *factors)


def _top_left_vectors(unf, r):
    """Top-``r`` left singular vectors of ``unf`` via the Gram matrix (the
    unfolding is short-and-fat for every mode)."""
    gram = peinsum("ij,kj->ik", unf, unf.conj())
    vals, vecs = dense_eigh(gram)  # ascending
    return vecs.flip(1)[:, :r], vals.flip(0)


def _project(x, factors, skip=None):
    """``x`` with every mode except ``skip`` contracted against its
    factor's conjugate rows."""
    k = x.ndim
    axes = _LETTERS[:k]
    for j, f in enumerate(factors):
        if j != skip:
            x = peinsum(f"{axes},z{axes[j]}->" + axes.replace(axes[j], "z"),
                        x, f.conj())
    return x


def _unfold(x, m):
    return torch.movedim(x, m, 0).reshape(x.shape[m], -1)


def tucker_hosvd(tensor, ranks):
    """Higher-order SVD (quasi-optimal Tucker decomposition).

    Returns ``(core, factors, discarded)``: ``core`` is ``(r_1, ...,
    r_k)``, ``factors[i]`` is ``(r_i, dim_i)`` with orthonormal rows, and
    ``discarded`` the total discarded squared singular value mass (a host
    float) — an upper bound on the squared reconstruction error.
    """
    x = _tensor(tensor)
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != x.ndim:
        raise ValueError("one rank per mode required")
    if x.ndim > 16:
        raise ValueError("tucker_hosvd supports tensor orders <= 16")
    factors = []
    discarded = torch.zeros((), dtype=real_dtype(x.dtype), device=x.device)
    for m, r in enumerate(ranks):
        u, vals = _top_left_vectors(_unfold(x, m), r)
        factors.append(u.T)  # (r, dim)
        discarded = discarded + torch.clamp(torch.real(vals[r:]), min=0.0).sum()
    return _project(x, factors), factors, float(discarded)


def _hooi(x, factors, ranks, steps):
    x_norm2 = torch.real(torch.vdot(x.reshape(-1), x.reshape(-1)))
    factors = list(factors)
    rel_errs = []
    core = None
    for _ in range(int(steps)):
        for m in range(x.ndim):
            u, _ = _top_left_vectors(_unfold(_project(x, factors, skip=m), m),
                                     ranks[m])
            factors[m] = u.T
        core = _project(x, factors)
        # orthonormal factors => ||X - X_hat||^2 = ||X||^2 - ||core||^2
        c = core.reshape(-1)
        err2 = torch.clamp(x_norm2 - torch.real(torch.vdot(c, c)), min=0.0)
        rel_errs.append(torch.sqrt(err2 / x_norm2))
    return factors, core, torch.stack(rel_errs)


def tucker_hooi(tensor, ranks, steps=10):
    """Higher-order orthogonal iteration: HOSVD-initialized alternating
    refinement of the Tucker subspaces (monotonically non-increasing
    error).

    Returns ``(core, factors, rel_errs)`` in the conventions of
    :func:`tucker_hosvd`, ``rel_errs`` a 1-d tensor of per-sweep relative
    errors.
    """
    x = _tensor(tensor)
    ranks = tuple(int(r) for r in ranks)
    _, init, _ = tucker_hosvd(x, ranks)
    factors, core, rel_errs = _hooi(x, init, ranks, int(steps))
    return core, factors, rel_errs


def tucker_reconstruct(core, factors):
    """Dense tensor from a Tucker ``(core, factors)`` pair."""
    k = core.ndim
    out = core
    for m, f in enumerate(factors):
        axes = _LETTERS[:k]
        out = peinsum(f"{axes},{axes[m]}z->" + axes.replace(axes[m], "z"),
                      out, f)
    return out
