"""Shared Lanczos and Arnoldi machinery.

Counterpart of ``contractn_tpu/ops/krylov.py``: one implementation of the
subtle parts — double Gram-Schmidt reorthogonalization, branchless
Krylov-exhaustion masking and the well-conditioned tridiagonal assembly —
consumed by the DMRG ground and penalized solvers and the TDVP Krylov
exponentials.

The JAX package runs each factorization as one ``lax.fori_loop``; here it is
a Python loop of a FIXED ``iters`` steps over device tensors.  Exhaustion is
masked with ``torch.where`` and never read on the host, so the loop issues
no host sync and gives the JAX package's results (breaking out early would
read ``beta`` every step and change them).

Every function takes ``batch_ndim``: that many leading axes of ``v0`` are a
batch of independent problems (``matvec`` maps the batched tensor to the
batched tensor), with per-member norms, exhaustion masks and tridiagonals —
the batched form :mod:`..models.ensemble` runs its Hamiltonian ensembles
through.

``axis_name`` takes the ``ProcessGroup`` of a mesh axis (see
:mod:`..parallel.mesh`): ``v0`` is then this rank's slice of the global
vector, ``matvec`` maps local slice to local slice, and every norm and
overlap is a local partial dot completed by an all-reduce over the group, as
the JAX package's ``_maybe_psum`` does.  The tridiagonal is then the global
one on every rank while the basis rows stay sharded.

:func:`gmres` stands in for ``jax.scipy.sparse.linalg.gmres`` (torch has
none), the solver the JAX package's infinite-chain environments call; it
follows jax 0.9.0's ``solve_method="batched"`` step for step and takes the
same ``batch_ndim`` knob.
"""

import numpy as np
import torch

from ..utils.device import real_dtype
from .stabilize import peinsum


def _psum(x, axis_name):
    """Sum a locally reduced value over the ranks of ``axis_name`` (no-op
    for ``None``): the one place a sharded Krylov vector communicates."""
    if axis_name is None:
        return x
    from ..parallel._collectives import psum

    return psum(x, axis_name)


def _norm(x, axis_name=None):
    """2-norm over the last axis (of the global vector with ``axis_name``)."""
    return torch.sqrt(_psum(torch.real(peinsum("...d,...d->...", x.conj(), x)),
                            axis_name))


def _orthogonalize(basis, w, axis_name=None):
    """Two Gram-Schmidt passes of ``w`` against every row of ``basis``
    ("twice is enough", Parlett: one pass leaves an ``eps ||w|| / beta``
    rogue component near exhaustion).  Rows not yet filled are zero, so
    masking is implicit.  Returns ``(w, summed coefficients)``."""
    coeffs = 0
    for _ in range(2):
        proj = _psum(peinsum("...kd,...d->...k", basis.conj(), w), axis_name)
        w = w - peinsum("...k,...kd->...d", proj, basis)
        coeffs = coeffs + proj
    return w, coeffs


def lanczos_basis(matvec, v0, iters, axis_name=None, project=None,
                  batch_ndim=0):
    """Lanczos factorization: returns ``(basis, alphas, betas, nrm0)``.

    ``basis (*batch, iters + 1, dim)`` rows are the Krylov vectors (zero rows
    after exhaustion), ``alphas`` carry 1e30 markers on exhausted steps (feed
    them to :func:`masked_tridiagonal`, never to ``eigh`` directly), and
    ``nrm0`` is ``|v0|`` (the basis starts from ``v0 / nrm0``).

    ``project`` restricts the iteration to an invariant subspace: it is
    applied to ``v0`` and to every new Krylov vector AFTER
    reorthogonalization.  Ending the matvec with a dense projector is not
    enough: each application leaves an ``eps``-relative out-of-subspace
    residual that Gram-Schmidt re-injects, growing geometrically.
    """
    batch = tuple(v0.shape[:batch_ndim])
    shape = tuple(v0.shape[batch_ndim:])
    dt = v0.dtype
    rdt = real_dtype(dt)
    if project is not None:
        v0 = project(v0)
    flat = v0.reshape(batch + (-1,))
    dim = flat.shape[-1]
    nrm0 = torch.clamp(_norm(flat, axis_name), min=1e-300)
    basis = torch.zeros(batch + (iters + 1, dim), dtype=dt, device=v0.device)
    basis[..., 0, :] = flat / nrm0[..., None]
    alphas = torch.full(batch + (iters,), float("inf"), dtype=rdt,
                        device=v0.device)
    betas = torch.zeros(batch + (iters,), dtype=rdt, device=v0.device)
    exhausted = torch.zeros(batch, dtype=torch.bool, device=v0.device)
    marker = torch.tensor(1e30, dtype=rdt, device=v0.device)
    for j in range(iters):
        v = basis[..., j, :]
        hv = matvec(v.reshape(batch + shape)).reshape(batch + (dim,))
        alpha = _psum(torch.real(peinsum("...d,...d->...", v.conj(), hv)), axis_name)
        hv, _ = _orthogonalize(basis, hv, axis_name)
        if project is not None:
            hv = project(hv.reshape(batch + shape)).reshape(batch + (dim,))
        beta = _norm(hv, axis_name)
        alive = ~exhausted & (beta > 1e-12)
        basis[..., j + 1, :] = torch.where(
            alive[..., None], hv / torch.clamp(beta, min=1e-300)[..., None],
            torch.zeros_like(hv))
        alphas[..., j] = torch.where(exhausted, marker, alpha)
        betas[..., j] = torch.where(alive, beta, torch.zeros_like(beta))
        exhausted = ~alive
    return basis, alphas, betas, nrm0


def masked_tridiagonal(alphas, betas):
    """Lanczos tridiagonal with exhausted steps pushed out of the way.

    Exhausted steps carry a 1e30 diagonal marker; fed to ``eigh`` directly it
    would destroy the valid eigenvalues (absolute error ``||T|| eps``).  The
    marker is remapped to a value that dominates the valid spectrum by ~1e4
    but keeps the matrix well-conditioned; the masked block's eigenvectors
    have exactly zero overlap with ``e1`` (its couplings are zero).  Leading
    axes of ``alphas``/``betas`` are batch axes.
    """
    valid = alphas < 1e29
    scale = torch.where(valid, alphas.abs(), torch.zeros_like(alphas)).amax(-1)
    scale = torch.maximum(scale, betas.abs().amax(-1))
    big = 1e4 * (1.0 + scale)
    diag = torch.where(valid, alphas, big[..., None])
    off = betas[..., :-1]
    return (torch.diag_embed(diag) + torch.diag_embed(off, 1)
            + torch.diag_embed(off, -1))


def tridiagonal_eigh(alphas, betas):
    """``eigh`` of :func:`masked_tridiagonal`, on the host: ``(vals, vecs)``
    as float64 numpy arrays (leading batch axes kept).

    The ``(iters,)`` coefficients are read to the host once and solved in
    numpy (no slower than cuSOLVER for one small matrix, faster for a batch,
    and ``torch.linalg.eigh`` would synchronize with the host anyway).  The
    read also yields the energy, so a local solve reads the host once.
    """
    tri = masked_tridiagonal(alphas, betas)
    return np.linalg.eigh(tri.detach().cpu().double().numpy())


def lanczos_ground(matvec, v0, iters, axis_name=None, project=None,
                   batch_ndim=0):
    """Lowest eigenpair of a Hermitian operator via :func:`lanczos_basis`.

    Returns ``(energy, vector)``: the energy as a float (a float64 numpy
    array for a batch; the one host read of the solve) and the vector
    normalized per batch member.  ``project`` confines the iteration to an
    invariant subspace (see :func:`lanczos_basis`).  With ``axis_name``,
    ``v0``, ``matvec`` and the vector are this rank's slice (see
    :func:`lanczos_basis`); the small eigenproblem runs on every rank.
    """
    basis, alphas, betas, _ = lanczos_basis(matvec, v0, iters, axis_name,
                                            project=project,
                                            batch_ndim=batch_ndim)
    vals, vecs = tridiagonal_eigh(alphas, betas)
    coeff = torch.from_numpy(vecs[..., :, 0]).to(v0.device, v0.dtype)
    vec = peinsum("...k,...kd->...d", coeff, basis[..., :-1, :])
    vec = vec / torch.clamp(_norm(vec, axis_name), min=1e-300)[..., None]
    energy = vals[..., 0]
    return (float(energy) if batch_ndim == 0 else energy), vec.reshape(v0.shape)


def arnoldi_basis(matvec, v0, iters, axis_name=None):
    """Arnoldi factorization of a NONSYMMETRIC operator.

    Returns ``(basis, h, nrm0)`` with ``basis (iters + 1, dim)`` orthonormal
    Krylov rows and ``h (iters + 1, iters)`` the upper-Hessenberg projection,
    ``A V_m = V_{m+1} H``.  Breakdown (an exact invariant subspace) zeroes
    the subdiagonal entry and all later rows and columns; detect it on the
    host via ``h[j + 1, j] == 0``.  Reorthogonalizes twice, like
    :func:`lanczos_basis`, with no host sync in the loop; ``axis_name``
    shards the vectors as there.
    """
    shape = v0.shape
    dt = v0.dtype
    flat = v0.reshape(-1)
    dim = flat.shape[0]
    nrm0 = torch.clamp(_norm(flat, axis_name), min=1e-300)
    basis = torch.zeros((iters + 1, dim), dtype=dt, device=v0.device)
    basis[0] = flat / nrm0
    h = torch.zeros((iters + 1, iters), dtype=dt, device=v0.device)
    exhausted = torch.zeros((), dtype=torch.bool, device=v0.device)
    for j in range(iters):
        w = matvec(basis[j].reshape(shape)).reshape(-1)
        w, coeffs = _orthogonalize(basis, w, axis_name)
        beta = _norm(w, axis_name)
        alive = ~exhausted & (beta > 1e-12)
        h[:, j] = torch.where(exhausted, torch.zeros_like(coeffs), coeffs)
        h[j + 1, j] = torch.where(alive, beta.to(dt), torch.zeros_like(h[j + 1, j]))
        basis[j + 1] = torch.where(
            alive, w / torch.clamp(beta, min=1e-300), torch.zeros_like(w))
        exhausted = ~alive
    return basis, h, nrm0


def arnoldi_eigs(matvec, v0, iters, k=2):
    """Leading ``k`` eigenvalues (by magnitude) of a nonsymmetric operator,
    plus the Ritz vector of the dominant one.

    The ``iters`` matvecs and Gram-Schmidt sweeps run on the operator's
    device; only the ``(iters, iters)`` Hessenberg eigenproblem runs on the
    host (numpy), so the host work is independent of the operator's size.

    Returns ``(vals, lead_vec)``: ``vals (k,)`` complex numpy, sorted by
    descending magnitude (conjugate pairs +Im first; zero-padded past a
    breakdown); ``lead_vec`` a numpy array of ``v0``'s shape.
    """
    basis, h, _ = arnoldi_basis(matvec, v0, iters)
    h_np = h.cpu().numpy()
    basis_np = basis.cpu().numpy()
    m = iters
    dead = np.nonzero(np.abs(np.diagonal(h_np[1:, :])) == 0.0)[0]
    if dead.size:
        m = int(dead[0]) + 1  # exact invariant subspace of size m
    vals, vecs = np.linalg.eig(h_np[:m, :m])
    order = np.lexsort((-vals.imag, -np.abs(vals)))
    vals = vals[order]
    lead = np.matmul(basis_np[:m].T, vecs[:, order[0]]).reshape(tuple(v0.shape))
    out = np.zeros((k,), complex)
    out[: min(k, m)] = vals[:k]
    return out, lead


def _safe_normalize(x, thresh):
    """``(x / |x|, |x|)`` per member, or zeros where ``|x| <= thresh``
    (jax's ``_safe_normalize``)."""
    nrm = _norm(x)
    use = nrm > thresh
    unit = torch.where(use[..., None], x / torch.where(use, nrm, 1.0)[..., None]
                       .to(x.dtype), torch.zeros_like(x))
    return unit, torch.where(use, nrm, torch.zeros_like(nrm))


def _gmres_cycle(apply, b, x, unit, rnorm, restart):
    """One restart cycle of jax 0.9.0's ``_gmres_batched`` for every member:
    ``restart`` Arnoldi steps (one classical Gram-Schmidt pass, as jax's
    ``_iterative_classical_gram_schmidt`` runs with ``max_iterations=2``:
    its loop condition stops it after the first pass), each member frozen
    from its breakdown on; then the small least-squares problem through its
    normal equations, solved by Cholesky as jax's ``_lstsq`` does."""
    batch, n = x.shape[:-1], x.shape[-1]
    dt = x.dtype
    eps = torch.finfo(real_dtype(dt)).eps
    basis = torch.zeros(batch + (restart + 1, n), dtype=dt, device=x.device)
    basis[..., 0, :] = unit
    # rows of H are jax's ``H[k, :]``; identity rows stand in for the steps
    # a member never takes, keeping its normal equations nonsingular
    hess = torch.eye(restart, restart + 1, dtype=dt, device=x.device).expand(
        batch + (restart, restart + 1)).clone()
    broken = torch.zeros(batch, dtype=torch.bool, device=x.device)
    for k in range(restart):
        v = apply(basis[..., k, :])
        _, nrm0 = _safe_normalize(v, eps)
        h = peinsum("...kn,...n->...k", basis.conj(), v)
        v = v - peinsum("...k,...kn->...n", h, basis)
        v, nrm1 = _safe_normalize(v, eps * nrm0)
        h[..., k + 1] = nrm1.to(dt)
        live = ~broken
        basis[..., k + 1, :] = torch.where(live[..., None], v,
                                           basis[..., k + 1, :])
        hess[..., k, :] = torch.where(live[..., None], h, hess[..., k, :])
        broken = broken | (nrm1 == 0)
    beta = torch.zeros(batch + (restart + 1,), dtype=dt, device=x.device)
    beta[..., 0] = rnorm.to(dt)
    gram = peinsum("...ij,...kj->...ik", hess.conj(), hess)
    rhs = peinsum("...ij,...j->...i", hess.conj(), beta)
    factor, info = torch.linalg.cholesky_ex(gram)
    y = torch.cholesky_solve(rhs[..., None], factor)[..., 0]
    y = torch.where((info == 0)[..., None], y, torch.full_like(y, float("nan")))
    x = x + peinsum("...k,...kn->...n", y, basis[..., :-1, :])
    unit, rnorm = _safe_normalize(b - apply(x), eps)
    return x, unit, rnorm


def gmres(matvec, b, x0=None, tol=1e-5, atol=0.0, restart=20, maxiter=None,
          batch_ndim=0):
    """Solve ``A x = b`` by restarted GMRES, as jax 0.9.0's
    ``jax.scipy.sparse.linalg.gmres(..., solve_method="batched")`` does.

    ``matvec`` maps a tensor of ``b``'s shape to one of the same shape
    (real or complex).  ``restart`` is clipped to the system size and
    ``maxiter`` counts restart cycles (default ``10 * size``).  A member
    stops once ``|b - A x| <= max(tol |b|, atol)``.  The first
    ``batch_ndim`` axes of ``b`` are a batch of independent systems; each
    member stops on its own residual and is frozen from then on, as under
    ``jax.vmap`` of jax's ``while_loop``.  The loop reads the host once a
    restart cycle (whether any member is still running).

    Returns ``(x, info)``: ``info`` is 0, or -1 where ``x`` is NaN (jax's
    convention), per member.
    """
    batch = tuple(b.shape[:batch_ndim])
    shape = tuple(b.shape[batch_ndim:])
    flat_b = b.reshape(batch + (-1,))
    size = flat_b.shape[-1]
    restart = min(int(restart), size)
    maxiter = 10 * size if maxiter is None else int(maxiter)
    x = (torch.zeros_like(flat_b) if x0 is None
         else x0.reshape(batch + (-1,)).to(b.dtype).clone())

    def apply(v):
        return matvec(v.reshape(batch + shape)).reshape(batch + (-1,))

    eps = torch.finfo(real_dtype(b.dtype)).eps
    bound = torch.clamp(tol * _norm(flat_b), min=atol)
    unit, rnorm = _safe_normalize(flat_b - apply(x), eps)
    cycles = torch.zeros(batch, dtype=torch.int64, device=b.device)
    running = rnorm > bound
    while maxiter > 0 and bool(running.any()):
        new_x, new_unit, new_rnorm = _gmres_cycle(apply, flat_b, x, unit, rnorm,
                                                  restart)
        x = torch.where(running[..., None], new_x, x)
        unit = torch.where(running[..., None], new_unit, unit)
        rnorm = torch.where(running, new_rnorm, rnorm)
        cycles = cycles + running.to(torch.int64)
        running = (cycles < maxiter) & (rnorm > bound)
    info = torch.where(torch.isnan(_norm(x)), -1, 0)
    return x.reshape(b.shape), (int(info) if batch_ndim == 0 else info)
