"""Two-site DMRG: variational ground-state search over MPS.

Counterpart of ``contractn_tpu/models/dmrg.py``.  Sandwich environments
update with the same two-GEMM-per-site contractions as
:meth:`~.mpo.MPO.expectation`; local two-site problems are solved by dense
Hermitian ``eigh`` up to ``_DENSE_EIGH_LIMIT`` and by the environment-matvec
Lanczos of :mod:`..ops.krylov` above it; SVD truncation keeps the bond at
``max_bond``.  The result returns to the uniform stacked ``(N, d, D, D)``
form (zero-padded), so it evaluates, samples and compresses like any other
MPS — on the card, ``MPS.evaluate`` of a ground state at ``D <= 128`` runs
the chain kernel.

A local solve reads the host once, as the JAX package's does for its energy:
the Lanczos tridiagonal (``iters`` numbers) is read and solved on the host
(:func:`~..ops.krylov.tridiagonal_eigh`), which yields the energy with no
further read; the dense solve reads its lowest eigenvalue.
(``torch.linalg.eigh`` and ``torch.linalg.svd`` synchronize the card with
the host themselves.)

Environment contractions and ``_split_theta`` broadcast over leading batch
axes, which :mod:`.ensemble` uses for its Hamiltonian ensembles.
"""

import numpy as np
import torch

from ..ops.krylov import lanczos_ground
from ..ops.linalg_ad import dense_eigh
from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device
from .mpo import MPO, _uniform_mpo, mpo_sum
from .mpo import rayleigh as _rayleigh
from .mps import MPS

_SX = np.array([[0.0, 1.0], [1.0, 0.0]])
_SZ = np.array([[1.0, 0.0], [0.0, -1.0]])
_SY_IM = np.array([[0.0, -1.0], [1.0, 0.0]])  # -i * sigma_y (real);
# only ever used quadratically, where the overall sign cancels
_ID = np.eye(2)

# Above this two-site problem size the dense eigh is replaced by Lanczos
_DENSE_EIGH_LIMIT = 1024


def _ragged_sites(mps):
    """Site tensors with explicit boundary bonds: each ``(d, Din, Dout)``,
    ``Din[0] = Dout[-1] = 1``."""
    cores = mps.cores
    n = cores.shape[0]
    left = as_tensor(mps.left, cores.device)
    right = as_tensor(mps.right, cores.device)
    first = peinsum("i,dij->dj", left, cores[0])[:, None, :]
    last = peinsum("dij,j->di", cores[-1], right)[:, :, None]
    return [first] + [cores[i] for i in range(1, n - 1)] + (
        [last] if n > 1 else []
    )


def _rebuild_uniform(tensors, dtype):
    """Uniform stacked MPS from ragged ``(d, Din, Dout)`` site tensors
    (zero-padded bonds, ``e0`` boundaries), on the first tensor's device."""
    n = len(tensors)
    d = tensors[0].shape[0]
    bond = max(max(t.shape[1], t.shape[2]) for t in tensors)
    bond = max(bond, 1)
    device = tensors[0].device
    cores = torch.zeros((n, d, bond, bond), dtype=dtype, device=device)
    for i, t in enumerate(tensors):
        cores[i, :, :t.shape[1], :t.shape[2]] = t
    e0 = torch.zeros((bond,), dtype=dtype, device=device)
    e0[0] = 1.0
    return MPS(cores, e0, e0.clone())


def _boundary(vec, dtype, device):
    """``(1, W, 1)`` edge environment from an MPO boundary vector."""
    return as_tensor(vec, device).to(dtype)[None, :, None]


def _update_left(L, site, w):
    """L' after absorbing one site: ``L (i, w, p)`` bra x op x ket."""
    t = peinsum("...iwp,...bpq->...iwbq", L, site)
    t = peinsum("...abwv,...iwbq->...iavq", w, t)
    return peinsum("...aij,...iavq->...jvq", site.conj(), t)


def _update_right(R, site, w):
    """R' after absorbing one site from the right: ``R (j, u, q)``."""
    t = peinsum("...juq,...bpq->...jubp", R, site)
    t = peinsum("...abwv,...jvbp->...jwap", w, t)
    return peinsum("...aij,...jwap->...iwp", site.conj(), t)


def _heff_matvec(L, w1, w2, R, theta):
    """Apply the two-site effective Hamiltonian without materializing it.

    Four small contractions, cost O(d^2 D^3 W) — the standard DMRG matvec.
    ``theta``: (d, d, Dl, Dr) -> same shape.
    """
    t = peinsum("...iwp,...ABpq->...iwABq", L, theta)
    t = peinsum("...XAwv,...iwABq->...iXvBq", w1, t)
    t = peinsum("...YBvu,...iXvBq->...iXYuq", w2, t)
    return peinsum("...kuq,...iXYuq->...XYik", R, t)


def _lanczos_ground(L, w1, w2, R, theta0, iters=24):
    """Lowest eigenpair of H_eff by Lanczos (:mod:`..ops.krylov`); returns
    ``(energy, theta)`` with one host read (the tridiagonal)."""
    return lanczos_ground(lambda t: _heff_matvec(L, w1, w2, R, t), theta0,
                          iters)


def _dense_heff(L, w1, w2, R):
    """The two-site effective Hamiltonian as a Hermitized dense matrix."""
    d = w1.shape[0]
    dim = d * d * L.shape[0] * R.shape[0]
    # H[(X,Y,i,k), (A,B,p,q)] = L[i,w,p] W1[X,A,w,v] W2[Y,B,v,u] R[k,u,q]
    hmat = peinsum("iwp,XAwv,YBvu,kuq->XYikABpq", L, w1, w2, R).reshape(dim, dim)
    return 0.5 * (hmat + hmat.conj().T)


def _local_ground_state(L, w1, w2, R, theta0=None):
    """Ground state of the two-site effective Hamiltonian.

    Dense eigh up to ``_DENSE_EIGH_LIMIT``; environment-matvec Lanczos above
    it.  Returns ``(energy, theta)`` with theta of shape ``(d, d, Dl, Dr)``.
    """
    d = w1.shape[0]
    dl, dr = L.shape[0], R.shape[0]
    if d * d * dl * dr > _DENSE_EIGH_LIMIT and theta0 is not None:
        return _lanczos_ground(L, w1, w2, R, theta0)
    vals, vecs = dense_eigh(_dense_heff(L, w1, w2, R))
    return float(vals[0]), vecs[:, 0].reshape(d, d, dl, dr)


def _ovl_left_update(lg, gsite, psisite):
    """Overlap environment after absorbing one site from the left.

    ``lg (Dg, D)``: ``<g|psi>`` partial contraction (bra ``g`` conjugated);
    ``gsite (d, Dg, Dg')``, ``psisite (d, D, D')``.
    """
    return peinsum("ab,dax,dby->xy", lg, gsite.conj(), psisite)


def _ovl_right_update(rg, gsite, psisite):
    return peinsum("xy,dax,dby->ab", rg, gsite.conj(), psisite)


def _penalty_vector(lg, g1, g2, rg):
    """The local two-site representation ``pg`` of ``|g>``:
    ``<g|psi> = vdot(pg, theta)`` for the current environments; shape
    ``(d, d, Dl, Dr)`` matching theta."""
    t = peinsum("ab,dax->dxb", lg.conj(), g1)  # (d, Dg', D)
    t = peinsum("dxb,exy->deby", t, g2)  # (d, d, Dg'', D)
    return peinsum("deby,yq->debq", t, rg.conj())


def _lanczos_ground_penalized(L, w1, w2, R, theta0, iters, pgs, weights):
    """Lanczos for ``H_eff + sum_k w_k |pg_k><pg_k|`` (the orthogonality
    trick for excited-state DMRG).  ``pgs (k, *theta.shape)``,
    ``weights (k,)``.  One host read (the tridiagonal)."""
    shape = theta0.shape
    flat = pgs.reshape(pgs.shape[0], -1)

    def matvec(t):
        ov = peinsum("kx,x->k", flat.conj(), t.reshape(-1))
        return _heff_matvec(L, w1, w2, R, t) + peinsum(
            "k,kx->x", weights * ov, flat).reshape(shape)

    return lanczos_ground(matvec, theta0, iters)


def _local_ground_penalized(L, w1, w2, R, theta0, penalties):
    """Lowest eigenpair of the penalized two-site problem.

    ``penalties``: list of ``(weight, pg)``.  Dense up to the eigh limit,
    rank-k-augmented Lanczos above it.
    """
    if not penalties:
        return _local_ground_state(L, w1, w2, R, theta0)
    d = w1.shape[0]
    dl, dr = L.shape[0], R.shape[0]
    dim = d * d * dl * dr
    if dim > _DENSE_EIGH_LIMIT and theta0 is not None:
        pgs = torch.stack([p for _, p in penalties])
        weights = torch.tensor([w for w, _ in penalties],
                               dtype=pgs.real.dtype, device=pgs.device)
        return _lanczos_ground_penalized(L, w1, w2, R, theta0, 24, pgs,
                                         weights)
    hmat = _dense_heff(L, w1, w2, R)
    for w, pg in penalties:
        v = pg.reshape(-1)
        hmat = hmat + w * torch.outer(v, v.conj())
    vals, vecs = dense_eigh(hmat)
    return float(vals[0]), vecs[:, 0].reshape(d, d, dl, dr)


def _split_theta(theta, max_bond, to_left):
    """SVD-split a two-site block into site tensors.

    ``theta``: ``(..., d, d, Dl, Dr)``.  Returns ``(T1 (..., d, Dl, k),
    T2 (..., d, k, Dr))`` with the isometry on the sweep side.
    """
    *batch, d, _, dl, dr = theta.shape
    batch = tuple(batch)
    mat = theta.transpose(-3, -2).reshape(batch + (d * dl, d * dr))
    u, s, vh = torch.linalg.svd(mat, full_matrices=False)
    k = min(s.shape[-1], max_bond)
    u, s, vh = u[..., :k], s[..., :k], vh[..., :k, :]
    s = s / torch.clamp(torch.linalg.norm(s, dim=-1, keepdim=True), min=1e-300)
    s = s.to(u.dtype)
    if to_left:  # left-to-right sweep: left site is the isometry
        t1 = u.reshape(batch + (d, dl, k))
        t2 = (s[..., :, None] * vh).reshape(batch + (k, d, dr)).transpose(-3, -2)
    else:  # right-to-left: right site is the isometry
        t1 = (u * s[..., None, :]).reshape(batch + (d, dl, k))
        t2 = vh.reshape(batch + (k, d, dr)).transpose(-3, -2)
    return t1, t2


def dmrg(mpo, mps0, max_bond=None, sweeps=4, orthogonal_to=(),
         penalty=None):
    """Minimize ``<psi|H|psi> / <psi|psi>`` over MPS of bounded bond.

    Args:
        mpo: Hermitian Hamiltonian as an :class:`MPO` (on ``mps0``'s device).
        mps0: initial state (e.g. ``MPS.random``); sets ``d``, the default
            bond and the device.
        max_bond: bond-dimension cap (default: ``mps0.bond_dim``).
        sweeps: full left-right + right-left sweeps.
        orthogonal_to: previously found MPS to stay orthogonal to —
            minimizing over ``H + penalty * sum_g |g><g|`` finds excited
            states (see :func:`dmrg_excited`).  States should be normalized.
        penalty: orthogonality weight; must exceed the targeted energy gap.
            Default: ``10 * (1 + |E[mps0]|)``.

    Returns:
        ``(ground_mps, energy, energies)``: the optimized state (uniform
        stacked form, normalized), the final energy, and the per-sweep energy
        trace (host floats).
    """
    n = mps0.n_sites
    if n < 2:
        raise ValueError("DMRG needs at least 2 sites")
    max_bond = max_bond or mps0.bond_dim
    sites = _ragged_sites(mps0)
    dt, device = sites[0].dtype, sites[0].device
    ws = [mpo.cores[i] for i in range(n)]

    L = [None] * (n + 1)
    R = [None] * (n + 1)
    L[0] = _boundary(mpo.left, dt, device)
    R[n] = _boundary(mpo.right, dt, device)
    for i in range(n - 1, 0, -1):  # right environments for the first sweep
        R[i] = _update_right(R[i + 1], sites[i], ws[i])

    # Overlap environments against each orthogonality constraint
    gs = [_ragged_sites(g) for g in orthogonal_to]
    if gs and penalty is None:
        penalty = 10.0 * (1.0 + abs(_rayleigh(mpo, mps0)))
    lg = [[None] * (n + 1) for _ in gs]
    rg = [[None] * (n + 1) for _ in gs]
    one = torch.ones((1, 1), dtype=dt, device=device)
    for k, g in enumerate(gs):
        lg[k][0] = one
        rg[k][n] = one
        for i in range(n - 1, 0, -1):
            rg[k][i] = _ovl_right_update(rg[k][i + 1], g[i], sites[i])

    def penalties_at(i):
        return [
            (penalty, _penalty_vector(lg[k][i], gs[k][i], gs[k][i + 1],
                                      rg[k][i + 2]))
            for k in range(len(gs))
        ]

    energies = []
    energy = np.inf
    for _ in range(sweeps):
        for i in range(n - 1):  # left -> right
            theta0 = peinsum("apj,bjq->abpq", sites[i], sites[i + 1])
            energy, theta = _local_ground_penalized(
                L[i], ws[i], ws[i + 1], R[i + 2], theta0, penalties_at(i))
            sites[i], sites[i + 1] = _split_theta(theta, max_bond, to_left=True)
            L[i + 1] = _update_left(L[i], sites[i], ws[i])
            for k, g in enumerate(gs):
                lg[k][i + 1] = _ovl_left_update(lg[k][i], g[i], sites[i])
        for i in range(n - 2, -1, -1):  # right -> left
            theta0 = peinsum("apj,bjq->abpq", sites[i], sites[i + 1])
            energy, theta = _local_ground_penalized(
                L[i], ws[i], ws[i + 1], R[i + 2], theta0, penalties_at(i))
            sites[i], sites[i + 1] = _split_theta(theta, max_bond, to_left=False)
            R[i + 1] = _update_right(R[i + 2], sites[i + 1], ws[i + 1])
            for k, g in enumerate(gs):
                rg[k][i + 1] = _ovl_right_update(rg[k][i + 2], g[i + 1],
                                                 sites[i + 1])
        energies.append(energy)

    return _rebuild_uniform(sites, mps0.cores.dtype), energy, energies


def dmrg_excited(mpo, mps0, n_states, max_bond=None, sweeps=4,
                 penalty=None, generator=None):
    """Lowest ``n_states`` eigenstates by sequential orthogonal DMRG.

    Each state is found by :func:`dmrg` with orthogonality penalties against
    all previously found states (the energies reported per state exclude the
    penalty — they are Rayleigh quotients of the final states).  States after
    the first start from ``MPS.random`` drawn from ``generator`` (a
    ``torch.Generator`` on ``mps0``'s device, or the global one).  Returns
    ``(states, energies)``.
    """
    states, energies = [], []
    for k in range(n_states):
        if k == 0:
            init = mps0
        else:
            init = MPS.random(mps0.n_sites, mps0.phys_dim,
                              max_bond or mps0.bond_dim,
                              dtype=mps0.cores.dtype, generator=generator,
                              device=mps0.cores.device)
        state, _, _ = dmrg(mpo, init, max_bond=max_bond, sweeps=sweeps,
                           orthogonal_to=states, penalty=penalty)
        states.append(state)
        energies.append(_rayleigh(mpo, state))
    return states, energies


def _normal(shape, dtype, device, generator):
    """Standard-normal draw from ``generator`` (the one random source of
    :func:`idmrg`)."""
    return torch.randn(shape, dtype=dtype, device=device, generator=generator)


def idmrg(mpo_cell, max_bond, steps=60, d=None, dtype=torch.float64,
          lanczos_iters=80, device=None, generator=None):
    """Infinite-system DMRG: variational bulk energy per site.

    McCulloch-style growth: two fresh sites are inserted in the middle every
    step, the two-site block is solved against the accumulated environments
    (the same machinery as finite :func:`dmrg`), and the halves are
    absorbed.  Differences of the total energies converge geometrically (for
    gapped systems) to twice the bulk energy per site.

    Args:
        mpo_cell: an :class:`MPO` of any length >= 1 whose ``cores[0]``,
            ``left`` and ``right`` are the repeated bulk tensor ``(d, d, W,
            W)`` and its boundary vectors.
        max_bond: bond cap for the half-chain SVD splits.
        steps: growth iterations.
        device: where to compute (default: the MPO's device).
        generator: ``torch.Generator`` on ``device`` for the initial blocks
            and the prediction noise (or the global one).

    Returns:
        ``(energy_per_site, trace)``: the converged estimate and the
        per-step estimates (host floats).
    """
    if steps < 2:
        raise ValueError("idmrg needs steps >= 2 (energy differences)")
    device = resolve_device(device, (mpo_cell.cores,))
    w = as_tensor(mpo_cell.cores[0], device, dtype)
    d = d or w.shape[0]
    L = _boundary(mpo_cell.left, dtype, device)
    R = _boundary(mpo_cell.right, dtype, device)

    theta0 = None
    prev_e = None
    trace = []
    for _ in range(int(steps)):
        dl, dr = L.shape[0], R.shape[0]
        if theta0 is None or tuple(theta0.shape) != (d, d, dl, dr):
            theta0 = _normal((d, d, dl, dr), dtype, device, generator)
        if d * d * dl * dr > _DENSE_EIGH_LIMIT:
            # growth starts are worse than finite sweeps: more Krylov room
            energy, theta = _lanczos_ground(L, w, w, R, theta0,
                                            iters=lanczos_iters)
        else:
            energy, theta = _local_ground_state(L, w, w, R, theta0)
        t1, _ = _split_theta(theta, max_bond, to_left=True)
        _, t2r = _split_theta(theta, max_bond, to_left=False)
        L = _update_left(L, t1, w)
        R = _update_right(R, t2r, w)
        if prev_e is not None:
            trace.append(0.5 * (energy - prev_e))
        prev_e = energy
        # wavefunction prediction: reuse the block when shapes repeat, with
        # a dash of noise so Lanczos is not confined to the guess's sector
        new_shape = (d, d, min(dl * d, max_bond), min(dr * d, max_bond))
        if tuple(theta.shape) == new_shape:
            noise = _normal(tuple(theta.shape), dtype, device, generator)
            theta0 = theta + 1e-2 * noise / torch.linalg.norm(noise)
        else:
            theta0 = None
    return trace[-1], trace


# ---------------------------------------------------------------------- #
# Standard Hamiltonians
# ---------------------------------------------------------------------- #


def tfim_mpo(n_sites, j=1.0, h=1.0, dtype=torch.float64, device=None):
    """Transverse-field Ising chain ``H = -J sum Z Z - h sum X`` (W=3)."""
    w = np.zeros((2, 2, 3, 3))
    w[:, :, 0, 0] = _ID
    w[:, :, 2, 2] = _ID
    w[:, :, 0, 1] = _SZ
    w[:, :, 1, 2] = -j * _SZ
    w[:, :, 0, 2] = -h * _SX
    return _uniform_mpo(w, np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                        n_sites, dtype, device)


def heisenberg_mpo(n_sites, jx=1.0, jz=1.0, dtype=torch.float64, device=None):
    """XXZ Heisenberg chain
    ``H = sum Jx (X X + Y Y) + Jz Z Z`` (W=5, real representation:
    ``Y Y = -(iY)(iY)``)."""
    w = np.zeros((2, 2, 5, 5))
    w[:, :, 0, 0] = _ID
    w[:, :, 4, 4] = _ID
    w[:, :, 0, 1] = _SX
    w[:, :, 1, 4] = jx * _SX
    w[:, :, 0, 2] = _SY_IM
    w[:, :, 2, 4] = -jx * _SY_IM
    w[:, :, 0, 3] = _SZ
    w[:, :, 3, 4] = jz * _SZ
    return _uniform_mpo(w, np.array([1.0, 0, 0, 0, 0]), np.array([0, 0, 0, 0, 1.0]),
                        n_sites, dtype, device)


def total_sz_penalty_mpo(n_sites, q, lam=1.0, dtype=torch.float64, device=None):
    """MPO of ``lam * (S^z_total - q)^2`` on ``n_sites`` spin-1/2 sites.

    ``(sum_i z_i - q)^2 = sum_i (z_i^2 - 2 q z_i + q^2/n) + 2 sum_{i<j} z_i
    z_j`` with ``z = S^z = diag(1/2, -1/2)`` — a width-3 triangular MPO whose
    INTERIOR diagonal is the identity (uniform infinite-range pair coupling;
    finite chains only).  Added to a U(1)-conserving Hamiltonian with
    :func:`~.mpo.mpo_sum` it pins the total-magnetization sector — see
    :func:`dmrg_sector`.
    """
    z = _SZ / 2.0
    onsite = (0.25 + q * q / n_sites) * _ID - 2.0 * q * z  # z^2 = I/4
    w = np.zeros((2, 2, 3, 3))
    w[:, :, 0, 0] = _ID
    w[:, :, 2, 2] = _ID
    w[:, :, 1, 1] = _ID  # uniform (non-decaying) pair channel
    w[:, :, 0, 1] = z
    w[:, :, 1, 2] = 2.0 * z
    w[:, :, 0, 2] = onsite
    # lam scales through the boundary vector (exact, keeps cores uniform)
    return _uniform_mpo(w, np.array([lam, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                        n_sites, dtype, device)


def dmrg_sector(mpo, mps0, q, lam=None, max_bond=None, sweeps=4, **kwargs):
    """Ground state of a U(1)-conserving ``mpo`` in the total-``S^z = q``
    sector, by minimizing ``H + lam (S^z_tot - q)^2``.

    The reported energy is the Rayleigh quotient of ``H`` on the optimized
    state (penalty excluded); ``sz_residual`` is ``<(S^z_tot - q)^2>``,
    ~0 when the sector is resolved.  Returns ``(mps, energy, sz_residual)``.
    """
    if lam is None:
        lam = 10.0 * (1.0 + float(mps0.n_sites))  # above typical sector gaps
    pen = total_sz_penalty_mpo(mps0.n_sites, q, lam=lam, dtype=mpo.cores.dtype,
                               device=mpo.cores.device)
    mps, _, _ = dmrg(mpo_sum(mpo, pen), mps0, max_bond=max_bond,
                     sweeps=sweeps, **kwargs)
    return mps, _rayleigh(mpo, mps), _rayleigh(pen, mps) / lam


def xx_dimerized_mpo(n_sites, j=1.0, delta=0.5, dtype=torch.float64,
                     device=None):
    """Dimerized XX chain ``H = sum_i J_i (S^x S^x + S^y S^y)`` with
    alternating bonds ``J_i = J (1 + delta)`` / ``J (1 - delta)`` — the
    exactly solvable two-site-cell model (free fermions with alternating
    hoppings ``J_i / 2``).  Bond ``(i, i + 1)``'s coupling sits in site
    ``i``'s emitting channel entries, so a 2-core slice is a valid cell.
    """
    sp = np.array([[0.0, 1.0], [0.0, 0.0]])
    sm = sp.T
    cores = []
    for i in range(n_sites):
        ji = j * (1 + delta if i % 2 == 0 else 1 - delta)
        w = np.zeros((2, 2, 4, 4))
        w[:, :, 0, 0] = np.eye(2)
        w[:, :, 3, 3] = np.eye(2)
        w[:, :, 0, 1] = (ji / 2) * sp
        w[:, :, 0, 2] = (ji / 2) * sm
        w[:, :, 1, 3] = sm
        w[:, :, 2, 3] = sp
        cores.append(w)
    device = resolve_device(device)

    def put(a):
        return torch.from_numpy(a).to(device, dtype)

    return MPO(put(np.stack(cores)), put(np.array([1.0, 0, 0, 0])),
               put(np.array([0, 0, 0, 1.0])))
