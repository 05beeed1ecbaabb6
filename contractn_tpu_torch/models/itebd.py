"""iTEBD: infinite-chain ground states by imaginary-time evolution.

Counterpart of ``contractn_tpu/models/itebd.py``.  The classic Vidal
algorithm on a two-site unit cell ``(Gamma_A, lambda_A, Gamma_B,
lambda_B)``: Trotter gates ``exp(-dt h)`` act on alternating bonds, each
followed by an SVD truncation back to the fixed bond dimension.  In
canonical (Vidal) form the environments are the squared Schmidt
coefficients, so bond energies read off the two-site wavefunction directly.

A stage (fixed gate, ``n_iter`` sweeps over both bonds) runs with static
``(d, D)`` shapes on the state's device and reads nothing on the host; the
host only walks the ``dt`` schedule.
"""

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device

_LAM_TOL = 1e-9  # relative to max(lambda)


def two_site_gate(h2, dt, device=None):
    """``exp(-dt * h2)`` for a Hermitian two-site term ``h2 (d^2, d^2)``.

    ``dt`` may be complex (``1j * t`` for real time).  A torch ``h2`` keeps
    its device; a numpy one goes to ``device`` (default ``cuda``).
    """
    device = resolve_device(device, (h2,))
    h2 = as_tensor(h2, device)
    vals, vecs = torch.linalg.eigh(h2)
    # a complex dt promotes the phases to complex
    return peinsum("ik,k,jk->ij", vecs, torch.exp(-dt * vals), vecs.conj())


def _bond_update(ga, gb, la, lb, gate):
    """Apply ``gate`` to the A-B bond; returns ``(ga', gb', la')``."""
    d, bond, _ = ga.shape
    cut = _LAM_TOL * lb.max()
    linv = torch.where(lb > cut, 1.0 / torch.clamp(lb, min=1e-300),
                       torch.zeros_like(lb))
    # theta[s, t, i, k] with lambda_B on BOTH outer bonds (canonical form)
    left = ga * lb[None, :, None] * la[None, None, :]
    theta = peinsum("sij,tjk->stik", left, gb * lb[None, None, :])
    theta = peinsum("uvst,stik->uvik", gate.reshape(d, d, d, d), theta)
    mat = theta.transpose(1, 2).reshape(d * bond, d * bond)
    u, s, vh = torch.linalg.svd(mat, full_matrices=False)
    u, s, vh = u[:, :bond], s[:bond], vh[:bond]
    s = s / torch.clamp(torch.linalg.norm(s), min=1e-300)
    ga_new = u.reshape(d, bond, bond) * linv[None, :, None]
    gb_new = vh.reshape(bond, d, bond).transpose(0, 1) * linv[None, None, :]
    return ga_new, gb_new, s.to(la.dtype)


def _stage(ga, gb, la, lb, gate, n_iter):
    for _ in range(n_iter):
        ga, gb, la = _bond_update(ga, gb, la, lb, gate)
        gb, ga, lb = _bond_update(gb, ga, lb, la, gate)
    return ga, gb, la, lb


def _bond_energy(ga, gb, la, lb, h2):
    """``<theta| h |theta> / <theta|theta>`` on the A-B bond (a host float)."""
    d = ga.shape[0]
    left = ga * lb[None, :, None] * la[None, None, :]
    theta = peinsum("sij,tjk->stik", left, gb * lb[None, None, :])
    vec = theta.reshape(d * d, -1)
    hvec = peinsum("uv,vx->ux", h2.to(vec.dtype), vec)
    num = (vec.conj() * hvec).sum()
    den = (vec.conj() * vec).sum()
    return float(torch.real(num / den))


def itebd_ground_state(h2, bond_dim, d=2,
                       schedule=((0.1, 400), (0.01, 400), (0.001, 400)),
                       dtype=torch.float64, generator=None, device=None):
    """Variational infinite-chain ground state of ``H = sum_i h2_{i,i+1}``.

    Args:
        h2: Hermitian two-site term as a dense ``(d^2, d^2)`` matrix (e.g.
            :func:`tfim_h2`, :func:`heisenberg_h2`).
        bond_dim: fixed bond dimension of the unit cell.
        schedule: ``(dt, n_iter)`` stages, large steps first.
        generator: optional ``torch.Generator`` on ``device``: perturbs the
            product start by 1e-3 normal noise, so distinct draws explore
            distinct basins (the JAX package's ``key``).
        device: where to compute (default ``cuda``; a torch ``h2`` keeps
            its device).

    Returns:
        ``(state, energy)``: ``state`` holds the Vidal tensors
        ``gamma_a/gamma_b/lambda_a/lambda_b`` plus ``cores`` — the
        ``(2, d, D, D)`` left-canonical unit-cell cores — and ``energy`` is
        the converged energy per site (a host float).
    """
    device = resolve_device(device, (h2,))
    # Product-state start (rank 1, generic local vector) keeps the fixed
    # point injective; the reversed vector on B (Neel-like asymmetry) keeps
    # staggered Hamiltonians out of translation-invariant eigenstates.
    va = np.cos(0.3 + 0.4 * np.arange(d))
    va = va / np.linalg.norm(va)
    vb = va[::-1].copy()
    ga = torch.zeros((d, bond_dim, bond_dim), dtype=dtype, device=device)
    gb = torch.zeros_like(ga)
    ga[:, 0, 0] = torch.from_numpy(va).to(device, dtype)
    gb[:, 0, 0] = torch.from_numpy(vb).to(device, dtype)
    la = torch.zeros((bond_dim,), dtype=dtype, device=device)
    la[0] = 1.0
    lb = la
    if generator is not None:
        ga = ga + 1e-3 * torch.randn(ga.shape, dtype=dtype, device=device,
                                     generator=generator)
        gb = gb + 1e-3 * torch.randn(gb.shape, dtype=dtype, device=device,
                                     generator=generator)

    h2 = as_tensor(h2, device, dtype)
    for dt, n_iter in schedule:
        ga, gb, la, lb = _stage(ga, gb, la, lb, two_site_gate(h2, dt),
                                int(n_iter))

    energy = 0.5 * (_bond_energy(ga, gb, la, lb, h2)
                    + _bond_energy(gb, ga, lb, la, h2))
    # LEFT-canonical unit-cell cores: lambda on the left cancels the
    # 1/lambda in Gamma exactly, so no null-space noise reaches the
    # transfer operator
    cores = torch.stack([lb[None, :, None] * ga, la[None, :, None] * gb])
    state = {"gamma_a": ga, "gamma_b": gb, "lambda_a": la, "lambda_b": lb,
             "cores": cores}
    return state, energy


def unit_cell_core(state, tol=1e-8):
    """Blocked injective unit-cell core for the uMPS tooling.

    ``C = lambda_B Gamma_A lambda_A Gamma_B`` restricted to the effective
    Schmidt rank on both bonds (directions with ``lambda < tol * max``
    dropped, which removes the noise the ``1/lambda`` factors carry).
    Returns a ``(d^2, r, r)`` core on the state's device.
    """
    device = state["gamma_a"].device
    ga, gb, la, lb = (state[k].cpu().numpy()
                      for k in ("gamma_a", "gamma_b", "lambda_a", "lambda_b"))
    keep_a = la > tol * la.max()
    keep_b = lb > tol * lb.max()
    ga_t = ga[:, keep_b][:, :, keep_a]
    gb_t = gb[:, keep_a][:, :, keep_b]
    c = np.einsum("i,sij,j,tjk->stik", lb[keep_b], ga_t, la[keep_a], gb_t)
    d = ga.shape[0]
    r = int(keep_b.sum())
    return torch.from_numpy(c.reshape(d * d, r, r)).to(device)


# ---------------------------------------------------------------------- #
# Standard two-site Hamiltonian terms (dense (d^2, d^2) numpy matrices)
# ---------------------------------------------------------------------- #

_SX = np.array([[0.0, 1.0], [1.0, 0.0]])
_SZ = np.array([[1.0, 0.0], [0.0, -1.0]])
_SY_IM = np.array([[0.0, -1.0], [1.0, 0.0]])  # i * sigma_y (real)
_ID = np.eye(2)


def tfim_h2(j=1.0, h=1.0):
    """TFIM bond term with the field split between bonds:
    ``-J Z(x)Z - (h/2)(X(x)1 + 1(x)X)``.  Exact infinite-chain ground energy
    per site at ``J = h = 1``: ``-4/pi``."""
    return (-j * np.kron(_SZ, _SZ)
            - 0.5 * h * (np.kron(_SX, _ID) + np.kron(_ID, _SX)))


def heisenberg_h2(jx=1.0, jz=1.0):
    """XXZ bond term ``(Jx/4)(XX + YY) + (Jz/4) ZZ`` (spin-1/2 S.S for
    ``Jx = Jz = 1``; exact ground energy per site ``1/4 - ln 2``)."""
    return 0.25 * (
        jx * (np.kron(_SX, _SX) - np.kron(_SY_IM, _SY_IM))
        + jz * np.kron(_SZ, _SZ)
    )
