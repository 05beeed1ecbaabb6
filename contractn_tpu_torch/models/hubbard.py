"""The 2D Hubbard model on the MPS machinery (spinful fermions via
spin-orbital snake Jordan-Wigner).

Counterpart of ``contractn_tpu/models/hubbard.py``.  Each lattice site
carries two spin-orbitals interleaved along the snake path (orbital
``2*snake(r,c) + s``), so

    ``H = -t sum_<ij>s (c^d_is c_js + h.c.) + U sum_i n_iu n_id
          - mu sum_is n_is``

compiles exactly through :func:`~.fermions2d.string_mpo` on a
``2*lx*ly``-site d=2 chain, and the finite DMRG / TDVP machinery runs on it
unchanged.  Fixed ``(N_up, N_dn)`` sectors run through the charge-masked
DMRG of :mod:`.u1` with packed per-orbital charges.  Sign conventions follow
``fermions2d`` (``n = (I+Z)/2``, occupied first).  The Fock-space oracles
are dense host numpy, for small lattices only.
"""

import numpy as np
import torch

from ..utils.device import as_tensor, resolve_device
from .fermions2d import _I2, _SM, _SP, _Z, snake_index, string_mpo
from .mpo import MPO

_N = 0.5 * (_I2 + _Z)  # number operator, occupied-first convention


def so_index(r, c, s, lx):
    """Spin-orbital JW index: snake over lattice sites, spin inside."""
    return 2 * snake_index(r, c, lx) + s


def hubbard2d_mpo(lx, ly, t=1.0, u=4.0, mu=0.0, dtype=torch.float64,
                  device=None):
    """Exact snake-JW MPO of the open ``lx x ly`` Hubbard model over
    ``2*lx*ly`` d=2 spin-orbital sites, on ``device`` (default ``cuda``).
    Half filling's particle-hole symmetric point is ``mu = u/2``."""
    terms = []
    onsite = []
    for r in range(ly):
        for c in range(lx):
            i2 = so_index(r, c, 0, lx)
            onsite.append((i2, -mu * _N))
            onsite.append((i2 + 1, -mu * _N))
            terms.append((float(u), [(i2, _N), (i2 + 1, _N)], _I2))
            for (r2, c2) in ((r, c + 1), (r + 1, c)):
                if r2 >= ly or c2 >= lx:
                    continue
                for s in (0, 1):
                    a = so_index(r, c, s, lx)
                    b = so_index(r2, c2, s, lx)
                    m, n = (a, b) if a < b else (b, a)
                    # -t (c^d_m c_n + h.c.) = t (S+ Z.. S- + S- Z.. S+)
                    terms.append((float(t), [(m, _SP), (n, _SM)], _Z))
                    terms.append((float(t), [(m, _SM), (n, _SP)], _Z))
    return string_mpo(2 * lx * ly, terms, onsite=onsite, dtype=dtype,
                      device=device)


def hubbard_fock_hamiltonian(lx, ly, t=1.0, u=4.0, mu=0.0):
    """Dense Fock-space Hubbard Hamiltonian (numpy, the ED oracle), from
    explicit ``c = (prod Z) S^-`` matrices in the same JW ordering as
    :func:`hubbard2d_mpo`.  Dimension ``4^(lx*ly)``: keep lattices at <= 6
    sites."""
    n_orb = 2 * lx * ly

    def op_at(mats):
        m = np.eye(1)
        for k in range(n_orb):
            m = np.kron(m, mats.get(k, np.eye(2)))
        return m

    cs = [op_at({**{j: _Z for j in range(k)}, k: _SM}) for k in range(n_orb)]
    dim = 2 ** n_orb
    h = np.zeros((dim, dim))
    for r in range(ly):
        for c in range(lx):
            iu = so_index(r, c, 0, lx)
            nu = np.matmul(cs[iu].T, cs[iu])
            nd = np.matmul(cs[iu + 1].T, cs[iu + 1])
            h += u * np.matmul(nu, nd) - mu * (nu + nd)
            for (r2, c2) in ((r, c + 1), (r + 1, c)):
                if r2 >= ly or c2 >= lx:
                    continue
                for s in (0, 1):
                    a = so_index(r, c, s, lx)
                    b = so_index(r2, c2, s, lx)
                    h += -t * (np.matmul(cs[a].T, cs[b])
                               + np.matmul(cs[b].T, cs[a]))
    return h


def hubbard_ed_energy(lx, ly, t=1.0, u=4.0, mu=0.0):
    """Exact (grand-canonical) ground energy by dense Fock ED."""
    return float(np.linalg.eigvalsh(hubbard_fock_hamiltonian(lx, ly, t, u, mu))[0])


def hubbard_phys_charges(lx, ly):
    """Per-spin-orbital packed ``(N_up, N_dn)`` charges ``n_up * A + n_dn``
    with ``A = lx*ly + 1``: up orbitals carry ``(A, 0)`` over (occupied,
    empty), down orbitals ``(1, 0)``.  Returns ``(per_site_charges, A)``."""
    a = lx * ly + 1
    return ([(a, 0) if k % 2 == 0 else (1, 0) for k in range(2 * lx * ly)], a)


def hubbard_sector_ed(lx, ly, n_up, n_dn, t=1.0, u=4.0):
    """Exact ``(N_up, N_dn)``-sector ground energy by dense Fock ED (at ``mu
    = 0``), the oracle for :func:`hubbard_dmrg_sector`."""
    h = hubbard_fock_hamiltonian(lx, ly, t, u, 0.0)
    n_orb = 2 * lx * ly
    idx = []
    for b in range(2 ** n_orb):
        # orbital k is kron factor k (most significant first); its FIRST
        # basis state (bit 0) is the occupied one
        occ = [((b >> (n_orb - 1 - k)) & 1) == 0 for k in range(n_orb)]
        if sum(occ[0::2]) == n_up and sum(occ[1::2]) == n_dn:
            idx.append(b)
    if not idx:
        raise ValueError(f"empty sector ({n_up}, {n_dn})")
    return float(np.linalg.eigvalsh(h[np.ix_(idx, idx)])[0])


def hubbard_dmrg_sector(lx, ly, n_up, n_dn, bond_dim, t=1.0, u=4.0, sweeps=8,
                        lanczos_iters=40, generator=None, device=None):
    """Exact-sector Hubbard ground state: charge-masked DMRG
    (:func:`~.u1.dmrg_u1`) at fixed ``(N_up, N_dn)`` on the ``mu = 0``
    snake-JW MPO, on ``device`` (default ``cuda``); ``generator`` draws the
    random masked start.  Returns ``(mps, energy, energies, masks)``."""
    from .u1 import dmrg_u1

    phys, a = hubbard_phys_charges(lx, ly)
    mpo = hubbard2d_mpo(lx, ly, t, u, 0.0, device=device)
    return dmrg_u1(mpo, n_up * a + n_dn, bond_dim, phys_charges=phys,
                   sweeps=sweeps, lanczos_iters=lanczos_iters,
                   generator=generator)


def hubbard_chain_cell(t=1.0, u=4.0, mu=0.0, dtype=torch.float64, device=None):
    """Uniform triangular MPO cell (one core) of the infinite 1D Hubbard
    chain: the two spin-orbitals fold into a d=4 site (up-major, occupied
    first) with the JW string absorbed site-locally (``S^+ Z = -S^+``);
    width 6.  Finite repetitions equal :func:`hubbard2d_mpo` on ``(n, 1)``
    lattices exactly."""

    def kr(a, b):
        return np.kron(a, b)

    eye4 = np.eye(4)
    w = np.zeros((4, 4, 6, 6))
    w[:, :, 0, 0] = eye4
    w[:, :, 5, 5] = eye4
    w[:, :, 0, 5] = u * kr(_N, _N) - mu * (kr(_N, _I2) + kr(_I2, _N))
    w[:, :, 0, 1] = t * kr(_SP, _Z)
    w[:, :, 1, 5] = kr(_SM, _I2)
    w[:, :, 0, 2] = t * kr(_SM, _Z)
    w[:, :, 2, 5] = kr(_SP, _I2)
    w[:, :, 0, 3] = t * kr(_I2, _SP)
    w[:, :, 3, 5] = kr(_Z, _SM)
    w[:, :, 0, 4] = t * kr(_I2, _SM)
    w[:, :, 4, 5] = kr(_Z, _SP)
    left = np.zeros((6,))
    left[0] = 1.0
    right = np.zeros((6,))
    right[5] = 1.0
    device = resolve_device(device)
    return MPO(*(torch.from_numpy(x).to(device, dtype)
                 for x in (w[None], left, right)))


def lieb_wu_energy(u, t=1.0):
    """Exact Bethe-ansatz ground energy per site of the half-filled Hubbard
    chain (``mu = 0``): ``e = -4t int_0^inf J0 J1 / (w (1 + e^{w U / 2t}))``
    by the trapezoid rule on a fine grid (host float)."""
    from scipy.special import j0, j1

    w = np.linspace(1e-9, 60.0 * t / max(float(u), 1.0), 400_001)
    f = j0(w) * j1(w) / (w * (1.0 + np.exp(w * u / (2.0 * t))))
    return float(-4.0 * t * np.trapezoid(f, w))


def hubbard_charge_gap(u, t=1.0):
    """Exact Mott charge gap of the half-filled Hubbard chain (Lieb-Wu):
    ``U - 4t + 8t int_0^inf J1(w) / (w (1 + e^{w U / 2t})) dw``."""
    from scipy.special import j1

    w = np.linspace(1e-9, 60.0 * t / max(float(u), 1.0), 400_001)
    f = j1(w) / (w * (1.0 + np.exp(w * u / (2.0 * t))))
    return float(u - 4.0 * t + 8.0 * t * np.trapezoid(f, w))


def hubbard_relative_charges(a=32):
    """Packed ``(N_up, N_dn)`` charges of the two-lattice-site folded cell,
    relative to half filling (``(2 n_up - 1) * a + (2 n_dn - 1)`` per site);
    the 16 folded charges, s1-major over two d=4 sites."""
    q4 = [a + 1, a - 1, -a + 1, -a - 1]
    return tuple(q1 + q2 for q1 in q4 for q2 in q4)


def hubbard_vumps(u, t=1.0, bond_dims=(16, 32), iters=100, lanczos_iters=40,
                  generator=None, device=None):
    """Infinite half-filled Hubbard chain by charge-masked VUMPS.

    Folds two lattice sites (the d=16 block of :func:`hubbard_chain_cell`)
    and confines the uniform MPS structurally to the half-filled
    zero-magnetization sector via the packed relative charges.
    ``bond_dims`` is the warm-started growth schedule (each bond starts from
    the previous one's state, :func:`~.u1_vumps.expand_sector_state`).
    ``generator`` draws the first start and the growth noise; ``device``
    defaults to ``cuda``.

    Returns the :func:`~.u1_vumps.vumps_u1` result with ``energy_per_site``
    added (cell energy / 2); compare :func:`lieb_wu_energy`.
    """
    from .mpo import block_mpo
    from .u1_vumps import expand_sector_state, vumps_u1

    cell4 = hubbard_chain_cell(t=t, u=u, mu=0.0, device=device)
    rep = cell4.cores[0].expand((2,) + tuple(cell4.cores.shape[1:]))
    cell16 = block_mpo(MPO(rep, cell4.left, cell4.right), 2)
    phys = hubbard_relative_charges()
    res = None
    for bond in bond_dims:
        init = (None if res is None
                else expand_sector_state(res, bond, generator=generator))
        res = vumps_u1(cell16, bond, phys, iters=iters,
                       lanczos_iters=lanczos_iters, generator=generator,
                       init=init)
    res["energy_per_site"] = res["energy"] / 2.0
    return res


def spin_densities(mps, lx, ly):
    """Per-lattice-site ``(<n_up>, <n_dn>)`` profiles (numpy ``(ly, lx)``
    each) from a spin-orbital MPS, through :meth:`MPS.site_expectations`."""
    dens = mps.site_expectations(as_tensor(_N, mps.cores.device))
    dens = torch.real(dens).detach().cpu().numpy()
    up = np.zeros((ly, lx))
    dn = np.zeros((ly, lx))
    for r in range(ly):
        for c in range(lx):
            up[r, c] = dens[so_index(r, c, 0, lx)]
            dn[r, c] = dens[so_index(r, c, 1, lx)]
    return up, dn
