"""Quantum-chemistry DMRG: ab initio Hamiltonians on spin-orbital chains.

Counterpart of ``contractn_tpu/models/chemistry.py``.  Second-quantized
molecular Hamiltonians

    ``H = sum_pq h_pq a+_ps a_qs
          + 1/2 sum_pqrs (pq|rs) a+_ps a+_rt a_st a_qs  +  E_nuc``

compile to an MPO through this package's fermionic AutoMPO and are solved
with its DMRG (the penalty route :func:`chemistry_dmrg`) or its charge-masked
DMRG (the exactly conserving route :func:`chemistry_dmrg_u1`).

Division of labour, as in the reference: the integral engine (s-type STO-3G
closed forms here, general angular momentum in :mod:`.gaussians`), the
RHF/UHF solvers, the term lists and the chunked AutoMPO compile, and the
independent determinant FCI oracle (:func:`fci_ground`, :func:`fci_rdms`)
are host numpy; the compiled MPO and every state live on the device, where
the sweeps run.  The chunked compile folds ``chunk`` terms at a time with
:func:`~.mpo.mpo_sum` and an exact-rank compression, so the intermediate
automaton never holds the full O(M^4)-term machine.

Entry points that build operators or states from host arrays take
``device=`` (default ``cuda``; passing a compiled ``mpo`` puts the work on
its device).  Departures: random draws take a ``torch.Generator``
(``generator=``) where the JAX package takes a key.

Conventions: occupied = index 1 (matches ``autompo.OP_TABLE``); ERIs are
chemists' ``(pq|rs)``; energies returned by :func:`chemistry_dmrg` and
:func:`fci_ground` are ELECTRONIC: add ``E_nuc`` from
:func:`molecular_integrals` for totals.
"""

import math

import numpy as np
import torch

from ..utils.device import resolve_device, torch_dtype
from .autompo import OpSum, op_sum_mpo
from .canonical import compress_mpo
from .dmrg import dmrg
from .mpo import MPO, mpo_sum
from .mps import MPS

__all__ = [
    "sto3g_basis",
    "h_chain_geometry",
    "molecular_integrals",
    "restricted_hartree_fock",
    "unrestricted_hartree_fock",
    "uhf_natural_orbitals",
    "lowdin_orthogonal",
    "mo_transform",
    "chemistry_terms",
    "chemistry_op_sum",
    "chemistry_mpo",
    "determinant_mps",
    "chemistry_dmrg",
    "chemistry_dmrg_u1",
    "chemistry_excited",
    "chemistry_thermal",
    "ancilla_lift_mpo",
    "infinite_temperature_purification",
    "orbital_ordering",
    "permute_orbitals",
    "one_body_mpo",
    "transition_element",
    "oscillator_strengths",
    "fci_ground",
    "fci_rdms",
    "one_rdm",
    "two_rdm",
    "rdm_energy",
    "natural_occupations",
]


# --------------------------------------------------------------------- #
# STO-3G basis (s functions only: H, He)                                 #
# --------------------------------------------------------------------- #

# Least-squares 3-Gaussian fit to a zeta=1 Slater 1s (Hehre-Stewart-
# Pople); scale exponents by zeta^2 for other effective charges.
_STO3G_ALPHA = np.array([2.227660584, 0.405771156, 0.109818])
_STO3G_COEF = np.array([0.154328967, 0.535328142, 0.444634542])

#: element symbol -> (nuclear charge, standard STO-3G 1s zeta)
_ELEMENTS = {"H": (1.0, 1.24), "He": (2.0, 2.0925)}


def sto3g_basis(symbols, centers):
    """Contracted s-type STO-3G functions for H/He geometries.

    Args:
        symbols: element symbols, e.g. ``["H", "H"]``.
        centers: ``(n_atoms, 3)`` positions in bohr.

    Returns:
        ``(basis, charges)`` where ``basis`` is a list of
        ``(center(3,), alphas(k,), coeffs(k,))`` with coefficients
        including primitive norms and an overall contraction
        renormalization (so each function has unit self-overlap), and
        ``charges`` is the ``(n_atoms,)`` array of nuclear charges.
    """
    centers = np.asarray(centers, float).reshape(len(symbols), 3)
    basis, charges = [], []
    for sym, c in zip(symbols, centers):
        if sym not in _ELEMENTS:
            raise ValueError(
                f"sto3g_basis covers s-only elements {sorted(_ELEMENTS)}; "
                f"got {sym!r}"
            )
        z, zeta = _ELEMENTS[sym]
        alphas = _STO3G_ALPHA * zeta**2
        coeffs = _STO3G_COEF * (2.0 * alphas / np.pi) ** 0.75
        # renormalize the contraction to unit self-overlap
        s = 0.0
        for a, ca in zip(alphas, coeffs):
            for b, cb in zip(alphas, coeffs):
                s += ca * cb * (np.pi / (a + b)) ** 1.5
        basis.append((c, alphas, coeffs / math.sqrt(s)))
        charges.append(z)
    return basis, np.asarray(charges)


def h_chain_geometry(n, r):
    """Linear H_n chain with uniform spacing ``r`` (bohr)."""
    centers = np.zeros((n, 3))
    centers[:, 2] = r * np.arange(n)
    return ["H"] * n, centers


# --------------------------------------------------------------------- #
# Primitive integrals (s-type closed forms)                              #
# --------------------------------------------------------------------- #

def _boys0(t):
    """Boys function ``F0(t) = (1/2) sqrt(pi/t) erf(sqrt(t))``."""
    if t < 1e-12:
        return 1.0 - t / 3.0
    st = math.sqrt(t)
    return 0.5 * math.sqrt(math.pi / t) * math.erf(st)


def molecular_integrals(basis, charges, centers):
    """AO integrals over contracted s functions.

    Returns ``(S, hcore, eri, e_nuc)``: overlap, one-electron core
    Hamiltonian (kinetic + nuclear attraction), chemists'-notation
    ``(pq|rs)`` two-electron integrals, and the nuclear repulsion.
    """
    centers = np.asarray(centers, float).reshape(-1, 3)
    m = len(basis)
    S = np.zeros((m, m))
    T = np.zeros((m, m))
    V = np.zeros((m, m))
    for i, (ci, ai, di) in enumerate(basis):
        for j, (cj, aj, dj) in enumerate(basis):
            r2 = float(np.dot(ci - cj, ci - cj))
            for a, da in zip(ai, di):
                for b, db in zip(aj, dj):
                    p = a + b
                    mu = a * b / p
                    k = math.exp(-mu * r2) * (np.pi / p) ** 1.5
                    S[i, j] += da * db * k
                    T[i, j] += da * db * mu * (3.0 - 2.0 * mu * r2) * k
                    pc = (a * ci + b * cj) / p
                    for z, cn in zip(charges, centers):
                        t = p * float(np.dot(pc - cn, pc - cn))
                        V[i, j] -= (
                            da * db * z * (2.0 * np.pi / p)
                            * math.exp(-mu * r2) * _boys0(t)
                        )
    eri = np.zeros((m, m, m, m))
    for i, (ci, ai, di) in enumerate(basis):
        for j, (cj, aj, dj) in enumerate(basis):
            rij = float(np.dot(ci - cj, ci - cj))
            for k2, (ck, ak, dk) in enumerate(basis):
                for l2, (cl, al, dl) in enumerate(basis):
                    if (i, j, k2, l2) > (j, i, l2, k2):
                        continue  # fill (ij|kl)=(ji|lk) by symmetry below
                    rkl = float(np.dot(ck - cl, ck - cl))
                    val = 0.0
                    for a, da in zip(ai, di):
                        for b, db in zip(aj, dj):
                            p = a + b
                            kab = math.exp(-a * b / p * rij)
                            pab = (a * ci + b * cj) / p
                            for c, dc in zip(ak, dk):
                                for d, dd in zip(al, dl):
                                    q = c + d
                                    kcd = math.exp(-c * d / q * rkl)
                                    pcd = (c * ck + d * cl) / q
                                    t = (p * q / (p + q)) * float(
                                        np.dot(pab - pcd, pab - pcd)
                                    )
                                    val += (
                                        da * db * dc * dd
                                        * 2.0 * np.pi**2.5
                                        / (p * q * math.sqrt(p + q))
                                        * kab * kcd * _boys0(t)
                                    )
                    eri[i, j, k2, l2] = val
                    eri[j, i, l2, k2] = val
    # remaining 8-fold symmetry: (ij|kl) = (kl|ij) etc.
    eri = 0.5 * (eri + eri.transpose(2, 3, 0, 1))
    eri = 0.5 * (eri + eri.transpose(1, 0, 3, 2))
    e_nuc = 0.0
    for i in range(len(charges)):
        for j in range(i + 1, len(charges)):
            e_nuc += charges[i] * charges[j] / float(
                np.linalg.norm(centers[i] - centers[j])
            )
    return S, T + V, eri, e_nuc


# --------------------------------------------------------------------- #
# Mean field + basis transforms                                          #
# --------------------------------------------------------------------- #

def lowdin_orthogonal(S):
    """Symmetric orthogonalization ``X = S^(-1/2)``."""
    w, u = np.linalg.eigh(S)
    if np.min(w) < 1e-10:
        raise ValueError("overlap matrix is numerically singular")
    return np.einsum("pi,i,qi->pq", u, 1.0 / np.sqrt(w), u)


def restricted_hartree_fock(S, hcore, eri, n_elec, iters=200, tol=1e-12):
    """Closed-shell SCF.  Returns ``(e_elec, C, eps)`` — the electronic
    RHF energy, MO coefficients (AO x MO), and orbital energies."""
    if n_elec % 2:
        raise ValueError("restricted_hartree_fock needs an even n_elec")
    nocc = n_elec // 2
    x = lowdin_orthogonal(S)
    f = hcore.copy()
    e_old = np.inf
    c = None
    for _ in range(iters):
        fp = np.einsum("pq,pr,rs->qs", x, f, x)
        _, cp = np.linalg.eigh(fp)
        c = np.einsum("pq,qr->pr", x, cp)
        occ = c[:, :nocc]
        dens = 2.0 * np.einsum("pi,qi->pq", occ, occ)
        g = np.einsum("rs,pqrs->pq", dens, eri) - 0.5 * np.einsum(
            "rs,prqs->pq", dens, eri
        )
        f = hcore + g
        e = 0.5 * np.einsum("pq,pq->", dens, hcore + f)
        if abs(e - e_old) < tol:
            break
        e_old = e
    fp = np.einsum("pq,pr,rs->qs", x, f, x)
    eps, cp = np.linalg.eigh(fp)
    c = np.einsum("pq,qr->pr", x, cp)
    return float(e), c, eps


def unrestricted_hartree_fock(S, hcore, eri, n_alpha, n_beta,
                              iters=400, tol=1e-12, mix=0.25 * np.pi):
    """Open-shell SCF with independent alpha/beta orbital sets.

    The initial guess mixes the core-Hamiltonian HOMO/LUMO by ``mix``
    with OPPOSITE rotations for the two spins — the standard
    deterministic symmetry breaking that lets stretched closed-shell
    systems find the broken (Coulson-Fischer) solution where it exists:
    at dissociation UHF sits near the correct fragment limit while RHF
    is ~0.2 Ha high on H2.  Where the restricted solution is the true
    minimum (equilibrium geometries) the iteration heals back to it.

    Returns ``(e_elec, (ca, cb), (eps_a, eps_b))``.  For DMRG
    downstream use :func:`uhf_natural_orbitals` — the spin-orbital
    compilation assumes ONE spatial basis for both spins.
    """
    x = lowdin_orthogonal(S)

    def diag(f):
        fp = np.einsum("pq,pr,rs->qs", x, f, x)
        eps, cp = np.linalg.eigh(fp)
        return eps, np.einsum("pq,qr->pr", x, cp)

    def rotate(c, nocc, angle):
        if not (0 < nocc < c.shape[1]) or angle == 0.0:
            return c
        out = c.copy()
        h_col, l_col = c[:, nocc - 1], c[:, nocc]
        out[:, nocc - 1] = np.cos(angle) * h_col + np.sin(angle) * l_col
        out[:, nocc] = -np.sin(angle) * h_col + np.cos(angle) * l_col
        return out

    _, c0 = diag(hcore)
    ca = rotate(c0, n_alpha, mix)
    cb = rotate(c0, n_beta, -mix)
    da = np.einsum("pi,qi->pq", ca[:, :n_alpha], ca[:, :n_alpha])
    db = np.einsum("pi,qi->pq", cb[:, :n_beta], cb[:, :n_beta])
    e_old = np.inf
    fa = fb = hcore
    for _ in range(iters):
        j = np.einsum("rs,pqrs->pq", da + db, eri)
        ka = np.einsum("rs,prqs->pq", da, eri)
        kb = np.einsum("rs,prqs->pq", db, eri)
        fa = hcore + j - ka
        fb = hcore + j - kb
        e = 0.5 * (
            np.einsum("pq,pq->", da, hcore + fa)
            + np.einsum("pq,pq->", db, hcore + fb)
        )
        if abs(e - e_old) < tol:
            break
        e_old = e
        _, ca = diag(fa)
        _, cb = diag(fb)
        da = np.einsum("pi,qi->pq", ca[:, :n_alpha], ca[:, :n_alpha])
        db = np.einsum("pi,qi->pq", cb[:, :n_beta], cb[:, :n_beta])
    eps_a, ca = diag(fa)
    eps_b, cb = diag(fb)
    return float(e), (ca, cb), (eps_a, eps_b)


def uhf_natural_orbitals(S, ca, cb, n_alpha, n_beta):
    """One spatial basis from the UHF total density (UNO).

    Diagonalizes the spin-summed density in the orthogonal basis;
    columns are ordered by DESCENDING occupation, so the leading
    ``n_elec/2``-ish orbitals are the natural active space.  Returns
    ``(c_no, occs)`` — feed ``c_no`` to :func:`mo_transform` and run
    the stock (single-basis) DMRG/FCI machinery.
    """
    x = lowdin_orthogonal(S)
    d_tot = (
        np.einsum("pi,qi->pq", ca[:, :n_alpha], ca[:, :n_alpha])
        + np.einsum("pi,qi->pq", cb[:, :n_beta], cb[:, :n_beta])
    )
    # into the Lowdin (orthonormal) frame: D_ortho = X^-1 D X^-T with
    # X = S^(-1/2), i.e. conjugate by S X = S^(1/2)
    sx = np.linalg.inv(x)
    d_o = np.einsum("pi,pq,qj->ij", sx.T, d_tot, sx.T)
    occs, u = np.linalg.eigh(d_o)
    occs, u = occs[::-1], u[:, ::-1]
    return np.einsum("pq,qr->pr", x, u), occs


def mo_transform(hcore, eri, c):
    """Rotate AO integrals into the (orthonormal) column basis of ``c``."""
    h1 = np.einsum("pq,pi,qj->ij", hcore, c, c)
    g = np.einsum("pqrs,pi->iqrs", eri, c)
    g = np.einsum("iqrs,qj->ijrs", g, c)
    g = np.einsum("ijrs,rk->ijks", g, c)
    g = np.einsum("ijks,sl->ijkl", g, c)
    return h1, g


# --------------------------------------------------------------------- #
# Second quantization -> OpSum -> MPO                                    #
# --------------------------------------------------------------------- #

def chemistry_terms(h1, eri, cutoff=1e-12):
    """Spin-orbital term list ``[(coef, (op, site, ...)), ...]``.

    Spin orbitals interleave on the chain: site ``2p + sigma`` with
    ``sigma in (0, 1)`` = (up, down).  Two-body terms carry the operator
    order ``a+_ps a+_rt a_st a_qs`` (chemists' ``(pq|rs)`` with the
    exchange-safe 1/2 prefactor); terms with a repeated creation or a
    repeated annihilation mode vanish identically and are skipped.
    """
    h1 = np.asarray(h1)
    eri = np.asarray(eri)
    m = h1.shape[0]
    terms = []
    for p in range(m):
        for q in range(m):
            if abs(h1[p, q]) <= cutoff:
                continue
            for sg in (0, 1):
                terms.append(
                    (h1[p, q],
                     ("Cdag", 2 * p + sg, "C", 2 * q + sg))
                )
    for p in range(m):
        for q in range(m):
            for r in range(m):
                for s in range(m):
                    g = eri[p, q, r, s]
                    if abs(g) <= 2.0 * cutoff:
                        continue
                    for sg in (0, 1):
                        for tu in (0, 1):
                            i1, i2 = 2 * p + sg, 2 * r + tu
                            i3, i4 = 2 * s + tu, 2 * q + sg
                            if i1 == i2 or i3 == i4:
                                continue
                            terms.append(
                                (0.5 * g,
                                 ("Cdag", i1, "Cdag", i2,
                                  "C", i3, "C", i4))
                            )
    return terms


def chemistry_op_sum(h1, eri, cutoff=1e-12):
    """The full electronic Hamiltonian as one :class:`OpSum`."""
    out = OpSum()
    for coef, ops in chemistry_terms(h1, eri, cutoff):
        out.add(coef, *ops)
    return out



def chemistry_mpo(h1, eri, cutoff=1e-12, chunk=300, max_bond=None,
                  compress_cutoff=1e-12, symmetric=False, device=None):
    """Compile the electronic Hamiltonian to a compressed :class:`MPO` on
    ``device`` (default ``cuda``).

    Terms are compiled ``chunk`` at a time (each chunk's exact finite-state
    machine is O(chunk) wide, compiled on the host) and folded with
    ``mpo_sum`` + ``compress_mpo`` on the device, so peak memory never sees
    the full O(M^4)-term automaton.  ``max_bond`` optionally caps the
    operator bond (default: exact to ``compress_cutoff``).

    ``symmetric=True`` compresses charge-blocked
    (:func:`~.u1.compress_mpo_u1` with occupation charges ``(0, 1)``): the
    result is channel-charge-definite, the form :func:`chemistry_dmrg_u1`
    requires.
    """
    terms = chemistry_terms(h1, eri, cutoff)
    if not terms:
        raise ValueError("no terms above cutoff")
    device = resolve_device(device)
    n_sites = 2 * np.asarray(h1).shape[0]
    charges = (0, 1) if symmetric else None

    def compile_chunk(chunk_terms):
        acc = OpSum()
        for coef, ops in chunk_terms:
            acc.add(coef, *ops)
        return op_sum_mpo(acc, n_sites, cutoff=compress_cutoff,
                          phys_charges=charges, device=device)

    mpo = None
    for lo in range(0, len(terms), chunk):
        part = compile_chunk(terms[lo:lo + chunk])
        if mpo is None:
            mpo = part
        elif symmetric:
            from .u1 import compress_mpo_u1

            mpo, _ = compress_mpo_u1(mpo_sum(mpo, part), charges,
                                     cutoff=compress_cutoff, max_bond=max_bond)
        else:
            comp, log_norm, _ = compress_mpo(mpo_sum(mpo, part),
                                             max_bond=max_bond,
                                             cutoff=compress_cutoff)
            mpo = MPO(comp.cores, comp.left * math.exp(log_norm), comp.right)
    return mpo


def chemistry_dmrg_u1(h1, eri, n_elec, bond_dim=32, sweeps=8, mpo=None,
                      cutoff=1e-12, chunk=300, noise=1e-2, generator=None,
                      device=None):
    """STRUCTURALLY particle-conserving chemistry DMRG.

    The charge-masked route: the operator compiles charge-blocked
    (channel-definite), the state lives on ``N = n_elec`` masks (``cores *
    (1 - masks) == 0`` identically along the whole optimization), and the
    sweeps warm-start from the Hartree-Fock determinant's charge walk plus
    ``noise`` times masked draws from ``generator``.  Runs on ``mpo``'s
    device when one is passed, else on ``device`` (default ``cuda``).

    Returns ``(e_elec, mps, mpo, masks)``.
    """
    from .u1 import determinant_mps_u1, dmrg_u1, u1_bond_charges

    m = np.asarray(h1).shape[0]
    n_sites = 2 * m
    if mpo is None:
        mpo = chemistry_mpo(h1, eri, cutoff=cutoff, chunk=chunk, symmetric=True,
                            device=device)
    occ = np.zeros(n_sites, int)
    occ[:n_elec] = 1
    bond_charges = u1_bond_charges(n_sites, (0, 1), n_elec, bond_dim)
    mps0 = determinant_mps_u1(occ, bond_charges, (0, 1), generator=generator,
                              noise=noise, device=mpo.cores.device)
    mps, energy, _, masks = dmrg_u1(mpo, n_elec, bond_dim, phys_charges=(0, 1),
                                    sweeps=sweeps, mps0=mps0)
    return float(energy), mps, mpo, masks


# --------------------------------------------------------------------- #
# DMRG driver                                                            #
# --------------------------------------------------------------------- #

def determinant_mps(occupations, bond_dim, dtype=torch.float64, device=None):
    """Product-state MPS for an occupation bit pattern (padded bonds), on
    ``device`` (default ``cuda``).

    Starting DMRG from a determinant keeps the whole sweep inside its
    particle-number sector: H conserves N and the two-site Lanczos Krylov
    spaces are built from in-sector vectors.
    """
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    occ = np.asarray(occupations, int)
    n = occ.shape[0]
    cores = np.zeros((n, 2, bond_dim, bond_dim))
    cores[np.arange(n), occ, 0, 0] = 1.0
    e0 = np.zeros(bond_dim)
    e0[0] = 1.0
    return MPS(*(torch.from_numpy(a).to(device, dtype)
                 for a in (cores, e0, e0.copy())))


def chemistry_dmrg(h1, eri, n_elec, max_bond=32, sweeps=8, mpo=None,
                   cutoff=1e-12, chunk=300, lam=10.0, device=None):
    """Ground-state DMRG for the electronic Hamiltonian ``(h1, eri)``.

    The electron count is pinned energetically: with occupied = index 1,
    ``N = n_sites/2 - Sz_total``, so the :func:`~.dmrg.dmrg_sector`
    magnetization penalty pins N exactly; the reported energy is the TRUE
    Rayleigh quotient of H (penalty excluded).

    Args:
        h1, eri: orthonormal-basis integrals (e.g. from :func:`mo_transform`
            with RHF orbitals).
        n_elec: electron count; sets the penalty target and the initial
            determinant (lowest ``n_elec`` spin orbitals in site order).
        mpo: optionally a precompiled operator (skips :func:`chemistry_mpo`;
            the solve then runs on its device).
        lam: sector-penalty weight in hartree (``0`` disables).
        device: where to compile and solve without ``mpo`` (default
            ``cuda``).

    Returns:
        ``(e_elec, mps, mpo)``: electronic energy, the state, the operator.
    """
    from .dmrg import dmrg_sector

    m = np.asarray(h1).shape[0]
    n_sites = 2 * m
    if n_elec > n_sites:
        raise ValueError("more electrons than spin orbitals")
    if mpo is None:
        mpo = chemistry_mpo(h1, eri, cutoff=cutoff, chunk=chunk, max_bond=None,
                            device=device)
    occ = np.zeros(n_sites, int)
    occ[:n_elec] = 1
    mps0 = determinant_mps(occ, max_bond, device=mpo.cores.device)
    if lam:
        q = 0.5 * n_sites - n_elec  # Sz target <-> N target
        ground, energy, _ = dmrg_sector(mpo, mps0, q, lam=lam,
                                        max_bond=max_bond, sweeps=sweeps)
        return float(energy), ground, mpo
    ground, energy, _ = dmrg(mpo, mps0, max_bond=max_bond, sweeps=sweeps)
    return float(energy), ground, mpo


def orbital_ordering(h1, eri):
    """Fiedler ordering of the orbitals by exchange connectivity.

    Chemistry DMRG converges at much smaller bond when strongly
    entangled orbitals sit close on the chain; the standard heuristic
    orders by the Fiedler vector (second-lowest Laplacian eigenvector)
    of the exchange graph ``K_pq = (pq|qp)``.  Returns a permutation —
    apply with :func:`permute_orbitals` (all spectra are invariant;
    only bond growth changes).
    """
    eri = np.asarray(eri)
    m = eri.shape[0]
    k = np.abs(np.einsum("pqqp->pq", eri))
    np.fill_diagonal(k, 0.0)
    lap = np.diag(k.sum(1)) - k
    _, vecs = np.linalg.eigh(lap)
    return np.argsort(vecs[:, 1], kind="stable")


def permute_orbitals(h1, eri, perm):
    """Reorder the spatial-orbital basis of the integral tensors."""
    perm = np.asarray(perm, int)
    h1 = np.asarray(h1)[np.ix_(perm, perm)]
    eri = np.asarray(eri)[np.ix_(perm, perm, perm, perm)]
    return h1, eri



def chemistry_excited(h1, eri, n_elec, n_states, max_bond=32, sweeps=8,
                      lam=10.0, cutoff=1e-12, chunk=300, generator=None,
                      device=None):
    """Lowest ``n_states`` electronic states in the ``n_elec`` sector by
    sequential orthogonal DMRG (:func:`~.dmrg.dmrg_excited`, later starts
    drawn from ``generator``) on the sector-penalized operator; the
    energies are Rayleigh quotients of the bare Hamiltonian.

    Returns ``(energies, states)``.
    """
    from .dmrg import dmrg_excited, total_sz_penalty_mpo
    from .mpo import rayleigh

    m = np.asarray(h1).shape[0]
    n_sites = 2 * m
    h_mpo = chemistry_mpo(h1, eri, cutoff=cutoff, chunk=chunk, device=device)
    dev = h_mpo.cores.device
    pen = total_sz_penalty_mpo(n_sites, 0.5 * n_sites - n_elec, lam=lam,
                               device=dev)
    h_tot = mpo_sum(h_mpo, pen)
    occ = np.zeros(n_sites, int)
    occ[:n_elec] = 1
    mps0 = determinant_mps(occ, max_bond, device=dev)
    states, _ = dmrg_excited(h_tot, mps0, n_states, max_bond=max_bond,
                             sweeps=sweeps, generator=generator)
    energies = [rayleigh(h_mpo, s) for s in states]
    return np.asarray(energies), states


# --------------------------------------------------------------------- #
# Transition properties                                                  #
# --------------------------------------------------------------------- #

def one_body_mpo(h1, cutoff=1e-12, device=None):
    """Spin-summed one-body operator ``sum_pq,s h_pq a+_ps a_qs`` as an MPO on
    the interleaved spin-orbital chain (e.g. a dipole component in the MO
    basis), on ``device`` (default ``cuda``)."""
    h1 = np.asarray(h1)
    m = h1.shape[0]
    acc = OpSum()
    for p in range(m):
        for q in range(m):
            if abs(h1[p, q]) <= cutoff:
                continue
            for sg in (0, 1):
                acc.add(h1[p, q], "Cdag", 2 * p + sg, "C", 2 * q + sg)
    return op_sum_mpo(acc, 2 * m, device=device)


def transition_element(mpo, bra, ket):
    """Normalized cross-state sandwich ``<bra|O|ket> / (|bra| |ket|)``: the
    MPO applied exactly (bond ``W * D``) and paired against the bra with
    the stabilized overlap, the log registers combined before
    exponentiating.  Returns a Python ``complex``."""
    from .boundary import apply_mpo_to_mps

    phi = apply_mpo_to_mps(mpo, ket)
    num_v, num_l = bra.inner(phi)
    nb_v, nb_l = bra.norm_squared()
    nk_v, nk_l = ket.norm_squared()
    scale = float(torch.exp(torch.as_tensor(num_l - 0.5 * (nb_l + nk_l))))
    return complex((num_v / torch.sqrt(nb_v * nk_v)).item()) * scale


def oscillator_strengths(energies, states, d_mo):
    """Length-gauge oscillator strengths from the ground state,
    ``f_n = (2/3) (E_n - E_0) sum_c |<0| r_c |n>|^2``, with MO-basis dipole
    matrices ``d_mo (3, M, M)``; the dipole MPOs go to the states' device.

    Returns ``(f, tdip)``: strengths ``(n_states,)`` (``f[0] = 0``) and
    transition moments ``tdip (n_states, 3)``.
    """
    d_mo = np.asarray(d_mo)
    # identically-zero components (molecular symmetry axes) contribute
    # nothing, and have no operator to compile
    live = [c for c in range(3) if np.abs(d_mo[c]).max() > 1e-12]
    ground = states[0]
    mpos = {c: one_body_mpo(d_mo[c], device=ground.cores.device) for c in live}
    tdip = np.zeros((len(states), 3), complex)
    for n, state in enumerate(states[1:], start=1):
        for c in live:
            tdip[n, c] = transition_element(mpos[c], ground, state)
    de = np.asarray(energies) - energies[0]
    # only |t|^2 enters: the per-state phase is a gauge
    f = (2.0 / 3.0) * de * np.sum(np.abs(tdip) ** 2, axis=1)
    return f, tdip


# --------------------------------------------------------------------- #
# Reduced density matrices / natural orbitals                            #
# --------------------------------------------------------------------- #

def _opsum_expectation(mps, terms, n_sites):
    """Normalized ``<mps| sum_t terms |mps>`` via one small MPO on the
    state's device."""
    acc = OpSum()
    for coef, ops in terms:
        acc.add(coef, *ops)
    mpo = op_sum_mpo(acc, n_sites, device=mps.cores.device)
    num_v, num_l = mpo.expectation(mps)
    den_v, den_l = mps.norm_squared()
    return (float(torch.real(num_v)) / float(torch.real(den_v))
            * float(np.exp(float(num_l - den_l))))


def one_rdm(mps):
    """Spin-traced one-electron RDM ``gamma_pq = sum_s <a+_ps a_qs>``, one
    tiny MPO expectation per matrix element (Jordan-Wigner strings inserted
    by the OpSum compiler)."""
    n_sites = int(mps.cores.shape[0])
    m = n_sites // 2
    gamma = np.zeros((m, m))
    for p in range(m):
        for q in range(p, m):
            terms = [(1.0, ("Cdag", 2 * p + sg, "C", 2 * q + sg))
                     for sg in (0, 1)]
            gamma[p, q] = _opsum_expectation(mps, terms, n_sites)
            gamma[q, p] = gamma[p, q]  # real wavefunctions
    return gamma


def two_rdm(mps):
    """Spin-traced two-electron RDM in the Hamiltonian's operator order,
    ``Gamma_pqrs = sum_st <a+_ps a+_rt a_st a_qs>`` (contracts against
    chemists' ``(pq|rs)`` with the 1/2 prefactor, :func:`rdm_energy`).
    O(M^4) small MPO expectations; oracle-scale."""
    n_sites = int(mps.cores.shape[0])
    m = n_sites // 2
    gam2 = np.zeros((m, m, m, m))
    for p in range(m):
        for q in range(m):
            for r in range(m):
                for s in range(m):
                    terms = []
                    for sg in (0, 1):
                        for tu in (0, 1):
                            i1, i2 = 2 * p + sg, 2 * r + tu
                            i3, i4 = 2 * s + tu, 2 * q + sg
                            if i1 == i2 or i3 == i4:
                                continue
                            terms.append((1.0, ("Cdag", i1, "Cdag", i2,
                                                "C", i3, "C", i4)))
                    if terms:
                        gam2[p, q, r, s] = _opsum_expectation(mps, terms,
                                                              n_sites)
    return gam2


def rdm_energy(h1, eri, gamma, gam2):
    """Electronic energy from the RDMs:
    ``E = sum h_pq gamma_pq + 1/2 sum (pq|rs) Gamma_pqrs``."""
    return float(
        np.einsum("pq,pq->", np.asarray(h1), gamma)
        + 0.5 * np.einsum("pqrs,pqrs->", np.asarray(eri), gam2)
    )


def natural_occupations(mps):
    """Eigenvalues of the spin-traced 1-RDM, descending (sum = N)."""
    w = np.linalg.eigvalsh(one_rdm(mps))
    return w[::-1]



def ancilla_lift_mpo(mpo):
    """Lift a system MPO onto the interleaved purification chain: system
    site ``k`` maps to position ``2k``, its ancilla ``2k + 1`` gets an
    identity core in EVERY virtual channel (so a JW string runs over system
    modes only)."""
    cores = mpo.cores
    n, d, _, w, _ = cores.shape
    eye = (torch.eye(d, dtype=cores.dtype, device=cores.device)[None, :, :, None, None]
           * torch.eye(w, dtype=cores.dtype, device=cores.device)[None, None, None])
    lifted = torch.stack([cores, eye.expand((n, d, d, w, w))], dim=1)
    return MPO(lifted.reshape(2 * n, d, d, w, w), mpo.left, mpo.right)


def infinite_temperature_purification(n_sites, d=2, dtype=torch.float64,
                                      device=None):
    """``(sum_s |s>|s> / sqrt(d))^n`` on the interleaved chain, the identity
    density matrix's purification (the beta = 0 state), on ``device``
    (default ``cuda``)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    bond = d
    cores = np.zeros((2 * n_sites, d, bond, bond))
    for k in range(n_sites):
        for s in range(d):
            cores[2 * k, s, 0, s] = 1.0 / np.sqrt(d)
            cores[2 * k + 1, s, s, 0] = 1.0
    e0 = np.zeros(bond)
    e0[0] = 1.0
    return MPS(*(torch.from_numpy(a).to(device, dtype)
                 for a in (cores, e0, e0.copy())))


def chemistry_thermal(h1, eri, beta, mu=0.0, max_bond=32, n_steps=40, mpo=None,
                      cutoff=1e-12, chunk=300, device=None):
    """Grand-canonical thermal state ``rho ~ exp(-beta (H - mu N))`` by
    purification: the interleaved ancilla chain starts at the beta = 0
    product and evolves by ``exp(-beta K / 2)`` with the W^II propagator of
    the LIFTED grand-canonical operator.  Runs on ``mpo``'s device when one
    is passed, else on ``device`` (default ``cuda``).

    Returns ``(energy, n_elec, psi, h_lifted)``: ``<H>_beta`` (bare H),
    ``<N>_beta``, the purification MPS and the lifted Hamiltonian.
    """
    from .mpo import deparallelize_mpo, rayleigh
    from .mpo_evolution import mpo_evolve

    h1 = np.asarray(h1)
    m = h1.shape[0]
    if mpo is None:
        mpo = chemistry_mpo(h1, eri, cutoff=cutoff, chunk=chunk, device=device)
    dev = mpo.cores.device
    h_lift = ancilla_lift_mpo(mpo)
    # K = H - mu N; the W^II builder needs the TRIANGULAR automaton
    # (compress=False), reduced by exact deparallelisation instead
    k_op = chemistry_op_sum(h1 - mu * np.eye(m), eri, cutoff=cutoff)
    k_mpo = deparallelize_mpo(op_sum_mpo(k_op, 2 * m, compress=False,
                                         device=dev))
    k_lift = ancilla_lift_mpo(k_mpo)
    n_ops = OpSum()
    for p in range(2 * m):
        n_ops.add(1.0, "N", p)
    n_lift = ancilla_lift_mpo(op_sum_mpo(n_ops, 2 * m, device=dev))
    psi = infinite_temperature_purification(2 * m, device=dev)
    psi = mpo_evolve(psi, k_lift, beta / 2.0, n_steps, imag=True,
                     max_bond=max_bond)
    return (rayleigh(h_lift, psi), rayleigh(n_lift, psi), psi, h_lift)


# --------------------------------------------------------------------- #
# Independent FCI oracle                                                 #
# --------------------------------------------------------------------- #

def _apply_ops(ops, det):
    """Apply ``[(kind, mode), ...]`` RIGHT-TO-LEFT to a determinant
    bitstring.  Returns ``(sign, det')`` or ``None``.  Sign = parity of
    occupied modes below the acted mode (modes ordered by site index,
    occupied = bit set)."""
    sign = 1
    for kind, k in reversed(ops):
        occ = (det >> k) & 1
        if kind == "c":
            if not occ:
                return None
        else:
            if occ:
                return None
        if (det & ((1 << k) - 1)).bit_count() & 1:
            sign = -sign
        det ^= 1 << k
    return sign, det


def fci_ground(h1, eri, n_elec=None, k=1):
    """Exact diagonalization in the determinant basis.

    A deliberately independent arbiter for the OpSum/MPO pipeline: bare
    bit-string determinants with explicit fermionic sign bookkeeping —
    no shared code with the compiler.  ``n_elec=None`` diagonalizes the
    full Fock space (checks which sector holds the global minimum).

    Returns the electronic ground energy (or the ``k`` lowest, sorted,
    if ``k > 1``).  Practical up to ~5 spatial orbitals.
    """
    h1 = np.asarray(h1)
    eri = np.asarray(eri)
    m = h1.shape[0]
    n_so = 2 * m
    if n_so > 14:
        raise ValueError("fci_ground is a small-system oracle (2M <= 14)")
    dets = [
        b for b in range(1 << n_so)
        if n_elec is None or b.bit_count() == n_elec
    ]
    index = {b: i for i, b in enumerate(dets)}
    ham = np.zeros((len(dets), len(dets)))

    one_body = [
        (h1[p, q], [("cdag", 2 * p + sg), ("c", 2 * q + sg)])
        for p in range(m) for q in range(m) for sg in (0, 1)
        if abs(h1[p, q]) > 1e-14
    ]
    two_body = []
    for p in range(m):
        for q in range(m):
            for r in range(m):
                for s in range(m):
                    g = eri[p, q, r, s]
                    if abs(g) <= 1e-14:
                        continue
                    for sg in (0, 1):
                        for tu in (0, 1):
                            i1, i2 = 2 * p + sg, 2 * r + tu
                            i3, i4 = 2 * s + tu, 2 * q + sg
                            if i1 == i2 or i3 == i4:
                                continue
                            two_body.append(
                                (0.5 * g,
                                 [("cdag", i1), ("cdag", i2),
                                  ("c", i3), ("c", i4)])
                            )

    for det in dets:
        col = index[det]
        for coef, ops in one_body + two_body:
            hit = _apply_ops(ops, det)
            if hit is None:
                continue
            sign, out = hit
            row = index.get(out)
            if row is not None:
                ham[row, col] += sign * coef
    evals = np.linalg.eigvalsh(ham)
    return float(evals[0]) if k == 1 else evals[:k]


def fci_rdms(h1, eri, n_elec):
    """Spin-traced 1- and 2-RDMs of the FCI ground state — the
    independent arbiter for :func:`one_rdm` / :func:`two_rdm` (same
    determinant-basis sign bookkeeping as :func:`fci_ground`, no MPS
    code involved)."""
    h1 = np.asarray(h1)
    eri = np.asarray(eri)
    m = h1.shape[0]
    n_so = 2 * m
    dets = [b for b in range(1 << n_so) if b.bit_count() == n_elec]
    index = {b: i for i, b in enumerate(dets)}
    ham = np.zeros((len(dets), len(dets)))
    ops_list = []
    for p in range(m):
        for q in range(m):
            for sg in (0, 1):
                if abs(h1[p, q]) > 1e-14:
                    ops_list.append(
                        (h1[p, q],
                         [("cdag", 2 * p + sg), ("c", 2 * q + sg)])
                    )
    for p in range(m):
        for q in range(m):
            for r in range(m):
                for s in range(m):
                    g = eri[p, q, r, s]
                    if abs(g) <= 1e-14:
                        continue
                    for sg in (0, 1):
                        for tu in (0, 1):
                            i1, i2 = 2 * p + sg, 2 * r + tu
                            i3, i4 = 2 * s + tu, 2 * q + sg
                            if i1 == i2 or i3 == i4:
                                continue
                            ops_list.append(
                                (0.5 * g,
                                 [("cdag", i1), ("cdag", i2),
                                  ("c", i3), ("c", i4)])
                            )
    for det in dets:
        col = index[det]
        for coef, ops in ops_list:
            hit = _apply_ops(ops, det)
            if hit is not None and hit[1] in index:
                ham[index[hit[1]], col] += hit[0] * coef
    _, vecs = np.linalg.eigh(ham)
    psi = vecs[:, 0]

    def expect(ops):
        out = 0.0
        for det in dets:
            hit = _apply_ops(ops, det)
            if hit is not None and hit[1] in index:
                out += psi[index[hit[1]]] * hit[0] * psi[index[det]]
        return out

    gamma = np.zeros((m, m))
    for p in range(m):
        for q in range(m):
            gamma[p, q] = sum(
                expect([("cdag", 2 * p + sg), ("c", 2 * q + sg)])
                for sg in (0, 1)
            )
    gam2 = np.zeros((m, m, m, m))
    for p in range(m):
        for q in range(m):
            for r in range(m):
                for s in range(m):
                    tot = 0.0
                    for sg in (0, 1):
                        for tu in (0, 1):
                            i1, i2 = 2 * p + sg, 2 * r + tu
                            i3, i4 = 2 * s + tu, 2 * q + sg
                            if i1 == i2 or i3 == i4:
                                continue
                            tot += expect(
                                [("cdag", i1), ("cdag", i2),
                                 ("c", i3), ("c", i4)]
                            )
                    gam2[p, q, r, s] = tot
    return gamma, gam2
