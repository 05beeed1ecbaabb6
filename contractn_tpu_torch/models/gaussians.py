"""General angular-momentum Gaussian integrals (McMurchie-Davidson).

Counterpart of ``contractn_tpu/models/gaussians.py``, kept as this package's
own copy: like the reference it is host numpy, the one-off setup of the
chemistry solves (:mod:`.chemistry`), whose many-body part runs on the
device.  Overlap, kinetic, nuclear attraction and electron repulsion over
contracted Cartesian Gaussians of arbitrary angular momentum:

* **Hermite expansion**: the product of two 1D Cartesian Gaussians is a
  finite sum of Hermite Gaussians, ``G_i(a,A) G_j(b,B) =
  sum_t E_t^{ij} Lambda_t(p,P)``, with ``E`` from the standard two-term
  upward recursion (:func:`hermite_expansion`);
* **Hermite Coulomb integrals** ``R^0_{tuv}`` from the auxiliary-index
  downward recursion seeded by the Boys function ``F_n``
  (:func:`hermite_coulomb`, :func:`boys`);
* every integral class is then a small tensor contraction of ``E`` tables
  (and ``R`` tables for the Coulomb classes).

STO-3G data: the universal 3-Gaussian least-squares fits to zeta=1 Slater
1s/2sp functions (Hehre-Stewart-Pople), scaled per element by the standard
zeta values.
"""

import math

import numpy as np

__all__ = [
    "boys",
    "hermite_expansion",
    "hermite_coulomb",
    "overlap_prim",
    "kinetic_prim",
    "nuclear_prim",
    "eri_prim",
    "primitive_norm",
    "sto3g_shell_basis",
    "molecular_integrals_general",
    "freeze_core",
    "dipole_prim",
    "dipole_integrals",
    "dipole_moment",
]


# --------------------------------------------------------------------- #
# Boys function                                                          #
# --------------------------------------------------------------------- #

def boys(m_max, t):
    """``F_m(t)`` for ``m = 0..m_max`` (ascending array).

    Series evaluation at the HIGHEST order plus the downward recursion
    ``F_{m-1} = (2t F_m + e^-t) / (2m - 1)`` — downward is stable (the
    upward direction loses digits for small ``t``).  All series terms
    are positive, so no cancellation anywhere.
    """
    t = float(t)
    out = np.empty(m_max + 1)
    if t < 1e-13:
        for m in range(m_max + 1):
            out[m] = 1.0 / (2 * m + 1) - t / (2 * m + 3)
        return out
    if t > 35.0:
        # asymptotic F0 (erf(sqrt t) = 1 to < 1e-16 here), but carry
        # the exact e^-t term through the upward recursion
        # F_m = ((2m-1) F_{m-1} - e^-t) / (2t): the relative weight of
        # the dropped term grows with m, which would degrade d/f-shell
        # integrals near t ~ 35 if neglected.  Upward is stable at
        # large t (division by 2t damps any F0 error).
        et = math.exp(-t)
        out[0] = 0.5 * math.sqrt(math.pi / t)
        for m in range(1, m_max + 1):
            out[m] = ((2 * m - 1) * out[m - 1] - et) / (2.0 * t)
        return out
    # F_m(t) = e^-t sum_k (2t)^k (2m-1)!! / (2m+2k+1)!!
    term = 1.0 / (2 * m_max + 1)
    total = term
    k = 0
    while term > 1e-17 * total:
        k += 1
        term *= 2.0 * t / (2 * m_max + 2 * k + 1)
        total += term
    et = math.exp(-t)
    out[m_max] = et * total
    for m in range(m_max, 0, -1):
        out[m - 1] = (2.0 * t * out[m] + et) / (2 * m - 1)
    return out


# --------------------------------------------------------------------- #
# Hermite machinery                                                      #
# --------------------------------------------------------------------- #

def hermite_expansion(la, lb, a, b, ax, bx):
    """``E[i, j, t]`` Hermite expansion table for one direction.

    ``E_t^{i+1,j} = E_{t-1}^{ij}/(2p) + X_PA E_t^{ij} + (t+1)
    E_{t+1}^{ij}`` (and the mirrored ``j`` step with ``X_PB``), seeded
    by the Gaussian product prefactor ``E_0^{00} = exp(-mu X_AB^2)``.
    """
    p = a + b
    mu = a * b / p
    qx = ax - bx
    px = (a * ax + b * bx) / p
    pa = px - ax
    pb = px - bx
    e = np.zeros((la + 1, lb + 1, la + lb + 1))
    e[0, 0, 0] = math.exp(-mu * qx * qx)
    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            if j == 0:
                src, step = e[i - 1, 0], pa
                hi = i - 1
            else:
                src, step = e[i, j - 1], pb
                hi = i + j - 1
            for t in range(i + j + 1):
                v = step * src[t] if t <= hi else 0.0
                if t >= 1:
                    v += src[t - 1] / (2.0 * p)
                if t + 1 <= hi:
                    v += (t + 1) * src[t + 1]
                e[i, j, t] = v
    return e


def hermite_coulomb(tmax, umax, vmax, p, pc):
    """``R^0_{tuv}`` table (shape ``(tmax+1, umax+1, vmax+1)``).

    Auxiliary-order recursion ``R^n_{t+1,uv} = t R^{n+1}_{t-1,uv} +
    X_PC R^{n+1}_{t,uv}`` (ditto u, v), seeded by ``R^n_{000} =
    (-2p)^n F_n(p |PC|^2)``.
    """
    order = tmax + umax + vmax
    f = boys(order, p * float(np.dot(pc, pc)))
    r = np.zeros((order + 1, tmax + 1, umax + 1, vmax + 1))
    scale = 1.0
    for n in range(order + 1):
        r[n, 0, 0, 0] = scale * f[n]
        scale *= -2.0 * p
    for total in range(1, order + 1):
        for t in range(min(total, tmax) + 1):
            for u in range(min(total - t, umax) + 1):
                v = total - t - u
                if v < 0 or v > vmax:
                    continue
                for n in range(order - total + 1):
                    if t > 0:
                        val = pc[0] * r[n + 1, t - 1, u, v]
                        if t > 1:
                            val += (t - 1) * r[n + 1, t - 2, u, v]
                    elif u > 0:
                        val = pc[1] * r[n + 1, t, u - 1, v]
                        if u > 1:
                            val += (u - 1) * r[n + 1, t, u - 2, v]
                    else:
                        val = pc[2] * r[n + 1, t, u, v - 1]
                        if v > 1:
                            val += (v - 1) * r[n + 1, t, u, v - 2]
                    r[n, t, u, v] = val
    return r[0]


# --------------------------------------------------------------------- #
# Primitive integrals (unnormalized Cartesian Gaussians)                 #
# --------------------------------------------------------------------- #

def overlap_prim(a, lmn1, pa, b, lmn2, pb):
    """``<G_lmn1(a, A) | G_lmn2(b, B)>`` (unnormalized primitives)."""
    p = a + b
    val = (math.pi / p) ** 1.5
    for d in range(3):
        e = hermite_expansion(lmn1[d], lmn2[d], a, b, pa[d], pb[d])
        val *= e[lmn1[d], lmn2[d], 0]
    return val


def kinetic_prim(a, lmn1, pa, b, lmn2, pb):
    """Kinetic energy ``<G1| -grad^2/2 |G2>`` via the overlap ladder:
    acting with ``d^2/dx^2`` on the ket raises/lowers its Cartesian
    power by 2, so T is a fixed combination of shifted overlaps."""
    lmn2 = tuple(lmn2)
    val = (a * (2 * sum(lmn1) + 3)
           * overlap_prim(a, lmn1, pa, b, lmn2, pb))
    for d in range(3):
        up = list(lmn1)
        up[d] += 2
        val -= 2.0 * a * a * overlap_prim(a, tuple(up), pa, b, lmn2, pb)
        ld = lmn1[d]
        if ld >= 2:
            dn = list(lmn1)
            dn[d] -= 2
            val -= 0.5 * ld * (ld - 1) * overlap_prim(
                a, tuple(dn), pa, b, lmn2, pb
            )
    return val


def nuclear_prim(a, lmn1, pa, b, lmn2, pb, pc):
    """Nuclear attraction ``<G1| 1/|r - C| |G2>`` (positive; callers
    apply the ``-Z`` charge factor)."""
    p = a + b
    pp = (a * np.asarray(pa, float) + b * np.asarray(pb, float)) / p
    es = [
        hermite_expansion(lmn1[d], lmn2[d], a, b, pa[d], pb[d])
        for d in range(3)
    ]
    r = hermite_coulomb(
        lmn1[0] + lmn2[0], lmn1[1] + lmn2[1], lmn1[2] + lmn2[2],
        p, pp - np.asarray(pc, float),
    )
    val = 0.0
    for t in range(lmn1[0] + lmn2[0] + 1):
        for u in range(lmn1[1] + lmn2[1] + 1):
            for v in range(lmn1[2] + lmn2[2] + 1):
                val += (
                    es[0][lmn1[0], lmn2[0], t]
                    * es[1][lmn1[1], lmn2[1], u]
                    * es[2][lmn1[2], lmn2[2], v]
                    * r[t, u, v]
                )
    return 2.0 * math.pi / p * val


def eri_prim(a, lmn1, pa, b, lmn2, pb, c, lmn3, pc, d, lmn4, pd):
    """Chemists' ``(G1 G2 | G3 G4)`` over unnormalized primitives."""
    p = a + b
    q = c + d
    alpha = p * q / (p + q)
    pp = (a * np.asarray(pa, float) + b * np.asarray(pb, float)) / p
    qq = (c * np.asarray(pc, float) + d * np.asarray(pd, float)) / q
    e1 = [
        hermite_expansion(lmn1[dd], lmn2[dd], a, b, pa[dd], pb[dd])
        for dd in range(3)
    ]
    e2 = [
        hermite_expansion(lmn3[dd], lmn4[dd], c, d, pc[dd], pd[dd])
        for dd in range(3)
    ]
    lb = [lmn1[dd] + lmn2[dd] for dd in range(3)]
    lk = [lmn3[dd] + lmn4[dd] for dd in range(3)]
    r = hermite_coulomb(
        lb[0] + lk[0], lb[1] + lk[1], lb[2] + lk[2], alpha, pp - qq
    )
    # contract the ket Hermite indices first (with the (-1)^(tau+nu+phi)
    # parity from d/dQ = -d/dP), then the bra indices
    bx = np.array([e1[0][lmn1[0], lmn2[0], t] for t in range(lb[0] + 1)])
    by = np.array([e1[1][lmn1[1], lmn2[1], t] for t in range(lb[1] + 1)])
    bz = np.array([e1[2][lmn1[2], lmn2[2], t] for t in range(lb[2] + 1)])
    kx = np.array(
        [(-1.0) ** t * e2[0][lmn3[0], lmn4[0], t] for t in range(lk[0] + 1)]
    )
    ky = np.array(
        [(-1.0) ** t * e2[1][lmn3[1], lmn4[1], t] for t in range(lk[1] + 1)]
    )
    kz = np.array(
        [(-1.0) ** t * e2[2][lmn3[2], lmn4[2], t] for t in range(lk[2] + 1)]
    )
    val = 0.0
    for t in range(lb[0] + 1):
        for u in range(lb[1] + 1):
            for v in range(lb[2] + 1):
                blk = r[t:t + lk[0] + 1, u:u + lk[1] + 1, v:v + lk[2] + 1]
                val += (
                    bx[t] * by[u] * bz[v]
                    * float(np.einsum("tuv,t,u,v->", blk, kx, ky, kz))
                )
    return (
        2.0 * math.pi ** 2.5
        / (p * q * math.sqrt(p + q))
        * val
    )


def primitive_norm(a, lmn):
    """Self-overlap normalization of a Cartesian primitive."""
    l, m, n = lmn
    df = (
        _double_factorial(2 * l - 1)
        * _double_factorial(2 * m - 1)
        * _double_factorial(2 * n - 1)
    )
    return (
        (2.0 * a / math.pi) ** 0.75
        * math.sqrt((4.0 * a) ** (l + m + n) / df)
    )


def _double_factorial(n):
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return out


# --------------------------------------------------------------------- #
# STO-3G shells through fluorine                                         #
# --------------------------------------------------------------------- #

# universal least-squares fits to zeta = 1 Slater functions
_S1_ALPHA = np.array([2.227660584, 0.405771156, 0.109818])
_S1_COEF = np.array([0.154328967, 0.535328142, 0.444634542])
_SP2_ALPHA = np.array([0.994203, 0.231031, 0.0751386])
_S2_COEF = np.array([-0.09996723, 0.39951283, 0.70011547])
_P2_COEF = np.array([0.15591627, 0.60768372, 0.39195739])

#: symbol -> (Z, zeta_1s, zeta_2sp or None)
_SHELL_ZETAS = {
    "H": (1.0, 1.24, None),
    "He": (2.0, 2.0925, None),
    "Li": (3.0, 2.69, 0.80),
    "Be": (4.0, 3.68, 1.15),
    "B": (5.0, 4.68, 1.50),
    "C": (6.0, 5.67, 1.72),
    "N": (7.0, 6.67, 1.95),
    "O": (8.0, 7.66, 2.25),
    "F": (9.0, 8.65, 2.55),
}

_P_DIRS = ((1, 0, 0), (0, 1, 0), (0, 0, 1))


def _contracted(center, lmn, alphas, coeffs):
    """Attach primitive norms + unit-self-overlap renormalization."""
    cc = np.asarray(coeffs, float) * np.array(
        [primitive_norm(a, lmn) for a in alphas]
    )
    s = 0.0
    for a, ca in zip(alphas, cc):
        for b, cb in zip(alphas, cc):
            s += ca * cb * overlap_prim(a, lmn, center, b, lmn, center)
    return (np.asarray(center, float), tuple(lmn), np.asarray(alphas, float),
            cc / math.sqrt(s))


def sto3g_shell_basis(symbols, centers):
    """STO-3G basis with p shells: H-He (1s) and Li-F (1s, 2s, 2p).

    Returns ``(basis, charges)``; ``basis`` entries are
    ``(center, lmn, alphas, coeffs)`` with coefficients carrying the
    primitive norms and an overall unit-self-overlap renormalization.
    Function order per atom: 1s [, 2s, 2px, 2py, 2pz].
    """
    centers = np.asarray(centers, float).reshape(len(symbols), 3)
    basis, charges = [], []
    for sym, cen in zip(symbols, centers):
        if sym not in _SHELL_ZETAS:
            raise ValueError(
                f"sto3g_shell_basis covers {sorted(_SHELL_ZETAS)}; "
                f"got {sym!r}"
            )
        z, z1, z2 = _SHELL_ZETAS[sym]
        charges.append(z)
        basis.append(
            _contracted(cen, (0, 0, 0), _S1_ALPHA * z1**2, _S1_COEF)
        )
        if z2 is not None:
            alphas = _SP2_ALPHA * z2**2
            basis.append(_contracted(cen, (0, 0, 0), alphas, _S2_COEF))
            for lmn in _P_DIRS:
                basis.append(_contracted(cen, lmn, alphas, _P2_COEF))
    return basis, np.asarray(charges)


# --------------------------------------------------------------------- #
# Contracted molecular integrals                                         #
# --------------------------------------------------------------------- #

def _as_shell(entry):
    """Accept both basis layouts: the s-only 3-tuples of
    :func:`chemistry.sto3g_basis` (implicit ``lmn = (0,0,0)``) and this
    module's 4-tuples."""
    if len(entry) == 3:
        cen, alphas, coeffs = entry
        return np.asarray(cen, float), (0, 0, 0), alphas, coeffs
    return entry


def _pair_sum(f, b1, b2):
    c1, l1, a1, d1 = _as_shell(b1)
    c2, l2, a2, d2 = _as_shell(b2)
    val = 0.0
    for a, da in zip(a1, d1):
        for b, db in zip(a2, d2):
            val += da * db * f(a, l1, c1, b, l2, c2)
    return val


def molecular_integrals_general(basis, charges, centers):
    """AO integrals over contracted Cartesian Gaussians of any l.

    Same contract as :func:`chemistry.molecular_integrals`: returns
    ``(S, hcore, eri, e_nuc)`` with chemists' ``(pq|rs)`` ERIs; accepts
    any basis in the :func:`sto3g_shell_basis` layout.  ERIs use the
    8-fold permutational symmetry.
    """
    centers = np.asarray(centers, float).reshape(-1, 3)
    charges = np.asarray(charges, float)
    m = len(basis)
    s_mat = np.zeros((m, m))
    hcore = np.zeros((m, m))
    for i in range(m):
        for j in range(i, m):
            s_mat[i, j] = s_mat[j, i] = _pair_sum(
                overlap_prim, basis[i], basis[j]
            )
            t_ij = _pair_sum(kinetic_prim, basis[i], basis[j])
            v_ij = 0.0
            for z, cn in zip(charges, centers):
                v_ij -= z * _pair_sum(
                    lambda a, l1, c1, b, l2, c2: nuclear_prim(
                        a, l1, c1, b, l2, c2, cn
                    ),
                    basis[i], basis[j],
                )
            hcore[i, j] = hcore[j, i] = t_ij + v_ij
    eri = np.zeros((m, m, m, m))
    done = np.zeros((m, m, m, m), bool)
    for i in range(m):
        for j in range(i + 1):
            for k in range(m):
                for l2 in range(k + 1):
                    if done[i, j, k, l2]:
                        continue
                    ci, li, ai, di = _as_shell(basis[i])
                    cj, lj, aj, dj = _as_shell(basis[j])
                    ck, lk, ak, dk = _as_shell(basis[k])
                    cl, ll, al, dl = _as_shell(basis[l2])
                    val = 0.0
                    for a, da in zip(ai, di):
                        for b, db in zip(aj, dj):
                            for c, dc in zip(ak, dk):
                                for d, dd in zip(al, dl):
                                    val += da * db * dc * dd * eri_prim(
                                        a, li, ci, b, lj, cj,
                                        c, lk, ck, d, ll, cl,
                                    )
                    for pi, pj in ((i, j), (j, i)):
                        for pk, pl in ((k, l2), (l2, k)):
                            eri[pi, pj, pk, pl] = val
                            eri[pk, pl, pi, pj] = val
                            done[pi, pj, pk, pl] = True
                            done[pk, pl, pi, pj] = True
    e_nuc = 0.0
    for i in range(len(charges)):
        for j in range(i + 1, len(charges)):
            e_nuc += charges[i] * charges[j] / float(
                np.linalg.norm(centers[i] - centers[j])
            )
    return s_mat, hcore, eri, e_nuc


# --------------------------------------------------------------------- #
# One-electron properties                                                #
# --------------------------------------------------------------------- #

def dipole_prim(a, lmn1, pa, b, lmn2, pb, origin):
    """``<G1| r - origin |G2>`` (3-vector, unnormalized primitives).

    ``x - o_x = (x - B_x) + (B_x - o_x)`` raises the ket Cartesian
    power by one, so each component is two overlaps — no new machinery.
    """
    out = np.zeros(3)
    for d in range(3):
        up = list(lmn2)
        up[d] += 1
        out[d] = overlap_prim(a, lmn1, pa, b, tuple(up), pb)
        out[d] += (pb[d] - origin[d]) * overlap_prim(a, lmn1, pa, b,
                                                     lmn2, pb)
    return out


def dipole_integrals(basis, origin=(0.0, 0.0, 0.0)):
    """AO dipole matrices ``D[c, p, q] = <p| r_c - origin_c |q>``."""
    origin = np.asarray(origin, float)
    m = len(basis)
    out = np.zeros((3, m, m))
    for i in range(m):
        for j in range(i, m):
            ci, li, ai, di = _as_shell(basis[i])
            cj, lj, aj, dj = _as_shell(basis[j])
            acc = np.zeros(3)
            for a, da in zip(ai, di):
                for b, db in zip(aj, dj):
                    acc += da * db * dipole_prim(
                        a, li, ci, b, lj, cj, origin
                    )
            out[:, i, j] = out[:, j, i] = acc
    return out


def dipole_moment(basis, charges, centers, gamma_ao,
                  origin=(0.0, 0.0, 0.0)):
    """Molecular dipole ``mu = sum_A Z_A (R_A - o) - Tr[gamma D]``
    (atomic units; ``gamma_ao`` is the spin-traced AO-basis 1-RDM —
    e.g. the RHF density ``2 C_occ C_occ^T`` or a DMRG 1-RDM rotated
    back with the MO coefficients)."""
    origin = np.asarray(origin, float)
    centers = np.asarray(centers, float).reshape(-1, 3)
    d_ao = dipole_integrals(basis, origin)
    mu = -np.einsum("cpq,pq->c", d_ao, np.asarray(gamma_ao, float))
    for z, cen in zip(np.asarray(charges, float), centers):
        mu += z * (cen - origin)
    return mu


# --------------------------------------------------------------------- #
# Frozen core                                                            #
# --------------------------------------------------------------------- #

def freeze_core(h1, eri, n_core):
    """Freeze the lowest ``n_core`` (doubly occupied) orbitals.

    MO-basis standard transform: the frozen orbitals' mean field folds
    into the active one-body operator, their energy becomes an additive
    constant.  Returns ``(h1_act, eri_act, e_core)`` with

    ``e_core  = 2 sum_i h_ii + sum_ij (2 (ii|jj) - (ij|ji))``
    ``h_eff   = h_pq + sum_i (2 (pq|ii) - (pi|iq))``

    (sums over frozen ``i, j``; chemists' notation).  Feed the result
    straight to :func:`chemistry.chemistry_dmrg` with
    ``n_elec - 2 n_core`` electrons and add ``e_core`` back.
    """
    h1 = np.asarray(h1, float)
    eri = np.asarray(eri, float)
    core = list(range(n_core))
    e_core = 2.0 * sum(h1[i, i] for i in core)
    for i in core:
        for j in core:
            e_core += 2.0 * eri[i, i, j, j] - eri[i, j, j, i]
    h_eff = h1.copy()
    for i in core:
        h_eff += 2.0 * eri[:, :, i, i] - eri[:, i, i, :]
    act = slice(n_core, h1.shape[0])
    return (
        h_eff[act, act],
        eri[act, act, act, act],
        float(e_core),
    )
