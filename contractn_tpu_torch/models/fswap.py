"""Fermionic PEPS via parity swap gates: the graded-contraction core.

Counterpart of ``contractn_tpu/models/fswap.py``.  A fermionic PEPS on the
open square lattice is defined in Fock space: one fermionic mode per
physical site and per bond endpoint, per-site creation operators ordered
``(phys, u, l, d, r)``, sites applied row-major, and maximally-entangled bond
pairs ``<0|(1 + b_first b_second)`` closing the virtual modes.  Amplitudes
are the bosonic contraction of the same tensors with a sign per virtual
configuration (:func:`fpeps_sign`, checked against the operator-reordering
oracle :func:`fpeps_sign_oracle`), which factorizes into site-local swap
gates (:func:`absorb_site_signs`) and row strings over the vertical-bond
parities, applied as parity registers during a row sweep.

This module's basis has index 1 = occupied and PLUS signs in its
Jordan-Wigner identities (``S+ Z = +S+``), the opposite of
:mod:`.fermions2d`; it shares no helper with that module.

The sign rule, the Fock oracles, the dense evaluators and the exact row
sweep are host numpy, the port's own copy of the JAX package's.  The
boundary-MPS contractions (:func:`fpeps_norm_boundary` and the functions on
top of it) build their row cores on the host and contract on ``device``
(default ``cuda``, or the tensors' own device when they are torch tensors);
:func:`fpeps_energy_diff` and :func:`fpeps_ground_state` are torch end to
end, differentiable through :func:`~.canonical.truncate_safe`.

Departures: the boundary entry points take ``device=``; the gradient loop
uses optax's Adam written out (:mod:`..ops.optim`) on torch's gradient.
"""

import itertools

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, real_dtype, resolve_device


def _host(a):
    """A site tensor as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _host_grid(tensors):
    return [[_host(t) for t in row] for row in tensors]


def _grid_device(tensors, device):
    return resolve_device(device, [t for row in tensors for t in row])


def fpeps_sign(ly, lx, ph, pv):
    """The sign of one virtual-parity configuration (the derived rule).

    Args:
        ph: ``(ly, lx-1)`` horizontal-bond parities (0/1).
        pv: ``(ly-1, lx)`` vertical-bond parities.
    """
    e = 0
    for r in range(ly):
        for c in range(lx - 1):
            h = ph[r][c]
            if not h:
                continue
            if c + 1 < lx - 1:
                e += h * ph[r][c + 1]
            if r < ly - 1:
                e += h * (pv[r][c] + pv[r][c + 1])
            if r > 0:
                e += h * pv[r - 1][c]
    for r in range(ly - 1):
        for c in range(lx):
            for c2 in range(c + 1, lx):
                e += pv[r][c] * pv[r][c2]
            if r + 1 < ly - 1:
                for c2 in range(0, c + 1):
                    e += pv[r][c] * pv[r + 1][c2]
    return (-1) ** (e % 2)


def fpeps_sign_oracle(ly, lx, nbits, ph, pv):
    """Independent spec: exact operator-reordering parity of the
    monomial (list bookkeeping, no Fock vectors).  ``fpeps_sign`` must
    (and does) reproduce it; kept for the tests' cross-validation."""
    seq = []
    for r in range(ly):
        for c in range(lx):
            if nbits[r][c]:
                seq.append(("p", r, c))
            if r > 0 and pv[r - 1][c]:
                seq.append(("v", r - 1, c, "lo"))
            if c > 0 and ph[r][c - 1]:
                seq.append(("h", r, c - 1, "rt"))
            if r < ly - 1 and pv[r][c]:
                seq.append(("v", r, c, "up"))
            if c < lx - 1 and ph[r][c]:
                seq.append(("h", r, c, "lf"))
    sign = 1

    def annihilate(m):
        nonlocal sign
        i = seq.index(m)
        sign *= (-1) ** i
        seq.pop(i)

    for r in range(ly):
        for c in range(lx - 1):
            if ph[r][c]:
                annihilate(("h", r, c, "rt"))
                annihilate(("h", r, c, "lf"))
    for r in range(ly - 1):
        for c in range(lx):
            if pv[r][c]:
                annihilate(("v", r, c, "lo"))
                annihilate(("v", r, c, "up"))
    for r in range(ly):
        for c in range(lx):
            if nbits[r][c]:
                annihilate(("p", r, c))
    assert not seq
    return sign


def parity_even_tensor(rng, shape, parities):
    """Random tensor supported on the parity-even block (the fermionic
    tensor condition).  ``parities``: one 0/1 vector per axis."""
    a = rng.standard_normal(shape)
    for idx in np.ndindex(*shape):
        if sum(int(p[i]) for p, i in zip(parities, idx)) % 2:
            a[idx] = 0.0
    return a


def absorb_site_signs(a, leg_parities):
    """Multiply a ``(d, u, l, d, r)``-ordered site tensor by the
    site-local swap factors ``(-1)^{lr + dr + ld + ur}``.

    ``leg_parities = (pu, pl, pd, pr)`` (parity vector per leg; legs a
    site does not have are length-1 even).  Numpy in, numpy out; a torch
    tensor stays on its device.  After this absorption only
    the row-string ``v x v`` gates remain — the piece a row-sweep
    contractor applies as a Jordan-Wigner string on its open legs.
    """
    pu, pl, pd, pr = [np.asarray(p) for p in leg_parities]
    sgn = np.ones(a.shape[1:])
    lr = pl[:, None] * pr[None, :]
    sgn = sgn * (-1.0) ** (
        lr[None, :, None, :]
        + (pd[:, None] * pr[None, :])[None, None, :, :]
        + (pl[:, None] * pd[None, :])[None, :, :, None]
        + (pu[:, None] * pr[None, :])[:, None, None, :]
    )
    if isinstance(a, torch.Tensor):
        return a * torch.from_numpy(sgn[None]).to(a.device, a.real.dtype)
    return a * sgn[None]


def _bond_iter(ly, lx, dims_h, dims_v):
    hkeys = [(r, c) for r in range(ly) for c in range(lx - 1)]
    vkeys = [(r, c) for r in range(ly - 1) for c in range(lx)]
    ranges = [range(dims_h[k]) for k in hkeys] + [
        range(dims_v[k]) for k in vkeys
    ]
    for combo in itertools.product(*ranges):
        xh = {k: v for k, v in zip(hkeys, combo[: len(hkeys)])}
        xv = {k: v for k, v in zip(vkeys, combo[len(hkeys):])}
        yield xh, xv


def fpeps_amplitudes_dense(tensors, ph_vec, pv_vec, d=2):
    """ALL amplitudes ``psi(n)`` of a small fermionic PEPS, exactly.

    Args:
        tensors: ``grid[r][c]`` of ``(d, Du, Dl, Dd, Dr)`` arrays
            (missing boundary legs have dim 1); parity-even w.r.t. the
            parity vectors.
        ph_vec / pv_vec: dict ``(r, c) -> parity vector`` per
            horizontal / vertical bond.

    Enumerates virtual configurations (exponential — validation-scale
    grids only) and applies :func:`fpeps_sign` per configuration.
    Returns a ``(d,) * (ly * lx)`` array, sites row-major.
    """
    ly, lx = len(tensors), len(tensors[0])
    dims_h = {k: len(v) for k, v in ph_vec.items()}
    dims_v = {k: len(v) for k, v in pv_vec.items()}
    out = np.zeros((d,) * (ly * lx))
    for xh, xv in _bond_iter(ly, lx, dims_h, dims_v):
        ph = [[int(ph_vec[(r, c)][xh[(r, c)]]) for c in range(lx - 1)]
              for r in range(ly)]
        pv = [[int(pv_vec[(r, c)][xv[(r, c)]]) for c in range(lx)]
              for r in range(ly - 1)]
        sgn = fpeps_sign(ly, lx, ph, pv)
        term = np.ones(())
        for r in range(ly):
            for c in range(lx):
                u = xv[(r - 1, c)] if r > 0 else 0
                left = xh[(r, c - 1)] if c > 0 else 0
                dn = xv[(r, c)] if r < ly - 1 else 0
                rt = xh[(r, c)] if c < lx - 1 else 0
                term = np.multiply.outer(
                    term, tensors[r][c][:, u, left, dn, rt]
                )
        out = out + sgn * term
    return out


def random_fpeps(ly, lx, bond_parities=(0, 1), d=2, seed=0):
    """Random parity-even fermionic PEPS on an ``ly x lx`` open grid.

    Every interior bond carries the parity vector ``bond_parities``;
    boundary legs are trivial (dim 1, even).  Returns ``(tensors,
    ph_vec, pv_vec)`` in the :func:`fpeps_amplitudes_dense` format.
    """
    rng = np.random.default_rng(seed)
    bp = np.asarray(bond_parities)
    ph_vec = {(r, c): bp for r in range(ly) for c in range(lx - 1)}
    pv_vec = {(r, c): bp for r in range(ly - 1) for c in range(lx)}
    pphys = np.arange(d) % 2  # |0> even, |1> one fermion, ...
    triv = np.zeros(1, np.int64)
    tensors = []
    for r in range(ly):
        row = []
        for c in range(lx):
            pu = pv_vec[(r - 1, c)] if r > 0 else triv
            pl = ph_vec[(r, c - 1)] if c > 0 else triv
            pd = pv_vec[(r, c)] if r < ly - 1 else triv
            pr = ph_vec[(r, c)] if c < lx - 1 else triv
            shape = (d, len(pu), len(pl), len(pd), len(pr))
            row.append(parity_even_tensor(
                rng, shape, [pphys, pu, pl, pd, pr]))
        tensors.append(row)
    return tensors, ph_vec, pv_vec


def fock_state(tensors, ph_vec, pv_vec, d=2):
    """The fermionic PEPS as a Fock-space vector (row-major JW basis:
    ``|n> = (f_0^d)^{n_0} (f_1^d)^{n_1} ... |0>``).

    The dense amplitudes ARE the coefficients in this ordered-creation
    basis (that is what the ``<n|`` readout convention of the sign spec
    means), so fermionic expectation values of ARBITRARY operators can
    be taken against explicit JW operator matrices — the bridge the
    tests use to validate energies of fermionic Hamiltonians.
    """
    amps = fpeps_amplitudes_dense(tensors, ph_vec, pv_vec, d=d)
    return amps.reshape(-1)


def fpeps_expectation_dense(tensors, ph_vec, pv_vec, op, d=2):
    """``<psi| O |psi> / <psi|psi>`` for an operator given as a dense
    Fock matrix in the row-major JW basis (build fermionic operators
    with the same convention as :mod:`contractn_tpu.models.fermions2d`).
    """
    psi = fock_state(tensors, ph_vec, pv_vec, d=d)
    num = np.matmul(psi.conj(), np.matmul(np.asarray(op), psi))
    den = np.matmul(psi.conj(), psi)
    return num / den


def hopping_fock_matrix(ly, lx, t=1.0, mu=0.0, delta=0.0):
    """Dense Fock matrix of the 2D spinless-fermion Hamiltonian in the
    ROW-MAJOR ordering and THIS module's basis (index 1 = occupied,
    so ``c`` maps index 1 -> 0 and ``n = diag(0, 1)``)."""
    n = ly * lx
    sm = np.array([[0.0, 1.0], [0.0, 0.0]])
    z = np.diag([1.0, -1.0])

    def op_at(mats):
        m = np.eye(1)
        for k in range(n):
            m = np.kron(m, mats.get(k, np.eye(2)))
        return m

    cs = [op_at({**{j: z for j in range(i)}, i: sm}) for i in range(n)]
    h = np.zeros((2 ** n, 2 ** n))
    for r in range(ly):
        for c in range(lx):
            i = r * lx + c
            h += -mu * np.matmul(cs[i].T, cs[i])
            for (r2, c2) in ((r, c + 1), (r + 1, c)):
                if r2 >= ly or c2 >= lx:
                    continue
                j = r2 * lx + c2
                h += -t * (np.matmul(cs[i].T, cs[j])
                           + np.matmul(cs[j].T, cs[i]))
                h += delta * (np.matmul(cs[i].T, cs[j].T)
                              + np.matmul(cs[j], cs[i]))
    return h


# --------------------------------------------------------------------- #
# Row-sweep contraction (polynomial in ly: strips of bounded width)
# --------------------------------------------------------------------- #


def _double_layer(a, op=None):
    """Merged-leg double layer ``E[(u ub), (l lb), (d db), (r rb)]`` of a
    site tensor (site-local sign factors ALREADY absorbed), with an
    optional parity-even one-site operator between the layers."""
    if op is None:
        e = np.einsum("nuldr,nULDR->uUlLdDrR", a, np.conj(a))
    else:
        e = np.einsum("nuldr,nm,mULDR->uUlLdDrR", a, np.asarray(op),
                      np.conj(a))
    s = a.shape
    return e.reshape(s[1] ** 2, s[2] ** 2, s[3] ** 2, s[4] ** 2)


def fpeps_expectation_sweep(tensors, ph_vec, pv_vec, op=None,
                            site=None, ops=None, d=2):
    """``<psi| O_site |psi>`` (or the norm, ``op=None``) by an exact
    row sweep — polynomial in ``ly``, dense over a row's merged
    vertical legs (strips of width ``lx <= ~5`` at D = 2).

    The residual (non-site-local) fermionic signs are applied DURING
    the left-to-right column sweep of each row absorption with one
    parity register per layer (the running parity ``K`` of the new
    row's v-legs):

    * within-row pairs of the new row's v-legs: ``(-1)^{q_c K(<c)}``;
    * the adjacent-row staircase against the previous row's v-legs:
      ``(-1)^{p_c (K(<c) + q_c)}``.

    ``op`` (parity-even one-site operator, e.g. the density) inserts
    between the layers at ``site``.  Exact — validated against the
    dense-enumeration evaluators, which are themselves Fock-pinned.
    """
    ly, lx = len(tensors), len(tensors[0])
    triv = np.zeros((1,), np.int64)

    def legpar(r, c):
        pu = pv_vec[(r - 1, c)] if r > 0 else triv
        pl = ph_vec[(r, c - 1)] if c > 0 else triv
        pd = pv_vec[(r, c)] if r < ly - 1 else triv
        pr = ph_vec[(r, c)] if c < lx - 1 else triv
        return (pu, pl, pd, pr)

    bnd = None  # dense boundary over the previous row's merged v-legs
    for r in range(ly):
        old_dims = list(bnd.shape) if bnd is not None else [1] * lx
        # carry[kk, kb, h2, new_0..new_{c-1}, old_c..old_{lx-1}]
        carry = np.zeros((2, 2, 1) + tuple(old_dims))
        carry[0, 0, 0] = (bnd if bnd is not None
                          else np.ones(tuple(old_dims)))
        for c in range(lx):
            pu, pl, pd, pr = legpar(r, c)
            a_abs = absorb_site_signs(tensors[r][c], (pu, pl, pd, pr))
            o = _op_at(op, site, ops, r, c)
            e = _double_layer(a_abs, op=o)  # (u2, l2, d2, r2)
            du2, _, dd2, dr2 = e.shape
            pdk = np.repeat(pd, len(pd)) % 2  # ket parity of merged d
            pdb = np.tile(pd, len(pd)) % 2    # bra parity
            puk = np.repeat(pu, len(pu)) % 2
            pub = np.tile(pu, len(pu)) % 2
            out = np.zeros((2, 2, dr2) + carry.shape[3:3 + c]
                           + (dd2,) + carry.shape[3 + c + 1:])
            for kk in range(2):
                for kb in range(2):
                    for u2 in range(du2):
                        # slice old leg u2 (axis 1 + c of carry[kk,kb])
                        sl = np.moveaxis(carry[kk, kb], 1 + c, 0)[u2]
                        if not sl.any():
                            continue
                        pk, pb = int(puk[u2]), int(pub[u2])
                        for dn2 in range(dd2):
                            qk, qb = int(pdk[dn2]), int(pdb[dn2])
                            sgn = (-1) ** ((qk * kk + qb * kb
                                            + pk * ((kk + qk) % 2)
                                            + pb * ((kb + qb) % 2))
                                           % 2)
                            mat = e[u2, :, dn2, :]  # (l2, r2)
                            contrib = np.tensordot(sl, mat,
                                                   axes=([0], [0]))
                            # axes: (new..., old_{c+1}.., r2) -> front
                            contrib = np.moveaxis(contrib, -1, 0)
                            idx = ((kk + qk) % 2, (kb + qb) % 2,
                                   slice(None))
                            idx += (slice(None),) * c + (dn2,)
                            out[idx] += sgn * contrib
            carry = out
        # registers partition the new-leg configurations: summing is exact
        bnd = carry.sum(axis=(0, 1, 2))
    return np.asarray(bnd).reshape(())


def fpeps_norm_sweep(tensors, ph_vec, pv_vec, d=2):
    return fpeps_expectation_sweep(tensors, ph_vec, pv_vec)


# --------------------------------------------------------------------- #
# Boundary-MPS contraction (scalable in BOTH dimensions, chi-truncated)
# --------------------------------------------------------------------- #


def _embed_np(mats, phys_shape):
    """Stack per-column cores into uniform numpy cores, zero-padding the
    horizontal bonds; returns ``(stacked, e0)``."""
    h = max(max(m.shape[-2], m.shape[-1]) for m in mats)
    out = np.zeros((len(mats),) + phys_shape + (h, h), mats[0].dtype)
    for i, m in enumerate(mats):
        sl = (i,) + tuple(slice(0, s) for s in m.shape)
        out[sl] = m
    e = np.zeros((h,))
    e[0] = 1.0
    return out, e


def _op_at(op, site, ops, r, c):
    """Resolve the operator inserted at ``(r, c)``: either the single
    ``op``/``site`` pair or an ``ops`` dict ``{(r, c): matrix}`` — the
    dict form is how multi-site JW-string operators (fermionic hopping
    and pairing) enter: the sign rule has NO dependence on the physical
    indices, so arbitrary per-site operator insertions between the
    layers are exact."""
    if ops is not None and (r, c) in ops:
        return ops[(r, c)]
    if site is not None and site == (r, c):
        return op
    return None


def _row_mpo_cores(tensors, ph_vec, pv_vec, r, ly, lx, op, site,
                   ops=None):
    """Per-column fermionic row-transfer cores ``(d_out, d_in, W, W)``.

    ``d_in = Du^2`` (old merged v-leg), ``d_out = Dd^2`` (new); the MPO
    bond is ``(merged h-leg) x (ket register) x (bra register)`` with
    the string signs and register transitions woven into the elements.
    """
    triv = np.zeros((1,), np.int64)
    cores = []
    for c in range(lx):
        pu = pv_vec[(r - 1, c)] if r > 0 else triv
        pl = ph_vec[(r, c - 1)] if c > 0 else triv
        pd = pv_vec[(r, c)] if r < ly - 1 else triv
        pr = ph_vec[(r, c)] if c < lx - 1 else triv
        a_abs = absorb_site_signs(tensors[r][c], (pu, pl, pd, pr))
        o = _op_at(op, site, ops, r, c)
        e = _double_layer(a_abs, op=o)  # (u2, l2, d2, r2)
        du2, dl2, dd2, dr2 = e.shape
        pdk = np.repeat(pd, len(pd)) % 2
        pdb = np.tile(pd, len(pd)) % 2
        puk = np.repeat(pu, len(pu)) % 2
        pub = np.tile(pu, len(pu)) % 2
        w = np.zeros((dd2, du2, dl2 * 4, dr2 * 4))
        for kk in range(2):
            for kb in range(2):
                for u2 in range(du2):
                    pk, pb = int(puk[u2]), int(pub[u2])
                    for dn2 in range(dd2):
                        qk, qb = int(pdk[dn2]), int(pdb[dn2])
                        sgn = (-1.0) ** ((qk * kk + qb * kb
                                          + pk * ((kk + qk) % 2)
                                          + pb * ((kb + qb) % 2)) % 2)
                        win = slice(None)
                        kk2, kb2 = (kk + qk) % 2, (kb + qb) % 2
                        # bond layout: h-index major, register minor
                        for l2 in range(dl2):
                            for r2 in range(dr2):
                                w[dn2, u2,
                                  l2 * 4 + kk * 2 + kb,
                                  r2 * 4 + kk2 * 2 + kb2] += (
                                    sgn * e[u2, l2, dn2, r2])
        cores.append(w)
    return cores



def _boundary_mps(stacked, device):
    """``(cores, left, right)`` on ``device`` for the stacked row cores: the
    left vector at h edge 0, registers (0, 0); the right one summing the four
    registers of the dim-1 right h edge."""
    wdim = stacked.shape[-1]
    left = np.zeros((wdim,))
    left[0] = 1.0
    right = np.zeros((wdim,))
    right[:4] = 1.0
    return tuple(torch.from_numpy(x).to(device) for x in (stacked, left, right))


def fpeps_norm_boundary(tensors, ph_vec, pv_vec, op=None, site=None,
                        ops=None, chi=None, d=2, device=None):
    """``<psi| O_site |psi>`` / norm of a finite fermionic PEPS by boundary-MPS
    sweeping, polynomial in both lattice dimensions.

    The fermionic row transfer is an MPO whose virtual bond carries the
    merged horizontal double-layer leg times the two string-parity
    registers; the registers start at 0 through the left boundary vector
    and are summed by the right one.  Rows are absorbed exactly and
    compressed back to ``chi`` (``chi=None`` is exact).  The row cores are
    built on the host; the contraction runs on ``device``.  Returns a float.
    """
    from .boundary import apply_mpo_to_mps
    from .canonical import compress
    from .mpo import MPO
    from .mps import MPS

    device = _grid_device(tensors, device)
    tensors = _host_grid(tensors)
    ly, lx = len(tensors), len(tensors[0])
    if ly == 1:
        # one row would be both the opening boundary and the closing row
        # (norm squared); the exact sweep handles 1 x N directly
        return fpeps_expectation_sweep(tensors, ph_vec, pv_vec, op=op, site=site,
                                       ops=ops, d=d)

    # row 0 as a boundary MPS over its new v-legs: the row-MPO cores with
    # trivial d_in, (d_out, 1, W, W) -> (d_out, W, W)
    cores0 = _row_mpo_cores(tensors, ph_vec, pv_vec, 0, ly, lx, op, site, ops)
    mats = [w[:, 0] for w in cores0]
    stacked, _ = _embed_np(mats, (mats[0].shape[0],))
    boundary = MPS(*_boundary_mps(stacked, device))
    total_log = 0.0

    for r in range(1, ly - 1):
        cores = _row_mpo_cores(tensors, ph_vec, pv_vec, r, ly, lx, op, site, ops)
        stacked, _ = _embed_np(cores, cores[0].shape[:2])
        boundary = apply_mpo_to_mps(MPO(*_boundary_mps(stacked, device)), boundary)
        if chi is not None and boundary.bond_dim > chi:
            boundary, log_norm, _ = compress(boundary, max_bond=chi)
            total_log += float(log_norm)

    # closing row: registers trivial (no new legs; the old-leg staircase
    # factors vanish against parity-0 new legs)
    cores = _row_mpo_cores(tensors, ph_vec, pv_vec, ly - 1, ly, lx, op, site, ops)
    mats = [w[0] for w in cores]  # (d_in, W, W); d_out = 1
    stacked, _ = _embed_np(mats, (mats[0].shape[0],))
    closing = MPS(*_boundary_mps(stacked, device))
    val, log = closing.inner(boundary, conjugate=False)
    return float(val) * float(np.exp(float(log) + total_log))


def _jw_string_ops(lx, site_a, site_b, kind):
    """Per-site spin operators of a two-fermion term in row-major JW.

    Returns ONE ordered term; callers sum the orderings.  In THIS
    module's basis (index 0 = empty, 1 = occupied — the fPEPS Fock
    definition's ``(f^d)^n``), the JW identities carry PLUS signs
    (``S+ Z = +S+`` here, unlike the occupied-first convention of
    ``models.fermions2d``), pinned by the Fock test:

        ``c^d_m c_n   = + S+_m (prod Z) S-_n``   (m < n)
        ``c^d_m c^d_n = + S+_m (prod Z) S+_n``
    """
    sp = np.array([[0.0, 0.0], [1.0, 0.0]])  # create: |0> -> |1>
    sm = sp.T
    z = np.diag([1.0, -1.0])
    (ra, ca), (rb, cb) = site_a, site_b
    m = ra * lx + ca
    n = rb * lx + cb
    if m > n:
        raise ValueError("order site_a before site_b (row-major)")
    first, second = {"pdm": (sp, sm), "mdp": (sm, sp),
                     "pdp": (sp, sp), "mdm": (sm, sm)}[kind]
    ops = {site_a: first}
    for k in range(m + 1, n):
        ops[(k // lx, k % lx)] = z
    ops[site_b] = second
    return ops



def fpeps_bond_expectation(tensors, ph_vec, pv_vec, site_a, site_b,
                           t=1.0, delta=0.0, chi=None, device=None):
    """``<psi| -t (c^d_a c_b + h.c.) + delta (c^d_a c^d_b + h.c.) |psi>``
    (UNNORMALIZED) through the boundary contraction; ``site_a`` must precede
    ``site_b`` row-major."""
    lx = len(tensors[0])
    total = 0.0
    for coeff, kind in ((-t, "pdm"), (-t, "mdp"), (delta, "pdp"), (delta, "mdm")):
        if coeff == 0.0:
            continue
        ops = _jw_string_ops(lx, site_a, site_b, kind)
        total += coeff * fpeps_norm_boundary(tensors, ph_vec, pv_vec, ops=ops,
                                             chi=chi, device=device)
    return total


def fpeps_energy(tensors, ph_vec, pv_vec, t=1.0, mu=0.0, delta=0.0, chi=None,
                 device=None):
    """Energy of the 2D spinless-fermion Hamiltonian (hopping, chemical
    potential, pairing) on a finite fermionic PEPS, through chi-truncated
    boundary sweeps (one contraction per term plus the norm).  A float."""
    device = _grid_device(tensors, device)
    tensors = _host_grid(tensors)
    ly, lx = len(tensors), len(tensors[0])
    nop = np.diag([0.0, 1.0])
    total = 0.0
    for r in range(ly):
        for c in range(lx):
            if mu != 0.0:
                total += -mu * fpeps_norm_boundary(tensors, ph_vec, pv_vec, op=nop,
                                                   site=(r, c), chi=chi, device=device)
            for (r2, c2) in ((r, c + 1), (r + 1, c)):
                if r2 >= ly or c2 >= lx:
                    continue
                total += fpeps_bond_expectation(tensors, ph_vec, pv_vec, (r, c),
                                                (r2, c2), t=t, delta=delta, chi=chi,
                                                device=device)
    return total / fpeps_norm_boundary(tensors, ph_vec, pv_vec, chi=chi, device=device)


# --------------------------------------------------------------------- #
# Differentiable energy -> gradient-optimized fermionic ground states
# --------------------------------------------------------------------- #


def _sign_block(pu, pd):
    """Constant ``(d2, u2, 4, 4)`` array: string sign x register
    transition for one site's merged legs (parities only — the whole
    fermionic structure enters the DIFFERENTIABLE energy through this
    tensor-independent constant)."""
    pdk = np.repeat(pd, len(pd)) % 2
    pdb = np.tile(pd, len(pd)) % 2
    puk = np.repeat(pu, len(pu)) % 2
    pub = np.tile(pu, len(pu)) % 2
    dd2, du2 = len(pdk), len(puk)
    s = np.zeros((dd2, du2, 4, 4))
    for kk in range(2):
        for kb in range(2):
            for u2 in range(du2):
                pk, pb = int(puk[u2]), int(pub[u2])
                for dn2 in range(dd2):
                    qk, qb = int(pdk[dn2]), int(pdb[dn2])
                    sgn = (-1.0) ** ((qk * kk + qb * kb
                                      + pk * ((kk + qk) % 2)
                                      + pb * ((kb + qb) % 2)) % 2)
                    kk2, kb2 = (kk + qk) % 2, (kb + qb) % 2
                    s[dn2, u2, kk * 2 + kb, kk2 * 2 + kb2] = sgn
    return s


def fpeps_energy_diff(tensors, ph_vec, pv_vec, chi, t=1.0, mu=0.0, delta=0.0):
    """Differentiable :func:`fpeps_energy` (torch end to end).

    The contraction of :func:`fpeps_norm_boundary` with every
    tensor-dependent step in torch (the fermionic signs enter as the
    constant :func:`_sign_block` arrays) and the boundary truncated to
    ``chi`` by :func:`~.canonical.truncate_safe`, whose ``svd_safe`` sweeps
    keep the gradient finite on the rank-deficient bonds of this
    contraction.  The norm and every term of the Hamiltonian differ only in
    the one-site operators inserted, so they are contracted together, as
    one batch of boundary sweeps (the JAX package contracts them one after
    another).  ``tensors`` is a grid of torch tensors on one device; feed
    parity-even tensors and parity-project gradients (:func:`parity_masks`).
    Returns a real 0-d tensor.
    """
    from .canonical import truncate_safe

    ly, lx = len(tensors), len(tensors[0])
    if ly == 1:
        # the sweep below would use row 0 as both the opening boundary and
        # the closing row, double-counting it
        raise ValueError("fpeps_energy_diff needs ly >= 2; use the exact "
                         "fpeps_energy path for single rows")
    like = tensors[0][0]
    device, dtype = like.device, like.dtype
    triv = np.zeros((1,), np.int64)

    # the batch: the norm first, then (coefficient, one-site operators)
    nop = np.diag([0.0, 1.0])
    terms = [(1.0, {})]
    for r in range(ly):
        for c in range(lx):
            if mu != 0.0:
                terms.append((-mu, {(r, c): nop}))
            for (r2, c2) in ((r, c + 1), (r + 1, c)):
                if r2 >= ly or c2 >= lx:
                    continue
                for coeff, kind in ((-t, "pdm"), (-t, "mdp"), (delta, "pdp"),
                                    (delta, "mdm")):
                    if coeff != 0.0:
                        terms.append((coeff, _jw_string_ops(lx, (r, c), (r2, c2), kind)))

    def legpar(r, c):
        pu = pv_vec[(r - 1, c)] if r > 0 else triv
        pl = ph_vec[(r, c - 1)] if c > 0 else triv
        pd = pv_vec[(r, c)] if r < ly - 1 else triv
        pr = ph_vec[(r, c)] if c < lx - 1 else triv
        return (pu, pl, pd, pr)

    def site_cores(r, c):
        """``(T, d2, u2, Wl, Wr)``: the site's row-transfer core under each
        term's operator (one core per distinct operator, gathered)."""
        pu, _, pd, _ = legpar(r, c)
        a = absorb_site_signs(tensors[r][c], legpar(r, c))
        sh = tensors[r][c].shape
        sb = torch.from_numpy(_sign_block(pu, pd)).to(device)  # (d2, u2, 4, 4)
        cores = {}
        for _, ops in terms:
            o = ops.get((r, c))
            key = None if o is None else np.asarray(o).tobytes()
            if key in cores:
                continue
            if o is None:
                e = peinsum("nuldr,nULDR->uUlLdDrR", a, a.conj())
            else:
                e = peinsum("nuldr,nm,mULDR->uUlLdDrR", a, as_tensor(o, device, dtype),
                            a.conj())
            e = e.reshape(sh[1] ** 2, sh[2] ** 2, sh[3] ** 2, sh[4] ** 2)
            w = e.permute(2, 0, 1, 3)[:, :, :, None, :, None] * sb[:, :, None, :, None, :]
            d2, u2, dl2, _, dr2, _ = w.shape
            cores[key] = w.reshape(d2, u2, dl2 * 4, dr2 * 4)
        return torch.stack([cores[None if o is None else np.asarray(o).tobytes()]
                            for o in (ops.get((r, c)) for _, ops in terms)])

    def unit(n, ones=1):
        v = torch.zeros((n,), dtype=dtype, device=device)
        v[:ones] = 1.0
        return v

    boundary = [w[:, :, 0] for w in (site_cores(0, c) for c in range(lx))]  # (T, d2, Wl, Wr)
    boundary, log = truncate_safe(boundary, unit(boundary[0].shape[-2]),
                                  unit(boundary[-1].shape[-1], 4), chi)
    for r in range(1, ly - 1):
        grown = []
        for c in range(lx):
            g = peinsum("TDUlr,TUij->TDlirj", site_cores(r, c), boundary[c])
            grown.append(g.reshape(g.shape[0], g.shape[1], g.shape[2] * g.shape[3],
                                   g.shape[4] * g.shape[5]))
        # the MPO boundary vectors kron the MPS unit bonds
        boundary, lg = truncate_safe(grown, unit(grown[0].shape[-2]),
                                     unit(grown[-1].shape[-1], 4), chi)
        log = log + lg
    closing = [w[:, 0] for w in (site_cores(ly - 1, c) for c in range(lx))]
    lvec, rvec = unit(closing[0].shape[-2]), unit(closing[-1].shape[-1], 4)
    # bilinear closing transfer over columns: the boundary's edge bonds are
    # unit (the truncation absorbed its boundary weights); the closing row's
    # register structure rides lvec / rvec
    carry = torch.outer(lvec, unit(boundary[0].shape[-2]))
    for c in range(lx):
        carry = peinsum("...ab,...dai,...dbj->...ij", carry, closing[c], boundary[c])
    vals = peinsum("...ij,i,j->...", carry, rvec,
                   torch.ones((carry.shape[-1],), dtype=dtype, device=device))
    coeffs = torch.tensor([coeff for coeff, _ in terms[1:]], dtype=real_dtype(dtype),
                          device=device)
    total = (coeffs * vals[1:] * torch.exp(log[1:] - log[0])).sum()
    return torch.real(total / vals[0])


def parity_masks(ly, lx, ph_vec, pv_vec, d=2):
    """0/1 masks (host numpy) of the parity-even blocks, one per site
    tensor: the projector that keeps a gradient flow on the fermionic
    manifold."""
    triv = np.zeros((1,), np.int64)
    pphys = np.arange(d) % 2
    masks = []
    for r in range(ly):
        row = []
        for c in range(lx):
            pu = pv_vec[(r - 1, c)] if r > 0 else triv
            pl = ph_vec[(r, c - 1)] if c > 0 else triv
            pd = pv_vec[(r, c)] if r < ly - 1 else triv
            pr = ph_vec[(r, c)] if c < lx - 1 else triv
            tot = (pphys[:, None, None, None, None]
                   + pu[None, :, None, None, None]
                   + pl[None, None, :, None, None]
                   + pd[None, None, None, :, None]
                   + pr[None, None, None, None, :]) % 2
            row.append((tot == 0).astype(float))
        masks.append(row)
    return masks


def fpeps_ground_state(ly, lx, t=1.0, mu=0.0, delta=0.0, chi=8, steps=200,
                       lr=2e-2, seed=0, d=2, bond_parities=(0, 1), init=None,
                       init_parities=None, device=None):
    """Gradient-optimized fermionic PEPS ground state (finite lattice).

    Adam on the parity-even site tensors through the differentiable
    boundary energy, gradients parity-projected every step so the state
    never leaves the fermionic manifold.  ``bond_parities`` sets the virtual
    dimension and its parity content.  ``init`` (a grid from a lower-D run,
    with ``init_parities`` its bond parity vector) warm-starts by
    parity-consistent zero-padding plus small even noise.  The start is
    drawn on the host from ``seed`` as the JAX package draws it; the work
    runs on ``device`` (default ``cuda``).

    Returns ``(tensors, energy, trace)``: the grid of torch tensors, the
    last step's energy and the per-step trace (floats, read once).
    """
    from ..ops.optim import Adam, descend

    device = resolve_device(device)
    tensors, ph_vec, pv_vec = random_fpeps(ly, lx, bond_parities=bond_parities,
                                           seed=seed, d=d)
    masks = parity_masks(ly, lx, ph_vec, pv_vec, d=d)
    if init is not None:
        if init_parities is None:
            raise ValueError("init needs init_parities (the bond parity vector "
                             "the init tensors use)")
        padded = pad_fpeps(init, init_parities, bond_parities, ly, lx)
        start = [[(padded[r][c] + 0.02 * tensors[r][c]) * masks[r][c]
                  for c in range(lx)] for r in range(ly)]
    else:
        start = [[0.3 * tensors[r][c] for c in range(lx)] for r in range(ly)]
    params = [torch.from_numpy(np.asarray(start[r][c], np.float64)).to(device)
              for r in range(ly) for c in range(lx)]
    mask_t = [torch.from_numpy(masks[r][c]).to(device)
              for r in range(ly) for c in range(lx)]

    def grid(ps):
        return [ps[r * lx:(r + 1) * lx] for r in range(ly)]

    opt = Adam(params, lr=lr)
    trace = []
    for _ in range(int(steps)):
        leaves = [p.requires_grad_(True) for p in params]
        e = fpeps_energy_diff(grid(leaves), ph_vec, pv_vec, chi, t=t, mu=mu, delta=delta)
        grads = torch.autograd.grad(e, leaves)
        descend(opt, params, [g * m for g, m in zip(grads, mask_t)])
        with torch.no_grad():
            for p, m in zip(params, mask_t):
                p.mul_(m)
        trace.append(e.detach())
    params = grid([p.detach() for p in params])
    trace = [float(x) for x in torch.stack(trace).cpu()] if trace else []
    return params, (trace[-1] if trace else None), trace


def pad_fpeps(tensors, old_bp, new_bp, ly=None, lx=None):
    """Zero-pad a fermionic PEPS into a larger bond parity structure (host
    numpy): each old bond slot injects into the first unused new slot of the
    SAME parity, so the embedded state is exactly the old one at the larger
    D.  Boundary legs (dim 1) pass through."""
    old_bp = list(np.asarray(old_bp))
    new_bp = list(np.asarray(new_bp))
    inj = []
    used = set()
    for p in old_bp:
        for j, q in enumerate(new_bp):
            if j not in used and q == p:
                inj.append(j)
                used.add(j)
                break
        else:
            raise ValueError(f"new_bp={new_bp} cannot host old_bp={old_bp}")
    ly = len(tensors) if ly is None else ly
    lx = len(tensors[0]) if lx is None else lx
    out = []
    for r in range(ly):
        row = []
        for c in range(lx):
            a = _host(tensors[r][c])
            take = np.zeros((len(old_bp), len(new_bp)), a.dtype)
            for i, j in enumerate(inj):
                take[i, j] = 1.0
            src = a
            for ax in range(1, 5):
                if a.shape[ax] == 1:  # boundary leg passes through
                    continue
                src = np.tensordot(src, take, axes=([ax], [0]))
                src = np.moveaxis(src, -1, ax)
            row.append(src)
        out.append(row)
    return out


def fpeps_correlator(tensors, ph_vec, pv_vec, site_a, site_b, chi=None,
                     device=None):
    """Normalized two-point function ``<c^d_a c_b>`` at arbitrary range: the
    Jordan-Wigner string between the (row-major ordered) sites is a chain of
    one-site ``Z`` insertions, so it costs one boundary sweep.  ``site_a``
    must precede ``site_b`` row-major; equal sites give the density."""
    lx = len(tensors[0])
    norm = fpeps_norm_boundary(tensors, ph_vec, pv_vec, chi=chi, device=device)
    if site_a == site_b:
        return fpeps_norm_boundary(tensors, ph_vec, pv_vec, op=np.diag([0.0, 1.0]),
                                   site=site_a, chi=chi, device=device) / norm
    ops = _jw_string_ops(lx, site_a, site_b, "pdm")
    return fpeps_norm_boundary(tensors, ph_vec, pv_vec, ops=ops, chi=chi,
                               device=device) / norm
