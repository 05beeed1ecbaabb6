"""Spinful fermionic infinite PEPS: the 2D Hubbard model in the
thermodynamic limit.

Counterpart of ``contractn_tpu/models/fipeps_spin.py``.  The fermionized
double-layer rule of :mod:`.fipeps` is purely parity-graded, so spinful d=4
sites ride the d=2 machinery unchanged; what changes is

1. the physical parity vector: basis ``|0>, |dn>, |up>, |updn>`` at index
   ``n = 2 n_up + n_dn`` (occupied = index 1 per orbital, as in
   :mod:`.fswap`), parities ``(0, 1, 1, 0)``; and
2. the per-site operator matrices, with the intra-site part of the
   Jordan-Wigner string (up before down, row-major over sites) baked into the
   endpoint factors::

       s = up:  site i  kron(S+, Z)   site j  kron(S-, I)
       s = dn:  site i  kron(I,  S+)  site j  kron(Z,  S-)

The Hamiltonian is the 2D Hubbard model with an optional same-spin p-wave
pairing::

    H = sum_<ij> sum_s [-t (c^d_is c_js + h.c.) + delta (c^d_is c^d_js + h.c.)]
        + U sum_i n_iu n_idn - mu sum_i (n_iu + n_idn)

At ``U = 0`` it is two copies of the spinless p-wave model
(:func:`hubbard_u0_energy`).  The checkerboard cell (AFM order at half
filling) measures each of its eight bonds as one open-leg pair patch against
the summed two-site operator :func:`hubbard_op4`; the on-site terms go
through plain site patches.

The gradient loops are plain loops of device work (the JAX package's jitted
``lax.scan``s) with the parity-masked Adam of :mod:`.fipeps`.  Departures:
the ground-state drivers take ``device=`` (default ``cuda``) and draw their
starts on the host from ``seed`` as the JAX package does.
"""

import numpy as np
import torch

from ..utils.device import as_tensor, resolve_device, torch_dtype
from .ctmrg_cell import ctmrg_cell, pair_weight_h, rotate, site_expectation
from .fipeps import (
    H_RIGHT_EXTRA,
    V_BOT_EXTRA,
    V_TOP_EXTRA,
    _bond_energies,
    _cell_loss,
    _cellify,
    _masked_descent,
    bdg_energy_2d,
    fdouble,
    fdouble_open,
    parity_mask_site,
)

_SP = np.array([[0.0, 0.0], [1.0, 0.0]])  # creation |0> -> |1>
_SM = _SP.T
_I2 = np.eye(2)
_Z2 = np.diag([1.0, -1.0])
_N2 = np.diag([0.0, 1.0])

PHYS_PAR = np.array([0, 1, 1, 0])  # |0>, |dn>, |up>, |updn>

N_UP = np.kron(_N2, _I2)
N_DN = np.kron(_I2, _N2)
N_TOT = N_UP + N_DN
DOCC = np.kron(_N2, _N2)

# (coefficient name, op at the FIRST site, op at the SECOND site) in
# row-major JW order; intra-site string factors baked in
BOND_KINDS = (
    ("t", np.kron(_SP, _Z2), np.kron(_SM, _I2)),
    ("t", np.kron(_SM, _Z2), np.kron(_SP, _I2)),
    ("t", np.kron(_I2, _SP), np.kron(_Z2, _SM)),
    ("t", np.kron(_I2, _SM), np.kron(_Z2, _SP)),
    ("delta", np.kron(_SP, _Z2), np.kron(_SP, _I2)),
    ("delta", np.kron(_SM, _Z2), np.kron(_SM, _I2)),
    ("delta", np.kron(_I2, _SP), np.kron(_Z2, _SP)),
    ("delta", np.kron(_I2, _SM), np.kron(_Z2, _SM)),
)


def random_spinful_fpeps(ly, lx, bond_parities=(0, 1), seed=0):
    """Random parity-even SPINFUL fermionic PEPS on an open grid (host
    numpy), in the :func:`~.fswap.fpeps_amplitudes_dense` format (``d=4``,
    physical parities :data:`PHYS_PAR`)."""
    from .fswap import parity_even_tensor

    rng = np.random.default_rng(seed)
    bp = np.asarray(bond_parities)
    ph_vec = {(r, c): bp for r in range(ly) for c in range(lx - 1)}
    pv_vec = {(r, c): bp for r in range(ly - 1) for c in range(lx)}
    triv = np.zeros(1, np.int64)
    tensors = []
    for r in range(ly):
        row = []
        for c in range(lx):
            pu = pv_vec[(r - 1, c)] if r > 0 else triv
            pl = ph_vec[(r, c - 1)] if c > 0 else triv
            pd = pv_vec[(r, c)] if r < ly - 1 else triv
            pr = ph_vec[(r, c)] if c < lx - 1 else triv
            shape = (4, len(pu), len(pl), len(pd), len(pr))
            row.append(parity_even_tensor(rng, shape, [PHYS_PAR, pu, pl, pd, pr]))
        tensors.append(row)
    return tensors, ph_vec, pv_vec


def hubbard_fock_rowmajor(ly, lx, t=1.0, u=0.0, mu=0.0, delta=0.0):
    """Dense Fock matrix (host numpy) of the spinful Hamiltonian over ``2 *
    ly * lx`` spin-orbitals in fswap's row-major basis (orbital ``2 * (r *
    lx + c) + s``, up = 0; occupied = index 1), for enumerable lattices."""
    n = ly * lx
    no = 2 * n

    def op_at(mats):
        m = np.eye(1)
        for k in range(no):
            m = np.kron(m, mats.get(k, _I2))
        return m

    cs = [op_at({**{j: _Z2 for j in range(k)}, k: _SM}) for k in range(no)]
    h = np.zeros((2 ** no, 2 ** no))
    for r in range(ly):
        for c in range(lx):
            i = r * lx + c
            h += u * np.matmul(np.matmul(cs[2 * i].T, cs[2 * i]),
                               np.matmul(cs[2 * i + 1].T, cs[2 * i + 1]))
            for s in (0, 1):
                h += -mu * np.matmul(cs[2 * i + s].T, cs[2 * i + s])
            for (r2, c2) in ((r, c + 1), (r + 1, c)):
                if r2 >= ly or c2 >= lx:
                    continue
                j = r2 * lx + c2
                for s in (0, 1):
                    a, b = 2 * i + s, 2 * j + s
                    h += -t * (np.matmul(cs[a].T, cs[b]) + np.matmul(cs[b].T, cs[a]))
                    h += delta * (np.matmul(cs[a].T, cs[b].T) + np.matmul(cs[b], cs[a]))
    return h


# --------------------------------------------------------------------- #
# Thermodynamic limit (uniform 1x1 cell)
# --------------------------------------------------------------------- #


def hubbard_ipeps_measure(a, pars, env, t=1.0, u=4.0, mu=0.0, delta=0.0):
    """Energy per site of the spinful Hamiltonian in the given CTMRG
    environment; differentiable in ``a``.  Returns ``(energy, (n_up, n_dn,
    docc))`` as real 0-d tensors."""
    a = as_tensor(a, resolve_device(None, (a,)))
    cell = _cellify(fdouble(a, pars))
    nup = site_expectation(cell, env, fdouble(a, pars, op=N_UP))
    ndn = site_expectation(cell, env, fdouble(a, pars, op=N_DN))
    docc = site_expectation(cell, env, fdouble(a, pars, op=DOCC))
    bonds = _bond_energies(a, pars, BOND_KINDS, {"t": -t, "delta": delta}, cell, env)
    energy = u * docc - mu * (nup + ndn) + bonds
    return torch.real(energy), (torch.real(nup), torch.real(ndn), torch.real(docc))


def hubbard_ipeps_energy(a, pars, chi, t=1.0, u=4.0, mu=0.0, delta=0.0, iters=60):
    """Converge the environment, then measure.  Returns ``(energy_per_site,
    {"n_up", "n_dn", "docc"})`` as floats."""
    a = as_tensor(a, resolve_device(None, (a,)))
    env = ctmrg_cell(_cellify(fdouble(a, pars)), chi, iters=iters)
    e, (nup, ndn, docc) = hubbard_ipeps_measure(a, pars, env, t=t, u=u, mu=mu,
                                                delta=delta)
    return float(e), {"n_up": float(nup), "n_dn": float(ndn), "docc": float(docc)}


def make_hubbard_loss(pars, chi, t=1.0, u=4.0, mu=0.0, delta=0.0, refresh_iters=8,
                      grad_iters=4):
    """Differentiable energy ``(a, env) -> (E, env')``: untaped CTMRG refresh
    + ``svd_safe``-differentiated absorptions."""
    return _cell_loss(lambda a: _cellify(fdouble(a, pars)),
                      lambda a, env: hubbard_ipeps_measure(a, pars, env, t=t, u=u, mu=mu,
                                                           delta=delta)[0],
                      chi, refresh_iters, grad_iters)


def _start(init, seed, shape, device, dtype, mask):
    if init is None:
        rng = np.random.default_rng(seed)
        init = 0.08 * rng.standard_normal(shape)
        init[(0,) * len(shape)] = 1.0  # vacuum amplitude
    return as_tensor(init, device, dtype) * mask


def hubbard_ipeps_ground_state(bond_parities=(0, 1), chi=12, t=1.0, u=0.0, mu=0.0,
                               delta=0.0, steps=300, lr=2e-2, refresh_iters=8,
                               grad_iters=4, seed=0, init=None, env_iters=60,
                               dtype=torch.float64, device=None):
    """Gradient ground state of the spinful model in the thermodynamic limit
    (the :func:`~.fipeps.fipeps_ground_state` loop with the d=4 graded
    physical leg).  Returns ``(a, energy, obs, energies)``."""
    dtype = torch_dtype(dtype)
    device = resolve_device(device, (init,) if init is not None else ())
    bp = np.asarray(bond_parities)
    pars = (bp, bp, bp, bp)
    mask = parity_mask_site(pars, d=4, phys_par=PHYS_PAR, device=device).to(dtype)
    a = _start(init, seed, (4,) + (len(bp),) * 4, device, dtype, mask)
    env = ctmrg_cell(_cellify(fdouble(a, pars)), chi, iters=env_iters)
    loss = make_hubbard_loss(pars, chi, t=t, u=u, mu=mu, delta=delta,
                             refresh_iters=refresh_iters, grad_iters=grad_iters)
    (a,), env, es = _masked_descent(loss, [a], mask, env, steps, lr)
    e_final, obs = hubbard_ipeps_energy(a, pars, chi, t=t, u=u, mu=mu, delta=delta,
                                        iters=env_iters)
    return a, e_final, obs, es


def hubbard_u0_energy(t=1.0, mu=0.0, delta=0.0, nk=400):
    """Exact U=0 ground energy per site: two decoupled spinless p-wave
    copies (:func:`~.fipeps.bdg_energy_2d`)."""
    return 2.0 * bdg_energy_2d(t=t, mu=mu, delta=delta, nk=nk)


def hubbard_correlator(a, pars, env, distances, spin=0, kind="hop"):
    """Spin-resolved long-range ROW correlators: ``kind="hop"`` gives
    ``<c^d_{0,s} (string) c_{r,s}>``, ``"pair"`` the same-spin pairing
    correlator ``<c^d c^d>`` (the endpoint matrices of
    :data:`BOND_KINDS`, the path string by :data:`~.fipeps.H_MID_EXTRA`)."""
    from .fipeps import fipeps_correlator

    if spin == 0:
        o1 = np.kron(_SP, _Z2)
        o2 = np.kron(_SP if kind == "pair" else _SM, _I2)
    else:
        o1 = np.kron(_I2, _SP)
        o2 = np.kron(_Z2, _SP if kind == "pair" else _SM)
    return fipeps_correlator(a, pars, env, o1, o2, distances)


# --------------------------------------------------------------------- #
# Unit cells: checkerboard Hubbard (AFM order at half filling)
# --------------------------------------------------------------------- #


def hubbard_op4(t=1.0, delta=0.0):
    """Summed two-site operator ``op4[bra_l, bra_r, ket_l, ket_r]`` of one
    bond: all eight :data:`BOND_KINDS` in one host array.

    The on-site terms must NOT be folded in: the patch's second tensor
    carries the impurity ``extra`` signs (the absorbed string of parity-ODD
    endpoints), which a parity-even component would pick up wrongly
    (measured 5.6e-3 off on the chain anchors in the JAX package); they go
    through plain site patches (:func:`hubbard_cell_measure`).
    """
    coeff = {"t": -t, "delta": delta}
    op4 = np.zeros((4, 4, 4, 4))
    for name, o1, o2 in BOND_KINDS:
        op4 += coeff[name] * np.einsum("pP,qQ->PQpq", o1, o2)
    return op4


def _open_grid(sites, pars, extra):
    return tuple(tuple(fdouble_open(s, pars, extra=extra) for s in col) for col in sites)


def _as_sites(sites):
    leaves = [s for col in sites for s in col]
    device = resolve_device(None, leaves)
    return tuple(tuple(as_tensor(s, device) for s in col) for col in sites)


def _fcell(sites, pars):
    return tuple(tuple(fdouble(s, pars) for s in col) for col in sites)


def hubbard_cell_measure(sites, pars, env, t=1.0, u=4.0, mu=0.0, delta=0.0):
    """Energy per site of the spinful Hamiltonian on a 2x2 unit cell
    ``sites[x][y]`` in the given cell-CTMRG environment; differentiable in
    the site tensors.  Each of the eight bonds is one open-leg pair patch
    against :func:`hubbard_op4` (vertical ones through one lattice rotation,
    the extras applied before rotating).  A real 0-d tensor."""
    from .ipeps_cell import _pair_weight_cell_op

    sites = _as_sites(sites)
    lx, ly = len(sites), len(sites[0])
    if (lx, ly) != (2, 2):
        raise ValueError("hubbard_cell_measure supports 2x2 cells")
    like = sites[0][0]
    op4 = torch.from_numpy(hubbard_op4(t=t, delta=delta)).to(like.device, like.dtype)
    cell = _fcell(sites, pars)
    o_hl = _open_grid(sites, pars, ())
    o_hr = _open_grid(sites, pars, H_RIGHT_EXTRA)
    o_vt = _open_grid(sites, pars, V_TOP_EXTRA)
    o_vb = _open_grid(sites, pars, V_BOT_EXTRA)

    def h_bonds(cell_, env_, opens_l, opens_r):
        tot = torch.zeros((), dtype=like.dtype, device=like.device)
        for x in range(2):
            for y in range(2):
                x2 = (x + 1) % 2
                num = _pair_weight_cell_op(env_, cell_, x, y, opens_l[x][y],
                                           opens_r[x2][y], op4)
                den = pair_weight_h(cell_, env_, cell_[x][y], cell_[x2][y], x, y)
                tot = tot + num / den
        return tot

    total = h_bonds(cell, env, o_hl, o_hr)
    cell_r, env_r = rotate(cell, env)

    def rot_opens(opens):
        return tuple(tuple(opens[(-yp) % 2][xp].permute(0, 1, 5, 2, 3, 4)
                           for yp in range(2))
                     for xp in range(2))

    total = total + h_bonds(cell_r, env_r, rot_opens(o_vt), rot_opens(o_vb))
    # on-site terms through PLAIN site patches (see hubbard_op4)
    os_mat = u * DOCC - mu * N_TOT
    for x in range(2):
        for y in range(2):
            total = total + site_expectation(cell, env,
                                             fdouble(sites[x][y], pars, op=os_mat), x, y)
    return torch.real(total) / 4.0


def hubbard_cell_env(sites, pars, chi, iters=60):
    """Converged cell-CTMRG environment of the fermionized cell."""
    return ctmrg_cell(_fcell(_as_sites(sites), pars), chi, iters=iters)


def hubbard_cell_energy(sites, pars, chi, t=1.0, u=4.0, mu=0.0, delta=0.0, iters=60):
    """Converge the environment, measure the energy and the per-position
    observables.  Returns ``(energy, obs)`` with ``obs[name][x][y]`` floats
    for ``n_up / n_dn / docc``."""
    sites = _as_sites(sites)
    env = hubbard_cell_env(sites, pars, chi, iters=iters)
    e = hubbard_cell_measure(sites, pars, env, t=t, u=u, mu=mu, delta=delta)
    cell = _fcell(sites, pars)
    obs = {}
    for name, mat in (("n_up", N_UP), ("n_dn", N_DN), ("docc", DOCC)):
        vals = torch.stack([torch.real(site_expectation(
            cell, env, fdouble(sites[x][y], pars, op=mat), x, y))
            for x in range(2) for y in range(2)]).cpu()
        obs[name] = tuple(tuple(float(vals[2 * x + y]) for y in range(2)) for x in range(2))
    return float(e), obs


SZ = 0.5 * (N_UP - N_DN)


def hubbard_cell_correlator(sites, pars, env, mat1, mat2, distances, x=0, y=0,
                            connected=True):
    """Row correlators of parity-EVEN one-site operators (``SZ``, ``N_TOT``,
    ``DOCC``, ...) on a unit cell; ``mat2`` is applied to whichever cell
    site each distance lands on.  A list of floats."""
    from .ctmrg_cell import row_correlator

    sites = _as_sites(sites)
    cell = _fcell(sites, pars)
    i1 = fdouble(sites[x][y], pars, op=mat1)
    i2 = tuple(tuple(fdouble(s, pars, op=mat2) for s in col) for col in sites)
    vals = row_correlator(cell, env, i1, i2, list(distances), x=x, y=y,
                          connected=connected)
    return [float(torch.real(v)) for v in vals]


def make_hubbard_cell_loss(pars, chi, t=1.0, u=4.0, mu=0.0, delta=0.0,
                           refresh_iters=8, grad_iters=4):
    """Differentiable checkerboard energy ``((a, b), env) -> (E, env')``
    through the cell CTMRG."""
    def sites_of(ab):
        a, b = ab
        return ((a, b), (b, a))

    return _cell_loss(lambda ab: _fcell(sites_of(ab), pars),
                      lambda ab, env: hubbard_cell_measure(sites_of(ab), pars, env, t=t,
                                                           u=u, mu=mu, delta=delta),
                      chi, refresh_iters, grad_iters)


def neel_dimer_init(bond_parities=(0, 1), seed=0, noise=0.08):
    """Checkerboard start: up at A, down at B, horizontally dimerized (a
    singly-occupied site is parity-odd, so the Neel pattern threads its
    parity through a bond), plus parity-even noise.  Returns ``(a0, b0)``
    host numpy arrays."""
    bp = np.asarray(bond_parities)
    dd = len(bp)
    odd = int(np.argmax(bp == 1))
    rng = np.random.default_rng(seed)
    pars = (bp, bp, bp, bp)
    mask = parity_mask_site(pars, d=4, phys_par=PHYS_PAR, device="cpu").numpy()
    a0 = noise * rng.standard_normal((4,) + (dd,) * 4) * mask
    b0 = noise * rng.standard_normal((4,) + (dd,) * 4) * mask
    a0[2, 0, 0, 0, odd] += 1.0  # |up>, right leg odd
    b0[1, 0, odd, 0, 0] += 1.0  # |dn>, left leg odd
    return a0, b0


def hubbard_cell_ground_state(bond_parities=(0, 1), chi=12, t=1.0, u=8.0, mu=None,
                              delta=0.0, steps=200, lr=1e-2, refresh_iters=8,
                              grad_iters=4, seed=0, init=None, env_iters=60,
                              dtype=torch.float64, device=None):
    """Checkerboard gradient ground state of the 2D Hubbard model (AFM order
    at half filling on the two-sublattice cell).  ``mu`` defaults to the
    particle-hole symmetric point ``u / 2``.  Returns ``(a, b, energy, obs,
    energies)``."""
    dtype = torch_dtype(dtype)
    device = resolve_device(device, tuple(init) if init is not None else ())
    if mu is None:
        mu = u / 2.0
    bp = np.asarray(bond_parities)
    pars = (bp, bp, bp, bp)
    mask = parity_mask_site(pars, d=4, phys_par=PHYS_PAR, device=device).to(dtype)
    if init is None:
        init = neel_dimer_init(bond_parities, seed=seed)
    a = as_tensor(init[0], device, dtype) * mask
    b = as_tensor(init[1], device, dtype) * mask
    env = hubbard_cell_env(((a, b), (b, a)), pars, chi, iters=env_iters)
    loss = make_hubbard_cell_loss(pars, chi, t=t, u=u, mu=mu, delta=delta,
                                  refresh_iters=refresh_iters, grad_iters=grad_iters)
    (a, b), env, es = _masked_descent(loss, [a, b], mask, env, steps, lr)
    e_final, obs = hubbard_cell_energy(((a, b), (b, a)), pars, chi, t=t, u=u, mu=mu,
                                       delta=delta, iters=env_iters)
    return a, b, e_final, obs, es
