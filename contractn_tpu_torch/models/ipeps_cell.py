"""Two-sublattice iPEPS: checkerboard simple update + cell-CTMRG energies.

Counterpart of ``contractn_tpu/models/ipeps_cell.py``.  The single-site C4v
machinery of :mod:`.ipeps` cannot hold staggered order, and its symmetrized
simple update stalls for the Heisenberg antiferromagnet.  This is the
Jiang-Weng-Xiang scheme on the checkerboard: two tensors ``A, B (d, D, D, D,
D)`` and four independent bond weights ``lam_u, lam_l, lam_d, lam_r``
(named for the legs of ``A``; ``B``'s legs carry the partners ``(d, r, u,
l)``).  Each sweep gates the four bond orientations in turn; one orientation
is coded and the vertical bonds reuse it through a leg permutation.  No
averaging and no symmetrization, so a sign flip of one singular vector pair
(cuSOLVER signs them unlike LAPACK) is a gauge change of one bond that
cancels between ``u`` and ``vh``: the measured energies do not depend on it.

Energies are true variational expectation values: the pair becomes a 2x2
checkerboard of double layers, :func:`~.ctmrg_cell.ctmrg_cell` converges the
environment, and all eight bonds of the cell are measured with open-physical
pair patches (vertical ones after one lattice rotation).

Each Trotter stage is a plain loop of four SVDs a sweep on the device (the
JAX package's jitted ``fori_loop``), and :func:`ipeps_cell_scan` runs the
whole pipeline for a family of bond terms as one ``torch.func.vmap``
program: every op carries the family as a batch axis (batched SVDs and
einsums), with no per-member loop and no host read.

Departure: the simple update's default seed is drawn on the host from
``numpy.random.default_rng(0)``, as the JAX package draws it, so whole runs
compare with it.
"""

import numpy as np
import torch

from ..ops.linalg_ad import small_svd
from ..ops.stabilize import path_einsum, peinsum
from ..utils.device import as_tensor, real_dtype, resolve_device, torch_dtype
from .ctmrg_cell import ctmrg_cell, pair_weight_h, rotate, site_expectation
from .ipeps import peps_double_layer, peps_double_layer_open

_LAM_TOL = 1e-9  # relative cutoff for guarded bond-weight inverses


def _inv(lam):
    cut = _LAM_TOL * lam.max()
    return torch.where(lam > cut, 1.0 / torch.clamp(lam, min=1e-300), torch.zeros_like(lam))


def _legs(g, wu, wl, wd, wr):
    """``g (s, u, l, d, r)`` times a weight vector on each leg given (None
    skips a leg)."""
    for axis, w in ((1, wu), (2, wl), (3, wd), (4, wr)):
        if w is not None:
            shape = [1] * 5
            shape[axis] = -1
            g = g * w.to(g.dtype).reshape(shape)
    return g


def _renorm(g):
    return g / torch.clamp(torch.sqrt((g.abs() ** 2).sum()), min=1e-300)


def _su_pair(gl, gr, lam, wl_other, wr_other, gate):
    """One gate on the horizontal bond ``gl.r -- gr.l`` (weight ``lam``).

    ``wl_other = (w_u, w_l, w_d)`` are the weights on ``gl``'s other legs,
    ``wr_other = (w_u, w_d, w_r)`` those on ``gr``'s.  Absorb, gate, SVD back
    to the bond dimension, divide the outer weights out.  Returns ``(gl',
    gr', lam')``.
    """
    d, bond = gl.shape[0], gl.shape[1]
    lu1, ll1, ld1 = wl_other
    lu2, ld2, lr2 = wr_other

    wl = _legs(gl, lu1, ll1, ld1, lam)
    wr = _legs(gr, lu2, None, ld2, lr2)
    theta = peinsum("sulxm,tvmyr->sulxtvyr", wl, wr)
    theta = peinsum("STst,sulxtvyr->SulxTvyr", gate.reshape(d, d, d, d), theta)
    mat = theta.reshape(d * bond ** 3, d * bond ** 3)
    u, s, vh = small_svd(mat)
    u, s, vh = u[:, :bond], s[:bond], vh[:bond]
    lam_new = s / torch.clamp(torch.linalg.norm(s), min=1e-300)

    g1 = _legs(u.reshape(d, bond, bond, bond, bond), _inv(lu1), _inv(ll1), _inv(ld1), None)
    g2 = vh.reshape(bond, d, bond, bond, bond).permute(1, 2, 0, 3, 4)
    g2 = _legs(g2, _inv(lu2), None, _inv(ld2), _inv(lr2))
    return _renorm(g1), _renorm(g2), lam_new


_VPERM = (0, 4, 1, 2, 3)      # rotate legs so "down" becomes "right"
_VPERM_INV = (0, 2, 3, 4, 1)


def _sweep(carry, gate):
    """Gate all four bond orientations once (r, l, d, u bonds of A)."""
    ga, gb, lu, ll, ld, lr = carry
    # A.r -- B.l (weight lam_r); B's legs (u, d, r) carry (ld, lu, ll)
    ga, gb, lr = _su_pair(ga, gb, lr, (lu, ll, ld), (ld, lu, ll), gate)
    # B.r -- A.l (lam_l)
    gb, ga, ll = _su_pair(gb, ga, ll, (ld, lr, lu), (lu, ld, lr), gate)
    # vertical bonds: permute legs so down plays right
    pa, pb = ga.permute(_VPERM), gb.permute(_VPERM)
    # A.d -- B.u (lam_d): permuted legs (u', l', d') of A = (r, u, l)
    pa, pb, ld = _su_pair(pa, pb, ld, (lr, lu, ll), (ll, lr, lu), gate)
    # B.d -- A.u (lam_u)
    pb, pa, lu = _su_pair(pb, pa, lu, (ll, ld, lr), (lr, ll, ld), gate)
    return (pa.permute(_VPERM_INV), pb.permute(_VPERM_INV), lu, ll, ld, lr)


def _su_stage(carry, gate, n_iter):
    for _ in range(int(n_iter)):
        carry = _sweep(carry, gate)
    return carry


def _default_seed(d, bond_dim):
    """The symmetry-broken two-sublattice product start plus noise, drawn on
    the host as the JAX package draws it."""
    rng = np.random.default_rng(0)
    va = np.cos(0.2 + 0.3 * np.arange(d))
    vb = np.cos(1.2 + 0.7 * np.arange(d))
    va, vb = va / np.linalg.norm(va), vb / np.linalg.norm(vb)
    ga = np.zeros((d,) + (bond_dim,) * 4)
    gb = np.zeros((d,) + (bond_dim,) * 4)
    ga[(slice(None),) + (0,) * 4] = va
    gb[(slice(None),) + (0,) * 4] = vb
    ga = ga + 0.02 * rng.normal(size=ga.shape)
    gb = gb + 0.02 * rng.normal(size=gb.shape)
    return ga, gb


def simple_update_cell(h2, bond_dim, d=2,
                       schedule=((0.1, 200), (0.02, 200), (0.005, 100)),
                       dtype=torch.float64, init=None):
    """Checkerboard (two-site cell) simple-update imaginary-time flow.

    Args:
        h2: nearest-neighbor bond term ``(d^2, d^2)`` applied to every bond,
            always ordered (A-site, B-site) (correct for swap-symmetric
            terms such as Heisenberg or TFIM).  A torch tensor keeps its
            device (and ``init``'s); a numpy array goes to ``cuda``.
        bond_dim: PEPS virtual dimension D.
        schedule: ``((dt, n_sweeps), ...)`` Trotter ladder.
        init: optional ``(gamma_a, gamma_b)`` seed tensors; default is a
            symmetry-broken two-sublattice product state plus noise.

    Returns:
        ``(gamma_a, gamma_b, lams)`` with ``lams = (lam_u, lam_l, lam_d,
        lam_r)`` named for the legs of ``A``.
    """
    from .itebd import two_site_gate

    dtype = torch_dtype(dtype)
    device = resolve_device(None, (h2,) + (tuple(init) if init is not None else ()))
    if init is None:
        init = _default_seed(d, bond_dim)
    ga, gb = (as_tensor(t, device, dtype) for t in init)
    # bond weights are singular values: REAL even for complex dtypes
    lam = torch.ones((bond_dim,), dtype=real_dtype(dtype), device=device) / np.sqrt(bond_dim)
    carry = (ga, gb, lam, lam, lam, lam)
    h2 = as_tensor(h2, device, dtype)
    for dt, n_iter in schedule:
        carry = _su_stage(carry, two_site_gate(h2, dt), n_iter)
    ga, gb, lu, ll, ld, lr = carry
    return ga, gb, (lu, ll, ld, lr)


def su_cell_absorb(gamma_a, gamma_b, lams):
    """Measurable ``(A, B)``: ``sqrt(lam)`` absorbed on every bond once (A's
    legs carry ``(u, l, d, r)`` weights, B's the partners ``(d, r, u,
    l)``)."""
    lu, ll, ld, lr = (torch.sqrt(x) for x in lams)
    return _legs(gamma_a, lu, ll, ld, lr), _legs(gamma_b, ld, lr, lu, ll)


# --------------------------------------------------------------------- #
# Cell-CTMRG measurement
# --------------------------------------------------------------------- #


def _pair_weight_cell_op(env, cell, x, y, ao_l, ao_r, op4):
    """The horizontal pair patch with OPEN pair tensors ``(d, d, q, q, q,
    q)`` contracted against ``op4[s1', s2', s1, s2]`` (bra first)."""
    c1, c2, c3, c4, t1, t2, t3, t4 = env
    x2 = (x + 1) % len(cell)
    return path_einsum(
        "ab,auc,cve,ef,blg,pPuldw,qQvwyr,frh,gi,idj,jyk,hk,PQpq->",
        c1[x][y], t1[x][y], t1[x2][y], c2[x2][y], t4[x][y],
        ao_l, ao_r, t2[x2][y], c4[x][y], t3[x][y], t3[x2][y], c3[x2][y], op4)


def checkerboard_cell(a_site, b_site):
    """The 2x2 double-layer cell ``((A, B), (B, A))`` of a pair."""
    na, nb = peps_double_layer(a_site), peps_double_layer(b_site)
    return ((na, nb), (nb, na))


def _pair(a_site, b_site):
    a_site = as_tensor(a_site, resolve_device(None, (a_site,)))
    return a_site, as_tensor(b_site, a_site.device, a_site.dtype)


def cell_energy_from_env(a_site, b_site, h2, cell, env):
    """Energy per site measured in a GIVEN converged environment
    (differentiable: the variational optimizer carries its own refreshed
    environment)."""
    a_site, b_site = _pair(a_site, b_site)
    d = a_site.shape[0]
    op4 = as_tensor(h2, a_site.device, a_site.dtype).reshape(d, d, d, d)
    ao_a = peps_double_layer_open(a_site)
    ao_b = peps_double_layer_open(b_site)
    opens = ((ao_a, ao_b), (ao_b, ao_a))

    def h_bonds(cell_, env_, opens_):
        tot = 0.0
        lx, ly = len(cell_), len(cell_[0])
        for x in range(lx):
            for y in range(ly):
                x2 = (x + 1) % lx
                num = _pair_weight_cell_op(env_, cell_, x, y, opens_[x][y],
                                           opens_[x2][y], op4)
                den = pair_weight_h(cell_, env_, cell_[x][y], cell_[x2][y], x, y)
                tot = tot + num / den
        return tot

    total = h_bonds(cell, env, opens)
    # vertical bonds: rotate the whole state a quarter turn (open tensors
    # rotate like sites on their virtual legs: (p, P, u, l, d, r) -> (p, P,
    # r, u, l, d))
    cell_r, env_r = rotate(cell, env)
    lx, ly = len(opens), len(opens[0])
    opens_r = tuple(tuple(opens[(-yp) % lx][xp].permute(0, 1, 5, 2, 3, 4)
                          for yp in range(lx))
                    for xp in range(ly))
    return (total + h_bonds(cell_r, env_r, opens_r)) / 4.0


def cell_energy(a_site, b_site, h2, chi, iters=150):
    """Energy per site of ``H = sum_<ij> h2`` on the checkerboard state.

    Builds the 2x2 double-layer cell, converges its directional environment
    once and measures all eight bonds of the cell; ``h2`` acts as
    ``op4[s_bra_left, s_bra_right, s_ket_left, s_ket_right]`` with the left
    factor on the left/upper site of each bond.  A 0-d tensor on the
    tensors' device.
    """
    a_site, b_site = _pair(a_site, b_site)
    cell = checkerboard_cell(a_site, b_site)
    env = ctmrg_cell(cell, chi, iters=iters)
    return cell_energy_from_env(a_site, b_site, h2, cell, env)


def cell_site_expectations(a_site, b_site, op, chi, iters=150):
    """One-site ``<op>`` at every cell position (2x2 nested tuple of 0-d
    tensors), e.g. the staggered magnetization of a Neel state."""
    a_site, b_site = _pair(a_site, b_site)
    ia, ib = peps_double_layer(a_site, op), peps_double_layer(b_site, op)
    cell = checkerboard_cell(a_site, b_site)
    imps = ((ia, ib), (ib, ia))
    env = ctmrg_cell(cell, chi, iters=iters)
    return tuple(tuple(site_expectation(cell, env, imps[x][y], x, y) for y in range(2))
                 for x in range(2))


def ipeps_cell_ground_state(h2, bond_dim, chi, d=2,
                            schedule=((0.1, 200), (0.02, 200), (0.005, 100)),
                            iters=150, dtype=torch.float64, init=None):
    """Checkerboard ground state by the two-site-cell simple update, with the
    true variational energy from the directional cell CTMRG.

    Returns ``(a_site, b_site, energy_per_site)`` (the energy a 0-d tensor).
    """
    ga, gb, lams = simple_update_cell(h2, bond_dim, d=d, schedule=schedule,
                                      dtype=dtype, init=init)
    a_site, b_site = su_cell_absorb(ga, gb, lams)
    return a_site, b_site, cell_energy(a_site, b_site, h2, chi, iters=iters)


def ipeps_cell_scan(h2_batch, bond_dim, chi, d=2,
                    schedule=((0.1, 150), (0.02, 150), (0.005, 80)),
                    iters=120, ops=(), dtype=torch.float64, init=None):
    """Batched checkerboard ground states over a FAMILY of bond terms, the 2D
    analog of :func:`~.ensemble.dmrg_ensemble`.

    The whole pipeline (gates from each ``h2``, the simple update, the
    directional CTMRG, the eight-bond energy and the requested one-site
    observables) is one ``torch.func.vmap`` program over the family: every
    launch carries all members (batched einsums and SVDs), the per-member
    code is the unbatched one, and nothing is read on the host.

    Args:
        h2_batch: ``(B, d^2, d^2)`` bond terms (a torch tensor keeps its
            device; numpy goes to ``cuda``).
        ops: one-site observables ``(d, d)`` measured at cell site (0, 0) of
            each member.

    Returns:
        dict with ``a, b`` (batched site tensors), ``energy (B,)`` and
        ``moments (B, len(ops))``.
    """
    dtype = torch_dtype(dtype)
    device = resolve_device(None, (h2_batch,))
    h2_batch = as_tensor(h2_batch, device, dtype)
    ops_arr = (torch.stack([as_tensor(o, device, dtype) for o in ops]) if ops
               else torch.zeros((0, d, d), dtype=dtype, device=device))
    if init is not None:
        init = tuple(as_tensor(t, device, dtype) for t in init)
    a, b, energy, moments = _scan_core(
        h2_batch, ops_arr, init, bond_dim, chi, d,
        tuple((float(t), int(n)) for t, n in schedule), int(iters))
    return {"a": a, "b": b, "energy": energy, "moments": moments}


def _scan_core(h2_batch, ops_arr, init, bond_dim, chi, d, schedule, iters):
    """The batched core of :func:`ipeps_cell_scan`: the unbatched pipeline
    under ``torch.func.vmap`` over the leading axis of ``h2_batch``, kept
    separate so a sharded wrapper can run the identical per-member program."""
    dtype = h2_batch.dtype
    if init is None:
        # drawn here, outside vmap: the host draw is the same for every member
        init = tuple(as_tensor(t, h2_batch.device, dtype) for t in _default_seed(d, bond_dim))

    def single(h2):
        ga, gb, lams = simple_update_cell(h2, bond_dim, d=d, schedule=schedule,
                                          dtype=dtype, init=init)
        a_site, b_site = su_cell_absorb(ga, gb, lams)
        cell = checkerboard_cell(a_site, b_site)
        env = ctmrg_cell(cell, chi, iters=iters)
        energy = torch.real(cell_energy_from_env(a_site, b_site, h2, cell, env))
        moms = [torch.real(site_expectation(cell, env, peps_double_layer(a_site, ops_arr[i]),
                                            0, 0))
                for i in range(ops_arr.shape[0])]
        moments = torch.stack(moms) if moms else torch.zeros((0,), dtype=energy.dtype,
                                                             device=energy.device)
        return a_site, b_site, energy, moments

    return torch.func.vmap(single)(h2_batch)
