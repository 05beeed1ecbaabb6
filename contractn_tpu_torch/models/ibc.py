"""Infinite boundary conditions: local quenches in the thermodynamic limit.

Counterpart of ``contractn_tpu/models/ibc.py``.  A uniform ground state
supplies EXACT semi-infinite surroundings for a finite window of sites: the
norm environments of the ``...AL AL [window] AR AR...`` embedding are
identities and the Hamiltonian environments are the quasi-fixed points
``FL/FR`` of :func:`~.vumps.mpo_environments`.  A local operator applied
inside the window then propagates through a genuinely INFINITE chain until
the light cone reaches the window edge (pick ``n_sites > 2 v_max t`` —
Phien/Vidal/McCulloch, PRB 86, 245107).

The window evolves by the two-site TDVP integrator of the finite chains
(:mod:`.tdvp`: symmetric second order, Krylov exponentials on the device,
SVD bond growth up to ``max_bond``); only the boundary environments differ
(``(D, W, D)`` tensors instead of the finite chain's weight vectors).
Observables never assume a canonical gauge: :func:`window_expectations`
contracts explicit norm environments from the identity edges.

At finite temperature (:func:`ibc_thermal_correlator`) a thermal
purification plays the ground state's role: it is an exact zero mode of the
balanced generator ``H (x) I - I (x) H^T`` (:func:`~.thermal.balanced_umpo`),
so it supplies stationary environments for the window.
"""

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device
from .dmrg import _split_theta, _update_left, _update_right
from .tdvp import _evolve_one_site, _evolve_two_site
from .vumps import mpo_environments


def ibc_window(ground, w_cell, n_sites):
    """Embed an ``n_sites`` window into a uniform ground state.

    Args:
        ground: a :func:`~.vumps.vumps` result dict (needs ``al, ar, c``).
        w_cell: the triangular bulk MPO core ``(d, d, W, W)`` the ground
            state was solved with (identity corners); it goes to the
            ground's device.
        n_sites: window width (``> 2 v_max t`` for the planned horizon).

    Returns:
        A window dict: ``sites`` (ragged ``(d, Dl, Dr)`` tensors, window
        gauge ``AC AR ... AR``), ``w`` (bulk core), ``env_left`` /
        ``env_right`` (Hamiltonian boundary environments in the sweep layout
        ``(bra D, W, ket D)``) and ``e_bulk`` (ground energy per site, a
        host float).
    """
    if n_sites < 2:
        raise ValueError("ibc_window needs n_sites >= 2")
    al, ar, c = ground["al"], ground["ar"], ground["c"]
    w = as_tensor(w_cell, al.device)
    fl, fr, e = mpo_environments(al, ar, c, w)
    ac = peinsum("dij,jk->dik", al, c)
    return {
        "sites": [ac] + [ar] * (int(n_sites) - 1),
        "w": w,
        # mpo_environments layout: FL (W, bra, ket), FR (W, ket, bra); the
        # sweep environments (_update_left/right) are (bra, W, ket).
        "env_left": fl.permute(1, 0, 2),
        "env_right": fr.permute(2, 0, 1),
        "e_bulk": float(e),
    }


def window_apply_local(window, op, site):
    """Apply a one-site operator inside the window (a NEW window dict;
    non-unitary operators are fine — the evolver renormalizes)."""
    sites = list(window["sites"])
    s = sites[site]
    sites[site] = peinsum("st,tij->sij", as_tensor(op, s.device, s.dtype), s)
    return {**window, "sites": sites}


def window_apply_bond(window, gate, site, max_bond=None):
    """Apply a two-site operator ``gate (d^2, d^2)`` to window sites
    ``(site, site + 1)`` — exact by default (``max_bond=None`` keeps the
    full SVD rank).  The split's unit normalization is undone so the window
    keeps the operator's amplitude."""
    sites = list(window["sites"])
    k1, k2 = sites[site], sites[site + 1]
    d = k1.shape[0]
    theta = peinsum("apj,bjq->abpq", k1, k2)
    g = as_tensor(gate, k1.device, theta.dtype).reshape(d, d, d, d)
    theta = peinsum("ABab,abpq->ABpq", g, theta)
    nrm = torch.linalg.norm(theta)
    cap = theta.shape[0] * min(theta.shape[2], theta.shape[3])
    t1, t2 = _split_theta(theta, cap if max_bond is None else max_bond,
                          to_left=True)
    sites[site], sites[site + 1] = t1, t2 * nrm.to(t2.dtype)
    return {**window, "sites": sites}


def _common_dtype(bs, ks):
    return torch.promote_types(bs[0].dtype, ks[0].dtype)


def _left_envs(bs, ks, dt, n):
    ls = [torch.eye(bs[0].shape[1], dtype=dt, device=bs[0].device)]
    for i in range(n):
        t = peinsum("xy,tyq->txq", ls[-1], ks[i].to(dt))
        ls.append(peinsum("sxp,sxq->pq", bs[i].conj().to(dt), t))
    return ls


def _right_envs(bs, ks, dt, stop):
    n = len(bs)
    rs = [None] * (n + 1)
    rs[n] = torch.eye(bs[-1].shape[2], dtype=dt, device=bs[0].device)
    for i in range(n - 1, stop - 1, -1):
        t = peinsum("syq,pq->syp", ks[i].to(dt), rs[i + 1])
        rs[i] = peinsum("sxp,syp->xy", bs[i].conj().to(dt), t)
    return rs


def window_overlaps_bond(bra_window, ket_window, gate):
    """``<bra| G_{i, i+1} |ket>`` for every window bond ``i`` in one pass
    (``n_sites - 1`` values, a 1-d tensor) — the two-site analog of
    :func:`window_overlaps_local`, same shared-embedding contract."""
    bs, ks = bra_window["sites"], ket_window["sites"]
    n = len(bs)
    d = bs[0].shape[0]
    dt = _common_dtype(bs, ks)
    g = as_tensor(gate, bs[0].device, dt).reshape(d, d, d, d)
    ls = _left_envs(bs, ks, dt, n - 1)
    rs = _right_envs(bs, ks, dt, 1)
    vals = []
    for i in range(n - 1):
        kt = peinsum("xy,ayj->axj", ls[i], ks[i].to(dt))
        kt = peinsum("axj,bjq->abxq", kt, ks[i + 1].to(dt))
        kt = peinsum("ABab,abxq->ABxq", g, kt)
        bt = peinsum("Axm,Bmp->ABxp", bs[i].conj().to(dt),
                     bs[i + 1].conj().to(dt))
        num = peinsum("ABxp,ABxq->pq", bt, kt)
        vals.append(peinsum("pq,pq->", num, rs[i + 2]))
    return torch.stack(vals)


def window_expectations(window, op):
    """One-site expectations on every window site (gauge-free: explicit
    norm environments from the identity edges); a 1-d tensor."""
    sites = window["sites"]
    n = len(sites)
    op = as_tensor(op, sites[0].device, sites[0].dtype)
    rs = _right_envs(sites, sites, sites[0].dtype, 0)
    left = torch.eye(sites[0].shape[1], dtype=sites[0].dtype,
                     device=sites[0].device)
    vals = []
    norm = None
    for i in range(n):
        t = peinsum("xy,tyq->txq", left, sites[i])
        top = peinsum("st,txq->sxq", op, t)
        num = peinsum("sxp,sxq->pq", sites[i].conj(), top)
        vals.append(peinsum("pq,pq->", num, rs[i + 1]))
        nxt = peinsum("sxp,sxq->pq", sites[i].conj(), t)
        if norm is None:
            norm = peinsum("pq,pq->", nxt, rs[1])
        left = nxt
    return torch.stack(vals) / norm


def window_overlaps_local(bra_window, ket_window, op=None):
    """``<bra| op_j |ket>`` for every window site ``j`` in one pass (a 1-d
    tensor).

    Both windows must share the embedding (same AL/AR outside, same edge
    bond dimensions).  ``op=None`` returns the plain overlap ``<bra|ket>``
    (a 0-d tensor)."""
    bs, ks = bra_window["sites"], ket_window["sites"]
    n = len(bs)
    dt = _common_dtype(bs, ks)
    ls = _left_envs(bs, ks, dt, n)
    if op is None:
        return torch.trace(ls[-1])
    rs = _right_envs(bs, ks, dt, 0)
    opj = as_tensor(op, bs[0].device, dt)
    vals = []
    for i in range(n):
        t = peinsum("xy,tyq->txq", ls[i], ks[i].to(dt))
        t = peinsum("st,txq->sxq", opj, t)
        num = peinsum("sxp,sxq->pq", bs[i].conj().to(dt), t)
        vals.append(peinsum("pq,pq->", num, rs[i + 1]))
    return torch.stack(vals)


def ibc_dynamic_correlator(ground, w_cell, op_b, op_a, n_sites, site_b,
                           dt, n_steps, max_bond=None, iters=16,
                           bond_b=False, bond_a=False):
    """Real-time correlator ``C[j, k] = <gs| A_j(t_k) B_{site_b} |gs>``
    (``t_k = k dt``) in the thermodynamic limit.

    ``B`` is applied at window site ``site_b``; the quenched window evolves
    by :func:`window_evolve` while a REFERENCE ground window evolves
    alongside: its overlap with the t=0 window is the pure phase
    accumulated by the effective Hamiltonian's environment constant, and
    dividing it out gives physical ``e^{i E0 t}``-corrected correlators
    (the same division cancels the symmetric slow norm loss of the SVD
    truncations to first order).

    Returns a complex ``(n_sites, n_steps + 1)`` numpy array (one host read
    a step).  ``bond_b`` / ``bond_a`` switch either operator to a two-site
    ``(d^2, d^2)`` bond operator (a bond-operator A returns ``n_sites - 1``
    rows).
    """
    win = ibc_window(ground, w_cell, n_sites)
    if bond_b:
        ket = window_apply_bond(win, op_b, site_b)
    else:
        ket = window_apply_local(win, op_b, site_b)

    def measure(bra, kw):
        if bond_a:
            return window_overlaps_bond(bra, kw, op_a)
        return window_overlaps_local(bra, kw, op_a)

    # the evolver renormalizes per step; restore the quench amplitude
    # ||B|gs>|| explicitly
    nb = float(torch.sqrt(torch.real(window_overlaps_local(ket, ket))))
    ref = win
    rows = [measure(win, ket).cpu().numpy()]
    for _ in range(int(n_steps)):
        ket = _window_step(ket, dt, max_bond=max_bond, iters=iters)
        ref = _window_step(ref, dt, max_bond=max_bond, iters=iters)
        phase = complex(window_overlaps_local(win, ref))
        rows.append(measure(win, ket).cpu().numpy() * (nb / phase))
    return np.stack(rows, axis=1)


def ibc_thermal_correlator(thermal_core, h_core, op_b, op_a, n_sites,
                           site_b, dt, n_steps, max_bond=None, iters=16,
                           gauge_iters=60, bond_b=False, bond_a=False):
    """Finite-temperature real-time correlator in the thermodynamic limit:
    ``C[j, k] = <A_j(t_k) B_{site_b}>_beta = Tr(rho A_j(t_k) B_{site_b})``.

    The thermal purification (a :func:`~.thermal.thermal_wii` core, folded
    ``d^2`` sites, on its device) is an exact zero mode of the balanced
    generator, so it supplies stationary environments for an
    :func:`ibc_window` while ``B (x) I`` applied inside the window
    propagates through the infinite thermal background:
    ``<rho^{1/2}| (A (x) I) e^{-iLt} (B (x) I) |rho^{1/2}> = Tr(rho A(t)
    B)``.

    Args:
        thermal_core: folded ``(d^2, D, D)`` uniform purification core.
        h_core: the PHYSICAL ``(d, d, W, W)`` triangular bulk core.
        op_b / op_a: physical one-site operators (lifted internally).
        n_sites, site_b, dt, n_steps, max_bond, iters: as in
            :func:`ibc_dynamic_correlator`.

    Returns a complex ``(n_sites, n_steps + 1)`` numpy array; the t=0 row is
    the static thermal correlator.
    """
    from .thermal import _fold_gate, _fold_op, balanced_umpo
    from .vumps import mixed_gauge

    core = as_tensor(thermal_core, resolve_device(None, (thermal_core,)))
    w = as_tensor(h_core, core.device)
    d = w.shape[0]
    al, ar, c = mixed_gauge(core, iters=gauge_iters)
    ground = {"al": al, "ar": ar, "c": c}

    def lift(op, bond):
        # physical bond operators lift through _fold_gate (identity on both
        # ancillas); one-site through _fold_op
        return _fold_gate(op, d) if bond else _fold_op(op, d)

    return ibc_dynamic_correlator(
        ground, balanced_umpo(w),
        lift(op_b, bond_b), lift(op_a, bond_a),
        n_sites, site_b, dt, n_steps, max_bond=max_bond, iters=iters,
        bond_b=bond_b, bond_a=bond_a)


def ibc_spectral_function(corr, site_b, dt, ks, omegas, eta=None):
    """``S(k, w)`` from an :func:`ibc_dynamic_correlator` signal (host
    numpy post-processing).

    Space-time Fourier transform with a Gaussian damping window ``exp(-eta
    t^2)`` (default ``8 / t_max^2``) and the ``t < 0`` half restored by
    hermiticity (``C(j, -t) = conj(C(j, t))`` for Hermitian A = B in a real
    ground state).  Returns ``(len(ks), len(omegas))`` real values.
    """
    corr = np.asarray(corr)
    n, nt = corr.shape
    t_max = dt * (nt - 1)
    if eta is None:
        eta = 8.0 / max(t_max, 1e-30) ** 2
    js = np.arange(n) - int(site_b)
    ck = np.einsum("kj,jt->kt",
                   np.exp(-1j * np.outer(np.asarray(ks), js)), corr)
    ts = dt * np.arange(nt)
    damp = np.exp(-eta * ts ** 2)
    damp[0] *= 0.5  # trapezoid endpoint; t=0 shared by both halves
    damp[-1] *= 0.5
    phase = np.exp(1j * np.outer(np.asarray(omegas), ts))  # (w, t)
    half = np.einsum("wt,kt->wk", phase, ck * damp[None, :])
    return 2.0 * np.real(half).T * dt


def window_evolve(window, dt, n_steps, max_bond=None, imaginary=False,
                  iters=16, callback=None):
    """Evolve the window ``n_steps`` symmetric two-site TDVP steps under the
    infinite-chain effective Hamiltonian (``exp(-1j dt H)`` per step, or
    ``exp(-dt H)`` with ``imaginary=True``); the interior bonds grow up to
    ``max_bond`` (default: keep the largest current bond), the two edge
    bonds stay at the uniform ground bond dimension.  ``callback(k,
    window)`` runs after each step.  Returns the evolved window dict.
    """
    out = window
    for k in range(int(n_steps)):
        out = _window_step(out, dt, max_bond=max_bond, imaginary=imaginary,
                           iters=iters)
        if callback is not None:
            callback(k, out)
    return out


def _window_step(window, dt, max_bond=None, imaginary=False, iters=16):
    sites = list(window["sites"])
    n = len(sites)
    w = window["w"]
    if max_bond is None:
        max_bond = max(max(s.shape[1], s.shape[2]) for s in sites)
    fwd = -0.5 * dt if imaginary else -0.5j * dt
    bwd = -fwd
    if not imaginary:
        sites = [s.to(torch.promote_types(s.dtype, torch.complex64))
                 for s in sites]
    dtype = sites[0].dtype
    w = w.to(torch.promote_types(w.dtype, dtype))
    L = [None] * (n + 1)
    R = [None] * (n + 1)
    L[0] = window["env_left"].to(dtype)
    R[n] = window["env_right"].to(dtype)
    for i in range(n - 1, 0, -1):
        R[i] = _update_right(R[i + 1], sites[i], w)

    def sweep(order, left_to_right):
        for idx, i in enumerate(order):
            theta = peinsum("apj,bjq->abpq", sites[i], sites[i + 1])
            theta = _evolve_two_site(L[i], w, w, R[i + 2], theta, iters, fwd)
            last_pair = idx == len(order) - 1
            if left_to_right:
                sites[i], sites[i + 1] = _split_theta(theta, max_bond,
                                                      to_left=True)
                L[i + 1] = _update_left(L[i], sites[i], w)
                if not last_pair:
                    sites[i + 1] = _evolve_one_site(
                        L[i + 1], w, R[i + 2], iters, sites[i + 1], bwd)
            else:
                sites[i], sites[i + 1] = _split_theta(theta, max_bond,
                                                      to_left=False)
                R[i + 1] = _update_right(R[i + 2], sites[i + 1], w)
                if not last_pair:
                    sites[i] = _evolve_one_site(
                        L[i], w, R[i + 1], iters, sites[i], bwd)

    sweep(list(range(n - 1)), left_to_right=True)
    sweep(list(range(n - 2, -1, -1)), left_to_right=False)
    sites[0] = sites[0] / torch.clamp(torch.linalg.norm(sites[0]), min=1e-300)
    return {**window, "sites": sites}
