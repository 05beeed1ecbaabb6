"""Infinite-chain thermal states: purification iTEBD at finite T.

Counterpart of ``contractn_tpu/models/thermal.py``.  The Gibbs state ``rho =
exp(-beta H) / Z`` of an infinite chain is represented by its purification
``|psi_beta> = exp(-beta H / 2) (x) 1 |I>`` where ``|I>`` is the site-wise
maximally entangled physical-ancilla pair (infinite temperature, bond
dimension 1).  Imaginary-time iTEBD evolves ``|I>`` by ``beta / 2`` with
second-order Trotter gates acting on the PHYSICAL legs only; thermal
expectation values are then pure-state expectations on the purification,
and the per-gate norm growth accumulates ``ln Z`` per site exactly — the
split-format log register applied to a thermal trace.

The folded site has local dimension ``d^2`` (physical (x) ancilla) and rides
the :mod:`.itebd` Vidal machinery: a Trotter stage is a plain loop on the
state's device with static ``(d^2, D)`` shapes, and the ``ln Z``
accumulator stays a 0-d tensor there (one host read when the stage ends).

Accounting for ``ln Z``: each bond update with pre-gate two-site norm
``n0`` and post-gate norm ``n1`` contributes ``log(n1 / n0)``, so ``ln Z /
N = ln d + sum ln(n1/n0)`` over the unit-cell updates (checked at ``beta =
0``: ``ln Z = ln d``, free spins).

Measure energies and one-site values through the blocked cell core's
transfer fixed points (:func:`thermal_cell_core` ->
:func:`~.umps.expect_local`), never through the lambda^2 environments of the
Vidal form: non-unitary gates leave an ``O(dbeta)`` residual
non-canonicality, which the lambda^2 route turns into a first-order error.

Long-range Hamiltonians go through the imaginary-time uniform W^II route
(:func:`thermal_wii`) on the :func:`fold_umpo`-lifted bulk core;
:func:`balanced_umpo` builds the balanced generator ``H (x) I - I (x) H^T``
that the finite-temperature IBC windows (:mod:`.ibc`) evolve with.
"""

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device, torch_dtype
from .itebd import two_site_gate, unit_cell_core
from .umps import expect_local

_LAM_TOL = 1e-9


def _fold_gate(g2, d):
    """Lift a two-site physical gate ``(d^2, d^2)`` to the purified site
    pair ``(d^4, d^4)``: identity on both ancillas (host numpy)."""
    if isinstance(g2, torch.Tensor):
        g2 = g2.detach().cpu().numpy()
    g = np.asarray(g2).reshape(d, d, d, d)  # (s1 s2, s1' s2')
    eye = np.eye(d)
    out = np.einsum("stuv,ac,bd->satbucvd", g, eye, eye)
    return out.reshape(d * d * d * d, d * d * d * d)


def _fold_op(op, d):
    """Lift a one-site physical operator to the purified site (host
    numpy)."""
    out = np.einsum("su,ab->saub", np.asarray(op), np.eye(d))
    return out.reshape(d * d, d * d)


def _bond_update_norm(ga, gb, la, lb, gate):
    """Vidal bond update that also returns ``log(n1 / n0)`` (a 0-d tensor)
    — the gate's contribution to the per-site ``ln Z``."""
    d, bond, _ = ga.shape
    cut = _LAM_TOL * lb.max()
    linv = torch.where(lb > cut, 1.0 / torch.clamp(lb, min=1e-300),
                       torch.zeros_like(lb))
    left = ga * lb[None, :, None] * la[None, None, :]
    theta0 = peinsum("sij,tjk->stik", left, gb * lb[None, None, :])
    n0 = torch.sqrt((theta0 * theta0).sum())
    theta = peinsum("uvst,stik->uvik", gate.reshape(d, d, d, d), theta0)
    mat = theta.transpose(1, 2).reshape(d * bond, d * bond)
    u, s, vh = torch.linalg.svd(mat, full_matrices=False)
    n1 = torch.linalg.norm(s)
    u, s, vh = u[:, :bond], s[:bond], vh[:bond]
    s = s / torch.clamp(torch.linalg.norm(s), min=1e-300)
    ga_new = u.reshape(d, bond, bond) * linv[None, :, None]
    gb_new = vh.reshape(bond, d, bond).transpose(0, 1) * linv[None, None, :]
    log_n = torch.log(torch.clamp(n1, min=1e-300)) - torch.log(
        torch.clamp(n0, min=1e-300))
    return ga_new, gb_new, s.to(la.dtype), log_n


def _stage_symmetric(ga, gb, la, lb, gate_half, gate_full, n_iter):
    """``n_iter`` second-order Trotter steps AB(dt/2) BA(dt) AB(dt/2),
    accumulating the per-site ``ln Z`` contribution on the device."""
    acc = torch.zeros((), dtype=ga.dtype, device=ga.device)
    for _ in range(int(n_iter)):
        ga, gb, la, n1 = _bond_update_norm(ga, gb, la, lb, gate_half)
        gb, ga, lb, n2 = _bond_update_norm(gb, ga, lb, la, gate_full)
        ga, gb, la, n3 = _bond_update_norm(ga, gb, la, lb, gate_half)
        acc = acc + n1 + n2 + n3
    return ga, gb, la, lb, acc


def thermal_cell_core(state, order="ab"):
    """Blocked folded unit-cell core (phys dim ``d^4``) of the
    purification, for the :mod:`.umps` tooling (thermal correlators,
    correlation lengths, structure factors).

    MEASURE THROUGH THIS, not through the raw Vidal tensors: its true
    transfer fixed points keep the state's second-order Trotter accuracy.
    ``order="ba"`` blocks the cell starting at sublattice B (for the B-A
    bond observables)."""
    if order == "ab":
        sub = {k: state[k] for k in
               ("gamma_a", "gamma_b", "lambda_a", "lambda_b")}
    else:
        sub = {"gamma_a": state["gamma_b"], "gamma_b": state["gamma_a"],
               "lambda_a": state["lambda_b"], "lambda_b": state["lambda_a"]}
    return unit_cell_core(sub)


def _identity_start(d, bond_dim, dtype, device):
    """Folded |I> product start: one maximally entangled pair per site."""
    ga = torch.zeros((d * d, bond_dim, bond_dim), dtype=dtype, device=device)
    ga[[i * d + i for i in range(d)], 0, 0] = 1.0 / np.sqrt(d)
    la = torch.zeros((bond_dim,), dtype=dtype, device=device)
    la[0] = 1.0
    return ga, ga, la, la


def _folded_gates(h2, dt, d, dtype, device):
    h2 = as_tensor(h2, device, dtype)
    return [torch.from_numpy(_fold_gate(two_site_gate(h2, tau), d)).to(
        device, dtype) for tau in (dt / 2.0, dt)]


def thermal_itebd(h2, beta, bond_dim, d=2, dbeta=0.005, dtype=torch.float64):
    """Thermal state of the INFINITE chain ``H = sum_i h2_{i,i+1}``.

    Args:
        h2: Hermitian two-site term, dense ``(d^2, d^2)`` (e.g.
            :func:`~.itebd.tfim_h2`); a torch ``h2`` sets the device, a
            numpy one goes to ``cuda``.
        beta: target inverse temperature.
        bond_dim: purification bond dimension.
        dbeta: imaginary-time Trotter step in units of beta (the
            purification evolves to ``beta / 2``; second-order error is
            ``O(dbeta^2 beta)``).

    Returns:
        A state dict with the folded Vidal tensors (local dim ``d^2``),
        ``log_z`` (``ln Z`` per site, a host float; it carries an
        ``O(dbeta)`` bias with a small coefficient — use
        :func:`thermal_log_z_ti` when second-order ``ln Z`` is needed) and
        ``beta``.
    """
    dtype = torch_dtype(dtype)
    device = resolve_device(None, (h2,))
    n_steps = max(1, int(round(beta / 2.0 / dbeta)))
    dt = beta / 2.0 / n_steps
    gate_half, gate_full = _folded_gates(h2, dt, d, dtype, device)
    ga, gb, la, lb = _identity_start(d, bond_dim, dtype, device)
    ga, gb, la, lb, acc = _stage_symmetric(ga, gb, la, lb, gate_half,
                                           gate_full, n_steps)
    return {
        "gamma_a": ga, "gamma_b": gb, "lambda_a": la, "lambda_b": lb,
        "log_z": float(acc) + float(np.log(d)),
        "beta": float(beta), "d": d,
    }


def thermal_log_z_ti(h2, beta, bond_dim, d=2, dbeta=0.005, intervals=16,
                     iters=400, dtype=torch.float64):
    """Second-order ``ln Z`` per site by thermodynamic integration:
    ``ln z(beta) = ln d - int_0^beta e(b) db`` with the energy measured at
    uniform checkpoints through the fixed-point environments and
    Simpson-integrated (``intervals`` must be even; the infinite-T endpoint
    is exact: ``e(0) = tr h2 / d^2``).

    Returns ``(log_z, state)`` with ``state`` the ``beta`` state dict.
    """
    if intervals % 2:
        raise ValueError("Simpson integration needs an even interval "
                         f"count, got {intervals}")
    dtype = torch_dtype(dtype)
    device = resolve_device(None, (h2,))
    chunk = beta / intervals
    n_steps = max(1, int(round(chunk / 2.0 / dbeta)))
    dt = chunk / 2.0 / n_steps
    gate_half, gate_full = _folded_gates(h2, dt, d, dtype, device)
    ga, gb, la, lb = _identity_start(d, bond_dim, dtype, device)
    acc = 0.0
    h_host = as_tensor(h2, torch.device("cpu")).numpy()
    energies = [float(np.trace(h_host)) / (d * d)]
    for _ in range(intervals):
        ga, gb, la, lb, da = _stage_symmetric(ga, gb, la, lb, gate_half,
                                              gate_full, n_steps)
        acc += float(da)
        state = {"gamma_a": ga, "gamma_b": gb,
                 "lambda_a": la, "lambda_b": lb, "d": d}
        energies.append(thermal_energy_density(state, h_host, iters=iters))
    e = np.asarray(energies)
    simpson = chunk / 3.0 * (
        e[0] + e[-1] + 4.0 * e[1:-1:2].sum() + 2.0 * e[2:-1:2].sum())
    state["log_z"] = acc + float(np.log(d))
    state["beta"] = float(beta)
    return float(np.log(d)) - float(simpson), state


def thermal_energy_density(state, h2, iters=400):
    """Energy per site ``<h2>`` at temperature ``1/beta`` (one bond per
    site; averaged over the two unit-cell bonds, each measured with true
    transfer-fixed-point environments — see :func:`thermal_cell_core`)."""
    op4 = _fold_gate(h2, state["d"])
    e_ab = expect_local(thermal_cell_core(state, "ab"), op4, iters=iters)
    e_ba = expect_local(thermal_cell_core(state, "ba"), op4, iters=iters)
    return 0.5 * (float(e_ab) + float(e_ba))


def thermal_site_expectation(state, op, iters=400):
    """One-site thermal expectation ``Tr(rho op)`` (averaged over the unit
    cell, fixed-point environments)."""
    d = state["d"]
    opf = _fold_op(op, d)
    eye2 = np.eye(d * d)
    core = thermal_cell_core(state, "ab")
    vals = [float(expect_local(core, np.kron(opf, eye2), iters=iters)),
            float(expect_local(core, np.kron(eye2, opf), iters=iters))]
    return 0.5 * sum(vals)


def thermal_free_energy(state):
    """Free energy per site ``f = -T ln Z`` from the accumulated per-site
    log partition function."""
    return -state["log_z"] / state["beta"]


# ---------------------------------------------------------------------- #
# Long-range Hamiltonians: purification by imaginary-time W^II
# ---------------------------------------------------------------------- #


def _host(core):
    if isinstance(core, torch.Tensor):
        return core.detach().cpu().numpy()
    return np.asarray(core)


def fold_umpo(core):
    """Lift a triangular bulk MPO core to the purified ``d^2`` site (host
    numpy): every automaton entry acts on the physical leg only, the ancilla
    carries the identity (``out[(s a), (t b)] = w[s, t] delta_ab``).
    Triangularity and the identity corners survive the lift."""
    w = _host(core)
    d, wdim = w.shape[0], w.shape[2]
    out = np.einsum("stij,ab->satbij", w, np.eye(d))
    return out.reshape(d * d, d * d, wdim, w.shape[3])


def fold_umpo_anc(core):
    """Lift a triangular bulk MPO core to act on the ANCILLA leg as ``H^T``
    (host numpy): ``out[(s a), (t b)] = delta_st w[b, a]`` — right
    multiplication in the row-major vectorization of :func:`_fold_op`."""
    w = _host(core)
    d = w.shape[0]
    out = np.einsum("baij,st->satbij", w, np.eye(d))
    return out.reshape(d * d, d * d, w.shape[2], w.shape[3])


def balanced_umpo(core):
    """The balanced purification generator ``L = H (x) I - I (x) H^T`` as ONE
    triangular bulk core on the folded ``d^2`` site (on ``core``'s device if
    it is a tensor, else ``cuda``).

    ``e^{-i L t} |X> = |e^{-iHt} X e^{+iHt}>``: any purification of a
    thermal state is an exact zero mode, so the folded thermal background is
    stationary under the balanced evolution (Karrasch/Bardarson/Moore, PRL
    108, 227206).  Bond ``W' = 2 W - 2``."""
    from .mpo import umpo_scale, umpo_sum

    device = resolve_device(None, (core,))
    return umpo_sum(fold_umpo(core),
                    umpo_scale(fold_umpo_anc(core), -1.0, device=device),
                    device=device)


def thermal_wii(h_core, beta, bond_dim, dbeta=0.02, order=2, callback=None):
    """Thermal state of an infinite chain with an ARBITRARY bulk-MPO
    Hamiltonian — exponential/power-law couplings included.

    The purification ``exp(-beta H / 2) |I>`` is built by imaginary-time
    uniform W^II application (:func:`~.mpo_evolution.umps_mpo_evolve` on the
    :func:`fold_umpo`-lifted core).  ``h_core`` sets the device: a torch
    core keeps its own, a numpy one goes to ``cuda``.

    Returns the folded ``(d^2, D, D)`` uniform purification core.  Measure
    with :func:`thermal_wii_expectation` / :func:`thermal_wii_correlate`.
    ``callback(k, core)`` runs after each of the ``ceil(beta / 2 / dbeta)``
    steps.
    """
    from .mpo_evolution import umps_mpo_evolve

    device = resolve_device(None, (h_core,))
    w = _host(h_core)
    d = w.shape[0]
    v = np.zeros(d * d)
    v[np.arange(d) * d + np.arange(d)] = 1.0 / np.sqrt(d)
    n_steps = max(1, int(round(beta / 2.0 / dbeta)))
    return umps_mpo_evolve(v[:, None, None], fold_umpo(w), beta / 2.0, n_steps,
                           bond_dim, imag=True, order=order, callback=callback,
                           device=device)


def thermal_wii_expectation(core, op, iters=300):
    """One-site ``Tr(rho op)`` on a :func:`thermal_wii` core (the transfer
    fixed point divides out ``Tr rho``)."""
    d = int(round(np.sqrt(core.shape[0])))
    return expect_local(core, _fold_op(op, d), iters=iters)


def thermal_wii_correlate(core, op1, op2, distances, iters=300):
    """Two-site thermal correlators ``Tr(rho op1_0 op2_r)`` on a
    :func:`thermal_wii` core (connected, as :func:`~.umps.correlate`)."""
    from .umps import correlate

    d = int(round(np.sqrt(core.shape[0])))
    return correlate(core, _fold_op(op1, d), _fold_op(op2, d), distances,
                     iters=iters)


# ---------------------------------------------------------------------- #
# Exact TFIM thermal oracle (fermionic spectrum integrals)
# ---------------------------------------------------------------------- #


def tfim_exact_thermal(beta, j=1.0, h=1.0, n=4001):
    """Exact infinite-chain TFIM thermal values ``(ln z, e)`` per site from
    the free-fermion spectrum ``eps_k = 2 sqrt(j^2 + h^2 - 2 j h cos k)``:
    ``ln z = (1/2pi) int ln(2 cosh(beta eps_k / 2))`` and ``e = -(1/4pi) int
    eps_k tanh(beta eps_k / 2)``."""
    k = np.linspace(-np.pi, np.pi, n)
    eps = 2.0 * np.sqrt(j * j + h * h - 2.0 * j * h * np.cos(k))
    log_z = np.trapezoid(
        np.log(2.0 * np.cosh(0.5 * beta * eps)), k) / (2.0 * np.pi)
    energy = -np.trapezoid(
        eps * np.tanh(0.5 * beta * eps), k) / (4.0 * np.pi)
    return float(log_z), float(energy)
