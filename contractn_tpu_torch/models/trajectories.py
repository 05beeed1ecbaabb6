"""Quantum-trajectory (MCWF) unraveling of Lindblad dynamics on MPS.

Counterpart of ``contractn_tpu/models/trajectories.py``.  Pure states evolve
under ``H_eff = H - (i/2) sum_k L_k^dag L_k`` with stochastic jumps
``|psi> -> L_k|psi>``; the trajectory average of ``|psi><psi|`` solves the
Lindblad equation at state-entanglement bond dimension.  Per step: one
Strang-split Trotter step of ``exp(-i dt H_eff)`` (one-site decay
half-layers ``exp(-dt K_j / 4)`` around the second-order TEBD bond layers,
all through :class:`~.circuits.CircuitState`); the post-step squared norm is
the survival probability ``q``; with probability ``1 - q`` a jump fires,
its channel drawn proportionally to ``<psi| L_k^dag L_k |psi>``.

Randomness: every decision consumes a pair of uniforms drawn on the HOST
(float64) from an explicit CPU ``torch.Generator`` — the ``uniforms=`` seam
— so a run on the card and a run on the CPU take the same draws.
"""

import numpy as np
import torch

from ..ops.stabilize import peinsum
from .circuits import CircuitState
from .itebd import two_site_gate


def _host_uniforms(n_steps, generator):
    """``(n_steps, 2)`` float64 uniforms from a CPU generator (the global
    one when ``None``)."""
    return torch.rand((n_steps, 2), dtype=torch.float64,
                      generator=generator).numpy()


def _site_decay_gates(jumps, n_sites, d, dt):
    """Half-layer one-site gates ``exp(-dt K_j / 4)`` (None = identity site)
    and the per-site decay generators ``K_j`` (host numpy)."""
    ks = [np.zeros((d, d), complex) for _ in range(n_sites)]
    for op, site in jumps:
        op = np.asarray(op)
        ks[site] = ks[site] + np.matmul(op.conj().T, op)
    gates = []
    for k in ks:
        if np.abs(k).max() == 0.0:
            gates.append(None)
            continue
        w, u = np.linalg.eigh(k)
        gates.append(np.matmul(u * np.exp(-0.25 * dt * w), u.conj().T))
    return gates, ks


def _ragged_norm_sq(sites):
    """``<psi|psi>`` of a ragged site list (left-to-right transfer)."""
    rho = torch.eye(sites[0].shape[1], dtype=sites[0].dtype,
                    device=sites[0].device)
    for a in sites:
        x = peinsum("ij,bjk->bik", rho, a)
        rho = peinsum("bji,bjk->ik", a.conj(), x)
    return float(torch.real(torch.trace(rho)))


def _renormalize(state):
    """Scale the state to unit norm, folding in the accumulated
    ``log_norm``; returns the pre-scaling squared norm."""
    raw = _ragged_norm_sq(state.sites)
    q = raw * float(np.exp(2.0 * state.log_norm))
    state.sites[0] = state.sites[0] * (
        float(np.exp(state.log_norm)) / np.sqrt(max(q, 1e-300)))
    state.log_norm = 0.0
    return q


def mcwf_trajectory(mps0, h2, jumps, t, n_steps, max_bond=16, generator=None,
                    uniforms=None, op=None, measure_every=1):
    """One MCWF trajectory on ``mps0``'s device.  Returns ``(mps, record,
    jump_log)``.

    Args:
        mps0: initial (normalized) :class:`~.mps.MPS`.
        h2: dense bond term ``(d^2, d^2)`` of the chain Hamiltonian.
        jumps: ``[(op (d, d), site), ...]`` with rates folded in.
        t, n_steps: total time and Trotter steps.
        generator: CPU ``torch.Generator`` for the ``(n_steps, 2)`` host
            uniforms (ignored if ``uniforms`` is given).
        uniforms: explicit ``(n_steps, 2)`` draws (first: jump?, second:
            which channel).
        op: optional one-site observable recorded per site after every
            ``measure_every``-th step (plus ``t = 0``); ``record`` is a numpy
            ``(n_records, n_sites)`` array (or None).

    With a binding ``max_bond`` the truncation loss lands in the norm and
    inflates the jump probability: keep the truncation error far below ``dt
    * <L^+ L>``.
    """
    n_sites = mps0.n_sites
    d = mps0.phys_dim
    dt = t / n_steps
    if uniforms is None:
        uniforms = _host_uniforms(int(n_steps), generator)
    uniforms = np.asarray(uniforms, float)
    device = mps0.cores.device

    g_half = two_site_gate(h2, 1j * dt / 2.0, device=device)
    g_full = two_site_gate(h2, 1j * dt, device=device)
    decay, _ = _site_decay_gates(jumps, n_sites, d, dt)
    state = CircuitState(mps0, max_bond=max_bond)
    state.sites = [s.to(torch.promote_types(s.dtype, torch.complex64))
                   for s in state.sites]

    def measure(record):
        if op is not None:
            mps = state.finalize()
            record.append(torch.real(mps.site_expectations(op)).cpu().numpy())

    def channel_weights():
        mps = state.finalize()
        w = np.zeros(len(jumps))
        for i, (jop, site) in enumerate(jumps):
            jop = np.asarray(jop)
            w[i] = float(torch.real(
                mps.site_expectations(np.matmul(jop.conj().T, jop))[site]))
        return w

    record = []
    jump_log = []
    measure(record)
    for step in range(int(n_steps)):
        for j, gate in enumerate(decay):
            if gate is not None:
                state.apply_gate(gate, j)
        state.apply_layer(g_half, start=0)
        state.apply_layer(g_full, start=1)
        state.apply_layer(g_half, start=0)
        for j, gate in enumerate(decay):
            if gate is not None:
                state.apply_gate(gate, j)
        q = _renormalize(state)
        if jumps and uniforms[step, 0] > q:
            w = channel_weights()
            total = w.sum()
            if total > 0.0:
                pick = int(np.searchsorted(np.cumsum(w / total),
                                           uniforms[step, 1]))
                pick = min(pick, len(jumps) - 1)
                jop, site = jumps[pick]
                state.apply_gate(np.asarray(jop), site)
                _renormalize(state)
                jump_log.append((step, pick))
        if (step + 1) % measure_every == 0:
            measure(record)
    out = state.finalize()
    return out, (np.asarray(record) if op is not None else None), jump_log


def mcwf_ensemble(mps0, h2, jumps, t, n_steps, op, n_traj, max_bond=16,
                  generator=None, measure_every=1):
    """Trajectory-averaged observable record ``(mean, n_jumps_total)`` with
    ``mean (n_records, n_sites)``, converging to the Lindblad solution at
    ``O(1/sqrt(n_traj))``.  The trajectories consume consecutive
    ``(n_steps, 2)`` blocks of host uniforms from one CPU ``generator``."""
    acc = None
    n_jumps = 0
    for _ in range(int(n_traj)):
        _, rec, jl = mcwf_trajectory(
            mps0, h2, jumps, t, n_steps, max_bond=max_bond,
            uniforms=_host_uniforms(int(n_steps), generator), op=op,
            measure_every=measure_every)
        acc = rec if acc is None else acc + rec
        n_jumps += len(jl)
    return acc / n_traj, n_jumps
