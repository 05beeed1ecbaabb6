"""MPS quantum-circuit simulation: gate application with bond truncation.

Counterpart of ``contractn_tpu/models/circuits.py``.  A circuit on n qubits
is a sequence of 1- and 2-site gates applied to an MPS; entanglement (and
hence cost) grows only where the circuit creates it.  Gates apply to a
ragged site list; ``finalize()`` returns an :class:`~.mps.MPS`, so the
whole toolkit composes with circuit outputs.

Also the engine for finite-temperature physics: purification doubles the
physical index (system (x) ancilla) and imaginary-time gates act on the
system half (:func:`thermal_state`), giving ``tr(e^{-beta H} O) / Z`` at
controlled bond dimension.

Gates may be numpy arrays or tensors; they go to the state's device.  Each
two-site gate reads one float on the host (the log of the split's norm).
"""

import math

import numpy as np
import torch

from ..ops.stabilize import peinsum
from ..utils.device import as_tensor, resolve_device
from .mps import MPS


class CircuitState:
    """Mutable MPS state under gate application.

    Sites are ragged ``(d, Dl, Dr)`` tensors with an accumulated
    ``log_norm`` (gates need not be unitary — imaginary-time or Kraus layers
    work too; each two-site application renormalizes and logs the factor).
    """

    def __init__(self, mps_or_sites, max_bond=None, cutoff=0.0):
        if isinstance(mps_or_sites, MPS):
            from .dmrg import _ragged_sites

            self.sites = list(_ragged_sites(mps_or_sites))
        else:
            self.sites = list(mps_or_sites)
        self.max_bond = max_bond
        self.cutoff = cutoff
        self.log_norm = 0.0

    @classmethod
    def product(cls, n_sites, local, max_bond=None, cutoff=0.0, device=None):
        """Product state ``|local>^n`` (``local``: length-``d`` vector; a
        numpy one goes to ``device``, default ``cuda``)."""
        device = resolve_device(device, (local,))
        site = as_tensor(local, device)[:, None, None]
        return cls([site] * n_sites, max_bond=max_bond, cutoff=cutoff)

    @property
    def n_sites(self):
        return len(self.sites)

    def _gate(self, u, *tensors):
        u = as_tensor(u, tensors[0].device)
        dt = u.dtype
        for t in tensors:
            dt = torch.promote_types(dt, t.dtype)
        return u.to(dt), dt

    def apply_gate(self, u, site):
        """One-site gate ``u (d, d)`` on ``site`` (no bond growth)."""
        if not 0 <= site < self.n_sites:
            raise ValueError(
                f"one-site gate needs 0 <= site < {self.n_sites}, got {site}")
        u, dt = self._gate(u, self.sites[site])
        self.sites[site] = peinsum("ab,b...->a...", u, self.sites[site].to(dt))
        return self

    def apply_gate2(self, u, site):
        """Two-site gate ``u (d*d, d*d)`` on ``(site, site + 1)``.

        Contract the pair, apply, split by SVD truncated to
        ``max_bond``/``cutoff``; the split is renormalized with the factor
        accumulated in ``log_norm`` (exactly 0 for unitaries on normalized
        states).  The truncation is taken in the local gauge, so with a
        binding ``max_bond`` the discarded weight understates the global
        error; re-canonicalize through :func:`~.canonical.compress` for
        strongly truncating deep circuits.
        """
        if not 0 <= site < self.n_sites - 1:
            raise ValueError(
                f"two-site gate needs 0 <= site < {self.n_sites - 1}, "
                f"got {site}")
        t1, t2 = self.sites[site], self.sites[site + 1]
        d1, dl, _ = t1.shape
        d2, _, dr = t2.shape
        u, dt = self._gate(u, t1, t2)
        theta = peinsum("aij,bjk->abik", t1.to(dt), t2.to(dt))
        theta = peinsum("abcd,cdik->abik", u.reshape(d1, d2, d1, d2), theta)
        mat = theta.transpose(1, 2).reshape(d1 * dl, d2 * dr)
        uu, s, vh = torch.linalg.svd(mat, full_matrices=False)
        k = s.shape[0]
        if self.max_bond is not None:
            k = min(k, self.max_bond)
        if self.cutoff > 0:
            above = int((s > self.cutoff * s[0]).sum())
            k = min(k, max(above, 1))
        uu, s, vh = uu[:, :k], s[:k], vh[:k]
        nrm = torch.clamp(torch.linalg.norm(s), min=1e-300)
        self.log_norm += float(torch.log(nrm))
        s = (s / nrm).to(dt)
        self.sites[site] = uu.reshape(d1, dl, k)
        self.sites[site + 1] = (s[:, None] * vh).reshape(k, d2, dr).transpose(0, 1)
        return self

    def apply_layer(self, u, start=0):
        """The same two-site gate on bonds ``start, start+2, ...`` (one even
        or odd Trotter layer)."""
        for i in range(start, self.n_sites - 1, 2):
            self.apply_gate2(u, i)
        return self

    def finalize(self):
        """Uniform stacked :class:`MPS` (normalized; norm in ``log_norm``)."""
        from .dmrg import _rebuild_uniform

        dt = self.sites[0].dtype
        for t in self.sites[1:]:
            dt = torch.promote_types(dt, t.dtype)
        return _rebuild_uniform([t.to(dt) for t in self.sites], dt)


# ---------------------------------------------------------------------- #
# Standard gates
# ---------------------------------------------------------------------- #

H_GATE = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
X_GATE = np.array([[0.0, 1.0], [1.0, 0.0]])
CNOT = np.eye(4)[[0, 1, 3, 2]]
CZ = np.diag([1.0, 1.0, 1.0, -1.0])


def _trotter_step(state, g_half, g_full):
    """One second-order Trotter step: even half, odd full, even half."""
    state.apply_layer(g_half, start=0)
    state.apply_layer(g_full, start=1)
    state.apply_layer(g_half, start=0)


def tebd_evolve(mps, h2, t, n_steps, max_bond, imaginary=False):
    """Finite-chain TEBD: evolve ``|psi>`` by ``exp(-i t H)`` (or
    ``exp(-t H)``) with second-order Trotter gate layers, on the state's
    device.

    ``H = sum_i h2_{i,i+1}`` from the dense bond term ``h2 (d^2, d^2)``.  An
    independent algorithm from :func:`~.tdvp.tdvp_step` for the same task;
    the two cross-validate.  Returns ``(mps_out, log_norm)``.
    """
    from .itebd import two_site_gate

    dt = t / n_steps
    coef = dt if imaginary else 1j * dt
    device = mps.cores.device
    g_half = two_site_gate(h2, coef / 2.0, device=device)
    g_full = two_site_gate(h2, coef, device=device)
    state = CircuitState(mps, max_bond=max_bond)
    if not imaginary:
        state.sites = [s.to(torch.promote_types(s.dtype, torch.complex64))
                       for s in state.sites]
    for _ in range(int(n_steps)):
        _trotter_step(state, g_half, g_full)
    return state.finalize(), state.log_norm


# ---------------------------------------------------------------------- #
# Finite temperature via purification
# ---------------------------------------------------------------------- #


def _double_system_gate(g, d, dtype=None):
    """Two-site gate on the SYSTEM half of the doubled (purification) index:
    ``u[(s1 a1)(s2 a2), (s1' a1')(s2' a2')] = g[(s1 s2), (s1' s2')]
    delta(a1, a1') delta(a2, a2')``, on ``g``'s device."""
    g4 = g.reshape(d, d, d, d)  # (s1, s2, s1', s2')
    eye = torch.eye(d, dtype=g.dtype, device=g.device)
    out = peinsum("stuv,ab,cf->satcubvf", g4, eye, eye).reshape(d ** 4, d ** 4)
    if dtype is not None:
        out = out.to(torch.promote_types(dtype, out.dtype))
    return out


def thermal_state(h2, n_sites, beta, max_bond, d=2, n_steps=None,
                  dtype=torch.float64, device=None):
    """Purified thermal state ``|psi_beta>`` with
    ``<psi_beta| O_sys |psi_beta> / <psi_beta|psi_beta> = tr(e^{-beta H} O)
    / Z``.

    Start from the infinite-temperature purification (maximally entangled
    system-ancilla pairs, ``d_eff = d^2``) and evolve the SYSTEM half by
    ``exp(-beta H / 2)`` in second-order Trotter layers.  ``h2`` is the
    two-site bond term (``(d^2, d^2)``).  Computes on ``device`` (default
    ``cuda``; a torch ``h2`` keeps its device).  Returns a
    :class:`CircuitState` over the doubled physical index.
    """
    from .itebd import two_site_gate

    device = resolve_device(device, (h2,))
    n_steps = n_steps or max(int(np.ceil(beta / 0.05)), 1)
    d_beta = 0.5 * beta / n_steps  # the state carries e^{-beta H / 2}
    iden = torch.from_numpy(np.eye(d).reshape(d * d) / np.sqrt(d)).to(device, dtype)
    state = CircuitState.product(n_sites, iden, max_bond=max_bond)
    g_half = _double_system_gate(two_site_gate(h2, d_beta / 2.0, device), d, dtype)
    g_full = _double_system_gate(two_site_gate(h2, d_beta, device), d, dtype)
    for _ in range(n_steps):
        _trotter_step(state, g_half, g_full)
    return state


def thermal_expectation(state, op, site, d=2):
    """``<O_site>`` on a purified state (``op (d, d)`` on the system half of
    the doubled index); a host float."""
    from .mpo import MPO
    from .mpo import rayleigh as _rayleigh

    mps = state.finalize()
    dt, device = mps.cores.dtype, mps.cores.device
    op = np.asarray(torch.as_tensor(op).cpu())
    ws = []
    for i in range(mps.n_sites):
        wi = np.eye(d * d) if i != site else np.kron(op, np.eye(d))
        ws.append(wi.reshape(d * d, d * d, 1, 1))
    one = torch.ones((1,), dtype=dt, device=device)
    mpo = MPO(torch.from_numpy(np.stack(ws)).to(device, dt), one, one)
    return _rayleigh(mpo, mps)


def thermal_correlation(h2, n_sites, beta, op, site, t_max, n_steps,
                        max_bond, d=2, site2=None, dtype=torch.float64,
                        device=None):
    """Finite-temperature dynamic correlation via purification:
    ``C(t) = tr(e^{-beta H} O_site2(t) O_site) / Z`` (``site2`` defaults to
    ``site``).

    Builds the purified thermal state, creates ``|phi> = (O x 1)_site
    |psi_beta>``, evolves both in real time with second-order Trotter layers
    on the system half, and reads ``<psi(t)| (O x 1)_site2 |phi(t)>`` at
    every step (truncation renormalizations tracked through the log
    registers).  Returns ``(times, values)`` as numpy arrays.
    """
    from .itebd import two_site_gate

    site2 = site if site2 is None else site2
    for name, val in (("site", site), ("site2", site2)):
        if not 0 <= val < n_sites:
            raise ValueError(
                f"{name} must satisfy 0 <= {name} < {n_sites}, got {val}")
    device = resolve_device(device, (h2,))
    psi = thermal_state(h2, n_sites, beta, max_bond, d=d, dtype=dtype,
                        device=device)
    psi.log_norm = 0.0  # the base purification norm cancels in the ratio
    op_doubled = torch.from_numpy(
        np.kron(np.asarray(torch.as_tensor(op).cpu()), np.eye(d))).to(device)
    phi = CircuitState(list(psi.sites), max_bond=max_bond)
    phi.apply_gate(op_doubled, site)

    dt = t_max / n_steps
    coef = 1j * dt
    g_half = _double_system_gate(two_site_gate(h2, coef / 2.0, device), d)
    g_full = _double_system_gate(two_site_gate(h2, coef, device), d)

    def measure():
        bra = psi.finalize()
        ket_state = CircuitState(list(phi.sites))
        ket_state.apply_gate(op_doubled, site2)
        ket = ket_state.finalize()
        num_v, num_l = bra.inner(ket)
        den_v, den_l = bra.norm_squared()
        ratio = complex(num_v / den_v) * math.exp(float(torch.real(num_l - den_l)))
        return ratio * math.exp(phi.log_norm - psi.log_norm)

    times, values = [0.0], [measure()]
    for step in range(1, n_steps + 1):
        for state in (psi, phi):
            _trotter_step(state, g_half, g_full)
        times.append(step * dt)
        values.append(measure())
    return np.asarray(times), np.asarray(values)
