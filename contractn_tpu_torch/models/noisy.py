"""Noisy quantum-circuit simulation on matrix-product density operators.

Counterpart of ``contractn_tpu/models/noisy.py``.  The gate machinery of
:class:`~.circuits.CircuitState` runs on the vectorized density matrix
(site-fused ``(s, a)`` pairs, local dimension ``d^2``, the convention of
:mod:`.lindblad`): unitaries lift to ``U (x) conj(U)``, CPTP channels to
``sum_k K_k (x) conj(K_k)`` over their Kraus operators (one- and two-site).
Observables are ``Tr(O rho) / Tr(rho)``; purity is the vectorized 2-norm.
Superoperators are built on the host and applied on the state's device.
"""

import math

import numpy as np
import torch

from ..utils.device import resolve_device
from .circuits import CircuitState
from .lindblad import _superop_pair, density_expectation_multi
from .lindblad import density_trace as _density_trace
from .mps import MPS


def depolarizing_kraus(p, d=2):
    """Depolarizing channel ``rho -> (1-p) rho + p I/d`` (qubit Kraus
    form for ``d=2``: ``sqrt(1-3p/4) I, sqrt(p/4) X, Y, Z``)."""
    if d != 2:
        raise ValueError("depolarizing_kraus implements the qubit case")
    x = np.array([[0.0, 1.0], [1.0, 0.0]])
    y = np.array([[0.0, -1j], [1j, 0.0]])
    z = np.array([[1.0, 0.0], [0.0, -1.0]])
    return [
        np.sqrt(1.0 - 3.0 * p / 4.0) * np.eye(2),
        np.sqrt(p / 4.0) * x,
        np.sqrt(p / 4.0) * y,
        np.sqrt(p / 4.0) * z,
    ]


def amplitude_damping_kraus(gamma):
    """Energy relaxation ``|1> -> |0>`` at rate ``gamma``."""
    k0 = np.array([[1.0, 0.0], [0.0, np.sqrt(1.0 - gamma)]])
    k1 = np.array([[0.0, np.sqrt(gamma)], [0.0, 0.0]])
    return [k0, k1]


def phase_damping_kraus(lam):
    """Pure dephasing (phase damping) with parameter ``lam``."""
    k0 = np.array([[1.0, 0.0], [0.0, np.sqrt(1.0 - lam)]])
    k1 = np.array([[0.0, 0.0], [0.0, np.sqrt(lam)]])
    return [k0, k1]


def _channel_superop(kraus, d):
    """One-site ``sum_k K (x) conj(K)`` on the fused ``(s, a)`` index."""
    ks = np.stack([np.asarray(k, complex) for k in kraus])
    t = np.einsum("ksS,kaA->saSA", ks, ks.conj())
    return t.reshape(d * d, d * d)


def _channel_superop2(kraus, d):
    """Two-site channel superoperator (``d^4 x d^4``, pair-fused)."""
    dd = d * d
    out = np.zeros((dd, dd, dd, dd), complex)
    for k in kraus:
        out += _superop_pair(k, np.asarray(k, complex).conj(), d)
    return out.reshape(dd * dd, dd * dd)


class NoisyCircuit:
    """Density-matrix circuit state with bond truncation.

    Args:
        n_sites: qubit/qudit count.
        d: local physical dimension (the vectorized chain runs at
            ``d^2``).
        init: per-site pure-state vectors (default ``|0>^n``), or the
            string ``"mixed"`` for the maximally mixed state.
        max_bond / cutoff: truncation policy for two-site
            applications, exactly as in :class:`CircuitState`.
        device: where the state lives (default ``cuda``).
    """

    def __init__(self, n_sites, d=2, init=None, max_bond=None,
                 cutoff=0.0, device=None):
        self.d = d
        if init == "mixed":
            locs = [np.eye(d).reshape(-1) / d] * n_sites
        else:
            if init is None:
                init = [None] * n_sites
            locs = []
            for v in init:
                if v is None:
                    v = np.zeros(d)
                    v[0] = 1.0
                v = np.asarray(v, complex)
                v = v / np.linalg.norm(v)
                locs.append(np.outer(v, v.conj()).reshape(-1))
        device = resolve_device(device)
        sites = [torch.from_numpy(np.asarray(loc, complex)).to(device)[:, None, None]
                 for loc in locs]
        self._cs = CircuitState(sites, max_bond=max_bond, cutoff=cutoff)

    @property
    def n_sites(self):
        return self._cs.n_sites

    def apply_gate(self, u, site):
        """One-site unitary ``u (d, d)`` as ``u (x) conj(u)``."""
        u = np.asarray(u, complex)
        self._cs.apply_gate(np.kron(u, u.conj()), site)
        return self

    def apply_gate2(self, u, site):
        """Two-site unitary ``u (d^2, d^2)`` on ``(site, site+1)``."""
        u = np.asarray(u, complex)
        sup = _superop_pair(u, u.conj(), self.d)
        dd = self.d * self.d
        self._cs.apply_gate2(sup.reshape(dd * dd, dd * dd), site)
        return self

    def apply_channel(self, kraus, site):
        """One-site CPTP channel from its Kraus operators."""
        self._cs.apply_gate(_channel_superop(kraus, self.d), site)
        return self

    def apply_channel2(self, kraus, site):
        """Two-site channel (Kraus operators ``(d^2, d^2)``) on
        ``(site, site+1)``."""
        self._cs.apply_gate2(_channel_superop2(kraus, self.d), site)
        return self

    def density_mps(self):
        """The vectorized density operator as a (trace-normalized)
        framework :class:`MPS`."""
        rho = self._cs.finalize()
        rho = MPS(rho.cores, rho.left * math.exp(self._cs.log_norm), rho.right)
        tr = _density_trace(rho, self.d)
        return MPS(rho.cores, rho.left / tr, rho.right)

    def trace(self):
        """``Tr(rho)`` including all accumulated factors (1 for CPTP
        circuits up to truncation — a built-in error meter)."""
        rho = self._cs.finalize()
        rho = MPS(rho.cores, rho.left * math.exp(self._cs.log_norm), rho.right)
        return _density_trace(rho, self.d)

    def expectation(self, op, site):
        """``Tr(O_site rho) / Tr(rho)``."""
        return density_expectation_multi(
            self.density_mps(), [(site, op)], d=self.d)

    def expectation_multi(self, site_ops):
        """``Tr(O_{i1} O_{i2} ... rho) / Tr(rho)`` on distinct sites."""
        return density_expectation_multi(
            self.density_mps(), site_ops, d=self.d)

    def purity(self):
        """``Tr(rho^2)`` of the trace-normalized state — the
        vectorized 2-norm squared."""
        rho = self.density_mps()
        val, log = rho.norm_squared()
        return float(torch.real(val)) * math.exp(float(log))
