"""Finite-temperature dynamics, transport, and open systems — all in
the thermodynamic limit — on the PyTorch port.

Three regimes the reference cannot express at all, driven end to end:

1. Finite-T dynamic structure factor S(k, w) with detailed balance
   (balanced purification evolution through an IBC window).
2. Finite-T spin transport: current-current correlators against the
   exact free-fermion Wick oracle.
3. Driven-dissipative dynamics: uniform Lindblad evolution toward a
   nonequilibrium steady state, trace-gauge observables.

Run with: ``python3 examples/torch/thermal_and_open_dynamics.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models.dmrg import tfim_mpo
from contractn_tpu_torch.models.ibc import (
    ibc_spectral_function,
    ibc_thermal_correlator,
)
from contractn_tpu_torch.models.lindblad_infinite import (
    lindblad_evolve_infinite,
    product_density,
    trace_correlate,
    trace_expect,
)
from contractn_tpu_torch.models.mpo import mpo_from_bond_term
from contractn_tpu_torch.models.thermal import thermal_wii

SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SY = np.array([[0.0, -1j], [1j, 0.0]])
SZ = np.array([[1.0, 0.0], [0.0, -1.0]])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def thermal_structure_factor(device):
    """S(k, w) of the infinite TFIM at beta = 1: the w < 0 side is
    the detailed-balance image of the w > 0 side."""
    beta, h = 1.0, 2.0
    hc = tfim_mpo(2, h=h, device=device).cores[0]
    core = thermal_wii(hc, beta, bond_dim=16, dbeta=0.02)
    nw, qj, dt, ns = 14, 6, 0.1, 20
    corr = ibc_thermal_correlator(core, hc, SZ, SZ, nw, qj, dt, ns,
                                  max_bond=32)
    ks = np.array([np.pi / 2])
    ws = np.linspace(-12.0, 16.0, 561)
    s = _host(ibc_spectral_function(corr, qj, dt, ks, ws))
    ridge = ws[np.argmax(s[0])]
    eps = 2.0 * np.sqrt(1 + h * h - 2 * h * np.cos(ks[0]))
    print(f"S(k=pi/2, w) ridge at w = {ridge:.2f}   "
          f"one-quasiparticle eps(k) = {eps:.2f}")
    # detailed balance S(k,-w) = e^{-beta w} S(k,w), to broadening
    for w0 in (4.0, 4.5):
        iw = np.argmin(np.abs(ws - w0))
        im = np.argmin(np.abs(ws + w0))
        print(f"  S(-{w0:.1f})/S({w0:.1f}) = "
              f"{s[0][im] / s[0][iw]:.4f}   "
              f"e^(-beta w) = {np.exp(-beta * w0):.4f}")


def thermal_transport(device):
    """<j_x(t) j_0>_beta on the infinite XX chain vs the exact Wick
    oracle — the integrand of the Kubo conductivity."""
    h2 = 0.5 * (np.kron(SX, SX) + np.real(np.kron(SY, SY)))
    hc = mpo_from_bond_term(h2, 2, device=device).cores[0]
    beta = 1.0
    core = thermal_wii(hc, beta, bond_dim=24, dbeta=0.02)
    j2 = 1j * (np.kron(SP, SP.T) - np.kron(SP.T, SP))
    nw, qj, dt, ns = 10, 4, 0.05, 8
    corr = ibc_thermal_correlator(core, hc, j2, j2, nw, qj, dt, ns,
                                  max_bond=32, bond_b=True, bond_a=True)

    ks = np.linspace(-np.pi, np.pi, 4001)
    eps = 2.0 * np.cos(ks)
    f = 1.0 / (1.0 + np.exp(beta * eps))

    def gp(x, t):
        return np.trapezoid(
            f * np.exp(1j * eps * t - 1j * ks * x), ks) / (2 * np.pi)

    def gm(x, t):
        return np.trapezoid(
            (1 - f) * np.exp(-1j * eps * t + 1j * ks * x),
            ks) / (2 * np.pi)

    t = ns * dt
    print(f"<j_0({t}) j_0>_beta = {complex(corr[qj, ns]):.6f}")
    exact = (2 * gp(0, t) * gm(0, t) - gp(-1, t) * gm(1, t)
             - gp(1, t) * gm(-1, t))
    print(f"  exact Wick value  = {exact:.6f}")


def dissipative_steady_state(device):
    """Infinite TFIM with uniform amplitude damping: relaxation toward
    the NESS (slow here — the loss-vs-field competition relaxes on a
    t ~ 20 scale; a dense n=8 oracle tracks the first chunks to 1e-4
    before its boundary takes over)."""
    h, gam = 1.2, 0.6
    hc = tfim_mpo(2, h=h, device=device).cores[0]
    sm = SP.T  # |down><up|
    rho = product_density(0.5 * (np.eye(2) + SX), device=device)
    t = 0.0
    for chunk in (1.0, 1.0, 2.0, 4.0):
        rho = lindblad_evolve_infinite(
            rho, hc, jumps=[sm], rates=[gam], t=chunk,
            n_steps=int(20 * chunk), bond_dim=20)
        t += chunk
        x = complex(trace_expect(rho, SX)).real
        z = complex(trace_expect(rho, SZ)).real
        zz = complex(trace_correlate(rho, SZ, SZ, [1])[0]).real
        print(f"t = {t:4.1f}  <X> = {x:+.6f}  <Z> = {z:+.6f}  "
              f"<ZZ> = {zz:+.6f}")


def main(device="cuda"):
    print("== finite-T structure factor (infinite TFIM, beta=1) ==")
    thermal_structure_factor(device)
    print("\n== finite-T transport (infinite XX chain, beta=1) ==")
    thermal_transport(device)
    print("\n== dissipative relaxation toward the NESS ==")
    dissipative_steady_state(device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
