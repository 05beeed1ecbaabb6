"""Kibble-Zurek defect production in the thermodynamic limit, on the
PyTorch port.

A transverse-field ramp drags the infinite TFIM across its critical
point; adiabaticity fails near h = 1 and domain-wall defects freeze
in with the Kibble-Zurek density ``n_kink ~ sqrt(v)``.  The uniform
W^II driven evolver (`umps_mpo_evolve_driven`) produces the whole
trajectory; every number is checked against the EXACT per-momentum
Landau-Zener dynamics of the free-fermion modes.

Run with: ``python3 examples/torch/kibble_zurek.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models.dmrg import tfim_mpo
from contractn_tpu_torch.models.mpo_evolution import umps_mpo_evolve_driven
from contractn_tpu_torch.models.umps import correlate
from contractn_tpu_torch.models.vumps import vumps

SZ = np.array([[1.0, 0.0], [0.0, -1.0]])
H0, H1 = 2.0, 0.25


def exact_kinks(t_ramp):
    """Per-k Landau-Zener integration of the pair blocks; the kink
    density is (1 - <Z Z>)/2 with
    <ZZ> = (2/pi) int [cos k |b|^2 + sin k Im(a* b)] dk."""
    ks = np.linspace(1e-6, np.pi, 1501)

    def hk_mats(h):
        z = np.zeros_like(ks)
        return np.stack(
            [np.stack([z, 2j * np.sin(ks)], -1),
             np.stack([-2j * np.sin(ks), 4 * h - 4 * np.cos(ks) + 0j],
                      -1)], -2)

    psi = np.zeros((len(ks), 2), complex)
    m0 = hk_mats(H0)
    for i in range(len(ks)):
        _, v = np.linalg.eigh(m0[i])
        psi[i] = v[:, 0]

    def rhs(p, t):
        h = H0 + (H1 - H0) * t / t_ramp
        return -1j * np.einsum("kab,kb->ka", hk_mats(h), p)

    dt, t = 5e-4, 0.0
    for _ in range(int(round(t_ramp / dt))):
        k1 = rhs(psi, t)
        k2 = rhs(psi + dt / 2 * k1, t + dt / 2)
        k3 = rhs(psi + dt / 2 * k2, t + dt / 2)
        k4 = rhs(psi + dt * k3, t + dt)
        psi = psi + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        t += dt
    a, b = psi[:, 0], psi[:, 1]
    zz = (2 / np.pi) * np.trapezoid(
        np.cos(ks) * np.abs(b) ** 2 + np.sin(ks) * np.imag(
            np.conj(a) * b), ks)
    return 0.5 * (1.0 - zz)


def main(device="cuda"):
    g = vumps(tfim_mpo(2, h=H0, device=device), 12, iters=100)
    al = g["al"]
    print("ramp h: 2.0 -> 0.25 across criticality; n_kink vs exact")
    prev = None
    for t_ramp in (1.0, 2.0, 4.0):
        core = umps_mpo_evolve_driven(
            al,
            lambda t, tr=t_ramp: tfim_mpo(
                2, h=H0 + (H1 - H0) * t / tr, device=device).cores[0],
            t_ramp, int(40 * t_ramp), 32, order=2)
        zz = float(np.real(complex(correlate(core, SZ, SZ, [1])[0])))
        n_umps = 0.5 * (1.0 - zz)
        n_ex = exact_kinks(t_ramp)
        # the halving ratio drifts toward the asymptotic KZ sqrt(2)
        # = 1.414 as ramps slow (these rates are still pre-asymptotic;
        # the POINT here is the 1e-5 match with exact Landau-Zener)
        ratio = "" if prev is None else \
            f"   n(2v)/n(v) = {prev / n_umps:.3f}"
        print(f"  T = {t_ramp:.0f}  n_kink = {n_umps:.5f}   "
              f"exact = {n_ex:.5f}{ratio}")
        prev = n_umps


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
