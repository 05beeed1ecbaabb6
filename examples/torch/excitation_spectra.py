"""Momentum-resolved excitation spectra of the infinite TFIM chain on the
PyTorch port.

Workflow: VUMPS ground state -> tangent-space quasiparticle bands
across the Brillouin zone -> dynamical structure factor pole weights,
compared against the exact Pfeuty dispersion and the static S(k) sum
rule.  Run with: ``python3 examples/torch/excitation_spectra.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models import (
    quasiparticle_dispersion,
    spectral_weights,
    tfim_mpo,
    vumps,
)
from contractn_tpu_torch.models.umps import correlate, expect_local

H_FIELD = 1.5
BOND = 12


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def main(device="cuda"):
    mpo = tfim_mpo(2, j=1.0, h=H_FIELD, device=device)
    ground = vumps(mpo, bond_dim=BOND, iters=60)
    print(f"VUMPS ground state: E/site = {ground['energy']:.12f} "
          f"(grad {ground['gradient_norm']:.1e})")

    ks = np.linspace(0.0, np.pi, 9)
    _, omegas = quasiparticle_dispersion(mpo, ks, ground=ground)
    omegas = _host(omegas)
    print("\n  k/pi    omega(k)        exact          error")
    for k, om in zip(ks, omegas[:, 0]):
        exact = 2.0 * np.sqrt(H_FIELD ** 2 - 2 * H_FIELD * np.cos(k) + 1.0)
        print(f"  {k / np.pi:4.2f}  {om:.10f}  {exact:.10f}  {om - exact:+.1e}")

    print("\nDynamical structure factor of Z (lowest pole + sum rule):")
    z = np.diag([1.0, -1.0])
    js = np.arange(1, 60)
    cj = np.array([complex(c) for c in correlate(ground["al"], z, z, js)])
    mz = float(np.real(complex(expect_local(ground["al"], z))))
    print("  k/pi   omega_pole   weight      S(k) static   saturation")
    for k in (0.0, np.pi / 2, np.pi):
        om, wt = spectral_weights(ground, mpo, z, k)
        om, wt = _host(om), _host(wt)
        sk = (1 - mz * mz) + 2.0 * np.sum(np.cos(k * js) * np.real(cj))
        print(f"  {k / np.pi:4.2f}  {om[0]:.6f}   {wt[0]:.8f}  "
              f"{sk:.8f}  {wt.sum() / sk:.6f}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
