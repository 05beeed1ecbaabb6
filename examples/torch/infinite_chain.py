"""Infinite-chain workflow on the PyTorch port: iTEBD ground state ->
uMPS observables.

Run with: ``python3 examples/torch/infinite_chain.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models.itebd import (
    heisenberg_h2,
    itebd_ground_state,
    tfim_h2,
    unit_cell_core,
)
from contractn_tpu_torch.models.umps import (
    correlate,
    correlation_length,
    expect_local,
)


def main(device="cuda"):
    # Critical transverse-field Ising chain: exact e0 = -4/pi
    _, e = itebd_ground_state(tfim_h2(j=1.0, h=1.0), bond_dim=12, device=device)
    print(f"TFIM (J=h=1)  e0 = {e:.6f}   exact {-4/np.pi:.6f}")

    # Heisenberg chain: exact e0 = 1/4 - ln 2 (Bethe ansatz)
    _, e = itebd_ground_state(
        heisenberg_h2(), bond_dim=16,
        schedule=((0.1, 400), (0.01, 600), (0.001, 600)), device=device,
    )
    print(f"Heisenberg    e0 = {e:.6f}   exact {0.25 - np.log(2):.6f}")

    # Paramagnetic TFIM: magnetization + correlations from fixed points
    st, _ = itebd_ground_state(tfim_h2(j=1.0, h=2.0), bond_dim=8, device=device)
    core = unit_cell_core(st)
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    ident = np.eye(2)
    x_avg = 0.5 * (np.kron(sx, ident) + np.kron(ident, sx))
    print(f"TFIM h=2      <X> = {float(np.real(complex(expect_local(core, x_avg)))):.6f}")
    print(f"              xi  = {float(correlation_length(core)):.4f} unit cells")
    zz = correlate(core, x_avg, x_avg, [1, 2, 4])
    print(f"              connected <XX> at 1,2,4 cells: "
          f"{[round(float(np.real(complex(c))), 8) for c in zz]}")


def long_range_dynamics(device="cuda"):
    """Uniform W^II: quench + thermal states with LONG-RANGE couplings
    directly in the thermodynamic limit (not run by the script, as in the
    JAX package's example)."""
    from contractn_tpu_torch.models.autompo import InfiniteOpSum
    from contractn_tpu_torch.models.dmrg import tfim_mpo
    from contractn_tpu_torch.models.mpo_evolution import umps_mpo_evolve
    from contractn_tpu_torch.models.thermal import (
        tfim_exact_thermal,
        thermal_wii,
        thermal_wii_expectation,
    )

    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    sz = np.array([[1.0, 0.0], [0.0, -1.0]])

    # Real-time quench under exponentially decaying Ising couplings:
    # |++..> evolved by H = -sum lam^(r-1) Z_i Z_{i+r} - h sum X_i.
    hc = (InfiniteOpSum().add(-0.9, sx, 0).add_exp(-1.0, sz, 0.5, sz)
          .to_umpo(device=device))
    v = torch.tensor([1.0, 1.0], dtype=torch.float64, device=device) / np.sqrt(2.0)
    core = umps_mpo_evolve(v[:, None, None], hc, t=1.0, n_steps=20, bond_dim=16)
    print(f"long-range quench  <X>(t=1) = "
          f"{np.real(complex(expect_local(core, sx))):.6f}")

    # Finite temperature from the bulk MPO core (W^II purification);
    # the NN TFIM case is pinned by the exact fermionic integrals.
    hc_nn = tfim_mpo(2, h=1.0, device=device).cores[0]
    core_b = thermal_wii(hc_nn, beta=1.0, bond_dim=16)
    _, e_exact = tfim_exact_thermal(1.0)
    ex = np.real(complex(thermal_wii_expectation(core_b, sx)))
    print(f"TFIM beta=1  <X> = {ex:.6f}  (exact energy {e_exact:.6f})")


def ising_2d():
    """CTMRG on the 2D classical Ising model, on ``cuda`` (not run by the
    script, as in the JAX package's example)."""
    from contractn_tpu_torch.models.ctmrg import ising_magnetization

    beta_c = 0.5 * np.log(1.0 + np.sqrt(2.0))
    for beta in (0.38, 0.42, 0.45, 0.5):
        m = ising_magnetization(beta, chi=24)
        exact = ((1 - np.sinh(2 * beta) ** -4) ** 0.125
                 if beta > beta_c else 0.0)
        print(f"2D Ising beta={beta}: M = {m:.6f} (exact {exact:.6f})")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
