"""Real-space RG workflows on the PyTorch port: HOTRG, MERA, and finite-T
infinite chains.

Run with: ``python3 examples/torch/renormalization.py [--device cpu]``
"""

import argparse

import numpy as np
import torch

from contractn_tpu_torch.models.ctmrg import ising_tensor
from contractn_tpu_torch.models.hotrg import (
    hotrg_bond_expectation,
    hotrg_log_z,
)
from contractn_tpu_torch.models.itebd import tfim_h2
from contractn_tpu_torch.models.mera import (
    expand_mera,
    mera_ground_state,
    scaling_dimensions,
)
from contractn_tpu_torch.models.thermal import (
    tfim_exact_thermal,
    thermal_energy_density,
    thermal_itebd,
)


def main(device="cuda"):
    # --- HOTRG: classical 2D Ising at criticality -------------------- #
    beta_c = 0.5 * np.log(1.0 + np.sqrt(2.0))
    lz = hotrg_log_z(ising_tensor(beta_c, device=device), chi=16, steps=30)
    exact = 0.5 * np.log(2.0) + 2.0 * 0.915965594177219 / np.pi
    print(f"HOTRG  ln z at beta_c = {lz:.8f}  (exact {exact:.8f})")
    sig = ising_tensor(beta_c, field_op=[1.0, -1.0], device=device)
    ss = hotrg_bond_expectation(ising_tensor(beta_c, device=device), sig, sig, chi=16)
    print(f"HOTRG  <s s>_nn at beta_c = {ss:.6f}  (exact {2**0.5 / 2:.6f})")

    # --- MERA: critical TFIM energy + Ising CFT dimensions ----------- #
    # chi ramp: cold starts at larger chi can lose the sigma tower;
    # warm-starting from the converged chi=4 solution is exact.
    h2 = torch.as_tensor(tfim_h2(), device=device)
    p4, e4 = mera_ground_state(h2, chi=4, sweeps=8000)
    params, e = mera_ground_state(h2, chi=6, sweeps=6000,
                                  init=expand_mera(p4, chi=6))
    print(f"MERA   e0 = {float(e):.8f}  (exact {-4 / np.pi:.8f})")
    dims = np.asarray(torch.as_tensor(scaling_dimensions(params, n=2)).cpu())
    print(f"MERA   scaling dims = {dims.round(4)}  (Ising CFT: 0, 1/8)")

    # --- Thermal: infinite TFIM at T = 1 ----------------------------- #
    state = thermal_itebd(h2, beta=1.0, bond_dim=24)
    lz_ex, e_ex = tfim_exact_thermal(1.0)
    print(f"Thermal e(T=1) = {float(thermal_energy_density(state, h2)):.8f}  "
          f"(exact {e_ex:.8f})")
    print(f"Thermal ln Z   = {float(state['log_z']):.6f}  (exact {lz_ex:.6f})")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
