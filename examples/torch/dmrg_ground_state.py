"""Ground state of the transverse-field Ising chain via DMRG, then sample
from the resulting Born distribution, on the PyTorch port.

Run with: ``python3 examples/torch/dmrg_ground_state.py [--device cpu]``
"""

import argparse

import torch

from contractn_tpu_torch.models import MPS, dmrg, sample, tfim_mpo


def main(device="cuda"):
    n, bond = 12, 8
    mpo = tfim_mpo(n, j=1.0, h=1.0, device=device)
    mps0 = MPS.random(n, 2, bond, dtype=torch.float64,
                      generator=torch.Generator(device).manual_seed(0), device=device)
    ground, energy, trace = dmrg(mpo, mps0, max_bond=bond, sweeps=3)
    print(f"DMRG energy per site: {float(energy) / n:.8f}  (sweep trace: "
          + ", ".join(f"{float(e):.6f}" for e in trace) + ")")

    samples, logp = sample(ground, 5, generator=torch.Generator(device).manual_seed(1))
    for s, lp in zip(samples.cpu().numpy(), logp.cpu().numpy()):
        print("sample", "".join(map(str, s)), f"log p = {lp:.3f}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
