#!/usr/bin/env python3
"""How far two float64 Born-machine fits part, step by step.

    python3 scripts/born_adam_divergence.py [--device cpu] [--steps 10]

At ``chip_smoke.BORN``'s widths (64 sites, bond 64, 4096 samples, Adam at
lr 1e-3) and its seed, runs in float64, on one device (``cuda`` unless
``--device cpu``): ``fit_born_machine`` (torch's Adam), the same fit from
cores nudged by a relative 1e-15, and ``fit_born_machine_sharded`` (the
port's written-out optax Adam) in a world of one rank (NCCL on the card,
gloo on the CPU).  Prints, for each step, the distance of the nudged and of
the sharded fit's loss from ``fit_born_machine``'s, relative to its largest
loss: how far the trajectory can be held at all, whatever the optimizer.
Imports neither JAX nor the JAX package.
"""

import argparse
import socket
import sys
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from contractn_tpu_torch.models import MPS  # noqa: E402
from contractn_tpu_torch.models.born import born_machine, fit_born_machine  # noqa: E402
from contractn_tpu_torch.parallel import fit_born_machine_sharded, make_mesh  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=chip_smoke.BORN["steps"])
    args = ap.parse_args()
    device = torch.device(args.device)
    cfg = {**chip_smoke.BORN, "seed": chip_smoke.PARALLEL["born"]["seed"]}
    gen = torch.Generator(device=device).manual_seed(cfg["seed"])
    model = born_machine(cfg["n_sites"], 2, cfg["bond"], dtype=torch.float32, generator=gen,
                         device=device)
    data = torch.randint(0, 2, (cfg["batch"], cfg["n_sites"]), generator=gen, device=device)
    model = MPS(*(t.double() for t in (model.cores, model.left, model.right)))
    noise = torch.randn(model.cores.shape, dtype=torch.float64, device=device,
                        generator=torch.Generator(device=device).manual_seed(1))
    nudged = MPS(model.cores * (1 + 1e-15 * noise), model.left, model.right)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        kw = dict(steps=args.steps, lr=cfg["lr"])
        _, ref = fit_born_machine(model, data, **kw)
        _, nud = fit_born_machine(nudged, data, **kw)
        _, sh = fit_born_machine_sharded(model, data, make_mesh({"dp": 1}, device=device.type),
                                         **kw)
    finally:
        dist.destroy_process_group()
    scale = ref.abs().max()
    print(f"{cfg['n_sites']} sites, bond {cfg['bond']}, {cfg['batch']} samples, lr "
          f"{cfg['lr']}, float64 on {device.type}")
    print("step  loss (fit_born_machine)  nudged 1e-15  sharded (optax Adam)")
    for k in range(args.steps):
        print(f"{k:4d}  {float(ref[k]):.12f}  {float((nud[k] - ref[k]).abs() / scale):.1e}  "
              f"{float((sh[k] - ref[k]).abs() / scale):.1e}")


if __name__ == "__main__":
    main()
