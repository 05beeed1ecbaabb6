"""Train an MPS regression model, single-device and mesh-sharded, on the
PyTorch port.

The sharded step runs on a mesh over the default process group; run as a
plain script, that group is a world of one rank (every mesh axis of size
1).  Run with: ``python3 examples/torch/mps_training.py [--device cpu]``
"""

import argparse
import socket

import torch
import torch.distributed as dist

from contractn_tpu_torch.models import MPS
from contractn_tpu_torch.parallel import make_mesh, make_sharded_train_step, make_train_step


def main(device="cuda"):
    n_sites, phys_dim, bond_dim, batch = 16, 2, 8, 32
    mps = MPS.random(n_sites, phys_dim, bond_dim,
                     generator=torch.Generator(device).manual_seed(0), device=device)
    x = torch.randn((batch, n_sites, phys_dim),
                    generator=torch.Generator(device).manual_seed(1), device=device)
    y = torch.sin(torch.arange(batch, device=device) / batch)

    step = make_train_step(lr=2e-3)
    for i in range(20):
        mps, loss = step(mps, x, y)
        if i % 5 == 0:
            print(f"step {i:3d}  loss {float(loss):.5f}")

    started = not dist.is_initialized()
    if started:  # a world of one rank on this device
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
    try:
        world = dist.get_world_size()
        sp = 2 if world % 2 == 0 else 1
        mesh = make_mesh({"dp": world // sp, "sp": sp}, device=device.type)
        sharded = make_sharded_train_step(mesh, lr=2e-3)
        mps, loss = sharded(mps, x, y)
        print(f"sharded step on {dict(zip(mesh.mesh_dim_names, mesh.shape))}: "
              f"loss {float(loss):.5f}")
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(torch.device(parser.parse_args().device))
