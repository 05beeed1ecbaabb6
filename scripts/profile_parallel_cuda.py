#!/usr/bin/env python3
"""Profile the parallel layer's training steps on one NVIDIA GPU.

    python3 scripts/profile_parallel_cuda.py [sharded|tp|pipeline ...]

In a world of one rank over NCCL (every mesh axis of size 1, as
``chip_smoke.py``'s phase 14 runs them), at ``chip_smoke.TRAIN``'s widths,
each named step (default: all three) runs once to warm up, once timed on the
host clock (ending in a synchronize) with its peak device memory, and once
under ``torch.profiler``.  Prints the host time, the device busy time (the
sum of the device operations' own time), the idle share, the number of
device operations, and the ops that take the most device time and the most
host time.  Needs a GPU; imports neither JAX nor the JAX package.
"""

import socket
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from contractn_tpu_torch.models import MPS  # noqa: E402
from contractn_tpu_torch.parallel import (make_mesh, make_pipeline_train_step,  # noqa: E402
                                          make_sharded_train_step, make_tp_train_step)


def steps(device):
    lr = chip_smoke.TRAIN["lr"]
    return {
        "sharded": lambda: make_sharded_train_step(
            make_mesh({"dp": 1, "sp": 1}, device=device.type), lr=lr),
        "tp": lambda: make_tp_train_step(
            make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=device.type), lr=lr),
        "pipeline": lambda: make_pipeline_train_step(
            make_mesh({"pp": 1}, device=device.type), lr=lr),
    }


def measure(name, step, device, smi):
    t = chip_smoke.TRAIN
    gen = torch.Generator(device=device).manual_seed(62)
    mps = MPS.random(t["n_sites"], t["phys"], t["bond"], generator=gen, device=device)
    x = torch.randn((t["batch"], t["n_sites"], t["phys"]), generator=gen, device=device)
    y = torch.zeros((t["batch"],), device=device)
    step(mps, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    step(mps, x, y)
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(mps, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_device) / 1e6
    print(f"== train_{name} {t['n_sites']} x {t['bond']} x {t['batch']} fp32 ({smi})")
    print(f"  host time a step {1e3 * host:.1f} ms (profiler off), peak device memory "
          f"{peak:.2f} GB; profiled {1e3 * wall:.1f} ms, device busy {1e3 * busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f} ({1 - busy / host:.3f} against the unprofiled "
          f"step), {sum(e.count for e in on_device)} device operations")
    print(events.table(sort_by="self_device_time_total", row_limit=12))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_parallel_cuda: needs a CUDA GPU")
    smi = chip_smoke.phase_device()[0]
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        makers = steps(device)
        for name in sys.argv[1:] or list(makers):
            measure(name, makers[name](), device, smi)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
