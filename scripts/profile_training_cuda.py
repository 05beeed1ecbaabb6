#!/usr/bin/env python3
"""Profile the PyTorch port's training steps on one NVIDIA GPU.

    python3 scripts/profile_training_cuda.py

Runs, at the JAX package's published widths (``chip_smoke.TRAIN`` and
``chip_smoke.BORN``), a float32 log-MSE SGD step and a Born-machine exact-NLL
Adam step: one warm-up step, then ``STEPS`` steps timed on the host clock
(each ending in a synchronize) and the same steps again under
``torch.profiler``.  Prints per step: host time, device busy time (the sum of
the device operations' own time), the device's idle share (against the
profiled steps, which the profiler slows, and against the unprofiled ones,
whose device work is the same), the number of device operations (kernels,
copies, fills), and the ops that take the most device time.  Needs a GPU;
imports neither JAX nor the JAX package.
"""

import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from contractn_tpu_torch.models import MPS  # noqa: E402
from contractn_tpu_torch.models.born import born_machine, born_nll  # noqa: E402
from contractn_tpu_torch.parallel import make_train_step  # noqa: E402

STEPS = 3


def sgd_case(device):
    t = chip_smoke.TRAIN
    gen = torch.Generator(device=device).manual_seed(11)
    mps = MPS.random(t["n_sites"], t["phys"], t["bond"], generator=gen, device=device)
    x = torch.randn((t["batch"], t["n_sites"], t["phys"]), generator=gen, device=device)
    y = torch.zeros((t["batch"],), device=device)
    step = make_train_step(lr=t["lr"])
    state = {"mps": mps}

    def run():
        state["mps"], _ = step(state["mps"], x, y)

    return run


def born_case(device):
    b = chip_smoke.BORN
    gen = torch.Generator(device=device).manual_seed(13)
    model = born_machine(b["n_sites"], 2, b["bond"], dtype=torch.float32,
                         generator=gen, device=device)
    data = torch.randint(0, 2, (b["batch"], b["n_sites"]), generator=gen, device=device)
    params = [t.detach().clone().requires_grad_(True)
              for t in (model.cores, model.left, model.right)]
    opt = torch.optim.Adam(params, lr=b["lr"])

    def run():  # one step of fit_born_machine's loop
        opt.zero_grad(set_to_none=True)
        born_nll(MPS(*params), data).backward()
        opt.step()

    return run


def measure(name, run, smi):
    run()
    torch.cuda.synchronize()
    host = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_device) / 1e6
    launches = sum(e.count for e in on_device)
    print(f"== {name} ({smi})")
    print(f"  host time a step: {', '.join(f'{1e3 * s:.1f}' for s in host)} ms "
          "(profiler off)")
    unprofiled = sum(host)
    print(f"  profiled: {1e3 * wall / STEPS:.1f} ms a step, device busy "
          f"{1e3 * busy / STEPS:.2f} ms a step, idle share {1 - busy / wall:.3f} "
          f"({1 - busy / unprofiled:.3f} against the unprofiled steps), "
          f"{launches / STEPS:.0f} device operations a step")
    print(events.table(sort_by="self_device_time_total", row_limit=12))


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_training_cuda: needs a CUDA GPU")
    smi = chip_smoke.phase_device()[0]
    device = torch.device("cuda", 0)
    measure("sgd_fp32", sgd_case(device), smi)
    measure("born_adam", born_case(device), smi)


if __name__ == "__main__":
    main()
