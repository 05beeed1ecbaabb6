#!/usr/bin/env python3
"""Profile the PyTorch port's finite-chain algorithms on one NVIDIA GPU.

    python3 scripts/profile_chains_cuda.py

At the widths of ``chip_smoke.CHAINS`` (phase 8): one two-site DMRG sweep of
the 100-site spin-1 Heisenberg chain at bond 128 from a random MPS, one
``dmrg_ensemble`` sweep over 64 TFIM chains of 32 sites at bond 32, and one
``tdvp1_step`` of a random 100-site, bond-64 state in complex128, each once
on the host clock (ending in a synchronize) and once under
``torch.profiler``: host time, device busy time (the device operations' own
time), the device's idle share, the number of device operations and the ops
that take the most device time.  Then the decompositions these paths call,
timed with CUDA events against numpy on the host: the split's SVD (single
384 x 384 and a batch of 64 x 64 x 64, float64) under each cuSOLVER driver,
the ensemble's batch of tridiagonal ``eigh`` and TDVP's complex QR.  Needs a
GPU; imports neither JAX nor the JAX package.
"""

import importlib
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from contractn_tpu_torch.models import (  # noqa: E402
    MPS, OpSum, dmrg, dmrg_ensemble, spin_ops, stack_pytrees, tdvp1_step, tfim_mpo)

krylov = importlib.import_module("contractn_tpu_torch.ops.krylov")


def spin1_case(device):
    cfg = chip_smoke.CHAINS["spin1"]
    n, bond = cfg["n_sites"], cfg["bond"]
    h = OpSum()
    for i in range(n - 1):
        h += (1.0, "Sz", i, "Sz", i + 1)
        h += (0.5, "S+", i, "S-", i + 1)
        h += (0.5, "S-", i, "S+", i + 1)
    mpo = h.to_mpo(n, d=3, ops=spin_ops(1), device=device)
    mps0 = MPS.random(n, 3, bond, dtype=torch.float64,
                      generator=chip_smoke._gen(device, cfg["seed"]), device=device)
    return lambda: dmrg(mpo, mps0, max_bond=bond, sweeps=1)


def ensemble_case(device):
    cfg = chip_smoke.CHAINS["ensemble"]
    hs = np.linspace(cfg["h"][0], cfg["h"][1], cfg["n_members"])
    gen = chip_smoke._gen(device, cfg["seed"])
    mpos = stack_pytrees([tfim_mpo(cfg["n_sites"], h=float(h), device=device) for h in hs])
    mps0s = stack_pytrees([MPS.random(cfg["n_sites"], 2, cfg["bond"], dtype=torch.float64,
                                      generator=gen, device=device) for _ in hs])
    return lambda: dmrg_ensemble(mpos, mps0s, sweeps=1)


def tdvp_case(device):
    cfg = chip_smoke.CHAINS["tfim"]
    psi = MPS.random(cfg["n_sites"], 2, cfg["bond"], dtype=torch.float64,
                     generator=chip_smoke._gen(device, 9), device=device)
    scale = torch.exp(-0.5 * psi.log_norm() / cfg["n_sites"])  # unit norm
    psi = MPS(psi.cores * scale, psi.left, psi.right)
    mpo = tfim_mpo(cfg["n_sites"], h=chip_smoke.CHAINS["quench"]["h"], device=device)
    return lambda: tdvp1_step(mpo, psi, chip_smoke.CHAINS["quench"]["dt"])


def measure(name, run, smi):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_device) / 1e6
    launches = sum(e.count for e in on_device)
    print(f"== {name} ({smi})")
    print(f"  host time {host:.3f} s (profiler off); profiled {wall:.3f} s, device "
          f"busy {busy:.3f} s, idle share {1 - busy / wall:.3f} ({1 - busy / host:.3f} "
          f"against the unprofiled run), {launches} device operations")
    print(events.table(sort_by="self_device_time_total", row_limit=10))


def host_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def decompositions(device, smi):
    gen = chip_smoke._gen(device, 12)
    print(f"== decompositions, median of 5 ({smi}); card: CUDA events, host: numpy")
    for shape in ((384, 384), (64, 64, 64)):
        a = torch.randn(shape, dtype=torch.float64, device=device, generator=gen)
        a_host = a.cpu().numpy()
        row = {}
        for driver in (None, "gesvdj", "gesvda"):
            row[driver or "default"] = chip_smoke.cuda_time(
                lambda: torch.linalg.svd(a, full_matrices=False, driver=driver), reps=5)
        row["numpy (host)"] = host_ms(lambda: np.linalg.svd(a_host, full_matrices=False))
        print(f"  svd {shape} float64: " + ", ".join(f"{k} {v:.2f} ms" for k, v in row.items()))
    alphas = torch.randn((64, 40), dtype=torch.float64, device=device, generator=gen)
    betas = torch.rand((64, 40), dtype=torch.float64, device=device, generator=gen)
    tri = krylov.masked_tridiagonal(alphas, betas)
    print(f"  eigh of 64 tridiagonals 40 x 40: card "
          f"{chip_smoke.cuda_time(lambda: torch.linalg.eigh(tri)):.2f} ms, host (read, "
          f"numpy) {host_ms(lambda: krylov.tridiagonal_eigh(alphas, betas)):.2f} ms")
    one = tri[0]
    print(f"  eigh of one tridiagonal 40 x 40: card "
          f"{chip_smoke.cuda_time(lambda: torch.linalg.eigh(one)):.2f} ms, host "
          f"{host_ms(lambda: krylov.tridiagonal_eigh(alphas[0], betas[0])):.2f} ms")
    q = torch.randn((128, 64), dtype=torch.complex128, device=device, generator=gen)
    print(f"  qr (128, 64) complex128: card "
          f"{chip_smoke.cuda_time(lambda: torch.linalg.qr(q)):.2f} ms, host "
          f"{host_ms(lambda: np.linalg.qr(q.cpu().numpy())):.2f} ms")


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_chains_cuda: needs a CUDA GPU")
    smi = chip_smoke.phase_device()[0]
    device = torch.device("cuda", 0)
    decompositions(device, smi)
    measure("spin-1 DMRG sweep, 100 sites, d 3, bond 128", spin1_case(device), smi)
    measure("dmrg_ensemble sweep, 64 x 32 sites, bond 32", ensemble_case(device), smi)
    measure("tdvp1_step, 100 sites, bond 64, complex128", tdvp_case(device), smi)


if __name__ == "__main__":
    main()
