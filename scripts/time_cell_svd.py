#!/usr/bin/env python3
"""Time the small dense decompositions of the checkerboard iPEPS paths on the
card under each cuSOLVER driver, and the route ``linalg_ad.small_svd`` takes.

    python3 scripts/time_cell_svd.py [ITERS]

Runs on the first CUDA device (and exits nonzero without one).  Prints the
card's name and power limit first, then, on the host clock ending in a
synchronize (median of 9 calls after a warm-up):

* one float64 SVD at the shapes phase 12 of ``chip_smoke.py`` decomposes:
  the cell CTMRG's projector matrices (64, 128 and 324 square: chi 16 at
  q 4, chi 64 at q 2, chi 36 at q 9, alone and as the batches a column's
  rows or the scan's members make), the simple update's pair splits (16
  and 54 square: D 2 and 3) and a batch of 16 pair splits (the scan), under
  torch's default driver, ``gesvd``, ``gesvdj``, ``gesvda``, the route of
  ``small_svd``, and LAPACK through the CPU build of the same torch (the
  factors copied back; a reference the port does not take), with each
  result's largest reconstruction error;
* one ``eigh`` of the full update's metric and normal matrices (16 and 32
  square) on the card and on the host;
* ``ctmrg_cell`` (growth plus ITERS iterations, default 20) of the 2x2
  Ising antiferromagnet at beta 0.5, chi 64, with every SVD forced to
  torch's default driver, to ``gesvd``, and as ``small_svd`` routes it, its
  staggered magnetization against the same run on the CPU;
* ``ipeps_cell_ground_state`` of the unrotated Heisenberg model (D 2, chi
  12, the default 500 sweeps, 60 CTMRG iterations) under the same three
  routes, its energy against the CPU's: cuSOLVER signs its singular vectors
  unlike LAPACK, and the checkerboard update must not care;
* at chi 16 (64 x 64 projector matrices) from that model's D 2
  simple-update cell: 20 cell CTMRG iterations, and one value and gradient
  of ``make_cell_loss`` (2 untaped and 2 differentiated iterations, as
  phase 12's variational flow takes them), under the same three routes.
"""

import statistics
import subprocess
import sys
import time
from importlib import import_module
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

cc = import_module("contractn_tpu_torch.models.ctmrg_cell")
ic = import_module("contractn_tpu_torch.models.ipeps_cell")
ip = import_module("contractn_tpu_torch.models.ipeps")
tv = import_module("contractn_tpu_torch.models.variational")
linalg_ad = import_module("contractn_tpu_torch.ops.linalg_ad")

ROUTES = (None, "gesvd", "gesvdj", "gesvda", "small_svd", "host")
PATH_ROUTES = (None, "gesvd", "small_svd")  # gesvdj and gesvda fail to converge there
REAL_SVD = torch.linalg.svd


def timed(fn, device, reps=9):
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def svd_route(m, route):
    if route == "host":
        u, s, vh = REAL_SVD(m.cpu(), full_matrices=False)
        return u.to(m.device), s.to(m.device), vh.to(m.device)
    if route == "small_svd":
        return linalg_ad.small_svd(m)
    return REAL_SVD(m, full_matrices=False, driver=route)


def force_route(route):
    """Route every ``torch.linalg.svd`` on the card through ``route`` (as
    ``small_svd`` chooses, for ``"small_svd"``)."""
    if route == "small_svd":
        torch.linalg.svd = REAL_SVD
        return

    def svd(m, full_matrices=True, driver=None):
        return REAL_SVD(m, full_matrices=full_matrices, driver=route if m.is_cuda else None)

    torch.linalg.svd = svd


def decay(shape, device, gen):
    """A matrix with the fast-decaying spectrum of a converged environment."""
    n = shape[-1]
    q, _ = torch.linalg.qr(torch.randn(shape, dtype=torch.float64, device=device,
                                       generator=gen))
    w, _ = torch.linalg.qr(torch.randn(shape, dtype=torch.float64, device=device,
                                       generator=gen))
    s = torch.exp(-0.3 * torch.arange(n, dtype=torch.float64, device=device))
    return (q * s) @ w.transpose(-2, -1)


def afm_reading(device, iters):
    cell, imps = chip_smoke.afm_cell(0.5, 1e-4, device)
    env = cc.ctmrg_cell(cell, 64, iters=iters)
    return float(cc.site_expectation(cell, env, imps[0][0]))


def heisenberg_energy(device):
    h2 = ip.heisenberg_bond_term_2d(rotated=False, device=device)
    return float(ic.ipeps_cell_ground_state(h2, 2, 12, iters=60)[2])


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the card")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    gen = torch.Generator(device=device).manual_seed(0)
    for shape in ((64, 64), (128, 128), (324, 324), (2, 128, 128), (32, 64, 64), (16, 16),
                  (54, 54), (16, 16, 16)):
        m = decay(shape, device, gen)
        line = []
        for route in ROUTES:
            try:
                (u, s, vh), secs = timed(lambda: svd_route(m, route), device)
            except RuntimeError as exc:
                line.append(f"{route}: {type(exc).__name__}")
                continue
            err = float(((u * s[..., None, :]) @ vh - m).abs().max())
            line.append(f"{route} {secs * 1e3:.3f} ms (err {err:.1e})")
        print(f"svd {shape}: " + "; ".join(line), flush=True)
    for n in (16, 32):
        a = decay((n, n), device, gen)
        h = a @ a.T
        _, card = timed(lambda: torch.linalg.eigh(h), device)
        _, host = timed(lambda: tuple(x.to(device) for x in torch.linalg.eigh(h.cpu())), device)
        print(f"eigh ({n}, {n}): card {card * 1e3:.3f} ms, host {host * 1e3:.3f} ms", flush=True)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    m_cpu = afm_reading(cpu, iters)
    print(f"ctmrg_cell AFM chi 64, {iters} iterations on the CPU: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for route in PATH_ROUTES:
        force_route(route)
        m, secs = timed(lambda: afm_reading(device, iters), device, reps=1)
        print(f"ctmrg_cell AFM chi 64, {iters} iterations, projector SVDs by {route}: "
              f"{secs:.2f} s, |m - CPU| {abs(m - m_cpu):.3e} ({smi})", flush=True)
    e_cpu = heisenberg_energy(cpu)
    for route in PATH_ROUTES:
        force_route(route)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        e = heisenberg_energy(device)
        secs = time.perf_counter() - t0
        print(f"ipeps_cell_ground_state Heisenberg D 2, chi 12, SVDs by {route}: {secs:.2f} s, "
              f"energy {e!r}, |E - CPU| {abs(e - e_cpu):.3e} ({smi})", flush=True)
    force_route("small_svd")
    h2 = ip.heisenberg_bond_term_2d(rotated=False, device=device)
    a, b = ic.su_cell_absorb(*ic.simple_update_cell(h2, 2))
    cell = ic.checkerboard_cell(a, b)
    env = cc.ctmrg_cell(cell, 16, iters=20)
    loss = tv.make_cell_loss(h2, 16, refresh_iters=2, grad_iters=2)

    def step():
        pa, pb = (x.detach().clone().requires_grad_(True) for x in (a, b))
        e, _ = loss(pa, pb, env)
        return torch.autograd.grad(e, (pa, pb))

    for route in PATH_ROUTES:
        force_route(route)
        _, ctm = timed(lambda: cc.ctmrg_cell(cell, 16, iters=iters), device, reps=3)
        _, grad = timed(step, device, reps=5)
        print(f"Heisenberg D 2 cell at chi 16, SVDs by {route}: ctmrg_cell {iters} iterations "
              f"{ctm:.3f} s, one make_cell_loss value and gradient {grad:.3f} s ({smi})",
              flush=True)
    force_route("small_svd")


if __name__ == "__main__":
    main()
