"""A multi-process dry run of the parallel layer on the CPU.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``, which forces a CPU platform with ``n_devices``
virtual devices.  Here :func:`dryrun_multichip` spawns ``n_devices``
processes in a gloo process group over localhost and runs, on tiny shapes,
one sharded training step (a 3-axis ``dp x sp x tp`` step when
``n_devices % 4 == 0``, else ``dp x sp``), then the model layer: the
ensemble DMRG over ``dp``, the tensor-parallel DMRG, the real-space DMRG,
the sharded Born machine and the sharded spectra.  Every loss, energy and
value must be finite; a failure raises with every rank's error attached.

:func:`run_cpu_world` is the spawning harness itself, for any function of
``(rank, world_size, *args)`` that lives in a module importable by a fresh
process.
"""

import multiprocessing
import queue
import socket
import time
import traceback
from datetime import timedelta


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(fn, rank, world_size, port, args, results, timeout):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout))
        value = fn(rank, world_size, *args)
        dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_cpu_world(fn, world_size, args=(), timeout=600.0):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each a rank of one gloo process group over localhost (one
    thread each), and return the list of their return values by rank.

    Raises :class:`RuntimeError` with every rank's traceback when any rank
    fails or the world outlives ``timeout`` seconds; the other ranks are
    then terminated.
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, port, args, results, timeout),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    done, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in errors]
                for r in dead:
                    errors[r] = f"rank {r} exited with code {procs[r].exitcode}"
                continue
            (done if ok else errors)[rank] = value
            if errors:  # give the others a moment to report theirs, then stop
                deadline = min(deadline, time.monotonic() + 5.0)
    finally:
        for p in procs:
            p.join(timeout=0.0 if errors else 10.0)
            if p.is_alive():
                p.terminate()
                p.join()
    if errors or len(done) < world_size:
        missing = [r for r in range(world_size) if r not in done and r not in errors]
        report = "".join(f"\n--- rank {r} ---\n{errors[r]}" for r in sorted(errors))
        if missing:
            report += f"\n--- ranks {missing}: no result within {timeout:.0f} s ---"
        raise RuntimeError(f"{world_size}-rank CPU world failed:{report}")
    return [done[r] for r in range(world_size)]


def dryrun_multichip(n_devices):
    """Spawn ``n_devices`` gloo ranks on the CPU and run the sharded
    training step and the sharded model layer on tiny shapes (see the module
    docstring).  Raises :class:`RuntimeError` on any rank's failure."""
    run_cpu_world(_dryrun_rank, int(n_devices))
    print(f"dryrun_multichip({int(n_devices)}) OK")


def _check_finite(what, values):
    import numpy as np

    values = np.asarray(values)
    if not np.all(np.isfinite(values)):
        raise RuntimeError(f"{what}: non-finite {values}")


def _dryrun_rank(rank, n_devices):
    """One rank of the dry run: the training step, then the model layer."""
    import torch

    from ..models import MPS
    from . import make_mesh, make_sharded_train_step, make_tp_train_step

    gen = torch.Generator().manual_seed(0)
    use_tp = n_devices % 4 == 0
    if use_tp:
        tp, sp = 2, 2
        dp = n_devices // 4
        mesh = make_mesh({"dp": dp, "sp": sp, "tp": tp}, device="cpu")
    else:
        sp = 2 if n_devices % 2 == 0 else 1
        dp, tp = n_devices // sp, 1
        mesh = make_mesh({"dp": dp, "sp": sp}, device="cpu")
    n_sites, batch = 4 * sp, 2 * dp
    phys_dim, bond_dim = 2, 4 * tp  # bond divisible by the tp axis
    mps = MPS.random(n_sites, phys_dim, bond_dim, dtype=torch.float32, generator=gen,
                     device="cpu")
    x = torch.randn((batch, n_sites, phys_dim), generator=gen)
    y = torch.zeros((batch,))
    step = (make_tp_train_step(mesh, lr=1e-2) if use_tp
            else make_sharded_train_step(mesh, lr=1e-2))
    new, loss = step(mps, x, y)
    _check_finite("sharded training step loss", float(loss))
    _check_finite("sharded training step cores", new.cores.detach())
    _dryrun_models(n_devices)


def _dryrun_models(n_devices):
    """The sharded model layer at the JAX dry run's shapes and dtypes."""
    import numpy as np
    import torch

    from ..models import MPS, dmrg, stack_pytrees, tfim_mpo
    from ..models.born import born_machine
    from . import (cv_greens_function_sharded, dmrg_ensemble_sharded, dmrg_realspace,
                   dmrg_uniform_tp, fit_born_machine_sharded, make_mesh)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # ensemble DMRG: K = n_devices TFIM couplings over a dp axis
    n_sites, bond = 6, 4
    hs = [0.5 + 0.2 * i for i in range(n_devices)]
    mpos = stack_pytrees([tfim_mpo(n_sites, h=h, device="cpu") for h in hs])
    mps0s = stack_pytrees([MPS.random(n_sites, 2, bond, dtype=torch.float32,
                                      generator=gen(i), device="cpu")
                           for i in range(n_devices)])
    mesh_dp = make_mesh({"dp": n_devices}, device="cpu")
    _, energies, _ = dmrg_ensemble_sharded(mesh_dp, mpos, mps0s, sweeps=1, lanczos_iters=8)
    _check_finite("sharded ensemble DMRG energies", energies)

    # tensor-parallel DMRG: one search, local solves sharded over the bond
    mesh_tp = make_mesh({"tp": n_devices}, device="cpu")
    mps0 = MPS.random(n_sites, 2, 2 * n_devices, dtype=torch.float32, generator=gen(7),
                      device="cpu")
    _, e_tp, _ = dmrg_uniform_tp(mesh_tp, tfim_mpo(n_sites, device="cpu"), mps0, sweeps=1,
                                 lanczos_iters=8)
    _check_finite("tp DMRG energy", float(e_tp))

    # real-space parallel DMRG: one search, chain windows over an sp axis
    n_rs = 2 * n_devices
    mps_rs = MPS.random(n_rs, 2, 4, dtype=torch.float32, generator=gen(9), device="cpu")
    mesh_sp = make_mesh({"sp": n_devices}, device="cpu")
    _, e_rs, _ = dmrg_realspace(mesh_sp, tfim_mpo(n_rs, device="cpu"), mps_rs,
                                outer_iters=2, lanczos_iters=8, final_sweeps=1)
    _check_finite("rs DMRG energy", float(e_rs))

    # data-parallel Born-machine training
    data = torch.randint(0, 2, (4 * n_devices, n_sites), generator=gen(3))
    model = born_machine(n_sites, 2, 4, dtype=torch.float32, generator=gen(3), device="cpu")
    _, nlls = fit_born_machine_sharded(model, data, mesh_dp, steps=2, lr=0.01)
    _check_finite("sharded Born training", nlls.detach())

    # frequency-sharded dynamical spectra
    mps_cv = MPS.random(n_sites, 2, 4, dtype=torch.float64, generator=gen(11),
                        device="cpu")
    h_cv = tfim_mpo(n_sites, device="cpu")
    gs_cv, e0_cv, _ = dmrg(h_cv, mps_cv, max_bond=4, sweeps=1)
    g = cv_greens_function_sharded(mesh_dp, h_cv, gs_cv, e0_cv, np.diag([1.0, -1.0]), 2,
                                   np.linspace(0.0, 3.0, n_devices), 0.5, max_bond=6,
                                   sweeps=1, cg_iters=6)
    _check_finite("sharded CV spectra", g)
