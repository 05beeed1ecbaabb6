"""The port's parallel MPS layer against the JAX package's, on the CPU.

``parallel/mesh.py``, ``_collectives.py``, ``sharded.py``, ``tp.py``, the
sharded half of ``training.py``, ``pipeline.py``, ``generative.py`` and the
``axis_name=`` of ``ops/krylov.py`` run in ONE world of 8 CPU processes
over gloo (the module-scoped fixture ``world``): every scenario runs on every
rank in float64, and each rank writes its outputs to a temporary directory.
The tests then hold them against the JAX package's own sharded functions,
run here on the conftest's 8 virtual CPU devices, at the JAX tests' sizes
and tolerances (``tests/test_parallel.py``, ``test_pipeline.py``,
``test_generative_sharded.py``); gradient scenarios compare the updated
parameters, not only the losses.  The inputs are drawn once with numpy.

The ranks import this module under the ``spawn`` start method, so its
top-level imports are torch, numpy and the port only: the JAX package is
imported inside the test bodies.  Also here: the dry run
(``dryrun_multichip(8)``, its own world) and a rehearsal of
``chip_smoke.py``'s phase 14 on a world of one rank.
"""

import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import mps_from_numpy, mps_to_numpy
from contractn_tpu_torch.models import MPS
from contractn_tpu_torch.ops import krylov
from contractn_tpu_torch.ops.optim import Adam
from contractn_tpu_torch.parallel import (
    fit_born_machine_sharded,
    make_mesh,
    make_optax_train_step,
    make_pipeline_train_step,
    make_sharded_train_step,
    make_tp_train_step,
    pipeline_mps_forward,
    sharded_mps_forward,
)
from contractn_tpu_torch.parallel._collectives import all_gather, mesh_grads
from contractn_tpu_torch.parallel.mesh import axis_group, axis_index
from contractn_tpu_torch.utils.errors import TNError
from torch_parallel_world import message as _message
from torch_parallel_world import mps_arrays as _mps_arrays
from torch_parallel_world import replicated as _got
from torch_parallel_world import run, save

torch.set_num_threads(1)


def _inputs():
    """Every scenario's inputs, drawn once with numpy."""
    rng = np.random.default_rng(0)
    out = {}
    for tag, (n, d, bond, batch) in {"a": (8, 2, 4, 8), "tp": (8, 2, 8, 8),
                                     "pipe": (16, 2, 4, 8), "grad": (8, 2, 3, 4),
                                     "ptrain": (8, 2, 4, 8)}.items():
        cores, left, right = _mps_arrays(rng, n, d, bond)
        out.update({f"{tag}_cores": cores, f"{tag}_left": left, f"{tag}_right": right,
                    f"{tag}_x": rng.standard_normal((batch, n, d))})
    # Born machine on GHZ samples (tests/test_generative_sharded.py)
    born = _mps_arrays(rng, 6, 2, 4)
    out.update(born_cores=born[0], born_left=np.abs(born[1]) + 0.1,
               born_right=np.abs(born[2]) + 0.1,
               born_data=np.repeat(rng.integers(0, 2, (800, 1)), 6, axis=1))
    # Lanczos / Arnoldi over 2 ranks
    h = rng.standard_normal((16, 16))
    out.update(lz_h=(h + h.T) / 2, lz_a=rng.standard_normal((16, 16)),
               lz_v0=rng.standard_normal(16))
    return out


def _mps(inp, tag):
    return mps_from_numpy(inp[f"{tag}_cores"], inp[f"{tag}_left"], inp[f"{tag}_right"],
                          device="cpu")


def _rank(rank, world_size, tmp):
    """Every scenario, on one rank; outputs to ``tmp/rank{rank}.npz``."""
    inp = dict(np.load(f"{tmp}/inputs.npz"))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    mesh = make_mesh({"dp": 4, "sp": 2}, device="cpu")

    mps = _mps(inp, "a")
    x, y = t["a_x"], torch.zeros(8, dtype=torch.float64)
    out["fwd_amp"], out["fwd_log"] = sharded_mps_forward(mesh, mps.cores, mps.left,
                                                         mps.right, x)
    step = make_sharded_train_step(mesh, lr=1e-2)
    new, loss = step(mps, x, y)
    out["sh_cores"], out["sh_left"], out["sh_right"] = mps_to_numpy(new)
    out["sh_loss"] = loss
    losses, m = [], mps
    for _ in range(3):
        m, value = step(m, x, y)
        losses.append(float(value))
    out["sh_losses"] = np.array(losses)

    tp_mps = _mps(inp, "tp")
    tp_step = make_tp_train_step(make_mesh({"dp": 2, "sp": 2, "tp": 2}, device="cpu"),
                                 lr=1e-2)
    new, out["tp_loss"] = tp_step(tp_mps, t["tp_x"], y)
    out["tp_cores"], out["tp_left"], out["tp_right"] = mps_to_numpy(new)

    ostep, oinit = make_optax_train_step(lambda p: Adam(p, lr=1e-2), mesh=mesh)
    new, _, out["opt_loss"] = ostep(mps, oinit(mps), x, y)
    out["opt_cores"], out["opt_left"], out["opt_right"] = mps_to_numpy(new)

    odd = MPS(mps.cores[:7], mps.left, mps.right)
    out["msg_sites"] = _message(lambda: step(odd, x[:, :7], y))
    out["msg_batch"] = _message(lambda: step(mps, x[:6], y[:6]))
    out["msg_mesh"] = _message(lambda: make_mesh({"dp": 3}, device="cpu"))

    # pipeline
    mesh_p4 = make_mesh({"dp": 2, "pp": 4}, device="cpu")
    mesh_p8 = make_mesh({"pp": 8}, device="cpu")
    pm = _mps(inp, "pipe")
    for stages, n_micro in ((4, 4), (4, 8), (8, 8)):
        amp, log = pipeline_mps_forward(mesh_p8 if stages == 8 else mesh_p4, pm.cores,
                                        pm.left, pm.right, t["pipe_x"], n_micro=n_micro)
        out[f"pipe_{stages}_{n_micro}_amp"], out[f"pipe_{stages}_{n_micro}_log"] = amp, log

    gm = _mps(inp, "grad")
    cores = gm.cores.clone().requires_grad_(True)
    amp, log = pipeline_mps_forward(mesh_p4, cores, gm.left, gm.right, t["grad_x"],
                                    n_micro=4)
    (out["pipe_grad"],) = mesh_grads(torch.sum(torch.log(amp.abs() + 1e-30) + log),
                                     [cores], mesh_p4)

    big = torch.full((16, 2, 3, 3), 1e40, dtype=torch.float64)
    ones = torch.ones(3, dtype=torch.float64)
    out["pipe_big_amp"], out["pipe_big_log"] = pipeline_mps_forward(
        mesh_p4, big, ones, ones, torch.ones((4, 16, 2), dtype=torch.float64), n_micro=4)
    out["msg_pipe_sites"] = _message(lambda: pipeline_mps_forward(
        mesh_p4, pm.cores[:15], pm.left, pm.right, t["pipe_x"][:, :15]))
    out["msg_pipe_micro"] = _message(lambda: pipeline_mps_forward(
        mesh_p4, pm.cores, pm.left, pm.right, t["pipe_x"][:6], n_micro=4))

    ptm = _mps(inp, "ptrain")
    pstep = make_pipeline_train_step(mesh_p4, lr=1e-2, n_micro=4)
    new, out["pt_loss"] = pstep(ptm, t["ptrain_x"], y)
    out["pt_cores"] = mps_to_numpy(new)[0]
    losses, m = [], ptm
    for _ in range(3):
        m, value = pstep(m, t["ptrain_x"], y)
        losses.append(float(value))
    out["pt_losses"] = np.array(losses)

    # Born machine over dp 8
    mesh_dp = make_mesh({"dp": 8}, device="cpu")
    _, out["born_losses"] = fit_born_machine_sharded(_mps(inp, "born"), t["born_data"],
                                                     mesh_dp, steps=60, lr=0.02)
    out["msg_born"] = _message(lambda: fit_born_machine_sharded(
        _mps(inp, "born"), np.zeros((9, 6), np.int64), mesh_dp, steps=1))

    # Krylov vectors sharded over 2 ranks
    mesh_k = make_mesh({"k": 2}, devices=[0, 1], device="cpu")
    if rank < 2:
        group = axis_group(mesh_k, "k")
        rows = slice(8 * axis_index(group), 8 * axis_index(group) + 8)

        def matvec(a):
            return lambda v: a[rows] @ all_gather(v, group, tiled=True)

        v0 = t["lz_v0"][rows]
        e, vec = krylov.lanczos_ground(matvec(t["lz_h"]), v0, 10, axis_name=group)
        out["lz_energy"], out["lz_vec"] = e, all_gather(vec, group, tiled=True)
        _, out["lz_alphas"], out["lz_betas"], _ = krylov.lanczos_basis(
            matvec(t["lz_h"]), v0, 10, axis_name=group)
        _, out["ar_h"], _ = krylov.arnoldi_basis(matvec(t["lz_a"]), v0, 8,
                                                 axis_name=group)

    save(tmp, rank, out)


def _jmps(inp, tag):
    import jax.numpy as jnp

    from contractn_tpu.models import MPS as JMPS

    return JMPS(*(jnp.asarray(inp[f"{tag}_{k}"]) for k in ("cores", "left", "right")))


def _jmesh(axes):
    from contractn_tpu.parallel import make_mesh as j_make_mesh

    return j_make_mesh(axes)


def _host(m):
    return {k: np.asarray(getattr(m, k)) for k in ("cores", "left", "right")}


def _references(inp):
    """The JAX package's sharded functions on the same inputs."""
    import jax
    import jax.numpy as jnp
    import optax

    from contractn_tpu.ops import krylov as jk
    from contractn_tpu.parallel import fit_born_machine_sharded as j_fit
    from contractn_tpu.parallel import make_optax_train_step as j_optax
    from contractn_tpu.parallel import make_pipeline_train_step as j_pipe_step
    from contractn_tpu.parallel import make_sharded_train_step as j_sh_step
    from contractn_tpu.parallel import make_tp_train_step as j_tp_step
    from contractn_tpu.parallel import pipeline_mps_forward as j_pipe
    from contractn_tpu.parallel import sharded_mps_forward as j_fwd

    ref = {}
    mesh, m, zeros = _jmesh({"dp": 4, "sp": 2}), _jmps(inp, "a"), jnp.zeros(8, jnp.float64)
    x = jnp.asarray(inp["a_x"])
    amp, log = jax.jit(lambda c, l, r, xx: j_fwd(mesh, c, l, r, xx))(m.cores, m.left,
                                                                        m.right, x)
    ref["fwd"] = np.asarray(amp) * np.exp(np.asarray(log))
    new, loss = j_sh_step(mesh, lr=1e-2)(m, x, zeros)
    ref["sh"] = (_host(new), float(loss))
    new, loss = j_tp_step(_jmesh({"dp": 2, "sp": 2, "tp": 2}), lr=1e-2)(
        _jmps(inp, "tp"), jnp.asarray(inp["tp_x"]), zeros)
    ref["tp"] = (_host(new), float(loss))
    step, init = j_optax(optax.adam(1e-2), mesh=mesh)
    new, _, loss = step(m, init(m), x, zeros)
    ref["opt"] = (_host(new), float(loss))

    mesh_p4, pm = _jmesh({"dp": 2, "pp": 4}), _jmps(inp, "pipe")
    for stages, n_micro in ((4, 4), (4, 8), (8, 8)):
        pmesh = _jmesh({"pp": 8}) if stages == 8 else mesh_p4
        amp, log = jax.jit(lambda c, l, r, xx: j_pipe(pmesh, c, l, r, xx, n_micro=n_micro))(
            pm.cores, pm.left, pm.right, jnp.asarray(inp["pipe_x"]))
        ref[f"pipe_{stages}_{n_micro}"] = (np.asarray(amp), np.asarray(log))
    gm, gx = _jmps(inp, "grad"), jnp.asarray(inp["grad_x"])

    def grad_loss(cores):
        amp, log = j_pipe(mesh_p4, cores, gm.left, gm.right, gx, n_micro=4)
        return jnp.sum(jnp.log(jnp.abs(amp) + 1e-30) + log)

    ref["pipe_grad"] = np.asarray(jax.jit(jax.grad(grad_loss))(gm.cores))
    ones = jnp.ones((3,), jnp.float64)
    ref["pipe_big"] = tuple(np.asarray(t) for t in j_pipe(
        mesh_p4, jnp.full((16, 2, 3, 3), 1e40, jnp.float64), ones, ones,
        jnp.ones((4, 16, 2), jnp.float64), n_micro=4))
    new, loss = j_pipe_step(mesh_p4, lr=1e-2, n_micro=4)(
        _jmps(inp, "ptrain"), jnp.asarray(inp["ptrain_x"]), zeros)
    ref["pt"] = (_host(new), float(loss))

    _, losses = j_fit(_jmps(inp, "born"), inp["born_data"], _jmesh({"dp": 8}), steps=60,
                      lr=0.02)
    ref["born"] = np.asarray(losses)

    h, a, v0 = (jnp.asarray(inp[k]) for k in ("lz_h", "lz_a", "lz_v0"))
    e, vec = jk.lanczos_ground(lambda v: h @ v, v0, 10)
    _, alphas, betas, _ = jk.lanczos_basis(lambda v: h @ v, v0, 10)
    ref["lz"] = (float(e), np.asarray(vec), np.asarray(alphas), np.asarray(betas),
                 np.asarray(jk.arnoldi_basis(lambda v: a @ v, v0, 8)[1]))
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' outputs, and the JAX references computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    ref, ranks = run(_rank, tmp, lambda: _references(inp))
    return inp, ref, ranks


def _check_step(ranks, tag, ref, rtol_loss, rtol, atol=0.0):
    """A training step's loss and updated parameters against the JAX step's."""
    want, loss = ref
    np.testing.assert_allclose(_got(ranks, f"{tag}_loss"), loss, rtol=rtol_loss)
    for k, v in want.items():
        np.testing.assert_allclose(_got(ranks, f"{tag}_{k}"), v, rtol=rtol, atol=atol)


def test_sharded_forward_matches_jax(world):
    _, ref, ranks = world
    got = _got(ranks, "fwd_amp") * np.exp(_got(ranks, "fwd_log"))
    np.testing.assert_allclose(got, ref["fwd"], rtol=1e-9)


def test_sharded_train_step_matches_jax(world):
    _, ref, ranks = world
    _check_step(ranks, "sh", ref["sh"], 1e-9, 1e-8)
    assert _got(ranks, "sh_losses")[-1] < ref["sh"][1]


def test_tp_train_step_matches_jax(world):
    _, ref, ranks = world
    _check_step(ranks, "tp", ref["tp"], 1e-9, 1e-8)


def test_optax_train_step_over_a_mesh_matches_jax(world):
    _, ref, ranks = world
    _check_step(ranks, "opt", ref["opt"], 1e-10, 1e-10, atol=1e-14)


def test_shape_and_mesh_messages_match_jax(world):
    import jax.numpy as jnp

    from contractn_tpu.models import MPS as JMPS
    from contractn_tpu.parallel import make_sharded_train_step as j_step

    inp, _, ranks = world
    m = _jmps(inp, "a")
    x = jnp.asarray(inp["a_x"])
    step = j_step(_jmesh({"dp": 4, "sp": 2}))
    for key, args in (("msg_sites", (JMPS(m.cores[:7], m.left, m.right), x[:, :7],
                                     jnp.zeros(8))),
                      ("msg_batch", (m, x[:6], jnp.zeros(6)))):
        with pytest.raises(ValueError) as err:
            step(*args)
        assert str(_got(ranks, key)) == str(err.value)
    with pytest.raises(ValueError) as err:
        _jmesh({"dp": 3})
    assert str(_got(ranks, "msg_mesh")) == str(err.value) != ""


def test_make_mesh_refuses_without_a_process_group_or_gpu(monkeypatch):
    with pytest.raises(TNError, match="init_process_group"):
        make_mesh({"dp": 1}, device="cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TNError, match="device='cpu'"):
        make_mesh({"dp": 1})


@pytest.mark.parametrize("stages,n_micro", [(4, 4), (4, 8), (8, 8)])
def test_pipeline_forward_matches_jax(world, stages, n_micro):
    _, ref, ranks = world
    amp, log = ref[f"pipe_{stages}_{n_micro}"]
    # same per-site rescale schedule: the split components match
    np.testing.assert_allclose(_got(ranks, f"pipe_{stages}_{n_micro}_amp"), amp, rtol=1e-10)
    np.testing.assert_allclose(_got(ranks, f"pipe_{stages}_{n_micro}_log"), log, rtol=1e-10)


def test_pipeline_gradients_match_jax(world):
    _, ref, ranks = world
    np.testing.assert_allclose(_got(ranks, "pipe_grad"), ref["pipe_grad"], rtol=1e-8)


def test_pipeline_overflowing_chain_and_messages_match_jax(world):
    import jax.numpy as jnp

    from contractn_tpu.parallel import pipeline_mps_forward as j_pipe

    inp, ref, ranks = world
    got_amp, got_log = _got(ranks, "pipe_big_amp"), _got(ranks, "pipe_big_log")
    assert np.all(np.isfinite(got_amp)) and np.all(np.isfinite(got_log))
    np.testing.assert_allclose(got_amp, ref["pipe_big"][0], rtol=1e-12)
    np.testing.assert_allclose(got_log, ref["pipe_big"][1], rtol=1e-12)
    m, mesh = _jmps(inp, "pipe"), _jmesh({"dp": 2, "pp": 4})
    x = jnp.asarray(inp["pipe_x"])
    for key, args, kw in (("msg_pipe_sites", (m.cores[:15], m.left, m.right, x[:, :15]), {}),
                          ("msg_pipe_micro", (m.cores, m.left, m.right, x[:6]),
                           {"n_micro": 4})):
        with pytest.raises(ValueError) as err:
            j_pipe(mesh, *args, **kw)
        assert str(_got(ranks, key)) == str(err.value)


def test_pipeline_train_step_matches_jax(world):
    _, ref, ranks = world
    want, loss = ref["pt"]
    np.testing.assert_allclose(_got(ranks, "pt_loss"), loss, rtol=1e-9)
    np.testing.assert_allclose(_got(ranks, "pt_cores"), want["cores"], rtol=1e-8)
    assert _got(ranks, "pt_losses")[-1] < loss


def test_born_machine_sharded_trajectory_matches_jax(world):
    from contractn_tpu.parallel import fit_born_machine_sharded as j_fit

    inp, ref, ranks = world
    got = _got(ranks, "born_losses")
    assert np.max(np.abs(got - ref["born"])) < 1e-12
    assert got[-1] < got[0]
    with pytest.raises(ValueError) as err:
        j_fit(_jmps(inp, "born"), np.zeros((9, 6), np.int32), _jmesh({"dp": 8}), steps=1)
    assert str(_got(ranks, "msg_born")) == str(err.value)


def test_krylov_axis_name_over_two_ranks_matches_jax(world):
    _, ref, ranks = world
    e, vec, alphas, betas, hess = ref["lz"]
    np.testing.assert_allclose(_got(ranks, "lz_energy", range(2)), e, rtol=1e-10)
    np.testing.assert_allclose(_got(ranks, "lz_vec", range(2)), vec, atol=1e-10)
    np.testing.assert_allclose(_got(ranks, "lz_alphas", range(2)), alphas, rtol=1e-10)
    np.testing.assert_allclose(_got(ranks, "lz_betas", range(2)), betas, rtol=1e-10)
    np.testing.assert_allclose(_got(ranks, "ar_h", range(2)), hess, atol=1e-10)
    assert "lz_energy" not in ranks[2]  # ranks outside the 2-rank mesh skip it


def test_chip_smoke_parallel_rehearsal_on_cpu():
    # phase 14 at a tiny size on a world of one rank over gloo: every path
    # runs and is held against its single-device counterpart, nothing is
    # launched on the CPU
    import chip_smoke

    runs = chip_smoke.parallel_phase(torch.device("cpu"), "cpu", chip_smoke.PARALLEL_TINY)
    assert set(runs) == {
        "sharded_forward", "forward_reference", "train_reference", "train_sharded",
        "train_tp", "train_pipeline", "born_reference", "born_sharded", "dmrg_tp",
        "dmrg_tp_reference", "dmrg_realspace", "dmrg_tp_small", "ensemble_sharded",
        "ensemble_reference", "scan_sharded", "scan_reference", "cv_sharded",
        "cv_reference"}
    for counts, _ in runs.values():
        assert set(counts.values()) == {0}
    assert not torch.distributed.is_initialized()
