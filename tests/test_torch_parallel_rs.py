"""The port's real-space parallel DMRG and sharded spectra against the JAX
package, on the CPU.

``parallel/rs_dmrg.py`` and ``spectra.py`` run in ONE world of 8 CPU
processes over gloo (the module-scoped fixture ``world``), in float64: every
scenario of ``tests/test_rs_dmrg.py`` on the ranks of its mesh (4, 2 and 8
windows), then the correction-vector grid of
``tests/test_parallel_models.py`` over 8 ranks.  Meanwhile the references
run here on the conftest's 8 virtual CPU devices: for the real-space DMRG the
JAX test's own criteria against the JAX package's serial ``dmrg_uniform`` at
the same bond and Krylov depth (the final energies, the Rayleigh quotients of
the returned states and the raw parallel plateau); for the spectra the JAX
package's ``cv_greens_function_sharded`` on the ground state the port finds
once here, to 1e-10.

The start states are the JAX tests' own (``MPS.random`` with their keys),
drawn once here and saved for the ranks: the JAX test pins the parallel
phase's trace (5e-2 of the optimum after 14 iterations) on its start, and
that bound depends on the start in both packages (from a numpy-drawn start
the JAX package's own trace ends 0.135 above the optimum).  The trace also
depends on the SVD's sign convention at the window stitch, which differs
between torch's and JAX's CPU builds on wide blocks, so the two packages'
traces part after the first iteration; the polished energies agree.

The ranks import this module under the ``spawn`` start method, so its
top-level imports are torch, numpy and the port only.
"""

import os
import time

import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import mps_from_numpy, mps_to_numpy
from contractn_tpu_torch.models import dmrg, heisenberg_mpo, rayleigh, tfim_mpo
from contractn_tpu_torch.parallel import cv_greens_function_sharded, dmrg_realspace, make_mesh
from torch_parallel_world import run, save
from torch_parallel_world import message as _message
from torch_parallel_world import replicated as _got

torch.set_num_threads(1)
# name: (ranks, n, bond, model, outer_iters, lanczos_iters, final_sweeps, the
#        JAX test's key); a case runs on its ranks, one window a rank, and
#        cases on disjoint ranks run at once
CASES = {
    "tfim4": ((0, 1, 2, 3), 16, 8, "tfim", 14, 30, 1, 0),
    "plateau": ((4, 5, 6, 7), 24, 8, "tfim", 26, 30, 0, 3),
    "heis2": ((0, 1), 12, 10, "heisenberg", 12, 30, 2, 1),
    "eight": (tuple(range(8)), 16, 6, "tfim", 16, 25, 1, 3),
}
CV = {"max_bond": 10, "sweeps": 4, "cg_iters": 32}

def _mpo(model, n, pkg):
    if model == "tfim":
        return pkg.tfim_mpo(n, j=1.0, h=1.3)
    return pkg.heisenberg_mpo(n)


def _inputs():
    import jax
    import jax.numpy as jnp

    from contractn_tpu.models import MPS as JMPS

    def draw():  # one program: the same values as eager calls, one compile
        return {name: JMPS.random(jax.random.PRNGKey(key), n, 2, bond, dtype=jnp.float64)
                for name, (_, n, bond, *_, key) in CASES.items()}

    out = {f"{name}_{k}": np.asarray(getattr(m, k))
           for name, m in jax.jit(draw)().items() for k in ("cores", "left", "right")}
    # the correction vectors' ground state, found once by the port
    rng = np.random.default_rng(1)
    cores = rng.standard_normal((6, 2, 8, 8)) / 4.0
    gs, e0, _ = dmrg(tfim_mpo(6, h=1.2, device="cpu"),
                     mps_from_numpy(cores, rng.standard_normal(8), rng.standard_normal(8),
                                    device="cpu"), max_bond=8, sweeps=3)
    out["gs_cores"], out["gs_left"], out["gs_right"] = mps_to_numpy(gs)
    out["gs_e0"] = np.asarray(e0)
    out["omegas"] = np.linspace(0.0, 4.0, 8)
    return out


def _wait_for_inputs(tmp):
    """The inputs, once the parent has written them (it draws them while the
    ranks start up)."""
    path = f"{tmp}/inputs.npz"
    while not os.path.exists(path):
        time.sleep(0.05)
    return dict(np.load(path))


def _mps(inp, tag):
    return mps_from_numpy(*(inp[f"{tag}_{k}"] for k in ("cores", "left", "right")),
                          device="cpu")


class _Port:
    tfim_mpo = staticmethod(lambda n, **kw: tfim_mpo(n, device="cpu", **kw))
    heisenberg_mpo = staticmethod(lambda n: heisenberg_mpo(n, device="cpu"))


def _rank(rank, world_size, tmp):
    inp = _wait_for_inputs(tmp)
    out = {}
    meshes = {name: make_mesh({"sp": len(case[0])}, devices=list(case[0]), device="cpu")
              for name, case in CASES.items()}
    for name, (ranks, n, _, model, outer, iters, final, _) in CASES.items():
        if rank not in ranks:
            continue
        mpo = _mpo(model, n, _Port)
        m, e, es = dmrg_realspace(meshes[name], mpo, _mps(inp, name), outer_iters=outer,
                                  lanczos_iters=iters, final_sweeps=final)
        out[f"{name}_e"], out[f"{name}_es"] = e, es
        out[f"{name}_rayleigh"] = rayleigh(mpo, m)
    if rank < 4:
        ten = mps_from_numpy(*(a[:10] if a.ndim == 4 else a for a in (
            inp["tfim4_cores"], inp["tfim4_left"], inp["tfim4_right"])), device="cpu")
        out["msg_sites"] = _message(lambda: dmrg_realspace(
            meshes["tfim4"], tfim_mpo(10, device="cpu"), ten))
    eight = mps_from_numpy(*(a[:8] if a.ndim == 4 else a for a in (
        inp["eight_cores"], inp["eight_left"], inp["eight_right"])), device="cpu")
    out["msg_window"] = _message(lambda: dmrg_realspace(
        meshes["eight"], tfim_mpo(8, device="cpu"), eight))

    # the correction-vector grid over dp 8
    mesh_dp8 = make_mesh({"dp": 8}, device="cpu")
    mpo, gs, e0 = tfim_mpo(6, h=1.2, device="cpu"), _mps(inp, "gs"), float(inp["gs_e0"])
    out["cv_g"] = cv_greens_function_sharded(mesh_dp8, mpo, gs, e0, np.diag([1.0, -1.0]), 2,
                                             inp["omegas"], 0.4, **CV)
    out["msg_cv"] = _message(lambda: cv_greens_function_sharded(
        mesh_dp8, mpo, gs, e0, np.diag([1.0, -1.0]), 2, inp["omegas"][:5], 0.4, **CV))
    save(tmp, rank, out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' outputs, and the JAX references computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("parallel_rs")

    def references():  # the inputs first: the ranks wait for them
        inp = _inputs()
        np.savez(tmp / "inputs.partial.npz", **inp)
        os.replace(tmp / "inputs.partial.npz", tmp / "inputs.npz")
        return {**{name: _serial(inp, name) for name in CASES},
                "cv": _cv_reference(inp), "inputs": inp}

    return run(_rank, tmp, references)


def _serial(inp, name):
    """The JAX package's serial optimum at the case's bond and depth."""
    import jax.numpy as jnp

    from contractn_tpu import models
    from contractn_tpu.models import MPS as JMPS
    from contractn_tpu.models.ensemble import dmrg_uniform

    _, n, _, model, _, iters, _, _ = CASES[name]
    mps0 = JMPS(*(jnp.asarray(inp[f"{name}_{k}"]) for k in ("cores", "left", "right")))
    _, e, _ = dmrg_uniform(_mpo(model, n, models), mps0, sweeps=8, lanczos_iters=iters)
    return float(e)


def _jgs(inp):
    import jax.numpy as jnp

    from contractn_tpu.models import MPS as JMPS

    return JMPS(*(jnp.asarray(inp[f"gs_{k}"]) for k in ("cores", "left", "right")))


def _cv_reference(inp, omegas=None):
    from contractn_tpu.models import tfim_mpo as j_tfim
    from contractn_tpu.parallel import cv_greens_function_sharded as j_cv
    from contractn_tpu.parallel import make_mesh as j_make_mesh

    return j_cv(j_make_mesh({"dp": 8}), j_tfim(6, h=1.2), _jgs(inp), float(inp["gs_e0"]),
                np.diag([1.0, -1.0]), 2, inp["omegas"] if omegas is None else omegas, 0.4,
                **CV)


def test_tfim_four_windows_reach_the_serial_optimum(world):
    serial, ranks = world
    e_ser = serial["tfim4"]
    assert abs(float(_got(ranks, "tfim4_rayleigh", CASES["tfim4"][0])) - e_ser) < 1e-8
    assert abs(float(_got(ranks, "tfim4_e", CASES["tfim4"][0])) - e_ser) < 1e-8
    # the parallel phase alone carries the state to ~1e-3 of the optimum
    assert float(_got(ranks, "tfim4_es", CASES["tfim4"][0])[-1]) - e_ser < 5e-2


def test_heisenberg_two_windows(world):
    serial, ranks = world
    assert abs(float(_got(ranks, "heis2_rayleigh", CASES["heis2"][0])) - serial["heis2"]) < 1e-6


def test_parallel_phase_raw_plateau(world):
    serial, ranks = world
    gap = float(_got(ranks, "plateau_rayleigh", CASES["plateau"][0])) - serial["plateau"]
    assert 0 <= gap < 1e-3, gap


def test_eight_windows_minimal_segments(world):
    serial, ranks = world
    assert abs(float(_got(ranks, "eight_e", CASES["eight"][0])) - serial["eight"]) < 1e-7


def test_validation_messages_match_jax(world):
    import jax
    import jax.numpy as jnp

    from contractn_tpu.models import MPS as JMPS
    from contractn_tpu.models.dmrg import tfim_mpo as j_tfim
    from contractn_tpu.parallel import make_mesh as j_make_mesh
    from contractn_tpu.parallel.rs_dmrg import dmrg_realspace as j_rs

    serial, ranks = world
    inp = serial["inputs"]
    for key, n, w, tag in (("msg_sites", 10, 4, "tfim4"), ("msg_window", 8, 8, "eight")):
        mps0 = JMPS(jnp.asarray(inp[f"{tag}_cores"][:n]), jnp.asarray(inp[f"{tag}_left"]),
                    jnp.asarray(inp[f"{tag}_right"]))
        with pytest.raises(ValueError) as err:
            j_rs(j_make_mesh({"sp": w}, devices=jax.devices()[:w]), j_tfim(n), mps0)
        assert str(_got(ranks, key, range(w))) == str(err.value) != ""



def test_cv_greens_function_sharded_matches_jax(world):
    serial, ranks = world
    assert np.max(np.abs(_got(ranks, "cv_g") - serial["cv"])) < 1e-10
    with pytest.raises(ValueError) as err:
        _cv_reference(serial["inputs"], serial["inputs"]["omegas"][:5])
    assert str(_got(ranks, "msg_cv")) == str(err.value)
