"""The port's sharded model layer against the JAX package's, on the CPU.

``parallel/tp_dmrg.py`` and ``ensembles.py`` run in ONE world
of 8 CPU processes over gloo (the module-scoped fixture ``world``), each
scenario on the ranks of its mesh, in float64 (scenarios on disjoint ranks
run at once).  Meanwhile the JAX package's own sharded functions run here on
the conftest's 8 virtual CPU devices, at the sizes of
``tests/test_parallel_models.py``, and the tests hold the ranks' outputs
against them at that file's tolerances.  Inputs are drawn once with numpy.
(The sharded spectra are in ``tests/test_torch_parallel_rs.py``.)

The JAX test of the tensor-parallel memory reads XLA's compiled temp bytes;
its counterpart here reads the shapes the tp DMRG stores: at tp 4 the
environment stacks and the Krylov basis hold a quarter of tp 1's ket bond.

The ranks import this module under the ``spawn`` start method, so its
top-level imports are torch, numpy and the port only.
"""

import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import mps_from_numpy, mps_to_numpy
from contractn_tpu_torch.models import stack_pytrees, tfim_bond_term_2d, tfim_mpo
from contractn_tpu_torch.ops import krylov
from contractn_tpu_torch.parallel import (
    dmrg_ensemble_sharded,
    dmrg_uniform_tp,
    ipeps_cell_scan_sharded,
    make_mesh,
    tp_dmrg,
)
from torch_parallel_world import message as _message
from torch_parallel_world import mps_arrays as _mps_arrays
from torch_parallel_world import replicated as _got
from torch_parallel_world import run, save

torch.set_num_threads(1)
HS = (0.4, 0.8, 1.2, 1.6)
SCAN_HS = (1.0, 2.0, 3.0, 3.5)
SCAN = {"bond_dim": 2, "chi": 8, "schedule": ((0.1, 20), (0.02, 10)), "iters": 10}
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
# the ranks of each scenario's mesh
TP4, ENS, TP2, TP1, SCAN_RANKS = (0, 1, 2, 3), (0, 1, 2, 3), (4, 5), (6,), (4, 5, 6, 7)


def _mps(inp, tag):
    return mps_from_numpy(*(inp[f"{tag}_{k}"] for k in ("cores", "left", "right")),
                          device="cpu")


def _inputs():
    rng = np.random.default_rng(1)
    out = {}
    for tag, (n, bond) in {"tp2": (6, 8), "tp4": (6, 64), "bad": (4, 5)}.items():
        out.update(zip((f"{tag}_cores", f"{tag}_left", f"{tag}_right"),
                       _mps_arrays(rng, n, 2, bond)))
    members = [_mps_arrays(rng, 6, 2, 8) for _ in HS]
    for i, k in enumerate(("cores", "left", "right")):
        out[f"ens_{k}"] = np.stack([m[i] for m in members])
    return out


def _stored_shapes(fn):
    """Run ``fn()`` recording the shapes of the environments the tp DMRG
    stores and of the Krylov bases it builds."""
    shapes = {"env": set(), "basis": set()}
    env_ops, basis = tp_dmrg._tp_env_ops, krylov.lanczos_basis

    def recording_env_ops(group):
        def rec(op):
            def call(*args):
                out = op(*args)
                shapes["env"].add(tuple(out.shape))
                return out
            return call
        return tuple(rec(op) for op in env_ops(group))

    def recording_basis(*args, **kwargs):
        out = basis(*args, **kwargs)
        shapes["basis"].add(tuple(out[0].shape))
        return out

    tp_dmrg._tp_env_ops, krylov.lanczos_basis = recording_env_ops, recording_basis
    try:
        return fn(), shapes
    finally:
        tp_dmrg._tp_env_ops, krylov.lanczos_basis = env_ops, basis


def _rank(rank, world_size, tmp):
    inp = dict(np.load(f"{tmp}/inputs.npz"))
    out = {}
    mpo6 = tfim_mpo(6, device="cpu")
    mesh = {name: make_mesh({axis: len(ranks)}, devices=list(ranks), device="cpu")
            for name, axis, ranks in (("tp4", "tp", TP4), ("ens", "dp", ENS),
                                      ("tp2", "tp", TP2), ("tp1", "tp", TP1),
                                      ("scan", "dp", SCAN_RANKS))}

    # tensor-parallel DMRG: tp 4 and tp 1 at bond 64, tp 2 at bond 8
    for name, ranks in (("tp4", TP4), ("tp1", TP1)):
        if rank in ranks:
            (_, e, _), shapes = _stored_shapes(lambda: dmrg_uniform_tp(
                mesh[name], mpo6, _mps(inp, "tp4"), sweeps=2, lanczos_iters=16))
            out[f"{name}_e"] = e
            out[f"{name}_env"] = sorted(shapes["env"])
            out[f"{name}_basis"] = sorted(shapes["basis"])
    if rank in TP2:
        m, e, tr = dmrg_uniform_tp(mesh["tp2"], mpo6, _mps(inp, "tp2"), sweeps=3)
        out["tp2_cores"], out["tp2_left"], out["tp2_right"] = mps_to_numpy(m)
        out["tp2_e"], out["tp2_tr"] = e, tr
        out["msg_bond"] = _message(lambda: dmrg_uniform_tp(
            mesh["tp2"], tfim_mpo(4, device="cpu"), _mps(inp, "bad")))

    # ensemble DMRG and the 2D field scan over dp 4
    if rank in ENS:
        mpos = stack_pytrees([tfim_mpo(6, h=h, device="cpu") for h in HS])
        m, e, tr = dmrg_ensemble_sharded(mesh["ens"], mpos, _mps(inp, "ens"), sweeps=2)
        out["ens_cores"], out["ens_left"], out["ens_right"] = mps_to_numpy(m)
        out["ens_e"], out["ens_tr"] = e, tr
        three = mps_from_numpy(*(inp[f"ens_{k}"][:3] for k in ("cores", "left", "right")),
                               device="cpu")
        out["msg_ens"] = _message(lambda: dmrg_ensemble_sharded(
            mesh["ens"], stack_pytrees([tfim_mpo(6, h=h, device="cpu") for h in HS[:3]]),
            three, sweeps=1))
    if rank in SCAN_RANKS:
        h2 = torch.stack([tfim_bond_term_2d(h=h, device="cpu") for h in SCAN_HS])
        scan = ipeps_cell_scan_sharded(mesh["scan"], h2, ops=(SX,), **SCAN)
        out.update({f"scan_{k}": v for k, v in scan.items()})

    save(tmp, rank, out)


def _jmps(arrays):
    import jax.numpy as jnp

    from contractn_tpu.models import MPS as JMPS

    return JMPS(*(jnp.asarray(a) for a in arrays))


def _jarrays(inp, tag):
    return _jmps(tuple(inp[f"{tag}_{k}"] for k in ("cores", "left", "right")))


def _jmesh(axes, k=None):
    import jax

    from contractn_tpu.parallel import make_mesh as j_make_mesh

    return j_make_mesh(axes, devices=jax.devices()[:k] if k else None)


def _references(inp):
    """The JAX package's sharded functions on the same inputs."""
    import jax.numpy as jnp

    from contractn_tpu.models import stack_pytrees as j_stack
    from contractn_tpu.models import tfim_bond_term_2d as j_bond
    from contractn_tpu.models import tfim_mpo as j_tfim
    from contractn_tpu.parallel import dmrg_ensemble_sharded as j_ens
    from contractn_tpu.parallel import dmrg_uniform_tp as j_tp
    from contractn_tpu.parallel import ipeps_cell_scan_sharded as j_scan

    def host(m):
        return tuple(np.asarray(t) for t in (m.cores, m.left, m.right))

    ref = {}
    m, e, tr = j_tp(_jmesh({"tp": 2}, 2), j_tfim(6), _jarrays(inp, "tp2"), sweeps=3)
    ref["tp2"] = (host(m), float(e), np.asarray(tr))
    ref["tp4_e"] = float(j_tp(_jmesh({"tp": 4}, 4), j_tfim(6), _jarrays(inp, "tp4"),
                              sweeps=2, lanczos_iters=16)[1])
    m, e, tr = j_ens(_jmesh({"dp": 4}, 4), j_stack([j_tfim(6, h=h) for h in HS]),
                     _jarrays(inp, "ens"), sweeps=2)
    ref["ens"] = (host(m), np.asarray(e), np.asarray(tr))
    scan = j_scan(_jmesh({"dp": 4}, 4), jnp.stack([j_bond(h=h) for h in SCAN_HS]),
                  ops=(jnp.asarray(SX),), **SCAN)
    ref["scan"] = {k: np.asarray(v) for k, v in scan.items()}
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' outputs, and the JAX references computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("parallel_models")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    ref, ranks = run(_rank, tmp, lambda: _references(inp))
    return inp, ref, ranks


def _fidelity(a, b):
    """|<a|b>| / (|a| |b|) of two stacked MPS ``(cores, left, right)``."""
    def inner(x, y):
        t = np.outer(x[1].conj(), y[1])
        for cx, cy in zip(x[0], y[0]):
            t = np.einsum("ab,dax,dby->xy", t, cx.conj(), cy)
        return x[2].conj() @ t @ y[2]

    return abs(inner(a, b)) / np.sqrt(abs(inner(a, a) * inner(b, b)))


def test_dmrg_uniform_tp_matches_jax(world):
    from tests.test_dmrg import dense_tfim

    _, ref, ranks = world
    want, e, tr = ref["tp2"]
    got_e = float(_got(ranks, "tp2_e", TP2))
    assert np.isclose(got_e, float(np.linalg.eigvalsh(dense_tfim(6))[0]), rtol=1e-8)
    assert np.isclose(got_e, e, rtol=1e-10)
    np.testing.assert_allclose(_got(ranks, "tp2_tr", TP2), tr, rtol=1e-9)
    got = tuple(_got(ranks, f"tp2_{k}", TP2) for k in ("cores", "left", "right"))
    assert np.isclose(_fidelity(got, want), 1.0, atol=1e-8)


def test_dmrg_uniform_tp_bond64_tp4_stores_a_quarter(world):
    _, ref, ranks = world
    assert np.isclose(float(_got(ranks, "tp4_e", TP4)), ref["tp4_e"], rtol=1e-10)
    assert np.isclose(float(_got(ranks, "tp1_e", TP1)), ref["tp4_e"], rtol=1e-10)
    # every stored environment (D, W, D / tp) and every Krylov basis
    # (iters + 1, d d D D / tp): a quarter of tp 1's along the ket bond
    env4, env1 = _got(ranks, "tp4_env", TP4), _got(ranks, "tp1_env", TP1)
    basis4, basis1 = _got(ranks, "tp4_basis", TP4), _got(ranks, "tp1_basis", TP1)
    assert {tuple(s) for s in env1} == {(64, 3, 64)}
    assert {tuple(s) for s in env4} == {(64, 3, 16)}
    assert {tuple(s) for s in basis1} == {(17, 2 * 2 * 64 * 64)}
    assert {tuple(s) for s in basis4} == {(17, 2 * 2 * 64 * 16)}


def test_dmrg_uniform_tp_validates_bond(world):
    from contractn_tpu.models import tfim_mpo as j_tfim
    from contractn_tpu.parallel import dmrg_uniform_tp as j_tp

    inp, _, ranks = world
    with pytest.raises(ValueError, match="divide") as err:
        j_tp(_jmesh({"tp": 2}, 2), j_tfim(4), _jarrays(inp, "bad"))
    assert str(_got(ranks, "msg_bond", TP2)) == str(err.value)


def test_dmrg_ensemble_sharded_matches_jax(world):
    _, ref, ranks = world
    want, e, tr = ref["ens"]
    np.testing.assert_allclose(_got(ranks, "ens_e", ENS), e, rtol=1e-12)
    np.testing.assert_allclose(_got(ranks, "ens_tr", ENS), tr, rtol=1e-12)
    got = tuple(_got(ranks, f"ens_{k}", ENS) for k in ("cores", "left", "right"))
    for i in range(len(HS)):
        fid = _fidelity(tuple(g[i] for g in got), tuple(w[i] for w in want))
        assert np.isclose(fid, 1.0, atol=1e-9), i


def test_dmrg_ensemble_sharded_validates_divisibility(world):
    from contractn_tpu.models import stack_pytrees as j_stack
    from contractn_tpu.models import tfim_mpo as j_tfim
    from contractn_tpu.parallel import dmrg_ensemble_sharded as j_ens

    inp, _, ranks = world
    arrays = tuple(inp[f"ens_{k}"][:3] for k in ("cores", "left", "right"))
    with pytest.raises(ValueError, match="divide") as err:
        j_ens(_jmesh({"dp": 4}, 4), j_stack([j_tfim(6, h=h) for h in HS[:3]]),
              _jmps(arrays), sweeps=1)
    assert str(_got(ranks, "msg_ens", ENS)) == str(err.value)


def test_ipeps_cell_scan_sharded_matches_jax(world):
    _, ref, ranks = world
    want = ref["scan"]
    np.testing.assert_allclose(_got(ranks, "scan_energy", SCAN_RANKS), want["energy"],
                               rtol=1e-10)
    np.testing.assert_allclose(_got(ranks, "scan_moments", SCAN_RANKS), want["moments"],
                               rtol=1e-8, atol=1e-10)
    for k in ("a", "b"):
        np.testing.assert_allclose(_got(ranks, f"scan_{k}", SCAN_RANKS), want[k],
                                   rtol=1e-8, atol=1e-10)

