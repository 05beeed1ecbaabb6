"""Training paths of the PyTorch port against the JAX package, on the CPU.

The same numpy-seeded float64 inputs go through both packages: MPS
``from_dense`` and ``site_expectations``, the log-MSE SGD step at even and
odd chain lengths, the optimizer-driven step, and ``fit_tn`` on the CP case
(torch Adam against optax Adam).  Tolerance 1e-10 unless a test says
otherwise.

Also the repair of the chain kernel's routing: ``MPS.evaluate(kernel=
"auto")`` takes the differentiable loop whenever autograd records (its
gradient matches ``jax.grad``), and every explicit kernel entry point raises
``TNError`` under recording autograd, here as on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from contractn_tpu import TN as JTN
from contractn_tpu.models import MPS as JMPS
from contractn_tpu.parallel import fit_tn as j_fit_tn
from contractn_tpu.parallel import make_optax_train_step as j_optax_step
from contractn_tpu.parallel import make_train_step as j_make_train_step
from contractn_tpu_torch import TN, TNError
from contractn_tpu_torch.convert import mps_from_numpy, mps_to_numpy
from contractn_tpu_torch.models import MPS, tfim_mpo
from contractn_tpu_torch.ops import cuda_epilogue, cuda_mpo, cuda_mps
from contractn_tpu_torch.parallel import (
    fit_tn,
    loss_fn,
    make_optax_train_step,
    make_train_step,
    sgd_init,
)

torch.set_num_threads(1)

RTOL = 1e-10


def _arrays(n=6, d=2, bond=4, batch=5, seed=0):
    rng = np.random.default_rng(seed)
    cores = rng.standard_normal((n, d, bond, bond)) / np.sqrt(d * bond)
    left, right = rng.standard_normal(bond), rng.standard_normal(bond)
    x = rng.standard_normal((batch, n, d))
    y = rng.standard_normal(batch)
    return cores, left, right, x, y


def _dense(cores, left, right):
    """The full amplitude vector of a uniform MPS (row-major configs)."""
    bond = cores.shape[-1]
    amp = np.asarray(left)[None]
    for core in cores:
        amp = np.einsum("cj,djk->cdk", amp, core).reshape(-1, bond)
    return amp @ np.asarray(right)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("max_bond,cutoff", [(None, 0.0), (3, 0.0), (None, 0.2)])
def test_from_dense_matches_jax(max_bond, cutoff):
    # the truncated state is gauge-invariant (distinct singular values):
    # compare dense vectors, not cores, since SVD signs differ
    vec = np.random.default_rng(1).standard_normal(2 ** 5)
    mj = JMPS.from_dense(jnp.asarray(vec), 2, max_bond=max_bond, cutoff=cutoff)
    mt = MPS.from_dense(vec, 2, max_bond=max_bond, cutoff=cutoff, device="cpu")
    assert mt.cores.shape == mj.cores.shape and mt.cores.dtype == torch.float64
    np.testing.assert_allclose(_dense(*mps_to_numpy(mt)),
                               _dense(*(np.asarray(a) for a in (mj.cores, mj.left, mj.right))),
                               rtol=RTOL, atol=RTOL)
    if max_bond is None and cutoff == 0.0:
        np.testing.assert_allclose(_dense(*mps_to_numpy(mt)), vec, rtol=RTOL, atol=RTOL)
    with pytest.raises(ValueError):
        MPS.from_dense(np.ones(10), 2, device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_site_expectations_match_jax(dtype):
    cores, left, right, _, _ = _arrays(n=7, seed=2)
    sz = np.diag([1.0, -1.0])
    if dtype == np.complex128:
        rng = np.random.default_rng(3)
        cores = cores + 1j * rng.standard_normal(cores.shape) / 3
        left, right = left + 0.5j, right - 0.25j
        sz = np.array([[0, -1j], [1j, 0]])  # sigma_y
    mj = JMPS(*(jnp.asarray(a) for a in (cores, left, right)))
    mt = mps_from_numpy(cores, left, right, device="cpu")
    got = mt.site_expectations(sz)
    assert got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), np.asarray(mj.site_expectations(jnp.asarray(sz))),
                               rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("n", [6, 5])  # two sites a step, and one
def test_sgd_steps_match_jax(n):
    cores, left, right, x, y = _arrays(n=n, seed=4)
    mj = JMPS(*(jnp.asarray(a) for a in (cores, left, right)))
    mt = mps_from_numpy(cores, left, right, device="cpu")
    step_j, step_t = j_make_train_step(lr=0.05), make_train_step(lr=0.05)
    for _ in range(3):
        mj, lj = step_j(mj, jnp.asarray(x), jnp.asarray(y))
        mt, lt = step_t(mt, _t(x), _t(y))
        np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    for got, want in zip(mps_to_numpy(mt), (mj.cores, mj.left, mj.right)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-12)
    assert not mt.cores.requires_grad and sgd_init(0.1) == {"lr": 0.1}


def test_optimizer_step_matches_optax_adam():
    cores, left, right, x, y = _arrays(n=6, seed=5)
    step_j, init_j = j_optax_step(optax.adam(1e-2))
    mj = JMPS(*(jnp.asarray(a) for a in (cores, left, right)))
    state_j = init_j(mj)
    step_t, init_t = make_optax_train_step(lambda p: torch.optim.Adam(p, lr=1e-2))
    mt = mps_from_numpy(cores, left, right, device="cpu")
    state_t = init_t(mt)
    before = mt.cores.clone()
    for _ in range(3):
        mj, state_j, lj = step_j(mj, state_j, jnp.asarray(x), jnp.asarray(y))
        mt, state_t, lt = step_t(mt, state_t, _t(x), _t(y))
        np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    for got, want in zip(mps_to_numpy(mt), (mj.cores, mj.left, mj.right)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-12)
    assert torch.equal(mps_from_numpy(cores, left, right, device="cpu").cores, before)
    with pytest.raises(ValueError, match="custom loss is not supported with mesh="):
        make_optax_train_step(lambda p: torch.optim.Adam(p), mesh=object(), loss=loss_fn)


def _cp_network(pkg, rng):
    tn = pkg()
    hub = tn.add_copy_node(3, dim=3)
    for i in range(3):
        tn.connect_nodes(hub, tn.add_dense_node(0.3 * rng.standard_normal((3, 4))), i, 0)
    return tn


def test_fit_tn_cp_matches_optax():
    rng = np.random.default_rng(0)
    f1, f2, f3 = (rng.standard_normal((2, 4)) for _ in range(3))
    target = np.einsum("ra,rb,rc->abc", f1, f2, f3)
    tj = _cp_network(JTN, np.random.default_rng(7))
    tt = _cp_network(TN, np.random.default_rng(7))

    def loss_j(out, target):
        mant, log = out
        return jnp.mean((mant * jnp.exp(log) - target) ** 2)

    def loss_t(out, target):
        mant, log = out
        return torch.mean((mant * torch.exp(log) - target) ** 2)

    trace_j = j_fit_tn(tj, optax.adam(0.05), loss_j, steps=25, batch=(jnp.asarray(target),))
    trace_t = fit_tn(tt, lambda p: torch.optim.Adam(p, lr=0.05), loss_t, steps=25,
                     batch=(_t(target),), device="cpu")
    np.testing.assert_allclose(trace_t, trace_j, rtol=RTOL)
    assert trace_t[-1] < 0.5 * trace_t[0]
    # the trained tensors are written back into the graph, on their device
    for pj, pt in zip(tj.params, tt.params):
        assert isinstance(pt, torch.Tensor) and pt.device.type == "cpu"
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(tt.contract(device="cpu").numpy(),
                               np.asarray(tj.contract()), rtol=RTOL, atol=1e-12)


# ---------------------------------------------------------------- the repair


def test_auto_gradient_matches_jax_grad():
    # the case that lost its gradient on the card: log|psi| through "auto"
    cores, left, right, x, _ = _arrays(n=7, seed=6)

    def j_obj(c, lv, rv):
        return jnp.sum(JMPS(c, lv, rv).log_abs_amplitude(jnp.asarray(x)))

    gj = jax.grad(j_obj, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (cores, left, right)))
    params = [_t(a).requires_grad_(True) for a in (cores, left, right)]
    val = MPS(*params).log_abs_amplitude(_t(x)).sum()
    assert val.grad_fn is not None
    for got, want in zip(torch.autograd.grad(val, params), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)


def test_auto_routes_to_the_loop_when_autograd_records(monkeypatch):
    cores, left, right, x, _ = _arrays(n=4, seed=7)
    mps = mps_from_numpy(cores, left, right, device="cpu")
    xt = _t(x)
    assert mps._path(xt, "auto", 1, None, 1) == "auto"  # CPU: no kernel
    # as on a GPU, where the kernel takes the call: the grad clause decides
    monkeypatch.setattr(MPS, "_kernel_eligible", lambda self, *a: True)
    assert mps._path(xt, "auto", 1, None, 1) == "cuda"
    graded = MPS(mps.cores.clone().requires_grad_(True), mps.left, mps.right)
    assert graded._path(xt, "auto", 1, None, 1) == "auto"
    assert mps._path(xt.clone().requires_grad_(True), "auto", 1, None, 1) == "auto"
    with torch.no_grad():
        assert graded._path(xt, "auto", 1, None, 1) == "cuda"
    assert graded._path(xt, "scan", 1, None, 1) == "scan"
    assert graded._path(xt, "cuda", 1, None, 1) == "cuda"  # asked for: raises later
    with pytest.raises(TNError, match="Unknown kernel"):
        mps._path(xt, "pallas", 1, None, 1)


def test_kernel_entry_points_refuse_recording_autograd():
    f32 = np.float32
    cores, left, right, x, _ = (a.astype(f32) for a in _arrays(n=4, bond=8, seed=8))
    c, lv, rv, xt = (_t(a) for a in (cores, left, right, x))
    mcores = _t(np.random.default_rng(9).standard_normal((3, 4, 2, 8, 8)).astype(f32))
    mpo = tfim_mpo(4, dtype=torch.float32, device="cpu")
    ones = torch.ones(8)
    env0 = torch.zeros(3 * 8, 8)
    calls = {
        "cuda_mps_evaluate": lambda c, lv, rv, xt, m: cuda_mps.cuda_mps_evaluate(c, lv, rv, xt),
        "MPS.evaluate(kernel='cuda')": lambda c, lv, rv, xt, m: MPS(c, lv, rv).evaluate(
            xt, kernel="cuda"),
        "epilogue_chain": lambda c, lv, rv, xt, m: cuda_epilogue.epilogue_chain(c, lv, xt),
        "mps_evaluate_epilogue": lambda c, lv, rv, xt, m: cuda_epilogue.mps_evaluate_epilogue(
            c, lv, rv, xt),
        "mpo_env": lambda c, lv, rv, xt, m: cuda_mpo.mpo_env(m, env0, (), 3),
        "mpo_expectation_cuda": lambda c, lv, rv, xt, m: cuda_mpo.mpo_expectation_cuda(
            mpo, m, ones, ones),
    }
    for name, call in calls.items():
        for i in range(5):  # each operand in turn requires grad
            args = [c, lv, rv, xt, mcores]
            args[i] = args[i].clone().requires_grad_(True)
            uses = {"epilogue_chain": (0, 1, 3), "mpo_env": (4,),
                    "mpo_expectation_cuda": (4,)}.get(name, (0, 1, 2, 3))
            if i in uses:
                with pytest.raises(TNError, match="no_grad"):
                    call(*args)
            with torch.no_grad():
                out = call(*args)
            assert not out[0].requires_grad, name
    # the MPO's own core enters the kernel as constants: refused as well
    graded = tfim_mpo(4, dtype=torch.float32, device="cpu")
    graded.cores.requires_grad_(True)
    with pytest.raises(TNError, match="no_grad"):
        cuda_mpo.mpo_expectation_cuda(graded, mcores, ones, ones)


def test_chip_smoke_training_rehearsal_on_cpu():
    # the training phase at a tiny size: on the CPU nothing is launched, and
    # every check of the phase (gradient, NLL, sampler, fit) runs
    runs = chip_smoke.training_paths(
        torch.device("cpu"), "cpu",
        train={"n_sites": 12, "phys": 2, "bond": 4, "batch": 8, "steps": 2, "lr": 1e-3},
        odd_sites=11, born={"n_sites": 6, "bond": 4, "batch": 64, "steps": 10, "lr": 1e-2},
        fit_steps=10, check=4)
    assert set(runs) == {"train_bf16", "train_fp32", "serve_trained", "train_odd",
                         "born_fit", "born_step", "sample", "fit_tn"}
    for counts, _ in runs.values():
        assert set(counts.values()) == {0}
    assert loss_fn  # the loss the phase trains is the package's
