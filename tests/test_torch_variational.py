"""Gradients through the CTMRG fixed point in the PyTorch port against JAX's
``value_and_grad`` and optax, on the CPU.

Both packages start from the same numpy parameters and the same environment
(the port's, carried across), so the energies and their gradients, which do
not depend on the decompositions' gauges, agree to 1e-10.  For complex
parameters torch's gradient of a real loss is the conjugate of JAX's (the
JAX package conjugates before optax; the port does not).  The written-out
Adam (``ops/optim.py``) is held to ``optax.adam`` on real and complex
tensors, and one descent step of each loss to JAX + optax.  The cell loss's
differentiated CTMRG (``svd_safe`` in the projectors) is held to central
differences of the same loss, in a complex direction.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

jv = import_module("contractn_tpu.models.variational")
jip = import_module("contractn_tpu.models.ipeps")
tv = import_module("contractn_tpu_torch.models.variational")
tip = import_module("contractn_tpu_torch.models.ipeps")
tct = import_module("contractn_tpu_torch.models.ctmrg")
tcc = import_module("contractn_tpu_torch.models.ctmrg_cell")
tic = import_module("contractn_tpu_torch.models.ipeps_cell")
optim = import_module("contractn_tpu_torch.ops.optim")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
CHI = 4
LR = 0.01
H2_TFIM = np.array(jip.tfim_bond_term_2d(1.0, 3.0))
H2_HEIS = np.array(jip.heisenberg_bond_term_2d())


def _params():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(2,) * 5)
    pa = rng.normal(size=(2,) * 5) + 1j * rng.normal(size=(2,) * 5)
    pb = rng.normal(size=(2,) * 5) + 0j
    return p, pa, pb


def _np_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return type(tree)(_np_tree(x) for x in tree)


def _envs():
    """The warm-start environments both packages get (the port's)."""
    p, pa, pb = _params()
    c, t = tct.ctmrg_environment(tip.peps_double_layer(tip.symmetrize_c4v(
        torch.from_numpy(p))), CHI, iters=3)
    env = tcc.ctmrg_cell(tic.checkerboard_cell(torch.from_numpy(pa), torch.from_numpy(pb)),
                         CHI, iters=3)
    return (c, t), env


def _optax_step(params, grads):
    import optax

    opt = optax.adam(LR)
    updates, _ = opt.update(grads, opt.init(params), params)
    return optax.apply_updates(params, updates)


@pytest.fixture(scope="module")
def ref():
    import jax

    p, pa, pb = _params()
    (c, t), env = _envs()
    loss = jv.make_ipeps_loss(H2_TFIM, CHI, refresh_iters=2, grad_iters=1)
    (e, _), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p, c.numpy(), t.numpy())
    closs = jv.make_cell_loss(H2_HEIS, CHI, refresh_iters=0, grad_iters=0)
    (ec, _), (ga, gb) = jax.jit(jax.value_and_grad(closs, argnums=(0, 1), has_aux=True))(
        pa, pb, _np_tree(env))
    # the JAX package's descent: optax on the CONJUGATED gradient
    step = jax.jit(_optax_step)(p, np.conj(np.asarray(g)))
    cstep = jax.jit(_optax_step)((pa, pb), (np.conj(np.asarray(ga)), np.conj(np.asarray(gb))))
    return {"e": float(e), "g": np.asarray(g), "ec": float(ec), "ga": np.asarray(ga),
            "gb": np.asarray(gb), "step": np.asarray(step),
            "cstep": tuple(np.asarray(x) for x in cstep)}


@pytest.fixture(scope="module")
def port():
    p, pa, pb = _params()
    (c, t), env = _envs()
    tp = torch.from_numpy(p).requires_grad_(True)
    e, _ = tv.make_ipeps_loss(torch.from_numpy(H2_TFIM), CHI, refresh_iters=2,
                              grad_iters=1)(tp, c, t)
    (g,) = torch.autograd.grad(e, tp)
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (pa, pb))
    ec, _ = tv.make_cell_loss(torch.from_numpy(H2_HEIS), CHI, refresh_iters=0,
                              grad_iters=0)(ta, tb, env)
    ga, gb = torch.autograd.grad(ec, (ta, tb))
    return e, g, ec, ga, gb


def test_losses_and_gradients_match_jax(ref, port):
    e, g, ec, ga, gb = port
    assert abs(float(e) - ref["e"]) < TOL
    np.testing.assert_allclose(g.numpy(), ref["g"], rtol=0, atol=TOL)
    assert abs(float(ec) - ref["ec"]) < TOL
    # torch's gradient of a real loss of complex parameters is conj(JAX's)
    np.testing.assert_allclose(ga.numpy(), np.conj(ref["ga"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(gb.numpy(), np.conj(ref["gb"]), rtol=0, atol=TOL)


def test_one_adam_step_matches_jax_and_optax(ref, port):
    """Real (C4v loss) and complex (cell loss): the port's Adam on torch's
    unconjugated gradient lands where optax does on JAX's conjugated one."""
    p, pa, pb = _params()
    _, g, _, ga, gb = port
    params = [torch.from_numpy(p)]
    optim.descend(optim.Adam(params, lr=LR), params, [g])
    np.testing.assert_allclose(params[0].numpy(), ref["step"], rtol=0, atol=TOL)
    params = [torch.from_numpy(pa), torch.from_numpy(pb)]
    optim.descend(optim.Adam(params, lr=LR), params, [ga, gb])
    for got, want in zip(params, ref["cstep"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_written_out_adam_matches_optax(dtype):
    import jax
    import optax

    rng = np.random.default_rng(3)

    def draw(shape):
        x = rng.normal(size=shape)
        return (x + 1j * rng.normal(size=shape)).astype(dtype) if dtype == np.complex128 else x

    params = [draw((3, 4)), draw((5,))]
    grads = [[draw((3, 4)), draw((5,))] for _ in range(4)]

    @jax.jit
    def descend(want, grads):
        opt = optax.adam(0.05)
        state = opt.init(want)
        for g in grads:
            updates, state = opt.update(g, state, want)
            want = optax.apply_updates(want, updates)
        return want

    want = descend(params, grads)
    got = [torch.from_numpy(x.copy()) for x in params]
    adam = optim.Adam(got, lr=0.05)
    for g in grads:
        optim.descend(adam, got, [torch.from_numpy(x) for x in g])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_cell_loss_gradient_through_the_ctmrg_matches_differences():
    """Fully differentiated (no untaped refresh): the svd_safe backward
    through one cell-CTMRG iteration equals central differences."""
    _, pa, pb = _params()
    _, env = _envs()
    loss = tv.make_cell_loss(torch.from_numpy(H2_HEIS), CHI, refresh_iters=0, grad_iters=1)
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (pa, pb))
    e, _ = loss(ta, tb, env)
    ga, gb = torch.autograd.grad(e, (ta, tb))
    rng = np.random.default_rng(4)
    da = torch.from_numpy(rng.normal(size=pa.shape) + 1j * rng.normal(size=pa.shape))
    db = torch.from_numpy(rng.normal(size=pb.shape) + 1j * rng.normal(size=pb.shape))
    h = 1e-5
    with torch.no_grad():
        fd = (float(loss(ta + h * da, tb + h * db, env)[0])
              - float(loss(ta - h * da, tb - h * db, env)[0])) / (2 * h)
    # the directional derivative is Re <grad, direction> in torch's convention
    dd = float(torch.real((ga.conj() * da).sum() + (gb.conj() * db).sum()))
    assert abs(dd - fd) < 1e-6 * max(1.0, abs(fd))
