"""The port's ``backend="tensorflow"`` bridge and ``jit=`` against the JAX
package, on the CPU.

Mirrors ``tests/test_interop.py``'s TF cases: a ``tf.GradientTape`` records
``contract(..., backend="tensorflow")``, plain and in split format, and the
port's TF gradients equal the JAX bridge's at 1e-10 in float64 (real and
complex operands).  Without tensorflow the backend raises ``TNError``.
"""

import sys

import numpy as np
import pytest
import torch

import contractn_tpu as jtn
import contractn_tpu_torch as ttn
from contractn_tpu_torch.compiler.interop import torch_contract

TOL = 1e-10


def _tape_grads(pkg, einstr, arrays, loss_fn, **kw):
    """(loss, gradients) of ``loss_fn(contract(...))`` under a tape."""
    tf = pytest.importorskip("tensorflow")
    xs = [tf.Variable(a) for a in arrays]
    with tf.GradientTape() as tape:
        out = pkg.contract(einstr, *xs, backend="tensorflow", **kw)
        loss = loss_fn(out)
    return np.asarray(loss), [np.asarray(g) for g in tape.gradient(loss, xs)]


def _both(einstr, arrays, loss_fn, **kw):
    return (_tape_grads(jtn, einstr, arrays, loss_fn, **kw),
            _tape_grads(ttn, einstr, arrays, loss_fn, device="cpu", **kw))


def _assert_same(ref, got):
    np.testing.assert_allclose(got[0], ref[0], rtol=TOL)
    for g_ref, g_got in zip(ref[1], got[1]):
        assert g_got.dtype == g_ref.dtype
        np.testing.assert_allclose(g_got, g_ref, rtol=TOL, atol=1e-12)


def test_tf_gradient_tape_matches_jax():
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(4, 5)), rng.normal(size=(5, 4))
    ref, got = _both("ab,ba->", [a, b], lambda y: y)
    _assert_same(ref, got)
    np.testing.assert_allclose(got[1][0], b.T, atol=1e-12)
    out = ttn.contract("ab,ba->", tf.constant(a), tf.constant(b),
                       backend="tensorflow", device="cpu")
    assert isinstance(out, tf.Tensor)


def test_tf_split_format_tape_matches_jax():
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(5)
    mats = [rng.normal(size=(3, 3)) * 2.0 for _ in range(4)]
    einstr = "ab,bc,cd,da->"
    ref, got = _both(einstr, mats, lambda mc: mc[0] * tf.exp(mc[1]),
                     split_format=True)
    _assert_same(ref, got)
    # the split pair's gradients are the plain contraction's
    _, plain = _tape_grads(ttn, einstr, mats, lambda y: y, device="cpu")
    for g1, g2 in zip(got[1], plain):
        np.testing.assert_allclose(g1, g2, rtol=TOL, atol=1e-12)


def test_tf_complex_gradients_match_jax():
    """Complex operands: the TF cotangent is pulled back as the JAX bridge
    pulls it back, for a real loss that mixes |y|^2 and Im y."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(6)
    z1 = rng.normal(size=(3, 4)) + 1j * rng.normal(size=(3, 4))
    z2 = rng.normal(size=(4, 3)) + 1j * rng.normal(size=(4, 3))

    def loss(y):
        return (tf.reduce_sum(tf.math.real(y * tf.math.conj(y)))
                + tf.reduce_sum(tf.math.imag(y)))

    ref, got = _both("ab,bc->ac", [z1, z2], loss)
    _assert_same(ref, got)


def test_tn_contract_tensorflow_backend_matches_jax():
    tf = pytest.importorskip("tensorflow")
    outs = []
    for pkg, kw in ((jtn, {}), (ttn, {"device": "cpu"})):
        tn = pkg.TN()
        a = tn.add_dense_node(np.ones((2, 2)))
        b = tn.add_dense_node(np.ones(2))
        tn.connect_nodes(a, b, 1, 0)
        out = tn.contract(backend="tensorflow", **kw)
        assert isinstance(out, tf.Tensor)
        outs.append(np.asarray(out))
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL)
    np.testing.assert_allclose(outs[1], [2.0, 2.0], rtol=TOL)


def test_tensorflow_backend_without_tensorflow_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # import fails
    with pytest.raises(ttn.TNError, match="tensorflow is not installed"):
        ttn.contract("ab,b->a", np.ones((2, 2)), np.ones(2),
                     backend="tensorflow", device="cpu")
    tn = ttn.TN()
    a = tn.add_dense_node(np.ones((2, 2)))
    b = tn.add_dense_node(np.ones(2))
    tn.connect_nodes(a, b, 1, 0)
    with pytest.raises(ttn.TNError, match="tensorflow is not installed"):
        tn.contract(backend="tensorflow", device="cpu")


def test_jit_flag_is_accepted_and_torch_contract_keeps_autograd():
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(3, 4)), rng.normal(size=(4, 2))
    want = np.asarray(jtn.contract("ab,bc->ac", a, b, jit=False))
    for jit in (False, True):
        got = ttn.contract("ab,bc->ac", a, b, jit=jit, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL)
    ta = torch.tensor(a, requires_grad=True)
    out = torch_contract("ab,bc->ac", (ta, b), None, "auto", None, False)
    out.sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.tile(b.sum(1), (3, 1)), rtol=TOL)
