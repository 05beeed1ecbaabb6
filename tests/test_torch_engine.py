"""Contraction engine of the PyTorch port against the JAX package.

Same numpy inputs (seeded) through ``contractn_tpu.contract`` and
``contractn_tpu_torch.contract(..., device="cpu")`` in float64; split-format
results compare as ``mantissa * exp(log)`` to 1e-10 relative (the JAX
suite's CPU x64 oracle tolerance).
"""

import numpy as np
import pytest
import torch

import contractn_tpu as jtn
import contractn_tpu_torch as ttn

torch.set_num_threads(1)

RTOL = 1e-10


def _recombined(mant, log):
    return np.asarray(mant, np.float64) * np.exp(np.asarray(log, np.float64))


def _both(einstr, *arrays, **kwargs):
    mj, lj = jtn.contract(einstr, *arrays, split_format=True, **kwargs)
    mt, lt = ttn.contract(einstr, *arrays, split_format=True, device="cpu", **kwargs)
    assert isinstance(mt, torch.Tensor) and mt.dtype == torch.float64
    return _recombined(mj, lj), _recombined(mt, lt), (mt, lt)


def _operands(einstr, dims, seed):
    rng = np.random.default_rng(seed)
    terms = einstr.split("->")[0].split(",")
    return [rng.standard_normal([dims[s] for s in t]) for t in terms]


CASES = [
    ("ab,bc->ac", {"a": 3, "b": 4, "c": 5}),
    ("abc,cd,dbe->ae", {"a": 2, "b": 3, "c": 4, "d": 5, "e": 2}),
    ("ab,bc,cd,da->", {"a": 3, "b": 4, "c": 2, "d": 3}),  # small ring
    ("ab,ab,ab->ab", {"a": 3, "b": 4}),  # Hadamard of identical sets
    ("ab,bc,ac->b", {"a": 3, "b": 4, "c": 2}),  # hyperedge kept in output
    ("a,ab,b->bb", {"a": 3, "b": 4}),  # repeated output: diagonal embed
    ("aab,bc->c", {"a": 3, "b": 2, "c": 4}),  # trace inside an operand
    ("ab,cd->abcd", {"a": 2, "b": 3, "c": 2, "d": 2}),  # outer product
    ("a,a,a,a->", {"a": 5}),  # pure hyperedge summed out
]


@pytest.mark.parametrize("einstr,dims", CASES)
def test_contract_matches_jax(einstr, dims):
    ops = _operands(einstr, dims, seed=len(einstr))
    ref, got, _ = _both(einstr, *ops)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-13)
    # and the numpy oracles agree with each other too
    mn, ln = ttn.contract(einstr, *ops, split_format=True, backend="numpy")
    np.testing.assert_allclose(_recombined(mn, ln), ref, rtol=RTOL, atol=1e-13)


@pytest.mark.parametrize("kind", ["chain", "ring", "hadamard", "hadamard_sum"])
def test_structure_routes_match_jax(kind):
    rng = np.random.default_rng(7)
    n, d = 40, 3
    if kind == "chain":
        # v M M ... M as the graph layer orients it
        mats = rng.standard_normal((n, d, d))
        tj, tt = jtn.TN(), ttn.TN()
        for tn in (tj, tt):
            prev = tn.add_dense_node(np.ones(d))
            for m in mats:
                node = tn.add_dense_node(m)
                tn.connect_nodes(prev, node, -1, 0)
                prev = node
        mj, lj = tj.contract(split_format=True)
        mt, lt = tt.contract(split_format=True, device="cpu")
        np.testing.assert_allclose(_recombined(mt, lt), _recombined(mj, lj), rtol=RTOL)
        return
    from contractn_tpu_torch.symbols import get_symbol

    if kind == "ring":
        terms = [get_symbol(i) + get_symbol((i + 1) % n) for i in range(n)]
        einstr = ",".join(terms) + "->"
        ops = list(rng.standard_normal((n, d, d)) / np.sqrt(d))
    else:
        einstr = ",".join(["a"] * n) + ("->" if kind == "hadamard_sum" else "->a")
        ops = list(rng.uniform(0.5, 1.5, (n, d)))
    ref, got, _ = _both(einstr, *ops)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_readme_examples_match_jax():
    rng = np.random.default_rng(1)
    vecs = rng.uniform(0.5, 1.0, (100, 2))
    out = []
    for pkg, kw in ((jtn, {}), (ttn, {"device": "cpu"})):
        tn = pkg.TN()
        hub = tn.add_copy_node(101)
        for i in range(100):
            tn.connect_nodes(hub, tn.add_dense_node(vecs[i]), i, 0)
        out.append(np.asarray(tn.contract(**kw)))
    np.testing.assert_allclose(out[1], out[0], rtol=RTOL)

    tn = ttn.TN()
    hub = tn.add_copy_node(101)
    for i in range(100):
        tn.connect_nodes(hub, tn.add_dense_node(np.array([1, 0.99])), i, 0)
    np.testing.assert_allclose(tn.contract(device="cpu").numpy(), [1.0, 0.99 ** 100],
                               rtol=RTOL)


def test_many_symbols_are_remapped_per_step():
    # a 60-node chain of distinct shapes: no structure route, > 52 symbols
    rng = np.random.default_rng(3)
    dims = [2 + (i % 3) for i in range(61)]
    mats = [rng.standard_normal((dims[i], dims[i + 1])) * 0.7 for i in range(60)]
    tj, tt = jtn.TN(), ttn.TN()
    for tn in (tj, tt):
        prev = None
        for m in mats:
            node = tn.add_dense_node(m)
            if prev is not None:
                tn.connect_nodes(prev, node, -1, 0)
            prev = node
    assert tt.einsum_str == tj.einsum_str
    assert len(set(tt.einsum_str) - set(",->")) > 52
    mj, lj = tj.contract(split_format=True)
    mt, lt = tt.contract(split_format=True, device="cpu")
    np.testing.assert_allclose(_recombined(mt, lt), _recombined(mj, lj), rtol=RTOL)


def test_explicit_path_and_strategies():
    ops = _operands("ab,bc,cd->ad", {"a": 2, "b": 3, "c": 4, "d": 2}, seed=5)
    ref, got, _ = _both("ab,bc,cd->ad", *ops, optimize=[(1, 2), (0, 1)])
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    got_g = ttn.contract("ab,bc,cd->ad", *ops, optimize="greedy", device="cpu")
    np.testing.assert_allclose(got_g.numpy(), ref, rtol=RTOL)
    got_o = ttn.contract("ab,bc,cd->ad", *ops, optimize="optimal", device="cpu")
    ref_o = jtn.contract("ab,bc,cd->ad", *ops, optimize="optimal")
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), rtol=RTOL)
    got_r = ttn.contract("ab,bc,cd->ad", *ops, optimize="random-greedy", device="cpu")
    ref_r = jtn.contract("ab,bc,cd->ad", *ops, optimize="random-greedy")
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), rtol=RTOL)
    with pytest.raises(ttn.TNError):
        ttn.contract("ab,bc,cd->ad", *ops, optimize=[(0, 1)], device="cpu")


def test_validation_errors():
    with pytest.raises(ttn.TNError):
        ttn.contract("ab,bc->ac", np.ones((2, 3)), device="cpu")
    with pytest.raises(ttn.TNError):
        ttn.contract("ab,bc->ac", np.ones((2, 3)), np.ones((4, 2)), device="cpu")
    with pytest.raises(TypeError):
        ttn.contract("ab->a", np.ones((2, 3)), device="cpu", bogus=1)


def test_torch_operands_keep_autograd():
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.standard_normal((3, 4)), requires_grad=True)
    b = torch.tensor(rng.standard_normal((4, 2)), requires_grad=True)
    out = ttn.contract("ab,bc->ac", a, b)
    out.sum().backward()
    want = np.tile(b.detach().numpy().sum(1), (3, 1))
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=1e-12)
    mant, log = ttn.contract("ab,bc->", a, b, split_format=True)
    assert mant.requires_grad and log.requires_grad


def test_clones_and_inputs_through_the_graph_match_jax():
    rng = np.random.default_rng(13)
    core = rng.standard_normal((3, 4, 3))
    vec = rng.standard_normal(3)
    inp = rng.standard_normal((4,))
    results = []
    for pkg, kw in ((jtn, {}), (ttn, {"device": "cpu"})):
        tn = pkg.TN()
        a = tn.add_dense_node(core)
        b = tn.add_duplicate_node(a)  # shares a's parameter slot
        v = tn.add_dense_node(vec)
        x1 = tn.add_input_node((4,))
        x2 = tn.add_input_node((4,))
        tn.connect_nodes(a, b, 2, 0)
        tn.connect_nodes(v, a, 0, 0)
        tn.connect_nodes(a, x1, 1, 0)
        tn.connect_nodes(b, x2, 1, 0)
        fun = tn.make_contract_fun(split_format=True, **kw)
        results.append((tn.einsum_str, _recombined(*fun(tn.params, (inp, 2 * inp)))))
    assert results[0][0] == results[1][0]
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=RTOL)
