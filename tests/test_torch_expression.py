"""Engine remainder of the PyTorch port against the JAX package: bucketed
lowering, native path search, introspection, compiled expressions,
checkpoints, graph inspection and the decomposition layouts.

Same numpy inputs (seeded) through both packages (the port with
``device="cpu"``), float64, tolerance 1e-10.  Lowering is held against the
``backend="numpy"`` oracle; its plan structure is held against the JAX
package's only on an explicit path, where the steps are identical.
"""

import sys

import numpy as np
import pytest
import torch

import contractn_tpu as jtn
import contractn_tpu_torch as ttn
from contractn_tpu.compiler.engine import _find_steps
from contractn_tpu.compiler.lowering import plan_program as jax_plan_program
from contractn_tpu_torch.compiler import engine
from contractn_tpu_torch.symbols import get_symbol

torch.set_num_threads(1)

TOL = 1e-10


def _chain(n, dims, seed):
    rng = np.random.default_rng(seed)
    mats = [rng.standard_normal((dims[i], dims[i + 1])) * 0.5
            for i in range(n)]
    terms = [get_symbol(i) + get_symbol(i + 1) for i in range(n)]
    return ",".join(terms) + "->" + get_symbol(0) + get_symbol(n), mats


def _value(pair):
    m, log = (np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                         else x) for x in pair)
    return m * np.exp(log)


def _kinds(plan):
    return [(item["kind"], len(item.get("out_ids", item.get("xs_ids", ()))))
            for item in plan]


def test_lowering_plan_matches_jax_on_explicit_path():
    einstr, mats = _chain(60, [5] * 61, seed=3)
    shapes = tuple(m.shape for m in mats)
    steps = _find_steps(einstr, shapes, "greedy", None)
    path = [inds for inds, _ in steps]
    plan = engine._plan(einstr, shapes, engine._freeze(path), None)
    jplan, jresult = jax_plan_program(steps, len(mats), shapes)
    assert plan.buckets is not None
    assert _kinds(plan.buckets.plan) == _kinds(jplan)
    assert plan.buckets.result_id == jresult
    kinds = {k for k, _ in _kinds(jplan)}
    assert {"batch", "scan"} <= kinds and len(jplan) < 10

    got = ttn.contract(einstr, *mats, split_format=True, optimize=path,
                       device="cpu")
    oracle = ttn.contract(einstr, *mats, split_format=True, optimize=path,
                          backend="numpy")
    want = jtn.contract(einstr, *mats, split_format=True, optimize=path)
    np.testing.assert_allclose(_value(got), _value(oracle), rtol=TOL)
    np.testing.assert_allclose(_value(got), _value(want), rtol=TOL)


def test_lowering_mixed_dims_matches_oracle():
    n = 48
    dims = [3 if (i // 12) % 2 == 0 else 5 for i in range(n + 1)]
    einstr, mats = _chain(n, dims, seed=4)
    assert engine._plan(einstr, tuple(m.shape for m in mats), "auto",
                        None).buckets is not None
    got = ttn.contract(einstr, *mats, split_format=True, device="cpu")
    oracle = ttn.contract(einstr, *mats, split_format=True, backend="numpy")
    np.testing.assert_allclose(_value(got), _value(oracle), rtol=TOL)
    np.testing.assert_allclose(float(got[1]), float(oracle[1]), rtol=1e-12)


def test_lowering_gradients_flow_through_buckets():
    einstr, mats = _chain(24, [3] * 25, seed=5)
    shapes = tuple(m.shape for m in mats)
    path = [inds for inds, _ in _find_steps(einstr, shapes, "greedy", None)]
    assert engine._plan(einstr, shapes, engine._freeze(path),
                        None).buckets is not None
    m0 = torch.tensor(mats[0], requires_grad=True)
    val, log = ttn.contract(einstr, m0, *mats[1:], split_format=True,
                            optimize=path, device="cpu")
    (torch.sum(val ** 2) + log).backward()

    import jax
    import jax.numpy as jnp

    def loss(x):
        v, lg = jtn.contract(einstr, x, *mats[1:], split_format=True,
                             optimize=path)
        return jnp.sum(v ** 2) + lg

    want = np.asarray(jax.grad(loss)(jnp.asarray(mats[0])))
    np.testing.assert_allclose(m0.grad.numpy(), want, rtol=1e-9, atol=1e-12)


NATIVE_CASES = [
    (["ab", "bc", "cd"], "ad", 8),
    (["ab", "bc", "cd", "de", "ef", "fg"], "ag", 4),
    (["ax", "ay", "az", "w"], "xyzw", 3),
    ([get_symbol(0)] + [get_symbol(i) + get_symbol(i + 1) for i in range(200)],
     get_symbol(200), 32),
]


@pytest.mark.parametrize("terms,output,dim", NATIVE_CASES)
def test_native_greedy_paths_match_jax(terms, output, dim):
    from contractn_tpu.native import greedy_path as jax_greedy
    from contractn_tpu.native import native_available as jax_available
    from contractn_tpu_torch.native import greedy_path, native_available

    if not jax_available():
        pytest.skip("the JAX package's native optimizer cannot be built here")
    assert native_available()
    sizes = {s: dim for s in "".join(terms) + output}
    assert greedy_path(terms, output, sizes) == jax_greedy(terms, output,
                                                           sizes)


def test_native_greedy_contraction_matches_jax():
    from contractn_tpu.models.peps import peps_tn as jax_peps

    tn_j, _ = jax_peps(2, 3, bond_dim=3, rng=np.random.default_rng(0))
    tn_t = ttn.TN()
    for node in tn_j.nodes():
        tn_t.add_dense_node(np.asarray(node.tensor), name=node.name)
    for edge in tn_j.edges():
        if not edge.dangler:
            n1, n2 = edge.nodes
            tn_t.connect_nodes(n1.name, n2.name, n1.index(edge),
                               n2.index(edge))
    assert tn_t.einsum_str == tn_j.einsum_str
    want = np.asarray(tn_j.contract(backend="numpy",
                                    optimize="native-greedy"))
    got = tn_t.contract(optimize="native-greedy", device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-12)
    info_t = tn_t.contraction_info(optimize="native-greedy")
    info_j = tn_j.contraction_info(optimize="native-greedy")
    assert info_t.path == [tuple(p) for p in info_j.path]


def test_native_greedy_raises_when_unavailable(monkeypatch):
    from contractn_tpu_torch import native

    monkeypatch.setattr(native, "_state",
                        {"lib": None, "error": "no compiler", "build_ms": 0.0})
    assert not native.native_available()
    with pytest.raises(ttn.TNError, match="native-greedy"):
        ttn.contract("abc,bcd,dea->e", np.ones((2, 3, 4)), np.ones((3, 4, 5)),
                     np.ones((5, 6, 2)), optimize="native-greedy",
                     device="cpu")
    # the random-greedy family needs no native library
    rng = np.random.default_rng(6)
    ops = [rng.standard_normal(s) for s in ((2, 3), (3, 4), (4, 2))]
    got = ttn.contract("ab,bc,cd->ad", *ops, optimize="random-greedy", device="cpu")
    want = jtn.contract("ab,bc,cd->ad", *ops, optimize="random-greedy")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)


def _grid_tn(mod, seed=2):
    rng = np.random.default_rng(seed)
    tn = mod.TN()
    shapes = [(2, 3, 4), (3, 5, 2), (4, 6), (5, 6, 3)]
    for i, s in enumerate(shapes):
        tn.add_dense_node(rng.standard_normal(s), name=f"t{i}")
    tn.connect_nodes("t0", "t1", 1, 0)
    tn.connect_nodes("t0", "t2", 2, 0)
    tn.connect_nodes("t1", "t3", 1, 0)
    tn.connect_nodes("t2", "t3", 1, 1)
    return tn


def test_contraction_info_matches_jax_on_explicit_path():
    tn_j, tn_t = _grid_tn(jtn), _grid_tn(ttn)
    path = [(0, 1), (0, 2), (0, 1)]
    info_j = tn_j.contraction_info(optimize=path)
    info_t = tn_t.contraction_info(optimize=path)
    assert info_t.einsum_str == info_j.einsum_str
    assert info_t.path == [tuple(p) for p in info_j.path]
    assert info_t.flops == info_j.flops
    assert info_t.largest_intermediate == info_j.largest_intermediate
    assert info_t.speedup_vs_naive == pytest.approx(info_j.speedup_vs_naive,
                                                    rel=1e-12)
    assert "estimated FLOPs" in str(info_t)


def test_contract_expression_reuse_and_validation():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((3, 4)), rng.standard_normal((4, 5))
    expr = ttn.contract_expression("ab,bc->ac", (3, 4), (4, 5), device="cpu")
    for _ in range(2):
        np.testing.assert_allclose(expr(a, b).numpy(), a @ b, rtol=TOL)
    assert expr.einsum_str == "ab,bc->ac" and expr.shapes == ((3, 4), (4, 5))
    with pytest.raises(ValueError):
        expr(a.T, b)


def test_tn_compile():
    tn_t, tn_j = _grid_tn(ttn), _grid_tn(jtn)
    compiled = tn_t.compile(split_format=True, device="cpu")
    got = _value(compiled())
    np.testing.assert_allclose(got, _value(tn_j.contract(split_format=True)),
                               rtol=TOL)
    np.testing.assert_allclose(_value(compiled(tn_t.params)), got, rtol=TOL)
    assert compiled.einsum_str == tn_j.einsum_str
    assert compiled.info().flops == tn_t.contraction_info().flops
    stats = compiled.measure_compile()
    assert stats is compiled.stats and stats.total_ms >= stats.lower_ms > 0
    assert stats.compile_ms == 0.0 and stats.flops_estimate > 0
    assert "CompiledContraction" in repr(compiled)


def _mixed_tn(mod):
    rng = np.random.default_rng(9)
    tn = mod.TN()
    a = tn.add_dense_node(rng.standard_normal((3, 4)), name="a")
    tn.add_duplicate_node(a, name="a_twin")
    hub = tn.add_copy_node(3, dim=4, name="hub")
    b = tn.add_dense_node(rng.standard_normal((4, 2)), name="b")
    tn.connect_nodes(hub, "a", 0, 1)
    tn.connect_nodes(hub, "a_twin", 1, 1)
    tn.connect_nodes(hub, b, 2, 0)
    return tn


def test_checkpoints_cross_load(tmp_path):
    from contractn_tpu.utils.checkpoint import load_tn as jax_load
    from contractn_tpu.utils.checkpoint import save_tn as jax_save
    from contractn_tpu_torch.utils.checkpoint import load_tn, save_tn, tn_spec

    tn_j, tn_t = _mixed_tn(jtn), _mixed_tn(ttn)
    jax_save(tmp_path / "from_jax.npz", tn_j)
    got = load_tn(tmp_path / "from_jax.npz", device="cpu")
    assert got.einsum_str == tn_j.einsum_str
    assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
               for p in got.params)
    np.testing.assert_allclose(got.contract(device="cpu").numpy(),
                               np.asarray(tn_j.contract()), rtol=TOL)

    save_tn(tmp_path / "from_torch.npz", tn_t)
    back = jax_load(tmp_path / "from_torch.npz")
    assert back.einsum_str == tn_t.einsum_str == tn_j.einsum_str
    np.testing.assert_allclose(np.asarray(back.contract()),
                               tn_t.contract(device="cpu").numpy(), rtol=TOL)
    assert tn_spec(got) == tn_spec(tn_t)


def test_graph_inspection_matches_jax(monkeypatch):
    tn_j, tn_t = _mixed_tn(jtn), _mixed_tn(ttn)
    tn_t.add_input_node((4,), name="feed")
    tn_j.add_input_node((4,), name="feed")
    assert tn_t.to_dot() == tn_j.to_dot()
    assert tn_t.to_dot(max_nodes=3) == tn_j.to_dot(max_nodes=3)
    assert tn_t.draw() == tn_j.draw()
    assert tn_t.draw(max_nodes=2) == tn_j.draw(max_nodes=2)
    g_t, g_j = tn_t.to_networkx(), tn_j.to_networkx()
    assert dict(g_t.nodes(data=True)) == dict(g_j.nodes(data=True))
    assert sorted(g_t.edges(keys=True, data=True), key=str) == \
        sorted(g_j.edges(keys=True, data=True), key=str)
    assert set(tn_t["a"].G.nodes) == set(g_j.nodes)
    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(ttn.TNError, match="networkx"):
        tn_t.to_networkx()


def _decompositions(mod):
    from importlib import import_module

    dec = import_module(f"{mod.__name__}.models.decompositions")
    rng = np.random.default_rng(11)
    factors = [rng.standard_normal((3, 4)) for _ in range(3)]
    core = rng.standard_normal((3, 3, 3))
    mps = [rng.standard_normal((2, 3))] + \
        [rng.standard_normal((2, 3, 3)) for _ in range(2)] + \
        [rng.standard_normal((2, 3))]
    ring = [rng.standard_normal((2, 3, 3)) for _ in range(4)]
    mats = [rng.standard_normal((3, 3)) for _ in range(5)]
    return {
        "cp": dec.cp_tn(factors),
        "tucker": dec.tucker_tn(core, factors),
        "mps": dec.mps_tn(mps),
        "ring": dec.tensor_ring_tn(ring),
        "regular": dec.random_regular_tn(
            8, 3, 2, rng=np.random.default_rng(5))[0],
        "matrix_chain": dec.matrix_chain_tn(mats, np.ones(3), np.ones(3)),
    }


def test_decompositions_match_jax():
    built_t, built_j = _decompositions(ttn), _decompositions(jtn)
    for name, tn_t in built_t.items():
        tn_j = built_j[name]
        assert tn_t.einsum_str == tn_j.einsum_str, name
        for p_t, p_j in zip(tn_t.params, tn_j.params):
            np.testing.assert_array_equal(np.asarray(p_t), np.asarray(p_j))
        got = _value(tn_t.contract(split_format=True, device="cpu"))
        want = _value(tn_j.contract(split_format=True))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-12,
                                   err_msg=name)


def test_new_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    from contractn_tpu_torch.utils.checkpoint import load_tn, save_tn

    save_tn(tmp_path / "tn.npz", _mixed_tn(ttn))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ring = ttn.TN()
    nodes = [ring.add_dense_node(np.eye(2)) for _ in range(3)]
    for i in range(3):
        ring.connect_nodes(nodes[i], nodes[(i + 1) % 3], 1, 0)
    for call in (
        lambda: ttn.contract_expression("ab,b->a", (2, 2), (2,))(
            np.ones((2, 2)), np.ones(2)),
        lambda: load_tn(tmp_path / "tn.npz"),
        lambda: ttn.bp_contract(ring),
        lambda: ttn.gate_from_term(np.eye(4), 0.1),
    ):
        with pytest.raises(ttn.TNError, match="device='cpu'"):
            call()
    # the CPU stays available on request (on a ring BP gives the dominant
    # eigenvalue's orbit: 1 here, where the trace of the identity is 2)
    assert abs(_value(ttn.bp_contract(ring, device="cpu")) - 1.0) < TOL
