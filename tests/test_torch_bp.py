"""Belief-propagation layer of the PyTorch port against the JAX package.

Same numpy inputs (seeded) through ``contractn_tpu`` and
``contractn_tpu_torch`` (``device="cpu"``) in float64.  Values, sweep
counts and messages must agree to 1e-10; gauge-dependent outputs (gauged
tensors, SVD factors) are compared through gauge-invariant quantities:
sorted spectra and the dense state the gauged network contracts to.
Energies of the variational descent agree to 1e-8, for real and complex
tensors (the complex case pins the optax form of Adam).
"""

import numpy as np
import pytest
import torch

import contractn_tpu as jtn
import contractn_tpu_torch as ttn

torch.set_num_threads(1)

TOL = 1e-10
SX = np.array([[0.0, 1.0], [1.0, 0.0]])
SZ = np.diag([1.0, -1.0])


def _value(mod_pair):
    m, log = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
              for x in mod_pair)
    return complex(m * np.exp(log))


def _tree(mod, seed):
    """Random tree of dense nodes (bond dims 2..4) with a copy-node hub."""
    rng = np.random.default_rng(seed)
    n = 6
    parents = [None] + [int(rng.integers(i)) for i in range(1, n)]
    dims = [0] + [int(rng.integers(2, 5)) for _ in range(1, n)]
    shapes = [[] for _ in range(n)]
    for i in range(1, n):
        shapes[i].append(dims[i])
        shapes[parents[i]].append(dims[i])
    shapes[0].append(3)  # leg to the hub
    tensors = [rng.standard_normal(tuple(s)) for s in shapes]
    leaves = [rng.standard_normal(3) for _ in range(3)]
    tn = mod.TN()
    for i, t in enumerate(tensors):
        tn.add_dense_node(t, name=f"n{i}")
    slots = [0] * n
    for i in range(1, n):
        tn.connect_nodes(f"n{i}", f"n{parents[i]}", slots[i],
                         slots[parents[i]])
        slots[i] += 1
        slots[parents[i]] += 1
    hub = tn.add_copy_node(4, dim=3, name="hub")
    tn.connect_nodes(hub, "n0", 0, slots[0])
    for k, v in enumerate(leaves):
        tn.connect_nodes(hub, tn.add_dense_node(v, name=f"leaf{k}"), k + 1, 0)
    return tn


def _ring(mod, seed=3):
    m = np.random.default_rng(seed).uniform(0.5, 1.5, size=(4, 4))
    tn = mod.TN()
    nodes = [tn.add_dense_node(m, name=f"m{i}") for i in range(6)]
    for i in range(6):
        tn.connect_nodes(nodes[i], nodes[(i + 1) % 6], 1, 0)
    return tn


def _petersen(mod, beta=0.2):
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0),
             (5, 7), (7, 9), (9, 6), (6, 8), (8, 5),
             (0, 5), (1, 6), (2, 7), (3, 8), (4, 9)]
    bond = np.array([[np.exp(beta), np.exp(-beta)],
                     [np.exp(-beta), np.exp(beta)]])
    tn = mod.TN()
    spins = [tn.add_copy_node(3, dim=2, name=f"v{i}") for i in range(10)]
    mode_next = [0] * 10
    for a, b in edges:
        e = tn.add_dense_node(bond, name=f"e{a}_{b}")
        tn.connect_nodes(spins[a], e, mode_next[a], 0)
        tn.connect_nodes(spins[b], e, mode_next[b], 1)
        mode_next[a] += 1
        mode_next[b] += 1
    return tn


@pytest.mark.parametrize("case,node,kwargs", [
    ("tree", "n0", {}),
    ("ring", "m2", {"max_iter": 500}),
    ("petersen", "e0_1", {}),
])
def test_bp_contract_and_environment_match_jax(case, node, kwargs):
    build = {"tree": lambda m: _tree(m, 0), "ring": _ring,
             "petersen": _petersen}[case]
    want = _value(jtn.bp_contract(build(jtn), **kwargs))
    got = _value(ttn.bp_contract(build(ttn), device="cpu", **kwargs))
    assert abs(got - want) <= TOL * abs(want)
    env_j, it_j = jtn.bp_environment(build(jtn), node, **kwargs)
    env_t, it_t = ttn.bp_environment(build(ttn), node, device="cpu", **kwargs)
    assert it_t == it_j
    assert len(env_t) == len(env_j)
    for a, b in zip(env_t, env_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    if case == "petersen":  # the analytic Bethe free energy
        phase, log = ttn.bp_contract(build(ttn), device="cpu")
        analytic = 10 * np.log(2) + 15 * np.log(np.cosh(0.2))
        assert abs(float(np.log(float(phase)) + log) - analytic) < 1e-10


def _state_tn(mod, rng_seed, loop, complex_=True):
    """4-site ring (or open chain), modes (phys, right, left), bond 3."""
    rng = np.random.default_rng(rng_seed)
    n, d, chi = 4, 2, 3
    tn = mod.TN()
    for i in range(n):
        shape = [d]
        if loop or i < n - 1:
            shape.append(chi)
        if loop or i > 0:
            shape.append(chi)
        t = rng.standard_normal(tuple(shape))
        if complex_:
            t = t + 1j * rng.standard_normal(tuple(shape))
        tn.add_dense_node(t, name=f"s{i}")
    for i in range(n if loop else n - 1):
        left = 2 if (loop or i + 1 < n - 1) else 1
        tn.connect_nodes(f"s{i}", f"s{(i + 1) % n}", 1, left)
    return tn


def _dense(tn):
    out = tn.contract(device="cpu") if isinstance(tn, ttn.TN) else tn.contract()
    return np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)


def _close(a, b, tol=TOL):
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def test_bp_norm_gauge_truncate_match_jax():
    tn_j, tn_t = _state_tn(jtn, 1, True), _state_tn(ttn, 1, True)
    kw = {"max_iter": 400}
    want = _value(jtn.bp_norm(tn_j, **kw))
    got = _value(ttn.bp_norm(tn_t, device="cpu", **kw))
    assert abs(got - want) <= TOL * abs(want)

    g_j, s_j = jtn.bp_gauge(tn_j, **kw)
    g_t, s_t = ttn.bp_gauge(tn_t, device="cpu", **kw)
    for a, b in zip(s_t, s_j):
        _close(np.sort(a.numpy()), np.sort(np.asarray(b)))
    _close(_dense(g_t), _dense(g_j))
    _close(_dense(g_t), _dense(tn_t))  # the telescope keeps the state

    t_j, k_j = jtn.bp_truncate(tn_j, 2, **kw)
    t_t, k_t = ttn.bp_truncate(tn_t, 2, device="cpu", **kw)
    for a, b in zip(k_t, k_j):
        _close(np.sort(a.numpy()), np.sort(np.asarray(b)))
    _close(_dense(t_t), _dense(t_j))


def _grid(mod, lx=2, ly=3):
    """|0...0> on an open lx x ly grid, bond 1, physical mode first."""
    tn = mod.TN()
    names = {}
    for x in range(lx):
        for y in range(ly):
            deg = sum([x > 0, x < lx - 1, y > 0, y < ly - 1])
            t = np.zeros((2,) + (1,) * deg)
            t[(0,) * (deg + 1)] = 1.0
            names[(x, y)] = f"g{x}_{y}"
            tn.add_dense_node(t, name=names[(x, y)])
    mode_next = {k: 1 for k in names}
    pairs = []
    for x in range(lx):
        for y in range(ly):
            for nb in ((x + 1, y), (x, y + 1)):
                if nb in names:
                    a, b = (x, y), nb
                    tn.connect_nodes(names[a], names[b], mode_next[a],
                                     mode_next[b])
                    mode_next[a] += 1
                    mode_next[b] += 1
                    pairs.append((names[a], names[b]))
    return tn, pairs


def test_bp_apply_gates_and_measure_match_jax():
    h = 1.5
    h2 = (-np.kron(SZ, SZ) - 0.5 * h * (np.kron(SX, np.eye(2))
                                        + np.kron(np.eye(2), SX)))
    tn_j, pairs = _grid(jtn)
    tn_t, _ = _grid(ttn)
    gate_j = jtn.gate_from_term(h2, 0.3, imaginary=True)
    gate_t = ttn.gate_from_term(h2, 0.3, imaginary=True, device="cpu")
    np.testing.assert_allclose(gate_t.numpy(), np.asarray(gate_j), rtol=TOL,
                               atol=1e-14)
    # a corner-edge, an edge-edge and an edge-corner bond (the JAX
    # package's eager gate ops compile per shape, so fewer gates keep the
    # test cheap); measured below on every node and bond
    gated = [pairs[i] for i in (1, 2, 5)]
    tn_j, sp_j = jtn.bp_apply_gates(
        tn_j, [(gate_j, a, b) for a, b in gated], max_bond=2,
        renormalize=True)
    tn_t, sp_t = ttn.bp_apply_gates(
        tn_t, [(gate_t, a, b) for a, b in gated], max_bond=2,
        renormalize=True, device="cpu")
    assert [len(s) for s in sp_t] == [len(s) for s in sp_j]
    for a, b in zip(sp_t, sp_j):
        _close(np.sort(a.numpy()), np.sort(np.asarray(b)))
    psi_j, psi_t = _dense(tn_j), _dense(tn_t)
    _close(psi_t / np.linalg.norm(psi_t), psi_j / np.linalg.norm(psi_j))

    local = [(f"g{x}_{y}", SX) for x in range(2) for y in range(3)]
    bonds = [(a, b, np.kron(SZ, SZ)) for a, b in pairs]
    loc_j, bond_j = jtn.bp_measure(tn_j, local=local, bonds=bonds)
    loc_t, bond_t = ttn.bp_measure(tn_t, local=local, bonds=bonds,
                                   device="cpu")
    np.testing.assert_allclose(loc_t, loc_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(bond_t, bond_j, rtol=TOL, atol=TOL)


def _chain(mod, complex_):
    rng = np.random.default_rng(7)
    n, chi = 4, 2
    tn = mod.TN()
    for i in range(n):
        shape = [2] + ([chi] if i < n - 1 else []) + ([chi] if i > 0 else [])
        t = 0.3 * rng.standard_normal(tuple(shape))
        if complex_:
            t = t + 0.3j * rng.standard_normal(tuple(shape))
        tn.add_dense_node(t, name=f"s{i}")
    for i in range(n - 1):
        tn.connect_nodes(f"s{i}", f"s{i+1}", 1, 2 if i + 1 < n - 1 else 1)
    bonds = [(f"s{i}", f"s{i+1}", -np.kron(SZ, SZ)) for i in range(n - 1)]
    local = [(f"s{i}", -1.1 * SX) for i in range(n)]
    return tn, bonds, local


@pytest.mark.parametrize("complex_", [False, True])
def test_bp_energy_and_ground_state_match_jax(complex_):
    tn_j, bonds, local = _chain(jtn, complex_)
    tn_t, _, _ = _chain(ttn, complex_)
    e_j = jtn.bp_energy(tn_j, bonds, local, n_sweeps=6)
    e_t = ttn.bp_energy(tn_t, bonds, local, n_sweeps=6, device="cpu")
    assert abs(e_t - e_j) <= TOL * abs(e_j)
    psi = _dense(tn_t).reshape(-1)
    assert abs(e_t - _rayleigh(psi, 4)) < 1e-10  # exact on a chain

    out_j, es_j = jtn.bp_ground_state(tn_j, bonds, local, steps=20, lr=0.05,
                                      n_sweeps=6)
    out_t, es_t = ttn.bp_ground_state(tn_t, bonds, local, steps=20, lr=0.05,
                                      n_sweeps=6, device="cpu")
    np.testing.assert_allclose(es_t.numpy(), np.asarray(es_j), rtol=0,
                               atol=1e-8)
    assert float(es_t[-1]) < float(es_t[0])
    _close(_dense(out_t), _dense(out_j), tol=1e-8)


def _rayleigh(psi, n, h=1.1):
    def op(o, i):
        m = np.eye(1)
        for j in range(n):
            m = np.kron(m, o if j == i else np.eye(2))
        return m

    hd = sum(-op(SZ, i) @ op(SZ, i + 1) for i in range(n - 1)) \
        - h * sum(op(SX, i) for i in range(n))
    return float(np.real(np.conj(psi) @ hd @ psi / (np.conj(psi) @ psi)))


def test_bp_errors_match_jax():
    for mod, kw in ((jtn, {}), (ttn, {"device": "cpu"})):
        tn = mod.TN()
        tn.add_dense_node(np.ones((2, 2)))
        with pytest.raises(mod.TNError):
            mod.bp_contract(tn, **kw)
        tn = mod.TN()
        hub = tn.add_copy_node(2, dim=2)
        tn.connect_nodes(hub, tn.add_dense_node(np.ones((2, 2))), 0, 0)
        with pytest.raises(mod.TNError):
            mod.bp_gauge(tn, **kw)
