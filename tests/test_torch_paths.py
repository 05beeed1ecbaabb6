"""The port's path strategies against opt_einsum 3.4.0, on the CPU.

``contractn_tpu_torch/compiler/paths.py`` ports opt_einsum's strategies; the
JAX package calls opt_einsum itself.  On ``opt_einsum.testing.rand_equation``
networks each strategy must return opt_einsum's path, so its cost in
opt_einsum's ``opt_cost`` convention is equal (relative 1e-12), and the
4096-matrix chain must plan into the JAX package's number of plan items.
"""

import numpy as np
import opt_einsum as oe
import pytest
import torch
from opt_einsum.testing import rand_equation

import contractn_tpu as jtn
import contractn_tpu_torch as ttn
from contractn_tpu_torch.compiler.paths import find_path
from contractn_tpu_torch.utils.introspect import path_cost

torch.set_num_threads(1)

SMALL = [(3 + seed % 6, seed) for seed in range(300)]  # 50 networks per size
LARGE = [(10 + seed % 7, seed) for seed in range(40)]


def _network(n_ops, seed):
    eq, shapes = rand_equation(n_ops, 3, seed=seed, d_min=2, d_max=6, n_out=2)
    terms, output = eq.split("->")
    return eq, terms.split(","), output, [tuple(s) for s in shapes]


def _check(strategy, n_ops, seed, memory_limit=None):
    eq, terms, output, shapes = _network(n_ops, seed)
    try:
        ref_path, info = oe.contract_path(eq, *shapes, shapes=True,
                                          optimize=strategy,
                                          memory_limit=memory_limit)
    except RuntimeError:  # dp: no path within the limit
        with pytest.raises(ttn.TNError, match="memory_limit"):
            find_path(tuple(terms), output, tuple(shapes), strategy,
                      memory_limit)
        return
    path = find_path(tuple(terms), output, tuple(shapes), strategy,
                     memory_limit)
    sizes = {}
    for term, shape in zip(terms, shapes):
        sizes.update(zip(term, shape))
    cost = path_cost(terms, output, sizes, path)[0]
    ref_cost = int(info.opt_cost)
    assert abs(cost - ref_cost) <= 1e-12 * ref_cost, (eq, cost, ref_cost)
    assert list(path) == [tuple(p) for p in ref_path], eq


@pytest.mark.parametrize("strategy", ["auto", "greedy", "optimal", "branch-all",
                                      "branch-2", "branch-1", "dp", "auto-hq"])
def test_small_networks_match_opt_einsum(strategy):
    for n_ops, seed in SMALL:
        _check(strategy, n_ops, seed)


@pytest.mark.parametrize("strategy", ["auto", "greedy", "branch-2", "branch-1", "dp"])
def test_large_networks_match_opt_einsum(strategy):
    for n_ops, seed in LARGE:
        _check(strategy, n_ops, seed)


@pytest.mark.parametrize("strategy", ["greedy", "optimal", "branch-2", "dp"])
@pytest.mark.parametrize("memory_limit", ["max_input", 64])
def test_memory_limit_matches_opt_einsum(strategy, memory_limit):
    for n_ops, seed in SMALL[:30]:
        _check(strategy, n_ops, seed, memory_limit)


def test_aliases_and_departures():
    eq, terms, output, shapes = _network(6, 3)
    args = (tuple(terms), output, tuple(shapes))
    assert find_path(*args, "eager", None) == find_path(*args, "greedy", None)
    assert find_path(*args, "dynamic-programming", None) == find_path(*args, "dp", None)
    for name in ("random-greedy", "random-greedy-128"):
        with pytest.raises(ttn.TNError, match="not available"):
            find_path(*args, name, None)
    eq, terms, output, shapes = _network(17, 0)
    with pytest.raises(ttn.TNError, match="random-greedy-128"):
        find_path(tuple(terms), output, tuple(shapes), "auto-hq", None)


@pytest.mark.parametrize("strategy", ["auto", "optimal", "branch-all", "dp"])
def test_contract_values_match_jax(strategy):
    eq, terms, output, shapes = _network(6, 11)
    rng = np.random.default_rng(4)
    ops = [rng.standard_normal(s) for s in shapes]
    mj, lj = jtn.contract(eq, *ops, split_format=True, optimize=strategy)
    mt, lt = ttn.contract(eq, *ops, split_format=True, optimize=strategy,
                          device="cpu")
    np.testing.assert_allclose(mt.numpy() * np.exp(lt.numpy()),
                               np.asarray(mj) * np.exp(np.asarray(lj)),
                               rtol=1e-10, atol=1e-13)


def test_chain_plan_items_match_jax():
    """The 4096-matrix chain of ``chip_smoke.py`` phase 7 (bonds 48/64 in
    blocks of 12) plans into the JAX package's number of plan items."""
    from contractn_tpu.compiler.engine import _find_steps
    from contractn_tpu.compiler.lowering import plan_program
    from contractn_tpu_torch.compiler import engine
    from contractn_tpu_torch.symbols import get_symbol

    n, block = 4096, 12
    dims = [48 if (i // block) % 2 == 0 else 64 for i in range(n + 1)]
    einstr = ",".join(get_symbol(i) + get_symbol(i + 1) for i in range(n)) \
        + "->" + get_symbol(0) + get_symbol(n)
    shapes = tuple((dims[i], dims[i + 1]) for i in range(n))
    jax_plan, _ = plan_program(_find_steps(einstr, shapes, "greedy", None), n, shapes)
    for optimize in ("greedy", "auto"):
        plan = engine._plan(einstr, shapes, optimize, None)
        assert len(plan.buckets.plan) == len(jax_plan) == 1047
