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
        _check(name, 6, 3)
    _check("auto-hq", 17, 0)  # random-greedy-128 above 16 operands


@pytest.mark.parametrize("strategy", ["random-greedy", "random-greedy-128"])
def test_random_greedy_matches_opt_einsum(strategy):
    """Each trial draws from its own ``random.Random(r)``: the same draws as
    opt_einsum's after ``random.seed(r)``, so the same path, on networks
    of 3 to 8 operands; the global ``random`` state is left alone."""
    import random

    state = random.getstate()
    for n_ops, seed in SMALL[:6]:
        eq, terms, output, shapes = _network(n_ops, seed)
        find_path.cache_clear()
        random.setstate(state)
        path = find_path(tuple(terms), output, tuple(shapes), strategy, None)
        assert random.getstate() == state
        _check(strategy, n_ops, seed)
        assert find_path.__wrapped__(tuple(terms), output, tuple(shapes),
                                     strategy, None) == path


@pytest.mark.parametrize("n_ops, seed", [(17, 1), (20, 2), (60, 3), (130, 4)])
def test_random_greedy_trials_match_opt_einsum(n_ops, seed):
    """Trial by trial, not only the best of many: trial ``r`` returns the
    SSA path, FLOPs and largest intermediate of opt_einsum's
    ``_trial_greedy_ssa_path_and_cost(r, ...)`` with ``RandomGreedy``'s
    default chooser and cost."""
    from opt_einsum.path_random import RandomGreedy, _trial_greedy_ssa_path_and_cost

    from contractn_tpu_torch.compiler.paths import _trial_greedy

    eq, terms, output, shapes = _network(n_ops, seed)
    sizes = {}
    for term, shape in zip(terms, shapes):
        sizes.update(zip(term, shape))
    inputs, out = [frozenset(t) for t in terms], frozenset(output)
    opt = RandomGreedy()
    for r in range(8):
        ssa, cost, size = _trial_greedy(r, inputs, out, sizes)
        ref_ssa, ref_cost, ref_size = _trial_greedy_ssa_path_and_cost(
            r, inputs, out, sizes, opt.choose_fn, opt.cost_fn)
        assert [tuple(p) for p in ssa] == [tuple(p) for p in ref_ssa], (eq, r)
        assert (cost, size) == (ref_cost, ref_size), (eq, r)


@pytest.mark.parametrize("n_ops, seed", [(17, 1), (20, 2)])
def test_auto_hq_above_16_operands_matches_opt_einsum(n_ops, seed):
    """``auto-hq`` takes ``random-greedy-128`` above 16 operands: the path
    equals opt_einsum's, and the contracted value the JAX package's."""
    _check("auto-hq", n_ops, seed)
    eq, terms, output, shapes = _network(n_ops, seed)
    assert find_path(tuple(terms), output, tuple(shapes), "auto-hq", None) == \
        find_path(tuple(terms), output, tuple(shapes), "random-greedy-128", None)
    rng = np.random.default_rng(seed)
    ops = [rng.standard_normal(s) for s in shapes]
    mj, lj = jtn.contract(eq, *ops, split_format=True, optimize="auto-hq")
    mt, lt = ttn.contract(eq, *ops, split_format=True, optimize="auto-hq",
                          device="cpu")
    np.testing.assert_allclose(mt.numpy() * np.exp(lt.numpy()),
                               np.asarray(mj) * np.exp(np.asarray(lj)),
                               rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("strategy", ["auto", "optimal", "branch-all", "dp",
                                      "random-greedy", "random-greedy-128"])
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
