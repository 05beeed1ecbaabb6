"""AutoMPO of the PyTorch port against the JAX package, on the CPU.

The same ``OpSum`` / ``InfiniteOpSum`` terms are compiled by both packages.
Compressed MPOs differ by SVD gauge, so they compare as dense ``2^n x 2^n``
operators (and by bond width); the uncompressed automata and the infinite
bulk cores are built without any decomposition and compare entry by entry.
Tolerance 1e-10 (relative to the operator's largest entry).
"""

from importlib import import_module

import numpy as np
import pytest
import torch

from contractn_tpu_torch.convert import mpo_to_numpy

ja = import_module("contractn_tpu.models.autompo")
ta = import_module("contractn_tpu_torch.models.autompo")

torch.set_num_threads(1)

TOL = 1e-10


def _dense(cores, left, right):
    d = cores.shape[1]
    cur = np.einsum("w,abwv->abv", np.asarray(left), np.asarray(cores[0]))
    for w in np.asarray(cores)[1:]:
        dd = cur.shape[0]
        cur = np.einsum("ABw,abwv->AaBbv", cur, w).reshape(d * dd, d * dd, -1)
    return np.einsum("ABv,v->AB", cur, np.asarray(right))


def _jdense(mpo):
    return _dense(np.asarray(mpo.cores), np.asarray(mpo.left), np.asarray(mpo.right))


def _tdense(mpo):
    return _dense(*mpo_to_numpy(mpo))


def _both(build):
    """The same terms accumulated in both packages' ``OpSum``."""
    return build(ja.OpSum()), build(ta.OpSum())


def _check(build, n, **kw):
    jsum, tsum = _both(build)
    jm = ja.op_sum_mpo(jsum, n, **kw)
    tm = ta.op_sum_mpo(tsum, n, device="cpu", **kw)
    want = _jdense(jm)
    got = _tdense(tm)
    assert np.max(np.abs(got - want)) < TOL * max(1.0, np.max(np.abs(want)))
    assert tm.cores.shape[3] == jm.cores.shape[3]
    return tm


def _tfim(h, n=5):
    for i in range(n - 1):
        h += (-1.0, "Z", i, "Z", i + 1)
    for i in range(n):
        h += (-0.7, "X", i)
    return h


def _heisenberg(h, n=5):
    for i in range(n - 1):
        for op in ("X", "Y", "Z"):
            h += (1.0, op, i, op, i + 1)
    return h


def _exp_decay(h, n=7, lam=0.55):
    for i in range(n):
        for j in range(i + 1, n):
            h += (lam ** (j - i), "Z", i, "Z", j)
    return h


def _fermions(h, n=6):
    for i in range(n - 1):
        h += (-1.0, "Cdag", i, "C", i + 1)
        h += (-1.0, "Cdag", i + 1, "C", i)
    for i in range(n - 2):
        h += (-0.3, "Cdag", i, "C", i + 2)
        h += (-0.3, "Cdag", i + 2, "C", i)
    for i in range(n):
        h += (0.4, "N", i)
    return h


def _complex_same_site(h):
    h += (0.5 + 0.25j, "S+", 1, "S-", 1)
    h += (-0.5 - 0.25j, "Sz", 2, "Sz", 2, "X", 0)
    h += (1.0j, "Y", 3)
    h += (2.5, "I", 1)  # a constant shift
    return h


def _random_terms(h, n=6):
    rng = np.random.default_rng(7)
    names = list(ja.OP_TABLE)
    for _ in range(20):
        args = []
        for _ in range(int(rng.integers(1, 5))):
            args += [names[rng.integers(len(names))], int(rng.integers(n))]
        h.add(complex(rng.standard_normal(), rng.standard_normal()), *args)
    return h


@pytest.mark.parametrize("case,n,width", [
    (_tfim, 5, 3), (_heisenberg, 5, 5), (_exp_decay, 7, 3), (_fermions, 6, None),
    (_complex_same_site, 4, None), (_random_terms, 6, None),
])
def test_op_sum_mpo_matches_jax(case, n, width):
    tm = _check(case, n)
    if width is not None:
        assert tm.cores.shape[3] == width


def test_uncompressed_automaton_and_deparallelized_match_jax():
    from contractn_tpu.models.mpo import deparallelize_mpo as j_dep
    from contractn_tpu_torch.models.mpo import deparallelize_mpo as t_dep

    jsum, tsum = _both(_heisenberg)
    jm = ja.op_sum_mpo(jsum, 5, compress=False)
    tm = ta.op_sum_mpo(tsum, 5, compress=False, device="cpu")
    for got, want in zip(mpo_to_numpy(tm), (jm.cores, jm.left, jm.right)):
        np.testing.assert_array_equal(got, np.asarray(want))
    jd, td = j_dep(jm), t_dep(tm)
    assert td.cores.shape == tuple(jd.cores.shape)
    np.testing.assert_allclose(_tdense(td), _jdense(jd), atol=TOL)


def test_raw_matrices_custom_ops_gates_and_dtype():
    rng = np.random.default_rng(0)
    m1, m2 = rng.standard_normal((2, 2)), rng.standard_normal((2, 2))
    gate = rng.standard_normal((4, 4))
    gate = gate + gate.T

    def build(h):
        h += (1.3, m1, 0, m2, 3)
        h += (-0.2, "Q", 1)
        h.add_gate(0.5, gate, 1, 2)
        return h

    _check(build, 4, ops={"Q": m2})
    jsum, tsum = _both(build)
    tm = tsum.to_mpo(4, ops={"Q": m2}, dtype=torch.float32, device="cpu")
    assert tm.cores.dtype == torch.float32
    np.testing.assert_allclose(_tdense(tm), _jdense(ja.op_sum_mpo(jsum, 4, ops={"Q": m2})),
                               atol=1e-5)


def test_spin_ops_and_spin1_chain_match_jax():
    for s in (0.5, 1, 1.5):
        jops, tops = ja.spin_ops(s), ta.spin_ops(s)
        assert set(jops) == set(tops)
        for k in jops:
            np.testing.assert_array_equal(tops[k], jops[k])

    def build(h, n=4):
        for i in range(n - 1):
            h += (1.0, "Sz", i, "Sz", i + 1)
            h += (0.5, "S+", i, "S-", i + 1)
            h += (0.5, "S-", i, "S+", i + 1)
        return h

    tm = _check(build, 4, d=3, ops=ja.spin_ops(1))
    assert tm.cores.shape[3] == 5


def _infinite_sums(h):
    h += (-1.0, "Z", 0, "Z", 1)
    h += (-0.6, "X", 0)
    h += (-0.5, "Cdag", 0, "C", 2)
    h += (-0.5, "Cdag", 2, "C", 0)
    h.add_exp(0.8, "Sz", 0.4, "Sz")
    h.add_exp(0.3, "Cdag", -0.5, "C", string="Z")
    h.add_gate(0.25, np.kron(np.diag([1.0, -1.0]), np.diag([1.0, -1.0])), r=2)
    return h


def test_infinite_op_sum_matches_jax():
    jsum, tsum = _infinite_sums(ja.InfiniteOpSum()), _infinite_sums(ta.InfiniteOpSum())
    jerr = jsum.add_power_law(0.2, "Sz", 2.0, "Sz", n_exp=4, r_max=30)
    terr = tsum.add_power_law(0.2, "Sz", 2.0, "Sz", n_exp=4, r_max=30)
    assert abs(terr - jerr) < TOL
    jcore = np.asarray(jsum.to_umpo())
    tcore = tsum.to_umpo(device="cpu")
    np.testing.assert_allclose(tcore.numpy(), jcore, atol=1e-12)
    jfin = ja.umpo_finite(jcore, 4)
    tfin = ta.umpo_finite(tcore, 4)
    for got, want in zip(mpo_to_numpy(tfin), (jfin.cores, jfin.left, jfin.right)):
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="even number"):
        ta.InfiniteOpSum().add(1.0, "C", 0).to_umpo(device="cpu")


def test_fit_exp_sum_matches_jax():
    for f in (lambda r: r ** -2.0, lambda r: np.exp(-0.3 * r) / r):
        cj, lj = ja.fit_exp_sum(f, 5, 40)
        ct, lt = ta.fit_exp_sum(f, 5, 40)
        np.testing.assert_allclose(lt, lj, atol=TOL)
        np.testing.assert_allclose(ct, cj, atol=TOL)


def test_validation():
    h = ta.OpSum()
    with pytest.raises(ValueError):
        h.add(1.0, "Z")
    with pytest.raises(ValueError):
        ta.op_sum_mpo(h, 4, device="cpu")
    h += (1.0, "Z", 5)
    with pytest.raises(ValueError):
        ta.op_sum_mpo(h, 4, device="cpu")
    h = ta.OpSum()
    h += (1.0, "X", 0)  # X changes the U(1) charge: no definite channels
    with pytest.raises(ValueError, match="charge-definite"):
        ta.op_sum_mpo(h, 4, phys_charges=[1, -1], device="cpu")
