"""The directional cell CTMRG of the PyTorch port against the JAX package and
the closed forms, on the CPU.

The JAX file's seven tests run on the port with their anchors (the
symmetric CTMRG on a 1x1 cell, translation invariance, Onsager-Yang on the
checkerboard antiferromagnet, Onsager's axial correlation length, the
quantum-classical correlator identity).  Parity with the JAX package is held
at 1e-10 through gauge-invariant readings (site expectations, the pair patch
and row correlators) on a columnar antiferromagnet of two sites, both
packages converging from the same cell; environments are never compared
directly (the decompositions' gauges differ).
"""

from importlib import import_module

import numpy as np
import pytest
import torch

jcc = import_module("contractn_tpu.models.ctmrg_cell")
tcc = import_module("contractn_tpu_torch.models.ctmrg_cell")
tct = import_module("contractn_tpu_torch.models.ctmrg")
tip = import_module("contractn_tpu_torch.models.ipeps")

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")


def ising(beta, field_op=None):
    return tct.ising_tensor(beta, field_op=field_op, device=CPU)


def afm_tensors(beta, eps=0.0):
    """Classical AFM Ising site and impurity tensors of both sublattices
    (the JAX test's construction; ``eps`` a staggered field)."""
    b_fm = np.array([[np.exp(beta), np.exp(-beta)], [np.exp(-beta), np.exp(beta)]])
    vals, vecs = np.linalg.eigh(b_fm)
    w = vecs * np.sqrt(np.maximum(vals, 0.0))[None, :]
    wa, wb = w, np.array([[0.0, 1.0], [1.0, 0.0]]) @ w
    spin = np.array([1.0, -1.0])
    pa, pb = np.exp(eps * spin), np.exp(-eps * spin)

    def site(wm, p):
        return np.einsum("s,su,sl,sd,sr->uldr", p, wm, wm, wm, wm)

    def imp(wm, p):
        return np.einsum("s,s,su,sl,sd,sr->uldr", spin, p, wm, wm, wm, wm)

    return site(wa, pa), site(wb, pb), imp(wa, pa), imp(wb, pb)


def readings(mod, cell, imps, chi, iters):
    """The gauge-invariant readings of one converged environment."""
    env = mod.ctmrg_cell(cell, chi, iters)
    lx, ly = len(cell), len(cell[0])
    return {
        "m": [[mod.site_expectation(cell, env, imps[x][y], x, y) for y in range(ly)]
              for x in range(lx)],
        "pair": mod.pair_expectation_h(cell, env, imps[0][0], imps[1 % lx][0], 0, 0),
        "row": mod.row_correlator(cell, env, imps[0][0], imps, [1, 2, 3]),
    }


STRIPE = dict(beta=0.5, eps=1e-3, chi=8, iters=30)


def stripe_cell():
    """Two columns of opposite sublattices: antiferromagnetic rows,
    ferromagnetic columns (a genuine 2x1 cell without C4v symmetry)."""
    aa, ab, ia, ib = afm_tensors(STRIPE["beta"], STRIPE["eps"])
    return ((aa,), (ab,)), ((ia,), (ib,))


@pytest.fixture(scope="module")
def ref():
    import jax

    cell, imps = stripe_cell()
    out = jax.jit(lambda c, i: readings(jcc, c, i, STRIPE["chi"], STRIPE["iters"]))(cell, imps)
    return jax.tree_util.tree_map(float, out)


def _floats(tree):
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_floats(x) for x in tree]
    return float(tree)


def test_stripe_cell_readings_match_jax(ref):
    cell, imps = stripe_cell()
    cell = tuple(tuple(torch.from_numpy(t) for t in col) for col in cell)
    got = _floats(readings(tcc, cell, imps, STRIPE["chi"], STRIPE["iters"]))
    np.testing.assert_allclose(got["m"], ref["m"], rtol=0, atol=TOL)
    assert abs(got["pair"] - ref["pair"]) < TOL
    np.testing.assert_allclose(got["row"], ref["row"], rtol=0, atol=TOL)
    # the staggered moment alternates between the columns
    assert got["m"][0][0] == pytest.approx(-got["m"][1][0], abs=1e-9)


def cell_free_energy_1x1(a, env):
    """Baxter corner-ratio free energy from a 1x1 cell environment."""
    c1, c2, c3, c4, t1, t2, t3, t4 = (e[0][0] for e in env)
    w_a = torch.einsum("ab,auc,ce,blf,uldr,erg,fh,hdi,gi->", c1, t1, c2, t4, a, t2, c4, t3, c3)
    w_c = torch.einsum("ab,ac,be,ce->", c1, c2, c4, c3)
    w_h = torch.einsum("ab,auc,cd,be,euf,df->", c1, t1, c2, c4, t3, c3)
    w_v = torch.einsum("ab,ac,ble,clf,eg,fg->", c1, c2, t4, t2, c4, c3)
    return float(torch.log(torch.abs(w_a * w_c / (w_h * w_v))))


def test_1x1_cell_matches_symmetric_ctmrg():
    a = ising(0.3)
    env = tcc.ctmrg_cell(((a,),), chi=16, iters=50)
    f_sym = tct.free_energy_per_site(a, chi=16, iters=100)
    assert np.isclose(cell_free_energy_1x1(a, env), f_sym, rtol=1e-12)


def test_rotation_is_order_four():
    a = ((ising(0.4),),)
    env = tcc.ctmrg_cell(a, chi=8, iters=20)
    a_r, env_r = a, env
    for _ in range(4):
        a_r, env_r = tcc.rotate(a_r, env_r)

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        return [x for t in tree for x in leaves(t)]

    for got, want in zip(leaves((a_r, env_r)), leaves((a, env))):
        assert torch.equal(got, want)


def test_uniform_2x2_cell_translation_invariant():
    beta = 0.3
    a, imp = ising(beta), ising(beta, field_op=[1.0, -1.0])
    cell = ((a, a), (a, a))
    env = tcc.ctmrg_cell(cell, chi=16, iters=40)
    db = 1e-5
    want = (tct.free_energy_per_site(ising(beta + db), 16, iters=100)
            - tct.free_energy_per_site(ising(beta - db), 16, iters=100)) / (2 * db) / 2.0
    for x in range(2):
        for y in range(2):
            got = float(tcc.pair_expectation_h(cell, env, imp, imp, x, y))
            assert np.isclose(got, want, atol=1e-8), (x, y, got, want)
            assert abs(float(tcc.site_expectation(cell, env, imp, x, y))) < 1e-10


def test_checkerboard_afm_matches_onsager():
    beta = 0.5
    m_exact = (1.0 - np.sinh(2 * beta) ** -4) ** 0.125
    a_a, a_b, i_a, i_b = (torch.from_numpy(t) for t in afm_tensors(beta, eps=1e-4))
    cell = ((a_a, a_b), (a_b, a_a))
    imps = ((i_a, i_b), (i_b, i_a))
    env = tcc.ctmrg_cell(cell, chi=16, iters=40)
    ms = [[float(tcc.site_expectation(cell, env, imps[x][y], x, y)) for y in range(2)]
          for x in range(2)]
    assert np.isclose(ms[0][0], ms[1][1], atol=1e-9)
    assert np.isclose(ms[1][0], ms[0][1], atol=1e-9)
    assert np.isclose(ms[0][0], -ms[1][0], atol=1e-9)
    assert np.isclose(abs(ms[0][0]), m_exact, atol=2e-4)
    imp_fm, a_fm = ising(beta, field_op=[1.0, -1.0]), ising(beta)
    env_fm = tcc.ctmrg_cell(((a_fm,),), chi=16, iters=40)
    ss_fm = float(tcc.pair_expectation_h(((a_fm,),), env_fm, imp_fm, imp_fm, 0, 0))
    ss_afm = float(tcc.pair_expectation_h(cell, env, imps[0][0], imps[1][0], 0, 0))
    assert np.isclose(ss_afm, -ss_fm, atol=3e-4)


def test_row_correlator_distance_one_equals_pair_patch():
    a, imp = ising(0.3), ising(0.3, field_op=[1.0, -1.0])
    cell = ((a,),)
    env = tcc.ctmrg_cell(cell, chi=16, iters=40)
    c1 = tcc.row_correlator(cell, env, imp, imp, [1], connected=False)[0]
    assert np.isclose(float(c1), float(tcc.pair_expectation_h(cell, env, imp, imp, 0, 0)),
                      rtol=1e-12)


def test_transfer_spectrum_matches_onsager_correlation_length():
    beta = 0.3
    a, imp = ising(beta), ising(beta, field_op=[1.0, -1.0])
    cell = ((a,),)
    env = tcc.ctmrg_cell(cell, chi=24, iters=100)
    _, xi = tcc.row_transfer_spectrum(cell, env)
    xi_exact = 1.0 / (np.log(1.0 / np.tanh(beta)) - 2.0 * beta)
    assert abs(xi - xi_exact) / xi_exact < 0.02
    c8, c10 = (float(v) for v in tcc.row_correlator(cell, env, imp, imp, [8, 10]))
    rate = (np.log(c8 / c10) - 0.5 * np.log(10.0 / 8.0)) / 2.0
    assert abs(rate - 1.0 / xi_exact) < 0.02


def test_quantum_row_correlator_matches_classical():
    beta = 0.35
    b = np.array([[np.exp(beta / 2), np.exp(-beta / 2)], [np.exp(-beta / 2), np.exp(beta / 2)]])
    vals, vecs = np.linalg.eigh(b)
    w = vecs * np.sqrt(np.maximum(vals, 0.0))[None, :]
    a_q = torch.from_numpy(np.einsum("su,sl,sd,sr->suldr", w, w, w, w))
    sz = np.diag([1.0, -1.0])
    dl, dl_imp = tip.peps_double_layer(a_q), tip.peps_double_layer(a_q, sz)
    cell_q = ((dl,),)
    env_q = tcc.ctmrg_cell(cell_q, chi=16, iters=50)
    got = [float(v) for v in tcc.row_correlator(cell_q, env_q, dl_imp, dl_imp, [1, 3, 5])]
    a_c, imp_c = ising(beta), ising(beta, field_op=[1.0, -1.0])
    cell_c = ((a_c,),)
    env_c = tcc.ctmrg_cell(cell_c, chi=16, iters=50)
    want = [float(v) for v in tcc.row_correlator(cell_c, env_c, imp_c, imp_c, [1, 3, 5])]
    assert np.allclose(got, want, rtol=1e-8)
