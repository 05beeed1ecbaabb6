"""The three kernel modules of the PyTorch port.

On the CPU each wrapper runs its kernel's plain torch version; those are
held against the JAX package's Pallas kernels run in interpret mode (as
``tests/test_pallas.py`` runs them), on identical float32 data, to rtol 1e-5:
the arithmetic is the same and only the summation order differs.  The hand
kernels themselves are held against their plain versions on a GPU in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu.models import MPO as JMPO
from contractn_tpu.models import heisenberg_mpo as j_heisenberg_mpo
from contractn_tpu.models import tfim_mpo as j_tfim_mpo
from contractn_tpu.ops.pallas_epilogue import mps_evaluate_epilogue as j_epilogue
from contractn_tpu.ops.pallas_mpo import mpo_expectation_pallas
from contractn_tpu.ops.pallas_mps import pallas_mps_evaluate
from contractn_tpu_torch.convert import mpo_from_numpy
from contractn_tpu_torch.models import heisenberg_mpo, tfim_mpo
from contractn_tpu_torch.ops import cuda_epilogue, cuda_mpo, cuda_mps

torch.set_num_threads(1)

RTOL = 1e-5


def _arrays(n, d, bond, batch, seed, scale=0.25):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        (scale * rng.standard_normal((n, d, bond, bond))).astype(f32),
        rng.standard_normal(bond).astype(f32),
        rng.standard_normal(bond).astype(f32),
        rng.standard_normal((batch, n, d)).astype(f32),
    )


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_split_close(got, ref, rtol, cond=1.0):
    """Split pairs agree as values: ``m_got * exp(l_got - l_ref)`` vs ``m_ref``.

    ``cond`` (per sample) is the condition number of the closing dot product
    ``sum |v_i r_i| / |sum v_i r_i|``: rounding in the chain is amplified by
    it where the amplitude cancels, so the tolerance scales with it.
    """
    (mg, lg), (mr, lr) = got, ref
    mg, lg, mr, lr = (np.asarray(a, np.float64) for a in (mg, lg, mr, lr))
    err = np.abs(mg * np.exp(lg - lr) - mr)
    bound = rtol * np.asarray(cond) * np.abs(mr)
    assert np.all(err <= bound), (err / bound).max()


def _close_condition(cores, left, right, x):
    v, _ = cuda_epilogue.epilogue_chain_plain(cores, left, x)
    terms = v.double() * right.double()
    return (terms.abs().sum(1) / terms.sum(1).abs()).numpy()


@pytest.mark.parametrize("n,d,bond,batch,block_b", [
    (12, 2, 8, 16, 16), (12, 2, 8, 32, 16), (10, 3, 5, 8, 8),
])
def test_mps_plain_matches_pallas(n, d, bond, batch, block_b):
    arrays = _arrays(n, d, bond, batch, seed=n + batch)
    ref = pallas_mps_evaluate(*(jnp.asarray(a) for a in arrays), block_b=block_b,
                              interpret=True)
    before = cuda_mps.cuda_mps_evaluate.launches
    got = cuda_mps.cuda_mps_evaluate(*(_t(a) for a in arrays))
    assert cuda_mps.cuda_mps_evaluate.launches == before  # CPU: plain version
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    _assert_split_close(got, ref, RTOL, _close_condition(*(_t(a) for a in arrays)))


def test_mps_plain_guard_matches_pallas_on_a_zero_row():
    cores, left, right, x = _arrays(6, 2, 8, 8, seed=1)
    x[3, 2] = 0.0  # row 3 collapses to zero at site 2: the guard keeps it unscaled
    ref = pallas_mps_evaluate(*(jnp.asarray(a) for a in (cores, left, right, x)),
                              block_b=8, interpret=True)
    got = cuda_mps.mps_evaluate_plain(*(_t(a) for a in (cores, left, right, x)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=RTOL, atol=RTOL)


def test_epilogue_plain_guard_matches_pallas_on_a_zero_row():
    cores, left, right, x = _arrays(6, 2, 8, 8, seed=7)
    x[5, 3] = 0.0  # row 5 is zero from site 3 on: mean 0 is left unscaled
    ref = j_epilogue(*(jnp.asarray(a) for a in (cores, left, right, x)), interpret=True)
    got = cuda_epilogue.mps_evaluate_epilogue(*(_t(a) for a in (cores, left, right, x)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("n,d,bond,batch",
                         [(12, 2, 8, 16), (6, 3, 4, 8), (9, 2, 16, 24)])
def test_epilogue_plain_matches_pallas(n, d, bond, batch):
    arrays = _arrays(n, d, bond, batch, seed=n, scale=1 / np.sqrt(d * bond))
    ref = j_epilogue(*(jnp.asarray(a) for a in arrays), interpret=True)
    got = cuda_epilogue.mps_evaluate_epilogue(*(_t(a) for a in arrays))
    _assert_split_close(got, ref, RTOL, _close_condition(*(_t(a) for a in arrays)))


def test_epilogue_plain_bf16_carry_tracks_pallas():
    # bf16 rounds at other places in XLA and torch: compare log|psi| with a
    # tolerance of a few bf16 ulps per site over 12 sites
    arrays = _arrays(12, 2, 8, 16, seed=4, scale=1 / 4.0)
    ref = j_epilogue(*(jnp.asarray(a) for a in arrays), interpret=True,
                     acc_dtype=jnp.bfloat16)
    amp, log = cuda_epilogue.mps_evaluate_epilogue(*(_t(a) for a in arrays),
                                                   acc_dtype=torch.bfloat16)
    got_log = np.log(np.abs(amp.float().numpy())) + log.numpy()
    ref_log = np.log(np.abs(np.asarray(ref[0], np.float32))) + np.asarray(ref[1])
    np.testing.assert_allclose(got_log, ref_log, atol=0.1)


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_epilogue_plain_bf16_cores_match_pallas(acc):
    # bf16 cores: the carry starts from left cast to bf16, the GEMM takes bf16
    # operands.  Under the fp32 carry the float32 chains agree to rounding
    # order and both round the amplitude to the same bf16 value on these
    # inputs: rtol 1e-5 x condition as in fp32; the bf16 carry's log is held
    # to the tolerance of the test above
    cores, left, right, x = _arrays(12, 2, 8, 16, seed=11, scale=1 / 4.0)
    jb, tb = jnp.bfloat16, torch.bfloat16
    ref = j_epilogue(jnp.asarray(cores).astype(jb), *(jnp.asarray(a) for a in (left, right, x)),
                     interpret=True, acc_dtype=getattr(jnp, acc))
    got = cuda_epilogue.mps_evaluate_epilogue(_t(cores).to(tb), _t(left), _t(right), _t(x),
                                              acc_dtype=getattr(torch, acc))
    assert got[0].dtype == tb and got[1].dtype == torch.float32
    if acc == "float32":
        cond = _close_condition(_t(cores).to(tb), _t(left), _t(right), _t(x))
        _assert_split_close((got[0].float(), got[1]), (np.asarray(ref[0], np.float32), ref[1]),
                            RTOL, cond)
    else:
        got_log = np.log(np.abs(got[0].float().numpy())) + got[1].numpy()
        ref_log = np.log(np.abs(np.asarray(ref[0], np.float32))) + np.asarray(ref[1])
        np.testing.assert_allclose(got_log, ref_log, atol=0.1)


def _mpo_close_condition(mpo, cores, boundary):
    """Condition number of the close ``sum env[w,i,k] R[w] r[i] r[k]``."""
    wdim, bond = mpo.cores.shape[3], boundary.shape[0]
    env0 = torch.einsum("w,i,k->wik", mpo.left, boundary, boundary).reshape(-1, bond)
    env, _ = cuda_mpo.mpo_env_plain(cores, env0, cuda_mpo.mpo_entries(mpo), wdim)
    weight = torch.einsum("w,i,k->wik", mpo.right, boundary, boundary).double()
    terms = env.reshape(-1, wdim, bond, bond).double() * weight
    return (terms.abs().sum((1, 2, 3)) / terms.sum((1, 2, 3)).abs()).numpy()


def _mpo_arrays(n, bond, batch, seed):
    rng = np.random.default_rng(seed)
    cores = ((2 * bond) ** -0.5 * rng.standard_normal((batch, n, 2, bond, bond)))
    return cores.astype(np.float32), np.ones(bond, np.float32)


@pytest.mark.parametrize("n,bond,batch", [(6, 8, 4), (5, 4, 6)])
def test_mpo_plain_matches_pallas(n, bond, batch):
    cores, ones = _mpo_arrays(n, bond, batch, seed=3)
    ref = mpo_expectation_pallas(j_tfim_mpo(n, dtype=jnp.float32), jnp.asarray(cores),
                                 jnp.asarray(ones), jnp.asarray(ones), btile=2,
                                 interpret=True)
    before = cuda_mpo.mpo_env.launches
    got = cuda_mpo.mpo_expectation_cuda(tfim_mpo(n, dtype=torch.float32, device="cpu"),
                                        _t(cores), _t(ones), _t(ones))
    assert cuda_mpo.mpo_env.launches == before
    mpo = tfim_mpo(n, dtype=torch.float32, device="cpu")
    _assert_split_close(got, ref, RTOL, _mpo_close_condition(mpo, _t(cores), _t(ones)))


def test_mpo_plain_matches_pallas_uniform_w6():
    # a dense uniform MPO with d = 2, W = 6 from numpy (the channel mix sums
    # up to d*W = 12 blocks per output): the plain version is what the card
    # holds both MPO kernel paths against
    n, bond, batch, wdim = 4, 6, 4, 6
    rng = np.random.default_rng(12)
    core = (rng.standard_normal((2, 2, wdim, wdim)) / np.sqrt(2 * wdim)).astype(np.float32)
    w = np.broadcast_to(core, (n, 2, 2, wdim, wdim)).copy()
    ends = (0.5 + rng.random((2, wdim))).astype(np.float32)
    cores, ones = _mpo_arrays(n, bond, batch, seed=13)
    ref = mpo_expectation_pallas(JMPO(jnp.asarray(w), jnp.asarray(ends[0]), jnp.asarray(ends[1])),
                                 jnp.asarray(cores), jnp.asarray(ones), jnp.asarray(ones),
                                 btile=2, interpret=True)
    mpo = mpo_from_numpy(w, ends[0], ends[1], device="cpu")
    assert len(cuda_mpo.mpo_entries(mpo)) == 2 * 2 * wdim * wdim
    before = cuda_mpo.mpo_env.launches
    got = cuda_mpo.mpo_expectation_cuda(mpo, _t(cores), _t(ones), _t(ones))
    assert cuda_mpo.mpo_env.launches == before
    _assert_split_close(got, ref, RTOL, _mpo_close_condition(mpo, _t(cores), _t(ones)))


@pytest.mark.parametrize("kind,bond", [("heisenberg", 96), ("heisenberg", 128), ((2, 8), 64)],
                         ids=["heisenberg-D96", "heisenberg-D128", "d2-W8-D64"])
def test_mpo_plain_matches_pallas_at_the_cluster_reach(kind, bond):
    # shapes only the CUDA kernel's cluster path takes (D > 64, and d = 2
    # with W = 8 at D = 64): the plain version the card holds it against
    # agrees with the Pallas kernel there too
    n, batch = 3, 2
    cores, ones = _mpo_arrays(n, bond, batch, seed=21)
    if kind == "heisenberg":
        jmpo = j_heisenberg_mpo(n, dtype=jnp.float32)
        mpo = heisenberg_mpo(n, dtype=torch.float32, device="cpu")
    else:
        phys, wdim = kind
        rng = np.random.default_rng(22)
        core = rng.standard_normal((phys, phys, wdim, wdim)) / np.sqrt(phys * wdim)
        w = np.broadcast_to(core.astype(np.float32), (n, phys, phys, wdim, wdim)).copy()
        ends = (0.5 + rng.random((2, wdim))).astype(np.float32)
        jmpo = JMPO(jnp.asarray(w), jnp.asarray(ends[0]), jnp.asarray(ends[1]))
        mpo = mpo_from_numpy(w, ends[0], ends[1], device="cpu")
    ref = mpo_expectation_pallas(jmpo, jnp.asarray(cores), jnp.asarray(ones), jnp.asarray(ones),
                                 btile=2, interpret=True)
    before = cuda_mpo.mpo_env.launches
    got = cuda_mpo.mpo_expectation_cuda(mpo, _t(cores), _t(ones), _t(ones))
    assert cuda_mpo.mpo_env.launches == before
    _assert_split_close(got, ref, RTOL, _mpo_close_condition(mpo, _t(cores), _t(ones)))


def test_mpo_plain_guard_matches_pallas_on_a_zero_sample():
    n, bond = 4, 8
    cores, ones = _mpo_arrays(n, bond, 4, seed=8)
    cores[2, 1] = 0.0  # sample 2's environment vanishes at site 1
    ref = mpo_expectation_pallas(j_tfim_mpo(n, dtype=jnp.float32), jnp.asarray(cores),
                                 jnp.asarray(ones), jnp.asarray(ones), btile=2,
                                 interpret=True)
    got = cuda_mpo.mpo_expectation_cuda(tfim_mpo(n, dtype=torch.float32, device="cpu"),
                                        _t(cores), _t(ones), _t(ones))
    np.testing.assert_array_equal(got[0].numpy()[2], np.asarray(ref[0])[2])
    np.testing.assert_allclose(got[1].numpy()[2], np.asarray(ref[1])[2], atol=RTOL)


def test_mpo_rejects_non_uniform():
    w = np.random.default_rng(0).standard_normal((4, 2, 2, 3, 3)).astype(np.float32)
    left, right = np.array([1.0, 0, 0], np.float32), np.array([0, 0, 1.0], np.float32)
    cores4 = np.zeros((4, 4, 2, 8, 8), np.float32)
    ones = np.ones(8, np.float32)
    with pytest.raises(ValueError, match="uniform"):
        mpo_expectation_pallas(
            JMPO(jnp.asarray(w), jnp.asarray(left), jnp.asarray(right)),
            jnp.asarray(cores4), jnp.asarray(ones), jnp.asarray(ones), btile=2)
    with pytest.raises(ValueError, match="uniform"):
        cuda_mpo.mpo_expectation_cuda(mpo_from_numpy(w, left, right, device="cpu"),
                                      _t(cores4), _t(ones), _t(ones))


def test_wrappers_validate_shapes():
    cores, left, right, x = (_t(a) for a in _arrays(4, 2, 8, 8, seed=2))
    with pytest.raises(ValueError):
        cuda_mps.cuda_mps_evaluate(cores, left, right, x[:, :3])
    with pytest.raises(ValueError):
        cuda_mps.cuda_mps_evaluate(cores, left[:4], right, x)
    with pytest.raises(TypeError):
        cuda_epilogue.mps_evaluate_epilogue(cores, left, right, x,
                                            acc_dtype=torch.float64)
    with pytest.raises(TypeError):
        cuda_mps.cuda_mps_evaluate(cores.to(torch.complex64), left, right, x)
    env0 = torch.zeros(3 * 8, 8)
    with pytest.raises(ValueError):
        cuda_mpo.mpo_env(torch.zeros(2, 4, 2, 8, 8), env0[:8], (), 3)
