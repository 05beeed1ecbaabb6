"""The first slice of the PyTorch port as a whole, on the CPU.

Graph -> split-format contraction -> batched MPS evaluation -> batched MPO
expectation, on the same seeded numpy data in both packages, plus a
rehearsal of ``chip_smoke.py``'s main-path phase at a tiny size on the CPU
(where every kernel wrapper runs its plain version).
"""

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
import contractn_tpu as jtn
from contractn_tpu.models import MPS as JMPS
from contractn_tpu.models import tfim_mpo as j_tfim_mpo
from contractn_tpu.ops.pallas_mpo import mpo_expectation_pallas
from contractn_tpu_torch.convert import mps_from_numpy
from contractn_tpu_torch.models import MPS, tfim_mpo
from contractn_tpu_torch.ops import cuda_mpo

torch.set_num_threads(1)


def _split(mant, log):
    return np.asarray(mant, np.float64) * np.exp(np.asarray(log, np.float64))


def test_slice_end_to_end_matches_jax():
    rng = np.random.default_rng(42)
    n, d, bond, batch = 9, 2, 6, 5
    cores = rng.standard_normal((n, d, bond, bond)) / np.sqrt(d * bond)
    left, right = rng.standard_normal(bond), rng.standard_normal(bond)
    x = np.zeros((batch, n, d))
    x[np.arange(batch)[:, None], np.arange(n), rng.integers(0, d, (batch, n))] = 1.0

    mj = JMPS(jnp.asarray(cores), jnp.asarray(left), jnp.asarray(right))
    mt = mps_from_numpy(cores, left, right, device="cpu")

    # graph layer: the MPS as a TN, contracted in split format (float64)
    tj, tt = mj.to_tn(), mt.to_tn()
    assert tt.einsum_str == tj.einsum_str
    dj = _split(*tj.contract(split_format=True))
    dt = _split(*tt.contract(split_format=True, device="cpu"))
    np.testing.assert_allclose(dt, dj, rtol=1e-10)

    # batched evaluation (float64 through "auto"), equal to the dense state
    ej = _split(*mj.evaluate(jnp.asarray(x)))
    et = _split(*mt.evaluate(torch.from_numpy(x)))
    np.testing.assert_allclose(et, ej, rtol=1e-10)
    idx = tuple(np.argmax(x, axis=-1).T)
    np.testing.assert_allclose(et, dt[idx], rtol=1e-10)

    # batched MPO expectation: the kernel path (plain version on the CPU,
    # float32) against the Pallas kernel in interpret mode
    mcores = rng.standard_normal((4, n, d, bond, bond)) / np.sqrt(d * bond)
    mcores = mcores.astype(np.float32)
    ones = np.ones(bond, np.float32)
    vj = mpo_expectation_pallas(j_tfim_mpo(n, dtype=jnp.float32), jnp.asarray(mcores),
                                jnp.asarray(ones), jnp.asarray(ones), btile=2,
                                interpret=True)
    before = cuda_mpo.mpo_env.launches
    vt = cuda_mpo.mpo_expectation_cuda(tfim_mpo(n, dtype=torch.float32, device="cpu"),
                                       torch.from_numpy(mcores), torch.from_numpy(ones),
                                       torch.from_numpy(ones))
    assert cuda_mpo.mpo_env.launches == before
    # fp32 rounding order differs; the energy's closing sum cancels (its
    # condition number is ~10-30 here), hence 1e-4 rather than 1e-5
    np.testing.assert_allclose(_split(*vt), _split(*vj), rtol=1e-4)
    # and the float64 per-sample expectation agrees with the batched path
    e64 = tfim_mpo(n, device="cpu").expectation(
        MPS(torch.from_numpy(mcores[0]).double(), torch.ones(bond, dtype=torch.float64),
            torch.ones(bond, dtype=torch.float64)))
    np.testing.assert_allclose(_split(*e64), _split(*vt)[0], rtol=1e-4)
    assert jtn.TN  # both packages imported side by side


def test_chip_smoke_main_path_rehearsal_on_cpu():
    flagship = {"n_sites": 20, "phys": 2, "bond": 8, "batch": 16}
    mpo_shape = {"n_sites": 6, "bond": 8, "batch": 5}
    runs = chip_smoke.main_path(torch.device("cpu"), flagship=flagship,
                                mpo_shape=mpo_shape, check=3)
    assert set(runs) == {"readme", "mps_evaluate", "mps_evaluate_epilogue",
                         "mpo_expectation"}
    # on the CPU the wrappers run their plain versions: nothing is launched
    for counts, _ in runs.values():
        assert set(counts.values()) == {0}


def test_chip_smoke_cluster_main_path_rehearsal_on_cpu():
    shape = {"n_sites": 4, "bond": 8, "batch": 4, "mpo": "heisenberg", "path": "cluster"}
    runs = chip_smoke.cluster_main_path(torch.device("cpu"), shape=shape, check=2)
    assert set(runs) == {"mpo_expectation_cluster"}
    counts, _ = runs["mpo_expectation_cluster"]
    assert "mpo_env.cluster" in counts and set(counts.values()) == {0}


def test_chip_smoke_streamed_main_path_rehearsal_on_cpu():
    # the AKLT chain (d 3, W 14) at a tiny size: nothing is launched on the
    # CPU, and the checked samples agree with float64 MPO.expectation
    shape = {"n_sites": 4, "bond": 8, "batch": 4, "mpo": "aklt", "path": "streamed"}
    runs = chip_smoke.streamed_main_path(torch.device("cpu"), shape=shape, check=2)
    assert set(runs) == {"mpo_expectation_streamed"}
    counts, _ = runs["mpo_expectation_streamed"]
    assert "mpo_env.streamed" in counts and set(counts.values()) == {0}


def test_chip_smoke_streamed_chain_main_path_rehearsal_on_cpu():
    # the flagship widened past bond 128 at a tiny size: both entries run
    # their plain versions on the CPU (nothing is launched), and the checked
    # samples agree with float64
    shape = {**chip_smoke.FLAGSHIP_WIDE, "n_sites": 6, "bond": 136, "batch": 4}
    runs = chip_smoke.streamed_chain_main_path(torch.device("cpu"), shape=shape, check=2)
    assert set(runs) == {"mps_evaluate_streamed", "mps_evaluate_epilogue_streamed"}
    for counts, _ in runs.values():
        assert {"mps_evaluate.streamed", "mps_evaluate_epilogue.streamed"} <= set(counts)
        assert set(counts.values()) == {0}
