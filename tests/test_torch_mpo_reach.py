"""Kernel #3 beyond its on-chip paths, on the CPU.

The CUDA kernel takes every real shape the Pallas kernel takes: where
neither on-chip path holds a shape (d*W > 16, D > 128) its streamed path
does, and on the card it is held against the plain version
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).  Here the plain
version, which the wrapper runs for CPU tensors, is held against the Pallas
kernel in interpret mode at such shapes, on identical float32 data (3
sites, 2 samples), to rtol 1e-5 times the close's condition as in
``tests/test_torch_kernels.py``.  The spin-1 AKLT MPO that ``chip_smoke.py``
drives on the card is pinned to the open chain's exact ground energy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from contractn_tpu.models import MPO as JMPO
from contractn_tpu.models import heisenberg_mpo as j_heisenberg_mpo
from contractn_tpu.ops.pallas_mpo import mpo_expectation_pallas
from contractn_tpu_torch.convert import mpo_from_numpy
from contractn_tpu_torch.models import heisenberg_mpo
from contractn_tpu_torch.ops import cuda_mpo
from test_torch_kernels import RTOL, _assert_split_close, _mpo_close_condition

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _aklt_arrays(n, dtype=torch.float32):
    mpo = chip_smoke.aklt_mpo(n, CPU, dtype)
    return tuple(t.numpy() for t in (mpo.cores, mpo.left, mpo.right))


def _diagonal_arrays(n, phys, wdim, rng):
    """A uniform MPO diagonal in the physical index with nonnegative
    channel entries and ends (``chip_smoke.mpo_inputs``'s ``(d, W)`` kind)."""
    core = np.zeros((phys, phys, wdim, wdim), np.float32)
    for p in range(phys):
        core[p, p] = np.abs(rng.standard_normal((wdim, wdim))) / np.sqrt(wdim)
    ends = (0.5 + rng.random((2, wdim))).astype(np.float32)
    return np.broadcast_to(core, (n, *core.shape)).copy(), ends[0], ends[1]


# d*W 17, 18, 24 and 42 (the AKLT chain), and D 136 > 128
CASES = [((1, 17), 8), ((3, 6), 8), ((4, 6), 16), ("aklt", 8), ("heisenberg", 136)]


@pytest.mark.parametrize("kind,bond", CASES,
                         ids=["d1-W17-D8", "d3-W6-D8", "d4-W6-D16", "aklt-D8",
                              "heisenberg-D136"])
def test_mpo_plain_matches_pallas_beyond_the_on_chip_paths(kind, bond):
    n, batch = 3, 2
    rng = np.random.default_rng(31)
    if kind == "heisenberg":
        jmpo = j_heisenberg_mpo(n, dtype=jnp.float32)
        mpo = heisenberg_mpo(n, dtype=torch.float32, device="cpu")
    else:
        w, left, right = (_aklt_arrays(n) if kind == "aklt"
                          else _diagonal_arrays(n, *kind, rng))
        jmpo = JMPO(jnp.asarray(w), jnp.asarray(left), jnp.asarray(right))
        mpo = mpo_from_numpy(w, left, right, device="cpu")
    phys, wdim = mpo.cores.shape[1], mpo.cores.shape[3]
    assert phys * wdim > cuda_mpo.MAX_MIX or bond > cuda_mpo.MAX_BOND
    cores = ((phys * bond) ** -0.5
             * rng.standard_normal((batch, n, phys, bond, bond))).astype(np.float32)
    ones = np.ones(bond, np.float32)
    ref = mpo_expectation_pallas(jmpo, jnp.asarray(cores), jnp.asarray(ones),
                                 jnp.asarray(ones), btile=2, interpret=True)
    cores_t, ones_t = torch.from_numpy(cores), torch.from_numpy(ones)
    before = cuda_mpo.mpo_env.launches
    got = cuda_mpo.mpo_expectation_cuda(mpo, cores_t, ones_t, ones_t)
    assert cuda_mpo.mpo_env.launches == before
    _assert_split_close(got, ref, RTOL, _mpo_close_condition(mpo, cores_t, ones_t))


def test_aklt_mpo_gives_the_open_chain_ground_energy():
    # H = sum S.S + (S.S)^2 / 3 = sum (2 P_2 - 2/3): on 4 sites the ground
    # energy is -(2/3) 3 = -2, fourfold (the two free edge spins 1/2)
    w, left, right = _aklt_arrays(4, torch.float64)
    h = np.einsum("a,ABab,CDbc,EFcd,GHde,e->ACEGBDFH", left, *w, right,
                  optimize=True).reshape(81, 81)
    np.testing.assert_array_equal(h, h.T)
    energies = np.linalg.eigvalsh(h)
    np.testing.assert_allclose(energies[:4], -2.0, rtol=0, atol=1e-12)
    assert energies[4] > -2.0 + 0.5


def test_mix_matrix_is_the_dense_entry_matrix():
    # M[v*d + p, e*W + w] = W[p, e, w, v] at its real size (d*W)^2, which
    # the streamed path reads from device memory
    w, left, right = _aklt_arrays(2)
    mpo = mpo_from_numpy(w, left, right, device="cpu")
    mix = cuda_mpo._mix_matrix(cuda_mpo.mpo_entries(mpo), 3, 14)
    np.testing.assert_array_equal(mix, w[0].transpose(3, 0, 1, 2).reshape(42, 42))
    assert np.count_nonzero(mix) == len(cuda_mpo.mpo_entries(mpo)) == 42


def test_streamed_path_is_counted_and_its_yardstick_needs_the_card():
    assert cuda_mpo.PATHS == (None, "tensor_core", "cluster", "streamed")
    assert set(cuda_mpo.mpo_env.launches_by_path) == set(cuda_mpo.PATHS[1:])
    cores = torch.zeros((2, 3, 1, 8, 8))
    env0 = torch.zeros((17 * 8, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_mpo.mpo_env_streamed(cores, env0, (), 17)
