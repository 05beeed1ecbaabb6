"""The 3xTF32 split arithmetic of the port's tensor-core kernels, on the CPU.

``contractn_tpu_torch/ops/tensor_core.py`` emulates ``cvt.rna.tf32.f32`` and
the three-pass product that ``csrc/mps_chain_tc.cu`` and ``csrc/mpo_env.cu``
run for fp32 cores.  Held against a float64 matmul at the kernels' bond
(D = 64): the three-pass product agrees to rtol 1e-6 of sum |a||b| (the
dropped lo*lo term is ~2**-22 relative, fp32 accumulation over 64 terms
adds a few ulps), while one TF32 pass misses by ~2e-4 (11 significant bits).
"""

import numpy as np
import pytest
import torch

from contractn_tpu_torch.ops.tensor_core import (
    matmul_3xtf32,
    matmul_tf32,
    split_tf32,
    tf32_round,
)

RTOL_3X = 1e-6


def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, 0.0, -0.0, 2.0 - ulp / 4], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0, -0.0, 2.0]
    got = tf32_round(x)
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.float32))
    assert torch.signbit(got[5])
    # 10 explicit mantissa bits survive: the low 13 are zero
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    assert int((tf32_round(y).view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_split_recovers_fp32_to_2e_22():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    hi, lo = split_tf32(x)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_product_is_fp32_accurate_and_one_pass_is_not(seed):
    rng = np.random.default_rng(seed)
    bond = 64
    a = rng.standard_normal((96, bond)).astype(np.float32)
    b = rng.standard_normal((bond, 2 * bond)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err3 = np.abs(matmul_3xtf32(ta, tb).double().numpy() - ref) / scale
    err1 = np.abs(matmul_tf32(ta, tb).double().numpy() - ref) / scale
    err_fp32 = np.abs((ta @ tb).double().numpy() - ref) / scale
    assert err3.max() <= RTOL_3X
    assert err3.max() <= 4 * err_fp32.max() + 1e-7  # as good as an fp32 matmul
    assert err1.max() >= 50 * RTOL_3X  # one TF32 pass is not fp32-accurate


def test_bond_alignment_and_zero_padding_leave_the_chain_unchanged():
    from contractn_tpu_torch.ops.cuda_mpo import aligned_bond, pad_bond
    from contractn_tpu_torch.ops.cuda_mps import mps_evaluate_plain

    assert [aligned_bond(b, torch.float32) for b in (20, 21, 40, 64)] == [20, 24, 40, 64]
    assert [aligned_bond(b, torch.bfloat16) for b in (20, 24, 40, 64)] == [24, 24, 40, 64]
    rng = np.random.default_rng(3)
    n, d, bond, batch = 7, 2, 21, 5
    cores = torch.from_numpy((0.3 * rng.standard_normal((n, d, bond, bond))).astype(np.float32))
    left, right = (torch.from_numpy(rng.standard_normal(bond).astype(np.float32))
                   for _ in range(2))
    x = torch.from_numpy(rng.standard_normal((batch, n, d)).astype(np.float32))
    pad = aligned_bond(bond, torch.float32) - bond
    padded = pad_bond(cores, pad, 2)
    assert padded.shape == (n, d, bond + pad, bond + pad)
    amp, lg = mps_evaluate_plain(cores, left, right, x)
    amp_p, lg_p = mps_evaluate_plain(padded, pad_bond(left, pad, 1), pad_bond(right, pad, 1), x)
    # only the split moves (the L1 mean divides by the padded width): the
    # amplitudes agree as values
    np.testing.assert_allclose((amp_p.double() * torch.exp(lg_p.double() - lg.double())).numpy(),
                               amp.double().numpy(), rtol=1e-5)
