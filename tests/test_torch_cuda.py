"""The hand-written CUDA kernels against their plain torch versions, on a GPU.

Needs an NVIDIA GPU and nvcc, and skips without them.  This file imports
neither JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: log|psi| within the stated
tolerance times each sample's condition number.
"""

import pytest
import torch

import chip_smoke
from contractn_tpu_torch.ops import cuda_epilogue, cuda_mpo, cuda_mps


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernels_match_plain_on_gpu(cuda_device, dtype):
    tol = chip_smoke.TOL_F32 if dtype == torch.float32 else chip_smoke.TOL_BF16
    shape = {"n_sites": 40, "phys": 2, "bond": 64, "batch": 100}
    cores, left, right, x = chip_smoke.mps_inputs(shape, cuda_device, dtype, seed=5)
    cond = chip_smoke.mps_condition(cores, left, right, x)
    before = cuda_mps.cuda_mps_evaluate.launches
    chip_smoke.compare_split(cuda_mps.cuda_mps_evaluate(cores, left, right, x),
                             cuda_mps.mps_evaluate_plain(cores, left, right, x),
                             tol, "mps_evaluate", cond)
    assert cuda_mps.cuda_mps_evaluate.launches == before + 1
    for acc in (torch.float32, torch.bfloat16):
        v_got, l_got = cuda_epilogue.epilogue_chain(cores, left, x, acc)
        v_ref, l_ref = cuda_epilogue.epilogue_chain_plain(cores, left, x, acc)
        chip_smoke.compare_split((v_got.float() @ right, l_got),
                                 (v_ref.float() @ right, l_ref),
                                 max(tol, chip_smoke.TOL_F32 if acc == torch.float32
                                     else chip_smoke.TOL_BF16), "epilogue_chain", cond)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernel_pads_an_unaligned_bond_on_gpu(cuda_device, dtype):
    # D = 20 fills neither a 32-wide tile nor a 16-byte row of bf16: the
    # wrapper's zero-padded layout carries both
    tol = chip_smoke.TOL_F32 if dtype == torch.float32 else chip_smoke.TOL_BF16
    shape = {"n_sites": 9, "phys": 2, "bond": 20, "batch": 33}
    cores, left, right, x = chip_smoke.mps_inputs(shape, cuda_device, dtype, seed=7)
    chip_smoke.compare_split(cuda_mps.cuda_mps_evaluate(cores, left, right, x),
                             cuda_mps.mps_evaluate_plain(cores, left, right, x),
                             tol, "mps_evaluate D=20",
                             chip_smoke.mps_condition(cores, left, right, x))


# TFIM at three bonds, then the edges of the kernel's reach: Heisenberg (W 5)
# at D <= 32 and D = 48, W 1, 2 and 4 at D = 64, W 8
MPO_SHAPES = [{"n_sites": 8, "bond": bond, "batch": 12} for bond in (32, 48, 20)]
MPO_SHAPES += chip_smoke.REACH_MPO


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MPO_SHAPES,
                         ids=lambda s: f"{s.get('mpo', 'tfim')}-D{s['bond']}")
def test_mpo_kernel_matches_plain_on_gpu(cuda_device, dtype, shape):
    tol = chip_smoke.TOL_F32 if dtype == torch.float32 else chip_smoke.TOL_BF16
    chip_smoke.compare_mpo_env(shape, cuda_device, dtype, tol,
                               f"mpo_env {shape.get('mpo', 'tfim')} D={shape['bond']}",
                               seed=6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("phys,bond", [(3, 96), (3, 128), (20, 24), (900, 4)])
def test_chain_kernel_reach_on_gpu(cuda_device, dtype, phys, bond):
    # d = 3 at D > 64 (fp32) and d = 20 run a core ring shorter than one
    # site; d = 900 reads x in place
    tol = chip_smoke.TOL_F32 if dtype == torch.float32 else chip_smoke.TOL_BF16
    shape = {"n_sites": 7, "phys": phys, "bond": bond, "batch": 40}
    cores, left, right, x = chip_smoke.mps_inputs(shape, cuda_device, dtype, seed=9)
    chip_smoke.compare_split(cuda_mps.cuda_mps_evaluate(cores, left, right, x),
                             cuda_mps.mps_evaluate_plain(cores, left, right, x),
                             tol, f"mps_evaluate d={phys} D={bond}",
                             chip_smoke.mps_condition(cores, left, right, x))


@pytest.mark.cuda
def test_mpo_kernel_refuses_shapes_out_of_reach_on_gpu(cuda_device):
    # W = 9 at D > 32 has more bra tiles than a warp keeps
    cores = torch.zeros((2, 3, 1, 40, 40), device=cuda_device)
    env0 = torch.zeros((9 * 40, 40), device=cuda_device)
    with pytest.raises(ValueError, match="outside the MPO kernel's reach"):
        cuda_mpo.mpo_env(cores, env0, (), 9)
