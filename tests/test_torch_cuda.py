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
from contractn_tpu_torch.ops import cuda_mpo


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernels_match_plain_on_gpu(cuda_device, dtype):
    # #1, and #2 under a float32 and a bfloat16 carry, each launched once
    shape = {"n_sites": 40, "phys": 2, "bond": 64, "batch": 100}
    chip_smoke.compare_chains(shape, cuda_device, dtype, "D=64", seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernel_pads_an_unaligned_bond_on_gpu(cuda_device, dtype):
    # D = 20 fills neither a 32-wide tile nor a 16-byte row of bf16: the
    # wrappers' zero-padded layout carries both
    chip_smoke.compare_chains(chip_smoke.UNALIGNED_MPS, cuda_device, dtype, "D=20", seed=7)


# TFIM at three bonds, then the edges of the tensor-core path's reach:
# Heisenberg (W 5) at D <= 32 and D = 48, W 1, 2 and 4 at D = 64, W 8; then
# two shapes only the exact-D path takes
MPO_SHAPES = [{"n_sites": 8, "bond": bond, "batch": 12} for bond in (32, 48, 20)]
MPO_SHAPES += chip_smoke.REACH_MPO + chip_smoke.EXACT_MPO


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
    # site; d = 900 reads x in place; #1 and #2 alike
    shape = {"n_sites": 7, "phys": phys, "bond": bond, "batch": 40}
    chip_smoke.compare_chains(shape, cuda_device, dtype, f"d={phys} D={bond}", seed=9)


@pytest.mark.cuda
@pytest.mark.parametrize("phys,bond,wdim", [(1, 65, 3), (1, 40, 17), (2, 64, 8)])
def test_mpo_kernel_refuses_shapes_out_of_reach_on_gpu(cuda_device, phys, bond, wdim):
    # D > 64, d*W > 16, and d = 2, W = 8 at D = 64, which fits neither
    # path's shared memory
    cores = torch.zeros((2, 3, phys, bond, bond), device=cuda_device)
    env0 = torch.zeros((wdim * bond, bond), device=cuda_device)
    with pytest.raises(ValueError, match="outside the MPO kernel's reach"):
        cuda_mpo.mpo_env(cores, env0, (), wdim)
