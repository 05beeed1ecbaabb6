"""The hand-written CUDA kernels against their plain torch versions, on a GPU.

Needs an NVIDIA GPU and nvcc, and skips without them.  This file imports
neither JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: log|psi| within the stated
tolerance times each sample's condition number.  The last tests hold the
training paths on the card: a gradient through ``MPS.evaluate`` is kept
(the differentiable loop runs, not the kernel) and the steps leave every
tensor on the GPU.
"""

import pytest
import torch

import chip_smoke
from contractn_tpu_torch.ops import cuda_mpo, cuda_mps


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
# the shapes only the cluster path takes, up to D = 128, and those only the
# streamed path takes
MPO_SHAPES = [{"n_sites": 8, "bond": bond, "batch": 12} for bond in (32, 48, 20)]
MPO_SHAPES += (chip_smoke.REACH_MPO + chip_smoke.EXACT_MPO + chip_smoke.CLUSTER_MPO
               + chip_smoke.STREAMED_MPO)
# each shape in the dtypes it is held in (both, unless it names them)
MPO_CASES = [(shape, dtype) for shape in MPO_SHAPES
             for dtype in shape.get("dtypes", (torch.float32, torch.bfloat16))]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,dtype", MPO_CASES,
    ids=[f"{s.get('mpo', 'tfim')}-D{s['bond']}-{str(dt)[6:]}" for s, dt in MPO_CASES])
def test_mpo_kernel_matches_plain_on_gpu(cuda_device, dtype, shape):
    tol = chip_smoke.TOL_F32 if dtype == torch.float32 else chip_smoke.TOL_BF16
    chip_smoke.compare_mpo_env(shape, cuda_device, dtype, tol,
                               f"mpo_env {shape.get('mpo', 'tfim')} D={shape['bond']}",
                               seed=6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("phys,bond", [(3, 96), (3, 128), (20, 24), (900, 4), (2, 129),
                                       (2, 192), (2, 256), (2, 520)])
def test_chain_kernel_reach_on_gpu(cuda_device, dtype, phys, bond):
    # d = 3 at D > 64 (fp32) and d = 20 run a core ring shorter than one
    # site; d = 900 reads x in place; bonds above 128 run the streamed path
    # (200 samples: four row tiles, the last one ragged, and enough that
    # some are conditioned for bf16); #1 and #2 alike
    path = "streamed" if bond > cuda_mps.MAX_BOND else "tensor_core"
    shape = {"n_sites": 7, "phys": phys, "bond": bond, "batch": 200 if bond > 128 else 40,
             "path": path}
    chip_smoke.compare_chains(shape, cuda_device, dtype, f"d={phys} D={bond}", seed=9)


@pytest.mark.cuda
def test_chain_kernel_path_choice_on_gpu(cuda_device):
    # the tensor-core path keeps every shape it takes (every d at 1 <= D <= 128:
    # exactly where it reports a shared-memory plan), the streamed path takes
    # every other one; a zero dimension has no path and raises ValueError
    lib = cuda_mps.tc_library()
    for bf16 in (0, 1):
        for d in range(1, 65):
            for bond in range(1, 521):
                planned = lib.cn_mps_evaluate_smem(bf16, d, bond) >= 0
                assert planned == (bond <= cuda_mps.MAX_BOND), (bf16, d, bond)
                assert lib.cn_mps_path(bf16, d, bond) == (1 if planned else 2), (bf16, d, bond)
    assert lib.cn_mps_path(0, 0, 64) == lib.cn_mps_path(1, 2, 0) == 0
    zero = torch.zeros((3, 0, 8, 8), device=cuda_device)
    with pytest.raises(ValueError, match="take d and D >= 1"):
        cuda_mps.cuda_mps_evaluate(zero, torch.zeros(8, device=cuda_device),
                                   torch.zeros(8, device=cuda_device),
                                   torch.zeros((2, 3, 0), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [chip_smoke.SMALL_MPS, chip_smoke.UNALIGNED_MPS,
                                   *chip_smoke.REACH_MPS],
                         ids=lambda s: f"d{s['phys']}-D{s['bond']}")
def test_chain_streamed_yardstick_matches_plain_on_gpu(cuda_device, dtype, shape):
    # the streamed path at shapes the entries give the tensor-core path
    chip_smoke.compare_streamed_yardstick(shape, cuda_device, dtype,
                                          f"d={shape['phys']} D={shape['bond']}", seed=10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("phys,bond,wdim", [(1, 40, 17), (2, 129, 5), (1, 129, 1)])
def test_mpo_kernel_streams_the_shapes_it_once_refused_on_gpu(cuda_device, dtype, phys,
                                                             bond, wdim):
    # d*W > 16 and D > 128, refused before the streamed path: now launched
    # there and held against the plain version (random diagonal MPOs; the
    # comparison needs samples whose close is conditioned enough, so 128)
    shape = {"n_sites": 3, "bond": bond, "batch": 128, "mpo": (phys, wdim), "path": "streamed"}
    tol = chip_smoke.TOL_F32 if dtype == torch.float32 else chip_smoke.TOL_BF16
    chip_smoke.compare_mpo_env(shape, cuda_device, dtype, tol,
                               f"mpo_env d={phys} W={wdim} D={bond}", seed=7)


@pytest.mark.cuda
def test_mpo_kernel_reach_on_gpu(cuda_device):
    # every d*W <= 64 up to D 256, in both dtypes, has a path; the on-chip
    # paths keep every shape they took (all of d*W <= 16 to D 128 but fp32
    # d 15-16 with W 1 at D 113-128), and the streamed path takes the rest
    lib = cuda_mpo.library()
    no_plan = {(0, d, 1, bond) for d in (15, 16) for bond in range(113, 129)}
    for bf16 in (0, 1):
        for d in range(1, 65):
            for w in range(1, 64 // d + 1):
                for bond in range(1, 257):
                    path = lib.cn_mpo_env_path(bf16, d, bond, w)
                    on_chip = d * w <= 16 and bond <= 128 and (bf16, d, w, bond) not in no_plan
                    assert path in ((1, 2) if on_chip else (3,)), (bf16, d, w, bond, path)
                    if path == 3:  # laid out at its own bond, no padding
                        assert lib.cn_mpo_env_bond(bf16, d, bond, w) == bond
    assert lib.cn_mpo_env_path(0, 0, 64, 5) == lib.cn_mpo_env_path(1, 2, 0, 5) == 0
    assert lib.cn_mpo_env_path(0, 2, 64, 0) == 0
    # so mpo_env raises ValueError for such dimensions alone
    with pytest.raises(ValueError, match="takes d, D and W >= 1"):
        cuda_mpo.mpo_env(torch.zeros((2, 3, 0, 8, 8), device=cuda_device),
                         torch.zeros((40, 8), device=cuda_device), (), 5)


@pytest.mark.cuda
def test_auto_gradient_on_gpu_matches_cpu_and_launches_nothing(cuda_device):
    # log|psi| through MPS.evaluate("auto") keeps its gradient on the card:
    # the differentiable loop runs, and #1 is not launched
    from contractn_tpu_torch.models import MPS

    gen = torch.Generator().manual_seed(3)
    cores = torch.randn((24, 2, 64, 64), generator=gen) / (2 * 64) ** 0.5
    left, right = torch.randn(64, generator=gen), torch.randn(64, generator=gen)
    x = torch.randn((48, 24, 2), generator=gen)
    # float32 on two devices differs in rounding order only: as in
    # chip_smoke.grad_check, on the samples whose log|psi| float32 determines
    cond = chip_smoke.mps_condition(cores, left, right, x)
    x = x[chip_smoke.TOL_F32 * cond <= 1]
    grads = []
    for dev in (torch.device("cpu"), cuda_device):
        params = [t.to(dev).requires_grad_(True) for t in (cores, left, right)]
        before = cuda_mps.cuda_mps_evaluate.launches
        val = MPS(*params).log_abs_amplitude(x.to(dev)).sum()
        assert cuda_mps.cuda_mps_evaluate.launches == before
        grads.append(torch.cat([g.cpu().reshape(-1)
                                for g in torch.autograd.grad(val, params)]).double())
    rel = float((grads[1] - grads[0]).norm() / grads[0].norm())
    assert rel <= chip_smoke.TOL_GRAD, rel
    with torch.no_grad():
        before = cuda_mps.cuda_mps_evaluate.launches
        MPS(*(t.to(cuda_device) for t in (cores, left, right))).log_abs_amplitude(
            x.to(cuda_device))
        assert cuda_mps.cuda_mps_evaluate.launches == before + 1


@pytest.mark.cuda
def test_training_steps_stay_on_gpu(cuda_device):
    from contractn_tpu_torch.models import MPS, born_machine, fit_born_machine
    from contractn_tpu_torch.parallel import make_train_step

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    mps = MPS.random(9, 2, 16, generator=gen, device=cuda_device)
    x = torch.randn((32, 9, 2), generator=gen, device=cuda_device)
    before = cuda_mps.cuda_mps_evaluate.launches
    new, loss = make_train_step(lr=1e-3)(mps, x, torch.zeros(32, device=cuda_device))
    assert cuda_mps.cuda_mps_evaluate.launches == before
    assert {t.device.type for t in (new.cores, new.left, new.right, loss)} == {"cuda"}
    model = born_machine(8, 2, 8, dtype=torch.float32, generator=gen, device=cuda_device)
    data = torch.randint(0, 2, (64, 8), generator=gen, device=cuda_device)
    trained, losses = fit_born_machine(model, data, steps=1, lr=1e-3)
    assert {t.device.type for t in (trained.cores, trained.left, trained.right, losses)} == {
        "cuda"}


# Phase 8 of chip_smoke.py at a reduced depth: the exact 10-site spin-1 ground
# energy (-12.8945601, sparse exact diagonalization) stands in for the
# published 100-site value; bond 24 truncates it by about 3e-5 (-12.8945313
# on the CPU)
CHAINS_SMALL = {
    "spin1": {"n_sites": 10, "bond": 24, "sweeps": 4, "serve_batch": 256,
              "published": -12.8945601, "published_tol": 1e-4, "seed": 3},
    "tfim": {"n_sites": 24, "h": 1.0, "bond": 24, "sweeps": 4, "rtol": 1e-8, "seed": 4},
    "ensemble": {"n_members": 8, "h": (0.5, 1.5), "n_sites": 12, "bond": 16,
                 "sweeps": 4, "rtol": 1e-7, "seed": 5},
    "quench": {"h": 0.5, "dt": 0.05, "steps": 3, "drift_tol": 1e-7, "norm_tol": 1e-10},
    "itebd": {"bond": 16, "tol": 5e-4},
    "opsum": {"n_sites": 24, "bond": 8, "rtol": 1e-10, "seed": 6},
    "svd": {"rows": 96, "reps": 3},
}


@pytest.mark.cuda
def test_finite_chains_on_gpu(cuda_device):
    # every phase-8 check, and #1 launched exactly once (serving the ground
    # state) while no other path launches a hand kernel
    runs = chip_smoke.finite_chains(cuda_device, "test", CHAINS_SMALL)
    assert runs["serve_spin1"][0]["mps_evaluate"] == 1


@pytest.mark.cuda
def test_physics_chains_on_gpu(cuda_device):
    # phase 9 at its rehearsal size: every check, and #1 launched exactly
    # once on each of the two serving paths and on no other
    runs = chip_smoke.physics_chains(cuda_device, "test", chip_smoke.PHYSICS_TINY)
    assert runs["serve_hubbard"][0]["mps_evaluate"] == 1
    assert runs["quantics_dense"][0]["mps_evaluate"] == 1


@pytest.mark.cuda
def test_infinite_chains_on_gpu(cuda_device):
    # phase 10 at its rehearsal size: every check (card against CPU where
    # the phase compares them), and #1 launched exactly once, serving the
    # hydrogen-chain ground state
    runs = chip_smoke.infinite_chains(cuda_device, "test", chip_smoke.INFINITE_TINY)
    assert runs["serve_h_chain"][0]["mps_evaluate"] == 1


@pytest.mark.cuda
def test_peps2d_paths_on_gpu(cuda_device):
    # phase 12 at its rehearsal size: every check (card against CPU where the
    # phase compares them, the scan's vmap of cuSOLVER SVDs), no hand kernel
    runs = chip_smoke.peps2d_paths(cuda_device, "test", chip_smoke.PEPS2D_TINY)
    assert all(not any(counts.values()) for counts, _ in runs.values())


@pytest.mark.cuda
def test_three_d_paths_on_gpu(cuda_device):
    # phase 13 at its rehearsal size: every check (card against CPU where the
    # phase compares them, the 3D merge's GEMM chain), no hand kernel
    runs = chip_smoke.three_d_ttn_paths(cuda_device, "test", chip_smoke.THREE_D_TINY)
    assert all(not any(counts.values()) for counts, _ in runs.values())


@pytest.mark.cuda
def test_parallel_paths_on_gpu(cuda_device):
    # phase 14 at its rehearsal size in a world of one rank over NCCL: every
    # path against its single-device counterpart; only the evaluation the
    # sharded forward is held against launches #1
    runs = chip_smoke.parallel_phase(cuda_device, "test", chip_smoke.PARALLEL_TINY)
    for path, (counts, _) in runs.items():
        assert counts["mps_evaluate"] == int(path == "forward_reference"), path
    assert not torch.distributed.is_initialized()


@pytest.mark.cuda
def test_contract_gradient_lands_on_the_operand_device(cuda_device):
    import contractn_tpu_torch as ttn

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    a = torch.randn((3, 4), generator=gen, device=cuda_device, requires_grad=True)
    b = torch.randn((4, 5), generator=gen, device=cuda_device)
    out = ttn.contract("ab,bc->ac", a, b)
    (grad,) = torch.autograd.grad(out.sum(), a)
    assert out.device.type == grad.device.type == "cuda"
    torch.testing.assert_close(grad, b.sum(1).expand(3, 4))
