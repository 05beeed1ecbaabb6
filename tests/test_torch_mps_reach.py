"""Kernels #1 and #2 beyond their tensor-core path, on the CPU.

The CUDA chain kernels take every bond the Pallas kernels take: above bond
128, where a site's core no longer fits a CTA's shared memory, their
streamed path does, and on the card it is held against the plain versions
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).  Here the plain
versions, which the wrappers run for CPU tensors, are held against the
Pallas kernels in interpret mode at such bonds (D 136 and 256; 3 sites,
d 2 and 3, 8 samples), on identical float32 data, to rtol 1e-5 times the
close's condition as in ``tests/test_torch_kernels.py``; the bf16 carry's
log to that file's tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contractn_tpu.models import MPS as JMPS
from contractn_tpu.ops.pallas_epilogue import mps_evaluate_epilogue as j_epilogue
from contractn_tpu.ops.pallas_mps import pallas_mps_evaluate
from contractn_tpu_torch.models import MPS
from contractn_tpu_torch.ops import cuda_epilogue, cuda_mps
from test_torch_kernels import RTOL, _assert_split_close, _close_condition, _t

torch.set_num_threads(1)

N_SITES, BATCH = 3, 8
# each kernel at both bonds and both physical dimensions, crossed apart
CASES = {"mps": [(2, 136), (3, 256)], "epilogue": [(3, 136), (2, 256)]}


def _ids(cases):
    return [f"d{d}-D{bond}" for d, bond in cases]


def _arrays(phys, bond, seed):
    """Cores scaled for an O(1) transfer (as ``chip_smoke.mps_inputs``)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        (rng.standard_normal((N_SITES, phys, bond, bond)) / np.sqrt(phys * bond)).astype(f32),
        rng.standard_normal(bond).astype(f32),
        rng.standard_normal(bond).astype(f32),
        rng.standard_normal((BATCH, N_SITES, phys)).astype(f32),
    )


@pytest.mark.parametrize("phys,bond", CASES["mps"], ids=_ids(CASES["mps"]))
def test_mps_plain_matches_pallas_above_the_tensor_core_path(phys, bond):
    arrays = _arrays(phys, bond, seed=phys + bond)
    assert bond > cuda_mps.MAX_BOND
    ref = pallas_mps_evaluate(*(jnp.asarray(a) for a in arrays), block_b=BATCH,
                              interpret=True)
    before = cuda_mps.cuda_mps_evaluate.launches
    got = cuda_mps.cuda_mps_evaluate(*(_t(a) for a in arrays))
    assert cuda_mps.cuda_mps_evaluate.launches == before  # CPU: plain version
    _assert_split_close(got, ref, RTOL, _close_condition(*(_t(a) for a in arrays)))


@pytest.mark.parametrize("phys,bond", CASES["epilogue"], ids=_ids(CASES["epilogue"]))
def test_epilogue_plain_matches_pallas_above_the_tensor_core_path(phys, bond):
    arrays = _arrays(phys, bond, seed=2 * bond + phys)
    ref = j_epilogue(*(jnp.asarray(a) for a in arrays), interpret=True)
    before = cuda_epilogue.epilogue_chain.launches
    got = cuda_epilogue.mps_evaluate_epilogue(*(_t(a) for a in arrays))
    assert cuda_epilogue.epilogue_chain.launches == before
    _assert_split_close(got, ref, RTOL, _close_condition(*(_t(a) for a in arrays)))


@pytest.mark.parametrize("bond", [136, 256])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_epilogue_plain_bf16_cores_match_pallas_above_the_tensor_core_path(acc, bond):
    # bf16 cores under the fp32 carry: rtol 1e-5 x condition as in fp32; the
    # bf16 carry's log|psi| to a few bf16 ulps a site, as in
    # test_epilogue_plain_bf16_carry_tracks_pallas
    cores, left, right, x = _arrays(2, bond, seed=bond + 5)
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


def test_mps_evaluate_cuda_kernel_at_bond_256_matches_jax():
    # kernel="cuda" on CPU tensors runs the plain version at any bond; the
    # JAX package's counterpart is kernel="pallas" (interpret mode off-TPU)
    cores, left, right, x = _arrays(2, 256, seed=17)
    ref = JMPS(*(jnp.asarray(a) for a in (cores, left, right))).evaluate(
        jnp.asarray(x), kernel="pallas")
    mps = MPS(*(_t(a) for a in (cores, left, right)))
    got = mps.evaluate(_t(x), kernel="cuda")
    _assert_split_close(got, ref, RTOL, _close_condition(*(_t(a) for a in (cores, left, right, x))))


def test_chain_paths_are_counted_and_the_streamed_yardstick_needs_the_card():
    assert cuda_mps.PATHS == (None, "tensor_core", "streamed")
    for fn in (cuda_mps.cuda_mps_evaluate, cuda_epilogue.epilogue_chain):
        assert set(fn.launches_by_path) == set(cuda_mps.PATHS[1:])
    cores, left, right, x = (_t(a) for a in _arrays(2, 136, seed=1))
    for acc in (None, torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            cuda_mps.mps_chain_streamed(cores, left, right, x, acc)
