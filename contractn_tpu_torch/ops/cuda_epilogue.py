"""Hand-written CUDA kernel: batched MPS chain returning the carry.

Replaces the Pallas TPU kernel ``contractn_tpu/ops/pallas_epilogue.py``
(``mps_evaluate_epilogue`` -> ``_kernel``).  The CUDA source is
``csrc/mps_chain_tc.cu`` (entry ``cn_mps_epilogue``): the chain kernel of
:mod:`.cuda_mps` in its carry modes, on the same two paths, picked by the
library from the shape (:func:`.cuda_mps.chain_path`): up to bond 128 one
CTA per 32-row batch tile walks every site with the carry on chip, each
site's GEMM on ``mma.sync`` and the coming cores fetched by the TMA; above
it the carry lives in device memory between sites, one launch a site
(:func:`.cuda_mps.chain_launch` lays out the operands of either).  What
differs from #1, as in the Pallas kernel it replaces:

* the carry is ``acc_dtype`` (float32 or bfloat16) and starts from
  ``left`` cast to the core dtype; the GEMM accumulates in fp32 and its
  result is rounded to ``acc_dtype``, as is every elementwise step after it;
* the rescale guard is ``mean > MIN_NORM`` (not ``MIN_NORM / D``);
* the kernel returns the carry ``(B, D)`` and an fp32 log; the close with
  ``right`` and the final ``|amp|`` rescale run outside in fp32, and the
  amplitude is cast to the core dtype.

CUDA tensors go through the kernel (counted in
``epilogue_chain.launches`` and, by path, ``epilogue_chain.launches_by_path``)
or raise; CPU tensors run :func:`epilogue_chain_plain`.  Neither entry point
takes operands autograd would record through: the kernel has no backward.
The Pallas wrapper's ``sites_per_step`` and ``interpret`` are TPU knobs and
are not taken; ``acc_dtype`` is semantic and stays.
"""

import torch

from ..utils.errors import check_no_autograd
from .cuda_mps import PATHS, chain_launch, chain_path, check_chain_args
from .stabilize import MIN_NORM


def _acc_dtype(acc_dtype):
    acc = torch.float32 if acc_dtype is None else acc_dtype
    if acc not in (torch.float32, torch.bfloat16):
        raise TypeError(f"acc_dtype must be float32 or bfloat16, got {acc}")
    return acc


def epilogue_chain_plain(cores, left, x, acc_dtype=None):
    """Plain torch version of the kernel: returns ``(v, log)``, ``v`` of
    shape ``(B, D)`` in ``acc_dtype`` and ``log`` of shape ``(B,)`` fp32."""
    acc = _acc_dtype(acc_dtype)
    check_chain_args(cores, left, None, x)
    n_sites, phys, bond, _ = cores.shape
    mats = cores.permute(0, 2, 1, 3).reshape(n_sites, bond, phys * bond)
    v = left.to(cores.dtype).to(acc).expand(x.shape[0], bond)
    log = torch.zeros(x.shape[0], 1, dtype=torch.float32, device=cores.device)
    for s in range(n_sites):
        # operands in the core dtype, fp32 accumulation, result in acc
        z = torch.matmul(v.to(cores.dtype).float(), mats[s].float()).to(acc)
        w = x[:, s].to(acc)
        a = z[:, 0:bond] * w[:, 0:1]
        for k in range(1, phys):
            a = a + z[:, k * bond:(k + 1) * bond] * w[:, k:k + 1]
        norm = a.abs().sum(dim=1, keepdim=True) / bond
        safe = torch.where(norm > MIN_NORM, norm, torch.ones_like(norm))
        v = a / safe
        log = log + torch.log(safe.float())
    return v, log[:, 0]


def epilogue_chain(cores, left, x, acc_dtype=None):
    """Launch wrapper: ``(v, log)`` from the chain kernel (CUDA tensors,
    counted in ``epilogue_chain.launches`` and by path in
    ``epilogue_chain.launches_by_path``) or its plain version (CPU).
    Raises ``TNError`` where autograd would record through it."""
    acc = _acc_dtype(acc_dtype)
    check_chain_args(cores, left, None, x)
    check_no_autograd("epilogue_chain", cores, left, x)
    if cores.device.type == "cpu":
        return epilogue_chain_plain(cores, left, x, acc)
    if cores.device.type != "cuda":
        raise ValueError(f"unsupported device {cores.device}")
    path = chain_path(cores)
    out = chain_launch("cn_mps_epilogue", path, cores, left, None, x, acc)
    epilogue_chain.launches += 1
    epilogue_chain.launches_by_path[path] += 1
    return out


def mps_evaluate_epilogue(cores, left, right, x, acc_dtype=None):
    """Batched MPS evaluation through the carry-returning chain kernel.

    Args:
        cores: ``(N, d, D, D)`` stacked site tensors (bf16/f32).
        left, right: ``(D,)`` boundary vectors.
        x: ``(B, N, d)`` input weights.
        acc_dtype: carry dtype, ``torch.float32`` (default) or
            ``torch.bfloat16``.

    Returns:
        Split-format ``(amp, log)`` of shape ``(B,)``; ``amp`` in the core
        dtype, ``log`` in float32.

    Raises ``TNError`` where autograd would record through it (the kernel
    has no backward).
    """
    check_no_autograd("mps_evaluate_epilogue", cores, left, right, x)
    v, log = epilogue_chain(cores, left, x, acc_dtype)
    amp = torch.matmul(v.float(), right.float())
    norm = amp.abs()
    safe = torch.where(norm > MIN_NORM, norm, torch.ones_like(norm))
    return (amp / safe).to(cores.dtype), log + torch.log(safe)


epilogue_chain.launches = 0
epilogue_chain.launches_by_path = dict.fromkeys(PATHS[1:], 0)
