"""Hand-written CUDA kernel: fused stabilized batched MPS evaluation.

Replaces the Pallas TPU kernel ``contractn_tpu/ops/pallas_mps.py``
(``pallas_mps_evaluate`` -> ``_mps_kernel``).  The CUDA source is
``csrc/mps_chain_tc.cu`` (entry ``cn_mps_evaluate``, the close mode of the
template that also serves :mod:`.cuda_epilogue`); its header states the
bound on an H100 (the chain's ``2*B*N*d*D^2`` GEMM FLOPs run as 3xTF32 on the
tensor cores for fp32 cores, one bf16 pass for bf16) and the design: one CTA
per 32-row batch tile walks every site with the fp32 carry on chip, each
site's GEMM on ``mma.sync``, the coming cores fetched by the TMA
(``cp.async.bulk``, one copy per physical index of a site) into a ring of
shared-memory slots while the current site computes.  For those single
copies the wrapper lays the cores out as ``(N, d, DP, LD)``, zero-padded,
with ``DP`` and ``LD`` from the library (``cn_mps_core_rows``,
``cn_mps_core_ld``): the shared-memory layout the kernel reads without bank
conflicts.  That copy is made on every call (:func:`tc_operands`, shared with
:mod:`.cuda_epilogue`).

The kernel has no backward, as the Pallas kernel has no VJP: the wrapper
raises where autograd would record through it (``MPS.evaluate`` with
``kernel="auto"`` takes the differentiable loop then).

Semantics (pinned against the Pallas kernel in interpret mode on the CPU):

* per site ``u = v @ A_n`` with the fp32 carry cast to the core dtype
  before the product and fp32 accumulation, then ``v = sum_k x[:, k] u_k``;
* per-row L1-mean rescale with guard ``mean > MIN_NORM / D`` (i.e. sum >
  MIN_NORM) and an fp32 log register;
* close ``amp = v . r`` and a ``|amp|`` rescale with guard ``> MIN_NORM``.

Outputs ``(amp, log)`` are fp32 of shape ``(B,)`` whatever the core dtype.

:func:`cuda_mps_evaluate` launches the kernel for CUDA tensors (or raises:
there is no fallback) and runs :func:`mps_evaluate_plain` — the same
arithmetic in plain torch — for CPU tensors.  The TPU tiling knobs of the
Pallas wrapper (``block_b``, ``sites_per_step``, ``interpret``) have no
meaning here and are not taken.
"""

import ctypes

import numpy as np
import torch

from ..utils.errors import check_no_autograd
from . import _build
from .stabilize import MIN_NORM

_TC_SIGNATURES = {
    "cn_mps_evaluate": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p,
    ],
    "cn_mps_epilogue": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ],
    "cn_mps_core_rows": [ctypes.c_int],
    "cn_mps_core_ld": [ctypes.c_int],
    "cn_mps_evaluate_smem": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
}

MAX_BOND = 128  # widest bond the chain kernels take


def tc_library():
    """The built ``csrc/mps_chain_tc.cu`` library (kernels #1 and #2)."""
    return _build.load("mps_chain_tc", _TC_SIGNATURES)


def f32(value):
    """A Python float rounded to float32, as a ctypes argument."""
    return ctypes.c_float(float(np.float32(value)))


def check_chain_args(cores, left, right, x):
    """Validate the chain kernels' operands; returns ``(N, d, D, B)``."""
    if cores.ndim != 4 or cores.shape[2] != cores.shape[3]:
        raise ValueError(f"cores must be (N, d, D, D), got {tuple(cores.shape)}")
    n_sites, phys, bond, _ = cores.shape
    if x.ndim != 3 or tuple(x.shape[1:]) != (n_sites, phys):
        raise ValueError(
            f"x must be (B, {n_sites}, {phys}), got {tuple(x.shape)}"
        )
    for name, vec in (("left", left), ("right", right)):
        if vec is not None and tuple(vec.shape) != (bond,):
            raise ValueError(f"{name} must be ({bond},), got {tuple(vec.shape)}")
    if any(t is not None and t.is_complex() for t in (cores, left, right, x)):
        raise TypeError("the MPS chain kernels take real tensors only")
    return n_sites, phys, bond, x.shape[0]


def tc_operands(cores, tensors, phys, bond):
    """Checks and core layout before a launch of the tensor-core chain
    kernels (#1 and #2): returns ``(library, bf16 flag, cores laid out)``.

    Raises on a dtype, device, layout or size the kernels do not take.  The
    cores are zero-padded to ``(N, d, DP, LD)`` with ``DP`` and ``LD`` from
    the library, the layout the kernel copies into shared memory one block
    at a time; the copy is made on every call.
    """
    if cores.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"CUDA MPS kernels take float32 or bfloat16 cores, got {cores.dtype}"
        )
    for t in (cores, *tensors):
        if t.device != cores.device:
            raise ValueError("all operands must be on the cores' device")
    if not cores.is_contiguous():
        raise ValueError("cores must be contiguous (N, d, D, D)")
    if bond > MAX_BOND:
        raise ValueError(f"CUDA MPS kernels take bond <= {MAX_BOND}, got {bond}")
    lib = tc_library()
    bf16 = int(cores.dtype == torch.bfloat16)
    smem = lib.cn_mps_evaluate_smem(bf16, phys, bond)
    if smem < 0 or smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"d={phys}, D={bond} needs {smem} bytes of shared memory per block "
            f"(limit {_build.SMEM_LIMIT})"
        )
    rows, ld = lib.cn_mps_core_rows(bond), lib.cn_mps_core_ld(bond)
    return lib, bf16, torch.nn.functional.pad(cores, (0, ld - bond, 0, rows - bond))


def f32_input(x):
    """``x`` as contiguous float32 (the kernels read their inputs in fp32;
    converting bf16/f16 is exact, and f64 is what the kernel would do)."""
    x = x.to(torch.float32)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (B, N, d)")
    return x


def mps_evaluate_plain(cores, left, right, x):
    """Plain torch version of the kernel: the same arithmetic, site by site."""
    check_chain_args(cores, left, right, x)
    n_sites, phys, bond, _ = cores.shape
    mats = cores.permute(0, 2, 1, 3).reshape(n_sites, bond, phys * bond)
    v = left.to(torch.float32).expand(x.shape[0], bond)
    acc = torch.zeros(x.shape[0], 1, dtype=torch.float32, device=cores.device)
    thr = float(np.float32(MIN_NORM / bond))
    for s in range(n_sites):
        # operands in the core dtype, products and sums in fp32
        u = torch.matmul(v.to(cores.dtype).float(), mats[s].float())
        xb = x[:, s].float()
        v = xb[:, 0:1] * u[:, 0:bond]
        for k in range(1, phys):
            v = v + xb[:, k:k + 1] * u[:, k * bond:(k + 1) * bond]
        norm = v.abs().sum(dim=1, keepdim=True) / bond
        safe = torch.where(norm > thr, norm, torch.ones_like(norm))
        v = v / safe
        acc = acc + torch.log(safe)
    amp = (v * right.float()).sum(dim=1, keepdim=True)
    mag = amp.abs()
    safe_a = torch.where(mag > MIN_NORM, mag, torch.ones_like(mag))
    return (amp / safe_a)[:, 0], (acc + torch.log(safe_a))[:, 0]


def cuda_mps_evaluate(cores, left, right, x):
    """Fused stabilized MPS evaluation (drop-in for ``mps_evaluate``).

    Args:
        cores: ``(N, d, D, D)`` site tensors, float32 or bfloat16.
        left, right: ``(D,)`` boundary vectors.
        x: ``(B, N, d)`` batched inputs.

    Returns:
        ``(amp, log)`` float32 of shape ``(B,)``: split-format amplitudes.
        CUDA tensors go through the hand kernel (counted in
        ``cuda_mps_evaluate.launches``); CPU tensors through
        :func:`mps_evaluate_plain`.

    Raises :class:`~contractn_tpu_torch.utils.errors.TNError` where autograd
    would record through it (the kernel has no backward), on every device.
    """
    n_sites, phys, bond, batch = check_chain_args(cores, left, right, x)
    check_no_autograd("cuda_mps_evaluate", cores, left, right, x)
    if cores.device.type == "cpu":
        return mps_evaluate_plain(cores, left, right, x)
    if cores.device.type != "cuda":
        raise ValueError(f"unsupported device {cores.device}")
    lib, bf16, cores_k = tc_operands(cores, (left, right, x), phys, bond)
    xf = f32_input(x)
    left_f = left.to(torch.float32).contiguous()
    right_f = right.to(torch.float32).contiguous()
    amp = torch.empty(batch, dtype=torch.float32, device=cores.device)
    log = torch.empty(batch, dtype=torch.float32, device=cores.device)
    with torch.cuda.device(cores.device):
        rc = lib.cn_mps_evaluate(
            cores_k.data_ptr(), bf16, xf.data_ptr(), left_f.data_ptr(),
            right_f.data_ptr(), amp.data_ptr(), log.data_ptr(), n_sites, phys,
            bond, batch, f32(MIN_NORM / bond), f32(MIN_NORM),
            _build.stream_of(cores),
        )
    _build.check(rc, "cn_mps_evaluate")
    cuda_mps_evaluate.launches += 1
    return amp, log


cuda_mps_evaluate.launches = 0
