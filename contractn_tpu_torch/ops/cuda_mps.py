"""Hand-written CUDA kernel: fused stabilized batched MPS evaluation.

Replaces the Pallas TPU kernel ``contractn_tpu/ops/pallas_mps.py``
(``pallas_mps_evaluate`` -> ``_mps_kernel``).  The CUDA source is
``csrc/mps_chain_tc.cu`` (entry ``cn_mps_evaluate``, the close mode of the
template that also serves :mod:`.cuda_epilogue`); its header states the
bound on an H100 (the chain's ``2*B*N*d*D^2`` GEMM FLOPs run as 3xTF32 on the
tensor cores for fp32 cores, one bf16 pass for bf16) and the design of its
two paths, both on ``mma.sync``, which together take every bond the Pallas
kernel takes:

* the tensor-core path, for every bond up to :data:`MAX_BOND`: one CTA per
  32-row batch tile walks every site with the fp32 carry on chip, the
  coming cores fetched by the TMA (``cp.async.bulk``, one copy per physical
  index of a site) into a ring of shared-memory slots while the current
  site computes.  For those single copies the wrapper lays the cores out as
  ``(N, d, DP, LD)``, zero-padded, with ``DP`` and ``LD`` from the library
  (``cn_mps_core_rows``, ``cn_mps_core_ld``), a copy made on every call;
* the streamed path, for every bond above it (a site's core no longer fits
  a CTA's shared memory): the carry in device memory between sites, one
  GEMM-and-weighting launch a site over 64-row x 64-column tiles and a
  finishing launch, the cores read in place and the workspace
  (``cn_mps_streamed_workspace`` bytes) allocated here.  Only device memory
  bounds it.

The library decides which, from the shape and before the launch
(``cn_mps_path``); each path counts its launches in
``cuda_mps_evaluate.launches_by_path``.  Only d or D < 1 raise
``ValueError``; a launch the card refuses raises ``RuntimeError``, and
nothing falls back.  :func:`mps_chain_streamed` launches the streamed path
at any valid shape, to time it beside the tensor-core path; the entry
points never call it.

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

# work, N, d, D, B
_TAIL = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
_TC_SIGNATURES = {
    "cn_mps_evaluate": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, *_TAIL,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ],
    "cn_mps_epilogue": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, *_TAIL,
        ctypes.c_float, ctypes.c_void_p,
    ],
    "cn_mps_chain_streamed": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, *_TAIL,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ],
    "cn_mps_path": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "cn_mps_streamed_workspace": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "cn_mps_core_rows": [ctypes.c_int],
    "cn_mps_core_ld": [ctypes.c_int],
    "cn_mps_evaluate_smem": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
}
# cn_mps_path's answer: the kernel that takes a shape, or None
PATHS = (None, "tensor_core", "streamed")
# the C output modes: the close (#1), the carry in float32 or bfloat16 (#2)
_MODES = {None: 0, torch.float32: 1, torch.bfloat16: 2}

MAX_BOND = 128  # widest bond the tensor-core path takes (the streamed path takes the rest)


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


def chain_path(cores):
    """The path the chain kernels take for ``cores``: ``"tensor_core"``
    (every bond up to :data:`MAX_BOND`) or ``"streamed"`` (the rest), from
    the library (``cn_mps_path``).  Raises ``ValueError`` for d or D < 1."""
    _, phys, bond, _ = cores.shape
    path = PATHS[tc_library().cn_mps_path(int(cores.dtype == torch.bfloat16), phys, bond)]
    if path is None:
        raise ValueError(f"d={phys}, D={bond}: the MPS chain kernels take d and D >= 1")
    return path


def chain_launch(entry, path, cores, left, right, x, acc=None):
    """Check and lay out the operands of a chain kernel for ``path``, call
    the C ``entry`` and return ``(out, log)``: ``out`` the amplitudes (B,)
    fp32 where ``acc`` is None (#1), else the carry (B, D) in ``acc`` (#2).

    Raises on a dtype or device the kernels do not take.  On the
    tensor-core path the cores are zero-padded to ``(N, d, DP, LD)`` with
    ``DP`` and ``LD`` from the library, the layout that kernel copies into
    shared memory one block at a time (a copy made on every call); the
    streamed path reads them in place and gets its workspace
    (``cn_mps_streamed_workspace`` bytes) here.
    """
    if cores.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"CUDA MPS kernels take float32 or bfloat16 cores, got {cores.dtype}"
        )
    for t in (left, right, x):
        if t is not None and t.device != cores.device:
            raise ValueError("all operands must be on the cores' device")
    if not cores.is_contiguous():
        raise ValueError("cores must be contiguous (N, d, D, D)")
    n_sites, phys, bond, _ = cores.shape
    batch = x.shape[0]
    lib = tc_library()
    bf16 = int(cores.dtype == torch.bfloat16)
    work = None
    if path == "tensor_core":
        rows, ld = lib.cn_mps_core_rows(bond), lib.cn_mps_core_ld(bond)
        cores = torch.nn.functional.pad(cores, (0, ld - bond, 0, rows - bond))
    else:
        nbytes = ctypes.c_longlong()
        _build.check(lib.cn_mps_streamed_workspace(bond, batch, ctypes.byref(nbytes)),
                     "cn_mps_streamed_workspace")
        work = torch.empty(max(nbytes.value, 1), dtype=torch.uint8, device=cores.device)
    xf = f32_input(x)
    log = torch.empty(batch, dtype=torch.float32, device=cores.device)
    if acc is None:  # #1: fp32 boundaries, guard MIN_NORM / D, then the close
        left_f = left.to(torch.float32).contiguous()
        right_f = right.to(torch.float32).contiguous()
        out = torch.empty(batch, dtype=torch.float32, device=cores.device)
        thr = [f32(MIN_NORM / bond), f32(MIN_NORM)]
    else:  # #2: left cast to the core and carry types, guard MIN_NORM in acc
        left_f = left.to(cores.dtype).to(acc).float().contiguous()
        right_f = None
        out = torch.empty(batch, bond, dtype=acc, device=cores.device)
        thr = [f32(carry_threshold(acc)), f32(0.0)]  # no close
    head = [cores.data_ptr(), bf16, xf.data_ptr(), left_f.data_ptr()]
    if entry == "cn_mps_evaluate":
        head += [right_f.data_ptr(), out.data_ptr()]
    elif entry == "cn_mps_epilogue":  # takes no close threshold
        head += [out.data_ptr(), int(acc == torch.bfloat16)]
        thr = thr[:1]
    else:  # cn_mps_chain_streamed
        head += [_ptr(right_f), out.data_ptr(), _MODES[acc]]
    with torch.cuda.device(cores.device):
        rc = getattr(lib, entry)(*head, log.data_ptr(), _ptr(work), n_sites, phys, bond,
                                 batch, *thr, _build.stream_of(cores))
    _build.check(rc, entry)
    return out, log


def _ptr(t):
    return None if t is None else t.data_ptr()


def carry_threshold(acc):
    """The rescale guard of #2: ``MIN_NORM`` in the carry dtype, as torch
    and XLA both compare it."""
    if acc == torch.float32:
        return MIN_NORM
    return float(torch.tensor(MIN_NORM, dtype=acc).float())


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
        CUDA tensors go through the hand kernel, on the path the library
        picks (counted in ``cuda_mps_evaluate.launches`` and, by path, in
        ``cuda_mps_evaluate.launches_by_path``); CPU tensors through
        :func:`mps_evaluate_plain`.

    Raises :class:`~contractn_tpu_torch.utils.errors.TNError` where autograd
    would record through it (the kernel has no backward), on every device.
    """
    check_chain_args(cores, left, right, x)
    check_no_autograd("cuda_mps_evaluate", cores, left, right, x)
    if cores.device.type == "cpu":
        return mps_evaluate_plain(cores, left, right, x)
    if cores.device.type != "cuda":
        raise ValueError(f"unsupported device {cores.device}")
    path = chain_path(cores)
    out = chain_launch("cn_mps_evaluate", path, cores, left, right, x)
    cuda_mps_evaluate.launches += 1
    cuda_mps_evaluate.launches_by_path[path] += 1
    return out


cuda_mps_evaluate.launches = 0
cuda_mps_evaluate.launches_by_path = dict.fromkeys(PATHS[1:], 0)


def mps_chain_streamed(cores, left, right, x, acc_dtype=None):
    """The streamed path (``cn_mps_chain_streamed``, which the chain entries
    launch for every bond above :data:`MAX_BOND`) at any valid shape of CUDA
    tensors, also where the library picks the tensor-core path: a yardstick
    for timing the two side by side (counted in
    ``mps_chain_streamed.launches``).  With ``acc_dtype`` None it computes
    #1's ``(amp, log)``; with ``torch.float32`` or ``torch.bfloat16``, #2's
    carry ``(v, log)`` in that dtype (``right`` is not read).  Neither
    :func:`cuda_mps_evaluate` nor the epilogue calls it."""
    check_chain_args(cores, left, right, x)
    check_no_autograd("mps_chain_streamed", cores, left, right, x)
    if cores.device.type != "cuda":
        raise ValueError(f"mps_chain_streamed needs CUDA tensors, got {cores.device}")
    if acc_dtype not in _MODES:
        raise TypeError(f"acc_dtype must be None, float32 or bfloat16, got {acc_dtype}")
    chain_path(cores)  # ValueError for a zero dimension
    out = chain_launch("cn_mps_chain_streamed", "streamed", cores, left, right, x, acc_dtype)
    mps_chain_streamed.launches += 1
    return out


mps_chain_streamed.launches = 0
