"""Hand-written CUDA kernel: batched MPO expectation environments.

Replaces the Pallas TPU kernel ``contractn_tpu/ops/pallas_mpo.py``
(``mpo_expectation_pallas`` / ``make_mpo_pallas_fn`` -> ``_mpo_pallas_run``
-> ``_kernel``).  The CUDA source is ``csrc/mpo_env.cu`` (entry
``cn_mpo_env``); its header states the bound on an H100 (``4*d*W*D^3`` GEMM
FLOPs per sample and site, run as 3xTF32 on the tensor cores for fp32 cores
and as one bf16 pass for bf16) and the design of its three paths, all on
``mma.sync``, which together take every real shape the Pallas kernel takes.
The first two keep the environment on chip, the channel mix in place
between the ket and bra GEMMs and the cores fetched by the TMA
(``cp.async.bulk``, one copy a row):

* the one-CTA tensor-core path: one CTA per sample walks every site with the
  ``(W*D, D)`` fp32 environment and the ket products resident in its shared
  memory, the next site's core fetched into a second buffer while this one
  computes.  It takes D <= 64, d*W <= 16 and W <= 8 at D > 32, within its
  shared memory; a bond whose rows are not a whole number of 16-byte copies
  is zero-padded here first (:func:`aligned_bond`);
* the cluster path, for the shapes no one-CTA plan holds (D > 64, or many
  ket blocks at 33 <= D <= 64, such as d = 2 with W = 7, 8): a thread-block
  cluster of 2 to 8 CTAs per sample, each owning a slice of the bond's
  columns, reading the environment and the core columns it lacks from its
  peers' shared memory.  It takes D <= 128 and d*W <= 16 (``MAX_BOND``,
  ``MAX_MIX``: the on-chip paths' limits) where a cluster's layout fits;
  the bond is zero-padded here to the cluster's (a multiple of 16, at least
  32: ``cn_mpo_env_bond``);
* the streamed path, for every other shape: d*W > 16 (such as the spin-1
  AKLT chain, d 3 and W 14), D > 128, and fp32 d 15-16 with W 1 at
  D 113-128, where no cluster's blocks fit a CTA.  The environment and the
  intermediates live in device memory (a workspace allocated here, of
  ``cn_mpo_env_workspace`` bytes, and the dense ``(d*W, d*W)`` mix on the
  device); each site is a batched ket GEMM, a mix kernel, a batched bra
  GEMM and a rescale, each launch covering the whole batch, the bond
  unpadded (the kernels mask the ragged edges).  Only device memory bounds
  it: running out raises torch's own error.

The library decides which, from the shape and before the launch
(``cn_mpo_env_path``); each path counts its launches in
``mpo_env.launches_by_path``.  Only d, D or W < 1 raise ``ValueError``; a
launch the card refuses raises ``RuntimeError``, and nothing falls back.
:func:`mpo_env_streamed` launches the streamed path at any valid shape, to
time it beside another path; :func:`mpo_env` never calls it.

Semantics (pinned against the Pallas kernel in interpret mode on the CPU):
per site, ``d`` ket GEMMs ``(W D, D) x (D, D)`` with the environment cast to
the core dtype, the channel mix over the MPO entries ``W[d, e, w, v]``
(summed in entry order and cast to the core dtype), ``W`` bra GEMMs
``(d D, D)^T x (d D, D)``, then a mean-|.| rescale of the whole environment
with guard ``mean > MIN_NORM`` and ``env * (1/safe)``.  The close with the
boundary vectors runs outside the kernel in fp32.

The MPO must be uniform (the same core at every site); a non-uniform one
raises ``ValueError`` as in the JAX package.  The kernel has no backward:
the entry points raise ``TNError`` where autograd would record through
them (``MPO.expectation`` is the differentiable path).  The Pallas
wrapper's ``btile``, ``unroll`` and ``interpret`` are TPU knobs and are not
taken.
"""

import ctypes

import numpy as np
import torch

from ..utils.errors import check_no_autograd
from . import _build
from .stabilize import MIN_NORM

_LAUNCH_TAIL = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
]  # mix_dev, work, env_out, log_out, B, N, d, D, W, count, thr, stream
_SIGNATURES = {
    "cn_mpo_env": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   *_LAUNCH_TAIL],
    "cn_mpo_env_streamed": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, *_LAUNCH_TAIL],
    "cn_mpo_env_workspace": [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "cn_mpo_env_path": [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "cn_mpo_env_smem": [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "cn_mpo_env_bond": [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "cn_mpo_env_cluster": [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
}
# cn_mpo_env_path's answer: the kernel that takes a shape, or None
PATHS = (None, "tensor_core", "cluster", "streamed")

# The on-chip paths' limits (the streamed path takes the shapes beyond)
MAX_BOND = 128  # widest bond the on-chip paths take
MAX_MIX = 16   # largest d * W their channel mix holds in registers


def aligned_bond(bond, dtype):
    """The bond the environment kernel lays out: ``bond`` rounded up so that
    a row of ``bond`` elements of ``dtype`` is a whole number of 16-byte
    bulk copies."""
    step = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-bond // step) * step


def pad_bond(t, pad, dims):
    """``t`` with its last ``dims`` axes zero-padded by ``pad`` at the end
    (itself when ``pad`` is 0).  Zero rows and columns leave every product
    and sum unchanged; the kernel divides its mean by the unpadded size."""
    if pad == 0:
        return t
    return torch.nn.functional.pad(t, (0, pad) * dims)


def aligned16(t):
    """``t`` itself if its data starts on a 16-byte boundary, else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def library():
    """The built ``csrc/mpo_env.cu`` library."""
    return _build.load("mpo_env", _SIGNATURES)


def mpo_entries(mpo):
    """Nonzero entries ``(d, e, w, v, coef)`` of a uniform MPO's core.

    Raises ``ValueError`` when the cores differ between sites.
    """
    cores = mpo.cores.detach().cpu()
    if cores.dtype in (torch.bfloat16, torch.float16):
        cores = cores.float()
    cores = cores.numpy()
    w0 = cores[0]
    if not np.allclose(cores, w0[None]):
        raise ValueError("the batched MPO expectation needs a uniform-W MPO")
    phys, _, wdim, _ = w0.shape
    return tuple(
        (d, e, w, v, float(w0[d, e, w, v]))
        for d in range(phys) for e in range(phys)
        for w in range(wdim) for v in range(wdim)
        if w0[d, e, w, v] != 0.0
    )


def mpo_env_plain(cores, env0, entries, wdim):
    """Plain torch version of the kernel.

    Args:
        cores: ``(B, N, d, D, D)`` per-sample MPS cores.
        env0: ``(W*D, D)`` fp32 boundary environment.
        entries: nonzero MPO entries ``(d, e, w, v, coef)`` (entry order).
        wdim: MPO bond ``W``.

    Returns:
        ``(env, log)``: ``(B, W*D, D)`` fp32 and ``(B,)`` fp32.
    """
    batch, n_sites, phys, bond, _ = cores.shape
    gemm = cores.dtype
    env = env0.reshape(1, wdim, bond, bond).expand(batch, -1, -1, -1)
    log = torch.zeros(batch, dtype=torch.float32, device=cores.device)
    for s in range(n_sites):
        a = cores[:, s].float()  # (B, d, D, D): [e, k, l]
        envm = env.to(gemm).float()
        # t1[b, e, w] = env[b, w] @ a[b, e]
        t1 = torch.matmul(envm[:, None], a[:, :, None])  # (B, d, W, D, D)
        blocks = {}
        for (d, e, w, v, coef) in entries:
            blk = coef * t1[:, e, w]
            blocks[(v, d)] = blk if (v, d) not in blocks else blocks[(v, d)] + blk
        zero = torch.zeros_like(t1[:, 0, 0])
        t2 = torch.stack([
            torch.cat([blocks.get((v, d), zero) for d in range(phys)], dim=1)
            for v in range(wdim)
        ], dim=1).to(gemm).float()  # (B, W, d*D, D): rows (d, i)
        bra = a.reshape(batch, 1, phys * bond, bond)  # rows (d, i), cols j
        out = torch.matmul(bra.transpose(-1, -2), t2)  # (B, W, D, D): [v, j, l]
        norm = out.abs().sum(dim=(1, 2, 3)) / (wdim * bond * bond)
        safe = torch.where(norm > MIN_NORM, norm, torch.ones_like(norm))
        env = out * (1.0 / safe)[:, None, None, None]
        log = log + torch.log(safe)
    return env.reshape(batch, wdim * bond, bond), log


def _mix_matrix(entries, phys, wdim):
    """Dense channel mix ``M[v*d + p, e*W + w] = W[p, e, w, v]`` of shape
    ``(d*W, d*W)`` in host memory (a zero entry adds an exact zero, so it
    sums like ``entries``); the library zero-pads it to 16 x 16 for the
    on-chip paths."""
    mix = np.zeros((phys * wdim, phys * wdim), np.float32)
    for (d, e, w, v, coef) in entries:
        mix[v * phys + d, e * wdim + w] = coef
    return mix


def _check_operands(cores, env0, wdim):
    """Shapes of the kernel's operands; real cores only."""
    check_no_autograd("mpo_env", cores, env0)
    if cores.ndim != 5 or cores.shape[3] != cores.shape[4]:
        raise ValueError(f"cores must be (B, N, d, D, D), got {tuple(cores.shape)}")
    bond = cores.shape[3]
    if tuple(env0.shape) != (wdim * bond, bond):
        raise ValueError(
            f"env0 must be ({wdim * bond}, {bond}), got {tuple(env0.shape)}"
        )
    if cores.is_complex():
        raise TypeError("the MPO environment kernel takes real cores only")


def _launch(entry, path, cores, env0, entries, wdim):
    """Lay the operands out for ``path``, call the C ``entry`` and return
    ``(env, log)`` at the caller's bond."""
    if cores.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"the MPO kernel takes float32 or bfloat16 cores, got {cores.dtype}"
        )
    if not cores.is_contiguous():
        raise ValueError("cores must be contiguous (B, N, d, D, D)")
    if env0.device != cores.device or env0.dtype != torch.float32:
        raise ValueError("env0 must be float32 on the cores' device")
    lib = library()
    batch, n_sites, phys, bond, _ = cores.shape
    bf16 = int(cores.dtype == torch.bfloat16)
    if path == "tensor_core":
        layout = aligned_bond(bond, cores.dtype)
    elif path == "cluster":
        layout = lib.cn_mpo_env_bond(bf16, phys, bond, wdim)
    else:  # the streamed kernels mask the ragged edges
        layout = bond
    pad = layout - bond
    cores_k = aligned16(pad_bond(cores, pad, 2))
    env0_k = pad_bond(env0.reshape(wdim, bond, bond), pad, 2).contiguous()
    mix = _mix_matrix(entries, phys, wdim)  # alive until the call returns
    host = (mix.ctypes.data,) if entry == "cn_mpo_env" else ()
    mix_dev = work = None
    if path == "streamed":  # the mix from device memory, E and the rest in `work`
        nbytes = ctypes.c_longlong()
        _build.check(lib.cn_mpo_env_workspace(bf16, phys, bond, wdim, batch,
                                              ctypes.byref(nbytes)), "cn_mpo_env_workspace")
        work = torch.empty(nbytes.value, dtype=torch.uint8, device=cores.device)
        mix_dev = torch.from_numpy(mix).pin_memory().to(cores.device, non_blocking=True)
    env = torch.empty(
        batch, wdim * layout, layout, dtype=torch.float32, device=cores.device
    )
    log = torch.empty(batch, dtype=torch.float32, device=cores.device)
    with torch.cuda.device(cores.device):
        rc = getattr(lib, entry)(
            cores_k.data_ptr(), bf16, env0_k.data_ptr(), *host,
            None if mix_dev is None else mix_dev.data_ptr(),
            None if work is None else work.data_ptr(),
            env.data_ptr(), log.data_ptr(), batch, n_sites, phys, layout, wdim,
            ctypes.c_float(float(wdim * bond * bond)),
            ctypes.c_float(float(np.float32(MIN_NORM))), _build.stream_of(cores),
        )
    _build.check(rc, entry)
    if pad:
        env = env.reshape(batch, wdim, layout, layout)[:, :, :bond, :bond]
        env = env.reshape(batch, wdim * bond, bond)
    return env, log


def mpo_env(cores, env0, entries, wdim):
    """Launch wrapper: the environment kernel for CUDA tensors (counted in
    ``mpo_env.launches`` and, by path, ``mpo_env.launches_by_path``),
    :func:`mpo_env_plain` for CPU tensors.  Raises ``TNError`` where autograd
    would record through it (the kernel has no backward)."""
    _check_operands(cores, env0, wdim)
    if cores.device.type == "cpu":
        return mpo_env_plain(cores, env0, entries, wdim)
    if cores.device.type != "cuda":
        raise ValueError(f"unsupported device {cores.device}")
    _, _, phys, bond, _ = cores.shape
    bf16 = int(cores.dtype == torch.bfloat16)
    path = PATHS[library().cn_mpo_env_path(bf16, phys, bond, wdim)]
    if path is None:
        raise ValueError(
            f"d={phys}, D={bond}, W={wdim}: the MPO kernel takes d, D and W >= 1"
        )
    out = _launch("cn_mpo_env", path, cores, env0, entries, wdim)
    mpo_env.launches += 1
    mpo_env.launches_by_path[path] += 1
    return out


mpo_env.launches = 0
mpo_env.launches_by_path = dict.fromkeys(PATHS[1:], 0)


def mpo_env_streamed(cores, env0, entries, wdim):
    """The streamed path (``cn_mpo_env_streamed``, the launcher
    ``cn_mpo_env`` calls for the shapes it assigns there) at any valid shape
    of CUDA tensors, also where the library picks an on-chip path: a
    yardstick for timing the paths side by side (counted in
    ``mpo_env_streamed.launches``).  :func:`mpo_env` never calls it."""
    _check_operands(cores, env0, wdim)
    if cores.device.type != "cuda":
        raise ValueError(f"mpo_env_streamed needs CUDA tensors, got {cores.device}")
    out = _launch("cn_mpo_env_streamed", "streamed", cores, env0, entries, wdim)
    mpo_env_streamed.launches += 1
    return out


mpo_env_streamed.launches = 0


def make_mpo_cuda_fn(mpo, left, right):
    """``cores -> (val, log)`` with the MPO entries and the boundary
    environment prepared once.

    Args:
        mpo: uniform-W MPO (same core at every site, e.g. ``tfim_mpo``).
        left, right: shared ``(D,)`` MPS boundary vectors.
    """
    entries = mpo_entries(mpo)
    wdim = mpo.cores.shape[3]
    bond = left.shape[0]
    device = left.device
    env0 = torch.einsum(
        "w,i,k->wik", mpo.left.to(device, torch.float32),
        left.conj().to(torch.float32), left.to(torch.float32),
    ).reshape(wdim * bond, bond)
    mpo_right = mpo.right.to(device, torch.float32)
    right_f = right.to(torch.float32)

    def fn(cores):
        # the MPO's core enters as constants (mpo_entries): it is checked too
        check_no_autograd("mpo_expectation_cuda", cores, env0, mpo_right, right_f,
                          mpo.cores)
        batch = cores.shape[0]
        env, log = mpo_env(cores, env0, entries, wdim)
        env = env.reshape(batch, wdim, bond, bond)
        val = torch.einsum("bwik,w,i,k->b", env, mpo_right, right_f.conj(), right_f)
        norm = val.abs()
        safe = torch.where(norm > MIN_NORM, norm, torch.ones_like(norm))
        return (val / safe).to(cores.dtype), log + torch.log(safe)

    return fn


def mpo_expectation_cuda(mpo, cores, left, right):
    """Batched ``<psi_b| H |psi_b>`` through the environment kernel.

    Args:
        mpo: uniform-W MPO.
        cores: ``(B, N, d, D, D)`` per-sample MPS cores (float32/bfloat16
            for the kernel).
        left, right: shared ``(D,)`` MPS boundary vectors.

    Returns split-format ``(val, log)`` of shape ``(B,)`` with
    :meth:`~contractn_tpu_torch.models.mpo.MPO.expectation` semantics (fp32
    environment carry).
    """
    return make_mpo_cuda_fn(mpo, left, right)(cores)
