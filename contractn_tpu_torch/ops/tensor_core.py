"""Plain torch emulation of the tensor-core arithmetic of the CUDA kernels.

The fp32 paths of ``csrc/mps_chain_tc.cu`` and ``csrc/mpo_env.cu`` run their
GEMMs as 3xTF32 (``csrc/tc_common.cuh``): each fp32 operand is split as
``a = hi + lo`` with ``hi = cvt.rna.tf32.f32(a)`` and
``lo = cvt.rna.tf32.f32(a - hi)``, and each product as
``hi*hi + hi*lo + lo*hi`` with fp32 accumulation.  These helpers repeat that
arithmetic on the CPU so that its rounding can be checked without a GPU
(``tests/test_torch_tensor_core.py``).  They document the kernels; no
entry point of the package calls them.
"""

import torch

_MANTISSA_DROP = 13  # fp32 keeps 23 explicit mantissa bits, TF32 keeps 10


def tf32_round(x):
    """``cvt.rna.tf32.f32``: round fp32 to TF32, nearest, ties away from zero.

    Adds half a TF32 ulp to the magnitude bits and clears the 13 low
    mantissa bits; the sign bit is untouched, so ties round away from zero.
    A carry out of the mantissa moves to the next binade, as in the hardware.
    Infinities and NaNs are not handled (the kernels never see them).
    """
    bits = x.to(torch.float32).view(torch.int32)
    sign = bits & torch.tensor(-(2 ** 31), dtype=torch.int32)
    mag = bits & torch.tensor(0x7FFFFFFF, dtype=torch.int32)
    mag = (mag + (1 << (_MANTISSA_DROP - 1))) & torch.tensor(
        ~((1 << _MANTISSA_DROP) - 1), dtype=torch.int32)
    return (sign | mag).view(torch.float32)


def split_tf32(x):
    """``(hi, lo)``, both TF32 values, with ``hi + lo`` equal to ``x`` to
    about 2**-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def matmul_3xtf32(a, b):
    """``a @ b`` as the kernels compute it from fp32 operands: three TF32
    products accumulated in fp32 (the ``lo @ lo`` term is dropped).

    A product of two TF32 values has at most 22 significant bits, so each
    float32 matmul below forms its products exactly, as the tensor cores do.
    """
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def matmul_tf32(a, b):
    """``a @ b`` in one TF32 pass (what the kernels avoid for fp32 work)."""
    return tf32_round(a) @ tf32_round(b)
