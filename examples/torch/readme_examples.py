"""The README's three workflows on the PyTorch port, runnable as a script.

Run with: ``python3 examples/torch/readme_examples.py [--device cpu]``
(from the repository root, with the package installed or ``PYTHONPATH=.``).
Each function returns what it prints, so a caller can check it.
"""

import argparse
import time

import numpy as np
import torch

from contractn_tpu_torch import TN


def copy_tensor_example(device="cuda"):
    """Order-101 copy tensor joined to 100 vectors -> ``[1, 0.99**100]``."""
    tn = TN()
    copy_node = tn.add_copy_node(101)
    for i in range(100):
        vec_node = tn.add_dense_node(np.array([1, 0.99]))
        tn.connect_nodes(copy_node, vec_node, i, 0)
    out = tn.contract(device=device)
    print("copy example:", out.cpu().numpy())  # [1., 0.36603234]
    if out.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    tn.contract(device=device)
    if out.is_cuda:
        torch.cuda.synchronize()
    print(f"  warm contract: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    return out


def einsum_string_example(mats=None):
    """CP vs Tucker hubs compile to the documented einsum strings; returns
    ``(cp, tucker)``, the two networks.  ``mats`` are the three (4, 10)
    factor matrices (default: ``np.eye(4, 10)`` each, as in the README)."""
    cp, tucker = TN(), TN()
    cp_hub = cp.add_copy_node(3)
    tucker_hub = tucker.add_dense_node(np.ones((4, 4, 4)))
    for i, mat in enumerate(mats if mats is not None else [np.eye(4, 10)] * 3):
        cp.connect_nodes(cp_hub, cp.add_dense_node(mat), i, 0)
        tucker.connect_nodes(tucker_hub, tucker.add_dense_node(mat), i, 0)
    print("cp einsum_str:    ", cp.einsum_str)      # ac,ad,ae->cde
    print("tucker einsum_str:", tucker.einsum_str)  # abc,ae,bf,cg->efg
    return cp, tucker


def stable_contraction_example(device="cuda"):
    """1000-link all-ones chain: plain overflows, split format is exact;
    returns ``(plain, mantissa, log_scale)``."""
    tn = TN()
    prev = tn.add_dense_node(np.ones((3,)))
    for _ in range(1000):
        mat = tn.add_dense_node(np.ones((3, 3)))
        tn.connect_nodes(prev, mat, -1, 0)
        prev = mat
    plain = tn.contract(device=device)
    print("plain contract:", plain.cpu().numpy())  # [inf inf inf]
    mant, log = tn.contract(split_format=True, device=device)
    print("split format:  ", mant.cpu().numpy(), float(log))  # [1,1,1], 1098.61...
    return plain, mant, log


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    dev = torch.device(parser.parse_args().device)
    copy_tensor_example(dev)
    einsum_string_example()
    stable_contraction_example(dev)
