"""Generate examples/torch/ctn_torch_examples.ipynb with RECORDED outputs.

Runs the README's three workflows on the PyTorch port (the code of
``examples/torch/readme_examples.py``) and the MPO expectation kernel (#3)
at bond 128 on the card, capturing each cell's standard output into the
notebook; the first cell names the card and its power limit.  Needs an
NVIDIA GPU; from the repository root:

    PYTHONPATH=. python3 scripts/make_torch_notebook.py [--out PATH]
"""

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

NOTEBOOK = Path(__file__).resolve().parents[1] / "examples" / "torch" / "ctn_torch_examples.ipynb"

CELLS_SRC = [
    ("markdown", """\
# contractn_tpu_torch — worked examples on an NVIDIA GPU

The three workflows from the README (copy tensors, einsum-string
specification, stabilized long products) on the PyTorch port, then the
batched MPO expectation kernel at bond 128.  Outputs below are recorded
from a run on the card the first cell names."""),
    ("code", """\
import subprocess

import torch

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip())
print("torch", torch.__version__, "CUDA", torch.version.cuda,
      "devices", torch.cuda.device_count())
device = torch.device("cuda")"""),
    ("code", """\
import time

import numpy as np

from contractn_tpu_torch import TN

# 1. Copy tensors: an order-101 hyperedge never materializes its 2**101
# elements; it lowers to a repeated einsum index.
tn = TN()
copy_node = tn.add_copy_node(101)
for i in range(100):
    tn.connect_nodes(copy_node, tn.add_dense_node(np.array([1, 0.99])), i, 0)
out = tn.contract(device=device)
print("copy example:", out.cpu().numpy())  # [1, 0.99**100]
torch.cuda.synchronize()
t0 = time.perf_counter()
tn.contract(device=device)
torch.cuda.synchronize()
print(f"  warm contract: {(time.perf_counter() - t0) * 1e3:.2f} ms")"""),
    ("code", """\
# 2. Einsum strings as the network spec: CP and Tucker hubs
cp, tucker = TN(), TN()
cp_hub = cp.add_copy_node(3)
tucker_hub = tucker.add_dense_node(np.ones((4, 4, 4)))
for i in range(3):
    cp.connect_nodes(cp_hub, cp.add_dense_node(np.eye(4, 10)), i, 0)
    tucker.connect_nodes(tucker_hub, tucker.add_dense_node(np.eye(4, 10)), i, 0)
print("cp einsum_str:    ", cp.einsum_str)
print("tucker einsum_str:", tucker.einsum_str)"""),
    ("code", """\
# 3. Stabilized contraction: 1000 all-ones 3x3 matrices overflow float64
# dense; the split format returns the value exactly (3**1000 in each entry).
chain = TN()
prev = chain.add_dense_node(np.ones((3,)))
for _ in range(1000):
    mat = chain.add_dense_node(np.ones((3, 3)))
    chain.connect_nodes(prev, mat, -1, 0)
    prev = mat
print("plain contract:", chain.contract(device=device).cpu().numpy())
mant, log = chain.contract(split_format=True, device=device)
print("split format:  ", mant.cpu().numpy(), float(log), " 1000 ln 3 =", 1000 * np.log(3.0))"""),
    ("code", """\
# 4. Batched MPO expectation <psi_b|H|psi_b> through the hand-written CUDA
# kernel (#3) at bond 128: the Heisenberg chain (W 5) on 64 random MPS of
# 20 sites, held against the same call on the CPU (the kernel's plain torch
# version).  At this bond one CTA's shared memory cannot hold a sample, so
# a thread-block cluster shares it.
import math

from contractn_tpu_torch.models import heisenberg_mpo
from contractn_tpu_torch.ops import cuda_mpo

n, d, bond, batch, wdim = 20, 2, 128, 64, 5
gen = torch.Generator(device=device).manual_seed(0)
cores = torch.randn((batch, n, d, bond, bond), generator=gen, device=device) / math.sqrt(d * bond)
ones = torch.ones(bond, device=device)
lib = cuda_mpo.library()
print("path:", cuda_mpo.PATHS[lib.cn_mpo_env_path(0, d, bond, wdim)],
      "| CTAs a sample:", lib.cn_mpo_env_cluster(0, d, bond, wdim),
      "| shared memory a CTA:", lib.cn_mpo_env_smem(0, d, bond, wdim), "bytes")
mpo = heisenberg_mpo(n, dtype=torch.float32, device=device)
before = dict(cuda_mpo.mpo_env.launches_by_path)
val, lg = cuda_mpo.mpo_expectation_cuda(mpo, cores, ones, ones)
print("launches by path:", {k: v - before[k] for k, v in cuda_mpo.mpo_env.launches_by_path.items()})
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(5):
    cuda_mpo.mpo_expectation_cuda(mpo, cores, ones, ones)
end.record()
torch.cuda.synchronize()
print(f"kernel call: {start.elapsed_time(end) / 5:.3f} ms for {batch} samples x {n} sites")
ref_val, ref_lg = cuda_mpo.mpo_expectation_cuda(
    heisenberg_mpo(n, dtype=torch.float32, device="cpu"), cores.cpu(), ones.cpu(), ones.cpu())
got = val.double().cpu() * torch.exp(lg.double().cpu() - ref_lg.double())
rel = (got - ref_val.double()).abs() / ref_val.double().abs()
print("log|<H>| of the first 4:", (torch.log(val.abs().double()) + lg.double()).cpu().numpy()[:4])
print(f"card against CPU, relative: median {rel.median():.2e}, max {rel.max():.2e}")"""),
]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(NOTEBOOK))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("make_torch_notebook: the notebook is recorded on an NVIDIA GPU")
    cells = []
    glb = {"__name__": "__main__"}  # shared across cells, like a kernel
    for i, (kind, src) in enumerate(CELLS_SRC):
        if kind == "markdown":
            cells.append({"cell_type": "markdown", "id": f"cell-{i}", "metadata": {},
                          "source": src.splitlines(keepends=True)})
            continue
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            exec(compile(src, "<cell>", "exec"), glb)  # noqa: S102
        text = buf.getvalue()
        cells.append({
            "cell_type": "code", "id": f"cell-{i}", "execution_count": None, "metadata": {},
            "source": src.splitlines(keepends=True),
            "outputs": [{"name": "stdout", "output_type": "stream",
                         "text": text.splitlines(keepends=True)}] if text else [],
        })
    nb = {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python", "name": "python3"},
            "language_info": {"name": "python"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(nb, indent=1) + "\n")
    print("wrote", out, file=sys.stderr)


if __name__ == "__main__":
    main()
