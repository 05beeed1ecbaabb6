"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use it is
compiled for Hopper (``sm_90a``) into ``build/kernels/`` at the root of the
checkout, named by a hash of the source and the shared ``csrc/*.cuh``
headers, and loaded with :mod:`ctypes`.
Nothing is built when the package is imported: the CPU test runs import every
module but never reach a kernel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("mps_chain_tc", "mpo_env")
SMEM_LIMIT = 232448  # bytes of shared memory one block may opt in to (sm_90)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_libraries = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels are built from source at first use"
    )


def library_path(name):
    """Where the library for ``csrc/<name>.cu`` is built."""
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES):
    """Compile every listed source that has no current library.

    All ``nvcc`` processes start together and are waited for.  Returns
    ``{name: compiler output}`` for the sources compiled by this call (the
    ``-Xptxas -v`` register and shared-memory report); raises on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, proc, tmp, out))
    logs = {}
    failed = []
    for name, proc, tmp, out in jobs:
        text, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{text}")
            continue
        os.replace(tmp, out)
        logs[name] = text
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name, signatures):
    """The loaded library for ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C function to its ctypes argument types; every
    function returns an ``int`` (a ``cudaError_t``, 0 on success).
    """
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libraries[name] = lib
    return lib


def check(rc, what):
    """Raise if a C entry point returned a CUDA error code."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_of(tensor):
    """The current CUDA stream of ``tensor``'s device, as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)

