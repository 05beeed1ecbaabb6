"""Native (C++) path optimizer, bound through ctypes.

Counterpart of ``contractn_tpu/native/__init__.py``: the greedy
contraction-path optimizer of ``pathopt.cpp`` (this package keeps its own
copy of the source).  On first use it is compiled with the system ``g++``
into ``build/native/`` at the root of the checkout, named by a hash of the
source, and loaded with :mod:`ctypes`; nothing is built when the package is
imported and nothing is written next to the source.

Departure from the JAX package: there a failed build silently falls back to
opt_einsum's optimizers.  Here ``optimize="native-greedy"`` (and
:func:`greedy_path`) raise :class:`TNError` with the build error when the
library cannot be built or loaded; :func:`native_available` says beforehand.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..utils.errors import TNError

_SRC = Path(__file__).resolve().parent / "pathopt.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_state = {"lib": None, "error": None, "build_ms": 0.0}


def library_path():
    """Where the library for the current ``pathopt.cpp`` is built."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpathopt-{digest}.so"


def _build(out):
    compiler = shutil.which("g++")
    if compiler is None:
        raise OSError("g++ not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
           "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode:
        raise OSError(f"g++ failed for {_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)


def _load():
    """The loaded library, built first if needed; raises :class:`TNError`
    (once and thereafter) when it cannot be built or loaded."""
    with _lock:
        if _state["lib"] is None and _state["error"] is None:
            try:
                out = library_path()
                if not out.exists():
                    t0 = time.perf_counter()
                    _build(out)
                    _state["build_ms"] = 1e3 * (time.perf_counter() - t0)
                lib = ctypes.CDLL(str(out))
                lib.ctn_greedy_path.restype = ctypes.c_int32
                lib.ctn_greedy_path.argtypes = [
                    ctypes.c_int32,
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    ctypes.c_int32,
                    np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
                    ctypes.c_int32,
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ]
                lib.ctn_pathopt_abi_version.restype = ctypes.c_int32
                lib.ctn_pathopt_abi_version.argtypes = []
                if lib.ctn_pathopt_abi_version() != 1:
                    raise OSError("pathopt ABI version mismatch")
                _state["lib"] = lib
            except (OSError, subprocess.SubprocessError) as exc:
                _state["error"] = str(exc)
        if _state["lib"] is None:
            raise TNError(
                "optimize='native-greedy' needs the C++ path optimizer, which "
                f"could not be built or loaded: {_state['error']}"
            )
        return _state["lib"]


def build_ms():
    """Milliseconds this process spent compiling the library (0 when it was
    already built)."""
    return _state["build_ms"]


def native_available():
    """Whether the C++ path optimizer can be built and loaded here."""
    try:
        _load()
    except TNError:
        return False
    return True


def greedy_path(terms, output, sym_dims):
    """Pairwise contraction path from the native greedy optimizer.

    Args:
        terms: sequence of index-symbol sequences (one per operand), symbols
            being any hashables.
        output: sequence of output symbols.
        sym_dims: mapping symbol -> dimension.

    Returns:
        List of ``(i, j)`` position pairs in opt_einsum's path convention.
        Raises :class:`TNError` when the library is unavailable.
    """
    lib = _load()
    sym_ids = {}
    for term in terms:
        for s in term:
            sym_ids.setdefault(s, len(sym_ids))
    for s in output:
        sym_ids.setdefault(s, len(sym_ids))

    flat = []
    offsets = [0]
    for term in terms:
        flat.extend(sym_ids[s] for s in term)
        offsets.append(len(flat))
    dims = np.ones(max(len(sym_ids), 1), np.float64)
    for s, i in sym_ids.items():
        dims[i] = float(sym_dims[s])
    out_syms = np.asarray(
        sorted({sym_ids[s] for s in output}), np.int32
    ).reshape(-1)
    flat = np.asarray(flat, np.int32).reshape(-1)
    offsets = np.asarray(offsets, np.int32)
    n_terms = len(terms)
    out_pairs = np.empty(max(2 * (n_terms - 1), 1), np.int32)

    n_steps = lib.ctn_greedy_path(
        n_terms, offsets, flat, len(dims), dims,
        len(out_syms), out_syms, out_pairs,
    )
    if n_steps < 0:
        raise TNError("the native path optimizer failed on this network")
    return [
        (int(out_pairs[2 * k]), int(out_pairs[2 * k + 1]))
        for k in range(n_steps)
    ]
