"""Contraction introspection and staging-time observability.

Counterpart of ``contractn_tpu/utils/introspect.py``.  The path metadata —
FLOP estimate, largest intermediate, the path itself — is a first-class
query (:func:`contraction_info`), computed from this package's own path
search with opt_einsum's cost convention (no opt_einsum import).
:class:`CompileStats` keeps the JAX package's field names; there are no XLA
stages here, so its fields mean (see :func:`compile_stats`):

* ``trace_ms`` — path search plus lowering plan of the signature, measured
  when it was first planned;
* ``compile_ms`` — building the native path optimizer in this process
  (``optimize="native-greedy"`` only; 0 when its library was on disk);
* ``lower_ms`` — the first call's run time, ending in
  ``torch.cuda.synchronize`` on the card.
"""

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple


@dataclass
class ContractionInfo:
    """Static cost model of a TN contraction."""

    einsum_str: str
    shapes: Tuple[Tuple[int, ...], ...]
    path: List[Tuple[int, ...]]
    flops: float  # total scalar ops estimated for the contraction
    largest_intermediate: float  # elements
    opt_cost: float  # the optimizer's cost metric (here: flops)
    speedup_vs_naive: float
    per_step: List[str] = field(default_factory=list)

    def __str__(self):
        lines = [
            f"einsum: {self.einsum_str}",
            f"path: {self.path}",
            f"estimated FLOPs: {self.flops:.3g}",
            f"largest intermediate: {self.largest_intermediate:.3g} elements",
            f"speedup vs naive: {self.speedup_vs_naive:.3g}x",
        ]
        return "\n".join(lines)


def flop_count(indices, inner, num_terms, sizes):
    """opt_einsum's FLOP convention for one contraction: the size of all
    indices involved, times ``max(num_terms - 1, 1)``, plus one more such
    size when an index is summed."""
    factor = max(1, num_terms - 1) + (1 if inner else 0)
    return math.prod(sizes[i] for i in indices) * factor


def path_cost(terms, output, sizes, path):
    """``(flops, largest_intermediate, naive_flops, per_step)`` of a
    linear-id ``path`` over ``terms -> output`` (opt_einsum's accounting)."""
    input_sets = [frozenset(t) for t in terms]
    output_set = frozenset(output)
    indices = frozenset("".join(terms))
    inner = sum(len(s) for s in input_sets) - len(indices) > 0
    naive = flop_count(indices, inner, len(terms), sizes)
    flops = 0
    sizes_out = []
    per_step = []
    for step in path:
        positions = sorted(step, reverse=True)
        taken = [input_sets.pop(i) for i in positions]
        contracted = frozenset.union(*taken)
        result = contracted & output_set.union(*input_sets)
        removed = contracted - result
        input_sets.append(result)
        flops += flop_count(contracted, bool(removed), len(positions), sizes)
        sizes_out.append(math.prod(sizes[i] for i in result))
        per_step.append(
            f"{len(contracted):>4}  {tuple(positions)} -> "
            f"{sizes_out[-1]} elements"
        )
    largest = max(sizes_out, default=1)
    return flops, largest, naive, per_step


def contraction_info(tn, optimize="auto", inputs_shapes=None,
                     memory_limit=None):
    """Cost-model a TN's contraction without executing it.

    Args:
        tn: the tensor network.
        optimize: path strategy (as in ``contract``).
        inputs_shapes: shapes for input nodes (required if the TN has any).
        memory_limit: optional bound on intermediate size.

    Returns:
        A :class:`ContractionInfo`.
    """
    from ..compiler.einstring import make_einstring, make_operand_spec
    from ..compiler.engine import _freeze, _parse
    from ..compiler.paths import find_path

    einstr = make_einstring(tn)
    slots, _, num_inputs = make_operand_spec(tn)
    param_shapes = [tuple(int(d) for d in p.shape) for p in tn.params]
    inputs_shapes = [tuple(s) for s in (inputs_shapes or [])]
    if len(inputs_shapes) != num_inputs:
        raise ValueError(
            f"TN has {num_inputs} input nodes; got {len(inputs_shapes)} "
            "shapes in inputs_shapes"
        )
    shapes = tuple(
        param_shapes[i] if kind == "param" else inputs_shapes[i]
        for kind, i in slots
    )
    terms, output = _parse(einstr)
    sizes = {}
    for term, shape in zip(terms, shapes):
        sizes.update(zip(term, shape))
    path = find_path(tuple(terms), output, shapes, _freeze(optimize),
                     memory_limit)
    flops, largest, naive, per_step = path_cost(terms, output, sizes, path)
    return ContractionInfo(
        einsum_str=einstr,
        shapes=shapes,
        path=list(path),
        flops=float(flops),
        largest_intermediate=float(largest),
        opt_cost=float(flops),
        speedup_vs_naive=float(naive) / max(float(flops), 1.0),
        per_step=per_step,
    )


@dataclass
class CompileStats:
    """Wall-clock breakdown of staging a contraction (see module doc)."""

    trace_ms: float
    lower_ms: float
    compile_ms: float
    flops_estimate: float | None = None

    @property
    def total_ms(self):
        return self.trace_ms + self.lower_ms + self.compile_ms


def compile_stats(fn, *args, signature):
    """Stage ``fn`` on ``args`` and time it; returns ``(fn, CompileStats)``.

    ``signature`` is ``(einsum_str, shapes, optimize, memory_limit)`` of the
    contraction ``fn`` runs: its plan is built (or taken from the cache) and
    its build time reported as ``trace_ms``, the native optimizer's build as
    ``compile_ms``, and its FLOPs as ``flops_estimate``.  ``lower_ms`` is
    the time of ``fn(*args)``, ending in a synchronize where the result is
    on the card.
    """
    import torch

    from ..compiler.engine import _dedup_output, _freeze, _parse, _plan
    from ..compiler.paths import NATIVE, find_path

    einstr, shapes, optimize, memory_limit = signature
    optimize = _freeze(optimize)
    compile_ms = 0.0
    if optimize == NATIVE:
        from .. import native

        native.native_available()
        compile_ms = native.build_ms()
    trace_ms = _plan(einstr, shapes, optimize, memory_limit).build_ms
    terms, output = _parse(_dedup_output(einstr)[0])
    sizes = {}
    for term, shape in zip(terms, shapes):
        sizes.update(zip(term, shape))
    path = find_path(tuple(terms), output, shapes, optimize, memory_limit)
    flops = float(path_cost(terms, output, sizes, path)[0])
    t0 = time.perf_counter()
    out = fn(*args)
    leaves = out if isinstance(out, tuple) else (out,)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    lower_ms = (time.perf_counter() - t0) * 1e3
    return fn, CompileStats(
        trace_ms=trace_ms,
        lower_ms=lower_ms,
        compile_ms=compile_ms,
        flops_estimate=flops,
    )


class Timings:
    """Tiny structured-timing registry for library-internal phases.

    Usage::

        with Timings.measure("path_find"):
            ...
        Timings.report()  # {"path_find": [ms, ...]}
    """

    _records: Dict[str, List[float]] = {}
    enabled: bool = False

    class _Ctx:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            if Timings.enabled:
                Timings._records.setdefault(self.name, []).append(
                    (time.perf_counter() - self.t0) * 1e3
                )

    @classmethod
    def measure(cls, name) -> Any:
        return cls._Ctx(name)

    @classmethod
    def report(cls) -> Dict[str, List[float]]:
        return dict(cls._records)

    @classmethod
    def reset(cls) -> None:
        cls._records.clear()


@contextmanager
def profile_trace(log_dir):
    """Capture a profile around a block of work.

    Wraps :mod:`torch.profiler` (CPU activity, and CUDA where a card is
    present) and writes a Chrome trace, ``trace.json``, into ``log_dir`` —
    the device-level complement to the host-side :class:`Timings`.  Usage::

        with profile_trace("/tmp/tn_trace"):
            tn.contract()
    """
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
