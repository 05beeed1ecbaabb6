"""First-class compiled contraction expressions.

Counterpart of ``contractn_tpu/compiler/expression.py``.  ``TN.compile(...)``
returns a :class:`CompiledContraction`: a reusable, introspectable handle
over the cached contraction plan (path, lowering), with its cost model and
staging times; :func:`contract_expression` is the opt_einsum-style
standalone form.
"""

from ..utils.introspect import CompileStats, compile_stats


def contract_expression(einstr, *shapes, optimize="auto",
                        split_format=False, **kwargs):
    """Standalone reusable einsum expression (opt_einsum-style).

    ``expr = contract_expression("ab,bc->ac", (8, 8), (8, 8))`` fixes the
    signature; ``expr(x, y)`` then contracts with the cached path and
    lowering plan of :func:`contractn_tpu_torch.compiler.engine.contract`
    (options such as ``device=`` go there), after checking the shapes.
    """
    from .engine import contract as _contract

    shapes = tuple(tuple(int(d) for d in s) for s in shapes)

    def expr(*tensors):
        given = tuple(tuple(int(d) for d in t.shape) for t in tensors)
        if given != shapes:
            raise ValueError(
                f"Expression built for shapes {shapes}, got {given}"
            )
        return _contract(
            einstr, *tensors, optimize=optimize,
            split_format=split_format, **kwargs
        )

    expr.einsum_str = einstr
    expr.shapes = shapes
    return expr


class CompiledContraction:
    """Reusable contraction with attached cost model and staging metrics."""

    def __init__(self, tn, optimize="auto", split_format=False, **kwargs):
        self._tn = tn
        self.optimize = optimize
        self.split_format = split_format
        self.einsum_str = tn.einsum_str
        self._memory_limit = kwargs.get("memory_limit")
        self._fn = tn.make_contract_fun(
            optimize=optimize, split_format=split_format, **kwargs
        )
        self._info = None
        self.stats: CompileStats | None = None

    def __call__(self, params=None, inputs=()):
        """Contract; ``params`` defaults to the TN's current tensors."""
        if params is None:
            params = self._tn.params
        return self._fn(params, inputs)

    def info(self, inputs_shapes=None):
        """Static cost model (FLOPs, largest intermediate, path)."""
        if self._info is None:
            self._info = self._tn.contraction_info(
                optimize=self.optimize, inputs_shapes=inputs_shapes
            )
        return self._info

    def measure_compile(self, params=None, inputs=()):
        """Stage the contraction and time it (see
        :func:`~contractn_tpu_torch.utils.introspect.compile_stats` for what
        each field holds here).

        Returns the populated :class:`CompileStats` (also kept on
        ``self.stats``).
        """
        from .engine import _freeze

        if params is None:
            params = self._tn.params
        shapes = tuple(
            tuple(int(d) for d in t.shape)
            for t in self._tn._compiled_spec()[1](params, inputs)
        )
        signature = (self.einsum_str, shapes, _freeze(self.optimize),
                     self._memory_limit)
        _, self.stats = compile_stats(
            self._fn, tuple(params), tuple(inputs), signature=signature
        )
        return self.stats

    def __repr__(self):
        return (
            f"CompiledContraction({self.einsum_str!r}, "
            f"optimize={self.optimize!r}, split_format={self.split_format})"
        )
