"""Generator expressions (explode, posexplode) — counterpart of
`spark_rapids_tpu/expr/generators.py`: markers that the DataFrame layer
extracts from a projection into a Generate node (Spark's ExtractGenerator
rule), planned as TpuGenerateExec. A generator never evaluates inline."""

from __future__ import annotations

from spark_rapids_tpu_torch.expr.core import Expression


class Explode(Expression):
    """explode(array): one output row per element of a non-null array."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return self.children[0].dtype.elementType

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        raise RuntimeError(
            "generator expressions are planned as Generate nodes, "
            "never evaluated inline")

    def key(self):
        return ("explode", self.children[0].key())


class PosExplode(Explode):
    """posexplode(array): (pos, col) rows."""

    def key(self):
        return ("posexplode", self.children[0].key())


def contains_generator(e: Expression) -> bool:
    if isinstance(e, Explode):
        return True
    return any(contains_generator(c) for c in e.children)
