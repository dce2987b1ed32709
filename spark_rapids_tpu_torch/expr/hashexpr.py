"""Hash expressions — counterpart of `spark_rapids_tpu/expr/hashexpr.py`:
Spark's `hash(...)` (Murmur3Hash, an int) and `xxhash64(...)` (XxHash64,
a long), bit-exact with CPU Spark and never null. Murmur3Hash runs kernel
K6 with no partition count; XxHash64 runs kernel K30
(ops/hashing.py)."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.ops.hashing import (
    DEFAULT_SEED,
    XXHASH_DEFAULT_SEED,
    murmur3_columns,
    xxhash64_columns,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import integer, long


class Murmur3Hash(Expression):
    def __init__(self, *exprs, seed: int = DEFAULT_SEED):
        super().__init__(list(exprs))
        self.seed = seed

    @property
    def dtype(self):
        return integer

    @property
    def nullable(self):
        return False

    def key(self):
        return ("murmur3", self.seed, tuple(c.key() for c in self.children))

    def eval(self, ctx):
        h = murmur3_columns([c.eval(ctx) for c in self.children], self.seed)
        return DeviceColumn(integer, h, torch.ones_like(h, dtype=torch.bool))


class XxHash64(Expression):
    """Spark `xxhash64(...)`, seed 42, a long."""

    def __init__(self, *exprs, seed: int = XXHASH_DEFAULT_SEED):
        super().__init__(list(exprs))
        self.seed = seed

    @property
    def dtype(self):
        return long

    @property
    def nullable(self):
        return False

    def key(self):
        return ("xxhash64", self.seed,
                tuple(c.key() for c in self.children))

    def eval(self, ctx):
        h = xxhash64_columns([c.eval(ctx) for c in self.children],
                             self.seed)
        return DeviceColumn(long, h, torch.ones_like(h, dtype=torch.bool))


HASH_EXPRESSIONS = (Murmur3Hash, XxHash64)
