"""Expressions: references, literals, predicates, arithmetic and
aggregate functions."""

from spark_rapids_tpu_torch.expr.aggregates import (  # noqa: F401
    AggregateFunction,
    Average,
    Count,
    Sum,
)
from spark_rapids_tpu_torch.expr.arith import (  # noqa: F401
    Add,
    Divide,
    Multiply,
    Subtract,
)
from spark_rapids_tpu_torch.expr.core import (  # noqa: F401
    Alias,
    BoundReference,
    EvalContext,
    Expression,
    Literal,
)
from spark_rapids_tpu_torch.expr.predicates import (  # noqa: F401
    And,
    EqualTo,
    GreaterThan,
    GreaterThanOrEqual,
    LessThan,
    LessThanOrEqual,
    Not,
    Or,
)
