"""Expressions: references, literals, predicates, arithmetic, aggregate
functions, string functions, regex, casts and datetimes."""

from spark_rapids_tpu_torch.expr.aggregates import (  # noqa: F401
    AggregateFunction,
    AnyValue,
    ApproxPercentile,
    Average,
    BoolAnd,
    BoolOr,
    CollectList,
    CollectSet,
    Corr,
    Count,
    CountDistinct,
    CovarPop,
    CovarSamp,
    First,
    Kurtosis,
    Last,
    Max,
    Min,
    Percentile,
    Skewness,
    StddevPop,
    StddevSamp,
    Sum,
    SumDistinct,
    VariancePop,
    VarianceSamp,
)
from spark_rapids_tpu_torch.expr.arith import (  # noqa: F401
    Add,
    Divide,
    Multiply,
    Subtract,
)
from spark_rapids_tpu_torch.expr.cast import Cast  # noqa: F401
from spark_rapids_tpu_torch.expr.core import (  # noqa: F401
    Alias,
    BoundReference,
    EvalContext,
    Expression,
    Literal,
)
from spark_rapids_tpu_torch.expr.datetimes import (  # noqa: F401
    DayOfMonth,
    Hour,
    Minute,
    Month,
    Second,
    Year,
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
from spark_rapids_tpu_torch.expr.regexexpr import (  # noqa: F401
    RegexpExtract,
    RegexpReplace,
    RLike,
)
from spark_rapids_tpu_torch.expr.strings import (  # noqa: F401
    Ascii,
    Chr,
    Concat,
    ConcatWs,
    Contains,
    EndsWith,
    InitCap,
    Length,
    Lower,
    StartsWith,
    StringInstr,
    StringLocate,
    StringLPad,
    StringRepeat,
    StringReplace,
    StringReverse,
    StringRPad,
    StringTranslate,
    StringTrim,
    StringTrimLeft,
    StringTrimRight,
    Substring,
    SubstringIndex,
    Upper,
)
