"""Regex expressions — counterpart of `spark_rapids_tpu/expr/regexexpr.py`:
RLike on the device through the pattern's DFA (kernel K18), and
RegexpExtract and RegexpReplace, which have no device implementation in
the reference (capture groups and replacement need a backtracking
engine): its planner sends them to its CPU engine, which the port does
not have yet (ROADMAP A9), so the port's planner refuses them with the
reference's reason, and so an untranspilable RLike pattern.
"""

from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.regex import (
    CompiledRegex,
    RegexUnsupported,
    compile_search,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import boolean, string


class RLike(Expression):
    """Spark `rlike` / RLIKE: unanchored regex search, compiled to a DFA
    when the pattern is in the transpilable subset."""

    def __init__(self, child: Expression, pattern: str):
        super().__init__([child])
        self.pattern = pattern
        self._compiled: Optional[CompiledRegex] = None
        self._compile_error: Optional[str] = None
        try:
            self._compiled = compile_search(pattern)
        except RegexUnsupported as e:
            self._compile_error = str(e)

    @property
    def dtype(self):
        return boolean

    def device_supported(self) -> Optional[str]:
        if self._compiled is None:
            return (f"regex {self.pattern!r} not transpilable to DFA: "
                    f"{self._compile_error}")
        return None

    def key(self):
        return ("rlike", self.pattern, self.children[0].key())

    def eval(self, ctx):
        from spark_rapids_tpu_torch.ops import regexops

        col = self.children[0].eval(ctx)
        m = regexops.dfa_match(col.data, col.lengths, self._compiled)
        return DeviceColumn(boolean, m, col.validity)


class RegexpExtract(Expression):
    """regexp_extract(col, pattern, idx): no device implementation (the
    reference runs it on its CPU engine: capture groups)."""

    def __init__(self, child: Expression, pattern: str, idx: int = 1):
        super().__init__([child])
        self.pattern = pattern
        self.idx = idx

    @property
    def dtype(self):
        return string

    def device_supported(self) -> Optional[str]:
        return "regexp_extract runs on CPU in v1 (capture groups)"

    def key(self):
        return ("regexp_extract", self.pattern, self.idx,
                self.children[0].key())


class RegexpReplace(Expression):
    """regexp_replace(col, pattern, replacement): no device
    implementation (the reference runs it on its CPU engine)."""

    def __init__(self, child: Expression, pattern: str, replacement: str):
        super().__init__([child])
        self.pattern = pattern
        self.replacement = replacement

    @property
    def dtype(self):
        return string

    @property
    def nullable(self):
        return self.children[0].nullable

    def device_supported(self) -> Optional[str]:
        return "regexp_replace runs on CPU in v1"

    def key(self):
        return ("regexp_replace", self.pattern, self.replacement,
                self.children[0].key())
