"""DataFrame — the user-facing lazy query surface, counterpart of
`spark_rapids_tpu/api/dataframe.py` for the port's slice: `select`,
`filter`/`where`, inner `join`, `groupBy(...).agg(...)`, device caching,
`collect_arrow`/`collect`, `count` and `explain`.

A collect plans the query (cache substitution, the optimizer, the
planner) and dispatches it to an engine, recording which one ran in
`session.last_execution["engine"]` and why faster ones were skipped in
`["fallbacks"]`, as it records a shuffle mode the port runs in the
DEVICE mode's place. The port has three rungs of the reference's ladder:
`fused` (exec/fused.py; spark.rapids.sql.fusedExec.enabled, on by
default), whose settled factors and lowerings land in
`last_execution["fused"]` and whose `FusedCompileError` is recorded as a
fallback; `aqe` (adaptive execution, whenever the plan has an exchange
and spark.sql.adaptive.enabled is on); and `eager`. The reference's
demotion ladder (circuit breaker, OOM injection) is not ported and there
is no CPU rung: a failure on the card propagates.
"""

from __future__ import annotations

from typing import List

import pyarrow as pa

from spark_rapids_tpu_torch.api.column import Column
from spark_rapids_tpu_torch.api.functions import UnresolvedColumn
from spark_rapids_tpu_torch.expr import Alias, BoundReference
from spark_rapids_tpu_torch.expr.aggregates import AggregateFunction
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.plan import logical as L


def _field_index(schema, name: str) -> int:
    lowered = [n.lower() for n in schema.names]
    if name in schema.names:
        return schema.names.index(name)
    if name.lower() in lowered:
        return lowered.index(name.lower())
    raise KeyError(f"column {name!r} not in {schema.names}")


def _resolve(expr, schema) -> Expression:
    """Replace UnresolvedColumn markers with BoundReferences."""
    if isinstance(expr, UnresolvedColumn):
        i = _field_index(schema, expr.name)
        f = schema.fields[i]
        return BoundReference(i, f.dataType, f.nullable)
    if isinstance(expr, Expression):
        return expr.with_children([_resolve(c, schema)
                                   for c in expr.children])
    raise TypeError(f"cannot resolve {expr!r}")


def _named(expr: Expression, fallback: str) -> Alias:
    if isinstance(expr, Alias):
        return expr
    return Alias(expr, fallback)


def _input_name(fn: AggregateFunction) -> str:
    if not fn.children:
        return "*"
    c = fn.children[0]
    if isinstance(c, BoundReference):
        return f"#{c.ordinal}"
    return repr(c)


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session):
        self._plan = plan
        self.session = session

    # --- schema ---

    @property
    def schema(self):
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return self._plan.schema.names

    def __getitem__(self, name: str) -> Column:
        i = _field_index(self.schema, name)
        f = self.schema.fields[i]
        return Column(BoundReference(i, f.dataType, f.nullable), name)

    # --- transformations ---

    def _col_expr(self, c) -> Expression:
        if isinstance(c, str):
            return self[c].expr
        if isinstance(c, Column):
            return _resolve(c.expr, self.schema)
        raise TypeError(repr(c))

    def select(self, *cols) -> "DataFrame":
        exprs = []
        for i, c in enumerate(cols):
            if isinstance(c, str) and c == "*":
                for j, f in enumerate(self.schema.fields):
                    exprs.append(Alias(BoundReference(j, f.dataType,
                                                      f.nullable), f.name))
                continue
            name = c if isinstance(c, str) else c.name
            exprs.append(_named(self._col_expr(c),
                                name if isinstance(name, str)
                                else f"col{i}"))
        return DataFrame(L.Project(exprs, self._plan), self.session)

    def filter(self, condition) -> "DataFrame":
        if isinstance(condition, str):
            raise NotImplementedError("SQL string filters: use Column")
        return DataFrame(L.Filter(self._col_expr(condition), self._plan),
                         self.session)

    where = filter

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Equi-join on column name(s) present on both sides. Other join
        types, join conditions and implicit key casts are not ported yet
        (ROADMAP A13)."""
        if how != "inner":
            raise NotImplementedError(
                f"{how} joins are not ported yet (ROADMAP A13)")
        if isinstance(on, str):
            on = [on]
        if not (isinstance(on, (list, tuple)) and on
                and all(isinstance(c, str) for c in on)):
            raise NotImplementedError(
                "joins on expressions or without keys are not ported yet "
                "(ROADMAP A13); pass the key column name(s)")
        lk = [self[c].expr for c in on]
        rk = [other[c].expr for c in on]
        for a, b in zip(lk, rk):
            if a.dtype != b.dtype:
                raise NotImplementedError(
                    f"join key types {a.dtype} and {b.dtype} differ: "
                    "implicit key casts are not ported yet (ROADMAP A12)")
        return DataFrame(L.Join(self._plan, other._plan, how, lk, rk),
                         self.session)

    def groupBy(self, *cols) -> "GroupedData":
        return GroupedData(self, list(cols))

    def agg(self, *cols) -> "DataFrame":
        return GroupedData(self, []).agg(*cols)

    # --- caching ---

    def cache(self, storage: str = "host") -> "DataFrame":
        """storage="device" registers this DataFrame's plan with the
        session's CacheManager: every query over an equal subtree then
        reads it from device memory. The host tier (a result blob) is
        not ported yet (ROADMAP A9)."""
        if storage != "device":
            raise NotImplementedError(
                f"cache(storage={storage!r}) is not ported yet (ROADMAP "
                "A9); use storage='device'")
        self.session.cache_manager.register(self._plan,
                                            self.session.rapids_conf)
        return self

    def unpersist(self) -> "DataFrame":
        self.session.cache_manager.unregister(self._plan)
        return self

    # --- actions ---

    def _physical(self):
        from spark_rapids_tpu_torch.plan.optimizer import optimize
        from spark_rapids_tpu_torch.plan.overrides import plan_query

        plan = self.session.cache_manager.substitute(self._plan)
        return plan_query(optimize(plan), self.session.rapids_conf)

    def collect_arrow(self) -> pa.Table:
        rec = {"engine": None, "fallbacks": [], "aqe": None, "fused": None}
        self._last_exec = rec
        self.session.last_execution = rec

        def ran(engine: str, out: pa.Table) -> pa.Table:
            rec["engine"] = engine
            return out

        def fell_back(engine: str, reason: str) -> None:
            rec["fallbacks"].append((engine, reason))

        phys, _meta = self._physical()
        if self.session.rapids_conf.is_explain_only:
            return pa.table({})
        return self._dispatch_engines(phys, ran, fell_back, rec)

    def _dispatch_engines(self, phys, ran, fell_back, rec) -> pa.Table:
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        from spark_rapids_tpu_torch.exec.operators import (
            TpuShuffleExchangeExec,
        )

        conf = self.session.rapids_conf
        if conf.get(rc.MESH_SIZE):
            raise NotImplementedError(
                "the mesh engine is not ported yet (ROADMAP A16)")
        if conf.get(rc.FUSED_EXEC):
            from spark_rapids_tpu_torch.exec.fused import (
                FusedCompileError,
                FusedSingleChipExecutor,
            )

            ex = FusedSingleChipExecutor(conf)
            try:
                out = ex.execute(phys)
                rec["fused"] = dict(zip(
                    ("expansion", "group_cap", "use_lookup", "use_pushdown"),
                    ex.last_settled))
                return ran("fused", out)
            except FusedCompileError as e:
                # no fused lowering: structural, not a failure
                fell_back("fused", str(e))

        def has_exchange(n):
            return isinstance(n, TpuShuffleExchangeExec) or any(
                has_exchange(c) for c in n.children)

        exchange = has_exchange(phys)
        mode = conf.get(rc.SHUFFLE_MODE)
        if exchange and mode != "DEVICE":
            # ICI raised at planning; the host-block modes run DEVICE
            fell_back(f"shuffle {mode}",
                      f"the {mode} shuffle (host-serialized blocks) is not "
                      "ported yet (ROADMAP A13); the exchange ran the "
                      "DEVICE mode")
        if exchange and conf.get(rc.ADAPTIVE_ENABLED):
            from spark_rapids_tpu_torch.plan.aqe import AdaptiveQueryExecutor

            ex = AdaptiveQueryExecutor(conf)
            out = ex.execute(phys)
            rec["aqe"] = list(ex.decisions)
            return ran("aqe", out)
        return ran("eager", phys.collect())

    def collect(self) -> List["Row"]:
        t = self.collect_arrow()
        names = t.column_names
        cols = [t.column(i).to_pylist() for i in range(t.num_columns)]
        return [Row(zip(names, vals)) for vals in zip(*cols)] if cols \
            else []

    def count(self) -> int:
        from spark_rapids_tpu_torch.api import functions as F

        agg_df = self.agg(F.count("*").alias("count"))
        return agg_df.collect_arrow().column("count").to_pylist()[0]

    def explain(self, extended: bool = False):
        phys, meta = self._physical()
        print("== Physical Plan ==")
        print(phys.pretty())
        if extended:
            print("== Device Placement ==")
            print(meta.explain(only_not_on_device=False))
        rec = getattr(self, "_last_exec", None)
        if rec is not None and rec["engine"] is not None:
            print("== Engine ==")
            print(rec["engine"])
            for eng, reason in rec["fallbacks"]:
                print(f"  fell back from {eng}: {reason}")
            for d in rec.get("aqe") or []:
                print(f"  aqe: {d}")


class Row(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __repr__(self):
        return "Row(" + ", ".join(f"{k}={v!r}" for k, v in
                                  self.items()) + ")"


class GroupedData:
    """groupBy(cols).agg(...); rollup, cube and grouping sets are not
    ported yet (ROADMAP A12)."""

    def __init__(self, df: DataFrame, cols):
        self.df = df
        self.grouping = [
            _named(df._col_expr(c), c if isinstance(c, str) else c.name)
            for c in cols]

    def agg(self, *cols) -> DataFrame:
        aggs = []
        for c in cols:
            e = self.df._col_expr(c)
            base = e.children[0] if isinstance(e, Alias) else e
            if not isinstance(base, AggregateFunction):
                raise TypeError(
                    f"agg() requires aggregate expressions, got {base!r}")
            name = (e.name if isinstance(e, Alias)
                    else f"{base.name}({_input_name(base)})")
            aggs.append(Alias(base, name))
        plan = L.Aggregate(self.grouping, aggs, self.df._plan)
        return DataFrame(plan, self.df.session)
