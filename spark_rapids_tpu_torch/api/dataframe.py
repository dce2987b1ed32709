"""DataFrame — the user-facing lazy query surface, counterpart of
`spark_rapids_tpu/api/dataframe.py` for the port's slice: `select`
(window expressions extracted into Window nodes), `filter`/`where`,
`withColumn`, `withColumnRenamed`, `join` of every type on names or on
a condition, `crossJoin`, `union`/`unionAll`, `repartition`,
`groupBy(...).agg(...)`, `orderBy`/`sort`, `limit`, `distinct`, device
caching, `collect_arrow`/`collect`, `count`, `explain` and `write` (Delta
tables; `DataFrameWriter`). Every
resolved expression gets the session's time zone (`_stamp_session`),
and a collect pins current_date and current_timestamp to one literal a
query (`_pin_query_time`).

A collect plans the query (cache substitution, the optimizer, the
planner) and dispatches it to an engine, recording which one ran in
`session.last_execution["engine"]` and why faster ones were skipped in
`["fallbacks"]`, as it records a shuffle mode the port runs in the
DEVICE mode's place. The port has three rungs of the reference's ladder:
`fused` (exec/fused.py; spark.rapids.sql.fusedExec.enabled, on by
default), whose settled factors and lowerings land in
`last_execution["fused"]` and whose `FusedCompileError` is recorded as a
fallback (in `["fallbacks"]`, and as `{"fallback": reason}` in
`["fused"]`: a query holding count(DISTINCT), sum(DISTINCT) or
percentile falls back so, as the reference's does); `aqe` (adaptive execution, whenever the plan has an exchange
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


def _stamp_session(expr: Expression, session) -> Expression:
    """Stamp spark.sql.session.timeZone on the time-zone-aware nodes (the
    zone becomes part of their keys), as the reference does after
    resolution."""
    from spark_rapids_tpu_torch.config import rapids_conf as rc
    from spark_rapids_tpu_torch.expr.cast import Cast
    from spark_rapids_tpu_torch.expr.datetimes import (
        CurrentDate,
        CurrentTimestamp,
        TzAware,
    )

    tz = session.rapids_conf.get(rc.SESSION_TZ) if session else "UTC"

    def fn(node):
        if isinstance(node, (TzAware, Cast, CurrentDate, CurrentTimestamp)):
            node.tz = tz  # node is a fresh copy from transform()
        return node

    return expr.transform(fn)


def _pin_query_time(plan):
    """Replace the current_date/current_timestamp markers with ONE literal
    a query (Spark pins both at query start), at physical planning."""
    import time

    import numpy as np

    from spark_rapids_tpu_torch.expr.core import Literal
    from spark_rapids_tpu_torch.expr.datetimes import (
        CurrentDate,
        CurrentTimestamp,
    )
    from spark_rapids_tpu_torch.ops import tzdb
    from spark_rapids_tpu_torch.sqltypes.datatypes import date, timestamp

    now_us = int(time.time() * 1_000_000)

    def efn(node):
        if isinstance(node, CurrentTimestamp):
            return Literal(now_us, timestamp)
        if isinstance(node, CurrentDate):
            local = int(tzdb.utc_to_local_np(
                np.array([now_us], np.int64), getattr(node, "tz", "UTC"))[0])
            return Literal(local // 86_400_000_000, date)
        return node

    return L.transform_expressions(plan, lambda e: e.transform(efn))


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
        ref = BoundReference(i, f.dataType, f.nullable)
        # provenance for join-condition resolution (df1.a == df2.b)
        ref._origin_plan = self._plan
        return Column(ref, name)

    # --- transformations ---

    def _col_expr(self, c) -> Expression:
        if isinstance(c, str):
            return _stamp_session(self[c].expr, self.session)
        if isinstance(c, Column):
            return _stamp_session(_resolve(c.expr, self.schema),
                                  self.session)
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
        return self._finish_project(exprs)

    def _finish_project(self, exprs: List[Alias]) -> "DataFrame":
        """Emit Project, extracting a generator into a Generate node
        (Spark's ExtractGenerator) or window expressions into Window nodes
        first (Spark's ExtractWindowExpressions): one Window node per
        (partitionBy, orderBy) spec, its columns appended to the child's,
        and the Project selecting them."""
        from spark_rapids_tpu_torch.expr.generators import (
            Explode,
            PosExplode,
            contains_generator,
        )
        from spark_rapids_tpu_torch.expr.windows import (
            WindowExpression,
            contains_window,
        )

        if any(contains_generator(e) for e in exprs):
            # Spark's ExtractGenerator: one top-level explode a select
            if any(contains_window(e) for e in exprs):
                raise ValueError(
                    "explode combined with window expressions in one "
                    "select is not supported; materialize the window "
                    "column with a prior select first")
            gens = [e for e in exprs if isinstance(e.children[0], Explode)]
            others = [e for e in exprs
                      if not isinstance(e.children[0], Explode)]
            if len(gens) != 1 or any(contains_generator(e) for e in others):
                raise ValueError(
                    "exactly one top-level explode/posexplode per select "
                    "(Spark's one-generator rule)")
            gen = gens[0]
            return DataFrame(L.Generate(
                others, gen, self._plan,
                position=isinstance(gen.children[0], PosExplode)),
                self.session)
        if not any(contains_window(e) for e in exprs):
            return DataFrame(L.Project(exprs, self._plan), self.session)
        plan = self._plan
        n_base = len(plan.schema.fields)
        groups = {}  # sort_key -> [Alias(WindowExpression)]
        for e in exprs:
            base = e.children[0]
            if isinstance(base, WindowExpression):
                groups.setdefault(base.spec.sort_key(), []).append(e)
            elif contains_window(e):
                raise NotImplementedError(
                    "window expressions must be top-level in v1 "
                    "(wrap arithmetic around them in a second select)")
        appended = {}
        ordinal = n_base
        for aliases in groups.values():
            plan = L.Window(aliases, plan)
            for a in aliases:
                appended[id(a)] = ordinal
                ordinal += 1
        out = []
        for e in exprs:
            if id(e) in appended:
                out.append(Alias(
                    BoundReference(appended[id(e)], e.dtype, True), e.name))
            else:
                out.append(e)
        return DataFrame(L.Project(out, plan), self.session)

    def withColumn(self, name: str, c: Column) -> "DataFrame":
        exprs = []
        replaced = False
        for j, f in enumerate(self.schema.fields):
            if f.name == name:
                exprs.append(Alias(self._col_expr(c), name))
                replaced = True
            else:
                exprs.append(Alias(BoundReference(j, f.dataType, f.nullable),
                                   f.name))
        if not replaced:
            exprs.append(Alias(self._col_expr(c), name))
        return self._finish_project(exprs)

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        exprs = [Alias(BoundReference(j, f.dataType, f.nullable),
                       new if f.name == old else f.name)
                 for j, f in enumerate(self.schema.fields)]
        return DataFrame(L.Project(exprs, self._plan), self.session)

    def filter(self, condition) -> "DataFrame":
        if isinstance(condition, str):
            raise NotImplementedError("SQL string filters: use Column")
        return DataFrame(L.Filter(self._col_expr(condition), self._plan),
                         self.session)

    where = filter

    def _same_device(self, other: "DataFrame") -> None:
        """Two DataFrames combine only on one device: the result runs in
        this DataFrame's session, which would otherwise read the other's
        relations (another device's cached parts) in its query."""
        if other.session is not self.session and (
                other.session.device != self.session.device):
            raise ValueError(
                f"cannot combine a DataFrame of a session on "
                f"{other.session.device} with one on {self.session.device}")

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        self._same_device(other)
        return DataFrame(
            L.Join(self._plan, other._plan, "cross", [], []), self.session)

    def _resolve_combined(self, other: "DataFrame", e) -> Expression:
        """Resolve an expression against [left fields | right fields]:
        an UnresolvedColumn binds left first; a BoundReference taken from
        `other` (df2["x"]) shifts into the right half."""
        n_l = len(self.schema.fields)

        def go(node):
            if isinstance(node, UnresolvedColumn):
                try:
                    i = _field_index(self.schema, node.name)
                    f = self.schema.fields[i]
                    return BoundReference(i, f.dataType, f.nullable)
                except KeyError:
                    i = _field_index(other.schema, node.name)
                    f = other.schema.fields[i]
                    return BoundReference(n_l + i, f.dataType, f.nullable)
            if isinstance(node, BoundReference):
                org = getattr(node, "_origin_plan", None)
                if org is other._plan:
                    return BoundReference(node.ordinal + n_l, node.dtype,
                                          node.nullable)
                if org is None or org is self._plan:
                    return node
                raise ValueError(
                    "join condition references a column from a DataFrame "
                    "that is neither side of this join; re-derive it from "
                    "the joined inputs")
            if isinstance(node, Expression):
                return node.with_children([go(c) for c in node.children])
            raise TypeError(f"cannot resolve {node!r}")

        return _stamp_session(go(e), self.session)

    @staticmethod
    def _promote_keys(lk, rk):
        """Implicit numeric promotion of mismatched key types (Spark's
        ImplicitTypeCasts)."""
        from spark_rapids_tpu_torch.expr.cast import Cast
        from spark_rapids_tpu_torch.sqltypes import NumericType
        from spark_rapids_tpu_torch.sqltypes.datatypes import (
            numeric_promotion,
        )

        out_l, out_r = [], []
        for a, b in zip(lk, rk):
            if a.dtype != b.dtype:
                if isinstance(a.dtype, NumericType) and isinstance(
                        b.dtype, NumericType):
                    common = numeric_promotion(a.dtype, b.dtype)
                    a = a if a.dtype == common else Cast(a, common)
                    b = b if b.dtype == common else Cast(b, common)
                else:
                    raise TypeError(
                        f"join key type mismatch: {a.dtype} vs {b.dtype}")
            out_l.append(a)
            out_r.append(b)
        return out_l, out_r

    @staticmethod
    def _split_conjuncts(e: Expression) -> List[Expression]:
        from spark_rapids_tpu_torch.expr import And

        if isinstance(e, And):
            return (DataFrame._split_conjuncts(e.children[0])
                    + DataFrame._split_conjuncts(e.children[1]))
        return [e]

    def _extract_equi_keys(self, cond: Expression):
        """Spark's ExtractEquiJoinKeys: the EqualTo conjuncts whose sides
        reference one input each become keys; the rest stays a
        condition."""
        from spark_rapids_tpu_torch.exec.joins import remap_refs
        from spark_rapids_tpu_torch.expr import And, EqualTo

        n_l = len(self.schema.fields)
        lk, rk, rest = [], [], []
        for c in self._split_conjuncts(cond):
            if isinstance(c, EqualTo):
                a, b = c.children
                ra, rb = a.references(), b.references()
                if ra and rb:
                    if max(ra) < n_l <= min(rb):
                        lk.append(a)
                        rk.append(b)
                        continue
                    if max(rb) < n_l <= min(ra):
                        lk.append(b)
                        rk.append(a)
                        continue
            rest.append(c)
        rk = [remap_refs(k, lambda o: o - n_l) for k in rk]
        remainder = None
        for c in rest:
            remainder = c if remainder is None else And(remainder, c)
        return lk, rk, remainder

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Join on column name(s) present on both sides or on a boolean
        Column over both sides (its equalities become keys, the rest a
        condition), of any type: inner, cross, left, right, full (outer),
        left_semi (semi), left_anti (anti)."""
        self._same_device(other)
        how = {"outer": "full", "full_outer": "full", "leftouter": "left",
               "left_outer": "left", "rightouter": "right",
               "right_outer": "right", "leftsemi": "left_semi",
               "semi": "left_semi", "leftanti": "left_anti",
               "anti": "left_anti"}.get(how, how)
        if on is None:
            if how not in ("inner", "cross"):
                raise ValueError(
                    f"join type {how!r} requires join keys or a condition")
            return self.crossJoin(other)
        if how == "cross":
            # keys given: Spark treats cross-with-keys as an equi join
            how = "inner"
        if isinstance(on, str):
            on = [on]
        if isinstance(on, (Column, Expression)):
            cond = self._resolve_combined(
                other, on.expr if isinstance(on, Column) else on)
            lk, rk, remainder = self._extract_equi_keys(cond)
            lk, rk = self._promote_keys(lk, rk)
            jt = "cross" if not lk and remainder is None else how
            plan = L.Join(self._plan, other._plan, jt, lk, rk,
                          condition=remainder)
            return DataFrame(plan, self.session)
        if isinstance(on, (list, tuple)) and on and isinstance(on[0], str):
            lk = [self[c].expr for c in on]
            rk = [other[c].expr for c in on]
        else:
            raise TypeError(
                "join `on` must be column name(s) or a Column expression")
        # name-keyed joins rewrite mismatched key columns to the common
        # type in place (the joined output carries the promoted type, as
        # Spark's ImplicitTypeCasts do on USING joins)
        plk, prk = self._promote_keys(lk, rk)
        df_l, df_r = self, other
        if any(p is not o for p, o in zip(plk, lk)):
            for i, (p, o) in enumerate(zip(plk, lk)):
                if p is not o:
                    df_l = df_l.withColumn(on[i], Column(p))
            lk = [df_l[c].expr for c in on]
        if any(p is not o for p, o in zip(prk, rk)):
            for i, (p, o) in enumerate(zip(prk, rk)):
                if p is not o:
                    df_r = df_r.withColumn(on[i], Column(p))
            rk = [df_r[c].expr for c in on]
        return DataFrame(L.Join(df_l._plan, df_r._plan, how, lk, rk),
                         self.session)

    def union(self, other: "DataFrame") -> "DataFrame":
        self._same_device(other)
        return DataFrame(L.Union([self._plan, other._plan]), self.session)

    unionAll = union

    def orderBy(self, *cols, ascending=None) -> "DataFrame":
        from spark_rapids_tpu_torch.api.column import SortColumn
        from spark_rapids_tpu_torch.expr.windows import contains_window

        orders = []
        asc_list = (ascending if isinstance(ascending, (list, tuple))
                    else [ascending] * len(cols))
        for c, asc in zip(cols, asc_list):
            if isinstance(c, SortColumn):
                orders.append(L.SortOrder(
                    _stamp_session(_resolve(c.expr, self.schema),
                                   self.session),
                    c.ascending, c.nulls_first))
                continue
            a = True if asc is None else bool(asc)
            orders.append(L.SortOrder(self._col_expr(c), a))
        for o in orders:
            if contains_window(o.expr):
                raise ValueError(
                    "window functions are not allowed in orderBy; "
                    "materialize with select/withColumn first")
        return DataFrame(L.Sort(orders, self._plan, global_sort=True),
                         self.session)

    sort = orderBy

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self._plan), self.session)

    def distinct(self) -> "DataFrame":
        return self.groupBy(*self.columns).agg()

    def repartition(self, n: int, *cols) -> "DataFrame":
        """An explicit exchange into n partitions: by a hash of `cols`, or
        round-robin without them."""
        keys = [self._col_expr(c) for c in cols] or None
        return DataFrame(L.Repartition(self._plan, n, keys), self.session)

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

        # cache substitution first: pinning rebuilds nodes, and the cache
        # matches subtrees by identity
        plan = self.session.cache_manager.substitute(self._plan)
        plan = _pin_query_time(plan)
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

        with self.session.activated():
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
                rec["fused"] = {"fallback": str(e)}

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

    @property
    def write(self) -> "DataFrameWriter":
        return DataFrameWriter(self)

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


class DataFrameWriter:
    """df.write.format("delta").mode(...).option(...).save(path) — the
    Delta Lake commit protocol (lakehouse/delta.py): `delta.*` options
    become table properties, `mode` is error (errorifexists), append,
    overwrite or ignore. Partitioned Delta writes raise, as in the
    reference. The other formats ride the reference's columnar writers,
    its committed-output protocol and its stage scheduler
    (`io/writers.py`, `io/commit.py`, `runtime/scheduler.py`), which are
    not ported yet (ROADMAP A14); nor are the reference's query-scoped
    write events (A17)."""

    def __init__(self, df: DataFrame):
        self._df = df
        self._format = "parquet"
        self._mode = "error"
        self._partition_by: List[str] = []
        self._options: dict = {}

    def format(self, fmt: str) -> "DataFrameWriter":
        self._format = fmt
        return self

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = {"errorifexists": "error"}.get(m, m)
        return self

    def option(self, k, v) -> "DataFrameWriter":
        self._options[k] = v
        return self

    def partitionBy(self, *cols) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    def save(self, path: str):
        if self._format != "delta":
            raise NotImplementedError(
                f"{self._format} writes are not ported yet (ROADMAP A14: "
                "io/writers.py, io/commit.py, runtime/scheduler.py)")
        from spark_rapids_tpu_torch.lakehouse.delta import write_delta

        props = {k: str(v) for k, v in self._options.items()
                 if k.startswith("delta.")}
        write_delta(self._df, path, mode=self._mode,
                    partition_by=self._partition_by,
                    properties=props or None)

    def delta(self, path: str):
        self._format = "delta"
        return self.save(path)


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
