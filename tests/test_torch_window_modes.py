"""The rest of the window through both sessions: the four window-mode
queries of q5.py (running, moving, range and u2u) and ScaleTest q6 as
written, on the fused and the adaptive engine; the planner's choice of
window mode against the reference's; the reference's streaming-window
cases; and min/max as group-by aggregates.

Both sessions read bench.py's data shape at 6,000 fact rows (20 stores,
2 files) cached on the device, with the reference's streaming tests'
chunk size (tests/test_window_streaming.py: spark.rapids.sql.batchSizeRows
512) on both sides, so the running carry and the halo cross chunk
boundaries, and the DEVICE shuffle mode, which the port's exchange runs.
Results compare ignoring row order (a window keeps its input rows, and
the engines emit them in other orders): rows sorted by their
key columns, integers exact, doubles within 1e-9 relative
(docs/compatibility.md, "Execution"); row_number and ntile, which order
the rows of an ORDER BY peer run as they arrived, compare as a multiset
within each (store, day) run. (store, day, amount) is unique in this data,
so the ROWS frames ordered by (day, amount) are deterministic.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.api.window import Window as JaxWindow
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.api.window import Window as PortWindow
from spark_rapids_tpu_torch.q5 import (
    moving_query,
    q6_query,
    range_query,
    running_query,
    u2u_query,
    write_q5_data,
)

REL_TOL = 1e-9

#: the reference's streaming-window conf (tests/test_window_streaming.py)
STREAM_CONF = {"spark.sql.shuffle.partitions": 2,
               "spark.rapids.sql.batchSizeRows": 512,
               "spark.rapids.sql.reader.batchSizeRows": 512,
               "spark.rapids.shuffle.mode": "DEVICE"}

_PORT_QUERIES = {"running": running_query, "moving": moving_query,
                 "range": range_query, "u2u": u2u_query, "q6": q6_query}

#: the window mode (presorted, halo, mode) each query is planned with
_MODES = {"running": (True, None, "running"), "moving": (True, 6, None),
          "range": (False, None, None), "u2u": (False, None, "u2u"),
          "q6": (True, None, "running")}

#: columns ordering each query's rows, and those compared per peer run
_KEYS = {"running": (["store", "day", "amount"], []),
         "moving": (["store", "day", "amount"], []),
         "range": (["store", "day", "amount"], ["q4"]),
         "u2u": (["store", "amount", "qty"], []),
         "q6": (["store", "day"], ["rn"])}


def _jax_query(which, base):
    """The same five queries written against the JAX package's API."""
    F, W = JF, JaxWindow
    if which == "q6":
        w = W.partitionBy("store").orderBy("day")
        return base.select("store", "day", F.row_number().over(w).alias("rn"))
    if which == "running":
        w = W.partitionBy("store").orderBy("day", "amount")
        run = w.rowsBetween(W.unboundedPreceding, W.currentRow)
        return base.select("store", "day", "amount",
                           F.row_number().over(w).alias("rn"),
                           F.rank().over(w).alias("rk"),
                           F.dense_rank().over(w).alias("drk"),
                           F.sum("amount").over(run).alias("run_sum"),
                           F.min("amount").over(run).alias("run_min"),
                           F.max("amount").over(run).alias("run_max"),
                           F.count("amount").over(run).alias("run_cnt"))
    if which == "moving":
        w = W.partitionBy("store").orderBy("day", "amount")
        week = w.rowsBetween(-6, 0)
        return base.select("store", "day", "amount", "qty",
                           F.avg("amount").over(week).alias("avg7"),
                           F.max("amount").over(week).alias("max7"),
                           F.min("qty").over(w.rowsBetween(-3, 3)).alias(
                               "min_qty"),
                           F.lag("amount", 1).over(w).alias("prev"),
                           F.lead("amount", 2, 0.0).over(w).alias("next2"),
                           F.first("amount").over(week).alias("first7"),
                           F.last("amount", ignorenulls=True).over(
                               week).alias("last7"))
    if which == "range":
        w = W.partitionBy("store").orderBy("day")
        days = w.rangeBetween(-6, 0)
        return base.select("store", "day", "amount", "qty",
                           F.sum("amount").over(days).alias("sum7d"),
                           F.count("amount").over(days).alias("cnt7d"),
                           F.min("amount").over(days).alias("min7d"),
                           F.max("qty").over(days).alias("max_qty7d"),
                           F.percent_rank().over(w).alias("prk"),
                           F.cume_dist().over(w).alias("cd"),
                           F.ntile(4).over(w).alias("q4"))
    w = W.partitionBy("store")
    return base.select("store", "amount", "qty",
                       F.sum("amount").over(w).alias("tot"),
                       F.avg("amount").over(w).alias("mean"),
                       F.min("amount").over(w).alias("lo"),
                       F.max("qty").over(w).alias("qmax"),
                       F.count("*").over(w).alias("n"))


def _window_exec(phys):
    if type(phys).__name__ == "TpuWindowExec":
        return phys
    for c in phys.children:
        w = _window_exec(c)
        if w is not None:
            return w
    return None


def _mode(df):
    w = _window_exec(df._physical()[0])
    return (w.presorted, w.halo, w.mode)


def _session(pkg, conf):
    if pkg == "jax":
        return JaxSession(conf)
    return TpuSparkSession(dict(conf, **{"spark.rapids.torch.device":
                                         "cpu"}))


def assert_same_rows(got: pa.Table, want: pa.Table, keys, per_run=()):
    """Equal ignoring row order: both sorted by `keys`, integers exact,
    doubles within 1e-9 relative (NaN equal to NaN); `per_run` columns as
    a multiset within each (store, day) run."""
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    order = [(k, "ascending") for k in keys]
    g, w = got.sort_by(order), want.sort_by(order)
    for name in want.schema.names:
        if name in per_run:
            continue
        gv, wv = g.column(name).to_pylist(), w.column(name).to_pylist()
        if pa.types.is_floating(want.schema.field(name).type):
            assert gv == pytest.approx(wv, rel=REL_TOL, nan_ok=True), name
        else:
            assert gv == wv, name
    for name in per_run:
        def runs(t):
            out = {}
            for s, d, v in zip(t.column("store").to_pylist(),
                               t.column("day").to_pylist(),
                               t.column(name).to_pylist()):
                out.setdefault((s, d), []).append(v)
            return {k: sorted(v) for k, v in out.items()}

        assert runs(g) == runs(w), name


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("window_modes"))
    fact_paths, _ = write_q5_data(root, rows=6000, stores=20, files=2,
                                  seed=0)
    t = pa.concat_tables([pq.read_table(p) for p in fact_paths])
    keys = set(zip(t.column("store").to_pylist(), t.column("day").to_pylist(),
                   t.column("amount").to_pylist()))
    assert len(keys) == t.num_rows  # the ROWS frames are deterministic
    return root


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "aqe"])
@pytest.mark.parametrize("which", list(_PORT_QUERIES))
def test_window_mode_queries_match_reference(data, which, fused):
    conf = dict(STREAM_CONF, **{"spark.rapids.sql.fusedExec.enabled": fused})
    out = {}
    for pkg in ("jax", "port"):
        spark = _session(pkg, conf)
        try:
            fact = spark.read.parquet(os.path.join(data, "fact")).cache(
                storage="device")
            df = (_PORT_QUERIES[which](fact) if pkg == "port"
                  else _jax_query(which, fact))
            mode = _mode(df)
            out[pkg] = (mode, df.collect_arrow(), dict(spark.last_execution))
        finally:
            spark.stop()
    (rmode, ref, rex), (pmode, got, pex) = out["jax"], out["port"]
    assert pmode == rmode == _MODES[which]
    assert pex["engine"] == rex["engine"] == ("fused" if fused else "aqe")
    assert pex["fallbacks"] == []
    assert got.num_rows == 6000
    keys, per_run = _KEYS[which]
    assert_same_rows(got, ref, keys, per_run)


# ------------------------------------------ the planner's window modes

def _specs(F, W):
    """Window selections over (g, o, v): the reference's window-streaming
    and window-test specs and this slice's queries' shapes."""
    w = W.partitionBy("g").orderBy("o")
    wv = W.partitionBy("g").orderBy("o", "v")
    run = wv.rowsBetween(W.unboundedPreceding, W.currentRow)
    whole = W.partitionBy("g")
    return {
        "ranks": [F.row_number().over(w), F.rank().over(w),
                  F.dense_rank().over(w)],
        "running_aggs": [F.sum("v").over(run), F.count("v").over(run),
                         F.min("v").over(run), F.max("v").over(run)],
        "running_first": [F.first("v").over(run)],
        "running_avg": [F.avg("v").over(run)],
        "no_partition": [F.row_number().over(W.orderBy("o", "v"))],
        "u2u": [F.sum("v").over(whole), F.avg("v").over(whole),
                F.count("v").over(whole), F.max("v").over(whole)],
        "u2u_first": [F.first("v").over(whole)],
        "u2u_rows": [F.sum("v").over(wv.rowsBetween(W.unboundedPreceding,
                                                    W.unboundedFollowing))],
        "mixed": [F.row_number().over(w), F.sum("v").over(whole)],
        "moving": [F.avg("v").over(wv.rowsBetween(-6, 0)),
                   F.lag("v", 1).over(wv), F.lead("v", 2).over(wv)],
        "lead_only": [F.lead("v", 3).over(w)],
        "wide_halo": [F.sum("v").over(wv.rowsBetween(-400, 0))],
        "range": [F.sum("v").over(w.rangeBetween(-2, 0))],
        "default_frame": [F.sum("v").over(w)],
        "rank_arith": [F.percent_rank().over(w), F.cume_dist().over(w),
                       F.ntile(3).over(w)],
        "first_last_rows": [F.first("v").over(wv.rowsBetween(-3, 0)),
                            F.last("v", True).over(wv.rowsBetween(-3, 0))],
    }


@pytest.fixture(scope="module")
def gov(tmp_path_factory):
    """A (g, o, v) table as a parquet file: the reference's streaming
    tests' shape."""
    rng = np.random.default_rng(5)
    n = 4000
    t = pa.table({
        "g": pa.array(rng.integers(0, 7, n), pa.int64()),
        "o": pa.array(rng.integers(0, 50, n), pa.int64()),
        "v": pa.array(np.where(rng.random(n) < 0.1, None,
                               rng.random(n) * 10), pa.float64()),
    })
    path = str(tmp_path_factory.mktemp("gov") / "gov.parquet")
    pq.write_table(t, path)
    return path


@pytest.mark.parametrize("name", list(_specs(PF, PortWindow)))
def test_planner_picks_the_reference_window_mode(gov, name):
    conf = dict(STREAM_CONF, **{"spark.rapids.sql.fusedExec.enabled": False})
    modes = []
    for pkg, F, W in (("jax", JF, JaxWindow), ("port", PF, PortWindow)):
        spark = _session(pkg, conf)
        try:
            cols = [c.alias(f"w{i}")
                    for i, c in enumerate(_specs(F, W)[name])]
            df = spark.read.parquet(gov).select("g", "o", "v", *cols)
            modes.append(_mode(df))
        finally:
            spark.stop()
    assert modes[1] == modes[0]


# ------------------------------- the reference's streaming-window cases

def _diff(tmp_path, table: pa.Table, query, keys, per_run=()):
    """One query over a parquet copy of `table` through both sessions,
    fused off (the streaming paths live on the per-operator engine)."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path)
    conf = dict(STREAM_CONF, **{"spark.sql.shuffle.partitions": 1,
                                "spark.rapids.sql.fusedExec.enabled": False})
    out = []
    for pkg, F, W in (("jax", JF, JaxWindow), ("port", PF, PortWindow)):
        spark = _session(pkg, conf)
        try:
            df = query(spark.read.parquet(path), F, W)
            out.append((_mode(df), df.collect_arrow()))
        finally:
            spark.stop()
    assert out[1][0] == out[0][0]
    assert_same_rows(out[1][1], out[0][1], keys, per_run)
    return out[1][0]


def test_running_nan_partition_key_across_chunks(tmp_path):
    """NaN partition keys stay one partition across chunk boundaries (the
    carry's NaN == NaN equality)."""
    n = 2000
    rng = np.random.default_rng(3)
    f = np.where(rng.random(n) < 0.3, np.nan,
                 rng.integers(0, 3, n).astype(np.float64))
    t = pa.table({"f": pa.array(f), "o": pa.array(np.arange(n))})

    def q(df, F, W):
        w = W.partitionBy("f").orderBy("o")
        return df.select("f", "o", F.row_number().over(w).alias("rn"))

    assert _diff(tmp_path, t, q, ["o"]) == (True, None, "running")


def test_u2u_null_partition_key(tmp_path):
    rng = np.random.default_rng(8)
    n = 2000
    g = [None if rng.random() < 0.15 else int(rng.integers(4))
         for _ in range(n)]
    t = pa.table({"g": pa.array(g, pa.int64()),
                  "v": pa.array(rng.random(n))})

    def q(df, F, W):
        w = W.partitionBy("g")
        return df.select("g", "v", F.sum("v").over(w).alias("ts"),
                         F.min("v").over(w).alias("tm"))

    assert _diff(tmp_path, t, q, ["v"]) == (False, None, "u2u")


def test_running_no_partition_global(tmp_path):
    rng = np.random.default_rng(2)
    n = 3000
    t = pa.table({"o": pa.array(rng.integers(0, 50, n), pa.int64()),
                  "v": pa.array(rng.random(n))})

    def q(df, F, W):
        w = W.orderBy("o", "v")
        return df.select("o", "v", F.row_number().over(w).alias("rn"))

    assert _diff(tmp_path, t, q, ["o", "v"]) == (True, None, "running")


def test_running_min_max_with_nulls_and_nans(tmp_path):
    """Running min and max over values with nulls, NaN, +-inf and +-0.0,
    and the running sum and count of a finite column with nulls, across
    chunk boundaries: the carry's null-skipping combine and its float
    rules are the reference's. (The sum takes finite values: the
    reference's sums subtract whole-chunk prefixes, so an inf in one
    partition turns later partitions' sums to NaN; ROADMAP C.)"""
    rng = np.random.default_rng(9)
    n = 3000
    v = rng.random(n) * 10 - 5
    pick = rng.random(n) < 0.2
    v[pick] = rng.choice([np.nan, 0.0, -0.0, np.inf, -np.inf],
                         int(pick.sum()))
    t = pa.table({"g": pa.array(rng.integers(0, 3, n), pa.int64()),
                  "o": pa.array(np.arange(n), pa.int64()),
                  "v": pa.array(v, mask=rng.random(n) < 0.1),
                  "x": pa.array(rng.random(n) * 10 - 5,
                                mask=rng.random(n) < 0.1)})

    def q(df, F, W):
        w = (W.partitionBy("g").orderBy("o")
             .rowsBetween(W.unboundedPreceding, W.currentRow))
        return df.select("g", "o", F.sum("x").over(w).alias("rs"),
                         F.count("x").over(w).alias("rc"),
                         F.min("v").over(w).alias("rmin"),
                         F.max("v").over(w).alias("rmax"))

    assert _diff(tmp_path, t, q, ["o"]) == (True, None, "running")


# ------------------------------------------ min and max in a group-by

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "aqe"])
def test_min_max_group_by_match_reference(data, fused):
    conf = dict(STREAM_CONF, **{"spark.rapids.sql.fusedExec.enabled": fused})
    out = []
    for pkg, F in (("jax", JF), ("port", PF)):
        spark = _session(pkg, conf)
        try:
            fact = spark.read.parquet(os.path.join(data, "fact")).cache(
                storage="device")
            df = fact.groupBy("store").agg(
                F.min("amount").alias("lo"), F.max("amount").alias("hi"),
                F.min("day").alias("first_day"), F.max("qty").alias("qmax"),
                F.count("*").alias("n"))
            out.append(df.collect_arrow())
        finally:
            spark.stop()
    assert_same_rows(out[1], out[0], ["store"])


def test_first_as_group_by_aggregate_raises_a12(data):
    """Group-by first() was refused naming A12 until slice 8 ported it
    (K12 over positions, K8's gather): it now plans, and each store's
    value is one of its amounts (which one follows the order its
    partials arrive in; tests/test_torch_aggregates.py holds it to the
    reference's)."""
    spark = _session("port", dict(STREAM_CONF))
    try:
        fact = spark.read.parquet(os.path.join(data, "fact"))
        got = fact.groupBy("store").agg(
            PF.first("amount").alias("f")).collect_arrow()
        facts = pq.read_table(os.path.join(data, "fact"))
    finally:
        spark.stop()
    amounts = {}
    for st, am in zip(facts.column("store").to_pylist(),
                      facts.column("amount").to_pylist()):
        amounts.setdefault(st, set()).add(am)
    rows = got.to_pylist()
    assert len(rows) == len(amounts)
    for r in rows:
        assert r["f"] in amounts[r["store"]], r


@pytest.mark.parametrize("case,match", [
    ("string_min", "A9"), ("range_desc", "A9"), ("range_two_keys", "A9"),
    ("group_by_string_max", "A12")])
def test_planner_refuses_what_the_reference_runs_on_its_cpu(data, case,
                                                            match):
    """Where the reference's planner sends a window or aggregate to its CPU
    engine, the port, which has none, raises naming the ROADMAP item that
    ports it: string min/max frames and RANGE offsets without one
    ascending numeric key (the CPU window, A9), and a group-by max of a
    string (A12)."""
    from spark_rapids_tpu_torch.api.functions import col

    spark = _session("port", dict(STREAM_CONF))
    try:
        fact = spark.read.parquet(os.path.join(data, "fact"))
        dim = spark.read.parquet(os.path.join(data, "dim"))
        W = PortWindow
        df = {
            "string_min": lambda: dim.select(
                "store", PF.min("region").over(
                    W.partitionBy("store")).alias("x")),
            "range_desc": lambda: fact.select(
                "store", PF.sum("amount").over(
                    W.partitionBy("store").orderBy(col("day").desc())
                    .rangeBetween(-2, 0)).alias("x")),
            "range_two_keys": lambda: fact.select(
                "store", PF.sum("amount").over(
                    W.partitionBy("store").orderBy("day", "qty")
                    .rangeBetween(-2, 0)).alias("x")),
            "group_by_string_max": lambda: dim.groupBy("store").agg(
                PF.max("region").alias("x")),
        }[case]()
        with pytest.raises(NotImplementedError, match=match):
            df.collect_arrow()
    finally:
        spark.stop()
