"""The slice's three date queries through the port's and the JAX package's
sessions.

q5.py's orders_q4_window_query (typed ORDERS, zone UTC),
orders_ingest_query (the .tbl text, zone America/Los_Angeles) and
orders_monthly_query (typed ORDERS, zone America/Los_Angeles) run over a
3,000-row table that write_orders_dated writes in 2 files: the port's
adaptive engine over the parquet files and its fused engine over
relations cached on the device, each equal to the reference's session
(bench.py's conf, the fused engine off; its reader packs the two small
files into one scan task) ignoring row order: counts, keys, dates and
integer sums exactly, double sums within 1e-9 relative
(docs/compatibility.md "Execution"). With the per-file reader, the port's
only one, each query's physical plan is the reference's but for the
batch coalescing the reference inserts after a scan (not ported yet,
ROADMAP A8).
"""

import importlib.util
import os

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.q5 import (
    orders_ingest_query,
    orders_monthly_query,
    orders_q4_window_query,
    write_orders_dated,
)

REL_TOL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LA = "America/Los_Angeles"


def _bench_conf():
    spec = importlib.util.spec_from_file_location(
        "srtpu_bench_dates", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._session_conf()


CONF = _bench_conf()
#: one scan task a file in both sessions, so the plans compare
PERFILE = {"spark.rapids.sql.format.parquet.reader.type": "PERFILE"}

#: name -> (query, table, session zone, group keys)
QUERIES = {
    "orders_q4_window": (orders_q4_window_query, "orders_dated", "UTC",
                         ["o_orderpriority"]),
    "orders_ingest": (orders_ingest_query, "orders_tbl", LA, ["o_year"]),
    "orders_monthly": (orders_monthly_query, "orders_dated", LA,
                       ["month", "ist_hour"]),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain versions on one thread (beside the other xdist
    workers, torch's intra-op threads oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("date_queries"))
    write_orders_dated(root, rows=3_000, files=2, seed=3)
    return root


def _run(pkg, which, root, fused, collect=True):
    """(answer or None, last_execution, the PERFILE plan's tree)."""
    build, table, zone, _ = QUERIES[which]
    conf = dict(CONF, **PERFILE, **{
        "spark.rapids.sql.fusedExec.enabled": fused,
        "spark.sql.session.timeZone": zone})
    if pkg == "jax":
        spark, F = JaxSession(conf), JF
    else:
        spark = TpuSparkSession(dict(conf, **{
            "spark.rapids.torch.device": "cpu"}))
        F = PF
    try:
        df = spark.read.parquet(os.path.join(root, table))
        if fused:
            df = df.cache(storage="device")
        q = build(df, F=F)
        out = q.collect_arrow() if collect else None
        return out, dict(spark.last_execution or {}), _tree(
            q._physical()[0])
    finally:
        spark.stop()


def _reference_answer(which, root):
    """The reference's answer with bench.py's conf as it stands (its reader
    makes one scan task of the two files: no exchange to compile)."""
    build, table, zone, _ = QUERIES[which]
    spark = JaxSession(dict(CONF, **{
        "spark.rapids.sql.fusedExec.enabled": False,
        "spark.sql.session.timeZone": zone}))
    try:
        return build(spark.read.parquet(os.path.join(root, table)),
                     F=JF).collect_arrow()
    finally:
        spark.stop()


def _tree(node, depth=0):
    """The physical tree's operator names, the reference's after-scan batch
    coalescing left out."""
    name = type(node).__name__
    rows = [] if name == "TpuCoalesceBatchesExec" else [(depth, name)]
    for c in node.children:
        rows += _tree(c, depth + (name != "TpuCoalesceBatchesExec"))
    return rows


@pytest.fixture(scope="module")
def reference(data):
    """Each query's answer and PERFILE plan in the reference's session,
    computed once."""
    cache = {}

    def get(which):
        if which not in cache:
            cache[which] = (_reference_answer(which, data),
                            _run("jax", which, data, False,
                                 collect=False)[2])
        return cache[which]
    return get


def _assert_same(got: pa.Table, want: pa.Table, keys):
    assert got.schema.names == want.schema.names
    assert got.num_rows == want.num_rows

    def rows(t):
        return {tuple(r[k] for k in keys): r for r in t.to_pylist()}

    g, w = rows(got), rows(want)
    assert set(g) == set(w) and len(g) == want.num_rows
    for k, row in w.items():
        for col, v in row.items():
            if isinstance(v, float):
                assert g[k][col] == pytest.approx(v, rel=REL_TOL), (k, col)
            else:
                assert g[k][col] == v, (k, col)


@pytest.mark.parametrize("fused", [False, True], ids=["aqe", "fused"])
@pytest.mark.parametrize("which", sorted(QUERIES))
def test_date_query_matches_reference(data, reference, which, fused):
    want, want_plan = reference(which)
    got, ex, plan = _run("port", which, data, fused)
    assert ex["engine"] == ("fused" if fused else "aqe"), ex
    assert not ex["fallbacks"], ex
    if not fused:
        assert plan == want_plan
    _assert_same(got, want, QUERIES[which][3])
    assert got.num_rows > 0


def test_ingest_reads_the_session_zone(data):
    """unix_timestamp of a date is its local midnight in the session zone:
    Los Angeles is 7 (PDT) or 8 (PST) hours behind UTC, so each year's sum
    of the timestamps grows by 7 to 8 hours a row, both occurring."""
    sums = {}
    for zone in ("UTC", LA):
        conf = dict(CONF, **PERFILE, **{
            "spark.rapids.torch.device": "cpu",
            "spark.sql.session.timeZone": zone})
        spark = TpuSparkSession(conf)
        try:
            out = orders_ingest_query(spark.read.parquet(
                os.path.join(data, "orders_tbl"))).collect_arrow()
        finally:
            spark.stop()
        sums[zone] = {r["o_year"]: (r["ts_sum"], r["n"])
                      for r in out.to_pylist()}
    assert sums["UTC"].keys() == sums[LA].keys()
    for year, (utc, n) in sums["UTC"].items():
        shift = sums[LA][year][0] - utc
        assert 7 * 3600 * n < shift < 8 * 3600 * n, (year, shift, n)


def test_fused_narrowed_dates_and_timestamps(tmp_path):
    """The fused engine's narrowed upload: a date column that fits int16
    and a timestamp column within +-35 minutes of the epoch (int32) ship
    narrowed with a vrange and widen back; grouped by the date (and its
    year in the session zone) with the timestamps' min, max, count and
    hour, the port's fused engine equals the reference's."""
    import numpy as np
    import pyarrow.parquet as pq

    rng = np.random.default_rng(91)
    n = 2_000
    days = rng.integers(-400, 400, n).astype(np.int32)
    ts = rng.integers(-2_000_000_000, 2_000_000_000, n)
    path = os.path.join(tmp_path, "narrow.parquet")
    pq.write_table(pa.table({
        "d": pa.array(days, pa.date32(), mask=rng.random(n) < 0.05),
        "t": pa.array(ts, pa.timestamp("us", tz="UTC"),
                      mask=rng.random(n) < 0.05)}), path)

    def query(df, F):
        return (df.select("d", "t", F.year("d").alias("y"),
                          F.hour("t").alias("h"))
                .groupBy("d", "y")
                .agg(F.min("t").alias("lo"), F.max("t").alias("hi"),
                     F.count("t").alias("n"), F.max("h").alias("h")))

    outs = {}
    for pkg in ("jax", "port"):
        conf = dict(CONF, **{"spark.sql.session.timeZone": LA})
        if pkg == "jax":
            spark, F = JaxSession(conf), JF
        else:
            spark = TpuSparkSession(dict(conf, **{
                "spark.rapids.torch.device": "cpu"}))
            F = PF
        try:
            df = spark.read.parquet(path).cache(storage="device")
            outs[pkg] = query(df, F).collect_arrow()
            assert spark.last_execution["engine"] == "fused"
        finally:
            spark.stop()
    _assert_same(outs["port"], outs["jax"], ["d", "y"])
