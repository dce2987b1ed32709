"""The slice's three statistical queries through the port's and the JAX
package's sessions.

q5.py's orders_price_stats_query (variance, stddev, skewness, kurtosis,
covariance, corr, percentile_approx, bool_and and bool_or per priority
and year), orders_daily_distinct_query (count, count(DISTINCT o_custkey)
and the median price per order date) and orders_price_window_query (a
100-row moving stddev and a whole-priority variance) run over a 3,000-row
dated ORDERS table that write_orders_dated writes in 2 files, at
spark.rapids.sql.batchSizeRows 2,048 (a partial a file, a hash exchange,
merged partials):
the port's adaptive engine over the parquet files and its fused engine
over relations cached on the device, each against the reference's
session (bench.py's conf, the fused engine off), its answer computed once
a query. (tests/test_torch_aggregates.py holds the fused engine's
percentile_approx to the reference's fused engine; the reference's fused
run of this query takes about a minute on the CPU.)

Tolerances: group keys, counts, bool_and/or, count(DISTINCT) and the
points percentile_approx selects are exact; the median (percentile's
interpolation) within 1e-12 relative; the moment and bivariate results,
whose formulas cancel, within 1e-9 of the size of their terms (the
formula over the terms' absolute values, as tests/test_torch_aggregates.py
states it); the window's variances likewise, from each frame's sums of x
and x^2 (the reference takes a frame's sums as differences of one prefix
over the whole batch, the port restarts it at each partition). The fused
engine's percentile_approx is held to the reference's fused engine, whose
partials are cut elsewhere (the sketch depends on the cuts), so there it
is held to the sketch's rank bound: its rank among the group's prices
within 2/K + 2/n of 0.9 (two merge levels of K = 128 points, n rows).
"""

import importlib.util
import math
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.api.window import Window as JaxWindow
from spark_rapids_tpu.plan import aqe as jax_aqe
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.q5 import (
    orders_daily_distinct_query,
    orders_price_stats_query,
    orders_price_window_query,
    write_orders_dated,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERM_TOL = 1e-9
INTERP_REL = 1e-12


def _bench_conf():
    spec = importlib.util.spec_from_file_location(
        "srtpu_bench_stats", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._session_conf()


CONF = dict(_bench_conf(), **{
    "spark.rapids.sql.format.parquet.reader.type": "PERFILE",
    "spark.rapids.sql.batchSizeRows": 2048,
    "spark.rapids.sql.reader.batchSizeRows": 2048,
    # the fused engine's partials at 1,024 groups, not 65,536: the plain
    # versions pay for every buffer row
    "spark.rapids.sql.fusedExec.groupCapacity": 1024})

#: name -> (query, group keys, the engine its fused run settles on)
QUERIES = {
    "orders_price_stats": (orders_price_stats_query,
                           ["o_orderpriority", "o_year"], "fused"),
    "orders_daily_distinct": (orders_daily_distinct_query, ["o_orderdate"],
                              "aqe"),
    "orders_price_window": (orders_price_window_query, ["o_orderkey"],
                            "fused"),
}
MOMENTS = {"var_samp", "var_pop", "sd_samp", "sd_pop", "skew", "kurt",
           "cov_pop", "cov_samp", "corr"}


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
    root = str(tmp_path_factory.mktemp("stat_queries"))
    write_orders_dated(root, rows=3_000, files=2, seed=3)
    return os.path.join(root, "orders_dated")


def _session(pkg, fused):
    conf = dict(CONF, **{"spark.rapids.sql.fusedExec.enabled": fused})
    if pkg == "jax":
        return JaxSession(conf), JF
    return TpuSparkSession(dict(conf, **{
        "spark.rapids.torch.device": "cpu"})), PF


def _run(pkg, build, path, fused):
    """(answer, last_execution, the physical tree)."""
    spark, F = _session(pkg, fused)
    try:
        df = spark.read.parquet(path)
        if fused:
            df = df.cache(storage="device")
        if build is orders_price_window_query and pkg == "jax":
            q = build(df, F=F, Window=JaxWindow)
        else:
            q = build(df, F=F)
        out, rec = _collect_recording_aqe(pkg, spark, q)
        return out, rec, _tree(q._physical()[0])
    finally:
        spark.stop()


def _collect_recording_aqe(pkg, spark, q):
    """Collect q; the last_execution record, with the reference's adaptive
    decisions (its session does not record them) under "aqe"."""
    if pkg != "jax":
        return q.collect_arrow(), dict(spark.last_execution or {})
    decisions = []
    orig = jax_aqe.AdaptiveQueryExecutor.execute

    def spy(self, phys):
        out = orig(self, phys)
        decisions.extend(self.decisions)
        return out

    jax_aqe.AdaptiveQueryExecutor.execute = spy
    try:
        out = q.collect_arrow()
    finally:
        jax_aqe.AdaptiveQueryExecutor.execute = orig
    rec = dict(spark.last_execution or {})
    rec["aqe"] = decisions if rec.get("engine") == "aqe" else None
    return out, rec


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
    """Each query's answer and plan in the reference's session, computed
    once."""
    cache = {}

    def get(which):
        if which not in cache:
            cache[which] = _run("jax", QUERIES[which][0], data, False)
        return cache[which]
    return get


def _rows(table, keys):
    return {tuple(r[k] for k in keys): r for r in table.to_pylist()}


def _orders(path):
    import pyarrow.parquet as pq

    t = pq.read_table(path)
    prio = np.asarray(t.column("o_orderpriority").to_pylist())
    days = t.column("o_orderdate").cast(pa.int32()).to_numpy()
    return dict(key=t.column("o_orderkey").to_numpy(), prio=prio, day=days,
                year=np.array([int(str(np.datetime64(int(d), "D"))[:4])
                               for d in days]),
                price=t.column("o_totalprice").to_numpy())


def _stat_scale(name, x, y):
    """The terms' size a moment result is held to (1e-9 of it)."""
    n = float(len(x))
    s = [math.fsum(np.abs(x) ** p) for p in range(5)]
    mu = s[1] / n
    m2 = abs(math.fsum(x * x) - math.fsum(x) ** 2 / n)
    if name in ("var_samp", "var_pop", "sd_samp", "sd_pop"):
        return (s[2] + s[1] * mu) / max(n - 1.0, 1.0)
    if name == "skew":
        return (s[3] + 3 * mu * s[2] + 2 * mu * mu * s[1]) / m2 ** 1.5 \
            * math.sqrt(n)
    if name == "kurt":
        return (s[4] + 4 * mu * s[3] + 6 * mu * mu * s[2]
                + 3 * mu ** 3 * s[1]) / (m2 * m2) * n
    cov = math.fsum(np.abs(x * y)) + s[1] * math.fsum(np.abs(y)) / n
    if name == "corr":
        vy = abs(math.fsum(y * y) - math.fsum(y) ** 2 / n)
        return cov / math.sqrt(m2 * vy)
    return cov / max(n - 1.0, 1.0)


def _close(name, got, want, scale):
    if name.startswith("sd"):
        got, want = got * got, want * want
    assert abs(got - want) <= TERM_TOL * scale, (name, got, want, scale)


def _check_stats(got, want, orders, fused):
    keys = QUERIES["orders_price_stats"][1]
    g, w = _rows(got, keys), _rows(want, keys)
    assert set(g) == set(w) and len(w) == 35
    day0 = (np.datetime64("1992-01-01", "D") - np.datetime64(0, "D")).astype(
        int)
    for k, row in w.items():
        sel = (orders["prio"] == k[0]) & (orders["year"] == k[1])
        x = orders["price"][sel]
        y = (orders["day"][sel] - day0).astype(float)
        for col, v in row.items():
            if col in MOMENTS:
                _close(col, g[k][col], v, _stat_scale(col, x, y))
            elif col == "p90" and fused:
                xs = np.sort(x)
                rank = np.searchsorted(xs, g[k][col], side="right") / len(x)
                assert abs(rank - 0.9) <= 2 / 128 + 2 / len(x), (k, rank)
            else:
                assert g[k][col] == v, (k, col)


def _check_daily(got, want):
    keys = QUERIES["orders_daily_distinct"][1]
    g, w = _rows(got, keys), _rows(want, keys)
    assert set(g) == set(w) and len(w) > 1000
    for k, row in w.items():
        assert g[k]["n"] == row["n"] and g[k]["customers"] == row[
            "customers"], k
        assert g[k]["median"] == pytest.approx(row["median"],
                                               rel=INTERP_REL), k


def _check_window(got, want, orders):
    keys = QUERIES["orders_price_window"][1]
    g, w = _rows(got, keys), _rows(want, keys)
    assert set(g) == set(w) and len(w) == 3_000
    order = np.lexsort((orders["key"], orders["day"], orders["prio"]))
    prio, x = orders["prio"][order], orders["price"][order]
    c1 = np.concatenate([[0.0], np.cumsum(x)])
    c2 = np.concatenate([[0.0], np.cumsum(x * x)])
    start = np.zeros(len(x), dtype=np.int64)
    for i in range(1, len(x)):
        start[i] = start[i - 1] if prio[i] == prio[i - 1] else i
    part_end = {p: np.max(np.nonzero(prio == p)[0]) + 1 for p in set(prio)}
    for i, key in enumerate(orders["key"][order]):
        lo = max(start[i], i - 99)
        n = i + 1 - lo
        s1, s2 = c1[i + 1] - c1[lo], c2[i + 1] - c2[lo]
        row, mine = w[(key,)], g[(key,)]
        if n < 2:
            assert row["sd100"] is None and mine["sd100"] is None
        else:
            _close("sd100", mine["sd100"], row["sd100"],
                   (s2 + s1 * s1 / n) / (n - 1))
        hi = part_end[prio[i]]
        n = hi - start[i]
        s1, s2 = c1[hi] - c1[start[i]], c2[hi] - c2[start[i]]
        _close("prio_var", mine["prio_var"], row["prio_var"],
               (s2 + s1 * s1 / n) / n)
        for col in ("o_orderpriority", "o_orderdate", "o_totalprice"):
            assert mine[col] == row[col]


@pytest.mark.parametrize("fused", [False, True], ids=["aqe", "fused"])
@pytest.mark.parametrize("which", sorted(QUERIES))
def test_stat_query_matches_reference(data, reference, which, fused):
    """The port's answer, engine and (adaptive) physical tree against the
    reference's session's."""
    want, wexec, want_plan = reference(which)
    build, _, fused_engine = QUERIES[which]
    got, ex, plan = _run("port", build, data, fused)
    assert ex["engine"] == (fused_engine if fused else "aqe"), ex
    if fused and fused_engine == "aqe":
        (eng, reason), = [f for f in ex["fallbacks"] if f[0] == "fused"]
        assert "no fused lowering" in reason
    else:
        assert not [f for f in ex["fallbacks"] if f[0] == "fused"], ex
    if not fused:
        assert plan == want_plan
        assert wexec["engine"] == "aqe"
        assert ex["aqe"] == wexec["aqe"]
    orders = _orders(data)
    if which == "orders_price_stats":
        _check_stats(got, want, orders, fused)
    elif which == "orders_daily_distinct":
        _check_daily(got, want)
    else:
        _check_window(got, want, orders)
