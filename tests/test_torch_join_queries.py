"""The slice's six join queries through the port's and the JAX package's
sessions.

q5.py's q13_outer_query (TPC-H q13: a conditional left outer join),
q22_anti_query (q22's NOT EXISTS: a left anti join),
orders_yoy_full_query (a full outer join), orders_price_bands_query (a
condition-only full outer nested-loop join), customer_segments_query (a
join on dictionary-encoded keys of two dictionaries) and
orders_union_rr_query (a union and a round-robin repartition) run over
`write_customer_data`'s tables at a few hundred rows, with
spark.sql.autoBroadcastJoinThreshold=-1 (every hash join shuffled, as at
full size) and the PERFILE reader. The port's adaptive engine (over the
parquet files) and fused engine (over relations cached on the device)
each equal the reference's session with the fused engine off, ignoring
row order (double sums within 1e-9 relative); the port's physical tree
equals the reference's; and each query reaches the plain versions of the
slice's kernels (K27-K29) where the card would launch them. The
nested-loop join has no fused lowering in either package: both hand it to
the adaptive engine. A right join plans as a swapped left join and a
reordering project, a cross join as a nested loop, in both.
"""

import os

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.columnar import encoding as port_encoding
from spark_rapids_tpu_torch.ops import joinops as port_joinops
from spark_rapids_tpu_torch.ops import partition as port_partition
from spark_rapids_tpu_torch.q5 import (
    customer_segments_query,
    orders_price_bands_query,
    orders_union_rr_query,
    orders_yoy_full_query,
    q13_outer_query,
    q22_anti_query,
    write_customer_data,
)

REL_TOL = 1e-9
CONF = {"spark.sql.autoBroadcastJoinThreshold": -1,
        "spark.sql.shuffle.partitions": 4,
        "spark.rapids.sql.format.parquet.reader.type": "PERFILE"}

#: query -> (builder, tables, key columns of a result row, the slice's
#: kernel wrappers it must reach on the adaptive and on the fused engine)
QUERIES = {
    "q13_outer": (q13_outer_query, ("customer", "orders_cust"),
                  ["c_count"], {"probe_marks"}, {"probe_marks"}),
    "q22_anti": (q22_anti_query, ("customer", "orders_cust"),
                 ["cntrycode"], set(), set()),
    "orders_yoy_full": (orders_yoy_full_query, ("orders_cust",),
                        ["customers"], {"build_coverage"},
                        {"build_coverage"}),
    "orders_price_bands": (orders_price_bands_query, ("orders_cust", "bands"),
                           ["b_band"], {"probe_marks", "build_marks"},
                           {"probe_marks", "build_marks"}),
    "customer_segments": (customer_segments_query, ("quota", "customer"),
                          ["c_mktsegment", "c_nationkey"], {"remap_codes"},
                          {"remap_codes"}),
    "orders_union_rr": (orders_union_rr_query, ("orders_cust",),
                        ["o_orderpriority"], {"round_robin_perm"}, set()),
}
#: the engine each query runs on with the fused engine on
FUSED_ENGINE = {q: "fused" for q in QUERIES}
FUSED_ENGINE["orders_price_bands"] = "aqe"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: beside the other test workers' pools its
    intra-op threads oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("join_queries"))
    write_customer_data(root, customers=60, orders=600, files=2, seed=1)
    return root


def _tree(node, depth=0):
    """The physical tree's operator names and join types, the reference's
    after-scan batch coalescing left out."""
    name = type(node).__name__
    rows = ([] if name == "TpuCoalesceBatchesExec"
            else [(depth, name, getattr(node, "join_type", None))])
    for c in node.children:
        rows += _tree(c, depth + (name != "TpuCoalesceBatchesExec"))
    return rows


def _run(pkg, which, root, fused, build=None):
    """(answer, last_execution, physical tree) of one query through one
    session: the fused engine over relations cached on the device, the
    adaptive engine over the parquet files."""
    b, tables = QUERIES[which][:2] if build is None else build
    conf = dict(CONF, **{"spark.rapids.sql.fusedExec.enabled": fused})
    if pkg == "jax":
        spark, F = JaxSession(conf), JF
    else:
        spark = TpuSparkSession(dict(conf, **{
            "spark.rapids.torch.device": "cpu"}))
        F = PF
    try:
        frames = [spark.read.parquet(os.path.join(root, t)) for t in tables]
        if fused:
            frames = [f.cache(storage="device") for f in frames]
        q = b(*frames, F=F)
        out = q.collect_arrow()
        return out, dict(spark.last_execution), _tree(q._physical()[0])
    finally:
        spark.stop()


@pytest.fixture(scope="module")
def reference(data):
    """Each query's answer and plan in the reference's session (adaptive
    engine), computed once."""
    cache = {}

    def get(which):
        if which not in cache:
            out, _, tree = _run("jax", which, data, False)
            cache[which] = (out, tree)
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


@pytest.fixture
def reached(monkeypatch):
    """The slice's kernel wrappers each run calls (on the CPU they run
    their plain versions)."""
    seen = set()
    for mod, name in ((port_joinops, "probe_marks"),
                      (port_joinops, "build_marks"),
                      (port_joinops, "build_coverage"),
                      (port_partition, "round_robin_perm"),
                      (port_encoding, "remap_codes")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.add(_name)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.mark.parametrize("fused", [False, True], ids=["aqe", "fused"])
@pytest.mark.parametrize("which", sorted(QUERIES))
def test_join_query_matches_reference(data, reference, reached, which,
                                      fused):
    want, want_tree = reference(which)
    got, ex, tree = _run("port", which, data, fused)
    engine = FUSED_ENGINE[which] if fused else "aqe"
    if which == "customer_segments" and not fused:
        engine = "eager"  # one file a side: no exchange to adapt
    assert ex["engine"] == engine, ex
    if not fused:  # the fused runs read cached relations
        assert tree == want_tree
    assert reached == QUERIES[which][4 if fused else 3]
    _assert_same(got, want, QUERIES[which][2])
    assert got.num_rows > 0


def test_nested_loop_join_falls_back_from_fused_in_both(data):
    """Neither package's fused engine lowers a nested-loop join: with the
    fused engine on, both run the bands query on the adaptive engine."""
    got, ex, _ = _run("port", "orders_price_bands", data, True)
    want, wex, _ = _run("jax", "orders_price_bands", data, True)
    assert ex["engine"] == wex["engine"] == "aqe"
    assert [e for e, _ in ex["fallbacks"]][0] == "fused"
    assert any("NestedLoopJoin" in r for _, r in ex["fallbacks"])
    _assert_same(got, want, ["b_band"])


def _right_and_cross(customer, orders, F=None):
    """A right join (planned as a swapped left join and a reordering
    project) unioned with a cross join of the bands (a nested loop)."""
    right = (orders.select("o_custkey", "o_totalprice")
             .join(customer.select("c_custkey", "c_nationkey"),
                   on=F.col("o_custkey") == F.col("c_custkey"), how="right")
             .groupBy("c_nationkey")
             .agg(F.count("o_custkey").alias("n"),
                  F.sum("o_totalprice").alias("v")))
    cross = (customer.filter(F.col("c_custkey") < 4).select("c_nationkey")
             .crossJoin(orders.filter(F.col("o_orderkey") < 40)
                        .select("o_totalprice"))
             .groupBy("c_nationkey")
             .agg(F.count("*").alias("n"), F.sum("o_totalprice").alias("v")))
    return right.union(cross)


@pytest.mark.parametrize("fused", [False, True], ids=["aqe", "fused"])
def test_right_and_cross_joins_match_reference(data, fused):
    build = (_right_and_cross, ("customer", "orders_cust"))
    want, _, want_tree = _run("jax", None, data, False, build=build)
    got, ex, tree = _run("port", None, data, fused, build=build)
    if not fused:
        assert tree == want_tree
    # the right join: a reordering project over a swapped left join
    assert any(a[1] == "TpuProjectExec" and b[1:] == (
        "TpuShuffledHashJoinExec", "left") and b[0] == a[0] + 1
        for a, b in zip(tree, tree[1:]))
    assert any(n == "TpuBroadcastNestedLoopJoinExec" and jt == "cross"
               for _, n, jt in tree)

    def rows(t):
        return sorted((r["c_nationkey"], r["n"], round(r["v"] or 0.0, 6))
                      for r in t.to_pylist())

    assert rows(got) == rows(want)
