"""The slice's four expression queries, and the functions and Column
entry points, through the port's and the JAX package's sessions.

q5.py's q22_full_query (TPC-H q22 as written: substring, IN, the scalar
subquery as a crossJoin to a one-row aggregate, a left anti join),
orders_priority_split_query (q12's CASE WHEN split over IN),
orders_hash_sample_query (a pmod(xxhash64) sample grouped by
pmod(hash), a MinHash min(xxhash64(...)) as hex) and
customer_value_bands_query (a left join, isNull, IN over the
dictionary-encoded c_mktsegment, %, coalesce, greatest, floor(log10(abs)),
round and ceil) run over `write_customer_data`'s tables at a few hundred
rows (comments of 19 to 78 bytes: past xxhash64's 32-byte stripes) on the
port's adaptive engine (parquet) and fused engine (relations cached on
the device), each equal to the reference's session (adaptive engine),
ignoring row order, double sums within 1e-9 relative; each reaches the
plain versions of K30, K6 and K24's hex mode where the card would launch
them. The reference's functions module has no `pmod`: the tests give it
one over its own Pmod expression, as its Column API reaches it.
"""

import os

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.expr import Pmod as JaxPmod
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.expr import hashexpr as port_hash
from spark_rapids_tpu_torch.expr import mathexpr as port_math
from spark_rapids_tpu_torch.q5 import (
    customer_value_bands_query,
    orders_hash_sample_query,
    orders_priority_split_query,
    q22_full_query,
    write_customer_data,
)

REL_TOL = 1e-9
CONF = {"spark.sql.autoBroadcastJoinThreshold": -1,
        "spark.sql.shuffle.partitions": 4,
        "spark.rapids.sql.format.parquet.reader.type": "PERFILE"}


class _ReferenceFunctions:
    """The reference's functions module with PySpark's pmod added."""

    def __getattr__(self, name):
        return getattr(JF, name)

    @staticmethod
    def pmod(dividend, divisor):
        return JF.Column(JaxPmod(JF.expr_of(dividend), JF.expr_of(divisor)))


#: query -> (builder, key columns of a result row, the wrappers it must
#: reach)
QUERIES = {
    "q22_full": (q22_full_query, ["cntrycode"], set()),
    "orders_priority_split": (orders_priority_split_query, ["o_year"],
                              set()),
    "orders_hash_sample": (orders_hash_sample_query, ["bucket"],
                           {"xxhash64", "murmur3", "hex"}),
    "customer_value_bands": (customer_value_bands_query, ["band"], set()),
}
#: the engine each query runs on with the fused engine on: q22's
#: crossJoin is a nested-loop join, which neither package's fused engine
#: lowers
FUSED_ENGINE = {q: "fused" for q in QUERIES}
FUSED_ENGINE["q22_full"] = "aqe"


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
    root = str(tmp_path_factory.mktemp("expr_queries"))
    write_customer_data(root, customers=80, orders=700, files=2, seed=3)
    return root


def _run(pkg, build, root, fused):
    """(answer, last_execution) of one query through one session: the
    fused engine over relations cached on the device, the adaptive engine
    over the parquet files."""
    conf = dict(CONF, **{"spark.rapids.sql.fusedExec.enabled": fused})
    if pkg == "jax":
        spark, F = JaxSession(conf), _ReferenceFunctions()
    else:
        spark = TpuSparkSession(dict(conf, **{
            "spark.rapids.torch.device": "cpu"}))
        F = PF
    try:
        frames = {t: spark.read.parquet(os.path.join(root, t))
                  for t in ("customer", "orders_cust")}
        if fused:
            frames = {t: f.cache(storage="device") for t, f in frames.items()}
        q = build(frames, F)
        return q.collect_arrow(), dict(spark.last_execution)
    finally:
        spark.stop()


def _query(which):
    b = QUERIES[which][0]
    if which == "orders_priority_split":
        return lambda fr, F: b(fr["orders_cust"], F=F)
    if which == "orders_hash_sample":
        return lambda fr, F: b(fr["orders_cust"], F=F)
    return lambda fr, F: b(fr["customer"], fr["orders_cust"], F=F)


@pytest.fixture(scope="module")
def reference(data):
    """Each query's answer in the reference's session (adaptive engine),
    computed once."""
    cache = {}

    def get(which):
        if which not in cache:
            cache[which] = _run("jax", _query(which), data, False)[0]
        return cache[which]
    return get


def _assert_same(got: pa.Table, want: pa.Table, keys):
    assert got.schema.names == want.schema.names
    assert [f.type for f in got.schema] == [f.type for f in want.schema]
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
    """The kernel wrappers each run calls (on the CPU they run their plain
    versions): K30, K6 behind hash(), K24's hex mode."""
    seen = set()
    for mod, name, tag in ((port_hash, "xxhash64_columns", "xxhash64"),
                           (port_hash, "murmur3_columns", "murmur3"),
                           (port_math, "hex_text", "hex")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _tag=tag, **k):
            seen.add(_tag)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.mark.parametrize("fused", [False, True], ids=["aqe", "fused"])
@pytest.mark.parametrize("which", sorted(QUERIES))
def test_expr_query_matches_reference(data, reference, reached, which,
                                      fused):
    want = reference(which)
    got, ex = _run("port", _query(which), data, fused)
    assert ex["engine"] == (FUSED_ENGINE[which] if fused else "aqe"), ex
    assert QUERIES[which][2] <= reached, reached
    _assert_same(got, want, QUERIES[which][1])
    assert got.num_rows > 0


def test_q22_crossjoin_falls_back_from_fused_in_both(data):
    """The scalar subquery's crossJoin is a nested-loop join: with the
    fused engine on, both packages run q22 on the adaptive engine."""
    build = _query("q22_full")
    got, ex = _run("port", build, data, True)
    want, wex = _run("jax", build, data, True)
    assert ex["engine"] == wex["engine"] == "aqe"
    assert [e for e, _ in ex["fallbacks"]][0] == "fused"


def _api_frame(F, df):
    """Every slice-10 entry point of functions and Column in one select
    (c_acctbal where c_nationkey > 12, else null, stands in for a
    nullable double: CUSTOMER has no null)."""
    a, b, d = F.col("c_acctbal"), F.col("c_nationkey"), F.col("c_custkey")
    n = F.when(b > 12, a)
    return df.select(
        (d % 7).alias("mod"), (-a).alias("neg"),
        n.eqNullSafe(a).alias("eqns"), n.isNull().alias("isnull"),
        n.isNotNull().alias("notnull"), F.sqrt(a).isNaN().alias("isnan"),
        F.col("c_mktsegment").isin("AUTOMOBILE", None).alias("isin"),
        F.abs(a).alias("abs"), F.coalesce(n, a).alias("coalesce"),
        F.when(b > 20, "hi").when(b > 10, "mid").otherwise("lo").alias("w"),
        n.alias("w_null"), F.nvl(n, -1.0).alias("nvl"),
        F.nvl2(n, b, d).alias("nvl2"), F.nanvl(F.sqrt(a), a).alias("nanvl"),
        F.greatest(n, b, d).alias("greatest"), F.least(a, n).alias("least"),
        F.round(a, 1).alias("round"), F.bround(a, -1).alias("bround"),
        F.ceil(a).alias("ceil"), F.floor(a).alias("floor"),
        F.pow(b, 2).alias("pow"), F.log(a).alias("ln"),
        F.log(2.0, d).alias("log2b"), F.atan2(a, b).alias("atan2"),
        F.hypot(a, b).alias("hypot"), F.sqrt(d).alias("sqrt"),
        F.signum(a).alias("signum"), F.degrees(b).alias("degrees"),
        F.log10(d).alias("log10"), F.log2(d).alias("log2"),
        F.log1p(d).alias("log1p"), F.exp(b).alias("exp"),
        F.bitwise_not(d).alias("bnot"), F.shiftleft(d, 3).alias("shl"),
        F.shiftright(d, 1).alias("shr"),
        F.shiftrightunsigned(-d, 60).alias("shru"),
        F.hash(d, F.col("c_phone")).alias("hash"),
        F.xxhash64(F.col("c_phone"), n).alias("xxhash64"),
        F.hex(d).alias("hex"), F.pmod(-d, 9).alias("pmod"))


@pytest.mark.parametrize("fused", [False, True], ids=["aqe", "fused"])
def test_functions_api_matches_reference(data, fused):
    """The entry points compose through both sessions to the same rows
    (exact but for the transcendental ones, within 1e-12 relative)."""
    def build(frames, F):
        return _api_frame(F, frames["customer"])

    got, ex = _run("port", build, data, fused)
    want, _ = _run("jax", build, data, False)
    assert ex["engine"] == ("fused" if fused else "eager"), ex
    assert got.schema.names == want.schema.names
    assert [f.type for f in got.schema] == [f.type for f in want.schema]
    g = sorted(got.to_pylist(), key=lambda r: r["hash"])
    w = sorted(want.to_pylist(), key=lambda r: r["hash"])
    for gr, wr in zip(g, w):
        for col, v in wr.items():
            if isinstance(v, float) and v == v:
                assert gr[col] == pytest.approx(v, rel=1e-12), col
            elif isinstance(v, float):
                assert gr[col] != gr[col], col
            else:
                assert gr[col] == v, col
