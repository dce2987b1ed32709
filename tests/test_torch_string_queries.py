"""The slice's four string queries through the port's and the JAX
package's sessions.

q5.py's string_q5_query, string_dup_query, orders_q13_query and
orders_words_query run over bench.py's tables at the small shape (in 2
files) and a 2,000-row ORDERS table: the port's adaptive engine (over the parquet
files) and fused engine (over relations cached on the device) each equal
to the reference's session with bench.py's conf and the fused engine
off,
ignoring row order (double sums within 1e-9 relative,
docs/compatibility.md "Execution"). Where the reference sends a regex
expression to its CPU engine, the port raises NotImplementedError naming
ROADMAP A9, and a string function over a number has no device lowering.
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
    orders_q13_query,
    orders_words_query,
    string_dup_query,
    string_q5_query,
    write_orders_data,
    write_q5_data,
)

REL_TOL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench():
    spec = importlib.util.spec_from_file_location(
        "srtpu_bench_strings", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH = _bench()
CONF = BENCH._session_conf()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain string versions on one thread: beside the other
    xdist workers' thread pools, torch's intra-op threads oversubscribe
    the host's cores and spin (string_dup's fused run took 215 s of a
    full run that way, 0.9 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("string_queries"))
    # bench.py's small shape in 2 files, not its 8: every cached part is
    # padded to the fused upload's 65,536-row bucket, and the string
    # plain versions pay for each padded row
    write_q5_data(root, rows=40_000, stores=BENCH.STORES,
                  regions=BENCH.REGIONS, files=2, seed=0,
                  dup_per_store=BENCH.DUP_PER_STORE)
    write_orders_data(root, rows=2_000, files=1, seed=5)
    return root


QUERIES = {
    "string_q5": (string_q5_query, ("fact", "dim"), ["rk"]),
    "string_dup": (string_dup_query, ("fact", "dup"), ["tag", "shape"]),
    "orders_q13": (orders_q13_query, ("orders",), ["o_orderpriority"]),
    "orders_words": (orders_words_query, ("orders",), ["word"]),
}


def _run(pkg, which, root, fused):
    """One query through one session: the fused engine over relations
    cached on the device (bench.py's path), the adaptive engine over the
    parquet files. A cached part is padded to the fused upload's 65,536-row
    bucket, where a scan batch takes the next power of two, so the
    adaptive runs stay small."""
    build, tables, _ = QUERIES[which]
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
        out = build(*frames, F=F).collect_arrow()
        return out, dict(spark.last_execution)
    finally:
        spark.stop()


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


@pytest.fixture(scope="module")
def reference(data):
    """The reference's answer to each query, computed once on its adaptive
    engine over the parquet files (bench.py's conf otherwise): its engines
    agree, and the fused engine's padded parts would cost it 30x the
    work."""
    cache = {}

    def get(which):
        if which not in cache:
            cache[which] = _run("jax", which, data, False)
        return cache[which]
    return get


@pytest.mark.parametrize("fused", [False, True], ids=["aqe", "fused"])
@pytest.mark.parametrize("which", sorted(QUERIES))
def test_query_matches_reference(data, reference, which, fused):
    want, jexec = reference(which)
    got, pexec = _run("port", which, data, fused)
    _assert_same(got, want, QUERIES[which][2])
    assert got.num_rows > 0
    assert pexec["fallbacks"] == [] and not jexec["fallbacks"]
    assert jexec["engine"] != "fused"
    # over parquet the reference's reader may leave one scan partition
    # (no exchange: "eager") where the port's per-file reader does not
    assert (pexec["engine"] == "fused") == fused


# ---------------------------------------------------- A9 refusals

@pytest.mark.parametrize("case", ["regexp_extract", "regexp_replace",
                                  "untranspilable", "disabled"])
def test_regex_the_reference_runs_on_its_cpu_raises_a9(data, case):
    extra = ({"spark.rapids.sql.regexp.enabled": False}
             if case == "disabled" else {})
    spark = TpuSparkSession(dict(CONF, **{"spark.rapids.torch.device": "cpu",
                                          **extra}))
    try:
        dup = spark.read.parquet(os.path.join(data, "dup"))
        col = {
            "regexp_extract": PF.regexp_extract("promo", r"(\d+)", 1),
            "regexp_replace": PF.regexp_replace("promo", r"\d", "#"),
            "untranspilable": PF.rlike("promo", r"(o)\1"),
            "disabled": PF.col("promo").rlike("promo_0[12]"),
        }[case]
        with pytest.raises(NotImplementedError, match="A9") as err:
            dup.select(col.alias("x")).collect_arrow()
        reason = {"regexp_extract": "capture groups",
                  "regexp_replace": "regexp_replace runs on CPU",
                  "untranspilable": "not transpilable",
                  "disabled": "regexp.enabled=false"}[case]
        assert reason in str(err.value)
    finally:
        spark.stop()


def test_string_function_over_a_number_is_refused(data):
    """The child types of the reference's ExprSig rows: a string function
    over a double (and chr over a string) has no device lowering."""
    spark = TpuSparkSession(dict(CONF, **{"spark.rapids.torch.device": "cpu"}))
    try:
        dup = spark.read.parquet(os.path.join(data, "dup"))
        for col, reason in ((PF.upper("discount"), "Upper parameter 0"),
                            (PF.chr_(PF.col("promo")), "Chr parameter 0")):
            with pytest.raises(NotImplementedError, match=reason):
                dup.select(col.alias("x")).collect_arrow()
    finally:
        spark.stop()
