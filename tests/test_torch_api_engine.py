"""The port's session on its own terms: what it refuses, how it records
its substitutions and how its adaptive engine handles small batches and
empty input, against the JAX package's where both answer.

Split from test_torch_api.py (its bench-query comparisons stay there);
the data (bench.py's shapes at 40,000 fact rows), the conf and the
comparison are that file's.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu_torch.api.session import (
    TpuSparkSession,
    TpuSparkSessionBuilder,
)
from spark_rapids_tpu_torch.plan import logical as port_logical
from spark_rapids_tpu_torch.plan.overrides import plan_query
from spark_rapids_tpu_torch.q5 import engine_query
from test_torch_api import (  # noqa: F401
    BENCH,
    CONF,
    PORT_CONF,
    ROWS,
    _assert_equal,
    data,
    one_torch_thread,
)


def test_session_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuSparkSessionBuilder().getOrCreate()
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuSparkSession(dict(CONF))
    # asked for explicitly, the CPU runs the plain versions
    spark = (TpuSparkSessionBuilder()
             .config("spark.rapids.torch.device", "cpu").getOrCreate())
    assert spark.device == torch.device("cpu")


def test_unported_plans_raise_not_implemented(data):
    """What the port still lacks raises naming its ROADMAP item: a range
    relation (A9) and the ICI mesh shuffle's global sort (A16). An
    in-memory relation
    (its upload above it), a left join, a union and a shuffled hash join
    (a build side over the broadcast threshold) plan."""
    spark = TpuSparkSession(PORT_CONF)
    fact = spark.read.parquet(os.path.join(data, "fact"))
    dim = spark.read.parquet(os.path.join(data, "dim"))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        plan_query(port_logical.Range(0, 10, 1, 1), spark.rapids_conf)
    rel = port_logical.LocalRelation(pa.table({"x": [1, 2]}))
    upload = plan_query(rel, spark.rapids_conf)[0]
    assert [type(upload).__name__, type(upload.children[0]).__name__] == \
        ["ArrowToDeviceExec", "LocalRelationExec"]
    ici = TpuSparkSession(dict(PORT_CONF, **{
        "spark.rapids.shuffle.mode": "ICI",
        "spark.sql.autoBroadcastJoinThreshold": 10}))
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        (ici.read.parquet(os.path.join(data, "fact"))
         .join(ici.read.parquet(os.path.join(data, "dim")), on="store")
         .orderBy("amount").collect_arrow())
    left = fact.join(dim, on="store", how="left")._physical()[0]
    assert left.join_type == "left"
    union = port_logical.Union([fact._plan, fact._plan])
    assert type(plan_query(union, spark.rapids_conf)[0]).__name__ == \
        "UnionExec"
    small = dict(PORT_CONF, **{"spark.sql.autoBroadcastJoinThreshold": 10})
    spark2 = TpuSparkSession(small)
    f2 = spark2.read.parquet(os.path.join(data, "fact"))
    d2 = spark2.read.parquet(os.path.join(data, "dim"))
    joined = f2.join(d2, on="store")
    assert type(joined._physical()[0]).__name__ == "TpuShuffledHashJoinExec"


@pytest.mark.parametrize("mode", [None, "CACHE_ONLY", "DEVICE"])
def test_shuffle_mode_substitution_is_recorded(data, mode):
    """The host-block shuffle modes (MULTITHREADED, the default, and
    CACHE_ONLY) are not ported: the exchange runs the DEVICE mode and the
    substitution is recorded as a fallback. (The fused engine, on by
    default, runs no exchange, so this drives the adaptive engine.)"""
    conf = {"spark.rapids.torch.device": "cpu",
            "spark.rapids.sql.fusedExec.enabled": False}
    if mode is not None:
        conf["spark.rapids.shuffle.mode"] = mode
    spark = TpuSparkSession(conf)
    fact = spark.read.parquet(os.path.join(data, "fact"))
    dim = spark.read.parquet(os.path.join(data, "dim"))
    rows = engine_query(fact, dim).collect()
    assert len(rows) == BENCH.REGIONS - 1
    ex = spark.last_execution
    assert ex["engine"] == "aqe"
    shuffle = [(e, r) for e, r in ex["fallbacks"] if e.startswith("shuffle")]
    if mode == "DEVICE":
        assert shuffle == []
    else:
        (engine, reason), = shuffle
        assert engine == f"shuffle {mode or 'MULTITHREADED'}"
        assert "ROADMAP A13" in reason and "DEVICE" in reason
    # a query without an exchange records no shuffle mode
    fact.filter(fact["qty"] > 5).collect_arrow()
    assert not [e for e, _ in spark.last_execution["fallbacks"]
                if e.startswith("shuffle")]


def test_ici_shuffle_raises_not_implemented(data):
    """The ICI shuffle is the mesh engine: bench's q5 runs on it, and a
    lowering the mesh engine has not ported (the global sort's) raises
    naming ROADMAP A16."""
    spark = TpuSparkSession(dict(PORT_CONF,
                                 **{"spark.rapids.shuffle.mode": "ICI"}))
    fact = spark.read.parquet(os.path.join(data, "fact"))
    dim = spark.read.parquet(os.path.join(data, "dim"))
    rows = engine_query(fact, dim).collect()
    assert len(rows) == BENCH.REGIONS - 1
    assert spark.last_execution["engine"] == "mesh"
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        fact.orderBy("amount").collect_arrow()


def test_count_and_collect_rows(data):
    spark = TpuSparkSession(PORT_CONF)
    fact = spark.read.parquet(os.path.join(data, "fact"))
    n = int(np.sum([pq.read_metadata(os.path.join(data, "fact", f)).num_rows
                    for f in os.listdir(os.path.join(data, "fact"))]))
    assert fact.count() == n == ROWS
    rows = engine_query(fact, spark.read.parquet(
        os.path.join(data, "dim"))).collect()
    assert len(rows) == BENCH.REGIONS - 1
    assert {r.region for r in rows} == {f"region_{i:02d}"
                                         for i in range(BENCH.REGIONS - 1)}


def test_small_batches_merge_early_and_finalize_in_pieces(data):
    """Row caps far below the data: the scan yields many batches a file,
    the partial merges its buffers early, the exchange's reduce side
    splits what it fetched, and the final aggregate re-partitions its
    2,000 groups by key hash and finalises each piece."""
    from spark_rapids_tpu.api import functions as JF
    from spark_rapids_tpu_torch.api import functions as F

    conf = {"spark.rapids.sql.reader.batchSizeRows": 1000,
            "spark.rapids.sql.batchSizeRows": 512}

    def q(spark, fns):
        return (spark.read.parquet(os.path.join(data, "fact"))
                .groupBy("store")
                .agg(fns.sum("qty").alias("qty"),
                     fns.avg("amount").alias("avg_amount"),
                     fns.count("*").alias("n")).collect_arrow())

    jspark = JaxSession(dict(CONF, **conf))
    try:
        want = q(jspark, JF)
    finally:
        jspark.stop()
    spark = TpuSparkSession(dict(PORT_CONF, **conf))
    got = q(spark, F)
    assert spark.last_execution["engine"] == "aqe"
    assert want.num_rows == BENCH.STORES
    _assert_equal(got, want, "store")


def test_global_aggregate_over_empty_input_matches_reference(tmp_path):
    """A global aggregate over a 0-row parquet file (fused engine off)
    yields the reference's default row: count 0, every other aggregate
    null (its exec/operators.py `_empty_global_result`)."""
    from spark_rapids_tpu.api import functions as JF
    from spark_rapids_tpu_torch.api import functions as PF

    pq.write_table(pa.table({"a": pa.array([], pa.int64()),
                             "b": pa.array([], pa.float64())}),
                   str(tmp_path / "empty.parquet"))
    out = []
    for F, spark in ((JF, JaxSession(dict(CONF))),
                     (PF, TpuSparkSession(dict(PORT_CONF)))):
        try:
            df = spark.read.parquet(str(tmp_path)).agg(
                F.count("a").alias("n"), F.sum("b").alias("s"),
                F.max("a").alias("m"), F.avg("b").alias("mean"))
            out.append(df.collect_arrow())
            assert spark.last_execution["engine"] != "fused"
        finally:
            spark.stop()
    want, got = out
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist() == [
        {"n": 0, "s": None, "m": None, "mean": None}]
