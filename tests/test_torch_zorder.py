"""Z-order clustering (ops/zorder.py: K9, K14's inverse, K36, K8) and the
Delta upkeep of ORDERS (q5.py) through the port against the JAX package,
on the CPU.

`column_ranks` (positions in each column's stable order, not dense
ranks: ties take consecutive ranks in row order), `interleave_bits` (the
top bits of n = 1-5, 63, 64 and 65 rank columns; a bit past position 63
gives nothing) and `zorder_sort` must equal the reference's exactly, over
keys with nulls, NaN, -0.0, +-inf, ties, strings and dead rows; Delta's
OPTIMIZE ZORDER BY must leave the reference's row order. Then the upkeep
pipeline (the write with deletion vectors, OPTIMIZE ZORDER BY, RF1 and
RF2 as MERGEs, the retention and the request DELETE, the UPDATE) runs
over a few thousand ORDERS through the reference's session once and the
port's on each engine: every step's log, the Z-ordered row order, the
final table and its priority summary (sums within 1e-12 relative: the
order of addition differs) must equal the reference's.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.columnar.arrow_bridge import (
    arrow_to_device as jax_upload,
)
from spark_rapids_tpu.columnar.arrow_bridge import (
    device_to_arrow as jax_download,
)
from spark_rapids_tpu.columnar.batch import ColumnBatch as JaxBatch
from spark_rapids_tpu.lakehouse.delta import DeltaTable as JaxDeltaTable
from spark_rapids_tpu.ops import zorder as JZ
from spark_rapids_tpu_torch import q5
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.columnar.arrow_bridge import (
    arrow_to_device,
    device_to_arrow,
)
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.lakehouse import delta as PD
from spark_rapids_tpu_torch.ops import zorder as PZ

ENGINES = ("fused", "aqe")
ROWS = 3000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    dbl = np.array([0.0, -0.0, 1.5, -2.0, np.nan, np.inf, -np.inf, 1.5])
    return pa.table({
        "d": pa.array(dbl[rng.integers(0, len(dbl), n)],
                      mask=rng.random(n) < 0.15),
        "k": pa.array(rng.integers(-3, 4, n), mask=rng.random(n) < 0.1),
        "s": pa.array([["", "a", "ab", "b", "zz"][i] for i in
                       rng.integers(0, 5, n)], mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(0, 1000, n).astype(np.int32)),
    })


def _both(table: pa.Table, dead: int):
    jb = jax_upload(table)
    jb = JaxBatch(jb.schema, jb.columns, table.num_rows - dead)
    pb = arrow_to_device(table, device="cpu")
    pb = ColumnBatch(pb.schema, pb.columns, table.num_rows - dead)
    assert pb.capacity == jb.capacity
    return jb, pb


@pytest.mark.parametrize("n,dead", [(1, 0), (700, 0), (700, 37),
                                    (2500, 2500)])
def test_column_ranks_and_zorder_sort_equal_reference(n, dead):
    table = _keys_table(n, n + dead)
    jb, pb = _both(table, dead)
    for i in range(table.num_columns):
        want = np.asarray(JZ.column_ranks(jb, i))
        got = PZ.column_ranks(pb, i)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    for ords in ([0, 1], [2, 0, 3], [3]):
        want = jax_download(JZ.zorder_sort(jb, ords))
        got = device_to_arrow(PZ.zorder_sort(pb, ords))
        assert got.num_rows == n - dead
        # NaN != NaN in Arrow's equality: compare the rows' reprs
        assert [repr(r) for r in got.to_pylist()] == \
            [repr(r) for r in want.to_pylist()]


@pytest.mark.parametrize("ncols", [1, 2, 3, 4, 5, 63, 64, 65])
@pytest.mark.parametrize("cap", [1024, 1 << 16])
def test_interleave_bits_equals_reference(ncols, cap):
    """K36's plain version: the top min(rank_bits, 63 // n) bits; n >= 64
    puts column 63 on the sign bit and drops the rest."""
    rng = np.random.default_rng(ncols * 7 + cap)
    rank_bits = (cap - 1).bit_length()
    ranks = [rng.integers(0, cap, 257) for _ in range(ncols)]
    want = np.asarray(JZ.interleave_bits(
        [jnp.asarray(r, jnp.int64) for r in ranks], rank_bits))
    got = PZ.interleave_bits([torch.from_numpy(r.astype(np.int32))
                              for r in ranks], rank_bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if ncols >= 64:
        assert (got.numpy() < 0).any()  # column 63 on the sign bit


def test_execute_zorder_by_equals_reference(tmp_path):
    """OPTIMIZE ZORDER BY over a one-file table (a table of several files
    is read in the order of their uuid names, which ties follow) leaves
    the reference's row order, and uploads to the session's device."""
    table = _keys_table(900, 3).append_column(
        "id", pa.array(np.arange(900), type=pa.int64()))
    orders = {}
    for name, spark, DT in (
            ("ref", JaxSession({}), JaxDeltaTable),
            ("port", TpuSparkSession({"spark.rapids.torch.device": "cpu"}),
             PD.DeltaTable)):
        p = str(tmp_path / name)
        spark.createDataFrame(table).write.format("delta").save(p)
        DT.forPath(spark, p).optimize().executeZOrderBy("k", "s", "d")
        orders[name] = _files_in_add_order(p, 1).column("id").to_pylist()
        spark.stop()
    assert orders["port"] == orders["ref"]
    assert sorted(orders["port"]) == list(range(900))


def _files_in_add_order(path: str, version: int) -> pa.Table:
    with open(PD._commit_file(path, version)) as f:
        adds = [json.loads(line)["add"] for line in f if '"add"' in line]
    return pa.concat_tables([pq.read_table(os.path.join(path, a["path"]))
                             for a in adds])


#: action fields that differ from run to run
_VOLATILE = {"path", "size", "modificationTime", "deletionTimestamp",
             "timestamp", "id", "createdTime"}


def _log(path: str) -> list:
    """Each commit's actions, their volatile fields dropped (stats
    parsed, a sidecar vector's uuid name too), as sorted canonical
    JSON."""
    def norm(obj):
        if isinstance(obj, dict):
            if obj.get("storageType") == "u":  # a sidecar's uuid name
                obj = {k: v for k, v in obj.items() if k != "pathOrInlineDv"}
            return {k: json.loads(v) if k == "stats" else norm(v)
                    for k, v in obj.items() if k not in _VOLATILE}
        return [norm(x) for x in obj] if isinstance(obj, list) else obj

    out, v = [], 0
    while os.path.exists(PD._commit_file(path, v)):
        with open(PD._commit_file(path, v)) as f:
            out.append(sorted(json.dumps(norm(json.loads(line)),
                                         sort_keys=True)
                              for line in f if line.strip()))
        v += 1
    return out


def _pipeline(spark, F, DT, root: str, path: str) -> dict:
    """q5.py's Delta upkeep of ORDERS, step by step: each step's log
    actions (uuids and timestamps aside), the Z-ordered rows in file
    order, the final table and its summary."""
    rf = q5.refresh_draws(ROWS, seed=1)
    q5.delta_write(spark.read.parquet(os.path.join(root, "orders_dated")),
                   path)
    q5.delta_zorder(spark, path, DT)
    zordered = _files_in_add_order(path, 1).column("o_orderkey").to_pylist()
    q5.delta_rf1(spark, path, rf["rf1"], DT)
    q5.delta_rf2(spark, path, rf["rf2"], DT)
    q5.delta_retention_delete(spark, path, F, DT)
    q5.delta_request_delete(spark, path, ROWS, F, DT)
    q5.delta_update(spark, path, F, DT)
    final = spark.read.delta(path).collect_arrow().sort_by("o_orderkey")
    summary = q5.delta_priority_summary_query(
        spark.read.delta(path), F).collect_arrow().sort_by(
            "o_orderpriority")
    return dict(log=_log(path), zordered=zordered, final=final,
                summary=summary)


@pytest.fixture(scope="module")
def orders_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("delta_orders"))
    q5.write_orders_dated(root, ROWS, files=2, seed=1)
    return root


@pytest.fixture(scope="module")
def reference_pipeline(orders_root):
    spark = JaxSession({"spark.sql.shuffle.partitions": 2})
    try:
        return _pipeline(spark, JF, JaxDeltaTable, orders_root,
                         os.path.join(orders_root, "ref"))
    finally:
        spark.stop()


@pytest.mark.parametrize("engine", ENGINES)
def test_delta_orders_pipeline_equals_reference(reference_pipeline,
                                                orders_root, engine):
    spark = TpuSparkSession({
        "spark.rapids.torch.device": "cpu",
        "spark.sql.shuffle.partitions": 2,
        "spark.rapids.sql.fusedExec.enabled": engine == "fused"})
    got = _pipeline(spark, None, None, orders_root,
                    os.path.join(orders_root, engine))
    spark.stop()
    want = reference_pipeline
    assert got["log"] == want["log"]
    assert got["zordered"] == want["zordered"]
    assert got["final"].equals(want["final"])
    # the steps did what they say: RF1's orders in, RF2's out, the
    # deleted dates and customers gone, the update applied
    keys = set(got["final"].column("o_orderkey").to_pylist())
    rf = q5.refresh_draws(ROWS, seed=1)
    assert not keys & set(rf["rf2"].column("o_orderkey").to_pylist())
    assert min(got["final"].column("o_custkey").to_pylist()) >= \
        q5.request_delete_custkey(ROWS)
    g, w = got["summary"], want["summary"]
    assert g.column("o_orderpriority").equals(w.column("o_orderpriority"))
    assert g.column("orders").equals(w.column("orders"))
    np.testing.assert_allclose(g.column("revenue").to_numpy(),
                               w.column("revenue").to_numpy(), rtol=1e-12)
