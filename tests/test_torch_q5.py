"""The q5 slice of the PyTorch port against the JAX package, end to end.

The same small parquet data (a few thousand fact rows, 50 stores, 12
regions, a dictionary-encoded `region`) goes through the JAX session with
the fused engine off and through the port's physical plan with
device="cpu". Group order may differ; the region set must be equal, counts
exact, sums and averages within 1e-9 relative (docs/compatibility.md,
"Execution").
"""

import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import arrow_to_device as jax_arrow_to_device
from spark_rapids_tpu.columnar.batch import ColumnBatch as JaxBatch
from spark_rapids_tpu.expr import core as jax_core
from spark_rapids_tpu.expr import predicates as jax_predicates
from spark_rapids_tpu.ops import filterops as jax_filterops
from spark_rapids_tpu.ops import segmented as jax_segmented
from spark_rapids_tpu.testing.asserts import with_tpu_session
from spark_rapids_tpu_torch.columnar.arrow_bridge import (
    arrow_to_device,
    device_to_arrow,
    schema_from_arrow,
)
from spark_rapids_tpu_torch.columnar.batch import batch_from_host_leaves
from spark_rapids_tpu_torch.exec.operators import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.relation_cache import DeviceCacheEntry
from spark_rapids_tpu_torch.expr import core as port_core
from spark_rapids_tpu_torch.expr import predicates as port_predicates
from spark_rapids_tpu_torch.ops import filterops as port_filterops
from spark_rapids_tpu_torch.ops import segmented as port_segmented
from spark_rapids_tpu_torch.q5 import q5_plan, write_q5_data
from spark_rapids_tpu_torch.sqltypes.datatypes import double

from test_torch_kernels import leaves_of, same, same_batch

REL_TOL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def q5_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("q5"))
    fact_paths, dim_path = write_q5_data(root, rows=6000, stores=50,
                                         regions=12, files=3, seed=0)
    return fact_paths, dim_path


def _jax_q5(fact_dir: str, dim_dir: str) -> pa.Table:
    from spark_rapids_tpu.api import functions as F

    def q(spark):
        base = spark.read.parquet(fact_dir)
        dim = spark.read.parquet(dim_dir)
        return (base
                .filter(F.col("amount") > 10.0)
                .join(dim, on="store", how="inner")
                .filter(F.col("region") != "region_11")
                .select("region",
                        (F.col("amount") * F.col("qty")).alias("revenue"),
                        "amount")
                .groupBy("region")
                .agg(F.sum("revenue").alias("rev"),
                     F.avg("amount").alias("avg_amount"),
                     F.count("*").alias("sales"))
                .collect_arrow())

    return with_tpu_session(q, {"spark.rapids.sql.fusedExec.enabled": False})


def _by_region(table: pa.Table):
    return {r["region"]: r for r in table.to_pylist()}


def test_q5_matches_jax_package(q5_data, monkeypatch):
    fact_paths, dim_path = q5_data
    binned = []
    orig = TpuHashAggregateExec._partial_binned

    def spy(self, *args):
        binned.append(1)
        return orig(self, *args)

    # the region codes' vrange must route every partial to the binned path
    monkeypatch.setattr(TpuHashAggregateExec, "_partial_binned", spy)
    fact = DeviceCacheEntry(fact_paths, device="cpu")
    dim = DeviceCacheEntry([dim_path], device="cpu")
    got = q5_plan(fact, dim).collect()
    assert len(binned) == len(fact_paths)
    assert got.schema.names == ["region", "rev", "avg_amount", "sales"]
    want = _jax_q5(os.path.dirname(fact_paths[0]),
                   os.path.dirname(dim_path))
    g, w = _by_region(got), _by_region(want)
    assert set(g) == set(w) and len(g) == 11
    for region, row in w.items():
        assert g[region]["sales"] == row["sales"], region
        for col in ("rev", "avg_amount"):
            assert g[region][col] == pytest.approx(row[col], rel=REL_TOL)


def test_q5_merges_partials_early(q5_data):
    """A small target forces `_merge_buffers` between parts; the answer
    must not change."""
    fact_paths, dim_path = q5_data
    fact = DeviceCacheEntry(fact_paths, device="cpu")
    dim = DeviceCacheEntry([dim_path], device="cpu")
    plain = q5_plan(fact, dim).collect()
    plan = q5_plan(fact, dim)
    plan.target_rows = 512
    early = plan.collect()
    a, b = _by_region(plain), _by_region(early)
    assert set(a) == set(b)
    for region in a:
        assert a[region]["sales"] == b[region]["sales"]
        for col in ("rev", "avg_amount"):
            assert a[region][col] == pytest.approx(b[region][col],
                                                   rel=REL_TOL)


def test_binned_partial_takes_one_k4_call(q5_data, monkeypatch):
    """q5's Sum/Average/count(*) partial takes every reduction from one K4
    call, and equals the per-function update loop it replaces."""
    fact_paths, dim_path = q5_data
    fact = DeviceCacheEntry(fact_paths, device="cpu")
    dim = DeviceCacheEntry([dim_path], device="cpu")
    calls = []
    orig = port_segmented.seg_sum_count_multi

    def spy(*args, **kw):
        calls.append(port_segmented._SORTED_GIDS.get())
        return orig(*args, **kw)

    monkeypatch.setattr(port_segmented, "seg_sum_count_multi", spy)
    one = q5_plan(fact, dim).collect()
    # unsorted ids are the binned partials: one call for each part
    assert calls.count(False) == len(fact_paths)
    monkeypatch.setattr(TpuHashAggregateExec, "_binned_all_sums",
                        lambda self, *args: None)
    loop = q5_plan(fact, dim).collect()
    a, b = _by_region(one), _by_region(loop)
    assert set(a) == set(b) and len(a) == 11
    for region in a:
        assert a[region]["sales"] == b[region]["sales"]
        for col in ("rev", "avg_amount"):
            assert a[region][col] == pytest.approx(b[region][col],
                                                   rel=REL_TOL)


def test_sorted_aggregate_matches_jax_package(q5_data):
    """Group keys without a vrange (the fact table's int64 `store`, read
    by the file scan; the device cache narrows it and stamps a vrange)
    take the sorted partial: sort, segment, reduce, then the sorted
    merge."""
    from spark_rapids_tpu.api import functions as F
    from spark_rapids_tpu_torch.columnar.arrow_bridge import (
        schema_from_arrow,
    )
    from spark_rapids_tpu_torch.config import rapids_conf as port_rc
    from spark_rapids_tpu_torch.exec.operators import TpuFileScanExec
    from spark_rapids_tpu_torch.expr.aggregates import Average, Count, Sum
    from spark_rapids_tpu_torch.io.readers import infer_parquet_schema

    fact_paths, _ = q5_data
    rel = TpuFileScanExec(
        "parquet", fact_paths,
        schema_from_arrow(infer_parquet_schema(fact_paths)),
        port_rc.RapidsConf({"spark.rapids.torch.device": "cpu"}))
    fs = rel.schema

    def ref(name):
        i = fs.field_index(name)
        return port_core.BoundReference(i, fs.fields[i].dataType)

    agg = TpuHashAggregateExec(
        "complete", [port_core.Alias(ref("store"), "store")],
        [port_core.Alias(Sum(ref("qty")), "qty"),
         port_core.Alias(Average(ref("amount")), "avg_amount"),
         port_core.Alias(Count(), "n")], rel)
    binned = []
    agg._partial_binned = lambda *a: binned.append(1)
    got = {r["store"]: r for r in agg.collect().to_pylist()}
    assert not binned

    def q(spark):
        return (spark.read.parquet(os.path.dirname(fact_paths[0]))
                .groupBy("store")
                .agg(F.sum("qty").alias("qty"),
                     F.avg("amount").alias("avg_amount"),
                     F.count("*").alias("n")).collect_arrow())

    want = with_tpu_session(q, {"spark.rapids.sql.fusedExec.enabled": False})
    want = {r["store"]: r for r in want.to_pylist()}
    assert set(got) == set(want) and len(got) == 50
    for store, row in want.items():
        assert got[store]["qty"] == row["qty"]
        assert got[store]["n"] == row["n"]
        assert got[store]["avg_amount"] == pytest.approx(row["avg_amount"],
                                                         rel=REL_TOL)


def _mixed_table(n: int = 2500) -> pa.Table:
    rng = np.random.default_rng(7)
    words = np.array(["", "a", "héllo", "zzz", "x" * 20])
    return pa.table({
        "i": pa.array(rng.integers(-5, 5, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "f": pa.array(rng.choice([1.5, -0.0, float("nan"), 3.25], n),
                      pa.float64(), mask=rng.random(n) < 0.1),
        "s": pa.array(rng.choice(words, n).tolist(),
                      mask=rng.random(n) < 0.1),
        "d": pa.array(rng.choice(words, n).tolist()).dictionary_encode(),
    })


def test_arrow_round_trip():
    table = _mixed_table()
    batch = arrow_to_device(table, device="cpu")
    assert batch.capacity == 4096
    same_batch(batch, jax_arrow_to_device(table))
    back = device_to_arrow(batch)
    assert back.column_names == table.column_names
    for name in table.column_names:
        want = table.column(name)
        if pa.types.is_dictionary(want.type):
            want = want.cast(pa.string())  # encoded columns decode
        got = back.column(name)
        assert got.type == want.type, name
        assert got.is_null().equals(want.is_null()), name
        np.testing.assert_array_equal(   # NaN equal to NaN
            got.to_numpy(zero_copy_only=False),
            want.to_numpy(zero_copy_only=False), err_msg=name)


def test_batch_from_host_leaves_gives_equal_outputs():
    """One JAX batch, turned into numpy leaves, is the identical port
    batch: the filter and the grouping over it agree array for array."""
    table = _mixed_table()
    jb = jax_arrow_to_device(table)
    jb = JaxBatch(jb.schema, jb.columns, table.num_rows - 9)
    pb = batch_from_host_leaves(schema_from_arrow(table.schema),
                                leaves_of(jb), table.num_rows - 9,
                                device="cpu")
    same_batch(pb, jb)
    pred = port_predicates.GreaterThan(port_core.BoundReference(1, double),
                                       port_core.Literal(1.0))
    jpred = jax_predicates.GreaterThan(jax_core.BoundReference(1, double),
                                       jax_core.Literal(1.0))
    p = pred.eval(port_core.EvalContext(pb))
    jp = jpred.eval(jax_core.EvalContext(jb))
    same(p.data & p.validity, np.asarray(jp.data & jp.validity), "pred")
    out = port_filterops.compact(pb, p.data & p.validity)
    jout = jax_filterops.compact(jb, jp.data & jp.validity)
    same(out.num_rows, jout.num_rows, "rows")
    same_batch(out, jout)
    g = port_segmented.group_by(out, [3])
    jg = jax_segmented.group_by(jout, [3])
    same(g.gid, jg.gid, "gid")
    s, c = port_segmented.seg_sum_count(
        g.sorted_batch.columns[0].data, g.live, g.gid, out.capacity)
    js, jc = jax_segmented.seg_sum_count(
        jg.sorted_batch.columns[0].data, jg.live, jg.gid, jout.capacity)
    same(s, js, "sums")
    same(c, jc, "counts")


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spark_rapids_tpu' or m.startswith('spark_rapids_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_entry_points_refuse_cpu_without_gpu(monkeypatch, q5_data):
    """Without a GPU and without an explicit device, the entry points
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = pa.table({"x": pa.array([1, 2, 3], pa.int64())})
    with pytest.raises(RuntimeError, match="CUDA"):
        arrow_to_device(table)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceCacheEntry(q5_data[0])
    # asked for explicitly, the CPU runs the plain versions
    assert arrow_to_device(table, device="cpu").row_count() == 3


def _expr_pair(build):
    """The same expression tree in both packages: build(m) gets a
    namespace with the package's expression classes and SQL types."""
    from spark_rapids_tpu.expr import arith as jax_arith
    from spark_rapids_tpu.sqltypes import datatypes as jax_types
    from spark_rapids_tpu_torch.expr import arith as port_arith
    from spark_rapids_tpu_torch.sqltypes import datatypes as port_types

    class NS:
        pass

    out = []
    for mods in ((port_core, port_predicates, port_arith, port_types),
                 (jax_core, jax_predicates, jax_arith, jax_types)):
        ns = NS()
        for mod in mods:
            for name in dir(mod):
                setattr(ns, name, getattr(mod, name))
        out.append(build(ns))
    return out


_EXPRS = {
    "int_gt_lit": lambda m: m.GreaterThan(
        m.BoundReference(0, m.long), m.Literal(0)),
    "double_lt_double": lambda m: m.LessThan(
        m.BoundReference(1, m.double), m.Literal(1.5)),
    "double_eq_nan": lambda m: m.EqualTo(
        m.BoundReference(1, m.double), m.Literal(float("nan"))),
    "int_vs_double": lambda m: m.LessThan(
        m.BoundReference(0, m.long), m.BoundReference(1, m.double)),
    "string_eq_wider_lit": lambda m: m.EqualTo(
        m.BoundReference(2, m.string), m.Literal("héllo-and-more-bytes")),
    "string_gt": lambda m: m.GreaterThan(
        m.BoundReference(2, m.string), m.Literal("b")),
    "encoded_ne": lambda m: m.Not(m.EqualTo(
        m.BoundReference(3, m.string), m.Literal("zzz"))),
    "encoded_eq_absent": lambda m: m.EqualTo(
        m.Literal("not-there"), m.BoundReference(3, m.string)),
    "encoded_eq_null": lambda m: m.EqualTo(
        m.BoundReference(3, m.string), m.Literal(None, m.string)),
    "encoded_lt_decodes": lambda m: m.LessThan(
        m.BoundReference(3, m.string), m.Literal("b")),
    "long_times_double": lambda m: m.Multiply(
        m.BoundReference(1, m.double), m.BoundReference(0, m.long)),
    "long_times_long_wraps": lambda m: m.Multiply(
        m.BoundReference(0, m.long), m.Literal(1 << 62, m.long)),
}


@pytest.mark.parametrize("name", sorted(_EXPRS))
def test_expressions_match_jax_package(name):
    table = _mixed_table()
    jb = jax_arrow_to_device(table)
    pb = arrow_to_device(table, device="cpu")
    port_expr, jax_expr = _expr_pair(_EXPRS[name])
    got = port_expr.eval(port_core.EvalContext(pb))
    want = jax_expr.eval(jax_core.EvalContext(jb))
    assert repr(got.dtype) == repr(want.dtype)
    same(got.validity, want.validity, "validity")
    valid = np.asarray(want.validity)
    np.testing.assert_array_equal(got.data.numpy()[valid],
                                  np.asarray(want.data)[valid])
