"""The port's fused single-chip engine against the JAX package's.

bench.py's two queries run through both sessions with bench.py's own
session conf, where spark.rapids.sql.fusedExec.enabled keeps its default
(true), over the device cache and over parquet, on the same small data
as tests/test_torch_api.py. Results must be equal ignoring row order:
groups and counts exact, double sums and averages within 1e-9 relative
(docs/compatibility.md, "Execution"). Both engines must report "fused"
and settle on the same lowerings: q5 keeps the lookup join and the
aggregate pushdown, dupjoin loses the lookup bet. The narrowed upload,
the pushdown rewrite and the capacity retry are held against the
reference's too, and the session's handling of settings the port does
not read.
"""

import importlib.util
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.exec import agg_pushdown as jax_pushdown
from spark_rapids_tpu.exec import fused as jax_fused
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.exec import agg_pushdown as port_pushdown
from spark_rapids_tpu_torch.exec import fused as port_fused
from spark_rapids_tpu_torch.q5 import (
    dupjoin_query,
    engine_query,
    write_q5_data,
)

REL_TOL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 40_000


def _bench():
    spec = importlib.util.spec_from_file_location(
        "srtpu_bench_fused", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH = _bench()
CONF = BENCH._session_conf()
PORT_CONF = dict(CONF, **{"spark.rapids.torch.device": "cpu"})
GROUP_KEY = {"q5": "region", "dupjoin": "promo", "stores": "store"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fused_bench_shapes"))
    write_q5_data(root, rows=ROWS, stores=BENCH.STORES,
                  regions=BENCH.REGIONS, files=BENCH.FILES, seed=0,
                  dup_per_store=BENCH.DUP_PER_STORE)
    return root


def _frames(spark, root, cache: bool):
    out = {}
    for name in ("fact", "dim", "dup"):
        df = spark.read.parquet(os.path.join(root, name))
        out[name] = df.cache(storage="device") if cache else df
    return out


def _query(which, frames, pkg):
    if which == "stores":
        if pkg == "jax":
            from spark_rapids_tpu.api import functions as F
        else:
            from spark_rapids_tpu_torch.api import functions as F
        return frames["fact"].groupBy("store").agg(
            F.sum("qty").alias("qty"), F.count("*").alias("n"))
    if pkg == "jax":
        return (BENCH.engine_query(frames["fact"], frames["dim"])
                if which == "q5"
                else BENCH.dupjoin_query(frames["fact"], frames["dup"]))
    return (engine_query(frames["fact"], frames["dim"]) if which == "q5"
            else dupjoin_query(frames["fact"], frames["dup"]))


def _run_reference(which, root, cache=True, extra=None, monkeypatch=None):
    """(result, last_execution, settled factors or None)."""
    settled = []
    if monkeypatch is not None:
        orig = jax_fused.FusedSingleChipExecutor._run_with_retry

        def spy(self, phys, as_parts):
            out = orig(self, phys, as_parts)
            if not as_parts:
                settled.append(out[1])
            return out

        monkeypatch.setattr(jax_fused.FusedSingleChipExecutor,
                            "_run_with_retry", spy)
    spark = JaxSession(dict(CONF, **(extra or {})))
    try:
        out = _query(which, _frames(spark, root, cache), "jax")\
            .collect_arrow()
        return out, dict(spark.last_execution), \
            settled[-1] if settled else None
    finally:
        spark.stop()


def _run_port(which, root, cache=True, extra=None):
    spark = TpuSparkSession(dict(PORT_CONF, **(extra or {})))
    out = _query(which, _frames(spark, root, cache), "port").collect_arrow()
    return out, spark.last_execution


def _assert_equal(got: pa.Table, want: pa.Table, key: str):
    assert got.schema.names == want.schema.names
    g = {r[key]: r for r in got.to_pylist()}
    w = {r[key]: r for r in want.to_pylist()}
    assert set(g) == set(w) and len(g) == want.num_rows
    for k, row in w.items():
        for col, v in row.items():
            if isinstance(v, float):
                assert g[k][col] == pytest.approx(v, rel=REL_TOL), (k, col)
            else:
                assert g[k][col] == v, (k, col)


def _settled(rec):
    f = rec["fused"]
    return (f["expansion"], f["group_cap"], f["use_lookup"],
            f["use_pushdown"])


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "parquet"])
@pytest.mark.parametrize("which", ["q5", "dupjoin"])
def test_fused_session_matches_reference(data, which, cache, monkeypatch):
    """(a) and (b): equal answers on the fused engine, and the same
    settled factors and lowerings."""
    want, jexec, jsettled = _run_reference(which, data, cache,
                                           monkeypatch=monkeypatch)
    got, rec = _run_port(which, data, cache)
    _assert_equal(got, want, GROUP_KEY[which])
    assert jexec["engine"] == rec["engine"] == "fused"
    assert rec["fallbacks"] == [] and not jexec["fallbacks"]
    assert _settled(rec) == tuple(jsettled)
    lookup = which == "q5"
    assert _settled(rec) == (4, 1 << 16, lookup, True)


def test_upload_narrowed_matches_reference(data):
    """(c) dtypes, vrange, capacity and values of the narrowed upload."""
    tables = [pq.read_table(os.path.join(data, "fact", "part-0.parquet")),
              pq.read_table(os.path.join(data, "dim", "dim-0.parquet"),
                            read_dictionary=["region"]),
              pa.table({"neg": pa.array([-70000, 3, None], pa.int64()),
                        "i32": pa.array([1, -129, 127], pa.int32()),
                        "s": pa.array(["a", None, "ccc"]),
                        "f": pa.array([0.5, None, -1.0])})]
    for table in tables:
        jb = jax_fused.upload_narrowed(table)
        pb = port_fused.upload_narrowed(table, device="cpu")
        assert pb.capacity == jb.capacity
        assert pb.row_count() == int(jb.num_rows)
        for pc, jc in zip(pb.columns, jb.columns):
            assert pc.vrange == jc.vrange
            assert (pc.encoding is None) == (jc.encoding is None)
            assert pc.data.numpy().dtype == np.asarray(jc.data).dtype
            np.testing.assert_array_equal(pc.data.numpy(),
                                          np.asarray(jc.data))
            np.testing.assert_array_equal(pc.validity.numpy(),
                                          np.asarray(jc.validity))


def test_bucket_capacity_matches_reference():
    rng = np.random.default_rng(80)
    ns = np.concatenate([np.arange(1, 70), rng.integers(1, 1 << 21, 3000),
                         [(1 << k) + d for k in range(10, 22)
                          for d in (-1, 0, 1)], [4_500_000]])
    for n in ns:
        assert port_fused.bucket_capacity(int(n)) == \
            jax_fused.bucket_capacity(int(n)), n
    assert port_fused.bucket_capacity(4_500_000) == 4_718_592


def _chain_below(phys):
    """The per-partition chain under the final aggregate, in execution
    order: [filter, join, filter, project, partial]."""
    node = phys.children[0].children[0]  # final -> exchange -> partial
    chain = []
    while type(node).__name__ not in ("TpuCachedRelationExec",
                                      "TpuFileScanExec"):
        chain.append(node)
        node = node.children[0]
    return list(reversed(chain))


def _describe(nodes):
    out = []
    for n in nodes:
        name = type(n).__name__
        if name == "MergeTail":
            out.append((name, [f.name for f in
                               n.agg.schema.fields]))
            continue
        item = [name, [f.name for f in n.schema.fields]]
        if name == "TpuHashAggregateExec":
            item += [n.mode, [g.name for g in n.grouping],
                     getattr(n, "_pushdown_synth", False)]
        if name == "TpuBroadcastHashJoinExec":
            item += [[k.ordinal for k in n.left_keys],
                     [k.ordinal for k in n.right_keys]]
        out.append(tuple(str(x) for x in item))
    return out


def test_rewrite_chain_matches_reference(data):
    """(d) q5's chain pushes the aggregate below the lookup join into the
    same node kinds and key layout."""
    jspark = JaxSession(CONF)
    try:
        jf = _frames(jspark, data, cache=True)
        jphys = BENCH.engine_query(jf["fact"], jf["dim"])._physical()[0]
        want = _describe(jax_pushdown.rewrite_chain(_chain_below(jphys)))
    finally:
        jspark.stop()
    spark = TpuSparkSession(PORT_CONF)
    pf = _frames(spark, data, cache=True)
    phys = engine_query(pf["fact"], pf["dim"])._physical()[0]
    got = _describe(port_pushdown.rewrite_chain(_chain_below(phys)))
    assert got == want
    assert [d[0] for d in got] == [
        "TpuFilterExec", "TpuHashAggregateExec", "TpuBroadcastHashJoinExec",
        "TpuFilterExec", "TpuProjectExec", "MergeTail"]


@pytest.mark.parametrize("which,settled", [
    ("stores", (8, 4096, True, True)),    # capacity overflow: retry
    ("q5", (4, 1024, True, False)),       # pushdown bet lost
])
def test_small_group_capacity_retries(data, which, settled, monkeypatch):
    """(e) a group capacity below the partials' group count: the
    per-store partial overflows and the run retries with the capacity
    quadrupled and the expansion doubled; q5's pushdown pre-aggregate by
    store does not fit and q5 re-runs without the pushdown. Both equal
    the reference under the same setting."""
    extra = {"spark.rapids.sql.fusedExec.groupCapacity": 1024}
    want, jexec, jsettled = _run_reference(which, data, extra=extra,
                                           monkeypatch=monkeypatch)
    got, rec = _run_port(which, data, extra=extra)
    _assert_equal(got, want, GROUP_KEY[which])
    assert rec["engine"] == jexec["engine"] == "fused"
    assert _settled(rec) == tuple(jsettled) == settled


def test_unlowerable_plan_falls_back(data):
    """(f) a bare scan has no fused lowering: the FusedCompileError is
    recorded as a fallback and the per-operator engine answers."""
    spark = TpuSparkSession(PORT_CONF)
    got = spark.read.parquet(os.path.join(data, "dim")).collect_arrow()
    rec = spark.last_execution
    assert rec["engine"] == "eager"
    (engine, reason), = rec["fallbacks"]
    assert engine == "fused" and "host operator" in reason
    want = pq.read_table(os.path.join(data, "dim"))
    assert got.num_rows == want.num_rows == BENCH.STORES
    assert got.column("store").to_pylist() == \
        want.column("store").to_pylist()


def test_cache_parts_are_narrowed(data):
    """The relation cache materialises through the fused engine: the
    fact parts hold int16 columns with the reference's vrange, in
    1/16-octave capacity buckets."""
    spark = TpuSparkSession(PORT_CONF)
    fact = _frames(spark, data, cache=True)["fact"]
    entry = spark.cache_manager.lookup(fact._plan)
    part = entry.device_part(0)
    assert part.capacity == port_fused.bucket_capacity(ROWS // BENCH.FILES)
    assert [str(c.data.dtype) for c in part.columns] == [
        "torch.int16", "torch.float64", "torch.int16", "torch.int16"]
    assert [c.vrange for c in part.columns] == [
        (0, 2047), None, (0, 127), (0, 511)]


def test_unread_setting_warns():
    """A setting nothing in the port reads is accepted with a warning
    (the UDF compiler is not ported; the regexp settings are read since
    the port's RLIKE)."""
    key = "spark.rapids.sql.udfCompiler.enabled"
    with pytest.warns(UserWarning, match=key):
        spark = TpuSparkSession({"spark.rapids.torch.device": "cpu",
                                 key: False})
    assert spark.ignored_settings == [key]
    with pytest.warns(UserWarning, match="spark.no.such.key"):
        TpuSparkSession({"spark.rapids.torch.device": "cpu",
                         "spark.no.such.key": 1})


def test_ansi_mode_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        TpuSparkSession({"spark.rapids.torch.device": "cpu",
                         "spark.sql.ansi.enabled": True})


@pytest.mark.parametrize("extra,settled", [
    ({"spark.rapids.sql.fusedExec.lookupJoin.enabled": False},
     (4, 1 << 16, True, True)),
    ({"spark.rapids.sql.fusedExec.aggPushdownThroughJoin": False},
     (4, 1 << 16, True, True)),
    ({"spark.rapids.sql.fusedExec.singleSyncFetchMaxBytes": 0},
     (4, 1 << 16, True, True)),
    ({"spark.rapids.sql.fusedExec.shapeBucketing": False},
     (4, 1 << 16, True, True)),
], ids=["no-lookup", "no-pushdown", "two-step-fetch", "no-buckets"])
def test_fused_settings_match_reference(data, extra, settled, monkeypatch):
    """The fused engine's own settings: joins expanded instead of looked
    up, no pushdown, the fetch of a result past the single-sync size, and
    uploads aligned instead of bucketed. Each equals the reference under
    the same setting and settles on the same factors."""
    want, jexec, jsettled = _run_reference("q5", data, extra=extra,
                                           monkeypatch=monkeypatch)
    got, rec = _run_port("q5", data, extra=extra)
    _assert_equal(got, want, "region")
    assert rec["engine"] == jexec["engine"] == "fused"
    assert _settled(rec) == tuple(jsettled) == settled
