"""The port's session, DataFrame API, planner and adaptive engine against
the JAX package's, on bench.py's two queries.

The same small parquet data (bench.py's shapes: 8 fact files, a 2,000-row
dimension with a dictionary-encoded `region`, a 4,000-row duplicate-key
dimension with a plain `promo`) goes through the reference's session, with
bench.py's session conf and the fused engine off, and through the port's
session with the same conf on the CPU. Results must be equal ignoring
row order: groups and counts exact, double sums and averages within 1e-9
relative (docs/compatibility.md, "Execution"). Both must run on the `aqe`
engine with the same physical tree and adaptive decisions. The session's
own behaviours (no GPU, unported plans, shuffle modes, small batches, an
empty input) are in test_torch_api_engine.py, which shares this file's
data and conf.
"""

import importlib.util
import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.plan import aqe as jax_aqe
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.exec import joins as port_joins
from spark_rapids_tpu_torch.exec.operators import TpuHashAggregateExec
from spark_rapids_tpu_torch.ops import bloom as port_bloom
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
        "srtpu_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH = _bench()
CONF = dict(BENCH._session_conf(),
            **{"spark.rapids.sql.fusedExec.enabled": False})
PORT_CONF = dict(CONF, **{"spark.rapids.torch.device": "cpu"})
GROUP_KEY = {"q5": "region", "dupjoin": "promo"}


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
    root = str(tmp_path_factory.mktemp("bench_shapes"))
    write_q5_data(root, rows=ROWS, stores=BENCH.STORES,
                  regions=BENCH.REGIONS, files=BENCH.FILES, seed=0,
                  dup_per_store=BENCH.DUP_PER_STORE)
    # a dimension holding only a quarter of the stores: most probe keys
    # are absent from it
    dim = pq.read_table(os.path.join(root, "dim", "dim-0.parquet"))
    os.makedirs(os.path.join(root, "dim_part"))
    pq.write_table(dim.slice(0, BENCH.STORES // 4),
                   os.path.join(root, "dim_part", "part-0.parquet"),
                   use_dictionary=["region"])
    return root


def _frames(spark, root, cache: bool):
    out = {}
    for name in ("fact", "dim", "dup", "dim_part"):
        df = spark.read.parquet(os.path.join(root, name))
        out[name] = df.cache(storage="device") if cache else df
    return out


def _query(which, frames, pkg):
    dim = frames["dim"]
    if pkg == "jax":
        return (BENCH.engine_query(frames["fact"], dim) if which == "q5"
                else BENCH.dupjoin_query(frames["fact"], frames["dup"]))
    return (engine_query(frames["fact"], dim) if which == "q5"
            else dupjoin_query(frames["fact"], frames["dup"]))


def _run_reference(which, root, cache=True, monkeypatch=None):
    """(result, last_execution, adaptive decisions, physical tree)."""
    decisions = []
    if monkeypatch is not None:
        orig = jax_aqe.AdaptiveQueryExecutor.execute

        def spy(self, phys):
            out = orig(self, phys)
            decisions.extend(self.decisions)
            return out

        monkeypatch.setattr(jax_aqe.AdaptiveQueryExecutor, "execute", spy)
    spark = JaxSession(CONF)
    try:
        df = _query(which, _frames(spark, root, cache), "jax")
        tree = _tree(df._physical()[0])
        out = df.collect_arrow()
        return out, dict(spark.last_execution), decisions, tree
    finally:
        spark.stop()


def _run_port(which, root, cache=True):
    spark = TpuSparkSession(PORT_CONF)
    df = _query(which, _frames(spark, root, cache), "port")
    tree = _tree(df._physical()[0])
    out = df.collect_arrow()
    return out, spark.last_execution, tree


def _tree(node):
    """Node types (with an aggregate's mode) in pre-order."""
    name = type(node).__name__
    if name == "TpuHashAggregateExec":
        name += f"({node.mode})"
    if name == "TpuShuffleExchangeExec":
        name += f"({node.num_partitions})"
    return [name] + [x for c in node.children for x in _tree(c)]


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


@pytest.mark.parametrize("which", ["q5", "dupjoin"])
def test_session_matches_reference(data, which, monkeypatch):
    want, jexec, jdecisions, jtree = _run_reference(which, data,
                                                    monkeypatch=monkeypatch)
    got, exec_rec, tree = _run_port(which, data)
    _assert_equal(got, want, GROUP_KEY[which])
    assert jexec["engine"] == exec_rec["engine"] == "aqe"
    assert exec_rec["aqe"] == jdecisions
    assert jdecisions == ["coalesced 8 shuffle partitions -> 1"]
    assert tree == jtree


@pytest.mark.parametrize("which", ["q5", "dupjoin"])
def test_physical_tree_is_the_references(data, which):
    """partial -> hash exchange -> final around the broadcast join, node
    type for node type."""
    *_, jtree = _run_reference(which, data)
    *_, tree = _run_port(which, data)
    join_side = (["TpuProjectExec", "TpuFilterExec",
                  "TpuBroadcastHashJoinExec"] if which == "q5"
                 else ["TpuProjectExec", "TpuBroadcastHashJoinExec"])
    assert tree == jtree == [
        "TpuHashAggregateExec(final)", "TpuShuffleExchangeExec(8)",
        "TpuHashAggregateExec(partial)", *join_side, "TpuFilterExec",
        "TpuCachedRelationExec", "TpuCachedRelationExec"]


@pytest.mark.parametrize("which", ["q5", "dupjoin"])
def test_session_over_parquet_matches_reference(data, which):
    """Without the device cache the port scans the files (PERFILE); the
    answer is the same."""
    want, *_ = _run_reference(which, data, cache=False)
    got, exec_rec, tree = _run_port(which, data, cache=False)
    _assert_equal(got, want, GROUP_KEY[which])
    assert exec_rec["engine"] == "aqe"
    assert tree.count("TpuFileScanExec") == 2


@pytest.mark.parametrize("which", ["q5", "dupjoin"])
def test_every_partial_is_binned(data, which, monkeypatch):
    binned = []
    orig = TpuHashAggregateExec._partial_binned

    def spy(self, *args):
        binned.append(self.mode)
        return orig(self, *args)

    monkeypatch.setattr(TpuHashAggregateExec, "_partial_binned", spy)
    partials = []
    orig_partial = TpuHashAggregateExec._partial

    def spy_partial(self, batch):
        partials.append(self.mode)
        return orig_partial(self, batch)

    monkeypatch.setattr(TpuHashAggregateExec, "_partial", spy_partial)
    _run_port(which, data)
    # one partial per fact part, and every one took the binned path
    assert partials == binned == ["partial"] * BENCH.FILES


def _bloom_spy(monkeypatch):
    seen = []
    orig = port_joins._DeviceJoinBase._bloom_prefilter

    def spy(self, left, right):
        out = orig(self, left, right)
        seen.append((left.row_count(), out.row_count()))
        return out

    monkeypatch.setattr(port_joins._DeviceJoinBase, "_bloom_prefilter", spy)
    calls = []
    orig_mc = port_bloom.might_contain_count

    def spy_mc(*args, **kw):
        calls.append(1)
        return orig_mc(*args, **kw)

    monkeypatch.setattr(port_bloom, "might_contain_count", spy_mc)
    return seen, calls


def test_bloom_prefilter_runs_and_keeps_every_q5_row(data, monkeypatch):
    seen, calls = _bloom_spy(monkeypatch)
    _run_port("q5", data)
    # every fact key is in the dimension: the pass runs on each part and
    # drops nothing
    assert len(calls) == BENCH.FILES
    assert len(seen) == BENCH.FILES and all(a == b for a, b in seen)


def test_bloom_prefilter_drops_absent_keys(data, monkeypatch):
    seen, calls = _bloom_spy(monkeypatch)
    spark = TpuSparkSession(PORT_CONF)
    frames = _frames(spark, data, cache=True)
    got = engine_query(frames["fact"], frames["dim_part"]).collect_arrow()
    assert len(calls) == BENCH.FILES
    # a quarter of the stores is in the build side: most rows drop, and
    # the prefiltered probe re-buckets smaller
    assert all(b < a / 2 for a, b in seen)
    jspark = JaxSession(CONF)
    try:
        jf = _frames(jspark, data, cache=True)
        want = BENCH.engine_query(jf["fact"], jf["dim_part"]).collect_arrow()
    finally:
        jspark.stop()
    _assert_equal(got, want, "region")
