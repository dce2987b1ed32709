"""The port's mesh engine against the JAX package's, on the CPU.

The port's session with spark.rapids.tpu.mesh = 8 runs its plans over
eight shards that share the CPU (`parallel/plan_compiler.py`); the
reference's runs them as one shard_map'd program over the eight virtual
host devices of tests/conftest.py. The same seeded tables go through
both: the cases of tests/test_mesh_query.py (grouped, global and
filter-project aggregates, q5's join and aggregate, a broadcast join, the
join types, the skew overflow retry, the nested-loop fallback), those of
tests/test_multichip.py (the encoded scan's dictionary reconciliation,
the iciShuffle.enabled=false fallback), bench's q5, string_q5 and dupjoin
over q5.py's parquet tables, the ICI shuffle mode, and the collectives
themselves: `all_to_all_batch` over four shards against the reference's
under shard_map (each shard's rows and overflow flag),
`make_distributed_agg`, and K37's plain version at its edges against the
reference's one-hot cumsum (in numpy). Aggregates compare within 1e-9 relative,
counts and keys exactly. A sort or a window over the mesh raises
NotImplementedError naming ROADMAP A16. Each reference answer is computed
once a query.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.parallel import collective as port_coll
from spark_rapids_tpu_torch.parallel import mesh_exec as port_mesh
from spark_rapids_tpu_torch.q5 import string_q5_query, write_q5_data

REL_TOL = 1e-9
MESH = {"spark.rapids.tpu.mesh": 8, "spark.sql.shuffle.partitions": 4}
SHUFFLED = {"spark.sql.autoBroadcastJoinThreshold": -1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: beside the other test workers' pools its
    intra-op threads oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _session(pkg: str, conf: dict):
    if pkg == "jax":
        return JaxSession(dict(conf)), JF
    return TpuSparkSession(dict(conf, **{
        "spark.rapids.torch.device": "cpu"})), PF


def _run(pkg: str, query, conf: dict):
    """(answer, last_execution) of query(session, F) in one package's
    session."""
    spark, F = _session(pkg, conf)
    try:
        out = query(spark, F).collect_arrow()
        return out, dict(spark.last_execution)
    finally:
        spark.stop()


_REFERENCE = {}


def _reference(name: str, query, conf: dict):
    if name not in _REFERENCE:
        _REFERENCE[name] = _run("jax", query, conf)
    return _REFERENCE[name]


def _rows(t: pa.Table):
    return sorted((tuple(r.values()) for r in t.to_pylist()),
                  key=lambda r: tuple((v is None, v if v is not None
                                       else 0) for v in r))


def _assert_same(got: pa.Table, want: pa.Table) -> None:
    assert got.schema.names == want.schema.names
    assert got.num_rows == want.num_rows
    for g, w in zip(_rows(got), _rows(want)):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=REL_TOL), (g, w)
            else:
                assert a == b, (g, w)


def _mesh_vs_reference(name: str, query, conf=None):
    conf = dict(MESH, **(conf or {}))
    want, wex = _reference(name, query, conf)
    got, ex = _run("port", query, conf)
    assert wex["engine"] == "mesh", wex
    assert ex["engine"] == "mesh", ex
    assert ex["mesh"]["shards"] == 8
    _assert_same(got, want)
    return got, ex


def _tables(s, n=5000, seed=11):
    rng = np.random.default_rng(seed)
    fact = s.createDataFrame(pa.table({
        "store": pa.array(rng.integers(0, 40, n), type=pa.int64()),
        "amount": pa.array(rng.random(n) * 100, type=pa.float64()),
        "qty": pa.array(rng.integers(1, 50, n), type=pa.int64()),
    }))
    dim = s.createDataFrame(pa.table({
        "store": pa.array(np.arange(0, 60), type=pa.int64()),
        "region": pa.array(np.arange(0, 60) % 7, type=pa.int64()),
    }))
    return fact, dim


# ------------------------------------------------------------ aggregates

def test_mesh_groupby_agg():
    def q(s, F):
        fact, _ = _tables(s)
        return fact.groupBy("store").agg(
            F.sum("amount").alias("rev"), F.count("*").alias("n"),
            F.avg("qty").alias("aq"), F.min("amount").alias("mn"),
            F.max("amount").alias("mx"))

    got, ex = _mesh_vs_reference("groupby", q)
    assert got.num_rows == 40 and ex["mesh"]["slots"]


def test_mesh_global_agg():
    """One row, from shard 0 only: the other shards' merges of no rows
    are dropped."""
    def q(s, F):
        fact, _ = _tables(s)
        return fact.agg(F.sum("qty").alias("t"), F.count("*").alias("n"))

    got, _ = _mesh_vs_reference("global", q)
    assert got.num_rows == 1


def test_mesh_filter_project_agg():
    def q(s, F):
        fact, _ = _tables(s)
        return (fact.filter(F.col("amount") > 25.0)
                .select("store",
                        (F.col("amount") * F.col("qty")).alias("rev"))
                .groupBy("store").agg(F.sum("rev").alias("total")))

    _mesh_vs_reference("filter_project", q)


# ----------------------------------------------------------------- joins

def test_mesh_q5_join_agg():
    """Shuffled hash join: both sides ride a key-hash all-to-all."""
    def q(s, F):
        fact, dim = _tables(s)
        return (fact.filter(F.col("amount") > 10.0)
                .join(dim, on="store", how="inner")
                .groupBy("region")
                .agg(F.sum("amount").alias("rev"), F.count("*").alias("n")))

    _, ex = _mesh_vs_reference("q5_join", q, SHUFFLED)
    assert len(ex["mesh"]["slots"]) == 3  # both join sides, the agg


def test_mesh_broadcast_join():
    def q(s, F):
        fact, dim = _tables(s)
        return fact.join(dim, on="store", how="inner") \
            .select("store", "amount", "region")

    _mesh_vs_reference("broadcast", q)


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti",
                                 "full"])
def test_mesh_join_types(how):
    def q(s, F):
        rng = np.random.default_rng(3)
        a = s.createDataFrame(pa.table({
            "k": pa.array(rng.integers(0, 30, 800), type=pa.int64()),
            "x": pa.array(rng.random(800), type=pa.float64())}))
        b = s.createDataFrame(pa.table({
            "k": pa.array(rng.integers(15, 45, 600), type=pa.int64()),
            "y": pa.array(rng.random(600), type=pa.float64())}))
        return a.join(b, on="k", how=how)

    _mesh_vs_reference(f"join_{how}", q, SHUFFLED)


def test_mesh_skew_overflow_retry(monkeypatch):
    """Skewed keys through a hash repartition overflow the first slots:
    the plan re-runs with the expansion doubled until they fit, as many
    times as the reference's does."""
    from spark_rapids_tpu.parallel import plan_compiler as jax_pc

    def q(s, F):
        n = 4000
        t = s.createDataFrame(pa.table({
            "k": pa.array(np.where(np.arange(n) % 10 == 0,
                                   np.arange(n) % 3, 7), type=pa.int64()),
            "v": pa.array(np.random.default_rng(5).random(n),
                          type=pa.float64())}))
        return t.repartition(4, "k").groupBy("k").agg(
            F.sum("v").alias("s"), F.count("*").alias("n"))

    tried = []
    real = jax_pc.MeshQueryExecutor._run

    def spy(self, phys, sources, sharded, expansion):
        tried.append(expansion)
        return real(self, phys, sources, sharded, expansion)

    monkeypatch.setattr(jax_pc.MeshQueryExecutor, "_run", spy)
    _, ex = _mesh_vs_reference("skew", q)
    assert len(tried) >= 2
    assert ex["mesh"]["retries"] == len(tried) - 1
    assert ex["mesh"]["expansion"] == tried[-1]


def test_mesh_fallback_for_unsupported():
    """A nested-loop join has no mesh lowering in either package: both
    hand the plan to the single-chip engines with the same reason."""
    def q(s, F):
        a = s.createDataFrame(pa.table({"x": pa.array(range(40),
                                                      type=pa.int64())}))
        b = s.createDataFrame(pa.table({"y": pa.array(range(25),
                                                      type=pa.int64())}))
        return a.crossJoin(b).groupBy("x").agg(F.count("*").alias("n"))

    conf = dict(MESH)
    want, wex = _reference("cross", q, conf)
    got, ex = _run("port", q, conf)
    assert wex["engine"] != "mesh" and ex["engine"] != "mesh"
    (eng, reason), = [f for f in ex["fallbacks"] if f[0] == "mesh"]
    assert (eng, reason) in [tuple(f) for f in wex["fallbacks"]]
    assert reason == "TpuBroadcastNestedLoopJoinExec has no mesh lowering"
    _assert_same(got, want)


@pytest.mark.parametrize("what", ["sort", "window", "limit", "union",
                                  "collect"])
def test_mesh_unported_lowering_raises(what):
    """The reference lowers these over the mesh; the port raises naming
    ROADMAP A16 rather than run another engine unsaid."""
    spark, F = _session("port", MESH)
    try:
        fact, _ = _tables(spark, n=600)
        if what == "sort":
            df = fact.orderBy("store", "amount")
        elif what == "window":
            from spark_rapids_tpu_torch.api.window import Window

            w = Window.partitionBy("store").orderBy("amount")
            df = fact.select("store", F.row_number().over(w).alias("rn"))
        elif what == "limit":
            df = fact.limit(5)
        elif what == "union":
            df = fact.union(fact).groupBy("store").agg(
                F.count("*").alias("n"))
        else:
            df = fact.groupBy("store").agg(F.collect_list("qty").alias("l"))
        with pytest.raises(NotImplementedError, match="ROADMAP A16"):
            df.collect_arrow()
    finally:
        spark.stop()


# ------------------------------------------------- scans and dictionaries

def _write_sharded_parquet(root, n_files=8, per=600,
                           shared=("both_a", "both_b")):
    """tests/test_multichip.py's files: a string column from disjoint
    per-file vocabularies plus a shared core, so every shard's dictionary
    differs."""
    path = os.path.join(root, "facts")
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(5)
    for i in range(n_files):
        vocab = [f"f{i}_v{j}" for j in range(5)] + list(shared)
        t = pa.table({
            "cat": pa.array(rng.choice(vocab, per), type=pa.large_string()),
            "store": pa.array(rng.integers(0, 50, per), type=pa.int64()),
            "amount": pa.array(rng.random(per) * 100, type=pa.float64()),
        })
        pq.write_table(t, os.path.join(path, f"part-{i}.parquet"),
                       use_dictionary=["cat"], row_group_size=per)
    return path


@pytest.fixture(scope="module")
def sharded_facts(tmp_path_factory):
    return _write_sharded_parquet(str(tmp_path_factory.mktemp("mesh")))


SCAN = {"spark.rapids.sql.format.parquet.reader.type": "PERFILE"}


@pytest.mark.parametrize("reconcile", [True, False])
def test_encoded_scan_groupby_reconciles_dictionaries(sharded_facts,
                                                      reconcile):
    """Each shard decodes its own file; the union dictionary (or, with
    reconciliation off, the decoded strings) gives the exact group set,
    the reference's (with its reconciliation on)."""
    def q(s, F):
        return (s.read.parquet(sharded_facts).groupBy("cat")
                .agg(F.sum("amount").alias("rev"), F.count("*").alias("n")))

    want, wex = _reference("encoded_scan", q, dict(MESH, **SCAN))
    got, ex = _run("port", q, dict(MESH, **SCAN, **{
        "spark.rapids.tpu.multichip.reconcileDictionaries": reconcile}))
    assert wex["engine"] == ex["engine"] == "mesh"
    _assert_same(got, want)
    assert got.num_rows == 42


def test_encoded_scan_join_on_plain_key(sharded_facts):
    """The encoded column rides the join's exchanges as codes."""
    def q(s, F):
        dim = s.createDataFrame(pa.table({
            "store": pa.array(np.arange(0, 50), type=pa.int64()),
            "w": pa.array((np.arange(0, 50) % 9).astype("float64"))}))
        return (s.read.parquet(sharded_facts)
                .join(dim, on="store", how="inner")
                .groupBy("cat")
                .agg(F.sum(F.col("amount") * F.col("w")).alias("wrev")))

    _mesh_vs_reference("encoded_join", q, dict(SCAN, **SHUFFLED))


def test_ici_shuffle_disabled_falls_back():
    """iciShuffle.enabled=false: the exchanges keep the host path, so
    both packages hand the plan to the single-chip engines, with the same
    recorded reason."""
    def q(s, F):
        fact, dim = _tables(s, n=2000, seed=3)
        return (fact.filter(F.col("amount") > 10.0)
                .join(dim, on="store", how="inner").groupBy("region")
                .agg(F.sum("amount").alias("rev"), F.count("*").alias("n")))

    conf = dict(MESH, **SHUFFLED, **{
        "spark.rapids.tpu.multichip.iciShuffle.enabled": False})
    want, wex = _reference("ici_off", q, conf)
    got, ex = _run("port", q, conf)
    assert wex["engine"] != "mesh" and ex["engine"] != "mesh"
    assert ("mesh", "ICI shuffle disabled: exchanges keep the host path") \
        in [tuple(f) for f in ex["fallbacks"]]
    assert ("mesh", "ICI shuffle disabled: exchanges keep the host path") \
        in [tuple(f) for f in wex["fallbacks"]]
    _assert_same(got, want)


def test_ici_shuffle_disabled_one_shard_falls_back():
    """A one-shard mesh with iciShuffle off: an explicit repartition stays
    pinned to the host shuffle path, so both packages fall back with the
    same recorded reason."""
    def q(s, F):
        fact, _ = _tables(s, n=2000, seed=5)
        return (fact.repartition(3, "store").groupBy("store")
                .agg(F.sum("amount").alias("rev")))

    conf = {"spark.rapids.tpu.mesh": 1, "spark.sql.shuffle.partitions": 4,
            "spark.rapids.tpu.multichip.iciShuffle.enabled": False}
    want, wex = _reference("ici_off_one_shard", q, conf)
    got, ex = _run("port", q, conf)
    assert wex["engine"] != "mesh" and ex["engine"] != "mesh"
    assert ("mesh", "exchange pinned to the host shuffle path") \
        in [tuple(f) for f in ex["fallbacks"]]
    assert ("mesh", "exchange pinned to the host shuffle path") \
        in [tuple(f) for f in wex["fallbacks"]]
    _assert_same(got, want)


def test_ici_shuffle_mode_selects_mesh_engine():
    """spark.rapids.shuffle.mode=ICI runs the mesh engine over every
    local device (the CPU is one) and gives test_mesh_groupby_agg's
    answer."""
    def q(s, F):
        fact, _ = _tables(s)
        return fact.groupBy("store").agg(
            F.sum("amount").alias("rev"), F.count("*").alias("n"),
            F.avg("qty").alias("aq"), F.min("amount").alias("mn"),
            F.max("amount").alias("mx"))

    want, _ = _reference("groupby", q, MESH)
    got, ex = _run("port", q, {"spark.rapids.shuffle.mode": "ICI"})
    assert ex["engine"] == "mesh" and ex["mesh"]["shards"] == 1
    _assert_same(got, want)


# ------------------------------------------------------- bench's queries

@pytest.fixture(scope="module")
def q5_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_q5"))
    write_q5_data(root, rows=8000, stores=300, dup_per_store=2)
    return root


def _bench(which: str, root: str):
    def q(s, F):
        fact = s.read.parquet(os.path.join(root, "fact"))
        dim = s.read.parquet(os.path.join(root, "dim"))
        dup = s.read.parquet(os.path.join(root, "dup"))
        if which == "string_q5":
            return string_q5_query(fact, dim, F=F)
        if which == "dupjoin":
            return (fact.filter(F.col("amount") > 50.0)
                    .join(dup, on="store", how="inner")
                    .select("promo", (F.col("amount") * F.col("discount"))
                            .alias("rebate"))
                    .groupBy("promo")
                    .agg(F.sum("rebate").alias("total_rebate"),
                         F.count("*").alias("n")))
        return (fact.filter(F.col("amount") > 10.0)
                .join(dim, on="store", how="inner")
                .filter(F.col("region") != "region_11")
                .select("region",
                        (F.col("amount") * F.col("qty")).alias("revenue"),
                        "amount")
                .groupBy("region")
                .agg(F.sum("revenue").alias("rev"),
                     F.avg("amount").alias("avg_amount"),
                     F.count("*").alias("sales")))
    return q


#: bench's queries over the mesh: (query, the port's conf); q5 with its
#: broadcast join is held to the reference's answer with the shuffled one
BENCH_CASES = {
    "q5": ("q5", {}), "q5_shuffled": ("q5", SHUFFLED),
    "string_q5": ("string_q5", {}), "dupjoin": ("dupjoin", {})}


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_bench_queries_over_the_mesh(q5_data, case):
    which, conf = BENCH_CASES[case]
    q = _bench(which, q5_data)
    ref_conf = dict(MESH, **SCAN, **(SHUFFLED if which == "q5" else {}))
    want, wex = _reference(f"bench_{which}", q, ref_conf)
    got, ex = _run("port", q, dict(MESH, **SCAN, **conf))
    assert wex["engine"] == ex["engine"] == "mesh"
    _assert_same(got, want)
    assert got.num_rows > 0


def test_cached_relations_over_the_mesh(q5_data):
    """Relations cached on the device are collected and split into the
    shards (their narrowed columns widened) and give q5's answer."""
    spark, F = _session("port", dict(MESH, **SCAN))
    try:
        frames = {t: spark.read.parquet(os.path.join(q5_data, t)).cache(
            storage="device") for t in ("fact", "dim", "dup")}
        got = (frames["fact"].filter(F.col("amount") > 10.0)
               .join(frames["dim"], on="store", how="inner")
               .filter(F.col("region") != "region_11")
               .select("region",
                       (F.col("amount") * F.col("qty")).alias("revenue"),
                       "amount")
               .groupBy("region")
               .agg(F.sum("revenue").alias("rev"),
                    F.avg("amount").alias("avg_amount"),
                    F.count("*").alias("sales"))).collect_arrow()
        assert spark.last_execution["engine"] == "mesh"
    finally:
        spark.stop()
    q = _bench("q5", q5_data)
    want, _ = _reference("bench_q5", q, dict(MESH, **SCAN, **SHUFFLED))
    _assert_same(got, want)


def test_peer_copy_route_gives_the_same_rows(q5_data, monkeypatch):
    """Shards on different devices move their blocks through a send
    buffer and a copy; forced here on the CPU, the answer is the same."""
    monkeypatch.setattr(port_coll, "_same_device", lambda a, b: False)
    conf = dict(MESH, **SCAN, **SHUFFLED)
    q = _bench("q5", q5_data)
    want, _ = _reference("bench_q5", q, conf)
    got, ex = _run("port", q, conf)
    assert ex["engine"] == "mesh"
    _assert_same(got, want)


# ------------------------------------------------------- the collectives

def _reference_all_to_all(keys, vals, n, slot):
    """The reference's all_to_all_batch under shard_map over n of the
    virtual devices: (rows of each shard as (k, v) lists, each shard's
    overflow flag)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from spark_rapids_tpu.columnar import arrow_to_device
    from spark_rapids_tpu.columnar.batch import ColumnBatch, DeviceColumn
    from spark_rapids_tpu.parallel import mesh_exec
    from spark_rapids_tpu.parallel.collective import all_to_all_batch
    from spark_rapids_tpu.shims import get_shim

    mesh = mesh_exec.make_mesh(n)
    t = pa.table({"k": pa.array(keys, type=pa.int64()),
                  "v": pa.array(vals, type=pa.float64())})
    batch = arrow_to_device(t, capacity=len(keys))
    sharded = mesh_exec.shard_batch(mesh, batch)

    def step(local):
        pid = (local.columns[0].data % n).astype(jnp.int32)
        out, overflow = all_to_all_batch(local, pid, n, slot,
                                         mesh_exec.AXIS)
        return (ColumnBatch(out.schema, out.columns,
                            jnp.asarray(out.num_rows,
                                        jnp.int32).reshape(1)),
                overflow.reshape(1))

    stub_cols = [
        DeviceColumn(f.dataType,
                     jax.ShapeDtypeStruct((n * slot,), c.data.dtype),
                     jax.ShapeDtypeStruct((n * slot,), jnp.bool_), None)
        for f, c in zip(batch.schema.fields, batch.columns)]
    stub = ColumnBatch(batch.schema, stub_cols,
                       jax.ShapeDtypeStruct((1,), jnp.int32))
    out_specs = (mesh_exec.batch_specs(stub, P(mesh_exec.AXIS)),
                 P(mesh_exec.AXIS))
    in_specs = mesh_exec.input_batch_specs(batch, P(mesh_exec.AXIS))
    fn = get_shim().shard_map(step, mesh, (in_specs,), out_specs)
    out, overflow = jax.jit(fn)(sharded)
    counts = np.asarray(out.num_rows)
    k = np.asarray(out.columns[0].data)
    v = np.asarray(out.columns[1].data)
    per = n * slot
    rows = [list(zip(k[s * per:s * per + counts[s]].tolist(),
                     v[s * per:s * per + counts[s]].tolist()))
            for s in range(n)]
    return rows, np.asarray(overflow).tolist()


@pytest.mark.parametrize("slot", [256, 32], ids=["fits", "overflows"])
def test_all_to_all_batch_matches_reference(slot):
    """Four shards: each shard's received rows, in order, and each
    source's overflow flag equal the reference's under shard_map."""
    from spark_rapids_tpu_torch.columnar.arrow_bridge import arrow_to_device

    n, cap = 4, 1024
    rng = np.random.default_rng(8)
    keys = np.where(rng.random(cap) < 0.4, 1, rng.integers(0, 97, cap))
    vals = np.arange(cap, dtype=np.float64)
    want_rows, want_ovf = _reference_all_to_all(keys, vals, n, slot)
    batch = arrow_to_device(pa.table({
        "k": pa.array(keys, type=pa.int64()),
        "v": pa.array(vals, type=pa.float64())}), capacity=cap,
        device="cpu")
    mesh = port_mesh.make_mesh(n, devices=[torch.device("cpu")] * n)
    shards = port_mesh.shard_batch(mesh, batch)
    pids = [(b.columns[0].data % n).to(torch.int32) for b in shards]
    out, flags = port_coll.all_to_all_batch(shards, pids, n, slot)
    counts, any_ovf = port_mesh.read_counts(out, flags)
    rows = [list(zip(b.columns[0].data[:c].tolist(),
                     b.columns[1].data[:c].tolist()))
            for b, c in zip(out, counts)]
    assert rows == want_rows
    assert [bool(f) for f in flags] == want_ovf
    assert any_ovf == (slot == 32)


def test_make_distributed_agg():
    """The flagship partial -> all-to-all -> final stage (the reference's
    tests/test_distributed.py cases): each key's sum and count, and an
    overflowing slot raising."""
    from spark_rapids_tpu_torch.columnar.arrow_bridge import (
        arrow_to_device,
        device_to_arrow,
    )
    from spark_rapids_tpu_torch.exec.fused import TpuSplitAndRetryOOM
    from spark_rapids_tpu_torch.exec.operators import TpuHashAggregateExec
    from spark_rapids_tpu_torch.expr import Alias, BoundReference, Count, Sum
    from spark_rapids_tpu_torch.sqltypes.datatypes import double, long

    n, cap = 8, 2048
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 37, cap)
    vals = rng.random(cap) * 100
    t = pa.table({"k": pa.array(keys, type=pa.int64()),
                  "v": pa.array(vals, type=pa.float64())})
    agg = TpuHashAggregateExec(
        "complete", [Alias(BoundReference(0, long, True), "k")],
        [Alias(Sum(BoundReference(1, double, True)), "s"),
         Alias(Count(None), "n")], None, None)
    mesh = port_mesh.make_mesh(n, devices=[torch.device("cpu")] * n)
    batch = arrow_to_device(t, device="cpu")
    step = port_mesh.make_distributed_agg(
        mesh, batch, agg._partial, agg._merge_final, [0],
        port_coll.slot_capacity(cap // n, n))
    got = device_to_arrow(port_mesh.gather_result(
        step(port_mesh.shard_batch(mesh, batch)))).to_pylist()
    assert sorted(r["k"] for r in got) == sorted(set(keys.tolist()))
    for r in got:
        mine = vals[keys == r["k"]]
        assert r["n"] == len(mine)
        assert r["s"] == pytest.approx(mine.sum(), rel=REL_TOL)
    tiny = port_mesh.make_distributed_agg(mesh, batch, agg._partial,
                                          agg._merge_final, [0], 1)
    with pytest.raises(TpuSplitAndRetryOOM):
        tiny(port_mesh.shard_batch(mesh, batch))


def _reference_slots(pid, num_rows, n_dest, slot):
    """The reference's rank construction (parallel/collective.py:151-167
    and `_scatter_to_slots`), line for line in numpy: (the row in each
    slot, live marks, send counts, overflow)."""
    cap = len(pid)
    live = np.arange(cap) < num_rows
    dest = np.where(live, pid, n_dest)
    counts_all = np.bincount(np.clip(dest, 0, n_dest),
                             weights=live.astype(np.int64),
                             minlength=n_dest + 1).astype(np.int64)
    dclip = np.clip(dest, 0, n_dest - 1)
    onehot = dest[:, None] == np.arange(n_dest)[None, :]
    cums = np.cumsum(onehot.astype(np.int32), axis=0)
    rank = np.take_along_axis(cums, dclip[:, None], axis=1)[:, 0] - 1
    overflow = bool(np.any(np.where(live, rank, 0) >= slot))
    rows = np.zeros((n_dest, slot), np.int32)
    keep = (dest < n_dest) & (rank < slot)  # mode="drop"
    rows[dest[keep], rank[keep]] = np.arange(cap, dtype=np.int32)[keep]
    counts = np.minimum(counts_all[:n_dest], slot)
    live_slots = np.arange(slot)[None, :] < counts[:, None]
    return rows.reshape(-1), live_slots.reshape(-1), counts, overflow


#: (cap, num_rows, n_dest, slot, pid pattern): the path's kind of shape,
#: n_dest 1, 2, 4 and 8, every row to one destination, overflow by one,
#: no live row and all but one, a capacity off the kernel's 1,024-row tile
SLOT_CASES = [
    (4096, 4000, 4, 2048, "hash"), (3000, 3000, 1, 3000, "hash"),
    (2048, 2000, 2, 1024, "hash"), (5000, 4999, 8, 1024, "hash"),
    (4096, 4096, 4, 4096, "one"), (4096, 1025, 4, 1024, "one"),
    (4096, 0, 4, 1024, "hash"), (4096, 4095, 4, 2048, "hash"),
    (1500, 1499, 4, 512, "hash"), (2049, 2049, 8, 16, "hash")]


@pytest.mark.parametrize("cap,num_rows,n_dest,slot,kind", SLOT_CASES)
def test_exchange_slots_plain_matches_reference(cap, num_rows, n_dest, slot,
                                                kind):
    """K37's plain version (the wrapper's route on the CPU) against the
    reference's construction at K37's edge cases, exactly."""
    rng = np.random.default_rng(cap + n_dest)
    pid = (np.full(cap, n_dest - 1) if kind == "one"
           else rng.integers(0, n_dest, cap)).astype(np.int32)
    want = _reference_slots(pid, num_rows, n_dest, slot)
    got = port_coll.exchange_slots(torch.from_numpy(pid), num_rows, n_dest,
                                   slot)
    assert np.array_equal(got.src_row.numpy(), want[0])
    assert np.array_equal(got.live.numpy(), want[1])
    assert np.array_equal(got.counts.numpy(), want[2])
    assert bool(got.overflow) == want[3]
    if kind == "one" and num_rows == 1025:
        assert want[3] and int(got.counts[n_dest - 1]) == slot


def test_mesh_devices():
    """A mesh takes the first n devices it is given and raises with
    fewer; 2D meshes are not ported."""
    cpu = torch.device("cpu")
    assert port_mesh.total_shards(port_mesh.make_mesh(2, [cpu] * 3)) == 2
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        port_mesh.make_mesh(4, devices=[cpu] * 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        port_mesh.make_host_mesh([[cpu], [cpu]])
