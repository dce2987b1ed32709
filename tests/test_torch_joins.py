"""The port's join operators against the JAX package's, operator by
operator.

The same seeded tables (int64 and float64 keys with nulls, duplicates,
NaN and -0.0, an int32 payload per side that a condition compares, a
string per side) become one batch per package: the port's on the CPU,
where every kernel wrapper runs its plain version. Each join type runs
under each strategy the reference's planner uses for it (broadcast hash,
shuffled hash with and without its sub-partition split, broadcast nested
loop), with and without a condition; every empty-side rule of
`_join_batches` runs on its own; dictionary-encoded keys join by codes
with one dictionary, with two (K29's re-encode) and with an evicted host
dictionary (the decode fallback); the adaptive engine's skew split,
broadcast promotion and partition-pruning decisions are checked through
both sessions; and K27-K29's plain versions are held against the
reference's functions. Rows are compared ignoring order, exactly.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.columnar import arrow_to_device as jax_arrow_to_device
from spark_rapids_tpu.columnar import encoding as jax_encoding
from spark_rapids_tpu.columnar.arrow_bridge import (
    device_to_arrow as jax_device_to_arrow,
)
from spark_rapids_tpu.config import rapids_conf as jax_rc
from spark_rapids_tpu.exec import joins as JJ
from spark_rapids_tpu.exec.base import PhysicalPlan as JaxPlan
from spark_rapids_tpu.expr import BoundReference as JRef
from spark_rapids_tpu.expr.predicates import LessThan as JLess
from spark_rapids_tpu.ops import partition as jax_partition
from spark_rapids_tpu.sqltypes import StructField as JField
from spark_rapids_tpu.sqltypes import StructType as JStruct
from spark_rapids_tpu.sqltypes import datatypes as JT
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.columnar import encoding as port_encoding
from spark_rapids_tpu_torch.columnar.arrow_bridge import (
    arrow_to_device as port_arrow_to_device,
)
from spark_rapids_tpu_torch.columnar.arrow_bridge import (
    device_to_arrow as port_device_to_arrow,
)
from spark_rapids_tpu_torch.config import rapids_conf as port_rc
from spark_rapids_tpu_torch.exec import joins as PJ
from spark_rapids_tpu_torch.exec.base import PhysicalPlan as PortPlan
from spark_rapids_tpu_torch.exec.base import new_task_context
from spark_rapids_tpu_torch.expr import BoundReference as PRef
from spark_rapids_tpu_torch.expr.predicates import LessThan as PLess
from spark_rapids_tpu_torch.ops import joinops as port_joinops
from spark_rapids_tpu_torch.ops import partition as port_partition
from spark_rapids_tpu_torch.plan import aqe as port_aqe
from spark_rapids_tpu_torch.sqltypes import StructField as PField
from spark_rapids_tpu_torch.sqltypes import StructType as PStruct
from spark_rapids_tpu_torch.sqltypes import datatypes as PT


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: beside the other test workers' pools its
    intra-op threads oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ inputs

def _tables():
    rng = np.random.default_rng(91)
    nl, nr = 40, 24

    def keys(n):
        k = rng.integers(0, 9, n).astype(np.int64)
        return pa.array(k, mask=rng.random(n) < 0.12)

    def floats(n):
        f = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, 2.5, -3.0]), n)
        return pa.array(f, mask=rng.random(n) < 0.1)

    def strings(n, p):
        return pa.array([f"{p}{i % 7}" for i in range(n)])

    left = pa.table({"k": keys(nl), "f": floats(nl),
                     "v": pa.array(rng.integers(0, 30, nl).astype(np.int32)),
                     "s": strings(nl, "l")})
    right = pa.table({"rk": keys(nr), "rf": floats(nr),
                      "w": pa.array(rng.integers(0, 30, nr).astype(np.int32)),
                      "t": strings(nr, "r")})
    return left, right


LEFT, RIGHT = _tables()
_TYPES = {"int64": "long", "double": "double", "int32": "integer",
          "string": "string", "bool": "boolean"}


def _schema(pkg, fields):
    """fields: [(name, arrow type name, nullable)] -> the package's
    StructType."""
    T, F, S = (JT, JField, JStruct) if pkg == "jax" else (PT, PField,
                                                          PStruct)
    return S([F(n, getattr(T, _TYPES[t]), nul) for n, t, nul in fields])


def _fields(table):
    return [(f.name, str(f.type), True) for f in table.schema]


def _join_fields(jt):
    """The join output's fields as the logical Join's schema makes them."""
    lf, rf = _fields(LEFT), _fields(RIGHT)
    if jt in ("left_semi", "left_anti"):
        return lf
    if jt == "existence":
        return lf + [("exists", "bool", False)]
    return lf + rf


class _JaxSrc(JaxPlan):
    def __init__(self, batches, schema):
        super().__init__([], schema, None)
        self.batches = batches

    @property
    def num_partitions(self):
        return max(1, len(self.batches))

    def execute_partition(self, pid, ctx):
        if pid < len(self.batches):
            yield self.batches[pid]


class _PortSrc(PortPlan):
    def __init__(self, batches, schema):
        super().__init__([], schema, None)
        self.batches = batches

    @property
    def num_partitions(self):
        return max(1, len(self.batches))

    def execute_partition(self, pid, ctx):
        if pid < len(self.batches):
            yield self.batches[pid]


def _batch(pkg, table):
    if pkg == "jax":
        return jax_arrow_to_device(table)
    return port_arrow_to_device(table, device="cpu")


def _src(pkg, table, schema_fields=None):
    fields = schema_fields or _fields(table)
    cls = _JaxSrc if pkg == "jax" else _PortSrc
    return cls([_batch(pkg, table)] if table.num_rows else [],
               _schema(pkg, fields))


def _cond(pkg):
    """v < w over the [left | right] pair layout."""
    ref, less = (JRef, JLess) if pkg == "jax" else (PRef, PLess)
    nl = LEFT.num_columns
    return less(ref(2, JT.integer if pkg == "jax" else PT.integer),
                ref(nl + 2, JT.integer if pkg == "jax" else PT.integer))


def _keys(pkg, col):
    """(left key, right key) refs on column `col` of each side: 0 the
    int64 key, 1 the float64 key."""
    ref = JRef if pkg == "jax" else PRef
    T = JT if pkg == "jax" else PT
    dt = T.long if col == 0 else T.double
    return [ref(col, dt)], [ref(col, dt)]


def _rows(table):
    def norm(v):
        return repr(v)
    return sorted(tuple(norm(v) for v in r.values())
                  for r in table.to_pylist())


def _node(pkg, strategy, jt, cond, key_col=0, conf=None, left=LEFT,
          right=RIGHT):
    J = JJ if pkg == "jax" else PJ
    ls, rs = _src(pkg, left), _src(pkg, right)
    schema = _schema(pkg, _join_fields(jt))
    c = _cond(pkg) if cond else None
    if strategy == "nested_loop":
        return J.TpuBroadcastNestedLoopJoinExec(ls, rs, jt, schema, conf,
                                                condition=c)
    lk, rk = _keys(pkg, key_col)
    cls = (J.TpuBroadcastHashJoinExec if strategy == "broadcast"
           else J.TpuShuffledHashJoinExec)
    return cls(ls, rs, jt, lk, rk, schema, conf, condition=c)


def _both(strategy, jt, cond, key_col=0, settings=None, **kw):
    jconf = jax_rc.RapidsConf(settings or {})
    pconf = port_rc.RapidsConf(settings or {})
    want = _node("jax", strategy, jt, cond, key_col, jconf, **kw).collect()
    got = _node("port", strategy, jt, cond, key_col, pconf, **kw).collect()
    return got, want


_CASES = (
    [("broadcast", jt) for jt in ("inner", "left", "left_semi", "left_anti",
                                  "existence")]
    + [("shuffled", jt) for jt in ("inner", "left", "full", "left_semi",
                                   "left_anti", "existence")]
    + [("nested_loop", jt) for jt in ("inner", "cross", "left", "full",
                                      "left_semi", "left_anti",
                                      "existence")])


@pytest.mark.parametrize("cond", [False, True], ids=["keys", "condition"])
@pytest.mark.parametrize("strategy,jt", _CASES,
                         ids=[f"{s}-{j}" for s, j in _CASES])
def test_join_matches_reference(strategy, jt, cond):
    got, want = _both(strategy, jt, cond)
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("jt", ["inner", "left", "full", "left_anti"])
def test_float_keys_nan_and_negative_zero(jt):
    """NaN keys equal NaN and -0.0 equals 0.0, as Spark normalises them;
    null keys match nothing."""
    got, want = _both("shuffled", jt, False, key_col=1)
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("jt", ["inner", "left", "full", "left_semi"])
def test_shuffled_sub_partition_split(jt):
    """A build side over batchSizeBytes splits both sides by a key hash of
    another seed; each piece joins on its own, and the answer is the
    reference's unsplit one. (The reference's own split fails on a full
    join whose piece is empty on both sides: `_left_nulls_batch` of no
    build batch; the port returns nothing for such a piece.)"""
    pconf = port_rc.RapidsConf({"spark.rapids.sql.batchSizeBytes": 64})
    got = _node("port", "shuffled", jt, True, 0, pconf).collect()
    want = _node("jax", "shuffled", jt, True, 0,
                 jax_rc.RapidsConf({})).collect()
    assert _rows(got) == _rows(want)


_EMPTY_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
                "existence")


@pytest.mark.parametrize("empty", ["left", "right", "both"])
@pytest.mark.parametrize("jt", _EMPTY_TYPES)
def test_empty_side_rules(jt, empty):
    """Every empty-side rule of _join_batches: nothing, the other side
    alone, or the other side padded with nulls."""
    out = {}
    for pkg in ("jax", "port"):
        node = _node(pkg, "shuffled", jt if jt != "right" else "left", False)
        node.join_type = jt
        lb = [] if empty in ("left", "both") else [_batch(pkg, LEFT)]
        rb = [] if empty in ("right", "both") else [_batch(pkg, RIGHT)]
        if (pkg == "jax" and empty == "both"
                and jt in ("right", "full")):
            # the reference pads a build side it does not have
            with pytest.raises(AttributeError):
                node._join_batches(lb, rb)
            out[pkg] = None
            continue
        res = node._join_batches(lb, rb)
        to_arrow = (jax_device_to_arrow if pkg == "jax"
                    else port_device_to_arrow)
        out[pkg] = None if res is None else to_arrow(res)
    if out["jax"] is None:
        assert out["port"] is None
    else:
        assert out["port"].column_names == out["jax"].column_names
        assert _rows(out["port"]) == _rows(out["jax"])


def test_nested_loop_full_with_empty_probe_pads_the_build():
    got, want = _both("nested_loop", "full", True, left=LEFT.slice(0, 0))
    assert got.num_rows == RIGHT.num_rows
    assert _rows(got) == _rows(want)


# ------------------------------------------------------------ encoded keys

_SEG = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]


def _encoded_tables(same: bool):
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 5, 60).astype(np.int32)
    lseg = pa.DictionaryArray.from_arrays(pa.array(codes), pa.array(_SEG))
    rdict = _SEG if same else _SEG[::-1] + ["SHIPPING"]
    rseg = pa.DictionaryArray.from_arrays(
        pa.array(np.arange(len(rdict), dtype=np.int32)), pa.array(rdict))
    left = pa.table({"seg": lseg, "v": pa.array(np.arange(60))})
    right = pa.table({"rseg": rseg,
                      "q": pa.array(np.arange(len(rdict)) * 10.0)})
    return left, right


def _encoded_join(pkg, left, right, evict=False):
    """An inner equi-join of the two encoded columns: (rows, the key
    rewrite's left and right key class names)."""
    J = JJ if pkg == "jax" else PJ
    T = JT if pkg == "jax" else PT
    ref = JRef if pkg == "jax" else PRef
    lf = [("seg", "string", True), ("v", "int64", True)]
    rf = [("rseg", "string", True), ("q", "double", True)]
    node = J.TpuShuffledHashJoinExec(
        _src(pkg, left, lf), _src(pkg, right, rf), "inner",
        [ref(0, T.string)], [ref(0, T.string)], _schema(pkg, lf + rf), None)
    lb, rb = _batch(pkg, left), _batch(pkg, right)
    assert lb.columns[0].encoding is not None
    if evict:
        # the build dictionary's host copy is gone: no remap table
        port_encoding._host_dicts.pop(rb.columns[0].encoding.dict_id)
    lk, rk = node._encoded_key_rewrite(lb, rb)
    res = node._join_batches([lb], [rb])
    to_arrow = jax_device_to_arrow if pkg == "jax" else port_device_to_arrow
    return (_rows(to_arrow(res)), type(lk[0]).__name__,
            type(rk[0]).__name__)


@pytest.mark.parametrize("same", [True, False], ids=["one_dict", "two_dicts"])
def test_encoded_keys_join_by_codes(same, monkeypatch):
    left, right = _encoded_tables(same)
    calls = []
    real = port_encoding.remap_codes
    monkeypatch.setattr(port_encoding, "remap_codes",
                        lambda c, t: calls.append(1) or real(c, t))
    want = _encoded_join("jax", left, right)
    got = _encoded_join("port", left, right)
    assert got == want
    assert got[1:] == ("CodesOf", "CodesOf")
    # two dictionaries re-encode the build side's codes (K29) once
    assert len(calls) == (0 if same else 1)


def test_evicted_host_dictionary_decodes_keys():
    left, right = _encoded_tables(False)
    want = _encoded_join("jax", left, right)
    got = _encoded_join("port", left, right, evict=True)
    assert got[0] == want[0]
    assert got[1:] == ("BoundReference", "BoundReference")


def test_codes_of_matches_reference():
    """CodesOf over a column of another dictionary: the reference's remap
    gather, absent values -1, validity carried."""
    left, right = _encoded_tables(False)
    out = {}
    for pkg, enc in (("jax", jax_encoding), ("port", port_encoding)):
        lb, rb = _batch(pkg, left), _batch(pkg, right)
        ref = JRef if pkg == "jax" else PRef
        T = JT if pkg == "jax" else PT
        expr = enc.CodesOf(ref(0, T.string), lb.columns[0].encoding.dict_id)
        from importlib import import_module
        core = import_module(("spark_rapids_tpu" if pkg == "jax"
                              else "spark_rapids_tpu_torch") + ".expr.core")
        col = expr.eval(core.EvalContext(rb))
        out[pkg] = (np.asarray(col.data), np.asarray(col.validity))
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert -1 in out["port"][0]


# -------------------------------------------------- K27-K29 plain versions

def test_probe_and_build_marks_plain_match_reference():
    rng = np.random.default_rng(5)
    n, m = 500, 77
    pi = rng.integers(0, m, n).astype(np.int32)
    bi = rng.integers(-3, m + 3, n).astype(np.int32)
    ok = rng.random(n) < 0.4
    want_l = np.asarray(jnp.zeros((m,), jnp.int32).at[pi].max(
        jnp.where(ok, 1, 0)) > 0)
    want_b = np.asarray(jnp.zeros((m,), jnp.int32).at[
        jnp.clip(bi, 0, m - 1)].max(jnp.where(ok, 1, 0)) > 0)
    got_l = port_joinops.probe_marks(torch.from_numpy(pi),
                                     torch.from_numpy(ok), m)
    got_b = port_joinops.build_marks(torch.from_numpy(bi),
                                     torch.from_numpy(ok), m)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    # the nested-loop join ORs the marks of its chunks
    prev = rng.random(m) < 0.2
    got_or = port_joinops.build_marks(torch.from_numpy(bi),
                                      torch.from_numpy(ok), m,
                                      out=torch.from_numpy(prev))
    np.testing.assert_array_equal(got_or.numpy(), want_b | prev)


def test_build_coverage_plain_matches_reference():
    rng = np.random.default_rng(6)
    n, cap = 300, 128
    lo = rng.integers(0, cap, n).astype(np.int32)
    counts = (rng.integers(0, 5, n) * (rng.random(n) < 0.5)).astype(np.int32)
    counts = np.minimum(counts, cap - lo).astype(np.int32)

    class _Bt:
        class batch:
            capacity = cap

    want = np.asarray(JJ._DeviceJoinBase._matched_build_mask(
        None, _Bt, jnp.asarray(lo), jnp.asarray(counts)))
    got = port_joinops.build_coverage(torch.from_numpy(lo),
                                      torch.from_numpy(counts), cap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,start,dead", [(16, 0, 0), (16, 5, 9), (1, 0, 3),
                                          (200, 2, 1)])
def test_round_robin_partition_matches_reference(n, start, dead):
    """K28's plain version: (row + start) % n for live rows, then K7's
    stable partition; n = 1 and n above the row count included."""
    table = LEFT.select(["k", "v", "s"])
    jb = jax_arrow_to_device(table)
    pb = port_arrow_to_device(table, device="cpu")
    rows = table.num_rows - dead
    from spark_rapids_tpu.columnar.batch import ColumnBatch as JB
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PB
    jb = JB(jb.schema, jb.columns, rows)
    pb = PB(pb.schema, pb.columns, rows)
    want = jax_partition.round_robin_partition(jb, n, start)
    got = port_partition.round_robin_partition(pb, n, start)
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    assert (port_device_to_arrow(got.batch).to_pylist()
            == jax_device_to_arrow(want.batch).to_pylist())


# ------------------------------------------------------ adaptive decisions

def _write(root, name, table, files=1):
    import os

    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    per = -(-table.num_rows // files)
    for i in range(files):
        pq.write_table(table.slice(i * per, per),
                       os.path.join(d, f"{name}-{i}.parquet"))
    return d


def _decisions(pkg, conf, build):
    conf = dict(conf, **{
        "spark.rapids.sql.format.parquet.reader.type": "PERFILE",
        "spark.rapids.sql.fusedExec.enabled": False})
    if pkg == "jax":
        spark, F = JaxSession(conf), JF
    else:
        spark = TpuSparkSession(dict(conf, **{
            "spark.rapids.torch.device": "cpu"}))
        F = PF
    try:
        # the reference records no decisions on its session: run each
        # package's adaptive executor on its own plan
        if pkg == "jax":
            from spark_rapids_tpu.plan.aqe import AdaptiveQueryExecutor
        else:
            AdaptiveQueryExecutor = port_aqe.AdaptiveQueryExecutor
        phys = build(spark, F)._physical()[0]
        ex = AdaptiveQueryExecutor(spark.rapids_conf)
        return ex.execute(phys), list(ex.decisions)
    finally:
        spark.stop()


@pytest.fixture(scope="module")
def skewed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("joins_aqe"))
    rng = np.random.default_rng(3)
    # key 0 holds most of the probe rows: one hot shuffle partition
    k = np.where(rng.random(3000) < 0.8, 0, rng.integers(1, 50, 3000))
    probe = pa.table({"k": pa.array(k.astype(np.int64)),
                      "x": pa.array(rng.random(3000))})
    build = pa.table({"bk": pa.array(np.arange(50, dtype=np.int64)),
                      "y": pa.array(np.arange(50) * 1.0)})
    return _write(root, "probe", probe, 2), _write(root, "build", build, 2)


def _kind(decision: str) -> str:
    return decision.split(":")[0].split(" ")[0]


def test_skew_split_decision_matches_reference(skewed):
    probe, build = skewed
    conf = {"spark.sql.autoBroadcastJoinThreshold": -1,
            "spark.sql.shuffle.partitions": 4,
            "spark.sql.adaptive.skewJoin.skewedPartitionThresholdInBytes": 1,
            "spark.sql.adaptive.skewJoin.skewedPartitionFactor": 2,
            "spark.rapids.sql.batchSizeBytes": 4096}

    def q(spark, F):
        p = spark.read.parquet(probe)
        b = spark.read.parquet(build)
        return (p.join(b, on=F.col("k") == F.col("bk"), how="left")
                .groupBy("k").agg(F.count("*").alias("n"),
                                  F.sum("y").alias("y")))

    want, wd = _decisions("jax", conf, q)
    got, gd = _decisions("port", conf, q)
    skew_w = [d for d in wd if d.startswith("skew split")]
    skew_g = [d for d in gd if d.startswith("skew split")]
    assert skew_w and skew_g
    # the same partition splits (the slice counts follow each package's
    # block sizes)
    assert ([d.split("->")[0] for d in skew_g]
            == [d.split("->")[0] for d in skew_w])
    assert _rows(got) == _rows(want)


def test_broadcast_promotion_and_no_pruning_match_reference(skewed):
    """A shuffled join whose build side (an aggregate: no size estimate)
    materialises under the threshold becomes a broadcast join and cancels
    the probe side's exchange; neither package prunes a plain scan."""
    probe, build = skewed

    def q(spark, F):
        p = spark.read.parquet(probe)
        b = (spark.read.parquet(build).groupBy("bk")
             .agg(F.sum("y").alias("y")))
        return (p.join(b, on=F.col("k") == F.col("bk"), how="inner")
                .groupBy("k").agg(F.count("*").alias("n")))

    conf = {"spark.sql.shuffle.partitions": 4}
    want, wd = _decisions("jax", conf, q)
    got, gd = _decisions("port", conf, q)
    assert [_kind(d) for d in gd] == [_kind(d) for d in wd]
    assert any(d.startswith("broadcast promotion") and "cancelled" in d
               for d in gd)
    assert not any("pruning" in d for d in gd + wd)
    assert _rows(got) == _rows(want)


def test_partition_pruning_decision():
    """The port's pruning decision over a scan with a partition spec: the
    build side's distinct keys go to the scan, which reports the files it
    dropped."""
    from spark_rapids_tpu_torch.exec import operators as ops

    pruned = []

    class _Scan(ops.TpuFileScanExec):
        _part_spec = ([("k", None)],)

        def prune_partitions(self, name, vals):
            pruned.append((name, sorted(vals)))
            return 3

    schema = _schema("port", [("k", "int64", True)])
    scan = _Scan("parquet", [], schema, None)
    conf = port_rc.RapidsConf({"spark.sql.shuffle.partitions": 2})
    bsrc = _PortSrc([port_arrow_to_device(
        pa.table({"bk": pa.array([4, 2, None, 4], type=pa.int64())}),
        device="cpu")], _schema("port", [("bk", "int64", True)]))
    rex = ops.TpuShuffleExchangeExec(bsrc, [PRef(0, PT.long)], 2, conf)
    rex._run_map_stage(new_task_context(conf))
    node = PJ.TpuShuffledHashJoinExec(
        ops.TpuShuffleExchangeExec(scan, [PRef(0, PT.long)], 2, conf), rex,
        "inner", [PRef(0, PT.long)], [PRef(0, PT.long)],
        _schema("port", [("k", "int64", True), ("bk", "int64", True)]),
        conf)
    ex = port_aqe.AdaptiveQueryExecutor(conf)
    ex._stats[id(rex)] = rex.partition_sizes()
    ex._try_dpp(node, rex)
    assert pruned == [("k", [2, 4])]
    assert ex.decisions == ["dynamic partition pruning on k: 3 files "
                            "skipped"]
