"""The port's array, map and struct columns against the JAX package's,
operator by operator.

Both packages upload the same seeded pyarrow table through their own
bridges: arrays of int32 (nulls, empty arrays, null rows, INT_MIN and
INT_MAX), of double (NaN, +-inf, -0.0), of dates and of strings (the
[cap, elems, bytes] cube, empty strings included), a map<int, double>
with null values and a struct<string, int> with null rows and fields. The
Arrow round trip of each type equals the reference's and the input.
Every class of `expr/collections.py`, `expr/structs.py` and
`expr/generators.py` is evaluated over both batches and each result
downloaded through its package's bridge: the two Arrow results must be
equal (doubles bit for bit, NaN equal to NaN). K33 (`frame_collect`) is
held against the reference's at W = 1, 3 and 6, lists and sets, over
values without NaN (with NaN the port follows Spark, where NaN equals NaN
in a set, and the reference's == does not: ROADMAP section C); the
window's collect and collect_list/collect_set results run through both
sessions. Each nested refusal names A9, and the relation cache keeps
every session's entries and active-session state apart.
"""

import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.columnar import arrow_bridge as jax_bridge
from spark_rapids_tpu.columnar.batch import ColumnBatch as JaxBatch
from spark_rapids_tpu.expr import collections as jax_cx
from spark_rapids_tpu.expr import core as jax_core
from spark_rapids_tpu.expr import structs as jax_st
from spark_rapids_tpu.expr.windows import WindowFrame as JaxFrame
from spark_rapids_tpu.ops import windowops as jax_w
from spark_rapids_tpu.sqltypes import StructField as JaxField
from spark_rapids_tpu.sqltypes import StructType as JaxStruct
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.api.window import Window as PWindow
from spark_rapids_tpu_torch.columnar import arrow_bridge as port_bridge
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch as PortBatch
from spark_rapids_tpu_torch.expr import collections as port_cx
from spark_rapids_tpu_torch.expr import core as port_core
from spark_rapids_tpu_torch.expr import structs as port_st
from spark_rapids_tpu_torch.ops import windowops as port_w
from spark_rapids_tpu_torch.sqltypes import StructField as PortField
from spark_rapids_tpu_torch.sqltypes import StructType as PortStruct

ROWS = 48
CPU = {"spark.rapids.torch.device": "cpu"}


def _table(seed: int = 12) -> pa.Table:
    rng = np.random.default_rng(seed)
    ints = [0, 1, -1, 3, 3, 7, 26, 40, -2 ** 31, 2 ** 31 - 1]
    dbls = [0.0, -0.0, 1.5, -2.25, float("nan"), float("inf"),
            float("-inf"), 30.0]
    words = ["", "AIR", "MAIL", "a", "TRUCK", "FOB x"]

    def lst(pool, k_max, null_elems=True):
        out = []
        for _ in range(ROWS):
            r = rng.random()
            if r < 0.1:
                out.append(None)
            elif r < 0.2:
                out.append([])
            else:
                out.append([None if null_elems and rng.random() < 0.15
                            else pool[rng.integers(len(pool))]
                            for _ in range(rng.integers(1, k_max + 1))])
        return out

    maps = []
    for _ in range(ROWS):
        if rng.random() < 0.1:
            maps.append(None)
            continue
        k = int(rng.integers(0, 5))
        maps.append([(j + 1, None if rng.random() < 0.2
                      else float(rng.integers(0, 100)) / 4)
                     for j in range(k)])
    structs = [None if rng.random() < 0.1 else
               {"p": None if rng.random() < 0.15 else words[i % 6],
                "c": None if rng.random() < 0.15 else int(i)}
               for i in range(ROWS)]
    return pa.table({
        "a": pa.array(lst(ints, 7), pa.list_(pa.int32())),
        "b": pa.array(lst(ints[:6], 5), pa.list_(pa.int32())),
        "f": pa.array(lst(dbls, 6), pa.list_(pa.float64())),
        "g": pa.array(lst(dbls[:4], 4), pa.list_(pa.float64())),
        "d": pa.array(lst([0, 9000, 10_000], 3), pa.list_(pa.int32()))
        .cast(pa.list_(pa.date32())),
        "s": pa.array(lst(words, 5), pa.list_(pa.string())),
        "m": pa.array(maps, pa.map_(pa.int32(), pa.float64())),
        "st": pa.array(structs, pa.struct([("p", pa.string()),
                                           ("c", pa.int32())])),
        "i": pa.array(rng.integers(-3, 6, ROWS).astype(np.int32)),
        "x": pa.array(rng.integers(0, 40, ROWS).astype(np.int32)),
    })


TABLE = _table()


class _Pkg:
    """One package's modules and its batch of TABLE."""

    def __init__(self, jax: bool):
        self.jax = jax
        self.CX = jax_cx if jax else port_cx
        self.ST = jax_st if jax else port_st
        self.core = jax_core if jax else port_core
        if jax:
            self.batch = jax_bridge.arrow_to_device(TABLE)
        else:
            self.batch = port_bridge.arrow_to_device(TABLE, device="cpu")
        self.schema = self.batch.schema

    def ref(self, name):
        i = self.schema.field_index(name)
        f = self.schema.fields[i]
        return self.core.BoundReference(i, f.dataType, True)

    def lit(self, v):
        return self.core.Literal(v)

    def eval(self, expr) -> pa.Array:
        col = expr.eval(self.core.EvalContext(self.batch))
        n = self.batch.row_count()
        if self.jax:
            b = JaxBatch(JaxStruct([JaxField("r", expr.dtype)]), [col], n)
            return jax_bridge.device_to_arrow(b).column(0)
        b = PortBatch(PortStruct([PortField("r", expr.dtype)]), [col], n)
        return port_bridge.device_to_arrow(b).column(0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: beside the other test workers' pools its
    intra-op threads oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pkgs():
    return _Pkg(True), _Pkg(False)


def _norm(v):
    """NaN as a marker and -0.0 apart from 0.0, recursively, so that
    doubles compare bit for bit."""
    if isinstance(v, float):
        return ("nan",) if math.isnan(v) else (v, math.copysign(1, v))
    if isinstance(v, list):
        return [_norm(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


def test_arrow_round_trip_matches_reference():
    """Upload and download of every nested type give the input back, and
    the port's leaves equal the reference's array for array."""
    jb = jax_bridge.arrow_to_device(TABLE)
    pb = port_bridge.arrow_to_device(TABLE, device="cpu")
    got = port_bridge.device_to_arrow(pb)
    assert _norm(got.to_pylist()) == _norm(TABLE.to_pylist())
    assert _norm(jax_bridge.device_to_arrow(jb).to_pylist()) == _norm(
        got.to_pylist())
    for jc, pc in zip(jb.columns, pb.columns):
        pairs = [(jc.data, pc.data), (jc.validity, pc.validity),
                 (jc.lengths, pc.lengths),
                 (jc.elem_validity, pc.elem_validity),
                 (jc.map_values, pc.map_values),
                 (jc.elem_lengths, pc.elem_lengths)]
        for j, p in pairs:
            assert (j is None) == (p is None)
            if j is not None:
                np.testing.assert_array_equal(
                    np.asarray(j).view(np.uint8), p.numpy().view(np.uint8))
        assert (jc.children is None) == (pc.children is None)


#: name -> builder(pkg) of one expression over TABLE's columns
CASES = {
    "Size": lambda k: k.CX.Size(k.ref("a")),
    "ArrayContains": lambda k: k.CX.ArrayContains(k.ref("a"), k.lit(3)),
    "ArrayContains_double": lambda k: k.CX.ArrayContains(k.ref("f"),
                                                         k.lit(1.5)),
    "ArrayContains_cube": lambda k: k.CX.ArrayContains(k.ref("s"),
                                                       k.lit("AIR")),
    "GetArrayItem": lambda k: k.CX.GetArrayItem(k.ref("a"), k.ref("i")),
    "GetArrayItem_cube": lambda k: k.CX.GetArrayItem(k.ref("s"), k.lit(1)),
    "ElementAt": lambda k: k.CX.ElementAt(k.ref("a"), k.ref("i")),
    "ElementAt_negative": lambda k: k.CX.ElementAt(k.ref("f"), k.lit(-1)),
    "ElementAt_cube": lambda k: k.CX.ElementAt(k.ref("s"), k.lit(-2)),
    "ElementAt_map": lambda k: k.CX.ElementAt(k.ref("m"), k.lit(2)),
    "CreateArray": lambda k: k.CX.CreateArray(k.ref("i"), k.ref("x")),
    "ArrayTransform": lambda k: k.CX.ArrayTransform(
        k.ref("a"), fn=lambda x: x * 2),
    "ArrayFilter": lambda k: k.CX.ArrayFilter(k.ref("a"),
                                              fn=lambda x: x > 2),
    "ArrayFilter_double": lambda k: k.CX.ArrayFilter(
        k.ref("f"), fn=lambda x: x < 2.0),
    "ArrayExists": lambda k: k.CX.ArrayExists(k.ref("a"),
                                              fn=lambda x: x > 25),
    "ArrayForall": lambda k: k.CX.ArrayForall(k.ref("a"),
                                              fn=lambda x: x > 0),
    "ArrayMax": lambda k: k.CX.ArrayMax(k.ref("a")),
    "ArrayMax_double": lambda k: k.CX.ArrayMax(k.ref("f")),
    "ArrayMin": lambda k: k.CX.ArrayMin(k.ref("a")),
    "ArrayMin_double": lambda k: k.CX.ArrayMin(k.ref("f")),
    "SortArray_asc": lambda k: k.CX.SortArray(k.ref("a"), True),
    "SortArray_desc": lambda k: k.CX.SortArray(k.ref("a"), False),
    "SortArray_double_asc": lambda k: k.CX.SortArray(k.ref("g"), True),
    "SortArray_double_desc": lambda k: k.CX.SortArray(k.ref("g"), False),
    "SortArray_date": lambda k: k.CX.SortArray(k.ref("d"), False),
    "MapKeys": lambda k: k.CX.MapKeys(k.ref("m")),
    "MapValues": lambda k: k.CX.MapValues(k.ref("m")),
    "MapContainsKey": lambda k: k.CX.MapContainsKey(k.ref("m"), k.lit(3)),
    "GetMapValue": lambda k: k.CX.GetMapValue(k.ref("m"), k.ref("i")),
    "MapFromArrays": lambda k: k.CX.MapFromArrays(k.ref("b"), k.ref("g")),
    "CreateMap": lambda k: k.CX.CreateMap(k.ref("i"), k.ref("x")),
    "Slice": lambda k: k.CX.Slice(k.ref("a"), k.ref("i"), k.lit(2)),
    "Slice_negative": lambda k: k.CX.Slice(k.ref("f"), k.lit(-2), k.lit(5)),
    "ArrayPosition": lambda k: k.CX.ArrayPosition(k.ref("a"), k.lit(3)),
    "ArrayPosition_nan": lambda k: k.CX.ArrayPosition(
        k.ref("f"), k.lit(float("nan"))),
    "ArrayRemove": lambda k: k.CX.ArrayRemove(k.ref("a"), k.lit(3)),
    "ArrayDistinct": lambda k: k.CX.ArrayDistinct(k.ref("a")),
    "ArrayDistinct_double": lambda k: k.CX.ArrayDistinct(k.ref("f")),
    "Reverse": lambda k: k.CX.Reverse(k.ref("a")),
    "ConcatArrays": lambda k: k.CX.ConcatArrays(k.ref("a"), k.ref("b")),
    "ArraysOverlap": lambda k: k.CX.ArraysOverlap(k.ref("a"), k.ref("b")),
    "ArrayIntersect": lambda k: k.CX.ArrayIntersect(k.ref("a"), k.ref("b")),
    "ArrayExcept": lambda k: k.CX.ArrayExcept(k.ref("a"), k.ref("b")),
    "ArrayUnion": lambda k: k.CX.ArrayUnion(k.ref("a"), k.ref("b")),
    "GetStructField": lambda k: k.ST.GetStructField(k.ref("st"), "p"),
    "GetStructField_int": lambda k: k.ST.GetStructField(k.ref("st"), "c"),
    "CreateNamedStruct": lambda k: k.ST.CreateNamedStruct(
        ["i", "n"], [k.ref("i"), k.CX.Size(k.ref("a"))]),
    "CreateNamedStruct_gated": lambda k: k.ST.CreateNamedStruct(
        ["c"], [k.ST.GetStructField(k.ref("st"), "c")], k.ref("st")),
    "NullGate": lambda k: k.ST.NullGate(k.ref("st")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_expression_matches_reference(pkgs, name):
    """One expression over both packages' batches: equal Arrow results,
    doubles bit for bit."""
    jk, pk = pkgs
    want = jk.eval(CASES[name](jk))
    got = pk.eval(CASES[name](pk))
    assert got.type == want.type
    assert _norm(got.to_pylist()) == _norm(want.to_pylist())


def _session_pair(tmp_path, table, fused=False):
    pq.write_table(table, str(tmp_path / "t.parquet"))
    spark = TpuSparkSession(dict(CPU, **{
        "spark.rapids.sql.fusedExec.enabled": fused}))
    return spark, spark.read.parquet(str(tmp_path))


def test_generators_match_reference(tmp_path):
    """explode and posexplode of arrays (the cube's strings included)
    with pass-through columns, on both of the port's engines, equal the
    reference's session."""
    pq.write_table(TABLE, str(tmp_path / "t.parquet"))
    queries = {
        "explode": lambda df, F: df.select("i", F.explode("a")),
        "posexplode_cube": lambda df, F: df.select(
            "x", F.posexplode("s")),
        "posexplode_double": lambda df, F: df.select(
            F.posexplode("f"), "st"),
    }
    jspark = JaxSession({})
    jdf = jspark.read.parquet(str(tmp_path))
    want = {q: _norm(sorted(b(jdf, JF).collect_arrow().to_pylist(),
                            key=repr)) for q, b in queries.items()}
    jspark.stop()
    for fused in (False, True):
        spark = TpuSparkSession(dict(CPU, **{
            "spark.rapids.sql.fusedExec.enabled": fused}))
        df = spark.read.parquet(str(tmp_path))
        if fused:
            df = df.cache(storage="device")
        for q, b in queries.items():
            got = b(df, PF).collect_arrow()
            assert (spark.last_execution["engine"] == "fused") == fused
            assert _norm(sorted(got.to_pylist(), key=repr)) == want[q], q
        spark.stop()


def _windows(seed=5, n=700):
    rng = np.random.default_rng(seed)
    part = np.sort(rng.integers(0, 40, n))
    return (rng.integers(0, 9, n).astype(np.int32), rng.random(n) < 0.85,
            part.astype(np.int64), rng.integers(0, 30, n).astype(np.int32))


@pytest.mark.parametrize("lower", [0, -2, -5], ids=["W1", "W3", "W6"])
@pytest.mark.parametrize("distinct", [False, True], ids=["list", "set"])
def test_frame_collect_matches_reference(lower, distinct):
    """K33's plain version against the reference's frame_collect (its
    sorted result written back through the inverse permutation), over
    int32 values with nulls and dead rows, 40 partitions ordered by a
    key with ties."""
    vals, valid, part, order = _windows()
    n, cap = len(vals), 1024
    tbl = pa.table({"v": pa.array(vals, mask=~valid), "p": part,
                    "o": order})
    jb = jax_bridge.arrow_to_device(tbl, capacity=cap)
    pb = port_bridge.arrow_to_device(tbl, capacity=cap, device="cpu")
    jsw = jax_w.sort_for_window(jb, [jb.columns[1]],
                                [(jb.columns[2], True, True)])
    psw = port_w.sort_for_window(pb, [pb.columns[1]],
                                 [(pb.columns[2], True, True)])
    np.testing.assert_array_equal(np.asarray(jsw.perm), psw.perm.numpy())
    frame = JaxFrame("rows", lower, 0)
    start, end = jax_w.rows_frame_bounds(jsw, lower, 0)
    vs = jb.columns[0].gather(jsw.perm)
    d, _, lens, ev = jax_w.frame_collect(vs.data, vs.validity, jsw, start,
                                         end, frame, distinct)
    inv = np.asarray(jsw.inv)
    want_d, want_len = np.asarray(d)[inv], np.asarray(lens)[inv]
    want_ev = np.asarray(ev)[inv]
    got_d, got_ev, got_len = port_w.frame_collect(
        pb.columns[0].data, pb.columns[0].validity, psw, lower, 0, distinct)
    np.testing.assert_array_equal(got_len.numpy()[:n], want_len[:n])
    np.testing.assert_array_equal(got_ev.numpy()[:n], want_ev[:n])
    np.testing.assert_array_equal(np.where(want_ev, want_d, 0)[:n],
                                  got_d.numpy()[:n])


def test_frame_collect_set_nan_equals_nan():
    """collect_set frames follow Spark: NaN equals NaN and -0.0 equals
    0.0 (the reference's == keeps every NaN: ROADMAP section C)."""
    vals = torch.tensor([float("nan"), float("nan"), -0.0, 0.0, 1.0,
                         float("nan")], dtype=torch.float64)
    n = len(vals)
    pos = torch.arange(n, dtype=torch.int32)
    zeros = torch.zeros(n, dtype=torch.int32)
    sw = port_w.SortedWindow(pos, torch.ones(n, dtype=torch.bool), pos,
                             zeros, zeros + n - 1, zeros + n, zeros,
                             zeros + n - 1, zeros)
    d, ev, lens = port_w.frame_collect(vals, torch.ones(n, dtype=torch.bool),
                                       sw, -5, 0, True)
    assert lens.tolist() == [1, 1, 2, 2, 3, 3]
    last = d[5, :3].tolist()
    assert math.isnan(last[0]) and last[1:] == [-0.0, 1.0]
    assert math.copysign(1, last[1]) < 0


@pytest.fixture(scope="module")
def orders_dir(tmp_path_factory):
    from spark_rapids_tpu_torch.q5 import write_nested_orders

    root = str(tmp_path_factory.mktemp("nested"))
    write_nested_orders(root, 300, 1200, files=2, seed=9)
    return root + "/nested_orders"


def _rows(table, lists=()):
    """Rows as sorted dicts; the named list columns as sorted lists
    (multisets: Spark leaves collect order open)."""
    out = []
    for r in table.to_pylist():
        out.append({k: (sorted(v) if k in lists and v is not None else v)
                    for k, v in r.items()})
    return sorted(_norm(out), key=repr)


def test_window_collect_matches_reference(orders_dir):
    """The window's collect_list at W = 1 and 3 and collect_set at W = 6
    of each order's customers, recent prices and years through the
    reference's session and the port's on both engines (collect_list and
    collect_set results run in test_torch_nested_queries.py's
    customer_order_lists)."""
    def queries(df, F, Window):
        w = Window.partitionBy("o_custkey").orderBy("o_orderdate",
                                                    "o_orderkey")
        flat = df.select("o_orderkey", "o_custkey", "o_orderdate",
                         "o_totalprice")
        return {
            "window": flat.select(
                "o_orderkey",
                F.collect_list("o_totalprice").over(w.rowsBetween(-2, 0))
                .alias("l3"),
                F.collect_set(F.year("o_orderdate"))
                .over(w.rowsBetween(-5, 0)).alias("s6"),
                F.collect_list("o_custkey").over(w.rowsBetween(0, 0))
                .alias("l1")),
        }

    jspark = JaxSession({})
    want = {q: _rows(d.collect_arrow(), ("s6", "custs", "years"))
            for q, d in queries(jspark.read.parquet(orders_dir), JF,
                                JWindow).items()}
    jspark.stop()
    for fused in (False, True):
        spark = TpuSparkSession(dict(CPU, **{
            "spark.rapids.sql.fusedExec.enabled": fused}))
        df = spark.read.parquet(orders_dir)
        if fused:
            df = df.cache(storage="device")
        for q, d in queries(df, PF, PWindow).items():
            got = _rows(d.collect_arrow(), ("s6", "custs", "years"))
            assert got == want[q], (q, fused)
            engine = spark.last_execution["engine"]
            assert (engine == "fused") == fused, engine
        spark.stop()


#: name -> a query (over the table's DataFrame) that the reference runs on
#: its CPU engine and the port refuses naming A9
REFUSED = {
    "sort_array_of_strings": lambda df: df.select(PF.sort_array("s")),
    "filter_of_strings": lambda df: df.select(
        PF.filter_array("s", lambda x: PF.length(x) > 1)),
    "array_distinct_of_strings": lambda df: df.select(
        PF.array_distinct("s")),
    "window_collect_unbounded": lambda df: df.select(
        PF.collect_list("i").over(PWindow.partitionBy("x").orderBy("i"))
        .alias("w")),
    "window_collect_span": lambda df: df.select(
        PF.collect_list("i").over(PWindow.partitionBy("x").orderBy("i")
                                  .rowsBetween(-1024, 0)).alias("w")),
    "window_collect_strings": lambda df: df.select(
        PF.collect_list(PF.col("st").getField("p")).over(
            PWindow.partitionBy("x").orderBy("i").rowsBetween(-1, 0))
        .alias("w")),
    "window_struct_payload": lambda df: df.select(
        "st", PF.collect_list("i").over(
            PWindow.partitionBy("x").orderBy("i").rowsBetween(-1, 0))
        .alias("w")),
    "window_sum_over_array": lambda df: df.select(
        PF.first("a").over(PWindow.partitionBy("x").orderBy("i")
                           .rowsBetween(-1, 0)).alias("w")),
    "collect_list_of_strings": lambda df: df.groupBy("x").agg(
        PF.collect_list(PF.col("st").getField("p"))),
    "collect_set_of_arrays": lambda df: df.groupBy("x").agg(
        PF.collect_set("a")),
    "sort_by_array": lambda df: df.orderBy("a"),
    "group_by_struct": lambda df: df.groupBy("st").agg(PF.count("*")),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_name_a9(tmp_path, name):
    """What the reference runs on its CPU engine raises naming A9."""
    pq.write_table(TABLE, str(tmp_path / "t.parquet"))
    spark = TpuSparkSession(CPU)
    try:
        df = spark.read.parquet(str(tmp_path))
        with pytest.raises(NotImplementedError, match="A9"):
            REFUSED[name](df).collect_arrow()
    finally:
        spark.stop()


@pytest.mark.parametrize("schema", [
    pa.list_(pa.list_(pa.int32())),
    pa.map_(pa.string(), pa.int32()),
    pa.struct([("q", pa.list_(pa.int32()))]),
], ids=["array_of_arrays", "map_of_strings", "struct_of_arrays"])
def test_nested_types_the_reference_keeps_on_cpu_name_a9(tmp_path, schema):
    """Arrays of arrays, maps of strings and structs of arrays: the
    reference's device types refuse them; the port's scan names A9."""
    arr = pa.array([None], type=schema)
    pq.write_table(pa.table({"c": arr}), str(tmp_path / "t.parquet"))
    spark = TpuSparkSession(CPU)
    try:
        with pytest.raises(NotImplementedError, match="A9"):
            spark.read.parquet(str(tmp_path)).collect_arrow()
    finally:
        spark.stop()


def test_sessions_keep_their_caches_and_active_state(tmp_path,
                                                     monkeypatch):
    """Two sessions of one process share no cached relation and no
    active-session state: a plan cached in one is not substituted in the
    other's queries, and while a query of the first session runs, the
    active session its expressions read is the first, though the second
    was created later."""
    from spark_rapids_tpu_torch.plan import logical as L

    pq.write_table(TABLE, str(tmp_path / "t.parquet"))
    a = TpuSparkSession(CPU)
    b = TpuSparkSession(CPU)
    try:
        da = a.read.parquet(str(tmp_path)).cache(storage="device")
        db = b.read.parquet(str(tmp_path))
        assert a.cache_manager.lookup(da._plan) is not None
        assert b.cache_manager.lookup(db._plan) is None
        plan = b.cache_manager.substitute(db._plan)
        assert not isinstance(plan, L.CachedRelation)
        seen = []
        real = port_cx.Size.eval

        def spy(self, ctx):
            seen.append(TpuSparkSession.active())
            return real(self, ctx)

        monkeypatch.setattr(port_cx.Size, "eval", spy)
        assert TpuSparkSession.active() is b
        da.select(PF.size("a")).collect_arrow()
        assert seen and all(s is a for s in seen)
        seen.clear()
        db.select(PF.size("a")).collect_arrow()
        assert seen and all(s is b for s in seen)
        assert TpuSparkSession.active() is b
    finally:
        a.stop()
        b.stop()


def test_cpu_entry_never_reaches_another_device(tmp_path):
    """A session whose conf names another device (a stub "meta" device;
    nothing is uploaded) takes no entry cached for the CPU: registering
    one raises before anything is planned, the CPU entry is not
    substituted in its queries, what it registers itself lives on its own
    device, and its DataFrames do not combine with a CPU session's."""
    from spark_rapids_tpu_torch.plan import logical as L

    pq.write_table(TABLE, str(tmp_path / "t.parquet"))
    cpu = TpuSparkSession(CPU)
    other = TpuSparkSession({"spark.rapids.torch.device": "meta"})
    try:
        dcpu = cpu.read.parquet(str(tmp_path)).cache(storage="device")
        entry = cpu.cache_manager.lookup(dcpu._plan)
        entry.materialize()
        assert {c.device.type for p in entry.device_parts()
                for c in p.columns} == {"cpu"}
        with pytest.raises(ValueError, match="meta"):
            other.cache_manager.register(dcpu._plan, cpu.rapids_conf)
        dother = other.read.parquet(str(tmp_path))
        plan = other.cache_manager.substitute(dother._plan)
        assert not isinstance(plan, L.CachedRelation)
        own = other.cache_manager.register(dother._plan, other.rapids_conf)
        assert own is not entry and own.device == torch.device("meta")
        for combine in (lambda x, y: x.union(y),
                        lambda x, y: x.crossJoin(y)):
            with pytest.raises(ValueError, match="cannot combine"):
                combine(dother, dcpu)
    finally:
        cpu.stop()
        other.stop()
