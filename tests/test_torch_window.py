"""The port's window path against the JAX package: the window sort
(`sort_for_window`: K9, K10, K12), the frame and rank evaluation (K14),
and window queries through both sessions.

Inputs are made with numpy from a seed and go through the JAX functions
(CPU backend) and the port with device="cpu", where each kernel wrapper
runs its plain PyTorch version. Positions, counts, integer sums and ranks
must be equal array for array; float64 frame sums agree within 1e-9
relative (docs/compatibility.md, "Execution") over the frames that hold a
valid row: both take the prefix over the whole batch and subtract, and
torch.cumsum and XLA's cumsum add in other orders. The queries run
bench.py's window query (row_number, rank, dense_rank and a running sum
over `store` ordered by `day`) and ScaleTest q6 through both sessions;
results compare ignoring row order (a window keeps its input rows, and
the engines emit them in other orders).
"""

import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.api.window import Window as JaxWindow
from spark_rapids_tpu.ops import windowops as jax_windowops
from spark_rapids_tpu.testing.scaletest import QUERIES, generate_data
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.api.window import Window as PortWindow
from spark_rapids_tpu_torch.ops import windowops as port_windowops
from spark_rapids_tpu_torch.q5 import window_query, write_q5_data

from test_torch_kernels import both_batches, same
from test_torch_sort import CONF, run_both

REL_TOL = 1e-9


def _window_table(rng, n: int, parts: int) -> pa.Table:
    """A partition key with nulls, a one-row partition and many small
    ones; an order key with ties and nulls; a double and a long value,
    both with nulls."""
    p = rng.integers(0, parts, n)
    p[0] = parts + 5  # a partition of one row
    o = rng.integers(0, 9, n)
    return pa.table({
        "p": pa.array(p, type=pa.int64(), mask=rng.random(n) < 0.05),
        "o": pa.array(o, type=pa.int64(), mask=rng.random(n) < 0.05),
        "v": pa.array(rng.random(n) * 100.0, type=pa.float64(),
                      mask=rng.random(n) < 0.1),
        "q": pa.array(rng.integers(-50, 50, n), type=pa.int64(),
                      mask=rng.random(n) < 0.1),
    })


def _sorted_windows(rng, n, parts, dead, keys, ascending, nulls_first):
    jb, pb = both_batches(_window_table(rng, n, parts), dead=dead)

    def cols(b):
        part = [b.columns[0]] if "p" in keys else []
        order = ([(b.columns[1], ascending, nulls_first)] if "o" in keys
                 else [])
        return part, order

    jsw = jax_windowops.sort_for_window(jb, *cols(jb))
    psw = port_windowops.sort_for_window(pb, *cols(pb))
    return jb, pb, jsw, psw


_CASES = [
    # (rows, partitions, dead rows, keys, ascending, nulls_first)
    (3000, 40, 0, "po", True, True),
    (3000, 40, 123, "po", False, False),
    (3000, 7, 55, "po", True, False),
    (3000, 40, 10, "p", True, True),
    (3000, 40, 10, "o", False, True),
    (3000, 40, 10, "", True, True),
    (1, 1, 0, "po", True, True),
    (600, 3, 600, "po", True, True),   # every row dead
]


@pytest.mark.parametrize("n,parts,dead,keys,asc,nf", _CASES)
def test_sort_for_window_matches_reference(n, parts, dead, keys, asc, nf):
    rng = np.random.default_rng(31)
    _, _, jsw, psw = _sorted_windows(rng, n, parts, dead, keys, asc, nf)
    for f in ("perm", "live", "pos", "seg_start", "seg_end", "seg_len",
              "peer_start", "peer_end"):
        same(getattr(psw, f), getattr(jsw, f), f)
    inv = torch.empty_like(psw.pos)
    inv[psw.perm.to(torch.int64)] = psw.pos
    same(inv, jsw.inv, "inv")


@pytest.mark.parametrize("n,parts,dead,keys,asc,nf", _CASES)
def test_ranks_match_reference(n, parts, dead, keys, asc, nf):
    rng = np.random.default_rng(32)
    _, _, jsw, psw = _sorted_windows(rng, n, parts, dead, keys, asc, nf)
    for fn in ("row_number", "rank", "dense_rank"):
        same(getattr(port_windowops, fn)(psw),
             getattr(jax_windowops, fn)(jsw), fn)


_FRAMES = {
    "default": None,
    "rows_-2_1": (-2, 1),
    "rows_unbounded_0": (None, 0),
    "rows_-1_unbounded": (-1, None),
    "rows_3_5": (3, 5),          # frames past the partition end: empty
    "whole": (None, None),
}


@pytest.mark.parametrize("frame", list(_FRAMES))
@pytest.mark.parametrize("n,parts,dead,keys,asc,nf", _CASES)
def test_frame_sums_and_counts_match_reference(n, parts, dead, keys, asc,
                                               nf, frame):
    rng = np.random.default_rng(33)
    jb, pb, jsw, psw = _sorted_windows(rng, n, parts, dead, keys, asc, nf)
    bounds = _FRAMES[frame]
    if bounds is None:
        jse = jax_windowops.default_frame_bounds(jsw, "o" in keys)
        pse = port_windowops.default_frame_bounds(psw, "o" in keys)
    else:
        jse = jax_windowops.rows_frame_bounds(jsw, *bounds)
        pse = port_windowops.rows_frame_bounds(psw, *bounds)
    same(pse[0], jse[0], "start")
    same(pse[1], jse[1], "end")
    for ci, acc in ((2, "float64"), (3, "int64")):
        jc = jb.columns[ci].gather(jsw.perm)
        pc = pb.columns[ci].gather(psw.perm)
        cnt = port_windowops.frame_count(pc.validity, psw, *pse)
        same(cnt, jax_windowops.frame_count(jc.validity, jsw, *jse),
             "count")
        want = np.asarray(jax_windowops.frame_sum(
            jc.data, jc.validity, jsw, *jse, np.dtype(acc)))
        got = port_windowops.frame_sum(pc.data, pc.validity, psw, *pse,
                                       getattr(torch, acc)).numpy()
        assert got.dtype == want.dtype
        if acc == "int64":
            np.testing.assert_array_equal(got, want)
        else:
            # a frame with no valid row sums to null (its count is 0);
            # its data is the prefix's rounding noise, different in each
            # summation order, so only counted frames compare
            counted = cnt.numpy() > 0
            np.testing.assert_allclose(got[counted], want[counted],
                                       rtol=REL_TOL, atol=0)


def test_window_eval_writes_back_through_the_permutation():
    """K14's plain evaluation with perm equals the sorted-domain results
    scattered to their input rows (the reference's inverse permutation
    and take)."""
    rng = np.random.default_rng(34)
    _, pb, jsw, psw = _sorted_windows(rng, 3000, 40, 20, "po", True, True)
    from spark_rapids_tpu_torch import kernels

    reqs = [port_windowops.WinRequest(k) for k in (
        kernels.WIN_ROW_NUMBER, kernels.WIN_RANK, kernels.WIN_DENSE_RANK)]
    sorted_out = port_windowops.window_eval(psw, reqs)
    back = port_windowops.window_eval(psw, reqs, perm=psw.perm)
    inv = np.asarray(jsw.inv)
    for (ds, _), (db, vb) in zip(sorted_out, back):
        np.testing.assert_array_equal(db.numpy(), ds.numpy()[inv])
        assert bool(vb.all())


# ----------------------------------------------------------- the queries

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("window_bench_shapes"))
    write_q5_data(root, rows=20_000, stores=2000, regions=12, files=4,
                  seed=0)
    return root


def _window_query(which, fact, dim, pkg):
    if pkg == "port":
        return window_query(fact)
    w = JaxWindow.partitionBy("store").orderBy("day")
    return fact.select("store", "day", "amount",
                       JF.row_number().over(w).alias("rn"),
                       JF.rank().over(w).alias("rk"),
                       JF.dense_rank().over(w).alias("drk"),
                       JF.sum("amount").over(w).alias("run_amount"))


def assert_same_rows(got: pa.Table, want: pa.Table, keys):
    """Equal ignoring row order: both sorted by `keys` (exact columns),
    then integers exact and doubles within 1e-9 relative."""
    assert got.schema.names == want.schema.names
    order = [(k, "ascending") for k in keys]
    g = got.sort_by(order)
    w = want.sort_by(order)
    for name in want.schema.names:
        gv, wv = g.column(name).to_pylist(), w.column(name).to_pylist()
        if pa.types.is_floating(want.schema.field(name).type):
            assert gv == pytest.approx(wv, rel=REL_TOL), name
        else:
            assert gv == wv, name


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "aqe"])
def test_window_query_matches_reference(data, fused, monkeypatch):
    ref, port = run_both(data, "window", fused, monkeypatch,
                         query=_window_query)
    assert port["tree"] == ref["tree"] == [
        "TpuProjectExec", "TpuWindowExec", "TpuShuffleExchangeExec",
        "TpuCachedRelationExec"]
    assert ref["exec"]["engine"] == port["exec"]["engine"] == (
        "fused" if fused else "aqe")
    assert port["exec"]["fallbacks"] == []
    if fused:
        assert port["settled"] == ref["settled"]
    else:
        assert port["decisions"] == ref["decisions"]
    assert port["result"].num_rows == 20_000
    assert_window_rows(port["result"], ref["result"])


def _exact_run_amount(t: pa.Table):
    """Each row's sum of amount over its store's days up to its own,
    exactly rounded (math.fsum), in the order of `t`'s rows."""
    import math

    by_store = {}
    for s, d, a in zip(t.column("store").to_pylist(),
                       t.column("day").to_pylist(),
                       t.column("amount").to_pylist()):
        by_store.setdefault(s, []).append((d, a))
    totals = {}
    for s, rows in by_store.items():
        rows.sort()
        acc = []
        for d, a in rows:
            acc.append(a)
            totals[(s, d)] = math.fsum(acc)
    return [totals[(s, d)] for s, d in zip(t.column("store").to_pylist(),
                                           t.column("day").to_pylist())]


def assert_window_rows(got: pa.Table, want: pa.Table):
    """The window query's rows, ignoring row order: rk and drk depend on
    the (store, day) peer run alone and compare row for row (rows ordered
    by store, day, amount); row_number orders the rows of a peer run as
    they arrived, and the reference's adaptive engine concatenates the
    exchange's map outputs in the order its map tasks finish, so within
    each peer run the row numbers compare as a set. run_amount compares
    with the exact running sum of the peer runs (1e-9 relative): the port
    restarts its float64 prefix at each partition, where the reference
    takes differences of one whole-batch prefix and misses the exact sum
    of a small first peer run by more than that (1.4e-9 on one row of
    this data; ROADMAP C)."""
    assert got.schema.names == want.schema.names
    keys = [("store", "ascending"), ("day", "ascending"),
            ("amount", "ascending")]
    g, w = got.sort_by(keys), want.sort_by(keys)
    for name in ("store", "day", "amount", "rk", "drk"):
        assert g.column(name).to_pylist() == w.column(name).to_pylist(), \
            name
    assert g.column("run_amount").to_pylist() == pytest.approx(
        _exact_run_amount(g), rel=REL_TOL)

    def rn_sets(t):
        out = {}
        for s, d, rn in zip(t.column("store").to_pylist(),
                            t.column("day").to_pylist(),
                            t.column("rn").to_pylist()):
            out.setdefault((s, d), []).append(rn)
        return {k: sorted(v) for k, v in out.items()}

    assert rn_sets(g) == rn_sets(w)


def test_window_query_keeps_the_whole_partition_mode(data):
    """The RANGE running sum is neither "running" nor "u2u", so the
    planner keeps the whole-partition TpuWindowExec, as the reference's
    does."""
    spark = TpuSparkSession(dict(CONF, **{
        "spark.rapids.sql.fusedExec.enabled": False,
        "spark.rapids.torch.device": "cpu"}))
    fact = spark.read.parquet(os.path.join(data, "fact"))
    phys = _window_query(None, fact, None, "port")._physical()[0]
    win = phys.children[0]
    assert (win.presorted, win.halo, win.mode) == (False, None, None)


@pytest.fixture(scope="module")
def scaletest(tmp_path_factory):
    return generate_data(str(tmp_path_factory.mktemp("scaletest")),
                         scale_factor=0.05, seed=42)


def test_scaletest_q6_runs_fused_and_matches_reference(scaletest):
    """ScaleTest q6 as written (row_number over `user` ordered by `ts`)
    on the fused engine."""
    spark = JaxSession(CONF)
    try:
        want = QUERIES["q6"](spark, scaletest).collect_arrow()
        assert spark.last_execution["engine"] == "fused"
    finally:
        spark.stop()
    port = TpuSparkSession(dict(CONF, **{"spark.rapids.torch.device":
                                         "cpu"}))
    ev = port.read.parquet(scaletest["events"])
    w = PortWindow.partitionBy("user").orderBy("ts")
    got = ev.select("user", "ts",
                    PF.row_number().over(w).alias("rn")).collect_arrow()
    assert port.last_execution["engine"] == "fused"
    assert port.last_execution["fallbacks"] == []
    assert_same_rows(got, want, ["user", "ts", "rn"])


def test_scaletest_q6_on_the_adaptive_engine_raises_a11b(scaletest):
    """ScaleTest q6 as written on the adaptive engine: the planner picks
    the "running" streaming mode for row_number alone, as the reference's
    does, and the result equals the reference's (ROADMAP A11b's exit test;
    the name is from when the mode raised, before A11b was ported)."""
    conf = dict(CONF, **{"spark.rapids.sql.fusedExec.enabled": False})
    spark = JaxSession(conf)
    try:
        jdf = QUERIES["q6"](spark, scaletest)
        want = jdf.collect_arrow()
        jmode = jdf._physical()[0].children[0].mode
    finally:
        spark.stop()
    port = TpuSparkSession(dict(conf, **{"spark.rapids.torch.device":
                                         "cpu"}))
    ev = port.read.parquet(scaletest["events"])
    w = PortWindow.partitionBy("user").orderBy("ts")
    df = ev.select("user", "ts", PF.row_number().over(w).alias("rn"))
    assert df._physical()[0].children[0].mode == jmode == "running"
    got = df.collect_arrow()
    assert port.last_execution["fallbacks"] == []
    assert_same_rows(got, want, ["user", "ts", "rn"])


def _function_column(F, W, fn):
    w = W.partitionBy("store").orderBy("day")
    return {"percent_rank": lambda: F.percent_rank(),
            "cume_dist": lambda: F.cume_dist(),
            "ntile": lambda: F.ntile(3),
            "lag": lambda: F.lag("amount")}[fn]().over(w)


@pytest.mark.parametrize("fn", ["percent_rank", "cume_dist", "ntile",
                                "lag"])
def test_unported_window_functions_raise_a11b(data, fn, monkeypatch):
    """percent_rank, cume_dist, ntile and lag beside a running sum of qty
    equal the reference on the fused engine (the name is from when they
    raised, before A11b was ported). ntile, which orders the rows of a
    (store, day) peer run as they arrived, compares as a multiset within
    it."""

    def query(which, fact, dim, pkg):
        F, W = (PF, PortWindow) if pkg == "port" else (JF, JaxWindow)
        w = W.partitionBy("store").orderBy("day")
        return fact.select("store", "day", "amount",
                           _function_column(F, W, fn).alias("x"),
                           F.sum("qty").over(w).alias("s"))

    ref, port = run_both(data, fn, True, monkeypatch, query=query)
    assert port["tree"] == ref["tree"]
    assert port["exec"]["fallbacks"] == []
    keys = ["store", "day", "amount"]
    if fn == "ntile":
        assert_same_rows(port["result"].drop_columns(["x"]),
                         ref["result"].drop_columns(["x"]), keys)
        assert _peer_runs(port["result"], "x") == _peer_runs(
            ref["result"], "x")
    else:
        assert_same_rows(port["result"], ref["result"], keys)


def _peer_runs(t: pa.Table, name: str):
    out = {}
    for s, d, v in zip(t.column("store").to_pylist(),
                       t.column("day").to_pylist(),
                       t.column(name).to_pylist()):
        out.setdefault((s, d), []).append(v)
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("lower,upper", [(-3, 0), (None, 0)])
def test_range_frames_raise_a11b(data, lower, upper, monkeypatch):
    """RANGE frames over (store, day) equal the reference on the fused
    engine (the name is from when they raised, before A11b was ported):
    the sum of qty, exact in int64, and the count and maximum of amount.
    A double sum over these frames is the difference of two whole-batch
    prefixes in both packages (the reference's algorithm), and with about
    ten rows a store most frames hold one or two amounts against a prefix
    near 1e6: both packages then miss the exact sum by up to 4e-9 relative,
    in other directions (ROADMAP C). test_torch_window_modes.py compares
    double RANGE sums over frames of about a hundred rows."""

    def query(which, fact, dim, pkg):
        F, W = (PF, PortWindow) if pkg == "port" else (JF, JaxWindow)
        w = W.partitionBy("store").orderBy("day").rangeBetween(
            W.unboundedPreceding if lower is None else lower, upper)
        return fact.select("store", "day", "amount",
                           F.sum("qty").over(w).alias("s"),
                           F.count("amount").over(w).alias("c"),
                           F.max("amount").over(w).alias("m"))

    ref, port = run_both(data, "range", True, monkeypatch, query=query)
    assert port["exec"]["fallbacks"] == []
    assert_same_rows(port["result"], ref["result"],
                     ["store", "day", "amount"])


@pytest.mark.parametrize("name,item", [
    ("CollectList", "A9"), ("CollectSet", "A9"), ("Skewness", "A9"),
    ("CountDistinct", "A9")])
def test_collect_and_variance_frames_raise(data, name, item):
    """Window aggregates the port does not evaluate raise naming the
    ROADMAP item that ports them: collect frames without a lower bound
    (the reference evaluates only bounded ROWS collect frames on its
    device, K33's since slice 12; it named A3 before), and an aggregate
    the reference's window runs on its CPU engine (skewness,
    count(DISTINCT)), name A9. Variance and stddev frames ran into A12
    here until slice 8 ported them (K14's frame sums of x and x^2)."""
    from spark_rapids_tpu_torch.api.column import Column
    from spark_rapids_tpu_torch.api.functions import UnresolvedColumn
    from spark_rapids_tpu_torch.expr import aggregates as AGG

    fn = getattr(AGG, name)(UnresolvedColumn("amount"))
    port = TpuSparkSession(dict(CONF, **{"spark.rapids.torch.device":
                                         "cpu"}))
    fact = port.read.parquet(os.path.join(data, "fact"))
    w = PortWindow.partitionBy("store").orderBy("day").rowsBetween(
        PortWindow.unboundedPreceding if name.startswith("Collect") else -2,
        0)
    df = fact.select("store", Column(fn).over(w).alias("x"))
    with pytest.raises(NotImplementedError, match=item):
        df.collect_arrow()
