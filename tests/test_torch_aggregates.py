"""The statistical, bool, positional, distinct and percentile aggregates of
the port against the JAX package.

Function by function, on the same seeded numpy inputs: K4's multi-sum
(k = 5, 8 and a split set of 11) against the reference's
`seg_multi_sum`; K26 through CollectList/CollectSet update and merge
against the reference's (`_seg_exclusive_ranks`, the scatter, the set's
NaN-aware duplicate test); K25 through ApproxPercentile update and merge
and Percentile.evaluate against the reference's.

Then through the two sessions: every new aggregate in a group-by over a
table holding nulls, NaN, +-inf, -0.0, a one-row group and an all-null
group, with batches of 512 rows (1,024 for the distinct query: partial
aggregates merged, and with three files a hash exchange between partial
and final), written as one
file and as three, on the port's adaptive engine and its fused one, each
against the reference's adaptive answer computed once a table and query.
The physical trees and engine choices equal the reference's, the fused
engine falls back for count(DISTINCT), sum(DISTINCT) and percentile, and
the aggregate pushdown skips a group-by first() over a lookup join.

Tolerances: counts, bool_and/or, first/last/any_value, count(DISTINCT)
and the values percentile and percentile_approx select are exact;
percentile's interpolation within 1e-12 relative; sums of distinct
values within 1e-9 relative. The moment and bivariate results are sums of
powers with cancellation (skewness's m3 = s3 - 3 mu s2 + 2 mu^2 s1 is
near 0 on a symmetric distribution), so they are held to 1e-9 of the size
of their terms, not of the result: |d| <= 1e-9 * T with T the formula
evaluated on the terms' absolute values (`_term_scale`). A group holding
NaN or an infinity gives NaN or an infinity on both sides.
"""

import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.plan import aqe as jax_aqe
from spark_rapids_tpu.columnar.batch import DeviceColumn as JCol
from spark_rapids_tpu.expr import aggregates as JA
from spark_rapids_tpu.exec import agg_pushdown as jax_pushdown
from spark_rapids_tpu.ops import segmented as jax_segmented
from spark_rapids_tpu.sqltypes import datatypes as JT
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn as PCol
from spark_rapids_tpu_torch.exec import agg_pushdown as port_pushdown
from spark_rapids_tpu_torch.expr import aggregates as PA
from spark_rapids_tpu_torch.expr.core import BoundReference as PRef
from spark_rapids_tpu_torch.ops import segmented as port_segmented
from spark_rapids_tpu_torch.sqltypes import datatypes as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERM_TOL = 1e-9
SUM_REL = 1e-9
INTERP_REL = 1e-12


def _bench_conf():
    spec = importlib.util.spec_from_file_location(
        "srtpu_bench_aggs", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._session_conf()


CONF = dict(_bench_conf(), **{
    "spark.rapids.sql.format.parquet.reader.type": "PERFILE",
    "spark.rapids.sql.batchSizeRows": 512,
    "spark.rapids.sql.reader.batchSizeRows": 512,
    "spark.sql.shuffle.partitions": 3,
    # the fused engine's partials at 1,024 groups, not 65,536: the plain
    # versions pay for every buffer row
    "spark.rapids.sql.fusedExec.groupCapacity": 1024})
#: the distinct query's batches: the reference runs its non-jittable
#: phases op by op, so fewer batches keep its run short
DISTINCT_BATCH = {"spark.rapids.sql.batchSizeRows": 1024,
                  "spark.rapids.sql.reader.batchSizeRows": 1024}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain versions on one thread (beside the other xdist
    workers, torch's intra-op threads oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ------------------------------------------------------- function level


@pytest.mark.parametrize("k", [5, 8, 11])
def test_seg_multi_sum_matches_reference(k):
    """K4 with k value vectors (a set of 11 takes launches of 8 and 3)
    against the reference's seg_multi_sum: counts exact, float64 sums
    within 1e-12 relative."""
    rng = np.random.default_rng(k)
    n, cap = 3000, 64
    gid = np.sort(rng.integers(0, 50, n)).astype(np.int32)
    valid = rng.random(n) > 0.2
    vals = [rng.normal(size=n) * 10.0 ** j for j in range(k)]
    jc, js = jax_segmented.seg_multi_sum([jnp.asarray(v) for v in vals],
                                         jnp.asarray(valid),
                                         jnp.asarray(gid), cap)
    red = port_segmented.seg_sum_count_multi([t(v) for v in vals], t(valid),
                                             t(gid), cap)
    pc, ps = red.count, red.sums
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert len(ps) == k
    for p, j in zip(ps, js):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-300)


class BoundRef:
    """A stand-in child for the reference's aggregates: only its dtype is
    read."""

    def __init__(self, dtype):
        self.dtype = dtype

    def key(self):
        return ("ref", str(self.dtype))


_ELEM_CASES = {
    "int64": (JT.long, PT.long, lambda r, n: r.integers(0, 40, n)),
    "int32": (JT.integer, PT.integer,
              lambda r, n: r.integers(-5, 5, n).astype(np.int32)),
    "float64": (JT.double, PT.double, lambda r, n: r.choice(np.array(
        [0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, 2.5, -3.0]), n)),
    "bool": (JT.boolean, PT.boolean, lambda r, n: r.random(n) > 0.5),
}


def _collect_inputs(case, seed, n=700, groups=23):
    rng = np.random.default_rng(seed)
    jt, pt, draw = _ELEM_CASES[case]
    vals = np.asarray(draw(rng, n))
    valid = rng.random(n) > 0.15
    live = np.arange(n) < n - 9
    gid = np.sort(rng.integers(0, groups, n)).astype(np.int32)
    return jt, pt, vals, valid, live, gid


def _array_equal(pcol, jcol, sort_rows=False):
    """Two array buffers equal: lengths and element validity exact, the
    elements exact where valid (NaN equal to NaN; a set's rows compared
    as sorted multisets)."""
    lens = np.asarray(jcol.lengths)
    np.testing.assert_array_equal(pcol.lengths.numpy(), lens)
    np.testing.assert_array_equal(pcol.elem_validity.numpy(),
                                  np.asarray(jcol.elem_validity))
    pd, jd = pcol.data.numpy(), np.asarray(jcol.data)
    assert pd.shape == jd.shape
    for r in range(pd.shape[0]):
        a, b = pd[r, :lens[r]], jd[r, :lens[r]]
        if sort_rows:
            a, b = np.sort(a), np.sort(b)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(_ELEM_CASES))
@pytest.mark.parametrize("fn", ["collect_list", "collect_set"])
def test_collect_update_and_merge_match_reference(fn, case):
    """K26 (ranks, the set's duplicate test, the scatter) through
    CollectList / CollectSet update, then a merge of two partials'
    buffers, against the reference's."""
    jt, pt, vals, valid, live, gid = _collect_inputs(case, 11)
    cap = 1024
    jfn = {"collect_list": JA.CollectList,
           "collect_set": JA.CollectSet}[fn](None)
    pfn = {"collect_list": PA.CollectList,
           "collect_set": PA.CollectSet}[fn](None)
    jin = JCol(jt, jnp.asarray(vals), jnp.asarray(valid))
    pin = PCol(pt, t(vals), t(valid))
    jb = jfn.update(jin, jnp.asarray(live), jnp.asarray(gid), cap)[0]
    pb = pfn.update(pin, t(live), t(gid), cap)[0]
    _array_equal(pb, jb, sort_rows=True)
    # merge: the first 12 group rows twice, as two partials
    rows = 24
    mgid = np.repeat(np.arange(12, dtype=np.int32), 2)
    take = np.tile(np.arange(12), 2).reshape(2, 12).T.reshape(rows)
    mlive = np.arange(rows) != 5
    jbuf = JCol(jb.dtype, jb.data[take], jnp.ones(rows, bool),
                jb.lengths[take], jb.elem_validity[take])
    pbuf = PCol(pb.dtype, pb.data[t(take)], torch.ones(rows, dtype=bool),
                pb.lengths[t(take)], elem_validity=pb.elem_validity[t(take)])
    jm = jfn.merge([jbuf], jnp.asarray(mlive), jnp.asarray(mgid), 64)[0]
    pm = pfn.merge([pbuf], t(mlive), t(mgid), 64)[0]
    _array_equal(pm, jm, sort_rows=True)


@pytest.mark.parametrize("case", ["int64", "int32", "float64"])
def test_count_sum_distinct_and_percentile_evaluate_match_reference(case):
    """count(DISTINCT) and sum(DISTINCT) of set buffers, and percentile of
    list buffers (K9's row sort, K25's interpolation), against the
    reference's evaluate."""
    jt, pt, vals, valid, live, gid = _collect_inputs(case, 12)
    cap = 1024
    jin = JCol(jt, jnp.asarray(vals), jnp.asarray(valid))
    pin = PCol(pt, t(vals), t(valid))
    for jcls, pcls in ((JA.CountDistinct, PA.CountDistinct),
                       (JA.SumDistinct, PA.SumDistinct)):
        jfn, pfn = jcls(BoundRef(jt)), pcls(PRef(0, pt))
        jr = jfn.evaluate(jfn.update(jin, jnp.asarray(live),
                                     jnp.asarray(gid), cap))
        pr = pfn.evaluate(pfn.update(pin, t(live), t(gid), cap))
        np.testing.assert_array_equal(pr.validity.numpy(),
                                      np.asarray(jr.validity))
        ok = np.asarray(jr.validity)
        np.testing.assert_allclose(pr.data.numpy()[ok],
                                   np.asarray(jr.data)[ok], rtol=SUM_REL)
    for p in (0.0, 0.25, 0.5, 0.9, 1.0):
        jfn, pfn = JA.Percentile(BoundRef(jt), p), PA.Percentile(
            PRef(0, pt), p)
        jr = jfn.evaluate(jfn.update(jin, jnp.asarray(live),
                                     jnp.asarray(gid), cap))
        pr = pfn.evaluate(pfn.update(pin, t(live), t(gid), cap))
        ok = np.asarray(jr.validity)
        np.testing.assert_array_equal(pr.validity.numpy(), ok)
        np.testing.assert_allclose(pr.data.numpy()[ok],
                                   np.asarray(jr.data)[ok],
                                   rtol=INTERP_REL, equal_nan=True)


@pytest.mark.parametrize("accuracy", [16, 10000])
def test_approx_percentile_update_and_merge_match_reference(accuracy):
    """K25's selection through ApproxPercentile update (unit weights: the
    reference's arithmetic exactly) and merge (weights n/K, which K25 sums
    as integers on the scale of K): every point equal to the
    reference's."""
    rng = np.random.default_rng(accuracy)
    n, cap = 3000, 1024
    vals = rng.lognormal(0.0, 1.5, n)
    vals[rng.random(n) < 0.01] = np.nan
    valid = rng.random(n) > 0.1
    live = np.arange(n) < n - 17
    gid = rng.integers(0, 30, n).astype(np.int32)  # unsorted, as binned
    jfn = JA.ApproxPercentile(BoundRef(JT.double), 0.9, accuracy)
    pfn = PA.ApproxPercentile(PRef(0, PT.double), 0.9, accuracy)
    K = jfn.K
    jin = JCol(JT.double, jnp.asarray(vals), jnp.asarray(valid))
    pin = PCol(PT.double, t(vals), t(valid))
    jb = jfn.update(jin, jnp.asarray(live), jnp.asarray(gid), cap)
    pb = pfn.update(pin, t(live), t(gid), cap)

    def same(pcols, jcols):
        ok = np.asarray(jcols[K].data) > 0
        np.testing.assert_array_equal(pcols[K].data.numpy(),
                                      np.asarray(jcols[K].data))
        for j in range(K):
            np.testing.assert_array_equal(pcols[j].validity.numpy(), ok)
            np.testing.assert_array_equal(pcols[j].data.numpy()[ok],
                                          np.asarray(jcols[j].data)[ok])

    same(pb, jb)
    # merge: three partials of the first 30 groups, one row dead
    rows = 90
    take = np.tile(np.arange(30), 3)
    mgid = np.sort(np.arange(rows) % 30).astype(np.int32)
    order = np.argsort(np.arange(rows) % 30, kind="stable")
    take = take[order]
    mlive = np.arange(rows) != 7
    jbufs = [JCol(c.dtype, c.data[take], c.validity[take]) for c in jb]
    pbufs = [PCol(c.dtype, c.data[t(take)], c.validity[t(take)])
             for c in pb]
    jm = jfn.merge(jbufs, jnp.asarray(mlive), jnp.asarray(mgid), rows)
    pm = pfn.merge(pbufs, t(mlive), t(mgid), rows)
    same(pm, jm)
    jr, pr = jfn.evaluate(jm), pfn.evaluate(pm)
    ok = np.asarray(jr.validity)
    np.testing.assert_array_equal(pr.validity.numpy(), ok)
    np.testing.assert_array_equal(pr.data.numpy()[ok],
                                  np.asarray(jr.data)[ok])


# --------------------------------------------------------- the sessions

#: special groups: one row, every value null, NaN, +-inf, -0.0 and 0.0
ONE, ALL_NULL, WITH_NAN, WITH_INF, ZEROS = 100, 101, 102, 103, 104


def _table(seed=5, n=2400):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 30, n)
    x = rng.normal(5000.0, 1000.0, n)
    y = rng.normal(0.0, 50.0, n) + 0.01 * x
    c = rng.integers(0, 60, n)
    b = rng.random(n) > 0.1
    null_x = rng.random(n) < 0.1
    null_y = rng.random(n) < 0.1
    null_c = rng.random(n) < 0.05
    null_b = rng.random(n) < 0.05
    # the special groups take the last rows
    k[-1] = ONE
    k[-6:-1] = ALL_NULL
    null_x[-6:-1] = null_c[-6:-1] = null_b[-6:-1] = True
    k[-12:-6] = WITH_NAN
    x[-12] = np.nan
    k[-18:-12] = WITH_INF
    x[-18], x[-17] = np.inf, -np.inf
    k[-26:-18] = ZEROS
    x[-26:-18] = [0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 1.0, 2.0]
    null_x[-26:-18] = False
    return pa.table({
        "k": pa.array(k),
        "x": pa.array(x, mask=null_x),
        "y": pa.array(y, mask=null_y),
        "c": pa.array(c, mask=null_c),
        "b": pa.array(b, mask=null_b)})


#: query -> [(output name, its builder over the functions module F)]
def _jittable_aggs(F):
    return [
        ("var_samp", F.var_samp("x")), ("var_pop", F.var_pop("x")),
        ("stddev", F.stddev("x")), ("stddev_pop", F.stddev_pop("x")),
        ("skewness", F.skewness("x")), ("kurtosis", F.kurtosis("x")),
        ("var_int", F.variance("c")),
        ("covar_pop", F.covar_pop("x", "y")),
        ("covar_samp", F.covar_samp("x", "y")),
        ("corr", F.corr("x", "y")),
        ("bool_and", F.bool_and("b")), ("bool_or", F.bool_or("b")),
        ("first", F.first("x")), ("last", F.last("x")),
        ("first_valid", F.first("x", ignorenulls=True)),
        ("last_valid", F.last("x", ignorenulls=True)),
        ("any_value", F.any_value("c")),
        ("p50", F.percentile_approx("x", 0.5)),
        ("p90_k16", F.percentile_approx("x", 0.9, 16)),
    ]


def _distinct_aggs(F):
    return [
        ("n", F.count("*")),
        ("distinct_c", F.countDistinct("c")),
        ("distinct_x", F.countDistinct("x")),
        ("approx_distinct", F.approx_count_distinct("c")),
        ("sum_distinct_c", F.sumDistinct("c")),
        ("sum_distinct_x", F.sumDistinct("x")),
        ("median", F.percentile("x", 0.5)),
        ("q25_c", F.percentile("c", 0.25)),
    ]


def _approx_aggs(F):
    return [("p50", F.percentile_approx("x", 0.5)),
            ("p90_k16", F.percentile_approx("x", 0.9, 16))]


QUERIES = {"jittable": _jittable_aggs, "distinct": _distinct_aggs,
           "approx": _approx_aggs}
#: percentile_approx's points depend on where partials are cut: the fused
#: engine's answer is held to the reference's fused engine (the approx
#: query alone, the same partial structure)
APPROX = {"p50", "p90_k16"}
#: aggregates whose value depends on row order within a group: exact with
#: one file, a value of the group with several (the reference's exchange
#: commits map outputs in the order its tasks finish)
ORDERED = {"first", "last", "first_valid", "last_valid", "any_value"}
MOMENTS = {"var_samp", "var_pop", "stddev", "stddev_pop", "skewness",
           "kurtosis", "var_int", "covar_pop", "covar_samp", "corr"}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The table written as one file and as three."""
    root = tmp_path_factory.mktemp("stat_aggs")
    table = _table()
    out = {}
    for files in (1, 3):
        d = root / f"files{files}"
        d.mkdir()
        per = -(-table.num_rows // files)
        for i in range(files):
            pq.write_table(table.slice(i * per, per),
                           str(d / f"part-{i}.parquet"))
        out[files] = str(d)
    return table, out


def _build(pkg, query, df):
    F = JF if pkg == "jax" else PF
    aggs = [col.alias(name) for name, col in QUERIES[query](F)]
    return df.groupBy("k").agg(*aggs)


def _run(pkg, query, path, fused):
    """(answer, last_execution, physical tree)."""
    conf = dict(CONF, **(DISTINCT_BATCH if query == "distinct" else {}),
                **{"spark.rapids.sql.fusedExec.enabled": fused})
    if pkg == "jax":
        spark = JaxSession(conf)
    else:
        spark = TpuSparkSession(dict(conf, **{
            "spark.rapids.torch.device": "cpu"}))
    try:
        df = spark.read.parquet(path)
        if fused:
            df = df.cache(storage="device")
        q = _build(pkg, query, df)
        out, rec = _collect_recording_aqe(pkg, spark, q)
        return out, rec, _tree(q._physical()[0])
    finally:
        spark.stop()


def _collect_recording_aqe(pkg, spark, q):
    """Collect q; the last_execution record, with the reference's adaptive
    decisions (its session does not record them) under "aqe"."""
    if pkg != "jax":
        return q.collect_arrow(), dict(spark.last_execution or {})
    decisions = []
    orig = jax_aqe.AdaptiveQueryExecutor.execute

    def spy(self, phys):
        out = orig(self, phys)
        decisions.extend(self.decisions)
        return out

    jax_aqe.AdaptiveQueryExecutor.execute = spy
    try:
        out = q.collect_arrow()
    finally:
        jax_aqe.AdaptiveQueryExecutor.execute = orig
    rec = dict(spark.last_execution or {})
    rec["aqe"] = decisions if rec.get("engine") == "aqe" else None
    return out, rec


def _tree(node, depth=0):
    name = type(node).__name__
    rows = [] if name == "TpuCoalesceBatchesExec" else [(depth, name)]
    for c in node.children:
        rows += _tree(c, depth + (name != "TpuCoalesceBatchesExec"))
    return rows


@pytest.fixture(scope="module")
def runs(tables):
    """Each (query, files) answer of the reference (adaptive engine, fused
    off) and of the port on both engines, computed once."""
    _, paths = tables
    cache = {}

    def get(query, files, who):
        key = (query, files, who)
        if key not in cache:
            pkg, fused = {"ref": ("jax", False), "ref_fused": ("jax", True),
                          "aqe": ("torch", False),
                          "fused": ("torch", True)}[who]
            cache[key] = _run(pkg, query, paths[files], fused)
        return cache[key]

    return get


def _by_key(table):
    rows = table.to_pylist()
    return {r["k"]: r for r in rows}


def _term_scale(name, vals_x, vals_y):
    """1e-9's multiplier for a moment result: the result's formula over
    the absolute values of its terms (Σ|x|^p and n), so that a result near
    0 after cancellation is held to the size of what cancelled."""
    ok = ~np.isnan(vals_x)
    if vals_y is not None:
        ok &= ~np.isnan(vals_y)
    x = vals_x[ok]
    n = float(len(x))
    if n == 0:
        return 0.0
    if not np.isfinite(x).all() or (
            vals_y is not None and not np.isfinite(vals_y[ok]).all()):
        return math.inf  # the result is NaN or an infinity on both sides
    s = [math.fsum(np.abs(x) ** p) for p in range(5)]
    mu = s[1] / n
    m2 = abs(math.fsum(x * x) - math.fsum(x) ** 2 / n)
    if m2 == 0.0 and name in ("skewness", "kurtosis", "corr"):
        return math.inf  # null on both sides (m2 = 0)
    if name in ("var_samp", "var_pop", "stddev", "stddev_pop", "var_int"):
        return (s[2] + s[1] * mu) / max(n - 1.0, 1.0)
    if name == "skewness":
        return (s[3] + 3 * mu * s[2] + 2 * mu * mu * s[1]) / m2 ** 1.5 \
            * math.sqrt(n)
    if name == "kurtosis":
        return (s[4] + 4 * mu * s[3] + 6 * mu * mu * s[2]
                + 3 * mu ** 3 * s[1]) / (m2 * m2) * n
    y = vals_y[ok]
    sy = math.fsum(np.abs(y))
    sxy = math.fsum(np.abs(x * y))
    cov = sxy + s[1] * sy / n
    if name == "corr":
        vy = abs(math.fsum(y * y) - math.fsum(y) ** 2 / n)
        return cov / math.sqrt(m2 * vy) if vy > 0.0 else math.inf
    return cov / max(n - 1.0, 1.0)


def _check(name, got, want, scale):
    """One aggregate's value, as the module docstring states."""
    if want is None or got is None:
        assert got is None and want is None, (name, got, want)
        return
    if isinstance(want, float) and (math.isnan(want) or math.isinf(want)):
        assert (math.isnan(got) and math.isnan(want)) or got == want, (
            name, got, want)
        return
    if name in MOMENTS:
        d = abs(got - want)
        if name.startswith("stddev"):
            d = abs(got * got - want * want)
        assert d <= TERM_TOL * scale, (name, got, want, scale)
    elif name.startswith("sum_distinct"):
        assert abs(got - want) <= SUM_REL * abs(want), (name, got, want)
    elif name in ("median", "q25_c"):
        assert abs(got - want) <= INTERP_REL * abs(want), (name, got, want)
    else:
        assert got == want, (name, got, want)


def _cases():
    out = []
    for query, aggs in QUERIES.items():
        if query == "approx":
            continue
        for name, _ in aggs(PF):
            for files in (1, 3):
                for engine in ("aqe", "fused"):
                    out.append((query, name, files, engine))
    return out


@pytest.mark.parametrize("query,name,files,engine", _cases())
def test_aggregate_matches_reference(query, name, files, engine, runs,
                                     tables):
    """One aggregate of a query, every group, on one engine at one file
    count, against the reference's answer."""
    table, _ = tables
    if name in APPROX and engine == "fused":
        want = _by_key(runs("approx", files, "ref_fused")[0])
    else:
        want = _by_key(runs(query, files, "ref")[0])
    got = _by_key(runs(query, files, engine)[0])
    assert sorted(got) == sorted(want)
    keys = np.asarray(table.column("k"))
    xs = table.column("x").to_numpy(zero_copy_only=False).astype(float)
    ys = table.column("y").to_numpy(zero_copy_only=False).astype(float)
    cs = table.column("c").to_numpy(zero_copy_only=False).astype(float)
    for key, row in want.items():
        sel = keys == key
        g, w = got[key][name], row[name]
        if name in ORDERED and files > 1:
            col = table.column("c" if name == "any_value" else "x").filter(
                pa.array(sel)).to_pylist()
            valid = [v for v in col if v is not None]
            if name.endswith("valid") or name == "any_value":
                assert (g is None) == (w is None) == (not valid)
            assert g is None or any(
                v == g or (math.isnan(v) and math.isnan(g)) for v in valid), (
                name, key, g)
            continue
        scale = 0.0
        if name in MOMENTS:
            vx = (cs if name == "var_int" else xs)[sel]
            vy = ys[sel] if name.startswith(("cov", "corr")) else None
            scale = _term_scale(name, vx, vy)
        _check(name, g, w, scale)


@pytest.mark.parametrize("query", ["distinct", "jittable"])
@pytest.mark.parametrize("files", [1, 3])
def test_plans_and_engines_match_reference(query, files, runs):
    """The port's physical tree over the files and its adaptive
    decisions are the reference's, and each engine runs what the
    reference's runs: the fused engine the
    jittable query, the adaptive engine (or, over one file, the eager one)
    the distinct query, recording the fused engine's fallback."""
    _, ref_exec, ref_tree = runs(query, files, "ref")
    for engine in ("aqe", "fused"):
        _, ex, tree = runs(query, files, engine)
        if engine == "aqe":
            assert tree == ref_tree
            assert ex["engine"] == ref_exec["engine"]
            assert not ex["fallbacks"]
            # the coalescing reads block bytes, which the eager path's
            # buffer rows (sized to the group count) change: the
            # decisions still match
            assert ex["aqe"] == ref_exec["aqe"]
        elif query == "jittable":
            assert ex["engine"] == "fused" and not ex["fallbacks"]
        else:
            (eng, reason), = ex["fallbacks"]
            assert eng == "fused" and "no fused lowering" in reason
            assert ex["fused"] == {"fallback": reason}


@pytest.mark.parametrize("query", ["distinct", "jittable"])
def test_fused_fallback_matches_reference(query, tables):
    """Over relations cached on the device, the reference's fused engine
    refuses the plan holding count(DISTINCT), sum(DISTINCT) and
    percentile (its session then runs the adaptive engine) and takes the
    jittable one, as the port's does: both validators, which compile
    nothing, decide the same."""
    from spark_rapids_tpu.exec import fused as jax_fused
    from spark_rapids_tpu_torch.exec import fused as port_fused

    _, paths = tables
    refused = []
    for pkg, fused_mod in (("jax", jax_fused), ("torch", port_fused)):
        conf = dict(CONF, **{"spark.rapids.sql.fusedExec.enabled": True})
        spark = (JaxSession(conf) if pkg == "jax" else TpuSparkSession(
            dict(conf, **{"spark.rapids.torch.device": "cpu"})))
        try:
            df = spark.read.parquet(paths[3]).cache(storage="device")
            phys = _build(pkg, query, df)._physical()[0]
            ex = fused_mod.FusedSingleChipExecutor(spark.rapids_conf)
            try:
                ex._validate(phys)
                refused.append(False)
            except fused_mod.FusedCompileError:
                refused.append(True)
        finally:
            spark.stop()
    assert refused == [query == "distinct"] * 2


@pytest.mark.parametrize("fused", [False, True])
def test_global_aggregates_over_empty_input_match_reference(tmp_path, fused):
    """A global aggregate over a 0-row parquet file: count and
    count(DISTINCT) 0, every other new aggregate null, as the reference's
    `_empty_global_result` gives them (the fused engine falls back for
    count(DISTINCT) and percentile)."""
    pq.write_table(pa.table({"x": pa.array([], pa.float64()),
                             "c": pa.array([], pa.int64())}),
                   str(tmp_path / "empty.parquet"))
    out = []
    for pkg, F in (("jax", JF), ("torch", PF)):
        conf = dict(CONF, **{"spark.rapids.sql.fusedExec.enabled": False})
        spark = (JaxSession(conf) if pkg == "jax" else TpuSparkSession(
            dict(conf, **{"spark.rapids.torch.device": "cpu",
                          "spark.rapids.sql.fusedExec.enabled": fused})))
        try:
            out.append(spark.read.parquet(str(tmp_path)).agg(
                F.countDistinct("c").alias("dc"), F.count("x").alias("n"),
                F.var_samp("x").alias("v"), F.corr("x", "c").alias("r"),
                F.percentile("x", 0.5).alias("p"),
                F.sumDistinct("c").alias("sd"),
                F.bool_or(F.col("x") > 1.0).alias("bo")).collect_arrow())
        finally:
            spark.stop()
    want, got = out
    assert got.to_pylist() == want.to_pylist() == [
        {"dc": 0, "n": 0, "v": None, "r": None, "p": None, "sd": None,
         "bo": None}]


def _chain_below(agg):
    """The fused engine's chain ending at an aggregate: the per-partition
    nodes under it, bottom-up (what exec/fused.py hands rewrite_chain)."""
    nodes, cur = [agg], agg.children[0]
    while type(cur).__name__ in ("TpuProjectExec", "TpuFilterExec",
                                 "TpuBroadcastHashJoinExec"):
        nodes.append(cur)
        cur = cur.children[0]
    return list(reversed(nodes))


def _first_agg(node):
    if type(node).__name__ == "TpuHashAggregateExec" and node.mode in (
            "partial", "complete"):
        return node
    for c in node.children:
        a = _first_agg(c)
        if a is not None:
            return a
    return None


@pytest.mark.parametrize("agg", ["sum", "first", "countDistinct",
                                 "stddev"])
def test_pushdown_gate_matches_reference(tmp_path, agg):
    """The aggregate pushdown through a lookup join takes sum and stddev
    and skips first() (order-sensitive) and count(DISTINCT) (not
    jittable), in both packages."""
    rng = np.random.default_rng(9)
    pq.write_table(pa.table({"store": pa.array(rng.integers(0, 20, 500)),
                             "amount": pa.array(rng.random(500))}),
                   str(tmp_path / "fact.parquet"))
    dim = tmp_path / "dim"
    dim.mkdir()
    pq.write_table(pa.table({"store": pa.array(np.arange(20)),
                             "region": pa.array(np.arange(20) % 4)}),
                   str(dim / "dim.parquet"))
    pushed = []
    for pkg, F, push in (("jax", JF, jax_pushdown), ("torch", PF,
                                                     port_pushdown)):
        spark = (JaxSession(dict(CONF)) if pkg == "jax" else TpuSparkSession(
            dict(CONF, **{"spark.rapids.torch.device": "cpu"})))
        try:
            fact = spark.read.parquet(str(tmp_path / "fact.parquet"))
            d = spark.read.parquet(str(dim))
            q = (fact.join(d, on="store", how="inner").groupBy("region")
                 .agg(getattr(F, agg)("amount").alias("a")))
            node = _first_agg(q._physical()[0])
            pushed.append(push.rewrite_chain(_chain_below(node)) is not None)
        finally:
            spark.stop()
    assert pushed[0] == pushed[1] == (agg in ("sum", "stddev"))


@pytest.mark.parametrize("agg,item", [
    ("collect_list", "A9"), ("collect_set", "A9"),
    ("countDistinct", "A9"), ("var_samp", "numeric input")])
def test_unported_aggregates_are_refused(tmp_path, agg, item):
    """collect_list, collect_set and count(DISTINCT) of a string name A9
    (the reference runs them on its CPU engine; collect results of a
    number run since slice 12, and named A3 before); a moment of a string
    needs numeric input, as the reference's check says."""
    pq.write_table(pa.table({"k": [1, 1, 2], "s": ["a", "b", "a"]}),
                   str(tmp_path / "t.parquet"))
    spark = TpuSparkSession({"spark.rapids.torch.device": "cpu"})
    try:
        q = spark.read.parquet(str(tmp_path)).groupBy("k").agg(
            getattr(PF, agg)("s").alias("a"))
        with pytest.raises(NotImplementedError, match=item):
            q.collect_arrow()
    finally:
        spark.stop()
