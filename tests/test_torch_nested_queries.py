"""The slice's four nested queries through the port's and the JAX
package's sessions.

q5.py's nested_explode_query (posexplode of each order's quantities,
summed and counted by status and position: K3's gather maps and K8's
element gather), nested_item_stats_query (size, array_max, array_contains
over the array<string> cube, element_at of sort_array through K35,
array_distinct and filter through K34, a map lookup and map_contains_key,
summed by the struct field o_info.priority), customer_order_lists_query
(collect_list and collect_set as results, sort_array and a struct of
each customer) and recent_orders_window_query (collect_list over 3 and
collect_set over 6 ROWS of each customer's orders through K33) run over a
small NESTED_ORDERS (`write_nested_orders`) on the port's adaptive engine
(parquet) and fused engine (the relation cached on the device), each
equal to the reference's session (adaptive engine): counts, sizes, maxima
and orders exactly, double sums within 1e-9 relative (their order of
addition differs), lists compared as multisets where Spark leaves their
order open (collect results, collect_set frames) and in frame order
where it does not (collect_list frames). Each run reaches the plain
versions of the kernels the card would launch.
"""

import math

import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.api.window import Window as PWindow
from spark_rapids_tpu_torch.expr import collections as port_cx
from spark_rapids_tpu_torch.ops import joinops as port_joinops
from spark_rapids_tpu_torch.ops import windowops as port_w
from spark_rapids_tpu_torch.q5 import (
    customer_order_lists_query,
    nested_explode_query,
    nested_item_stats_query,
    recent_orders_window_query,
    write_nested_orders,
)

CONF = {"spark.sql.shuffle.partitions": 2,
        "spark.rapids.sql.batchSizeRows": 1024}

#: query -> (builder over (DataFrame, F, Window), the wrappers it must
#: reach, the list columns compared as multisets)
QUERIES = {
    "nested_explode": (lambda df, F, W: nested_explode_query(df, F),
                       {"expand_gather_maps"}, ()),
    "nested_item_stats": (lambda df, F, W: nested_item_stats_query(df, F),
                          {"array_compact", "array_distinct", "array_sort"},
                          ()),
    "customer_order_lists": (
        lambda df, F, W: customer_order_lists_query(df, F),
        {"array_sort"}, ("order_keys",)),
    "recent_orders_window": (
        lambda df, F, W: recent_orders_window_query(df, F, W),
        {"frame_collect"}, ("recent_years",)),
}
#: collect results hand the fused run to the adaptive engine, as the
#: reference's fused engine does
FUSED_ENGINE = {q: "fused" for q in QUERIES}
FUSED_ENGINE["customer_order_lists"] = "aqe"


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
    root = str(tmp_path_factory.mktemp("nested_queries"))
    write_nested_orders(root, 1500, 6000, files=2, seed=4)
    return root + "/nested_orders"


def _rows(table, multisets):
    """Rows in a canonical order; the multiset list columns sorted."""
    out = []
    for r in table.to_pylist():
        out.append({k: (sorted(v) if k in multisets and v is not None
                        else v) for k, v in r.items()})
    return sorted(out, key=lambda r: repr([r[k] for k in sorted(r)
                                           if not isinstance(r[k], float)]))


def _run(pkg, which, path, fused):
    conf = dict(CONF, **{"spark.rapids.sql.fusedExec.enabled": fused})
    if pkg == "jax":
        spark, F, W = JaxSession(conf), JF, JWindow
    else:
        spark = TpuSparkSession(dict(conf, **{
            "spark.rapids.torch.device": "cpu"}))
        F, W = PF, PWindow
    try:
        df = spark.read.parquet(path)
        if fused:
            df = df.cache(storage="device")
        out = QUERIES[which][0](df, F, W).collect_arrow()
        return out, dict(spark.last_execution)
    finally:
        spark.stop()


@pytest.fixture(scope="module")
def reference(data):
    """Each query's answer in the reference's session (adaptive engine),
    computed once."""
    cache = {}

    def get(which):
        if which not in cache:
            cache[which] = _run("jax", which, data, False)[0]
        return cache[which]
    return get


@pytest.fixture
def reached(monkeypatch):
    """The K3, K33, K34 and K35 wrappers each run calls (on the CPU they
    run their plain versions)."""
    seen = set()
    for mod, name in ((port_joinops, "expand_gather_maps"),
                      (port_w, "frame_collect"),
                      (port_cx, "array_compact"),
                      (port_cx, "array_distinct"),
                      (port_cx, "array_sort")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _tag=name, **k):
            seen.add(_tag)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return seen


def _same(got, want, path="") -> None:
    """Equal, doubles within 1e-9 relative."""
    if isinstance(want, float):
        assert isinstance(got, float) and math.isclose(
            got, want, rel_tol=1e-9), (path, got, want)
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("fused", [False, True], ids=["aqe", "fused"])
@pytest.mark.parametrize("which", sorted(QUERIES))
def test_nested_query_matches_reference(data, reference, reached, which,
                                        fused):
    """The reference's rows with its Arrow types, on both engines."""
    want = reference(which)
    got, ex = _run("port", which, data, fused)
    if fused:
        assert ex["engine"] == FUSED_ENGINE[which], ex
    else:
        assert ex["engine"] != "fused", ex
    assert QUERIES[which][1] <= reached, reached
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows > 0
    multisets = QUERIES[which][2]
    _same(_rows(got, multisets), _rows(want, multisets))
