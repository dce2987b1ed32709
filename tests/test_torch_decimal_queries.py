"""The slice's three decimal queries through the port's and the JAX
package's sessions.

q5.py's lineitem_q1_query (TPC-H q1 over decimal(15,2) LINEITEM columns:
wide sums of narrow inputs through K32, the decimal(32,4) products of
price and 1 - discount through K31, the decimal(19,6) averages),
orders_tbl_decimal_query (a .tbl load: text -> decimal(15,2) through K22's
decimal mode, a decimal literal filter, the wide sum and average, min and
max, the decimals as text through K24's decimal modes, ordered by the wide
revenue through K9's limb keys) and q22_decimal_query (TPC-H q22 over a
decimal c_acctbal: the wide average carried through the crossJoin's
nested-loop join and compared as decimal(38,6) limbs) run over
`write_decimal_data`'s, `write_customer_data`'s and `write_orders_dated`'s
tables at a few hundred rows on the port's adaptive engine (parquet) and
fused engine (relations cached on the device), each exactly equal to the
reference's session (adaptive engine) with the same physical tree, and
each reaching the plain versions of K31 and K32 where the card would
launch them.
"""

import os

import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.ops import decimal128 as port_d128
from spark_rapids_tpu_torch.ops import stringcast as port_stringcast
from spark_rapids_tpu_torch.q5 import (
    lineitem_q1_query,
    orders_tbl_decimal_query,
    q22_decimal_query,
    write_customer_data,
    write_decimal_data,
    write_orders_dated,
)

CONF = {"spark.sql.autoBroadcastJoinThreshold": -1,
        "spark.sql.shuffle.partitions": 1,
        "spark.rapids.sql.format.parquet.reader.type": "PERFILE"}

#: query -> (builder over {table: DataFrame}, the wrappers it must reach)
QUERIES = {
    "lineitem_q1": (lambda fr, F: lineitem_q1_query(fr["lineitem"], F),
                    {"multiply", "seg_sum128", "average"}),
    "orders_tbl_decimal": (
        lambda fr, F: orders_tbl_decimal_query(fr["orders_tbl"], F),
        {"parse_decimal", "seg_sum128", "average"}),
    "q22_decimal": (
        lambda fr, F: q22_decimal_query(fr["customer_dec"],
                                        fr["orders_cust"], F),
        {"seg_sum128", "average", "rescale_data", "compare"}),
}
#: q22's crossJoin is a nested-loop join, which neither package's fused
#: engine lowers
FUSED_ENGINE = {q: "fused" for q in QUERIES}
FUSED_ENGINE["q22_decimal"] = "aqe"
TABLES = ("lineitem", "customer_dec", "orders_cust", "orders_tbl")


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
    root = str(tmp_path_factory.mktemp("decimal_queries"))
    write_decimal_data(root, lineitem=600, customers=120, files=2, seed=4)
    write_customer_data(root, customers=120, orders=500, files=2, seed=4)
    write_orders_dated(root, rows=400, files=2, seed=4)
    return root


def _tree(node, depth=0):
    """The physical tree's operator names, the reference's after-scan
    batch coalescing and its host transitions left out."""
    name = type(node).__name__
    skip = name in ("TpuCoalesceBatchesExec", "DeviceToHostExec",
                    "HostToDeviceExec")
    rows = [] if skip else [(depth, name.replace("Cpu", "Tpu"))]
    for c in node.children:
        rows += _tree(c, depth + (not skip))
    return rows


def _run(pkg, which, root, fused):
    """(answer, last_execution, physical tree) of one query through one
    session: the fused engine over relations cached on the device, the
    adaptive engine over the parquet files."""
    conf = dict(CONF, **{"spark.rapids.sql.fusedExec.enabled": fused})
    if pkg == "jax":
        spark, F = JaxSession(conf), JF
    else:
        spark = TpuSparkSession(dict(conf, **{
            "spark.rapids.torch.device": "cpu"}))
        F = PF
    try:
        frames = {t: spark.read.parquet(os.path.join(root, t))
                  for t in TABLES}
        if fused:
            frames = {t: f.cache(storage="device") for t, f in frames.items()}
        q = QUERIES[which][0](frames, F)
        out = q.collect_arrow()
        return out, dict(spark.last_execution), _tree(q._physical()[0])
    finally:
        spark.stop()


@pytest.fixture(scope="module")
def reference(data):
    """Each query's answer and plan in the reference's session (adaptive
    engine), computed once."""
    cache = {}

    def get(which):
        if which not in cache:
            out, _, tree = _run("jax", which, data, False)
            cache[which] = (out, tree)
        return cache[which]
    return get


@pytest.fixture
def reached(monkeypatch):
    """The K31, K32 and K22-decimal wrappers each run calls (on the CPU
    they run their plain versions)."""
    seen = set()
    for mod, name in ((port_d128, "multiply"), (port_d128, "seg_sum128"),
                      (port_d128, "average"), (port_d128, "rescale_data"),
                      (port_d128, "compare"),
                      (port_stringcast, "parse_decimal")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _tag=name, **k):
            seen.add(_tag)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.mark.parametrize("fused", [False, True], ids=["aqe", "fused"])
@pytest.mark.parametrize("which", sorted(QUERIES))
def test_decimal_query_matches_reference(data, reference, reached, which,
                                         fused):
    """Exactly the reference's rows, in its order, with its Arrow types;
    the adaptive engine runs the reference's physical tree."""
    want, want_tree = reference(which)
    got, ex, tree = _run("port", which, data, fused)
    assert ex["engine"] == (FUSED_ENGINE[which] if fused else "aqe"), ex
    assert QUERIES[which][1] <= reached, reached
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()
    assert got.num_rows > 0
    if not fused:
        if which == "orders_tbl_decimal":
            tree, want_tree = _below_wide_sort(tree, want_tree)
        assert tree == want_tree


def _below_wide_sort(tree, want_tree):
    """The trees below the ORDER BY of a decimal(> 18) key: the reference
    sorts on its CPU engine (its key check refuses the 128-bit key) after
    a device-to-host transition, the port on the device (K9 orders the
    limbs), each above the exchange its engine plans."""
    top = ("TpuSortExec", "TpuRangeShuffleExchangeExec",
           "TpuShuffleExchangeExec", "DeviceToArrowExec")

    def strip(rows):
        k = 0
        while rows[k][1] in top:
            k += 1
        return [n for _, n in rows[:k]], [(d - k, n) for d, n in rows[k:]]

    (port_top, port_rest), (ref_top, ref_rest) = strip(tree), strip(
        want_tree)
    assert port_top[0] == ref_top[0] == "TpuSortExec"
    assert "DeviceToArrowExec" in ref_top and "DeviceToArrowExec" \
        not in port_top
    return port_rest, ref_rest


def test_q22_decimal_falls_back_from_fused(data):
    """With the fused engine on, q22's crossJoin (a nested-loop join) hands
    the query to the adaptive engine, as the reference's fused engine
    does."""
    _, ex, _ = _run("port", "q22_decimal", data, True)
    assert ex["engine"] == "aqe"
    fused = [r for e, r in ex["fallbacks"] if e == "fused"]
    assert fused and "TpuBroadcastNestedLoopJoinExec" in fused[0]
