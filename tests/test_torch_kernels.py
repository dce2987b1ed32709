"""The port's kernel modules against the JAX package, function by function.

Every input is made with numpy from a seed and goes through the JAX
function (CPU backend) and its counterpart in spark_rapids_tpu_torch with
device="cpu", where each kernel wrapper runs its plain PyTorch version.
Outputs must be equal array for array, dtypes included; float64 sums agree
within 1e-12 relative (summation order), and the join's gather maps are
compared on [0, total) with every slot beyond checked to be in range.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import arrow_to_device as jax_arrow_to_device
from spark_rapids_tpu.columnar import encoding as jax_encoding
from spark_rapids_tpu.columnar.batch import ColumnBatch as JaxBatch
from spark_rapids_tpu.ops import common as jax_common
from spark_rapids_tpu.ops import filterops as jax_filterops
from spark_rapids_tpu.ops import joinops as jax_joinops
from spark_rapids_tpu.ops import segmented as jax_segmented
from spark_rapids_tpu_torch.columnar import encoding as port_encoding
from spark_rapids_tpu_torch.columnar.arrow_bridge import schema_from_arrow
from spark_rapids_tpu_torch.columnar.batch import batch_from_host_leaves
from spark_rapids_tpu_torch.ops import common as port_common
from spark_rapids_tpu_torch.ops import filterops as port_filterops
from spark_rapids_tpu_torch.ops import joinops as port_joinops
from spark_rapids_tpu_torch.ops import segmented as port_segmented

F64_REL = 1e-12


def same(port, ref, what=""):
    """Equal values and dtype: a torch tensor against a jax/numpy array."""
    want = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def close_f64(port, ref, what=""):
    want = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == want.dtype == np.float64, what
    np.testing.assert_allclose(got, want, rtol=F64_REL, atol=0, err_msg=what)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def leaves_of(jb):
    """Numpy leaves of a JAX ColumnBatch, as batch_from_host_leaves takes
    them."""
    out = []
    for c in jb.columns:
        leaf = {"data": np.asarray(c.data), "validity": np.asarray(c.validity)}
        if c.lengths is not None:
            leaf["lengths"] = np.asarray(c.lengths)
        if c.vrange is not None:
            leaf["vrange"] = c.vrange
        if c.encoding is not None:
            leaf["dict_values"] = jax_encoding.dictionary_values(
                c.encoding.dict_id).to_pylist()
        out.append(leaf)
    return out


def both_batches(table: pa.Table, dead: int = 0):
    """The same batch in both packages; the last `dead` rows are kept in
    the buffers but counted out of num_rows."""
    jb = jax_arrow_to_device(table)
    n = table.num_rows - dead
    jb = JaxBatch(jb.schema, jb.columns, n)
    pb = batch_from_host_leaves(schema_from_arrow(table.schema),
                                leaves_of(jb), n, device="cpu")
    return jb, pb


def same_batch(pb, jb, rows=None):
    assert pb.capacity == jb.capacity
    for i, (pc, jc) in enumerate(zip(pb.columns, jb.columns)):
        sl = slice(None) if rows is None else slice(0, rows)
        same(pc.data[sl], np.asarray(jc.data)[sl], f"col {i} data")
        same(pc.validity[sl], np.asarray(jc.validity)[sl], f"col {i} valid")
        if jc.lengths is not None:
            same(pc.lengths[sl], np.asarray(jc.lengths)[sl], f"col {i} len")
        assert pc.vrange == jc.vrange, i
        assert (pc.encoding is None) == (jc.encoding is None), i


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("cap,p_keep,seed", [
    (1024, 0.5, 0), (1024, 0.0, 1), (1024, 1.0, 2), (8192, 0.9, 3),
    (16384, 0.1, 4)])
def test_compact_perm(cap, p_keep, seed):
    rng = np.random.default_rng(seed)
    keep = rng.random(cap) < p_keep
    perm, n_keep = port_filterops.compact_perm(t(keep), cap)
    jperm, jn = jax_filterops.compact_perm(jnp.asarray(keep), cap)
    same(perm, jperm, "perm")
    same(n_keep, jn, "n_keep")
    assert sorted(perm.tolist()) == list(range(cap))  # a bijection


def test_compact_keeps_live_rows_in_order():
    rng = np.random.default_rng(5)
    n = 3000
    table = pa.table({"k": pa.array(rng.integers(0, 9, n), pa.int64()),
                      "v": pa.array(rng.random(n))})
    jb, pb = both_batches(table, dead=100)
    keep = rng.random(jb.capacity) < 0.6
    out = port_filterops.compact(pb, t(keep))
    jout = jax_filterops.compact(jb, jnp.asarray(keep))
    same(out.num_rows, jout.num_rows, "rows")
    same_batch(out, jout)


# ------------------------------------------------------------- K2 / B3b

def _join_tables(rng, w: int, n_build: int, n_probe: int):
    keys = {"a": pa.array(rng.integers(0, 40, n_build), pa.int64())}
    pkeys = {"a": pa.array(rng.integers(-2, 42, n_probe), pa.int64())}
    if w == 2:
        keys["b"] = pa.array(rng.choice([1.5, -0.0, 0.0, float("nan")],
                                        n_build))
        pkeys["b"] = pa.array(rng.choice([1.5, 0.0, float("nan"), 2.0],
                                         n_probe))
    bmask = rng.random(n_build) < 0.1     # null build keys
    pmask = rng.random(n_probe) < 0.1     # null probe keys
    build = pa.table({k: pa.array(v.to_numpy(zero_copy_only=False),
                                  mask=bmask) for k, v in keys.items()})
    build = build.append_column("payload", pa.array(np.arange(n_build)))
    probe = pa.table({k: pa.array(v.to_numpy(zero_copy_only=False),
                                  mask=pmask) for k, v in pkeys.items()})
    return build, probe


@pytest.mark.parametrize("w", [1, 2])
def test_build_side_and_probe_ranges(w):
    rng = np.random.default_rng(10 + w)
    build, probe = _join_tables(rng, w, 700, 2500)
    jb, pb = both_batches(build, dead=20)
    jp, pp = both_batches(probe, dead=50)
    idx = list(range(w))
    bt = port_joinops.build_side(pb, idx)
    jbt = jax_joinops.build_side(jb, idx)
    same(bt.valid_bound, jbt.valid_bound, "valid_bound")
    assert len(bt.keys) == len(jbt.keys) == w
    for k, jk in zip(bt.keys, jbt.keys):
        same(k, jk, "sorted keys")
    same_batch(bt.batch, jbt.batch)
    lo, counts = port_joinops.probe_ranges(bt, pp, idx)
    jlo, jcounts = jax_joinops.probe_ranges(jbt, jp, idx)
    same(lo, jlo, "lo")
    same(counts, jcounts, "counts")
    assert int(counts.sum()) > 0


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("n,seed", [(1024, 20), (4096, 21)])
def test_expand_gather_maps(n, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, n).astype(np.int32)   # 0, 1 and 2 matches
    lo = rng.integers(0, 500, n).astype(np.int32)
    total = int(counts.sum())
    out_cap = 1 << max(10, (total - 1).bit_length())
    pi, bi, tot = port_joinops.expand_gather_maps(t(lo), t(counts), out_cap)
    jpi, jbi, jtot = jax_joinops.expand_gather_maps(
        jnp.asarray(lo), jnp.asarray(counts), out_cap)
    same(tot, jtot, "total")
    same(pi[:total], np.asarray(jpi)[:total], "probe idx")
    same(bi[:total], np.asarray(jbi)[:total], "build idx")
    assert pi.dtype == bi.dtype == torch.int32
    beyond_p, beyond_b = pi[total:], bi[total:]
    assert bool(((beyond_p >= 0) & (beyond_p < n)).all())
    assert bool((beyond_b >= 0).all())


# ------------------------------------------------------------------ K4

def _seg_inputs(rng, n, nseg, sorted_ids):
    gid = rng.integers(0, nseg, n).astype(np.int32)
    if sorted_ids:
        gid = np.sort(gid)
    valid = rng.random(n) < 0.8
    f = rng.normal(size=n) * 1e3
    i = rng.integers(-(1 << 40), 1 << 40, n)
    return gid, valid, f, i


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_seg_count(sorted_ids):
    rng = np.random.default_rng(30)
    gid, valid, _, _ = _seg_inputs(rng, 5000, 1024, sorted_ids)
    if sorted_ids:
        got = port_segmented.seg_count(t(valid), t(gid), 1024)
        want = jax_segmented.seg_count(jnp.asarray(valid), jnp.asarray(gid),
                                       1024)
    else:
        with port_segmented.unsorted_gids():
            got = port_segmented.seg_count(t(valid), t(gid), 1024)
        with jax_segmented.unsorted_gids():
            want = jax_segmented.seg_count(jnp.asarray(valid),
                                           jnp.asarray(gid), 1024)
    same(got, want, "count")


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("dtype", ["f64", "i64"])
def test_seg_sum_and_seg_sum_count(sorted_ids, dtype):
    rng = np.random.default_rng(31)
    gid, valid, f, i = _seg_inputs(rng, 6000, 2048, sorted_ids)
    vals = f if dtype == "f64" else i
    args = (t(vals), t(valid), t(gid), 2048)
    jargs = (jnp.asarray(vals), jnp.asarray(valid), jnp.asarray(gid), 2048)
    if sorted_ids:
        s = port_segmented.seg_sum(*args)
        s2, c2 = port_segmented.seg_sum_count(*args)
        js = jax_segmented.seg_sum(*jargs)
        js2, jc2 = jax_segmented.seg_sum_count(*jargs)
    else:
        with port_segmented.unsorted_gids():
            s = port_segmented.seg_sum(*args)
            s2, c2 = port_segmented.seg_sum_count(*args)
        with jax_segmented.unsorted_gids():
            js = jax_segmented.seg_sum(*jargs)
            js2, jc2 = jax_segmented.seg_sum_count(*jargs)
    check = close_f64 if dtype == "f64" else same
    check(s, js, "seg_sum")
    check(s2, js2, "seg_sum_count sum")
    same(c2, jc2, "seg_sum_count count")


def test_seg_sum_count_multi_matches_single_sums():
    """K4's one-launch shape: several value vectors, each under its own
    mask (or none), with per-vector counts, against one JAX segmented
    sum and count per vector over valid & mask."""
    rng = np.random.default_rng(32)
    gid, valid, f, _ = _seg_inputs(rng, 4000, 1024, False)
    g = rng.normal(size=4000)
    g_mask = rng.random(4000) < 0.7
    with port_segmented.unsorted_gids():
        out = port_segmented.seg_sum_count_multi(
            [t(f), t(g)], t(valid), t(gid), 1024, masks=[None, t(g_mask)],
            value_counts=True)
    for j, (vals, use) in enumerate(((f, valid), (g, valid & g_mask))):
        jargs = (jnp.asarray(vals), jnp.asarray(use), jnp.asarray(gid), 1024)
        js, jc = jax_segmented.seg_sum_count(*jargs)
        close_f64(out.sums[j], js, f"sum {j}")
        same(out.value_counts[j], jc, f"value count {j}")
    same(out.count, jax_segmented.seg_count(jnp.asarray(valid),
                                            jnp.asarray(gid), 1024))


# ------------------------------------------------------- B2 / B4 / B6 / B7

@pytest.mark.parametrize("p_occ", [0.0, 0.05, 0.5, 1.0])
def test_dense_bin_perm(p_occ):
    rng = np.random.default_rng(40)
    occupied = rng.random(1024) < p_occ
    same(port_segmented.dense_bin_perm(t(occupied), 1024),
         jax_segmented.dense_bin_perm(jnp.asarray(occupied), 1024))


@pytest.mark.parametrize("dtype", ["f64", "i64"])
def test_seg_min(dtype):
    rng = np.random.default_rng(41)
    gid, valid, f, i = _seg_inputs(rng, 3000, 1024, True)
    vals = f if dtype == "f64" else i
    same(port_segmented.seg_min(t(vals), t(valid), t(gid), 1024),
         jax_segmented.seg_min(jnp.asarray(vals), jnp.asarray(valid),
                               jnp.asarray(gid), 1024))


def _group_table(rng, n):
    k = rng.integers(0, 6, n)
    f = rng.choice([0.5, -0.0, 0.0, float("nan"), float("inf")], n)
    regions = pa.array([f"r{x}" for x in rng.integers(0, 5, n)])
    return pa.table({
        "k": pa.array(k, pa.int64(), mask=rng.random(n) < 0.1),
        "f": pa.array(f, pa.float64(), mask=rng.random(n) < 0.1),
        "s": regions.dictionary_encode(),
        "v": pa.array(rng.normal(size=n)),
    })


@pytest.mark.parametrize("keys", [[0], [1], [2], [0, 1, 2]])
def test_group_by(keys):
    rng = np.random.default_rng(42)
    jb, pb = both_batches(_group_table(rng, 2000), dead=30)
    g = port_segmented.group_by(pb, keys)
    jg = jax_segmented.group_by(jb, keys)
    same(g.num_groups, jg.num_groups, "num_groups")
    same(g.gid, jg.gid, "gid")
    same(g.live, jg.live, "live")
    same(g.first_pos, jg.first_pos, "first_pos")
    same_batch(g.sorted_batch, jg.sorted_batch)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ascending,nulls_first", [
    (True, True), (True, False), (False, True), (False, False)])
def test_orderable_keys_floats(np_dtype, ascending, nulls_first):
    rng = np.random.default_rng(43)
    special = [-0.0, 0.0, float("nan"), float("inf"), float("-inf"),
               1.5, -2.5, 1e-30, -1e30]
    vals = np.array(rng.choice(special, 1500), dtype=np_dtype)
    arr = pa.array(vals, mask=rng.random(1500) < 0.1)
    jb, pb = both_batches(pa.table({"x": arr}), dead=40)
    keys = port_common.orderable_keys(pb.columns[0], ascending, nulls_first,
                                      pb.live_mask())
    jkeys = jax_common.orderable_keys(jb.columns[0], ascending, nulls_first,
                                      jb.live_mask())
    assert len(keys) == len(jkeys) == 2
    for k, jk in zip(keys, jkeys):
        same(k, jk)
    perm = port_common.sort_permutation(keys, pb.capacity)
    jperm = jax_common.sort_permutation(jkeys, jb.capacity)
    same(perm, jperm, "stable sort permutation")


def test_decode_column_and_encoded_upload():
    # duplicate and null dictionary values and null indices: interning
    # canonicalises all three
    values = pa.array(["b", "a", None, "b", "ccccccccccc"])
    indices = pa.array([0, 1, 2, 3, 4, None, 1, 0] * 200, pa.int32())
    table = pa.table({"s": pa.DictionaryArray.from_arrays(indices, values)})
    from spark_rapids_tpu_torch.columnar.arrow_bridge import arrow_to_device

    pb = arrow_to_device(table, device="cpu")
    jb = jax_arrow_to_device(table)
    same_batch(pb, jb)
    assert pb.columns[0].encoding.dict_id == jb.columns[0].encoding.dict_id
    dec = port_encoding.decode_column(pb.columns[0])
    jdec = jax_encoding.decode_column(jb.columns[0])
    same(dec.data, jdec.data, "decoded bytes")
    same(dec.lengths, jdec.lengths, "decoded lengths")
    same(dec.validity, jdec.validity, "decoded validity")
    assert dec.encoding is None and dec.vrange is None


# ------------------------------------------------------ batch primitives

@pytest.mark.parametrize("shared_dict", [True, False])
def test_concat_batches(shared_dict):
    """Strings of different widths align; encoded pieces stay codes only
    when they share one dictionary, and decode otherwise."""
    from spark_rapids_tpu.columnar.batch import concat_batches as jax_concat
    from spark_rapids_tpu_torch.columnar.batch import concat_batches

    rng = np.random.default_rng(50)
    pairs = []
    for i, width in enumerate((3, 20, 9)):
        n = 700 + 100 * i
        words = [("w" * width)[:rng.integers(0, width + 1)]
                 for _ in range(n)]
        values = ["a", "b", "c"] if shared_dict else ["c", "b", "a"][i:]
        codes = pa.array(rng.integers(0, len(values), n), pa.int32())
        pairs.append(both_batches(pa.table({
            "s": pa.array(words),
            "d": pa.DictionaryArray.from_arrays(codes, pa.array(values)),
            "v": pa.array(rng.normal(size=n)),
        }), dead=i * 7))
    out = concat_batches([p for _, p in pairs])
    jout = jax_concat([j for j, _ in pairs])
    assert out.row_count() == jout.row_count()
    same_batch(out, jout)
    assert (out.columns[1].encoding is not None) == shared_dict


def test_empty_like_schema():
    from spark_rapids_tpu.columnar.arrow_bridge import (
        schema_from_arrow as jax_schema_from_arrow,
    )
    from spark_rapids_tpu.columnar.batch import (
        empty_like_schema as jax_empty_like_schema,
    )
    from spark_rapids_tpu_torch.columnar.batch import empty_like_schema

    schema = pa.schema([("i", pa.int64()), ("f", pa.float64()),
                        ("s", pa.string()), ("b", pa.bool_())])
    out = empty_like_schema(schema_from_arrow(schema), 2048,
                            torch.device("cpu"))
    jout = jax_empty_like_schema(jax_schema_from_arrow(schema), 2048)
    assert out.num_rows == jout.num_rows == 0
    same_batch(out, jout)


# ------------------------------------------------------- K6 murmur3 (B9)

from spark_rapids_tpu.ops import bloom as jax_bloom  # noqa: E402
from spark_rapids_tpu.ops import hashing as jax_hashing  # noqa: E402
from spark_rapids_tpu.ops import partition as jax_partition  # noqa: E402
from spark_rapids_tpu_torch.ops import bloom as port_bloom  # noqa: E402
from spark_rapids_tpu_torch.ops import hashing as port_hashing  # noqa: E402
from spark_rapids_tpu_torch.ops import (  # noqa: E402
    partition as port_partition,
)

_I64_EDGES = [-(1 << 63), -1, 0, 1, (1 << 63) - 1, -(1 << 32), 1 << 31]


def _key_table(rng, n: int) -> pa.Table:
    """Key columns of every hashed kind, with nulls: strings of 0-12 bytes
    (every tail length, non-ASCII bytes included), an encoded string,
    longs with INT64_MIN and negatives, doubles with -0.0 and NaN, ints,
    floats and booleans."""
    alphabet = ["a", "é", "z", "€", "0"]
    words = ["".join(rng.choice(alphabet, rng.integers(0, 7)))
             for _ in range(n)]
    longs = rng.integers(-(1 << 62), 1 << 62, n)
    longs[:len(_I64_EDGES)] = _I64_EDGES

    def nulls(p=0.1):
        return rng.random(n) < p

    return pa.table({
        "s": pa.array(words, mask=nulls()),
        "d": pa.array([f"region_{i:02d}" for i in rng.integers(0, 12, n)]
                      ).dictionary_encode(),
        "l": pa.array(longs, pa.int64(), mask=nulls()),
        "f64": pa.array(rng.choice([-0.0, 0.0, np.nan, 1.5, -2.25, np.inf],
                                   n), pa.float64(), mask=nulls()),
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32), pa.int32(),
                      mask=nulls()),
        "f32": pa.array(rng.choice([-0.0, 0.0, np.nan, 3.5], n)
                        .astype(np.float32), pa.float32(), mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
    })


def test_string_tail_lengths_cover_zero_to_twelve():
    rng = np.random.default_rng(60)
    lengths = set(len(s.encode()) for s in
                  _key_table(rng, 3000).column("s").drop_null().to_pylist())
    assert set(range(13)) <= lengths


@pytest.mark.parametrize("seed_kind", ["scalar", "vector"])
def test_hash_int_long_string(seed_kind):
    rng = np.random.default_rng(61)
    n = 2000
    seed = (np.int32(42) * np.ones(n, np.int32) if seed_kind == "scalar"
            else rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32))
    v32 = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    v64 = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    v64[:len(_I64_EDGES)] = _I64_EDGES
    same(port_hashing.hash_int(t(v32), t(seed)),
         jax_hashing.hash_int(jnp.asarray(v32), jnp.asarray(seed)),
         "hash_int")
    same(port_hashing.hash_long(t(v64), t(seed)),
         jax_hashing.hash_long(jnp.asarray(v64), jnp.asarray(seed)),
         "hash_long")
    jb, pb = both_batches(_key_table(rng, n))
    col, jcol = pb.columns[0], jb.columns[0]
    cap = jb.capacity
    seed_c = np.resize(seed, cap).astype(np.int32)
    same(port_hashing.hash_string(col.data, col.lengths, t(seed_c)),
         jax_hashing.hash_string(jcol.data, jcol.lengths,
                                 jnp.asarray(seed_c)), "hash_string")


@pytest.mark.parametrize("ci", range(7))
def test_hash_column(ci):
    rng = np.random.default_rng(62)
    jb, pb = both_batches(_key_table(rng, 1500), dead=25)
    seed = rng.integers(-(1 << 31), 1 << 31, jb.capacity).astype(np.int32)
    same(port_hashing.hash_column(pb.columns[ci], t(seed)),
         jax_hashing.hash_column(jb.columns[ci], jnp.asarray(seed)),
         f"column {ci}")


@pytest.mark.parametrize("cols,seed", [
    ([0], 42), ([1], 42), ([2, 3], 42), ([0, 1, 2, 3, 4, 5, 6], 42),
    ([4, 6, 0], 1091), ([2], -1756908916)])
def test_murmur3_columns(cols, seed):
    rng = np.random.default_rng(63)
    jb, pb = both_batches(_key_table(rng, 2500), dead=40)
    got = port_hashing.murmur3_columns([pb.columns[i] for i in cols], seed)
    want = jax_hashing.murmur3_columns([jb.columns[i] for i in cols], seed)
    same(got, want, "murmur3")


@pytest.mark.parametrize("n", [1, 8, 200])
def test_pmod(n):
    rng = np.random.default_rng(64)
    x = rng.integers(-(1 << 31), 1 << 31, 3000).astype(np.int32)
    same(port_hashing.pmod(t(x), n), jax_hashing.pmod(jnp.asarray(x), n))


# --------------------------------------------- K7 partition_by_ids (B10)

@pytest.mark.parametrize("nparts,dead", [(1, 0), (8, 77), (200, 500)])
def test_hash_partition_and_partition_by_ids(nparts, dead):
    rng = np.random.default_rng(65)
    jb, pb = both_batches(_key_table(rng, 3000), dead=dead)
    keys = [0, 2]
    pid = port_partition.hash_partition_ids(pb, keys, nparts)
    jpid = jax_partition.hash_partition_ids(jb, keys, nparts)
    same(pid, jpid, "partition ids")
    out = port_partition.partition_by_ids(pb, pid, nparts)
    jout = jax_partition.partition_by_ids(jb, jpid, nparts)
    same(out.counts, jout.counts, "counts")
    same_batch(out.batch, jout.batch)


def test_split_to_slices():
    rng = np.random.default_rng(66)
    jb, pb = both_batches(_key_table(rng, 2000), dead=13)
    got = port_partition.split_to_slices(pb, [2], 5, seed=1091)
    want = jax_partition.split_to_slices(jb, [2], 5, seed=1091)
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if g is not None:
            assert g.row_count() == w.row_count()
            same_batch(g, w)


# -------------------------------------------------------- K5 bloom (B11)

@pytest.mark.parametrize("keys,m_bits", [([2], 8192), ([2, 0], 32768),
                                         ([3], 1 << 20)])
def test_bloom_build_and_might_contain(keys, m_bits):
    rng = np.random.default_rng(67)
    # a build side with duplicate and null keys and dead rows
    build = _key_table(rng, 400)
    build = pa.concat_tables([build, build.slice(0, 100)])
    jb, pb = both_batches(build, dead=30)
    # the probe holds some build keys and many absent ones
    probe = pa.concat_tables([build.slice(0, 300), _key_table(rng, 2700)])
    jp, pp = both_batches(probe, dead=200)
    bits = port_bloom.build([pb.columns[i] for i in keys], pb.live_mask(),
                            m_bits)
    jbits = jax_bloom.build([jb.columns[i] for i in keys], jb.live_mask(),
                            m_bits)
    same(bits, jbits, "bits")
    keep = port_bloom.might_contain(bits, [pp.columns[i] for i in keys])
    jkeep = jax_bloom.might_contain(jbits, [jp.columns[i] for i in keys])
    same(keep, jkeep, "might_contain")
    # the counting form tests only the live rows
    keep2, kept = port_bloom.might_contain_count(
        bits, [pp.columns[i] for i in keys], pp.num_rows)
    same(keep2, jkeep & jp.live_mask(), "might_contain_count keep")
    assert int(kept) == int(jnp.sum(jkeep & jp.live_mask()))
    assert 0 < int(kept) < pp.row_count()


@pytest.mark.parametrize("rows", [10, 2000, 4000, 10 ** 6])
def test_bloom_size_for(rows):
    assert port_bloom.size_for(rows) == jax_bloom.size_for(rows)


# ----------------------------------------------- K8 gather_leaves (B6)

@pytest.mark.parametrize("dead", [0, 300])
def test_batch_gather_primitive_string_encoded(dead):
    rng = np.random.default_rng(68)
    jb, pb = both_batches(_key_table(rng, 2500), dead=dead)
    n_out = 1024
    idx = rng.integers(0, jb.capacity, n_out).astype(np.int32)
    out = pb.gather(t(idx), 700)
    jout = jb.gather(jnp.asarray(idx), 700)
    assert out.num_rows == 700
    same_batch(out, jout)
    assert out.columns[1].encoding is not None   # codes moved, not bytes
    col = pb.columns[0].gather(t(idx))
    jcol = jb.columns[0].gather(jnp.asarray(idx))
    same(col.data, jcol.data, "string bytes")
    same(col.lengths, jcol.lengths, "string lengths")


@pytest.mark.parametrize("width", [7, 12])
def test_gather_byte_matrix_of_odd_width(width):
    """A [cap, width] byte matrix whose width is no multiple of 4 (the
    kernel then moves rows in 1- or 4-byte units) gathers like jnp.take."""
    from spark_rapids_tpu.columnar.batch import DeviceColumn as JaxColumn
    from spark_rapids_tpu.sqltypes.datatypes import string as jax_string
    from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
    from spark_rapids_tpu_torch.sqltypes.datatypes import string

    rng = np.random.default_rng(71)
    cap = 2048
    lengths = rng.integers(0, width + 1, cap).astype(np.int32)
    data = rng.integers(1, 256, (cap, width)).astype(np.uint8)
    data[np.arange(width)[None, :] >= lengths[:, None]] = 0
    valid = rng.random(cap) < 0.9
    idx = rng.integers(0, cap, 1024).astype(np.int32)
    col = DeviceColumn(string, t(data), t(valid), t(lengths)).gather(t(idx))
    jcol = JaxColumn(jax_string, jnp.asarray(data), jnp.asarray(valid),
                     jnp.asarray(lengths)).gather(jnp.asarray(idx))
    same(col.data, jcol.data, "bytes")
    same(col.validity, jcol.validity, "validity")
    same(col.lengths, jcol.lengths, "lengths")


def test_gather_columns_with_two_index_vectors():
    """Both sides of a join output in one gather, each by its own
    indices, against one JAX gather per column."""
    from spark_rapids_tpu_torch.columnar.batch import gather_columns

    rng = np.random.default_rng(69)
    jl, pl = both_batches(_key_table(rng, 3000))
    jr, pr = both_batches(_key_table(rng, 500))
    pi = rng.integers(0, jl.capacity, 2048).astype(np.int32)
    bi = rng.integers(0, jr.capacity, 2048).astype(np.int32)
    got = gather_columns([(c, t(pi)) for c in pl.columns]
                         + [(c, t(bi)) for c in pr.columns])
    want = ([c.gather(jnp.asarray(pi)) for c in jl.columns]
            + [c.gather(jnp.asarray(bi)) for c in jr.columns])
    for g, w in zip(got, want):
        same(g.data, w.data, "data")
        same(g.validity, w.validity, "validity")
        if w.lengths is not None:
            same(g.lengths, w.lengths, "lengths")


def test_decode_column_clips_codes_and_zeroes_nulls():
    rng = np.random.default_rng(70)
    jb, pb = both_batches(_key_table(rng, 1500), dead=9)
    jcol, col = jb.columns[1], pb.columns[1]
    codes = rng.integers(-3, 15, jb.capacity).astype(np.int16)
    jcol = jcol.replace(data=jnp.asarray(codes))
    col = col.replace(data=t(codes))
    dec = port_encoding.decode_column(col)
    jdec = jax_encoding.decode_column(jcol)
    same(dec.data, jdec.data, "bytes")
    same(dec.lengths, jdec.lengths, "lengths")


# --------------------------------------------------- K9, K10, K11 (slice 3)

_KEY_SETS = [["l"], ["s"], ["f64"], ["d"], ["f32", "b"],
             ["i", "s", "l"], ["s", "d", "l", "f64", "i", "f32"]]


@pytest.mark.parametrize("cols", _KEY_SETS)
@pytest.mark.parametrize("ascending,nulls_first", [
    (True, True), (False, False), (True, False), (False, True)])
def test_k9_pack_and_sort_match_reference(cols, ascending, nulls_first):
    """K9's plain pack (one column's words = orderable_keys, several
    columns word-major) and its stable sort against the reference's
    orderable_keys and lax.sort: ties, nulls first and last, descending,
    dead rows, NaN, -0.0, +-inf, INT64_MIN, strings of 0-12 bytes with
    bytes >= 0x80, and the encoded column decoded."""
    rng = np.random.default_rng(70)
    table = _key_table(rng, 3000).select(cols)
    jb, pb = both_batches(table, dead=111)
    live, jlive = pb.live_mask(), jb.live_mask()
    specs = [port_common.KeySpec(c, ascending, nulls_first)
             for c in pb.columns]
    words, _ = port_common.pack_keys(specs, live)
    jkeys = [k for c in jb.columns
             for k in jax_common.orderable_keys(c, ascending, nulls_first,
                                                jlive)]
    assert words.shape[0] == len(jkeys)
    for w, jk in zip(words, jkeys):
        same(w, jk, "key word")
    perm = port_common.sort_words(words)
    same(perm, jax_common.sort_permutation(jkeys, jb.capacity), "perm")


@pytest.mark.parametrize("codes_ok", [True, False])
def test_k9_encoded_codes(codes_ok):
    rng = np.random.default_rng(71)
    jb, pb = both_batches(_key_table(rng, 2000).select(["d"]), dead=50)
    keys = port_common.orderable_keys(pb.columns[0], True, True,
                                      pb.live_mask(), codes_ok=codes_ok)
    jkeys = jax_common.orderable_keys(jb.columns[0], True, True,
                                      jb.live_mask(), codes_ok=codes_ok)
    assert len(keys) == len(jkeys)
    for k, jk in zip(keys, jkeys):
        same(k, jk)


@pytest.mark.parametrize("n,distinct", [(1024, 1), (5000, 3), (20000, 7)])
def test_k9_heavy_ties_are_stable(n, distinct):
    rng = np.random.default_rng(72)
    x = rng.integers(0, distinct, n).astype(np.int64)
    y = rng.integers(-2, 2, n).astype(np.int64)
    perm = port_common.sort_words(t(np.stack([x, y])))
    want = jax_common.sort_permutation([jnp.asarray(x), jnp.asarray(y)], n)
    same(perm, want)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.lexsort((np.arange(n), y, x)))


@pytest.mark.parametrize("cols", _KEY_SETS)
def test_k10_group_by_matches_reference(cols):
    """group_by = K9 pack and sort, then K10's segment structure: gid, the
    sorted live mask, num_groups and first_pos array for array (positions
    past the groups hold segment_min's identity), and the sorted batch."""
    rng = np.random.default_rng(73)
    jb, pb = both_batches(_key_table(rng, 2500).select(cols), dead=200)
    keys = list(range(len(cols)))
    g = port_segmented.group_by(pb, keys)
    jg = jax_segmented.group_by(jb, keys)
    same(g.num_groups, jg.num_groups, "num_groups")
    same(g.gid, jg.gid, "gid")
    same(g.live, jg.live, "live")
    same(g.first_pos, jg.first_pos, "first_pos")
    same_batch(g.sorted_batch, jg.sorted_batch)


@pytest.mark.parametrize("live_rows", [0, 1, 1000])
def test_k10_group_bounds_edges(live_rows):
    """No live row (first_pos[0] holds the capacity), one, and all."""
    rng = np.random.default_rng(74)
    table = pa.table({"k": pa.array(rng.integers(0, 3, 1024), pa.int64())})
    jb, pb = both_batches(table, dead=1024 - live_rows)
    g = port_segmented.group_by(pb, [0])
    jg = jax_segmented.group_by(jb, [0])
    for a, b, what in ((g.num_groups, jg.num_groups, "num_groups"),
                       (g.gid, jg.gid, "gid"), (g.live, jg.live, "live"),
                       (g.first_pos, jg.first_pos, "first_pos")):
        same(a, b, what)


@pytest.mark.parametrize("cap,p_occ", [(1, 1.0), (5000, 0.3), (8192, 0.0),
                                       (12289, 0.9)])
def test_k11_dense_bin_perm_sizes(cap, p_occ):
    rng = np.random.default_rng(75)
    occupied = rng.random(cap) < p_occ
    same(port_segmented.dense_bin_perm(t(occupied), cap),
         jax_segmented.dense_bin_perm(jnp.asarray(occupied), cap))


# ------------------------------------------- plain versions stay plain

import sys  # noqa: E402

from spark_rapids_tpu_torch import kernels as port_kernels  # noqa: E402
from spark_rapids_tpu_torch.columnar import batch as port_batch  # noqa: E402
from spark_rapids_tpu_torch.ops import sortops as port_sortops  # noqa: E402
from spark_rapids_tpu_torch.ops import windowops as port_windowops  # noqa: E402,E501
from spark_rapids_tpu_torch.expr import strings as port_strings  # noqa: E402
from spark_rapids_tpu_torch.ops import regexops as port_regexops  # noqa: E402
from spark_rapids_tpu_torch.regex import compile_search as port_compile  # noqa: E402,E501
from spark_rapids_tpu_torch.ops import stringcast as port_stringcast  # noqa: E402,E501
from spark_rapids_tpu_torch.ops import tzdb as port_tzdb  # noqa: E402
from spark_rapids_tpu_torch.expr import cast as port_cast  # noqa: E402
from spark_rapids_tpu_torch.expr import datetimes as port_datetimes  # noqa: E402,E501
from spark_rapids_tpu_torch.expr import aggregates as port_aggregates  # noqa: E402,E501
from spark_rapids_tpu_torch.expr import mathexpr as port_math  # noqa: E402
from spark_rapids_tpu_torch.ops import decimal128 as port_d128  # noqa: E402,E501
from spark_rapids_tpu_torch.expr import collections as port_collections  # noqa: E402,E501
from spark_rapids_tpu_torch.ops import zorder as port_zorder  # noqa: E402

# every kernel wrapper: on a CUDA tensor each one launches its kernel, so
# a plain version (the kernel's check on the card) must reach none of them
_WRAPPERS = [
    (port_filterops, "compact_perm"), (port_joinops, "probe_bounds"),
    (port_joinops, "expand_gather_maps"),
    (port_segmented, "seg_sum_count_multi"),
    (port_segmented, "dense_bin_perm"), (port_segmented, "group_bounds"),
    (port_bloom, "build"), (port_bloom, "might_contain"),
    (port_bloom, "might_contain_count"), (port_hashing, "murmur3_pmod"),
    (port_hashing, "murmur3_columns"), (port_hashing, "pmod"),
    (port_hashing, "hash_column"), (port_hashing, "_launch_k6"),
    (port_partition, "partition_perm"), (port_batch, "gather_leaves"),
    (port_encoding, "decode_column"), (port_common, "pack_keys"),
    (port_common, "sort_words"), (port_common, "sort_permutation"),
    (port_common, "orderable_keys"), (port_segmented, "_seg_minmax"),
    (port_segmented, "seg_min"), (port_segmented, "seg_max"),
    (port_sortops, "merge_runs"), (port_windowops, "window_prefix"),
    (port_windowops, "window_eval"),
    (port_windowops, "inverse_permutation"),
    (port_windowops, "range_bounds"), (port_windowops, "frame_minmax_eval"),
    (port_windowops, "frame_pick"), (port_regexops, "dfa_match"),
    (port_strings, "_find"), (port_strings, "_contains"),
    (port_strings, "_first_match_charpos"),
    (port_strings, "_select_nonoverlapping"),
    (port_strings, "_substring_index_bounds"), (port_strings, "_rewrite"),
    (port_strings, "_char_count"), (port_strings, "_assemble"),
    (port_stringcast, "_parse"), (port_stringcast, "parse_long"),
    (port_stringcast, "parse_double"), (port_stringcast, "parse_bool"),
    (port_stringcast, "parse_date"), (port_stringcast, "parse_timestamp"),
    (port_tzdb, "_rebase"), (port_tzdb, "utc_to_local"),
    (port_tzdb, "local_to_utc"), (port_cast, "_format"),
    (port_cast, "_int_to_string"), (port_cast, "_date_to_string"),
    (port_cast, "_timestamp_to_string"),
    (port_datetimes, "_pattern_to_string"),
    (port_segmented, "_seg_sum_count_launch"),
    (port_aggregates, "rank_select"), (port_aggregates, "rank_interp"),
    (port_aggregates, "collect_rank"), (port_aggregates, "collect_scatter"),
    (port_joinops, "probe_marks"), (port_joinops, "build_marks"),
    (port_joinops, "_launch_marks"), (port_joinops, "build_coverage"),
    (port_partition, "round_robin_perm"), (port_encoding, "remap_codes"),
    (port_hashing, "xxhash64_columns"), (port_math, "hex_text"),
    (port_d128, "add"), (port_d128, "multiply"), (port_d128, "rescale_data"),
    (port_d128, "average"), (port_d128, "negate"), (port_d128, "absolute"),
    (port_d128, "compare"), (port_d128, "to_double"), (port_d128, "to_long"),
    (port_d128, "seg_sum128"), (port_d128, "_launch"),
    (port_stringcast, "parse_decimal"), (port_cast, "_decimal_to_string"),
    (port_windowops, "frame_collect"), (port_collections, "array_compact"),
    (port_collections, "array_distinct"), (port_collections, "array_sort"),
    (port_collections, "_launch_rows"), (port_zorder, "interleave_bits"),
]


def _string_plain_cases(s_col):
    """K18-K21's plain versions, each mode and kind once."""
    S, K = port_strings, port_kernels
    d, ln = s_col.data, s_col.lengths
    n = d.shape[0]
    lo = torch.full((n,), 1, dtype=torch.int32)
    hi = torch.full((n,), 5, dtype=torch.int32)
    table = np.arange(256, dtype=np.int16)
    table[ord("a")] = -1
    cases = {
        "dfa_match_plain": lambda: port_regexops.dfa_match_plain(
            d, ln, port_compile("a.b|^x")),
        "_contains_plain": lambda: S._contains_plain(d, ln, b"ab"),
        "_first_match_charpos_plain": lambda: S._first_match_charpos_plain(
            d, ln, b"b", 1),
        "_select_nonoverlapping_plain":
            lambda: S._select_nonoverlapping_plain(d, ln, b"a"),
        "_substring_index_bounds_plain[2]":
            lambda: S._substring_index_bounds_plain(d, ln, b"a", 2),
        "_substring_index_bounds_plain[-1]":
            lambda: S._substring_index_bounds_plain(d, ln, b"a", -1),
        "_char_count_plain": lambda: S._char_count_plain(d, ln),
    }
    rewrites = {
        "map": S.Rewrite(K.REWRITE_MAP, table),
        "chars": S.Rewrite(K.REWRITE_CHARS, a=-3, b=2),
        "trim": S.Rewrite(K.REWRITE_TRIM, table, 1, 1),
        "range": S.Rewrite(K.REWRITE_RANGE, lo=lo, hi=hi),
        "reverse": S.Rewrite(K.REWRITE_REVERSE),
        "initcap": S.Rewrite(K.REWRITE_INITCAP)}
    for kind, rw in rewrites.items():
        cases[f"_rewrite_plain[{kind}]"] = \
            lambda rw=rw: S._rewrite_plain(d, ln, rw)
    assembles = {
        "concat": ([s_col, s_col], S.Assemble(K.ASSEMBLE_CONCAT)),
        "concat_ws": ([s_col, s_col], S.Assemble(K.ASSEMBLE_CONCAT_WS,
                                                 b"|")),
        "lpad": ([s_col], S.Assemble(K.ASSEMBLE_LPAD, b"xy", 9)),
        "rpad": ([s_col], S.Assemble(K.ASSEMBLE_RPAD, b"-", 3)),
        "repeat": ([s_col], S.Assemble(K.ASSEMBLE_REPEAT, a=2)),
        "replace": ([s_col], S.Assemble(K.ASSEMBLE_REPLACE, b"zz", 1))}
    for kind, (cols, asm) in assembles.items():
        cases[f"_assemble_plain[{kind}]"] = \
            lambda cols=cols, asm=asm: S._assemble_plain(
                cols, asm._replace(sel=S._select_nonoverlapping_plain(
                    d, ln, b"a")), 128)
    return cases


def _slice7_plain_cases():
    """K22-K24's plain versions, each mode once."""
    from spark_rapids_tpu_torch.sqltypes import datatypes as T

    texts = ["  -42 ", "1.5e3", "yes", "2020-02-29", "2020-01-01 12:30:45.5",
             "", "x", "9223372036854775808"]
    d = torch.zeros((len(texts), 32), dtype=torch.uint8)
    for i, s in enumerate(texts):
        d[i, :len(s)] = torch.tensor(list(s.encode()), dtype=torch.uint8)
    col = port_strings.DeviceColumn(
        T.string, d, torch.ones(len(texts), dtype=torch.bool),
        torch.tensor([len(s) for s in texts], dtype=torch.int32))
    sc, tz, ca = port_stringcast, port_tzdb, port_cast
    us = torch.tensor([0, -1, 1615712400000000, 1636273800000000,
                       -880000000000000], dtype=torch.int64)
    days = torch.tensor([0, -1, 8035, -719528], dtype=torch.int32)
    la = "America/Los_Angeles"
    return {
        "parse_long_plain": lambda: sc.parse_long_plain(col, T.integer),
        "parse_double_plain": lambda: sc.parse_double_plain(col, T.double),
        "parse_bool_plain": lambda: sc.parse_bool_plain(col, T.boolean),
        "parse_date_plain": lambda: sc.parse_date_plain(col, T.date),
        "parse_timestamp_plain": lambda: sc.parse_timestamp_plain(
            col, T.timestamp),
        "utc_to_local_plain": lambda: tz.utc_to_local_plain(us, la),
        "local_to_utc_plain": lambda: tz.local_to_utc_plain(us, la),
        "_int_to_string_plain": lambda: ca._int_to_string_plain(us),
        "_date_to_string_plain": lambda: ca._date_to_string_plain(days),
        "_timestamp_to_string_plain":
            lambda: ca._timestamp_to_string_plain(us),
        "_pattern_to_string_plain[days]":
            lambda: port_datetimes._pattern_to_string_plain(
                days, True, "yyyy-MM"),
        "_pattern_to_string_plain[us]":
            lambda: port_datetimes._pattern_to_string_plain(
                us, False, "dd/MM/yyyy HH:mm:ss.SSS"),
    }


def _slice8_plain_cases():
    """K4's multi-sum (8 vectors), K25's two modes and K26's two modes."""
    rng = np.random.default_rng(81)
    n = 900
    gid = t(np.sort(rng.integers(0, 40, n)).astype(np.int32))
    valid = t(rng.random(n) > 0.2)
    x = t(rng.choice(np.array([0.0, -0.0, np.nan, 1.5, 2.5, -3.0]), n))
    sv = t(np.sort(rng.normal(size=n)))
    w = t(rng.integers(0, 4, n) * 128)
    A, S = port_aggregates, port_segmented
    keep, rank, counts = A.collect_rank_plain(x, valid, gid, 64, True)
    return {
        "seg_sum_count_plain[k=8]": lambda: S.seg_sum_count_plain(
            [x * j for j in range(8)], valid, gid, 64),
        "rank_select_plain[live]": lambda: A.rank_select_plain(
            sv, gid, None, valid, 64, 128, 1e-12),
        "rank_select_plain[weights]": lambda: A.rank_select_plain(
            sv, gid, w, None, 64, 128, 128e-12),
        "rank_interp_plain": lambda: A.rank_interp_plain(
            sv[:896].reshape(64, 14), counts.clamp(max=14), 0.9),
        "collect_rank_plain": lambda: A.collect_rank_plain(
            x, valid, gid, 64, True),
        "collect_scatter_plain": lambda: A.collect_scatter_plain(
            x, keep, rank, gid, counts, 64, max(int(counts.max()), 1)),
    }


def _slice9_plain_cases():
    """K27-K29's plain versions."""
    rng = np.random.default_rng(79)
    n, m = 700, 90
    idx = t(rng.integers(0, m, n).astype(np.int32))
    ok = t(rng.random(n) < 0.3)
    lo = t(rng.integers(0, m, n).astype(np.int32))
    cnt = t(rng.integers(0, 3, n).astype(np.int32))
    codes = t(rng.integers(-2, 9, n).astype(np.int16))
    table = t(rng.integers(-1, 5, 7).astype(np.int32))
    J = port_joinops
    return {
        "probe_marks_plain": lambda: J.probe_marks_plain(idx, ok, m),
        "build_marks_plain": lambda: J.build_marks_plain(
            idx.to(torch.int64) - 3, ok, m, out=ok[:m].clone()),
        "build_coverage_plain": lambda: J.build_coverage_plain(lo, cnt, m),
        "round_robin_perm_plain":
            lambda: port_partition.round_robin_perm_plain(n, n - 9, 16, 3),
        "remap_codes_plain":
            lambda: port_encoding.remap_codes_plain(codes, table),
    }


def _slice10_plain_cases(s_col=None, d_col=None, l_col=None):
    """K30's and K24's hex mode's plain versions over a string, an encoded
    and a long key."""
    return {
        "xxhash64_columns_plain": lambda: port_hashing.xxhash64_columns_plain(
            [s_col, d_col, l_col]),
        "hex_plain": lambda: port_math.hex_plain(l_col.data.to(torch.int64)),
    }


def _slice11_plain_cases(s_col=None, d_col=None, l_col=None):
    """K31's, K32's and the decimal modes' of K22, K24 and K9 plain
    versions over a long key as decimal data, narrow and as limbs."""
    from spark_rapids_tpu_torch.sqltypes import DecimalType

    def wide():
        return port_d128.join(*port_d128.from_i64(l_col.data))

    def dec_col():
        return port_strings.DeviceColumn(DecimalType(38, 2), wide(),
                                         l_col.validity)

    def text():
        digits = (l_col.data.abs() % 1000).to(torch.uint8) % 10 + ord("0")
        data = digits[:, None].repeat(1, 8)
        return port_strings.DeviceColumn(
            None, data, l_col.validity,
            torch.full((data.shape[0],), 5, dtype=torch.int32))

    n = lambda: l_col.data.shape[0]  # noqa: E731
    return {
        "d128_add_plain": lambda: port_d128.add_plain(
            l_col.data, 2, wide(), 0, l_col.validity, 38, True),
        "d128_multiply_plain": lambda: port_d128.multiply_plain(
            l_col.data, l_col.data, None, 38),
        "d128_rescale_plain": lambda: port_d128.rescale_plain(
            wide(), -3, None, 18, False),
        "d128_average_plain": lambda: port_d128.average_plain(
            wide(), l_col.data.abs() % 7, 4, 19, True),
        "d128_negate_plain": lambda: port_d128.negate_plain(wide()),
        "d128_absolute_plain": lambda: port_d128.absolute_plain(wide()),
        "d128_compare_plain": lambda: port_d128.compare_plain(
            wide(), port_d128.negate_plain(wide())),
        "d128_to_double_plain": lambda: port_d128.to_double_plain(wide(), 2),
        "d128_to_long_plain": lambda: port_d128.to_long_plain(wide(), 20),
        "seg_sum128_plain": lambda: port_d128.seg_sum128_plain(
            *port_d128.from_i64(l_col.data), l_col.validity,
            (torch.arange(n()) % 5).to(torch.int32), 5),
        "decimal_string": lambda: port_d128.decimal_string(
            *port_d128.from_i64(l_col.data), 3),
        "decimal_to_string_plain": lambda: port_cast._decimal_to_string_plain(
            l_col.data, 4),
        "parse_decimal_plain": lambda: port_stringcast.parse_decimal_plain(
            text(), DecimalType(15, 2)),
        "pack_keys_plain_d128": lambda: port_common.pack_keys_plain(
            [port_common.KeySpec(dec_col(), False, False)],
            torch.ones(n(), dtype=torch.bool)),
    }


def _slice12_plain_cases(l_col=None, perm=None, live=None):
    """K33's, K34's (both modes) and K35's plain versions over the long
    key as values: a bounded frame collected as a list and a set, and the
    key's residues as [rows, 8] arrays."""
    def rows():
        n = l_col.data.shape[0]
        data = (l_col.data[:, None] + torch.arange(8)) % 7
        ev = (torch.arange(8)[None, :] + l_col.data[:, None]) % 5 != 0
        return data, ev, (l_col.data.abs() % 9).clamp(max=8).to(
            torch.int32).reshape(n)

    def window():
        return _plain_window(l_col.data.shape[0], perm, live)

    return {
        "frame_collect_plain_list": lambda: port_windowops.frame_collect_plain(
            l_col.data, l_col.validity, window(), -2, 0, False),
        "frame_collect_plain_set": lambda: port_windowops.frame_collect_plain(
            l_col.data % 3, l_col.validity, window(), -5, 0, True),
        "array_compact_plain": lambda: port_collections.array_compact_plain(
            rows()[0], rows()[1], rows()[0] > 2),
        "array_distinct_plain": lambda: port_collections.array_distinct_plain(
            *rows()),
        "array_sort_plain": lambda: port_collections.array_sort_plain(
            *rows(), False),
    }


_STRING_PLAIN = sorted(_string_plain_cases(port_strings.DeviceColumn(
    None, torch.zeros((1, 8), dtype=torch.uint8), torch.ones(1, dtype=bool),
    torch.zeros(1, dtype=torch.int32))))


def _plain_case(name, pb):
    """Run one plain version on the key table's batch (encoded `d` and
    string `s` keys included, so that decoding is reached)."""
    n = pb.capacity
    live = pb.live_mask()
    rng = np.random.default_rng(76)
    s_col, d_col, l_col = pb.columns[0], pb.columns[1], pb.columns[2]
    words, _ = port_common.pack_keys_plain(
        [port_common.KeySpec(c) for c in (d_col, l_col)], live)
    perm = port_common.sort_permutation_plain(list(words.unbind(0)), n)
    counts = t(rng.integers(0, 3, n).astype(np.int32))
    lo = t(rng.integers(0, n, n).astype(np.int32))
    ss = port_segmented
    cases = {
        "compact_perm_plain": lambda: port_filterops.compact_perm_plain(
            live, n),
        "probe_bounds_plain": lambda: port_joinops.probe_bounds_plain(
            list(words[:, perm.long()].unbind(0)), list(words.unbind(0)),
            torch.tensor(n - 5, dtype=torch.int32), live, n),
        "expand_gather_maps_plain":
            lambda: port_joinops.expand_gather_maps_plain(lo, counts, 2 * n),
        "seg_sum_count_plain": lambda: ss.seg_sum_count_plain(
            [l_col.data], live, counts, 3),
        "dense_bin_perm_plain": lambda: ss.dense_bin_perm_plain(live, n),
        "group_bounds_plain": lambda: ss.group_bounds_plain(words, perm,
                                                            live),
        "sort_permutation_plain": lambda: perm,
        "pack_keys_plain": lambda: port_common.pack_keys_plain(
            [port_common.KeySpec(d_col), port_common.KeySpec(s_col)], live,
            lead_rank=True),
        "orderable_keys_plain": lambda: port_common.orderable_keys_plain(
            d_col, False, False, live),
        "hash_column_plain": lambda: port_hashing.hash_column_plain(d_col,
                                                                    42),
        "murmur3_columns_plain": lambda: port_hashing.murmur3_columns_plain(
            [d_col, s_col, l_col]),
        "partition_perm_plain": lambda: port_partition.partition_perm_plain(
            counts, n - 9, 3),
        "build_plain": lambda: port_bloom.build_plain([d_col, s_col], live,
                                                      4096),
        "might_contain_count_plain":
            lambda: port_bloom.might_contain_count_plain(
                port_bloom.build_plain([d_col], live, 4096), [d_col], n - 9),
        "gather_leaves_plain": lambda: port_batch.gather_leaves_plain(
            [s_col.data, l_col.data], [perm, lo], clamp=True),
        "decode_column_plain": lambda: port_encoding.decode_column_plain(
            d_col),
        "seg_minmax_plain": lambda: ss.seg_minmax_plain(
            l_col.data.to(torch.float64), live, counts, 3, True),
        "merge_runs_plain": lambda: port_sortops.merge_runs_plain(
            words, words[:, :100], n - 5, 70, [s_col.data, l_col.data],
            [s_col.data[:100], l_col.data[:100]], 2 * n),
        "window_prefix_plain": lambda: port_windowops.window_prefix_plain(
            l_col.data, l_col.validity, live, perm, torch.int64),
        "window_eval_plain": lambda: port_windowops.window_eval_plain(
            _plain_window(n, perm, live), [
                port_windowops.WinRequest(k) for k in (
                    port_kernels.WIN_ROW_NUMBER, port_kernels.WIN_RANK,
                    port_kernels.WIN_DENSE_RANK)] + [
                port_windowops.WinRequest(
                    port_kernels.WIN_SUM_I64,
                    port_windowops.Frame(port_kernels.WIN_SEG,
                                         port_kernels.WIN_PEER),
                    torch.arange(n + 1, dtype=torch.int64),
                    torch.arange(n + 1, dtype=torch.int64)),
                port_windowops.WinRequest(port_kernels.WIN_PERCENT_RANK),
                port_windowops.WinRequest(port_kernels.WIN_CUME_DIST),
                port_windowops.WinRequest(port_kernels.WIN_NTILE,
                                          buckets=3)], perm),
        "inverse_permutation_plain":
            lambda: port_windowops.inverse_permutation_plain(perm),
        "range_bounds_plain": lambda: port_windowops.range_bounds_plain(
            _plain_window(n, perm, live), l_col.data, l_col.validity, perm,
            -3, 2.5, True),
        "frame_minmax_plain": lambda: port_windowops.frame_minmax_plain(
            l_col.data.to(torch.float64), l_col.validity,
            _plain_window(n, perm, live),
            port_windowops.Frame(port_kernels.WIN_OFFSET,
                                 port_kernels.WIN_PEER, -40),
            True, torch.arange(n + 1, dtype=torch.int64), perm),
        "frame_pick_plain": lambda: port_windowops.frame_pick_plain(
            _plain_window(n, perm, live), [
                port_windowops.Pick(port_kernels.PICK_SHIFT, offset=-2),
                port_windowops.Pick(
                    port_kernels.PICK_LAST_VALID,
                    port_windowops.Frame(port_kernels.WIN_OFFSET,
                                         port_kernels.WIN_OFFSET, -6, 0),
                    pcnt=torch.arange(n + 1, dtype=torch.int64))], perm),
    }
    cases.update(_string_plain_cases(s_col))
    cases.update(_slice7_plain_cases())
    cases.update(_slice8_plain_cases())
    cases.update(_slice9_plain_cases())
    cases.update(_slice10_plain_cases(s_col, d_col, l_col))
    cases.update(_slice11_plain_cases(s_col, d_col, l_col))
    cases.update(_slice12_plain_cases(l_col, perm, live))
    cases.update(_slice13_plain_cases(perm))
    return cases[name]()


def _slice13_plain_cases(perm=None):
    """K36's plain version over three and 65 rank columns (the sort's
    permutation and its shifts as ranks)."""
    def ranks(k):
        n = perm.shape[0]
        return [(perm + c) % n for c in range(k)]

    return {
        "interleave_bits_plain[3]": lambda: port_zorder.interleave_bits_plain(
            ranks(3), 10),
        "interleave_bits_plain[65]":
            lambda: port_zorder.interleave_bits_plain(ranks(65), 10),
    }


def _plain_window(n, perm, live):
    """A sorted-window view of n rows in three partitions."""
    pos = torch.arange(n, dtype=torch.int32)
    seg_start = (pos // 250) * 250
    seg_end = torch.clamp(seg_start + 249, max=n - 1)
    peer_start = (pos // 5) * 5
    return port_windowops.SortedWindow(
        perm, live, pos, seg_start, seg_end, seg_end - seg_start + 1,
        peer_start, torch.clamp(peer_start + 4, max=n - 1), pos // 5)


@pytest.mark.parametrize("name", [
    "compact_perm_plain", "probe_bounds_plain", "expand_gather_maps_plain",
    "seg_sum_count_plain", "dense_bin_perm_plain", "group_bounds_plain",
    "sort_permutation_plain", "pack_keys_plain", "orderable_keys_plain",
    "hash_column_plain", "murmur3_columns_plain", "partition_perm_plain",
    "build_plain", "might_contain_count_plain", "gather_leaves_plain",
    "decode_column_plain", "seg_minmax_plain", "merge_runs_plain",
    "window_prefix_plain", "window_eval_plain", "inverse_permutation_plain",
    "range_bounds_plain", "frame_minmax_plain", "frame_pick_plain",
    *_STRING_PLAIN, *sorted(_slice7_plain_cases()),
    *sorted(_slice8_plain_cases()), *sorted(_slice9_plain_cases()),
    *sorted(_slice10_plain_cases()), *sorted(_slice11_plain_cases()),
    *sorted(_slice12_plain_cases()), *sorted(_slice13_plain_cases())])
def test_plain_versions_reach_no_kernel_wrapper(name, monkeypatch):
    """With every kernel wrapper, wherever it is bound, replaced by one
    that raises, each plain version still runs."""
    rng = np.random.default_rng(77)
    _, pb = both_batches(_key_table(rng, 600), dead=31)
    wrappers = {getattr(mod, attr): attr for mod, attr in _WRAPPERS}

    def raiser(attr):
        def call(*a, **k):
            raise AssertionError(f"a plain version called {attr}")
        return call

    for mname, mod in list(sys.modules.items()):
        if not mname.startswith("spark_rapids_tpu_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            if callable(val) and val in wrappers:
                monkeypatch.setattr(mod, attr, raiser(wrappers[val]))
    _plain_case(name, pb)
