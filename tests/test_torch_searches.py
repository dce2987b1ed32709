"""The functions of K15 (RANGE frame bounds) and K2 (join probe ranges)
against the JAX package, at the edges their searches must keep.

K15: `range_frame_bounds` over windows sorted by the key searched: float
keys with NaN sorted before +inf, trailing nulls and dead rows in both
null orders; offsets that make a +inf target on either side; int64 keys
at and past +-2^62 (the reference's int64 sentinels) with offsets that
carry targets past them and wrap; one-row partitions; one partition of
10,000 rows with a frame of +-100,000, longer than K15's tile and halo.
K2: `probe_bounds` against the reference's two `_binary_search`es at W =
1-4 over duplicate runs of 1, 2 and 1,000 rows, every build key equal,
keys at INT64_MIN and INT64_MAX, probes below and above the build's
range, bound 0 and below the capacity, dead and null probe rows.

Inputs are made with numpy from a seed; the port runs with device="cpu",
where each kernel wrapper runs its plain PyTorch version. Results are
equal array for array.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.ops import joinops as jax_joinops
from spark_rapids_tpu.ops import windowops as jax_windowops
from spark_rapids_tpu_torch.ops import joinops as port_joinops
from spark_rapids_tpu_torch.ops import windowops as port_windowops

from test_torch_kernels import both_batches, same, t

_I64 = np.iinfo(np.int64)
_BIG = 1 << 62

# ------------------------------------------------------------------ K15

_INT_SPECIALS = np.array(
    [_BIG - 7, _BIG - 1, _BIG, _BIG + 1, _BIG + 6, -_BIG - 6, -_BIG - 1,
     -_BIG, -_BIG + 1, -_BIG + 7, _I64.max, _I64.min, _I64.max - 3],
    np.int64)
_FLOAT_SPECIALS = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e308,
                            -1e308, 1.5])

#: name -> (rows, partitions (0: one row each), dead rows, key kind,
#: value spread, share of special values, share of null keys, offsets)
_K15_CASES = {
    "float_nan_inf": (3000, 7, 150, "float", 60, 0.3, 0.1,
                      [(-2, 3), (-1.5, 0.5), (None, 2)]),
    "float_inf_targets": (2000, 5, 100, "float", 60, 0.3, 0.1,
                          [(1e308, 1e308), (-1e308, 1e308), (None, 1e308),
                           (-1e308, None)]),
    "int64_sentinels": (2000, 5, 100, "int", 60, 0.4, 0.1,
                        [(-3, 4), (-_BIG, _BIG), (1, _BIG + 3),
                         (-_I64.max, 7)]),
    "one_row_partitions": (1500, 0, 20, "int", 60, 0.1, 0.1,
                           [(-3, 2), (None, 1)]),
    "long_frame": (10000, 1, 0, "int", 300000, 0.0, 0.02,
                   [(-100000, 100000), (-100000, None)]),
}


def _k15_table(seed: int, rows: int, parts: int, kind: str, spread: int,
               special: float, nulls: float) -> pa.Table:
    rng = np.random.default_rng(seed)
    p = np.arange(rows) if parts == 0 else rng.integers(0, parts, rows)
    pick = rng.random(rows) < special
    if kind == "float":
        k = rng.integers(0, spread, rows).astype(np.float64) - spread // 2
        k[pick] = rng.choice(_FLOAT_SPECIALS, int(pick.sum()))
        ktype = pa.float64()
    else:
        k = rng.integers(0, spread, rows) - spread // 2
        k[pick] = rng.choice(_INT_SPECIALS, int(pick.sum()))
        ktype = pa.int64()
    return pa.table({
        "p": pa.array(p, type=pa.int64(), mask=rng.random(rows) < 0.02),
        "k": pa.array(k, type=ktype, mask=rng.random(rows) < nulls),
    })


def _k15_params():
    for name, case in _K15_CASES.items():
        for nulls_first in (True, False):
            for lower, upper in case[-1]:
                yield pytest.param(name, nulls_first, lower, upper,
                                   id=f"{name}-nf{int(nulls_first)}-"
                                      f"{lower},{upper}")


@pytest.mark.parametrize("name,nulls_first,lower,upper", _k15_params())
def test_range_bounds_edges_match_reference(name, nulls_first, lower,
                                            upper):
    rows, parts, dead, kind, spread, special, nulls, _ = _K15_CASES[name]
    jb, pb = both_batches(_k15_table(14, rows, parts, kind, spread, special,
                                     nulls), dead=dead)
    jsw = jax_windowops.sort_for_window(
        jb, [jb.columns[0]], [(jb.columns[1], True, nulls_first)])
    psw = port_windowops.sort_for_window(
        pb, [pb.columns[0]], [(pb.columns[1], True, nulls_first)])
    jo = jb.columns[1].gather(jsw.perm)
    po = pb.columns[1].gather(psw.perm)
    want = jax_windowops.range_frame_bounds(
        jsw, jo, jax_windowops.segment_ids_sorted(jsw), lower, upper,
        nulls_first=nulls_first)
    got = port_windowops.range_frame_bounds(psw, po, lower, upper,
                                            nulls_first=nulls_first)
    for g, w, side in zip(got, want, ("start", "end")):
        same(g, w, side)
    # read through the permutation, K15 gives the same bounds
    key = pb.columns[1]
    through = port_windowops.range_bounds(psw, key.data, key.validity,
                                          psw.perm, lower, upper,
                                          nulls_first)
    direct = port_windowops.range_bounds(psw, po.data, po.validity, None,
                                         lower, upper, nulls_first)
    for a, b in zip(through, direct):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


# ------------------------------------------------------------------- K2

_K2_PATTERNS = ("unique", "runs", "equal", "extremes")


def _k2_inputs(seed: int, w: int, pattern: str, bound_kind: str,
               cap: int = 4096, n: int = 3000):
    """A sorted [w, cap] build (its rows past bound random), probe words
    that hit, miss by -2..2 in one word, and fall below and above the
    build's range, and all_valid with dead and null rows."""
    rng = np.random.default_rng(seed)
    rows = {"full": cap, "short": cap - 7, "empty": 0}[bound_kind]
    if pattern == "unique":
        w0 = np.arange(max(rows, 1), dtype=np.int64) * 3 - rows
    elif pattern == "runs":
        lens = rng.choice([1, 2, 1000], max(rows, 1))
        w0 = np.repeat(np.arange(len(lens), dtype=np.int64) * 5,
                       lens)[:max(rows, 1)]
    elif pattern == "equal":
        w0 = np.full(max(rows, 1), 7, np.int64)
    else:
        w0 = rng.integers(-50, 50, max(rows, 1))
        third = len(w0) // 3
        w0[:third] = _I64.min
        w0[len(w0) - third:] = _I64.max
    words = [w0] + [np.full(len(w0), 3, np.int64) if pattern == "equal"
                    else rng.integers(-2, 3, len(w0))
                    for _ in range(w - 1)]
    order = np.lexsort(words[::-1])
    build = rng.integers(-9, 9, (w, cap))
    for k in range(w):
        build[k, :rows] = words[k][order][:rows]
    src = rng.integers(0, max(rows, 1), n)
    probe = [build[k][src].copy() for k in range(w)]
    miss = rng.random(n) < 0.3
    moved = rng.integers(0, w, n)
    for k in range(w):
        m = miss & (moved == k)
        probe[k][m] += rng.integers(-2, 3, int(m.sum()))
    probe[0][:2] = [_I64.min, _I64.max]
    if rows:
        lo, hi = build[0, :rows].min(), build[0, :rows].max()
        probe[0][2] = lo - 1 if lo > _I64.min else lo
        probe[0][3] = hi + 1 if hi < _I64.max else hi
    all_valid = rng.random(n) < 0.85
    return build, probe, rows, all_valid, cap


@pytest.mark.parametrize("bound_kind", ["full", "short", "empty"])
@pytest.mark.parametrize("pattern", _K2_PATTERNS)
@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_probe_bounds_edges_match_reference(w, pattern, bound_kind):
    build, probe, rows, all_valid, cap = _k2_inputs(
        20 + w, w, pattern, bound_kind)
    bound = np.int32(rows)
    jbuild = [jnp.asarray(b) for b in build]
    jprobe = [jnp.asarray(q) for q in probe]
    jbound = jnp.asarray(bound)
    jlo = jax_joinops._binary_search(jbuild, jprobe, jbound, cap,
                                     upper=False)
    jhi = jax_joinops._binary_search(jbuild, jprobe, jbound, cap,
                                     upper=True)
    jcounts = jnp.where(jnp.asarray(all_valid), jhi - jlo, 0).astype(
        jnp.int32)
    lo, counts = port_joinops.probe_bounds(
        [t(b) for b in build], [t(q) for q in probe],
        torch.tensor(rows, dtype=torch.int32), t(all_valid), cap)
    same(lo, jlo, "lo")
    same(counts, jcounts, "counts")
    if pattern != "equal" and bound_kind != "empty":
        assert int(counts.sum()) > 0
