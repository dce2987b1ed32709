"""The port's window frame functions against the JAX package: RANGE frame
bounds (K15), min/max frames (K16), first/last frames and lead/lag (K17
with K8's gather), and percent_rank, cume_dist and ntile (K14).

Inputs are made with numpy from a seed and go through the JAX functions
(CPU backend) and the port with device="cpu", where each kernel wrapper
runs its plain PyTorch version. Every sorted domain comes from
`sort_for_window` over the same batch in both packages. Bounds, ranks,
counts and min/max results are equal array for array, floats bit for bit
(NaN, +-inf and -0.0 included); a picked value compares where it is
valid: where a frame holds no valid row the reference returns an
arbitrary value under validity false.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.ops import windowops as jax_windowops
from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.ops import windowops as port_windowops

from test_torch_kernels import both_batches, same

#: rows, partitions, dead rows
_SHAPES = [(3000, 40, 0), (3000, 7, 123), (1, 1, 0), (600, 3, 600)]


def _frame_table(rng, n: int, parts: int) -> pa.Table:
    """A partition key with nulls; an integer order key with ties and
    nulls; a float order key with ties, nulls, NaN, +-inf and -0.0; and
    values of every type K16 takes, with nulls, NaN, +-inf and -0.0."""
    p = rng.integers(0, parts, n)
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 2.5, -7.25])
    f = np.round(rng.random(n) * 40 - 20, 1)
    pick = rng.random(n) < 0.15
    f[pick] = rng.choice(specials, int(pick.sum()))
    d = rng.random(n) * 200 - 100
    pick = rng.random(n) < 0.3
    d[pick] = rng.choice(specials, int(pick.sum()))

    def nulls(frac):
        return rng.random(n) < frac

    return pa.table({
        "p": pa.array(p, type=pa.int64(), mask=nulls(0.05)),
        "o": pa.array(rng.integers(-20, 20, n), type=pa.int64(),
                      mask=nulls(0.05)),
        "f": pa.array(f, type=pa.float64(), mask=nulls(0.05)),
        "d": pa.array(d, type=pa.float64(), mask=nulls(0.1)),
        "l": pa.array(rng.integers(-1000, 1000, n), type=pa.int64(),
                      mask=nulls(0.1)),
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                      type=pa.int32(), mask=nulls(0.1)),
        "h": pa.array(rng.integers(-300, 300, n).astype(np.int16),
                      type=pa.int16(), mask=nulls(0.1)),
        "b": pa.array(rng.random(n) < 0.5, type=pa.bool_(),
                      mask=nulls(0.1)),
        "s": pa.array([f"s{v}" * int(v % 4) for v in rng.integers(0, 50, n)],
                      type=pa.string(), mask=nulls(0.1)),
    })


_COLS = {name: i for i, name in enumerate("pofdlihbs")}


def _windows(shape, order="o", ascending=True, nulls_first=True, seed=0):
    n, parts, dead = shape
    jb, pb = both_batches(_frame_table(np.random.default_rng(seed), n,
                                       parts), dead=dead)

    def cols(b):
        return ([b.columns[0]],
                [(b.columns[_COLS[order]], ascending, nulls_first)])

    return (jb, pb, jax_windowops.sort_for_window(jb, *cols(jb)),
            port_windowops.sort_for_window(pb, *cols(pb)))


def _sorted(jb, pb, jsw, psw, name):
    c = _COLS[name]
    return jb.columns[c].gather(jsw.perm), pb.columns[c].gather(psw.perm)


def _bits(x):
    x = np.asarray(x)
    if x.dtype == np.float64:
        return x.view(np.int64)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x.astype(np.int64)


# ------------------------------------------------------------------ K15

_RANGES = [(-3, 0), (0, 2), (-2, 5), (None, 1), (-1, None), (1, 4),
           (-4, -1), (None, 0), (-1.5, 1.5), (-0.5, 0)]


@pytest.mark.parametrize("lower,upper", _RANGES)
@pytest.mark.parametrize("order,nulls_first", [("o", True), ("o", False),
                                               ("f", True), ("f", False)])
@pytest.mark.parametrize("shape", _SHAPES[:2], ids=["3000x40", "3000x7"])
def test_range_frame_bounds_match_reference(shape, order, nulls_first,
                                            lower, upper):
    jb, pb, jsw, psw = _windows(shape, order, True, nulls_first, seed=1)
    jo, po = _sorted(jb, pb, jsw, psw, order)
    want = jax_windowops.range_frame_bounds(
        jsw, jo, jax_windowops.segment_ids_sorted(jsw), lower, upper,
        nulls_first=nulls_first)
    got = port_windowops.range_frame_bounds(psw, po, lower, upper,
                                            nulls_first=nulls_first)
    for g, w, side in zip(got, want, ("start", "end")):
        same(g, w, side)


def test_range_bounds_read_through_the_permutation():
    """K15 over the key in input order, read through perm, equals K15 over
    the sorted key."""
    jb, pb, jsw, psw = _windows(_SHAPES[1], "o", seed=2)
    _, po = _sorted(jb, pb, jsw, psw, "o")
    key = pb.columns[_COLS["o"]]
    a = port_windowops.range_bounds(psw, key.data, key.validity, psw.perm,
                                    -3, 2, True)
    b = port_windowops.range_bounds(psw, po.data, po.validity, None, -3, 2,
                                    True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------------------------------------ K16

_MM_FRAMES = {
    "rows_-2_1": ("rows", -2, 1),
    "running": ("rows", None, 0),
    "rows_-40_40": ("rows", -40, 40),   # frames across many 32-row tiles
    "rows_3_5": ("rows", 3, 5),         # past the partition end: empty
    "whole": ("rows", None, None),
    "range_-3_2": ("range", -3, 2),
}


def _bounds(jb, pb, jsw, psw, frame):
    kind, lower, upper = _MM_FRAMES[frame]
    if kind == "rows":
        return (jax_windowops.rows_frame_bounds(jsw, lower, upper),
                port_windowops.rows_frame_bounds(psw, lower, upper))
    jo, po = _sorted(jb, pb, jsw, psw, "o")
    return (jax_windowops.range_frame_bounds(
        jsw, jo, jax_windowops.segment_ids_sorted(jsw), lower, upper),
        port_windowops.range_frame_bounds(psw, po, lower, upper))


@pytest.mark.parametrize("frame", list(_MM_FRAMES))
@pytest.mark.parametrize("col", ["d", "l", "i", "h", "b"])
@pytest.mark.parametrize("shape", _SHAPES, ids=["3000x40", "3000x7", "1",
                                                "dead"])
def test_frame_minmax_matches_reference(shape, col, frame):
    jb, pb, jsw, psw = _windows(shape, seed=3)
    jse, pse = _bounds(jb, pb, jsw, psw, frame)
    jc, pc = _sorted(jb, pb, jsw, psw, col)
    for maximum in (False, True):
        want = jax_windowops.frame_minmax(jc.data, jc.validity, jsw, *jse,
                                          maximum)
        got = port_windowops.frame_minmax(pc.data, pc.validity, psw, *pse,
                                          maximum)
        if col == "b":   # the reference computes booleans in int32
            assert got.dtype == torch.bool
            got = got.to(torch.int32)
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=f"{col} max={maximum}")


def test_frame_minmax_writes_back_through_the_permutation():
    """K16 with perm (values read through it, results at input rows) and
    the count prefix's validity equals the sorted-domain result scattered
    back, with the reference's count > 0."""
    jb, pb, jsw, psw = _windows(_SHAPES[1], seed=4)
    jse, pse = _bounds(jb, pb, jsw, psw, "rows_-2_1")
    col = pb.columns[_COLS["d"]]
    _, pc = _sorted(jb, pb, jsw, psw, "d")
    pcnt = port_windowops.window_prefix(None, col.validity, psw.live,
                                        psw.perm, torch.int64)
    fr = port_windowops.Frame(kernels.WIN_OFFSET, kernels.WIN_OFFSET, -2, 1)
    data, valid = port_windowops.frame_minmax_eval(
        col.data, col.validity, psw, fr, True, pcnt, perm=psw.perm)
    sorted_data = port_windowops.frame_minmax(pc.data, pc.validity, psw,
                                              *pse, True)
    inv = np.asarray(jsw.inv)
    np.testing.assert_array_equal(_bits(data.numpy()),
                                  _bits(sorted_data.numpy()[inv]))
    cnt = jax_windowops.frame_count(
        jb.columns[_COLS["d"]].gather(jsw.perm).validity, jsw, *jse)
    np.testing.assert_array_equal(valid.numpy(), (np.asarray(cnt) > 0)[inv])


# ------------------------------------------------------------------ K17

@pytest.mark.parametrize("ignore_nulls", [False, True])
@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
@pytest.mark.parametrize("frame", ["rows_-2_1", "running", "rows_3_5",
                                   "range_-3_2"])
@pytest.mark.parametrize("col", ["d", "s"])
@pytest.mark.parametrize("shape", _SHAPES, ids=["3000x40", "3000x7", "1",
                                                "dead"])
def test_frame_first_last_matches_reference(shape, col, frame, last,
                                            ignore_nulls):
    jb, pb, jsw, psw = _windows(shape, seed=5)
    jse, pse = _bounds(jb, pb, jsw, psw, frame)
    jc, pc = _sorted(jb, pb, jsw, psw, col)
    wv, wok = jax_windowops.frame_first_last(jc.data, jc.validity, jsw,
                                             *jse, last, ignore_nulls)
    gv, gok = port_windowops.frame_first_last(pc.data, pc.validity, psw,
                                              *pse, last, ignore_nulls)
    same(gok, wok, "validity")
    ok = np.asarray(wok)
    same(gv[ok], np.asarray(wv)[ok], "values")
    if col == "s":
        wl, _ = jax_windowops.frame_first_last(jc.lengths, jc.validity, jsw,
                                               *jse, last, ignore_nulls)
        gl, _ = port_windowops.frame_first_last(pc.lengths, pc.validity,
                                                psw, *pse, last,
                                                ignore_nulls)
        same(gl[ok], np.asarray(wl)[ok], "lengths")


@pytest.mark.parametrize("offset", [1, 2, 3, -1, -2, -3])
@pytest.mark.parametrize("col", ["d", "h", "s"])
@pytest.mark.parametrize("shape", _SHAPES, ids=["3000x40", "3000x7", "1",
                                                "dead"])
def test_lead_lag_matches_reference(shape, col, offset):
    jb, pb, jsw, psw = _windows(shape, seed=6)
    jc, pc = _sorted(jb, pb, jsw, psw, col)
    leaves = [("data", jc.data, pc.data)]
    if col == "s":
        leaves.append(("lengths", jc.lengths, pc.lengths))
    for what, jx, px in leaves:
        wv, wok, win = jax_windowops.lead_lag(jx, jc.validity, jsw, offset)
        gv, gok, gin = port_windowops.lead_lag(px, pc.validity, psw, offset)
        same(gok, wok, f"{what} validity")
        same(gin, win, f"{what} inside")
        ok = np.asarray(wok)
        same(gv[ok], np.asarray(wv)[ok], what)


def test_frame_pick_writes_back_through_the_permutation():
    """K17 with perm gives input rows at input positions: src and has of
    the sorted-domain picks, mapped through perm and scattered back."""
    jb, pb, jsw, psw = _windows(_SHAPES[0], seed=7)
    pcnt = port_windowops.window_prefix(
        None, pb.columns[_COLS["d"]].validity, psw.live, psw.perm,
        torch.int64)
    picks = [port_windowops.Pick(kernels.PICK_SHIFT, offset=-2),
             port_windowops.Pick(kernels.PICK_LAST_VALID,
                                 port_windowops.Frame(
                                     kernels.WIN_OFFSET, kernels.WIN_OFFSET,
                                     -6, 0), pcnt=pcnt)]
    back = port_windowops.frame_pick(psw, picks, perm=psw.perm)
    sorted_out = port_windowops.frame_pick(psw, picks)
    inv = np.asarray(jsw.inv)
    perm = psw.perm.numpy()
    for (bs, bh), (ss, sh) in zip(back, sorted_out):
        np.testing.assert_array_equal(bs.numpy(), perm[ss.numpy()][inv])
        np.testing.assert_array_equal(bh.numpy(), sh.numpy()[inv])


# ------------------------------------------------------------------ K14+

@pytest.mark.parametrize("fn", ["percent_rank", "cume_dist", "ntile_1",
                                "ntile_3", "ntile_7"])
@pytest.mark.parametrize("shape", _SHAPES, ids=["3000x40", "3000x7", "1",
                                                "dead"])
def test_rank_arithmetic_matches_reference(shape, fn):
    _, _, jsw, psw = _windows(shape, seed=8)
    if fn.startswith("ntile"):
        k = int(fn.split("_")[1])
        got, want = port_windowops.ntile(psw, k), jax_windowops.ntile(jsw, k)
    else:
        got = getattr(port_windowops, fn)(psw)
        want = getattr(jax_windowops, fn)(jsw)
    same(got, want, fn)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
