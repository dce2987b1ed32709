"""Host-side launch plans of K14's evaluation and K20 (CPU).

K14's sorted pass parks each row's results in records that its gather
reads back through the inverse permutation (`windowops.record_layout`);
K20 copies tiles of whole rows through shared memory
(`strings._rewrite_plan`). Both kernels run only on the card; these tests
hold the plans they are given to the layouts the kernels assume.
"""

import itertools

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.ops import windowops as W

#: one kind of each record footprint: a 4-byte rank, an 8-byte value that
#: is always valid, an 8-byte value with data validity
_KINDS = (kernels.WIN_ROW_NUMBER, kernels.WIN_CUME_DIST,
          kernels.WIN_SUM_F64)
_ALL_KINDS = (kernels.WIN_ROW_NUMBER, kernels.WIN_RANK,
              kernels.WIN_DENSE_RANK, kernels.WIN_SUM_F64,
              kernels.WIN_SUM_I64, kernels.WIN_COUNT, kernels.WIN_AVG,
              kernels.WIN_PERCENT_RANK, kernels.WIN_CUME_DIST,
              kernels.WIN_NTILE)


#: the per-block shared memory a launch may take without opting in
_SMEM_STATIC = 48 * 1024


def _width(kind: int) -> int:
    return torch.empty(0, dtype=W._out_dtype(W.WinRequest(kind))
                       ).element_size()


def _check_layout(kinds) -> None:
    lay = W.record_layout(kinds)
    assert lay.words in (4, 8) and lay.records >= 1
    rec_bytes = 4 * lay.words
    assert rec_bytes <= W.WIN_RECORD_BYTES
    if lay.words == 4:
        assert lay.records == 1
    spans = []
    for k, slot in zip(kinds, lay.slots):
        size = _width(k)
        assert slot % size == 0, (kinds, lay)  # aligned to its own size
        assert 0 <= slot and slot // 32 < lay.records
        assert slot % 32 + size <= rec_bytes, (kinds, lay)  # no straddle
        spans.append((slot, slot + size))
    needs_valid = any(k in (kernels.WIN_SUM_F64, kernels.WIN_SUM_I64,
                            kernels.WIN_AVG) for k in kinds)
    if needs_valid:
        v = lay.valid_slot
        assert v % 4 == 0 and v % 32 + 4 <= rec_bytes
        assert v // 32 == lay.records - 1  # the gather reads it first
        spans.append((v, v + 4))
    else:
        assert lay.valid_slot == -1
    spans.sort()
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 <= b0, (kinds, lay)  # no overlap
    used = sum(b - a for a, b in spans)
    assert lay.records == -(-used // W.WIN_RECORD_BYTES)  # nothing wasted


@pytest.mark.parametrize("count", range(1, kernels.MAX_WIN_OUTS + 1))
def test_record_layout_fits_every_request_set(count):
    for kinds in itertools.product(_KINDS, repeat=count):
        _check_layout(kinds)


@pytest.mark.parametrize("seed", range(4))
def test_record_layout_fits_mixed_kinds(seed):
    rng = np.random.default_rng(seed)
    for _ in range(500):
        count = int(rng.integers(1, kernels.MAX_WIN_OUTS + 1))
        _check_layout([int(k) for k in rng.choice(_ALL_KINDS, count)])


def test_record_layout_of_the_path_shapes():
    window = W.record_layout([kernels.WIN_ROW_NUMBER, kernels.WIN_RANK,
                              kernels.WIN_DENSE_RANK, kernels.WIN_SUM_F64])
    assert window.records == 1 and window.words == 8
    ranks = W.record_layout([kernels.WIN_PERCENT_RANK,
                             kernels.WIN_CUME_DIST, kernels.WIN_NTILE])
    assert ranks.records == 1 and ranks.valid_slot == -1
    assert W.record_layout([kernels.WIN_COUNT]).words == 4
    assert W.record_layout([kernels.WIN_SUM_F64] * 8).records == 3


@pytest.mark.parametrize("count", [0, kernels.MAX_WIN_OUTS + 1])
def test_record_layout_refuses_launch_sizes(count):
    with pytest.raises(ValueError):
        W.record_layout([kernels.WIN_ROW_NUMBER] * count)


#: K20's widths: the engine's powers of two, the edge widths of the chip
#: check, and widths around the row route's switch
_WIDTHS = (1, 2, 3, 8, 12, 16, 24, 31, 64, 128, 512, 520, 740, 760, 1000,
           1480, 1500, 4096, 65_536)


def _rewrite_smem(rows: int, pitch: int, tiles: int) -> int:
    """The table, its low bytes, the lengths, the tiles and the slack."""
    return 512 + 256 + 4 * rows + tiles * rows * pitch + 16


@pytest.mark.parametrize("kind", [kernels.REWRITE_MAP,
                                  kernels.REWRITE_REVERSE])
@pytest.mark.parametrize("mb", _WIDTHS)
@pytest.mark.parametrize("offsets", [(0, 0), (8, 0), (4, 0), (1, 0),
                                     (0, 2), (24, 16)])
def test_rewrite_plan_aligns_tiles(kind, mb, offsets):
    base = 1 << 20
    addrs = [base + o for o in offsets]
    plan = S._rewrite_plan(kind, mb, *addrs)
    tiles = 2 if kind == kernels.REWRITE_REVERSE else 1  # Reverse: in, out
    words = -(-mb // 4)
    if plan.tile_rows == 0:  # the row route: not even 32 rows fit
        assert _rewrite_smem(32, 4 * words, tiles) > S.REWRITE_TILE_SMEM
        return
    vec = plan.vec
    assert vec in (1, 2, 4, 8, 16)
    # a word holds one row's bytes and every tile starts on a word
    assert mb % vec == 0 and all(a % vec == 0 for a in addrs)
    assert (plan.tile_rows * mb) % vec == 0
    # no wider word would do
    assert vec == 16 or mb % (2 * vec) or any(a % (2 * vec) for a in addrs)
    assert plan.tile_rows in S.REWRITE_TILE_ROWS
    # a tile of more than 128 rows (several a thread) only for narrow rows
    assert plan.tile_rows <= 128 or (
        plan.tile_rows * mb <= S.REWRITE_TILE_BYTES)
    # rows at an odd number of 4-byte words, at least the width
    assert plan.pitch >= mb and plan.pitch % 4 == 0
    assert (plan.pitch // 4) % 2 == 1 and plan.pitch - mb < 8
    # within the static limit
    assert plan.smem == _rewrite_smem(plan.tile_rows, plan.pitch, tiles)
    assert plan.smem <= S.REWRITE_TILE_SMEM <= _SMEM_STATIC
    # the most rows that fit
    for r in S.REWRITE_TILE_ROWS:
        if r > plan.tile_rows:
            assert (_rewrite_smem(r, plan.pitch, tiles) > S.REWRITE_TILE_SMEM
                    or (r > 128 and r * mb > S.REWRITE_TILE_BYTES))


def test_rewrite_plan_of_the_path_widths():
    trim = S._rewrite_plan(kernels.REWRITE_TRIM, 128, 0, 0)
    assert trim == S.RewritePlan(128, 132, 16, _rewrite_smem(128, 132, 1))
    region = S._rewrite_plan(kernels.REWRITE_CHARS, 16, 0, 0)
    assert (region.tile_rows, region.pitch, region.vec) == (512, 20, 16)
    assert S._rewrite_plan(kernels.REWRITE_LENGTH, 8, 8, 0).vec == 8
    assert S._rewrite_plan(kernels.REWRITE_MAP, 512, 0, 0).tile_rows == 64
    assert S._rewrite_plan(kernels.REWRITE_REVERSE, 512, 0, 0
                           ).tile_rows == 32
    assert S._rewrite_plan(kernels.REWRITE_MAP, 1600, 0, 0).tile_rows == 0
