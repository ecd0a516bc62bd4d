"""The training segment kernels' host plan (`flash_segments_plan`) and a
model of their tile walk.

The bf16 segment forward and backward (csrc/flash_segments_{fwd,bwd}.cu)
run on the flash pipes with a segment flag. Three pre-passes
(csrc/flash_unpacked.cuh) write, for each 64-token tile, the first and
the last tile whose [min, max] id range meets its own (lo, hi) and the
lengths of its walks, then the units' order, longest walk first. A
forward or dq-pass unit walks the key tiles of [lo, hi] up to its own
tile when causal, a dk/dv-pass unit the query tiles of [lo, hi] from its
own tile on. `_walk` below is that walk in numpy: every (query tile, key
tile) pair that holds a live token pair must be visited exactly once in
each pass whatever the ids' order, and, for sorted ids (fmha's), no pair
that holds none. The port's plain version of the pre-passes
(`flash_segments_tables_plain`) must give `_walk`'s tables word for word;
on the card chip_smoke.py (group seg_train) holds the tables the kernels
wrote to that plain version, and the kernels' outputs to theirs."""

import numpy as np
import pytest
import torch

from rocm_apex_tpu_torch.ops import flash_attention_segments as fas

TILE = 64
RANGE_ROWS = 32
FMHA_LENS = np.random.RandomState(0).choice(
    [64, 128, 256, 512, 2048], size=64,
    p=[0.3, 0.3, 0.2, 0.15, 0.05]).tolist()  # bench.py fmha's batch


def _ids(lens):
    return np.repeat(np.arange(len(lens)), lens).astype(np.int32)


def _walk(seg, causal):
    """The pre-passes and the walks as the kernels run them: returns
    (tiles, order_q, order_k, dq, dkv, ranges), tiles an (nt, 4) array of
    (lo, hi, cq, ck), dq[qt] the key tiles query tile qt walks (the
    forward's walk too), dkv[kt] the query tiles key tile kt walks, ranges
    the (min, max) id of each 32 tokens."""
    total = seg.size
    nt = -(-total // TILE)
    n32 = -(-total // RANGE_ROWS)
    r32 = [(seg[i * RANGE_ROWS:(i + 1) * RANGE_ROWS].min(),
            seg[i * RANGE_ROWS:(i + 1) * RANGE_ROWS].max())
           for i in range(n32)]
    rng = []
    for t in range(nt):
        parts = [r32[i] for i in range(2 * t, min(2 * t + 2, n32))]
        rng.append((min(p[0] for p in parts), max(p[1] for p in parts)))
    meet = np.array([[a[0] <= b[1] and a[1] >= b[0] for b in rng]
                     for a in rng])
    tiles = np.zeros((nt, 4), dtype=np.int64)
    for t in range(nt):
        live = np.flatnonzero(meet[t])
        lo, hi = live.min(), live.max()
        tiles[t] = (lo, hi, (t if causal else hi) - lo + 1,
                    hi - (t if causal else lo) + 1)
    # longest first; ties: query tiles down, key tiles up (the pipes' own
    # index order)
    order_q = sorted(range(nt), key=lambda t: (-tiles[t, 2], -t))
    order_k = sorted(range(nt), key=lambda t: (-tiles[t, 3], t))
    dq = [list(range(tiles[t, 0], (t if causal else tiles[t, 1]) + 1))
          for t in range(nt)]
    dkv = [list(range(max(tiles[t, 0], t if causal else 0), tiles[t, 1] + 1))
           for t in range(nt)]
    return tiles, order_q, order_k, dq, dkv, r32


def _live_tile_pairs(seg, causal):
    """(query tile, key tile) pairs that hold at least one attended token
    pair."""
    same = seg[:, None] == seg[None, :]
    if causal:
        same &= np.tril(np.ones_like(same))
    nt = -(-seg.size // TILE)
    return {(qt, kt) for qt in range(nt) for kt in range(nt)
            if same[qt * TILE:(qt + 1) * TILE,
                    kt * TILE:(kt + 1) * TILE].any()}


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_routes_by_dtype_and_head_dim(dtype, hd):
    plan = fas.flash_segments_plan(8, 17408, hd, dtype)
    assert plan["splits"] == 1
    assert plan["tiles"] == 272
    assert plan["workspace"] == 6 * 272 + 2 * 544
    if dtype == torch.bfloat16:
        assert plan["route"] == "wgmma"
        assert plan["grid"] == (8, 272)
        assert plan["stats"] == (8, 272 * TILE, 2)
    else:
        assert plan["route"] == "cuda_cores"
        assert plan["grid"] == (272, 8)
        assert plan["stats"] == (8, 17408)


@pytest.mark.parametrize("hd", [32, 96, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_refuses_other_head_dims(dtype, hd):
    with pytest.raises(ValueError, match="head_dim"):
        fas.flash_segments_plan(8, 1000, hd, dtype)


def test_plan_pads_the_stats_of_a_ragged_last_tile():
    plan = fas.flash_segments_plan(4, 470, 64)
    assert plan["tiles"] == 8 and plan["stats"] == (4, 512, 2)
    assert plan["workspace"] == 6 * 8 + 2 * 15


def test_plan_refuses_a_bf16_stream_past_the_grid():
    assert fas.flash_segments_plan(8, 65535 * TILE, 64)["tiles"] == 65535
    with pytest.raises(ValueError, match="at most 65535 tiles"):
        fas.flash_segments_plan(8, 65535 * TILE + 1, 64)
    # the CUDA cores carry the tiles on x
    plan = fas.flash_segments_plan(8, 65536 * TILE, 64, torch.float32)
    assert plan["grid"] == (65536, 8)


_SHUFFLED = np.random.RandomState(1).permutation(
    np.repeat(np.arange(9), 4)).repeat(29)
WALK_CASES = {
    "fmha batch": _ids(FMHA_LENS),
    "ragged, an empty sequence": _ids([37, 0, 300, 5, 128, 0]),
    "BERT-like lengths": _ids([512, 77, 300, 512, 129, 64, 1, 200]),
    "ids out of order": _SHUFFLED.astype(np.int32),
    "one token": np.zeros(1, dtype=np.int32),
    "one sequence, ragged": np.zeros(200, dtype=np.int32),
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_walk_visits_every_live_pair_once_in_each_pass(name, causal):
    seg = WALK_CASES[name]
    tiles, _, _, dq, dkv, _ = _walk(seg, causal)
    live = _live_tile_pairs(seg, causal)
    dq_pairs = [(qt, kt) for qt, kts in enumerate(dq) for kt in kts]
    dkv_pairs = [(qt, kt) for kt, qts in enumerate(dkv) for qt in qts]
    for pairs in (dq_pairs, dkv_pairs):
        assert len(pairs) == len(set(pairs))  # each at most once
        assert live <= set(pairs)  # no live pair skipped
    # the walks' lengths are the counts the order ranks by
    assert [len(w) for w in dq] == tiles[:, 2].tolist()
    assert [len(w) for w in dkv] == tiles[:, 3].tolist()
    if name != "ids out of order":  # sorted ids: no dead pair either
        assert set(dq_pairs) == live and set(dkv_pairs) == live


def test_shuffled_ids_are_exact_but_may_visit_dead_tiles():
    seg = WALK_CASES["ids out of order"]
    _, _, _, dq, _, _ = _walk(seg, True)
    visited = {(qt, kt) for qt, kts in enumerate(dq) for kt in kts}
    assert visited > _live_tile_pairs(seg, True)


@pytest.mark.parametrize("causal", [True, False])
def test_order_is_longest_walk_first(causal):
    seg = WALK_CASES["fmha batch"]
    tiles, order_q, order_k, _, _, _ = _walk(seg, causal)
    nt = len(tiles)
    assert sorted(order_q) == list(range(nt))
    assert sorted(order_k) == list(range(nt))
    assert np.all(np.diff(tiles[order_q, 2]) <= 0)
    assert np.all(np.diff(tiles[order_k, 3]) <= 0)
    # the fmha batch's longest walks are its three 2048-token sequences'
    # (32 tiles each): their last query tiles, their first key tiles
    starts = np.cumsum([0] + FMHA_LENS)[:-1]
    long_seqs = [s // TILE for s, n in zip(starts, FMHA_LENS) if n == 2048]
    if causal:
        assert sorted(order_q[:3]) == [s + 31 for s in long_seqs]
        assert sorted(order_k[:3]) == long_seqs
        assert tiles[order_q[0], 2] == 32 and tiles[order_k[0], 3] == 32
    else:
        assert sorted(order_q[:96]) == sorted(
            s + i for s in long_seqs for i in range(32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_plain_tables_are_the_models(name, causal):
    """The port's plain pre-passes write `_walk`'s tables, in the
    workspace layout the kernels write them (tiles, order, ranges)."""
    seg = WALK_CASES[name]
    tiles, order_q, order_k, _, _, ranges = _walk(seg, causal)
    want = np.concatenate([tiles.ravel(), order_q, order_k,
                           np.asarray(ranges).ravel()])
    got = fas.flash_segments_tables_plain(torch.from_numpy(seg), causal)
    assert got.dtype == torch.int32
    assert got.numel() == fas.flash_segments_plan(
        1, seg.size, 64)["workspace"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_tables_of_an_empty_stream():
    got = fas.flash_segments_tables_plain(torch.zeros(0, dtype=torch.int32),
                                          True)
    assert got.numel() == 0 == fas.flash_segments_plan(1, 0, 64)["workspace"]
