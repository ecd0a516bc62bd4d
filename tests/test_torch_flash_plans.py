"""The flash forward's host plan (`flash_fwd_plan`) and the plain form of
the key split it may choose, on the CPU.

- At the cells' shapes (the GPT train cell, BERT-Large unmasked and
  masked, the whole-prompt prefill's causal window, the ragged and varlen
  shapes the card checks) the plan's units cover every query row once and
  every key tile of a query tile once; query tiles go longest first; a
  split past a causal row block's last key holds no tile; bf16 takes the
  wgmma pipe at head_dim 64 and 128, fp32 the CUDA cores, other head dims
  raise; the split fills the card only where the (head, query tile) pairs
  cannot.
- `flash_fwd_split_plain`, the split forward and its merge in plain
  PyTorch, against the JAX package's `_fwd` (its Pallas `_fwd_kernel` in
  interpret mode) on numpy-drawn fp32 inputs at 1e-5 (both sides fp32; the
  summation order differs), with a bias, per-row lengths and causal
  masking, at the plan's split and at hand-picked ones.
- The packed backward's host plan (`flash_bwd_plan`): its two passes
  cover every attended (query tile, key tile) pair once each, longest
  first, causal and not, at S 1024, 512 and 1000; its routes, buffers and
  bias partials. The bias pre-pass it plans is a change of operands, not
  of results: the plain backward on the biased projection with no bias
  gives the same dqkv bits, and that dqkv's column sums are the bias's
  cotangent.
- The unpacked backward's host plan (`flash_unpacked_bwd_plan`), on the
  same tile lists: every live (query tile, key tile) pair once in each
  pass, causal (top-left) and not, at sq = sk and sq != sk both ways;
  bf16 on the wgmma pipe at head_dim 64 and 128, fp32 on the CUDA cores,
  other head dims raise; the stats padded to whole query tiles; the delta
  buffer named only for the bias gradient. The packed plan's tile lists
  are those it gave before the two plans shared them.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.ops import flash_attention as jfa
from rocm_apex_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132
TILE = 64

# name, (batch * heads, sq, sk, head_dim, causal)
CELLS = [
    ("train", (16 * 8, 1024, 1024, 128, True)),
    ("bert_train", (8 * 8, 512, 512, 128, False)),
    ("masked BERT", (8 * 8, 512, 512, 128, False)),
    ("serve_whole", (1 * 8, 768, 768, 128, True)),
    ("ragged", (2 * 4, 200, 333, 64, False)),
    ("ragged causal", (2 * 4, 333, 200, 64, True)),
    ("varlen", (2 * 4, 300, 300, 64, False)),
    ("varlen causal", (2 * 4, 300, 300, 128, True)),
]


def _units(plan, sq):
    """(query tile, split) of each grid row, in launch order."""
    nqt = -(-sq // TILE)
    return [(nqt - 1 - y // plan["splits"], y % plan["splits"])
            for y in range(plan["grid"][1])]


@pytest.mark.parametrize("name,shape", CELLS)
def test_plan_covers_rows_and_key_tiles_once(name, shape):
    bh, sq, sk, hd, causal = shape
    plan = fa.flash_fwd_plan(bh, sq, sk, hd, causal, H100_SMS)
    assert plan["route"] == "wgmma" and plan["rows"] == TILE
    assert plan["grid"][0] == bh
    nqt, ntk = -(-sq // TILE), -(-sk // TILE)
    splits, st = plan["splits"], plan["split_tiles"]
    units = _units(plan, sq)
    # every query tile once per split, every split of it once
    assert sorted(units) == [(qt, s) for qt in range(nqt)
                             for s in range(splits)]
    rows = np.concatenate([np.arange(qt * TILE, min(qt * TILE + TILE, sq))
                           for qt, s in units if s == 0])
    assert np.array_equal(np.sort(rows), np.arange(sq))
    # the splits cut each query tile's key tiles into disjoint runs
    tiles = np.concatenate([np.arange(s * st, min(s * st + st, ntk))
                            for s in range(splits)])
    assert np.array_equal(tiles, np.arange(ntk))
    assert (splits - 1) * st < ntk  # no split starts past the last tile
    # longest first: query tiles never grow along the launch order
    qts = [qt for qt, _ in units]
    assert qts == sorted(qts, reverse=True)
    if causal:
        for qt, s in units:
            # the row block's keys end at its last row; a split past
            # them holds no tile (the kernel writes an empty partial)
            last = min(qt * TILE + TILE, sq, sk)
            n = max(0, min(-(-last // TILE), s * st + st) - s * st)
            assert n == 0 or s * st * TILE < last
    want = bh * nqt * splits * TILE * (hd + 2) if splits > 1 else 0
    assert plan["workspace"] == want


def test_plan_splits_only_where_the_pairs_cannot_fill_the_card():
    """The train and BERT cells have enough (head, query tile) pairs for
    two blocks a multiprocessor and are not split; the whole-prompt
    window's 8 x 12 pairs are, into runs of at least two key tiles."""
    for name, (bh, sq, sk, hd, causal) in CELLS[:3]:
        assert fa.flash_fwd_plan(bh, sq, sk, hd, causal,
                                 H100_SMS)["splits"] == 1, name
    plan = fa.flash_fwd_plan(8, 768, 768, 128, True, H100_SMS)
    assert plan["splits"] == 4 and plan["split_tiles"] == 3
    assert plan["grid"] == (8, 12 * 4)
    # a card of few multiprocessors is filled by the pairs alone
    assert fa.flash_fwd_plan(8, 768, 768, 128, True, 8)["splits"] == 1
    # one key tile cannot be split
    assert fa.flash_fwd_plan(1, 64, 64, 64, False, H100_SMS)["splits"] == 1


def test_plan_routes_by_dtype_and_head_dim():
    for hd in (64, 128):
        assert fa.flash_fwd_plan(8, 300, 300, hd, False,
                                 H100_SMS)["route"] == "wgmma"
    fp32 = fa.flash_fwd_plan(8, 300, 300, 128, True, H100_SMS, torch.float32)
    assert fp32["route"] == "cuda_cores" and fp32["splits"] == 1
    assert fp32["workspace"] == 0
    # hd 32 (the JAX recipes' width) runs on the width-64 pipe with zero
    # columns; the split workspace is sized at the width
    p32 = fa.flash_fwd_plan(8, 300, 300, 32, False, H100_SMS)
    assert (p32["route"], p32["width"], p32["hd_route"]) == (
        "wgmma", 64, "zero_columns")
    split = fa.flash_fwd_plan(1, 64, 4096, 80, False, H100_SMS)
    assert split["splits"] > 1 and split["workspace"] == (
        split["splits"] * 64 * (128 + 2))
    for hd in (264, 512):
        with pytest.raises(ValueError, match="head_dim.*Queue 2"):
            fa.flash_fwd_plan(8, 300, 300, hd, False, H100_SMS)


def _draw(bh, sq, sk, d, seed, nb=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    bias = rng.standard_normal((nb, sq, sk)).astype(np.float32)
    bias[:, :, sk - 3:] = -1e30  # padded keys
    return q, k, v, bias


# (bh, sq, sk, head_dim, causal, splits, split_tiles; None: the plan's)
SPLITS = [
    (8, 300, 300, 64, False, None, None),
    (8, 300, 300, 128, True, None, None),
    (2, 200, 333, 64, False, 3, 2),
    (2, 333, 200, 128, True, 4, 1),
    (2, 130, 130, 64, True, 1, 3),
]


@pytest.mark.parametrize("bh,sq,sk,d,causal,splits,split_tiles", SPLITS)
def test_split_forward_matches_jax(bh, sq, sk, d, causal, splits,
                                   split_tiles):
    """o and lse of the split forward and its merge against JAX `_fwd`,
    with a bias row per operand row and per-row key lengths (one shorter
    than a tile, one ending inside the last split)."""
    if splits is None:
        plan = fa.flash_fwd_plan(bh, sq, sk, d, causal, H100_SMS)
        splits, split_tiles = plan["splits"], plan["split_tiles"]
        assert splits > 1
    q, k, v, bias = _draw(bh, sq, sk, d, seed=sq + d + causal, nb=bh)
    if causal:
        bias[:, :, 0] = 0.0  # every causal row keeps a live key
    lens = np.full((bh,), sk, np.int32)
    lens[0], lens[1] = 17, sk - 70
    scale = 1.0 / math.sqrt(d)
    jo, jlse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(bias), causal, scale, 128, 128,
                        kv_lengths=jnp.asarray(lens))
    o, lse = fa.flash_fwd_split_plain(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), causal, scale,
        splits, split_tiles, torch.from_numpy(lens))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("splits,split_tiles", [(2, 3), (4, 2), (6, 1)])
def test_split_forward_equals_the_unsplit_one_with_dropout(splits,
                                                           split_tiles):
    """The merge keeps the unsplit forward's semantics under dropout: l
    over the undropped p, the kept p scaled, the same keep bits."""
    q, k, v, bias = (torch.from_numpy(a) for a in _draw(4, 300, 300, 64, 3))
    for causal in (False, True):
        ref = fa.flash_unpacked_fwd_plain(q, k, v, bias, causal, 0.125,
                                          None, 0.1, 9)
        got = fa.flash_fwd_split_plain(q, k, v, bias, causal, 0.125, splits,
                                       split_tiles, None, 0.1, 9)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# (batch, S, heads) of the packed backward: the GPT train cell, the
# bert_train cell and chip_smoke.py's ragged S
BWD_SHAPES = [(16, 1024, 8), (8, 512, 8), (4, 1000, 8)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("batch,seq,heads", BWD_SHAPES)
def test_bwd_plan_covers_every_pair_once_in_each_pass(batch, seq, heads,
                                                      causal):
    plan = fa.flash_bwd_plan(batch, seq, heads, 128, causal)
    nt = -(-seq // TILE)
    assert plan["route"] == "wgmma"
    assert plan["dq_grid"] == plan["dkv_grid"] == (batch * heads, nt)
    want = sorted((qt, kt) for qt in range(nt) for kt in range(nt)
                  if not causal or kt <= qt)
    dq = [(qt, kt) for qt, lo, hi in plan["dq_tiles"]
          for kt in range(lo, hi)]
    dkv = [(qt, kt) for kt, lo, hi in plan["dkv_tiles"]
           for qt in range(lo, hi)]
    assert sorted(dq) == want and sorted(dkv) == want
    # each block owns one tile: every row once
    assert sorted(t for t, _, _ in plan["dq_tiles"]) == list(range(nt))
    assert sorted(t for t, _, _ in plan["dkv_tiles"]) == list(range(nt))
    # longest first along the launch order
    for tiles in (plan["dq_tiles"], plan["dkv_tiles"]):
        walks = [hi - lo for _, lo, hi in tiles]
        assert walks == sorted(walks, reverse=True)
    # the dq pass's stats: a (lse log2 e, delta) pair for every row of
    # every query tile, padded to the tile
    assert plan["stats"] == (batch * heads, nt * TILE, 2)
    assert plan["parts"] == (batch, nt, heads, 3 * 128)
    assert plan["scratch"] == (batch, seq, heads, 3 * 128)


def test_bwd_plan_routes_by_dtype_and_head_dim():
    fp32 = fa.flash_bwd_plan(4, 1000, 8, 128, True, torch.float32)
    assert fp32["route"] == "cuda_cores" and fp32["scratch"] is None
    assert fp32["stats"] == (32, 1000)  # delta alone
    assert fp32["parts"] == (4, 16, 8, 384)
    assert fa.flash_bwd_plan(4, 1000, 8, 128, True)["route"] == "wgmma"
    # hd 256 (GPT-J's), the packed branch: the width-256 pipe with its
    # dk/dv pass split into two column halves; in fp32 the unpacked
    # CUDA-core bodies behind the bias pre-pass
    p256 = fa.flash_bwd_plan(4, 1000, 8, 256, True)
    assert (p256["route"], p256["width"], p256["hd_route"]) == (
        "wgmma", 256, "native")
    assert p256["dkv_grid"] == (32, 16, 2) and p256["dq_grid"] == (32, 16)
    f256 = fa.flash_bwd_plan(4, 1000, 8, 256, True, torch.float32)
    assert f256["form"] == "unpacked" and f256["scratch"] == (
        4, 1000, 8, 768)
    assert f256["parts"] == (4, 16, 8, 768)
    # the packed path takes hd % 128 == 0 (models/gpt.py routes the rest
    # to the unpacked kernels); 64 and past 256 raise
    for hd in (64, 264, 512):
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_bwd_plan(4, 1000, 8, hd, True)


def _packed(seed, batch, seq, heads, dt):
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dt)

    qkv = draw(batch, seq, heads, 3 * 64)
    bias = draw(heads * 3 * 64, scale=0.5)
    o, do = draw(batch, seq, heads * 64), draw(batch, seq, heads * 64)
    return qkv, bias, o, do


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,rate", [(True, 0.0), (False, 0.1)])
def test_bwd_on_the_biased_projection_is_the_bias_form(dt, causal, rate):
    """The plain packed backward on bf16(qkv + bias) (the pre-pass's
    rows) with no bias gives the bias form's dqkv bit for bit; the bias's
    cotangent is the column sums of that dqkv, taken in fp32 (here over a
    contiguous copy, the plain version over a permuted view: the orders
    differ, by fp32 rounding, ~sqrt(rows) 2^-24 of the terms' L1 mass)."""
    batch, seq, heads = 2, 70, 2
    qkv, bias, o, do = _packed(61 + causal, batch, seq, heads, dt)
    biased = (qkv.float() + bias.float().view(heads, -1)).to(dt)
    _, lse = fa.flash_qkv_fwd_plain(qkv, bias, causal, 0.125, rate, 5)
    dqkv, dbias = fa.flash_qkv_bwd_plain(qkv, bias, o, lse, do, causal,
                                         0.125, rate, 5)
    dqkv2, none = fa.flash_qkv_bwd_plain(biased, None, o, lse, do, causal,
                                         0.125, rate, 5)
    assert none is None and dqkv.dtype == dt
    assert torch.equal(dqkv, dqkv2)
    if dt == torch.float32:  # the fp32 dqkv is the unrounded one
        l1 = dqkv2.abs().sum(dim=(0, 1)).reshape(-1)
        np.testing.assert_array_less(
            (dqkv2.sum(dim=(0, 1)).reshape(-1) - dbias).abs().numpy(),
            (1e-6 * l1 + 1e-30).numpy())


# (sq, sk) of the unpacked backward: masked BERT, the whole-prompt
# window, and chip_smoke.py's ragged shapes both ways
UNPACKED_BWD_SHAPES = [(512, 512), (768, 768), (200, 333), (333, 200)]


def _live_tile_pairs(sq, sk, causal):
    """The (query tile, key tile) pairs holding at least one attended
    (query, key): top-left causal keeps key <= query."""
    nqt, nkt = -(-sq // TILE), -(-sk // TILE)
    return sorted((qt, kt) for qt in range(nqt) for kt in range(nkt)
                  if not causal or kt * TILE <= min(qt * TILE + TILE, sq) - 1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", UNPACKED_BWD_SHAPES)
def test_unpacked_bwd_plan_covers_every_live_pair_once(sq, sk, causal):
    bh = 64
    plan = fa.flash_unpacked_bwd_plan(bh, sq, sk, 128, causal)
    nqt, nkt = -(-sq // TILE), -(-sk // TILE)
    assert plan["route"] == "wgmma"
    assert plan["dq_grid"] == (bh, nqt) and plan["dkv_grid"] == (bh, nkt)
    want = _live_tile_pairs(sq, sk, causal)
    dq = [(qt, kt) for qt, lo, hi in plan["dq_tiles"]
          for kt in range(lo, hi)]
    dkv = [(qt, kt) for kt, lo, hi in plan["dkv_tiles"]
           for qt in range(lo, hi)]
    # each pair once: no repeats, none missing, none dead
    assert sorted(dq) == want and sorted(dkv) == want
    assert len(set(dq)) == len(dq) and len(set(dkv)) == len(dkv)
    # a block a tile: every query row and every key once
    assert [t for t, _, _ in plan["dq_tiles"]] == list(reversed(range(nqt)))
    assert [t for t, _, _ in plan["dkv_tiles"]] == list(range(nkt))
    for tiles in (plan["dq_tiles"], plan["dkv_tiles"]):
        walks = [max(hi - lo, 0) for _, lo, hi in tiles]
        assert walks == sorted(walks, reverse=True)


@pytest.mark.parametrize("hd", [64, 128])
def test_unpacked_bwd_plan_routes_by_dtype_and_head_dim(hd):
    bf = fa.flash_unpacked_bwd_plan(8, 300, 300, hd, False, torch.bfloat16)
    assert bf["route"] == "wgmma"
    fp32 = fa.flash_unpacked_bwd_plan(8, 300, 300, hd, False, torch.float32,
                                      True)
    assert fp32["route"] == "cuda_cores"
    # the CUDA cores' stats are delta itself, which the bias gradient reads
    assert fp32["stats"] == (8, 300) and fp32["delta"] is None
    assert fp32["dq_grid"] == (5, 8) and fp32["dkv_grid"] == (5, 8)
    # hd 96 (GPT-NeoX's) on the width-128 instance with zero columns,
    # both routes; past 256 a named refusal
    for dt in (torch.bfloat16, torch.float32):
        p96 = fa.flash_unpacked_bwd_plan(8, 300, 300, 96, False, dt)
        assert (p96["width"], p96["hd_route"], p96["pad_bytes"]) == (
            128, "zero_columns", 0)
        for bad in (264, 512):
            with pytest.raises(ValueError, match="head_dim.*Queue 2"):
                fa.flash_unpacked_bwd_plan(8, 300, 300, bad, False, dt)


@pytest.mark.parametrize("dbias", [False, True])
def test_unpacked_bwd_plan_pads_stats_and_names_delta_for_dbias(dbias):
    plan = fa.flash_unpacked_bwd_plan(8, 200, 333, 64, True, torch.bfloat16,
                                      dbias)
    # (lse log2 e, delta) pairs of whole query tiles: 200 rows -> 256
    assert plan["stats"] == (8, 256, 2)
    assert plan["delta"] == ((8, 200) if dbias else None)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("batch,seq,heads", BWD_SHAPES)
def test_bwd_plan_tile_lists_are_the_packed_ones(batch, seq, heads, causal,
                                                 dt):
    """`flash_bwd_plan` on the shared tile helper lists what it listed
    before: on the pipe query tiles counted down, on the CUDA cores up."""
    tiles = -(-seq // TILE)
    plan = fa.flash_bwd_plan(batch, seq, heads, 128, causal, dt)
    order = (reversed(range(tiles)) if dt == torch.bfloat16
             else range(tiles))
    assert plan["dq_tiles"] == [(t, 0, t + 1 if causal else tiles)
                                for t in order]
    assert plan["dkv_tiles"] == [(t, t if causal else 0, tiles)
                                 for t in range(tiles)]
    # the unpacked plan at sq = sk gives the same lists
    un = fa.flash_unpacked_bwd_plan(batch * heads, seq, seq, 128, causal, dt)
    assert (un["dq_tiles"], un["dkv_tiles"]) == (plan["dq_tiles"],
                                                plan["dkv_tiles"])
