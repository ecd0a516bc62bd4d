"""The serving segment read's plan (`flash_segments_serve_plan`), its plain
version on each route, a model of its in-kernel tile walk, and the bias
gradient's plan (`flash_dbias_plan`).

The serving read (`flash_attention_segments_with_lse`, the chunked
prefill's attention within a chunk) takes one of three routes by shape:
bf16 at head_dim 64 or 128 up to `SERVE_TILES_MAX` tokens runs the tile
kernel (csrc/flash_segments_serve.cu), a longer bf16 stream the training
forward's pipe, fp32 and bf16 at head_dim 32 or 256 the warp-a-row kernel.
Each route rounds p in its frame (64 keys on the tiles and the pipe, 32 on
the rows) and walks the key tiles in ascending order, as JAX does, so its
plain version is `flash_attention_segments_plain` at that frame, held
here to JAX at block_q = block_k = the frame. On the card chip_smoke.py
holds each kernel to it. `_walk` models the tile kernel's walk: from the
ids alone each block forms every 64-token tile's [min, max] id range and
visits the tiles whose range meets its query tile's within the causal
bound; `_schedule` models its cp.async groups and ring stages."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.ops import flash_attention_segments as jfs
from rocm_apex_tpu_torch.ops import flash_attention as fa
from rocm_apex_tpu_torch.ops import flash_attention_segments as fas

TILE = 64
BF16 = torch.bfloat16
SHARE = 1e-3  # at most 0.1% of the elements beyond one bf16 step
HEADS = 2


def _ids(kind):
    """Segment ids of a 320-token stream: sorted, shuffled in blocks (the
    scheduler's order of slot pieces), or slot pieces with a pad
    segment (the engine's id num_slots)."""
    if kind == "sorted":
        return np.repeat(np.arange(3), (150, 41, 129)).astype(np.int32)
    if kind == "shuffled":
        return np.repeat(np.random.RandomState(3).permutation(
            np.repeat(np.arange(4), 2)), 40).astype(np.int32)
    ids = np.full(320, 8, np.int32)  # the pads
    at = 0
    for slot, n in ((3, 97), (0, 64), (5, 40), (6, 32)):
        ids[at:at + n] = slot
        at += n
    return ids


IDS = ("sorted", "shuffled", "pads")


def _draw(kind, d, seed, dtype=BF16):
    seg = _ids(kind)
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (HEADS, seg.size, d)).astype(np.float32)).to(dtype)
        for _ in range(3))
    return q, k, v, torch.from_numpy(seg)


def _j(t):
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _off_share(got, ref):
    got = got.float().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float32).astype(np.float64)
    big = np.abs(ref) > 1e-2
    off = np.abs(got - ref) > 2.0 ** -7 * np.abs(ref)
    return float((off & big).sum()) / max(int(big.sum()), 1)


# ---------------------------------------------------------------------------
# the serving read's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("total", [1, 64, 65, 256, 320,
                                   fas.SERVE_TILES_MAX])
def test_bf16_at_64_and_128_takes_the_tiles_up_to_the_stated_length(
        hd, total):
    plan = fas.flash_segments_serve_plan(8, total, hd)
    assert plan["route"] == "tiles" and plan["frame"] == TILE
    assert plan["grid"] == (-(-total // TILE), 8)


def test_the_serve_chunk_is_on_the_tiles():
    """The serve's chunk (budget 256, 8 heads of 128) in bf16: a block of
    one warpgroup a (query tile, head)."""
    plan = fas.flash_segments_serve_plan(8, 256, 128, BF16)
    assert plan == dict(route="tiles", frame=64, tiles=4, grid=(4, 8),
                        width=128, kernel_hd=128, hd_route="native",
                        pad_bytes=0)


@pytest.mark.parametrize("hd", [64, 128])
def test_a_longer_bf16_stream_takes_the_pipe(hd):
    total = fas.SERVE_TILES_MAX + 1
    plan = fas.flash_segments_serve_plan(8, total, hd)
    assert plan["route"] == "pipe" and plan["frame"] == TILE
    assert plan["grid"] == fas.flash_segments_plan(8, total, hd)["grid"]


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 32),
                                      (torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.float32, 256), (BF16, 32),
                                      (BF16, 256)])
@pytest.mark.parametrize("total", [256, 5000])
def test_fp32_and_the_other_head_dims_take_the_rows(dtype, hd, total):
    """fp32, and bf16 past head_dim 128, read on the rows at the warp's
    width; bf16 at hd 32 now takes the tiles (or, past SERVE_TILES_MAX
    tokens, the pipe) at width 64 with zero columns."""
    plan = fas.flash_segments_serve_plan(8, total, hd, dtype)
    if dtype == BF16 and hd <= 128:
        assert plan["route"] == ("tiles" if total <= fas.SERVE_TILES_MAX
                                 else "pipe")
        assert (plan["width"], plan["hd_route"]) == (64, "zero_columns")
        return
    assert plan["route"] == "rows"
    assert plan["frame"] == fas.SERVE_FRAME == 32
    assert plan["grid"] == (-(-8 * total // 4),)  # 4 warps (rows) a block
    assert plan["width"] == hd and plan["hd_route"] == "native"


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("hd", [16, 96, 512])
def test_other_head_dims_raise(dtype, hd):
    """Past 256 the read raises (ROADMAP Queue 2); 16 and 96, once
    refused, take their width with zero columns (bf16 on the tiles at 64
    and 128, fp32 on the rows at 32 and 128)."""
    if hd > 256:
        with pytest.raises(ValueError, match="head_dim.*Queue 2"):
            fas.flash_segments_serve_plan(8, 256, hd, dtype)
        return
    plan = fas.flash_segments_serve_plan(8, 256, hd, dtype)
    assert plan["route"] == ("tiles" if dtype == BF16 else "rows")
    assert plan["width"] == ({16: 64, 96: 128} if dtype == BF16
                             else {16: 32, 96: 128})[hd]
    assert plan["hd_route"] == "zero_columns"


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("hd", [264, 512])
def test_head_dims_past_256_raise(dtype, hd):
    for plan in (lambda: fas.flash_segments_serve_plan(8, 256, hd, dtype),
                 lambda: fa.flash_dbias_plan(8, 8, 512, 512, hd, False,
                                             dtype)):
        with pytest.raises(ValueError, match="head_dim.*Queue 2"):
            plan()


# ---------------------------------------------------------------------------
# the plain version on each route
# ---------------------------------------------------------------------------

# the head_dim each route is drawn at, and a shape whose plan names it
# bf16 reads on the rows past head_dim 128 only
ROUTES = {"rows": (256, 320), "tiles": (64, 320),
          "pipe": (64, fas.SERVE_TILES_MAX + 1)}


@pytest.mark.parametrize("kind", IDS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_plain_at_each_route_frame_matches_jax(route, causal, kind):
    """The plain version at the route's frame against JAX
    `flash_attention_segments_with_lse` at block_q = block_k = that frame
    (both walk the key tiles in ascending order): at most 0.1% of o's elements beyond one bf16 step, lse within 1e-5 + 1e-6
    |lse|."""
    d, plan_total = ROUTES[route]
    plan = fas.flash_segments_serve_plan(HEADS, plan_total, d, BF16)
    assert plan["route"] == route
    f = plan["frame"]
    q, k, v, seg = _draw(kind, d, seed=len(route) + causal)
    scale = 1.0 / math.sqrt(d)
    jo, jlse = jfs.flash_attention_segments_with_lse(
        _j(q), _j(k), _j(v), jnp.asarray(seg.numpy()), causal, scale,
        block_q=f, block_k=f)
    o, lse = fas.flash_attention_segments_plain(q, k, v, seg, causal,
                                                scale, f)
    assert _off_share(o, np.asarray(jo, np.float32)) <= SHARE
    err = np.abs(lse.numpy() - np.asarray(jlse)) - (
        1e-5 + 1e-6 * np.abs(np.asarray(jlse)))
    assert err.max() <= 0.0


@pytest.mark.parametrize("kind", IDS)
@pytest.mark.parametrize("d,total", [(128, 320), (64, 40), (32, 320)])
def test_the_cpu_wrapper_is_the_plain_version_of_its_route(d, total, kind):
    """`flash_attention_segments_with_lse` on CPU tensors is the plain
    version of its plan's route: `flash_attention_segments_plain` at the
    route's frame."""
    q, k, v, seg = _draw(kind, d, seed=d)
    q, k, v, seg = q[:, :total], k[:, :total], v[:, :total], seg[:total]
    plan = fas.flash_segments_serve_plan(HEADS, total, d, BF16)
    got = fas.flash_attention_segments_with_lse(q, k, v, seg, True, 0.1)
    ref = fas.flash_attention_segments_plain(q, k, v, seg, True, 0.1,
                                             plan["frame"])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ---------------------------------------------------------------------------
# the in-kernel tile walk
# ---------------------------------------------------------------------------

def _walk(seg, causal):
    """The kernel's walks: walks[qt] the key tiles the block of query tile
    qt visits, in its order: the tiles up to the causal bound (every tile
    without causal masking) whose [min, max] id range meets the query
    tile's, the diagonal among them, in ascending order."""
    nt = -(-seg.size // TILE)
    rng = [(seg[t * TILE:(t + 1) * TILE].min(),
            seg[t * TILE:(t + 1) * TILE].max()) for t in range(nt)]

    def meet(a, b):
        return rng[a][0] <= rng[b][1] and rng[a][1] >= rng[b][0]

    return [[kt for kt in range((qt if causal else nt - 1) + 1)
             if meet(qt, kt)] for qt in range(nt)]


def _live_tile_pairs(seg, causal):
    same = seg[:, None] == seg[None, :]
    if causal:
        same &= np.tril(np.ones_like(same))
    nt = -(-seg.size // TILE)
    return {(qt, kt) for qt in range(nt) for kt in range(nt)
            if same[qt * TILE:(qt + 1) * TILE,
                    kt * TILE:(kt + 1) * TILE].any()}


WALK_IDS = {
    **{k: _ids(k) for k in IDS},
    "serve chunk": _ids("pads")[:256],
    "one sequence, ragged": np.zeros(200, np.int32),
    "one token": np.zeros(1, np.int32),
    "the longest stream, sorted": np.repeat(
        np.arange(5), (700, 13, 1, 900, 434)).astype(np.int32),
    "the longest stream, shuffled": np.random.RandomState(5).permutation(
        np.repeat(np.arange(16), 8)).repeat(16).astype(np.int32),
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(WALK_IDS))
def test_the_walk_visits_every_live_pair_once(name, causal):
    """Every (query tile, key tile) pair that holds a live token pair is
    visited exactly once, whatever the ids' order; for sorted ids no
    other pair is."""
    seg = WALK_IDS[name]
    assert seg.size <= fas.SERVE_TILES_MAX
    walks = _walk(seg, causal)
    pairs = [(qt, kt) for qt, kts in enumerate(walks) for kt in kts]
    assert len(pairs) == len(set(pairs))  # each at most once
    live = _live_tile_pairs(seg, causal)
    assert live <= set(pairs)  # none skipped
    if "shuffled" not in name and name not in ("pads", "serve chunk"):
        assert set(pairs) == live
    for qt, kts in enumerate(walks):  # one 32-bit mask, in JAX's order
        assert qt in kts and all(kt < 32 for kt in kts)
        assert kts == sorted(kts)


def _schedule(walk, qt):
    """The kernel's copies and waits over one walk, step by step, as
    (key tile, buffer, wait count, groups committed) where the groups are
    Q, D (the diagonal), R0 (the first ring tile, empty if none), then
    one a ring step: R(i + 1) issued at ring step i after its wait."""
    ring = [kt for kt in walk if kt != qt]
    groups = ["Q", "D", ("R", 0) if ring else None]
    held = {0: ring[0]} if ring else {}  # ring stage -> the tile it holds
    steps, i = [], 0
    for kt in walk:
        if kt == qt:
            steps.append((kt, "D", 1, list(groups)))
            continue
        steps.append((kt, ("stage", i % 2), 0, list(groups)))
        assert held[i % 2] == kt
        if i + 1 < len(ring):  # into the stage of ring tile i - 1
            held[(i + 1) % 2] = ring[i + 1]
        groups.append(("R", i + 1) if i + 1 < len(ring) else None)
        i += 1
    return steps


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(WALK_IDS))
def test_each_step_waits_for_its_tile_and_keeps_the_next_in_flight(
        name, causal):
    """cp.async groups complete in order and wait<N> leaves the newest N
    pending: at each step the group holding the step's tile is older than
    the newest N, the diagonal's step leaves at most the next ring tile in
    flight, and a ring stage is refilled only with the tile after the one
    it held, so no tile is overwritten before its step."""
    for qt, walk in enumerate(_walk(WALK_IDS[name], causal)):
        steps = _schedule(walk, qt)
        assert [kt for kt, *_ in steps] == walk
        ring_seen = 0
        for kt, buf, n, groups in steps:
            want = "D" if buf == "D" else ("R", ring_seen)
            pending = groups[len(groups) - n:] if n else []
            assert want in groups and want not in pending
            if buf != "D":
                ring_seen += 1
            else:
                assert pending in ([], [None], [("R", ring_seen)])


# ---------------------------------------------------------------------------
# the bias gradient's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_dbias_routes_by_dtype_at_masked_bert(dtype, hd):
    """Masked BERT's shape (nb 8, hp 8, 512 x 512)."""
    plan = fa.flash_dbias_plan(8, 8, 512, 512, hd, False, dtype)
    assert plan["live"] == 64
    if dtype == BF16:
        # two key tiles a block sharing q and do: 6 tiles a stage
        stages = 2 if hd == 128 else 3
        assert plan["route"] == "wgmma" and plan["key_tiles"] == 2
        assert plan["grid"] == (4, 8, 8) and plan["stages"] == stages
        assert plan["smem"] == stages * 6 * TILE * hd * 2 + 1024
    else:
        assert plan["route"] == "cuda_cores" and plan["key_tiles"] == 1
        assert plan["grid"] == (8, 8, 8) and plan["stages"] == 1
        assert plan["smem"] == 4 * (4 * TILE * (hd + 1) + 2 * TILE)


@pytest.mark.parametrize("hd", [64, 128])
def test_dbias_ring_fits_a_multiprocessor(hd):
    """The ring fits a block's shared memory (227 KB)."""
    assert fa.flash_dbias_plan(1, 1, 64, 64, hd, False)["smem"] <= 232448


@pytest.mark.parametrize("sq,sk", [(512, 512), (200, 333), (333, 200)])
def test_dbias_causal_blocks_past_the_bound_run_no_head(sq, sk):
    """Under causal masking the (query tile, key tile) pairs wholly past
    the diagonal write zeros without the heads' loop; the rest run it. A
    block of two key tiles covers an odd count with its second past Sk."""
    plan = fa.flash_dbias_plan(4, 2, sq, sk, 64, True)
    nqt, nkt = -(-sq // TILE), -(-sk // TILE)
    assert plan["grid"] == (-(-nkt // 2), nqt, 4)
    rows = np.arange(sq)
    live = {(r // TILE, c // TILE) for r in rows
            for c in range(min(r, sk - 1) + 1)}
    assert plan["live"] == len(live)
    assert fa.flash_dbias_plan(4, 2, sq, sk, 64, False)["live"] == nqt * nkt


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("hd", [32, 96, 256])
def test_dbias_other_head_dims_raise(dtype, hd):
    """The head dims other than 64 and 128, once refused, name their
    width and route: 32 on 64, 96 on 128 (zero columns), 256 staged in
    two 128-column parts (on the ring, two stages of the width-128 set)."""
    plan = fa.flash_dbias_plan(8, 8, 512, 512, hd, False, dtype)
    assert plan["route"] == ("wgmma" if dtype == BF16 else "cuda_cores")
    assert plan["width"] == {32: 64, 96: 128, 256: 256}[hd]
    assert plan["hd_route"] == ("native" if hd == 256 else "zero_columns")
    assert plan["parts"] == (2 if hd == 256 else 1)
    if dtype == BF16:
        assert plan["stages"] == (3 if hd == 32 else 2)
        assert plan["smem"] <= 232448


def test_dbias_refuses_what_its_grid_cannot_carry():
    with pytest.raises(ValueError, match="bias rows"):
        fa.flash_dbias_plan(65536, 1, 64, 64, 64, False)
    with pytest.raises(ValueError, match="bias rows"):
        fa.flash_dbias_plan(0, 1, 64, 64, 64, False)
