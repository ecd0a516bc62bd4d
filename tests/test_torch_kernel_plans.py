"""The host-side plans of the split paged decode read and of the
pipelined 3x3 bottleneck backward, and the plain forms of the device
steps they add, on the CPU.

- The split read (``csrc/flash_decode_paged.cu``): `decode_span_plan`
  cuts every (row, head)'s keys into spans that cover the capacity once
  each, none starting past it; `decode_span_workspace` sizes the blocks'
  partials. `decode_paged_spans_plain` forms each span's partial alone and
  merges them with `merge_span_partials_plain`, the fixed-order merge the
  kernels mirror; it is held against the JAX package's
  `flash_attention_decode_paged` (its Pallas kernel in interpret mode) on
  numpy-drawn fp32 inputs at 1e-5 (both sides fp32, the summation order
  differs), float and int8 pools, spans ending mid-page, a dead row and
  an empty one.
- The 3x3 backward (``csrc/bottleneck_bwd.cu`` over
  ``csrc/bottleneck_pipe.cuh``): `conv3_bwd_plan`'s tap-folded wgrad
  tiles, pixel splits and buffers at ResNet-50's five stride-1 block
  shapes and the ragged ones; the pre-pass's plain form equal bit for
  bit to the finalize and prologue the products read.
- The 3x3 forward (``csrc/bottleneck_fwd.cu``): `conv3_fwd_plan`'s
  routes (the pipe at every ResNet-50 width, the staged core at widths
  that are not multiples of 64 and in fp32), grid, partials and pre-pass
  buffer; the pipe's chain (the pre-pass, then the bare 3x3 on the
  zero-padded u) equal bit for bit to the prologue form's plain version,
  and held against the JAX package's `conv3x3_bn_act` in interpret mode.
- The 1x1 forward (``csrc/bottleneck_fwd.cu`` `MmFwdPipe`): `mm_fwd_plan`
  sends every 1x1 forward of ResNet-50's 13 fused blocks to the pipe and
  other widths and fp32 to the staged core, its grid covering M and N
  once, one partial a 128-pixel tile, u named only under a prologue; the
  chain (the pre-pass, then the bare 1x1) equal bit for bit to the
  prologue form's plain version, and held against the JAX package's
  `conv1x1_bn_act` in interpret mode at a ragged M with b > 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.ops.flash_attention import (
    flash_attention_decode_paged as jax_decode_paged,
)
from rocm_apex_tpu_torch.ops import flash_attention as fa
from rocm_apex_tpu_torch.ops import fused_bottleneck as fb

TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132

# ---------------------------------------------------------------------------
# the split paged read
# ---------------------------------------------------------------------------

# (rows, heads, capacity, multiprocessors): the serve's decode grid and
# chunk piece B, a two-row grid, small and odd capacities, a small card
SPAN_CASES = [
    (8, 8, 1024, H100_SMS),
    (256, 8, 1024, H100_SMS),
    (2, 8, 1024, H100_SMS),
    (8, 8, 100, H100_SMS),
    (1, 1, 1056, H100_SMS),
    (3, 2, 128, H100_SMS),
    (8, 8, 1024, 8),
    (1, 1, 16, H100_SMS),
    (1, 1, 0, H100_SMS),
]


@pytest.mark.parametrize("rows,heads,capacity,sms", SPAN_CASES)
def test_span_plan_covers_every_key_once(rows, heads, capacity, sms):
    spans, span_len = fa.decode_span_plan(rows, heads, capacity, sms)
    assert spans & (spans - 1) == 0 and 1 <= spans <= 32
    assert span_len % 32 == 0 and span_len >= 32
    keys = np.concatenate([np.arange(s * span_len,
                                     min((s + 1) * span_len, capacity))
                           for s in range(spans)])
    np.testing.assert_array_equal(keys, np.arange(capacity))
    # no span starts at or past the capacity (an idle warp)
    assert spans == 1 or (spans - 1) * span_len < capacity
    # more than one span only while the warps stay within the card's aim
    assert spans == 1 or rows * heads * spans <= 16 * sms
    ws = fa.decode_span_workspace(rows, heads, 128, spans)
    assert ws == (0 if spans <= 4
                  else rows * heads * (spans // 4) * (128 + 2))


def test_span_plan_fills_the_card_on_the_decode_grid():
    """The serve's decode grid (8 rows x 8 heads, capacity 1024) takes 32
    spans of one tile, 2048 warps; the chunk's 256 rows keep one span a
    row (they fill the card already) and need no workspace."""
    assert fa.decode_span_plan(8, 8, 1024, H100_SMS) == (32, 32)
    assert fa.decode_span_workspace(8, 8, 128, 32) == 64 * 8 * 130
    assert fa.decode_span_plan(256, 8, 1024, H100_SMS) == (1, 1024)
    assert fa.decode_span_workspace(256, 8, 128, 1) == 0


def _pools(rng, page_size, quantized, num_pages=12, heads=2, hd=16):
    shape = (num_pages, heads, page_size, hd)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (0.02 * (1 + rng.random((num_pages, heads)))).astype(np.float32)
        vs = (0.02 * (1 + rng.random((num_pages, heads)))).astype(np.float32)
        return k, v, ks, vs
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32), None, None)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("page_size,spans,span_len", [
    (16, None, None),  # the plan's: 4 spans of 32 at capacity 128
    (24, None, None),  # spans of 32 ending mid-page
    (24, 2, 96),  # a span of 96 keys over 4 pages
    (16, 8, 32),  # more spans than live keys need
])
def test_split_read_matches_jax(page_size, quantized, spans, span_len):
    """Slot 0 live over 5 pages but the last key, slot 1 dead (its
    bound reaches unmapped sentinel entries), slot 2 a row shorter than
    one span, slot 3 empty: o and lse of the merged spans against the
    JAX kernel."""
    rng = np.random.default_rng(page_size + 3 * quantized)
    k, v, ks, vs = _pools(rng, page_size, quantized)
    heads, hd = k.shape[1], k.shape[3]
    pps = -(-128 // page_size)
    cap = pps * page_size
    table = np.full((4, pps), k.shape[0], np.int32)
    table[0, :5] = [3, 7, 0, 11, 5]
    table[1, :2] = [1, 9]
    table[2, :1] = [4]
    lengths = np.array([5 * page_size - 1, cap, 7, 0], np.int32)
    q = rng.standard_normal((4, heads, hd)).astype(np.float32)
    scale = 0.3
    if spans is None:
        spans, span_len = fa.decode_span_plan(4, heads, cap, H100_SMS)
        assert spans > 1 and span_len < cap
    jo, jlse = jax_decode_paged(
        _j(q.reshape(4 * heads, 1, hd)), _j(k), _j(v), _j(table),
        _j(lengths), scale, k_scale=_j(ks), v_scale=_j(vs), return_lse=True)
    o, lse = fa.decode_paged_spans_plain(
        _t(q), _t(k), _t(v), _t(table), _t(lengths), scale, spans, span_len,
        _t(ks), _t(vs))
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jo).reshape(4, heads, hd), **TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jlse).reshape(4, heads), **TOL)
    assert np.all(o[3].numpy() == 0) and np.all(lse[3].numpy() == -1e30)


def test_split_read_with_slot_ids_matches_the_plain_read():
    """Rows naming their slots (the chunk's form), pads out of range:
    the merged spans equal the one-pass plain read."""
    rng = np.random.default_rng(5)
    k, v, _, _ = _pools(rng, 16, False)
    table = np.full((3, 8), k.shape[0], np.int32)
    table[0, :4] = [2, 6, 10, 1]
    table[2, :2] = [8, 0]
    lengths = np.array([61, 0, 20], np.int32)
    ids = np.array([2, 0, 3, 0, -1, 2], np.int32)
    q = rng.standard_normal((6, 2, 16)).astype(np.float32)
    args = (_t(q), _t(k), _t(v), _t(table), _t(lengths), 0.25)
    o, lse = fa.decode_paged_spans_plain(*args, 4, 32, slot_ids=_t(ids))
    ro, rlse = fa.flash_attention_decode_paged_plain(*args,
                                                     slot_ids=_t(ids))
    np.testing.assert_allclose(o.numpy(), ro.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), **TOL)
    assert np.all(o[[2, 4]].numpy() == 0)


def test_merge_drops_empty_partials_exactly():
    """A span that attended nothing (m = -1e30, l = 0, acc = 0) changes no
    bit of the merge; all empty gives zeros and lse = -1e30."""
    rng = np.random.default_rng(9)
    m = torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32))
    l = torch.from_numpy(rng.random((3, 2)).astype(np.float32) + 0.5)
    acc = torch.from_numpy(rng.standard_normal((3, 2, 8)).astype(np.float32))
    o, lse = fa.merge_span_partials_plain(m, l, acc)
    pad = torch.full((3, 1), -1e30)
    o2, lse2 = fa.merge_span_partials_plain(
        torch.cat([m[:, :1], pad, m[:, 1:]], 1),
        torch.cat([l[:, :1], torch.zeros(3, 1), l[:, 1:]], 1),
        torch.cat([acc[:, :1], torch.zeros(3, 1, 8), acc[:, 1:]], 1))
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o3, lse3 = fa.merge_span_partials_plain(
        torch.full((2, 4), -1e30), torch.zeros(2, 4), torch.zeros(2, 4, 8))
    assert torch.equal(o3, torch.zeros(2, 8))
    assert torch.equal(lse3, torch.full((2,), -1e30))


# ---------------------------------------------------------------------------
# the 3x3 backward
# ---------------------------------------------------------------------------

# (name, n, H = W, Cin, Cout): ResNet-50's five stride-1 3x3s at B 128,
# and the ragged shapes of chip_smoke.py's bottleneck group
CONV3_SHAPES = [
    ("layer1", 128, 56, 64, 64),
    ("layer2", 128, 28, 128, 128),
    ("layer3", 128, 14, 256, 256),
    ("layer4", 128, 7, 512, 512),
    ("ragged M", 3, 7, 64, 64),
    ("ragged split", 3, 13, 128, 128),
    ("W 2", 4, 2, 64, 64),
    ("fp32 parity", 8, 14, 64, 64),
]


@pytest.mark.parametrize("name,n,h,cin,cout", CONV3_SHAPES)
def test_conv3_plan_tiles_and_buffers(name, n, h, cin, cout):
    m = n * h * h
    plan = fb.conv3_bwd_plan(m, cin, cout, torch.bfloat16, H100_SMS)
    rows, cols = plan["wgrad_grid"][:2]
    bn = 128 if cout % 128 == 0 else 64
    # the wgrad's output rows are the 9 Cin (tap, cin) pairs
    assert (rows - 1) * 128 < 9 * cin <= rows * 128
    assert (cols - 1) * bn < cout <= cols * bn
    assert plan["dgrad_grid"] == (-(-m // 128),
                                  -(-cin // (128 if cin % 128 == 0 else 64)),
                                  1)
    # pixel splits: whole 64-pixel chunks, every pixel in one split
    split_len, splits = plan["split_len"], plan["splits"]
    assert split_len % 64 == 0 and 1 <= splits <= 256
    assert (splits - 1) * split_len < m <= splits * split_len
    assert plan["wgrad_grid"][2] == splits
    # the blocks the splits aim at, a multiprocessor
    blocks = rows * cols * splits
    per_sm = fb._PIPE_WGRAD_BLOCKS_PER_SM
    assert splits == 1 or blocks <= per_sm * H100_SMS + rows * cols
    assert plan["ws"] == (splits, 9 * cin, cout)
    assert plan["dz"] == (m, cout) and plan["u"] == (m, cin)
    # tiles fuller than one tap a tile: at Cin 64, 576 of 640 rows
    fill = 9 * cin / (rows * 128)
    assert fill >= cin / (-(-cin // 128) * 128)
    if cin == 64:
        assert fill == 0.9


def test_conv3_plan_ragged_split_falls_inside_an_image_row():
    """chip_smoke.py's ragged split case (3 x 13 x 13): a split boundary
    falls inside an image row, so a split's first pixels take taps whose
    sources lie in the previous split's rows."""
    m, w = 3 * 13 * 13, 13
    plan = fb.conv3_bwd_plan(m, 128, 128, torch.bfloat16, H100_SMS)
    cuts = [s * plan["split_len"] for s in range(1, plan["splits"])]
    assert cuts and any(c % w for c in cuts)


def test_conv3_plan_fp32_keeps_the_staged_sizes():
    m, cin, cout = 8 * 14 * 14, 64, 64
    plan = fb.conv3_bwd_plan(m, cin, cout, torch.float32, H100_SMS)
    split_len, splits = fb._wgrad_splits(m, 9, torch.float32, H100_SMS)
    assert (plan["split_len"], plan["splits"]) == (split_len, splits)
    assert plan["ws"] == (splits, 9 * cin, cout)
    assert plan["wgrad_grid"] == (1, 1, 9 * splits)
    assert plan["dz"] is None and plan["u"] is None


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_finalize", [True, False])
def test_prepass_plain_is_bit_equal_to_the_staged_forms(dt, with_finalize):
    """dz and u as the pre-pass rounds them equal `_finalized` and
    `_apply_dt` bit for bit: the products read the values they read when
    each tile recomputed them."""
    rng = np.random.default_rng(21)

    def draw(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (shift + scale * rng.standard_normal(shape)).astype(np.float32))

    m, cin, cout = 300, 32, 48
    e = (1e-2 * draw(m, cout)).to(dt)
    y = draw(m, cout).to(dt)
    x = draw(m, cin).to(dt)
    k = (draw(cout, scale=0.1, shift=1.0), draw(cout, scale=1e-3),
         draw(cout, scale=1e-3))
    a, b = draw(cin, scale=0.1, shift=1.0), draw(cin, scale=0.1)
    y_fin = (y, *k) if with_finalize else None
    dz, u = fb.conv3_bwd_prepass_plain(e, y_fin, x, (a, b))
    assert u.dtype == dt and torch.equal(u, fb._apply_dt(x, a, b))
    if with_finalize:
        ref = fb._finalized(e, None, y_fin)
        assert dz.dtype == dt and torch.equal(dz, ref)
    else:
        assert dz is None


# ---------------------------------------------------------------------------
# the 3x3 forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n,h,cin,cout", CONV3_SHAPES[:7])
def test_conv3_fwd_plan_routes_tiles_and_buffers(name, n, h, cin, cout):
    """bf16 at multiples of 64 channels takes the pipe: tiles of 128
    pixels x 128 channels where Cout divides by 128, else 64, the grid
    covering M and Cout once; one (Σy, Σy²) partial a 128-pixel tile; u
    the pre-pass's (M, Cin) rows."""
    m = n * h * h
    plan = fb.conv3_fwd_plan(m, cin, cout, torch.bfloat16, H100_SMS)
    assert plan["route"] == "pipe"
    bn = plan["bn"]
    assert bn == (128 if cout % 128 == 0 else 64)
    rows, cols, depth = plan["grid"]
    assert depth == 1 and cols * bn == cout
    assert (rows - 1) * 128 < m <= rows * 128
    assert plan["parts"] == (-(-m // 128), 2 * cout)
    assert plan["u"] == (m, cin)


def test_conv3_fwd_plan_fills_layer4_with_wide_tiles():
    """layer4's 49 pixel tiles x 4 tiles of 128 channels: 196 blocks, of
    the 264 a wave of two a multiprocessor holds."""
    plan = fb.conv3_fwd_plan(128 * 7 * 7, 512, 512, torch.bfloat16, H100_SMS)
    assert plan["grid"] == (49, 4, 1) and plan["bn"] == 128


@pytest.mark.parametrize("cin,cout,dt", [
    (48, 48, torch.bfloat16), (48, 80, torch.bfloat16),
    (16, 32, torch.bfloat16), (64, 80, torch.bfloat16),
    (64, 64, torch.float32), (256, 256, torch.float32)])
def test_conv3_fwd_plan_sends_other_widths_and_fp32_to_the_staged_core(
        cin, cout, dt):
    m = 3 * 7 * 7
    plan = fb.conv3_fwd_plan(m, cin, cout, dt, H100_SMS)
    assert plan["route"] == "staged" and plan["bn"] == 0
    assert plan["u"] is None
    tm, tn = fb._TILE_M[dt], fb._TILE_N[dt]
    rows, cols, _ = plan["grid"]
    assert (rows - 1) * tm < m <= rows * tm
    assert (cols - 1) * tn < cout <= cols * tn
    assert plan["parts"] == (rows, 2 * cout)


def _conv3_inputs(seed, shape, cin, cout, dt):
    rng = np.random.default_rng(seed)

    def draw(*s, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (shift + scale * rng.standard_normal(s)).astype(np.float32))

    # b > 0: relu(b) != 0, so a pre-pass that padded x rather than u, or
    # an inline prologue on a zero-filled edge tap, would show at every
    # image edge
    return (draw(*shape, cin).to(dt), draw(3, 3, cin, cout, scale=0.3),
            draw(cin, scale=0.2, shift=1.0), draw(cin, scale=0.1,
                                                  shift=0.5).abs())


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_conv3_fwd_chain_is_bit_equal_to_the_prologue_form(dt):
    """The pre-pass's u, then the bare 3x3 (zero padding of u), gives the
    prologue form's y and sums bit for bit: the pipe's products see what
    the staged core's do."""
    x, w, a, b = _conv3_inputs(51, (2, 6, 7), 32, 48, dt)
    u = fb.conv3_fwd_prepass_plain(x, a, b)
    assert u.dtype == dt and torch.equal(u, fb._apply_dt(x, a, b))
    y, sums = fb.conv3x3_bn_act_plain(u, w)
    ry, rsums = fb.conv3x3_bn_act_plain(x, w, a, b)
    assert torch.equal(y, ry)
    assert torch.equal(sums[0], rsums[0]) and torch.equal(sums[1], rsums[1])


def test_conv3_fwd_chain_matches_jax():
    """The pipe's chain in plain PyTorch against the JAX package's
    `conv3x3_bn_act` (`_conv3_fwd_kernel` in interpret mode) at fp32 on a
    3 x 5 x 5 map, b > 0: y at test_torch_fused_bottleneck.py's 1e-5, the
    sums within 1e-4 of their largest |value|."""
    from rocm_apex_tpu.ops import fused_bottleneck as jfb

    x, w, a, b = _conv3_inputs(52, (3, 5, 5), 16, 32, torch.float32)
    assert float(b.min()) > 0
    u = fb.conv3_fwd_prepass_plain(x, a, b)
    y, sums = fb.conv3x3_bn_act_plain(u, w)
    jy, jsums = jfb.conv3x3_bn_act(*(jnp.asarray(t.numpy())
                                     for t in (x, w, a, b)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for got, ref in zip(sums, jsums):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0.0,
                                   atol=1e-4 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the 1x1 backward
# ---------------------------------------------------------------------------

# (block, n, H = W, Cin, Cmid, Cout): ResNet-50's five stride-1 blocks at
# B 128 and chip_smoke.py's ragged M; each block's three 1x1 backwards
# as (form, K, N): conv3 (w3 (Cmid, Cout)), conv1 (w1 (Cin, Cmid)), the
# downsample (wd (Cin, Cout))
MM_BLOCKS = [
    ("layer1_0", 128, 56, 64, 64, 256),
    ("layer1_1", 128, 56, 256, 64, 256),
    ("layer2", 128, 28, 512, 128, 512),
    ("layer3", 128, 14, 1024, 256, 1024),
    ("layer4", 128, 7, 2048, 512, 2048),
    ("ragged M", 3, 7, 64, 64, 256),
]
MM_CASES = [(f"{b} {form}", n * h * h, k, nn)
            for b, n, h, cin, cmid, cout in MM_BLOCKS
            for form, k, nn in (("conv3", cmid, cout), ("conv1", cin, cmid),
                                ("downsample", cin, cout))]


@pytest.mark.parametrize("name,m,k,n", MM_CASES)
def test_mm_plan_tiles_splits_and_buffers(name, m, k, n):
    plan = fb.mm_bwd_plan(m, k, n, torch.bfloat16, H100_SMS)
    assert plan["route"] == "pipe"
    bk = 128 if k % 128 == 0 else 64
    bn = 128 if n % 128 == 0 else 64
    assert plan["dgrad_grid"] == (-(-m // 128), k // bk, 1)
    rows, cols, splits = plan["wgrad_grid"]
    assert (rows, cols) == (-(-k // 128), n // bn)
    # pixel splits: whole 64-pixel chunks, every pixel in one split
    split_len = plan["split_len"]
    assert split_len % 64 == 0 and 1 <= splits == plan["splits"] <= 256
    assert (splits - 1) * split_len < m <= splits * split_len
    # about 3 blocks a multiprocessor, at least the 2 resident ones,
    # unless the cap of 256 ranges or the pixels bind
    blocks = rows * cols * splits
    assert blocks <= 3 * H100_SMS + rows * cols
    assert blocks >= 2 * H100_SMS or splits >= 250 or m <= 64 * splits
    assert plan["ws"] == (splits, k, n)
    assert plan["dz"] == (m, n) and plan["u"] == (m, k)


def test_mm_plan_split_cap_binds_on_one_output_tile():
    """layer1_0's conv1 dw is 64 x 64, one output tile: the 256-range cap
    leaves 251 ranges of 1600 pixels, not the 396 that 3 blocks a
    multiprocessor would ask."""
    plan = fb.mm_bwd_plan(128 * 56 * 56, 64, 64, torch.bfloat16, H100_SMS)
    assert plan["wgrad_grid"] == (1, 1, 251)
    assert (plan["split_len"], plan["splits"]) == (1600, 251)


@pytest.mark.parametrize("k,n", [(48, 80), (64, 80), (48, 256), (16, 16),
                                 (96, 64)])
def test_mm_plan_sends_widths_off_the_pipe_to_the_staged_core(k, n):
    """A channel count that is not a multiple of 64 (the pipe's chunk and
    narrowest tile) takes the staged core, sized as it always was; so
    does fp32 at any width."""
    m = 3 * 7 * 7
    for dt in (torch.bfloat16, torch.float32):
        plan = fb.mm_bwd_plan(m, k, n, dt, H100_SMS)
        assert plan["route"] == "staged"
        assert plan["dz"] is None and plan["u"] is None
        split_len, splits = fb._wgrad_splits(
            m, -(-k // fb._TILE_M[dt]) * -(-n // fb._TILE_N[dt]), dt,
            H100_SMS)
        assert (plan["split_len"], plan["splits"]) == (split_len, splits)
        assert plan["ws"] == (splits, k, n)
        assert plan["dgrad_grid"] == (-(-m // fb._TILE_M[dt]),
                                      -(-k // fb._TILE_N[dt]), 1)
    assert fb.mm_bwd_plan(m, 64, 128, torch.float32,
                          H100_SMS)["route"] == "staged"


def _mm_inputs(seed, m, k, n, dt):
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (shift + scale * rng.standard_normal(shape)).astype(np.float32))

    return dict(
        e=(1e-2 * draw(m, n)).to(dt), z=draw(m, n).to(dt),
        y=draw(m, n).to(dt), x=draw(m, k).to(dt), w=draw(k, n, scale=0.3),
        k=(draw(n, scale=0.1, shift=1.0), draw(n, scale=1e-3),
           draw(n, scale=1e-3)),
        a=draw(k, scale=0.2, shift=1.0), b=draw(k, scale=0.2),
        mu=draw(k, scale=0.1), rs=draw(k, scale=0.2, shift=1.0).abs())


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("premask,finalize,prologue", [
    (True, True, True), (False, True, False), (True, True, False),
    (False, False, True), (False, False, False)])
def test_mm_prepass_plain_is_bit_equal_to_the_plain_backward(
        dt, premask, finalize, prologue):
    """dz is `_finalized` bit for bit, and u is the fp32 prologue rounded
    once, as `conv1x1_bn_act_bwd_plain` forms it (its wgrad with u, over
    the same dz, is the plain backward's dw bit for bit); a call with no
    pre-mask and no finalize writes no dz, one with no prologue no u."""
    t = _mm_inputs(31, 300, 32, 48, dt)
    z = t["z"] if premask else None
    y_fin = (t["y"], *t["k"]) if finalize else None
    pro = (t["a"], t["b"]) if prologue else None
    dz, u = fb.mm_bwd_prepass_plain(t["e"], z, y_fin, t["x"], pro)
    if premask or finalize:
        assert dz.dtype == dt
        assert torch.equal(dz, fb._finalized(t["e"], z, y_fin))
    else:
        assert dz is None
    if not prologue:
        assert u is None
        return
    s = t["x"].float() * t["a"] + t["b"]
    assert u.dtype == dt and torch.equal(u, torch.clamp_min(s, 0).to(dt))
    _, dw, _, _ = fb.conv1x1_bn_act_bwd_plain(
        t["e"], t["w"], t["x"], z, y_fin, pro, dgrad=False)
    dz = t["e"] if dz is None else dz
    assert torch.equal(u.float().t() @ dz.float(), dw)


def test_mm_prepass_keeps_a_positive_s_that_rounds_to_a_bf16_zero():
    """Why the dgrad's mask recomputes s in fp32: an s of 1e-41 is
    positive but rounds to a bf16 zero, so a mask by u > 0 would drop a
    gradient the fp32 prologue keeps."""
    x = torch.tensor([[1.0]], dtype=torch.bfloat16)
    a, b = torch.tensor([1e-41]), torch.tensor([0.0])
    _, u = fb.mm_bwd_prepass_plain(x, None, None, x, (a, b))
    assert float(x.float() * a + b) > 0 and float(u) == 0.0
    g, _, _, _ = fb.conv1x1_bn_act_bwd_plain(
        x, torch.ones((1, 1)), x, prologue=(a, b), wgrad=False)
    assert float(g) == 1.0


@pytest.mark.parametrize("form", ["conv3", "conv1", "downsample"])
def test_mm_pipe_chain_matches_jax(form):
    """The pipe's chain in plain PyTorch (the pre-pass, then g = dz w^T
    masked by the fp32 s > 0, dw = u^T dz, and the reductions of the
    masked g) against the JAX package's `conv1x1_bn_act_bwd`
    (`_mm_bwd_kernel` in interpret mode) at fp32, in the three flag sets a
    fused block calls: g at 1e-5, the sums over the pixels within 1e-4 of
    their largest |value|."""
    from rocm_apex_tpu.ops import fused_bottleneck as jfb

    m, k, n = 240, 64, 128
    t = _mm_inputs(41, m, k, n, torch.float32)
    z = t["z"] if form != "conv1" else None
    y_fin = (t["y"], *t["k"])
    pro = (t["a"], t["b"]) if form == "conv3" else None
    red = (t["mu"], t["rs"]) if form == "conv3" else None
    assert fb.mm_bwd_plan(m, k, n, torch.bfloat16, H100_SMS)["route"] == \
        "pipe"
    dz, u = fb.mm_bwd_prepass_plain(t["e"], z, y_fin, t["x"], pro)
    u = t["x"] if u is None else u
    gf = dz @ t["w"].t()
    if pro is not None:
        gf = torch.where(t["x"] * t["a"] + t["b"] > 0, gf, 0.0)
    dw = u.t() @ dz
    jouts = jfb.conv1x1_bn_act_bwd(
        *(jnp.asarray(t[i].numpy()) for i in ("e", "w", "x")),
        z=_j(None if z is None else z.numpy()),
        y_fin=tuple(jnp.asarray(v.numpy()) for v in y_fin),
        prologue=None if pro is None else tuple(
            jnp.asarray(v.numpy()) for v in pro),
        reduce_stats=None if red is None else tuple(
            jnp.asarray(v.numpy()) for v in red))
    np.testing.assert_allclose(gf.numpy(), np.asarray(jouts[0]), **TOL)
    outs = [dw]
    if red is not None:
        xhat = (t["x"] - red[0]) * red[1]
        outs += [gf.sum(0), (gf * xhat).sum(0)]
    else:
        assert jouts[2] is None and jouts[3] is None
    for got, ref in zip(outs, jouts[1:]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0.0,
                                   atol=1e-4 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the 1x1 forward
# ---------------------------------------------------------------------------

# every 1x1 forward of ResNet-50's 13 fused blocks at B 128, as (block,
# form, M, K, N): conv1 (Cin -> Cmid, bare), conv3 (Cmid -> Cout, under
# the bn2 prologue), and layer1_0's downsample (Cin -> Cout, bare); the
# blocks of one stage share their shapes
K1_BLOCKS = [("layer1_0", 56, 64, 64, 256, True),
             ("layer1_1,2", 56, 256, 64, 256, False),
             ("layer2_1..3", 28, 512, 128, 512, False),
             ("layer3_1..5", 14, 1024, 256, 1024, False),
             ("layer4_1,2", 7, 2048, 512, 2048, False)]
K1_CASES = [(f"{b} {form}", 128 * h * h, k, n, form == "conv3")
            for b, h, cin, cmid, cout, ds in K1_BLOCKS
            for form, k, n in (("conv1", cin, cmid), ("conv3", cmid, cout))
            + ((("downsample", cin, cout),) if ds else ())]


@pytest.mark.parametrize("name,m,k,n,prologue", K1_CASES)
def test_mm_fwd_plan_takes_the_pipe_at_every_block_shape(name, m, k, n,
                                                         prologue):
    """bf16 at multiples of 64 channels: tiles of 128 pixels x 128
    channels where N divides by 128, else 64; the grid covers M and N
    once; one (Σy, Σy²) partial row a 128-pixel tile; u the pre-pass's
    (M, K) rows only under a prologue."""
    plan = fb.mm_fwd_plan(m, k, n, torch.bfloat16, H100_SMS, prologue)
    assert plan["route"] == "pipe"
    bn = plan["bn"]
    assert bn == (128 if n % 128 == 0 else 64)
    rows, cols, depth = plan["grid"]
    assert depth == 1 and cols * bn == n
    assert (rows - 1) * 128 < m <= rows * 128
    assert plan["parts"] == (-(-m // 128), 2 * n)
    assert plan["u"] == ((m, k) if prologue else None)


def test_mm_fwd_plan_fills_layer4_with_wide_tiles():
    """layer4's conv1 (N 512): 49 pixel tiles x 4 tiles of 128 channels,
    196 blocks of the 264 a wave of two a multiprocessor holds."""
    plan = fb.mm_fwd_plan(128 * 7 * 7, 2048, 512, torch.bfloat16, H100_SMS)
    assert plan["grid"] == (49, 4, 1) and plan["bn"] == 128


@pytest.mark.parametrize("k,n,dt", [
    (48, 48, torch.bfloat16), (48, 80, torch.bfloat16),
    (16, 32, torch.bfloat16), (64, 80, torch.bfloat16),
    (64, 64, torch.float32), (256, 1024, torch.float32)])
def test_mm_fwd_plan_sends_other_widths_and_fp32_to_the_staged_core(k, n,
                                                                    dt):
    m = 3 * 7 * 7
    plan = fb.mm_fwd_plan(m, k, n, dt, H100_SMS)
    assert plan["route"] == "staged" and plan["bn"] == 0
    assert plan["u"] is None
    tm, tn = fb._TILE_M[dt], fb._TILE_N[dt]
    rows, cols, _ = plan["grid"]
    assert (rows - 1) * tm < m <= rows * tm
    assert (cols - 1) * tn < n <= cols * tn
    assert plan["parts"] == (rows, 2 * n)


def _mm_fwd_inputs(seed, m, k, n, dt):
    rng = np.random.default_rng(seed)

    def draw(*s, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (shift + scale * rng.standard_normal(s)).astype(np.float32))

    # b > 0: relu(b) != 0, so a padded row of u entering the sums would
    # show in both of them
    return (draw(m, k).to(dt), draw(k, n, scale=0.3),
            draw(k, scale=0.2, shift=1.0), draw(k, scale=0.1,
                                                shift=0.5).abs())


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_mm_fwd_chain_is_bit_equal_to_the_prologue_form(dt):
    """The pre-pass's u, then the bare 1x1, gives the prologue form's y
    and sums bit for bit: the pipe's products see what the staged core's
    do."""
    x, w, a, b = _mm_fwd_inputs(53, 147, 64, 128, dt)
    u = fb.conv3_fwd_prepass_plain(x, a, b)
    assert u.dtype == dt and torch.equal(u, fb._apply_dt(x, a, b))
    y, sums = fb.conv1x1_bn_act_plain(u, w)
    ry, rsums = fb.conv1x1_bn_act_plain(x, w, a, b)
    assert torch.equal(y, ry)
    assert torch.equal(sums[0], rsums[0]) and torch.equal(sums[1], rsums[1])


def test_mm_fwd_chain_matches_jax():
    """The pipe's chain in plain PyTorch against the JAX package's
    `conv1x1_bn_act` (`_mm_fwd_kernel` in interpret mode) at fp32 on a
    ragged M (147 pixels: no 128-pixel tile divides it), b > 0: y at
    test_torch_fused_bottleneck.py's 1e-5, the sums within 1e-4 of their
    largest |value|."""
    from rocm_apex_tpu.ops import fused_bottleneck as jfb

    m, k, n = 147, 64, 128
    x, w, a, b = _mm_fwd_inputs(54, m, k, n, torch.float32)
    assert float(b.min()) > 0 and m % 128
    assert fb.mm_fwd_plan(m, k, n, torch.bfloat16, H100_SMS)["route"] == \
        "pipe"
    u = fb.conv3_fwd_prepass_plain(x, a, b)
    y, sums = fb.conv1x1_bn_act_plain(u, w)
    jy, jsums = jfb.conv1x1_bn_act(*(jnp.asarray(t.numpy())
                                     for t in (x, w, a, b)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for got, ref in zip(sums, jsums):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0.0,
                                   atol=1e-4 * float(np.abs(ref).max()))


def test_conv3_fwd_plan_names_u_only_under_a_prologue():
    """The 3x3's plan, on the same rule: the bare form reads x itself."""
    m = 128 * 14 * 14
    assert fb.conv3_fwd_plan(m, 256, 256, torch.bfloat16, H100_SMS,
                             prologue=False)["u"] is None
    assert fb.conv3_fwd_plan(m, 256, 256, torch.bfloat16,
                             H100_SMS)["u"] == (m, 256)
