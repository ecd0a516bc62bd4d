"""The host-side plans of the register-row LayerNorm forward (row 1) and
backward (row 2) and the softmax forwards (row 12 K1 and K2), and their
plain versions against the JAX package, on the CPU.

- `ln_fwd_plan` (``csrc/layer_norm.cu``): every row once and every
  16-byte vector of a row once, at most 32 values a thread; a block a row
  at the serve's 8 and 264 rows, a warp a row at 4096 and 16384 rows of
  1024; widths off the vector grid, past the cap or at unaligned
  addresses on the three-pass kernel.
- `ln_bwd_plan`: the forward's layout by shape, its grid walking the
  rows at three blocks a multiprocessor, two in fp32 (every row once, a
  partial row a block), the old form off the vector grid.
- `softmax_fwd_plan` (``csrc/softmax.cu``): every column of a row once;
  the register row up to 2048 keys and the streaming one above, for the
  masked forward (K2) and the causal one (K1, no mask); the mask read as
  vectors only where its last stride is 1 and its rows are aligned; the
  backward (K3) keeps its one layout.
- The plain versions the kernels are held to on the card, against the
  JAX package's functions run as its own tests run them on the CPU (the
  Pallas kernels in interpret mode): the LN forward at the serve's tick
  shapes (8 and 264 rows of 1024, fp32, plain and residual, no dropout)
  and the masked softmax at (2, 2, 16, 512) fp32 under a padding mask
  whose padded queries are fully masked (uniform rows); the causal
  softmax (K1) against `scaled_upper_triang_masked_softmax` and the LN
  backward (row 2) against `_layer_norm_bwd`, both reaching their
  Pallas kernels (`_causal_fwd_kernel`, `_ln_bwd_kernel`). Inputs are
  numpy-drawn; both sides compute in fp32 and differ in summation order
  only: 1e-5 on LN outputs of order 1, 1e-6 on probabilities.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.ops import layer_norm as jln
from rocm_apex_tpu.ops import softmax as jsm
from rocm_apex_tpu_torch.ops import layer_norm as ln
from rocm_apex_tpu_torch.ops import softmax as sm

H100_SMS = 132
BF16, FP32 = torch.bfloat16, torch.float32

# ---------------------------------------------------------------------------
# ln_fwd_plan
# ---------------------------------------------------------------------------

# (rows, hidden, dtype): the serve's decode and mixed ticks and a single
# row, the training and BERT rows, a wide row, a tiny one
LN_SHAPES = [(8, 1024, BF16), (8, 1024, FP32), (264, 1024, BF16),
             (1, 1024, BF16), (4096, 1024, BF16), (16384, 1024, BF16),
             (16384, 1024, FP32), (8, 8192, BF16), (2048, 4096, FP32),
             (3, 64, FP32), (1100, 1000, BF16)]


def _ln_cover(plan, rows, hidden, vec):
    """The (row, column start) pairs the plan's threads hold: rows by
    block and warp, columns by vector j of thread t of a row."""
    if plan["route"] == "warp":
        per_block = plan["threads"] // 32
        held_rows = [b * per_block + w for b in range(plan["grid"])
                     for w in range(per_block) if b * per_block + w < rows]
    else:
        held_rows = list(range(plan["grid"]))
    row_threads = 32 * plan["row_warps"]
    cols = [(j * row_threads + t) * vec for j in range(plan["vectors"])
            for t in range(row_threads)]
    return held_rows, [c for c in cols if c < hidden]


@pytest.mark.parametrize("rows,hidden,dt", LN_SHAPES)
def test_ln_plan_holds_every_row_and_vector_once(rows, hidden, dt):
    plan = ln.ln_fwd_plan(rows, hidden, dt, H100_SMS)
    vec = 16 // torch.empty((), dtype=dt).element_size()
    assert plan["route"] in ("warp", "block")
    held_rows, cols = _ln_cover(plan, rows, hidden, vec)
    assert sorted(held_rows) == list(range(rows))
    assert sorted(cols) == list(range(0, hidden, vec))
    assert plan["vectors"] * vec <= 32  # the register cap
    assert plan["vectors"] & (plan["vectors"] - 1) == 0
    assert plan["threads"] <= 256


@pytest.mark.parametrize("rows,dt,route,row_warps", [
    (8, BF16, "block", 4), (264, BF16, "block", 4), (8, FP32, "block", 8),
    (1, BF16, "block", 4), (4096, BF16, "warp", 1), (16384, BF16, "warp", 1),
    (4096, FP32, "warp", 1), (16384, FP32, "warp", 1)])
def test_ln_plan_layout_follows_the_rows(rows, dt, route, row_warps):
    """Too few rows to fill the card spread each row over a block (one
    vector a thread); enough rows take a warp each."""
    plan = ln.ln_fwd_plan(rows, 1024, dt, H100_SMS)
    assert (plan["route"], plan["row_warps"]) == (route, row_warps)
    if route == "block":
        assert plan["vectors"] == 1 and plan["grid"] == rows
    else:
        assert plan["grid"] == rows // 4


@pytest.mark.parametrize("rows,hidden,dt,aligned", [
    (8, 1002, BF16, True),      # off the 8-element vector grid
    (8, 1002, FP32, True),      # off the 4-element grid
    (4096, 1020, BF16, True),
    (2, 16384, BF16, True),     # 64 values a thread at 8 warps
    (16384, 16384, FP32, True),
    (8, 1024, BF16, False),     # an unaligned address
])
def test_ln_plan_sends_other_widths_to_the_three_pass_kernel(
        rows, hidden, dt, aligned):
    plan = ln.ln_fwd_plan(rows, hidden, dt, H100_SMS, aligned)
    assert plan["route"] == "three_pass"
    assert (plan["row_warps"], plan["vectors"]) == (0, 0)
    assert plan["grid"] * plan["threads"] // 32 >= rows


def test_ln_plan_of_a_call_reads_its_addresses(monkeypatch):
    """The wrapper's plan: an input view 2 bytes off 16-byte alignment
    takes the three-pass kernel, the same shape aligned the register
    row."""
    monkeypatch.setattr(ln, "sm_count", lambda dev: H100_SMS)
    buf = torch.zeros(8 * 1024 + 8, dtype=BF16)
    w, b = torch.ones(1024), torch.zeros(1024)
    aligned = buf[:8 * 1024].view(8, 1024)
    shifted = buf[1:8 * 1024 + 1].view(8, 1024)
    assert ln._plan_of(aligned, None, w, b)["route"] == "block"
    assert ln._plan_of(shifted, None, w, b)["route"] == "three_pass"


# ---------------------------------------------------------------------------
# ln_bwd_plan
# ---------------------------------------------------------------------------

def _ln_bwd_rows(plan, rows):
    """The rows each block's row groups walk, block by block: groups g,
    g + groups, ... for the grid's row groups (a warp each on the warp
    route, a block each on the block route)."""
    per_block = plan["threads"] // (32 * plan["row_warps"])
    groups = plan["grid"] * per_block
    return [[r for w in range(per_block)
             for r in range(b * per_block + w, rows, groups)]
            for b in range(plan["grid"])]


@pytest.mark.parametrize("rows,hidden,dt", LN_SHAPES)
def test_ln_bwd_plan_walks_every_row_once(rows, hidden, dt):
    """The backward holds the forward's columns (`ln_fwd_plan`'s layout)
    and its grid walks every row once, a partial row a block, at most
    three blocks a multiprocessor (two in fp32)."""
    plan = ln.ln_bwd_plan(rows, hidden, dt, H100_SMS)
    fwd = ln.ln_fwd_plan(rows, hidden, dt, H100_SMS)
    for key in ("route", "row_warps", "vectors", "threads"):
        assert plan[key] == fwd[key], key
    walked = [r for block in _ln_bwd_rows(plan, rows) for r in block]
    assert sorted(walked) == list(range(rows))
    assert plan["parts"] == plan["grid"] <= 3 * H100_SMS


@pytest.mark.parametrize("rows,dt,route,row_warps,grid", [
    (8, BF16, "block", 4, 8),          # the serve's rows: a block a row
    (264, BF16, "block", 4, 264),
    (16384, BF16, "warp", 1, 396),     # the training rows: 41 rows a block
    (16384, FP32, "warp", 1, 264),     # fp32: two blocks a multiprocessor
    (4096, BF16, "warp", 1, 396),
    (600, FP32, "block", 8, 264)])
def test_ln_bwd_plan_layout_follows_the_rows(rows, dt, route, row_warps,
                                             grid):
    plan = ln.ln_bwd_plan(rows, 1024, dt, H100_SMS)
    assert (plan["route"], plan["row_warps"], plan["grid"]) == (
        route, row_warps, grid)


@pytest.mark.parametrize("rows,hidden,dt,aligned", [
    (8, 1002, BF16, True), (4096, 1020, BF16, True),
    (2, 16384, BF16, True), (8, 1024, BF16, False)])
def test_ln_bwd_plan_keeps_the_old_form_off_the_vector_grid(
        rows, hidden, dt, aligned):
    """Widths off the vector grid, past the register cap, or unaligned
    inputs: the old warp-a-row form, a partial row a 32-row block."""
    plan = ln.ln_bwd_plan(rows, hidden, dt, H100_SMS, aligned)
    assert (plan["route"], plan["row_warps"], plan["vectors"]) == (
        "three_pass", 0, 0)
    assert plan["grid"] == plan["parts"] == -(-rows // 32)


# ---------------------------------------------------------------------------
# softmax_fwd_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sk", [1, 7, 333, 512, 1000, 2047, 2048])
@pytest.mark.parametrize("dt", [FP32, BF16, torch.float16])
def test_softmax_plan_holds_each_row_in_registers_up_to_2048(sk, dt):
    plan = sm.softmax_fwd_plan(64, sk, dt, True, 1)
    assert plan["route"] == "register"
    vec = plan["vec"]
    kvec = 16 // torch.empty((), dtype=dt).element_size()
    assert vec == (kvec if sk % kvec == 0 else 1)
    cols = [(j * 32 + lane) * vec for j in range(plan["vectors"])
            for lane in range(32)]
    assert sorted(c for c in cols if c < sk) == list(range(0, sk, vec))
    assert plan["vectors"] * vec * 32 <= 2048  # at most 64 values a lane
    assert plan["grid"] == 8


@pytest.mark.parametrize("sk", [2049, 4096, 8192, 16384])
def test_softmax_plan_streams_longer_rows(sk):
    plan = sm.softmax_fwd_plan(64, sk, FP32, True, 1)
    assert (plan["route"], plan["vectors"], plan["grid"]) == (
        "streaming", 0, 64)
    assert plan["mask"] == "strided"


@pytest.mark.parametrize("mask_sk,mask_aligned,aligned,sk,form", [
    (1, True, True, 512, "vector"),
    (2, True, True, 512, "strided"),    # a sliced mask
    (0, True, True, 512, "strided"),    # broadcast over the keys
    (1, False, True, 512, "strided"),   # rows not vector-aligned
    (1, True, False, 512, "strided"),   # x unaligned: scalar loads
    (1, True, True, 333, "strided"),    # off the vector grid
    (None, False, True, 512, None),     # no mask
])
def test_softmax_plan_reads_the_mask_as_vectors_only_at_stride_1(
        mask_sk, mask_aligned, aligned, sk, form):
    plan = sm.softmax_fwd_plan(64, sk, FP32, True, mask_sk, aligned,
                               mask_aligned)
    assert plan["route"] == "register"
    assert plan["mask"] == form


def test_softmax_plan_names_no_route_for_k1_or_k3():
    """The backward (K3) keeps its one layout and takes no plan; the
    causal forward (K1), once planned apart from the masked one, now
    takes the masked forward's routes with no mask: a mask stride handed
    with ``masked`` False is not read."""
    for sk in (512, 1024, 4096):
        plan = sm.softmax_fwd_plan(128 * 1024, sk, FP32, False, 1)
        assert plan == sm.softmax_fwd_plan(128 * 1024, sk, FP32, True, None)
        assert plan["mask"] is None


@pytest.mark.parametrize("sk", [1, 7, 333, 1000, 1024, 2047, 2048])
@pytest.mark.parametrize("dt", [FP32, BF16, torch.float16])
def test_softmax_plan_holds_causal_rows_in_registers_up_to_2048(sk, dt):
    """K1's register route: every row of up to 2048 keys, a warp a row,
    each column held once, 16-byte vectors where the row allows them."""
    plan = sm.softmax_fwd_plan(128 * sk, sk, dt, False, None)
    kvec = 16 // torch.empty((), dtype=dt).element_size()
    assert (plan["route"], plan["mask"]) == ("register", None)
    assert plan["vec"] == (kvec if sk % kvec == 0 else 1)
    cols = [(j * 32 + lane) * plan["vec"] for j in range(plan["vectors"])
            for lane in range(32)]
    assert sorted(c for c in cols if c < sk) == list(range(0, sk,
                                                           plan["vec"]))
    assert plan["grid"] == 16 * sk


@pytest.mark.parametrize("sk,dt", [(2049, FP32), (4096, BF16),
                                   (8192, FP32), (16384, BF16)])
def test_softmax_plan_streams_causal_rows_past_2048(sk, dt):
    plan = sm.softmax_fwd_plan(4 * sk, sk, dt, False, None)
    assert (plan["route"], plan["vectors"], plan["grid"], plan["mask"]) == (
        "streaming", 0, 4 * sk, None)


def test_causal_plan_of_a_call_reads_its_address(monkeypatch):
    """The causal wrapper hands the kernel its plan's vec and vectors:
    an aligned (b, sq, sk) input takes 16-byte vectors, one a scalar a
    column; both on the register route at the GPT cell's 1024 keys."""
    seen = []
    monkeypatch.setattr(sm, "SOFTMAX_CAUSAL_FWD",
                        lambda *args: seen.append(args[6:8]))
    monkeypatch.setattr(sm, "_require_cuda", lambda x: None)
    dev = type("Dev", (), {"type": "cuda"})()

    class _X:  # a CUDA-looking (2, 1024, 1024) fp32 tensor at an address
        def __init__(self, addr):
            self.addr, self.shape, self.dtype = addr, (2, 1024, 1024), FP32
            self.device = dev

        def dim(self):
            return 3

        def contiguous(self):
            return self

        def data_ptr(self):
            return self.addr

    monkeypatch.setattr(sm.torch, "empty_like",
                        lambda x: torch.zeros(1))
    monkeypatch.setattr(sm, "ptr", lambda t: 0)
    monkeypatch.setattr(sm, "stream_ptr", lambda d: 0)
    sm.softmax_causal_fwd(_X(256), 0.125)
    sm.softmax_causal_fwd(_X(260), 0.125)
    assert seen == [(4, 8), (1, 32)]


def test_softmax_plan_of_a_call_reads_its_mask_and_addresses():
    x = torch.zeros(2, 4, 64, 512)
    full = torch.zeros(2, 1, 64, 1024, dtype=torch.bool)
    contiguous = sm._expand_mask(full[..., :512].contiguous(), x)
    sliced = sm._expand_mask(full[..., ::2], x)
    keys = sm._expand_mask(torch.zeros(2, 1, 1, 512, dtype=torch.bool), x)
    assert sm._masked_plan_of(x, contiguous)["mask"] == "vector"
    assert sm._masked_plan_of(x, keys)["mask"] == "vector"
    assert sm._masked_plan_of(x, sliced)["mask"] == "strided"
    assert sm._masked_plan_of(x, None)["mask"] is None
    shifted = torch.zeros(2 * 4 * 64 * 512 + 1)[1:].view(2, 4, 64, 512)
    plan = sm._masked_plan_of(shifted, contiguous)
    assert (plan["vec"], plan["mask"]) == (1, "strided")


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

def _draw(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("rows", [8, 264])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_ln_forward_matches_jax_at_the_serve_ticks(rows, residual):
    h = 1024
    x = _draw((rows, h), rows)
    d = _draw((rows, h), rows + 1) if residual else None
    w = _draw((h,), 2, 0.1, 1.0)
    b = _draw((h,), 3, 0.1)
    got = ln._ln_fwd_impl(torch.from_numpy(x),
                          None if d is None else torch.from_numpy(d),
                          torch.from_numpy(w), torch.from_numpy(b), 1e-5,
                          torch.float32)
    want = jln._ln_fwd_impl(jnp.asarray(x),
                            None if d is None else jnp.asarray(d),
                            jnp.asarray(w), jnp.asarray(b), 1e-5,
                            jnp.float32)
    for name, g, j in zip(("y", "s", "mean", "rsigma"), got, want):
        if j is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_plain_masked_softmax_matches_jax_with_fully_masked_queries():
    b, h, sq, sk = 2, 2, 16, 512
    x = _draw((b, h, sq, sk), 7, 2.0)
    q_len, k_len = np.array([16, 9]), np.array([512, 300])
    live = ((np.arange(sq)[None, :, None] < q_len[:, None, None])
            & (np.arange(sk)[None, None, :] < k_len[:, None, None]))
    mask = ~live[:, None]  # (2, 1, 16, 512), True = masked
    got = sm.scaled_masked_softmax(torch.from_numpy(x),
                                   torch.from_numpy(mask), 0.125).numpy()
    want = np.asarray(jsm.scaled_masked_softmax(jnp.asarray(x),
                                                jnp.asarray(mask), 0.125))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    # batch 1's padded queries attend uniformly over all 512 keys
    np.testing.assert_allclose(got[1, :, 9:], 1.0 / sk, rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0.0, atol=1e-5)


def test_plain_causal_softmax_matches_jax():
    """K1's plain version against JAX `scaled_upper_triang_masked_softmax`
    (`_causal_fwd_kernel` in interpret mode): fp32 at sq = sk = 256, the
    upper triangle exactly 0."""
    x = _draw((2, 256, 256), 11, 2.0)
    got = sm.scaled_upper_triang_masked_softmax(torch.from_numpy(x),
                                                0.125).numpy()
    want = np.asarray(jsm.scaled_upper_triang_masked_softmax(
        jnp.asarray(x), 0.125))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    assert not got[:, np.triu_indices(256, 1)[0],
                   np.triu_indices(256, 1)[1]].any()


@pytest.mark.parametrize("rows", [8, 264])
@pytest.mark.parametrize("with_ds", [False, True])
def test_plain_ln_backward_matches_jax(rows, with_ds):
    """Row 2's plain version (`layer_norm_bwd_plain`) against JAX
    `_layer_norm_bwd` (`_ln_bwd_kernel` in interpret mode), affine, with
    and without the stream's cotangent ds, fp32: dx within 1e-5, dgamma
    and dbeta within 1e-5 of their L1 mass (sums over the rows in
    another order)."""
    h = 1024
    x = torch.from_numpy(_draw((rows, h), rows, 1.0, 0.5))
    w = torch.from_numpy(_draw((h,), 2, 0.1, 1.0))
    dy = torch.from_numpy(_draw((rows, h), rows + 1))
    ds = torch.from_numpy(_draw((rows, h), rows + 2)) if with_ds else None
    mu = x.mean(dim=1)
    rs = torch.rsqrt(((x - mu[:, None]) ** 2).mean(dim=1) + 1e-5)
    dx, dd, dg, db = ln.layer_norm_bwd_plain(x, dy, ds, mu, rs, w)
    assert dd is None
    jdx, jdg, jdb = jln._layer_norm_bwd(
        True, 1e-5, (jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                     jnp.asarray(mu.numpy()), jnp.asarray(rs.numpy())),
        jnp.asarray(dy.numpy()),
        ds=None if ds is None else jnp.asarray(ds.numpy()))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    xh = (x - mu[:, None]) * rs[:, None]
    for got, want, mass in ((dg, jdg, (dy * xh).abs().sum(0)),
                            (db, jdb, dy.abs().sum(0))):
        assert np.all(np.abs(got.numpy() - np.asarray(want))
                      <= 1e-5 * mass.numpy() + 1e-6)
