"""The host-side plans of the register-row LayerNorm forward (row 1) and
masked softmax forward (row 12 K2), and their plain versions against the
JAX package, on the CPU.

- `ln_fwd_plan` (``csrc/layer_norm.cu``): every row once and every
  16-byte vector of a row once, at most 32 values a thread; a block a row
  at the serve's 8 and 264 rows, a warp a row at 4096 and 16384 rows of
  1024; widths off the vector grid, past the cap or at unaligned
  addresses on the three-pass kernel.
- `softmax_fwd_plan` (``csrc/softmax.cu``): every column of a row once;
  the register row up to 2048 keys and the streaming one above; the
  mask read as vectors only where its last stride is 1 and its rows are
  aligned; no route for the causal forward (K1) or the backward (K3).
- The plain versions the kernels are held to on the card, against the
  JAX package's functions run as its own tests run them on the CPU (the
  Pallas kernels in interpret mode): the LN forward at the serve's tick
  shapes (8 and 264 rows of 1024, fp32, plain and residual, no dropout)
  and the masked softmax at (2, 2, 16, 512) fp32 under a padding mask
  whose padded queries are fully masked (uniform rows). Inputs are
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
    """The causal forward (K1) and the backward (K3) keep their one
    layout: the plan names nothing for them."""
    for sk in (512, 1024, 4096):
        assert sm.softmax_fwd_plan(128 * 1024, sk, FP32, False,
                                   None) == dict(route=None)


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
