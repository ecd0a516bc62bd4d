"""fp16 through every module that holds a kernel, against the JAX package
in fp16 on the CPU.

amp O1, O2 and O3 compute in fp16 (rocm_apex_tpu/amp/frontend.py). On the
CPU the JAX kernels take fp16 operands as they are (ops/_pallas.py
`kernel_dtype` up-casts on a TPU only), and the port's kernels take fp16
wherever they take bf16 (csrc: an f16 instance of every 2-byte kernel,
wgmma and mma.sync ``.f16``). Here, on numpy-drawn inputs rounded to fp16
at tiny shapes, each module's plain version (what its wrapper runs on the
CPU and what its kernel is held to on the card) in fp16 against the JAX
function in fp16, its Pallas kernels in interpret mode:

- rows 1/2 (LayerNorm forward, residual, backward), 12 (the scaled
  softmaxes), 13 (cross-entropy), 14 (the multi-tensor passes, the
  nonfinite flag on fp16 inf and nan), 15 (a packed update on fp16
  gradients), 16 (the LAMB leaf stages on fp16 gradients with an fp16
  compute copy), 17 (the four bottleneck ops), each within one fp16 step
  (2^-10 of the value) plus 1e-3 of the output's scale where the two sides
  sum fp16-rounded terms in another order (`HALF`), and fp32 outputs
  within 1e-5 relative (`F32`); the bottleneck's dgrads but for the ReLU
  flips `FLIP_SHARE` explains;
- the attention rows 3-11 by the measure of tests/test_torch_p_rounding.py
  in fp16's precision: at most 0.1% of the elements with |x| > 1e-2
  beyond one fp16 step, lse within 1e-5 + 1e-6 |lse|, JAX run at the
  port's frame;
- `dtype_code(float16) == 2`, and every plan routing fp16 as it routes
  bf16;
- a 2-layer GPT's O2 step (fp32 params, fp16 compute): loss within 1e-3
  relative and every gradient within 1e-2 of its leaf's largest entry of
  JAX's (fp16 matmuls summed in another order); and the fp16 engine's
  greedy tokens identical to the JAX engine's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocm_apex_tpu.ops.fused_bottleneck as jfb
from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.ops import flash_attention as jfa
from rocm_apex_tpu.ops import flash_attention_segments as jfs
from rocm_apex_tpu.ops import layer_norm as jln
from rocm_apex_tpu.ops import multi_tensor as jmt
from rocm_apex_tpu.ops import optim_kernels as jok
from rocm_apex_tpu.ops import packing as jpk
from rocm_apex_tpu.ops import softmax as jsm
from rocm_apex_tpu.ops import xentropy as jx
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
)
from rocm_apex_tpu_torch.inference import InferenceEngine, SamplingParams
from rocm_apex_tpu_torch.models.gpt import GPTConfig
from rocm_apex_tpu_torch.ops import flash_attention as fa
from rocm_apex_tpu_torch.ops import flash_attention_segments as fas
from rocm_apex_tpu_torch.ops import fused_bottleneck as fb
from rocm_apex_tpu_torch.ops import layer_norm as tln
from rocm_apex_tpu_torch.ops import multi_tensor as tmt
from rocm_apex_tpu_torch.ops import optim_kernels as tok
from rocm_apex_tpu_torch.ops import packing as tpk
from rocm_apex_tpu_torch.ops import softmax as tsm
from rocm_apex_tpu_torch.ops import xentropy as tx
from rocm_apex_tpu_torch.ops._build import DTYPE_CODES, dtype_code, half_float

F16 = torch.float16
STEP = 2.0 ** -10  # one fp16 step, relative
HALF = dict(rtol=STEP, atol=1e-3)
F32 = dict(rtol=1e-5, atol=1e-6)
SHARE = 1e-3  # at most 0.1% of the elements beyond one fp16 step
FWD_FRAME, ROW_FRAME = 64, 32
GRAD_SHARE = 1e-2
LOSS_RTOL = 1e-3


def _h(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))).to(F16)


def _j(t):
    """A torch tensor as a JAX array of the same dtype."""
    return None if t is None else jnp.asarray(t.numpy())


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _np(t):
    return (t.detach().float().numpy() if torch.is_tensor(t)
            else np.asarray(t, np.float32))


def _close(got, ref, tol=HALF, scale=None, what=""):
    """|got - ref| <= atol * scale + rtol |ref|, scale the largest |ref|
    (the terms an fp16 output sums) where ``scale`` is not given."""
    got, ref = _np(got), _np(ref)
    s = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=tol["rtol"],
                               atol=tol["atol"] * max(s, 1e-30),
                               err_msg=what)


# the bottleneck's ReLU masks: the port rounds the prologue's product and
# sum each to fp16 (the TPU kernels' rule, `prologue_dt`), while XLA on
# the CPU evaluates JAX's ``x * a + b`` in fp32 and rounds once, so a
# value within an fp16 step of 0 may land on the other side of the ReLU
# (an element of g masked on one side only: x -0.0716, a 1.147, b 0.0822
# give 0 rounded twice, 1.7e-6 fused); at most 0.5% of the elements
FLIP_SHARE = 5e-3


def _close_but_flips(got, ref, tol=HALF):
    """`_close`, but for at most FLIP_SHARE of the elements."""
    got, ref = _np(got), _np(ref)
    bound = tol["atol"] * float(np.abs(ref).max()) + tol["rtol"] * np.abs(ref)
    share = float((np.abs(got - ref) > bound).mean())
    assert share <= FLIP_SHARE, f"{100 * share:.3f}% beyond the tolerance"


def _off_share(got, ref):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    big = np.abs(ref) > 1e-2
    off = np.abs(got - ref) > STEP * np.abs(ref)
    return float((off & big).sum()) / max(int(big.sum()), 1)


def _attn_close(got, ref, what):
    share = _off_share(got, ref)
    assert share <= SHARE, f"{what}: {100 * share:.3f}% beyond one fp16 step"


def _lse_close(got, ref):
    got = np.asarray(got, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    err = np.abs(got - ref) - (1e-5 + 1e-6 * np.abs(ref))
    assert err.max() <= 0.0, f"lse off by {np.abs(got - ref).max():.3e}"


# ---------------------------------------------------------------------------
# the dtype table and the plans
# ---------------------------------------------------------------------------


def test_dtype_code_of_float16_is_the_kernels_code():
    """`csrc/common.cuh` kFloat16 = 2, in the one table every wrapper
    reads; fp16 is a 2-byte type like bf16, fp32 is not."""
    assert dtype_code(F16) == 2 and DTYPE_CODES[F16] == 2
    assert dtype_code(torch.bfloat16) == 1 and dtype_code(torch.float32) == 0
    assert half_float(F16) and half_float(torch.bfloat16)
    assert not half_float(torch.float32)
    with pytest.raises(TypeError, match="float16"):
        dtype_code(torch.float64)


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
def test_every_plan_routes_fp16_as_bf16(hd):
    """Each flash and bottleneck plan gives fp16 the plan of bf16 (the
    same route, grids, buffers and frames), the LayerNorm and softmax
    row plans too."""
    bf = torch.bfloat16
    pairs = [
        lambda dt: fa.flash_fwd_plan(8, 300, 300, hd, True, 132, dt),
        lambda dt: fa.flash_unpacked_bwd_plan(8, 300, 300, hd, True, dt),
        lambda dt: fa.flash_dbias_plan(2, 4, 300, 300, hd, False, dt),
        lambda dt: fas.flash_segments_plan(8, 1000, hd, dt),
        lambda dt: fas.flash_segments_serve_plan(8, 256, hd, dt),
        lambda dt: fas.flash_segments_serve_plan(8, 3000, hd, dt),
    ]
    if hd % 128 == 0:
        pairs.append(lambda dt: fa.flash_bwd_plan(2, 300, 4, hd, True, dt))
    for c in (64, 256, 48, 12):
        pairs += [lambda dt, c=c: fb.mm_fwd_plan(6272, c, 2 * c, dt, 132),
                  lambda dt, c=c: fb.conv3_fwd_plan(6272, c, c, dt, 132),
                  lambda dt, c=c: fb.mm_bwd_plan(6272, c, 2 * c, dt, 132),
                  lambda dt, c=c: fb.conv3_bwd_plan(6272, c, c, dt, 132),
                  lambda dt, c=c: fb.channel_plan((c, c), 6272, dt)]
    pairs += [lambda dt: tln.ln_fwd_plan(16384, 1024, dt, 132, True),
              lambda dt: tln.ln_bwd_plan(16384, 1024, dt, 132, True),
              lambda dt: tsm.softmax_fwd_plan(4096, 1024, dt, True, 1024)]
    for plan in pairs:
        assert plan(F16) == plan(bf)
    assert fa.flash_fwd_plan(8, 300, 300, hd, True, 132, F16)["route"] == \
        "wgmma"
    assert fas.flash_segments_plan(8, 1000, hd, F16)["route"] == "wgmma"


# ---------------------------------------------------------------------------
# rows 1, 2: LayerNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_forward_matches_jax(residual):
    """`layer_norm_fwd_plain` against JAX `_ln_fwd_impl` on fp16 x (and
    delta), fp16 weights and output (the O2 model's) and fp32 ones (the
    mixed contract): y in its dtype, s bit-equal, mean and rsigma fp32."""
    rng = np.random.default_rng(1 + residual)
    x = _h(rng, 24, 256)
    d = _h(rng, 24, 256) if residual else None
    w, b = _h(rng, 256, scale=0.1, shift=1.0), _h(rng, 256, scale=0.1)
    for wt, out in ((w, F16), (w.float(), torch.float32)):
        bt = b.to(wt.dtype)
        got = tln.layer_norm_fwd_plain(x, d, wt, bt, 1e-5, out)
        want = jln._ln_fwd_impl(_j(x), _j(d), _j(wt), _j(bt), 1e-5,
                                jnp.dtype(str(out)[6:]))
        assert got[0].dtype == out
        _close(got[0], want[0], HALF if out == F16 else F32, scale=1.0)
        if residual:
            assert torch.equal(got[1], _t(want[1]))
        for g, j in zip(got[2:], want[2:]):
            _close(g, j, F32, scale=1.0)


def test_layer_norm_backward_matches_jax():
    """`layer_norm_bwd_plain` against JAX `_layer_norm_bwd` with the
    stream cotangent, fp16: dx in fp16, dgamma and dbeta fp32 sums."""
    rng = np.random.default_rng(3)
    x, dy, ds = (_h(rng, 24, 256) for _ in range(3))
    w, b = _h(rng, 256, scale=0.1, shift=1.0), _h(rng, 256, scale=0.1)
    _, mu, rs = jln.layer_norm_fwd(_j(x), _j(w), _j(b), 1e-5)
    jdx, jdg, jdb = jln._layer_norm_bwd(True, 1e-5, (_j(x), _j(w), mu, rs),
                                       _j(dy), ds=_j(ds))
    dx, dd, dg, db = tln.layer_norm_bwd_plain(
        x, dy, ds, _t(mu), _t(rs), w)
    assert dx.dtype == F16 and dd is None
    _close(dx, jdx, HALF)
    _close(dg, jdg, HALF)
    _close(db, jdb, HALF)


# ---------------------------------------------------------------------------
# rows 3-11: attention, at the port's frames
# ---------------------------------------------------------------------------

B, S, NH, HD = 2, 192, 2, 128


@pytest.mark.parametrize("causal", [True, False])
def test_packed_forward_and_backward_match_jax(causal):
    """Rows 7a/8 and 9a/11: `flash_qkv_fwd_plain` against JAX
    `_fwd_packed` with the projection bias at block_k 64, then
    `flash_qkv_bwd_plain` against `_bwd_packed` on JAX's o and lse."""
    rng = np.random.default_rng(11 + causal)
    qkv, do = _h(rng, B, S, NH, 3 * HD), _h(rng, B, S, NH * HD)
    bias = _h(rng, NH * 3 * HD, scale=0.1)
    scale = 1.0 / math.sqrt(HD)
    jo, jlse = jfa._fwd_packed(_j(qkv), causal, scale, FWD_FRAME, FWD_FRAME,
                               qkv_bias=_j(bias))
    o, lse = fa.flash_qkv_fwd_plain(qkv, bias, causal, scale)
    assert o.dtype == F16
    _attn_close(o, _t(jo), "o")
    _lse_close(lse.numpy(), np.asarray(jlse)[..., 0])
    jd, _ = jfa._bwd_packed(causal, scale, FWD_FRAME, FWD_FRAME,
                            (_j(qkv), jo, jlse), _j(do), qkv_bias=_j(bias))
    dqkv, _ = fa.flash_qkv_bwd_plain(qkv, bias, _t(jo), _t(jlse)[..., 0],
                                     do, causal, scale)
    jd = _t(jd)
    for i, name in enumerate(("dq", "dk", "dv")):
        sl = slice(i * HD, (i + 1) * HD)
        _attn_close(dqkv[..., sl], jd[..., sl], name)


def test_unpacked_forward_backward_and_dbias_match_jax():
    """Rows 7b, 9b and 10: the unpacked forward with a padding bias
    against JAX `_fwd` at block_k 64, the backward with the bias gradient
    against `_bwd` on JAX's o and lse (dbias an fp32 sum)."""
    rng = np.random.default_rng(21)
    q, k, v, do = (_h(rng, 4, 160, HD) for _ in range(4))
    bias = torch.zeros(2, 160, 160)
    bias[1, :, 101:] = -1e30
    bias[0] += 0.1 * torch.from_numpy(
        rng.standard_normal((160, 160)).astype(np.float32))
    scale = 1.0 / math.sqrt(HD)
    jo, jlse = jfa._fwd(_j(q), _j(k), _j(v), _j(bias), False, scale,
                        FWD_FRAME, FWD_FRAME)
    o, lse = fa.flash_unpacked_fwd_plain(q, k, v, bias, False, scale)
    _attn_close(o, _t(jo), "o")
    _lse_close(lse.numpy(), np.asarray(jlse))
    jdq, jdk, jdv, jdb = jfa._bwd(
        False, scale, FWD_FRAME, FWD_FRAME,
        (_j(q), _j(k), _j(v), _j(bias), jo, jlse), _j(do),
        compute_dbias=True)
    dq, dk, dv, db = fa.flash_unpacked_bwd_plain(
        q, k, v, bias, _t(jo), _t(jlse), do, False, scale,
        compute_dbias=True)
    for name, got, ref in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        _attn_close(got, _t(ref), name)
    _close(db, jdb, dict(rtol=0.0, atol=1e-3))


SLOTS, CAP, HEADS = 4, 256, 2
LENGTHS = np.array([CAP, 173, 40, 5], np.int32)


def test_decode_reads_match_jax():
    """Rows 5 and 6: the contiguous read against JAX
    `flash_attention_decode` at block_k 32, the paged read over fp16
    pools (a permuted table, page 32) against
    `flash_attention_decode_paged`."""
    rng = np.random.default_rng(31)
    q = _h(rng, SLOTS, HEADS, HD)
    k, v = (_h(rng, SLOTS, CAP, HEADS, HD) for _ in range(2))
    scale = 1.0 / math.sqrt(HD)

    def rows(c):
        return _j(c).transpose(0, 2, 1, 3).reshape(SLOTS * HEADS, CAP, HD)

    jo, jlse = jfa.flash_attention_decode(
        _j(q).reshape(SLOTS * HEADS, 1, HD), rows(k), rows(v),
        jnp.asarray(np.repeat(LENGTHS, HEADS)), scale, block_k=ROW_FRAME,
        return_lse=True)
    o, lse = fa.flash_attention_decode(q, k, v, torch.from_numpy(LENGTHS),
                                       scale, return_lse=True)
    _attn_close(o, _t(jo).reshape(SLOTS, HEADS, HD), "decode o")
    _lse_close(lse.numpy(), np.asarray(jlse))
    pps = CAP // ROW_FRAME
    perm = rng.permutation(SLOTS * pps)

    def pool(c):
        out = torch.empty((SLOTS * pps, HEADS, ROW_FRAME, HD), dtype=F16)
        out[torch.from_numpy(perm)] = c.reshape(
            SLOTS, pps, ROW_FRAME, HEADS, HD).permute(0, 1, 3, 2, 4).reshape(
                SLOTS * pps, HEADS, ROW_FRAME, HD)
        return out

    table = perm.reshape(SLOTS, pps).astype(np.int32)
    kp, vp = pool(k), pool(v)
    jo, jlse = jfa.flash_attention_decode_paged(
        _j(q).reshape(SLOTS * HEADS, 1, HD), _j(kp), _j(vp),
        jnp.asarray(table), jnp.asarray(LENGTHS), scale, return_lse=True)
    o, lse = fa.flash_attention_decode_paged(
        q, kp, vp, torch.from_numpy(table), torch.from_numpy(LENGTHS), scale,
        return_lse=True)
    _attn_close(o, _t(jo).reshape(SLOTS, HEADS, HD), "paged o")
    _lse_close(lse.numpy(), np.asarray(jlse))


@pytest.mark.parametrize("causal", [True, False])
def test_segments_match_jax(causal):
    """Row 3's serving read on its tiles route (frame 64) against JAX
    `flash_attention_segments_with_lse` at block 64; row 3's training
    forward and row 4's backward against `_seg_fwd` / `_seg_bwd`."""
    rng = np.random.default_rng(41 + causal)
    lens = (150, 41, 129)
    seg = torch.from_numpy(np.repeat(np.arange(3), lens).astype(np.int32))
    q, k, v, do = (_h(rng, HEADS, sum(lens), HD) for _ in range(4))
    scale = 1.0 / math.sqrt(HD)
    js = jnp.asarray(seg.numpy())
    assert fas.flash_segments_serve_plan(HEADS, seg.numel(), HD,
                                         F16)["route"] == "tiles"
    jo, jlse = jfs.flash_attention_segments_with_lse(
        _j(q), _j(k), _j(v), js, causal, scale, block_q=FWD_FRAME,
        block_k=FWD_FRAME)
    o, lse = fas.flash_attention_segments_with_lse(q, k, v, seg, causal,
                                                   scale)
    _attn_close(o, _t(jo), "serving o")
    _lse_close(lse.numpy(), np.asarray(jlse))
    jo, jlse = jfs._seg_fwd(_j(q), _j(k), _j(v), js, causal, scale,
                            FWD_FRAME, FWD_FRAME)
    o, lse = fas.flash_attention_segments_plain(q, k, v, seg, causal, scale)
    _attn_close(o, _t(jo), "training o")
    jgrads = jfs._seg_bwd(_j(q), _j(k), _j(v), js, jo, jlse, _j(do), causal,
                          scale, FWD_FRAME, FWD_FRAME)
    grads = fas.flash_attention_segments_bwd_plain(
        q, k, v, seg, _t(jo), _t(jlse), do, causal, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        _attn_close(got, _t(ref), name)


# ---------------------------------------------------------------------------
# row 12: the scaled softmaxes; row 13: cross-entropy
# ---------------------------------------------------------------------------


def test_softmax_matches_jax():
    """K1 (causal), K2 (masked) and K3 (backward) plain versions on fp16
    scores against JAX's kernels."""
    rng = np.random.default_rng(51)
    x = _h(rng, 4, 64, 64, scale=2.0)
    y = tsm.causal_softmax_fwd_plain(x, 0.3)
    _close(y, jsm.scaled_upper_triang_masked_softmax(_j(x), 0.3), HALF,
           scale=1.0)
    x4 = _h(rng, 2, 2, 64, 64, scale=2.0)
    mask = torch.from_numpy(rng.random((2, 1, 64, 64)) < 0.2)
    _close(tsm.masked_softmax_fwd_plain(x4, mask, 0.3),
           jsm.scaled_masked_softmax(_j(x4), _j(mask), 0.3), HALF, scale=1.0)
    dy = _h(rng, 4, 64, 64)
    _close(tsm.softmax_bwd_plain(y, dy, 0.3),
           jsm._softmax_bwd_impl(_j(y), _j(dy), 0.3), HALF)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    """Row 13: both forward forms (loss, lse; loss, dg in fp16) and the
    two-pass backward (dx in fp16) on fp16 logits."""
    rng = np.random.default_rng(61)
    x = _h(rng, 24, 520, scale=2.0)
    labels = rng.integers(0, 520, 24)
    jxx, jl = _j(x), jnp.asarray(labels)
    jloss, jlse = jx._fwd_impl(jxx, jl, smoothing)
    jloss2, jdg = jx._fwd_dg_impl(jxx, jl, smoothing)
    loss, lse = tx.xent_fwd(x, torch.from_numpy(labels), smoothing)
    loss2, dg = tx.xent_fwd_dg(x, torch.from_numpy(labels), smoothing)
    _close(loss, jloss, F32, scale=1.0)
    _close(lse, jlse, F32, scale=1.0)
    _close(loss2, jloss2, F32, scale=1.0)
    assert dg.dtype == F16
    _close(dg, jdg, dict(rtol=STEP, atol=1e-6), scale=1.0)
    dl = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    dx = tx.xent_bwd_reference(x, torch.from_numpy(labels), lse, dl,
                               smoothing)
    jdx = jax.grad(lambda a: jnp.sum(jx.softmax_cross_entropy_loss(
        a, jl, smoothing, -1) * jnp.asarray(dl.numpy())))(jxx)
    assert dx.dtype == F16
    _close(dx, jdx, dict(rtol=STEP, atol=1e-5), scale=1.0)


# ---------------------------------------------------------------------------
# rows 14-16: the multi-tensor passes and the optimizer kernels
# ---------------------------------------------------------------------------


def _tree(seed, bad=None):
    rng = np.random.default_rng(seed)
    vals = {"w": rng.standard_normal((5, 512)).astype(np.float32),
            "b": rng.standard_normal(300).astype(np.float32)}
    if bad is not None:
        vals["b"][299] = bad
    return (jpk.pack_tree({k: jnp.asarray(v, jnp.float16)
                           for k, v in vals.items()}),
            tpk.pack_tree({k: torch.from_numpy(v).to(F16)
                           for k, v in vals.items()}))


@pytest.mark.parametrize("out_dtype", ["float16", "float32"])
def test_multi_tensor_passes_match_jax(out_dtype):
    """Row 14 on an fp16 packed tree: scale and scale_sumsq (the amp
    unscale, into fp16 or fp32), axpby, the row sums."""
    jp, tp = _tree(71)
    tdt = getattr(torch, out_dtype)
    jout, jinf = jmt.scale_packed(jp, 1.0 / 1024, out_dtype)
    out, inf = tmt.scale_packed(tp, 1.0 / 1024, tdt)
    assert not bool(inf) and not bool(jinf)
    for b, jb in zip(out.buffers, jout.buffers):
        assert b.dtype == tdt
        _close(b, jb, HALF if tdt == F16 else F32, scale=0.0)
    jout, _, jrsq = jmt.scale_sumsq_packed(jp, 3.0, out_dtype)
    out, _, rsq = tmt.scale_sumsq_packed(tp, torch.tensor(3.0), tdt)
    for r, jr in zip(rsq, jrsq):
        _close(r, jr, F32)
    jout, jinf = jmt.axpby_packed(jp, jp, 0.5, 0.25, out_dtype)
    out, inf = tmt.axpby_packed(tp, tp, 0.5, 0.25, tdt)
    for b, jb in zip(out.buffers, jout.buffers):
        _close(b, jb, HALF if tdt == F16 else F32, scale=0.0)
    for b, jb in zip(tp.buffers, jp.buffers):
        _close(tmt.row_sumsq(b), jmt.row_sumsq(jb), F32)


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_fp16_nonfinite_trips_the_flag_as_in_jax(bad):
    """An fp16 inf or nan in the last live element trips the found-inf
    flag of scale and scale_sumsq on both sides."""
    jp, tp = _tree(72, bad)
    _, jinf = jmt.scale_packed(jp, 0.5)
    _, inf = tmt.scale_packed(tp, 0.5)
    assert bool(inf) and bool(jinf)
    _, inf, _ = tmt.scale_sumsq_packed(tp, torch.tensor(0.5))
    assert bool(inf)


def test_packed_adam_on_fp16_gradients_matches_jax():
    """Row 15: the packed Adam update with fp32 masters and moments and
    fp16 gradients."""
    rng = np.random.default_rng(81)
    p, m = (rng.standard_normal((64, 1024)).astype(np.float32)
            for _ in range(2))
    v = np.abs(rng.standard_normal((64, 1024))).astype(np.float32)
    g = rng.standard_normal((64, 1024)).astype(np.float32)
    wd = np.abs(rng.standard_normal((64, 1))).astype(np.float32)
    s = [1e-2, 0.9, 0.1, 0.999, 1.0 - 0.999, 1e-8, 1 - 0.9 ** 3,
         1 - 0.999 ** 3, 0.5]
    got = tok.adam_update(torch.from_numpy(p), torch.from_numpy(g).to(F16),
                          torch.from_numpy(m), torch.from_numpy(v),
                          torch.from_numpy(wd), s, True)
    want = jok.adam_update(jnp.asarray(p), jnp.asarray(g, jnp.float16),
                           jnp.asarray(m), jnp.asarray(v), jnp.asarray(wd),
                           s, True)
    for a, b in zip(got, want):
        _close(a, b, F32, scale=0.0)


def test_lamb_stages_on_fp16_gradients_match_jax():
    """Row 16: stage 1 on fp16 gradients with fp32 moments (the O2 BERT's
    LAMB), stage 2 with an fp16 compute copy."""
    rng = np.random.default_rng(91)
    p, g, m = (rng.standard_normal((96, 128)).astype(np.float32)
               for _ in range(3))
    v = np.abs(rng.standard_normal((96, 128))).astype(np.float32)
    sc = [0.9, 0.999, 0.1, 1e-6, 1 - 0.9 ** 3, 1 - 0.999 ** 3, 0.7, 1.0]
    jm, jv, jpsq, jusq = jok.lamb_leaf_stage1(
        jnp.asarray(p), jnp.asarray(g, jnp.float16), jnp.asarray(m),
        jnp.asarray(v), sc, 0.01, True)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    psq, usq = tok.lamb_leaf_stage1(tp, torch.from_numpy(g).to(F16), tm, tv,
                                    torch.tensor(sc), 0.01, True)
    _close(tm, jm, F32, scale=0.0)
    _close(tv, jv, F32, scale=0.0)
    np.testing.assert_allclose(float(psq), float(jpsq), rtol=1e-5)
    np.testing.assert_allclose(float(usq), float(jusq), rtol=1e-5)
    sb = [sc[3], sc[4], sc[5], 3e-3, 1.0]
    jp2, jc2 = jok.lamb_leaf_stage2(jnp.asarray(p), jm, jv, sb, 0.01, True,
                                    jnp.float16)
    c = torch.empty(p.shape, dtype=F16)
    tok.lamb_leaf_stage2(tp, tm, tv, torch.tensor(sb[:3] + sb[4:]),
                         torch.tensor([sb[3]]), 0.01, True, model_out=c)
    _close(tp, jp2, F32, scale=0.0)
    _close(c, jc2, dict(rtol=STEP, atol=0.0), scale=0.0)
    assert torch.equal(c, tp.to(F16))


# ---------------------------------------------------------------------------
# row 17: the bottleneck ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [16, 12])
def test_bottleneck_ops_match_jax(c):
    """The four conv+BN ops on fp16 maps (fp32 BN coefficients), at a
    width the kernels take natively and at one they pad: y and g in
    fp16, the statistics, dw and the reductions fp32 sums."""
    rng = np.random.default_rng(101 + c)
    shape = (2, 6, 5)
    m = int(np.prod(shape))

    def f32(*s, scale=1.0, shift=0.0):
        return (shift + scale * torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)))

    x, e, z = _h(rng, m, c), _h(rng, m, c, scale=0.1), _h(rng, m, c)
    w = _h(rng, c, c, scale=0.3)
    a, b = f32(c, scale=0.2, shift=1.0), f32(c, scale=0.2)
    y_fin = (_h(rng, m, c), f32(c, scale=0.3, shift=1.0), f32(c, scale=0.1),
             f32(c, scale=0.1))
    red = (f32(c, scale=0.1), f32(c, scale=0.2, shift=1.0).abs())

    def j(ts):
        return tuple(_j(t) for t in ts)

    jy, js = jfb.conv1x1_bn_act(_j(x), _j(w), _j(a), _j(b), stats=True)
    ty, ts = fb.conv1x1_bn_act(x, w, a, b, stats=True)
    _close(ty, jy, HALF)
    _close(ts[1], js[1], dict(rtol=0.0, atol=1e-3))
    x4, w3 = x.reshape(shape + (c,)), _h(rng, 3, 3, c, c, scale=0.3)
    jy, js = jfb.conv3x3_bn_act(_j(x4), _j(w3), _j(a), _j(b), stats=True)
    ty, ts = fb.conv3x3_bn_act(x4, w3, a, b, stats=True)
    _close(ty, jy, HALF)
    _close(ts[1], js[1], dict(rtol=0.0, atol=1e-3))
    jouts = jfb.conv1x1_bn_act_bwd(_j(e), _j(w), _j(x), z=_j(z),
                                   y_fin=j(y_fin), prologue=(_j(a), _j(b)),
                                   reduce_stats=j(red))
    touts = fb.conv1x1_bn_act_bwd(e, w, x, z=z, y_fin=y_fin, prologue=(a, b),
                                  reduce_stats=red)
    _close_but_flips(touts[0], jouts[0])
    for tv, jv in zip(touts[1:], jouts[1:]):
        _close(tv, jv, dict(rtol=0.0, atol=1e-3))
    e4 = e.reshape(shape + (c,))
    yf4 = (y_fin[0].reshape(shape + (c,)), *y_fin[1:])
    jouts = jfb.conv3x3_bn_act_bwd(_j(e4), _j(w3), _j(x4), j(yf4),
                                   (_j(a), _j(b)), j(red))
    touts = fb.conv3x3_bn_act_bwd(e4, w3, x4, yf4, (a, b), red)
    _close_but_flips(touts[0], jouts[0])
    _close(touts[1], jouts[1], dict(rtol=0.0, atol=1e-3))
    # the reductions sum g (times x-hat): a flipped element of g moves its
    # channel's sums by its own difference, which they are allowed beside
    # 1e-3 of their scale
    dg = np.abs(_np(touts[0]) - _np(jouts[0])).reshape(-1, c)
    xh = np.abs((_np(x4).reshape(-1, c) - _np(red[0])) * _np(red[1]))
    for tv, jv, flips in zip(touts[2:], jouts[2:], (dg.sum(0),
                                                    (dg * xh).sum(0))):
        ref = _np(jv)
        assert np.all(np.abs(_np(tv) - ref)
                      <= 1e-3 * np.abs(ref).max() + flips), "a reduction"


# ---------------------------------------------------------------------------
# the O2 GPT: a step's loss and gradients; the fp16 engine
# ---------------------------------------------------------------------------

SHAPE = dict(vocab_size=96, hidden_size=256, num_layers=2,
             num_attention_heads=2, max_position_embeddings=32,
             tensor_parallel_size=1, hidden_dropout=0.0,
             attention_dropout=0.0)


def test_o2_gpt_loss_and_every_gradient_match_jax():
    """The 2-layer GPT (hd 128: the packed kernels) with fp32 params and
    fp16 compute, as amp O2 runs it: the mean loss and every gradient
    against JAX's fp16 model on the same weights."""
    cfg = GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=F16)
    tree = random_params(cfg, seed=3)
    jmodel = JaxGPTModel(JaxGPTConfig(**SHAPE, params_dtype=jnp.float32,
                                      dtype=jnp.float16))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(111)
    tokens = rng.integers(0, 96, (2, 24)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply(p, jnp.asarray(tokens),
                               labels=jnp.asarray(labels),
                               loss_reduction="mean"))(jparams)
    model = from_jax_params(tree, cfg, device="cpu")
    loss = model(torch.from_numpy(tokens).long(),
                 labels=torch.from_numpy(labels).long(),
                 loss_reduction="mean")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    flat = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                 jgrads["params"]))
    named = dict(model.named_parameters())
    assert set(named) == set(flat)
    for name, g in flat.items():
        got = named[name].grad.float().numpy()
        g = np.asarray(g, np.float32)
        err = np.abs(got - g).max() / (np.abs(g).max() + 1e-30)
        assert err <= GRAD_SHARE, (name, err)


def test_fp16_engine_greedy_tokens_match_jax():
    """The chunked engine on the fp16 model (2 slots, capacity 24, budget
    4): greedy tokens and finish reasons identical to the JAX engine's."""
    cfg = GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=F16)
    tree = random_params(cfg, seed=7)
    jmodel = JaxGPTModel(JaxGPTConfig(**SHAPE, params_dtype=jnp.float32,
                                      dtype=jnp.float16))
    kw = dict(num_slots=2, capacity=24, prefill_token_budget=4)
    jeng = JaxEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
                     sampling=JaxSamplingParams(temperature=0.0), **kw)
    eng = InferenceEngine(from_jax_params(tree, cfg, device="cpu"),
                          sampling=SamplingParams(temperature=0.0), **kw)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], list(range(30, 42)), [10]]

    def run(e):
        return [(r.tokens, r.finish_reason)
                for r in e.generate(prompts, max_new_tokens=4)]

    got, want = run(eng), run(jeng)
    assert got == want
    assert all(reason == "length" for _, reason in got)
