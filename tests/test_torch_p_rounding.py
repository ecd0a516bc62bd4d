"""p and ds rounded as every JAX attention kernel rounds them, held against
the JAX package in bf16 on the CPU.

Every JAX attention kernel rounds the probabilities to the operand dtype
before the products that consume them: p (times 1 / (1 - rate) where
dropout keeps it) to v's dtype before p @ v, p_drop to do's before dv, and
ds = p (dp - delta) to q's (k's) before dk (dq) (rocm_apex_tpu/ops/
flash_attention.py `_fwd_kernel`, `_decode_kernel`, `_bwd_dkv_kernel`,
`_bwd_dq_kernel`, `_bwd_merged_kernel`, and flash_attention_segments.py's
kernels). The port's plain versions, what its wrappers run on the CPU and
what its kernels are held to on the card, do the same.

A forward forms p against the running max after each key block, so its o
depends on the tiling: JAX's o on its ``block_k``, the port's on its
kernel's key tile (64 keys in the flash pipes, 32 in the decode reads
and the serving segment read). Every forward case
here runs JAX at the port's frame (for the paged read, a page of 32); the
last test pins that dependence. The backward forms p from the final lse
and has no frame: its cases take JAX's o and lse as input.

The measure: of the elements with |x| > 1e-2, the share that differ by
more than one bf16 step (2^-7 |ref|) must stay at or below 0.1% (with p
kept at fp32 precision the port's plain versions were 5.8-8.1% off on
such inputs); lse agrees within 1e-5 + 1e-6 |lse|.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.ops import flash_attention as jfa
from rocm_apex_tpu.ops import flash_attention_segments as jfs
from rocm_apex_tpu_torch.ops import flash_attention as fa
from rocm_apex_tpu_torch.ops import flash_attention_segments as fas

BF16 = torch.bfloat16
FWD_FRAME = 64  # the flash pipes' key tile
ROW_FRAME = 32  # the decode reads' and the serving read's key tile
SHARE = 1e-3    # at most 0.1% of the elements beyond one bf16 step


def _bf16(rng, *shape, scale=1.0):
    return (scale * torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))).to(BF16)


def _j(t):
    """A torch tensor as a JAX array of the same dtype (bf16 exactly)."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _t(x):
    """A JAX array as a torch tensor of the same dtype."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(BF16)
    return torch.from_numpy(np.array(a))


def _off_share(got, ref):
    """The share of the elements with |ref| > 1e-2 that differ from ref by
    more than one bf16 step (2^-7 |ref|)."""
    got = np.asarray(got.float().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref.float().numpy() if torch.is_tensor(ref) else ref,
                     np.float64)
    big = np.abs(ref) > 1e-2
    off = np.abs(got - ref) > 2.0 ** -7 * np.abs(ref)
    return float((off & big).sum()) / max(int(big.sum()), 1)


def _close(got, ref, name):
    share = _off_share(got, ref)
    assert share <= SHARE, f"{name}: {100 * share:.3f}% beyond one bf16 step"


def _lse_close(got, ref):
    """|got - ref| <= 1e-5 + 1e-6 |ref|, elementwise."""
    got = np.asarray(got, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    err = np.abs(got - ref) - (1e-5 + 1e-6 * np.abs(ref))
    assert err.max() <= 0.0, f"lse off by {np.abs(got - ref).max():.3e}"


# ---------------------------------------------------------------------------
# the packed forward and backward with the projection bias (7a/8, 9a/11)
# ---------------------------------------------------------------------------

B, S, NH, HD = 2, 256, 2, 128


def _packed(seed):
    rng = np.random.default_rng(seed)
    qkv = _bf16(rng, B, S, NH, 3 * HD)
    bias = _bf16(rng, NH * 3 * HD, scale=0.1)
    do = _bf16(rng, B, S, NH * HD)
    return qkv, bias, do


@pytest.mark.parametrize("causal", [True, False])
def test_packed_forward_matches_jax_at_the_pipe_frame(causal):
    """`flash_qkv_fwd_plain` (rows 7a/8) against JAX `_fwd_packed` with
    the projection bias at block_k 64, four key tiles a row."""
    qkv, bias, _ = _packed(21 + causal)
    scale = 1.0 / math.sqrt(HD)
    jo, jlse = jfa._fwd_packed(_j(qkv), causal, scale, FWD_FRAME, FWD_FRAME,
                               qkv_bias=_j(bias))
    o, lse = fa.flash_qkv_fwd_plain(qkv, bias, causal, scale)
    _close(o, _t(jo), "o")
    _lse_close(lse.numpy(), np.asarray(jlse)[..., 0])


@pytest.mark.parametrize("causal", [True, False])
def test_packed_backward_matches_jax(causal):
    """`flash_qkv_bwd_plain` (rows 9a/11) against JAX `_bwd_packed` with
    the projection bias, both from JAX's o and lse: dq, dk and dv."""
    qkv, bias, do = _packed(31 + causal)
    scale = 1.0 / math.sqrt(HD)
    jo, jlse = jfa._fwd_packed(_j(qkv), causal, scale, FWD_FRAME, FWD_FRAME,
                               qkv_bias=_j(bias))
    jd, _ = jfa._bwd_packed(causal, scale, FWD_FRAME, FWD_FRAME,
                            (_j(qkv), jo, jlse), _j(do), qkv_bias=_j(bias))
    dqkv, _ = fa.flash_qkv_bwd_plain(qkv, bias, _t(jo),
                                     _t(jlse)[..., 0], do, causal, scale)
    jd = _t(jd)
    for i, name in enumerate(("dq", "dk", "dv")):
        sl = slice(i * HD, (i + 1) * HD)
        _close(dqkv[..., sl], jd[..., sl], name)


# ---------------------------------------------------------------------------
# unpacked with a padding bias (7b, 9b)
# ---------------------------------------------------------------------------

UB, UH, US = 2, 2, 192
U_LENGTHS = (192, 131)


def _unpacked(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(rng, UB * UH, US, HD) for _ in range(4))
    bias = torch.zeros(UB, US, US)
    for b, n in enumerate(U_LENGTHS):
        bias[b, :, n:] = -1e30
    return q, k, v, do, bias


@pytest.mark.parametrize("causal", [True, False])
def test_unpacked_forward_and_backward_match_jax(causal):
    """`flash_unpacked_fwd_plain` (row 7b) against JAX `_fwd` with the
    masked BERT padding bias at block_k 64, and `flash_unpacked_bwd_plain`
    (row 9b) against JAX `_bwd` on JAX's o and lse."""
    q, k, v, do, bias = _unpacked(41 + causal)
    scale = 1.0 / math.sqrt(HD)
    jo, jlse = jfa._fwd(_j(q), _j(k), _j(v), _j(bias), causal, scale,
                        FWD_FRAME, FWD_FRAME)
    o, lse = fa.flash_unpacked_fwd_plain(q, k, v, bias, causal, scale)
    _close(o, _t(jo), "o")
    _lse_close(lse.numpy(), np.asarray(jlse))
    jdq, jdk, jdv, _ = jfa._bwd(
        causal, scale, FWD_FRAME, FWD_FRAME,
        (_j(q), _j(k), _j(v), _j(bias), jo, jlse), _j(do),
        compute_dbias=False)
    dq, dk, dv, _ = fa.flash_unpacked_bwd_plain(q, k, v, bias, _t(jo),
                                                _t(jlse), do, causal, scale)
    for name, got, ref in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        _close(got, _t(ref), name)


# ---------------------------------------------------------------------------
# the decode reads (5, 6)
# ---------------------------------------------------------------------------

SLOTS, CAP, HEADS = 4, 256, 2
LENGTHS = np.array([CAP, 173, 40, 5], np.int32)


def _decode_inputs(seed):
    rng = np.random.default_rng(seed)
    q = _bf16(rng, SLOTS, HEADS, HD)
    k = _bf16(rng, SLOTS, CAP, HEADS, HD)
    v = _bf16(rng, SLOTS, CAP, HEADS, HD)
    return q, k, v


def _jrows(cache):
    """(slots, cap, heads, hd) -> JAX's (slots * heads, cap, hd)."""
    return _j(cache).transpose(0, 2, 1, 3).reshape(SLOTS * HEADS, CAP, HD)


def test_contiguous_decode_matches_jax_at_the_row_frame():
    """Row 5's read (`flash_attention_decode` on the CPU: its plain
    version) against JAX `flash_attention_decode` at block_k 32."""
    q, k, v = _decode_inputs(51)
    scale = 1.0 / math.sqrt(HD)
    jo, jlse = jfa.flash_attention_decode(
        _j(q).reshape(SLOTS * HEADS, 1, HD), _jrows(k), _jrows(v),
        jnp.asarray(np.repeat(LENGTHS, HEADS)), scale, block_k=ROW_FRAME,
        return_lse=True)
    o, lse = fa.flash_attention_decode(q, k, v, torch.from_numpy(LENGTHS),
                                       scale, return_lse=True)
    _close(o, _t(jo).reshape(SLOTS, HEADS, HD), "o")
    _lse_close(lse.numpy(), np.asarray(jlse))


def _pools(k, v, rng, page):
    """Page pools holding the cache through a permuted table."""
    pps = CAP // page
    perm = rng.permutation(SLOTS * pps)

    def pool(cache):
        out = torch.empty((SLOTS * pps, HEADS, page, HD), dtype=cache.dtype)
        out[torch.from_numpy(perm)] = cache.reshape(
            SLOTS, pps, page, HEADS, HD).permute(0, 1, 3, 2, 4).reshape(
                SLOTS * pps, HEADS, page, HD)
        return out

    return pool(k), pool(v), perm.reshape(SLOTS, pps).astype(np.int32)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_matches_jax_at_a_page_of_32(quantized):
    """Row 6's read over bf16 pools and over int8 pools (dequantized by
    both sides as `(float(x) * scale)` in q's dtype) against JAX
    `flash_attention_decode_paged`, whose frame is the page: 32 keys."""
    rng = np.random.default_rng(61 + quantized)
    q, k, v = _decode_inputs(61 + quantized)
    kp, vp, table = _pools(k, v, rng, ROW_FRAME)
    ks = vs = None
    if quantized:
        shape = kp.shape
        kp = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        vp = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        ks, vs = (torch.from_numpy((0.01 * (1 + rng.random(
            (shape[0], HEADS)))).astype(np.float32)) for _ in range(2))
    scale = 1.0 / math.sqrt(HD)
    jo, jlse = jfa.flash_attention_decode_paged(
        _j(q).reshape(SLOTS * HEADS, 1, HD), _j(kp), _j(vp),
        jnp.asarray(table), jnp.asarray(LENGTHS), scale,
        k_scale=None if ks is None else _j(ks),
        v_scale=None if vs is None else _j(vs), return_lse=True)
    o, lse = fa.flash_attention_decode_paged(
        q, kp, vp, torch.from_numpy(table), torch.from_numpy(LENGTHS), scale,
        ks, vs, return_lse=True)
    _close(o, _t(jo).reshape(SLOTS, HEADS, HD), "o")
    _lse_close(lse.numpy(), np.asarray(jlse))


# ---------------------------------------------------------------------------
# segment attention: the serving read (3) and the training form (3, 4)
# ---------------------------------------------------------------------------

SEG_LENS = (150, 41, 129)


def _segments(seed):
    rng = np.random.default_rng(seed)
    total = sum(SEG_LENS)
    seg = torch.from_numpy(np.repeat(np.arange(len(SEG_LENS)),
                                     SEG_LENS).astype(np.int32))
    q, k, v, do = (_bf16(rng, HEADS, total, HD) for _ in range(4))
    return q, k, v, do, seg


@pytest.mark.parametrize("causal", [True, False])
def test_serving_segment_read_matches_jax_at_the_row_frame(causal):
    """Row 3's serving read (`flash_attention_segments_with_lse` on the
    CPU) against the JAX function at block_k 32."""
    q, k, v, _, seg = _segments(71 + causal)
    scale = 1.0 / math.sqrt(HD)
    jo, jlse = jfs.flash_attention_segments_with_lse(
        _j(q), _j(k), _j(v), jnp.asarray(seg.numpy()), causal, scale,
        block_q=ROW_FRAME, block_k=ROW_FRAME)
    o, lse = fas.flash_attention_segments_with_lse(q, k, v, seg, causal,
                                                   scale)
    _close(o, _t(jo), "o")
    _lse_close(lse.numpy(), np.asarray(jlse))


@pytest.mark.parametrize("causal", [True, False])
def test_training_segments_match_jax(causal):
    """Row 3's training forward (`flash_attention_segments_plain`, the
    forward pipe's frame of 64) against JAX `_seg_fwd` at block 64, and
    row 4's backward against JAX `_seg_bwd` on JAX's o and lse."""
    q, k, v, do, seg = _segments(81 + causal)
    scale = 1.0 / math.sqrt(HD)
    js = jnp.asarray(seg.numpy())
    jo, jlse = jfs._seg_fwd(_j(q), _j(k), _j(v), js, causal, scale,
                            FWD_FRAME, FWD_FRAME)
    o, lse = fas.flash_attention_segments_plain(q, k, v, seg, causal, scale)
    _close(o, _t(jo), "o")
    _lse_close(lse.numpy(), np.asarray(jlse))
    jgrads = jfs._seg_bwd(_j(q), _j(k), _j(v), js, jo, jlse, _j(do), causal,
                          scale, FWD_FRAME, FWD_FRAME)
    grads = fas.flash_attention_segments_bwd_plain(
        q, k, v, seg, _t(jo), _t(jlse), do, causal, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        _close(got, _t(ref), name)


# ---------------------------------------------------------------------------
# the frame: JAX's own o depends on its block_k
# ---------------------------------------------------------------------------


def test_o_follows_the_frame_as_jax_follows_block_k():
    """JAX's forward rounds p against the running max after each key
    block, so its o at block_k 128 is not its o at 64: the port's plain
    forward matches JAX only at the same frame (128 against 128, 64
    against 64), and its frame of 64 is measurably off JAX at 128 (1-3%
    of the elements beyond one bf16 step, against at most 0.1%)."""
    q, k, v, _, bias = _unpacked(91)
    scale = 1.0 / math.sqrt(HD)
    jo = {f: _t(jfa._fwd(_j(q), _j(k), _j(v), _j(bias), False, scale, f,
                         f)[0]) for f in (64, 128)}
    o = {f: fa.flash_unpacked_fwd_plain(q, k, v, bias, False, scale,
                                        frame=f)[0] for f in (64, 128)}
    for f in (64, 128):
        _close(o[f], jo[f], f"o at frame {f}")
    assert _off_share(o[64], jo[128]) > 10 * SHARE
