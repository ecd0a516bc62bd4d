"""The score rule of every attention kernel, held against the JAX package in
bf16 on the CPU.

Every JAX attention kernel forms its scores as ``q * asarray(scale *
LOG2E, q.dtype)``, rounded in q's dtype, and then takes the fp32 product
with k (`_masked_scores`, rocm_apex_tpu/ops/flash_attention.py:122; the
paged read does the same). In bf16 the constant itself rounds (0.127517
becomes 0.127930 at head_dim 128) and q takes one more rounding, so a
port that folds the scale in fp32 is 0.3% off in every score. The port's
plain versions (what its wrappers run on the CPU, and what its kernels
are held to on the card) take the same rule:

- the packed forward (`flash_qkv_fwd_plain`, the kernel of rows 7a/8)
  against JAX `_fwd_packed` through `flash_attention_qkv_bias`'s forward,
  with the projection bias, causal and not, on one tile and on four;
- the contiguous decode read, the paged read over float and int8 pools
  and the serving segment read against JAX `flash_attention_decode`,
  `flash_attention_decode_paged` and `flash_attention_segments_with_lse`.

Each lse agrees within 1e-5 + 1e-6 |lse| (both sides fp32 from the same
bf16 operands; the summation order differs) and is also held to an fp32
evaluation on the pre-rounded q. o is held to JAX's o within one bf16
step: both round p to bf16 before p @ v against the running max after
each key block, so the port's plain version runs at JAX's block_k (its
``frame``; JAX at the packed cases' blocks, the decode read at block_k
32, the paged read's page of 16, the serving read at block 32). The
packed backward's dqkv is held to fp32 autograd of the evaluation, with
ds and p rounded to bf16 where JAX's backward kernels round them (the
tolerances are stated at `GRAD_FLOORS`).
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

LOG2E = 1.4426950408889634
LN2 = math.log(2.0)
BF16 = torch.bfloat16


def _lse_close(got, ref):
    """|got - ref| <= 1e-5 + 1e-6 |ref|, elementwise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref) - (1e-5 + 1e-6 * np.abs(ref))
    assert err.max() <= 0.0, f"lse off by {np.abs(got - ref).max():.3e}"


def _o_close(got, ref):
    """o against JAX's o: of the elements with |ref| > 1e-2, at most 0.1%
    more than one bf16 step (2^-7 |ref|) off. Both are bf16 sums of p
    rounded to bf16 in the same frame; a p on a rounding edge may round
    either way, and where the terms cancel a bf16 output is no finer than
    the terms it sums."""
    got, ref = got.float().numpy(), _t(ref).numpy()
    big = np.abs(ref) > 1e-2
    off = (np.abs(got - ref) > 2.0 ** -7 * np.abs(ref)) & big
    assert off.sum() <= 1e-3 * big.sum(), (
        f"o: {off.sum()} of {big.sum()} beyond one bf16 step")


def _bf16(rng, *shape, scale=1.0):
    return (scale * torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))).to(BF16)


def _j(t):
    """A torch tensor as a JAX array of the same dtype (bf16 exactly)."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _t(x):
    """A JAX array (bf16 or fp32) as an fp32 torch tensor."""
    return torch.from_numpy(np.asarray(x).astype(np.float32))


def _q_rounded(q, scale):
    """The pre-rounded q of the rule, as fp32: bf16(q * bf16(scale *
    log2 e))."""
    c = torch.tensor(scale * LOG2E, dtype=q.dtype)
    return (q * c).float()


class _RoundedGrad(torch.autograd.Function):
    """The identity whose gradient is rounded to bf16: the score gradient
    ds as JAX's kernels round it before dq and dk."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(BF16).float()


class _RoundedPV(torch.autograd.Function):
    """p @ v whose gradient in v takes p rounded to bf16, as JAX's
    kernels round p before dv."""

    @staticmethod
    def forward(ctx, p, v):
        ctx.save_for_backward(p, v)
        return torch.einsum("...qk,...kd->...qd", p, v)

    @staticmethod
    def backward(ctx, do):
        p, v = ctx.saved_tensors
        return (torch.einsum("...qd,...kd->...qk", do, v),
                torch.einsum("...qk,...qd->...kd", p.to(BF16).float(), do))


def _reference(qr, k, v, live):
    """fp32 attention on pre-rounded base-2 scores qr . k: o and the
    natural-log lse; rows with no live key give o = 0. Its gradient rounds
    ds and p (for dv) to bf16 where JAX's backward kernels round them."""
    s = _RoundedGrad.apply(torch.einsum("...qd,...kd->...qk", qr, k) * LN2)
    s = s.masked_fill(~live, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).nan_to_num(0.0)
    return _RoundedPV.apply(p, v), lse


# ---------------------------------------------------------------------------
# the packed forward and backward (rows 7a/8, 9a/11)
# ---------------------------------------------------------------------------

B, S, NH, HD = 2, 256, 2, 128


def _packed(seed):
    rng = np.random.default_rng(seed)
    qkv = _bf16(rng, B, S, NH, 3 * HD)
    bias = _bf16(rng, NH * 3 * HD, scale=0.1)
    do = _bf16(rng, B, S, NH * HD)
    return qkv, bias, do


def _packed_heads(qkv, bias):
    """q, k, v (B*nh, S, hd) in bf16 after the projection bias, rounded
    as the kernels' bf16 add rounds it."""
    x = (qkv.float() + bias.float().view(NH, 3 * HD)).to(BF16)
    x = x.permute(0, 2, 1, 3).reshape(B * NH, S, 3 * HD)
    return x.split(HD, dim=-1)


def _causal_live(causal):
    if not causal:
        return torch.ones(S, S, dtype=torch.bool)
    return torch.ones(S, S, dtype=torch.bool).tril()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [256, 128])
def test_packed_forward_lse_matches_jax(causal, block):
    """lse against JAX `_fwd_packed` with the projection bias: one tile
    (`_fwd_single_kernel`) and four (`_fwd_kernel`), and against the fp32
    evaluation on the pre-rounded q; o against JAX's o, the plain version
    at JAX's block as its frame."""
    qkv, bias, _ = _packed(3 + block + causal)
    scale = 1.0 / math.sqrt(HD)
    jo, jlse = jfa._fwd_packed(_j(qkv), causal, scale, block, block,
                               qkv_bias=_j(bias))
    o, lse = fa.flash_qkv_fwd_plain(qkv, bias, causal, scale, frame=block)
    _lse_close(lse.numpy(), np.asarray(jlse)[..., 0])
    q, k, v = _packed_heads(qkv, bias)
    _, rlse = _reference(_q_rounded(q, scale), k.float(), v.float(),
                         _causal_live(causal))
    _lse_close(lse.numpy(), rlse.numpy())
    _o_close(o, jo)


def _grad_tol(ref, floor):
    """Half a bf16 step of the value, twice over (rtol 2^-8, the output's
    rounding), plus ``floor`` times the tensor's largest entry."""
    return dict(rtol=2.0 ** -8, atol=floor * float(ref.abs().max()))


# The floors: dv differs from the evaluation by fp32 summation noise only
# (2^-12). dq and dk take delta = rowsum(do * o) from o rounded to bf16,
# as JAX's kernels do, half a bf16 step in every term of every ds (2^-8);
# dk is also formed from the biased q times scale, where the evaluation's
# derivative has the pre-rounded q / c, another half step a term (2^-7).
GRAD_FLOORS = dict(dq=2.0 ** -8, dk=2.0 ** -7, dv=2.0 ** -12)


@pytest.mark.parametrize("causal", [True, False])
def test_packed_backward_is_the_gradient_of_the_rounded_forward(causal):
    """dqkv of the plain packed backward (the kernels' formulas) against
    fp32 autograd of the evaluation on the pre-rounded q, ds and p
    rounded to bf16 where JAX's kernels round them: dq = scale / ln 2
    times the gradient in the rounded q, dk = scale / (ln 2 c) times the
    gradient in k, dv the gradient in v."""
    qkv, bias, do = _packed(11 + causal)
    scale = 1.0 / math.sqrt(HD)
    c = float(torch.tensor(scale * LOG2E, dtype=BF16))
    o, lse = fa.flash_qkv_fwd_plain(qkv, bias, causal, scale)
    dqkv, _ = fa.flash_qkv_bwd_plain(qkv, bias, o, lse, do, causal, scale)
    q, k, v = _packed_heads(qkv, bias)
    qr, kf, vf = (t.detach().clone().requires_grad_(True)
                  for t in (_q_rounded(q, scale), k.float(), v.float()))
    ro, _ = _reference(qr, kf, vf, _causal_live(causal))
    do_h = do.float().reshape(B, S, NH, HD).permute(0, 2, 1, 3).reshape(
        B * NH, S, HD)
    (ro * do_h).sum().backward()
    got = dqkv.float().permute(0, 2, 1, 3).reshape(B * NH, S, 3 * HD)
    refs = dict(dq=qr.grad * scale / LN2, dk=kf.grad * scale / (LN2 * c),
                dv=vf.grad)
    for g, (name, ref) in zip(got.split(HD, dim=-1), refs.items()):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), err_msg=name,
                                   **_grad_tol(ref, GRAD_FLOORS[name]))


# ---------------------------------------------------------------------------
# the serving reads (rows 3, 5, 6)
# ---------------------------------------------------------------------------

SLOTS, CAP, HEADS, DHEAD, PAGE = 4, 64, 2, 128, 16
LENGTHS = np.array([CAP, 37, 5, 0], np.int32)


def _decode_inputs(seed):
    rng = np.random.default_rng(seed)
    q = _bf16(rng, SLOTS, HEADS, DHEAD)
    k = _bf16(rng, SLOTS, CAP, HEADS, DHEAD)
    v = _bf16(rng, SLOTS, CAP, HEADS, DHEAD)
    return q, k, v


def _decode_reference(q, k, v, scale, lengths):
    """fp32 evaluation of the decode read on the pre-rounded q: o (slots,
    heads, hd), lse (slots, heads); empty slots are compared apart."""
    kk = k.float().permute(0, 2, 1, 3)  # (slots, heads, cap, hd)
    vv = v.float().permute(0, 2, 1, 3)
    live = (torch.arange(CAP)[None, :] < torch.from_numpy(lengths)[:, None])
    o, lse = _reference(_q_rounded(q, scale)[:, :, None], kk, vv,
                        live[:, None, None, :])
    return o[:, :, 0], lse[:, :, 0]


def _check_serving(o, lse, jo, jlse, rlse, live_rows):
    _lse_close(lse[live_rows].numpy(), np.asarray(jlse)[live_rows])
    _lse_close(lse[live_rows].numpy(), rlse[live_rows].numpy())
    _o_close(o[live_rows], np.asarray(jo)[live_rows])


def test_contiguous_decode_lse_matches_jax():
    """Row 5's read (`flash_attention_decode`, the split plan's plain
    version) against JAX `flash_attention_decode` at block_k 32, the
    plain version's frame."""
    q, k, v = _decode_inputs(5)
    scale = 1.0 / math.sqrt(DHEAD)
    jk = _j(k).transpose(0, 2, 1, 3).reshape(SLOTS * HEADS, CAP, DHEAD)
    jv = _j(v).transpose(0, 2, 1, 3).reshape(SLOTS * HEADS, CAP, DHEAD)
    jo, jlse = jfa.flash_attention_decode(
        _j(q).reshape(SLOTS * HEADS, 1, DHEAD), jk, jv,
        jnp.asarray(np.repeat(LENGTHS, HEADS)), scale, block_k=32,
        return_lse=True)
    o, lse = fa.flash_attention_decode(q, k, v, torch.from_numpy(LENGTHS),
                                       scale, return_lse=True)
    _, rlse = _decode_reference(q, k, v, scale, LENGTHS)
    live = LENGTHS > 0
    _check_serving(o, lse, np.asarray(jo).reshape(SLOTS, HEADS, DHEAD),
                   np.asarray(jlse).reshape(SLOTS, HEADS), rlse, live)
    assert torch.all(lse[~live] == -1e30)


def _pools(k, v, rng):
    """Page pools holding the cache through a permuted table."""
    pps = CAP // PAGE
    perm = rng.permutation(SLOTS * pps)

    def pool(cache):
        out = torch.empty((SLOTS * pps, HEADS, PAGE, DHEAD), dtype=cache.dtype)
        out[torch.from_numpy(perm)] = cache.reshape(
            SLOTS, pps, PAGE, HEADS, DHEAD).permute(0, 1, 3, 2, 4).reshape(
                SLOTS * pps, HEADS, PAGE, DHEAD)
        return out

    table = perm.reshape(SLOTS, pps).astype(np.int32)
    return pool(k), pool(v), table


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_lse_matches_jax(quantized):
    """Row 6's read over bf16 pools and over int8 pools (dequantized to
    bf16 by both sides as `(float(x) * scale)` in q's dtype) against JAX
    `flash_attention_decode_paged`; o from the plain version at the
    page, JAX's frame, as its frame."""
    rng = np.random.default_rng(6 + quantized)
    q, k, v = _decode_inputs(6 + quantized)
    kp, vp, table = _pools(k, v, rng)
    ks = vs = None
    if quantized:
        shape = kp.shape
        kp = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        vp = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        ks, vs = (torch.from_numpy((0.01 * (1 + rng.random(
            (shape[0], HEADS)))).astype(np.float32)) for _ in range(2))
    scale = 1.0 / math.sqrt(DHEAD)
    jo, jlse = jfa.flash_attention_decode_paged(
        _j(q).reshape(SLOTS * HEADS, 1, DHEAD), _j(kp), _j(vp),
        jnp.asarray(table), jnp.asarray(LENGTHS), scale,
        k_scale=None if ks is None else _j(ks),
        v_scale=None if vs is None else _j(vs), return_lse=True)
    _, lse = fa.flash_attention_decode_paged(
        q, kp, vp, torch.from_numpy(table), torch.from_numpy(LENGTHS), scale,
        ks, vs, return_lse=True)
    o, _ = fa.flash_attention_decode_paged_plain(
        q, kp, vp, torch.from_numpy(table), torch.from_numpy(LENGTHS), scale,
        ks, vs, frame=PAGE)
    # the cache the pools hold, as the reads see it (int8 dequantized)
    kc = fa._paged_cache(kp, torch.from_numpy(table), ks, BF16, CAP)
    vc = fa._paged_cache(vp, torch.from_numpy(table), vs, BF16, CAP)
    _, rlse = _decode_reference(q, kc, vc, scale, LENGTHS)
    live = LENGTHS > 0
    _check_serving(o, lse, np.asarray(jo).reshape(SLOTS, HEADS, DHEAD),
                   np.asarray(jlse).reshape(SLOTS, HEADS), rlse, live)


@pytest.mark.parametrize("causal", [True, False])
def test_serving_segment_read_lse_matches_jax(causal):
    """Row 3's serving read (`flash_attention_segments_with_lse`) over a
    packed chunk of three sequences against the JAX function, at block
    32, the serving read's frame."""
    rng = np.random.default_rng(8 + causal)
    lens = [50, 7, 71]
    total = sum(lens)
    seg = torch.from_numpy(np.repeat(np.arange(3), lens).astype(np.int32))
    q, k, v = (_bf16(rng, HEADS, total, DHEAD) for _ in range(3))
    scale = 1.0 / math.sqrt(DHEAD)
    jo, jlse = jfs.flash_attention_segments_with_lse(
        _j(q), _j(k), _j(v), jnp.asarray(seg.numpy()), causal, scale,
        block_q=fas.SERVE_FRAME, block_k=fas.SERVE_FRAME)
    o, lse = fas.flash_attention_segments_with_lse(q, k, v, seg, causal,
                                                   scale)
    live = seg[:, None] == seg[None, :]
    if causal:
        live = live & torch.ones(total, total, dtype=torch.bool).tril()
    _, rlse = _reference(_q_rounded(q, scale), k.float(), v.float(), live)
    _lse_close(lse.numpy(), np.asarray(jlse))
    _lse_close(lse.numpy(), rlse.numpy())
    _o_close(o, jo)
