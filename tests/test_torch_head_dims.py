"""The flash kernels' head dims against the JAX package, on the CPU.

The JAX kernels take any head dim up to 256: they pad it to the 128-lane
width with zero columns (rocm_apex_tpu/ops/flash_attention.py:19,
:245-254). The port's kernels take every head dim from 1 to 256 on an
instance of width 64, 128 or 256 (32 too for the warp-a-row reads): at
the width itself, below it with zero columns formed in the kernel (a
multiple of 8), or through a padded copy the wrapper makes (any other
head dim). Here, on numpy-drawn fp32 inputs at tiny shapes and dropout 0,
at hd 16, 32, 80, 96 and 256: every plan names its instance and route
for each hd 1-256 and raises past 256; the zero-column rule itself (the
plain version at hd 80 against the plain version at width 128 on
zero-padded operands); each flash op's plain version (the unpacked
forward and backward with a bias and its gradient, the packed path at
256, the training and serving segment forms, the contiguous and paged
decode reads) against the JAX function, its Pallas kernels in interpret
mode; the tiny GPT (hd 32, 80 and 256, the packed branch at 256) and
masked BERT (hd 32) logits and every gradient against JAX's; the
engine's greedy tokens against the JAX engine at hd 80 and 256. Both
sides compute in fp32 and differ in summation order only: 1e-5 relative
(an absolute floor of 1e-5 on values of order 1 to 10), 2e-5 of a
gradient's largest entry on the models, identical tokens.
"""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.bert import BertConfig as JaxBertConfig
from rocm_apex_tpu.models.bert import BertModel as JaxBertModel
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.ops import flash_attention as jfa
from rocm_apex_tpu.ops import flash_attention_segments as jfs
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
)
from rocm_apex_tpu_torch.inference import InferenceEngine, SamplingParams
from rocm_apex_tpu_torch.models.bert import BertConfig
from rocm_apex_tpu_torch.models.gpt import GPTConfig
from rocm_apex_tpu_torch.ops import flash_attention as fa
from rocm_apex_tpu_torch.ops import flash_attention_segments as fas

HDS = [16, 32, 80, 96, 256]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 2e-5  # of each gradient's largest entry, as test_torch_bert.py
NEG = -1e30
F32 = torch.float32


def _rng(*key):
    """A generator seeded from ``key`` (the same in every process)."""
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().float().numpy() if torch.is_tensor(got) else got,
        np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------


def _width(hd, widths):
    return min(w for w in widths if w >= -(-hd // 8) * 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, F32])
def test_every_plan_names_an_instance_for_every_head_dim(dtype):
    """hd 1 to 256: each plan's width is the smallest instance at or above
    the head dim (rounded up to a multiple of 8), its route "native" at
    the width, "zero_columns" at another multiple of 8, "padded" else
    (its pad bytes counted); past 256 every plan raises, naming ROADMAP
    Queue 2."""
    pipe, rows = fa.PIPE_WIDTHS, fa.ROW_WIDTHS
    for hd in range(1, 257):
        route = ("native" if hd in pipe else
                 "zero_columns" if hd % 8 == 0 else "padded")
        plans = [fa.flash_fwd_plan(8, 300, 300, hd, True, 132, dtype),
                 fa.flash_unpacked_bwd_plan(8, 300, 300, hd, True, dtype),
                 fa.flash_dbias_plan(2, 4, 300, 300, hd, False, dtype),
                 fas.flash_segments_plan(8, 1000, hd, dtype)]
        for plan in plans:
            assert plan["width"] == _width(hd, pipe), (hd, plan)
            assert plan["hd_route"] == route, (hd, plan)
            assert plan["kernel_hd"] == -(-hd // 8) * 8
        for plan in plans[:2] + plans[3:]:
            assert (plan["pad_bytes"] > 0) == (route == "padded")
        serve = fas.flash_segments_serve_plan(8, 256, hd, dtype)
        on_rows = serve["route"] == "rows"
        assert on_rows == (dtype == F32 or hd > 128)
        assert serve["width"] == _width(hd, rows if on_rows else pipe)
        dec = fa.head_dim_plan(hd, rows)
        assert dec["width"] == _width(hd, rows)
        assert fa.decode_span_workspace(8, 8, hd, 32) == (
            8 * 8 * 8 * (dec["width"] + 2))
        if hd % 128 == 0:
            bwd = fa.flash_bwd_plan(2, 300, 4, hd, True, dtype)
            assert bwd["width"] == hd and bwd["hd_route"] == "native"
            halves = 2 if hd == 256 and dtype != F32 else None
            assert len(bwd["dkv_grid"]) == (3 if halves else 2)
    for hd in (257, 264, 512):
        for plan in (
                lambda: fa.flash_fwd_plan(8, 300, 300, hd, True, 132, dtype),
                lambda: fa.flash_unpacked_bwd_plan(8, 300, 300, hd, True,
                                                   dtype),
                lambda: fa.flash_dbias_plan(2, 4, 300, 300, hd, False,
                                            dtype),
                lambda: fas.flash_segments_plan(8, 1000, hd, dtype),
                lambda: fas.flash_segments_serve_plan(8, 256, hd, dtype),
                lambda: fa.head_dim_plan(hd, fa.ROW_WIDTHS)):
            with pytest.raises(ValueError, match="head_dim.*Queue 2"):
                plan()


# ---------------------------------------------------------------------------
# the zero-column rule
# ---------------------------------------------------------------------------


def test_zero_columns_change_nothing():
    """The plain versions at hd 80 equal the plain versions at width 128
    on the same operands padded with zero columns, sliced back: o, lse
    and every gradient (the padded gradient columns exactly 0), and the
    bias gradient. A zero column adds exactly 0 to each score, to p v and
    to rowsum(do o)."""
    rng = _rng("zero columns")
    bh, sq, sk, hd, wd = 4, 37, 45, 80, 128
    q, k, v, do = (rng.standard_normal((bh, s, hd)).astype(np.float32)
                   for s in (sq, sk, sk, sq))
    bias = rng.standard_normal((1, sq, sk)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    w = [torch.from_numpy(np.pad(x, ((0, 0), (0, 0), (0, wd - hd))))
         for x in (q, k, v, do)]
    b = torch.from_numpy(bias)
    scale = 1.0 / math.sqrt(hd)
    o, lse = fa.flash_unpacked_fwd_plain(*t[:3], b, True, scale)
    ow, lsew = fa.flash_unpacked_fwd_plain(*w[:3], b, True, scale)
    _close(o, ow[..., :hd], dict(rtol=1e-6, atol=1e-6))
    _close(lse, lsew, dict(rtol=1e-6, atol=1e-6))
    assert torch.all(ow[..., hd:] == 0)
    g = fa.flash_unpacked_bwd_plain(*t[:3], b, o, lse, t[3], True, scale,
                                    compute_dbias=True)
    gw = fa.flash_unpacked_bwd_plain(*w[:3], b, ow, lsew, w[3], True, scale,
                                     compute_dbias=True)
    for a, c in zip(g[:3], gw[:3]):
        _close(a, c[..., :hd], dict(rtol=1e-6, atol=1e-6))
        assert torch.all(c[..., hd:] == 0)
    _close(g[3], gw[3], dict(rtol=1e-6, atol=1e-6))


# ---------------------------------------------------------------------------
# each flash op against JAX
# ---------------------------------------------------------------------------


def _j(x):
    return jnp.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("hd", HDS)
def test_unpacked_matches_jax(hd):
    """o, lse, dq, dk, dv and the bias gradient of
    `flash_attention_with_lse` (a bias row a head, causal, ragged sq !=
    sk, a cotangent on both outputs) against the JAX kernels."""
    rng = _rng("unpacked", hd)
    bh, sq, sk = 2, 20, 33
    q, k, v, do = (rng.standard_normal((bh, s, hd)).astype(np.float32)
                   for s in (sq, sk, sk, sq))
    dlse = rng.standard_normal((bh, sq)).astype(np.float32)
    bias = rng.standard_normal((bh, sq, sk)).astype(np.float32)
    bias[:, :, sk - 3:] = NEG

    def jloss(q, k, v, b):
        o, lse = jfa.flash_attention_with_lse(q, k, v, b, True, None,
                                              compute_dbias=True)
        return (o * do).sum() + (lse * dlse).sum(), (o, lse)

    (_, (jo, jl)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(x) for x in (q, k, v, bias)))
    tq, tk, tv, tb = (torch.tensor(x, requires_grad=True)
                      for x in (q, k, v, bias))
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, tb, True,
                                         compute_dbias=True)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    _close(o, jo)
    _close(lse, jl)
    for t, g in zip((tq, tk, tv, tb), jg):
        _close(t.grad, g)


@pytest.mark.parametrize("bias", [False, True])
def test_packed_at_256_matches_jax(bias):
    """The packed path at hd 256 (the GPT's packed branch): o and the
    cotangents of the projection and its bias against JAX
    `flash_attention_qkv_bias` (`flash_attention_qkv` without a bias),
    causal."""
    rng = _rng("packed", bias)
    B, S, nh, hd = 2, 19, 2, 256
    qkv = rng.standard_normal((B, S, nh, 3 * hd)).astype(np.float32)
    pb = (0.1 * rng.standard_normal(nh * 3 * hd)).astype(np.float32)
    do = rng.standard_normal((B, S, nh * hd)).astype(np.float32)

    def jloss(x, b):
        o = (jfa.flash_attention_qkv_bias(x, b, True) if bias
             else jfa.flash_attention_qkv(x, True))
        return (o * do).sum(), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(pb))
    tx, tb = (torch.tensor(x, requires_grad=True) for x in (qkv, pb))
    o = (fa.flash_attention_qkv_bias(tx, tb, True) if bias
         else fa.flash_attention_qkv(tx, True))
    (o * torch.from_numpy(do)).sum().backward()
    _close(o, jo)
    _close(tx.grad, jg[0])
    if bias:
        _close(tb.grad, jg[1])


def _segments(rng, hd, heads=2):
    lens = [7, 0, 13, 5]
    ids = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    total = ids.size
    q, k, v, do = (rng.standard_normal((heads, total, hd)).astype(np.float32)
                   for _ in range(4))
    return q, k, v, do, ids


@pytest.mark.parametrize("hd", HDS)
def test_segments_match_jax(hd):
    """The serving read (o and lse of `flash_attention_segments_with_lse`
    on its route) and the training form (o and dq, dk, dv of
    `flash_attention_segments`) against JAX, causal, an empty segment."""
    rng = _rng("segments", hd)
    q, k, v, do, ids = _segments(rng, hd)
    jo, jl = jfs.flash_attention_segments_with_lse(
        *(jnp.asarray(x) for x in (q, k, v, ids)), True)
    o, lse = fas.flash_attention_segments_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v, ids)), causal=True)
    _close(o, jo)
    _close(lse, jl)

    def jloss(q, k, v):
        return (jfs.flash_attention_segments(q, k, v, jnp.asarray(ids),
                                             True) * do).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    ot = fas.flash_attention_segments(tq, tk, tv, torch.from_numpy(ids),
                                      True)
    (ot * torch.from_numpy(do)).sum().backward()
    _close(ot, jo)
    for t, g in zip((tq, tk, tv), jg):
        _close(t.grad, g)


SLOTS, HEADS, CAP, PAGE = 3, 2, 24, 8
LENGTHS = np.array([0, 7, 24], np.int32)


@pytest.mark.parametrize("hd", HDS)
def test_decode_reads_match_jax(hd):
    """The contiguous decode read and the paged read over the same keys
    (a permuted table) against JAX `flash_attention_decode` and
    `flash_attention_decode_paged`: o and lse of every live row, an empty
    row's zeros."""
    rng = _rng("decode", hd)
    q = rng.standard_normal((SLOTS, HEADS, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((SLOTS, CAP, HEADS, hd)).astype(
        np.float32) for _ in range(2))
    scale = 1.0 / math.sqrt(hd)
    jk, jv = (jnp.asarray(c.transpose(0, 2, 1, 3).reshape(
        SLOTS * HEADS, CAP, hd)) for c in (kc, vc))
    jo, jl = jfa.flash_attention_decode(
        jnp.asarray(q).reshape(SLOTS * HEADS, 1, hd), jk, jv,
        jnp.asarray(np.repeat(LENGTHS, HEADS)), scale, return_lse=True)
    jo = np.asarray(jo).reshape(SLOTS, HEADS, hd)
    jl = np.asarray(jl).reshape(SLOTS, HEADS)
    live = LENGTHS > 0
    o, lse = fa.flash_attention_decode(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(LENGTHS), scale, return_lse=True)
    _close(o[live], jo[live])
    _close(lse[live], jl[live])
    assert torch.all(o[~live] == 0)
    pps = CAP // PAGE
    perm = rng.permutation(SLOTS * pps)

    def pool(c):
        out = np.empty((SLOTS * pps, HEADS, PAGE, hd), np.float32)
        out[perm] = c.reshape(SLOTS, pps, PAGE, HEADS, hd).transpose(
            0, 1, 3, 2, 4).reshape(SLOTS * pps, HEADS, PAGE, hd)
        return out

    kp, vp = pool(kc), pool(vc)
    table = perm.reshape(SLOTS, pps).astype(np.int32)
    jpo, jpl = jfa.flash_attention_decode_paged(
        jnp.asarray(q).reshape(SLOTS * HEADS, 1, hd), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(LENGTHS), scale,
        return_lse=True)
    po, pl = fa.flash_attention_decode_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(LENGTHS), scale,
        return_lse=True)
    _close(po[live], np.asarray(jpo).reshape(SLOTS, HEADS, hd)[live])
    _close(pl[live], np.asarray(jpl).reshape(SLOTS, HEADS)[live])


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _gpt_shape(hd, layers=1):
    return dict(vocab_size=96, hidden_size=2 * hd, num_layers=layers,
                num_attention_heads=2, max_position_embeddings=32,
                tensor_parallel_size=1, hidden_dropout=0.0,
                attention_dropout=0.0)


def _grads_match(model, jgrads):
    flat = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                 jgrads["params"]))
    named = dict(model.named_parameters())
    assert set(named) == set(flat)
    for name, g in flat.items():
        # a leaf the loss does not reach (BERT's binary head) has no
        # gradient on the port's side and zeros on JAX's
        got = named[name].grad
        got = np.zeros_like(g) if got is None else got.numpy()
        err = np.abs(got - g).max() / (np.abs(g).max() + 1e-30)
        assert err < GRAD_REL, (name, err)


@pytest.mark.parametrize("hd", [32, 80, 256])
def test_gpt_logits_loss_and_every_gradient_match_jax(hd):
    """The tiny GPT at hd 32 and 80 (the unpacked kernels) and 256 (the
    packed branch, as models/gpt.py routes hd % 128 == 0): logits, the
    mean loss and every gradient against JAX's."""
    shape = _gpt_shape(hd)
    cfg = GPTConfig(**shape, params_dtype=F32, dtype=F32)
    tree = random_params(cfg, seed=hd)
    jmodel = JaxGPTModel(JaxGPTConfig(**shape, params_dtype=jnp.float32,
                                      dtype=jnp.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = _rng("gpt", hd)
    tokens = rng.integers(0, 96, (2, 17)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    jlogits = jmodel.apply(jparams, jnp.asarray(tokens))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply(p, jnp.asarray(tokens),
                               labels=jnp.asarray(labels),
                               loss_reduction="mean"))(jparams)
    model = from_jax_params(tree, cfg, device="cpu")
    t, lbl = torch.from_numpy(tokens).long(), torch.from_numpy(labels).long()
    with torch.no_grad():
        _close(model(t), jlogits, dict(rtol=1e-4, atol=1e-4))
    loss = model(t, labels=lbl, loss_reduction="mean")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _grads_match(model, jgrads)


def test_masked_bert_at_32_matches_jax():
    """The JAX recipe's masked BERT width (hidden 256 over 8 heads: hd
    32) at 1 layer: logits and every gradient of the masked LM loss with
    a padding mask of two lengths against JAX's."""
    shape = dict(vocab_size=128, hidden_size=256, num_layers=1,
                 num_attention_heads=8, ffn_hidden_size=512,
                 max_position_embeddings=32, tensor_parallel_size=1,
                 hidden_dropout=0.0, attention_dropout=0.0)
    cfg = BertConfig(**shape, params_dtype=F32, dtype=F32)
    tree = random_params(cfg, seed=5)
    jmodel = JaxBertModel(JaxBertConfig(**shape, params_dtype=jnp.float32,
                                        dtype=jnp.float32))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = _rng("bert")
    b, s = 2, 24
    tokens = rng.integers(0, 128, (b, s)).astype(np.int32)
    labels = np.roll(tokens, 1, 1).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.array([s, 15])[:, None]).astype(
        np.int32)
    jt, jl, jm = (jnp.asarray(x) for x in (tokens, labels, mask))
    jlogits, _ = jmodel.apply(jtree, jt, attention_mask=jm)

    def loss_fn(p):
        losses, _ = jmodel.apply(p, jt, attention_mask=jm, lm_labels=jl)
        return jnp.mean(losses)

    jloss, jgrads = jax.value_and_grad(loss_fn)(jtree)
    model = from_jax_params(tree, cfg, device="cpu")
    tt, tl, tm = (torch.from_numpy(x).long() for x in (tokens, labels, mask))
    with torch.no_grad():
        logits, _ = model(tt, attention_mask=tm)
    _close(logits, jlogits, dict(rtol=1e-4, atol=1e-4))
    losses, _ = model(tt, attention_mask=tm, lm_labels=tl)
    loss = losses.mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _grads_match(model, jgrads)


PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], list(range(30, 42)), [10]]


@pytest.mark.parametrize("hd", [80, 256])
def test_engine_greedy_tokens_match_jax(hd):
    """The chunked engine (2 slots, capacity 24, budget 4: slot reuse, a
    prompt longer than the budget) at hd 80 and 256: greedy tokens and
    finish reasons identical to the JAX engine's on the same weights."""
    shape = _gpt_shape(hd)
    cfg = GPTConfig(**shape, params_dtype=F32, dtype=F32)
    tree = random_params(cfg, seed=7)
    jmodel = JaxGPTModel(JaxGPTConfig(**shape, params_dtype=jnp.float32,
                                      dtype=jnp.float32))
    kw = dict(num_slots=2, capacity=24, prefill_token_budget=4)
    jeng = JaxEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
                     sampling=JaxSamplingParams(temperature=0.0), **kw)
    eng = InferenceEngine(from_jax_params(tree, cfg, device="cpu"),
                          sampling=SamplingParams(temperature=0.0), **kw)

    def run(e):
        return [(r.tokens, r.finish_reason)
                for r in e.generate(PROMPTS, max_new_tokens=4)]

    got, want = run(eng), run(jeng)
    assert got == want
    assert all(reason == "length" for _, reason in got)
