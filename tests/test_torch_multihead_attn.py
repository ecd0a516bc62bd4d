"""The port's contrib/multihead_attn against the JAX package, on the CPU.

`SelfMultiheadAttn` and `EncdecMultiheadAttn` with and without projection
biases and ``include_norm_add``, under a key-padding mask, an attention
mask (bool and additive) and both, on numpy-drawn fp32 inputs; the flax
modules' params go across through `convert.mha_from_jax_params`. The JAX
side runs its Pallas kernels (the unpacked flash forward and backward,
the LayerNorm) in interpret mode, the port its kernels' plain versions.
Both compute in fp32 and differ in summation order only: outputs and
every gradient agree to 1e-5 relative with a 1e-5 floor (1e-4 for the
gradients, summed over batch and keys).

The dropout branch cannot be bit-matched against ``jax.random``; it is
held three ways (keep fraction, kept values p / (1 - rate), determinism
by seed) and against its formula with the recovered keep bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.contrib.multihead_attn import (
    EncdecMultiheadAttn as JEncdec,
    SelfMultiheadAttn as JSelf,
    fast_mask_softmax_dropout as jfast,
)
from rocm_apex_tpu_torch.contrib import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    fast_mask_softmax_dropout,
)
from rocm_apex_tpu_torch.convert import mha_from_jax_params
from rocm_apex_tpu_torch.ops import _dropout

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, SQ, SK, HID, HEADS = 2, 13, 9, 32, 2


def _masks(kind, sq, sk, rng):
    """(key_padding_mask, attn_mask) as numpy arrays for ``kind``."""
    kpm = am = None
    if kind in ("kpm", "both"):
        kpm = np.zeros((B, sk), bool)
        kpm[0, sk - 3:] = True
        kpm[1, sk - 1:] = True
    if kind == "attn_bool":
        am = np.triu(np.ones((sq, sk), bool), 1)
    if kind in ("attn_add", "both"):
        am = (0.5 * rng.standard_normal((sq, sk))).astype(np.float32)
        am[:, 0] = 0.0
        am[2, 1:] = -1e30
    return kpm, am


def _pair(encdec, bias, norm_add):
    kw = dict(bias=bias, include_norm_add=norm_add)
    if encdec:
        return (JEncdec(num_heads=HEADS, **kw),
                EncdecMultiheadAttn(HEADS, HID, device="cpu", **kw))
    return (JSelf(num_heads=HEADS, **kw),
            SelfMultiheadAttn(HEADS, HID, device="cpu", **kw))


def _t(a, grad=False):
    return None if a is None else torch.tensor(a, requires_grad=grad)


@pytest.mark.parametrize("mask", ["kpm", "attn_bool", "attn_add", "both"])
@pytest.mark.parametrize("norm_add", [False, True])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("encdec", [False, True])
def test_output_and_gradients_match_jax(encdec, bias, norm_add, mask):
    """The eval forward (the flash core) and the gradients of sum(out *
    dout) in every parameter and input, against the flax module."""
    rng = np.random.default_rng(7 * encdec + 3 * bias + norm_add)
    sk = SK if encdec else SQ
    query = rng.standard_normal((B, SQ, HID)).astype(np.float32)
    key = rng.standard_normal((B, sk, HID)).astype(np.float32)
    dout = rng.standard_normal((B, SQ, HID)).astype(np.float32)
    kpm, am = _masks(mask, SQ, sk, rng)
    jmod, tmod = _pair(encdec, bias, norm_add)
    jargs = ((jnp.asarray(query), jnp.asarray(key)) if encdec
             else (jnp.asarray(query),))
    params = jmod.init(jax.random.PRNGKey(0), *jargs)
    if norm_add:
        # non-trivial LN parameters
        ln = dict(params["params"]["lyr_norm"])
        ln["weight"] = jnp.asarray(
            1.0 + 0.1 * rng.standard_normal(HID).astype(np.float32))
        ln["bias"] = jnp.asarray(0.1 * rng.standard_normal(HID)
                                 .astype(np.float32))
        params = {"params": {**params["params"], "lyr_norm": ln}}
    jkw = dict(key_padding_mask=None if kpm is None else jnp.asarray(kpm),
               attn_mask=None if am is None else jnp.asarray(am))

    def jloss(p, *xs):
        out = jmod.apply(p, *xs, **jkw)
        return (out * dout).sum(), out

    argnums = (0, 1, 2) if encdec else (0, 1)
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=argnums,
                                           has_aux=True)(params, *jargs)
    mha_from_jax_params(jax.tree_util.tree_map(np.asarray, params), tmod)
    tq, tk = _t(query, True), _t(key, True)
    txs = (tq, tk) if encdec else (tq,)
    tout = tmod(*txs, key_padding_mask=_t(kpm), attn_mask=_t(am))
    (tout * torch.tensor(dout)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgrads[1]),
                               **GRAD_TOL)
    if encdec:
        np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jgrads[2]),
                                   **GRAD_TOL)
    jp = {k.replace(".kernel", ".weight"): np.asarray(v)
          for k, v in _flat(jgrads[0]["params"]).items()}
    tp = dict(tmod.named_parameters())
    assert set(jp) == set(tp)
    for name, g in jp.items():
        if name.endswith(".weight") and not name.startswith("lyr_norm"):
            g = g.T
        np.testing.assert_allclose(tp[name].grad.numpy(), g, **GRAD_TOL,
                                   err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_params_layout():
    """Names and (out, in) shapes; a tree that does not fit raises."""
    m = SelfMultiheadAttn(4, 64, include_norm_add=True, device="cpu")
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == {
        "lyr_norm.weight": (64,), "lyr_norm.bias": (64,),
        "qkv_proj.weight": (192, 64), "qkv_proj.bias": (192,),
        "out_proj.weight": (64, 64), "out_proj.bias": (64,)}
    assert all(p.dtype == torch.float32 for p in m.parameters())
    e = EncdecMultiheadAttn(4, 64, bias=False, device="cpu")
    assert {n for n, _ in e.named_parameters()} == {
        "q_proj.weight", "kv_proj.weight", "out_proj.weight"}
    with pytest.raises(KeyError, match="missing"):
        mha_from_jax_params({"params": {}}, e)
    with pytest.raises(ValueError, match="divisible"):
        SelfMultiheadAttn(3, 64, device="cpu")


def test_fully_masked_row_both_paths():
    """A batch row whose every key is padding: the flash path's context
    is 0 there (the output is out_proj's bias, as JAX's), the softmax
    path's the uniform average of v over the keys."""
    rng = np.random.default_rng(3)
    query = rng.standard_normal((B, SQ, HID)).astype(np.float32)
    kpm = np.zeros((B, SQ), bool)
    kpm[1] = True
    jmod, tmod = _pair(False, True, False)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(query))
    leaves = _flat(params["params"])
    leaves = {k: np.asarray(v) + (0.1 if k.endswith("bias") else 0.0)
              for k, v in leaves.items()}
    mha_from_jax_params({"qkv_proj": {"kernel": leaves["qkv_proj.kernel"],
                                      "bias": leaves["qkv_proj.bias"]},
                         "out_proj": {"kernel": leaves["out_proj.kernel"],
                                      "bias": leaves["out_proj.bias"]}},
                        tmod)
    jparams = {"params": {"qkv_proj": {"kernel": leaves["qkv_proj.kernel"],
                                       "bias": leaves["qkv_proj.bias"]},
                          "out_proj": {"kernel": leaves["out_proj.kernel"],
                                       "bias": leaves["out_proj.bias"]}}}
    jout = jmod.apply(jparams, jnp.asarray(query),
                      key_padding_mask=jnp.asarray(kpm))
    tout = tmod(_t(query), key_padding_mask=_t(kpm))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    np.testing.assert_allclose(
        tout[1].detach().numpy(),
        np.broadcast_to(leaves["out_proj.bias"], (SQ, HID)), **TOL)
    # the softmax path at a rate whose keep bits all pass: the uniform
    # average of v over the keys, through out_proj
    tmod.dropout = 1e-9
    tsm = tmod(_t(query), key_padding_mask=_t(kpm), deterministic=False,
               dropout_seed=5)
    v = (torch.tensor(query[1]) @ tmod.qkv_proj.weight[2 * HID:].T
         + tmod.qkv_proj.bias[2 * HID:])
    want = v.mean(0) @ tmod.out_proj.weight.T + tmod.out_proj.bias
    np.testing.assert_allclose(tsm[1].detach().numpy(),
                               np.broadcast_to(want.detach().numpy(),
                                               (SQ, HID)), **TOL)
    np.testing.assert_allclose(tsm[0].detach().numpy(), tout[0].detach()
                               .numpy(), **TOL)


def _dropout_parts(seed, rate, gen=None):
    rng = np.random.default_rng(11)
    query = _t(rng.standard_normal((B, 40, HID)).astype(np.float32))
    kpm = np.zeros((B, 40), bool)
    kpm[0, 30:] = True
    m = SelfMultiheadAttn(HEADS, HID, dropout=rate, device="cpu")
    torch.manual_seed(0)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.3)
    return m, query, _t(kpm)


def test_dropout_branch_formula_and_determinism():
    """The training branch equals softmax -> dropout(keep bits of the
    seed's hash over (b*heads, sq, sk)) -> @ v, the same seed gives the
    same bits, another seed others, and a generator draws its own."""
    rate = 0.25
    m, query, kpm = _dropout_parts(0, rate)
    out = m(query, key_padding_mask=kpm, deterministic=False,
            dropout_seed=123)
    again = m(query, key_padding_mask=kpm, deterministic=False,
              dropout_seed=123)
    other = m(query, key_padding_mask=kpm, deterministic=False,
              dropout_seed=124)
    assert torch.equal(out, again)
    assert not torch.allclose(out, other)
    # the formula, recomputed with the recovered keep bits
    d = HID // HEADS
    qkv = m.qkv_proj(query)
    q, k, v = (t.view(B, 40, HEADS, d).transpose(1, 2)
               for t in qkv.split(HID, -1))
    s = q @ k.transpose(-1, -2) / np.sqrt(d)
    s = s + torch.where(kpm[:, None, None, :], -1e30, 0.0)
    p = torch.softmax(s, -1)
    keep = _dropout.keep_mask(123, rate, (B * HEADS, 40, 40)).view(p.shape)
    ctx = (torch.where(keep, p / (1 - rate), 0.0) @ v).transpose(1, 2)
    want = m.out_proj(ctx.reshape(B, 40, HID))
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               **TOL)
    g1 = m(query, key_padding_mask=kpm, deterministic=False,
           generator=torch.Generator().manual_seed(9))
    g2 = m(query, key_padding_mask=kpm, deterministic=False,
           generator=torch.Generator().manual_seed(9))
    assert torch.equal(g1, g2) and not torch.allclose(g1, out)
    # eval ignores the rate: the flash path, as training at rate 0
    ev = m(query, key_padding_mask=kpm)
    m.dropout = 0.0
    np.testing.assert_allclose(
        ev.detach().numpy(),
        m(query, key_padding_mask=kpm, deterministic=False).detach().numpy(),
        **TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_fast_mask_softmax_dropout_keep_fraction_and_scale(rate):
    """`fast_mask_softmax_dropout` in training: the keep fraction within
    5 sigma of 1 - rate, every kept value p / (1 - rate), masked keys 0;
    deterministic, it equals JAX's."""
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((4, 2, 64, 96)).astype(np.float32)
    mask = np.zeros((4, 1, 1, 96), bool)
    mask[..., 80:] = True
    ts, tm = torch.tensor(scores), torch.tensor(mask)
    p = fast_mask_softmax_dropout(ts, tm, rate, True, scale=0.7)
    jp = jfast(jnp.asarray(scores), jnp.asarray(mask), rate, True,
               scale=0.7)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), **TOL)
    pd = fast_mask_softmax_dropout(ts, tm, rate, False, dropout_seed=77,
                                   scale=0.7)
    live = np.broadcast_to(~mask, scores.shape)
    kept = (pd.numpy() != 0) & live
    n = live.sum()
    frac = kept.sum() / n
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(frac - (1 - rate)) < 5 * sigma
    np.testing.assert_allclose(pd.numpy()[kept],
                               p.numpy()[kept] / (1 - rate), rtol=1e-6)
    assert (pd.numpy()[~live] == 0).all()
    assert torch.equal(pd, fast_mask_softmax_dropout(
        ts, tm, rate, False, dropout_seed=77, scale=0.7))


def test_fast_mask_softmax_fully_masked_row_is_uniform():
    scores = torch.randn(2, 5, 7)
    mask = torch.zeros(2, 5, 7, dtype=torch.bool)
    mask[1, 2] = True
    p = fast_mask_softmax_dropout(scores, mask, 0.0, True)
    np.testing.assert_allclose(p[1, 2].numpy(), np.full(7, 1 / 7), **TOL)
