"""The port's packed-varlen attention against the JAX package, on the CPU.

`flash_attention_segments` (the differentiable segment attention over a
packed token stream), `contrib.fmha.fmha` with both ``packed`` values and
the `FMHA` module, on numpy-drawn fp32 inputs. The JAX side runs its
Pallas kernels (`_seg_fwd_kernel`, `_seg_dkv_kernel`, `_seg_dq_kernel`,
and the unpacked kernels of the padded path) in interpret mode; the port
runs its kernels' plain versions, as every wrapper does for CPU tensors.
Both compute in fp32 and differ in summation order only: o and lse agree
to 1e-5 relative with a 1e-5 floor, gradients to 1e-4 (the tolerance of
tests/L0/test_attention.py's packed-vs-padded check).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.contrib.fmha import FMHA as JFMHA
from rocm_apex_tpu.contrib.fmha import fmha as jfmha
from rocm_apex_tpu.ops import flash_attention_segments as jfs
from rocm_apex_tpu_torch.contrib.fmha import FMHA, fmha
from rocm_apex_tpu_torch.contrib.fmha.fmha import _unpack_ids
from rocm_apex_tpu_torch.ops import flash_attention_segments as tfs

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _stream(lengths, h, d, seed):
    """q, k, v, do as (h, total, d) fp32 and the (total,) int32 ids."""
    rng = np.random.default_rng(seed)
    total = int(sum(lengths))
    q, k, v, do = (rng.standard_normal((h, total, d)).astype(np.float32)
                   for _ in range(4))
    seg = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    return q, k, v, do, seg


def _jax_segments(q, k, v, do, seg, causal):
    """JAX o, lse and the gradients of sum(o * do) in q, k, v."""
    jseg = jnp.asarray(seg)

    def loss(q, k, v):
        return (jfs.flash_attention_segments(q, k, v, jseg, causal)
                * do).sum()

    args = [jnp.asarray(a) for a in (q, k, v)]
    jo, jl = jfs.flash_attention_segments_with_lse(*args, jseg, causal)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return np.asarray(jo), np.asarray(jl), [np.asarray(g) for g in grads]


def _torch_segments(q, k, v, do, seg, causal):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tseg = torch.from_numpy(seg)
    o, lse = tfs._seg_fwd(tq.detach(), tk.detach(), tv.detach(), tseg,
                          causal, 1.0 / np.sqrt(q.shape[-1]))
    out = tfs.flash_attention_segments(tq, tk, tv, tseg, causal)
    (out * torch.from_numpy(do)).sum().backward()
    assert torch.equal(out.detach(), o)
    return o.numpy(), lse.numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("lengths", [[37, 128, 5], [37, 512, 9, 300]],
                         ids=["3seq", "4seq"])
def test_segments_match_jax(lengths, causal):
    """o and lse of the training forward, and dq/dk/dv of
    `flash_attention_segments`, against JAX's `_seg_fwd`/`_seg_bwd`
    (a stream over several of JAX's 512-token blocks: its range skip runs
    too)."""
    q, k, v, do, seg = _stream(lengths, h=2, d=64, seed=len(lengths))
    jo, jl, jg = _jax_segments(q, k, v, do, seg, causal)
    o, lse, g = _torch_segments(q, k, v, do, seg, causal)
    np.testing.assert_allclose(o, jo, **TOL)
    np.testing.assert_allclose(lse, jl, **TOL)
    for name, a, b in zip("qkv", g, jg):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_segment_ids_in_any_order_match_jax(causal):
    """The ids need not be sorted: the kernels skip by id ranges, which
    never drops a live pair, and the plain versions mask per pair. Ids
    interleaved in blocks, against JAX on the same ids."""
    q, k, v, do, _ = _stream([90, 70], h=2, d=64, seed=5)
    seg = np.array([3, 1, 3, 0, 1] * 32, np.int32)
    jo, jl, jg = _jax_segments(q, k, v, do, seg, causal)
    o, lse, g = _torch_segments(q, k, v, do, seg, causal)
    np.testing.assert_allclose(o, jo, **TOL)
    np.testing.assert_allclose(lse, jl, **TOL)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_plain_backward_is_the_derivative_of_the_plain_forward():
    """The explicit plain backward (the kernels' formulas) equals
    autograd through the plain forward."""
    q, k, v, do, seg = _stream([20, 1, 43], h=2, d=64, seed=6)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tseg, tdo = torch.from_numpy(seg), torch.from_numpy(do)
    o, lse = tfs.flash_attention_segments_plain(tq, tk, tv, tseg, True, 0.125)
    (o * tdo).sum().backward()
    got = tfs.flash_attention_segments_bwd_plain(
        tq.detach(), tk.detach(), tv.detach(), tseg, o.detach(), lse.detach(),
        tdo, True, 0.125)
    for a, t in zip(got, (tq, tk, tv)):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), **GRAD_TOL)


def test_plain_forward_rounds_the_scaled_q_in_q_dtype():
    """The one score rule of the serving and the training forms (JAX's):
    q times scale * log2(e) is rounded in q's dtype before the fp32
    product. In bf16 the plain forward (at the serving read's frame), and
    the serving wrapper's CPU path with it, equal the fp32 computation on
    the pre-rounded q, and differ from a fold of the scale in fp32."""
    q, k, v, _, seg = _stream([30, 34], h=2, d=64, seed=7)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    tseg = torch.from_numpy(seg)
    scale = 0.125
    o_r, lse_r = tfs.flash_attention_segments_plain(tq, tk, tv, tseg, True,
                                                    scale, tfs.SERVE_FRAME)
    o_s, lse_s = tfs.flash_attention_segments_with_lse(tq, tk, tv, tseg,
                                                       True, scale)
    assert torch.equal(o_s, o_r) and torch.equal(lse_s, lse_r)
    c = torch.tensor(scale * 1.4426950408889634, dtype=torch.bfloat16)
    qr = (tq * c).float() / (scale * 1.4426950408889634)
    # v stays bf16: p is rounded to v's dtype, as the bf16 forward rounds it
    o_w, lse_w = tfs.flash_attention_segments_plain(
        qr, tk.float(), tv, tseg, True, scale, tfs.SERVE_FRAME)
    np.testing.assert_allclose(lse_r.numpy(), lse_w.numpy(), **TOL)
    np.testing.assert_allclose(o_r.float().numpy(), o_w.float().numpy(),
                               rtol=2.0 ** -7, atol=1e-5)
    o_f, lse_f = tfs.flash_attention_segments_plain(
        tq.float(), tk.float(), tv.float(), tseg, True, scale)
    assert not torch.equal(o_r, o_f.to(torch.bfloat16)) or not torch.equal(
        lse_r, lse_f)


# cu_seqlens with a zero-length sequence inside and two at the end
FMHA_LENGTHS = [37, 0, 128, 5, 64, 0, 0]


def _packed(lengths, h, d, seed):
    rng = np.random.default_rng(seed)
    total = int(sum(lengths))
    qkv = rng.standard_normal((total, 3, h, d)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return qkv, cu, max(lengths)


def _jax_fmha(qkv, cu, max_s, causal, packed):
    def loss(x):
        o = jfmha(x, jnp.asarray(cu), max_s, causal=causal, packed=packed)
        return (o.astype(jnp.float32) ** 2).sum(), o

    (_, o), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(qkv))
    return np.asarray(o), np.asarray(g)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "padded"])
def test_fmha_matches_jax(packed, causal):
    """Values and the gradient of sum(o²) for both paths, with empty
    sequences in cu_seqlens (they own no token and no row)."""
    qkv, cu, max_s = _packed(FMHA_LENGTHS, h=2, d=64, seed=11)
    jo, jg = _jax_fmha(qkv, cu, max_s, causal, packed)
    x = torch.tensor(qkv, requires_grad=True)
    o = fmha(x, torch.from_numpy(cu), max_s, causal=causal, packed=packed)
    (o.float() ** 2).sum().backward()
    assert o.shape == (qkv.shape[0], 2, 64)
    np.testing.assert_allclose(o.detach().numpy(), jo, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), jg, **GRAD_TOL)


def test_packed_and_padded_agree_and_the_gradient_is_projection_layout():
    """The two paths give one function; the packed backward's dqkv is a
    (total, 3, h, d) tensor in qkv's layout."""
    qkv, cu, max_s = _packed(FMHA_LENGTHS, h=2, d=64, seed=12)
    outs = []
    for packed in (True, False):
        x = torch.tensor(qkv, requires_grad=True)
        o = fmha(x, torch.from_numpy(cu), max_s, causal=True, packed=packed,
                 scale=0.2)
        (o ** 2).sum().backward()
        outs.append((o.detach(), x.grad))
    assert outs[0][1].shape == qkv.shape and outs[0][1].is_contiguous()
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(), **TOL)
    np.testing.assert_allclose(outs[0][1].numpy(), outs[1][1].numpy(),
                               **GRAD_TOL)


def test_fmha_module_matches_jax():
    """`FMHA` against the JAX module (neither holds parameters)."""
    qkv, cu, max_s = _packed([50, 0, 77], h=2, d=64, seed=13)
    jm = JFMHA(causal=True)
    jo = jm.apply(jm.init(jax.random.PRNGKey(0), jnp.asarray(qkv),
                          jnp.asarray(cu), max_s),
                  jnp.asarray(qkv), jnp.asarray(cu), max_s)
    m = FMHA(causal=True)
    assert not list(m.parameters())
    o = m(torch.from_numpy(qkv), torch.from_numpy(cu), max_s)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)


def test_unpack_ids_skip_empty_sequences():
    """token -> (sequence, offset): a zero-length sequence owns no token,
    also at the end of cu_seqlens."""
    cu = torch.tensor([0, 3, 3, 5, 5, 5], dtype=torch.int32)
    seq, off = _unpack_ids(cu, 5, 3)
    assert seq.tolist() == [0, 0, 0, 2, 2]
    assert off.tolist() == [0, 1, 2, 0, 1]


@pytest.mark.parametrize("bad", ["shape", "device"])
def test_wrappers_refuse_what_no_kernel_takes(bad):
    q = torch.zeros(2, 10, 64)
    seg = torch.zeros(10, dtype=torch.int32)
    if bad == "shape":
        with pytest.raises(ValueError):
            tfs.flash_attention_segments(q, q, q, seg[:5])
        with pytest.raises(ValueError):
            fmha(torch.zeros(10, 2, 2, 64), torch.tensor([0, 10]), 10)
    else:
        with pytest.raises(RuntimeError, match="no kernel"):
            tfs._seg_fwd(q.to("meta"), q.to("meta"), q.to("meta"),
                         seg.to("meta"), False, 0.125)
