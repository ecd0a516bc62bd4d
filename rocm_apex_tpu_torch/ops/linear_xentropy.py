"""Chunked fused LM head + cross-entropy: the ``(rows, vocab)`` logits
never exist whole.

Port of ``rocm_apex_tpu/ops/linear_xentropy.py``. The JAX package
computes this head with XLA (a `lax.scan` over
row chunks around the jnp `_loss_block` of ops/xentropy.py:33), not in a
Pallas kernel, so the port keeps it plain PyTorch: a Python loop over
row chunks, the chunk's logits from one `torch.matmul`, the loss math
in fp32.

* `linear_cross_entropy_loss` returns per-row losses; it saves only the
  row lse and its backward recomputes each chunk's softmax.
* `linear_cross_entropy_mean` returns the masked mean (the
  `gpt_loss_fn` reduction) and, because its cotangent is then a scalar,
  forms each chunk's dlogits while the chunk is live and contracts it
  straight into dx and an fp32 dW accumulator during the forward; the
  backward only scales them (linear_xentropy.py:254-355 of the JAX
  package).

* `vocab_parallel_linear_cross_entropy` is the head over this rank's
  block of the vocabulary (tensor-parallel world size > 1): each
  chunk's max reduced to the global max over the group, then its sum of
  exp, target logit and (with smoothing) logit sum summed over the group
  in one all-reduce; the backward recomputes each chunk's softmax from
  the saved lse and sums the chunk's dx over the group (the hidden
  input is replicated, so this sum is the gradient's whole
  tensor-parallel reduction). The exchanges are `parallel_state`'s.

Semantics per row (ops/xentropy.py of the JAX package): with label y,
smoothing eps and vocab V, loss = lse - (1 - eps) x[y] - (eps / V) sum(x);
rows whose label equals ``padding_idx`` get zero loss and gradient; a
label outside [0, V) contributes no target logit.
"""

from typing import Optional

import torch
import torch.distributed as dist

from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = ["linear_cross_entropy_loss", "linear_cross_entropy_mean",
           "vocab_parallel_linear_cross_entropy"]

_SUBLANE = 8
# chunk * vocab ~ 2^27 elements, as in the JAX package
_DEFAULT_CHUNK_ELEMENTS = 1 << 27


def _chunk_rows(rows: int, vocab: int, chunk_size: Optional[int]) -> int:
    if chunk_size is None:
        chunk_size = max(_SUBLANE, _DEFAULT_CHUNK_ELEMENTS // max(1, vocab))
    chunk_size = max(_SUBLANE, (chunk_size // _SUBLANE) * _SUBLANE)
    return min(chunk_size, max(_SUBLANE, -(-rows // _SUBLANE) * _SUBLANE))


def _mm_f32(a, b):
    """a @ b with an fp32 result (the JAX dW contraction's
    preferred_element_type=float32)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _loss_block(smoothing, x, lbl):
    """(loss, lse, logp) of one fp32 (chunk, V) logits tile, logp its
    log-softmax: one fused pass gives the normalizer, and exp(logp) is
    the softmax the gradient needs."""
    vocab = x.shape[1]
    logp = torch.log_softmax(x, dim=1)
    lse = x[:, 0] - logp[:, 0]
    valid = (lbl >= 0) & (lbl < vocab)
    xt = torch.where(valid, x.gather(1, lbl.clamp(0, vocab - 1)[:, None])[:, 0],
                     0.0)
    loss = lse - (1.0 - smoothing) * xt
    if smoothing > 0.0:
        loss = loss - (smoothing / vocab) * x.sum(dim=1)
    return loss, lse, logp


def _sub_target(p, lbl, smoothing):
    """p - the smoothed one-hot target, in place on the fp32 tile p."""
    vocab = p.shape[1]
    valid = (lbl >= 0) & (lbl < vocab)
    # a scatter, not boolean indexing: that would wait on the device
    p.scatter_add_(1, lbl.clamp(0, vocab - 1)[:, None],
                   torch.where(valid, smoothing - 1.0, 0.0)[:, None])
    if smoothing > 0.0:
        p -= smoothing / vocab
    return p


def _row_weights(labels, loss_mask, padding_idx):
    """fp32 per-row weights reproducing `gpt_loss_fn`: sum(mask * loss) /
    max(sum(mask), 1) with a mask, the plain mean without;
    ``padding_idx`` rows are zeroed from the numerator only."""
    lbl = labels.reshape(-1)
    if loss_mask is not None:
        m = loss_mask.detach().reshape(-1).float()
        rw = m / torch.clamp(m.sum(), min=1.0)
    else:
        rw = torch.full(lbl.shape, 1.0 / lbl.numel(), dtype=torch.float32,
                        device=lbl.device)
    if padding_idx is not None:
        rw = torch.where(lbl == padding_idx, 0.0, rw)
    return rw


def _chunks(rows, chunk):
    return [slice(i, min(i + chunk, rows)) for i in range(0, rows, chunk)]


class _LinearCEMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, loss_mask, smoothing,
                padding_idx, chunk_size):
        h2 = hidden.reshape(-1, hidden.shape[-1])
        rows, hdim = h2.shape
        vocab = weight.shape[0]
        cdt = h2.dtype
        w = weight.to(cdt)
        lbl = labels.reshape(-1).long()
        rw = _row_weights(labels, loss_mask, padding_idx)
        with_grads = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        total = torch.zeros((), dtype=torch.float32, device=h2.device)
        dx = torch.empty_like(h2) if with_grads else None
        dw = (torch.zeros((vocab, hdim), dtype=torch.float32,
                          device=h2.device) if with_grads else None)
        for sl in _chunks(rows, _chunk_rows(rows, vocab, chunk_size)):
            x_c = h2[sl]
            logits = torch.matmul(x_c, w.t()).float()
            loss, _, logp = _loss_block(smoothing, logits, lbl[sl])
            total = total + (rw[sl] * loss).sum()
            if not with_grads:
                continue
            dlog = _sub_target(logp.exp_(), lbl[sl], smoothing)
            dlog = dlog.mul_(rw[sl][:, None]).to(cdt)
            dx[sl] = torch.matmul(dlog, w)
            dw += _mm_f32(dlog.t(), x_c)
        ctx.save_for_backward(dx, dw)
        ctx.hidden_shape = hidden.shape
        ctx.weight_dtype = weight.dtype
        return total

    @staticmethod
    def backward(ctx, g):
        dx, dw = ctx.saved_tensors
        g32 = g.float()
        return (
            (g32 * dx.float()).to(dx.dtype).reshape(ctx.hidden_shape),
            (g32 * dw).to(ctx.weight_dtype),
            None, None, None, None, None,
        )


def linear_cross_entropy_mean(hidden, weight, labels, loss_mask=None,
                              smoothing=0.0, padding_idx=None,
                              chunk_size=None):
    """Scalar masked-mean CE of the fused head ``hidden @ weight^T``:
    equals ``gpt_loss_fn(linear_cross_entropy_loss(...), loss_mask)``,
    with dx and dW finished during the forward. ``hidden`` is
    (..., hidden), ``weight`` (vocab, hidden), ``labels`` integer (...);
    ``loss_mask`` is a constant. Returns an fp32 scalar."""
    return _LinearCEMean.apply(hidden, weight, labels, loss_mask,
                               float(smoothing), padding_idx, chunk_size)


class _LinearCELoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, smoothing, padding_idx,
                chunk_size):
        h2 = hidden.reshape(-1, hidden.shape[-1])
        rows = h2.shape[0]
        w = weight.to(h2.dtype)
        lbl = labels.reshape(-1).long()
        losses = torch.empty((rows,), dtype=torch.float32, device=h2.device)
        lse = torch.empty_like(losses)
        for sl in _chunks(rows, _chunk_rows(rows, w.shape[0], chunk_size)):
            logits = torch.matmul(h2[sl], w.t()).float()
            losses[sl], lse[sl], _ = _loss_block(smoothing, logits, lbl[sl])
        if padding_idx is not None:
            losses = torch.where(lbl == padding_idx, 0.0, losses)
        ctx.save_for_backward(hidden, weight, lbl, lse)
        ctx.args = (smoothing, padding_idx, chunk_size)
        return losses.reshape(labels.shape)

    @staticmethod
    def backward(ctx, dloss):
        hidden, weight, lbl, lse = ctx.saved_tensors
        smoothing, padding_idx, chunk_size = ctx.args
        h2 = hidden.reshape(-1, hidden.shape[-1])
        rows, hdim = h2.shape
        cdt = h2.dtype
        w = weight.to(cdt)
        dl = dloss.reshape(-1).float()
        if padding_idx is not None:
            dl = torch.where(lbl == padding_idx, 0.0, dl)
        dx = torch.empty_like(h2)
        dw = torch.zeros((w.shape[0], hdim), dtype=torch.float32,
                         device=h2.device)
        for sl in _chunks(rows, _chunk_rows(rows, w.shape[0], chunk_size)):
            x_c = h2[sl]
            logits = torch.matmul(x_c, w.t()).float()
            # the softmax from the SAVED lse: no second max/sum pass
            p = torch.exp(logits - lse[sl][:, None])
            dlog = _sub_target(p, lbl[sl], smoothing).mul_(dl[sl][:, None])
            dlog = dlog.to(cdt)
            dx[sl] = torch.matmul(dlog, w)
            dw += _mm_f32(dlog.t(), x_c)
        return (dx.reshape(hidden.shape), dw.to(weight.dtype), None, None,
                None, None)


def linear_cross_entropy_loss(hidden, weight, labels, smoothing=0.0,
                              padding_idx=None, chunk_size=None):
    """Per-row smoothed CE of the fused head ``hidden @ weight^T``: fp32
    losses shaped like ``labels``, differentiable under any per-row
    cotangent (the backward recomputes each chunk's softmax from the
    saved lse)."""
    return _LinearCELoss.apply(hidden, weight, labels, float(smoothing),
                               padding_idx, chunk_size)


def _vp_target(logits, lbl, start):
    """The columns of this rank's block that hold each row's label (the
    comparison is False everywhere when the label lies on another
    rank)."""
    col = torch.arange(logits.shape[1], device=logits.device)
    return col[None, :] == (lbl - start)[:, None]


class _VocabParallelLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, group, smoothing, padding_idx,
                chunk_size):
        h2 = hidden.reshape(-1, hidden.shape[-1])
        rows = h2.shape[0]
        w = weight.to(h2.dtype)
        v_local = w.shape[0]
        vocab = v_local * dist.get_world_size(group)
        start = parallel_state.axis_rank(group) * v_local
        lbl = labels.reshape(-1).long()
        losses = torch.empty((rows,), dtype=torch.float32, device=h2.device)
        lse = torch.empty_like(losses)
        for sl in _chunks(rows, _chunk_rows(rows, v_local, chunk_size)):
            logits = torch.matmul(h2[sl], w.t()).float()
            m = parallel_state.all_reduce(logits.max(dim=1).values, group,
                                          op="max")[:, None]
            parts = [(logits - m).exp().sum(dim=1),
                     torch.where(_vp_target(logits, lbl[sl], start), logits,
                                 0.0).sum(dim=1)]
            if smoothing > 0.0:
                parts.append(logits.sum(dim=1))
            sums = parallel_state.all_reduce(torch.stack(parts), group)
            lse[sl] = m[:, 0] + sums[0].log()
            losses[sl] = lse[sl] - (1.0 - smoothing) * sums[1]
            if smoothing > 0.0:
                losses[sl] -= (smoothing / vocab) * sums[2]
        if padding_idx is not None:
            losses = torch.where(lbl == padding_idx, 0.0, losses)
        ctx.save_for_backward(hidden, weight, lbl, lse)
        ctx.args = (group, smoothing, padding_idx, chunk_size, vocab, start)
        return losses.reshape(labels.shape)

    @staticmethod
    def backward(ctx, dloss):
        hidden, weight, lbl, lse = ctx.saved_tensors
        group, smoothing, padding_idx, chunk_size, vocab, start = ctx.args
        h2 = hidden.reshape(-1, hidden.shape[-1])
        rows, hdim = h2.shape
        cdt = h2.dtype
        w = weight.to(cdt)
        dl = dloss.reshape(-1).float()
        if padding_idx is not None:
            dl = torch.where(lbl == padding_idx, 0.0, dl)
        dx = torch.empty_like(h2)
        dw = torch.zeros((w.shape[0], hdim), dtype=torch.float32,
                         device=h2.device)
        for sl in _chunks(rows, _chunk_rows(rows, w.shape[0], chunk_size)):
            x_c = h2[sl]
            logits = torch.matmul(x_c, w.t()).float()
            # the global softmax's local columns, from the saved lse
            p = torch.exp(logits - lse[sl][:, None])
            tgt = torch.where(_vp_target(logits, lbl[sl], start),
                              1.0 - smoothing, 0.0) + smoothing / vocab
            dlog = ((p - tgt) * dl[sl][:, None]).to(cdt)
            dx[sl] = parallel_state.all_reduce(torch.matmul(dlog, w), group)
            dw += _mm_f32(dlog.t(), x_c)
        return (dx.reshape(hidden.shape), dw.to(weight.dtype), None, None,
                None, None, None)


def vocab_parallel_linear_cross_entropy(hidden, weight, labels, axis_name,
                                        smoothing=0.0, padding_idx=None,
                                        chunk_size=None):
    """`linear_cross_entropy_loss` over a vocab-sharded head: ``hidden``
    (..., hidden) the same on every rank of the group bound to
    ``axis_name``, ``weight`` this rank's (vocab / tp, hidden) block,
    ``labels`` global ids. Returns the per-row fp32 losses, the same on
    every rank. The gradient of ``hidden`` is summed over the group
    inside (do not also pass the input through
    `copy_to_tensor_model_parallel_region`); the gradient of ``weight``
    is this rank's block's."""
    group = parallel_state.resolve_group(axis_name)
    return _VocabParallelLinearCE.apply(hidden, weight, labels, group,
                                        float(smoothing), padding_idx,
                                        chunk_size)
