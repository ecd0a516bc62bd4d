#!/usr/bin/env python3
"""Digests of kernel outputs on seeded inputs, to compare two trees' bits.

    python3 kernel_digest.py [--tree DIR] [--time]

Imports ``rocm_apex_tpu_torch`` from DIR (default: the directory of this
script), runs on one CUDA device, on inputs drawn from fixed seeds:

- the paged decode read (row 6: bf16, fp32 and int8 pools at pages of 16
  and 64, the serve's decode grid and chunk piece B);
- the 3x3 bottleneck backward (row 17 K4: ResNet-50's five stride-1
  blocks at B 128 in bf16, a ragged M, W 2, a ragged split, and fp32) and
  the 1x1 backward (K3: its conv3 and conv1 flag sets at layer3 and
  layer4, bf16, and fp32);
- the bottleneck forwards (K1: the 1x1 with and without its prologue; K2:
  the 3x3 with its prologue and bare; each at layer3, layer4, a ragged M
  and W 2, in bf16 and fp32; and K1 as the ResNet-50 blocks call it,
  conv1 bare and conv3 under its prologue, at layer1_1 and layer4, bf16);
- the forwards that round p against their running max (the contiguous
  decode read, row 5, at the decode grid; the serving segment read, row
  3, at the serve's chunk; the packed forward, rows 7a/8, at the GPT
  train cell with bias; the unpacked forward, row 7b, at masked BERT's
  shape and split at the whole-prompt shape; bf16 and fp32);
- the training segment attention forward and backward (rows 3 and 4, at
  contrib/fmha's shape, bf16 and fp32), the unpacked backward and bias
  gradient (rows 9b and 10, masked BERT's shape; 9b's dq, dk and dv
  apart, and again with o = 0, where delta is 0 in any order; row 10 in
  bf16 with and without dropout, and with a bias row a head (no sum over
  heads), its products S and dP read back through
  its output, and dP's count of elements off the fp64 product), and the
  packed backward
  (row 11, the GPT train cell's, bf16 and fp32), each backward on a
  forward's outputs made here by plain torch ops, so that two trees feed
  it the same o and lse;
- the LayerNorm forward (row 1: the serve's form, (8, 1024) and (264,
  1024) bf16 -> fp32; the training form, (16384, 1024) residual +
  dropout 0.1, bf16 and fp32, its stream s apart from y, mean and
  rsigma) and backward (row 2: the training step's residual + dropout
  form with the stream cotangent, bf16 and fp32, and its plain affine
  form, on statistics made by torch ops; the serve's 8 rows, a block a
  row, and width 1002, off the vector grid, its dx and dd apart from
  dgamma and dbeta; the non-affine forward and backward at (16384, 1024)
  bf16 and fp32, where the tree has that form);
- the softmax kernels (row 12: the causal forward K1 at the GPT train
  cell's (128, 1024, 1024) scores, at a ragged 333 keys and at 4096
  keys a row (streaming), the masked forward K2 at masked
  BERT-Large's (8, 8, 512, 512) under a padding mask, the backward K3 at
  both shapes on a softmax made by torch ops; fp32 and bf16);

and prints one JSON line: the sha256 of each call's outputs. Two trees
whose lines agree give those kernels the same bits on the same card and
PyTorch build. With ``--time`` the serving segment read (the serve's chunk)
and the bias gradient (masked BERT, dropout 0.1) are timed too, so
that two trees run in one call give their times on one card. It imports
nothing of JAX.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import torch


def _digest(outs):
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()[:16]


# --time: the calls `_timed` digests are also timed, device time alone:
# behind a sleep kernel twice as long as the host takes to launch
# TIME_ITERS calls, so that they run back to back between two CUDA events
# (chip_smoke.py's `device_ms`); the median of TIME_ROUNDS such means,
# under "<name> ms"
TIME = False
TIME_ITERS, TIME_ROUNDS = 20, 5
_SLEEP_CYCLES_PER_S = []


def _device_ms(call):
    if not _SLEEP_CYCLES_PER_S:
        torch.cuda._sleep(1000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _SLEEP_CYCLES_PER_S.append(1e7 / (a.elapsed_time(b) / 1e3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIME_ITERS):
        call()
    torch.cuda.synchronize()
    launch_s = time.perf_counter() - t0
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2 * launch_s * _SLEEP_CYCLES_PER_S[0]) + 1000)
    a.record()
    for _ in range(TIME_ITERS):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / TIME_ITERS


def _timed(out, name, call):
    """out[name] = the digest of call()'s outputs; with --time, also the
    median device ms of one call."""
    out[name] = _digest(call())
    if TIME:
        ms = sorted(_device_ms(call) for _ in range(TIME_ROUNDS))
        out[f"{name} ms"] = f"{ms[len(ms) // 2]:.4f}"


def _flat(out):
    """(y, sums) of a bottleneck forward as a flat tuple of tensors."""
    y, sums = out
    return (y,) + (tuple(sums) if sums is not None else ())


def _lse(q, k, scale, causal, bias=None):
    """The natural-log lse of fp32 scores (b, sq, sk), by torch ops: a
    forward's output for the backward digests, the same on every tree."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.repeat_interleave(s.shape[0] // bias.shape[0], dim=0)
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool,
                                      device=s.device).tril(), float("-inf"))
    return torch.logsumexp(s, dim=-1).contiguous()


def _flash_digests(out, fa, fas, dev, gen):
    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device=dev)).to(dtype)

    # rows 3 and 4: segment attention, 8 heads x 4096 tokens of 64 dims
    lens = [300, 1000, 7, 1789, 1000]
    seg = torch.repeat_interleave(
        torch.arange(len(lens), device=dev),
        torch.tensor(lens, device=dev)).int()
    total, h, d = sum(lens), 8, 64
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = (rnd(h, total, d, dtype=dt) for _ in range(4))
        o, lse = fas._seg_fwd(q, k, v, seg, True, d ** -0.5)
        out[f"segments fwd {str(dt)[6:]}"] = _digest((o, lse))
        o = rnd(h, total, d, dtype=dt)
        out[f"segments bwd {str(dt)[6:]}"] = _digest(fas._seg_bwd(
            q, k, v, seg, o, lse, do, True, d ** -0.5))
    # rows 9b and 10: masked BERT (B 8 x 8 heads, S 512, hd 128), a -1e30
    # bias on the padded keys, dropout 0.1
    B, H, S, D = 8, 8, 512, 128
    bias = torch.zeros(B, S, S, device=dev)
    for b in range(B):
        bias[b, :, S - 37 * (b + 1):] = -1e30
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, o, do = (rnd(B, H, S, D, dtype=dt) for _ in range(5))
        lse = _lse(q.reshape(-1, S, D), k.reshape(-1, S, D), D ** -0.5,
                   False, bias)
        args = (q, k, v, bias, o, lse, do, None, False, D ** -0.5, None, 0.1,
                7)
        for name, g in zip(("dq", "dk", "dv"),
                           fa._unpacked_bwd(*args, False)[:3]):
            out[f"unpacked bwd {name} {str(dt)[6:]}"] = _digest((g,))
        # o = 0: delta is exactly 0 in any summation order, so dq and dk
        # show the products' bits apart from delta's
        zargs = args[:4] + (torch.zeros_like(o),) + args[5:]
        for name, g in zip(("dq", "dk", "dv"),
                           fa._unpacked_bwd(*zargs, False)[:3]):
            out[f"unpacked bwd {name} o 0 {str(dt)[6:]}"] = _digest((g,))
        delta = (do.float() * o.float()).sum(-1).reshape(B * H, S)
        delta = delta.contiguous()
        _timed(out, f"dbias {str(dt)[6:]}", lambda: (fa._flash_dbias(
            q, k, v, bias, lse, do, delta, False, D ** -0.5, None, 0.1,
            7),))
        if dt == torch.bfloat16:  # the same without dropout; and with a
            # bias row a head, where no sum over heads is formed
            _timed(out, "dbias bfloat16 no dropout", lambda: (
                fa._flash_dbias(q, k, v, bias, lse, do, delta, False,
                                D ** -0.5, None, 0.0, 7),))
            out["dbias bfloat16 no dropout, a bias row a head"] = _digest((
                fa._flash_dbias(q, k, v, bias.repeat_interleave(H, dim=0),
                                lse, do, delta, False, D ** -0.5, None, 0.0,
                                7),))
    # row 10's products read back, bf16, a bias row a head, no dropout: q
    # = 0, lse = 0, delta = 0 give ds = dP; do = 0, lse = 0, delta = -1
    # give ds = exp2(S). dP's elements off the fp64 product rounded to fp32
    # are counted.
    q, k, v, do = (rnd(B, H, S, D, dtype=torch.bfloat16) for _ in range(4))
    zb = torch.zeros(B * H, S, S, device=dev)
    z = torch.zeros(B * H, S, device=dev)
    dp = fa._flash_dbias(torch.zeros_like(q), k, v, zb, z, do, z, False,
                         D ** -0.5, None, 0.0, 7)
    exact = torch.einsum("bhqd,bhkd->bhqk", do.double(), v.double()).reshape(
        B * H, S, S).float()
    out["dbias dP readback bfloat16"] = _digest((dp,))
    out["dbias dP readback bfloat16, off fp64"] = str(int((dp != exact).sum()))
    out["dbias S readback bfloat16"] = _digest((fa._flash_dbias(
        q, k, v, zb, z, torch.zeros_like(do), z - 1.0, False, D ** -0.5,
        None, 0.0, 7),))
    del zb, dp, exact
    # row 11: the packed backward at the GPT train cell, bias, dropout 0.1
    B, S, nh, hd = 16, 1024, 8, 128
    for dt in (torch.bfloat16, torch.float32):
        qkv = rnd(B, S, nh, 3 * hd, dtype=dt)
        pbias = rnd(nh * 3 * hd, dtype=dt, scale=0.1)
        o, do = (rnd(B, S, nh * hd, dtype=dt) for _ in range(2))
        x = (qkv.float() + pbias.float().view(nh, 3 * hd)).to(dt)
        q, k, _ = x.permute(0, 2, 1, 3).reshape(B * nh, S, 3 * hd).split(
            hd, dim=-1)
        lse = _lse(q, k, hd ** -0.5, True)
        out[f"packed bwd {str(dt)[6:]}"] = _digest(fa._flash_bwd(
            qkv, pbias, o, lse, do, True, hd ** -0.5, 0.1, 11))


def _fwd_digests(out, fa, fas, dev, gen):
    """The forwards whose p is rounded against a running max (rows 3, 5,
    7a/8, 7b), bf16 and fp32."""
    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device=dev)).to(dtype)

    lens = torch.tensor([1024, 0, 17, 513, 300, 64, 1000, 129],
                        dtype=torch.int32, device=dev)
    seg = torch.tensor([3] * 97 + [0] * 64 + [5] * 40 + [6] * 32 + [8] * 23,
                       dtype=torch.int32, device=dev)
    bias = torch.zeros(8, 512, 512, device=dev)
    for b in range(8):
        bias[b, :, 512 - 37 * (b + 1):] = -1e30
    for dt in (torch.bfloat16, torch.float32):
        lab = str(dt)[6:]
        q = rnd(8, 8, 128, dtype=dt, scale=2.0)
        k, v = (rnd(8, 1024, 8, 128, dtype=dt) for _ in range(2))
        out[f"decode grid {lab}"] = _digest(fa.flash_attention_decode(
            q, k, v, lens, return_lse=True))
        q, k, v = (rnd(8, 256, 128, dtype=dt, scale=2.0) for _ in range(3))
        _timed(out, f"segments serve {lab}",
               lambda: fas.flash_attention_segments_with_lse(q, k, v, seg,
                                                             True))
        qkv = rnd(16, 1024, 8, 384, dtype=dt)
        pbias = rnd(8 * 384, dtype=dt, scale=0.1)
        out[f"packed fwd {lab}"] = _digest(fa._flash_fwd(
            qkv, pbias, True, 128 ** -0.5, 0.1, 11))
        del qkv
        q, k, v = (rnd(8, 8, 512, 128, dtype=dt) for _ in range(3))
        out[f"unpacked fwd {lab}"] = _digest(fa._unpacked_fwd(
            q, k, v, bias, False, 128 ** -0.5, None, 0.1, 7))
        q, k, v = (rnd(1, 8, 768, 128, dtype=dt) for _ in range(3))
        out[f"unpacked fwd split {lab}"] = _digest(fa._unpacked_fwd(
            q, k, v, None, True, 128 ** -0.5, None, 0.0, 7))


def _row_digests(out, ln, sm, dev):
    """Rows 1, 2 and 12 (the LayerNorm and softmax kernels), on inputs of
    their own generator."""
    gen = torch.Generator(device=dev).manual_seed(15)

    def rnd(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=gen,
                                            device=dev)).to(dtype)

    h = 1024
    for rows in (8, 264):
        x = rnd(rows, h, dtype=torch.bfloat16)
        w, b = rnd(h, scale=0.1, shift=1.0), rnd(h, scale=0.1)
        y, _, mu, rs = ln._ln_fwd_impl(x, None, w, b, 1e-5, torch.float32)
        out[f"ln fwd serve ({rows}, {h}) bfloat16 -> float32"] = _digest(
            (y, mu, rs))
    rows, rate, seed = 16384, 0.1, 2024
    for dt in (torch.bfloat16, torch.float32):
        lab = str(dt)[6:]
        x, d = rnd(rows, h, dtype=dt), rnd(rows, h, dtype=dt)
        w, b = rnd(h, scale=0.1, shift=1.0, dtype=dt), rnd(h, scale=0.1,
                                                           dtype=dt)
        y, s_, mu, rs = ln._ln_fwd_impl(x, d, w, b, 1e-5, dt, rate, seed)
        out[f"ln fwd train s {lab}"] = _digest((s_,))
        out[f"ln fwd train y mean rsigma {lab}"] = _digest((y, mu, rs))
        # row 2 on statistics made by torch ops: the same on every tree
        sf = s_.float()
        mu = sf.mean(1)
        rs = torch.rsqrt(((sf - mu[:, None]) ** 2).mean(1) + 1e-5)
        dy, ds = rnd(rows, h, dtype=dt), rnd(rows, h, dtype=dt)
        out[f"ln bwd residual+dropout {lab}"] = _digest(ln._layer_norm_bwd(
            s_, dy, ds, mu, rs, w, rate, seed))
        if dt == torch.bfloat16:
            out[f"ln bwd plain affine {lab}"] = _digest(ln._layer_norm_bwd(
                s_, dy, None, mu, rs, w))
    # row 2's other layouts: the serve's rows (a block a row) and a width
    # off the vector grid (dx and dd apart from the column sums)
    for n, width in ((8, h), (4096, 1002)):
        x = rnd(n, width, dtype=torch.bfloat16)
        w = rnd(width, scale=0.1, shift=1.0, dtype=torch.bfloat16)
        xf = x.float()
        mu = xf.mean(1)
        rs = torch.rsqrt(((xf - mu[:, None]) ** 2).mean(1) + 1e-5)
        dy, ds = (rnd(n, width, dtype=torch.bfloat16) for _ in range(2))
        dx, dd, dg, db = ln._layer_norm_bwd(x, dy, ds, mu, rs, w, rate,
                                            seed)
        out[f"ln bwd ({n}, {width}) dx dd"] = _digest((dx, dd))
        out[f"ln bwd ({n}, {width}) dgamma dbeta"] = _digest((dg, db))
    gpt, bert = (128, 1024, 1024), (8, 8, 512, 512)
    lens = torch.tensor([512 - 37 * i for i in range(8)], device=dev)
    pos = torch.arange(512, device=dev)
    live = pos[None, :] < lens[:, None]
    mask = ~(live[:, None, :, None] & live[:, None, None, :])
    for dt in (torch.float32, torch.bfloat16):
        lab = str(dt)[6:]
        x = rnd(*gpt, scale=3.0, dtype=dt)
        out[f"softmax causal fwd GPT {lab}"] = _digest(
            (sm.softmax_causal_fwd(x, 128 ** -0.5),))
        upper = torch.ones(gpt[1:], dtype=torch.bool, device=dev).triu(1)
        y = torch.softmax((x.float() * 128 ** -0.5).masked_fill(
            upper, float("-inf")), -1).to(dt)
        del x
        out[f"softmax bwd GPT {lab}"] = _digest(
            (sm.softmax_bwd(y, rnd(*gpt, dtype=dt), 128 ** -0.5),))
        del y
        for shape in ((16, 333, 333), (2, 4096, 4096)):
            out[f"softmax causal fwd {shape} {lab}"] = _digest(
                (sm.softmax_causal_fwd(rnd(*shape, scale=3.0, dtype=dt),
                                       0.1),))
        x = rnd(*bert, scale=3.0, dtype=dt)
        out[f"softmax masked fwd BERT {lab}"] = _digest(
            (sm.softmax_masked_fwd(x, mask, 128 ** -0.5),))
        y = torch.softmax((x.float() * 128 ** -0.5).masked_fill(
            mask, -10000.0), -1).to(dt)
        out[f"softmax bwd BERT {lab}"] = _digest(
            (sm.softmax_bwd(y, rnd(*bert, dtype=dt), 128 ** -0.5),))
    if not hasattr(ln, "LN_BWD_NOAFFINE"):
        return  # a tree without row 2's non-affine form
    # rows 1 and 2 without a weight (the non-affine forward, and the
    # backward with no dgamma/dbeta and no reduction), on a generator of
    # their own so that the inputs above stay as they were
    gen2 = torch.Generator(device=dev).manual_seed(16)
    for dt in (torch.bfloat16, torch.float32):
        lab = str(dt)[6:]
        x, dy = (torch.randn(16384, h, generator=gen2, device=dev).to(dt)
                 for _ in range(2))
        y, _, mu, rs = ln._ln_fwd_impl(x, None, None, None, 1e-5, dt)
        out[f"ln fwd non-affine (16384, {h}) {lab}"] = _digest((y, mu, rs))
        xf = x.float()
        mu = xf.mean(1)
        rs = torch.rsqrt(((xf - mu[:, None]) ** 2).mean(1) + 1e-5)
        out[f"ln bwd non-affine (16384, {h}) {lab}"] = _digest(
            ln._layer_norm_bwd(x, dy, None, mu, rs, None)[:1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--time", action="store_true",
                    help="also time the serving segment read and the bias "
                         "gradient (\"<name> ms\")")
    args = ap.parse_args(argv)
    global TIME
    TIME = args.time
    sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("kernel_digest: no CUDA device", file=sys.stderr)
        return 2
    from rocm_apex_tpu_torch.ops import flash_attention as fa
    from rocm_apex_tpu_torch.ops import flash_attention_segments as fas
    from rocm_apex_tpu_torch.ops import fused_bottleneck as fb
    from rocm_apex_tpu_torch.ops import layer_norm as ln
    from rocm_apex_tpu_torch.ops import softmax as sm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    slots, cap, heads, hd = 8, 1024, 8, 128
    lens = torch.tensor([1024, 0, 17, 513, 300, 64, 1000, 129],
                        dtype=torch.int32, device=dev)
    ids = torch.tensor([3] * 97 + [0] * 64 + [5] * 40 + [6] * 32
                       + [slots] * 23, dtype=torch.int32, device=dev)
    for ps in (16, 64):
        pages = slots * cap // ps
        table = torch.randperm(pages, generator=torch.Generator().manual_seed(
            ps)).int().reshape(slots, cap // ps).to(dev)
        shape = (pages, heads, ps, hd)
        for pool in ("bf16", "fp32", "int8"):
            dt = torch.float32 if pool == "fp32" else torch.bfloat16
            if pool == "int8":
                k, v = (torch.randint(-127, 128, shape, generator=gen,
                                      device=dev, dtype=torch.int8)
                        for _ in range(2))
                ks, vs = (0.005 + 0.02 * torch.rand(
                    (pages, heads), generator=gen, device=dev)
                    for _ in range(2))
            else:
                k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                        for _ in range(2))
                ks = vs = None
            for form, rows, sl in (("grid", slots, None),
                                   ("piece B", 256, ids)):
                q = torch.randn(rows, heads, hd, generator=gen,
                                device=dev).to(dt)
                out[f"paged {pool} page {ps} {form}"] = _digest(
                    fa.flash_attention_decode_paged(
                        q, k, v, table, lens, None, ks, vs, return_lse=True,
                        slot_ids=sl))
    for name, n, h, c, dt in (
            ("layer1", 128, 56, 64, torch.bfloat16),
            ("layer2", 128, 28, 128, torch.bfloat16),
            ("layer3", 128, 14, 256, torch.bfloat16),
            ("layer4", 128, 7, 512, torch.bfloat16),
            ("ragged M", 3, 7, 64, torch.bfloat16),
            ("W 2", 4, 2, 64, torch.bfloat16),
            ("ragged split", 3, 13, 128, torch.bfloat16),
            ("fp32", 8, 14, 64, torch.float32)):

        def rnd(*shape, scale=1.0, shift=0.0):
            return (shift + scale * torch.randn(*shape, generator=gen,
                                                device=dev))

        e = rnd(n, h, h, c, scale=1e-2).to(dt)
        x = rnd(n, h, h, c).to(dt)
        y = rnd(n, h, h, c).to(dt)
        w = rnd(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5).to(dt)
        kf = (rnd(c, scale=0.1, shift=1.0), rnd(c, scale=1e-3),
              rnd(c, scale=1e-3))
        pro = (rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1))
        red = (rnd(c, scale=0.1), rnd(c, scale=0.1, shift=1.0))
        out[f"conv3 bwd {name}"] = _digest(
            fb.conv3x3_bn_act_bwd(e, w, x, (y, *kf), pro, red))
    for name, m, k, n, dt in (
            ("layer3 conv3", 128 * 14 * 14, 256, 1024, torch.bfloat16),
            ("layer3 conv1", 128 * 14 * 14, 1024, 256, torch.bfloat16),
            ("layer4 conv3", 128 * 7 * 7, 512, 2048, torch.bfloat16),
            ("layer4 conv1", 128 * 7 * 7, 2048, 512, torch.bfloat16),
            ("fp32", 8 * 14 * 14, 64, 256, torch.float32)):
        # conv3: z's pre-mask, the finalize, the prologue and reductions;
        # conv1: the finalize and the prologue, no reductions
        e = rnd(m, n, scale=1e-2).to(dt)
        x = rnd(m, k).to(dt)
        w = rnd(k, n, scale=(2.0 / k) ** 0.5).to(dt)
        y_fin = (rnd(m, n).to(dt), rnd(n, scale=0.1, shift=1.0),
                 rnd(n, scale=1e-3), rnd(n, scale=1e-3))
        pro = (rnd(k, scale=0.1, shift=1.0), rnd(k, scale=0.1))
        conv3 = "conv3" in name or name == "fp32"
        z = rnd(m, n).to(dt) if conv3 else None
        red = ((rnd(k, scale=0.1), rnd(k, scale=0.1, shift=1.0)) if conv3
               else None)
        out[f"conv1x1 bwd {name}"] = _digest(
            fb.conv1x1_bn_act_bwd(e, w, x, z, y_fin, pro, red))
    for name, n, h, c in (("layer3", 128, 14, 256), ("layer4", 128, 7, 512),
                          ("ragged M", 3, 7, 64), ("W 2", 4, 2, 64)):
        for dt in (torch.bfloat16, torch.float32):
            x = rnd(n, h, h, c).to(dt)
            w3 = rnd(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5).to(dt)
            w1 = rnd(c, 4 * c, scale=(2.0 / c) ** 0.5).to(dt)
            a, b = rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)
            x2 = x.reshape(-1, c)
            lab = f"{name} {str(dt)[6:]}"
            out[f"conv1x1 fwd prologue {lab}"] = _digest(
                _flat(fb.conv1x1_bn_act(x2, w1, a, b)))
            out[f"conv1x1 fwd bare {lab}"] = _digest(
                _flat(fb.conv1x1_bn_act(x2, w1)))
            # y alone: the products' bits apart from the sums' order
            out[f"conv1x1 fwd bare y {lab}"] = _digest(
                (fb.conv1x1_bn_act(x2, w1, stats=False)[0],))
            out[f"conv3 fwd prologue {lab}"] = _digest(
                _flat(fb.conv3x3_bn_act(x, w3, a, b)))
            out[f"conv3 fwd bare {lab}"] = _digest(
                _flat(fb.conv3x3_bn_act(x, w3, stats=False)))
    _flash_digests(out, fa, fas, dev, gen)
    # K1 at the blocks' own widths: conv1 (Cin -> Cmid, bare), conv3 (Cmid
    # -> Cout under the bn2 prologue)
    for name, n, h, cin, cmid, cout in (("layer1_1", 128, 56, 256, 64, 256),
                                        ("layer4", 128, 7, 2048, 512, 2048)):
        m = n * h * h
        x = rnd(m, cin).to(torch.bfloat16)
        w1 = rnd(cin, cmid, scale=(2.0 / cin) ** 0.5).to(torch.bfloat16)
        y2 = rnd(m, cmid).to(torch.bfloat16)
        w3 = rnd(cmid, cout, scale=(2.0 / cmid) ** 0.5).to(torch.bfloat16)
        a, b = rnd(cmid, scale=0.1, shift=1.0), rnd(cmid, scale=0.1)
        out[f"conv1x1 fwd conv1 {name} bfloat16"] = _digest(
            _flat(fb.conv1x1_bn_act(x, w1)))
        out[f"conv1x1 fwd conv3 {name} bfloat16"] = _digest(
            _flat(fb.conv1x1_bn_act(y2, w3, a, b)))
    _row_digests(out, ln, sm, dev)
    _fwd_digests(out, fa, fas, dev, torch.Generator(device=dev).manual_seed(
        12))
    torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
