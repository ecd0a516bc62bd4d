#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--profile] [--only PHASES]

Drives ``rocm_apex_tpu_torch`` only (it imports nothing of JAX or of the
JAX package) through these phases, in order; any failure exits non-zero:

1. device    the card's name and power limit, as nvidia-smi reports them;
2. build     every kernel of ``rocm_apex_tpu_torch/csrc`` with nvcc
             (one process per source, started together);
3. kernels   each kernel's wrapper on card tensors at the shapes of the
             serve and of the training step, in bf16 and fp32, held
             against its plain PyTorch version on the same inputs
             (dropout cases included: both draw the same keep bits; the
             paged decode read at page sizes 16 and 64 over bf16, fp32
             and int8 pools, with prefixes ending mid-page and a dead row
             whose bound reaches unmapped table entries; the unpacked
             flash forward, backward and dbias at the masked BERT-Large,
             whole-prompt, ragged and varlen shapes, and the unpacked
             kernels equal to the packed ones on a projection's views;
             the training segment attention forward and backward at
             bench.py's fmha batch, causal and not, at masked BERT-Large
             lengths with head_dim 128, in fp32 and with ids out of
             order; the cross-entropy's two-pass backward);
             kernel, plain and library times with CUDA events, and the
             least time the card could take (bound);
4. parity    the serving config at full width but 2 layers, fp32 with
             TF32 off: first-chunk logits and greedy tokens of the engine
             on the card (kernels) against the engine on the CPU (plain
             versions), from the same seeded weights; then the paged
             engine (page size 16): its tokens on the card against the
             CPU's and the contiguous engine's, int8 pages card against
             CPU (tokens, and the logits of two chunks), prefix sharing
             against no sharing (tokens; hits and copy-on-write forks
             counted), and a pool below demand (page stalls, every
             request done, no page left in use); the whole-prompt engine's
             tokens on the card against the CPU's and the chunked ones;
5. serve     the full serving config in bf16 (GPT 8 layers, hidden 1024,
             8 heads, vocab 32768; 8 slots, capacity 1024, budget 256) on
             32 requests of 64 new tokens, greedy; every kernel's launch
             count is reset just before the timed run and read after it,
             and each serving kernel's must be > 0;
6. serve_paged  the same serve on the paged cache (page size 16, the
             worst-case pool) in three forms: bf16 pages, int8 pages, and
             bench.py's shared-prefix traffic (a 250-token prefix and
             4-16 random tail tokens) with prefix sharing; per form the
             serve's metrics, cache bytes, peak pages in use, the paged
             kernel's launches (> 0 for the variant the form runs) and
             the requests whose tokens match the contiguous serve's;
   serve_whole  the serve on the whole-prompt path (bench.py serve's A/B
             baseline: a padded (1, 768) prefill per admit, the causal
             unpacked forward once per admit and layer), its metrics and
             the requests whose tokens match the chunked serve's;
7. train parity  the training config at full width but 2 layers, S 256,
             B 2, fp32 with TF32 off, dropout 0: three optimizer steps on
             the card against the same on the CPU — losses within a
             stated tolerance, the same skip decisions;
8. train     the bench.py GPT step in bf16 with fp32 masters (8 layers,
             hidden 1024, 8 heads, vocab 32768, B 16 x S 1024, dropout
             0.1, fused linear+CE head, MixedPrecisionAdam under a dynamic
             LossScaler): 5 warm-up and 20 timed steps on one batch;
             tokens/s, step ms, losses, peak memory, and each training
             kernel's wrapper calls per step against the stack's count;
9. bert train parity  the BERT config at full width but 2 layers, S 128,
             B 2, fp32 with TF32 off: three LAMB steps on the card
             against the same on the CPU (losses within a stated
             tolerance, the same found_inf), then one step with an inf in
             a gradient, which must leave masters, moments and count bit
             for bit as they were;
10. bert train  bench.py's BERT step (`build_bert_train` on an
             accelerator) in bf16 with fp32 masters: BERT-Large shape (24
             layers, hidden 1024, 8 heads, ffn 4096, vocab 30592, B 8 x
             S 512, dropout 0, no attention mask, the binary head),
             MixedPrecisionLamb(1e-4, wd 0.01 but for biases and
             LayerNorms, bf16 moments, store_model=False) with the global
             gradient norm as the overflow probe: 5 warm-up and 20 timed
             steps on one batch, then one evaluation forward under
             no_grad; tokens/s, step ms, losses, peak memory, and each
             kernel's wrapper calls against the stack's count; then
             masked BERT: parity as phase 9 with a padding mask of two
             lengths, and the BERT-Large step with a padding mask of
             seeded lengths and dropout 0.1 (the unpacked kernels 24 +
             24 calls a step, no packed or dbias call);
11. fmha     contrib/fmha at bench.py's fmha configuration (64 sequences
             of RandomState(0) lengths, 17408 tokens, max_s 2048, 8
             heads x 64, causal, bf16): the loss sum(o^2), forward +
             backward, 5 warm-up and 20 timed iterations, packed (the
             training segment kernels, one forward and one backward
             call an iteration, no serving-kernel call) and padded (the
             unpacked kernels); ms, padded / packed, peak memory above
             the inputs (packed under 10x the qkv and under padded),
             packed == padded on the card, fp32 cuda == cpu;
12. xentropy contrib/xentropy's SoftmaxCrossEntropyLoss at the BERT
             head's logits, forward + backward (the plain forward and the
             two-pass backward kernel, one call each an iteration), zero
             gradient on padded rows, fp32 cuda == cpu == F.cross_entropy;
13. report   a ``{"kernels": [...]}`` line, then the device line
             ``{"ok": true, "device": {...}}`` as the last line.

``--out DIR`` also writes every number and the compiler's register and
spill report to DIR/chip_smoke.json. ``--profile`` adds profiled serve
(contiguous and paged) and train (GPT and BERT) windows that report the
device's busy share. ``--only`` runs a subset of the phases (a check of
one part; the full run is the smoke); ``kernels:xent+lamb`` there names a
subset of the kernel phase's case groups (ln, seg, decode, paged,
train_ln, flash, xent, lamb, unpacked, seg_train).

It needs one CUDA device and nvcc (CUDA_HOME, PATH or /usr/local/cuda).
"""

import argparse
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# the operation rates by input type; a kernel on CUDA cores in fp32 is
# held to the fp32 rate, one reading bf16 to the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the serving config (bench.py serve on the accelerator)
SERVE = dict(vocab_size=32768, hidden_size=1024, num_layers=8,
             num_attention_heads=8, max_position_embeddings=1024,
             tensor_parallel_size=1)
SLOTS, CAPACITY, BUDGET = 8, 1024, 256
PROMPT_LENS, PROMPT_P = [32, 64, 128, 256, 768], [0.3, 0.3, 0.2, 0.15, 0.05]
N_REQUESTS, MAX_NEW = 32, 64

# the training config (bench.py's GPT step on an accelerator,
# bench.py:2315-2340): bf16 compute, fp32 masters, dropout 0.1, the fused
# linear+CE head with the mean loss, MixedPrecisionAdam(1e-4, wd 0.01)
# under a dynamic LossScaler; 5 warm-up and 20 timed steps on one batch
TRAIN = dict(vocab_size=32768, hidden_size=1024, num_layers=8,
             num_attention_heads=8, max_position_embeddings=1024,
             tensor_parallel_size=1, hidden_dropout=0.1,
             attention_dropout=0.1)
TRAIN_BATCH, TRAIN_SEQ = 16, 1024
TRAIN_WARMUP, TRAIN_STEPS = 5, 20
# wrapper calls per step of the chained pre-LN stack at 8 layers: one
# attention forward and backward a layer; 17 LN forwards (layer 0's
# plain ln1, 8 ln2, 7 chained ln1, the final LN — all but the first
# with dropout) and as many backwards
TRAIN_CALLS_PER_STEP = {
    "flash_attention_qkv_fwd": 8,
    "flash_attention_qkv_bwd": 8,
    "layer_norm_fwd": 1,
    "layer_norm_fwd_dropout": 16,
    "layer_norm_bwd": 17,
}
# train parity, cuda vs cpu: the bench widths at 2 layers, S 256, B 2,
# fp32 with TF32 off, dropout 0, three steps. Both sides compute in fp32
# and differ in summation order (~1e-6 relative on the loss); Adam's
# normalized step can turn that noise into a sign flip on a near-zero
# gradient element (a full lr step on that element), which moves the
# next loss by far less than 1e-4 of its value.
PARITY_TRAIN = dict(num_layers=2, seq=256, batch=2, steps=3)
PARITY_LOSS_RTOL = 1e-4

# the BERT training config (bench.py's `build_bert_train` on an
# accelerator, bench.py:216-296): BERT-Large shape with head_dim 128,
# bf16 compute, fp32 masters, dropout 0, no attention mask, the mean of
# the per-token losses with labels = roll(tokens, 1);
# MixedPrecisionLamb(1e-4, wd 0.01 except biases and LayerNorms, bf16
# moments, store_model=False), no loss scaler
BERT = dict(vocab_size=30592, hidden_size=1024, num_layers=24,
            num_attention_heads=8, ffn_hidden_size=4096,
            max_position_embeddings=512, tensor_parallel_size=1,
            hidden_dropout=0.0, attention_dropout=0.0)
BERT_BATCH, BERT_SEQ = 8, 512
# BERT train parity, cuda vs cpu: the widths above at 2 layers, S 128,
# B 2, fp32 with TF32 off, three steps, held to PARITY_LOSS_RTOL as the
# GPT step (LAMB's normalized step scales noise as Adam's does)
BERT_PARITY = dict(num_layers=2, seq=128, batch=2, steps=3)
BERT_KERNELS = ("xent_fwd_dg", "xent_fwd", "lamb_leaf_stage1",
                "lamb_leaf_stage2")
# masked BERT: the BERT step with a padding mask (`bert_lengths`) and
# BERT-Large's published pre-training dropout, 0.1 hidden and attention;
# the unpacked flash kernels carry its attention
BERT_MASKED_DROPOUT = 0.1
BERT_MASKED_PARITY_LENGTHS = (128, 77)  # B 2 at S 128: two lengths
UNPACKED_KERNELS = ("flash_unpacked_fwd", "flash_unpacked_bwd",
                    "flash_dbias")
# contrib/fmha at bench.py's fmha configuration (bench.py:2087-2146
# `bench_fmha` on an accelerator): 64 sequences whose lengths
# RandomState(0) draws from FMHA_LENS with FMHA_P (17408 tokens, three of
# 2048, max_s 2048), 8 heads of 64, causal, bf16, qkv = 0.5 * normal; the
# loss sum(fmha(qkv).float() ** 2), forward + backward, packed and padded
FMHA_LENS, FMHA_P = [64, 128, 256, 512, 2048], [0.3, 0.3, 0.2, 0.15, 0.05]
FMHA_BATCH, FMHA_HEADS, FMHA_HD = 64, 8, 64
FMHA_KERNELS = ("flash_segments_fwd", "flash_segments_bwd")
# fp32 cuda vs cpu: a small ragged batch with empty sequences
FMHA_PARITY_LENS = [37, 0, 300, 5, 128, 0]
# contrib/xentropy's loss, forward + backward, at the BERT head's logits
# (B 8 x S 512 rows, vocab 30592) in bf16, smoothing 0.1, padding_idx 0
XENT_SMOOTHING, XENT_PAD = 0.1, 0
XENT_CONTRIB_KERNELS = ("xent_fwd", "xent_bwd")

# kernel vs plain version on the same card inputs, each output by its
# own dtype: |kernel - plain| <= atol + rtol * |plain|. Both compute in
# fp32 and differ in summation order and exp2-vs-exp only (~1e-6
# relative), so fp32 outputs (the LN's mixed output, the lse, all of the
# fp32 cases) are held to atol 1e-4. A bf16 output (the residual stream,
# the attention o) rounds both fp32 results to 8 mantissa bits, where
# that noise may flip the last bit: one bf16 ulp is at most 2^-7 of the
# value, so rtol 2^-7, with atol 1e-5 for the fp32 noise near zero.
TOL = {torch.float32: dict(rtol=0.0, atol=1e-4),
       torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}
# the engine's first-chunk logits, card (cuBLAS fp32, no TF32) vs CPU:
# summation order over K = 1024..4096 through 2 layers, ~1e-5 observed
# scale on logits of order 1; 1e-3 leaves two orders of margin
PARITY_LOGIT_ATOL = 1e-3


# the paged serve: bench.py serve --paged at page size 16 with the
# worst-case pool; --shared-prefix traffic is one 250-token prefix (not
# page-aligned: the tails start inside a shared page) and 4-16 random
# tail tokens per request
PAGE_SIZE = 16
SHARED_PREFIX = 250
PARITY_NEW = 8  # new tokens per request in the parity phase
CARD = "cuda"  # the engine phases' device (a CPU rehearsal renames it)

PHASES = ("kernels", "parity", "serve", "serve_paged", "serve_whole",
          "train_parity", "train", "bert_train_parity", "bert_train",
          "bert_train_masked_parity", "bert_train_masked", "fmha",
          "xentropy")
SERVE_KERNELS = ("layer_norm_fwd", "flash_attention_segments_with_lse",
                 "flash_attention_decode")
# the paged serve's kernels: the contiguous decode read gives way to the
# paged one, float or int8 by the form's pools
PAGED_SERVE_KERNELS = ("layer_norm_fwd", "flash_attention_segments_with_lse")
PAGED_KERNELS = ("flash_attention_decode_paged",
                 "flash_attention_decode_paged_int8")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean time of ``fn`` over ``iters`` back-to-back calls, between two
    CUDA events: the device time, or the host's time to launch a call
    where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_SLEEP_CYCLES_PER_S = []


def device_ms(fn, iters, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, without the
    host's time to launch them: the stream first spins in a sleep kernel
    twice as long as the host takes to launch the calls, so the calls
    queue up behind it and run back to back between the two events.
    (A call that synchronizes with the host defeats this and is timed
    with the host's gaps, as `cuda_ms`.)"""
    if not _SLEEP_CYCLES_PER_S:
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_S.append(1e7 / (start.elapsed_time(end) / 1e3))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    launch_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * launch_s * _SLEEP_CYCLES_PER_S[0]) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, ops, dtype):
    """The least time for the work: bytes over HBM rate or operations
    over the peak rate of the input type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def compare(got, ref, extra=None, tols=None):
    """Kernel outputs against the plain version's, each within `TOL` of
    its dtype, or within ``tols[i]`` (a dict of rtol and atol) where a
    case states its own for output i, plus ``extra[i]``, an added atol
    (a number or a tensor) where given: the worst ratio of error to
    tolerance (<= 1 passes; NaN fails), the max abs error, and the max
    |plain| of the first output (the LN's y, the attention's o or dqkv)."""
    ratio, err = 0.0, 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g is None:
            continue
        tol = (tols[i] if tols is not None and tols[i] is not None
               else TOL[r.dtype])
        diff = (g.float() - r.float()).abs()
        bound = tol["atol"] + tol["rtol"] * r.float().abs()
        if extra is not None and extra[i] is not None:
            bound = bound + extra[i]
        r = float((diff / bound).max())
        # a NaN anywhere fails (max() would keep the earlier ratio)
        ratio = max(ratio, math.inf if math.isnan(r) else r)
        err = max(err, float(diff.max()))
    return dict(ratio=ratio, err=err,
                ref_max=float(ref[0].float().abs().max()))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def ln_cases(dev):
    from rocm_apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device=dev).manual_seed(1)
    for rows in (256, 8):
        for residual in (False, True):
            for dt in (torch.bfloat16, torch.float32):
                h = SERVE["hidden_size"]
                x = torch.randn(rows, h, device=dev, generator=gen).to(dt)
                d = (torch.randn(rows, h, device=dev, generator=gen)
                     .to(dt) if residual else None)
                w = 1.0 + 0.1 * torch.randn(h, device=dev, generator=gen)
                b = 0.1 * torch.randn(h, device=dev, generator=gen)
                out_dt = torch.float32  # the mixed contract: weight dtype

                def kern():
                    return ln._ln_fwd_impl(x, d, w, b, 1e-5, out_dt)

                def plain():
                    return ln.layer_norm_fwd_plain(x, d, w, b, 1e-5, out_dt)

                got, ref = kern(), plain()
                wl, bl = w.to(dt), b.to(dt)
                lib = None if residual else (
                    lambda: F.layer_norm(x, (h,), wl, bl, 1e-5))
                moved = nbytes(x, d, w, b, *got)
                yield dict(
                    kernel="layer_norm_fwd",
                    case=f"{'residual' if residual else 'plain'} "
                         f"({rows}, {h}) {str(dt)[6:]}",
                    dtype=dt, cmp=compare(got, ref), kern=kern,
                    plain=plain, lib=lib, nbytes=moved, ops=8 * rows * h,
                    headline=(rows == 8 and not residual
                              and dt == torch.bfloat16),
                )


def _qkv(t, heads, d, dt, dev, gen):
    """q/k/v as the model slices them: views of one fused projection
    (t, heads, 3*d), interleaved per head."""
    qkv = torch.randn(t, heads, 3 * d, device=dev, generator=gen).to(dt)
    return qkv.split(d, dim=-1)


def chunk_slot_ids(budget, num_slots):
    """A mixed chunk as the scheduler packs it: slot pieces in slot-scan
    order (ids not sorted by arrival), a completing tail, then pads
    carrying the id num_slots."""
    pieces = [(3, 97), (0, 64), (5, 40), (6, 32)]
    ids = np.full((budget,), num_slots, np.int32)
    at = 0
    for slot, n in pieces:
        ids[at:at + n] = slot
        at += n
    return ids, at


def seg_cases(dev):
    from rocm_apex_tpu_torch.ops import flash_attention_segments as fs

    gen = torch.Generator(device=dev).manual_seed(2)
    h, d = SERVE["num_attention_heads"], SERVE["hidden_size"] // 8
    ids_np, _ = chunk_slot_ids(BUDGET, SLOTS)
    seg = torch.from_numpy(ids_np).to(dev)
    mask = (seg[:, None] == seg[None, :]) & torch.ones(
        BUDGET, BUDGET, dtype=torch.bool, device=dev).tril()
    live_pairs = int(mask.sum())
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (x.transpose(0, 1) for x in _qkv(BUDGET, h, d, dt, dev,
                                                   gen))

        def kern():
            return fs.flash_attention_segments_with_lse(
                q, k, v, seg, causal=True)

        def plain():
            return fs.flash_attention_segments_plain(
                q, k, v, seg, True, 1.0 / math.sqrt(d), round_q=False)

        got, ref = kern(), plain()
        qc, kc, vc = (x.contiguous()[None] for x in (q, k, v))

        def lib():
            return F.scaled_dot_product_attention(qc, kc, vc,
                                                  attn_mask=mask)

        yield dict(
            kernel="flash_attention_segments_with_lse",
            case=f"causal ({h}, {BUDGET}, {d}) {str(dt)[6:]}, 4 slots + pads",
            dtype=dt, cmp=compare(got, ref), kern=kern, plain=plain,
            lib=lib, nbytes=nbytes(q, k, v, seg, *got),
            ops=4 * d * h * live_pairs, headline=dt == torch.bfloat16,
        )


def decode_cases(dev):
    from rocm_apex_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    h, d = SERVE["num_attention_heads"], SERVE["hidden_size"] // 8
    # mixed decode bounds min(lengths + 1, capacity): a full slot, an
    # empty one, long and short prefixes
    grid_len = torch.tensor([1024, 0, 17, 513, 300, 64, 1000, 129],
                            dtype=torch.int32, device=dev)
    chunk_len = torch.tensor([700, 0, 0, 256, 0, 0, 32, 0],
                             dtype=torch.int32, device=dev)
    ids_np, _ = chunk_slot_ids(BUDGET, SLOTS)
    slot_ids = torch.from_numpy(ids_np).to(dev)
    # the library yardstick reads the cache as (heads, keys, d) copies,
    # made outside its timing; piece B flattens every slot's keys into
    # one row of slots * capacity keys, each query masked to its own
    # slot's prefix
    key_slot = torch.arange(SLOTS * CAPACITY, device=dev) // CAPACITY
    key_pos = torch.arange(SLOTS * CAPACITY, device=dev) % CAPACITY
    for dt in (torch.bfloat16, torch.float32):
        # 4 caches in turn: 4 x 32 MB (bf16) exceeds the 50 MB L2, so
        # each launch finds its cache cold, as each layer does in a tick
        caches = [
            (torch.randn(SLOTS, CAPACITY, h, d, device=dev,
                         generator=gen).to(dt),
             torch.randn(SLOTS, CAPACITY, h, d, device=dev,
                         generator=gen).to(dt))
            for _ in range(4)
        ]
        for form, rows, lens, ids in (
            ("decode grid", SLOTS, grid_len, None),
            ("chunk piece B", BUDGET, chunk_len, slot_ids),
        ):
            q, _, _ = _qkv(rows, h, d, dt, dev, gen)
            turn = [0]

            def kern(q=q, lens=lens, ids=ids):
                kc, vc = caches[turn[0] % 4]
                turn[0] += 1
                return fa.flash_attention_decode(
                    q, kc, vc, lens, return_lse=True, slot_ids=ids)

            def plain(q=q, lens=lens, ids=ids):
                kc, vc = caches[0]
                return fa.flash_attention_decode_plain(
                    q, kc, vc, lens, 1.0 / math.sqrt(d), ids)

            turn[0] = 0
            got, ref = kern(), plain()
            per_row = (lens.long() if ids is None
                       else torch.where(slot_ids < SLOTS,
                                        lens.long()[slot_ids.clamp(0, SLOTS - 1)],
                                        0))
            keys_read = int(per_row.sum())
            # each live K/V row once, per head (the bound), not per query
            slots_live = (lens if ids is None else
                          lens * torch.isin(torch.arange(SLOTS, device=dev),
                                            slot_ids).int())
            kv_bytes = 2 * int(slots_live.sum()) * h * d * q.element_size()
            if ids is None:  # (slots, heads, capacity, d)
                tcaches = [(kc.transpose(1, 2).contiguous(),
                            vc.transpose(1, 2).contiguous())
                           for kc, vc in caches]
                amask = (torch.arange(CAPACITY, device=dev)[None, :]
                         < lens[:, None])[:, None, None, :]
                qs = q.contiguous()[:, :, None, :]
            else:  # (1, heads, slots * capacity, d)
                tcaches = [tuple(c.permute(2, 0, 1, 3)
                                 .reshape(1, h, SLOTS * CAPACITY, d)
                                 .contiguous() for c in kv)
                           for kv in caches]
                amask = ((ids.long()[:, None] == key_slot[None, :])
                         & (key_pos < lens.long()[key_slot])[None, :]
                         )[None, None]
                qs = q.transpose(0, 1).contiguous()[None]
            lturn = [0]

            def lib(qs=qs, amask=amask, tcaches=tcaches, lturn=lturn):
                kt, vt = tcaches[lturn[0] % 4]
                lturn[0] += 1
                return F.scaled_dot_product_attention(
                    qs, kt, vt, attn_mask=amask)

            yield dict(
                kernel="flash_attention_decode",
                case=f"{form}: {rows} rows x {h} heads vs ({SLOTS}, "
                     f"{CAPACITY}, {h}, {d}) {str(dt)[6:]}",
                dtype=dt, cmp=compare(got, ref), kern=kern, plain=plain,
                lib=lib, nbytes=(nbytes(q, lens, ids, *got) + kv_bytes),
                ops=4 * d * h * keys_read,
                headline=ids is None and dt == torch.bfloat16,
            )


def _paged_table(lens, ps, num_pages, gen, dev, mapped=None):
    """A page table mapping each slot's live pages (``mapped[s]`` pages
    where given, else ceil(lens[s] / ps)) onto a random permutation of
    the pool; the rest hold the sentinel num_pages."""
    pps = CAPACITY // ps
    perm = torch.randperm(num_pages, generator=gen, device="cpu")
    table = torch.full((SLOTS, pps), num_pages, dtype=torch.int32)
    at = 0
    for s, n in enumerate(lens):
        n = mapped[s] if mapped and s in mapped else -(-int(n) // ps)
        table[s, :n] = perm[at:at + n].int()
        at += n
    return table.to(dev)


def _paged_rows_read(table, lens, ps, num_pages, slots):
    """Distinct pool rows (page * ps + offset) that reads bounded by
    ``lens`` of ``slots`` touch, unmapped entries clamped as the kernel
    clamps them; and the distinct pages."""
    tab = table.cpu().long()
    keys = []
    for s in sorted(set(slots)):
        t = torch.arange(int(lens[s]))
        page = tab[s, t // ps].clamp(max=num_pages - 1)
        keys.append(page * ps + t % ps)
    keys = torch.unique(torch.cat(keys)) if keys else torch.zeros(0)
    return keys.numel(), torch.unique(keys // ps).numel()


def paged_decode_cases(dev):
    """The paged decode read (float pools, and int8 pools with fp32
    scales) at the serve's shapes: the decode grid (8 slots x 8 heads x
    d 128, prefixes up to 1024: ragged, ending mid-page, and slot 1 a
    dead row at capacity whose table maps 3 pages, so its bound reaches
    sentinel entries) and piece B (the 256-row chunk, each row against
    its own slot's pre-chunk prefix, pads reading nothing), at page sizes
    16 and 64. The library yardstick is one masked SDPA over a contiguous
    view gathered beforehand (the gather is not timed)."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa
    from rocm_apex_tpu_torch.ops.paging import paged_view

    gen = torch.Generator(device=dev).manual_seed(6)
    cpu_gen = torch.Generator().manual_seed(6)
    h, d = SERVE["num_attention_heads"], SERVE["hidden_size"] // 8
    grid_len = [CAPACITY, CAPACITY, 17, 513, 300, 64, 1000, 129]
    chunk_len = [700, 0, 0, 256, 0, 0, 32, 0]
    ids_np, _ = chunk_slot_ids(BUDGET, SLOTS)
    slot_ids = torch.from_numpy(ids_np).to(dev)
    key_slot = torch.arange(SLOTS * CAPACITY, device=dev) // CAPACITY
    key_pos = torch.arange(SLOTS * CAPACITY, device=dev) % CAPACITY
    cases = [
        ("decode grid", 16, torch.bfloat16, False),
        ("decode grid", 16, torch.float32, False),
        ("decode grid", 16, torch.bfloat16, True),
        ("decode grid", 16, torch.float32, True),
        ("decode grid", 64, torch.bfloat16, False),
        ("decode grid", 64, torch.bfloat16, True),
        ("chunk piece B", 16, torch.bfloat16, False),
        ("chunk piece B", 16, torch.bfloat16, True),
        ("chunk piece B", 64, torch.bfloat16, False),
    ]
    for form, ps, dt, int8 in cases:
        num_pages = SLOTS * (CAPACITY // ps)  # the worst-case pool
        grid = form == "decode grid"
        lens_list = grid_len if grid else chunk_len
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        table = _paged_table(lens_list, ps, num_pages, cpu_gen, dev,
                             mapped={1: 3} if grid else None)
        shape = (num_pages, h, ps, d)
        # 4 pool sets in turn, more than the 50 MB L2 together
        pools = []
        for _ in range(4):
            if int8:
                kv = [torch.randint(-127, 128, shape, generator=gen,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2)]
                sc = [0.005 + 0.02 * torch.rand((num_pages, h), generator=gen,
                                                device=dev)
                      for _ in range(2)]
            else:
                kv = [torch.randn(shape, generator=gen, device=dev).to(dt)
                      for _ in range(2)]
                sc = [None, None]
            pools.append((*kv, *sc))
        rows = SLOTS if grid else BUDGET
        ids = None if grid else slot_ids
        q, _, _ = _qkv(rows, h, d, dt, dev, gen)
        turn = [0]

        def kern(q=q, lens=lens, ids=ids, table=table, pools=pools,
                 turn=turn):
            k, v, ks, vs = pools[turn[0] % 4]
            turn[0] += 1
            return fa.flash_attention_decode_paged(
                q, k, v, table, lens, None, ks, vs, return_lse=True,
                slot_ids=ids)

        def plain(q=q, lens=lens, ids=ids, table=table, pools=pools):
            k, v, ks, vs = pools[0]
            return fa.flash_attention_decode_paged_plain(
                q, k, v, table, lens, 1.0 / math.sqrt(d), ks, vs, ids)

        got, ref = kern(), plain()
        turn[0] = 0
        read_slots = (range(SLOTS) if grid else
                      [s for s in ids_np.tolist() if s < SLOTS])
        n_rows, n_pages = _paged_rows_read(table, lens_list, ps, num_pages,
                                           read_slots)
        elem = 1 if int8 else q.element_size()
        kv_bytes = 2 * n_rows * h * d * elem + (
            2 * n_pages * h * 4 if int8 else 0)
        per_row = (lens.long() if grid else torch.where(
            slot_ids < SLOTS, lens.long()[slot_ids.clamp(0, SLOTS - 1)], 0))
        # the gathered contiguous views, in q's dtype (int8 dequantized)
        views = [tuple(paged_view(p, table, s, out_dtype=dt)
                       for p, s in ((k, ks), (v, vs)))
                 for k, v, ks, vs in pools]
        if grid:  # (slots, heads, capacity, d)
            tviews = [tuple(x.transpose(1, 2).contiguous() for x in kv)
                      for kv in views]
            amask = (torch.arange(CAPACITY, device=dev)[None, :]
                     < lens[:, None])[:, None, None, :]
            qs = q.contiguous()[:, :, None, :]
        else:  # (1, heads, slots * capacity, d)
            tviews = [tuple(x.permute(2, 0, 1, 3)
                            .reshape(1, h, SLOTS * CAPACITY, d).contiguous()
                            for x in kv) for kv in views]
            amask = ((slot_ids.long()[:, None] == key_slot[None, :])
                     & (key_pos < lens.long()[key_slot])[None, :]
                     )[None, None]
            qs = q.transpose(0, 1).contiguous()[None]
        del views
        lturn = [0]

        def lib(qs=qs, amask=amask, tviews=tviews, lturn=lturn):
            kt, vt = tviews[lturn[0] % 4]
            lturn[0] += 1
            return F.scaled_dot_product_attention(qs, kt, vt,
                                                  attn_mask=amask)

        name = ("flash_attention_decode_paged_int8" if int8
                else "flash_attention_decode_paged")
        yield dict(
            kernel=name,
            case=f"{form}: {rows} rows x {h} heads, page {ps}, "
                 f"{'int8' if int8 else str(dt)[6:]} pool "
                 f"({num_pages}, {h}, {ps}, {d}), q {str(dt)[6:]}",
            dtype=dt, cmp=compare(got, ref), kern=kern, plain=plain,
            lib=lib, nbytes=(nbytes(q, lens, ids, table, *got) + kv_bytes),
            ops=4 * d * h * int(per_row.sum()),
            headline=grid and ps == 16 and dt == torch.bfloat16,
        )


def _l1_tol(abs_terms_sum):
    """Extra atol for an output that is an fp32 sum over many rows (a
    bias or LayerNorm-parameter gradient): kernel and plain version add
    the rows in different orders, which moves the sum by up to about
    sqrt(n) * 2^-24 of the L1 mass of its terms (8e-6 at n = 16384 rows
    of the training step); 1e-5 of the L1 mass allows that."""
    return 1e-5 * abs_terms_sum


def train_ln_cases(dev):
    """The LayerNorms of the training step on its (16384, 1024) rows:
    the residual forward with dropout (16 of the step's 17 forwards),
    and the backward with the stream cotangent and the regenerated
    dropout mask (16 of 17) and in the plain affine form (layer 0's
    ln1)."""
    from rocm_apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device=dev).manual_seed(5)
    rows, h = TRAIN_BATCH * TRAIN_SEQ, TRAIN["hidden_size"]
    rate, seed = TRAIN["hidden_dropout"], 2024
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(rows, h, device=dev, generator=gen).to(dt)
        d = torch.randn(rows, h, device=dev, generator=gen).to(dt)
        # the training state holds LN parameters in the compute dtype
        w = (1.0 + 0.1 * torch.randn(h, device=dev, generator=gen)).to(dt)
        b = (0.1 * torch.randn(h, device=dev, generator=gen)).to(dt)

        def fkern(x=x, d=d, w=w, b=b, dt=dt):
            return ln._ln_fwd_impl(x, d, w, b, 1e-5, dt, rate, seed)

        def fplain(x=x, d=d, w=w, b=b, dt=dt):
            return ln.layer_norm_fwd_plain(x, d, w, b, 1e-5, dt, rate, seed)

        got = fkern()
        yield dict(
            kernel="layer_norm_fwd_dropout",
            case=f"residual+dropout {rate} ({rows}, {h}) {str(dt)[6:]}",
            dtype=dt, cmp=compare(got, fplain()), kern=fkern, plain=fplain,
            lib=None, nbytes=nbytes(x, d, w, b, *got), ops=10 * rows * h,
            headline=dt == torch.bfloat16, iters=50,
        )
        _, s_, mu, rs = got
        dy = torch.randn(rows, h, device=dev, generator=gen).to(dt)
        ds = torch.randn(rows, h, device=dev, generator=gen).to(dt)
        xh = (s_.float() - mu[:, None]) * rs[:, None]
        forms = [("residual+dropout", ds, rate)]
        if dt == torch.bfloat16:
            forms.append(("plain affine", None, 0.0))
        for form, ds_, r in forms:
            def bkern(s_=s_, dy=dy, ds_=ds_, mu=mu, rs=rs, w=w, r=r):
                return ln._layer_norm_bwd(s_, dy, ds_, mu, rs, w, r, seed)

            def bplain(s_=s_, dy=dy, ds_=ds_, mu=mu, rs=rs, w=w, r=r):
                return ln.layer_norm_bwd_plain(s_, dy, ds_, mu, rs, w, r,
                                               seed)

            xg = s_.detach().clone().requires_grad_(True)
            wg = w.detach().clone().requires_grad_(True)
            bg = b.detach().clone().requires_grad_(True)

            def lib(xg=xg, wg=wg, bg=bg, dy=dy):
                xg.grad = wg.grad = bg.grad = None
                F.layer_norm(xg, (h,), wg, bg, 1e-5).backward(dy)

            got = bkern()
            extra = [None, None, _l1_tol((dy.float() * xh).abs().sum(0)),
                     _l1_tol(dy.float().abs().sum(0))]
            yield dict(
                kernel="layer_norm_bwd",
                case=f"{form} ({rows}, {h}) {str(dt)[6:]}",
                dtype=dt, cmp=compare(got, bplain(), extra), kern=bkern,
                plain=bplain, lib=lib,
                nbytes=nbytes(s_, dy, ds_, mu, rs, w, *got),
                ops=14 * rows * h,
                headline=form != "plain affine" and dt == torch.bfloat16,
                iters=50,
            )


def flash_cases(dev):
    """The packed-QKV attention of the training step, forward and
    backward: (B 16, S 1024, 8 heads, 3 x 128) bf16 with the projection
    bias and dropout 0.1 (the step's form), without bias or dropout, an
    S that is not a multiple of the 64-row tile (causal and not), and an
    fp32 case. The library yardstick is SDPA on the biased q/k/v in (B,
    nh, S, hd), forward, and forward + backward through autograd."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(4)
    nh = TRAIN["num_attention_heads"]
    hd = TRAIN["hidden_size"] // nh
    scale, seed = 1.0 / math.sqrt(hd), 77
    for B, S, dt, with_bias, rate, causal in (
        (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16, True, 0.1, True),
        (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16, False, 0.0, True),
        (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16, True, 0.0, True),
        (4, 1000, torch.bfloat16, True, 0.1, True),
        (4, 1000, torch.bfloat16, True, 0.1, False),
        (4, TRAIN_SEQ, torch.float32, True, 0.1, True),
    ):
        qkv = torch.randn(B, S, nh, 3 * hd, device=dev, generator=gen).to(dt)
        bias = ((0.1 * torch.randn(nh * 3 * hd, device=dev, generator=gen))
                .to(dt) if with_bias else None)
        do = torch.randn(B, S, nh * hd, device=dev, generator=gen).to(dt)
        name = (f"{'bias' if with_bias else 'no bias'}, dropout {rate}, "
                f"{'causal' if causal else 'not causal'}, "
                f"({B}, {S}, {nh}, {3 * hd}) {str(dt)[6:]}")
        headline = with_bias and rate > 0.0 and S == TRAIN_SEQ and (
            dt == torch.bfloat16)
        # the (query, key) pairs attended
        pairs = B * nh * (S * (S + 1) // 2 if causal else S * S)

        def fkern(qkv=qkv, bias=bias, rate=rate, causal=causal):
            return fa._flash_fwd(qkv, bias, causal, scale, rate, seed)

        def fplain(qkv=qkv, bias=bias, rate=rate, causal=causal):
            return fa.flash_qkv_fwd_plain(qkv, bias, causal, scale, rate,
                                          seed)

        x = qkv if bias is None else qkv + bias.view(nh, 3 * hd)
        q, k, v = (t.contiguous() for t in
                   x.permute(0, 2, 1, 3).split(hd, dim=-1))

        def flib(q=q, k=k, v=v, rate=rate, causal=causal):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  dropout_p=rate)

        o, lse = fkern()
        yield dict(
            kernel="flash_attention_qkv_fwd", case=name, dtype=dt,
            cmp=compare((o, lse), fplain()), kern=fkern, plain=fplain,
            lib=flib, nbytes=nbytes(qkv, bias, o, lse), ops=4 * hd * pairs,
            headline=headline, iters=10, plain_iters=2,
        )

        def bkern(qkv=qkv, bias=bias, o=o, lse=lse, do=do, rate=rate,
                  causal=causal):
            return fa._flash_bwd(qkv, bias, o, lse, do, causal, scale, rate,
                                 seed)

        def bplain(qkv=qkv, bias=bias, o=o, lse=lse, do=do, rate=rate,
                   causal=causal):
            return fa.flash_qkv_bwd_plain(qkv, bias, o, lse, do, causal,
                                          scale, rate, seed)

        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        do_h = do.view(B, S, nh, hd).permute(0, 2, 1, 3).contiguous()

        def blib(qg=qg, kg=kg, vg=vg, do_h=do_h, rate=rate, causal=causal):
            qg.grad = kg.grad = vg.grad = None
            F.scaled_dot_product_attention(
                qg, kg, vg, is_causal=causal, dropout_p=rate).backward(do_h)

        got = bkern()
        ref = bplain()
        extra = [None, None if bias is None else _l1_tol(
            ref[0].float().abs().sum(dim=(0, 1)).reshape(-1))]
        yield dict(
            kernel="flash_attention_qkv_bwd", case=name, dtype=dt,
            cmp=compare(got, ref, extra), kern=bkern, plain=bplain, lib=blib,
            nbytes=nbytes(qkv, bias, o, lse, do, *got), ops=10 * hd * pairs,
            headline=headline, iters=5, plain_iters=2,
        )


# dg = softmax - target of the cross-entropy kernel against its plain
# version: both form exp(x - max) / sum in fp32 and differ by the fast
# exponential and the order of the row's sum, a few 1e-6 of the softmax
# term. An fp32 dg is held to 2e-5 of its value; where the softmax term
# meets eps / V the difference cancels to nothing, and atol 1e-9 (far
# under eps / V = 3e-6, which a kernel without the smoothing term would
# be off by) allows the fp32 noise left there. A bf16 dg rounds both to 8
# mantissa bits: one ulp, at most 2^-7 of the value, and the same atol.
XENT_DG_TOL = {torch.float32: dict(rtol=2e-5, atol=1e-9),
               torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-9)}
# the sum of |dg| over a case, divided by its rows (about 2): last-bit
# flips of single elements move it by a few 1e-6 of itself, a wrong
# factor by its error
XENT_DG_L1_RTOL = 1e-4


def xent_cases(dev):
    """The cross-entropy kernel's two forms at the BERT head's shape,
    (B 8 x S 512, vocab 30592) bf16 logits, with smoothing 0 (the bench)
    and 0.1; an fp32 case; a vocab that is no multiple of 8 (the scalar
    form); every case with labels at column 0 and V - 1.

    Most of dg is far below the shared `TOL`: off the label column it is
    softmax - eps / V, about 3e-5 in the mean at this vocab, with the
    smoothing term at 3e-6. So dg has tolerances of its own, `XENT_DG_TOL`,
    and beside dg the sum of |dg| over the case is held to
    `XENT_DG_L1_RTOL`: one bf16 ulp an element would still pass a factor
    that is off by half a percent, the sum does not.

    The library yardstick is `F.cross_entropy`, forward + backward for
    the differentiated form and forward for the plain one: `library_ms`
    on the same logits, `library_fp32_ms` on an fp32 copy of bf16 logits
    (twice the bytes to read, and an fp32 gradient to write)."""
    from rocm_apex_tpu_torch.ops import xentropy as xe

    gen = torch.Generator(device=dev).manual_seed(8)
    rows_full, vocab = BERT_BATCH * BERT_SEQ, BERT["vocab_size"]
    for rows, v, dt, eps in (
        (rows_full, vocab, torch.bfloat16, 0.0),
        (rows_full, vocab, torch.bfloat16, 0.1),
        (1024, vocab, torch.float32, 0.1),
        (512, 30001, torch.bfloat16, 0.1),
    ):
        x = (2.0 * torch.randn(rows, v, device=dev, generator=gen)).to(dt)
        labels = torch.randint(0, v, (rows,), device=dev, generator=gen)
        labels[0], labels[1] = 0, v - 1
        xg = x.detach().clone().requires_grad_(True)
        x32 = (None if dt == torch.float32 else
               x.detach().to(torch.float32).requires_grad_(True))
        w = torch.full((rows,), 1.0 / rows, device=dev)
        for form in ("xent_fwd_dg", "xent_fwd"):
            fn, ref = ((xe.xent_fwd_dg, xe.xent_fwd_dg_reference)
                       if form == "xent_fwd_dg"
                       else (xe.xent_fwd, xe.xent_fwd_reference))

            def kern(fn=fn, x=x, labels=labels, eps=eps):
                return fn(x, labels, eps)

            def plain(ref=ref, x=x, labels=labels, eps=eps):
                return ref(x, labels, eps)

            if form == "xent_fwd_dg":
                def lib(xl=xg, labels=labels, eps=eps, w=w):
                    xl.grad = None
                    F.cross_entropy(xl, labels, reduction="none",
                                    label_smoothing=eps).backward(
                                        w.to(xl.dtype))
            else:
                def lib(xl=xg, labels=labels, eps=eps):
                    with torch.no_grad():
                        return F.cross_entropy(xl, labels, reduction="none",
                                               label_smoothing=eps)

            def lib32(lib=lib, x32=x32):
                return lib(xl=x32)

            got, ref = kern(), plain()
            tols = None
            if form == "xent_fwd_dg":
                got = (*got, got[1].double().abs().sum() / rows)
                ref = (*ref, ref[1].double().abs().sum() / rows)
                tols = [None, XENT_DG_TOL[dt],
                        dict(rtol=XENT_DG_L1_RTOL, atol=0.0)]
            yield dict(
                kernel=form,
                case=f"({rows}, {v}) {str(dt)[6:]}, smoothing {eps}",
                dtype=dt, cmp=compare(got, ref, tols=tols), kern=kern,
                plain=plain, lib=lib, lib32=None if x32 is None else lib32,
                nbytes=nbytes(x, labels, *got[:2]), ops=8 * rows * v,
                headline=(rows == rows_full and dt == torch.bfloat16
                          and eps == 0.0),
                iters=20, plain_iters=3,
            )


# the LAMB cases' hyperparameters: [b1, b2, b3, eps, bc1, bc2, gs * clip],
# then live; bc1/bc2 are those of step 3
_LAMB_SCALARS = [0.9, 0.999, 0.1, 1e-6, 1 - 0.9 ** 3, 1 - 0.999 ** 3, 0.7]
# lr times the trust ratio of leaf 0 of a case; leaf i has (1 + i / 128)
# times that. Of order 1, far above a training step's, so that the
# applied step is as large as the master it is applied to: the decay term
# of u, a leaf that reads another's ratio and a compute copy that missed
# the step all show far above the tolerances
_LAMB_LR_RATIO = 0.7
# Kernel and plain version do the same fp32 arithmetic but for fused
# multiply-adds: a result differs by a few 2^-24 of its largest term.
# fp32 moments are held to 1e-5 of the value plus 2e-6 (terms up to 5 may
# cancel); bf16 moments to one ulp (2^-7 of the value) plus the same.
LAMB_MOMENT_TOL = {torch.float32: dict(rtol=1e-5, atol=2e-6),
                   torch.bfloat16: dict(rtol=2.0 ** -7, atol=2e-6)}
# the new master and its compute copy: `LAMB_STEP_RTOL` of |old master| +
# |applied step| as atol (the two may cancel), and for a bf16 copy one
# ulp of the value besides
LAMB_STEP_RTOL = 1e-5
LAMB_COPY_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def _lamb_leaves(shapes, gdt, mdt, dev, gen):
    """The buffers of a list of leaves at magnitudes of order 1 (so the
    tolerances bite, the decay term wd * p among them): masters,
    gradients, moments (v positive)."""
    ps = [torch.randn(s, device=dev, generator=gen) for s in shapes]
    gs = [torch.randn(s, device=dev, generator=gen).to(gdt) for s in shapes]
    ms = [torch.randn(s, device=dev, generator=gen).to(mdt) for s in shapes]
    vs = [torch.randn(s, device=dev, generator=gen).abs().to(mdt)
          for s in shapes]
    return ps, gs, ms, vs


def _clones(ts):
    return None if ts is None else [t.clone() for t in ts]


def _foreach_lamb_u(ps, mf, vf, wd):
    _, _, _, eps, bc1, bc2, _ = _LAMB_SCALARS
    den = torch._foreach_div(vf, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(mf, bc1)
    torch._foreach_div_(u, den)
    if wd != 0.0:
        torch._foreach_add_(u, ps, alpha=wd)
    return u


def _foreach_lamb_stage1(ps, gs, ms, vs, wd):
    """The `torch._foreach_*` composition of stage 1 over the leaves (the
    library yardstick; it updates the moments in place)."""
    b1, b2, b3, _, _, _, gscale = _LAMB_SCALARS
    gf = torch._foreach_mul([g.float() for g in gs], gscale)
    mf, vf = [m.float() for m in ms], [v.float() for v in vs]
    torch._foreach_mul_(mf, b1)
    torch._foreach_add_(mf, gf, alpha=b3)
    torch._foreach_mul_(vf, b2)
    torch._foreach_addcmul_(vf, gf, gf, value=1.0 - b2)
    u = _foreach_lamb_u(ps, mf, vf, wd)
    out = list(torch._foreach_norm(ps)) + list(torch._foreach_norm(u))
    if ms[0].dtype != torch.float32:
        torch._foreach_copy_(list(ms) + list(vs), mf + vf)
    return out


def _foreach_lamb_stage2(ps, ms, vs, wd, cs):
    """The same of stage 2, with one ratio for every leaf."""
    u = _foreach_lamb_u(ps, [m.float() for m in ms],
                        [v.float() for v in vs], wd)
    torch._foreach_add_(ps, u, alpha=-_LAMB_LR_RATIO)
    if cs is not None:
        torch._foreach_copy_(cs, ps)


def lamb_frozen_check(dev):
    """``live = 0`` with an inf in the gradient: both stages must leave
    m, v and the master bit-equal (a select, not a blend), in fp32 and
    bf16 moments."""
    from rocm_apex_tpu_torch.ops import optim_kernels as ok

    gen = torch.Generator(device=dev).manual_seed(10)
    dead1 = torch.tensor(_LAMB_SCALARS + [0.0], device=dev)
    dead2 = torch.tensor([1e-6, 0.271, 0.003, 0.0], device=dev)
    lr_ratio = torch.tensor([float("nan")], device=dev)
    for mdt in (torch.float32, torch.bfloat16):
        (p,), (g,), (m,), (v,) = _lamb_leaves([(1024, 4096)], torch.bfloat16,
                                              mdt, dev, gen)
        g[3, 5] = float("inf")
        keep = [t.clone() for t in (p, m, v)]
        c = torch.empty_like(p, dtype=torch.bfloat16)
        ok.lamb_leaf_stage1(p, g, m, v, dead1, 0.01, True)
        ok.lamb_leaf_stage2(p, m, v, dead2, lr_ratio, 0.01, True,
                            model_out=c)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip((p, m, v), keep))
        log(f"  lamb stages, live = 0 with an inf gradient, "
            f"{str(mdt)[6:]} moments: master, m, v "
            f"{'bit-equal' if same else 'CHANGED'}")
        check(same, "live = 0 changed a buffer")
        check(torch.equal(c, p.to(torch.bfloat16)),
              "live = 0: the compute copy is not the kept master")


def bert_kernel_leaves():
    """The shapes of the bench BERT's 100 leaves on the LAMB kernel pair,
    in parameter order."""
    h, f = BERT["hidden_size"], BERT["ffn_hidden_size"]
    shapes = [(BERT["vocab_size"], h), (BERT["max_position_embeddings"], h)]
    for _ in range(BERT["num_layers"]):
        shapes += [(h, 3 * h), (h, h), (h, f), (f, h)]
    return shapes + [(h, h), (h, h)]  # lm_head.dense, pooler


def lamb_cases(dev):
    """The LAMB stage pair: first as the BERT step calls it, ALL 100
    kernel leaves of the bench BERT (333M parameters) in one call a
    stage, bf16 gradients and moments, weight decay 0.01, AdamW, no
    compute copy; then on single leaves, (1024, 4096) and the (30592,
    1024) word embeddings, in fp32 and bf16 moments, weight decay 0 and
    0.01, AdamW and L2 mode, a fp32 gradient, stage 2 with and without
    the compute copy; and 40 leaves of mixed sizes, one of a size no
    vector width divides (two launches, the scalar form). Kernel and
    plain version start from equal copies; the moments are held to
    `LAMB_MOMENT_TOL`, the sums to 1e-5 of their mass, the new masters
    and compute copies to `LAMB_STEP_RTOL` of the step applied. In a
    case of several leaves every other leaf has half the weight decay and
    each leaf its own ratio. The library yardstick is the
    `torch._foreach_*` composition of the same stage over the leaves
    (with one decay and one ratio for all)."""
    from rocm_apex_tpu_torch.ops import optim_kernels as ok

    lamb_frozen_check(dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    s1 = torch.tensor(_LAMB_SCALARS + [1.0], device=dev)
    s2 = s1[[3, 4, 5, 7]].contiguous()
    bf, f32 = torch.bfloat16, torch.float32
    mixed = [(1024, 1024), (1001, 1023)] + [(256, 512), (512, 384)] * 19
    for what, shapes, gdt, mdt, wd, adam_w, copy in (
        ("the bench BERT's 100 leaves", bert_kernel_leaves(), bf, bf, 0.01,
         True, False),
        ("(1024, 4096)", [(1024, 4096)], bf, bf, 0.01, True, False),
        ("(1024, 4096)", [(1024, 4096)], bf, f32, 0.01, True, True),
        ("(1024, 4096)", [(1024, 4096)], bf, bf, 0.0, True, True),
        ("(1024, 4096)", [(1024, 4096)], bf, bf, 0.01, False, False),
        ("(1024, 4096)", [(1024, 4096)], f32, f32, 0.01, False, True),
        ("(30592, 1024)", [(30592, 1024)], bf, bf, 0.01, True, False),
        ("(30592, 1024)", [(30592, 1024)], bf, f32, 0.01, True, True),
        ("40 mixed leaves", mixed, bf, bf, 0.01, True, True),
    ):
        ps, gs, ms, vs = _lamb_leaves(shapes, gdt, mdt, dev, gen)
        n, total = len(shapes), sum(p.numel() for p in ps)
        wds = [wd if i % 2 == 0 else 0.5 * wd for i in range(n)]
        lr_ratios = _LAMB_LR_RATIO * (
            1.0 + torch.arange(n, device=dev) / 128.0)
        name = (f"{what} grad {str(gdt)[6:]}, moments {str(mdt)[6:]}, "
                f"wd {wd}, {'AdamW' if adam_w else 'L2'}")
        headline = n == 100

        # stage 1: equal copies through kernel and plain version
        km, kv, rm, rv = (_clones(t) for t in (ms, vs, ms, vs))
        rsum = torch.empty((n, 2), device=dev)
        ksum = ok.lamb_stage1(ps, gs, km, kv, s1, wds, adam_w)
        for i in range(n):
            ok.lamb_leaf_stage1_reference(ps[i], gs[i], rm[i], rv[i], s1,
                                          wds[i], adam_w, rsum[i])
        extra = [None] * (2 * n) + [_l1_tol(rsum)]
        tols = [LAMB_MOMENT_TOL[mdt]] * (2 * n) + [dict(rtol=0.0, atol=0.0)]
        # timing runs update their own buffers in place, step after step:
        # small cases in 4 sets in turn, together above the 50 MB L2, so
        # each launch finds its buffers cold, as each leaf is in a step
        n_sets = 4 if total < (1 << 24) else 1

        def sets(*lists):
            return itertools.cycle([tuple(_clones(t) for t in lists)
                                    for _ in range(n_sets)])

        tsum = torch.empty((n, 2), device=dev)
        k1, p1, l1 = (sets(ps, gs, ms, vs) for _ in range(3))

        def kern1(k1=k1, wds=wds, adam_w=adam_w):
            return ok.lamb_stage1(*next(k1), s1, wds, adam_w, out=tsum)

        def plain1(p1=p1, wds=wds, adam_w=adam_w):
            for i, leaf in enumerate(zip(*next(p1))):
                ok.lamb_leaf_stage1_reference(*leaf, s1, wds[i], adam_w,
                                              tsum[i])

        def lib1(l1=l1, wd=wd, adam_w=adam_w):
            return _foreach_lamb_stage1(*next(l1), wd if adam_w else 0.0)

        yield dict(
            kernel="lamb_leaf_stage1", case=name, dtype=gdt,
            cmp=compare((*km, *kv, ksum), (*rm, *rv, rsum), extra, tols),
            kern=kern1, plain=plain1, lib=lib1,
            nbytes=nbytes(*ps, *gs, *ms, *vs, *ms, *vs, s1, ksum),
            ops=16 * total, headline=headline,
            iters=5 if headline else 20, plain_iters=1 if headline else 3,
        )
        del k1, p1, l1, kern1, plain1, lib1

        # stage 2 from the kernel's stored moments
        kp, rp = _clones(ps), _clones(ps)
        kc = [torch.empty_like(p, dtype=gdt) for p in ps] if copy else None
        rc = _clones(kc)
        ok.lamb_stage2(kp, km, kv, s2, lr_ratios, wds, adam_w, model_outs=kc)
        for i in range(n):
            ok.lamb_leaf_stage2_reference(
                rp[i], km[i], kv[i], s2, lr_ratios[i], wds[i], adam_w,
                None if rc is None else rc[i])
        step = [LAMB_STEP_RTOL * (p.abs() + (r - p).abs())
                for p, r in zip(ps, rp)]
        extra = step + (step if copy else [])
        tols = [dict(rtol=0.0, atol=0.0)] * n + (
            [dict(rtol=LAMB_COPY_RTOL[gdt], atol=0.0)] * n if copy else [])
        k2, p2, l2 = (sets(ps, km, kv, kc) for _ in range(3))

        def kern2(k2=k2, wds=wds, adam_w=adam_w):
            tp, tm, tv, tc = next(k2)
            ok.lamb_stage2(tp, tm, tv, s2, lr_ratios, wds, adam_w,
                           model_outs=tc)

        def plain2(p2=p2, wds=wds, adam_w=adam_w):
            tp, tm, tv, tc = next(p2)
            for i in range(len(tp)):
                ok.lamb_leaf_stage2_reference(
                    tp[i], tm[i], tv[i], s2, lr_ratios[i], wds[i], adam_w,
                    None if tc is None else tc[i])

        def lib2(l2=l2, wd=wd, adam_w=adam_w):
            tp, tm, tv, tc = next(l2)
            _foreach_lamb_stage2(tp, tm, tv, wd if adam_w else 0.0, tc)

        yield dict(
            kernel="lamb_leaf_stage2",
            case=name + (", with the compute copy" if copy else ""),
            dtype=gdt,
            cmp=compare((*kp, *(kc or ())), (*rp, *(rc or ())), extra,
                        tols),
            kern=kern2, plain=plain2, lib=lib2,
            nbytes=nbytes(*ps, *ps, *km, *kv, *(kc or ()), s2, lr_ratios),
            ops=10 * total, headline=headline,
            iters=5 if headline else 20, plain_iters=1 if headline else 3,
        )
        del k2, p2, l2, kern2, plain2, lib2


def bert_lengths(batch):
    """The masked BERT batch's sequence lengths: RandomState(0) draws
    from [S / 4, S] = [128, 512], the first set to S (one unpadded row)."""
    lens = np.random.RandomState(0).randint(BERT_SEQ // 4, BERT_SEQ + 1,
                                            batch)
    lens[0] = BERT_SEQ
    return lens


def padding_mask(lens, seq):
    """(b, seq) int64, 1 where a position is inside its sequence."""
    return torch.from_numpy(
        (np.arange(seq)[None, :] < np.asarray(lens)[:, None]).astype(
            np.int64))


def _live_pairs(bh, sq, sk, bias, causal, lens):
    """The (query, key) pairs a case attends: the work its data needs."""
    live = torch.ones((bh, sq, sk), dtype=torch.bool, device=DEV_CPU)
    if bias is not None:
        nb = bias.shape[0]
        live &= (bias.cpu() > -1e29).repeat_interleave(bh // nb, dim=0)
    col = torch.arange(sk)
    if lens is not None:
        live &= col[None, None, :] < lens.cpu().long()[:, None, None]
    if causal:
        live &= (col[None, :] <= torch.arange(sq)[:, None])[None]
    return int(live.sum())


DEV_CPU = torch.device("cpu")
# an lse or a bias gradient is an fp32 sum over many terms: besides the
# fp32 atol, 1e-5 of the L1 mass of its terms (see `_l1_tol`)
LSE_L1_RTOL = 1e-5


def unpacked_cases(dev):
    """The unpacked flash kernels (forward, backward, dbias) against
    their plain versions, bf16 and fp32, at the paths' shapes: masked
    BERT-Large (B 8 x 8 heads, S 512, hd 128, q/k/v read in place from a
    (B, S, 8, 384) projection, the (8, 512, 512) padding bias from
    `bert_lengths`, so whole query rows are masked; with dropout 0.1 as
    the masked step runs it, and without), the whole-prompt prefill's
    causal window (bh 8, S 768), sq != sk ragged (200 x 333, hd 64, bias
    rows nb = 1 and nb = bh, causal and not), varlen with rows shorter
    than one tile, the dbias kernel (compute_dbias=True) and an lse
    cotangent. The library yardstick is SDPA with the bias as a float
    mask: forward, forward + backward, and for dbias forward + backward
    with a mask that needs its gradient."""
    from rocm_apex_tpu_torch.models.bert import bert_extended_attention_mask
    from rocm_apex_tpu_torch.models.gpt import padding_bias
    from rocm_apex_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(9)
    H = BERT["num_attention_heads"]
    D = BERT["hidden_size"] // H
    B, S = BERT_BATCH, BERT_SEQ
    mask = padding_mask(bert_lengths(B), S).to(dev)
    bert_bias = padding_bias(bert_extended_attention_mask(mask), B, S)
    seed = 31
    cases = [
        # name, (B, H, sq, sk, D), dtype, bias, causal, lens, rate,
        # dbias, dlse, in-place projection views, headline
        ("masked BERT, dropout 0.1", (B, H, S, S, D), torch.bfloat16,
         "bert", False, None, 0.1, False, False, True, True),
        ("masked BERT", (B, H, S, S, D), torch.bfloat16, "bert", False,
         None, 0.0, False, False, True, False),
        ("masked BERT, dropout 0.1", (B, H, S, S, D), torch.float32,
         "bert", False, None, 0.1, False, False, True, False),
        ("masked BERT, dbias", (B, H, S, S, D), torch.bfloat16, "bert",
         False, None, 0.0, True, False, True, False),
        ("whole-prompt causal", (1, 8, 768, 768, 128), torch.bfloat16, None,
         True, None, 0.0, False, False, False, False),
        ("whole-prompt causal", (1, 8, 768, 768, 128), torch.float32, None,
         True, None, 0.0, False, False, False, False),
        ("ragged, bias nb 1, dbias", (2, 4, 200, 333, 64), torch.bfloat16,
         1, False, None, 0.0, True, True, False, False),
        ("ragged causal, bias nb bh, dbias", (2, 4, 200, 333, 64),
         torch.bfloat16, 8, True, None, 0.0, True, True, False, False),
        ("ragged causal, bias nb bh, dbias", (2, 4, 333, 200, 64),
         torch.float32, 8, True, None, 0.1, True, True, False, False),
        ("ragged, bias nb 1, dropout 0.1", (2, 4, 200, 333, 128),
         torch.float32, 1, False, None, 0.1, True, False, False, False),
        ("varlen", (2, 4, 300, 300, 64), torch.bfloat16, None, False,
         "lens", 0.0, False, False, False, False),
        ("varlen causal, lse cotangent", (2, 4, 300, 300, 128),
         torch.float32, None, True, "lens", 0.0, False, True, False, False),
    ]
    for (name, (b, h, sq, sk, d), dt, bias_kind, causal, lens_kind, rate,
         want_db, want_dlse, inplace, headline) in cases:
        bh = b * h
        scale = 1.0 / math.sqrt(d)
        if inplace:
            # the model's views: per-head column blocks of the fused
            # projection, (b, h, s, d) with strides (s*h*3d, 3d, h*3d, 1)
            qkv = torch.randn(b, sq, h, 3 * d, device=dev,
                              generator=gen).to(dt)
            q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.split(d, dim=-1))
        else:
            q = torch.randn(b, h, sq, d, device=dev, generator=gen).to(dt)
            k = torch.randn(b, h, sk, d, device=dev, generator=gen).to(dt)
            v = torch.randn(b, h, sk, d, device=dev, generator=gen).to(dt)
        if bias_kind == "bert":
            bias = bert_bias
        elif bias_kind is None:
            bias = None
        else:
            bias = torch.randn(bias_kind, sq, sk, device=dev, generator=gen)
            bias[0, 3, :] = fa.NEG_INF  # a query row with no live key
            bias[:, :, sk - 5:] = fa.NEG_INF
        if causal and bias is not None:
            # a fully biased row under causal masking is tiling-dependent
            # in the JAX kernel; keep such rows out of the causal cases
            bias[:, :, 0] = 0.0
        lens = None
        if lens_kind == "lens":
            lens = torch.randint(1, sk + 1, (bh,), device=dev, generator=gen,
                                 dtype=torch.int32)
            lens[0], lens[1] = 17, sk  # shorter than one tile; full
        do = torch.randn(b, sq, h, d, device=dev,
                         generator=gen).to(dt).permute(0, 2, 1, 3)
        dlse = (torch.randn(bh, sq, device=dev, generator=gen)
                if want_dlse else None)
        label = (f"{name}, ({b}x{h}, {sq}, {sk}, {d}) {str(dt)[6:]}")
        pairs = _live_pairs(bh, sq, sk, bias, causal, lens)
        flat = fa._flat

        def fkern(q=q, k=k, v=v, bias=bias, causal=causal, lens=lens,
                  rate=rate, scale=scale):
            return fa._unpacked_fwd(q, k, v, bias, causal, scale, lens, rate,
                                    seed, bshd=True)

        def fplain(q=q, k=k, v=v, bias=bias, causal=causal, lens=lens,
                   rate=rate, scale=scale):
            o, lse = fa.flash_unpacked_fwd_plain(
                flat(q), flat(k), flat(v), bias, causal, scale, lens, rate,
                seed)
            return o.view(q.shape), lse

        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        amask = None if bias is None else (
            bias.repeat_interleave(bh // bias.shape[0], dim=0).view(
                b, h, sq, sk).to(dt))
        if lens is not None:
            live = (torch.arange(sk, device=dev)[None, :]
                    < lens.long()[:, None]).view(b, h, 1, sk)
            amask = torch.where(live, 0.0, fa.NEG_INF).to(dt)

        def flib(qc=qc, kc=kc, vc=vc, amask=amask, causal=causal, rate=rate):
            return F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=amask,
                is_causal=causal and amask is None, dropout_p=rate)

        if causal and amask is not None:
            flib = None  # SDPA takes a causal flag or a mask, not both
        o, lse = fkern()
        ref = fplain()
        extra = [None, LSE_L1_RTOL * ref[1].abs()]
        yield dict(
            kernel="flash_unpacked_fwd", case=label, dtype=dt,
            cmp=compare((o, lse), ref, extra), kern=fkern, plain=fplain,
            lib=flib, nbytes=nbytes(q, k, v, bias, lens, o, lse),
            ops=4 * d * pairs, headline=headline, iters=10, plain_iters=2,
        )

        def bkern(q=q, k=k, v=v, bias=bias, o=o, lse=lse, do=do, dlse=dlse,
                  causal=causal, lens=lens, rate=rate, scale=scale):
            return fa._unpacked_bwd(q, k, v, bias, o, lse, do, dlse, causal,
                                    scale, lens, rate, seed, False,
                                    bshd=True)[:3]

        def bplain(q=q, k=k, v=v, bias=bias, o=o, lse=lse, do=do, dlse=dlse,
                   causal=causal, lens=lens, rate=rate, scale=scale):
            got = fa.flash_unpacked_bwd_plain(
                flat(q), flat(k), flat(v), bias, flat(o), lse, flat(do),
                causal, scale, lens, rate, seed, dlse)
            return tuple(g.view(t.shape) for g, t in zip(got, (q, k, v)))

        gq, gk, gv = (t.detach().clone().requires_grad_(True)
                      for t in (qc, kc, vc))
        doc = do.contiguous()

        def blib(gq=gq, gk=gk, gv=gv, doc=doc, amask=amask, causal=causal,
                 rate=rate):
            gq.grad = gk.grad = gv.grad = None
            F.scaled_dot_product_attention(
                gq, gk, gv, attn_mask=amask,
                is_causal=causal and amask is None,
                dropout_p=rate).backward(doc)

        if flib is None:
            blib = None
        yield dict(
            kernel="flash_unpacked_bwd", case=label, dtype=dt,
            cmp=compare(bkern(), bplain()), kern=bkern, plain=bplain,
            lib=blib, nbytes=nbytes(q, k, v, bias, lens, o, lse, do, dlse,
                                    q, k, v),
            ops=10 * d * pairs, headline=headline, iters=5, plain_iters=2,
        )
        if not want_db:
            continue

        # dbias: checked through the whole backward, timed alone (delta
        # from torch, as the dq pass computes it)
        got = fa._unpacked_bwd(q, k, v, bias, o, lse, do, dlse, causal,
                               scale, lens, rate, seed, True, bshd=True)[3]
        # per-head ds (a bias row per head) gives the L1 mass of the terms
        nb = bias.shape[0]
        per_head = fa.flash_unpacked_bwd_plain(
            flat(q), flat(k), flat(v),
            bias.repeat_interleave(bh // nb, dim=0), flat(o), lse,
            flat(do), causal, scale, lens, rate, seed, dlse, True)[3]
        ref_db = per_head.view(nb, bh // nb, sq, sk).sum(dim=1)
        l1 = per_head.abs().view(nb, bh // nb, sq, sk).sum(dim=1)
        delta = (do.float() * o.float()).sum(dim=-1).reshape(
            bh, sq).contiguous()
        if dlse is not None:
            delta = delta - dlse
        qa, ka, va, doa = (fa._aligned(t) for t in (q, k, v, do))

        def dkern(qa=qa, ka=ka, va=va, bias=bias, lse=lse, doa=doa,
                  delta=delta, causal=causal, lens=lens, rate=rate,
                  scale=scale):
            return fa._flash_dbias(qa, ka, va, bias, lse, doa, delta, causal,
                                   scale, lens, rate, seed)

        def dplain(q=q, k=k, v=v, bias=bias, o=o, lse=lse, do=do, dlse=dlse,
                   causal=causal, lens=lens, rate=rate, scale=scale):
            return fa.flash_unpacked_bwd_plain(
                flat(q), flat(k), flat(v), bias, flat(o), lse, flat(do),
                causal, scale, lens, rate, seed, dlse, True)[3]

        dlib = None
        if flib is not None and amask is not None:
            mg = amask.detach().clone().requires_grad_(True)

            def dlib(gq=gq, gk=gk, gv=gv, mg=mg, doc=doc, rate=rate):
                gq.grad = gk.grad = gv.grad = mg.grad = None
                F.scaled_dot_product_attention(
                    gq, gk, gv, attn_mask=mg, dropout_p=rate).backward(doc)

            try:
                dlib()
                torch.cuda.synchronize()
            except RuntimeError as e:  # no SDPA backend differentiates it
                log(f"  (SDPA with a mask that needs grad: {e})"[:160])
                dlib = None
        yield dict(
            kernel="flash_dbias", case=label, dtype=dt,
            cmp=compare((got,), (ref_db,), [_l1_tol(l1)]), kern=dkern,
            plain=dplain, lib=dlib,
            nbytes=nbytes(q, k, v, bias, lens, lse, do, delta, got),
            ops=4 * d * pairs,
            headline=dt == torch.bfloat16 and bias_kind == "bert",
            iters=5, plain_iters=2,
        )


def unpacked_vs_packed_cases(dev):
    """The cross-check: with no bias and a zero projection bias, the
    unpacked kernels on the per-head views of a fused projection equal
    the packed kernels on the projection itself, dropout 0.1 on (the
    same keep bits), causal and not. In fp32, where the two fold the
    scale into the scores in different places and differ by fp32
    rounding only."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(12)
    B, S, nh, hd = 2, 320, 8, 128
    scale, seed, rate = 1.0 / math.sqrt(hd), 55, 0.1
    for causal in (True, False):
        qkv = torch.randn(B, S, nh, 3 * hd, device=dev, generator=gen)
        do = torch.randn(B, S, nh * hd, device=dev, generator=gen)
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.split(hd, dim=-1))

        def kern(qkv=qkv, q=q, k=k, v=v, do=do, causal=causal):
            o, lse = fa._unpacked_fwd(q, k, v, None, causal, scale, None,
                                      rate, seed, bshd=True)
            do4 = do.view(B, S, nh, hd).permute(0, 2, 1, 3)
            dq, dk, dv, _ = fa._unpacked_bwd(q, k, v, None, o, lse, do4,
                                             None, causal, scale, None, rate,
                                             seed, False, bshd=True)
            dqkv = torch.cat([t.permute(0, 2, 1, 3) for t in (dq, dk, dv)],
                             dim=-1)
            return o.permute(0, 2, 1, 3).reshape(B, S, nh * hd), lse, dqkv

        def packed(qkv=qkv, do=do, causal=causal):
            o, lse = fa._flash_fwd(qkv, None, causal, scale, rate, seed)
            dqkv, _ = fa._flash_bwd(qkv, None, o, lse, do, causal, scale,
                                    rate, seed)
            return o, lse, dqkv

        got, ref = kern(), packed()
        pairs = B * nh * (S * (S + 1) // 2 if causal else S * S)
        yield dict(
            kernel="flash_unpacked_fwd",
            case=f"= packed kernels, dropout {rate}, "
                 f"{'causal' if causal else 'not causal'}, ({B}, {S}, {nh}, "
                 f"{3 * hd}) float32: forward and backward",
            dtype=torch.float32, cmp=compare(got, ref), kern=kern,
            plain=packed, lib=None, nbytes=nbytes(qkv, do, *got),
            ops=14 * hd * pairs, headline=False, iters=5, plain_iters=5,
        )


def fmha_lengths():
    """bench.py fmha's sequence lengths (RandomState(0))."""
    return np.random.RandomState(0).choice(
        FMHA_LENS, size=FMHA_BATCH, p=FMHA_P).tolist()


def _cu(lens, dev):
    return torch.tensor(np.cumsum([0] + list(lens)), dtype=torch.int32,
                        device=dev)


def _seg_ids(lens, dev):
    return torch.repeat_interleave(
        torch.arange(len(lens), dtype=torch.int32),
        torch.tensor(lens)).to(dev)


def _seg_pairs(seg, causal):
    """The (query, key) pairs segment attention attends on these ids,
    counted per 4096-query slab: the work its data needs."""
    seg = seg.to(DEV_CPU).long()
    n, col = 0, torch.arange(seg.numel())
    for r0 in range(0, seg.numel(), 4096):
        rows = torch.arange(r0, min(seg.numel(), r0 + 4096))
        live = seg[rows][:, None] == seg[None, :]
        if causal:
            live &= col[None, :] <= rows[:, None]
        n += int(live.sum())
    return n


def _per_head(fn, *ts):
    """``fn`` on head slices of (h, total, d) tensors, results stacked:
    the plain versions' (total, total) scores fit one head at a time."""
    outs = [fn(*(t if t is None or t.dim() < 2 else t[i:i + 1]
                 for t in ts)) for i in range(ts[0].shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def seg_train_cases(dev):
    """The training segment attention (forward; backward, a dq and a dk/dv
    pass) against its plain versions: bench.py's fmha batch (17408 tokens,
    8 heads x 64, bf16, q/k/v read in place from the packed (total, 3, h,
    d) qkv), causal (the path's form) and not; masked BERT-Large's lengths
    packed (8 heads x 128, not causal); fp32 on a small ragged batch with
    an empty sequence; ids out of order (every tile range then spans
    several ids, and a range test must still skip no live pair). The
    plain versions run one head at a time. Beside each: the bound, the
    plain time, one PyTorch call (SDPA on a jagged nested tensor where it
    takes the case, else SDPA on the padded batch with the length mask;
    `library` says which) and, for the forward, the serving kernel's time
    on the same inputs (`row3_ms`, the per-row kernel that
    `flash_attention_segments_with_lse` launches)."""
    from rocm_apex_tpu_torch.ops import flash_attention_segments as fs

    gen = torch.Generator(device=dev).manual_seed(13)
    rng = np.random.RandomState(1)
    shuffled = rng.permutation(np.repeat(np.arange(9), 4)).tolist()
    cases = [
        # name, lengths, heads, head_dim, dtype, causal, ids, headline
        ("fmha batch", fmha_lengths(), FMHA_HEADS, FMHA_HD, torch.bfloat16,
         True, None, True),
        ("fmha batch", fmha_lengths(), FMHA_HEADS, FMHA_HD, torch.bfloat16,
         False, None, False),
        ("masked BERT-Large lengths", bert_lengths(BERT_BATCH).tolist(), 8,
         128, torch.bfloat16, False, None, False),
        ("ragged, an empty sequence", FMHA_PARITY_LENS, 4, 64, torch.float32,
         True, None, False),
        ("ids out of order", [29] * 36, 4, 64, torch.bfloat16, True, shuffled,
         False),
    ]
    for name, lens, h, d, dt, causal, ids, headline in cases:
        seg = _seg_ids(lens, dev)
        if ids is not None:  # run i of 29 tokens carries id ids[i]
            seg = torch.tensor(ids, dtype=torch.int32).repeat_interleave(
                29).to(dev)
        total, scale = seg.numel(), 1.0 / math.sqrt(d)
        qkv = (0.5 * torch.randn(total, 3, h, d, device=dev,
                                 generator=gen)).to(dt)
        q, k, v = (qkv[:, i].transpose(0, 1) for i in range(3))
        do = torch.randn(total, h, d, device=dev, generator=gen).to(
            dt).transpose(0, 1)
        pairs = _seg_pairs(seg, causal)
        label = (f"{name}, {'causal' if causal else 'not causal'} ({h}, "
                 f"{total}, {d}) {str(dt)[6:]}")

        def fkern(q=q, k=k, v=v, seg=seg, causal=causal, scale=scale):
            return fs._seg_fwd(q, k, v, seg, causal, scale, token_major=True)

        def fplain(q=q, k=k, v=v, seg=seg, causal=causal, scale=scale):
            return _per_head(
                lambda q, k, v: fs.flash_attention_segments_plain(
                    q, k, v, seg, causal, scale), q, k, v)

        def frow3(q=q, k=k, v=v, seg=seg, causal=causal, scale=scale):
            return fs.flash_attention_segments_with_lse(q, k, v, seg, causal,
                                                        scale)

        flib, blib, lib_form = _seg_library(qkv, do, lens, seg, ids, causal,
                                            scale)
        o, lse = fkern()
        ref = fplain()
        yield dict(
            kernel="flash_segments_fwd", case=label, dtype=dt,
            cmp=compare((o, lse), ref, [None, LSE_L1_RTOL * ref[1].abs()]),
            kern=fkern, plain=fplain, lib=flib, library=lib_form,
            extra_timings=dict(row3_ms=frow3),
            nbytes=nbytes(q, k, v, seg, o, lse), ops=4 * d * pairs,
            headline=headline, iters=10, plain_iters=1,
        )

        def bkern(q=q, k=k, v=v, seg=seg, o=o, lse=lse, do=do, causal=causal,
                  scale=scale):
            return fs._seg_bwd(q, k, v, seg, o, lse, do, causal, scale,
                               dqkv=torch.empty_like(qkv))

        def bplain(q=q, k=k, v=v, seg=seg, o=o, lse=lse, do=do,
                   causal=causal, scale=scale):
            return _per_head(
                lambda *ts: fs.flash_attention_segments_bwd_plain(
                    *ts[:3], seg, *ts[3:], causal, scale),
                q, k, v, o, lse, do)

        yield dict(
            kernel="flash_segments_bwd", case=label, dtype=dt,
            cmp=compare(bkern(), bplain()), kern=bkern, plain=bplain,
            lib=blib, library=lib_form,
            nbytes=nbytes(q, k, v, seg, o, lse, do, q, k, v),
            ops=10 * d * pairs, headline=headline, iters=5, plain_iters=1,
        )


def _seg_library(qkv, do, lens, seg, ids, causal, scale):
    """One PyTorch call for the same attention, forward and forward +
    backward, and which call it is: SDPA on a jagged nested tensor
    (offsets = cu_seqlens) where torch takes it for this case, else SDPA
    on the padded (b, h, max_s, d) batch with the length mask (and the
    causal triangle); None for ids out of order, which neither form
    takes."""
    if ids is not None:
        return None, None, None
    dev = qkv.device
    total, _, h, d = qkv.shape
    cu = _cu(lens, dev).long()
    leaves = [qkv[:, i].contiguous().requires_grad_(True) for i in range(3)]
    dot = do.transpose(0, 1).contiguous()

    def njt():
        q, k, v = (torch.nested.nested_tensor_from_jagged(
            t, offsets=cu).transpose(1, 2) for t in leaves)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              scale=scale)

    try:
        njt().transpose(1, 2).values().backward(dot)
        torch.cuda.synchronize()

        def flib():
            with torch.no_grad():
                return njt()

        def blib():
            for t in leaves:
                t.grad = None
            njt().transpose(1, 2).values().backward(dot)

        return flib, blib, "sdpa_nested_jagged"
    except (RuntimeError, NotImplementedError, ValueError) as e:
        log(f"  (SDPA on a jagged nested tensor: {e})"[:200])
    b, max_s = len(lens), max(lens)
    seq = torch.searchsorted(cu[1:], torch.arange(total, device=dev),
                             right=True)
    off = torch.arange(total, device=dev) - cu[seq]
    lengths = torch.tensor(lens, device=dev)
    live = torch.arange(max_s, device=dev)[None, :] < lengths[:, None]
    mask = live[:, None, None, :]
    if causal:
        mask = mask & torch.ones(max_s, max_s, dtype=torch.bool,
                                 device=dev).tril()
    pad = torch.zeros(b, max_s, 3, h, d, dtype=qkv.dtype, device=dev)
    pad[seq, off] = qkv
    qp, kp, vp = (pad[:, :, i].transpose(1, 2).contiguous().requires_grad_(
        True) for i in range(3))
    dop = torch.zeros(b, max_s, h, d, dtype=qkv.dtype, device=dev)
    dop[seq, off] = dot
    dop = dop.transpose(1, 2).contiguous()

    def flib():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qp, kp, vp, attn_mask=mask,
                                                  scale=scale)

    def blib():
        qp.grad = kp.grad = vp.grad = None
        F.scaled_dot_product_attention(qp, kp, vp, attn_mask=mask,
                                       scale=scale).backward(dop)

    return flib, blib, "sdpa_padded_mask"


def xent_bwd_cases(dev):
    """The two-pass backward form (contrib/xentropy's) against
    `xent_bwd_reference` on the same lse: the BERT head's (4096, 30592)
    bf16 logits with smoothing 0.1 and rows at padding_idx (their
    cotangent zero, as the autograd function passes it); fp32; an odd
    vocab (the scalar form). dx = dl * (softmax - target) carries dg's
    tolerances, `XENT_DG_TOL` and the L1 check. The library yardstick is
    `F.cross_entropy(reduction="none", label_smoothing=eps,
    ignore_index=padding_idx)` forward + backward on the same logits (the
    kernel is the backward alone; `two_pass_ms` is the port's forward +
    backward, `softmax_cross_entropy_loss`)."""
    from rocm_apex_tpu_torch.ops import xentropy as xe

    gen = torch.Generator(device=dev).manual_seed(14)
    rows_full, vocab = BERT_BATCH * BERT_SEQ, BERT["vocab_size"]
    for rows, v, dt in ((rows_full, vocab, torch.bfloat16),
                        (1024, vocab, torch.float32),
                        (512, 30001, torch.bfloat16)):
        x = (2.0 * torch.randn(rows, v, device=dev, generator=gen)).to(dt)
        labels = torch.randint(0, v, (rows,), device=dev, generator=gen)
        labels[0], labels[1] = 0, v - 1
        labels[::7] = XENT_PAD  # padded rows
        dl = torch.randn(rows, device=dev, generator=gen)
        dl = torch.where(labels == XENT_PAD, 0.0, dl)
        _, lse = xe.xent_fwd(x, labels, XENT_SMOOTHING)

        def kern(x=x, labels=labels, lse=lse, dl=dl):
            return xe.xent_bwd(x, labels, lse, dl, XENT_SMOOTHING)

        def plain(x=x, labels=labels, lse=lse, dl=dl):
            return xe.xent_bwd_reference(x, labels, lse, dl, XENT_SMOOTHING)

        xg = x.detach().clone().requires_grad_(True)
        w = torch.randn(rows, device=dev, generator=gen).to(dt)

        def lib(xg=xg, labels=labels, w=w):
            xg.grad = None
            F.cross_entropy(xg, labels, reduction="none",
                            label_smoothing=XENT_SMOOTHING,
                            ignore_index=XENT_PAD).backward(w)

        def two_pass(xg=xg, labels=labels, w=w):
            xg.grad = None
            xe.softmax_cross_entropy_loss(xg, labels, XENT_SMOOTHING,
                                          XENT_PAD).backward(w.float())

        got, ref = kern(), plain()
        got = (got, got.double().abs().sum() / rows)
        ref = (ref, ref.double().abs().sum() / rows)
        yield dict(
            kernel="xent_bwd",
            case=f"({rows}, {v}) {str(dt)[6:]}, smoothing {XENT_SMOOTHING}, "
                 f"rows at padding_idx {XENT_PAD}",
            dtype=dt,
            cmp=compare(got, ref, tols=[XENT_DG_TOL[dt],
                                        dict(rtol=XENT_DG_L1_RTOL, atol=0.0)]),
            kern=kern, plain=plain, lib=lib,
            library="F.cross_entropy forward + backward",
            extra_timings=dict(two_pass_ms=two_pass),
            nbytes=nbytes(x, labels, lse, dl, got[0]), ops=6 * rows * v,
            headline=rows == rows_full and dt == torch.bfloat16,
            iters=20, plain_iters=3,
        )


CASE_GROUPS = dict(ln=ln_cases, seg=seg_cases, decode=decode_cases,
                   paged=paged_decode_cases, train_ln=train_ln_cases,
                   flash=flash_cases,
                   xent=lambda dev: itertools.chain(xent_cases(dev),
                                                    xent_bwd_cases(dev)),
                   lamb=lamb_cases,
                   unpacked=lambda dev: itertools.chain(
                       unpacked_cases(dev), unpacked_vs_packed_cases(dev)),
                   seg_train=seg_train_cases)


def run_kernel_phase(dev, generators):
    """Check and time each case as its generator yields it (the
    closures read the generator's loop variables)."""
    out = []
    for c in itertools.chain(*(g(dev) for g in generators)):
        cmp = c["cmp"]
        log(f"  {c['kernel']:<36} {c['case']:<58} max|err| "
            f"{cmp['err']:.3e}, max|plain y or o| {cmp['ref_max']:.3e}; worst "
            f"err/tol {cmp['ratio']:.3f} (tol atol + rtol|plain|, each "
            f"output's own)")
        check(cmp["ratio"] <= 1.0, f"{c['kernel']} {c['case']}: an output "
              f"differs from its plain version by {cmp['ratio']:.3g}x its "
              f"tolerance (max abs error {cmp['err']:.3e})")
        iters = c.get("iters", 100)
        ms = device_ms(c["kern"], iters)
        call_ms = cuda_ms(c["kern"], iters)
        plain_ms = device_ms(c["plain"], c.get("plain_iters", 10), warmup=1)
        lib_ms = (device_ms(c["lib"], iters) if c["lib"] is not None
                  else None)
        lib32_ms = (device_ms(c["lib32"], iters)
                    if c.get("lib32") is not None else None)
        b_ms, b_by = bound_ms(c["nbytes"], c["ops"], c["dtype"])
        extra = {k: device_ms(fn, c.get("iters", 100))
                 for k, fn in c.get("extra_timings", {}).items()}
        out.append(dict(
            kernel=c["kernel"], case=c["case"], max_abs_err=cmp["err"],
            max_abs_out=cmp["ref_max"], err_over_tol=cmp["ratio"], ms=ms,
            call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
            library_fp32_ms=lib32_ms, bound_ms=b_ms, bound_by=b_by,
            bytes=c["nbytes"], ops=c["ops"],
            headline=c["headline"], library=c.get("library"), **extra,
        ))
        log(f"    kernel {ms:.4f} ms (call {call_ms:.4f})  plain "
            f"{plain_ms:.4f} ms  library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            f"{'' if lib32_ms is None else f' (on fp32 {lib32_ms:.4f} ms)'}"
            f"{'' if c.get('library') is None else ' [' + c['library'] + ']'}"
            f"  bound {b_ms:.4f} ms ({b_by})"
            + "".join(f"  {k} {t:.4f}" for k, t in extra.items()))
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: the engine
# ---------------------------------------------------------------------------


def serve_prompts(vocab):
    """bench.py serve's workload: RandomState(0) prompt lengths drawn
    from PROMPT_LENS with PROMPT_P, uniform token ids."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, size=int(rng.choice(PROMPT_LENS,
                                                      p=PROMPT_P))).tolist()
            for _ in range(N_REQUESTS)]


def shared_prefix_prompts(vocab, n=N_REQUESTS):
    """bench.py serve --shared-prefix on an accelerator: from
    RandomState(0), one SHARED_PREFIX-token prefix, then per request a
    tail of 4-16 uniform token ids."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, vocab, size=SHARED_PREFIX).tolist()
    return [prefix + rng.randint(0, vocab, size=int(rng.randint(4, 17)))
            .tolist() for _ in range(n)]


def _engine(model, **kw):
    """The serving engine of bench.py serve: 8 slots, capacity 1024,
    budget 256, greedy; ``whole=True`` is its A/B baseline, the
    whole-prompt path (``prefill_token_budget=None``, prompts padded to
    the longest prompt length, bench.py:686-694)."""
    from rocm_apex_tpu_torch.inference import InferenceEngine, SamplingParams

    if kw.pop("whole", False):
        kw.update(prefill_token_budget=None, max_prompt_len=max(PROMPT_LENS))
    kw.setdefault("prefill_token_budget", BUDGET)
    return InferenceEngine(model, num_slots=SLOTS, capacity=CAPACITY,
                           sampling=SamplingParams(temperature=0.0), **kw)


def _tokens(eng, prompts, max_new):
    return [r.tokens for r in eng.generate(prompts, max_new_tokens=max_new)]


def _pack(pieces):
    """A chunk of BUDGET tokens from ``(slot, tokens, start position)``
    pieces, then pads (slot id SLOTS)."""
    toks = np.zeros((BUDGET,), np.int64)
    slots = np.full((BUDGET,), SLOTS, np.int32)
    pos = np.zeros((BUDGET,), np.int32)
    at = 0
    for slot, tk, start in pieces:
        n = min(len(tk), BUDGET - at)
        toks[at:at + n], slots[at:at + n] = tk[:n], slot
        pos[at:at + n] = np.arange(start, start + n)
        at += n
    return toks, slots, pos, at


def _chunk_logits(model, cache, chunk, dev):
    toks, slots, pos, n = chunk
    out, _ = model(torch.from_numpy(toks).to(dev)[None], cache=cache,
                   chunk=(torch.from_numpy(slots).to(dev),
                          torch.from_numpy(pos).to(dev)))
    return out[0, :n].cpu()


def run_paged_parity(cfg, models, prompts, contiguous):
    """The paged engine at page size 16 on the parity config: fp32
    tokens card == CPU == the contiguous engine's (``contiguous``); int8
    pages card against CPU; prefix sharing against no sharing; and a
    pool below demand."""
    from rocm_apex_tpu_torch.inference import PagedKVCache

    res = {}
    paged = {dev: _tokens(_engine(m, paged=True, page_size=PAGE_SIZE),
                          prompts, PARITY_NEW)
             for dev, m in models.items()}
    same = paged[CARD] == paged["cpu"] == contiguous
    log(f"  paged fp32 greedy tokens, page {PAGE_SIZE}: cuda "
        f"{'==' if same else '!='} cpu, contiguous")
    check(same, f"paged greedy tokens differ: {paged}, contiguous "
          f"{contiguous}")
    res["paged_tokens_identical"] = same

    # int8 pages through the model, two chunks of three prompt pieces on
    # a permuted table. The first chunk's logits read only the chunk's
    # own fp32 K/V; its int8 writes may differ by one step where the
    # card's and the CPU's K/V straddle a rounding boundary. The second
    # chunk reads the first's pages (the int8 kernel on the card): both
    # sides start it from the CPU's bytes, so its logits differ by
    # summation order only.
    pieces = [(2, prompts[0]), (0, prompts[1]), (5, prompts[2])]
    n1 = [min(len(p) // 2, 64) for _, p in pieces]
    chunks = [
        _pack([(s, p[:n], 0) for (s, p), n in zip(pieces, n1)]),
        _pack([(s, p[n:n + 64], n) for (s, p), n in zip(pieces, n1)]),
    ]
    caches = {dev: PagedKVCache.for_model(cfg, SLOTS, CAPACITY,
                                          page_size=PAGE_SIZE,
                                          quantized=True, device=dev)
              for dev in models}
    table = torch.from_numpy(np.random.RandomState(1).permutation(
        caches["cpu"].num_pages).reshape(SLOTS, -1).astype(np.int32))
    lengths = torch.zeros((SLOTS,), dtype=torch.int32)
    int8 = {}
    for i, chunk in enumerate(chunks):
        logits = {}
        for dev, model in models.items():
            c = caches[dev]
            c.page_table.copy_(table)
            c.lengths = lengths.to(dev)
            logits[dev] = _chunk_logits(model, c, chunk, dev)
        err = max_err(logits[CARD], logits["cpu"])
        log(f"  int8 pages, chunk {i + 1} logits ({chunk[3]} rows): "
            f"max|cuda - cpu| {err:.3e} (atol {PARITY_LOGIT_ATOL:g})")
        check(bool(torch.isfinite(logits[CARD]).all()), "nonfinite logits")
        check(err <= PARITY_LOGIT_ATOL, f"int8 chunk {i + 1} logits differ "
              f"by {err:.3e}")
        int8[f"chunk{i + 1}_logit_max_abs_err"] = err
        if i == 0:
            gc, cc = caches[CARD], caches["cpu"]
            steps = max(int((a.cpu().int() - b.int()).abs().max())
                        for a, b in zip(gc.k + gc.v, cc.k + cc.v))
            flips = sum(int((a.cpu() != b).sum())
                        for a, b in zip(gc.k + gc.v, cc.k + cc.v))
            sc_err = max(max_err(a.cpu(), b) / float(b.abs().max())
                         for a, b in zip(gc.k_scale + gc.v_scale,
                                         cc.k_scale + cc.v_scale))
            log(f"  int8 bytes after chunk 1: {flips} differ, by at most "
                f"{steps} step(s); scales within {sc_err:.2e} relative")
            check(steps <= 1 and sc_err <= 1e-5,
                  "the card's int8 pages differ from the CPU's by more "
                  "than a rounding step")
            int8.update(bytes_differing=flips, max_step=steps,
                        scale_rel_err=sc_err)
            for a, b in zip(gc.k + gc.v + gc.k_scale + gc.v_scale,
                            cc.k + cc.v + cc.k_scale + cc.v_scale):
                a.copy_(b)
        for slot, _ in pieces:
            lengths[slot] += int((chunk[1] == slot).sum())
    q8 = {dev: _tokens(_engine(m, paged=True, page_size=PAGE_SIZE,
                               kv_dtype=torch.int8), prompts, PARITY_NEW)
          for dev, m in models.items()}
    same = q8[CARD] == q8["cpu"]
    log(f"  int8 pages greedy tokens: cuda {'==' if same else '!='} cpu; "
        f"{sum(a == b for a, b in zip(q8[CARD], contiguous))}/"
        f"{len(prompts)} requests match the float cache")
    check(same, f"int8 greedy tokens differ: {q8}")
    res["int8"] = dict(int8, tokens_identical=same)

    # prefix sharing on the card: one request registers the prefix, then
    # the rest borrow it, the partial last page copied on write
    shared = shared_prefix_prompts(cfg.vocab_size, 6)
    shared.sort(key=len, reverse=True)  # the first fills its 16th page
    waves = [shared[:1], shared[1:]]
    runs = {}
    for sharing in (True, False):
        eng = _engine(models[CARD], paged=True, page_size=PAGE_SIZE,
                      prefix_sharing=sharing)
        runs[sharing] = ([_tokens(eng, w, PARITY_NEW) for w in waves],
                         eng.stats())
    s = runs[True][1]
    same = runs[True][0] == runs[False][0]
    log(f"  prefix sharing ({SHARED_PREFIX}-token prefix, page "
        f"{PAGE_SIZE}): tokens {'==' if same else '!='} unshared; "
        f"{s['prefix_hits']:.0f} hits, {s['prefix_hit_tokens']:.0f} hit "
        f"tokens, {s['cow_forks']:.0f} copy-on-write forks")
    check(same, "prefix sharing changed tokens")
    check(s["prefix_hits"] > 0 and s["cow_forks"] >= 1,
          "prefix sharing made no hit or no copy-on-write fork")
    res["prefix_sharing"] = dict(
        tokens_identical=same, prefix_hits=s["prefix_hits"],
        prefix_hit_tokens=s["prefix_hit_tokens"], cow_forks=s["cow_forks"])

    # a pool below demand: the largest request fits, not all at once
    need = max(-(-(len(p) + PARITY_NEW) // PAGE_SIZE) for p in prompts)
    eng = _engine(models[CARD], paged=True, page_size=PAGE_SIZE,
                  num_pages=need + 2)
    results = eng.generate(prompts, max_new_tokens=PARITY_NEW)
    s = eng.stats()
    match = sum(r.tokens == t for r, t in zip(results, contiguous))
    log(f"  pool of {need + 2} pages: {s['page_stalls']:.0f} page stalls, "
        f"{s['preemptions']:.0f} preemptions, {eng.pages_used} pages in "
        f"use after the drain; {match}/{len(prompts)} requests match the "
        f"contiguous tokens")
    check(s["page_stalls"] > 0, "the small pool never stalled")
    check(all(r.finish_reason == "length" and len(r.tokens) == PARITY_NEW
              for r in results), "a request did not finish under the "
          "small pool")
    check(eng.pages_used == 0, "pages left in use after the drain")
    res["small_pool"] = dict(num_pages=need + 2,
                             page_stalls=s["page_stalls"],
                             preemptions=s["preemptions"],
                             requests_matching_contiguous=match)
    return res


def run_parity_phase():
    from rocm_apex_tpu_torch.convert import from_jax_params, random_params
    from rocm_apex_tpu_torch.inference import KVCache
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**{**SERVE, "num_layers": 2},
                    params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(cfg, seed=0)
    models = {dev: from_jax_params(tree, cfg, device=dev)
              for dev in (CARD, "cpu")}
    prompts = serve_prompts(cfg.vocab_size)[:6]

    # first chunk: three prompt pieces out of slot order, then pads
    chunk = _pack([(2, prompts[0], 0), (0, prompts[1], 0),
                   (5, prompts[2], 0)])
    at = chunk[3]
    logits = {dev: _chunk_logits(
        model, KVCache.for_model(cfg, SLOTS, CAPACITY, device=dev), chunk,
        dev) for dev, model in models.items()}
    err = max_err(logits[CARD], logits["cpu"])
    check(bool(torch.isfinite(logits[CARD]).all()), "nonfinite logits")
    log(f"  first-chunk logits ({at} rows x {cfg.vocab_size}): max|cuda - "
        f"cpu| {err:.3e} (atol {PARITY_LOGIT_ATOL:g})")
    check(err <= PARITY_LOGIT_ATOL, f"parity logits differ by {err:.3e}")

    tokens = {dev: _tokens(_engine(model), prompts, PARITY_NEW)
              for dev, model in models.items()}
    same = tokens[CARD] == tokens["cpu"]
    log(f"  greedy tokens of {len(prompts)} requests x {PARITY_NEW}: cuda "
        f"{'==' if same else '!='} cpu")
    check(same, f"greedy tokens differ: {tokens}")
    # the whole-prompt path (padded prefill: the unpacked causal forward)
    whole = {dev: _tokens(_engine(model, whole=True), prompts, PARITY_NEW)
             for dev, model in models.items()}
    whole_same = whole[CARD] == whole["cpu"] == tokens[CARD]
    log(f"  whole-prompt greedy tokens: cuda "
        f"{'==' if whole_same else '!='} cpu, chunked")
    check(whole_same, f"whole-prompt greedy tokens differ: {whole}, "
          f"chunked {tokens[CARD]}")
    return dict(logit_max_abs_err=err, requests=len(prompts),
                tokens_identical=same, whole_tokens_identical=whole_same,
                paged=run_paged_parity(cfg, models, prompts,
                                       tokens[CARD]))


_SERVE_MODEL = {}


def _serve_model():
    """The full serving config in bf16 on the card, from seeded random
    weights; built once for the contiguous and the paged serve."""
    from rocm_apex_tpu_torch.convert import from_jax_params, random_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    if not _SERVE_MODEL:
        cfg = GPTConfig(**SERVE, params_dtype=torch.float32,
                        dtype=torch.bfloat16)
        t0 = time.perf_counter()
        _SERVE_MODEL["model"] = from_jax_params(random_params(cfg, seed=0),
                                                cfg, device=CARD)
        _SERVE_MODEL["load_s"] = time.perf_counter() - t0
    return _SERVE_MODEL["model"], _SERVE_MODEL["load_s"]


def timed_serve(eng, prompts):
    """One timed serve of ``prompts`` x MAX_NEW greedy tokens on a warm
    engine: every kernel's launch count is set to 0 just before and read
    just after. Checks that every request ran to MAX_NEW finite,
    in-vocabulary tokens; returns (metrics, the requests' tokens)."""
    from rocm_apex_tpu_torch.ops._build import KERNELS

    vocab = eng.model.cfg.vocab_size
    eng.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.add_request(p, MAX_NEW) for p in prompts]
    done, peak_pages = {}, 0
    while eng.has_work():
        for r in eng.step():
            done[r.request_id] = r
        peak_pages = max(peak_pages, eng.pages_used)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    results = [done[i] for i in ids]
    s = eng.stats()
    gen = sum(len(r.tokens) for r in results)
    ticks = int(s["mixed_steps"] + s["decode_only_steps"])
    check(all(r.finish_reason == "length" and len(r.tokens) == MAX_NEW
              for r in results), "a request did not run to max_new_tokens")
    check(s["quarantined"] == 0, "nonfinite logits in the serve run")
    check(all(0 <= t < vocab for r in results for t in r.tokens),
          "token id out of range")
    res = dict(
        requests=len(results), prompt_tokens=int(s["prompt_tokens"]),
        generated_tokens=gen, seconds=dt, tokens_per_s=gen / dt,
        ttft_ms_p50=s["ttft_ms_p50"], ttft_ms_p95=s["ttft_ms_p95"],
        tpot_ms_p50=float(np.percentile(
            [c["tpot_ms"] for c in eng.completions], 50)),
        mixed_ticks=int(s["mixed_steps"]),
        decode_only_ticks=int(s["decode_only_steps"]),
        ticks=ticks, mixed_tick_ms=s["prefill_ms_avg"],
        decode_tick_ms=s["decode_ms_avg"], launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        cache_bytes=eng.cache_bytes(),
    )
    if eng.paged:
        res.update(peak_pages_used=peak_pages,
                   pages_total=int(s["pages_total"]),
                   pages_used_after=eng.pages_used,
                   **{k: s[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                        "cow_forks", "page_stalls",
                                        "preemptions")})
    log(f"  {gen} tokens in {dt:.3f} s: {gen / dt:.1f} generated tok/s; "
        f"TTFT p50 {s['ttft_ms_p50']:.1f} ms p95 {s['ttft_ms_p95']:.1f} ms; "
        f"TPOT p50 {res['tpot_ms_p50']:.2f} ms; "
        f"{ticks} ticks ({res['mixed_ticks']} mixed at "
        f"{s['prefill_ms_avg']:.2f} ms, {res['decode_only_ticks']} decode-only"
        f" at {s['decode_ms_avg']:.2f} ms); peak "
        f"{res['peak_mem_gib']:.2f} GiB, cache {res['cache_bytes'] / 2**20:.1f}"
        f" MiB")
    log(f"  launches in the timed run: {launches}")
    return res, [r.tokens for r in results]


def run_serve_phase(profile):
    model, load_s = _serve_model()
    prompts = serve_prompts(model.cfg.vocab_size)
    eng = _engine(model)
    eng.generate(prompts[:SLOTS], max_new_tokens=3)  # warm-up
    res, tokens = timed_serve(eng, prompts)
    res.update(weights_load_s=load_s, tokens=tokens)
    for name in SERVE_KERNELS:
        check(res["launches"][name] > 0,
              f"kernel {name} was not launched on the serving path")
    if profile:
        res["profile"] = profile_window(
            lambda: eng.generate(prompts[:SLOTS], max_new_tokens=16),
            f"serve: {SLOTS} requests x 16 new tokens")
    return res


def run_serve_paged_phase(profile, contiguous_tokens=None):
    """The serve on the paged cache in three forms: bf16 pages, int8
    pages, and shared-prefix traffic with prefix sharing. Each form's
    launches are counted over its timed run alone; the phase's
    ``launches`` are their sums. Tokens are compared with the contiguous
    engine's on the same prompts (the serve phase's, or a run here),
    counted and not asserted: bf16 GEMMs over other chunk mixes may move
    a logit by an ulp."""
    model, load_s = _serve_model()
    vocab = model.cfg.vocab_size
    prompts = {"serve": serve_prompts(vocab),
               "shared": shared_prefix_prompts(vocab)}
    reference = {"serve": contiguous_tokens}
    for name, ps in prompts.items():
        if reference.get(name) is None:
            reference[name] = _tokens(_engine(model), ps, MAX_NEW)
    forms = (
        ("bf16", "serve", dict(), "flash_attention_decode_paged"),
        ("int8", "serve", dict(kv_dtype=torch.int8),
         "flash_attention_decode_paged_int8"),
        ("shared_prefix", "shared", dict(prefix_sharing=True),
         "flash_attention_decode_paged"),
    )
    res = dict(weights_load_s=load_s, page_size=PAGE_SIZE, forms={},
               launches={})
    for form, traffic, kw, kernel in forms:
        log(f"  -- {form} pages ({traffic} traffic)")
        ps = prompts[traffic]
        eng = _engine(model, paged=True, page_size=PAGE_SIZE, **kw)
        eng.generate(ps[:SLOTS], max_new_tokens=3)  # warm-up
        if eng.prefix_sharing:
            # a prompt that ends inside a stored page: a partial borrow
            # and its copy-on-write fork, before the timed run
            eng.generate([ps[0][:SHARED_PREFIX + 2]], max_new_tokens=3)
        r, tokens = timed_serve(eng, ps)
        r["requests_matching_contiguous"] = sum(
            a == b for a, b in zip(tokens, reference[traffic]))
        log(f"  {r['peak_pages_used']}/{r['pages_total']} pages at the "
            f"peak; {r['prefix_hits']:.0f} prefix hits "
            f"({r['prefix_hit_tokens']:.0f} tokens), {r['cow_forks']:.0f} "
            f"forks, {r['page_stalls']:.0f} stalls; "
            f"{r['requests_matching_contiguous']}/{len(ps)} requests match "
            f"the contiguous tokens")
        for name in PAGED_SERVE_KERNELS + (kernel,):
            check(r["launches"][name] > 0,
                  f"{form}: kernel {name} was not launched on the paged "
                  f"serving path")
        check(r["launches"]["flash_attention_decode"] == 0,
              f"{form}: the paged serve launched the contiguous decode read")
        check(r["pages_used_after"] == 0, f"{form}: pages left in use")
        if eng.prefix_sharing:
            check(r["prefix_hits"] > 0, "shared-prefix traffic made no hit")
        for name, n in r["launches"].items():
            res["launches"][name] = res["launches"].get(name, 0) + n
        if profile:
            r["profile"] = profile_window(
                lambda: eng.generate(ps[:SLOTS], max_new_tokens=16),
                f"paged serve, {form}: {SLOTS} requests x 16 new tokens")
        res["forms"][form] = r
    return res


def run_serve_whole_phase(profile, chunked_tokens=None):
    """The serve's 32 requests on the whole-prompt path: one padded
    (1, 768) prefill per admitted request (the unpacked causal forward,
    once per layer), then the decode grid. Tokens are compared with the
    chunked serve's (counted, not asserted: bf16 over another batching)."""
    model, load_s = _serve_model()
    prompts = serve_prompts(model.cfg.vocab_size)
    if chunked_tokens is None:
        chunked_tokens = _tokens(_engine(model), prompts, MAX_NEW)
    eng = _engine(model, whole=True)
    eng.generate(prompts[:SLOTS], max_new_tokens=3)  # warm-up
    res, tokens = timed_serve(eng, prompts)
    layers = model.cfg.num_layers
    res.update(weights_load_s=load_s, max_prompt_len=eng.max_prompt_len,
               requests_matching_chunked=sum(
                   a == b for a, b in zip(tokens, chunked_tokens)))
    log(f"  {res['requests_matching_chunked']}/{len(prompts)} requests "
        f"match the chunked serve's tokens")
    want = len(prompts) * layers
    check(res["launches"]["flash_unpacked_fwd"] == want,
          f"flash_unpacked_fwd: {res['launches']['flash_unpacked_fwd']} "
          f"launches, expected one per admitted request and layer ({want})")
    check(res["launches"]["flash_attention_decode"] > 0,
          "flash_attention_decode was not launched in the whole-prompt "
          "serve")
    check(res["launches"]["flash_attention_segments_with_lse"] == 0,
          "the whole-prompt serve launched the chunk kernel")
    if profile:
        res["profile"] = profile_window(
            lambda: eng.generate(prompts[:SLOTS], max_new_tokens=16),
            f"whole-prompt serve: {SLOTS} requests x 16 new tokens")
    return res


def profile_window(run, what):
    """Device busy share over a short window of ``run()`` (``what`` says
    what it runs): the union of kernel intervals on the
    card over the window's wall time; the ops with the most device time
    and the most host (self CPU) time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_s = busy / 1e6
    # device time by kernel (the kernels' own intervals, so nothing is
    # counted twice) and host self time by op
    device_ms, host_ms = {}, {}
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            key = e.name[:80]
            device_ms[key] = device_ms.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    for e in prof.key_averages():
        if e.self_cpu_time_total:
            host_ms[e.key[:80]] = e.self_cpu_time_total / 1e3

    def top(d, n=12):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])

    res = dict(wall_s=wall, device_busy_s=busy_s,
               busy_share=busy_s / wall if spans else None,
               window=what, top_device_ms=top(device_ms, 24),
               top_host_self_ms=top(host_ms))
    log(f"  profiled window ({what}): wall {wall:.3f} s, device busy "
        f"{busy_s:.3f} s ({'not measured' if not spans else f'{busy_s / wall:.1%}'})")
    return res


# ---------------------------------------------------------------------------
# phases 6 and 7: the training step
# ---------------------------------------------------------------------------


def _train_batch(cfg, batch, seq):
    """bench.py's batch: uniform token ids from a seeded generator
    (numpy here), labels the tokens shifted by one."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64)
    return torch.from_numpy(tokens), torch.from_numpy(np.roll(tokens, -1, 1))


def _trainer(cfg, device, lr):
    from rocm_apex_tpu_torch.amp import LossScaler
    from rocm_apex_tpu_torch.convert import (random_params,
                                             train_state_from_jax_params)
    from rocm_apex_tpu_torch.optimizers import MixedPrecisionAdam
    from rocm_apex_tpu_torch.train import make_train_step

    opt = MixedPrecisionAdam(lr, weight_decay=0.01, compute_dtype=cfg.dtype)
    scaler = LossScaler("dynamic")
    model, state = train_state_from_jax_params(
        random_params(cfg, seed=0), cfg, opt, device=device)
    return (make_train_step(model, opt, scaler), state,
            scaler.init(model.device))


def run_train_parity_phase():
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**{**TRAIN, "num_layers": PARITY_TRAIN["num_layers"],
                       "hidden_dropout": 0.0, "attention_dropout": 0.0},
                    params_dtype=torch.float32, dtype=torch.float32)
    tokens, labels = _train_batch(cfg, PARITY_TRAIN["batch"],
                                  PARITY_TRAIN["seq"])
    runs = {}
    for dev in ("cuda", "cpu"):
        step, state, sstate = _trainer(cfg, dev, 1e-4)
        losses, skips = [], []
        for _ in range(PARITY_TRAIN["steps"]):
            over = sstate.overflows
            state, sstate, loss = step(state, sstate, tokens, labels)
            losses.append(float(loss))
            skips.append(int(sstate.overflows - over))
        runs[dev] = (losses, skips)
    (lc, sc), (lp, sp) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    log(f"  losses cuda {lc}, cpu {lp}: max relative difference {rel:.3e} "
        f"(rtol {PARITY_LOSS_RTOL:g}); skipped steps cuda {sc}, cpu {sp}")
    check(all(math.isfinite(x) for x in lc + lp), "nonfinite parity loss")
    check(rel <= PARITY_LOSS_RTOL, f"train losses differ by {rel:.3e}")
    check(sc == sp, f"skip decisions differ: cuda {sc}, cpu {sp}")
    return dict(losses_cuda=lc, losses_cpu=lp, max_rel_diff=rel,
                skips_cuda=sc, skips_cpu=sp)


def run_train_phase(profile):
    from rocm_apex_tpu_torch.models.gpt import GPTConfig
    from rocm_apex_tpu_torch.ops._build import KERNELS

    cfg = GPTConfig(**TRAIN, params_dtype=torch.float32,
                    dtype=torch.bfloat16)
    t0 = time.perf_counter()
    step, state, sstate = _trainer(cfg, "cuda", 1e-4)
    setup_s = time.perf_counter() - t0
    tokens, labels = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens, labels = tokens.cuda(), labels.cuda()
    gen = torch.Generator().manual_seed(0)  # CPU: the dropout seeds
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, sstate, loss = step(state, sstate, tokens, labels,
                                   dropout_generator=gen)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, sstate, loss = step(state, sstate, tokens, labels,
                                   dropout_generator=gen)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    losses = [float(x) for x in losses]
    scale = float(sstate.loss_scale)
    overflows = int(sstate.overflows)
    res = dict(
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, seconds=dt,
        step_ms=1e3 * dt / TRAIN_STEPS,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / dt,
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        loss_scale=scale, overflows=overflows, setup_s=setup_s,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches,
        calls_per_step={k: launches[k] / TRAIN_STEPS
                        for k in TRAIN_CALLS_PER_STEP},
    )
    log(f"  {TRAIN_STEPS} steps of B {TRAIN_BATCH} x S {TRAIN_SEQ}: "
        f"{res['step_ms']:.2f} ms/step, {res['tokens_per_s']:.1f} tokens/s; "
        f"loss {losses[0]:.4f} (first) -> {losses[-1]:.4f} (last); loss "
        f"scale {scale:g}, {overflows} overflows; peak "
        f"{res['peak_mem_gib']:.2f} GiB")
    log(f"  wrapper calls per step: {res['calls_per_step']} (expected "
        f"{TRAIN_CALLS_PER_STEP})")
    check(all(math.isfinite(x) for x in losses), "nonfinite training loss")
    check(losses[-1] < losses[0], "the training loss did not fall")
    check(scale >= 2.0**12, f"the loss scale collapsed to {scale:g}")
    for name, want in TRAIN_CALLS_PER_STEP.items():
        check(launches[name] == want * TRAIN_STEPS,
              f"{name}: {launches[name]} calls in {TRAIN_STEPS} steps, "
              f"expected {want} per step")
    if profile:
        res["profile"] = profile_window(
            lambda: [step(state, sstate, tokens, labels,
                          dropout_generator=gen) for _ in range(3)],
            "3 train steps")
    return res


# ---------------------------------------------------------------------------
# phases 9 and 10: the BERT training step
# ---------------------------------------------------------------------------


def _bert_batch(cfg, batch, seq):
    """bench.py's batch: uniform token ids from a seeded generator (numpy
    here), labels the tokens rolled by one."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64)
    return torch.from_numpy(tokens), torch.from_numpy(np.roll(tokens, 1, 1))


def _bert_trainer(cfg, device, moment_dtype):
    """``(step, state, model, opt)``: bench.py's optimizer over seeded
    random weights."""
    from rocm_apex_tpu_torch.convert import (flatten_params, random_params,
                                             train_state_from_jax_params)
    from rocm_apex_tpu_torch.optimizers import MixedPrecisionLamb
    from rocm_apex_tpu_torch.train import make_bert_train_step

    tree = random_params(cfg, seed=0)
    mask = {k: not (k.endswith("bias") or "layernorm" in k.lower())
            for k in flatten_params(tree["params"])}
    opt = MixedPrecisionLamb(1e-4, weight_decay=0.01, weight_decay_mask=mask,
                             compute_dtype=cfg.dtype,
                             moment_dtype=moment_dtype, store_model=False)
    model, state = train_state_from_jax_params(tree, cfg, opt, device=device)
    return make_bert_train_step(model, opt), state, model, opt


def run_bert_train_parity_phase():
    from rocm_apex_tpu_torch.models.bert import BertConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BertConfig(**{**BERT, "num_layers": BERT_PARITY["num_layers"],
                        "max_position_embeddings": BERT_PARITY["seq"]},
                     params_dtype=torch.float32, dtype=torch.float32)
    tokens, labels = _bert_batch(cfg, BERT_PARITY["batch"],
                                 BERT_PARITY["seq"])
    runs = {}
    for dev in (CARD, "cpu"):
        step, state, _, opt = _bert_trainer(cfg, dev, torch.float32)
        losses, found = [], []
        for _ in range(BERT_PARITY["steps"]):
            state, loss, inf = step(state, tokens, labels)
            losses.append(float(loss))
            found.append(bool(inf))
        runs[dev] = (losses, found)
        if dev != CARD:
            continue
        # one more step on the card with an inf in one gradient: found,
        # and masters, moments and count bit for bit as they were
        before = {n: {k: t.clone() for k, t in getattr(state, n).items()}
                  for n in ("master", "m", "v")}
        count = int(state.count)
        grads = {k: torch.full_like(t, 1e-3) for k, t in state.master.items()}
        grads["embedding.word_embeddings.weight"][7, 7] = float("inf")
        state, inf = opt.step_and_probe(state, grads)
        frozen = bool(inf) and int(state.count) == count and all(
            torch.equal(getattr(state, n)[k], t)
            for n, d in before.items() for k, t in d.items())
        log(f"  injected inf gradient on the card: found_inf {bool(inf)}, "
            f"masters, moments and count "
            f"{'bit-frozen' if frozen else 'CHANGED'}")
        check(frozen, "the overflow step changed the state")
    (lc, fc), (lp, fp) = runs[CARD], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    log(f"  losses cuda {lc}, cpu {lp}: max relative difference {rel:.3e} "
        f"(rtol {PARITY_LOSS_RTOL:g}); found_inf cuda {fc}, cpu {fp}")
    check(all(math.isfinite(x) for x in lc + lp), "nonfinite parity loss")
    check(rel <= PARITY_LOSS_RTOL, f"BERT train losses differ by {rel:.3e}")
    check(fc == fp, f"found_inf differs: cuda {fc}, cpu {fp}")
    return dict(losses_cuda=lc, losses_cpu=lp, max_rel_diff=rel,
                found_inf_cuda=fc, found_inf_cpu=fp, inf_step_frozen=True)


def run_bert_train_masked_parity_phase():
    """Masked BERT train parity: the parity config (2 layers, S 128, B 2,
    fp32, TF32 off, dropout 0) with a padding mask of two lengths, three
    LAMB steps on the card (the unpacked kernels) against the CPU (their
    plain versions)."""
    from rocm_apex_tpu_torch.models.bert import BertConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BertConfig(**{**BERT, "num_layers": BERT_PARITY["num_layers"],
                        "max_position_embeddings": BERT_PARITY["seq"]},
                     params_dtype=torch.float32, dtype=torch.float32)
    tokens, labels = _bert_batch(cfg, BERT_PARITY["batch"],
                                 BERT_PARITY["seq"])
    mask = padding_mask(BERT_MASKED_PARITY_LENGTHS, BERT_PARITY["seq"])
    runs = {}
    for dev in (CARD, "cpu"):
        step, state, _, _ = _bert_trainer(cfg, dev, torch.float32)
        losses, found = [], []
        for _ in range(BERT_PARITY["steps"]):
            state, loss, inf = step(state, tokens, labels,
                                    attention_mask=mask)
            losses.append(float(loss))
            found.append(bool(inf))
        runs[dev] = (losses, found)
    (lc, fc), (lp, fp) = runs[CARD], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    log(f"  lengths {BERT_MASKED_PARITY_LENGTHS}: losses cuda {lc}, cpu {lp}"
        f": max relative difference {rel:.3e} (rtol {PARITY_LOSS_RTOL:g}); "
        f"found_inf cuda {fc}, cpu {fp}")
    check(all(math.isfinite(x) for x in lc + lp), "nonfinite parity loss")
    check(rel <= PARITY_LOSS_RTOL, f"masked BERT losses differ by {rel:.3e}")
    check(fc == fp, f"found_inf differs: cuda {fc}, cpu {fp}")
    return dict(lengths=list(BERT_MASKED_PARITY_LENGTHS), losses_cuda=lc,
                losses_cpu=lp, max_rel_diff=rel, found_inf_cuda=fc,
                found_inf_cpu=fp)


def bert_masked_calls(layers, steps):
    """Wrapper calls of ``steps`` masked BERT steps with hidden and
    attention dropout: one unpacked attention a layer (no packed one, no
    dbias: the padding bias is a constant); layer 0's plain ln1 and the
    LM head's LN, and 2 * layers dropout LNs (the ln2s, the chained ln1s,
    the final LN); one cross-entropy and one LAMB call a stage."""
    return {
        "flash_unpacked_fwd": layers * steps,
        "flash_unpacked_bwd": layers * steps,
        "flash_dbias": 0,
        "flash_attention_qkv_fwd": 0,
        "flash_attention_qkv_bwd": 0,
        "layer_norm_fwd": 2 * steps,
        "layer_norm_fwd_dropout": 2 * layers * steps,
        "layer_norm_bwd": (2 * layers + 2) * steps,
        "xent_fwd_dg": steps,
        "lamb_leaf_stage1": steps,
        "lamb_leaf_stage2": steps,
    }


def bert_calls(layers, leaves, steps, evals):
    """Wrapper calls of ``steps`` training steps and ``evals`` no-grad
    forwards of the chained stack at ``layers`` layers without dropout:
    one attention a layer; 2 * layers + 1 LayerNorms in the stack (layer
    0's plain ln1, the ln2s, the chained ln1s, the final LN) and the LM
    head's; one cross-entropy, differentiated in training and plain in
    evaluation; the LAMB pair once a step, over all ``leaves`` kernel
    leaves (inside a call, for each 32 leaves, stage 1 launches two
    kernels and stage 2 one)."""
    ln = 2 * layers + 2
    return {
        "flash_attention_qkv_fwd": layers * (steps + evals),
        "flash_attention_qkv_bwd": layers * steps,
        "layer_norm_fwd": ln * (steps + evals),
        "layer_norm_fwd_dropout": 0,
        "layer_norm_bwd": ln * steps,
        "xent_fwd_dg": steps,
        "xent_fwd": evals,
        "lamb_leaf_stage1": steps if leaves else 0,
        "lamb_leaf_stage2": steps if leaves else 0,
    }


def bert_host_breakdown(model, opt, state, tokens, labels, steps=5):
    """Host milliseconds a BERT step spends enqueueing each part, on an
    idle device: the step's parts are run as `make_bert_train_step` runs
    them, with the host clock read between them and the device drained
    before each step, so no part waits on a full queue. ``drain`` is the
    wait for the device after the last enqueue: near zero when the host
    is the limit."""
    named = dict(model.named_parameters())
    parts = dict(forward=0.0, backward=0.0, optimizer=0.0, drain=0.0)
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.model_params(state, model)
        for p in named.values():
            p.grad = None
        losses, _ = model(tokens, lm_labels=labels)
        loss = losses.mean()
        t1 = time.perf_counter()
        loss.backward()
        t2 = time.perf_counter()
        state, _ = opt.step_and_probe(
            state, {k: named[k].grad for k in state.master})
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for name, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[name] += 1e3 * dt / steps
    log(f"  host enqueue ms a step on an idle device: "
        f"{ {k: round(v, 2) for k, v in parts.items()} }")
    return parts


def run_bert_train_masked_phase(profile):
    """The BERT-Large step with a padding mask: `bert_lengths` over B 8 x
    S 512 and dropout 0.1 (hidden and attention), otherwise the
    bert_train phase's config; 5 warm-up and 20 timed steps."""
    from rocm_apex_tpu_torch.models.bert import BertConfig
    from rocm_apex_tpu_torch.ops._build import KERNELS

    cfg = BertConfig(**{**BERT, "hidden_dropout": BERT_MASKED_DROPOUT,
                        "attention_dropout": BERT_MASKED_DROPOUT},
                     params_dtype=torch.float32, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    step, state, model, opt = _bert_trainer(cfg, "cuda", torch.bfloat16)
    setup_s = time.perf_counter() - t0
    tokens, labels = _bert_batch(cfg, BERT_BATCH, BERT_SEQ)
    tokens, labels = tokens.cuda(), labels.cuda()
    lens = bert_lengths(BERT_BATCH)
    mask = padding_mask(lens, BERT_SEQ).cuda()
    gen = torch.Generator().manual_seed(0)  # CPU: the dropout seeds

    def run():
        return step(state, tokens, labels, attention_mask=mask,
                    dropout_generator=gen)

    losses, found = [], []
    for _ in range(TRAIN_WARMUP):
        state, loss, inf = run()
        losses.append(loss)
        found.append(inf)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, loss, inf = run()
        losses.append(loss)
        found.append(inf)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    losses = [float(x) for x in losses]
    skipped = sum(bool(x) for x in found)
    want = bert_masked_calls(cfg.num_layers, TRAIN_STEPS)
    res = dict(
        batch=BERT_BATCH, seq=BERT_SEQ, steps=TRAIN_STEPS, seconds=dt,
        lengths=[int(x) for x in lens], real_tokens=int(lens.sum()),
        dropout=BERT_MASKED_DROPOUT, step_ms=1e3 * dt / TRAIN_STEPS,
        tokens_per_s=BERT_BATCH * BERT_SEQ * TRAIN_STEPS / dt,
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        skipped_steps=skipped, setup_s=setup_s,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, expected_launches=want,
    )
    log(f"  lengths {res['lengths']} ({res['real_tokens']} real tokens); "
        f"{TRAIN_STEPS} steps of B {BERT_BATCH} x S {BERT_SEQ}, dropout "
        f"{BERT_MASKED_DROPOUT}: {res['step_ms']:.2f} ms/step, "
        f"{res['tokens_per_s']:.1f} tokens/s (padded positions counted); "
        f"loss {losses[0]:.4f} (first) -> {losses[-1]:.4f} (last); "
        f"{skipped} skipped steps; peak {res['peak_mem_gib']:.2f} GiB")
    log(f"  launches in the timed steps: "
        f"{ {k: launches[k] for k in want} } (expected {want})")
    check(all(math.isfinite(x) for x in losses), "nonfinite BERT loss")
    check(losses[-1] < losses[0], "the masked BERT loss did not fall")
    check(skipped == 0, f"{skipped} masked BERT steps were skipped")
    for name, n in want.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches in "
              f"{TRAIN_STEPS} masked steps, expected {n}")
    if profile:
        res["profile"] = profile_window(
            lambda: [run() for _ in range(3)], "3 masked BERT train steps")
    return res


def run_bert_train_phase(profile):
    from rocm_apex_tpu_torch.models.bert import BertConfig
    from rocm_apex_tpu_torch.ops._build import KERNELS
    from rocm_apex_tpu_torch.optimizers.mixed import takes_leaf_kernels

    cfg = BertConfig(**BERT, params_dtype=torch.float32,
                     dtype=torch.bfloat16)
    t0 = time.perf_counter()
    step, state, model, opt = _bert_trainer(cfg, "cuda", torch.bfloat16)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.master.values())
    leaves = sum(takes_leaf_kernels(p) for p in state.master.values())
    tokens, labels = _bert_batch(cfg, BERT_BATCH, BERT_SEQ)
    tokens, labels = tokens.cuda(), labels.cuda()
    losses, found = [], []
    for _ in range(TRAIN_WARMUP):
        state, loss, inf = step(state, tokens, labels)
        losses.append(loss)
        found.append(inf)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, loss, inf = step(state, tokens, labels)
        losses.append(loss)
        found.append(inf)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # one evaluation forward on the trained weights, no gradient asked:
    # the cross-entropy's plain form
    opt.model_params(state, model)
    with torch.no_grad():
        eval_losses, binary = model(tokens, lm_labels=labels)
    eval_loss = float(eval_losses.mean())
    launches = {k.name: k.launches for k in KERNELS}
    losses = [float(x) for x in losses]
    skipped = sum(bool(x) for x in found)
    want = bert_calls(cfg.num_layers, leaves, TRAIN_STEPS, 1)
    res = dict(
        batch=BERT_BATCH, seq=BERT_SEQ, steps=TRAIN_STEPS, seconds=dt,
        params=n_params, lamb_kernel_leaves=leaves,
        step_ms=1e3 * dt / TRAIN_STEPS,
        tokens_per_s=BERT_BATCH * BERT_SEQ * TRAIN_STEPS / dt,
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        eval_loss=eval_loss, skipped_steps=skipped, setup_s=setup_s,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, expected_launches=want,
    )
    log(f"  {n_params / 1e6:.1f}M parameters, {leaves} leaves on the LAMB "
        f"kernel pair; {TRAIN_STEPS} steps of B {BERT_BATCH} x S "
        f"{BERT_SEQ}: {res['step_ms']:.2f} ms/step, "
        f"{res['tokens_per_s']:.1f} tokens/s; loss {losses[0]:.4f} (first) "
        f"-> {losses[-1]:.4f} (last), evaluation {eval_loss:.4f}; "
        f"{skipped} skipped steps; peak {res['peak_mem_gib']:.2f} GiB")
    log(f"  launches in the timed steps and the evaluation: "
        f"{ {k: launches[k] for k in want} } (expected {want})")
    check(all(math.isfinite(x) for x in losses + [eval_loss]),
          "nonfinite BERT loss")
    check(losses[-1] < losses[0], "the BERT training loss did not fall")
    check(eval_loss < losses[0], "the evaluation loss is not below the "
          "first training loss")
    check(skipped == 0, f"{skipped} BERT steps were skipped")
    check(binary.shape == (BERT_BATCH, 2) and bool(
        torch.isfinite(binary).all()), "bad binary logits")
    for name, n in want.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches in "
              f"{TRAIN_STEPS} steps and one evaluation, expected {n}")
    if profile:
        res["profile"] = profile_window(
            lambda: [step(state, tokens, labels) for _ in range(3)],
            "3 BERT train steps")
        res["host_ms"] = bert_host_breakdown(model, opt, state, tokens,
                                             labels)
    return res


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phases 11 and 12: contrib/fmha and contrib/xentropy
# ---------------------------------------------------------------------------


def _fmha_grad(fmha, x, cu, max_s, packed, causal=True):
    """o and dqkv of the loss sum(fmha(x).float() ** 2)."""
    xg = x.detach().requires_grad_(True)
    o = fmha(xg, cu, max_s, causal=causal, packed=packed)
    g, = torch.autograd.grad((o.float() ** 2).sum(), xg)
    return o.detach(), g


def run_fmha_phase():
    """bench.py's fmha configuration at full size: the loss
    sum(fmha(qkv, cu, max_s, causal=True, packed=...).float() ** 2),
    forward + backward, 5 warm-up and 20 timed iterations, packed and
    padded; per path the ms, the peak device memory above the inputs and
    the kernels' launches; padded / packed (bench.py's vs_baseline);
    packed == padded on the card in values and dqkv; and fp32 cuda ==
    cpu (values and dqkv) on a small ragged batch with empty
    sequences."""
    from rocm_apex_tpu_torch.contrib.fmha import fmha
    from rocm_apex_tpu_torch.ops._build import KERNELS

    dev = torch.device(CARD, 0) if CARD == "cuda" else torch.device(CARD)
    lens = fmha_lengths()
    cu, max_s = _cu(lens, dev), max(lens)
    total = int(sum(lens))
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = (0.5 * torch.randn(total, 3, FMHA_HEADS, FMHA_HD, device=dev,
                             generator=gen)).to(torch.bfloat16)
    res = dict(batch=len(lens), total=total, max_s=max_s,
               padded_tokens=len(lens) * max_s, heads=FMHA_HEADS,
               head_dim=FMHA_HD, qkv_bytes=nbytes(qkv))
    outs = {}
    for name, packed in (("packed", True), ("padded", False)):
        def it(packed=packed):
            return _fmha_grad(fmha, qkv, cu, max_s, packed)

        for _ in range(TRAIN_WARMUP):
            it()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs[name] = it()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del outs[name]
        for k in KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            out = it()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        outs[name] = out
        res[name] = dict(
            ms=1e3 * dt / TRAIN_STEPS, peak_extra_bytes=peak,
            launches={k.name: k.launches for k in KERNELS if k.launches})
        log(f"  {name}: {res[name]['ms']:.3f} ms forward + backward; peak "
            f"{peak / 2**20:.1f} MiB above the inputs; launches in "
            f"{TRAIN_STEPS} iterations {res[name]['launches']}")
    res["padded_over_packed"] = res["padded"]["ms"] / res["packed"]["ms"]
    res["launches"] = res["packed"]["launches"]
    log(f"  padded / packed = {res['padded_over_packed']:.3f} (bench.py's "
        f"vs_baseline); qkv {res['qkv_bytes'] / 2**20:.1f} MiB")
    cmp = compare(outs["packed"], outs["padded"])
    res["packed_vs_padded"] = cmp
    log(f"  packed vs padded on the card: max|err| {cmp['err']:.3e}, worst "
        f"err/tol {cmp['ratio']:.3f}")
    check(cmp["ratio"] <= 1.0, f"fmha packed and padded differ by "
          f"{cmp['ratio']:.3g}x the tolerance")
    for path, want in (("packed", {"flash_segments_fwd": 1,
                                   "flash_segments_bwd": 1,
                                   "flash_attention_segments_with_lse": 0}),
                       ("padded", {"flash_unpacked_fwd": 1,
                                   "flash_unpacked_bwd": 1,
                                   "flash_segments_fwd": 0,
                                   "flash_segments_bwd": 0})):
        got = res[path]["launches"]
        for name, n in want.items():
            check(got.get(name, 0) == n * TRAIN_STEPS,
                  f"fmha {path}: {got.get(name, 0)} launches of {name} in "
                  f"{TRAIN_STEPS} iterations, expected {n} per iteration")
    peak = res["packed"]["peak_extra_bytes"]
    check(peak < 10 * res["qkv_bytes"], f"the packed fwd + bwd took {peak} "
          f"bytes above its inputs, over 10x the qkv's")
    check(peak < res["padded"]["peak_extra_bytes"],
          "the packed path took more memory than the padded one")

    # fp32 cuda vs cpu, both paths, on a small ragged batch
    g = torch.Generator().manual_seed(1)
    lens = FMHA_PARITY_LENS
    x = torch.randn(sum(lens), 3, 4, 64, generator=g)
    res["parity"] = {}
    for packed in (True, False):
        got = _fmha_grad(fmha, x.to(dev), _cu(lens, dev), max(lens), packed)
        ref = _fmha_grad(fmha, x, _cu(lens, DEV_CPU), max(lens), packed)
        cmp = compare([t.cpu() for t in got], ref)
        res["parity"]["packed" if packed else "padded"] = cmp
        log(f"  fp32 cuda vs cpu, lengths {lens}, "
            f"{'packed' if packed else 'padded'}: max|err| {cmp['err']:.3e}, "
            f"worst err/tol {cmp['ratio']:.3f}")
        check(cmp["ratio"] <= 1.0, "fmha fp32: the card differs from the "
              "CPU's plain versions")
    return res


def run_xentropy_phase():
    """contrib/xentropy's `SoftmaxCrossEntropyLoss.apply` at the BERT
    head's logits ((4096, 30592) bf16, smoothing 0.1, padding_idx 0 on
    one row in seven), forward + backward of the mean over live rows: 5
    warm-up and 20 timed iterations, the launches (one plain forward and
    one backward an iteration, no dg form), zero gradient on padded rows;
    then fp32 cuda == cpu and == F.cross_entropy with ignore_index on a
    small batch."""
    from rocm_apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss
    from rocm_apex_tpu_torch.ops._build import KERNELS

    dev = torch.device(CARD, 0) if CARD == "cuda" else torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(15)
    rows, vocab = BERT_BATCH * BERT_SEQ, BERT["vocab_size"]
    x = (2.0 * torch.randn(rows, vocab, device=dev, generator=gen)).to(
        torch.bfloat16)
    labels = torch.randint(0, vocab, (rows,), device=dev, generator=gen)
    labels[::7] = XENT_PAD
    live = int((labels != XENT_PAD).sum())

    def it():
        xg = x.detach().requires_grad_(True)
        loss = SoftmaxCrossEntropyLoss.apply(xg, labels, XENT_SMOOTHING,
                                             XENT_PAD).sum() / live
        g, = torch.autograd.grad(loss, xg)
        return loss.detach(), g

    for _ in range(TRAIN_WARMUP):
        it()
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        loss, g = it()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    res = dict(rows=rows, vocab=vocab, smoothing=XENT_SMOOTHING,
               padded_rows=rows - live, ms=1e3 * dt / TRAIN_STEPS,
               loss=float(loss), launches=launches)
    log(f"  ({rows}, {vocab}) bf16: {res['ms']:.3f} ms forward + backward, "
        f"loss {res['loss']:.4f}; launches in {TRAIN_STEPS} iterations "
        f"{launches}")
    check(math.isfinite(res["loss"]), "nonfinite xentropy loss")
    check(bool((g[labels == XENT_PAD] == 0).all()),
          "a padded row has a nonzero gradient")
    for name, n in (("xent_fwd", 1), ("xent_bwd", 1), ("xent_fwd_dg", 0)):
        check(launches.get(name, 0) == n * TRAIN_STEPS,
              f"xentropy: {launches.get(name, 0)} launches of {name} in "
              f"{TRAIN_STEPS} iterations, expected {n} per iteration")

    g = torch.Generator().manual_seed(2)
    xs = 3.0 * torch.randn(64, 1001, generator=g)
    ls = torch.randint(0, 1001, (64,), generator=g)
    ls[::5] = XENT_PAD
    w = torch.randn(64, generator=g)
    outs = []
    for d in (dev, DEV_CPU):
        xg = xs.to(d).detach().requires_grad_(True)
        loss = SoftmaxCrossEntropyLoss.apply(xg, ls.to(d), XENT_SMOOTHING,
                                             XENT_PAD)
        (loss * w.to(d)).sum().backward()
        outs.append((loss.detach().cpu(), xg.grad.cpu()))
    ref = F.cross_entropy(xs, ls, reduction="none",
                          label_smoothing=XENT_SMOOTHING,
                          ignore_index=XENT_PAD)
    cmp = compare(outs[0], outs[1])
    cmp_lib = compare((outs[0][0],), (ref,))
    res["parity"] = dict(cpu=cmp, f_cross_entropy=cmp_lib)
    log(f"  fp32 (64, 1001) cuda vs cpu: max|err| {cmp['err']:.3e}; losses "
        f"vs F.cross_entropy: max|err| {cmp_lib['err']:.3e}")
    check(cmp["ratio"] <= 1.0 and cmp_lib["ratio"] <= 1.0,
          "xentropy fp32: the card differs from the CPU or F.cross_entropy")
    return res


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    ap.add_argument("--profile", action="store_true",
                    help="add profiled serve and train windows (device "
                         "busy share)")
    ap.add_argument("--only", help="comma-separated subset of the phases "
                    f"{','.join(PHASES)} (default: all); kernels:A+B runs "
                    f"the kernel phase's case groups A and B of "
                    f"{','.join(CASE_GROUPS)}")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    try:
        from rocm_apex_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              f"root of a checkout", file=sys.stderr)
        return 2

    report = {}
    log("== device")
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    report["nvidia_smi"] = smi

    log("== build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"  {len(libs)} libraries in {report['build_s']:.1f} s")
    report["ptxas"] = {}
    for src, text in _build.build_logs().items():
        # pair each entry function (mangled name up to its template
        # arguments) with its register and spill lines
        fn = None
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1].split("EEv")[0]
            elif fn and ("registers" in ln or "spill" in ln):
                report["ptxas"].setdefault(f"{src} {fn}", []).append(
                    ln.split(":", 1)[-1].strip())
    for fn, lines in report["ptxas"].items():
        log(f"  {fn}: {'; '.join(lines)}")

    dev = torch.device("cuda", 0)
    only = dict(e.partition(":")[::2] for e in (
        PHASES if args.only is None else args.only.split(",")))
    unknown = set(only) - set(PHASES)
    check(not unknown, f"--only: no phase named {sorted(unknown)}")
    phases = list(only)
    from rocm_apex_tpu_torch.ops import (flash_attention,  # noqa: F401
                                         flash_attention_segments,
                                         layer_norm, optim_kernels, xentropy)
    groups = (only["kernels"].split("+") if only.get("kernels")
              else list(CASE_GROUPS))
    runs = {
        "kernels": ("kernels (kernel vs plain version on the card)",
                    lambda: run_kernel_phase(
                        dev, [CASE_GROUPS[g] for g in groups])),
        "parity": ("parity (2 layers, fp32, TF32 off: cuda kernels vs cpu "
                   "plain)", run_parity_phase),
        "serve": ("serve (8 layers, bf16, 32 requests x 64 tokens)",
                  lambda: run_serve_phase(args.profile)),
        "serve_paged": (f"serve_paged (the serve on pages of {PAGE_SIZE}: "
                        "bf16, int8, shared prefix)",
                        lambda: run_serve_paged_phase(
                            args.profile,
                            report.get("serve", {}).get("tokens"))),
        "serve_whole": ("serve_whole (the serve on the whole-prompt path: a "
                        f"padded (1, {max(PROMPT_LENS)}) prefill per admit)",
                        lambda: run_serve_whole_phase(
                            args.profile,
                            report.get("serve", {}).get("tokens"))),
        "train_parity": ("train parity (2 layers, S 256, B 2, fp32, TF32 "
                         "off: 3 steps cuda vs cpu)", run_train_parity_phase),
        "train": (f"train (8 layers, bf16, B {TRAIN_BATCH} x S {TRAIN_SEQ}, "
                  f"dropout 0.1: {TRAIN_WARMUP} warm-up + {TRAIN_STEPS} "
                  f"timed steps)", lambda: run_train_phase(args.profile)),
        "bert_train_parity": (
            "bert train parity (2 layers, S 128, B 2, fp32, TF32 off: 3 "
            "LAMB steps cuda vs cpu, then an inf gradient)",
            run_bert_train_parity_phase),
        "bert_train": (
            f"bert train (24 layers, bf16, B {BERT_BATCH} x S {BERT_SEQ}, "
            f"LAMB with bf16 moments: {TRAIN_WARMUP} warm-up + "
            f"{TRAIN_STEPS} timed steps, one evaluation)",
            lambda: run_bert_train_phase(args.profile)),
        "bert_train_masked_parity": (
            "bert train masked parity (2 layers, S 128, B 2, fp32, TF32 off, "
            f"lengths {BERT_MASKED_PARITY_LENGTHS}: 3 LAMB steps cuda vs cpu)",
            run_bert_train_masked_parity_phase),
        "bert_train_masked": (
            f"bert train masked (24 layers, bf16, B {BERT_BATCH} x S "
            f"{BERT_SEQ}, padding mask, dropout {BERT_MASKED_DROPOUT}: "
            f"{TRAIN_WARMUP} warm-up + {TRAIN_STEPS} timed steps)",
            lambda: run_bert_train_masked_phase(args.profile)),
        "fmha": (
            f"fmha (bench.py's fmha batch: {FMHA_BATCH} sequences, "
            f"{FMHA_HEADS} heads x {FMHA_HD}, causal, bf16; fwd + bwd of "
            f"sum(o^2), packed and padded: {TRAIN_WARMUP} warm-up + "
            f"{TRAIN_STEPS} timed)", run_fmha_phase),
        "xentropy": (
            f"xentropy (SoftmaxCrossEntropyLoss at ({BERT_BATCH * BERT_SEQ}, "
            f"{BERT['vocab_size']}) bf16, smoothing {XENT_SMOOTHING}, "
            f"padding_idx {XENT_PAD}: {TRAIN_WARMUP} warm-up + {TRAIN_STEPS} "
            f"timed)", run_xentropy_phase),
    }
    report["phase_s"] = {}
    for phase in PHASES:
        if phase not in phases:
            continue
        title, run = runs[phase]
        log(f"== {title}")
        t0 = time.perf_counter()
        report["kernel_cases" if phase == "kernels" else phase] = run()
        report["phase_s"][phase] = time.perf_counter() - t0
        log(f"  ({report['phase_s'][phase]:.1f} s)")

    # one line per kernel: its headline case (the bf16 case its path
    # launches most), every case in the --out file, and its launches in
    # the run of its path (the serve for the serving kernels, the paged
    # serve's three timed runs for the paged decode read, the timed train
    # steps for the GPT training ones, the BERT steps and evaluation for
    # the cross-entropy and the LAMB pair, whose count is of wrapper
    # calls: a call of stage 1 launches 2 * ceil(leaves / 32) kernels, of
    # stage 2 ceil(leaves / 32); the plain LN forward runs on
    # all and reports the serve, whose shape heads it). In the serve
    # every forward runs 9 plain and 8 residual LNs and every tick a
    # decode-grid forward (8 rows), so the plain (8, 1024) LN and the
    # decode grid lead; in training the dropout forms lead.
    kernels = []
    for k in _build.KERNELS:
        c = next((c for c in report.get("kernel_cases", [])
                  if c["kernel"] == k.name and c["headline"]), {})
        path = "train" if k.name in TRAIN_CALLS_PER_STEP and (
            k.name != "layer_norm_fwd") else "serve"
        if k.name in PAGED_KERNELS:
            path = "serve_paged"
        if k.name in BERT_KERNELS:
            path = "bert_train"
        if k.name in UNPACKED_KERNELS:
            path = "bert_train_masked"
        if k.name in FMHA_KERNELS:
            path = "fmha"
        if k.name == "xent_bwd":
            path = "xentropy"
        where, _, _ = k.replaces.partition(" ")
        kernels.append(dict(
            name=k.name, route="cuda",
            source=f"rocm_apex_tpu_torch/csrc/{k.source}",
            replaces=where,
            launches=report.get(path, {}).get("launches", {}).get(k.name),
            max_abs_err=c.get("max_abs_err"), ms=c.get("ms"),
            plain_ms=c.get("plain_ms"), bound_ms=c.get("bound_ms"),
            bound_by=c.get("bound_by"), library_ms=c.get("library_ms"),
            library_fp32_ms=c.get("library_fp32_ms"),
            library=c.get("library"), case=c.get("case"), path=path,
        ))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
