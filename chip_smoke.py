#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--profile] [--only PHASES]

Drives ``rocm_apex_tpu_torch`` only (it imports nothing of JAX or of the
JAX package) through these phases, in order; any failure exits non-zero:

1. device    the card's name and power limit, as nvidia-smi reports them;
2. build     every kernel of ``rocm_apex_tpu_torch/csrc`` with nvcc
             (one process per source, started together);
3. kernels   each kernel's wrapper on card tensors at the shapes of the
             serve and of the training step, in bf16 and fp32, then
             in fp16 at each row's main path shape (`FP16_CASES`) and
             in the head dims' forms (`HD_CASES`), held
             against its plain PyTorch version on the same inputs
             (dropout cases included: both draw the same keep bits; the
             paged decode read at page sizes 16 and 64 over bf16, fp32
             and int8 pools, with prefixes ending mid-page and a dead row
             whose bound reaches unmapped table entries; the contiguous
             and the paged decode read bit-equal on the same keys, also
             at a capacity the page size does not divide; the unpacked
             flash forward, backward and dbias at the masked BERT-Large,
             whole-prompt, ragged and varlen shapes (dbias on its
             `flash_dbias_plan` route, launched twice for the same bits),
             and the unpacked kernels equal to the packed ones on a
             projection's views; the serving segment read at the serve's
             chunk on its `flash_segments_serve_plan` route (the tile
             kernel in bf16, the warp-a-row kernel in fp32), launched
             twice for the same bits, beside the pipe route's kernels;
             the training segment attention forward and backward at
             bench.py's fmha batch, causal and not, at masked BERT-Large
             lengths with head_dim 128, in fp32 and with ids out of
             order, each on its `flash_segments_plan` route (the pipes
             and their segment pre-passes in bf16, launched twice for the
             same bits, the tables the pre-passes wrote read back and held
             to their plain version; the CUDA cores in fp32); the
             cross-entropy's two-pass backward; the scaled
             causal and masked softmax forwards and the softmax backward
             at the GPT train cell's and masked BERT-Large's scores, in
             bf16 and fp16 too, at odd, tiny and 16K-key rows, under
             every mask broadcast and with sq != sk; the ten packed-buffer
             kernels, multi-tensor passes and optimizer updates, at the
             train cell's packed buffer and on a ragged tree, with the
             nonfinite flag, Adam's skip slot and the padding's zeros; the
             fused bottleneck's four conv+BN kernels, every call of a
             fused block with its flags, at ResNet-50's five stride-1
             block shapes at B 128 and at a ragged M, W 2, fp32 and (the
             1x1 backward, the 3x3 forward) widths the pipelined products
             do not take, beside the whole block fused and unfused; every
             1x1 and 3x3 backward case and every pipelined 3x3 forward
             case launched twice and held bit-equal; the flash forwards,
             the packed backward and the 3x3 forward checked against
             their plans' routes by the kernels a call launches (the launch tables));
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
             the requests whose tokens match the contiguous serve's (all
             32 for the bf16 pages, or the phase fails);
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
13. fused_softmax_parity  the fused-softmax attention path
             (attention_impl="fused_softmax"): the GPT train parity and
             the masked BERT parity configs under it, fp32 with TF32 off,
             three steps each on the card against the CPU (losses within
             the same tolerance, the same skips); the card runs the
             softmax kernels a forward and a backward a layer and step
             and no flash kernel;
14. train_fused_softmax  the train phase's GPT step under that path:
             tokens/s, step ms, losses, peak memory; the causal softmax
             forward and the backward 8 calls a step each, no flash call;
15. bert_train_masked_fused_softmax  the masked BERT-Large step under
             that path: the masked softmax forward and the backward 24
             calls a step each, no flash call;
16. train_packed_parity  `PackedOptimizerStep` on the train parity
             config: Adam and LAMB, three steps on the card against the
             CPU (losses, skips, masters), then an inf gradient (found and
             bit-frozen on both); the packed ops outside the step
             (`unscale_packed`, `multi_tensor_applier`'s axpby and l2norm,
             the SGD, Adagrad and NovoGrad updates) card against CPU;
17. train_packed  the train phase's GPT step under
             `PackedOptimizerStep("adam")` (bench.py gpt --packed-update):
             tokens/s, step ms beside the train phase's, losses, peak
             memory, one scale_sumsq and one adam_update call a step; the
             bare update phase on fixed gradients, `MixedPrecisionAdam`
             and `PackedOptimizerStep` in turns;
18. rn50_parity  the fused ResNet-50 step (bench.py rn50's widths, B
             2 x 64 x 64, fp32, TF32 off, O0 with fp32 masters and a
             dynamic scaler): the first step's gradients and three steps
             on the card against the same on the CPU (see RN50_PARITY);
19. rn50_train  bench.py rn50's step on an accelerator: ResNet-50, B 128
             x 224 x 224, bf16 under amp O5, FusedAdam(1e-3, weight_decay
             1e-4), every conv on F.conv2d: 5 warm-up and 20 timed steps;
             images/s, step ms, losses, peak memory;
20. rn50_train_fused  the same with --fused=1: the 13 stride-1 blocks on
             the bottleneck kernels (27, 13, 27, 13 wrapper calls a step),
             the ratio to rn50_train's step in the same call;
21. mha      contrib/multihead_attn at Transformer-big's widths (16
             heads of 64, bf16 with fp32 parameters): self attention
             over B 8 x 512 with BERT-style key padding, encoder-decoder
             attention of 8 x 256 queries over 8 x 512 keys; with and
             without norm_add, under the key padding and under an
             attention mask alone; eval and (dropout 0) training forward
             + backward against the same modules on the plain versions,
             one unpacked forward and backward a call (rows 7b, 9b); the
             dropout branch at 0.1 (no flash launch, its formula, the
             kept share, a fully padded row); then the normalization API
             (the non-affine backward among its launches);
22. context_parallel  four spawned ranks of a gloo group on the one
             card: ring and Ulysses attention (B 2 x 8 heads of 128, a
             4096-token sequence, bf16, causal and not), forward and
             q/k/v gradients against unsharded attention on the card;
             the GPT at the train widths on B 2 x 4096 (fp32): logits and
             rank-summed gradients against the unsharded model, one step
             at hidden dropout 0.1 with a different mask a rank;
23. serve_jnp  attention_impl="jnp": card == CPU greedy tokens at 2
             layers (contiguous, paged, int8 pages, whole-prompt), then
             the serve at 8 layers bf16 in the four forms, no attention
             kernel launched, the requests matching the flash serve;
24. optim_amp  the rest of the optimizers and amp: FusedSGD (plain,
             momentum with dampening, nesterov, wd_after_momentum),
             FusedAdagrad (both modes), FusedNovoGrad (norms 2 and 0,
             reg_inside_moment on and off), FusedLAMB (tree and packed),
             FusedMixedPrecisionLamb (a found_inf step bit-frozen), the
             contrib FusedAdam, FP16_Optimizer (an overflow) and the
             transformer GradScaler (no axis bound): three steps on the
             card against the CPU on BERT-Large's leaves at 2 layers;
             bert_pretrain.py's recipe at bench.py bert's shape (tree and
             packed FusedLAMB with the no-decay mask; the packed LAMB
             pair's launches counted, the first losses equal, the
             packed masters after step 1 held to the tree's; each step's
             device time) beside bert_train's step; imagenet_train.py's FusedSGD on the fused
             ResNet-50 under O5 beside rn50_train_fused's step; the GPT at
             the train widths under O4 (fp32 params and gradients, the
             loss in `amp.policy_function`, the train phase's kernel
             calls a step); O1 on a decorated matmul and softmax;
25. head_dims  every head dim up to 256 on the flash kernels: GPT-J-6B's
             attention shape (hidden 4096, 16 heads of 256, ffn 16384,
             vocab 50400, the packed branch), GPT-3 2.7B's (hidden 2560,
             32 heads of 80: the unpacked kernels at width 128 with zero
             columns) and the JAX recipes' GPT and masked BERT (hidden
             256, 8 heads of 32 at width 64), each at 2 or 4 layers: three
             O5 train steps (MixedPrecisionAdam, dropout 0.1 on the wide
             ones; the BERT under MixedPrecisionLamb with a padding
             mask), step ms, peak memory, the flash kernels' launches,
             the losses finite and falling; the wide ones serve 32
             requests contiguous then on pages of 16 (the pages give the
             contiguous tokens in every request); each model's one-layer
             twin in fp32, card against CPU (losses, greedy tokens). The
             kernel groups flash, unpacked, seg_train, seg, decode and
             paged also hold their kernels at hd 32, 80 and 256 (and 96,
             and 20 on the padded route), bf16 and fp32, on their plans'
             routes, beside the bound at the instance's width;
26. fp16     amp O2 in fp16: the GPT train cell (fp16 compute, fp32
             masters, MixedPrecisionAdam under the dynamic loss scaler,
             a warm-up then timed steps that skip none, rows 1, 2, 8, 11
             at the train phase's calls a step) and its 2-layer twin, one
             step on the kernels against one under `plain_versions()` on
             the same card, weights and batch (loss and every gradient),
             and under PackedOptimizerStep (rows 14, 15); the serve cell
             in fp16, contiguous and on fp16 pages (32 of 32 requests
             equal; rows 1, 3, 5, 6); BERT-Large under MixedPrecisionLamb
             unmasked and masked (rows 7b, 8, 9b, 11, 13a, 16); ResNet-50
             with FusedBottleneck under O2 at B 128 x 224^2 (row 17) and
             its B 2 x 64^2 twin against `plain_bottleneck()`;
27. serve_spec  speculative decoding at the serve's width (bench.py
             serve --spec-k=4): 16 periodic prompts x 128 tokens, budget
             40, spec_k 4 against 0 on the contiguous cache, bf16 and
             int8 pages of 16: tokens/s of each in one call, TPOT p95,
             acceptance, drafted/accepted/rolled-back tokens (each > 0
             over the phase), rows 1, 3, 5, 6's launches (row 3 on its
             tile route), the timed serves under `sync_audit` (a device
             sync outside the engine's fetch, input copy and table push
             fails; one fetch a tick), no page left in use, the
             requests whose speculative tokens equal the plain ones
             (counted); the 2-layer fp32 twin card == cpu with and
             without speculation on every layout, speculative == plain on
             the contiguous cache and bf16 pages, an always-wrong drafter
             harmless;
28. serve_chaos  the fault harness (bench.py serve --chaos=0): the
             seeded FaultPlan (device_step, logits, host_fetch p 0.05,
             page_alloc) on the serve's 32 requests x 64 with max_queue
             30 and two retries, a leased request cancelled after two
             ticks, drain; contiguous, bf16 and int8 pages: the
             accounting identity, quarantined == error results, >= 2
             fires, the allocator back to its snapshot, the survivors
             matching the fault-free tokens (counted); the fp32 twin's
             survivors equal on every layout; a page_alloc fault on every
             call raising the watchdog with the stuck slot named and its
             dump written;
29. serve_lora  multi-LoRA serving (the engine with an AdapterPool of 4
             slots at rank 16, 8 seeded adapters of ranks 4-16 in 3
             tiers) on the serve's 32 requests x 64, a quarter on the
             base, contiguous and on bf16 pages, under `sync_audit`:
             rows 1, 3 and the decode read launched; adapter uploads,
             evictions and revivals > 0, stalls counted; the pool back to
             its base slot; the segmented delta against the dense
             per-adapter product; a tier preemption; the fp32 twin card
             == cpu on both layouts, adapter 0 == the plain engine, the
             preempted requests' tokens == an undisturbed run's;
30. serve_router  two replicas of the serve model on the card under
             `sync_audit`: the fleet against the single engine (tokens
             counted), a replica_kill mid-decode (each request delivered
             once, the accounting identity), a kill on bf16 pages (no
             page leaked), the prefill/decode fleet on bf16 and int8
             pages (handoffs shipping pages, each imported page bit-equal
             to its source), a rolling drain and rejoin; every replica
             launches rows 1, 3 and its decode read; the fp32 twin's
             fleets == the single engine == the CPU;
31. serve_tp  tensor-parallel serving at tp=2: rows 1, 3 and 6 first
             held to their plain versions at a rank's bf16 shapes (LN
             on 128 and 8 rows, the segment read and the paged grid and
             piece B on 4 heads, float and int8 pools); then two spawned
             ranks of a gloo group on the one card (the exchanges staged
             through host memory), each with its shard of the serve model sliced
             from the serve's tp=1 checkpoint by `shard_tp1_params`: the
             serve's 32 requests x 16 on bf16 and int8 pages of 16 beside
             the tp=1 paged serve in the same call (tok/s a figure; the
             tp=1 tokens counted): half the KV bytes a rank, rows 1, 3
             and 6 on their plans' routes at the rank's shapes, one fetch
             a tick and the exchanges a step the layout implies under
             `sync_audit`, both ranks the same tokens; a migration with
             full-head pages (each rank's heads its own pool's bits, a
             tp=1 payload's layout); spec_k 4 drafting, accepting and
             rolling back; the fp32 twin tp=2 card == tp=2 cpu == tp=1
             card on both layouts with and without speculation, and a
             tp=2 payload resumed by a tp=1 engine; a `ReplicaRouter`
             over two tp=2 engines on each rank (the serve's requests,
             a drain shipping pages on bf16 pages, a replica_kill on
             int8 pages: both ranks the same tokens, replica states,
             fault log and payload bits), its fp32 twin == the tp=1
             fleet == one tp=2 engine;
32. serve_monitor  the monitor layer's host side on the serve;
33. train_tp  tensor-parallel GPT training at tp=2 (bench.py's
             `--seq-parallel --collective-matmul` step): rows 1, 2, 8
             and 11 held to their plain versions at a rank's bf16
             shapes, then two spawned ranks run the train cell's bf16
             step with sequence parallelism and the rings, with fp32
             and then int8 ring payloads: losses finite and bit-equal on
             both ranks, the kernels' calls a step and routes, no sync
             but the exchanges a step the layout implies, their MiB as
             derived for each comm dtype; the fp32 twin's loss and every
             gradient tp=2 card == tp=2 cpu == tp=1 card in five forms
             (the rings under activation checkpointing among them), and
             with int8 rings tp=2 card == tp=2 cpu;
34. bert_tp  BERT-Large at tp=2 (bench.py's BERT step): rows 1, 2, 7b,
             8, 9b, 11 and 16 held to their plain versions at a rank's
             bf16 shapes, then two spawned ranks run the step unmasked
             and with the masked BERT's padding mask: losses finite and
             bit-equal on both ranks, the kernels' calls a step, no sync
             but the exchanges a step and MiB as derived; the fp32
             twin's loss and every gradient tp=2 card == tp=2 cpu ==
             tp=1 card, unmasked and masked;
35. remat    activation checkpointing (bench.py's ``--remat``): the GPT
             train cell and BERT-Large at B 16, each with and without
             ``checkpoint_activations`` in one process: step ms, peak
             memory (lower with it), the kernels' calls a step (each
             layer's forward twice); the fp32 twins of checkpointing and
             post-LN, GPT and BERT, card == cpu;
36. data_parallel  data parallelism at dp=2 (bench.py's ``--dist-opt``
             step and DDP): rows 14 and 15 at a rank's ZeRO shard and
             rows 1, 2, 8 and 11 at its 8 sequences held to their plain
             versions (twice for the same bits, on their routes); then
             two spawned ranks run the train cell's bf16 step on 8
             sequences each under DistributedFusedAdam at fp32 and int8
             comm and under DDP (`sync_gradients`, MixedPrecisionAdam):
             each rank's own finite losses, the parameters bit-equal on
             both ranks after every step, the exchanges a step and their
             MiB as derived, no other sync, the kernels' calls a step, the
             ZeRO state half the replicated one; the fp32 twins card vs
             cpu (ZeRO Adam, ZeRO LAMB at the fp32, bf16 and e5m2 wires,
             DDP, int8 comm); ResNet-50 under SyncBatchNorm, 64 images a
             rank, bf16 O5 (statistics and params bit-equal on both ranks,
             the exchanges as derived) and its fp32 twin; SpatialBottleneck
             at layer3's widths, H 14 split 7 + 7, against the unsharded
             block;
37. report   a ``{"kernels": [...]}`` line (the data-parallel rank cases
             under ``data_parallel_cases``), then the device line
             ``{"ok": true, "device": {...}}`` as the last line.

``--out DIR`` also writes every number and the compiler's register and
spill report to DIR/chip_smoke.json (what ran, also after a failure). ``--profile`` adds profiled serve
(contiguous and paged) and train (GPT and BERT) windows that report the
device's busy share. ``--only`` runs a subset of the phases (a check of
one part; the full run is the smoke); ``kernels:xent+lamb`` there names a
subset of the kernel phase's case groups (ln, seg, decode, paged,
train_ln, ln_plain, flash, xent, lamb, unpacked, seg_train, softmax,
packed, bottleneck, frames; hd runs the head-dim forms and fp16 every
group's fp16 cases, both also in the default run).

It needs one CUDA device and nvcc (CUDA_HOME, PATH or /usr/local/cuda).
"""

import argparse
import contextlib
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
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}

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
       torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5),
       torch.float16: dict(rtol=2.0 ** -10, atol=1e-5)}
# fp16 holds the same rules in its own precision: one fp16 step is 2^-10
# of the value (10 stored mantissa bits)
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

# the fused-softmax attention path (GPTConfig(attention_impl=
# "fused_softmax")): materialized fp32 scores through the softmax kernels;
# the GPT train cell and masked BERT-Large run under it beside their
# flash phases. No flash kernel runs on the uncached path there.
SOFTMAX_KERNELS = ("softmax_causal_fwd", "softmax_masked_fwd", "softmax_bwd")
FLASH_TRAIN_KERNELS = ("flash_attention_qkv_fwd", "flash_attention_qkv_bwd",
                       "flash_unpacked_fwd", "flash_unpacked_bwd",
                       "flash_dbias")
FUSED_TRAIN_CALLS_PER_STEP = {
    "softmax_causal_fwd": 8,
    "softmax_bwd": 8,
    "softmax_masked_fwd": 0,
    **{k: 0 for k in FLASH_TRAIN_KERNELS},
    **{k: v for k, v in TRAIN_CALLS_PER_STEP.items()
       if not k.startswith("flash")},
}

# the packed optimizer path (`PackedOptimizerStep`, bench.py gpt
# --packed-update): the train cell's step with one scale_sumsq and one
# adam_update call a step (the model is all bf16: one dtype group); the
# parity's masters (fp32, cuda vs cpu) within PACKED_MASTER_RTOL of
# |master| + |step| plus OPTIM_STEP_SHARE of the largest step the CPU
# took on that master's leaf, the optim_amp phase's rule (`_param_err`).
# Adam divides each gradient element by its own scale: where that is
# near eps the two devices' fp32 summation noise moves the step by a
# share of lr (1% of an lr step seen on a layer-0 dense weight after 3
# steps), which the leaf's share covers, where a floor of a share of lr
# let a LAMB trust ratio 1.5x its value pass
PACKED_TRAIN_CALLS_PER_STEP = {**TRAIN_CALLS_PER_STEP, "scale_sumsq": 1,
                               "adam_update": 1, "lamb_stage1": 0,
                               "lamb_stage2": 0, "row_sumsq": 0}
PACKED_MASTER_RTOL = 1e-5

PHASES = ("kernels", "parity", "serve", "serve_paged", "serve_whole",
          "train_parity", "train", "bert_train_parity", "bert_train",
          "bert_train_masked_parity", "bert_train_masked", "fmha",
          "xentropy", "fused_softmax_parity", "train_fused_softmax",
          "bert_train_masked_fused_softmax", "train_packed_parity",
          "train_packed", "rn50_parity", "rn50_train", "rn50_train_fused",
          "mha", "context_parallel", "serve_jnp", "optim_amp", "head_dims",
          "fp16", "serve_spec", "serve_chaos", "serve_lora", "serve_router",
          "serve_tp", "serve_monitor", "train_tp", "bert_tp", "remat",
          "data_parallel")
SERVE_KERNELS = ("layer_norm_fwd", "flash_segments_serve",
                 "flash_attention_decode")
# the paged serve's kernels: the contiguous decode read gives way to the
# paged one, float or int8 by the form's pools
PAGED_SERVE_KERNELS = ("layer_norm_fwd", "flash_segments_serve")
PAGED_KERNELS = ("flash_attention_decode_paged",
                 "flash_attention_decode_paged_int8")

# the head dims the flash kernels take (every one from 1 to 256): public
# models' attention shapes on the repo's GPTModel / BertModel (there is no
# rotary embedding, so each is that model's shape, not the model), at 2
# layers: GPT-J-6B (hd 256, the packed branch, as models/gpt.py routes
# hd % 128 == 0), GPT-3 2.7B / OPT-2.7B (hd 80: the unpacked kernels on
# the width-128 instance with zero columns; OPT-2.7B's vocab) and the JAX
# package's recipes (hidden 256, 8 heads, hd 32 on the width-64 instance:
# examples/gpt_train.py:141 at its 4 layers, S 256, B 4, and
# examples/bert_pretrain.py:39 at its 4 layers, S 128, B 8)
HD_MODELS = {
    "gptj": dict(vocab_size=50400, hidden_size=4096, num_layers=2,
                 num_attention_heads=16, ffn_hidden_size=16384,
                 max_position_embeddings=2048, tensor_parallel_size=1),
    "gpt3_2.7b": dict(vocab_size=50272, hidden_size=2560, num_layers=2,
                      num_attention_heads=32, ffn_hidden_size=10240,
                      max_position_embeddings=2048, tensor_parallel_size=1),
    "recipe_gpt": dict(vocab_size=8192, hidden_size=256, num_layers=4,
                       num_attention_heads=8, max_position_embeddings=256,
                       tensor_parallel_size=1),
    "recipe_bert": dict(vocab_size=8192, hidden_size=256, num_layers=4,
                        num_attention_heads=8, max_position_embeddings=128,
                        tensor_parallel_size=1),
}
# (batch, seq) of each model's train steps: GPT-J and GPT-3 at their 2048
# context, the recipes at their own defaults
HD_TRAIN_SHAPES = {"gptj": (2, 2048), "gpt3_2.7b": (2, 2048),
                   "recipe_gpt": (4, 256), "recipe_bert": (8, 128)}
HD_TRAIN_STEPS = 3
HD_DROPOUT = 0.1
# the engine on the two wide models: 16 requests of 16 new tokens on 8
# slots (prompts of 32 to 256 tokens), contiguous, then on pages of 16
# (8 requests, down from 16, to keep the smoke inside its time limit)
HD_SERVE = dict(requests=8, max_new=16, capacity=1024, budget=256)
# each model's reduced-depth twin, fp32 with TF32 off, card against CPU:
# one layer at the model's widths, B 1 x S 128, three Adam steps (LAMB for
# the BERT) at lr 1e-5 (losses at PARITY_LOSS_RTOL), then greedy tokens of
# 4 requests x 6. At lr 1e-4 the wide twins memorize the batch in two
# steps (GPT-J's 11.81 -> 0.204 -> 0.0004): a loss of 4e-4 holds the
# two sides' fp32 noise at 1.7e-2 of itself, which says nothing of the
# kernels
HD_TWIN = dict(num_layers=1, batch=1, seq=128, steps=3, requests=4,
               max_new=6, lr=1e-5)
# the flash kernels of the head_dims phase's paths, whose launches it
# reads
HD_FLASH_KERNELS = ("flash_attention_qkv_fwd", "flash_attention_qkv_bwd",
                    "flash_unpacked_fwd", "flash_unpacked_bwd",
                    "flash_segments_serve",
                    "flash_attention_segments_with_lse",
                    "flash_segments_fwd", "flash_attention_decode",
                    "flash_attention_decode_paged")


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


def half_float(dtype):
    """A 2-byte float type: the kernels' tensor-core routes take bf16 and
    fp16 alike (ops/_build.py `half_float`)."""
    return dtype in (torch.bfloat16, torch.float16)


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


# p and ds (rows 3-11) are rounded to bf16 by the kernels and by the plain
# versions alike, from fp32 values whose last bits differ (the products'
# summation order, exp2's): a value on a rounding edge rounds one way on
# one side and the other way on the other, moving an output by one bf16
# step of that term. A bf16 attention output is therefore held within
# `TOL` plus one bf16 step (ROUND_STEP) of the L1 mass of the terms it
# sums (`attn_compare`), and, to show that both sides round by the same
# rule in the same frame (a kernel that kept p unrounded, or rounded it
# against another running max, moves several percent of the elements),
# with at most FRAME_SHARE of the elements with |plain| > 1e-2 more than
# one bf16 step (2^-7 |plain|) off: tests/test_torch_p_rounding.py's
# measure, there against JAX on the CPU.
ROUND_STEP = 2.0 ** -7
FRAME_SHARE = 1e-3
# one step of each 2-byte type (fp16's p and ds round by the same rule)
ROUND_STEPS = {torch.bfloat16: ROUND_STEP, torch.float16: 2.0 ** -10}


def _off_share(got, ref):
    """The share of the elements with |ref| > 1e-2 more than one step of
    got's 2-byte type (2^-7 |ref| in bf16, 2^-10 in fp16) from ref."""
    step = ROUND_STEPS[got.dtype]
    got, ref = got.float(), ref.float()
    big = ref.abs() > 1e-2
    off = ((got - ref).abs() > step * ref.abs()) & big
    return float(off.sum()) / max(int(big.sum()), 1)


def attn_compare(got, ref, l1, extra=None, same_frame=True):
    """`compare` for attention outputs that sum terms rounded to bf16:
    ``l1[i]`` is the L1 mass of output i's terms (None where the output is
    no such sum, and for fp32 outputs, where the rounding is the
    identity). Adds ROUND_STEP of it to the tolerance and, where both
    sides round in the same frame, folds the share of elements beyond one
    bf16 step, over FRAME_SHARE, into the ratio."""
    ex = list(extra) if extra is not None else [None] * len(got)
    shares = []
    for i, (g, r, m) in enumerate(zip(got, ref, l1)):
        if m is None or g is None or g.dtype not in ROUND_STEPS:
            continue
        add = ROUND_STEPS[g.dtype] * m.float()
        ex[i] = add if ex[i] is None else ex[i] + add
        shares.append(_off_share(g, r))
    cmp = compare(got, ref, ex)
    if shares and same_frame:
        cmp["share"] = max(shares)
        cmp["ratio"] = max(cmp["ratio"], cmp["share"] / FRAME_SHARE)
    return cmp


def grad_l1(q, k, v, bias, o, lse, do, causal, scale, lens=None, rate=0.0,
            seed=0, dlse=None):
    """The L1 masses of the terms of dq, dk and dv on (bh, s, d) operands,
    from the plain backward's ds and p: scale * sum_k |ds| |k|, scale *
    sum_q |ds| |q| and sum_q |p_drop| |do|."""
    from rocm_apex_tpu_torch.ops import _dropout
    from rocm_apex_tpu_torch.ops import flash_attention as fa

    s = fa._unpacked_scores(q, k, bias, causal, scale, lens)
    p = torch.exp2(s - lse[..., None] * fa.LOG2E)
    del s
    if rate > 0.0:
        keep = _dropout.keep_mask(seed, rate, p.shape, device=p.device)
        p = torch.where(keep, p * _dropout.keep_scale(rate), 0.0)
    ds = fa._unpacked_grads(q, k, v, bias, o, lse, do, causal, scale, lens,
                            rate, seed, dlse)[3].abs()
    return (torch.einsum("bqk,bkd->bqd", ds, k.float().abs()) * scale,
            torch.einsum("bqk,bqd->bkd", ds, q.float().abs()) * scale,
            torch.einsum("bqk,bqd->bkd", p, do.float().abs()))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


# the device kernels of each route of the LayerNorm forward's plan
# (csrc/layer_norm.cu, ops/layer_norm.py `ln_fwd_plan`)
LN_ROUTE_KERNELS = {"warp": ("ln_fwd_warp_kernel",),
                    "block": ("ln_fwd_block_kernel",),
                    "three_pass": ("ln_fwd_kernel",)}


def check_ln_fwd(kern, ref, x, d, w, b, what):
    """A LayerNorm forward case against its plan: launched twice, the
    same bits; the residual stream s equal to the plain version's bit for
    bit (elementwise, the same fp32 sum and keep bits); one call's device
    kernels those of the route `ln_fwd_plan` names. Returns the route's
    label for the case name."""
    from rocm_apex_tpu_torch.ops import layer_norm as ln

    got = [t for t in kern() if t is not None]
    check(_same_bits(got, [t for t in kern() if t is not None]),
          f"{what}: two launches of the forward differ")
    if d is not None:
        check(torch.equal(kern()[1], ref[1]),
              f"{what}: the stream s differs from the plain version's")
    plan = ln._plan_of(x, d, w, b)
    return check_launches(kern, LN_ROUTE_KERNELS, plan["route"], what)


def ln_cases(dev, shapes=None):
    """The LayerNorm forward of the serve (bf16 or fp32 x, fp32 weights
    and y): 256 and 8 rows of 1024 (the chunk and the decode tick), the
    mixed tick's 264 rows in bf16, a single row, plain and residual; a
    width off the 16-byte vector grid (1002) and one past the register
    row's cap (16384 keys of bf16), which take the three-pass kernel.
    Every case launched twice for the same bits, its route checked
    against `ln_fwd_plan`."""
    from rocm_apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device=dev).manual_seed(1)
    h = SERVE["hidden_size"]
    if shapes is None:
        shapes = [(rows, h, residual, dt) for rows in (256, 8)
                  for residual in (False, True)
                  for dt in (torch.bfloat16, torch.float32)]
        shapes += [(264, h, False, torch.bfloat16),
                   (264, h, True, torch.bfloat16),
                   (1, h, False, torch.bfloat16),
                   (8, 1002, False, torch.bfloat16),
                   (8, 1002, True, torch.float32),
                   (2, 16384, False, torch.bfloat16)]
    for rows, hid, residual, dt in shapes:
        x = torch.randn(rows, hid, device=dev, generator=gen).to(dt)
        d = (torch.randn(rows, hid, device=dev, generator=gen)
             .to(dt) if residual else None)
        w = 1.0 + 0.1 * torch.randn(hid, device=dev, generator=gen)
        b = 0.1 * torch.randn(hid, device=dev, generator=gen)
        out_dt = torch.float32  # the mixed contract: weight dtype

        def kern(x=x, d=d, w=w, b=b):
            return ln._ln_fwd_impl(x, d, w, b, 1e-5, out_dt)

        def plain(x=x, d=d, w=w, b=b):
            return ln.layer_norm_fwd_plain(x, d, w, b, 1e-5, out_dt)

        got, ref = kern(), plain()
        case = (f"{'residual' if residual else 'plain'} ({rows}, {hid}) "
                f"{str(dt)[6:]}")
        route = check_ln_fwd(kern, ref, x, d, w, b, f"layer_norm_fwd {case}")
        wl, bl = w.to(dt), b.to(dt)
        lib = None if residual else (
            lambda x=x, wl=wl, bl=bl, hid=hid: F.layer_norm(
                x, (hid,), wl, bl, 1e-5))
        yield dict(
            kernel="layer_norm_fwd", case=f"{case}, {route}",
            dtype=dt, cmp=compare(got, ref), kern=kern,
            plain=plain, lib=lib, nbytes=nbytes(x, d, w, b, *got),
            ops=8 * rows * hid,
            headline=(rows == 8 and hid == h and not residual
                      and dt == torch.bfloat16),
            # the library call once more, after every other timing of
            # the case: warm
            extra_timings=({"library_again_ms": lib}
                           if lib is not None else {}),
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


def seg_cases(dev, h=None, d=None, seed=2,
              dtypes=(torch.bfloat16, torch.float32)):
    """Row 3's serving read at the serve's chunk (8 heads x 256 tokens x
    128, causal, 4 slot pieces out of order and pads; ``h`` heads of ``d``
    where given), bf16 and fp32, each
    against the plain version of its `flash_segments_serve_plan` route
    (`flash_attention_segments_plain` at the route's frame; bf16: the tile
    kernel, fp32: the warp-a-row kernel), on its route by the kernels a call launches (the launch tables)
    (`SEG_SERVE_ROUTE_KERNELS`), launched twice for the same bits. Beside
    the bf16 case: the pipe route's kernels on the same inputs (the
    training forward with its pre-passes, `pipe_ms`)."""
    from rocm_apex_tpu_torch.ops import flash_attention_segments as fs

    gen = torch.Generator(device=dev).manual_seed(seed)
    if h is None:
        h, d = SERVE["num_attention_heads"], SERVE["hidden_size"] // 8
    scale = 1.0 / math.sqrt(d)
    ids_np, _ = chunk_slot_ids(BUDGET, SLOTS)
    seg = torch.from_numpy(ids_np).to(dev)
    mask = (seg[:, None] == seg[None, :]) & torch.ones(
        BUDGET, BUDGET, dtype=torch.bool, device=dev).tril()
    live_pairs = int(mask.sum())
    kernel_of = {"tiles": fs.FLASH_SEGMENTS_SERVE.name,
                 "pipe": fs.FLASH_SEGMENTS_FWD.name,
                 "rows": fs.FLASH_SEGMENTS.name}
    for dt in dtypes:
        q, k, v = (x.transpose(0, 1) for x in _qkv(BUDGET, h, d, dt, dev,
                                                   gen))
        plan = fs.flash_segments_serve_plan(h, BUDGET, d, dt)
        check(plan["route"] == ("tiles" if half_float(dt) and d <= 128
                                else "rows"),
              f"segments serve {dt}: planned on the {plan['route']} route")
        what = f"causal ({h}, {BUDGET}, {d}) {str(dt)[6:]}, 4 slots + pads"

        def kern(q=q, k=k, v=v):
            return fs.flash_attention_segments_with_lse(
                q, k, v, seg, causal=True)

        def plain(q=q, k=k, v=v, plan=plan):
            return fs.flash_attention_segments_plain(q, k, v, seg, True,
                                                     scale, plan["frame"])

        got, ref = kern(), plain()
        check(_same_bits(got, kern()),
              f"segments serve {what}: two launches differ")
        route = check_launches(kern, SEG_SERVE_ROUTE_KERNELS, plan["route"],
                               f"segments serve {what}")
        l1 = fs.flash_attention_segments_plain(q, k, v.abs(), seg, True,
                                               scale, plan["frame"])[0]
        qc, kc, vc = (x.contiguous()[None] for x in (q, k, v))

        def lib(qc=qc, kc=kc, vc=vc):
            return F.scaled_dot_product_attention(qc, kc, vc,
                                                  attn_mask=mask)

        extra = {}
        if dt == torch.bfloat16:
            extra = dict(pipe_ms=lambda q=q, k=k, v=v, scale=scale:
                         fs._seg_fwd(q, k, v, seg, True, scale))
        yield dict(
            kernel=kernel_of[plan["route"]],
            case=f"{what} [{route}]",
            dtype=dt, cmp=attn_compare(got, ref, [l1, None]), kern=kern,
            plain=plain, lib=lib, nbytes=nbytes(q, k, v, seg, *got),
            ops=4 * d * h * live_pairs, headline=dt != torch.float16,
            extra_timings=extra, breakdown=dt == torch.bfloat16,
        )


def _pools_from_cache(kc, vc, ps, gen):
    """Page pools holding a contiguous (slots, capacity, heads, d) K/V
    cache's keys through one permuted table: the capacity rounded up to
    whole pages of ``ps`` (the rows past it zeros), every page mapped,
    the table a random permutation of the pool. Returns (k pool, v pool,
    table)."""
    slots, cap, h, d = kc.shape
    pps = -(-cap // ps)
    perm = torch.randperm(slots * pps, generator=gen).to(kc.device)

    def pool(cache):
        full = torch.zeros(slots, pps * ps, h, d, dtype=cache.dtype,
                           device=cache.device)
        full[:, :cap] = cache
        out = torch.empty(slots * pps, h, ps, d, dtype=cache.dtype,
                          device=cache.device)
        out[perm] = full.reshape(slots, pps, ps, h, d).transpose(
            2, 3).reshape(slots * pps, h, ps, d)
        return out

    return pool(kc), pool(vc), perm.reshape(slots, pps).int()


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# the device kernels of each flash forward route (csrc/flash_fwd_pipe.cuh,
# flash_fwd.cu, flash_unpacked_fwd.cuh)
FWD_ROUTE_KERNELS = {"wgmma": "fwd_pipe_kernel",
                     "cuda_cores": ("flash_fwd_kernel", "fwd_f32_kernel")}


def _launched_kernels(fn):
    """The names of the device kernels two calls of ``fn`` launch, read
    from the kernel libraries' host launch tables (csrc/common.cuh
    ``launch_log``, `_build.device_launches`): each C entry point notes
    every kernel it launches, by name, as its launch call returns without
    error. The tables are cleared just before the calls."""
    from rocm_apex_tpu_torch.ops._build import (
        device_launches,
        reset_device_launches,
    )

    torch.cuda.synchronize()
    reset_device_launches()
    fn()
    fn()
    torch.cuda.synchronize()
    return set(device_launches())


def check_fwd_route(fkern, plan, dtype, what, prepass=False):
    """A flash forward case against its plan: the route is the one its
    dtype takes (bf16 the wgmma pipe, fp32 the CUDA cores), the bf16
    forward launched twice gives the same bits, and one call's kernels,
    as the launch tables name them (`_launched_kernels`), are the route's
    (the pipe, with the split merge exactly when the plan splits and the
    bias pre-pass where ``prepass``) and none of the other route's.
    Returns the route's label for the case name."""
    route = plan["route"]
    check(route == ("wgmma" if half_float(dtype) else "cuda_cores"),
          f"{what}: a {dtype} forward planned on the {route} route")
    if route == "wgmma":
        check(_same_bits(fkern(), fkern()),
              f"{what}: two launches of the forward differ")
    want = FWD_ROUTE_KERNELS[route]  # a tuple: any one
    names = _launched_kernels(fkern)
    check(any(k in n for n in names for k in (
        want if isinstance(want, tuple) else (want,))),
        f"{what}: the plan says {route}, the call launched {sorted(names)}")
    other = FWD_ROUTE_KERNELS["cuda_cores" if route == "wgmma" else "wgmma"]
    check(not any(k in n for n in names for k in (
        other if isinstance(other, tuple) else (other,))),
        f"{what}: the call launched another route's kernel: {sorted(names)}")
    if route == "wgmma":
        check(any("fwd_merge_kernel" in n for n in names)
              == (plan["splits"] > 1),
              f"{what}: {plan['splits']} split(s) planned, launched "
              f"{sorted(names)}")
        check(any("qkv_bias_kernel" in n for n in names) == prepass,
              f"{what}: the bias pre-pass {'missing' if prepass else 'ran'}")
        return f"wgmma, {plan['splits']} split(s)"
    return route


# the device kernels of each route of the packed flash backward (csrc/
# flash_bwd_pipe.cuh, flash_bwd.cu) and of the 3x3 forward (csrc/
# bottleneck_fwd.cu over bottleneck_pipe.cuh or bottleneck.cuh)
BWD_ROUTE_KERNELS = {"wgmma": ("bwd_dq_pipe_kernel", "bwd_dkv_pipe_kernel"),
                     "cuda_cores": ("flash_bwd_dq_kernel",
                                    "flash_bwd_dkv_kernel")}
K2_ROUTE_KERNELS = {"pipe": ("Conv3FwdPipe",), "staged": ("gemm_kernel",)}
K1_ROUTE_KERNELS = {"pipe": ("MmFwdPipe",), "staged": ("gemm_kernel",)}
# the unpacked backward's routes (csrc/flash_unpacked_bwd.cu: bf16 on
# flash_bwd_pipe.cuh, fp32 on flash_unpacked_bwd.cuh's CUDA-core bodies)
UNPACKED_BWD_ROUTE_KERNELS = {
    "wgmma": ("bwd_dq_pipe_kernel", "bwd_dkv_pipe_kernel"),
    "cuda_cores": ("dq_f32_kernel", "dkv_f32_kernel")}
# the training segment kernels' routes (csrc/flash_segments_{fwd,bwd}.cu,
# `flash_segments_plan`): bf16 on the two pipes with their segment
# pre-passes, fp32 on the CUDA-core bodies
SEG_FWD_ROUTE_KERNELS = {
    "wgmma": ("fwd_pipe_kernel", "seg_tiles_kernel", "seg_order_kernel"),
    "cuda_cores": ("fwd_f32_kernel",)}
# the serving segment read's routes (`flash_segments_serve_plan`): bf16 on
# the tile kernel (csrc/flash_segments_serve.cu) or, past SERVE_TILES_MAX
# tokens, the training forward's pipe with its pre-passes; fp32 (and bf16
# at head_dim 32 or 256) on the warp-a-row kernel (csrc/flash_segments.cu)
SEG_SERVE_ROUTE_KERNELS = {
    "tiles": ("serve_tiles_kernel",),
    "pipe": ("fwd_pipe_kernel", "seg_tiles_kernel", "seg_order_kernel"),
    "rows": ("segments_kernel",)}
# the bias gradient's routes (csrc/flash_dbias.cu, `flash_dbias_plan`)
DBIAS_ROUTE_KERNELS = {"wgmma": ("dbias_wgmma_kernel",),
                       "cuda_cores": ("dbias_f32_kernel",)}
SEG_BWD_ROUTE_KERNELS = {
    "wgmma": ("bwd_dq_pipe_kernel", "bwd_dkv_pipe_kernel",
              "seg_tiles_kernel", "seg_order_kernel"),
    "cuda_cores": ("dq_f32_kernel", "dkv_f32_kernel")}


def check_launches(fn, routes, route, what, prepass_name=None,
                   prepass=False):
    """One call's device kernels, as the launch tables name them
    (`_launched_kernels`), against a plan's ``route``: every kernel
    ``routes[route]`` names is launched, none of another route's, and the
    pre-pass ``prepass_name`` exactly when ``prepass``. Returns the
    route's label for the case name."""
    names = _launched_kernels(fn)
    for k in routes[route]:
        check(any(k in n for n in names),
              f"{what}: the plan says {route}, the call launched "
              f"{sorted(names)}")
    for other, ks in routes.items():
        if other != route:
            check(not any(k in n for n in names for k in ks),
                  f"{what}: the call launched the {other} route's kernel: "
                  f"{sorted(names)}")
    if prepass_name is not None:
        check(any(prepass_name in n for n in names) == prepass,
              f"{what}: the pre-pass {'missing' if prepass else 'ran'}: "
              f"{sorted(names)}")
    return route


def planned_fwd_plain(q, k, v, bias, causal, scale, lens, rate, seed):
    """The plain forward a flash forward kernel on (bh, s, d) operands is
    held to: split as `flash_fwd_plan` splits the card's call (each
    split's p rounded against its own running max, as the pipe's splits
    round it, then merged), else whole."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa
    from rocm_apex_tpu_torch.ops._build import sm_count

    plan = fa.flash_fwd_plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                             causal, sm_count(q.device), q.dtype)
    if plan["splits"] > 1:
        return fa.flash_fwd_split_plain(q, k, v, bias, causal, scale,
                                        plan["splits"], plan["split_tiles"],
                                        lens, rate, seed)
    return fa.flash_unpacked_fwd_plain(q, k, v, bias, causal, scale, lens,
                                       rate, seed)


def planned_qkv_fwd_plain(qkv, bias, causal, scale, rate, seed,
                          abs_v=False):
    """`planned_fwd_plain` for the packed forward on the (B, S, nh, 3 hd)
    projection: the biased heads, split as the card's call splits them;
    returns o (B, S, nh hd) and lse, as `flash_qkv_fwd_plain`. With
    ``abs_v``, on |v|: o is then the L1 mass of o's terms."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa

    B, S, nh, _ = qkv.shape
    q, k, v = fa._heads(qkv, bias)
    o, lse = planned_fwd_plain(q, k, v.abs() if abs_v else v, None, causal,
                               scale, None, rate, seed)
    return fa._to_rows(o, B, S, nh).reshape(B, S, -1), lse


def packed_grad_l1(qkv, bias, o, lse, do, causal, scale, rate, seed):
    """`grad_l1` of the packed backward, in dqkv's (B, S, nh, 3 hd)
    layout."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa

    B, S, nh, _ = qkv.shape
    q, k, v = fa._heads(qkv, bias)

    def heads(t):
        return t.reshape(B, S, nh, -1).permute(0, 2, 1, 3).reshape(
            B * nh, S, -1)

    l1 = grad_l1(q, k, v, None, heads(o), lse, heads(do), causal, scale,
                 None, rate, seed)
    return fa._to_rows(torch.cat(l1, dim=-1), B, S, nh)


def decode_cases(dev, h=None, d=None, seed=3,
                 dtypes=(torch.bfloat16, torch.float32)):
    """The contiguous decode read (row 5) at the serve's shapes: the
    decode grid (8 slots x 8 heads x d 128, capacity 1024, mixed bounds;
    ``h`` heads of ``d`` where given, without the capacity-1020 tail)
    and piece B (the 256-row chunk, each row against its own slot's
    prefix, pads reading nothing), bf16 and fp32, each against its plain
    version. Every decode-grid case launches twice on the same inputs and
    must repeat its bits. Every case must give the same bits, o and lse,
    as the paged read (row 6) of the same keys: the cache copied into a
    page-16 pool through a permuted table. Then the same at capacity 1020,
    which page 16 rounds up to 1024 rows: the paged read given the
    capacity plans the contiguous read's split (checked to differ from the
    1024-key plan), so the bits agree there too. The library yardstick is
    one masked SDPA over (heads, keys, d) copies made outside its
    timing."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa
    from rocm_apex_tpu_torch.ops._build import sm_count

    gen = torch.Generator(device=dev).manual_seed(seed)
    cpu_gen = torch.Generator().manual_seed(seed)
    tail = h is None
    if h is None:
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
    for dt in dtypes:
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

            def kern(q=q, lens=lens, ids=ids, caches=caches, turn=turn):
                kc, vc = caches[turn[0] % 4]
                turn[0] += 1
                return fa.flash_attention_decode(
                    q, kc, vc, lens, return_lse=True, slot_ids=ids)

            def plain(q=q, lens=lens, ids=ids, rows=rows, caches=caches):
                kc, vc = caches[0]
                return fa.decode_spans_plain(
                    q, kc, vc, lens, 1.0 / math.sqrt(d),
                    *fa.decode_span_plan(rows, h, CAPACITY, sm_count(dev)),
                    ids)

            turn[0] = 0
            got, ref = kern(), plain()
            l1 = fa.decode_spans_plain(
                q, caches[0][0], caches[0][1].abs(), lens, 1.0 / math.sqrt(d),
                *fa.decode_span_plan(rows, h, CAPACITY, sm_count(dev)),
                ids)[0]
            turn[0] = 0
            if ids is None:
                check(_same_bits(got, kern()),
                      f"{form}, {dt}: two launches on the same inputs "
                      f"differ")
                turn[0] = 0
            kp, vp, tab = _pools_from_cache(*caches[0], PAGE_SIZE, cpu_gen)
            paged = fa.flash_attention_decode_paged(
                q, kp, vp, tab, lens, None, return_lse=True, slot_ids=ids)
            check(_same_bits(got, paged),
                  f"{form}, {dt}: the contiguous read and the paged read "
                  f"of the same keys differ (o {max_err(got[0], paged[0])},"
                  f" lse {max_err(got[1], paged[1])})")
            log(f"  {form}, {str(dt)[6:]}: contiguous == paged (page "
                f"{PAGE_SIZE}, permuted table), o and lse bit for bit")
            del kp, vp
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

            spans, span_len = fa.decode_span_plan(rows, h, CAPACITY,
                                                  sm_count(dev))
            yield dict(
                kernel="flash_attention_decode",
                case=f"{form}: {rows} rows x {h} heads vs ({SLOTS}, "
                     f"{CAPACITY}, {h}, {d}) {str(dt)[6:]}, {spans} "
                     f"span{'s' * (spans > 1)} of {span_len}",
                dtype=dt, cmp=attn_compare(got, ref, [l1, None]), kern=kern,
                plain=plain,
                lib=lib, nbytes=(nbytes(q, lens, ids, *got) + kv_bytes),
                ops=4 * d * h * keys_read,
                headline=ids is None and dt == torch.bfloat16,
            )
    if not tail:
        return
    # a capacity page 16 does not divide (the pools round it up to 1024
    # rows): the paged read takes the capacity and plans on it
    cap = CAPACITY - 4
    sms = sm_count(dev)
    rounded = -(-cap // PAGE_SIZE) * PAGE_SIZE
    check(fa.decode_span_plan(SLOTS, h, cap, sms)
          != fa.decode_span_plan(SLOTS, h, rounded, sms),
          f"capacity {cap} and its pages' {rounded} rows plan one split: "
          f"the case tests nothing")
    kc, vc = (torch.randn(SLOTS, cap, h, d, device=dev,
                          generator=gen).to(torch.bfloat16)
              for _ in range(2))
    lens = grid_len.clamp(max=cap)
    q, _, _ = _qkv(SLOTS, h, d, torch.bfloat16, dev, gen)
    got = fa.flash_attention_decode(q, kc, vc, lens, return_lse=True)
    ref = fa.decode_spans_plain(q, kc, vc, lens, 1.0 / math.sqrt(d),
                                *fa.decode_span_plan(SLOTS, h, cap, sms))
    cmp = attn_compare(got, ref, [fa.decode_spans_plain(
        q, kc, vc.abs(), lens, 1.0 / math.sqrt(d),
        *fa.decode_span_plan(SLOTS, h, cap, sms))[0], None])
    check(cmp["ratio"] <= 1.0, f"decode grid at capacity {cap}: the kernel "
          f"differs from its plain version by {cmp['ratio']:.3g}x its "
          f"tolerance")
    kp, vp, tab = _pools_from_cache(kc, vc, PAGE_SIZE, cpu_gen)
    paged = fa.flash_attention_decode_paged(q, kp, vp, tab, lens, None,
                                            return_lse=True, capacity=cap)
    check(_same_bits(got, paged),
          f"decode grid at capacity {cap}: the contiguous read and the "
          f"paged read ({rounded} rows, capacity {cap}) differ (o "
          f"{max_err(got[0], paged[0])}, lse {max_err(got[1], paged[1])})")
    log(f"  decode grid at capacity {cap} (pages of {PAGE_SIZE}: {rounded} "
        f"rows): contiguous == paged bit for bit, err/tol {cmp['ratio']:.3f}"
        f" against the plain version; split "
        f"{fa.decode_span_plan(SLOTS, h, cap, sms)}")


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


def paged_decode_cases(dev, h=None, d=None, cases=None, seed=6):
    """The paged decode read (float pools, and int8 pools with fp32
    scales) at the serve's shapes (``h`` heads of ``d`` and the ``cases``
    where given): the decode grid (8 slots x 8 heads x d 128, prefixes up
    to 1024: ragged, ending mid-page, and slot 1 a
    dead row at capacity whose table maps 3 pages, so its bound reaches
    sentinel entries) and piece B (the 256-row chunk, each row against
    its own slot's pre-chunk prefix, pads reading nothing), at page sizes
    16 and 64. Then the split read's edges on the decode grid ("spans"):
    an empty row, rows shorter than one span, rows ending inside a span,
    and at page 64 spans that end mid-page (checked against the plan).
    Every decode-grid case launches twice on the same inputs and must
    repeat its bits, and every float-pool case must give the bits of the
    contiguous read (row 5) over the pool gathered through the table. The
    library yardstick is one masked SDPA over a contiguous view gathered
    beforehand (the gather is not timed)."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa
    from rocm_apex_tpu_torch.ops._build import sm_count
    from rocm_apex_tpu_torch.ops.paging import paged_view

    gen = torch.Generator(device=dev).manual_seed(seed)
    cpu_gen = torch.Generator().manual_seed(seed)
    if h is None:
        h, d = SERVE["num_attention_heads"], SERVE["hidden_size"] // 8
    grid_len = [CAPACITY, CAPACITY, 17, 513, 300, 64, 1000, 129]
    chunk_len = [700, 0, 0, 256, 0, 0, 32, 0]
    # the split read's edges: empty, shorter than a span, ending inside a
    # span and (page 64) inside a page, one span long, the capacity
    span_len_edges = [0, 5, 31, 33, 95, 160, 1000, CAPACITY]
    spans, span_len = fa.decode_span_plan(SLOTS, h, CAPACITY, sm_count(dev))
    ids_np, _ = chunk_slot_ids(BUDGET, SLOTS)
    slot_ids = torch.from_numpy(ids_np).to(dev)
    key_slot = torch.arange(SLOTS * CAPACITY, device=dev) // CAPACITY
    key_pos = torch.arange(SLOTS * CAPACITY, device=dev) % CAPACITY
    cases = cases or [
        ("decode grid", 16, torch.bfloat16, False),
        ("decode grid", 16, torch.float32, False),
        ("decode grid", 16, torch.bfloat16, True),
        ("decode grid", 16, torch.float32, True),
        ("decode grid", 64, torch.bfloat16, False),
        ("decode grid", 64, torch.bfloat16, True),
        ("chunk piece B", 16, torch.bfloat16, False),
        ("chunk piece B", 16, torch.bfloat16, True),
        ("chunk piece B", 64, torch.bfloat16, False),
        ("decode grid, spans", 16, torch.bfloat16, False),
        ("decode grid, spans", 64, torch.bfloat16, False),
        ("decode grid, spans", 64, torch.bfloat16, True),
    ]
    for form, ps, dt, int8 in cases:
        num_pages = SLOTS * (CAPACITY // ps)  # the worst-case pool
        grid = form.startswith("decode grid")
        lens_list = (span_len_edges if form.endswith("spans")
                     else grid_len if grid else chunk_len)
        if form.endswith("spans"):
            live = [n for n in lens_list if n]
            check(spans > 1 and 0 in lens_list and min(live) < span_len
                  and any(n % span_len for n in live),
                  f"the split read's edge case does not reach its edges "
                  f"({spans} spans of {span_len})")
            check(ps != 64 or span_len % ps,
                  f"no span of {span_len} keys ends mid-page at page {ps}")
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        table = _paged_table(lens_list, ps, num_pages, cpu_gen, dev,
                             mapped={1: 3} if form == "decode grid"
                             else None)
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

        def plain(q=q, lens=lens, ids=ids, table=table, pools=pools,
                  rows=rows):
            k, v, ks, vs = pools[0]
            return fa.decode_paged_spans_plain(
                q, k, v, table, lens, 1.0 / math.sqrt(d),
                *fa.decode_span_plan(rows, h, CAPACITY, sm_count(dev)), ks,
                vs, ids, CAPACITY)

        got, ref = kern(), plain()
        k0, v0, ks0, vs0 = pools[0]
        l1 = fa.decode_paged_spans_plain(
            q, k0, v0.abs(), table, lens, 1.0 / math.sqrt(d),
            *fa.decode_span_plan(rows, h, CAPACITY, sm_count(dev)), ks0, vs0,
            ids, CAPACITY)[0]
        turn[0] = 0
        if grid:
            again = kern()
            turn[0] = 0
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{form}, page {ps}: two launches on the same inputs "
                  f"differ")
        if not int8:
            # the contiguous read (row 5) of the same keys, gathered
            kc, vc = (paged_view(x, table, out_dtype=dt).contiguous()
                      for x in pools[0][:2])
            contig = fa.flash_attention_decode(q, kc, vc, lens,
                                               return_lse=True, slot_ids=ids)
            check(_same_bits(got, contig),
                  f"{form}, page {ps}, {dt}: the paged read and the "
                  f"contiguous read of the same keys differ (o "
                  f"{max_err(got[0], contig[0])}, lse "
                  f"{max_err(got[1], contig[1])})")
            del kc, vc, contig
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
                 f"({num_pages}, {h}, {ps}, {d}), q {str(dt)[6:]}"
                 + (f", {spans} spans of {span_len}" if grid else ""),
            dtype=dt, cmp=attn_compare(got, ref, [l1, None]), kern=kern,
            plain=plain,
            lib=lib, nbytes=(nbytes(q, lens, ids, table, *got) + kv_bytes),
            ops=4 * d * h * int(per_row.sum()),
            headline=(form == "decode grid" and ps == 16
                      and dt == torch.bfloat16),
            breakdown=form == "decode grid" and ps == 16,
        )


def _dbias_flip_tol(l1):
    """The part of a bf16 packed bias gradient's tolerance that its rows'
    ds rounding flips take: the bias gradient sums dq|dk|dv over the
    (B, S) rows in fp32, and each of those may move by one bf16 step of
    its terms' L1 mass ``l1`` (B, S, nh, 3 hd) where p or ds rounds the
    other way on the two sides, in at most FRAME_SHARE of the elements
    (`attn_compare`'s rule for dq|dk|dv themselves); so each column is
    allowed ROUND_STEP times the sum of its ceil(FRAME_SHARE B S) largest
    L1 masses. At B 1 x S 2048 the fp32-order term alone (`_l1_tol`) read
    1.8-2.0x at head_dim 128 and 256 alike, dq|dk|dv 0.5."""
    rows = l1.reshape(-1, l1.shape[-2] * l1.shape[-1]).float()
    k = max(1, math.ceil(FRAME_SHARE * rows.shape[0]))
    return ROUND_STEP * rows.topk(k, dim=0).values.sum(dim=0)


def _l1_tol(abs_terms_sum):
    """Extra atol for an output that is an fp32 sum over many rows (a
    bias or LayerNorm-parameter gradient): kernel and plain version add
    the rows in different orders, which moves the sum by up to about
    sqrt(n) * 2^-24 of the L1 mass of its terms (8e-6 at n = 16384 rows
    of the training step); 1e-5 of the L1 mass allows that."""
    return 1e-5 * abs_terms_sum


# the device kernels of each route of the LayerNorm backward's plan
# (csrc/layer_norm.cu, ops/layer_norm.py `ln_bwd_plan`)
LN_BWD_ROUTE_KERNELS = {"warp": ("ln_bwd_warp_kernel",),
                        "block": ("ln_bwd_block_kernel",),
                        "three_pass": ("ln_bwd_kernel",)}


def ln_bwd_case(dev, gen, rows, h, dt, form, rate, seed, x=None, w=None,
                b=None, mu=None, rs=None, keep=None, headline=False):
    """One LayerNorm backward case (row 2): ``form`` "residual+dropout"
    (the stream cotangent ds and the regenerated keep bits of ``rate``)
    or "plain affine"; x (the forward's LN input), w, b, mu and rs drawn
    where not given. Launched twice for the same bits; dd 0 exactly where
    the forward dropped (``keep``); its route checked against
    `ln_bwd_plan` by the kernels one call launches. Library: the aten
    backward alone (`native_layer_norm_backward`, dx, dgamma and dbeta
    of the plain form) on the same shape, and `F.layer_norm` forward +
    backward beside it."""
    from rocm_apex_tpu_torch.ops import _dropout
    from rocm_apex_tpu_torch.ops import layer_norm as ln
    from rocm_apex_tpu_torch.ops._build import sm_count

    if x is None:
        x = torch.randn(rows, h, device=dev, generator=gen).to(dt)
        w = (1.0 + 0.1 * torch.randn(h, device=dev, generator=gen)).to(dt)
        b = (0.1 * torch.randn(h, device=dev, generator=gen)).to(dt)
        mu = x.float().mean(1)
        rs = torch.rsqrt(((x.float() - mu[:, None]) ** 2).mean(1) + 1e-5)
    r = rate if form == "residual+dropout" else 0.0
    if r > 0.0 and keep is None:
        keep = _dropout.keep_mask(seed, r, (rows, h), device=dev)
    dy = torch.randn(rows, h, device=dev, generator=gen).to(dt)
    ds = (torch.randn(rows, h, device=dev, generator=gen).to(dt)
          if form == "residual+dropout" else None)
    xh = (x.float() - mu[:, None]) * rs[:, None]

    def bkern(x=x, dy=dy, ds=ds, mu=mu, rs=rs, w=w, r=r):
        return ln._layer_norm_bwd(x, dy, ds, mu, rs, w, r, seed)

    def bplain(x=x, dy=dy, ds=ds, mu=mu, rs=rs, w=w, r=r):
        return ln.layer_norm_bwd_plain(x, dy, ds, mu, rs, w, r, seed)

    got = bkern()
    what = f"layer_norm_bwd {form} ({rows}, {h}) {str(dt)[6:]}"
    check(_same_bits([t for t in got if t is not None],
                     [t for t in bkern() if t is not None]),
          f"{what}: two launches differ")
    if r > 0.0:
        # the backward regenerates the forward's keep bits: dd is 0
        # exactly where the forward dropped the delta
        check(torch.equal(got[1] != 0, keep & (got[0] != 0)),
              f"{what}: dd's zeros are not the forward's dropped elements")
    plan = ln.ln_bwd_plan(rows, h, dt, sm_count(x.device),
                          all(t.data_ptr() % 16 == 0
                              for t in (x, dy, ds, w) if t is not None))
    route = check_launches(bkern, LN_BWD_ROUTE_KERNELS, plan["route"], what)
    xg = x.detach().clone().requires_grad_(True)
    wg = w.detach().clone().requires_grad_(True)
    bg = b.detach().clone().requires_grad_(True)

    def fwd_bwd(xg=xg, wg=wg, bg=bg, dy=dy):
        xg.grad = wg.grad = bg.grad = None
        F.layer_norm(xg, (h,), wg, bg, 1e-5).backward(dy)

    _, amu, ars = torch.ops.aten.native_layer_norm(x, (h,), w, b, 1e-5)

    def lib(x=x, dy=dy, w=w, b=b, amu=amu, ars=ars):
        return torch.ops.aten.native_layer_norm_backward(
            dy, x, (h,), amu, ars, w, b, [True, True, True])

    extra = [None, None, _l1_tol((dy.float() * xh).abs().sum(0)),
             _l1_tol(dy.float().abs().sum(0))]
    return dict(
        kernel="layer_norm_bwd", case=f"{form} ({rows}, {h}) "
        f"{str(dt)[6:]}, {route}", dtype=dt, cmp=compare(got, bplain(),
                                                          extra),
        kern=bkern, plain=bplain, lib=lib,
        library="aten native_layer_norm_backward alone",
        extra_timings={"library_fwd_bwd_ms": fwd_bwd},
        nbytes=nbytes(x, dy, ds, mu, rs, w, *got), ops=14 * rows * h,
        headline=headline, iters=50,
    )


def train_ln_cases(dev, dtypes=(torch.bfloat16, torch.float32), tail=True,
                   rows=None):
    """The LayerNorms of the training step on its (16384, 1024) rows:
    the residual forward with dropout (16 of the step's 17 forwards:
    launched twice for the same bits, s equal to the plain version's bit
    for bit, its route checked against `ln_fwd_plan`), and the backward
    (`ln_bwd_case`) with the stream cotangent and the regenerated dropout
    mask (16 of 17) and in the plain affine form (layer 0's ln1); then
    the backward's other routes: the serve's 8 rows and 264 rows (a block
    a row), and width 1002 (off the vector grid: the old form).
    ``rows``: another row count (a tensor-parallel rank's shard)."""
    from rocm_apex_tpu_torch.ops import _dropout
    from rocm_apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device=dev).manual_seed(5)
    rows, h = rows or TRAIN_BATCH * TRAIN_SEQ, TRAIN["hidden_size"]
    rate, seed = TRAIN["hidden_dropout"], 2024
    for dt in dtypes:
        x = torch.randn(rows, h, device=dev, generator=gen).to(dt)
        d = torch.randn(rows, h, device=dev, generator=gen).to(dt)
        # the training state holds LN parameters in the compute dtype
        w = (1.0 + 0.1 * torch.randn(h, device=dev, generator=gen)).to(dt)
        b = (0.1 * torch.randn(h, device=dev, generator=gen)).to(dt)

        def fkern(x=x, d=d, w=w, b=b, dt=dt):
            return ln._ln_fwd_impl(x, d, w, b, 1e-5, dt, rate, seed)

        def fplain(x=x, d=d, w=w, b=b, dt=dt):
            return ln.layer_norm_fwd_plain(x, d, w, b, 1e-5, dt, rate, seed)

        got, ref = fkern(), fplain()
        case = f"residual+dropout {rate} ({rows}, {h}) {str(dt)[6:]}"
        route = check_ln_fwd(fkern, ref, x, d, w, b,
                             f"layer_norm_fwd_dropout {case}")
        yield dict(
            kernel="layer_norm_fwd_dropout", case=f"{case}, {route}",
            dtype=dt, cmp=compare(got, ref), kern=fkern, plain=fplain,
            lib=None, nbytes=nbytes(x, d, w, b, *got), ops=10 * rows * h,
            headline=dt == torch.bfloat16, iters=50,
        )
        del ref
        _, s_, mu, rs = got
        keep = _dropout.keep_mask(seed, rate, (rows, h), device=dev)
        forms = ["residual+dropout"]
        if dt == torch.bfloat16:
            forms.append("plain affine")
        for form in forms:
            yield ln_bwd_case(dev, gen, rows, h, dt, form, rate, seed, s_, w,
                              b, mu, rs, keep,
                              headline=form != "plain affine"
                              and dt == torch.bfloat16)
        del s_, got
    if not tail:
        return
    for n, width, form in ((8, h, "plain affine"), (264, h, "residual+dropout"),
                           (4096, 1002, "residual+dropout")):
        yield ln_bwd_case(dev, gen, n, width, torch.bfloat16, form, rate, seed)


def ln_plain_cases(dev, dtypes=(torch.bfloat16, torch.float32)):
    """Row 2's non-affine form and the non-affine forward (the
    normalization API's `fused_layer_norm`, `FusedLayerNorm(
    elementwise_affine=False)`): forward and backward at the training
    rows (16384, 1024) and the serve's 8 rows, bf16 and fp32, against the
    plain versions (`layer_norm_fwd_plain`, `layer_norm_bwd_plain` with no
    weight) on the same card tensors; each launched twice for the same
    bits, its route checked against `ln_fwd_plan` / `ln_bwd_plan`. The
    yardstick: `F.layer_norm` without a weight, the forward alone, and
    forward + backward for the backward case (`library_fwd_bwd_ms`
    beside the aten backward alone)."""
    from rocm_apex_tpu_torch.ops import layer_norm as ln
    from rocm_apex_tpu_torch.ops._build import sm_count

    gen = torch.Generator(device=dev).manual_seed(19)
    h = TRAIN["hidden_size"]
    for rows in (TRAIN_BATCH * TRAIN_SEQ, 8):
        for dt in dtypes:
            lab = f"({rows}, {h}) {str(dt)[6:]}"
            x = (0.5 + 2.0 * torch.randn(rows, h, device=dev,
                                         generator=gen)).to(dt)
            dy = torch.randn(rows, h, device=dev, generator=gen).to(dt)

            def fkern(x=x):
                return ln._ln_fwd_impl(x, None, None, None, 1e-5, None)

            def fplain(x=x, dt=dt):
                return ln.layer_norm_fwd_plain(x, None, None, None, 1e-5, dt)

            got, ref = fkern(), fplain()
            route = check_ln_fwd(fkern, ref, x, None, None, None,
                                 f"layer_norm_fwd non-affine {lab}")
            yield dict(
                kernel="layer_norm_fwd", case=f"non-affine {lab}, {route}",
                dtype=dt, cmp=compare(got, ref), kern=fkern, plain=fplain,
                lib=lambda x=x: F.layer_norm(x, (h,)),
                library="F.layer_norm, no weight",
                nbytes=nbytes(x, got[0], got[2], got[3]), ops=8 * rows * h,
                headline=False, iters=50,
            )
            _, _, mu, rs = ref

            def bkern(x=x, dy=dy, mu=mu, rs=rs):
                return ln._layer_norm_bwd(x, dy, None, mu, rs, None)

            def bplain(x=x, dy=dy, mu=mu, rs=rs):
                return ln.layer_norm_bwd_plain(x, dy, None, mu, rs, None)

            bgot = bkern()
            what = f"layer_norm_bwd_noaffine {lab}"
            check(bgot[1] is None and bgot[2] is None and bgot[3] is None,
                  f"{what}: the non-affine form returned dd/dgamma/dbeta")
            check(_same_bits(bgot[:1], bkern()[:1]),
                  f"{what}: two launches differ")
            plan = ln.ln_bwd_plan(rows, h, dt, sm_count(x.device),
                                  all(t.data_ptr() % 16 == 0
                                      for t in (x, dy)))
            broute = check_launches(bkern, LN_BWD_ROUTE_KERNELS,
                                    plan["route"], what)
            names = _launched_kernels(bkern)
            check(not any("ln_bwd_reduce_kernel" in n for n in names),
                  f"{what}: the non-affine backward launched the "
                  f"dgamma/dbeta reduction")
            xg = x.detach().clone().requires_grad_(True)
            _, amu, ars = torch.ops.aten.native_layer_norm(x, (h,), None,
                                                           None, 1e-5)

            def fwd_bwd(xg=xg, dy=dy):
                xg.grad = None
                F.layer_norm(xg, (h,)).backward(dy)

            def lib(x=x, dy=dy, amu=amu, ars=ars):
                return torch.ops.aten.native_layer_norm_backward(
                    dy, x, (h,), amu, ars, None, None, [True, False, False])

            yield dict(
                kernel="layer_norm_bwd_noaffine",
                case=f"non-affine {lab}, {broute}", dtype=dt,
                cmp=compare(bgot[:1], bplain()[:1]), kern=bkern,
                plain=bplain, lib=lib,
                library="aten native_layer_norm_backward alone, no weight",
                extra_timings={"library_fwd_bwd_ms": fwd_bwd},
                nbytes=nbytes(x, dy, mu, rs, bgot[0]), ops=10 * rows * h,
                headline=rows > 8 and dt == torch.bfloat16, iters=50,
            )
            del x, dy, got, ref, bgot


def flash_cases(dev, nh=None, hd=None, shapes=None, seed=4, flips=False):
    """The packed-QKV attention of the training step, forward and
    backward: (B 16, S 1024, 8 heads, 3 x 128) bf16 with the projection
    bias and dropout 0.1 (the step's form), without bias or dropout, an
    S that is not a multiple of the 64-row tile (causal and not), and an
    fp32 case, and the bert_train cell's packed shape (B 8, S 512, not
    causal, bias, no dropout). Every forward case is checked against the
    plan's route (`check_fwd_route`: the bf16 ones on the wgmma pipe,
    launched twice for equal bits). The library yardstick is SDPA on the
    biased q/k/v in (B, nh, S, hd), forward, and forward + backward
    through autograd. ``nh`` heads of ``hd`` and the ``shapes`` where
    given: at hd 256 the fp32 form runs on the unpacked CUDA-core bodies
    (`flash_bwd_plan`'s ``form``), its bias through an fp32 pre-pass.
    With ``flips``, a bf16 bias gradient is also allowed the ds rounding
    flips its rows carry (`_dbias_flip_tol`)."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa
    from rocm_apex_tpu_torch.ops._build import sm_count

    gen = torch.Generator(device=dev).manual_seed(seed)
    if nh is None:
        nh = TRAIN["num_attention_heads"]
        hd = TRAIN["hidden_size"] // nh
    scale, seed = 1.0 / math.sqrt(hd), 77
    for B, S, dt, with_bias, rate, causal in shapes or (
        (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16, True, 0.1, True),
        (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16, False, 0.0, True),
        (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16, True, 0.0, True),
        (4, 1000, torch.bfloat16, True, 0.1, True),
        (4, 1000, torch.bfloat16, True, 0.1, False),
        (4, TRAIN_SEQ, torch.float32, True, 0.1, True),
        (BERT_BATCH, BERT_SEQ, torch.bfloat16, True, 0.0, False),
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
            return planned_qkv_fwd_plain(qkv, bias, causal, scale, rate,
                                         seed)

        x = qkv if bias is None else qkv + bias.view(nh, 3 * hd)
        q, k, v = (t.contiguous() for t in
                   x.permute(0, 2, 1, 3).split(hd, dim=-1))

        def flib(q=q, k=k, v=v, rate=rate, causal=causal):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  dropout_p=rate)

        o, lse = fkern()
        plan = fa.flash_fwd_plan(B * nh, S, S, hd, causal, sm_count(dev), dt)
        route = check_fwd_route(fkern, plan, dt, f"flash fwd {name}",
                                prepass=with_bias)
        yield dict(
            kernel="flash_attention_qkv_fwd", case=f"{name} [{route}]",
            dtype=dt, cmp=attn_compare(
                (o, lse), fplain(),
                [planned_qkv_fwd_plain(qkv, bias, causal, scale, rate, seed,
                                       abs_v=True)[0], None]),
            kern=fkern, plain=fplain, lib=flib,
            nbytes=nbytes(qkv, bias, o, lse),
            ops=4 * hd * pairs, headline=headline, iters=10, plain_iters=2,
            breakdown=dt == torch.bfloat16,
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
        bplan = fa.flash_bwd_plan(B, S, nh, hd, causal, dt)
        check(bplan["route"] == ("wgmma" if half_float(dt)
                                 else "cuda_cores"),
              f"flash bwd {name}: planned on the {bplan['route']} route")
        if bplan["route"] == "wgmma":
            check(_same_bits([t for t in got if t is not None],
                             [t for t in bkern() if t is not None]),
                  f"flash bwd {name}: two launches differ")
        if bplan["form"] == "unpacked":  # fp32 at hd 256
            broute = check_launches(bkern, UNPACKED_BWD_ROUTE_KERNELS,
                                    bplan["route"], f"flash bwd {name}",
                                    "qkv_bias_f32_kernel", with_bias)
        else:
            broute = check_launches(bkern, BWD_ROUTE_KERNELS,
                                    bplan["route"], f"flash bwd {name}",
                                    "qkv_bias_kernel",
                                    with_bias and bplan["route"] == "wgmma")
        ref = bplain()
        extra = [None, None if bias is None else _l1_tol(
            ref[0].float().abs().sum(dim=(0, 1)).reshape(-1))]
        l1 = (packed_grad_l1(qkv, bias, o, lse, do, causal, scale, rate,
                             seed) if half_float(dt) else None)
        if flips and bias is not None and l1 is not None:
            extra[1] = extra[1] + _dbias_flip_tol(l1)
        yield dict(
            kernel="flash_attention_qkv_bwd", case=f"{name} [{broute}]",
            dtype=dt, cmp=attn_compare(got, ref, [l1, None], extra),
            kern=bkern, plain=bplain,
            lib=blib, nbytes=nbytes(qkv, bias, o, lse, do, *got),
            ops=10 * hd * pairs, headline=headline, iters=5, plain_iters=2,
            extra_timings=dict(library_fwd_ms=flib),
            breakdown=dt == torch.bfloat16,
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
               torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-9),
               torch.float16: dict(rtol=2.0 ** -10, atol=2.0 ** -24)}
# fp16 holds dg's smallest terms (the softmax at vocab 30592 is about 3e-5,
# below fp16's least normal 6.1e-5) as subnormals, a step of 2^-24 apart:
# one fp16 step there is that absolute step, not 2^-10 of the value
# the sum of |dg| over a case, divided by its rows (about 2): last-bit
# flips of single elements move it by a few 1e-6 of itself, a wrong
# factor by its error
XENT_DG_L1_RTOL = 1e-4


def xent_cases(dev, cases=None):
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
    for rows, v, dt, eps in cases or (
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
                   torch.bfloat16: dict(rtol=2.0 ** -7, atol=2e-6),
                   torch.float16: dict(rtol=2.0 ** -10, atol=2e-6)}
# the new master and its compute copy: `LAMB_STEP_RTOL` of |old master| +
# |applied step| as atol (the two may cancel), and for a bf16 copy one
# ulp of the value besides
LAMB_STEP_RTOL = 1e-5
LAMB_COPY_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
                  torch.float16: 2.0 ** -10}


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


def lamb_cases(dev, cases=None):
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

    if cases is None:
        lamb_frozen_check(dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    s1 = torch.tensor(_LAMB_SCALARS + [1.0], device=dev)
    s2 = s1[[3, 4, 5, 7]].contiguous()
    bf, f32 = torch.bfloat16, torch.float32
    mixed = [(1024, 1024), (1001, 1023)] + [(256, 512), (512, 384)] * 19
    for what, shapes, gdt, mdt, wd, adam_w, copy in cases or (
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
        headline = n == 100 and gdt != torch.float16

        # stage 1: equal copies through kernel and plain version
        km, kv, rm, rv = (_clones(t) for t in (ms, vs, ms, vs))
        rsum = torch.empty((n, 2), device=dev)
        ksum = ok.lamb_leaves_stage1(ps, gs, km, kv, s1, wds, adam_w)
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
            return ok.lamb_leaves_stage1(*next(k1), s1, wds, adam_w,
                                         out=tsum)

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
        ok.lamb_leaves_stage2(kp, km, kv, s2, lr_ratios, wds, adam_w,
                              model_outs=kc)
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
            ok.lamb_leaves_stage2(tp, tm, tv, s2, lr_ratios, wds, adam_w,
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


def unpacked_cases(dev, cases=None, seed=9):
    """The unpacked flash kernels (forward, backward, dbias) against
    their plain versions, bf16 and fp32, at the paths' shapes: masked
    BERT-Large (B 8 x 8 heads, S 512, hd 128, q/k/v read in place from a
    (B, S, 8, 384) projection, the (8, 512, 512) padding bias from
    `bert_lengths`, so whole query rows are masked; with dropout 0.1 as
    the masked step runs it, and without), the whole-prompt prefill's
    causal window (bh 8, S 768), sq != sk ragged (200 x 333, hd 64, bias
    rows nb = 1 and nb = bh, causal and not), varlen with rows shorter
    than one tile, the dbias kernel (compute_dbias=True; bf16 at masked
    BERT with and without dropout 0.1, the dropout form heading row 10)
    and an lse cotangent, among them a context-parallel ring hop's
    shapes (16 x 1024 x 1024, hd 128, full and causal, bf16 and fp32).
    The library yardstick is SDPA with the bias as a float mask:
    forward, forward + backward (and its backward alone, fwd + bwd less
    fwd in the same call), and for dbias forward + backward with a
    mask that needs its gradient. Every forward case is checked against
    the plan's route (`check_fwd_route`: the bf16 ones on the wgmma pipe,
    split where the plan splits, launched twice for equal bits), every
    backward case against `flash_unpacked_bwd_plan`'s by the kernels a
    call launches (the launch tables; bf16: the wgmma backward pipe's two passes,
    launched twice for equal bits, the dbias call's too; fp32: the CUDA
    cores), and every dbias call against `flash_dbias_plan`'s
    (`DBIAS_ROUTE_KERNELS`: bf16 the wgmma ring, fp32 the CUDA cores),
    launched twice for equal bits."""
    from rocm_apex_tpu_torch.models.bert import bert_extended_attention_mask
    from rocm_apex_tpu_torch.models.gpt import padding_bias
    from rocm_apex_tpu_torch.ops import flash_attention as fa
    from rocm_apex_tpu_torch.ops._build import sm_count

    gen = torch.Generator(device=dev).manual_seed(seed)
    H = BERT["num_attention_heads"]
    D = BERT["hidden_size"] // H
    B, S = BERT_BATCH, BERT_SEQ
    mask = padding_mask(bert_lengths(B), S).to(dev)
    bert_bias = padding_bias(bert_extended_attention_mask(mask), B, S)
    seed = 31
    cases = cases or [
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
        ("masked BERT, dbias, dropout 0.1", (B, H, S, S, D), torch.bfloat16,
         "bert", False, None, 0.1, True, False, True, False),
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
        # a context-parallel hop (B 2 x 8 heads of 128, 1024 tokens a
        # rank): full and causal, with the lse cotangent that the ring's
        # merge hands each hop's backward; bf16 as the ring attention
        # runs it, fp32 as the context-parallel GPT does
        ("ring hop, lse cotangent", (2, 8, 1024, 1024, 128),
         torch.bfloat16, None, False, None, 0.0, False, True, False, False),
        ("ring hop causal, lse cotangent", (2, 8, 1024, 1024, 128),
         torch.bfloat16, None, True, None, 0.0, False, True, False, False),
        ("ring hop, lse cotangent", (2, 8, 1024, 1024, 128),
         torch.float32, None, False, None, 0.0, False, True, False, False),
        ("ring hop causal, lse cotangent", (2, 8, 1024, 1024, 128),
         torch.float32, None, True, None, 0.0, False, True, False, False),
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
            o, lse = planned_fwd_plain(flat(q), flat(k), flat(v), bias,
                                       causal, scale, lens, rate, seed)
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
        l1 = planned_fwd_plain(flat(q), flat(k), flat(v).abs(), bias, causal,
                               scale, lens, rate, seed)[0].view(q.shape)
        plan = fa.flash_fwd_plan(bh, sq, sk, d, causal, sm_count(dev), dt)
        route = check_fwd_route(fkern, plan, dt, f"unpacked fwd {label}")
        yield dict(
            kernel="flash_unpacked_fwd", case=f"{label} [{route}]",
            dtype=dt, cmp=attn_compare((o, lse), ref, [l1, None], extra),
            kern=fkern,
            plain=fplain, lib=flib,
            nbytes=nbytes(q, k, v, bias, lens, o, lse), ops=4 * d * pairs,
            headline=headline, iters=10, plain_iters=2,
            breakdown=dt == torch.bfloat16,
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
        got = bkern()
        bplan = fa.flash_unpacked_bwd_plan(bh, sq, sk, d, causal, dt)
        check(bplan["route"] == ("wgmma" if half_float(dt)
                                 else "cuda_cores"),
              f"unpacked bwd {label}: planned on the {bplan['route']} route")
        if bplan["route"] == "wgmma":
            check(_same_bits(got, bkern()),
                  f"unpacked bwd {label}: two launches differ")
        broute = check_launches(bkern, UNPACKED_BWD_ROUTE_KERNELS,
                                bplan["route"], f"unpacked bwd {label}")
        l1 = [None] * 3
        if half_float(dt):
            l1 = [m.view(t.shape) for m, t in zip(grad_l1(
                flat(q), flat(k), flat(v), bias, flat(o), lse, flat(do),
                causal, scale, lens, rate, seed, dlse), (q, k, v))]
        yield dict(
            kernel="flash_unpacked_bwd", case=f"{label} [{broute}]",
            dtype=dt, cmp=attn_compare(got, bplain(), l1), kern=bkern,
            plain=bplain,
            lib=blib, nbytes=nbytes(q, k, v, bias, lens, o, lse, do, dlse,
                                    q, k, v),
            ops=10 * d * pairs, headline=headline, iters=5, plain_iters=2,
            extra_timings=(dict(library_fwd_ms=flib) if blib is not None
                           else {}),
            breakdown=dt == torch.bfloat16,
        )
        if not want_db:
            continue

        # dbias: checked through the whole backward (on the pipe, delta
        # written by its dq pass where the plan names the buffer), timed
        # alone (delta from torch, as the dq pass computes it)
        def bkern_db(q=q, k=k, v=v, bias=bias, o=o, lse=lse, do=do,
                     dlse=dlse, causal=causal, lens=lens, rate=rate,
                     scale=scale):
            return fa._unpacked_bwd(q, k, v, bias, o, lse, do, dlse, causal,
                                    scale, lens, rate, seed, True, bshd=True)

        full = bkern_db()
        got = full[3]
        if bplan["route"] == "wgmma":
            check(fa.flash_unpacked_bwd_plan(bh, sq, sk, d, causal, dt,
                                             True)["delta"] == (bh, sq),
                  f"unpacked bwd {label}: the plan names no delta buffer")
            check(_same_bits(full, bkern_db()),
                  f"unpacked bwd {label}, dbias: two launches differ")
            check_launches(bkern_db, UNPACKED_BWD_ROUTE_KERNELS,
                           bplan["route"], f"unpacked bwd {label}, dbias")
        del full
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
        dplan = fa.flash_dbias_plan(nb, bh // nb, sq, sk, d, causal, dt)
        check(dplan["route"] == ("wgmma" if half_float(dt)
                                 else "cuda_cores"),
              f"dbias {label}: planned on the {dplan['route']} route")
        check(torch.equal(dkern(), dkern()),
              f"dbias {label}: two launches differ")
        droute = check_launches(dkern, DBIAS_ROUTE_KERNELS, dplan["route"],
                                f"dbias {label}")
        yield dict(
            kernel="flash_dbias", case=f"{label} [{droute}]", dtype=dt,
            cmp=compare((got,), (ref_db,), [_l1_tol(l1)]), kern=dkern,
            plain=dplain, lib=dlib,
            nbytes=nbytes(q, k, v, bias, lens, lse, do, delta, got),
            ops=4 * d * pairs,
            # the model's shape with its dropout heads row 10
            headline=(dt == torch.bfloat16 and bias_kind == "bert"
                      and rate > 0.0),
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


def _seg_tables(fs, fn, seg, causal, what):
    """Runs fn (a training segment kernel's call) with
    `fs._seg_workspace` recording the workspace each launch is handed, and
    holds what the pre-passes wrote there to
    `fs.flash_segments_tables_plain` word for word."""
    made, make = [], fs._seg_workspace

    def record(plan, device):
        made.append(make(plan, device))
        return made[-1]

    fs._seg_workspace = record
    try:
        fn()
    finally:
        fs._seg_workspace = make
    torch.cuda.synchronize()
    want = fs.flash_segments_tables_plain(seg, causal)
    check(len(made) == 1, f"{what}: {len(made)} workspaces, expected 1")
    got = made[0].cpu()
    bad = int((got != want).sum()) if got.shape == want.shape else -1
    check(bad == 0, f"{what}: the segment tables differ from their plain "
          f"version ({bad} of {want.numel()} words; -1: the sizes)")


def seg_train_cases(dev, cases=None, seed=13):
    """The training segment attention (forward; backward, a dq and a dk/dv
    pass) against its plain versions: bench.py's fmha batch (17408 tokens,
    8 heads x 64, bf16, q/k/v read in place from the packed (total, 3, h,
    d) qkv), causal (the path's form) and not; masked BERT-Large's lengths
    packed (8 heads x 128, not causal); fp32 on a small ragged batch with
    an empty sequence; ids out of order (every tile range then spans
    several ids, and a range test must still skip no live pair). The
    plain versions run one head at a time. Each case is checked against
    `flash_segments_plan`'s route by the kernels a call launches (the launch tables)
    (bf16: the forward pipe, or the backward pipe's two passes, with the
    segment pre-passes; fp32: the CUDA-core bodies) and launched twice for
    the same bits. In bf16 the tables the pre-passes wrote (each tile's
    walk, the units' order, the id ranges; `_seg_tables`), in the forward
    and again in the backward, must equal `flash_segments_tables_plain`'s
    word for word. The operations count every head's attended pairs.
    Beside each: the bound, the plain time, one PyTorch call (SDPA on a
    jagged nested tensor where it takes the case, else SDPA on the padded
    batch with the length mask; `library` says which) and, for the
    forward, the serving read's warp-a-row kernel on the same inputs
    (`row3_ms`, the rows route of `flash_segments_serve_plan`)."""
    from rocm_apex_tpu_torch.ops import flash_attention_segments as fs

    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(1)
    shuffled = rng.permutation(np.repeat(np.arange(9), 4)).tolist()
    cases = cases or [
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
        pairs = h * _seg_pairs(seg, causal)
        label = (f"{name}, {'causal' if causal else 'not causal'} ({h}, "
                 f"{total}, {d}) {str(dt)[6:]}")
        plan = fs.flash_segments_plan(h, total, d, dt)
        check(plan["route"] == ("wgmma" if half_float(dt)
                                else "cuda_cores") and plan["splits"] == 1,
              f"seg_train {label}: planned {plan['route']}, "
              f"{plan['splits']} split(s)")

        def fkern(q=q, k=k, v=v, seg=seg, causal=causal, scale=scale):
            return fs._seg_fwd(q, k, v, seg, causal, scale, token_major=True)

        def fplain(q=q, k=k, v=v, seg=seg, causal=causal, scale=scale):
            return _per_head(
                lambda q, k, v: fs.flash_attention_segments_plain(
                    q, k, v, seg, causal, scale), q, k, v)

        def frow3(q=q, k=k, v=v, seg=seg, causal=causal, scale=scale):
            return fs._serve_rows(q, k, v, seg, causal, scale)

        flib, blib, lib_form = _seg_library(qkv, do, lens, seg, ids, causal,
                                            scale)
        o, lse = fkern()
        # the route, the same bits twice, the pre-passes' tables
        route = check_launches(fkern, SEG_FWD_ROUTE_KERNELS, plan["route"],
                               f"seg_train fwd {label}")
        check(_same_bits((o, lse), fkern()),
              f"seg_train fwd {label}: two launches differ")
        if plan["route"] == "wgmma":
            _seg_tables(fs, fkern, seg, causal, f"seg_train fwd {label}")
        ref = fplain()
        l1 = _per_head(lambda q, k, v: fs.flash_attention_segments_plain(
            q, k, v.abs(), seg, causal, scale), q, k, v)[0]
        yield dict(
            kernel="flash_segments_fwd", case=f"{label} [{route}]", dtype=dt,
            cmp=attn_compare((o, lse), ref, [l1, None],
                             [None, LSE_L1_RTOL * ref[1].abs()]),
            kern=fkern, plain=fplain, lib=flib, library=lib_form,
            extra_timings=dict(row3_ms=frow3),
            nbytes=nbytes(q, k, v, seg, o, lse), ops=4 * d * pairs,
            headline=headline, iters=10, plain_iters=1,
            breakdown=dt == torch.bfloat16,
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

        l1 = [None] * 3
        if half_float(dt):
            l1 = _per_head(lambda q, k, v, o, lse, do: grad_l1(
                q, k, v, fs._segment_bias(seg, q.device), o, lse, do, causal,
                scale), q, k, v, o, lse, do)
        got = bkern()
        broute = check_launches(bkern, SEG_BWD_ROUTE_KERNELS, plan["route"],
                                f"seg_train bwd {label}")
        check(_same_bits(got, bkern()),
              f"seg_train bwd {label}: two launches differ")
        if plan["route"] == "wgmma":
            _seg_tables(fs, bkern, seg, causal, f"seg_train bwd {label}")
        yield dict(
            kernel="flash_segments_bwd", case=f"{label} [{broute}]",
            dtype=dt, cmp=attn_compare(got, bplain(), l1), kern=bkern,
            plain=bplain,
            lib=blib, library=lib_form,
            nbytes=nbytes(q, k, v, seg, o, lse, do, q, k, v),
            ops=10 * d * pairs, headline=headline, iters=5, plain_iters=1,
            breakdown=dt == torch.bfloat16,
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


def xent_bwd_cases(dev, cases=None):
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
    for rows, v, dt in cases or ((rows_full, vocab, torch.bfloat16),
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


# the scaled softmax kernels (ops/softmax.py): the forward in fp32 within
# 2e-6 absolute (probabilities in [0, 1]: both compute in fp32 and differ
# in the exp's last bits and the sum's order); a 16-bit output within one
# ulp of its own dtype; dx within 1e-5 of scale * sum_row |y * dy| (the
# row sum's order: its error reaches dx times scale * y <= scale) plus
# 1e-7, a 16-bit dx one ulp beside that
SOFTMAX_FWD_TOL = {torch.float32: dict(rtol=0.0, atol=2e-6),
                   torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-7),
                   torch.float16: dict(rtol=2.0 ** -10, atol=1e-7)}
SOFTMAX_BWD_RTOL, SOFTMAX_BWD_ATOL = 1e-5, 1e-7
# the fused-softmax path's shapes: the GPT train cell's causal scores
# (B 16 x 8 heads, S 1024) and masked BERT-Large's (B 8, 8 heads, S 512)
SOFTMAX_GPT = (TRAIN_BATCH * TRAIN["num_attention_heads"], TRAIN_SEQ,
               TRAIN_SEQ)
SOFTMAX_BERT = (BERT_BATCH, BERT["num_attention_heads"], BERT_SEQ, BERT_SEQ)


# the device kernels of each route of the softmax forwards' plan
# (csrc/softmax.cu, ops/softmax.py `softmax_fwd_plan`)
SOFTMAX_ROUTE_KERNELS = {"register": ("softmax_reg_kernel",),
                         "streaming": ("softmax_fwd_kernel",)}


def _causal_live(sq, sk):
    """Score columns the causal forward reads: min(r + 1, sk) a row."""
    return int(np.minimum(np.arange(1, sq + 1), sk).sum())


def softmax_cases(dev):
    """The three softmax kernels against their plain versions. Main path:
    the GPT train cell's causal forward (B 16 x 8 heads, S 1024, fp32
    scores, scale 1/sqrt(128)) and the backward on its output; masked
    BERT-Large's forward (B 8, 8 heads, S 512, fp32) under the bench
    lengths' extended mask (padded query rows fully masked) and the
    backward there. Others: the GPT shape in bf16 and fp16 (as
    `FusedScaleMaskSoftmax` takes them), sk 333 and 1 (the scalar form),
    rows of 8192 and 16384 keys (a block a row), the mask broadcasts
    (b, 1, 1, sk) and (1, 1, sq, sk) and none, sq != sk; for K2 also
    rows of 2048 and 2049 keys (the last register row, the first
    streaming one), a mask of last stride 2 (read a byte a column) and
    masked BERT's scores in bf16; for K1 also rows of 2048 and 2049 keys.
    Every K1 and K2 case is launched twice for the same bits and its
    route checked against `softmax_fwd_plan`. Library
    yardsticks: `torch.softmax(x, -1)` on the same tensor for the
    forwards (for the headline cases timed again, warm, after the rest),
    `torch._softmax_backward_data` for the backward. Bounds count what
    each call must move: the causal forward reads only the columns at or
    left of the diagonal."""
    from rocm_apex_tpu_torch.models.bert import bert_extended_attention_mask
    from rocm_apex_tpu_torch.ops import softmax as sm

    gen = torch.Generator(device=dev).manual_seed(15)

    def scores(shape, dt):
        return (3.0 * torch.randn(shape, device=dev, generator=gen)).to(dt)

    def fwd_case(name, case, x, mask, scale, headline=False, causal=False):
        if causal:
            def kern(x=x):
                return sm.softmax_causal_fwd(x, scale)

            def plain(x=x):
                return sm.causal_softmax_fwd_plain(x, scale)

            live = x.shape[0] * _causal_live(*x.shape[1:])
            nb = live * x.element_size() + nbytes(x)
        else:
            def kern(x=x, mask=mask):
                return sm.softmax_masked_fwd(x, mask, scale)

            def plain(x=x, mask=mask):
                return sm.masked_softmax_fwd_plain(x, mask, scale)

            live = x.numel()
            nb = nbytes(x, mask, x)
        got, ref = kern(), plain()
        cmp = compare((got,), (ref,), tols=[SOFTMAX_FWD_TOL[x.dtype]])
        # two launches give the same bits; the call's kernels are those of
        # the route `softmax_fwd_plan` names
        check(torch.equal(got, kern()), f"{name} {case}: two launches differ")
        if causal:
            upper = torch.ones(x.shape[1:], dtype=torch.bool,
                               device=dev).triu(1)
            if not bool((got[:, upper] == 0).all()):
                cmp["ratio"] = math.inf  # the upper triangle is exactly 0
            plan = sm.softmax_fwd_plan(x.shape[0] * x.shape[1], x.shape[2],
                                       x.dtype, False, None,
                                       aligned=x.data_ptr() % 16 == 0)
        else:
            plan = sm._masked_plan_of(
                x, None if mask is None else sm._expand_mask(mask, x))
        route = check_launches(kern, SOFTMAX_ROUTE_KERNELS, plan["route"],
                               f"{name} {case}")
        case = (f"{case}, {route}"
                + (f", {plan['mask']} mask" if plan["mask"] else ""))
        def lib(x=x):
            return torch.softmax(x, -1)

        return dict(kernel=name, case=case, dtype=x.dtype, cmp=cmp,
                    kern=kern, plain=plain, lib=lib,
                    library="torch.softmax(x, -1)",
                    nbytes=nb, ops=5 * live, headline=headline,
                    # the library call once more, after every other
                    # timing of the case: warm
                    extra_timings=({"library_again_ms": lib} if headline
                                   else {}),
                    iters=20 if x.numel() > 2**26 else 100, plain_iters=3)

    def bwd_case(case, y, scale, headline=False):
        dy = torch.randn(y.shape, device=dev, generator=gen).to(y.dtype)

        def kern(y=y, dy=dy):
            return sm.softmax_bwd(y, dy, scale)

        def plain(y=y, dy=dy):
            return sm.softmax_bwd_plain(y, dy, scale)

        got, ref = kern(), plain()
        mass = scale * (y.float() * dy.float()).abs().sum(-1, keepdim=True)
        tol = dict(SOFTMAX_FWD_TOL[y.dtype])
        if y.dtype == torch.float32:
            tol["atol"] = SOFTMAX_BWD_ATOL
        cmp = compare((got,), (ref,), extra=[SOFTMAX_BWD_RTOL * mass],
                      tols=[tol])
        if not bool((got[y == 0] == 0).all()):
            cmp["ratio"] = math.inf  # dx is exactly 0 where y is
        return dict(kernel="softmax_bwd", case=case, dtype=y.dtype, cmp=cmp,
                    kern=kern, plain=plain,
                    lib=lambda y=y, dy=dy: torch._softmax_backward_data(
                        dy, y, -1, y.dtype),
                    library="torch._softmax_backward_data",
                    nbytes=nbytes(y, dy, y), ops=5 * y.numel(),
                    headline=headline,
                    iters=20 if y.numel() > 2**26 else 100, plain_iters=3)

    gpt_scale = 1.0 / math.sqrt(TRAIN["hidden_size"]
                                // TRAIN["num_attention_heads"])
    bert_scale = 1.0 / math.sqrt(BERT["hidden_size"]
                                 // BERT["num_attention_heads"])
    # the main path: the GPT cell, fp32
    x = scores(SOFTMAX_GPT, torch.float32)
    yield fwd_case("softmax_causal_fwd", f"GPT {SOFTMAX_GPT} fp32, causal",
                   x, None, gpt_scale, headline=True, causal=True)
    y = sm.softmax_causal_fwd(x, gpt_scale)
    del x
    yield bwd_case(f"GPT {SOFTMAX_GPT} fp32, on the causal y", y, gpt_scale,
                   headline=True)
    del y
    # masked BERT-Large, fp32, the bench lengths
    mask = bert_extended_attention_mask(
        padding_mask(bert_lengths(BERT_BATCH), BERT_SEQ).to(dev))
    x = scores(SOFTMAX_BERT, torch.float32)
    yield fwd_case("softmax_masked_fwd",
                   f"masked BERT {SOFTMAX_BERT} fp32, mask {tuple(mask.shape)}"
                   f" (padded queries fully masked)", x, mask, bert_scale,
                   headline=True)
    yield bwd_case(f"masked BERT {SOFTMAX_BERT} fp32, on the masked y",
                   sm.softmax_masked_fwd(x, mask, bert_scale), bert_scale)
    # 16-bit scores at the GPT shape
    for dt in (torch.bfloat16, torch.float16):
        x = scores(SOFTMAX_GPT, dt)
        yield fwd_case("softmax_causal_fwd",
                       f"GPT {SOFTMAX_GPT} {str(dt)[6:]}, causal", x, None,
                       gpt_scale, causal=True)
        yield bwd_case(f"GPT {SOFTMAX_GPT} {str(dt)[6:]}",
                       sm.softmax_causal_fwd(x, gpt_scale), gpt_scale)
        del x
    # odd and tiny key counts: the scalar form
    for shape in ((16, 333, 333), (4, 7, 1)):
        x = scores(shape, torch.float32)
        yield fwd_case("softmax_causal_fwd", f"{shape} fp32, causal", x,
                       None, 0.3, causal=True)
        m = torch.rand((2, 1) + shape[1:], device=dev, generator=gen) < 0.2
        x4 = scores((2, 3) + shape[1:], torch.bfloat16)
        yield fwd_case("softmax_masked_fwd",
                       f"{(2, 3) + shape[1:]} bf16, mask {tuple(m.shape)}",
                       x4, m, 0.3)
        yield bwd_case(f"{shape} fp32", sm.softmax_causal_fwd(x, 0.3), 0.3)
    # long rows: a block a row
    x = scores((1, 8192, 8192), torch.float32)
    yield fwd_case("softmax_causal_fwd", "(1, 8192, 8192) fp32, causal", x,
                   None, 0.1, causal=True)
    del x
    m = torch.rand((2, 1, 1, 16384), device=dev, generator=gen) < 0.1
    x = scores((2, 2, 64, 16384), torch.float32)
    yield fwd_case("softmax_masked_fwd",
                   "(2, 2, 64, 16384) fp32, mask (2, 1, 1, 16384)", x, m, 0.1)
    yield bwd_case("(2, 2, 64, 16384) fp32",
                   sm.softmax_masked_fwd(x, m, 0.1), 0.1)
    # the register rows at their longest, the streaming rows past them
    for sk in (2048, 2049):
        m = torch.rand((2, 1, 1, sk), device=dev, generator=gen) < 0.1
        yield fwd_case("softmax_masked_fwd",
                       f"(2, 4, 32, {sk}) fp32, mask (2, 1, 1, {sk})",
                       scores((2, 4, 32, sk), torch.float32), m, 0.1)
        yield fwd_case("softmax_causal_fwd", f"(2, {sk}, {sk}) fp32, causal",
                       scores((2, sk, sk), torch.float32), None, 0.1,
                       causal=True)
    # a mask read through a last stride of 2 (the strided form)
    m = (torch.rand((2, 1, 64, 1024), device=dev, generator=gen)
         < 0.2)[..., ::2]
    yield fwd_case("softmax_masked_fwd",
                   "(2, 4, 64, 512) fp32, mask (2, 1, 64, 1024)[..., ::2]",
                   scores((2, 4, 64, 512), torch.float32), m, 0.5)
    # masked BERT-Large's scores in bf16
    x = scores(SOFTMAX_BERT, torch.bfloat16)
    yield fwd_case("softmax_masked_fwd",
                   f"masked BERT {SOFTMAX_BERT} bf16, mask "
                   f"{tuple(mask.shape)}", x, mask, bert_scale)
    del x
    # mask broadcasts and sq != sk
    m = torch.rand((1, 1, 100, 200), device=dev, generator=gen) < 0.3
    x = scores((2, 4, 100, 200), torch.float32)
    yield fwd_case("softmax_masked_fwd",
                   "(2, 4, 100, 200) fp32, mask (1, 1, 100, 200)", x, m, 0.5)
    yield fwd_case("softmax_masked_fwd", "(2, 4, 100, 200) fp32, no mask",
                   x, None, 0.5)
    for shape in ((16, 300, 512), (16, 512, 300)):
        yield fwd_case("softmax_causal_fwd", f"{shape} bf16, causal",
                       scores(shape, torch.bfloat16), None, 0.2, causal=True)


# ---------------------------------------------------------------------------
# the packed optimizer path: rows 14 and 15 (ops/multi_tensor.py,
# ops/optim_kernels.py's packed updates)
# ---------------------------------------------------------------------------

PACKED_KERNELS = ("scale", "scale_sumsq", "axpby", "row_sumsq", "adam_update",
                  "sgd_update", "adagrad_update", "novograd_update",
                  "lamb_stage1", "lamb_stage2")
# the case hyperparameters: of order 1 (lr 0.5, not a training step's
# 1e-4) with inputs of order 1, so that every output is of order 1 and
# `TOL`'s fp32 atol 1e-4 is 1e-4 of it; Adam's [lr, b1, 1-b1, b2, 1-b2,
# eps, bc1, bc2 (step 3), gs]
_PK_ADAM = [0.5, 0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8, 1 - 0.9 ** 3,
            1 - 0.999 ** 3, 0.5]
_PK_LAMB1 = [0.9, 0.999, 1.0 - 0.999, 0.1, 1e-6, 1 - 0.9 ** 3,
             1 - 0.999 ** 3, 0.5, 0.7]
_PK_SGD = [0.5, 0.9, 0.1, 0.0, 0.5]
_PK_ADAGRAD = [0.5, 1e-10, 0.5]
_PK_NOVOGRAD = [0.5, 0.95, 0.05, 1e-8, 1 - 0.95 ** 3, 1 - 0.98 ** 3, 0.5]
_PK_SCALE = 2.0 ** -16  # the dynamic scaler's first 1 / loss_scale
# a row sum: 1e-5 of its L1 mass (`_l1_tol`), the padding rows' exact 0s
# with a floor that keeps 0 / 0 out of the ratio
_PK_SUMS_TOL = dict(rtol=0.0, atol=1e-30)


def gpt_train_spec():
    """The PackSpec of the train cell's model copy (bf16, one group):
    every leaf of `convert.random_params`'s GPT tree."""
    from rocm_apex_tpu_torch.convert import flatten_params, random_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig
    from rocm_apex_tpu_torch.ops.packing import build_pack_spec

    cfg = GPTConfig(**TRAIN, params_dtype=torch.float32, dtype=torch.bfloat16)
    shapes = {k: v.shape for k, v in
              flatten_params(random_params(cfg, seed=0)["params"]).items()}
    return build_pack_spec({k: torch.empty(s, dtype=torch.bfloat16,
                                           device="meta")
                            for k, s in shapes.items()})


def _live_mask(group, dev):
    """True on the live elements of a group buffer: not a row tail, not a
    padding row."""
    from rocm_apex_tpu_torch.ops.packing import WIDTH

    live = torch.zeros(group.rows * WIDTH, dtype=torch.bool, device=dev)
    for ls in group.leaf_specs:
        live[ls.row_start * WIDTH:ls.row_start * WIDTH + ls.numel] = True
    return live.view(group.rows, WIDTH)


def _pk_buf(live, gen, scale=1.0, dtype=torch.float32, positive=False):
    x = torch.randn(live.shape, device=live.device, generator=gen) * scale
    if positive:
        x = x.abs()
    return torch.where(live, x, 0.0).to(dtype)


def _pk_col(group, live, gen, scale=0.1):
    """A (rows, 1) per-tensor column: one value a leaf, 0 on padding."""
    from rocm_apex_tpu_torch.optimizers._common import per_tensor_to_columns

    vals = torch.rand(len(group.leaf_specs), device=live.device,
                      generator=gen) * scale + scale
    return per_tensor_to_columns(group, vals)


def _yardstick(name, fn):
    """``fn``, a library yardstick, or None where this PyTorch lacks the
    op or its CUDA form (the case then reports no library time)."""
    if fn is None:
        return None
    try:
        fn()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        log(f"  no library yardstick {name}: {str(e).splitlines()[0][:120]}")
        return None
    return fn


def packed_cases(dev, half=torch.bfloat16):
    """Each of the ten kernels of rows 14 and 15 against its plain version
    at two sizes: the train cell's packed buffer (every leaf of the bench
    GPT, 135M elements, one bf16 group: its gradients bf16, masters and
    moments fp32, as `PackedOptimizerStep` holds them), and a ragged
    3-leaf tree (a leaf of 2.5 rows, one under a row, a scalar; bf16
    gradients and fp32 ones). On the ragged tree: an inf and a nan in the
    last live row trip the nonfinite flag of scale, scale_sumsq and axpby
    (kernel and plain version alike, and a clean buffer does not); Adam's
    skip slot with an inf gradient leaves delta 0 and m, v bit for bit;
    and every output is exactly 0 on the row tails and padding rows.
    Outputs are held to `TOL`, the row sums to 1e-5 of their L1 mass. The
    bound counts bytes (Adam and LAMB stage 1 28 B an element in fp32,
    scale_sumsq from bf16 6 B, stage 2 8 B, the row sums 4 B). Library
    yardsticks: one PyTorch call doing the same update or pass in place
    where there is one (`torch._fused_adamw_`, `_fused_sgd_`,
    `_fused_adagrad_`, the amp unscale, `torch.add`,
    `torch.linalg.vector_norm(dim=1)`, u times a pre-scaled column)."""
    from rocm_apex_tpu_torch.ops import multi_tensor as mt
    from rocm_apex_tpu_torch.ops import optim_kernels as ok
    from rocm_apex_tpu_torch.ops.packing import (PackedTree, PackSpec,
                                                 build_pack_spec)

    gen = torch.Generator(device=dev).manual_seed(14)
    f32 = torch.float32
    gpt = gpt_train_spec()
    rag = build_pack_spec({"w": torch.empty(5, 512, device="meta"),
                           "b.bias": torch.empty(300, device="meta"),
                           "s": torch.empty((), device="meta")})
    sizes = [("the train cell's buffer "
              f"({sum(ls.numel for ls in gpt.groups[0].leaf_specs)} "
              f"elements, {gpt.n_leaves} leaves)", gpt, True)]
    sizes.append(("a ragged 3-leaf tree", rag, False))

    def tree_of(group, buf):
        """``buf`` as a packed tree of one group."""
        return PackedTree([buf], PackSpec(None, (group,),
                                          len(group.leaf_specs)))

    for size, spec, headline in sizes:
        group = spec.groups[0]
        live = _live_mask(group, dev)
        dead = ~live
        iters = 20 if headline else 100
        plain_iters = 2 if headline else 10
        # fp32 gradients once, in the bf16 pass
        gdts = (half,) if headline or half != torch.bfloat16 else (half, f32)
        # the train buffer heads its kernels' lines in the bf16 pass
        main, headline = headline, headline and half == torch.bfloat16

        def case(kernel, name, outs, refs, kern, plain, lib, nbytes_,
                 tols=None, extra=None, library=None, dtype=f32):
            for o in outs:
                if o is not None and o.dim() == 2 and o.shape[1] > 1:
                    check(not bool(o[dead].any()), f"{kernel} {name}: a "
                          f"row tail or padding row is not 0")
            return dict(kernel=kernel, case=f"{size}, {name}", dtype=dtype,
                        cmp=compare(outs, refs, extra, tols), kern=kern,
                        plain=plain, lib=lib, nbytes=nbytes_,
                        ops=8 * group.rows * 1024, headline=headline,
                        iters=iters, plain_iters=plain_iters,
                        library=library)

        # ---- row 14: scale, scale_sumsq, axpby, row sums; the gradients
        # at the dynamic scaler's first scale, so the outputs are of order 1
        # fp16 holds at most 65504: its gradients come scaled by 2^10
        # (a scale the dynamic scaler settles at), bf16's by 2^16
        pk = _PK_SCALE if half == torch.bfloat16 else 2.0 ** -10
        pk_name = f"2^{int(math.log2(pk))}"
        s = torch.tensor([pk], device=dev)
        a1 = torch.ones(1, device=dev)
        for gdt in gdts:
            x = _pk_buf(live, gen, 1.0 / pk, gdt)
            t = tree_of(group, x)
            out, found = mt.scale_packed(t, s, f32)
            ro, rfound = mt.scale_plain(x, s, f32)
            check(not bool(found) and not bool(rfound),
                  "scale: a clean buffer tripped the flag")
            # a copy: the amp unscale scales it in place at every call
            x32 = x.to(torch.float32, copy=True)
            amp_flag = torch.zeros(1, device=dev)
            yield case(
                "scale", f"{str(gdt)[6:]} -> float32, s {pk_name}",
                list(out.buffers), [ro],
                lambda t=t: mt.scale_packed(t, s, f32),
                lambda x=x: mt.scale_plain(x, s, f32),
                lambda x32=x32, amp_flag=amp_flag:
                    torch._amp_foreach_non_finite_check_and_unscale_(
                        [x32], amp_flag, s),
                nbytes(x, out.buffers[0]), library="the amp unscale, in "
                "place on an fp32 copy", dtype=gdt)
            out, found, (rsq,) = mt.scale_sumsq_packed(t, s, f32)
            ro, _, rr = mt.scale_plain(x, s, f32, sumsq=True)
            check(not bool(found), "scale_sumsq: a clean buffer tripped "
                  "the flag")
            yield case(
                "scale_sumsq", f"{str(gdt)[6:]} -> float32, s {pk_name}",
                [out.buffers[0], rsq], [ro, rr],
                lambda t=t: mt.scale_sumsq_packed(t, s, f32),
                lambda x=x: mt.scale_plain(x, s, f32, sumsq=True), None,
                nbytes(x, out.buffers[0], rsq),
                tols=[None, _PK_SUMS_TOL], extra=[None, _l1_tol(rr)],
                dtype=gdt)
            y = _pk_buf(live, gen)
            ty = tree_of(group, y)
            out, found = mt.axpby_packed(ty, t, 1.0, pk, f32)
            ro, _ = mt.axpby_plain(y, x, a1, s, f32)
            check(not bool(found), "axpby: a clean buffer tripped the flag")
            yield case(
                "axpby", f"float32 + {pk_name} x {str(gdt)[6:]} -> float32",
                list(out.buffers), [ro],
                lambda ty=ty, t=t: mt.axpby_packed(ty, t, 1.0, pk,
                                                   f32),
                lambda y=y, x=x: mt.axpby_plain(y, x, a1, s, f32),
                lambda y=y, x=x: torch.add(y, x, alpha=pk),
                nbytes(x, y, out.buffers[0]),
                library="torch.add(y, x, alpha=b)")
            if not main:
                # an inf, then a nan, in the last live element of the
                # last live row: every pass's flag trips
                last = max(ls.row_start * 1024 + ls.numel - 1
                           for ls in group.leaf_specs)
                for bad in (float("inf"), float("nan")):
                    xb = x.clone()
                    xb.view(-1)[last] = bad
                    tb = tree_of(group, xb)
                    flags = [bool(mt.scale_packed(tb, s, f32)[1]),
                             bool(mt.scale_sumsq_packed(tb, s, f32)[1]),
                             bool(mt.axpby_packed(ty, tb, 1.0, 1.0, f32)[1]),
                             bool(mt.scale_plain(xb, s, f32)[1])]
                    log(f"  {size}, {str(gdt)[6:]}: {bad} in the last live "
                        f"row: flags scale, scale_sumsq, axpby, plain "
                        f"{flags}")
                    check(all(flags), f"{bad} did not trip every flag")
        p = _pk_buf(live, gen)
        r = mt.row_sumsq(p)
        rr = mt.row_sumsq_plain(p)
        yield case("row_sumsq", "float32 masters", [r], [rr],
                   lambda p=p: mt.row_sumsq(p),
                   lambda p=p: mt.row_sumsq_plain(p),
                   lambda p=p: torch.linalg.vector_norm(p, dim=1),
                   nbytes(p, r), tols=[_PK_SUMS_TOL], extra=[_l1_tol(rr)],
                   library="torch.linalg.vector_norm(dim=1), the row norms")

        # ---- row 15: the updates, fp32 masters and states
        wd = _pk_col(group, live, gen)
        # the headline gradients fp32 (the unscaled bf16 step's), an fp16
        # pass's in fp16 (`half`: rows 14 and 15 at the O2 step's type)
        for gdt in ((f32,) if headline else (half,) if main
                    or half != torch.bfloat16 else (half, f32)):
            p = _pk_buf(live, gen)
            g = _pk_buf(live, gen, 1.0, gdt)
            m = _pk_buf(live, gen)
            v = _pk_buf(live, gen, positive=True)
            gname = f"grad {str(gdt)[6:]}"
            for skip in ([0.0] if main else [0.0, 1.0]):
                sv = ok.scalar_vector(_PK_ADAM + [skip], dev)
                outs = ok.adam_update(p, g, m, v, wd, sv, True)
                refs = ok.adam_plain(p, g, m, v, wd, sv, True)
                pl, gl = p.clone(), g.float()
                ml, vl = m.clone(), v.clone()
                step = torch.tensor(3.0, device=dev)
                yield case(
                    "adam_update", f"{gname}, AdamW, skip slot {skip}", outs,
                    refs,
                    lambda sv=sv, p=p, g=g, m=m, v=v: ok.adam_update(
                        p, g, m, v, wd, sv, True),
                    lambda sv=sv, p=p, g=g, m=m, v=v: ok.adam_plain(
                        p, g, m, v, wd, sv, True),
                    _yardstick("torch._fused_adamw_", lambda pl=pl, gl=gl,
                               ml=ml, vl=vl, step=step: torch._fused_adamw_(
                                   [pl], [gl], [ml], [vl], [], [step],
                                   lr=1e-3, beta1=0.9, beta2=0.999,
                                   weight_decay=0.01, eps=1e-8, amsgrad=False,
                                   maximize=False)),
                    nbytes(p, g, m, v, *outs), library="torch._fused_adamw_"
                    " in place, fp32 gradients")
            if not main:
                # the skip slot with an inf and a nan gradient: frozen
                gi = g.clone()
                gi[0, 0], gi[1, 1] = float("inf"), float("nan")
                d, m2, v2 = ok.adam_update(
                    p, gi, m, v, wd, ok.scalar_vector(_PK_ADAM + [1.0], dev),
                    True)
                frozen = (not bool(d.any()) and torch.equal(m2, m)
                          and torch.equal(v2, v))
                log(f"  {size}, {gname}: Adam skip slot with an inf "
                    f"gradient: delta, m, v "
                    f"{'bit-frozen' if frozen else 'CHANGED'}")
                check(frozen, "Adam's skip slot changed a buffer")
            sv = ok.scalar_vector(_PK_SGD, dev)
            outs = ok.sgd_update(p, g, m, wd, sv, False, False, True)
            refs = ok.sgd_plain(p, g, m, wd, sv, False, False, True)
            fused_sgd = getattr(torch, "_fused_sgd_", None)
            pl, gl, bl = p.clone(), g.float(), m.clone()
            yield case(
                "sgd_update", f"{gname}, momentum 0.9, dampening 0.1", outs,
                refs,
                lambda sv=sv, p=p, g=g, m=m: ok.sgd_update(
                    p, g, m, wd, sv, False, False, True),
                lambda sv=sv, p=p, g=g, m=m: ok.sgd_plain(
                    p, g, m, wd, sv, False, False, True),
                _yardstick("torch._fused_sgd_", None if fused_sgd is None
                           else (lambda pl=pl, gl=gl, bl=bl: fused_sgd(
                               [pl], [gl], [bl], weight_decay=0.01,
                               momentum=0.9, lr=1e-3, dampening=0.1,
                               nesterov=False, maximize=False,
                               is_first_step=False))),
                nbytes(p, g, m, *outs), library="torch._fused_sgd_ in place")
            sv = ok.scalar_vector(_PK_ADAGRAD, dev)
            outs = ok.adagrad_update(p, g, v, wd, sv, True)
            refs = ok.adagrad_plain(p, g, v, wd, sv, True)
            fused_adagrad = getattr(torch, "_fused_adagrad_", None)
            pl, gl, hl = p.clone(), g.float(), v.clone()
            yield case(
                "adagrad_update", f"{gname}, decoupled decay", outs, refs,
                lambda sv=sv, p=p, g=g, v=v: ok.adagrad_update(
                    p, g, v, wd, sv, True),
                lambda sv=sv, p=p, g=g, v=v: ok.adagrad_plain(
                    p, g, v, wd, sv, True),
                _yardstick("torch._fused_adagrad_",
                           None if fused_adagrad is None else (
                               lambda pl=pl, gl=gl, hl=hl, step=step:
                               fused_adagrad([pl], [gl], [hl], [step],
                                             lr=1e-3, lr_decay=0.0,
                                             weight_decay=0.01, eps=1e-10,
                                             maximize=False))),
                nbytes(p, g, v, *outs), library="torch._fused_adagrad_ in "
                "place")
            vcol = _pk_col(group, live, gen, 1.0)
            sv = ok.scalar_vector(_PK_NOVOGRAD, dev)
            for reg in (False,) if main else (False, True):
                outs = ok.novograd_update(p, g, m, vcol, wd, sv, reg)
                refs = ok.novograd_plain(p, g, m, vcol, wd, sv, reg)
                yield case(
                    "novograd_update", f"{gname}, reg_inside_moment {reg}",
                    outs, refs,
                    lambda sv=sv, p=p, g=g, m=m, reg=reg: ok.novograd_update(
                        p, g, m, vcol, wd, sv, reg),
                    lambda sv=sv, p=p, g=g, m=m, reg=reg: ok.novograd_plain(
                        p, g, m, vcol, wd, sv, reg),
                    None, nbytes(p, g, m, *outs))
            sv = ok.scalar_vector(_PK_LAMB1, dev)
            outs = ok.lamb_stage1(p, g, m, v, wd, sv, True)
            refs = ok.lamb1_plain(p, g, m, v, wd, sv, True)
            yield case(
                "lamb_stage1", f"{gname}, AdamW, clip 0.7", outs, refs,
                lambda sv=sv, p=p, g=g, m=m, v=v: ok.lamb_stage1(
                    p, g, m, v, wd, sv, True),
                lambda sv=sv, p=p, g=g, m=m, v=v: ok.lamb1_plain(
                    p, g, m, v, wd, sv, True),
                None, nbytes(p, g, m, v, *outs))
            u = outs[0]
            ratio = _pk_col(group, live, gen, 1.0)
            lr = torch.tensor([0.5], device=dev)
            scaled = -0.5 * ratio
            (d,) = ok.lamb_stage2(u, ratio, lr)
            yield case(
                "lamb_stage2", f"{gname}'s u, a ratio a tensor", [d],
                list(ok.lamb2_plain(u, ratio, lr)),
                lambda u=u, ratio=ratio: ok.lamb_stage2(u, ratio, lr),
                lambda u=u, ratio=ratio: ok.lamb2_plain(u, ratio, lr),
                lambda u=u, scaled=scaled: torch.mul(u, scaled),
                nbytes(u, d), library="torch.mul(u, column): the column "
                "pre-scaled by -lr")


# ---------------------------------------------------------------------------
# the fused bottleneck (row 17)
# ---------------------------------------------------------------------------

# bench.py rn50 on an accelerator (bench.py:119-213): ResNet-50, NHWC
# (128, 224, 224, 3), 1000 classes, bf16 under amp O5 with
# FusedAdam(1e-3, weight_decay=1e-4); `fused=1` routes the 13 stride-1
# bottlenecks through the fused kernels. Its five stride-1 block shapes:
# (name, H = W, Cin, Cmid, Cout, downsample)
RN50_BATCH, RN50_SIZE, RN50_CLASSES = 128, 224, 1000
BNECK_SHAPES = [
    ("layer1_0", 56, 64, 64, 256, True),
    ("layer1_1,2", 56, 256, 64, 256, False),
    ("layer2_1..3", 28, 512, 128, 512, False),
    ("layer3_1..5", 14, 1024, 256, 1024, False),
    ("layer4_1,2", 7, 2048, 512, 2048, False),
]
BNECK_HEADLINE = "layer3_1..5"  # the shape the step launches most
BNECK_KERNELS = ("bneck_mm_fwd", "bneck_conv3_fwd", "bneck_mm_bwd",
                 "bneck_conv3_bwd")
# wrapper calls a fused step: 3 1x1 forwards (conv1, conv3, the
# downsample of layer1_0) and backwards a block, 1 3x3 each
RN50_FUSED_CALLS_PER_STEP = {"bneck_mm_fwd": 27, "bneck_conv3_fwd": 13,
                             "bneck_mm_bwd": 27, "bneck_conv3_bwd": 13}
# fp32 sums kernel vs plain version: within 1e-5 of their L1 mass
# (`_l1_tol`), each with its own order over up to 401408 pixels
BNECK_SUMS_TOL = dict(rtol=0.0, atol=1e-30)


def _bneck_inputs(gen, dev, n, h, cin, cmid, cout, dt):
    """Seeded raw maps and BN coefficients of one block at (n, h, h):
    values of order 1 (raw conv outputs), cotangents of 1e-2, BN scales
    about 1, shifts about 0.1, finalize slopes 1e-3, kernels He-scaled."""
    def rnd(*shape, scale=1.0, shift=0.0, dtype=dt):
        return (shift + scale * torch.randn(*shape, device=dev,
                                            generator=gen)).to(dtype)

    def vec(c, s=0.1, sh=0.0):
        return rnd(c, scale=s, shift=sh, dtype=torch.float32)

    m = n * h * h
    return dict(
        m=m,
        x=rnd(m, cin), y1=rnd(m, cmid), y2=rnd(m, cmid), y3=rnd(m, cout),
        z=rnd(m, cout), e3=rnd(m, cout, scale=1e-2),
        e1=rnd(m, cmid, scale=1e-2), e2=rnd(m, cmid, scale=1e-2),
        w1=rnd(cin, cmid, scale=math.sqrt(2.0 / cin)),
        w2=rnd(3, 3, cmid, cmid, scale=math.sqrt(2.0 / (9 * cmid))),
        w3=rnd(cmid, cout, scale=math.sqrt(2.0 / cmid)),
        wd=rnd(cin, cout, scale=math.sqrt(2.0 / cin)),
        a1=vec(cmid, 0.1, 1.0), c1=vec(cmid), a2=vec(cmid, 0.1, 1.0),
        c2=vec(cmid), mu1=vec(cmid), rs1=vec(cmid, 0.1, 1.0),
        mu2=vec(cmid), rs2=vec(cmid, 0.1, 1.0),
        k_mid=(vec(cmid, 0.1, 1.0), vec(cmid, 1e-3), vec(cmid, 1e-3)),
        k_out=(vec(cout, 0.1, 1.0), vec(cout, 1e-3), vec(cout, 1e-3)),
    )


def _sum_tols(n):
    return [None] + [BNECK_SUMS_TOL] * n


def _bneck_block_times(dev, gen, n, h, cin, cmid, cout):
    """The fused block's forward + backward and the unfused `Bottleneck`'s
    (cuDNN convolutions, the BN as torch ops) at the same shape in bf16,
    from seeded weights: the block-level yardstick."""
    from rocm_apex_tpu_torch.contrib.bottleneck import (Bottleneck,
                                                        FusedBottleneck)

    g = torch.Generator().manual_seed(17)
    x = torch.randn(n, h, h, cin, device=dev, generator=gen).to(
        torch.bfloat16)
    dz = (1e-2 * torch.randn(n, h, h, cout, device=dev, generator=gen)).to(
        torch.bfloat16)
    fused = FusedBottleneck(cin, cmid, cout, dtype=torch.bfloat16,
                            device=dev, generator=g)
    plain = Bottleneck(cin, cmid, cout, dtype=torch.bfloat16, device=dev,
                       generator=g)

    def run(blk):
        return lambda: blk(x).backward(dz)

    return dict(block_fused_ms=run(fused), block_unfused_ms=run(plain))


def _k1_library(x2, w, a, b, stats, dt):
    u = x2 if a is None else torch.relu(x2 * a.to(dt) + b.to(dt))
    y = u @ w
    if not stats:
        return y
    yf = y.float()
    return torch.stack((yf.sum(0), (yf * yf).sum(0)))


def _k3_library(e, w, x2, kw, dt):
    from rocm_apex_tpu_torch.ops import fused_bottleneck as fb

    dz = fb._finalized(e, kw.get("z"), kw.get("y_fin"))
    pro = kw.get("prologue")
    u = x2 if pro is None else torch.relu(x2 * pro[0].to(dt) + pro[1].to(dt))
    return dz @ w.t(), u.t() @ dz


def bottleneck_cases(dev, shapes=None):
    """The four kernels of row 17 against their plain versions, each call
    of a fused block with its flags: K1 conv1 (no prologue), conv3 (the
    prologue) and the downsample; K2 conv2; K3 conv3's backward (pre-mask,
    finalize, prologue, reductions), conv1's (finalize) and the
    downsample's (pre-mask, finalize); K4 conv2's. At the five stride-1
    block shapes of bench.py's ResNet-50 at B 128 (layer3's the headline:
    five blocks a step), then a ragged M (3 x 7 x 7: no tile divides it)
    with the bare forms too (no prologue, no statistics; the products
    alone), W = 2 (4 x 2 x 2, every tap at an edge), fp32 (8 x 14 x 14),
    K4 alone at a ragged split (3 x 13 x 13 at 128 channels: the wgrad's
    pixel splits end inside image rows, checked against the plan) and K1,
    K2 and K3 alone at widths the pipe does not take (48 and 80 channels:
    the staged core, checked against `mm_fwd_plan`, `conv3_fwd_plan` and
    `mm_bwd_plan`; every other bf16 K1, K2 and K3 case is checked to take
    the pipe, K1 and K2 by the kernels a call launches (the launch tables), their
    pre-pass exactly under a prologue). Every K3 and K4 case, and every
    bf16 K1 and K2 case on the pipe, launches twice on the same inputs and
    must repeat its outputs bit for bit. Outputs
    in bf16 held to one ulp + 1e-5 (`TOL`), fp32 to 1e-4, the sums over the pixels (statistics,
    dw, r1, r2) to 1e-5 of their L1 mass. Bounds: each input read once,
    each output written once; operations 2 M K N a product (x 9 for the 3x3, x 2 for a backward's
    dgrad and wgrad). Library yardsticks, never called by the port:
    torch.matmul on the (M, K) view with the prologue, finalize and
    statistics as torch ops (1x1); F.conv2d, torch.nn.grad.conv2d_input +
    conv2d_weight in channels_last bf16 (cuDNN) with the same (3x3).
    Beside each full-size shape's K2 case: the whole fused block's forward
    + backward against the unfused `Bottleneck` (`block_fused_ms`,
    `block_unfused_ms`)."""
    from rocm_apex_tpu_torch.ops import fused_bottleneck as fb
    from rocm_apex_tpu_torch.ops._build import sm_count

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(17)
    bf = torch.bfloat16
    shapes = shapes or [(nm, RN50_BATCH, h, cin, cmid, cout, ds, bf, None)
                        for nm, h, cin, cmid, cout, ds in BNECK_SHAPES] + [
               ("ragged M 3 x 7 x 7", 3, 7, 64, 64, 256, True, bf, None),
               ("W 2: 4 x 2 x 2", 4, 2, 64, 64, 256, False, bf, None),
               ("fp32 8 x 14 x 14", 8, 14, 256, 64, 256, False,
                torch.float32, None),
               ("ragged split 3 x 13 x 13", 3, 13, 128, 128, 512, False, bf,
                ("K4",)),
               ("staged widths 3 x 7 x 7", 3, 7, 48, 48, 80, True, bf,
                ("K1", "K2", "K3")),
               # counts that are no multiple of 16 (8: the grain; 20: a
               # tail of 4 padded to 24, `channel_plan`)
               ("widths 8 3 x 7 x 7", 3, 7, 8, 8, 8, True, bf, None),
               ("widths 20 3 x 7 x 7", 3, 7, 20, 20, 20, True,
                torch.float32, None)]
    sms = sm_count(dev)
    for nm, n, h, cin, cmid, cout, ds, dt, only in shapes:
        full = n == RN50_BATCH
        headline = nm == BNECK_HEADLINE and dt == bf
        # the pipe takes 2-byte types at multiples of 64 (the plans' rule)
        pipe = half_float(dt) and all(c % 64 == 0 for c in (cin, cmid, cout))
        cplan = fb.channel_plan((cin, cmid, cout), n * h * h, dt)
        t = _bneck_inputs(gen, dev, n, h, cin, cmid, cout, dt)
        m = t["m"]
        lab = (f"{nm}: M {m}, {str(dt)[6:]}"
               + (", channels padded to "
                  f"{cplan['kernel_counts']}" if cplan["route"] == "padded"
                  else ""))
        runs = only or ("K1", "K2", "K3", "K4")
        staged_widths = "K4" not in runs and "K3" in runs
        k4_only = runs == ("K4",)
        if staged_widths:
            # every 1x1 backward of this block: widths the pipe does not
            # take (48, 80: not multiples of 64)
            check(all(fb.mm_bwd_plan(m, k, nn, dt, sms)["route"] == "staged"
                      for k, nn in ((cmid, cout), (cin, cmid), (cin, cout))),
                  f"{nm}: a width here takes the pipe")
        if k4_only:
            plan = fb.conv3_bwd_plan(m, cmid, cmid, dt, sm_count(dev))
            cuts = [s * plan["split_len"] for s in range(1, plan["splits"])]
            check(any(c % h for c in cuts),
                  f"{nm}: no wgrad split ends inside an image row "
                  f"({plan['splits']} splits of {plan['split_len']})")

        def case(kernel, what, got, ref, kern, plain, lib, nbytes_, ops,
                 tols=None, extra=None, library=None, timings=None,
                 route=None):
            return dict(kernel=kernel, case=f"{lab}, {what.lstrip('*')}"
                        + (f" [{route}]" if route else ""),
                        dtype=dt, cmp=compare(got, ref, extra, tols),
                        kern=kern, plain=plain, lib=lib, nbytes=nbytes_,
                        ops=ops, headline=headline and what.startswith("*"),
                        iters=20 if full else 100,
                        plain_iters=2 if full else 10, library=library,
                        extra_timings=timings or {},
                        breakdown=full and kernel in ("bneck_mm_fwd",
                                                      "bneck_conv3_fwd",
                                                      "bneck_mm_bwd",
                                                      "bneck_conv3_bwd"))

        # ---- K1: the 1x1 forwards
        k1_calls = [] if "K1" not in runs else [
            ("conv1 (no prologue)", t["x"], t["w1"], None),
            ("*conv3 (prologue)", t["y2"], t["w3"], (t["a2"], t["c2"]))]
        if ds and "K1" in runs:
            k1_calls.append(("downsample (no prologue)", t["x"], t["wd"],
                             None))
        if not full and "K1" in runs:
            k1_calls.append(("bare product (no prologue, no statistics)",
                             t["x"], t["w1"], None))
        for what, x2, w, pro in k1_calls:
            stats = "no statistics" not in what
            a, b = pro if pro else (None, None)

            def k1(x2=x2, w=w, a=a, b=b, stats=stats):
                return fb.conv1x1_bn_act(x2, w, a, b, stats=stats)

            y, s = k1()
            got = [y, *s] if stats else [y]
            k1_plan = fb.mm_fwd_plan(m, w.shape[0], w.shape[1], dt, sms,
                                     prologue=a is not None)
            check(k1_plan["route"] == ("pipe" if pipe else "staged"),
                  f"{lab}, {what}: K1 planned on the {k1_plan['route']} "
                  f"route")
            if k1_plan["route"] == "pipe":
                y2, s2 = k1()
                check(_same_bits(got, [y2, *s2] if stats else [y2]),
                      f"{lab}, {what}: two K1 launches on the same inputs "
                      f"differ")
                del y2, s2
            route = check_launches(k1, K1_ROUTE_KERNELS, k1_plan["route"],
                                   f"{lab}, K1 {what}",
                                   "conv3_fwd_prepass_kernel",
                                   k1_plan["u"] is not None)
            ry, rs_ = fb.conv1x1_bn_act_plain(x2, w, a, b, stats=stats)
            ref, extra = [ry], [None]
            if stats:
                ref += list(rs_)
                extra += [_l1_tol(ry.float().abs().sum(0)), _l1_tol(rs_[1])]
            yield case(
                "bneck_mm_fwd", what, got, ref, k1,
                lambda x2=x2, w=w, a=a, b=b, stats=stats:
                    fb.conv1x1_bn_act_plain(x2, w, a, b, stats=stats),
                lambda x2=x2, w=w, a=a, b=b, stats=stats:
                    _k1_library(x2, w, a, b, stats, dt),
                nbytes(x2, w, a, b, y) + (8 * w.shape[1] if stats else 0),
                2 * m * w.shape[0] * w.shape[1],
                tols=_sum_tols(2) if stats else None, extra=extra,
                library="torch.matmul on the (M, K) view, the prologue and "
                "statistics as torch ops", route=route)

        # ---- K2: the 3x3 forward, and the block-level yardstick
        x4 = t["y1"].reshape(n, h, h, cmid)
        a1, c1, w2 = t["a1"], t["c1"], t["w2"]
        wcl = w2.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        k2_calls = [] if "K2" not in runs else [
            ("*conv2 (prologue)", (a1, c1), True)]
        if not full and "K2" in runs:
            k2_calls.append(("bare conv (no prologue, no statistics)",
                             (None, None), False))
        k2_plan = fb.conv3_fwd_plan(m, cmid, cmid, dt, sms)
        check(k2_plan["route"] == ("pipe" if pipe else "staged"),
              f"{lab}: K2 planned on the {k2_plan['route']} route")
        for what, (a, b), stats in k2_calls:
            def k2(x4=x4, w2=w2, a=a, b=b, stats=stats):
                return fb.conv3x3_bn_act(x4, w2, a, b, stats=stats)

            def k2_plain(x4=x4, w2=w2, a=a, b=b, stats=stats):
                return fb.conv3x3_bn_act_plain(x4, w2, a, b, stats=stats)

            y, s = k2()
            got = [y, *s] if stats else [y]
            if k2_plan["route"] == "pipe":
                y2, s2 = k2()
                check(_same_bits(got, [y2, *s2] if stats else [y2]),
                      f"{lab}, {what}: two K2 launches on the same inputs "
                      f"differ")
                del y2, s2
            route = check_launches(k2, K2_ROUTE_KERNELS, k2_plan["route"],
                                   f"{lab}, K2 {what}",
                                   "conv3_fwd_prepass_kernel",
                                   a is not None and k2_plan["route"] ==
                                   "pipe")
            ry, rs_ = k2_plain()
            if stats:

                def lib3(x4=x4, wcl=wcl, a1=a, c1=b):
                    u = torch.relu(x4 * a1.to(dt) + c1.to(dt))
                    yf = F.conv2d(u.permute(0, 3, 1, 2), wcl,
                                  padding=1).float()
                    return torch.stack((yf.sum((0, 2, 3)),
                                        (yf * yf).sum((0, 2, 3))))

                yield case(
                    "bneck_conv3_fwd", what, got, [ry, *rs_], k2, k2_plain,
                    lib3, nbytes(x4, w2, a, b, y) + 8 * cmid,
                    2 * m * 9 * cmid * cmid, tols=_sum_tols(2),
                    extra=[None, _l1_tol(ry.float().abs().sum((0, 1, 2))),
                           _l1_tol(rs_[1])],
                    library="F.conv2d channels_last (cuDNN), the prologue "
                    "and statistics as torch ops",
                    timings=(_bneck_block_times(dev, gen, n, h, cin, cmid,
                                                cout)
                             if full and dt == bf else None),
                    route=route)
            else:
                yield case(
                    "bneck_conv3_fwd", what, got, [ry], k2, k2_plain,
                    lambda x4=x4, wcl=wcl:
                        F.conv2d(x4.permute(0, 3, 1, 2), wcl, padding=1),
                    nbytes(x4, w2, y), 2 * m * 9 * cmid * cmid,
                    library="F.conv2d channels_last (cuDNN)", route=route)
            del y, s, got, ry, rs_

        # ---- K3: the 1x1 backwards
        k3_calls = [] if k4_only else [
            ("*conv3 (pre-mask, finalize, prologue, reductions)", t["e3"],
             t["w3"], t["y2"], dict(z=t["z"], y_fin=(t["y3"], *t["k_out"]),
                                    prologue=(t["a2"], t["c2"]),
                                    reduce_stats=(t["mu2"], t["rs2"]))),
            ("conv1 (finalize)", t["e1"], t["w1"], t["x"],
             dict(y_fin=(t["y1"], *t["k_mid"]))),
        ]
        if ds:
            k3_calls.append(("downsample (pre-mask, finalize)", t["e3"],
                             t["wd"], t["x"],
                             dict(z=t["z"], y_fin=(t["y3"], *t["k_out"]))))
        if not full and not k4_only:
            k3_calls.append(("bare products (dgrad, wgrad)", t["e1"],
                             t["w1"], t["x"], {}))
        for what, e, w, x2, kw in k3_calls:
            route = fb.mm_bwd_plan(m, w.shape[0], w.shape[1], dt,
                                   sms)["route"]
            check(route == ("pipe" if pipe else "staged"),
                  f"{lab}, {what}: K3 takes the {route} route")
            got = fb.conv1x1_bn_act_bwd(e, w, x2, **kw)
            again = fb.conv1x1_bn_act_bwd(e, w, x2, **kw)
            check(_same_bits([t_ for t_ in got if t_ is not None],
                             [t_ for t_ in again if t_ is not None]),
                  f"{lab}, {what}: two K3 launches on the same inputs "
                  f"differ")
            del again
            ref = fb.conv1x1_bn_act_bwd_plain(e, w, x2, **kw)
            dz = fb._finalized(e, kw.get("z"), kw.get("y_fin")).float()
            pro = kw.get("prologue")
            u = (x2 if pro is None else
                 torch.clamp_min(x2.float() * pro[0] + pro[1], 0).to(dt))
            extra = [None, _l1_tol(u.float().abs().t() @ dz.abs())]
            outs = 2
            if kw.get("reduce_stats") is not None:
                mu, rs = kw["reduce_stats"]
                gf = ref[0].float()
                extra += [_l1_tol(gf.abs().sum(0)), _l1_tol(
                    (gf * ((x2.float() - mu) * rs)).abs().sum(0))]
                outs = 4
                del gf
            del dz, u
            yield case(
                "bneck_mm_bwd", what, list(got[:outs]), list(ref[:outs]),
                lambda e=e, w=w, x2=x2, kw=kw:
                    fb.conv1x1_bn_act_bwd(e, w, x2, **kw),
                lambda e=e, w=w, x2=x2, kw=kw:
                    fb.conv1x1_bn_act_bwd_plain(e, w, x2, **kw),
                lambda e=e, w=w, x2=x2, kw=kw: _k3_library(e, w, x2, kw, dt),
                nbytes(e, w, x2, kw.get("z"), *(kw.get("y_fin") or ()),
                       *(kw.get("prologue") or ()),
                       *(kw.get("reduce_stats") or ()), *got),
                2 * 2 * m * w.shape[0] * w.shape[1],
                tols=_sum_tols(outs - 1), extra=extra,
                library="torch.matmul dgrad + wgrad, the finalize and "
                "prologue as torch ops", route=route)

        # ---- K4: the 3x3 backward
        if "K4" not in runs:
            del t
            continue
        e4 = t["e2"].reshape(n, h, h, cmid)
        yfin = (t["y2"].reshape(n, h, h, cmid), *t["k_mid"])
        pro, red = (a1, c1), (t["mu1"], t["rs1"])
        got = fb.conv3x3_bn_act_bwd(e4, w2, x4, yfin, pro, red)
        again = fb.conv3x3_bn_act_bwd(e4, w2, x4, yfin, pro, red)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{lab}: two K4 launches on the same inputs differ")
        del again
        ref = fb.conv3x3_bn_act_bwd_plain(e4, w2, x4, yfin, pro, red)
        l1_dw = fb._conv3_wgrad(fb._apply_dt(x4, *pro).float().abs(),
                                fb._finalized(e4, None, yfin).float().abs())
        gf = ref[0].float()
        extra = [None, _l1_tol(l1_dw), _l1_tol(gf.abs().sum((0, 1, 2))),
                 _l1_tol((gf * ((x4.float() - red[0]) * red[1])).abs().sum(
                     (0, 1, 2)))]
        del gf, l1_dw

        def lib4(e4=e4, x4=x4, wcl=wcl, yfin=yfin, pro=pro):
            dz = fb._finalized(e4, None, yfin).permute(0, 3, 1, 2)
            u = torch.relu(x4 * pro[0].to(dt) + pro[1].to(dt))
            gi = torch.nn.grad.conv2d_input(
                (n, cmid, h, h), wcl, dz, padding=1)
            gw = torch.nn.grad.conv2d_weight(
                u.permute(0, 3, 1, 2), wcl.shape, dz, padding=1)
            return gi, gw

        yield case(
            "bneck_conv3_bwd", "*conv2 (finalize, prologue, reductions)",
            list(got), list(ref),
            lambda e4=e4, w2=w2, x4=x4, yfin=yfin, pro=pro, red=red:
                fb.conv3x3_bn_act_bwd(e4, w2, x4, yfin, pro, red),
            lambda e4=e4, w2=w2, x4=x4, yfin=yfin, pro=pro, red=red:
                fb.conv3x3_bn_act_bwd_plain(e4, w2, x4, yfin, pro, red),
            lib4, nbytes(e4, w2, x4, *yfin, *pro, *red, *got),
            2 * 2 * m * 9 * cmid * cmid, tols=_sum_tols(3), extra=extra,
            library="torch.nn.grad.conv2d_input + conv2d_weight "
            "channels_last (cuDNN), the finalize and prologue as torch ops")
        del t, got, ref


def frame_cases(dev):
    """p's rounding, a case per bf16 flash kernel at its frame: each kernel
    at a shape of its path, q drawn 2.5 times wider than the model's so
    the softmax peaks and p's rounding shows, held to its plain version
    (p and ds rounded to bf16 as JAX rounds them, a forward's p against
    the running max after each key tile of the kernel's: 64 keys in the
    pipes and the serving read's tiles, 32 in the decode
    reads' row walks) by the share of
    elements more than one bf16 step off, at most `FRAME_SHARE`. Beside it
    each forward logs the share against the plain version at another frame
    (twice the kernel's, one span unsplit for the decode reads), which the
    kernel does not follow. The backward forms p from the final lse and
    has no frame."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa
    from rocm_apex_tpu_torch.ops import flash_attention_segments as fs
    from rocm_apex_tpu_torch.ops._build import sm_count

    gen = torch.Generator(device=dev).manual_seed(16)
    bf = torch.bfloat16
    nh, hd = 8, 128
    scale, seed = 1.0 / math.sqrt(hd), 5

    def randn(*shape, wide=1.0):
        return (wide * torch.randn(shape, device=dev, generator=gen)).to(bf)

    def case(kernel, what, kern, plain, other=None):
        got, ref = kern(), plain()
        shares = [_off_share(g, r) for g, r in zip(got, ref)
                  if g is not None and g.is_floating_point()
                  and g.dtype == bf]
        share = max(shares)
        what = f"{what}, share beyond one bf16 step {100 * share:.4f}%"
        if other is not None:
            what += (f" (at another frame "
                     f"{100 * _off_share(got[0], other()[0]):.3f}%)")
        err = max(max_err(g, r) for g, r in zip(got, ref) if g is not None
                  and g.dtype == bf)
        return dict(kernel=kernel, case=f"p rounding: {what}", dtype=bf,
                    cmp=dict(ratio=share / FRAME_SHARE, err=err,
                             ref_max=float(ref[0].float().abs().max())),
                    kern=kern, plain=plain, lib=None, nbytes=0, ops=0,
                    headline=False, iters=5, plain_iters=1)

    # rows 7a/8 and 9a/11: the packed forward and backward, the GPT train
    # cell's heads at B 2, bias, causal
    B, S = 2, 1024
    qkv = torch.randn(B, S, nh, 3 * hd, device=dev, generator=gen)
    qkv[..., :hd] *= 2.5
    qkv = qkv.to(bf)
    bias = randn(nh * 3 * hd, wide=0.1)
    do = randn(B, S, nh * hd)
    yield case("flash_attention_qkv_fwd", f"({B}, {S}, {nh}, 384) causal, "
               "frame 64",
               lambda: fa._flash_fwd(qkv, bias, True, scale, 0.0, seed),
               lambda: planned_qkv_fwd_plain(qkv, bias, True, scale, 0.0,
                                             seed),
               lambda: fa.flash_qkv_fwd_plain(qkv, bias, True, scale,
                                              frame=128))
    o, lse = fa._flash_fwd(qkv, bias, True, scale, 0.0, seed)
    yield case("flash_attention_qkv_bwd", f"({B}, {S}, {nh}, 384) causal",
               lambda: fa._flash_bwd(qkv, bias, o, lse, do, True, scale,
                                     0.0, seed)[:1],
               lambda: fa.flash_qkv_bwd_plain(qkv, bias, o, lse, do, True,
                                              scale)[:1])
    del qkv, o, lse, do
    # rows 7b and 9b: the unpacked forward and backward under masked
    # BERT's padding bias, (B 8, 8 heads, S 512)
    b, s_ = BERT_BATCH, BERT_SEQ
    lengths = bert_lengths(b)
    pbias = torch.zeros(b, s_, s_, device=dev)
    for i, n in enumerate(lengths):
        pbias[i, :, int(n):] = fa.NEG_INF
    q, k, v, dou = (randn(b * nh, s_, hd, wide=w) for w in (2.5, 1, 1, 1))
    view = [t.view(b, nh, s_, hd) for t in (q, k, v, dou)]
    yield case("flash_unpacked_fwd", f"({b}x{nh}, {s_}, {s_}, {hd}) padding "
               "bias, frame 64",
               lambda: (fa._flat(fa._unpacked_fwd(*view[:3], pbias, False,
                                                  scale, None, 0.0,
                                                  seed)[0]),),
               lambda: planned_fwd_plain(q, k, v, pbias, False, scale, None,
                                         0.0, seed),
               lambda: fa.flash_unpacked_fwd_plain(q, k, v, pbias, False,
                                                   scale, frame=128))
    o, lse = planned_fwd_plain(q, k, v, pbias, False, scale, None, 0.0, seed)
    yield case("flash_unpacked_bwd", f"({b}x{nh}, {s_}, {s_}, {hd}) padding "
               "bias",
               lambda: [fa._flat(t) for t in fa._unpacked_bwd(
                   *view[:3], pbias, o.view(view[0].shape), lse, view[3],
                   None, False, scale, None, 0.0, seed, False)[:3]],
               lambda: fa.flash_unpacked_bwd_plain(q, k, v, pbias, o, lse,
                                                   dou, False, scale)[:3])
    del q, k, v, dou, view, o, lse, pbias
    # rows 5 and 6: the decode grid (8 slots x 8 heads, capacity 1024),
    # contiguous and through page-16 pools
    lens = torch.tensor([CAPACITY, 700, 17, 513, 300, 64, 1000, 129],
                        dtype=torch.int32, device=dev)
    qd = randn(SLOTS, nh, hd, wide=2.5)
    kc, vc = randn(SLOTS, CAPACITY, nh, hd), randn(SLOTS, CAPACITY, nh, hd)
    plan = fa.decode_span_plan(SLOTS, nh, CAPACITY, sm_count(dev))
    yield case("flash_attention_decode", f"grid, {plan[0]} spans of "
               f"{plan[1]}, frame 32",
               lambda: fa.flash_attention_decode(qd, kc, vc, lens,
                                                 return_lse=True),
               lambda: fa.decode_spans_plain(qd, kc, vc, lens, scale, *plan),
               lambda: fa.flash_attention_decode_plain(qd, kc, vc, lens,
                                                       scale, frame=64))
    kp, vp, tab = _pools_from_cache(kc, vc, PAGE_SIZE,
                                    torch.Generator().manual_seed(16))
    yield case("flash_attention_decode_paged", f"grid, page {PAGE_SIZE}, "
               "frame 32",
               lambda: fa.flash_attention_decode_paged(qd, kp, vp, tab, lens,
                                                       return_lse=True),
               lambda: fa.decode_paged_spans_plain(qd, kp, vp, tab, lens,
                                                   scale, *plan),
               lambda: fa.flash_attention_decode_paged_plain(
                   qd, kp, vp, tab, lens, scale, frame=64))
    del kc, vc, kp, vp
    # row 3: the serving read (the 256-token chunk) and the training form;
    # row 4: the training backward (3 sequences, causal)
    ids = torch.from_numpy(chunk_slot_ids(BUDGET, SLOTS)[0]).to(dev)
    qs, ks, vs = (randn(nh, BUDGET, hd, wide=w) for w in (2.5, 1, 1))
    plan = fs.flash_segments_serve_plan(nh, BUDGET, hd, bf)
    yield case(fs.FLASH_SEGMENTS_SERVE.name, f"({nh}, {BUDGET}, {hd}) chunk, "
               f"causal, frame {plan['frame']}",
               lambda: fs.flash_attention_segments_with_lse(qs, ks, vs, ids,
                                                            True, scale),
               lambda: fs.flash_attention_segments_plain(
                   qs, ks, vs, ids, True, scale, plan["frame"]),
               lambda: fs.flash_attention_segments_plain(
                   qs, ks, vs, ids, True, scale, 2 * plan["frame"]))
    lens3 = [700, 213, 1135]
    seg = torch.from_numpy(np.repeat(np.arange(3), lens3).astype(
        np.int32)).to(dev)
    qt, kt, vt, dot = (randn(nh, sum(lens3), hd, wide=w)
                       for w in (2.5, 1, 1, 1))
    yield case("flash_segments_fwd", f"({nh}, {sum(lens3)}, {hd}) 3 "
               "sequences, causal, frame 64",
               lambda: fs._seg_fwd(qt, kt, vt, seg, True, scale),
               lambda: fs.flash_attention_segments_plain(qt, kt, vt, seg,
                                                         True, scale),
               lambda: fs.flash_attention_segments_plain(qt, kt, vt, seg,
                                                         True, scale, 128))
    ot, lt = fs._seg_fwd(qt, kt, vt, seg, True, scale)
    yield case("flash_segments_bwd", f"({nh}, {sum(lens3)}, {hd}) 3 "
               "sequences, causal",
               lambda: fs._seg_bwd(qt, kt, vt, seg, ot, lt, dot, True,
                                   scale),
               lambda: fs.flash_attention_segments_bwd_plain(
                   qt, kt, vt, seg, ot, lt, dot, True, scale))


# ---------------------------------------------------------------------------
# the head dims (PERF.md §6's head-dim forms): each flash kernel at hd 32,
# 80 and 256 (and 96, and 20, which the wrappers pad), bf16 and fp32,
# through the groups' own case generators at those shapes
# ---------------------------------------------------------------------------


def _hd_cases(cases, hd, rows=False):
    """The head-dim cases of a group, off the kernels line's headline (the
    models' own shapes head it), each with its instance's width (`rows`:
    the warp-a-row reads', whose widths include 32) and the operations at
    that width beside those at hd (`ops_width`)."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa

    for c in cases:
        # the serving read's rows route is a warp-a-row read too
        on_rows = rows or c["kernel"] == "flash_attention_segments_with_lse"
        width = fa.head_dim_plan(
            hd, fa.ROW_WIDTHS if on_rows else fa.PIPE_WIDTHS)["width"]
        c["headline"] = False
        c["hd"], c["width"] = hd, width
        c["ops_width"] = c["ops"] * width // hd
        yield c


def hd_flash_cases(dev):
    """The packed path at hd 256 (GPT-J's 16 heads): the train form (S
    2048, bias, dropout 0.1, causal), a ragged S not causal, and fp32
    (the unpacked CUDA-core bodies behind the fp32 bias pre-pass)."""
    bf, f32 = torch.bfloat16, torch.float32
    yield from _hd_cases(flash_cases(dev, 16, 256, shapes=(
        (1, 2048, bf, True, 0.1, True),
        (2, 1000, bf, True, 0.1, False),
        (1, 512, f32, True, 0.1, True),
        (1, 512, f32, False, 0.0, False),
    ), seed=41, flips=True), 256)


# name, (B, H, sq, sk, D), dtype, bias, causal, lens, rate, dbias, dlse,
# in-place projection views, headline (`unpacked_cases`)
HD_UNPACKED_CASES = [
    ("GPT-3 2.7B attention, dropout 0.1", (1, 32, 2048, 2048, 80),
     torch.bfloat16, None, True, None, 0.1, False, False, True, False),
    ("GPT-3 2.7B attention", (1, 4, 512, 512, 80), torch.float32, None,
     True, None, 0.0, False, False, True, False),
    ("hd 80, bias nb 1, dbias, dropout 0.1", (2, 4, 256, 256, 80),
     torch.bfloat16, 1, False, None, 0.1, True, False, False, False),
    ("hd 80 ragged, bias nb 1, dbias", (2, 2, 200, 333, 80), torch.float32,
     1, False, None, 0.0, True, False, False, False),
    ("recipe attention, dropout 0.1", (4, 8, 256, 256, 32), torch.bfloat16,
     None, True, None, 0.1, False, False, True, False),
    ("hd 32 ragged causal, bias nb bh, dbias", (2, 4, 200, 333, 32),
     torch.bfloat16, 8, True, None, 0.0, True, True, False, False),
    ("hd 32 ragged causal, bias nb bh, dbias", (2, 4, 200, 333, 32),
     torch.float32, 8, True, None, 0.1, True, True, False, False),
    ("hd 256, bias nb 1, dbias, lse cotangent", (1, 16, 1024, 1024, 256),
     torch.bfloat16, 1, False, None, 0.0, True, True, False, False),
    ("hd 256 ragged causal, bias nb bh, dbias", (2, 2, 200, 333, 256),
     torch.float32, 4, True, None, 0.1, True, True, False, False),
    ("hd 96 (GPT-NeoX), varlen", (2, 4, 300, 300, 96), torch.bfloat16, None,
     False, "lens", 0.0, False, False, False, False),
    ("hd 20 (padded), bias nb 1, dbias", (2, 2, 200, 333, 20),
     torch.bfloat16, 1, False, None, 0.0, True, False, False, False),
    ("hd 20 (padded) causal, bias nb 1, dbias", (2, 2, 200, 333, 20),
     torch.float32, 1, True, None, 0.0, True, False, False, False),
]


def hd_unpacked_cases(dev):
    for i, case in enumerate(HD_UNPACKED_CASES):
        yield from _hd_cases(unpacked_cases(dev, [case], seed=90 + i),
                             case[1][4])


def hd_seg_train_cases(dev):
    """The training segment kernels at the models' head dims: packed
    streams of GPT-3 2.7B's (32 heads of 80), the recipe's (8 of 32) and
    GPT-J's (16 of 256), bf16, causal; fp32 on the small ragged batch with
    an empty sequence at each head dim."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        ("GPT-3 2.7B heads", [700, 37, 0, 1024, 300], 32, 80, bf, True,
         None, False),
        ("recipe heads", [256, 256, 256, 100, 3], 8, 32, bf, True, None,
         False),
        ("GPT-J heads", [2048, 300, 64], 16, 256, bf, True, None, False),
        ("ragged, an empty sequence", FMHA_PARITY_LENS, 4, 80, f32, True,
         None, False),
        ("ragged, an empty sequence", FMHA_PARITY_LENS, 4, 32, f32, False,
         None, False),
        ("ragged, an empty sequence", FMHA_PARITY_LENS, 4, 256, f32, True,
         None, False),
    ]
    for i, case in enumerate(cases):
        yield from _hd_cases(seg_train_cases(dev, [case], seed=130 + i),
                             case[3])


# (heads, head_dim) of the serving reads' head-dim cases: the recipe's,
# GPT-3 2.7B's and GPT-J's; the decode read also at hd 20 (padded)
HD_SERVE_DIMS = ((8, 32), (32, 80), (16, 256))


def hd_seg_cases(dev):
    for i, (h, d) in enumerate(HD_SERVE_DIMS):
        yield from _hd_cases(seg_cases(dev, h, d, seed=20 + i), d)


def hd_decode_cases(dev):
    for i, (h, d) in enumerate(HD_SERVE_DIMS + ((4, 20),)):
        yield from _hd_cases(decode_cases(dev, h, d, seed=30 + i), d,
                             rows=True)


def hd_paged_cases(dev):
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("decode grid", 16, bf, False), ("decode grid", 16, f32, False),
             ("decode grid", 16, bf, True), ("chunk piece B", 16, bf, False)]
    for i, (h, d) in enumerate(HD_SERVE_DIMS):
        yield from _hd_cases(
            paged_decode_cases(dev, h, d, cases, seed=60 + i), d, rows=True)


# fp16, every row at its main path's shape (the O2 models' type), through
# each group's own generator: the bf16 rules in fp16's precision (`TOL`,
# `ROUND_STEPS`, the tables of the groups), on the plan's route, the
# tensor-core routes launched twice for the same bits. None heads its
# kernel's line. Bottleneck widths 8, 12, 40 and 13 run here too (12 and 13
# through `channel_plan`'s padded copy).
FP16 = torch.float16
FP16_CASES = dict(
    ln=lambda dev: ln_cases(dev, shapes=[
        (8, SERVE["hidden_size"], False, FP16),
        (BUDGET, SERVE["hidden_size"], True, FP16)]),
    seg=lambda dev: seg_cases(dev, dtypes=(FP16,)),
    decode=lambda dev: decode_cases(
        dev, SERVE["num_attention_heads"],
        SERVE["hidden_size"] // SERVE["num_attention_heads"],
        dtypes=(FP16,)),
    paged=lambda dev: paged_decode_cases(dev, cases=[
        ("decode grid", PAGE_SIZE, FP16, False),
        ("decode grid", PAGE_SIZE, FP16, True)]),
    train_ln=lambda dev: train_ln_cases(dev, dtypes=(FP16,), tail=False),
    ln_plain=lambda dev: ln_plain_cases(dev, dtypes=(FP16,)),
    flash=lambda dev: flash_cases(dev, shapes=(
        (TRAIN_BATCH, TRAIN_SEQ, FP16, True, 0.1, True),
        (BERT_BATCH, BERT_SEQ, FP16, True, 0.0, False))),
    xent=lambda dev: itertools.chain(
        xent_cases(dev, cases=[(BERT_BATCH * BERT_SEQ, BERT["vocab_size"],
                                FP16, 0.0)]),
        xent_bwd_cases(dev, cases=[(BERT_BATCH * BERT_SEQ,
                                    BERT["vocab_size"], FP16)])),
    lamb=lambda dev: lamb_cases(dev, cases=[
        ("the bench BERT's 100 leaves", bert_kernel_leaves(), FP16,
         torch.float32, 0.01, True, True)]),
    unpacked=lambda dev: unpacked_cases(dev, cases=[
        ("masked BERT, dbias, dropout 0.1",
         (BERT_BATCH, BERT["num_attention_heads"], BERT_SEQ, BERT_SEQ,
          BERT["hidden_size"] // BERT["num_attention_heads"]), FP16, "bert",
         False, None, 0.1, True, False, True, False)]),
    seg_train=lambda dev: seg_train_cases(dev, cases=[
        ("fmha batch", fmha_lengths(), FMHA_HEADS, FMHA_HD, FP16, True, None,
         False)]),
    packed=lambda dev: packed_cases(dev, half=FP16),
    bottleneck=lambda dev: bottleneck_cases(dev, shapes=[
        ("layer3_1..5", RN50_BATCH, 14, 1024, 256, 1024, False, FP16, None),
        ("widths 8 3 x 7 x 7", 3, 7, 8, 8, 8, True, FP16, None),
        ("widths 12 3 x 7 x 7", 3, 7, 12, 12, 12, True, FP16, None),
        ("widths 40 3 x 7 x 7", 3, 7, 40, 40, 40, True, FP16, None),
        ("widths 13 (odd) 3 x 7 x 7", 3, 7, 13, 13, 13, True, FP16, None)]),
)

CASE_GROUPS = dict(
    ln=ln_cases, seg=seg_cases, decode=decode_cases,
    paged=paged_decode_cases, train_ln=train_ln_cases,
    ln_plain=ln_plain_cases, flash=flash_cases,
    xent=lambda dev: itertools.chain(xent_cases(dev), xent_bwd_cases(dev)),
    lamb=lamb_cases,
    unpacked=lambda dev: itertools.chain(
        unpacked_cases(dev), unpacked_vs_packed_cases(dev)),
    seg_train=seg_train_cases, softmax=softmax_cases, packed=packed_cases,
    bottleneck=bottleneck_cases, frames=frame_cases)
# the head-dim forms of the flash kernels and every row's fp16 cases, run
# after the groups above (`--only kernels:hd+fp16` runs them alone)
HD_CASES = dict(seg=hd_seg_cases, decode=hd_decode_cases,
                paged=hd_paged_cases, flash=hd_flash_cases,
                unpacked=hd_unpacked_cases, seg_train=hd_seg_train_cases)
HD_GROUP, FP16_GROUP = "hd", "fp16"
ALL_GROUPS = {
    **CASE_GROUPS,
    HD_GROUP: lambda dev: itertools.chain(
        *(f(dev) for f in HD_CASES.values())),
    FP16_GROUP: lambda dev: itertools.chain(
        *(f(dev) for f in FP16_CASES.values()))}


# timed calls of a kernel-phase case that is not its kernel's headline,
# and of its plain version (both were 10, when the phase's side cases
# spent ~57 of its 188 s on an H100 in their timings)
SIDE_CASE_ITERS = 3
SIDE_PLAIN_ITERS = 2


def run_kernel_phase(dev, generators, profile=False):
    """Check and time each case as its generator yields it (the
    closures read the generator's loop variables). With ``profile``, a
    case marked ``breakdown`` also gets the device time of each kernel
    its call launches, over 5 calls (`profile_window`)."""
    out = []
    t_case = time.perf_counter()
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
        plain_iters = c.get("plain_iters", 10)
        if not c["headline"]:
            # a case the kernels line does not report: fewer timed calls,
            # to keep the smoke inside its time limit
            iters = min(iters, SIDE_CASE_ITERS)
            plain_iters = min(plain_iters, SIDE_PLAIN_ITERS)
        ms = device_ms(c["kern"], iters)
        call_ms = cuda_ms(c["kern"], iters)
        plain_ms = device_ms(c["plain"], plain_iters, warmup=1)
        lib_ms = (device_ms(c["lib"], iters) if c["lib"] is not None
                  else None)
        lib32_ms = (device_ms(c["lib32"], iters)
                    if c.get("lib32") is not None else None)
        b_ms, b_by = bound_ms(c["nbytes"], c["ops"], c["dtype"])
        extra = {k: device_ms(fn, iters)
                 for k, fn in c.get("extra_timings", {}).items()}
        if "ops_width" in c:
            # a head-dim case: its instance's width, and the bound of the
            # operations at that width (zero columns included) beside the
            # bound at hd
            extra.update(hd=c["hd"], width=c["width"],
                         bound_width_ms=bound_ms(c["nbytes"], c["ops_width"],
                                                 c["dtype"])[0])
        if lib_ms is not None and "library_fwd_ms" in extra:
            # the library's backward alone: fwd + bwd less fwd
            extra["library_bwd_ms"] = lib_ms - extra["library_fwd_ms"]
        if profile and c.get("breakdown"):
            extra["breakdown"] = profile_window(
                lambda c=c: [c["kern"]() for _ in range(5)],
                f"{c['kernel']} {c['case']}: 5 calls")["top_device_ms"]
        # the case's wall time: its inputs, plain reference, checks and
        # timings
        wall_s, t_case = time.perf_counter() - t_case, time.perf_counter()
        out.append(dict(
            wall_s=wall_s,
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
            + "".join(f"  {k} {t:.4f}" for k, t in extra.items()
                      if k != "breakdown"))
        for name, t in extra.get("breakdown", {}).items():
            log(f"      {t / 5:.4f} ms a call  {name}")
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


# the engine's own device syncs: its fetch of the sampled tokens, its
# blocking input copy (made on an idle stream, before a step's first
# launch) and its page-table push
ENGINE_SYNCS = ("_fetch", "_upload", "_push_table")


@contextlib.contextmanager
def sync_audit(*engs):
    """Every device sync in the window raises
    (``torch.cuda.set_sync_debug_mode("error")``: a ``.item()``, a
    ``nonzero``, a blocking copy either way), except inside the engines'
    `ENGINE_SYNCS`, whose calls are counted (summed over ``engs``, a
    router's replicas), and, with a tensor-parallel engine among them,
    inside `parallel_state.exchange` (the staged exchanges of the tensor
    group: a gloo collective copies its card tensors through host
    memory), counted by kind as ``exchange:<kind>`` (`exchange_count`
    sums them), and so too with no engine in a process group of more than
    one rank (a tensor- or data-parallel training step). Yields the
    counts.
    Without a card (a CPU rehearsal of the ranks) nothing can sync one,
    and the window only counts."""
    import torch.distributed as dist

    from rocm_apex_tpu_torch.transformer import parallel_state

    tp = any(getattr(eng, "tp", 1) > 1 for eng in engs) or (
        dist.is_initialized() and dist.get_world_size() > 1)
    counts = dict.fromkeys(ENGINE_SYNCS, 0)
    mode = (torch.cuda.set_sync_debug_mode if torch.cuda.is_available()
            else lambda _: None)

    def allowed(key, fn):
        def call(*a, **kw):
            name, n = key(*a)
            counts[name] = counts.get(name, 0) + n
            mode(0)
            try:
                return fn(*a, **kw)
            finally:
                mode("error")
        return call

    def engine_sync(eng, name):
        # a table push copies only when the mapping changed
        return lambda *_: (name, int(eng._table_dirty)
                           if name == "_push_table" else 1)

    for eng in engs:
        for name in ENGINE_SYNCS:
            setattr(eng, name, allowed(engine_sync(eng, name),
                                       getattr(eng, name)))
    exchange = parallel_state.exchange
    if tp:
        parallel_state.exchange = allowed(
            lambda kind, *_: (f"exchange:{kind}", 1), exchange)
    mode("error")
    try:
        yield counts
    finally:
        mode(0)
        parallel_state.exchange = exchange
        for eng in engs:
            for name in ENGINE_SYNCS:
                delattr(eng, name)


def exchange_count(counts):
    """The exchanges of every kind that `sync_audit` counted."""
    return sum(n for k, n in counts.items() if k.startswith("exchange:"))


def timed_serve(eng, prompts, max_new=MAX_NEW, audit=False, adapters=None,
                on_tick=None):
    """One timed serve of ``prompts`` x ``max_new`` greedy tokens on a
    warm engine: every kernel's launch count is set to 0 just before and
    read just after. Checks that every request ran to ``max_new``
    finite, in-vocabulary tokens; returns (metrics, the requests'
    tokens). ``host_fetches_per_tick``: the engine's reads of device
    values (its fetch of the sampled tokens) over its device steps.
    ``audit``: the serve runs under `sync_audit`, so a device sync
    outside the engine's `ENGINE_SYNCS` fails it; ``syncs_per_tick``
    counts those calls. ``adapters``: each prompt's adapter id (multi-LoRA
    engines). ``on_tick(tick)``: called after each step, inside the
    window (the monitor phase scrapes its exporter there)."""
    from rocm_apex_tpu_torch.ops._build import KERNELS

    vocab = eng.model.cfg.vocab_size
    eng.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (sync_audit(eng) if audit else contextlib.nullcontext()) as syncs:
        ids = [eng.add_request(p, max_new, adapter_id=a) for p, a in
               zip(prompts, adapters or [0] * len(prompts))]
        done, peak_pages, tick = {}, 0, 0
        while eng.has_work():
            for r in eng.step():
                done[r.request_id] = r
            peak_pages = max(peak_pages, eng.pages_used)
            tick += 1
            if on_tick is not None:
                on_tick(tick)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    results = [done[i] for i in ids]
    s = eng.stats()
    gen = sum(len(r.tokens) for r in results)
    ticks = int(s["mixed_steps"] + s["decode_only_steps"])
    check(all(r.finish_reason == "length" and len(r.tokens) == max_new
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
        tpot_ms_p95=float(np.percentile(
            [c["tpot_ms"] for c in eng.completions], 95)),
        host_fetches_per_tick=s["host_fetches"] / max(ticks, 1),
        mixed_ticks=int(s["mixed_steps"]),
        decode_only_ticks=int(s["decode_only_steps"]),
        ticks=ticks, mixed_tick_ms=s["prefill_ms_avg"],
        decode_tick_ms=s["decode_ms_avg"], launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        cache_bytes=eng.cache_bytes(),
    )
    if audit:
        res["syncs_per_tick"] = {k.lstrip("_"): n / max(ticks, 1)
                                 for k, n in syncs.items()}
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
    check(res["launches"]["flash_attention_segments_with_lse"] == 0,
          "the bf16 serve's chunks left the tile route "
          "(`flash_segments_serve_plan`)")
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
    engine's on the same prompts (the serve phase's, or a run here). The
    bf16 pages must give them in every request, as the reference promises
    (tests/L0/test_paging.py): the same chunks, the same GEMMs and one
    decode read for both caches (the paged read plans the contiguous
    read's split), so every logit has the same bits. The int8 and
    shared-prefix forms are counted, not asserted: int8 rounds K/V, and
    prefix sharing changes the chunk mix, so a bf16 GEMM over other rows
    may move a logit by an ulp and flip a near-tied token."""
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
        if form == "bf16":
            check(r["requests_matching_contiguous"] == len(ps),
                  f"bf16 pages: {r['requests_matching_contiguous']} of "
                  f"{len(ps)} requests give the contiguous serve's tokens "
                  f"(the paged cache must reproduce them exactly)")
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
    check(res["launches"]["flash_attention_segments_with_lse"] == 0
          and res["launches"]["flash_segments_serve"] == 0,
          "the whole-prompt serve launched a chunk kernel")
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


def _trainer(cfg, device, lr, opt=None, tree=None):
    """``(step, state, scaler state)`` over seeded random weights (or the
    param ``tree``), with ``opt`` (default: bench.py's
    MixedPrecisionAdam(lr, wd 0.01))."""
    from rocm_apex_tpu_torch.amp import LossScaler
    from rocm_apex_tpu_torch.convert import (random_params,
                                             train_state_from_jax_params)
    from rocm_apex_tpu_torch.optimizers import MixedPrecisionAdam
    from rocm_apex_tpu_torch.train import make_train_step

    if opt is None:
        opt = MixedPrecisionAdam(lr, weight_decay=0.01,
                                 compute_dtype=cfg.dtype)
    scaler = LossScaler("dynamic")
    model, state = train_state_from_jax_params(
        random_params(cfg, seed=0) if tree is None else tree, cfg, opt,
        device=device)
    return (make_train_step(model, opt, scaler), state,
            scaler.init(model.device))


def run_train_parity_phase(impl="flash"):
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**{**TRAIN, "num_layers": PARITY_TRAIN["num_layers"],
                       "hidden_dropout": 0.0, "attention_dropout": 0.0},
                    params_dtype=torch.float32, dtype=torch.float32,
                    attention_impl=impl)
    tokens, labels = _train_batch(cfg, PARITY_TRAIN["batch"],
                                  PARITY_TRAIN["seq"])
    runs = {}
    for dev in (CARD, "cpu"):
        step, state, sstate = _trainer(cfg, dev, 1e-4)
        losses, skips = [], []
        for _ in range(PARITY_TRAIN["steps"]):
            over = sstate.overflows
            state, sstate, loss = step(state, sstate, tokens, labels)
            losses.append(float(loss))
            skips.append(int(sstate.overflows - over))
        runs[dev] = (losses, skips)
    (lc, sc), (lp, sp) = runs[CARD], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    log(f"  losses cuda {lc}, cpu {lp}: max relative difference {rel:.3e} "
        f"(rtol {PARITY_LOSS_RTOL:g}); skipped steps cuda {sc}, cpu {sp}")
    check(all(math.isfinite(x) for x in lc + lp), "nonfinite parity loss")
    check(rel <= PARITY_LOSS_RTOL, f"train losses differ by {rel:.3e}")
    check(sc == sp, f"skip decisions differ: cuda {sc}, cpu {sp}")
    return dict(losses_cuda=lc, losses_cpu=lp, max_rel_diff=rel,
                skips_cuda=sc, skips_cpu=sp)


def run_train_phase(profile, impl="flash", calls=TRAIN_CALLS_PER_STEP,
                    opt=None, dtype=torch.bfloat16, warmup=TRAIN_WARMUP,
                    steps=TRAIN_STEPS):
    """The GPT train cell under ``impl`` (the model's attention_impl),
    with ``opt`` (default MixedPrecisionAdam), in the compute ``dtype``
    (bf16; fp16 is amp O2's), ``warmup`` + ``steps`` timed steps;
    ``calls``: each kernel's wrapper calls a step. Reports the steps the
    dynamic loss scaler skipped, in the warm-up and in the timed run."""
    from rocm_apex_tpu_torch.models.gpt import GPTConfig
    from rocm_apex_tpu_torch.ops._build import KERNELS

    cfg = GPTConfig(**TRAIN, params_dtype=torch.float32,
                    dtype=dtype, attention_impl=impl)
    t0 = time.perf_counter()
    step, state, sstate = _trainer(cfg, "cuda", 1e-4, opt)
    setup_s = time.perf_counter() - t0
    tokens, labels = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens, labels = tokens.cuda(), labels.cuda()
    gen = torch.Generator().manual_seed(0)  # CPU: the dropout seeds
    losses = []
    for _ in range(warmup):
        state, sstate, loss = step(state, sstate, tokens, labels,
                                   dropout_generator=gen)
        losses.append(loss)
    torch.cuda.synchronize()
    warm_overflows = int(sstate.overflows)
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
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
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=steps, seconds=dt,
        step_ms=1e3 * dt / steps,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ * steps / dt,
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        loss_scale=scale, overflows=overflows, setup_s=setup_s,
        dtype=str(dtype)[6:], skipped_warmup=warm_overflows,
        skipped_timed=overflows - warm_overflows,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches,
        attention_impl=impl,
        calls_per_step={k: launches[k] / steps for k in calls},
    )
    log(f"  {steps} steps of B {TRAIN_BATCH} x S {TRAIN_SEQ}: "
        f"{res['step_ms']:.2f} ms/step, {res['tokens_per_s']:.1f} tokens/s; "
        f"loss {losses[0]:.4f} (first) -> {losses[-1]:.4f} (last); loss "
        f"scale {scale:g}, {overflows} overflows (skipped steps: "
        f"{warm_overflows} in the warm-up, {overflows - warm_overflows} "
        f"timed); peak "
        f"{res['peak_mem_gib']:.2f} GiB")
    log(f"  wrapper calls per step: {res['calls_per_step']} (expected "
        f"{calls})")
    check(all(math.isfinite(x) for x in losses), "nonfinite training loss")
    check(losses[-1] < losses[0], "the training loss did not fall")
    check(scale >= 2.0**12, f"the loss scale collapsed to {scale:g}")
    if dtype == torch.float16:
        # amp O2: skipped steps only while the scale settles
        check(overflows == warm_overflows, f"{overflows - warm_overflows} "
              f"timed fp16 steps skipped: the loss scale had not settled "
              f"after the warm-up")
    for name, want in calls.items():
        check(launches[name] == want * steps,
              f"{name}: {launches[name]} calls in {steps} steps, "
              f"expected {want} per step")
    if profile:
        res["profile"] = profile_window(
            lambda: [step(state, sstate, tokens, labels,
                          dropout_generator=gen) for _ in range(3)],
            f"3 train steps ({impl})")
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


def _bert_trainer(cfg, device, moment_dtype, lr=1e-4, tree=None):
    """``(step, state, model, opt)``: bench.py's optimizer (at ``lr``)
    over seeded random weights (or the param ``tree``)."""
    from rocm_apex_tpu_torch.convert import (flatten_params, random_params,
                                             train_state_from_jax_params)
    from rocm_apex_tpu_torch.optimizers import MixedPrecisionLamb
    from rocm_apex_tpu_torch.train import make_bert_train_step

    tree = random_params(cfg, seed=0) if tree is None else tree
    mask = {k: not (k.endswith("bias") or "layernorm" in k.lower())
            for k in flatten_params(tree["params"])}
    opt = MixedPrecisionLamb(lr, weight_decay=0.01, weight_decay_mask=mask,
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


def run_bert_train_masked_parity_phase(impl="flash"):
    """Masked BERT train parity: the parity config (2 layers, S 128, B 2,
    fp32, TF32 off, dropout 0) with a padding mask of two lengths, three
    LAMB steps on the card (the unpacked kernels, or the softmax kernels
    under ``impl="fused_softmax"``) against the CPU (their plain
    versions)."""
    from rocm_apex_tpu_torch.models.bert import BertConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = BertConfig(**{**BERT, "num_layers": BERT_PARITY["num_layers"],
                        "max_position_embeddings": BERT_PARITY["seq"]},
                     params_dtype=torch.float32, dtype=torch.float32,
                     attention_impl=impl)
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


def bert_masked_calls(layers, steps, impl="flash"):
    """Wrapper calls of ``steps`` masked BERT steps with hidden and
    attention dropout: one unpacked attention a layer (no packed one, no
    dbias: the padding bias is a constant), or under ``impl=
    "fused_softmax"`` one masked softmax forward and backward a layer and
    no flash call; layer 0's plain ln1 and the LM head's LN, and 2 *
    layers dropout LNs (the ln2s, the chained ln1s, the final LN); one
    cross-entropy and one LAMB call a stage."""
    attn = layers * steps
    fused = impl == "fused_softmax"
    return {
        "flash_unpacked_fwd": 0 if fused else attn,
        "flash_unpacked_bwd": 0 if fused else attn,
        "softmax_masked_fwd": attn if fused else 0,
        "softmax_bwd": attn if fused else 0,
        "softmax_causal_fwd": 0,
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


def run_bert_train_masked_phase(profile, impl="flash"):
    """The BERT-Large step with a padding mask: `bert_lengths` over B 8 x
    S 512 and dropout 0.1 (hidden and attention), otherwise the
    bert_train phase's config, under ``impl`` (the attention_impl); 5
    warm-up and 20 timed steps."""
    from rocm_apex_tpu_torch.models.bert import BertConfig
    from rocm_apex_tpu_torch.ops._build import KERNELS

    cfg = BertConfig(**{**BERT, "hidden_dropout": BERT_MASKED_DROPOUT,
                        "attention_dropout": BERT_MASKED_DROPOUT},
                     params_dtype=torch.float32, dtype=torch.bfloat16,
                     attention_impl=impl)
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
    want = bert_masked_calls(cfg.num_layers, TRAIN_STEPS, impl)
    res = dict(
        batch=BERT_BATCH, seq=BERT_SEQ, steps=TRAIN_STEPS, seconds=dt,
        lengths=[int(x) for x in lens], real_tokens=int(lens.sum()),
        dropout=BERT_MASKED_DROPOUT, attention_impl=impl,
        step_ms=1e3 * dt / TRAIN_STEPS,
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
            lambda: [run() for _ in range(3)],
            f"3 masked BERT train steps ({impl})")
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
    res["device_step_ms"] = device_ms(lambda: step(state, tokens, labels),
                                      LAMB_DEVICE_STEPS, warmup=1)
    log(f"  {res['device_step_ms']:.2f} ms a step on the device, busy "
        f"{res['device_step_ms'] / res['step_ms']:.0%}")
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
    # the two paths round p to bf16 against running maxima of different
    # key tiles (the packed stream's 64-token tiles; each padded sequence's
    # own), as JAX's kernels would: o is held within `TOL` plus one bf16
    # step of the L1 mass of its terms (o of the padded path on |v|), dqkv
    # (whose do = 2 o carries o's difference) within one bf16 step in
    # norm, tensor by tensor
    absv = qkv.clone()
    absv[:, 2] = absv[:, 2].abs()
    l1 = fmha(absv, cu, max_s, causal=True, packed=False)
    cmp = attn_compare(outs["packed"][:1], outs["padded"][:1], [l1],
                       same_frame=False)
    g_rel = float((outs["packed"][1].float() - outs["padded"][1].float())
                  .norm() / outs["padded"][1].float().norm())
    cmp["dqkv_rel_norm"] = g_rel
    res["packed_vs_padded"] = cmp
    log(f"  packed vs padded on the card: o max|err| {cmp['err']:.3e}, "
        f"worst err/tol {cmp['ratio']:.3f}; dqkv |diff| / |dqkv| "
        f"{g_rel:.3e}")
    check(cmp["ratio"] <= 1.0, f"fmha packed and padded o differ by "
          f"{cmp['ratio']:.3g}x the tolerance")
    check(g_rel <= ROUND_STEP, f"fmha packed and padded dqkv differ by "
          f"{g_rel:.3g} of its norm")
    for path, want in (("packed", {"flash_segments_fwd": 1,
                                   "flash_segments_bwd": 1,
                                   "flash_attention_segments_with_lse": 0,
                                   "flash_segments_serve": 0}),
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


# ---------------------------------------------------------------------------
# phases 13 to 15: the fused-softmax attention path
# ---------------------------------------------------------------------------


def run_fused_softmax_parity_phase():
    """The fused-softmax path, cuda (the softmax kernels) against cpu
    (their plain versions), fp32 with TF32 off, dropout 0, three
    optimizer steps each: the GPT train parity config (full width, 2
    layers, S 256, B 2, Adam) and the masked BERT parity config (2
    layers, S 128, B 2, lengths (128, 77), LAMB), each held as its flash
    phase is. On the card the softmax kernels run a forward and a
    backward a layer and step, and no flash kernel runs."""
    from rocm_apex_tpu_torch.ops._build import KERNELS

    res = {}
    for name, run, fwd, shape in (
            ("gpt", run_train_parity_phase, "softmax_causal_fwd",
             PARITY_TRAIN),
            ("bert_masked", run_bert_train_masked_parity_phase,
             "softmax_masked_fwd", BERT_PARITY)):
        for k in KERNELS:
            k.launches = 0
        res[name] = run("fused_softmax")
        launches = res[name]["launches"] = {
            k.name: k.launches for k in KERNELS
            if k.name in SOFTMAX_KERNELS + FLASH_TRAIN_KERNELS}
        calls = shape["num_layers"] * shape["steps"]
        want = {k: (calls if k in (fwd, "softmax_bwd") else 0)
                for k in launches}
        log(f"  {name} card launches: {launches}")
        check(launches == want, f"{name} fused-softmax parity launches "
              f"{launches}, expected {want}")
    return res


# ---------------------------------------------------------------------------
# phases 16 and 17: the packed optimizer step
# ---------------------------------------------------------------------------


def _packed_ops(grads, master, sstate):
    """The packed ops a caller reaches outside the step, on one step's
    gradients (by name) and the packed masters: the scaler's
    `unscale_packed`, `multi_tensor_applier`'s axpby and per-tensor
    l2norm, and the SGD, Adagrad and NovoGrad updates over the buffers.
    Returns every output, flattened to a list of tensors."""
    from rocm_apex_tpu_torch.amp import LossScaler
    from rocm_apex_tpu_torch.multi_tensor_apply import (
        multi_tensor_applier, multi_tensor_axpby, multi_tensor_l2norm)
    from rocm_apex_tpu_torch.ops import optim_kernels as ok
    from rocm_apex_tpu_torch.ops.packing import pack_tree
    from rocm_apex_tpu_torch.optimizers._common import wd_columns

    pg = pack_tree(grads)
    unscaled, found = LossScaler().unscale_packed(sstate, pg)
    axpby, found2 = multi_tensor_applier(multi_tensor_axpby, None,
                                         [grads, grads, None], 1.0, 0.5)
    norm, per = multi_tensor_applier(multi_tensor_l2norm, None, [grads],
                                     True)
    p, g = master[0], unscaled.buffers[0]
    (wd,) = wd_columns(pg.spec, 0.01, None, p.device)
    vcol = wd + 1.0
    outs = [*unscaled.buffers, found, *axpby.values(), found2, norm,
            *per.values()]
    outs += ok.sgd_update(p, g, p * 0.5, wd, [1e-4, 0.9, 0.0, 0.0, 1.0],
                          True, False, True)
    outs += ok.adagrad_update(p, g, p * p, wd, [1e-4, 1e-10, 1.0], False)
    outs += ok.novograd_update(p, g, p * 0.5, vcol, wd,
                               [1e-4, 0.95, 0.05, 1e-8, 0.05, 0.04, 1.0],
                               False)
    return outs


def _master_err(card, cpu, initial, spec):
    """The worst ratio of |card - cpu| to the packed parity's tolerance
    over the packed masters, and where it falls (leaf, element, the three
    values): PACKED_MASTER_RTOL of |initial| + |step| plus
    OPTIM_STEP_SHARE of the largest step |cpu - initial| of the element's
    leaf, as `_param_err` holds the tree optimizers' params."""
    from rocm_apex_tpu_torch.ops.packing import WIDTH

    worst, where = 0.0, None
    for mc, mp, m0, group in zip(card, cpu, initial, spec.groups):
        step = (mp - m0).abs()
        share = torch.zeros_like(step).view(-1)
        for ls in group.leaf_specs:
            at = slice(ls.row_start * WIDTH, ls.row_start * WIDTH + ls.numel)
            share[at] = OPTIM_STEP_SHARE * float(step.view(-1)[at].max())
        tol = PACKED_MASTER_RTOL * (m0.abs() + step) + share.view(step.shape)
        # equal values pass where the tolerance is 0 (the padding, a leaf
        # that did not move); any difference there is infinitely over it
        r = torch.where(mc == mp, 0.0, (mc - mp).abs() / tol).view(-1)
        i = int(r.argmax())
        if float(r[i]) > worst:
            j = max(k for k, ls in enumerate(group.leaf_specs)
                    if ls.row_start * WIDTH <= i)
            off = i - group.leaf_specs[j].row_start * WIDTH
            worst = float(r[i])
            where = (f"{spec.treedef[group.leaf_indices[j]]}[{off}] (cuda "
                     f"{float(mc.view(-1)[i]):.9g}, cpu "
                     f"{float(mp.view(-1)[i]):.9g}, initial "
                     f"{float(m0.view(-1)[i]):.9g})")
    return worst, where


def run_train_packed_parity_phase():
    """`PackedOptimizerStep` on the train parity config (full width, 2
    layers, S 256, B 2, fp32, TF32 off, dropout 0): Adam (weight decay
    0.01; eps 1e-6, as the CPU tests', so that fp32 noise on a near-zero
    gradient cannot flip a normalized step) and LAMB (max_grad_norm 1.0),
    three steps on the card against the CPU, then one step with an inf in
    a gradient. Losses within PARITY_LOSS_RTOL, the same skips, masters
    within `PACKED_MASTER_RTOL` of |master| + |applied step| and
    `OPTIM_STEP_SHARE` of the leaf's largest CPU step (`_master_err`), the
    inf step found and bit-frozen on both. Then the packed ops outside the
    step (`_packed_ops`) on the card's last gradients, card against CPU
    on the same inputs."""
    from rocm_apex_tpu_torch.models.gpt import GPTConfig
    from rocm_apex_tpu_torch.ops._build import KERNELS
    from rocm_apex_tpu_torch.ops.packing import build_pack_spec
    from rocm_apex_tpu_torch.optimizers import PackedOptimizerStep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**{**TRAIN, "num_layers": PARITY_TRAIN["num_layers"],
                       "hidden_dropout": 0.0, "attention_dropout": 0.0},
                    params_dtype=torch.float32, dtype=torch.float32)
    tokens, labels = _train_batch(cfg, PARITY_TRAIN["batch"],
                                  PARITY_TRAIN["seq"])
    for k in KERNELS:
        k.launches = 0
    res = {}
    for name, kw in (("adam", dict(weight_decay=0.01, eps=1e-6)),
                     ("lamb", dict(weight_decay=0.01, max_grad_norm=1.0))):
        runs = {}
        for dev in (CARD, "cpu"):
            opt = PackedOptimizerStep(name, 1e-4, compute_dtype=torch.float32,
                                      **kw)
            step, state, sstate = _trainer(cfg, dev, 1e-4, opt)
            master0 = [b.cpu() for b in state.master]
            spec = build_pack_spec(state.model)
            losses, skips = [], []
            for _ in range(PARITY_TRAIN["steps"]):
                over = sstate.overflows
                state, sstate, loss = step(state, sstate, tokens, labels)
                losses.append(float(loss))
                skips.append(int(sstate.overflows - over))
            if name == "adam" and dev == CARD:
                grads = {k: t.grad for k, t in state.model.items()}
                ops_in = (grads, state.master, sstate)
            keep = [[b.clone() for b in getattr(state, n)]
                    for n in ("master", "m", "v")]
            count = int(state.count)
            grads = {k: torch.full_like(t, 1e-3)
                     for k, t in state.model.items()}
            grads["embedding.word_embeddings.weight"][7, 7] = float("inf")
            state, inf = opt.step_and_probe(state, grads, grad_scale=1.0)
            frozen = bool(inf) and int(state.count) == count and all(
                torch.equal(a, b) for n, kept in zip(("master", "m", "v"),
                                                     keep)
                for a, b in zip(getattr(state, n), kept))
            runs[dev] = dict(losses=losses, skips=skips, frozen=frozen,
                             master=[b.cpu() for b in state.master])
        rc, rp = runs[CARD], runs["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(rc["losses"],
                                                     rp["losses"]))
        ratio, worst = _master_err(rc["master"], rp["master"], master0,
                                   spec)
        log(f"  {name}: losses cuda {rc['losses']}, cpu {rp['losses']}: "
            f"max relative difference {rel:.3e} (rtol {PARITY_LOSS_RTOL:g});"
            f" skips cuda {rc['skips']}, cpu {rp['skips']}; masters worst "
            f"err/tol {ratio:.3f} at {worst} (tol {PACKED_MASTER_RTOL:g} x "
            f"(|master| + |step|) + {OPTIM_STEP_SHARE:g} x the leaf's "
            f"largest step); inf "
            f"step bit-frozen cuda {rc['frozen']}, cpu {rp['frozen']}")
        check(all(math.isfinite(x) for x in rc["losses"] + rp["losses"]),
              "nonfinite packed parity loss")
        check(rel <= PARITY_LOSS_RTOL, f"{name}: losses differ by {rel:.3e}")
        check(rc["skips"] == rp["skips"], f"{name}: skips differ")
        check(ratio <= 1.0, f"{name}: masters differ by {ratio:.3g}x the "
              f"tolerance")
        check(rc["frozen"] and rp["frozen"], f"{name}: the inf step changed "
              f"the state")
        res[name] = dict(losses_cuda=rc["losses"], losses_cpu=rp["losses"],
                         max_rel_diff=rel, skips_cuda=rc["skips"],
                         skips_cpu=rp["skips"], master_err_over_tol=ratio,
                         inf_step_frozen=True)
    # the ops outside the step, card against CPU on the card's inputs
    grads, master, sstate = ops_in
    card = _packed_ops(grads, master, sstate)
    cpu = _packed_ops({k: t.cpu() for k, t in grads.items()},
                      [b.cpu() for b in master],
                      type(sstate)(*(t.cpu() for t in sstate)))
    worst = max(float((a.float().cpu() - b.float()).abs().max())
                / (float(b.float().abs().max()) + 1e-30)
                for a, b in zip(card, cpu))
    log(f"  unscale_packed, axpby, l2norm, sgd, adagrad, novograd on the "
        f"last gradients: card vs cpu worst |err| / max|cpu| {worst:.3e} "
        f"(limit 1e-5: the norms' sums in two orders)")
    check(worst <= 1e-5, f"the packed ops differ card vs cpu by {worst:.3e}")
    res["packed_ops_rel_err"] = worst
    res["launches"] = {k.name: k.launches for k in KERNELS
                       if k.name in PACKED_KERNELS}
    log(f"  card launches: {res['launches']}")
    for k, n in res["launches"].items():
        check(n > 0, f"{k} was not launched on the card")
    return res


def run_train_packed_phase(profile, report):
    """The train cell with `PackedOptimizerStep("adam", 1e-4,
    weight_decay=0.01)`, as bench.py gpt --packed-update sets it
    (bench.py:2696): the train phase's 5 + 20 steps and checks, 1
    scale_sumsq and 1 adam_update call a step (one bf16 group) and no LAMB
    call; beside it the train phase's step ms from this call. Then the
    bare update phase on fixed bf16 gradients p * 1e-3 + 1e-5
    (bench.py:2699-2701), `MixedPrecisionAdam` and `PackedOptimizerStep`
    in turns (mixed, packed, packed, mixed): the host-clock time of a
    call (`cuda_ms`) and the device time (`device_ms`)."""
    from rocm_apex_tpu_torch.convert import flatten_params, random_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig
    from rocm_apex_tpu_torch.optimizers import (MixedPrecisionAdam,
                                                PackedOptimizerStep)

    res = run_train_phase(
        profile, calls=PACKED_TRAIN_CALLS_PER_STEP,
        opt=PackedOptimizerStep("adam", 1e-4, weight_decay=0.01))
    train_ms = report.get("train", {}).get("step_ms")
    res["train_step_ms_same_call"] = train_ms
    log(f"  packed step {res['step_ms']:.2f} ms against the train phase's "
        f"{'not run' if train_ms is None else f'{train_ms:.2f} ms'} in this "
        f"call")
    torch.cuda.empty_cache()

    cfg = GPTConfig(**TRAIN, params_dtype=torch.float32, dtype=torch.bfloat16)
    params = {k: torch.from_numpy(v).cuda() for k, v in flatten_params(
        random_params(cfg, seed=0)["params"]).items()}
    grads = {k: (p * 1e-3 + 1e-5).to(torch.bfloat16)
             for k, p in params.items()}
    opts = {"mixed": MixedPrecisionAdam(1e-4, weight_decay=0.01),
            "packed": PackedOptimizerStep("adam", 1e-4, weight_decay=0.01)}
    states = {k: o.init(params) for k, o in opts.items()}
    n_params = sum(p.numel() for p in params.values())
    del params

    def update(which):
        states[which], _ = opts[which].step_and_probe(
            states[which], grads, grad_scale=1.0)

    times = {k: {"call_ms": [], "device_ms": []} for k in opts}
    for which in ("mixed", "packed", "packed", "mixed"):
        times[which]["call_ms"].append(cuda_ms(lambda: update(which), 20))
        times[which]["device_ms"].append(
            device_ms(lambda: update(which), 20))
    res["update_phase"] = times
    log(f"  bare update phase (fixed bf16 gradients, {n_params} "
        f"parameters), mixed / packed / packed / mixed: " + "; ".join(
            f"{k} call {v['call_ms'][0]:.3f}, {v['call_ms'][1]:.3f} ms, "
            f"device {v['device_ms'][0]:.3f}, {v['device_ms'][1]:.3f} ms"
            for k, v in times.items()))
    return res


# ---------------------------------------------------------------------------
# phases 18 to 20: ResNet-50 training, fused and unfused
# ---------------------------------------------------------------------------

# rn50 parity, cuda vs cpu: ResNet-50's widths (stages (3, 4, 6, 3), 64
# filters, 1000 classes) fused at B 2, 64 x 64 (layer4 at W 2), fp32 with
# TF32 off, the bench step at O0 with fp32 masters and a dynamic scaler.
# From random weights with every residual branch's last BN scale 1 the
# net is chaotic: on the CPU alone, 1e-6 relative noise on the input
# moves the logits by 2.3e-4 of their size, some first-step gradients by
# 15% of their leaf's largest, and bench.py's FusedAdam(1e-3) turns it
# into 11% and 69% of the second and third losses, so fp32 rounding
# cannot be told from a fault. With those scales at 0.2
# (RN50_PARITY_BN3_SCALE, the damped-residual init) and FusedAdam lr 1e-4,
# eps 1e-3 (the eps keeps a near-zero gradient's noise from taking a full
# Adam step) the same noise moves the gradients by 5.0e-5 of their leaf's
# largest and the losses by 1.9e-5 at most (rn50_parity_sensitivity.py
# measures all of these). Held: the first step's gradients within 1e-3 of
# each leaf's largest |gradient|, the losses within 1e-4 relative, the
# masters within 1e-5 of |master| + 1e-5 + half the three lr steps (the
# biases ahead of a BN have near-cancelling gradients; the noise uses
# 0.62 of this tolerance), the running statistics within 1e-3 of their
# scale (|mean| + std for a mean, E[y^2] = var + mean^2 for a variance:
# the single-pass variance subtracts from E[y^2]; the noise uses 0.14 of
# it), and the same skips.
RN50_PARITY = dict(batch=2, size=64, steps=3, lr=1e-4, eps=1e-3)
RN50_PARITY_BN3_SCALE = 0.2
RN50_PARITY_GRAD_SHARE = 1e-3
RN50_PARITY_LOSS_RTOL = 1e-4
RN50_PARITY_MASTER_TOL = dict(rtol=1e-5, atol=1e-5, lr_share=0.5)
RN50_PARITY_STATS_RTOL = 1e-3


def _rn50(device, fused, dtype):
    """bench.py's `models.resnet50(num_classes=1000, dtype, fused)` from
    seeded random weights (the flax initializers' variances)."""
    from rocm_apex_tpu_torch.models import resnet50

    return resnet50(num_classes=RN50_CLASSES, dtype=dtype, fused=fused,
                    device=device, generator=torch.Generator().manual_seed(0))


def _rn50_batch(batch, size, device):
    """normal(0, 1) NHWC images and uniform class ids from a seed."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(batch, size, size, 3, generator=gen)
    y = torch.randint(0, RN50_CLASSES, (batch,), generator=gen)
    return x.to(device), y.to(device)


def _rn50_trainer(model, opt_level, lr=1e-3, eps=1e-8, optimizer=None,
                  grad_sync=None, **overrides):
    """``(step, params, opt_state, scaler_states)``: bench.py's
    `amp.initialize(params, FusedAdam(1e-3, weight_decay=1e-4), opt_level)`
    (or ``optimizer``) and its one_step (with ``grad_sync``, the
    data-parallel sync of its gradients)."""
    from rocm_apex_tpu_torch import amp
    from rocm_apex_tpu_torch.optimizers import FusedAdam
    from rocm_apex_tpu_torch.train import make_rn50_train_step

    if optimizer is None:
        optimizer = FusedAdam(lr, weight_decay=1e-4, eps=eps)
    params, opt, st = amp.initialize(
        {k: v.detach() for k, v in model.named_parameters()},
        optimizer, opt_level=opt_level, verbosity=0, **overrides)
    return (make_rn50_train_step(model, opt, st, grad_sync=grad_sync),
            params, opt.init(params), st.scaler_states)


def _stats_scale(stats):
    """Each running statistic's scale: |mean| + std, var + mean^2."""
    out = {}
    for k, v in stats.items():
        base, _, leaf = k.rpartition("mean" if k.endswith("mean") else "var")
        mean, var = stats[base + "mean"], stats[base + "var"].clamp_min(0)
        out[k] = (mean.abs() + var.sqrt()) if leaf == "mean" \
            else (var + mean * mean)
    return out


def _worst(card, cpu, scale, share, atol=0.0):
    """The worst |card - cpu| / (share * scale + atol) over dicts."""
    worst = 0.0
    for k, v in cpu.items():
        diff = (card[k].detach().to("cpu", torch.float32) - v.float()).abs()
        worst = max(worst, float((diff / (share * scale[k] + atol)).max()))
    return worst


def run_rn50_parity_phase():
    """The fused ResNet-50 step, cuda (the bottleneck kernels, fp32) vs
    cpu (their plain versions): the first step's gradients, then three
    steps (see RN50_PARITY)."""
    from rocm_apex_tpu_torch.ops._build import KERNELS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = RN50_PARITY
    out = {}
    for dev in (CARD, "cpu"):
        model = _rn50(dev, True, torch.float32)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("bn3_scale", "bn3.scale")):
                    p.fill_(RN50_PARITY_BN3_SCALE)
        x, y = _rn50_batch(cfg["batch"], cfg["size"], dev)
        bufs = {k: b.clone() for k, b in model.named_buffers()}
        names = [k for k, _ in model.named_parameters()]
        loss = F.cross_entropy(model(x).float(), y)
        grads = dict(zip(names, torch.autograd.grad(
            loss, list(model.parameters()))))
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(bufs[k])
        step, params, opt_state, ss = _rn50_trainer(
            model, "O0", lr=cfg["lr"], eps=cfg["eps"], master_weights=True,
            loss_scale="dynamic")
        for k in KERNELS:
            k.launches = 0
        losses, skips = [], []
        for _ in range(cfg["steps"]):
            params, opt_state, ss2, loss = step(params, opt_state, ss, x, y)
            skips.append(int(ss2[0].overflows) - int(ss[0].overflows))
            ss = ss2
            losses.append(float(loss))
        out[dev] = dict(losses=losses, skips=skips, grads=grads,
                        master=opt_state.master,
                        stats=dict(model.named_buffers()),
                        launches={k.name: k.launches for k in KERNELS
                                  if k.name in BNECK_KERNELS})
    card, cpu = out[CARD], out["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                  cpu["losses"]))
    gscale = {k: g.abs().max().expand_as(g) for k, g in cpu["grads"].items()}
    mt = RN50_PARITY_MASTER_TOL
    lr_steps = cfg["lr"] * cfg["steps"]
    res = dict(
        losses_cuda=card["losses"], losses_cpu=cpu["losses"],
        loss_rel_err=rel, skips_cuda=card["skips"], skips_cpu=cpu["skips"],
        grad_err_over_tol=_worst(card["grads"], cpu["grads"], gscale,
                                 RN50_PARITY_GRAD_SHARE, 1e-30),
        master_err_over_tol=_worst(
            card["master"], cpu["master"],
            {k: v.abs() for k, v in cpu["master"].items()}, mt["rtol"],
            mt["atol"] + mt["lr_share"] * lr_steps),
        stats_err_over_tol=_worst(card["stats"], cpu["stats"],
                                  _stats_scale(cpu["stats"]),
                                  RN50_PARITY_STATS_RTOL, 1e-30),
        launches_cuda=card["launches"], launches_cpu=cpu["launches"])
    log(f"  losses cuda {card['losses']} cpu {cpu['losses']}: max rel "
        f"{rel:.2e} (tol {RN50_PARITY_LOSS_RTOL}); of their tolerances: "
        f"first-step gradients {res['grad_err_over_tol']:.3f}, masters "
        f"{res['master_err_over_tol']:.3f}, running stats "
        f"{res['stats_err_over_tol']:.3f}; skips {card['skips']} / "
        f"{cpu['skips']}; kernel calls on the card {card['launches']}")
    check(rel <= RN50_PARITY_LOSS_RTOL, f"rn50 parity: loss rel err {rel:.2e}")
    check(card["skips"] == cpu["skips"], "rn50 parity: skips differ")
    for what in ("grad", "master", "stats"):
        r = res[f"{what}_err_over_tol"]
        check(r <= 1.0, f"rn50 parity: {what} differ by {r:.3g}x their "
              f"tolerance")
    for k, want in RN50_FUSED_CALLS_PER_STEP.items():
        check(card["launches"][k] == want * cfg["steps"],
              f"rn50 parity: {k} {card['launches'][k]} calls on the card, "
              f"expected {want} a step")
        check(cpu["launches"][k] == 0, f"rn50 parity: {k} launched on cpu")
    return res


def run_rn50_train_phase(profile, fused, report=None, optimizer=None):
    """bench.py's rn50 step at B 128 x 224 x 224, bf16 under amp O5 with
    FusedAdam(1e-3, weight_decay=1e-4) (or ``optimizer``), fused or not:
    5 warm-up and 20 timed steps on one batch; images/s, step ms, peak
    memory, losses, and the bottleneck kernels' wrapper calls a step
    (27/13/27/13 fused, 0 unfused)."""
    from rocm_apex_tpu_torch.ops._build import KERNELS

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = _rn50(CARD, fused, torch.bfloat16)
    step, params, opt_state, ss = _rn50_trainer(model, "O5",
                                                optimizer=optimizer)
    x, y = _rn50_batch(RN50_BATCH, RN50_SIZE, CARD)
    setup_s = time.perf_counter() - t0
    losses = []
    for _ in range(TRAIN_WARMUP):
        params, opt_state, ss, loss = step(params, opt_state, ss, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        params, opt_state, ss, loss = step(params, opt_state, ss, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    losses = [float(v) for v in losses]
    want = (RN50_FUSED_CALLS_PER_STEP if fused
            else {k: 0 for k in BNECK_KERNELS})
    res = dict(
        fused=fused, batch=RN50_BATCH, size=RN50_SIZE, steps=TRAIN_STEPS,
        seconds=dt, step_ms=1e3 * dt / TRAIN_STEPS,
        images_per_s=RN50_BATCH * TRAIN_STEPS / dt, setup_s=setup_s,
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches,
        calls_per_step={k: launches[k] / TRAIN_STEPS for k in want})
    log(f"  {TRAIN_STEPS} steps of B {RN50_BATCH} x {RN50_SIZE}^2: "
        f"{res['step_ms']:.2f} ms/step, {res['images_per_s']:.1f} images/s; "
        f"loss {losses[0]:.4f} (first) -> {losses[-1]:.4f} (last); peak "
        f"{res['peak_mem_gib']:.2f} GiB; wrapper calls per step "
        f"{res['calls_per_step']} (expected {want})")
    if fused and report is not None:
        unfused = report.get("rn50_train", {}).get("step_ms")
        res["unfused_step_ms_same_call"] = unfused
        if unfused:
            res["fused_over_unfused"] = res["step_ms"] / unfused
            log(f"  fused / unfused step in this call: "
                f"{res['fused_over_unfused']:.3f}")
    check(all(math.isfinite(v) for v in losses), "nonfinite rn50 loss")
    for name, n in want.items():
        check(launches[name] == n * TRAIN_STEPS,
              f"{name}: {launches[name]} calls in {TRAIN_STEPS} steps, "
              f"expected {n} a step")
    if profile:
        res["profile"] = profile_window(
            lambda: [step(params, opt_state, ss, x, y) for _ in range(3)],
            f"3 rn50 steps ({'fused' if fused else 'unfused'})")
    return res


# ---------------------------------------------------------------------------
# phases 22 to 24: contrib/multihead_attn, context parallelism, "jnp"
# ---------------------------------------------------------------------------

# contrib/multihead_attn at Transformer-big's widths (Vaswani et al. 2017,
# Table 3, "big": d_model 1024, 16 heads of 64), bf16 compute with fp32
# parameters: self attention over B 8 x 512 with `bert_lengths` key
# padding, encoder-decoder attention of 8 x 256 queries over 8 x 512
# keys with the encoder's padding
MHA = dict(hidden=1024, heads=16, batch=8, seq=512, dec_seq=256)
MHA_DROPOUT = 0.1
MHA_ITERS = 20
# the modules on the kernels against the same modules on the plain
# versions, the weights and inputs the same, on the card: only the
# attention and LayerNorm differ (cuBLAS takes the projections in both),
# each rounding p and o on one rule from fp32 sums in another order, so
# an attention output moves by about a bf16 step (2^-8 relative); through
# the bf16 output projection and the gradients' bf16 products each
# output, and each gradient, is held within MHA_REL_TOL of its largest
# element
MHA_REL_TOL = 2e-2


def _rel_err(a, b):
    """max |a - b| over max |b| (NaN fails: inf)."""
    a, b = a.detach().float(), b.detach().float()
    d = float((a - b).abs().max())
    if math.isnan(d):
        return math.inf
    return d / max(float(b.abs().max()), 1e-30)


class plain_versions:
    """While open, the unpacked and the packed attention and the LayerNorm
    wrappers run their plain PyTorch versions on card tensors (the
    autograd functions unchanged, their forward and backward bodies
    swapped): the modules' reference on the same card inputs."""

    def __enter__(self):
        from rocm_apex_tpu_torch.ops import flash_attention as fa
        from rocm_apex_tpu_torch.ops import layer_norm as ln

        self.fa, self.ln = fa, ln
        self.saved = (fa._unpacked_fwd, fa._unpacked_bwd, ln._ln_fwd_impl,
                      ln._layer_norm_bwd, fa._flash_fwd, fa._flash_bwd)

        def fwd(q, k, v, bias, causal, scale, kv_lengths, rate, seed,
                bshd=False):
            B, H, sq, d = q.shape
            o, lse = fa.flash_unpacked_fwd_plain(
                fa._flat(q), fa._flat(k), fa._flat(v), bias, causal, scale,
                kv_lengths, rate, seed)
            return o.view(B, H, sq, d), lse

        def bwd(q, k, v, bias, o, lse, do, dlse, causal, scale, kv_lengths,
                rate, seed, compute_dbias, bshd=False):
            dq, dk, dv, dbias = fa.flash_unpacked_bwd_plain(
                fa._flat(q), fa._flat(k), fa._flat(v), bias, fa._flat(o),
                lse, fa._flat(do), causal, scale, kv_lengths, rate, seed,
                dlse, compute_dbias)
            return dq.view(q.shape), dk.view(k.shape), dv.view(v.shape), dbias

        def lnf(x2d, delta2d, weight, bias, eps, out_dtype, rate=0.0, seed=0):
            return ln.layer_norm_fwd_plain(x2d, delta2d, weight, bias, eps,
                                           out_dtype or x2d.dtype, rate, seed)

        fa._unpacked_fwd, fa._unpacked_bwd = fwd, bwd
        ln._ln_fwd_impl, ln._layer_norm_bwd = lnf, ln.layer_norm_bwd_plain
        fa._flash_fwd = fa.flash_qkv_fwd_plain
        fa._flash_bwd = lambda qkv, bias, o, lse, do, *a: (
            fa.flash_qkv_bwd_plain(qkv, bias, o, lse, do.contiguous(), *a))
        return self

    def __exit__(self, *exc):
        (self.fa._unpacked_fwd, self.fa._unpacked_bwd, self.ln._ln_fwd_impl,
         self.ln._layer_norm_bwd, self.fa._flash_fwd,
         self.fa._flash_bwd) = self.saved
        return False


class plain_bottleneck:
    """While open, the four fused bottleneck ops run their plain PyTorch
    versions on card tensors (`bottleneck_fused`'s autograd function
    unchanged): the fused ResNet's reference on the same card inputs."""

    NAMES = ("conv1x1_bn_act", "conv3x3_bn_act", "conv1x1_bn_act_bwd",
             "conv3x3_bn_act_bwd")

    def __enter__(self):
        from rocm_apex_tpu_torch.ops import fused_bottleneck as fb

        self.fb = fb
        self.saved = {n: getattr(fb, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(fb, n, getattr(fb, n + "_plain"))
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.fb, n, f)
        return False


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _zero_launches():
    from rocm_apex_tpu_torch.ops._build import KERNELS

    _sync()
    for k in KERNELS:
        k.launches = 0


def _launches():
    from rocm_apex_tpu_torch.ops._build import KERNELS

    _sync()
    return {k.name: k.launches for k in KERNELS if k.launches}


def _mha_run(mod, xs, kpm, am, train, dout=None, **kw):
    """One call: the output, and with ``train`` the gradients of sum(out
    * dout) in the inputs and every parameter, in a fixed order."""
    if not train:
        with torch.no_grad():
            return [mod(*xs, key_padding_mask=kpm, attn_mask=am, **kw)]
    xs = [x.detach().requires_grad_(True) for x in xs]
    mod.zero_grad(set_to_none=True)
    out = mod(*xs, key_padding_mask=kpm, attn_mask=am, deterministic=False,
              **kw)
    (out.float() * dout).sum().backward()
    return ([out.detach()] + [x.grad for x in xs]
            + [p.grad for _, p in sorted(mod.named_parameters())])


def _mha_modules(dev):
    """(name, module, inputs, key padding mask, attention mask, dout) for
    every case: Self and EncDec, each with and without norm_add, under
    their key padding and under an attention mask alone."""
    from rocm_apex_tpu_torch.contrib import (EncdecMultiheadAttn,
                                             SelfMultiheadAttn)

    h, heads, b, s, sd = (MHA[k] for k in ("hidden", "heads", "batch", "seq",
                                           "dec_seq"))
    gen = torch.Generator(device=dev).manual_seed(23)
    enc = torch.randn(b, s, h, device=dev, generator=gen)
    dec = torch.randn(b, sd, h, device=dev, generator=gen)
    lens = torch.from_numpy(bert_lengths(b)).to(dev)
    kpm = torch.arange(s, device=dev)[None, :] >= lens[:, None]
    self_am = torch.ones(s, s, dtype=torch.bool, device=dev).triu(1)
    # a band: each decoder query sees the encoder keys within 128 of 2q
    qi = torch.arange(sd, device=dev)[:, None] * 2
    ki = torch.arange(s, device=dev)[None, :]
    encdec_am = (ki - qi).abs() > 128
    out = []
    for norm_add in (False, True):
        torch.manual_seed(31)
        sm = SelfMultiheadAttn(heads, h, include_norm_add=norm_add,
                               dtype=torch.bfloat16, device=dev)
        em = EncdecMultiheadAttn(heads, h, include_norm_add=norm_add,
                                 dtype=torch.bfloat16, device=dev)
        for m in (sm, em):
            if norm_add:
                with torch.no_grad():
                    m.lyr_norm.weight.normal_(1.0, 0.1)
                    m.lyr_norm.bias.normal_(0.0, 0.1)
        tag = "norm_add" if norm_add else "plain"
        d_self = torch.randn(b, s, h, device=dev, generator=gen)
        d_enc = torch.randn(b, sd, h, device=dev, generator=gen)
        out += [(f"self {tag} key padding", sm, (enc,), kpm, None, d_self),
                (f"self {tag} attn mask", sm, (enc,), None, self_am, d_self),
                (f"encdec {tag} key padding", em, (dec, enc), kpm, None,
                 d_enc),
                (f"encdec {tag} attn mask", em, (dec, enc), None, encdec_am,
                 d_enc)]
    return out


def _mha_dropout_reference(mod, query, kpm, seed):
    """`SelfMultiheadAttn`'s training branch recomputed from its formula
    with the keep bits of ``seed`` (ops._dropout): fp32 scores of the
    bf16 q, k plus the padding bias, an fp32 softmax (a row whose every
    key is padding: the uniform average), bf16 probabilities, dropout,
    then probs @ v and the output projection."""
    from rocm_apex_tpu_torch.ops import _dropout

    b, s, h = query.shape
    heads, d = mod.num_heads, h // mod.num_heads
    with torch.no_grad():
        qkv = mod.qkv_proj(query)
        q, k, v = (t.view(b, s, heads, d).transpose(1, 2)
                   for t in qkv.split(h, -1))
        sc = torch.matmul(q.float(), k.float().transpose(-1, -2))
        sc = sc / math.sqrt(d)
        sc = sc + torch.where(kpm[:, None, None, :], -1e30, 0.0)
        p = torch.softmax(sc, -1).to(q.dtype)
        keep = _dropout.keep_mask(seed, MHA_DROPOUT, (b * heads, s, s),
                                  device=query.device).view(p.shape)
        p = torch.where(keep, p / (1 - MHA_DROPOUT), 0.0).to(q.dtype)
        ctx = torch.matmul(p, v).transpose(1, 2).reshape(b, s, h)
        return mod.out_proj(ctx), keep


def run_mha_phase():
    """contrib/multihead_attn and the normalization API on the card (see
    MHA): every case's eval forward and (dropout 0) training forward +
    backward against the same module on the plain versions; per call one
    unpacked forward (row 7b), one unpacked backward (row 9b) in
    training, and one LayerNorm forward and backward (rows 1, 2) with
    norm_add; the headline case timed (a call, and the device alone);
    then the dropout branch at 0.1 in training (no flash launch; its
    output equal to its formula with the recovered keep bits, whose kept
    share is within 5 sigma of 0.9; a batch row whose every key is
    padding gives the flash path's 0 in eval and the uniform average in
    training); then `FusedLayerNorm` affine and not,
    `fused_layer_norm_affine` and `mixed_dtype_fused_layer_norm_affine`
    on the self-attention input, forward + backward, against their
    plain versions, with their launches (the non-affine backward's among
    them)."""
    from rocm_apex_tpu_torch import normalization as norm

    dev = torch.device(CARD, 0) if CARD == "cuda" else torch.device(CARD)
    res = dict(cases={}, launches={})
    cases = _mha_modules(dev)
    for name, mod, xs, kpm, am, dout in cases:
        for train in (False, True):
            _zero_launches()
            got = _mha_run(mod, xs, kpm, am, train, dout)
            calls = _launches()
            with plain_versions():
                ref = _mha_run(mod, xs, kpm, am, train, dout)
            errs = [_rel_err(g, r) for g, r in zip(got, ref)
                    if g is not None]
            worst = max(errs)
            what = f"mha {name} {'train' if train else 'eval'}"
            log(f"  {what}: worst max|kernel - plain| / max|plain| "
                f"{worst:.3e} over {len(errs)} tensors (tol "
                f"{MHA_REL_TOL:g}); launches {calls}")
            check(all(bool(torch.isfinite(t).all()) for t in got
                      if t is not None), f"{what}: nonfinite output")
            check(worst <= MHA_REL_TOL, f"{what}: the kernels differ from "
                  f"the plain versions by {worst:.3e} of the largest element")
            want = {"flash_unpacked_fwd": 1,
                    "flash_unpacked_bwd": int(train)}
            if mod.include_norm_add:
                want.update(layer_norm_fwd=1, layer_norm_bwd=int(train))
            for k, n in want.items():
                check(calls.get(k, 0) == n, f"{what}: {k} launched "
                      f"{calls.get(k, 0)} times, expected {n}")
            check(set(calls) <= set(want), f"{what}: unexpected launches "
                  f"{calls}")
            res["cases"][what] = dict(rel_err=worst, launches=calls)
            for k, n in calls.items():
                res["launches"][k] = res["launches"].get(k, 0) + n
    # the headline: self attention with key padding, norm_add off
    name, mod, xs, kpm, am, dout = cases[0]
    # each call timed twice: back to back between two events (the host's
    # launch time where that is longer), and queued behind a sleep kernel
    # (the device's time alone); their ratio is the card's busy share
    ev, tr = (lambda: _mha_run(mod, xs, kpm, am, False),
              lambda: _mha_run(mod, xs, kpm, am, True, dout))
    eval_ms, train_ms = cuda_ms(ev, MHA_ITERS), cuda_ms(tr, MHA_ITERS)
    eval_dev, train_dev = device_ms(ev, MHA_ITERS), device_ms(tr, MHA_ITERS)
    res.update(eval_ms=eval_ms, train_ms=train_ms, eval_device_ms=eval_dev,
               train_device_ms=train_dev, headline=name)
    log(f"  {name}: eval forward {eval_ms:.3f} ms a call ({eval_dev:.3f} "
        f"ms on the device, busy {eval_dev / eval_ms:.0%}), training "
        f"forward + backward {train_ms:.3f} ms ({train_dev:.3f} ms on the "
        f"device, busy {train_dev / train_ms:.0%}) (B {MHA['batch']} x "
        f"{MHA['seq']}, {MHA['heads']} heads of "
        f"{MHA['hidden'] // MHA['heads']}, bf16)")

    # the dropout branch, with a batch row whose every key is padding
    query = xs[0]
    kpm_full = kpm.clone()
    kpm_full[1] = True
    mod.dropout = MHA_DROPOUT
    _zero_launches()
    got = _mha_run(mod, xs, kpm_full, None, True, dout, dropout_seed=77)
    calls = _launches()
    check(not any(k.startswith("flash") for k in calls),
          f"mha dropout: the training branch launched {calls}")
    with torch.no_grad():
        drop = mod(query, key_padding_mask=kpm_full, deterministic=False,
                   dropout_seed=77)
    want, keep = _mha_dropout_reference(mod, query, kpm_full, 77)
    err = _rel_err(drop, want)
    n = keep.numel()
    frac = float(keep.float().mean())
    sigma = math.sqrt(MHA_DROPOUT * (1 - MHA_DROPOUT) / n)
    log(f"  dropout {MHA_DROPOUT} (training branch): no flash launch "
        f"({calls}); output against its formula with the recovered keep "
        f"bits {err:.3e} of the largest element; kept share {frac:.6f} "
        f"(0.9 +- 5 sigma = {5 * sigma:.2e})")
    check(err <= MHA_REL_TOL, f"mha dropout: output off its formula by "
          f"{err:.3e}")
    check(abs(frac - (1 - MHA_DROPOUT)) <= 5 * sigma,
          f"mha dropout: kept share {frac} off 0.9")
    check(all(bool(torch.isfinite(t).all()) for t in got if t is not None),
          "mha dropout: nonfinite gradient")
    mod.dropout = 0.0
    with torch.no_grad():
        ev = mod(query, key_padding_mask=kpm_full)
    # the fully padded row's context is 0: its output is out_proj's bias
    bias_err = _rel_err(ev[1], mod.out_proj.bias.to(ev.dtype).expand(
        MHA["seq"], -1))
    log(f"  the fully padded batch row, eval (flash): max|out - out_proj "
        f"bias| / max|bias| {bias_err:.3e}")
    check(bias_err <= 2.0 ** -8, "mha: the fully padded row of the flash "
          "path is not 0 through out_proj")
    res["dropout"] = dict(rel_err=err, kept_share=frac, five_sigma=5 * sigma,
                          launches=calls)

    # the normalization API on the same input
    h = MHA["hidden"]
    dy = torch.randn(query.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    xb = query.to(torch.bfloat16)
    nonaff = norm.FusedLayerNorm(h, elementwise_affine=False, device=dev)
    aff = norm.FusedLayerNorm(h, device=dev)
    w = 1.0 + 0.1 * torch.randn(h, device=dev)
    bb = 0.1 * torch.randn(h, device=dev)
    fns = {
        "FusedLayerNorm non-affine": (nonaff, [xb], []),
        "FusedLayerNorm affine": (aff, [xb], list(aff.parameters())),
        "fused_layer_norm_affine": (
            lambda x, w, b: norm.fused_layer_norm_affine(x, w, b, h),
            [xb, w, bb], []),
        "mixed_dtype_fused_layer_norm_affine": (
            lambda x, w, b: norm.mixed_dtype_fused_layer_norm_affine(
                x, w, b, h), [xb, w, bb], []),
    }
    res["normalization"] = {}
    for name, (fn, args, params) in fns.items():
        def run(fn=fn, args=args, params=params):
            a = [t.detach().requires_grad_(True) for t in args]
            for p in params:
                p.grad = None
            y = fn(*a)
            (y.float() * dy).sum().backward()
            return [y.detach()] + [t.grad for t in a] + [p.grad
                                                         for p in params]

        _zero_launches()
        got = run()
        calls = _launches()
        with plain_versions():
            ref = run()
        worst = max(_rel_err(g, r) for g, r in zip(got, ref))
        bwd = ("layer_norm_bwd_noaffine" if name.endswith("non-affine")
               else "layer_norm_bwd")
        log(f"  {name} ({' x '.join(map(str, xb.shape))} bf16): forward + "
            f"backward "
            f"{worst:.3e} of the largest element off the plain versions; "
            f"launches {calls}")
        check(worst <= MHA_REL_TOL, f"{name}: off its plain version by "
              f"{worst:.3e}")
        check(calls == {"layer_norm_fwd": 1, bwd: 1},
              f"{name}: launches {calls}, expected one layer_norm_fwd and "
              f"one {bwd}")
        res["normalization"][name] = dict(rel_err=worst, launches=calls)
        for k, n in calls.items():
            res["launches"][k] = res["launches"].get(k, 0) + n
    return res


# context parallelism on the one card: four ranks of a gloo group (the
# exchanges staged through host memory), each a process of its own. Ring
# and Ulysses attention at the GPT train cell's heads (B 2 x 8 heads of
# 128) over a 4096-token sequence, 1024 a rank, bf16; then the GPT at the
# train cell's widths (8 layers) with max_position_embeddings 4096 on B 2
# x 4096 tokens, fp32 with TF32 off (both sides on their fp32 kernels:
# the ring on the unpacked ones, the unsharded model on the packed ones).
CP_RANKS = 4
CP_ATTN = dict(batch=2, heads=8, head_dim=128, seq=4096)
CP_GPT_SEQ, CP_GPT_BATCH = 4096, 2
CP_JOIN_S = 300
# the ring rounds each hop's o to bf16 before the fp32 merge (as JAX's
# ring does) where the unsharded kernel rounds once: about a bf16 step
# of each output and, through the backward's products, of each gradient
CP_ATTN_REL_TOL = 3e-2
# fp32 on both sides, summation order only: the logits within
# PARITY_LOGIT_ATOL, each rank-summed gradient within 1e-4 of its
# largest element
CP_GRAD_REL_TOL = 1e-4


def _cp_rank(rank, n, workdir, spec):
    """One rank of the context-parallel phase (spawned): bind the
    "context" axis to the gloo group, run the cases, write rank<r>.pt
    (an ``error`` entry if a case raised)."""
    import datetime
    import traceback

    import torch.distributed as dist

    out = {}
    try:
        dev = torch.device(spec["device"], 0) if spec["device"] == "cuda" \
            else torch.device(spec["device"])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir}/store", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=120))
        from rocm_apex_tpu_torch.transformer import parallel_state

        parallel_state.set_axis_group("context")
        _cp_attention(rank, n, dev, spec, out)
        _cp_gpt(rank, n, dev, spec, out)
        parallel_state.clear_axis_groups()
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - the parent reports it
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def _cp_attention(rank, n, dev, spec, out):
    from rocm_apex_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse)
    from rocm_apex_tpu_torch.transformer.context_parallel import (
        ring_flash_attention, ulysses_attention)

    b, h, d, s = (spec["attn"][k] for k in ("batch", "heads", "head_dim",
                                            "seq"))
    sl = slice(rank * s // n, (rank + 1) * s // n)
    gen = torch.Generator().manual_seed(7)  # the same draw on every rank
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(
        torch.bfloat16).to(dev) for _ in range(4))
    for causal in (True, False):
        # the unsharded reference on the card: (b*h, s, d)
        fl = [t.reshape(b * h, s, d).clone().requires_grad_(True)
              for t in (q, k, v)]
        o_ref, _ = flash_attention_with_lse(*fl, None, causal)
        (o_ref.float() * do.reshape(b * h, s, d).float()).sum().backward()
        ref = [o_ref.detach()] + [t.grad for t in fl]
        ref = [t.view(b, h, s, d)[:, :, sl] for t in ref]
        shapes = dict(
            # ring: (b*h, s_local, d) shards
            ring=(ring_flash_attention,
                  lambda t: t[:, :, sl].reshape(b * h, -1, d),
                  lambda t: t.view(b, h, -1, d), rank + 1 if causal else n),
            # Ulysses: (b, s_local, h, d) shards
            ulysses=(ulysses_attention,
                     lambda t: t[:, :, sl].transpose(1, 2).contiguous(),
                     lambda t: t.transpose(1, 2), 1))
        for kind, (fn, shard, unshard, hops) in shapes.items():
            def run(fn=fn, shard=shard, unshard=unshard):
                sh = [shard(t).clone().requires_grad_(True)
                      for t in (q, k, v)]
                o = fn(*sh, "context", causal)
                (o.float() * shard(do).float()).sum().backward()
                return [unshard(t) for t in [o.detach()] + [t.grad
                                                            for t in sh]]

            _zero_launches()
            got = run()
            calls = _launches()
            # the same exchange on the plain versions, on the same shards:
            # each hop's kernels (the forward, the backward with its lse
            # cotangent) held to their plain versions at the hop's shapes
            with plain_versions():
                plain = run()
            out[f"{kind} causal={causal}"] = dict(
                rel_err=[_rel_err(g, r) for g, r in zip(got, ref)],
                plain_rel_err=[_rel_err(g, r) for g, r in zip(got, plain)],
                launches=calls, want_hops=hops)


def _cp_gpt(rank, n, dev, spec, out):
    import torch.distributed as dist

    from rocm_apex_tpu_torch.convert import from_jax_params, random_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig, hidden_dropout_seed

    base = dict(spec["gpt"], params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(GPTConfig(**base), seed=0)
    rng = np.random.default_rng(0)
    b, s = spec["gpt_batch"], spec["gpt_seq"]
    tokens = torch.from_numpy(rng.integers(0, base["vocab_size"], (b, s))).to(
        dev)
    labels = torch.roll(tokens, -1, 1)
    sl = slice(rank * s // n, (rank + 1) * s // n)
    ref = from_jax_params(tree, GPTConfig(**base), device=dev)
    cp = from_jax_params(tree, GPTConfig(**base,
                                         context_parallel_axis="context"),
                         device=dev)
    with torch.no_grad():
        want = ref(tokens)[:, sl]
        _zero_launches()
        got = cp(tokens[:, sl])
        calls = _launches()
        # the same shard on the plain versions: the fp32 hops' kernels
        # held to their plain versions at the hop's shapes
        with plain_versions():
            plain = cp(tokens[:, sl])
    out["gpt logits"] = dict(max_abs_err=float((got - want).abs().max()),
                             plain_max_abs_err=float(
                                 (got - plain).abs().max()),
                             finite=bool(torch.isfinite(got).all()),
                             launches=calls)
    del want, got, plain
    ref(tokens, labels=labels).sum().backward()
    with plain_versions():
        cp(tokens[:, sl], labels=labels[:, sl]).sum().backward()
    plain = {k: p.grad for k, p in cp.named_parameters()}
    cp.zero_grad(set_to_none=True)
    cp(tokens[:, sl], labels=labels[:, sl]).sum().backward()
    perrs = {k: _rel_err(p.grad, plain[k]) for k, p in cp.named_parameters()}
    out["gpt plain grads"] = dict(worst=max(perrs.values()),
                                  worst_name=max(perrs, key=perrs.get))
    del plain
    names = [k for k, _ in cp.named_parameters()]
    flat = torch.cat([p.grad.reshape(-1) for _, p in cp.named_parameters()])
    flat = flat.cpu()
    dist.all_reduce(flat)  # the caller's all-reduce over the group
    errs, at = {}, 0
    refs = dict(ref.named_parameters())
    for k in names:
        g = refs[k].grad
        part = flat[at:at + g.numel()].view(g.shape).to(dev)
        at += g.numel()
        errs[k] = _rel_err(part, g)
    out["gpt grads"] = dict(worst=max(errs.values()),
                            worst_name=max(errs, key=errs.get))
    del ref, flat
    cp.zero_grad(set_to_none=True)
    # one step at hidden dropout 0.1 from one generator state on every
    # rank: the rank folds into each site's seed
    drop = from_jax_params(tree, GPTConfig(
        **{**base, "hidden_dropout": 0.1}, context_parallel_axis="context"),
        device=dev)
    loss = drop(tokens[:, sl], labels=labels[:, sl], deterministic=False,
                dropout_generator=torch.Generator().manual_seed(3),
                loss_reduction="mean")
    loss.backward()
    out["gpt dropout"] = dict(
        loss=float(loss.detach()),
        seed=hidden_dropout_seed(torch.Generator().manual_seed(3), drop.cfg),
        grads_finite=all(bool(torch.isfinite(p.grad).all())
                         for p in drop.parameters()))


def run_context_parallel_phase(spec=None):
    """Context parallelism on one card (see CP_RANKS): four spawned ranks
    of a gloo group; ring and Ulysses attention forward and q/k/v
    gradients against unsharded `flash_attention_with_lse` on the card
    and against the same exchange on the same shards on the plain
    versions (`plain_versions`: each hop's forward and its backward with
    the lse cotangent held to their plain versions at the hop's shapes),
    with each rank's launches (the ring: one forward and one backward a
    hop it attends, none for a later rank's block under causal); the
    context-parallel GPT's logits and rank-summed parameter gradients
    against the unsharded model on the card (no packed launch under
    CP), and its logits and rank-local gradients against the same shard
    on the plain versions; one step at hidden dropout 0.1 with finite
    loss and a different seed, so a different mask, on every rank. The
    phase's times are the kernels' alone (one hop's forward timed
    here): the ranks share one card and exchange through host memory,
    which says nothing of a real interconnect."""
    import multiprocessing
    import tempfile

    from rocm_apex_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse)

    spec = spec or dict(
        device=CARD, attn=CP_ATTN,
        gpt={**TRAIN, "max_position_embeddings": CP_GPT_SEQ,
             "hidden_dropout": 0.0, "attention_dropout": 0.0},
        gpt_batch=CP_GPT_BATCH, gpt_seq=CP_GPT_SEQ)
    n = CP_RANKS
    res = dict(ranks=n, attn=spec["attn"], gpt_seq=spec["gpt_seq"])
    with tempfile.TemporaryDirectory() as workdir:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_cp_rank, args=(r, n, workdir, spec))
                 for r in range(n)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(CP_JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        res["ranks_s"] = time.perf_counter() - t0
        check(not hung, f"context_parallel: ranks {hung} did not finish in "
              f"{CP_JOIN_S} s")
        outs = []
        for r in range(n):
            path = os.path.join(workdir, f"rank{r}.pt")
            check(os.path.exists(path), f"context_parallel: rank {r} wrote "
                  f"nothing (exit code {procs[r].exitcode})")
            outs.append(torch.load(path, weights_only=False))
    for r, o in enumerate(outs):
        check("error" not in o, f"context_parallel rank {r}:\n"
              f"{o.get('error')}")
    res["cases"] = {}
    for kind in ("ring", "ulysses"):
        for causal in (True, False):
            key = f"{kind} causal={causal}"
            worst = max(max(o[key]["rel_err"]) for o in outs)
            plain = max(max(o[key]["plain_rel_err"]) for o in outs)
            log(f"  {key}: o, dq, dk, dv against unsharded "
                f"flash_attention_with_lse: worst max|err| / max|ref| "
                f"{worst:.3e}; against the same {kind} on the plain "
                f"versions {plain:.3e} (tol {CP_ATTN_REL_TOL:g}); launches "
                f"by rank {[o[key]['launches'] for o in outs]}")
            check(worst <= CP_ATTN_REL_TOL, f"{key}: off unsharded "
                  f"attention by {worst:.3e}")
            check(plain <= CP_ATTN_REL_TOL, f"{key}: off its plain "
                  f"versions by {plain:.3e}")
            for r, o in enumerate(outs):
                calls, hops = o[key]["launches"], o[key]["want_hops"]
                check(calls.get("flash_unpacked_fwd", 0) == hops
                      and calls.get("flash_unpacked_bwd", 0) == hops,
                      f"{key} rank {r}: launches {calls}, expected {hops} "
                      f"unpacked forwards and backwards")
            res["cases"][key] = dict(worst_rel_err=worst,
                                     worst_plain_rel_err=plain,
                                     launches=[o[key]["launches"]
                                               for o in outs])
    lg = [o["gpt logits"] for o in outs]
    err = max(x["max_abs_err"] for x in lg)
    perr = max(x["plain_max_abs_err"] for x in lg)
    log(f"  GPT ({spec['gpt']['num_layers']} layers, B "
        f"{spec['gpt_batch']} x {spec['gpt_seq']}, fp32): logits shard by "
        f"shard max|cp - unsharded| {err:.3e}, max|cp - cp on the plain "
        f"versions| {perr:.3e} (atol {PARITY_LOGIT_ATOL:g}); launches by "
        f"rank {[x['launches'] for x in lg]}")
    check(all(x["finite"] for x in lg), "context_parallel: nonfinite logits")
    check(err <= PARITY_LOGIT_ATOL, f"context_parallel GPT logits differ by "
          f"{err:.3e}")
    check(perr <= PARITY_LOGIT_ATOL, f"context_parallel GPT logits differ "
          f"from the plain versions' by {perr:.3e}")
    check(all(not any(k.startswith("flash_attention_qkv") for k in
                      x["launches"]) for x in lg),
          "context_parallel: the GPT launched the packed kernels")
    layers = spec["gpt"]["num_layers"]
    check(all(x["launches"].get("flash_unpacked_fwd", 0) == layers * (r + 1)
              for r, x in enumerate(lg)),
          "context_parallel: the GPT's ring forwards are not one a layer "
          "and attended hop")
    g = outs[0]["gpt grads"]
    log(f"  GPT rank-summed gradients against the unsharded model's: worst "
        f"max|err| / max|ref| {g['worst']:.3e} ({g['worst_name']}; tol "
        f"{CP_GRAD_REL_TOL:g})")
    check(g["worst"] <= CP_GRAD_REL_TOL, f"context_parallel: summed gradient "
          f"{g['worst_name']} off by {g['worst']:.3e}")
    pg = max((o["gpt plain grads"] for o in outs), key=lambda x: x["worst"])
    log(f"  GPT rank-local gradients against the same shard on the plain "
        f"versions: worst max|err| / max|ref| {pg['worst']:.3e} "
        f"({pg['worst_name']}; tol {CP_GRAD_REL_TOL:g})")
    check(pg["worst"] <= CP_GRAD_REL_TOL, f"context_parallel: gradient "
          f"{pg['worst_name']} off its plain versions by {pg['worst']:.3e}")
    dr = [o["gpt dropout"] for o in outs]
    log(f"  hidden dropout 0.1: losses {[x['loss'] for x in dr]}, first "
        f"site seeds {[x['seed'] for x in dr]}")
    check(all(math.isfinite(x["loss"]) and x["grads_finite"] for x in dr),
          "context_parallel: nonfinite dropout loss or gradient")
    check(len({x["seed"] for x in dr}) == n,
          "context_parallel: ranks drew the same dropout mask")
    res.update(gpt_logit_max_abs_err=err, gpt_grad_worst_rel_err=g["worst"],
               gpt_plain_logit_max_abs_err=perr,
               gpt_plain_grad_worst_rel_err=pg["worst"],
               dropout_losses=[x["loss"] for x in dr],
               dropout_seeds=[x["seed"] for x in dr])
    # the kernels' times alone: one ring hop's forward (full and causal)
    # and the unsharded forward it stands in for
    if spec["device"] == "cuda":
        b, h, d, s = (spec["attn"][k] for k in ("batch", "heads",
                                                "head_dim", "seq"))
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn(b * h, s, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        sl = s // n
        res["hop_full_ms"] = device_ms(lambda: flash_attention_with_lse(
            q[:, :sl], k[:, :sl], v[:, :sl], None, False), 50)
        res["hop_causal_ms"] = device_ms(lambda: flash_attention_with_lse(
            q[:, :sl], k[:, :sl], v[:, :sl], None, True), 50)
        res["unsharded_causal_ms"] = device_ms(
            lambda: flash_attention_with_lse(q, k, v, None, True), 50)
        log(f"  kernel times alone (not the exchange): a hop's forward "
            f"({b * h}, {sl}, {sl}, {d}) {res['hop_full_ms']:.4f} ms full, "
            f"{res['hop_causal_ms']:.4f} ms causal; the unsharded causal "
            f"forward ({b * h}, {s}, {s}, {d}) "
            f"{res['unsharded_causal_ms']:.4f} ms. The ranks' "
            f"{res['ranks_s']:.1f} s of wall time include spawning and the "
            f"host-staged gloo exchange on one card, which says nothing of "
            f"a real interconnect")
    res["launches"] = {}
    for x in lg:
        for k, c in x["launches"].items():
            res["launches"][k] = res["launches"].get(k, 0) + c
    return res


# the "jnp" serve: the serve phases' engines under attention_impl="jnp"
# (the one-pass reference attention in plain PyTorch; no attention kernel)
# the "jnp" serves' new tokens a request (the serve's 64 cut to 32, then
# to 16, to keep the smoke inside its time limit)
JNP_NEW = 16
JNP_FORMS = (("contiguous", dict()),
             ("paged", dict(paged=True, page_size=PAGE_SIZE)),
             ("paged_int8", dict(paged=True, page_size=PAGE_SIZE,
                                 kv_dtype=torch.int8)),
             ("whole_prompt", dict(whole=True)))


def _attention_kernel_names():
    from rocm_apex_tpu_torch.ops._build import KERNELS

    return [k.name for k in KERNELS
            if k.source.startswith("flash_") or k.source == "softmax.cu"]


def run_serve_jnp_phase(flash_tokens=None):
    """attention_impl="jnp" on the serving engines: first parity at 2
    layers, fp32, TF32 off (the card's "jnp" engine gives the CPU "jnp"
    engine's greedy tokens on the same weights, in each form of
    JNP_FORMS), then the serve at SERVE (8 layers, bf16) in each form: 32
    requests, every one to JNP_NEW, no attention kernel launched and the
    LayerNorm forward present; the share of requests whose tokens equal
    the flash engine's (the serve phase's, or a run here) is printed."""
    from rocm_apex_tpu_torch.convert import from_jax_params, random_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(**{**SERVE, "num_layers": 2}, params_dtype=torch.float32,
                    dtype=torch.float32, attention_impl="jnp")
    tree = random_params(cfg, seed=0)
    models = {dev: from_jax_params(tree, cfg, device=dev)
              for dev in (CARD, "cpu")}
    prompts = serve_prompts(cfg.vocab_size)[:6]
    res = dict(parity={}, forms={})
    for form, kw in JNP_FORMS:
        toks = {dev: _tokens(_engine(m, **kw), prompts, PARITY_NEW)
                for dev, m in models.items()}
        same = toks[CARD] == toks["cpu"]
        log(f"  parity, {form}: \"jnp\" greedy tokens of {len(prompts)} "
            f"requests x {PARITY_NEW}, 2 layers fp32: cuda "
            f"{'==' if same else '!='} cpu")
        check(same, f"serve_jnp parity {form}: {toks}")
        res["parity"][form] = same
    del models
    flash_model, load_s = _serve_model()
    prompts = serve_prompts(SERVE["vocab_size"])
    if flash_tokens is None:
        flash_tokens = _tokens(_engine(flash_model), prompts, MAX_NEW)
    jcfg = GPTConfig(**SERVE, params_dtype=torch.float32,
                     dtype=torch.bfloat16, attention_impl="jnp")
    model = from_jax_params(random_params(jcfg, seed=0), jcfg, device=CARD)
    attention = _attention_kernel_names()
    res["launches"] = {}
    for form, kw in JNP_FORMS:
        log(f"  -- {form}")
        eng = _engine(model, **kw)
        eng.generate(prompts[:SLOTS], max_new_tokens=3)  # warm-up
        r, tokens = timed_serve(eng, prompts, JNP_NEW)
        r["requests_matching_flash"] = sum(
            a == b[:JNP_NEW] for a, b in zip(tokens, flash_tokens))
        log(f"  {r['requests_matching_flash']}/{len(prompts)} requests give "
            f"the flash engine's tokens (contiguous flash serve)")
        launched = {k: r["launches"][k] for k in attention
                    if r["launches"].get(k)}
        check(not launched, f"serve_jnp {form}: attention kernels launched "
              f"{launched}")
        check(r["launches"]["layer_norm_fwd"] > 0,
              f"serve_jnp {form}: no LayerNorm forward")
        res["forms"][form] = r
        for k, n in r["launches"].items():
            res["launches"][k] = res["launches"].get(k, 0) + n
    return res


# ---------------------------------------------------------------------------
# phase 25: the rest of the optimizers and amp's function casting
# ---------------------------------------------------------------------------

# card-vs-CPU parity of each optimizer on the leaves of BERT-Large's widths
# at 2 layers (hidden 1024, FFN 4096, the 30592-row embedding: BERT's
# `random_params`, 59.5M values), three steps of seeded normal gradients
# times OPTIM_GRAD_SCALE. Both devices compute in fp32 and differ only in
# the summation order of the norms (NovoGrad's, LAMB's) and in contracted
# multiply-adds: each param within PACKED_MASTER_RTOL of |p0| + |step|
# plus OPTIM_STEP_SHARE of its leaf's largest step on the CPU (the step
# each optimizer really takes: a LAMB step is lr times a trust ratio of
# ~0.02, an SGD step lr times a gradient of ~1e-2, so a share of lr would
# pass a trust ratio off by 2x), a bf16 param to one bf16 step (2^-7) of
# the CPU's beside them; every state leaf within OPTIM_STATE_RTOL of its
# largest CPU element; a skipped step bit for bit as its input, on both
# devices
OPTIM_PARITY_LAYERS = 2
OPTIM_PARITY_STEPS = 3
OPTIM_GRAD_SCALE = 1e-2
OPTIM_STATE_RTOL = 1e-5
OPTIM_STEP_SHARE = 1e-2
OPTIM_BF16_STEP = 2.0 ** -7
# the LAMB pair over packed buffers (`FusedLAMB(packed=True)`, one dtype
# group of fp32 masters): wrapper calls a step, the fused unscale and
# probe pass, the trust ratio's two segmented row sums, stages 1 and 2
PACKED_LAMB_CALLS_PER_STEP = {"scale_sumsq": 1, "row_sumsq": 2,
                              "lamb_stage1": 1, "lamb_stage2": 1,
                              "adam_update": 0, "lamb_leaf_stage1": 0,
                              "lamb_leaf_stage2": 0}
OPTIM_KERNELS = ("lamb_stage1", "lamb_stage2", "row_sumsq")
OPTIM_INF_LEAF = "embedding.word_embeddings.weight"  # where an inf goes
O4_STEPS = 3
LAMB_DEVICE_STEPS = 5  # steps a LAMB step's device time is taken over


def _optim_leaves():
    """The parity leaves (fp32, CPU) by name, their no-decay mask
    (bert_pretrain.py's: ndim <= 1, LayerNorms, biases) and the three
    steps' gradients."""
    from rocm_apex_tpu_torch.convert import flatten_params, random_params
    from rocm_apex_tpu_torch.models.bert import BertConfig

    cfg = BertConfig(**{**BERT, "num_layers": OPTIM_PARITY_LAYERS})
    flat = flatten_params(random_params(cfg, seed=0)["params"])
    leaves = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in flat.items()}
    gen = torch.Generator().manual_seed(5)
    grads = [{k: OPTIM_GRAD_SCALE * torch.randn(v.shape, generator=gen)
              for k, v in leaves.items()} for _ in range(OPTIM_PARITY_STEPS)]
    return leaves, bert_no_decay_mask(leaves), grads


def bert_no_decay_mask(params):
    """bert_pretrain.py's LAMB decay mask: no decay for leaves of ndim <=
    1, LayerNorms and biases."""
    return {k: not (v.ndim <= 1 or "layernorm" in k.lower()
                    or "bias" in k.lower()) for k, v in params.items()}


def _state_leaves(state, prefix="state"):
    """(name, tensor) for every tensor of an optimizer state: NamedTuple
    fields, dicts by name, tuples (packed buffers) by index."""
    if torch.is_tensor(state):
        return [(prefix, state)]
    if hasattr(state, "_fields"):
        items = zip(state._fields, state)
    elif isinstance(state, dict):
        items = state.items()
    else:
        items = enumerate(state)
    return [x for k, v in items for x in _state_leaves(v, f"{prefix}.{k}")]


def _param_err(card, cpu, p0, rel_slack=0.0):
    """The worst |card - cpu| over its tolerance among the params, and
    where: PACKED_MASTER_RTOL of |p0| + |step| plus OPTIM_STEP_SHARE of
    the leaf's largest step |cpu - p0| (plus one bf16 step for a bf16
    param, and ``rel_slack`` of |cpu|). Computed a leaf at a time on
    ``card``'s device."""
    worst, where = 0.0, None
    for k, v in cpu.items():
        c = card[k].float()
        v, p = v.to(c.device).float(), p0[k].to(c.device).float()
        step = (v - p).abs()
        tol = (PACKED_MASTER_RTOL * (p.abs() + step)
               + OPTIM_STEP_SHARE * step.max())
        if cpu[k].dtype == torch.bfloat16:
            tol = tol + OPTIM_BF16_STEP * v.abs()
        if rel_slack:
            tol = tol + rel_slack * v.abs()
        # equal values pass where the tolerance is 0 (a leaf that did
        # not move); any difference there is infinitely over it
        r = float(torch.where(c == v, 0.0, (c - v).abs() / tol).max())
        if r > worst:
            worst, where = r, k
    return worst, where


def _state_err(card, cpu):
    """The worst |card - cpu| / (OPTIM_STATE_RTOL * max |cpu|) over the
    state's float leaves; the int leaves (counts) must be equal."""
    worst, where = 0.0, None
    for (k, c), (_, v) in zip(_state_leaves(card), _state_leaves(cpu)):
        c = c.cpu()
        if not v.is_floating_point():
            check(torch.equal(c, v), f"{k}: {c} on the card, {v} on the cpu")
            continue
        r = float((c.float() - v.float()).abs().max() / (
            OPTIM_STATE_RTOL * v.float().abs().max() + 1e-30))
        if r > worst:
            worst, where = r, k
    return worst, where


def _same_tree(a, b):
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(_state_leaves(a), _state_leaves(b)))


def _optim_configs(mask):
    """(name, factory) of every optimizer configuration the parity
    runs."""
    from rocm_apex_tpu_torch import optimizers as o

    def novo(n, inside):
        return lambda: o.FusedNovoGrad(1e-3, weight_decay=1e-3, norm_type=n,
                                       reg_inside_moment=inside)

    return [
        ("sgd", lambda: o.FusedSGD(0.1)),
        ("sgd_momentum_dampening",
         lambda: o.FusedSGD(0.1, momentum=0.9, dampening=0.1)),
        ("sgd_nesterov",
         lambda: o.FusedSGD(0.1, momentum=0.9, nesterov=True)),
        ("sgd_wd_after_momentum",
         lambda: o.FusedSGD(0.1, momentum=0.9, weight_decay=1e-4,
                            wd_after_momentum=True)),
        ("adagrad", lambda: o.FusedAdagrad(1e-2, weight_decay=1e-4)),
        ("adagrad_w_mode",
         lambda: o.FusedAdagrad(1e-2, weight_decay=1e-4,
                                adagrad_w_mode=True)),
        *[(f"novograd_norm{n}_{'inside' if r else 'decoupled'}",
           novo(n, r)) for n in (2, 0) for r in (True, False)],
        ("lamb_tree",
         lambda: o.FusedLAMB(1e-3, weight_decay=0.01, weight_decay_mask=mask)),
        ("lamb_packed",
         lambda: o.FusedLAMB(1e-3, weight_decay=0.01, weight_decay_mask=mask,
                             packed=True)),
    ]


def _to(tree, dev):
    return {k: v.to(dev) for k, v in tree.items()}


def _optim_parity(leaves, mask, grads):
    """Each configuration of `_optim_configs` three steps on the card and
    on the CPU, then the scaler-aware optimizers with a skipped step."""
    import warnings

    from rocm_apex_tpu_torch import fp16_utils
    from rocm_apex_tpu_torch.amp import all_finite
    from rocm_apex_tpu_torch.contrib.optimizers import FusedAdam as CAdam
    from rocm_apex_tpu_torch.optimizers import (FusedAdam,
                                                FusedMixedPrecisionLamb)
    from rocm_apex_tpu_torch.transformer import parallel_state
    from rocm_apex_tpu_torch.transformer.amp import GradScaler

    out = {}

    def record(name, runs, p0, extra=None):
        (pc, sc), (pp, sp) = runs[CARD], runs["cpu"]
        perr, pwhere = _param_err(pc, pp, p0)
        serr, swhere = _state_err(sc, sp)
        out[name] = dict(param_err_over_tol=perr, param_worst=pwhere,
                         state_err_over_tol=serr, state_worst=swhere,
                         **(extra or {}))
        log(f"  {name}: params {perr:.3f} of their tolerance ({pwhere}), "
            f"state {serr:.3f} ({swhere})"
            + (f"; {extra}" if extra else ""))
        check(perr <= 1.0 and serr <= 1.0,
              f"optim parity {name}: params {perr:.3g}, state {serr:.3g} "
              f"of their tolerances")

    for name, make in _optim_configs(mask):
        runs = {}
        for dev in (CARD, "cpu"):
            opt, p = make(), _to(leaves, dev)
            s = opt.init(p)
            for g in grads:
                p, s = opt.step(p, _to(g, dev), s)
            runs[dev] = (p, s)
        record(name, runs, leaves)

    # FusedMixedPrecisionLamb on mixed fp32/bf16 leaves (the matrices in
    # bf16), gradients carrying a loss scale of 1024 with inv_scale, and
    # an inf in one gradient at step 2: found_inf on the device, a step
    # that leaves params, moments and count bit for bit as they were
    mixed = {k: v.to(torch.bfloat16) if v.ndim >= 2 else v
             for k, v in leaves.items()}
    seq = grads[:2] + [{k: v.clone() for k, v in grads[2].items()}] + \
        grads[2:]
    seq[2][OPTIM_INF_LEAF][7, 7] = float("inf")
    runs, frozen = {}, True
    for dev in (CARD, "cpu"):
        opt, p = FusedMixedPrecisionLamb(1e-3, weight_decay=0.01,
                                         weight_decay_mask=mask), \
            _to(mixed, dev)
        s = opt.init(p)
        for g in seq:
            g = {k: (v * 1024.0).to(mixed[k].dtype).to(dev)
                 for k, v in g.items()}
            found = torch.logical_not(all_finite(g.values()))
            p2, s2 = opt.step(p, g, s, inv_scale=1.0 / 1024, found_inf=found)
            if bool(found):
                frozen &= _same_tree(p2, p) and _same_tree(s2, s)
            p, s = p2, s2
        runs[dev] = (p, s)
    record("mp_lamb", runs, mixed,
           dict(found_inf_step_frozen=frozen,
                count=int(runs[CARD][1].count)))
    check(frozen and int(runs[CARD][1].count) == OPTIM_PARITY_STEPS,
          "mp_lamb: the found_inf step changed params, moments or count")

    # the deprecated contrib FusedAdam: gradients times 128,
    # step_with_scale(scale=128)
    runs = {}
    for dev in (CARD, "cpu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            opt = CAdam(1e-3, weight_decay=0.01)
        p = _to(leaves, dev)
        s = opt.init(p)
        for g in grads:
            p, s = opt.step_with_scale(
                p, {k: v.to(dev) * 128.0 for k, v in g.items()}, s,
                scale=128.0)
        runs[dev] = (p, s)
    record("contrib_fused_adam", runs, leaves)

    # FP16_Optimizer over FusedAdam: fp16 params, dynamic scaling from
    # 2^16, the fp16 gradients of the scaled loss (made on the CPU, the
    # same bits to both devices), an inf at step 1: skipped, the scale
    # halved
    half = fp16_utils.network_to_half(leaves)
    runs, frozen, scales = {}, True, {}
    for dev in (CARD, "cpu"):
        opt = fp16_utils.FP16_Optimizer(
            FusedAdam(1e-3, weight_decay=0.01), dynamic_loss_scale=True,
            dynamic_loss_args=dict(init_scale=2.0 ** 16))
        st = opt.init(_to(half, dev))
        scales[dev] = []
        for i, g in enumerate(grads):
            scale = float(st.scaler_state.loss_scale)
            g16 = {k: (v * scale).half() for k, v in g.items()}
            if i == 1:
                g16[OPTIM_INF_LEAF][7, 7] = float("inf")
            st2 = opt.step(st, _to(g16, dev))
            if i == 1:
                frozen &= _same_tree(st2.master_params, st.master_params) \
                    and _same_tree(st2.inner_state, st.inner_state) \
                    and _same_tree(st2.model_params, st.model_params)
            st = st2
            scales[dev].append(float(st.scaler_state.loss_scale))
        runs[dev] = (st.master_params, st.inner_state)
    record("fp16_optimizer", runs, half,
           dict(loss_scales=scales[CARD], overflow_step_frozen=frozen))
    check(frozen and scales[CARD] == scales["cpu"] == [2.0 ** 16, 2.0 ** 15,
                                                        2.0 ** 15],
          f"fp16_optimizer: the overflow step (frozen {frozen}, scales "
          f"{scales})")

    # the transformer GradScaler, one rank and no axis bound: the found_inf
    # of each step's gradients (an inf at step 1) passes through unsynced
    parallel_state.clear_axis_groups()
    states = {}
    for dev in (CARD, "cpu"):
        scaler = GradScaler(init_scale=2.0 ** 16, growth_interval=2)
        ss, states[dev] = scaler.init(torch.device(dev)), []
        for i, g in enumerate(grads + grads[:1]):
            g = {k: v.to(dev, copy=True) for k, v in g.items()}
            if i == 1:
                g[OPTIM_INF_LEAF][7, 7] = float("nan")
            ss, skip = scaler.update(ss, torch.logical_not(
                all_finite(g.values())))
            states[dev].append((float(ss.loss_scale), int(ss.unskipped),
                                int(ss.overflows), bool(skip)))
    out["grad_scaler"] = dict(states=states[CARD])
    log(f"  grad_scaler (no axis bound): {states[CARD]}")
    check(states[CARD] == states["cpu"] and [x[3] for x in states[CARD]]
          == [False, True, False, False], f"grad_scaler: {states}")
    return out


def _bert_lamb_trainer(cfg, packed):
    """``(step, master, state)``: bert_pretrain.py's recipe at bench.py
    bert's shape: fp32 params (the masters), the model holding their
    compute copy, the tree (or packed) `FusedLAMB(1e-4, wd 0.01)` with
    the example's no-decay mask, the mean of the per-token losses. A
    leaf the loss does not reach (the token-type embedding: no ids are
    given) takes a zero gradient, as under `jax.grad`."""
    from rocm_apex_tpu_torch.convert import (flatten_params, from_jax_params,
                                             random_params)
    from rocm_apex_tpu_torch.optimizers import FusedLAMB

    tree = random_params(cfg, seed=0)
    model = from_jax_params(tree, cfg, device=CARD)
    master = {k: torch.from_numpy(np.asarray(v, np.float32)).to(CARD)
              for k, v in flatten_params(tree["params"]).items()}
    opt = FusedLAMB(1e-4, weight_decay=0.01,
                    weight_decay_mask=bert_no_decay_mask(master),
                    packed=packed)
    named = dict(model.named_parameters())
    zeros = {k: torch.zeros_like(p) for k, p in master.items()}

    def step(master, state, tokens, labels):
        with torch.no_grad():
            for k, p in master.items():
                named[k].copy_(p)
        for p in named.values():
            p.grad = None
        losses, _ = model(tokens, lm_labels=labels)
        loss = losses.mean()
        loss.backward()
        grads = {k: zeros[k] if named[k].grad is None else named[k].grad
                 for k in master}
        master, state = opt.step(master, grads, state)
        return master, state, loss.detach()

    return step, master, opt.init(master)


def _bert_lamb_run(packed, tree_first=None):
    """One form's run: TRAIN_WARMUP steps, TRAIN_STEPS timed, then the
    device time of a step. Returns ``(res, first)``: ``first`` is the
    tree run's masters before and after its first step, on the host; the
    packed run (``tree_first`` given) holds its masters after its first
    step, the same params and batch, to the tree's by `_param_err`."""
    from rocm_apex_tpu_torch.models.bert import BertConfig

    torch.cuda.empty_cache()
    # bert_pretrain.py's model has no binary head
    cfg = BertConfig(**BERT, params_dtype=torch.float32,
                     dtype=torch.bfloat16, add_binary_head=False)
    t0 = time.perf_counter()
    step, master, state = _bert_lamb_trainer(cfg, packed)
    setup_s = time.perf_counter() - t0
    tokens, labels = _bert_batch(cfg, BERT_BATCH, BERT_SEQ)
    tokens, labels = tokens.to(CARD), labels.to(CARD)
    form = "packed" if packed else "tree"
    first, vs_tree = None, None
    if tree_first is None:
        p0 = {k: v.cpu() for k, v in master.items()}
    losses = []
    for i in range(TRAIN_WARMUP):
        master, state, loss = step(master, state, tokens, labels)
        losses.append(loss)
        if i == 0 and tree_first is None:
            first = (p0, {k: v.cpu() for k, v in master.items()})
        elif i == 0:
            err, where = _param_err(master, tree_first[1], tree_first[0])
            vs_tree = dict(err_over_tol=err, worst=where)
    _sync()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        master, state, loss = step(master, state, tokens, labels)
        losses.append(loss)
    _sync()
    dt = time.perf_counter() - t0
    launches = _launches()
    losses = [float(x) for x in losses]
    want = {**bert_calls(cfg.num_layers, 0, TRAIN_STEPS, 0),
            **{k: (n if packed else 0) * TRAIN_STEPS
               for k, n in PACKED_LAMB_CALLS_PER_STEP.items()}}
    res = dict(form=form, step_ms=1e3 * dt / TRAIN_STEPS, seconds=dt,
               tokens_per_s=BERT_BATCH * BERT_SEQ * TRAIN_STEPS / dt,
               loss_first=losses[0], loss_last=losses[-1], losses=losses,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               setup_s=setup_s, launches=launches, expected_launches=want,
               count=int(state.count), first_step_vs_tree=vs_tree)
    log(f"  BERT-Large FusedLAMB ({form}): {res['step_ms']:.2f} ms/step, "
        f"{res['tokens_per_s']:.1f} tokens/s; loss {losses[0]:.4f} (first) "
        f"-> {losses[-1]:.4f} (last); peak {res['peak_mem_gib']:.2f} GiB; "
        f"launches {launches}")
    if vs_tree is not None:
        log(f"  masters after the first step, packed vs tree: "
            f"{vs_tree['err_over_tol']:.3g} of the tolerance (worst "
            f"{vs_tree['worst']})")
        check(vs_tree["err_over_tol"] <= 1.0, f"packed LAMB's first step "
              f"differs from the tree's: {vs_tree}")
    check(all(math.isfinite(x) for x in losses), f"nonfinite {form} loss")
    check(losses[-1] < losses[0], f"the {form} LAMB loss did not fall")
    check(res["count"] == TRAIN_WARMUP + TRAIN_STEPS, f"{form}: count "
          f"{res['count']}")
    for name, n in want.items():
        check(launches.get(name, 0) == n, f"{form} LAMB: {name} "
              f"{launches.get(name, 0)} launches in {TRAIN_STEPS} steps, "
              f"expected {n}")
    # the step's device time alone (calls queued behind a sleep): beside
    # step_ms it says how much of the step the host holds the card back
    res["device_step_ms"] = device_ms(
        lambda: step(master, state, tokens, labels), LAMB_DEVICE_STEPS,
        warmup=1)
    log(f"  ({form}: {res['device_step_ms']:.2f} ms a step on the device, "
        f"busy {res['device_step_ms'] / res['step_ms']:.0%})")
    return res, first


def _o4_gpt_run():
    """The GPT at the train widths under amp O4: fp32 params, the loss in
    `amp.policy_function` (a bf16 compute copy made by the cast, fp32
    gradients through it), the tree FusedAdam with O4's loss scale 1."""
    from rocm_apex_tpu_torch import amp
    from rocm_apex_tpu_torch.convert import flatten_params, random_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from rocm_apex_tpu_torch.optimizers import FusedAdam
    from rocm_apex_tpu_torch.optimizers._common import apply_updates

    torch.cuda.empty_cache()
    cfg = GPTConfig(**TRAIN, params_dtype=torch.float32,
                    dtype=torch.bfloat16)
    model = GPTModel(cfg, device=CARD)
    params = {k: torch.from_numpy(np.asarray(v, np.float32)).to(CARD)
              for k, v in flatten_params(
                  random_params(cfg, seed=0)["params"]).items()}
    params, opt, st = amp.initialize(
        params, FusedAdam(1e-4, weight_decay=0.01), opt_level="O4",
        verbosity=0)
    check(amp.current_policy() is st.policy and all(
        p.dtype == torch.float32 for p in params.values()),
        "O4: params not fp32 or the policy not active")
    opt_state = opt.init(params)

    @amp.policy_function
    def loss_fn(p, tokens, labels, gen):
        return torch.func.functional_call(
            model, p, (tokens,), dict(labels=labels, loss_reduction="mean",
                                      deterministic=False,
                                      dropout_generator=gen))

    tokens, labels = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens, labels = tokens.to(CARD), labels.to(CARD)
    gen = torch.Generator().manual_seed(0)
    grad_dtypes = set()

    def step(params, opt_state, st):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        scaled = amp.scale_loss(loss_fn(p, tokens, labels, gen), st)
        names = list(p)
        grads = dict(zip(names, torch.autograd.grad(
            scaled, [p[k] for k in names])))
        grad_dtypes.update((k, g.dtype) for k, g in grads.items())
        grads, found_inf = amp.unscale_grads(grads, st)
        st, _ = amp.update_scale(st, found_inf)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, st, scaled.detach()

    params, opt_state, st, loss = step(params, opt_state, st)  # warm-up
    losses = [loss]
    _sync()
    _zero_launches()
    t0 = time.perf_counter()
    for _ in range(O4_STEPS):
        params, opt_state, st, loss = step(params, opt_state, st)
        losses.append(loss)
    _sync()
    dt = time.perf_counter() - t0
    launches = _launches()
    losses = [float(x) for x in losses]
    non_f32 = sorted(k for k, d in grad_dtypes if d != torch.float32)
    res = dict(step_ms=1e3 * dt / O4_STEPS, losses=losses,
               loss_scale=float(st.loss_scale), launches=launches,
               grads_fp32=not non_f32, params_fp32=all(
                   p.dtype == torch.float32 for p in params.values()))
    log(f"  GPT O4 (policy_function, fp32 params, tree FusedAdam): "
        f"{res['step_ms']:.2f} ms/step over {O4_STEPS} steps; losses "
        f"{losses}; loss scale {res['loss_scale']:g}; launches {launches}")
    check(all(math.isfinite(x) for x in losses), "O4: nonfinite loss")
    check(not non_f32, f"O4: gradients not fp32: {non_f32}")
    check(res["params_fp32"] and res["loss_scale"] == 1.0,
          "O4: params left fp32 or the loss scale left 1")
    for name, n in TRAIN_CALLS_PER_STEP.items():
        check(launches.get(name, 0) == n * O4_STEPS,
              f"O4: {name} {launches.get(name, 0)} calls in {O4_STEPS} "
              f"steps, expected {n} a step")
    return res


def _o1_check():
    """O1 on a decorated matmul and softmax: fp16 out of `half_function`,
    fp32 out of `float_function`, uncast inside `disable_casts()`, and
    uncast again after `amp.initialize(opt_level="O5")`."""
    from rocm_apex_tpu_torch import amp

    @amp.half_function
    def mm(a, b):
        return a @ b

    @amp.float_function
    def sm(x):
        return torch.softmax(x, dim=-1)

    gen = torch.Generator().manual_seed(2)
    a, b = (torch.randn(1024, 1024, generator=gen).to(CARD)
            for _ in range(2))
    amp.initialize({"w": a}, opt_level="O1", verbosity=0)
    y = mm(a, b)
    z = sm(y)
    with amp.disable_casts():
        y_off = mm(a, b)
    amp.initialize({"w": a}, opt_level="O5", verbosity=0)
    y_o5 = mm(a, b)
    res = dict(o1=str(y.dtype), softmax=str(z.dtype),
               disable_casts=str(y_off.dtype), after_o5=str(y_o5.dtype),
               mm_equal=bool(torch.equal(y, a.half() @ b.half())),
               softmax_err=max_err(z, torch.softmax(y.float(), dim=-1)))
    log(f"  O1: {res}")
    check(y.dtype == torch.float16 and z.dtype == torch.float32
          and y_off.dtype == torch.float32 and y_o5.dtype == torch.float32
          and amp.current_policy() is None and res["mm_equal"]
          and res["softmax_err"] == 0.0, f"O1 casting: {res}")
    return res


def run_optim_amp_phase(report):
    """Queue 1 item 7 on the card: (1) each new optimizer card vs CPU; (2)
    bert_pretrain.py's recipe (tree and packed FusedLAMB) at bench.py
    bert's shape beside bert_train's MixedPrecisionLamb step; (3)
    imagenet_train.py's FusedSGD on the fused ResNet-50 under O5 beside
    rn50_train_fused's FusedAdam step; (4) O4 on the GPT at the train
    widths and O1 on decorated functions."""
    from rocm_apex_tpu_torch import amp
    from rocm_apex_tpu_torch.optimizers import FusedSGD

    try:
        leaves, mask, grads = _optim_leaves()
        log(f"  parity leaves: {len(leaves)}, "
            f"{sum(v.numel() for v in leaves.values()) / 1e6:.1f}M values")
        res = dict(parity=_optim_parity(leaves, mask, grads))
        del leaves, grads
        tree, first = _bert_lamb_run(False)
        packed, _ = _bert_lamb_run(True, tree_first=first)
        del first
        mp = report.get("bert_train", {}).get("step_ms")
        mp_dev = report.get("bert_train", {}).get("device_step_ms")
        res["bert"] = dict(tree=tree, packed=packed,
                           mixed_precision_lamb_step_ms_same_call=mp,
                           mixed_precision_lamb_device_step_ms=mp_dev)
        log(f"  BERT-Large step ms: tree {tree['step_ms']:.2f}, packed "
            f"{packed['step_ms']:.2f}, MixedPrecisionLamb (bert_train) "
            f"{mp if mp is None else f'{mp:.2f}'}; on the device: "
            f"{tree['device_step_ms']:.2f}, {packed['device_step_ms']:.2f},"
            f" {mp_dev if mp_dev is None else f'{mp_dev:.2f}'}; first "
            f"losses {tree['loss_first']!r} / {packed['loss_first']!r}")
        check(tree["loss_first"] == packed["loss_first"],
              "the tree and packed LAMB runs' first losses differ")
        # the launches of this phase's main path: the packed LAMB steps
        res["launches"] = packed["launches"]
        sgd = run_rn50_train_phase(False, True, optimizer=FusedSGD(
            0.1, momentum=0.9, weight_decay=1e-4))
        adam = report.get("rn50_train_fused", {}).get("step_ms")
        sgd["fused_adam_step_ms_same_call"] = adam
        log(f"  ResNet-50 fused O5 step ms: FusedSGD {sgd['step_ms']:.2f}, "
            f"FusedAdam (rn50_train_fused) "
            f"{adam if adam is None else f'{adam:.2f}'}")
        res["rn50_sgd"] = sgd
        res["o4_gpt"] = _o4_gpt_run()
        res["o1"] = _o1_check()
    finally:
        amp.init(None)
    return res


# ---------------------------------------------------------------------------
# phase head_dims: GPT/BERT at the public models' head dims
# ---------------------------------------------------------------------------


def _hd_cfg(name, dtype, **kw):
    from rocm_apex_tpu_torch.models.bert import BertConfig
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    cls = BertConfig if name.endswith("bert") else GPTConfig
    return cls(**{**HD_MODELS[name], **kw}, params_dtype=torch.float32,
               dtype=dtype)


def _hd_flash_launches():
    return {k: v for k, v in _launches().items() if k in HD_FLASH_KERNELS}


def _hd_prompts(vocab, n, seed=0, lengths=(32, 64, 128, 256)):
    """``n`` prompts of uniform token ids, their lengths drawn from
    ``lengths`` (RandomState(seed))."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=int(rng.choice(lengths))).tolist()
            for _ in range(n)]


def _hd_losses_fall(name, losses):
    check(all(math.isfinite(x) for x in losses),
          f"{name}: a nonfinite loss {losses}")
    check(losses[-1] < losses[0], f"{name}: the loss did not fall {losses}")


def _hd_train(name, lr, tree):
    """HD_TRAIN_STEPS O5 steps of ``name`` (MixedPrecisionAdam under the
    dynamic LossScaler; the wide models with dropout HD_DROPOUT, the
    recipe at its own dropout 0) on one batch: each step's ms, the peak
    memory, the flash kernels' launches over the steps."""
    drop = HD_DROPOUT if name in ("gptj", "gpt3_2.7b") else 0.0
    cfg = _hd_cfg(name, torch.bfloat16, hidden_dropout=drop,
                  attention_dropout=drop)
    b, s = HD_TRAIN_SHAPES[name]
    t0 = time.perf_counter()
    step, state, sstate = _trainer(cfg, CARD, lr, tree=tree)
    setup_s = time.perf_counter() - t0
    tokens, labels = (t.to(CARD) for t in _train_batch(cfg, b, s))
    gen = torch.Generator().manual_seed(0)  # CPU: the dropout seeds
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, step_ms = [], []
    for _ in range(HD_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, sstate, loss = step(state, sstate, tokens, labels,
                                   dropout_generator=gen)
        losses.append(float(loss))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    res = dict(batch=b, seq=s, head_dim=cfg.head_dim, dropout=drop, lr=lr,
               losses=losses, step_ms=step_ms, setup_s=setup_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=_hd_flash_launches(),
               overflows=int(sstate.overflows))
    del step, state, sstate
    torch.cuda.empty_cache()
    return res


def _hd_bert_train(name, lr, tree):
    """HD_TRAIN_STEPS masked steps of the BERT recipe under
    MixedPrecisionLamb (bf16 moments as bench.py's BERT), a padding mask
    of seeded lengths."""
    from rocm_apex_tpu_torch.convert import (flatten_params,
                                             train_state_from_jax_params)
    from rocm_apex_tpu_torch.optimizers import MixedPrecisionLamb
    from rocm_apex_tpu_torch.train import make_bert_train_step

    cfg = _hd_cfg(name, torch.bfloat16, hidden_dropout=0.0,
                  attention_dropout=0.0)
    b, s = HD_TRAIN_SHAPES[name]
    mask = {k: not (k.endswith("bias") or "layernorm" in k.lower())
            for k in flatten_params(tree["params"])}
    opt = MixedPrecisionLamb(lr, weight_decay=0.01, weight_decay_mask=mask,
                             compute_dtype=cfg.dtype,
                             moment_dtype=torch.bfloat16, store_model=False)
    model, state = train_state_from_jax_params(tree, cfg, opt, device=CARD)
    step = make_bert_train_step(model, opt)
    tokens, labels = (t.to(CARD) for t in _bert_batch(cfg, b, s))
    lens = np.random.RandomState(3).randint(s // 4, s + 1, b)
    lens[0] = s
    amask = padding_mask(lens, s).to(CARD)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, step_ms, found = [], [], []
    for _ in range(HD_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss, inf = step(state, tokens, labels, attention_mask=amask)
        losses.append(float(loss))
        found.append(bool(inf))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    check(not any(found), f"{name}: a LAMB step found an overflow")
    return dict(batch=b, seq=s, head_dim=cfg.head_dim, lr=lr,
                lengths=[int(x) for x in lens], losses=losses,
                step_ms=step_ms,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches=_hd_flash_launches())


def _hd_serve(name, tree):
    """The bf16 model on the chunked engine (8 slots, capacity 1024,
    budget 256, greedy): HD_SERVE's requests on the contiguous cache,
    then on pages of PAGE_SIZE, each timed with the flash kernels'
    launches; the pages must give the contiguous tokens in every
    request."""
    from rocm_apex_tpu_torch.convert import from_jax_params

    cfg = _hd_cfg(name, torch.bfloat16)
    model = from_jax_params(tree, cfg, device=CARD)
    prompts = _hd_prompts(cfg.vocab_size, HD_SERVE["requests"])
    res, tokens = {}, {}
    for form, kw in (("contiguous", {}),
                     ("paged", dict(paged=True, page_size=PAGE_SIZE))):
        eng = _engine(model, **kw)
        eng.generate(prompts[:SLOTS], max_new_tokens=2)  # warm-up
        _zero_launches()
        t0 = time.perf_counter()
        tokens[form] = _tokens(eng, prompts, HD_SERVE["max_new"])
        _sync()
        dt = time.perf_counter() - t0
        gen = sum(len(t) for t in tokens[form])
        check(all(len(t) == HD_SERVE["max_new"] and all(
            0 <= x < cfg.vocab_size for x in t) for t in tokens[form]),
              f"{name} {form}: a request did not run to its tokens")
        res[form] = dict(seconds=dt, tokens_per_s=gen / dt,
                         launches=_hd_flash_launches())
    same = sum(a == b for a, b in zip(tokens["paged"], tokens["contiguous"]))
    res["paged_requests_matching_contiguous"] = same
    check(same == len(prompts), f"{name}: bf16 pages give the contiguous "
          f"tokens in {same} of {len(prompts)} requests")
    del model
    torch.cuda.empty_cache()
    return res


def _first_layers(tree, n):
    """A copy of a GPT/BERT param tree cut to its first ``n`` layers."""
    def cut(node):
        return {k: (cut(v) if isinstance(v, dict) else np.array(v))
                for k, v in node.items()
                if not (k.startswith("layer_") and int(k[6:]) >= n)}
    return cut(tree)


def _hd_twin(name, tree):
    """The reduced-depth twin (HD_TWIN), fp32 with TF32 off, card against
    CPU: the losses of three Adam steps (LAMB for the BERT recipe, with its
    padding mask) within PARITY_LOSS_RTOL; for the GPTs also the engine's
    greedy tokens, equal."""
    from rocm_apex_tpu_torch.convert import from_jax_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _hd_cfg(name, torch.float32, num_layers=HD_TWIN["num_layers"],
                  hidden_dropout=0.0, attention_dropout=0.0)
    tree = _first_layers(tree, HD_TWIN["num_layers"])
    b, s = HD_TWIN["batch"], HD_TWIN["seq"]
    bert = name.endswith("bert")
    runs = {}
    for dev in (CARD, "cpu"):
        losses = []
        if bert:
            step, state, _, _ = _bert_trainer(cfg, dev, torch.float32,
                                              HD_TWIN["lr"],
                                              _first_layers(tree, 99))
            tokens, labels = _bert_batch(cfg, b, s)
            amask = padding_mask([s - 29] * b, s)
            for _ in range(HD_TWIN["steps"]):
                state, loss, _ = step(state, tokens, labels,
                                      attention_mask=amask)
                losses.append(float(loss))
        else:
            step, state, sstate = _trainer(cfg, dev, HD_TWIN["lr"],
                                           tree=_first_layers(tree, 99))
            tokens, labels = _train_batch(cfg, b, s)
            for _ in range(HD_TWIN["steps"]):
                state, sstate, loss = step(state, sstate, tokens, labels)
                losses.append(float(loss))
        runs[dev] = losses
        del step, state
    lc, lp = runs[CARD], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    log(f"  {name} twin ({HD_TWIN['num_layers']} layer, fp32): losses cuda "
        f"{lc}, cpu {lp}: max relative difference {rel:.3e} (rtol "
        f"{PARITY_LOSS_RTOL:g})")
    check(all(math.isfinite(x) for x in lc + lp),
          f"{name} twin: a nonfinite loss")
    check(rel <= PARITY_LOSS_RTOL,
          f"{name} twin: card and CPU losses differ by {rel:.3e}")
    res = dict(losses_cuda=lc, losses_cpu=lp, max_rel_diff=rel)
    if not bert:
        from rocm_apex_tpu_torch.inference import (InferenceEngine,
                                                   SamplingParams)

        prompts = _hd_prompts(cfg.vocab_size, HD_TWIN["requests"], seed=1,
                              lengths=(16, 32, 48))
        cap = min(CAPACITY, cfg.max_position_embeddings)
        toks = {dev: _tokens(InferenceEngine(
            from_jax_params(tree, cfg, device=dev), num_slots=SLOTS,
            capacity=cap, prefill_token_budget=min(BUDGET, cap),
            sampling=SamplingParams(temperature=0.0)), prompts,
            HD_TWIN["max_new"]) for dev in (CARD, "cpu")}
        same = toks[CARD] == toks["cpu"]
        log(f"  {name} twin: greedy tokens of {len(prompts)} requests x "
            f"{HD_TWIN['max_new']}: cuda {'==' if same else '!='} cpu")
        check(same, f"{name} twin: greedy tokens differ: {toks}")
        res["tokens_identical"] = same
    torch.cuda.empty_cache()
    return res


def run_head_dims_phase():
    """GPT-J-6B's attention shape (hd 256: the packed branch), GPT-3
    2.7B's (hd 80: the unpacked kernels at width 128 with zero columns)
    and the JAX recipes' (hd 32 at width 64): each wide model trains
    HD_TRAIN_STEPS O5 steps (dropout 0.1) and serves HD_SERVE's requests
    contiguous and paged; the recipes' GPT trains under Adam and masked
    BERT under LAMB; each prints its step ms, peak memory and the flash
    kernels' launches, and its losses must be finite and fall. Each
    model's reduced-depth twin then holds card against CPU."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa

    res = dict(launches={})
    expect = {  # the flash kernels each path must launch
        "gptj": ("flash_attention_qkv_fwd", "flash_attention_qkv_bwd"),
        "gpt3_2.7b": ("flash_unpacked_fwd", "flash_unpacked_bwd"),
        "recipe_gpt": ("flash_unpacked_fwd", "flash_unpacked_bwd"),
        "recipe_bert": ("flash_unpacked_fwd", "flash_unpacked_bwd"),
    }
    lrs = {"gptj": 3e-4, "gpt3_2.7b": 3e-4, "recipe_gpt": 1e-4,
           "recipe_bert": 1e-3}
    from rocm_apex_tpu_torch.convert import random_params

    for name in HD_MODELS:
        hd = HD_MODELS[name]["hidden_size"] // HD_MODELS[name][
            "num_attention_heads"]
        # one seeded tree a model: its train, serve and twin start from it
        tree = random_params(_hd_cfg(name, torch.float32), seed=0)
        plan = fa.head_dim_plan(hd)
        log(f"  -- {name}: hd {hd} (width {plan['width']}, "
            f"{plan['hd_route']})")
        r = dict(head_dim=hd, width=plan["width"], hd_route=plan["hd_route"])
        r["train"] = (_hd_bert_train(name, lrs[name], tree)
                      if name.endswith("bert")
                      else _hd_train(name, lrs[name], tree))
        t = r["train"]
        log(f"  {name} train: B {t['batch']} x S {t['seq']}, losses "
            f"{[round(x, 4) for x in t['losses']]}, step ms "
            f"{[round(x, 2) for x in t['step_ms']]}, peak "
            f"{t['peak_mem_gib']:.2f} GiB; flash launches {t['launches']}")
        _hd_losses_fall(f"{name} train", t["losses"])
        for k in expect[name]:
            check(t["launches"].get(k, 0) > 0,
                  f"{name} train: {k} was not launched")
        other = ({"flash_unpacked_fwd", "flash_unpacked_bwd"}
                 if name == "gptj" else
                 {"flash_attention_qkv_fwd", "flash_attention_qkv_bwd"})
        check(not any(t["launches"].get(k, 0) for k in other),
              f"{name} train: the other attention branch ran "
              f"{t['launches']}")
        if name in ("gptj", "gpt3_2.7b"):
            r["serve"] = _hd_serve(name, tree)
            for form in ("contiguous", "paged"):
                sv = r["serve"][form]
                log(f"  {name} serve {form}: {HD_SERVE['requests']} requests "
                    f"x {HD_SERVE['max_new']} tokens in {sv['seconds']:.3f} s "
                    f"({sv['tokens_per_s']:.1f} tok/s); flash launches "
                    f"{sv['launches']}")
            chunk = ("flash_segments_serve" if hd <= 128
                     else "flash_attention_segments_with_lse")
            check(r["serve"]["contiguous"]["launches"].get(chunk, 0) > 0
                  and r["serve"]["contiguous"]["launches"].get(
                      "flash_attention_decode", 0) > 0,
                  f"{name} serve: the chunk read ({chunk}) or the decode read "
                  f"was not launched")
            check(r["serve"]["paged"]["launches"].get(
                "flash_attention_decode_paged", 0) > 0,
                f"{name} paged serve: the paged read was not launched")
            log(f"  {name}: bf16 pages give the contiguous tokens in "
                f"{r['serve']['paged_requests_matching_contiguous']} of "
                f"{HD_SERVE['requests']} requests")
        r["twin"] = _hd_twin(name, tree)
        res[name] = r
        for part in (r["train"], *(r.get("serve", {}).get(f, {})
                                   for f in ("contiguous", "paged"))):
            for k, n in part.get("launches", {}).items():
                res["launches"][k] = res["launches"].get(k, 0) + n
    return res


# ---------------------------------------------------------------------------
# phase 27: fp16 (amp O2) on the card
# ---------------------------------------------------------------------------

# the fp16 GPT cell: the train cell's model and batch under amp O2 (fp16
# compute copy, fp32 masters, MixedPrecisionAdam, the dynamic LossScaler)
FP16_TRAIN_WARMUP, FP16_TRAIN_STEPS = 3, 5
# the 2-layer twin: one O2 step on the kernels and one under
# `plain_versions()` on the same card, weights and batch, both fp16. The
# loss is an fp32 mean over 512 tokens of terms whose fp16 operands the
# two sides round alike but for the last bits of p and ds (the attention
# frames) and the summation order: 1e-3 relative is 30x the spread such
# flips give at this size. A gradient leaf sums fp16-rounded products over
# 512 rows; 1e-2 of the leaf's largest element allows a few fp16 steps of
# its largest terms.
FP16_TWIN = dict(num_layers=2, batch=2, seq=256)
FP16_TWIN_LOSS_RTOL = 1e-3
FP16_TWIN_GRAD_SHARE = 1e-2
FP16_PACKED_STEPS = 3
FP16_BERT_STEPS = 3
# amp O2's dynamic scale starts at 2^16 and halves on each overflow; the
# fused ResNet-50 may skip several steps while it settles (six at B 4 x
# 64^2 on the CPU, one at B 128 on the card), so a warm-up of 8 steps,
# then 3 timed steps that must skip none
FP16_RN50_WARMUP, FP16_RN50_STEPS = 8, 3
# the fused ResNet's twin: rn50_parity's widths and damped residuals
# (RN50_PARITY_BN3_SCALE) at B 2 x 64^2 in fp16 on the card, the
# bottleneck kernels against their plain versions on the same input: the
# loss within FP16_TWIN_LOSS_RTOL; and the first step's gradients, which
# this net at this batch cannot hold leaf by leaf: the plain versions on
# the input moved by one fp16 step (2^-10 relative) move the median leaf
# by about a quarter of its largest entry (the twin logs it). So the
# median over the leaves of |kernels - plain| / max |plain| is held to
# that of the moved input, FP16_RN50_TWIN_MEDIAN_SHARE times it: a fault
# that moves the gradients more than one fp16 step of input does, such as
# a dgrad scaled by 1.5 in one kernel, fails it; smaller ones are for the
# kernel cases of group `bottleneck`, which hold each call to one fp16
# step
FP16_RN50_TWIN = dict(batch=2, size=64)
FP16_RN50_TWIN_MEDIAN_SHARE = 1.0


def _fp16_gpt_twin():
    """One O2 step of the 2-layer GPT twin on the card, on the kernels and
    under `plain_versions()`: the losses and every gradient leaf (read
    unscaled from the step's parameters)."""
    from rocm_apex_tpu_torch.convert import random_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(**{**TRAIN, "num_layers": FP16_TWIN["num_layers"],
                       "hidden_dropout": 0.0, "attention_dropout": 0.0},
                    params_dtype=torch.float32, dtype=torch.float16)
    tree = random_params(cfg, seed=0)
    tokens, labels = _train_batch(cfg, FP16_TWIN["batch"], FP16_TWIN["seq"])
    runs = {}
    for form in ("kernels", "plain"):
        step, state, sstate = _trainer(cfg, CARD, 1e-4, tree=tree)
        inv = 1.0 / float(sstate.loss_scale)
        _zero_launches()
        if form == "plain":
            with plain_versions():
                state, sstate, loss = step(state, sstate, tokens, labels)
        else:
            state, sstate, loss = step(state, sstate, tokens, labels)
        runs[form] = dict(
            loss=float(loss), launches=_launches(),
            grads={k: p.grad.float() * inv for k, p in state.model.items()})
        del step, state
    kern, plain = runs["kernels"], runs["plain"]
    rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    worst, at = 0.0, None
    for k, g in plain["grads"].items():
        r = float((kern["grads"][k] - g).abs().max()) / max(
            FP16_TWIN_GRAD_SHARE * float(g.abs().max()), 1e-30)
        if math.isnan(r) or r > worst:
            worst, at = (math.inf if math.isnan(r) else r), k
    log(f"  O2 twin ({FP16_TWIN['num_layers']} layers, B "
        f"{FP16_TWIN['batch']} x S {FP16_TWIN['seq']}, fp16): loss kernels "
        f"{kern['loss']:.6f}, plain versions {plain['loss']:.6f}, relative "
        f"{rel:.3e} (rtol {FP16_TWIN_LOSS_RTOL:g}); worst gradient leaf "
        f"{worst:.3f} of its tolerance ({at}); launches on the kernels "
        f"{kern['launches']}, under plain_versions {plain['launches']}")
    check(math.isfinite(kern["loss"]) and math.isfinite(plain["loss"]),
          "O2 twin: a nonfinite loss")
    check(rel <= FP16_TWIN_LOSS_RTOL, f"O2 twin: losses differ by {rel:.3e}")
    check(worst <= 1.0, f"O2 twin: gradient {at} differs by {worst:.3g}x "
          f"its tolerance")
    for name in ("layer_norm_fwd", "layer_norm_bwd",
                 "flash_attention_qkv_fwd", "flash_attention_qkv_bwd"):
        check(kern["launches"].get(name, 0) > 0,
              f"O2 twin: {name} was not launched")
    check(not plain["launches"], f"O2 twin: kernels launched under "
          f"plain_versions: {plain['launches']}")
    return dict(loss_kernels=kern["loss"], loss_plain=plain["loss"],
                loss_rel_err=rel, grad_err_over_tol=worst, worst_leaf=at)


def _fp16_packed_twin():
    """The twin's step under `PackedOptimizerStep("adam")` in fp16: the
    packed passes (rows 14, 15) on fp16 gradients, a few steps."""
    from rocm_apex_tpu_torch.models.gpt import GPTConfig
    from rocm_apex_tpu_torch.optimizers import PackedOptimizerStep

    cfg = GPTConfig(**{**TRAIN, "num_layers": FP16_TWIN["num_layers"]},
                    params_dtype=torch.float32, dtype=torch.float16)
    step, state, sstate = _trainer(
        cfg, CARD, 1e-4, opt=PackedOptimizerStep(
            "adam", 1e-4, weight_decay=0.01, compute_dtype=torch.float16))
    tokens, labels = _train_batch(cfg, FP16_TWIN["batch"], FP16_TWIN["seq"])
    gen = torch.Generator().manual_seed(0)
    _zero_launches()
    losses = []
    for _ in range(FP16_PACKED_STEPS):
        state, sstate, loss = step(state, sstate, tokens, labels,
                                   dropout_generator=gen)
        losses.append(float(loss))
    launches = _launches()
    log(f"  O2 twin under PackedOptimizerStep('adam'): losses {losses}, "
        f"{int(sstate.overflows)} skipped; packed launches "
        f"{ {k: launches.get(k, 0) for k in ('scale_sumsq', 'adam_update')} }")
    check(all(math.isfinite(x) for x in losses),
          "packed O2 twin: a nonfinite loss")
    for name in ("scale_sumsq", "adam_update"):
        check(launches.get(name, 0) == FP16_PACKED_STEPS,
              f"packed O2 twin: {name} launched {launches.get(name, 0)} "
              f"times in {FP16_PACKED_STEPS} steps")
    return dict(losses=losses, launches=launches)


def _fp16_serve():
    """The serve cell's engine with the model in fp16: contiguous, then
    on fp16 pages of PAGE_SIZE; the paged tokens must equal the
    contiguous ones in every request."""
    from rocm_apex_tpu_torch.convert import from_jax_params, random_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(**SERVE, params_dtype=torch.float32, dtype=torch.float16)
    t0 = time.perf_counter()
    model = from_jax_params(random_params(cfg, seed=0), cfg, device=CARD)
    load_s = time.perf_counter() - t0
    prompts = serve_prompts(cfg.vocab_size)
    out = {}
    for form, kw in (("contiguous", {}),
                     ("paged", dict(paged=True, page_size=PAGE_SIZE))):
        log(f"  -- fp16 serve, {form}")
        eng = _engine(model, **kw)
        eng.generate(prompts[:SLOTS], max_new_tokens=3)  # warm-up
        r, tokens = timed_serve(eng, prompts)
        r["tokens"] = tokens
        out[form] = r
        del eng
    same = sum(a == b for a, b in zip(out["paged"]["tokens"],
                                      out["contiguous"]["tokens"]))
    log(f"  fp16 pages: {same}/{len(prompts)} requests give the contiguous "
        f"serve's tokens")
    check(same == len(prompts), f"fp16 pages: {same} of {len(prompts)} "
          f"requests give the contiguous serve's tokens")
    for name in SERVE_KERNELS:
        check(out["contiguous"]["launches"][name] > 0,
              f"fp16 serve: {name} was not launched")
    check(out["contiguous"]["launches"]["flash_attention_segments_with_lse"]
          == 0, "the fp16 serve's chunks left the tile route")
    check(out["paged"]["launches"]["flash_attention_decode_paged"] > 0,
          "fp16 paged serve: the paged read was not launched")
    for r in out.values():
        r.pop("tokens")
    return dict(weights_load_s=load_s, requests_matching=same, **out)


def _fp16_bert():
    """BERT-Large (the bert_train cell's model, B 8 x S 512) under O2 with
    `MixedPrecisionLamb` (fp32 moments): FP16_BERT_STEPS steps without a
    mask (the packed kernels, the cross-entropy, the LAMB pair), then as
    many with the masked batch's padding mask and dropout 0.1 (the
    unpacked kernels), on one model."""
    from rocm_apex_tpu_torch.models.bert import BertConfig

    cfg = BertConfig(**{**BERT, "hidden_dropout": BERT_MASKED_DROPOUT,
                        "attention_dropout": BERT_MASKED_DROPOUT},
                     params_dtype=torch.float32, dtype=torch.float16)
    t0 = time.perf_counter()
    step, state, _, _ = _bert_trainer(cfg, CARD, torch.float32)
    setup_s = time.perf_counter() - t0
    tokens, labels = _bert_batch(cfg, BERT_BATCH, BERT_SEQ)
    amask = padding_mask(bert_lengths(BERT_BATCH), BERT_SEQ)
    gen = torch.Generator().manual_seed(0)
    res = dict(setup_s=setup_s)
    for form, kw in (("unmasked", {}),
                     ("masked", dict(attention_mask=amask,
                                     dropout_generator=gen))):
        _zero_launches()
        t0 = time.perf_counter()
        losses, skipped = [], 0
        for _ in range(FP16_BERT_STEPS):
            state, loss, inf = step(state, tokens, labels, **kw)
            losses.append(float(loss))
            skipped += int(bool(inf))
        dt = time.perf_counter() - t0
        launches = _launches()
        res[form] = dict(losses=losses, skipped=skipped, launches=launches,
                         step_ms=1e3 * dt / FP16_BERT_STEPS)
        log(f"  BERT-Large O2 {form}: losses {losses}, {skipped} skipped, "
            f"{res[form]['step_ms']:.1f} ms a step (the first with its "
            f"allocations); launches {launches}")
        check(all(math.isfinite(x) for x in losses),
              f"BERT O2 {form}: a nonfinite loss")
        check(losses[-1] < losses[0], f"BERT O2 {form}: the loss did not "
              f"fall")
        want = (("flash_attention_qkv_fwd", "flash_attention_qkv_bwd",
                 "xent_fwd_dg", "lamb_leaf_stage1", "lamb_leaf_stage2")
                if form == "unmasked"
                else ("flash_unpacked_fwd", "flash_unpacked_bwd"))
        for name in want:
            check(launches.get(name, 0) > 0,
                  f"BERT O2 {form}: {name} was not launched")
    return res


def _fp16_rn50():
    """ResNet-50 with `FusedBottleneck` under amp O2 at bench.py's B 128 x
    224^2 (FusedAdam): FP16_RN50_STEPS steps on the bottleneck kernels in
    fp16; then the twin, rn50_parity's widths at B 2 x 64^2, the kernels
    against their plain versions (`plain_bottleneck`) on the card."""
    from rocm_apex_tpu_torch.ops._build import KERNELS

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = _rn50(CARD, True, torch.float16)
    step, params, opt_state, ss = _rn50_trainer(model, "O2")
    x, y = _rn50_batch(RN50_BATCH, RN50_SIZE, CARD)
    setup_s = time.perf_counter() - t0
    losses = []
    for _ in range(FP16_RN50_WARMUP):
        params, opt_state, ss, loss = step(params, opt_state, ss, x, y)
        losses.append(float(loss))
    warm_skipped = int(ss[0].overflows)
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FP16_RN50_STEPS):
        params, opt_state, ss, loss = step(params, opt_state, ss, x, y)
        losses.append(float(loss))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    skipped = int(ss[0].overflows) - warm_skipped
    launches = {k.name: k.launches for k in KERNELS}
    res = dict(setup_s=setup_s, losses=losses, skipped_warmup=warm_skipped,
               skipped_timed=skipped, loss_scale=float(ss[0].loss_scale),
               step_ms=1e3 * dt / FP16_RN50_STEPS,
               images_per_s=RN50_BATCH * FP16_RN50_STEPS / dt,
               launches={k: launches[k] for k in BNECK_KERNELS})
    log(f"  ResNet-50 fused O2, B {RN50_BATCH} x {RN50_SIZE}^2: losses "
        f"{losses}; skipped steps {warm_skipped} in the warm-up (loss scale "
        f"now {res['loss_scale']:g}), {skipped} timed; {res['step_ms']:.1f} "
        f"ms a step, {res['images_per_s']:.1f} images/s; bottleneck calls "
        f"{res['launches']}")
    check(all(math.isfinite(v) for v in losses), "rn50 O2: nonfinite loss")
    check(skipped == 0, f"rn50 O2: {skipped} timed steps skipped (the scale "
          f"had not settled)")
    check(losses[-1] < losses[FP16_RN50_WARMUP - 1],
          "rn50 O2: the loss did not fall over the timed steps")
    for name, n in RN50_FUSED_CALLS_PER_STEP.items():
        check(launches[name] == n * FP16_RN50_STEPS,
              f"rn50 O2: {name} {launches[name]} calls in "
              f"{FP16_RN50_STEPS} steps, expected {n} a step")
    del model, step, params, opt_state, x, y

    tw = FP16_RN50_TWIN
    runs = {}
    for form in ("kernels", "plain", "plain, input moved"):
        model = _rn50(CARD, True, torch.float16)
        with torch.no_grad():  # rn50_parity's damped residuals
            for name, p in model.named_parameters():
                if name.endswith(("bn3_scale", "bn3.scale")):
                    p.fill_(RN50_PARITY_BN3_SCALE)
        x, y = _rn50_batch(tw["batch"], tw["size"], CARD)
        if form == "plain, input moved":  # one fp16 step, relative
            x = x * (1.0 + 2.0 ** -10 * torch.randn(
                x.shape, generator=torch.Generator().manual_seed(5)).to(
                    x.device))
        names = [k for k, _ in model.named_parameters()]
        _zero_launches()
        if form.startswith("plain"):
            with plain_bottleneck():
                loss = F.cross_entropy(model(x).float(), y)
                grads = torch.autograd.grad(loss, list(model.parameters()))
        else:
            loss = F.cross_entropy(model(x).float(), y)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        runs[form] = dict(loss=float(loss.detach()), launches=_launches(),
                          grads=dict(zip(names, (g.float() for g in grads))))
        del model
    plain = runs["plain"]

    def leaf_errs(other):
        return {k: float((other["grads"][k] - g).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for k, g in plain["grads"].items()}

    kern, moved = runs["kernels"], runs["plain, input moved"]
    ek, em = leaf_errs(kern), leaf_errs(moved)
    med_k = float(np.median(list(ek.values())))
    med_m = float(np.median(list(em.values())))
    at = max(ek, key=ek.get)
    rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    log(f"  fused ResNet-50 twin, B {tw['batch']} x {tw['size']}^2 fp16: "
        f"loss kernels {kern['loss']:.6f}, plain {plain['loss']:.6f}, "
        f"relative {rel:.3e} (rtol {FP16_TWIN_LOSS_RTOL:g}); the gradient "
        f"leaves' error over their largest entry, median {med_k:.3e} "
        f"(worst {ek[at]:.3e}, {at}) against {med_m:.3e} for the plain "
        f"versions on the input moved by one fp16 step (limit: that, "
        f"x{FP16_RN50_TWIN_MEDIAN_SHARE:g})")
    check(rel <= FP16_TWIN_LOSS_RTOL, f"rn50 O2 twin: losses differ by "
          f"{rel:.3e}")
    check(med_k <= FP16_RN50_TWIN_MEDIAN_SHARE * med_m,
          f"rn50 O2 twin: the gradients' median error {med_k:.3e} is above "
          f"{FP16_RN50_TWIN_MEDIAN_SHARE:g}x the one-step input noise's "
          f"{med_m:.3e}")
    for name in BNECK_KERNELS:
        check(kern["launches"].get(name, 0) > 0,
              f"rn50 O2 twin: {name} was not launched")
    check(not any(plain["launches"].get(n) for n in BNECK_KERNELS),
          "rn50 O2 twin: a bottleneck kernel launched under the plain "
          "versions")
    res["twin"] = dict(loss_kernels=kern["loss"], loss_plain=plain["loss"],
                       loss_rel_err=rel, grad_median_err=med_k,
                       grad_median_err_input_moved=med_m,
                       grad_worst_err=ek[at], worst_leaf=at)
    return res


def run_fp16_phase(profile):
    """amp O2 in fp16 on the card through the port's entry points: the
    GPT train cell (`run_train_phase` in fp16, FP16_TRAIN_WARMUP +
    FP16_TRAIN_STEPS steps: rows 1, 2, 8, 11) and its 2-layer twin
    (kernels against plain versions, then under PackedOptimizerStep: rows
    14, 15); the fp16 serve, contiguous and paged (rows 1, 3, 5, 6);
    BERT-Large under MixedPrecisionLamb, unmasked and masked (rows 7b, 8,
    9b, 11, 13a, 16); ResNet-50 with FusedBottleneck and its twin (row
    17). The kernel cases in fp16 are each group's (`FP16_CASES`)."""
    out = {}
    log("  -- GPT train cell, amp O2 (fp16)")
    out["train"] = run_train_phase(profile, dtype=torch.float16,
                                   warmup=FP16_TRAIN_WARMUP,
                                   steps=FP16_TRAIN_STEPS)
    torch.cuda.empty_cache()
    log("  -- the 2-layer O2 twin")
    out["twin"] = _fp16_gpt_twin()
    out["packed"] = _fp16_packed_twin()
    torch.cuda.empty_cache()
    log("  -- GPT serve, fp16")
    out["serve"] = _fp16_serve()
    torch.cuda.empty_cache()
    log("  -- BERT-Large, amp O2")
    out["bert"] = _fp16_bert()
    torch.cuda.empty_cache()
    log("  -- ResNet-50 fused, amp O2")
    out["rn50"] = _fp16_rn50()
    torch.cuda.empty_cache()
    # the phase's launches: the GPT cell's timed steps, the serves', the
    # BERT and ResNet steps
    launches = {}
    for part in (out["train"]["launches"], out["packed"]["launches"],
                 out["serve"]["contiguous"]["launches"],
                 out["serve"]["paged"]["launches"],
                 out["bert"]["unmasked"]["launches"],
                 out["bert"]["masked"]["launches"],
                 out["rn50"]["launches"]):
        for k, n in part.items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    return out



# ---------------------------------------------------------------------------
# phases 27 and 28: speculative decoding, the fault harness
# ---------------------------------------------------------------------------

# bench.py serve --spec-k=4 on an accelerator (bench.py:544-566): 16
# periodic prompts (periods 3-6, 8 repeats), 128 new tokens, greedy; the
# budget fits every slot's span, SLOTS * (max(k, 2) + 1) = 40 rows
SPEC_K = 4
# SPEC_NEW: bench.py's 128 new tokens cut to 64, then to 32, to keep the
# smoke inside its time limit
SPEC_REQUESTS, SPEC_REPS, SPEC_NEW, SPEC_WARM_NEW = 16, 8, 32, 10
SPEC_BUDGET = SLOTS * (max(SPEC_K, 2) + 1)
SPEC_LAYOUTS = (
    ("contiguous", {}, "flash_attention_decode"),
    ("bf16_pages", dict(paged=True, page_size=PAGE_SIZE),
     "flash_attention_decode_paged"),
    ("int8_pages", dict(paged=True, page_size=PAGE_SIZE,
                        kv_dtype=torch.int8),
     "flash_attention_decode_paged_int8"),
)
# the twins: 2 layers at the serve's width, fp32, TF32 off, card vs CPU
# was 8 x 24, cut to keep the smoke inside its time limit
SPEC_TWIN = dict(num_layers=2, requests=4, max_new=16)
CHAOS_TWIN_NEW = 16
WATCHDOG_TIMEOUT_S = 0.5


def spec_prompts(vocab, n=SPEC_REQUESTS):
    """bench.py serve --spec-k's workload: from RandomState(0), request i
    repeats a random cycle of 3 + i % 4 tokens SPEC_REPS times, cut to
    period * SPEC_REPS + i % 3 tokens."""
    rng = np.random.RandomState(0)
    prompts = []
    for i in range(n):
        p = 3 + i % 4
        cyc = rng.randint(1, vocab, size=p).tolist()
        prompts.append((cyc * (SPEC_REPS + 1))[: p * SPEC_REPS + i % 3])
    return prompts


class _ShiftedDrafter:
    """The n-gram drafter's proposals shifted by +1 mod vocab (JAX
    tests/L0/test_speculative.py:237): wrong on nearly every token."""

    def __init__(self, k, vocab):
        from rocm_apex_tpu_torch.inference import NGramDrafter

        self._inner = NGramDrafter(k)
        self.window = self._inner.window
        self._vocab = vocab

    def __call__(self, histories, lengths):
        drafts, counts = self._inner(histories, lengths)
        return (drafts + 1) % self._vocab, counts


_TWINS = {}


def _twin_models(num_layers):
    """The serve's width at ``num_layers`` in fp32 on the card and on the
    CPU, from the same seeded weights (TF32 off); built once."""
    from rocm_apex_tpu_torch.convert import from_jax_params, random_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if num_layers not in _TWINS:
        cfg = GPTConfig(**{**SERVE, "num_layers": num_layers},
                        params_dtype=torch.float32, dtype=torch.float32)
        tree = random_params(cfg, seed=0)
        _TWINS[num_layers] = {dev: from_jax_params(tree, cfg, device=dev)
                              for dev in (CARD, "cpu")}
    return _TWINS[num_layers]


def _spec_twin():
    """The fp32 twin, card against CPU: greedy tokens equal with and
    without speculation on every layout; speculative tokens equal to the
    non-speculative ones on the contiguous cache and bf16 pages; an
    always-wrong drafter changes nothing."""
    models = _twin_models(SPEC_TWIN["num_layers"])
    vocab = models["cpu"].cfg.vocab_size
    prompts = spec_prompts(vocab, SPEC_TWIN["requests"])
    new = SPEC_TWIN["max_new"]
    out, tokens = {}, {}
    for form, kw, _ in SPEC_LAYOUTS:
        for k in (0, SPEC_K):
            for dev, model in models.items():
                eng = _engine(model, prefill_token_budget=SPEC_BUDGET,
                              spec_k=k, **kw)
                tokens[form, k, dev] = _tokens(eng, prompts, new)
                if k:
                    out[f"{form}_drafted_{dev}"] = eng.stats()[
                        "tokens_drafted"]
            same = tokens[form, k, CARD] == tokens[form, k, "cpu"]
            out[f"{form}_spec{k}_card_equals_cpu"] = same
            check(same, f"spec twin, {form}, spec_k={k}: card tokens differ "
                  f"from the CPU's")
        same = tokens[form, SPEC_K, CARD] == tokens[form, 0, CARD]
        out[f"{form}_spec_equals_plain"] = same
        if form != "int8_pages":
            check(same, f"spec twin, {form}: speculative tokens differ from "
                  f"the non-speculative ones")
    eng = _engine(models[CARD], prefill_token_budget=SPEC_BUDGET,
                  spec_k=SPEC_K, drafter=_ShiftedDrafter(SPEC_K, vocab))
    wrong = _tokens(eng, prompts, new)
    s = eng.stats()
    out.update(wrong_drafter_equals_plain=wrong == tokens["contiguous", 0,
                                                           CARD],
               wrong_drafter=dict(**{c: s[c] for c in (
                   "tokens_drafted", "tokens_accepted", "rollbacks")}))
    check(out["wrong_drafter_equals_plain"], "spec twin: an always-wrong "
          "drafter changed the tokens")
    check(s["rollbacks"] > 0, "spec twin: the always-wrong drafter rolled "
          "nothing back")
    log(f"  fp32 twin ({SPEC_TWIN['num_layers']} layers, "
        f"{len(prompts)} requests x {new}): card == cpu with and without "
        f"speculation on {', '.join(f for f, _, _ in SPEC_LAYOUTS)}; "
        f"spec == plain: " + ", ".join(
            f"{f} {out[f'{f}_spec_equals_plain']}" for f, _, _ in
            SPEC_LAYOUTS) + f"; always-wrong drafter: {out['wrong_drafter']}")
    return out


def _spec_counters(s):
    return {c: s[c] for c in ("tokens_drafted", "tokens_accepted",
                              "rollbacks", "acceptance_rate")}


def run_serve_spec_phase():
    """Speculative decoding at the serve's full width (bench.py serve
    --spec-k=4): spec_k=4 against spec_k=0 in one call, on the
    contiguous cache, bf16 pages and int8 pages, each engine warmed then
    timed over the periodic workload with every kernel's count set to 0
    just before. Generated tokens/s of each (the ratio is reported, not
    claimed), TPOT p95, acceptance, drafted, accepted and rolled-back
    tokens, rows 1, 3, 5 and 6's launches, and the device syncs a tick:
    each timed serve runs under `sync_audit`, so any sync but the
    engine's fetch, input copies and table pushes fails it, and the
    fetch must come once a tick (the commit reads no device value). The
    bf16 requests whose speculative tokens equal the non-speculative ones
    are counted, not asserted: a chunk row and a grid row go through
    GEMMs of different M, so an ulp may flip a near-tied token. Then the
    fp32 twin, where they must be equal."""
    model, load_s = _serve_model()
    vocab = model.cfg.vocab_size
    prompts = spec_prompts(vocab)
    res = dict(weights_load_s=load_s, budget=SPEC_BUDGET, spec_k=SPEC_K,
               requests=len(prompts), max_new=SPEC_NEW, forms={},
               launches={})
    totals = dict(tokens_drafted=0.0, tokens_accepted=0.0, rollbacks=0.0)
    for form, kw, decode_kernel in SPEC_LAYOUTS:
        runs, tokens = {}, {}
        for k in (0, SPEC_K):
            eng = _engine(model, prefill_token_budget=SPEC_BUDGET, spec_k=k,
                          **kw)
            eng.generate(prompts[:SLOTS], max_new_tokens=SPEC_WARM_NEW)
            log(f"  -- {form}, spec_k={k}")
            r, tokens[k] = timed_serve(eng, prompts, SPEC_NEW, audit=True)
            s = eng.stats()
            r.update(_spec_counters(s))
            # the audit raised on any other sync; the fetch is one a tick
            check(r["syncs_per_tick"]["fetch"] == 1.0,
                  f"{form} spec_k={k}: {r['syncs_per_tick']['fetch']} host "
                  f"fetches a tick")
            log(f"  device syncs a tick (none elsewhere): "
                f"{r['syncs_per_tick']}")
            check(r["launches"]["flash_attention_segments_with_lse"] == 0,
                  f"{form} spec_k={k}: the chunks left row 3's tile route "
                  f"(`flash_segments_serve_plan`)")
            for name in ("layer_norm_fwd", "flash_segments_serve",
                         decode_kernel):
                check(r["launches"][name] > 0, f"{form} spec_k={k}: "
                      f"{name} was not launched")
            if eng.paged:
                check(r["pages_used_after"] == 0,
                      f"{form} spec_k={k}: pages left in use")
            for name, n in r["launches"].items():
                res["launches"][name] = res["launches"].get(name, 0) + n
            runs[f"spec{k}"] = r
            del eng
        for c in totals:
            totals[c] += runs[f"spec{SPEC_K}"][c]
        same = sum(a == b for a, b in zip(tokens[SPEC_K], tokens[0]))
        ratio = (runs[f"spec{SPEC_K}"]["tokens_per_s"]
                 / runs["spec0"]["tokens_per_s"])
        runs.update(requests_spec_equals_plain=same,
                    tokens_per_s_ratio=ratio)
        log(f"  {form}: spec_k={SPEC_K} "
            f"{runs[f'spec{SPEC_K}']['tokens_per_s']:.1f} vs spec_k=0 "
            f"{runs['spec0']['tokens_per_s']:.1f} generated tok/s (x"
            f"{ratio:.3f}); TPOT p95 "
            f"{runs[f'spec{SPEC_K}']['tpot_ms_p95']:.2f} vs "
            f"{runs['spec0']['tpot_ms_p95']:.2f} ms; "
            f"{_spec_counters(runs[f'spec{SPEC_K}'])}; {same}/{len(prompts)}"
            f" requests give the non-speculative tokens")
        res["forms"][form] = runs
    for c, n in totals.items():
        check(n > 0, f"serve_spec: {c} is 0 over the phase")
    res["totals"] = totals
    torch.cuda.empty_cache()
    log("  -- the fp32 twin, card vs cpu")
    res["twin"] = _spec_twin()
    return res


def chaos_plan(seed=0):
    """bench.py serve --chaos=SEED's plan (bench.py:1628-1642): a
    device_step fault at a seeded tick, a logits fault poisoning a
    seeded slot at a seeded tick, host_fetch faults with p 0.05 (twice
    at most), a page_alloc fault at a seeded call (paged engines only)."""
    from rocm_apex_tpu_torch.inference import Fault, FaultPlan

    rng = np.random.RandomState(seed)
    return FaultPlan([
        Fault(site="device_step", tick=int(rng.randint(1, 5))),
        Fault(site="logits", tick=int(rng.randint(5, 10)),
              payload={"slot": int(rng.randint(0, SLOTS))}),
        Fault(site="host_fetch", p=0.05, times=2),
        Fault(site="page_alloc", nth=int(rng.randint(2, 7))),
    ], seed=seed)


def _chaos_run(eng, prompts, max_new):
    """bench.py serve --chaos's traffic: every request submitted (the
    queue bound sheds the last two), two ticks, a leased request
    cancelled, then `drain`. Checks the accounting identity; returns the
    results by request id and the counters."""
    from rocm_apex_tpu_torch.inference import FINISH_REASONS

    plan = eng.faults
    baseline = eng._allocator.snapshot() if eng.paged else None
    ids = [eng.add_request(p, max_new) for p in prompts]
    done = {}
    for _ in range(2):
        for r in eng.step():
            done[r.request_id] = r
    victim = next(st.req.request_id for st in eng._slots if st is not None)
    done[victim] = eng.cancel(victim)
    done.update({r.request_id: r for r in eng.drain()})
    s = eng.stats()
    reasons = [c["finish_reason"] for c in eng.completions]
    completed = sum(r in ("eos", "length", "capacity") for r in reasons)
    n = len(prompts)
    counts = dict(completed=completed, shed=int(s["shed"]),
                  quarantined=int(s["quarantined"]),
                  cancelled=int(s["cancelled"]),
                  expired=int(s["deadline_exceeded"]),
                  step_retries=int(s["step_retries"]),
                  preemptions=int(s["preemptions"]),
                  page_stalls=int(s["page_stalls"]),
                  fires=dict(plan.fires), victim=victim)
    check(sorted(done) == sorted(ids) and len(reasons) == n,
          f"{n} submitted, {len(reasons)} accounted")
    check(set(reasons) <= set(FINISH_REASONS), f"unknown reasons {reasons}")
    check(completed + counts["shed"] + counts["quarantined"]
          + counts["cancelled"] + counts["expired"] == n,
          f"completion accounting leaked: {counts}")
    check(counts["quarantined"] == reasons.count("error"),
          "quarantined != the error results")
    check(sum(plan.fires.values()) >= 2, f"the plan barely fired: "
          f"{plan.fires}")
    if eng.paged:
        eng._allocator.assert_consistent()
        check(eng._allocator.snapshot() == baseline,
              "pages leaked across the chaos run")
    return done, counts


def _survivors_match(done, reference):
    """Requests the plan did not shed, cancel or quarantine whose tokens
    equal the fault-free run's, and how many there are."""
    kept = [i for i, r in done.items() if r.finish_reason == "length"]
    return sum(done[i].tokens == reference[i] for i in kept), len(kept)


def _chaos_twin():
    """The plan on the fp32 twin (the serve's 32 requests x
    CHAOS_TWIN_NEW): on every layout the survivors give the fault-free
    run's tokens exactly."""
    model = _twin_models(SPEC_TWIN["num_layers"])[CARD]
    prompts = serve_prompts(model.cfg.vocab_size)
    out = {}
    for form, kw, _ in SPEC_LAYOUTS:
        reference = _tokens(_engine(model, **kw), prompts, CHAOS_TWIN_NEW)
        eng = _engine(model, faults=chaos_plan(0), max_step_retries=2,
                      max_queue=len(prompts) - 2, **kw)
        done, counts = _chaos_run(eng, prompts, CHAOS_TWIN_NEW)
        same, kept = _survivors_match(done, reference)
        out[form] = dict(counts, survivors=kept, survivors_matching=same)
        check(same == kept, f"chaos twin, {form}: {same} of {kept} "
              f"surviving requests give the fault-free tokens")
    log("  fp32 twin: survivors equal the fault-free run on "
        + ", ".join(f"{f} ({o['survivors_matching']}/{o['survivors']})"
                    for f, o in out.items()))
    return out


def _watchdog_run(tmp):
    """A page_alloc fault on every call wedges a paged engine's first
    prefill: the watchdog must raise naming the stuck slot, after
    writing its dump."""
    from rocm_apex_tpu_torch.inference import Fault, FaultPlan

    model = _twin_models(SPEC_TWIN["num_layers"])[CARD]
    dump = os.path.join(tmp, "watchdog.json")
    eng = _engine(model, paged=True, page_size=PAGE_SIZE,
                  faults=FaultPlan([Fault(site="page_alloc", every=1,
                                          times=None)]),
                  watchdog_timeout=WATCHDOG_TIMEOUT_S,
                  watchdog_dump_path=dump)
    eng.add_request(serve_prompts(model.cfg.vocab_size)[0], 4)
    err = None
    t0 = time.perf_counter()
    while err is None and time.perf_counter() - t0 < 20 * WATCHDOG_TIMEOUT_S:
        try:
            eng.step()
        except RuntimeError as e:
            err = str(e)
        time.sleep(0.01)
    check(err is not None and "serving watchdog" in err
          and "slot 0: request 0 prefilling" in err,
          f"the watchdog did not name the stuck slot: {err}")
    with open(dump) as f:
        bundle = json.load(f)
    check(bundle["event"] == "watchdog" and "slot 0" in bundle["diagnosis"],
          f"watchdog dump: {bundle}")
    log(f"  watchdog: {err[:160]}")
    return dict(error=err, dump_diagnosis=bundle["diagnosis"],
                stalled_seconds=bundle["stalled_seconds"],
                watchdog_fires=bundle["stats"]["watchdog_fires"])


def run_serve_chaos_phase(contiguous_tokens=None):
    """The fault harness at the serve's full width (bench.py serve
    --chaos=0): the seeded plan on the serve's 32 requests x MAX_NEW with
    max_queue 30 and two step retries, on the contiguous cache, bf16
    pages and int8 pages; a leased request cancelled after two ticks,
    then `drain`. The accounting identity, quarantined == the error
    results, at least two fires, the allocator consistent and back to its
    snapshot; each layout's launches counted over its own chaos run (the
    fault-free references run first) and its decode read among them. The
    survivors' tokens against the fault-free serve's
    (contiguous tokens for the contiguous cache and bf16 pages, an int8
    run for int8 pages) are counted: a cancel or a quarantine changes
    which prompt pieces share a chunk, so a survivor's chunk rows may
    split differently and a bf16 logit move by an ulp. The fp32 twin
    holds them exactly; then the watchdog."""
    import tempfile

    model, load_s = _serve_model()
    prompts = serve_prompts(model.cfg.vocab_size)
    if contiguous_tokens is None:
        contiguous_tokens = _tokens(_engine(model), prompts, MAX_NEW)
    # the fault-free references run before any count is set to 0
    references = {form: contiguous_tokens for form, _, _ in SPEC_LAYOUTS}
    int8_kw = next(kw for form, kw, _ in SPEC_LAYOUTS
                   if form == "int8_pages")
    references["int8_pages"] = _tokens(_engine(model, **int8_kw), prompts,
                                       MAX_NEW)
    res = dict(weights_load_s=load_s, requests=len(prompts),
               max_queue=len(prompts) - 2, forms={}, launches={})
    for form, kw, decode_kernel in SPEC_LAYOUTS:
        eng = _engine(model, faults=chaos_plan(0), max_step_retries=2,
                      max_queue=len(prompts) - 2, **kw)
        _zero_launches()
        t0 = time.perf_counter()
        done, counts = _chaos_run(eng, prompts, MAX_NEW)
        counts["seconds"] = time.perf_counter() - t0
        launches = _launches()
        for name in ("layer_norm_fwd", "flash_segments_serve",
                     decode_kernel):
            check(launches.get(name, 0) > 0,
                  f"serve_chaos {form}: {name} was not launched")
        same, kept = _survivors_match(done, references[form])
        counts.update(survivors=kept, survivors_matching=same,
                      launches=launches)
        log(f"  {form}: {counts}")
        res["forms"][form] = counts
        for name, n in launches.items():
            res["launches"][name] = res["launches"].get(name, 0) + n
        del eng
    torch.cuda.empty_cache()
    log("  -- the fp32 twin")
    res["twin"] = _chaos_twin()
    log("  -- the watchdog")
    with tempfile.TemporaryDirectory() as tmp:
        res["watchdog"] = _watchdog_run(tmp)
    return res


# ---------------------------------------------------------------------------
# multi-LoRA serving and the replica router
# ---------------------------------------------------------------------------

# multi-LoRA at the serve's width (the JAX engine's adapter pool, JAX
# tests/L0/test_adapters.py's protocol): a pool of LORA_RESIDENT device
# slots (slot 0 the base) at rank LORA_MAX_RANK; LORA_RANKS adapters with
# RandomState(100 + i) factors of scale LORA_SCALE (alpha = rank) in
# LORA_TIERS tiers (tier i % 3); the serve's 32 prompts, every fourth on
# the base and the rest on a RandomState(1) draw of the adapters with the
# skew LORA_P (a few hot tenants), so slots park, revive and evict
LORA_RESIDENT, LORA_MAX_RANK, LORA_TIERS = 4, 16, 3
LORA_RANKS = (4, 6, 8, 10, 12, 14, 16, 16)
LORA_SCALE = 0.05
LORA_P = (0.3, 0.2, 0.15, 0.1, 0.08, 0.07, 0.05, 0.05)
LORA_LAYOUTS = (
    ("contiguous", {}, "flash_attention_decode"),
    ("bf16_pages", dict(paged=True, page_size=PAGE_SIZE),
     "flash_attention_decode_paged"),
)
# the tier-preemption run: SLOTS tier-0 requests fill the engine, then
# TIER_VIPS tier-2 ones arrive after TIER_TICKS ticks
TIER_VIPS, TIER_TICKS = 2, 3
# the fp32 twins (2 layers at the serve's width, TF32 off), card vs CPU
LORA_TWIN = dict(num_layers=2, requests=8, max_new=16)
# the router: 2 replicas on the one card sharing the model's weights; the
# kill lands mid-decode (every prompt's chunks are through by then)
ROUTER_REPLICAS, ROUTER_KILL_TICK = 2, 12


def lora_factors(cfg, rank, seed):
    """One adapter's per-layer numpy factors at ``cfg``'s widths."""
    rng = np.random.RandomState(seed)
    h = cfg.hidden_size
    return [{"qkv": (LORA_SCALE * rng.randn(h, rank),
                     LORA_SCALE * rng.randn(rank, 3 * h)),
             "dense": (LORA_SCALE * rng.randn(h, rank),
                       LORA_SCALE * rng.randn(rank, h))}
            for _ in range(cfg.num_layers)]


def lora_pool(cfg, device):
    """A fresh pool with the LORA_RANKS adapters registered; returns it
    and their ids."""
    from rocm_apex_tpu_torch.inference import AdapterPool

    pool = AdapterPool(cfg.num_layers, cfg.hidden_size,
                       max_resident=LORA_RESIDENT, max_rank=LORA_MAX_RANK,
                       device=device)
    ids = [pool.register(f"tenant{i}", lora_factors(cfg, r, 100 + i),
                         rank=r, tier=i % LORA_TIERS)
           for i, r in enumerate(LORA_RANKS)]
    return pool, ids


def lora_assignment(ids, n):
    rng = np.random.RandomState(1)
    return [0 if i % 4 == 0 else ids[int(rng.choice(len(ids), p=LORA_P))]
            for i in range(n)]


def _pool_counters(eng):
    s = eng.stats()
    return {k: s[k] for k in ("adapter_uploads", "adapter_evictions",
                              "adapter_revivals", "adapter_stalls",
                              "tier_preemptions", "tier_sheds")}


def _lora_delta_case(pool):
    """`segmented_lora_delta` on the card at the chunk's shape (BUDGET
    rows of the hidden width, layer 0's qkv factors of every slot, a
    seeded slot per row) against the dense per-adapter x @ (A_a @ B_a)
    of each token group in fp64 on the CPU: within 1e-5 of the largest
    |delta| (fp32 sums over h, then r, against fp64)."""
    from rocm_apex_tpu_torch.ops.lora import segmented_lora_delta

    A, B = (t[0] for t in pool.buffers["qkv"])  # (P, h, r), (P, r, o)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(BUDGET, A.shape[1], generator=g)
    ids = np.random.RandomState(2).randint(0, A.shape[0], size=BUDGET)
    xd = x.to(A.device)
    idd = torch.from_numpy(ids.astype(np.int32)).to(A.device)
    got = segmented_lora_delta(xd, A, B, idd).cpu().double()
    A64, B64, x64 = A.cpu().double(), B.cpu().double(), x.double()
    ref = torch.zeros_like(got)
    for a in np.unique(ids):
        rows = torch.from_numpy(ids == a)
        ref[rows] = x64[rows] @ (A64[a] @ B64[a])
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(scale > 0 and err <= 1e-5 * scale,
          f"segmented_lora_delta: max |card - dense fp64| {err:.3e} vs "
          f"largest |delta| {scale:.3e}")
    ms = cuda_ms(lambda: segmented_lora_delta(xd, A, B, idd), 50)
    log(f"  segmented_lora_delta ({BUDGET} x {A.shape[1]} -> {B.shape[2]}, "
        f"rank {A.shape[2]}, {A.shape[0]} slots): max abs err {err:.3e} of "
        f"{scale:.3e}, {ms:.4f} ms")
    return dict(max_abs_err=err, max_abs_delta=scale, ms=ms)


def _tier_run(model, tier_preemption):
    """SLOTS requests on the first tier-0 adapter fill the engine, then
    TIER_VIPS on the first tier-2 adapter arrive after TIER_TICKS ticks
    (the serve's first prompts; 24 and 8 new tokens); returns the results
    by request id and the engine's counters."""
    pool, ids = lora_pool(model.cfg, model.device)
    tier0 = next(a for a in ids if pool.tier_of(a) == 0)
    tier2 = next(a for a in ids if pool.tier_of(a) == 2)
    eng = _engine(model, adapter_pool=pool, tier_preemption=tier_preemption)
    prompts = serve_prompts(model.cfg.vocab_size)
    done = {}
    for i in range(SLOTS):
        eng.add_request(prompts[i], 24, adapter_id=tier0)
    for _ in range(TIER_TICKS):
        done.update({r.request_id: r for r in eng.step()})
    for i in range(TIER_VIPS):
        eng.add_request(prompts[SLOTS + i], 8, adapter_id=tier2)
    while eng.has_work():
        done.update({r.request_id: r for r in eng.step()})
    pool.assert_consistent()
    check(pool.snapshot()["refs"] == 1, "tier run: adapter refs leaked")
    return done, _pool_counters(eng)


def _lora_twin():
    """The fp32 twin, card vs CPU: the serve's first requests on their
    adapters give the same tokens on both devices, contiguous and paged;
    all-base traffic through a pool with resident adapters gives the
    plain engine's tokens bit for bit; tier preemption leaves the
    preempted requests' tokens as an undisturbed run's."""
    models = _twin_models(LORA_TWIN["num_layers"])
    vocab = models["cpu"].cfg.vocab_size
    prompts = serve_prompts(vocab)[:LORA_TWIN["requests"]]
    new = LORA_TWIN["max_new"]
    out = {}
    for form, kw, _ in LORA_LAYOUTS:
        tokens = {}
        for dev, model in models.items():
            pool, ids = lora_pool(model.cfg, dev)
            eng = _engine(model, adapter_pool=pool, **kw)
            aids = lora_assignment(ids, len(prompts))
            rids = [eng.add_request(p, new, adapter_id=a)
                    for p, a in zip(prompts, aids)]
            done = {}
            while eng.has_work():
                done.update({r.request_id: r for r in eng.step()})
            tokens[dev] = [done[i].tokens for i in rids]
        same = tokens[CARD] == tokens["cpu"]
        out[f"{form}_card_equals_cpu"] = same
        check(same, f"lora twin, {form}: card tokens differ from the CPU's")
    model = models[CARD]
    pool, ids = lora_pool(model.cfg, CARD)
    for a in ids[:LORA_RESIDENT - 1]:  # resident, then parked
        pool.acquire(a)
        pool.release(a)
    base = _tokens(_engine(model, adapter_pool=pool), prompts, new)
    plain = _tokens(_engine(model), prompts, new)
    out["adapter0_equals_plain"] = base == plain
    check(base == plain, "lora twin: adapter-0 requests differ from the "
          "plain engine's tokens")
    calm, _ = _tier_run(model, False)
    busy, counters = _tier_run(model, True)
    check(counters["tier_preemptions"] >= 1, "lora twin: no tier "
          "preemption fired")
    same = all(busy[i].tokens == calm[i].tokens for i in range(SLOTS))
    out.update(tier_preemptions=counters["tier_preemptions"],
               preempted_equal_undisturbed=same)
    check(same, "lora twin: a preempted request's tokens differ from the "
          "undisturbed run's")
    log(f"  fp32 twin ({LORA_TWIN['num_layers']} layers, {len(prompts)} "
        f"requests x {new}): {out}")
    return out


def run_serve_lora_phase(contiguous_tokens=None):
    """Multi-LoRA serving at the serve's width: the engine with an
    `AdapterPool` (LORA_RESIDENT slots, rank LORA_MAX_RANK, the
    LORA_RANKS adapters in LORA_TIERS tiers) on the serve's 32 requests x
    MAX_NEW, a quarter on the base, contiguous and on bf16 pages; each
    timed serve under `sync_audit` (the adapter uploads are asynchronous
    copies from pinned memory) with the launch counts set to 0 just
    before: rows 1, 3 and the layout's decode read launched; uploads and
    evictions > 0 over the serves, stalls counted; the pool consistent
    and back to its base slot's one ref. Tier order admits the top tier
    first, so a serve submitted at once revives a parked slot only by
    chance: after each serve one short request for every adapter it left
    parked (returning tenants, under the audit too) revives those slots
    without an upload, and revivals > 0 over the phase. The base
    requests' tokens against the base serve's are counted, not asserted
    (tier order moves which prompt pieces share a chunk). Then the
    segmented delta on the card against the dense form, a tier
    preemption at bf16 (counted), and the fp32 twin."""
    model, load_s = _serve_model()
    vocab = model.cfg.vocab_size
    prompts = serve_prompts(vocab)
    if contiguous_tokens is None:
        contiguous_tokens = _tokens(_engine(model), prompts, MAX_NEW)
    res = dict(weights_load_s=load_s, resident=LORA_RESIDENT,
               max_rank=LORA_MAX_RANK, ranks=list(LORA_RANKS), forms={},
               launches={})
    totals = dict(adapter_uploads=0.0, adapter_evictions=0.0,
                  adapter_revivals=0.0)
    pool = None
    for form, kw, decode_kernel in LORA_LAYOUTS:
        pool, ids = lora_pool(model.cfg, CARD)
        aids = lora_assignment(ids, len(prompts))
        eng = _engine(model, adapter_pool=pool, **kw)
        eng.generate(prompts[:SLOTS], max_new_tokens=3)  # warm-up, base
        log(f"  -- {form}")
        r, tokens = timed_serve(eng, prompts, audit=True, adapters=aids)
        r.update(_pool_counters(eng), tenants=eng.tenant_stats())
        check(r["launches"]["flash_attention_segments_with_lse"] == 0,
              f"serve_lora {form}: the chunks left row 3's tile route")
        for name in ("layer_norm_fwd", "flash_segments_serve",
                     decode_kernel):
            check(r["launches"][name] > 0,
                  f"serve_lora {form}: {name} was not launched")
        pool.assert_consistent()
        check(pool.snapshot()["refs"] == 1,
              f"serve_lora {form}: adapter refs left after the serve")
        if eng.paged:
            check(r["pages_used_after"] == 0,
                  f"serve_lora {form}: pages left in use")
        # returning tenants: one short request for each adapter the serve
        # left parked in the pool revives its slot (no upload)
        parked = [a for a in ids if pool.resident(a) and pool.refs(a) == 0]
        before = eng.stats()["adapter_revivals"]
        with sync_audit(eng):
            back = [eng.add_request(prompts[0], 4, adapter_id=a)
                    for a in parked]
            while eng.has_work():
                eng.step()
        r["returning_tenants"] = len(back)
        r["adapter_revivals"] = eng.stats()["adapter_revivals"] - before
        pool.assert_consistent()
        base = [i for i, a in enumerate(aids) if a == 0]
        r["base_requests_matching_base_serve"] = sum(
            tokens[i] == contiguous_tokens[i] for i in base)
        r["base_requests"] = len(base)
        log(f"  pool: {_pool_counters(eng)}; syncs a tick "
            f"{r['syncs_per_tick']}; {r['base_requests_matching_base_serve']}"
            f"/{len(base)} base requests give the base serve's tokens")
        for c in totals:
            totals[c] += r[c]
        for name, n in r["launches"].items():
            res["launches"][name] = res["launches"].get(name, 0) + n
        res["forms"][form] = r
        del eng
    for c, n in totals.items():
        check(n > 0, f"serve_lora: {c} is 0 over the phase")
    res["totals"] = totals
    res["delta"] = _lora_delta_case(pool)
    calm, _ = _tier_run(model, False)
    busy, counters = _tier_run(model, True)
    res["tier_bf16"] = dict(counters, preempted_matching_undisturbed=sum(
        busy[i].tokens == calm[i].tokens for i in range(SLOTS)))
    log(f"  tier preemption (bf16): {res['tier_bf16']}")
    check(counters["tier_preemptions"] >= 1, "serve_lora: no tier "
          "preemption fired")
    torch.cuda.empty_cache()
    log("  -- the fp32 twin, card vs cpu")
    res["twin"] = _lora_twin()
    return res


class _ReplicaLaunches:
    """Each replica's kernel launches: its engine's `step` is wrapped to
    add the launch counts' growth over the call to the replica's own."""

    def __init__(self, router):
        from rocm_apex_tpu_torch.ops._build import KERNELS

        self.counts = [dict() for _ in range(router.num_replicas)]
        for i in range(router.num_replicas):
            eng = router.replica(i)
            inner = eng.step

            def step(inner=inner, mine=self.counts[i]):
                before = {k.name: k.launches for k in KERNELS}
                try:
                    return inner()
                finally:
                    for k in KERNELS:
                        n = k.launches - before[k.name]
                        if n:
                            mine[k.name] = mine.get(k.name, 0) + n

            eng.step = step


def _fleet_run(router, prompts, max_new, audit=True, during=None):
    """Submit every prompt, step the fleet dry (under `sync_audit` over
    every replica), checking each request is delivered once; ``during``
    runs after the third tick. Returns the tokens in prompt order, the
    router's stats and the audit's sync counts."""
    engs = [router.replica(i) for i in range(router.num_replicas)]
    s0 = router.stats()
    ids = [router.add_request(p, max_new) for p in prompts]
    done, ticks = {}, 0
    with (sync_audit(*engs) if audit else contextlib.nullcontext()) as syncs:
        while router.has_work():
            for r in router.step():
                check(r.request_id not in done,
                      f"request {r.request_id} delivered twice")
                done[r.request_id] = r
            ticks += 1
            if ticks == 3 and during is not None:
                during()
            check(ticks < 20000, "the fleet did not drain")
    s = router.stats()
    check(sorted(done) == sorted(ids), "a request was never delivered")
    check(s["completed"] - s0["completed"] == s["submitted"] - s0["submitted"]
          == len(prompts) and s["pending_depth"] == s["in_flight"] == 0,
          f"fleet accounting: {s}")
    check(all(done[i].finish_reason == "length" for i in ids),
          "a fleet request did not run to max_new_tokens")
    return [done[i].tokens for i in ids], s, dict(syncs or {}), ticks


def _ship_checks(router):
    """Record every shipped page as the source's pool holds it (before
    the source releases it), as the payload carries it and as the
    destination's pool holds it after the import, as device copies (no
    sync); `_ship_equal` compares them after the run."""
    records = {}

    def blocks(cache, pages):
        # the check's own index copy is not the engine's: the audit's
        # mode is off for it (a CPU rehearsal has no mode)
        cuda = cache.k[0].is_cuda
        mode = torch.cuda.get_sync_debug_mode() if cuda else 0
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
        try:
            idx = torch.tensor(pages, device=cache.k[0].device)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
        out = [x.index_select(0, idx) for x in (*cache.k, *cache.v)]
        if cache.quantized:
            out += [x.index_select(0, idx)
                    for x in (*cache.k_scale, *cache.v_scale)]
        return out

    for i in range(router.num_replicas):
        eng = router.replica(i)
        export, imp = eng._export_slot_pages, eng._import_shipped_pages

        def export_checked(st, slot, eng=eng, export=export):
            payload = export(st, slot)
            if payload is not None:
                n = len(payload["k"][0])
                pages = [int(p) for p in eng._table[slot, :n]]
                sent = [*payload["k"], *payload["v"]]
                if payload["quantized"]:
                    sent += [*payload["k_scale"], *payload["v_scale"]]
                records.setdefault(st.req.request_id, []).append(
                    [blocks(eng.cache, pages), [t.clone() for t in sent]])
            return payload

        def import_checked(st, slot, payload, eng=eng, imp=imp):
            ok = imp(st, slot, payload)
            if ok:
                n = len(payload["k"][0])
                pages = [int(p) for p in eng._table[slot, :n]]
                records[st.req.request_id][-1].append(
                    blocks(eng.cache, pages))
            return ok

        eng._export_slot_pages = export_checked
        eng._import_shipped_pages = import_checked
    return records


def _ship_equal(records, rank=0):
    """Every imported page: source == payload == destination, bit for
    bit (pool blocks and int8 scale rows); at tp > 1 the payload carries
    every head and the pools this ``rank``'s, so the payload's heads of
    the rank are compared. Returns the pages checked."""
    pages = 0
    for rid, hops in records.items():
        for hop in hops:
            if len(hop) < 3:
                continue  # replayed (no import)
            src, sent, dst = hop
            for a, b, c in zip(src, sent, dst):
                heads = a.shape[1]
                if b.shape[1] != heads:
                    b = b.narrow(1, rank * heads, heads)
                a, b, c = (t.view(torch.uint8) if t.dtype != torch.int8
                           else t for t in (a, b, c))
                check(torch.equal(a, b) and torch.equal(b, c),
                      f"request {rid}: a shipped page's bits changed")
            pages += src[0].shape[0]
    return pages


def _payload_digests(records):
    """Each request's shipped payloads as sha256 digests of their bytes
    (the ranks of a tp>1 fleet must ship the same bits)."""
    import hashlib

    out = {}
    for rid, hops in records.items():
        for hop in hops:
            h = hashlib.sha256()
            for t in hop[1]:
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
            out.setdefault(rid, []).append(h.hexdigest())
    return out


def _router(model, **kw):
    from rocm_apex_tpu_torch.inference import ReplicaRouter, SamplingParams

    ekw = dict(num_slots=SLOTS, capacity=CAPACITY,
               prefill_token_budget=BUDGET,
               sampling=SamplingParams(temperature=0.0),
               **kw.pop("engine_kwargs", {}))
    return ReplicaRouter(model, replicas=ROUTER_REPLICAS, engine_kwargs=ekw,
                         **kw)


def _kill_plan():
    from rocm_apex_tpu_torch.inference import Fault, FaultPlan

    return FaultPlan([Fault(site="replica_kill", tick=ROUTER_KILL_TICK,
                            payload={"replica": 0})], seed=0)


def _router_runs(model, prompts, max_new, audit, count):
    """(a) the contiguous fleet, (b) a replica_kill mid-decode, (c) a
    kill on bf16 pages, (d) the disaggregated fleet on bf16 and int8
    pages, (e) a rolling drain and rejoin; with ``count`` each run's
    per-replica launches are recorded. Returns {run: result}."""
    paged = dict(paged=True, page_size=PAGE_SIZE)
    runs = {
        "a_fleet": (dict(), None),
        "b_kill": (dict(faults=_kill_plan(), rejoin_after=4), None),
        "c_kill_bf16_pages": (dict(faults=_kill_plan(),
                                   engine_kwargs=paged), None),
        "d_disagg_bf16_pages": (dict(engine_kwargs=paged,
                                     replica_classes=["prefill", "decode"]),
                                None),
        "d_disagg_int8_pages": (dict(engine_kwargs=dict(
            paged, kv_dtype=torch.int8),
            replica_classes=["prefill", "decode"]), None),
        "e_rolling_drain": (dict(), "drain"),
    }
    out = {}
    for name, (kw, action) in runs.items():
        router = _router(model, **kw)
        counter = _ReplicaLaunches(router) if count else None
        records = (_ship_checks(router) if name.startswith("d_")
                   else None)

        def during(router=router, action=action):
            if action == "drain":
                router.drain_replica(0)
                check(router.replica_state(0) == "drained"
                      and router.replica(0).num_active == 0,
                      "drain_replica left work on the replica")

        tokens, s, syncs, ticks = _fleet_run(router, prompts, max_new,
                                             audit, during)
        r = dict(tokens=tokens, stats=s, syncs=syncs, ticks=ticks)
        if action == "drain":
            router.rejoin_replica(0)
            check(router.replica_state(0) == "up"
                  and router.healthy_replicas == ROUTER_REPLICAS,
                  "rejoin_replica did not restore the fleet")
            again, _, _, _ = _fleet_run(router, prompts[:2], 4, audit)
            r["after_rejoin"] = again
        if kw.get("faults") is not None:
            check(router.fault_log == [("replica_kill", ROUTER_KILL_TICK, 0)]
                  and s["replica_kills"] == 1 and s["migrations"] >= 1,
                  f"{name}: the kill did not migrate work: {s}")
        for i in range(router.num_replicas):
            eng = router.replica(i)
            check(eng.num_active == 0 and eng.num_queued == 0,
                  f"{name}: replica {i} kept work")
            if eng.paged:
                eng._allocator.assert_consistent()
                check(eng.pages_used == 0,
                      f"{name}: replica {i} leaked {eng.pages_used} pages")
        if records is not None:
            check(s["handoffs"] > 0 and s["page_migrations"] > 0,
                  f"{name}: no handoff shipped pages: {s}")
            check(router.replica(1).stats()["page_ships"] > 0,
                  f"{name}: the decode replica imported no page")
            r["pages_bit_equal"] = _ship_equal(records)
            check(r["pages_bit_equal"] > 0, f"{name}: no page was imported")
        if counter is not None:
            r["replica_launches"] = counter.counts
        out[name] = r
        del router
    return out


def _router_twin():
    """The fp32 twin: the contiguous fleet, the kill and the
    disaggregated fleet (fp32 pages) give the single engine's tokens on
    the card, which are the CPU's."""
    models = _twin_models(LORA_TWIN["num_layers"])
    prompts = serve_prompts(models["cpu"].cfg.vocab_size)[
        :LORA_TWIN["requests"]]
    new = LORA_TWIN["max_new"]
    paged = dict(paged=True, page_size=PAGE_SIZE)
    single = {}
    for layout, kw in (("contiguous", {}), ("paged", paged)):
        for dev, model in models.items():
            single[layout, dev] = _tokens(_engine(model, **kw), prompts, new)
        check(single[layout, CARD] == single[layout, "cpu"],
              f"router twin: the {layout} single engine's card tokens "
              f"differ from the CPU's")
    model = models[CARD]
    out = {}
    for name, kw, layout in (
        ("a_fleet", dict(), "contiguous"),
        ("b_kill", dict(faults=_kill_plan()), "contiguous"),
        ("d_disagg_pages", dict(engine_kwargs=paged,
                                replica_classes=["prefill", "decode"]),
         "paged"),
    ):
        router = _router(model, **kw)
        tokens, s, _, _ = _fleet_run(router, prompts, new, audit=False)
        same = tokens == single[layout, CARD]
        out[name] = dict(fleet_equals_single=same,
                         migrations=s["migrations"], handoffs=s["handoffs"])
        check(same, f"router twin, {name}: fleet tokens differ from the "
              f"single engine's")
    log(f"  fp32 twin ({LORA_TWIN['num_layers']} layers, {len(prompts)} "
        f"requests x {new}): fleet == single == cpu: {out}")
    return out


def run_serve_router_phase(contiguous_tokens=None):
    """The replica router at the serve's width: ROUTER_REPLICAS engines
    of the serve model on the one card (they share its weights), every
    run on the serve's 32 requests x MAX_NEW under `sync_audit` over
    both replicas (the page export and import each take one `_upload`
    of their page indices, counted with the engines' other uploads; no
    other sync): (a) the contiguous fleet, its tokens against the single
    engine's counted at bf16; (b) a replica_kill mid-decode, every
    request delivered once, the accounting identity; (c) the kill on
    bf16 pages, no page left on either replica; (d) the disaggregated
    fleet (prefill, decode) on bf16 and int8 pages: handoffs and page
    migrations > 0, every imported page's blocks and scales the same
    bits in the source's pool, the payload and the destination's pool;
    (e) a rolling drain and rejoin. Each replica launches rows 1 and 3
    and its layout's decode read in each run. Then the fp32 twin."""
    model, load_s = _serve_model()
    prompts = serve_prompts(model.cfg.vocab_size)
    if contiguous_tokens is None:
        contiguous_tokens = _tokens(_engine(model), prompts, MAX_NEW)
    _zero_launches()
    runs = _router_runs(model, prompts, MAX_NEW, audit=True, count=True)
    launches = _launches()
    res = dict(weights_load_s=load_s, replicas=ROUTER_REPLICAS,
               kill_tick=ROUTER_KILL_TICK, runs={}, launches=launches)
    for name, r in runs.items():
        decode = ("flash_attention_decode_paged_int8" if "int8" in name
                  else "flash_attention_decode_paged" if "pages" in name
                  else "flash_attention_decode")
        for i, counts in enumerate(r["replica_launches"]):
            for k in ("layer_norm_fwd", "flash_segments_serve", decode):
                check(counts.get(k, 0) > 0,
                      f"serve_router {name}: replica {i} never launched {k}")
        r["requests_matching_single"] = sum(
            a == b for a, b in zip(r.pop("tokens"), contiguous_tokens))
        keep = ("migrations", "handoffs", "page_migrations", "replica_kills",
                "replica_quarantines", "replica_rejoins", "affinity_hits")
        r["stats"] = {k: r["stats"][k] for k in keep}
        log(f"  {name}: {r['ticks']} ticks, {r['stats']}, syncs "
            f"{r['syncs']}, {r['requests_matching_single']}/{len(prompts)} "
            f"requests give the single engine's tokens"
            + (f", {r['pages_bit_equal']} shipped pages bit-equal"
               if "pages_bit_equal" in r else ""))
        res["runs"][name] = r
    torch.cuda.empty_cache()
    log("  -- the fp32 twin, card vs cpu")
    res["twin"] = _router_twin()
    return res


# ---------------------------------------------------------------------------
# phase 31: tensor-parallel serving at tp=2
# ---------------------------------------------------------------------------

# tp=2 serving on the one card: two ranks of a gloo group (the exchanges
# staged through host memory), each a process of its own holding its
# shard of the serve model, sliced from the serve's tp=1 checkpoint
# (`shard_tp1_params`, the same seeded tree as `_serve_model`'s). Each
# serves the serve's requests on pages of PAGE_SIZE in the model's dtype
# and in int8; then a migration with its pages, a speculative serve and
# the fp32 twin. The ranks share one card's multiprocessors and exchange
# through host memory: their times say nothing of an interconnect.
TP_RANKS = 2
TP_LAYOUTS = (("pages", {}, "flash_attention_decode_paged"),
              ("int8_pages", dict(kv_dtype=torch.int8),
               "flash_attention_decode_paged_int8"))
# the migration: the first requests evacuate (with their pages) once each
# has generated `after` tokens, into a fresh engine
TP_SHIP = dict(requests=4, after=4)
TP_SPEC = dict(requests=8, max_new=32)  # periodic prompts, spec_k SPEC_K
# the tp=2 serves' new tokens a request (the serve's 64 cut to 32, and the
# fleet's to 16, then both and the int8 serve's requests halved again,
# to keep the smoke inside its time limit; the fleet's kill at tick 12
# still lands in its prefill)
TP_MAX_NEW, TP_FLEET_NEW = 16, 8
# the serve_tp twin's requests and new tokens (the spec twin's 8 x 24 cut
# to keep the smoke inside its time limit)
TP_TWIN = dict(requests=4, max_new=8)
TP_INT8_REQUESTS = 8
TP_JOIN_S = 420
TP_THREADS = 3  # CPU threads a rank (the twin's CPU engines)
# a migrated payload against the tp=1 engine's for the same requests: the
# largest |difference| over max |tp=1 value| a block. The row-parallel
# sums add two partial products where tp=1 adds one, so a value moves by
# its dtype's rounding through the layers; a row in another slot moves it
# by its own size
TP_PAYLOAD_TOL = {torch.bfloat16: 0.1, torch.float32: 1e-4}


def _tp_models(spec, rank, dtype, devices, **over):
    """The serve's config (``over`` changed) at tp=2: this rank's shard of
    the seeded tp=1 tree (seed 0, as `_serve_model` and `_twin_models`
    draw it), one model a device. ``rank`` None: the tp=1 model."""
    import dataclasses

    from rocm_apex_tpu_torch.convert import from_jax_params, random_params
    from rocm_apex_tpu_torch.inference import shard_tp1_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig, GPTModel

    cfg = GPTConfig(**{**spec["serve"], **over}, params_dtype=torch.float32,
                    dtype=dtype)
    tree = random_params(cfg, seed=0)
    cfg = dataclasses.replace(cfg, tensor_parallel_size=TP_RANKS)
    tree = shard_tp1_params(GPTModel(cfg, device="meta"), tree, rank)
    return [from_jax_params(tree, cfg, device=d) for d in devices]


def _tp_engine(model, spec, **kw):
    """A greedy paged engine of the serve's geometry (sizes from
    ``spec``, so a rehearsal may shrink them in the spawned ranks)."""
    from rocm_apex_tpu_torch.inference import InferenceEngine, SamplingParams

    kw.setdefault("prefill_token_budget", spec["budget"])
    return InferenceEngine(model, num_slots=spec["slots"],
                           capacity=spec["capacity"], paged=True,
                           page_size=spec["page_size"],
                           sampling=SamplingParams(temperature=0.0), **kw)


def _tp_timed(eng, prompts, max_new):
    """One timed serve on a warm engine, under `sync_audit`: launches
    (wrapper counts and the device kernels of the launch tables) set to
    0 just before, read just after; each device step's exchanges (the
    audit's counts) recorded by step kind; tokens, tok/s, syncs a tick,
    this rank's KV bytes."""
    from rocm_apex_tpu_torch.ops._build import (
        device_launches,
        reset_device_launches,
    )

    per_step = {"mixed": [], "decode": []}

    def step(name, fn):
        def call(*a, **kw):
            before = exchange_count(syncs)
            out = fn(*a, **kw)
            per_step[name].append(exchange_count(syncs) - before)
            return out
        return call

    eng._mixed, eng._decode = step("mixed", eng._mixed), step("decode",
                                                              eng._decode)
    eng.reset_stats()
    _zero_launches()
    reset_device_launches()
    try:
        t0 = time.perf_counter()
        with sync_audit(eng) as syncs:
            results = eng.generate(prompts, max_new_tokens=max_new)
        _sync()
        dt = time.perf_counter() - t0
    finally:
        del eng._mixed, eng._decode
    s = eng.stats()
    ticks = int(s["mixed_steps"] + s["decode_only_steps"])
    gen = sum(len(r.tokens) for r in results)
    return dict(
        tokens=[r.tokens for r in results],
        reasons=sorted({r.finish_reason for r in results}),
        quarantined=s["quarantined"], seconds=dt, tokens_per_s=gen / dt,
        ticks=ticks, mixed_ticks=int(s["mixed_steps"]),
        decode_only_ticks=int(s["decode_only_steps"]),
        exchanges={k.split(":")[1]: n for k, n in syncs.items()
                   if k.startswith("exchange:")},
        exchanges_per_step={k: sorted(set(v)) for k, v in per_step.items()},
        syncs_per_tick={k.lstrip("_"): n / max(ticks, 1)
                        for k, n in syncs.items()},
        launches=_launches(), device_kernels=sorted(device_launches()),
        kv_bytes=eng.per_chip_kv_bytes(), pages_used_after=eng.pages_used,
        **{c: s[c] for c in ("tokens_drafted", "tokens_accepted",
                             "rollbacks")})


def _tp_layout_prompts(spec, form):
    """A layout's timed serve: the serve's requests on bf16 pages, the
    first TP_INT8_REQUESTS on int8 pages (whose eager scatter makes the
    serve the slowest; cut to keep the smoke inside its time limit)."""
    return (spec["prompts"][:TP_INT8_REQUESTS] if form == "int8_pages"
            else spec["prompts"])


def _tp_ship(model, spec, rank=0):
    """The migration: the first ``spec["ship"]["requests"]`` prompts run
    until each generated ``after`` tokens, the engine evacuates with its
    pages into a fresh engine, which finishes them. ``own_blocks_equal``:
    every payload's heads of this rank are its pool's blocks bit for bit
    (read before the evacuation released the pages). Returns the records
    (payloads on the host), the tokens by request id, the same requests'
    tokens on an undisturbed engine, and the import counters."""
    n, after = spec["ship"]["requests"], spec["ship"]["after"]
    prompts, max_new = spec["prompts"][:n], spec["max_new"]
    base = [r.tokens for r in _tp_engine(model, spec).generate(prompts,
                                                               max_new)]
    src = _tp_engine(model, spec)
    for p in prompts:
        src.add_request(p, max_new)
    done = {}
    for _ in range(10 * max_new):
        for r in src.step():
            done[r.request_id] = r.tokens
        live = [st for st in src._slots if st is not None]
        if live and all(len(st.generated) >= after for st in live):
            break
    c, ps = src.cache, src.cache.page_size
    own = {}
    for slot, st in enumerate(src._slots):
        if st is not None:
            idx = torch.as_tensor(src._table[slot, :-(-st.pos // ps)],
                                  dtype=torch.long, device=c.k[0].device)
            own[st.req.request_id] = [b.index_select(0, idx) for b in (
                *c.k, *c.v, *(c.k_scale or ()), *(c.v_scale or ()))]
    heads = c.k[0].shape[1]
    recs = src.evacuate(ship_pages=True)
    equal = True
    for rec in recs:
        pay = rec.get("pages")
        blocks = [*pay["k"], *pay["v"], *pay.get("k_scale", ()),
                  *pay.get("v_scale", ())]
        equal &= all(torch.equal(b.narrow(1, rank * heads, heads), o)
                     for b, o in zip(blocks, own[rec["request_id"]]))
        for key in ("k", "v", "k_scale", "v_scale"):
            if key in pay:
                pay[key] = [b.cpu() for b in pay[key]]
    dst = _tp_engine(model, spec)
    for rec in recs:
        dst.resume_request(rec["prompt"], rec["max_new_tokens"],
                           rec["request_id"], generated=rec["generated"],
                           first_token_at=rec["first_token_at"],
                           chunks=rec["chunks"], pages=rec.get("pages"))
    while dst.has_work():
        for r in dst.step():
            done[r.request_id] = r.tokens
    s = dst.stats()
    return dict(records=recs, tokens=[done[i] for i in sorted(done)],
                base=base, own_blocks_equal=bool(equal),
                page_ships=s["page_ships"],
                page_ship_fallbacks=s["page_ship_fallbacks"],
                pages_used_after=(src.pages_used, dst.pages_used))


def _tp_serves(rank, dev, spec, out):
    """The serve on both layouts, the migration, the speculative serve
    (bf16 pages), each timed under the audit."""
    (model,) = _tp_models(spec, rank, torch.bfloat16, [dev])
    for form, kw, _ in TP_LAYOUTS:
        eng = _tp_engine(model, spec, **kw)
        eng.generate(spec["prompts"][:spec["slots"]], max_new_tokens=3)
        out[form] = _tp_timed(eng, _tp_layout_prompts(spec, form),
                              spec["max_new"])
        del eng
    out["ship"] = _tp_ship(model, spec, rank)
    eng = _tp_engine(model, spec, spec_k=spec["spec_k"],
                     prefill_token_budget=spec["spec_budget"])
    eng.generate(spec["spec_prompts"][:spec["slots"]],
                 max_new_tokens=spec["spec_warm_new"])
    out["spec"] = _tp_timed(eng, spec["spec_prompts"], spec["spec_new"])
    del eng
    _tp_fleet(rank, dev, spec, out, model)


def _tp_fleet_run(model, spec, rank, form, kw, prompts, max_new,
                  audit=True):
    """A `ReplicaRouter` over ``ROUTER_REPLICAS`` tp=2 engines (every
    rank builds the same fleet and makes the same calls): on bf16
    pages replica 0 drains after 3 ticks, shipping its requests' pages
    to replica 1; on int8 pages a replica_kill of replica 0 fires at
    router tick ``ROUTER_KILL_TICK``. Under `sync_audit` (the engines'
    syncs and the staged exchanges only), each request delivered once
    (`_fleet_run`). Returns the tokens, each tick's replica states, the
    fault log, the shipped pages (each one's heads of this rank its
    source pool's and its destination pool's bits) and their digests."""
    from rocm_apex_tpu_torch.inference import ReplicaRouter

    kill = form == "int8_pages"
    router = ReplicaRouter(
        engines=[_tp_engine(model, spec, **kw)
                 for _ in range(ROUTER_REPLICAS)],
        faults=_kill_plan() if kill else None)
    records = _ship_checks(router)
    states, inner = [], router.step

    def step():
        done = inner()
        states.append(tuple(router.replica_state(i)
                            for i in range(router.num_replicas)))
        return done

    router.step = step
    _zero_launches()
    t0 = time.perf_counter()
    tokens, stats, syncs, ticks = _fleet_run(
        router, prompts, max_new, audit=audit,
        during=None if kill else (lambda: router.drain_replica(0)))
    _sync()
    dt = time.perf_counter() - t0
    return dict(tokens=tokens, states=states, ticks=ticks,
                launches=_launches(),
                fault_log=list(router.fault_log), seconds=dt,
                tokens_per_s=sum(len(t) for t in tokens) / dt,
                shipped_pages=_ship_equal(records, rank),
                digests=_payload_digests(records), syncs=syncs,
                **{k: stats[k] for k in ("page_migrations", "migrations",
                                         "replica_quarantines",
                                         "replica_kills")})


def _tp_fleet(rank, dev, spec, out, model):
    """The tp=2 fleet on each layout at the serve's requests (bf16)."""
    out["fleet"] = {form: _tp_fleet_run(model, spec, rank, form, kw,
                                        spec["prompts"], spec["fleet_new"])
                    for form, kw, _ in TP_LAYOUTS}


def _tp_twin(rank, dev, spec, out):
    """The fp32 twin (``twin_layers`` layers, TF32 off) at tp=2 on the
    card and on the CPU, every layout with and without speculation, and
    the migration on the card."""
    card, cpu = _tp_models(spec, rank, torch.float32, [dev, "cpu"],
                           num_layers=spec["twin_layers"])
    prompts, new = spec["twin_prompts"], spec["twin_new"]
    res = {}
    for form, kw, _ in TP_LAYOUTS:
        for k in (0, spec["spec_k"]):
            for where, m in (("card", card), ("cpu", cpu)):
                eng = _tp_engine(m, spec, spec_k=k,
                                 prefill_token_budget=spec["spec_budget"],
                                 **kw)
                res[form, k, where] = [r.tokens for r in
                                       eng.generate(prompts, new)]
    res["ship"] = _tp_ship(card, {**spec, "prompts": prompts,
                                  "max_new": new}, rank)
    for form, kw, _ in TP_LAYOUTS:
        # the fleet over two tp=2 engines, kill and drain included
        res["fleet", form] = _tp_fleet_run(
            card, {**spec, "budget": spec["spec_budget"]}, rank, form, kw,
            prompts, new, audit=False)["tokens"]
    out["twin"] = res


def _tp_rank(rank, n, workdir, spec):
    """One rank of a two-rank phase (spawned; ``spec["phase"]`` names
    it): the gloo group, the tensor and data axes
    (`initialize_model_parallel` at ``spec["tp"]``, default the two
    ranks), then the phase's work (`_TP_WORK`); writes rank<r>.pt (an
    ``error`` entry if anything raised)."""
    import datetime
    import traceback

    import torch.distributed as dist

    out = {}
    try:
        dev = (torch.device(spec["device"], 0) if spec["device"] == "cuda"
               else torch.device(spec["device"]))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.set_num_threads(spec["threads"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir}/store", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=120))
        from rocm_apex_tpu_torch.transformer import parallel_state

        parallel_state.initialize_model_parallel(spec.get("tp", n))
        t0 = time.perf_counter()
        for work in _TP_WORK[spec["phase"]]:
            work(rank, dev, spec, out)
        out["rank_s"] = time.perf_counter() - t0
        dist.barrier()
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - the parent reports it
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def _tp_spawn(spec):
    """The ranks of ``spec["phase"]``, spawned; their outputs (fails on a
    hang, a missing file or a rank's error) and the seconds they took."""
    import multiprocessing
    import tempfile

    with tempfile.TemporaryDirectory() as workdir:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_tp_rank, args=(r, TP_RANKS, workdir,
                                                    spec))
                 for r in range(TP_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(TP_JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        ranks_s = time.perf_counter() - t0
        phase = spec["phase"]
        check(not hung, f"{phase}: ranks {hung} did not finish in "
              f"{TP_JOIN_S} s")
        outs = []
        for r in range(TP_RANKS):
            path = os.path.join(workdir, f"rank{r}.pt")
            check(os.path.exists(path), f"{phase}: rank {r} wrote nothing "
                  f"(exit code {procs[r].exitcode})")
            outs.append(torch.load(path, weights_only=False))
    for r, o in enumerate(outs):
        check("error" not in o, f"{phase} rank {r}:\n{o.get('error')}")
    return outs, ranks_s


def _tp_routes(cfg, spec, dtype):
    """The device kernels rows 1, 3 and 6 must launch on a rank, by their
    plans at the rank's shapes, and those they must not: the LN forward
    on the chunk's rows a rank (``budget / tp``) and the grid's, the
    serving segment read over the rank's heads of the whole chunk, the
    paged read's split (its merge when the grid's key range splits over
    more than one block)."""
    from rocm_apex_tpu_torch.ops import flash_attention as fa
    from rocm_apex_tpu_torch.ops import layer_norm as ln
    from rocm_apex_tpu_torch.ops._build import sm_count
    from rocm_apex_tpu_torch.ops.flash_attention_segments import (
        flash_segments_serve_plan)

    sms = sm_count(torch.device(CARD, 0))
    heads, hd = cfg.num_attention_heads // TP_RANKS, cfg.head_dim
    ln_routes = {ln.ln_fwd_plan(rows, cfg.hidden_size, dtype, sms)["route"]
                 for rows in (spec["budget"] // TP_RANKS, spec["slots"])}
    seg = flash_segments_serve_plan(heads, spec["budget"], hd, dtype)["route"]
    spans, _ = fa.decode_span_plan(spec["slots"], heads, spec["capacity"],
                                   sms)
    need = {k for r in ln_routes for k in LN_ROUTE_KERNELS[r]}
    need |= set(SEG_SERVE_ROUTE_KERNELS[seg]) | {"decode_split_kernel"}
    if fa.decode_span_workspace(spec["slots"], heads, hd, spans):
        need.add("decode_merge_kernel")
    banned = {k for r, ks in LN_ROUTE_KERNELS.items() if r not in ln_routes
              for k in ks}
    banned |= {k for r, ks in SEG_SERVE_ROUTE_KERNELS.items() if r != seg
               for k in ks} - need
    return dict(ln=sorted(ln_routes), seg=seg, spans=spans), need, banned


def _tp_kernel_cases(dev, cfg):
    """Rows 1, 3 and 6 at a rank's shapes in the tp=2 bf16 serve, each
    against its plain version on the same card inputs by the kernel
    phase's own case generators, checks and tolerances
    (`run_kernel_phase`; routes by the launch tables): the LN forward on
    the chunk's sequence shard (``BUDGET / tp`` rows) and on the grid's
    ``SLOTS`` rows, plain and residual; the serving segment read over
    the whole chunk on the rank's heads; the paged read's grid and
    chunk piece B on the rank's heads, float and int8 pools."""
    bf = torch.bfloat16
    h, d = cfg.num_attention_heads // TP_RANKS, cfg.head_dim
    ln_shapes = [(rows, cfg.hidden_size, residual, bf)
                 for rows in (BUDGET // TP_RANKS, SLOTS)
                 for residual in (False, True)]
    paged = [(form, PAGE_SIZE, bf, int8)
             for form in ("decode grid", "chunk piece B")
             for int8 in (False, True)]
    return run_kernel_phase(dev, [
        lambda dev: ln_cases(dev, ln_shapes),
        lambda dev: seg_cases(dev, h, d, seed=250, dtypes=(bf,)),
        lambda dev: paged_decode_cases(dev, h, d, paged, seed=251)])


def _payload_diff(got, want):
    """A tp=2 payload against the tp=1 engine's for the same request:
    the same keys, shapes and dtypes (checked), whether layer 0's blocks
    have the same bits, the largest |difference| over max |tp=1 value|
    of the float blocks (int8: the largest step)."""
    check(set(got) == set(want) and all(
        got[k] == want[k] for k in ("rows", "page_size", "quantized",
                                    "dtype")),
          "serve_tp: the payload's fields differ from a tp=1 payload's")
    layer0, worst = True, 0.0
    for key in ("k", "v", "k_scale", "v_scale"):
        for layer, (a, b) in enumerate(zip(got.get(key, ()),
                                           want.get(key, ()))):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"serve_tp: payload {key} {layer}: {tuple(a.shape)} "
                  f"{a.dtype} where tp=1 has {tuple(b.shape)} {b.dtype}")
            layer0 &= layer > 0 or torch.equal(a, b.cpu())
            d = (a.float() - b.float().cpu()).abs().max()
            worst = max(worst, float(d) if a.dtype == torch.int8 else
                        float(d) / max(float(b.float().abs().max()), 1e-30))
    return layer0, worst


def run_serve_tp_phase(spec=None):
    """Tensor-parallel serving at tp=2 (see TP_RANKS): rows 1, 3 and 6
    at a rank's bf16 shapes against their plain versions
    (`_tp_kernel_cases`), then the tp=1 paged serve on the card (tokens, tok/s, KV bytes, a migration's
    payload, the twin's tokens), then two spawned ranks. On each rank
    and layout: the serve's requests all to their length, this rank's
    pools and scales half the tp=1 engine's bytes, rows 1, 3 and 6
    launched (wrapper counts) on their plans' routes at the rank's
    shapes (the launch tables), one fetch a tick and no sync outside
    the engine's and the staged exchanges (`sync_audit`), each mixed
    step's and decode step's exchanges the count the layout implies; both
    ranks the same tokens; the bf16 tokens equal to the tp=1 serve's
    counted, not asserted (the row-parallel partial sums add in another
    order). The migration: every payload carries every head (each rank's
    heads its own pool's bits, both ranks' payloads the same bits, the
    layout of a tp=1 payload, layer 0 and the worst difference to it
    reported), imported whole into a fresh tp=2 engine, no page left.
    The speculative serve drafts, accepts and rolls back. The fp32 twin:
    tp=2 card == tp=2 CPU == tp=1 card tokens on both layouts with and
    without speculation; the migration's tokens == the undisturbed tp=2
    run's, and its payload imported by a tp=1 engine gives the tp=1
    run's tokens."""
    model, load_s = _serve_model()
    cfg = model.cfg
    vocab = cfg.vocab_size
    dev = torch.device(CARD, 0) if CARD == "cuda" else torch.device(CARD)
    spec = spec or dict(
        phase="serve_tp", device=CARD, serve=SERVE, slots=SLOTS,
        capacity=CAPACITY,
        budget=BUDGET, page_size=PAGE_SIZE, prompts=serve_prompts(vocab),
        max_new=TP_MAX_NEW, fleet_new=TP_FLEET_NEW, ship=TP_SHIP,
        spec_k=SPEC_K,
        spec_budget=SPEC_BUDGET,
        spec_prompts=spec_prompts(vocab, TP_SPEC["requests"]),
        spec_new=TP_SPEC["max_new"], spec_warm_new=SPEC_WARM_NEW,
        twin_layers=SPEC_TWIN["num_layers"],
        twin_prompts=spec_prompts(vocab, TP_TWIN["requests"]),
        twin_new=TP_TWIN["max_new"], threads=TP_THREADS)
    L = spec["serve"]["num_layers"]
    # exchanges a device step: the chunk's embedding all-reduce, four
    # ring hops a layer (the QKV and fc1 gathers, the dense and fc2
    # reduce-scatters), the exit gather and the logits' vocab gather;
    # the grid's embedding all-reduce, two all-reduces a layer, the
    # logits' gather
    want_steps = {"mixed": [(4 * L + 3) + (2 * L + 2)],
                  "decode": [2 * L + 2]}
    res = dict(ranks=TP_RANKS, weights_load_s=load_s,
               exchanges_want=want_steps, forms={})
    if dev.type == "cuda":
        log(f"  -- rows 1, 3 and 6 at a rank's shapes (tp={TP_RANKS}, bf16) "
            f"against their plain versions")
        res["kernel_cases"] = [
            {k: c[k] for k in ("kernel", "case", "max_abs_err",
                               "err_over_tol", "ms", "plain_ms",
                               "bound_ms")}
            for c in _tp_kernel_cases(dev, cfg)]
    log("  -- tp=1 references on the card")
    ref = {}
    for form, kw, _ in TP_LAYOUTS:
        eng = _tp_engine(model, spec, **kw)
        eng.generate(spec["prompts"][:spec["slots"]], max_new_tokens=3)
        ref[form] = _tp_timed(eng, _tp_layout_prompts(spec, form),
                              spec["max_new"])
        del eng
    ref["ship"] = _tp_ship(model, spec)
    twin1 = _twin_models(spec["twin_layers"])[CARD]
    for form, kw, _ in TP_LAYOUTS:
        for k in (0, spec["spec_k"]):
            eng = _tp_engine(twin1, spec, spec_k=k,
                             prefill_token_budget=spec["spec_budget"], **kw)
            ref["twin", form, k] = [r.tokens for r in eng.generate(
                spec["twin_prompts"], spec["twin_new"])]
    twin_spec = {**spec, "prompts": spec["twin_prompts"],
                 "max_new": spec["twin_new"]}
    ref["twin_ship"] = _tp_ship(twin1, twin_spec)
    for form, kw, _ in TP_LAYOUTS:
        ref["twin_fleet", form] = _tp_fleet_run(
            twin1, {**spec, "budget": spec["spec_budget"]}, 0, form, kw,
            spec["twin_prompts"], spec["twin_new"], audit=False)["tokens"]
    torch.cuda.empty_cache()

    log(f"  -- {TP_RANKS} ranks")
    outs, res["ranks_s"] = _tp_spawn(spec)
    routes, need, banned = _tp_routes(cfg, spec, cfg.dtype)
    res["routes"] = routes
    for form, kw, decode in TP_LAYOUTS:
        want = ref[form]
        r_out = [o[form] for o in outs]
        for r, got in enumerate(r_out):
            what = f"serve_tp {form} rank {r}"
            check(got["reasons"] == ["length"] and got["quarantined"] == 0
                  and all(len(t) == spec["max_new"] and all(
                      0 <= x < vocab for x in t) for t in got["tokens"]),
                  f"{what}: a request did not run to its length with "
                  f"in-vocabulary tokens")
            check(got["kv_bytes"] * TP_RANKS == want["kv_bytes"],
                  f"{what}: {got['kv_bytes']} KV bytes, tp=1 holds "
                  f"{want['kv_bytes']}")
            for name in ("layer_norm_fwd", "flash_segments_serve", decode):
                check(got["launches"].get(name, 0) > 0,
                      f"{what}: {name} was not launched")
            check(got["launches"].get("flash_attention_segments_with_lse",
                                      0) == 0,
                  f"{what}: the chunk left row 3's serving route")
            names = got["device_kernels"]
            check(all(any(k in x for x in names) for k in need)
                  and not any(k in x for x in names for k in banned),
                  f"{what}: launched {names}; the plans {routes} need "
                  f"{sorted(need)} and none of {sorted(banned)}")
            check(got["syncs_per_tick"].get("fetch") == 1.0,
                  f"{what}: {got['syncs_per_tick']} syncs a tick")
            check(got["exchanges_per_step"] == want_steps,
                  f"{what}: exchanges a step {got['exchanges_per_step']}, "
                  f"want {want_steps}")
            check(got["pages_used_after"] == 0, f"{what}: pages left in use")
        check(r_out[0]["tokens"] == r_out[1]["tokens"],
              f"serve_tp {form}: the ranks' tokens differ")
        same = sum(a == b for a, b in zip(r_out[0]["tokens"],
                                          want["tokens"]))
        row = dict(
            tokens_per_s=[g["tokens_per_s"] for g in r_out],
            tp1_tokens_per_s=want["tokens_per_s"],
            requests_matching_tp1=same, kv_bytes=r_out[0]["kv_bytes"],
            tp1_kv_bytes=want["kv_bytes"], ticks=r_out[0]["ticks"],
            mixed_ticks=r_out[0]["mixed_ticks"],
            exchanges=r_out[0]["exchanges"],
            exchanges_per_step=r_out[0]["exchanges_per_step"],
            syncs_per_tick=r_out[0]["syncs_per_tick"],
            launches=[g["launches"] for g in r_out], seconds=[
                g["seconds"] for g in r_out], tp1_seconds=want["seconds"])
        res["forms"][form] = row
        log(f"  {form}: ranks {[round(x, 1) for x in row['tokens_per_s']]} "
            f"generated tok/s beside tp=1's {want['tokens_per_s']:.1f} (the "
            f"same call; two ranks on one card's multiprocessors, "
            f"exchanging through host memory); {same}/"
            f"{len(want['tokens'])} requests give the tp=1 paged serve's "
            f"tokens; KV bytes a rank {row['kv_bytes']} = tp=1's "
            f"{want['kv_bytes']} / {TP_RANKS}; {row['ticks']} ticks "
            f"({row['mixed_ticks']} mixed); exchanges a step "
            f"{row['exchanges_per_step']} ({row['exchanges']}); syncs a "
            f"tick {row['syncs_per_tick']}")
        log(f"  launches by rank {row['launches']}")

    log("  -- the migration (bf16 pages)")
    ships = [o["ship"] for o in outs]
    for r, sh in enumerate(ships):
        check(sh["own_blocks_equal"], f"serve_tp rank {r}: a payload's "
              f"heads of this rank are not its pool's blocks")
        check(sh["page_ships"] >= 1 and sh["page_ship_fallbacks"] == 0,
              f"serve_tp rank {r}: {sh['page_ships']} payloads imported, "
              f"{sh['page_ship_fallbacks']} replayed")
        check(sh["pages_used_after"] == (0, 0),
              f"serve_tp rank {r}: pages left in use {sh['pages_used_after']}")
    check(ships[0]["tokens"] == ships[1]["tokens"],
          "serve_tp: the migrated requests' tokens differ between ranks")
    layer0, worst, n_pages = True, 0.0, 0
    check(len(ships[0]["records"]) == len(ref["ship"]["records"]),
          "serve_tp: tp=2 and tp=1 evacuated other requests")
    for rec0, rec1, rec_tp1 in zip(ships[0]["records"], ships[1]["records"],
                                   ref["ship"]["records"]):
        p0, p1 = rec0["pages"], rec1["pages"]
        check(rec0["request_id"] == rec_tp1["request_id"],
              "serve_tp: tp=2 and tp=1 evacuated other requests")
        check(all(torch.equal(a, b) for key in p0 if isinstance(p0[key], list)
                  for a, b in zip(p0[key], p1[key])),
              "serve_tp: the ranks' payloads differ")
        l0, w = _payload_diff(p0, rec_tp1["pages"])
        layer0, worst = layer0 and l0, max(worst, w)
        n_pages += p0["k"][0].shape[0]
    check(worst <= TP_PAYLOAD_TOL[cfg.dtype], f"serve_tp: a payload differs "
          f"from the tp=1 engine's by {worst:.3e} of its scale")
    same = sum(a == b for a, b in zip(ships[0]["tokens"], ships[0]["base"]))
    res["ship"] = dict(requests=len(ships[0]["records"]), pages=n_pages,
                       layer0_bits_equal_tp1=layer0,
                       worst_rel_diff_tp1=worst,
                       requests_matching_undisturbed=same,
                       page_ships=ships[0]["page_ships"])
    log(f"  {res['ship']['requests']} requests evacuated with {n_pages} "
        f"full-head pages each: every rank's heads its own pool's bits, "
        f"both ranks' payloads the same bits, a tp=1 payload's layout; "
        f"layer 0 bit-equal to the tp=1 engine's payload: {layer0}; worst "
        f"difference to it {worst:.3e} of its scale; {same}/"
        f"{len(ships[0]['tokens'])} requests give the undisturbed tp=2 "
        f"run's tokens (counted at bf16)")
    for r, o in enumerate(outs):
        sp = o["spec"]
        check(sp["reasons"] == ["length"] and sp["quarantined"] == 0,
              f"serve_tp spec rank {r}: a request did not finish")
        for c in ("tokens_drafted", "tokens_accepted", "rollbacks"):
            check(sp[c] > 0, f"serve_tp spec rank {r}: {c} is 0")
        check(sp["syncs_per_tick"].get("fetch") == 1.0
              and sp["exchanges_per_step"] == {
                  "mixed": want_steps["mixed"], "decode": []},
              f"serve_tp spec rank {r}: syncs {sp['syncs_per_tick']}, "
              f"exchanges {sp['exchanges_per_step']}")
    check(outs[0]["spec"]["tokens"] == outs[1]["spec"]["tokens"],
          "serve_tp: the ranks' speculative tokens differ")
    sp = outs[0]["spec"]
    res["spec"] = dict(tokens_per_s=[o["spec"]["tokens_per_s"]
                                     for o in outs],
                       **{c: sp[c] for c in ("tokens_drafted",
                                             "tokens_accepted", "rollbacks",
                                             "ticks")})
    log(f"  spec_k={spec['spec_k']} on bf16 pages: {res['spec']}")

    log(f"  -- the fleet: a router over {ROUTER_REPLICAS} tp={TP_RANKS} "
        f"engines")
    res["fleet"] = {}
    for form, _, _ in TP_LAYOUTS:
        f0, f1 = (o["fleet"][form] for o in outs)
        what = f"serve_tp fleet {form}"
        check(f0["tokens"] == f1["tokens"], f"{what}: the ranks' tokens "
              f"differ")
        check(f0["states"] == f1["states"]
              and f0["fault_log"] == f1["fault_log"],
              f"{what}: the ranks' replica states differ")
        check(f0["digests"] == f1["digests"],
              f"{what}: the ranks shipped other payload bits")
        if form == "int8_pages":
            down = [st[0] for st in f0["states"]].index("quarantined")
            check(f0["fault_log"] == [("replica_kill", ROUTER_KILL_TICK, 0)]
                  and f0["replica_kills"] == 1 and down == ROUTER_KILL_TICK,
                  f"{what}: the kill at tick {ROUTER_KILL_TICK} logged "
                  f"{f0['fault_log']}, replica 0 down from tick {down}")
        else:
            check(f0["page_migrations"] >= 1 and f0["shipped_pages"] >= 1,
                  f"{what}: the drain shipped no pages ({f0})")
        if dev.type == "cuda":
            decode = dict((f, d) for f, _, d in TP_LAYOUTS)[form]
            for name in ("layer_norm_fwd", "flash_segments_serve", decode):
                check(all(f["launches"].get(name, 0) > 0 for f in (f0, f1)),
                      f"{what}: {name} was not launched")
        # the fleet's tokens against the tp=1 serve's first as many
        same = sum(a == b[:len(a)]
                   for a, b in zip(f0["tokens"], ref[form]["tokens"]))
        res["fleet"][form] = dict(
            tokens_per_s=[f["tokens_per_s"] for f in (f0, f1)],
            seconds=[f["seconds"] for f in (f0, f1)], ticks=f0["ticks"],
            requests_matching_tp1=same, shipped_pages=f0["shipped_pages"],
            payloads=sum(len(v) for v in f0["digests"].values()),
            **{k: f0[k] for k in ("page_migrations", "migrations",
                                  "replica_quarantines", "replica_kills",
                                  "fault_log")},
            quarantined_at=[st[0] for st in f0["states"]].index(
                "quarantined") if f0["replica_quarantines"] else None,
            syncs=f0["syncs"], launches=[f["launches"] for f in (f0, f1)])
        log(f"  {form}: {res['fleet'][form]}")

    log("  -- the fp32 twin: tp=2 card vs tp=2 cpu vs tp=1 card")
    twin = {}
    for form, _, _ in TP_LAYOUTS:
        for k in (0, spec["spec_k"]):
            got = [o["twin"][form, k, w] for o in outs for w in ("card",
                                                                 "cpu")]
            same = all(g == ref["twin", form, k] for g in got)
            twin[f"{form}_spec{k}"] = same
            check(same, f"serve_tp twin {form} spec_k={k}: tp=2 card, tp=2 "
                  f"cpu and tp=1 card tokens differ")
    tsh = [o["twin"]["ship"] for o in outs]
    for sh in tsh:
        check(sh["tokens"] == sh["base"] and sh["page_ships"] >= 1
              and sh["own_blocks_equal"],
              "serve_tp twin: the migrated tokens differ from the "
              "undisturbed tp=2 run's")
    check(tsh[0]["base"] == ref["twin_ship"]["base"],
          "serve_tp twin: the tp=2 run's tokens differ from tp=1's")
    for form, _, _ in TP_LAYOUTS:
        got = [o["twin"]["fleet", form] for o in outs]
        same = all(g == ref["twin_fleet", form] == o["twin"][form, 0, "card"]
                   for g, o in zip(got, outs))
        twin[f"fleet_{form}"] = same
        check(same, f"serve_tp twin fleet {form}: the tp=2 fleet's tokens "
              f"differ from the tp=1 fleet's or one tp=2 engine's")
    twin_worst = 0.0
    for a, b in zip(tsh[0]["records"], ref["twin_ship"]["records"]):
        check(a["request_id"] == b["request_id"], "serve_tp twin: tp=2 and "
              "tp=1 evacuated other requests")
        twin_worst = max(twin_worst, _payload_diff(a["pages"], b["pages"])[1])
    twin["payload_worst_rel_diff_tp1"] = twin_worst
    check(twin_worst <= TP_PAYLOAD_TOL[torch.float32], f"serve_tp twin: a "
          f"payload differs from the tp=1 engine's by {twin_worst:.3e} of "
          f"its scale")
    # the tp=2 payload into a tp=1 engine: shipped pages are tp-agnostic
    one = _tp_engine(twin1, spec)
    done = {}
    for rec in tsh[0]["records"]:
        one.resume_request(rec["prompt"], rec["max_new_tokens"],
                           rec["request_id"], generated=rec["generated"],
                           first_token_at=rec["first_token_at"],
                           chunks=rec["chunks"], pages=rec.get("pages"))
    while one.has_work():
        for r in one.step():
            done[r.request_id] = r.tokens
    check(one.stats()["page_ships"] >= 1,
          "serve_tp twin: the tp=1 engine imported no tp=2 payload")
    twin["ship_tp2_to_tp2"] = True  # checked above
    twin["ship_tp2_to_tp1"] = [done[i] for i in sorted(done)] == ref[
        "twin_ship"]["base"]
    check(twin["ship_tp2_to_tp1"], "serve_tp twin: a tp=1 engine resuming "
          "the tp=2 payloads gives other tokens than the tp=1 run")
    res["twin"] = twin
    log(f"  fp32 twin ({spec['twin_layers']} layers, "
        f"{len(spec['twin_prompts'])} requests x {spec['twin_new']}): {twin}")
    res["rank_s"] = [o["rank_s"] for o in outs]
    res["launches"] = {}
    for o in outs:
        for form, _, _ in TP_LAYOUTS:
            for k, c in o[form]["launches"].items():
                res["launches"][k] = res["launches"].get(k, 0) + c
    log(f"  ranks' wall time {res['ranks_s']:.1f} s (spawn included), "
        f"{[round(x, 1) for x in res['rank_s']]} s of work a rank")
    return res


# ---------------------------------------------------------------------------
# phase 33: the monitor layer's host side on the serve
# ---------------------------------------------------------------------------

# the serve on bf16 pages of PAGE_SIZE three ways (A bare on NULL_REGISTRY,
# B the default private registry, C a tracer, a time series sampling every
# tick, a flight recorder and an exporter on loopback), timed serves in
# A B C C B A order; the exporter is scraped after MONITOR_SCRAPE_TICK
# ticks of each of C's serves. Then on int8 pages: a logits
# fault (Inf on slot 0) MONITOR_FAULT_TICKS[0] ticks into the serve with
# the flight recorder, and the ROADMAP Queue 3 plan, a host_fetch fault
# MONITOR_FAULT_TICKS[1] ticks in (a prefill tick, which raises int8
# scales) with max_step_retries=0. Then a traced fleet whose replica 0
# drains after MONITOR_DRAIN_TICK ticks, shipping its pages. Every
# fault tick counts from the engine's warm-up's end.
MONITOR_SCRAPE_TICK = 2
# the A B C C B A sequence, run MONITOR_ROUNDS times in one process (the
# host-bound serve moves between runs; the medians are what is compared)
MONITOR_ORDER = ("bare", "default", "instrumented", "instrumented",
                 "default", "bare")
MONITOR_ROUNDS = 1
# the monitor's serves' new tokens a request: the serve's 64 cut to 32
# to keep the smoke inside its time limit (the fault ticks and the
# fleet's drain still land before the requests end)
MONITOR_NEW = 32
MONITOR_FAULT_TICKS = (4, 2)
MONITOR_DRAIN_TICK = 12
MONITOR_PATHS = ("/metrics", "/healthz", "/varz", "/timeseries")
# the fp32 twin (2 layers at the serve's width, TF32 off) holds the
# faulted runs' tokens to the fault-free run's exactly
MONITOR_TWIN = dict(num_layers=2, requests=8, max_new=16)


def _get(url):
    """One GET on loopback: (status, body)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _monitor_engine(model, form, **kw):
    """An engine of the serve at ``form`` ("bare", "default",
    "instrumented") on bf16 pages; the instrumented one's time series
    samples every tick (TimeSeriesStore takes no interval of 0)."""
    from rocm_apex_tpu_torch.monitor import (NULL_REGISTRY, FlightRecorder,
                                             TimeSeriesStore, Tracer)

    kw = dict(paged=True, page_size=PAGE_SIZE, **kw)
    if form == "bare":
        kw["registry"] = NULL_REGISTRY
    elif form == "instrumented":
        kw.update(tracer=Tracer(), flight_recorder=FlightRecorder())
    eng = _engine(model, **kw)
    if form == "instrumented":
        eng.timeseries = TimeSeriesStore(eng.registry, interval=1e-9,
                                         capacity=4096)
    return eng


def _trace_checks(eng, path):
    """From C's exported Chrome trace: one finish per request of the
    timed serve, each decode span's start minus its enqueue the TTFT its
    completion record holds (to 1 us), no event dropped."""
    n = eng.tracer.export_chrome_trace(path)
    with open(path) as f:
        body = json.load(f)
    recs = {c["request_id"]: c for c in eng.completions}
    ev = {}
    for e in body["traceEvents"]:
        rid = (e.get("args") or {}).get("request_id")
        if rid in recs and e["name"] in ("enqueue", "decode", "finish"):
            ev.setdefault(rid, {}).setdefault(e["name"], []).append(e)
    finishes = sorted(len(v.get("finish", ())) for v in ev.values())
    check(len(ev) == len(recs) and finishes == [1] * len(recs),
          f"serve_monitor: finish events per request {finishes}")
    err_us = max(abs(v["decode"][0]["ts"] - v["enqueue"][0]["ts"]
                     - 1e3 * recs[rid]["ttft_ms"]) for rid, v in ev.items())
    check(err_us <= 1.0, f"serve_monitor: the trace's TTFT is {err_us:.3f} "
          f"us off the completion records'")
    check(eng.tracer.dropped == 0 and body["otherData"]["dropped_events"]
          == 0, "serve_monitor: the tracer dropped events")
    return dict(events=n, requests=len(ev), ttft_max_err_us=err_us,
                dropped=eng.tracer.dropped)


def _monitor_abc(model, prompts, tmp):
    """The A B C C B A timed serves, MONITOR_ROUNDS times: tokens and
    syncs per tick equal, tok/s of each and each form's median (a host
    cost), C's trace against its completion records, the exporter
    scraped between two ticks of each of C's serves."""
    from rocm_apex_tpu_torch.monitor import start_exporter

    engs = {f: _monitor_engine(model, f)
            for f in ("bare", "default", "instrumented")}
    for eng in engs.values():
        eng.generate(prompts[:SLOTS], max_new_tokens=3)  # warm-up
    c = engs["instrumented"]
    server = start_exporter(c.registry, engine=c)
    runs, scrapes, trace = [], [], None
    try:
        for form in MONITOR_ORDER * MONITOR_ROUNDS:
            eng = engs[form]
            hook = None
            if form == "instrumented":
                eng.tracer.clear()
                got = {}

                def hook(tick, got=got):
                    if tick == MONITOR_SCRAPE_TICK:
                        for path in MONITOR_PATHS:
                            got[path] = _get(server.url + path)

            res, tokens = timed_serve(eng, prompts, MONITOR_NEW, audit=True,
                                      on_tick=hook)
            runs.append((form, res, tokens))
            if form == "instrumented":
                status, text = _get(server.url + "/metrics")
                total = sum(float(ln.rsplit(" ", 1)[1])
                            for ln in text.decode().splitlines()
                            if ln.startswith("serve_completions_total{"))
                varz = json.loads(got["/varz"][1])
                mem = varz["device_memory"]
                scrape = dict(
                    status={p: got[p][0] for p in MONITOR_PATHS},
                    completions_total=total,
                    healthz=json.loads(got["/healthz"][1]),
                    varz_platforms=[m["platform"] for m in mem],
                    varz_mem_bytes_in_use=[m["mem_bytes_in_use"]
                                           for m in mem],
                    timeseries_samples=len(json.loads(
                        got["/timeseries"][1])["t"]),
                )
                check(all(v == 200 for v in scrape["status"].values())
                      and status == 200, f"serve_monitor: a scrape failed "
                      f"during the serve (a sync raises in the handler): "
                      f"{scrape['status']}")
                check(total == len(prompts), f"serve_monitor: /metrics "
                      f"counts {total} completions of {len(prompts)}")
                check(mem and all(m["platform"] == "cuda"
                                  and m["mem_bytes_in_use"] > 0
                                  for m in mem),
                      f"serve_monitor: /varz device memory {mem}")
                scrapes.append(scrape)
                trace = _trace_checks(eng, os.path.join(tmp, "c.json"))
    finally:
        server.close()
    ref_tokens = runs[0][2]
    ref_syncs = runs[0][1]["syncs_per_tick"]
    out = dict(order=[f for f, _, _ in runs], tokens_per_s=[
        r["tokens_per_s"] for _, r, _ in runs], scrapes=scrapes, trace=trace,
        ticks=[r["ticks"] for _, r, _ in runs])
    out["median_tokens_per_s"] = {f: float(np.median(
        [r["tokens_per_s"] for g, r, _ in runs if g == f]))
        for f in MONITOR_ORDER[:3]}
    for form, res, tokens in runs:
        same = sum(a == b for a, b in zip(tokens, ref_tokens))
        check(same == len(prompts), f"serve_monitor: {form} gives "
              f"{same}/{len(prompts)} of the bare engine's tokens")
        check(res["syncs_per_tick"] == ref_syncs, f"serve_monitor: {form} "
              f"syncs per tick {res['syncs_per_tick']} vs bare {ref_syncs}")
    out["syncs_per_tick"] = ref_syncs
    out["tokens_equal_bare"] = len(prompts)
    out["launches"] = runs[-3][1]["launches"]  # the last C serve's
    out["timeseries_samples"] = len(c.timeseries)
    for name in PAGED_SERVE_KERNELS + ("flash_attention_decode_paged",):
        check(out["launches"].get(name, 0) > 0, f"serve_monitor: {name} "
              f"was not launched in C's serve")
    log(f"  tok/s {list(zip(out['order'], [round(x, 1) for x in out['tokens_per_s']]))}"
        f" (host cost of the monitor, A B C C B A x {MONITOR_ROUNDS}); "
        f"medians {out['median_tokens_per_s']}; syncs per tick "
        f"{ref_syncs}; C's trace: {trace}; scrapes: {scrapes[-1]}")
    return out


def _int8_runs(model, prompts, max_new, audit, tmp):
    """On int8 pages, each engine warmed up first: F the fault-free
    serve, its scales copied before and after tick MONITOR_FAULT_TICKS[1];
    Q the Queue 3 plan (host_fetch at that tick, max_step_retries=0),
    its scales copied before the tick and after the requeue; R the
    logits fault on slot 0 with the flight recorder. Returns the results
    and the copies (compared after the runs: a comparison reads the
    device)."""
    from rocm_apex_tpu_torch.inference import Fault, FaultInjected, FaultPlan
    from rocm_apex_tpu_torch.monitor import FlightRecorder

    out = {}
    for run in ("F", "Q", "R"):
        kw = dict(kv_dtype=torch.int8)
        if run == "Q":
            kw["max_step_retries"] = 0
        if run == "R":
            kw["flight_recorder"] = FlightRecorder(
                path=os.path.join(tmp, f"recorder_{len(prompts)}.jsonl"))
        eng = _monitor_engine(model, "default", **kw)
        eng.generate(prompts[:SLOTS], max_new_tokens=3)  # warm-up
        t0 = eng.tick_count
        fault_at = t0 + MONITOR_FAULT_TICKS[1]
        if run == "Q":
            eng.faults = FaultPlan([Fault(site="host_fetch", tick=fault_at)])
        if run == "R":
            eng.faults = FaultPlan([Fault(
                site="logits", tick=t0 + MONITOR_FAULT_TICKS[0],
                payload={"slot": 0, "value": float("inf")})])
        ids = [eng.add_request(p, max_new) for p in prompts]
        done, copies, raised = {}, {}, 0
        # R's logits fault copies its poison to the card with a blocking
        # copy (a sync on the fault path), so only F and Q are audited
        audited = audit and run != "R"
        with (sync_audit(eng) if audited
              else contextlib.nullcontext()) as syncs:
            while eng.has_work():
                if eng.tick_count == fault_at and "pre" not in copies:
                    copies["pre"] = eng.cache.snapshot_scales()
                try:
                    for r in eng.step():
                        done[r.request_id] = r
                except FaultInjected:
                    raised += 1
                    copies["requeued"] = eng.cache.snapshot_scales()
                    check(eng.num_active == 0, "Queue 3: slots still leased "
                          "after the requeue")
                if eng.tick_count == fault_at + 1 and "post" not in copies:
                    copies["post"] = eng.cache.snapshot_scales()
        out[run] = dict(done=done, ids=ids, copies=copies, raised=raised,
                        syncs=dict(syncs) if audited else None,
                        stats=eng.stats(), engine=eng)
    return out


def _monitor_faults(model, prompts, max_new, tmp, audit=True):
    """The flight recorder (R) and the Queue 3 repair (Q) against the
    fault-free int8 run (F): R quarantines slot 0's request alone and
    dumps one nonfinite/slot0 bundle; Q raises once, its scales after
    the requeue are F's before the same tick bit for bit (F's tick
    raised a scale), and every request finishes."""
    runs = _int8_runs(model, prompts, max_new, audit, tmp)
    f, q, r = runs["F"], runs["Q"], runs["R"]
    ref = [f["done"][i].tokens for i in f["ids"]]
    raised_scale = not torch.equal(f["copies"]["pre"], f["copies"]["post"])
    check(raised_scale, "Queue 3: the fault-free run's tick raised no int8 "
          "scale (pick another MONITOR_FAULT_TICKS[1])")
    check(q["raised"] == 1 and "requeued" in q["copies"], "Queue 3: the "
          "host_fetch fault did not raise once")
    restored = torch.equal(q["copies"]["requeued"], q["copies"]["pre"])
    equal_f = torch.equal(q["copies"]["requeued"], f["copies"]["pre"])
    check(restored and equal_f, f"Queue 3: the scales after the requeue are "
          f"not the fault-free run's at the tick (own pre-tick copy "
          f"{restored}, fault-free run's {equal_f})")
    q_tokens = [q["done"][i].tokens for i in q["ids"]]
    check(all(q["done"][i].finish_reason == "length" for i in q["ids"]),
          "Queue 3: a request did not finish after the requeue")
    fr = r["engine"].flight_recorder
    errors = [i for i in r["ids"] if r["done"][i].finish_reason == "error"]
    check(len(fr.dumps) == 1 and fr.dumps[0]["offending"] == ["slot0"]
          and len(errors) == 1 and int(r["stats"]["quarantined"]) == 1,
          f"flight recorder: {len(fr.dumps)} dumps, errors {errors}")
    survivors = [i for i in r["ids"] if i not in errors]
    out = dict(
        queue3=dict(raised=q["raised"], scales_restored=restored,
                    scales_equal_fault_free=equal_f,
                    fault_tick_raised_a_scale=raised_scale,
                    tokens_equal_fault_free=sum(
                        a == b for a, b in zip(q_tokens, ref)),
                    requests=len(prompts), preemptions=int(
                        q["stats"]["preemptions"]),
                    syncs=q["syncs"], fault_free_syncs=f["syncs"]),
        recorder=dict(dumps=len(fr.dumps), offending=fr.dumps[0]["offending"],
                      request_id=fr.dumps[0]["snapshot"]["request_id"],
                      survivors=len(survivors),
                      survivors_equal_fault_free=sum(
                          r["done"][i].tokens == f["done"][i].tokens
                          for i in survivors)),
    )
    return out


def _monitor_fleet(model, prompts):
    """A traced two-replica fleet on bf16 pages under `sync_audit`:
    replica 0 drains after MONITOR_DRAIN_TICK ticks, shipping its pages
    to replica 1; the merged trace shows one finish per trace id, a
    migrated lifeline spans the router and both replicas, and the merged
    registry counts every completion."""
    from rocm_apex_tpu_torch.inference import ReplicaRouter
    from rocm_apex_tpu_torch.monitor import Tracer, trace_lifelines

    engines = [_monitor_engine(model, "default", tracer=Tracer())
               for _ in range(ROUTER_REPLICAS)]
    router = ReplicaRouter(engines=engines, tracer=Tracer())
    router.generate(prompts[:SLOTS], 3)  # warm-up
    for tr in [router.tracer] + [e.tracer for e in engines]:
        tr.clear()
    for e in engines:
        e.reset_stats()
    _zero_launches()
    with sync_audit(*engines) as syncs:
        ids = [router.add_request(p, MONITOR_NEW) for p in prompts]
        done, ticks = {}, 0
        while router.has_work():
            if ticks == MONITOR_DRAIN_TICK:
                router.drain_replica(0)
            for r in router.step():
                done[r.request_id] = r
            ticks += 1
    launches = _launches()
    router.rejoin_replica(0)
    body = router.merged_trace()
    lines = trace_lifelines(body)
    merged = router.merged_registry()
    completions = sum(s["value"] for s in merged.snapshot()[
        "serve_completions_total"]["series"])
    shipped = sum(1 for e in body["traceEvents"] if e["name"] == "migrate"
                  and e["args"].get("shipped"))
    finishes = sorted({v["finishes"] for v in lines.values()})
    spans = max(len(v["pids"]) for v in lines.values())
    check(len(lines) == len(prompts) and finishes == [1],
          f"fleet: {len(lines)} lifelines, finishes {finishes}")
    check(completions == len(prompts), f"fleet: merged registry counts "
          f"{completions} completions")
    check(shipped > 0 and engines[1].stats()["page_ships"] > 0 and spans == 3,
          f"fleet: {shipped} migrations with shipped pages, replica 1 "
          f"imported {engines[1].stats()['page_ships']}, widest lifeline "
          f"{spans} processes")
    check(all(done[i].finish_reason == "length" for i in ids),
          "fleet: a request did not finish")
    out = dict(lifelines=len(lines), finishes_per_trace_id=finishes,
               merged_completions=completions, shipped_migrations=shipped,
               page_ships=int(engines[1].stats()["page_ships"]),
               widest_lifeline_processes=spans, ticks=ticks,
               syncs=dict(syncs), events=len(body["traceEvents"]),
               launches=launches)
    log(f"  fleet: {out}")
    return out


def run_serve_monitor_phase():
    """The monitor layer's host side at the serve's width: the A B C C B
    A serves (the instrumented engine's tokens and syncs per tick equal
    the bare engine's; tok/s of each, a host cost), its trace against
    its completion records, the exporter scraped mid-serve under
    `sync_audit`; the flight recorder and the Queue 3 repair on int8
    pages; the traced fleet; the fp32 twin, where the faulted runs'
    surviving tokens equal the fault-free run's exactly."""
    import tempfile

    model, load_s = _serve_model()
    prompts = serve_prompts(model.cfg.vocab_size)
    res = dict(weights_load_s=load_s, card=smi_line())
    log(f"  card: {res['card']}")
    with tempfile.TemporaryDirectory() as tmp:
        res["abc"] = _monitor_abc(model, prompts, tmp)
        res["launches"] = res["abc"]["launches"]
        log("  -- int8 pages: the flight recorder and the Queue 3 repair")
        _zero_launches()
        res["faults"] = _monitor_faults(model, prompts, MONITOR_NEW, tmp)
        res["faults"]["launches"] = _launches()
        check(res["faults"]["launches"].get(
            "flash_attention_decode_paged_int8", 0) > 0,
            "serve_monitor: the int8 paged read was not launched")
        log(f"  {res['faults']}")
        torch.cuda.empty_cache()
        log("  -- the traced fleet")
        res["fleet"] = _monitor_fleet(model, prompts)
        torch.cuda.empty_cache()
        log("  -- the fp32 twin")
        twin_model = _twin_models(MONITOR_TWIN["num_layers"])[CARD]
        twin_prompts = serve_prompts(twin_model.cfg.vocab_size)[
            :MONITOR_TWIN["requests"]]
        twin = _monitor_faults(twin_model, twin_prompts,
                               MONITOR_TWIN["max_new"], tmp, audit=False)
        for part, key, n in (("queue3", "tokens_equal_fault_free",
                              "requests"),
                             ("recorder", "survivors_equal_fault_free",
                              "survivors")):
            check(twin[part][key] == twin[part][n], f"serve_monitor twin: "
                  f"{part} {twin[part][key]}/{twin[part][n]} equal the "
                  f"fault-free tokens")
        res["twin"] = twin
        log(f"  fp32 twin: {twin}")
    return res


# ---------------------------------------------------------------------------
# phase 34: tensor-parallel GPT training at tp=2
# ---------------------------------------------------------------------------

# bench.py's `--seq-parallel --collective-matmul` step (bench.py:2260-2330,
# :2540-2605) at the train cell's config: tp=2 with sequence parallelism
# and the collective-matmul rings (one piece a shard), O5 (bf16 compute,
# fp32 masters), dropout 0.1, the fused head's mean loss,
# MixedPrecisionAdam(1e-4, wd 0.01) under a dynamic LossScaler; warm-up
# and timed steps on two gloo ranks on the one card
TP_TRAIN_WARMUP, TP_TRAIN_STEPS = 1, 2
# the fp32 twin: 2 layers at the train widths, B 2 x S 128 (cut from S
# 256 to make room for its remat and int8 forms), dropout 0, TF32 off;
# each form's loss and every gradient on the card at tp=2, on the CPU
# at tp=2 and on the card at tp=1 (sliced for the rank); the int8
# rings' forms against the CPU only (tp=1 has no ring to quantize)
TP_TRAIN_TWIN = dict(num_layers=2, batch=2, seq=128)
TP_TRAIN_FORMS = {
    "plain_fused": dict(),
    "sp_materialized": dict(sequence_parallel=True, fused_lm_head=False),
    "ring_fused": dict(sequence_parallel=True, collective_matmul=True),
    "ring_materialized": dict(sequence_parallel=True, collective_matmul=True,
                              fused_lm_head=False),
    "ring_remat": dict(sequence_parallel=True, collective_matmul=True,
                       checkpoint_activations=True),
    "ring_int8": dict(sequence_parallel=True, collective_matmul=True,
                      comm_dtype="int8"),
}
# the twin's losses and gradients: fp32 on both sides, summation orders
# apart (the card's kernels, the CPU's plain versions, tp=1's one partial
# product where tp=2 adds two), relative to each tensor's largest entry
TP_TRAIN_RTOL = 1e-4
# int8 rings, card against CPU: a payload element whose fp32 value lies
# within the two sides' rounding of a half step rounds to neighbouring
# int8 values, one step (amax / 127 of its row) apart, and each such flip
# moves the values downstream of it, so later hops flip more (on an
# H100: 31% of the gradient elements past 1e-4 of their scale). The loss
# stays within TP_TRAIN_RTOL; the gradients are held to the size of the
# int8 wire's own effect on the same step, INT8_TWIN_FACTOR times the
# CPU int8 step's distance from the CPU fp32 step
INT8_TWIN_FACTOR = 4.0
# the bf16 step's comm dtypes, one after the other on the same ranks
TP_TRAIN_COMMS = ("fp32", "int8")


def tp_train_exchanges(layers, head_chunks):
    """The staged exchanges a training step implies at tp=2 with
    sequence parallelism and the rings (one piece a shard), derived:
    forward, the embedding's all-reduce, four ring hops a layer (the QKV
    and fc1 gathers, the dense and fc2 reduce-scatters), the exit gather
    and the fused head's two all-reduces a row chunk (the max, then the
    sums); backward, the head's dx all-reduce a chunk, the final LN's
    gradient sum, eight ring hops a layer (each ring's dx and dW hop),
    the two row-parallel biases' and the two LNs' gradient sums a layer,
    and the embedding scatter's all-gather. An int8 hop is one exchange
    too (its scales and body in one buffer)."""
    return (2 + 4 * layers + 2 * head_chunks) + (
        2 + 12 * layers + head_chunks)


def tp_train_ring_mib(layers, batch, seq, hidden, comm_dtype):
    """The ring hops' MiB a step at tp=2 (one piece a shard), derived:
    each of a layer's 12 hops moves a (batch, seq / 2, hidden) payload.
    fp32 comm: the forward's two gathers move bf16 rows and its two
    reduce-scatters fp32 accumulators; backward, each gather ring's dx is
    a reduce-scatter (fp32) and its dW hop rotates the bf16 rows, each
    reduce-scatter ring's dx is a gather of the bf16 cotangent and its
    dW hop rotates it too: 32 bytes an element a layer. int8: every hop
    one int8 byte an element plus a 4-byte scale a row."""
    rows = batch * seq // TP_RANKS
    elems = rows * hidden
    if comm_dtype == "int8":
        per_layer = 12 * (elems + 4 * rows)
    else:
        per_layer = 32 * elems
    return layers * per_layer / 2**20


class _ExchangeCounter:
    """Counts `parallel_state.exchange` calls by kind while open, with
    their payload bytes and host seconds (an exchange's first copy waits
    for the work queued before it)."""

    def __enter__(self):
        from rocm_apex_tpu_torch.transformer import parallel_state

        self.ps, self.inner = parallel_state, parallel_state.exchange
        self.counts, self.nbytes, self.seconds = {}, {}, {}

        def counted(kind, fn, t, group):
            t1 = time.perf_counter()
            try:
                return self.inner(kind, fn, t, group)
            finally:
                self.seconds[kind] = (self.seconds.get(kind, 0.0)
                                      + time.perf_counter() - t1)
                self.counts[kind] = self.counts.get(kind, 0) + 1
                self.nbytes[kind] = (self.nbytes.get(kind, 0)
                                     + t.numel() * t.element_size())

        parallel_state.exchange = counted
        return self

    def __exit__(self, *exc):
        self.ps.exchange = self.inner
        return False


def _audited_steps(step, warmup, steps, dev):
    """``step()`` (returning its loss, a device tensor) ``warmup`` times,
    then ``steps`` times under `sync_audit` (no sync but the staged
    exchanges), the launches set to 0 just before and read just after
    (wrapper counts and the launch tables), each exchange's host time
    (its first copy waits for the work queued before it) and payload
    bytes by kind. The losses, the ms a step, the exchanges a step by
    kind, their ms and MiB, the syncs, launches and peak memory."""
    from rocm_apex_tpu_torch.ops._build import (
        device_launches,
        reset_device_launches,
    )

    losses = [step() for _ in range(warmup)]
    _zero_launches()
    reset_device_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _ExchangeCounter() as ex:
        with sync_audit() as syncs:
            for _ in range(steps):
                losses.append(step())
        _sync()
    dt = time.perf_counter() - t0
    return dict(
        losses=[float(x) for x in losses], step_ms=1e3 * dt / steps,
        seconds=dt,
        exchanges={k.split(":")[1]: n / steps
                   for k, n in syncs.items() if k.startswith("exchange:")},
        exchanges_per_step=exchange_count(syncs) / steps,
        exchange_ms={k: 1e3 * v / steps for k, v in ex.seconds.items()},
        exchange_mib={k: v / 2**20 / steps for k, v in ex.nbytes.items()},
        syncs={k: n for k, n in syncs.items()
               if not k.startswith("exchange:") and n},
        launches=_launches(), device_kernels=sorted(device_launches()),
        peak_mem_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if dev.type == "cuda" else None))


def _free_card():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _tp_train_steps(rank, dev, spec, out):
    """The bf16 step on this rank at each comm dtype of
    ``spec["comms"]`` (fp32, then int8 ring payloads), one model after
    the other from one tree: warm-up, then the timed steps
    (`_audited_steps`); the losses, the ms a step, the exchanges a step
    by kind with their ms and MiB, the launches, the scaler's state."""
    from rocm_apex_tpu_torch.convert import random_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    tree = None
    for comm in spec["comms"]:
        cfg = GPTConfig(**{**spec["train"], "tensor_parallel_size": TP_RANKS,
                           "sequence_parallel": True,
                           "collective_matmul": True, "comm_dtype": comm},
                        params_dtype=torch.float32, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        tree = tree or random_params(cfg, seed=0)
        step, state, sstate = _trainer(cfg, dev, 1e-4, tree=tree)
        setup_s = time.perf_counter() - t0
        tokens, labels = _train_batch(cfg, spec["batch"], spec["seq"])
        tokens, labels = tokens.to(dev), labels.to(dev)
        gen = torch.Generator().manual_seed(0)  # CPU: the dropout seeds
        carry = [state, sstate]

        def one():
            carry[0], carry[1], loss = step(carry[0], carry[1], tokens,
                                            labels, dropout_generator=gen)
            return loss

        res = _audited_steps(one, spec["warmup"], spec["steps"], dev)
        res.update(
            tokens_per_s=spec["batch"] * spec["seq"] * spec["steps"]
            / res["seconds"], setup_s=setup_s,
            overflows=int(carry[1].overflows),
            loss_scale=float(carry[1].loss_scale))
        out["train" if comm == "fp32" else f"train_{comm}"] = res
        del step, state, sstate, carry, one
        _free_card()


def _grad_worst(got, want):
    """The largest |difference| over the largest |want| entry, over the
    leaves of two gradient dicts."""
    return max(float((got[k].float().cpu() - torch.as_tensor(
        np.asarray(want[k])).float()).abs().max())
        / max(float(np.abs(np.asarray(want[k])).max()), 1e-30)
        for k in want)


def _grad_flip_share(got, want, rtol):
    """The share of all gradient elements more than ``rtol`` of their
    tensor's largest |want| entry apart."""
    over = total = 0
    for k in want:
        w = torch.as_tensor(np.asarray(want[k])).float()
        d = (got[k].float().cpu() - w).abs()
        over += int((d > rtol * float(w.abs().max())).sum())
        total += d.numel()
    return over / total


def _tp_train_twin(rank, dev, spec, out):
    """The fp32 twin on this rank, each form of `TP_TRAIN_FORMS`: the
    loss and every gradient shard on the card and on the CPU at tp=2,
    against the tp=1 card step's loss and gradients sliced for the rank
    (`shard_tp1_params`: the gathered tp=2 gradients against tp=1's);
    a form with int8 rings against the CPU only, with its flip share."""
    import dataclasses

    from rocm_apex_tpu_torch.convert import from_jax_params, random_params
    from rocm_apex_tpu_torch.inference import shard_tp1_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig, GPTModel

    tw = spec["twin"]
    cfg1 = GPTConfig(**{**spec["train"], "num_layers": tw["num_layers"],
                        "hidden_dropout": 0.0, "attention_dropout": 0.0},
                     params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(cfg1, seed=0)
    tokens, labels = _train_batch(cfg1, tw["batch"], tw["seq"])

    def loss_grads(model, where):
        loss = model(tokens.to(where), labels=labels.to(where),
                     loss_reduction="mean")
        loss.backward()
        return float(loss.detach()), {k: p.grad.cpu()
                                      for k, p in model.named_parameters()}

    loss1, g1 = loss_grads(from_jax_params(tree, cfg1, device=dev), dev)
    res = {}
    for form, kw in spec["twin_forms"].items():
        cfg2 = dataclasses.replace(cfg1, tensor_parallel_size=TP_RANKS, **kw)
        want = shard_tp1_params(GPTModel(cfg2, device="meta"), g1, rank)
        got = {where: loss_grads(from_jax_params(tree, cfg2, device=where),
                                 where) for where in (dev, "cpu")}
        (lc, gc), (lp, gp) = got[dev], got["cpu"]
        gp_np = {k: v.numpy() for k, v in gp.items()}
        if cfg2.comm_dtype == "int8":
            _, gf = loss_grads(from_jax_params(tree, dataclasses.replace(
                cfg2, comm_dtype="fp32"), device="cpu"), "cpu")
            res[form] = dict(
                loss_card=lc, loss_cpu=lp, loss_tp1=loss1,
                loss_rel=abs(lc - lp) / abs(lp),
                card_vs_cpu=_grad_worst(gc, gp_np),
                flip_share=_grad_flip_share(gc, gp_np, TP_TRAIN_RTOL),
                wire_effect=_grad_worst(gp, {k: v.numpy()
                                             for k, v in gf.items()}),
                int8_vs_tp1=_grad_worst(gc, want))
            continue
        res[form] = dict(
            loss_card=lc, loss_cpu=lp, loss_tp1=loss1,
            loss_rel=max(abs(lc - lp), abs(lc - loss1)) / abs(loss1),
            card_vs_cpu=_grad_worst(gc, gp_np),
            card_vs_tp1=_grad_worst(gc, want),
            cpu_vs_tp1=_grad_worst(gp, want))
    out["twin"] = res


def _tp_twin_checks(phase, outs, forms, key="twin"):
    """Each twin form's worst relative difference over both ranks within
    `TP_TRAIN_RTOL` (an int8 form: the loss, and its gradients within
    `INT8_TWIN_FACTOR` times the int8 wire's own effect), and the ranks'
    card losses equal; a summary a form."""
    twin = {}
    for form in forms:
        rows_ = [o[key][form] for o in outs]
        if "wire_effect" in rows_[0]:
            worst = max(x["card_vs_cpu"] for x in rows_)
            wire = min(x["wire_effect"] for x in rows_)
            loss_rel = max(x["loss_rel"] for x in rows_)
            twin[form] = dict(rows_[0], worst=worst, worst_wire_effect=wire,
                              worst_flip_share=max(x["flip_share"]
                                                   for x in rows_))
            check(loss_rel <= TP_TRAIN_RTOL
                  and worst <= INT8_TWIN_FACTOR * wire,
                  f"{phase} twin {form}: card against cpu with int8 rings, "
                  f"loss {loss_rel:.3e}, gradients {worst:.3e} of their "
                  f"scale against the wire's own {wire:.3e}")
        else:
            worst = max(max(v for k, v in x.items() if k in (
                "card_vs_cpu", "card_vs_tp1", "cpu_vs_tp1", "loss_rel"))
                for x in rows_)
            twin[form] = dict(rows_[0], worst=worst)
            check(worst <= TP_TRAIN_RTOL, f"{phase} twin {form}: the losses "
                  f"or gradients differ by {worst:.3e} of their scale")
        check(rows_[0]["loss_card"] == rows_[1]["loss_card"],
              f"{phase} twin {form}: the ranks' card losses differ")
    return twin


def _tp_train_routes(cfg, spec):
    """The device kernels rows 1, 2, 8 and 11 must launch on a rank, by
    their plans at the rank's shapes (the LN forward and backward on
    the rank's sequence shard of B x S / tp rows, the packed attention
    over its heads of every row: the wgmma pipes), and those they must
    not (the other routes')."""
    from rocm_apex_tpu_torch.ops import layer_norm as ln
    from rocm_apex_tpu_torch.ops._build import sm_count

    sms = sm_count(torch.device(CARD, 0))
    rows = spec["batch"] * spec["seq"] // TP_RANKS
    f = ln.ln_fwd_plan(rows, cfg.hidden_size, cfg.dtype, sms)["route"]
    b = ln.ln_bwd_plan(rows, cfg.hidden_size, cfg.dtype, sms)["route"]
    need = set(LN_ROUTE_KERNELS[f]) | set(LN_BWD_ROUTE_KERNELS[b])
    need |= {FWD_ROUTE_KERNELS["wgmma"], *BWD_ROUTE_KERNELS["wgmma"]}
    banned = {k for r, ks in LN_ROUTE_KERNELS.items() if r != f for k in ks}
    banned |= {k for r, ks in LN_BWD_ROUTE_KERNELS.items() if r != b
               for k in ks}
    banned |= set(FWD_ROUTE_KERNELS["cuda_cores"]) | set(
        BWD_ROUTE_KERNELS["cuda_cores"])
    return dict(ln_fwd=f, ln_bwd=b, flash="wgmma"), need, banned


def _tp_train_kernel_cases(dev):
    """Rows 1, 2, 8 and 11 at a rank's shapes in the tp=2 bf16 step,
    each against its plain version on the same card inputs by the kernel
    phase's own case generators, checks and tolerances: the residual LN
    forward with dropout and its backward on the rank's (B x S / tp,
    hidden) rows, the packed attention forward and backward over the
    rank's heads (B, S, heads / tp, 3 hd) with the bias and dropout."""
    heads = TRAIN["num_attention_heads"] // TP_RANKS
    hd = TRAIN["hidden_size"] // TRAIN["num_attention_heads"]
    return run_kernel_phase(dev, [
        lambda dev: train_ln_cases(dev, (torch.bfloat16,), tail=False,
                                   rows=TRAIN_BATCH * TRAIN_SEQ // TP_RANKS),
        lambda dev: flash_cases(dev, heads, hd, shapes=[
            (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16, True, 0.1, True)],
            seed=252)])


def int8_quantize_check(dev):
    """The int8 wire's quantization on card tensors bit-equal to the CPU's
    (the contract of `ops.quantized_collectives`: scale amax / 127 by
    true division, round half to even, zero and non-finite rows at scale
    1, inf saturating and nan to 0) at a ring hop's (B x S / tp, hidden)
    payload with such rows planted, and its dequantized values."""
    from rocm_apex_tpu_torch.ops.quantized_collectives import (
        dequantize_int8,
        quantize_int8,
    )

    gen = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn(TRAIN_BATCH * TRAIN_SEQ // TP_RANKS,
                    TRAIN["hidden_size"], device=dev, generator=gen) * 3
    x[1] = 0.0
    x[2, 5], x[3, 7], x[4] = float("inf"), float("-inf"), float("nan")
    t0 = time.perf_counter()
    q, s = quantize_int8(x)
    d = dequantize_int8(q, s)
    _sync()
    ms = 1e3 * (time.perf_counter() - t0)
    qc, sc = quantize_int8(x.cpu())
    same = (torch.equal(q.cpu(), qc) and torch.equal(
        s.cpu().view(torch.int32), sc.view(torch.int32))
        and torch.equal(d.cpu(), dequantize_int8(qc, sc)))
    log(f"  int8 quantize on the card, {tuple(x.shape)}: q, scale and "
        f"dequantized values {'bit-equal to' if same else 'DIFFER from'} "
        f"the CPU's (one call {ms:.3f} ms of host time)")
    check(same, "int8 quantize: the card's bits differ from the CPU's")
    return dict(shape=list(x.shape), bit_equal=same)


def _case_summary(cases):
    return [{k: c[k] for k in ("kernel", "case", "max_abs_err",
                               "err_over_tol", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")} for c in cases]


def _check_rank_steps(what, t, want_ex, calls, steps, cuda, want_mib=None):
    """One rank's timed steps: finite losses, the exchanges a step as
    derived (and their MiB by kind, where given), no other sync, and on
    the card each kernel's wrapper calls ``calls`` a step."""
    check(all(math.isfinite(x) for x in t["losses"]),
          f"{what}: a nonfinite loss {t['losses']}")
    check(t["exchanges_per_step"] == want_ex,
          f"{what}: {t['exchanges_per_step']} exchanges a step "
          f"({t['exchanges']}), the layout implies {want_ex}")
    for kind, mib in (want_mib or {}).items():
        got = t["exchange_mib"].get(kind, 0.0)
        check(abs(got - mib) <= 1e-6 * mib,
              f"{what}: {got} MiB a step of {kind}, derived {mib}")
    check(not t["syncs"], f"{what}: syncs outside the exchanges "
          f"{t['syncs']}")
    if cuda:
        for name, n in calls.items():
            check(t["launches"].get(name, 0) == n * steps,
                  f"{what}: {name} launched {t['launches'].get(name)} "
                  f"times in {steps} steps, {n} a step wanted")


def run_train_tp_phase(spec=None, tp1_losses=None):
    """Tensor-parallel GPT training at tp=2 (bench.py's
    `--seq-parallel --collective-matmul` step, two gloo ranks on the one
    card; then the same step with `--comm-dtype=int8`): rows 1, 2, 8
    and 11 at a rank's bf16 shapes against their plain versions
    (`_tp_train_kernel_cases`); then on each rank the bf16 step's
    warm-up and timed steps at each comm dtype. Checked: the losses
    finite and bit-equal on both ranks; rows 1, 2, 8 and 11 launched at
    the calls a step the layout implies (`TRAIN_CALLS_PER_STEP`: each
    rank runs every layer on its shard) on their plans' routes (the
    launch tables); no sync in the timed steps but the staged exchanges
    (`sync_audit`), as many a step as the layout implies
    (`tp_train_exchanges`, the same at both comm dtypes), the ring hops'
    MiB as derived (`tp_train_ring_mib`), the other kinds' the same at
    both. Reported: the ms a step, the exchanges by kind, the losses
    beside the tp=1 train cell's (``tp1_losses``; the attention masks
    differ: counted, not asserted). The fp32 twin: each form's loss and
    every gradient, tp=2 card against tp=2 CPU against the tp=1 card
    step, within `TP_TRAIN_RTOL`; the int8 form card against CPU."""
    from rocm_apex_tpu_torch.models.gpt import GPTConfig
    from rocm_apex_tpu_torch.ops.linear_xentropy import _chunk_rows

    spec = spec or dict(
        phase="train_tp", device=CARD, train=TRAIN, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, warmup=TP_TRAIN_WARMUP, steps=TP_TRAIN_STEPS,
        comms=TP_TRAIN_COMMS, twin=TP_TRAIN_TWIN, twin_forms=TP_TRAIN_FORMS,
        threads=TP_THREADS)
    dev = torch.device(CARD, 0) if CARD == "cuda" else torch.device(CARD)
    cfg = GPTConfig(**spec["train"], params_dtype=torch.float32,
                    dtype=torch.bfloat16)
    L, rows = cfg.num_layers, spec["batch"] * spec["seq"]
    v_local = cfg.vocab_size // TP_RANKS
    chunks = -(-rows // _chunk_rows(rows, v_local, None))
    want_ex = tp_train_exchanges(L, chunks)
    res = dict(ranks=TP_RANKS, exchanges_want=want_ex, head_chunks=chunks,
               ring_mib_want={c: tp_train_ring_mib(
                   L, spec["batch"], spec["seq"], cfg.hidden_size, c)
                   for c in spec["comms"]})
    cuda = dev.type == "cuda"
    if cuda:
        res["card"] = smi_line()
        log(f"  card: {res['card']}")
        log(f"  -- rows 1, 2, 8 and 11 at a rank's shapes (tp={TP_RANKS}, "
            f"bf16) against their plain versions")
        res["kernel_cases"] = _case_summary(_tp_train_kernel_cases(dev))
        res["int8_quantize"] = int8_quantize_check(dev)
        torch.cuda.empty_cache()
    log(f"  -- {TP_RANKS} ranks")
    outs, res["ranks_s"] = _tp_spawn(spec)
    if cuda:
        routes, need, banned = _tp_train_routes(cfg, spec)
        res["routes"] = routes
    for comm in spec["comms"]:
        key = "train" if comm == "fp32" else f"train_{comm}"
        tr = [o[key] for o in outs]
        for r, t in enumerate(tr):
            want_mib = {"shift": res["ring_mib_want"][comm]}
            if comm != "fp32":
                # the other kinds move what the fp32 run moved
                want_mib.update({k: v for k, v in outs[r]["train"][
                    "exchange_mib"].items() if k != "shift"})
            _check_rank_steps(f"train_tp {comm} rank {r}", t, want_ex,
                              TRAIN_CALLS_PER_STEP, spec["steps"], cuda,
                              want_mib)
            if cuda:
                names = t["device_kernels"]
                check(all(any(k in x for x in names) for k in need)
                      and not any(k in x for x in names for k in banned),
                      f"train_tp {comm} rank {r}: launched {names}; the "
                      f"plans {routes} need {sorted(need)} and none of "
                      f"{sorted(banned)}")
        check(tr[0]["losses"] == tr[1]["losses"],
              f"train_tp {comm}: the ranks' losses differ: "
              f"{tr[0]['losses']} against {tr[1]['losses']}")
        t = tr[0]
        res[key] = dict(
            step_ms=[x["step_ms"] for x in tr], tokens_per_s=[
                x["tokens_per_s"] for x in tr], losses=t["losses"],
            exchanges=t["exchanges"],
            exchanges_per_step=t["exchanges_per_step"],
            exchange_ms=[x["exchange_ms"] for x in tr],
            exchange_mib=t["exchange_mib"],
            launches=t["launches"], loss_scale=t["loss_scale"],
            overflows=t["overflows"], setup_s=[x["setup_s"] for x in tr],
            peak_mem_gib=[x["peak_mem_gib"] for x in tr])
        log(f"  {comm} rings: {spec['steps']} timed steps of B "
            f"{spec['batch']} x S {spec['seq']} a rank: "
            f"{[round(x, 1) for x in res[key]['step_ms']]} ms/step; losses "
            f"{t['losses']}; {t['exchanges_per_step']} exchanges a step "
            f"(derived {want_ex}: {t['exchanges']}), host ms a step in them "
            f"by kind {res[key]['exchange_ms']}, MiB a step "
            f"{t['exchange_mib']} (ring hops derived "
            f"{res['ring_mib_want'][comm]}); loss scale "
            f"{t['loss_scale']:g}, {t['overflows']} overflows; launches "
            f"{t['launches']}")
    res.update({k: res["train"][k] for k in (
        "step_ms", "tokens_per_s", "losses", "exchanges",
        "exchanges_per_step", "exchange_ms", "exchange_mib", "launches",
        "loss_scale", "overflows", "setup_s", "peak_mem_gib")})
    res["tp1_losses"] = None if tp1_losses is None else tp1_losses[:len(
        res["losses"])]
    log(f"  tp=1's train cell losses {res['tp1_losses']} (other attention "
        f"masks: not compared)")
    log("  -- the fp32 twin: tp=2 card vs tp=2 cpu vs tp=1 card")
    res["twin"] = _tp_twin_checks("train_tp", outs, spec["twin_forms"])
    log(f"  fp32 twin ({spec['twin']}): {res['twin']}")
    res["rank_s"] = [o["rank_s"] for o in outs]
    log(f"  ranks' wall time {res['ranks_s']:.1f} s (spawn included), "
        f"{[round(x, 1) for x in res['rank_s']]} s of work a rank")
    return res


# ---------------------------------------------------------------------------
# phase 34: BERT-Large at tp=2
# ---------------------------------------------------------------------------

# bench.py's BERT step (bench.py:216-296) at tp=2, two gloo ranks on the
# one card: BERT-Large, B 8 x S 512, bf16 compute, fp32 masters,
# MixedPrecisionLamb with bf16 moments on each rank's shards; unmasked
# (dropout 0, as bench.py), then with the masked BERT's padding mask and
# dropout 0.1 (`bert_lengths`, BERT_MASKED_DROPOUT)
BERT_TP_WARMUP, BERT_TP_STEPS = 1, 2
BERT_TP_FORMS = ("unmasked", "masked")
# the fp32 twin: 2 layers at the BERT widths, B 2 x S 128, dropout 0, the
# masked parity lengths for the masked form, token types, the loss the
# mean LM loss plus the binary logits against fixed weights (so the
# pooler and the binary head have gradients)
BERT_TP_TWIN = dict(num_layers=2, batch=2, seq=128,
                    lengths=BERT_MASKED_PARITY_LENGTHS)


def bert_tp_exchanges(layers):
    """The staged exchanges of a BERT step at tp=2 without sequence
    parallelism, derived: forward, the vocab-parallel embedding's
    all-reduce, the two row-parallel outputs' all-reduces a layer, the
    vocab-parallel cross-entropy's two (the max, then the target logit
    and the sum of exponentials); backward, the two column-parallel
    inputs' gradient all-reduces a layer and the tied head's. The mask,
    the dropout seeds and LAMB (each rank's shards, as JAX's) exchange
    nothing."""
    return (1 + 2 * layers + 2) + (2 * layers + 1)


def bert_tp_exchange_mib(layers, batch, seq, hidden):
    """Their MiB a step: 4 * layers + 2 all-reduces of the (batch, seq,
    hidden) bf16 stream, the cross-entropy's fp32 row max and its two
    fp32 row sums."""
    rows = batch * seq
    return ((4 * layers + 2) * rows * hidden * 2 + 3 * rows * 4) / 2**20


def bert_tp_calls(layers, masked):
    """Wrapper calls a rank's step: the tp=1 step's (`bert_calls`, or
    `bert_masked_calls` with the padding mask and dropout) but the
    cross-entropy, which is plain code at tp>1 (vocab-parallel, as in
    JAX)."""
    calls = (bert_masked_calls(layers, 1) if masked
             else bert_calls(layers, 1, 1, 0))
    calls.update(xent_fwd_dg=0, xent_fwd=0)
    return calls


def bert_kernel_leaves_tp(tp):
    """A tensor-parallel rank's LAMB kernel leaves of the bench BERT, in
    parameter order: the vocab rows, the QKV and fc1 columns, the dense
    and fc2 rows its shards; the position embeddings, the LM head's
    dense and the pooler whole."""
    h, f = BERT["hidden_size"], BERT["ffn_hidden_size"]
    shapes = [(BERT["vocab_size"] // tp, h),
              (BERT["max_position_embeddings"], h)]
    for _ in range(BERT["num_layers"]):
        shapes += [(h, 3 * h // tp), (h // tp, h), (h, f // tp), (f // tp, h)]
    return shapes + [(h, h), (h, h)]


def _bert_tp_kernel_cases(dev):
    """Rows 1, 2, 7b, 8, 9b, 11 and 16 at a rank's shapes in the tp=2
    bf16 BERT step, each against its plain version on the same card
    inputs by the kernel phase's own case generators, checks, routes and
    tolerances: the LN forward plain and residual and the residual
    forward with dropout and its backward on the rank's whole (B x S,
    hidden) rows (no sequence parallelism), the packed attention over
    the rank's heads (B, S, heads / tp, 3 hd) with the bias, the unpacked
    attention over them with the padding bias and dropout 0.1, and the
    LAMB pair over the rank's kernel leaves."""
    bf = torch.bfloat16
    heads = BERT["num_attention_heads"] // TP_RANKS
    hd = BERT["hidden_size"] // BERT["num_attention_heads"]
    rows, h = BERT_BATCH * BERT_SEQ, BERT["hidden_size"]
    return run_kernel_phase(dev, [
        lambda dev: ln_cases(dev, [(rows, h, residual, bf)
                                   for residual in (False, True)]),
        lambda dev: train_ln_cases(dev, (bf,), tail=False, rows=rows),
        lambda dev: flash_cases(dev, heads, hd, shapes=[
            (BERT_BATCH, BERT_SEQ, bf, True, 0.0, False)], seed=253),
        lambda dev: unpacked_cases(dev, [
            (f"masked BERT, a tp={TP_RANKS} rank's heads, dropout "
             f"{BERT_MASKED_DROPOUT}", (BERT_BATCH, heads, BERT_SEQ, BERT_SEQ,
                                        hd), bf, "bert", False, None,
             BERT_MASKED_DROPOUT, False, False, True, False)], seed=254),
        lambda dev: lamb_cases(dev, [
            (f"a tp={TP_RANKS} rank's BERT leaves",
             bert_kernel_leaves_tp(TP_RANKS), bf, bf, 0.01, True, False)])])


def _bert_tp_steps(rank, dev, spec, out):
    """The bf16 BERT step on this rank, unmasked and masked, one model
    after the other from one tree: warm-up, then the timed steps
    (`_audited_steps`)."""
    from rocm_apex_tpu_torch.convert import random_params
    from rocm_apex_tpu_torch.models.bert import BertConfig

    tree = None
    for form in spec["forms"]:
        masked = form == "masked"
        rate = spec["dropout"] if masked else 0.0
        cfg = BertConfig(**{**spec["bert"], "tensor_parallel_size": TP_RANKS,
                            "hidden_dropout": rate,
                            "attention_dropout": rate},
                         params_dtype=torch.float32, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        tree = tree or random_params(cfg, seed=0)
        step, state, _, _ = _bert_trainer(cfg, dev, torch.bfloat16,
                                          tree=tree)
        setup_s = time.perf_counter() - t0
        tokens, labels = _bert_batch(cfg, spec["batch"], spec["seq"])
        tokens, labels = tokens.to(dev), labels.to(dev)
        mask = (padding_mask(spec["lengths"], spec["seq"]).to(dev)
                if masked else None)
        gen = torch.Generator().manual_seed(0) if rate else None
        carry = [state]

        def one():
            carry[0], loss, _ = step(carry[0], tokens, labels,
                                     dropout_generator=gen,
                                     attention_mask=mask)
            return loss

        res = _audited_steps(one, spec["warmup"], spec["steps"], dev)
        res.update(setup_s=setup_s, tokens_per_s=spec["batch"] * spec["seq"]
                   * spec["steps"] / res["seconds"])
        out[f"bert_{form}"] = res
        del step, state, carry, one
        _free_card()


def _bert_tp_twin(rank, dev, spec, out):
    """The fp32 twin on this rank, unmasked and masked: the per-token
    losses and every gradient shard of mean(losses) + sum(binary * W) on
    the card and on the CPU at tp=2, against the tp=1 card model's
    sliced for the rank."""
    import dataclasses

    from rocm_apex_tpu_torch.convert import from_jax_params, random_params
    from rocm_apex_tpu_torch.inference import shard_tp1_params
    from rocm_apex_tpu_torch.models.bert import BertConfig, BertModel

    tw = spec["twin"]
    cfg1 = BertConfig(**{**spec["bert"], "num_layers": tw["num_layers"],
                         "max_position_embeddings": tw["seq"]},
                      params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(cfg1, seed=0)
    tokens, labels = _bert_batch(cfg1, tw["batch"], tw["seq"])
    rng = np.random.default_rng(1)
    types = torch.from_numpy(rng.integers(0, 2, tokens.shape))
    w = torch.from_numpy(rng.standard_normal((tw["batch"], 2)).astype(
        np.float32))
    res = {}
    for form in spec["forms"]:
        mask = (padding_mask(tw["lengths"], tw["seq"])
                if form == "masked" else None)

        def loss_grads(model, where, mask=mask):
            losses, b = model(tokens.to(where), attention_mask=(
                None if mask is None else mask.to(where)),
                tokentype_ids=types.to(where), lm_labels=labels.to(where))
            (losses.mean() + (b * w.to(where)).sum()).backward()
            return float(losses.mean().detach()), {
                k: p.grad.cpu() for k, p in model.named_parameters()}

        loss1, g1 = loss_grads(from_jax_params(tree, cfg1, device=dev), dev)
        cfg2 = dataclasses.replace(cfg1, tensor_parallel_size=TP_RANKS)
        want = shard_tp1_params(BertModel(cfg2, device="meta"), g1, rank)
        (lc, gc), (lp, gp) = (loss_grads(from_jax_params(
            tree, cfg2, device=where), where) for where in (dev, "cpu"))
        res[form] = dict(
            loss_card=lc, loss_cpu=lp, loss_tp1=loss1,
            loss_rel=max(abs(lc - lp), abs(lc - loss1)) / abs(loss1),
            card_vs_cpu=_grad_worst(gc, {k: v.numpy()
                                         for k, v in gp.items()}),
            card_vs_tp1=_grad_worst(gc, want),
            cpu_vs_tp1=_grad_worst(gp, want))
    out["twin"] = res


def run_bert_tp_phase(spec=None):
    """BERT-Large at tp=2 (bench.py's BERT step, two gloo ranks on the
    one card): rows 1, 2, 7b, 8, 9b, 11 and 16 at a rank's bf16 shapes
    against their plain versions (`_bert_tp_kernel_cases`); then on each
    rank the step unmasked and masked, warm-up and timed steps. Checked:
    the losses finite and bit-equal on both ranks; each kernel's wrapper
    calls a step as the layout implies (`bert_tp_calls`); no sync in the
    timed steps but the staged exchanges, as many a step as derived
    (`bert_tp_exchanges`) and their MiB (`bert_tp_exchange_mib`).
    Reported: the ms a step, the exchanges' host ms and MiB by kind,
    peak memory. The fp32 twin: each form's losses and every gradient,
    tp=2 card against tp=2 CPU against the tp=1 card model, within
    `TP_TRAIN_RTOL`."""
    spec = spec or dict(
        phase="bert_tp", device=CARD, bert=BERT, batch=BERT_BATCH,
        seq=BERT_SEQ, warmup=BERT_TP_WARMUP, steps=BERT_TP_STEPS,
        forms=BERT_TP_FORMS, lengths=[int(x) for x in bert_lengths(
            BERT_BATCH)], dropout=BERT_MASKED_DROPOUT, twin=BERT_TP_TWIN,
        threads=TP_THREADS)
    dev = torch.device(CARD, 0) if CARD == "cuda" else torch.device(CARD)
    cuda = dev.type == "cuda"
    L, h = spec["bert"]["num_layers"], spec["bert"]["hidden_size"]
    want_ex = bert_tp_exchanges(L)
    want_mib = bert_tp_exchange_mib(L, spec["batch"], spec["seq"], h)
    res = dict(ranks=TP_RANKS, exchanges_want=want_ex,
               exchange_mib_want=want_mib)
    if cuda:
        res["card"] = smi_line()
        log(f"  card: {res['card']}")
        log(f"  -- rows 1, 2, 7b, 8, 9b, 11 and 16 at a rank's shapes "
            f"(tp={TP_RANKS}, bf16) against their plain versions")
        res["kernel_cases"] = _case_summary(_bert_tp_kernel_cases(dev))
        torch.cuda.empty_cache()
    log(f"  -- {TP_RANKS} ranks")
    outs, res["ranks_s"] = _tp_spawn(spec)
    for form in spec["forms"]:
        tr = [o[f"bert_{form}"] for o in outs]
        for r, t in enumerate(tr):
            _check_rank_steps(f"bert_tp {form} rank {r}", t, want_ex,
                              bert_tp_calls(L, form == "masked"),
                              spec["steps"], cuda, {"all_reduce": want_mib})
        check(tr[0]["losses"] == tr[1]["losses"],
              f"bert_tp {form}: the ranks' losses differ: {tr[0]['losses']} "
              f"against {tr[1]['losses']}")
        t = tr[0]
        res[form] = dict(
            step_ms=[x["step_ms"] for x in tr],
            tokens_per_s=[x["tokens_per_s"] for x in tr],
            losses=t["losses"], exchanges=t["exchanges"],
            exchanges_per_step=t["exchanges_per_step"],
            exchange_ms=[x["exchange_ms"] for x in tr],
            exchange_mib=t["exchange_mib"], launches=t["launches"],
            setup_s=[x["setup_s"] for x in tr],
            peak_mem_gib=[x["peak_mem_gib"] for x in tr])
        log(f"  {form}: {spec['steps']} timed steps of B {spec['batch']} x S "
            f"{spec['seq']} a rank: "
            f"{[round(x, 1) for x in res[form]['step_ms']]} ms/step; losses "
            f"{t['losses']}; {t['exchanges_per_step']} exchanges a step "
            f"(derived {want_ex}), host ms a step in them "
            f"{res[form]['exchange_ms']}, MiB a step {t['exchange_mib']} "
            f"(derived {want_mib}); peak "
            f"{res[form]['peak_mem_gib']} GiB; launches {t['launches']}")
    log("  -- the fp32 twin: tp=2 card vs tp=2 cpu vs tp=1 card")
    res["twin"] = _tp_twin_checks("bert_tp", outs, spec["forms"])
    log(f"  fp32 twin ({spec['twin']}): {res['twin']}")
    res["rank_s"] = [o["rank_s"] for o in outs]
    log(f"  ranks' wall time {res['ranks_s']:.1f} s (spawn included), "
        f"{[round(x, 1) for x in res['rank_s']]} s of work a rank")
    return res


_TP_WORK = {"serve_tp": (_tp_serves, _tp_twin),
            "train_tp": (_tp_train_steps, _tp_train_twin),
            "bert_tp": (_bert_tp_steps, _bert_tp_twin)}


# ---------------------------------------------------------------------------
# phase 35: activation checkpointing
# ---------------------------------------------------------------------------

# bench.py's `--remat` (bench.py:2327, the GPT bench; bench.py:299-340 and
# :305, `bench_bert --batch=16 --remat`): each model's step with and
# without `checkpoint_activations`, one process, one after the other;
# warm-up and timed steps each
REMAT_WARMUP, REMAT_STEPS = 1, 2
REMAT_BERT_BATCH = 16
# the fp32 twins, card against cpu: the GPT at the train widths
# (`TP_TRAIN_TWIN`'s 2 layers, B 2 x S 128) and BERT at its own (2
# layers, B 2 x S 128, the masked
# parity lengths, token types), under checkpointing and under post-LN
REMAT_TWIN_FORMS = {
    "gpt_remat": ("gpt", dict(checkpoint_activations=True)),
    "gpt_postln": ("gpt", dict(apply_residual_connection_post_layernorm=True)),
    "bert_remat": ("bert", dict(checkpoint_activations=True)),
    "bert_postln": ("bert", dict(
        apply_residual_connection_post_layernorm=True)),
}


def remat_calls(layers, dropout, bert=False):
    """Wrapper calls a checkpointed step (the stack unchained): each
    layer's attention forward twice (the forward, the recompute in the
    backward) and its backward once; each layer's plain ln1 and residual
    ln2 (with hidden dropout when on) twice; the final LN (and BERT's
    LM-head LN) once, plain; every LN's backward once; BERT's
    cross-entropy and LAMB pair once."""
    tail = 2 if bert else 1
    calls = {"flash_attention_qkv_fwd": 2 * layers,
             "flash_attention_qkv_bwd": layers,
             "layer_norm_fwd": (2 if dropout else 4) * layers + tail,
             "layer_norm_fwd_dropout": 2 * layers if dropout else 0,
             "layer_norm_bwd": 2 * layers + tail}
    if bert:
        calls.update(xent_fwd_dg=1, lamb_leaf_stage1=1, lamb_leaf_stage2=1)
    return calls


def _timed_steps(step, warmup, steps):
    """``step()`` ``warmup`` times, then ``steps`` timed times from a
    synchronized card, the launches set to 0 just before and read just
    after, the peak memory of the timed steps."""
    losses = [step() for _ in range(warmup)]
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step())
    _sync()
    dt = time.perf_counter() - t0
    return dict(losses=[float(x) for x in losses], step_ms=1e3 * dt / steps,
                launches=_launches(),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def _remat_gpt(dev, remat, tree):
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(**TRAIN, checkpoint_activations=remat,
                    params_dtype=torch.float32, dtype=torch.bfloat16)
    step, state, sstate = _trainer(cfg, dev, 1e-4, tree=tree)
    tokens, labels = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens, labels = tokens.to(dev), labels.to(dev)
    gen = torch.Generator().manual_seed(0)
    carry = [state, sstate]

    def one():
        carry[0], carry[1], loss = step(carry[0], carry[1], tokens, labels,
                                        dropout_generator=gen)
        return loss

    res = _timed_steps(one, REMAT_WARMUP, REMAT_STEPS)
    res["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ * 1e3 / res["step_ms"]
    return res


def _remat_bert(dev, remat, tree):
    from rocm_apex_tpu_torch.models.bert import BertConfig

    cfg = BertConfig(**BERT, checkpoint_activations=remat,
                     params_dtype=torch.float32, dtype=torch.bfloat16)
    step, state, _, _ = _bert_trainer(cfg, dev, torch.bfloat16, tree=tree)
    tokens, labels = _bert_batch(cfg, REMAT_BERT_BATCH, BERT_SEQ)
    tokens, labels = tokens.to(dev), labels.to(dev)
    carry = [state]

    def one():
        carry[0], loss, _ = step(carry[0], tokens, labels)
        return loss

    res = _timed_steps(one, REMAT_WARMUP, REMAT_STEPS)
    res["tokens_per_s"] = REMAT_BERT_BATCH * BERT_SEQ * 1e3 / res["step_ms"]
    return res


def _remat_twin(dev, kind, kw):
    """One twin form: the loss and every gradient on the card and on the
    CPU (fp32, TF32 off), their worst relative difference."""
    from rocm_apex_tpu_torch.convert import from_jax_params, random_params
    from rocm_apex_tpu_torch.models.bert import BertConfig
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    if kind == "gpt":
        tw = TP_TRAIN_TWIN
        cfg = GPTConfig(**{**TRAIN, "num_layers": tw["num_layers"],
                           "hidden_dropout": 0.0, "attention_dropout": 0.0},
                        params_dtype=torch.float32, dtype=torch.float32,
                        **kw)
        tokens, labels = _train_batch(cfg, tw["batch"], tw["seq"])
        extra = {}
    else:
        tw = BERT_PARITY
        cfg = BertConfig(**{**BERT, "num_layers": tw["num_layers"],
                            "max_position_embeddings": tw["seq"]},
                         params_dtype=torch.float32, dtype=torch.float32,
                         **kw)
        tokens, labels = _bert_batch(cfg, tw["batch"], tw["seq"])
        extra = dict(
            attention_mask=padding_mask(BERT_MASKED_PARITY_LENGTHS,
                                        tw["seq"]),
            tokentype_ids=torch.from_numpy(np.random.default_rng(1).integers(
                0, 2, tokens.shape)))
    tree = random_params(cfg, seed=0)
    got = {}
    for where in (dev, "cpu"):
        model = from_jax_params(tree, cfg, device=where)
        kws = {k: v.to(where) for k, v in extra.items()}
        if kind == "gpt":
            loss = model(tokens.to(where), labels=labels.to(where),
                         loss_reduction="mean")
        else:
            loss = model(tokens.to(where), lm_labels=labels.to(where),
                         **kws)[0].mean()
        loss.backward()
        got[where] = (float(loss.detach()), {
            k: p.grad.cpu() for k, p in model.named_parameters()
            if p.grad is not None})
    (lc, gc), (lp, gp) = got[dev], got["cpu"]
    return dict(loss_card=lc, loss_cpu=lp, loss_rel=abs(lc - lp) / abs(lp),
                card_vs_cpu=_grad_worst(gc, {k: v.numpy()
                                             for k, v in gp.items()}))


def run_remat_phase():
    """Activation checkpointing (bench.py's ``--remat``): the GPT train
    cell (bf16, dropout 0.1, B 16 x S 1024) and BERT-Large (bf16, B 16 x
    S 512, LAMB with bf16 moments), each without and with
    ``checkpoint_activations``, warm-up and timed steps. Checked: finite
    losses; each kernel's wrapper calls a step (`TRAIN_CALLS_PER_STEP`
    and `bert_calls` without, `remat_calls` with: every layer's forward
    twice); the timed steps' peak memory lower with checkpointing.
    Reported: ms a step, tokens/s, peak memory. The fp32 twins (card
    against cpu, loss and every gradient within `PARITY_LOSS_RTOL`):
    checkpointing and post-LN, GPT and BERT."""
    from rocm_apex_tpu_torch.convert import random_params
    from rocm_apex_tpu_torch.models.bert import BertConfig
    from rocm_apex_tpu_torch.models.gpt import GPTConfig
    from rocm_apex_tpu_torch.ops._build import KERNELS

    dev = torch.device(CARD, 0)
    res = dict(card=smi_line())
    log(f"  card: {res['card']}")
    runs = (
        ("gpt", _remat_gpt, GPTConfig(**TRAIN), TRAIN["num_layers"],
         lambda remat: remat_calls(TRAIN["num_layers"], True) if remat
         else TRAIN_CALLS_PER_STEP),
        ("bert", _remat_bert, BertConfig(**BERT), BERT["num_layers"],
         lambda remat: remat_calls(BERT["num_layers"], False, True) if remat
         else bert_calls(BERT["num_layers"], 1, 1, 0)),
    )
    for name, run, cfg, layers, calls in runs:
        tree = random_params(cfg, seed=0)
        for remat in (False, True):
            key = f"{name}_remat" if remat else name
            r = run(dev, remat, tree)
            _free_card()
            want = calls(remat)
            check(all(math.isfinite(x) for x in r["losses"]),
                  f"remat {key}: a nonfinite loss {r['losses']}")
            for k in KERNELS:
                n = want.get(k.name, 0) * REMAT_STEPS
                check(r["launches"].get(k.name, 0) == n,
                      f"remat {key}: {k.name} launched "
                      f"{r['launches'].get(k.name, 0)} times in "
                      f"{REMAT_STEPS} steps, {n} wanted")
            res[key] = r
            log(f"  {key}: {REMAT_STEPS} timed steps "
                f"{r['step_ms']:.1f} ms/step, {r['tokens_per_s']:.0f} "
                f"tokens/s, peak {r['peak_mem_gib']:.2f} GiB; losses "
                f"{r['losses']}; launches {r['launches']}")
        del tree
        plain, remat = res[name], res[f"{name}_remat"]
        check(remat["peak_mem_gib"] < plain["peak_mem_gib"],
              f"remat {name}: peak {remat['peak_mem_gib']:.2f} GiB with "
              f"checkpointing, {plain['peak_mem_gib']:.2f} without")
        res[f"{name}_peak_ratio"] = remat["peak_mem_gib"] / plain[
            "peak_mem_gib"]
        res[f"{name}_ms_ratio"] = remat["step_ms"] / plain["step_ms"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    twin = {}
    for form, (kind, kw) in REMAT_TWIN_FORMS.items():
        t = _remat_twin(dev, kind, kw)
        worst = max(t["loss_rel"], t["card_vs_cpu"])
        check(worst <= PARITY_LOSS_RTOL, f"remat twin {form}: card and cpu "
              f"differ by {worst:.3e} of their scale")
        twin[form] = dict(t, worst=worst)
    res["twin"] = twin
    log(f"  fp32 twins, card vs cpu: {twin}")
    return res


# ---------------------------------------------------------------------------
# phase 36: data parallelism
# ---------------------------------------------------------------------------

# bench.py's --dist-opt step (bench.py:2360-2420) at the train cell's
# config, dp=2 on the one card (two gloo ranks): each rank takes 8 of the
# 16 sequences and feeds its unreduced gradients to DistributedFusedAdam
# (1e-4, wd 0.01, allgather fp32), at fp32 and then at int8 comm; then
# the same step under DDP (`sync_gradients` before MixedPrecisionAdam
# under a dynamic LossScaler: __graft_entry__.py part A's data side)
DP_WARMUP, DP_STEPS = 1, 2
DP_COMMS = ("fp32", "int8")
# the ZeRO state a rank against the replicated MixedPrecisionAdam's 12 B
# a parameter (masters, m, v): each rank holds half of every buffer
# padded to 64-row blocks x 2 ranks
DP_STATE_SHARE = (0.49, 0.52)
# the fp32 twins, card against cpu on each rank: 2 layers at hidden 256
# (2 heads of 128), B 2 x S 128 a rank, dropout 0, DP_TWIN["steps"]
# steps; each form's params held by the optimizer parity rule
# (`_param_err`), its losses to PARITY_LOSS_RTOL; the int8 form's params
# within INT8_TWIN_FACTOR of the int8 wire's own effect on the CPU
DP_TWIN = dict(num_layers=2, hidden_size=256, num_attention_heads=2,
               batch=2, seq=128, steps=2)
DP_TWIN_FORMS = {
    "zero_adam": ("adam", dict()),
    "zero_lamb": ("lamb", dict()),
    "zero_lamb_bf16": ("lamb", dict(allgather_dtype="bf16")),
    "zero_lamb_e5m2": ("lamb", dict(allgather_dtype="e5m2")),
    "zero_adam_int8": ("adam", dict(comm_dtype="int8")),
    "ddp": ("ddp", dict()),
}
# a low wire's params are masters rounded to it: on either side of a
# rounding edge they differ by one step of the wire (bf16 2^-7, e5m2 2^-2
# of the value), which the parity rule's tolerance gains (`_param_err`'s
# ``rel_slack``)
DP_WIRE_STEP = {"bf16": 2.0 ** -7, "e5m2": 2.0 ** -2}
# ResNet-50 under SyncBatchNorm: bench.py rn50 at the rn50 cell's global
# batch (128: 64 a rank), 224^2, bf16 O5, FusedAdam after sync_gradients
DP_RN50_BATCH = RN50_BATCH // 2
# its fp32 twin at rn50_parity's size on each rank (B 2 x 64^2, its bn3
# scale, lr and eps), card vs cpu: the first forward's loss and running
# statistics held by rn50_parity's rules; the first gradients (each
# rank's, before the sync), the later losses and the masters reported.
# At 16-64 values a channel the backward is ill-conditioned in fp32: on
# the CPU alone one and six threads (two summation orders) put a leaf's
# first gradient 4.5% of its largest entry apart (layer4_0.conv1), a 1e-6
# draw added to the images moves the second loss by 1.3e-4 and the
# masters by 0.40 of a leaf's largest entry; the card ("NVIDIA H100 80GB
# HBM3, 700.00 W") and the CPU put layer3_2.conv1's 4.3% apart.
# SyncBatchNorm's backward with its staged exchange is held on the card
# where it is well conditioned: `_dp_spatial` (784 values a channel,
# within DP_SPATIAL_RTOL)
DP_RN50_TWIN = dict(batch=RN50_PARITY["batch"], size=RN50_PARITY["size"],
                    steps=2, lr=RN50_PARITY["lr"], eps=RN50_PARITY["eps"])
# SpatialBottleneck at layer3's widths (1024 -> 256 -> 1024), H 14 split
# 7 + 7 over the two ranks, fp32 with TF32 off, training (SyncBatchNorm
# over the spatial axis) against the unsharded Bottleneck on the gathered
# input: output and every gradient within DP_SPATIAL_RTOL of its scale
DP_SPATIAL = dict(batch=4, size=14, cin=1024, cmid=256, cout=1024)
DP_SPATIAL_RTOL = 1e-4


def _dp_train_cfg(dtype=torch.bfloat16, **over):
    """The train cell's GPTConfig (``over`` replacing its entries)."""
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(**{**TRAIN, **over}, params_dtype=torch.float32,
                     dtype=dtype)


def _dp_model_spec(cfg):
    """The pack spec of a GPT's parameters in their stored dtypes (the
    linears and embeddings in the compute dtype, the LayerNorms fp32):
    the layout the ZeRO optimizer shards."""
    from rocm_apex_tpu_torch.models.gpt import GPTModel
    from rocm_apex_tpu_torch.ops.packing import build_pack_spec

    return build_pack_spec(dict(GPTModel(cfg, device="meta")
                                .named_parameters()))


def dp_zero_exchanges(spec, comm, ranks=2):
    """The staged exchanges and their MiB a ZeRO step takes a rank,
    derived, by kind: fp32 comm, a group's reduce-scatter (an all-reduce
    of the whole fp32 buffer, padded to 64 rows x ranks, then the rank's
    block) and the all-gather of its fp32 master shard; int8 comm, the
    ring's ranks - 1 hops each way, each hop a shard's int8 body (1 byte
    an element) with its fp32 scale column (4 bytes a row) in one
    buffer."""
    from rocm_apex_tpu_torch.ops.packing import ALIGN_ROWS, WIDTH

    ex, mib = {}, {}

    def add(kind, n, nbytes):
        ex[kind] = ex.get(kind, 0) + n
        mib[kind] = mib.get(kind, 0.0) + n * nbytes / 2**20

    for g in spec.groups:
        rows = -(-g.rows // (ALIGN_ROWS * ranks)) * ALIGN_ROWS * ranks
        shard = rows // ranks
        if comm == "int8":
            add("shift", 2 * (ranks - 1), shard * (WIDTH + 4))
        else:
            add("reduce_scatter", 1, rows * WIDTH * 4)
            add("all_gather", 1, shard * WIDTH * 4)
    return ex, mib


def _fingerprint(tensors):
    """One int64 a tensor, the sum of its bits read as integers, on the
    device (no sync): two ranks' tensors with equal fingerprints hold the
    same bits but for a compensating change."""
    return torch.stack([t.detach().view(
        torch.int16 if t.element_size() == 2 else torch.int32).sum(
        dtype=torch.int64) for t in tensors])


def _dp_gpt_steps(rank, dev, spec, out):
    """The bf16 train cell on this rank's half of the batch: the ZeRO step
    (`make_zero_train_step`) at each comm dtype, then the DDP step
    (`make_train_step(grad_sync=sync_gradients)`), each warmed up and
    timed under `sync_audit` (`_audited_steps`), a fingerprint of every
    parameter (and of the DDP masters) after each step, the optimizer
    state's bytes."""
    from rocm_apex_tpu_torch.amp import LossScaler
    from rocm_apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from rocm_apex_tpu_torch.convert import (random_params,
                                             train_state_from_jax_params)
    from rocm_apex_tpu_torch.optimizers import MixedPrecisionAdam
    from rocm_apex_tpu_torch.parallel import sync_gradients
    from rocm_apex_tpu_torch.train import make_train_step, make_zero_train_step

    cfg = _dp_train_cfg(**spec["train"])
    tree = random_params(cfg, seed=0)
    tokens, labels = _train_batch(cfg, spec["batch"], spec["seq"])
    rows = spec["batch"] // TP_RANKS
    tokens = tokens[rank * rows:(rank + 1) * rows].to(dev)
    labels = labels[rank * rows:(rank + 1) * rows].to(dev)
    for form in list(spec["comms"]) + ["ddp"]:
        t0 = time.perf_counter()
        prints = []
        gen = torch.Generator().manual_seed(0)  # CPU: the dropout seeds
        if form == "ddp":
            opt = MixedPrecisionAdam(1e-4, weight_decay=0.01,
                                     compute_dtype=cfg.dtype)
            scaler = LossScaler("dynamic")
            model, state = train_state_from_jax_params(tree, cfg, opt,
                                                       device=dev)
            step = make_train_step(model, opt, scaler,
                                   grad_sync=sync_gradients)
            carry = [state, scaler.init(dev)]

            def one():
                carry[0], carry[1], loss = step(
                    carry[0], carry[1], tokens, labels,
                    dropout_generator=gen)
                prints.append(_fingerprint(
                    list(carry[0].model.values())
                    + list(carry[0].master.values())))
                return loss
        else:
            opt = DistributedFusedAdam(1e-4, weight_decay=0.01,
                                       allgather_dtype="fp32",
                                       comm_dtype=form)
            model, state = train_state_from_jax_params(tree, cfg, opt,
                                                       device=dev)
            step = make_zero_train_step(model, opt)
            carry = [state]
            params = list(model.parameters())

            def one():
                carry[0], loss = step(carry[0], tokens, labels,
                                      dropout_generator=gen)
                prints.append(_fingerprint(params))
                return loss
        setup_s = time.perf_counter() - t0
        state_t = ([carry[0].master, carry[0].m, carry[0].v]
                   if form != "ddp" else [list(carry[0].master.values()),
                                          list(carry[0].m.values()),
                                          list(carry[0].v.values())])
        res = _audited_steps(one, spec["warmup"], spec["steps"], dev)
        res.update(setup_s=setup_s, fingerprints=torch.stack(prints).cpu(),
                   state_bytes=sum(nbytes(*ts) for ts in state_t),
                   params=sum(p.numel() for p in model.parameters()),
                   tokens_per_s=rows * spec["seq"] * spec["steps"]
                   / res["seconds"])
        if form == "ddp":
            res.update(overflows=int(carry[1].overflows),
                       loss_scale=float(carry[1].loss_scale))
        out[f"gpt_{form}"] = res
        del step, state, carry, one, model, opt
        _free_card()


def _dp_twin_run(kind, kw, cfg, tree, tokens, labels, where, steps):
    """One twin form on ``where``: ``steps`` steps from the tree; the
    losses and the params by name (CPU fp32)."""
    from rocm_apex_tpu_torch.amp import LossScaler
    from rocm_apex_tpu_torch.contrib.optimizers import (
        DistributedFusedAdam, DistributedFusedLAMB)
    from rocm_apex_tpu_torch.convert import train_state_from_jax_params
    from rocm_apex_tpu_torch.optimizers import MixedPrecisionAdam
    from rocm_apex_tpu_torch.parallel import sync_gradients
    from rocm_apex_tpu_torch.train import make_train_step, make_zero_train_step

    losses = []
    if kind == "ddp":
        opt = MixedPrecisionAdam(1e-3, weight_decay=0.01, eps=1e-4,
                                 compute_dtype=torch.float32)
        scaler = LossScaler("dynamic")
        model, state = train_state_from_jax_params(tree, cfg, opt,
                                                   device=where)
        step = make_train_step(model, opt, scaler, grad_sync=sync_gradients)
        sstate = scaler.init(model.device)
        for _ in range(steps):
            state, sstate, loss = step(state, sstate, tokens, labels)
            losses.append(float(loss))
        return losses, {k: v.detach().float().cpu()
                        for k, v in state.master.items()}
    cls = DistributedFusedAdam if kind == "adam" else DistributedFusedLAMB
    opt = cls(1e-3, weight_decay=0.01, **({"eps": 1e-4} if kind == "adam"
                                          else {}), **kw)
    model, state = train_state_from_jax_params(tree, cfg, opt, device=where)
    step = make_zero_train_step(model, opt)
    for _ in range(steps):
        state, loss = step(state, tokens, labels)
        losses.append(float(loss))
    return losses, {k: p.detach().float().cpu()
                    for k, p in model.named_parameters()}


def _dp_twin(rank, dev, spec, out):
    """The fp32 twins on this rank (`DP_TWIN_FORMS`): each form's steps on
    the card and on the CPU from one tree and this rank's batch; the
    losses' relative difference and the params' worst error over the
    optimizer parity rule; the int8 form's distance from the CPU against
    the int8 wire's own effect there (the CPU fp32-comm run's params)."""
    from rocm_apex_tpu_torch.convert import flatten_params, random_params

    tw = spec["twin"]
    cfg = _dp_train_cfg(**{**spec["train"], **{
        k: tw[k] for k in ("num_layers", "hidden_size",
                           "num_attention_heads")},
        "hidden_dropout": 0.0, "attention_dropout": 0.0},
        dtype=torch.float32)
    tree = random_params(cfg, seed=0)
    p0 = {k: torch.as_tensor(v).float()
          for k, v in flatten_params(tree["params"]).items()}
    tokens, labels = _train_batch(cfg, tw["batch"] * TP_RANKS, tw["seq"])
    sl = slice(rank * tw["batch"], (rank + 1) * tw["batch"])
    tokens, labels = tokens[sl], labels[sl]
    res = {}
    for form, (kind, kw) in spec["twin_forms"].items():
        lc, pc = _dp_twin_run(kind, kw, cfg, tree, tokens.to(dev),
                              labels.to(dev), dev, tw["steps"])
        lp, pp = _dp_twin_run(kind, kw, cfg, tree, tokens, labels, "cpu",
                              tw["steps"])
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        if kw.get("comm_dtype") == "int8":
            _, pf = _dp_twin_run(kind, {}, cfg, tree, tokens, labels, "cpu",
                                 tw["steps"])
            res[form] = dict(loss_card=lc, loss_cpu=lp, loss_rel=loss_rel,
                             card_vs_cpu=_grad_worst(pc, pp),
                             wire_effect=_grad_worst(pp, pf))
        else:
            err, where = _param_err(pc, pp, p0, DP_WIRE_STEP.get(
                kw.get("allgather_dtype"), 0.0))
            res[form] = dict(loss_card=lc, loss_cpu=lp, loss_rel=loss_rel,
                             param_err=err, param_where=where)
        _free_card()
    out["twin"] = res


def _resnet_sync(dev, dtype, batch, size):
    """ResNet-50 with every norm on SyncBatchNorm over the data axis, from
    seeded weights; its batch for this rank (the rank's seed)."""
    from rocm_apex_tpu_torch.models import resnet50
    from rocm_apex_tpu_torch.transformer import parallel_state

    model = resnet50(num_classes=RN50_CLASSES, dtype=dtype,
                     sync_bn_axis="data", device=dev,
                     generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(
        1 + parallel_state.get_data_parallel_rank())
    x = torch.randn(batch, size, size, 3, generator=gen)
    y = torch.randint(0, RN50_CLASSES, (batch,), generator=gen)
    return model, x.to(dev), y.to(dev)


def dp_rn50_exchanges(model, params):
    """A SyncBatchNorm step's exchanges and MiB, derived: each norm's
    stacked statistics (count, C sums, C sums of squares: fp32) in the
    forward and their cotangents in the backward, then one gradient
    bucket a dtype of ``params``."""
    from rocm_apex_tpu_torch.parallel import SyncBatchNorm

    norms = [m for m in model.modules() if isinstance(m, SyncBatchNorm)]
    buckets = {}
    for p in params.values():
        buckets[p.dtype] = buckets.get(p.dtype, 0) + p.numel() * \
            p.element_size()
    stats = sum(2 * (1 + 2 * m.num_features) * 4 for m in norms)
    return (dict(all_reduce=2 * len(norms) + len(buckets)),
            dict(all_reduce=(stats + sum(buckets.values())) / 2**20),
            len(norms))


def _dp_rn50(rank, dev, spec, out):
    """bench.py rn50's step under SyncBatchNorm on this rank's 64 images:
    bf16 O5, FusedAdam, the gradients through `sync_gradients`; warm-up
    and timed steps, the exchanges of the timed steps counted; a
    fingerprint of the running statistics; then the fp32 twin, card and
    cpu, at `DP_RN50_TWIN`."""
    from rocm_apex_tpu_torch.parallel import sync_gradients

    r = spec["rn50"]
    model, x, y = _resnet_sync(dev, torch.bfloat16, r["batch"], r["size"])
    step, params, opt_state, ss = _rn50_trainer(model, "O5",
                                                grad_sync=sync_gradients)
    carry = [params, opt_state, ss]

    def one():
        carry[0], carry[1], carry[2], loss = step(*carry, x, y)
        return loss

    want_ex, want_mib, norms = dp_rn50_exchanges(model, params)
    losses = [one() for _ in range(spec["warmup"])]
    _zero_launches()
    t0 = time.perf_counter()
    with _ExchangeCounter() as c:
        for _ in range(spec["steps"]):
            losses.append(one())
        _sync()
    dt = time.perf_counter() - t0
    out["rn50"] = dict(
        losses=[float(v) for v in losses], step_ms=1e3 * dt / spec["steps"],
        images_per_s=r["batch"] * spec["steps"] / dt, norms=norms,
        exchanges={k: n / spec["steps"] for k, n in c.counts.items()},
        exchange_mib={k: n / 2**20 / spec["steps"]
                      for k, n in c.nbytes.items()},
        exchanges_want=want_ex, mib_want=want_mib, launches=_launches(),
        stats_print=_fingerprint([b for _, b in model.named_buffers()])
        .cpu(), params_print=_fingerprint(list(carry[0].values())).cpu())
    del model, step, carry, one, params, opt_state
    _free_card()
    tw = spec["rn50_twin"]
    got = {}
    for where in (dev, torch.device("cpu")):
        model, x, y = _resnet_sync(where, torch.float32, tw["batch"],
                                   tw["size"])
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("bn3.scale"):
                    p.fill_(RN50_PARITY_BN3_SCALE)
        first = {}

        def capture(grads, first=first):
            if not first:
                first.update({k: v.detach().float().cpu().clone()
                              for k, v in grads.items()})
            return sync_gradients(grads)

        step, params, opt_state, ss = _rn50_trainer(
            model, "O0", lr=tw["lr"], eps=tw["eps"], master_weights=True,
            loss_scale="dynamic", grad_sync=capture)
        carry, losses, stats = [params, opt_state, ss], [], None
        for _ in range(tw["steps"]):
            carry[0], carry[1], carry[2], loss = step(*carry, x, y)
            losses.append(float(loss))
            # the statistics of the first forward alone: no update yet
            stats = stats or {k: b.cpu().clone()
                              for k, b in model.named_buffers()}
        got[where.type] = (losses, first, stats, {
            k: v.detach().float().cpu() for k, v in carry[1].master.items()})
        del model
        _free_card()
    (lc, gc, sc, mc), (lp, gp, sp, mp) = got[dev.type], got["cpu"]
    apart = {k: float((gc[k] - g).abs().max() / g.abs().max().clamp_min(
        1e-30)) for k, g in gp.items()}
    worst = max(apart, key=apart.get)
    out["rn50_twin"] = dict(
        loss_card=lc, loss_cpu=lp, loss_rel=abs(lc[0] - lp[0]) / abs(lp[0]),
        stats_err=_worst(sc, sp, _stats_scale(sp), RN50_PARITY_STATS_RTOL,
                         1e-30),
        later_loss_rel=max(abs(a - b) / abs(b) for a, b in zip(lc, lp)),
        grads_apart=apart[worst], grads_worst=worst,
        grads_median=float(np.median(list(apart.values()))),
        masters_apart=_grad_worst(mc, {k: v.numpy() for k, v in mp.items()}))


def _dp_spatial(rank, dev, spec, out):
    """`SpatialBottleneck` (SyncBatchNorm over the spatial axis, bound to
    the two ranks) on this rank's 7 of 14 rows against the unsharded
    `Bottleneck` on the gathered input, training mode: the rank's output
    rows, input gradient rows and its parameter gradients (the ranks'
    sum the unsharded block's, summed in the parent), fp32."""
    from rocm_apex_tpu_torch.contrib.bottleneck import (Bottleneck,
                                                        SpatialBottleneck)
    from rocm_apex_tpu_torch.transformer import parallel_state

    s = spec["spatial"]
    parallel_state.set_axis_group("spatial")
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(s["batch"], s["size"], s["size"], s["cin"],
                    generator=gen).to(dev)
    w = torch.randn(s["batch"], s["size"], s["size"], s["cout"],
                    generator=gen).to(dev)
    h = s["size"] // TP_RANKS
    rows = slice(rank * h, (rank + 1) * h)
    blocks = {}
    for name, cls, kw in (("spatial", SpatialBottleneck,
                           dict(spatial_axis="spatial",
                                sync_bn_axis="spatial")),
                          ("dense", Bottleneck, {})):
        blocks[name] = cls(s["cin"], s["cmid"], s["cout"], device=dev,
                           generator=torch.Generator().manual_seed(6), **kw)
    res = {}
    for name, xin, win in (("spatial", x[:, rows], w[:, rows]),
                           ("dense", x, w)):
        xr = xin.clone().requires_grad_(True)
        y = blocks[name](xr, True)
        params = dict(blocks[name].named_parameters())
        grads = torch.autograd.grad((y * win).sum(), [xr, *params.values()])
        res[name] = dict(y=y.detach().cpu(), dx=grads[0].cpu(),
                         dparams={k: g.cpu() for k, g in
                                  zip(params, grads[1:])})
    _sync()
    res["dense"]["y"] = res["dense"]["y"][:, rows]
    res["dense"]["dx"] = res["dense"]["dx"][:, rows]
    out["spatial"] = res


_TP_WORK["data_parallel"] = (_dp_gpt_steps, _dp_twin, _dp_rn50, _dp_spatial)


def _dp_shard_cases(dev, spec):
    """Rows 14 and 15 at a rank's ZeRO shard of the train cell's bf16
    group (every linear and embedding: half its 64-row-padded buffer, in
    fp32 as the ZeRO optimizer holds its masters, moments and the
    reduce-scattered gradients): Adam, LAMB's stages and the row sums of
    the masters (LAMB's sharded norms), each against its plain version
    (`TOL`), launched twice for the same bits, on its route by the launch
    tables (``packed_update_kernel``, ``mt_row_kernel``)."""
    from rocm_apex_tpu_torch.ops import multi_tensor as mt
    from rocm_apex_tpu_torch.ops import optim_kernels as ok

    gen = torch.Generator(device=dev).manual_seed(29)
    big = max(spec.groups, key=lambda g: g.rows)
    rows = -(-big.rows // (64 * TP_RANKS)) * 64
    shape = (rows, 1024)
    case_name = f"a dp={TP_RANKS} rank's ZeRO shard ({rows} x 1024 fp32)"

    def buf(positive=False):
        x = torch.randn(shape, device=dev, generator=gen)
        return x.abs() if positive else x

    p, g, m, v = buf(), buf(), buf(), buf(True)
    wd = torch.full((rows, 1), 0.01, device=dev)

    def case(kernel, name, outs, refs, kern, plain, lib, nb, route,
             tols=None, extra=None, library=None):
        check(_same_bits(kern(), kern()),
              f"{kernel} {name}: two launches differ")
        names = _launched_kernels(kern)
        check(names == {route}, f"{kernel} {name}: launched {names}, its "
              f"route is {route}")
        return dict(kernel=kernel, case=f"{case_name}, {name}",
                    dtype=torch.float32, cmp=compare(outs, refs, extra,
                                                     tols),
                    kern=kern, plain=plain, lib=lib, nbytes=nb,
                    ops=8 * rows * 1024, headline=False, library=library,
                    iters=20, plain_iters=2)

    sv = ok.scalar_vector(_PK_ADAM, dev)
    outs = ok.adam_update(p, g, m, v, wd, sv, True)
    pl, gl, ml, vl = p.clone(), g.clone(), m.clone(), v.clone()
    step = torch.tensor(3.0, device=dev)
    yield case("adam_update", "AdamW", outs,
               ok.adam_plain(p, g, m, v, wd, sv, True),
               lambda: ok.adam_update(p, g, m, v, wd, sv, True),
               lambda: ok.adam_plain(p, g, m, v, wd, sv, True),
               _yardstick("torch._fused_adamw_", lambda: torch._fused_adamw_(
                   [pl], [gl], [ml], [vl], [], [step], lr=1e-3, beta1=0.9,
                   beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
                   maximize=False)),
               nbytes(p, g, m, v, *outs), "packed_update_kernel",
               library="torch._fused_adamw_ in place")
    sv1 = ok.scalar_vector(_PK_LAMB1, dev)
    outs = ok.lamb_stage1(p, g, m, v, wd, sv1, True)
    yield case("lamb_stage1", "AdamW, clip 0.7", outs,
               ok.lamb1_plain(p, g, m, v, wd, sv1, True),
               lambda: ok.lamb_stage1(p, g, m, v, wd, sv1, True),
               lambda: ok.lamb1_plain(p, g, m, v, wd, sv1, True), None,
               nbytes(p, g, m, v, *outs), "packed_update_kernel")
    u = outs[0]
    ratio = torch.rand((rows, 1), device=dev, generator=gen) + 0.5
    lr = torch.tensor([0.5], device=dev)
    scaled = -0.5 * ratio
    (d,) = ok.lamb_stage2(u, ratio, lr)
    yield case("lamb_stage2", "u, a ratio a row", [d],
               list(ok.lamb2_plain(u, ratio, lr)),
               lambda: ok.lamb_stage2(u, ratio, lr),
               lambda: ok.lamb2_plain(u, ratio, lr),
               lambda: torch.mul(u, scaled), nbytes(u, d),
               "packed_update_kernel", library="torch.mul(u, column): the "
               "column pre-scaled by -lr")
    r = mt.row_sumsq(p)
    rr = mt.row_sumsq_plain(p)
    yield case("row_sumsq", "fp32 masters (LAMB's sharded norms)", [r], [rr],
               lambda: mt.row_sumsq(p), lambda: mt.row_sumsq_plain(p),
               lambda: torch.linalg.vector_norm(p, dim=1), nbytes(p, r),
               "mt_row_kernel", tols=[_PK_SUMS_TOL], extra=[_l1_tol(rr)],
               library="torch.linalg.vector_norm(dim=1), the row norms")


def _dp_kernel_cases(dev, spec):
    """The per-rank shapes of the data-parallel path against their plain
    versions by the kernel phase's own generators, checks and
    tolerances: rows 14 and 15 at the ZeRO shard (`_dp_shard_cases`);
    rows 1 and 2 on a rank's 8 x 1024 rows (the residual forward with
    dropout and its backward) and rows 8 and 11 over its 8 sequences of
    all 8 heads, with the bias and dropout."""
    hd = TRAIN["hidden_size"] // TRAIN["num_attention_heads"]
    seqs = TRAIN_BATCH // TP_RANKS
    return run_kernel_phase(dev, [
        lambda dev: _dp_shard_cases(dev, spec),
        lambda dev: train_ln_cases(dev, (torch.bfloat16,), tail=False,
                                   rows=seqs * TRAIN_SEQ),
        lambda dev: flash_cases(dev, TRAIN["num_attention_heads"], hd,
                                shapes=[(seqs, TRAIN_SEQ, torch.bfloat16,
                                         True, 0.1, True)], seed=253)])


def _dp_checks(outs, res, spec, pack, cuda):
    """The ranks' GPT steps against their derivations and each other:
    ``pack`` is the ZeRO optimizer's layout (`_dp_model_spec`)."""
    for form in list(spec["comms"]) + ["ddp"]:
        tr = [o[f"gpt_{form}"] for o in outs]
        if form == "ddp":
            ex, mib = ({"all_reduce": 1}, {"all_reduce": 2 * tr[0]["params"]
                                           / 2**20})
            calls = TRAIN_CALLS_PER_STEP
        else:
            ex, mib = dp_zero_exchanges(pack, form, TP_RANKS)
            # one Adam kernel a dtype group a step, on the rank's shards
            calls = {**TRAIN_CALLS_PER_STEP, "adam_update": len(pack.groups)}
        for r, t in enumerate(tr):
            _check_rank_steps(f"data_parallel {form} rank {r}", t,
                              sum(ex.values()), calls, spec["steps"], cuda,
                              mib)
            check(t["exchanges"] == ex, f"data_parallel {form} rank {r}: "
                  f"exchanges {t['exchanges']}, derived {ex}")
        check(torch.equal(tr[0]["fingerprints"], tr[1]["fingerprints"]),
              f"data_parallel {form}: the ranks' parameters differ after a "
              f"step")
        check(tr[0]["losses"] != tr[1]["losses"],
              f"data_parallel {form}: both ranks report the same losses "
              f"(each has its own batch)")
        if form != "ddp":
            share = tr[0]["state_bytes"] / (12 * tr[0]["params"])
            lo, hi = DP_STATE_SHARE
            check(lo <= share <= hi, f"data_parallel {form}: the ZeRO "
                  f"state a rank is {share:.4f} of the replicated 12 B a "
                  f"parameter, outside {DP_STATE_SHARE}")
        t = tr[0]
        res[f"gpt_{form}"] = dict(
            step_ms=[x["step_ms"] for x in tr], tokens_per_s=[
                x["tokens_per_s"] for x in tr],
            losses=[x["losses"] for x in tr], exchanges=t["exchanges"],
            exchange_ms=[x["exchange_ms"] for x in tr],
            exchange_mib=t["exchange_mib"], exchanges_want=ex,
            mib_want=mib, launches=t["launches"],
            state_gb=t["state_bytes"] / 1e9,
            state_share=t["state_bytes"] / (12 * t["params"]),
            setup_s=[x["setup_s"] for x in tr],
            peak_mem_gib=[x["peak_mem_gib"] for x in tr],
            **({"overflows": t["overflows"], "loss_scale": t["loss_scale"]}
               if form == "ddp" else {}))
        log(f"  {form}: {spec['steps']} timed steps of B "
            f"{spec['batch'] // TP_RANKS} x S {spec['seq']} a rank: "
            f"{[round(x, 1) for x in res[f'gpt_{form}']['step_ms']]} ms/step;"
            f" losses {res[f'gpt_{form}']['losses']}; exchanges a step "
            f"{t['exchanges']} (derived {ex}), host ms in them "
            f"{res[f'gpt_{form}']['exchange_ms']}, MiB {t['exchange_mib']} "
            f"(derived {mib}); state {t['state_bytes'] / 1e9:.3f} GB a rank "
            f"({res[f'gpt_{form}']['state_share']:.4f} of 12 B x "
            f"{t['params']}); peak {res[f'gpt_{form}']['peak_mem_gib']} GiB")


def run_data_parallel_phase(spec=None):
    """Data parallelism at dp=2 on the one card (two gloo ranks, staged
    exchanges): rows 14 and 15 at a rank's ZeRO shard and rows 1, 2, 8,
    11 at its 8 sequences against their plain versions
    (`_dp_kernel_cases`); then on each rank the train cell's bf16 step
    under bench.py's ``--dist-opt`` ZeRO Adam at fp32 and int8 comm and
    under DDP, warm-up and timed steps under `sync_audit`. Checked: finite
    losses, each rank its own; the parameters bit-equal across the ranks
    after every step (fingerprints); the exchanges a step and their MiB
    as derived (`dp_zero_exchanges`; DDP one bf16 all-reduce); no other
    sync; the kernels' calls a step (`TRAIN_CALLS_PER_STEP`); the ZeRO
    state a rank within `DP_STATE_SHARE` of 12 B a parameter. The fp32
    twins card against cpu (`DP_TWIN_FORMS`). ResNet-50 under
    SyncBatchNorm (`dp_rn50_exchanges`, statistics and params bit-equal
    across ranks) and its fp32 twin. `SpatialBottleneck` against the
    unsharded block."""
    spec = spec or dict(
        phase="data_parallel", device=CARD, tp=1, train={},
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, warmup=DP_WARMUP, steps=DP_STEPS,
        comms=DP_COMMS, twin=DP_TWIN, twin_forms=DP_TWIN_FORMS,
        rn50=dict(batch=DP_RN50_BATCH, size=RN50_SIZE),
        rn50_twin=DP_RN50_TWIN, spatial=DP_SPATIAL, threads=TP_THREADS)
    dev = torch.device(CARD, 0) if CARD == "cuda" else torch.device(CARD)
    cuda = dev.type == "cuda"
    pack = _dp_model_spec(_dp_train_cfg(**spec["train"]))
    res = dict(ranks=TP_RANKS, groups=[(g.dtype, g.rows)
                                       for g in pack.groups])
    if cuda:
        res["card"] = smi_line()
        log(f"  card: {res['card']}")
        log(f"  -- rows 14 and 15 at a rank's ZeRO shard, rows 1, 2, 8, 11 "
            f"at its {TRAIN_BATCH // TP_RANKS} sequences, against their "
            f"plain versions")
        res["kernel_cases"] = _case_summary(_dp_kernel_cases(dev, pack))
        torch.cuda.empty_cache()
    log(f"  -- {TP_RANKS} ranks")
    outs, res["ranks_s"] = _tp_spawn(spec)
    _dp_checks(outs, res, spec, pack, cuda)
    twin = {}
    for form in spec["twin_forms"]:
        rows_ = [o["twin"][form] for o in outs]
        if "wire_effect" in rows_[0]:
            worst = max(x["card_vs_cpu"] for x in rows_)
            wire = min(x["wire_effect"] for x in rows_)
            check(worst <= INT8_TWIN_FACTOR * wire, f"data_parallel twin "
                  f"{form}: card against cpu {worst:.3e} of the params' "
                  f"scale, the int8 wire's own {wire:.3e}")
        else:
            worst = max(x["param_err"] for x in rows_)
            check(worst <= 1.0, f"data_parallel twin {form}: params "
                  f"{worst:.3g}x the parity rule's tolerance")
        loss_rel = max(x["loss_rel"] for x in rows_)
        check(loss_rel <= PARITY_LOSS_RTOL, f"data_parallel twin {form}: "
              f"losses card vs cpu {loss_rel:.3e}")
        twin[form] = dict(rows_[0], worst=worst, loss_rel=loss_rel)
    res["twin"] = twin
    log(f"  fp32 twins ({spec['twin']}), card vs cpu: {twin}")
    rn = [o["rn50"] for o in outs]
    for r, t in enumerate(rn):
        check(all(math.isfinite(x) for x in t["losses"]),
              f"data_parallel rn50 rank {r}: a nonfinite loss")
        check(t["exchanges"] == t["exchanges_want"],
              f"data_parallel rn50 rank {r}: exchanges {t['exchanges']}, "
              f"derived {t['exchanges_want']}")
        for k, v in t["mib_want"].items():
            check(abs(t["exchange_mib"][k] - v) <= 1e-6 * v,
                  f"data_parallel rn50 rank {r}: {t['exchange_mib']} MiB, "
                  f"derived {t['mib_want']}")
    check(torch.equal(rn[0]["stats_print"], rn[1]["stats_print"]),
          "data_parallel rn50: the ranks' running statistics differ")
    check(torch.equal(rn[0]["params_print"], rn[1]["params_print"]),
          "data_parallel rn50: the ranks' params differ")
    res["rn50"] = {k: ([x[k] for x in rn] if k in ("step_ms", "losses",
                                                   "images_per_s")
                       else rn[0][k]) for k in rn[0]
                   if not k.endswith("_print")}
    log(f"  rn50 (SyncBatchNorm, {rn[0]['norms']} norms): "
        f"{[round(x['step_ms'], 1) for x in rn]} ms/step a rank, losses "
        f"{[x['losses'] for x in rn]}; exchanges a step {rn[0]['exchanges']}"
        f" MiB {rn[0]['exchange_mib']}")
    tw = [o["rn50_twin"] for o in outs]
    for r, t in enumerate(tw):
        check(t["loss_rel"] <= RN50_PARITY_LOSS_RTOL and t["stats_err"] <= 1,
              f"data_parallel rn50 twin rank {r}: {t}")
    res["rn50_twin"] = tw
    log(f"  rn50 fp32 twin ({spec['rn50_twin']}), card vs cpu: {tw}")
    sp = [o["spatial"] for o in outs]
    dparams = {k: sp[0]["spatial"]["dparams"][k]
               + sp[1]["spatial"]["dparams"][k]
               for k in sp[0]["spatial"]["dparams"]}
    worst = max(
        [_grad_worst({"y": s["spatial"]["y"], "dx": s["spatial"]["dx"]},
                     {"y": s["dense"]["y"].numpy(),
                      "dx": s["dense"]["dx"].numpy()}) for s in sp]
        + [_grad_worst(dparams, {k: g.numpy() for k, g in
                                 sp[0]["dense"]["dparams"].items()})])
    check(worst <= DP_SPATIAL_RTOL, f"data_parallel spatial: {worst:.3e} of "
          f"the scale from the unsharded block")
    res["spatial"] = dict(worst=worst, shape=spec["spatial"])
    log(f"  SpatialBottleneck {spec['spatial']} over {TP_RANKS} ranks "
        f"against the unsharded block: {worst:.3e} of the scale")
    res["rank_s"] = [o["rank_s"] for o in outs]
    log(f"  ranks' wall time {res['ranks_s']:.1f} s (spawn included), "
        f"{[round(x, 1) for x in res['rank_s']]} s of work a rank")
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
                    f"{','.join(ALL_GROUPS)}")
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
                                         fused_bottleneck, layer_norm,
                                         multi_tensor, optim_kernels,
                                         softmax, xentropy)
    groups = (only["kernels"].split("+") if only.get("kernels")
              else list(ALL_GROUPS))
    check(set(groups) <= set(ALL_GROUPS), f"--only kernels: no group "
          f"named {sorted(set(groups) - set(ALL_GROUPS))}")
    runs = {
        "kernels": ("kernels (kernel vs plain version on the card)",
                    lambda: run_kernel_phase(
                        dev, [ALL_GROUPS[g] for g in groups],
                        args.profile)),
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
        "fused_softmax_parity": (
            "fused_softmax parity (attention_impl='fused_softmax', fp32, "
            "TF32 off: GPT 2 layers, S 256, B 2, 3 Adam steps; masked BERT "
            f"2 layers, S 128, B 2, lengths {BERT_MASKED_PARITY_LENGTHS}, 3 "
            "LAMB steps; cuda vs cpu)", run_fused_softmax_parity_phase),
        "train_fused_softmax": (
            f"train fused_softmax (the train cell under attention_impl="
            f"'fused_softmax': 8 layers, bf16, B {TRAIN_BATCH} x S "
            f"{TRAIN_SEQ}, dropout 0.1: {TRAIN_WARMUP} warm-up + "
            f"{TRAIN_STEPS} timed steps)",
            lambda: run_train_phase(args.profile, "fused_softmax",
                                    FUSED_TRAIN_CALLS_PER_STEP)),
        "bert_train_masked_fused_softmax": (
            f"bert train masked fused_softmax (24 layers, bf16, B "
            f"{BERT_BATCH} x S {BERT_SEQ}, padding mask, dropout "
            f"{BERT_MASKED_DROPOUT}, attention_impl='fused_softmax': "
            f"{TRAIN_WARMUP} warm-up + {TRAIN_STEPS} timed steps)",
            lambda: run_bert_train_masked_phase(args.profile,
                                                "fused_softmax")),
        "train_packed_parity": (
            "train packed parity (PackedOptimizerStep, 2 layers, S 256, B 2, "
            "fp32, TF32 off: Adam and LAMB, 3 steps cuda vs cpu, then an inf "
            "gradient; the packed ops outside the step)",
            run_train_packed_parity_phase),
        "train_packed": (
            f"train packed (the train cell with PackedOptimizerStep('adam'): "
            f"8 layers, bf16, B {TRAIN_BATCH} x S {TRAIN_SEQ}, dropout 0.1: "
            f"{TRAIN_WARMUP} warm-up + {TRAIN_STEPS} timed steps; the bare "
            f"update phase beside MixedPrecisionAdam's)",
            lambda: run_train_packed_phase(args.profile, report)),
        "rn50_parity": (
            f"rn50 parity (ResNet-50 widths fused, B {RN50_PARITY['batch']} x "
            f"{RN50_PARITY['size']}^2, fp32, TF32 off: "
            f"{RN50_PARITY['steps']} FusedAdam steps cuda vs cpu)",
            run_rn50_parity_phase),
        "rn50_train": (
            f"rn50 train (bench.py rn50: ResNet-50, B {RN50_BATCH} x "
            f"{RN50_SIZE}^2, bf16 O5, FusedAdam, every conv on F.conv2d: "
            f"{TRAIN_WARMUP} warm-up + {TRAIN_STEPS} timed steps)",
            lambda: run_rn50_train_phase(args.profile, False)),
        "rn50_train_fused": (
            f"rn50 train fused (the same step with --fused=1: the 13 "
            f"stride-1 blocks on the bottleneck kernels)",
            lambda: run_rn50_train_phase(args.profile, True, report)),
        "mha": (
            f"mha (contrib/multihead_attn at Transformer-big's widths: "
            f"{MHA['heads']} heads x {MHA['hidden'] // MHA['heads']}, self "
            f"B {MHA['batch']} x {MHA['seq']}, encdec {MHA['dec_seq']} over "
            f"{MHA['seq']}, bf16; kernels vs plain versions, dropout "
            f"{MHA_DROPOUT}; the normalization API)", run_mha_phase),
        "context_parallel": (
            f"context_parallel ({CP_RANKS} gloo ranks on one card: ring and "
            f"Ulysses at {CP_ATTN}, bf16; the GPT at the train widths, B "
            f"{CP_GPT_BATCH} x {CP_GPT_SEQ}, fp32)",
            run_context_parallel_phase),
        "serve_jnp": (
            "serve_jnp (attention_impl='jnp': parity 2 layers fp32 cuda vs "
            "cpu, then the serve at 8 layers bf16: contiguous, paged, int8 "
            "pages, whole-prompt)",
            lambda: run_serve_jnp_phase(
                report.get("serve", {}).get("tokens"))),
        "optim_amp": (
            f"optim_amp (the optimizers card vs cpu on BERT-Large's leaves at "
            f"{OPTIM_PARITY_LAYERS} layers; BERT-Large under tree and packed "
            f"FusedLAMB, ResNet-50 under FusedSGD: {TRAIN_WARMUP} warm-up + "
            f"{TRAIN_STEPS} timed steps; the GPT under O4, {O4_STEPS} steps; "
            f"O1 casting)", lambda: run_optim_amp_phase(report)),
        "head_dims": (
            "head_dims (GPT-J-6B's attention shape at hd 256, GPT-3 2.7B's at "
            "hd 80, the JAX recipes' GPT and masked BERT at hd 32: "
            f"{HD_TRAIN_STEPS} train steps each, the wide ones served "
            "contiguous and paged; each model's reduced-depth twin card vs "
            "cpu)", run_head_dims_phase),
        "fp16": (
            f"fp16 (amp O2: the GPT train cell, {FP16_TRAIN_WARMUP} + "
            f"{FP16_TRAIN_STEPS} steps, its 2-layer twin on the kernels vs "
            f"the plain versions and under PackedOptimizerStep; the serve "
            f"contiguous and on fp16 pages; BERT-Large under "
            f"MixedPrecisionLamb, {FP16_BERT_STEPS} steps unmasked and "
            f"masked; ResNet-50 fused, {FP16_RN50_STEPS} steps, and its B "
            f"{FP16_RN50_TWIN['batch']} x {FP16_RN50_TWIN['size']}^2 twin)",
            lambda: run_fp16_phase(args.profile)),
        "serve_spec": (
            f"serve_spec (bench.py serve --spec-k={SPEC_K}: {SPEC_REQUESTS} "
            f"periodic requests x {SPEC_NEW} tokens, budget {SPEC_BUDGET}, "
            f"spec_k {SPEC_K} vs 0 on the contiguous cache, bf16 and int8 "
            f"pages of {PAGE_SIZE}; the {SPEC_TWIN['num_layers']}-layer fp32 "
            f"twin card vs cpu)", run_serve_spec_phase),
        "serve_chaos": (
            f"serve_chaos (bench.py serve --chaos=0: the seeded FaultPlan on "
            f"the serve's {N_REQUESTS} requests x {MAX_NEW}, max_queue "
            f"{N_REQUESTS - 2}, a cancel, drain; contiguous, bf16 and int8 "
            f"pages; the fp32 twin; the watchdog)",
            lambda: run_serve_chaos_phase(
                report.get("serve", {}).get("tokens"))),
        "serve_lora": (
            f"serve_lora (multi-LoRA: {len(LORA_RANKS)} adapters of ranks "
            f"{LORA_RANKS[0]}-{LORA_MAX_RANK} in {LORA_TIERS} tiers, "
            f"{LORA_RESIDENT} pool slots; the serve's {N_REQUESTS} requests x "
            f"{MAX_NEW}, contiguous and bf16 pages; tier preemption; the "
            f"{LORA_TWIN['num_layers']}-layer fp32 twin card vs cpu)",
            lambda: run_serve_lora_phase(
                report.get("serve", {}).get("tokens"))),
        "serve_router": (
            f"serve_router ({ROUTER_REPLICAS} replicas on the card: the "
            f"fleet, a replica_kill, a kill on bf16 pages, the "
            f"prefill/decode fleet on bf16 and int8 pages, a rolling drain; "
            f"{N_REQUESTS} requests x {MAX_NEW}; the fp32 twin)",
            lambda: run_serve_router_phase(
                report.get("serve", {}).get("tokens"))),
        "serve_tp": (
            f"serve_tp (tensor parallelism at tp={TP_RANKS}: {TP_RANKS} gloo "
            f"ranks on the one card, the serve's {N_REQUESTS} requests x "
            f"{TP_MAX_NEW} on pages and int8 pages of {PAGE_SIZE} beside "
            f"the tp=1 paged serve, a migration with its pages, spec_k "
            f"{SPEC_K}, a router over {ROUTER_REPLICAS} tp={TP_RANKS} engines "
            f"({N_REQUESTS} requests x {TP_FLEET_NEW}); the "
            f"{SPEC_TWIN['num_layers']}-layer fp32 twin tp=2 card vs cpu vs "
            f"tp=1)", run_serve_tp_phase),
        "serve_monitor": (
            f"serve_monitor (the monitor layer on the serve: {N_REQUESTS} "
            f"requests x {MONITOR_NEW} on bf16 pages of {PAGE_SIZE}, bare / "
            f"default registry / tracer + time series + recorder + exporter "
            f"in A B C C B A order x {MONITOR_ROUNDS}; a logits fault with "
            f"the flight recorder and a host_fetch fault with no retry on "
            f"int8 pages; a "
            f"{ROUTER_REPLICAS}-replica traced fleet with a drain; the "
            f"{MONITOR_TWIN['num_layers']}-layer fp32 twin)",
            run_serve_monitor_phase),
        "train_tp": (
            f"train_tp (tensor-parallel training at tp={TP_RANKS}: "
            f"{TP_RANKS} gloo ranks on the one card, the train cell's GPT "
            f"with sequence parallelism and the collective-matmul rings, "
            f"bf16 O5, B {TRAIN_BATCH} x S {TRAIN_SEQ}, dropout 0.1: "
            f"{TP_TRAIN_WARMUP} warm-up + {TP_TRAIN_STEPS} timed steps; the "
            f"{TP_TRAIN_TWIN['num_layers']}-layer fp32 twin tp=2 card vs "
            f"cpu vs tp=1 in {len(TP_TRAIN_FORMS)} forms)",
            lambda: run_train_tp_phase(
                tp1_losses=report.get("train", {}).get("losses"))),
        "bert_tp": (
            f"bert_tp (BERT-Large at tp={TP_RANKS}: {TP_RANKS} gloo ranks on "
            f"the one card, bf16, B {BERT_BATCH} x S {BERT_SEQ}, LAMB with "
            f"bf16 moments on each rank's shards, unmasked and with the "
            f"padding mask and dropout {BERT_MASKED_DROPOUT}: "
            f"{BERT_TP_WARMUP} warm-up + {BERT_TP_STEPS} timed steps each; "
            f"the {BERT_TP_TWIN['num_layers']}-layer fp32 twin tp=2 card vs "
            f"cpu vs tp=1)", run_bert_tp_phase),
        "remat": (
            f"remat (activation checkpointing: the train cell's GPT, B "
            f"{TRAIN_BATCH} x S {TRAIN_SEQ}, and BERT-Large, B "
            f"{REMAT_BERT_BATCH} x S {BERT_SEQ}, each without and with it: "
            f"{REMAT_WARMUP} warm-up + {REMAT_STEPS} timed steps; the fp32 "
            f"twins of checkpointing and post-LN, card vs cpu)",
            run_remat_phase),
        "data_parallel": (
            f"data_parallel (dp={TP_RANKS}: {TP_RANKS} gloo ranks on the one "
            f"card; the train cell's bf16 GPT, B {TRAIN_BATCH // TP_RANKS} x "
            f"S {TRAIN_SEQ} a rank, under ZeRO Adam at "
            f"{' and '.join(DP_COMMS)}"
            f" comm and under DDP: {DP_WARMUP} warm-up + {DP_STEPS} timed "
            f"steps each; the {DP_TWIN['num_layers']}-layer fp32 twins card "
            f"vs cpu in {len(DP_TWIN_FORMS)} forms; ResNet-50 under "
            f"SyncBatchNorm, B {DP_RN50_BATCH} a rank, bf16 O5, and its fp32 "
            f"twin; SpatialBottleneck at layer3's widths against the "
            f"unsharded block)", run_data_parallel_phase),
    }
    report["phase_s"] = {}
    try:
        for phase in PHASES:
            if phase not in phases:
                continue
            title, run = runs[phase]
            log(f"== {title}")
            t0 = time.perf_counter()
            report["kernel_cases" if phase == "kernels" else phase] = run()
            report["phase_s"][phase] = time.perf_counter() - t0
            log(f"  ({report['phase_s'][phase]:.1f} s)")
    finally:
        # what ran so far, also when a phase failed (the file says which
        # phases finished: `phase_s`)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
                json.dump(report, f, indent=1)

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
        if k.name in ("softmax_causal_fwd", "softmax_bwd"):
            path = "train_fused_softmax"
        if k.name == "softmax_masked_fwd":
            path = "bert_train_masked_fused_softmax"
        if k.name in PACKED_KERNELS:
            path = ("train_packed" if PACKED_TRAIN_CALLS_PER_STEP.get(k.name)
                    else "train_packed_parity")
        if k.name in BNECK_KERNELS:
            path = "rn50_train_fused"
        if k.name == "layer_norm_bwd_noaffine":
            path = "mha"
        if k.name in OPTIM_KERNELS:
            path = "optim_amp"
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
            **({"data_parallel_cases": dp_cases} if (dp_cases := [
                x for x in report.get("data_parallel", {}).get(
                    "kernel_cases", []) if x["kernel"] == k.name]) else {}),
        ))
    if args.out:
        report["kernels"] = kernels
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
