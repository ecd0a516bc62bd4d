"""The ranks of the two-rank test modules (tests/test_torch_tensor_
parallel.py, test_torch_serve_tp.py, test_torch_tp_train_ops.py,
test_torch_train_tp.py, test_torch_router_tp.py): one process each of a
two-rank gloo group on the CPU, spawned once per test module.

This module imports torch and the port only: a spawned rank re-imports
the module that defines its entry point, and the test modules import
JAX. Each rank binds the tensor axis (`initialize_model_parallel`),
reads the inputs the test wrote (numpy arrays in an .npz), runs its
suite and writes what it computed to ``rank<r>.pt`` beside them (an
``error`` entry if the suite raised).

Suite ``"layers"``: each mapping forward and backward on the rank's
input and cotangent, the two collective matmuls at every chunk form, the
three layers at world size 2, and one chunk and one decode apply of the
tp=2 GPT on a contiguous cache. Suite ``"serve"``: the tp=2 engine
(weights from `shard_tp1_params`) on float and int8 pages, greedy and
sampled, with speculation, and a page-shipping migration.

Suite ``"bert"``: the tp=2 BERT's logits, losses and every gradient in
four forms (masked or not, token types or not), a 3-step
`make_bert_train_step` LAMB trajectory, one LAMB step on the rank's
shards, and the refusal of sequence parallelism. Suite ``"remat"``: the
tp=2 GPT (sequence parallelism, rings) and BERT under
``checkpoint_activations`` and post-LN, and the exchanges a remat step
adds. Suite ``"qcomm"``: the three quantized rings at both comm dtypes
and every fallback, the int8 collective matmuls forward and backward at
every chunk form, and the int8 GPT step.

Suite ``"train_ops"``: the collective matmuls' backward at every chunk
form, the two vocab-parallel cross-entropies forward and backward, a
LayerNorm with ``grad_sync_axis``, `broadcast_data` and the seeds of
`model_parallel_prng_keys`. Suite ``"train"``: the tp=2 GPT's loss and
every gradient in each head, sequence-parallel and ring form, a 3-step
`make_train_step` trajectory, and the dropout rules. Suite
``"router"``: a `ReplicaRouter` over two tp=2 engines on float and
int8 pages, a rolling drain that ships pages, injected replica faults,
and the group clock.
"""

import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)

# the mappings under test: name -> (function name, keyword arguments)
MAPPINGS = {
    "copy": ("copy_to_tensor_model_parallel_region", {}),
    "reduce": ("reduce_from_tensor_model_parallel_region", {}),
    "scatter": ("scatter_to_tensor_model_parallel_region", {}),
    "gather": ("gather_from_tensor_model_parallel_region", {}),
    "sp_scatter": ("scatter_to_sequence_parallel_region", dict(dim=1)),
    "sp_gather": ("gather_from_sequence_parallel_region", dict(dim=1)),
    "sp_gather_rep": ("gather_from_sequence_parallel_region",
                      dict(dim=1, tensor_parallel_output_grad=False)),
    "sp_reduce_scatter": ("reduce_scatter_to_sequence_parallel_region",
                          dict(dim=1)),
}
RING_CHUNKS = (None, 8, 5)  # one piece a shard, a tiling chunk, a fallback
# the layer forms: name -> (layer, constructor keywords, input sharded)
LAYERS = {
    "column_gather": ("column", dict(gather_output=True), False),
    "column_local": ("column", dict(gather_output=False), False),
    "column_sp": ("column", dict(gather_output=False,
                                 sequence_parallel=True), True),
    "column_sp_ring": ("column", dict(gather_output=False,
                                      sequence_parallel=True,
                                      collective_matmul=True), True),
    "row_parallel_in": ("row", dict(input_is_parallel=True), True),
    "row_full_in": ("row", dict(input_is_parallel=False), False),
    "row_sp": ("row", dict(input_is_parallel=True,
                           sequence_parallel=True), True),
    "row_sp_ring": ("row", dict(input_is_parallel=True,
                                sequence_parallel=True,
                                collective_matmul=True), True),
}
# the tiny GPT of JAX tests/L0/test_disagg.py and its engine geometry
GPT_SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=32)
ENGINE = dict(num_slots=2, capacity=24, prefill_token_budget=4, paged=True,
              page_size=4)
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
           [12, 13]]
MAX_NEW = 8
SPEC_K = 2
SAMPLED = dict(temperature=0.9, top_k=12)
SAMPLED_SEED = 42
# the train suite: the forms of the tp=2 GPT step, each against JAX's
TRAIN_BATCH, TRAIN_SEQ = 2, 16
RING_CHUNK = 4  # rows a ring piece (a rank's 8 rows: two pieces)
TRAIN_FORMS = {
    "plain_fused": dict(),
    "plain_materialized": dict(fused_lm_head=False),
    "sp_fused": dict(sequence_parallel=True),
    "sp_materialized": dict(sequence_parallel=True, fused_lm_head=False),
    "ring_fused": dict(sequence_parallel=True, collective_matmul=True,
                       collective_matmul_chunk=RING_CHUNK),
    "ring_materialized": dict(sequence_parallel=True, collective_matmul=True,
                              collective_matmul_chunk=RING_CHUNK,
                              fused_lm_head=False),
}
TRAJECTORY_FORMS = ("plain_fused", "ring_fused")
# Adam of the trajectory. eps 1e-4: the key projection's bias has a zero
# gradient in exact arithmetic (the softmax is shift invariant), so its
# fp32 gradient is summation noise (~1e-8 here), and Adam's normalized
# step scales a difference in that noise by lr / eps; at eps 1e-4 two
# summation orders stay within 1e-7 of each other after three steps
LR, WD, EPS = 1e-3, 0.01, 1e-4
TRAJECTORY_STEPS = 3
# the sharded leaf whose gradient takes an inf on rank 0 only
OVERFLOW_LEAF = "transformer.layer_0.mlp.dense_h_to_4h.kernel"
DROPOUT_RATE = 0.2
DROPOUT_SEED = 7
# the fused heads' forms: (smoothing, padding_idx, chunk_size)
HEAD_FORMS = {"plain": (0.0, None, None), "smooth_pad": (0.1, 3, None),
              "chunked": (0.0, None, 8), "chunked_smooth_pad": (0.1, 3, 8)}
# the bert suite: BERT at GPT_SHAPE's widths, B 2 x S 16, padding mask
# lengths (16, 11); forms: (padding mask, token types)
BERT_FORMS = {"unmasked": (False, False), "unmasked_types": (False, True),
              "masked": (True, False), "masked_types": (True, True)}
BERT_TRAJECTORY_FORMS = ("unmasked_types", "masked_types")
BERT_LENGTHS = (16, 11)
# LAMB's eps 1e-4 for the reason of Adam's below: the key bias's gradient
# is fp32 noise, which eps 1e-6 turns into normalized steps of either sign
LAMB_LR, LAMB_WD, LAMB_EPS = 1e-3, 0.01, 1e-4
# the remat suite's forms: (model, config keywords)
REMAT_FORMS = {
    "gpt_remat": ("gpt", dict(checkpoint_activations=True)),
    "gpt_postln": ("gpt", dict(apply_residual_connection_post_layernorm=True)),
    "gpt_ring_remat": ("gpt", dict(sequence_parallel=True,
                                   collective_matmul=True,
                                   collective_matmul_chunk=RING_CHUNK,
                                   checkpoint_activations=True)),
    "gpt_ring_postln": ("gpt", dict(
        sequence_parallel=True, collective_matmul=True,
        collective_matmul_chunk=RING_CHUNK,
        apply_residual_connection_post_layernorm=True)),
    "bert_remat": ("bert", dict(checkpoint_activations=True)),
    "bert_postln": ("bert", dict(
        apply_residual_connection_post_layernorm=True)),
}
# the qcomm suite: the quantized rings' inputs (per-rank rows, width),
# their chunk forms (one piece, a tiling chunk, a fallback) and the
# all-reduce's rows that do not tile the group
QROWS, QWIDTH = 12, 10
QCHUNKS = (None, 3, 5)
QODD_ROWS = 7
INT8_FORMS = {
    "int8_ring": dict(sequence_parallel=True, collective_matmul=True,
                      comm_dtype="int8"),
    "int8_ring_chunked": dict(sequence_parallel=True, collective_matmul=True,
                              collective_matmul_chunk=RING_CHUNK,
                              comm_dtype="int8"),
}
# the router suite: a fleet of two tp=2 engines, a rolling drain after
# DRAIN_TICK fleet ticks, a replica_kill of replica 0 at KILL_TICK and a
# replica_stall at STALL_TICK
DRAIN_TICK, KILL_TICK, STALL_TICK = 3, 2, 1
CLOCK_TIMEOUT_S, CLOCK_SKEW_S = 0.5, 1.0


def tree_of(inputs, prefix="p."):
    """The tp=1 param tree the test wrote (``<prefix><path>`` arrays)."""
    tree = {}
    for key in inputs.files:
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = inputs[key]
    return {"params": tree}


def gpt_config(tp, **kw):
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(**{**GPT_SHAPE, "tensor_parallel_size": tp,
                        "hidden_dropout": 0.0, "attention_dropout": 0.0,
                        "params_dtype": torch.float32,
                        "dtype": torch.float32, **kw})


def tp2_model(inputs, rank):
    """The rank's tp=2 GPT, sliced from the tp=1 tree."""
    from rocm_apex_tpu_torch.convert import from_jax_params
    from rocm_apex_tpu_torch.inference import shard_tp1_params
    from rocm_apex_tpu_torch.models.gpt import GPTModel

    cfg = gpt_config(2)
    tree = shard_tp1_params(GPTModel(cfg, device="meta"), tree_of(inputs),
                            rank)
    return from_jax_params(tree, cfg, device="cpu")


def _mappings(inputs, rank, out):
    from rocm_apex_tpu_torch.transformer.tensor_parallel import mappings

    for name, (fn, kw) in MAPPINGS.items():
        x = torch.from_numpy(inputs[f"map_{name}_x"][rank]).requires_grad_()
        y = getattr(mappings, fn)(x, **kw)
        y.backward(torch.from_numpy(inputs[f"map_{name}_c"][rank]))
        out[f"map_{name}"] = (y.detach(), x.grad)


def _rings(inputs, rank, out):
    from rocm_apex_tpu_torch.ops.collective_matmul import (
        all_gather_matmul,
        matmul_reduce_scatter,
    )

    for name, fn in (("ag", all_gather_matmul),
                     ("rs", matmul_reduce_scatter)):
        x = torch.from_numpy(inputs[f"{name}_x"][rank])
        w = torch.from_numpy(inputs[f"{name}_w"][rank])
        for chunk in RING_CHUNKS:
            out[f"{name}_{chunk}"] = fn(x, w, "tensor", chunk)
        xg = x.clone().requires_grad_()
        fn(xg, w, "tensor").sum().backward()
        out[f"{name}_backward"] = xg.grad
        out[f"{name}_int8"] = fn(x, w, "tensor", comm_dtype="int8")
        # an axis with no group bound is the plain matmul
        out[f"{name}_unbound"] = fn(x, w, "unbound")


def _layers(inputs, rank, out):
    from rocm_apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear,
        RowParallelLinear,
        VocabParallelEmbedding,
    )

    for name, (kind, kw, _) in LAYERS.items():
        k = torch.from_numpy(inputs[f"layer_{name}_kernel"][rank])
        b = torch.from_numpy(inputs[f"layer_{name}_bias"][rank])
        x = torch.from_numpy(inputs[f"layer_{name}_x"][rank])
        cls = ColumnParallelLinear if kind == "column" else RowParallelLinear
        n_in = k.shape[0] * (1 if kind == "column" else 2)
        n_out = b.shape[0] * (2 if kind == "column" else 1)
        layer = cls(n_in, n_out, world_size=2, device="cpu", **kw)
        with torch.no_grad():
            layer.kernel.copy_(k)
            layer.bias.copy_(b)
            out[f"layer_{name}"] = layer(x)[0]
    emb = VocabParallelEmbedding(32, 8, world_size=2, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(inputs["vocab_weight"][rank]))
        out["vocab_lookup"] = emb(torch.from_numpy(inputs["vocab_ids"]))
        out["vocab_attend"] = emb.attend(
            torch.from_numpy(inputs["vocab_hidden"]))
        out["vocab_attend_loss"] = emb.attend_loss(
            torch.from_numpy(inputs["vocab_hidden"]),
            torch.from_numpy(inputs["vocab_ids"]))


def _gpt(inputs, rank, out):
    from rocm_apex_tpu_torch.convert import from_jax_params
    from rocm_apex_tpu_torch.inference import KVCache

    model = tp2_model(inputs, rank)
    chunk_model = model.with_config(sequence_parallel=True,
                                    collective_matmul=True)
    cache = KVCache.for_model(model.cfg, ENGINE["num_slots"],
                              ENGINE["capacity"], device="cpu")
    out["gpt_cache_heads"] = cache.k[0].shape[2]
    chunk = tuple(torch.from_numpy(inputs[f"gpt_chunk_{k}"])
                  for k in ("slots", "pos"))
    with torch.no_grad():
        logits, cache = chunk_model(
            torch.from_numpy(inputs["gpt_chunk_tokens"])[None], cache=cache,
            chunk=chunk)
        out["gpt_chunk_logits"] = logits
        cache.lengths = torch.from_numpy(inputs["gpt_decode_lengths"])
        logits, cache = model(torch.from_numpy(inputs["gpt_decode_tokens"]),
                              cache=cache)
        out["gpt_decode_logits"] = logits
    # the tp>1 model trains (tests/test_torch_train_tp.py holds it to
    # JAX); it refuses a cached decode under sequence parallelism, and
    # the materialized head's smoothing, as JAX's does
    out["gpt_labels"] = model(torch.zeros((1, 4), dtype=torch.long),
                              labels=torch.zeros((1, 4), dtype=torch.long))
    try:
        smooth = from_jax_params(tree_of(inputs), gpt_config(
            2, fused_lm_head=False, label_smoothing=0.1), device="cpu")
        smooth(torch.zeros((1, 4), dtype=torch.long),
               labels=torch.zeros((1, 4), dtype=torch.long))
    except ValueError as e:
        out["gpt_smoothing"] = str(e)
    try:
        chunk_model(torch.zeros((2, 1), dtype=torch.long), cache=cache)
    except ValueError as e:
        out["gpt_sp_decode"] = str(e)


def _layers_suite(inputs, rank, out):
    _mappings(inputs, rank, out)
    _rings(inputs, rank, out)
    _layers(inputs, rank, out)
    _gpt(inputs, rank, out)


def _engine(model, **kw):
    from rocm_apex_tpu_torch.inference import InferenceEngine, SamplingParams

    kw.setdefault("sampling", SamplingParams(temperature=0.0))
    return InferenceEngine(model, **{**ENGINE, **kw})


def _tokens(eng, prompts=PROMPTS):
    return [(r.tokens, r.finish_reason)
            for r in eng.generate(prompts, max_new_tokens=MAX_NEW)]


def _evacuated(eng):
    """Two requests run until each generated 2 tokens, then evacuated
    with their pages (JAX test_disagg.py's `migrate`)."""
    for p in PROMPTS[:2]:
        eng.add_request(list(p), max_new_tokens=MAX_NEW)
    done = {}
    for _ in range(40):
        for r in eng.step():
            done[r.request_id] = (r.tokens, r.finish_reason)
        live = [s for s in eng._slots if s is not None]
        if live and all(len(s.generated) >= 2 for s in live):
            break
    return eng.evacuate(ship_pages=True), done


def _resume(eng, recs, done):
    for rec in recs:
        eng.resume_request(
            rec["prompt"], rec["max_new_tokens"], rec["request_id"],
            generated=rec["generated"], first_token_at=rec["first_token_at"],
            chunks=rec["chunks"], pages=rec.get("pages"))
    while eng.has_work():
        for r in eng.step():
            done[r.request_id] = (r.tokens, r.finish_reason)
    return [done[i] for i in sorted(done)]


def _ship(model, tp1_model, out, **kw):
    """Page shipping from a tp=2 engine into a fresh tp=2 engine, and the
    same payload into a tp=1 engine."""
    recs, done = _evacuated(_engine(model, **kw))
    out["ship_payload"] = [rec.get("pages") for rec in recs]
    dst = _engine(model, **kw)
    out["ship_tokens"] = _resume(dst, recs, dict(done))
    out["ship_stats"] = {k: dst.stats()[k] for k in
                         ("page_ships", "page_ship_fallbacks")}
    out["ship_pages_used"] = (dst.pages_used, dst._allocator.available)
    one = _engine(tp1_model, **kw)
    out["ship_to_tp1_tokens"] = _resume(one, recs, dict(done))
    out["ship_to_tp1_ships"] = one.stats()["page_ships"]


# tp>1 constructions that break JAX's checks, each case breaking the
# check it names and every later one (engine.py:366-412, 490-495): the
# message of the first check in JAX's order must win
BAD_ENGINES = {
    "world_size": dict(tp=4, paged=False),
    "paged": dict(paged=False, prefill_token_budget=None),
    "chunked": dict(prefill_token_budget=None),
    "budget": dict(prefill_token_budget=5, heads=3),
    "heads": dict(heads=3),
    "adapter_pool": dict(adapter_pool=object()),
}


def _construction_errors(model, out):
    """The messages of `BAD_ENGINES`; a stub stands in for a model whose
    heads the group does not divide (the port's model refuses to build
    one)."""
    import types

    from rocm_apex_tpu_torch.inference import InferenceEngine
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    for name, bad in BAD_ENGINES.items():
        bad = dict(bad)
        m = model
        if "tp" in bad or "heads" in bad:
            heads = bad.pop("heads", 4)
            cfg = GPTConfig(**{**GPT_SHAPE, "num_attention_heads": heads,
                               "hidden_size": 8 * heads},
                            tensor_parallel_size=bad.pop("tp", 2))
            m = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
        try:
            InferenceEngine(m, **{**ENGINE, **bad})
        except ValueError as e:
            out[name] = str(e)


def _serve_suite(inputs, rank, out):
    from rocm_apex_tpu_torch.convert import from_jax_params
    from rocm_apex_tpu_torch.inference import SamplingParams

    model = tp2_model(inputs, rank)
    tp1 = from_jax_params(tree_of(inputs), gpt_config(1), device="cpu")
    for form, kw in (("float", {}), ("int8", dict(kv_dtype=torch.int8))):
        eng = _engine(model, **kw)
        out[f"{form}_tokens"] = _tokens(eng)
        out[f"{form}_kv_bytes"] = eng.per_chip_kv_bytes()
        out[f"{form}_heads"] = eng.cache.k[0].shape[1]
        out[f"{form}_base2"] = _tokens(_engine(model, **kw), PROMPTS[:2])
        spec = _engine(model, spec_k=SPEC_K, **kw)
        out[f"{form}_spec_tokens"] = _tokens(spec)
        out[f"{form}_spec_drafted"] = spec.stats()["tokens_drafted"]
        _ship(model, tp1, out.setdefault(f"{form}_ship", {}), **kw)
    eng = _engine(model, sampling=SamplingParams(**SAMPLED),
                  seed=SAMPLED_SEED)
    out["sampled_tokens"] = _tokens(eng)
    _construction_errors(model, out.setdefault("errors", {}))
    from rocm_apex_tpu_torch.inference import ReplicaRouter

    router = ReplicaRouter(engines=[_engine(model)])
    out["router"] = router.tp
    out["router_refusals"] = {}
    for name, call in (
            ("retrace_policy", lambda: ReplicaRouter(
                engines=[_engine(model)], retrace_policy="warn")),
            ("arm_retrace_sentinel", router.arm_retrace_sentinel)):
        try:
            call()
        except NotImplementedError as e:
            out["router_refusals"][name] = str(e)


def _train_ops_suite(inputs, rank, out):
    from rocm_apex_tpu_torch.normalization import MixedFusedLayerNorm
    from rocm_apex_tpu_torch.ops.collective_matmul import (
        all_gather_matmul,
        matmul_reduce_scatter,
    )
    from rocm_apex_tpu_torch.ops.linear_xentropy import (
        vocab_parallel_linear_cross_entropy,
    )
    from rocm_apex_tpu_torch.transformer.tensor_parallel import (
        broadcast_data,
        model_parallel_prng_keys,
        vocab_parallel_cross_entropy,
    )

    def t(key):
        return torch.from_numpy(inputs[key][rank])

    for name, fn in (("ag", all_gather_matmul),
                     ("rs", matmul_reduce_scatter)):
        for chunk in RING_CHUNKS:
            x = t(f"{name}_x").clone().requires_grad_()
            w = t(f"{name}_w").clone().requires_grad_()
            fn(x, w, "tensor", chunk).backward(t(f"{name}_c"))
            out[f"{name}_bwd_{chunk}"] = (x.grad, w.grad)
    logits = t("ce_logits").clone().requires_grad_()
    loss = vocab_parallel_cross_entropy(logits,
                                        torch.from_numpy(inputs["ce_target"]))
    loss.backward(torch.from_numpy(inputs["ce_cot"]))
    out["ce"] = (loss.detach(), logits.grad)
    for form, (smoothing, pad, chunk) in HEAD_FORMS.items():
        h = torch.from_numpy(inputs["lce_hidden"]).requires_grad_()
        w = t("lce_weight").clone().requires_grad_()
        loss = vocab_parallel_linear_cross_entropy(
            h, w, torch.from_numpy(inputs["lce_labels"]), "tensor",
            smoothing, pad, chunk)
        loss.backward(torch.from_numpy(inputs["lce_cot"]))
        out[f"lce_{form}"] = (loss.detach(), h.grad, w.grad)
    ln = MixedFusedLayerNorm(inputs["ln_x"].shape[-1], device="cpu",
                             grad_sync_axis="tensor")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(inputs["ln_w"]))
        ln.bias.copy_(torch.from_numpy(inputs["ln_b"]))
    x = t("ln_x").clone().requires_grad_()
    ln(x).backward(t("ln_c"))
    out["ln"] = (x.grad, ln.weight.grad, ln.bias.grad)
    data = {k: t(f"bd_{k}") for k in ("tokens", "labels")}
    out["broadcast"] = broadcast_data(["tokens", "labels"], data,
                                      torch.int64)
    try:
        broadcast_data(["tokens"], {"tokens": data["tokens"].int()},
                       torch.int64)
    except ValueError as e:
        out["broadcast_dtype"] = str(e)
    keys = model_parallel_prng_keys(123, rank)
    out["prng"] = {k: int(torch.randint(0, 2**31 - 1, (4,), generator=g)
                          .sum()) for k, g in keys.items()}


def bert_config(tp, **kw):
    from rocm_apex_tpu_torch.models.bert import BertConfig

    return BertConfig(**{**GPT_SHAPE, "tensor_parallel_size": tp,
                         "hidden_dropout": 0.0, "attention_dropout": 0.0,
                         "params_dtype": torch.float32,
                         "dtype": torch.float32, **kw})


def bert_batch(inputs, form):
    """(tokens, labels, token types or None, padding mask or None)."""
    masked, types = BERT_FORMS[form]
    t = {k: torch.from_numpy(inputs[f"bert_{k}"])
         for k in ("tokens", "labels", "types", "mask")}
    return (t["tokens"], t["labels"], t["types"] if types else None,
            t["mask"] if masked else None)


def decay_mask(names):
    return {k: not (k.endswith("bias") or "layernorm" in k.lower())
            for k in names}


def _bert_loss_grads(model, inputs, form):
    """Logits, binary logits, the per-token losses and every gradient of
    mean(losses) + sum(binary * W)."""
    tokens, labels, types, mask = bert_batch(inputs, form)
    with torch.no_grad():
        logits, binary = model(tokens, attention_mask=mask,
                               tokentype_ids=types)
    losses, b = model(tokens, attention_mask=mask, tokentype_ids=types,
                      lm_labels=labels)
    (losses.mean() + (b * torch.from_numpy(inputs["bert_w"])).sum()
     ).backward()
    # a leaf the forward does not read (the token types without types)
    # has a zero gradient, as JAX gives it
    return dict(logits=logits, binary=binary, losses=losses.detach(),
                grads={k: torch.zeros_like(p) if p.grad is None else p.grad
                       for k, p in model.named_parameters()})


def _lamb(names):
    from rocm_apex_tpu_torch.optimizers import MixedPrecisionLamb

    return MixedPrecisionLamb(LAMB_LR, weight_decay=LAMB_WD, eps=LAMB_EPS,
                              weight_decay_mask=decay_mask(names),
                              compute_dtype=torch.float32)


def _bert_suite(inputs, rank, out):
    from rocm_apex_tpu_torch.convert import (
        flatten_params,
        from_jax_params,
        train_state_from_jax_params,
    )
    from rocm_apex_tpu_torch.inference import shard_tp1_params
    from rocm_apex_tpu_torch.models.bert import BertConfig, BertModel
    from rocm_apex_tpu_torch.train import make_bert_train_step

    tree = tree_of(inputs)
    names = flatten_params(tree["params"])
    for form in BERT_FORMS:
        model = from_jax_params(tree, bert_config(2), device="cpu")
        out[f"bert_{form}"] = _bert_loss_grads(model, inputs, form)
    for form in BERT_TRAJECTORY_FORMS:
        opt = _lamb(names)
        model, state = train_state_from_jax_params(tree, bert_config(2), opt,
                                                   device="cpu")
        step = make_bert_train_step(model, opt)
        tokens, labels, types, mask = bert_batch(inputs, form)
        losses = []
        for _ in range(TRAJECTORY_STEPS):
            state, loss, found = step(state, tokens, labels, types,
                                      attention_mask=mask)
            losses.append((float(loss), bool(found)))
        out[f"bert_trajectory_{form}"] = (losses, dict(state.master))
    # one LAMB step on the rank's shards from given gradients: each
    # sharded leaf's trust ratio from the rank's own shard norms
    opt = _lamb(names)
    model, state = train_state_from_jax_params(tree, bert_config(2), opt,
                                               device="cpu")
    grads = {k: torch.from_numpy(v) for k, v in flatten_params(
        shard_tp1_params(model, tree_of(inputs, "g."))["params"]).items()}
    state, _ = opt.step_and_probe(state, grads)
    out["bert_lamb_step"] = dict(state.master)
    # sequence parallelism at tp=2 is refused, by the config and by the
    # model over the bound group's size
    for what, fn in (
            ("config", lambda: bert_config(2, sequence_parallel=True)),
            ("model", lambda: BertModel(BertConfig(
                **GPT_SHAPE, sequence_parallel=True), device="meta"))):
        try:
            fn()
        except ValueError as e:
            out[f"bert_sp_{what}"] = str(e)


def _remat_suite(inputs, rank, out):
    from rocm_apex_tpu_torch.convert import from_jax_params
    from rocm_apex_tpu_torch.transformer import parallel_state

    trees = {"gpt": tree_of(inputs), "bert": tree_of(inputs, "bp.")}
    tokens, labels, mask = train_batch(inputs)
    for form, (kind, kw) in REMAT_FORMS.items():
        if kind == "gpt":
            model = from_jax_params(trees["gpt"], gpt_config(2, **kw),
                                    device="cpu")
            loss = model(tokens, labels=labels, loss_mask=mask,
                         loss_reduction="mean")
            loss.backward()
            out[form] = (loss.detach(), {
                k: p.grad for k, p in model.named_parameters()})
        else:
            model = from_jax_params(trees["bert"], bert_config(2, **kw),
                                    device="cpu")
            out[form] = _bert_loss_grads(model, inputs, "masked_types")
    # the exchanges of one ring step, with and without checkpointing
    counts, inner = {}, parallel_state.exchange

    def counted(kind, fn, t, group):
        counts[key] = counts.get(key, 0) + 1
        return inner(kind, fn, t, group)

    parallel_state.exchange = counted
    try:
        for key, remat in (("ring", False), ("ring_remat", True)):
            model = from_jax_params(trees["gpt"], gpt_config(
                2, sequence_parallel=True, collective_matmul=True,
                collective_matmul_chunk=RING_CHUNK,
                checkpoint_activations=remat), device="cpu")
            model(tokens, labels=labels, loss_mask=mask,
                  loss_reduction="mean").backward()
    finally:
        parallel_state.exchange = inner
    out["remat_exchanges"] = counts


def _qcomm_suite(inputs, rank, out):
    from rocm_apex_tpu_torch.convert import from_jax_params
    from rocm_apex_tpu_torch.ops import quantized_collectives as qc
    from rocm_apex_tpu_torch.ops.collective_matmul import (
        all_gather_matmul,
        matmul_reduce_scatter,
    )
    from rocm_apex_tpu_torch.transformer import parallel_state

    def t(key):
        return torch.from_numpy(inputs[key][rank])

    x, odd = t("q_x"), t("q_odd")
    for dtype in ("fp32", "int8"):
        for chunk in QCHUNKS:
            out[f"q_rs_{dtype}_{chunk}"] = qc.ring_reduce_scatter(
                x, "tensor", comm_dtype=dtype, chunk=chunk)
            out[f"q_ag_{dtype}_{chunk}"] = qc.ring_all_gather(
                x, "tensor", comm_dtype=dtype, chunk=chunk)
            out[f"q_ar_{dtype}_{chunk}"] = qc.ring_all_reduce(
                x, "tensor", comm_dtype=dtype, chunk=chunk)
        out[f"q_ar_{dtype}_odd"] = qc.ring_all_reduce(odd, "tensor",
                                                      comm_dtype=dtype)
        out[f"q_ag_{dtype}_dim1"] = qc.ring_all_gather(
            x, "tensor", dim=1, comm_dtype=dtype)
        out[f"q_rs_{dtype}_unbound"] = qc.ring_reduce_scatter(
            x, "unbound", comm_dtype=dtype)
    # the exchanges of one int8 hop: one (the pair in one buffer)
    kinds, inner = [], parallel_state.exchange

    def counted(kind, fn, tensor, group):
        kinds.append((kind, tensor.dtype, tensor.numel()))
        return inner(kind, fn, tensor, group)

    parallel_state.exchange = counted
    try:
        qc.ring_all_gather(x, "tensor", comm_dtype="int8")
    finally:
        parallel_state.exchange = inner
    out["q_hop_exchanges"] = kinds
    for name, fn in (("ag", all_gather_matmul),
                     ("rs", matmul_reduce_scatter)):
        for chunk in RING_CHUNKS:
            xg = t(f"{name}_x").clone().requires_grad_()
            wg = t(f"{name}_w").clone().requires_grad_()
            y = fn(xg, wg, "tensor", chunk, comm_dtype="int8")
            y.backward(t(f"{name}_c"))
            out[f"{name}_int8_{chunk}"] = (y.detach(), xg.grad, wg.grad)
    tree = tree_of(inputs)
    tokens, labels, mask = train_batch(inputs)
    for form, kw in INT8_FORMS.items():
        model = from_jax_params(tree, gpt_config(2, **kw), device="cpu")
        loss = model(tokens, labels=labels, loss_mask=mask,
                     loss_reduction="mean")
        loss.backward()
        out[form] = (loss.detach(), {
            k: p.grad for k, p in model.named_parameters()})


def train_batch(inputs):
    return tuple(torch.from_numpy(inputs[f"train_{k}"])
                 for k in ("tokens", "labels", "mask"))


def _train_suite(inputs, rank, out):
    from rocm_apex_tpu_torch.amp import LossScaler
    from rocm_apex_tpu_torch.convert import (
        from_jax_params,
        train_state_from_jax_params,
    )
    from rocm_apex_tpu_torch.models import gpt as tgpt
    from rocm_apex_tpu_torch.ops import layer_norm as tln
    from rocm_apex_tpu_torch.optimizers import MixedPrecisionAdam
    from rocm_apex_tpu_torch.train import make_train_step

    tree = tree_of(inputs)
    tokens, labels, mask = train_batch(inputs)
    for form, kw in TRAIN_FORMS.items():
        model = from_jax_params(tree, gpt_config(2, **kw), device="cpu")
        loss = model(tokens, labels=labels, loss_mask=mask,
                     loss_reduction="mean")
        loss.backward()
        out[f"grads_{form}"] = (loss.detach(), {
            k: p.grad for k, p in model.named_parameters()})
    for form in TRAJECTORY_FORMS:
        opt = MixedPrecisionAdam(LR, weight_decay=WD, eps=EPS,
                                 compute_dtype=torch.float32)
        model, state = train_state_from_jax_params(
            tree, gpt_config(2, **TRAIN_FORMS[form]), opt, device="cpu")
        scaler = LossScaler("dynamic")
        sstate = scaler.init()
        step = make_train_step(model, opt, scaler)
        losses = []
        for _ in range(TRAJECTORY_STEPS):
            state, sstate, loss = step(state, sstate, tokens, labels, mask)
            losses.append(float(loss))
        out[f"trajectory_{form}"] = (losses, dict(state.master))
    # one rank's overflow: an inf in rank 0's shard of a sharded leaf's
    # gradient; each rank probes its own gradients, with no collective
    opt = MixedPrecisionAdam(LR, weight_decay=WD, eps=EPS,
                             compute_dtype=torch.float32)
    model, state = train_state_from_jax_params(tree, gpt_config(2), opt,
                                               device="cpu")
    grads = {k: torch.full_like(v, 1e-3) for k, v in state.master.items()}
    if rank == 0:
        grads[OVERFLOW_LEAF][0, 0] = float("inf")
    _, found_inf = opt.step_and_probe(state, grads)
    out["overflow_found_inf"] = bool(found_inf)
    # the dropout rules: the seeds a rank draws from one generator state
    for sp in (False, True):
        cfg = gpt_config(2, sequence_parallel=sp)
        seeds = {}
        for name, fn in (("hidden", tgpt.hidden_dropout_seed),
                         ("attention", tgpt.attention_dropout_seed)):
            seeds[name] = fn(torch.Generator().manual_seed(DROPOUT_SEED),
                             cfg)
        out[f"seeds_sp{int(sp)}"] = seeds
    # hidden dropout without sequence parallelism: the replicated stream
    # draws the tp=1 model's masks, forward and backward
    kw = dict(hidden_dropout=DROPOUT_RATE)
    model = from_jax_params(tree, gpt_config(2, **kw), device="cpu")
    loss = model(tokens, labels=labels, loss_mask=mask, loss_reduction="mean",
                 deterministic=False,
                 dropout_generator=torch.Generator().manual_seed(
                     DROPOUT_SEED))
    loss.backward()
    out["dropout_hidden"] = (loss.detach(), {
        k: p.grad for k, p in model.named_parameters()})
    # under sequence parallelism: the rank's LN dropout mask at its seed,
    # three ways (keep fraction, kept values, the backward's mask)
    seed = out["seeds_sp1"]["hidden"]
    res = torch.from_numpy(inputs["drop_residual"])
    delta = torch.from_numpy(inputs["drop_delta"]).requires_grad_()
    h = res.shape[-1]
    _, s = tln.layer_norm_residual_dropout_affine(
        res, delta, torch.ones(h), torch.zeros(h), seed, DROPOUT_RATE, 1e-5,
        torch.float32)
    s.backward(torch.ones_like(s))
    out["dropout_ln"] = (s.detach() - res, delta.grad)


def _router_engines(model, n=2, **kw):
    return [_engine(model, **kw) for _ in range(n)]


def _fleet_tokens(router, prompts=PROMPTS):
    return [(r.tokens, r.finish_reason)
            for r in router.generate(prompts, max_new_tokens=MAX_NEW)]


def _drain_run(model, rank, **kw):
    """Replica 0 drains after DRAIN_TICK fleet ticks; its requests ship
    their pages to replica 1. Returns the tokens, each payload, and
    whether every payload's heads of this rank were its pool's blocks
    (read before the evacuation released them)."""
    from rocm_apex_tpu_torch.inference import ReplicaRouter

    router = ReplicaRouter(engines=_router_engines(model, **kw))
    for p in PROMPTS:
        router.add_request(list(p), MAX_NEW)
    done = {}
    for _ in range(DRAIN_TICK):
        for r in router.step():
            done[r.request_id] = (r.tokens, r.finish_reason)
    src = router.replica(0)
    c, ps = src.cache, src.cache.page_size
    own = {}
    for slot, st in enumerate(src._slots):
        if st is not None:
            idx = torch.as_tensor(src._table[slot, :-(-st.pos // ps)],
                                  dtype=torch.long)
            own[st.req.request_id] = [b.index_select(0, idx) for b in (
                *c.k, *c.v, *(c.k_scale or ()), *(c.v_scale or ()))]
    heads = c.k[0].shape[1]
    router.drain_replica(0)
    payloads, equal = {}, True
    for rec in router._pending:
        pay = rec.get("pages")
        if pay is None:
            continue
        payloads[rec["request_id"]] = pay
        blocks = [*pay["k"], *pay["v"], *pay.get("k_scale", ()),
                  *pay.get("v_scale", ())]
        equal &= all(torch.equal(b.narrow(1, rank * heads, heads), o)
                     for b, o in zip(blocks, own[rec["request_id"]]))
    while router.has_work():
        for r in router.step():
            done[r.request_id] = (r.tokens, r.finish_reason)
    return dict(tokens=[done[i] for i in sorted(done)], payloads=payloads,
                own_blocks_equal=bool(equal),
                page_migrations=router.stats()["page_migrations"],
                pages_used=[router.replica(i).pages_used for i in (0, 1)])


def _fault_run(model, faults):
    """A fleet under ``faults``; each tick's replica states and the
    fault log."""
    from rocm_apex_tpu_torch.inference import ReplicaRouter

    router = ReplicaRouter(engines=_router_engines(model), faults=faults,
                           stall_grace=2)
    for p in PROMPTS:
        router.add_request(list(p), MAX_NEW)
    done, states = {}, []
    while router.has_work():
        for r in router.step():
            done[r.request_id] = (r.tokens, r.finish_reason)
        states.append(tuple(router.replica_state(i) for i in (0, 1)))
    s = router.stats()
    return dict(tokens=[done[i] for i in sorted(done)], states=states,
                fault_log=list(router.fault_log),
                **{k: s[k] for k in ("replica_quarantines", "replica_kills",
                                     "migrations")})


def _clock_run(model, rank, router):
    """A request with a deadline of CLOCK_TIMEOUT_S; rank 1 reaches the
    step CLOCK_SKEW_S later than rank 0 (its clock, read there, is past
    the deadline; rank 0's is not). Each rank's results, its tick count
    and each tick's clock exchanges (`group_clock` calls, the engines'
    and the router's)."""
    import time

    from rocm_apex_tpu_torch.inference import engine as engine_mod
    from rocm_apex_tpu_torch.inference import router as router_mod

    calls = [0]
    real = engine_mod.group_clock

    def counted(*a):
        calls[0] += 1
        return real(*a)

    if router:
        from rocm_apex_tpu_torch.inference import ReplicaRouter

        target = ReplicaRouter(engines=_router_engines(model))
    else:
        target = _engine(model)
    target.add_request(list(PROMPTS[0]), MAX_NEW, timeout=CLOCK_TIMEOUT_S)
    target.add_request(list(PROMPTS[1]), MAX_NEW)
    if rank == 1:
        time.sleep(CLOCK_SKEW_S)
    done, ticks, exchanges = {}, 0, []
    engine_mod.group_clock = router_mod.group_clock = counted
    try:
        while target.has_work():
            calls[0] = 0
            for r in target.step():
                done[r.request_id] = (r.tokens, r.finish_reason, ticks)
            exchanges.append(calls[0])
            ticks += 1
    finally:
        engine_mod.group_clock = router_mod.group_clock = real
    return dict(results=[done[i][:2] for i in sorted(done)], ticks=ticks,
                expired_at=done[0][2], clock_exchanges=exchanges)


def _router_suite(inputs, rank, out):
    from rocm_apex_tpu_torch.inference import Fault, FaultPlan, ReplicaRouter

    model = tp2_model(inputs, rank)
    for form, kw in (("float", {}), ("int8", dict(kv_dtype=torch.int8))):
        router = ReplicaRouter(engines=_router_engines(model, **kw))
        out[f"{form}_tokens"] = _fleet_tokens(router)
        out[f"{form}_drain"] = _drain_run(model, rank, **kw)
    out["kill"] = _fault_run(model, FaultPlan([Fault(
        site="replica_kill", tick=KILL_TICK, payload={"replica": 0})],
        seed=0))
    out["stall"] = _fault_run(model, FaultPlan([Fault(
        site="replica_stall", tick=STALL_TICK,
        payload={"replica": 0, "ticks": 6})], seed=0))
    out["clock_engine"] = _clock_run(model, rank, router=False)
    out["clock_router"] = _clock_run(model, rank, router=True)
    router = ReplicaRouter(engines=_router_engines(model))
    ids = [router.add_request(list(p), MAX_NEW) for p in PROMPTS]
    out["router_trace_ids"] = [rec["trace_id"] for rec in router._pending]
    out["router_ids"] = ids


SUITES = {"layers": _layers_suite, "serve": _serve_suite,
          "train_ops": _train_ops_suite, "train": _train_suite,
          "router": _router_suite, "bert": _bert_suite,
          "remat": _remat_suite, "qcomm": _qcomm_suite}


def run(rank, n, workdir, suite):
    """One rank: init the group (a file store under ``workdir``), bind the
    tensor axis, run ``suite``, write rank<r>.pt."""
    torch.set_num_threads(1)
    out = {}
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=n, timeout=TIMEOUT)
    from rocm_apex_tpu_torch.transformer import parallel_state

    try:
        parallel_state.initialize_model_parallel(n)
        inputs = np.load(os.path.join(workdir, "inputs.npz"))
        SUITES[suite](inputs, rank, out)
    except Exception:  # noqa: BLE001 - the test reports it
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    parallel_state.destroy_model_parallel()
    dist.destroy_process_group()


def spawn(workdir, suite, inputs, n=2, join_s=120):
    """Write ``inputs``, run ``suite`` on ``n`` spawned ranks and return
    their outputs; fails on a rank that hangs, dies or raised."""
    import multiprocessing

    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, n, str(workdir), suite))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(join_s)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    assert not hung, f"ranks {hung} did not finish in {join_s} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    outs = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]
    for r, o in enumerate(outs):
        assert "error" not in o, f"rank {r}:\n{o['error']}"
    return outs
