"""The ranks of tests/test_torch_tensor_parallel.py and
tests/test_torch_serve_tp.py: one process each of a two-rank gloo group
on the CPU, spawned once per test module.

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


def tree_of(inputs):
    """The tp=1 param tree the test wrote (``p.<path>`` arrays)."""
    tree = {}
    for key in inputs.files:
        if not key.startswith("p."):
            continue
        node = tree
        *path, leaf = key[len("p."):].split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = inputs[key]
    return {"params": tree}


def gpt_config(tp, **kw):
    from rocm_apex_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(**GPT_SHAPE, tensor_parallel_size=tp, hidden_dropout=0.0,
                     attention_dropout=0.0, params_dtype=torch.float32,
                     dtype=torch.float32, **kw)


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
        try:
            fn(x.clone().requires_grad_(), w, "tensor").sum().backward()
        except NotImplementedError as e:
            out[f"{name}_backward"] = str(e)
        try:
            fn(x, w, "tensor", comm_dtype="int8")
        except NotImplementedError as e:
            out[f"{name}_int8"] = str(e)
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
    try:
        emb.attend_loss(torch.zeros(3, 8), torch.zeros(3).long())
    except NotImplementedError as e:
        out["vocab_attend_loss"] = str(e)


def _gpt(inputs, rank, out):
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
    # the refusals of the tp>1 model: training, and a cached decode
    # under sequence parallelism
    try:
        model(torch.zeros((1, 4), dtype=torch.long),
              labels=torch.zeros((1, 4), dtype=torch.long))
    except NotImplementedError as e:
        out["gpt_labels"] = str(e)
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

    try:
        ReplicaRouter(engines=[_engine(model)])
    except NotImplementedError as e:
        out["router"] = str(e)


SUITES = {"layers": _layers_suite, "serve": _serve_suite}


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
