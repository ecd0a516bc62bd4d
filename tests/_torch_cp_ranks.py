"""The ranks of tests/test_torch_context_parallel.py: one process each of
a gloo group on the CPU, spawned once per test module.

This module imports torch and the port only: a spawned rank re-imports
the module that defines its entry point, and the test module imports
JAX. Each rank reads the inputs the test wrote (numpy arrays in an .npz),
runs the port's ring and Ulysses attention and the context-parallel GPT
on its contiguous shard of the sequence, and writes what it computed to
``rank<r>.pt`` beside them.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)


def _shard(a, rank, n, dim):
    s = a.shape[dim] // n
    return a.narrow(dim, rank * s, s)


def _ring_and_ulysses(inputs, rank, n, out):
    from rocm_apex_tpu_torch.transformer.context_parallel import (
        ring_flash_attention,
        ulysses_attention,
    )

    for name, fn, seq_dim in (("ring", ring_flash_attention, 1),
                              ("ulysses", ulysses_attention, 1)):
        q, k, v, do = (torch.from_numpy(inputs[f"{name}_{x}"])
                       for x in "qkvo")
        for causal in (True, False):
            shards = [_shard(t, rank, n, seq_dim).clone().requires_grad_()
                      for t in (q, k, v)]
            o = fn(*shards, "context", causal)
            (o * _shard(do, rank, n, seq_dim)).sum().backward()
            out[f"{name}_{causal}"] = [o.detach()] + [t.grad for t in shards]
    try:
        q = torch.zeros(1, 8, 3, 4)
        ulysses_attention(q, q, q, "context")
    except ValueError as e:
        out["ulysses_refusal"] = str(e)


def _gpt(inputs, rank, n, out):
    from rocm_apex_tpu_torch.convert import from_jax_params
    from rocm_apex_tpu_torch.models.gpt import GPTConfig, hidden_dropout_seed

    shape = {k: int(v) for k, v in zip(inputs["gpt_shape_keys"],
                                       inputs["gpt_shape_vals"])}
    tree = {"params": {k[len("p."):]: inputs[k] for k in inputs.files
                       if k.startswith("p.")}}
    tree = _unflatten(tree["params"])
    base = dict(shape, hidden_dropout=0.0, attention_dropout=0.0,
                params_dtype=torch.float32, dtype=torch.float32)
    cfg = GPTConfig(**base, context_parallel_axis="context")
    model = from_jax_params({"params": tree}, cfg, device="cpu")
    tokens = torch.from_numpy(inputs["gpt_tokens"]).long()
    labels = torch.from_numpy(inputs["gpt_labels"]).long()
    t, lbl = _shard(tokens, rank, n, 1), _shard(labels, rank, n, 1)
    with torch.no_grad():
        out["gpt_logits"] = model(t)
    # the per-token losses of this shard, summed: the rank-summed
    # gradients are those of the global sum
    model(t, labels=lbl).sum().backward()
    out["gpt_grads"] = {k: p.grad for k, p in model.named_parameters()}
    # hidden dropout 0.1: one generator state on every rank, the rank
    # folded into each site's seed
    drop = from_jax_params({"params": tree}, GPTConfig(
        **{**base, "hidden_dropout": 0.1}, context_parallel_axis="context"),
        device="cpu")
    gen = torch.Generator().manual_seed(3)
    loss = drop(t, labels=lbl, deterministic=False, dropout_generator=gen,
                loss_reduction="mean")
    loss.backward()
    out["dropout_loss"] = float(loss.detach())
    out["dropout_seed"] = hidden_dropout_seed(torch.Generator().manual_seed(3),
                                              drop.cfg)
    # the JAX model's refusals, with its messages
    refusals = {}
    for name, kw in (("attention_dropout", dict(attention_dropout=0.1)),
                     ("impl", dict(attention_impl="fused_softmax"))):
        m = from_jax_params({"params": tree}, GPTConfig(
            **{**base, **kw}, context_parallel_axis="context"), device="cpu")
        try:
            m(t, deterministic=name != "attention_dropout",
              dropout_generator=torch.Generator().manual_seed(0))
        except ValueError as e:
            refusals[name] = str(e)
    out["gpt_refusals"] = refusals


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def run(rank, n, workdir):
    """One rank: init the group (a file store under ``workdir``), bind
    the "context" axis, compute, write rank<r>.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=n, timeout=TIMEOUT)
    from rocm_apex_tpu_torch.transformer import parallel_state

    parallel_state.set_axis_group("context")
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    _ring_and_ulysses(inputs, rank, n, out)
    _gpt(inputs, rank, n, out)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    parallel_state.clear_axis_groups()
    dist.destroy_process_group()
