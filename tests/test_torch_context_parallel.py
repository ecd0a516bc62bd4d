"""The port's context parallelism against the JAX package, on the CPU.

Four ranks of a gloo group (spawned once for the module,
`_torch_cp_ranks.run`, with a file-store rendezvous under the test's
temporary directory and 60 s timeouts) run `ring_flash_attention`,
`ulysses_attention` and the GPT under ``context_parallel_axis`` on their
contiguous shards of numpy-drawn inputs. The JAX side runs its ring and
Ulysses attention and its context-parallel GPT inside ``shard_map`` on
four devices of the conftest's host mesh (its Pallas flash kernels in
interpret mode), as tests/L0/test_context_parallel.py does, on the same
inputs and weights. Both compute in fp32: outputs agree within JAX's
2e-4 there, gradients within its 2e-3, logits within its 2e-3. The
rank-summed parameter gradients are held against the port's unsharded
model on the gathered sequence (1e-4 relative to each gradient's
largest element, summation order only).
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_cp_ranks
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.ops.flash_attention import flash_attention as jflash
from rocm_apex_tpu.transformer.context_parallel import (
    ring_flash_attention as jring,
    ulysses_attention as julysses,
)
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig

CP = 4
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)
# tests/L0/test_context_parallel.py's GPT
GPT_SHAPE = dict(vocab_size=128, hidden_size=64, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=512,
                 tensor_parallel_size=1)
GPT_SEQ, GPT_BATCH = 512, 2
JOIN_S = 120


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, shape in (("ring", (2, 512, 64)), ("ulysses", (2, 512, 4, 64))):
        for x in "qkvo":
            out[f"{name}_{x}"] = rng.standard_normal(shape).astype(np.float32)
    cfg = GPTConfig(**GPT_SHAPE, hidden_dropout=0.0, attention_dropout=0.0,
                    params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(cfg, seed=1)
    for k, v in flatten_params(tree["params"]).items():
        out[f"p.{k}"] = v
    tokens = rng.integers(0, GPT_SHAPE["vocab_size"],
                          (GPT_BATCH, GPT_SEQ)).astype(np.int32)
    out.update(gpt_tokens=tokens, gpt_labels=np.roll(tokens, -1, 1),
               gpt_shape_keys=np.array(list(GPT_SHAPE)),
               gpt_shape_vals=np.array(list(GPT_SHAPE.values())))
    return out, tree


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the four ranks once; returns (inputs, tree, per-rank
    outputs)."""
    workdir = tmp_path_factory.mktemp("cp")
    inputs, tree = _inputs()
    np.savez(workdir / "inputs.npz", **inputs)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_torch_cp_ranks.run,
                         args=(r, CP, str(workdir))) for r in range(CP)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    assert not hung, f"ranks {hung} did not finish in {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    outs = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(CP)]
    return inputs, tree, outs


def _mesh(devs):
    return Mesh(np.array(devs[:CP]), ("context",))


def _jax_attention(fn, mesh, q, k, v, do, causal):
    f = jax.jit(shard_map(lambda q, k, v: fn(q, k, v, "context", causal),
                          mesh=mesh, in_specs=(P(None, "context"),) * 3,
                          out_specs=P(None, "context"), check_rep=False))

    def loss(q, k, v):
        o = f(q, k, v)
        return (o * do).sum(), o

    (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                   has_aux=True)(q, k, v)
    return [np.asarray(o)] + [np.asarray(t) for t in g]


def _gathered(outs, key):
    return [torch.cat([o[key][i] for o in outs], dim=1).numpy()
            for i in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_attention_and_gradients_match_jax(ranks, eight_devices, kind,
                                           causal):
    """Forward and the q/k/v gradients of sum(o * do), gathered over the
    ranks, against JAX's on the host mesh and against the port's
    unsharded flash attention."""
    inputs, _, outs = ranks
    q, k, v, do = (jnp.asarray(inputs[f"{kind}_{x}"]) for x in "qkvo")
    fn = jring if kind == "ring" else julysses
    want = _jax_attention(fn, _mesh(eight_devices), q, k, v, do, causal)
    got = _gathered(outs, f"{kind}_{causal}")
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    # the unsharded flash attention on the gathered sequence
    if kind == "ring":
        ref = jflash(q, k, v, None, causal)
    else:
        b, s, h, d = q.shape

        def flat(t):
            return t.transpose(0, 2, 1, 3).reshape(b * h, s, d)

        ref = jflash(flat(q), flat(k), flat(v), None, causal).reshape(
            b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got[0], np.asarray(ref), **FWD_TOL)


def test_ulysses_refuses_heads_the_group_does_not_divide(ranks):
    assert all("not divisible by axis size 4" in o["ulysses_refusal"]
               for o in ranks[2])


def test_gpt_logits_match_jax_context_parallel_gpt(ranks, eight_devices):
    """tests/L0/test_context_parallel.py's GPT on the context mesh: the
    port's shards' logits, gathered, against JAX's (ring attention,
    offset positions)."""
    inputs, tree, outs = ranks
    base = dict(GPT_SHAPE, hidden_dropout=0.0, attention_dropout=0.0,
                params_dtype=jnp.float32, dtype=jnp.float32)
    jmodel = JaxGPTModel(JaxGPTConfig(**base, context_parallel_axis="context"))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    f = jax.jit(shard_map(lambda p, t: jmodel.apply(p, t),
                          mesh=_mesh(eight_devices),
                          in_specs=(P(), P(None, "context")),
                          out_specs=P(None, "context"), check_rep=False))
    want = np.asarray(f(params, jnp.asarray(inputs["gpt_tokens"])))
    got = torch.cat([o["gpt_logits"] for o in outs], dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_gpt_rank_summed_gradients_match_the_unsharded_model(ranks):
    """The per-token losses summed on each shard: the parameter gradients
    summed over the ranks (the caller's all-reduce) equal the unsharded
    model's of the global sum; the logits equal its too."""
    inputs, tree, outs = ranks
    cfg = GPTConfig(**GPT_SHAPE, hidden_dropout=0.0, attention_dropout=0.0,
                    params_dtype=torch.float32, dtype=torch.float32)
    model = from_jax_params(tree, cfg, device="cpu")
    tokens = torch.from_numpy(inputs["gpt_tokens"]).long()
    labels = torch.from_numpy(inputs["gpt_labels"]).long()
    with torch.no_grad():
        logits = model(tokens)
    got = torch.cat([o["gpt_logits"] for o in outs], dim=1)
    np.testing.assert_allclose(got.numpy(), logits.numpy(), rtol=1e-4,
                               atol=1e-4)
    model(tokens, labels=labels).sum().backward()
    for name, p in model.named_parameters():
        summed = sum(o["gpt_grads"][name] for o in outs)
        scale = float(p.grad.abs().max()) or 1.0
        np.testing.assert_allclose(summed.numpy(), p.grad.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_gpt_hidden_dropout_folds_the_rank(ranks):
    """One step at hidden dropout 0.1 from one generator state on every
    rank: finite losses, and every rank's first site seed differs."""
    outs = ranks[2]
    assert all(np.isfinite(o["dropout_loss"]) for o in outs)
    assert len({o["dropout_seed"] for o in outs}) == CP


def test_gpt_keeps_the_jax_refusals(ranks):
    """Attention dropout in training and an attention_impl other than
    flash raise the JAX model's ValueError; the sequence-parallel
    collision raises at construction."""
    for o in ranks[2]:
        r = o["gpt_refusals"]
        assert set(r) == {"attention_dropout", "impl"}
        for msg in r.values():
            assert msg.startswith(
                "context_parallel_axis requires attention_impl='flash', "
                "causal masking, and attention_dropout=0 in training")
    with pytest.raises(ValueError, match="collide on the sequence"):
        GPTConfig(context_parallel_axis="context", sequence_parallel=True)
