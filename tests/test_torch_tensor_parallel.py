"""The port's tensor-parallel stack against the JAX package, on the CPU.

Two ranks of a gloo group (spawned once for the module,
`_torch_tp_ranks.run`'s ``"layers"`` suite, a file store under the
test's temporary directory, 60 s timeouts) run the region mappings
forward and backward, the collective matmuls, the three layers at world
size 2 and the tp=2 GPT's chunk and decode applies on numpy-drawn
inputs. The JAX side runs the same functions inside ``shard_map`` over
two devices of the conftest's host mesh, a rank's inputs and weights
the same as the port's rank's, all in fp32.

Tolerances: the mappings move and add values (a sum of two), within
1e-6; the rings and layers are fp32 matmuls of another blocking, within
1e-5 relative; the GPT logits within 1e-5 relative to their scale (plus
1e-6), the two paths' summation orders apart. `shard_tp1_params` is held
to JAX's leaf for leaf, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_tp_ranks as R
from rocm_apex_tpu.inference import KVCache as JaxKVCache
from rocm_apex_tpu.inference import shard_tp1_params as jax_shard_tp1_params
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.ops.collective_matmul import (
    all_gather_matmul as jax_ag_mm,
    matmul_reduce_scatter as jax_mm_rs,
)
from rocm_apex_tpu.transformer.tensor_parallel import layers as jlayers
from rocm_apex_tpu.transformer.tensor_parallel import mappings as jmappings
from rocm_apex_tpu_torch.convert import flatten_params, random_params
from rocm_apex_tpu_torch.inference import shard_tp1_params
from rocm_apex_tpu_torch.models.gpt import GPTModel

TP = 2
MAP_TOL = dict(rtol=1e-6, atol=1e-6)
MM_TOL = dict(rtol=1e-5, atol=1e-5)
GPT_RTOL = 1e-5
ROWS, K, N = 24, 16, 12  # the rings' per-rank rows, contraction, columns


def _mesh():
    devs = jax.devices()
    if len(devs) < TP:
        pytest.skip(f"needs {TP} simulated devices")
    return Mesh(np.array(devs[:TP]), ("tensor",))


def _per_rank(mesh, body, *stacked):
    """``body`` on each rank's slice of the stacked (TP, ...) inputs,
    inside shard_map; returns its outputs stacked the same way."""
    def f(*xs):
        out = body(*(x[0] for x in xs))
        return jax.tree_util.tree_map(lambda t: t[None], out)

    return jax.jit(shard_map(f, mesh=mesh, in_specs=(P("tensor"),) * len(
        stacked), out_specs=P("tensor"), check_rep=False))(
        *(jnp.asarray(x) for x in stacked))


def _jax_mapping(name):
    fn, kw = R.MAPPINGS[name]
    f = getattr(jmappings, fn)
    args = ("tensor",) + tuple(kw.values())  # positional: custom_vjp
    return lambda x: f(x, *args)


def _gpt_cfg(tp, **kw):
    return JaxGPTConfig(**R.GPT_SHAPE, tensor_parallel_size=tp,
                        hidden_dropout=0.0, attention_dropout=0.0,
                        params_dtype=jnp.float32, dtype=jnp.float32, **kw)


def _inputs(mesh):
    """The ranks' inputs, and the JAX results on them."""
    rng = np.random.default_rng(0)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    inputs, want = {}, {}
    shapes = {"copy": (2, 4, 8), "reduce": (2, 4, 8), "scatter": (2, 4, 8),
              "gather": (2, 4, 4), "sp_scatter": (2, 4, 8),
              "sp_gather": (2, 2, 8), "sp_gather_rep": (2, 2, 8),
              "sp_reduce_scatter": (2, 4, 8)}
    for name, shape in shapes.items():
        x = draw(TP, *shape)
        f = _jax_mapping(name)
        y = np.asarray(_per_rank(mesh, f, x))
        c = draw(*y.shape)  # a distinct cotangent a rank

        def fwd_bwd(x, c, f=f):
            y, vjp = jax.vjp(f, x)
            return y, vjp(c)[0]

        want[f"map_{name}"] = [np.asarray(t) for t in
                               _per_rank(mesh, fwd_bwd, x, c)]
        inputs[f"map_{name}_x"], inputs[f"map_{name}_c"] = x, c

    for name, fn, rows in (("ag", jax_ag_mm, ROWS), ("rs", jax_mm_rs,
                                                     TP * ROWS)):
        x, w = draw(TP, rows, K), draw(TP, K, N)
        inputs[f"{name}_x"], inputs[f"{name}_w"] = x, w
        for chunk in R.RING_CHUNKS:
            want[f"{name}_{chunk}"] = np.asarray(_per_rank(
                mesh, lambda x, w, fn=fn, c=chunk: fn(x, w, "tensor", c),
                x, w))

    for name, (kind, kw, sharded) in R.LAYERS.items():
        if kind == "column":
            n_in, n_out = 16, 24
            kernel, bias = draw(TP, n_in, n_out // TP), draw(TP, n_out // TP)
            x = draw(TP, 4, n_in) if sharded else np.stack([draw(4, n_in)] * TP)
            layer = jlayers.ColumnParallelLinear(
                n_in, n_out, world_size=TP, axis_name="tensor", **kw)
        else:
            n_in, n_out = 24, 10
            kernel = draw(TP, n_in // TP, n_out)
            bias = np.stack([draw(n_out)] * TP)  # whole on every rank
            x = (draw(TP, 4, n_in // TP) if sharded
                 else np.stack([draw(4, n_in)] * TP))
            layer = jlayers.RowParallelLinear(
                n_in, n_out, world_size=TP, axis_name="tensor", **kw)
        inputs.update({f"layer_{name}_kernel": kernel,
                       f"layer_{name}_bias": bias, f"layer_{name}_x": x})
        want[f"layer_{name}"] = np.asarray(_per_rank(
            mesh, lambda k, b, x, layer=layer: layer.apply(
                {"params": {"kernel": k, "bias": b}}, x)[0],
            kernel, bias, x))

    vocab = jlayers.VocabParallelEmbedding(32, 8, world_size=TP,
                                           axis_name="tensor")
    w = draw(TP, 16, 8)
    ids = rng.integers(0, 32, (2, 4)).astype(np.int32)
    hidden = draw(2, 4, 8)
    inputs.update(vocab_weight=w, vocab_ids=ids, vocab_hidden=hidden)
    want["vocab_lookup"], want["vocab_attend"], want["vocab_attend_loss"] = (
        np.asarray(t) for t in (_per_rank(mesh, lambda w, i, h: (
            vocab.apply({"params": {"weight": w}}, i),
            vocab.apply({"params": {"weight": w}}, h, method="attend"),
            vocab.apply({"params": {"weight": w}}, h, i,
                        method="attend_loss")),
            w, np.stack([ids] * TP), np.stack([hidden] * TP))))
    return inputs, want


def _gpt_inputs(mesh, inputs, want):
    """The tp=1 tree, one chunk and one decode; the JAX tp=2 model's
    vocab-parallel logits (chunk on the sequence-parallel rings, decode
    plain) on weights from JAX's `shard_tp1_params`."""
    tcfg = R.gpt_config(1)
    tree = random_params(tcfg, seed=1)
    for k, v in flatten_params(tree["params"]).items():
        inputs[f"p.{k}"] = v
    S = R.ENGINE["num_slots"]
    rng = np.random.default_rng(1)
    chunk = dict(tokens=rng.integers(0, 96, 8).astype(np.int32),
                 slots=np.array([0] * 5 + [1] * 2 + [S], np.int32),
                 pos=np.array([0, 1, 2, 3, 4, 0, 1, 0], np.int32))
    dec_tokens = rng.integers(0, 96, (S, 1)).astype(np.int32)
    lengths = np.array([5, 2], np.int32)
    inputs.update({f"gpt_chunk_{k}": v for k, v in chunk.items()})
    inputs.update(gpt_decode_tokens=dec_tokens, gpt_decode_lengths=lengths)

    cfg2 = _gpt_cfg(TP)
    model2 = JaxGPTModel(cfg2)
    chunk_model = JaxGPTModel(dataclasses.replace(
        cfg2, sequence_parallel=True, collective_matmul=True))
    params2 = jax_shard_tp1_params(
        model2, jax.tree_util.tree_map(jnp.asarray, tree), mesh)

    def body(p, toks, slots, pos, lens, dtoks):
        cache = JaxKVCache.for_model(cfg2, S, R.ENGINE["capacity"],
                                     dtype=jnp.float32)
        logits, cache = chunk_model.apply(p, toks[None], cache=cache,
                                          chunk=(slots, pos))
        dlogits, _ = model2.apply(p, dtoks, cache=cache.replace(lengths=lens))
        return logits, dlogits

    vp = P(None, None, "tensor")  # the ranks' vocab columns side by side
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),) * 6,
                          out_specs=(vp, vp), check_rep=False))
    c, d = f(params2, *(jnp.asarray(chunk[k]) for k in ("tokens", "slots",
                                                         "pos")),
             jnp.asarray(lengths), jnp.asarray(dec_tokens))
    want["gpt_chunk_logits"], want["gpt_decode_logits"] = (
        np.asarray(c), np.asarray(d))
    return tree, model2, params2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    mesh = _mesh()
    inputs, want = _inputs(mesh)
    tree, jmodel2, jparams2 = _gpt_inputs(mesh, inputs, want)
    outs = R.spawn(tmp_path_factory.mktemp("tp"), "layers", inputs)
    return dict(inputs=inputs, want=want, outs=outs, tree=tree,
                jparams2=jparams2, mesh=mesh)


@pytest.mark.parametrize("name", list(R.MAPPINGS))
def test_mapping_forward_and_backward_match_jax(ranks, name):
    """Each rank's output and input gradient (for a distinct cotangent a
    rank, so a missing or doubled sum shows) against JAX's custom_vjp
    rule in shard_map."""
    want_y, want_dx = ranks["want"][f"map_{name}"]
    for r, o in enumerate(ranks["outs"]):
        y, dx = o[f"map_{name}"]
        np.testing.assert_allclose(y.numpy(), want_y[r], **MAP_TOL)
        np.testing.assert_allclose(dx.numpy(), want_dx[r], **MAP_TOL)


@pytest.mark.parametrize("chunk", R.RING_CHUNKS)
@pytest.mark.parametrize("name", ["ag", "rs"])
def test_collective_matmul_matches_jax(ranks, name, chunk):
    """The ring forward with one piece a shard, a chunk that tiles the
    shard, and one that does not (the plain collective's fallback),
    against JAX's; and the plain product on an unbound axis."""
    want = ranks["want"][f"{name}_{chunk}"]
    for r, o in enumerate(ranks["outs"]):
        np.testing.assert_allclose(o[f"{name}_{chunk}"].numpy(), want[r],
                                   **MM_TOL)
        x = torch.from_numpy(ranks["inputs"][f"{name}_x"][r])
        w = torch.from_numpy(ranks["inputs"][f"{name}_w"][r])
        np.testing.assert_allclose(o[f"{name}_unbound"].numpy(),
                                   (x @ w).numpy(), **MM_TOL)


def test_collective_matmul_refusals_name_item_10(ranks):
    """``comm_dtype="int8"`` (item 10's part 10c) runs now: each ring's
    int8 output within the int8 rounding of its fp32 output (its values
    are held to JAX's in tests/test_torch_quantized_collectives.py); the
    rings' backward runs (held to JAX's in
    tests/test_torch_tp_train_ops.py): the input gradient of the summed
    output, finite and shaped like the input."""
    for r, o in enumerate(ranks["outs"]):
        for name in ("ag", "rs"):
            dx = o[f"{name}_backward"]
            assert tuple(dx.shape) == ranks["inputs"][f"{name}_x"][r].shape
            assert torch.isfinite(dx).all()
            full, q = o[f"{name}_None"], o[f"{name}_int8"]
            assert q.shape == full.shape and q.dtype == full.dtype
            err = float((q - full).abs().max() / full.abs().max())
            assert 0.0 < err < 0.05, (name, r, err)


@pytest.mark.parametrize("name", list(R.LAYERS))
def test_layer_matches_jax_layer_in_shard_map(ranks, name):
    want = ranks["want"][f"layer_{name}"]
    for r, o in enumerate(ranks["outs"]):
        np.testing.assert_allclose(o[f"layer_{name}"].numpy(), want[r],
                                   **MM_TOL)


def test_vocab_parallel_embedding_matches_jax(ranks):
    """The masked lookup summed over the ranks, `attend`'s
    vocab-parallel logits, and the fused head at world size 2 (its
    per-row losses the same on every rank)."""
    for r, o in enumerate(ranks["outs"]):
        np.testing.assert_allclose(o["vocab_lookup"].numpy(),
                                   ranks["want"]["vocab_lookup"][r],
                                   **MM_TOL)
        np.testing.assert_allclose(o["vocab_attend"].numpy(),
                                   ranks["want"]["vocab_attend"][r],
                                   **MM_TOL)
        np.testing.assert_allclose(o["vocab_attend_loss"].detach().numpy(),
                                   ranks["want"]["vocab_attend_loss"][r],
                                   **MM_TOL)


@pytest.mark.parametrize("apply", ["chunk", "decode"])
def test_gpt_tp2_logits_match_jax_tp2_model(ranks, apply):
    """One chunk on the sequence-parallel rings, then one decode grid on
    the plain tensor-parallel model: each rank's vocab-parallel logits
    against the JAX tp=2 model's columns for that rank (shard_map over
    the same sliced weights and a per-rank cache of 2 heads)."""
    want = ranks["want"][f"gpt_{apply}_logits"]
    cols = want.shape[-1] // TP
    for r, o in enumerate(ranks["outs"]):
        got = o[f"gpt_{apply}_logits"].numpy()
        ref = want[..., r * cols:(r + 1) * cols]
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=GPT_RTOL * np.abs(ref).max() + 1e-6)
        assert o["gpt_cache_heads"] == R.GPT_SHAPE["num_attention_heads"] // TP


def test_gpt_tp2_refusals(ranks):
    """tp>1 training runs (``labels=`` gives finite per-token losses, the
    same bits on both ranks; tests/test_torch_train_tp.py holds them to
    JAX); the materialized head's label smoothing at tp>1 and a cached
    decode under sequence parallelism raise JAX's messages."""
    assert torch.equal(ranks["outs"][0]["gpt_labels"],
                       ranks["outs"][1]["gpt_labels"])
    for o in ranks["outs"]:
        assert torch.isfinite(o["gpt_labels"]).all()
        assert o["gpt_smoothing"].startswith(
            "label_smoothing/ignore_index with tp>1 require fused_lm_head")
        assert o["gpt_sp_decode"].startswith(
            "sequence_parallel composes with KV-cached inference only on "
            "the packed chunk path")


def test_shard_tp1_params_matches_jax_leaf_for_leaf(ranks):
    """Every rank's leaf of the port's `shard_tp1_params` (on a meta
    model: shapes only) equals the JAX function's shard on that rank's
    device, bit for bit; replicated leaves pass through."""
    cfg2 = R.gpt_config(TP)
    meta = GPTModel(cfg2, device="meta")
    devs = list(ranks["mesh"].devices.flat)
    jflat = flatten_params(ranks["jparams2"]["params"])
    for r in range(TP):
        got = flatten_params(shard_tp1_params(meta, ranks["tree"], r)[
            "params"])
        assert set(got) == set(jflat)
        for key, leaf in jflat.items():
            shard = next(s for s in leaf.addressable_shards
                         if s.device == devs[r])
            np.testing.assert_array_equal(got[key], np.asarray(shard.data),
                                          err_msg=key)
    with pytest.raises(ValueError, match="cannot map tp=1 leaf"):
        bad = {"params": dict(ranks["tree"]["params"])}
        bad["params"]["embedding"] = {
            **bad["params"]["embedding"],
            "position_embeddings": np.zeros((3, 3), np.float32)}
        shard_tp1_params(meta, bad, 0)
