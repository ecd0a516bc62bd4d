"""The tensor-parallel training ops against the JAX package, on the CPU.

Two ranks of a gloo group (spawned once for the module,
`_torch_tp_ranks.run`'s ``"train_ops"`` suite, 60 s timeouts) run, on
numpy-drawn inputs, the backward of both collective matmuls at every
chunk form, `vocab_parallel_cross_entropy` and
`vocab_parallel_linear_cross_entropy` forward and backward (the latter
with label smoothing, ``padding_idx`` and several row chunks), a
`MixedFusedLayerNorm` with ``grad_sync_axis``, `broadcast_data` and the
streams of `model_parallel_prng_keys`. The JAX side runs the same
functions inside ``shard_map`` over two devices of the conftest's host
mesh, a rank's inputs the same as the port's rank's, all in fp32, each
gradient JAX's ``custom_vjp`` rule for a distinct cotangent a rank (so
a missing or doubled sum shows). The seeds' tracker, the memory buffers
and the refusals run in this process.

Tolerances: the rings and heads are fp32 matmuls and reductions of
another blocking, within 1e-5 relative (rtol and atol 1e-5); the
LayerNorm gradients within 1e-5; `broadcast_data` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_tp_ranks as R
from rocm_apex_tpu.normalization.fused_layer_norm import (
    MixedFusedLayerNorm as JaxLN,
)
from rocm_apex_tpu.ops.collective_matmul import (
    all_gather_matmul as jax_ag_mm,
    matmul_reduce_scatter as jax_mm_rs,
)
from rocm_apex_tpu.ops.linear_xentropy import (
    vocab_parallel_linear_cross_entropy as jax_vp_lce,
)
from rocm_apex_tpu.transformer.tensor_parallel import memory as jmemory
from rocm_apex_tpu.transformer.tensor_parallel import random as jrandom
from rocm_apex_tpu.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jax_vp_ce,
)
from rocm_apex_tpu.transformer.tensor_parallel.data import (
    broadcast_data as jax_broadcast_data,
)
from rocm_apex_tpu_torch.transformer.tensor_parallel import memory as tmemory
from rocm_apex_tpu_torch.transformer.tensor_parallel import random as trandom

TP = 2
TOL = dict(rtol=1e-5, atol=1e-5)
ROWS, K, N = 24, 16, 12  # the rings' per-rank rows, contraction, columns
CE_ROWS, CE_VOCAB = 6, 24
LCE_ROWS, LCE_HIDDEN, LCE_VOCAB = 20, 16, 24
LN_ROWS, LN_HIDDEN = 6, 16


def _mesh():
    devs = jax.devices()
    if len(devs) < TP:
        pytest.skip(f"needs {TP} simulated devices")
    return Mesh(np.array(devs[:TP]), ("tensor",))


def _per_rank(mesh, body, *stacked):
    """``body`` on each rank's slice of the stacked (TP, ...) inputs,
    inside shard_map; its outputs stacked the same way."""
    def f(*xs):
        out = body(*(x[0] for x in xs))
        return jax.tree_util.tree_map(lambda t: t[None], out)

    return jax.jit(shard_map(f, mesh=mesh, in_specs=(P("tensor"),) * len(
        stacked), out_specs=P("tensor"), check_rep=False))(
        *(jnp.asarray(x) for x in stacked))


def _vjp(fn, n_args):
    """(y, the vjp of the first ``n_args`` inputs for the cotangent
    passed last); the inputs between are held fixed."""
    def body(*xs):
        fixed = xs[n_args:-1]
        y, vjp = jax.vjp(lambda *d: fn(*d, *fixed), *xs[:n_args])
        return y, vjp(xs[-1])
    return body


def _inputs(mesh):
    rng = np.random.default_rng(5)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    inputs, want = {}, {}
    for name, fn, rows, out_rows in (("ag", jax_ag_mm, ROWS, TP * ROWS),
                                     ("rs", jax_mm_rs, TP * ROWS, ROWS)):
        x, w, c = draw(TP, rows, K), draw(TP, K, N), draw(TP, out_rows, N)
        inputs.update({f"{name}_x": x, f"{name}_w": w, f"{name}_c": c})
        for chunk in R.RING_CHUNKS:
            want[f"{name}_bwd_{chunk}"] = _per_rank(mesh, _vjp(
                lambda x, w, fn=fn, ch=chunk: fn(x, w, "tensor", ch), 2),
                x, w, c)[1]

    logits = draw(TP, CE_ROWS, CE_VOCAB // TP) * 3
    target = rng.integers(0, CE_VOCAB, CE_ROWS)
    cot = draw(CE_ROWS)
    inputs.update(ce_logits=logits, ce_target=target, ce_cot=cot)
    want["ce"] = _per_rank(mesh, _vjp(
        lambda lg, t: jax_vp_ce(lg, t, "tensor"), 1),
        logits, np.stack([target] * TP), np.stack([cot] * TP))
    want["ce"] = (want["ce"][0], want["ce"][1][0])

    hidden = draw(LCE_ROWS, LCE_HIDDEN)
    weight = draw(TP, LCE_VOCAB // TP, LCE_HIDDEN) * 0.5
    labels = rng.integers(0, LCE_VOCAB, LCE_ROWS)
    labels[[2, 9, 15]] = 3  # padding_idx rows of the padded forms
    lcot = draw(LCE_ROWS)
    inputs.update(lce_hidden=hidden, lce_weight=weight, lce_labels=labels,
                  lce_cot=lcot)
    for form, (smoothing, pad, chunk) in R.HEAD_FORMS.items():
        y, (dh, dw) = _per_rank(mesh, _vjp(
            lambda h, w, lb, s=smoothing, p=pad, c=chunk: jax_vp_lce(
                h, w, lb, "tensor", s, p, c), 2),
            np.stack([hidden] * TP), weight, np.stack([labels] * TP),
            np.stack([lcot] * TP))
        want[f"lce_{form}"] = (y, dh, dw)

    x, c = draw(TP, LN_ROWS, LN_HIDDEN), draw(TP, LN_ROWS, LN_HIDDEN)
    lw, lb = draw(LN_HIDDEN) * 0.5 + 1.0, draw(LN_HIDDEN) * 0.1
    inputs.update(ln_x=x, ln_c=c, ln_w=lw, ln_b=lb)
    ln = JaxLN(LN_HIDDEN, grad_sync_axis="tensor")

    def ln_body(x, w, b, c):
        y, vjp = jax.vjp(lambda x, w, b: ln.apply(
            {"params": {"weight": w, "bias": b}}, x), x, w, b)
        return vjp(c)

    want["ln"] = _per_rank(mesh, ln_body, x, np.stack([lw] * TP),
                           np.stack([lb] * TP), c)

    bd = {k: rng.integers(0, 100, (TP, 2, 5)) for k in ("tokens", "labels")}
    inputs.update({f"bd_{k}": v for k, v in bd.items()})
    want["broadcast"] = _per_rank(
        mesh, lambda t, lb: jax_broadcast_data(
            ["tokens", "labels"], {"tokens": t, "labels": lb}, t.dtype,
            "tensor"), bd["tokens"], bd["labels"])
    return inputs, want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    mesh = _mesh()
    inputs, want = _inputs(mesh)
    outs = R.spawn(tmp_path_factory.mktemp("tp_train_ops"), "train_ops",
                   inputs)
    return dict(inputs=inputs, want=want, outs=outs)


@pytest.mark.parametrize("chunk", R.RING_CHUNKS)
@pytest.mark.parametrize("name", ["ag", "rs"])
def test_collective_matmul_backward_matches_jax(ranks, name, chunk):
    """dx and dW of each ring (one piece a shard, a tiling chunk, and a
    chunk that does not tile: the plain transposed collectives) against
    JAX's custom_vjp rule for the rank's cotangent."""
    want_dx, want_dw = ranks["want"][f"{name}_bwd_{chunk}"]
    for r, o in enumerate(ranks["outs"]):
        dx, dw = o[f"{name}_bwd_{chunk}"]
        np.testing.assert_allclose(dx.numpy(), want_dx[r], **TOL)
        np.testing.assert_allclose(dw.numpy(), want_dw[r], **TOL)


def test_vocab_parallel_cross_entropy_matches_jax(ranks):
    """The per-token losses (the same on both ranks) and each rank's
    logits gradient against JAX's."""
    want_y, want_dl = ranks["want"]["ce"]
    for r, o in enumerate(ranks["outs"]):
        loss, dlogits = o["ce"]
        np.testing.assert_allclose(loss.numpy(), want_y[r], **TOL)
        np.testing.assert_allclose(dlogits.numpy(), want_dl[r], **TOL)
    assert torch.equal(ranks["outs"][0]["ce"][0], ranks["outs"][1]["ce"][0])


@pytest.mark.parametrize("form", list(R.HEAD_FORMS))
def test_vocab_parallel_linear_cross_entropy_matches_jax(ranks, form):
    """The fused head over each rank's vocabulary block, with and without
    smoothing and ``padding_idx`` and over one or several row chunks:
    the losses, the hidden gradient (summed over the ranks inside: the
    same on both) and each rank's weight gradient."""
    want_y, want_dh, want_dw = ranks["want"][f"lce_{form}"]
    for r, o in enumerate(ranks["outs"]):
        loss, dh, dw = o[f"lce_{form}"]
        np.testing.assert_allclose(loss.numpy(), want_y[r], **TOL)
        np.testing.assert_allclose(dh.numpy(), want_dh[r], **TOL)
        np.testing.assert_allclose(dw.numpy(), want_dw[r], **TOL)
    smoothing, pad, _ = R.HEAD_FORMS[form]
    if pad is not None:
        rows = ranks["inputs"]["lce_labels"] == pad
        for o in ranks["outs"]:
            assert torch.all(o[f"lce_{form}"][0][rows] == 0)
            assert torch.all(o[f"lce_{form}"][1][rows] == 0)


def test_grad_sync_axis_sums_the_parameter_gradients(ranks):
    """A LayerNorm over each rank's rows: the input gradient is the
    rank's own, the weight and bias gradients the sum over the ranks
    (the same on both), as JAX's `_psum_grad`."""
    want_dx, want_dw, want_db = ranks["want"]["ln"]
    for r, o in enumerate(ranks["outs"]):
        dx, dw, db = o["ln"]
        np.testing.assert_allclose(dx.numpy(), want_dx[r], **TOL)
        np.testing.assert_allclose(dw.numpy(), want_dw[r], **TOL)
        np.testing.assert_allclose(db.numpy(), want_db[r], **TOL)
    assert torch.equal(ranks["outs"][0]["ln"][1], ranks["outs"][1]["ln"][1])


def test_broadcast_data_is_rank_0s_batch(ranks):
    want = ranks["want"]["broadcast"]
    for r, o in enumerate(ranks["outs"]):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(o["broadcast"][k].numpy(),
                                          want[k][r])
            np.testing.assert_array_equal(
                o["broadcast"][k].numpy(), ranks["inputs"][f"bd_{k}"][0])
        assert o["broadcast_dtype"] == (
            "tokens has data type torch.int32 which is different than "
            "torch.int64")


def test_model_parallel_streams_fold_the_rank(ranks):
    """`model_parallel_prng_keys`: the default stream is the same on
    both ranks, the model-parallel stream differs."""
    a, b = (o["prng"] for o in ranks["outs"])
    assert a["default"] == b["default"]
    assert a[trandom._MODEL_PARALLEL_RNG_TRACKER_NAME] != \
        b[trandom._MODEL_PARALLEL_RNG_TRACKER_NAME]


def _draws(gen, n=4):
    return torch.randint(0, 2**31 - 1, (n,), generator=gen).tolist()


def test_rng_tracker_forks_advance_and_replay():
    """JAX's tracker semantics on generators: a fork yields a stream of
    its own and advances the named one; `set_states` replays forks bit
    for bit; JAX's error messages for a duplicate or unknown name."""
    tracker = trandom.RngStateTracker()
    tracker.add("a", 5)
    snap = tracker.get_states()
    with tracker.fork("a") as g1:
        first = _draws(g1)
    with tracker.fork("a") as g2:
        second = _draws(g2)
    assert first != second
    tracker.set_states(snap)
    with tracker.fork("a") as g3:
        assert _draws(g3) == first
    jtracker = jrandom.RngStateTracker()
    jtracker.add("a", 5)
    for t in (tracker, jtracker):
        with pytest.raises(RuntimeError) as e:
            t.add("a", 1)
        msgs = [str(e.value)]
        with pytest.raises(RuntimeError) as e:
            with t.fork("b"):
                pass
        msgs.append(str(e.value))
        if t is tracker:
            port = msgs
    assert port == msgs == ["rng state a already exists",
                            "rng state b is not added"]
    trandom.model_parallel_seed(9, tp_rank=1)
    names = set(trandom.get_rng_tracker().get_states())
    jrandom.model_parallel_seed(9, tp_rank=1)
    assert names == set(jrandom.get_rng_tracker().get_states())


def test_fold_in_is_the_dropout_hash():
    """`fold_in` is the counter hash the GPT model's dropout seeds fold
    ranks with: distinct per index, int32, deterministic."""
    seeds = [trandom.fold_in(1234, i) for i in range(4)]
    assert len(set(seeds)) == 4
    assert all(0 <= s < 2**31 for s in seeds)
    assert seeds == [trandom.fold_in(1234, i) for i in range(4)]


def test_checkpoint_is_refused_naming_10b():
    """Activation checkpointing (part 10b) runs now: ``checkpoint`` returns
    the function's value and its gradient, ``distribute_saved_activations``
    accepted and ignored as in JAX; the policies name the products they
    save (tests/test_torch_remat.py holds them to ``jax.checkpoint``)."""
    x = torch.arange(3.0, requires_grad=True)
    y = trandom.checkpoint(lambda t: (t * t).sum(), x,
                           distribute_saved_activations=True)
    y.backward()
    assert float(y) == 5.0
    assert torch.equal(x.grad, 2 * x.detach())
    aten = torch.ops.aten
    assert trandom.CheckpointPolicy.DOTS_SAVEABLE == {
        aten.mm.default, aten.addmm.default, aten.bmm.default}
    assert not trandom.CheckpointPolicy.NOTHING_SAVEABLE


def test_memory_buffers_match_jax():
    """Bump allocation in order, views of the buffer, JAX's out-of-space
    and in-use messages, and the ring's rotation."""
    buf = tmemory.allocate_mem_buff("b", 10, torch.float32)
    jbuf = jmemory.allocate_mem_buff("b", 10, jnp.float32)
    for shape in ((2, 3), (4,)):
        v, jv = buf.add(shape), jbuf.add(shape)
        assert tuple(v.shape) == tuple(jv.shape)
    assert buf.numel_in_use() == jbuf.numel_in_use() == 10
    v.fill_(7.0)
    assert torch.all(buf.get_data()[6:] == 7.0)  # a view, not a copy
    msgs = []
    for b in (buf, jbuf):
        with pytest.raises(RuntimeError) as e:
            b.add((1,))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    buf.reset()
    assert not buf.is_in_use()
    ring = tmemory.RingMemBuffer("r", 2, 4, torch.float32)
    jring = jmemory.RingMemBuffer("r", 2, 4, jnp.float32)
    for r in (ring, jring):
        r.get_next_buffer().add((2,))
        r.get_next_buffer()
    for r in (ring, jring):
        with pytest.raises(RuntimeError, match="already in use"):
            r.get_next_buffer()
