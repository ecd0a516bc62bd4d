"""The int8 ring payloads against the JAX package, on the CPU.

`ops.quantized_collectives.quantize_int8` against JAX's on random,
all-zero, inf and nan rows, in this process: ``(q, scale)`` bit for bit.
Two ranks of a gloo group (spawned once for the module,
`_torch_tp_ranks.run`'s ``"qcomm"`` suite, 60 s timeouts) run, on
numpy-drawn inputs, the three quantized rings (`ring_reduce_scatter`,
`ring_all_gather`, `ring_all_reduce`) at both comm dtypes, with one
piece a shard, a tiling chunk and one that does not tile (the plain
collective), the all-reduce's rows that do not tile the group (the plain
sum), a gather along dim 1 and an unbound axis (the identity); the two
collective matmuls with ``comm_dtype="int8"`` forward and backward at
every chunk form; and the tp=2 GPT step (sequence parallelism, the
rings, int8 payloads, one piece a shard and pieces of 4 rows): the loss
and every gradient. The JAX side runs the same functions in
``shard_map`` over two devices of the conftest's host mesh.

Tolerances: the rings at tp=2 quantize only the inputs' own values
(one hop), so they are bit-equal to JAX's run op by op (under ``jit``
XLA turns ``amax / 127`` into a multiply by the reciprocal, one ulp off
on some rows' scales). The collective matmuls and the GPT step quantize
fp32 partial products, which the two sides sum in other orders, and JAX
runs them under ``jit``: 1e-5 relative to each tensor's largest entry
where no rounding flips; a value one ulp across a rounding boundary
moves its element by one int8 step, ``amax / 127`` of its row, so the
matmuls allow 1e-5 of the largest entry plus one step of the largest
row scale (their inputs are of order 1) on at most 1% of the elements,
and the GPT step 1e-4 relative. Measured here: the matmuls within
1.6e-7 and the GPT step within 1.3e-6, no flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_tp_ranks as R
from rocm_apex_tpu.inference import shard_tp1_params as jax_shard_tp1_params
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.ops import quantized_collectives as jqc
from rocm_apex_tpu.ops.collective_matmul import (
    all_gather_matmul as jax_ag_mm,
    matmul_reduce_scatter as jax_mm_rs,
)
from rocm_apex_tpu_torch.convert import flatten_params, random_params
from rocm_apex_tpu_torch.ops import quantized_collectives as qc

TP = 2
RTOL = 1e-5
STEP_RTOL = 1e-4
FLIP_SHARE = 0.01
ROWS, K, N = 24, 16, 12  # the matmul rings' per-rank rows, k, n
ROW_KINDS = ("random", "zero", "inf", "nan", "mixed")


def _mesh():
    devs = jax.devices()
    if len(devs) < TP:
        pytest.skip(f"needs {TP} simulated devices")
    return Mesh(np.array(devs[:TP]), ("tensor",))


def _per_rank(mesh, body, *stacked, jit=True):
    """``body`` on each rank's slice of the stacked (TP, ...) inputs in
    shard_map, its outputs stacked the same way; ``jit=False`` runs it op
    by op (jit lets XLA turn ``amax / 127`` into ``amax * (1 / 127)``,
    one ulp off the source's division on some rows)."""
    def f(*xs):
        out = body(*(x[0] for x in xs))
        return jax.tree_util.tree_map(lambda t: t[None], out)

    fn = shard_map(f, mesh=mesh, in_specs=(P("tensor"),) * len(stacked),
                   out_specs=P("tensor"), check_rep=False)
    return (jax.jit(fn) if jit else fn)(*(jnp.asarray(x) for x in stacked))


def _rows(kind):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((6, 40)).astype(np.float32) * 3
    if kind == "zero":
        x[[1, 4]] = 0.0
    elif kind == "inf":
        x[1, 3], x[2, 0], x[4] = np.inf, -np.inf, np.inf
    elif kind == "nan":
        x[0, 7], x[3] = np.nan, np.nan
    elif kind == "mixed":
        x[0], x[1, 2], x[2, 5], x[5, :3] = 0.0, np.nan, -np.inf, 1e-38
    return x


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_quantize_int8_is_bit_equal_to_jax(kind):
    """``(q, scale)`` bit for bit against JAX's: scale amax / 127 by true
    division, round half to even, a zero or non-finite row at scale 1,
    inf saturating to +-127 and nan to 0; the round trip within half a
    step of each finite row."""
    x = _rows(kind)
    q, s = qc.quantize_int8(torch.from_numpy(x))
    jq, js = jqc.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.dtype == torch.float32 and s.shape == (6, 1)
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    d = qc.dequantize_int8(q, s).numpy()
    np.testing.assert_array_equal(
        d, np.asarray(jqc.dequantize_int8(jq, js)))
    finite = np.isfinite(x).all(axis=1)
    assert np.all(np.abs(d - x)[finite] <= s.numpy()[finite] / 2 + 1e-30)


def _inputs(mesh):
    rng = np.random.default_rng(23)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    inputs, want = {}, {}
    x = draw(TP, TP * R.QROWS, R.QWIDTH)
    odd = draw(TP, R.QODD_ROWS, R.QWIDTH)
    inputs.update(q_x=x, q_odd=odd)
    for dtype in ("fp32", "int8"):
        for chunk in R.QCHUNKS:
            for op, fn in (("rs", jqc.ring_reduce_scatter),
                           ("ag", jqc.ring_all_gather),
                           ("ar", jqc.ring_all_reduce)):
                want[f"q_{op}_{dtype}_{chunk}"] = np.asarray(_per_rank(
                    mesh, lambda v, fn=fn, d=dtype, c=chunk: fn(
                        v, "tensor", comm_dtype=d, chunk=c), x, jit=False))
        want[f"q_ar_{dtype}_odd"] = np.asarray(_per_rank(
            mesh, lambda v, d=dtype: jqc.ring_all_reduce(
                v, "tensor", comm_dtype=d), odd, jit=False))
        want[f"q_ag_{dtype}_dim1"] = np.asarray(_per_rank(
            mesh, lambda v, d=dtype: jqc.ring_all_gather(
                v, "tensor", dim=1, comm_dtype=d), x, jit=False))
    for name, fn, rows, out_rows in (("ag", jax_ag_mm, ROWS, TP * ROWS),
                                     ("rs", jax_mm_rs, TP * ROWS, ROWS)):
        xm, w, c = draw(TP, rows, K), draw(TP, K, N), draw(TP, out_rows, N)
        inputs.update({f"{name}_x": xm, f"{name}_w": w, f"{name}_c": c})
        for chunk in R.RING_CHUNKS:
            def body(a, b, cot, fn=fn, ch=chunk):
                y, vjp = jax.vjp(lambda a, b: fn(a, b, "tensor", ch, "int8"),
                                 a, b)
                return (y, *vjp(cot))
            want[f"{name}_int8_{chunk}"] = tuple(
                np.asarray(t) for t in _per_rank(mesh, body, xm, w, c))
    return inputs, want


def _gpt_inputs(mesh, inputs, want):
    tree = random_params(R.gpt_config(1, init_method_std=0.3), seed=12)
    rng = np.random.default_rng(25)
    shape = (R.TRAIN_BATCH, R.TRAIN_SEQ)
    vocab = R.GPT_SHAPE["vocab_size"]
    inputs.update({f"p.{k}": v for k, v in flatten_params(
        tree["params"]).items()})
    inputs.update(
        train_tokens=rng.integers(0, vocab, shape),
        train_labels=rng.integers(0, vocab, shape),
        train_mask=(rng.random(shape) > 0.25).astype(np.float32))
    tokens, labels, mask = (jnp.asarray(inputs[f"train_{k}"]) for k in (
        "tokens", "labels", "mask"))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    for form, kw in R.INT8_FORMS.items():
        model = JaxGPTModel(JaxGPTConfig(
            **R.GPT_SHAPE, tensor_parallel_size=TP, hidden_dropout=0.0,
            attention_dropout=0.0, params_dtype=jnp.float32,
            dtype=jnp.float32, **kw))
        params = jax_shard_tp1_params(model, jtree, mesh)

        def body(p, model=model):
            loss, g = jax.value_and_grad(lambda p: model.apply(
                p, tokens, labels=labels, loss_mask=mask,
                loss_reduction="mean"))(p)
            return jax.tree_util.tree_map(lambda t: t[None], (loss, g))

        loss, grads = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(P(),), out_specs=P("tensor"),
            check_rep=False))(params)
        want[form] = (np.asarray(loss), flatten_params(
            jax.tree_util.tree_map(np.asarray, grads["params"])))


@pytest.fixture(scope="module")
def qcomm(tmp_path_factory):
    mesh = _mesh()
    inputs, want = _inputs(mesh)
    _gpt_inputs(mesh, inputs, want)
    outs = R.spawn(tmp_path_factory.mktemp("qcomm"), "qcomm", inputs)
    return dict(inputs=inputs, want=want, outs=outs)


@pytest.mark.parametrize("dtype", ("fp32", "int8"))
@pytest.mark.parametrize("chunk", R.QCHUNKS)
@pytest.mark.parametrize("op", ("rs", "ag", "ar"))
def test_quantized_rings_are_bit_equal_to_jax(qcomm, op, dtype, chunk):
    """Each ring against JAX's on each rank, bit for bit: one piece a
    shard, a tiling chunk, and a chunk that does not tile (the plain
    collective, full precision at either comm dtype); the int8 gather
    the same bits on both ranks."""
    key = f"q_{op}_{dtype}_{chunk}"
    for r, o in enumerate(qcomm["outs"]):
        np.testing.assert_array_equal(o[key].numpy(), qcomm["want"][key][r],
                                      err_msg=key)
    if op != "rs":
        assert torch.equal(qcomm["outs"][0][key], qcomm["outs"][1][key])


@pytest.mark.parametrize("dtype", ("fp32", "int8"))
def test_quantized_ring_fallbacks_as_jax(qcomm, dtype):
    """The all-reduce of rows that do not tile the group is the plain sum,
    the gather along dim 1 rings over columns, an unbound axis is the
    identity; a non-tiling chunk gives the plain collective's bits, the
    same at both comm dtypes; the int8 rings move at most one int8 step
    of their row scales from the fp32 ones."""
    x = qcomm["inputs"]["q_x"]
    for r, o in enumerate(qcomm["outs"]):
        for key in (f"q_ar_{dtype}_odd", f"q_ag_{dtype}_dim1"):
            np.testing.assert_array_equal(o[key].numpy(),
                                          qcomm["want"][key][r], err_msg=key)
        np.testing.assert_array_equal(o[f"q_rs_{dtype}_unbound"].numpy(),
                                      x[r])
        for op in ("rs", "ag", "ar"):
            assert torch.equal(o[f"q_{op}_{dtype}_5"], o[f"q_{op}_fp32_5"])
    np.testing.assert_allclose(qcomm["outs"][0][f"q_ar_{dtype}_odd"].numpy(),
                               qcomm["inputs"]["q_odd"].sum(0), rtol=1e-6,
                               atol=1e-6)
    step = np.abs(x).max() * TP / 127
    for o in qcomm["outs"]:
        for op in ("rs", "ag", "ar"):
            d = o[f"q_{op}_int8_None"] - o[f"q_{op}_fp32_None"]
            assert float(d.abs().max()) <= 2 * step


def test_an_int8_hop_is_one_exchange(qcomm):
    """An int8 gather ring at tp=2 makes one exchange: the hop's scale
    column and int8 body in one uint8 buffer (4 bytes a row, then the
    row's bytes), where JAX sends two ppermutes."""
    rows, width = TP * R.QROWS, R.QWIDTH
    for o in qcomm["outs"]:
        assert o["q_hop_exchanges"] == [
            ("shift", torch.uint8, rows * width + 4 * rows)]


def _int8_mm_close(got, want, what):
    """1e-5 of the largest entry, plus one int8 step of a row scale (of
    order max / 127) on at most FLIP_SHARE of the elements."""
    got = got.detach().numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= RTOL * scale + scale / 127, what
    assert (err > RTOL * scale).mean() <= FLIP_SHARE, what


@pytest.mark.parametrize("chunk", R.RING_CHUNKS)
@pytest.mark.parametrize("name", ("ag", "rs"))
def test_int8_collective_matmul_matches_jax(qcomm, name, chunk):
    """``comm_dtype="int8"``: the output, dx and dW of each ring against
    JAX's custom_vjp at the same comm dtype, one piece a shard, a tiling
    chunk and the plain fallback (full precision)."""
    want = qcomm["want"][f"{name}_int8_{chunk}"]
    for r, o in enumerate(qcomm["outs"]):
        for got, ref, what in zip(o[f"{name}_int8_{chunk}"],
                                  (w[r] for w in want), ("y", "dx", "dw")):
            _int8_mm_close(got, ref, f"{name} {chunk} {r} {what}")


@pytest.mark.parametrize("form", list(R.INT8_FORMS))
def test_int8_gpt_step_matches_jax_tp2(qcomm, form):
    """The tp=2 GPT step with sequence parallelism and int8 rings: each
    rank's loss and every gradient shard against JAX's in shard_map
    (STEP_RTOL); both ranks' losses bit-equal."""
    jloss, jgrads = qcomm["want"][form]
    outs = [o[form] for o in qcomm["outs"]]
    assert torch.equal(outs[0][0], outs[1][0])
    for r, (loss, grads) in enumerate(outs):
        np.testing.assert_allclose(float(loss), jloss[r], rtol=STEP_RTOL)
        assert set(grads) == set(jgrads)
        for k, g in grads.items():
            err = np.abs(g.numpy() - jgrads[k][r]).max() / (
                np.abs(jgrads[k][r]).max() + 1e-30)
            assert err < STEP_RTOL, (form, r, k, err)
