"""The port's packed layout and multi-tensor ops against the JAX package,
on the CPU.

The layout must be the JAX one row for row (packed buffers carry across
between the packages), so the specs are compared field for field and the
buffers bit for bit. The multi-tensor ops run their plain PyTorch versions
(a wrapper takes them for CPU tensors); the JAX ops run their own CPU path.
Tolerances: elementwise results in fp32 are the same products, rounded
once: 1e-7 relative (bitwise seen). Row sums and norms add up to 1024
squares in another order: 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.multi_tensor_apply import multi_tensor_applier as japplier
from rocm_apex_tpu.multi_tensor_apply import multi_tensor_axpby as jmt_axpby
from rocm_apex_tpu.multi_tensor_apply import multi_tensor_l2norm as jmt_l2norm
from rocm_apex_tpu.multi_tensor_apply import multi_tensor_scale as jmt_scale
from rocm_apex_tpu.ops import multi_tensor as jmt
from rocm_apex_tpu.ops import packing as jpk
from rocm_apex_tpu_torch import multi_tensor_apply as tmta
from rocm_apex_tpu_torch.convert import flatten_params, random_params
from rocm_apex_tpu_torch.models.gpt import GPTConfig
from rocm_apex_tpu_torch.ops import multi_tensor as tmt
from rocm_apex_tpu_torch.ops import packing as tpk

ELEM = dict(rtol=1e-7, atol=0.0)
SUMS = dict(rtol=1e-6, atol=0.0)


def _gpt_tree(layers=12):
    """A GPT param tree with layer_10 and layer_11 (numpy fp32), and the
    dtype each leaf is packed in: LayerNorm parameters fp32, the rest
    bf16, so there are two groups."""
    cfg = GPTConfig(vocab_size=96, hidden_size=32, num_layers=layers,
                    num_attention_heads=2, max_position_embeddings=16,
                    tensor_parallel_size=1)
    flat = flatten_params(random_params(cfg, seed=3)["params"])
    dtypes = {k: ("float32" if "layernorm" in k else "bfloat16")
              for k in flat}
    return flat, dtypes


def _jax_nested(flat, dtypes):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v, dtype=dtypes[k])
    return tree


def _torch_flat(flat, dtypes):
    return {k: torch.from_numpy(np.asarray(v)).to(getattr(torch, dtypes[k]))
            for k, v in flat.items()}


def _np(x):
    return np.asarray(x, dtype=np.float32) if not torch.is_tensor(x) \
        else x.float().numpy()


def _jax_names(tree):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [".".join(p.key for p in path) for path, _ in paths]


class TestPackSpec:
    def test_gpt_spec_matches_jax_leaf_for_leaf(self):
        flat, dtypes = _gpt_tree()
        jtree = _jax_nested(flat, dtypes)
        jspec = jpk.build_pack_spec(jtree)
        spec = tpk.build_pack_spec(_torch_flat(flat, dtypes))
        assert [g.dtype for g in spec.groups] == ["bfloat16", "float32"]
        assert [g.dtype for g in jspec.groups] == ["bfloat16", "float32"]
        assert spec.n_leaves == jspec.n_leaves == len(flat)
        jnames = _jax_names(jtree)
        assert list(spec.treedef) == jnames
        for g, jg in zip(spec.groups, jspec.groups):
            assert g.rows == jg.rows and g.rows % tpk.ALIGN_ROWS == 0
            assert g.leaf_indices == jg.leaf_indices
            assert g.leaf_specs == jg.leaf_specs
        # JAX's key order, not the insertion order nor the number order
        names = list(spec.treedef)
        first = {n.split(".")[1]: i for i, n in reversed(list(
            enumerate(names))) if n.startswith("transformer.layer_")}
        assert first["layer_10"] < first["layer_11"] < first["layer_2"]

    def test_path_components_order_not_the_dotted_string(self):
        # "a-b" sorts before "a.c" as a string, after it as a path
        tree = {"a-b": torch.zeros(3), "a.c": torch.zeros(3)}
        assert tpk.build_pack_spec(tree).treedef == ("a.c", "a-b")
        jtree = {"a-b": jnp.zeros(3), "a": {"c": jnp.zeros(3)}}
        assert _jax_names(jtree) == ["a.c", "a-b"]

    def test_segment_ids_match_jax(self):
        flat, dtypes = _gpt_tree(layers=3)
        jspec = jpk.build_pack_spec(_jax_nested(flat, dtypes))
        spec = tpk.build_pack_spec(_torch_flat(flat, dtypes))
        for g, jg in zip(spec.groups, jspec.groups):
            np.testing.assert_array_equal(tpk.group_segment_ids(g),
                                          jpk.group_segment_ids(jg))

    def test_refusals(self):
        with pytest.raises(TypeError, match="floating"):
            tpk.build_pack_spec({"i": torch.zeros(3, dtype=torch.int32)})
        spec = tpk.build_pack_spec({"a": torch.zeros(3)})
        with pytest.raises(TypeError, match="pack_like"):
            tpk.pack_tree({"a": torch.zeros(3, dtype=torch.bfloat16)}, spec)
        with pytest.raises(ValueError, match="leaves"):
            tpk.pack_tree({"a": torch.zeros(3), "b": torch.zeros(1)}, spec)
        with pytest.raises(ValueError, match="packed buffer"):
            tpk.check_packed_buffer(torch.zeros(32, tpk.WIDTH))


class TestPackUnpack:
    def test_pack_bit_equal_to_jax_and_unpack_inverts(self):
        flat, dtypes = _gpt_tree(layers=11)
        jpacked = jpk.pack_tree(_jax_nested(flat, dtypes))
        tree = _torch_flat(flat, dtypes)
        packed = tpk.pack_tree(tree)
        assert len(packed.buffers) == len(jpacked.buffers) == 2
        for b, jb in zip(packed.buffers, jpacked.buffers):
            assert tpk.dtype_name(b.dtype) == jnp.dtype(jb.dtype).name
            np.testing.assert_array_equal(_np(b), _np(jb))
        back = tpk.unpack_tree(packed)
        assert list(back) == list(packed.spec.treedef)
        for k, v in tree.items():
            assert back[k].dtype == v.dtype and torch.equal(back[k], v)
            # a view of the buffer, not a copy
            assert any(back[k].untyped_storage().data_ptr()
                       == b.untyped_storage().data_ptr()
                       for b in packed.buffers)

    def test_pack_like_casts_into_the_spec_as_jax(self):
        flat, dtypes = _gpt_tree(layers=2)
        jspec = jpk.build_pack_spec(_jax_nested(flat, dtypes))
        spec = tpk.build_pack_spec(_torch_flat(flat, dtypes))
        rng = np.random.default_rng(4)
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in flat.items()}
        jp = jpk.pack_like(jspec, _jax_nested(grads, {k: "float32"
                                                      for k in grads}))
        tp = tpk.pack_like(spec, {k: torch.from_numpy(v)
                                  for k, v in grads.items()})
        for b, jb in zip(tp.buffers, jp.buffers):
            assert b.dtype in (torch.bfloat16, torch.float32)
            np.testing.assert_array_equal(_np(b), _np(jb))
        # respec: the same layout in fp32
        f32 = tpk.respec(spec, torch.float32)
        assert [g.dtype for g in f32.groups] == ["float32", "float32"]
        assert [[ls.row_start for ls in g.leaf_specs] for g in f32.groups] \
            == [[ls.row_start for ls in g.leaf_specs] for g in spec.groups]

    def test_a_list_is_a_tree_in_its_order(self):
        xs = [torch.arange(5.0), torch.ones(2, 3), torch.zeros(())]
        packed = tpk.pack_tree(xs)
        assert [ls.row_start for ls in packed.spec.groups[0].leaf_specs] \
            == [0, 1, 2]
        back = tpk.unpack_tree(packed)
        assert isinstance(back, list)
        assert all(torch.equal(a, b) for a, b in zip(back, xs))


def _ragged(seed, dtypes=("float32", "bfloat16", "float32")):
    """A ragged 3-leaf tree: a leaf of 2.5 rows, one under a row, a
    scalar; numpy fp32 values and the dtype of each."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (5, 512), "b.bias": (300,), "s": ()}
    vals = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    return vals, dict(zip(shapes, dtypes))


class TestMultiTensorOps:
    @pytest.mark.parametrize("out_dtype", [None, "float32", "bfloat16"])
    def test_scale_and_scale_sumsq_match_jax(self, out_dtype):
        vals, dts = _ragged(5)
        jp = jpk.pack_tree(_jax_nested(vals, dts))
        tp = tpk.pack_tree(_torch_flat(vals, dts))
        tdt = None if out_dtype is None else getattr(torch, out_dtype)
        jout, jinf = jmt.scale_packed(jp, 1.0 / 1024, out_dtype)
        out, inf = tmt.scale_packed(tp, 1.0 / 1024, tdt)
        assert not bool(inf) and not bool(jinf)
        for b, jb in zip(out.buffers, jout.buffers):
            assert tpk.dtype_name(b.dtype) == jnp.dtype(jb.dtype).name
            np.testing.assert_allclose(_np(b), _np(jb), **ELEM)
        jout, jinf, jrsq = jmt.scale_sumsq_packed(jp, 3.0, out_dtype)
        out, inf, rsq = tmt.scale_sumsq_packed(tp, torch.tensor(3.0), tdt)
        for b, jb in zip(out.buffers, jout.buffers):
            np.testing.assert_allclose(_np(b), _np(jb), **ELEM)
        for r, jr in zip(rsq, jrsq):
            assert r.shape == jr.shape and r.dtype == torch.float32
            np.testing.assert_allclose(_np(r), _np(jr), **SUMS)

    @pytest.mark.parametrize("bad", [float("inf"), float("nan")])
    def test_a_nonfinite_value_trips_the_flag_as_in_jax(self, bad):
        vals, dts = _ragged(6)
        vals["b.bias"][299] = bad  # the last live element of its row
        jp = jpk.pack_tree(_jax_nested(vals, dts))
        tp = tpk.pack_tree(_torch_flat(vals, dts))
        _, inf = tmt.scale_packed(tp, 0.5)
        _, jinf = jmt.scale_packed(jp, 0.5)
        assert bool(inf) and bool(jinf)
        assert inf.dtype == torch.bool and inf.shape == ()
        _, inf, _ = tmt.scale_sumsq_packed(tp, 0.5)
        assert bool(inf)
        # a finite value the scale overflows trips it too
        big = tpk.pack_tree({"x": torch.full((4,), 3e38)})
        assert bool(tmt.scale_packed(big, 4.0)[1])

    def test_axpby_matches_jax(self):
        xv, dts = _ragged(7)
        yv, _ = _ragged(8)
        out, inf = tmt.axpby(_torch_flat(xv, dts), _torch_flat(yv, dts),
                             0.5, -2.0)
        jout, jinf = jmt.axpby(_jax_nested(xv, dts), _jax_nested(yv, dts),
                               0.5, -2.0)
        assert not bool(inf) and not bool(jinf)
        jflat = dict(zip(_jax_names(jout), jax.tree_util.tree_leaves(jout)))
        for k, v in out.items():
            np.testing.assert_allclose(_np(v), _np(jflat[k]), **ELEM)
        yv["s"] = np.float32("inf")
        assert bool(tmt.axpby(_torch_flat(xv, dts), _torch_flat(yv, dts),
                              0.5, -2.0)[1])
        with pytest.raises(ValueError, match="same spec"):
            tmt.axpby_packed(tpk.pack_tree({"a": torch.zeros(3)}),
                             tpk.pack_tree({"a": torch.zeros(2000)}), 1, 1)

    def test_row_sumsq_and_l2norm_match_jax(self):
        vals, dts = _ragged(9)
        tree, jtree = _torch_flat(vals, dts), _jax_nested(vals, dts)
        for b, jb in zip(tpk.pack_tree(tree).buffers,
                         jpk.pack_tree(jtree).buffers):
            np.testing.assert_allclose(_np(tmt.row_sumsq(b)),
                                       _np(jmt.row_sumsq(jb)), **SUMS)
        norm, per = tmt.l2norm(tree, per_tensor=True)
        jnorm, jper = jmt.l2norm(jtree, per_tensor=True)
        np.testing.assert_allclose(float(norm), float(jnorm), **SUMS)
        jflat = dict(zip(_jax_names(jper), jax.tree_util.tree_leaves(jper)))
        assert set(per) == set(jflat)
        for k, v in per.items():
            np.testing.assert_allclose(float(v), float(jflat[k]), **SUMS)
        # the per-tensor norms are each leaf's own
        for k, v in tree.items():
            np.testing.assert_allclose(float(per[k]),
                                       float(v.float().norm()), **SUMS)
        assert tmt.l2norm(tree)[1] is None


class TestMultiTensorApplier:
    def test_the_three_ops_match_jax(self):
        xv, dts = _ragged(10)
        yv, _ = _ragged(11)
        xs = [torch.from_numpy(xv[k]).to(getattr(torch, dts[k])) for k in xv]
        ys = [torch.from_numpy(yv[k]).to(getattr(torch, dts[k])) for k in yv]
        jxs = [jnp.asarray(xv[k], dts[k]) for k in xv]
        jys = [jnp.asarray(yv[k], dts[k]) for k in yv]
        dst = [torch.empty(x.shape) for x in xs]  # fp32 destination
        jdst = [jnp.zeros(x.shape, jnp.float32) for x in jxs]
        out, inf = tmta.multi_tensor_applier(tmta.multi_tensor_scale, None,
                                             [xs, dst], 0.25)
        jout, jinf = japplier(jmt_scale, None, [jxs, jdst], 0.25)
        assert not bool(inf) and not bool(jinf)
        for a, b in zip(out, jout):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), **ELEM)
        out, inf = tmta.MultiTensorApply(2048)(
            tmta.multi_tensor_axpby, None, [xs, ys, None], 2.0, 3.0)
        jout, _ = japplier(jmt_axpby, None, [jxs, jys, None], 2.0, 3.0)
        for a, b in zip(out, jout):
            np.testing.assert_allclose(_np(a), _np(b), **ELEM)
        norm, per = tmta.multi_tensor_applier(tmta.multi_tensor_l2norm, None,
                                              [xs], True)
        jnorm, jper = japplier(jmt_l2norm, None, [jxs], True)
        np.testing.assert_allclose(float(norm), float(jnorm), **SUMS)
        np.testing.assert_allclose([float(x) for x in per],
                                   [float(x) for x in jper], **SUMS)
        assert tmta.available and tmta.MultiTensorApply.available
