"""The weight bridge: the JAX `GPTModel` and `BertModel` param trees into
the port's modules.

The JAX package's ``GPTModel.init`` returns ``{'params': {'embedding':
{...}, 'transformer': {'layer_0': {...}, ..., 'final_layernorm':
{...}}}}``. The port's module and parameter names follow that tree, so
each flattened path of the tree (joined with ``.``) is a `GPTModel.state_dict`
key. `from_jax_params` takes such a tree as numpy arrays (any array with
``__array__`` works) and loads it, casting each leaf to the dtype the
port keeps it in (linear and embedding weights in the compute dtype,
LayerNorm parameters in ``params_dtype``). A `BertConfig` selects
`BertModel`, whose tree adds ``tokentype_embeddings``, ``lm_head``
(``dense``, ``layernorm``) and, with the binary head, ``pooler`` and
``binary_head`` (flax ``Dense`` kernels are (in, out), as the port's).
`train_state_from_jax_params` builds the training state instead: fp32
masters from the tree and the model's parameters (all of them) in the
compute dtype; with ``opt_state`` it carries an optimizer state across
(moments and count, or a packed state's buffers), so both sides step
from the same state.

`resnet_from_jax_variables` loads a flax ResNet's ``params`` and
``batch_stats`` into a port `ResNet` of the same configuration: the
port's names are the flax paths joined with ``.``; a `Conv` kernel goes
from flax's HWIO to OIHW and the dense head's kernel from (in, out) to
(out, in); the fused blocks' flat leaves (``conv*_kernel``,
``downsample_kernel``, ``bn*_scale``/``bias``, ``bn*_mean``/``var``) and
`FoldedConvBN`'s keep the JAX layout, which the kernels take as it is.
Under ``sync_bn_axis`` every norm is a `parallel.SyncBatchNorm`, whose
``scale``, ``bias``, ``mean`` and ``var`` are the flax SyncBatchNorm's
variables of the same names. The same function loads a flax
`Bottleneck` or `SpatialBottleneck` (contrib/bottleneck, with or without
``sync_bn_axis``) into the port's block of that configuration: the
names are the flax paths, the convs HWIO -> OIHW.

`mha_from_jax_params` loads a flax `SelfMultiheadAttn` or
`EncdecMultiheadAttn`'s params (``qkv_proj``/``q_proj``/``kv_proj``/
``out_proj`` kernels and biases, ``lyr_norm`` weight and bias) into the
port module of the same options: a ``Dense`` kernel goes from (in, out)
to ``nn.Linear``'s (out, in).

`optimizer_state_from_jax` turns a JAX optimizer state (`FusedAdamState`,
`FusedSGDState`, `FusedAdagradState`, `FusedNovoGradState`,
`FusedLAMBState`, `FP16OptimizerState`) into the port's, each tree
flattened by name as `flatten_params` does, so a port step resumes from
it.

At tensor-parallel size > 1 (a `GPTConfig` or `BertConfig` whose
``tensor_parallel_size`` is 2, or the tensor group's) `from_jax_params`
and `train_state_from_jax_params` take the tp=1 tree and slice it for
this rank (`inference.shard_tp1_params`; a tree already of the rank's
shapes passes through), so each rank's `MixedPrecisionAdam` or
`MixedPrecisionLamb` state is built from its own shard. BERT's own
leaves (``tokentype_embeddings``, ``lm_head.*``, ``pooler``,
``binary_head``) are whole on every rank, as JAX's `shard_tp1_params`
leaves them. `gather_tp_params` is the inverse: the ranks' parameters,
gradients or moments, by name, back into the tp=1 layout.

`random_params` draws the same tree with numpy from a seed, with the
JAX model's initializers: normal(``init_method_std``) for the
embeddings and input projections, the output projections (attention
``dense`` and ``dense_4h_to_h``) scaled by 1/sqrt(2 * num_layers), zero
biases, LayerNorm ones and zeros; BERT's extra leaves are
normal(``init_method_std``) with zero biases. A machine without JAX
builds its weights this way.
"""

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from rocm_apex_tpu_torch.models.bert import BertConfig, BertModel
from rocm_apex_tpu_torch.models.gpt import GPTConfig, GPTModel

__all__ = [
    "from_jax_params",
    "random_params",
    "flatten_params",
    "train_state_from_jax_params",
    "resnet_from_jax_variables",
    "mha_from_jax_params",
    "optimizer_state_from_jax",
    "gather_tp_params",
]


def flatten_params(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{'a': {'b': x}}`` -> ``{'a.b': x}``."""
    flat = {}
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if isinstance(sub, dict):
            flat.update(flatten_params(sub, key + "."))
        else:
            flat[key] = sub
    return flat


def from_jax_params(
    tree: Dict[str, Any],
    cfg: GPTConfig,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[GPTModel, BertModel]:
    """Build a `GPTModel` (a `BertModel` for a `BertConfig`) on ``device``
    holding the weights of ``tree`` (the JAX model's variables dict, with
    or without its ``'params'`` level). Raises on a missing or unexpected
    leaf, or a shape mismatch."""
    cls = BertModel if isinstance(cfg, BertConfig) else GPTModel
    model = cls(cfg, device=device)
    flat = flatten_params(_rank_tree(model, tree))
    state = model.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(
            f"param tree does not match {cls.__name__}: missing {missing}, "
            f"unexpected {extra}"
        )
    with torch.no_grad():
        for key, dst in state.items():
            src = torch.tensor(np.asarray(flat[key], dtype=np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"{key}: shape {tuple(src.shape)} != {tuple(dst.shape)}"
                )
            dst.copy_(src.to(dst.dtype))
    return model


def train_state_from_jax_params(
    tree: Dict[str, Any],
    cfg: GPTConfig,
    opt,
    device: Optional[Union[str, torch.device]] = None,
    opt_state: Optional[Any] = None,
) -> Tuple[Union[GPTModel, BertModel], Any]:
    """``(model, state)`` for training from the JAX param tree: ``state =
    opt.init(fp32 leaves of the tree, model)`` (a `MixedPrecisionAdam`,
    `MixedPrecisionLamb` or `PackedOptimizerStep`), so the masters are
    the tree's values exactly and every model parameter holds its master
    cast to the optimizer's compute dtype.

    ``opt_state`` carries a JAX optimizer state across. For the
    per-parameter optimizers: ``{"m": tree, "v": tree, "count": int}``
    shaped like the params (with or without a ``'params'`` level); the
    moments land in the dtype the optimizer keeps them in. For a
    `PackedOptimizerStep`: the JAX ``PackedStepState`` (or a dict with its
    ``master``, ``m``, ``v`` and ``count``), whose packed buffers become
    the port's as they are (the two layouts are one, ops/packing.py), and
    the model's parameters are then set from those masters."""
    model = from_jax_params(tree, cfg, device=device)
    params = {
        k: torch.tensor(np.asarray(v, dtype=np.float32), device=model.device)
        for k, v in flatten_params(_rank_tree(model, tree)).items()
    }
    state = opt.init(params, model)
    if opt_state is None:
        return model, state
    if hasattr(opt_state, "_asdict"):
        opt_state = opt_state._asdict()
    if isinstance(state.master, tuple):  # packed buffers, one a group
        for name in ("master", "m", "v"):
            src, dst = opt_state[name], getattr(state, name)
            shapes = [tuple(np.shape(b)) for b in src]
            if shapes != [tuple(b.shape) for b in dst]:
                raise ValueError(
                    f"opt_state[{name!r}] has buffers {shapes}, the port's "
                    f"layout {[tuple(b.shape) for b in dst]}"
                )
            for d, b in zip(dst, src):
                d.copy_(torch.tensor(np.asarray(b, dtype=np.float32)))
        opt.write_model(state)
    else:
        for name in ("m", "v"):
            src = flatten_params(_rank_tree(model, opt_state[name]))
            dst = getattr(state, name)
            if set(src) != set(dst):
                raise KeyError(
                    f"opt_state[{name!r}] names "
                    f"{sorted(set(src) ^ set(dst))} differently from the "
                    f"params"
                )
            for k, v in src.items():
                dst[k].copy_(torch.tensor(np.asarray(v, dtype=np.float32)))
    state = state._replace(count=torch.full_like(
        state.count, int(opt_state["count"])))
    return model, state


def _rank_tree(model, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The tree's params (without the ``'params'`` level), sliced for this
    rank when ``model`` is tensor-parallel."""
    params = tree.get("params", tree)
    if getattr(model, "tp", 1) == 1:
        return params
    local = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if all(tuple(np.shape(v)) == local.get(k)
           for k, v in flatten_params(params).items()):
        return params  # already this rank's shard
    from rocm_apex_tpu_torch.inference import shard_tp1_params

    return shard_tp1_params(model, params)


def gather_tp_params(cfg: GPTConfig, shards) -> Dict[str, torch.Tensor]:
    """The tp=1 layout of the ranks' leaves: ``shards`` holds, in rank
    order, each rank's ``{name: tensor or array}`` (a `state_dict`, the
    gradients by parameter name, a moment tree flattened), ``cfg`` the
    tp>1 model's config. A leaf the tp>1 model holds whole is rank 0's;
    a sharded one is the ranks' blocks concatenated along the axis on
    which it is smaller (the inverse of `inference.shard_tp1_params`).
    Returns CPU tensors in the leaves' dtypes."""
    import dataclasses

    tp = len(shards)
    cls = BertModel if isinstance(cfg, BertConfig) else GPTModel
    full = cls(dataclasses.replace(
        cfg, tensor_parallel_size=1, sequence_parallel=False,
        collective_matmul=False), device="meta").state_dict()
    out = {}
    for key in shards[0]:
        parts = [torch.as_tensor(np.asarray(s[key]) if not isinstance(
            s[key], torch.Tensor) else s[key]).detach().cpu()
            for s in shards]
        g, l = tuple(full[key].shape), tuple(parts[0].shape)
        if g == l:
            out[key] = parts[0]
            continue
        diff = [i for i, (a, b) in enumerate(zip(g, l)) if a != b]
        if len(g) != len(l) or len(diff) != 1 or g[diff[0]] != l[diff[0]] * tp:
            raise ValueError(f"cannot map tp={tp} leaf {key} {l} onto the "
                             f"tp=1 shape {g}")
        out[key] = torch.cat(parts, dim=diff[0])
    return out


def random_params(cfg: GPTConfig, seed: int = 0) -> Dict[str, Any]:
    """A GPT (for a `BertConfig`, BERT) param tree shaped like the JAX
    model's, of float32 numpy arrays drawn from ``seed``, with the JAX
    model's initializers."""
    rng = np.random.default_rng(seed)
    h, f, nl = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    std = cfg.init_method_std
    out_std = std / np.sqrt(2.0 * nl)

    def normal(shape, s):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(s))

    def linear(n_in, n_out, s):
        return {"kernel": normal((n_in, n_out), s),
                "bias": np.zeros((n_out,), np.float32)}

    def ln():
        return {"weight": np.ones((h,), np.float32),
                "bias": np.zeros((h,), np.float32)}

    transformer = {}
    for i in range(nl):
        transformer[f"layer_{i}"] = {
            "input_layernorm": ln(),
            "self_attention": {
                "query_key_value": linear(h, 3 * h, std),
                "dense": linear(h, h, out_std),
            },
            "post_attention_layernorm": ln(),
            "mlp": {
                "dense_h_to_4h": linear(h, f, std),
                "dense_4h_to_h": linear(f, h, out_std),
            },
        }
    transformer["final_layernorm"] = ln()
    params = {
        "embedding": {
            "word_embeddings": {"weight": normal((cfg.vocab_size, h), std)},
            "position_embeddings": normal(
                (cfg.max_position_embeddings, h), std
            ),
        },
        "transformer": transformer,
    }
    if isinstance(cfg, BertConfig):
        params["tokentype_embeddings"] = normal((cfg.num_token_types, h), std)
        params["lm_head"] = {"dense": linear(h, h, std), "layernorm": ln()}
        if cfg.add_binary_head:
            params["pooler"] = linear(h, h, std)
            params["binary_head"] = linear(h, 2, std)
    return {"params": params}


def resnet_from_jax_variables(params: Dict[str, Any],
                              batch_stats: Dict[str, Any], model) -> Any:
    """Copy a flax ResNet's variables (numpy-convertible trees) into
    ``model`` (a port `ResNet` of the same configuration, or a contrib
    `Bottleneck` or `SpatialBottleneck`), in place, each
    leaf cast to the dtype the model holds it in; returns the model.
    Raises on a missing or unexpected leaf, or a shape mismatch."""
    from rocm_apex_tpu_torch.models._layers import Conv

    src = flatten_params(params)
    src.update(flatten_params(batch_stats))
    dst = dict(model.named_parameters())
    dst.update(dict(model.named_buffers()))
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"variables do not match the ResNet: missing "
                       f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for key, d in dst.items():
            a = np.asarray(src[key], dtype=np.float32)
            owner, _, leaf = key.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            if isinstance(mod, Conv) and leaf == "kernel":
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif owner == "fc" and leaf == "kernel":
                a = a.T  # (in, out) -> (out, in)
            if tuple(a.shape) != tuple(d.shape):
                raise ValueError(f"{key}: shape {a.shape} != "
                                 f"{tuple(d.shape)}")
            d.copy_(torch.tensor(a, dtype=d.dtype))
    return model


def mha_from_jax_params(tree: Dict[str, Any], module) -> Any:
    """Copy a flax multi-head attention module's params (numpy-convertible,
    with or without the ``'params'`` level) into ``module``, a port
    `SelfMultiheadAttn` or `EncdecMultiheadAttn` with the same ``bias``
    and ``include_norm_add``, in place; returns the module. Each ``kernel``
    is transposed to the (out, in) ``weight``. Raises on a missing or
    unexpected leaf, or a shape mismatch."""
    src = {}
    for key, a in flatten_params(tree.get("params", tree)).items():
        owner, _, leaf = key.rpartition(".")
        a = np.asarray(a, dtype=np.float32)
        if leaf == "kernel":
            key, a = f"{owner}.weight", a.T
        src[key] = a
    dst = dict(module.named_parameters())
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"params do not match {type(module).__name__}: "
                       f"missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for key, d in dst.items():
            if tuple(src[key].shape) != tuple(d.shape):
                raise ValueError(f"{key}: shape {src[key].shape} != "
                                 f"{tuple(d.shape)}")
            d.copy_(torch.tensor(np.ascontiguousarray(src[key]),
                                 dtype=d.dtype))
    return module


def _tensor_from_jax(a, device) -> torch.Tensor:
    """A numpy-convertible array as a tensor of its dtype (bf16 too)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def optimizer_state_from_jax(state: Any, device=None) -> Any:
    """The port's state for a JAX optimizer state: the same NamedTuple's
    fields, ``count`` an int32 scalar tensor, each tree a dict by the
    names `flatten_params` gives it (NovoGrad's per-leaf norms 0-dim
    tensors); an `FP16OptimizerState`'s inner state converted the same
    way and its scaler state a `ScalerState`. Dispatches on the type's
    name, so the JAX package is not imported."""
    from rocm_apex_tpu_torch import optimizers as o
    from rocm_apex_tpu_torch.amp.scaler import ScalerState
    from rocm_apex_tpu_torch.fp16_utils import FP16OptimizerState

    def flat(tree):
        return {k: _tensor_from_jax(v, device)
                for k, v in flatten_params(tree).items()}

    name = type(state).__name__
    if name == "FP16OptimizerState":
        return FP16OptimizerState(
            model_params=flat(state.model_params),
            master_params=flat(state.master_params),
            inner_state=optimizer_state_from_jax(state.inner_state, device),
            scaler_state=ScalerState(*(_tensor_from_jax(x, device)
                                       for x in state.scaler_state)))
    classes = {c.__name__: c for c in (
        o.FusedAdamState, o.FusedSGDState, o.FusedAdagradState,
        o.FusedNovoGradState, o.FusedLAMBState)}
    if name not in classes:
        raise TypeError(f"no port state for a JAX {name}")
    return classes[name](**{
        f: (_tensor_from_jax(v, device).to(torch.int32) if f == "count"
            else flat(v))
        for f, v in zip(state._fields, state)})
