"""The tensor-parallel seeds and the named generator streams.

Port of ``rocm_apex_tpu/transformer/tensor_parallel/random.py``. JAX
keys become explicit CPU `torch.Generator`s, and JAX's ``fold_in`` of a
rank becomes the port's counter hash (`ops._dropout.hash32`, the hash of
the dropout kernels, ``csrc/dropout.cuh``), so a seed and a rank give
one int32 seed on every machine:

* `fold_in(seed, index)`: the int32 seed of stream ``index`` under
  ``seed`` (the GPT model folds the tensor and context ranks into its
  dropout seeds with it);
* `model_parallel_prng_keys(seed, tp_rank)`: the ``"default"`` stream,
  seeded with ``seed`` (the same on every tensor rank), and the
  ``"model-parallel-rng"`` stream, seeded with ``fold_in(seed + 2718,
  tp_rank)`` (the reference's seed offsets, random.py:193-221);
* `RngStateTracker`: named streams; ``fork(name)`` yields a fresh
  generator seeded from one draw of the stream, which advances it;
  ``get_states``/``set_states`` snapshot and restore every stream;
* `model_parallel_seed` (alias `model_parallel_cuda_manual_seed`): the
  global tracker reset to those two streams.

* `checkpoint(function, *args, policy=None)`: activation checkpointing
  (JAX ``jax.checkpoint``) on non-reentrant `torch.utils.checkpoint`;
  `CheckpointPolicy` names what a policy saves.
"""

import contextlib
import functools
from typing import Callable, Dict, Optional, Union

import torch
import torch.utils.checkpoint as torch_checkpoint

from rocm_apex_tpu_torch.ops import _dropout

__all__ = [
    "RngStateTracker",
    "get_rng_tracker",
    "get_cuda_rng_tracker",
    "fold_in",
    "model_parallel_seed",
    "model_parallel_cuda_manual_seed",
    "model_parallel_prng_keys",
    "checkpoint",
    "CheckpointPolicy",
    "_MODEL_PARALLEL_RNG_TRACKER_NAME",
]

# Name of the model-parallel fork (reference random.py:110).
_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"

_SEED_MAX = 2**31 - 1


def fold_in(seed: int, index: int) -> int:
    """The int32 seed of stream ``index`` under ``seed``: the counter
    hash of (seed, index), so each rank of an axis draws its own
    masks from one seed."""
    return int(_dropout.hash32(int(seed), int(index), 0, 0)) & _SEED_MAX


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def model_parallel_prng_keys(seed: int,
                             tp_rank: int) -> Dict[str, torch.Generator]:
    """The default and model-parallel streams: ``seed`` itself (the data
    parallel seed, the same on every tensor rank), and ``seed + 2718``
    with the tensor rank folded in."""
    return {
        "default": _generator(seed),
        _MODEL_PARALLEL_RNG_TRACKER_NAME: _generator(
            fold_in(seed + 2718, tp_rank)),
    }


class RngStateTracker:
    """Named generator streams with fork semantics (the reference's
    CudaRNGStatesTracker, random.py:113-187). ``fork(name)`` yields a
    generator of its own, seeded from one draw of the named stream,
    and advances the stream. Host state only: the generators are CPU
    generators, so a fork never waits on a device."""

    def __init__(self):
        self._states: Dict[str, torch.Generator] = {}

    def reset(self):
        self._states = {}

    def get_states(self) -> Dict[str, torch.Tensor]:
        """Each stream's state (`torch.Generator.get_state`)."""
        return {k: g.get_state() for k, g in self._states.items()}

    def set_states(self, states: Dict[str, Union[torch.Tensor,
                                                 torch.Generator]]):
        """Streams from `get_states`'s states (or generators, copied)."""
        out = {}
        for name, st in states.items():
            g = torch.Generator()
            g.set_state(st.get_state() if isinstance(st, torch.Generator)
                        else st)
            out[name] = g
        self._states = out

    def add(self, name: str, seed: Union[int, torch.Generator]):
        """Register a stream (reference random.py:141-159): an int seed,
        or a generator, whose state is copied."""
        if name in self._states:
            raise RuntimeError(f"rng state {name} already exists")
        if isinstance(seed, torch.Generator):
            g = torch.Generator()
            g.set_state(seed.get_state())
        else:
            g = _generator(seed)
        self._states[name] = g

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Yield a generator drawn from the named stream and advance it
        (reference random.py:161-187)."""
        if name not in self._states:
            raise RuntimeError(f"rng state {name} is not added")
        seed = int(torch.randint(0, _SEED_MAX, (1,),
                                 generator=self._states[name]))
        yield _generator(seed)


_RNG_TRACKER = RngStateTracker()


def get_rng_tracker() -> RngStateTracker:
    """Reference: get_cuda_rng_tracker (random.py:188-190)."""
    return _RNG_TRACKER


# Reference-spelling alias so Megatron-style code ports 1:1.
get_cuda_rng_tracker = get_rng_tracker


def model_parallel_seed(seed: int, tp_rank: Optional[int] = None) -> None:
    """Initialize the global tracker (reference:
    model_parallel_cuda_manual_seed, random.py:193-221)."""
    keys = model_parallel_prng_keys(seed, 0 if tp_rank is None else tp_rank)
    _RNG_TRACKER.reset()
    for name, gen in keys.items():
        _RNG_TRACKER.add(name, gen)


model_parallel_cuda_manual_seed = model_parallel_seed

_ATEN = torch.ops.aten


class CheckpointPolicy:
    """The remat policies by JAX's names (``jax.checkpoint_policies``),
    each the set of ops whose outputs a checkpointed region keeps:
    ``NOTHING_SAVEABLE`` nothing (all recomputed), ``DOTS_SAVEABLE`` the
    products (``mm``, ``addmm``, ``bmm``), ``DOTS_WITH_NO_BATCH_DIMS``
    the products without a batch dimension (``mm``, ``addmm``)."""

    NOTHING_SAVEABLE = frozenset()
    DOTS_SAVEABLE = frozenset({_ATEN.mm.default, _ATEN.addmm.default,
                               _ATEN.bmm.default})
    DOTS_WITH_NO_BATCH_DIMS = frozenset({_ATEN.mm.default,
                                         _ATEN.addmm.default})


_POLICIES = (CheckpointPolicy.NOTHING_SAVEABLE,
             CheckpointPolicy.DOTS_SAVEABLE,
             CheckpointPolicy.DOTS_WITH_NO_BATCH_DIMS)


def _policy_fn(saved, ctx, op, *args, **kwargs):
    if op in saved:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint(function: Callable, *args,
               distribute_saved_activations: bool = False, policy=None):
    """``function(*args)``, its activations recomputed in the backward
    (reference random.py:224-293; JAX ``jax.checkpoint``): non-reentrant
    `torch.utils.checkpoint`, which restores torch's global generators
    for the recompute. A function that draws from a generator of its own
    must take its draws as arguments (the GPT model draws each layer's
    dropout seeds before the checkpointed call), as JAX's remat replays
    the same keys. ``distribute_saved_activations`` is accepted and
    ignored, as in JAX. ``policy`` (a `CheckpointPolicy` value; None
    saves nothing, as JAX's default) keeps those ops' outputs through
    `torch.utils.checkpoint.create_selective_checkpoint_contexts`. The
    port's kernels are ctypes calls inside `torch.autograd.Function`s,
    not aten ops, so they are always recomputed."""
    del distribute_saved_activations
    kw = {}
    if policy is not None:
        if policy not in _POLICIES:
            raise ValueError(f"policy must be a CheckpointPolicy value, got "
                             f"{policy!r}")
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            functools.partial(_policy_fn, policy))
    return torch_checkpoint.checkpoint(function, *args, use_reentrant=False,
                                       **kw)
