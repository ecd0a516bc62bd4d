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

Activation checkpointing (`checkpoint`, `CheckpointPolicy`) is ROADMAP
Queue 1 item 10, part 10b, and raises.
"""

import contextlib
from typing import Dict, Optional, Union

import torch

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

_CHECKPOINT = ("activation checkpointing ({what}) is not ported yet (ROADMAP "
               "Queue 1 item 10, part 10b)")


class _CheckpointPolicy:
    """The JAX remat policies' names; reading one raises (part 10b)."""

    def __getattr__(self, name):
        raise NotImplementedError(_CHECKPOINT.format(
            what=f"CheckpointPolicy.{name}"))


CheckpointPolicy = _CheckpointPolicy()


def checkpoint(function, *args, distribute_saved_activations: bool = False,
               policy=None):
    """Refused: activation checkpointing is ROADMAP Queue 1 item 10,
    part 10b."""
    raise NotImplementedError(_CHECKPOINT.format(what="checkpoint"))
