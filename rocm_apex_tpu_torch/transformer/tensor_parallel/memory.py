"""Reusable flat memory buffers.

Port of ``rocm_apex_tpu/transformer/tensor_parallel/memory.py``
(`MemoryBuffer`, `RingMemBuffer`, `allocate_mem_buff`, the reference's
memory.py:24-136): one preallocated 1-D tensor handing out views by
bump allocation. In JAX ``add`` returns a reshaped slice of one array;
here it is a zero-copy view of the buffer, as in the reference.
"""

from typing import Optional, Tuple, Union

import math

import torch

__all__ = ["MemoryBuffer", "RingMemBuffer", "allocate_mem_buff"]

Device = Optional[Union[str, torch.device]]


class MemoryBuffer:
    """Contiguous pre-sized buffer with bump allocation (reference
    memory.py:34-118), zeroed, on ``device`` (default the CPU)."""

    def __init__(self, name: str, numel: int, dtype, track_usage: bool = False,
                 device: Device = None):
        self.name = name
        self.numel = numel
        self.dtype = dtype
        self.data = torch.zeros((numel,), dtype=dtype, device=device)
        self._start = 0
        self.track_usage = track_usage
        self.in_use_value = 0.0
        self.total_value = 0.0

    def reset(self):
        self._start = 0

    def is_in_use(self) -> bool:
        return self._start > 0

    def numel_in_use(self) -> int:
        return self._start

    def add(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """Bump-allocate a view of ``shape`` (reference memory.py:77-93)."""
        numel = math.prod(shape)
        if self._start + numel > self.numel:
            raise RuntimeError(
                f"MemoryBuffer {self.name}: out of space "
                f"({self._start}+{numel} > {self.numel})"
            )
        view = self.data[self._start:self._start + numel].view(shape)
        self._start += numel
        if self.track_usage:
            self.in_use_value += float(numel)
            self.total_value += float(self.numel)
        return view

    def get_data(self) -> torch.Tensor:
        return self.data

    def print_average_usage(self):
        if self.track_usage and self.total_value:
            print(
                f" > usage of {self.name} memory buffer: "
                f"{self.in_use_value * 100.0 / self.total_value:.2f} %"
            )


class RingMemBuffer:
    """Ring of ``num_buffers`` MemoryBuffers (reference memory.py:121-136)."""

    def __init__(self, name: str, num_buffers: int, numel: int, dtype,
                 track_usage: bool = False, device: Device = None):
        self.num_buffers = num_buffers
        self.buffers = [
            MemoryBuffer(f"{name} {i}", numel, dtype, track_usage, device)
            for i in range(num_buffers)
        ]
        self._index = -1

    def get_next_buffer(self) -> MemoryBuffer:
        self._index = (self._index + 1) % self.num_buffers
        buff = self.buffers[self._index]
        if buff.is_in_use():
            raise RuntimeError("buffer is already in use")
        return buff


def allocate_mem_buff(name: str, numel: int, dtype, track_usage: bool = False,
                      device: Device = None) -> MemoryBuffer:
    """Reference memory.py:24-31."""
    return MemoryBuffer(name, numel, dtype, track_usage, device)
