"""Quantized ring collectives: int8 hops with fp32 per-row scales.

Port of ``rocm_apex_tpu/ops/quantized_collectives.py`` (the JAX module
has no Pallas kernel: its rings are ``ppermute`` hops beside ``jnp``
rounding, so the port's are `parallel_state.shift` hops beside torch
ops). `ring_reduce_scatter`, `ring_all_gather` and `ring_all_reduce`
decompose the collective into ``size - 1`` neighbour hops; with
``comm_dtype="int8"`` every hop's payload is quantized to int8 with one
fp32 scale per trailing-axis row.

The contract, JAX's:

* `quantize_int8`: ``scale = amax(|row|) / 127``, then ``q =
  round(x / scale)`` by true division, rounded to nearest even
  (``torch.round``), clipped to +-127. A row whose max is 0 or not
  finite takes scale 1.0; a non-finite input saturates (inf -> +-127,
  nan -> 0), so an int8 wire carries no inf or nan across ranks. Two
  ranks quantizing the same values get the same ``(q, scale)`` bits.
* The gather quantizes each shard once, the local one included (it
  lands dequantized too), and rotates the ``(q, scale)`` pairs
  unchanged, so every rank reconstructs the same array.
* The reduce-scatter quantizes only what moves: the rotating fp32
  partial is quantized again at each hop, dequantized on arrival, and
  the local term is added in fp32. Rank r's block sums in the fixed
  ring order r + 1, r + 2, ..., r.
* Fallbacks, the reference's semantics: an axis with no group bound, or
  a group of one, is the identity; a ``chunk`` that does not tile the
  shard (or rows that do not tile the group) is the plain collective;
  `ring_all_reduce` with rows that do not tile the group is the plain
  sum.

JAX sends the int8 body and the scale column as two ``ppermute``s. The
port sends both in ONE staged exchange a hop (`shift_pair`: the scale
bytes, then the body bytes, as one uint8 buffer); the bits that arrive
are the same, and a hop costs one exchange, as an fp32 hop does.

Not differentiable: the quantization has zero gradient almost
everywhere. The tensor-parallel layers take the int8 payloads through
`ops.collective_matmul`'s rings (``comm_dtype="int8"``), whose
backward is their own rule; these rings serve the optimizer's data
flow (ROADMAP Queue 1 item 10d), which is never differentiated.
"""

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = [
    "COMM_DTYPES",
    "check_comm_dtype",
    "quantize_int8",
    "dequantize_int8",
    "shift_pair",
    "gather_ring",
    "scatter_ring",
    "ring_reduce_scatter",
    "ring_all_gather",
    "ring_all_reduce",
]

COMM_DTYPES = ("fp32", "int8")


def check_comm_dtype(comm_dtype: str) -> str:
    if comm_dtype not in COMM_DTYPES:
        raise ValueError(f"comm_dtype must be one of {COMM_DTYPES}, got "
                         f"{comm_dtype!r}")
    return comm_dtype


def bound_group(axis_name):
    """The axis's group when it is bound and holds more than one rank,
    else None (the identity, or the plain op)."""
    if isinstance(axis_name, str):
        try:
            group = parallel_state.get_axis_group(axis_name)
        except KeyError:
            return None
    else:
        group = axis_name
    return group if dist.get_world_size(group) > 1 else None


def ring_chunks(rows: int, chunk: Optional[int]) -> Optional[int]:
    """Pieces a shard, or None when ``chunk`` does not tile ``rows``."""
    if chunk is None:
        return 1
    if chunk <= 0 or rows % chunk:
        return None
    return rows // chunk


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale fp32 of trailing dim 1)``: symmetric per-row int8
    of a hop payload (the module's contract)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # the divisor a tensor on x's device: torch's CUDA kernel turns a
    # division by a Python scalar into a multiply by its reciprocal
    scale = torch.where(torch.isfinite(amax) & (amax > 0.0),
                        amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.nan_to_num(torch.round(xf / scale), nan=0.0)
    return q.clamp(-127.0, 127.0).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def shift_pair(q: torch.Tensor, scale: torch.Tensor, group, step: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`parallel_state.shift` of a ``(q, scale)`` pair in one exchange:
    rank r - step's pair, received while this one goes to rank r + step."""
    side = scale.contiguous().view(-1).view(torch.uint8)
    body = q.contiguous().view(-1).view(torch.uint8)
    out = parallel_state.shift(torch.cat([side, body]), group, step)
    n = side.numel()
    return (out[n:].view(torch.int8).view(q.shape),
            out[:n].view(torch.float32).view(scale.shape))


def gather_ring(x: torch.Tensor, group, m: int, dim: int, comm_dtype: str,
                dtype: torch.dtype):
    """The gather ring's walk (JAX `_rotating_pieces`, `_rotate_and_land`):
    yields ``(at, piece)`` for each of the group's shards' ``m`` pieces
    along ``dim`` as it lands here, ``at`` its first row in the gathered
    layout. The payloads go to rank - 1 each hop: the pieces as they are,
    or under int8 their ``(q, scale)`` pairs, each quantized once (the
    local one included) and landing dequantized in ``dtype``."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    rows = x.shape[dim]
    chunk = rows // m
    int8 = comm_dtype == "int8"
    pieces = list(x.split(chunk, dim=dim))
    if int8:
        pieces = [quantize_int8(p) for p in pieces]
    for i in range(n):
        # receive from rank + 1: hop i leaves rank idx + i's shard here
        src = (idx + i) % n
        nxt = []
        for j, payload in enumerate(pieces):
            if i + 1 < n:
                nxt.append(shift_pair(*payload, group, -1) if int8 else
                           parallel_state.shift(payload, group, -1))
            yield (src * rows + j * chunk,
                   dequantize_int8(*payload, dtype=dtype) if int8 else payload)
        pieces = nxt


def scatter_ring(term, rows: int, m: int, dim: int, group,
                 comm_dtype: str) -> torch.Tensor:
    """The reduce-scatter ring's walk (JAX `_acc_hop`): this rank's block
    of ``rows`` rows along ``dim``, summed over the group, in fp32.
    ``term(at, chunk)`` is this rank's fp32 term for the ``chunk`` rows
    from ``at`` of the full layout. Each of the ``m`` rotating partials
    goes to rank + 1 a hop, under int8 quantized again at every hop (its
    value changes each hop) and dequantized on arrival; the local term
    is added in fp32."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    chunk = rows // m
    acc = [None] * m
    for i in range(n):
        # the block this rank adds to now reaches its owner in the
        # remaining n - 1 - i hops (each to rank + 1)
        dst = (idx + n - 1 - i) % n
        for j in range(m):
            part = term(dst * rows + j * chunk, chunk)
            if acc[j] is None:
                acc[j] = part
            elif comm_dtype == "int8":
                q, s = shift_pair(*quantize_int8(acc[j]), group, 1)
                acc[j] = dequantize_int8(q, s) + part
            else:
                acc[j] = parallel_state.shift(acc[j], group, 1) + part
    return torch.cat(acc, dim=dim)


def ring_reduce_scatter(x: torch.Tensor, axis_name, *, dim: int = 0,
                        comm_dtype: str = "int8",
                        chunk: Optional[int] = None) -> torch.Tensor:
    """The tiled ``psum_scatter(x, dim)`` as a ring: each rank feeds its
    whole ``x`` and gets its block of ``x.shape[dim] / size`` rows,
    summed over the group, in x's dtype. The rotating partial sum is
    fp32 (quantized for the wire only under int8)."""
    check_comm_dtype(comm_dtype)
    group = bound_group(axis_name)
    if group is None:
        return x
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    rows_full = x.shape[dim]
    m = ring_chunks(rows_full // n, chunk) if rows_full % n == 0 else None
    if m is None:
        return parallel_state.reduce_scatter(x, group, dim)
    return scatter_ring(
        lambda at, rows: x.narrow(dim, at, rows).float(), rows_full // n, m,
        dim, group, comm_dtype).to(x.dtype)


def ring_all_gather(x: torch.Tensor, axis_name, *, dim: int = 0,
                    comm_dtype: str = "int8",
                    chunk: Optional[int] = None) -> torch.Tensor:
    """The tiled ``all_gather(x, dim)`` as a ring. Under int8 each shard,
    the local one included, is quantized once and its pair rotates
    unchanged, so every rank holds the same gathered bits; the fp32 ring
    moves the payloads as they are."""
    check_comm_dtype(comm_dtype)
    group = bound_group(axis_name)
    if group is None:
        return x
    dim = dim % x.dim()
    m = ring_chunks(x.shape[dim], chunk)
    if m is None:
        return parallel_state.all_gather(x, group, dim)
    rows = x.shape[dim] // m
    shape = list(x.shape)
    shape[dim] *= dist.get_world_size(group)
    out = x.new_empty(shape)
    for at, landed in gather_ring(x, group, m, dim, comm_dtype, x.dtype):
        out.narrow(dim, at, rows).copy_(landed)
    return out


def ring_all_reduce(x: torch.Tensor, axis_name, *, dim: int = 0,
                    comm_dtype: str = "int8",
                    chunk: Optional[int] = None) -> torch.Tensor:
    """``psum(x)`` as the ring reduce-scatter then the ring all-gather;
    the plain sum when ``x.shape[dim]`` does not tile the group."""
    check_comm_dtype(comm_dtype)
    group = bound_group(axis_name)
    if group is None:
        return x
    if x.shape[dim % x.dim()] % dist.get_world_size(group):
        return parallel_state.all_reduce(x, group)
    shard = ring_reduce_scatter(x, axis_name, dim=dim, comm_dtype=comm_dtype,
                                chunk=chunk)
    return ring_all_gather(shard, axis_name, dim=dim, comm_dtype=comm_dtype,
                           chunk=chunk)
