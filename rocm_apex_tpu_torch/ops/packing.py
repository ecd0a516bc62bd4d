"""Packed buffers: every leaf of a parameter tree in a few dtype-segregated
(rows, 1024) buffers, so that an optimizer step is one kernel a buffer.

Port of ``rocm_apex_tpu/ops/packing.py``, with its layout row for row, so
that packed buffers carry across between the two packages and compare
element for element:

* one buffer per leaf dtype, the groups ordered by dtype NAME (the JAX
  dtype names: ``"bfloat16"`` before ``"float32"``);
* each leaf starts on a fresh row of ``WIDTH = 1024`` elements, so a row
  never straddles two tensors and per-tensor quantities (LAMB trust
  ratios, per-tensor norms) are segmented row reductions;
* each buffer's row count is padded to ``ALIGN_ROWS`` with zeros, which
  every op of this layer maps to zero.

A tree is a dict of name -> tensor (or a list of tensors, taken in its
order). Leaves are ordered as JAX's ``tree_flatten`` orders the nested
dict the names spell: by the tuple of the dotted path's components,
compared as strings at every level, so ``layer_10`` comes before
``layer_2``.
"""

import functools
from typing import Any, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "WIDTH",
    "ALIGN_ROWS",
    "LeafSpec",
    "GroupSpec",
    "PackSpec",
    "PackedTree",
    "build_pack_spec",
    "check_packed_buffer",
    "dtype_name",
    "pack_tree",
    "pack_like",
    "unpack_tree",
    "group_segment_ids",
    "respec",
    "tree_flatten",
    "tree_unflatten",
]

# the JAX package's TPU tile (ops/_pallas.py): a row is 8 x 128 elements
LANE = 128
SUBLANE = 8
WIDTH = SUBLANE * LANE  # 1024
ALIGN_ROWS = 64


class LeafSpec(NamedTuple):
    """Where one leaf sits inside its group's buffer."""

    shape: Tuple[int, ...]
    dtype: str
    row_start: int
    nrows: int
    numel: int


class GroupSpec(NamedTuple):
    """One dtype's buffer: which leaves it holds and where."""

    dtype: str
    leaf_indices: Tuple[int, ...]  # indices into the flattened leaf list
    leaf_specs: Tuple[LeafSpec, ...]
    rows: int  # padded to ALIGN_ROWS


class PackSpec(NamedTuple):
    # the leaf names in flattening order (a tree given as a dict), or the
    # number of leaves (a list)
    treedef: Any
    groups: Tuple[GroupSpec, ...]
    n_leaves: int


def dtype_name(dtype: torch.dtype) -> str:
    """JAX's name of a dtype: ``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).rpartition(".")[2]


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def tree_flatten(tree: Any) -> Tuple[List[torch.Tensor], Any]:
    """``(leaves, treedef)`` in JAX's leaf order (see the module doc)."""
    if isinstance(tree, Mapping):
        names = tuple(sorted(tree, key=lambda k: tuple(k.split("."))))
        return [tree[k] for k in names], names
    leaves = list(tree)
    return leaves, len(leaves)


def tree_unflatten(treedef: Any, leaves: Sequence[Any]) -> Any:
    if isinstance(treedef, tuple):
        return dict(zip(treedef, leaves))
    return list(leaves)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def build_pack_spec(tree: Any) -> PackSpec:
    """The packing layout of a tree of floating tensors."""
    leaves, treedef = tree_flatten(tree)
    by_dtype = {}
    for i, leaf in enumerate(leaves):
        if not leaf.is_floating_point():
            raise TypeError(
                f"pack_tree only packs floating leaves; leaf {i} has dtype "
                f"{leaf.dtype}"
            )
        by_dtype.setdefault(dtype_name(leaf.dtype), []).append(i)
    groups = []
    for name in sorted(by_dtype):
        specs, row = [], 0
        for i in by_dtype[name]:
            numel = leaves[i].numel()
            nrows = max(1, -(-numel // WIDTH))
            specs.append(LeafSpec(shape=tuple(leaves[i].shape), dtype=name,
                                  row_start=row, nrows=nrows, numel=numel))
            row += nrows
        groups.append(GroupSpec(
            dtype=name, leaf_indices=tuple(by_dtype[name]),
            leaf_specs=tuple(specs), rows=_round_up(max(row, 1), ALIGN_ROWS),
        ))
    return PackSpec(treedef=treedef, groups=tuple(groups),
                    n_leaves=len(leaves))


class PackedTree:
    """A tree packed into dtype-segregated (rows, WIDTH) buffers."""

    def __init__(self, buffers: Sequence[torch.Tensor], spec: PackSpec):
        self.buffers = tuple(buffers)
        self.spec = spec

    def __repr__(self):
        shapes = ", ".join(f"{g.dtype}[{g.rows}x{WIDTH}]"
                           for g in self.spec.groups)
        return f"PackedTree({shapes}, n_leaves={self.spec.n_leaves})"


def check_packed_buffer(buf: torch.Tensor) -> None:
    """Raise unless ``buf`` is a packed buffer: a contiguous (rows, WIDTH)
    tensor with rows % ALIGN_ROWS == 0 (on a card, 16-byte aligned: the
    kernels' accesses are 16-byte vectors with no tail)."""
    if (buf.dim() != 2 or buf.shape[1] != WIDTH
            or buf.shape[0] % ALIGN_ROWS or not buf.is_contiguous()):
        raise ValueError(
            f"a packed buffer is a contiguous (rows, {WIDTH}) tensor with "
            f"rows % {ALIGN_ROWS} == 0, got {tuple(buf.shape)}"
        )
    if buf.device.type == "cuda" and buf.data_ptr() % 16:
        raise ValueError("a packed buffer must start 16-byte aligned")


def _views(buf: torch.Tensor, group: GroupSpec) -> List[torch.Tensor]:
    """Each leaf of ``group`` as a view of its rows of ``buf``."""
    flat = buf.view(-1)
    return [flat[ls.row_start * WIDTH:ls.row_start * WIDTH + ls.numel]
            .view(ls.shape) for ls in group.leaf_specs]


def _pack_group(leaves, group: GroupSpec, cast: bool) -> torch.Tensor:
    dtype = _torch_dtype(group.dtype)
    srcs = [leaves[i] for i in group.leaf_indices]
    for i, leaf in zip(group.leaf_indices, srcs):
        if not cast and leaf.dtype != dtype:
            raise TypeError(
                f"leaf {i} has dtype {leaf.dtype} but the pack spec expects "
                f"{group.dtype}; use pack_like() to pack a tree whose dtypes "
                "differ from the spec's"
            )
    device = srcs[0].device if srcs else None
    # zeros: the row tails and the padding rows stay 0
    buf = torch.zeros((group.rows, WIDTH), dtype=dtype, device=device)
    if srcs:
        torch._foreach_copy_(_views(buf, group),
                             [s.reshape(ls.shape) for s, ls in
                              zip(srcs, group.leaf_specs)])
    return buf


def _check_leaf_count(leaves, spec):
    if len(leaves) != spec.n_leaves:
        raise ValueError(
            f"tree has {len(leaves)} leaves but spec describes "
            f"{spec.n_leaves}"
        )


def pack_tree(tree: Any, spec: Optional[PackSpec] = None) -> PackedTree:
    """Pack a tree into its buffers (the layout of ``spec`` when given);
    each leaf must have its group's dtype."""
    if spec is None:
        spec = build_pack_spec(tree)
    leaves, _ = tree_flatten(tree)
    _check_leaf_count(leaves, spec)
    return PackedTree([_pack_group(leaves, g, cast=False)
                       for g in spec.groups], spec)


def pack_like(spec: PackSpec, tree: Any) -> PackedTree:
    """Pack ``tree`` (same names and shapes) into ``spec``'s layout,
    casting each leaf to its group's dtype (fp32 gradients against bf16
    parameters)."""
    leaves, _ = tree_flatten(tree)
    _check_leaf_count(leaves, spec)
    return PackedTree([_pack_group(leaves, g, cast=True)
                       for g in spec.groups], spec)


def unpack_tree(packed: PackedTree) -> Any:
    """The inverse of `pack_tree`: each leaf a view of its buffer."""
    spec = packed.spec
    leaves = [None] * spec.n_leaves
    for buf, group in zip(packed.buffers, spec.groups):
        for i, view in zip(group.leaf_indices, _views(buf, group)):
            leaves[i] = view
    return tree_unflatten(spec.treedef, leaves)


def respec(spec: PackSpec, dtype) -> PackSpec:
    """``spec`` with every group and leaf in ``dtype`` (None: unchanged):
    the layout of a companion tree (fp32 gradients, masters, moments)."""
    if dtype is None:
        return spec
    name = dtype if isinstance(dtype, str) else dtype_name(dtype)
    return spec._replace(groups=tuple(
        g._replace(dtype=name, leaf_specs=tuple(
            ls._replace(dtype=name) for ls in g.leaf_specs))
        for g in spec.groups
    ))


@functools.lru_cache(maxsize=64)
def group_segment_ids(group: GroupSpec) -> np.ndarray:
    """Row -> leaf index within the group; the padding rows map to
    ``len(group.leaf_specs)``, to be dropped from per-tensor results."""
    ids = np.full((group.rows,), len(group.leaf_specs), dtype=np.int32)
    for j, ls in enumerate(group.leaf_specs):
        ids[ls.row_start:ls.row_start + ls.nrows] = j
    return ids
