"""Paged multi-LoRA adapter pool: many registered tenants, a fixed-shape
device residency window.

Port of ``rocm_apex_tpu/inference/adapters.py``. `ops/lora.py` makes
adapter ids DATA: each projection gathers per-token factors out of
packed ``(L, P, h, r)`` / ``(L, P, r, o)`` fp32 device buffers, so a
tick depends on WHICH adapters are resident only through the ids. The
buffer slots are pages of a `PageAllocator`:

* ref-counts: one ref per in-flight request using the adapter
  (admission `acquire`s, every teardown path `release`s once);
* LRU park: an idle tenant's slot keeps its bytes (``decref(park=
  True)``), so that tenant's next request revives it with no upload;
* reclaim on pressure: a fresh tenant's ``alloc`` evicts the least
  recently parked slot (``on_evict`` unmaps it here); when every slot
  is pinned by in-flight work `acquire` returns None and the engine
  backpressures at admission.

Slot 0 is the base model: allocated at construction (the allocator's
first ``alloc(1)`` is ``[0]``), zero forever, its ref never dropped.
``adapter_id == 0`` means "no adapter" end to end.

Host side, the registry keeps rank-padded fp32 copies (`pad_rank` folds
alpha/rank into B at registration), plus the admission ``tier`` each
tenant bought. Factors come in as numpy, as in the JAX pool, so both
packages register the same arrays. An upload is an in-place ``copy_``
into the slot of the device buffers: nothing is reallocated. On a CUDA
device the host copies are pinned and the copy is asynchronous, so an
upload inside a tick syncs nothing.
"""

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from rocm_apex_tpu_torch._device import resolve_device
from rocm_apex_tpu_torch.inference.paging import PageAllocator
from rocm_apex_tpu_torch.ops.lora import pad_rank

__all__ = ["AdapterPool", "BASE_ADAPTER_ID", "TARGETS"]

# adapter_id 0 = base model everywhere: requests default to it, buffer
# slot 0 holds zeros, acquire/release are free no-ops
BASE_ADAPTER_ID = 0

# projection targets carrying deltas, in model order: "qkv" hooks the
# fused query_key_value projection (h -> 3h), "dense" the attention
# output projection (h -> h)
TARGETS = ("qkv", "dense")


class AdapterPool:
    """Fixed-shape paged device buffers and a host registry for LoRA
    adapters (see the module docstring for the residency protocol).
    ``device``: where the buffers live (default CUDA)."""

    def __init__(
        self,
        num_layers: int,
        hidden: int,
        *,
        max_resident: int = 8,
        max_rank: int = 8,
        qkv_out: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if num_layers < 1 or hidden < 1:
            raise ValueError(
                f"bad pool geometry: layers={num_layers} hidden={hidden}"
            )
        if max_resident < 2:
            # slot 0 is the base; a pool that can hold no adapter admits
            # nothing and deadlocks admission
            raise ValueError(
                f"max_resident must be >= 2 (slot 0 is the base), "
                f"got {max_resident}"
            )
        if max_rank < 1:
            raise ValueError(f"max_rank must be >= 1, got {max_rank}")
        self.num_layers = int(num_layers)
        self.hidden = int(hidden)
        self.max_resident = int(max_resident)
        self.max_rank = int(max_rank)
        self.device = resolve_device(device)
        self.out_dims = {
            "qkv": int(qkv_out) if qkv_out is not None else 3 * hidden,
            "dense": int(hidden),
        }
        L, P, h, r = num_layers, max_resident, hidden, max_rank
        self._buffers: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {
            t: (
                torch.zeros((L, P, h, r), dtype=torch.float32,
                            device=self.device),
                torch.zeros((L, P, r, self.out_dims[t]),
                            dtype=torch.float32, device=self.device),
            )
            for t in TARGETS
        }
        self._alloc = PageAllocator(max_resident)
        self._alloc.on_evict = self._on_evict
        base = self._alloc.alloc(1)
        assert base == [0], f"base slot must be 0, allocator gave {base}"

        # host registry: adapter_id -> padded fp32 factors (pinned on a
        # CUDA pool, so the copy into a slot is asynchronous) / metadata
        self._host: Dict[int, Dict[str, Tuple[torch.Tensor,
                                              torch.Tensor]]] = {}
        self._tenant: Dict[int, str] = {BASE_ADAPTER_ID: "base"}
        self._tier: Dict[int, int] = {BASE_ADAPTER_ID: 0}
        self._rank: Dict[int, int] = {BASE_ADAPTER_ID: 0}
        self._by_tenant: Dict[str, int] = {}
        self._slot_of: Dict[int, int] = {BASE_ADAPTER_ID: 0}
        self._aid_at: Dict[int, int] = {0: BASE_ADAPTER_ID}
        self._next_id = 1
        # park/reclaim economics for tests and stats()
        self.uploads = 0
        self.evictions = 0
        self.revivals = 0

    # -- device buffers --------------------------------------------------

    @property
    def buffers(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """``{"qkv": (A, B), "dense": (A, B)}``; A is (L, P, h, r), B is
        (L, P, r, out), fp32 on the pool's device."""
        return self._buffers

    @buffers.setter
    def buffers(self, value: Dict[str, Tuple[Any, Any]]) -> None:
        if set(value) != set(TARGETS):
            raise ValueError(f"buffer pytree keys {set(value)}")
        self._buffers = {t: (value[t][0], value[t][1]) for t in TARGETS}

    # -- registry --------------------------------------------------------

    def register(
        self,
        tenant: str,
        weights: List[Dict[str, Tuple[Any, Any]]],
        *,
        rank: int,
        alpha: Optional[float] = None,
        tier: int = 0,
    ) -> int:
        """Register a tenant's adapter; returns its adapter_id (>= 1).

        ``weights`` is one dict per layer, each mapping a target in
        ``TARGETS`` to its ``(A: (h, r), B: (r, out))`` numpy factors; a
        target missing from a layer's dict contributes no delta there.
        Factors are rank-padded and alpha-scaled here, once."""
        if not tenant or tenant == "base":
            raise ValueError(f"bad tenant name {tenant!r}")
        if tenant in self._by_tenant:
            raise ValueError(f"tenant {tenant!r} already registered")
        if len(weights) != self.num_layers:
            raise ValueError(
                f"expected {self.num_layers} per-layer weight dicts, "
                f"got {len(weights)}"
            )
        pin = self.device.type == "cuda"
        packed: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        for t in TARGETS:
            o = self.out_dims[t]
            a_l = np.zeros((self.num_layers, self.hidden, self.max_rank),
                           np.float32)
            b_l = np.zeros((self.num_layers, self.max_rank, o), np.float32)
            for li, layer in enumerate(weights):
                if t not in layer:
                    continue
                a, b = layer[t]
                if np.asarray(a).shape != (self.hidden, rank):
                    raise ValueError(
                        f"layer {li} {t} A shape "
                        f"{np.asarray(a).shape} != ({self.hidden}, {rank})"
                    )
                if np.asarray(b).shape != (rank, o):
                    raise ValueError(
                        f"layer {li} {t} B shape "
                        f"{np.asarray(b).shape} != ({rank}, {o})"
                    )
                a_l[li], b_l[li] = pad_rank(a, b, self.max_rank, alpha)
            packed[t] = tuple(
                torch.from_numpy(x).pin_memory() if pin
                else torch.from_numpy(x) for x in (a_l, b_l))
        aid = self._next_id
        self._next_id += 1
        self._host[aid] = packed
        self._tenant[aid] = tenant
        self._tier[aid] = int(tier)
        self._rank[aid] = int(rank)
        self._by_tenant[tenant] = aid
        return aid

    def lookup(self, tenant: str) -> Optional[int]:
        return self._by_tenant.get(tenant)

    def tenant_of(self, adapter_id: int) -> str:
        return self._tenant[adapter_id]

    def tier_of(self, adapter_id: int) -> int:
        return self._tier[adapter_id]

    def rank_of(self, adapter_id: int) -> int:
        return self._rank[adapter_id]

    def known(self, adapter_id: int) -> bool:
        return adapter_id == BASE_ADAPTER_ID or adapter_id in self._host

    @property
    def num_registered(self) -> int:
        """Registered adapters, base excluded."""
        return len(self._host)

    # -- residency -------------------------------------------------------

    def resident(self, adapter_id: int) -> bool:
        return adapter_id in self._slot_of

    def slot_of(self, adapter_id: int) -> Optional[int]:
        return self._slot_of.get(adapter_id)

    def acquire(self, adapter_id: int) -> Optional[int]:
        """One admission ref on the adapter; returns its buffer slot, or
        None when every slot is pinned (the caller skips this request
        and retries next tick). Raises only on unknown ids."""
        if adapter_id == BASE_ADAPTER_ID:
            return 0
        if adapter_id not in self._host:
            raise KeyError(f"unknown adapter_id {adapter_id}")
        slot = self._slot_of.get(adapter_id)
        if slot is not None:
            if self._alloc.refcount(slot) == 0:
                self.revivals += 1  # parked -> live, bytes reused
            self._alloc.ref(slot)
            return slot
        got = self._alloc.alloc(1)
        if got is None:
            return None
        slot = got[0]
        self._upload(adapter_id, slot)
        self._slot_of[adapter_id] = slot
        self._aid_at[slot] = adapter_id
        return slot

    def release(self, adapter_id: int) -> None:
        """Drop one admission ref. The slot PARKS at refcount zero: its
        bytes stay resident for revival until pressure reclaims it."""
        if adapter_id == BASE_ADAPTER_ID:
            return
        slot = self._slot_of.get(adapter_id)
        if slot is None:
            raise RuntimeError(
                f"release of non-resident adapter {adapter_id} "
                f"(double release?)"
            )
        self._alloc.decref(slot, park=True)

    def refs(self, adapter_id: int) -> int:
        slot = self._slot_of.get(adapter_id)
        return 0 if slot is None else self._alloc.refcount(slot)

    def _on_evict(self, slot: int) -> None:
        aid = self._aid_at.pop(slot)
        del self._slot_of[aid]
        self.evictions += 1

    def _upload(self, adapter_id: int, slot: int) -> None:
        """The adapter's factors into buffer slot ``slot``, in place."""
        packed = self._host[adapter_id]
        for t in TARGETS:
            A, B = self._buffers[t]
            a_h, b_h = packed[t]
            A[:, slot].copy_(a_h, non_blocking=True)
            B[:, slot].copy_(b_h, non_blocking=True)
        self.uploads += 1

    # -- invariants and observability ------------------------------------

    def snapshot(self) -> Dict[str, int]:
        """Counters for leak checks: after every in-flight request has
        finished, ``refs`` is exactly 1 (the base slot's own ref)."""
        s = self._alloc.snapshot()
        s.update(
            resident=len(self._slot_of) - 1,  # base excluded
            registered=self.num_registered,
            uploads=self.uploads,
            evictions=self.evictions,
            revivals=self.revivals,
        )
        return s

    def assert_consistent(self) -> None:
        """Allocator partition invariants plus the residency-map
        bijection; run by tests after every teardown path."""
        self._alloc.assert_consistent()
        assert self._slot_of.get(BASE_ADAPTER_ID) == 0, "base slot moved"
        assert self._alloc.refcount(0) >= 1, "base slot ref dropped"
        for aid, slot in self._slot_of.items():
            assert self._aid_at.get(slot) == aid, (
                f"slot map corrupt: adapter {aid} -> slot {slot} -> "
                f"adapter {self._aid_at.get(slot)}"
            )
        for slot, aid in self._aid_at.items():
            assert self._slot_of.get(aid) == slot, (
                f"slot map corrupt: slot {slot} -> adapter {aid} -> "
                f"slot {self._slot_of.get(aid)}"
            )
