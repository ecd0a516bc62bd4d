"""Numerics flight recorder: last-k step snapshots and NaN provenance.

Port of ``rocm_apex_tpu/monitor/recorder.py``:

* **probes** (`group_nonfinite`): one 0/1 flag per top-level parameter
  group of a tensor tree, from one fp32 sum per group (finite iff every
  element is; inf meeting -inf gives nan, still caught). The flags stay
  on the device as tensors: the caller fetches them with the step's own
  values, so the probe adds no sync;
* **host ring** (`FlightRecorder.record`): the last ``last_k`` steps'
  scalar snapshots. On an anomaly (a non-finite value, a
  ``nonfinite/<group>`` flag set, a ``found_inf`` entry firing) it dumps
  a jsonl bundle: the step, the loss scale, the offending names and the
  history window. The serving engine records ``nonfinite/slot<i>`` when
  it quarantines a slot, from values already on the host.
"""

import json
import math
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = ["FlightRecorder", "group_nonfinite"]


def _top_level_groups(tree: Any) -> Dict[str, Any]:
    """{'embedding': subtree, ...} for the first mapping level of a
    (possibly ``{'params': {...}}``-wrapped) tree; a non-mapping tree is
    one group, 'all'."""
    if hasattr(tree, "items"):
        items = dict(tree)
        if set(items) == {"params"}:
            items = dict(items["params"])
        return items
    return {"all": tree}


def _float_leaves(tree: Any) -> List[torch.Tensor]:
    """The floating-point tensors of a nested mapping / sequence tree,
    in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if hasattr(tree, "items"):
        return [x for k in sorted(tree) for x in _float_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _float_leaves(sub)]
    return []


def group_nonfinite(
    tree: Any,
    prefix: str = "nonfinite",
    axis_name: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """``{"nonfinite/<group>": 0.0|1.0}`` per top-level group of
    ``tree``, each a 0-dim fp32 tensor on the leaves' device (nothing is
    read back to the host here).

    Each flag sums the group's leaves in fp32 into one scalar, finite iff
    every element is. With ``axis_name`` (a tensor-parallel axis or
    process group) the partial sums are all-reduced before the test, so
    every rank reports the same flag for a sharded tree."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in sorted(_top_level_groups(tree).items()):
        leaves = _float_leaves(sub)
        if not leaves:
            continue
        probe = sum(x.float().sum() for x in leaves)
        if axis_name:
            probe = parallel_state.all_reduce(
                probe, parallel_state.resolve_group(axis_name))
        out[f"{prefix}/{name}"] = (~torch.isfinite(probe)).float()
    return out


class FlightRecorder:
    """Host-side ring of the last ``last_k`` step snapshots with
    anomaly-triggered jsonl dumps.

    ``record(step, metrics)`` accepts a `Metrics`, any mapping, or
    anything with ``as_dict()``; values are read with ``float`` (a
    tensor value is fetched here: pass host values on a path that must
    not sync). Returns the dump bundle when this step is anomalous,
    else None.

    Anomaly = any non-finite snapshot value, any ``<prefix>/<group>``
    flag > 0, or a truthy ``found_inf`` entry. ``max_dumps`` caps the
    bundles written (a persistently-NaN run must not fill the disk);
    ``offending()`` and ``dumps`` expose the history programmatically.
    """

    def __init__(
        self,
        last_k: int = 32,
        path: Optional[str] = None,
        prefix: str = "nonfinite",
        max_dumps: int = 8,
    ):
        if last_k < 1:
            raise ValueError(f"last_k must be >= 1, got {last_k}")
        self.last_k = last_k
        self.path = path
        self.prefix = prefix + "/"
        self.max_dumps = max_dumps
        self._ring: deque = deque(maxlen=last_k)
        self.dumps: List[Dict[str, Any]] = []

    # -- per-step ingestion ---------------------------------------------

    def record(self, step: int, metrics, **extra) -> Optional[Dict]:
        """Snapshot one step; dump and return the bundle on anomaly."""
        if hasattr(metrics, "as_dict"):
            metrics = metrics.as_dict()
        snap: Dict[str, float] = {"step": int(step)}
        for name, value in {**metrics, **extra}.items():
            snap[name] = float(value)
        self._ring.append(snap)
        offending = self.offending(snap)
        if not offending:
            return None
        return self._dump(snap, offending)

    def offending(self, snap: Dict[str, float]) -> List[str]:
        """The anomalous entries of one snapshot: group names whose
        nonfinite flag fired, plus any metric that is itself
        non-finite, plus ``found_inf`` when set."""
        out = []
        for name, value in snap.items():
            if name == "step":
                continue
            if name.startswith(self.prefix):
                if value > 0.0:
                    out.append(name[len(self.prefix):])
            elif name == "found_inf":
                if value > 0.0:
                    out.append(name)
            elif not math.isfinite(value):
                out.append(name)
        return out

    # -- dumping --------------------------------------------------------

    def _dump(self, snap: Dict[str, float], offending) -> Dict[str, Any]:
        bundle = {
            "event": "numerics_anomaly",
            "step": snap["step"],
            "offending": offending,
            "loss_scale": snap.get("loss_scale"),
            "snapshot": snap,
            # the ring INCLUDES the anomalous step (it was just
            # appended): the window a postmortem wants is "the k steps
            # leading into the blow-up"
            "history": list(self._ring),
        }
        if len(self.dumps) < self.max_dumps:
            self.dumps.append(bundle)
            if self.path is not None:
                with open(self.path, "a") as f:
                    json.dump(bundle, f)
                    f.write("\n")
        return bundle
