"""The ranks of tests/test_torch_grad_scaler.py: one process each of a
gloo group on the CPU.

This module imports torch and the port only (a spawned rank re-imports
the module that defines its entry point, and the test module imports
JAX). Each rank binds the default group to the "tensor" axis, runs the
transformer `GradScaler` over its own overflow flags, and writes each
step's scaler state and skip decision to ``rank<r>.pt``.
"""

import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)


def run(rank, n, workdir, flags, scaler_kw):
    """One rank: init the group (a file store under ``workdir``), bind
    "tensor" (and not "pipe"), step the scaler over ``flags[rank]``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=n, timeout=TIMEOUT)
    from rocm_apex_tpu_torch.transformer import parallel_state
    from rocm_apex_tpu_torch.transformer.amp import GradScaler, sync_found_inf

    parallel_state.set_axis_group(parallel_state.TENSOR_AXIS)
    scaler = GradScaler(**scaler_kw)
    state = scaler.init()
    out = {"states": [], "skips": [], "synced": []}
    for flag in flags[rank]:
        out["synced"].append(bool(sync_found_inf(torch.tensor(flag))))
        state, skip = scaler.update(state, torch.tensor(flag))
        out["states"].append(tuple(float(x) for x in state))
        out["skips"].append(bool(skip))
    # an unsynced scaler (no axes) keeps this rank's own decision
    alone = GradScaler(axis_names=(), **scaler_kw)
    out["alone"] = [bool(alone.update(alone.init(), torch.tensor(f))[1])
                    for f in flags[rank]]
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    parallel_state.clear_axis_groups()
    dist.destroy_process_group()
