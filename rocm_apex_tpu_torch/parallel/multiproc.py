"""One process per device: the launcher.

Port of ``rocm_apex_tpu/parallel/multiproc.py`` (JAX :1-33). JAX runs
the target script inline, since one JAX controller drives every local
device. The port runs one process a rank, so `main` follows the
reference the JAX docstring cites (apex/parallel/multiproc.py:1-35): it
starts ``--nproc`` copies of the script (default: the visible CUDA
devices, else 1), each with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` in its environment (the script calls
``torch.distributed.init_process_group(init_method="env://")``), waits
for all of them and returns the first non-zero exit code, in rank order
(0 when every copy succeeded).

    python -m rocm_apex_tpu_torch.parallel.multiproc [--nproc N]
        [--master-port P] script.py [args...]
"""

import argparse
import os
import socket
import subprocess
import sys
from typing import List, Optional

__all__ = ["main"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _default_nproc() -> int:
    try:
        import torch

        return max(torch.cuda.device_count(), 1)
    except ImportError:
        return 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rocm_apex_tpu_torch.parallel.multiproc",
        description="start one process of a script per rank")
    ap.add_argument("--nproc", type=int, default=None,
                    help="processes (default: the visible CUDA devices)")
    ap.add_argument("--master-addr", default="localhost")
    ap.add_argument("--master-port", type=int, default=None,
                    help="the rendezvous port (default: a free one)")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    n = a.nproc if a.nproc is not None else _default_nproc()
    port = a.master_port if a.master_port is not None else _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(rank), MASTER_ADDR=a.master_addr,
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, a.script, *a.args], env=env))
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c != 0), 0)


if __name__ == "__main__":
    sys.exit(main())
