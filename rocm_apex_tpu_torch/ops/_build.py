"""Build, load and launch the port's hand-written CUDA kernels.

The counterpart of ``rocm_apex_tpu/ops/_pallas.py``: where the JAX
package hands each Pallas kernel to ``pl.pallas_call``, the port
compiles ``rocm_apex_tpu_torch/csrc/*.cu`` with ``nvcc`` for Hopper
(``sm_90a``) into one shared library per source, with a plain C
interface, and binds it with ``ctypes``. Nothing is built when a module
is imported: the first launch builds every source at once (one ``nvcc``
process each, started together) into ``rocm_apex_tpu_torch/_build/``,
keyed by a hash of the sources, headers and flags, so later processes
reuse the libraries.

Every C entry point returns ``cudaGetLastError()``; `Kernel.__call__`
raises if it is not 0, since a refused launch never runs and a later
``torch.cuda.synchronize()`` would not report it. Each library also keeps
a host table of the device kernels its entry points launched, by name
(``launch_log``, csrc/common.cuh): `device_launches` reads every loaded
library's, `reset_device_launches` clears them, `Kernel.device_launches`
reads its own library's.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

__all__ = [
    "Kernel",
    "KERNELS",
    "DTYPE_CODES",
    "build_all",
    "build_logs",
    "device_launches",
    "reset_device_launches",
    "dtype_code",
    "half_float",
    "ptr",
    "sm_count",
    "stream_ptr",
]

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, kept in the build log
    "-Xptxas", "-v",
)

# the dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# every Kernel registers itself here (chip_smoke.py resets and reads the
# launch counts around the main path)
KERNELS: List["Kernel"] = []


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(
            f"the CUDA kernels take float32, bfloat16 or float16, got {dtype}"
        )
    return DTYPE_CODES[dtype]


def half_float(dtype: torch.dtype) -> bool:
    """A 2-byte float type (bfloat16 or float16): the plans send these to
    the tensor-core routes (wgmma takes either at the same shapes, f32
    accumulators), fp32 to the CUDA cores."""
    return dtype in (torch.bfloat16, torch.float16)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ctypes pointer (None -> NULL)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The multiprocessors of a CUDA device (the kernels' grids are sized
    from it)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c is not None and Path(c).is_file():
            return str(c)
    raise RuntimeError(
        "nvcc was not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from rocm_apex_tpu_torch/csrc at "
        "first use"
    )


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _library_path(source: Path) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in [source] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source at once (one ``nvcc`` each, run in
    parallel) and return ``{source file name: library path}``. The
    compiler's output (``-Xptxas -v``: registers and spills) goes to a
    ``.log`` beside each library."""
    sources = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s.name: _library_path(s) for s in sources}
    stale = [s for s in sources if not out[s.name].exists()]
    if not stale:
        return out
    nvcc = _nvcc()
    procs = []
    for src in stale:
        lib = out[src.name]
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(src)]
        procs.append((src, lib, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT
        )))
    # each source's seconds from the start of the build to its end, at the
    # end of its log (the build takes its slowest source's)
    t0, ended = time.perf_counter(), {}
    while len(ended) < len(procs):
        for src, _, _, _, proc in procs:
            if src not in ended and proc.poll() is not None:
                ended[src] = time.perf_counter() - t0
        time.sleep(0.05)
    failed = []
    for src, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        with open(lib.with_suffix(".log"), "a") as f:
            f.write(f"\nbuild seconds: {ended[src]:.1f}\n")
        if rc != 0:
            failed.append(
                f"{src.name} (exit {rc}):\n"
                + lib.with_suffix(".log").read_text()[-4000:]
            )
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def build_logs() -> Dict[str, str]:
    """The compiler output of the current build, per source."""
    return {
        s.name: (
            _library_path(s).with_suffix(".log").read_text()
            if _library_path(s).with_suffix(".log").exists() else ""
        )
        for s in _sources()
    }


def _library(source: str) -> ctypes.CDLL:
    with _lock:
        if source not in _libs:
            for name, path in build_all().items():
                if name not in _libs:
                    lib = ctypes.CDLL(str(path))
                    lib.kernel_error_string.argtypes = [ctypes.c_int]
                    lib.kernel_error_string.restype = ctypes.c_char_p
                    lib.launch_log.argtypes = [ctypes.c_char_p, ctypes.c_int]
                    lib.launch_log.restype = ctypes.c_int
                    lib.launch_log_reset.argtypes = []
                    lib.launch_log_reset.restype = None
                    _libs[name] = lib
        return _libs[source]


def _launch_log(lib: ctypes.CDLL) -> Dict[str, int]:
    need = lib.launch_log(None, 0)
    buf = ctypes.create_string_buffer(need)
    lib.launch_log(buf, need)
    out = {}
    for line in buf.value.decode().splitlines():
        name, count = line.rsplit(" ", 1)
        out[name] = int(count)
    return out


def device_launches() -> Dict[str, int]:
    """Device kernel name -> launches since the last
    `reset_device_launches`, over every library this process loaded (a
    name launched from two libraries sums). The names are the kernels'
    own (``fwd_pipe_kernel``; a bottleneck pipe's as ``pipe_kernel<``
    its problem type's typeid name ``>``), recorded on the host as each
    launch call returns without error."""
    out: Dict[str, int] = {}
    with _lock:
        libs = list(_libs.values())
    for lib in libs:
        for name, n in _launch_log(lib).items():
            out[name] = out.get(name, 0) + n
    return out


def reset_device_launches() -> None:
    """Clear the launch table of every loaded library."""
    with _lock:
        libs = list(_libs.values())
    for lib in libs:
        lib.launch_log_reset()


class Kernel:
    """One hand-written kernel: its C entry point in ``csrc/<source>``,
    the TPU kernel it replaces, and ``launches``, the number of times
    its wrapper has launched it in this process (a plain int a caller
    may reset to 0)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = _library(self.source).kernel_error_string(rc).decode()
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with error {rc} ({msg})"
            )
        self.launches += 1

    def device_launches(self) -> Dict[str, int]:
        """Device kernel name -> launches recorded by this kernel's
        library (every entry point of its source) since the last
        `reset_device_launches`."""
        return _launch_log(_library(self.source))
