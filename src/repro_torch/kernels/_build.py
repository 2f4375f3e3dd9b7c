"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, from the sources in the checkout, into
``build/kernels/`` at the repo root (listed in ``.gitignore``); a library's
file name carries a hash of the sources and flags, so an edited source is
rebuilt, never reused stale.  All sources are compiled together, one
``nvcc`` process each, started at once.

``launches`` holds one plain integer per kernel (``KERNELS``; K2, K3 and K4
are three forms of one template in one library, ``lif_deliver``, and K2's
local-ring form, the sharded step's delivery, is counted apart as
``ell_deliver_local``; K5,
``gated_spike_matvec``, lives in ``spike_deliver``, and K6,
``flash_attention``, is two kernels: bfloat16 on the tensor cores in
``flash_attention_sm90``, float32 on the CUDA cores in
``flash_attention``; ``pop_counts``, the probe's per-population spike
count, in ``pop_counts``).  A wrapper adds one where it launches its kernel,
and nowhere else, so a run can show that its path went through the
kernels (``reset_launches`` before, read after).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "kernels"

#: library name -> its source in csrc/
SOURCES = {
    "lif_update": "lif_update.cu",
    "lif_deliver": "lif_deliver.cu",
    "stdp_update": "stdp_update.cu",
    "spike_deliver": "spike_deliver.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_sm90": "flash_attention_sm90.cu",
    "pop_counts": "pop_counts.cu",
}
#: kernel name -> the libraries that hold it
KERNELS = {"lif_update": ("lif_update",), "ell_deliver": ("lif_deliver",),
           "ell_deliver_local": ("lif_deliver",),
           "lif_deliver": ("lif_deliver",),
           "lif_deliver_plastic": ("lif_deliver",),
           "stdp_update": ("stdp_update",),
           "gated_spike_matvec": ("spike_deliver",),
           "flash_attention": ("flash_attention_sm90", "flash_attention"),
           "pop_counts": ("pop_counts",)}

# --fmad=false on top of the explicit __fmul_rn/__fadd_rn: no multiply-add
# may contract into an FMA, or V would differ from the plain version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

launches: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: nvcc's -Xptxas -v report per kernel (registers, shared memory, spills)
ptxas_report: Dict[str, str] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def cuda_tool(name: str = "nvcc") -> str:
    """The path of one of the CUDA toolkit's programs (``nvcc``,
    ``cuobjdump``): on PATH, else under $CUDA_HOME/bin."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / name
    if not path.exists():
        raise RuntimeError(
            f"{name} not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            f"repro_torch are built from csrc/ at first use on a CUDA machine")
    return str(path)


def library_path(name: str) -> Path:
    """Where library ``name`` of the current sources and flags is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (
                src.suffix == ".cuh" or src.name == SOURCES[name]):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library, all at once;
    returns the wall seconds spent (0 when everything was built)."""
    todo = {name: library_path(name) for name in SOURCES}
    todo = {k: p for k, p in todo.items() if not p.exists()}
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_tool("nvcc")
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        ptxas_report[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch stream on ``t``'s device, as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def device_index(device) -> int:
    """The index of a CUDA ``device``; ``torch.device("cuda")`` has none,
    and means the current device."""
    import torch
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None \
        else device.index


def require_cuda(what: str, *tensors) -> None:
    """A kernel takes contiguous CUDA tensors of one device, or raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: tensors must all lie on one CUDA "
                             f"device (got {t.device} and {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
