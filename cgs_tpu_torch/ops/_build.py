"""Build and bind the port's CUDA C++ kernels (`cgs_tpu_torch/csrc/`).

Each `csrc/<name>.cu` has a plain C interface and is compiled by its own
`nvcc` into `build/kernels/lib<name>.so` at the root of the checkout
(a directory `.gitignore` lists), then loaded with `ctypes`. All
sources are compiled at once, in parallel, on the first use of any
kernel; a library newer than its source is reused. Nothing is built
or imported when this module is imported, so the CPU tests import it
on a machine without `nvcc`.

Every C entry point takes its pointers and the stream as `void*` and
returns `cudaGetLastError()`; `check` raises on anything but 0.

`launches` counts kernel launches per entry point (`KERNELS`: the C
name without its `cgs_` prefix). A wrapper adds one where it launches
its kernel and nowhere else, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# the C signature of every entry point: (argtypes) -> int
_P, _I64, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    "normalize_u8": {"cgs_normalize_u8": (_P,) + (_I64,) * 4
                     + (_P, _P, _I64, _P)},
    "upsample2x": {"cgs_upsample2x": (_P,) * 3 + (_I64,) * 7 + (_P,),
                   "cgs_upsample2x_bwd": (_P,) * 3 + (_I64,) * 11 + (_P,)},
    "threshold_iou": {"cgs_threshold_iou": (_P, _P, _I64, _F32, _P, _P,
                                            _P)},
    "merge_pair": {"cgs_merge_pair": (_P,) * 5 + (_I64, _I64, _P),
                   "cgs_merge_pair_bwd": (_P,) * 7 + (_I64,) * 6 + (_P,)},
}

# one launch counter per C entry point, named without the `cgs_` prefix
KERNELS = tuple(fn[len("cgs_"):] for fns in SIGNATURES.values()
                for fn in fns)

launches: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH): the port's CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build_kernels(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Compile every stale kernel (one `nvcc` each, all started
    together), load all of them, and return {name: CDLL}."""
    if len(_libs) == len(SIGNATURES):
        return dict(_libs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SIGNATURES if _stale(n)]
    procs = {}
    if todo:
        nvcc = _nvcc()
        for name in todo:
            # per-process temp name + os.replace: concurrent
            # builders never load a half-written library
            tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS,
                   *(("-Xptxas", "-v") if verbose else ()),
                   "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu (nvcc exit {proc.returncode}):"
                          f"\n{out}")
            continue
        if verbose and out.strip():
            print(f"[nvcc {name}.cu]\n{out.strip()}")
        os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    for name, fns in SIGNATURES.items():
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in fns.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return dict(_libs)


def kernel(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building all on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_kernels()[name]


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_tensor(t: torch.Tensor, name: str,
                        memory_format=torch.contiguous_format) -> None:
    """Kernel inputs must be dense in `memory_format` and on a CUDA
    device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous(memory_format=memory_format):
        raise ValueError(f"{name}: expected a contiguous tensor"
                         + ("" if memory_format == torch.contiguous_format
                            else f" in {memory_format}"))
