"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), at its
first use in a process:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/pdebench_tpu_torch/lib<name>-<hash>.so

The library lands in `build/pdebench_tpu_torch/` beside the package (a
directory git ignores), named by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
Wrappers pass tensor pointers (`data_ptr()`) and PyTorch's current CUDA
stream as `ctypes.c_void_p`; every C entry point returns a `cudaError_t`,
which `check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pdebench_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / spill report) of each library built
# in this process
BUILD_LOG: Dict[str, str] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from csrc/ at first use"
        )
    return found


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True,
                text=True,
            )
            BUILD_LOG[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name}:\n{BUILD_LOG[name]}"
                )
            # atomic: concurrent builders never load a half-written file
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.pdb_error_string.argtypes = [ctypes.c_int]
        lib.pdb_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.pdb_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def current_stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
