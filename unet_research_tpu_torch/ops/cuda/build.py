"""Build and load the hand-written Hopper kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
by `nvcc` into `build/lib<name>-<digest>.so` beside this file (the digest
covers the source and the flags, so an edited source rebuilds), then loaded
with ctypes. Only the sources in the repository are compiled; no PyTorch
headers are involved, so a build takes seconds.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<digest>.so csrc/<name>.cu

`build()` starts one nvcc per missing library, all at once, and waits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("dropblock", "group_norm", "pair_conv", "shear_rotate", "upsample")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every library in `names` that is not built yet, in parallel.
    Returns {name: {"seconds": wall time, "log": nvcc's output}} for the
    libraries it compiled; raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return done


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def sass(name: str) -> str:
    """The SASS of the built library for csrc/<name>.cu (`cuobjdump -sass`)."""
    tool = Path(nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(library_path(name))], capture_output=True,
                          text=True, check=True).stdout


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch):
    a non-zero cudaError_t, or its negation."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {abs(status)}")
