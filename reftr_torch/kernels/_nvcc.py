"""Build a kernel source of this package into a shared library and load it.

Each source under ``csrc/`` is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into ``build/<stem>-<hash>.so``, where the hash covers the
source, the headers beside it (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one is loaded as it is. The library has a plain C interface and is loaded with
``ctypes``; nothing here includes PyTorch's headers, so a build takes
seconds. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built.

    The compiler's resource report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``<name>.log``.
    """
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``, once per process."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _loaded[source] = lib
    return lib


def entry(source: str, name: str, argtypes):
    """The C entry point ``name`` of ``csrc/<source>``, built and loaded on
    first use: its arguments ``argtypes`` and then the CUDA stream, its
    result the launch's cudaError_t."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(table, name: str, device, *args) -> None:
    """Launch the C entry point ``name``, whose source and arguments
    ``table[name]`` gives (``entry``), with ``args`` on the current stream
    of the CUDA ``device``; raise if the launch failed."""
    import torch

    source, argtypes = table[name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(source, name, argtypes)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
