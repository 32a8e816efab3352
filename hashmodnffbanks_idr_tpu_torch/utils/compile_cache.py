"""The kernel build cache.

Counterpart of ``hashmodnffbanks_idr_tpu/utils/compile_cache.py``, whose
persistent XLA cache lets every process after the first start without
compiling.  The port's compiled artifacts are its CUDA libraries, each
built by ``nvcc`` once per source content (``build_library``, called by
``ops/fused_mlp.py`` and ``ops/graph_loops.py``).  Their directory is this
cache: ``HMNFFB_COMPILE_CACHE``
(the JAX module's variable) when set, else ``build/`` at the repository
root (git-ignored).  ``build_once`` is the policy for a process group:
rank 0 builds while the other ranks wait at a barrier, then they load
what it built.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, TypeVar

import torch.distributed as dist

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build"
_dir: Optional[Path] = None

T = TypeVar("T")


def cache_dir() -> Path:
    """The build directory in force: the last ``enable_compile_cache``
    path, else ``HMNFFB_COMPILE_CACHE``, else ``build/``."""
    if _dir is not None:
        return _dir
    return Path(os.environ.get("HMNFFB_COMPILE_CACHE") or DEFAULT_DIR)


def enable_compile_cache(path: Optional[str] = None) -> str:
    """Fix the build directory (``path``, else ``cache_dir()``), create it
    and return it."""
    global _dir
    _dir = Path(path) if path else cache_dir()
    _dir.mkdir(parents=True, exist_ok=True)
    return str(_dir)


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME``
    (``/usr/local/cuda`` by default)."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(src: Path, stem: str) -> Path:
    """Where ``build_library`` puts the library of ``src`` as it is now
    (one per source content); ``-Xptxas -v``'s report of its build lies
    beside it, with the suffix ``.ptxas.txt``."""
    return cache_dir() / f"lib{stem}_{hashlib.sha256(src.read_bytes()).hexdigest()[:12]}.so"


def build_library(src: Path, stem: str) -> Path:
    """Build the CUDA source ``src`` for ``sm_90a`` into a shared library
    with a plain C interface (once per source content) and return its path."""
    out = library_path(src, stem)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({res.returncode}):\n{res.stderr}")
        out.with_suffix(".ptxas.txt").write_text(res.stderr)
        os.replace(tmp, out)
    return out


def build_once(build: Callable[[], T]) -> T:
    """``build()`` on every rank of the process group, rank 0 first: the
    others wait at a barrier until rank 0's build is in the cache, so a
    single ``nvcc`` runs.  Without a process group it just builds."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return build()
    first = dist.get_rank() == 0
    out = build() if first else None
    dist.barrier()
    return out if first else build()
