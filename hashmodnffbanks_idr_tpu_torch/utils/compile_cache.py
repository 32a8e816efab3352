"""The kernel build cache.

Counterpart of ``hashmodnffbanks_idr_tpu/utils/compile_cache.py``, whose
persistent XLA cache lets every process after the first start without
compiling.  The port's compiled artifact is the CUDA kernel library,
built by ``nvcc`` once per source content (``ops/fused_mlp.py:
load_library``).  Its directory is this cache: ``HMNFFB_COMPILE_CACHE``
(the JAX module's variable) when set, else ``build/`` at the repository
root (git-ignored).  ``build_once`` is the policy for a process group:
rank 0 builds while the other ranks wait at a barrier, then they load
what it built.
"""

from __future__ import annotations

import os
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
