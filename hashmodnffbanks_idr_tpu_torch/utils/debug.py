"""Numerical-safety debugging: find where a NaN or an infinity appears.

Counterpart of ``hashmodnffbanks_idr_tpu/utils/debug.py`` (:27-63).  Off
unless ``HMNFFB_DEBUG_NANS=1`` (or ``debug=True``), because each check
reads a flag back from the device:

  * :func:`nan_guard` wraps a function (a train step, a render): its body
    runs under ``torch.autograd.detect_anomaly``, so a backward that makes
    a NaN raises naming its autograd function and the forward op that
    recorded it, and every tensor it returns is checked and named on
    failure;
  * :func:`assert_finite` checks one tensor in place in model code;
  * :func:`enable_debug_nans` turns anomaly detection on process-wide.

:func:`deterministic` runs a block with PyTorch's deterministic algorithms,
so that two runs of a step on the card give the same bits.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from functools import wraps
from typing import Iterator, Tuple

import torch


def debug_enabled() -> bool:
    return os.environ.get("HMNFFB_DEBUG_NANS") == "1"


def enable_debug_nans(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on)


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` for a block.  On the card the
    hash grid's ``index_select`` backward then sums without atomics, which
    otherwise part two runs of a step after a few steps; cuBLAS's warning
    about its workspace is silenced (one stream keeps it deterministic)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def _check(x: torch.Tensor, name: str) -> None:
    finite = torch.isfinite(x)
    if not bool(finite.all()):
        n_nan = int(torch.isnan(x).sum())
        raise FloatingPointError(
            f"non-finite values in {name}: {n_nan} NaN and {int((~finite).sum()) - n_nan} "
            f"infinite of {x.numel()} ({tuple(x.shape)}, {x.dtype}, {x.device})")


def assert_finite(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Raise ``FloatingPointError`` naming ``name`` when ``x`` holds a NaN or
    an infinity (no-op unless ``HMNFFB_DEBUG_NANS=1``); returns ``x``."""
    if debug_enabled() and x.is_floating_point():
        _check(x, name)
    return x


def _tensors(out, path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    if torch.is_tensor(out):
        yield path, out
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _tensors(v, f"{path}[{k!r}]")
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _tensors(v, f"{path}[{i}]")


def nan_guard(fn, debug: bool | None = None):
    """``fn`` under anomaly detection with its outputs checked, when
    debugging is on; ``fn`` itself otherwise."""
    if debug is None:
        debug = debug_enabled()
    if not debug:
        return fn

    @wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.autograd.detect_anomaly(check_nan=True):
            out = fn(*args, **kwargs)
        for name, t in _tensors(out, getattr(fn, "__name__", "output")):
            if t.is_floating_point():
                _check(t.detach(), name)
        return out

    return wrapper
