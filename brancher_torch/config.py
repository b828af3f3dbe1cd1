"""Runtime configuration: the default device, dtype and seed.

Counterpart of ``brancher_tpu/config.py``.  The JAX package's config
describes mesh axis names and a PRNG key policy; here it names the device
every entry point runs on unless its caller says otherwise, and the seed
of the ``torch.Generator`` an entry point makes when none is given.

Entry points default to ``"cuda"``.  Where CUDA is absent they raise
instead of carrying on quietly on the CPU; the CPU is used only when a
caller asks for it (``device="cpu"``), as the tests do.

``set_dtype`` and ``enable_nan_checks`` are JAX's (lines 49-62).
``enable_nan_checks`` turns on ``torch.autograd.set_detect_anomaly``, which
raises where a backward pass produces a NaN; JAX's ``jax_debug_nans``
raises at any primitive, forward ones too (a documented deviation).  The
mesh axis names wait for the parallelism item (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


@dataclasses.dataclass
class RuntimeConfig:
    """Defaults read by the entry points.

    Attributes:
      device: where models compile and samplers run when no ``device`` is
        passed.
      dtype: floating dtype of parameters, latents and data.
      seed: seed of the generator an entry point makes when it is given
        none.
    """

    device: str = "cuda"
    dtype: torch.dtype = torch.float32
    seed: int = 0


config = RuntimeConfig()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` or the default, a bare
    "cuda" resolved to the current card ("cuda:0"), so that every cache keyed
    by the device agrees.

    Raises when the result is a CUDA device and CUDA is not available, so
    that no run falls back to the CPU without being asked to.
    """
    dev = torch.device(config.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default is "
            f"{config.device!r}) but CUDA is not available; pass "
            "device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_generator(
    seed: Union[int, torch.Generator, None], device: torch.device
) -> torch.Generator:
    """A generator on ``device``: ``seed`` itself when it is one, else a
    new one seeded with ``seed`` (or ``config.seed``)."""
    if isinstance(seed, torch.Generator):
        if seed.device.type != torch.device(device).type:
            raise ValueError(
                f"generator lives on {seed.device}, the run on {device}"
            )
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(config.seed if seed is None else int(seed))
    return gen


def set_dtype(dtype) -> None:
    """Set the default floating dtype: a ``torch.dtype`` or a name
    ("float32", "bfloat16", ...), or a numpy dtype."""
    if not isinstance(dtype, torch.dtype):
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        dtype = getattr(torch, name, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype {name!r}")
    config.dtype = dtype


def default_dtype() -> torch.dtype:
    return config.dtype


def enable_nan_checks(on: bool = True) -> None:
    """Debug aid: raise at the first backward-pass operation that yields a
    NaN, with a traceback into the forward operation that made it
    (``torch.autograd.set_detect_anomaly``)."""
    torch.autograd.set_detect_anomaly(bool(on))
