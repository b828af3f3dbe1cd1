"""The NUTS leaf's bookkeeping as two hand-written CUDA kernels (K7).

Counterpart of no Pallas kernel: the JAX package's leaf is the body of the
``while_loop`` in ``brancher_tpu/inference/vectorized_nuts.py``, which XLA
fuses.  Here the plain leaf is ``_NutsTree.plain_leaf``
(``inference/vectorized_nuts.py``), about 90 PyTorch ops, which CPU tensors
run; on CUDA ``_NutsTree.leaf`` runs K7's head, the potential and K7's tail
(``csrc/nuts_leaf.cu``: what each computes, the bound, the design).

  * ``NUTS_LEAF.bind(buffers, max_delta_energy)``: the launch arguments over
    a tree's buffers (``BUFFERS``, by name), checked and laid out once;
  * ``NUTS_LEAF.head(args, n, dir_pos)``: a subtree's start, the half kick
    and the drift into the ``z_new`` buffer, the potential's input;
  * ``NUTS_LEAF.tail(args, n, val_new, grad_new, swap_u, take_u)``: the rest
    of the leaf, from the potential's value and gradient at ``z_new``.

n is the tree's leaf index, [1] or one a chain, given at every launch.
Both kernels launch on the current stream and allocate nothing, so a CUDA
graph captures them; ``launches`` counts the leaves (one per tail).
Float32 and float64 trees only.
"""
from __future__ import annotations

import ctypes

import torch

Tensor = torch.Tensor

_P, _I = ctypes.c_void_p, ctypes.c_int64
# the tree's buffers the kernels read or write, in csrc/nuts_leaf.cu's
# LeafArgs order
BUFFERS = ("flags", "slot", "row", "eps", "inv_mass", "z_new", "ends", "mov", "prop", "sp",
           "prop_val", "sp_val", "h0", "lw", "s_lw", "dirn", "sum_acc", "cnt", "r_sum", "s_cum",
           "s_failed", "active", "diverging", "r_ck", "rs_ck")


class _LeafArgs(ctypes.Structure):
    _fields_ = [("n", _P), ("n_stride", _I), ("flags", _P), ("flag_cols", _I), ("slot", _P),
                ("row", _P), ("eps", _P), ("inv_mass", _P), ("dir_pos", _P), ("swap_u", _P),
                ("take_u", _P), ("val_new", _P), ("grad_new", _P),
                *((f, _P) for f in BUFFERS[5:]),
                ("max_delta_energy", ctypes.c_double), ("c", _I), ("d", _I), ("kdim", _I)]


class LeafArgs:
    """K7's launch arguments over one tree's buffers (``NUTS_LEAF.bind``):
    the laid-out block, the buffers it points into, and the chains, width,
    dtype and device the launches' own tensors must match."""

    def __init__(self, block: _LeafArgs, buffers: dict):
        self.block, self.buffers = block, buffers
        self.z_new = buffers["z_new"]
        self.c, self.d = self.z_new.shape
        self.dtype, self.device = self.z_new.dtype, self.z_new.device


def tree_shapes(c: int, d: int, kdim: int, max_n: int) -> dict:
    """The shape of each tree buffer the kernels read or write."""
    cd = (c, d)
    return {"flags": (max_n + 1, 2 + kdim), "slot": (max_n + 1,), "row": (c,), "eps": (),
            "inv_mass": (d,), "z_new": cd, "ends": (2, 3, *cd), "mov": (3, *cd),
            "prop": (2, *cd), "sp": (2, *cd), "r_sum": cd, "s_cum": cd,
            "r_ck": (kdim + 1, *cd), "rs_ck": (kdim + 1, *cd),
            **{f: (c,) for f in ("prop_val", "sp_val", "h0", "lw", "s_lw", "dirn", "sum_acc",
                                 "cnt", "s_failed", "active", "diverging")}}


def _kind(field: str, dtype) -> torch.dtype:
    if field in ("flags", "s_failed", "active", "diverging"):
        return torch.bool
    if field in ("slot", "row"):
        return torch.int64
    return dtype


class NutsLeafKernel:
    """Wrapper of ``csrc/nuts_leaf.cu`` (K7): the lockstep and pipelined
    NUTS leaf's bookkeeping, float32 and float64.

    ``launches`` counts the leaves whose bookkeeping ran in the kernels:
    one per head-and-tail pair, counted at the tail.
    """

    name = "nuts_leaf"
    source = "brancher_torch/csrc/nuts_leaf.cu"
    replaces = ("none: brancher_tpu/inference/vectorized_nuts.py's leaf is XLA-fused inside "
                "its while_loop")

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _library(self):
        if self._lib is None:
            from .cuda_build import load_library

            lib = load_library("nuts_leaf")
            for fn in (lib.nuts_leaf_head, lib.nuts_leaf_tail):
                fn.argtypes = [_P, ctypes.c_int, _P]
                fn.restype = ctypes.c_int
            lib.nuts_leaf_tiling.argtypes = [_I, _P]
            lib.nuts_leaf_args_bytes.restype = _I
            if lib.nuts_leaf_args_bytes() != ctypes.sizeof(_LeafArgs):
                raise RuntimeError(f"{self.name}: the library's LeafArgs is "
                                   f"{lib.nuts_leaf_args_bytes()} bytes, the wrapper's "
                                   f"{ctypes.sizeof(_LeafArgs)}")
            self._lib = lib
        return self._lib

    def tiling(self, d: int):
        """The tail's (threads a chain, columns a thread in registers) at width d."""
        out = (ctypes.c_int * 2)()
        self._library().nuts_leaf_tiling(d, ctypes.addressof(out))
        return tuple(out)

    def bind(self, buffers: dict, max_delta_energy: float) -> LeafArgs:
        """The launch arguments over a tree's ``buffers`` (every name of
        ``BUFFERS``; C and d from ``z_new``, the checkpoint rows from
        ``r_ck``, the leaves from ``slot``); raises on a buffer of another
        dtype, shape or device, or not contiguous.  The buffers stay where
        they are for the arguments' life: the kernels read their addresses."""
        z_new = buffers["z_new"]
        dtype, dev = z_new.dtype, z_new.device
        if dev.type != "cuda":
            raise RuntimeError(f"{self.name} runs on CUDA tensors, got {dev}")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{self.name} takes a float32 or float64 tree, got {dtype}")
        c, d = z_new.shape
        kdim = buffers["r_ck"].shape[0] - 1
        block = _LeafArgs(flag_cols=2 + kdim, max_delta_energy=float(max_delta_energy),
                          c=c, d=d, kdim=kdim)
        for field, shape in tree_shapes(c, d, kdim, buffers["slot"].shape[0] - 1).items():
            t = buffers[field]
            if t.dtype != _kind(field, dtype):
                raise TypeError(f"{self.name}: {field} is {t.dtype}, not {_kind(field, dtype)}")
            if tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{self.name}: {field} must be a contiguous {shape} tensor on "
                                 f"{dev}, got {tuple(t.shape)} on {t.device}")
            setattr(block, field, t.data_ptr())
        return LeafArgs(block, {f: buffers[f] for f in BUFFERS})

    def _given(self, args: LeafArgs, n: Tensor, **given) -> None:
        c, d, dtype, dev = args.c, args.d, args.dtype, args.device
        want = {"dir_pos": ((c,), torch.bool), "swap_u": ((c,), dtype), "take_u": ((c,), dtype),
                "val_new": ((c,), dtype), "grad_new": ((c, d), dtype)}
        for field, t in given.items():
            shape, kind = want[field]
            if t.dtype != kind:
                raise TypeError(f"{self.name}: {field} is {t.dtype}, not {kind}")
            if tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{self.name}: {field} must be a contiguous {shape} tensor on "
                                 f"{dev}, got {tuple(t.shape)} on {t.device}")
            setattr(args.block, field, t.data_ptr())
        if (n.dtype != torch.int64 or tuple(n.shape) not in ((1,), (c,)) or n.device != dev
                or not n.is_contiguous()):
            raise ValueError(f"{self.name}: n must be a contiguous int64 [1] or [{c}] tensor "
                             f"on {dev}")
        # n [1]: one leaf index for every chain (stride 0); [C]: one a chain
        args.block.n, args.block.n_stride = n.data_ptr(), int(n.shape[0] != 1)

    def _launch(self, fn, args: LeafArgs) -> None:
        with torch.cuda.device(args.device):
            err = fn(ctypes.addressof(args.block), int(args.dtype == torch.float64),
                     torch.cuda.current_stream(args.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")

    def head(self, args: LeafArgs, n: Tensor, dir_pos: Tensor) -> Tensor:
        """K7's head over the tree of ``args`` at leaf index n: returns its
        ``z_new``."""
        lib = self._library()
        self._given(args, n, dir_pos=dir_pos)
        self._launch(lib.nuts_leaf_head, args)
        return args.z_new

    def tail(self, args: LeafArgs, n: Tensor, val_new: Tensor, grad_new: Tensor,
             swap_u: Tensor, take_u: Tensor) -> None:
        """K7's tail over the tree of ``args`` from the potential at its
        ``z_new``; n advances by one."""
        lib = self._library()
        self._given(args, n, val_new=val_new, grad_new=grad_new, swap_u=swap_u, take_u=take_u)
        self._launch(lib.nuts_leaf_tail, args)
        self.launches += 1


NUTS_LEAF = NutsLeafKernel()


def leaf_bytes(c: int, d: int, itemsize: int, checked_rows: int, even: bool) -> int:
    """Least bytes a live leaf's bookkeeping moves: the moving end (z, grad,
    r), grad_new, s_cum and z_new read; z_new, s_cum and the moving end
    written; an even leaf's checkpoint pair written, an odd leaf's checked
    rows read (two a row).  The swap's, the take's and the merge's writes
    depend on the draws and are left out, so the bound is a floor."""
    passes = 6 + 5 + (2 if even else 2 * checked_rows)
    return passes * c * d * itemsize


__all__ = ["BUFFERS", "LeafArgs", "NutsLeafKernel", "NUTS_LEAF", "leaf_bytes", "tree_shapes"]
