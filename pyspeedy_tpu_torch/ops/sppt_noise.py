"""SPPT's noise: wrapper of the hand-written CUDA kernel in
``csrc/sppt_noise.cu``.

The kernel draws the clipped standard normals of the JAX package's stream
(physics/sppt.py), scaled by SPPT's amplitude table, in one launch for a
chunk of rows: each row's key folded in registers, each element's threefry2x32
words and JAX's map to a normal computed where they are stored. It replaces
no Pallas kernel (the JAX package draws with ``jax.random``); the plain
version, with the same bits, is ``physics/sppt.py::draw_noise_plain``.

Dispatch rule (physics/sppt.py: ``draw_noise``, ``stationary_draw``,
``gen_sppt_n`` and the runner's chunks): a CPU tensor takes the plain
passes, a CUDA tensor launches the kernel or raises. The kernel's launches
are counted in ``ops.column_kernels.launch_counts["sppt_noise"]``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .column_kernels import _load, launch_counts

__all__ = ["NO_FOLD", "map_constants", "step_table", "sppt_noise_cuda"]

# A table entry's fold data that leaves the row's key as it is.
NO_FOLD = -1

_NP_TYPES = {torch.float32: np.float32, torch.float64: np.float64}


def map_constants(dtype) -> tuple:
    """(lo, span, sqrt2) of jax.random.normal's map from bits to a normal
    in `dtype`: lo = nextafter(-1, 0), span = 1 - lo and sqrt(2), each
    rounded to `dtype` as JAX rounds them, as Python floats. Raises for a
    type other than float32 and float64."""
    npdt = _NP_TYPES.get(dtype)
    if npdt is None:
        raise ValueError(f"SPPT noise in float32 or float64, not {dtype}")
    lo = np.nextafter(npdt(-1.0), npdt(0.0), dtype=npdt)
    return float(lo), float(npdt(1.0) - lo), float(npdt(math.sqrt(2)))


def step_table(data, offset) -> np.ndarray:
    """The kernel's table of a chunk: (steps, 2) int64 rows of the fold
    data of each step's key (NO_FOLD for none) and the index of its first
    element in its group's draw."""
    return np.stack([np.asarray(data, dtype=np.int64),
                     np.asarray(offset, dtype=np.int64)], axis=-1)


def _scale_size(scale, shape, dtype, device) -> int:
    """The number of values of `scale`, which must broadcast against the
    trailing dimensions of `shape` as a dense table of them (leading 1s
    apart); raises otherwise."""
    dims = list(scale.shape)
    while dims and dims[0] == 1:
        dims.pop(0)
    trailing = tuple(shape)[len(shape) - len(dims):] if dims else ()
    if (len(dims) > len(shape) or tuple(dims) != trailing
            or scale.dtype != dtype or scale.device != device
            or not scale.is_contiguous()):
        raise ValueError(
            f"scale: {tuple(scale.shape)} {scale.dtype} on {scale.device}, "
            f"expected a contiguous {dtype} table of the trailing dimensions "
            f"of {tuple(shape)} on {device}")
    return max(1, math.prod(dims))


def sppt_noise_cuda(keys: torch.Tensor, table, shape, dtype,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the SPPT noise kernel on PyTorch's current stream: for member
    b's key keys[b] ((B, 2) int64 holding uint32 words) and step s's table
    row (fold data or NO_FOLD, offset), the clipped normals of the key
    folded with the data at element indices offset + e, e over `shape`
    (row-major), times `scale` (a table of shape's trailing dimensions, or
    None). `table` is (S, 2), shared by the members, or (B, S, 2): int64 on
    the keys' device, or host data (step_table), copied there without a
    synchronisation. Returns (B, S, *shape) in `dtype`. Raises for what the
    kernel does not take (a type other than float32 or float64 among them),
    if the build fails or if the launch is refused; does not synchronise."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"sppt_noise_cuda needs CUDA tensors, got {dev}")
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys: {tuple(keys.shape)} {keys.dtype}, expected "
                         f"(members, 2) int64")
    lo, span, sqrt2 = map_constants(dtype)
    if not torch.is_tensor(table):
        table = torch.from_numpy(np.ascontiguousarray(table, dtype=np.int64))
        table = table.pin_memory().to(dev, non_blocking=True)
    nb = keys.shape[0]
    if (table.dim() not in (2, 3) or table.shape[-1] != 2
            or (table.dim() == 3 and table.shape[0] != nb)
            or table.dtype != torch.int64 or table.device != dev
            or not table.is_contiguous()):
        raise ValueError(
            f"table: {tuple(table.shape)} {table.dtype} on {table.device}, "
            f"expected a contiguous int64 (steps, 2) or ({nb}, steps, 2) on "
            f"{dev}")
    ns = table.shape[-2]
    per = math.prod(shape)
    nscale = 0 if scale is None else _scale_size(scale, shape, dtype, dev)
    out = torch.empty((nb, ns, *shape), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    keys = keys.contiguous()
    fn = _load("sppt_noise")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(out.element_size(), nb, ns, per, keys.data_ptr(),
                table.data_ptr(), int(table.dim() == 3),
                None if scale is None else scale.data_ptr(), nscale,
                lo, span, sqrt2, out.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"sppt_noise kernel launch failed with code {rc} (members={nb}, "
            f"steps={ns}, elements a row={per}, {dtype})")
    launch_counts["sppt_noise"] += 1
    return out
