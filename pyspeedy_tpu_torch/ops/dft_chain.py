"""The latitude-tiled DFT chain: wrapper of the hand-written CUDA kernel in
``csrc/dft_chain.cu`` and its plain PyTorch version.

Counterpart of the JAX package's ``tools/exp_dft_kernel.py``
(``make_pallas_step`` over ``pallas_kernel_dot`` / ``pallas_kernel_mul``): a
zonal inverse DFT of ``nf`` fields of Fourier pairs, an elementwise chain that
mixes the fields at each grid point, and the forward DFT back, inside one
kernel. It is a diagnostic of how a kernel carries the zonal DFT, not a part
of the model's step. The kernel is built for the tool's one shape
(``NFIELDS`` fields, ``IL`` latitudes, ``MX`` wavenumbers, ``IX``
longitudes; any member and level count) and folds both DFTs by half a
period: float32 on FFMA, float64 on the FP64 tensor cores (the design is in
the source's note). ``make_tables`` and ``chain`` are this package's own
copies of the tool's (a package module imports no tool).

Dispatch rule (:func:`dft_chain`), the same as for the other kernels: a CPU
tensor goes to the plain version, a CUDA tensor launches the kernel or
raises. The plain version counts its calls in ``plain_calls``; the kernel's
launches are counted in ``ops.column_kernels.launch_counts["dft_chain"]``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .column_kernels import _load, launch_counts

__all__ = ["make_tables", "device_tables", "chain", "dft_chain",
           "dft_chain_cuda", "dft_chain_plain", "plain_calls",
           "reset_plain_calls", "KX", "IL", "IX", "MX", "NFIELDS"]

# The tool's shapes: T30 (96 longitudes, 31 zonal wavenumbers, 48 latitudes),
# 8 levels, 6 fields.
KX, IL, IX, MX = 8, 48, 96, 31
NFIELDS = 6

plain_calls = {"dft_chain": 0}


def reset_plain_calls() -> None:
    for name in plain_calls:
        plain_calls[name] = 0


def make_tables(dtype):
    """The four DFT tables as numpy arrays of `dtype`: inv_re, inv_im
    (MX, IX), fwd_re, fwd_im (IX, MX)."""
    theta = 2.0 * np.pi * np.outer(np.arange(IX), np.arange(MX)) / IX
    dup = np.where(np.arange(MX) == 0, 1.0, 2.0)
    inv_re = (dup[:, None] * np.cos(theta).T).astype(dtype)   # (MX, IX)
    inv_im = (-dup[:, None] * np.sin(theta).T).astype(dtype)
    fwd_re = (np.cos(theta) / IX).astype(dtype)               # (IX, MX)
    fwd_im = (-np.sin(theta) / IX).astype(dtype)
    return inv_re, inv_im, fwd_re, fwd_im


def device_tables(dtype, device):
    """make_tables as contiguous tensors of `dtype` on `device`."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in make_tables(np_dtype))


def chain(gs):
    """The elementwise chain across the fields at each grid point: the mean
    of the squares in field order, then a tanh, a floor at -3 and a decaying
    exponential."""
    acc = 0.0
    for g in gs:
        acc = acc + g * g
    acc = acc / len(gs)
    out = []
    for g in gs:
        h = g + 0.1 * torch.tanh(acc) - 0.01 * g * acc
        h = torch.clamp_min(h, -3.0) + torch.exp(-torch.abs(g)) * 0.05
        out.append(h)
    return out


def dft_chain_plain(tabs, fre: torch.Tensor, fim: torch.Tensor):
    """Plain version (the tool's ``xla_step`` with a member axis): Fourier
    pairs (B, nf, kx, il, mx) -> the chained pairs of the same shape, by
    matrix products."""
    plain_calls["dft_chain"] += 1
    inv_re, inv_im, fwd_re, fwd_im = tabs
    nf = fre.shape[1]
    gs = chain([fre[:, i] @ inv_re + fim[:, i] @ inv_im for i in range(nf)])
    return (torch.stack([g @ fwd_re for g in gs], dim=1),
            torch.stack([g @ fwd_im for g in gs], dim=1))


def dft_chain_cuda(tabs, fre: torch.Tensor, fim: torch.Tensor):
    """Launch the DFT-chain kernel on PyTorch's current stream. Same
    arguments and results as dft_chain_plain, at the tool's shape: Fourier
    pairs (members, NFIELDS, levels, IL, MX), tables of IX longitudes; every
    tensor dense and of one type (float32 or float64). Raises on anything
    else, before anything is built; does not synchronise."""
    if (fre.dim() != 5 or (fre.shape[1], fre.shape[3], fre.shape[4])
            != (NFIELDS, IL, MX) or tabs[0].dim() != 2
            or tabs[0].shape[1] != IX):
        raise ValueError(
            f"the DFT-chain kernel is built for the tool's shape: fre "
            f"(members, {NFIELDS}, levels, {IL}, {MX}) and {IX} longitudes, "
            f"got fre {tuple(fre.shape)} and inv_re {tuple(tabs[0].shape)}")
    if fre.device.type != "cuda":
        raise ValueError(f"dft_chain_cuda needs CUDA tensors, got "
                         f"{fre.device}")
    if fre.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {fre.dtype}: float32 or float64")
    nmem, nf, kx, il, mx = fre.shape
    ix = IX
    want = [("fre", fre, fre.shape), ("fim", fim, fre.shape),
            ("inv_re", tabs[0], (mx, ix)), ("inv_im", tabs[1], (mx, ix)),
            ("fwd_re", tabs[2], (ix, mx)), ("fwd_im", tabs[3], (ix, mx))]
    for name, x, shape in want:
        if (tuple(x.shape) != tuple(shape) or x.dtype != fre.dtype
                or x.device != fre.device or not x.is_contiguous()):
            raise ValueError(
                f"{name}: {tuple(x.shape)} {x.dtype} on {x.device} with "
                f"strides {x.stride()}, expected a contiguous "
                f"{tuple(shape)} {fre.dtype} on {fre.device}")
    fn = _load("dft_chain")
    ore, oim = torch.empty_like(fre), torch.empty_like(fre)
    if fre.numel() == 0:
        return ore, oim
    ptrs = [x.data_ptr() for _, x, _ in want] + [ore.data_ptr(),
                                                  oim.data_ptr()]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(fre.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(fre.element_size(), nmem, nf, kx, il, mx, ix,
                ctypes.cast(c_ptrs, ctypes.c_void_p), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"dft_chain kernel launch failed with code {rc} (members={nmem}, "
            f"nf={nf}, kx={kx}, il={il}, mx={mx}, ix={ix}, {fre.dtype})")
    launch_counts["dft_chain"] += 1
    return ore, oim


def dft_chain(tabs, fre: torch.Tensor, fim: torch.Tensor):
    """CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if fre.device.type == "cpu":
        return dft_chain_plain(tabs, fre, fim)
    return dft_chain_cuda(tabs, fre, fim)
