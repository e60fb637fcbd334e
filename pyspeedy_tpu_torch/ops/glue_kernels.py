"""The spectral update as one hand-written CUDA kernel: wrapper, binding and
dispatch.

Counterpart of the JAX package's ``tools/exp_glue.py::member_tiled_kernel``,
which runs ``models/spectral_glue.py::spectral_update`` over tiles of members
as one Pallas kernel. The kernel (``csrc/spectral_update.cu``) computes the
whole spectral side of a step in one launch for all members: the flux
combination, the linear tendencies, the semi-implicit correction, diffusion
and stratospheric drag, and the Robert-Williams leapfrog. It is built and
loaded through ``ops.column_kernels.KERNELS``; its launches are counted in
``launch_counts["spectral_update"]``.

Dispatch rule (:func:`spectral_update`), the same as for the other kernels: a
CPU tensor goes to the plain PyTorch version it is given
(``models.spectral_glue.spectral_update_plain``, which counts its calls in
``plain_calls``); a CUDA tensor launches the kernel or raises. The wrapper
never copies an input: every field is read in place through its member,
pair, level, m and n strides, so the stride-0 member axis of a freshly
broadcast state and the views of any transform route are taken as they are.
What does not have the shape the kernel expects is refused.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import constants as pc
from .column_kernels import _SUPPORTED_KX, _load, launch_counts

__all__ = ["spectral_update", "spectral_update_cuda", "kernel_levels",
           "field_strides", "plain_calls", "reset_plain_calls",
           "MAX_TRACERS"]

# kMaxTracers of the source: its argument struct holds 6 + 3*ntr spectra.
MAX_TRACERS = 4

plain_calls = {"spectral_update": 0}


def reset_plain_calls() -> None:
    for name in plain_calls:
        plain_calls[name] = 0


def field_strides(name: str, x: torch.Tensor, shape: tuple) -> list:
    """The five element strides (member, pair part, level, m, n) through
    which the kernel reads `x`: a (B, 2, levels, mx, nx) field, or a
    (B, 2, mx, nx) plane (level stride 0). Raises if `x` does not have
    `shape`."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} with strides "
                         f"{x.stride()}, expected {tuple(shape)}")
    s = list(x.stride())
    return s if x.dim() == 5 else s[:2] + [0] + s[2:]


def kernel_levels(consts) -> np.ndarray:
    """The per-level tables of the argument struct, float64 on the host in
    the order the source reads them: the column tables dhs, dhsr, tref,
    tref3; the implicit tables of this dt tref, tref2, dhsx; tcorv, qcorv;
    then xd and xc row by row."""
    col, im, hd = consts.col.levels_host, consts.implicit.levels_host, \
        consts.hd.levels_host
    kx = consts.params.kx
    return np.ascontiguousarray(np.concatenate(
        [col[0], col[1], col[3], col[4], im[:3 * kx], hd, im[3 * kx:]]))


def spectral_update_cuda(consts, j1: int, dt: float, eps: float, specs, psdt,
                         vor0, vor1, div0, div1, t0, t1, ps0, ps1, trf0, trf1,
                         phi, tcorh, qcorh):
    """Launch the spectral-update kernel on PyTorch's current stream. Same
    arguments and results as ``models.spectral_glue.spectral_update_plain``:
    the ten new state tensors (ps, vor, div, t, trf) x (lev1, lev2), dense.
    Raises if the inputs are not what the kernel takes, if the build fails
    or if the launch is refused; does not synchronise."""
    params, sp, im, hd = consts.params, consts.sp, consts.implicit, consts.hd
    kx, ntr, mx, nx = params.kx, params.ntr, sp.mx, sp.nx
    if psdt.device.type != "cuda":
        raise ValueError(f"spectral_update_cuda needs CUDA tensors, got "
                         f"{psdt.device}")
    if kx not in _SUPPORTED_KX:
        raise ValueError(f"kx={kx}: the kernel is built for kx in "
                         f"{_SUPPORTED_KX}")
    if not 1 <= ntr <= MAX_TRACERS:
        raise ValueError(f"ntr={ntr}: the kernel takes 1 to {MAX_TRACERS} "
                         f"tracers")
    if len(specs) != 6 + 3 * ntr:
        raise ValueError(f"expected {6 + 3 * ntr} flux spectra, got "
                         f"{len(specs)}")
    dtype = sp.rdtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype}: float32 or float64")
    nmem = psdt.shape[0]
    lev3, plane = (nmem, 2, kx, mx, nx), (nmem, 2, mx, nx)
    trac = (nmem, 2, ntr * kx, mx, nx)
    fields = [(f"specs[{i}]", x, lev3) for i, x in enumerate(specs)]
    fields += [("psdt", psdt, plane), ("vor0", vor0, lev3),
               ("vor1", vor1, lev3), ("div0", div0, lev3),
               ("div1", div1, lev3), ("t0", t0, lev3), ("t1", t1, lev3),
               ("ps0", ps0, plane), ("ps1", ps1, plane),
               ("trf0", trf0, trac), ("trf1", trf1, trac),
               ("phi", phi, lev3), ("tcorh", tcorh, plane),
               ("qcorh", qcorh, plane)]
    strides = []
    for name, x, shape in fields:
        if x.dtype != dtype or x.device != psdt.device:
            raise TypeError(f"{name}: {x.dtype} on {x.device}, expected "
                            f"{dtype} on {psdt.device}")
        strides += field_strides(name, x, shape)
    tables = (sp.el2, sp.trfilt, hd.dmp, hd.dmpd, hd.dmps, im.dmp1, im.dmp1d,
              im.dmp1s, im.elz, sp.vddym, sp.vddyp, sp.gradx, im.xj_klmn)
    shapes = [(mx, nx)] * 11 + [(mx,), (kx, kx, mx, nx)]
    for t, shape in zip(tables, shapes):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != psdt.device or not t.is_contiguous()):
            raise ValueError(f"the tables must be contiguous {dtype} on "
                             f"{psdt.device} of shapes {shapes}")
    fn = _load("spectral_update")

    new = lambda shape: torch.empty(shape, dtype=dtype, device=psdt.device)
    outs = (new(plane), new(plane), new(lev3), new(lev3), new(lev3),
            new(lev3), new(lev3), new(lev3), new(trac), new(trac))
    if nmem == 0:
        return outs
    ins = [x for _, x, _ in fields]
    c_in = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    c_tab = (ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables))
    c_out = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    levels = kernel_levels(consts)
    with torch.cuda.device(psdt.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(psdt.element_size(), kx, ntr, nmem, mx, nx,
                ctypes.cast(c_in, ctypes.c_void_p),
                ctypes.cast(c_strides, ctypes.c_void_p),
                ctypes.cast(c_tab, ctypes.c_void_p),
                ctypes.cast(c_out, ctypes.c_void_p),
                levels.ctypes.data_as(ctypes.c_void_p), int(j1),
                int(params.ix == params.iy * 4), float(dt),
                float(params.wil * eps), float((1.0 - params.wil) * eps),
                1.0 / (pc.TDRS * 3600.0), pc.RGAS, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"spectral_update kernel launch failed with code {rc} "
            f"(members={nmem}, kx={kx}, ntr={ntr}, mx={mx}, nx={nx}, "
            f"{dtype})")
    launch_counts["spectral_update"] += 1
    return outs


def spectral_update(plain_fn, consts, j1: int, dt: float, eps: float, specs,
                    psdt, *state):
    """The dispatch rule: CPU tensors take `plain_fn` (the plain PyTorch
    version, ``models.spectral_glue.spectral_update_plain``); CUDA tensors
    launch the kernel or raise."""
    if psdt.device.type == "cpu":
        return plain_fn(consts, j1, dt, eps, specs, psdt, *state)
    return spectral_update_cuda(consts, j1, dt, eps, specs, psdt, *state)
