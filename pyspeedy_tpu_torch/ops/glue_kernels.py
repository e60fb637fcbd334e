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
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as pc
from ..utils.profiling import span
from .column_kernels import (_SUPPORTED_KX, _destinations, _load, copy_into,
                             launch_counts)

__all__ = ["spectral_update", "spectral_update_cuda", "kernel_levels",
           "UpdateTables", "build_update_tables", "field_strides",
           "plain_calls", "reset_plain_calls", "MAX_TRACERS", "MAX_NX",
           "update_launch_plan", "library_launch_plan", "H100_SMS"]

# kMaxTracers of the source: its argument struct holds 6 + 3*ntr spectra.
MAX_TRACERS = 4
# A member lane of the kernel is one block's 2*nx points, at most 256
# threads (kLaneThreads of the source).
MAX_NX = 128
# The source's launch limits (threads an SM at 128 registers, threads a
# block: Shape<T>::threads, kMaxSmem, kSmemPerSm) and its staging
# (Shape<T>: levels a staged chunk, slots of the ring).
MAX_THREADS = 512
LANE_THREADS = 256
MAX_SMEM = 232448
SMEM_PER_SM = 233472
STAGING = {4: (8, 2), 8: (2, 3)}
# SMs of an NVIDIA H100 SXM.
H100_SMS = 132
# The (mx, nx) tables of a row in the source's order (its enum Table).
ROW_TABLES = ("el2", "trfilt", "dmp", "dmpd", "dmps", "dmp1", "dmp1d",
              "dmp1s", "elz", "vddym", "vddyp")

plain_calls = {"spectral_update": 0}


def reset_plain_calls() -> None:
    for name in plain_calls:
        plain_calls[name] = 0


def field_strides(name: str, x: torch.Tensor, shape: tuple) -> list:
    """The five element strides (member, pair part, level, m, n) through
    which the kernel reads `x`: a (B, 2, levels, mx, nx) field, or a
    (B, 2, mx, nx) plane (level stride 0). Raises if `x` does not have
    `shape`, or if the offsets inside one (member, m) row do not fit the
    kernel's 32-bit row offsets."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} with strides "
                         f"{x.stride()}, expected {tuple(shape)}")
    s = list(x.stride())
    s = s if x.dim() == 5 else s[:2] + [0] + s[2:]
    levels = shape[2] if len(shape) == 5 else 1
    if s[1] + (levels - 1) * s[2] + (shape[-1] - 1) * s[4] >= 2 ** 31:
        raise ValueError(f"{name}: strides {tuple(x.stride())}: the offsets "
                         f"inside a row exceed 32 bits")
    return s


def update_launch_plan(nx: int, mx: int, kx: int, ntr: int, itemsize: int,
                       nmem: int, sms: int = H100_SMS) -> dict:
    """The kernel's launch plan (``plan`` in csrc/spectral_update.cu) for
    `nmem` members of `ntr` tracers at (mx, nx, kx) in the scalar type of
    `itemsize` bytes on a card of `sms` SMs:

    * ``pslots``: the threads of a member lane, one m row of one member
      (2 nx points: both pair parts, all n) rounded up to a warp; a lane
      synchronises on a named barrier of its own;
    * ``lanes``: G, as many lanes as fit 256 threads and the shared memory
      (``smem``: the row's tables and each lane's ring of staged chunks of
      its member's flux spectra, bytes); ``threads`` = G pslots;
    * ``blocks_per_sm``: by 16 warps of 128 registers and by the shared
      memory (1 KiB of each block is the system's);
    * the grid is (mx, ``tiles``): block (m, t) takes m row m of members t
      tile .. (t + 1) tile - 1, G at a time; a tile of 16 members (the
      kernel's first member-tiled design's fixed tile) would make W waves of sms blocks_per_sm blocks, rounded up;
      each m row gets floor(W sms blocks_per_sm / mx) blocks (at least
      one), which share its ceil(nmem / G) member groups equally: ``tile``
      = G ceil(groups / that); ``blocks`` = mx tiles, at most W waves."""
    chunk, ring = STAGING[itemsize]
    pslots = -(-2 * nx // 32) * 32
    if pslots > LANE_THREADS:
        raise ValueError(f"a lane of the spectral update at nx={nx} does "
                         f"not fit a block")
    row_len = 11 * nx + 1 + kx * kx * nx
    slot_len = (4 + 2 * ntr) * min(chunk, kx) * 2 * nx
    g = LANE_THREADS // pslots
    smem = lambda g: (row_len + ring * g * slot_len) * itemsize
    while g > 1 and smem(g) > MAX_SMEM:
        g -= 1
    if smem(g) > MAX_SMEM:
        raise ValueError(f"no lane of the spectral update fits a block at "
                         f"nx={nx}, kx={kx}, ntr={ntr}")
    threads = g * pslots
    bps = min((MAX_THREADS // 32) // (threads // 32),
              SMEM_PER_SM // (smem(g) + 1024))
    slots = sms * bps
    waves = -(-mx * -(-nmem // 16) // slots)
    per_row = max(1, waves * slots // mx)
    tile = -(-(-(-nmem // g)) // per_row) * g
    tiles = -(-nmem // tile)
    return {"lanes": g, "pslots": pslots, "threads": threads,
            "smem": smem(g), "blocks_per_sm": bps, "tile": tile,
            "tiles": tiles, "blocks": mx * tiles}


_PLAN_KEYS = ("lanes", "threads", "smem", "blocks_per_sm", "tile", "tiles",
              "blocks")


def library_launch_plan(itemsize: int, kx: int, ntr: int, nx: int, mx: int,
                        nmem: int, sms: int = H100_SMS) -> dict:
    """The launch plan as the built library reports it
    (``pyspeedy_spectral_update_plan``; builds it at first use, needs no
    device): the keys of :func:`update_launch_plan` but ``pslots``."""
    from .column_kernels import build_kernels
    lib = ctypes.CDLL(str(build_kernels(["spectral_update"])[
        "spectral_update"]))
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    rc = lib.pyspeedy_spectral_update_plan(
        itemsize, kx, ntr, nx, mx, ctypes.c_longlong(nmem), sms, out)
    if rc != 0:
        raise RuntimeError(f"the spectral_update plan query failed with {rc}")
    return dict(zip(_PLAN_KEYS, out))


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


class UpdateTables(NamedTuple):
    """What the kernel reads besides the fields, for one set of spectral,
    diffusion, implicit and column tables."""

    # (mx, 11*nx + 1 + kx*kx*nx): for each m row, contiguous, the eleven
    # (mx, nx) tables in ROW_TABLES order, gradx, and the implicit inverses
    # of the row laid out (kx, kx, nx); on the consts' device.
    rows: torch.Tensor
    levels: np.ndarray   # kernel_levels in the model's scalar type


def build_update_tables(consts) -> UpdateTables:
    """The kernel's tables for `consts`. Read through
    ``Consts.update_tables``, which builds them once per Consts: each
    start-up time step (``with_implicit``) has its own."""
    sp, hd, im = consts.sp, consts.hd, consts.implicit
    src = {"el2": sp.el2, "trfilt": sp.trfilt, "dmp": hd.dmp,
           "dmpd": hd.dmpd, "dmps": hd.dmps, "dmp1": im.dmp1,
           "dmp1d": im.dmp1d, "dmp1s": im.dmp1s, "elz": im.elz,
           "vddym": sp.vddym, "vddyp": sp.vddyp}
    mx = sp.mx
    tabs = torch.stack([src[name] for name in ROW_TABLES], dim=1)
    xj = im.xj_mn.permute(0, 2, 3, 1)            # (mx, kx, kx, nx)
    rows = torch.cat([tabs.reshape(mx, -1), sp.gradx.reshape(mx, 1),
                      xj.reshape(mx, -1)], dim=1).contiguous()
    np_dtype = np.float64 if sp.rdtype == torch.float64 else np.float32
    return UpdateTables(rows, kernel_levels(consts).astype(np_dtype))


def spectral_update_cuda(consts, j1: int, dt: float, eps: float, specs, psdt,
                         vor0, vor1, div0, div1, t0, t1, ps0, ps1, trf0, trf1,
                         phi, tcorh, qcorh, out=None):
    """Launch the spectral-update kernel on PyTorch's current stream. Same
    arguments and results as ``models.spectral_glue.spectral_update_plain``:
    the ten new state tensors (ps, vor, div, t, trf) x (lev1, lev2), dense.
    `out`, when given, is ten dense tensors of those shapes that the kernel
    stores into and that come back; they may be the state inputs
    themselves: every point of the ten outputs is stored by the thread that
    read that point of ps, vor, div, t and trf at both time levels, after
    it read them (csrc/spectral_update.cu, finish and streamed), and no
    thread reads another point of them. Raises if the inputs are not what
    the kernel takes (checked before anything else), if they do not lie on
    a CUDA device, if the build fails or if the launch is refused; does not
    synchronise."""
    params, sp = consts.params, consts.sp
    kx, ntr, mx, nx = params.kx, params.ntr, sp.mx, sp.nx
    if kx not in _SUPPORTED_KX:
        raise ValueError(f"kx={kx}: the kernel is built for kx in "
                         f"{_SUPPORTED_KX}")
    if not 1 <= ntr <= MAX_TRACERS:
        raise ValueError(f"ntr={ntr}: the kernel takes 1 to {MAX_TRACERS} "
                         f"tracers")
    if nx > MAX_NX:
        raise ValueError(f"nx={nx}: a member lane of the kernel is one block "
                         f"of 2*nx points, so nx is at most {MAX_NX}")
    if len(specs) != 6 + 3 * ntr:
        raise ValueError(f"expected {6 + 3 * ntr} flux spectra, got "
                         f"{len(specs)}")
    dtype = sp.rdtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype}: float32 or float64")
    nmem = psdt.shape[0]
    lev3, plane = (nmem, 2, kx, mx, nx), (nmem, 2, mx, nx)
    trac = (nmem, 2, ntr * kx, mx, nx)
    ins = (*specs, psdt, vor0, vor1, div0, div1, t0, t1, ps0, ps1, trf0,
           trf1, phi, tcorh, qcorh)
    shapes = ((lev3,) * len(specs) + (plane, lev3, lev3, lev3, lev3, lev3,
                                      lev3, plane, plane, trac, trac, lev3,
                                      plane, plane))
    strides = []
    for n, (x, shape) in enumerate(zip(ins, shapes)):
        if x.dtype != dtype or x.device != psdt.device:
            raise TypeError(f"{_input_name(n, len(specs))}: {x.dtype} on "
                            f"{x.device}, expected {dtype} on {psdt.device}")
        strides += field_strides(_input_name(n, len(specs)), x, shape)
    if psdt.device.type != "cuda":
        raise ValueError(f"spectral_update_cuda needs CUDA tensors, got "
                         f"{psdt.device}")
    rows, levels = consts.update_tables
    if rows.device != psdt.device:
        raise ValueError(f"the tables lie on {rows.device}, the fields on "
                         f"{psdt.device}")
    fn = _load("spectral_update")

    out_shapes = (plane, plane, lev3, lev3, lev3, lev3, lev3, lev3, trac,
                  trac)
    if out is None:
        outs = tuple(torch.empty(shape, dtype=dtype, device=psdt.device)
                     for shape in out_shapes)
    else:
        outs = _destinations(out, out_shapes, psdt, "out")
    if nmem == 0:
        return outs
    c_in = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    c_out = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    with torch.cuda.device(psdt.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(psdt.element_size(), kx, ntr, nmem, mx, nx, c_in, c_strides,
                rows.data_ptr(), c_out, levels.ctypes.data, int(j1),
                int(params.ix == params.iy * 4), float(dt),
                float(params.wil * eps), float((1.0 - params.wil) * eps),
                1.0 / (pc.TDRS * 3600.0), pc.RGAS, stream)
    if rc != 0:
        raise RuntimeError(
            f"spectral_update kernel launch failed with code {rc} "
            f"(members={nmem}, kx={kx}, ntr={ntr}, mx={mx}, nx={nx}, "
            f"{dtype})")
    launch_counts["spectral_update"] += 1
    return outs


_STATE_NAMES = ("psdt", "vor0", "vor1", "div0", "div1", "t0", "t1", "ps0",
                "ps1", "trf0", "trf1", "phi", "tcorh", "qcorh")


def _input_name(n: int, nspecs: int) -> str:
    return f"specs[{n}]" if n < nspecs else _STATE_NAMES[n - nspecs]


def spectral_update(plain_fn, consts, j1: int, dt: float, eps: float, specs,
                    psdt, *state, out=None):
    """The dispatch rule: CPU tensors take `plain_fn` (the plain PyTorch
    version, ``models.spectral_glue.spectral_update_plain``); CUDA tensors
    launch the kernel or raise. With `out` (ten tensors, see
    spectral_update_cuda) the results land there and `out` comes back: the
    kernel stores into it, the plain version's results are copied in.
    Under the span `spectral_update`."""
    with span("spectral_update"):
        if psdt.device.type == "cpu":
            res = plain_fn(consts, j1, dt, eps, specs, psdt, *state)
            return res if out is None else copy_into(out, res)
        return spectral_update_cuda(consts, j1, dt, eps, specs, psdt, *state,
                                    out=out)

