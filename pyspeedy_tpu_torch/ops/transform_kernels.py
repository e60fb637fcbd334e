"""Fused spectral transforms: wrappers of the hand-written CUDA kernels in
``csrc/fused_transform.cu`` and their plain PyTorch versions.

Counterpart of the JAX package's ``tools/exp_fused_transform.py``
(``fused_grid2spec``, ``fused_spec2grid``) and ``tools/exp_fused_probe.py``
(``probe``). A kernel runs the zonal DFT and the Legendre transform of a field
row in one launch and keeps the Fourier intermediate in shared memory; its
Legendre stage works on the ``(il, mx, nx)`` operator, one block per zonal
wavenumber.

Dispatch rule (:func:`fused_grid2spec`, :func:`fused_spec2grid`,
:func:`fused_probe`), the same as for the column kernels: a CPU tensor goes
to the plain version, a CUDA tensor launches the kernel or raises. There is
no fallback from the kernel to the plain version on the card, and the wrapper
never copies a tensor into another layout: what the kernel cannot address by
member, pair and row strides is refused. ``ops.spectral.grid2spec_p`` and
``spec2grid_p`` come here on the dense route (``sp.use_matmul_fft and
sp.use_dense_legendre``); the ``torch.fft`` route and the einsum route of the
larger truncations are routes of their own and are not plain versions of
these kernels.

The plain versions are the dense matmul chain: two DFT products and two
products against the zero-padded block-diagonal Legendre matrix
(``leg_*_dense``). On the card that chain is also the one library yardstick
there is for these kernels. ``plain_chain_calls`` counts its calls, so a run
can show that it never took the chain on the card.

A bfloat16 grid (the ``bf16_tendencies`` configuration, float32 tables only)
takes the 2-byte operand mode of the direct transform: DFT and Legendre
tables rounded to bfloat16, float32 accumulation, the Fourier intermediate
rounded to bfloat16, float32 result.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .column_kernels import _load, launch_counts

__all__ = ["fused_grid2spec", "fused_spec2grid", "fused_probe",
           "fused_grid2spec_cuda", "fused_spec2grid_cuda", "fused_probe_cuda",
           "grid2spec_plain", "spec2grid_plain", "probe_plain",
           "plain_chain_calls", "reset_plain_chain_calls", "PROBE_STAGES"]

# The probes: the stages of the direct transform alone, real part only.
PROBE_STAGES = (0, 1, 2, 3)

# Largest dynamic shared memory a block may ask for on sm_90.
_MAX_SHARED = 232448
_KIND_DIRECT, _KIND_INVERSE, _KIND_PROBE0 = 0, 1, 2
_MODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_LAT_TILE = 6    # kLatTile of the source: il must be a multiple

plain_chain_calls = {"grid2spec": 0, "spec2grid": 0}


def reset_plain_chain_calls() -> None:
    for name in plain_chain_calls:
        plain_chain_calls[name] = 0


# ---------------------------------------------------------------------------
# Plain versions: the dense matmul chain
# ---------------------------------------------------------------------------

def _leg_dir_dense(sp, F: torch.Tensor, table=None) -> torch.Tensor:
    """Fourier (..., il, mx) -> spectral (..., mx, nx) as ONE flat matmul
    against the block-diagonal dense operator."""
    x = F.reshape(*F.shape[:-2], sp.il * sp.mx)
    table = sp.leg_dir_dense if table is None else table
    return (x @ table).reshape(*F.shape[:-2], sp.mx, sp.nx)


def _leg_inv_dense(sp, S: torch.Tensor) -> torch.Tensor:
    """Spectral (..., mx, nx) -> Fourier (..., il, mx) as ONE flat matmul."""
    x = S.reshape(*S.shape[:-2], sp.mx * sp.nx)
    return (x @ sp.leg_inv_dense).reshape(*S.shape[:-2], sp.il, sp.mx)


def _check_bf16(sp):
    if sp.rdtype != torch.float32:
        raise TypeError(
            f"a bfloat16 grid needs float32 transform tables (the 2-byte "
            f"operand mode accumulates and returns float32), got {sp.rdtype}")


def grid2spec_plain(sp, grid: torch.Tensor, pdim: int = 0) -> torch.Tensor:
    """Plain version of the direct transform: grid (..., il, ix) -> spectral
    pair with the pair axis at `pdim`, by four matrix products.

    A bfloat16 grid takes the 2-byte operand chain as the JAX package writes
    it: bfloat16 x bfloat16 products accumulated in float32 (the widened
    operands multiply exactly in float32), the Fourier intermediate rounded
    to bfloat16, the Legendre table rounded to bfloat16, float32 result."""
    plain_chain_calls["grid2spec"] += 1
    if grid.dtype != torch.bfloat16:
        return torch.stack([_leg_dir_dense(sp, grid @ sp.dft_fwd_re),
                            _leg_dir_dense(sp, grid @ sp.dft_fwd_im)],
                           dim=pdim)
    _check_bf16(sp)
    g = grid.float()
    leg = sp.leg_dir_dense.to(torch.bfloat16).float()
    parts = []
    for c in range(2):
        f = (g @ sp.dft_fwd_ri_bf16[c].float()).to(torch.bfloat16).float()
        parts.append(_leg_dir_dense(sp, f, leg))
    return torch.stack(parts, dim=pdim)


def spec2grid_plain(sp, p: torch.Tensor, kcos: int = 1,
                    pdim: int = 0) -> torch.Tensor:
    """Plain version of the inverse transform: spectral pair (pair axis at
    `pdim`) -> grid (..., il, ix), by four matrix products and an add; scaled
    by 1/cos(lat) unless kcos == 1."""
    plain_chain_calls["spec2grid"] += 1
    re, im = p.unbind(pdim)
    g = (_leg_inv_dense(sp, re) @ sp.dft_inv_re
         + _leg_inv_dense(sp, im) @ sp.dft_inv_im)
    if kcos != 1:
        g = g * sp.cosgr[:, None]
    return g


def probe_plain(sp, stage: int, grid: torch.Tensor) -> torch.Tensor:
    """Plain versions of the four probe stages on a dense (N, il, ix) grid:
    0 the DFT product of the real part as (N*il, mx); 1 the same values as
    (N, il*mx); 2 followed by the Legendre product, (N, mx*nx); 3 the
    inverse-side split (N, il*ix)[:, :il*mx] viewed as (N*il, mx), times 2."""
    n, il, ix, mx = grid.shape[0], sp.il, sp.ix, sp.mx
    if stage == 3:
        return grid.reshape(n, il * ix)[:, :il * mx].reshape(n * il, mx) * 2.0
    f = grid.reshape(n * il, ix) @ sp.dft_fwd_re
    if stage == 0:
        return f
    f = f.reshape(n, il * mx)
    if stage == 1:
        return f
    if stage == 2:
        return f @ sp.leg_dir_dense
    raise ValueError(f"probe stage must be one of {PROBE_STAGES}, got {stage}")


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor, shape, what: str) -> torch.Tensor:
    """`x` viewed in the collapsed `shape` the kernel addresses by strides,
    its two field axes dense. Raises if that needs a copy."""
    try:
        v = x.view(shape)
    except RuntimeError as err:
        raise ValueError(
            f"{what}: shape {tuple(x.shape)} with strides {x.stride()} cannot "
            f"be addressed by member, pair and row strides, and the kernel "
            f"wrapper copies nothing") from err
    rows, cols = shape[-2], shape[-1]
    if (cols > 1 and v.stride(-1) != 1) or (rows > 1 and v.stride(-2) != cols):
        raise ValueError(
            f"{what}: the last two axes must be dense, got strides "
            f"{x.stride()} for shape {tuple(x.shape)}")
    return v


def _check_tables(sp, device, *tables):
    for t in tables:
        if t.device != device or not t.is_contiguous():
            raise ValueError(
                f"transform tables must be contiguous on {device}, got "
                f"{t.device}")
    if sp.il % _LAT_TILE != 0:
        raise ValueError(f"il={sp.il}: the kernel needs a multiple of "
                         f"{_LAT_TILE} latitudes")


def _launch(kind, mode, nrows, per_member, sp, ptrs, strides, device, what):
    fn = _load("fused_transform")
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_strides = (ctypes.c_longlong * max(len(strides), 1))(*strides)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(kind, mode, nrows, per_member, sp.il, sp.ix, sp.mx, sp.nx,
                ctypes.cast(c_ptrs, ctypes.c_void_p),
                ctypes.cast(c_strides, ctypes.c_void_p),
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed with code {rc} (rows={nrows}, "
            f"per member {per_member}, il={sp.il}, ix={sp.ix}, mx={sp.mx}, "
            f"nx={sp.nx}, mode={mode})")


def _need_cuda(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")


def _shared_fits(nbytes, what):
    if nbytes > _MAX_SHARED:
        raise ValueError(f"{what}: a row needs {nbytes} bytes of shared "
                         f"memory, a block has {_MAX_SHARED}")


def fused_grid2spec_cuda(sp, grid: torch.Tensor, pdim: int = 0) -> torch.Tensor:
    """Launch the direct-transform kernel on PyTorch's current stream: grid
    (..., il, ix) in the tables' type, or bfloat16 against float32 tables ->
    spectral pair in the tables' type, written with the pair axis at `pdim`.
    The leading axes may be strided (a slice of a level stack, an expanded
    member axis) as long as they collapse to a member and a row stride.
    Raises on anything else; does not synchronise."""
    _need_cuda(grid, "fused_grid2spec_cuda")
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    bf16 = grid.dtype == torch.bfloat16
    if bf16:
        _check_bf16(sp)
        dft, leg = sp.dft_fwd_ri_bf16, sp.cpol_dir_full_bf16
    elif grid.dtype == sp.rdtype and grid.dtype in _MODES:
        dft, leg = sp.dft_fwd_ri, sp.cpol_dir_full
    else:
        raise TypeError(f"grid is {grid.dtype}, the tables {sp.rdtype}")
    lead = tuple(grid.shape[:-2])
    if grid.dim() < 2 or tuple(grid.shape[-2:]) != (il, ix):
        raise ValueError(f"grid must be (..., {il}, {ix}), got "
                         f"{tuple(grid.shape)}")
    if not 0 <= pdim <= len(lead):
        raise ValueError(f"pdim={pdim} for {len(lead)} leading axes")
    _check_tables(sp, grid.device, dft, leg)
    nmem, per = math.prod(lead[:pdim]), math.prod(lead[pdim:])
    out = torch.empty(lead[:pdim] + (2,) + lead[pdim:] + (mx, nx),
                      dtype=sp.rdtype, device=grid.device)
    if nmem * per == 0:
        return out
    g4 = _rows(grid, (nmem, per, il, ix), "grid")
    _shared_fits(out.element_size() * (il * ix + 2 * il * mx),
                 "fused_grid2spec")
    plane = mx * nx
    _launch(_KIND_DIRECT, _MODES[grid.dtype], nmem * per, per, sp,
            (g4.data_ptr(), dft.data_ptr(), leg.data_ptr(), out.data_ptr()),
            (g4.stride(0), g4.stride(1), 2 * per * plane, per * plane, plane),
            grid.device, "fused_grid2spec")
    launch_counts["fused_grid2spec_bf16" if bf16 else "fused_grid2spec"] += 1
    return out


def fused_spec2grid_cuda(sp, p: torch.Tensor, kcos: int = 1,
                         pdim: int = 0) -> torch.Tensor:
    """Launch the inverse-transform kernel on PyTorch's current stream:
    spectral pair with the pair axis at `pdim`, read in place through its
    member, pair and row strides -> a new dense grid (..., il, ix); scaled by
    1/cos(lat) at the store unless kcos == 1. Raises on anything the kernel
    does not take; does not synchronise."""
    _need_cuda(p, "fused_spec2grid_cuda")
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    if p.dtype != sp.rdtype or p.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spectral pair is {p.dtype}, the tables {sp.rdtype}")
    if (p.dim() < 3 or not 0 <= pdim <= p.dim() - 3 or p.shape[pdim] != 2
            or tuple(p.shape[-2:]) != (mx, nx)):
        raise ValueError(
            f"spectral pair must be (..., 2, ..., {mx}, {nx}) with the pair "
            f"axis at pdim={pdim}, got {tuple(p.shape)}")
    _check_tables(sp, p.device, sp.cpol_inv_t, sp.dft_inv_ri, sp.cosgr)
    lead = tuple(p.shape[:pdim]) + tuple(p.shape[pdim + 1:-2])
    nmem, per = math.prod(lead[:pdim]), math.prod(lead[pdim:])
    out = torch.empty(lead + (il, ix), dtype=p.dtype, device=p.device)
    if nmem * per == 0:
        return out
    p5 = _rows(p, (nmem, 2, per, mx, nx), "spectral pair")
    _shared_fits(p.element_size() * (2 * mx * (nx + 1) + 2 * il * mx),
                 "fused_spec2grid")
    scale = sp.cosgr.data_ptr() if kcos != 1 else 0
    _launch(_KIND_INVERSE, _MODES[p.dtype], nmem * per, per, sp,
            (p5.data_ptr(), sp.cpol_inv_t.data_ptr(),
             sp.dft_inv_ri.data_ptr(), scale, out.data_ptr()),
            (p5.stride(0), p5.stride(1), p5.stride(2)),
            p.device, "fused_spec2grid")
    launch_counts["fused_spec2grid"] += 1
    return out


def fused_probe_cuda(sp, stage: int, grid: torch.Tensor) -> torch.Tensor:
    """Launch one probe stage (see :func:`probe_plain`) on a dense
    (N, il, ix) grid in the tables' type. Does not synchronise."""
    _need_cuda(grid, "fused_probe_cuda")
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    if stage not in PROBE_STAGES:
        raise ValueError(f"probe stage must be one of {PROBE_STAGES}, got "
                         f"{stage}")
    if grid.dtype != sp.rdtype or grid.dtype not in (torch.float32,
                                                     torch.float64):
        raise TypeError(f"grid is {grid.dtype}, the tables {sp.rdtype}")
    if (grid.dim() != 3 or tuple(grid.shape[1:]) != (il, ix)
            or not grid.is_contiguous()):
        raise ValueError(f"grid must be a contiguous (N, {il}, {ix}), got "
                         f"{tuple(grid.shape)} with strides {grid.stride()}")
    _check_tables(sp, grid.device, sp.dft_fwd_ri, sp.cpol_dir_full)
    n = grid.shape[0]
    shape = {0: (n * il, mx), 1: (n, il * mx), 2: (n, mx * nx),
             3: (n * il, mx)}[stage]
    out = torch.empty(shape, dtype=grid.dtype, device=grid.device)
    if n == 0:
        return out
    if stage == 3:
        ptrs = (grid.data_ptr(), out.data_ptr())
    else:
        _shared_fits(grid.element_size() * (il * ix + 2 * il * mx),
                     "fused_probe")
        ptrs = (grid.data_ptr(), sp.dft_fwd_ri.data_ptr(),
                sp.cpol_dir_full.data_ptr(), out.data_ptr())
    _launch(_KIND_PROBE0 + stage, _MODES[grid.dtype], n, 1, sp, ptrs, (),
            grid.device, f"fused_probe stage {stage}")
    launch_counts["fused_probe"] += 1
    return out


# ---------------------------------------------------------------------------
# The dispatch rule
# ---------------------------------------------------------------------------

def fused_grid2spec(sp, grid: torch.Tensor, pdim: int = 0) -> torch.Tensor:
    """CPU tensors take the plain chain; CUDA tensors launch the kernel or
    raise."""
    if grid.device.type == "cpu":
        return grid2spec_plain(sp, grid, pdim)
    return fused_grid2spec_cuda(sp, grid, pdim)


def fused_spec2grid(sp, p: torch.Tensor, kcos: int = 1,
                    pdim: int = 0) -> torch.Tensor:
    """CPU tensors take the plain chain; CUDA tensors launch the kernel or
    raise."""
    if p.device.type == "cpu":
        return spec2grid_plain(sp, p, kcos, pdim)
    return fused_spec2grid_cuda(sp, p, kcos, pdim)


def fused_probe(stage: int, sp, grid: torch.Tensor) -> torch.Tensor:
    """One stage of the direct transform alone. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if grid.device.type == "cpu":
        return probe_plain(sp, stage, grid)
    return fused_probe_cuda(sp, stage, grid)
