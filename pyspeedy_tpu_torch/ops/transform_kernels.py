"""Fused spectral transforms: wrappers of the hand-written CUDA kernels in
``csrc/fused_transform.cu`` (T30) and ``csrc/fused_transform_hires.cu``
(T47, T63) and their plain PyTorch versions.

Counterpart of the JAX package's ``tools/exp_fused_transform.py``
(``fused_grid2spec``, ``fused_spec2grid``) and ``tools/exp_fused_probe.py``
(``probe``). A kernel launch transforms a group of up to ``MAX_SEGMENTS``
fields ("segments"): persistent blocks hold the folded DFT and Legendre
tables in shared memory and walk over the rows of every field, the zonal DFT
and the Legendre transform of a row in one pass with the Fourier intermediate
in shared memory (the design is in the source's note). The probes are the
direct kernel stopped after one stage. Those kernels are built for T30. At
T47 and T63 (``HIRES_SHAPES``), whose folded Legendre tables do not fit in one
block, the direct transform of a group is one kernel launched on
thread-block clusters: each block of a cluster owns a band of latitude pairs
for the DFT (on the tensor cores) and a slice of the wavenumbers for the
Legendre sums, and the Fourier intermediate goes from block to block through
the cluster's shared memory. The inverse is the mirror image on clusters,
its Legendre sums and its DFT on different warps of a block and on
successive steps (the designs are in that source's note; the library's
plan, which :func:`hires_kernel_plan` reads, and :func:`hires_cluster_plan`,
the decomposition for the CPU model of it). ``KERNEL_SHAPES`` are the (il,
ix, mx, nx) the kernels serve; the probes and the 2-byte operand mode stay
at ``T30_SHAPE``.

Dispatch rule (:func:`fused_grid2spec`, :func:`fused_spec2grid`, the grouped
:func:`fused_grid2spec_many`, :func:`fused_spec2grid_many`, and
:func:`fused_probe`), the same as for the column kernels: CPU tensors go to
the plain version, one field at a time; CUDA tensors launch the kernel or
raise. There is no fallback from the kernel to the plain version on the card,
and the wrapper never copies or converts a tensor: what the kernel cannot
address by member, pair and row strides is refused, before anything is built.
A group launches once per element type it holds; its outputs equal those of
the fields launched one by one, bitwise. ``ops.spectral.grid2spec_p``,
``spec2grid_p`` and their ``*_many_p`` forms come here on the kernel route
(``sp.use_fused_kernels``); the ``torch.fft`` route and the einsum route of
other truncations are routes of their own.

The plain versions at T30 are the dense matmul chain: two DFT products and
two products against the zero-padded block-diagonal Legendre matrix
(``leg_*_dense``); at T47 and T63 the einsum chain (``einsum_grid2spec``,
``einsum_spec2grid``: two einsums, as ``ops.spectral``'s einsum route and the
JAX package compute these truncations), so a CPU result there is the einsum
route's, bitwise. On the card each chain is also the library yardstick there
is for its kernels. ``plain_chain_calls`` counts the dense chain's calls and
``einsum_chain_calls`` the einsum chain's as a plain version (the einsum
route of other shapes and of the latitude bands is not counted), so a run
can show that it took neither on the card. ``launch_counts`` (in
``ops.column_kernels``) counts launches (one a group and element type),
``field_counts`` here the fields those launches transformed.

A bfloat16 grid (the ``bf16_tendencies`` configuration) takes, at T30, the
2-byte operand mode of the direct transform: DFT and Legendre tables rounded
to bfloat16, the Fourier intermediate rounded to bfloat16, the sums and the
result in the tables' type (float32 or float64), as the JAX package's dense
route computes it. At T47 and T63 the JAX package widens a bfloat16 grid to
the tables' type and takes the ordinary transform; so does the T47/T63
direct kernel, which reads the bfloat16 rows (16-byte aligned: the wrapper
refuses others) and widens each value where its products read it, and so
does the einsum chain, its plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .column_kernels import _load, launch_counts

__all__ = ["fused_grid2spec", "fused_spec2grid", "fused_probe",
           "fused_grid2spec_many", "fused_spec2grid_many",
           "fused_grid2spec_cuda", "fused_spec2grid_cuda", "fused_probe_cuda",
           "fused_grid2spec_many_cuda", "fused_spec2grid_many_cuda",
           "grid2spec_plain", "spec2grid_plain", "probe_plain", "c_mode",
           "plain_chain_calls", "reset_plain_chain_calls", "field_counts",
           "reset_field_counts", "kcos_list", "PROBE_STAGES", "MAX_SEGMENTS",
           "T30_SHAPE", "T47_SHAPE", "T63_SHAPE", "HIRES_SHAPES",
           "KERNEL_SHAPES", "einsum_grid2spec", "einsum_spec2grid",
           "grid2spec_hires_plain", "spec2grid_hires_plain",
           "einsum_chain_calls", "reset_einsum_chain_calls",
           "hires_cluster_plan", "hires_kernel_plan"]

# The probes: the stages of the direct transform alone, real part only.
PROBE_STAGES = (0, 1, 2, 3)
# Fields one launch takes (kMaxSeg of the source).
MAX_SEGMENTS = 16
# (il, ix, mx, nx) the direct and inverse kernels are built for: T30 in
# csrc/fused_transform.cu (also the probes' and the 2-byte mode's one
# shape), T47 and T63 in csrc/fused_transform_hires.cu.
T30_SHAPE = (48, 96, 31, 32)
T47_SHAPE = (72, 144, 48, 49)
T63_SHAPE = (96, 192, 64, 65)
HIRES_SHAPES = (T47_SHAPE, T63_SHAPE)
KERNEL_SHAPES = (T30_SHAPE,) + HIRES_SHAPES

_KIND_DIRECT, _KIND_INVERSE, _KIND_PROBE0 = 0, 1, 2
_MODES = {torch.float32: 0, torch.float64: 1}


def c_mode(dtype, table_dtype) -> int:
    """The C entries' `mode` of a field of `dtype` against tables of
    `table_dtype`: 0 float, 1 double, 2 / 3 a bfloat16 grid against float /
    double tables (the direct transform only)."""
    return _MODES[table_dtype] + (2 if dtype == torch.bfloat16 else 0)


# The inverse's Legendre warps (INV_LEG_WARPS of the source).
INVERSE_LEGENDRE_WARPS = 4

plain_chain_calls = {"grid2spec": 0, "spec2grid": 0}


def reset_plain_chain_calls() -> None:
    for name in plain_chain_calls:
        plain_chain_calls[name] = 0


# Calls of the einsum chain as the plain version of the T47/T63 kernels.
einsum_chain_calls = {"grid2spec": 0, "spec2grid": 0}


def reset_einsum_chain_calls() -> None:
    for name in einsum_chain_calls:
        einsum_chain_calls[name] = 0


# Fields (segments) transformed by the launches of each counter.
field_counts = {"fused_grid2spec": 0, "fused_grid2spec_bf16": 0,
                "fused_spec2grid": 0, "fused_grid2spec_hires": 0,
                "fused_grid2spec_hires_bf16": 0, "fused_spec2grid_hires": 0}


def reset_field_counts() -> None:
    for name in field_counts:
        field_counts[name] = 0


def hires_cluster_plan(shape, dtype) -> dict:
    """The decomposition of the T47/T63 cluster kernels at shape (il, ix,
    mx, nx) and an element type, from the two choices of ``Plan<S, T>`` in
    ``csrc/fused_transform_hires.cu`` (blocks a cluster, rows a step; the
    card's tests hold them against the library's :func:`hires_kernel_plan`):

    * ``cluster``: blocks a cluster (4; 8 for T63 in float64);
    * ``bands``: block b's latitude pairs [b0, b1), an equal share of the
      il/2 mirror pairs, whose zonal DFT it computes;
    * ``m_slices``: block r's wavenumbers, whose Legendre sums it computes:
      the K = mx / (2 C) lowest from r K and their mirrors mx - 1 - m, so
      every block holds K (2 nx - mx + 1) entries of the (m, n) triangle;
    * ``rows_per_step``: field rows a cluster transforms between two
      exchanges; ``band_columns``: the MMA columns of a step, (row, pair,
      hemisphere) in that order, padded to a multiple of 8 with zeros;
    * the direct kernel's warps: ``direct_dft_warps``, a warp of the DFT a
      (parity, 16 wavenumber columns) tile, a step ahead of
      ``direct_legendre_warps`` warps of the Legendre sums (2 at T47 in
      float32, where two blocks share an SM, else 4); ``direct_threads``,
      both;
    * ``mma_k``: the depth of one tensor-core product (8 for 3xTF32, 4 for
      DMMA), the order in which the DFT's k loop adds its terms;
    * the inverse's: ``inverse_threads``, a warp of the DFT a (parity, 16
      longitudes) tile and ``INVERSE_LEGENDRE_WARPS`` warps of the Legendre
      stage; ``inverse_pairs_per_item``, the latitude pairs of one Legendre
      item (m pair, pairs, n parity), one item a thread of those warps;
      ``inverse_rows_per_step`` (4 at T47 in float32, else 2).
    """
    il, ix, mx, nx = shape = tuple(shape)
    if shape not in HIRES_SHAPES or dtype not in (torch.float32,
                                                  torch.float64):
        raise ValueError(f"the T47/T63 kernels are built for {HIRES_SHAPES} "
                         f"in float32 and float64, got {shape} {dtype}")
    f64 = dtype == torch.float64
    c = 8 if f64 and il == 96 else 4
    k, rows, pairs, iy = mx // (2 * c), 2, il // 2 // c, il // 2
    dft_warps = 2 * ((mx + 1) // 2 * 2 // 16)
    leg_warps = 2 if (il == 72 and not f64) else 4
    svw = next(d for d in range(1, iy + 1) if iy % d == 0
               and k * (iy // d) * 2 <= 32 * INVERSE_LEGENDRE_WARPS)
    return {
        "inverse_pairs_per_item": svw,
        "inverse_threads": 32 * (2 * -(-ix // 2 // 16)
                                 + INVERSE_LEGENDRE_WARPS),
        "inverse_rows_per_step": 4 if (il == 72 and not f64) else 2,
        "direct_dft_warps": dft_warps,
        "direct_legendre_warps": leg_warps,
        "direct_threads": 32 * (dft_warps + leg_warps),
        "cluster": c, "pairs_per_band": pairs, "rows_per_step": rows,
        "band_columns": -(-rows * 2 * pairs // 8) * 8,
        "bands": tuple((r * pairs, (r + 1) * pairs) for r in range(c)),
        "m_slices": tuple(tuple(range(r * k, (r + 1) * k))
                          + tuple(range(mx - (r + 1) * k, mx - r * k))
                          for r in range(c)),
        "mma_k": 4 if f64 else 8,
    }


_PLAN_FIELDS = ("cluster", "m_pairs", "pairs_per_band", "rows_per_step",
                "band_columns", "mma_k", "direct_threads", "direct_smem",
                "grid_buffers", "inverse_threads", "inverse_pairs_per_item",
                "inverse_rows_per_step", "inverse_smem", "direct_dft_warps",
                "direct_legendre_warps", "direct_blocks_per_sm")
_kernel_plans: dict = {}


def hires_kernel_plan(sp, grid_dtype=None) -> dict:
    """The plan of the T47/T63 kernels at sp's shape and type, the direct
    kernel's for a grid of `grid_dtype` (the tables' type by default, or
    bfloat16), as the library reports it
    (``pyspeedy_fused_transform_hires_plan``; builds and loads the library
    at first use): the decomposition (blocks a cluster, m pairs of a block,
    latitude pairs of a band, rows a direct step, MMA columns and depth),
    threads and shared memory (bytes) of the direct block, its grid
    buffers, the inverse block's threads, latitude pairs a Legendre item,
    rows a step and shared memory, the direct block's DFT and Legendre
    warps and its blocks an SM, with ``direct_kernels`` /
    ``inverse_kernels``, the device kernels a call launches."""
    grid_dtype = sp.rdtype if grid_dtype is None else grid_dtype
    key = (sp.il, sp.ix, sp.mx, sp.nx, sp.rdtype, grid_dtype)
    if key not in _kernel_plans:
        if key[:4] not in HIRES_SHAPES:
            raise ValueError(f"the T47/T63 kernels are built for "
                             f"{HIRES_SHAPES}, got {key[:4]}")
        from .column_kernels import build_kernels
        lib = ctypes.CDLL(str(build_kernels(["fused_transform_hires"])[
            "fused_transform_hires"]))
        out = (ctypes.c_int * len(_PLAN_FIELDS))()
        rc = lib.pyspeedy_fused_transform_hires_plan(
            47 if sp.il == T47_SHAPE[0] else 63,
            c_mode(grid_dtype, sp.rdtype), out)
        if rc != 0:
            raise RuntimeError(f"the plan query failed with {rc}")
        plan = dict(zip(_PLAN_FIELDS, out))
        plan["direct_kernels"] = ("hires_direct_cluster_kernel",)
        plan["inverse_kernels"] = ("hires_inverse_ws_kernel",)
        _kernel_plans[key] = plan
    return _kernel_plans[key]


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


def grid2spec_plain(sp, grid: torch.Tensor, pdim: int = 0) -> torch.Tensor:
    """Plain version of the direct transform: grid (..., il, ix) -> spectral
    pair with the pair axis at `pdim`, by four matrix products.

    A bfloat16 grid takes the 2-byte operand chain as the JAX package writes
    it: the DFT a bfloat16 x bfloat16 product accumulated in float32 (the
    widened operands multiply exactly) and rounded to bfloat16, then the
    Legendre product against the table rounded to bfloat16, accumulated in
    the tables' type, which is the result's (JAX's preferred_element_type).
    The tables round to bfloat16 through float32 in either precision, as
    JAX's astype(bfloat16) of a float64 array does on the CPU."""
    plain_chain_calls["grid2spec"] += 1
    if grid.dtype != torch.bfloat16:
        return torch.stack([_leg_dir_dense(sp, grid @ sp.dft_fwd_re),
                            _leg_dir_dense(sp, grid @ sp.dft_fwd_im)],
                           dim=pdim)
    g = grid.float()
    leg = sp.leg_dir_dense.to(torch.bfloat16).to(sp.rdtype)
    parts = []
    for c in range(2):
        f = (g @ sp.dft_fwd_ri_bf16[c].float()).to(torch.bfloat16)
        parts.append(_leg_dir_dense(sp, f.to(sp.rdtype), leg))
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


def einsum_grid2spec(sp, grid: torch.Tensor, pdim: int = 0) -> torch.Tensor:
    """The einsum chain of the direct transform: grid (..., il, ix) in the
    tables' type -> spectral pair with the pair axis at `pdim`, a DFT einsum
    against ``dft_fwd_ri`` and a Legendre einsum against
    ``cpol_dir_full``."""
    F2 = torch.einsum("...ji,cim->c...jm", grid, sp.dft_fwd_ri)
    S2 = torch.einsum("jmn,c...jm->c...mn", sp.cpol_dir_full, F2)
    return S2.movedim(0, pdim)


def einsum_spec2grid(sp, p: torch.Tensor, kcos: int = 1,
                     pdim: int = 0) -> torch.Tensor:
    """The einsum chain of the inverse transform: spectral pair (pair axis
    at `pdim`) -> grid (..., il, ix), scaled by 1/cos(lat) unless
    kcos == 1. ``dft_inv_ri[1, 0] == 0`` drops the imaginary part of m = 0."""
    F2 = torch.einsum("jmn,c...mn->c...jm", sp.cpol_inv_full,
                      p.movedim(pdim, 0))
    g = torch.einsum("c...jm,cmi->...ji", F2, sp.dft_inv_ri)
    if kcos != 1:
        g = g * sp.cosgr[:, None]
    return g


def grid2spec_hires_plain(sp, grid: torch.Tensor,
                          pdim: int = 0) -> torch.Tensor:
    """Plain version of the T47/T63 direct kernels: the einsum chain (a
    bfloat16 grid widened to the tables' type first, as on the einsum
    route)."""
    einsum_chain_calls["grid2spec"] += 1
    if grid.dtype == torch.bfloat16:
        grid = grid.to(sp.rdtype)
    return einsum_grid2spec(sp, grid, pdim)


def spec2grid_hires_plain(sp, p: torch.Tensor, kcos: int = 1,
                          pdim: int = 0) -> torch.Tensor:
    """Plain version of the T47/T63 inverse kernels: the einsum chain."""
    einsum_chain_calls["spec2grid"] += 1
    return einsum_spec2grid(sp, p, kcos, pdim)


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


def _check_tables(device, *tables):
    for t in tables:
        if t.device != device or not t.is_contiguous():
            raise ValueError(
                f"transform tables must be contiguous on {device}, got "
                f"{t.device}")


def _check_t30(sp):
    if (sp.il, sp.ix, sp.mx, sp.nx) != T30_SHAPE:
        raise ValueError(
            f"the probes are built for T30 (il, ix, mx, nx) = {T30_SHAPE}, "
            f"got {(sp.il, sp.ix, sp.mx, sp.nx)}")
    if not sp.use_dense_legendre:
        raise ValueError("the probes read the folded tables of the dense "
                         "route (use_matmul_fft at T30)")


def _is_hires(sp) -> bool:
    """Whether the T47/T63 kernels serve `sp` (else T30's); raises, before
    anything is built, for tables the kernels are not built for."""
    shape = (sp.il, sp.ix, sp.mx, sp.nx)
    if shape not in KERNEL_SHAPES:
        raise ValueError(
            f"the fused transform kernels are built for T30, T47 and T63, "
            f"(il, ix, mx, nx) in {KERNEL_SHAPES}, got {shape}")
    if not sp.use_fused_kernels:
        raise ValueError("the fused transform kernels read the folded tables "
                         "of the kernel route (use_matmul_fft at T30, T47, "
                         "T63)")
    return shape != T30_SHAPE


def _check_count(fields, what):
    if len(fields) > MAX_SEGMENTS:
        raise ValueError(f"{what}: {len(fields)} fields, one launch takes at "
                         f"most {MAX_SEGMENTS}")


def _check_device(fields, what):
    device = fields[0].device
    for x in fields:
        if x.device.type != "cuda":
            raise ValueError(f"{what} needs CUDA tensors, got {x.device}")
        if x.device != device:
            raise ValueError(f"{what}: fields on {device} and {x.device}")
    return device


def _call(kernel, kind, mode, count, sp, tables, desc, device, what,
          *extra):
    """The C entry of `kernel` (its ``extra`` pointers before the stream)
    on PyTorch's current stream; raises on a nonzero code."""
    fn = _load(kernel)
    c_tables = (ctypes.c_void_p * len(tables))(*tables)
    c_desc = (ctypes.c_longlong * max(len(desc), 1))(*desc)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(kind, mode, count, sp.il, sp.ix, sp.mx, sp.nx,
                ctypes.cast(c_tables, ctypes.c_void_p),
                ctypes.cast(c_desc, ctypes.c_void_p), *extra,
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed with code {rc} (count={count}, "
            f"il={sp.il}, ix={sp.ix}, mx={sp.mx}, nx={sp.nx}, mode={mode})")


def _launch_groups(kind, sp, plans, tables_of, device, what):
    """One launch per element type among `plans` [(mode, counter, words)],
    in the order the types first appear, with the tables `tables_of(counter)`;
    empty fields take no segment."""
    by_mode = {}
    for mode, counter, words in plans:
        if words is not None:
            by_mode.setdefault((mode, counter), []).append(words)
    for (mode, counter), segs in by_mode.items():
        tables = tables_of(counter)
        _check_tables(device, *tables)
        ptrs = [t.data_ptr() for t in tables]
        desc = [w for seg in segs for w in seg]
        if "_hires" in counter:
            _call("fused_transform_hires", kind, mode, len(segs), sp, ptrs,
                  desc, device, what)
        else:
            _call("fused_transform", kind, mode, len(segs), sp, ptrs, desc,
                  device, what)
        launch_counts[counter] += 1
        field_counts[counter] += len(segs)


def _direct_plan(sp, grid: torch.Tensor, pdim: int, hires: bool):
    """(output, (mode, counter, segment words or None when empty)) of one
    field of a direct group. Raises on what the kernel does not take."""
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    counter = "fused_grid2spec_hires" if hires else "fused_grid2spec"
    if grid.dtype == torch.bfloat16 and sp.rdtype in _MODES:
        counter += "_bf16"
    elif grid.dtype != sp.rdtype or grid.dtype not in _MODES:
        raise TypeError(f"grid is {grid.dtype}, the tables {sp.rdtype}")
    if grid.dim() < 2 or tuple(grid.shape[-2:]) != (il, ix):
        raise ValueError(f"grid must be (..., {il}, {ix}), got "
                         f"{tuple(grid.shape)}")
    lead = tuple(grid.shape[:-2])
    if not 0 <= pdim <= len(lead):
        raise ValueError(f"pdim={pdim} for {len(lead)} leading axes")
    nmem, per = math.prod(lead[:pdim]), math.prod(lead[pdim:])
    g4 = _rows(grid, (nmem, per, il, ix), "grid") if nmem * per else None
    out = torch.empty(lead[:pdim] + (2,) + lead[pdim:] + (mx, nx),
                      dtype=sp.rdtype, device=grid.device)
    mode = c_mode(grid.dtype, sp.rdtype)
    if g4 is None:
        return out, (mode, counter, None)
    if hires and grid.dtype == torch.bfloat16 and (
            g4.data_ptr() % 16 or g4.stride(0) * 2 % 16
            or g4.stride(1) * 2 % 16):
        raise ValueError(
            f"a bfloat16 grid at T47/T63 is copied in 16-byte chunks: its "
            f"address {g4.data_ptr()} and member and row strides "
            f"{g4.stride(0)}, {g4.stride(1)} (elements) must be 16-byte "
            f"aligned, and the kernel wrapper copies nothing")
    plane = mx * nx
    words = (g4.data_ptr(), out.data_ptr(), nmem * per, per, g4.stride(0), 0,
             g4.stride(1), 2 * per * plane, per * plane, plane, 0)
    return out, (mode, counter, words)


def _inverse_plan(sp, p: torch.Tensor, kcos: int, pdim: int, hires: bool):
    """(output, (mode, counter, segment words or None when empty)) of one
    field of an inverse group."""
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    counter = "fused_spec2grid_hires" if hires else "fused_spec2grid"
    if p.dtype != sp.rdtype or p.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spectral pair is {p.dtype}, the tables {sp.rdtype}")
    if (p.dim() < 3 or not 0 <= pdim <= p.dim() - 3 or p.shape[pdim] != 2
            or tuple(p.shape[-2:]) != (mx, nx)):
        raise ValueError(
            f"spectral pair must be (..., 2, ..., {mx}, {nx}) with the pair "
            f"axis at pdim={pdim}, got {tuple(p.shape)}")
    lead = tuple(p.shape[:pdim]) + tuple(p.shape[pdim + 1:-2])
    nmem, per = math.prod(lead[:pdim]), math.prod(lead[pdim:])
    p5 = _rows(p, (nmem, 2, per, mx, nx), "spectral pair") if nmem * per \
        else None
    out = torch.empty(lead + (il, ix), dtype=p.dtype, device=p.device)
    if p5 is None:
        return out, (_MODES[p.dtype], counter, None)
    words = (p5.data_ptr(), out.data_ptr(), nmem * per, per, p5.stride(0),
             p5.stride(1), p5.stride(2), per * il * ix, 0, il * ix,
             int(kcos != 1))
    return out, (_MODES[p.dtype], counter, words)


def fused_grid2spec_many_cuda(sp, grids, pdim: int = 0) -> list:
    """Launch the direct-transform kernel on PyTorch's current stream for a
    group of up to MAX_SEGMENTS fields: each grid (..., il, ix) in the
    tables' type or in bfloat16 (at T30 the 2-byte operand mode, at T47/T63
    widened in the kernel) -> its spectral pair in the tables' type, the
    pair axis at `pdim`. One launch per element type in the list (at T47/T63
    one kernel on thread-block clusters); the leading axes of each grid may
    be strided (a slice of a level stack, an expanded member axis) as long
    as they collapse to a member and a row stride, 16-byte aligned for a
    bfloat16 grid at T47/T63. Raises on anything else, before anything is
    built or launched; does not synchronise."""
    grids = list(grids)
    what = "fused_grid2spec_many_cuda"
    _check_count(grids, what)
    hires = _is_hires(sp)
    plans = [_direct_plan(sp, g, pdim, hires) for g in grids]
    if not grids:
        return []
    device = _check_device(grids, what)
    _launch_groups(
        _KIND_DIRECT, sp, [plan for _, plan in plans],
        lambda counter: ((sp.fold_dir_bf16,)
                         if counter == "fused_grid2spec_bf16"
                         else (sp.fold_dir,)),
        device, "fused_grid2spec")
    return [out for out, _ in plans]


def fused_spec2grid_many_cuda(sp, pairs, kcos=1, pdim: int = 0) -> list:
    """Launch the inverse-transform kernel on PyTorch's current stream for a
    group of up to MAX_SEGMENTS spectral pairs (pair axis at `pdim`), each
    read in place through its member, pair and row strides -> a new dense
    grid (..., il, ix) each; `kcos` is one value or one per field: the field
    is scaled by 1/cos(lat) at the store unless its kcos == 1. At T47/T63
    one kernel on thread-block clusters. Raises on anything the kernel does
    not take, before anything is built or launched; does not synchronise."""
    pairs = list(pairs)
    what = "fused_spec2grid_many_cuda"
    kcos = kcos_list(kcos, len(pairs))
    _check_count(pairs, what)
    hires = _is_hires(sp)
    plans = [_inverse_plan(sp, p, k, pdim, hires)
             for p, k in zip(pairs, kcos)]
    if not pairs:
        return []
    device = _check_device(pairs, what)
    _launch_groups(_KIND_INVERSE, sp, [plan for _, plan in plans],
                   lambda counter: (sp.fold_inv, sp.cosgr),
                   device, "fused_spec2grid")
    return [out for out, _ in plans]


def fused_grid2spec_cuda(sp, grid: torch.Tensor, pdim: int = 0) -> torch.Tensor:
    """One field: a group of one segment (see fused_grid2spec_many_cuda)."""
    return fused_grid2spec_many_cuda(sp, [grid], pdim)[0]


def fused_spec2grid_cuda(sp, p: torch.Tensor, kcos: int = 1,
                         pdim: int = 0) -> torch.Tensor:
    """One field: a group of one segment (see fused_spec2grid_many_cuda)."""
    return fused_spec2grid_many_cuda(sp, [p], [kcos], pdim)[0]


def kcos_list(kcos, n) -> list:
    """`kcos` (one value, or one per field) as a list of n values."""
    if isinstance(kcos, int):
        return [kcos] * n
    kcos = list(kcos)
    if len(kcos) != n:
        raise ValueError(f"{len(kcos)} kcos values for {n} fields")
    return kcos


def fused_probe_cuda(sp, stage: int, grid: torch.Tensor) -> torch.Tensor:
    """Launch one probe stage (see :func:`probe_plain`) on a dense
    (N, il, ix) grid in the tables' type: p0-p2 the direct kernel stopped
    after that stage (its folded tables, ``sp.fold_dir``), p3 the split
    pass. Built for T30 alone; raises on anything else before
    anything is built. Does not synchronise."""
    il, ix, mx, nx = sp.il, sp.ix, sp.mx, sp.nx
    if stage not in PROBE_STAGES:
        raise ValueError(f"probe stage must be one of {PROBE_STAGES}, got "
                         f"{stage}")
    _check_t30(sp)
    _check_device([grid], "fused_probe_cuda")
    if grid.dtype != sp.rdtype or grid.dtype not in (torch.float32,
                                                     torch.float64):
        raise TypeError(f"grid is {grid.dtype}, the tables {sp.rdtype}")
    if (grid.dim() != 3 or tuple(grid.shape[1:]) != (il, ix)
            or not grid.is_contiguous()):
        raise ValueError(f"grid must be a contiguous (N, {il}, {ix}), got "
                         f"{tuple(grid.shape)} with strides {grid.stride()}")
    n = grid.shape[0]
    shape = {0: (n * il, mx), 1: (n, il * mx), 2: (n, mx * nx),
             3: (n * il, mx)}[stage]
    out = torch.empty(shape, dtype=grid.dtype, device=grid.device)
    if n == 0:
        return out
    if stage == 3:
        ptrs = (grid.data_ptr(), out.data_ptr())
    else:
        _check_tables(grid.device, sp.fold_dir)
        ptrs = (grid.data_ptr(), sp.fold_dir.data_ptr(), out.data_ptr())
    _call("fused_transform", _KIND_PROBE0 + stage, _MODES[grid.dtype], n,
          sp, ptrs, (), grid.device, f"fused_probe stage {stage}")
    launch_counts["fused_probe"] += 1
    return out


# ---------------------------------------------------------------------------
# The dispatch rule
# ---------------------------------------------------------------------------

def _on_cpu(fields) -> bool:
    return all(x.device.type == "cpu" for x in fields)


def _hires_tables(sp) -> bool:
    return (sp.il, sp.ix, sp.mx, sp.nx) in HIRES_SHAPES


def fused_grid2spec_many(sp, grids, pdim: int = 0) -> list:
    """A group of fields: CPU tensors take the plain chain (the dense one at
    T30, the einsum one at T47/T63) one field at a time; otherwise one launch
    per element type, or the call raises (a CPU tensor among CUDA ones
    included)."""
    grids = list(grids)
    if _on_cpu(grids):
        plain = grid2spec_hires_plain if _hires_tables(sp) else \
            grid2spec_plain
        return [plain(sp, g, pdim) for g in grids]
    return fused_grid2spec_many_cuda(sp, grids, pdim)


def fused_spec2grid_many(sp, pairs, kcos=1, pdim: int = 0) -> list:
    """A group of spectral pairs, `kcos` one value or one per field: CPU
    tensors take the plain chain one field at a time; otherwise one launch,
    or the call raises."""
    pairs = list(pairs)
    if _on_cpu(pairs):
        plain = spec2grid_hires_plain if _hires_tables(sp) else \
            spec2grid_plain
        return [plain(sp, p, k, pdim)
                for p, k in zip(pairs, kcos_list(kcos, len(pairs)))]
    return fused_spec2grid_many_cuda(sp, pairs, kcos, pdim)


def fused_grid2spec(sp, grid: torch.Tensor, pdim: int = 0) -> torch.Tensor:
    """One field: a group of one (see fused_grid2spec_many)."""
    return fused_grid2spec_many(sp, [grid], pdim)[0]


def fused_spec2grid(sp, p: torch.Tensor, kcos: int = 1,
                    pdim: int = 0) -> torch.Tensor:
    """One field: a group of one (see fused_spec2grid_many)."""
    return fused_spec2grid_many(sp, [p], [kcos], pdim)[0]


def fused_probe(stage: int, sp, grid: torch.Tensor) -> torch.Tensor:
    """One stage of the direct transform alone. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if grid.device.type == "cpu":
        return probe_plain(sp, stage, grid)
    return fused_probe_cuda(sp, stage, grid)
