"""Hand-written CUDA kernels for column-local grid work: build, load, launch.

Counterpart of the JAX package's ``ops/pallas_tiling.py``. The sources live in
``pyspeedy_tpu_torch/csrc/``; they are compiled with ``nvcc`` for ``sm_90a``
at first use into a shared library with a plain C interface, which is loaded
with ``ctypes``. Nothing is built or imported when this module is imported.

Dispatch rule (:func:`grid_dynamics`, :func:`grid_physics`): a CPU tensor goes
to the plain PyTorch version it is given; a CUDA tensor launches the kernel or
raises. There is no fallback from the kernel to the plain version on the card.

``KERNELS`` is the table of kernels: one entry names a source, its C symbol
and argument types, its extra nvcc flags and its launch counters; building and
loading are generic over it. ``launch_counts`` holds, per counter, the number
of launches made since the last :func:`reset_launch_counts`; a wrapper adds
one exactly where it launches its kernel. The physics kernel counts its two
variants apart (``grid_physics_sw``: a shortwave step, ``grid_physics_nosw``),
and every kernel counts the launches of its bfloat16 instantiation apart
(``*_bf16``: the ``bf16_tendencies`` configuration). The fused spectral
transforms (``csrc/fused_transform.cu`` at T30,
``csrc/fused_transform_hires.cu`` at T47 and T63), the spectral update
(``csrc/spectral_update.cu``) and the DFT chain (``csrc/dft_chain.cu``) are in
the table too; their wrappers live in ``ops/transform_kernels.py``,
``ops/glue_kernels.py`` and ``ops/dft_chain.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as pc

__all__ = ["ColumnTables", "build_column_tables", "grid_dynamics",
           "grid_dynamics_cuda", "PhysicsTables", "build_physics_tables",
           "grid_physics", "grid_physics_cuda", "build_kernels",
           "copy_into",
           "build_command", "build_logs", "launch_counts",
           "reset_launch_counts", "find_nvcc", "KernelSpec", "KERNELS",
           "KERNEL_SOURCES", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
# Build outputs go beside the package (the repository root in a checkout).
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# Flags every source is compiled with; -Xptxas -v makes nvcc report each
# instantiation's registers and spill bytes (kept in `build_logs`).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_SUPPORTED_KX = (5, 7, 8)


class KernelSpec(NamedTuple):
    """One hand-written kernel: its source, the C function the library
    exports with its ctypes argument types, the nvcc flags it needs besides
    NVCC_FLAGS, and the names under which its launches are counted."""

    source: Path
    symbol: str
    argtypes: tuple
    extra_flags: tuple = ()
    counters: tuple = ()


_P, _I, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
KERNELS = {
    "grid_dynamics": KernelSpec(
        source=_CSRC / "grid_dynamics.cu", symbol="pyspeedy_grid_dynamics",
        argtypes=(_I, _I, _I, _I, _L, _I, _I, _P, _P, _P, _D, _D, _P),
        counters=("grid_dynamics", "grid_dynamics_bf16")),
    # -fmad=false: the plain version's separate elementwise passes cannot
    # contract a*b+c, and the physics is full of thresholds that turn a
    # last-bit difference into another branch.
    "grid_physics": KernelSpec(
        source=_CSRC / "grid_physics.cu", symbol="pyspeedy_grid_physics",
        argtypes=(_I, _I, _I, _I, _I, _L, _I, _I, _P, _P, _P, _P),
        extra_flags=("-fmad=false",),
        counters=("grid_physics_sw", "grid_physics_nosw",
                  "grid_physics_sw_bf16", "grid_physics_nosw_bf16")),
    # One entry point with a `kind` argument: a direct or an inverse group,
    # four probes.
    "fused_transform": KernelSpec(
        source=_CSRC / "fused_transform.cu",
        symbol="pyspeedy_fused_transform",
        argtypes=(_I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
        counters=("fused_grid2spec", "fused_grid2spec_bf16",
                  "fused_spec2grid", "fused_probe")),
    # The same transforms at T47 and T63, two kernels a direction launched
    # by one call (counted once): kind 0 direct, 1 inverse, with the
    # wrapper's scratch. Wrappers: ops/transform_kernels.py.
    "fused_transform_hires": KernelSpec(
        source=_CSRC / "fused_transform_hires.cu",
        symbol="pyspeedy_fused_transform_hires",
        argtypes=(_I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
        counters=("fused_grid2spec_hires", "fused_spec2grid_hires")),
    # -fmad=false as for the physics: the plain version's separate passes
    # cannot contract a*b+c, and the leapfrog filter is a small difference of
    # large values. Wrapper: ops/glue_kernels.py.
    "spectral_update": KernelSpec(
        source=_CSRC / "spectral_update.cu",
        symbol="pyspeedy_spectral_update",
        argtypes=(_I, _I, _I, _L, _I, _I, _P, _P, _P, _P, _P, _I, _I, _D, _D,
                  _D, _D, _D, _P),
        extra_flags=("-fmad=false",),
        counters=("spectral_update",)),
    # Wrapper: ops/dft_chain.py.
    "dft_chain": KernelSpec(
        source=_CSRC / "dft_chain.cu", symbol="pyspeedy_dft_chain",
        argtypes=(_I, _L, _I, _I, _I, _I, _I, _P, _P),
        counters=("dft_chain",)),
}
KERNEL_SOURCES = {name: spec.source for name, spec in KERNELS.items()}

launch_counts = {c: 0 for spec in KERNELS.values() for c in spec.counters}
build_logs: dict = {}    # kernel name -> what nvcc printed when it was built
_fns: dict = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class ColumnTables(NamedTuple):
    """What the grid-dynamics function needs besides its fields: per-level
    columns and per-latitude vectors on the device (for the plain version and
    as kernel inputs) and the per-level columns once more on the host, in the
    order the kernel's argument pack takes them."""

    dhs: torch.Tensor      # (kx, 1, 1) layer thickness
    dhsr: torch.Tensor     # (kx, 1, 1) 1/(2 dhs)
    fsgr: torch.Tensor     # (kx, 1, 1) akap/(2 fsg)
    tref: torch.Tensor     # (kx, 1, 1) reference temperature profile
    tref3: torch.Tensor    # (kx, 1, 1) fsgr * tref
    rcos: torch.Tensor     # (il, 1) 1/cos(lat)
    coriol: torch.Tensor   # (il, 1) Coriolis parameter
    levels_host: np.ndarray  # (5, kx) float64: dhs, dhsr, fsgr, tref, tref3

    @property
    def kx(self) -> int:
        return self.dhs.shape[0]


def build_column_tables(geom, tref, np_dtype, device) -> ColumnTables:
    """geom: numpy Geometry (f64); tref: (kx,) numpy f64 reference profile.
    Every table is rounded to the model dtype first, so the kernel's host
    copy and the device tensors hold the same values."""
    rows = [np.asarray(x, dtype=np_dtype) for x in
            (geom.dhs, geom.dhsr, geom.fsgr, tref, geom.fsgr * tref)]
    dev = lambda x, shape: torch.from_numpy(
        np.ascontiguousarray(x)).reshape(shape).to(device)
    kx = rows[0].shape[0]
    cols = [dev(x, (kx, 1, 1)) for x in rows]
    lat = [dev(np.asarray(x, dtype=np_dtype), (-1, 1))
           for x in (geom.cosgr, geom.coriol)]
    return ColumnTables(*cols, *lat,
                        levels_host=np.stack(rows).astype(np.float64))


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME and /usr/local/cuda): "
        "the CUDA kernels of pyspeedy_tpu_torch are compiled at first use")


def build_command(name: str, nvcc: str, out) -> list:
    """The nvcc command line that builds kernel `name` into `out`."""
    spec = KERNELS[name]
    return [nvcc, *NVCC_FLAGS, *spec.extra_flags, "-o", str(out),
            str(spec.source)]


def _library_path(name: str) -> Path:
    spec = KERNELS[name]
    flags = " ".join(NVCC_FLAGS + spec.extra_flags)
    digest = hashlib.sha1(spec.source.read_bytes()
                          + flags.encode()).hexdigest()[:12]
    return _BUILD_DIR / f"lib{name}_{digest}.so"


def build_kernels(names=None) -> dict:
    """Compile the named kernels (default: all), one nvcc process per source,
    all started together. Returns {name: library path}. A library whose name
    carries the hash of its source and flags is reused if it exists. A failed
    build raises."""
    names = list(KERNELS) if names is None else list(names)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    paths, procs = {}, {}
    for name in names:
        out = _library_path(name)
        paths[name] = out
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            build_command(name, nvcc, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def _load(name: str):
    """The C function of kernel `name`, built and loaded at first use."""
    fn = _fns.get(name)
    if fn is None:
        spec = KERNELS[name]
        lib = ctypes.CDLL(str(build_kernels([name])[name]))
        fn = getattr(lib, spec.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(spec.argtypes)
        _fns[name] = fn
    return fn


# ---------------------------------------------------------------------------
# The grid-dynamics kernel
# ---------------------------------------------------------------------------

_IN_NAMES = ("vorg", "divg", "tg", "trg_flat", "ug", "vg", "pxy")


def _check_inputs(tab: ColumnTables, fields):
    """Validate the seven member-batched fields against each other and the
    tables; returns (B, kx, ntr, il, ix). Raises on what the kernel does not
    take."""
    vorg = fields[0]
    if vorg.dim() != 4:
        raise ValueError(
            f"vorg must be (members, kx, il, ix), got {tuple(vorg.shape)}")
    nmem, kx, il, ix = vorg.shape
    if kx != tab.kx or kx not in _SUPPORTED_KX:
        raise ValueError(
            f"kx={kx}: the tables hold {tab.kx} levels and the kernel is "
            f"built for kx in {_SUPPORTED_KX}")
    if vorg.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {vorg.dtype}: float32 or float64")
    trg = fields[3]
    if trg.dim() != 4 or trg.shape[1] % kx != 0 or trg.shape[1] == 0:
        raise ValueError(
            f"trg_flat must be (members, ntr*kx, il, ix), got "
            f"{tuple(trg.shape)}")
    ntr = trg.shape[1] // kx
    want = {"vorg": (nmem, kx, il, ix), "divg": (nmem, kx, il, ix),
            "tg": (nmem, kx, il, ix), "trg_flat": (nmem, ntr * kx, il, ix),
            "ug": (nmem, kx, il, ix), "vg": (nmem, kx, il, ix),
            "pxy": (nmem, 2, il, ix)}
    for name, x in zip(_IN_NAMES, fields):
        if tuple(x.shape) != want[name]:
            raise ValueError(
                f"{name}: shape {tuple(x.shape)}, expected {want[name]}")
        if x.dtype != vorg.dtype or x.device != vorg.device:
            raise TypeError(
                f"{name}: {x.dtype} on {x.device}, expected {vorg.dtype} on "
                f"{vorg.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("rcos", tab.rcos), ("coriol", tab.coriol)):
        if (x.numel() != il or x.dtype != vorg.dtype
                or x.device != vorg.device or not x.is_contiguous()):
            raise ValueError(
                f"tables.{name} must hold {il} contiguous {vorg.dtype} "
                f"values on {vorg.device}")
    return nmem, kx, ntr, il, ix


def grid_dynamics_cuda(tab: ColumnTables, vorg, divg, tg, trg_flat, ug, vg,
                       pxy, bf16_out: bool = False):
    """Launch the CUDA grid-dynamics kernel on PyTorch's current stream.
    Returns the ten outputs in the order of ``grid_dynamics_core``; with
    `bf16_out` (float32 inputs only) all ten are bfloat16, rounded at the
    store. Raises if the inputs are not what the kernel takes, if the build
    fails or if the launch is refused; does not synchronise."""
    fields = (vorg, divg, tg, trg_flat, ug, vg, pxy)
    nmem, kx, ntr, il, ix = _check_inputs(tab, fields)
    if vorg.device.type != "cuda":
        raise ValueError(f"grid_dynamics_cuda needs CUDA tensors, got "
                         f"{vorg.device}")
    if bf16_out and vorg.dtype != torch.float32:
        raise TypeError(f"bfloat16 outputs need float32 inputs, got "
                        f"{vorg.dtype}")
    fn = _load("grid_dynamics")

    out_dtype = torch.bfloat16 if bf16_out else vorg.dtype
    full = lambda: torch.empty_like(vorg, dtype=out_dtype)
    trac = lambda: torch.empty_like(trg_flat, dtype=out_dtype)
    utend, vtend, ttend = full(), full(), full()
    trtend = trac()
    psdt_g = torch.empty((nmem, il, ix), dtype=out_dtype, device=vorg.device)
    flux_ut, flux_vt = full(), full()
    flux_qu, flux_qv = trac(), trac()
    ke = full()
    outs = (utend, vtend, ttend, trtend, psdt_g, flux_ut, flux_vt,
            flux_qu, flux_qv, ke)

    ins = fields + (tab.rcos, tab.coriol)
    in_ptrs = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    levels = np.ascontiguousarray(tab.levels_host, dtype=np.float64)
    with torch.cuda.device(vorg.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            vorg.element_size(), int(bf16_out), kx, ntr, nmem, il, ix,
            ctypes.cast(in_ptrs, ctypes.c_void_p),
            ctypes.cast(out_ptrs, ctypes.c_void_p),
            levels.ctypes.data_as(ctypes.c_void_p),
            pc.RGAS, pc.AKAP, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"grid_dynamics kernel launch failed with code {rc} "
            f"(members={nmem}, kx={kx}, ntr={ntr}, il={il}, ix={ix}, "
            f"{vorg.dtype}, bf16_out={bool(bf16_out)})")
    launch_counts["grid_dynamics_bf16" if bf16_out else "grid_dynamics"] += 1
    return outs


def grid_dynamics(plain_fn, tab: ColumnTables, vorg, divg, tg, trg_flat, ug,
                  vg, pxy, bf16_out: bool = False):
    """The dispatch rule: CPU tensors take `plain_fn` (the plain PyTorch
    version, ``models.tendencies.grid_dynamics_core``); CUDA tensors launch
    the kernel or raise."""
    if vorg.device.type == "cpu":
        return plain_fn(tab, vorg, divg, tg, trg_flat, ug, vg, pxy,
                        bf16_out=bf16_out)
    return grid_dynamics_cuda(tab, vorg, divg, tg, trg_flat, ug, vg, pxy,
                              bf16_out=bf16_out)


# ---------------------------------------------------------------------------
# The physics kernel
# ---------------------------------------------------------------------------

_N_BC = 16      # physics.driver.BC_FIELDS
_N_CACHE = 7    # physics.driver.CACHE_FIELDS


class PhysicsTables(NamedTuple):
    """What the physics kernel needs besides its fields: the per-level tables
    and derived scalars on the host, in the order of the kernel's argument
    struct, and sqrt(cos(lat)) on the device."""

    levels_host: np.ndarray   # (17*kx + 8,) float64, as computed
    # levels_host rounded to the model's scalar type: what the kernel
    # receives (its PhysTables<T>), so that it converts nothing per use.
    levels: np.ndarray        # (17*kx + 8,) float32 or float64
    sqrtcoa: torch.Tensor     # (il,)
    kx: int


def build_physics_tables(geom, gp, device) -> PhysicsTables:
    """geom: numpy Geometry in the model dtype; gp: GeopotTables. Every entry
    comes from the expression the plain PyTorch schemes use on the same
    geometry, so kernel and plain version see the same constants."""
    from ..physics import convection as conv
    from ..physics import large_scale_condensation as lsc
    from ..physics import shortwave_radiation as sw
    from ..physics import vertical_diffusion as vdif

    f64 = lambda x: np.asarray(x, dtype=np.float64)
    kx = np.asarray(geom.fsg).shape[0]
    rhref, dqmax, wcol = lsc.lsc_level_tables(geom)
    rsig, rsig1, drh0k, fvdiq2k, gate = vdif.vdiff_level_tables(geom)
    fshcq, fshcse, fvdiq, fvdise = vdif.vdiff_constants(geom)
    rows = [geom.fsg, geom.dhs, geom.grdsig, geom.grdscp,
            np.asarray(geom.wvi)[:, 1], conv.entrainment_profile(geom),
            rhref, dqmax, wcol, sw.sw_abs1(geom), rsig, rsig1, drh0k,
            fvdiq2k, gate, gp.xgeop1_host, gp.xgeop2_host]
    dhs = f64(geom.dhs)
    scalars = [
        pc.P0 * dhs[kx - 1] / (pc.GRAV * conv.TRCNV * 3600.0),    # fm0
        pc.RGAS * 288.0 * float(geom.sigl[kx - 1]),                # sigl_b_den
        fshcq, fshcse, fvdise,
        float(vdif.RHGRAD * (geom.fsg[kx - 1] - geom.fsg[kx - 2])),  # drh0
        float(fvdiq * geom.sigh[kx - 1]),                          # fvdiq2
        pc.EPSLW / (dhs[0] + dhs[1]),                              # eps1_strat
    ]
    levels = np.concatenate([f64(r) for r in rows] + [f64(scalars)])
    assert levels.shape == (17 * kx + 8,)
    dtype = np.asarray(geom.fsg).dtype
    coa = torch.as_tensor(f64(geom.coa), device=device).to(
        torch.float64 if dtype == np.float64 else torch.float32)
    return PhysicsTables(levels_host=np.ascontiguousarray(levels),
                         levels=np.ascontiguousarray(levels, dtype=dtype),
                         sqrtcoa=torch.sqrt(coa).contiguous(), kx=kx)


def _plane_strides(name, x, nmem, il, ix):
    """(member, latitude, longitude) element strides of a boundary field:
    shared (il, ix), zonal (il, 1), or either with a leading member axis,
    each contiguous or an expanded view of such (stride 0 on a broadcast
    axis). Anything else raises."""
    shape = tuple(x.shape)
    if x.dim() == 2:
        shape3, strides = (1,) + shape, (0,) + tuple(x.stride())
    elif x.dim() == 3:
        shape3, strides = shape, tuple(x.stride())
    else:
        raise ValueError(f"{name}: shape {shape}, expected (il, ix), "
                         f"(il, 1) or those behind a member axis")
    if (shape3[0] not in (1, nmem) or shape3[1] != il
            or shape3[2] not in (1, ix)):
        raise ValueError(
            f"{name}: shape {shape} does not broadcast to "
            f"({nmem}, {il}, {ix}) from (il, ix) or (il, 1) planes")
    eff = [0 if n == 1 else s for n, s in zip(shape3, strides)]
    # The axes that are not broadcast must be laid out contiguously.
    want, run = [0, 0, 0], 1
    for d in (2, 1, 0):
        if eff[d] != 0:
            want[d] = run
            run *= shape3[d]
    if eff != want:
        raise ValueError(
            f"{name}: strides {tuple(x.stride())} for shape {shape}: neither "
            f"contiguous nor an expanded view of a contiguous field")
    return eff


def _check_physics_inputs(phys, sw_flag, ug, vg, tg, qg, phig, pslg, bc, cache,
                          ablco2, phisg, m0corr, sppt_pattern):
    """Validate what the physics kernel is given; returns (B, kx, il, ix,
    strides) with the 1 + 3*16 element strides it takes. Raises on what the
    kernel does not take."""
    if tg.dim() != 4:
        raise ValueError(
            f"tg must be (members, kx, il, ix), got {tuple(tg.shape)}")
    nmem, kx, il, ix = tg.shape
    if kx != phys.kx or kx not in _SUPPORTED_KX:
        raise ValueError(
            f"kx={kx}: the tables hold {phys.kx} levels and the kernel is "
            f"built for kx in {_SUPPORTED_KX}")
    if tg.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {tg.dtype}: float32 or float64")

    def same(name, x):
        if x.dtype != tg.dtype or x.device != tg.device:
            raise TypeError(f"{name}: {x.dtype} on {x.device}, expected "
                            f"{tg.dtype} on {tg.device}")

    def dense(name, x, shape):
        if tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: shape {tuple(x.shape)}, expected {shape}")
        same(name, x)
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    full = (nmem, kx, il, ix)
    for name, x in (("ug", ug), ("vg", vg), ("tg", tg), ("qg", qg)):
        dense(name, x, full)
    dense("pslg", pslg, (nmem, il, ix))
    if phig is not None:
        dense("phig", phig, full)
    else:
        if phisg is None or m0corr is None:
            raise ValueError("without phig the kernel needs phisg and m0corr")
        dense("phisg", phisg, (il, ix))
        dense("m0corr", m0corr, (nmem, kx, il, 1))
    if sppt_pattern is not None:
        dense("sppt_pattern", sppt_pattern, full)
    if phys.sqrtcoa.numel() != il:
        raise ValueError(f"tables hold {phys.sqrtcoa.numel()} latitudes, "
                         f"fields {il}")
    same("tables.sqrtcoa", phys.sqrtcoa)

    if len(bc) != _N_BC:
        raise ValueError(f"expected {_N_BC} boundary fields, got {len(bc)}")
    strides = []
    if ablco2.dim() == 0:
        strides.append(0)
    elif tuple(ablco2.shape) == (nmem,):
        strides.append(ablco2.stride(0) if nmem > 1 else 0)
    else:
        raise ValueError(f"ablco2: shape {tuple(ablco2.shape)}, expected () "
                         f"or ({nmem},)")
    same("ablco2", ablco2)
    for n, x in enumerate(bc):
        same(f"bc[{n}]", x)
        strides += _plane_strides(f"bc[{n}]", x, nmem, il, ix)

    if not sw_flag:
        if len(cache) != _N_CACHE:
            raise ValueError(
                "a step without shortwave needs the 7 cache fields")
        shapes = (full, (nmem, 4, kx, il, ix), (nmem, 2, il, ix),
                  (nmem, il, ix), (nmem, il, ix), (nmem, il, ix),
                  (nmem, il, ix))
        for n, (x, shape) in enumerate(zip(cache, shapes)):
            dense(f"cache[{n}]", x, shape)
    return nmem, kx, il, ix, strides


def copy_into(out, results) -> tuple:
    """Copy each of `results` into its tensor of `out` (a tensor that is its
    own destination stays); returns `out` as a tuple. The CPU's destination
    path of the kernel wrappers."""
    out = tuple(out)
    if len(out) != len(results):
        raise ValueError(f"out: {len(out)} tensors for {len(results)} "
                         f"results")
    for dst, res in zip(out, results):
        if dst is not res:
            dst.copy_(res)
    return out


def _destinations(out, shapes, like, what: str) -> tuple:
    """`out` checked against `shapes`: dense tensors of `like`'s dtype and
    device; raises otherwise."""
    out = tuple(out)
    if len(out) != len(shapes):
        raise ValueError(f"{what}: {len(out)} tensors, expected "
                         f"{len(shapes)}")
    for n, (x, shape) in enumerate(zip(out, shapes)):
        if (tuple(x.shape) != tuple(shape) or x.dtype != like.dtype
                or x.device != like.device or not x.is_contiguous()):
            raise ValueError(
                f"{what}[{n}]: {tuple(x.shape)} {x.dtype} on {x.device}, "
                f"expected a dense {tuple(shape)} {like.dtype} on "
                f"{like.device}")
    return out


def grid_physics_cuda(consts, sw_flag, ug, vg, tg, qg, phig, pslg, bc, cache,
                      ablco2, phisg=None, m0corr=None, sppt_pattern=None,
                      out=None):
    """Launch the CUDA physics kernel on PyTorch's current stream. Same
    arguments and results as ``physics.driver.grid_physics``: (utend, vtend,
    ttend, qtend, diag, new_cache). On a step without shortwave the cache
    tensors are read in place and come back as new_cache. With
    consts.bf16_tendencies (float32 only) the four tendencies come back in
    bfloat16, rounded at the store. `out`, when given, is (diag, cache):
    dense tensors of the diagnostics' and the cache's shapes that the
    kernel stores into and that come back as diag and new_cache. The
    shortwave variant reads none of the cache: it stores the new one, so
    `out`'s cache may be the state's; on a step without shortwave the
    cache read is copied into `out`'s where the two differ. Raises if the
    inputs are not what the kernel takes, if the build fails or if the
    launch is refused; does not synchronise."""
    sw_flag = bool(sw_flag)
    phys = consts.phys
    bf16 = bool(consts.bf16_tendencies)
    if bf16 and tg.dtype != torch.float32:
        raise TypeError(f"bfloat16 tendencies need float32 inputs, got "
                        f"{tg.dtype}")
    nmem, kx, il, ix, strides = _check_physics_inputs(
        phys, sw_flag, ug, vg, tg, qg, phig, pslg, bc, cache, ablco2, phisg,
        m0corr, sppt_pattern)
    if tg.device.type != "cuda":
        raise ValueError(f"grid_physics_cuda needs CUDA tensors, got "
                         f"{tg.device}")
    fn = _load("grid_physics")

    new = lambda shape: torch.empty(shape, dtype=tg.dtype, device=tg.device)
    cache_shapes, diag_shapes = _physics_output_shapes(nmem, kx, il, ix)
    if out is None:
        diag = tuple(new(shape) for shape in diag_shapes)
        new_cache = (tuple(new(shape) for shape in cache_shapes) if sw_flag
                     else tuple(cache))
    else:
        diag = _destinations(out[0], diag_shapes, tg, "out diag")
        dst = _destinations(out[1], cache_shapes, tg, "out cache")
        new_cache = dst if sw_flag else tuple(cache)
    tends = tuple(torch.empty((nmem, kx, il, ix), device=tg.device,
                              dtype=torch.bfloat16 if bf16 else tg.dtype)
                  for _ in range(4))

    ptr = lambda x: 0 if x is None else x.data_ptr()
    ptrs = [ptr(x) for x in (ug, vg, tg, qg, phig, pslg, phisg, m0corr,
                             sppt_pattern, phys.sqrtcoa, ablco2)]
    ptrs += [ptr(x) for x in (*bc, *new_cache, *tends, *diag)]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    levels = phys.levels
    with torch.cuda.device(tg.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(tg.element_size(), int(bf16), kx, int(sw_flag),
                int(consts.sea_coupling_flag > 0), nmem, il, ix,
                ctypes.cast(c_ptrs, ctypes.c_void_p),
                ctypes.cast(c_strides, ctypes.c_void_p),
                levels.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"grid_physics kernel launch failed with code {rc} "
            f"(members={nmem}, kx={kx}, il={il}, ix={ix}, {tg.dtype}, "
            f"shortwave={sw_flag}, bf16_tendencies={bf16})")
    launch_counts[("grid_physics_sw" if sw_flag else "grid_physics_nosw")
                  + ("_bf16" if bf16 else "")] += 1
    if out is not None and not sw_flag:
        new_cache = copy_into(out[1], new_cache)
    return (*tends, diag, new_cache)


def _physics_output_shapes(nmem: int, kx: int, il: int, ix: int) -> tuple:
    """(cache shapes, diagnostic shapes) of the physics' outputs, in the
    order of physics.driver.CACHE_FIELDS and DIAG_FIELDS."""
    plane = (nmem, il, ix)
    cache = ((nmem, kx, il, ix), (nmem, 4, kx, il, ix), (nmem, 2, il, ix),
             plane, plane, plane, plane)
    rows3 = (nmem, 3, il, ix)
    diag = ((plane,) * 6 + (rows3,) * 6
            + ((nmem, 4, il, ix), (nmem, 2, kx, il, ix)))
    return cache, diag


def grid_physics(plain_fn, consts, sw_flag, ug, vg, tg, qg, phig, pslg, bc,
                 cache, ablco2, phisg=None, m0corr=None, sppt_pattern=None,
                 out=None):
    """The dispatch rule: CPU tensors take `plain_fn` (the plain PyTorch
    version, ``physics.driver.grid_physics``); CUDA tensors launch the
    kernel or raise. With `out` ((diag, cache), see grid_physics_cuda) the
    diagnostics and the cache land there and come back: the kernel stores
    into them, the plain version's results are copied in."""
    if tg.device.type == "cpu":
        res = plain_fn(consts, sw_flag, ug, vg, tg, qg, phig, pslg, bc,
                       cache, ablco2, phisg=phisg, m0corr=m0corr,
                       sppt_pattern=sppt_pattern)
        if out is None:
            return res
        return (*res[:4], copy_into(out[0], res[4]),
                copy_into(out[1], res[5]))
    return grid_physics_cuda(consts, sw_flag, ug, vg, tg, qg, phig, pslg, bc,
                             cache, ablco2, phisg=phisg, m0corr=m0corr,
                             sppt_pattern=sppt_pattern, out=out)
