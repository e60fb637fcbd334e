"""Device time of the transform kernels that the step's speed or a
diagnostic rests on, on one CUDA card, through their public wrappers only.

    python3 -m pyspeedy_tpu_torch.kernel_time [probes] [dft_chain] [hires]
        [spectral_update] [--source FILE.cu]

With no argument it times all four: the transform probes at 256 and 9,344
rows (float32 and float64), the DFT chain at 256 members, rows 3-4 at
T47 and T63 (``fused_grid2spec_many_cuda`` / ``fused_spec2grid_many_cuda``
on the step's three transform groups at B=128: the direct group of 10
fields, also from a bfloat16 grid, the dynamics' 7 inverse fields and the
physics' 5, float32 and float64; in a tree whose library keeps several
inverse designs, each of them, the plan's marked), and row 6 at T30, T47 and T63 (``spectral_update_cuda`` at B=128
on seeded inputs of the step's magnitudes, float32 and float64, into new
tensors, and in float32 also in place, into the state it reads, as the
graphs would run it without their two pair sets). The times come from the
profiler's device records: a probe, DFT-chain or spectral-update launch
through ``utils.profiling.kernel_device_ms``, a T47/T63
group as the sum over the device kernels one call launches
(``hires_kernel_plan``'s, or the earlier design's two a direction in a
tree without it) of each one's mean record, from windows that hold no
other kernel and all or all but one of its launches, two windows
agreeing. It prints the card's name and power limit, one line per time
and a JSON line with every time. Only the wrappers, their tables and
``build_consts`` / ``build_spectral`` are used, so the module also runs in
another tree of this package: copy it into that tree's package and run
both trees on one card in turns (parent, change, change, parent) to compare two designs.
``--source`` builds another version of ``csrc/fused_transform_hires.cu``
(with ``hires``) or of ``csrc/spectral_update.cu`` (with
``spectral_update``), an edit of this tree's design with the same kernels
a call, with the same flags, and times the T47/T63 groups or row 6 under
it and under the tree's own build in turns in one process (tree, other,
other, tree), the wrapper's library swapped between them; each pair of
calls is checked bitwise equal.
Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

PROBE_ROWS = (256, 9344)   # the JAX tool's rows; the step's group at B=128
DFT_MEMBERS = 256          # the JAX tool's members
HIRES_MEMBERS = 128        # the step's transform groups at B=128
UPDATE_MEMBERS = 128       # the spectral update of a step at B=128
SECTIONS = ("probes", "dft_chain", "hires", "spectral_update")


# The device kernels of a T47/T63 call in a tree whose wrappers do not
# report them (the earlier design: two kernels a direction).
PAIR_KERNELS = {"direct": ("hires_dft_fwd_kernel", "hires_leg_dir_kernel"),
                "inverse": ("hires_leg_inv_kernel", "hires_dft_inv_kernel")}


def device_ms_all(fn, kernels, reps: int = 10) -> float:
    """Device ms one call of fn spends in `kernels` (the names of the device
    kernels it launches, each once a call): the sum over them of the mean
    of each one's records in a profiled window of `reps` calls. A window
    counts only if each kernel has at least reps - 1 and at most `reps`
    records and no other kernel named ``hires_`` has any (the tracer drops
    a record now and then on an H100, for one kernel one record in every
    window of a call; the mean of what it recorded is unbiased), and the
    time is taken once two such windows agree within 5 % (their mean). A
    window that does not count is profiled again a second later, eight
    windows at most, and then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    taken = []
    for attempt in range(8):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "hires_" in e.key]
        mine = {k: [e for e in hits if k in e.key] for k in kernels}
        counts = {k: sum(e.count for e in v) for k, v in mine.items()}
        whole = sum(counts.values()) == sum(e.count for e in hits)
        if whole and all(reps - 1 <= n <= reps for n in counts.values()):
            taken.append(1e-3 * sum(
                sum(e.self_device_time_total for e in mine[k]) / counts[k]
                for k in kernels))
            if len(taken) > 1 and abs(taken[-1] - taken[-2]) \
                    <= 0.05 * min(taken[-2:]):
                return (taken[-1] + taken[-2]) / 2
            continue
        print(f"  (profiler window {attempt + 1}: records {counts} of "
              f"{reps} calls; profiling again in a second)", flush=True)
        time.sleep(1.0)
    raise RuntimeError(f"the profiler recorded no two agreeing whole "
                       f"windows of {kernels}: {taken}")


def hires_groups(sp, params, rng) -> dict:
    """The step's three transform groups at B=HIRES_MEMBERS, seeded, with
    the step's row counts (the direct group: one surface field and nine
    level stacks, also rounded to bfloat16 as bf16_tendencies hands it
    over; the dynamics' inverse group: six level stacks and the stacked
    log-ps gradient; the physics' group: four stacks, log ps, kcos 2 for
    the winds), the pair axis at 1. Returns {name: (kind, fields, kcos)}."""
    b, kx = HIRES_MEMBERS, params.kx
    tri = torch.from_numpy((np.arange(sp.mx)[:, None]
                            + np.arange(sp.nx)[None] <= sp.nx - 1)
                           .astype(np.float64)).to("cuda", sp.rdtype)
    spec = lambda *s: torch.from_numpy(rng.standard_normal(
        (b, 2) + s + (sp.mx, sp.nx))).to("cuda", sp.rdtype) * tri
    grid = lambda *s: torch.from_numpy(rng.standard_normal(
        (b,) + s + (sp.il, sp.ix))).to("cuda", sp.rdtype)
    direct = [grid()] + [grid(kx) for _ in range(9)]
    return {
        "direct": ("direct", direct, None),
        "direct, bf16 grid": ("direct", [g.to(torch.bfloat16) for g in direct],
                              None),
        "inverse, dynamics": ("inverse", [spec(kx) for _ in range(6)]
                              + [spec(2)], [1] * 7),
        "inverse, physics": ("inverse", [spec(kx) for _ in range(4)]
                             + [spec()], [2, 2, 1, 1, 1]),
    }


def other_build(name: str, source: str):
    """The C entry of `source`, a version of kernel `name`'s source
    (csrc/fused_transform_hires.cu or csrc/spectral_update.cu), built into
    the kernels' build directory with the tree's flags."""
    import ctypes
    import pathlib
    import subprocess
    from .ops import column_kernels as ck
    spec = ck.KERNELS[name]
    out = ck._BUILD_DIR / f"other_{pathlib.Path(source).stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([ck.find_nvcc(), *ck.NVCC_FLAGS, *spec.extra_flags, "-o",
                    str(out), source], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(out)), spec.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(spec.argtypes)
    return fn


def time_hires(card, rng, source=None) -> dict:
    from .ops import column_kernels as ck
    from .ops import geometry as G
    from .ops import spectral as S
    from .ops import transform_kernels as tk
    from .params import T47L8, T63L8
    out = {}
    builds = {"": None}
    if source:
        ck._load("fused_transform_hires")
        builds = {" [tree]": ck._fns["fused_transform_hires"],
                  " [other]": other_build("fused_transform_hires", source)}
    order = list(builds) + list(builds)[::-1] if source else [""]
    for base in (T47L8, T63L8):
        for prec in ("f32", "f64"):
            params = dataclasses.replace(base, precision=prec,
                                         fft_mode="matmul")
            sp = S.build_spectral(params, G.build_geometry(params),
                                  use_matmul_fft=True, device="cuda")
            plan = (tk.hires_kernel_plan(sp) if hasattr(
                tk, "hires_kernel_plan") else None)
            for name, (kind, fields, kcos) in hires_groups(
                    sp, params, rng).items():
                # The direct kernel; every inverse design the tree keeps
                # (the plan's marked), or the plan's alone in a tree that
                # cannot name them.
                designs = [(None, plan[f"{kind}_kernels"] if plan
                            else PAIR_KERNELS[kind])]
                if kind == "inverse" and hasattr(tk, "_HIRES_INVERSE"):
                    designs = [(d, kernels) for d, (_, kernels)
                               in tk._HIRES_INVERSE.items()]
                for design, kernels in designs:
                    call = lambda f=fields: tk.fused_grid2spec_many_cuda(
                        sp, f, 1)
                    if design is not None:
                        call = lambda f=fields, k=kcos, d=design: \
                            tk._spec2grid_many_design(sp, f, k, 1, d)
                    elif kind == "inverse":
                        call = lambda f=fields, k=kcos: \
                            tk.fused_spec2grid_many_cuda(sp, f, k, 1)
                    label = name if design is None else (
                        f"{name} [{design}"
                        f"{', the plan' if design == plan['inverse'] else ''}]")
                    first = None
                    for tag in order:
                        if builds[tag] is not None:
                            ck._fns["fused_transform_hires"] = builds[tag]
                            got = call()
                            first = first or got
                            if not all(torch.equal(a, b)
                                       for a, b in zip(got, first)):
                                raise RuntimeError(f"{tag} differs at T"
                                                   f"{params.trunc} {label}")
                        ms = device_ms_all(call, kernels)
                        key = f"T{params.trunc} {prec} {label}{tag}"
                        out.setdefault(key, []).append(ms)
                        print(f"rows 3-4 {key} (B={HIRES_MEMBERS}, "
                              f"{len(fields)} fields, {' + '.join(kernels)}):"
                              f" {ms:.4f} ms [{card}]", flush=True)
    if source:
        ck._fns["fused_transform_hires"] = builds[" [tree]"]
    return {k: v[0] if len(v) == 1 else v for k, v in out.items()}


def update_inputs(params, rng):
    """Seeded arguments of the spectral update at B=UPDATE_MEMBERS, dense,
    of the step's magnitudes: the 6 + 3 ntr flux spectra, then psdt and the
    state (vor, div, t at both time levels, log ps, the tracers, phi,
    tcorh, qcorh)."""
    b, kx, mx, nx, ntr = (UPDATE_MEMBERS, params.kx, params.mx, params.nx,
                          params.ntr)

    def mk(shape, scale):
        return torch.from_numpy(scale * rng.standard_normal(
            (b,) + shape)).to("cuda", params.dtype)

    lev, plane, trac = (2, kx, mx, nx), (2, mx, nx), (2, ntr * kx, mx, nx)
    specs = [mk(lev, 1e-5) for _ in range(6 + 3 * ntr)]
    state = (mk(plane, 1e-5), mk(lev, 1e-5), mk(lev, 1e-5), mk(lev, 1e-6),
             mk(lev, 1e-6), mk(lev, 10.0), mk(lev, 10.0), mk(plane, 1e-2),
             mk(plane, 1e-2), mk(trac, 1e-3), mk(trac, 1e-3), mk(lev, 1e3),
             mk(plane, 1.0), mk(plane, 1e-3))
    return specs, state


def time_spectral_update(card, rng, kernel_device_ms, source=None) -> dict:
    from .models import model as M
    from .ops import column_kernels as ck
    from .ops import glue_kernels as GK
    from .params import T30L8, T47L8, T63L8
    out = {}
    builds = {"": None}
    if source:
        ck._load("spectral_update")
        builds = {" [tree]": ck._fns["spectral_update"],
                  " [other]": other_build("spectral_update", source)}
    order = list(builds) + list(builds)[::-1] if source else [""]
    for base in (T30L8, T47L8, T63L8):
        for prec in ("f32", "f64"):
            params = dataclasses.replace(base, precision=prec,
                                         fft_mode="matmul")
            consts, _ = M.build_consts(params, device="cuda",
                                       physics_on=False)
            specs, state = update_inputs(params, rng)
            args = (consts, 2, 2 * params.delt, params.rob, specs)
            modes = {"": lambda: GK.spectral_update_cuda(*args, *state)}
            if prec == "f32":
                # into the state it reads: ps, vor, div, t, trf at both
                # time levels (the state's positions 7, 8, 1-6, 9, 10)
                own = tuple(state[i] for i in (7, 8, 1, 2, 3, 4, 5, 6, 9,
                                               10))
                modes[" in place"] = lambda: GK.spectral_update_cuda(
                    *args, *state, out=own)
            for mode, call in modes.items():
                first = None
                for tag in order:
                    if builds[tag] is not None:
                        ck._fns["spectral_update"] = builds[tag]
                        if not mode:
                            got = call()
                            first = first or got
                            if not all(torch.equal(a, b)
                                       for a, b in zip(got, first)):
                                raise RuntimeError(f"{tag} differs at T"
                                                   f"{params.trunc} {prec}")
                    ms = kernel_device_ms(call, "spectral_update_kernel")
                    key = f"T{params.trunc} {prec}{mode}{tag}"
                    out.setdefault(key, []).append(ms)
                    print(f"row 6 {key} (B={UPDATE_MEMBERS}): {ms:.4f} ms "
                          f"[{card}]", flush=True)
    if source:
        ck._fns["spectral_update"] = builds[" [tree]"]
    return {k: v[0] if len(v) == 1 else v for k, v in out.items()}


def main(argv=()) -> int:
    argv, source = list(argv), None
    if "--source" in argv:
        at = argv.index("--source")
        source = argv[at + 1] if at + 1 < len(argv) else ""
        del argv[at:at + 2]
        if not source:
            print("kernel_time: --source needs a file", file=sys.stderr)
            return 2
    sections = argv or list(SECTIONS)
    if any(s not in SECTIONS for s in sections):
        print(f"kernel_time: sections are {SECTIONS}", file=sys.stderr)
        return 2
    if source and len({"hires", "spectral_update"} & set(sections)) != 1:
        print("kernel_time: --source goes with one of the sections hires "
              "and spectral_update", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_time needs a CUDA device", file=sys.stderr)
        return 2
    from .models import model as M
    from .ops import dft_chain as DC
    from .ops import transform_kernels as tk
    from .params import T30L8
    from .utils.profiling import kernel_device_ms, nvidia_smi_line

    card = nvidia_smi_line()
    print(f"card: {card}")
    rng = np.random.default_rng(0)
    result = {"card": card, "probes": {}, "dft_chain": {}, "hires": {},
              "spectral_update": {}}
    # Each wrapper launches one kernel, named *_kernel in either design.
    for prec in ("f32", "f64") if "probes" in sections else ():
        params = dataclasses.replace(T30L8, precision=prec, fft_mode="matmul")
        consts, _ = M.build_consts(params, device="cuda", physics_on=False)
        sp = consts.sp
        for n in PROBE_ROWS:
            g = torch.from_numpy(rng.standard_normal(
                (n, sp.il, sp.ix))).to("cuda", sp.rdtype)
            for stage in tk.PROBE_STAGES:
                ms = kernel_device_ms(
                    lambda: tk.fused_probe_cuda(sp, stage, g), "_kernel")
                result["probes"][f"p{stage} {prec} {n}"] = ms
                print(f"probe p{stage} {prec} {n} rows: {ms:.4f} ms [{card}]")
    for dtype in (torch.float32, torch.float64) \
            if "dft_chain" in sections else ():
        shape = (DFT_MEMBERS, DC.NFIELDS, DC.KX, DC.IL, DC.MX)
        fre, fim = (torch.from_numpy(rng.standard_normal(shape)).to(
            "cuda", dtype) for _ in range(2))
        tabs = DC.device_tables(dtype, "cuda")
        ms = kernel_device_ms(lambda: DC.dft_chain_cuda(tabs, fre, fim),
                              "_kernel", reps=10)
        name = "f32" if dtype == torch.float32 else "f64"
        result["dft_chain"][f"{name} {DFT_MEMBERS}"] = ms
        print(f"dft_chain {name} B={DFT_MEMBERS}: {ms:.4f} ms [{card}]")
    if "hires" in sections:
        result["hires"] = time_hires(card, rng, source)
    if "spectral_update" in sections:
        result["spectral_update"] = time_spectral_update(
            card, rng, kernel_device_ms, source)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
