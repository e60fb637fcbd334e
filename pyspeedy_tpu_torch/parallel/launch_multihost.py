"""Multi-process launcher and worker for the sharded ensemble path.

Counterpart of the JAX package's ``tools/launch_multihost.py``. The launcher
spawns N local worker processes (the ``spawn`` start method), which meet at a
TCP store on 127.0.0.1, make the ("ensemble", "space") mesh, build the same
demo model each, take their piece of a sharded ensemble and run 6 steps of
the batched runner on the mesh, then check their piece against the
single-process trajectory and, with SPPT, that the members diverge. This is
the code a multi-node run uses (initialize_distributed, make_hybrid_mesh,
make_global_ensemble, make_run_steps_batched(mesh=...)), on one host.

    python -m pyspeedy_tpu_torch.parallel.launch_multihost N_PROC \\
        [--n-space K] [--device cpu|cuda] [--backend gloo|nccl]

Each worker prints one JSON line; the launcher prints a summary line after
them and exits non-zero when a worker failed (a failed worker ends the
others). On a cluster, run one worker per rank with torchrun's variables
set and call the same ``worker`` path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import socket
import sys
import time

N_STEPS = 6
MEMBERS_PER_ENSEMBLE_ROW = 2
LIMIT = 1e-10         # largest difference relative to the field's largest
COMPARED = ("vor", "div", "t", "ps", "tr", "land_temp", "tt_rsw", "precnv")
TIMEOUT_S = 900


def _expand_members(state: dict, n_members: int) -> dict:
    """A B=1 member-batched state as n_members copies (expanded views)."""
    from ..models import model as M

    def rep(name, a):
        if name in M.DYNAMIC_FIELDS and a.dim() > M.single_member_ndim(name):
            return a.expand(n_members, *a.shape[1:])
        return a

    return {k: (tuple(rep(k, a) for a in v) if isinstance(v, tuple)
                else rep(k, v)) for k, v in state.items()}


def _rel_err(got, want) -> float:
    scale = float(want.abs().max())
    diff = float((got.double() - want.double()).abs().max())
    return diff / scale if scale > 0 else diff


def worker(rank: int, world: int, n_space: int, device: str, backend: str,
           init_method: str) -> None:
    import torch
    import torch.distributed as dist

    from ..models import model as M
    from ..params import T30L8
    from ..testing import make_demo_model
    from . import distributed as D
    from .ensemble import broadcast_state, make_run_steps_batched
    from .mesh import local_shard, mesh_shape

    if device == "cpu":
        torch.set_num_threads(1)
    D.initialize_distributed(init_method, world, rank, backend, device)
    dev = D.rank_device()
    mesh = D.make_hybrid_mesh(n_space)
    n_ens = mesh_shape(mesh)["ensemble"]
    n_members = MEMBERS_PER_ENSEMBLE_ROW * n_ens
    params = dataclasses.replace(T30L8, fft_mode="matmul")

    consts, state, cal = make_demo_model(params, device=dev)
    local = D.make_global_ensemble(state, n_members, mesh)
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), 2, N_STEPS)
    out = make_run_steps_batched(consts, device=dev, mesh=mesh)(local, ctx)
    # The single-process trajectory (members are unperturbed copies of it),
    # cut as this rank's piece.
    ref = make_run_steps_batched(consts, device=dev)(
        broadcast_state(state, 1), ctx)
    ref = local_shard(mesh, _expand_members(ref, n_members))
    max_err = 0.0
    for name in COMPARED:
        pairs = (zip(out[name], ref[name]) if isinstance(out[name], tuple)
                 else [(out[name], ref[name])])
        for got, want in pairs:
            if got.shape != want.shape:
                raise RuntimeError(f"{name}: shape {tuple(got.shape)}, "
                                   f"expected {tuple(want.shape)}")
            max_err = max(max_err, _rel_err(got, want))
    ok = max_err <= LIMIT and not bool(out["error_flag"].any())

    # SPPT: each member draws its own noise, so the members of this rank's
    # row diverge, and the spectrum has advanced.
    params_s = dataclasses.replace(params, sppt_on=True)
    consts_s, state_s, cal_s = make_demo_model(params_s, device=dev)
    local_s = D.make_global_ensemble(state_s, n_members, mesh)
    ctx_s, _ = M.build_step_ctx(dataclasses.replace(cal_s), 2, N_STEPS)
    out_s = make_run_steps_batched(consts_s, device=dev, mesh=mesh)(
        local_s, ctx_s)
    t0 = out_s["t"][0]
    spread = float((t0[1:] - t0[:1]).abs().max()) if t0.shape[0] > 1 else -1
    advanced = float((out_s["sppt_spec"] - local_s["sppt_spec"]).abs().max())
    sppt_ok = (spread > 1e-10 and advanced > 0.0
               and not bool(out_s["error_flag"].any()))
    ok = ok and sppt_ok

    members = D.process_local_members(n_members, mesh)
    # One write of the whole line: the workers share the launcher's stdout
    # and print at the same moment, and an unbuffered print writes the
    # line and its newline apart.
    sys.stdout.write(json.dumps({
        "rank": rank, "world": world, "device": str(dev),
        "backend": dist.get_backend(),
        "group_backends": {d: dist.get_backend(mesh.get_group(d))
                           for d in ("ensemble", "space")},
        "mesh": mesh_shape(mesh), "members": [members.start, members.stop],
        "max_rel_err_vs_single": max_err, "limit": LIMIT,
        "sppt_member_spread": spread, "sppt_spec_advanced": advanced,
        "sppt_ok": sppt_ok, "ok": ok}) + "\n")
    sys.stdout.flush()
    dist.barrier()
    dist.destroy_process_group()
    if not ok:
        sys.exit(1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(target, n_proc: int, args: tuple,
                timeout_s: float = TIMEOUT_S) -> list:
    """Spawn n_proc processes target(rank, *args), wait for all of them and
    return their exit codes. When one fails the others are ended (they would
    wait in a collective); after timeout_s all are."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args))
             for r in range(n_proc)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            failed = any(p.exitcode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return [p.exitcode for p in procs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_proc", type=int)
    ap.add_argument("--n-space", type=int, default=1)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    a = ap.parse_args(argv)
    if a.device == "cuda":
        # Build the kernels once here, not in every worker.
        from ..ops.column_kernels import build_kernels
        build_kernels()
    init = f"tcp://127.0.0.1:{free_port()}"
    codes = run_workers(worker, a.n_proc,
                        (a.n_proc, a.n_space, a.device, a.backend, init))
    ok = all(c == 0 for c in codes)
    print(json.dumps({"multihost_ok": ok, "n_processes": a.n_proc,
                      "n_space": a.n_space, "device": a.device,
                      "backend": a.backend, "exit_codes": codes}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
