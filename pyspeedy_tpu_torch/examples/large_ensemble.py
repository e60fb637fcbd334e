"""A large batched ensemble on one GPU: the runner API directly; the
counterpart of examples/large_ensemble_tpu.py.

1,024 T30L8 members advance in chunks of the swept width
(parallel/ensemble.py::MEMBER_CHUNK, pick_member_chunk), each chunk one
member-batched run call a day through the runner's CUDA graphs; each
member starts from its own perturbation of the surface temperature. For
the reference-style object API at small member counts see
ensemble_forecast.py (SpeedyEns batches the same way under the hood).

    python -m pyspeedy_tpu_torch.examples.large_ensemble \\
        [--device cuda|cpu] [--members 1024] [--days 5]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from pyspeedy_tpu_torch.models import model as M
from pyspeedy_tpu_torch.parallel.ensemble import (broadcast_state,
                                                  make_run_steps_batched,
                                                  pick_member_chunk)
from pyspeedy_tpu_torch.params import T30L8
from pyspeedy_tpu_torch.testing import make_demo_model


def main(device: str = "cuda", n_members: int = 1024, n_days: int = 5,
         seed: int = 0):
    """n_members members for n_days days (the first day's run calls capture
    the graphs and are not timed); returns the member chunks' states and
    the member-steps per second of the timed days."""
    precision = "f64" if device == "cpu" else "f32"
    params = dataclasses.replace(T30L8, precision=precision,
                                 fft_mode="matmul")
    consts, state, cal = make_demo_model(params, device=device)
    n_day = params.nsteps
    chunk = pick_member_chunk(n_members, params)
    run = make_run_steps_batched(consts, device=device)

    # Perturbed initial conditions: seeded noise on each member's spectral
    # temperature.
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(n_members // chunk):
        b = broadcast_state(state, chunk)
        t0, t1 = b["t"]
        pert = torch.from_numpy(rng.normal(0.0, 1e-3, t0.shape)).to(
            device=t0.device, dtype=t0.dtype)
        b["t"] = (t0 + pert, t1)
        chunks.append(b)

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ctx, cal = M.build_step_ctx(cal, 2, n_day)
    chunks = [run(b, ctx) for b in chunks]      # the graphs' capture
    sync()

    t0 = time.perf_counter()
    stepno = 2 + n_day
    for _ in range(n_days - 1):
        ctx, cal = M.build_step_ctx(cal, stepno, n_day)
        chunks = [run(b, ctx) for b in chunks]
        stepno += n_day
    sync()
    wall = time.perf_counter() - t0
    msps = n_members * (n_days - 1) * n_day / wall
    print(f"{n_members} members in chunks of {chunk} x {n_days - 1} days: "
          f"{msps:.0f} member-steps/s")

    # Every member's last-step diagnostics are current (the runner returns
    # them member-batched): ensemble-mean convective precipitation and the
    # spread of the surface-level spectral mean temperature.
    precnv = torch.cat([b["precnv"] for b in chunks]).double()
    tmean = torch.cat([b["t"][0][:, 0, -1, 0, 0] for b in chunks]).double()
    errors = torch.cat([b["error_flag"].reshape(-1) for b in chunks])
    print(f"ensemble-mean precnv: {float(precnv.mean()):.3f} mm/day; "
          f"surface-T spread: {float(tmean.std() / np.sqrt(2.0)):.3f} K; "
          f"failed members: {int(errors.sum())}")
    return chunks, msps


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--members", type=int, default=1024)
    ap.add_argument("--days", type=int, default=5)
    a = ap.parse_args()
    main(a.device, a.members, a.days)
