"""Ensemble forecast with perturbed initial conditions
(reference: examples/Ensemble_forecast.ipynb) on the PyTorch port; the
counterpart of examples/ensemble_forecast.py.

Four members from the bundled boundary conditions, each with its own
Gaussian perturbation of the temperature, advanced together through the
member-batched runner (SpeedyEns), checkpointed daily:

    python -m pyspeedy_tpu_torch.examples.ensemble_forecast \\
        [--device cuda|cpu] [--end 1980-01-08T00:00] [--members 4]
"""

from __future__ import annotations

import argparse
from datetime import datetime

import numpy as np

from pyspeedy_tpu_torch import SpeedyEns
from pyspeedy_tpu_torch.callbacks import DiagnosticCheck, ModelCheckpoint

START = datetime(1980, 1, 1)
END = datetime(1980, 1, 8)


def main(device: str = "cuda", end_date: datetime = END,
         number_of_members: int = 4, interval: int = 36, seed: int = 42):
    """The ensemble forecast from START to end_date; returns the ensemble
    and the checkpoints' dataset."""
    model_ens = SpeedyEns(number_of_members, start_date=START,
                          end_date=end_date, device=device)

    rng = np.random.default_rng(seed)
    for member in model_ens:
        member.set_bc()
        # Gaussian perturbation of the temperature on the grid, then the
        # grid fields back to spectral space (the reference's idiom).
        t = member["t_grid"]
        member["t_grid"] = t + rng.normal(0.0, 0.01, t.shape)
        member.grid2spectral()

    checkpoints = ModelCheckpoint(interval=interval,
                                  variables=("u_grid", "t_grid"))
    model_ens.run(callbacks=[DiagnosticCheck(interval=interval),
                             checkpoints])

    ens_ds = checkpoints.dataframe
    print(ens_ds)
    # Ensemble spread of surface temperature at the last checkpoint:
    t = ens_ds["t"].data    # (time, ens, lev, lat, lon)
    spread = t[-1].std(axis=0)[-1]
    print("surface T spread [K]: mean %.4f max %.4f" % (spread.mean(),
                                                        spread.max()))
    return model_ens, ens_ds


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--end", type=datetime.fromisoformat, default=END)
    ap.add_argument("--members", type=int, default=4)
    a = ap.parse_args()
    main(a.device, a.end, a.members)
