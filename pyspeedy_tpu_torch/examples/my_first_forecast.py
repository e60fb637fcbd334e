"""My first forecast: the pySPEEDY introductory workflow
(reference: examples/My_first_forecast.ipynb) on the PyTorch port; the
counterpart of examples/my_first_forecast.py.

Runs a two-month T30L8 forecast from the bundled climatological boundary
conditions, checkpoints daily fields after a spin-up month, and exports
NetCDF snapshots:

    python -m pyspeedy_tpu_torch.examples.my_first_forecast \\
        [--device cuda|cpu] [--end 1980-02-29T00:00] [--output-dir ./output]
"""

from __future__ import annotations

import argparse
from datetime import datetime

from pyspeedy_tpu_torch import Speedy
from pyspeedy_tpu_torch.callbacks import ModelCheckpoint, XarrayExporter

START = datetime(1980, 1, 1)
END = datetime(1980, 2, 29)
SPINUP = datetime(1980, 2, 1)


def main(device: str = "cuda", end_date: datetime = END,
         spinup_date: datetime = SPINUP, output_dir: str = "./output",
         interval: int = 36):
    """The forecast from START to end_date on `device`; returns the model
    and the checkpoints' dataset (None when no checkpoint fell after
    spinup_date)."""
    model = Speedy(start_date=START, end_date=end_date, device=device)

    # Initialize the model state from the default boundary conditions
    # (orography, land-sea mask, albedo, monthly climatologies of land/sea
    # surface conditions). See Speedy.set_bc for the NetCDF contract.
    model.set_bc()

    checkpoints = ModelCheckpoint(
        interval=interval,          # once per simulated day by default
        spinup_date=spinup_date,
        variables=("u_grid", "v_grid", "t_grid", "ps_grid"),
    )
    exporter = XarrayExporter(interval=interval, spinup_date=spinup_date,
                              output_dir=output_dir)
    model.run(callbacks=[checkpoints, exporter])

    ds = checkpoints.dataframe
    print(ds)
    # Surface (lowest-level) temperature of the final state:
    t_sfc = model["t_grid"][:, :, -1]
    print("surface T range [K]:", t_sfc.min(), t_sfc.max())
    return model, ds


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--end", type=datetime.fromisoformat, default=END)
    ap.add_argument("--output-dir", default="./output")
    a = ap.parse_args()
    main(a.device, a.end, output_dir=a.output_dir)
