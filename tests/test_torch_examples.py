"""The port's examples (pyspeedy_tpu_torch/examples/) run on the CPU for a
few steps: my_first_forecast (Speedy, checkpoints and NetCDF exports) and
ensemble_forecast (SpeedyEns, perturbed members, their spread). Marked gpu
(skipped here): large_ensemble, a few chunks at the swept width on the
card."""

import os
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch.examples import (ensemble_forecast,
                                         my_first_forecast)

torch.set_num_threads(1)

# Six T30 steps (40 minutes each), a checkpoint every three.
END = timedelta(hours=4)
INTERVAL = 3


def test_my_first_forecast_runs_on_the_cpu(tmp_path):
    start = my_first_forecast.START
    model, ds = my_first_forecast.main(
        device="cpu", end_date=start + END, spinup_date=start,
        output_dir=str(tmp_path), interval=INTERVAL)
    assert model.current_date == start + END
    t = np.asarray(ds["t"].data)
    assert t.shape[0] == 2 and np.isfinite(t).all()
    files = sorted(os.listdir(tmp_path))
    assert files == ["1980-01-01_0200.nc", "1980-01-01_0400.nc"]
    t_sfc = model["t_grid"][:, :, -1]
    assert 200.0 < t_sfc.min() and t_sfc.max() < 330.0


def test_ensemble_forecast_runs_on_the_cpu():
    start = ensemble_forecast.START
    ens, ds = ensemble_forecast.main(device="cpu", end_date=start + END,
                                     number_of_members=2,
                                     interval=INTERVAL)
    t = np.asarray(ds["t"].data)           # (time, ens, lev, lat, lon)
    assert t.shape[:2] == (2, 2) and np.isfinite(t).all()
    # The members' own perturbations: they differ.
    assert np.abs(t[-1, 0] - t[-1, 1]).max() > 0.0
    assert all(m.current_date == start + END for m in ens)


@pytest.mark.gpu
def test_large_ensemble_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyspeedy_tpu_torch.examples import large_ensemble
    from pyspeedy_tpu_torch.parallel.ensemble import MEMBER_CHUNK
    chunks, msps = large_ensemble.main(device="cuda",
                                       n_members=2 * MEMBER_CHUNK, n_days=2)
    assert len(chunks) == 2 and msps > 0
    assert not any(bool(b["error_flag"].any()) for b in chunks)
