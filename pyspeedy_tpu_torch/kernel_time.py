"""Device time of the two diagnostic kernels (the transform probes and the
DFT chain) on one CUDA card, through their public wrappers only.

    python3 -m pyspeedy_tpu_torch.kernel_time

The times come from ``utils.profiling.kernel_device_ms`` of the package
it runs in. Prints the card's name and power limit, one
line per probe stage at 256 and 9,344 rows (float32 and float64) and per
DFT-chain type at 256 members, and a JSON line with every time. Only
``ops.transform_kernels.fused_probe_cuda``, ``ops.dft_chain.dft_chain_cuda``
and their tables are used, so the module also runs in another tree of this
package: copy it into that tree's package and run both trees on one card in
turns (parent, change, change, parent) to compare two designs. Without a
CUDA device it exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

PROBE_ROWS = (256, 9344)   # the JAX tool's rows; the step's group at B=128
DFT_MEMBERS = 256          # the JAX tool's members


def main() -> int:
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
    result = {"card": card, "probes": {}, "dft_chain": {}}
    # Each wrapper launches one kernel, named *_kernel in either design.
    for prec in ("f32", "f64"):
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
    for dtype in (torch.float32, torch.float64):
        shape = (DFT_MEMBERS, DC.NFIELDS, DC.KX, DC.IL, DC.MX)
        fre, fim = (torch.from_numpy(rng.standard_normal(shape)).to(
            "cuda", dtype) for _ in range(2))
        tabs = DC.device_tables(dtype, "cuda")
        ms = kernel_device_ms(lambda: DC.dft_chain_cuda(tabs, fre, fim),
                              "_kernel", reps=10)
        name = "f32" if dtype == torch.float32 else "f64"
        result["dft_chain"][f"{name} {DFT_MEMBERS}"] = ms
        print(f"dft_chain {name} B={DFT_MEMBERS}: {ms:.4f} ms [{card}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
