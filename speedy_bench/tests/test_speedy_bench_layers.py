"""Every kernel that the port's CUDA sources define is matched by a
pattern of exactly one layer (layers/<layer>/*.json)."""

import re
from pathlib import Path

import pytest

from speedy_bench.trace import OTHER, layer_of, layer_patterns

CSRC = Path(__file__).resolve().parents[2] / "pyspeedy_tpu_torch" / "csrc"


def kernel_names() -> list:
    names = []
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        names += re.findall(r"__global__\s+(?:void\s+)?"
                            r"(?:__launch_bounds__\([^)]*\)\s*)?"
                            r"(?:void\s+)?(\w+)\s*\(", text)
    return sorted(set(names))


def test_found_kernels():
    assert len(kernel_names()) >= 8


@pytest.mark.parametrize("name", kernel_names())
def test_kernel_has_one_layer(name):
    pats = layer_patterns()
    hits = [layer for layer, ps in pats.items()
            if any(p.search(f"void {name}<float, 8>(Args)") for p in ps)]
    assert len(hits) == 1, hits
    assert layer_of(name, pats) != OTHER


def test_unmatched_is_torch():
    assert layer_of("void at::native::vectorized_elementwise_kernel<4>",
                    layer_patterns()) == OTHER
