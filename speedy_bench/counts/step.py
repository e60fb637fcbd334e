"""A whole step: the sum of the layers' counts (transforms, grid
dynamics, physics, spectral update). The PyTorch passes between them are
left out: they add bytes and few operations, so the step's share of the
peak is a floor."""

from . import count as layer_count

LAYERS = ("transforms", "grid_dynamics", "physics", "spectral_update")


def count(params, members: int, sppt: bool) -> tuple:
    parts = [layer_count(name, params, members, sppt) for name in LAYERS]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)
