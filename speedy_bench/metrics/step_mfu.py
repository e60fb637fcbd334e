"""The whole step's share of the card's peak outside the tensor cores
(float32, or float64 in a float64 configuration): the operations of a
member-step (counts/step.py: the transforms' folded multiply-adds, the grid
dynamics, the physics and the spectral update) times the untraced window's
member-steps a second (the host's clock), over that peak, in %."""

from .. import counts


def read(r):
    if not r.member_steps_per_s or r.trace.records == 0:
        return None
    flops, _ = counts.count("step", r.params, 1, r.sppt)
    return 100.0 * flops * r.member_steps_per_s / r.peaks[
        counts.peak_key("step", r.params)]
