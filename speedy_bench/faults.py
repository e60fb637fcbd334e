"""Broken timed paths, each a ``program.Program`` with one fault planted
where the answer is produced, for the check to catch: the tests run them on
the CPU, ``control.py --fault <name>`` at a cell's own size on the card.

- ``unchanged``: a segment returns its state unchanged;
- ``half_left``: a segment advances the first half of its chunk's members
  and hands the rest back as they were;
- ``altered``: a segment's last member's temperature is altered by a
  hundredth of its spectrum;
- ``shared_key``: with SPPT, every member of a chunk draws its noise with
  the chunk's first member's key;
- ``no_noise``: with SPPT, the noise is drawn as zeros."""

from __future__ import annotations

import torch

from .program import Program

__all__ = ["FAULTS"]


class Unchanged(Program):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.run = lambda state, ctx: dict(state)


class HalfLeft(Program):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        run = self.run

        def half(state, ctx):
            out = run(state, ctx)
            n = out["vor"][0].shape[0] // 2
            for name in ("vor", "div", "t", "ps", "tr"):
                out[name] = tuple(torch.cat([a[:n], b[n:]]) for a, b in
                                  zip(out[name], state[name]))
            return out
        self.run = half


class Altered(Program):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        run = self.run

        def altered(state, ctx):
            out = run(state, ctx)
            t = [a.clone() for a in out["t"]]
            for a in t:
                a[-1] *= 1.01
            out["t"] = tuple(t)
            return out
        self.run = altered


class SharedKey(Program):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        for st in self.chunks:
            st["sppt_key"] = st["sppt_key"][:1].expand_as(
                st["sppt_key"]).clone()


class NoNoise(Program):
    def __init__(self, *a, **k):
        from pyspeedy_tpu_torch.physics import sppt as SP

        super().__init__(*a, **k)
        run, draw = self.run, SP.draw_run_noise

        def zeros(*args):
            return (torch.zeros_like(x) for x in draw(*args))

        def quiet(state, ctx):
            SP.draw_run_noise = zeros
            try:
                return run(state, ctx)
            finally:
                SP.draw_run_noise = draw
        self.run = quiet


FAULTS = {"unchanged": Unchanged, "half_left": HalfLeft, "altered": Altered,
          "shared_key": SharedKey, "no_noise": NoNoise}
