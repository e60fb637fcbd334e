"""SPPT stochastic physics pattern (reference: speedy.f90/sppt.f90).

The spectral AR(1) state persists across steps in the model state, and the
noise is a keyed, reproducible stream per member, as in the JAX package
(which documents both as deliberate divergences from the reference).

The stream is the JAX package's own, bit for bit: its keys are threefry2x32
key pairs, and the noise of a group of n steps that starts at step s is
``jax.random.normal(fold_in(member_key, s), (n, 2, kx, mx, nx))`` clipped to
+-10, drawn with partitionable threefry (each element's bits are threefry2x32
of the key and the element's flat index). Here the same words come from
integer tensor arithmetic on the CPU (draw_noise_plain: uint32 bit patterns
held in int32 tensors, whose additions wrap modulo 2^32), and on the card
from one kernel launch a chunk (ops/sppt_noise.py, csrc/sppt_noise.cu: the
same words, each element's computed in registers where it is stored). The
bits to normal map is JAX's too (a uniform on (-1, 1) from the mantissa
bits, then sqrt(2) * erfinv), so the normals agree with JAX's to the
rounding of erfinv; the kernel's are the plain passes' on the same card.

A key is carried as its two words in an int64 tensor: (2,) for one member,
(B, 2) member-batched.

The runner (parallel/ensemble.py) draws the noise of a run call in chunks of
many steps (draw_run_noise: on the card one kernel launch a chunk, the group
keys folded inside it; on the CPU the plain passes), and hands each step its
slice;
the step advances the AR(1) spectrum (advance) and the physics' inverse
transform group takes the spectrum to the grid (physics/driver.py), where
the clip to +-1 follows and the physics kernel multiplies it in.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as pc
from ..ops import sppt_noise as SN
from ..utils.profiling import span

__all__ = ["gen_sppt", "gen_sppt_n", "init_sppt_state", "stationary_draw",
           "build_sppt_tables", "SpptTables", "threefry2x32", "fold_in",
           "split_keys", "key_data", "normals", "draw_noise",
           "draw_noise_plain", "advance", "sppt_groups", "chunk_steps",
           "draw_run_noise"]

TIME_DECORR = 6.0       # decorrelation time [h]
LEN_DECORR = 500000.0   # correlation length [m]
STDDEV = 0.33           # grid-space standard deviation

# Salt of the stationary draw's key (JAX physics/sppt.py::stationary_draw).
STATIONARY_SALT = 0x5bb7
# Elements of one chunk of a run call's noise (the output, and on the CPU
# int32 temporaries of this many elements, a few alive at once): a T30L8
# run call of 36 steps at 128 members (73 M elements) is one chunk.
MAX_DRAW_ELEMENTS = 1 << 27

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


class SpptTables(NamedTuple):
    """The AR(1) constants."""

    sigma: torch.Tensor  # (1, 1, mx, nx) wavenumber amplitude (sppt.f90:84-92)
    phi: float           # AR(1) coefficient exp(-dt/tau)
    stat: float          # stationary-variance factor (1-phi^2)^(-1/2)


def build_sppt_tables(params, el2_np: np.ndarray, device) -> SpptTables:
    """Wavenumber-dependent amplitude and AR(1) coefficients
    (sppt.f90:30-92); el2_np is the Laplacian-eigenvalue table l(l+1)/a^2,
    (mx, nx). sigma is computed in float64 and rounded to the model dtype."""
    phi = float(np.exp(-(24.0 / params.nsteps) / TIME_DECORR))
    n = np.arange(1, params.trunc + 1, dtype=np.float64)
    f0 = np.sum((2 * n + 1) * np.exp(
        -0.5 * (LEN_DECORR / pc.REARTH) ** 2 * n * (n + 1)))
    f0 = np.sqrt((STDDEV**2 * (1 - phi**2)) / (2 * f0))
    sigma = f0 * np.exp(-0.25 * LEN_DECORR**2 * np.asarray(el2_np, np.float64))
    sigma = torch.from_numpy(sigma[None, None].astype(params.np_dtype))
    return SpptTables(sigma=sigma.to(device), phi=phi,
                      stat=float((1 - phi**2) ** (-0.5)))


# ---------------------------------------------------------------------------
# threefry2x32 on int32 tensors
# ---------------------------------------------------------------------------

def _as_i32(v, device):
    """uint32 words (an int, or an int64 tensor holding values in [0, 2^32))
    as int32 tensors with the same bits."""
    if not torch.is_tensor(v):
        v = torch.tensor(v & _M32, dtype=torch.int64, device=device)
    return ((v + 2**31) % 2**32 - 2**31).to(torch.int32)


def _threefry_i32(k0, k1, x0, x1):
    """threefry2x32 on int32 tensors holding uint32 bit patterns: additions
    wrap modulo 2^32, a rotation masks the sign bits an arithmetic right
    shift brings in. The key schedule is computed on the (small) key
    tensors, so a round costs six passes over the counters."""
    ks = (k0, k1, k0 ^ k1 ^ _as_i32(_KS_PARITY, k0.device))
    inject = [(ks[(i + 1) % 3], ks[(i + 2) % 3] + (i + 1)) for i in range(5)]
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))) ^ x0
        x0 = x0 + inject[i][0]
        x1 = x1 + inject[i][1]
    return x0, x1


def threefry2x32(k0, k1, x0, x1):
    """threefry2x32 with 20 rounds (Salmon et al. 2011; JAX's
    threefry2x32_p) of the counter words (x0, x1) under the key words
    (k0, k1): int64 tensors (or ints) holding uint32 values, broadcast
    against each other. Returns the two output words, int64 in [0, 2^32)."""
    ref = next(v for v in (x1, x0, k0, k1) if torch.is_tensor(v))
    y0, y1 = _threefry_i32(*(_as_i32(v, ref.device) for v in (k0, k1, x0, x1)))
    return y0.to(torch.int64) & _M32, y1.to(torch.int64) & _M32


def key_data(seed: int = 0, device="cpu") -> torch.Tensor:
    """The key of an integer seed below 2^32 (JAX's jax.random.key(seed)
    for the threefry2x32 implementation): the words (0, seed)."""
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in of keys (..., 2) with uint32 data (an int or a
    tensor broadcast against the keys' leading axes): threefry2x32 of the
    counter (0, data). Returns keys (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data & _M32)
    return torch.stack([x0, x1], dim=-1)


def split_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.split(key, n) of one key (2,) under partitionable
    threefry: key i is threefry2x32 of the counter (0, i), the same as
    fold_in(key, i). Returns (n, 2)."""
    return fold_in(key, torch.arange(n, device=key.device))


def normals(x0: torch.Tensor, x1: torch.Tensor, dtype) -> torch.Tensor:
    """jax.random.normal's map from an element's threefry words (int32
    tensors holding the uint32 bits) to a standard normal in `dtype`.
    float64 takes the 64 bits x0:x1, float32 the 32 bits x0 ^ x1; the
    mantissa bits give a float in [0, 1), mapped to the uniform u on (-1, 1)
    as JAX maps it (u = f * (hi - lo) + lo with lo = nextafter(-1, 0), both
    in `dtype`), then sqrt(2) * erfinv(u)."""
    lo, span, sqrt2 = SN.map_constants(dtype)
    if dtype == torch.float64:
        hi = x0.to(torch.int64) & _M32
        lo_bits = x1.to(torch.int64) & _M32
        mant = (hi << 20) | (lo_bits >> 12)         # top 52 of 64 bits
        f = mant.to(torch.float64) * 2.0**-52
    else:
        mant = ((x0 ^ x1) >> 9) & 0x7FFFFF          # top 23 of 32 bits
        f = mant.to(torch.float32) * 2.0**-23
    u = torch.clamp_min(f * span + lo, lo)
    return torch.erfinv(u) * sqrt2


def draw_noise(keys: torch.Tensor, shape, dtype, offsets=0) -> torch.Tensor:
    """Clipped standard normals of JAX's stream: for each key (..., 2) and
    each element index offset + e (e over `shape`, row-major), the normal of
    threefry2x32(key, (0, index)), clipped to +-10. `offsets` (an int or a
    tensor) broadcasts against the keys' leading axes. Returns
    (*lead, *shape) in `dtype`. On the card one kernel launch
    (ops/sppt_noise.py), which raises for a type other than float32 and
    float64; on the CPU draw_noise_plain."""
    if keys.device.type != "cuda":
        return draw_noise_plain(keys, shape, dtype, offsets)
    lead = torch.broadcast_shapes(keys.shape[:-1], torch.as_tensor(
        offsets).shape)
    rows = math.prod(lead)
    keys = keys.expand(*lead, 2).reshape(rows, 2)
    if torch.is_tensor(offsets) and offsets.dim():
        offs = offsets.to(device=keys.device, dtype=torch.int64)
        table = torch.stack([torch.full_like(offs, SN.NO_FOLD), offs],
                            dim=-1).expand(*lead, 2).reshape(rows, 1, 2)
    else:
        table = SN.step_table([SN.NO_FOLD], [int(offsets)])
    eta = SN.sppt_noise_cuda(keys, table, shape, dtype)
    return eta.reshape(*lead, *shape)


def draw_noise_plain(keys: torch.Tensor, shape, dtype,
                     offsets=0) -> torch.Tensor:
    """draw_noise as int32 tensor passes, on any device: threefry2x32
    (_threefry_i32) over the element indices, then normals and the clip.
    The CPU's path, and the card's kernel's plain version."""
    per = math.prod(shape)
    dev = keys.device
    offsets = torch.as_tensor(offsets, device=dev)
    lead = torch.broadcast_shapes(keys.shape[:-1], offsets.shape)
    idx = (offsets.to(torch.int32)[..., None]
           + torch.arange(per, dtype=torch.int32, device=dev))
    x0, x1 = _threefry_i32(_as_i32(keys[..., 0, None], dev),
                           _as_i32(keys[..., 1, None], dev),
                           torch.zeros((), dtype=torch.int32, device=dev),
                           idx)
    eta = normals(x0, x1, dtype).clamp_(-10.0, 10.0)
    return eta.reshape(*lead, *shape)


def _pair_shape(params):
    return (2, params.kx, params.mx, params.nx)


def init_sppt_state(params, key: torch.Tensor | None = None,
                    device="cpu") -> dict:
    """Initial AR(1) state: a zero spectrum (2, kx, mx, nx) and the member's
    key (JAX's jax.random.key(0) when none is given). model.initialize
    replaces the zeros with stationary_draw."""
    if key is None:
        key = key_data(0, device)
    return {"sppt_spec": torch.zeros(_pair_shape(params), dtype=params.dtype,
                                     device=device),
            "sppt_key": key.to(device=device, dtype=torch.int64)}


def stationary_draw(consts, key: torch.Tensor) -> torch.Tensor:
    """Stationary-variance AR(1) state (sppt.f90:92): stat * sigma * eta,
    eta from the key folded with STATIONARY_SALT. key (..., 2) gives
    (..., 2, kx, mx, nx)."""
    params = consts.params
    tables = consts.sppt
    if key.device.type == "cuda":
        return _folded_noise(key, STATIONARY_SALT, _pair_shape(params),
                             params.dtype, tables.stat * tables.sigma)
    eta = draw_noise(fold_in(key, STATIONARY_SALT), _pair_shape(params),
                     params.dtype)
    return tables.stat * tables.sigma * eta


def _folded_noise(key, data: int, shape, dtype, scale):
    """scale * eta of the keys (..., 2) folded with `data`, from element 0:
    one kernel launch, the fold-in inside it. Returns (..., *shape)."""
    lead = key.shape[:-1]
    eta = SN.sppt_noise_cuda(key.reshape(-1, 2),
                             SN.step_table([data], [0]), shape, dtype, scale)
    return eta.reshape(*lead, *shape)


def advance(tables: SpptTables, spec: torch.Tensor,
            sigma_eta: torch.Tensor, out=None) -> torch.Tensor:
    """One AR(1) step of the spectrum: phi * spec + sigma * eta, into `out`
    when given (which may be `spec` itself)."""
    return torch.add(tables.phi * spec, sigma_eta, out=out)


def gen_sppt_n(consts, state, n: int, stepno):
    """Advance the AR(1) spectrum n steps and return the n grid-space
    multiplicative fields, clipped to +-1 (sppt.f90:40-111), with the noise
    of the group that starts at step `stepno`. The state is one member's
    (key (2,), spectrum (2, kx, mx, nx)) or member-batched (key (B, 2),
    spectrum (B, 2, kx, mx, nx)). Returns (patterns (n, [B,] kx, il, ix),
    state with the new spectrum). The model's runner does not call this:
    it draws a run call's noise at once and transforms each step's
    spectrum inside the physics' transform group."""
    from ..ops import spectral as S

    params = consts.params
    key = state["sppt_key"]
    shape = (n,) + _pair_shape(params)
    if key.device.type == "cuda":
        se = _folded_noise(key, int(stepno), shape, params.dtype,
                           consts.sppt.sigma)
    else:
        eta = draw_noise(fold_in(key, int(stepno)), shape, params.dtype)
        se = consts.sppt.sigma * eta             # (..., n, 2, kx, mx, nx)
    spec = state["sppt_spec"]
    specs = []
    for j in range(n):
        spec = advance(consts.sppt, spec, se[..., j, :, :, :, :])
        specs.append(spec)
    stacked = torch.stack(specs, dim=0)          # (n, ..., 2, kx, mx, nx)
    patterns = torch.clamp(
        S.spec2grid_p(consts.sp, stacked, 1, stacked.dim() - 4), -1.0, 1.0)
    state = dict(state)
    state["sppt_spec"] = spec
    return patterns, state


def gen_sppt(consts, state, stepno):
    """Single-step gen_sppt_n."""
    patterns, state = gen_sppt_n(consts, state, 1, stepno)
    return patterns[0], state


# ---------------------------------------------------------------------------
# The noise of a run call
# ---------------------------------------------------------------------------

def sppt_groups(first_step: int, n_steps: int) -> list:
    """[(stepno of the group's first step, steps in the group)] of an
    n_steps run from first_step, as the JAX package's batched runner groups
    its pattern draws (parallel/ensemble.py::run_aligned): one group per
    step before the first shortwave step (stepno % 3 == 0), then triples
    from there, and the last triple together with the 1-2 steps left over."""
    q = min((3 - first_step % 3) % 3, n_steps)
    groups = [(first_step + j, 1) for j in range(q)]
    m = n_steps - q
    n_triples = m // 3
    s = first_step + q
    for _ in range(max(n_triples - 1, 0)):
        groups.append((s, 3))
        s += 3
    tail = m - 3 * max(n_triples - 1, 0)
    if tail:
        groups.append((s, tail))
    return groups


def chunk_steps(params, nmem: int) -> int:
    """Steps of one chunk of draw_run_noise at nmem members: as many as
    MAX_DRAW_ELEMENTS holds, at least one."""
    per = math.prod(_pair_shape(params))
    return max(1, MAX_DRAW_ELEMENTS // (nmem * per))


def draw_run_noise(consts, keys: torch.Tensor, first_step: int,
                   n_steps: int):
    """sigma * eta for each step of an n_steps run call from first_step,
    member-batched: an iterator over n_steps tensors (B, 2, kx, mx, nx),
    grouped as sppt_groups groups them: step i takes its group's key (the
    member's key folded with the group's first step) from element offset i
    of the group's draw. The steps are drawn in chunks of chunk_steps
    steps, a chunk when the one before is used up: on the card one kernel
    launch a chunk (a T30L8 run call of 36 steps at 128 members is one
    chunk), and however long the run, at most one chunk is alive while the
    caller keeps no step it has used."""
    per = math.prod(_pair_shape(consts.params))
    fold, offset = [], []
    for s, n in sppt_groups(first_step, n_steps):
        fold += [s] * n
        offset += [j * per for j in range(n)]
    step_chunk = chunk_steps(consts.params, keys.shape[0])
    for i0 in range(0, n_steps, step_chunk):
        i1 = min(n_steps, i0 + step_chunk)
        chunk = _draw_steps(consts, keys, fold[i0:i1], offset[i0:i1])
        for j in range(i1 - i0):
            yield chunk[:, j]
        del chunk


def _draw_steps(consts, keys, fold, offset):
    """One chunk of draw_run_noise: sigma * eta of the steps whose keys are
    the member keys `keys` (B, 2) folded with `fold` and whose first
    elements are at `offset` in their groups' draws. Returns (B, steps, 2,
    kx, mx, nx). On the card one kernel launch (the fold-in inside it), on
    the CPU the plain passes. Under the span `sppt.draw`."""
    with span("sppt.draw"):
        params = consts.params
        shape = _pair_shape(params)
        if keys.device.type == "cuda":
            return SN.sppt_noise_cuda(keys, SN.step_table(fold, offset),
                                      shape, params.dtype, consts.sppt.sigma)
        dev = keys.device
        gkeys = fold_in(keys[:, None, :], torch.tensor(
            fold, dtype=torch.int64, device=dev))          # (B, steps, 2)
        offs = torch.tensor(offset, dtype=torch.int64, device=dev)
        eta = draw_noise_plain(gkeys, shape, params.dtype, offs)
        return consts.sppt.sigma * eta
