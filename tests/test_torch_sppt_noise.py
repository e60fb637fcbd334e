"""SPPT's noise kernel (csrc/sppt_noise.cu, ops/sppt_noise.py) without the
JAX package: on the CPU, what the wrapper hands the kernel (each step's fold
data and offset, as draw_run_noise groups the steps), the kernel's entry in
the table, what the wrapper refuses, and a numpy model of the kernel's words
(the rotation as a funnel shift, the fold-in of the row's key) against the
plain passes; on the card, the kernel against the plain passes bitwise.
No JAX import, so that `python -m pytest tests/test_torch_sppt_noise.py -m
gpu` runs on the card's machine. The plain passes against the JAX stream
are in tests/test_torch_sppt.py.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch import constants as pc
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import sppt_noise as SN
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.params import T30L8, T47L8, T63L8
from pyspeedy_tpu_torch.physics import sppt as SP
from pyspeedy_tpu_torch.testing import make_demo_model

torch.set_num_threads(1)

PRESETS = {"T30": T30L8, "T47": T47L8, "T63": T63L8}


def noise_consts(params, device):
    """What the draw reads of the consts: the params and SPPT's tables,
    sigma from a Laplacian-eigenvalue table l(l+1)/a^2 with l = m + n."""
    l = np.add.outer(np.arange(params.mx), np.arange(params.nx))
    el2 = l * (l + 1.0) / pc.REARTH**2
    return types.SimpleNamespace(
        params=params, sppt=SP.build_sppt_tables(params, el2, device))


def expected_table(first_step, n_steps, per):
    """Each step's (group's first step, first element in the group's draw),
    from sppt_groups alone."""
    rows = []
    for s, n in SP.sppt_groups(first_step, n_steps):
        rows += [(s, j * per) for j in range(n)]
    return np.array(rows, dtype=np.int64).reshape(-1, 2)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first_step,n_steps,chunk", [
    (0, 9, 8), (1, 9, 8), (2, 9, 8), (0, 40, 8), (1, 40, 3), (2, 40, 40),
    (5, 1, 1), (3, 7, 2), (4, 2, 5)])
def test_step_table_follows_the_groups(first_step, n_steps, chunk,
                                       monkeypatch):
    """The table the wrapper hands the kernel, chunk by chunk: step i's
    fold data is the first step of its sppt_groups group and its offset the
    index of its first element in the group's draw; the chunks cover the
    run in order, chunk_steps steps each."""
    params = T30L8
    per = 2 * params.kx * params.mx * params.nx
    nmem = 3
    seen = []

    def record(consts, keys, fold, offset):
        seen.append(SN.step_table(fold, offset))
        return torch.zeros((keys.shape[0], len(fold), 1))

    monkeypatch.setattr(SP, "_draw_steps", record)
    monkeypatch.setattr(SP, "MAX_DRAW_ELEMENTS", chunk * nmem * per)
    assert SP.chunk_steps(params, nmem) == chunk
    keys = SP.split_keys(SP.key_data(0), nmem)
    steps = list(SP.draw_run_noise(types.SimpleNamespace(params=params),
                                   keys, first_step, n_steps))
    assert len(steps) == n_steps
    assert [t.shape[0] for t in seen] == (
        [chunk] * (n_steps // chunk) + [n_steps % chunk] * bool(
            n_steps % chunk))
    assert all(t.dtype == np.int64 and t.shape[1:] == (2,) for t in seen)
    assert np.array_equal(np.concatenate(seen),
                          expected_table(first_step, n_steps, per))


def test_kernel_entry_in_the_table():
    """The kernel is built like the others, with -fmad=false, and counts its
    launches under `sppt_noise`; its C function takes as many arguments as
    the table declares."""
    spec = ck.KERNELS["sppt_noise"]
    assert spec.source.name == "sppt_noise.cu" and spec.source.exists()
    assert "-fmad=false" in spec.extra_flags
    assert "-fmad=false" in ck.build_command("sppt_noise", "nvcc", "out.so")
    assert spec.counters == ("sppt_noise",)
    assert "sppt_noise" in ck.launch_counts
    src = spec.source.read_text()
    decl = src.split(f'extern "C" int {spec.symbol}(', 1)[1].split(")", 1)[0]
    assert len(decl.split(",")) == len(spec.argtypes)


def test_wrapper_refuses_before_building():
    """What the wrapper and the dispatch refuse: CPU tensors, a type other
    than float32 and float64; the map constants are JAX's."""
    keys = SP.split_keys(SP.key_data(1), 2)
    with pytest.raises(ValueError, match="CUDA"):
        SN.sppt_noise_cuda(keys, SN.step_table([0], [0]), (4,),
                           torch.float32)
    for dtype in (torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(ValueError, match="float32 or float64"):
            SN.map_constants(dtype)
        with pytest.raises(ValueError, match="float32 or float64"):
            SP.draw_noise(keys, (4,), dtype)
    lo32 = np.nextafter(np.float32(-1), np.float32(0))
    assert SN.map_constants(torch.float32) == (
        float(lo32), 2.0, float(np.float32(math.sqrt(2))))
    assert SN.map_constants(torch.float64) == (
        float(np.nextafter(-1.0, 0.0)), 2.0, math.sqrt(2))


def _rotl(x, r):
    """__funnelshift_l(x, x, r) on uint32."""
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry_model(k0, k1, x0, x1):
    """The kernel's threefry (csrc/sppt_noise.cu::threefry) in numpy
    uint32, wrapping as the card's adds do."""
    k2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0, x1 = x0 + k0, x1 + k1
    for i, rots in enumerate(((13, 15, 26, 6), (17, 29, 16, 24)) * 2
                             + ((13, 15, 26, 6),)):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


@pytest.mark.parametrize("data,offset", [(SN.NO_FOLD, 0), (0, 0), (7, 0),
                                         (SP.STATIONARY_SALT, 0),
                                         (40, 2 * 15872),
                                         (3, 2**32 - 100)])
def test_word_model_equals_the_plain_passes(data, offset):
    """A numpy model of the kernel's words for one row (its key folded with
    the table's data unless NO_FOLD, each element threefry2x32 of (0,
    offset + e) mod 2^32) against the plain passes' words, and the float32
    map's bits (x0 ^ x1) >> 9 against normals' mantissa, bit for bit."""
    key = SP.split_keys(SP.key_data(123), 2)[1]
    k0, k1 = (np.uint32(int(v)) for v in key)
    with np.errstate(over="ignore"):
        if data != SN.NO_FOLD:
            k0, k1 = _threefry_model(k0, k1, np.uint32(0), np.uint32(data))
        e = np.arange(300, dtype=np.uint32)
        x0, x1 = _threefry_model(k0, k1, np.zeros_like(e),
                                 np.uint32(offset % 2**32) + e)
    pkey = key if data == SN.NO_FOLD else SP.fold_in(key, data)
    idx = (torch.arange(300, dtype=torch.int64) + offset) & 0xFFFFFFFF
    y0, y1 = SP.threefry2x32(pkey[0], pkey[1], 0, idx)
    assert np.array_equal(x0.astype(np.int64), y0.numpy())
    assert np.array_equal(x1.astype(np.int64), y1.numpy())
    mant = ((x0 ^ x1) >> np.uint32(9)).astype(np.float32) * np.float32(2**-23)
    plain = SP.draw_noise_plain(pkey[None], (300,), torch.float32, offset)
    lo, span, sqrt2 = SN.map_constants(torch.float32)
    want = torch.erfinv(torch.from_numpy(mant) * span + lo) * sqrt2
    assert torch.equal(plain[0], want.clamp(-10.0, 10.0))


def test_cpu_draws_take_the_plain_passes():
    """On the CPU every draw takes the plain passes and launches nothing."""
    consts = noise_consts(dataclasses.replace(T30L8, kx=5), "cpu")
    keys = SP.split_keys(SP.key_data(4), 2)
    before = ck.launch_counts["sppt_noise"]
    shape = SP._pair_shape(consts.params)
    got = SP.draw_noise(keys, shape, torch.float64, 5)
    assert torch.equal(got, SP.draw_noise_plain(keys, shape, torch.float64,
                                                5))
    steps = list(SP.draw_run_noise(consts, keys, 1, 4))
    assert len(steps) == 4 and steps[0].shape == (2,) + shape
    assert ck.launch_counts["sppt_noise"] == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")


def plain_steps(consts, keys, fold, offset):
    """A chunk by the plain passes on the keys' device: sigma * eta of each
    step's key folded with its data, from its offset."""
    dev = keys.device
    gkeys = SP.fold_in(keys[:, None, :], torch.tensor(fold, device=dev))
    eta = SP.draw_noise_plain(gkeys, SP._pair_shape(consts.params),
                              consts.params.dtype,
                              torch.tensor(offset, device=dev))
    return consts.sppt.sigma * eta


def assert_same_bits(got, want, what):
    """Bitwise, or the first elements that differ shown."""
    if torch.equal(got, want):
        return
    bad = (got != want).nonzero()[:5].tolist()
    shown = [(i, float(got[tuple(i)]), float(want[tuple(i)])) for i in bad]
    raise AssertionError(f"{what}: {int((got != want).sum())} elements "
                         f"differ, first {shown}")


@pytest.mark.gpu
@pytest.mark.parametrize("nmem", [1, 3, 1024])
@pytest.mark.parametrize("trunc", ["T30", "T47", "T63"])
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_kernel_equals_the_plain_passes(precision, trunc, nmem):
    """Needs an NVIDIA GPU and nvcc: the runner's chunks (draw_run_noise)
    from first steps 0, 1 and 2 over 9 and 40 steps (1,024 members: over 9)
    against the plain passes on the card, bitwise, with one kernel launch a
    chunk; the chunks held at 1,024 members are at most 4 steps, so that the
    plain passes fit."""
    _needs_card()
    params = dataclasses.replace(PRESETS[trunc], precision=precision)
    consts = noise_consts(params, "cuda")
    keys = SP.split_keys(SP.key_data(2**31 + 77), nmem).cuda()
    per = math.prod(SP._pair_shape(params))
    runs = [(f, n) for f in (0, 1, 2) for n in ((9,) if nmem > 3 else
                                                 (9, 40))]
    old = SP.MAX_DRAW_ELEMENTS
    try:
        SP.MAX_DRAW_ELEMENTS = min(old, 4 * nmem * per)
        for first, n in runs:
            before = ck.launch_counts["sppt_noise"]
            got = list(SP.draw_run_noise(consts, keys, first, n))
            step = SP.chunk_steps(params, nmem)
            assert ck.launch_counts["sppt_noise"] - before == -(-n // step)
            table = expected_table(first, n, per)
            for i0 in range(0, n, step):
                rows = table[i0:i0 + step]
                want = plain_steps(consts, keys, rows[:, 0].tolist(),
                                   rows[:, 1].tolist())
                for j in range(want.shape[1]):
                    assert_same_bits(got[i0 + j], want[:, j],
                                     f"{precision} {trunc} B={nmem} from "
                                     f"{first} over {n}, step {i0 + j}")
            del got
    finally:
        SP.MAX_DRAW_ELEMENTS = old


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_stationary_draw_offsets_and_one_group(precision):
    """Needs an NVIDIA GPU and nvcc: the stationary draw (the key folded
    with its salt inside the kernel, scaled by stat * sigma) for one key and
    a batch, draw_noise at nonzero offsets (an int and a tensor), and
    gen_sppt_n's group draw, each one launch and bitwise the plain passes."""
    _needs_card()
    params = dataclasses.replace(T30L8, precision=precision)
    consts = noise_consts(params, "cuda")
    tables = consts.sppt
    shape = SP._pair_shape(params)
    keys = SP.split_keys(SP.key_data(9), 3).cuda()
    for key in (keys[1], keys):
        before = ck.launch_counts["sppt_noise"]
        got = SP.stationary_draw(consts, key)
        assert ck.launch_counts["sppt_noise"] == before + 1
        want = tables.stat * tables.sigma * SP.draw_noise_plain(
            SP.fold_in(key, SP.STATIONARY_SALT), shape, params.dtype)
        assert_same_bits(got, want, f"stationary draw {tuple(key.shape)}")
    per = math.prod(shape)
    for offsets in (3 * per + 17, torch.tensor([0, per, 2**32 - 5]).cuda()):
        got = SP.draw_noise(keys, shape, params.dtype, offsets)
        want = SP.draw_noise_plain(keys, shape, params.dtype, offsets)
        assert_same_bits(got, want, f"offsets {offsets}")
    group = SP._folded_noise(keys, 12, (3,) + shape, params.dtype,
                             tables.sigma)
    want = tables.sigma * SP.draw_noise_plain(SP.fold_in(keys, 12),
                                              (3,) + shape, params.dtype)
    assert_same_bits(group, want, "gen_sppt_n's group of 3")
    with pytest.raises(ValueError, match="float32 or float64"):
        SP.draw_noise(keys, shape, torch.bfloat16)


@pytest.mark.gpu
def test_sppt_noise_launches_in_runs():
    """Needs an NVIDIA GPU and nvcc: a T30L8 run of 4 steps at B=2 without
    SPPT launches no noise kernel; with SPPT the initialization launches
    three (the stationary draw and the two bootstrap steps' draws) and the
    run call one (one chunk), through the graphs and the eager loop."""
    _needs_card()
    for sppt_on in (False, True):
        params = dataclasses.replace(T30L8, precision="f32", sppt_on=sppt_on)
        ck.reset_launch_counts()
        consts, state, cal = make_demo_model(params, device="cuda")
        assert ck.launch_counts["sppt_noise"] == 3 * sppt_on
        run = TE.make_run_steps_batched(consts, device="cuda")
        for eager in (False, True):
            ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, 4)
            before = ck.launch_counts["sppt_noise"]
            run(TE.broadcast_state(state, 2), ctx, eager=eager)
            torch.cuda.synchronize()
            assert ck.launch_counts["sppt_noise"] - before == int(sppt_on)
