// Grid-point dynamical core of one leapfrog step, for NVIDIA Hopper (sm_90a).
//
// Replaces: pyspeedy_tpu/ops/pallas_tiling.py::tiled_columnwise run over
//   pyspeedy_tpu/models/tendencies.py::grid_dynamics_core (the latitude-tiled
//   Pallas kernel of the JAX package). The plain PyTorch version of the same
//   function is pyspeedy_tpu_torch/models/tendencies.py::grid_dynamics_core.
//
// Computes, for every (member, latitude, longitude) column: the cos-latitude
// rescale of the winds and the log-ps gradient, the Coriolis add, the
// sigma-weighted vertical means, the grid-space log-ps tendency, the two
// sigma-dot recursions over half levels (the bottom half level keeps the
// accumulated sum), the u/v/T/tracer tendencies with vertical advection (the
// tracer flux is zeroed at half levels 1 and 2), the flux products -uT, -vT,
// -uq, -vq (times 1/cos) and the kinetic energy.
//
// Bound: bytes to and from device memory. A column reads 6*kx + 2 values
// (+ kx for each tracer) and writes 6*kx + 1 (+ 3*kx for each tracer):
// 123 values at kx=8 with one tracer, 4,608 columns per T30 member, so
// 2.27 MB (float) or 4.53 MB (double) per member and launch. At 128 members
// that is 290 MB, which an H100 at 3.35 TB/s cannot move in less than 87 us
// (174 us in double). The arithmetic is a few hundred operations per column.
//
// Design: one thread per column, longitude fastest, so a warp reads 32
// consecutive longitudes of each level plane (coalesced, level stride il*ix).
// The kx levels of every field and both half-level recursions live in
// registers (KX is a template parameter and every level loop is unrolled), so
// each input is read once and each output written once and no intermediate
// touches device memory. The per-level tables ride in the kernel's argument
// struct; 1/cos(lat) and the Coriolis parameter are (il,) vectors. A variant
// with two adjacent longitudes per thread (8- and 16-byte loads) was timed
// on an H100 at 128 members and was no faster in float or double, so the
// scalar form stays.
//
// Output types: the model's scalar type, or (float only, `out_bf16`) all ten
// outputs rounded to bfloat16, to nearest even, from the float value at the
// store: the 2-byte operands of the bf16_tendencies configuration, whose
// direct transforms read them as they are.
//
// Interface: plain C, loaded with ctypes. The launch goes to the stream it is
// given, allocates nothing and does not synchronise; the function returns
// cudaGetLastError() (0 on success), or a negative code for arguments the
// kernel was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 128;

// Per-level tables and the two physical constants, as doubles already rounded
// to the model's scalar type by the caller.
struct ColumnTables {
  double dhs[kMaxLevels];    // layer thickness
  double dhsr[kMaxLevels];   // 1 / (2 dhs)
  double fsgr[kMaxLevels];   // akap / (2 fsg)
  double tref[kMaxLevels];   // reference temperature profile
  double tref3[kMaxLevels];  // fsgr * tref
  double rgas;
  double akap;
};

// Store one output value: as it is, or rounded to bfloat16 (float only).
template <bool BF16, typename T>
__device__ __forceinline__ void put(void* __restrict__ p, long long o, T v) {
  if constexpr (BF16)
    static_cast<__nv_bfloat16*>(p)[o] = __float2bfloat16_rn(static_cast<float>(v));
  else
    static_cast<T*>(p)[o] = v;
}

template <typename T, int KX, bool BF16>
__global__ void __launch_bounds__(kThreads)
grid_dynamics_kernel(
    long long ncol, int ntr, int il, int ix,
    const T* __restrict__ vorg, const T* __restrict__ divg,
    const T* __restrict__ tg, const T* __restrict__ trg,
    const T* __restrict__ ug0, const T* __restrict__ vg0,
    const T* __restrict__ pxy,
    const T* __restrict__ rcos, const T* __restrict__ coriol,
    void* __restrict__ utend, void* __restrict__ vtend, void* __restrict__ ttend,
    void* __restrict__ trtend, void* __restrict__ psdt_g,
    void* __restrict__ flux_ut, void* __restrict__ flux_vt,
    void* __restrict__ flux_qu, void* __restrict__ flux_qv, void* __restrict__ ke,
    ColumnTables tab) {
  const long long col = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (col >= ncol) return;

  const long long plane = static_cast<long long>(il) * ix;  // level stride
  const long long b = col / plane;                           // member
  const long long r = col - b * plane;                       // lat*ix + lon
  const int j = static_cast<int>(r / ix);                    // latitude

  const long long off3 = b * KX * plane + r;        // (B, KX, il, ix) fields
  const long long off2 = b * 2 * plane + r;         // (B, 2, il, ix)
  const long long off1 = col;                       // (B, il, ix)
  const long long offq = b * ntr * KX * plane + r;  // (B, ntr*KX, il, ix)

  const T rc = rcos[j];
  const T cor = coriol[j];
  const T rgas = static_cast<T>(tab.rgas);
  const T akap = static_cast<T>(tab.akap);

  T dhs[KX], dhsr[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    dhs[k] = static_cast<T>(tab.dhs[k]);
    dhsr[k] = static_cast<T>(tab.dhsr[k]);
  }

  const T px = pxy[off2] * rc;
  const T py = pxy[off2 + plane] * rc;

  // Winds (rescaled) and divergence; vertical means.
  T u[KX], v[KX], d[KX];
  T umean = 0, vmean = 0, dmean = 0;
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    u[k] = ug0[off3 + k * plane] * rc;
    v[k] = vg0[off3 + k * plane] * rc;
    d[k] = divg[off3 + k * plane];
    umean += dhs[k] * u[k];
    vmean += dhs[k] * v[k];
    dmean += dhs[k] * d[k];
  }

  // Log-ps tendency, grid part.
  put<BF16, T>(psdt_g, off1, -umean * px - vmean * py);

  // Sigma-dot on half levels 0..KX. The recursion runs through k = KX, so
  // the bottom half level carries the accumulated sum: it is not zero.
  T puv[KX], sigdt[KX + 1], sigm[KX + 1];
  sigdt[0] = 0;
  sigm[0] = 0;
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    puv[k] = (u[k] - umean) * px + (v[k] - vmean) * py;
    sigdt[k + 1] = sigdt[k] - dhs[k] * (puv[k] + d[k] - dmean);
    sigm[k + 1] = sigm[k] - dhs[k] * puv[k];
  }

  // Temperature (and its anomaly from the reference profile).
  T t[KX], tgg[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    t[k] = tg[off3 + k * plane];
    tgg[k] = t[k] - static_cast<T>(tab.tref[k]);
  }

  // Vertical-advection fluxes on half levels: zero at the top (0) and at the
  // bottom (KX), sigdt[h] * (f[h] - f[h-1]) in between.
  T fu[KX + 1], fv[KX + 1], ft[KX + 1];
  fu[0] = fv[0] = ft[0] = 0;
  fu[KX] = fv[KX] = ft[KX] = 0;
#pragma unroll
  for (int h = 1; h < KX; ++h) {
    fu[h] = sigdt[h] * (u[h] - u[h - 1]);
    fv[h] = sigdt[h] * (v[h] - v[h - 1]);
    ft[h] = sigdt[h] * (tgg[h] - tgg[h - 1])
          + sigm[h] * static_cast<T>(tab.tref[h] - tab.tref[h - 1]);
  }

#pragma unroll
  for (int k = 0; k < KX; ++k) {
    const long long o = off3 + k * plane;
    const T vor = vorg[o] + cor;
    put<BF16, T>(utend, o, v[k] * vor - tgg[k] * rgas * px - (fu[k + 1] + fu[k]) * dhsr[k]);
    put<BF16, T>(vtend, o, -u[k] * vor - tgg[k] * rgas * py - (fv[k + 1] + fv[k]) * dhsr[k]);
    put<BF16, T>(ttend, o, tgg[k] * d[k] - (ft[k + 1] + ft[k]) * dhsr[k]
             + static_cast<T>(tab.fsgr[k]) * tgg[k] * (sigdt[k + 1] + sigdt[k])
             + static_cast<T>(tab.tref3[k]) * (sigm[k + 1] + sigm[k])
             + akap * (t[k] * puv[k] - tgg[k] * dmean));
    put<BF16, T>(flux_ut, o, -u[k] * tgg[k] * rc);
    put<BF16, T>(flux_vt, o, -v[k] * tgg[k] * rc);
    put<BF16, T>(ke, o, static_cast<T>(0.5) * (u[k] * u[k] + v[k] * v[k]));
  }

  // Tracers: the reference zeroes the vertical flux at half levels 1 and 2.
  for (int itr = 0; itr < ntr; ++itr) {
    const long long oq = offq + static_cast<long long>(itr) * KX * plane;
    T q[KX], fq[KX + 1];
#pragma unroll
    for (int k = 0; k < KX; ++k) q[k] = trg[oq + k * plane];
#pragma unroll
    for (int h = 0; h <= KX; ++h) fq[h] = 0;
#pragma unroll
    for (int h = 3; h < KX; ++h) fq[h] = sigdt[h] * (q[h] - q[h - 1]);
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const long long o = oq + k * plane;
      put<BF16, T>(trtend, o, q[k] * d[k] - (fq[k + 1] + fq[k]) * dhsr[k]);
      put<BF16, T>(flux_qu, o, -u[k] * q[k] * rc);
      put<BF16, T>(flux_qv, o, -v[k] * q[k] * rc);
    }
  }
}

template <typename T, int KX, bool BF16>
int launch(long long nmem, int ntr, int il, int ix, const void* const* in,
           void* const* out, const ColumnTables& tab, cudaStream_t stream) {
  const long long ncol = nmem * il * ix;
  if (ncol <= 0) return 0;
  const long long nblocks = (ncol + kThreads - 1) / kThreads;
  if (nblocks > 2147483647LL) return -3;
  grid_dynamics_kernel<T, KX, BF16><<<static_cast<unsigned>(nblocks), kThreads, 0, stream>>>(
      ncol, ntr, il, ix,
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(in[7]),
      static_cast<const T*>(in[8]),
      out[0], out[1], out[2], out[3], out[4], out[5], out[6], out[7], out[8],
      out[9], tab);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool BF16>
int launch_kx(int kx, long long nmem, int ntr, int il, int ix,
              const void* const* in, void* const* out,
              const ColumnTables& tab, cudaStream_t stream) {
  switch (kx) {
    case 5: return launch<T, 5, BF16>(nmem, ntr, il, ix, in, out, tab, stream);
    case 7: return launch<T, 7, BF16>(nmem, ntr, il, ix, in, out, tab, stream);
    case 8: return launch<T, 8, BF16>(nmem, ntr, il, ix, in, out, tab, stream);
    default: return -2;
  }
}

}  // namespace

// in:  vorg, divg, tg, trg_flat, ug, vg, pxy, rcos, coriol        (9 pointers)
// out: utend, vtend, ttend, trtend, psdt_g, flux_ut, flux_vt,
//      flux_qu, flux_qv, ke                                       (10 pointers)
// levels: 5*kx doubles on the host: dhs, dhsr, fsgr, tref, tref3.
// elem_size: 4 (float) or 8 (double), the type of the inputs. out_bf16: the
// ten outputs are bfloat16 buffers (float inputs only).
extern "C" int pyspeedy_grid_dynamics(
    int elem_size, int out_bf16, int kx, int ntr, long long nmem, int il, int ix,
    const void* const* in, void* const* out, const double* levels,
    double rgas, double akap, void* stream) {
  if (kx < 1 || kx > kMaxLevels) return -2;
  ColumnTables tab = {};
  for (int k = 0; k < kx; ++k) {
    tab.dhs[k] = levels[0 * kx + k];
    tab.dhsr[k] = levels[1 * kx + k];
    tab.fsgr[k] = levels[2 * kx + k];
    tab.tref[k] = levels[3 * kx + k];
    tab.tref3[k] = levels[4 * kx + k];
  }
  tab.rgas = rgas;
  tab.akap = akap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4 && out_bf16)
    return launch_kx<float, true>(kx, nmem, ntr, il, ix, in, out, tab, s);
  if (elem_size == 4)
    return launch_kx<float, false>(kx, nmem, ntr, il, ix, in, out, tab, s);
  if (elem_size == 8 && !out_bf16)
    return launch_kx<double, false>(kx, nmem, ntr, il, ix, in, out, tab, s);
  return -1;
}
