// The spectral side of one leapfrog step, for NVIDIA Hopper (sm_90a).
//
// Replaces: tools/exp_glue.py:39 member_tiled_kernel, the Pallas kernel that
//   runs pyspeedy_tpu/models/spectral_glue.py:33 spectral_update over tiles of
//   members (tools/exp_glue.py:144 glue_one). The plain PyTorch version of the
//   same function is
//   pyspeedy_tpu_torch/models/spectral_glue.py::spectral_update_plain.
//
// Computes, for every (member, pair part, m, n) point of the spectral state,
// everything between the direct transforms and the new prognostic state, in
// the order of the plain version:
//   - the flux combination (tendencies.f90:244-268): vel2vort of the wind pair
//     and divergence of the T and tracer flux pairs, the n-1 / n+1 neighbours
//     with zero inflow, the zonal derivative (a swap of the two pair parts
//     with a sign) dropped on the last n row; the T and tracer tendency adds;
//     divdt -= laplacian(ke);
//   - the linear tendencies (:283-352): the mean divergence, the log-ps
//     tendency with its (0,0) mode zeroed, the sequential sigma-dot sum over
//     levels (the bottom half level stays zero here), the vertical T
//     advection of the reference profile, divdt -= laplacian(phi + R tref ps);
//   - the semi-implicit correction (implicit.f90:234-289): ye = xd.tdt +
//     R tref psdt, yf = divdt + elz ye, divdt = xj(m,n).yf, psdt -= dhsx.divdt,
//     tdt += xc.divdt;
//   - horizontal diffusion (time_stepping.f90:78-122): del^8 on vor, div and
//     the orographically corrected T, the stratospheric drag on (level 0,
//     m = 0, every n) of vor and div, the del^2 stratospheric damping, the
//     tracers (humidity with its orographic correction on the divergence
//     coefficients, the others on the vorticity ones);
//   - the leapfrog with the Robert-Williams filter (:124-188) of ps, vor, div,
//     T and the tracers: the tendency truncated by trfilt when ix == 4*iy, the
//     second time level filtered with the already-filtered first one.
//
// Bound: bytes to and from device memory. At T30L8 with one tracer a launch
// reads 18 level stacks (9 flux spectra, vor, div, T at both time levels, phi,
// the tracer at both levels) and five (2, mx, nx) planes, and writes 8 level
// stacks and two planes: 218 MB at 128 members in float, 0.065 ms at
// 3.35 TB/s. The arithmetic is about 40 operations per level and value plus
// two 8x8 matrix-vector products per point for the implicit solve.
//
// Design: one thread per (member, pair part, m, n), n fastest, so that a warp
// reads a 32-wide n row of each level (coalesced; nx = 32 at T30). The two
// pair parts never meet except in the zonal derivative, which reads the other
// part of a flux spectrum from memory: a thread per part halves the registers
// a thread needs and doubles the threads in flight. The n+-1 neighbours of the
// flux spectra are read from global memory as well (the same warp reads them,
// so they come from L1). The kx levels of divdt, tdt, the mean-divergence
// terms and the implicit intermediates live in registers (KX is a template
// parameter, every level loop unrolled); vorticity and the tracers have no
// level coupling and are streamed level by level. The per-level tables and
// the 8x8 level matrices ride in the argument struct; the (mx, nx) tables
// and the implicit inverses come by pointer (L2-resident), the inverses laid
// out (kx, kx, mx, nx) so that a warp's 32 n points read 32 adjacent values
// (in the plain version's (mx, nx, kx, kx) layout they lie kx*kx apart).
// Every input is addressed through five element strides (member, part, level,
// m, n), so the stride-0 member axis of a freshly broadcast state and the
// views the other transform routes return are read in place: nothing is
// copied. Compiled with -fmad=false and written in the plain version's order
// of operations, so that the only differences from it are the sums of the
// level contractions (the plain version hands them to einsum).
//
// Interface: plain C, loaded with ctypes. The launch goes to the stream it is
// given, allocates nothing and does not synchronise; the function returns
// cudaGetLastError() (0 on success), or a negative code for arguments the
// kernel was not built for.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxTracers = 4;
constexpr int kMaxSpecs = 6 + 3 * kMaxTracers;
constexpr int kNumState = 14;
constexpr int kMaxInputs = kMaxSpecs + kNumState;
constexpr int kNumTables = 12;
constexpr int kThreads = 128;

// The state inputs, after the 6 + 3*ntr flux spectra.
enum StateInput {
  kPsdt, kVor0, kVor1, kDiv0, kDiv1, kT0, kT1, kPs0, kPs1, kTrf0, kTrf1,
  kPhi, kTcorh, kQcorh
};
// The (mx, nx) tables, then gradx (mx,).
enum Table {
  kEl2, kTrfilt, kDmp, kDmpd, kDmps, kDmp1, kDmp1d, kDmp1s, kElz, kVddym,
  kVddyp, kGradx
};

struct Field {
  const void* p;
  long long s[5];  // element strides: member, pair part, level, m, n
};

// Everything a launch reads besides the fields. The tables and scalars are
// held in the model's scalar type T (the caller's values are already rounded
// to it), so that the kernel reads them as operands from the constant bank.
template <typename T>
struct Args {
  Field in[kMaxInputs];
  const void* tab[kNumTables];
  const void* xj;  // (kx, kx, mx, nx) implicit inverses
  void* out[10];   // ps, vor, div, t, trf at the two time levels, dense
  T dhs[kMaxLevels], dhsr[kMaxLevels], tref[kMaxLevels],
      tref3[kMaxLevels];                                      // column tables
  T im_tref[kMaxLevels], tref2[kMaxLevels], dhsx[kMaxLevels];  // implicit
  T tcorv[kMaxLevels], qcorv[kMaxLevels];                     // diffusion
  T xd[kMaxLevels][kMaxLevels], xc[kMaxLevels][kMaxLevels];
  T dt, w1, w2, sdrag, rgas;  // w1 = wil*eps, w2 = (1-wil)*eps
  long long nmem;
  int j1, truncate, ntr, mx, nx;
};

template <typename T>
__device__ __forceinline__ T ld(const Field& f, long long b, int c, int k,
                                int m, int n) {
  return static_cast<const T*>(f.p)[b * f.s[0] + c * f.s[1] + k * f.s[2] +
                                    m * f.s[3] + n * f.s[4]];
}

template <typename T, int KX>
__global__ void __launch_bounds__(kThreads)
spectral_update_kernel(const __grid_constant__ Args<T> a) {
  const int mx = a.mx, nx = a.nx;
  const long long idx = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (idx >= a.nmem * 2 * mx * nx) return;
  const int n = static_cast<int>(idx % nx);
  const int m = static_cast<int>((idx / nx) % mx);
  const int c = static_cast<int>((idx / (static_cast<long long>(nx) * mx)) % 2);
  const long long b = idx / (2LL * mx * nx);
  const int mn = m * nx + n;
  const int ntr = a.ntr;
  const int base = 4 + 2 * ntr;           // ke, then ttend, then the tracers
  const Field* st = a.in + 6 + 3 * ntr;   // the state inputs

  auto tab = [&](int t) { return static_cast<const T*>(a.tab[t])[mn]; };
  const T el2 = tab(kEl2), elz = tab(kElz);
  const T ym = tab(kVddym), yp = tab(kVddyp);
  const T gx = static_cast<const T*>(a.tab[kGradx])[m];
  const T dt = a.dt, w1 = a.w1, w2 = a.w2, sdrag = a.sdrag, rgas = a.rgas;
  const bool drag = m == 0;   // the stratospheric drag acts on level 0, m = 0

  // Flux combination at level k of spectra iu (u-like) and iv (v-like).
  auto spec = [&](int i, int k, int part, int nn) {
    return ld<T>(a.in[i], b, part, k, m, nn);
  };
  auto dn = [&](int i, int k) { return n > 0 ? spec(i, k, c, n - 1) : T(0); };
  auto up = [&](int i, int k) { return n < nx - 1 ? spec(i, k, c, n + 1) : T(0); };
  auto zonal = [&](int i, int k) {   // (i * gradx) * spec, part c
    if (n == nx - 1) return T(0);
    const T x = spec(i, k, 1 - c, n);
    return c == 0 ? -(gx * x) : gx * x;
  };
  auto divm = [&](int iu, int iv, int k) {
    return (-(ym * dn(iv, k)) + yp * up(iv, k)) + zonal(iu, k);
  };
  auto vorm = [&](int iu, int iv, int k) {
    return (ym * dn(iu, k) - yp * up(iu, k)) + zonal(iv, k);
  };
  auto state = [&](int i, int k) { return ld<T>(st[i], b, c, k, m, n); };

  // Leapfrog + Robert-Williams filter; returns the two new time levels.
  const T trf = a.truncate ? tab(kTrfilt) : T(1);
  auto leapfrog = [&](T f0, T f1, T fdt, T& g1, T& g2) {
    if (a.truncate) fdt = fdt * trf;
    const T fj = a.j1 == 1 ? f0 : f1;
    const T fnew = f0 + dt * fdt;
    g1 = fj + w1 * ((f0 - T(2) * fj) + fnew);
    g2 = fnew - w2 * ((g1 - T(2) * fj) + fnew);
  };
  const long long plane = static_cast<long long>(mx) * nx;
  auto put3 = [&](int o, int nlev, int k, T v) {
    static_cast<T*>(a.out[o])[((b * 2 + c) * nlev + k) * plane + mn] = v;
  };

  // --- linear tendencies: mean divergence, log-ps, sigma-dot ---
  T div0[KX];
  T dmeanc = 0;
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    div0[k] = state(kDiv0, k);
    dmeanc = dmeanc + a.dhs[k] * div0[k];
  }
  T psdt = state(kPsdt, 0) - dmeanc;
  if (m == 0 && n == 0) psdt = 0;
  T sig[KX + 1];
  sig[0] = 0;
  sig[KX] = 0;
  T run = 0;
#pragma unroll
  for (int k = 0; k < KX - 1; ++k) {
    run = run + a.dhs[k] * (div0[k] - dmeanc);
    sig[k + 1] = -run;
  }
  T dumk[KX + 1];
  dumk[0] = 0;
  dumk[KX] = 0;
#pragma unroll
  for (int h = 1; h < KX; ++h)
    dumk[h] = sig[h] * (a.tref[h] - a.tref[h - 1]);

  const T ps0 = state(kPs0, 0);
  T tdt[KX], divdt[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    const T td = divm(2, 3, k) + spec(base + 1, k, c, n);
    tdt[k] = ((td - (dumk[k + 1] + dumk[k]) * a.dhsr[k]) +
              a.tref3[k] * (sig[k + 1] + sig[k])) -
             a.tref2[k] * dmeanc;
    T dd = divm(0, 1, k);
    dd = dd - (-spec(base, k, c, n)) * el2;
    const T ph = state(kPhi, k) + (rgas * a.tref[k]) * ps0;
    divdt[k] = dd - (-ph) * el2;
  }

  // --- semi-implicit correction ---
  T y[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    T s = 0;
#pragma unroll
    for (int l = 0; l < KX; ++l) s = s + a.xd[k][l] * tdt[l];
    y[k] = divdt[k] + elz * (s + (rgas * a.im_tref[k]) * psdt);
  }
  const T* xj = static_cast<const T*>(a.xj) + mn;
  T sdiv = 0;
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    T s = 0;
#pragma unroll
    for (int l = 0; l < KX; ++l) s = s + xj[(k * KX + l) * plane] * y[l];
    divdt[k] = s;
    sdiv = sdiv + a.dhsx[k] * s;
  }
  psdt = psdt - sdiv;
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    T s = 0;
#pragma unroll
    for (int l = 0; l < KX; ++l) s = s + a.xc[k][l] * divdt[l];
    tdt[k] = tdt[k] + s;
  }

  // --- diffusion and leapfrog of ps, div, T ---
  T g1, g2;
  leapfrog(ps0, state(kPs1, 0), psdt, g1, g2);
  {
    const long long o = (b * 2 + c) * plane + mn;
    static_cast<T*>(a.out[0])[o] = g1;
    static_cast<T*>(a.out[1])[o] = g2;
  }
  const T dmp = tab(kDmp), dmpd = tab(kDmpd), dmps = tab(kDmps);
  const T dmp1 = tab(kDmp1), dmp1d = tab(kDmp1d), dmp1s = tab(kDmp1s);
  const T tcorh = state(kTcorh, 0);
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    T dd = (divdt[k] - dmpd * div0[k]) * dmp1d;
    if (k == 0 && drag) dd = dd - sdrag * div0[0];
    dd = (dd - dmps * div0[k]) * dmp1s;
    leapfrog(div0[k], state(kDiv1, k), dd, g1, g2);
    put3(4, KX, k, g1);
    put3(5, KX, k, g2);

    const T t0 = state(kT0, k);
    const T tcor = t0 + tcorh * a.tcorv[k];
    T td = (tdt[k] - dmp * tcor) * dmp1;
    td = (td - dmps * tcor) * dmp1s;
    leapfrog(t0, state(kT1, k), td, g1, g2);
    put3(6, KX, k, g1);
    put3(7, KX, k, g2);
  }

  // --- vorticity, level by level ---
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    const T v0 = state(kVor0, k);
    T vd = vorm(0, 1, k);
    vd = (vd - dmp * v0) * dmp1;
    if (k == 0 && drag) vd = vd - sdrag * v0;
    vd = (vd - dmps * v0) * dmp1s;
    leapfrog(v0, state(kVor1, k), vd, g1, g2);
    put3(2, KX, k, g1);
    put3(3, KX, k, g2);
  }

  // --- tracers, level by level: humidity with its orographic correction ---
  const T qcorh = state(kQcorh, 0);
  for (int itr = 0; itr < ntr; ++itr) {
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int lev = itr * KX + k;
      T trd = divm(4 + 2 * itr, 5 + 2 * itr, k) + spec(base + 2 + itr, k, c, n);
      const T f0 = state(kTrf0, lev);
      if (itr == 0) {
        const T q = f0 + qcorh * a.qcorv[k];
        trd = (trd - dmpd * q) * dmp1d;
      } else {
        trd = (trd - dmp * f0) * dmp1;
      }
      leapfrog(f0, state(kTrf1, lev), trd, g1, g2);
      put3(8, ntr * KX, lev, g1);
      put3(9, ntr * KX, lev, g2);
    }
  }
}

template <typename T, int KX>
int launch(const Args<T>& a, cudaStream_t stream) {
  const long long npoints = a.nmem * 2 * a.mx * a.nx;
  if (npoints <= 0) return 0;
  const long long nblocks = (npoints + kThreads - 1) / kThreads;
  if (nblocks > 2147483647LL) return -4;
  spectral_update_kernel<T, KX><<<static_cast<unsigned>(nblocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_kx(int kx, const Args<T>& a, cudaStream_t stream) {
  switch (kx) {
    case 5: return launch<T, 5>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    case 8: return launch<T, 8>(a, stream);
    default: return -2;
  }
}

}  // namespace

// in:      6 + 3*ntr flux spectra (B, 2, kx, mx, nx), then psdt, vor0, vor1,
//          div0, div1, t0, t1, ps0, ps1, trf0, trf1 (tracers flat: ntr*kx
//          levels), phi, tcorh, qcorh; each with five element strides in
//          `strides` (member, part, level, m, n; level 0 for the planes).
// tables:  el2, trfilt, dmp, dmpd, dmps, dmp1, dmp1d, dmp1s, elz, vddym,
//          vddyp (mx, nx); gradx (mx,); xj (kx, kx, mx, nx). Contiguous.
// out:     ps0, ps1 (B, 2, mx, nx), vor0, vor1, div0, div1, t0, t1
//          (B, 2, kx, mx, nx), trf0, trf1 (B, 2, ntr*kx, mx, nx). Dense.
// levels:  9*kx + 2*kx*kx doubles on the host: dhs, dhsr, tref, tref3 (the
//          column tables), tref, tref2, dhsx (the implicit tables of this dt),
//          tcorv, qcorv, then xd and xc row by row.
// elem_size: 4 (float) or 8 (double).
extern "C" int pyspeedy_spectral_update(
    int elem_size, int kx, int ntr, long long nmem, int mx, int nx,
    const void* const* in, const long long* strides, const void* const* tables,
    void* const* out, const double* levels, int j1, int truncate, double dt,
    double w1, double w2, double sdrag, double rgas, void* stream) {
  if (kx < 1 || kx > kMaxLevels) return -2;
  if (ntr < 1 || ntr > kMaxTracers) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto a) {
    using T = decltype(a.dt);
    const int nin = 6 + 3 * ntr + kNumState;
    for (int i = 0; i < nin; ++i) {
      a.in[i].p = in[i];
      for (int d = 0; d < 5; ++d) a.in[i].s[d] = strides[5 * i + d];
    }
    for (int t = 0; t < kNumTables; ++t) a.tab[t] = tables[t];
    a.xj = tables[kNumTables];
    for (int o = 0; o < 10; ++o) a.out[o] = out[o];
    const double* lv = levels;
    for (int k = 0; k < kx; ++k) {
      a.dhs[k] = static_cast<T>(lv[0 * kx + k]);
      a.dhsr[k] = static_cast<T>(lv[1 * kx + k]);
      a.tref[k] = static_cast<T>(lv[2 * kx + k]);
      a.tref3[k] = static_cast<T>(lv[3 * kx + k]);
      a.im_tref[k] = static_cast<T>(lv[4 * kx + k]);
      a.tref2[k] = static_cast<T>(lv[5 * kx + k]);
      a.dhsx[k] = static_cast<T>(lv[6 * kx + k]);
      a.tcorv[k] = static_cast<T>(lv[7 * kx + k]);
      a.qcorv[k] = static_cast<T>(lv[8 * kx + k]);
      for (int l = 0; l < kx; ++l) {
        a.xd[k][l] = static_cast<T>(lv[9 * kx + k * kx + l]);
        a.xc[k][l] = static_cast<T>(lv[9 * kx + kx * kx + k * kx + l]);
      }
    }
    a.dt = static_cast<T>(dt);
    a.w1 = static_cast<T>(w1);
    a.w2 = static_cast<T>(w2);
    a.sdrag = static_cast<T>(sdrag);
    a.rgas = static_cast<T>(rgas);
    a.nmem = nmem;
    a.j1 = j1;
    a.truncate = truncate;
    a.ntr = ntr;
    a.mx = mx;
    a.nx = nx;
    return launch_kx<T>(kx, a, s);
  };
  if (elem_size == 4) return run(Args<float>{});
  if (elem_size == 8) return run(Args<double>{});
  return -1;
}
