// Column physics of one model step, for NVIDIA Hopper (sm_90a).
//
// Replaces: pyspeedy_tpu/physics/pallas_physics.py::grid_physics_pallas (the
//   latitude-tiled Pallas kernel of the JAX package, launched through
//   pyspeedy_tpu/ops/pallas_tiling.py::tiled_columnwise), whose body is
//   pyspeedy_tpu/physics/driver.py::grid_physics. The plain PyTorch version
//   of the same function is pyspeedy_tpu_torch/physics/driver.py::grid_physics.
//
// Computes, for every (member, latitude, longitude) column: exp(ps), q >= 0,
// dry static energy, saturation humidity; deep convection; large-scale
// condensation; on a shortwave step clouds, the two-band shortwave sweeps,
// the longwave transmissivities and the stratospheric correction (written
// out as the radiation cache), on other steps those read back; longwave
// down; surface fluxes (with a second, sea-only evaluation when the sea
// model is coupled); longwave up; vertical diffusion and shallow convection;
// the surface-flux tendencies of the lowest layer; optionally the
// hydrostatic geopotential from T (instead of reading it) and the SPPT
// multiply. Outputs: 4 tendencies, 14 diagnostics, 7 cache fields.
//
// Bound: bytes to and from device memory. A column of a shortwave step reads
// 3*kx + 3 values (T, q, phi, the lowest level of u and v, ps) plus up to 16
// boundary values and writes 11*kx + 34 (122 at kx = 8: 4*kx tendencies,
// 2*kx + 28 diagnostics, 5*kx + 6 cache; the four band transmissivities and
// the two emission arrays are the bulk); a step without shortwave reads
// 5*kx + 3 of the cache instead of writing it. At 128 T30L8 members that is
// about 350 MB in float, 0.10 ms at 3.35 TB/s. The arithmetic, about 2,500
// operations per column with 30-odd exponentials on a shortwave step, stays
// under the byte time. Measured on an H100: 45-47 % of the bound in float,
// 20 % (shortwave) and 43 % in double, where the kernel spills.
//
// Design.
// * One thread per column, longitude fastest, as in grid_dynamics.cu: a warp
//   reads 32 neighbouring longitudes of a level plane. KX is a template
//   parameter and every level loop is unrolled, so the level arrays live in
//   registers. What the TPU kernel does with level-parallel masks, one-hot
//   selections and shift-add prefix sums is here the sequential column loop
//   that those stand for; data-dependent level indices (cloud top, convection
//   top) are predicates inside unrolled loops, never array subscripts, so no
//   array goes to local memory for that reason. Level indices are ints with
//   the reference's 1-based meaning (kx+1: none).
// * Registers: only T, q, phi and qsat are held for all levels; dry static
//   energy and relative humidity are recomputed where used. The band
//   transmissivities (4*kx), the shortwave heating and the emission arrays
//   (2*kx) are written to device memory when they are made (they are outputs)
//   and read back level by level in the longwave sweeps (a thread reads its
//   own writes; those pointers are neither const nor restrict).
// * Boundary fields come with a member, a latitude and a longitude stride
//   each (0 where the field is broadcast), so shared (il, ix), zonal (il, 1)
//   and per-member (B, il, ix) fields are read in place. cos(lat) enters as
//   an (il,) vector of sqrt(cos). Per-level tables ride in the argument
//   struct, rounded to the model's scalar type on the host. The CO2
//   absorptivity is read through a pointer with a member stride.
// * The source is compiled with -fmad=false: the plain version runs as
//   separate elementwise passes that cannot contract a*b+c, and the scheme's
//   thresholds (convection and cloud tops, stability switches, nint(T)) turn
//   a last-bit difference into a different branch.
//
// Interface: plain C, loaded with ctypes. The launch goes to the stream it is
// given, allocates nothing and does not synchronise; the function returns
// cudaGetLastError() (0 on success), or a negative code for arguments the
// kernel was not built for.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 128;
constexpr int kNumBc = 16;

// Order of the boundary fields (physics/driver.py::BC_FIELDS).
enum Bc {
  FMASK, PHIS0, FOROG, SST_AM, ALB_LAND, ALB_SEA, ALB_SFC, SNOWC, LAND_TEMP,
  SOILW, ZENIT, FSOL, OZUPP, OZONE, STRATZ, SSTI_OM
};

// Per-level tables and derived scalars, as doubles already rounded to the
// model's scalar type by the caller.
struct PhysTables {
  double fsg[kMaxLevels];
  double dhs[kMaxLevels];
  double grdsig[kMaxLevels];
  double grdscp[kMaxLevels];
  double wvi1[kMaxLevels];     // wvi[:, 1]
  double entr[kMaxLevels];     // entrainment profile
  double rhref[kMaxLevels];    // large-scale condensation RH threshold
  double dqmax[kMaxLevels];    // cap of the heating humidity tendency
  double wcol[kMaxLevels];     // dhs * p0 / g
  double abs1[kMaxLevels];     // absdry + absaer * fsg^2
  double rsig[kMaxLevels];     // 1 / dhs
  double rsig1[kMaxLevels];    // 1 / (1 - sigh[k+1])
  double drh0k[kMaxLevels];    // rhgrad * (fsg[k+1] - fsg[k])
  double fvdiq2k[kMaxLevels];  // fvdiq * sigh[k+1]
  double gate[kMaxLevels];     // 1 where moisture diffusion acts
  double xgeop1[kMaxLevels];
  double xgeop2[kMaxLevels];
  double fm0, sigl_b_den, fshcq, fshcse, fvdise, drh0, fvdiq2, eps1_strat;
};

struct PhysArgs {
  // inputs
  const void* ug; const void* vg; const void* tg; const void* qg;
  const void* phig;      // (B, kx, il, ix) or null
  const void* pslg;      // (B, il, ix)
  const void* phisg;     // (il, ix), with phig null
  const void* m0corr;    // (B, kx, il), with phig null
  const void* sppt;      // (B, kx, il, ix) or null
  const void* sqrtcoa;   // (il,)
  const void* ablco2; long long ablco2_stride;
  const void* bc[kNumBc];
  long long bc_sm[kNumBc]; long long bc_sl[kNumBc]; long long bc_sx[kNumBc];
  // cache: written on a shortwave step, read on the others
  void* tt_rsw; void* rad_tau2; void* rad_sc; void* tsr; void* ssrd;
  void* ssr; void* qcloud;
  // outputs
  void* utend; void* vtend; void* ttend; void* qtend;
  void* cbmf; void* precnv; void* precls; void* slrd; void* slr; void* olr;
  void* ustr; void* vstr; void* shf; void* evap; void* slru; void* hfluxn;
  void* rad_flux; void* rad_st4a;
  int sea_coupled;
};

template <typename T> __device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T> __device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
__device__ __forceinline__ float texp(float x) { return expf(x); }
__device__ __forceinline__ double texp(double x) { return exp(x); }
__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double tsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float tfloor(float x) { return floorf(x); }
__device__ __forceinline__ double tfloor(double x) { return floor(x); }

// Saturation specific humidity [g/kg] at pressure p (humidity.f90:44-78).
template <typename T>
__device__ __forceinline__ T qsat_at(T ta, T p) {
  const T t0 = static_cast<T>(273.16), e0 = static_cast<T>(6.108e-3);
  T e;
  if (ta >= t0)
    e = e0 * texp(static_cast<T>(17.269) * (ta - t0) / (ta - static_cast<T>(35.86)));
  else
    e = e0 * texp(static_cast<T>(21.875) * (ta - t0) / (ta - static_cast<T>(7.66)));
  return static_cast<T>(622.0) * e / (p - static_cast<T>(0.378) * e);
}

// Longwave band fractions at nint(T), clipped to 200..320 K
// (longwave_radiation.f90:208-232, in closed form).
template <typename T>
__device__ __forceinline__ void band_fractions(T ta, T fb[4]) {
  const T eps1 = static_cast<T>(1.0 - 0.05);
  T t = tfloor(ta + static_cast<T>(0.5));
  t = tmin(tmax(t, static_cast<T>(200.0)), static_cast<T>(320.0));
  const T d1 = t - static_cast<T>(247.0);
  const T d2 = t - static_cast<T>(282.0);
  const T d3 = t - static_cast<T>(315.0);
  fb[1] = (static_cast<T>(0.148) - static_cast<T>(3.0e-6) * (d1 * d1)) * eps1;
  fb[2] = (static_cast<T>(0.356) - static_cast<T>(5.2e-6) * (d2 * d2)) * eps1;
  fb[3] = (static_cast<T>(0.314) + static_cast<T>(1.0e-5) * (d3 * d3)) * eps1;
  fb[0] = eps1 - ((fb[1] + fb[2]) + fb[3]);
}

// Asymmetric stability correction (surface_fluxes.f90:169-184).
template <typename T>
__device__ __forceinline__ T stability_factor(T tsurf, T t2) {
  const T dtheta = static_cast<T>(3.0);
  const T d = tsurf - t2;
  const T dth = (tsurf > t2) ? tmin(d, dtheta) : tmax(static_cast<T>(0.5) * d, -dtheta);
  return static_cast<T>(1.0) + dth * static_cast<T>(0.67 / 3.0);
}

template <typename T, int KX, bool SW>
__global__ void __launch_bounds__(kThreads)
grid_physics_kernel(long long ncol, int il, int ix, PhysArgs a, PhysTables tab) {
  const long long col = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (col >= ncol) return;

#define C(x) static_cast<T>(x)
  const long long plane = static_cast<long long>(il) * ix;
  const long long b = col / plane;
  const long long r = col - b * plane;
  const int j = static_cast<int>(r / ix);
  const int i = static_cast<int>(r - static_cast<long long>(j) * ix);
  const long long off3 = b * KX * plane + r;   // (B, KX, il, ix)
  const long long off1 = col;                  // (B, il, ix)

  auto bcv = [&](int f) -> T {
    return static_cast<const T*>(a.bc[f])[b * a.bc_sm[f] + j * a.bc_sl[f] + i * a.bc_sx[f]];
  };
  auto out1 = [&](void* p, T v) { static_cast<T*>(p)[off1] = v; };
  auto out3 = [&](void* p, T land, T sea, T avg) {
    T* q3 = static_cast<T*>(p) + b * 3 * plane + r;
    q3[0] = land; q3[plane] = sea; q3[2 * plane] = avg;
  };

  const T cp = C(1004.0), alhc = C(2501.0);
  constexpr int NL1 = KX - 1;   // 1-based index of the level above the lowest
  constexpr int KB = KX - 1;    // 0-based lowest level
  constexpr int KA = KX - 2;    // 0-based level above it

  // ------------------------------------------------------------------
  // Thermodynamics (physics.f90:107-116)
  // ------------------------------------------------------------------
  const T psa = texp(static_cast<const T*>(a.pslg)[off1]);
  const T rps = C(1.0) / psa;
  T t[KX], q[KX], phi[KX], qsat[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    t[k] = static_cast<const T*>(a.tg)[off3 + k * plane];
    q[k] = tmax(static_cast<const T*>(a.qg)[off3 + k * plane], C(0.0));
  }
  if (a.phig != nullptr) {
#pragma unroll
    for (int k = 0; k < KX; ++k) phi[k] = static_cast<const T*>(a.phig)[off3 + k * plane];
  } else {
    // Hydrostatic integration from the surface (geopotential.f90:49-77) plus
    // the zonally uniform m=0 lapse-rate correction.
    const T* m0 = static_cast<const T*>(a.m0corr) + b * KX * il + j;
    phi[KB] = static_cast<const T*>(a.phisg)[r] + C(tab.xgeop1[KB]) * t[KB];
#pragma unroll
    for (int k = KX - 2; k >= 0; --k)
      phi[k] = (phi[k + 1] + C(tab.xgeop2[k + 1]) * t[k + 1]) + C(tab.xgeop1[k]) * t[k];
#pragma unroll
    for (int k = 0; k < KX; ++k) phi[k] = phi[k] + m0[k * il];
  }
#pragma unroll
  for (int k = 0; k < KX; ++k) qsat[k] = qsat_at<T>(t[k], C(tab.fsg[k]) * psa);
#define SE(k) (cp * t[k] + phi[k])
#define RH(k) (q[k] / qsat[k])

  // ------------------------------------------------------------------
  // Deep convection (convection.f90:27-253)
  // ------------------------------------------------------------------
  int itop = KX + 1;
  T qdif = C(0.0);
  {
    const T mse0 = SE(KB) + alhc * q[KB];
    const T mse1 = tmin(mse0, SE(KA) + alhc * q[KA]);
    const T mss0 = tmax(mse0, SE(KB) + alhc * qsat[KB]);
    int ktop1 = KX, ktop2 = KX;
    T msthr = C(0.0);
    // 1-based levels 3 .. kx-3, descending, so the smallest hit wins.
#pragma unroll
    for (int k1 = KX - 3; k1 >= 3; --k1) {
      const int k = k1 - 1;
      const T mss_k = SE(k) + alhc * qsat[k];
      const T mss_k1 = SE(k + 1) + alhc * qsat[k + 1];
      const T mss2 = mss_k + C(tab.wvi1[k]) * (mss_k1 - mss_k);
      if (mss0 > mss2) ktop1 = k1;
      if (mse1 > mss2) { ktop2 = k1; msthr = mss2; }
    }
    const T qthr0 = C(0.9) * qsat[KB];
    const T qthr1 = C(0.9) * qsat[KA];
    const bool lqthr = (q[KB] > qthr0) && (q[KA] > qthr1);
    const bool candidate = (psa > C(0.8)) && (ktop1 < KX);
    const bool deep = candidate && (ktop2 < KX);
    const bool shallow = candidate && (ktop2 >= KX) && lqthr;
    if (deep) {
      itop = ktop1;
      qdif = tmax(q[KB] - qthr0, (mse0 - msthr) * C(1.0 / 2501.0));
    } else if (shallow) {
      itop = ktop1;
      qdif = q[KB] - qthr0;
    }
  }

  T ttend[KX], qtend[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) { ttend[k] = C(0.0); qtend[k] = C(0.0); }
  T cbmf = C(0.0), precnv = C(0.0);
  if (itop <= KX) {
    const T qmax = tmax(C(1.01) * q[KB], qsat[KB]);
    const T se_b = SE(KB), se_a = SE(KA);
    const T sb_b = se_a + C(tab.wvi1[KA]) * (se_b - se_a);
    const T qb_b = tmin(q[KA] + C(tab.wvi1[KA]) * (q[KB] - q[KA]), q[KB]);
    const T fpsa = psa * tmin((psa - C(0.8)) * C(2.0 / (1.0 - 0.8)), C(1.0));
    cbmf = C(tab.fm0) * fpsa * tmin(qdif / (qmax - qb_b), C(5.0));
    T fmass = cbmf;
    T fus = cbmf * se_b, fuq = cbmf * qmax;
    T fds = cbmf * sb_b, fdq = cbmf * qb_b;
    T dfse[KX], dfqa[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) { dfse[k] = C(0.0); dfqa[k] = C(0.0); }
    dfse[KB] = fds - fus;
    T sec_total = C(0.0);
    const T bot_q = fdq - fuq;
    // Intermediate layers, 1-based k1 = kx-1 .. itop+1.
#pragma unroll
    for (int k1 = KX - 1; k1 >= 3; --k1) {
      const int k = k1 - 1;
      if (k1 > itop) {
        const T se_k = SE(k), se_km = SE(k - 1);
        const T enmass = C(tab.entr[k]) * psa * cbmf;
        const T fmass_n = fmass + enmass;
        const T fus_n = fus + enmass * se_k;
        const T fuq_n = fuq + enmass * q[k];
        const T sb = se_km + C(tab.wvi1[k - 1]) * (se_k - se_km);
        const T qb = q[k - 1] + C(tab.wvi1[k - 1]) * (q[k] - q[k - 1]);
        const T fds_n = fmass_n * sb;
        const T fdq_n = fmass_n * qb;
        dfse[k] = (fus - fds) + (fds_n - fus_n);
        dfqa[k] = (fuq - fdq) + (fdq_n - fuq_n);
        const T delq = C(0.7) * qsat[k] - q[k];
        if (delq > C(0.0)) {
          const T fsq = C(0.8) * cbmf * delq;
          dfqa[k] = dfqa[k] + fsq;
          sec_total = sec_total + fsq;
        }
        fmass = fmass_n; fus = fus_n; fuq = fuq_n; fds = fds_n; fdq = fdq_n;
      }
    }
    // Top layer: condensation and detrainment.
#pragma unroll
    for (int k1 = KX - 1; k1 >= 3; --k1) {
      const int k = k1 - 1;
      if (k1 == itop) {
        const T qsatb = qsat[k] + C(tab.wvi1[k]) * (qsat[k + 1] - qsat[k]);
        const T pr = tmax(fuq - fmass * qsatb, C(0.0));
        precnv = pr;
        dfse[k] = (fus - fds) + alhc * pr;
        dfqa[k] = (fuq - fdq) - pr;
      }
    }
    dfqa[KB] = bot_q - sec_total;
    // Flux -> tendency (physics.f90:127-130): levels 2..kx.
#pragma unroll
    for (int k = 1; k < KX; ++k) {
      ttend[k] = dfse[k] * (rps * C(tab.grdscp[k]));
      qtend[k] = dfqa[k] * (rps * C(tab.grdsig[k]));
    }
  }
  const int icnv = KX - itop;
  out1(a.cbmf, cbmf);
  out1(a.precnv, precnv);

  // ------------------------------------------------------------------
  // Large-scale condensation (large_scale_condensation.f90:33-96)
  // ------------------------------------------------------------------
  int iptop = itop;
  T precls;
  {
    const T psa2 = psa * psa;
    const T rtlsc = C(1.0 / (4.0 * 3600.0));
    T acc = C(0.0);
#pragma unroll
    for (int k = 1; k < KX; ++k) {
      const T dqa = C(tab.rhref[k]) * qsat[k] - q[k];
      T dq = C(0.0), dt = C(0.0);
      if (dqa < C(0.0)) {
        iptop = min(iptop, k + 1);
        dq = dqa * rtlsc;
        dt = C(2501.0 / 1004.0) * tmin(-dq, C(tab.dqmax[k]) * psa2);
      }
      acc = acc + C(tab.wcol[k]) * dq;
      ttend[k] = ttend[k] + dt;
      qtend[k] = qtend[k] + dq;
    }
    precls = -acc * psa;
  }
  out1(a.precls, precls);

  // ------------------------------------------------------------------
  // Shortwave and the radiation cache (shortwave_radiation.f90:50-404)
  // ------------------------------------------------------------------
  T* tt_rsw = static_cast<T*>(a.tt_rsw) + off3;
  T* tau2 = static_cast<T*>(a.rad_tau2) + b * 4 * KX * plane + r;   // (B, 4, KX, il, ix)
  T* rad_sc = static_cast<T*>(a.rad_sc) + b * 2 * plane + r;
  T ssrd, sc0, sc1;
  if (SW) {
    // Clouds.
    const T gse = (SE(KA) - SE(KB)) / (phi[KA] - phi[KB]);
    const T rh_a = RH(KA);
    const bool base = rh_a > C(0.30);
    T cloudc = base ? rh_a - C(0.30) : C(0.0);
    int icltop = base ? NL1 : KX + 1;
#pragma unroll
    for (int k1 = 3; k1 <= KX - 2; ++k1) {
      const T drh = RH(k1 - 1) - C(0.30);
      if ((drh > cloudc) && (q[k1 - 1] > C(0.20))) { cloudc = drh; icltop = k1; }
    }
    const T pr1 = tmin(C(86.4) * (precnv + precls), C(10.0));
    const T cl1 = tmin(cloudc * C(1.0 / (1.00 - 0.30)), C(1.0));
    cloudc = tmin(C(0.2) * tsqrt(pr1) + cl1 * cl1, C(1.0));
    icltop = min(iptop, icltop);
    const T qcloud = q[KA];
    const T fstab = tmin(tmax(C(1.0 / (0.40 - 0.25)) * (gse - C(0.25)), C(0.0)), C(1.0));
    T clstr = fstab * tmax(C(0.60) - C(1.2) * cloudc, C(0.0));
    const T clstrl = tmax(clstr, C(0.15)) * RH(KB);
    clstr = clstr + bcv(FMASK) * (clstrl - clstr);

    // Transmissivities of the visible band and cloud reflection slots.
    T tau1[KX], tau3[KX], tt[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) tau3[k] = C(0.0);
#pragma unroll
    for (int k1 = 3; k1 <= KX; ++k1)
      if (icltop == k1) tau3[k1 - 1] = C(0.43) * cloudc;
    tau3[KB] = C(0.50) * clstr;   // overwrites a cloud top at kx

    const T psaz = psa * bcv(ZENIT);
    const T acloud = cloudc * tmin(C(0.015) * qcloud, C(0.15));
    tau1[0] = texp(-psaz * C(tab.dhs[0]) * C(0.033));
#pragma unroll
    for (int k1 = 2; k1 <= KX - 1; ++k1) {
      const int k = k1 - 1;
      const T deltap = psaz * C(tab.dhs[k]);
      const T clear = C(tab.abs1[k]) + C(0.022) * q[k];
      tau1[k] = texp(-deltap * ((k1 >= icltop) ? clear + acloud : clear));
    }
    tau1[KB] = texp(-psaz * C(tab.dhs[KB]) * (C(tab.abs1[KB]) + C(0.022) * q[KB]));

    // Downward sweeps.
    const T fsol = bcv(FSOL);
    T flux1 = fsol * C(1.0 - 0.05);
    T flux2 = fsol * C(0.05);
    tt[0] = flux1;
    flux1 = tau1[0] * (flux1 - bcv(OZUPP) * psa);
    tt[0] = tt[0] - flux1;
    tt[1] = flux1;
    flux1 = tau1[1] * (flux1 - bcv(OZONE) * psa);
    tt[1] = tt[1] - flux1;
#pragma unroll
    for (int k = 2; k < KX; ++k) {
      tau3[k] = flux1 * tau3[k];
      flux1 = flux1 - tau3[k];
      tt[k] = flux1;
      flux1 = tau1[k] * flux1;
      tt[k] = tt[k] - flux1;
    }
#pragma unroll
    for (int k = 1; k < KX; ++k) {
      const T tau2b = texp(-psaz * C(tab.dhs[k]) * C(15.0) * q[k]);
      tt[k] = tt[k] + flux2;
      flux2 = tau2b * flux2;
      tt[k] = tt[k] - flux2;
    }
    // Surface and upward sweep.
    ssrd = flux1 + flux2;
    flux1 = flux1 * bcv(ALB_SFC);
    const T ssr = ssrd - flux1;
#pragma unroll
    for (int k = KX - 1; k >= 0; --k) {
      tt[k] = tt[k] + flux1;
      flux1 = tau1[k] * flux1;
      tt[k] = tt[k] - flux1;
      flux1 = flux1 + tau3[k];
    }
    const T tsr = fsol - flux1;
#pragma unroll
    for (int k = 0; k < KX; ++k) tt_rsw[k * plane] = tt[k] * (rps * C(tab.grdscp[k]));

    // Longwave transmissivities, four bands (shortwave_radiation.f90:170-205).
    const T ablco2 = static_cast<const T*>(a.ablco2)[b * a.ablco2_stride];
    const T acl_lw = cloudc * C(0.6);
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int k1 = k + 1;
      T l1, l2, l3, l4;
      if (k1 >= 3 && k1 <= KX - 1) {
        const T nd = -(psa * C(tab.dhs[k]));
        const T acloud1 = (k1 < icltop) ? acl_lw : C(12.0) * cloudc;
        l1 = texp(nd * (C(0.3) + acloud1));
        l2 = texp(nd * ablco2);
        l3 = texp(nd * tmax(C(0.7) * q[k], acl_lw));
        l4 = texp(nd * tmax(C(50.0) * q[k], acl_lw));
      } else {
        const T nd = -psa * C(tab.dhs[k]);
        l1 = texp(nd * C(0.3));
        l2 = texp(nd * ablco2);
        if (k == 0) {
          l3 = C(1.0); l4 = C(1.0);
        } else {
          l3 = texp(nd * C(0.7) * q[k]);
          l4 = texp(nd * C(50.0) * q[k]);
        }
      }
      tau2[(0 * KX + k) * plane] = l1;
      tau2[(1 * KX + k) * plane] = l2;
      tau2[(2 * KX + k) * plane] = l3;
      tau2[(3 * KX + k) * plane] = l4;
    }
    sc0 = bcv(STRATZ) * psa;
    sc1 = C(tab.eps1_strat) * psa;
    rad_sc[0] = sc0;
    rad_sc[plane] = sc1;
    out1(a.tsr, tsr);
    out1(a.ssrd, ssrd);
    out1(a.ssr, ssr);
    out1(a.qcloud, qcloud);
  } else {
    ssrd = static_cast<const T*>(a.ssrd)[off1];
    sc0 = rad_sc[0];
    sc1 = rad_sc[plane];
  }

  // ------------------------------------------------------------------
  // Longwave, downward (longwave_radiation.f90:16-121)
  // ------------------------------------------------------------------
  T* st4a = static_cast<T*>(a.rad_st4a) + b * 2 * KX * plane + r;   // (B, 2, KX, il, ix)
  T dfabs[KX];
  T flux[4];
  T slrd;
  T st1_0, st1_1;   // emission of the two stratospheric layers, kept for the up sweep
  {
    const T sbc = C(5.67e-8);
    T st1[KX], st2[KX];
    {
      T tb[KX];
#pragma unroll
      for (int k = 0; k < KX - 1; ++k) tb[k] = t[k] + C(tab.wvi1[k]) * (t[k + 1] - t[k]);
      st2[0] = C(0.75) * t[0] + C(0.25) * tb[0];
      st2[1] = C(0.50) * t[1] + C(0.25) * (tb[0] + tb[1]);
#pragma unroll
      for (int k = 2; k < KX - 1; ++k) st2[k] = C(0.5) * tmax(tb[k] - tb[k - 1], C(0.0));
      st2[KB] = tmax(t[KB] - tb[KX - 2], C(0.0));
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const T sq = st2[k] * st2[k];
      st1[k] = sbc * (sq * sq);
      st2[k] = C(0.0);
    }
#pragma unroll
    for (int k = 2; k < KX; ++k) {
      const T st3a = sbc * (t[k] * t[k] * t[k]);
      st1[k] = st3a * t[k];
      st2[k] = C(4.0) * st3a * st2[k];
    }
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      st4a[k * plane] = st1[k];
      st4a[(KX + k) * plane] = st2[k];
    }
    st1_0 = st1[0];
    st1_1 = st1[1];

    T fb[4];
    // Stratosphere: bands 1-2 only.
    band_fractions<T>(t[0], fb);
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      if (jb < 2) {
        const T emis = C(1.0) - tau2[(jb * KX) * plane];
        flux[jb] = emis * (fb[jb] * (st1[0] + emis * st2[0]));
      } else {
        flux[jb] = C(0.0);
      }
    }
    dfabs[0] = -(((flux[0] + flux[1]) + flux[2]) + flux[3]);
    // Troposphere.
#pragma unroll
    for (int k = 1; k < KX; ++k) {
      band_fractions<T>(t[k], fb);
      T d[4];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        const T tau = tau2[(jb * KX + k) * plane];
        const T emis = C(1.0) - tau;
        const T brad = fb[jb] * (st1[k] + emis * st2[k]);
        const T nf = tau * flux[jb] + emis * brad;
        d[jb] = flux[jb] - nf;
        flux[jb] = nf;
      }
      dfabs[k] = ((d[0] + d[1]) + d[2]) + d[3];
    }
    slrd = C(0.98) * (((flux[0] + flux[1]) + flux[2]) + flux[3]);
    const T corlw = C(0.05 * 0.98) * st1[KB];
    dfabs[KB] = dfabs[KB] - corlw;
    slrd = slrd + corlw;
  }
  out1(a.slrd, slrd);
  {
    T* rf = static_cast<T*>(a.rad_flux) + b * 4 * plane + r;
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) rf[jb * plane] = flux[jb];
  }

  // ------------------------------------------------------------------
  // Surface fluxes (surface_fluxes.f90:40-320)
  // ------------------------------------------------------------------
  T tsfc, slru_avg, ustr_avg, vstr_avg, shf_avg, evap_avg;
  {
    const T fmask = bcv(FMASK), phi0 = bcv(PHIS0), land_temp = bcv(LAND_TEMP);
    const T alb_land = bcv(ALB_LAND), alb_sea = bcv(ALB_SEA);
    const T soilw = bcv(SOILW);
    const T ua = static_cast<const T*>(a.ug)[off3 + KB * plane];
    const T va = static_cast<const T*>(a.vg)[off3 + KB * plane];
    const T esbc = C(0.98 * 5.67e-8);
    const T rcp = C(1.0 / 1004.0);
    const T chl = C(1.2e-3);
    const T u0 = C(0.95) * ua, v0 = C(0.95) * va;
    const T dt1 = C(tab.wvi1[KB]) * (t[KB] - t[KA]);
    const T t1_land_ext = t[KB] + dt1;
    const T t1_sea_ext = t1_land_ext - phi0 * dt1 / C(tab.sigl_b_den);
    const bool unstable = t[KB] > t[KA];
    const T t1_land = unstable ? t1_land_ext : t[KB];
    const T t1_sea = unstable ? t1_sea_ext : t[KB];
    const T t2_sea = t[KB] + rcp * phi[KB];
    const T t2_land = t2_sea - rcp * phi0;
    const T t0 = t1_sea + fmask * (t1_land - t1_sea);
    const T denvvs0 = (C(1.0e5) * psa / (C((2.0 / 7.0) * 1004.0) * t0))
                      * tsqrt(u0 * u0 + v0 * v0 + C(25.0));
    T tskin = land_temp + C(1.0e-2) * static_cast<const T*>(a.sqrtcoa)[j] * ssrd
                          * (C(1.0) - alb_land) * psa;
    const T denvvs1 = denvvs0 * stability_factor<T>(tskin, t2_land);
    const T cdldv = C(2.4e-3) * denvvs0 * bcv(FOROG);
    const T ustr_l = -cdldv * ua, vstr_l = -cdldv * va;
    const T chlcp = C(1.2e-3 * 1004.0);
    T shf_l = chlcp * denvvs1 * (tskin - t1_land);
    const T q1 = q[KB];
    const T qsat0_l = qsat_at<T>(tskin, psa);
    T evap_l = chl * denvvs1 * tmax(soilw * qsat0_l - q1, C(0.0));
    const T tsk3 = tskin * tskin * tskin;
    const T dslr = C(4.0) * esbc * tsk3;
    T slru_l = esbc * tsk3 * tskin;
    T hfluxn_l = ssrd * (C(1.0) - alb_land) + slrd - (slru_l + shf_l + alhc * evap_l);
    const T clamb = C(7.0) + bcv(SNOWC) * C(7.0 - 7.0);
    hfluxn_l = hfluxn_l - clamb * (tskin - land_temp);
    const T qsat_dt = qsat_at<T>(tskin + C(1.0), psa);
    const T dqsat = (evap_l > C(0.0)) ? soilw * (qsat_dt - qsat0_l) : C(0.0);
    const T dtskin = hfluxn_l / (clamb + dslr + chl * denvvs1 * (cp + alhc * dqsat));
    tskin = tskin + dtskin;
    shf_l = shf_l + chlcp * denvvs1 * dtskin;
    evap_l = evap_l + chl * denvvs1 * dqsat * dtskin;
    slru_l = slru_l + dslr * dtskin;
    hfluxn_l = clamb * (tskin - land_temp);

    const T denvvs2 = denvvs0 * stability_factor<T>(bcv(SST_AM), t2_sea);
    const T cdsdv = C(1.0e-3) * denvvs2;
    const T ustr_s = -cdsdv * ua, vstr_s = -cdsdv * va;
    // Sea fluxes; evaluated again with the ocean model's temperature when
    // the sea model is coupled (physics.f90:186-195).
    const T tsea = a.sea_coupled ? bcv(SSTI_OM) : bcv(SST_AM);
    const T shf_s = C(0.9e-3 * 1004.0) * denvvs2 * (tsea - t1_sea);
    const T qsat_sea = qsat_at<T>(tsea, psa);
    const T evap_s = C(0.9e-3) * denvvs2 * (qsat_sea - q1);
    const T tsea2 = tsea * tsea;
    const T slru_s = esbc * (tsea2 * tsea2);
    // The reference adds (does not subtract) shf and evap here.
    const T hfluxn_s = ssrd * (C(1.0) - alb_sea) + slrd - slru_s + shf_s + alhc * evap_s;

    ustr_avg = ustr_s + fmask * (ustr_l - ustr_s);
    vstr_avg = vstr_s + fmask * (vstr_l - vstr_s);
    shf_avg = shf_s + fmask * (shf_l - shf_s);
    evap_avg = evap_s + fmask * (evap_l - evap_s);
    slru_avg = slru_s + fmask * (slru_l - slru_s);
    tsfc = tsea + fmask * (land_temp - tsea);
    out3(a.ustr, ustr_l, ustr_s, ustr_avg);
    out3(a.vstr, vstr_l, vstr_s, vstr_avg);
    out3(a.shf, shf_l, shf_s, shf_avg);
    out3(a.evap, evap_l, evap_s, evap_avg);
    out3(a.slru, slru_l, slru_s, slru_avg);
    out3(a.hfluxn, hfluxn_l, hfluxn_s, C(0.0));   // third row: zeros
  }

  // ------------------------------------------------------------------
  // Longwave, upward (longwave_radiation.f90:124-205)
  // ------------------------------------------------------------------
  {
    const T fsfcu = slru_avg;
    out1(a.slr, fsfcu - slrd);
    T fb[4];
    band_fractions<T>(tsfc, fb);
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) flux[jb] = fb[jb] * fsfcu + C(1.0 - 0.98) * flux[jb];
    dfabs[KB] = dfabs[KB] + C(0.05) * fsfcu;
#pragma unroll
    for (int k = KX - 1; k >= 1; --k) {
      band_fractions<T>(t[k], fb);
      const T s1 = st4a[k * plane], s2 = st4a[(KX + k) * plane];
      T d[4];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        const T tau = tau2[(jb * KX + k) * plane];
        const T emis = C(1.0) - tau;
        const T brad = fb[jb] * (s1 - emis * s2);
        const T nf = tau * flux[jb] + emis * brad;
        d[jb] = flux[jb] - nf;
        flux[jb] = nf;
      }
      dfabs[k] = dfabs[k] + (((d[0] + d[1]) + d[2]) + d[3]);
    }
    // Stratosphere: bands 1-2 only; the other two pass through.
    band_fractions<T>(t[0], fb);
    {
      const T s2 = st4a[KX * plane];
      T d[4];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        if (jb < 2) {
          const T tau = tau2[(jb * KX) * plane];
          const T emis = C(1.0) - tau;
          const T brad = fb[jb] * (st1_0 - emis * s2);
          const T nf = tau * flux[jb] + emis * brad;
          d[jb] = flux[jb] - nf;
          flux[jb] = nf;
        } else {
          d[jb] = C(0.0);
        }
      }
      dfabs[0] = dfabs[0] + (((d[0] + d[1]) + d[2]) + d[3]);
    }
    const T corlw1 = C(tab.dhs[0]) * sc1 * st1_0 + sc0;
    const T corlw2 = C(tab.dhs[1]) * sc1 * st1_1;
    dfabs[0] = dfabs[0] - corlw1;
    dfabs[1] = dfabs[1] - corlw2;
    out1(a.olr, corlw1 + corlw2 + (((flux[0] + flux[1]) + flux[2]) + flux[3]));
#pragma unroll
    for (int k = 0; k < KX; ++k)
      ttend[k] = (ttend[k] + tt_rsw[k * plane]) + dfabs[k] * (rps * C(tab.grdscp[k]));
  }

  // ------------------------------------------------------------------
  // Vertical diffusion and shallow convection (vertical_diffusion.f90:30-146)
  // ------------------------------------------------------------------
  {
    T ttv[KX], qtv[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) { ttv[k] = C(0.0); qtv[k] = C(0.0); }
    const T se_b = SE(KB), se_a = SE(KA);
    const T dmse = se_b - se_a + alhc * (q[KB] - qsat[KA]);
    const T drh = RH(KB) - RH(KA);
    const T fcnv = (icnv > 0) ? C(0.5) : C(1.0);
    T fluxse = C(0.0), fluxq = C(0.0);
    if (dmse >= C(0.0)) {
      fluxse = fcnv * C(tab.fshcse) * dmse;
      if (drh >= C(0.0)) fluxq = fcnv * C(tab.fshcq) * qsat[KB] * drh;
    } else if (drh > C(tab.drh0)) {
      fluxq = C(tab.fvdiq2) * qsat[KA] * drh;
    }
    ttv[KA] = C(tab.rsig[KA]) * fluxse;
    ttv[KB] = -(C(tab.rsig[KB]) * fluxse);
    qtv[KA] = C(tab.rsig[KA]) * fluxq;
    qtv[KB] = -(C(tab.rsig[KB]) * fluxq);
    // Moisture diffusion above the boundary layer.
    {
      T fq_prev = C(0.0);
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        T fq = C(0.0);
        if (k < KX - 1 && tab.gate[k] > 0.0) {
          const T drhk = RH(k + 1) - RH(k);
          if (drhk >= C(tab.drh0k[k])) fq = C(tab.fvdiq2k[k]) * qsat[k] * drhk;
        }
        qtv[k] = qtv[k] + (fq - fq_prev) * C(tab.rsig[k]);
        fq_prev = fq;
      }
    }
    // Damping of super-adiabatic lapse rates.
    {
      T below = C(0.0);   // sum of fse * rsig1 over the levels above
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        T fse = C(0.0);
        if (k < KX - 1) {
          const T se_k = SE(k);
          const T se0 = SE(k + 1) + C(0.1) * (phi[k] - phi[k + 1]);
          if (se_k < se0) fse = C(tab.fvdise) * (se0 - se_k);
          ttv[k] = ttv[k] + fse * C(tab.rsig[k]);
        }
        if (k > 0) ttv[k] = ttv[k] - below;
        if (k < KX - 1) below = below + fse * C(tab.rsig1[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      ttend[k] = ttend[k] + ttv[k];
      qtend[k] = qtend[k] + qtv[k];
    }
  }

  // ------------------------------------------------------------------
  // Surface-flux tendencies of the lowest layer, SPPT, and the stores
  // ------------------------------------------------------------------
  const T gsig = rps * C(tab.grdsig[KB]);
  const T gscp = rps * C(tab.grdscp[KB]);
  T ub = ustr_avg * gsig;
  T vb = vstr_avg * gsig;
  ttend[KB] = ttend[KB] + shf_avg * gscp;
  qtend[KB] = qtend[KB] + evap_avg * gsig;
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    const long long o = off3 + k * plane;
    T ut = (k == KB) ? ub : C(0.0);
    T vt = (k == KB) ? vb : C(0.0);
    T tt_k = ttend[k], qt_k = qtend[k];
    if (a.sppt != nullptr) {
      const T f = C(1.0) + static_cast<const T*>(a.sppt)[o];
      ut = f * ut; vt = f * vt; tt_k = f * tt_k; qt_k = f * qt_k;
    }
    static_cast<T*>(a.utend)[o] = ut;
    static_cast<T*>(a.vtend)[o] = vt;
    static_cast<T*>(a.ttend)[o] = tt_k;
    static_cast<T*>(a.qtend)[o] = qt_k;
  }
#undef C
#undef SE
#undef RH
}

template <typename T, int KX>
int launch(bool sw, long long nmem, int il, int ix, const PhysArgs& a,
           const PhysTables& tab, cudaStream_t stream) {
  const long long ncol = nmem * il * ix;
  if (ncol <= 0) return 0;
  const long long nblocks = (ncol + kThreads - 1) / kThreads;
  if (nblocks > 2147483647LL) return -3;
  const unsigned nb = static_cast<unsigned>(nblocks);
  if (sw)
    grid_physics_kernel<T, KX, true><<<nb, kThreads, 0, stream>>>(ncol, il, ix, a, tab);
  else
    grid_physics_kernel<T, KX, false><<<nb, kThreads, 0, stream>>>(ncol, il, ix, a, tab);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_kx(int kx, bool sw, long long nmem, int il, int ix, const PhysArgs& a,
              const PhysTables& tab, cudaStream_t stream) {
  switch (kx) {
    case 5: return launch<T, 5>(sw, nmem, il, ix, a, tab, stream);
    case 7: return launch<T, 7>(sw, nmem, il, ix, a, tab, stream);
    case 8: return launch<T, 8>(sw, nmem, il, ix, a, tab, stream);
    default: return -2;
  }
}

}  // namespace

// ptrs (52 pointers, null where a field is absent), in this order:
//   0-8   ug, vg, tg, qg, phig, pslg, phisg, m0corr, sppt
//   9-10  sqrtcoa, ablco2
//   11-26 the 16 boundary fields in the order of BC_FIELDS
//   27-33 cache: tt_rsw, rad_tau2, rad_strat_corr, tsr, ssrd, ssr, qcloud_equiv
//   34-37 utend, vtend, ttend, qtend
//   38-51 cbmf, precnv, precls, slrd, slr, olr, ustr, vstr, shf, evap, slru,
//         hfluxn, rad_flux, rad_st4a
// strides: 1 + 3*16 element strides: ablco2 member stride, then for each
//   boundary field its member, latitude and longitude stride.
// levels: 17 rows of kx doubles (the arrays of PhysTables in order) followed
//   by its 8 scalars.
// elem_size: 4 (float) or 8 (double).
extern "C" int pyspeedy_grid_physics(
    int elem_size, int kx, int sw_flag, int sea_coupled, long long nmem, int il,
    int ix, const void* const* ptrs, const long long* strides,
    const double* levels, void* stream) {
  if (kx < 1 || kx > kMaxLevels) return -2;
  PhysArgs a = {};
  a.ug = ptrs[0]; a.vg = ptrs[1]; a.tg = ptrs[2]; a.qg = ptrs[3];
  a.phig = ptrs[4]; a.pslg = ptrs[5]; a.phisg = ptrs[6]; a.m0corr = ptrs[7];
  a.sppt = ptrs[8]; a.sqrtcoa = ptrs[9]; a.ablco2 = ptrs[10];
  a.ablco2_stride = strides[0];
  for (int f = 0; f < kNumBc; ++f) {
    a.bc[f] = ptrs[11 + f];
    a.bc_sm[f] = strides[1 + 3 * f];
    a.bc_sl[f] = strides[2 + 3 * f];
    a.bc_sx[f] = strides[3 + 3 * f];
  }
  void* const* w = const_cast<void* const*>(ptrs);
  a.tt_rsw = w[27]; a.rad_tau2 = w[28]; a.rad_sc = w[29]; a.tsr = w[30];
  a.ssrd = w[31]; a.ssr = w[32]; a.qcloud = w[33];
  a.utend = w[34]; a.vtend = w[35]; a.ttend = w[36]; a.qtend = w[37];
  a.cbmf = w[38]; a.precnv = w[39]; a.precls = w[40]; a.slrd = w[41];
  a.slr = w[42]; a.olr = w[43]; a.ustr = w[44]; a.vstr = w[45]; a.shf = w[46];
  a.evap = w[47]; a.slru = w[48]; a.hfluxn = w[49]; a.rad_flux = w[50];
  a.rad_st4a = w[51];
  a.sea_coupled = sea_coupled;
  if (a.phig == nullptr && (a.phisg == nullptr || a.m0corr == nullptr)) return -4;

  PhysTables tab = {};
  double* rows[17] = {tab.fsg, tab.dhs, tab.grdsig, tab.grdscp, tab.wvi1, tab.entr,
                      tab.rhref, tab.dqmax, tab.wcol, tab.abs1, tab.rsig, tab.rsig1,
                      tab.drh0k, tab.fvdiq2k, tab.gate, tab.xgeop1, tab.xgeop2};
  for (int n = 0; n < 17; ++n)
    for (int k = 0; k < kx; ++k) rows[n][k] = levels[n * kx + k];
  const double* sc = levels + 17 * kx;
  tab.fm0 = sc[0]; tab.sigl_b_den = sc[1]; tab.fshcq = sc[2]; tab.fshcse = sc[3];
  tab.fvdise = sc[4]; tab.drh0 = sc[5]; tab.fvdiq2 = sc[6]; tab.eps1_strat = sc[7];

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sw = sw_flag != 0;
  if (elem_size == 4) return launch_kx<float>(kx, sw, nmem, il, ix, a, tab, s);
  if (elem_size == 8) return launch_kx<double>(kx, sw, nmem, il, ix, a, tab, s);
  return -1;
}
