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
// about 350 MB in float, 0.105 ms at 3.35 TB/s (0.21 ms in double). The
// arithmetic, about 2,500 operations per column with 30-odd exponentials on
// a shortwave step, stays under the byte time.
//
// What held the first design (one thread per column, every level array in
// registers, the radiation arrays stored to device memory and read back by
// the same thread, per-level tables held in double) at 45-47 % of the bound
// in float and 20 % in double: 225-230 registers in float (8 warps per SM,
// too few loads in flight to cover device-memory latency), 255 registers
// and 368-476 spilled bytes in double, a double-to-float conversion at every
// use of a table in float, and a store-then-load through L2 on a dependent
// path for every band transmissivity, emission and heating value.
//
// Design.
// * One thread per column, longitude fastest (a warp reads 32 neighbouring
//   longitudes of a level plane), KX a template parameter and every level
//   loop unrolled. Columns never meet: no barrier, no atomics.
// * Per-thread level arrays in shared memory. T, q, phi, qsat and the four
//   band transmissivities (8*kx values) and the column's scalars (ps, the
//   lowest wind level, the 16 boundary values, on a step without shortwave
//   the cached ssrd and stratospheric correction) live in dynamic shared
//   memory laid out [slot][thread], so a warp's access to one slot is 32
//   consecutive words: no bank conflict, an immediate offset per access. A
//   thread touches only its own column's slots. What stays in registers is
//   the tendencies, the flux divergences and the transients of one scheme.
// * Inputs staged ahead of use. At its start a thread issues cp.async copies
//   of every value its column reads (all levels of T, q, phi or the m = 0
//   correction, ps, the lowest u and v, the boundary values; on a step
//   without shortwave, in a second group, the cached transmissivities, ssrd
//   and the stratospheric correction), so all of a column's loads are in
//   flight at once whatever the register count; the second group is waited
//   for only before the longwave.
// * No device-memory round trip. Outputs are written once, through pointers
//   that are never read. The shortwave heating is added to the temperature
//   tendency where it is made (nothing touches that tendency between there
//   and the longwave, where the first design added it back), the
//   transmissivities come from shared memory in both longwave sweeps, and
//   the two emission arrays are recomputed from T for the upward sweep, in
//   the same operations, instead of being read back.
// * Tables in the scalar type. PhysTables<T> holds the per-level tables and
//   derived scalars already rounded to T on the host; they ride in the
//   argument struct and reach the arithmetic as constant-bank operands, with
//   no conversion.
// * Block sizes: 128 columns in float, 64 in double, with a register budget
//   (Block<T>). Shared memory per column is (8*kx + 22) values: 43 KB a
//   block at kx = 8 in either type.
// * In double, the exponential is called out of line (exp_call): the
//   shortwave variant's code otherwise outgrows the instruction cache.
// * Boundary fields come with a member, a latitude and a longitude stride
//   each (0 where the field is broadcast), so shared (il, ix), zonal (il, 1)
//   and per-member (B, il, ix) fields are read in place. cos(lat) enters as
//   an (il,) vector of sqrt(cos). The CO2 absorptivity is read through a
//   pointer with a member stride.
// * Order of operations: a column's arithmetic is the plain version's. What
//   the TPU kernel does with level-parallel masks, one-hot selections and
//   shift-add prefix sums is here the sequential column loop that those stand
//   for, with one exception: the updraft's entrained mass, static energy and
//   moisture are summed by the plain version's shift-add passes, because the
//   convective heating is a difference of fluxes four orders of magnitude
//   larger and a running sum moved it by 1e-5 of the largest tendency in
//   float. Data-dependent level indices (cloud top, convection top) are
//   predicates inside unrolled loops, never array subscripts. Level indices
//   are ints with the reference's 1-based meaning (kx+1: none). The source is
//   compiled with -fmad=false: the plain version runs as separate
//   elementwise passes that cannot contract a*b+c, and the scheme's
//   thresholds (convection and cloud tops, stability switches, nint(T)) turn
//   a last-bit difference into a different branch.
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3, power limit 700 W,
// T30L8, B = 128, the main path's grid_phi mode on seeded random columns;
// the first design's times from the same runs):
//   float, shortwave    108 registers, 16 warps per SM, 0.172 ms (0.235),
//                       61 % of the byte bound; 0.162 ms on the model's own
//                       state after a day (67 %)
//   float, without       96 registers, 20 warps per SM, 0.159 ms (0.217), 65 %
//   double, shortwave   166 registers, 10 warps per SM, 0.38 ms (1.12), 55 %
//   double, without     168 registers, 10 warps per SM, 0.33 ms (0.48), 63 %
//   bfloat16 tendencies with an SPPT pattern: 0.194 / 0.168 ms (0.279 /
//   0.254); no spill, no local memory and no conversion between float and
//   double in any float instantiation.
//
// Interface: plain C, loaded with ctypes. The launch goes to the stream it is
// given, allocates nothing and does not synchronise; the function returns
// cudaGetLastError() (0 on success), or a negative code for arguments the
// kernel was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kNumBc = 16;
constexpr int kNumTableRows = 17;
constexpr int kNumTableScalars = 8;

// Columns per block: 128 in float, 64 in double (the same shared memory).
// Columns per block and the blocks an SM must hold (a register budget):
// 128 columns and 4 blocks (at most 128 registers) in float, 64 columns and
// 5 blocks (at most 204) in double, where 5 blocks of 44 KB fill the shared
// memory.
template <typename T> struct Block {
  static constexpr int threads = 128, min_blocks = 4;
};
template <> struct Block<double> {
  static constexpr int threads = 64, min_blocks = 5;
};


// Order of the boundary fields (physics/driver.py::BC_FIELDS).
enum Bc {
  FMASK, PHIS0, FOROG, SST_AM, ALB_LAND, ALB_SEA, ALB_SFC, SNOWC, LAND_TEMP,
  SOILW, ZENIT, FSOL, OZUPP, OZONE, STRATZ, SSTI_OM
};

// Per-level tables and derived scalars in the model's scalar type, rounded
// to it on the host (ops/column_kernels.py::build_physics_tables).
template <typename T>
struct PhysTables {
  T fsg[kMaxLevels];
  T dhs[kMaxLevels];
  T grdsig[kMaxLevels];
  T grdscp[kMaxLevels];
  T wvi1[kMaxLevels];     // wvi[:, 1]
  T entr[kMaxLevels];     // entrainment profile
  T rhref[kMaxLevels];    // large-scale condensation RH threshold
  T dqmax[kMaxLevels];    // cap of the heating humidity tendency
  T wcol[kMaxLevels];     // dhs * p0 / g
  T abs1[kMaxLevels];     // absdry + absaer * fsg^2
  T rsig[kMaxLevels];     // 1 / dhs
  T rsig1[kMaxLevels];    // 1 / (1 - sigh[k+1])
  T drh0k[kMaxLevels];    // rhgrad * (fsg[k+1] - fsg[k])
  T fvdiq2k[kMaxLevels];  // fvdiq * sigh[k+1]
  T gate[kMaxLevels];     // 1 where moisture diffusion acts
  T xgeop1[kMaxLevels];
  T xgeop2[kMaxLevels];
  T fm0, sigl_b_den, fshcq, fshcse, fvdise, drh0, fvdiq2, eps1_strat;
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

// Shared-memory slots of one column (each slot is a row of Block<T>::threads
// values, one per thread of the block).
template <int KX>
struct Slots {
  static constexpr int t = 0;            // KX levels of T
  static constexpr int q = KX;           // KX levels of q (then max(q, 0))
  static constexpr int phi = 2 * KX;     // KX levels of phi (or m0corr first)
  static constexpr int qsat = 3 * KX;    // KX levels of qsat
  static constexpr int tau = 4 * KX;     // 4 bands x KX levels
  static constexpr int ps = 8 * KX;      // log ps, then the scalars below
  static constexpr int ua = ps + 1;
  static constexpr int va = ps + 2;
  static constexpr int ssrd = ps + 3;    // cached, on a step without shortwave
  static constexpr int sc0 = ps + 4;
  static constexpr int sc1 = ps + 5;
  static constexpr int bc = ps + 6;      // the 16 boundary values
  static constexpr int count = bc + kNumBc;
};

__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char smem_[];
  return smem_;
}

// One element copied from device memory to shared memory without passing
// through registers; completed by copy_wait.
template <typename D, typename T>
__device__ __forceinline__ void copy_async(D* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared((const void*)dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(s), "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
#endif
}

template <typename T> __device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T> __device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
__device__ __forceinline__ float texp(float x) { return expf(x); }
// In double the exponential is one out-of-line function: inlined at its 45
// call sites it grew the shortwave variant to 9,720 instructions (155 KB),
// beyond the instruction cache; called, the same operations give the same
// bits (measured on an H100: 0.94 -> 0.38 ms at T30L8, B = 128).
__device__ __noinline__ double exp_call(double x) { return exp(x); }
__device__ __forceinline__ double texp(double x) { return exp_call(x); }
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

// The longwave emission of every level (longwave_radiation.f90:49-78):
// st1 the blackbody emission, st2 its gradient correction, from T in the
// column's slots (t[k] at t[k * NT]). Called for the downward sweep and
// again for the upward one, where the first design read back what it had
// stored; the same operations give the same values.
template <typename T, int KX, int NT, typename P>
__device__ __forceinline__ void emission(P t, const PhysTables<T>& tab,
                                         T st1[KX], T st2[KX]) {
  constexpr int KB = KX - 1;
  const T sbc = static_cast<T>(5.67e-8);
  T tb[KX];
#pragma unroll
  for (int k = 0; k < KX - 1; ++k)
    tb[k] = t[k * NT] + tab.wvi1[k] * (t[(k + 1) * NT] - t[k * NT]);
  st2[0] = static_cast<T>(0.75) * t[0] + static_cast<T>(0.25) * tb[0];
  st2[1] = static_cast<T>(0.50) * t[NT] + static_cast<T>(0.25) * (tb[0] + tb[1]);
#pragma unroll
  for (int k = 2; k < KX - 1; ++k)
    st2[k] = static_cast<T>(0.5) * tmax(tb[k] - tb[k - 1], static_cast<T>(0.0));
  st2[KB] = tmax(t[KB * NT] - tb[KX - 2], static_cast<T>(0.0));
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T sq = st2[k] * st2[k];
    st1[k] = sbc * (sq * sq);
    st2[k] = static_cast<T>(0.0);
  }
#pragma unroll
  for (int k = 2; k < KX; ++k) {
    const T tk = t[k * NT];
    const T st3a = sbc * (tk * tk * tk);
    st1[k] = st3a * tk;
    st2[k] = static_cast<T>(4.0) * st3a * st2[k];
  }
}

// Store one tendency value: as it is, or rounded to bfloat16 through float
// (a double as the JAX package's astype(bfloat16) rounds it on the CPU).
template <bool BF16, typename T>
__device__ __forceinline__ void put_tend(void* p, long long o, T v) {
  if constexpr (BF16)
    static_cast<__nv_bfloat16*>(p)[o] = __float2bfloat16_rn(static_cast<float>(v));
  else
    static_cast<T*>(p)[o] = v;
}

// BF16: the four tendencies leave as bfloat16, rounded to nearest even from
// the float value after the SPPT multiply (the bf16_tendencies configuration,
// in either scalar type);
// the diagnostics and the radiation cache keep the scalar type.
template <typename T, int KX, bool SW, bool BF16>
__global__ void __launch_bounds__(Block<T>::threads, Block<T>::min_blocks)
grid_physics_kernel(long long ncol, int il, int ix, const __grid_constant__ PhysArgs a,
                    const __grid_constant__ PhysTables<T> tab) {
  constexpr int NT = Block<T>::threads;
  using S = Slots<KX>;
  const long long col = blockIdx.x * static_cast<long long>(NT) + threadIdx.x;
  if (col >= ncol) return;
  // This column's slots: slot s at sm[s * NT]. Volatile, so that every use
  // reads the slot again instead of holding a copy in a register (without
  // it: 198-218 registers in float, 255 and spills in double).
  volatile T* const sm = reinterpret_cast<volatile T*>(dyn_smem()) + threadIdx.x;

#define C(x) static_cast<T>(x)
#define SM(s) sm[(s) * NT]
#define TK(k) SM(S::t + (k))
#define QK(k) SM(S::q + (k))
#define PHI(k) SM(S::phi + (k))
#define QSAT(k) SM(S::qsat + (k))
#define TAU(jb, k) SM(S::tau + (jb) * KX + (k))
#define BCV(f) SM(S::bc + (f))
#define SE(k) (cp * TK(k) + PHI(k))
#define RH(k) (QK(k) / QSAT(k))
  const long long plane = static_cast<long long>(il) * ix;
  const long long b = col / plane;
  const long long r = col - b * plane;
  const int j = static_cast<int>(r / ix);
  const int i = static_cast<int>(r - static_cast<long long>(j) * ix);
  const long long off3 = b * KX * plane + r;   // (B, KX, il, ix)
  const long long off1 = col;                  // (B, il, ix)

  // ------------------------------------------------------------------
  // Stage the column's inputs: group 0 what the first schemes read, group 1
  // (a step without shortwave) the cache the longwave reads.
  // ------------------------------------------------------------------
  {
    const T* tg = static_cast<const T*>(a.tg) + off3;
    const T* qg = static_cast<const T*>(a.qg) + off3;
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      copy_async(&TK(k), tg + k * plane);
      copy_async(&QK(k), qg + k * plane);
    }
    if (a.phig != nullptr) {
      const T* pg = static_cast<const T*>(a.phig) + off3;
#pragma unroll
      for (int k = 0; k < KX; ++k) copy_async(&PHI(k), pg + k * plane);
    } else {
      const T* m0 = static_cast<const T*>(a.m0corr) + b * KX * il + j;
#pragma unroll
      for (int k = 0; k < KX; ++k) copy_async(&PHI(k), m0 + k * il);
    }
    copy_async(&SM(S::ps), static_cast<const T*>(a.pslg) + off1);
    copy_async(&SM(S::ua), static_cast<const T*>(a.ug) + off3 + (KX - 1) * plane);
    copy_async(&SM(S::va), static_cast<const T*>(a.vg) + off3 + (KX - 1) * plane);
#pragma unroll
    for (int f = 0; f < kNumBc; ++f)
      copy_async(&BCV(f), static_cast<const T*>(a.bc[f]) + b * a.bc_sm[f] + j * a.bc_sl[f]
                              + i * a.bc_sx[f]);
    copy_commit();
    if (!SW) {
      const T* tau_in = static_cast<const T*>(a.rad_tau2) + b * 4 * KX * plane + r;
#pragma unroll
      for (int n = 0; n < 4 * KX; ++n) copy_async(&SM(S::tau + n), tau_in + n * plane);
      copy_async(&SM(S::ssrd), static_cast<const T*>(a.ssrd) + off1);
      const T* sc_in = static_cast<const T*>(a.rad_sc) + b * 2 * plane + r;
      copy_async(&SM(S::sc0), sc_in);
      copy_async(&SM(S::sc1), sc_in + plane);
    }
    copy_commit();
    copy_wait<1>();
  }

  auto out1 = [&](void* p, T v) { static_cast<T*>(p)[off1] = v; };
  auto out3 = [&](void* p, T land, T sea, T avg) {
    T* __restrict__ q3 = static_cast<T*>(p) + b * 3 * plane + r;
    q3[0] = land; q3[plane] = sea; q3[2 * plane] = avg;
  };

  const T cp = C(1004.0), alhc = C(2501.0);
  constexpr int NL1 = KX - 1;   // 1-based index of the level above the lowest
  constexpr int KB = KX - 1;    // 0-based lowest level
  constexpr int KA = KX - 2;    // 0-based level above it

  // ------------------------------------------------------------------
  // Thermodynamics (physics.f90:107-116)
  // ------------------------------------------------------------------
  const T psa = texp(SM(S::ps));
  const T rps = C(1.0) / psa;
#pragma unroll
  for (int k = 0; k < KX; ++k) QK(k) = tmax(QK(k), C(0.0));
  if (a.phig == nullptr) {
    // Hydrostatic integration from the surface (geopotential.f90:49-77) plus
    // the zonally uniform m=0 lapse-rate correction, staged in the phi slots.
    T p = static_cast<const T*>(a.phisg)[r] + tab.xgeop1[KB] * TK(KB);
    PHI(KB) = p + PHI(KB);
#pragma unroll
    for (int k = KX - 2; k >= 0; --k) {
      p = (p + tab.xgeop2[k + 1] * TK(k + 1)) + tab.xgeop1[k] * TK(k);
      PHI(k) = p + PHI(k);
    }
  }
#pragma unroll
  for (int k = 0; k < KX; ++k) QSAT(k) = qsat_at<T>(TK(k), tab.fsg[k] * psa);

  // ------------------------------------------------------------------
  // Deep convection (convection.f90:27-253)
  // ------------------------------------------------------------------
  int itop = KX + 1;
  T qdif = C(0.0);
  {
    const T mse0 = SE(KB) + alhc * QK(KB);
    const T mse1 = tmin(mse0, SE(KA) + alhc * QK(KA));
    const T mss0 = tmax(mse0, SE(KB) + alhc * QSAT(KB));
    int ktop1 = KX, ktop2 = KX;
    T msthr = C(0.0);
    // 1-based levels 3 .. kx-3, descending, so the smallest hit wins.
#pragma unroll
    for (int k1 = KX - 3; k1 >= 3; --k1) {
      const int k = k1 - 1;
      const T mss_k = SE(k) + alhc * QSAT(k);
      const T mss_k1 = SE(k + 1) + alhc * QSAT(k + 1);
      const T mss2 = mss_k + tab.wvi1[k] * (mss_k1 - mss_k);
      if (mss0 > mss2) ktop1 = k1;
      if (mse1 > mss2) { ktop2 = k1; msthr = mss2; }
    }
    const T qthr0 = C(0.9) * QSAT(KB);
    const T qthr1 = C(0.9) * QSAT(KA);
    const bool lqthr = (QK(KB) > qthr0) && (QK(KA) > qthr1);
    const bool candidate = (psa > C(0.8)) && (ktop1 < KX);
    const bool deep = candidate && (ktop2 < KX);
    const bool shallow = candidate && (ktop2 >= KX) && lqthr;
    if (deep) {
      itop = ktop1;
      qdif = tmax(QK(KB) - qthr0, (mse0 - msthr) * C(1.0 / 2501.0));
    } else if (shallow) {
      itop = ktop1;
      qdif = QK(KB) - qthr0;
    }
  }

  T ttend[KX], qtend[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) { ttend[k] = C(0.0); qtend[k] = C(0.0); }
  T cbmf = C(0.0), precnv = C(0.0);
  if (itop <= KX) {
    const T qmax = tmax(C(1.01) * QK(KB), QSAT(KB));
    const T se_b = SE(KB), se_a = SE(KA);
    const T sb_b = se_a + tab.wvi1[KA] * (se_b - se_a);
    const T qb_b = tmin(QK(KA) + tab.wvi1[KA] * (QK(KB) - QK(KA)), QK(KB));
    const T fpsa = psa * tmin((psa - C(0.8)) * C(2.0 / (1.0 - 0.8)), C(1.0));
    cbmf = tab.fm0 * fpsa * tmin(qdif / (qmax - qb_b), C(5.0));
    const T fus_bb = cbmf * se_b, fuq_bb = cbmf * qmax;
    T fus = fus_bb, fuq = fuq_bb;
    T fds = cbmf * sb_b, fdq = cbmf * qb_b;
    T dfse[KX], dfqa[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) { dfse[k] = C(0.0); dfqa[k] = C(0.0); }
    dfse[KB] = fds - fus;
    T sec_total = C(0.0);
    const T bot_q = fdq - fuq;
    // Entrained mass, static energy and moisture of the intermediate layers
    // (1-based k1 = kx-1 .. itop+1), summed from each level down to the
    // boundary layer. The updraft fluxes are differences of numbers four
    // orders of magnitude larger than the tendency they leave, so the sums
    // are taken in the plain version's order of additions: log-depth
    // shift-adds over the whole column, zeros where a level does not entrain.
    T s_m[KX], s_s[KX], s_q[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int k1 = k + 1;
      const bool m = (k1 >= 3) && (k1 <= KX - 1) && (k1 > itop);
      const T enmass = m ? tab.entr[k] * psa * cbmf : C(0.0);
      s_m[k] = enmass;
      s_s[k] = enmass * SE(k);
      s_q[k] = enmass * QK(k);
    }
    static_assert(KX <= 8, "three shift-add passes cover eight levels");
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const int shift = 1 << pass;
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        if (k + shift < KX) {
          s_m[k] = s_m[k] + s_m[k + shift];
          s_s[k] = s_s[k] + s_s[k + shift];
          s_q[k] = s_q[k] + s_q[k + shift];
        }
      }
    }
#pragma unroll
    for (int k1 = KX - 1; k1 >= 3; --k1) {
      const int k = k1 - 1;
      if (k1 > itop) {
        const T se_k = SE(k), se_km = SE(k - 1);
        const T fmass_n = cbmf + s_m[k];
        const T fus_n = fus_bb + s_s[k];
        const T fuq_n = fuq_bb + s_q[k];
        const T sb = se_km + tab.wvi1[k - 1] * (se_k - se_km);
        const T qb = QK(k - 1) + tab.wvi1[k - 1] * (QK(k) - QK(k - 1));
        const T fds_n = fmass_n * sb;
        const T fdq_n = fmass_n * qb;
        dfse[k] = (fus - fds) + (fds_n - fus_n);
        dfqa[k] = (fuq - fdq) + (fdq_n - fuq_n);
        const T delq = C(0.7) * QSAT(k) - QK(k);
        if (delq > C(0.0)) {
          const T fsq = C(0.8) * cbmf * delq;
          dfqa[k] = dfqa[k] + fsq;
          sec_total = sec_total + fsq;
        }
        fus = fus_n; fuq = fuq_n; fds = fds_n; fdq = fdq_n;
      }
    }
    // Top layer: condensation and detrainment, from the updraft's final
    // fluxes (the sums of the whole column).
    const T fmass_fin = cbmf + s_m[0];
    const T fus_fin = fus_bb + s_s[0];
    const T fuq_fin = fuq_bb + s_q[0];
#pragma unroll
    for (int k1 = KX - 1; k1 >= 3; --k1) {
      const int k = k1 - 1;
      if (k1 == itop) {
        const T qsatb = QSAT(k) + tab.wvi1[k] * (QSAT(k + 1) - QSAT(k));
        const T pr = tmax(fuq_fin - fmass_fin * qsatb, C(0.0));
        precnv = pr;
        dfse[k] = (fus_fin - fds) + alhc * pr;
        dfqa[k] = (fuq_fin - fdq) - pr;
      }
    }
    dfqa[KB] = bot_q - sec_total;
    // Flux -> tendency (physics.f90:127-130): levels 2..kx.
#pragma unroll
    for (int k = 1; k < KX; ++k) {
      ttend[k] = dfse[k] * (rps * tab.grdscp[k]);
      qtend[k] = dfqa[k] * (rps * tab.grdsig[k]);
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
      const T dqa = tab.rhref[k] * QSAT(k) - QK(k);
      T dq = C(0.0), dt = C(0.0);
      if (dqa < C(0.0)) {
        iptop = min(iptop, k + 1);
        dq = dqa * rtlsc;
        dt = C(2501.0 / 1004.0) * tmin(-dq, tab.dqmax[k] * psa2);
      }
      acc = acc + tab.wcol[k] * dq;
      ttend[k] = ttend[k] + dt;
      qtend[k] = qtend[k] + dq;
    }
    precls = -acc * psa;
  }
  out1(a.precls, precls);

  // ------------------------------------------------------------------
  // Shortwave and the radiation cache (shortwave_radiation.f90:50-404). The
  // heating joins the temperature tendency here (the plain version adds it
  // after the longwave; nothing changes that tendency in between).
  // ------------------------------------------------------------------
  T ssrd, sc0, sc1;
  if (SW) {
    // Clouds.
    const T gse = (SE(KA) - SE(KB)) / (PHI(KA) - PHI(KB));
    const T rh_a = RH(KA);
    const bool base = rh_a > C(0.30);
    T cloudc = base ? rh_a - C(0.30) : C(0.0);
    int icltop = base ? NL1 : KX + 1;
#pragma unroll
    for (int k1 = 3; k1 <= KX - 2; ++k1) {
      const T drh = RH(k1 - 1) - C(0.30);
      if ((drh > cloudc) && (QK(k1 - 1) > C(0.20))) { cloudc = drh; icltop = k1; }
    }
    const T pr1 = tmin(C(86.4) * (precnv + precls), C(10.0));
    const T cl1 = tmin(cloudc * C(1.0 / (1.00 - 0.30)), C(1.0));
    cloudc = tmin(C(0.2) * tsqrt(pr1) + cl1 * cl1, C(1.0));
    icltop = min(iptop, icltop);
    const T qcloud = QK(KA);
    const T fstab = tmin(tmax(C(1.0 / (0.40 - 0.25)) * (gse - C(0.25)), C(0.0)), C(1.0));
    T clstr = fstab * tmax(C(0.60) - C(1.2) * cloudc, C(0.0));
    const T clstrl = tmax(clstr, C(0.15)) * RH(KB);
    clstr = clstr + BCV(FMASK) * (clstrl - clstr);

    // Transmissivities of the visible band and cloud reflection slots.
    T tau1[KX], tau3[KX], tt[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) tau3[k] = C(0.0);
#pragma unroll
    for (int k1 = 3; k1 <= KX; ++k1)
      if (icltop == k1) tau3[k1 - 1] = C(0.43) * cloudc;
    tau3[KB] = C(0.50) * clstr;   // overwrites a cloud top at kx

    const T psaz = psa * BCV(ZENIT);
    const T acloud = cloudc * tmin(C(0.015) * qcloud, C(0.15));
    tau1[0] = texp(-psaz * tab.dhs[0] * C(0.033));
#pragma unroll
    for (int k1 = 2; k1 <= KX - 1; ++k1) {
      const int k = k1 - 1;
      const T deltap = psaz * tab.dhs[k];
      const T clear = tab.abs1[k] + C(0.022) * QK(k);
      tau1[k] = texp(-deltap * ((k1 >= icltop) ? clear + acloud : clear));
    }
    tau1[KB] = texp(-psaz * tab.dhs[KB] * (tab.abs1[KB] + C(0.022) * QK(KB)));

    // Downward sweeps.
    const T fsol = BCV(FSOL);
    T flux1 = fsol * C(1.0 - 0.05);
    T flux2 = fsol * C(0.05);
    tt[0] = flux1;
    flux1 = tau1[0] * (flux1 - BCV(OZUPP) * psa);
    tt[0] = tt[0] - flux1;
    tt[1] = flux1;
    flux1 = tau1[1] * (flux1 - BCV(OZONE) * psa);
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
      const T tau2b = texp(-psaz * tab.dhs[k] * C(15.0) * QK(k));
      tt[k] = tt[k] + flux2;
      flux2 = tau2b * flux2;
      tt[k] = tt[k] - flux2;
    }
    // Surface and upward sweep.
    ssrd = flux1 + flux2;
    flux1 = flux1 * BCV(ALB_SFC);
    const T ssr = ssrd - flux1;
#pragma unroll
    for (int k = KX - 1; k >= 0; --k) {
      tt[k] = tt[k] + flux1;
      flux1 = tau1[k] * flux1;
      tt[k] = tt[k] - flux1;
      flux1 = flux1 + tau3[k];
    }
    const T tsr = fsol - flux1;
    {
      T* __restrict__ tt_out = static_cast<T*>(a.tt_rsw) + off3;
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        const T h = tt[k] * (rps * tab.grdscp[k]);
        tt_out[k * plane] = h;
        ttend[k] = ttend[k] + h;
      }
    }

    // Longwave transmissivities, four bands (shortwave_radiation.f90:170-205).
    const T ablco2 = static_cast<const T*>(a.ablco2)[b * a.ablco2_stride];
    const T acl_lw = cloudc * C(0.6);
    T* __restrict__ tau_out = static_cast<T*>(a.rad_tau2) + b * 4 * KX * plane + r;
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int k1 = k + 1;
      T l1, l2, l3, l4;
      if (k1 >= 3 && k1 <= KX - 1) {
        const T nd = -(psa * tab.dhs[k]);
        const T acloud1 = (k1 < icltop) ? acl_lw : C(12.0) * cloudc;
        l1 = texp(nd * (C(0.3) + acloud1));
        l2 = texp(nd * ablco2);
        l3 = texp(nd * tmax(C(0.7) * QK(k), acl_lw));
        l4 = texp(nd * tmax(C(50.0) * QK(k), acl_lw));
      } else {
        const T nd = -psa * tab.dhs[k];
        l1 = texp(nd * C(0.3));
        l2 = texp(nd * ablco2);
        if (k == 0) {
          l3 = C(1.0); l4 = C(1.0);
        } else {
          l3 = texp(nd * C(0.7) * QK(k));
          l4 = texp(nd * C(50.0) * QK(k));
        }
      }
      TAU(0, k) = l1; TAU(1, k) = l2; TAU(2, k) = l3; TAU(3, k) = l4;
      tau_out[(0 * KX + k) * plane] = l1;
      tau_out[(1 * KX + k) * plane] = l2;
      tau_out[(2 * KX + k) * plane] = l3;
      tau_out[(3 * KX + k) * plane] = l4;
    }
    sc0 = BCV(STRATZ) * psa;
    sc1 = tab.eps1_strat * psa;
    {
      T* __restrict__ sc_out = static_cast<T*>(a.rad_sc) + b * 2 * plane + r;
      sc_out[0] = sc0;
      sc_out[plane] = sc1;
    }
    out1(a.tsr, tsr);
    out1(a.ssrd, ssrd);
    out1(a.ssr, ssr);
    out1(a.qcloud, qcloud);
  } else {
    const T* tt_in = static_cast<const T*>(a.tt_rsw) + off3;
#pragma unroll
    for (int k = 0; k < KX; ++k) ttend[k] = ttend[k] + tt_in[k * plane];
    copy_wait<0>();
    ssrd = SM(S::ssrd);
    sc0 = SM(S::sc0);
    sc1 = SM(S::sc1);
  }

  // ------------------------------------------------------------------
  // Longwave, downward (longwave_radiation.f90:16-121)
  // ------------------------------------------------------------------
  T dfabs[KX];
  T flux[4];
  T slrd;
  T st1_0, st1_1;   // emission of the two stratospheric layers, kept for the up sweep
  {
    T st1[KX], st2[KX];
    emission<T, KX, NT>(&TK(0), tab, st1, st2);
    T* __restrict__ st4a = static_cast<T*>(a.rad_st4a) + b * 2 * KX * plane + r;
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      st4a[k * plane] = st1[k];
      st4a[(KX + k) * plane] = st2[k];
    }
    st1_0 = st1[0];
    st1_1 = st1[1];

    T fb[4];
    // Stratosphere: bands 1-2 only.
    band_fractions<T>(TK(0), fb);
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      if (jb < 2) {
        const T emis = C(1.0) - TAU(jb, 0);
        flux[jb] = emis * (fb[jb] * (st1[0] + emis * st2[0]));
      } else {
        flux[jb] = C(0.0);
      }
    }
    dfabs[0] = -(((flux[0] + flux[1]) + flux[2]) + flux[3]);
    // Troposphere.
#pragma unroll
    for (int k = 1; k < KX; ++k) {
      band_fractions<T>(TK(k), fb);
      T d[4];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        const T tau = TAU(jb, k);
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
    T* __restrict__ rf = static_cast<T*>(a.rad_flux) + b * 4 * plane + r;
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) rf[jb * plane] = flux[jb];
  }

  // ------------------------------------------------------------------
  // Surface fluxes (surface_fluxes.f90:40-320)
  // ------------------------------------------------------------------
  T tsfc, slru_avg, ustr_avg, vstr_avg, shf_avg, evap_avg;
  {
    const T fmask = BCV(FMASK), phi0 = BCV(PHIS0), land_temp = BCV(LAND_TEMP);
    const T alb_land = BCV(ALB_LAND), alb_sea = BCV(ALB_SEA);
    const T soilw = BCV(SOILW);
    const T ua = SM(S::ua);
    const T va = SM(S::va);
    const T esbc = C(0.98 * 5.67e-8);
    const T rcp = C(1.0 / 1004.0);
    const T chl = C(1.2e-3);
    const T u0 = C(0.95) * ua, v0 = C(0.95) * va;
    const T dt1 = tab.wvi1[KB] * (TK(KB) - TK(KA));
    const T t1_land_ext = TK(KB) + dt1;
    const T t1_sea_ext = t1_land_ext - phi0 * dt1 / tab.sigl_b_den;
    const bool unstable = TK(KB) > TK(KA);
    const T t1_land = unstable ? t1_land_ext : TK(KB);
    const T t1_sea = unstable ? t1_sea_ext : TK(KB);
    const T t2_sea = TK(KB) + rcp * PHI(KB);
    const T t2_land = t2_sea - rcp * phi0;
    const T t0 = t1_sea + fmask * (t1_land - t1_sea);
    const T denvvs0 = (C(1.0e5) * psa / (C((2.0 / 7.0) * 1004.0) * t0))
                      * tsqrt(u0 * u0 + v0 * v0 + C(25.0));
    T tskin = land_temp + C(1.0e-2) * static_cast<const T*>(a.sqrtcoa)[j] * ssrd
                          * (C(1.0) - alb_land) * psa;
    const T denvvs1 = denvvs0 * stability_factor<T>(tskin, t2_land);
    const T cdldv = C(2.4e-3) * denvvs0 * BCV(FOROG);
    const T ustr_l = -cdldv * ua, vstr_l = -cdldv * va;
    const T chlcp = C(1.2e-3 * 1004.0);
    T shf_l = chlcp * denvvs1 * (tskin - t1_land);
    const T q1 = QK(KB);
    const T qsat0_l = qsat_at<T>(tskin, psa);
    T evap_l = chl * denvvs1 * tmax(soilw * qsat0_l - q1, C(0.0));
    const T tsk3 = tskin * tskin * tskin;
    const T dslr = C(4.0) * esbc * tsk3;
    T slru_l = esbc * tsk3 * tskin;
    T hfluxn_l = ssrd * (C(1.0) - alb_land) + slrd - (slru_l + shf_l + alhc * evap_l);
    const T clamb = C(7.0) + BCV(SNOWC) * C(7.0 - 7.0);
    hfluxn_l = hfluxn_l - clamb * (tskin - land_temp);
    const T qsat_dt = qsat_at<T>(tskin + C(1.0), psa);
    const T dqsat = (evap_l > C(0.0)) ? soilw * (qsat_dt - qsat0_l) : C(0.0);
    const T dtskin = hfluxn_l / (clamb + dslr + chl * denvvs1 * (cp + alhc * dqsat));
    tskin = tskin + dtskin;
    shf_l = shf_l + chlcp * denvvs1 * dtskin;
    evap_l = evap_l + chl * denvvs1 * dqsat * dtskin;
    slru_l = slru_l + dslr * dtskin;
    hfluxn_l = clamb * (tskin - land_temp);

    const T denvvs2 = denvvs0 * stability_factor<T>(BCV(SST_AM), t2_sea);
    const T cdsdv = C(1.0e-3) * denvvs2;
    const T ustr_s = -cdsdv * ua, vstr_s = -cdsdv * va;
    // Sea fluxes; evaluated again with the ocean model's temperature when
    // the sea model is coupled (physics.f90:186-195).
    const T tsea = a.sea_coupled ? BCV(SSTI_OM) : BCV(SST_AM);
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
    T st1[KX], st2[KX];
    emission<T, KX, NT>(&TK(0), tab, st1, st2);
    const T fsfcu = slru_avg;
    out1(a.slr, fsfcu - slrd);
    T fb[4];
    band_fractions<T>(tsfc, fb);
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) flux[jb] = fb[jb] * fsfcu + C(1.0 - 0.98) * flux[jb];
    dfabs[KB] = dfabs[KB] + C(0.05) * fsfcu;
#pragma unroll
    for (int k = KX - 1; k >= 1; --k) {
      band_fractions<T>(TK(k), fb);
      const T s1 = st1[k], s2 = st2[k];
      T d[4];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        const T tau = TAU(jb, k);
        const T emis = C(1.0) - tau;
        const T brad = fb[jb] * (s1 - emis * s2);
        const T nf = tau * flux[jb] + emis * brad;
        d[jb] = flux[jb] - nf;
        flux[jb] = nf;
      }
      dfabs[k] = dfabs[k] + (((d[0] + d[1]) + d[2]) + d[3]);
    }
    // Stratosphere: bands 1-2 only; the other two pass through.
    band_fractions<T>(TK(0), fb);
    {
      const T s2 = st2[0];
      T d[4];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        if (jb < 2) {
          const T tau = TAU(jb, 0);
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
    const T corlw1 = tab.dhs[0] * sc1 * st1_0 + sc0;
    const T corlw2 = tab.dhs[1] * sc1 * st1_1;
    dfabs[0] = dfabs[0] - corlw1;
    dfabs[1] = dfabs[1] - corlw2;
    out1(a.olr, corlw1 + corlw2 + (((flux[0] + flux[1]) + flux[2]) + flux[3]));
#pragma unroll
    for (int k = 0; k < KX; ++k)
      ttend[k] = ttend[k] + dfabs[k] * (rps * tab.grdscp[k]);
  }

  // ------------------------------------------------------------------
  // Vertical diffusion and shallow convection (vertical_diffusion.f90:30-146)
  // ------------------------------------------------------------------
  {
    T ttv[KX], qtv[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) { ttv[k] = C(0.0); qtv[k] = C(0.0); }
    const T se_b = SE(KB), se_a = SE(KA);
    const T dmse = se_b - se_a + alhc * (QK(KB) - QSAT(KA));
    const T drh = RH(KB) - RH(KA);
    const T fcnv = (icnv > 0) ? C(0.5) : C(1.0);
    T fluxse = C(0.0), fluxq = C(0.0);
    if (dmse >= C(0.0)) {
      fluxse = fcnv * tab.fshcse * dmse;
      if (drh >= C(0.0)) fluxq = fcnv * tab.fshcq * QSAT(KB) * drh;
    } else if (drh > tab.drh0) {
      fluxq = tab.fvdiq2 * QSAT(KA) * drh;
    }
    ttv[KA] = tab.rsig[KA] * fluxse;
    ttv[KB] = -(tab.rsig[KB] * fluxse);
    qtv[KA] = tab.rsig[KA] * fluxq;
    qtv[KB] = -(tab.rsig[KB] * fluxq);
    // Moisture diffusion above the boundary layer.
    {
      T fq_prev = C(0.0);
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        T fq = C(0.0);
        if (k < KX - 1 && tab.gate[k] > C(0.0)) {
          const T drhk = RH(k + 1) - RH(k);
          if (drhk >= tab.drh0k[k]) fq = tab.fvdiq2k[k] * QSAT(k) * drhk;
        }
        qtv[k] = qtv[k] + (fq - fq_prev) * tab.rsig[k];
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
          const T se0 = SE(k + 1) + C(0.1) * (PHI(k) - PHI(k + 1));
          if (se_k < se0) fse = tab.fvdise * (se0 - se_k);
          ttv[k] = ttv[k] + fse * tab.rsig[k];
        }
        if (k > 0) ttv[k] = ttv[k] - below;
        if (k < KX - 1) below = below + fse * tab.rsig1[k];
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
  const T gsig = rps * tab.grdsig[KB];
  const T gscp = rps * tab.grdscp[KB];
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
    put_tend<BF16, T>(a.utend, o, ut);
    put_tend<BF16, T>(a.vtend, o, vt);
    put_tend<BF16, T>(a.ttend, o, tt_k);
    put_tend<BF16, T>(a.qtend, o, qt_k);
  }
#undef C
#undef SM
#undef TK
#undef QK
#undef PHI
#undef QSAT
#undef TAU
#undef BCV
#undef SE
#undef RH
}

// Once per instantiation: allow its dynamic shared memory and ask for the
// largest shared-memory carveout, so that several blocks fit an SM.
template <typename T, int KX, bool SW, bool BF16>
int prepare() {
  constexpr int smem = Slots<KX>::count * Block<T>::threads * static_cast<int>(sizeof(T));
  static const int rc = [] {
    int r = static_cast<int>(cudaFuncSetAttribute(
        grid_physics_kernel<T, KX, SW, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (r == 0)
      r = static_cast<int>(cudaFuncSetAttribute(
          grid_physics_kernel<T, KX, SW, BF16>,
          cudaFuncAttributePreferredSharedMemoryCarveout, 100));
    return r;
  }();
  return rc;
}

template <typename T, int KX, bool SW, bool BF16>
int launch_variant(long long ncol, int il, int ix, const PhysArgs& a,
                   const PhysTables<T>& tab, cudaStream_t stream) {
  constexpr int NT = Block<T>::threads;
  constexpr int smem = Slots<KX>::count * NT * static_cast<int>(sizeof(T));
  const int rc = prepare<T, KX, SW, BF16>();
  if (rc != 0) return rc;
  const long long nblocks = (ncol + NT - 1) / NT;
  if (nblocks > 2147483647LL) return -3;
  grid_physics_kernel<T, KX, SW, BF16>
      <<<static_cast<unsigned>(nblocks), NT, smem, stream>>>(ncol, il, ix, a, tab);
  return static_cast<int>(cudaGetLastError());
}

// out: resident blocks per SM, threads a block, dynamic shared memory a
// block, registers a thread, local memory a thread, as the runtime gives them.
template <typename T, int KX, bool SW, bool BF16>
int occupancy_of(int* out) {
  constexpr int NT = Block<T>::threads;
  constexpr int smem = Slots<KX>::count * NT * static_cast<int>(sizeof(T));
  int rc = prepare<T, KX, SW, BF16>();
  cudaFuncAttributes attr = {};
  if (rc == 0)
    rc = static_cast<int>(cudaFuncGetAttributes(&attr, grid_physics_kernel<T, KX, SW, BF16>));
  int blocks = 0;
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, grid_physics_kernel<T, KX, SW, BF16>, NT, smem));
  out[0] = blocks; out[1] = NT; out[2] = smem;
  out[3] = attr.numRegs; out[4] = static_cast<int>(attr.localSizeBytes);
  return rc;
}

template <typename T, bool BF16>
int occupancy_kx(int kx, bool sw, int* out) {
  switch (kx) {
    case 5: return sw ? occupancy_of<T, 5, true, BF16>(out) : occupancy_of<T, 5, false, BF16>(out);
    case 7: return sw ? occupancy_of<T, 7, true, BF16>(out) : occupancy_of<T, 7, false, BF16>(out);
    case 8: return sw ? occupancy_of<T, 8, true, BF16>(out) : occupancy_of<T, 8, false, BF16>(out);
    default: return -2;
  }
}

template <typename T, int KX, bool BF16>
int launch(bool sw, long long nmem, int il, int ix, const PhysArgs& a,
           const PhysTables<T>& tab, cudaStream_t stream) {
  const long long ncol = nmem * il * ix;
  if (ncol <= 0) return 0;
  return sw ? launch_variant<T, KX, true, BF16>(ncol, il, ix, a, tab, stream)
            : launch_variant<T, KX, false, BF16>(ncol, il, ix, a, tab, stream);
}

template <typename T, bool BF16>
int launch_kx(int kx, bool sw, long long nmem, int il, int ix, const PhysArgs& a,
              const void* levels, cudaStream_t stream) {
  // levels: kNumTableRows rows of kx values of T, then kNumTableScalars.
  PhysTables<T> tab = {};
  const T* lv = static_cast<const T*>(levels);
  T* rows[kNumTableRows] = {tab.fsg, tab.dhs, tab.grdsig, tab.grdscp, tab.wvi1, tab.entr,
                            tab.rhref, tab.dqmax, tab.wcol, tab.abs1, tab.rsig, tab.rsig1,
                            tab.drh0k, tab.fvdiq2k, tab.gate, tab.xgeop1, tab.xgeop2};
  for (int n = 0; n < kNumTableRows; ++n) std::memcpy(rows[n], lv + n * kx, kx * sizeof(T));
  const T* sc = lv + kNumTableRows * kx;
  tab.fm0 = sc[0]; tab.sigl_b_den = sc[1]; tab.fshcq = sc[2]; tab.fshcse = sc[3];
  tab.fvdise = sc[4]; tab.drh0 = sc[5]; tab.fvdiq2 = sc[6]; tab.eps1_strat = sc[7];
  switch (kx) {
    case 5: return launch<T, 5, BF16>(sw, nmem, il, ix, a, tab, stream);
    case 7: return launch<T, 7, BF16>(sw, nmem, il, ix, a, tab, stream);
    case 8: return launch<T, 8, BF16>(sw, nmem, il, ix, a, tab, stream);
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
// levels: in the scalar type (elem_size bytes each), 17 rows of kx values
//   (the arrays of PhysTables in order) followed by its 8 scalars.
// elem_size: 4 (float) or 8 (double). tend_bf16: utend, vtend, ttend and qtend
// are bfloat16 buffers.
extern "C" int pyspeedy_grid_physics(
    int elem_size, int tend_bf16, int kx, int sw_flag, int sea_coupled, long long nmem, int il,
    int ix, const void* const* ptrs, const long long* strides,
    const void* levels, void* stream) {
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

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sw = sw_flag != 0;
  if (elem_size == 4 && tend_bf16)
    return launch_kx<float, true>(kx, sw, nmem, il, ix, a, levels, s);
  if (elem_size == 4) return launch_kx<float, false>(kx, sw, nmem, il, ix, a, levels, s);
  if (elem_size == 8 && tend_bf16)
    return launch_kx<double, true>(kx, sw, nmem, il, ix, a, levels, s);
  if (elem_size == 8) return launch_kx<double, false>(kx, sw, nmem, il, ix, a, levels, s);
  return -1;
}

// The occupancy of one instantiation (see occupancy_of): out holds 5 ints.
extern "C" int pyspeedy_grid_physics_occupancy(int elem_size, int tend_bf16, int kx,
                                                int sw_flag, int* out) {
  const bool sw = sw_flag != 0;
  if (elem_size == 4 && tend_bf16) return occupancy_kx<float, true>(kx, sw, out);
  if (elem_size == 4) return occupancy_kx<float, false>(kx, sw, out);
  if (elem_size == 8 && tend_bf16) return occupancy_kx<double, true>(kx, sw, out);
  if (elem_size == 8) return occupancy_kx<double, false>(kx, sw, out);
  return -1;
}
