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
// 3.35 TB/s (435 MB, 0.130 ms in double). The arithmetic is about 40
// operations per level and value plus two 8x8 matrix-vector products per
// point for the implicit solve: 0.39 GFLOP at B = 128, under the byte time.
//
// What held the first design (one thread per point, every operand fetched
// from device memory through five 64-bit strides) at 36 % of the bound in
// float: each flux-spectrum element was fetched by about three load
// instructions (the point, its n-1 / n+1 neighbours, and the other pair part,
// which lay in another block), each load paid five 64-bit multiply-adds for
// its address, and every member's threads read the 256 KB of implicit
// inverses again from L2.
//
// Design: member tiles, as the TPU kernel had them.
// * A block owns one m row, both pair parts and all n of it (2*nx points,
//   padded to a whole number of warps: 64 threads at T30, 128 at T47, 160
//   at T63), for G member lanes side by side (as many as fit 256 threads
//   and the shared memory: 4 at T30, 2 at T47, 1 at T63), and walks a tile
//   of members, G at a time. A lane is at most one block of 256 threads,
//   so nx is at most 128 (T126 and below; the wrapper refuses more,
//   ops/glue_kernels.py::MAX_NX). Grid: (mx, member tiles). Each lane
//   synchronises on a named barrier of its own, so the lanes of a block do
//   not wait for each other.
// * The tile is chosen from B and mx so that the grid fills whole waves of
//   the blocks the card holds at once (plan(), reported by
//   pyspeedy_spectral_update_plan, modelled by
//   ops/glue_kernels.py::update_launch_plan): a tile of kTile = 16 members,
//   the fixed tile of the kernel's first member-tiled design, would give W
//   waves, rounded up; each m row gets floor(W x SMs x blocks an SM / mx)
//   blocks, which share its ceil(B / G) member groups equally. At T30 and
//   B = 128 that is the fixed tile again (248 blocks, one wave); at T47 12
//   members (528 blocks, two waves) and at T63 11 (768 blocks), where the
//   fixed tile made 1.45 and 1.29 waves. (One wave of
//   larger tiles, 26 and 22 members, measured 5 % slower at T47 and the
//   same at T63; at T30 a tile of 8, two waves, 1.7 % slower: PERF.md.)
// * The row's tables (the eleven (mx, nx) tables, gradx and the implicit
//   inverses xj of the row: kx*kx*nx values, 8 KB in float) are laid out by
//   m row on the host (ops/glue_kernels.py::build_update_tables), so a
//   block copies one contiguous slice into shared memory once and reuses it
//   for every member of its tile.
// * The 4 + 2*ntr flux spectra whose n-1 / n+1 neighbours and other pair
//   part a point reads come into shared memory with cp.async, so that each
//   element is fetched from device memory once, through a ring of slots per
//   lane (Shape<T>): in float a whole member per slot, double-buffered, so
//   the next member loads while this one computes; in double, where a whole
//   member of four lanes would take 216 KB and one block per SM, two levels
//   per slot in a ring of three. The spectra and state fields that a point
//   reads only at itself are loaded directly.
// * Order: with a whole member staged, the temperature and divergence
//   tendencies of every level, the implicit correction and the leapfrog of
//   ps, div and T, then vorticity and the tracers (the order of the first
//   design, which lets the compiler issue a phase's loads together); with a
//   chunk of levels staged, everything that reads that chunk's spectra
//   (vorticity, tracers, tendencies), then the correction. Each output's
//   arithmetic is the same in both.
// * Addresses: each field's base for a (member, m) row is formed from its
//   member and m strides (64-bit); the offsets inside a row are 32-bit (the
//   wrapper refuses a layout whose row does not fit). Every input keeps its
//   own five strides, so the stride-0 member axis of a freshly broadcast
//   state and the views the transform routes return are read in place.
// * A point's arithmetic depends on nothing but its own member's data and the
//   tables: no atomics, no sum across members or tiles, so a member's result
//   is bitwise the same whatever tile or lane it lands in, and for any B.
// * The kx levels of divdt, tdt, the mean divergence and the implicit
//   intermediates live in registers (KX a template parameter, every level
//   loop unrolled), at most 128 a thread so that two blocks fit an SM. The
//   per-level tables and the 8x8 level matrices ride in the argument struct
//   in the model's scalar type. Compiled with -fmad=false and written in the
//   plain version's order of operations, so that the only differences from
//   it are the sums of the level contractions (the plain version hands them
//   to einsum).
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3, power limit 700 W, B =
// 128; the first design's times from the same runs): T30L8 float 0.133 ms
// (0.188), 49 % of the byte bound; double 0.201 ms (0.234), 65 %; T30L5
// double 0.128 ms (0.146), 64 %; at B = 1 0.014 / 0.022 ms. 128 registers,
// 16 warps per SM, no spill, in every instantiation. A float member tile of
// 8 or 16 took the same time at T30, 32 or more left SMs idle (the fixed
// tile set to each). Whole members staged in float take 26 % less time
// than a member streamed four levels at a time (0.178 ms); in double the
// two-level ring takes 29 % less than whole members, one 256-thread block
// per SM (0.284 ms). At T47 / T63 (kernel_time in turns with the fixed
// tile of 16, float, B = 128): the plan's two waves 0.370-0.376 /
// 0.673-0.715 ms against 0.464 / 0.877-0.878, 38-42 % of the byte bound;
// one wave of 26 / 22 members 0.40 / 0.67-0.68. Into the state it reads
// ("in place") it takes 19-31 % longer at T47 / T63 (0.485-0.487 /
// 0.831-0.893 ms), so the graphs keep their two pair sets.
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
constexpr int kNumRowTables = 11;
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use
constexpr int kSmemPerSm = 233472; // bytes of shared memory of an SM
constexpr int kRegsPerSm = 65536;  // registers of an SM
constexpr int kTile = 16;          // the first design's member tile, the plan's target

// The state inputs, after the 6 + 3*ntr flux spectra.
enum StateInput {
  kPsdt, kVor0, kVor1, kDiv0, kDiv1, kT0, kT1, kPs0, kPs1, kTrf0, kTrf1,
  kPhi, kTcorh, kQcorh
};
// The (mx, nx) tables of a row, in the order of the row layout; then gradx,
// then the implicit inverses (kx, kx, nx).
enum Table {
  kEl2, kTrfilt, kDmp, kDmpd, kDmps, kDmp1, kDmp1d, kDmp1s, kElz, kVddym,
  kVddyp
};

// A field: its member and m strides (64-bit), its pair-part, level and n
// strides (32-bit: the offsets inside one (member, m) row).
struct Field {
  const void* p;
  long long sb, sm;
  int sc, sk, sn;
};

// Everything a launch reads besides the fields. The tables and scalars are
// held in the model's scalar type T (the caller's values are already rounded
// to it), so that the kernel reads them as operands from the constant bank.
template <typename T>
struct Args {
  Field in[kMaxInputs];
  const void* rows;  // (mx, row_len) per-row tables
  void* out[10];     // ps, vor, div, t, trf at the two time levels, dense
  T dhs[kMaxLevels], dhsr[kMaxLevels], tref[kMaxLevels],
      tref3[kMaxLevels];                                      // column tables
  T im_tref[kMaxLevels], tref2[kMaxLevels], dhsx[kMaxLevels];  // implicit
  T tcorv[kMaxLevels], qcorv[kMaxLevels];                     // diffusion
  T xd[kMaxLevels][kMaxLevels], xc[kMaxLevels][kMaxLevels];
  T dt, w1, w2, sdrag, rgas;  // w1 = wil*eps, w2 = (1-wil)*eps
  long long nmem;
  long long tile;  // members a block
  int j1, truncate, ntr, mx, nx;
  int pslots;    // threads of one member lane: 2*nx rounded up to a warp
  int row_len;   // values of one row of `rows`
};

__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char smem_[];
  return smem_;
}

// One element copied from device memory to shared memory without passing
// through registers; completed by copy_wait.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
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

// Barrier of one member lane: named barrier `id` (1 + lane) over its
// `count` threads, so that the lanes of a block do not wait for each other.
__device__ __forceinline__ void lane_sync(int id, int count) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
#else
  __syncthreads();
#endif
}

template <typename T>
__device__ __forceinline__ const T* row_base(const Field& f, long long b, int m) {
  return static_cast<const T*>(f.p) + (b * f.sb + m * f.sm);
}

// Launch shape per scalar type (measured on an H100, see the note above):
// at most `threads` threads a block (G member lanes of a row's points),
// `min_blocks` blocks resident per SM (so at most 128 registers); a lane's
// staged spectra pass through a ring of `ring` slots of `chunk` levels each,
// ring - 1 chunks in flight ahead of the one computed. Float stages a whole
// member (chunk >= kx) and double-buffers it; double, whose whole member
// would take 216 KB for four lanes, stages two levels at a time in a ring
// of three.
template <typename T> struct Shape {
  static constexpr int chunk = 8, ring = 2, threads = 256, min_blocks = 2;
};
template <> struct Shape<double> {
  static constexpr int chunk = 2, ring = 3, threads = 256, min_blocks = 2;
};
// Levels of a chunk at KX levels: Shape<T>::chunk, at most KX.
template <typename T, int KX>
struct Chunk {
  static constexpr int levels = Shape<T>::chunk < KX ? Shape<T>::chunk : KX;
};

// The flux combination (tendencies.f90:244-268) at one point from the
// staged spectra of one level (lv: spectrum i, part, n at
// (i * LC * 2 + part) * nx + n): the n-1 / n+1 neighbours with zero inflow
// and the zonal derivative, a swap of the two pair parts with a sign,
// dropped on the last n row.
template <typename T, int LC>
struct Level {
  const T* lv;
  int nx, c, n;
  T ym, yp, gx;
  __device__ T spec(int i, int part, int nn) const {
    return lv[(i * LC * 2 + part) * nx + nn];
  }
  __device__ T dn(int i) const { return n > 0 ? spec(i, c, n - 1) : T(0); }
  __device__ T up(int i) const { return n < nx - 1 ? spec(i, c, n + 1) : T(0); }
  __device__ T zonal(int i) const {   // (i * gradx) * spec, part c
    if (n == nx - 1) return T(0);
    const T x = spec(i, 1 - c, n);
    return c == 0 ? -(gx * x) : gx * x;
  }
  __device__ T divm(int iu, int iv) const {
    return (-(ym * dn(iv)) + yp * up(iv)) + zonal(iu);
  }
  __device__ T vorm(int iu, int iv) const {
    return (ym * dn(iu) - yp * up(iu)) + zonal(iv);
  }
};

template <typename T, int KX>
__global__ void __launch_bounds__(Shape<T>::threads, Shape<T>::min_blocks)
spectral_update_kernel(const __grid_constant__ Args<T> a) {
  constexpr int kRing = Shape<T>::ring;
  constexpr int kAhead = kRing - 1;
  constexpr int LC = Chunk<T, KX>::levels;       // levels of a chunk
  constexpr int NCH = (KX + LC - 1) / LC;         // chunks of a member
  const int mx = a.mx, nx = a.nx, ntr = a.ntr;
  const int m = blockIdx.x;
  const int P = a.pslots;
  const int G = blockDim.x / P;            // member lanes
  const int g = threadIdx.x / P;
  const int p = threadIdx.x - g * P;
  const bool point = p < 2 * nx;
  const int c = point ? p / nx : 0;
  const int n = point ? p - c * nx : 0;
  const int mn = m * nx + n;
  const int nstaged = 4 + 2 * ntr;          // spectra read at n-1, n+1 and 1-c
  const int base = 4 + 2 * ntr;             // ke, then ttend, then the tracers
  const Field* st = a.in + 6 + 3 * ntr;     // the state inputs
  const int slot_len = nstaged * LC * 2 * nx;   // one chunk of a lane's spectra

  T* const rows = reinterpret_cast<T*>(dyn_smem());
  T* const ring = rows + a.row_len;   // [slot][lane][spectrum][part][n]
  const long long first = static_cast<long long>(blockIdx.y) * a.tile;
  const long long last = min(first + a.tile, a.nmem);
  const int iters = static_cast<int>((last - first + G - 1) / G);
  const int items = iters * NCH;            // (member, chunk) items of a lane

  // Copy item q (the lane's member q / NCH, chunk q % NCH) into slot
  // q % kRing, as one commit group (empty past the last item).
  auto issue = [&](int q) {
    const long long b = first + static_cast<long long>(q / NCH) * G + g;
    if (q < items && point && b < last) {
      const int k0 = (q % NCH) * LC;
      T* dst = ring + ((q % kRing) * G + g) * slot_len + c * nx + n;
      for (int i = 0; i < nstaged; ++i) {
        const Field& f = a.in[i];
        const T* src = row_base<T>(f, b, m) + (c * f.sc + n * f.sn);
#pragma unroll
        for (int kk = 0; kk < LC; ++kk)
          if (k0 + kk < KX)
            copy_async(dst + (i * LC + kk) * 2 * nx, src + (k0 + kk) * f.sk);
      }
    }
    copy_commit();
  };

  // The row's tables join the first item's group.
  {
    const T* src = static_cast<const T*>(a.rows) + static_cast<long long>(m) * a.row_len;
    for (int e = threadIdx.x; e < a.row_len; e += blockDim.x) copy_async(rows + e, src + e);
  }
  for (int q = 0; q < kAhead; ++q) issue(q);

  const T dt = a.dt, w1 = a.w1, w2 = a.w2, sdrag = a.sdrag, rgas = a.rgas;
  const bool drag = m == 0;   // the stratospheric drag acts on level 0, m = 0
  const long long plane = static_cast<long long>(mx) * nx;
  auto tab = [&](int t) { return rows[t * nx + n]; };
  // Leapfrog + Robert-Williams filter; returns the two new time levels.
  auto leapfrog = [&](T f0, T f1, T fdt, T& g1, T& g2) {
    if (a.truncate) fdt = fdt * tab(kTrfilt);
    const T fj = a.j1 == 1 ? f0 : f1;
    const T fnew = f0 + dt * fdt;
    g1 = fj + w1 * ((f0 - T(2) * fj) + fnew);
    g2 = fnew - w2 * ((g1 - T(2) * fj) + fnew);
  };

  for (int it = 0; it < iters; ++it) {
    const long long b = first + static_cast<long long>(it) * G + g;
    const bool live = point && b < last;
    // The fields' bases at this point of the member's row: each formed once
    // per member, read at 32-bit level offsets.
    auto at = [&](const Field& f) {
      return row_base<T>(f, b, m) + (c * f.sc + n * f.sn);
    };
    auto out_row = [&](int o, int nlev) {
      return static_cast<T*>(a.out[o]) + (b * 2 * nlev * plane + m * nx) +
             c * nlev * plane + n;
    };

    // --- the member's mean divergence and log-ps tendency (state only) ---
    T div0[KX];
    T dmeanc = 0, psdt = 0, ps0 = 0;
    if (live) {
      const Field& f = st[kDiv0];
      const T* q = at(f);
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        div0[k] = q[k * f.sk];
        dmeanc = dmeanc + a.dhs[k] * div0[k];
      }
      psdt = *at(st[kPsdt]) - dmeanc;
      if (m == 0 && n == 0) psdt = 0;
      ps0 = *at(st[kPs0]);
    }
    // sigma-dot and the vertical advection term, built level by level in
    // the order of the plain version's sums.
    T run = 0, sig_k = 0, dumk_k = 0;
    T tdt[KX], divdt[KX];

    // The staged spectra of level k: lv points at its chunk slot and level.
    auto level = [&](int k) {
      const int q = it * NCH + k / LC;
      return ring + ((q % kRing) * G + g) * slot_len + (k % LC) * 2 * nx;
    };
    // Wait for chunk q, then refill the slot read one chunk ago.
    auto next_chunk = [&](int q) {
      copy_wait<kAhead - 1>();
      // Chunk q is in and the slot refilled next was read, for the lane;
      // the first time, the row's tables all lanes copied, for the block.
      if (q == 0)
        __syncthreads();
      else
        lane_sync(1 + g, P);
      issue(q + kAhead);
    };
    // The flux combination from the staged spectra of level k.
    auto flux = [&](int k) {
      return Level<T, Chunk<T, KX>::levels>{level(k), nx, c, n, tab(kVddym),
                                            tab(kVddyp), rows[kNumRowTables * nx]};
    };
    T g1, g2;

    // Temperature and divergence tendencies at level k.
    auto tendencies = [&](int k) {
      const auto comb = flux(k);
      T sig_k1 = 0, dumk_k1 = 0;
      if (k < KX - 1) {
        run = run + a.dhs[k] * (div0[k] - dmeanc);
        sig_k1 = -run;
        dumk_k1 = sig_k1 * (a.tref[k + 1] - a.tref[k]);
      }
      const Field& ftt = a.in[base + 1];
      const Field& fke = a.in[base];
      const Field& fphi = st[kPhi];
      const T td = comb.divm(2, 3) + at(ftt)[k * ftt.sk];
      tdt[k] = ((td - (dumk_k1 + dumk_k) * a.dhsr[k]) +
                a.tref3[k] * (sig_k1 + sig_k)) -
               a.tref2[k] * dmeanc;
      T dd = comb.divm(0, 1);
      dd = dd - (-at(fke)[k * fke.sk]) * tab(kEl2);
      const T ph = at(fphi)[k * fphi.sk] + (rgas * a.tref[k]) * ps0;
      divdt[k] = dd - (-ph) * tab(kEl2);
      sig_k = sig_k1;
      dumk_k = dumk_k1;
    };

    // Vorticity and the tracers at level k: no level coupling.
    auto streamed = [&](int k) {
      const auto comb = flux(k);
      const T dmp = tab(kDmp), dmps = tab(kDmps);
      const T dmp1 = tab(kDmp1), dmp1s = tab(kDmp1s);
      {
        const Field& f0 = st[kVor0];
        const Field& f1 = st[kVor1];
        const T v0 = at(f0)[k * f0.sk];
        T vd = comb.vorm(0, 1);
        vd = (vd - dmp * v0) * dmp1;
        if (k == 0 && drag) vd = vd - sdrag * v0;
        vd = (vd - dmps * v0) * dmp1s;
        leapfrog(v0, at(f1)[k * f1.sk], vd, g1, g2);
        out_row(2, KX)[k * plane] = g1;
        out_row(3, KX)[k * plane] = g2;
      }
      // Humidity with its orographic correction, the others like vorticity.
      const Field& f0 = st[kTrf0];
      const Field& f1 = st[kTrf1];
      for (int itr = 0; itr < ntr; ++itr) {
        const int l = itr * KX + k;
        const Field& ft = a.in[base + 2 + itr];
        T trd = comb.divm(4 + 2 * itr, 5 + 2 * itr) + at(ft)[k * ft.sk];
        const T tr0 = at(f0)[l * f0.sk];
        if (itr == 0) {
          const T q0 = tr0 + *at(st[kQcorh]) * a.qcorv[k];
          trd = (trd - tab(kDmpd) * q0) * tab(kDmp1d);
        } else {
          trd = (trd - dmp * tr0) * dmp1;
        }
        leapfrog(tr0, at(f1)[l * f1.sk], trd, g1, g2);
        out_row(8, ntr * KX)[l * plane] = g1;
        out_row(9, ntr * KX)[l * plane] = g2;
      }
    };

    // The semi-implicit correction and the leapfrog of ps, div and T.
    auto finish = [&]() {
      const T elz = tab(kElz);
      const T* xj = rows + kNumRowTables * nx + 1 + n;   // (k, l) at (k*KX + l)*nx
      T y[KX];
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        T s = 0;
#pragma unroll
        for (int l = 0; l < KX; ++l) s = s + a.xd[k][l] * tdt[l];
        y[k] = divdt[k] + elz * (s + (rgas * a.im_tref[k]) * psdt);
      }
      T sdiv = 0;
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        T s = 0;
#pragma unroll
        for (int l = 0; l < KX; ++l) s = s + xj[(k * KX + l) * nx] * y[l];
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

      leapfrog(ps0, *at(st[kPs1]), psdt, g1, g2);
      {
        const long long o = (b * 2 + c) * plane + mn;
        static_cast<T*>(a.out[0])[o] = g1;
        static_cast<T*>(a.out[1])[o] = g2;
      }
      const T dmp = tab(kDmp), dmpd = tab(kDmpd), dmps = tab(kDmps);
      const T dmp1 = tab(kDmp1), dmp1d = tab(kDmp1d), dmp1s = tab(kDmp1s);
      const T tcorh = *at(st[kTcorh]);
      const Field& fdiv1 = st[kDiv1];
      const Field& ft0 = st[kT0];
      const Field& ft1 = st[kT1];
      const T* pdiv1 = at(fdiv1);
      const T* pt0 = at(ft0);
      const T* pt1 = at(ft1);
      T* od0 = out_row(4, KX);
      T* od1 = out_row(5, KX);
      T* ot0 = out_row(6, KX);
      T* ot1 = out_row(7, KX);
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        T dd = (divdt[k] - dmpd * div0[k]) * dmp1d;
        if (k == 0 && drag) dd = dd - sdrag * div0[0];
        dd = (dd - dmps * div0[k]) * dmp1s;
        leapfrog(div0[k], pdiv1[k * fdiv1.sk], dd, g1, g2);
        od0[k * plane] = g1;
        od1[k * plane] = g2;

        const T t0 = pt0[k * ft0.sk];
        const T tcor = t0 + tcorh * a.tcorv[k];
        T td = (tdt[k] - dmp * tcor) * dmp1;
        td = (td - dmps * tcor) * dmp1s;
        leapfrog(t0, pt1[k * ft1.sk], td, g1, g2);
        ot0[k * plane] = g1;
        ot1[k * plane] = g2;
      }
    };

    if constexpr (LC == KX) {
      // The whole member is staged at once: the tendencies of every level,
      // the implicit correction, then vorticity and the tracers.
      next_chunk(it);
      if (!live) continue;
#pragma unroll
      for (int k = 0; k < KX; ++k) tendencies(k);
      finish();
#pragma unroll
      for (int k = 0; k < KX; ++k) streamed(k);
    } else {
      // Chunks of levels: everything that reads a level's spectra while its
      // chunk is staged, then the implicit correction.
#pragma unroll
      for (int k = 0; k < KX; ++k) {
        if (k % LC == 0) next_chunk(it * NCH + k / LC);
        if (!live) continue;
        streamed(k);
        tendencies(k);
      }
      if (!live) continue;
      finish();
    }
  }
  copy_wait<0>();
}

// Shared memory of a launch with G lanes: the row tables and the ring.
template <typename T>
long long smem_bytes(int G, int row_len, int slot_len) {
  return (static_cast<long long>(row_len) + static_cast<long long>(Shape<T>::ring) * G * slot_len) *
         static_cast<long long>(sizeof(T));
}

// A launch plan: G member lanes of `pslots` threads a block, its dynamic
// shared memory, blocks an SM (by 16 warps of 128 registers and by the
// shared memory), the tile (members a block) and the grid (mx, tiles).
struct LaunchPlan {
  int lanes, pslots, threads, blocks_per_sm, row_len;
  long long smem, tile, tiles;
};

// The plan for nmem members (at least 1) of ntr tracers at (mx, nx) on a
// card of `sms` SMs (modelled by ops/glue_kernels.py::update_launch_plan).
// Returns 0, or -5 if even one lane does not fit.
template <typename T, int KX>
int plan(int ntr, int nx, int mx, long long nmem, int sms, LaunchPlan* p) {
  p->pslots = (2 * nx + 31) / 32 * 32;
  if (p->pslots > Shape<T>::threads) return -5;
  p->row_len = kNumRowTables * nx + 1 + KX * KX * nx;
  const int slot_len = (4 + 2 * ntr) * Chunk<T, KX>::levels * 2 * nx;
  // As many member lanes as fit the block's threads and the shared memory.
  int G = Shape<T>::threads / p->pslots;
  while (G > 1 && smem_bytes<T>(G, p->row_len, slot_len) > kMaxSmem) --G;
  p->smem = smem_bytes<T>(G, p->row_len, slot_len);
  if (p->smem > kMaxSmem) return -5;
  p->lanes = G;
  p->threads = G * p->pslots;
  int bps = (kRegsPerSm / 128 / 32) / (p->threads / 32);
  const long long by_smem = kSmemPerSm / (p->smem + 1024);
  if (by_smem < bps) bps = static_cast<int>(by_smem);
  p->blocks_per_sm = bps;
  // A tile of kTile members would make `waves` waves of the blocks the
  // card holds at once, rounded up; each m row's share of that many waves
  // of blocks splits its member groups equally.
  const long long slots = static_cast<long long>(sms) * bps;
  const long long waves = (mx * ((nmem + kTile - 1) / kTile) + slots - 1) / slots;
  long long per_row = waves * slots / mx;
  if (per_row < 1) per_row = 1;
  const long long groups = (nmem + G - 1) / G;
  p->tile = (groups + per_row - 1) / per_row * G;
  p->tiles = (nmem + p->tile - 1) / p->tile;
  return 0;
}

// Allow the dynamic shared memory (the largest asked for so far) and ask
// for the largest shared-memory carveout.
template <typename T, int KX>
int prepare(long long smem) {
  static long long allowed = 0;
  if (smem <= allowed) return 0;
  int rc = static_cast<int>(cudaFuncSetAttribute(
      spectral_update_kernel<T, KX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        spectral_update_kernel<T, KX>, cudaFuncAttributePreferredSharedMemoryCarveout, 100));
  if (rc == 0) allowed = smem;
  return rc;
}

// SMs of the current device, asked once per device.
int device_sms(int* sms) {
  static int cached_device = -1, cached = 0;
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev != cached_device) {
    rc = static_cast<int>(cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev));
    if (rc != 0) return rc;
    cached_device = dev;
  }
  *sms = cached;
  return 0;
}

template <typename T, int KX>
int launch(Args<T> a, cudaStream_t stream) {
  if (a.nmem <= 0) return 0;
  int sms = 0;
  int rc = device_sms(&sms);
  if (rc != 0) return rc;
  LaunchPlan p;
  rc = plan<T, KX>(a.ntr, a.nx, a.mx, a.nmem, sms, &p);
  if (rc != 0) return rc;
  if (p.tiles > 65535) return -4;
  a.pslots = p.pslots;
  a.row_len = p.row_len;
  a.tile = p.tile;
  rc = prepare<T, KX>(p.smem);
  if (rc != 0) return rc;
  dim3 grid(static_cast<unsigned>(a.mx), static_cast<unsigned>(p.tiles));
  spectral_update_kernel<T, KX><<<grid, p.threads, static_cast<size_t>(p.smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out: resident blocks per SM, threads a block, dynamic shared memory a
// block, registers a thread, local memory a thread, as the runtime gives them,
// then the plan's member lanes and blocks an SM.
template <typename T, int KX>
int occupancy_of(int ntr, int nx, int* out) {
  LaunchPlan p;
  int rc = plan<T, KX>(ntr, nx, 1, 1, 1, &p);
  if (rc == 0) rc = prepare<T, KX>(p.smem);
  cudaFuncAttributes attr = {};
  if (rc == 0)
    rc = static_cast<int>(cudaFuncGetAttributes(&attr, spectral_update_kernel<T, KX>));
  int blocks = 0;
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, spectral_update_kernel<T, KX>, p.threads, static_cast<size_t>(p.smem)));
  out[0] = blocks; out[1] = p.threads; out[2] = static_cast<int>(p.smem);
  out[3] = attr.numRegs; out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = p.lanes; out[6] = p.blocks_per_sm;
  return rc;
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
//          `strides` (member, part, level, m, n; level 0 for the planes). The
//          part, level and n strides must be offsets that fit 32 bits.
// rows:    (mx, 11*nx + 1 + kx*kx*nx) per-row tables, contiguous: el2,
//          trfilt, dmp, dmpd, dmps, dmp1, dmp1d, dmp1s, elz, vddym, vddyp
//          (nx each), gradx, the implicit inverses xj (kx, kx, nx).
// out:     ps0, ps1 (B, 2, mx, nx), vor0, vor1, div0, div1, t0, t1
//          (B, 2, kx, mx, nx), trf0, trf1 (B, 2, ntr*kx, mx, nx). Dense.
// levels:  9*kx + 2*kx*kx values of the scalar type: dhs, dhsr, tref, tref3
//          (the column tables), tref, tref2, dhsx (the implicit tables of this
//          dt), tcorv, qcorv, then xd and xc row by row.
// elem_size: 4 (float) or 8 (double).
extern "C" int pyspeedy_spectral_update(
    int elem_size, int kx, int ntr, long long nmem, int mx, int nx,
    const void* const* in, const long long* strides, const void* rows,
    void* const* out, const void* levels, int j1, int truncate, double dt,
    double w1, double w2, double sdrag, double rgas, void* stream) {
  if (kx < 1 || kx > kMaxLevels) return -2;
  if (ntr < 1 || ntr > kMaxTracers) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto a) {
    using T = decltype(a.dt);
    const int nin = 6 + 3 * ntr + kNumState;
    for (int i = 0; i < nin; ++i) {
      const long long* sd = strides + 5 * i;
      a.in[i].p = in[i];
      a.in[i].sb = sd[0];
      a.in[i].sc = static_cast<int>(sd[1]);
      a.in[i].sk = static_cast<int>(sd[2]);
      a.in[i].sm = sd[3];
      a.in[i].sn = static_cast<int>(sd[4]);
    }
    a.rows = rows;
    for (int o = 0; o < 10; ++o) a.out[o] = out[o];
    const T* lv = static_cast<const T*>(levels);
    for (int k = 0; k < kx; ++k) {
      a.dhs[k] = lv[0 * kx + k];
      a.dhsr[k] = lv[1 * kx + k];
      a.tref[k] = lv[2 * kx + k];
      a.tref3[k] = lv[3 * kx + k];
      a.im_tref[k] = lv[4 * kx + k];
      a.tref2[k] = lv[5 * kx + k];
      a.dhsx[k] = lv[6 * kx + k];
      a.tcorv[k] = lv[7 * kx + k];
      a.qcorv[k] = lv[8 * kx + k];
      for (int l = 0; l < kx; ++l) {
        a.xd[k][l] = lv[9 * kx + k * kx + l];
        a.xc[k][l] = lv[9 * kx + kx * kx + k * kx + l];
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

// The occupancy of one instantiation (see occupancy_of): out holds 7 ints.
extern "C" int pyspeedy_spectral_update_occupancy(int elem_size, int kx, int ntr, int nx,
                                                   int* out) {
  auto by_kx = [&](auto zero) -> int {
    using T = decltype(zero);
    switch (kx) {
      case 5: return occupancy_of<T, 5>(ntr, nx, out);
      case 7: return occupancy_of<T, 7>(ntr, nx, out);
      case 8: return occupancy_of<T, 8>(ntr, nx, out);
      default: return -2;
    }
  };
  if (elem_size == 4) return by_kx(0.0f);
  if (elem_size == 8) return by_kx(0.0);
  return -1;
}

// The launch plan for nmem members (at least 1) of ntr tracers at (mx, nx)
// on a card of `sms` SMs (see plan): out holds 7 values, member lanes a
// block, threads a block, dynamic shared memory a block (bytes), blocks an
// SM, members a block (the tile), member tiles, blocks. Needs no device.
extern "C" int pyspeedy_spectral_update_plan(int elem_size, int kx, int ntr, int nx, int mx,
                                             long long nmem, int sms, long long* out) {
  if (nmem < 1 || sms < 1 || mx < 1 || nx < 1) return -1;
  LaunchPlan p;
  auto by_kx = [&](auto zero) -> int {
    using T = decltype(zero);
    switch (kx) {
      case 5: return plan<T, 5>(ntr, nx, mx, nmem, sms, &p);
      case 7: return plan<T, 7>(ntr, nx, mx, nmem, sms, &p);
      case 8: return plan<T, 8>(ntr, nx, mx, nmem, sms, &p);
      default: return -2;
    }
  };
  const int rc = elem_size == 4 ? by_kx(0.0f) : elem_size == 8 ? by_kx(0.0) : -1;
  if (rc != 0) return rc;
  const long long v[] = {p.lanes, p.threads, p.smem, p.blocks_per_sm, p.tile, p.tiles,
                         p.tiles * mx};
  for (int q = 0; q < 7; ++q) out[q] = v[q];
  return 0;
}
