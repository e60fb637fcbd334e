// Fused spectral transforms for NVIDIA Hopper (sm_90a): the zonal DFT and the
// Legendre transform of a group of fields in one launch, the Fourier
// intermediate held in shared memory.
//
// Replaces three Pallas experiments of the JAX package:
//   tools/exp_fused_transform.py:65  fused_grid2spec  (pallas_call at :102)
//   tools/exp_fused_transform.py:121 fused_spec2grid  (pallas_call at :143)
//   tools/exp_fused_probe.py:49      probe            (pallas_call at :57)
// The plain PyTorch versions (the dense matmul chain) and the wrappers are in
// pyspeedy_tpu_torch/ops/transform_kernels.py.
//
// Computes, for every field row (one (il, ix) grid or one spectral pair):
//   direct   F[c, j, m] = sum_i g[j, i] * dft_fwd[c, i, m]
//            S[c, m, n] = sum_j F[c, j, m] * leg_dir[j, m, n]
//   inverse  F[c, j, m] = sum_n leg_inv[j, m, n] * p[c, m, n]
//            g[j, i]    = (sum_c sum_m F[c, j, m] * dft_inv[c, m, i]) * scale[j]
// c indexes the (real, imaginary) parts. The inverse never reads the
// imaginary part of m = 0 (the reference's "discard" rule). Element types:
// float, double, and the 2-byte operand mode of the direct transform (grid,
// DFT table and Legendre table in bfloat16, the Fourier intermediate rounded
// to bfloat16) with float or double sums and result: the JAX package's
// bfloat16 dense chain (ops/spectral.py::grid2spec_p) at precision f32 or
// f64, whose Legendre product accumulates in the tables' type.
//
// What bounds the transform on an H100 (3.35 TB/s): the bytes. A T30 row
// (il=48, ix=96, mx=31, nx=32) moves 18,432 B of grid and 7,936 B of spectral
// pair in float: 7.9 ns per row, 0.0081 ms for 1,024 rows (0.0162 ms in
// double, 0.0053 ms with 2-byte operands). The folded arithmetic below is
// 0.30 GFLOP at 1,024 rows, 0.0045 ms at the 67 TFLOP/s float peak, so the
// kernel can only approach the byte figure if its operations are cheap to
// issue. The first version of these kernels (one block of 256 threads per
// row) ran at 13-17 % of the dense operation figure; they re-read the tables from L2 for every row,
// issued about one shared-memory load per multiply-add, did 3.8 times the
// Legendre operations the tables need and twice the DFT operations, copied
// rows with plain loads and were launched once per field (22 launches a step).
//
// Design, point by point:
//  1. Persistent blocks (as many as fit on the card, at most one per row)
//     walk over the rows of a whole group of fields; each block copies the
//     tables into shared memory once, with cp.async, from one flat array that
//     ops/spectral.py::_fold_tables lays out in the order of the shared
//     memory: the DFT table folded to half a period (12 KB in float), the
//     Legendre table folded to the 24 northern latitudes and cut to the 527
//     (m, n) pairs with m + n <= 31 (50.6 KB in float, 101 KB in double).
//     The tables are read once per block, not once per row.
//  2. Register tiles: in the DFT stages a thread keeps 6 latitudes x 4 (or 2)
//     wavenumbers (direct) or 6 latitudes x 2 longitudes of both parities
//     (inverse) in registers and reads its operands as 8- and 16-byte
//     vectors: 4 shared-memory loads feed 24 multiply-adds (direct, float),
//     8 feed 24 (inverse), where the first version issued about one load per
//     multiply-add; the loads of a warp are broadcasts or fall on distinct
//     banks. The direct Legendre sums run as two independent chains.
//  3. The structure of the tables. Hemispheric parity holds bitwise,
//     L[il-1-j, m, n] = (-1)^n L[j, m, n], and the table is exactly zero
//     where m + n > 31: the direct Legendre stage sums over 24 latitudes of
//     F[j] + F[il-1-j] (even n) or F[j] - F[il-1-j] (odd n) over the 527
//     pairs and stores 0 elsewhere; the inverse forms even and odd partial
//     sums E, O and writes F[j] = E + O, F[il-1-j] = E - O. The DFT tables
//     have half-period symmetry, D[i + ix/2] = (-1)^m D[i], to 2.6e-16 (direct)
//     and 5e-14 (inverse) absolute, not bitwise: both DFT stages are folded
//     (the direct one sums g[i] +- g[i + ix/2] against the first half of the
//     table, the inverse one forms the even-m and odd-m partial sums and
//     writes g[i] = Pe + Po, g[i + ix/2] = Pe - Po). That halves the DFT
//     operations and changes the result by rounding only (chip_smoke.py
//     measures it against the plain chain; PERF.md has the figures).
//     tests/test_torch_transform_groups.py states both table facts, so a
//     table that broke them would fail there, not drift here.
//  4. The next row is copied into shared memory with cp.async (16-byte
//     chunks, L1 bypassed) while the current one is computed: the folded,
//     transposed grid (direct) or the Fourier coefficients (inverse) are the
//     second buffer of the ring, so the stage buffer is free once they are
//     written. Rows whose address is not 16-byte aligned are copied with
//     plain loads instead. Outputs are stored straight from the register
//     tiles, neighbouring threads on neighbouring addresses.
//  5./6. One launch takes a group of up to 16 fields (segments): each with
//     its pointers, member, pair and row strides, rows per member and, for
//     the inverse, its own 1/cos(lat) flag, in a __grid_constant__ argument
//     struct. A step's 22 transform launches become 3.
// Products on CUDA cores, not the tensor cores: in float the 1e-5 limit
// needs the 3xTF32 split (three tensor-core products and the operand split
// per element); in double the DMMA m8n8k4 shapes do not match a 6-latitude
// fold. After the folds the products are 0.30 GFLOP at 1,024 rows, below the
// bytes, so the design spends its effort on table reuse and load counts.
//
// Every output element is one fixed-order sum inside one block, with no
// atomics: results are deterministic, and a row's result does not depend on
// the rows or segments launched with it (a group equals its fields launched
// one by one, bitwise).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, 1,024 rows:
// 0.0324-0.0327 ms direct and 0.0269-0.0275 ms inverse in float (25 % and
// 30 % of the byte bound; the first version 0.086 and 0.069-0.081 ms),
// 0.058 and 0.065 ms in double, 0.033 ms with 2-byte operands; the step's
// groups at 128 members (10 direct fields, 7 and 5 inverse) 0.274, 0.155 and
// 0.104 ms. Against the plain chain: 3.2e-7 of the largest value in float,
// 6.6e-15 in double (the first version 2.8e-7 and 1e-15: the folds, above
// all the inverse DFT table's 5e-14 asymmetry, add about 5e-15), 8.6e-4 with
// 2-byte operands. What holds the kernels back from the bytes: the cheap
// stages (the folds, the Legendre sums, the zero stores) issue about as many
// instructions as the DFT, with 8 (direct) or 12 (inverse) warps per SM
// between four barriers a row; registers 80 (direct) and 55 / 86 (inverse,
// float / double), no spills.
//
// The probes (tools/exp_fused_probe.py) are the direct kernel stopped after
// one stage: grid2spec_fold_kernel<.., STOP> with STOP = 0, 1, 2 (STOP = 3 is
// the whole transform), the same persistent blocks, folded tables, register
// tiles and cp.async ring, one real part stored: p0 the DFT stage's real part
// stored straight from the register tiles as (N*il, mx); p1 the same values
// taken through the shared-memory intermediate and stored flat as
// (N, il*mx); p2 the real part of the whole transform as (N, mx*nx), zeros
// where m + n > 31 (the Legendre sums of the imaginary part are not formed).
// p3 (split_probe_kernel) is the inverse-side split, (N, il*ix)[:, :il*mx]
// viewed as (N*il, mx), times 2: a grid-stride pass of 16-byte vectors where
// both pointers are 16-byte aligned (a row of either is a multiple of 16
// bytes at T30), of single elements otherwise.
//
// Interface: plain C, loaded with ctypes; one entry point with a `kind`
// argument. The launch goes to the stream it is given, allocates nothing and
// does not synchronise; the function returns cudaGetLastError() (0 on
// success) or a negative code for arguments the kernels were not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// Shapes: the transforms are built for T30, the one truncation whose dense
// route exists (the wrappers refuse others).
// ---------------------------------------------------------------------------
constexpr int kIL = 48, kIY = 24, kIX = 96, kIH = 48, kMX = 31, kNX = 32;
constexpr int kTri = 527;            // (m, n) pairs with m + n <= 31
constexpr int kPlane = kMX * kNX;    // one part of a spectral field
constexpr int kCols = 32;            // (part, m of one parity): 2 x 16
constexpr int kPitchA = kIL + 2;     // folded grid, transposed: even pitch
constexpr int kTable = 2 * kIH * kCols + kIY * kTri;  // either kernel's tables
constexpr int kMaxSeg = 16;
constexpr int kSegWords = 11;        // int64 words of one segment descriptor
constexpr int kTJ = 6;               // latitudes of a thread's register tile

// Start of row m of the (m, n) triangle, n = 0 .. nx-1-m.
__host__ __device__ constexpr int tri_offset(int m) {
  return kNX * m - m * (m - 1) / 2;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// A double through float, as the JAX package rounds a float64 to bfloat16.
__device__ __forceinline__ double round_bf16(double x) {
  return __bfloat162float(__float2bfloat16_rn(static_cast<float>(x)));
}

// One field of a group: its rows are numbered member-major, per_member rows
// to a member; strides in elements.
struct Segment {
  const void* in;
  void* out;
  long long first;        // first row of the segment in the group's numbering
  long long in_member, in_pair, in_row;
  long long out_member, out_pair, out_row;
  int per_member;
  int flag;               // inverse: 1 = scale by 1/cos(lat) at the store
  int aligned;            // 16-byte copies allowed (pointer, strides, row)
};

struct Group {
  Segment seg[kMaxSeg];
  int nseg;
  const void* tables;     // kTable values, in the order of the shared memory
  const void* scale;      // inverse: 1/cos(lat) (il,)
};

// N neighbouring values in one load (the address is aligned to the size).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};
template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

__device__ __forceinline__ int find_segment(const Group& g, long long r) {
  int s = 0;
  while (s + 1 < g.nseg && r >= g.seg[s + 1].first) ++s;
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy n elements (n * sizeof(E) a multiple of 16) into shared memory:
// cp.async in 16-byte chunks where the source is aligned, plain loads
// otherwise (then complete when the caller next synchronises the block).
template <int THREADS, typename E>
__device__ __forceinline__ void stage_copy(E* dst, const E* src, int n, bool aligned) {
  if (aligned) {
    const int chunks = n * static_cast<int>(sizeof(E)) / 16;
    auto* d = reinterpret_cast<unsigned char*>(dst);
    auto* s = reinterpret_cast<const unsigned char*>(src);
    for (int q = threadIdx.x; q < chunks; q += THREADS) cp_async16(d + 16 * q, s + 16 * q);
  } else {
    for (int q = threadIdx.x; q < n; q += THREADS) dst[q] = src[q];
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, T a, T b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<double>(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// ---------------------------------------------------------------------------
// Direct transform. T: working and output type; E: element type of the grid
// and both tables; BF16: round the Fourier intermediate to bfloat16.
// ---------------------------------------------------------------------------
template <typename T, typename E>
constexpr size_t direct_shared_bytes() {
  return sizeof(E) * kIL * kIX + sizeof(T) * (kTable + 2 * kIH * kPitchA + 2 * kIL * kMX);
}

// STOP < 3: a probe, the kernel stopped after a stage (see the header).
template <typename T, typename E, bool BF16, int THREADS, int STOP = 3>
__global__ void __launch_bounds__(THREADS)
grid2spec_fold_kernel(const __grid_constant__ Group g, long long total) {
  constexpr int TC = 512 / THREADS;        // wavenumber columns of a thread
  constexpr int NCB = kCols / TC;
  constexpr int HALF = THREADS / 2;        // threads of one parity
  static_assert(8 * NCB == HALF && 8 * kTJ == kIL, "register tile");
  constexpr int MAXP = (kTri + THREADS - 1) / THREADS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* stage = reinterpret_cast<E*>(smem_raw);                          // (il, ix) as read
  T* sD = reinterpret_cast<T*>(smem_raw + sizeof(E) * kIL * kIX);     // (2, ih, 32)
  T* sL = sD + 2 * kIH * kCols;                                       // (iy, 527)
  T* sA = sL + kIY * kTri;                                            // (2, ih, il+2)
  T* sF = sA + 2 * kIH * kPitchA;                                     // (2, il, mx)
  const int tid = threadIdx.x;

  long long r = blockIdx.x;
  auto issue = [&](long long row) {
    const Segment& s = g.seg[find_segment(g, row)];
    const long long lr = row - s.first;
    const long long b = lr / s.per_member, kk = lr - b * s.per_member;
    const E* src = static_cast<const E*>(s.in) + b * s.in_member + kk * s.in_row;
    stage_copy<THREADS>(stage, src, kIL * kIX, s.aligned != 0);
  };
  // The tables, once per block, with the first row: the half-period DFT
  // table (2 parities, ih, 32 columns: col = c * 16 + q for m = 2q + parity,
  // the odd parity's q = 15 zero), then the northern Legendre rows over the
  // triangle (iy, 527), as ops/spectral.py::_fold_tables lays them out.
  if (r < total) issue(r);
  stage_copy<THREADS>(sD, static_cast<const T*>(g.tables), kTable, true);
  cp_async_commit();
  int pm[MAXP], pn[MAXP];
#pragma unroll
  for (int q = 0; q < MAXP; ++q) {
    int p = tid + q * THREADS;
    pm[q] = -1;
    pn[q] = 0;
    if (p < kTri) {
      int m = 0;
      while (p >= kNX - m) { p -= kNX - m; ++m; }
      pm[q] = m;
      pn[q] = p;
    }
  }

  for (; r < total; r += gridDim.x) {
    const Segment& s = g.seg[find_segment(g, r)];
    const long long lr = r - s.first;
    const long long b = lr / s.per_member, kk = lr - b * s.per_member;
    cp_async_wait_all();
    __syncthreads();

    // Fold the row by half a period and transpose it:
    // sA[0][i][j] = g[j][i] + g[j][i+ih], sA[1][i][j] = g[j][i] - g[j][i+ih].
    for (int idx = tid; idx < kIL * kIH; idx += THREADS) {
      const int j = idx / kIH, i = idx - j * kIH;
      const T a = widen(stage[j * kIX + i]), c = widen(stage[j * kIX + i + kIH]);
      sA[i * kPitchA + j] = a + c;
      sA[(kIH + i) * kPitchA + j] = a - c;
    }
    __syncthreads();
    if (r + gridDim.x < total) issue(r + gridDim.x);
    cp_async_commit();

    // Zonal DFT on the folded row: even m from the sums, odd m from the
    // differences; a thread keeps kTJ latitudes x TC columns.
    T* out = static_cast<T*>(s.out) + b * s.out_member + kk * s.out_row;
    {
      const int par = tid / HALF, u = tid - par * HALF;
      const int jb = u / NCB, cb = u - jb * NCB;
      const T* a_base = sA + par * kIH * kPitchA + jb * kTJ;
      const T* b_base = sD + par * kIH * kCols + cb * TC;
      T acc[kTJ][TC];
#pragma unroll
      for (int jj = 0; jj < kTJ; ++jj)
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) acc[jj][cc] = T(0);
#pragma unroll 4
      for (int k = 0; k < kIH; ++k) {
        Vec<T, 2> a[kTJ / 2];
#pragma unroll
        for (int q = 0; q < kTJ / 2; ++q) a[q] = load_vec<T, 2>(a_base + k * kPitchA + 2 * q);
        const Vec<T, TC> bv = load_vec<T, TC>(b_base + k * kCols);
#pragma unroll
        for (int jj = 0; jj < kTJ; ++jj)
#pragma unroll
          for (int cc = 0; cc < TC; ++cc) acc[jj][cc] += a[jj / 2].v[jj % 2] * bv.v[cc];
      }
#pragma unroll
      for (int cc = 0; cc < TC; ++cc) {
        const int col = cb * TC + cc;
        const int c = col >> 4, m = 2 * (col & 15) + par;
        if (m >= kMX) continue;
#pragma unroll
        for (int jj = 0; jj < kTJ; ++jj) {
          T v = acc[jj][cc];
          if constexpr (BF16) v = round_bf16(v);
          if constexpr (STOP == 0) {
            if (c == 0) out[(jb * kTJ + jj) * kMX + m] = v;
          } else {
            sF[(c * kIL + jb * kTJ + jj) * kMX + m] = v;
          }
        }
      }
    }
    if constexpr (STOP == 0) continue;
    __syncthreads();
    if constexpr (STOP == 1) {
      for (int idx = tid; idx < kIL * kMX; idx += THREADS) out[idx] = sF[idx];
      continue;
    }

    // Hemispheric fold: F[j] <- F[j] + F[il-1-j], F[il-1-j] <- F[j] - F[il-1-j].
    for (int idx = tid; idx < 2 * kIY * kMX; idx += THREADS) {
      const int c = idx / (kIY * kMX);
      const int rem = idx - c * kIY * kMX;
      const int j = rem / kMX, m = rem - j * kMX;
      T* lo = sF + (c * kIL + j) * kMX + m;
      T* hi = sF + (c * kIL + kIL - 1 - j) * kMX + m;
      const T x = *lo, y = *hi;
      *lo = x + y;
      *hi = x - y;
    }
    __syncthreads();

    // Legendre analysis over the northern latitudes, the triangle only.
#pragma unroll
    for (int q = 0; q < MAXP; ++q) {
      const int m = pm[q];
      if (m < 0) continue;
      const int n = pn[q];
      const int p = tid + q * THREADS;
      // Row j holds F[j] + F[il-1-j], row il-1-j the difference.
      const T* f0 = sF + m + ((n & 1) ? (kIL - 1) * kMX : 0);
      const T* f1 = f0 + kIL * kMX;
      const int step = (n & 1) ? -kMX : kMX;
      T s0 = T(0), s1 = T(0), t0 = T(0), t1 = T(0);   // even and odd j
#pragma unroll 4
      for (int j = 0; j < kIY; j += 2) {
        const T l = sL[j * kTri + p], lo = sL[(j + 1) * kTri + p];
        s0 += l * f0[j * step];
        s1 += l * f1[j * step];
        t0 += lo * f0[(j + 1) * step];
        t1 += lo * f1[(j + 1) * step];
      }
      out[m * kNX + n] = s0 + t0;
      if constexpr (STOP == 3) out[s.out_pair + m * kNX + n] = s1 + t1;
    }
    for (int idx = tid; idx < kPlane; idx += THREADS) {
      const int m = idx / kNX, n = idx - m * kNX;
      if (m + n >= kNX) {
        out[idx] = T(0);
        if constexpr (STOP == 3) out[s.out_pair + idx] = T(0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Inverse transform.
// ---------------------------------------------------------------------------
template <typename T>
constexpr size_t inverse_shared_bytes() {
  return sizeof(T) * (2 * kPlane + kIY * kTri + 2 * kCols * kIH + 2 * kCols * kIL);
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
spec2grid_fold_kernel(const __grid_constant__ Group g, long long total) {
  constexpr int TI = 2;                   // longitudes of a thread (both halves)
  constexpr int NIB = kIH / TI;
  static_assert(8 * NIB == THREADS && 8 * kTJ == kIL, "register tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);    // (2, mx, nx) as read
  T* sL = stage + 2 * kPlane;                   // (iy, 527)
  T* sB = sL + kIY * kTri;                      // (2, 32, ih)
  T* sA = sB + 2 * kCols * kIH;                 // (2, 32, il) Fourier coefficients
  const int tid = threadIdx.x;

  long long r = blockIdx.x;
  auto issue = [&](long long row) {
    const Segment& s = g.seg[find_segment(g, row)];
    const long long lr = row - s.first;
    const long long b = lr / s.per_member, kk = lr - b * s.per_member;
    const T* src = static_cast<const T*>(s.in) + b * s.in_member + kk * s.in_row;
    stage_copy<THREADS>(stage, src, kPlane, s.aligned != 0);
    stage_copy<THREADS>(stage + kPlane, src + s.in_pair, kPlane, s.aligned != 0);
  };
  // The tables, once per block, with the first row: the northern Legendre
  // rows over the triangle (iy, 527), then the half-period DFT table (2
  // parities, 32 rows k = c * 16 + q for m = 2q + parity, ih).
  if (r < total) issue(r);
  stage_copy<THREADS>(sL, static_cast<const T*>(g.tables), kTable, true);
  cp_async_commit();
  const T* scale = static_cast<const T*>(g.scale);
  // Rows never written below stay zero: the odd parity's q = 15 and the
  // imaginary part of m = 0, which the transform ignores.
  for (int idx = tid; idx < 2 * kCols * kIL; idx += THREADS) sA[idx] = T(0);

  for (; r < total; r += gridDim.x) {
    const Segment& s = g.seg[find_segment(g, r)];
    const long long lr = r - s.first;
    const long long b = lr / s.per_member, kk = lr - b * s.per_member;
    cp_async_wait_all();
    __syncthreads();

    // Legendre synthesis, folded: item = (m, northern latitude j), j fastest.
    for (int it = tid; it < kMX * kIY; it += THREADS) {
      const int m = it / kIY, j = it - m * kIY;
      const T* l = sL + j * kTri + tri_offset(m);
      const T* p0 = stage + m * kNX;
      const T* p1 = p0 + kPlane;
      const int nn = kNX - m;
      T e0 = T(0), o0 = T(0), e1 = T(0), o1 = T(0);
      int n = 0;
      for (; n + 1 < nn; n += 2) {
        const T le = l[n], lo = l[n + 1];
        e0 += le * p0[n];
        e1 += le * p1[n];
        o0 += lo * p0[n + 1];
        o1 += lo * p1[n + 1];
      }
      if (n < nn) {
        const T le = l[n];
        e0 += le * p0[n];
        e1 += le * p1[n];
      }
      const int par = m & 1, q = m >> 1;
      T* a0 = sA + (par * kCols + q) * kIL;
      a0[j] = e0 + o0;
      a0[kIL - 1 - j] = e0 - o0;
      if (m != 0) {
        T* a1 = sA + (par * kCols + 16 + q) * kIL;
        a1[j] = e1 + o1;
        a1[kIL - 1 - j] = e1 - o1;
      }
    }
    __syncthreads();
    if (r + gridDim.x < total) issue(r + gridDim.x);
    cp_async_commit();

    // Inverse DFT, folded: Pe over even m, Po over odd m, for the first half
    // of the longitudes; g[i] = Pe + Po, g[i + ih] = Pe - Po.
    const int jb = tid / NIB, ib = tid - jb * NIB;
    T pe[kTJ][TI], po[kTJ][TI];
#pragma unroll
    for (int jj = 0; jj < kTJ; ++jj)
#pragma unroll
      for (int ii = 0; ii < TI; ++ii) pe[jj][ii] = po[jj][ii] = T(0);
    const T* ae_base = sA + jb * kTJ;
    const T* ao_base = sA + kCols * kIL + jb * kTJ;
    const T* be_base = sB + ib * TI;
    const T* bo_base = sB + kCols * kIH + ib * TI;
#pragma unroll 4
    for (int k = 0; k < kCols; ++k) {
      Vec<T, 2> ae[kTJ / 2], ao[kTJ / 2];
#pragma unroll
      for (int q = 0; q < kTJ / 2; ++q) {
        ae[q] = load_vec<T, 2>(ae_base + k * kIL + 2 * q);
        ao[q] = load_vec<T, 2>(ao_base + k * kIL + 2 * q);
      }
      const Vec<T, TI> be = load_vec<T, TI>(be_base + k * kIH);
      const Vec<T, TI> bo = load_vec<T, TI>(bo_base + k * kIH);
#pragma unroll
      for (int jj = 0; jj < kTJ; ++jj)
#pragma unroll
        for (int ii = 0; ii < TI; ++ii) {
          pe[jj][ii] += ae[jj / 2].v[jj % 2] * be.v[ii];
          po[jj][ii] += ao[jj / 2].v[jj % 2] * bo.v[ii];
        }
    }
    T* out = static_cast<T*>(s.out) + b * s.out_member + kk * s.out_row;
#pragma unroll
    for (int jj = 0; jj < kTJ; ++jj) {
      const int j = jb * kTJ + jj;
      T x0 = pe[jj][0] + po[jj][0], x1 = pe[jj][1] + po[jj][1];
      T y0 = pe[jj][0] - po[jj][0], y1 = pe[jj][1] - po[jj][1];
      if (s.flag) {
        const T sc = scale[j];
        x0 = x0 * sc; x1 = x1 * sc; y0 = y0 * sc; y1 = y1 * sc;
      }
      store2(out + j * kIX + ib * TI, x0, x1);
      store2(out + j * kIX + kIH + ib * TI, y0, y1);
    }
  }
}

// ---------------------------------------------------------------------------
// Probe p3: out[(r*il + j), m] = 2 * flat(g[r])[j*mx + m], a grid-stride pass.
// ---------------------------------------------------------------------------
constexpr int kSplitThreads = 256;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kSplitThreads)
split_probe_kernel(const T* __restrict__ grid, T* __restrict__ out, long long nrows) {
  constexpr int N = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;   // elements a step
  constexpr unsigned long long PER_ROW = kIL * kMX / N;
  static_assert((kIL * kMX) % N == 0 && (kIL * kIX) % N == 0, "whole vectors per row");
  const unsigned long long total = static_cast<unsigned long long>(nrows) * PER_ROW;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * kSplitThreads;
  for (unsigned long long q = blockIdx.x * static_cast<unsigned long long>(kSplitThreads) +
                              threadIdx.x;
       q < total; q += stride) {
    const unsigned long long r = q / PER_ROW, v = q - r * PER_ROW;
    Vec<T, N> x = load_vec<T, N>(grid + r * (kIL * kIX) + v * N);
#pragma unroll
    for (int e = 0; e < N; ++e) x.v[e] = x.v[e] * static_cast<T>(2);
    *reinterpret_cast<Vec<T, N>*>(out + r * (kIL * kMX) + v * N) = x;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Dynamic shared memory above 48 KB has to be allowed per kernel first.
template <typename K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// A persistent launch: as many blocks as fit on the card at once, at most one
// per row. The occupancy is asked once per kernel and device (the statics
// belong to one instantiation, that is to one kernel).
template <auto kernel>
int launch_persistent(int threads, size_t bytes, const Group& g,
                      long long total, cudaStream_t stream) {
  static int cached_device = -1, blocks_per_sm = 0, sms = 0;
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev != cached_device) {
    rc = allow_shared(kernel, bytes);
    if (rc != 0) return rc;
    rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    if (rc != 0) return rc;
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, kernel, threads, bytes));
    if (rc != 0) return rc;
    if (blocks_per_sm < 1) return -5;
    cached_device = dev;
  }
  long long blocks = static_cast<long long>(blocks_per_sm) * sms;
  if (blocks > total) blocks = total;
  kernel<<<static_cast<unsigned>(blocks), threads, bytes, stream>>>(g, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split(long long nrows, const void* grid, void* out, cudaStream_t stream) {
  const bool vec = (reinterpret_cast<unsigned long long>(grid) |
                    reinterpret_cast<unsigned long long>(out)) % 16 == 0;
  int dev = 0, sms = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (rc != 0) return rc;
  const long long per_block = kSplitThreads * (vec ? 16 / static_cast<long long>(sizeof(T)) : 1);
  long long blocks = (nrows * kIL * kMX + per_block - 1) / per_block;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  const T* g = static_cast<const T*>(grid);
  T* o = static_cast<T*>(out);
  if (vec)
    split_probe_kernel<T, true><<<static_cast<unsigned>(blocks), kSplitThreads, 0, stream>>>(
        g, o, nrows);
  else
    split_probe_kernel<T, false><<<static_cast<unsigned>(blocks), kSplitThreads, 0, stream>>>(
        g, o, nrows);
  return static_cast<int>(cudaGetLastError());
}

// Probes p0..p2: the direct kernel stopped after stage STOP, on a dense
// (N, il, ix) grid (one segment, one row per member) against the direct
// kernel's folded tables.
template <typename T, int STOP>
int launch_probe(long long nrows, const void* const* ptrs, cudaStream_t stream) {
  constexpr int threads = sizeof(T) == 4 ? 128 : 256;
  Group g;
  g.nseg = 1;
  g.tables = ptrs[1];
  g.scale = nullptr;
  if (reinterpret_cast<unsigned long long>(g.tables) % 16 != 0) return -7;
  Segment& s = g.seg[0];
  s.in = ptrs[0];
  s.out = const_cast<void*>(ptrs[2]);
  s.first = 0;
  s.per_member = 1;
  s.in_member = kIL * kIX;
  s.in_pair = s.in_row = 0;
  s.out_member = STOP == 2 ? kPlane : kIL * kMX;
  s.out_pair = s.out_row = 0;
  s.flag = 0;
  s.aligned = reinterpret_cast<unsigned long long>(ptrs[0]) % 16 == 0;
  return launch_persistent<grid2spec_fold_kernel<T, T, false, threads, STOP>>(
      threads, direct_shared_bytes<T, T>(), g, nrows, stream);
}

template <typename T>
int launch_probe_kind(int stage, long long nrows, const void* const* ptrs, cudaStream_t s) {
  switch (stage) {
    case 0: return launch_probe<T, 0>(nrows, ptrs, s);
    case 1: return launch_probe<T, 1>(nrows, ptrs, s);
    case 2: return launch_probe<T, 2>(nrows, ptrs, s);
    case 3: return launch_split<T>(nrows, ptrs[0], const_cast<void*>(ptrs[1]), s);
    default: return -4;
  }
}

bool aligned16(long long address, long long stride, int esize) {
  return address % 16 == 0 && (stride * esize) % 16 == 0;
}

// The group's descriptor from the wrapper's int64 words; returns its rows,
// or a negative code.
long long read_group(Group& g, int nseg, const long long* desc, const void* const* tables,
                     bool inverse, int esize) {
  if (nseg < 1 || nseg > kMaxSeg) return -6;
  g.nseg = nseg;
  g.tables = tables[0];
  g.scale = inverse ? tables[1] : nullptr;
  if (reinterpret_cast<unsigned long long>(g.tables) % 16 != 0) return -7;
  long long total = 0;
  for (int q = 0; q < nseg; ++q) {
    const long long* w = desc + q * kSegWords;
    Segment& s = g.seg[q];
    s.in = reinterpret_cast<const void*>(w[0]);
    s.out = reinterpret_cast<void*>(w[1]);
    const long long rows = w[2];
    s.per_member = static_cast<int>(w[3]);
    s.in_member = w[4];
    s.in_pair = w[5];
    s.in_row = w[6];
    s.out_member = w[7];
    s.out_pair = w[8];
    s.out_row = w[9];
    s.flag = static_cast<int>(w[10]);
    if (rows < 1 || s.per_member < 1 || rows % s.per_member != 0) return -2;
    s.first = total;
    total += rows;
    const long long chunk = static_cast<long long>(inverse ? kPlane : kIL * kIX) * esize;
    s.aligned = aligned16(w[0], s.in_member, esize) && aligned16(0, s.in_row, esize) &&
                (!inverse || aligned16(0, s.in_pair, esize)) && chunk % 16 == 0;
  }
  if (total > 2147483647LL) return -3;
  return total;
}

template <auto kernel>
int occupancy(int threads, size_t bytes, int* out) {
  int rc = allow_shared(kernel, bytes);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  rc = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  if (rc != 0) return rc;
  int blocks = 0;
  rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                                      bytes));
  if (rc != 0) return rc;
  out[0] = blocks;
  out[1] = threads;
  out[2] = static_cast<int>(bytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <typename T>
int probe_occupancy(int kind, int* out) {
  constexpr int threads = sizeof(T) == 4 ? 128 : 256;
  constexpr size_t bytes = direct_shared_bytes<T, T>();
  switch (kind) {
    case 2: return occupancy<grid2spec_fold_kernel<T, T, false, threads, 0>>(threads, bytes, out);
    case 3: return occupancy<grid2spec_fold_kernel<T, T, false, threads, 1>>(threads, bytes, out);
    case 4: return occupancy<grid2spec_fold_kernel<T, T, false, threads, 2>>(threads, bytes, out);
    case 5: return occupancy<split_probe_kernel<T, true>>(kSplitThreads, 0, out);
    default: return -4;
  }
}

}  // namespace

// out: resident blocks per SM, threads a block, shared memory a block
// (bytes), registers, local memory (bytes) of the probe kind 2..5 in mode 0
// (float) or 1 (double), from the CUDA runtime.
extern "C" int pyspeedy_fused_probe_occupancy(int kind, int mode, int* out) {
  if (mode == 0) return probe_occupancy<float>(kind, out);
  if (mode == 1) return probe_occupancy<double>(kind, out);
  return -1;
}

// kind: 0 direct transform of a group, 1 inverse transform of a group,
//       2..5 the probes p0..p3.
// mode: 0 float, 1 double, 2 bfloat16 operands with float sums, 3 bfloat16
//       operands with double sums (2 and 3: the direct transform only).
// count: the group's segments (kinds 0, 1), or the rows (probes).
// tables, by kind:
//   0:       the direct kernel's folded tables (ops/spectral.py::_fold_tables;
//            in the 2-byte modes their bfloat16 roundings, as float or
//            double)
//   1:       the inverse kernel's folded tables, 1/cos(lat) (il,)
//   2, 3, 4: grid, the direct kernel's folded tables, out
//   5:       grid, out
// desc (kinds 0, 1): 11 int64 words per segment: input and output address,
//   rows, rows per member, input member, pair and row strides, output member,
//   pair and row strides (elements), flag (inverse: 1 = scale by 1/cos(lat)).
//   The probes take dense (N, il, ix) grids and write dense outputs; they
//   are built for T30, as the transforms.
extern "C" int pyspeedy_fused_transform(
    int kind, int mode, int count, int il, int ix, int mx, int nx,
    const void* const* tables, const long long* desc, void* stream) {
  if (count <= 0) return 0;
  if (mode < 0 || mode > 3) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (kind == 0 || kind == 1) {
    if (il != kIL || ix != kIX || mx != kMX || nx != kNX) return -2;
    const bool inverse = kind == 1;
    if (inverse && mode >= 2) return -1;
    const int esize = mode == 0 ? 4 : mode == 1 ? 8 : 2;
    Group g;
    const long long total = read_group(g, count, desc, tables, inverse, esize);
    if (total < 0) return static_cast<int>(total);
    if (inverse) {
      if (mode == 0)
        return launch_persistent<spec2grid_fold_kernel<float, 192>>(192,
                                 inverse_shared_bytes<float>(), g, total, s);
      return launch_persistent<spec2grid_fold_kernel<double, 192>>(192,
                               inverse_shared_bytes<double>(), g, total, s);
    }
    if (mode == 0)
      return launch_persistent<grid2spec_fold_kernel<float, float, false, 128>>(128,
                               direct_shared_bytes<float, float>(), g, total, s);
    if (mode == 1)
      return launch_persistent<grid2spec_fold_kernel<double, double, false, 256>>(256,
                               direct_shared_bytes<double, double>(), g, total, s);
    if (mode == 2)
      return launch_persistent<grid2spec_fold_kernel<float, __nv_bfloat16, true, 128>>(128,
                               direct_shared_bytes<float, __nv_bfloat16>(), g, total, s);
    return launch_persistent<grid2spec_fold_kernel<double, __nv_bfloat16, true, 256>>(256,
                             direct_shared_bytes<double, __nv_bfloat16>(), g, total, s);
  }

  if (kind < 2 || kind > 5) return -4;
  if (mode >= 2) return -1;   // the probes have no 2-byte mode
  if (il != kIL || ix != kIX || mx != kMX || nx != kNX) return -2;
  if (mode == 0) return launch_probe_kind<float>(kind - 2, count, tables, s);
  return launch_probe_kind<double>(kind - 2, count, tables, s);
}
