// The fused spectral transforms at T47 (il 72, ix 144, mx 48, nx 49) and T63
// (il 96, ix 192, mx 64, nx 65) for NVIDIA Hopper (sm_90a): the zonal DFT and
// the Legendre transform of a group of fields, two kernels a direction.
//
// Replaces, at these shapes, the two Pallas experiments of the JAX package
// that csrc/fused_transform.cu replaces at T30:
//   tools/exp_fused_transform.py:65  fused_grid2spec  (pallas_call at :102)
//   tools/exp_fused_transform.py:121 fused_spec2grid  (pallas_call at :143)
// Both read il, mx and nx from the tables they are given; the JAX package runs
// T47 and T63 through einsums (its dense size gate). On the card those are
// cuBLAS products whose rounding may follow the batch width, which these
// kernels do not. The plain version at these shapes is that einsum chain
// (ops/transform_kernels.py); the wrappers are there too.
//
// Computes, for every field row (one (il, ix) grid or one spectral pair):
//   direct   F[c, j, m] = sum_i g[j, i] * dft_fwd[c, i, m]
//            S[c, m, n] = sum_j F[c, j, m] * leg_dir[j, m, n]
//   inverse  F[c, j, m] = sum_n leg_inv[j, m, n] * p[c, m, n]
//            g[j, i]    = (sum_c sum_m F[c, j, m] * dft_inv[c, m, i]) * scale[j]
// on the folded tables of ops/spectral.py::_fold_tables (the same layout as
// at T30): the DFT folded by half a period (sums against even m, differences
// against odd m), the Legendre sums over the northern latitudes and the
// (m, n) triangle m + n <= nx - 1 only, using the tables' hemispheric parity.
// The inverse never reads the imaginary part of m = 0 (the reference's
// "discard" rule). float and double.
//
// Why two kernels. The T30 kernels keep all their folded tables in one
// block's shared memory; here the Legendre table alone is 172 / 344 KB (T47,
// float / double) and 402 / 804 KB (T63), above the 227 KB a block can hold.
// The transform factorises: a DFT a latitude over all m, then a Legendre sum
// an m over all latitudes (and the reverse for the inverse). So:
//   hires_dft_fwd_kernel  persistent blocks over items (row, 12 latitude
//       pairs): the folded DFT table resident (27 / 48 KB in float), the
//       item's 24 grid rows copied by cp.async while the previous item is
//       computed, folded by half a period into a transposed tile; a thread
//       keeps 2 pairs x 4 wavenumber columns (16 sums) and writes the
//       hemispheric sums and differences F[j] +- F[il-1-j] to a scratch
//       X[row, m, c, sd, j] (j the pair).
//   hires_leg_dir_kernel  blocks over (16 row pairs, a slice of the
//       triangle): a slice is an equal share of the (m, n) entries, one entry
//       a thread, whose iy Legendre values stay in registers; the slice's
//       part of X for two rows comes in by cp.async into a two-stage ring
//       (a third stage ran no faster); each thread forms 4 sums (2 rows x real,
//       imaginary) and the slice writes the zeros past the triangle of the
//       rows m that end in it. The slices read unequal spans of X (the high
//       m have few entries each), so the blocks are not persistent: the
//       hardware spreads the heavy and light slices' blocks over the SMs.
//   hires_leg_inv_kernel  blocks over (row pairs, slices of m balanced by
//       triangle entries): the slice's Legendre rows in shared memory as
//       (m, n, j); a thread keeps 4 latitudes x 2 rows x 2 parts of the even
//       and odd partial sums E, O and writes F[j] = E + O, F[il-1-j] = E - O
//       to X[row, m, c, hemisphere, j] (0 for the imaginary part of m = 0).
//   hires_dft_inv_kernel  persistent blocks over items (row, 12 latitude
//       pairs): the folded inverse DFT table resident, the item's Fourier
//       coefficients copied by cp.async into a two-stage ring; a thread keeps
//       8 latitudes x 2 longitudes of both parities and stores g[i] = Pe + Po,
//       g[i + ix/2] = Pe - Po, scaled by 1/cos(lat) where the field's flag
//       says so.
// The scratch X (mx * 4 * iy values a row, the size of the Fourier
// intermediate) is allocated by the wrapper for each launch; it costs a write
// and a read of 2 il mx values a row beyond a fused kernel's bytes.
//
// Every output element is one fixed-order sum inside one thread (j or n
// ascending, the even and odd partial sums apart), with no atomics and no
// split that depends on the launch's row count: a row's result does not
// depend on the rows or segments launched with it, so a member alone is
// bitwise the same member in any batch, and a group equals its fields
// launched one by one.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s float outside the tensor
// cores): a T63 row reads 73.7 KB of grid and writes 33.3 KB of pair in
// float (32 ns at the memory rate), and the folded work is il mx ix + il
// triangle multiply-adds, 1.39 M a row (41 ns at the float peak): the
// operations bind at T63 (0.83 ms for the step's groups of 9,344 direct and
// 10,624 inverse rows, against 0.64 ms of bytes), and at T47 they are about
// even with the bytes (0.35 against 0.36 ms). Products on CUDA cores; the
// DFT stages are register-tiled (16 multiply-adds for 4 shared-memory loads
// direct, 32 for 6 inverse), the Legendre stages 4 multiply-adds a 16-byte
// load (direct) or 16 for 5 loads (inverse).
//
// Interface: plain C, loaded with ctypes. The launches go to the stream they
// are given, allocate nothing and do not synchronise; the function returns
// cudaGetLastError() (0 on success) or a negative code for arguments the
// kernels were not built for.

#include <cuda_runtime.h>

namespace {

constexpr int kPB = 12;              // latitude pairs of a DFT item
constexpr int kMaxSeg = 16;
constexpr int kSegWords = 11;        // int64 words of one segment descriptor

template <int IL_, int IX_, int MX_, int NX_>
struct Shape {
  static constexpr int IL = IL_, IX = IX_, MX = MX_, NX = NX_;
  static constexpr int IY = IL / 2, IH = IX / 2, H = (MX + 1) / 2, COLS = 2 * H;
  static constexpr int TRI = MX * NX - MX * (MX - 1) / 2;   // m + n <= nx - 1
  static constexpr int NPB = IY / kPB;                      // DFT items a row
  static constexpr int DFT = 2 * IH * COLS;                 // folded DFT table
  static constexpr int LEG = IY * TRI;                      // folded Legendre table
  static constexpr int XROW = MX * 4 * IY;                  // scratch a row
  static_assert(IY % kPB == 0 && IY % 4 == 0 && MX % 2 == 0 && IX % 2 == 0,
                "the tiles of these kernels");
};
using T47 = Shape<72, 144, 48, 49>;
using T63 = Shape<96, 192, 64, 65>;

// Start of row m of the (m, n) triangle, n = 0 .. nx-1-m.
__host__ __device__ constexpr int tri_offset(int m, int nx) {
  return nx * m - m * (m - 1) / 2;
}
// The row m of triangle entry e.
__host__ __device__ constexpr int m_of_entry(int e, int nx) {
  int m = 0;
  while (e >= nx - m) { e -= nx - m; ++m; }
  return m;
}

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
  const void* tables;     // ops/spectral.py::_fold_tables, this direction's
  const void* scale;      // inverse: 1/cos(lat) (il,)
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};
template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}
// Four neighbouring values (16-byte aligned), as one or two 16-byte loads.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T* out) {
  if constexpr (sizeof(T) == 4) {
    const Vec<T, 4> a = load_vec<T, 4>(p);
    out[0] = a.v[0]; out[1] = a.v[1]; out[2] = a.v[2]; out[3] = a.v[3];
  } else {
    const Vec<T, 2> a = load_vec<T, 2>(p), b = load_vec<T, 2>(p + 2);
    out[0] = a.v[0]; out[1] = a.v[1]; out[2] = b.v[0]; out[3] = b.v[1];
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, T a, T b) {
  Vec<T, 2> v;
  v.v[0] = a;
  v.v[1] = b;
  *reinterpret_cast<Vec<T, 2>*>(p) = v;
}

__device__ __forceinline__ int find_segment(const Group& g, long long r) {
  int s = 0;
  while (s + 1 < g.nseg && r >= g.seg[s + 1].first) ++s;
  return s;
}

// cp.async: 16-byte chunks bypassing L1, or single elements (4 or 8 bytes)
// through L1; completed by cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy n elements into shared memory: cp.async in 16-byte chunks where the
// source is aligned (n * sizeof(T) a multiple of 16), element by element
// otherwise; both complete at the caller's next cp_async_wait_all.
template <int THREADS, typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, int n, bool aligned) {
  if (aligned) {
    const int chunks = n * static_cast<int>(sizeof(T)) / 16;
    auto* d = reinterpret_cast<unsigned char*>(dst);
    auto* s = reinterpret_cast<const unsigned char*>(src);
    for (int q = threadIdx.x; q < chunks; q += THREADS) cp_async16(d + 16 * q, s + 16 * q);
  } else {
    for (int q = threadIdx.x; q < n; q += THREADS) cp_async_elem(dst + q, src + q);
  }
}

// The input of row lr of segment s (elements of its (il, ix) grid or of its
// real part), and the output.
template <typename T>
__device__ __forceinline__ const T* row_in(const Segment& s, long long lr) {
  const long long b = lr / s.per_member, kk = lr - b * s.per_member;
  return static_cast<const T*>(s.in) + b * s.in_member + kk * s.in_row;
}
template <typename T>
__device__ __forceinline__ T* row_out(const Segment& s, long long lr) {
  const long long b = lr / s.per_member, kk = lr - b * s.per_member;
  return static_cast<T*>(s.out) + b * s.out_member + kk * s.out_row;
}

// ---------------------------------------------------------------------------
// Direct transform, stage 1: the folded zonal DFT of 12 latitude pairs of a
// row, written as hemispheric sums (sd 0, even n) and differences (sd 1).
// ---------------------------------------------------------------------------
// The folded, transposed tile's pitch, even (8- or 16-byte loads of two
// slots): 2 kPB + 2 at T63, where it turns the transposed store's 8-way bank
// conflicts into 2-way ones and the kernel ran faster on the H100; 2 kPB at
// T47, where the padded pitch ran slower.
template <class S>
__host__ __device__ constexpr int pitch_a() { return S::IL == 96 ? 2 * kPB + 2 : 2 * kPB; }
template <class S>
__host__ __device__ constexpr int dft_fwd_threads() { return 2 * (kPB / 2) * (S::COLS / 4); }
template <class S, typename T>
constexpr size_t dft_fwd_shared_bytes() {
  return sizeof(T) * (2 * kPB * S::IX + S::DFT + 2 * S::IH * pitch_a<S>());
}

template <class S, typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
hires_dft_fwd_kernel(const __grid_constant__ Group g, long long items, void* scratch) {
  constexpr int PB2 = 2 * kPB;             // latitude slots: south, then north
  constexpr int NCB = S::COLS / 4;
  constexpr int HALF = THREADS / 2;        // threads of one parity
  constexpr int kPitchA = pitch_a<S>();
  static_assert(HALF == (kPB / 2) * NCB, "register tile");
  T* x = static_cast<T*>(scratch);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);  // (2 PB, ix): south rows, north rows
  T* sD = stage + PB2 * S::IX;                // (2 parity, ih, cols)
  T* sA = sD + S::DFT;                        // (2 parity, ih, kPitchA) folded, transposed
  const int tid = threadIdx.x;

  // Item = (row, pair block pb): pairs p = pb*PB + t, latitudes p (south) and
  // il-1-p (north). The south rows are one run of the grid, the north rows
  // another (ascending: north slot PB + t is run row PB-1-t).
  auto issue = [&](long long item) {
    const long long row = item / S::NPB;
    const int pb = static_cast<int>(item - row * S::NPB);
    const Segment& s = g.seg[find_segment(g, row)];
    const T* src = row_in<T>(s, row - s.first);
    stage_copy<THREADS>(stage, src + pb * kPB * S::IX, kPB * S::IX, s.aligned != 0);
    stage_copy<THREADS>(stage + kPB * S::IX, src + (S::IL - kPB - pb * kPB) * S::IX,
                        kPB * S::IX, s.aligned != 0);
  };
  long long it = blockIdx.x;
  if (it < items) issue(it);
  stage_copy<THREADS>(sD, static_cast<const T*>(g.tables), S::DFT, true);
  cp_async_commit();

  const int par = tid / HALF, u = tid - par * HALF;
  const int jb = u / NCB, cb = u - jb * NCB;
  for (; it < items; it += gridDim.x) {
    const long long row = it / S::NPB;
    const int pb = static_cast<int>(it - row * S::NPB);
    cp_async_wait_all();
    __syncthreads();
    // sA[0][i][slot] = g[i] + g[i+ih], sA[1][i][slot] = g[i] - g[i+ih].
    for (int idx = tid; idx < PB2 * S::IH; idx += THREADS) {
      const int slot = idx / S::IH, i = idx - slot * S::IH;
      const int r = slot < kPB ? slot : 3 * kPB - 1 - slot;
      const T a = stage[r * S::IX + i], c = stage[r * S::IX + i + S::IH];
      sA[i * kPitchA + slot] = a + c;
      sA[(S::IH + i) * kPitchA + slot] = a - c;
    }
    __syncthreads();
    if (it + gridDim.x < items) issue(it + gridDim.x);
    cp_async_commit();

    // Slots 2jb, 2jb+1 (south) and PB+2jb, PB+2jb+1 (north) x columns
    // 4cb..4cb+3 of this thread's parity.
    const T* a_base = sA + par * S::IH * kPitchA + 2 * jb;
    const T* b_base = sD + par * S::IH * S::COLS + 4 * cb;
    T acc[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[jj][cc] = T(0);
#pragma unroll 4
    for (int k = 0; k < S::IH; ++k) {
      const Vec<T, 2> as = load_vec<T, 2>(a_base + k * kPitchA);
      const Vec<T, 2> an = load_vec<T, 2>(a_base + k * kPitchA + kPB);
      const Vec<T, 2> b0 = load_vec<T, 2>(b_base + k * S::COLS);
      const Vec<T, 2> b1 = load_vec<T, 2>(b_base + k * S::COLS + 2);
      const T av[4] = {as.v[0], as.v[1], an.v[0], an.v[1]};
      const T bv[4] = {b0.v[0], b0.v[1], b1.v[0], b1.v[1]};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[jj][cc] += av[jj] * bv[cc];
    }
    T* xr = x + row * S::XROW + pb * kPB + 2 * jb;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = 4 * cb + cc;
      const int c = col / S::H, m = 2 * (col - c * S::H) + par;
      T* dst = xr + (m * 2 + c) * 2 * S::IY;
      store2(dst, acc[0][cc] + acc[2][cc], acc[1][cc] + acc[3][cc]);
      store2(dst + S::IY, acc[0][cc] - acc[2][cc], acc[1][cc] - acc[3][cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// Direct transform, stage 2: the Legendre sums of a slice of the triangle,
// two rows at a time.
// ---------------------------------------------------------------------------
constexpr int kLegDirThreads = 256;
constexpr int kLegDirPairs = 16;     // row pairs a block
template <class S>
__host__ __device__ constexpr int leg_dir_slices() { return (S::TRI + kLegDirThreads - 1) / kLegDirThreads; }
// X values of slice sl for one row: the rows m of its entries.
template <class S>
__host__ __device__ constexpr int leg_dir_span(int sl) {
  constexpr int NS = leg_dir_slices<S>();
  const int e0 = sl * S::TRI / NS, e1 = (sl + 1) * S::TRI / NS;
  return (m_of_entry(e1 - 1, S::NX) - m_of_entry(e0, S::NX) + 1) * 4 * S::IY;
}
template <class S, typename T>
size_t leg_dir_shared_bytes() {
  int span = 0;
  for (int sl = 0; sl < leg_dir_slices<S>(); ++sl)
    span = leg_dir_span<S>(sl) > span ? leg_dir_span<S>(sl) : span;
  return sizeof(T) * 4 * static_cast<size_t>(span);
}

template <class S, typename T, int THREADS, int PAIRS>
__global__ void __launch_bounds__(THREADS)
hires_leg_dir_kernel(const __grid_constant__ Group g, long long rows, void* scratch) {
  constexpr int NS = leg_dir_slices<S>();
  constexpr int VW = 16 / static_cast<int>(sizeof(T));
  const T* x = static_cast<const T*>(scratch);
  const int sl = blockIdx.y;
  const int e0 = sl * S::TRI / NS, e1 = (sl + 1) * S::TRI / NS;
  const int mlo = m_of_entry(e0, S::NX), mhi = m_of_entry(e1 - 1, S::NX);
  const int span = leg_dir_span<S>(sl);
  // Rows m whose zeros past the triangle this slice writes: those that end in it.
  const int zhi = tri_offset(mhi + 1, S::NX) <= e1 ? mhi : mhi - 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // (2 stages, 2 rows, span)
  const int tid = threadIdx.x;
  const int e = e0 + tid;
  const bool active = e < e1;
  int m = 0, n = 0;
  if (active) {
    m = m_of_entry(e, S::NX);
    n = e - tri_offset(m, S::NX);
  }
  T L[S::IY];
  const T* leg = static_cast<const T*>(g.tables) + S::DFT;   // (iy, triangle)
#pragma unroll
  for (int j = 0; j < S::IY; ++j) L[j] = active ? leg[j * S::TRI + e] : T(0);
  // This entry's X values in a stage: (m - mlo, c, sd = n & 1, j).
  const int xoff = ((m - mlo) * 4 + (n & 1)) * S::IY;

  const long long npairs = (rows + 1) / 2;
  auto issue = [&](long long pr, int buf) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long row = 2 * pr + rr;
      if (row < rows)
        stage_copy<THREADS>(xs + (buf * 2 + rr) * span, x + row * S::XROW + mlo * 4 * S::IY,
                            span, true);
    }
  };
  // This block's run of row pairs; the grid's x dimension covers them all.
  long long pr = blockIdx.x * static_cast<long long>(PAIRS);
  const long long pr_end = pr + PAIRS < npairs ? pr + PAIRS : npairs;
  int buf = 0;
  if (pr < pr_end) issue(pr, 0);
  cp_async_commit();
  for (; pr < pr_end; ++pr, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (pr + 1 < pr_end) issue(pr + 1, buf ^ 1);
    cp_async_commit();
    const long long row0 = 2 * pr;
    const bool two = row0 + 1 < rows;
    if (active) {
      const T* x0 = xs + buf * 2 * span + xoff;   // row 0, real part
      const T* x1 = x0 + 2 * S::IY;               // row 0, imaginary part
      const T* x2 = x0 + span;                    // row 1
      const T* x3 = x2 + 2 * S::IY;
      T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll
      for (int j = 0; j < S::IY; j += VW) {
        const Vec<T, VW> a0 = load_vec<T, VW>(x0 + j), a1 = load_vec<T, VW>(x1 + j);
        const Vec<T, VW> a2 = load_vec<T, VW>(x2 + j), a3 = load_vec<T, VW>(x3 + j);
#pragma unroll
        for (int q = 0; q < VW; ++q) {
          s0 += L[j + q] * a0.v[q];
          s1 += L[j + q] * a1.v[q];
          s2 += L[j + q] * a2.v[q];
          s3 += L[j + q] * a3.v[q];
        }
      }
      const Segment& sa = g.seg[find_segment(g, row0)];
      T* out = row_out<T>(sa, row0 - sa.first) + m * S::NX + n;
      out[0] = s0;
      out[sa.out_pair] = s1;
      if (two) {
        const Segment& sb = g.seg[find_segment(g, row0 + 1)];
        T* outb = row_out<T>(sb, row0 + 1 - sb.first) + m * S::NX + n;
        outb[0] = s2;
        outb[sb.out_pair] = s3;
      }
    }
    // Zeros past the triangle: n = nx - m .. nx - 1 of the rows m that end here.
    for (int rr = 0; rr < (two ? 2 : 1); ++rr) {
      const Segment& s = g.seg[find_segment(g, row0 + rr)];
      T* out = row_out<T>(s, row0 + rr - s.first);
      for (int mm = mlo; mm <= zhi; ++mm)
        for (int nn = S::NX - mm + tid; nn < S::NX; nn += THREADS) {
          out[mm * S::NX + nn] = T(0);
          out[s.out_pair + mm * S::NX + nn] = T(0);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Inverse transform, stage 1: the Legendre synthesis of a slice of m, two
// rows at a time, written as F of both hemispheres.
// ---------------------------------------------------------------------------
constexpr int kLegInvThreads = 128;
constexpr int kLegInvSlices = 8;
// First m of slice sl: the first row of the triangle that starts at or past
// the slice's equal share of the entries.
template <class S>
__host__ __device__ constexpr int leg_inv_m0(int sl) {
  const int e = sl * S::TRI / kLegInvSlices;
  int m = 0;
  while (m < S::MX && tri_offset(m, S::NX) < e) ++m;
  return m;
}
template <class S, typename T>
size_t leg_inv_shared_bytes() {
  size_t most = 0;
  for (int sl = 0; sl < kLegInvSlices; ++sl) {
    const int m0 = leg_inv_m0<S>(sl), m1 = leg_inv_m0<S>(sl + 1);
    const size_t n = static_cast<size_t>(tri_offset(m1, S::NX) - tri_offset(m0, S::NX)) * S::IY +
                     2 * 4 * static_cast<size_t>(m1 - m0) * S::NX;
    most = n > most ? n : most;
  }
  return sizeof(T) * most;
}

template <class S, typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
hires_leg_inv_kernel(const __grid_constant__ Group g, long long rows, void* scratch) {
  constexpr int JQ = S::IY / 4;            // latitude quads
  T* x = static_cast<T*>(scratch);
  const int sl = blockIdx.y;
  const int m0 = leg_inv_m0<S>(sl), m1 = leg_inv_m0<S>(sl + 1);
  if (m0 >= m1) return;
  const int t0 = tri_offset(m0, S::NX);
  const int ent = tri_offset(m1, S::NX) - t0;
  const int run = (m1 - m0) * S::NX;       // a part's values of the slice, one row
  const int items = (m1 - m0) * JQ;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sL = reinterpret_cast<T*>(smem_raw);  // (entries of the slice, iy)
  T* sP = sL + ent * S::IY;                // (2 stages, 2 rows, 2 parts, run)
  const int tid = threadIdx.x;
  const T* leg = static_cast<const T*>(g.tables);    // (iy, triangle)
  for (int idx = tid; idx < ent * S::IY; idx += THREADS) {
    const int j = idx / ent, q = idx - j * ent;
    sL[q * S::IY + j] = leg[j * S::TRI + t0 + q];
  }

  const long long npairs = (rows + 1) / 2;
  auto issue = [&](long long pr, int buf) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long row = 2 * pr + rr;
      if (row >= rows) continue;
      const Segment& s = g.seg[find_segment(g, row)];
      const T* src = row_in<T>(s, row - s.first) + m0 * S::NX;
      T* dst = sP + (buf * 4 + rr * 2) * run;
      for (int q = tid; q < run; q += THREADS) {
        cp_async_elem(dst + q, src + q);
        cp_async_elem(dst + run + q, src + s.in_pair + q);
      }
    }
  };
  long long pr = blockIdx.x;
  int buf = 0;
  if (pr < npairs) issue(pr, 0);
  cp_async_commit();
  for (; pr < npairs; pr += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (pr + gridDim.x < npairs) issue(pr + gridDim.x, buf ^ 1);
    cp_async_commit();
    const long long row0 = 2 * pr;
    const bool two = row0 + 1 < rows;
    for (int it = tid; it < items; it += THREADS) {
      const int mm = it / JQ, jq = it - mm * JQ, m = m0 + mm;
      const T* l = sL + (tri_offset(m, S::NX) - t0) * S::IY + 4 * jq;
      const T* p = sP + buf * 4 * run + mm * S::NX;   // + (rr * 2 + c) * run
      T e[4][4], o[4][4];                             // [rr * 2 + c][latitude]
#pragma unroll
      for (int rc = 0; rc < 4; ++rc)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) e[rc][jj] = o[rc][jj] = T(0);
      const int nn = S::NX - m;
      int n = 0;
      for (; n + 1 < nn; n += 2) {
        T le[4], lo[4];
        load4(l + n * S::IY, le);
        load4(l + (n + 1) * S::IY, lo);
#pragma unroll
        for (int rc = 0; rc < 4; ++rc) {
          const T pe = p[rc * run + n], po = p[rc * run + n + 1];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            e[rc][jj] += le[jj] * pe;
            o[rc][jj] += lo[jj] * po;
          }
        }
      }
      if (n < nn) {
        T le[4];
        load4(l + n * S::IY, le);
#pragma unroll
        for (int rc = 0; rc < 4; ++rc) {
          const T pe = p[rc * run + n];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) e[rc][jj] += le[jj] * pe;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (rr == 1 && !two) break;
        T* xr = x + (row0 + rr) * S::XROW + m * 4 * S::IY + 4 * jq;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          T* dst = xr + c * 2 * S::IY;
          const int rc = rr * 2 + c;
          const bool discard = m == 0 && c == 1;   // the imaginary part of m = 0
#pragma unroll
          for (int jj = 0; jj < 4; jj += 2) {
            store2(dst + jj, discard ? T(0) : e[rc][jj] + o[rc][jj],
                   discard ? T(0) : e[rc][jj + 1] + o[rc][jj + 1]);
            store2(dst + S::IY + jj, discard ? T(0) : e[rc][jj] - o[rc][jj],
                   discard ? T(0) : e[rc][jj + 1] - o[rc][jj + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Inverse transform, stage 2: the folded inverse DFT of 12 latitude pairs of
// a row.
// ---------------------------------------------------------------------------
template <class S>
__host__ __device__ constexpr int dft_inv_threads() { return (2 * kPB / 8) * (S::IH / 2); }
template <class S, typename T>
constexpr size_t dft_inv_shared_bytes() {
  return sizeof(T) * (S::DFT + 2 * 2 * S::COLS * 2 * kPB);
}

template <class S, typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
hires_dft_inv_kernel(const __grid_constant__ Group g, long long items, void* scratch) {
  constexpr int PB2 = 2 * kPB;
  constexpr int NIB = S::IH / 2;
  constexpr int CH = kPB * static_cast<int>(sizeof(T)) / 16;   // 16-byte chunks of a run
  constexpr int TILE = 2 * S::COLS * PB2;                      // one stage
  static_assert(THREADS == (PB2 / 8) * NIB, "register tile");
  const T* x = static_cast<const T*>(scratch);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sD = reinterpret_cast<T*>(smem_raw);  // (2 parity, cols, ih)
  T* sA = sD + S::DFT;                     // (2 stages, 2 parity, cols, 2 PB)
  const int tid = threadIdx.x;

  // Item = (row, pb): its F runs X[row, m, c, hemisphere, pb*PB ..] into
  // sA[stage][parity of m][c*h + m/2][hemisphere*PB ..].
  auto issue = [&](long long item, int buf) {
    const long long row = item / S::NPB;
    const int pb = static_cast<int>(item - row * S::NPB);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        x + row * S::XROW + pb * kPB);
    unsigned char* dst = reinterpret_cast<unsigned char*>(sA + buf * TILE);
    for (int q = tid; q < S::MX * 4 * CH; q += THREADS) {
      const int r = q / CH, ch = q - r * CH;           // r = (m * 2 + c) * 2 + hemisphere
      const int m = r >> 2, c = (r >> 1) & 1, hemi = r & 1;
      const int k = (m & 1) * S::COLS + c * S::H + (m >> 1);
      cp_async16(dst + sizeof(T) * (k * PB2 + hemi * kPB) + 16 * ch,
                 src + sizeof(T) * r * S::IY + 16 * ch);
    }
  };
  long long it = blockIdx.x;
  if (it < items) issue(it, 0);
  stage_copy<THREADS>(sD, static_cast<const T*>(g.tables) + S::LEG, S::DFT, true);
  cp_async_commit();
  const T* scale = static_cast<const T*>(g.scale);

  const int jb = tid / NIB, ib = tid - jb * NIB;
  int buf = 0;
  for (; it < items; it += gridDim.x, buf ^= 1) {
    const long long row = it / S::NPB;
    const int pb = static_cast<int>(it - row * S::NPB);
    cp_async_wait_all();
    __syncthreads();
    if (it + gridDim.x < items) issue(it + gridDim.x, buf ^ 1);
    cp_async_commit();

    const T* ae_base = sA + buf * TILE + 8 * jb;
    const T* ao_base = ae_base + S::COLS * PB2;
    const T* be_base = sD + 2 * ib;
    const T* bo_base = be_base + S::COLS * S::IH;
    T pe[8][2], po[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) pe[jj][0] = pe[jj][1] = po[jj][0] = po[jj][1] = T(0);
#pragma unroll 4
    for (int k = 0; k < S::COLS; ++k) {
      T ae[8], ao[8];
      load4(ae_base + k * PB2, ae);
      load4(ae_base + k * PB2 + 4, ae + 4);
      load4(ao_base + k * PB2, ao);
      load4(ao_base + k * PB2 + 4, ao + 4);
      const Vec<T, 2> be = load_vec<T, 2>(be_base + k * S::IH);
      const Vec<T, 2> bo = load_vec<T, 2>(bo_base + k * S::IH);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          pe[jj][ii] += ae[jj] * be.v[ii];
          po[jj][ii] += ao[jj] * bo.v[ii];
        }
    }
    const Segment& s = g.seg[find_segment(g, row)];
    T* out = row_out<T>(s, row - s.first);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int slot = 8 * jb + jj;
      const int lat = slot < kPB ? pb * kPB + slot : S::IL - 1 - (pb * kPB + slot - kPB);
      T x0 = pe[jj][0] + po[jj][0], x1 = pe[jj][1] + po[jj][1];
      T y0 = pe[jj][0] - po[jj][0], y1 = pe[jj][1] - po[jj][1];
      if (s.flag) {
        const T sc = scale[lat];
        x0 = x0 * sc; x1 = x1 * sc; y0 = y0 * sc; y1 = y1 * sc;
      }
      store2(out + lat * S::IX + 2 * ib, x0, x1);
      store2(out + lat * S::IX + S::IH + 2 * ib, y0, y1);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// Resident blocks per SM and SMs of the current device, asked once per
// kernel and device (the statics belong to one instantiation).
template <auto kernel>
int residency(int threads, size_t bytes, int* blocks_per_sm, int* sms) {
  static int cached_device = -1, cached_blocks = 0, cached_sms = 0;
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev != cached_device) {
    rc = allow_shared(kernel, bytes);
    if (rc != 0) return rc;
    rc = static_cast<int>(cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, dev));
    if (rc != 0) return rc;
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached_blocks, kernel, threads, bytes));
    if (rc != 0) return rc;
    if (cached_blocks < 1) return -5;
    cached_device = dev;
  }
  *blocks_per_sm = cached_blocks;
  *sms = cached_sms;
  return 0;
}

// A launch of `slices` columns of persistent blocks: as many blocks as fit
// on the card at once, shared by the columns, at most one per unit of work.
template <auto kernel>
int launch(int threads, size_t bytes, int slices, const Group& g, long long units,
           long long n, void* scratch, cudaStream_t stream) {
  int bps = 0, sms = 0;
  int rc = residency<kernel>(threads, bytes, &bps, &sms);
  if (rc != 0) return rc;
  long long blocks = static_cast<long long>(bps) * sms / slices;
  if (blocks < 1) blocks = 1;
  if (blocks > units) blocks = units;
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(slices)), threads, bytes,
           stream>>>(g, n, scratch);
  return static_cast<int>(cudaGetLastError());
}

// A launch of the Legendre stage: `slices` columns of blocks, each block a
// run of `pairs` row pairs; the hardware balances the blocks of light and
// heavy slices over the SMs.
template <auto kernel>
int launch_pairs(int threads, size_t bytes, int slices, int pairs, const Group& g,
                 long long rows, void* scratch, cudaStream_t stream) {
  int bps = 0, sms = 0;
  int rc = residency<kernel>(threads, bytes, &bps, &sms);
  if (rc != 0) return rc;
  const long long npairs = (rows + 1) / 2;
  const long long blocks = (npairs + pairs - 1) / pairs;
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(slices)), threads, bytes,
           stream>>>(g, rows, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <class S, typename T>
int run_direct(const Group& g, long long rows, void* scratch, cudaStream_t s) {
  constexpr int t1 = dft_fwd_threads<S>();
  const long long items = rows * S::NPB;
  int rc = launch<hires_dft_fwd_kernel<S, T, t1>>(t1, dft_fwd_shared_bytes<S, T>(), 1, g, items,
                                                  items, scratch, s);
  if (rc != 0) return rc;
  return launch_pairs<hires_leg_dir_kernel<S, T, kLegDirThreads, kLegDirPairs>>(
      kLegDirThreads, leg_dir_shared_bytes<S, T>(), leg_dir_slices<S>(), kLegDirPairs, g, rows,
      scratch, s);
}

template <class S, typename T>
int run_inverse(const Group& g, long long rows, void* scratch, cudaStream_t s) {
  constexpr int t2 = dft_inv_threads<S>();
  int rc = launch<hires_leg_inv_kernel<S, T, kLegInvThreads>>(
      kLegInvThreads, leg_inv_shared_bytes<S, T>(), kLegInvSlices, g, (rows + 1) / 2, rows,
      scratch, s);
  if (rc != 0) return rc;
  const long long items = rows * S::NPB;
  return launch<hires_dft_inv_kernel<S, T, t2>>(t2, dft_inv_shared_bytes<S, T>(), 1, g, items,
                                                items, scratch, s);
}

bool aligned16(long long address, long long stride, int esize) {
  return address % 16 == 0 && (stride * esize) % 16 == 0;
}

// The group's descriptor from the wrapper's int64 words; returns its rows,
// or a negative code.
long long read_group(Group& g, int nseg, const long long* desc, const void* const* tables,
                     bool inverse, int esize, int grid_row) {
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
    // Only the direct kernel copies 16-byte chunks of its input (the rows of
    // a grid, grid_row elements apart).
    s.aligned = !inverse && aligned16(w[0], s.in_member, esize) &&
                aligned16(0, s.in_row, esize) && (grid_row * esize) % 16 == 0;
  }
  if (total > 2147483647LL / 64) return -3;
  return total;
}

template <class S, typename T>
int run(int kind, int count, const void* const* tables, const long long* desc, void* scratch,
        cudaStream_t s) {
  Group g;
  const long long rows = read_group(g, count, desc, tables, kind == 1,
                                    static_cast<int>(sizeof(T)), S::IX);
  if (rows < 0) return static_cast<int>(rows);
  if (reinterpret_cast<unsigned long long>(scratch) % 16 != 0) return -8;
  return kind == 0 ? run_direct<S, T>(g, rows, scratch, s) : run_inverse<S, T>(g, rows, scratch, s);
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

template <class S, typename T>
int occupancy_of(int stage, int* out) {
  constexpr int t1 = dft_fwd_threads<S>(), t2 = dft_inv_threads<S>();
  switch (stage) {
    case 0: return occupancy<hires_dft_fwd_kernel<S, T, t1>>(t1, dft_fwd_shared_bytes<S, T>(), out);
    case 1: return occupancy<hires_leg_dir_kernel<S, T, kLegDirThreads, kLegDirPairs>>(
        kLegDirThreads, leg_dir_shared_bytes<S, T>(), out);
    case 2: return occupancy<hires_leg_inv_kernel<S, T, kLegInvThreads>>(
        kLegInvThreads, leg_inv_shared_bytes<S, T>(), out);
    case 3: return occupancy<hires_dft_inv_kernel<S, T, t2>>(t2, dft_inv_shared_bytes<S, T>(), out);
    default: return -4;
  }
}

// 47 or 63 for the shapes the kernels are built for, else 0.
int shape_of(int il, int ix, int mx, int nx) {
  if (il == T47::IL && ix == T47::IX && mx == T47::MX && nx == T47::NX) return 47;
  if (il == T63::IL && ix == T63::IX && mx == T63::MX && nx == T63::NX) return 63;
  return 0;
}

}  // namespace

// out: resident blocks per SM, threads a block, shared memory a block
// (bytes), registers, local memory (bytes) of stage 0 (direct DFT), 1
// (direct Legendre), 2 (inverse Legendre) or 3 (inverse DFT) at truncation
// 47 or 63 in mode 0 (float) or 1 (double), from the CUDA runtime; out[5]
// the stage's slices (the grid's second dimension).
extern "C" int pyspeedy_fused_transform_hires_occupancy(int stage, int trunc, int mode, int* out) {
  out[5] = stage == 1 ? (trunc == 47 ? leg_dir_slices<T47>() : leg_dir_slices<T63>())
           : stage == 2 ? kLegInvSlices : 1;
  if (trunc == 47 && mode == 0) return occupancy_of<T47, float>(stage, out);
  if (trunc == 47 && mode == 1) return occupancy_of<T47, double>(stage, out);
  if (trunc == 63 && mode == 0) return occupancy_of<T63, float>(stage, out);
  if (trunc == 63 && mode == 1) return occupancy_of<T63, double>(stage, out);
  return -1;
}

// kind: 0 direct transform of a group, 1 inverse transform of a group.
// mode: 0 float, 1 double.
// count: the group's segments.
// tables: 0: the direct folded tables (ops/spectral.py::_fold_tables);
//         1: the inverse folded tables, 1/cos(lat) (il,).
// desc: 11 int64 words per segment: input and output address, rows, rows
//   per member, input member, pair and row strides, output member, pair and
//   row strides (elements), flag (inverse: 1 = scale by 1/cos(lat)).
// scratch: mx * 4 * (il / 2) values of the mode's type for every row of the
//   group, 16-byte aligned (the Fourier intermediate between the stages).
extern "C" int pyspeedy_fused_transform_hires(int kind, int mode, int count, int il, int ix,
                                              int mx, int nx, const void* const* tables,
                                              const long long* desc, void* scratch,
                                              void* stream) {
  if (count <= 0) return 0;
  if (mode < 0 || mode > 1 || kind < 0 || kind > 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape_of(il, ix, mx, nx)) {
    case 47:
      return mode == 0 ? run<T47, float>(kind, count, tables, desc, scratch, s)
                       : run<T47, double>(kind, count, tables, desc, scratch, s);
    case 63:
      return mode == 0 ? run<T63, float>(kind, count, tables, desc, scratch, s)
                       : run<T63, double>(kind, count, tables, desc, scratch, s);
    default:
      return -2;
  }
}
