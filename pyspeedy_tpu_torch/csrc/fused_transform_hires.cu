// The fused spectral transforms at T47 (il 72, ix 144, mx 48, nx 49) and T63
// (il 96, ix 192, mx 64, nx 65) for NVIDIA Hopper (sm_90a): the zonal DFT and
// the Legendre transform of a group of fields. Each direction is one kernel
// launched on thread-block clusters, its DFT and its Legendre sums on
// different warps of a block and on successive steps; the inverse is the
// direct one's mirror image.
//
// Replaces, at these shapes, the two Pallas experiments of the JAX package
// that csrc/fused_transform.cu replaces at T30:
//   tools/exp_fused_transform.py:65  fused_grid2spec  (pallas_call at :102)
//   tools/exp_fused_transform.py:121 fused_spec2grid  (pallas_call at :143)
// Both read il, mx and nx from the tables they are given; the JAX package runs
// T47 and T63 through einsums (its dense size gate). On the card those are
// cuBLAS products whose rounding may follow the batch width, which these
// kernels do not. The plain version at these shapes is that einsum chain
// (ops/transform_kernels.py); the wrappers are there too. They read the Plan
// below through pyspeedy_fused_transform_hires_plan; the decomposition's two
// choices (blocks a cluster, rows a step) are also in
// ops/transform_kernels.py::hires_cluster_plan for the CPU model of it, and
// the card's tests hold the two against each other.
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
// "discard" rule). float and double; the direct kernel also reads a bfloat16
// grid (the bf16_tendencies configuration) against float or double tables:
// it widens each value to the tables' type where its products read it, so
// that instantiation is, bit for bit, the one of the tables' type fed the
// widened grid, which is the JAX package's transform of a bfloat16 grid
// off its dense route (ops/spectral.py::grid2spec_p widens, then the
// ordinary transform). Its grid rows come in by 16-byte cp.async only (the
// wrapper refuses a bfloat16 grid it cannot address so), half the bytes of
// float, into a staging area of their own element type and pitch.
//
// The cluster design. The folded Legendre table is 172 / 344 KB (T47, float
// / double) and 402 / 804 KB (T63), above the 227 KB a block can hold, and
// the transform factorises: a DFT a latitude over all m, then a Legendre sum
// an m over all latitudes. So a cluster of C blocks (Plan::C: 4, and 8 for
// T63 in double) takes R field rows at a time (2 direct; the inverse 4 at
// T47 in float, 2 elsewhere), persistent over the rows, and splits them
// both ways:
//   * by latitude: block b owns the band of NP = (il/2)/C mirror pairs
//     b NP .. (b+1) NP - 1, both hemispheres (so the hemispheric sums
//     F[j] +- F[il-1-j] form inside a thread);
//   * by wavenumber: block r owns K = mx/(2C) m from r K and their mirrors
//     mx - 1 - m, whose triangle rows hold 2 nx - mx + 1 entries whatever m,
//     so every block sums the same work. Its slice of the Legendre table
//     stays in its shared memory for the kernel's life.
// hires_direct_cluster_kernel: warp-specialised. The DFT warps of block r
//   copy the band's rows of a step in by cp.async (16-byte chunks where
//   aligned; two buffers where they fit, the next step's in flight), run
//   the folded DFT on the tensor cores, one warp a (parity, 16 wavenumber
//   columns) tile over all the band's (row, pair, hemisphere) columns, and
//   each thread stores the hemispheric sums and differences of its
//   accumulators straight into the shared memory of the block that owns
//   their m (distributed shared memory, two buffers by the step's parity).
//   One step behind them, the Legendre warps (four; two at T47 in float,
//   where two blocks share an SM) sum the block's entries over all il/2
//   pairs for every row of the step (a thread a few entries, the table and
//   the Fourier values read as 16-byte vectors), stage the pairs
//   in the buffer they have just read, each of the block's two runs of m
//   (nx values a row, the zeros past the triangle among them) shifted to
//   the alignment of its destination, and store the runs as 16-byte
//   vectors.
// hires_inverse_ws_kernel: the mirror image, warp-specialised. Four Legendre
//   warps of block r: a thread sums E (even n) or O (odd n) of an m pair for
//   a few latitude pairs and all rows of a step (the spectral values held by
//   the parity of n, read as vectors), swaps with its partner lane, and
//   writes F = E + O (south) and E - O (north) into the shared memory of the
//   band's owner (0 for the imaginary part of m = 0), a pair's rows as
//   16-byte vectors; the DFT warps of every block run the folded inverse DFT
//   of their band on the tensor cores, a warp a (16 longitudes, parity)
//   tile, one step behind the Legendre warps, stage Pe and Po of the step's
//   rows and store g[i] = Pe + Po, g[i + ix/2] = Pe - Po (scaled by
//   1/cos(lat) where the field's flag says so) as 16-byte vectors.
// The Fourier intermediate never reaches device memory: it lives in the
// receiving block's shared memory for one step, double-buffered by the
// step's parity, and the two halves of one cluster barrier a step order both
// the exchange and the buffers' reuse (see each kernel).
//
// The products on the tensor cores, A the DFT table (kept in registers for
// the kernel's life, loaded once), B the band's data (M 16 wavenumber columns
// direct or longitudes inverse, N the band's columns, K the longitudes direct
// or wavenumber columns inverse):
//   double: mma.sync m16n8k4 on the FP64 tensor cores (DMMA);
//   float:  3xTF32, mma.sync m16n8k8: each operand x split into
//           hi = tf32(x) and lo = tf32(x - hi), D += lo.hi + hi.lo + hi.hi in
//           float (the lo.lo term, 2^-22 of a product, dropped), which holds
//           the 1e-5 agreement that one TF32 product (2^-11) would not.
// The Legendre sums stay on the CUDA cores (15 % of the work).
//
// Every output element is one fixed-order sum: the MMA's k order is the
// table's, a row is always its own MMA columns and nobody else's, the
// Legendre sums run over the pairs (or n) in ascending order inside one
// thread, the exchange places values and adds nothing, and there are no
// atomics. Which cluster takes a row, and which row shares its step, change
// no bit: a member alone is bitwise the same member in any batch, and a group
// equals its fields launched one by one.
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s float and 34 TFLOP/s
// double outside the tensor cores, 67 TFLOP/s double on DMMA, 495 TFLOP/s
// TF32, a third of that for 3xTF32): a T63 row reads 73.7 KB of grid and
// writes 33.3 KB of pair in float (32 ns at the memory rate), and the folded
// work is il mx ix + il triangle multiply-adds, 1.39 M a row (41 ns at the
// float peak outside the tensor cores; 85 % of it is DFT, which the tensor
// cores take at 14 ns in 3xTF32). So on the tensor cores the bytes bind, in
// both types, at both shapes. What holds the kernels at 25-35 % of that on
// the card (PERF.md): a block is alone on its SM but at T47 in float, and
// the tensor-core products (three mma.sync a 3xTF32 product, two or three
// DFT warps an SMSP) issue well below their peak. In the direct kernel's
// serial schedule (clock64 spans of a scratch build, T63 float, the step's
// direct group at 128 members on an H100) a step was 52 % DFT and remote
// stores, 37 % Legendre sums and 4-byte stores and 10 % cluster barrier, one
// after the other; warp specialisation overlaps the two stages (9-25 %
// less time in every instantiation, 23 % at T63 float), and the step is now
// the DFT warps' (in a scratch build, their products' loop took 11.8k cycles
// of a 13.6k step while the Legendre warps waited 1.6k for them). More
// registers for the DFT warps (setmaxnreg), more Legendre warps and a grid
// folded once before the products each moved nothing. The inverse's steps
// (clock64 spans, PERF.md) wait on its DFT warps' products and stores, its
// Legendre warps' sums and their remote stores, and the barrier between the
// two. A bfloat16 grid halves the grid's bytes, which moves the bound little
// where the folded work binds (outside the tensor cores: T63, and T47 in
// double) and leaves the kernel about where the kernel of the tables' type
// is on the widened grid (PERF.md).
//
// Interface: plain C, loaded with ctypes. The launches go to the stream they
// are given, allocate nothing and do not synchronise; the function returns
// cudaGetLastError() (0 on success) or a negative code for arguments the
// kernels were not built for.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSeg = 16;
constexpr int kSegWords = 11;        // int64 words of one segment descriptor
constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may use

template <int IL_, int IX_, int MX_, int NX_>
struct Shape {
  static constexpr int IL = IL_, IX = IX_, MX = MX_, NX = NX_;
  static constexpr int IY = IL / 2, IH = IX / 2, H = (MX + 1) / 2, COLS = 2 * H;
  static constexpr int TRI = MX * NX - MX * (MX - 1) / 2;   // m + n <= nx - 1
  static constexpr int DFT = 2 * IH * COLS;                 // folded DFT table
  static constexpr int LEG = IY * TRI;                      // folded Legendre table
  static_assert(MX % 2 == 0 && IX % 2 == 0 && COLS % 16 == 0, "the tiles of these kernels");
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
// What to add to a to reach b modulo m, in 0 .. m-1.
constexpr int pad_to(int a, int b, int m) { return ((b - a % m) % m + m) % m; }
// The least pitch >= n (elements) of a Fourier column of the products' B
// operand that puts a warp's loads (four k rows at once) on distinct banks:
// 8 or 24 mod 32 words in float, 4 or 12 mod 16 doubles in double.
constexpr int mma_pitch(int n, bool f64) {
  const int m = f64 ? 16 : 32, a = f64 ? 4 : 8, b = f64 ? 12 : 24;
  while (n % m != a && n % m != b) ++n;
  return n;
}
// The fewest latitude pairs an item of the warp-specialised inverse's
// Legendre stage sums (a divisor of iy) so that its k m pairs x 2 n
// parities x iy / svw items take at most `threads` threads.
constexpr int leg_svw(int iy, int k, int threads) {
  int svw = 1;
  while (svw < iy && (iy % svw != 0 || k * (iy / svw) * 2 > threads)) ++svw;
  return svw;
}

// The wavenumbers of a block: block r of a cluster owns the k lowest m from
// r k and their mirrors mx - 1 - m, whose triangle rows together hold
// 2 nx - mx + 1 entries whatever m, so every block sums the same work. Local
// index ml < k: m = r k + ml; ml >= k: m = mx - (r + 1) k + ml - k (both
// runs ascending in m).
__host__ __device__ constexpr int slice_m(int r, int ml, int k, int mx) {
  return ml < k ? r * k + ml : mx - (r + 1) * k + (ml - k);
}
__host__ __device__ constexpr int owner_of(int m, int k, int mx) {
  return (m < mx - 1 - m ? m : mx - 1 - m) / k;
}
__host__ __device__ constexpr int local_of(int m, int k, int mx) {
  return m < mx - 1 - m ? m - owner_of(m, k, mx) * k
                        : k + m - (mx - (owner_of(m, k, mx) + 1) * k);
}

// The cluster plan of a shape, the tables' type T and the direct kernel's
// grid type G (pyspeedy_fused_transform_hires_plan reports it).
template <class S, typename T, typename G = T>
struct Plan {
  static constexpr bool F64 = sizeof(T) == 8;
  static constexpr int C = (F64 && S::IL == 96) ? 8 : 4;   // blocks a cluster
  static constexpr int K = S::MX / (2 * C);                // m pairs of a block
  static constexpr int MS = 2 * K;                         // m of a block
  static constexpr int ENT = K * (2 * S::NX - S::MX + 1);  // triangle entries of a block
  static constexpr int NP = S::IY / C;                     // mirror pairs of a band
  static constexpr int NB = 2 * NP;                        // latitudes of a band
  static constexpr int R = 2;                              // rows a cluster step
  static constexpr int NPAD = (R * NB + 7) / 8 * 8;        // MMA columns: (row, pair, hemisphere)
  static constexpr int NT = NPAD / 8;                      // n tiles
  static constexpr int KS = F64 ? 4 : 8;                   // MMA depth
  static constexpr int VW = 16 / static_cast<int>(sizeof(T));   // a 16-byte vector
  static constexpr int GS = static_cast<int>(sizeof(G));
  // The pitch, in elements of G, of a grid row that puts the B fragments'
  // loads on distinct banks: 4 mod 32 words (float) / 4 mod 16 doubles; for
  // bfloat16, 8 mod 64 elements (4 mod 32 words, a lane's 4 k values in 2),
  // which also keeps each row's 16-byte chunks aligned.
  static constexpr int GP = GS == 2 ? S::IX + pad_to(S::IX, 8, 64)
                                    : S::IX + pad_to(S::IX, 4, F64 ? 16 : 32);
  static constexpr int MT_DIR = S::COLS / 16;              // column tiles of a parity
  static constexpr int MT_INV = (S::IH + 15) / 16;         // longitude tiles
  static constexpr int KS_DIR = S::IH / KS, KS_INV = S::COLS / KS;
  // Direct (hires_direct_cluster_kernel): DIR_DFT_WARPS warps of the DFT, a
  // (parity, 16 wavenumber columns) tile each, a step ahead of DIR_LEG_WARPS
  // warps of the Legendre sums. Its shared memory: the block's Legendre table
  // (il/2 / VW, ENT, VW), the Fourier values it receives (2 buffers, R rows,
  // MS, c, sum / difference, il/2), in which the Legendre warps also stage
  // their pairs for the stores once they have read them, and the band's grid
  // rows (GBUF buffers, NPAD, GP, in G). Two blocks an SM where two fit with
  // one grid buffer each (1 KB of each block is the system's; T47 in float),
  // each with two Legendre warps, so that the 8 warps of a block keep 128
  // registers a thread; else one block of four Legendre warps, with two grid
  // buffers where they fit, the next step's rows copied in while these are
  // transformed.
  static constexpr int XROW = MS * 4 * S::IY;
  static constexpr int D_SL = S::IY * ENT, D_ROWS = NPAD * GP;
  static constexpr int D_TAB = static_cast<int>(sizeof(T)) * (D_SL + 2 * R * XROW);   // bytes
  static constexpr size_t dir_smem(int gbuf) {
    return static_cast<size_t>(D_TAB) + static_cast<size_t>(GS) * gbuf * D_ROWS;
  }
  static constexpr int DIR_MINB = 2 * (dir_smem(1) + 1024) <= 233472 ? 2 : 1;   // blocks an SM
  static constexpr int GBUF = DIR_MINB == 1 && dir_smem(2) <= kSmemLimit ? 2 : 1;
  static constexpr size_t DIR_SMEM = dir_smem(GBUF);
  static constexpr int DIR_DFT_WARPS = 2 * MT_DIR, DIR_LEG_WARPS = DIR_MINB == 2 ? 2 : 4;
  static constexpr int DIR_THREADS = 32 * (DIR_DFT_WARPS + DIR_LEG_WARPS);
  // The staged pairs of a step: (row, c, run of the K low m / of the K
  // mirrors), each run's K nx values (zeros past the triangle included)
  // shifted by up to VW - 1 so that they align with their destination.
  static constexpr int RUN = K * S::NX, RUNP = (RUN + 2 * (VW - 1)) / VW * VW;
  // Inverse (hires_inverse_ws_kernel): INV_DFT_WARPS warps of the DFT, a
  // (parity, 16 longitudes) tile each, and INV_LEG_WARPS warps of the
  // Legendre stage, one item (m pair, INV_SVW latitude pairs, n parity) a
  // thread. INV_R rows a cluster step (4 at T47 in float, where they fit,
  // else 2); MMA columns (pair, row, hemisphere: a pair's 2 INV_R values
  // contiguous) and n tiles; the Fourier column pitch (mma_pitch). Its
  // shared memory: the block's table (ENT, il/2), its spectral values (2
  // buffers, INV_R rows, c, MS, n parity, NH: the even n, then the odd ones,
  // each run padded to whole 16-byte vectors), the band's Fourier values (2
  // buffers, parity, COLS, INV_FP), INV_SR rows' Pe and Po staged for the
  // stores (by longitude tile: row, parity, NB, INV_LP) and the band's
  // 1/cos(lat).
  static constexpr int INV_DFT_WARPS = 2 * MT_INV, INV_LEG_WARPS = 4;
  static constexpr int INV_THREADS = 32 * (INV_DFT_WARPS + INV_LEG_WARPS);
  static constexpr int INV_SVW = leg_svw(S::IY, K, 32 * INV_LEG_WARPS);
  static constexpr int INV_ITEMS = K * (S::IY / INV_SVW) * 2;
  static constexpr int INV_R = (S::IL == 72 && !F64) ? 4 : 2;
  static constexpr int INV_NPAD = (INV_R * NB + 7) / 8 * 8, INV_NT = INV_NPAD / 8;
  static constexpr int INV_FP = mma_pitch(INV_NPAD, F64);
  static constexpr int NH = ((S::NX + 1) / 2 + VW - 1) / VW * VW;
  static constexpr int PROW = 2 * MS * 2 * NH;
  static constexpr int I_SL = ENT * S::IY, I_P = 2 * INV_R * PROW, I_FIN = 4 * S::COLS * INV_FP;
  static constexpr int INV_LP = 16 + (F64 ? 2 : 4);
  static constexpr size_t inv_smem(int sr) {
    return sizeof(T) * (I_SL + I_P + I_FIN + MT_INV * sr * 2 * NB * INV_LP + NB);
  }
  // Rows staged at once: the step's where they fit, else one.
  static constexpr int INV_SR = inv_smem(INV_R) <= kSmemLimit ? INV_R : 1;
  static constexpr int I_STAGE = MT_INV * INV_SR * 2 * NB * INV_LP;
  static constexpr size_t INV_SMEM = inv_smem(INV_SR);
  static_assert(S::IY % C == 0 && S::IY % VW == 0 && S::MX % (2 * C) == 0, "bands and slices");
  static_assert(S::IH % KS == 0 && S::COLS % KS == 0, "MMA depth");
  static_assert(DIR_SMEM <= kSmemLimit && INV_SMEM <= kSmemLimit, "shared memory of a block");
  static_assert(S::IH % VW == 0, "vectors of a row");
  static_assert(D_TAB % 16 == 0 && (GP * GS) % 16 == 0, "16-byte chunks of the grid rows");
  static_assert(4 * RUNP <= XROW && RUNP % VW == 0,
                "the staged pairs of a row in its Fourier values");
  static_assert(INV_ITEMS <= 32 * INV_LEG_WARPS && S::IY % INV_SVW == 0, "Legendre items");
  static_assert((I_SL + I_P) % VW == 0 && INV_FP % VW == 0 && (2 * INV_R) % VW == 0,
                "16-byte vectors of a pair's Fourier values");
};

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

template <bool B>
struct Flag {
  static constexpr bool value = B;
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

// The input of row lr of segment s (elements of its (il, ix) grid or of its
// real part), and the output, the row split into member and row of the
// member in int (a group holds fewer than 2^31 rows: read_group checks).
template <typename T>
__device__ __forceinline__ const T* row_in(const Segment& s, long long lr) {
  const int r = static_cast<int>(lr), b = r / s.per_member, kk = r - b * s.per_member;
  return static_cast<const T*>(s.in) + b * s.in_member + kk * s.in_row;
}
template <typename T>
__device__ __forceinline__ T* row_out(const Segment& s, long long lr) {
  const int r = static_cast<int>(lr), b = r / s.per_member, kk = r - b * s.per_member;
  return static_cast<T*>(s.out) + b * s.out_member + kk * s.out_row;
}

// ---------------------------------------------------------------------------
// Device primitives: cp.async, the tensor-core products
// ---------------------------------------------------------------------------

// cp.async: 16-byte chunks bypassing L1, or single elements (4 or 8 bytes)
// through L1; completed by cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32 (to nearest, ties away), as the bits of a float: the
// bits of cvt.rna.tf32.f32 for every finite x, by integer arithmetic on x's
// bits, without the conversion unit's narrow issue rate.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// D += A . B, m16n8k8, TF32 operands, float accumulation: a0 = A[g][t],
// a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4], b0 = B[t][g],
// b1 = B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1] for
// lane 4g + t.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// x split for 3xTF32: hi = x rounded to TF32 (tf32_rna), lo = x - hi (exact
// in float) with its low 13 bits dropped.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
// The two halves of a cluster barrier, each thread alternating them: arrive
// (release: this thread's stores, remote ones too, before it) and wait
// (acquire: until every thread of the cluster has arrived).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
// arrive without release: for a thread whose stores others need not see.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// Barrier `id` (not 0, __syncthreads' own) over `count` threads of the block,
// whole warps.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// D += A . B on the FP64 tensor cores, m16n8k4: a0 = A[g][t], a1 = A[g+8][t],
// b = B[t][g]; d as above.
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1, double b) {
  asm(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// ---------------------------------------------------------------------------
// A fragments of the DFT table (in registers) and one step of a product
// ---------------------------------------------------------------------------

template <typename T, int K>
struct AFrags;
template <int K>
struct AFrags<float, K> {   // 3xTF32: the high and low TF32 parts
  uint32_t hi[K][4], lo[K][4];
  __device__ __forceinline__ void set(int ks, float v0, float v1, float v2, float v3) {
    const float v[4] = {v0, v1, v2, v3};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[ks][q] = tf32_rna(v[q]);
      lo[ks][q] = tf32_rna(v[q] - __uint_as_float(hi[ks][q]));
    }
  }
};
template <int K>
struct AFrags<double, K> {
  double v[K][2];
  __device__ __forceinline__ void set(int ks, double v0, double v1, double, double) {
    v[ks][0] = v0;
    v[ks][1] = v1;
  }
};

// acc[nt] += A(k step ks) . B[nt] for the NT n tiles, B[nt] given by this
// lane's values b0[nt], b1[nt] (b1 unused in double). A tile's three 3xTF32
// products add in the order lo.hi, hi.lo, hi.hi; the tiles interleave, so
// consecutive products are independent. Both parts of B are rounded to
// nearest (tf32_rna), or with SPLIT split by split_tf32 (lo truncated).
template <int NT, int K, bool SPLIT = false>
__device__ __forceinline__ void mma_step(float (&acc)[NT][4], const AFrags<float, K>& a, int ks,
                                         const float (&b0)[NT], const float (&b1)[NT]) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if constexpr (SPLIT) {
      split_tf32(b0[nt], bh[nt][0], bl[nt][0]);
      split_tf32(b1[nt], bh[nt][1], bl[nt][1]);
    } else {
      bh[nt][0] = tf32_rna(b0[nt]);
      bh[nt][1] = tf32_rna(b1[nt]);
      bl[nt][0] = tf32_rna(b0[nt] - __uint_as_float(bh[nt][0]));
      bl[nt][1] = tf32_rna(b1[nt] - __uint_as_float(bh[nt][1]));
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], a.lo[ks], bh[nt]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], a.hi[ks], bl[nt]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], a.hi[ks], bh[nt]);
}
template <int NT, int K, bool SPLIT = false>
__device__ __forceinline__ void mma_step(double (&acc)[NT][4], const AFrags<double, K>& a, int ks,
                                         const double (&b0)[NT], const double (&)[NT]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_f64(acc[nt], a.v[ks][0], a.v[ks][1], b0[nt]);
}

// ---------------------------------------------------------------------------
// Direct transform: grid rows -> spectral pairs
// ---------------------------------------------------------------------------

// A grid value of type G in the tables' type T: bfloat16 widened (exactly),
// any other type as it is.
template <typename T, typename G>
__device__ __forceinline__ T widen(G x) {
  if constexpr (sizeof(G) == 2)
    return static_cast<T>(__bfloat162float(x));
  else
    return x;
}
template <typename G>
__device__ __forceinline__ G zero_of() {
  if constexpr (sizeof(G) == 2)
    return __ushort_as_bfloat16(static_cast<unsigned short>(0));
  else
    return G(0);
}

// T: the tables' type, in which everything is computed and stored; G: the
// grid's (T, or bfloat16).
//
// The DFT warps of every block transform step u + 1's rows while its
// Legendre warps sum step u's: F goes into the owners' buffer u % 2, and the
// two halves of the cluster barrier order the buffers. Phase u completes
// once every DFT thread has stored F of step u (it arrives, with release,
// after its stores) and every Legendre thread is done with step u - 1's
// buffer (it arrives, relaxed, after the stores of step u - 1, which read
// back the pairs staged there: its last use of the buffer); a DFT thread
// waits for phase u - 1 before it stores F of step u into buffer u % 2, which
// step u - 2 was the last to use, and a Legendre thread waits for phase u
// before it sums step u. Each role keeps a named barrier of its own: the DFT
// warps copy the band's grid rows in by cp.async (two buffers where they
// fit, the next step's in flight), the Legendre warps stage a step's pairs in
// the buffer they have just read, each row's runs of n and the zeros past the
// triangle, and store them as 16-byte vectors.
template <class S, typename T, typename G>
__global__ void __launch_bounds__(Plan<S, T, G>::DIR_THREADS, Plan<S, T, G>::DIR_MINB)
hires_direct_cluster_kernel(const __grid_constant__ Group g, long long rows) {
  using P = Plan<S, T, G>;
  constexpr int C = P::C, K = P::K, MS = P::MS, NP = P::NP, NB = P::NB, R = P::R;
  constexpr int NPAD = P::NPAD, NT = P::NT, KS = P::KS, VW = P::VW, GP = P::GP;
  constexpr int ENT = P::ENT, XROW = P::XROW, KSTEPS = P::KS_DIR;
  constexpr int RUN = P::RUN, RUNP = P::RUNP, NVR = RUNP / VW;
  constexpr int ND = 32 * P::DIR_DFT_WARPS, NL = 32 * P::DIR_LEG_WARPS;
  constexpr int kDftBar = 1, kLegBar = 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long cid = blockIdx.x / C, ncl = gridDim.x / C;
  const long long units = (rows + R - 1) / R;          // R rows a cluster step

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sL = reinterpret_cast<T*>(smem_raw);   // (il/2 / VW, ENT, VW)
  T* xin = sL + P::D_SL;                    // (2, R, MS, c, sd, il/2)
  // (GBUF, NPAD, GP): slot NB rr + 2 pp + hemisphere
  G* sG = reinterpret_cast<G*>(smem_raw + P::D_TAB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = rank * NP;
  // The block's triangle entries: the rows of its K low m, then of their mirrors.
  const int t_lo = tri_offset(rank * K, S::NX), t_hi = tri_offset(S::MX - (rank + 1) * K, S::NX);
  const int e_lo = tri_offset((rank + 1) * K, S::NX) - t_lo;

  // The block's Legendre table, resident; the pad slots of the band zero;
  // every block of the cluster runs before any remote store.
  const T* leg = static_cast<const T*>(g.tables) + S::DFT;   // (il/2, triangle)
  for (int idx = tid; idx < S::IY * ENT; idx += P::DIR_THREADS) {
    const int p = idx / ENT, el = idx - p * ENT;
    const int e = el < e_lo ? t_lo + el : t_hi + el - e_lo;
    sL[((p / VW) * ENT + el) * VW + p % VW] = leg[p * S::TRI + e];
  }
  for (int bf = 0; bf < P::GBUF; ++bf)
    for (int idx = tid; idx < (NPAD - R * NB) * GP; idx += P::DIR_THREADS)
      sG[bf * P::D_ROWS + R * NB * GP + idx] = zero_of<G>();
  cluster.sync();

  if (warp < P::DIR_DFT_WARPS) {
    // --- The DFT warps: this warp's tile, parity par, wavenumber columns
    // col_a = 16 mt + g and col_b = col_a + 8 (col = c h + q for
    // m = 2q + par); the table's A fragments, A[col][i] = dft_fwd[par][i][col].
    const int gq = lane >> 2, tq = lane & 3;
    const int par = warp / P::MT_DIR, mt = warp - par * P::MT_DIR;
    const int col_a = 16 * mt + gq;
    const T* dfwd = static_cast<const T*>(g.tables) + par * S::IH * S::COLS;
    AFrags<T, KSTEPS> a;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int k = ks * KS + tq;
      if constexpr (sizeof(T) == 4)
        a.set(ks, dfwd[k * S::COLS + col_a], dfwd[k * S::COLS + col_a + 8],
              dfwd[(k + 4) * S::COLS + col_a], dfwd[(k + 4) * S::COLS + col_a + 8]);
      else
        a.set(ks, dfwd[k * S::COLS + col_a], dfwd[k * S::COLS + col_a + 8], T(0), T(0));
    }
    // Where this thread's Fourier values go: the block owning their m, at
    // (local m, c) in its receive buffers.
    T* xdst[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = col_a + 8 * half;
      const int c = col / S::H, m = 2 * (col - c * S::H) + par;
      xdst[half] = cluster.map_shared_rank(xin, owner_of(m, K, S::MX)) +
                   (local_of(m, K, S::MX) * 2 + c) * 2 * S::IY;
    }
    // The band's grid rows of a unit's rows into buffer `buf`: slot NB rr + 2 pp
    // (south, latitude p0 + pp) and NB rr + 2 pp + 1 (north, il - 1 - p0 - pp).
    auto issue = [&](long long unit, int buf) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const long long row = unit * R + rr;
        if (row >= rows) break;
        const Segment& s = g.seg[find_segment(g, row)];
        const G* src = row_in<G>(s, row - s.first);
        G* dst = sG + buf * P::D_ROWS + rr * NB * GP;
        if (sizeof(G) == 2 || s.aligned) {   // bfloat16: always (run checks)
          constexpr int CH = S::IX * static_cast<int>(sizeof(G)) / 16;
          for (int q = tid; q < NB * CH; q += ND) {
            const int n = q / CH, ch = q - n * CH;
            const int lat = (n & 1) ? S::IL - 1 - (p0 + (n >> 1)) : p0 + (n >> 1);
            cp_async16(reinterpret_cast<unsigned char*>(dst + n * GP) + 16 * ch,
                       reinterpret_cast<const unsigned char*>(src + lat * S::IX) + 16 * ch);
          }
        } else if constexpr (sizeof(G) != 2) {
          for (int q = tid; q < NB * S::IX; q += ND) {
            const int n = q / S::IX, i = q - n * S::IX;
            const int lat = (n & 1) ? S::IL - 1 - (p0 + (n >> 1)) : p0 + (n >> 1);
            cp_async_elem(dst + n * GP + i, src + lat * S::IX + i);
          }
        }
      }
    };
    long long unit = cid;
    if (unit < units) issue(unit, 0);
    cp_async_commit();
    int steps = 0;
    for (int s = 0; unit < units; unit += ncl, s ^= 1, ++steps) {
      cp_async_wait_all();
      named_sync(kDftBar, ND);   // this step's rows are in; the other buffer is read
      const G* gb = sG + (P::GBUF == 2 ? s : 0) * P::D_ROWS;
      if (P::GBUF == 2 && unit + ncl < units) issue(unit + ncl, s ^ 1);
      cp_async_commit();

      // The folded DFT of the band: F[col][slot] = sum_i fold_par[slot][i] A[col][i],
      // fold_0 = g[i] + g[i + ix/2], fold_1 = g[i] - g[i + ix/2].
      T acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = T(0);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        T b0[NT], b1[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const G* r = gb + (nt * 8 + gq) * GP + ks * KS + tq;
          const T u0 = widen<T>(r[0]), v0 = widen<T>(r[S::IH]);
          b0[nt] = par ? u0 - v0 : u0 + v0;
          b1[nt] = T(0);
          if constexpr (sizeof(T) == 4) {
            const T u1 = widen<T>(r[4]), v1 = widen<T>(r[S::IH + 4]);
            b1[nt] = par ? u1 - v1 : u1 + v1;
          }
        }
        mma_step(acc, a, ks, b0, b1);
      }
      if (P::GBUF == 1) {
        named_sync(kDftBar, ND);   // the band's grid rows are read
        if (unit + ncl < units) issue(unit + ncl, 0);
        cp_async_commit();
      }
      // acc[nt] = F[col_a][south, north], F[col_b][south, north] of slot pair
      // 8 nt + 2 t: the hemispheric sums (n even) and differences (n odd) into
      // the owner's buffer s (rows past the group's end are never read), once
      // the Legendre warps are done with it.
      if (steps > 0) cluster_wait();
      const int xoff = s * R * XROW;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n0 = nt * 8 + 2 * tq;
        if (n0 < R * NB) {
          const int rr = n0 / NB, pp = (n0 - rr * NB) >> 1;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const T south = acc[nt][2 * half], north = acc[nt][2 * half + 1];
            T* d = xdst[half] + xoff + rr * XROW + p0 + pp;
            d[0] = south + north;
            d[S::IY] = south - north;
          }
        }
      }
      cluster_arrive();   // this step's Fourier values are stored
    }
    if (steps > 0) cluster_wait();
  } else {
    // --- The Legendre warps: thread lt sums entries lt, lt + NL, ... of the
    // block's slice, for every row of a step, and stages them. Per entry:
    // its Fourier values' offset in a row's buffer ((local m, c = 0, parity
    // of n), il/2), its place in its run ((K low m, or their mirrors) x nx)
    // and that run's first element m_first nx, modulo VW.
    const int lt = tid - ND;
    constexpr int EPT = (ENT + NL - 1) / NL, FULL = ENT / NL;
    int xo[EPT], so[EPT], mo[EPT];
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int el = u < FULL || lt + u * NL < ENT ? lt + u * NL : 0;
      const int e = el < e_lo ? t_lo + el : t_hi + el - e_lo;
      const int m = m_of_entry(e, S::NX), n = e - tri_offset(m, S::NX);
      const int ml = local_of(m, K, S::MX), run = ml >= K ? 1 : 0;
      xo[u] = (ml * 4 + (n & 1)) * S::IY;
      so[u] = run * RUNP + (ml - run * K) * S::NX + n;
      mo[u] = (slice_m(rank, run * K, K, S::MX) * S::NX) % VW;
    }
    long long unit = cid;
    if (unit < units) cluster_arrive_relaxed();   // phase 0: no buffer used yet
    for (int s = 0; unit < units; unit += ncl, s ^= 1) {
      // The step's rows: their pairs, and where each part starts modulo VW.
      T* out[R];
      long long opair[R];
      int bmod[R][2];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const long long row = unit * R + rr;
        out[rr] = nullptr;
        opair[rr] = 0;
        if (row < rows) {
          const Segment& sg = g.seg[find_segment(g, row)];
          out[rr] = row_out<T>(sg, row - sg.first);
          opair[rr] = sg.out_pair;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
          bmod[rr][c] = static_cast<int>(
              (reinterpret_cast<uintptr_t>(out[rr] + c * opair[rr]) / sizeof(T)) % VW);
      }
      cluster_wait();   // every block's Fourier values of this step are in

      // The Legendre sums of the thread's entries, every row of the step:
      // S[c][m][n] = sum_p L[p][e] X[m][c][n & 1][p], p ascending.
      T* xs = xin + s * R * XROW;
      T sum[EPT][R][2];
#pragma unroll
      for (int u = 0; u < EPT; ++u)
#pragma unroll
        for (int rr = 0; rr < R; ++rr) sum[u][rr][0] = sum[u][rr][1] = T(0);
#pragma unroll
      for (int pv = 0; pv < S::IY / VW; ++pv) {
#pragma unroll
        for (int u = 0; u < EPT; ++u) {
          if (u < FULL || lt + u * NL < ENT) {
            const Vec<T, VW> lv = load_vec<T, VW>(sL + (pv * ENT + lt + u * NL) * VW);
#pragma unroll
            for (int rr = 0; rr < R; ++rr)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const Vec<T, VW> xv =
                    load_vec<T, VW>(xs + xo[u] + rr * XROW + c * 2 * S::IY + pv * VW);
#pragma unroll
                for (int v = 0; v < VW; ++v) sum[u][rr][c] += lv.v[v] * xv.v[v];
              }
          }
        }
      }
      named_sync(kLegBar, NL);   // buffer s is read: the pairs go there
      // Run element j of (row, c, run) at (row 2 + c) 2 RUNP + run RUNP +
      // shift + j, shift the run's first element modulo VW.
#pragma unroll
      for (int u = 0; u < EPT; ++u)
        if (u < FULL || lt + u * NL < ENT)
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
            if (out[rr])
#pragma unroll
              for (int c = 0; c < 2; ++c)
                xs[(rr * 2 + c) * 2 * RUNP + so[u] + (bmod[rr][c] + mo[u]) % VW] = sum[u][rr][c];
      named_sync(kLegBar, NL);
      // Each run of each row and part, the zeros past the triangle
      // (m + n >= nx) included, as 16-byte vectors where whole.
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        if (!out[rr]) continue;
        for (int q = lt; q < 4 * NVR; q += NL) {
          const int cr = q / NVR, vq = q - cr * NVR, c = cr >> 1, run = cr & 1;
          const int mf = slice_m(rank, run * K, K, S::MX);
          T* dst = out[rr] + c * opair[rr] + mf * S::NX;
          const int j0 =
              vq * VW - static_cast<int>((reinterpret_cast<uintptr_t>(dst) / sizeof(T)) % VW);
          Vec<T, VW> x = load_vec<T, VW>(xs + (rr * 4 + cr) * RUNP + vq * VW);
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            const int j = j0 + v, mr = j / S::NX;
            if (j >= 0 && j < RUN && j - mr * S::NX + mf + mr >= S::NX) x.v[v] = T(0);
          }
          if (j0 >= 0 && j0 + VW <= RUN) {
            *reinterpret_cast<Vec<T, VW>*>(dst + j0) = x;
          } else {
#pragma unroll
            for (int v = 0; v < VW; ++v)
              if (j0 + v >= 0 && j0 + v < RUN) dst[j0 + v] = x.v[v];
          }
        }
      }
      if (unit + ncl < units) cluster_arrive_relaxed();   // buffer s is free
    }
  }
}

// ---------------------------------------------------------------------------
// Inverse transform: spectral pairs -> grid rows, the direct kernel's
// decomposition with its two stages on different warps and steps
// ---------------------------------------------------------------------------
// The Legendre warps of every block compute step u + 1's Fourier values
// while the DFT warps transform step u's: F goes into the band owner's
// buffer u % 2, and the cluster barrier's two halves order the buffers. Phase u completes once every Legendre thread
// has stored F of step u (it arrives, with release, after its stores) and
// every DFT thread has read F of step u - 1 (it arrives, relaxed, right
// after its products, before it stages and stores that step's rows); a
// Legendre thread waits for phase u before it stores F of step u + 1 into
// buffer (u + 1) % 2, which step u - 1 was the last to read. Each half of
// the block keeps its own named barrier: the Legendre warps stage their
// spectral values by cp.async (two buffers, the next step's in flight), the
// DFT warps stage a row's Pe and Po in an area of their own before the
// 16-byte stores. The Legendre sums run in whole vectors of n without a
// test while they can (the rest with one), so their loads issue ahead of
// the multiply-adds; each step's spectral values are copied for the
// triangle only (n < nx - m), each thread its own fixed entries. The B
// operands of the float products are split by integer arithmetic
// (split_tf32), not by cvt. An inverse on clusters with one thread role and
// one cluster barrier a step measured slower than a pair of kernels with a
// scratch in float; on an H100 (clock64 spans of scratch builds, PERF.md)
// this design's steps were first bound by Legendre sums that kept their
// partial sums in local memory (indexed by the n parity), then by 4-byte
// copies of every (m, n) of the slice, then by the DFT warps' stores; what
// is above is what removed each.
template <class S, typename T>
__global__ void __launch_bounds__(Plan<S, T>::INV_THREADS, 1)
hires_inverse_ws_kernel(const __grid_constant__ Group g, long long rows) {
  using P = Plan<S, T>;
  constexpr int C = P::C, K = P::K, MS = P::MS, NP = P::NP, NB = P::NB, R = P::INV_R;
  constexpr int NT = P::INV_NT, KS = P::KS, VW = P::VW, SVW = P::INV_SVW, FP = P::INV_FP;
  constexpr int PROW = P::PROW, ENT = P::ENT, KSTEPS = P::KS_INV;
  constexpr int ND = 32 * P::INV_DFT_WARPS, NL = 32 * P::INV_LEG_WARPS;
  constexpr int PG = S::IY / SVW;   // items of pairs
  constexpr int LP = P::INV_LP;        // a staged slot's pitch
  constexpr int kLegBar = 1, kTileBar = 2;   // + the tile: the DFT warps of a tile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long cid = blockIdx.x / C, ncl = gridDim.x / C;
  const long long units = (rows + R - 1) / R;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sL = reinterpret_cast<T*>(smem_raw);   // (ENT, il/2)
  T* sP = sL + P::I_SL;                     // (2, R, c, MS, n parity, NH)
  T* fin = sP + P::I_P;                   // (2, parity, COLS, FP): slot NB rr + 2 pp + hemisphere
  T* stage = fin + P::I_FIN;              // (tile, row, parity, NB, LP): Pe, Po
  T* band_scale = stage + P::I_STAGE;       // (NB): 1/cos(lat) of the band's slots
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = rank * NP;
  const int t_lo = tri_offset(rank * K, S::NX), t_hi = tri_offset(S::MX - (rank + 1) * K, S::NX);
  const int e_lo = tri_offset((rank + 1) * K, S::NX) - t_lo;

  // The block's Legendre table, resident as (entry, pair); both Fourier
  // buffers zero (the pad slots stay so); every block of the cluster runs
  // before any remote store.
  const T* leg = static_cast<const T*>(g.tables);   // (il/2, triangle)
  for (int idx = tid; idx < ENT * S::IY; idx += P::INV_THREADS) {
    const int p = idx / ENT, el = idx - p * ENT;
    sL[el * S::IY + p] = leg[p * S::TRI + (el < e_lo ? t_lo + el : t_hi + el - e_lo)];
  }
  for (int idx = tid; idx < P::I_FIN; idx += P::INV_THREADS) fin[idx] = T(0);
  for (int q = tid; q < NB; q += P::INV_THREADS) {
    const int pp = q >> 1;
    band_scale[q] = static_cast<const T*>(g.scale)[(q & 1) ? S::IL - 1 - (p0 + pp) : p0 + pp];
  }
  cluster.sync();

  if (warp < P::INV_DFT_WARPS) {
    // --- The DFT warps: this warp's tile, parity par, longitudes i_a =
    // 16 mt + g and i_a + 8; A[i][col] = dft_inv[par][col][i], 0 past ix/2.
    const int gq = lane >> 2, tq = lane & 3;
    const int par = warp / P::MT_INV, mt = warp - par * P::MT_INV;
    const int ia = 16 * mt + gq;
    const T* dinv = static_cast<const T*>(g.tables) + S::LEG + par * S::COLS * S::IH;
    auto at = [&](int k, int i) -> T { return i < S::IH ? dinv[k * S::IH + i] : T(0); };
    AFrags<T, KSTEPS> a;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int k = ks * KS + tq;
      if constexpr (sizeof(T) == 4)
        a.set(ks, at(k, ia), at(k, ia + 8), at(k + 4, ia), at(k + 4, ia + 8));
      else
        a.set(ks, at(k, ia), at(k, ia + 8), T(0), T(0));
    }
    T* tstage = stage + mt * P::INV_SR * 2 * NB * LP;   // this tile's (row, parity, slot, LP)
    long long unit = cid;
    if (unit < units) cluster_arrive_relaxed();   // phase 0: no step read yet
    for (int s = 0; unit < units; unit += ncl, s ^= 1) {
      cluster_wait();     // every block's Fourier values of this step are in
      // The folded inverse DFT of the band, this warp's parity:
      // P_par[i][slot] = sum_col A[i][col] F[col][slot].
      const T* fs = fin + (s * 2 + par) * S::COLS * FP;
      T acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = T(0);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        T b0[NT], b1[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const T* b = fs + (ks * KS + tq) * FP + nt * 8 + gq;
          b0[nt] = b[0];
          b1[nt] = T(0);
          if constexpr (sizeof(T) == 4) b1[nt] = b[4 * FP];
        }
        mma_step<NT, KSTEPS, true>(acc, a, ks, b0, b1);
      }
      // Done with this step's Fourier values (the next phase, if any).
      if (unit + ncl < units) cluster_arrive_relaxed();
      // SR rows at a time (all of the step's where they fit), the two warps
      // of this longitude tile (both parities) alone: Pe and Po staged as
      // (row, parity, slot, longitude of the tile); then g[i] = Pe + Po,
      // g[i + ix/2] = Pe - Po, scaled where the field's flag says so, as
      // 16-byte vectors.
      constexpr int SR = P::INV_SR, CH = 16 / VW;   // CH: vectors of a tile's longitudes
#pragma unroll
      for (int r0 = 0; r0 < R; r0 += SR) {
        if (unit * R + r0 >= rows) break;
        named_sync(kTileBar + mt, 64);   // the last rows are stored
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // MMA column n0 (and n0 + 1): pair n0 / 2R, row (n0 % 2R) / 2,
          // the south (and north) hemisphere.
          const int n0 = nt * 8 + 2 * tq, pp = n0 / (2 * R), rs = (n0 - pp * 2 * R) / 2 - r0;
          if (pp >= NP || rs < 0 || rs >= SR) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = gq + 8 * (q >> 1);
            if (ia + 8 * (q >> 1) < S::IH)
              tstage[((rs * 2 + par) * NB + 2 * pp + (q & 1)) * LP + i] = acc[nt][q];
          }
        }
        named_sync(kTileBar + mt, 64);
        for (int q = lane + 32 * par; q < SR * NB * CH; q += 64) {
          const int rs = q / (NB * CH), slot = q / CH - rs * NB;
          const int iv = (q - (q / CH) * CH) * VW, pp = slot >> 1, i = 16 * mt + iv;
          const long long row = unit * R + r0 + rs;
          if (i >= S::IH || row >= rows) continue;
          const Segment& sg = g.seg[find_segment(g, row)];
          T* out = row_out<T>(sg, row - sg.first);
          const int lat = (slot & 1) ? S::IL - 1 - (p0 + pp) : p0 + pp;
          const T* st = tstage + (rs * 2 * NB + slot) * LP + iv;
          const Vec<T, VW> pe = load_vec<T, VW>(st);
          const Vec<T, VW> po = load_vec<T, VW>(st + NB * LP);
          Vec<T, VW> x, y;
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            x.v[v] = pe.v[v] + po.v[v];
            y.v[v] = pe.v[v] - po.v[v];
          }
          if (sg.flag) {
            const T sc = band_scale[slot];
#pragma unroll
            for (int v = 0; v < VW; ++v) {
              x.v[v] = x.v[v] * sc;
              y.v[v] = y.v[v] * sc;
            }
          }
          *reinterpret_cast<Vec<T, VW>*>(out + lat * S::IX + i) = x;
          *reinterpret_cast<Vec<T, VW>*>(out + lat * S::IX + S::IH + i) = y;
        }
      }
    }
  } else {
    // --- The Legendre warps: thread lt takes item lt (m pair jl, SVW
    // pairs pg, n parity).
    const int lt = tid - ND;
    // The block's spectral values of a unit's rows: for c = 0 and 1, its
    // triangle entries (the K low m and the K mirrors, n < nx - m) split by
    // the parity of n. This thread's entries lt, lt + NL, ... are the same
    // every step: their offsets in a part of a row (m nx + n) and in its
    // staged part ((local m, parity) run, n / 2), -1 past the block's.
    constexpr int EPT = (ENT + NL - 1) / NL;
    int soff[EPT], doff[EPT];
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int el = lt + u * NL;
      const int e = el < e_lo ? t_lo + el : t_hi + el - e_lo;
      const int m = el < ENT ? m_of_entry(e, S::NX) : 0, n = e - tri_offset(m, S::NX);
      soff[u] = el < ENT ? m * S::NX + n : -1;
      doff[u] = (local_of(m, K, S::MX) * 2 + (n & 1)) * P::NH + (n >> 1);
    }
    auto issue = [&](long long unit, int buf) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const long long row = unit * R + rr;
        if (row >= rows) break;
        const Segment& s = g.seg[find_segment(g, row)];
        const T* src = row_in<T>(s, row - s.first);
        T* dst = sP + (buf * R + rr) * PROW;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int u = 0; u < EPT; ++u)
            if (soff[u] >= 0)
              cp_async_elem(dst + c * MS * 2 * P::NH + doff[u], src + c * s.in_pair + soff[u]);
      }
    };
    const bool act = lt < P::INV_ITEMS;
    const int npar = lt & 1, rest = act ? lt >> 1 : 0;
    const int jl = rest / PG, pg = rest - jl * PG;
    long long unit = cid;
    if (unit < units) issue(unit, 0);
    cp_async_commit();
    int steps = 0;
    for (int s = 0; unit < units; unit += ncl, s ^= 1, ++steps) {
      cp_async_wait_all();
      named_sync(kLegBar, NL);   // this step's values are in; last step's buffer is read
      if (unit + ncl < units) issue(unit + ncl, s ^ 1);
      cp_async_commit();
      if (steps > 0) cluster_wait();   // the DFT warps are done with buffer s
      const T* ps = sP + s * R * PROW;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int ml = side ? 2 * K - 1 - jl : jl;
        const int m = slice_m(rank, ml, K, S::MX);
        const int el0 = ml < K ? tri_offset(m, S::NX) - t_lo : e_lo + tri_offset(m, S::NX) - t_hi;
        const T* l = sL + el0 * S::IY + pg * SVW;
        T acc[R][2][SVW];
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int v = 0; v < SVW; ++v) acc[rr][c][v] = T(0);
        // This parity's n < nx - m: n = 2 j + npar, VW of them a step (the
        // spectral values as vectors, the last step masked).
        const int cnt = (S::NX - m - npar + 1) / 2;
        const T* pj = ps + (ml * 2 + npar) * P::NH;
        // VW terms from n = 2 j + npar on, all of them (a true Flag) or those
        // below cnt.
        auto terms = [&](int j, auto full) {
          Vec<T, VW> pv[R][2];
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              pv[rr][c] = load_vec<T, VW>(pj + rr * PROW + c * MS * 2 * P::NH + j);
#pragma unroll
          for (int u = 0; u < VW; ++u) {
            if (decltype(full)::value || j + u < cnt) {
              const T* lr = l + (2 * (j + u) + npar) * S::IY;
              T lv[SVW];
              if constexpr (SVW % 4 == 0 && sizeof(T) == 4) {
#pragma unroll
                for (int v = 0; v < SVW; v += 4) {
                  const Vec<T, 4> l4 = load_vec<T, 4>(lr + v);
                  lv[v] = l4.v[0]; lv[v + 1] = l4.v[1]; lv[v + 2] = l4.v[2]; lv[v + 3] = l4.v[3];
                }
              } else if constexpr (SVW % 2 == 0) {
#pragma unroll
                for (int v = 0; v < SVW; v += 2) {
                  const Vec<T, 2> l2 = load_vec<T, 2>(lr + v);
                  lv[v] = l2.v[0]; lv[v + 1] = l2.v[1];
                }
              } else {
#pragma unroll
                for (int v = 0; v < SVW; ++v) lv[v] = lr[v];
              }
#pragma unroll
              for (int rr = 0; rr < R; ++rr)
#pragma unroll
                for (int c = 0; c < 2; ++c)
#pragma unroll
                  for (int v = 0; v < SVW; ++v) acc[rr][c][v] += lv[v] * pv[rr][c].v[u];
            }
          }
        };
        int j = 0;
        for (; j + VW <= cnt; j += VW) terms(j, Flag<true>{});
        if (j < cnt) terms(j, Flag<false>{});
        // This thread keeps part c = npar: E and O of it, its partner lane
        // (the other parity) the other part.
        const bool discard = m == 0 && npar == 1;   // the imaginary part of m = 0
        const int col = ((s * 2 + (m & 1)) * S::COLS + npar * S::H + (m >> 1)) * FP;
#pragma unroll
        for (int v = 0; v < SVW; ++v) {
          // Pair p's 2 R slots (row, hemisphere) are contiguous in the
          // owner's column: whole 16-byte vectors.
          T f[2 * R];
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            // (selected, not indexed by npar: acc stays in registers)
            const T a0 = acc[rr][0][v], a1 = acc[rr][1][v];
            const T mine = npar ? a1 : a0;
            const T theirs = __shfl_xor_sync(0xffffffffu, npar ? a0 : a1, 1);
            const T e = npar ? theirs : mine, o = npar ? mine : theirs;
            f[2 * rr] = discard ? T(0) : e + o;
            f[2 * rr + 1] = discard ? T(0) : e - o;
          }
          const int p = pg * SVW + v, b = p / NP, pp = p - b * NP;
          if (act) {
            T* d = cluster.map_shared_rank(fin, b) + col + pp * 2 * R;
#pragma unroll
            for (int q = 0; q < 2 * R; q += VW) {
              Vec<T, VW> x;
#pragma unroll
              for (int w = 0; w < VW; ++w) x.v[w] = f[q + w];
              *reinterpret_cast<Vec<T, VW>*>(d + q) = x;
            }
          }
        }
      }
      cluster_arrive();   // this step's Fourier values are stored
    }
    if (steps > 0) cluster_wait();
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int cluster,
                    long long clusters, int threads, size_t bytes, cudaStream_t stream) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// Clusters of the kernel the current device holds at once, asked once per
// kernel and device (the statics belong to one instantiation).
template <auto kernel>
int resident_clusters(int cluster, int threads, size_t bytes, int* clusters) {
  static int cached_device = -1, cached = 0;
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev != cached_device) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
    if (rc != 0) return rc;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, cluster, 1, threads, bytes, nullptr);
    rc = static_cast<int>(cudaOccupancyMaxActiveClusters(&cached, kernel, &cfg));
    if (rc != 0) return rc;
    if (cached < 1) return -5;
    cached_device = dev;
  }
  *clusters = cached;
  return 0;
}

// Persistent clusters: as many as the card holds at once, at most one a row.
template <auto kernel>
int launch(int cluster, int threads, size_t bytes, const Group& g, long long rows,
           cudaStream_t stream) {
  int most = 0;
  int rc = resident_clusters<kernel>(cluster, threads, bytes, &most);
  if (rc != 0) return rc;
  const long long clusters = most < rows ? most : rows;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, cluster, clusters, threads, bytes, stream);
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, g, rows));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

template <class S, typename T, typename G>
int run_direct(const Group& g, long long rows, cudaStream_t s) {
  using P = Plan<S, T, G>;
  return launch<hires_direct_cluster_kernel<S, T, G>>(P::C, P::DIR_THREADS, P::DIR_SMEM, g, rows,
                                                      s);
}

template <class S, typename T>
int run_inverse(const Group& g, long long rows, cudaStream_t s) {
  using P = Plan<S, T>;
  return launch<hires_inverse_ws_kernel<S, T>>(P::C, P::INV_THREADS, P::INV_SMEM, g, rows, s);
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

// G: the direct kernel's grid type (the inverse reads T).
template <class S, typename T, typename G = T>
int run(int kind, int count, const void* const* tables, const long long* desc, cudaStream_t s) {
  Group g;
  const long long rows = read_group(g, count, desc, tables, kind != 0,
                                    static_cast<int>(sizeof(G)), S::IX);
  if (rows < 0) return static_cast<int>(rows);
  if (kind != 0) return run_inverse<S, T>(g, rows, s);
  if (sizeof(G) == 2)   // a bfloat16 grid is copied in 16-byte chunks only
    for (int q = 0; q < g.nseg; ++q)
      if (!g.seg[q].aligned) return -8;
  return run_direct<S, T, G>(g, rows, s);
}

template <auto kernel>
int occupancy(int cluster, int threads, size_t bytes, int* out) {
  int clusters = 0;
  int rc = resident_clusters<kernel>(cluster, threads, bytes, &clusters);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  rc = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  if (rc != 0) return rc;
  out[0] = clusters;
  out[1] = threads;
  out[2] = static_cast<int>(bytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = cluster;
  return 0;
}

// A kernel's clusters at once, threads, shared memory, registers, local
// bytes, blocks a cluster (kind 0 the direct kernel with grid type G, 1 the
// inverse).
template <class S, typename T, typename G = T>
int occupancy_of(int kind, int* out) {
  using P = Plan<S, T, G>;
  switch (kind) {
    case 0:
      return occupancy<hires_direct_cluster_kernel<S, T, G>>(P::C, P::DIR_THREADS, P::DIR_SMEM,
                                                             out);
    case 1:
      return occupancy<hires_inverse_ws_kernel<S, T>>(P::C, P::INV_THREADS, P::INV_SMEM, out);
    default:
      return -4;
  }
}

// The plan of a shape and types, as ints (see pyspeedy_fused_transform_hires_plan).
template <class S, typename T, typename G = T>
void plan_of(int* out) {
  using P = Plan<S, T, G>;
  const int v[] = {P::C, P::K, P::NP, P::R, P::NPAD, P::KS, P::DIR_THREADS,
                   static_cast<int>(P::DIR_SMEM), P::GBUF, P::INV_THREADS, P::INV_SVW,
                   P::INV_R, static_cast<int>(P::INV_SMEM), P::DIR_DFT_WARPS,
                   P::DIR_LEG_WARPS, P::DIR_MINB};
  for (int q = 0; q < 16; ++q) out[q] = v[q];
}

// 47 or 63 for the shapes the kernels are built for, else 0.
int shape_of(int il, int ix, int mx, int nx) {
  if (il == T47::IL && ix == T47::IX && mx == T47::MX && nx == T47::NX) return 47;
  if (il == T63::IL && ix == T63::IX && mx == T63::MX && nx == T63::NX) return 63;
  return 0;
}

}  // namespace

// out, the Plan at truncation 47 or 63 in a mode (see
// pyspeedy_fused_transform_hires), 16 ints: blocks a cluster, m pairs of a
// block, latitude pairs of a band, rows a direct cluster step, MMA columns of
// a direct step, MMA depth; the direct kernel's threads and shared memory
// (bytes), its grid buffers; the inverse kernel's threads, latitude pairs a
// Legendre item, rows a step and shared memory (bytes); the direct kernel's
// DFT warps, Legendre warps and blocks an SM. Needs no device.
extern "C" int pyspeedy_fused_transform_hires_plan(int trunc, int mode, int* out) {
  using B = __nv_bfloat16;
  if (trunc == 47 && mode == 0) plan_of<T47, float>(out);
  else if (trunc == 47 && mode == 1) plan_of<T47, double>(out);
  else if (trunc == 47 && mode == 2) plan_of<T47, float, B>(out);
  else if (trunc == 47 && mode == 3) plan_of<T47, double, B>(out);
  else if (trunc == 63 && mode == 0) plan_of<T63, float>(out);
  else if (trunc == 63 && mode == 1) plan_of<T63, double>(out);
  else if (trunc == 63 && mode == 2) plan_of<T63, float, B>(out);
  else if (trunc == 63 && mode == 3) plan_of<T63, double, B>(out);
  else return -1;
  return 0;
}

// out, from the CUDA runtime, at truncation 47 or 63 in a mode (see
// pyspeedy_fused_transform_hires; 2 and 3 for kind 0 only), kind 0 the
// direct kernel, kind 1 the inverse: clusters the current device holds at
// once, threads a block, shared memory a block (bytes), registers, local
// memory (bytes), blocks a cluster.
extern "C" int pyspeedy_fused_transform_hires_occupancy(int kind, int trunc, int mode, int* out) {
  using B = __nv_bfloat16;
  if (mode >= 2 && kind != 0) return -1;
  if (trunc == 47 && mode == 0) return occupancy_of<T47, float>(kind, out);
  if (trunc == 47 && mode == 1) return occupancy_of<T47, double>(kind, out);
  if (trunc == 47 && mode == 2) return occupancy_of<T47, float, B>(kind, out);
  if (trunc == 47 && mode == 3) return occupancy_of<T47, double, B>(kind, out);
  if (trunc == 63 && mode == 0) return occupancy_of<T63, float>(kind, out);
  if (trunc == 63 && mode == 1) return occupancy_of<T63, double>(kind, out);
  if (trunc == 63 && mode == 2) return occupancy_of<T63, float, B>(kind, out);
  if (trunc == 63 && mode == 3) return occupancy_of<T63, double, B>(kind, out);
  return -1;
}

// kind: 0 direct transform of a group, 1 inverse transform of a group.
// mode: 0 float, 1 double; 2 and 3 (kind 0 only) a bfloat16 grid against
//   float (2) or double (3) tables, its rows and strides 16-byte aligned
//   (else -8).
// count: the group's segments.
// tables: 0: the direct folded tables (ops/spectral.py::_fold_tables);
//         1: the inverse folded tables, 1/cos(lat) (il,).
// desc: 11 int64 words per segment: input and output address, rows, rows
//   per member, input member, pair and row strides, output member, pair and
//   row strides (elements), flag (inverse: 1 = scale by 1/cos(lat)).
extern "C" int pyspeedy_fused_transform_hires(int kind, int mode, int count, int il, int ix,
                                              int mx, int nx, const void* const* tables,
                                              const long long* desc, void* stream) {
  using B = __nv_bfloat16;
  if (count <= 0) return 0;
  if (mode < 0 || mode > 3 || kind < 0 || kind > 1 || (mode >= 2 && kind != 0)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape_of(il, ix, mx, nx) * 4 + mode) {
    case 47 * 4 + 0: return run<T47, float>(kind, count, tables, desc, s);
    case 47 * 4 + 1: return run<T47, double>(kind, count, tables, desc, s);
    case 47 * 4 + 2: return run<T47, float, B>(kind, count, tables, desc, s);
    case 47 * 4 + 3: return run<T47, double, B>(kind, count, tables, desc, s);
    case 63 * 4 + 0: return run<T63, float>(kind, count, tables, desc, s);
    case 63 * 4 + 1: return run<T63, double>(kind, count, tables, desc, s);
    case 63 * 4 + 2: return run<T63, float, B>(kind, count, tables, desc, s);
    case 63 * 4 + 3: return run<T63, double, B>(kind, count, tables, desc, s);
    default: return -2;
  }
}
