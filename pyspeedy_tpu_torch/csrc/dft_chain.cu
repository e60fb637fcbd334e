// Zonal inverse DFT -> elementwise chain across fields -> forward DFT, for
// NVIDIA Hopper (sm_90a).
//
// Replaces: tools/exp_dft_kernel.py:113 make_pallas_step, the latitude-tiled
//   Pallas kernel of the JAX package's DFT experiment (bodies
//   pallas_kernel_dot :70 and pallas_kernel_mul :95). The plain PyTorch
//   version of the same function is
//   pyspeedy_tpu_torch/ops/dft_chain.py::dft_chain_plain (the tool's
//   xla_step :61, written with torch.matmul).
//
// Computes, for Fourier pairs (re, im) of shape (B, nf, kx, il, mx) and the
// four DFT tables inv_re, inv_im (mx, ix), fwd_re, fwd_im (ix, mx):
//   g_f = re_f @ inv_re + im_f @ inv_im               (ix longitudes per row)
//   acc = (g_0^2 + g_1^2 + ... ) / nf                  (fields in order)
//   h_f = max(g_f + 0.1 tanh(acc) - 0.01 g_f acc, -3) + 0.05 exp(-|g_f|)
//   out_re_f = h_f @ fwd_re,  out_im_f = h_f @ fwd_im.
// Built for the tool's one shape: mx = 31, ix = 96, il = 48, nf = 6 (any
// member count and level count); the wrapper refuses every other shape.
//
// Both DFTs are folded by half a period. The tables have D[i + ix/2] =
// (-1)^m D[i] up to rounding, so the inverse sums the even and the odd
// wavenumbers apart over the first 48 longitudes, Pe and Po, and writes
// g[i] = Pe + Po, g[i + 48] = Pe - Po; the forward transforms the sum
// h[i] + h[i + 48] into the even wavenumbers and the difference into the odd
// ones. That halves the multiply-adds and changes the result by rounding
// only. Each DFT is then two small matrix products per parity p:
//   inverse  (rows x 32) . (32 x 48): K = (part, q) for m = 2q + p, the
//            odd parity's q = 15 (m = 31) a zero table row;
//   forward  (rows x 48) . (48 x 32): N = (part, q) likewise.
//
// Bound (chip_smoke.py prints it): the tables are cos and sin, so besides
// the half period they are symmetric under the mirror i -> ix - i, and the
// least work folds by both: 2 x 2 x 31 x 24 multiply-adds per field row,
// 3.51 GFLOP for the tool's 256 members (589,824 field rows), 0.052 ms at
// 67 TFLOP/s (the float32 peak outside the tensor cores and the float64 peak
// of the tensor cores). This kernel folds by the half period only and does
// twice that work. The bytes (each Fourier value read once and written once)
// are 292.6 MB in float, 0.087 ms, and 585 MB in double, 0.175 ms. So both
// types are bound by their bytes.
//
// Design:
//  1. A block owns a row group, the 6 field rows of LT latitudes of one
//     (member, level), and walks over row groups (persistent blocks, as many
//     as fit on the card at once). Rows are numbered rho = f * LT + jj.
//  2. The tables are folded, padded and laid out for the products once per
//     block, in shared memory. Every operand plane is (k, column) with the
//     column XOR-swizzled by the row's low two bits, so the loads of a warp
//     fall on distinct banks and 16-byte vectors stay whole.
//  3. The group's Fourier values are copied into shared memory with cp.async,
//     scattered element by element into the (parity, k, rho) layout of the
//     inverse product (lane m of a warp takes wavenumber m, so the warp reads
//     whole rows); the next group's copy is issued as soon as the
//     current one's inverse product has read its values, and lands while
//     the chain and the forward product run.
//  4. float, on FFMA (TF32 would break the 1e-5 agreement): LT = 16, 192
//     threads. In the inverse the two half-warps take the two parities of the
//     same points: a lane keeps 6 fields x 2 latitudes x 4 longitudes (48
//     sums) and reads per k 6 8-byte field vectors and one 16-byte table
//     vector: 7 loads (one shared-memory wavefront each: the parity planes sit
//     64 bytes apart, so the half-warps use disjoint banks) feed 48 FFMA.
//     Lanes l and l ^ 16 swap their sums with one shuffle each: the even
//     half forms g[i] = Pe + Po and runs the chain at longitude i, the odd
//     half g[i + 48] = Pe - Po and the chain there; a second shuffle gives
//     each half its operand of the forward, the sum or the difference. In
//     the forward a lane keeps 4 rows x 8 columns of its parity and reads a
//     16-byte row vector and two 16-byte table vectors for 32 FFMA.
//  5. double, on the FP64 tensor cores (DMMA): mma.sync m16n8k4 (on an H100
//     the m8n8k4 shape does not reach the FP64 tensor-core rate). LT = 8,
//     6 warps. An inverse warp owns 8 longitudes for all 48 rows and both
//     parities; its table fragments stay in registers for the block's life;
//     an m16 tile is two fields of the same 8 latitudes, so each thread holds
//     all 6 fields of its points. A forward warp owns one parity and one pair
//     of fields.
//  6. The chain runs on the inverse product's registers, between the two
//     products: it needs the 6 fields of a point, which the thread holds;
//     the folded sum and difference go to shared memory as the forward
//     product's operand.
//  7. The results are staged in shared memory and stored as 16-byte vectors,
//     one contiguous run of LT x 31 values per (part, field).
//  8. Two blocks of 6 warps per SM (110.6 KB of shared memory a block in
//     double, 86.5 KB in float), so one block's chain overlaps the other's
//     products.
// Every output element is one sum in a fixed order inside one block, with no
// atomics: a member's result does not depend on the other members launched
// with it.
//
// Interface: plain C, loaded with ctypes. The launch goes to the stream it is
// given, allocates nothing and does not synchronise; the function returns
// cudaGetLastError() (0 on success), or a negative code for arguments the
// kernel was not built for.

#include <cuda_runtime.h>

namespace {

constexpr int kMX = 31, kIX = 96, kIH = 48, kIL = 48, kNF = 6;
constexpr int kQ = 16;        // wavenumbers of one parity and part
constexpr int kK = 2 * kQ;    // (part, q): the inverse's depth, the forward's width
constexpr int kTable = 2 * kK * kIH;   // one folded table's values, both parities

template <typename T> struct Shape;
constexpr int kThreads = 192;   // 6 warps a block, two blocks per SM
// LT latitudes of a row group, ROWS = 6 LT rows; PAD elements between the two
// parity planes of an operand (float: 64 bytes, so the two half-warps of a
// warp, one parity each, read disjoint banks).
template <> struct Shape<float> {
  static constexpr int LT = 16, ROWS = kNF * LT, PAD = 16;
};
template <> struct Shape<double> {
  static constexpr int LT = 8, ROWS = kNF * LT, PAD = 0;
};
// Elements of one parity plane: a table, the Fourier operand, the forward
// operand.
template <typename T> struct Planes {
  static constexpr int T_ = kK * kIH + Shape<T>::PAD;
  static constexpr int F = kK * Shape<T>::ROWS + Shape<T>::PAD;
  static constexpr int H = kIH * Shape<T>::ROWS + Shape<T>::PAD;
};

template <typename T>
constexpr size_t shared_bytes() {
  return sizeof(T) * (4 * static_cast<size_t>(Planes<T>::T_) + 2 * Planes<T>::F +
                      2 * Planes<T>::H);
}

// Element (k, c) of a plane of `pitch` columns (a multiple of 16): the column
// XOR-swizzled by the row's low two bits.
__device__ __forceinline__ int swz(int k, int c, int pitch) {
  return k * pitch + (c ^ ((k & 3) << 2));
}

__device__ __forceinline__ float tanh_(float x) { return tanhf(x); }
__device__ __forceinline__ double tanh_(double x) { return tanh(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }

// The chain at one grid point, over the fields in order.
template <typename T>
__device__ __forceinline__ void chain(T (&g)[kNF]) {
  T acc = 0;
#pragma unroll
  for (int f = 0; f < kNF; ++f) acc = acc + g[f] * g[f];
  acc = acc * (T(1) / static_cast<T>(kNF));
  const T th = T(0.1) * tanh_(acc);
#pragma unroll
  for (int f = 0; f < kNF; ++f) {
    const T gf = g[f];
    T v = (gf + th) - (T(0.01) * gf) * acc;
    g[f] = fmax_(v, T(-3)) + exp_(-fabs_(gf)) * T(0.05);
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// D += A . B on the FP64 tensor cores, m16n8k4: a0 = A[g][t], a1 = A[g+8][t],
// b = B[t][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1] for lane
// 4g + t.
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

struct Args {
  const void* fre;
  const void* fim;
  const void* tabs[4];   // inv_re, inv_im (mx, ix), fwd_re, fwd_im (ix, mx)
  void* ore;
  void* oim;
  long long ngroups;
  int kx;
};

// Offset of the group's first row of field 0, rows (b, f, k, j) of mx values;
// field f's rows follow at f * field_stride(kx).
__device__ __forceinline__ long long group_base(long long grp, int kx, int lt) {
  const int ntiles = kIL / lt;
  const long long bk = grp / ntiles;
  const int tile = static_cast<int>(grp - bk * ntiles);
  const long long b = bk / kx;
  const long long k = bk - b * kx;
  return ((b * kNF * kx + k) * kIL + tile * lt) * kMX;
}
__device__ __forceinline__ long long field_stride(int kx) {
  return static_cast<long long>(kx) * kIL * kMX;
}

// The group's Fourier values into sF (parity, k = part * 16 + q, rho) with
// cp.async, element by element: lane m of a warp copies wavenumber m of the
// rows (part, field, latitude) the warp takes, so a warp reads a row's 31
// contiguous values, and its lanes' destinations differ by a constant each.
template <typename T>
__device__ __forceinline__ void issue_group(T* sF, long long grp, const Args& a) {
  constexpr int LT = Shape<T>::LT, ROWS = Shape<T>::ROWS, WARPS = kThreads / 32;
  const int m = threadIdx.x & 31;
  if (m >= kMX) return;
  const int q = m >> 1;
  // swz(part * 16 + q, rho, ROWS): part * 16 leaves the swizzle's bits alone.
  T* dst = sF + (m & 1) * Planes<T>::F + q * ROWS;
  const int x = (q & 3) << 2;
  const long long base = group_base(grp, a.kx, LT) + m, fs = field_stride(a.kx);
  for (int r = threadIdx.x >> 5; r < 2 * kNF * LT; r += WARPS) {
    const int part = r / (kNF * LT), rho = r - part * kNF * LT;
    const int f = rho / LT, jj = rho - f * LT;
    const T* src = static_cast<const T*>(part ? a.fim : a.fre) + base + f * fs + jj * kMX;
    cp_async<sizeof(T)>(dst + part * kQ * ROWS + (rho ^ x), src);
  }
}

// The staged results (part, rho, m) to device memory: per (part, field) one
// run of LT * mx contiguous values, as 16-byte vectors.
template <typename T>
__device__ __forceinline__ void store_group(const T* sOut, long long grp, const Args& a) {
  constexpr int LT = Shape<T>::LT;
  constexpr int RUN = LT * kMX;
  constexpr int VEC = 16 / sizeof(T);
  static_assert(RUN % VEC == 0, "16-byte runs");
  constexpr int NV = RUN / VEC;
  const long long base = group_base(grp, a.kx, LT), fs = field_stride(a.kx);
  for (int e = threadIdx.x; e < 2 * kNF * NV; e += kThreads) {
    const int run = e / NV, v = e - run * NV;
    const int part = run / kNF, f = run - part * kNF;
    T* dst = static_cast<T*>(part ? a.oim : a.ore);
    *reinterpret_cast<uint4*>(dst + base + f * fs + v * VEC) =
        *reinterpret_cast<const uint4*>(sOut + run * RUN + v * VEC);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dft_chain_fold_kernel(const __grid_constant__ Args a) {
  constexpr int LT = Shape<T>::LT, ROWS = Shape<T>::ROWS;
  constexpr int PLANE_T = Planes<T>::T_, PLANE_F = Planes<T>::F, PLANE_H = Planes<T>::H;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sTinv = reinterpret_cast<T*>(smem_raw);   // (parity, k, i < 48)
  T* sTfwd = sTinv + 2 * PLANE_T;               // (parity, i < 48, c)
  T* sF = sTfwd + 2 * PLANE_T;                  // (parity, k, rho)
  T* sH = sF + 2 * PLANE_F;                     // (parity, i < 48, rho); then (part, rho, m)
  const int tid = threadIdx.x;

  long long grp = blockIdx.x;
  if (grp < a.ngroups) issue_group<T>(sF, grp, a);
  cp_async_commit();
  {
    const T* inv_re = static_cast<const T*>(a.tabs[0]);
    const T* inv_im = static_cast<const T*>(a.tabs[1]);
    const T* fwd_re = static_cast<const T*>(a.tabs[2]);
    const T* fwd_im = static_cast<const T*>(a.tabs[3]);
    for (int idx = tid; idx < kTable; idx += kThreads) {
      const int p = idx / (kK * kIH);
      const int r = idx - p * kK * kIH;
      // inverse: r = k * 48 + i; forward: r = i * 32 + c; (part, q) -> m = 2q + p
      const int k = r / kIH, i = r - k * kIH;
      const int mi = 2 * (k & (kQ - 1)) + p;
      sTinv[p * PLANE_T + swz(k, i, kIH)] = mi < kMX ? (k < kQ ? inv_re : inv_im)[mi * kIX + i] : T(0);
      const int i2 = r / kK, c = r - i2 * kK;
      const int mf = 2 * (c & (kQ - 1)) + p;
      sTfwd[p * PLANE_T + swz(i2, c, kK)] = mf < kMX ? (c < kQ ? fwd_re : fwd_im)[i2 * kMX + mf] : T(0);
    }
    // The odd parity's m = 31 slots of the Fourier plane: never copied, zero.
    for (int idx = tid; idx < 2 * ROWS; idx += kThreads) {
      const int k = idx < ROWS ? kQ - 1 : kK - 1;
      sF[PLANE_F + swz(k, idx % ROWS, ROWS)] = T(0);
    }
  }

  __syncthreads();
  [[maybe_unused]] const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  // double: the inverse table's B fragments of this warp's 8 longitudes,
  // held in registers for the block's life.
  [[maybe_unused]] double binv[2][kK / 4];
  if constexpr (sizeof(T) == 8) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int s = 0; s < kK / 4; ++s)
        binv[p][s] = sTinv[p * PLANE_T + swz(4 * s + t, 8 * warp + g, kIH)];
  }

  for (; grp < a.ngroups; grp += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();

    if constexpr (sizeof(T) == 4) {
      // ---- float: inverse DFT. Lane l of warp w: parity p = l / 16, 2
      // latitudes (jp), 4 longitudes (iq = 2w + (l / 8) % 2), all 6 fields;
      // lanes l and l ^ 16 hold the two parities of the same points.
      const int p = (lane >> 4) & 1, jp = lane & 7, iq = 2 * warp + ((lane >> 3) & 1);
      const float* fpl = sF + p * PLANE_F;
      const float* tpl = sTinv + p * PLANE_T;
      float acc[kNF][2][4];
#pragma unroll
      for (int f = 0; f < kNF; ++f)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[f][j][c] = 0.f;
      // swz(k, f * LT + 2 jp) = k * ROWS + f * LT + (2 jp ^ 4 (k % 4)): the
      // swizzle stays inside a field's 16 columns, so each unrolled k has
      // fixed offsets from one of four bases.
      for (int k0 = 0; k0 < kK; k0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u;
          const float4 b = *reinterpret_cast<const float4*>(tpl + k * kIH + ((4 * iq) ^ (4 * u)));
          const float bv[4] = {b.x, b.y, b.z, b.w};
          const float* arow = fpl + k * ROWS + ((2 * jp) ^ (4 * u));
#pragma unroll
          for (int f = 0; f < kNF; ++f) {
            const float2 v = *reinterpret_cast<const float2*>(arow + f * LT);
            const float av[2] = {v.x, v.y};
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[f][j][c] = fmaf(av[j], bv[c], acc[f][j][c]);
          }
        }
      }
      __syncthreads();   // sF read: the next group may land there
      if (grp + gridDim.x < a.ngroups) issue_group<T>(sF, grp + gridDim.x, a);
      cp_async_commit();

      // The fold, the chain, the forward fold into sH: the even lanes'
      // longitudes i = g[i] = Pe + Po, the odd ones' i + 48 = Pe - Po;
      // then the sum h[i] + h[i + 48] (parity 0) and the difference
      // (parity 1), each lane its own.
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * iq + c;
        float out[kNF][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float gv[kNF];
#pragma unroll
          for (int f = 0; f < kNF; ++f) {
            const float mine = acc[f][j][c];
            const float other = __shfl_xor_sync(0xffffffffu, mine, 16);
            gv[f] = p == 0 ? mine + other : other - mine;
          }
          chain(gv);
#pragma unroll
          for (int f = 0; f < kNF; ++f) {
            const float other = __shfl_xor_sync(0xffffffffu, gv[f], 16);
            out[f][j] = p == 0 ? gv[f] + other : other - gv[f];
          }
        }
#pragma unroll
        for (int f = 0; f < kNF; ++f)
          *reinterpret_cast<float2*>(sH + p * PLANE_H + swz(i, f * LT + 2 * jp, ROWS)) =
              make_float2(out[f][0], out[f][1]);
      }
      __syncthreads();

      // ---- float: forward DFT. Lane l of warp w: parity l / 16, 4 rows
      // (rq = 4w + (l / 4) % 4), 8 columns (co = l % 4).
      const int co = lane & 3, rq = 4 * warp + ((lane >> 2) & 3);
      const float* hpl = sH + p * PLANE_H;
      const float* fwp = sTfwd + p * PLANE_T;
      float o[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) o[r][c] = 0.f;
      for (int i0 = 0; i0 < kIH; i0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          const float4 h =
              *reinterpret_cast<const float4*>(hpl + i * ROWS + ((4 * rq) ^ (4 * u)));
          const float4 b0 = *reinterpret_cast<const float4*>(fwp + i * kK + ((8 * co) ^ (4 * u)));
          const float4 b1 =
              *reinterpret_cast<const float4*>(fwp + i * kK + ((8 * co + 4) ^ (4 * u)));
          const float hv[4] = {h.x, h.y, h.z, h.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) o[r][c] = fmaf(hv[r], bv[c], o[r][c]);
        }
      }
      __syncthreads();   // sH read: it becomes the output stage
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 8 * co + c, part = col / kQ, m = 2 * (col & (kQ - 1)) + p;
        if (m >= kMX) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r) sH[(part * ROWS + 4 * rq + r) * kMX + m] = o[r][c];
      }
    } else {
      // ---- double: inverse DFT on the tensor cores. Warp w: longitudes
      // 8w .. 8w+7; m16 tile q: fields 2q (rows g) and 2q+1 (rows g+8) of
      // the group's 8 latitudes.
      double acc[2][3][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][q][e] = 0.0;
      // swz(4s + t, 16q + g) = (4s + t) ROWS + 16q + (g ^ 4t), and likewise
      // for g + 8: fixed offsets from two per-lane bases.
      const double* a_lo = sF + t * ROWS + (g ^ (4 * t));
      const double* a_hi = sF + t * ROWS + ((8 + g) ^ (4 * t));
#pragma unroll
      for (int s = 0; s < kK / 4; ++s)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int o = p * PLANE_F + 4 * s * ROWS + 16 * q;
            mma_f64(acc[p][q], a_lo[o], a_hi[o], binv[p][s]);
          }
      __syncthreads();   // sF read: the next group may land there
      if (grp + gridDim.x < a.ngroups) issue_group<T>(sF, grp + gridDim.x, a);
      cp_async_commit();

      // The fold, the chain, the forward fold into sH: this thread holds
      // latitude g, longitudes 8w + 2t + e, all six fields.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * warp + 2 * t + e;
        double g0[kNF], g1[kNF];
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const double pe = acc[0][q][2 * h + e], po = acc[1][q][2 * h + e];
            g0[2 * q + h] = pe + po;
            g1[2 * q + h] = pe - po;
          }
        chain(g0);
        chain(g1);
#pragma unroll
        for (int f = 0; f < kNF; ++f) {
          sH[swz(i, f * LT + g, ROWS)] = g0[f] + g1[f];
          sH[PLANE_H + swz(i, f * LT + g, ROWS)] = g0[f] - g1[f];
        }
      }
      __syncthreads();

      // ---- double: forward DFT on the tensor cores. Warp w: parity w / 3,
      // fields 2q and 2q+1 (q = w % 3), all 32 columns.
      const int p = warp / 3, q = warp - 3 * (warp / 3);
      const double* h_lo = sH + p * PLANE_H + t * ROWS + (g ^ (4 * t));
      const double* h_hi = sH + p * PLANE_H + t * ROWS + ((8 + g) ^ (4 * t));
      // swz(4s + t, 8n + g, 32) = (4s + t) 32 + 16 (n / 2) + ((8 (n % 2) + g) ^ 4t)
      const double* b_even = sTfwd + p * PLANE_T + t * kK + (g ^ (4 * t));
      const double* b_odd = sTfwd + p * PLANE_T + t * kK + ((8 + g) ^ (4 * t));
      double o[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.0;
#pragma unroll 4
      for (int s = 0; s < kIH / 4; ++s) {
        const double a0 = h_lo[4 * s * ROWS + 16 * q], a1 = h_hi[4 * s * ROWS + 16 * q];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_f64(o[n], a0, a1, (n & 1 ? b_odd : b_even)[4 * s * kK + 16 * (n >> 1)]);
      }
      __syncthreads();   // sH read: it becomes the output stage
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t + e, part = col / kQ, m = 2 * (col & (kQ - 1)) + p;
          if (m >= kMX) continue;
          sH[(part * ROWS + 16 * q + g) * kMX + m] = o[n][e];
          sH[(part * ROWS + 16 * q + 8 + g) * kMX + m] = o[n][2 + e];
        }
    }
    __syncthreads();
    store_group<T>(sH, grp, a);
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  if (a.ngroups <= 0) return 0;
  auto kernel = dft_chain_fold_kernel<T>;
  constexpr size_t smem = shared_bytes<T>();
  static int cached_device = -1, per_sm = 0, sms = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != cached_device) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
        cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return -5;
    cached_device = device;
  }
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned nblocks = static_cast<unsigned>(a.ngroups < resident ? a.ngroups : resident);
  kernel<<<nblocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int* out) {
  auto kernel = dft_chain_fold_kernel<T>;
  constexpr size_t smem = shared_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = static_cast<int>(smem);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

// out: resident blocks per SM, threads a block, shared memory a block
// (bytes), registers, local memory (bytes) of the instantiation for
// elem_size 4 (float) or 8 (double), from the CUDA runtime.
extern "C" int pyspeedy_dft_chain_occupancy(int elem_size, int* out) {
  if (elem_size == 4) return occupancy<float>(out);
  if (elem_size == 8) return occupancy<double>(out);
  return -1;
}

// ptrs: fre, fim (B, nf, kx, il, mx), inv_re, inv_im (mx, ix), fwd_re, fwd_im
//       (ix, mx), then the two outputs ore, oim (B, nf, kx, il, mx); all
//       dense, in one scalar type, the outputs 16-byte aligned.
// elem_size: 4 (float) or 8 (double).
extern "C" int pyspeedy_dft_chain(int elem_size, long long nmem, int nf, int kx,
                                  int il, int mx, int ix,
                                  const void* const* ptrs, void* stream) {
  if (nf != kNF || il != kIL || mx != kMX || ix != kIX) return -2;
  if (kx < 1) return -3;
  if ((reinterpret_cast<unsigned long long>(ptrs[6]) |
       reinterpret_cast<unsigned long long>(ptrs[7])) % 16 != 0)
    return -7;
  Args a;
  a.fre = ptrs[0];
  a.fim = ptrs[1];
  for (int q = 0; q < 4; ++q) a.tabs[q] = ptrs[2 + q];
  a.ore = const_cast<void*>(ptrs[6]);
  a.oim = const_cast<void*>(ptrs[7]);
  a.kx = kx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) {
    a.ngroups = nmem * kx * (kIL / Shape<float>::LT);
    return launch<float>(a, s);
  }
  if (elem_size == 8) {
    a.ngroups = nmem * kx * (kIL / Shape<double>::LT);
    return launch<double>(a, s);
  }
  return -1;
}
