// Fused spectral transforms for NVIDIA Hopper (sm_90a): the zonal DFT and the
// Legendre transform of a field in one kernel, the Fourier intermediate held
// in shared memory.
//
// Replaces three Pallas experiments of the JAX package:
//   tools/exp_fused_transform.py:65  fused_grid2spec  (pallas_call at :102)
//   tools/exp_fused_transform.py:121 fused_spec2grid  (pallas_call at :143)
//   tools/exp_fused_probe.py:49      probe            (pallas_call at :57)
// The plain PyTorch versions (the dense matmul chain) and the wrappers are in
// pyspeedy_tpu_torch/ops/transform_kernels.py.
//
// Computes, for every field row r (one (il, ix) grid or one spectral pair):
//   direct   F[c, j, m] = sum_i g[j, i] * dft_fwd[c, i, m]
//            S[c, m, n] = sum_j F[c, j, m] * leg_dir[j, m, n]
//   inverse  F[c, j, m] = sum_n leg_inv[j, m, n] * p[c, m, n]
//            g[j, i]    = (sum_c sum_m F[c, j, m] * dft_inv[c, m, i]) * scale[j]
// c indexes the (real, imaginary) parts. dft_inv[1, 0, :] is zero, which is
// the reference's "discard the imaginary part of m = 0" rule: no mask here.
// The Legendre stage uses the (il, mx, nx) operator, one (il x nx) block per
// zonal wavenumber, not its zero-padded dense (il*mx, mx*nx) form, which
// costs mx times the operations. Three element types: float, double, and the
// 2-byte operand mode of the direct transform (grid, DFT table and Legendre
// table in bfloat16, float accumulation, the Fourier intermediate rounded to
// bfloat16, float result).
//
// The probe kinds run the stages of the direct transform alone, for one part
// (the real one): p0 the DFT stage written straight to device memory as
// (N*il, mx); p1 the same values taken through the shared-memory intermediate
// and stored flat as (N, il*mx); p2 the whole chain as (N, mx*nx); p3 the
// inverse-side split, (N, il*ix)[:, :il*mx] viewed as (N*il, mx), times 2.
// They say which stage is wrong and which stage takes the time.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float and 34 TFLOP/s double outside
// the tensor cores): a T30 row (il=48, ix=96, mx=31, nx=32) is 18,432 B of
// grid and 7,936 B of spectral pair in float and needs 571,392 + 190,464
// operations: 7.9 ns of bytes against 11.4 ns of operations per row in float
// (15.7 against 22.4 in double), so the transform is bound by operations in
// float and double, and by bytes only if the products moved to the tensor
// cores, as the 2-byte mode would allow. Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700 W, 1,024 rows: 0.087 ms direct and 0.081 ms
// inverse in float (13-14 % of the 0.0116 ms bound), 0.131 and 0.126 ms in
// double (18 %), 0.091 ms with 2-byte operands; the dense cuBLAS chain takes
// 0.21 and 0.48 ms in float.
//
// Design (simple on purpose): one block of 256 threads per row. The row is
// staged in shared memory; in the DFT stages a thread keeps 6 latitudes of
// one (part, wavenumber) or one longitude in registers; the tables are read
// through L1/L2 (the DFT tables are 24 KB in float, the Legendre table
// 190 KB). Every output element is one fixed-order sum inside one block: no
// atomics, so results are deterministic and a row's result does not depend on
// the rows launched with it. Rows are addressed by member, pair and row
// strides, so the pair axis may sit anywhere in front of the field axes and
// nothing is copied before or after the launch.
// What this leaves for a redesign: the Legendre table is read from L2 once
// per row (several rows per block would reuse it); about one shared-memory
// or L1 load is issued per multiply-add (a two-dimensional register tile
// would cut that); the hemispheric even/odd fold would halve the Legendre
// operations and the triangular truncation halve them again; the products do
// not use the tensor cores (wgmma with TF32 or bfloat16 operands) and the
// loads do not use TMA.
//
// Interface: plain C, loaded with ctypes; one entry point with a `kind`
// argument. The launch goes to the stream it is given, allocates nothing and
// does not synchronise; the function returns cudaGetLastError() (0 on
// success) or a negative code for arguments the kernels were not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLatTile = 6;   // latitudes a thread keeps in the DFT stages

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ double round_bf16(double x) { return x; }  // never used

// Element strides of a row's address: rows are numbered member-major,
// `per_member` rows to a member.
struct RowStrides {
  long long member;
  long long pair;   // between the real and the imaginary part (spectral side)
  long long row;
};

// Direct transform and its probes. T: working and output type; E: element type
// of the grid and of both tables; BF16: round the Fourier intermediate to
// bfloat16. STAGE -1: the whole transform, both parts; 0, 1, 2: the probes
// p0, p1, p2 (real part only).
template <typename T, typename E, bool BF16, int STAGE>
__global__ void __launch_bounds__(kThreads)
grid2spec_kernel(const E* __restrict__ grid, const E* __restrict__ dft,
                 const E* __restrict__ leg, T* __restrict__ out,
                 int il, int ix, int mx, int nx, int per_member,
                 RowStrides gs, RowStrides os) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sg = reinterpret_cast<T*>(smem_raw);          // (il, ix) the grid row
  T* sf = sg + il * ix;                            // (2, il, mx) Fourier parts
  const int tid = threadIdx.x;
  const long long r = blockIdx.x;
  const long long b = r / per_member;
  const long long kk = r - b * per_member;
  constexpr int kParts = STAGE < 0 ? 2 : 1;

  const E* g = grid + b * gs.member + kk * gs.row;
  for (int idx = tid; idx < il * ix; idx += kThreads) sg[idx] = widen(g[idx]);
  __syncthreads();

  // Zonal DFT: item = (latitude tile, part, wavenumber), wavenumber fastest.
  const int ncol = kParts * mx;
  const int nitems = (il / kLatTile) * ncol;
  for (int item = tid; item < nitems; item += kThreads) {
    const int jt = item / ncol;
    const int mc = item - jt * ncol;
    const int c = mc / mx;
    const int m = mc - c * mx;
    const E* d = dft + (static_cast<long long>(c) * ix) * mx + m;
    const T* gr = sg + jt * kLatTile * ix;
    T acc[kLatTile];
#pragma unroll
    for (int jj = 0; jj < kLatTile; ++jj) acc[jj] = 0;
    for (int i = 0; i < ix; ++i) {
      const T dv = widen(d[i * mx]);
#pragma unroll
      for (int jj = 0; jj < kLatTile; ++jj) acc[jj] += gr[jj * ix + i] * dv;
    }
#pragma unroll
    for (int jj = 0; jj < kLatTile; ++jj) {
      const int j = jt * kLatTile + jj;
      T v = acc[jj];
      if constexpr (BF16) v = round_bf16(v);
      if constexpr (STAGE == 0)
        out[(r * il + j) * mx + m] = v;
      else
        sf[(c * il + j) * mx + m] = v;
    }
  }
  if constexpr (STAGE == 0) return;
  __syncthreads();

  if constexpr (STAGE == 1) {
    T* o = out + r * il * mx;
    for (int idx = tid; idx < il * mx; idx += kThreads) o[idx] = sf[idx];
    return;
  }

  // Legendre analysis: item = (wavenumber m, index n), n fastest, both parts.
  for (int item = tid; item < mx * nx; item += kThreads) {
    const int m = item / nx;
    const E* p = leg + item;                 // leg[j, m, n], stride mx*nx in j
    const T* f0 = sf + m;
    T a0 = 0, a1 = 0;
#pragma unroll 4
    for (int j = 0; j < il; ++j) {
      const T pv = widen(p[static_cast<long long>(j) * mx * nx]);
      a0 += f0[j * mx] * pv;
      if constexpr (kParts == 2) a1 += f0[(il + j) * mx] * pv;
    }
    if constexpr (STAGE == 2) {
      out[r * mx * nx + item] = a0;
    } else {
      T* o = out + b * os.member + kk * os.row + item;
      o[0] = a0;
      o[os.pair] = a1;
    }
  }
}

// Probe p3: out[(r*il + j), m] = 2 * flat(g[r])[j*mx + m].
template <typename T>
__global__ void __launch_bounds__(kThreads)
split_probe_kernel(const T* __restrict__ grid, T* __restrict__ out,
                   long long total, int il, int ix, int mx) {
  const long long idx = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (idx >= total) return;
  const long long per_row = static_cast<long long>(il) * mx;
  const long long r = idx / per_row;
  out[idx] = grid[r * il * ix + (idx - r * per_row)] * static_cast<T>(2);
}

// Inverse transform. legt is the Legendre operator transposed to (il, nx, mx)
// so that neighbouring threads (neighbouring m) read neighbouring addresses.
template <typename T>
__global__ void __launch_bounds__(kThreads)
spec2grid_kernel(const T* __restrict__ spec, const T* __restrict__ legt,
                 const T* __restrict__ dft, const T* __restrict__ scale,
                 T* __restrict__ out, int il, int ix, int mx, int nx,
                 int per_member, RowStrides ss) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = nx + 1;                        // odd pitch: no bank conflicts
  T* sp = reinterpret_cast<T*>(smem_raw);          // (2, mx, nx + 1)
  T* sf = sp + 2 * mx * pitch;                     // (2, il, mx)
  const int tid = threadIdx.x;
  const long long r = blockIdx.x;
  const long long b = r / per_member;
  const long long kk = r - b * per_member;

  const T* p = spec + b * ss.member + kk * ss.row;
  for (int idx = tid; idx < 2 * mx * nx; idx += kThreads) {
    const int c = idx / (mx * nx);
    const int rem = idx - c * mx * nx;
    const int m = rem / nx;
    const int n = rem - m * nx;
    sp[(c * mx + m) * pitch + n] = p[c * ss.pair + rem];
  }
  __syncthreads();

  // Legendre synthesis: item = (latitude j, wavenumber m), m fastest.
  for (int item = tid; item < il * mx; item += kThreads) {
    const int j = item / mx;
    const int m = item - j * mx;
    const T* l = legt + (static_cast<long long>(j) * nx) * mx + m;
    const T* p0 = sp + m * pitch;
    const T* p1 = sp + (mx + m) * pitch;
    T a0 = 0, a1 = 0;
#pragma unroll 4
    for (int n = 0; n < nx; ++n) {
      const T lv = l[n * mx];
      a0 += lv * p0[n];
      a1 += lv * p1[n];
    }
    sf[item] = a0;
    sf[il * mx + item] = a1;
  }
  __syncthreads();

  // Inverse zonal DFT: item = (latitude tile, longitude i), i fastest.
  T* o = out + r * il * ix;
  const int nitems = (il / kLatTile) * ix;
  for (int item = tid; item < nitems; item += kThreads) {
    const int jt = item / ix;
    const int i = item - jt * ix;
    T acc[kLatTile];
#pragma unroll
    for (int jj = 0; jj < kLatTile; ++jj) acc[jj] = 0;
    for (int c = 0; c < 2; ++c) {
      const T* d = dft + (static_cast<long long>(c) * mx) * ix + i;
      const T* f = sf + (c * il + jt * kLatTile) * mx;
      for (int m = 0; m < mx; ++m) {
        const T dv = d[m * ix];
#pragma unroll
        for (int jj = 0; jj < kLatTile; ++jj) acc[jj] += f[jj * mx + m] * dv;
      }
    }
#pragma unroll
    for (int jj = 0; jj < kLatTile; ++jj) {
      const int j = jt * kLatTile + jj;
      T v = acc[jj];
      if (scale != nullptr) v = v * scale[j];
      o[j * ix + i] = v;
    }
  }
}

// Dynamic shared memory above 48 KB has to be allowed per kernel first.
template <typename K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, typename E, bool BF16, int STAGE>
int launch_direct(long long nrows, int per_member, int il, int ix, int mx, int nx,
                  const void* grid, const void* dft, const void* leg, void* out,
                  RowStrides gs, RowStrides os, cudaStream_t stream) {
  const size_t bytes = sizeof(T) * (static_cast<size_t>(il) * ix + 2 * static_cast<size_t>(il) * mx);
  auto kernel = grid2spec_kernel<T, E, BF16, STAGE>;
  const int rc = allow_shared(kernel, bytes);
  if (rc != 0) return rc;
  kernel<<<static_cast<unsigned>(nrows), kThreads, bytes, stream>>>(
      static_cast<const E*>(grid), static_cast<const E*>(dft),
      static_cast<const E*>(leg), static_cast<T*>(out), il, ix, mx, nx,
      per_member, gs, os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename E, bool BF16>
int launch_direct_stage(int stage, long long nrows, int per_member, int il, int ix,
                        int mx, int nx, const void* grid, const void* dft,
                        const void* leg, void* out, RowStrides gs, RowStrides os,
                        cudaStream_t s) {
  switch (stage) {
    case -1: return launch_direct<T, E, BF16, -1>(nrows, per_member, il, ix, mx, nx, grid, dft, leg, out, gs, os, s);
    case 0: return launch_direct<T, E, BF16, 0>(nrows, per_member, il, ix, mx, nx, grid, dft, leg, out, gs, os, s);
    case 1: return launch_direct<T, E, BF16, 1>(nrows, per_member, il, ix, mx, nx, grid, dft, leg, out, gs, os, s);
    case 2: return launch_direct<T, E, BF16, 2>(nrows, per_member, il, ix, mx, nx, grid, dft, leg, out, gs, os, s);
    default: return -2;
  }
}

template <typename T>
int launch_inverse(long long nrows, int per_member, int il, int ix, int mx, int nx,
                   const void* spec, const void* legt, const void* dft,
                   const void* scale, void* out, RowStrides ss, cudaStream_t stream) {
  const size_t bytes = sizeof(T) * (2 * static_cast<size_t>(mx) * (nx + 1) + 2 * static_cast<size_t>(il) * mx);
  auto kernel = spec2grid_kernel<T>;
  const int rc = allow_shared(kernel, bytes);
  if (rc != 0) return rc;
  kernel<<<static_cast<unsigned>(nrows), kThreads, bytes, stream>>>(
      static_cast<const T*>(spec), static_cast<const T*>(legt),
      static_cast<const T*>(dft), static_cast<const T*>(scale),
      static_cast<T*>(out), il, ix, mx, nx, per_member, ss);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split(long long nrows, int il, int ix, int mx, const void* grid,
                 void* out, cudaStream_t stream) {
  const long long total = nrows * il * mx;
  const long long nblocks = (total + kThreads - 1) / kThreads;
  if (nblocks > 2147483647LL) return -3;
  split_probe_kernel<T><<<static_cast<unsigned>(nblocks), kThreads, 0, stream>>>(
      static_cast<const T*>(grid), static_cast<T*>(out), total, il, ix, mx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 direct transform, 1 inverse transform, 2..5 the probes p0..p3.
// mode: 0 float, 1 double, 2 bfloat16 operands (direct transform only).
// nrows field rows, numbered member-major with per_member rows to a member.
// ptrs, by kind:
//   0, 2, 3, 4: grid, dft_fwd (2, ix, mx), leg_dir (il, mx, nx), out
//   1:          spec, leg_inv transposed (il, nx, mx), dft_inv (2, mx, ix),
//               scale (il,) or null, out
//   5:          grid, out
// strides (elements), by kind:
//   0: grid member, grid row, out member, out pair, out row
//   1: spec member, spec pair, spec row
//   the probes take dense (N, il, ix) grids and write dense outputs.
extern "C" int pyspeedy_fused_transform(
    int kind, int mode, long long nrows, int per_member, int il, int ix, int mx,
    int nx, const void* const* ptrs, const long long* strides, void* stream) {
  if (nrows <= 0) return 0;
  if (nrows > 2147483647LL) return -3;
  if (il < kLatTile || il % kLatTile != 0 || ix < 1 || mx < 1 || nx < 1 ||
      per_member < 1)
    return -2;
  if (mode < 0 || mode > 2) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (kind == 1) {
    const RowStrides ss = {strides[0], strides[1], strides[2]};
    if (mode == 0)
      return launch_inverse<float>(nrows, per_member, il, ix, mx, nx, ptrs[0], ptrs[1], ptrs[2], ptrs[3], const_cast<void*>(ptrs[4]), ss, s);
    if (mode == 1)
      return launch_inverse<double>(nrows, per_member, il, ix, mx, nx, ptrs[0], ptrs[1], ptrs[2], ptrs[3], const_cast<void*>(ptrs[4]), ss, s);
    return -1;
  }
  if (kind == 5) {
    if (mode == 0) return launch_split<float>(nrows, il, ix, mx, ptrs[0], const_cast<void*>(ptrs[1]), s);
    if (mode == 1) return launch_split<double>(nrows, il, ix, mx, ptrs[0], const_cast<void*>(ptrs[1]), s);
    return -1;
  }
  if (kind != 0 && (kind < 2 || kind > 4)) return -4;

  const int stage = kind == 0 ? -1 : kind - 2;
  RowStrides gs = {static_cast<long long>(il) * ix * per_member, 0,
                   static_cast<long long>(il) * ix};
  RowStrides os = {0, 0, 0};
  if (kind == 0) {
    gs = {strides[0], 0, strides[1]};
    os = {strides[2], strides[3], strides[4]};
  }
  void* out = const_cast<void*>(ptrs[3]);
  if (mode == 0)
    return launch_direct_stage<float, float, false>(stage, nrows, per_member, il, ix, mx, nx, ptrs[0], ptrs[1], ptrs[2], out, gs, os, s);
  if (mode == 1)
    return launch_direct_stage<double, double, false>(stage, nrows, per_member, il, ix, mx, nx, ptrs[0], ptrs[1], ptrs[2], out, gs, os, s);
  if (kind != 0) return -1;   // the probes have no 2-byte mode
  return launch_direct<float, __nv_bfloat16, true, -1>(nrows, per_member, il, ix, mx, nx, ptrs[0], ptrs[1], ptrs[2], out, gs, os, s);
}
