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
//
// Bound: operations. Per field row the two DFTs are 4*mx*ix multiply-adds:
// 23,808 operations at T30 (mx = 31, ix = 96), 14.0 GFLOP for the tool's 256
// members (589,824 field rows), 0.21 ms at 67 TFLOP/s in float; the bytes
// (each Fourier value read once and written once) are 292 MB, 0.087 ms.
//
// Design: a block owns a row group, the nf field rows of kLatTile latitudes of
// one (member, level): their Fourier values and the nf grid rows live in
// shared memory, and so do the DFT tables, packed as (re, im) pairs (47.6 KB
// in float, 95.2 KB in double), which each block loads once and keeps while
// it walks over row groups (a grid of as many blocks as fit on the card at
// once). Shared-memory loads, not the multiply-adds, bound such a kernel
// unless each loaded value feeds several of them, so both stages are blocked
// in registers: in the inverse stage a thread owns two longitudes (i and
// i + ix/2) of one latitude for all nf fields (the chain, which mixes the
// fields at a point, then runs in registers between the two DFTs): per zonal
// wavenumber it loads the two table pairs and the nf Fourier pairs (the same
// for the warp's threads: a broadcast) for 4*nf multiply-adds. In the
// forward stage a thread owns two wavenumbers (m and m + 16 at T30) of one
// latitude for all nf fields: per longitude two table pairs and nf grid
// values for 4*nf multiply-adds. Sums run in the plain version's order of terms (m, then
// the longitude) with fused multiply-adds; no tensor cores (the 1e-5 float
// agreement rules out TF32).
//
// Interface: plain C, loaded with ctypes. The launch goes to the stream it is
// given, allocates nothing and does not synchronise; the function returns
// cudaGetLastError() (0 on success), or a negative code for arguments the
// kernel was not built for.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLatTile = 16;
constexpr int kMaxFields = 8;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// The math of both scalar types by name: tanhf, expf, ... for float.
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float tanh_(float x) { return tanhf(x); }
__device__ __forceinline__ double tanh_(double x) { return tanh(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dft_chain_kernel(long long ngroups, int nf, int kx, int il, int mx, int ix,
                 const T* __restrict__ fre, const T* __restrict__ fim,
                 const T* __restrict__ inv_re, const T* __restrict__ inv_im,
                 const T* __restrict__ fwd_re, const T* __restrict__ fwd_im,
                 T* __restrict__ ore, T* __restrict__ oim) {
  using V = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* s_inv = reinterpret_cast<V*>(smem_raw);   // (mx, ix): (inv_re, inv_im)
  V* s_fwd = s_inv + mx * ix;                  // (ix, mx): (fwd_re, fwd_im)
  V* s_f = s_fwd + ix * mx;                    // (nf, kLatTile, mx): (re, im)
  T* s_h = reinterpret_cast<T*>(s_f + nf * kLatTile * mx);  // (nf, kLatTile, ix)

  for (int i = threadIdx.x; i < mx * ix; i += kThreads) {
    s_inv[i] = V{inv_re[i], inv_im[i]};
    s_fwd[i] = V{fwd_re[i], fwd_im[i]};
  }

  const int half = ix / 2;             // longitudes i and i + half
  const int mhalf = (mx + 1) / 2;      // wavenumbers m and m + mhalf
  const int ntiles = (il + kLatTile - 1) / kLatTile;
  const T inv_nf = T(1) / static_cast<T>(nf);
  for (long long g = blockIdx.x; g < ngroups; g += gridDim.x) {
    const int tile = static_cast<int>(g % ntiles);
    const long long bk = g / ntiles;        // member * kx + level
    const long long b = bk / kx;
    const int k = static_cast<int>(bk % kx);
    const int j0 = tile * kLatTile;
    const int nlat = min(kLatTile, il - j0);
    // Row (b, f, k, j) starts at ((b*nf + f)*kx + k)*il + j, times mx; the
    // tile's rows of one field are contiguous.
    auto row = [&](int f) {
      return ((((b * nf + f) * kx + k) * il) + j0) * static_cast<long long>(mx);
    };

    __syncthreads();   // the previous group's rows are consumed
    for (int i = threadIdx.x; i < nf * nlat * mx; i += kThreads) {
      const int f = i / (nlat * mx);
      const int r = i - f * nlat * mx;      // jj * mx + m
      const long long o = row(f) + r;
      s_f[f * kLatTile * mx + r] = V{fre[o], fim[o]};
    }
    __syncthreads();

    // Inverse DFT and the chain: longitudes i and i + half of one latitude.
    for (int p = threadIdx.x; p < nlat * half; p += kThreads) {
      const int jj = p / half;
      const int i = p - jj * half;
      T s1[kMaxFields][2], s2[kMaxFields][2];
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f)
        s1[f][0] = s1[f][1] = s2[f][0] = s2[f][1] = 0;
      const V* fr = s_f + jj * mx;
      for (int m = 0; m < mx; ++m) {
        const V t0 = s_inv[m * ix + i];
        const V t1 = s_inv[m * ix + i + half];
#pragma unroll
        for (int f = 0; f < kMaxFields; ++f) {
          if (f >= nf) break;
          const V c = fr[f * kLatTile * mx + m];
          s1[f][0] = fma_(c.x, t0.x, s1[f][0]);
          s2[f][0] = fma_(c.y, t0.y, s2[f][0]);
          s1[f][1] = fma_(c.x, t1.x, s1[f][1]);
          s2[f][1] = fma_(c.y, t1.y, s2[f][1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T gv[kMaxFields];
        T acc = 0;
#pragma unroll
        for (int f = 0; f < kMaxFields; ++f) {
          if (f >= nf) break;
          gv[f] = s1[f][h] + s2[f][h];
          acc = acc + gv[f] * gv[f];
        }
        acc = acc * inv_nf;
        const T th = T(0.1) * tanh_(acc);
#pragma unroll
        for (int f = 0; f < kMaxFields; ++f) {
          if (f >= nf) break;
          const T gf = gv[f];
          T v = (gf + th) - (T(0.01) * gf) * acc;
          v = fmax_(v, T(-3)) + exp_(-fabs_(gf)) * T(0.05);
          s_h[(f * kLatTile + jj) * ix + i + h * half] = v;
        }
      }
    }
    __syncthreads();

    // Forward DFT: wavenumbers m and m + mhalf of one latitude.
    for (int q = threadIdx.x; q < nlat * mhalf; q += kThreads) {
      const int jj = q / mhalf;
      const int m0 = q - jj * mhalf;
      const int m1 = m0 + mhalf < mx ? m0 + mhalf : m0;   // m0 twice at the end
      T sr[kMaxFields][2], si[kMaxFields][2];
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f)
        sr[f][0] = sr[f][1] = si[f][0] = si[f][1] = 0;
      const T* hr = s_h + jj * ix;
      for (int i = 0; i < ix; ++i) {
        const V w0 = s_fwd[i * mx + m0];
        const V w1 = s_fwd[i * mx + m1];
#pragma unroll
        for (int f = 0; f < kMaxFields; ++f) {
          if (f >= nf) break;
          const T h = hr[f * kLatTile * ix + i];
          sr[f][0] = fma_(h, w0.x, sr[f][0]);
          si[f][0] = fma_(h, w0.y, si[f][0]);
          sr[f][1] = fma_(h, w1.x, sr[f][1]);
          si[f][1] = fma_(h, w1.y, si[f][1]);
        }
      }
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f) {
        if (f >= nf) break;
        const long long o = row(f) + jj * mx;
        ore[o + m0] = sr[f][0];
        oim[o + m0] = si[f][0];
        if (m1 != m0) {
          ore[o + m1] = sr[f][1];
          oim[o + m1] = si[f][1];
        }
      }
    }
  }
}

template <typename T>
int launch(long long nmem, int nf, int kx, int il, int mx, int ix,
           const void* const* ptrs, cudaStream_t stream) {
  const long long ngroups = nmem * kx * ((il + kLatTile - 1) / kLatTile);
  if (ngroups <= 0) return 0;
  const size_t smem = 2 * sizeof(T) * (2 * static_cast<size_t>(mx) * ix +
                                       static_cast<size_t>(nf) * kLatTile * mx) +
                      sizeof(T) * static_cast<size_t>(nf) * kLatTile * ix;
  cudaError_t err = cudaFuncSetAttribute(
      dft_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dft_chain_kernel<T>, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return -5;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned nblocks = static_cast<unsigned>(ngroups < resident ? ngroups : resident);
  dft_chain_kernel<T><<<nblocks, kThreads, smem, stream>>>(
      ngroups, nf, kx, il, mx, ix,
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<const T*>(ptrs[3]),
      static_cast<const T*>(ptrs[4]), static_cast<const T*>(ptrs[5]),
      static_cast<T*>(const_cast<void*>(ptrs[6])),
      static_cast<T*>(const_cast<void*>(ptrs[7])));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: fre, fim (B, nf, kx, il, mx), inv_re, inv_im (mx, ix), fwd_re, fwd_im
//       (ix, mx), then the two outputs ore, oim (B, nf, kx, il, mx); all
//       dense, in one scalar type.
// elem_size: 4 (float) or 8 (double).
extern "C" int pyspeedy_dft_chain(int elem_size, long long nmem, int nf, int kx,
                                  int il, int mx, int ix,
                                  const void* const* ptrs, void* stream) {
  if (nf < 1 || nf > kMaxFields) return -3;
  if (ix % 2 != 0) return -6;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) return launch<float>(nmem, nf, kx, il, mx, ix, ptrs, s);
  if (elem_size == 8) return launch<double>(nmem, nf, kx, il, mx, ix, ptrs, s);
  return -1;
}
