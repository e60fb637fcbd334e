// SPPT's noise for NVIDIA Hopper (sm_90a): the clipped, scaled standard
// normals of the JAX package's stream, one launch for a chunk of steps.
//
// Replaces no Pallas kernel: the JAX package draws SPPT's noise with
// jax.random (pyspeedy_tpu/physics/sppt.py), which XLA fuses into its step.
// Added because the port's plain version of the same draw
// (pyspeedy_tpu_torch/physics/sppt.py::draw_noise_plain) writes threefry2x32
// as int32 tensor arithmetic: about 130 full-size passes an element, each
// reading and writing int32 temporaries, and some 500 host calls for the
// noise of one run call. Every word of that traffic is intermediate: the
// result is one value an element.
//
// Computes, for each row (b, s) of a (B, S, per) output:
//   - the row's key: keys[b] (two uint32 words held in int64), folded with
//     the row's table entry `data` unless it is -1 (jax.random.fold_in:
//     threefry2x32 of the counter (0, data));
//   - for every e < per, the element index i = offset + e (mod 2^32, the
//     row's table entry `offset`), and (x0, x1) = threefry2x32 of the
//     counter (0, i) under the key, 20 rounds (JAX's partitionable
//     threefry: an element's bits are those of its flat index);
//   - JAX's map of the bits to a standard normal (jax.random.normal):
//     float:  f = ((x0 ^ x1) >> 9) * 2^-23, u = max(f * span + lo, lo) with
//             two roundings, sqrt(2) * erfinvf(u);
//     double: the 52 bits x0 << 20 | x1 >> 12, then the same in double with
//             erfinv;
//   - the clip to +-10, then the product with scale[e % nscale] when a
//     scale table is given (SPPT's sigma, or stat * sigma as rounded by the
//     caller).
// Every step rounds once, as the plain passes do: the products and sums by
// the _rn intrinsics, the file built with -fmad=false. The threefry words
// are the plain version's bit for bit, and so, on one card, are the normals
// (erfinvf / erfinv are the CUDA math library's, which PyTorch's erfinv also
// calls).
//
// Bound: INT32 issue, not bytes. An element costs 73 integer operations
// (20 rounds of an add, a rotate (one funnel shift) and a xor, the key
// injections, the index) and a few dozen float ones (the normal map,
// erfinvf's logarithm and polynomial), and moves only its store. The 40
// rotates and xors only the INT32 pipe issues (the compiler moves adds to
// the FMA pipe as IMAD): at the SPPT cell's chunk (T30L8, 1,024 members,
// 8 steps: 130 M elements) 5.2 G of them take 0.31 ms at 64 a clock an SM
// (132 SMs at 1.98 GHz), against 0.16 ms for the 520 MB written at
// 3.35 TB/s.
//
// Design: a block of 128 threads a row. Every thread folds the row's key in
// registers (one threefry2x32 against per / 128 of the elements' ones), then
// walks the row 16 bytes at a time: four floats or two doubles a thread, each
// an independent threefry chain (instruction-level parallelism for the
// integer pipe), stored with one 16-byte store where the row is aligned so
// (the wrapper's shapes are), else one value at a time. No shared memory, no
// synchronisation, nothing read but the key, the table entry and the scale.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

// threefry2x32 with 20 rounds (Salmon et al. 2011; JAX's threefry2x32_p) of
// the counter (x0, x1) under the key (k0, k1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1;
  x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2;
  x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0;
  x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1;
  x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

// JAX's bits-to-normal map, then the clip to +-10. lo = nextafter(-1, 0),
// span = 1 - lo and sqrt2 are the plain version's constants in T.
__device__ __forceinline__ float normal(uint32_t x0, uint32_t x1, float lo,
                                        float span, float sqrt2) {
  const float f = __fmul_rn(static_cast<float>((x0 ^ x1) >> 9), 0x1p-23f);
  const float u = fmaxf(__fadd_rn(__fmul_rn(f, span), lo), lo);
  const float eta = __fmul_rn(erfinvf(u), sqrt2);
  return fminf(fmaxf(eta, -10.0f), 10.0f);
}

__device__ __forceinline__ double normal(uint32_t x0, uint32_t x1, double lo,
                                         double span, double sqrt2) {
  const unsigned long long mant =
      (static_cast<unsigned long long>(x0) << 20) | (x1 >> 12);
  const double f = __dmul_rn(static_cast<double>(mant), 0x1p-52);
  const double u = fmax(__dadd_rn(__dmul_rn(f, span), lo), lo);
  const double eta = __dmul_rn(erfinv(u), sqrt2);
  return fmin(fmax(eta, -10.0), 10.0);
}

__device__ __forceinline__ float times(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double times(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static __device__ __forceinline__ type make(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static __device__ __forceinline__ type make(const double* v) {
    return make_double2(v[0], v[1]);
  }
};

template <typename T>
struct Args {
  const long long* keys;   // (nb, 2) uint32 words
  const long long* table;  // (ns, 2), or (nb, ns, 2): fold data or -1, offset
  const T* scale;          // nscale values, or null
  T* out;                  // (nb, ns, per)
  long long ns;
  int per, nscale;
  bool table_per_member;   // the table is (nb, ns, 2)
  bool vec;                // every row starts on a 16-byte boundary
  T lo, span, sqrt2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) sppt_noise_kernel(const Args<T> a) {
  constexpr int V = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const long long b = row / a.ns;
  const long long s = row - b * a.ns;
  const long long* key = a.keys + 2 * b;
  const long long* entry = a.table + 2 * (a.table_per_member ? row : s);
  uint32_t k0 = static_cast<uint32_t>(key[0]);
  uint32_t k1 = static_cast<uint32_t>(key[1]);
  const long long data = entry[0];
  const uint32_t offset = static_cast<uint32_t>(entry[1]);
  if (data >= 0) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(data);
    threefry(k0, k1, x0, x1);
    k0 = x0;
    k1 = x1;
  }
  T* out = a.out + row * static_cast<long long>(a.per);
  for (int e0 = threadIdx.x * V; e0 < a.per; e0 += kThreads * V) {
    T v[V];
    int m = a.scale ? e0 % a.nscale : 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      uint32_t x0 = 0u, x1 = offset + static_cast<uint32_t>(e0 + j);
      threefry(k0, k1, x0, x1);
      v[j] = normal(x0, x1, a.lo, a.span, a.sqrt2);
      if (a.scale) {
        v[j] = times(a.scale[m], v[j]);
        if (++m == a.nscale) m = 0;
      }
    }
    if (a.vec && e0 + V <= a.per) {
      *reinterpret_cast<typename Vec<T>::type*>(out + e0) = Vec<T>::make(v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (e0 + j < a.per) out[e0 + j] = v[j];
    }
  }
}

template <typename T>
int launch(long long nb, long long ns, long long per, const void* keys, const void* table,
           int table_per_member, const void* scale, long long nscale, double lo, double span,
           double sqrt2, void* out, cudaStream_t stream) {
  Args<T> a;
  a.keys = static_cast<const long long*>(keys);
  a.table = static_cast<const long long*>(table);
  a.scale = static_cast<const T*>(scale);
  a.out = static_cast<T*>(out);
  a.ns = ns;
  a.table_per_member = table_per_member != 0;
  a.per = static_cast<int>(per);
  a.nscale = static_cast<int>(nscale);
  a.vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && (per * sizeof(T)) % 16 == 0;
  a.lo = static_cast<T>(lo);
  a.span = static_cast<T>(span);
  a.sqrt2 = static_cast<T>(sqrt2);
  sppt_noise_kernel<T><<<static_cast<unsigned>(nb * ns), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The noise of nb x ns rows of per elements into out (nb, ns, per) of
// elem_size bytes a value (4: float, 8: double), on `stream`: row (b, s)
// takes the key pair keys[b] and the table pair table[s], or table[b, s]
// with table_per_member (int64 each). `scale` (nscale values of the same
// type) may be null. Returns 0, a CUDA error code, or -1 / -2 for what the
// kernel does not take.
extern "C" int pyspeedy_sppt_noise(int elem_size, long long nb, long long ns, long long per,
                                   const void* keys, const void* table, int table_per_member,
                                   const void* scale, long long nscale, double lo,
                                   double span, double sqrt2, void* out, void* stream) {
  if (nb < 1 || ns < 1 || per < 1 || per > INT_MAX - kThreads * 4) return -1;
  if (nb * ns > INT_MAX) return -1;
  if (scale != nullptr && (nscale < 1 || nscale > INT_MAX)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4)
    return launch<float>(nb, ns, per, keys, table, table_per_member, scale, nscale, lo, span,
                         sqrt2, out, s);
  if (elem_size == 8)
    return launch<double>(nb, ns, per, keys, table, table_per_member, scale, nscale, lo, span,
                          sqrt2, out, s);
  return -2;
}
