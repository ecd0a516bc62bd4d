// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is built from one .cu file with a plain C
// interface (no PyTorch headers) and bound with ctypes. Each C entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>
#include <cstring>
#include <initializer_list>
#include <type_traits>
#include <typeinfo>

namespace apex_port {

// dtype codes shared with the Python wrappers (ops/_build.py DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
// the JAX kernels' "-inf tier": an lse merge weighs such a row to zero.
// Also the running max of a row that has attended nothing yet and the
// score of a masked key: finite, so no inf - inf can arise, and
// exp2(kNegInf - m) is exactly 0 for any real score m.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T's precision (round to nearest even), as a float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// whether a 2-byte float type is fp16 (else bf16): the tensor-core
// products' operand type (".f16" or ".bf16")
template <typename T>
constexpr bool kIsF16 = std::is_same<T, __half>::value;

// a 2-byte float type's two-element vector (its __hadd2 and friends)
template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <>
struct Pair<__half> {
  using type = __half2;
};

// two floats as one 32-bit word of a 2-byte type, lo in the low half
// (round to nearest even; fp16 keeps subnormals, as the plain versions)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  static_assert(sizeof(T) == 2, "a 2-byte float type");
  if constexpr (kIsF16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The dtype code of the one 2-byte float type of a call whose buffers are
// each fp32 or that type (kBFloat16 where every buffer is fp32); -1 where
// bf16 and fp16 meet in one call or a code is unknown. Each kernel is
// instanced once per 2-byte type, not per mix of them.
inline int half_family(int a, int b = kFloat32, int c = kFloat32,
                       int d = kFloat32) {
  int h = kFloat32;
  for (int x : {a, b, c, d}) {
    if (x == kFloat32) continue;
    if ((x != kBFloat16 && x != kFloat16) || (h != kFloat32 && h != x))
      return -1;
    h = x;
  }
  return h == kFloat32 ? kBFloat16 : h;
}

// a 2-byte float type's code: the tensor-core kernels' operand types
inline bool is_half_code(int code) {
  return code == kBFloat16 || code == kFloat16;
}

// f(H{}) for the 2-byte type H of a half_family code (the caller picks
// each buffer's type from its code: float or H)
template <typename F>
inline int with_half(int family, F&& f) {
  if (family == kFloat16) return f(__half{});
  if (family == kBFloat16) return f(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Load VEC consecutive elements as fp32. The wrappers guarantee the
// address is aligned to VEC * sizeof(T) bytes, so 4/8/16-byte vectors
// become one load instruction per lane.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 16) {
    uint4 r = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float(e[i]);
  } else if constexpr (kBytes == 8) {
    uint2 r = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float(e[i]);
  } else if constexpr (kBytes == 4) {
    uint32_t r = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&in)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) p[i] = from_float<T>(in[i]);
}

// Store VEC consecutive elements rounded from fp32, as one 16-, 8- or
// 4-byte store where VEC * sizeof(T) is that size (the address aligned to
// it, as for `load_vec`).
template <typename T, int VEC>
__device__ __forceinline__ void store_vec_packed(T* __restrict__ p,
                                                 const float (&in)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 16 || kBytes == 8 || kBytes == 4) {
    using Word = typename std::conditional<
        kBytes == 16, uint4,
        typename std::conditional<kBytes == 8, uint2, uint32_t>::type>::type;
    Word r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(in[i]);
    *reinterpret_cast<Word*>(p) = r;
  } else {
    store_vec<T, VEC>(p, in);
  }
}

// N elements of T at p as fp32, in 16-byte vectors loaded evict-first
// (`__ldcs`) where N * sizeof(T) is a multiple of 16 (the address aligned
// to 16), else as `load_vec`: for operands read once, whose lines should
// give way to data that is read again
template <typename T, int N>
__device__ __forceinline__ void load_vec_once(const T* __restrict__ p,
                                              float (&out)[N]) {
  constexpr int kPiece = 16 / static_cast<int>(sizeof(T));
  if constexpr (N % kPiece == 0) {
#pragma unroll
    for (int k = 0; k < N / kPiece; ++k) {
      const float4 w = __ldcs(reinterpret_cast<const float4*>(p) + k);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int i = 0; i < kPiece; ++i) out[k * kPiece + i] = to_float(e[i]);
    }
  } else {
    load_vec<T, N>(p, out);
  }
}

// N elements rounded from fp32 to T at p, one 16-byte vector stored
// evict-first (`__stcs`) where N * sizeof(T) is 16, else as
// `store_vec_packed`: for outputs written once
template <typename T, int N>
__device__ __forceinline__ void store_vec_once(T* __restrict__ p,
                                               const float (&in)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    float4 w;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_float<T>(in[i]);
    __stcs(reinterpret_cast<float4*>(p), w);
  } else {
    store_vec_packed<T, N>(p, in);
  }
}

}  // namespace apex_port

// One definition per shared library: each library is one translation unit.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The host's record of launches, which chip_smoke.py reads to check each
// call's route: every entry point notes each kernel it launches, by name,
// once the launch call left no error pending. One table a library: the
// table and `note_launch` have internal linkage (each library is one
// translation unit), so no library writes or reads another's.
namespace launch_table {
constexpr int kEntries = 128;
constexpr int kNameBytes = 160;
struct Entry {
  char name[kNameBytes];
  long long count;
};
static Entry entries[kEntries];
static int used = 0;
}  // namespace launch_table

// ``detail`` (e.g. a problem type's typeid name) joins the name as
// name<detail>; a kernel past the table's capacity is not recorded.
[[maybe_unused]] static void note_launch(const char* name,
                                         const char* detail = nullptr) {
  using namespace launch_table;
  if (cudaPeekAtLastError() != cudaSuccess) return;
  char key[kNameBytes];
  if (detail != nullptr)
    snprintf(key, sizeof(key), "%s<%s>", name, detail);
  else
    snprintf(key, sizeof(key), "%s", name);
  for (int i = 0; i < used; ++i) {
    if (strcmp(entries[i].name, key) == 0) {
      ++entries[i].count;
      return;
    }
  }
  if (used < kEntries) {
    snprintf(entries[used].name, kNameBytes, "%s", key);
    entries[used].count = 1;
    ++used;
  }
}

// The table as "name count" lines into buf (cap bytes, NUL-terminated);
// returns the bytes the whole table needs, NUL included.
extern "C" int launch_log(char* buf, int cap) {
  using namespace launch_table;
  int need = 1, at = 0;
  for (int i = 0; i < used; ++i) {
    char line[kNameBytes + 24];
    const int n = snprintf(line, sizeof(line), "%s %lld\n", entries[i].name,
                           entries[i].count);
    need += n;
    if (buf != nullptr && at + n < cap) {
      memcpy(buf + at, line, n);
      at += n;
    }
  }
  if (buf != nullptr && cap > 0) buf[at] = '\0';
  return need;
}

extern "C" void launch_log_reset() { launch_table::used = 0; }
