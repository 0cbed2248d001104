// What every step kernel of the port shares: the step kinds, nan_to_num, and
// arithmetic with the rounding spelled out.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Kind { FIRST = 0, MIDDLE = 1, LAST = 2 };

template <typename T> struct Lim;
template <> struct Lim<float> { static __device__ __forceinline__ float max() { return FLT_MAX; } };
template <> struct Lim<double> { static __device__ __forceinline__ double max() { return DBL_MAX; } };

// torch.nan_to_num / jnp.nan_to_num: NaN -> 0, +-inf -> +-largest finite.
template <typename T>
__device__ __forceinline__ T nan_to_num(T x) {
  if (isnan(x)) return T(0);
  if (isinf(x)) return x > T(0) ? Lim<T>::max() : -Lim<T>::max();
  return x;
}

// The same values (-0 included) from a compare, two min/max and a select,
// fewer instructions than isnan and isinf. The fused passes, bound by issue,
// scrub with this one, and so does the windowed local vector step, which it
// makes faster. The other one-step kernels keep nan_to_num: with this form
// the 32-register ring kernels spilled more and they all ran slower.
__device__ __forceinline__ float clamp_abs(float x, float m) { return fminf(fmaxf(x, -m), m); }
__device__ __forceinline__ double clamp_abs(double x, double m) { return fmin(fmax(x, -m), m); }

template <typename T>
__device__ __forceinline__ T nan_to_num_fast(T x) {
  return x == x ? clamp_abs(x, Lim<T>::max()) : T(0);
}

// Arithmetic that nvcc can neither contract into an FMA nor split out of one:
// a product is fused with a sum exactly where fmad() says so. The shared step
// functions use nothing else, so every kernel that inlines them rounds alike,
// whatever surrounds the call (plain `a * b + c` is contracted or not
// depending on the code around it, which made kernels differ in the last bit).
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fmad(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmad(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }

}  // namespace
