// The per-cell arithmetic of one scalar Chebyshev step, shared by every
// scalar kernel of the port: the unsharded step kernel (cheb_pass.cu), the
// local step kernel of the sharded engine (local_pass.cu), the ring step
// kernel (ring_pass.cu) and the fused passes of cheb_tile.cuh. The kernels
// differ only in where a value comes from; what they do with it is the value
// functions below, written in the explicitly rounded arithmetic of
// common.cuh, so their results are equal bit for bit.
#pragma once

#include "common.cuh"

namespace {

// -- values in, values out ---------------------------------------------------

// nan_to_num, or with FAST its shorter form (common.cuh): the same value.
template <bool FAST, typename T>
__device__ __forceinline__ T scrub(T x) {
  return FAST ? nan_to_num_fast(x) : nan_to_num(x);
}

// T_0 at a cell from its raw field value: fbar = field [* area]; under the
// h-space mask elimination (drop_pre) h = post * nan_to_num(fbar).
template <bool FAST = false, typename T>
__device__ __forceinline__ T t0_value(T field, bool has_area, T area, bool drop_pre, T post) {
  T x = field;
  if (has_area) x = mul(x, area);
  if (drop_pre) x = mul(post, scrub<FAST>(x));
  return x;
}

// The value the stencil contracts over: [pre *] (zap ? nan_to_num(x) : x).
template <bool FAST = false, typename T>
__device__ __forceinline__ T gather_value(T x, bool zap, bool has_pre, T pre) {
  if (zap) x = scrub<FAST>(x);
  if (has_pre) x = mul(pre, x);
  return x;
}

// lap'(t) at a cell: [post *] (c g + n g_N + s g_S + e g_E + w g_W), summed
// left to right, the first product fused onto the second one.
template <typename T>
__device__ __forceinline__ T lap_value(T c, T n, T s, T e, T w, T g, T gn, T gs, T ge,
                                       T gw, bool has_post, T post) {
  T lap = fmad(c, g, mul(n, gn));
  lap = fmad(s, gs, lap);
  lap = fmad(e, ge, lap);
  lap = fmad(w, gw, lap);
  if (has_post) lap = mul(post, lap);
  return lap;
}

// FIRST: T_1 = -h + 0.5 lap'(h), and acc = p_a h + p_b T_1.
template <typename T>
__device__ __forceinline__ T t1_value(T lap, T h) { return fmad(T(0.5), lap, -h); }

template <typename T>
__device__ __forceinline__ T acc_first(T p_a, T p_b, T h, T t1) {
  return fmad(p_b, t1, mul(p_a, h));
}

// MIDDLE and LAST: T_{k+1} = -2 T_k + lap'(T_k) - T_{k-1}, and acc += p_a T_{k+1}.
template <typename T>
__device__ __forceinline__ T next_value(T t, T lap, T t_prev) {
  return add(fmad(T(-2), t, lap), -t_prev);
}

template <typename T>
__device__ __forceinline__ T acc_add(T p_a, T nxt, T acc) { return fmad(p_a, nxt, acc); }

// The end of LAST: under drop_pre, acc = post == 0 ? land_gain*fbar :
// acc + 0*fbar (the 0*fbar keeps a NaN at a wet cell NaN); then acc /= area.
template <typename T>
__device__ __forceinline__ T finish_value(T acc, T field, bool has_area, T area,
                                          bool drop_pre, T post, T land_gain) {
  T fbar = field;
  if (has_area) fbar = mul(fbar, area);
  if (drop_pre) acc = post == T(0) ? mul(land_gain, fbar) : fmad(fbar, T(0), acc);
  if (has_area) acc = quot(acc, area);
  return acc;
}

// -- the one-step kernels' view: planes in device memory ---------------------

template <typename T>
struct Args {
  int ny, nx;
  const T* field;   // raw field (FIRST, LAST)
  const T* t;       // T_k (MIDDLE, LAST)
  const T* t_prev;  // T_{k-1} (MIDDLE, LAST)
  T* t_next;        // T_{k+1} (FIRST, MIDDLE); may alias t_prev
  T* acc;           // running sum, updated in place
  T* h;             // T_0 output (FIRST)
  const T* coef[5]; // c, n, s, e, w (pre-scaled); null -> cval
  T cval[5];
  const T* pre;
  const T* post;
  const T* area;
  T p_a, p_b, land_gain;
  int zap, fold, drop_pre;
};

template <typename T>
__device__ __forceinline__ T at(const T* p, int64_t k) { return p ? p[k] : T(0); }

// T_0 at plane offset `k` (batch base `b`), from the raw field.
template <typename T>
__device__ __forceinline__ T first_value(const Args<T>& a, int64_t b, int64_t k) {
  return t0_value(a.field[b + k], a.area != nullptr, at(a.area, k), a.drop_pre != 0,
                  at(a.post, k));
}

// The value the stencil contracts over at plane offset `k` (batch base `b`).
template <typename T, int KIND>
__device__ __forceinline__ T gathered(const Args<T>& a, int64_t b, int64_t k) {
  const T x = KIND == FIRST ? first_value(a, b, k) : a.t[b + k];
  return gather_value(x, a.zap != 0, a.pre != nullptr, at(a.pre, k));
}

template <typename T>
__device__ __forceinline__ T coef(const Args<T>& a, int m, int64_t k) {
  return a.coef[m] ? a.coef[m][k] : a.cval[m];
}

// One step at the cell at plane offset `k`, from the gathered values at the
// cell (g) and at its north, south, east and west neighbours.
template <typename T, int KIND>
__device__ __forceinline__ void step_cell(const Args<T>& a, int64_t b, int64_t k,
                                          T g, T gn, T gs, T ge, T gw) {
  const T lap = lap_value(coef(a, 0, k), coef(a, 1, k), coef(a, 2, k), coef(a, 3, k),
                          coef(a, 4, k), g, gn, gs, ge, gw, a.post != nullptr,
                          at(a.post, k));
  if (KIND == FIRST) {
    // T_0 = h is the un-masked-by-pre value at this cell
    const T h = first_value(a, b, k);
    const T t1 = t1_value(lap, h);
    a.h[b + k] = h;
    a.t_next[b + k] = t1;
    a.acc[b + k] = acc_first(a.p_a, a.p_b, h, t1);
    return;
  }
  const T nxt = next_value(a.t[b + k], lap, a.t_prev[b + k]);
  const T acc = acc_add(a.p_a, nxt, a.acc[b + k]);
  if (KIND == MIDDLE) {
    a.t_next[b + k] = nxt;  // in place over t_prev: only this cell read it
    a.acc[b + k] = acc;     // in place
    return;
  }
  // in place: the filtered result
  a.acc[b + k] = finish_value(acc, a.field[b + k], a.area != nullptr, at(a.area, k),
                              a.drop_pre != 0, at(a.post, k), a.land_gain);
}

}  // namespace
