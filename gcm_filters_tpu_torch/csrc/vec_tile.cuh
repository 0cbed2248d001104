// The fused coupled vector Chebyshev pass on shared-memory tiles: S coupled
// (u, v) steps per launch, for the B-grid pair (BGridLap) and the C-grid taps
// (CTapLap) of vec_step.cuh. Entries vec_fused_pass_f32/f64 in vec_pass.cu.
//
// A block owns a by x bx tile of the output, for both components, and runs
// the trapezoid (overlapped-halo) decomposition of the TPU kernel
// (gcm_filters_tpu/ops/pallas/vec_pass.py::_build_coupled_pass, head
// comment), with a halo in both y and x:
//   1. load a window of (by+2H) x (bx+2H) cells, H = S, with its corners
//      (the C-grid's diagonal taps read them from the first step on, and a
//      5-point step reaches them within H steps): periodic in both axes on
//      the whole field, cut from the halo-extended block on a shard; into
//      shared memory: the raw state of both components (w on the first pass,
//      else t and t_prev) and every coefficient plane; acc of the own cells.
//      Every value goes by cp.async straight into its slot, all of a
//      window's copies in flight at once (vec_window_load);
//   2. run the S steps in shared memory; step j updates the window shrunk by
//      j cells on each side, so the last one ends exactly on the own tile.
//      T_{k+1} overwrites T_{k-1} cell by cell (only the cell itself reads
//      it), acc of the own cells is updated in place;
//   3. write the own cells of t, t_prev and acc, or, when the pass ends the
//      filter, only acc (vector grids have no finalize).
// The window holds raw values: nan_to_num (zap) applies where a value enters
// the contraction, as in the step kernels, because the raw t and t_prev
// enter -2t - t_prev. Every value goes through OP::lap and the recurrence
// functions in the same order as in the step kernels, so a cell that two
// tiles compute gets the same bits as in the chain of one-step launches.
//
// The tile geometry is a template parameter (GEO): WrapGeo (cheb_tile.cuh,
// no fold) for the whole periodic field, RoundGeo (below) for the fused
// local round of the sharded engine (entries vec_local_fused_pass_f32/f64),
// whose window comes from the halo-extended shard block instead of a wrap,
// and RingGeo (cheb_tile.cuh, no fold) for a y-shard of the ring (entries
// vec_ring_fused_pass_f32/f64 in ring_pass.cu), whose window rows past the
// shard's edges are halo rows that the neighbours' sends fill. `vec_fused_tile`
// is one tile's whole pass, with the planes (`io`) and the tile's origin as
// arguments: `vec_fused_kernel` runs it for the tile of its blockIdx, the
// ring kernel for the tile its ticket names, with a shard's row of its table.
// Every buffer is indexed through its own plane: the inputs (the state and
// the coefficients) through in_plane/in_index, the carries out through
// out_plane/out_index, acc through own_plane/own_index, and acc exists only
// where has_acc() says so (the core of the shard block). A tile cell outside
// the core steps the carries; its acc slot in shared memory is scratch that
// is never loaded from or stored to device memory.
//
// Bound: issue, with one 512-thread block an SM (a window takes most of its
// shared memory, and the registers allow no second block), no longer HBM. A
// cell-step reads about 23 (B-grid: 10 coefficients, the centre, north,
// south, east and west values of both components, t_prev and acc of both) or
// 31 (C-grid: 18 coefficients and the two diagonal values) shared words and
// writes two to four; the strips of rows per thread share the centre column
// between rows, and a warp's lanes take consecutive (strip, column) pairs so
// that none idles at a window's edge. The redundant cells of the trapezoid
// add (1 + 2H/by)(1 + 2H/bx) - 1 at most. The window's load is the other
// part of the time: 14 or 22 cp.async copies a window cell, each with its
// addresses, issued by the same warps. Its latency is one trip, not one per
// row and column chunk; what is left is issue, and issue is what the steps
// are bound by too, so a second window, loading while this one steps, does
// not hide it: the steps run no faster beside the next window's copies, and
// the smaller tiles that two windows need add redundant cells (PERF.md §6,
// measured on the card). A block keeps one window. Device memory moves each
// input once per pass plus the halos, which neighbouring tiles share through
// L2. The planner (ops/cuda/vec_pass.py::plan_vec_fused_passes) picks the
// tile and the split.
//
// Build without --use_fast_math: it breaks the NaN test in nan_to_num.
#pragma once

#include "cheb_tile.cuh"  // the geometries, FUSED_THREADS, MAX_SHARED, cp_async, Quot
#include "vec_step.cuh"

namespace {

// A halo-extended shard block (ly+2c, lx+2c) of the sharded vector engine, of
// which one launch owns the region shrunk by `shrink` cells: the core and a
// margin of c - shrink cells around it. Own-region coordinates (gy, gx) run
// over [0, ly+2(c-shrink)) x [0, lx+2(c-shrink)). No wrap (the exchange
// placed it); reads past the block are clamped, and such cells lie more than
// n_ops cells from every own cell. The state, the coefficients and the
// carries out are extended planes; acc is core-shaped.
struct RoundGeo {
  int ly, lx, c, shrink;
  __host__ __device__ int margin() const { return c - shrink; }
  __host__ __device__ int rows() const { return ly + 2 * margin(); }
  __host__ __device__ int cols() const { return lx + 2 * margin(); }
  __device__ int row(int gy) const { return min(max(gy + shrink, 0), ly + 2 * c - 1); }
  __device__ int col(int gx, bool) const { return min(max(gx + shrink, 0), lx + 2 * c - 1); }
  __device__ int64_t in_plane() const { return (int64_t)(ly + 2 * c) * (lx + 2 * c); }
  __device__ int64_t in_index(int r, int cc) const { return (int64_t)r * (lx + 2 * c) + cc; }
  __device__ int64_t out_plane() const { return in_plane(); }
  __device__ int64_t out_index(int gy, int gx) const { return in_index(gy + shrink, gx + shrink); }
  __device__ int64_t own_plane() const { return (int64_t)ly * lx; }
  __device__ int64_t own_index(int gy, int gx) const {
    return (int64_t)(gy - margin()) * lx + (gx - margin());
  }
};

// Whether own cell (gy, gx) has an acc: every cell of the periodic field and
// of a ring shard (acc is own-shaped there), the core cells of a shard block.
__device__ __forceinline__ bool has_acc(const WrapGeo&, int, int) { return true; }
__device__ __forceinline__ bool has_acc(const RoundGeo& g, int gy, int gx) {
  return (unsigned)(gy - g.margin()) < (unsigned)g.ly &&
         (unsigned)(gx - g.margin()) < (unsigned)g.lx;
}
__device__ __forceinline__ bool has_acc(const RingGeo&, int, int) { return true; }

// The window's loads go into shared memory by cp.async (cp_async of
// cheb_tile.cuh), except a ring shard's state, which StateAsync<RingGeo>
// sends through registers past L1 (__ldcg): the sends of the same launch
// write its halo rows.
template <typename T, class GEO>
__device__ __forceinline__ T state_ld(const GEO&, const T* p) { return __ldg(p); }
template <typename T>
__device__ __forceinline__ T state_ld(const RingGeo&, const T* p) { return __ldcg(p); }

template <typename T>
struct VecFusedArgs {
  int by, bx;         // the own tile
  int n_ops;          // steps in this pass, = H
  int first, last;    // the pass starts with FIRST / ends with LAST
  T pa[MAX_FUSE];     // p_a of each step of the pass
  T p_b;              // p_b of FIRST
  const T* w;         // the stacked input (first pass), (batch, 2, ny, nx)
  const T* t;         // T_k in (not first)
  const T* t_prev;    // T_{k-1} in (not first)
  const T* acc_in;    // acc in (not first); may alias acc_out
  T* t_out;           // T_k out (not last)
  T* t_prev_out;      // T_{k-1} out (not last)
  T* acc_out;         // acc out, the result on a last pass
  const T* coef;      // (n_coef, ny, nx), pre-scaled
};

// Shared planes of the window: the state pairs A (u, v) and B (u, v) (each
// (by+2H) x (bx+2H)), the n_coef coefficients of every window cell, then acc
// of the own tile for u and for v.
template <typename T>
__host__ __device__ inline size_t vec_fused_shared_bytes(int by, int bx, int H, int n_coef) {
  const size_t wy = by + 2 * H, wx = bx + 2 * H;
  return ((4 + n_coef) * wy * wx + 2 * (size_t)by * bx) * sizeof(T);
}

// Rows a thread steps per work item: it loads the strip's values first,
// then does the arithmetic (one latency per strip instead of one per row; a
// store of the step would keep the compiler from hoisting later rows'
// loads). Fewer for the C-grid's 18 coefficients and for float64, which
// would otherwise spill registers at 512 threads.
template <typename OP, typename T>
__host__ __device__ constexpr int vec_strip() {
  return (OP::N_COEF <= 10 ? 4 : 2) / (sizeof(T) == 4 ? 1 : 2);
}

// Two values in one shared-memory load.
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// Offsets of the window's planes in shared memory (offsets, not pointers,
// keep every access in the shared address space). The coefficients are
// stored cell-major: a cell's n_coef values (an even count) follow each
// other, so a cell-step loads them as n_coef / 2 pairs, without bank
// conflicts at a stride of 10 or 18 words.
struct VecPlanes {
  int wx, wa;   // window width (pitch) and cells
  int coef;     // the coefficients, n_coef per window cell
  int acc;      // acc of the own tile: u, then v
};

// One step (kind KIND) of the window shrunk by j, rows [j, wy-j), columns
// [j, wx-j): the pair at `cur` holds T_k, the pair at `prev` T_{k-1}, and
// T_{k+1} goes over prev. A pair's u plane is at its offset, its v plane one
// window later. `b_acc` is this batch entry's u plane of acc, `io` the
// planes (a LAST step writes io.acc_out).
template <typename T, typename OP, int ZAP, int KIND, class GEO, class IO>
__device__ __forceinline__ void vec_step_window(const VecFusedArgs<T>& a, const IO& io, T* sm,
                                                const VecPlanes& pl, const GEO geo,
                                                int j, int wy, int H, int y0, int x0, int cur,
                                                int prev, T p_a, int64_t b_acc) {
  constexpr int S = vec_strip<OP, T>();
  constexpr int NC = OP::N_COEF;
  const int wx = pl.wx, wa = pl.wa;
  const int own_plane = a.by * a.bx;
  const int rows = wy - 2 * j, cols = wx - 2 * j;
  const int strips = (rows + S - 1) / S;
  const int64_t P = geo.own_plane();
  // A work item is a strip's column: (strip, column) pairs, column fastest,
  // one per thread, so a warp's 32 lanes take 32 consecutive pairs across a
  // strip's end and none idles where `cols` is not a multiple of 32.
  const int pairs = strips * cols;
  const Quot per_strip(cols);
  for (int idx = threadIdx.x; idx < pairs; idx += blockDim.x) {
    const int s_i = per_strip(idx);
    const int q = j + idx - s_i * cols;
    const int r0 = j + s_i * S;
    const int r1 = min(r0 + S, wy - j);  // rows past r1 load clamped rows and are not stored
    // loads, for each component: the centre column on rows r0-1 .. r0+S, the
    // east column on rows r0-1 .. r0+S-1 (v's south-east tap reads the row
    // below), the west column on rows r0 .. r0+S (u's north-west tap reads
    // the row above); the rest on the strip
    T tc[2][S + 2], te[2][S + 1], tw[2][S + 1], cf[S][NC], tp[2][S], ac[2][S];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int base = cur + c * wa;
#pragma unroll
      for (int s = 0; s < S + 2; ++s) tc[c][s] = sm[base + min(r0 - 1 + s, r1) * wx + q];
#pragma unroll
      for (int s = 0; s < S + 1; ++s) {
        te[c][s] = sm[base + min(r0 - 1 + s, r1 - 1) * wx + q + 1];
        tw[c][s] = sm[base + min(r0 + s, r1) * wx + q - 1];
      }
    }
    const unsigned ox = q - H;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = min(r0 + s, r1 - 1);
      const int k = r * wx + q;
      const auto* cp = reinterpret_cast<const typename Pair<T>::type*>(sm + pl.coef + k * NC);
#pragma unroll
      for (int m = 0; m < NC / 2; ++m) {
        const auto c2 = cp[m];
        cf[s][2 * m] = c2.x;
        cf[s][2 * m + 1] = c2.y;
      }
      const unsigned oy = r - H;
      const bool own = KIND != FIRST && oy < (unsigned)a.by && ox < (unsigned)a.bx;
      const int o = pl.acc + (int)oy * a.bx + (int)ox;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        tp[c][s] = KIND == FIRST ? T(0) : sm[prev + c * wa + k];
        ac[c][s] = own ? sm[o + c * own_plane] : T(0);
      }
    }
    T gc[2][S + 2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int s = 0; s < S + 2; ++s) gc[c][s] = gather_value<true>(tc[c][s], ZAP != 0, false, T(0));
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = r0 + s;
      if (r >= r1) break;
      const int k = r * wx + q;
      Nb<T> g[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        g[c].c = gc[c][s + 1];
        g[c].n = gc[c][s + 2];
        g[c].s = gc[c][s];
        g[c].e = gather_value<true>(te[c][s + 1], ZAP != 0, false, T(0));
        g[c].w = gather_value<true>(tw[c][s], ZAP != 0, false, T(0));
        g[c].se = gather_value<true>(te[c][s], ZAP != 0, false, T(0));
        g[c].nw = gather_value<true>(tw[c][s + 1], ZAP != 0, false, T(0));
      }
      T l[2];
      OP::lap([&](int m) { return cf[s][m]; }, g[0], g[1], l[0], l[1]);
      const unsigned oy = r - H;
      if (KIND == LAST) {
        // the window is the own tile
        const int gy = y0 + (int)oy, gx = x0 + (int)ox;
        if (gy < geo.rows() && gx < geo.cols() && has_acc(geo, gy, gx)) {
          const int64_t ko = b_acc + geo.own_index(gy, gx);
#pragma unroll
          for (int c = 0; c < 2; ++c)
            io.acc_out[ko + c * P] = acc_add(p_a, next_value(tc[c][s + 1], l[c], tp[c][s]),
                                             ac[c][s]);
        }
        continue;
      }
      const bool own = oy < (unsigned)a.by && ox < (unsigned)a.bx;
      const int o = pl.acc + (int)oy * a.bx + (int)ox;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (KIND == FIRST) {
          const T t1 = t1_value(l[c], tc[c][s + 1]);
          sm[prev + c * wa + k] = t1;
          if (own) sm[o + c * own_plane] = acc_first(p_a, a.p_b, tc[c][s + 1], t1);
        } else {
          const T nxt = next_value(tc[c][s + 1], l[c], tp[c][s]);
          sm[prev + c * wa + k] = nxt;
          if (own) sm[o + c * own_plane] = acc_add(p_a, nxt, ac[c][s]);
        }
      }
    }
  }
}

// The planes of a window of wa cells, wx wide, in shared memory.
__host__ __device__ inline VecPlanes vec_planes(int wx, int wa, int n_coef) {
  return VecPlanes{wx, wa, 4 * wa, (4 + n_coef) * wa};
}

// Issue the loads of the window of the tile at y0, x0 of batch entry z, and
// of acc of its own cells; the caller commits them as a cp.async group and
// waits (cp_async_wait_all, then __syncthreads) before it reads them. Pair A
// (offset 0) takes T_k (w on a first pass), pair B (2*wa) T_{k-1}; a first
// pass leaves pair B unloaded (its first step writes T_1 there before any
// step reads it). Coefficients go cell-major: a cell's n_coef values follow
// each other. The window's cells are spread over the block's threads,
// row-major, so a warp's copies read consecutive cells of a plane.
template <typename T, typename OP, class GEO, class IO>
__device__ __forceinline__ void vec_window_load(const VecFusedArgs<T>& a, const IO& io,
                                                const GEO geo, T* sm, int y0, int x0,
                                                unsigned z) {
  constexpr int NC = OP::N_COEF;
  const int H = a.n_ops;
  const int wy = a.by + 2 * H, wx = a.bx + 2 * H, wa = wy * wx;
  const VecPlanes pl = vec_planes(wx, wa, NC);
  const int64_t P = geo.in_plane();
  const int64_t b_in = (int64_t)z * 2 * P;
  const T* const s0 = (a.first ? io.w : io.t) + b_in;
  const T* const s1 = a.first ? s0 : io.t_prev + b_in;
  const Quot per_row(wx);
  for (int k = threadIdx.x; k < wa; k += blockDim.x) {
    const int r = per_row(k), q = k - r * wx;
    const int64_t kk = geo.in_index(geo.row(y0 - H + r), geo.col(x0 - H + q, false));
#pragma unroll
    for (int m = 0; m < NC; ++m) cp_async(sm + pl.coef + k * NC + m, io.coef + m * P + kk);
    if constexpr (StateAsync<GEO>::value) {
#pragma unroll
      for (int c = 0; c < 2; ++c) cp_async(sm + c * wa + k, s0 + c * P + kk);
      if (!a.first) {
#pragma unroll
        for (int c = 0; c < 2; ++c) cp_async(sm + (2 + c) * wa + k, s1 + c * P + kk);
      }
    }
  }
  if constexpr (!StateAsync<GEO>::value) {
    // the state through registers, U cells a thread at a time: all their
    // loads, then all their stores
    constexpr int U = 4;
    for (int k0 = threadIdx.x; k0 < wa; k0 += U * blockDim.x) {
      T v[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * blockDim.x;
        if (k < wa) {
          const int r = per_row(k), q = k - r * wx;
          const int64_t kk = geo.in_index(geo.row(y0 - H + r), geo.col(x0 - H + q, false));
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            v[u][c] = state_ld(geo, s0 + c * P + kk);
            v[u][2 + c] = a.first ? T(0) : state_ld(geo, s1 + c * P + kk);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * blockDim.x;
        if (k < wa) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < 2 || !a.first) sm[c * wa + k] = v[u][c];
        }
      }
    }
  }
  if (!a.first) {
    const int own_plane = a.by * a.bx;
    const int64_t PA = geo.own_plane();
    const int64_t b_acc = (int64_t)z * 2 * PA;
    const int ny = geo.rows(), nx = geo.cols();
    for (int i = threadIdx.x; i < own_plane; i += blockDim.x) {
      const int gy = y0 + i / a.bx, gx = x0 + i % a.bx;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        T* const dst = sm + pl.acc + c * own_plane + i;
        if (gy < ny && gx < nx && has_acc(geo, gy, gx))
          cp_async(dst, io.acc_in + b_acc + c * PA + geo.own_index(gy, gx));
        else
          *dst = T(0);
      }
    }
  }
}

// The steps of one tile on its window, which has arrived, and the stores of
// its own cells: the carries and, where it exists, acc (a last pass writes
// acc in its last step instead). Every step ends with __syncthreads, so the
// stores read the last step's values.
template <typename T, typename OP, int ZAP, class GEO, class IO>
__device__ __forceinline__ void vec_window_run(const VecFusedArgs<T>& a, const IO& io,
                                               const GEO geo, T* sm, int y0, int x0,
                                               unsigned z) {
  constexpr int NC = OP::N_COEF;
  const int H = a.n_ops;
  const int wy = a.by + 2 * H, wx = a.bx + 2 * H, wa = wy * wx;
  const VecPlanes pl = vec_planes(wx, wa, NC);
  const int own_plane = a.by * a.bx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  // this entry's u planes (v follows one plane later) of the carries out and acc
  const int64_t PO = geo.out_plane(), PA = geo.own_plane();
  const int64_t b_out = (int64_t)z * 2 * PO;
  const int64_t b_acc = (int64_t)z * 2 * PA;
  const int ny = geo.rows(), nx = geo.cols();

  int cur = 0, prev = 2 * wa;
  for (int i = 0; i < H; ++i) {
    const int j = i + 1;  // this step's window: shrunk by j
    if (a.first && i == 0)
      vec_step_window<T, OP, ZAP, FIRST>(a, io, sm, pl, geo, j, wy, H, y0, x0, cur, prev,
                                         a.pa[i], b_acc);
    else if (a.last && i == H - 1)
      vec_step_window<T, OP, ZAP, LAST>(a, io, sm, pl, geo, j, wy, H, y0, x0, cur, prev,
                                        a.pa[i], b_acc);
    else
      vec_step_window<T, OP, ZAP, MIDDLE>(a, io, sm, pl, geo, j, wy, H, y0, x0, cur, prev,
                                          a.pa[i], b_acc);
    __syncthreads();
    const int tmp = cur;
    cur = prev;
    prev = tmp;
  }
  if (a.last) return;

  for (int r = H + warp; r < H + a.by; r += nwarps) {
    const int gy = y0 - H + r;
    if (gy >= ny) break;
    for (int q = H + lane; q < H + a.bx; q += 32) {
      const int gx = x0 - H + q;
      if (gx >= nx) break;
      const int k = r * wx + q;
      const int64_t ko = b_out + geo.out_index(gy, gx);
      const int o = (r - H) * a.bx + (q - H);
      const bool sums = has_acc(geo, gy, gx);
      const int64_t ka = b_acc + geo.own_index(gy, gx);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        io.t_out[ko + c * PO] = sm[cur + c * wa + k];
        io.t_prev_out[ko + c * PO] = sm[prev + c * wa + k];
        if (sums) io.acc_out[ka + c * PA] = sm[pl.acc + c * own_plane + o];
      }
    }
  }
}

// One tile's pass on one window, all of the block's threads, the dynamic
// shared memory its window: the own cells of the tile at `org` (GridOrigin or
// TileOrigin of cheb_tile.cuh). `a` holds the pass (steps, p_a, tile), `io`
// the planes (w, t, t_prev, acc_in, t_out, t_prev_out, acc_out, coef): the
// VecFusedArgs itself for vec_fused_kernel, a shard's row of a table for the
// ring. The geometry goes by value, here and into vec_step_window: by
// reference, five of the RoundGeo kernels got other register counts than
// when this body was the kernel's own (ptxas -v, compared on the card).
template <typename T, typename OP, int ZAP, class GEO, class IO, class ORG>
__device__ __forceinline__ void vec_fused_tile(const VecFusedArgs<T>& a, const IO& io,
                                               const GEO geo, const ORG& org) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int y0 = org.y0(a.by), x0 = org.x0(a.bx);
  vec_window_load<T, OP>(a, io, geo, sm, y0, x0, org.z());
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  vec_window_run<T, OP, ZAP>(a, io, geo, sm, y0, x0, org.z());
}

template <typename T, typename OP, int ZAP, class GEO>
__global__ void __launch_bounds__(FUSED_THREADS) vec_fused_kernel(const VecFusedArgs<T> a,
                                                                   const GEO geo) {
  vec_fused_tile<T, OP, ZAP>(a, a, geo, GridOrigin{});
}

template <typename T, typename OP, int ZAP, class GEO>
int launch_vec_mode(const VecFusedArgs<T>& a, const GEO& g, dim3 grid, size_t bytes,
                    cudaStream_t st) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vec_fused_kernel<T, OP, ZAP, GEO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  vec_fused_kernel<T, OP, ZAP, GEO><<<grid, FUSED_THREADS, bytes, st>>>(a, g);
  return (int)cudaGetLastError();
}

// Launch one fused vector pass over the own domain of `g` (rows x cols
// cells), tiles of by x bx, one block per tile, with the kernel compiled for
// the contraction and for zap.
template <typename T, class GEO>
int launch_vec_fused(int op, int zap, const VecFusedArgs<T>& a, const GEO& g, int rows,
                     int cols, int batch, cudaStream_t st) {
  if (op != BGRID && op != CTAP) return (int)cudaErrorInvalidValue;
  if (rows < 1 || cols < 1 || a.n_ops < 1 || a.n_ops > MAX_FUSE || a.by < 1 || a.bx < 1 ||
      batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_coef = op == BGRID ? BGridLap::N_COEF : CTapLap::N_COEF;
  const size_t bytes = vec_fused_shared_bytes<T>(a.by, a.bx, a.n_ops, n_coef);
  if (bytes > MAX_SHARED) return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + a.bx - 1) / a.bx, (rows + a.by - 1) / a.by, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (op == BGRID)
    return zap ? launch_vec_mode<T, BGridLap, 1>(a, g, grid, bytes, st)
               : launch_vec_mode<T, BGridLap, 0>(a, g, grid, bytes, st);
  return zap ? launch_vec_mode<T, CTapLap, 1>(a, g, grid, bytes, st)
             : launch_vec_mode<T, CTapLap, 0>(a, g, grid, bytes, st);
}

// Fill the fields both fused entries pass the same way.
template <typename T>
VecFusedArgs<T> vec_fused_args(int by, int bx, int n_ops, int first, int last, const double* pa,
                               double p_b, const T* w, const T* t, const T* t_prev,
                               const T* acc_in, T* t_out, T* t_prev_out, T* acc_out,
                               const T* coef) {
  VecFusedArgs<T> a;
  a.by = by; a.bx = bx; a.n_ops = n_ops; a.first = first; a.last = last;
  for (int i = 0; i < MAX_FUSE; ++i) a.pa[i] = i < n_ops ? T(pa[i]) : T(0);
  a.p_b = T(p_b);
  a.w = w; a.t = t; a.t_prev = t_prev; a.acc_in = acc_in;
  a.t_out = t_out; a.t_prev_out = t_prev_out; a.acc_out = acc_out; a.coef = coef;
  return a;
}

}  // namespace
