// The fused scalar Chebyshev pass on shared-memory tiles: S steps per
// launch, shared by the unsharded fused entry (cheb_pass.cu, WrapGeo), the
// fused local round of the sharded engine (local_pass.cu: BlockStripGeo on
// the core and four halo strips) and the fused ring pass (ring_pass.cu, RingGeo). `fused_tile` is one tile's whole
// pass; `fused_pass_kernel` and `local_strip_kernel` run it for the tile of
// their blockIdx, the ring kernel for the tile its blockIdx or its ticket
// names.
//
// A block owns a by x bx tile of the output and runs the trapezoid
// (overlapped-halo) decomposition of the TPU kernel
// (gcm_filters_tpu/ops/pallas/cheb_pass.py, head comment), with a halo in
// both y and x:
//   1. load a window of (by+2H) x (bx+2H) cells, H = S, into shared memory
//      in one burst: every copy of the window goes by cp.async straight into
//      its slot, all of them in flight at once (fused_window_load): the
//      carries (t_prev and t, or on a first pass the raw field and area) and
//      the coefficient planes that are arrays (c, n, s, e, w, post, pre);
//      acc of the own cells. A first pass then computes T_0 = h in place
//      from the raw field, area and post (t0_value), one sweep over the
//      window between two barriers;
//   2. run the S steps; step j updates the window shrunk by j cells on each
//      side, so the last one ends exactly on the own tile. In shared memory
//      (step_window): a step's work items are (strip, column) pairs, one per
//      thread, so no lane idles at a window's right edge; T_{k+1} overwrites
//      T_{k-1} cell by cell (only the cell itself reads it), acc of the own
//      cells is updated in place. Or in registers (reg_steps, a kernel of its
//      own where the planner picks it): each thread holds a run of window
//      rows of one column through the pass, and a step goes to shared memory
//      only for what other threads hold (see "the register steps" below);
//   3. write the own cells of t, t_prev and acc, or, when the pass ends the
//      filter, only the result (land reconstruction and /area fused).
// Every value goes through the functions of cheb_step.cuh in the same order
// as in the step kernels, so a cell that two tiles compute, or that a tile
// computes as a mirror, gets the same bits as in the chain of one-step
// launches.
//
// The tripolar fold (WrapGeo with fold): window rows above the top row are
// mirror cells, ext row ny-1+m = real row ny-m reversed in x. A mirror cell
// is stepped as the real cell R it mirrors: with R's own coefficients and
// masks (loaded from R's index) and with its window neighbours in swapped
// roles (R's north is the window's south, R's east the window's west). In
// the fixed summation order c, n, s, e, w that is R's arithmetic exactly.
// Window rows below row 0 wrap to the top rows (as the step kernel's south
// neighbour of row 0 does); there the window's north neighbour of real row
// ny-1 is row 0 and not the fold, so those cells drift from the step chain,
// and the drift would reach row 0 one step later. Row 0 is land on every
// fold grid (`_check_antarctica` raises otherwise) and its Laplacian is zero
// whatever its south neighbour holds (post = 0, or all coefficients 0), so
// no real cell reads the drift.
//
// Bound: issue in the steps, no longer HBM. In shared memory a cell-step
// reads about 7 shared words (the centre column shared by a strip's rows,
// east, west, c, post, t_prev, acc of an own cell) and writes one or two; the
// (strip, column) items keep every lane of a round busy but the last
// round's; the redundant cells of the trapezoid add (1 + 2H/by)(1 + 2H/bx) -
// 1 at most. In registers a cell-step reads east, west, post and 2/R of a
// row's ends and writes one word, about 12 instructions, but every slot of a
// run is stepped (68% of them in the shrunk windows of 11 steps on 40x80),
// 128 registers hold one block (16 warps) an SM, and the window's load and
// the lift no longer hide under another block's steps. Measured on one H100
// (PERF.md §6, python3 -m gcm_filters_tpu_torch.utils.tile_split): on the
// 2400x3600 float32 headline (40x80 tiles, one pass of 11 steps) the steps
// took 82% of 0.444 ms in shared memory (two blocks an SM), and take 0.270
// ms of 0.395 in registers, where a tile's window, lift and steps run about
// 8.7k, 3.1k and 20.9k cycles a warp (clock64). Device memory moves each
// input once per pass plus the halos, which neighbouring tiles share
// through L2.
//
// Build without --use_fast_math: it breaks the NaN test in nan_to_num and the
// 0*fbar NaN poison.
#pragma once

#include "cheb_step.cuh"

namespace {

constexpr int MAX_FUSE = 16;       // steps per pass at most (the halo, H)
constexpr int FUSED_THREADS = 512; // 16 warps; a warp walks one window row
constexpr size_t MAX_SHARED = 232448;  // what a block may take on sm_90

template <typename T>
struct FusedArgs {
  int by, bx;        // the own tile
  int n_ops;         // steps in this pass, = H
  int first, last;   // the pass starts with FIRST / ends with LAST
  T pa[MAX_FUSE];    // p_a of each step of the pass
  T p_b;             // p_b of FIRST
  const T* field;    // raw field of the window (first pass), in-plane indexed
  const T* field_own;  // raw field of the own cells (last pass), own-plane indexed
  const T* t;        // T_k in (not first)
  const T* t_prev;   // T_{k-1} in (not first)
  const T* acc_in;   // acc in (not first); may alias acc_out
  T* t_out;          // T_k out (not last)
  T* t_prev_out;     // T_{k-1} out (not last)
  T* acc_out;        // acc out, or the result on a last pass
  const T* coef[5];  // c, n, s, e, w (pre-scaled); null -> cval
  T cval[5];
  const T* pre;
  const T* post;
  const T* area;
  T land_gain;
  int zap, drop_pre;
  int regs;          // 1: the pass takes the register steps where they fit (reg_path)
};

// Planes: "in" planes (t, t_prev, the first pass's field and every
// coefficient plane) and "out" planes (t_out, t_prev_out) are indexed by
// in_index/out_index, the own planes (acc, the result, the last pass's
// field) by own_index. Window row gy, column gx are in the own domain's
// coordinates and may lie outside it.

// The whole field: x periodic, y periodic or folded at the top.
struct WrapGeo {
  int ny, nx, fold;
  __device__ int rows() const { return ny; }
  __device__ int cols() const { return nx; }
  __device__ bool mirror(int gy) const { return fold && gy >= ny; }
  // one add or subtract where the field is at least a window wide, as the
  // planner's predicate makes it; the loops cover smaller fields too
  __device__ int row(int gy) const {
    if (mirror(gy)) gy = 2 * ny - 1 - gy;  // ext row ny-1+m -> real row ny-m
    while (gy < 0) gy += ny;
    while (gy >= ny) gy -= ny;
    return gy;
  }
  __device__ int col(int gx, bool mir) const {
    while (gx < 0) gx += nx;
    while (gx >= nx) gx -= nx;
    return mir ? nx - 1 - gx : gx;
  }
  __device__ int64_t in_plane() const { return (int64_t)ny * nx; }
  __device__ int64_t in_index(int r, int c) const { return (int64_t)r * nx + c; }
  __device__ int64_t own_plane() const { return (int64_t)ny * nx; }
  __device__ int64_t own_index(int gy, int gx) const { return (int64_t)gy * nx + gx; }
  __device__ int64_t out_plane() const { return (int64_t)ny * nx; }
  __device__ int64_t out_index(int gy, int gx) const { return (int64_t)gy * nx + gx; }
};

// A y-shard of the ring (ly rows of nx cells): every "in" plane is the
// shard's block extended by `pad` rows below and above, whose halo rows the
// neighbours' sends fill (the bottom shard's south halo holds the top shard's
// top rows: y wraps); x is periodic. On the top shard of a fold grid
// (`fold`) window rows above ly-1 are mirror cells of the shard's own top
// rows, as WrapGeo's are of the field's (needs ly >= the pass's halo). Rows
// further than the pass's halo from every own row are clamped into the
// block: their values reach no own cell. The carries go to the own rows of
// extended planes; acc and the last pass's field are own-shaped. The state
// of a window row that lies in the shard's own rows (own()) goes by
// cp.async; that of a halo row, which the sends of the same launch write,
// past L1 after the flag wait (fused_halo_load).
struct RingGeo {
  int ly, nx, pad, fold;
  __device__ int rows() const { return ly; }
  __device__ int cols() const { return nx; }
  __device__ bool mirror(int gy) const { return fold && gy >= ly; }
  // whether window row gy reads the shard's own rows: rows [0, ly) and, on a
  // folding top shard, the mirror rows above them
  __device__ bool own(int gy) const { return (unsigned)gy < (unsigned)ly || (fold && gy >= ly); }
  __device__ int row(int gy) const {
    if (mirror(gy)) gy = max(2 * ly - 1 - gy, 0);  // ext row ly-1+m -> real row ly-m
    return min(max(gy, -pad), ly + pad - 1) + pad;
  }
  __device__ int col(int gx, bool mir) const {
    while (gx < 0) gx += nx;
    while (gx >= nx) gx -= nx;
    return mir ? nx - 1 - gx : gx;
  }
  __device__ int64_t in_plane() const { return (int64_t)(ly + 2 * pad) * nx; }
  __device__ int64_t in_index(int r, int c) const { return (int64_t)r * nx + c; }
  __device__ int64_t own_plane() const { return (int64_t)ly * nx; }
  __device__ int64_t own_index(int gy, int gx) const { return (int64_t)gy * nx + gx; }
  __device__ int64_t out_plane() const { return in_plane(); }
  __device__ int64_t out_index(int gy, int gx) const { return (int64_t)(gy + pad) * nx + gx; }
};

// A halo-extended block (ly+2c, lx+2c) of the sharded engine: the own domain
// is its core, no wrap and no fold (the exchange placed them). Reads past
// the block are clamped: such cells lie more than S cells from the core.
// The base of BlockStripGeo, which launches on it.
struct BlockGeo {
  int ly, lx, c;
  __device__ int rows() const { return ly; }
  __device__ int cols() const { return lx; }
  __device__ bool mirror(int) const { return false; }
  __device__ int row(int gy) const { return min(max(gy + c, 0), ly + 2 * c - 1); }
  __device__ int col(int gx, bool) const { return min(max(gx + c, 0), lx + 2 * c - 1); }
  __device__ int64_t in_plane() const { return (int64_t)(ly + 2 * c) * (lx + 2 * c); }
  __device__ int64_t in_index(int r, int cc) const { return (int64_t)r * (lx + 2 * c) + cc; }
  __device__ int64_t own_plane() const { return (int64_t)ly * lx; }
  __device__ int64_t own_index(int gy, int gx) const { return (int64_t)gy * lx + gx; }
  __device__ int64_t out_plane() const { return in_plane(); }
  __device__ int64_t out_index(int gy, int gx) const { return in_index(gy + c, gx + c); }
};

// A round of the sharded engine on strips (entries local_strip_pass_f32/f64):
// BlockGeo's block and own domain with no extended copy of the state. The
// state of a window cell lies where the exchange left it: the core's own
// planes, read in place (the caller's field on round 0, the previous round's
// core-shaped carries later; a row pitch and a batch stride), or one of the
// four halo strips of parallel/halo.py::exchange_strips, south and north
// (batch, c, lx+2c) with the corners, west and east (batch, ly, c). The
// clamps of BlockGeo::row/col pick the extended cell, so every window cell
// gets the value it gets from the extended block. The coefficients and area
// stay on the extended planes (in_index); acc and the carries out are
// core-shaped (own_index), and the next round reads those in place.
struct BlockStripGeo : BlockGeo {
  int64_t own_batch, own_pitch;  // of the own planes: batch stride, row pitch
  __device__ int64_t out_plane() const { return own_plane(); }
  __device__ int64_t out_index(int gy, int gx) const { return own_index(gy, gx); }
};

// The planes of a launch on strips, the kernel's argument: the pass and its
// planes as FusedArgs (field, t and t_prev unused), and the sources of the
// window's two state planes, [0] the raw field (a first round) or T_{k-1},
// [1] T_k: [plane][south, north, west, east, own], own at core cell (0, 0)
// of batch entry 0.
template <typename T>
struct StripArgs : FusedArgs<T> {
  const T* src[2][5];
};

// Where the state of extended cell (r, cc) of batch entry z lies: source s
// (0 south, 1 north, 2 west, 3 east, 4 the own planes) at the offset returned.
__device__ __forceinline__ int64_t block_strip_cell(const BlockStripGeo g, int r, int cc,
                                                    unsigned z, int& s) {
  const int c = g.c, ex = g.lx + 2 * c;
  if (r < c) { s = 0; return ((int64_t)z * c + r) * ex + cc; }
  if (r >= c + g.ly) { s = 1; return ((int64_t)z * c + (r - c - g.ly)) * ex + cc; }
  if (cc < c) { s = 2; return ((int64_t)z * g.ly + (r - c)) * c + cc; }
  if (cc >= c + g.lx) { s = 3; return ((int64_t)z * g.ly + (r - c)) * c + (cc - c - g.lx); }
  s = 4;
  return z * g.own_batch + (r - c) * g.own_pitch + (cc - c);
}

// The window's copies. cp.async puts a value from device memory straight
// into its shared-memory slot, with no round trip through a register, so
// every copy of a window is in flight at once: one latency per window, where
// a load into a register and a store per cell queue one behind the other.
// cp.async of 4 or 8 bytes caches in L1, so it copies only what no block of
// the launch writes: the coefficients, acc of the own tile (only its tile
// writes it), the carries of the whole field and of a shard block, a strip
// round's own planes and strips (the launch writes fresh core-shaped carries,
// which the wrapper checks alias nothing it reads), and the state of a ring
// shard's own rows (the sends read them, the tiles write the other carry
// pair). The state of a ring shard's halo rows goes through registers past
// L1 (__ldcg, fused_halo_load) after the flag wait: the sends of the same
// launch write those rows, and a 128-byte line that a .ca copy of an own row
// brings into L1 may hold the start of a halo row still stale, so no halo
// cell is ever read through L1.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Whether the state of every window row may go into the window by cp.async
// (see above); on RingGeo only that of the rows own() names.
template <class GEO> struct StateAsync { static constexpr bool value = true; };
template <> struct StateAsync<RingGeo> { static constexpr bool value = false; };

// n / d for 0 <= n < 2^32 / d, as a multiply-high by the rounded-up
// reciprocal m = ceil(2^32 / d): exact there, since m*d - 2^32 < d.
struct Quot {
  unsigned long long m;
  __device__ explicit Quot(int d) : m(0xFFFFFFFFull / (unsigned)d + 1) {}
  __device__ int operator()(int n) const { return (int)(((unsigned long long)n * m) >> 32); }
};

// Shared planes of one window: 2 carries, the array coefficients, post, pre
// (each (by+2H) x (bx+2H)), then acc of the own tile.
template <typename T>
__host__ __device__ inline size_t fused_shared_bytes(const FusedArgs<T>& a) {
  int planes = 2;
  for (int m = 0; m < 5; ++m) planes += a.coef[m] != nullptr;
  planes += (a.post != nullptr) + (a.pre != nullptr);
  const size_t wy = a.by + 2 * a.n_ops, wx = a.bx + 2 * a.n_ops;
  return (planes * wy * wx + (size_t)a.by * a.bx) * sizeof(T);
}

// Stencil shapes the kernel is compiled for. Every branch on them is
// resolved at compile time; GENERIC reads them from the arguments.
enum Mode {
  GENERIC = 0,  // any combination of zap, pre, post and coefficient arrays
  HSPACE = 1,   // no zap, no pre, post, c an array, n s e w constants (the
                // masked grids under the h-space elimination)
  FLUX = 2,     // zap, no pre, no post, c n s e w arrays (flux-form grids)
};

template <typename T, int MODE>
struct Tile {
  const FusedArgs<T>& a;
  T* sm;       // the window planes
  int wx;      // window width (pitch of every plane)
  int o_coef[5], o_post, o_pre, o_acc;  // plane offsets; -1: absent

  __device__ bool zap() const { return MODE == GENERIC ? a.zap != 0 : MODE == FLUX; }
  __device__ bool has_pre() const { return MODE == GENERIC && o_pre >= 0; }
  __device__ bool has_post() const { return MODE == GENERIC ? o_post >= 0 : MODE == HSPACE; }
  __device__ bool coef_array(int m) const {
    return MODE == GENERIC ? o_coef[m] >= 0 : MODE == FLUX || m == 0;
  }
  __device__ T coef(int m, int k) const { return coef_array(m) ? sm[o_coef[m] + k] : a.cval[m]; }
  __device__ T gat(T x, int k) const {
    return gather_value<true>(x, zap(), has_pre(), has_pre() ? sm[o_pre + k] : T(0));
  }
};

// Rows a thread steps per work item: it loads the strip's values first,
// then does the arithmetic (one latency per strip instead of one per row),
// and keeps the centre column in registers (a cell loads its east and west,
// and one more centre value).
constexpr int STRIP = 4;

// One step (kind KIND) of the window shrunk by j, rows [j, wy-j), columns
// [j, wx-j): cur holds T_k, prev T_{k-1}, T_{k+1} goes over prev. `pl` holds
// the planes (see fused_tile). A work item is a strip's column: (strip,
// column) pairs, column fastest, one per thread, so a warp's 32 lanes take
// 32 consecutive pairs across a strip's end and none idles where the
// window's width is not a multiple of 32.
template <typename T, int MODE, int KIND, class Geo, class P>
__device__ __forceinline__ void step_window(const Tile<T, MODE>& tl, const P& pl, const Geo geo,
                                            int j, int wy, int H, int y0, int x0, int cur,
                                            int prev, T p_a, int64_t b_own) {
  const FusedArgs<T>& a = tl.a;
  T* const sm = tl.sm;
  const int wx = tl.wx;
  const int rows = wy - 2 * j, cols = wx - 2 * j;
  const int pairs = (rows + STRIP - 1) / STRIP * cols;
  const Quot per_strip(cols);
  const int ny = geo.rows(), nx = geo.cols();
  for (int idx = threadIdx.x; idx < pairs; idx += blockDim.x) {
    const int s_i = per_strip(idx);
    const int q = j + idx - s_i * cols;
    const int r0 = j + s_i * STRIP;
    const int r1 = min(r0 + STRIP, wy - j);  // rows past r1 load row r1-1 and are not stored
    // loads: the centre column on rows r0-1 .. r0+STRIP, the rest on the strip
    T tc[STRIP + 2], te[STRIP], tw[STRIP], cf[STRIP][5], po[STRIP], tp[STRIP], ac[STRIP];
#pragma unroll
    for (int s = 0; s < STRIP + 2; ++s) tc[s] = sm[cur + min(r0 - 1 + s, r1) * wx + q];
    const unsigned ox = q - H;
#pragma unroll
    for (int s = 0; s < STRIP; ++s) {
      const int k = min(r0 + s, r1 - 1) * wx + q;
      te[s] = sm[cur + k + 1];
      tw[s] = sm[cur + k - 1];
#pragma unroll
      for (int m = 0; m < 5; ++m) cf[s][m] = tl.coef(m, k);
      po[s] = tl.has_post() ? sm[tl.o_post + k] : T(0);
      tp[s] = KIND == FIRST ? T(0) : sm[prev + k];
      const unsigned oy = min(r0 + s, r1 - 1) - H;
      ac[s] = KIND != FIRST && oy < (unsigned)a.by && ox < (unsigned)a.bx
                  ? sm[tl.o_acc + (int)oy * a.bx + (int)ox] : T(0);
    }
    T g[STRIP + 2];
#pragma unroll
    for (int s = 0; s < STRIP + 2; ++s) g[s] = tl.gat(tc[s], min(r0 - 1 + s, r1) * wx + q);
#pragma unroll
    for (int s = 0; s < STRIP; ++s) {
      const int r = r0 + s;
      if (r >= r1) break;
      const int k = r * wx + q;
      const T ge = tl.gat(te[s], k + 1), gw = tl.gat(tw[s], k - 1);
      // a mirror cell's north is the window's south, its east the window's west
      const bool mir = geo.mirror(y0 - H + r);
      const T lap = lap_value(cf[s][0], cf[s][1], cf[s][2], cf[s][3], cf[s][4], g[s + 1],
                              mir ? g[s] : g[s + 2], mir ? g[s + 2] : g[s], mir ? gw : ge,
                              mir ? ge : gw, tl.has_post(), po[s]);
      const unsigned oy = r - H;
      const bool own = oy < (unsigned)a.by && ox < (unsigned)a.bx;
      const int o = tl.o_acc + (int)oy * a.bx + (int)ox;
      if (KIND == FIRST) {
        const T t1 = t1_value(lap, tc[s + 1]);
        sm[prev + k] = t1;
        if (own) sm[o] = acc_first(p_a, a.p_b, tc[s + 1], t1);
      } else if (KIND == MIDDLE) {
        const T nxt = next_value(tc[s + 1], lap, tp[s]);
        sm[prev + k] = nxt;
        if (own) sm[o] = acc_add(p_a, nxt, ac[s]);
      } else {
        // LAST: the window is the own tile
        const int gy = y0 + (int)oy, gx = x0 + (int)ox;
        if (gy < ny && gx < nx) {
          const T acc = acc_add(p_a, next_value(tc[s + 1], lap, tp[s]), ac[s]);
          const int64_t kk = geo.in_index(geo.row(gy), geo.col(gx, false));
          const int64_t ko = b_own + geo.own_index(gy, gx);
          pl.acc_out[ko] = finish_value(acc, at(pl.field_own, ko), pl.area != nullptr,
                                        at(pl.area, kk), a.drop_pre != 0, po[s], a.land_gain);
        }
      }
    }
  }
}

// -- the register steps ----------------------------------------------------
//
// A thread owns a run of R consecutive window rows in one column for the
// whole pass: thread t < runs (ceil(wy / R) run rows of wx columns) takes
// column t % wx and rows [R (t / wx), R (t / wx) + R), so a warp's lanes take
// consecutive columns. After the window's load the thread lifts its run into
// registers (RegRun): T_k, T_{k-1}, the coefficient arrays, pre and acc
// (post too, but a step reads it from its plane: held, it spilled). The
// window's planes are then dead, and two exchange planes and a post plane
// take their room: column-major, P rows a column (P odd, so a warp's lanes,
// a column apart, hit 32 banks), with a column of padding on each side. A
// step reads from an exchange plane only what another thread holds: the
// gathered T_k of each cell's east and west neighbours and of the rows just
// below and just above the run, all at constant offsets from one address; it
// steps its cells in registers with the value functions of cheb_step.cuh in
// step_window's order, publishes the gathered T_{k+1} of each into the other
// plane, and one barrier a step separates the two. Every slot of a run is
// stepped, with no branch or select: a cell outside the step's shrunk window
// computes values that no later step reads (the windows only shrink), and
// the padding keeps its reads and writes inside the planes; only the own
// cells' results leave the registers. No run holds a mirror cell: the
// register kernel steps a window that reaches the fold (the top tiles of a
// fold grid) in shared memory; the selects of mirror cells spilled.

// Rows of a thread's run in the register steps of a dtype and mode; 0: the
// mode keeps step_window. R is the least that lets the block's threads cover
// the headline window (62 x 102: 5 run rows of 13) and no more, since every
// row of a run holds its values in registers: an instantiation whose run
// would spill keeps step_window (ptxas -v, csrc/ptxas_lines.json): float64
// and the modes with more array planes (FLUX, GENERIC). R 14 and 16 spilled,
// and 1024 threads a block of R 7 to 9 (64 registers) spilled and ran
// slower (PERF.md §6).
template <typename T, int MODE> struct RegRows { static constexpr int value = 0; };
template <> struct RegRows<float, HSPACE> { static constexpr int value = 13; };

// Rows a column of an exchange plane holds: the run rows', made odd.
__host__ __device__ constexpr int reg_pitch(int wy, int r) { return (wy + r - 1) / r * r | 1; }

// Whether a pass takes the register steps: the caller asks for them (the
// planner weighs both steps, ops/cuda/cheb_pass.py::fused_path), the mode
// has a run length, the block's threads cover the window's runs, and the two
// exchange planes and the post plane fit in the window's shared memory
// (reg_fits there mirrors
// this). The register steps are kernels of their own (REG), so a pass in
// shared memory keeps the registers, and the blocks an SM, of step_window.
template <typename T, int MODE>
__host__ __device__ inline bool reg_path(const FusedArgs<T>& a) {
  constexpr int R = RegRows<T, MODE>::value;
  const int wy = a.by + 2 * a.n_ops, wx = a.bx + 2 * a.n_ops;
  return R > 0 && a.regs && (wy + R - 1) / R * wx <= FUSED_THREADS &&
         3 * (wx + 2) * reg_pitch(wy, R) * sizeof(T) <= fused_shared_bytes(a);
}

// One thread's run: its cells' values (slot s is window row r0 + s of
// column q) and the masks of its slots that are own cells and mirror cells.
template <typename T, int MODE, int R>
struct RegRun {
  T x[R], y[R];  // T_k and T_{k-1}, the roles trading places every step
  T cf[R][5];    // the coefficient arrays of the mode
  T po[R], pr[R];  // post: lifted, then read from the post plane
  T ac[R];
  int q, r0;     // column and first row; q < 0: no run
  int e0;        // exchange-plane offset of slot 0: (q + 1) P + r0
  unsigned own;  // the slots that are own cells
};

// The gathered value of a cell's T from its own pre (Tile::gat's value).
template <typename T, int MODE>
__device__ __forceinline__ T reg_gat(const Tile<T, MODE>& tl, T x, T pre) {
  return gather_value<true>(x, tl.zap(), tl.has_pre(), pre);
}

// One step (kind KIND) in registers: `cur` holds T_k, T_{k+1} goes over
// `old` (T_{k-1}); the neighbours' gathered T_k come from exchange plane
// `in` (P rows a column; plane 0 or 1, `out` the other), post from the post
// plane (2), and with `publish` the gathered T_{k+1} goes into plane `out`.
// No slot is a mirror cell (fused_tile steps a window that reaches the fold
// in shared memory). LAST writes the result of the own cells.
template <int KIND, typename T, int MODE, int R, class Geo, class P>
__device__ __forceinline__ void reg_step(const Tile<T, MODE>& tl, const P& pl, const Geo geo,
                                         RegRun<T, MODE, R>& v, T (&cur)[R], T (&old)[R],
                                         int P_, int H, int y0, int x0, int in, int out,
                                         T p_a, bool publish, int64_t b_own) {
  const FusedArgs<T>& a = tl.a;
  T* const sm = tl.sm;
  const T* const se = sm + in + v.e0;  // slot 0 in plane `in`
  // and in the post plane, after the two (in + out: one plane's words)
  const T* const sp = sm + 2 * (in + out) + v.e0;
  T ge[R], gw[R], g[R + 2];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    ge[s] = se[s + P_];
    gw[s] = se[s - P_];
  }
  // the rows just below and just above the run
  g[0] = se[-1];
  g[R + 1] = se[R];
#pragma unroll
  for (int s = 0; s < R; ++s) g[s + 1] = reg_gat(tl, cur[s], v.pr[s]);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const T lap = lap_value(tl.coef_array(0) ? v.cf[s][0] : a.cval[0],
                            tl.coef_array(1) ? v.cf[s][1] : a.cval[1],
                            tl.coef_array(2) ? v.cf[s][2] : a.cval[2],
                            tl.coef_array(3) ? v.cf[s][3] : a.cval[3],
                            tl.coef_array(4) ? v.cf[s][4] : a.cval[4], g[s + 1], g[s + 2], g[s],
                            ge[s], gw[s], tl.has_post(), sp[s]);
    if (KIND == FIRST) {
      const T t1 = t1_value(lap, cur[s]);
      v.ac[s] = acc_first(p_a, a.p_b, cur[s], t1);
      old[s] = t1;
    } else if (KIND == MIDDLE) {
      const T nxt = next_value(cur[s], lap, old[s]);
      v.ac[s] = acc_add(p_a, nxt, v.ac[s]);
      old[s] = nxt;
    } else if ((v.own >> s) & 1u) {
      // LAST: the result of the own cells, the window shrunk by H
      const int gy = y0 - H + v.r0 + s, gx = x0 - H + v.q;
      if (gy < geo.rows() && gx < geo.cols()) {
        const T acc = acc_add(p_a, next_value(cur[s], lap, old[s]), v.ac[s]);
        const int64_t kk = geo.in_index(geo.row(gy), geo.col(gx, false));
        const int64_t ko = b_own + geo.own_index(gy, gx);
        pl.acc_out[ko] = finish_value(acc, at(pl.field_own, ko), pl.area != nullptr,
                                      at(pl.area, kk), a.drop_pre != 0, sp[s], a.land_gain);
      }
    }
  }
  if (KIND != LAST && publish) {
    T* const so = sm + out + v.e0;
#pragma unroll
    for (int s = 0; s < R; ++s) so[s] = reg_gat(tl, old[s], v.pr[s]);
  }
}

// Where a block's tile lies: the tile of its blockIdx, batch entry
// blockIdx.z (the grid of fused_pass_kernel), with nothing to wait for
// before the state of its halo loads (the ring's tiles, RingTile of
// ring_pass.cu, wait for flags there). z() is unsigned, as blockIdx.z is: an
// int there changed the fused K1's registers and spills.
struct GridOrigin {
  __device__ int y0(int by) const { return blockIdx.y * by; }
  __device__ int x0(int bx) const { return blockIdx.x * bx; }
  __device__ unsigned z() const { return blockIdx.z; }
  __device__ void wait() const {}
};

// Issue the copies of the window of the tile at (y0, x0), batch bases b_in
// (the "in" planes) and b_own (acc), and of acc of its own cells; the caller
// commits them as a cp.async group and waits (cp_async_wait_all, then
// __syncthreads) before it reads them. Plane 0 takes t_prev, plane 1 t; a
// first pass takes the raw field into plane 0 and area into plane 1, which
// its first step overwrites with T_1 after the transform has read it. The
// window's cells are spread over the block's threads, row-major, so a
// warp's copies read consecutive cells of a plane; a row above the fold
// reads its real row reversed in x. Clamped rows of a shard block or a ring
// shard copy a source cell into several slots, each its own copy. On a ring
// shard (StateAsync false) only the state of the rows own() names goes here;
// that of its halo rows waits for fused_halo_load.
template <typename T, class Geo, int MODE, class P>
__device__ __forceinline__ void fused_window_load(const Tile<T, MODE>& tl, const P& pl,
                                                  const Geo geo, int wy, int H, int y0, int x0,
                                                  int64_t b_in, int64_t b_own) {
  const FusedArgs<T>& a = tl.a;
  T* const sm = tl.sm;
  const int wx = tl.wx, wa = wy * wx;
  const bool first = a.first != 0;
  const Quot per_row(wx);
  for (int k = threadIdx.x; k < wa; k += blockDim.x) {
    const int r = per_row(k), q = k - r * wx;
    const int gy = y0 - H + r;
    const int64_t kk = geo.in_index(geo.row(gy), geo.col(x0 - H + q, geo.mirror(gy)));
#pragma unroll
    for (int m = 0; m < 5; ++m)
      if (tl.coef_array(m)) cp_async(sm + tl.o_coef[m] + k, pl.coef[m] + kk);
    if (tl.has_post()) cp_async(sm + tl.o_post + k, pl.post + kk);
    if (tl.has_pre()) cp_async(sm + tl.o_pre + k, pl.pre + kk);
    if (first && pl.area) cp_async(sm + wa + k, pl.area + kk);
    if constexpr (StateAsync<Geo>::value) {
      if (first) {
        cp_async(sm + k, pl.field + b_in + kk);
      } else {
        cp_async(sm + k, pl.t_prev + b_in + kk);
        cp_async(sm + wa + k, pl.t + b_in + kk);
      }
    } else if (geo.own(gy)) {
      if (first) {
        cp_async(sm + k, pl.field + b_in + kk);
      } else {
        cp_async(sm + k, pl.t_prev + b_in + kk);
        cp_async(sm + wa + k, pl.t + b_in + kk);
      }
    }
  }
  if (!first) {
    const int ny = geo.rows(), nx = geo.cols();
    const Quot per_tile_row(a.bx);
    for (int i = threadIdx.x; i < a.by * a.bx; i += blockDim.x) {
      const int oy = per_tile_row(i);
      const int gy = y0 + oy, gx = x0 + i - oy * a.bx;
      if (gy < ny && gx < nx)
        cp_async(sm + tl.o_acc + i, pl.acc_in + b_own + geo.own_index(gy, gx));
      else
        sm[tl.o_acc + i] = T(0);
    }
  }
}

// The window's copies on a strip round (BlockStripGeo, StripArgs): as above,
// but a window cell's state comes from where block_strip_cell finds it, the
// own planes or a strip, never from an extended block. The coefficient and
// acc copies repeat the general load's rather than share a helper with it,
// so the kernels that inline that one keep their code and their recorded
// ptxas -v lines. The strip kernel's tiles are GridOrigin's: batch entry
// blockIdx.z.
template <typename T, int MODE, class P>
__device__ __forceinline__ void fused_window_load(const Tile<T, MODE>& tl, const P& pl,
                                                  const BlockStripGeo geo, int wy, int H, int y0,
                                                  int x0, int64_t, int64_t b_own) {
  const FusedArgs<T>& a = tl.a;
  T* const sm = tl.sm;
  const int wx = tl.wx, wa = wy * wx;
  const bool first = a.first != 0;
  const unsigned z = blockIdx.z;
  const Quot per_row(wx);
  for (int k = threadIdx.x; k < wa; k += blockDim.x) {
    const int r = per_row(k), q = k - r * wx;
    const int er = geo.row(y0 - H + r), ec = geo.col(x0 - H + q, false);
    const int64_t kk = geo.in_index(er, ec);
#pragma unroll
    for (int m = 0; m < 5; ++m)
      if (tl.coef_array(m)) cp_async(sm + tl.o_coef[m] + k, pl.coef[m] + kk);
    if (tl.has_post()) cp_async(sm + tl.o_post + k, pl.post + kk);
    if (tl.has_pre()) cp_async(sm + tl.o_pre + k, pl.pre + kk);
    if (first && pl.area) cp_async(sm + wa + k, pl.area + kk);
    int s;
    const int64_t off = block_strip_cell(geo, er, ec, z, s);
    cp_async(sm + k, pl.src[0][s] + off);
    if (!first) cp_async(sm + wa + k, pl.src[1][s] + off);
  }
  if (!first) {
    const int ny = geo.rows(), nx = geo.cols();
    const Quot per_tile_row(a.bx);
    for (int i = threadIdx.x; i < a.by * a.bx; i += blockDim.x) {
      const int oy = per_tile_row(i);
      const int gy = y0 + oy, gx = x0 + i - oy * a.bx;
      if (gy < ny && gx < nx)
        cp_async(sm + tl.o_acc + i, pl.acc_in + b_own + geo.own_index(gy, gx));
      else
        sm[tl.o_acc + i] = T(0);
    }
  }
}

// The state of the window rows outside a ring shard's own rows (RingGeo,
// where StateAsync is false; nothing elsewhere), after the wait for the
// flags of those rows: through registers past L1 (__ldcg), U cells a thread
// at a time, all their loads, then all their stores. Window rows [0, lo) lie
// below row 0, rows [hi, wy) from row ly on, none on a folding top shard,
// whose rows above ly are mirror cells of its own; an interior tile has
// none. The caller waits for the cp.async group and then for the block
// (__syncthreads) before the window is read.
template <typename T, class Geo, int MODE, class P>
__device__ __forceinline__ void fused_halo_load(const Tile<T, MODE>& tl, const P& pl,
                                                const Geo geo, int wy, int H, int y0, int x0,
                                                int64_t b_in) {
  if constexpr (!StateAsync<Geo>::value) {
    T* const sm = tl.sm;
    const int wx = tl.wx, wa = wy * wx;
    const bool first = tl.a.first != 0;
    const T* const s0 = first ? pl.field : pl.t_prev;
    const int lo = min(max(H - y0, 0), wy);
    const int hi = geo.fold ? wy : max(min(geo.ly + H - y0, wy), lo);
    const int n_lo = lo * wx, cells = n_lo + (wy - hi) * wx;
    const Quot per_row(wx);
    constexpr int U = 4;
    for (int i0 = threadIdx.x; i0 < cells; i0 += U * blockDim.x) {
      T v[U][2];
      int ks[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * blockDim.x;
        ks[u] = i < n_lo ? i : i + (hi - lo) * wx;  // the window cell
        if (i < cells) {
          const int r = per_row(ks[u]), q = ks[u] - r * wx;
          const int gy = y0 - H + r;
          const int64_t kk =
              b_in + geo.in_index(geo.row(gy), geo.col(x0 - H + q, geo.mirror(gy)));
          v[u][0] = __ldcg(s0 + kk);
          v[u][1] = first ? T(0) : __ldcg(pl.t + kk);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u * (int)blockDim.x < cells) {
          sm[ks[u]] = v[u][0];
          if (!first) sm[wa + ks[u]] = v[u][1];
        }
      }
    }
  }
}

// The lift of a thread's run (see reg_steps), with the pass's uniform flags
// as template arguments so the slots' loads carry no branch: FIRST_PASS
// computes T_0 from the raw field (plane 0), area (plane `prev`) and post as
// the shared-memory steps compute it in place, where AREA or DROP; else the
// carries and acc are read. Every load is unpredicated: a slot past the
// window (or of a thread with no run, k0 < 0) reads a cell of the window's
// last row (of cell 0), whose values no stepped cell reads.
template <bool FIRST_PASS, bool AREA, bool DROP, typename T, int MODE, int R>
__device__ __forceinline__ void reg_lift(const Tile<T, MODE>& tl, RegRun<T, MODE, R>& v, int wy,
                                         int cur, int prev) {
  const FusedArgs<T>& a = tl.a;
  const T* const sm = tl.sm;
  const int wx = tl.wx;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int k = v.q < 0 ? 0 : min(v.r0 + s, wy - 1) * wx + v.q;
#pragma unroll
    for (int m = 0; m < 5; ++m) v.cf[s][m] = tl.coef_array(m) ? sm[tl.o_coef[m] + k] : T(0);
    v.po[s] = tl.has_post() ? sm[tl.o_post + k] : T(0);
    v.pr[s] = tl.has_pre() ? sm[tl.o_pre + k] : T(0);
    if (FIRST_PASS) {
      v.x[s] = AREA || DROP ? t0_value<true>(sm[k], AREA, sm[prev + k], DROP, v.po[s]) : sm[k];
      v.y[s] = T(0);
      v.ac[s] = T(0);
    } else {
      const int own = (v.own >> s) & 1u;
      v.x[s] = sm[cur + k];
      v.y[s] = sm[prev + k];
      v.ac[s] = sm[tl.o_acc + (own ? (v.r0 + s - a.n_ops) * a.bx + v.q - a.n_ops : 0)];
    }
  }
}

// Phases 2 and 3 of fused_tile in the register steps (see reg_step), after
// the window's load: lift each thread's run, publish T_k into exchange plane
// 0 over the dead window, step, and write the own cells of the carries and
// acc from the registers (LAST wrote the result). `cur` and `prev` are the
// window planes of T_k (T_0: the raw field) and T_{k-1} (a first pass: area).
template <typename T, int MODE, class Geo, class P>
__device__ __forceinline__ void reg_steps(const Tile<T, MODE>& tl, const P& pl, const Geo geo,
                                          int wy, int H, int y0, int x0, int cur, int prev,
                                          int64_t b_own, int64_t b_out) {
  constexpr int R = RegRows<T, MODE>::value;
  const FusedArgs<T>& a = tl.a;
  T* const sm = tl.sm;
  const int wx = tl.wx, P_ = reg_pitch(wy, R);
  const bool first = a.first != 0, has_area = pl.area != nullptr, drop_pre = a.drop_pre != 0;
  // this thread's run: column q, rows [r0, r0 + R); q < 0: none
  RegRun<T, MODE, R> v;
  const int t = threadIdx.x;
  const bool runs = t < (wy + R - 1) / R * wx;
  v.q = runs ? t % wx : -1;
  v.r0 = runs ? t / wx * R : 0;
  v.e0 = (v.q + 1) * P_ + v.r0;
  v.own = 0;
  const unsigned ox = v.q - H;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const unsigned oy = v.r0 + s - H;
    v.own |= (unsigned)(runs && v.r0 + s < wy && oy < (unsigned)a.by && ox < (unsigned)a.bx) << s;
  }
  if (!first)
    reg_lift<false, false, false>(tl, v, wy, cur, prev);
  else if (has_area && drop_pre)
    reg_lift<true, true, true>(tl, v, wy, cur, prev);
  else if (has_area)
    reg_lift<true, true, false>(tl, v, wy, cur, prev);
  else if (drop_pre)
    reg_lift<true, false, true>(tl, v, wy, cur, prev);
  else
    reg_lift<true, false, false>(tl, v, wy, cur, prev);
  // the exchange planes over the dead window: plane 0 from word 0, plane 1
  // from word (wx + 2) P; T_k, gathered, goes into plane 0, and post into a
  // third plane in their layout, read every step where holding it would
  // spill registers
  const int plane = (wx + 2) * P_;
  __syncthreads();
  if (runs) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      sm[v.e0 + s] = reg_gat(tl, v.x[s], v.pr[s]);
      if (tl.has_post()) sm[2 * plane + v.e0 + s] = v.po[s];
    }
  }
  __syncthreads();

  // the steps: T_{k+1} goes over T_{k-1}, so step i reads T_k from x where
  // i is even and from y where it is odd; the planes trade places likewise
  for (int i = 0; i < H; ++i) {
    const bool odd = i & 1, publish = i + 1 < H;
    const int in = odd ? plane : 0, out = odd ? 0 : plane;
    const T p_a = a.pa[i];
    if (runs) {
      if (!odd) {
        if (first && i == 0)
          reg_step<FIRST>(tl, pl, geo, v, v.x, v.y, P_, H, y0, x0, in, out, p_a, publish, b_own);
        else if (a.last && i == H - 1)
          reg_step<LAST>(tl, pl, geo, v, v.x, v.y, P_, H, y0, x0, in, out, p_a, publish, b_own);
        else
          reg_step<MIDDLE>(tl, pl, geo, v, v.x, v.y, P_, H, y0, x0, in, out, p_a, publish, b_own);
      } else {
        if (a.last && i == H - 1)
          reg_step<LAST>(tl, pl, geo, v, v.y, v.x, P_, H, y0, x0, in, out, p_a, publish, b_own);
        else
          reg_step<MIDDLE>(tl, pl, geo, v, v.y, v.x, P_, H, y0, x0, in, out, p_a, publish, b_own);
      }
    }
    if (publish) __syncthreads();
  }
  if (a.last) return;

  // 3. the own cells of the carries and of acc, from the registers: T_k is in
  // y after an odd number of steps, in x after an even one
  const int gx = x0 - H + v.q;
  if (gx >= geo.cols()) return;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int gy = y0 - H + v.r0 + s;
    if (!((v.own >> s) & 1u) || gy >= geo.rows()) continue;
    pl.t_out[b_out + geo.out_index(gy, gx)] = H & 1 ? v.y[s] : v.x[s];
    pl.t_prev_out[b_out + geo.out_index(gy, gx)] = H & 1 ? v.x[s] : v.y[s];
    pl.acc_out[b_own + geo.own_index(gy, gx)] = v.ac[s];
  }
}

// One tile's pass, all of the block's threads, the dynamic shared memory its
// window: the own cells of the tile at `org`. `a` holds the pass (steps, p_a,
// tile, constants), `pl` the planes (field, field_own, t, t_prev, acc_in,
// t_out, t_prev_out, acc_out, coef, pre, post, area): the FusedArgs itself
// for fused_pass_kernel, a shard's row of a table for the ring. The geometry
// goes by value, here and into the load and the steps, as in vec_tile.cuh.
template <typename T, class Geo, int MODE, bool REG, class P, class Org>
__device__ __forceinline__ void fused_tile(const FusedArgs<T>& a, const P& pl, const Geo geo,
                                           const Org& org) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.n_ops;
  const int wy = a.by + 2 * H, wx = a.bx + 2 * H, wa = wy * wx;
  // plane offsets in the window (offsets, not pointers, keep every access in
  // the shared address space); a plane that is absent has offset -1
  Tile<T, MODE> tl{a, reinterpret_cast<T*>(smem_raw), wx, {}, -1, -1, 0};
  int off = 2 * wa;
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    tl.o_coef[m] = pl.coef[m] ? off : -1;
    if (pl.coef[m]) off += wa;
  }
  tl.o_post = pl.post ? off : -1;
  if (pl.post) off += wa;
  tl.o_pre = pl.pre ? off : -1;
  if (pl.pre) off += wa;
  tl.o_acc = off;
  T* const sm = tl.sm;

  const bool has_area = pl.area != nullptr, drop_pre = a.drop_pre != 0;
  const int y0 = org.y0(a.by), x0 = org.x0(a.bx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int64_t b_in = (int64_t)org.z() * geo.in_plane();
  const int64_t b_own = (int64_t)org.z() * geo.own_plane();
  const int64_t b_out = (int64_t)org.z() * geo.out_plane();
  const int ny = geo.rows(), nx = geo.cols();

  // 1. the window, in one burst (a ring tile's halo rows after their flags)
  fused_window_load(tl, pl, geo, wy, H, y0, x0, b_in, b_own);
  cp_async_commit();
  org.wait();
  fused_halo_load(tl, pl, geo, wy, H, y0, x0, b_in);
  cp_async_wait_all();
  __syncthreads();

  // 2. the steps: in registers in a REG kernel (launched where reg_path
  // holds; reg_steps computes T_0 of a first pass as it lifts the runs, and
  // writes phase 3 too), but for a window that reaches the fold (the top
  // tiles of a fold grid: no run holds a mirror cell); else in shared
  // memory: a first pass computes T_0 in place (plane 0), and FIRST writes
  // T_1 into plane 1.
  int cur = a.first ? 0 : wa;
  int prev = a.first ? wa : 0;
  if constexpr (REG) {
    if (!geo.mirror(y0 - H + wy - 1)) {
      reg_steps(tl, pl, geo, wy, H, y0, x0, cur, prev, b_own, b_out);
      return;
    }
  }
  if (a.first && (has_area || drop_pre)) {
    for (int k = threadIdx.x; k < wa; k += blockDim.x)
      sm[k] = t0_value<true>(sm[k], has_area, sm[wa + k], drop_pre,
                             tl.has_post() ? sm[tl.o_post + k] : T(0));
    __syncthreads();
  }
  for (int i = 0; i < H; ++i) {
    const int j = i + 1;  // this step's window: shrunk by j
    if (a.first && i == 0)
      step_window<T, MODE, FIRST>(tl, pl, geo, j, wy, H, y0, x0, cur, prev, a.pa[i], b_own);
    else if (a.last && i == H - 1)
      step_window<T, MODE, LAST>(tl, pl, geo, j, wy, H, y0, x0, cur, prev, a.pa[i], b_own);
    else
      step_window<T, MODE, MIDDLE>(tl, pl, geo, j, wy, H, y0, x0, cur, prev, a.pa[i], b_own);
    __syncthreads();
    const int tmp = cur;
    cur = prev;
    prev = tmp;
  }
  if (a.last) return;

  // 3. the own cells of the carries and of acc
  for (int r = H + warp; r < H + a.by; r += nwarps) {
    const int gy = y0 - H + r;
    if (gy >= ny) break;
    for (int q = H + lane; q < H + a.bx; q += 32) {
      const int gx = x0 - H + q;
      if (gx >= nx) break;
      const int k = r * wx + q;
      pl.t_out[b_out + geo.out_index(gy, gx)] = sm[cur + k];
      pl.t_prev_out[b_out + geo.out_index(gy, gx)] = sm[prev + k];
      pl.acc_out[b_own + geo.own_index(gy, gx)] = sm[tl.o_acc + (r - H) * a.bx + (q - H)];
    }
  }
}

template <typename T, class Geo, int MODE, bool REG>
__global__ void __launch_bounds__(FUSED_THREADS) fused_pass_kernel(const FusedArgs<T> a,
                                                                    const Geo geo) {
  fused_tile<T, Geo, MODE, REG>(a, a, geo, GridOrigin{});
}

// A strip round: fused_tile on BlockStripGeo, the planes and the state's
// sources in one StripArgs. It keeps the steps in shared memory: its
// register steps spilled (BlockStripGeo's five state sources), as the
// ring's did (ring_pass.cu).
template <typename T, int MODE>
__global__ void __launch_bounds__(FUSED_THREADS) local_strip_kernel(const StripArgs<T> a,
                                                                     const BlockStripGeo geo) {
  fused_tile<T, BlockStripGeo, MODE, false>(a, a, geo, GridOrigin{});
}

template <typename T, class Geo, int MODE, bool REG>
int launch_kernel(const FusedArgs<T>& a, const Geo& g, dim3 grid, size_t bytes, cudaStream_t st) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fused_pass_kernel<T, Geo, MODE, REG>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  fused_pass_kernel<T, Geo, MODE, REG><<<grid, FUSED_THREADS, bytes, st>>>(a, g);
  return (int)cudaGetLastError();
}

// The kernel of the pass's steps: in registers where reg_path holds.
template <typename T, class Geo, int MODE>
int launch_mode(const FusedArgs<T>& a, const Geo& g, dim3 grid, size_t bytes, cudaStream_t st) {
  if constexpr (RegRows<T, MODE>::value > 0)
    if (reg_path<T, MODE>(a)) return launch_kernel<T, Geo, MODE, true>(a, g, grid, bytes, st);
  return launch_kernel<T, Geo, MODE, false>(a, g, grid, bytes, st);
}

template <typename T, class Geo, int MODE>
int launch_mode(const StripArgs<T>& a, const BlockStripGeo& g, dim3 grid, size_t bytes,
                cudaStream_t st) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        local_strip_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  local_strip_kernel<T, MODE><<<grid, FUSED_THREADS, bytes, st>>>(a, g);
  return (int)cudaGetLastError();
}

// The compiled mode that fits the stencil's shape.
template <typename T>
int fused_mode(const FusedArgs<T>& a) {
  const bool c_only = a.coef[0] && !a.coef[1] && !a.coef[2] && !a.coef[3] && !a.coef[4];
  const bool all = a.coef[0] && a.coef[1] && a.coef[2] && a.coef[3] && a.coef[4];
  if (!a.zap && !a.pre && a.post && c_only) return HSPACE;
  if (a.zap && !a.pre && !a.post && all) return FLUX;
  return GENERIC;
}

// Launch one fused pass over the own domain of `geo`, tiles of by x bx, with
// the kernel compiled for the stencil's shape: `a` the FusedArgs, or the
// StripArgs of a strip round.
template <typename T, class Geo, class A>
int launch_fused(const A& a, const Geo& g, int ny, int nx, int batch, cudaStream_t st) {
  if (a.n_ops < 1 || a.n_ops > MAX_FUSE || a.by < 1 || a.bx < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = fused_shared_bytes(a);
  if (bytes > MAX_SHARED) return (int)cudaErrorInvalidValue;
  const dim3 grid((nx + a.bx - 1) / a.bx, (ny + a.by - 1) / a.by, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  switch (fused_mode(a)) {
    case HSPACE: return launch_mode<T, Geo, HSPACE>(a, g, grid, bytes, st);
    case FLUX: return launch_mode<T, Geo, FLUX>(a, g, grid, bytes, st);
    default: return launch_mode<T, Geo, GENERIC>(a, g, grid, bytes, st);
  }
}

// Fill the fields every fused entry passes the same way.
template <typename T>
FusedArgs<T> fused_args(int by, int bx, int n_ops, int first, int last, const double* pa,
                        double p_b, const T* field, const T* field_own, const T* t,
                        const T* t_prev,
                        const T* acc_in, T* t_out, T* t_prev_out, T* acc_out, const T* c,
                        const T* n, const T* s, const T* e, const T* w, double cv,
                        double nv, double sv, double ev, double wv, const T* pre,
                        const T* post, const T* area, double land_gain, int zap,
                        int drop_pre, int regs) {
  FusedArgs<T> a;
  a.by = by; a.bx = bx; a.n_ops = n_ops; a.first = first; a.last = last;
  for (int i = 0; i < MAX_FUSE; ++i) a.pa[i] = i < n_ops ? T(pa[i]) : T(0);
  a.p_b = T(p_b);
  a.field = field; a.field_own = field_own; a.t = t; a.t_prev = t_prev; a.acc_in = acc_in;
  a.t_out = t_out; a.t_prev_out = t_prev_out; a.acc_out = acc_out;
  a.coef[0] = c; a.coef[1] = n; a.coef[2] = s; a.coef[3] = e; a.coef[4] = w;
  a.cval[0] = T(cv); a.cval[1] = T(nv); a.cval[2] = T(sv); a.cval[3] = T(ev); a.cval[4] = T(wv);
  a.pre = pre; a.post = post; a.area = area;
  a.land_gain = T(land_gain);
  a.zap = zap; a.drop_pre = drop_pre;
  a.regs = regs;
  return a;
}

}  // namespace
