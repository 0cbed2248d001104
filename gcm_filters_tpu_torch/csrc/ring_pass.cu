// Chebyshev steps on the y-shards of a ring, with the halo exchange done by
// the kernel itself, for Hopper (sm_90a). Four entries:
//   ring_pass_f32/f64            scalar step   (the arithmetic of cheb_pass.cu)
//   vec_ring_pass_f32/f64        coupled step, op = BGRID or CTAP (vec_pass.cu)
//   ring_fused_pass_f32/f64      fused scalar pass: S <= 16 steps per launch on
//                                the shared-memory tiles of cheb_tile.cuh
//   vec_ring_fused_pass_f32/f64  fused coupled pass, op = BGRID or CTAP: S <= 16
//                                (u, v) steps per launch on the tiles of
//                                vec_tile.cuh
//
// Replaces the ring mode of the TPU pass kernels:
// gcm_filters_tpu/ops/pallas/cheb_pass.py::build_ring_pass with its
// _WindowStreamer (remote copies `rem_desc`, the entry barrier, the block
// order `_pblk`), and the ring mode of
// gcm_filters_tpu/ops/pallas/vec_pass.py::_build_coupled_pass
// (build_vec_pass, build_ctap_pass with ring_axis). This file ports WHAT those
// kernels do, not their TPU layout: on the TPU a shard's kernel starts remote
// DMA of its edge rows into the neighbours' halo buffers, computes its
// interior blocks while the rows travel and its two edge blocks last, waiting
// on the receive semaphores only there. Here the remote copy is a plain store
// through a pointer into the neighbour's halo buffer, and the semaphore is a
// flag word written with release and read with acquire order.
//
// The field is cut into p shards of ly = ny/p rows along y; x is not cut, so
// the x wrap and the tripolar seam are local (the seam belongs to the top
// shard). Every shard is a set of separately allocated buffers, listed in one
// row of a pointer table in device memory. One launch runs ONE step of ALL
// shards (the steps are FIRST / MIDDLE / LAST of cheb_pass.cu and vec_pass.cu,
// with t_next written over t_prev and acc updated in place), so with one step
// per launch a cell reads its neighbours' `t` only, and the halo is one row per
// side: the C-grid's diagonal taps u[j+1, i-1] and v[j-1, i+1] stay inside
// that row because x is local. A halo row holds the already GATHERED values
// (area, masks and nan_to_num applied at the sender's own index), so a
// receiver needs no coefficient row of its neighbour.
//
// Work order. A launch has exactly one block per work item, and a block
// learns its item from an atomic ticket when it starts to run, in this order:
//   1. sends: for every shard, its bottom row into the down-neighbour's north
//      halo and its top row into the up-neighbour's south halo; then a release
//      store of this launch's epoch into the halo's flag word. A send waits for
//      nothing.
//   2. interior tiles of every shard (32 x 8 cells, one per thread, as in the
//      unsharded kernels): they read the shard's own rows only.
//   3. edge tiles (those holding row 0 or row ly-1): they wait, with acquire
//      order, until the flag of the halo they read holds this launch's epoch.
// A block that waits holds a ticket above every send's, so every send has
// been drawn by a block that already runs and never waits: each wait ends
// whatever order the hardware schedules blocks in. The ticket counter needs
// no reset either: every launch draws exactly `total` tickets, so a launch's
// item is ticket % total.
//
// Flags need no reset: the epoch grows by one with every launch and a flag is
// compared for equality with it. Buffer reuse (the TPU kernel's entry
// barrier): all shards share one launch and launches follow each other in
// stream order, so step k+1's sends cannot land while step k's edge tiles
// still read a halo. Two applies of one state on two streams at once are not
// supported, nor is replaying a launch from a CUDA graph (the epoch is an
// argument of the launch). The wait is bounded: it backs off with
// __nanosleep and traps after SPIN_LIMIT polls, so a protocol fault is a CUDA
// error, not a hang.
//
// Memory order: the halo stores of a send block are followed by
// __syncthreads, then one thread fences and stores the flag with release
// order; a reader's thread 0 loads the flag with acquire order, then
// __syncthreads, then the halo loads, which bypass L1 (__ldcg): no
// non-coherent load touches a buffer written in the same launch. The scope is
// .gpu: all shards live on this card. Shards on peer cards would need .sys.
//
// Bound: memory, as the unsharded steps: the same planes plus 2p halo rows
// written and read. The whole-filter bound is the unsharded one.
//
// The fused pass (ring_fused_pass_*) is what build_ring_pass computes per
// call: one exchange per PASS of S steps, not per step. Every shard's planes
// are extended by `pad` >= S rows below and above (RingGeo of
// cheb_tile.cuh): the coefficient planes once, by the host; the carries by
// the pass's sends, which store the S rows nearest each edge of every live
// field (the raw field on a first pass, else t and t_prev: the windows step
// their halo cells, so they need raw values, not gathered ones) into the
// neighbours' halo rows. A tile is the unsharded fused kernel's (fused_tile,
// the same code), its window cut from the extended planes, so a cell gets
// the bits of the fused K1 and of the step chain. Work order, one block of
// FUSED_THREADS per item and one ticket per block:
//   1. the two sends of every shard, each ending in a release store of the
//      launch's epoch into the receiver's flag;
//   2. interior tiles of every shard: window rows [y0-S, y0+by+S) inside
//      [0, ly), no wait;
//   3. edge tiles: they wait, with acquire order, for the flag of every halo
//      their window reaches (the top shard of a fold grid reads mirror cells
//      of its own rows instead of a north halo), then load their window.
// The deadlock argument is the one above, whatever the occupancy: a block
// may take most of an SM's shared memory, so as few as one block an SM may
// run, but a block that waits holds a ticket above every send's, and every
// send was drawn by a block that runs and never waits. The ticket is not
// reset: the launch gets the count drawn before it (`base`) and a block's
// item is its ticket less that. The ticket sits in the first word of the
// dynamic shared memory (a static one would take from the window's room).
// The shards' plane pointers are a table in the kernel's parameters
// (__grid_constant__, at most MAX_RING_SHARDS rows): a block reads them where
// they are, as the unsharded kernel reads its arguments, so the tile keeps
// K1's registers and blocks per SM (a copy of the shard's arguments in the
// block took registers past 64 and halved the occupancy; PERF.md §6).
// Buffer reuse across passes: a pass reads one extended pair of carries and
// writes the own rows of the other, so its sends (into the pair it reads)
// and its tiles (out of it) touch no buffer another block of the launch
// writes, except the halo rows that the flags cover; pass m+1's sends write
// the halo rows of the pair that pass m wrote, which stream order puts after
// every block of pass m. acc is own-shaped and updated in place by its tile.
//
// Bound (fused pass): issue in the steps, as the fused K1, plus the
// 2p sends of S rows of one or two fields.
//
// The fused vector pass (vec_ring_fused_pass_*) is the same protocol for the
// stacked (u, v) pair, what the ring mode of _build_coupled_pass computes per
// call (build_vec_pass, build_ctap_pass with ring_axis): every shard's planes
// are (2, ly+2*pad, nx) pairs and (n_coef, ly+2*pad, nx) coefficients,
// extended as above; a send stores the S rows nearest one edge of both
// components of every live field (w on a first pass, else t and t_prev: 2
// or 4 planes) and ends in the same release store; a tile is the fused K3 /
// K4 tile (vec_fused_tile of vec_tile.cuh, the same code, contraction and zap
// compiled in) on RingGeo without a fold, so a cell gets the bits of the
// fused K3 / K4 and of the vector step ring. Vector grids do not fold: an
// edge tile waits for the flag of each halo its window reaches, the top
// shard's north one too. The work order, the tickets, the flags, the table
// in the kernel's parameters and the reuse of the two carry pairs are the
// scalar pass's. The deadlock argument holds as it stands: a 32 x 64 B-grid
// tile with a halo of 6 takes about 203 KB of shared memory in float32, so
// one block runs on an SM, and a block that waits holds a ticket above every
// send's, each drawn by a block that runs and never waits. acc is own-shaped
// (2, ly, nx) and every own cell has one.
//
// Build without --use_fast_math: it breaks isnan/isinf in nan_to_num and the
// 0*fbar NaN poison.

#include <algorithm>
#include <cstdio>
#include <cstring>
#include <type_traits>

#include "cheb_tile.cuh"
#include "vec_step.cuh"
#include "vec_tile.cuh"

namespace {

constexpr int TILE_X = 32;  // cells of a tile along x: one warp
constexpr int TILE_Y = 8;   // rows of a tile: one per warp
constexpr int THREADS = TILE_X * TILE_Y;
// Blocks per SM that the scalar kernel is compiled for (a cap of 32 registers,
// met without spills): a shard's pointers come from the table, not from the
// launch's parameters, and left alone they take the kernel to 66-80 registers
// and half the occupancy of the unsharded kernel, which on an H100 cost a
// memory-bound MIDDLE step about a quarter of its speed. The vector kernels
// were faster left alone.
constexpr int SCALAR_MIN_BLOCKS = 8;
constexpr long long SPIN_LIMIT = 1LL << 23;  // polls of >= 1 us each: seconds

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Thread 0 polls `flag` until it holds `epoch`; then the whole block goes on.
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned epoch, int tid) {
  if (tid == 0) {
    unsigned ns = 32;
    for (long long polls = 0; ld_acquire(flag) != epoch; ++polls) {
      if (polls > SPIN_LIMIT) {
        printf("ring_pass: halo flag %p never reached epoch %u (holds %u)\n",
               (const void*)flag, epoch, ld_acquire(flag));
        __trap();
      }
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
  }
  __syncthreads();
}

// After the block's halo stores: publish them under `flag`.
__device__ __forceinline__ void publish(unsigned* flag, unsigned epoch, int tid) {
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    st_release(flag, epoch);
  }
}

// What all shards of one launch share.
struct Ring {
  int p, ly, nx;            // shards, rows of a shard, cells of a row
  int tiles_x, tiles_y;     // tiles of a shard
  int swap;                 // 0: t = b, t_prev = a; 1: t = a, t_prev = b
  unsigned epoch;           // this launch's flag value
  unsigned long long* ticket;
};

enum ItemKind { SEND = 0, TILE = 1 };

struct Item {
  int what, shard;
  int side;    // SEND: 0 = bottom row to the down-neighbour, 1 = top row to the up-neighbour
  int tx, ty;  // TILE
};

__host__ __device__ inline long long interior_tiles(int tiles_x, int tiles_y) {
  return (long long)tiles_x * (tiles_y > 2 ? tiles_y - 2 : 0);
}

__host__ __device__ inline long long edge_tiles(int tiles_x, int tiles_y) {
  return (long long)tiles_x * (tiles_y < 2 ? tiles_y : 2);
}

__host__ __device__ inline long long total_items(int p, int tiles_x, int tiles_y) {
  return p * (2 + interior_tiles(tiles_x, tiles_y) + edge_tiles(tiles_x, tiles_y));
}

// The block's item: sends of every shard, then interior tiles, then edge tiles.
__device__ __forceinline__ Item draw_item(const Ring& q, int tid) {
  __shared__ unsigned long long drawn;
  if (tid == 0)
    drawn = atomicAdd(q.ticket, 1ULL) %
            (unsigned long long)total_items(q.p, q.tiles_x, q.tiles_y);
  __syncthreads();
  long long idx = (long long)drawn;
  Item it;
  if (idx < 2LL * q.p) {
    it.what = SEND; it.shard = (int)(idx / 2); it.side = (int)(idx % 2); it.tx = it.ty = 0;
    return it;
  }
  idx -= 2LL * q.p;
  it.what = TILE; it.side = 0;
  const long long n_int = interior_tiles(q.tiles_x, q.tiles_y);
  if (idx < q.p * n_int) {
    it.shard = (int)(idx / n_int);
    const long long rem = idx % n_int;
    it.ty = 1 + (int)(rem / q.tiles_x);
    it.tx = (int)(rem % q.tiles_x);
    return it;
  }
  idx -= q.p * n_int;
  const long long n_edge = edge_tiles(q.tiles_x, q.tiles_y);
  it.shard = (int)(idx / n_edge);
  const long long rem = idx % n_edge;
  it.ty = rem / q.tiles_x == 0 ? 0 : q.tiles_y - 1;
  it.tx = (int)(rem % q.tiles_x);
  return it;
}

// ---- scalar -----------------------------------------------------------------

// One row of the scalar pointer table: a shard's own buffers.
template <typename T>
struct Shard {
  const T* field;      // raw input rows
  T* a;                // carry: T_0 (FIRST's h), then every other T_k
  T* b;                // carry: T_1, then every other T_k
  T* acc;              // running sum; the result after LAST
  T* halo_s;           // gathered row below row 0, written by the down-neighbour
  T* halo_n;           // gathered row above row ly-1, written by the up-neighbour
  unsigned* flag_s;    // epoch of halo_s
  unsigned* flag_n;    // epoch of halo_n
  const T* coef[5];    // c, n, s, e, w rows (pre-scaled); null -> the launch's constant
  const T* pre;
  const T* post;
  const T* area;
};

// What the scalar step reads besides the table.
template <typename T>
struct ScalarStep {
  T cval[5];
  T p_a, p_b, land_gain;
  int zap, fold, drop_pre;
};

template <typename T, int KIND>
__device__ __forceinline__ Args<T> shard_args(const Ring& q, const ScalarStep<T>& s,
                                              const Shard<T>& sh) {
  Args<T> a;
  a.ny = q.ly; a.nx = q.nx;
  a.field = sh.field;
  a.t = q.swap ? sh.a : sh.b;
  a.t_prev = q.swap ? sh.b : sh.a;
  a.t_next = KIND == FIRST ? sh.b : (q.swap ? sh.b : sh.a);  // MIDDLE: over t_prev
  a.acc = sh.acc;
  a.h = sh.a;
  for (int m = 0; m < 5; ++m) { a.coef[m] = sh.coef[m]; a.cval[m] = s.cval[m]; }
  a.pre = sh.pre; a.post = sh.post; a.area = sh.area;
  a.p_a = s.p_a; a.p_b = s.p_b; a.land_gain = s.land_gain;
  a.zap = s.zap; a.fold = s.fold; a.drop_pre = s.drop_pre;
  return a;
}

template <typename T, int KIND>
__global__ void __launch_bounds__(THREADS, SCALAR_MIN_BLOCKS)
ring_pass_kernel(const Ring q, const ScalarStep<T> s, const Shard<T>* __restrict__ table) {
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  const Item it = draw_item(q, tid);
  const Shard<T> me = table[it.shard];  // all pointers at once: one latency, not a chain
  const Args<T> a = shard_args<T, KIND>(q, s, me);
  const int nx = q.nx, ly = q.ly;

  if (it.what == SEND) {
    const int to = it.side ? (it.shard + 1) % q.p : (it.shard + q.p - 1) % q.p;
    T* out = it.side ? table[to].halo_s : table[to].halo_n;
    const int64_t row = it.side ? (int64_t)(ly - 1) * nx : 0;
    for (int i = tid; i < nx; i += THREADS) out[i] = gathered<T, KIND>(a, 0, row + i);
    publish(it.side ? table[to].flag_s : table[to].flag_n, q.epoch, tid);
    return;
  }

  // the seam folds the top shard's top row onto itself: it reads no north halo
  const bool folds = s.fold && it.shard == q.p - 1;
  if (it.ty == 0) wait_flag(me.flag_s, q.epoch, tid);
  if (it.ty == q.tiles_y - 1 && !folds) wait_flag(me.flag_n, q.epoch, tid);

  const int i = it.tx * TILE_X + threadIdx.x;
  const int j = it.ty * TILE_Y + threadIdx.y;
  if (i >= nx || j >= ly) return;
  const int64_t r = (int64_t)j * nx;
  const int64_t k = r + i;
  T gn, gs;
  if (j + 1 < ly) gn = gathered<T, KIND>(a, 0, k + nx);
  else if (folds) gn = gathered<T, KIND>(a, 0, r + (nx - 1 - i));
  else gn = __ldcg(me.halo_n + i);
  if (j > 0) gs = gathered<T, KIND>(a, 0, k - nx);
  else gs = __ldcg(me.halo_s + i);
  step_cell<T, KIND>(a, 0, k, gathered<T, KIND>(a, 0, k), gn, gs,
                     gathered<T, KIND>(a, 0, i + 1 < nx ? k + 1 : r),
                     gathered<T, KIND>(a, 0, i > 0 ? k - 1 : r + nx - 1));
}

// ---- vector -----------------------------------------------------------------

// One row of the vector pointer table: a shard's own buffers, each carry a
// stacked (2, ly, nx) pair, each halo a stacked (2, nx) pair of rows.
template <typename T>
struct VecShard {
  T* a;              // carry: the stacked input T_0, then every other T_k
  T* b;              // carry: T_1, then every other T_k
  T* acc;            // running sum; the result after LAST
  T* halo_s;
  T* halo_n;
  unsigned* flag_s;
  unsigned* flag_n;
  const T* coef;     // (n_coef, ly, nx) rows, pre-scaled
};

template <typename T>
struct VecStep {
  T p_a, p_b;
  int zap;
};

// The contraction input of a ring shard: offsets inside the plane read the
// shard's own rows, offsets below 0 the south halo row and offsets past the
// plane the north halo row, both already gathered by their senders.
template <typename T>
struct RingGather {
  Gather<T> own;
  const T* halo_s;
  const T* halo_n;
  int nx;
  __device__ __forceinline__ T operator()(int comp, int64_t k) const {
    if (k < 0) return __ldcg(halo_s + comp * nx + (k + nx));
    if (k >= own.plane) return __ldcg(halo_n + comp * nx + (k - own.plane));
    return own(comp, k);
  }
};

template <typename T, typename OP, int KIND>
__global__ void __launch_bounds__(THREADS)
vec_ring_pass_kernel(const Ring q, const VecStep<T> s, const VecShard<T>* __restrict__ table) {
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  const Item it = draw_item(q, tid);
  const VecShard<T>& me = table[it.shard];
  const int nx = q.nx, ly = q.ly;
  const int64_t P = (int64_t)ly * nx;

  VecArgs<T> a;
  a.ny = ly; a.nx = nx;
  a.w = me.a;
  a.t = q.swap ? me.a : me.b;
  a.t_prev = q.swap ? me.b : me.a;
  a.t_next = KIND == FIRST ? me.b : (q.swap ? me.b : me.a);  // MIDDLE: over t_prev
  a.acc = me.acc;
  a.coef = me.coef;
  a.p_a = s.p_a; a.p_b = s.p_b; a.zap = s.zap;
  const Gather<T> own{KIND == FIRST ? a.w : a.t, P, s.zap};

  if (it.what == SEND) {
    const int to = it.side ? (it.shard + 1) % q.p : (it.shard + q.p - 1) % q.p;
    T* out = it.side ? table[to].halo_s : table[to].halo_n;
    const int64_t row = it.side ? (int64_t)(ly - 1) * nx : 0;
    for (int i = tid; i < 2 * nx; i += THREADS) {
      const int comp = i >= nx;
      out[i] = own(comp, row + (i - comp * nx));
    }
    publish(it.side ? table[to].flag_s : table[to].flag_n, q.epoch, tid);
    return;
  }

  if (it.ty == 0) wait_flag(me.flag_s, q.epoch, tid);
  if (it.ty == q.tiles_y - 1) wait_flag(me.flag_n, q.epoch, tid);

  const int i = it.tx * TILE_X + threadIdx.x;
  const int j = it.ty * TILE_Y + threadIdx.y;
  if (i >= nx || j >= ly) return;
  const int ie = i + 1 < nx ? i + 1 : 0;
  const int iw = i > 0 ? i - 1 : nx - 1;
  const int64_t r = (int64_t)j * nx;
  const int64_t rn = j + 1 < ly ? r + nx : P;  // the north halo row follows the plane
  const int64_t rs = j > 0 ? r - nx : -nx;     // the south halo row precedes it
  Nbr x;
  x.c = r + i;
  x.n = rn + i;
  x.s = rs + i;
  x.e = r + ie;
  x.w = r + iw;
  x.nw = rn + iw;
  x.se = rs + ie;
  T lu, lv;
  OP::apply(a.coef, P, x, RingGather<T>{own, me.halo_s, me.halo_n, nx}, lu, lv);
  vec_step_cell<T, KIND>(a, x.c, P + x.c, x.c, P + x.c, true, lu, lv);
}

// ---- fused scalar pass ------------------------------------------------------

constexpr int MAX_RING_SHARDS = 16;  // shards of a fused launch at most (the table's rows)

// A shard's planes for one pass, named as in FusedArgs, every "in" plane
// extended by `pad` rows below and above (RingGeo): t and t_prev are the
// carry pair the pass reads (its sends write their halo rows, as they write
// the field's on a first pass), t_out and t_prev_out the pair it writes.
template <typename T>
struct ShardPlanes {
  static constexpr int COMPONENTS = 1;  // planes a field stacks
  T* field;
  const T* field_own;  // the own rows of field
  T* t;
  T* t_prev;
  const T* acc_in;
  T* t_out;
  T* t_prev_out;
  T* acc_out;          // own rows; = acc_in
  const T* coef[5];    // c, n, s, e, w; null -> the launch's constant
  const T* pre;
  const T* post;
  const T* area;
};

// The launch's table, a kernel parameter read in place (__grid_constant__):
// a block reads its shard's pointers as fused_pass_kernel reads its
// FusedArgs, from the constant bank, with no copy into registers or local
// memory, so the tile keeps K1's registers and blocks per SM.
template <typename T>
struct RingTable {
  ShardPlanes<T> shard[MAX_RING_SHARDS];
};

// A shard's planes for one fused vector pass, named as in VecFusedArgs: the
// stacked input w and the carry pairs (2, ly+2*pad, nx), acc (2, ly, nx),
// the coefficients (n_coef, ly+2*pad, nx); t and t_prev are the pair the
// pass reads, t_out and t_prev_out the pair it writes.
template <typename T>
struct VecShardPlanes {
  static constexpr int COMPONENTS = 2;
  T* w;
  T* t;
  T* t_prev;
  const T* acc_in;
  T* t_out;
  T* t_prev_out;
  T* acc_out;          // = acc_in
  const T* coef;
};

template <typename T>
struct VecRingTable {
  VecShardPlanes<T> shard[MAX_RING_SHARDS];
};

// The raw input of a shard: what a first pass sends and loads.
template <typename T>
__device__ __forceinline__ T* raw_input(const ShardPlanes<T>& s) { return s.field; }
template <typename T>
__device__ __forceinline__ T* raw_input(const VecShardPlanes<T>& s) { return s.w; }

// What all shards of one fused launch share.
struct FusedRing {
  int p, ly, nx, pad;        // shards, own rows, cells of a row, halo rows of the planes
  int tiles_x, tiles_y;      // tiles of a shard
  int int_lo, n_int;         // the interior tile rows: [int_lo, int_lo + n_int)
  int fold;                  // the top shard folds onto itself
  unsigned epoch;
  unsigned long long base;   // tickets drawn before this launch
  unsigned long long* ticket;
  unsigned* flags;           // per shard: the epoch of its south, then of its north halo rows
};

__host__ __device__ inline long long fused_items(const FusedRing& q) {
  return (long long)q.p * (2 + (long long)q.tiles_x * q.tiles_y);
}

// The block's item: sends of every shard, then interior tiles, then edge tiles.
__device__ __forceinline__ Item draw_fused_item(const FusedRing& q, int tid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* drawn = reinterpret_cast<unsigned long long*>(smem_raw);
  if (tid == 0) *drawn = atomicAdd(q.ticket, 1ULL) - q.base;
  __syncthreads();
  // broadcast from lane 0: the compiler then knows the shard index is warp-uniform
  // and reads the shard's row of the table with uniform loads (1-4% faster)
  long long idx = __shfl_sync(0xffffffffu, (long long)*drawn, 0);
  __syncthreads();  // the window will overwrite the slot
  Item it;
  if (idx < 2LL * q.p) {
    it.what = SEND; it.shard = (int)(idx / 2); it.side = (int)(idx % 2); it.tx = it.ty = 0;
    return it;
  }
  idx -= 2LL * q.p;
  it.what = TILE; it.side = 0;
  const long long n_int = (long long)q.n_int * q.tiles_x;
  long long rem;
  if (idx < q.p * n_int) {
    it.shard = (int)(idx / n_int);
    rem = idx % n_int;
    it.ty = q.int_lo + (int)(rem / q.tiles_x);
  } else {
    idx -= q.p * n_int;
    const long long n_edge = (long long)(q.tiles_y - q.n_int) * q.tiles_x;
    it.shard = (int)(idx / n_edge);
    rem = idx % n_edge;
    const int e = (int)(rem / q.tiles_x);  // the e-th edge row: below, then above the interior
    it.ty = e < q.int_lo ? e : e + q.n_int;
  }
  it.tx = (int)(rem % q.tiles_x);
  return it;
}

// A send: the n rows of every live field nearest one edge of shard `from`
// into the halo rows of its neighbour (side 0: the bottom rows into the
// down-neighbour's north halo; 1: the top rows into the up-neighbour's
// south halo), every component of a stacked field, then the receiver's flag.
template <typename T, class TAB>
__device__ __forceinline__ void fused_send(const FusedRing& q, const TAB& tab, int from, int side,
                                           int n, bool first, int tid) {
  const int to = side ? (from + 1) % q.p : (from + q.p - 1) % q.p;
  const auto& src = tab.shard[from];
  const auto& dst = tab.shard[to];
  constexpr int C = std::remove_reference_t<decltype(src)>::COMPONENTS;
  const int64_t nx = q.nx;
  const int64_t plane = (int64_t)(q.ly + 2 * q.pad) * nx;  // one component, extended
  const int64_t r_src = side ? q.pad + q.ly - n : q.pad;   // first row sent, extended
  const int64_t r_dst = side ? q.pad - n : q.pad + q.ly;   // first halo row written
  for (int f = 0; f < (first ? 1 : 2); ++f) {
    const T* a = first ? raw_input(src) : f ? src.t_prev : src.t;
    T* b = first ? raw_input(dst) : f ? dst.t_prev : dst.t;
#pragma unroll
    for (int c = 0; c < C; ++c)
      for (int64_t i = tid; i < n * nx; i += FUSED_THREADS)
        b[c * plane + r_dst * nx + i] = a[c * plane + r_src * nx + i];
  }
  publish(q.flags + 2 * to + (side ? 0 : 1), q.epoch, tid);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(FUSED_THREADS)
ring_fused_kernel(const FusedArgs<T> a, const FusedRing q, const __grid_constant__ RingTable<T> tab) {
  const int tid = threadIdx.x;
  const Item it = draw_fused_item(q, tid);
  if (it.what == SEND) {
    fused_send<T>(q, tab, it.shard, it.side, a.n_ops, a.first != 0, tid);
    return;
  }
  const int H = a.n_ops, y0 = it.ty * a.by;
  // the seam folds the top shard onto its own rows: it reads no north halo
  const bool folds = q.fold && it.shard == q.p - 1;
  if (y0 - H < 0) wait_flag(q.flags + 2 * it.shard, q.epoch, tid);
  if (y0 + a.by + H > q.ly && !folds) wait_flag(q.flags + 2 * it.shard + 1, q.epoch, tid);
  fused_tile<T, RingGeo, MODE>(a, tab.shard[it.shard], RingGeo{q.ly, q.nx, q.pad, folds},
                               TileOrigin{it.ty, it.tx});
}

template <typename T, int MODE>
int launch_ring_mode(const FusedArgs<T>& a, const FusedRing& q, const RingTable<T>& tab,
                     size_t bytes, cudaStream_t st) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_fused_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  ring_fused_kernel<T, MODE><<<(unsigned)fused_items(q), FUSED_THREADS, bytes, st>>>(a, q, tab);
  return (int)cudaGetLastError();
}

// The launch geometry of a fused pass of n_ops steps on tiles of by x bx,
// after checking what both fused entries check; false if they refuse it.
bool fused_ring(int p, int ly, int nx, int pad, int fold, int by, int bx, int n_ops,
                const void* const* planes, void* ticket, void* flags, unsigned long long base,
                unsigned epoch, FusedRing* q) {
  if (!planes || !ticket || !flags || p < 2 || p > MAX_RING_SHARDS || ly < 1 || nx < 1)
    return false;
  if (n_ops < 1 || n_ops > MAX_FUSE || n_ops > pad || n_ops > ly || by < 1 || bx < 1)
    return false;
  q->p = p; q->ly = ly; q->nx = nx; q->pad = pad; q->fold = fold ? 1 : 0;
  q->tiles_x = (nx + bx - 1) / bx;
  q->tiles_y = (ly + by - 1) / by;
  // interior rows ty: ty*by >= H and (ty+1)*by + H <= ly
  q->int_lo = std::min((n_ops + by - 1) / by, q->tiles_y);
  q->n_int = std::max(0, std::min((ly - n_ops) / by, q->tiles_y) - q->int_lo);
  q->epoch = epoch;
  q->base = base;
  q->ticket = static_cast<unsigned long long*>(ticket);
  q->flags = static_cast<unsigned*>(flags);
  return fused_items(*q) <= 0x7fffffffLL;
}

// One fused pass of every shard: `a` holds the pass (steps, tile, p_a) and
// shard 0's planes, which give the compiled mode; `planes` holds 16
// pointers per shard, in the order of ShardPlanes.
template <typename T>
int launch_ring_fused(const FusedArgs<T>& a, int p, int ly, int nx, int pad, int fold,
                      const void* const* planes, void* ticket, void* flags,
                      unsigned long long base, unsigned epoch, cudaStream_t st) {
  FusedRing q;
  if (!fused_ring(p, ly, nx, pad, fold, a.by, a.bx, a.n_ops, planes, ticket, flags, base, epoch,
                  &q))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = fused_shared_bytes(a);
  if (bytes > MAX_SHARED) return (int)cudaErrorInvalidValue;
  static_assert(sizeof(ShardPlanes<T>) == 16 * sizeof(void*), "16 pointers a shard");
  RingTable<T> tab;
  std::memcpy(tab.shard, planes, (size_t)p * sizeof(ShardPlanes<T>));
  switch (fused_mode(a)) {
    case HSPACE: return launch_ring_mode<T, HSPACE>(a, q, tab, bytes, st);
    case FLUX: return launch_ring_mode<T, FLUX>(a, q, tab, bytes, st);
    default: return launch_ring_mode<T, GENERIC>(a, q, tab, bytes, st);
  }
}

// ---- fused vector pass ------------------------------------------------------

template <typename T, typename OP, int ZAP>
__global__ void __launch_bounds__(FUSED_THREADS)
vec_ring_fused_kernel(const VecFusedArgs<T> a, const FusedRing q,
                      const __grid_constant__ VecRingTable<T> tab) {
  const int tid = threadIdx.x;
  const Item it = draw_fused_item(q, tid);
  if (it.what == SEND) {
    fused_send<T>(q, tab, it.shard, it.side, a.n_ops, a.first != 0, tid);
    return;
  }
  const int H = a.n_ops, y0 = it.ty * a.by;
  if (y0 - H < 0) wait_flag(q.flags + 2 * it.shard, q.epoch, tid);
  if (y0 + a.by + H > q.ly) wait_flag(q.flags + 2 * it.shard + 1, q.epoch, tid);
  vec_fused_tile<T, OP, ZAP>(a, tab.shard[it.shard], RingGeo{q.ly, q.nx, q.pad, 0},
                             TileOrigin{it.ty, it.tx});
}

template <typename T, typename OP, int ZAP>
int launch_vec_ring_mode(const VecFusedArgs<T>& a, const FusedRing& q, const VecRingTable<T>& tab,
                         size_t bytes, cudaStream_t st) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vec_ring_fused_kernel<T, OP, ZAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  vec_ring_fused_kernel<T, OP, ZAP><<<(unsigned)fused_items(q), FUSED_THREADS, bytes, st>>>(
      a, q, tab);
  return (int)cudaGetLastError();
}

// One fused vector pass of every shard, with the kernel compiled for the
// contraction and for zap: `a` holds the pass (steps, tile, p_a); `planes`
// holds 8 pointers per shard, in the order of VecShardPlanes.
template <typename T>
int launch_vec_ring_fused(int op, int zap, const VecFusedArgs<T>& a, int p, int ly, int nx,
                          int pad, const void* const* planes, void* ticket, void* flags,
                          unsigned long long base, unsigned epoch, cudaStream_t st) {
  if (op != BGRID && op != CTAP) return (int)cudaErrorInvalidValue;
  FusedRing q;
  if (!fused_ring(p, ly, nx, pad, 0, a.by, a.bx, a.n_ops, planes, ticket, flags, base, epoch,
                  &q))
    return (int)cudaErrorInvalidValue;
  const int n_coef = op == BGRID ? BGridLap::N_COEF : CTapLap::N_COEF;
  const size_t bytes = vec_fused_shared_bytes<T>(a.by, a.bx, a.n_ops, n_coef);
  if (bytes > MAX_SHARED) return (int)cudaErrorInvalidValue;
  static_assert(sizeof(VecShardPlanes<T>) == 8 * sizeof(void*), "8 pointers a shard");
  VecRingTable<T> tab;
  std::memcpy(tab.shard, planes, (size_t)p * sizeof(VecShardPlanes<T>));
  if (op == BGRID)
    return zap ? launch_vec_ring_mode<T, BGridLap, 1>(a, q, tab, bytes, st)
               : launch_vec_ring_mode<T, BGridLap, 0>(a, q, tab, bytes, st);
  return zap ? launch_vec_ring_mode<T, CTapLap, 1>(a, q, tab, bytes, st)
             : launch_vec_ring_mode<T, CTapLap, 0>(a, q, tab, bytes, st);
}

// ---- launches ---------------------------------------------------------------

bool ring_geometry(int p, int ly, int nx, int kind, int swap, unsigned epoch, void* ticket,
                   Ring* q) {
  if (p < 2 || ly < 1 || nx < 1 || !ticket) return false;
  if (kind != FIRST && kind != MIDDLE && kind != LAST) return false;
  q->p = p; q->ly = ly; q->nx = nx;
  q->tiles_x = (nx + TILE_X - 1) / TILE_X;
  q->tiles_y = (ly + TILE_Y - 1) / TILE_Y;
  q->swap = swap ? 1 : 0;
  q->epoch = epoch;
  q->ticket = static_cast<unsigned long long*>(ticket);
  return total_items(p, q->tiles_x, q->tiles_y) <= 0x7fffffffLL;
}

template <typename T>
int launch_scalar(int kind, int swap, int p, int ly, int nx, const void* table, void* ticket,
                  unsigned epoch, double cv, double nv, double sv, double ev, double wv,
                  double p_a, double p_b, double land_gain, int zap, int fold, int drop_pre,
                  void* stream) {
  cudaGetLastError();  // clear a stale error so the result below is this launch's
  Ring q;
  if (!table || !ring_geometry(p, ly, nx, kind, swap, epoch, ticket, &q))
    return (int)cudaErrorInvalidValue;
  ScalarStep<T> s;
  s.cval[0] = T(cv); s.cval[1] = T(nv); s.cval[2] = T(sv); s.cval[3] = T(ev); s.cval[4] = T(wv);
  s.p_a = T(p_a); s.p_b = T(p_b); s.land_gain = T(land_gain);
  s.zap = zap; s.fold = fold; s.drop_pre = drop_pre;
  const Shard<T>* tab = static_cast<const Shard<T>*>(table);
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((unsigned)total_items(p, q.tiles_x, q.tiles_y));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case FIRST: ring_pass_kernel<T, FIRST><<<grid, block, 0, st>>>(q, s, tab); break;
    case MIDDLE: ring_pass_kernel<T, MIDDLE><<<grid, block, 0, st>>>(q, s, tab); break;
    default: ring_pass_kernel<T, LAST><<<grid, block, 0, st>>>(q, s, tab); break;
  }
  return (int)cudaGetLastError();
}

template <typename T, typename OP>
void launch_vec_kind(int kind, dim3 grid, dim3 block, cudaStream_t st, const Ring& q,
                     const VecStep<T>& s, const VecShard<T>* tab) {
  switch (kind) {
    case FIRST: vec_ring_pass_kernel<T, OP, FIRST><<<grid, block, 0, st>>>(q, s, tab); break;
    case MIDDLE: vec_ring_pass_kernel<T, OP, MIDDLE><<<grid, block, 0, st>>>(q, s, tab); break;
    default: vec_ring_pass_kernel<T, OP, LAST><<<grid, block, 0, st>>>(q, s, tab); break;
  }
}

template <typename T>
int launch_vector(int op, int kind, int swap, int p, int ly, int nx, const void* table,
                  void* ticket, unsigned epoch, double p_a, double p_b, int zap, void* stream) {
  cudaGetLastError();  // clear a stale error so the result below is this launch's
  Ring q;
  if (!table || !ring_geometry(p, ly, nx, kind, swap, epoch, ticket, &q))
    return (int)cudaErrorInvalidValue;
  if (op != BGRID && op != CTAP) return (int)cudaErrorInvalidValue;
  VecStep<T> s;
  s.p_a = T(p_a); s.p_b = T(p_b); s.zap = zap;
  const VecShard<T>* tab = static_cast<const VecShard<T>*>(table);
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((unsigned)total_items(p, q.tiles_x, q.tiles_y));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == BGRID) launch_vec_kind<T, BGridLap>(kind, grid, block, st, q, s, tab);
  else launch_vec_kind<T, CTapLap>(kind, grid, block, st, q, s, tab);
  return (int)cudaGetLastError();
}

}  // namespace

#define RING_PASS_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(int kind, int swap, int p, int ly, int nx, const void* table,       \
                      void* ticket, unsigned epoch, double cv, double nv, double sv,      \
                      double ev, double wv, double p_a, double p_b, double land_gain,     \
                      int zap, int fold, int drop_pre, void* stream) {                    \
    return launch_scalar<T>(kind, swap, p, ly, nx, table, ticket, epoch, cv, nv, sv, ev,  \
                            wv, p_a, p_b, land_gain, zap, fold, drop_pre, stream);        \
  }

RING_PASS_ENTRY(ring_pass_f32, float)
RING_PASS_ENTRY(ring_pass_f64, double)

#define VEC_RING_PASS_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(int op, int kind, int swap, int p, int ly, int nx,                  \
                      const void* table, void* ticket, unsigned epoch, double p_a,        \
                      double p_b, int zap, void* stream) {                                \
    return launch_vector<T>(op, kind, swap, p, ly, nx, table, ticket, epoch, p_a, p_b,    \
                            zap, stream);                                                 \
  }

VEC_RING_PASS_ENTRY(vec_ring_pass_f32, float)
VEC_RING_PASS_ENTRY(vec_ring_pass_f64, double)

// One fused pass of every shard: steps start+1 .. start+n_ops of the filter
// (`first`: the pass begins with FIRST and reads the raw field; `last`: it
// ends with LAST and leaves the result in acc), on tiles of by x bx own
// cells. `planes` holds 16 pointers per shard (ShardPlanes); the plane
// pointers among the arguments are shard 0's, which give the compiled mode.
// `flags` holds two words per shard, `base` the tickets drawn before this
// launch.
#define RING_FUSED_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(int p, int ly, int nx, int pad, int by, int bx, int n_ops,         \
                      int first, int last, const double* pa, double p_b,                 \
                      const void* const* planes, void* ticket, void* flags,              \
                      unsigned long long base, unsigned epoch, const T* c, const T* n,   \
                      const T* s, const T* e, const T* w, double cv, double nv,          \
                      double sv, double ev, double wv, const T* pre, const T* post,      \
                      const T* area, double land_gain, int zap, int fold, int drop_pre,  \
                      void* stream) {                                                    \
    cudaGetLastError();                                                                  \
    const FusedArgs<T> a = fused_args<T>(by, bx, n_ops, first, last, pa, p_b, nullptr,   \
                                         nullptr, nullptr, nullptr, nullptr, nullptr,    \
                                         nullptr, nullptr, c, n, s, e, w, cv, nv, sv, ev, \
                                         wv, pre, post, area, land_gain, zap, drop_pre); \
    return launch_ring_fused<T>(a, p, ly, nx, pad, fold, planes, ticket, flags, base,    \
                                epoch, static_cast<cudaStream_t>(stream));               \
  }

RING_FUSED_ENTRY(ring_fused_pass_f32, float)
RING_FUSED_ENTRY(ring_fused_pass_f64, double)

// One fused vector pass of every shard: steps start+1 .. start+n_ops of the
// filter with contraction `op` (`first`: the pass begins with FIRST and
// reads w; `last`: it ends with LAST and leaves the result in acc), on tiles
// of by x bx own cells. `planes` holds 8 pointers per shard
// (VecShardPlanes), `flags` two words per shard, `base` the tickets drawn
// before this launch.
#define VEC_RING_FUSED_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(int op, int p, int ly, int nx, int pad, int by, int bx, int n_ops, \
                      int first, int last, const double* pa, double p_b,                 \
                      const void* const* planes, void* ticket, void* flags,              \
                      unsigned long long base, unsigned epoch, int zap, void* stream) {  \
    cudaGetLastError();                                                                  \
    const VecFusedArgs<T> a = vec_fused_args<T>(by, bx, n_ops, first, last, pa, p_b,     \
                                                nullptr, nullptr, nullptr, nullptr,      \
                                                nullptr, nullptr, nullptr, nullptr);     \
    return launch_vec_ring_fused<T>(op, zap, a, p, ly, nx, pad, planes, ticket, flags,   \
                                    base, epoch, static_cast<cudaStream_t>(stream));     \
  }

VEC_RING_FUSED_ENTRY(vec_ring_fused_pass_f32, float)
VEC_RING_FUSED_ENTRY(vec_ring_fused_pass_f64, double)

// Pointers in one row of the scalar and of the vector table, for the wrapper.
extern "C" int ring_pass_table_row(int vector) {
  return (int)((vector ? sizeof(VecShard<float>) : sizeof(Shard<float>)) / sizeof(void*));
}

extern "C" const char* ring_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
