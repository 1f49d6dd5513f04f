// Kernels of the neighbor-list path, for Hopper (sm_90a).  Plain C
// launchers, loaded with ctypes by treensearch_tpu_torch/ops/pairs.py; each
// returns cudaGetLastError().
//
// Build flags (ops/pairs.py NVCC_FLAGS) never include --use_fast_math or
// -ftz: the query padding carries NaN coordinates that must fail every
// d^2 <= r^2 compare, and d^2 is rounded exactly as eager PyTorch and
// numpy round it (explicit _rn intrinsics, so no FMA contraction).
//
// Layouts (all int32; float fields travel as their bit patterns):
//   desc   (>= tiles_cap, 128): window starts in columns [0, n_win), window
//          lengths in [64, 64 + n_win), the tile's first sorted point in 62,
//          its real point count in 63, and 2 in column 127 for a dead tile.
//   recs_t (8, n_rec): sorted records, field-major: x, y, z, r, orig, set,
//          p0, p1.
//   q_t    (8, tiles_cap * 128): query tiles, field-major.
// Every kernel clips every record range to [0, n_rec), so no descriptor
// can make it read outside recs_t; the plain versions clip the same way.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int TILE = 128;
constexpr int DESC_W = 128;
constexpr int LENS_OFF = 64;
constexpr int A_COL = 62;
constexpr int CNT_COL = 63;
constexpr int FAT_COL = 127;
constexpr int N_FIELDS = 8;
constexpr int F_R = 3;
constexpr int F_ORIG = 4;
constexpr int F_SET = 5;
constexpr int SENTINEL_BITS = 0x7FC00000;  // quiet NaN
constexpr int CHUNK = 256;                 // candidates staged per pass

// K1 -- replaces make_expand_call(build_rec=False)
// (treensearch_tpu/ops/pallas_pairs.py:276).  Slot 128 t + l of the query
// tiles gets sorted record a_t + l when l < cnt_t and the sentinel record
// otherwise.  One thread per padded slot.  Bound: memory, 2 * 8 * 4 bytes
// per slot (read one record, write one); the TPU kernel's DMA banks and
// lane rotations exist to make unaligned tile starts cheap there, which
// on this card is what coalesced per-thread loads of consecutive records
// already are.
__global__ void expand_query_tiles_kernel(const int* __restrict__ desc,
                                          const int* __restrict__ recs_t,
                                          int n_rec, int n_slots,
                                          int sentinel_orig,
                                          int* __restrict__ q_t) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= n_slots) return;
  const int t = slot / TILE;
  const int l = slot % TILE;
  const int a = desc[(size_t)t * DESC_W + A_COL];
  const int cnt = desc[(size_t)t * DESC_W + CNT_COL];
  if (l < cnt && a >= 0 && (long long)a + l < n_rec) {
    const size_t src = (size_t)a + l;
#pragma unroll
    for (int f = 0; f < N_FIELDS; ++f)
      q_t[(size_t)f * n_slots + slot] = recs_t[(size_t)f * n_rec + src];
  } else {
#pragma unroll
    for (int f = 0; f < N_FIELDS; ++f) {
      int v = 0;
      if (f < 3) v = SENTINEL_BITS;
      else if (f == F_ORIG) v = sentinel_orig;
      else if (f == F_SET) v = -1;
      q_t[(size_t)f * n_slots + slot] = v;
    }
  }
}

// K1r -- replaces make_expand_call(build_rec=True)
// (treensearch_tpu/ops/pallas_pairs.py:276-442).  K1's query tiles, and the
// same records slot-major in rec_pad (n_slots + slack, 8): slot 128 t + l
// holds sorted record a_t + l when l < cnt_t, every other slot and the
// slack tail the sentinel record.  One thread per padded slot; each reads
// its record's 8 fields from the field-major recs_t (consecutive threads,
// consecutive records: coalesced), writes them field-major into q_t and
// as one 32-byte record (two int4 stores) into rec_pad.  Bound: memory,
// 32 bytes read per live slot and 64 written per slot.  The TPU kernel's
// DMA banks and lane rotations make unaligned tile starts cheap there;
// the per-thread loads do that here.
__global__ void expand_records_kernel(const int* __restrict__ desc,
                                      const int* __restrict__ recs_t,
                                      int n_rec, int n_slots, int n_total,
                                      int sentinel_orig,
                                      int* __restrict__ q_t,
                                      int4* __restrict__ rec_pad) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= n_total) return;
  int v[N_FIELDS] = {SENTINEL_BITS, SENTINEL_BITS, SENTINEL_BITS, 0,
                     sentinel_orig, -1, 0, 0};
  if (slot < n_slots) {
    const int t = slot / TILE;
    const int l = slot % TILE;
    const int a = desc[(size_t)t * DESC_W + A_COL];
    const int cnt = desc[(size_t)t * DESC_W + CNT_COL];
    if (l < cnt && a >= 0 && (long long)a + l < n_rec) {
      const size_t src = (size_t)a + l;
#pragma unroll
      for (int f = 0; f < N_FIELDS; ++f) v[f] = recs_t[(size_t)f * n_rec + src];
    }
#pragma unroll
    for (int f = 0; f < N_FIELDS; ++f) q_t[(size_t)f * n_slots + slot] = v[f];
  }
  rec_pad[2 * (size_t)slot] = make_int4(v[0], v[1], v[2], v[3]);
  rec_pad[2 * (size_t)slot + 1] = make_int4(v[4], v[5], v[6], v[7]);
}

// The output blocks of K2 (K2a has one), passed by value: block b collects
// the survivors whose set id is set_of[b], as set-local indices orig -
// offset[b], in rows of k8[b] (tiles_cap, k8[b], 128); its counts are row b
// of counts (n_blocks, tiles_cap * 128).  K2 stages the first stage[b]
// entries of each thread's row of block b in shared memory.
constexpr int MAX_BLOCKS = 8;
struct Blocks {
  int n_blocks;
  int set_of[MAX_BLOCKS];
  int offset[MAX_BLOCKS];
  int k8[MAX_BLOCKS];
  int stage[MAX_BLOCKS];
  int* nbrs[MAX_BLOCKS];
  int* counts;
};

// ---------------------------------------------------------------------------
// The candidate stream of a tile (K2a-K2c, K4, K5; csrc/reduce.cu keeps its
// copy for K3).  The tile's n_win windows, each clipped to the records as
// every kernel clips them, are read as one stream in window order: stream
// index k lies in window w when pre[w] <= k < pre[w + 1] (pre: the exclusive
// prefix of the clipped lengths, pre[n_win] the tile's candidate count) and
// is record start[w] + k - pre[w].  Each thread walks its stream indices in
// increasing order, so one window cursor per thread finds each record in
// O(1) amortised steps.  The sum of the clipped lengths is at most n_win *
// n_rec, inside int32 for n_rec below 43M points.
constexpr int MAX_WIN = 49;   // (2W+1)^2 windows for W <= 3 (LENS_OFF = 64)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clipped_len(const int* d, int w, int n_rec) {
  const int s = d[w];
  if (s < 0 || s > n_rec) return 0;
  return max(0, min(d[LENS_OFF + w], n_rec - s));
}

// Warp 0 writes the window starts into start[0, 64) and the prefix of the
// clipped lengths into pre[0, 65) (entries past n_win repeat the total); the
// caller synchronises the block before reading them.
__device__ __forceinline__ void tile_stream(const int* d, int n_rec, int n_win,
                                            int* start, int* pre) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  int lo = lane < n_win ? clipped_len(d, lane, n_rec) : 0;
  int hi = lane + 32 < n_win ? clipped_len(d, lane + 32, n_rec) : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(FULL, lo, off);
    const int b = __shfl_up_sync(FULL, hi, off);
    if (lane >= off) {
      lo += a;
      hi += b;
    }
  }
  hi += __shfl_sync(FULL, lo, 31);
  if (lane == 0) pre[0] = 0;
  pre[lane + 1] = lo;
  pre[lane + 33] = hi;
  start[lane] = lane < n_win ? d[lane] : 0;
  start[lane + 32] = lane + 32 < n_win ? d[lane + 32] : 0;
}

// Advance a thread's window cursor to stream index k (< the total) and
// return k's record.
__device__ __forceinline__ int stream_record(const int* start, const int* pre,
                                             int k, int& w) {
  while (k >= pre[w + 1]) ++w;
  return start[w] + (k - pre[w]);
}

// One 4-byte asynchronous copy global -> shared (cp.async, sm_80+), with its
// commit and wait.  The window starts are arbitrary record indices, so a
// chunk's source is not 16-byte aligned and TMA bulk copies do not apply;
// per-element cp.async needs no alignment beyond the element's and holds no
// registers while in flight.
__device__ __forceinline__ void cp_async4(void* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
// One 16-byte copy, bypassing L1 (K5's bit rows, 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const int4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float d2_rn(float cx, float cy, float cz, float qx,
                                       float qy, float qz) {
  const float dx = __fsub_rn(cx, qx);
  const float dy = __fsub_rn(cy, qy);
  const float dz = __fsub_rn(cz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// -1 past count in a thread's row of k8 entries (stride TILE), the warp's
// 32 lanes entry by entry from their smallest count, so that each store is
// one 128-byte line: a loop per lane strides 512 bytes between its stores
// and half writes a line with each.  The whole warp calls it.
__device__ __forceinline__ void fill_tail(int* row, int count, int k8) {
  int k0 = min(count, k8);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    k0 = min(k0, __shfl_xor_sync(FULL, k0, off));
  for (int k = k0; k < k8; ++k)
    if (k >= count) row[(size_t)k * TILE] = -1;
}

// A thread's row out at the end of its tile: its first e entries, staged
// in shared memory (stride TILE), line by line across the warp with -1
// past its count n, then -1 past them with fill_tail.  The whole warp
// calls it, with one e.
__device__ __forceinline__ void flush_row(int* row, const int* staged, int n,
                                          int k8, int e) {
  for (int k = 0; k < e; ++k)
    row[(size_t)k * TILE] = k < n ? staged[k * TILE] : -1;
  fill_tail(row, max(n, e), k8);
}

constexpr int WORD = 32;       // K2 candidates per test word, K5 rows per group
constexpr int STAGED = 32;     // K5 row entries a thread stages in shared memory
constexpr int K2_STAGED = 16;  // K2 row entries a thread stages in shared memory

// The cull's lower bound of d^2 between a candidate c and every query of a
// warp inside its box [lo, hi]: per axis the gap max(lo - c, c - hi, 0),
// then d2_rn's operations in d2_rn's order.  A NaN candidate gives NaN.
__device__ __forceinline__ float box_gap(float c, float lo, float hi) {
  const float g = fmaxf(__fsub_rn(lo, c), __fsub_rn(c, hi));
  return g < 0.0f ? 0.0f : g;   // a NaN gap stays NaN
}
__device__ __forceinline__ float box_d2_rn(float4 c, float3 lo, float3 hi) {
  const float gx = box_gap(c.x, lo.x, hi.x);
  const float gy = box_gap(c.y, lo.y, hi.y);
  const float gz = box_gap(c.z, lo.z, hi.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// K2a, K2b and K2c -- replace make_pairs_call in neighbor-list mode
// (treensearch_tpu/ops/pallas_pairs.py:445): K2a at a fixed radius with one
// candidate set (ONE_SET; narrow and fat tier alike), K2b with multi_set (one
// output block per distinct candidate set, cand_sets/cand_offsets/nbr_caps),
// K2c with variable/symmetric radii (the criterion :950-957, the per-block
// compaction :1154-1310).  One block of 128 threads per query tile, one query
// per thread, each survivor appended to the thread's own row of its block in
// window order, so the rows equal the plain version's slot for slot;
// counting goes on past a block's k8.
//   VARIABLE:  d^2 <= r_i^2, r_i the query's F_R, squared in float32;
//              else d^2 <= r2 (K2a's and K2b's fixed radius).
//   SYMMETRIC: also d^2 <= r_j^2 (variable only).
//   ONE_SET:   K2a: one block that keeps every survivor as its orig.
// The sentinel query (NaN coordinates, r = 0) fails every compare.
//
// Bound: the distance tests the search needs (9 float32 operations each, 10
// symmetric; the _rn pins forbid FMA) and the rows (k8 x 128 ints per tile
// and block, 384 MB at config 1, 4.48 GB at config 5, written whole).  The
// TPU kernel's compaction networks and MXU prefix sums existed because a
// TPU core cannot append per lane; here each thread appends to its own row.
// A tile is a z-run of about 11 cells (config 1) inside one grid row, and
// its windows hold every candidate any of its 128 queries could reach:
// 4.5x (config 1) to 5.4x (config 5) the tests the search needs, no lane
// hitting in 84% of (warp, candidate) steps.  This design:
//   * concatenates the clipped windows into one stream (tile_stream) cut
//     into full CHUNK-candidate chunks that cross window boundaries:
//     ceil(sum len / CHUNK) passes, about 5 instead of 9 at config 1 and
//     15 instead of 25 at config 4 (a design staging each window on its
//     own took K2a 1.0012 ms at config 1, K2b/K2c 1.1371 and 1.8657 ms at
//     configs 3 and 4 on the H100);
//   * double-buffers the chunks: chunk c + 1 is copied with cp.async while
//     chunk c is tested, one barrier per chunk; each thread then squares
//     its own staged r_j and turns its staged set into a block index;
//   * packs the geometry as one float4 (x, y, z, r_j^2) per candidate and
//     keeps the orig (K2a) or (orig, block) (K2b/K2c) aside, read only on a
//     hit, where self-exclusion and the block dispatch happen; pads the
//     last chunk with NaN candidates;
//   * culls per warp: once per tile each warp reduces its lanes' query
//     coordinates to a box [lo, hi] (fminf/fmaxf from +-inf, so NaN lanes
//     drop out and an all-sentinel warp's box is empty) and its threshold
//     thr (r2, or VARIABLE the warp's largest r_i^2).  For each 32-candidate
//     word of a chunk, lane u takes candidate j0 + u and keeps it iff its
//     box_d2_rn gd2 <= thr (SYMMETRIC: or gd2 <= r_j^2); __ballot_sync gives
//     the word's survivors.  No margin is needed: round-to-nearest
//     subtraction, multiplication of non-negatives and addition of
//     non-negatives are each monotone, and RN is symmetric, so for a query
//     q inside the box with q_x >= lo_x > c_x, |fl(c_x - q_x)| = fl(q_x -
//     c_x) >= fl(lo_x - c_x), and so on up the sum: the query's computed
//     d^2 is at least gd2, and gd2 > thr (and > r_j^2) fails the exact
//     test in every lane.  A NaN candidate gives a NaN gd2 and is culled;
//     an empty box culls everything.  The culled tests are all misses, so
//     the rows, counts and truncation equal the plain version's bit for bit
//     (tests/test_torch_cull.py holds the bound in float32 on the CPU).  On
//     the H100 the warps skip 0.7519 of the window tests at config 1,
//     0.7844 at config 3, 0.8863 at config 4 and 0.7508 at config 5;
//   * compacts the survivors: each warp appends a word's survivors (their
//     float4 and id) in order to a list of 2 x WORD in shared memory and
//     tests the list WORD at a time, unrolled, with the bit of each test a
//     compile-time constant, then walks that word's hits lowest bit first
//     (window order kept; the warp pays for the hit body as often as its
//     busiest lane hits); the list's last survivors are tested padded with
//     NaN.  Walking each word's survivor bits instead (one test per
//     iteration, its bit and address computed) cost K2a 0.68 ms at config
//     1 against 0.59;
//   * stages each thread's first K2_STAGED row entries (K2b/K2c: split over
//     the blocks in proportion to their k8) in shared memory and writes
//     them at the end line by line across the warp, then the -1 tails
//     with fill_tail (flush_row, as K5 does); a hit past them goes
//     straight to its row.  A hit stored straight to its lane's row lands
//     512 bytes from its neighbour's and writes one 4-byte word of a
//     sector, as does a -1 tail filled by a loop per lane: with every hit
//     stored so and K2b's tails filled per lane, K2a took 0.80 ms at
//     config 1 (0.48 with no hit stored) and K2b 10.48 ms at config 5 (5.67
//     with no hit stored, 6.62 with no tail written).  16 entries beat 0, 8,
//     24, 32 and 48 at configs 1, 3 and 4 (24 was 1% faster at config 5):
//     more shared memory per block means fewer resident blocks;
//   * asks __launch_bounds__ for 8 resident blocks per SM (53 registers
//     for K2a, 56 for K2b and K2c, 62 symmetric, no spills; at 10 blocks
//     K2a and K2c spill).
// Measured on the H100 (NVIDIA H100 80GB HBM3, 700 W; CUDA events, median of
// 7 runs of 10 calls): K2a 0.539 ms at config 1 (bound 0.1269 ms, by bytes),
// K2b 0.446-0.456 ms at config 3 (bound 0.1156) and 6.80 ms at config 5
// (bound 1.636), K2c 0.353-0.359 ms at config 4 (bound 0.0567, by
// operations); before the cull, the compaction and the staged entries
// 0.824-0.828, 0.785-0.786, 10.81 and 0.840-0.852 ms.
// With tested non-null, lane 0 of each warp adds the number of candidates
// its warp tested after the cull (one atomicAdd per warp and tile); every
// engine path passes null.
// Dead tiles return at once (their rows are undefined).
template <bool VARIABLE, bool SYMMETRIC, bool ONE_SET>
__global__ void __launch_bounds__(TILE, 8)
pairs_nbrs_kernel(const int* __restrict__ desc, const int* __restrict__ q_t,
                  const int* __restrict__ recs_t, int n_rec, int tiles_cap,
                  int n_win, float r2, Blocks blk,
                  unsigned long long* __restrict__ tested) {
  static_assert(!ONE_SET || !VARIABLE, "K2a is the fixed-radius kernel");
  // per candidate: the orig (K2a), or (orig, block) (K2b/K2c)
  using Id = typename std::conditional<ONE_SET, int, int2>::type;
  __shared__ float4 s_geo[2][CHUNK];
  __shared__ Id s_id[2][CHUNK];
  __shared__ int s_start[64];
  __shared__ int s_pre[65];
  __shared__ int* s_nbrs[MAX_BLOCKS];
  __shared__ int s_k8[MAX_BLOCKS];
  __shared__ int s_off[MAX_BLOCKS];
  __shared__ int s_e[MAX_BLOCKS];      // staged entries per thread
  __shared__ int s_e0[MAX_BLOCKS];     // their first row in s_rows
  __shared__ float4 s_cg[TILE / WORD][2 * WORD];   // each warp's survivors
  __shared__ Id s_ci[TILE / WORD][2 * WORD];       // and their ids
  // K2b/K2c: the counts [n_blocks][TILE]; then the staged entries
  // [sum of stage][TILE]
  extern __shared__ int s_dyn[];

  const int t = blockIdx.x;
  const int l = threadIdx.x;
  const int lane = l & 31;
  const int* d = desc + (size_t)t * DESC_W;
  const size_t n_slots = (size_t)tiles_cap * TILE;
  const size_t slot = (size_t)t * TILE + l;
  const int n_blocks = ONE_SET ? 1 : blk.n_blocks;
  if (d[FAT_COL] == 2) {  // dead tile: uniform across the block
    for (int b = 0; b < n_blocks; ++b) blk.counts[b * n_slots + slot] = 0;
    return;
  }
  int* const s_cnt = s_dyn;
  int* const s_rows = s_dyn + (ONE_SET ? 0 : n_blocks * TILE);
  tile_stream(d, n_rec, n_win, s_start, s_pre);
  if constexpr (!ONE_SET) {
#pragma unroll
    for (int b = 0; b < MAX_BLOCKS; ++b) {
      if (b == l && b < n_blocks) {
        s_nbrs[b] = blk.nbrs[b];
        s_k8[b] = blk.k8[b];
        s_off[b] = blk.offset[b];
        s_e[b] = blk.stage[b];
        int e0 = 0;
        for (int p = 0; p < b; ++p) e0 += blk.stage[p];
        s_e0[b] = e0;
      }
    }
    for (int b = 0; b < n_blocks; ++b) s_cnt[b * TILE + l] = 0;
  }
  const float qx = __int_as_float(q_t[slot]);
  const float qy = __int_as_float(q_t[n_slots + slot]);
  const float qz = __int_as_float(q_t[2 * n_slots + slot]);
  const int qo = q_t[F_ORIG * n_slots + slot];
  float qr2 = r2;
  if (VARIABLE) {
    const float qr = __int_as_float(q_t[F_R * n_slots + slot]);
    qr2 = __fmul_rn(qr, qr);
  }
  // the warp's box of live queries and its threshold
  const float inf = __int_as_float(0x7f800000);
  float3 lo = make_float3(fminf(inf, qx), fminf(inf, qy), fminf(inf, qz));
  float3 hi = make_float3(fmaxf(-inf, qx), fmaxf(-inf, qy), fmaxf(-inf, qz));
  float thr = qr2;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo.x = fminf(lo.x, __shfl_xor_sync(FULL, lo.x, off));
    lo.y = fminf(lo.y, __shfl_xor_sync(FULL, lo.y, off));
    lo.z = fminf(lo.z, __shfl_xor_sync(FULL, lo.z, off));
    hi.x = fmaxf(hi.x, __shfl_xor_sync(FULL, hi.x, off));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(FULL, hi.y, off));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(FULL, hi.z, off));
    if (VARIABLE) thr = fmaxf(thr, __shfl_xor_sync(FULL, thr, off));
  }
  // K2a: the thread's row, staged entries and count
  const int k8_1 = ONE_SET ? blk.k8[0] : 0;
  const int e_1 = ONE_SET ? blk.stage[0] : 0;
  int* const row = blk.nbrs[0] + (size_t)t * k8_1 * TILE + l;
  int count = 0;
  unsigned n_tested = 0;   // candidates this warp tested
  __syncthreads();
  const int total = s_pre[n_win];
  const int n_chunks = (total + CHUNK - 1) / CHUNK;
  int cur = 0;   // this thread's window cursor while staging

  // Chunk c into buffer buf: each thread copies stream indices c * CHUNK +
  // l + h * TILE; slots past the stream get a NaN candidate.
  auto stage = [&](int c, int buf) {
#pragma unroll
    for (int h = 0; h < CHUNK / TILE; ++h) {
      const int j = h * TILE + l;
      const int k = c * CHUNK + j;
      if (k < total) {
        const size_t src = stream_record(s_start, s_pre, k, cur);
        cp_async4(&s_geo[buf][j].x, recs_t + src);
        cp_async4(&s_geo[buf][j].y, recs_t + n_rec + src);
        cp_async4(&s_geo[buf][j].z, recs_t + 2 * (size_t)n_rec + src);
        if (SYMMETRIC)
          cp_async4(&s_geo[buf][j].w, recs_t + F_R * (size_t)n_rec + src);
        if constexpr (ONE_SET) {
          cp_async4(&s_id[buf][j], recs_t + F_ORIG * (size_t)n_rec + src);
        } else {
          cp_async4(&s_id[buf][j].x, recs_t + F_ORIG * (size_t)n_rec + src);
          cp_async4(&s_id[buf][j].y, recs_t + F_SET * (size_t)n_rec + src);
        }
      } else {
        s_geo[buf][j] = make_float4(__int_as_float(SENTINEL_BITS),
                                    __int_as_float(SENTINEL_BITS),
                                    __int_as_float(SENTINEL_BITS), 0.0f);
      }
    }
    cp_async_commit();
  };
  // After the wait: r_j squared, the set turned into its block index (-1
  // for a set that is no candidate set), for this thread's own slots.
  auto finish = [&](int c, int buf) {
    cp_async_wait_all();
    if constexpr (!ONE_SET) {
#pragma unroll
      for (int h = 0; h < CHUNK / TILE; ++h) {
        const int j = h * TILE + l;
        if (c * CHUNK + j < total) {
          if (SYMMETRIC) {
            const float r = s_geo[buf][j].w;
            s_geo[buf][j].w = __fmul_rn(r, r);
          }
          const int set = s_id[buf][j].y;
          int bi = -1;
#pragma unroll
          for (int b = 0; b < MAX_BLOCKS; ++b)
            if (b < n_blocks && set == blk.set_of[b]) bi = b;
          s_id[buf][j].y = bi;
        }
      }
    }
  };
  // the hit work of this thread's query on the candidate of id: its
  // entry staged, or past the staged ones straight to the row
  auto append = [&](Id id) {
    if constexpr (ONE_SET) {
      const int o = id;
      if (o == qo) return;
      if (count < e_1)
        s_rows[count * TILE + l] = o;
      else if (count < k8_1)
        row[(size_t)count * TILE] = o;
      ++count;
    } else {
      if (id.x == qo || id.y < 0) return;
      int* cnt = &s_cnt[id.y * TILE + l];
      const int n = *cnt;
      const int k8 = s_k8[id.y];
      const int v = id.x - s_off[id.y];
      if (n < s_e[id.y])
        s_rows[(s_e0[id.y] + n) * TILE + l] = v;
      else if (n < k8)
        s_nbrs[id.y][((size_t)t * k8 + n) * TILE + l] = v;
      *cnt = n + 1;
    }
  };
  float4* const cg_w = s_cg[l >> 5];
  Id* const ci_w = s_ci[l >> 5];
  int n_pend = 0;   // survivors waiting in the warp's list
  // test the list's first WORD survivors, then move the rest down
  auto test_list = [&]() {
    __syncwarp();
    unsigned hits = 0u;
#pragma unroll
    for (int u = 0; u < WORD; ++u) {
      const float4 cg = cg_w[u];
      const float d2 = d2_rn(cg.x, cg.y, cg.z, qx, qy, qz);
      bool hit = d2 <= qr2;
      if (SYMMETRIC) hit = hit || d2 <= cg.w;
      hits |= hit ? (1u << u) : 0u;
    }
    for (; hits; hits &= hits - 1) append(ci_w[__ffs(hits) - 1]);
    __syncwarp();
    if (lane < n_pend - WORD) {
      cg_w[lane] = cg_w[WORD + lane];
      ci_w[lane] = ci_w[WORD + lane];
    }
    n_pend -= WORD;
    __syncwarp();
  };

  if (n_chunks > 0) {
    stage(0, 0);
    finish(0, 0);
  }
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) stage(c + 1, buf ^ 1);
    const int m = min(CHUNK, total - c * CHUNK);
    const float4* g = s_geo[buf];
    for (int j0 = 0; j0 < m; j0 += WORD) {   // warp-uniform words
      const float4 cu = g[j0 + lane];
      const float gd2 = box_d2_rn(cu, lo, hi);
      bool keep = gd2 <= thr;
      if (SYMMETRIC) keep = keep || gd2 <= cu.w;
      const unsigned live = __ballot_sync(FULL, keep);
      if (keep) {
        const int p = n_pend + __popc(live & ((1u << lane) - 1u));
        cg_w[p] = cu;
        ci_w[p] = s_id[buf][j0 + lane];
      }
      n_pend += __popc(live);
      n_tested += __popc(live);
      if (n_pend >= WORD) test_list();
    }
    if (c + 1 < n_chunks) finish(c + 1, buf ^ 1);
    __syncthreads();
  }
  if (n_pend > 0) {   // the last survivors, the list padded with NaN
    __syncwarp();
    if (lane >= n_pend)
      cg_w[lane] = make_float4(__int_as_float(SENTINEL_BITS),
                               __int_as_float(SENTINEL_BITS),
                               __int_as_float(SENTINEL_BITS), 0.0f);
    n_pend = WORD;
    test_list();
  }
  if (tested != nullptr && lane == 0)
    atomicAdd(tested, (unsigned long long)n_tested);
  if constexpr (ONE_SET) {
    blk.counts[slot] = count;
    flush_row(row, s_rows + l, count, k8_1, e_1);
  } else {
    for (int b = 0; b < n_blocks; ++b) {
      const int n = s_cnt[b * TILE + l];
      blk.counts[b * n_slots + slot] = n;
      flush_row(s_nbrs[b] + (size_t)t * s_k8[b] * TILE + l,
                s_rows + s_e0[b] * TILE + l, n, s_k8[b], s_e[b]);
    }
  }
}

// The candidate sets of K4 (and K3, csrc/reduce.cu), passed by value: a
// candidate whose set is set_of[b] carries bit b, and a query of set s
// takes it when bit b of allow[s] is set (the active matrix).
struct CandSets {
  int n_blocks;
  int set_of[MAX_BLOCKS];
};

__device__ __forceinline__ int cand_bit(const CandSets& cs, int set) {
  int bit = 0;
#pragma unroll
  for (int b = 0; b < MAX_BLOCKS; ++b)
    if (b < cs.n_blocks && set == cs.set_of[b]) bit = 1 << b;
  return bit;
}

// Transpose a 32 x 32 bit matrix held one row per lane (bit c of lane r's
// word) so that lane r holds column r: five rounds of swapping off-diagonal
// blocks of 16, 8, 4, 2 and 1 bits with the partner lane.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    // the bits c with (c & s) == 0: 0x0000FFFF, 0x00FF00FF, ... 0x55555555
    const unsigned low = s == 16 ? 0x0000FFFFu : s == 8 ? 0x00FF00FFu
                       : s == 4 ? 0x0F0F0F0Fu : s == 2 ? 0x33333333u
                                                : 0x55555555u;
    const unsigned y = __shfl_xor_sync(FULL, x, s);
    x = (lane & s) ? (x & ~low) | ((y >> s) & low)
                   : (x & low) | ((y << s) & ~low);
  }
  return x;
}

// K4 -- replaces make_pairs_call(mask_mode=True)
// (treensearch_tpu/ops/pallas_pairs.py:779-859).  Its output is one row of
// four 32-bit words per candidate (bit l % 32 of word l / 32: query lane l
// of the tile hits it) at row cand_base[t] + k, k the candidate's index in
// the tile's window order, plus each query's count: a per-candidate
// product, so each thread owns candidates, not queries.  One block of 128
// threads per tile:
//   * the tile's 128 queries go to shared memory once, as float4 (x, y, z,
//     r_i^2 or the fixed r^2; the sentinel lanes keep their NaN
//     coordinates), and per candidate-set bit b the 4 words of the queries
//     whose set's allow entry has bit b (the active matrix);
//   * thread l takes stream indices k = l, l + 128, ... of the tile's
//     clipped windows (tile_stream) and reads its candidate straight from
//     recs_t: consecutive lanes, consecutive records, coalesced; nothing is
//     staged;
//   * it tests its candidate against the 128 queries, 32 per word with
//     the bit a compile-time constant, each a broadcast float4 load and the
//     pinned d^2; a candidate whose set no query of the tile searches
//     skips the tests;
//   * it ANDs each word with the allowed-queries words of its set's bit,
//     clears the bit of every hit query whose orig is the candidate's
//     (the plain version's self-exclusion, looked at only on the hits, so
//     any q_t gives the plain version's bits), and stores the row as one
//     int4: coalesced 16-byte stores, no ballot, no shared scratch;
//   * counts: each warp transposes each word across its 32 lanes
//     (transpose32), so lane i then holds, per word w, the hits of query
//     32 w + i over the warp's 32 candidates as one word, and adds its
//     __popc; the 4 warps' sums meet in shared memory, in a fixed order,
//     once per tile.
// Bound: the distance tests, 9 float32 operations each (10 symmetric),
// one FP32 issue each under the _rn pins, about 11.5 instructions a test
// with the broadcast load and the bit; the transposes add about 4 x 27
// instructions per lane and 128 tests; the bits are 16 B per candidate row.
// It asks __launch_bounds__ for 8 resident blocks per SM (the 32 unrolled
// tests of a word hold their queries in registers).  The design
// it replaces (PR 3, 1.4167 ms at config 1 on the H100, PR 5's run) was
// K2's query-major schedule with a __ballot_sync, a lane-0 shared store
// per staged candidate and a third pass over shared memory per chunk to
// store the words.
// Dead tiles return at once and own no rows.  A row at or past rows_cap
// (bits' size: a static cap under CUDA graph capture, else the row count)
// is not stored; the wrapper reports cand_base[tiles] > rows_cap.
template <bool VARIABLE, bool SYMMETRIC>
__global__ void __launch_bounds__(TILE, 8)
pairs_mask_kernel(const int* __restrict__ desc, const int* __restrict__ q_t,
                  const int* __restrict__ recs_t, int n_rec, int tiles_cap,
                  int n_win, float r2, CandSets cs,
                  const int* __restrict__ allow, int n_allow,
                  const long long* __restrict__ cand_base,
                  long long rows_cap, int* __restrict__ counts,
                  int* __restrict__ bits) {
  constexpr int WORDS = TILE / 32;
  __shared__ float4 s_q[TILE];
  __shared__ int s_qo[TILE];
  __shared__ unsigned s_allowed[MAX_BLOCKS][WORDS];
  __shared__ int s_sum[WORDS][TILE];
  __shared__ int s_start[64];
  __shared__ int s_pre[65];

  const int t = blockIdx.x;
  const int l = threadIdx.x;
  const int lane = l & 31;
  const int warp = l >> 5;
  const int* d = desc + (size_t)t * DESC_W;
  const size_t n_slots = (size_t)tiles_cap * TILE;
  const size_t slot = (size_t)t * TILE + l;
  if (d[FAT_COL] == 2) {  // dead tile: uniform across the block
    counts[slot] = 0;
    return;
  }
  tile_stream(d, n_rec, n_win, s_start, s_pre);
  {
    float qr2 = r2;
    if (VARIABLE) {
      const float qr = __int_as_float(q_t[F_R * n_slots + slot]);
      qr2 = __fmul_rn(qr, qr);
    }
    s_q[l] = make_float4(__int_as_float(q_t[slot]),
                         __int_as_float(q_t[n_slots + slot]),
                         __int_as_float(q_t[2 * n_slots + slot]), qr2);
    s_qo[l] = q_t[F_ORIG * n_slots + slot];
    const int qs = q_t[F_SET * n_slots + slot];
    const int allow_q = (qs >= 0 && qs < n_allow) ? allow[qs] : 0;
#pragma unroll
    for (int b = 0; b < MAX_BLOCKS; ++b) {
      const unsigned v = __ballot_sync(FULL, (allow_q >> b) & 1);
      if (lane == 0) s_allowed[b][warp] = v;
    }
  }
  __syncthreads();
  const int total = s_pre[n_win];
  const long long row0 = cand_base[t];
  // rows at or past rows_cap are not stored (bits holds rows_cap rows);
  // the counts below stay exact
  const long long stored = rows_cap - row0;
  int4* rows = reinterpret_cast<int4*>(bits) + row0;
  int sum[WORDS] = {0, 0, 0, 0};
  int cur = 0;   // this thread's window cursor
  // warp-uniform rounds: every lane takes part in the transposes
  for (int k0 = warp * 32; k0 < total; k0 += TILE) {
    const int k = k0 + lane;
    unsigned word[WORDS] = {0u, 0u, 0u, 0u};
    if (k < total) {
      const int src = stream_record(s_start, s_pre, k, cur);
      const int bit = cand_bit(cs, recs_t[F_SET * (size_t)n_rec + src]);
      unsigned allowed[WORDS] = {0u, 0u, 0u, 0u};
      if (bit) {
        const int b = __ffs(bit) - 1;
#pragma unroll
        for (int w = 0; w < WORDS; ++w) allowed[w] = s_allowed[b][w];
      }
      if (allowed[0] | allowed[1] | allowed[2] | allowed[3]) {
        const float cx = __int_as_float(recs_t[src]);
        const float cy = __int_as_float(recs_t[(size_t)n_rec + src]);
        const float cz = __int_as_float(recs_t[2 * (size_t)n_rec + src]);
        float cr2 = 0.0f;
        if (SYMMETRIC) {
          const float r = __int_as_float(recs_t[F_R * (size_t)n_rec + src]);
          cr2 = __fmul_rn(r, r);
        }
        const int co = recs_t[F_ORIG * (size_t)n_rec + src];
        // one word per pass, its 32 tests unrolled; the word arrays are
        // indexed only by unrolled constants, so they stay in registers
#pragma unroll 1
        for (int w = 0; w < WORDS; ++w) {
          const float4* q = s_q + 32 * w;
          unsigned v = 0u;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float4 qi = q[i];
            const float d2 = d2_rn(cx, cy, cz, qi.x, qi.y, qi.z);
            bool hit = d2 <= qi.w;
            if (SYMMETRIC) hit = hit || d2 <= cr2;
            v |= hit ? (1u << i) : 0u;
          }
#pragma unroll
          for (int x = 0; x < WORDS; ++x)
            if (x == w) v &= allowed[x];
          for (unsigned m = v; m; m &= m - 1) {   // the hits only
            const int i = __ffs(m) - 1;
            if (s_qo[32 * w + i] == co) v &= ~(1u << i);
          }
#pragma unroll
          for (int x = 0; x < WORDS; ++x)
            if (x == w) word[x] = v;
        }
      }
      if (k < stored)
        rows[k] = make_int4((int)word[0], (int)word[1], (int)word[2],
                            (int)word[3]);
    }
#pragma unroll
    for (int w = 0; w < WORDS; ++w) sum[w] += __popc(transpose32(word[w], lane));
  }
#pragma unroll
  for (int w = 0; w < WORDS; ++w) s_sum[warp][32 * w + lane] = sum[w];
  __syncthreads();
  counts[slot] = s_sum[0][l] + s_sum[1][l] + s_sum[2][l] + s_sum[3][l];
}

// K5 -- replaces make_pairs_call(stage_from_bits=True)
// (treensearch_tpu/ops/pallas_pairs.py:500-514, body :897-913), the second
// pass of split staging: K4's hit bits into K2b's output blocks.  It
// computes what the JAX pass 2 computes (unpack the hits, read each
// candidate's orig and set, append to its block); the pack phases,
// compaction networks and MXU prefixes there exist because a TPU lane
// cannot append.  One block of 128 threads per tile, query lane l on
// thread l: each hit of lane l on a candidate of block b appends orig -
// offset[b] to the lane's own row of block b while its count is below
// k8[b], counting on past the cap.  The hits come in window order, K2's
// order, so an active pair's rows equal the fused kernel's slot for slot.
// Rows at or past n_bits_rows read as zero; a candidate whose set is no
// block's is dropped.  No distance arithmetic.
//
// Bound: memory: the bits (16 B per candidate row) and each candidate's
// orig and set read once, the counts and every block's rows (k8 x 128
// ints per tile, written whole) written.  The design this replaces
// (1.2159-1.2328 ms at config 1 on the H100) walked the windows one by
// one, at least n_win passes (9 at config 1, 25 at config 4) of mostly one
// partial 256-row chunk, with plain 4-byte loads and two barriers each and
// nothing in flight while it tested; every lane then made a shared load, a
// bit test and a divergent branch per candidate row (1.4e9 lane steps at
// config 1, 2.3% of them hits), and filled its rows' -1 tails with a loop
// of its own.  This design:
//   * reads the tile's clipped windows as one stream (tile_stream) cut into
//     CHUNK-row chunks that cross window edges, double-buffered as K2's:
//     chunk c + 1 is copied while chunk c drains, one barrier per chunk;
//   * copies a chunk's bit rows, one contiguous run from cand_base[t] whose
//     rows are 16-byte aligned, with one 16-byte cp.async per row (rows at
//     or past n_bits_rows and slots past the stream are zeroed), and
//     gathers each candidate's orig and set with 4-byte cp.async; after the
//     wait each thread turns its own candidates' sets into block indices
//     and origs into set-local indices, and clears the bit row of a
//     candidate in no block, so the drain checks nothing;
//   * drains each 32-row group per warp: lane i reads word w (its warp's)
//     of row j0 + i, transpose32 (K4's) hands lane l the word whose bit u
//     says that query 32 w + l hits row j0 + u, and the thread walks its
//     set bits lowest first: about one instruction per (lane, candidate)
//     where each lane loaded, tested and branched; a group that no lane of
//     the warp hits skips the transpose.  The reads conflict 4 ways on the
//     banks (4 wavefronts per group and warp); a word-major copy of the
//     rows, conflict-free but one more shared pass, was slower;
//   * stages each thread's first stage_e entries of every block (STAGED
//     entries a thread in all, 16 KB of dynamic shared memory a tile) and
//     writes them out at the end one 128-byte line per entry and warp, -1
//     past each count, then the tails past them with fill_tail; only a
//     count past stage_e stores straight to its row.  A hit stored straight
//     to its lane's row lands 512 bytes from its neighbour's and
//     half-writes a sector: with every hit stored so, K5 took 0.91 ms at
//     config 1 on the H100, 0.31 ms with 32 entries staged (16 to 80
//     measured: 32 and 40 were fastest), 0.23 ms with no hit stored;
//   * ONE_SET (one block, as config 1's split run()): the count stays in a
//     register; several blocks keep their counts, k8 and row bases in
//     shared memory, indexed by the hit's block directly, as K2b does;
//   * shared memory (about 29 KB a tile) holds it to 7 resident blocks per
//     SM; __launch_bounds__ asks for 12 (at most 40 registers, no spills),
//     and 8 or 16 measured the same.
// Dead tiles return at once (their rows are undefined).
template <bool ONE_SET>
__global__ void __launch_bounds__(TILE, 12)
pairs_nbrs_from_bits_kernel(const int* __restrict__ desc,
                            const int* __restrict__ recs_t, int n_rec,
                            int tiles_cap, int n_win,
                            const int4* __restrict__ bits,
                            long long n_bits_rows,
                            const long long* __restrict__ cand_base,
                            Blocks blk, int stage_e) {
  constexpr int WORDS = TILE / 32;   // bit words per candidate row
  __shared__ int4 s_bits[2][CHUNK];
  __shared__ int2 s_id[2][CHUNK];    // (orig, set), then (index, block)
  __shared__ int s_start[64];
  __shared__ int s_pre[65];
  __shared__ int* s_nbrs[MAX_BLOCKS];
  __shared__ int s_k8[MAX_BLOCKS];
  // several blocks' counts [n_blocks][TILE], then the staged entries
  // [n_blocks][stage_e][TILE]
  extern __shared__ int s_dyn[];

  const int t = blockIdx.x;
  const int l = threadIdx.x;
  const int lane = l & 31;
  const int warp = l >> 5;
  const int* d = desc + (size_t)t * DESC_W;
  const size_t n_slots = (size_t)tiles_cap * TILE;
  const size_t slot = (size_t)t * TILE + l;
  const int n_blocks = ONE_SET ? 1 : blk.n_blocks;
  if (d[FAT_COL] == 2) {  // dead tile: uniform across the block
    for (int b = 0; b < n_blocks; ++b) blk.counts[b * n_slots + slot] = 0;
    return;
  }
  int* const s_cnt = s_dyn;
  int* const s_rows = s_dyn + (ONE_SET ? 0 : n_blocks * TILE);
  tile_stream(d, n_rec, n_win, s_start, s_pre);
  if constexpr (!ONE_SET) {
#pragma unroll
    for (int b = 0; b < MAX_BLOCKS; ++b) {
      if (b == l && b < n_blocks) {
        s_nbrs[b] = blk.nbrs[b];
        s_k8[b] = blk.k8[b];
      }
    }
    for (int b = 0; b < n_blocks; ++b) s_cnt[b * TILE + l] = 0;
  }
  // ONE_SET: the thread's row, staged entries and count
  const int k8_1 = ONE_SET ? blk.k8[0] : 0;
  const int e_1 = min(k8_1, stage_e);
  int* const row = blk.nbrs[0] + (size_t)t * k8_1 * TILE + l;
  int count = 0;
  const long long base = cand_base[t];
  __syncthreads();
  const int total = s_pre[n_win];
  const int n_chunks = (total + CHUNK - 1) / CHUNK;
  int cur = 0;   // this thread's window cursor while staging

  // Chunk c into buffer buf: each thread copies the bit row and gathers
  // the orig and set of stream indices c * CHUNK + l + h * TILE.
  auto stage = [&](int c, int buf) {
#pragma unroll
    for (int h = 0; h < CHUNK / TILE; ++h) {
      const int j = h * TILE + l;
      const int k = c * CHUNK + j;
      const long long r = base + k;
      if (k < total && r >= 0 && r < n_bits_rows)
        cp_async16(&s_bits[buf][j], bits + r);
      else
        s_bits[buf][j] = make_int4(0, 0, 0, 0);
      if (k < total) {
        const size_t src = stream_record(s_start, s_pre, k, cur);
        cp_async4(&s_id[buf][j].x, recs_t + F_ORIG * (size_t)n_rec + src);
        cp_async4(&s_id[buf][j].y, recs_t + F_SET * (size_t)n_rec + src);
      }
    }
    cp_async_commit();
  };
  // After the wait, for this thread's own slots: (set-local index, block)
  // for a candidate of a block, a zero bit row for any other.
  auto finish = [&](int c, int buf) {
    cp_async_wait_all();
#pragma unroll
    for (int h = 0; h < CHUNK / TILE; ++h) {
      const int j = h * TILE + l;
      if (c * CHUNK + j < total) {
        const int2 id = s_id[buf][j];
        int bi = -1, off = 0;
#pragma unroll
        for (int b = 0; b < MAX_BLOCKS; ++b) {
          if (b < n_blocks && id.y == blk.set_of[b]) {
            bi = b;
            off = blk.offset[b];
          }
        }
        if (bi < 0)
          s_bits[buf][j] = make_int4(0, 0, 0, 0);
        else
          s_id[buf][j] = make_int2(id.x - off, bi);
      }
    }
  };
  // the hit work of this thread's query on row j of buffer buf: its entry
  // staged, or past the staged ones straight to the row
  auto append = [&](int buf, int j) {
    const int2 id = s_id[buf][j];
    if constexpr (ONE_SET) {
      if (count < e_1)
        s_rows[count * TILE + l] = id.x;
      else if (count < k8_1)
        row[(size_t)count * TILE] = id.x;
      ++count;
    } else {
      int* cnt = &s_cnt[id.y * TILE + l];
      const int n = *cnt;
      const int k8 = s_k8[id.y];
      if (n < min(k8, stage_e))
        s_rows[(id.y * stage_e + n) * TILE + l] = id.x;
      else if (n < k8)
        s_nbrs[id.y][((size_t)t * k8 + n) * TILE + l] = id.x;
      *cnt = n + 1;
    }
  };

  if (n_chunks > 0) {
    stage(0, 0);
    finish(0, 0);
  }
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) stage(c + 1, buf ^ 1);
    const int m = min(CHUNK, total - c * CHUNK);
    const unsigned* words = reinterpret_cast<const unsigned*>(s_bits[buf]);
    // warp-uniform groups: every lane takes part in the transpose
    for (int j0 = 0; j0 < m; j0 += WORD) {
      const unsigned x = words[(j0 + lane) * WORDS + warp];
      if (!__any_sync(FULL, x)) continue;
      for (unsigned hits = transpose32(x, lane); hits; hits &= hits - 1)
        append(buf, j0 + __ffs(hits) - 1);
    }
    if (c + 1 < n_chunks) finish(c + 1, buf ^ 1);
    __syncthreads();
  }
  if constexpr (ONE_SET) {
    blk.counts[slot] = count;
    flush_row(row, s_rows + l, count, k8_1, e_1);
  } else {
    for (int b = 0; b < n_blocks; ++b) {
      const int n = s_cnt[b * TILE + l];
      blk.counts[b * n_slots + slot] = n;
      flush_row(s_nbrs[b] + (size_t)t * s_k8[b] * TILE + l,
                s_rows + b * stage_e * TILE + l, n, s_k8[b],
                min(s_k8[b], stage_e));
    }
  }
}

}  // namespace

extern "C" int tns_expand_query_tiles(const int* desc, const int* recs_t,
                                      int n_rec, int tiles_cap,
                                      int sentinel_orig, int* q_t,
                                      void* stream) {
  const int n_slots = tiles_cap * TILE;
  if (n_slots > 0) {
    const int threads = 256;
    const int blocks = (n_slots + threads - 1) / threads;
    expand_query_tiles_kernel<<<blocks, threads, 0,
                                (cudaStream_t)stream>>>(
        desc, recs_t, n_rec, n_slots, sentinel_orig, q_t);
  }
  return (int)cudaGetLastError();
}

extern "C" int tns_expand_records(const int* desc, const int* recs_t,
                                  int n_rec, int tiles_cap, int slack,
                                  int sentinel_orig, int* q_t, int* rec_pad,
                                  void* stream) {
  const int n_slots = tiles_cap * TILE;
  const int n_total = n_slots + slack;
  if (n_total > 0) {
    const int threads = 256;
    const int blocks = (n_total + threads - 1) / threads;
    expand_records_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        desc, recs_t, n_rec, n_slots, n_total, sentinel_orig, q_t,
        reinterpret_cast<int4*>(rec_pad));
  }
  return (int)cudaGetLastError();
}

extern "C" int tns_pairs_nbrs_fixed(const int* desc, const int* q_t,
                                    const int* recs_t, int n_rec,
                                    int tiles_cap, int n_win, int k8,
                                    float r2, int* counts, int* nbrs,
                                    unsigned long long* tested,
                                    void* stream) {
  if (n_win < 1 || n_win > MAX_WIN || k8 < 1)
    return (int)cudaErrorInvalidValue;
  Blocks blk{};
  blk.n_blocks = 1;
  blk.k8[0] = k8;
  blk.stage[0] = k8 < K2_STAGED ? k8 : K2_STAGED;
  blk.nbrs[0] = nbrs;
  blk.counts = counts;
  if (tiles_cap > 0) {
    const size_t smem = (size_t)blk.stage[0] * TILE * sizeof(int);
    pairs_nbrs_kernel<false, false, true>
        <<<tiles_cap, TILE, smem, (cudaStream_t)stream>>>(
            desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, blk, tested);
  }
  return (int)cudaGetLastError();
}

extern "C" int tns_pairs_nbrs(const int* desc, const int* q_t,
                              const int* recs_t, int n_rec, int tiles_cap,
                              int n_win, float r2, int variable,
                              int symmetric, int n_blocks, const int* set_of,
                              const int* offset, const int* k8,
                              int* const* nbrs, int* counts,
                              unsigned long long* tested, void* stream) {
  if (n_blocks < 1 || n_blocks > MAX_BLOCKS || (symmetric && !variable) ||
      n_win < 1 || n_win > MAX_WIN)
    return (int)cudaErrorInvalidValue;
  Blocks blk{};
  blk.n_blocks = n_blocks;
  long long k8_sum = 0;
  for (int b = 0; b < n_blocks; ++b) {
    blk.set_of[b] = set_of[b];
    blk.offset[b] = offset[b];
    blk.k8[b] = k8[b];
    blk.nbrs[b] = nbrs[b];
    if (k8[b] < 1) return (int)cudaErrorInvalidValue;
    k8_sum += k8[b];
  }
  // the staged entries split over the blocks in proportion to their k8
  int staged = 0;
  for (int b = 0; b < n_blocks; ++b) {
    const int e = (int)(K2_STAGED * (long long)k8[b] / k8_sum);
    blk.stage[b] = e < k8[b] ? e : k8[b];
    staged += blk.stage[b];
  }
  blk.counts = counts;
  if (tiles_cap > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    // the counts, then the staged entries
    const size_t smem = (size_t)(n_blocks + staged) * TILE * sizeof(int);
    if (!variable)
      pairs_nbrs_kernel<false, false, false><<<tiles_cap, TILE, smem, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, blk, tested);
    else if (!symmetric)
      pairs_nbrs_kernel<true, false, false><<<tiles_cap, TILE, smem, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, blk, tested);
    else
      pairs_nbrs_kernel<true, true, false><<<tiles_cap, TILE, smem, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, blk, tested);
  }
  return (int)cudaGetLastError();
}

extern "C" int tns_pairs_mask(const int* desc, const int* q_t,
                              const int* recs_t, int n_rec, int tiles_cap,
                              int n_win, float r2, int variable,
                              int symmetric, int n_blocks, const int* set_of,
                              const int* allow, int n_allow,
                              const long long* cand_base,
                              long long rows_cap, int* counts, int* bits,
                              void* stream) {
  if (n_blocks < 0 || n_blocks > MAX_BLOCKS || (symmetric && !variable) ||
      n_win < 1 || n_win > MAX_WIN)
    return (int)cudaErrorInvalidValue;
  CandSets cs{};
  cs.n_blocks = n_blocks;
  for (int b = 0; b < n_blocks; ++b) cs.set_of[b] = set_of[b];
  if (tiles_cap > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (!variable)
      pairs_mask_kernel<false, false><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, cs, allow,
          n_allow, cand_base, rows_cap, counts, bits);
    else if (!symmetric)
      pairs_mask_kernel<true, false><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, cs, allow,
          n_allow, cand_base, rows_cap, counts, bits);
    else
      pairs_mask_kernel<true, true><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, cs, allow,
          n_allow, cand_base, rows_cap, counts, bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int tns_pairs_nbrs_from_bits(const int* desc, const int* recs_t,
                                        int n_rec, int tiles_cap, int n_win,
                                        const int* bits, long long n_bits_rows,
                                        const long long* cand_base,
                                        int n_blocks, const int* set_of,
                                        const int* offset, const int* k8,
                                        int* const* nbrs, int* counts,
                                        void* stream) {
  // bits: rows of 16 bytes, copied whole; the stream's tables hold 64
  // windows
  if (n_blocks < 1 || n_blocks > MAX_BLOCKS || n_win < 1 || n_win > MAX_WIN ||
      reinterpret_cast<uintptr_t>(bits) % sizeof(int4) != 0)
    return (int)cudaErrorInvalidValue;
  Blocks blk{};
  blk.n_blocks = n_blocks;
  for (int b = 0; b < n_blocks; ++b) {
    blk.set_of[b] = set_of[b];
    blk.offset[b] = offset[b];
    blk.k8[b] = k8[b];
    blk.nbrs[b] = nbrs[b];
  }
  blk.counts = counts;
  if (tiles_cap > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int4* rows = reinterpret_cast<const int4*>(bits);
    // the staged entries split evenly over the blocks; several blocks
    // also keep their counts there
    const int stage_e = STAGED / n_blocks;
    const size_t smem = (size_t)(n_blocks > 1 ? n_blocks : 0) * TILE *
                            sizeof(int) +
                        (size_t)n_blocks * stage_e * TILE * sizeof(int);
    auto kernel = n_blocks == 1 ? pairs_nbrs_from_bits_kernel<true>
                                : pairs_nbrs_from_bits_kernel<false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<tiles_cap, TILE, smem, st>>>(desc, recs_t, n_rec, tiles_cap,
                                          n_win, rows, n_bits_rows,
                                          cand_base, blk, stage_e);
  }
  return (int)cudaGetLastError();
}
