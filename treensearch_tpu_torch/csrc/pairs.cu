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

// K2a -- replaces make_pairs_call in neighbor-list mode, fixed radius, one
// candidate set (treensearch_tpu/ops/pallas_pairs.py:445), narrow and fat
// tier alike.  One block of 128 threads per query tile, one query per
// thread.  The tile's n_win windows are streamed in order through shared
// memory, CHUNK candidates (x, y, z, orig: 4 KB) at a time, so a window of
// any width fits and there is no narrow/fat routing.  Each thread tests
// its query against the chunk, appends each survivor's orig to its own
// row while its count is below k8, and keeps counting past the cap.
// Bound: the distance tests (128 x ~1.2k per tile at 1M points),
// then the scattered 4-byte row writes.  The TPU kernel's compaction
// networks and MXU prefix sums existed because a TPU core cannot append
// per lane; here each thread appends to its own row directly.
// Self-exclusion by orig in every window is exact: windows of distinct
// stencil offsets are disjoint and a point has one sorted slot.
__global__ void __launch_bounds__(TILE)
pairs_nbrs_fixed_kernel(const int* __restrict__ desc,
                        const int* __restrict__ q_t,
                        const int* __restrict__ recs_t, int n_rec,
                        int tiles_cap, int n_win, int k8, float r2,
                        int* __restrict__ counts, int* __restrict__ nbrs) {
  __shared__ float sx[CHUNK];
  __shared__ float sy[CHUNK];
  __shared__ float sz[CHUNK];
  __shared__ int so[CHUNK];

  const int t = blockIdx.x;
  const int l = threadIdx.x;
  const int* d = desc + (size_t)t * DESC_W;
  const size_t n_slots = (size_t)tiles_cap * TILE;
  const size_t slot = (size_t)t * TILE + l;
  if (d[FAT_COL] == 2) {  // dead tile: uniform across the block
    counts[slot] = 0;
    return;
  }
  const float qx = __int_as_float(q_t[slot]);
  const float qy = __int_as_float(q_t[n_slots + slot]);
  const float qz = __int_as_float(q_t[2 * n_slots + slot]);
  const int qo = q_t[F_ORIG * n_slots + slot];
  int* out = nbrs + (size_t)t * k8 * TILE + l;
  const int* rx = recs_t;
  const int* ry = recs_t + (size_t)n_rec;
  const int* rz = recs_t + 2 * (size_t)n_rec;
  const int* ro = recs_t + F_ORIG * (size_t)n_rec;

  int cnt = 0;
  for (int w = 0; w < n_win; ++w) {
    const int s = d[w];
    const int ln = (s < 0 || s > n_rec) ? 0 : min(d[LENS_OFF + w], n_rec - s);
    for (int c0 = 0; c0 < ln; c0 += CHUNK) {
      const int m = min(CHUNK, ln - c0);
      for (int j = l; j < m; j += TILE) {
        const size_t src = (size_t)s + c0 + j;
        sx[j] = __int_as_float(rx[src]);
        sy[j] = __int_as_float(ry[src]);
        sz[j] = __int_as_float(rz[src]);
        so[j] = ro[src];
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float dx = __fsub_rn(sx[j], qx);
        const float dy = __fsub_rn(sy[j], qy);
        const float dz = __fsub_rn(sz[j], qz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        const int o = so[j];
        if (d2 <= r2 && o != qo) {
          if (cnt < k8) out[(size_t)cnt * TILE] = o;
          ++cnt;
        }
      }
      __syncthreads();
    }
  }
  counts[slot] = cnt;
  for (int k = cnt; k < k8; ++k) out[(size_t)k * TILE] = -1;
}

// The output blocks of K2b/K2c, passed by value: block b collects the
// survivors whose set id is set_of[b], as set-local indices orig -
// offset[b], in rows of k8[b] (tiles_cap, k8[b], 128); its counts are row
// b of counts (n_blocks, tiles_cap * 128).
constexpr int MAX_BLOCKS = 8;
struct Blocks {
  int n_blocks;
  int set_of[MAX_BLOCKS];
  int offset[MAX_BLOCKS];
  int k8[MAX_BLOCKS];
  int* nbrs[MAX_BLOCKS];
  int* counts;
};

// K2b and K2c -- replace make_pairs_call with multi_set (one output block
// per distinct candidate set, cand_sets/cand_offsets/nbr_caps) and with
// variable/symmetric radii (treensearch_tpu/ops/pallas_pairs.py:445; the
// criterion :950-957, the per-block compaction :1154-1310).  K2a's
// schedule: one block of 128 threads per query tile, windows streamed in
// CHUNK-candidate passes through shared memory, one query per thread.
// Each staged candidate also carries its block index (-1 for a set that
// is no candidate set), found once at staging, and in symmetric mode its
// squared radius.  A survivor goes to its block's row while that block's
// count is below its k8; counting goes on past the cap.  The per-block
// counts stay in registers: the unrolled compare against each block index
// keeps every array index a constant.
//   VARIABLE:  d^2 <= r_i^2, r_i the query's F_R, squared in float32;
//              else d^2 <= r2 (K2b's fixed radius).
//   SYMMETRIC: also d^2 <= r_j^2 (variable only).
// The sentinel query (NaN coordinates, r = 0) fails every compare.
// Bound: the distance tests, as K2a; the block lookup is paid per staged
// candidate, not per test.
template <bool VARIABLE, bool SYMMETRIC>
__global__ void __launch_bounds__(TILE)
pairs_nbrs_kernel(const int* __restrict__ desc, const int* __restrict__ q_t,
                  const int* __restrict__ recs_t, int n_rec, int tiles_cap,
                  int n_win, float r2, Blocks blk) {
  __shared__ float sx[CHUNK];
  __shared__ float sy[CHUNK];
  __shared__ float sz[CHUNK];
  __shared__ float sr2[SYMMETRIC ? CHUNK : 1];
  __shared__ int so[CHUNK];
  __shared__ int sb[CHUNK];

  const int t = blockIdx.x;
  const int l = threadIdx.x;
  const int* d = desc + (size_t)t * DESC_W;
  const size_t n_slots = (size_t)tiles_cap * TILE;
  const size_t slot = (size_t)t * TILE + l;
  if (d[FAT_COL] == 2) {  // dead tile: uniform across the block
    for (int b = 0; b < blk.n_blocks; ++b) blk.counts[b * n_slots + slot] = 0;
    return;
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
  const int* rx = recs_t;
  const int* ry = recs_t + (size_t)n_rec;
  const int* rz = recs_t + 2 * (size_t)n_rec;
  const int* rr = recs_t + F_R * (size_t)n_rec;
  const int* ro = recs_t + F_ORIG * (size_t)n_rec;
  const int* rs = recs_t + F_SET * (size_t)n_rec;

  int cnt[MAX_BLOCKS];
#pragma unroll
  for (int b = 0; b < MAX_BLOCKS; ++b) cnt[b] = 0;
  for (int w = 0; w < n_win; ++w) {
    const int s = d[w];
    const int ln = (s < 0 || s > n_rec) ? 0 : min(d[LENS_OFF + w], n_rec - s);
    for (int c0 = 0; c0 < ln; c0 += CHUNK) {
      const int m = min(CHUNK, ln - c0);
      for (int j = l; j < m; j += TILE) {
        const size_t src = (size_t)s + c0 + j;
        sx[j] = __int_as_float(rx[src]);
        sy[j] = __int_as_float(ry[src]);
        sz[j] = __int_as_float(rz[src]);
        so[j] = ro[src];
        if (SYMMETRIC) {
          const float r = __int_as_float(rr[src]);
          sr2[j] = __fmul_rn(r, r);
        }
        const int set = rs[src];
        int bi = -1;
#pragma unroll
        for (int b = 0; b < MAX_BLOCKS; ++b)
          if (b < blk.n_blocks && set == blk.set_of[b]) bi = b;
        sb[j] = bi;
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float dx = __fsub_rn(sx[j], qx);
        const float dy = __fsub_rn(sy[j], qy);
        const float dz = __fsub_rn(sz[j], qz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        bool hit = d2 <= qr2;
        if (SYMMETRIC) hit = hit || d2 <= sr2[j];
        const int o = so[j];
        const int bi = sb[j];
        if (hit && o != qo && bi >= 0) {
#pragma unroll
          for (int b = 0; b < MAX_BLOCKS; ++b) {
            if (b == bi) {
              if (cnt[b] < blk.k8[b])
                blk.nbrs[b][((size_t)t * blk.k8[b] + cnt[b]) * TILE + l] =
                    o - blk.offset[b];
              ++cnt[b];
            }
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int b = 0; b < MAX_BLOCKS; ++b) {
    if (b < blk.n_blocks) {
      blk.counts[b * n_slots + slot] = cnt[b];
      int* out = blk.nbrs[b] + (size_t)t * blk.k8[b] * TILE + l;
      for (int k = cnt[b]; k < blk.k8[b]; ++k) out[(size_t)k * TILE] = -1;
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

// K4 -- replaces make_pairs_call(mask_mode=True)
// (treensearch_tpu/ops/pallas_pairs.py:779-859).  K2's schedule and
// criteria (one block of 128 threads per tile, windows streamed through
// shared memory in CHUNK-candidate passes), plus the active matrix: the
// query's allow word is read once, each staged candidate carries its
// candidate-set bit.  Instead of compacting hits, every warp takes
// __ballot_sync of its 32 lanes' hits on each staged candidate, so the
// tile's 4 warps give one row of 4 words per candidate; a chunk's rows
// gather in shared memory and are stored coalesced after it, at row
// cand_base[t] + (the candidate's index in the tile's window order).
// Counts are K2's.  Every lane of a live tile walks the same chunk loop
// (its bounds come from the tile's descriptor), so each ballot sees all
// 32 lanes; the sentinel lanes of a partial tile vote 0.  Dead tiles
// return as a whole block and own no rows.
// Bound: the distance tests, as K2; the bits are 16 B per candidate row
// (about 175 MB at 1M points), under a tenth of the tests' time at HBM
// rate.
template <bool VARIABLE, bool SYMMETRIC>
__global__ void __launch_bounds__(TILE)
pairs_mask_kernel(const int* __restrict__ desc, const int* __restrict__ q_t,
                  const int* __restrict__ recs_t, int n_rec, int tiles_cap,
                  int n_win, float r2, CandSets cs,
                  const int* __restrict__ allow, int n_allow,
                  const long long* __restrict__ cand_base,
                  int* __restrict__ counts, int* __restrict__ bits) {
  __shared__ float sx[CHUNK];
  __shared__ float sy[CHUNK];
  __shared__ float sz[CHUNK];
  __shared__ float sr2[SYMMETRIC ? CHUNK : 1];
  __shared__ int so[CHUNK];
  __shared__ int sbit[CHUNK];
  __shared__ unsigned sw[CHUNK * (TILE / 32)];

  const int t = blockIdx.x;
  const int l = threadIdx.x;
  const int* d = desc + (size_t)t * DESC_W;
  const size_t n_slots = (size_t)tiles_cap * TILE;
  const size_t slot = (size_t)t * TILE + l;
  if (d[FAT_COL] == 2) {  // dead tile: uniform across the block
    counts[slot] = 0;
    return;
  }
  const float qx = __int_as_float(q_t[slot]);
  const float qy = __int_as_float(q_t[n_slots + slot]);
  const float qz = __int_as_float(q_t[2 * n_slots + slot]);
  const int qo = q_t[F_ORIG * n_slots + slot];
  const int qs = q_t[F_SET * n_slots + slot];
  const int allow_q = (qs >= 0 && qs < n_allow) ? allow[qs] : 0;
  float qr2 = r2;
  if (VARIABLE) {
    const float qr = __int_as_float(q_t[F_R * n_slots + slot]);
    qr2 = __fmul_rn(qr, qr);
  }
  const int* rx = recs_t;
  const int* ry = recs_t + (size_t)n_rec;
  const int* rz = recs_t + 2 * (size_t)n_rec;
  const int* rr = recs_t + F_R * (size_t)n_rec;
  const int* ro = recs_t + F_ORIG * (size_t)n_rec;
  const int* rs = recs_t + F_SET * (size_t)n_rec;

  long long row = cand_base[t];
  int cnt = 0;
  for (int w = 0; w < n_win; ++w) {
    const int s = d[w];
    const int ln = (s < 0 || s > n_rec) ? 0 : min(d[LENS_OFF + w], n_rec - s);
    for (int c0 = 0; c0 < ln; c0 += CHUNK) {
      const int m = min(CHUNK, ln - c0);
      for (int j = l; j < m; j += TILE) {
        const size_t src = (size_t)s + c0 + j;
        sx[j] = __int_as_float(rx[src]);
        sy[j] = __int_as_float(ry[src]);
        sz[j] = __int_as_float(rz[src]);
        so[j] = ro[src];
        sbit[j] = cand_bit(cs, rs[src]);
        if (SYMMETRIC) {
          const float r = __int_as_float(rr[src]);
          sr2[j] = __fmul_rn(r, r);
        }
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float dx = __fsub_rn(sx[j], qx);
        const float dy = __fsub_rn(sy[j], qy);
        const float dz = __fsub_rn(sz[j], qz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        bool hit = d2 <= qr2;
        if (SYMMETRIC) hit = hit || d2 <= sr2[j];
        hit = hit && so[j] != qo && (allow_q & sbit[j]) != 0;
        const unsigned vote = __ballot_sync(0xffffffffu, hit);
        if ((l & 31) == 0) sw[j * (TILE / 32) + (l >> 5)] = vote;
        cnt += hit;
      }
      __syncthreads();
      int* dst = bits + row * (TILE / 32);
      for (int k = l; k < m * (TILE / 32); k += TILE) dst[k] = (int)sw[k];
      row += m;
    }
  }
  counts[slot] = cnt;
}

// K5 -- replaces make_pairs_call(stage_from_bits=True)
// (treensearch_tpu/ops/pallas_pairs.py:500-514, body :897-913), the second
// pass of split staging: K4's hit bits into K2b's output blocks.  It
// computes what the JAX pass 2 computes (unpack the hits, read each
// candidate's orig and set, append to its block); the pack phases,
// compaction networks and MXU prefixes there exist because a TPU lane
// cannot append.  K2's schedule: one block of 128 threads per tile, one
// query lane per thread, the tile's clipped windows walked in order in
// CHUNK-row passes.  Each pass stages coalesced the rows' 4 bit words
// (contiguous from cand_base[t] + k) and each candidate's orig and block
// index (its set looked up once); each thread tests bit l % 32 of word
// l / 32 and appends orig - offset[b] to its own row of block b while
// that block's count is below its k8, counting on past the cap.  The
// rows come out in window order, K2's order, so an active pair's rows
// equal the fused kernel's slot for slot.  No distance arithmetic.  Rows
// at or past n_bits_rows read as zero.  Dead tiles return at once.
// Bound: memory, the bits (16 B per candidate row) and the candidates'
// orig and set read once, the rows written.
__global__ void __launch_bounds__(TILE)
pairs_nbrs_from_bits_kernel(const int* __restrict__ desc,
                            const int* __restrict__ recs_t, int n_rec,
                            int tiles_cap, int n_win,
                            const int* __restrict__ bits,
                            long long n_bits_rows,
                            const long long* __restrict__ cand_base,
                            Blocks blk) {
  __shared__ unsigned sw[CHUNK * (TILE / 32)];
  __shared__ int so[CHUNK];
  __shared__ int sb[CHUNK];

  const int t = blockIdx.x;
  const int l = threadIdx.x;
  const int* d = desc + (size_t)t * DESC_W;
  const size_t n_slots = (size_t)tiles_cap * TILE;
  const size_t slot = (size_t)t * TILE + l;
  if (d[FAT_COL] == 2) {  // dead tile: uniform across the block
    for (int b = 0; b < blk.n_blocks; ++b) blk.counts[b * n_slots + slot] = 0;
    return;
  }
  const int* ro = recs_t + F_ORIG * (size_t)n_rec;
  const int* rs = recs_t + F_SET * (size_t)n_rec;
  const int word = l >> 5;
  const unsigned lane_bit = 1u << (l & 31);
  const long long n_words = n_bits_rows * (TILE / 32);

  int cnt[MAX_BLOCKS];
#pragma unroll
  for (int b = 0; b < MAX_BLOCKS; ++b) cnt[b] = 0;
  long long row = cand_base[t];
  for (int w = 0; w < n_win; ++w) {
    const int s = d[w];
    const int ln = (s < 0 || s > n_rec) ? 0 : min(d[LENS_OFF + w], n_rec - s);
    for (int c0 = 0; c0 < ln; c0 += CHUNK) {
      const int m = min(CHUNK, ln - c0);
      const long long w0 = row * (TILE / 32);
      for (int k = l; k < m * (TILE / 32); k += TILE)
        sw[k] = (w0 + k < n_words) ? (unsigned)bits[w0 + k] : 0u;
      for (int j = l; j < m; j += TILE) {
        const size_t src = (size_t)s + c0 + j;
        so[j] = ro[src];
        const int set = rs[src];
        int bi = -1;
#pragma unroll
        for (int b = 0; b < MAX_BLOCKS; ++b)
          if (b < blk.n_blocks && set == blk.set_of[b]) bi = b;
        sb[j] = bi;
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const int bi = sb[j];
        if ((sw[j * (TILE / 32) + word] & lane_bit) && bi >= 0) {
          const int o = so[j];
#pragma unroll
          for (int b = 0; b < MAX_BLOCKS; ++b) {
            if (b == bi) {
              if (cnt[b] < blk.k8[b])
                blk.nbrs[b][((size_t)t * blk.k8[b] + cnt[b]) * TILE + l] =
                    o - blk.offset[b];
              ++cnt[b];
            }
          }
        }
      }
      __syncthreads();
      row += m;
    }
  }
#pragma unroll
  for (int b = 0; b < MAX_BLOCKS; ++b) {
    if (b < blk.n_blocks) {
      blk.counts[b * n_slots + slot] = cnt[b];
      int* out = blk.nbrs[b] + (size_t)t * blk.k8[b] * TILE + l;
      for (int k = cnt[b]; k < blk.k8[b]; ++k) out[(size_t)k * TILE] = -1;
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
                                    void* stream) {
  if (tiles_cap > 0) {
    pairs_nbrs_fixed_kernel<<<tiles_cap, TILE, 0, (cudaStream_t)stream>>>(
        desc, q_t, recs_t, n_rec, tiles_cap, n_win, k8, r2, counts, nbrs);
  }
  return (int)cudaGetLastError();
}

extern "C" int tns_pairs_nbrs(const int* desc, const int* q_t,
                              const int* recs_t, int n_rec, int tiles_cap,
                              int n_win, float r2, int variable,
                              int symmetric, int n_blocks, const int* set_of,
                              const int* offset, const int* k8,
                              int* const* nbrs, int* counts, void* stream) {
  if (n_blocks < 1 || n_blocks > MAX_BLOCKS || (symmetric && !variable))
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
    if (!variable)
      pairs_nbrs_kernel<false, false><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, blk);
    else if (!symmetric)
      pairs_nbrs_kernel<true, false><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, blk);
    else
      pairs_nbrs_kernel<true, true><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, blk);
  }
  return (int)cudaGetLastError();
}

extern "C" int tns_pairs_mask(const int* desc, const int* q_t,
                              const int* recs_t, int n_rec, int tiles_cap,
                              int n_win, float r2, int variable,
                              int symmetric, int n_blocks, const int* set_of,
                              const int* allow, int n_allow,
                              const long long* cand_base, int* counts,
                              int* bits, void* stream) {
  if (n_blocks < 0 || n_blocks > MAX_BLOCKS || (symmetric && !variable))
    return (int)cudaErrorInvalidValue;
  CandSets cs{};
  cs.n_blocks = n_blocks;
  for (int b = 0; b < n_blocks; ++b) cs.set_of[b] = set_of[b];
  if (tiles_cap > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (!variable)
      pairs_mask_kernel<false, false><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, cs, allow,
          n_allow, cand_base, counts, bits);
    else if (!symmetric)
      pairs_mask_kernel<true, false><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, cs, allow,
          n_allow, cand_base, counts, bits);
    else
      pairs_mask_kernel<true, true><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, cs, allow,
          n_allow, cand_base, counts, bits);
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
  if (n_blocks < 1 || n_blocks > MAX_BLOCKS)
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
    pairs_nbrs_from_bits_kernel<<<tiles_cap, TILE, 0,
                                  (cudaStream_t)stream>>>(
        desc, recs_t, n_rec, tiles_cap, n_win, bits, n_bits_rows, cand_base,
        blk);
  }
  return (int)cudaGetLastError();
}
