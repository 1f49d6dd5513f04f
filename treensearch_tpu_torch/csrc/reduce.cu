// K3 -- the fused neighbor-reduce, for Hopper (sm_90a).  Replaces
// make_pairs_call(reduce_fn=...) (treensearch_tpu/ops/pallas_pairs.py:
// 671-777; the active-matrix gate :736-752).
//
// A template: treensearch_tpu_torch/ops/reduce.py replaces the generated
// section below with the user's traced per-pair callback (N_OUT, the radius
// mode, the env fields it reads, and pair_fn), writes the result into
// build/ and compiles it with the flags of csrc/pairs.cu (no fast-math, no
// -ftz: the NaN padding must fail every compare, and the traced arithmetic
// uses the _rn intrinsics so each pair's value rounds as eager PyTorch
// rounds it).  As committed the section counts neighbors, so the file also
// builds alone.  Plain C launcher, loaded with ctypes; it returns
// cudaGetLastError().
//
// Layouts as in csrc/pairs.cu (desc, recs_t and q_t int32, field-major
// records x, y, z, r, orig, set, p0, p1); out is (N_OUT, tiles_cap * 128)
// float32, zero for the slots of dead tiles.

#include <cuda_runtime.h>
#include <math.h>

// torch.minimum / torch.maximum: a NaN operand gives NaN (fminf would not)
__device__ __forceinline__ float tns_fmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float tns_fmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

namespace {

// the layout constants of csrc/pairs.cu
constexpr int TILE = 128;
constexpr int DESC_W = 128;
constexpr int LENS_OFF = 64;
constexpr int FAT_COL = 127;
constexpr int F_R = 3;
constexpr int F_ORIG = 4;
constexpr int F_SET = 5;
constexpr int F_P0 = 6;
constexpr int F_P1 = 7;
constexpr int CHUNK = 256;       // candidates staged per pass
constexpr int WORD = 32;         // tests per hit word; chunks pad to it
constexpr int MAX_BLOCKS = 8;    // candidate sets
constexpr int MAX_WIN = 49;      // windows (LENS_OFF = 64)
constexpr int SENTINEL_BITS = 0x7FC00000;  // quiet NaN
constexpr unsigned FULL = 0xffffffffu;

// ---- generated section (ops/reduce.py) ----
constexpr int N_OUT = 1;
constexpr bool VARIABLE = false;
constexpr bool USE_SET_J = false;
constexpr bool USE_P0_J = false;
constexpr bool USE_P1_J = false;
constexpr bool USE_R_J = false;
__device__ __forceinline__ void pair_fn(
    float dx, float dy, float dz, float d2, float r2_i, int orig_i,
    int orig_j, int set_i, int set_j, float p0_i, float p1_i, float p0_j,
    float p1_j, float r_j, float (&v)[N_OUT]) {
  v[0] = 1.0f;
}
// ---- end of generated section ----

// The candidate sets, passed by value: a candidate whose set is set_of[b]
// carries bit b, and a query of set s takes it when bit b of allow[s] is
// set (as K4 in csrc/pairs.cu).
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

// ---------------------------------------------------------------------------
// The candidate stream of a tile, as in csrc/pairs.cu (kept here as a copy:
// ops/pairs.py::build_library keys a build by the text it compiles, so an
// #include of a shared header would leave a stale cached build behind when
// the header changed).  The tile's n_win clipped windows are read as one
// stream in window order: stream index k lies in window w when pre[w] <= k <
// pre[w + 1] and is record start[w] + k - pre[w].
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

// One 4-byte asynchronous copy global -> shared (cp.async; window starts
// are not 16-byte aligned, so no TMA), with its commit and wait.
__device__ __forceinline__ void cp_async4(void* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// K2's stream schedule (csrc/pairs.cu): one block of 128 threads per query
// tile, one query per thread, the tile's clipped windows read as one stream
// (tile_stream) in full CHUNK-candidate chunks that cross window edges,
// chunk c + 1 copied with cp.async while chunk c is tested, one barrier per
// chunk, the last chunk padded with NaN candidates.  Staged per candidate:
// a float4 (x, y, z, r_j^2 when symmetric), the only thing the tests read;
// an int4 (orig, candidate-set bit, set when USE_SET_J, r_j when USE_R_J);
// and a float2 of the payload when pair_fn reads it.  After the wait each
// thread squares its own slots' r_j and turns their set into its bit.
// Each thread tests WORD candidates at a time, unrolled, setting bit u of a
// word for each hit (K2's criterion), then walks the word's set bits in
// increasing order: for each, self-exclusion and the query set's allow
// word, then pair_fn on the env (the displacement and d^2 recomputed from
// the float4, bit for bit as tested) and its N_OUT values added to float
// accumulators in registers.  So the callback, the payload loads and the
// adds run only for the hits: a warp pays for them as often as its busiest
// lane hits in the word, not in every step where some lane hits.  Each
// query's terms are added in window order, as before, so the sums do not
// depend on this schedule.  Nothing is compacted; each slot's N_OUT sums
// are written once.  The env is JAX's: dx dy dz the displacement candidate
// minus query, d2, r2_i = the query's F_R squared (0 at a fixed radius, as
// in JAX), orig, set and payload of both, r_j in variable mode.
// Bound: the distance tests (9 float operations each) plus pair_fn's
// operations and N_OUT adds per hit; the bytes (the records once, the
// query tiles, N_OUT floats per slot) take a tenth of that at 1M points.
// The design this replaces (1.0104 ms for the density at config 1 on the
// H100) staged each window on its own into up to ten shared arrays and ran
// the callback inside the test loop, where a warp paid for it whenever one
// of its lanes hit.  __launch_bounds__ asks for 8 resident blocks per SM
// (at most 64 registers): the callbacks chip_smoke.py builds take 48-53
// registers without spills, where 10 or 12 blocks (48 or 40 registers)
// make most of them spill (chip_variants.py).
template <bool SYMMETRIC>
__global__ void __launch_bounds__(TILE, 8)
pairs_reduce_kernel(const int* __restrict__ desc, const int* __restrict__ q_t,
                    const int* __restrict__ recs_t, int n_rec, int tiles_cap,
                    int n_win, float r2, CandSets cs,
                    const int* __restrict__ allow, int n_allow,
                    float* __restrict__ out) {
  constexpr bool USE_PAY = USE_P0_J || USE_P1_J;
  constexpr bool STAGE_R = SYMMETRIC || USE_R_J;
  __shared__ float4 s_geo[2][CHUNK];
  __shared__ int4 s_id[2][CHUNK];
  __shared__ float2 s_pay[2][USE_PAY ? CHUNK : 1];
  __shared__ int s_start[64];
  __shared__ int s_pre[65];

  const int t = blockIdx.x;
  const int l = threadIdx.x;
  const int* d = desc + (size_t)t * DESC_W;
  const size_t n_slots = (size_t)tiles_cap * TILE;
  const size_t slot = (size_t)t * TILE + l;
  if (d[FAT_COL] == 2) {  // dead tile: uniform across the block
#pragma unroll
    for (int k = 0; k < N_OUT; ++k) out[k * n_slots + slot] = 0.0f;
    return;
  }
  tile_stream(d, n_rec, n_win, s_start, s_pre);
  const float qx = __int_as_float(q_t[slot]);
  const float qy = __int_as_float(q_t[n_slots + slot]);
  const float qz = __int_as_float(q_t[2 * n_slots + slot]);
  const float qr = __int_as_float(q_t[F_R * n_slots + slot]);
  const int qo = q_t[F_ORIG * n_slots + slot];
  const int qs = q_t[F_SET * n_slots + slot];
  const float qp0 = __int_as_float(q_t[F_P0 * n_slots + slot]);
  const float qp1 = __int_as_float(q_t[F_P1 * n_slots + slot]);
  const float r2_i = __fmul_rn(qr, qr);
  const float qr2 = VARIABLE ? r2_i : r2;
  const int allow_q = (qs >= 0 && qs < n_allow) ? allow[qs] : 0;
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
        if (STAGE_R)
          cp_async4(&s_geo[buf][j].w, recs_t + F_R * (size_t)n_rec + src);
        cp_async4(&s_id[buf][j].x, recs_t + F_ORIG * (size_t)n_rec + src);
        cp_async4(&s_id[buf][j].y, recs_t + F_SET * (size_t)n_rec + src);
        if (USE_P0_J)
          cp_async4(&s_pay[buf][j].x, recs_t + F_P0 * (size_t)n_rec + src);
        if (USE_P1_J)
          cp_async4(&s_pay[buf][j].y, recs_t + F_P1 * (size_t)n_rec + src);
      } else {
        s_geo[buf][j] = make_float4(__int_as_float(SENTINEL_BITS),
                                    __int_as_float(SENTINEL_BITS),
                                    __int_as_float(SENTINEL_BITS), 0.0f);
      }
    }
    cp_async_commit();
  };
  // After the wait, for this thread's own slots: r_j aside and squared,
  // the set aside and turned into its candidate-set bit.
  auto finish = [&](int c, int buf) {
    cp_async_wait_all();
#pragma unroll
    for (int h = 0; h < CHUNK / TILE; ++h) {
      const int j = h * TILE + l;
      if (c * CHUNK + j < total) {
        int4 id = s_id[buf][j];
        if (STAGE_R) {
          const float r = s_geo[buf][j].w;
          if (USE_R_J) id.w = __float_as_int(r);
          if (SYMMETRIC) s_geo[buf][j].w = __fmul_rn(r, r);
        }
        if (USE_SET_J) id.z = id.y;
        id.y = cand_bit(cs, id.y);
        s_id[buf][j] = id;
      }
    }
  };

  float acc[N_OUT];
#pragma unroll
  for (int k = 0; k < N_OUT; ++k) acc[k] = 0.0f;
  if (n_chunks > 0) {
    stage(0, 0);
    finish(0, 0);
  }
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) stage(c + 1, buf ^ 1);
    const int m = min(CHUNK, total - c * CHUNK);
    const int mw = (m + WORD - 1) / WORD * WORD;
    const float4* g = s_geo[buf];
    for (int j0 = 0; j0 < mw; j0 += WORD) {
      unsigned hits = 0u;
#pragma unroll
      for (int u = 0; u < WORD; ++u) {
        const float4 cg = g[j0 + u];
        const float d2 = d2_rn(__fsub_rn(cg.x, qx), __fsub_rn(cg.y, qy),
                               __fsub_rn(cg.z, qz));
        bool hit = d2 <= qr2;
        if (SYMMETRIC) hit = hit || d2 <= cg.w;
        if (hit) hits |= 1u << u;
      }
      for (; hits; hits &= hits - 1) {   // the hits only, in order
        const int j = j0 + __ffs(hits) - 1;
        const int4 id = s_id[buf][j];   // orig, bit, set, r_j
        if (id.x == qo || (allow_q & id.y) == 0) continue;
        const float4 cg = g[j];
        const float dx = __fsub_rn(cg.x, qx);
        const float dy = __fsub_rn(cg.y, qy);
        const float dz = __fsub_rn(cg.z, qz);
        const float2 p = USE_PAY ? s_pay[buf][j] : make_float2(0.0f, 0.0f);
        float v[N_OUT];
        pair_fn(dx, dy, dz, d2_rn(dx, dy, dz), r2_i, qo, id.x, qs,
                USE_SET_J ? id.z : 0, qp0, qp1, USE_P0_J ? p.x : 0.0f,
                USE_P1_J ? p.y : 0.0f, USE_R_J ? __int_as_float(id.w) : 0.0f,
                v);
#pragma unroll
        for (int k = 0; k < N_OUT; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
      }
    }
    if (c + 1 < n_chunks) finish(c + 1, buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < N_OUT; ++k) out[k * n_slots + slot] = acc[k];
}

}  // namespace

extern "C" int tns_reduce_n_out() { return N_OUT; }

extern "C" int tns_pairs_reduce(const int* desc, const int* q_t,
                                const int* recs_t, int n_rec, int tiles_cap,
                                int n_win, float r2, int symmetric,
                                int n_blocks, const int* set_of,
                                const int* allow, int n_allow, float* out,
                                void* stream) {
  if (n_blocks < 0 || n_blocks > MAX_BLOCKS || (symmetric && !VARIABLE) ||
      n_win < 1 || n_win > MAX_WIN)
    return (int)cudaErrorInvalidValue;
  CandSets cs{};
  cs.n_blocks = n_blocks;
  for (int b = 0; b < n_blocks; ++b) cs.set_of[b] = set_of[b];
  if (tiles_cap > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    // symmetric implies VARIABLE (checked above), so a fixed-radius build
    // instantiates the kernel once
    if (symmetric)
      pairs_reduce_kernel<VARIABLE><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, cs, allow, n_allow,
          out);
    else
      pairs_reduce_kernel<false><<<tiles_cap, TILE, 0, st>>>(
          desc, q_t, recs_t, n_rec, tiles_cap, n_win, r2, cs, allow, n_allow,
          out);
  }
  return (int)cudaGetLastError();
}
