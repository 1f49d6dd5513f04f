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
constexpr int MAX_BLOCKS = 8;    // candidate sets

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

// K2's schedule (csrc/pairs.cu): one block of 128 threads per query tile,
// one query per thread, the tile's windows streamed in order through
// shared memory in CHUNK-candidate passes.  Staged per candidate: x, y, z,
// orig, its candidate-set bit, and the fields pair_fn reads (set, p0, p1,
// r_j; r_j^2 for symmetric search).  For each hit (K2's criterion, self
// excluded, the query set's allow word taking the candidate's set) the
// thread evaluates pair_fn on the env and adds its N_OUT values to float
// accumulators in registers, in window order; nothing is compacted, and
// each slot's N_OUT sums are written once.  The env is JAX's: dx dy dz
// the displacement candidate minus query, d2, r2_i = the query's F_R
// squared (0 at a fixed radius, as in JAX), orig, set and payload of
// both, r_j in variable mode.
// Bound: the distance tests (9 float operations each) plus pair_fn's
// operations and N_OUT adds per hit; the bytes (the records once, the
// query tiles, N_OUT floats per slot) take a tenth of that at 1M points.
template <bool SYMMETRIC>
__global__ void __launch_bounds__(TILE)
pairs_reduce_kernel(const int* __restrict__ desc, const int* __restrict__ q_t,
                    const int* __restrict__ recs_t, int n_rec, int tiles_cap,
                    int n_win, float r2, CandSets cs,
                    const int* __restrict__ allow, int n_allow,
                    float* __restrict__ out) {
  __shared__ float sx[CHUNK];
  __shared__ float sy[CHUNK];
  __shared__ float sz[CHUNK];
  __shared__ int so[CHUNK];
  __shared__ int sbit[CHUNK];
  __shared__ int ss[USE_SET_J ? CHUNK : 1];
  __shared__ float sp0[USE_P0_J ? CHUNK : 1];
  __shared__ float sp1[USE_P1_J ? CHUNK : 1];
  __shared__ float srj[USE_R_J ? CHUNK : 1];
  __shared__ float srj2[SYMMETRIC ? CHUNK : 1];

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
  const int* rx = recs_t;
  const int* ry = recs_t + (size_t)n_rec;
  const int* rz = recs_t + 2 * (size_t)n_rec;
  const int* rr = recs_t + F_R * (size_t)n_rec;
  const int* ro = recs_t + F_ORIG * (size_t)n_rec;
  const int* rs = recs_t + F_SET * (size_t)n_rec;
  const int* rp0 = recs_t + F_P0 * (size_t)n_rec;
  const int* rp1 = recs_t + F_P1 * (size_t)n_rec;

  float acc[N_OUT];
#pragma unroll
  for (int k = 0; k < N_OUT; ++k) acc[k] = 0.0f;
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
        const int set = rs[src];
        sbit[j] = cand_bit(cs, set);
        if (USE_SET_J) ss[j] = set;
        if (USE_P0_J) sp0[j] = __int_as_float(rp0[src]);
        if (USE_P1_J) sp1[j] = __int_as_float(rp1[src]);
        if (USE_R_J || SYMMETRIC) {
          const float r = __int_as_float(rr[src]);
          if (USE_R_J) srj[j] = r;
          if (SYMMETRIC) srj2[j] = __fmul_rn(r, r);
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
        if (SYMMETRIC) hit = hit || d2 <= srj2[j];
        const int o = so[j];
        if (hit && o != qo && (allow_q & sbit[j]) != 0) {
          float v[N_OUT];
          pair_fn(dx, dy, dz, d2, r2_i, qo, o, qs, USE_SET_J ? ss[j] : 0,
                  qp0, qp1, USE_P0_J ? sp0[j] : 0.0f,
                  USE_P1_J ? sp1[j] : 0.0f, USE_R_J ? srj[j] : 0.0f, v);
#pragma unroll
          for (int k = 0; k < N_OUT; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
        }
      }
      __syncthreads();
    }
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
  if (n_blocks < 0 || n_blocks > MAX_BLOCKS || (symmetric && !VARIABLE))
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
