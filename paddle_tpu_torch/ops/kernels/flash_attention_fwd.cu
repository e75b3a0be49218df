// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/flash_attention.py:_fwd_kernel (:64), launched by
// _flash_fwd (pallas_call at :136).
//
// Computes, per (batch b, query head h), out = softmax(scale * Q K^T) V and
// lse = m + log(l) (f32, [B, H, Sq]), with GQA by kv head h / (H / HKV)
// (no repeat of K/V) and, when causal, query row i seeing keys
// j <= i + (Sk - Sq). Key tiles wholly above that diagonal are skipped.
// Masked scores never count, so a row with no visible key comes out as
// zeros with lse = -1e30 — the TPU kernel's conventions. Q/K/V/out are
// addressed through strides, so the public [B, S, H, D] layout is read and
// written in place.
//
// Bound on this card: operations. Attention forward does 4 * Sq * Sk * D
// flops per head (halved when causal) on 2-byte inputs, well above the
// ~295 flops per byte where the H100 turns compute-bound. Design against
// that: one block per query tile, head and batch loops over key tiles in
// place of the TPU's sequential grid axis (nothing carries between blocks
// on this card); the Q tile stays in shared memory for the whole loop,
// each K/V tile is read from device memory once per query tile, and the
// online-softmax state (row max, denominator, output accumulator) stays in
// registers, so the Sq x Sk score matrix never reaches device memory.
// bf16/f16 inputs run both products on the tensor cores through wgmma,
// fed by TMA from a producer warpgroup (second kernel below); f32 inputs,
// which have no tensor-core type of their own precision, run on the CUDA
// cores (first kernel). The Python wrapper picks the kernel up front from
// dtype and head_dim and launches its symbol.

// ---------------------------------------------------------------------------
// f32 path on the CUDA cores: each of the 256 threads owns a 4-row strip of
// the tile, 4 x (BK/16) scores and 4 x (D/16) output columns, accumulated
// with f32 FMAs; P reuses the K tile's shared memory.
// ---------------------------------------------------------------------------

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

template <int D, int BK>
constexpr int smem_floats() {
  // Q tile [BQ][D+1], K tile [BK][D+1] (reused for P [BQ][BK+1]), V [BK][D]
  return BQ * (D + 1) + BK * (D + 1) + BK * D;
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int HKV, int Sq, int Sk,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                 int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                 int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 float scale, int causal) {
  static_assert(BQ * (BK + 1) <= BK * (D + 1), "P must fit in the K tile");
  constexpr int RM = 4;        // rows per thread
  constexpr int CN = BK / 16;  // score columns per thread
  constexpr int DN = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);     // [BK][D + 1]; then P [BQ][BK + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / HKV);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // owns rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // owns columns tx + 16*j
  const int off = Sk - Sq;  // causal diagonal offset

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    Qs[r * (D + 1) + c] = q0 + r < Sq ? to_f<T>(qb[(q0 + r) * q_ss + c]) : 0.f;
  }

  float m_i[RM], l_i[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    // last key any row of this tile may see
    const int last = min(q0 + BQ, Sq) - 1 + off;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < Sk;
      Ks[r * (D + 1) + c] = in ? to_f<T>(kb[(k0 + r) * k_ss + c]) : 0.f;
      Vs[r * D + c] = in ? to_f<T>(vb[(k0 + r) * v_ss + c]) : 0.f;
    }
    __syncthreads();  // Q (first pass), K and V tiles in place

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RM], kk[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = Qs[(ty * RM + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kk[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty * RM + i;
      bool ok[CN];
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < Sk && (!causal || qi + off >= kj);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
      // the 16 threads sharing these rows are one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_new = fmaxf(m_i[i], mc);
      const float alpha = expf(m_i[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        // a row masked so far has m_new = -1e30 and exp(s - m) = 1: zero it
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_i[i] = l_i[i] * alpha + ps;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DN; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading the K tile
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        Ps[(ty * RM + i) * (BK + 1) + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pa[i] = Ps[(ty * RM + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < DN; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DN; ++c) acc[i][c] = fmaf(pa[i], vv[c], acc[i][c]);
    }
    __syncthreads();  // before the next tile overwrites K/P and V
  }

  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi >= Sq) continue;
    const float safe = l_i[i] == 0.f ? 1.f : l_i[i];
#pragma unroll
    for (int c = 0; c < DN; ++c)
      ob[qi * o_ss + tx + 16 * c] = from_f<T>(acc[i][c] / safe);
    if (tx == 0) lse[((int64_t)b * H + h) * Sq + qi] = m_i[i] + logf(safe);
  }
}

template <typename T, int D, int BK>
int launch_scalar(const void* q, const void* k, const void* v, void* out,
                  float* lse, int B, int H, int HKV, int Sq, int Sk,
                  const int64_t* st, float scale, int causal,
                  cudaStream_t stream) {
  constexpr int SMEM = smem_floats<D, BK>() * int(sizeof(float));
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D, BK><<<grid, THREADS, SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, H, HKV, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int HKV, int Sq, int Sk, int D,
               const int64_t* st, float scale, int causal,
               cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_scalar<float, 64, 64>(q, k, v, out, lse, B, H, HKV, Sq,
                                          Sk, st, scale, causal, stream);
    case 128:
      return launch_scalar<float, 128, 64>(q, k, v, out, lse, B, H, HKV, Sq,
                                           Sk, st, scale, causal, stream);
    case 256:
      return launch_scalar<float, 256, 32>(q, k, v, out, lse, B, H, HKV, Sq,
                                           Sk, st, scale, causal, stream);
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// Warp-specialised tensor-core path for bf16/f16 on Hopper: TMA, mbarriers
// and wgmma (hopper.cuh). One block per (128-row query tile, head, batch),
// three warpgroups:
// - the producer (warpgroup 0) gives up registers (setmaxnreg.dec) and one
//   of its threads issues the TMA loads: the Q tile once, then each key
//   tile's K and V into a ring of WG_STAGES stages, each stage with a
//   "full" mbarrier (armed with the bytes to expect) and an "empty" one
//   (one arrival per consumer warp once the tile is no longer read);
// - two consumers (warpgroups 1 and 2) take more registers
//   (setmaxnreg.inc) and own 64 query rows each: S = Q K^T by wgmma with
//   both operands K-major in shared memory; the online softmax in
//   registers in the log2 domain (exp2 of s * scale * log2(e) - m, one
//   multiply-add, m and the row sums shared by the 4 lanes of a quad); then
//   O += P V by wgmma with P from registers — each warp's f32 S
//   accumulators packed to bf16/f16 pairs in place, the fragment identity
//   of mma.sync (mma.cuh), P rounded to V's dtype as the TPU kernel
//   rounds it — and V read MN-major from its [key][d] tile, never
//   transposed in memory.
// The causal mask runs only on the tiles that hold keys past a row's
// diagonal (or past Sk) for the warpgroup's rows. Causal grids launch the
// heaviest query tiles first. The epilogue stages O in the consumer's own
// Q rows and writes it in 16-byte stores, rows past Sq clipped; lse is the
// natural-log f32 residual the backward kernels read.
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;      // query rows per block, 64 per consumer
constexpr int WG_THREADS = 384;  // producer + two consumer warpgroups
constexpr int WG_STAGES = 2;     // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct WgmmaTile {
  static constexpr int BK = D <= 128 ? 128 : 64;  // keys per tile
  static constexpr int BOXES = D / 64;            // 128-byte column boxes
  static constexpr int Q_BYTES = WG_BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or one V tile
  static constexpr int BAR_OFFSET = Q_BYTES + WG_STAGES * 2 * KV_BYTES;
  // tiles, barriers (Q, then full and empty per stage), and the slack that
  // aligns the base to the 1024 bytes of the swizzle pattern
  static constexpr int SMEM = BAR_OFFSET + 8 * (1 + 2 * WG_STAGES) + 1024;
};

// key tiles a block of query rows q0.. visits: all of them, or under
// causal masking those up to the diagonal of its last row
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int BK,
                                         int causal) {
  int n = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + WG_BQ, Sq) - 1 + (Sk - Sq);
    n = last < 0 ? 0 : min(n, last / BK + 1);
  }
  return n;
}

template <typename T, int N>  // S = Q K^T: N = BK, both K-major
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64<T, 0, 0>(d, a, b, scale_d);
  } else {
    wgmma_ss_n128<T, 0, 0>(d, a, b, scale_d);
  }
}

template <typename T, int N>  // O += P V: N = D, V MN-major
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs_n64<T, 1>(d, a, b, 1);
  } else if constexpr (N == 128) {
    wgmma_rs_n128<T, 1>(d, a, b, 1);
  } else {
    wgmma_rs_n256<T, 1>(d, a, b, 1);
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       T* __restrict__ out, float* __restrict__ lse, int H,
                       int HKV, int Sq, int Sk, int64_t o_sb, int64_t o_ss,
                       int64_t o_sh, float scale_log2, int causal) {
  using Tile = WgmmaTile<D>;
  constexpr int BK = Tile::BK;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = wg_smem + (base - raw);
  const uint32_t q_tile = base;                    // [BOXES][WG_BQ][128 B]
  const uint32_t kv_tiles = base + Tile::Q_BYTES;  // per stage: K, then V
  const uint32_t q_full = base + Tile::BAR_OFFSET;
  const uint32_t full0 = q_full + 8;                // + 8 * stage
  const uint32_t empty0 = full0 + 8 * WG_STAGES;    // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * WG_BQ;
  const int kv_head = h / (H / HKV);
  const int off = Sk - Sq;  // causal: row i sees keys j <= i + off
  const int n_tiles = key_tiles(q0, Sq, Sk, BK, causal);
  const int tid = threadIdx.x;

  if (tid == 0) {
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < WG_STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 8);  // the 8 consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    warpgroup_reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, Tile::Q_BYTES);
#pragma unroll
      for (int i = 0; i < Tile::BOXES; ++i)
        tma_load_4d(q_tile + i * WG_BQ * 128, &q_map, q_full, 64 * i, q0, h,
                    b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % WG_STAGES;
        // the stage's previous tile, t - WG_STAGES, has been read
        if (t >= WG_STAGES) mbar_wait(empty0 + 8 * st, (t / WG_STAGES + 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t kt = kv_tiles + st * 2 * Tile::KV_BYTES;
        mbar_expect_tx(full, 2 * Tile::KV_BYTES);
#pragma unroll
        for (int i = 0; i < Tile::BOXES; ++i) {
          tma_load_4d(kt + i * BK * 128, &k_map, full, 64 * i, t * BK,
                      kv_head, b);
          tma_load_4d(kt + Tile::KV_BYTES + i * BK * 128, &v_map, full, 64 * i,
                      t * BK, kv_head, b);
        }
      }
    }
    return;
  }

  warpgroup_reg_alloc<240>();
  const int cw = tid / 128 - 1;  // this consumer's rows: 64 cw .. 64 cw + 63
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r_a = 64 * cw + 16 * warp + g;  // tile rows r_a and r_a + 8
  const int row_a = q0 + r_a, row_b = row_a + 8;
  const int first_row = q0 + 64 * cw;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, log2 domain
  float l_a = 0.f, l_b = 0.f;              // this lane's part of the sums

  mbar_wait(q_full, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % WG_STAGES;
    const int k0 = tile * BK;
    const uint32_t kt = kv_tiles + st * 2 * Tile::KV_BYTES;
    mbar_wait(full0 + 8 * st, (tile / WG_STAGES) & 1);

    // S = Q K^T: this warpgroup's 64 rows x BK keys, k16 steps along D
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t box = kk / 4, in_box = (kk % 4) * 32;
      wgmma_qk<T, BK>(
          s,
          desc_sw128(q_tile + box * WG_BQ * 128 + cw * 64 * 128 + in_box, 16,
                     1024),
          desc_sw128(kt + box * BK * 128 + in_box, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // element e of n-tile n: row (e < 2 ? row_a : row_b), key
    // k0 + 8n + 2 t4 + (e & 1)
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > first_row + off)) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * n + 2 * t4 + (e & 1);
          const int qi = e < 2 ? row_a : row_b;
          if (kj >= Sk || (causal && kj > qi + off)) s[4 * n + e] = -INFINITY;
        }
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    // a row with no visible key so far keeps m = -inf and offsets by 0,
    // so its probabilities (and the rescale of its zero sums) are 0
    const float mn_a = fmaxf(m_a, mx_a * scale_log2);
    const float mn_b = fmaxf(m_b, mx_b * scale_log2);
    const float c_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float c_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2_approx(m_a - c_a), al_b = exp2_approx(m_b - c_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[4 * n] = exp2_approx(fmaf(s[4 * n], scale_log2, -c_a));
      s[4 * n + 1] = exp2_approx(fmaf(s[4 * n + 1], scale_log2, -c_a));
      s[4 * n + 2] = exp2_approx(fmaf(s[4 * n + 2], scale_log2, -c_b));
      s[4 * n + 3] = exp2_approx(fmaf(s[4 * n + 3], scale_log2, -c_b));
      sum_a += s[4 * n] + s[4 * n + 1];
      sum_b += s[4 * n + 2] + s[4 * n + 3];
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= al_a;
      o[4 * n + 1] *= al_a;
      o[4 * n + 2] *= al_b;
      o[4 * n + 3] *= al_b;
    }

    // O += P V: P's accumulators for keys 16kk..16kk+15 are the A fragment
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      p[kk][0] = pack2f<T>(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack2f<T>(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack2f<T>(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack2f<T>(s[8 * kk + 6], s[8 * kk + 7]);
    }
    const uint32_t v_tile = kt + Tile::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<T, D>(o, p[kk],
                     desc_sw128(v_tile + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // K and V read
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
  const float inv_b = l_b == 0.f ? 0.f : 1.f / l_b;

  // stage O in this warpgroup's Q rows, swizzled as Q was loaded
  named_barrier_sync(1 + cw, 128);
  const int sw = r_a % 8;  // rows r_a and r_a + 8 share the swizzle phase
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    unsigned char* box = sbase + (n / 8) * WG_BQ * 128;
    const int at = ((n % 8) ^ sw) * 16 + 4 * t4;
    *reinterpret_cast<uint32_t*>(box + r_a * 128 + at) =
        pack2f<T>(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(box + (r_a + 8) * 128 + at) =
        pack2f<T>(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
  }
  named_barrier_sync(1 + cw, 128);
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  T* ob = out + b * o_sb + h * o_sh;
  for (int idx = tid % 128; idx < 64 * CHUNKS; idx += 128) {
    const int r = 64 * cw + idx / CHUNKS, c = idx % CHUNKS;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(sbase + (c / 8) * WG_BQ * 128 +
                                          r * 128 + ((c % 8) ^ (r % 8)) * 16);
  }
  if (t4 == 0) {
    float* lrow = lse + ((int64_t)b * H + h) * Sq;
    if (row_a < Sq) lrow[row_a] = l_a == 0.f ? NEG_INF : m_a * LN2 + logf(l_a);
    if (row_b < Sq) lrow[row_b] = l_b == 0.f ? NEG_INF : m_b * LN2 + logf(l_b);
  }
}

template <typename T, int D>
int launch_wgmma(int dtype, const void* q, const void* k, const void* v,
                 void* out, float* lse, int B, int H, int HKV, int Sq, int Sk,
                 const int64_t* st, float scale, int causal,
                 cudaStream_t stream) {
  using Tile = WgmmaTile<D>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap q_map, k_map, v_map;
  int e = encode_bshd_map(&q_map, dtype, q, B, Sq, H, D, st[0], st[1], st[2],
                          WG_BQ);
  if (e == 0)
    e = encode_bshd_map(&k_map, dtype, k, B, Sk, HKV, D, st[3], st[4], st[5],
                        Tile::BK);
  if (e == 0)
    e = encode_bshd_map(&v_map, dtype, v, B, Sk, HKV, D, st[6], st[7], st[8],
                        Tile::BK);
  if (e != 0) return e;
  const dim3 grid(H, B, (Sq + WG_BQ - 1) / WG_BQ);
  flash_fwd_wgmma_kernel<T, D><<<grid, WG_THREADS, Tile::SMEM, stream>>>(
      q_map, k_map, v_map, (T*)out, lse, H, HKV, Sq, Sk, st[9], st[10],
      st[11], scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgmma_typed(int dtype, const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int H, int HKV, int Sq,
                       int Sk, int D, const int64_t* st, float scale,
                       int causal, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_wgmma<T, 64>(dtype, q, k, v, out, lse, B, H, HKV, Sq, Sk,
                                 st, scale, causal, stream);
    case 128:
      return launch_wgmma<T, 128>(dtype, q, k, v, out, lse, B, H, HKV, Sq, Sk,
                                  st, scale, causal, stream);
    case 256:
      return launch_wgmma<T, 256>(dtype, q, k, v, out, lse, B, H, HKV, Sq, Sk,
                                  st, scale, causal, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" int flash_attention_fwd_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* lse, int B, int H, int HKV, int Sq, int Sk, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int causal,
    void* stream) {
  if (B <= 0 || H <= 0 || HKV <= 0 || H % HKV != 0 || Sq <= 0 || Sk <= 0 ||
      dtype != DT_F32)
    return -1;
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  return launch_f32(q, k, v, out, (float*)lse, B, H, HKV, Sq, Sk, D, st,
                    scale, causal, (cudaStream_t)stream);
}

extern "C" int flash_attention_fwd_wgmma_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* lse, int B, int H, int HKV, int Sq, int Sk, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int causal,
    void* stream) {
  if (B <= 0 || H <= 0 || HKV <= 0 || H % HKV != 0 || Sq <= 0 || Sk <= 0)
    return -1;
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  float* l = (float*)lse;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_BF16:
      return launch_wgmma_typed<__nv_bfloat16>(dtype, q, k, v, out, l, B, H,
                                               HKV, Sq, Sk, D, st, scale,
                                               causal, s);
    case DT_F16:
      return launch_wgmma_typed<__half>(dtype, q, k, v, out, l, B, H, HKV, Sq,
                                        Sk, D, st, scale, causal, s);
    default:
      return -1;
  }
}
