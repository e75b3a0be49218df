// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/flash_attention.py:_fwd_kernel (:64), launched by
// _flash_fwd (pallas_call at :136).
//
// Computes, per (batch b, query head h), out = softmax(scale * Q K^T) V and
// lse = m + log(l) (f32, [B, H, Sq]), with GQA by kv head h / (H / HKV)
// (no repeat of K/V) and, when causal, query row i seeing keys
// j <= i + (Sk - Sq). Key tiles wholly above that diagonal are skipped.
// Masked scores take -1e30 and their probabilities are zeroed, so a row
// with no visible key comes out as zeros with lse = -1e30 — the TPU
// kernel's conventions. Q/K/V/out are addressed through strides, so the
// public [B, S, H, D] layout is read and written in place.
//
// Bound on this card: operations. Attention forward does 4 * Sq * Sk * D
// flops per head (halved when causal) on 2-byte inputs, well above the
// ~295 flops per byte where the H100 turns compute-bound. Design against
// that: one block per (64-row query tile, head, batch) loops over key tiles
// in place of the TPU's sequential grid axis (nothing carries between
// blocks on this card); the Q tile stays in shared memory for the whole
// loop, each K/V tile is read from device memory once per query tile, and
// the online-softmax state (row max, denominator, output accumulator) stays
// in registers, so the Sq x Sk score matrix never reaches device memory.
// bf16/f16 inputs run both products on the tensor cores (mma.sync, below);
// f32 inputs, which have no tensor-core type of their own precision, run on
// the CUDA cores (next kernel). Overlapping tile loads with the products
// (cp.async/TMA stages, then wgmma) is the next step, not part of this one.

// ---------------------------------------------------------------------------
// f32 path on the CUDA cores: each of the 256 threads owns a 4-row strip of
// the tile, 4 x (BK/16) scores and 4 x (D/16) output columns, accumulated
// with f32 FMAs; P reuses the K tile's shared memory.
// ---------------------------------------------------------------------------

#include <type_traits>

#include "common.cuh"
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

// ---------------------------------------------------------------------------
// Tensor-core path for bf16/f16: both products on mma.sync.m16n8k16 with f32
// accumulation. One warp owns 16 query rows (4 warps, 64 rows a block). The
// fragment layouts are PTX's: for lane = 4*g + t, an accumulator holds rows
// g and g+8 at columns 2t and 2t+1 of each 8-wide n-tile, which is exactly
// the A-operand layout of the next product, so the probabilities P go from
// the S accumulators into bf16/f16 A fragments without touching shared
// memory (and, as in the TPU kernel, are rounded to V's dtype there).
// Row statistics are shared by the 4 lanes of a quad. Q, K and V tiles sit
// in shared memory with rows padded by 8 elements, which makes every
// fragment load below free of bank conflicts.
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_BK = 64;

template <int D>
constexpr int mma_smem_bytes() {
  return (BQ + 2 * MMA_BK) * (D + 8) * 2;  // Q, K, V tiles of 2-byte elements
}

template <typename T, int D>
__global__ void __launch_bounds__(MMA_WARPS * 32)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int HKV, int Sq, int Sk,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                     int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                     float scale, int causal) {
  constexpr int BK = MMA_BK;
  constexpr int LD = D + 8;  // padded row, in elements
  constexpr int NS = BK / 8;  // S n-tiles per warp
  constexpr int NO = D / 8;   // O n-tiles per warp
  constexpr int VEC = 8;      // elements per 16-byte load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* Ks = Qs + BQ * LD;                     // [BK][LD]
  T* Vs = Ks + BK * LD;                     // [BK][LD]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / HKV);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = Sk - Sq;
  const int r0 = warp * 16;  // this warp's first row in the tile
  const int row_a = q0 + r0 + g, row_b = row_a + 8;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < BQ * (D / VEC); idx += MMA_WARPS * 32) {
    const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
    *reinterpret_cast<uint4*>(Qs + r * LD + c) =
        q0 + r < Sq ? *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_ss + c)
                    : zero;
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;  // running max of rows a, b
  float l_a = 0.f, l_b = 0.f;          // this lane's part of the row sums

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + BQ, Sq) - 1 + off;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int idx = tid; idx < BK * (D / VEC); idx += MMA_WARPS * 32) {
      const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
      const bool in = k0 + r < Sk;
      *reinterpret_cast<uint4*>(Ks + r * LD + c) =
          in ? *reinterpret_cast<const uint4*>(kb + (k0 + r) * k_ss + c) : zero;
      *reinterpret_cast<uint4*>(Vs + r * LD + c) =
          in ? *reinterpret_cast<const uint4*>(vb + (k0 + r) * v_ss + c) : zero;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      const uint32_t a0 = ld_pair(Qs + (r0 + g) * LD + c);
      const uint32_t a1 = ld_pair(Qs + (r0 + g + 8) * LD + c);
      const uint32_t a2 = ld_pair(Qs + (r0 + g) * LD + c + 8);
      const uint32_t a3 = ld_pair(Qs + (r0 + g + 8) * LD + c + 8);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const T* kr = Ks + (n * 8 + g) * LD + c;
        mma16816<T>(s[n], a0, a1, a2, a3, ld_pair(kr), ld_pair(kr + 8));
      }
    }

    // scale, mask, online softmax; element e of n-tile n sits at row
    // (e < 2 ? row_a : row_b), key k0 + 8n + 2t + (e & 1)
    static_assert(NS * 4 <= 32, "one bit per score of the tile");
    uint32_t okm = 0;  // bit 4n+e: score (n, e) is visible
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        const int qi = e < 2 ? row_a : row_b;
        const bool ok = kj < Sk && (!causal || qi + off >= kj);
        okm |= (uint32_t)ok << (4 * n + e);
        s[n][e] = ok ? s[n][e] * scale : NEG_INF;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a row masked so far has m = -1e30 and exp(s - m) = 1 for its
        // masked scores: zero every masked entry explicitly
        const float mref = e < 2 ? mn_a : mn_b;
        s[n][e] = (okm >> (4 * n + e)) & 1u ? expf(s[n][e] - mref) : 0.f;
      }
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // O += P V: P's accumulators for keys 16j..16j+15 are the A fragment
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a0 = pack2f<T>(s[2 * j][0], s[2 * j][1]);
      const uint32_t a1 = pack2f<T>(s[2 * j][2], s[2 * j][3]);
      const uint32_t a2 = pack2f<T>(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t a3 = pack2f<T>(s[2 * j + 1][2], s[2 * j + 1][3]);
      const T* v0 = Vs + (j * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const T* vr = v0 + n * 8;
        const uint32_t b0 = pack2<T>(vr[0], vr[LD]);
        const uint32_t b1 = pack2<T>(vr[8 * LD], vr[9 * LD]);
        mma16816<T>(o[n], a0, a1, a2, a3, b0, b1);
      }
    }
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float safe_a = l_a == 0.f ? 1.f : l_a;
  const float safe_b = l_b == 0.f ? 1.f : l_b;
  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(ob + row_a * o_ss + c) =
          pack2f<T>(o[n][0] / safe_a, o[n][1] / safe_a);
    if (row_b < Sq)
      *reinterpret_cast<uint32_t*>(ob + row_b * o_ss + c) =
          pack2f<T>(o[n][2] / safe_b, o[n][3] / safe_b);
  }
  if (t == 0) {
    float* lrow = lse + ((int64_t)b * H + h) * Sq;
    if (row_a < Sq) lrow[row_a] = m_a + logf(safe_a);
    if (row_b < Sq) lrow[row_b] = m_b + logf(safe_b);
  }
}

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int HKV, int Sq, int Sk,
               const int64_t* st, float scale, int causal,
               cudaStream_t stream) {
  constexpr int SMEM = mma_smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_mma_kernel<T, D><<<grid, MMA_WARPS * 32, SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, H, HKV, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal);
  return (int)cudaGetLastError();
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

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int H, int HKV, int Sq, int Sk, int D,
                 const int64_t* st, float scale, int causal,
                 cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {  // tensor cores
    switch (D) {
      case 64:
        return launch_mma<T, 64>(q, k, v, out, lse, B, H, HKV, Sq, Sk, st,
                                 scale, causal, stream);
      case 128:
        return launch_mma<T, 128>(q, k, v, out, lse, B, H, HKV, Sq, Sk, st,
                                  scale, causal, stream);
      case 256:
        return launch_mma<T, 256>(q, k, v, out, lse, B, H, HKV, Sq, Sk, st,
                                  scale, causal, stream);
      default:
        return -1;
    }
  } else {  // f32: CUDA cores
    switch (D) {
      case 64:
        return launch_scalar<T, 64, 64>(q, k, v, out, lse, B, H, HKV, Sq, Sk,
                                        st, scale, causal, stream);
      case 128:
        return launch_scalar<T, 128, 64>(q, k, v, out, lse, B, H, HKV, Sq, Sk,
                                         st, scale, causal, stream);
      case 256:
        return launch_scalar<T, 256, 32>(q, k, v, out, lse, B, H, HKV, Sq, Sk,
                                         st, scale, causal, stream);
      default:
        return -1;
    }
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
  if (B <= 0 || H <= 0 || HKV <= 0 || H % HKV != 0 || Sq <= 0 || Sk <= 0)
    return -1;
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  float* l = (float*)lse;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch_typed<float>(q, k, v, out, l, B, H, HKV, Sq, Sk, D, st,
                                 scale, causal, s);
    case DT_BF16:
      return launch_typed<__nv_bfloat16>(q, k, v, out, l, B, H, HKV, Sq, Sk, D,
                                         st, scale, causal, s);
    case DT_F16:
      return launch_typed<__half>(q, k, v, out, l, B, H, HKV, Sq, Sk, D, st,
                                  scale, causal, s);
    default:
      return -1;
  }
}
