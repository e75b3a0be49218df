// Paged single-token decode attention for Hopper (sm_90a), over float pools
// and over int8 pools with f32 per-token scales.
//
// Replaces: the TPU paged-attention kernel that
// paddle_tpu/ops/paged_attention.py:paged_decode_attention calls at :984
// (jax.experimental.pallas.ops.tpu.paged_attention), on float pools and on
// int8 pools wrapped as QuantizedTensor pages (:971-990).
//
// Computes, for every sequence b and query head h:
//   out[b, h] = softmax(q'[b, h] . K[b, :len_b]^T) V[b, :len_b]
// where q' is q pre-scaled by 1/sqrt(D) in q's dtype (as the TPU kernel
// path does), K/V rows are gathered from [KVH, NB, BS, D] pools through the
// [B, P] block table, kv head = h / (H / KVH), and len_b = lengths[b]
// (cache_len + 1). Only the live pages ceil(len_b / BS) are read: table
// entries past them may hold the serving engine's trash block id.
// Int8 pools: element x of row r dequantizes in f32 as (x * s[r]) / 127.5,
// s the [KVH, NB, BS] scale pool, which is the TPU kernel's order
// (quantization_utils.from_int8 on an f32 page); nothing is rounded to a
// 16-bit type.
//
// Bound on this card: bytes. Each live K/V element is used for 2 flops
// (one multiply-add in q.k, one in p.v; int8 adds a multiply and a divide),
// far below the ~295 flops per byte the H100 needs before compute limits,
// so the time is the live KV bytes over HBM bandwidth. Design against that:
// one block per (query head, sequence); each warp streams whole K and V rows
// (D=128: 256 bytes in bf16, 8 bytes per lane; 128 bytes in int8, one
// 32-bit load per lane plus the row's scale, one address for the warp), TPI
// rows at a time to keep several loads in flight, and keeps an online
// softmax (running max, denominator, f32 accumulator) in registers, so no
// score or probability ever touches device memory. The block's warps split
// the sequence and merge their partial softmax states once through shared
// memory. No tensor cores: a decode row is one query against many keys.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;  // warps per block
constexpr int TPI = 4;    // K/V rows a warp loads per iteration
constexpr float KV_QMAX = 127.5f;  // the int8 convention's MAX_INT8

template <typename KV>
constexpr bool kIsInt8 = std::is_same<KV, int8_t>::value;

// Start the loads of row `row` (this lane's EPL elements, converted to f32
// exactly) and, for int8 pools, of its scale; dequantize() applies the
// scale where the values are used, so every row's loads are in flight
// before the first one is waited on.
template <typename KV, int EPL, int D>
__device__ __forceinline__ void load_row(const KV* __restrict__ pool,
                                         const float* __restrict__ scales,
                                         int64_t row, int lane,
                                         float (&o)[EPL], float& s) {
  load_f32<KV, EPL>(pool + row * D + lane * EPL, o);
  if constexpr (kIsInt8<KV>) s = scales[row];
}

// int8: (x * s) / 127.5 in f32, the TPU kernel's order; float: nothing
template <typename KV, int EPL>
__device__ __forceinline__ void dequantize(float (&o)[EPL], float s) {
  if constexpr (kIsInt8<KV>) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = __fdiv_rn(__fmul_rn(o[e], s), KV_QMAX);
  }
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ lengths, T* __restrict__ out,
                    int H, int KVH, int NB, int BS, int P, float scale) {
  constexpr int EPL = D / 32;  // elements per lane
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // never read past the table row
  const int len = min(lengths[b], P * BS);

  // q pre-scaled in its own dtype: round(q * round(scale))
  float qv[EPL];
  load_f32<T, EPL>(q + ((int64_t)b * H + h) * D + lane * EPL, qv);
  const float scale_t = to_f<T>(from_f<T>(scale));
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] = to_f<T>(from_f<T>(qv[e] * scale_t));

  const int32_t* trow = tables + (int64_t)b * P;
  const int64_t head_rows = (int64_t)kvh * NB * BS;

  float m = -INFINITY, l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  for (int t0 = warp * TPI; t0 < len; t0 += WARPS * TPI) {
    int64_t row[TPI];
    float kv[TPI][EPL];
    float sc[TPI];  // the rows' scales (int8 pools)
#pragma unroll
    for (int i = 0; i < TPI; ++i) {
      const int t = t0 + i;
      row[i] = -1;
      sc[i] = 0.f;
      if (t < len) {
        row[i] = head_rows + (int64_t)trow[t / BS] * BS + (t % BS);
        load_row<KV, EPL, D>(k_pool, k_scale, row[i], lane, kv[i], sc[i]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[i][e] = 0.f;
      }
    }
    float s[TPI];
#pragma unroll
    for (int i = 0; i < TPI; ++i) {
      dequantize<KV, EPL>(kv[i], sc[i]);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qv[e], kv[i][e], d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      s[i] = row[i] >= 0 ? d : -INFINITY;
    }
    // start the V loads before the softmax arithmetic
#pragma unroll
    for (int i = 0; i < TPI; ++i) {
      if (row[i] >= 0) {
        load_row<KV, EPL, D>(v_pool, v_scale, row[i], lane, kv[i], sc[i]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[i][e] = 0.f;
      }
    }
    // t0 < len, so s[0] is finite and so is m_new
    float m_new = m;
#pragma unroll
    for (int i = 0; i < TPI; ++i) m_new = fmaxf(m_new, s[i]);
    const float corr = expf(m - m_new);  // m = -inf on the first pass -> 0
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < TPI; ++i) {
      s[i] = expf(s[i] - m_new);  // masked rows: exp(-inf) = 0
      psum += s[i];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < TPI; ++i) dequantize<KV, EPL>(kv[i], sc[i]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float a = acc[e] * corr;
#pragma unroll
      for (int i = 0; i < TPI; ++i) a = fmaf(s[i], kv[i][e], a);
      acc[e] = a;
    }
    m = m_new;
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[e];
  __syncthreads();
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      // a warp that saw no token has m = -inf and l = 0
      const float f = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - mx);
      L = fmaf(sm_l[w], f, L);
      o = fmaf(sm_acc[w][d], f, o);
    }
    out[((int64_t)b * H + h) * D + d] = from_f<T>(L > 0.f ? o / L : 0.f);
  }
}

// KV = T for float pools, int8_t for int8 pools (then scales are non-null)
template <typename T, typename KV>
int launch_typed(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int32_t* tables,
                 const int32_t* lengths, void* out, int B, int H, int KVH,
                 int NB, int BS, int P, int D, float scale,
                 cudaStream_t stream) {
  const dim3 grid(H, B);
  const dim3 block(WARPS * 32);
#define PAGED_LAUNCH(DIM)                                                  \
  paged_decode_kernel<T, KV, DIM><<<grid, block, 0, stream>>>(             \
      (const T*)q, (const KV*)k, (const KV*)v, ks, vs, tables, lengths,    \
      (T*)out, H, KVH, NB, BS, P, scale)
  switch (D) {
    case 64: PAGED_LAUNCH(64); break;
    case 128: PAGED_LAUNCH(128); break;
    case 256: PAGED_LAUNCH(256); break;
    default: return -1;
  }
#undef PAGED_LAUNCH
  return (int)cudaGetLastError();
}

template <bool INT8>
int launch(int dtype, const void* q, const void* k, const void* v,
           const float* ks, const float* vs, const void* tables,
           const void* lengths, void* out, int B, int H, int KVH, int NB,
           int BS, int P, int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || BS <= 0 || P <= 0)
    return -1;
  const int32_t* t = (const int32_t*)tables;
  const int32_t* len = (const int32_t*)lengths;
  cudaStream_t s = (cudaStream_t)stream;
#define TYPED(T)                                                            \
  launch_typed<T, typename std::conditional<INT8, int8_t, T>::type>(        \
      q, k, v, ks, vs, t, len, out, B, H, KVH, NB, BS, P, D, scale, s)
  switch (dtype) {
    case DT_F32: return TYPED(float);
    case DT_BF16: return TYPED(__nv_bfloat16);
    case DT_F16: return TYPED(__half);
    default: return -1;
  }
#undef TYPED
}

}  // namespace

extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, int B, int H, int KVH,
    int NB, int BS, int P, int D, float scale, void* stream) {
  return launch<false>(dtype, q, k_pool, v_pool, nullptr, nullptr, tables,
                       lengths, out, B, H, KVH, NB, BS, P, D, scale, stream);
}

// q and out in the dtype code's type; pools int8; scale pools f32
// [KVH, NB, BS]
extern "C" int paged_decode_attention_int8_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, int B, int H, int KVH, int NB, int BS,
    int P, int D, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return -1;
  return launch<true>(dtype, q, k_pool, v_pool, (const float*)k_scale,
                      (const float*)v_scale, tables, lengths, out, B, H, KVH,
                      NB, BS, P, D, scale, stream);
}
