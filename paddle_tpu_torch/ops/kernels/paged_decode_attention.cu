// Paged single-token decode attention for Hopper (sm_90a), over float pools
// and over int8 pools with f32 per-token scales: flash-decoding.
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
// [B, P] block table, kv head = h / (H / KVH), and len_b = cache_len[b] + 1
// (one cache_len for every row when its stride is 0). Only the live pages
// ceil(len_b / BS) are read: table entries past them may hold the serving
// engine's trash block id.
// Int8 pools: the row's scale s (the [KVH, NB, BS] scale pools) is folded
// into the score and into the probability, s_k * (q' . x_k) / 127.5 and
// (p * s_v / 127.5) * x_v, where the TPU kernel dequantizes each element,
// (x * s) / 127.5, before the products: the same function in f32, rounded
// at other points (an ulp of each term), and one multiply-add per element
// instead of a multiply, a divide and a multiply-add. Nothing is rounded to
// a 16-bit type.
//
// Bound on this card: bytes. Each live K/V element is used for 2 flops
// (one multiply-add in q.k, one in p.v), far below the ~295 flops per byte
// the H100 needs before compute limits, so the time is the live KV bytes
// over HBM bandwidth. Design against that (flash-decoding):
// - The grid is (splits, H, B). Split j of sequence b covers the
//   page-aligned tokens [j * pps * BS, (j + 1) * pps * BS); the wrapper
//   picks splits and pages per split (pps) from the table width, B and H
//   alone (no length is read back), so that the grid fills the SMs several
//   times over and a long sequence is spread over many SMs. A split past
//   the sequence's last live token exits at once.
// - A block's threads form groups of LPR lanes; a group takes R rows at a
//   time, each lane one 16-byte piece of each row's K and V (a 128-wide
//   int8 row is 8 lanes), and issues all of them, with the rows' scales,
//   before the first is used: at D=128, 16 KB in flight per bf16 block
//   with 4 blocks an SM, 8 KB per int8 block with 8 (each measured best
//   of R in {2, 4, 8} at 2, 4, 6 or 8 blocks an SM: flash_ab.py decode). The
//   block stages its slice of the table in shared memory first, so no row
//   address waits on a table load.
// - int8 elements become f32 exactly by byte permutes into the mantissa of
//   2^23 and one subtraction.
// - Each group keeps an online softmax (running max, denominator, f32
//   accumulator) in registers; the block merges its groups through shared
//   memory. A sequence with one live split writes its output there.
//   Otherwise each live split writes its (accumulator, max, denominator)
//   in f32 to the workspace [B, H, splits, D + 2], and the last of them to
//   finish (an atomic ticket per (sequence, head), returned to zero after)
//   merges them and writes the output: one kernel per call.
// No tensor cores: a decode row is one query against many keys.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SPLITS = 64;       // splits a call may have
constexpr int MAX_SPLIT_PAGES = 64;  // pages a split may cover
constexpr float KV_QMAX = 127.5f;    // the int8 convention's MAX_INT8

template <typename KV>
constexpr bool kIsInt8 = std::is_same<KV, int8_t>::value;

// How one (pool type, head dim) splits a row over the lanes of a group.
template <typename KV, int D>
struct Layout {
  static constexpr int EPV = 16 / int(sizeof(KV));  // elements per 16 bytes
  static constexpr int CHUNKS = D / EPV;            // 16-byte pieces a row
  static constexpr int LPR = CHUNKS < 16 ? CHUNKS : 16;  // lanes per row
  static constexpr int VPL = CHUNKS / LPR;          // pieces per lane per row
  static constexpr int EPL = VPL * EPV;             // elements per lane
  // rows per group per pass: int8 rows are short, so int8 trades rows in
  // flight per thread for blocks per SM (BLOCKS_PER_SM)
  static constexpr int R = kIsInt8<KV> ? 2 : VPL >= 4 ? 1 : 4 / VPL;
  static constexpr int GROUPS = THREADS / LPR;
};

// The 16 bytes of a piece as f32, exactly.
template <typename KV>
__device__ __forceinline__ void unpack(const uint4& u, float (&o)[16 / sizeof(KV)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (kIsInt8<KV>) {
    // 0x4B0000XX is 2^23 + XX; XX = x ^ 0x80 = x + 128 for a signed byte
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t biased = w[i] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[4 * i + k] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u + k))
                       - 8388736.f;
    }
  } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else if constexpr (std::is_same<KV, __half>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __uint_as_float(w[i]);
  }
}

// Start the loads of this lane's pieces of pool row `row` and, for int8
// pools, of the row's scale.
template <typename KV, int D>
__device__ __forceinline__ void load_row(const KV* __restrict__ pool,
                                         const float* __restrict__ scales,
                                         int64_t row, int lane,
                                         uint4 (&raw)[Layout<KV, D>::VPL],
                                         float& s) {
  using L = Layout<KV, D>;
  const uint4* src = reinterpret_cast<const uint4*>(pool + row * D);
#pragma unroll
  for (int j = 0; j < L::VPL; ++j) raw[j] = __ldg(src + j * L::LPR + lane);
  if constexpr (kIsInt8<KV>) s = __ldg(scales + row);
}

// Merge the partial states of splits [0, n) from the workspace (written by
// other blocks of this launch: read through L2) into the output row.
template <typename T, int D>
__device__ __forceinline__ void merge_splits(const float* __restrict__ parts,
                                             int n, T* __restrict__ o) {
  __shared__ float s_m[MAX_SPLITS], s_l[MAX_SPLITS], s_f[MAX_SPLITS];
  if (threadIdx.x < n) {
    s_m[threadIdx.x] = __ldcg(parts + threadIdx.x * (D + 2) + D);
    s_l[threadIdx.x] = __ldcg(parts + threadIdx.x * (D + 2) + D + 1);
  }
  __syncthreads();
  float M = -INFINITY;
  for (int i = 0; i < n; ++i) M = fmaxf(M, s_m[i]);
  if (threadIdx.x < n) s_f[threadIdx.x] = expf(s_m[threadIdx.x] - M);
  __syncthreads();
  float L = 0.f;
  for (int i = 0; i < n; ++i) L = fmaf(s_l[i], s_f[i], L);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float od = 0.f;
    for (int i = 0; i < n; ++i) od = fmaf(__ldcg(parts + i * (D + 2) + d), s_f[i], od);
    o[d] = from_f<T>(od / L);
  }
}

// resident blocks per SM the compiler must allow (it caps the registers)
template <typename KV>
constexpr int BLOCKS_PER_SM = kIsInt8<KV> ? 8 : 4;

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM<KV>)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ cache_len, int cl_stride,
                    T* __restrict__ out, float* __restrict__ partials,
                    unsigned int* __restrict__ tickets, int H, int KVH, int NB,
                    int BS, int P, int pps, float scale) {
  using L = Layout<KV, D>;
  constexpr int R = L::R, EPV = L::EPV, EPL = L::EPL, VPL = L::VPL;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x;
  const int64_t bh = (int64_t)b * H + h;
  T* o = out + bh * D;
  // never read past the table row
  const int len = min(cache_len[b * cl_stride] + 1, P * BS);
  const int split_tokens = pps * BS;
  if (len <= 0) {  // nothing to attend over: a zero output
    if (split == 0)
      for (int d = threadIdx.x; d < D; d += THREADS) o[d] = from_f<T>(0.f);
    return;
  }
  const int n_live = (len + split_tokens - 1) / split_tokens;
  if (split >= n_live) return;  // no live token in this split
  const int t_begin = split * split_tokens;
  const int t_end = min(len, t_begin + split_tokens);

  __shared__ int s_pages[MAX_SPLIT_PAGES];
  const int32_t* trow = tables + (int64_t)b * P + split * pps;
  const int n_pages = (t_end - t_begin + BS - 1) / BS;
  for (int i = threadIdx.x; i < n_pages; i += THREADS) s_pages[i] = trow[i];

  const int lane = threadIdx.x % L::LPR;
  const int group = threadIdx.x / L::LPR;
  // q pre-scaled in its own dtype: round(q * round(scale))
  float qv[EPL];
  const float scale_t = to_f<T>(from_f<T>(scale));
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    float x[EPV];
    load_f32<T, EPV>(q + bh * D + (j * L::LPR + lane) * EPV, x);
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      qv[j * EPV + e] = to_f<T>(from_f<T>(x[e] * scale_t));
  }
  __syncthreads();  // s_pages

  const int64_t head_rows = (int64_t)(h / (H / KVH)) * NB * BS;
  float m = -INFINITY, l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int k = 0; k < EPL; ++k) acc[k] = 0.f;

  const int n_pass = (t_end - t_begin + L::GROUPS * R - 1) / (L::GROUPS * R);
  for (int pass = 0; pass < n_pass; ++pass) {
    const int t0 = t_begin + (pass * L::GROUPS + group) * R;
    uint4 kr[R][VPL], vr[R][VPL];
    float ks[R], vs[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ks[r] = vs[r] = 0.f;
      if (t0 + r < t_end) {
        const int rel = t0 + r - t_begin;
        const int page = rel / BS;
        const int64_t row = head_rows + (int64_t)s_pages[page] * BS + (rel - page * BS);
        load_row<KV, D>(k_pool, k_scale, row, lane, kr[r], ks[r]);
        load_row<KV, D>(v_pool, v_scale, row, lane, vr[r], vs[r]);
      } else {
#pragma unroll
        for (int j = 0; j < VPL; ++j) kr[r][j] = vr[r][j] = make_uint4(0, 0, 0, 0);
      }
    }
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float x[EPV];
        unpack<KV>(kr[r][j], x);
#pragma unroll
        for (int e = 0; e < EPV; ++e) d = fmaf(qv[j * EPV + e], x[e], d);
      }
#pragma unroll
      for (int off = L::LPR / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if constexpr (kIsInt8<KV>) d = __fdiv_rn(d * ks[r], KV_QMAX);
      s[r] = t0 + r < t_end ? d : -INFINITY;
    }
    // the group's online softmax; a group whose rows are all past t_end in
    // this pass (and had none before) keeps m = -inf, l = 0, acc = 0
    float m_new = m;
#pragma unroll
    for (int r = 0; r < R; ++r) m_new = fmaxf(m_new, s[r]);
    const bool any = m_new != -INFINITY;
    const float corr = any ? expf(m - m_new) : 1.f;  // m = -inf -> 0
    float p[R], psum = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = s[r] == -INFINITY ? 0.f : expf(s[r] - m_new);
      psum += p[r];
      if constexpr (kIsInt8<KV>) p[r] = __fdiv_rn(p[r] * vs[r], KV_QMAX);
    }
    l = l * corr + psum;
#pragma unroll
    for (int k = 0; k < EPL; ++k) acc[k] *= corr;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float x[EPV];
        unpack<KV>(vr[r][j], x);
#pragma unroll
        for (int e = 0; e < EPV; ++e)
          acc[j * EPV + e] = fmaf(p[r], x[e], acc[j * EPV + e]);
      }
    }
    m = any ? m_new : m;
  }

  // merge the groups' states: (M, Lsum, O) over this split's tokens
  __shared__ float s_m[L::GROUPS], s_l[L::GROUPS], s_f[L::GROUPS];
  __shared__ float s_acc[L::GROUPS][D];
  if (lane == 0) {
    s_m[group] = m;
    s_l[group] = l;
  }
#pragma unroll
  for (int j = 0; j < VPL; ++j)
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      s_acc[group][(j * L::LPR + lane) * EPV + e] = acc[j * EPV + e];
  __syncthreads();
  float M = -INFINITY;  // finite: this split has a live token
#pragma unroll
  for (int g = 0; g < L::GROUPS; ++g) M = fmaxf(M, s_m[g]);
  if (threadIdx.x < L::GROUPS)
    s_f[threadIdx.x] = s_m[threadIdx.x] == -INFINITY ? 0.f : expf(s_m[threadIdx.x] - M);
  __syncthreads();
  float Lsum = 0.f;
#pragma unroll
  for (int g = 0; g < L::GROUPS; ++g) Lsum = fmaf(s_l[g], s_f[g], Lsum);
  float* part = partials + (bh * splits + split) * (D + 2);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float acc_d = 0.f;
#pragma unroll
    for (int g = 0; g < L::GROUPS; ++g) acc_d = fmaf(s_acc[g][d], s_f[g], acc_d);
    if (n_live == 1)
      o[d] = from_f<T>(acc_d / Lsum);
    else
      part[d] = acc_d;
  }
  if (n_live == 1) return;

  // several live splits: the last to finish merges them
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    part[D] = M;
    part[D + 1] = Lsum;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(tickets + bh, 1u) == (unsigned int)(n_live - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  merge_splits<T, D>(partials + bh * splits * (D + 2), n_live, o);
  if (threadIdx.x == 0) tickets[bh] = 0;  // ready for the next call
}

// KV = T for float pools, int8_t for int8 pools (then scales are non-null)
template <typename T, typename KV>
int launch_typed(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int32_t* tables,
                 const int32_t* cache_len, int cl_stride, void* out,
                 float* partials,
                 unsigned int* tickets, int B, int H, int KVH, int NB, int BS,
                 int P, int D, int splits, int pps, float scale,
                 cudaStream_t stream) {
  const dim3 grid(splits, H, B);
  const dim3 block(THREADS);
#define PAGED_LAUNCH(DIM)                                                  \
  paged_decode_kernel<T, KV, DIM><<<grid, block, 0, stream>>>(             \
      (const T*)q, (const KV*)k, (const KV*)v, ks, vs, tables, cache_len,  \
      cl_stride, (T*)out, partials, tickets, H, KVH, NB, BS, P, pps, scale)
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
           const void* cache_len, int cl_stride, void* out, void* partials,
           void* tickets,
           int B, int H, int KVH, int NB, int BS, int P, int D, int splits,
           int pps, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || BS <= 0 || P <= 0)
    return -1;
  // the splits cover the table row, none of them empty of pages
  if (splits < 1 || splits > MAX_SPLITS || pps < 1 || pps > MAX_SPLIT_PAGES
      || (int64_t)splits * pps < P || (int64_t)(splits - 1) * pps >= P)
    return -1;
  if (splits > 1 && (partials == nullptr || tickets == nullptr)) return -1;
  const int32_t* t = (const int32_t*)tables;
  const int32_t* cl = (const int32_t*)cache_len;
  float* part = (float*)partials;
  unsigned int* tick = (unsigned int*)tickets;
  cudaStream_t s = (cudaStream_t)stream;
#define TYPED(T)                                                            \
  launch_typed<T, typename std::conditional<INT8, int8_t, T>::type>(        \
      q, k, v, ks, vs, t, cl, cl_stride, out, part, tick, B, H, KVH, NB, BS, \
      P, D, splits, pps, scale, s)
  switch (dtype) {
    case DT_F32: return TYPED(float);
    case DT_BF16: return TYPED(__nv_bfloat16);
    case DT_F16: return TYPED(__half);
    default: return -1;
  }
#undef TYPED
}

}  // namespace

// cache_len: int32, row b's at cache_len[b * cl_stride] (stride 0: one for
// all); partials: f32 [B, H, splits, D + 2]; tickets: uint32 [B * H], zero
// between calls (each call returns them to zero); both may be null when
// splits == 1
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* cache_len, int cl_stride, void* out,
    void* partials, void* tickets, int B, int H, int KVH, int NB, int BS,
    int P, int D, int splits, int pps, float scale, void* stream) {
  return launch<false>(dtype, q, k_pool, v_pool, nullptr, nullptr, tables,
                       cache_len, cl_stride, out, partials, tickets, B, H, KVH,
                       NB, BS, P, D, splits, pps, scale, stream);
}

// q and out in the dtype code's type; pools int8; scale pools f32
// [KVH, NB, BS]
extern "C" int paged_decode_attention_int8_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* cache_len, int cl_stride, void* out, void* partials,
    void* tickets, int B, int H, int KVH, int NB, int BS, int P, int D,
    int splits, int pps, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return -1;
  return launch<true>(dtype, q, k_pool, v_pool, (const float*)k_scale,
                      (const float*)v_scale, tables, cache_len, cl_stride, out,
                      partials, tickets, B, H, KVH, NB, BS, P, D, splits, pps,
                      scale, stream);
}
