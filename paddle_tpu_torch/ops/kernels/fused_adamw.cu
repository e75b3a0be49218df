// Fused AdamW update for Hopper (sm_90a): one streamed pass per parameter.
//
// Replaces: paddle_tpu/ops/fused_adamw.py:_adamw_kernel (:111), launched by
// fused_adamw_update (pallas_call at :235).
//
// Per element, in f32 and in the reference's op order (AdamW._update_param
// with _AdamBase._moments / _adam_delta):
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   p' = p * decay_f - (lr_t * m') / (sqrt(v') + eps_eff)
// then p' is written in p's dtype (round to nearest even), or, with the
// stochastic-rounding writeback, through the lowbias32 hash of the element's
// C-order flat index within its own parameter and the two salts (the bits of
// _stochastic_round_bf16); non-finite values pass through. The scalar
// prologue (lr_t, eps_eff, decay_f, skip) is a 4-float device tensor built
// by the wrapper with the reference's expressions, the salts a 2-int64
// device tensor: nothing here reads the host. skip != 0 is the found-inf
// veto: the kernel returns before it writes anything, so p, m and v keep
// their bits. (1 - b1) and (1 - b2) arrive already rounded from Python
// doubles, as the reference forms them.
//
// Every product, sum, quotient and square root is an explicit _rn
// intrinsic: nvcc would otherwise contract b1 * m + c1 * g into an FMA and
// break bitwise parity with the op-by-op reference and the plain PyTorch
// version.
//
// Bound on this card: bytes. About 10 flops per element against 14 bytes
// (bf16 p/g/m/v) to 28 bytes (f32) moved, far below the H100's ~20 f32
// flops per byte. Design: p, m and v are updated in place, so each element
// is read once and written once, and the pass streams with a grid-stride
// loop over the flat array (consecutive threads on consecutive elements,
// so every load and store coalesces). No padding: the flat index is the
// loop index.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename P, typename G, typename M, bool SR>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(P* __restrict__ p, const G* __restrict__ g, M* __restrict__ m,
             M* __restrict__ v, const float* __restrict__ scal,
             const long long* __restrict__ salts, int64_t n, float b1,
             float c1, float b2, float c2) {
  if (scal[3] != 0.f) return;  // found-inf veto: nothing is written
  const float lr_t = scal[0], eps_eff = scal[1], decay_f = scal[2];
  uint32_t s0 = 0, s1 = 0;
  if constexpr (SR) {
    s0 = (uint32_t)salts[0];
    s1 = (uint32_t)salts[1];
  }
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float g32 = to_f<G>(g[i]);
    const float m_new =
        __fadd_rn(__fmul_rn(b1, to_f<M>(m[i])), __fmul_rn(c1, g32));
    const float v_new = __fadd_rn(__fmul_rn(b2, to_f<M>(v[i])),
                                  __fmul_rn(__fmul_rn(c2, g32), g32));
    const float delta = __fdiv_rn(__fmul_rn(lr_t, m_new),
                                  __fadd_rn(__fsqrt_rn(v_new), eps_eff));
    const float nw = __fsub_rn(__fmul_rn(to_f<P>(p[i]), decay_f), delta);
    if constexpr (SR) {
      uint32_t h = (uint32_t)i * 0x9E3779B9u + s0;
      h = (h ^ (h >> 16)) * 0x7FEB352Du;
      h = (h ^ (h >> 15)) * 0x846CA68Bu;
      h = (h ^ (h >> 16)) + s1;
      const uint32_t u = __float_as_uint(nw);
      const float r = __uint_as_float((u + (h & 0xFFFFu)) & 0xFFFF0000u);
      // r has no bits below the bf16 cut: the conversion is exact
      p[i] = from_f<P>(isfinite(nw) ? r : nw);
    } else {
      p[i] = from_f<P>(nw);
    }
    m[i] = from_f<M>(m_new);
    v[i] = from_f<M>(v_new);
  }
}

template <typename P, typename G, typename M, bool SR>
int launch(void* p, const void* g, void* m, void* v, const float* scal,
           const long long* salts, int64_t n, float b1, float c1, float b2,
           float c2, cudaStream_t stream) {
  // enough blocks to fill every SM several times over; the grid-stride
  // loop covers the rest
  const int64_t want = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  adamw_kernel<P, G, M, SR><<<blocks, THREADS, 0, stream>>>(
      (P*)p, (const G*)g, (M*)m, (M*)v, scal, salts, n, b1, c1, b2, c2);
  return (int)cudaGetLastError();
}

template <typename P, typename G>
int by_moment(int m_dt, int sr, void* p, const void* g, void* m, void* v,
              const float* scal, const long long* salts, int64_t n, float b1,
              float c1, float b2, float c2, cudaStream_t s) {
  if (sr) {
    if constexpr (std::is_same<P, __nv_bfloat16>::value) {
      if (m_dt == DT_F32)
        return launch<P, G, float, true>(p, g, m, v, scal, salts, n, b1, c1,
                                         b2, c2, s);
      if (m_dt == DT_BF16)
        return launch<P, G, __nv_bfloat16, true>(p, g, m, v, scal, salts, n,
                                                 b1, c1, b2, c2, s);
    }
    return -1;  // the SR writeback needs a bf16 param
  }
  if (m_dt == DT_F32)
    return launch<P, G, float, false>(p, g, m, v, scal, salts, n, b1, c1, b2,
                                      c2, s);
  if (m_dt == DT_BF16)
    return launch<P, G, __nv_bfloat16, false>(p, g, m, v, scal, salts, n, b1,
                                              c1, b2, c2, s);
  return -1;
}

template <typename P>
int by_grad(int g_dt, int m_dt, int sr, void* p, const void* g, void* m,
            void* v, const float* scal, const long long* salts, int64_t n,
            float b1, float c1, float b2, float c2, cudaStream_t s) {
  if (g_dt == DT_F32)
    return by_moment<P, float>(m_dt, sr, p, g, m, v, scal, salts, n, b1, c1,
                               b2, c2, s);
  if (g_dt == DT_BF16)
    return by_moment<P, __nv_bfloat16>(m_dt, sr, p, g, m, v, scal, salts, n,
                                       b1, c1, b2, c2, s);
  return -1;
}

}  // namespace

extern "C" int fused_adamw_launch(int p_dt, int g_dt, int m_dt, int sr,
                                  void* p, const void* g, void* m, void* v,
                                  const void* scalars, const void* salts,
                                  long long n, float b1, float c1, float b2,
                                  float c2, void* stream) {
  if (n <= 0) return n == 0 ? 0 : -1;
  const float* scal = (const float*)scalars;
  const long long* sl = (const long long*)salts;
  cudaStream_t s = (cudaStream_t)stream;
  if (p_dt == DT_F32)
    return by_grad<float>(g_dt, m_dt, sr, p, g, m, v, scal, sl, n, b1, c1, b2,
                          c2, s);
  if (p_dt == DT_BF16)
    return by_grad<__nv_bfloat16>(g_dt, m_dt, sr, p, g, m, v, scal, sl, n, b1,
                                  c1, b2, c2, s);
  return -1;
}
