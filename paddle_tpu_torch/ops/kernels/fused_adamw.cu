// Fused AdamW update for Hopper (sm_90a): one multi-tensor launch per step.
//
// Replaces: paddle_tpu/ops/fused_adamw.py:_adamw_kernel (:111), launched by
// fused_adamw_update (pallas_call at :235) once per parameter.
//
// Per element of tensor t, in f32 and in the reference's op order
// (AdamW._update_param with _AdamBase._moments / _adam_delta):
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   p' = p * decay_f[t] - (lr_t[t] * m') / (sqrt(v') + eps_eff[t])
// then p' is written in p's dtype (round to nearest even), or, with the
// stochastic-rounding writeback, through the lowbias32 hash of the element's
// C-order flat index within its own tensor plus the table entry's base (0
// for a whole tensor; a shard's offset in its whole tensor, so a shard draws
// the bits its elements draw unsharded) and tensor t's two salts (the bits
// of _stochastic_round_bf16); non-finite values pass through. The
// scalar rows (lr_t, eps_eff, decay_f, skip) are a [T, 4] f32 device tensor
// built by the wrapper with the reference's expressions, the salts a [T, 2]
// int64 device tensor: nothing here reads the host. skip != 0 is the
// found-inf veto: the kernel returns before it writes anything, so p, m
// and v keep their bits. (1 - b1) and (1 - b2) arrive already rounded from
// Python doubles, as the reference forms them.
//
// Every product, sum, quotient and square root is an explicit _rn
// intrinsic: nvcc would otherwise contract b1 * m + c1 * g into an FMA and
// break bitwise parity with the op-by-op reference and the plain PyTorch
// version.
//
// Bound on this card: bytes. About 10 flops per element against 14 bytes
// (bf16 p/g/m/v) to 28 bytes (f32) moved, far below the H100's ~20 f32
// flops per byte. Design: p, m and v are updated in place, so each element
// is read once and written once. One launch covers every tensor of a step
// that shares the (p, g, m dtype, SR) instantiation: the tensor table
// (pointers, sizes, the first aligned element, the first chunk) travels in
// the launch's parameters (CUDA 12.1+ takes up to 32764 bytes), and each
// block takes one chunk of CHUNK elements of one tensor, found by a binary
// search over the first chunks, so a 32000 x 2048 embedding and a 2048-wide
// norm share one grid. Inside a chunk each thread moves VEC elements per
// access in 16-byte loads and stores (one for bf16, two for f32), UNROLL
// accesses at a time with every load issued before the first is used; a
// tensor whose p, g, m and v do not share a 16-byte phase, and the ragged
// head and tail of the others, take the element-wise path.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;            // elements per access
constexpr int UNROLL = 4;         // accesses per thread per chunk
constexpr int CHUNK = THREADS * VEC * UNROLL;  // elements per block
constexpr int MAX_TENSORS = 512;  // per launch (the table fits 32764 bytes)

struct TensorTable {
  void* p[MAX_TENSORS];
  const void* g[MAX_TENSORS];
  void* m[MAX_TENSORS];
  void* v[MAX_TENSORS];
  long long n[MAX_TENSORS];
  long long base[MAX_TENSORS];  // flat index of element 0 for the SR hash
  // elements before the first access whose p, g, m and v addresses are all
  // 16-byte aligned, or -1: the whole tensor element-wise
  int head[MAX_TENSORS];
  int chunk0[MAX_TENSORS + 1];  // first chunk of each tensor; [T]: the total
  int n_tensors;
};

struct Consts {
  float b1, c1, b2, c2;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <typename T>
struct Access {  // VEC elements of T, as 16-byte pieces
  static constexpr int PIECES = VEC * int(sizeof(T)) / 16;
  uint4 u[PIECES];
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, Access<T>& a) {
#pragma unroll
  for (int i = 0; i < Access<T>::PIECES; ++i)
    a.u[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Access<T>& a) {
#pragma unroll
  for (int i = 0; i < Access<T>::PIECES; ++i)
    __stcs(reinterpret_cast<uint4*>(p) + i, a.u[i]);
}

template <typename T>
__device__ __forceinline__ T& elem(Access<T>& a, int k) {
  return reinterpret_cast<T*>(a.u)[k];
}

// One element: returns p' (in p's type) and writes m', v' as f32.
template <typename P, bool SR>
__device__ __forceinline__ P update(float p32, float g32, float m32,
                                    float v32, uint32_t idx, const Consts& k,
                                    float lr_t, float eps_eff, float decay_f,
                                    uint32_t s0, uint32_t s1, float& m_new,
                                    float& v_new) {
  m_new = __fadd_rn(__fmul_rn(k.b1, m32), __fmul_rn(k.c1, g32));
  v_new = __fadd_rn(__fmul_rn(k.b2, v32), __fmul_rn(__fmul_rn(k.c2, g32), g32));
  const float delta = __fdiv_rn(__fmul_rn(lr_t, m_new),
                                __fadd_rn(__fsqrt_rn(v_new), eps_eff));
  const float nw = __fsub_rn(__fmul_rn(p32, decay_f), delta);
  if constexpr (SR) {
    uint32_t h = idx * 0x9E3779B9u + s0;
    h = (h ^ (h >> 16)) * 0x7FEB352Du;
    h = (h ^ (h >> 15)) * 0x846CA68Bu;
    h = (h ^ (h >> 16)) + s1;
    const uint32_t u = __float_as_uint(nw);
    const float r = __uint_as_float((u + (h & 0xFFFFu)) & 0xFFFF0000u);
    // r has no bits below the bf16 cut: the conversion is exact
    return from_f<P>(isfinite(nw) ? r : nw);
  } else {
    return from_f<P>(nw);
  }
}

template <typename P, typename G, typename M, bool SR>
__global__ void __launch_bounds__(THREADS)
adamw_multi_kernel(const __grid_constant__ TensorTable tab,
                   const float* __restrict__ scal,
                   const long long* __restrict__ salts, const Consts k) {
  // this chunk's tensor: the last t with chunk0[t] <= blockIdx.x
  const int c = blockIdx.x;
  int lo = 0, hi = tab.n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.chunk0[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int t = lo;
  const float* sc = scal + 4 * t;
  if (sc[3] != 0.f) return;  // found-inf veto: nothing is written
  const float lr_t = sc[0], eps_eff = sc[1], decay_f = sc[2];
  uint32_t s0 = 0, s1 = 0;
  if constexpr (SR) {
    const long long* st = salts + 2 * t;
    s0 = (uint32_t)st[0];
    s1 = (uint32_t)st[1];
  }
  P* __restrict__ p = (P*)tab.p[t];
  const G* __restrict__ g = (const G*)tab.g[t];
  M* __restrict__ m = (M*)tab.m[t];
  M* __restrict__ v = (M*)tab.v[t];
  const int64_t n = tab.n[t];
  const int64_t base = tab.base[t];
  const int head = tab.head[t];
  const int64_t local = c - tab.chunk0[t];

  auto scalar = [&](int64_t i) {
    float m_new, v_new;
    p[i] = update<P, SR>(to_f<P>(p[i]), to_f<G>(g[i]), to_f<M>(m[i]),
                         to_f<M>(v[i]), (uint32_t)(base + i), k, lr_t, eps_eff,
                         decay_f, s0, s1, m_new, v_new);
    m[i] = from_f<M>(m_new);
    v[i] = from_f<M>(v_new);
  };

  if (head < 0) {  // element-wise: chunk `local` is [local * CHUNK, +CHUNK)
    const int64_t end = min64(local * CHUNK + CHUNK, n);
    for (int64_t i = local * CHUNK + threadIdx.x; i < end; i += THREADS) scalar(i);
    return;
  }
  // chunk `local` is [head + local * CHUNK, +CHUNK) in VEC-element
  // accesses, plus the head [0, head) in chunk 0 and the ragged tail in the
  // last chunk, element-wise
  const int64_t begin = head + local * CHUNK;
  const int64_t end = min64(begin + CHUNK, n);
  const int64_t n_acc = end > begin ? (end - begin) / VEC : 0;
  Access<P> pa[UNROLL];
  Access<G> ga[UNROLL];
  Access<M> ma[UNROLL], va[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t a = threadIdx.x + u * THREADS;
    if (a < n_acc) {
      const int64_t i = begin + a * VEC;
      load_vec<P>(p + i, pa[u]);
      load_vec<G>(g + i, ga[u]);
      load_vec<M>(m + i, ma[u]);
      load_vec<M>(v + i, va[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t a = threadIdx.x + u * THREADS;
    if (a < n_acc) {
      const int64_t i = begin + a * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float m_new, v_new;
        elem<P>(pa[u], e) = update<P, SR>(
            to_f<P>(elem<P>(pa[u], e)), to_f<G>(elem<G>(ga[u], e)),
            to_f<M>(elem<M>(ma[u], e)), to_f<M>(elem<M>(va[u], e)),
            (uint32_t)(base + i + e), k, lr_t, eps_eff, decay_f, s0, s1, m_new,
            v_new);
        elem<M>(ma[u], e) = from_f<M>(m_new);
        elem<M>(va[u], e) = from_f<M>(v_new);
      }
      store_vec<P>(p + i, pa[u]);
      store_vec<M>(m + i, ma[u]);
      store_vec<M>(v + i, va[u]);
    }
  }
  if (local == 0)
    for (int64_t i = threadIdx.x; i < min64(head, n); i += THREADS) scalar(i);
  for (int64_t i = begin + n_acc * VEC + threadIdx.x; i < end; i += THREADS)
    scalar(i);
}

template <typename T>
bool aligned(const void* ptr, int64_t i) {
  return ((uintptr_t)ptr + i * (int64_t)sizeof(T)) % 16 == 0;
}

// table: T rows of (p, g, m, v, n, base) as int64, on the host
template <typename P, typename G, typename M, bool SR>
int launch(const long long* table, int T, const float* scal,
           const long long* salts, Consts k, cudaStream_t stream) {
  TensorTable tab;  // 28.7 KB, passed by value
  tab.n_tensors = T;
  int64_t chunks = 0;
  for (int t = 0; t < T; ++t) {
    const long long* row = table + 6 * t;
    tab.p[t] = (void*)row[0];
    tab.g[t] = (const void*)row[1];
    tab.m[t] = (void*)row[2];
    tab.v[t] = (void*)row[3];
    const int64_t n = row[4];
    if (n <= 0) return -1;
    tab.n[t] = n;
    tab.base[t] = row[5];
    int head = -1;
    for (int h = 0; h < VEC && head < 0; ++h)
      if (aligned<P>(tab.p[t], h) && aligned<G>(tab.g[t], h)
          && aligned<M>(tab.m[t], h) && aligned<M>(tab.v[t], h))
        head = h;
    tab.head[t] = head;
    tab.chunk0[t] = (int)chunks;
    const int64_t body = head < 0 ? n : n - head;
    chunks += body > 0 ? (body + CHUNK - 1) / CHUNK : 1;
    if (chunks >= (1LL << 31)) return -1;
  }
  tab.chunk0[T] = (int)chunks;
  const int grid = tab.chunk0[T];
  adamw_multi_kernel<P, G, M, SR><<<grid, THREADS, 0, stream>>>(tab, scal, salts, k);
  return (int)cudaGetLastError();
}

template <typename P, typename G>
int by_moment(int m_dt, int sr, const long long* table, int T,
              const float* scal, const long long* salts, Consts k,
              cudaStream_t s) {
  if (sr) {
    if constexpr (std::is_same<P, __nv_bfloat16>::value) {
      if (m_dt == DT_F32)
        return launch<P, G, float, true>(table, T, scal, salts, k, s);
      if (m_dt == DT_BF16)
        return launch<P, G, __nv_bfloat16, true>(table, T, scal, salts, k, s);
    }
    return -1;  // the SR writeback needs a bf16 param
  }
  if (m_dt == DT_F32)
    return launch<P, G, float, false>(table, T, scal, salts, k, s);
  if (m_dt == DT_BF16)
    return launch<P, G, __nv_bfloat16, false>(table, T, scal, salts, k, s);
  return -1;
}

template <typename P>
int by_grad(int g_dt, int m_dt, int sr, const long long* table, int T,
            const float* scal, const long long* salts, Consts k,
            cudaStream_t s) {
  if (g_dt == DT_F32)
    return by_moment<P, float>(m_dt, sr, table, T, scal, salts, k, s);
  if (g_dt == DT_BF16)
    return by_moment<P, __nv_bfloat16>(m_dt, sr, table, T, scal, salts, k, s);
  return -1;
}

}  // namespace

// table: T rows of six int64 (p, g, m, v data pointers, numel, SR index
// base), T in
// [1, 512]; scalars: f32 [T, 4] device; salts: int64 [T, 2] device (SR)
extern "C" int fused_adamw_multi_launch(int p_dt, int g_dt, int m_dt, int sr,
                                        const void* table, int T,
                                        const void* scalars, const void* salts,
                                        float b1, float c1, float b2, float c2,
                                        void* stream) {
  if (T < 1 || T > MAX_TENSORS) return -1;
  const long long* tb = (const long long*)table;
  const float* scal = (const float*)scalars;
  const long long* sl = (const long long*)salts;
  const Consts k{b1, c1, b2, c2};
  cudaStream_t s = (cudaStream_t)stream;
  if (p_dt == DT_F32)
    return by_grad<float>(g_dt, m_dt, sr, tb, T, scal, sl, k, s);
  if (p_dt == DT_BF16)
    return by_grad<__nv_bfloat16>(g_dt, m_dt, sr, tb, T, scal, sl, k, s);
  return -1;
}
