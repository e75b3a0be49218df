// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_bwd_dq_kernel (:172) and
// _bwd_dkv_kernel (:215), launched by _flash_bwd (pallas_call at :274 and
// :296).
//
// Both recompute the probabilities from the forward's f32 logsumexp instead
// of storing them: p = exp(scale * q.k - lse), zeroed where masked (so a
// fully masked row, lse = -1e30, contributes nothing), and
// dS = p * (dP - delta) * scale with dP = dO.v and delta = sum(out * dO)
// (f32, computed by the wrapper, as the reference does outside its
// kernels). The dQ kernel then accumulates dQ = sum_k dS @ K; the dK/dV
// kernel accumulates dV = sum_q P^T @ dO and dK = sum_q dS^T @ Q. The
// reference's rounding points are kept: dS is rounded to K's dtype before
// dS @ K and to Q's dtype before dS^T @ Q, P to dO's dtype before P^T @ dO,
// and the outputs are written in the input dtype from f32 accumulators.
// Causal tiles that the reference's `live` predicate skips (offset Sk - Sq)
// are skipped here too. GQA: K/V are read at kv head h / (H / HKV) (the
// reference's repeat, without copying); dK/dV are written per query head,
// [B, Sk, H, D], and the wrapper sums each group in f32.
//
// Bound on this card: operations. Per head the dQ kernel does three
// Sq x Sk x D products and the dK/dV kernel four (halved when causal), on
// 2-byte inputs read once per tile: far above the ~295 flops per byte where
// the H100 turns compute-bound. Design against that: nothing of size
// Sq x Sk reaches device memory. The TPU kernels' sequential grid axis
// becomes a loop inside one block (nothing carries between blocks on this
// card): the dQ kernel has one block per (64-row query tile, head, batch)
// and loops over key tiles with dQ in registers; the dK/dV kernel has one
// block per (key tile, head, batch) and loops over query tiles with dK and
// dV in registers, so no atomics are needed. bf16/f16 at head_dim 64 and
// 128 run every product on the tensor cores (mma.sync.m16n8k16, f32
// accumulate; score accumulators become A fragments without leaving
// registers, as in the forward). f32 inputs, and bf16/f16 at head_dim 256
// (whose dK + dV accumulators do not fit a warp's registers), run on the
// CUDA cores. Staged tile loads (cp.async/TMA) and wgmma are the next step.

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* o1;            // dQ, or dK
  void* o2;            // unused, or dV
  int H, HKV, Sq, Sk;
  // (batch, seq, head) strides in elements of q, k, v, dout, o1, o2
  int64_t st[18];
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// ---------------------------------------------------------------------------
// CUDA-core kernels (f32; bf16/f16 at head_dim 256). 256 threads as 16 x 16:
// thread (ty, tx) owns rows ty*RM .. ty*RM+RM-1 of the block's tile, score
// columns tx + 16j and output columns tx + 16c. Tiles sit in shared memory
// as f32 with rows padded by one element (no bank conflicts on column
// walks).
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;

template <int D, int BQ, int BK>
constexpr int dq_smem_floats() {
  // Q, dO [BQ][D+1]; K, V [BK][D+1]; dS [BQ][BK+1]
  return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1);
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS) dq_scalar_kernel(BwdArgs a) {
  constexpr int RM = BQ / 16, CN = BK / 16, DN = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + BQ * (D + 1);
  float* Ks = Os + BQ * (D + 1);
  float* Vs = Ks + BK * (D + 1);
  float* Ss = Vs + BK * (D + 1);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.HKV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = a.Sk - a.Sq;
  const int64_t* st = a.st;
  const T* qb = (const T*)a.q + b * st[0] + h * st[2];
  const T* kb = (const T*)a.k + b * st[3] + hk * st[5];
  const T* vb = (const T*)a.v + b * st[6] + hk * st[8];
  const T* ob = (const T*)a.dout + b * st[9] + h * st[11];

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const bool in = q0 + r < a.Sq;
    Qs[r * (D + 1) + c] = in ? to_f<T>(qb[(q0 + r) * st[1] + c]) : 0.f;
    Os[r * (D + 1) + c] = in ? to_f<T>(ob[(q0 + r) * st[10] + c]) : 0.f;
  }
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
  float lse_i[RM], del_i[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    lse_i[i] = qi < a.Sq ? a.lse[row0 + qi] : 0.f;
    del_i[i] = qi < a.Sq ? a.delta[row0 + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) {  // the reference's `live`: skip tiles above the diagonal
    const int last = min(q0 + BQ, a.Sq) - 1 + off;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < a.Sk;
      Ks[r * (D + 1) + c] = in ? to_f<T>(kb[(k0 + r) * st[4] + c]) : 0.f;
      Vs[r * (D + 1) + c] = in ? to_f<T>(vb[(k0 + r) * st[7] + c]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RM], oa[RM], kk[CN], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qa[i] = Qs[(ty * RM + i) * (D + 1) + d];
        oa[i] = Os[(ty * RM + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        kk[j] = Ks[(tx + 16 * j) * (D + 1) + d];
        vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = qi < a.Sq && kj < a.Sk && (!a.causal || qi + off >= kj);
        const float p = ok ? expf(s[i][j] * a.scale - lse_i[i]) : 0.f;
        const float ds = p * (dp[i][j] - del_i[i]) * a.scale;
        Ss[(ty * RM + i) * (BK + 1) + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sa[RM], kv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) sa[i] = Ss[(ty * RM + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < DN; ++c) kv[c] = Ks[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DN; ++c) acc[i][c] = fmaf(sa[i], kv[c], acc[i][c]);
    }
    __syncthreads();  // before the next tile overwrites K, V and dS
  }

  T* dqb = (T*)a.o1 + b * st[12] + h * st[14];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < DN; ++c) dqb[qi * st[13] + tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <int D, int BK, int BQ>
constexpr int dkv_smem_floats() {
  // K, V [BK][D+1]; Q, dO [BQ][D+1]; P^T, dS^T [BK][BQ+1]; lse, delta [BQ]
  return 2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ;
}

template <typename T, int D, int BK, int BQ>
__global__ void __launch_bounds__(THREADS) dkv_scalar_kernel(BwdArgs a) {
  constexpr int RM = BK / 16, CN = BQ / 16, DN = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * (D + 1);
  float* Qs = Vs + BK * (D + 1);
  float* Os = Qs + BQ * (D + 1);
  float* Ps = Os + BQ * (D + 1);
  float* Ds = Ps + BK * (BQ + 1);
  float* Ls = Ds + BK * (BQ + 1);
  float* Es = Ls + BQ;

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.HKV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = a.Sk - a.Sq;
  const int64_t* st = a.st;
  const T* qb = (const T*)a.q + b * st[0] + h * st[2];
  const T* kb = (const T*)a.k + b * st[3] + hk * st[5];
  const T* vb = (const T*)a.v + b * st[6] + hk * st[8];
  const T* ob = (const T*)a.dout + b * st[9] + h * st[11];
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;

  for (int idx = tid; idx < BK * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const bool in = k0 + r < a.Sk;
    Ks[r * (D + 1) + c] = in ? to_f<T>(kb[(k0 + r) * st[4] + c]) : 0.f;
    Vs[r * (D + 1) + c] = in ? to_f<T>(vb[(k0 + r) * st[7] + c]) : 0.f;
  }
  float dk[RM][DN], dv[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int nq = (a.Sq + BQ - 1) / BQ;
  // causal: the first query tile whose last row sees key k0
  const int first = a.causal ? max(0, k0 - off) / BQ : 0;
  for (int iq = first; iq < nq; ++iq) {
    const int qs0 = iq * BQ;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BQ * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const bool in = qs0 + r < a.Sq;
      Qs[r * (D + 1) + c] = in ? to_f<T>(qb[(qs0 + r) * st[1] + c]) : 0.f;
      Os[r * (D + 1) + c] = in ? to_f<T>(ob[(qs0 + r) * st[10] + c]) : 0.f;
    }
    for (int idx = tid; idx < BQ; idx += THREADS) {
      const bool in = qs0 + idx < a.Sq;
      Ls[idx] = in ? a.lse[row0 + qs0 + idx] : 0.f;
      Es[idx] = in ? a.delta[row0 + qs0 + idx] : 0.f;
    }
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[RM], va[RM], qq[CN], oo[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        ka[i] = Ks[(ty * RM + i) * (D + 1) + d];
        va[i] = Vs[(ty * RM + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        qq[j] = Qs[(tx + 16 * j) * (D + 1) + d];
        oo[j] = Os[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(ka[i], qq[j], s[i][j]);
          dp[i][j] = fmaf(va[i], oo[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kj = k0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int ql = tx + 16 * j, qi = qs0 + ql;
        const bool ok = qi < a.Sq && kj < a.Sk && (!a.causal || qi + off >= kj);
        const float p = ok ? expf(s[i][j] * a.scale - Ls[ql]) : 0.f;
        const float ds = p * (dp[i][j] - Es[ql]) * a.scale;
        Ps[(ty * RM + i) * (BQ + 1) + ql] = round_to<T>(p);
        Ds[(ty * RM + i) * (BQ + 1) + ql] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < BQ; ++jj) {
      float pa[RM], da[RM], oo[DN], qq[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        pa[i] = Ps[(ty * RM + i) * (BQ + 1) + jj];
        da[i] = Ds[(ty * RM + i) * (BQ + 1) + jj];
      }
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        oo[c] = Os[jj * (D + 1) + tx + 16 * c];
        qq[c] = Qs[jj * (D + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DN; ++c) {
          dv[i][c] = fmaf(pa[i], oo[c], dv[i][c]);
          dk[i][c] = fmaf(da[i], qq[c], dk[i][c]);
        }
    }
  }

  T* dkb = (T*)a.o1 + b * st[12] + h * st[14];
  T* dvb = (T*)a.o2 + b * st[15] + h * st[17];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kj = k0 + ty * RM + i;
    if (kj >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      dkb[kj * st[13] + tx + 16 * c] = from_f<T>(dk[i][c]);
      dvb[kj * st[16] + tx + 16 * c] = from_f<T>(dv[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16/f16, head_dim 64 and 128): 4 warps, each owning
// 16 rows of the block's 64-row tile. Fragment layouts are PTX's m16n8k16:
// for lane = 4g + t an accumulator holds rows g and g+8 at columns 2t, 2t+1
// of each 8-wide n-tile, which is the A-operand layout of the next product,
// so P and dS go from accumulators into A fragments in registers (rounded to
// the input dtype there, the reference's rounding points). Tiles sit in
// shared memory in the input dtype with rows padded by 8 elements.
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_TILE = 64;  // query and key rows per tile

template <int D>
constexpr int dq_mma_smem_bytes() {
  return 4 * MMA_TILE * (D + 8) * 2;  // Q, dO, K, V
}

template <int D>
constexpr int dkv_mma_smem_bytes() {
  return 4 * MMA_TILE * (D + 8) * 2 + 2 * MMA_TILE * 4;  // + lse, delta
}

// rows [r_begin, r_begin + 64) of a strided [S, D] slice into a padded
// shared tile, 16 bytes a thread; rows past `rows` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ss,
                                          int r_begin, int rows) {
  constexpr int LD = D + 8, VEC = 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int idx = threadIdx.x; idx < MMA_TILE * (D / VEC);
       idx += MMA_WARPS * 32) {
    const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        r_begin + r < rows
            ? *reinterpret_cast<const uint4*>(src + (r_begin + r) * ss + c)
            : zero;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(MMA_WARPS * 32) dq_mma_kernel(BwdArgs a) {
  constexpr int BK = MMA_TILE, LD = D + 8, NS = BK / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Os = Qs + MMA_TILE * LD;
  T* Ks = Os + MMA_TILE * LD;
  T* Vs = Ks + BK * LD;

  const int q0 = blockIdx.x * MMA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.HKV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = a.Sk - a.Sq;
  const int r0 = warp * 16;
  const int row_a = q0 + r0 + g, row_b = row_a + 8;
  const int64_t* st = a.st;
  const T* qb = (const T*)a.q + b * st[0] + h * st[2];
  const T* kb = (const T*)a.k + b * st[3] + hk * st[5];
  const T* vb = (const T*)a.v + b * st[6] + hk * st[8];
  const T* ob = (const T*)a.dout + b * st[9] + h * st[11];

  load_tile<T, D>(Qs, qb, st[1], q0, a.Sq);
  load_tile<T, D>(Os, ob, st[10], q0, a.Sq);
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
  const float lse_a = row_a < a.Sq ? a.lse[row0 + row_a] : 0.f;
  const float lse_b = row_b < a.Sq ? a.lse[row0 + row_b] : 0.f;
  const float del_a = row_a < a.Sq ? a.delta[row0 + row_a] : 0.f;
  const float del_b = row_b < a.Sq ? a.delta[row0 + row_b] : 0.f;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) {
    const int last = min(q0 + MMA_TILE, a.Sq) - 1 + off;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<T, D>(Ks, kb, st[4], k0, a.Sk);
    load_tile<T, D>(Vs, vb, st[7], k0, a.Sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BK keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      const uint32_t a0 = ld_pair(Qs + (r0 + g) * LD + c);
      const uint32_t a1 = ld_pair(Qs + (r0 + g + 8) * LD + c);
      const uint32_t a2 = ld_pair(Qs + (r0 + g) * LD + c + 8);
      const uint32_t a3 = ld_pair(Qs + (r0 + g + 8) * LD + c + 8);
      const uint32_t o0 = ld_pair(Os + (r0 + g) * LD + c);
      const uint32_t o1 = ld_pair(Os + (r0 + g + 8) * LD + c);
      const uint32_t o2 = ld_pair(Os + (r0 + g) * LD + c + 8);
      const uint32_t o3 = ld_pair(Os + (r0 + g + 8) * LD + c + 8);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const T* kr = Ks + (n * 8 + g) * LD + c;
        mma16816<T>(s[n], a0, a1, a2, a3, ld_pair(kr), ld_pair(kr + 8));
        const T* vr = Vs + (n * 8 + g) * LD + c;
        mma16816<T>(dp[n], o0, o1, o2, o3, ld_pair(vr), ld_pair(vr + 8));
      }
    }

    // dS into s; element e of n-tile n sits at row (e < 2 ? a : b),
    // key k0 + 8n + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        const int qi = e < 2 ? row_a : row_b;
        const bool ok = qi < a.Sq && kj < a.Sk && (!a.causal || qi + off >= kj);
        const float p =
            ok ? expf(s[n][e] * a.scale - (e < 2 ? lse_a : lse_b)) : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? del_a : del_b)) * a.scale;
      }
    }

    // dQ += dS K: dS's accumulators for keys 16j..16j+15 are the A
    // fragment (rounded to K's dtype); K is B with keys along k
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a0 = pack2f<T>(s[2 * j][0], s[2 * j][1]);
      const uint32_t a1 = pack2f<T>(s[2 * j][2], s[2 * j][3]);
      const uint32_t a2 = pack2f<T>(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t a3 = pack2f<T>(s[2 * j + 1][2], s[2 * j + 1][3]);
      const T* kc = Ks + (j * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const T* kr = kc + n * 8;
        mma16816<T>(acc[n], a0, a1, a2, a3, pack2<T>(kr[0], kr[LD]),
                    pack2<T>(kr[8 * LD], kr[9 * LD]));
      }
    }
  }

  T* dqb = (T*)a.o1 + b * st[12] + h * st[14];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_a < a.Sq)
      *reinterpret_cast<uint32_t*>(dqb + row_a * st[13] + c) =
          pack2f<T>(acc[n][0], acc[n][1]);
    if (row_b < a.Sq)
      *reinterpret_cast<uint32_t*>(dqb + row_b * st[13] + c) =
          pack2f<T>(acc[n][2], acc[n][3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(MMA_WARPS * 32) dkv_mma_kernel(BwdArgs a) {
  constexpr int BQ = MMA_TILE, QC = 32;  // query rows per tile, per pass
  constexpr int LD = D + 8, NS = QC / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + MMA_TILE * LD;
  T* Qs = Vs + MMA_TILE * LD;
  T* Os = Qs + BQ * LD;
  float* Ls = reinterpret_cast<float*>(Os + BQ * LD);
  float* Es = Ls + BQ;

  const int k0 = blockIdx.x * MMA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.HKV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = a.Sk - a.Sq;
  const int r0 = warp * 16;
  const int key_a = k0 + r0 + g, key_b = key_a + 8;
  const int64_t* st = a.st;
  const T* qb = (const T*)a.q + b * st[0] + h * st[2];
  const T* kb = (const T*)a.k + b * st[3] + hk * st[5];
  const T* vb = (const T*)a.v + b * st[6] + hk * st[8];
  const T* ob = (const T*)a.dout + b * st[9] + h * st[11];
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;

  load_tile<T, D>(Ks, kb, st[4], k0, a.Sk);
  load_tile<T, D>(Vs, vb, st[7], k0, a.Sk);

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int nq = (a.Sq + BQ - 1) / BQ;
  const int first = a.causal ? max(0, k0 - off) / BQ : 0;
  for (int iq = first; iq < nq; ++iq) {
    const int qs0 = iq * BQ;
    __syncthreads();  // the previous query tile is no longer read
    load_tile<T, D>(Qs, qb, st[1], qs0, a.Sq);
    load_tile<T, D>(Os, ob, st[10], qs0, a.Sq);
    for (int idx = threadIdx.x; idx < BQ; idx += MMA_WARPS * 32) {
      const bool in = qs0 + idx < a.Sq;
      Ls[idx] = in ? a.lse[row0 + qs0 + idx] : 0.f;
      Es[idx] = in ? a.delta[row0 + qs0 + idx] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int ch = 0; ch < BQ / QC; ++ch) {
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x QC queries
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        const uint32_t a0 = ld_pair(Ks + (r0 + g) * LD + c);
        const uint32_t a1 = ld_pair(Ks + (r0 + g + 8) * LD + c);
        const uint32_t a2 = ld_pair(Ks + (r0 + g) * LD + c + 8);
        const uint32_t a3 = ld_pair(Ks + (r0 + g + 8) * LD + c + 8);
        const uint32_t v0 = ld_pair(Vs + (r0 + g) * LD + c);
        const uint32_t v1 = ld_pair(Vs + (r0 + g + 8) * LD + c);
        const uint32_t v2 = ld_pair(Vs + (r0 + g) * LD + c + 8);
        const uint32_t v3 = ld_pair(Vs + (r0 + g + 8) * LD + c + 8);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const T* qr = Qs + (ch * QC + n * 8 + g) * LD + c;
          mma16816<T>(s[n], a0, a1, a2, a3, ld_pair(qr), ld_pair(qr + 8));
          const T* orow = Os + (ch * QC + n * 8 + g) * LD + c;
          mma16816<T>(dp[n], v0, v1, v2, v3, ld_pair(orow), ld_pair(orow + 8));
        }
      }

      // P^T into s, dS^T into dp; element e of n-tile n sits at key
      // (e < 2 ? a : b), query ch*QC + 8n + 2t + (e & 1) of the tile
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = ch * QC + n * 8 + 2 * t + (e & 1), qi = qs0 + ql;
          const int kj = e < 2 ? key_a : key_b;
          const bool ok =
              qi < a.Sq && kj < a.Sk && (!a.causal || qi + off >= kj);
          const float p = ok ? expf(s[n][e] * a.scale - Ls[ql]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Es[ql]) * a.scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, queries along k (16 per step)
#pragma unroll
      for (int j = 0; j < QC / 16; ++j) {
        const uint32_t p0 = pack2f<T>(s[2 * j][0], s[2 * j][1]);
        const uint32_t p1 = pack2f<T>(s[2 * j][2], s[2 * j][3]);
        const uint32_t p2 = pack2f<T>(s[2 * j + 1][0], s[2 * j + 1][1]);
        const uint32_t p3 = pack2f<T>(s[2 * j + 1][2], s[2 * j + 1][3]);
        const uint32_t d0 = pack2f<T>(dp[2 * j][0], dp[2 * j][1]);
        const uint32_t d1 = pack2f<T>(dp[2 * j][2], dp[2 * j][3]);
        const uint32_t d2 = pack2f<T>(dp[2 * j + 1][0], dp[2 * j + 1][1]);
        const uint32_t d3 = pack2f<T>(dp[2 * j + 1][2], dp[2 * j + 1][3]);
        const T* oc = Os + (ch * QC + j * 16 + 2 * t) * LD + g;
        const T* qc = Qs + (ch * QC + j * 16 + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const T* orow = oc + n * 8;
          mma16816<T>(dv[n], p0, p1, p2, p3, pack2<T>(orow[0], orow[LD]),
                      pack2<T>(orow[8 * LD], orow[9 * LD]));
          const T* qr = qc + n * 8;
          mma16816<T>(dk[n], d0, d1, d2, d3, pack2<T>(qr[0], qr[LD]),
                      pack2<T>(qr[8 * LD], qr[9 * LD]));
        }
      }
    }
  }

  T* dkb = (T*)a.o1 + b * st[12] + h * st[14];
  T* dvb = (T*)a.o2 + b * st[15] + h * st[17];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (key_a < a.Sk) {
      *reinterpret_cast<uint32_t*>(dkb + key_a * st[13] + c) =
          pack2f<T>(dk[n][0], dk[n][1]);
      *reinterpret_cast<uint32_t*>(dvb + key_a * st[16] + c) =
          pack2f<T>(dv[n][0], dv[n][1]);
    }
    if (key_b < a.Sk) {
      *reinterpret_cast<uint32_t*>(dkb + key_b * st[13] + c) =
          pack2f<T>(dk[n][2], dk[n][3]);
      *reinterpret_cast<uint32_t*>(dvb + key_b * st[16] + c) =
          pack2f<T>(dv[n][2], dv[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
int configure(K kernel, int smem) {
  // callers keep one `static bool` per instantiation, so this runs once
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int D, int BQ, int BK>
int launch_dq_scalar(const BwdArgs& a, int B, cudaStream_t s) {
  constexpr int SMEM = dq_smem_floats<D, BQ, BK>() * int(sizeof(float));
  static bool done = false;
  if (!done) {
    if (int e = configure(dq_scalar_kernel<T, D, BQ, BK>, SMEM)) return e;
    done = true;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  dq_scalar_kernel<T, D, BQ, BK><<<grid, THREADS, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D, int BK, int BQ>
int launch_dkv_scalar(const BwdArgs& a, int B, cudaStream_t s) {
  constexpr int SMEM = dkv_smem_floats<D, BK, BQ>() * int(sizeof(float));
  static bool done = false;
  if (!done) {
    if (int e = configure(dkv_scalar_kernel<T, D, BK, BQ>, SMEM)) return e;
    done = true;
  }
  const dim3 grid((a.Sk + BK - 1) / BK, a.H, B);
  dkv_scalar_kernel<T, D, BK, BQ><<<grid, THREADS, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq_mma(const BwdArgs& a, int B, cudaStream_t s) {
  constexpr int SMEM = dq_mma_smem_bytes<D>();
  static bool done = false;
  if (!done) {
    if (int e = configure(dq_mma_kernel<T, D>, SMEM)) return e;
    done = true;
  }
  const dim3 grid((a.Sq + MMA_TILE - 1) / MMA_TILE, a.H, B);
  dq_mma_kernel<T, D><<<grid, MMA_WARPS * 32, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_mma(const BwdArgs& a, int B, cudaStream_t s) {
  constexpr int SMEM = dkv_mma_smem_bytes<D>();
  static bool done = false;
  if (!done) {
    if (int e = configure(dkv_mma_kernel<T, D>, SMEM)) return e;
    done = true;
  }
  const dim3 grid((a.Sk + MMA_TILE - 1) / MMA_TILE, a.H, B);
  dkv_mma_kernel<T, D><<<grid, MMA_WARPS * 32, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// tile sizes of the CUDA-core kernels by head_dim: the f32 tiles of one
// block stay under the 227 KB of shared memory and the accumulators under
// 64 registers a thread
template <typename T>
int launch_typed(bool dkv, const BwdArgs& a, int B, int D, cudaStream_t s) {
  if constexpr (!std::is_same<T, float>::value) {
    if (D == 64)
      return dkv ? launch_dkv_mma<T, 64>(a, B, s) : launch_dq_mma<T, 64>(a, B, s);
    if (D == 128)
      return dkv ? launch_dkv_mma<T, 128>(a, B, s)
                 : launch_dq_mma<T, 128>(a, B, s);
  }
  switch (D) {
    case 64:
      return dkv ? launch_dkv_scalar<T, 64, 64, 64>(a, B, s)
                 : launch_dq_scalar<T, 64, 64, 64>(a, B, s);
    case 128:
      return dkv ? launch_dkv_scalar<T, 128, 64, 64>(a, B, s)
                 : launch_dq_scalar<T, 128, 64, 64>(a, B, s);
    case 256:
      return dkv ? launch_dkv_scalar<T, 256, 32, 32>(a, B, s)
                 : launch_dq_scalar<T, 256, 64, 32>(a, B, s);
    default:
      return -1;
  }
}

int launch(bool dkv, int dtype, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* o1,
           void* o2, int B, int H, int HKV, int Sq, int Sk, int D,
           const long long* strides, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || HKV <= 0 || H % HKV != 0 || Sq <= 0 || Sk <= 0)
    return -1;
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.o1 = o1;
  a.o2 = o2;
  a.H = H;
  a.HKV = HKV;
  a.Sq = Sq;
  a.Sk = Sk;
  for (int i = 0; i < 18; ++i) a.st[i] = strides[i];
  a.scale = scale;
  a.causal = causal;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch_typed<float>(dkv, a, B, D, s);
    case DT_BF16:
      return launch_typed<__nv_bfloat16>(dkv, a, B, D, s);
    case DT_F16:
      return launch_typed<__half>(dkv, a, B, D, s);
    default:
      return -1;
  }
}

}  // namespace

extern "C" int flash_attention_bwd_dq_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* unused, int B, int H,
    int HKV, int Sq, int Sk, int D, const long long* strides, float scale,
    int causal, void* stream) {
  return launch(false, dtype, q, k, v, dout, lse, delta, dq, unused, B, H,
                HKV, Sq, Sk, D, strides, scale, causal, stream);
}

extern "C" int flash_attention_bwd_dkv_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int HKV, int Sq, int Sk, int D, const long long* strides, float scale,
    int causal, void* stream) {
  return launch(true, dtype, q, k, v, dout, lse, delta, dk, dv, B, H, HKV, Sq,
                Sk, D, strides, scale, causal, stream);
}
