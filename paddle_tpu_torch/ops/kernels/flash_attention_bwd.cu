// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_bwd_dq_kernel (:172) and
// _bwd_dkv_kernel (:215), launched by _flash_bwd (pallas_call at :274 and
// :296), with the GQA group sum of _fa_bwd (:372-373) folded into the
// dK/dV kernel.
//
// Both recompute the probabilities from the forward's f32 logsumexp instead
// of storing them: p = exp(scale * q.k - lse), zeroed where masked (so a
// fully masked row, lse = -1e30, contributes nothing), and
// dS = p * (dP - delta) * scale with dP = dO.v and delta = sum(out * dO)
// (f32, computed by the wrapper, as the reference does outside its
// kernels). The dQ kernel accumulates dQ = sum_k dS @ K; the dK/dV kernel
// accumulates dV = sum_q P^T @ dO and dK = sum_q dS^T @ Q. The reference's
// rounding points are kept: dS is rounded to K's dtype before dS @ K and to
// Q's dtype before dS^T @ Q, P to dO's dtype before P^T @ dO, and the
// outputs are written in the input dtype from f32 accumulators. Causal
// tiles that the reference's `live` predicate skips (offset Sk - Sq) are
// skipped here too. GQA: K/V are read at kv head h / (H / HKV) (the
// reference's repeat, without copying); dK/dV come out per kv head,
// [B, Sk, HKV, D], each group's query heads summed in the f32 accumulators
// and cast once.
//
// Bound on this card: operations. Per head the dQ kernel does three
// Sq x Sk x D products and the dK/dV kernel four (halved when causal), on
// 2-byte inputs read once per tile: far above the ~295 flops per byte where
// the H100 turns compute-bound. Design against that: nothing of size
// Sq x Sk reaches device memory, every product of bf16/f16 at head_dim 64
// and 128 runs on the tensor cores through wgmma, and the tiles stream in
// by TMA from a producer warpgroup, so the consumers' registers and issue
// slots go to the products and the elementwise work between them. The TPU
// kernels' sequential grid axis becomes a loop inside one block (nothing
// carries between blocks on this card): the dQ kernel has one block per
// (128-row query tile, head, batch) and loops over key tiles with dQ in
// registers; the dK/dV kernel has one block per (64-key tile, kv head,
// batch) and loops over the group's query heads and their query tiles with
// dK and dV in registers, so no atomics are needed and the result does not
// depend on the order blocks run in. f32 inputs, and bf16/f16 at head_dim
// 256 (whose dK + dV accumulators do not fit one warpgroup's registers),
// run on the CUDA cores (first two kernels). The Python wrapper picks the
// kernels up front from dtype and head_dim and launches their symbols.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
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

// One block per (key tile, kv head, batch): loops over the group's query
// heads and their query tiles, so dK/dV leave summed over the group.
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

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.HKV;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = a.Sk - a.Sq;
  const int64_t* st = a.st;
  const T* kb = (const T*)a.k + b * st[3] + hk * st[5];
  const T* vb = (const T*)a.v + b * st[6] + hk * st[8];

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
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const T* qb = (const T*)a.q + b * st[0] + h * st[2];
    const T* ob = (const T*)a.dout + b * st[9] + h * st[11];
    const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
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
  }

  T* dkb = (T*)a.o1 + b * st[12] + hk * st[14];
  T* dvb = (T*)a.o2 + b * st[15] + hk * st[17];
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
// Warp-specialised tensor-core kernels for bf16/f16 at head_dim 64 and 128:
// TMA, mbarriers and wgmma (hopper.cuh), the flash forward's structure.
// Tiles are 128-byte-swizzled boxes of 64 columns. In each kernel a
// producer warpgroup streams tiles into a ring of STAGES stages, each with
// a "full" mbarrier (armed with the bytes to expect) and an "empty" one
// (one arrival per consumer warp once the tile is no longer read), while
// the resident operands stay in shared memory for the whole loop. Each
// consumer warpgroup owns 64 output rows: two wgmma products on
// shared-memory operands give a 64-row tile of scores and of dP, the
// probabilities and dS are formed in registers in the accumulators' own
// layout (exp2 of s * scale * log2(e) - lse * log2(e), one multiply-add),
// and the accumulators, packed to bf16/f16 pairs in place (the rounding
// points), are the register A operand of the products that accumulate the
// gradients — the fragment identity of mma.sync (mma.cuh), with the other
// operand read MN-major from its [row][d] tile, never transposed in
// memory. The epilogue stages each output tile in shared memory and writes
// it in 16-byte stores, rows past the end clipped.
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>  // D[64 x 64] (+)= A B^T, both K-major
__device__ __forceinline__ void wgmma_nt(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  wgmma_ss_n64<T, 0, 0>(d, a, b, scale_d);
}

template <typename T, int N>  // D[64 x N] += A (registers) B, B MN-major
__device__ __forceinline__ void wgmma_acc(float (&d)[N / 2],
                                          const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs_n64<T, 1>(d, a, b, 1);
  } else {
    wgmma_rs_n128<T, 1>(d, a, b, 1);
  }
}

// The A fragments of k16 step kk from a 64 x N accumulator, rounded to T.
template <typename T, int N>
__device__ __forceinline__ void pack_fragments(const float (&s)[N / 2],
                                               uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack2f<T>(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack2f<T>(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack2f<T>(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack2f<T>(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// This lane's part of a 64 x D f32 accumulator (tile rows r and r + 8) into
// a swizzled [D / 64][box_rows][128 B] tile, as TMA lays a loaded tile out,
// then the tile's rows [row0, row0 + 64) out to `out` (the global row of
// tile row row0) in 16-byte stores, the first `limit` rows only. Called by
// one consumer warpgroup's 128 threads; `barrier` is theirs.
template <typename T, int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2],
                                           unsigned char* tile, int box_rows,
                                           int row0, int r, int t4, T* out,
                                           int64_t row_stride, int limit,
                                           int barrier) {
  named_barrier_sync(barrier, 128);  // the tile is no longer read
  const int sw = r % 8;  // rows r and r + 8 share the swizzle phase
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    unsigned char* box = tile + (n / 8) * box_rows * 128;
    const int at = ((n % 8) ^ sw) * 16 + 4 * t4;
    *reinterpret_cast<uint32_t*>(box + r * 128 + at) =
        pack2f<T>(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(box + (r + 8) * 128 + at) =
        pack2f<T>(acc[4 * n + 2], acc[4 * n + 3]);
  }
  named_barrier_sync(barrier, 128);
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x % 128; idx < 64 * CHUNKS; idx += 128) {
    const int i = idx / CHUNKS, c = idx % CHUNKS, rr = row0 + i;
    if (i < limit)
      *reinterpret_cast<uint4*>(out + i * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + (c / 8) * box_rows * 128 +
                                          rr * 128 + ((c % 8) ^ (rr % 8)) * 16);
  }
}

// ---- dQ --------------------------------------------------------------------
// One block per (128-row query tile, head, batch), 384 threads: the producer
// warpgroup loads Q and dO once, then each key tile's K and V into the
// ring; two consumers own 64 query rows each and run, per key tile,
//   S = Q K^T and dP = dO V^T (wgmma, shared-memory operands),
//   P = exp(S scale - lse) masked, dS = P (dP - delta) scale (registers),
//   dQ += dS K (wgmma, dS from registers, K read MN-major).
// Key tiles of 64 keep S, dP and dQ (32 + 32 + 64 f32 registers a thread at
// D 128) inside the 168 registers ptxas allots each thread at 384 threads.
// S and dP are committed as two groups, so the exponentials of P run while
// dP is still on the tensor cores (measured against one group, flash_ab.py
// on the H100: causal MHA 0.270 -> 0.228 ms). A consumer whose rows see
// none of a causal tile skips its products but still releases the stage.
// Causal grids launch the heaviest query tiles first.

constexpr int DQ_BQ = 128;       // query rows per block, 64 per consumer
constexpr int DQ_THREADS = 384;  // producer + two consumer warpgroups
constexpr int DQ_STAGES = 3;     // K/V ring depth

template <int D>
struct DqTile {
  static constexpr int BK = 64;  // keys per tile
  static constexpr int BOXES = D / 64;
  static constexpr int Q_BYTES = DQ_BQ * D * 2;  // one of Q or dO
  static constexpr int KV_BYTES = BK * D * 2;    // one of K or V
  static constexpr int BAR_OFFSET = 2 * Q_BYTES + DQ_STAGES * 2 * KV_BYTES;
  // tiles, barriers (Q/dO, then full and empty per stage), and the slack
  // that aligns the base to the 1024 bytes of the swizzle pattern
  static constexpr int SMEM = BAR_OFFSET + 8 * (1 + 2 * DQ_STAGES) + 1024;
};

// key tiles rows [q0, q0 + rows) visit: all of them, or under causal
// masking those up to the diagonal of the last row (the reference's `live`)
__device__ __forceinline__ int key_tiles(int q0, int rows, int Sq, int Sk,
                                         int BK, int causal) {
  int n = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + rows, Sq) - 1 + (Sk - Sq);
    n = last < 0 ? 0 : min(n, last / BK + 1);
  }
  return n;
}

template <typename T, int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, int H, int HKV, int Sq, int Sk,
                          int64_t o_sb, int64_t o_ss, int64_t o_sh,
                          float scale, int causal) {
  using Tile = DqTile<D>;
  constexpr int BK = Tile::BK;
  extern __shared__ unsigned char dq_smem[];
  const uint32_t raw = smem_u32(dq_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = dq_smem + (base - raw);
  const uint32_t q_tile = base;                        // [BOXES][DQ_BQ][128 B]
  const uint32_t do_tile = base + Tile::Q_BYTES;       // the same for dO
  const uint32_t kv_tiles = base + 2 * Tile::Q_BYTES;  // per stage: K, V
  const uint32_t qo_full = base + Tile::BAR_OFFSET;
  const uint32_t full0 = qo_full + 8;               // + 8 * stage
  const uint32_t empty0 = full0 + 8 * DQ_STAGES;    // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * DQ_BQ;
  const int kv_head = h / (H / HKV);
  const int off = Sk - Sq;  // causal: row i sees keys j <= i + off
  const int n_tiles = key_tiles(q0, DQ_BQ, Sq, Sk, BK, causal);
  const int tid = threadIdx.x;

  if (tid == 0) {
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    prefetch_tensor_map(&do_map);
    mbar_init(qo_full, 1);
#pragma unroll
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 8);  // the 8 consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    warpgroup_reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(qo_full, 2 * Tile::Q_BYTES);
#pragma unroll
      for (int i = 0; i < Tile::BOXES; ++i) {
        tma_load_4d(q_tile + i * DQ_BQ * 128, &q_map, qo_full, 64 * i, q0, h,
                    b);
        tma_load_4d(do_tile + i * DQ_BQ * 128, &do_map, qo_full, 64 * i, q0,
                    h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % DQ_STAGES;
        // the stage's previous tile, t - DQ_STAGES, has been read
        if (t >= DQ_STAGES)
          mbar_wait(empty0 + 8 * st, (t / DQ_STAGES + 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t kt = kv_tiles + st * 2 * Tile::KV_BYTES;
        mbar_expect_tx(full, 2 * Tile::KV_BYTES);
#pragma unroll
        for (int i = 0; i < Tile::BOXES; ++i) {
          tma_load_4d(kt + i * BK * 128, &k_map, full, 64 * i, t * BK,
                      kv_head, b);
          tma_load_4d(kt + Tile::KV_BYTES + i * BK * 128, &v_map, full,
                      64 * i, t * BK, kv_head, b);
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
  const int my_tiles = key_tiles(first_row, 64, Sq, Sk, BK, causal);

  // this lane's rows' lse (log2 domain) and delta; rows past Sq read 0, so
  // that P = 1 and dS = 0 there (their Q and dO are zero-filled)
  const float* lrow = lse + ((int64_t)b * H + h) * Sq;
  const float* drow = delta + ((int64_t)b * H + h) * Sq;
  const float l2_a = row_a < Sq ? lrow[row_a] * LOG2E : 0.f;
  const float l2_b = row_b < Sq ? lrow[row_b] * LOG2E : 0.f;
  const float d_a = row_a < Sq ? drow[row_a] : 0.f;
  const float d_b = row_b < Sq ? drow[row_b] : 0.f;
  const float scale_log2 = scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qo_full, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % DQ_STAGES;
    const int k0 = tile * BK;
    const uint32_t kt = kv_tiles + st * 2 * Tile::KV_BYTES;
    const uint32_t vt = kt + Tile::KV_BYTES;
    mbar_wait(full0 + 8 * st, (tile / DQ_STAGES) & 1);
    if (tile < my_tiles) {
      // S = Q K^T and dP = dO V^T: 64 rows x BK keys, k16 steps along D
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = kk / 4, in_box = (kk % 4) * 32;
        const uint32_t a_off = box * DQ_BQ * 128 + cw * 64 * 128 + in_box;
        const uint32_t b_off = box * BK * 128 + in_box;
        wgmma_nt<T>(s, desc_sw128(q_tile + a_off, 16, 1024),
                        desc_sw128(kt + b_off, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = kk / 4, in_box = (kk % 4) * 32;
        const uint32_t a_off = box * DQ_BQ * 128 + cw * 64 * 128 + in_box;
        const uint32_t b_off = box * BK * 128 + in_box;
        wgmma_nt<T>(dp, desc_sw128(do_tile + a_off, 16, 1024),
                        desc_sw128(vt + b_off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S is in; dP runs on under P
      fence_operands(s);

      // element e of n-tile n: row (e < 2 ? row_a : row_b), key
      // k0 + 8n + 2 t4 + (e & 1); P, then dS, into s
      const bool edge =
          k0 + BK > Sk || (causal && k0 + BK - 1 > first_row + off);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * n + 2 * t4 + (e & 1);
          const int qi = e < 2 ? row_a : row_b;
          float p = exp2_approx(
              fmaf(s[4 * n + e], scale_log2, -(e < 2 ? l2_a : l2_b)));
          if (edge && (kj >= Sk || (causal && kj > qi + off))) p = 0.f;
          s[4 * n + e] = p;
        }
      }
      wgmma_wait<0>();
      fence_operands(dp);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] = s[i] * (dp[i] - ((i % 4) < 2 ? d_a : d_b)) * scale;

      // dQ += dS K: dS's accumulators for keys 16kk..16kk+15 are the A
      // fragment (rounded to K's dtype); K read MN-major, as V in P V
      uint32_t ds[BK / 16][4];
      pack_fragments<T, BK>(s, ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_acc<T, D>(acc, ds[kk],
                        desc_sw128(kt + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // K and V read
  }

  // stage dQ in this consumer's Q rows, swizzled as Q was loaded
  store_tile<T, D>(acc, sbase, DQ_BQ, 64 * cw, r_a, t4,
                   dq + b * o_sb + h * o_sh + (int64_t)first_row * o_ss, o_ss,
                   Sq - first_row, 1 + cw);
}

// ---- dK/dV -----------------------------------------------------------------
// One block per (64-key tile, kv head, batch), 256 threads: the producer
// loads K and V once, then for each of the group's query heads and each of
// its live query tiles, Q and dO by TMA and that tile's lse (log2 domain)
// and delta by its first warp's loads into the ring; one consumer owns the
// 64 keys and runs, per query tile,
//   S^T = K Q^T and dP^T = V dO^T (wgmma, shared-memory operands),
//   P^T = exp(S^T scale - lse) masked, dS^T = P^T (dP^T - delta) scale,
//   dV += P^T dO and dK += dS^T Q (wgmma, P^T and dS^T from registers, dO
//   and Q read MN-major).
// dK + dV take 128 f32 registers a thread at D 128 and S^T + dP^T 64 more,
// beyond the 168 ptxas allots at 384 threads: so one consumer per block,
// whose 256 threads may use 255 registers each without setmaxnreg (246
// used, no spill). Two consumers owning 64 keys each at 384 threads, with
// 32-query tiles and setmaxnreg.inc 240, were measured against this
// (flash_ab.py on the H100): ptxas still allots 168 and serialises their
// wgmmas (C7512), 0.58 ms against 0.43 at causal MHA. The dQ kernel's
// split of the score products into two commit groups gained nothing here
// (0.44 ms, 238 registers). The
// group's query heads accumulate into the same f32 registers, so dK/dV
// leave summed over the group and cast once.
// Block order: without GQA the key tile is the fastest grid axis, so the
// ~130 resident blocks share a few heads' Q and dO in L2 (causal MHA 0.43
// -> 0.36 ms, non-causal 0.84 -> 0.69 against the kv head fastest). With
// GQA a block's chain is group times longer, and the kv head fastest, with
// the heaviest causal key tiles launched first, keeps the longest chains
// from starting last (GQA 4 kv heads 0.33 ms against 0.38).

constexpr int DKV_BK = 64;        // keys per block
constexpr int DKV_THREADS = 256;  // producer + one consumer warpgroup
constexpr int DKV_STAGES = 3;     // Q/dO ring depth
constexpr int DKV_BQ = 64;        // query rows per tile

template <int D>
struct DkvTile {
  static constexpr int BQ = DKV_BQ;
  static constexpr int BOXES = D / 64;
  static constexpr int KV_BYTES = DKV_BK * D * 2;  // one of K or V
  static constexpr int QO_BYTES = BQ * D * 2;      // one of Q or dO
  static constexpr int LD_OFFSET = 2 * KV_BYTES + DKV_STAGES * 2 * QO_BYTES;
  // per stage: lse (log2 domain), then delta, BQ floats each
  static constexpr int BAR_OFFSET = LD_OFFSET + DKV_STAGES * 2 * BQ * 4;
  static constexpr int SMEM = BAR_OFFSET + 8 * (1 + 2 * DKV_STAGES) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int H,
                           int HKV, int Sq, int Sk, int64_t dk_sb,
                           int64_t dk_ss, int64_t dk_sh, int64_t dv_sb,
                           int64_t dv_ss, int64_t dv_sh, float scale,
                           int causal, int key_fastest) {
  using Tile = DkvTile<D>;
  constexpr int BQ = Tile::BQ;
  extern __shared__ unsigned char dkv_smem[];
  const uint32_t raw = smem_u32(dkv_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = dkv_smem + (base - raw);
  const uint32_t k_tile = base;                    // [BOXES][64][128 B]
  const uint32_t v_tile = base + Tile::KV_BYTES;
  const uint32_t qo_tiles = base + 2 * Tile::KV_BYTES;  // per stage: Q, dO
  float* const ld = reinterpret_cast<float*>(sbase + Tile::LD_OFFSET);
  const uint32_t kv_full = base + Tile::BAR_OFFSET;
  const uint32_t full0 = kv_full + 8;               // + 8 * stage
  const uint32_t empty0 = full0 + 8 * DKV_STAGES;   // + 8 * stage

  const int hk = key_fastest ? blockIdx.y : blockIdx.x;
  const int b = key_fastest ? blockIdx.z : blockIdx.y;
  const int k0 = (key_fastest ? blockIdx.x : blockIdx.z) * DKV_BK;
  const int group = H / HKV;
  const int off = Sk - Sq;  // causal: row i sees keys j <= i + off
  // the first query tile whose last row sees key k0, and the tiles per head
  const int first = causal ? max(0, k0 - off) / BQ : 0;
  const int per_head = max((Sq + BQ - 1) / BQ - first, 0);
  const int n_tiles = group * per_head;
  const int tid = threadIdx.x;

  if (tid == 0) {
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    prefetch_tensor_map(&do_map);
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < DKV_STAGES; ++st) {
      mbar_init(full0 + 8 * st, 32);  // the producer's first warp
      mbar_init(empty0 + 8 * st, 4);  // the 4 consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: its first warp does the work
    if (tid >= 32) return;
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * Tile::KV_BYTES);
#pragma unroll
      for (int i = 0; i < Tile::BOXES; ++i) {
        tma_load_4d(k_tile + i * DKV_BK * 128, &k_map, kv_full, 64 * i, k0,
                    hk, b);
        tma_load_4d(v_tile + i * DKV_BK * 128, &v_map, kv_full, 64 * i, k0,
                    hk, b);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % DKV_STAGES;
      const int h = hk * group + t / per_head;
      const int qs0 = (first + t % per_head) * BQ;
      // the stage's previous tile, t - DKV_STAGES, has been read
      if (t >= DKV_STAGES)
        mbar_wait(empty0 + 8 * st, (t / DKV_STAGES + 1) & 1);
      const float* lrow = lse + ((int64_t)b * H + h) * Sq;
      const float* drow = delta + ((int64_t)b * H + h) * Sq;
      float* ls = ld + st * 2 * BQ;
      // rows past Sq read 0, so that P = 1 and dS = 0 there (their Q and
      // dO are zero-filled)
      for (int i = tid; i < BQ; i += 32) {
        const bool in = qs0 + i < Sq;
        ls[i] = in ? lrow[qs0 + i] * LOG2E : 0.f;
        ls[BQ + i] = in ? drow[qs0 + i] : 0.f;
      }
      const uint32_t full = full0 + 8 * st;
      if (tid == 0) {
        const uint32_t qt = qo_tiles + st * 2 * Tile::QO_BYTES;
        mbar_expect_tx(full, 2 * Tile::QO_BYTES);
#pragma unroll
        for (int i = 0; i < Tile::BOXES; ++i) {
          tma_load_4d(qt + i * BQ * 128, &q_map, full, 64 * i, qs0, h, b);
          tma_load_4d(qt + Tile::QO_BYTES + i * BQ * 128, &do_map, full,
                      64 * i, qs0, h, b);
        }
      } else {
        mbar_arrive(full);  // this lane's lse and delta are in place
      }
    }
    return;
  }

  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r_a = 16 * warp + g;  // tile keys r_a and r_a + 8
  const int key_a = k0 + r_a, key_b = key_a + 8;
  const float scale_log2 = scale * LOG2E;
  // under causal masking a tile whose first query sees the block's last
  // key needs no mask
  const int last_key = k0 + DKV_BK - 1;

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % DKV_STAGES;
    const int qs0 = (first + t % per_head) * BQ;
    const uint32_t qt = qo_tiles + st * 2 * Tile::QO_BYTES;
    const uint32_t ot = qt + Tile::QO_BYTES;
    const float* ls = ld + st * 2 * BQ;
    mbar_wait(full0 + 8 * st, (t / DKV_STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries, k16 along D
    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t box = kk / 4, in_box = (kk % 4) * 32;
      const uint32_t a_off = box * DKV_BK * 128 + in_box;
      const uint32_t b_off = box * BQ * 128 + in_box;
      wgmma_nt<T>(s, desc_sw128(k_tile + a_off, 16, 1024),
                      desc_sw128(qt + b_off, 16, 1024), kk > 0);
      wgmma_nt<T>(dp, desc_sw128(v_tile + a_off, 16, 1024),
                      desc_sw128(ot + b_off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);

    // element e of n-tile n: key (e < 2 ? key_a : key_b), query
    // qs0 + 8n + 2 t4 + (e & 1); P^T into s, dS^T into dp
    const bool edge = causal && qs0 + off < last_key;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t4);
      const float2 dl =
          *reinterpret_cast<const float2*>(ls + BQ + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qs0 + 8 * n + 2 * t4 + (e & 1);
        const int kj = e < 2 ? key_a : key_b;
        float p = exp2_approx(
            fmaf(s[4 * n + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
        if (edge && qi + off < kj) p = 0.f;
        s[4 * n + e] = p;
        dp[4 * n + e] = p * (dp[4 * n + e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q: queries along k, dO and Q MN-major
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    pack_fragments<T, BQ>(s, pa);
    pack_fragments<T, BQ>(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_acc<T, D>(acc_v, pa[kk],
                      desc_sw128(ot + kk * 16 * 128, BQ * 128, 1024));
      wgmma_acc<T, D>(acc_k, da[kk],
                      desc_sw128(qt + kk * 16 * 128, BQ * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_v);
    fence_operands(acc_k);
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // Q, dO, lse, delta read
  }

  // stage dK in the K tile and dV in the V tile, swizzled as they were
  // loaded, and write both
  const int limit = Sk - k0;
  store_tile<T, D>(acc_k, sbase, DKV_BK, 0, r_a, t4,
                   dk + b * dk_sb + hk * dk_sh + (int64_t)k0 * dk_ss, dk_ss,
                   limit, 1);
  store_tile<T, D>(acc_v, sbase + Tile::KV_BYTES, DKV_BK, 0, r_a, t4,
                   dv + b * dv_sb + hk * dv_sh + (int64_t)k0 * dv_ss, dv_ss,
                   limit, 1);
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
  const dim3 grid((a.Sk + BK - 1) / BK, a.HKV, B);
  dkv_scalar_kernel<T, D, BK, BQ><<<grid, THREADS, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// tile sizes of the CUDA-core kernels by head_dim: the f32 tiles of one
// block stay under the 227 KB of shared memory and the accumulators under
// 64 registers a thread. 2-byte types take them at head_dim 256 only (the
// wgmma kernels take 64 and 128).
template <typename T>
int launch_scalar_typed(bool dkv, const BwdArgs& a, int B, int D,
                        cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (D == 64)
      return dkv ? launch_dkv_scalar<T, 64, 64, 64>(a, B, s)
                 : launch_dq_scalar<T, 64, 64, 64>(a, B, s);
    if (D == 128)
      return dkv ? launch_dkv_scalar<T, 128, 64, 64>(a, B, s)
                 : launch_dq_scalar<T, 128, 64, 64>(a, B, s);
  }
  if (D == 256)
    return dkv ? launch_dkv_scalar<T, 256, 32, 32>(a, B, s)
               : launch_dq_scalar<T, 256, 64, 32>(a, B, s);
  return -1;
}

template <typename T, int D>
int launch_dq_wgmma(int dtype, const BwdArgs& a, int B, cudaStream_t s) {
  using Tile = DqTile<D>;
  static bool done = false;
  if (!done) {
    if (int e = configure(flash_bwd_dq_wgmma_kernel<T, D>, Tile::SMEM))
      return e;
    done = true;
  }
  const int64_t* st = a.st;
  CUtensorMap q_map, k_map, v_map, do_map;
  int e = encode_bshd_map(&q_map, dtype, a.q, B, a.Sq, a.H, D, st[0], st[1],
                          st[2], DQ_BQ);
  if (e == 0)
    e = encode_bshd_map(&k_map, dtype, a.k, B, a.Sk, a.HKV, D, st[3], st[4],
                        st[5], Tile::BK);
  if (e == 0)
    e = encode_bshd_map(&v_map, dtype, a.v, B, a.Sk, a.HKV, D, st[6], st[7],
                        st[8], Tile::BK);
  if (e == 0)
    e = encode_bshd_map(&do_map, dtype, a.dout, B, a.Sq, a.H, D, st[9],
                        st[10], st[11], DQ_BQ);
  if (e != 0) return e;
  const dim3 grid(a.H, B, (a.Sq + DQ_BQ - 1) / DQ_BQ);
  flash_bwd_dq_wgmma_kernel<T, D><<<grid, DQ_THREADS, Tile::SMEM, s>>>(
      q_map, k_map, v_map, do_map, a.lse, a.delta, (T*)a.o1, a.H, a.HKV, a.Sq,
      a.Sk, st[12], st[13], st[14], a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_wgmma(int dtype, const BwdArgs& a, int B, cudaStream_t s) {
  using Tile = DkvTile<D>;
  static bool done = false;
  if (!done) {
    if (int e = configure(flash_bwd_dkv_wgmma_kernel<T, D>, Tile::SMEM))
      return e;
    done = true;
  }
  const int64_t* st = a.st;
  CUtensorMap q_map, k_map, v_map, do_map;
  int e = encode_bshd_map(&q_map, dtype, a.q, B, a.Sq, a.H, D, st[0], st[1],
                          st[2], Tile::BQ);
  if (e == 0)
    e = encode_bshd_map(&k_map, dtype, a.k, B, a.Sk, a.HKV, D, st[3], st[4],
                        st[5], DKV_BK);
  if (e == 0)
    e = encode_bshd_map(&v_map, dtype, a.v, B, a.Sk, a.HKV, D, st[6], st[7],
                        st[8], DKV_BK);
  if (e == 0)
    e = encode_bshd_map(&do_map, dtype, a.dout, B, a.Sq, a.H, D, st[9],
                        st[10], st[11], Tile::BQ);
  if (e != 0) return e;
  // the block order: see the dK/dV kernel's note
  const int nk = (a.Sk + DKV_BK - 1) / DKV_BK;
  const bool key_fastest = a.H == a.HKV;
  const dim3 grid = key_fastest ? dim3(nk, a.HKV, B) : dim3(a.HKV, B, nk);
  flash_bwd_dkv_wgmma_kernel<T, D><<<grid, DKV_THREADS, Tile::SMEM, s>>>(
      q_map, k_map, v_map, do_map, a.lse, a.delta, (T*)a.o1, (T*)a.o2, a.H,
      a.HKV, a.Sq, a.Sk, st[12], st[13], st[14], st[15], st[16], st[17],
      a.scale, a.causal, key_fastest);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgmma_typed(bool dkv, int dtype, const BwdArgs& a, int B, int D,
                       cudaStream_t s) {
  switch (D) {
    case 64:
      return dkv ? launch_dkv_wgmma<T, 64>(dtype, a, B, s)
                 : launch_dq_wgmma<T, 64>(dtype, a, B, s);
    case 128:
      return dkv ? launch_dkv_wgmma<T, 128>(dtype, a, B, s)
                 : launch_dq_wgmma<T, 128>(dtype, a, B, s);
    default:
      return -1;
  }
}

int launch(bool wgmma, bool dkv, int dtype, const void* q, const void* k,
           const void* v, const void* dout, const void* lse,
           const void* delta, void* o1, void* o2, int B, int H, int HKV,
           int Sq, int Sk, int D, const long long* strides, float scale,
           int causal, void* stream) {
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
      return wgmma ? -1 : launch_scalar_typed<float>(dkv, a, B, D, s);
    case DT_BF16:
      return wgmma ? launch_wgmma_typed<__nv_bfloat16>(dkv, dtype, a, B, D, s)
                   : launch_scalar_typed<__nv_bfloat16>(dkv, a, B, D, s);
    case DT_F16:
      return wgmma ? launch_wgmma_typed<__half>(dkv, dtype, a, B, D, s)
                   : launch_scalar_typed<__half>(dkv, a, B, D, s);
    default:
      return -1;
  }
}

}  // namespace

// CUDA-core kernels: dQ [B, Sq, H, D]; dK, dV [B, Sk, HKV, D]
extern "C" int flash_attention_bwd_dq_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* unused, int B, int H,
    int HKV, int Sq, int Sk, int D, const long long* strides, float scale,
    int causal, void* stream) {
  return launch(false, false, dtype, q, k, v, dout, lse, delta, dq, unused, B,
                H, HKV, Sq, Sk, D, strides, scale, causal, stream);
}

extern "C" int flash_attention_bwd_dkv_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int HKV, int Sq, int Sk, int D, const long long* strides, float scale,
    int causal, void* stream) {
  return launch(false, true, dtype, q, k, v, dout, lse, delta, dk, dv, B, H,
                HKV, Sq, Sk, D, strides, scale, causal, stream);
}

// TMA + wgmma kernels, bf16/f16 at head_dim 64 and 128 (the same outputs)
extern "C" int flash_attention_bwd_dq_wgmma_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* unused, int B, int H,
    int HKV, int Sq, int Sk, int D, const long long* strides, float scale,
    int causal, void* stream) {
  return launch(true, false, dtype, q, k, v, dout, lse, delta, dq, unused, B,
                H, HKV, Sq, Sk, D, strides, scale, causal, stream);
}

extern "C" int flash_attention_bwd_dkv_wgmma_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int HKV, int Sq, int Sk, int D, const long long* strides, float scale,
    int causal, void* stream) {
  return launch(true, true, dtype, q, k, v, dout, lse, delta, dk, dv, B, H,
                HKV, Sq, Sk, D, strides, scale, causal, stream);
}
