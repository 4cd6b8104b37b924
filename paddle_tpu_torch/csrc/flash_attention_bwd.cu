// Flash-attention backward for Hopper (sm_90a): dq (K3) and dk/dv (K4),
// bf16 tensor-core products (mma.sync m16n8k16) with fp32 accumulation.
//
// Replaces the TPU kernels paddle_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (pallas_call at :776) and ::_bwd_dkv_kernel (pallas_call at :919) on the
// training path: causal with an explicit query offset (k_pos <= q_off + i),
// GQA by kv-head index, per-batch kv_lens, any sq/sk with ragged tails.
// Both recompute P = exp(S·scale − lse) from the forward's log-sum-exp
// (csrc/flash_attention.cu: natural log of the scaled scores, NEG_INF for a
// row with no visible key, whose P is 0 here as in the reference, :732/:859)
// and take Δ = rowsum(dO∘O) (fp32, computed by the caller, as the reference
// does outside its kernels at :1059). dS = P∘(dP − Δ) with dP = dO·Vᵀ.
//
//   K3: dq = scale · Σ_k dS·K
//   K4: dv = Σ_q Pᵀ·dO,  dk = scale · Σ_q dSᵀ·Q
//
// What bounds them on the H100: at the training shape (s = 1024, d = 64,
// causal) both do 6·d (K3) or 8·d (K4) FLOPs per visible (query, key) pair
// against ~8·d bytes per row, so they are compute bound (989 TFLOP/s bf16
// dense). Neither writes the (sq, sk) matrices to device memory: one tile of
// S, dP and dS lives in registers at a time, and each kernel skips the tiles
// past the causal or kv_len limit.
//
// K3: grid (ceil(sq/64), h, b), 4 warps × 16 query rows. The Q and dO
// A-fragments stay in registers while the block walks the k tiles; per tile
// S = Q·Kᵀ and dP = dO·Vᵀ (B-fragments: contiguous pairs of K/V rows in
// padded shared memory), then dS, whose accumulators of two adjacent key
// octets form one A-fragment of dq += dS·K.
//
// K4: grid (ceil(sk/64), nkv, b), 4 warps × 16 keys. It works in the
// transposed form, so no fragment is ever transposed: Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ give Pᵀ and dSᵀ as accumulators with keys on the rows, which
// pack straight into the A-fragments of dv += Pᵀ·dO and dk += dSᵀ·Q. Under
// GQA the block loops over the n_rep query heads of its kv head and sums
// their dk/dv in fp32 registers: no repeat, no atomics.
//
// Tiles: K3 walks keys in tiles of 64 (d = 64) or 32 (d = 128), K4 walks
// queries in tiles of 64 (d = 64) or 16 (d = 128), so that the fp32
// accumulators (K4 holds dk and dv: 2·16·d per warp) fit the 255-register
// limit without spills. All shared memory is static (< 48 KB).
//
// A first, simple design: synchronous tile loads, mma.sync instead of wgmma,
// no TMA and no warp specialisation.
//
// Layouts: q, dout (b, sq, h, d), k/v (b, sk, nkv, d), dq (b, sq, h, d),
// dk/dv (b, sk, nkv, d), all bf16 and contiguous; lse, delta (b, h, sq)
// fp32; kv_lens (b,) int32 or null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1e30f)

namespace {

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> bf16x2 register, lower column in the low half
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_b2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + ROWS) of a (rows, rs)-strided bf16 tensor -> padded smem
// tile (row stride D + 8), zero past `nrows`
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long rs, int r0, int nrows,
                                          int tid) {
  constexpr int LD = D + 8, CH = D / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < ROWS * CH; idx += 128) {
    const int r = idx / CH, c = (idx % CH) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < nrows)
      v = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(&dst[r * LD + c]) = v;
  }
}

// B-fragment of a product whose B operand is an smem tile T read along its
// rows (B[k][n] = T[k0 + k][n0 + n]): two scalar reads per register
__device__ __forceinline__ void frag_b_rows(uint32_t* b, const bf16* t,
                                            int ld) {
  b[0] = pack_b2(t[0], t[ld]);
  b[1] = pack_b2(t[8 * ld], t[9 * ld]);
}

constexpr int BQ3 = 64;   // K3: query rows per block
constexpr int BK4 = 64;   // K4: keys per block

template <int D>
struct Tiles {
  static constexpr int K3_KEYS = D == 128 ? 32 : 64;  // K3 keys per tile
  static constexpr int K4_QROWS = D == 128 ? 16 : 64; // K4 queries per tile
};

// ---- K3: dq ------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    const int* __restrict__ kv_lens, int sq, int sk, int h,
                    int nkv, int causal, int q_off, float scale) {
  constexpr int BK = Tiles<D>::K3_KEYS;
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Ks[BK * LD];
  __shared__ __align__(16) bf16 Vs[BK * LD];

  const int qt = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int kh = hi / (h / nkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const long q_rs = (long)h * D;
  const long kv_rs = (long)nkv * D;
  const long q_base = (long)bi * sq * q_rs + (long)hi * D;
  const bf16* qb = q + q_base;
  const bf16* ob = dout + q_base;
  const bf16* kb = k + (long)bi * sk * kv_rs + (long)kh * D;
  const bf16* vb = v + (long)bi * sk * kv_rs + (long)kh * D;

  int kvlen = sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[bi], sk));
  const int r0 = qt * BQ3 + warp * 16 + g;  // rows held in c0/c1 ...
  const int r1 = r0 + 8;                    // ... and in c2/c3

  // Q and dO as A fragments, straight from device memory (read once)
  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    qf[kk][0] = r0 < sq ? ld32(qb + r0 * q_rs + c) : 0u;
    qf[kk][1] = r1 < sq ? ld32(qb + r1 * q_rs + c) : 0u;
    qf[kk][2] = r0 < sq ? ld32(qb + r0 * q_rs + c + 8) : 0u;
    qf[kk][3] = r1 < sq ? ld32(qb + r1 * q_rs + c + 8) : 0u;
    of[kk][0] = r0 < sq ? ld32(ob + r0 * q_rs + c) : 0u;
    of[kk][1] = r1 < sq ? ld32(ob + r1 * q_rs + c) : 0u;
    of[kk][2] = r0 < sq ? ld32(ob + r0 * q_rs + c + 8) : 0u;
    of[kk][3] = r1 < sq ? ld32(ob + r1 * q_rs + c + 8) : 0u;
  }
  const float* lb = lse + ((long)bi * h + hi) * sq;
  const float* db = delta + ((long)bi * h + hi) * sq;
  const float lse0 = r0 < sq ? lb[r0] : NEG_INF;
  const float lse1 = r1 < sq ? lb[r1] : NEG_INF;
  const float dl0 = r0 < sq ? db[r0] : 0.f;
  const float dl1 = r1 < sq ? db[r1] : 0.f;
  // a row with no visible key (lse NEG_INF) has P = 0 everywhere
  const bool live0 = lse0 > NEG_INF * 0.5f, live1 = lse1 > NEG_INF * 0.5f;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // k tiles that can hold a visible key for any row of this block
  int kend = kvlen;
  if (causal) {
    const int last_q = min(qt * BQ3 + BQ3 - 1, sq - 1);
    kend = min(kend, q_off + last_q + 1);
  }
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    load_tile<D, BK>(Ks, kb, kv_rs, k0, sk, tid);
    load_tile<D, BK>(Vs, vb, kv_rs, k0, sk, tid);
    __syncthreads();

    // S = Q Kᵀ and dP = dO Vᵀ for this warp's 16 rows × BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (n * 8 + g) * LD + kk * 16 + tg * 2;
        uint32_t bk[2] = {ld32(&Ks[off]), ld32(&Ks[off + 8])};
        uint32_t bv[2] = {ld32(&Vs[off]), ld32(&Vs[off + 8])};
        mma16816(s[n], qf[kk], bk);
        mma16816(dp[n], of[kk], bv);
      }
    }

    // P = exp(S·scale − lse) on visible keys, then dS = P∘(dP − Δ) into s
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + n * 8 + tg * 2 + j;
        const bool ok0 = live0 && kc < kvlen && (!causal || kc <= q_off + r0);
        const bool ok1 = live1 && kc < kvlen && (!causal || kc <= q_off + r1);
        const float p0 = ok0 ? __expf(s[n][j] * scale - lse0) : 0.f;
        const float p1 = ok1 ? __expf(s[n][2 + j] * scale - lse1) : 0.f;
        s[n][j] = p0 * (dp[n][j] - dl0);
        s[n][2 + j] = p1 * (dp[n][2 + j] - dl1);
      }
    }

    // dq += dS K: the dS accumulators of two adjacent key octets form one
    // 16-key A fragment; K is the B operand read along its rows
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t bfr[2];
        frag_b_rows(bfr, &Ks[(kk * 16 + tg * 2) * LD + dn * 8 + g], LD);
        mma16816(acc[dn], pa, bfr);
      }
    }
  }

  bf16* qo = dq + q_base;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + tg * 2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(qo + r0 * q_rs + c) =
          pack_f2(acc[dn][0] * scale, acc[dn][1] * scale);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(qo + r1 * q_rs + c) =
          pack_f2(acc[dn][2] * scale, acc[dn][3] * scale);
  }
}

// ---- K4: dk, dv --------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ kv_lens,
                     int sq, int sk, int h, int nkv, int causal, int q_off,
                     float scale) {
  constexpr int BQ = Tiles<D>::K4_QROWS;
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Ks[BK4 * LD];
  __shared__ __align__(16) bf16 Vs[BK4 * LD];
  __shared__ __align__(16) bf16 Qs[BQ * LD];
  __shared__ __align__(16) bf16 Os[BQ * LD];
  __shared__ float Ls[BQ];
  __shared__ float Dl[BQ];

  const int kt = blockIdx.x, kh = blockIdx.y, bi = blockIdx.z;
  const int n_rep = h / nkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const long q_rs = (long)h * D;
  const long kv_rs = (long)nkv * D;
  const long kv_base = (long)bi * sk * kv_rs + (long)kh * D;
  const int k0 = kt * BK4;

  int kvlen = sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[bi], sk));
  const int wr = warp * 16 + g;     // this thread's key rows in the tile:
  const int c0 = k0 + wr;           // c0/c1 of the accumulators ...
  const int c1 = c0 + 8;            // ... and c2/c3

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  // the first query row that can see a key of this tile
  const int qstart = causal ? max(0, k0 - q_off) : 0;
  const int qt0 = k0 < kvlen ? qstart / BQ : (sq + BQ - 1) / BQ;
  const int nqt = (sq + BQ - 1) / BQ;

  if (qt0 < nqt) {
    load_tile<D, BK4>(Ks, k + kv_base, kv_rs, k0, sk, tid);
    load_tile<D, BK4>(Vs, v + kv_base, kv_rs, k0, sk, tid);
  }
  for (int r = 0; r < n_rep && qt0 < nqt; ++r) {
    const int hi = kh * n_rep + r;
    const long q_base = (long)bi * sq * q_rs + (long)hi * D;
    const float* lb = lse + ((long)bi * h + hi) * sq;
    const float* db = delta + ((long)bi * h + hi) * sq;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous q tile is consumed
      load_tile<D, BQ>(Qs, q + q_base, q_rs, q0, sq, tid);
      load_tile<D, BQ>(Os, dout + q_base, q_rs, q0, sq, tid);
      for (int i = tid; i < BQ; i += 128) {
        Ls[i] = q0 + i < sq ? lb[q0 + i] : NEG_INF;
        Dl[i] = q0 + i < sq ? db[q0 + i] : 0.f;
      }
      __syncthreads();

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: this warp's 16 keys × BQ queries; the K
      // and V A-fragments come from the padded smem tile (rows wr, wr + 8)
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a = wr * LD + kk * 16 + tg * 2;
        const uint32_t ak[4] = {ld32(&Ks[a]), ld32(&Ks[a + 8 * LD]),
                                ld32(&Ks[a + 8]), ld32(&Ks[a + 8 * LD + 8])};
        const uint32_t av[4] = {ld32(&Vs[a]), ld32(&Vs[a + 8 * LD]),
                                ld32(&Vs[a + 8]), ld32(&Vs[a + 8 * LD + 8])};
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const int off = (n * 8 + g) * LD + kk * 16 + tg * 2;
          uint32_t bq[2] = {ld32(&Qs[off]), ld32(&Qs[off + 8])};
          uint32_t bo[2] = {ld32(&Os[off]), ld32(&Os[off + 8])};
          mma16816(s[n], ak, bq);
          mma16816(dp[n], av, bo);
        }
      }

      // Pᵀ into s, dSᵀ = Pᵀ∘(dPᵀ − Δ) into dp; the query is the column
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int li = n * 8 + tg * 2 + j;
          const int qi = q0 + li;
          const float l = Ls[li], dl = Dl[li];
          const bool live = l > NEG_INF * 0.5f;
          const bool ok0 = live && c0 < kvlen && (!causal || c0 <= q_off + qi);
          const bool ok1 = live && c1 < kvlen && (!causal || c1 <= q_off + qi);
          const float p0 = ok0 ? __expf(s[n][j] * scale - l) : 0.f;
          const float p1 = ok1 ? __expf(s[n][2 + j] * scale - l) : 0.f;
          s[n][j] = p0;
          s[n][2 + j] = p1;
          dp[n][j] = p0 * (dp[n][j] - dl);
          dp[n][2 + j] = p1 * (dp[n][2 + j] - dl);
        }
      }

      // dv += Pᵀ dO and dk += dSᵀ Q: accumulators of two adjacent query
      // octets form one 16-query A fragment; dO and Q are B operands read
      // along their rows
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack_f2(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_f2(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_f2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_f2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        da[0] = pack_f2(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack_f2(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack_f2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack_f2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const int off = (kk * 16 + tg * 2) * LD + dn * 8 + g;
          uint32_t bo[2], bq[2];
          frag_b_rows(bo, &Os[off], LD);
          frag_b_rows(bq, &Qs[off], LD);
          mma16816(dva[dn], pa, bo);
          mma16816(dka[dn], da, bq);
        }
      }
    }
  }

  bf16* dkb = dk + kv_base;
  bf16* dvb = dv + kv_base;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + tg * 2;
    if (c0 < sk) {
      *reinterpret_cast<uint32_t*>(dkb + c0 * kv_rs + c) =
          pack_f2(dka[dn][0] * scale, dka[dn][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + c0 * kv_rs + c) =
          pack_f2(dva[dn][0], dva[dn][1]);
    }
    if (c1 < sk) {
      *reinterpret_cast<uint32_t*>(dkb + c1 * kv_rs + c) =
          pack_f2(dka[dn][2] * scale, dka[dn][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + c1 * kv_rs + c) =
          pack_f2(dva[dn][2], dva[dn][3]);
    }
  }
}

}  // namespace

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, const void* kv_lens, int b,
                                      int sq, int sk, int h, int nkv, int d,
                                      int causal, int q_off, float scale,
                                      void* stream) {
  dim3 grid((sq + BQ3 - 1) / BQ3, h, b);
  cudaStream_t st = (cudaStream_t)stream;
#define K3_ARGS                                                              \
  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,         \
      (const float*)lse, (const float*)delta, (bf16*)dq,                     \
      (const int*)kv_lens, sq, sk, h, nkv, causal, q_off, scale
  if (d == 128) {
    flash_bwd_dq_kernel<128><<<grid, 128, 0, st>>>(K3_ARGS);
  } else if (d == 64) {
    flash_bwd_dq_kernel<64><<<grid, 128, 0, st>>>(K3_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef K3_ARGS
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const void* kv_lens, int b, int sq,
                                       int sk, int h, int nkv, int d,
                                       int causal, int q_off, float scale,
                                       void* stream) {
  dim3 grid((sk + BK4 - 1) / BK4, nkv, b);
  cudaStream_t st = (cudaStream_t)stream;
#define K4_ARGS                                                              \
  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,         \
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,          \
      (const int*)kv_lens, sq, sk, h, nkv, causal, q_off, scale
  if (d == 128) {
    flash_bwd_dkv_kernel<128><<<grid, 128, 0, st>>>(K4_ARGS);
  } else if (d == 64) {
    flash_bwd_dkv_kernel<64><<<grid, 128, 0, st>>>(K4_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef K4_ARGS
  return (int)cudaGetLastError();
}
