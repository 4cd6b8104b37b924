// Flash-attention backward for Hopper (sm_90a): dq (K3) and dk/dv (K4),
// bf16 tensor-core products with fp32 accumulation: K3 on mma.sync
// m16n8k16, K4 on wgmma fed by TMA (see the K4 section below).
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
// dense, which only wgmma reaches). Neither writes the (sq, sk) matrices to
// device memory: one tile of S, dP and dS lives in registers at a time, and
// each kernel skips the tiles past the causal or kv_len limit.
//
// K3 (a first, simple design: synchronous tile loads, mma.sync): grid
// (ceil(sq/64), h, b), 4 warps × 16 query rows. The Q and dO A-fragments
// stay in registers while the block walks the k tiles (64 keys at d = 64,
// 32 at d = 128); per tile S = Q·Kᵀ and dP = dO·Vᵀ (B-fragments: contiguous
// pairs of K/V rows in padded shared memory), then dS, whose accumulators
// of two adjacent key octets form one A-fragment of dq += dS·K.
//
// K4: a 1-d grid of ceil(sk/128) key blocks × nkv × b in the order of
// block_order (hopper_sm90.cuh: (batch, kv head) units grouped so their
// heads' Q and dO fit 4 MB of L2, the heaviest causal key blocks first),
// 384 threads: two consumer warpgroups of 64 keys each and a producer
// warpgroup (one warp streams; setmaxnreg: producer 24 registers,
// consumers 240). It works in the transposed form, so nothing is ever
// transposed: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ give Pᵀ and dSᵀ with keys on the
// accumulator rows, which pack straight into the register A operand of
// dv += Pᵀ·dO and dk += dSᵀ·Q. At d = 128 each group holds dk and dv (2 ×
// 64 fp32 a thread) and a 64-query tile (Sᵀ, dPᵀ: 2 × 32) in registers.
// Each query tile's products are waited for inside its pass, so no wgmma
// is in flight across the loop edge (ptxas serialises them otherwise); the
// two consumer groups overlap each other. Shared memory: K, V 2·128·d·2 +
// ST·(2·64·d·2 + 512) bytes (d = 128, ST = 2: 129 KB; d = 64, ST = 3: 81.5
// KB). Registers (nvcc 12.9 -Xptxas -v, sm_90a): 168 at entry for 384
// threads, 0 bytes spilled, no wgmma serialisation warning, both head
// dims.
//
// Layouts: q, dout (b, sq, h, d), k/v (b, sk, nkv, d), dq (b, sq, h, d),
// dk/dv (b, sk, nkv, d), all bf16 and contiguous; lse, delta (b, h, sq)
// fp32; kv_lens (b,) int32 or null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

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

template <int D>
struct Tiles {
  static constexpr int K3_KEYS = D == 128 ? 32 : 64;  // K3 keys per tile
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
//
// One block owns BKEY = 128 keys of one kv head (64 per consumer warpgroup)
// and walks the query tiles of every query head of its GQA group. The
// producer warp TMA-loads K and V once, then streams Q, dO (64 rows each) and
// the tile's lse (as lse·log2 e; +inf for a row with no visible key or past
// sq, so its P is exactly 0) and Δ through an ST-stage ring. Each consumer
// group computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ by wgmma m64n64k16 (K, V as A,
// Q, dO as B, all K-major from shared memory), forms Pᵀ and dSᵀ in
// registers, and accumulates dv += Pᵀ·dO and dk += dSᵀ·Q by wgmma
// m64nDk16 with Pᵀ, dSᵀ from registers and dO, Q as MN-major B from the
// same tiles: no transpose, no scalar fragment assembly. dk and dv stay in
// fp32 registers over all the group's heads (fixed order, no atomics: two
// launches give equal bits).

constexpr int BKEY = 128;       // K4: keys per block (64 per consumer group)
constexpr int BQ4 = 64;         // K4: query rows per streamed tile
constexpr int K4_THREADS = 384; // consumer groups 0, 1; producer group 2

template <int D>
struct Dkv {
  static constexpr int ST = D == 128 ? 2 : 3;   // ring stages
  static constexpr int NCH = D / 64;            // 64-column tiles a row
  static constexpr int KV_BYTES = BKEY * D * 2; // K or V
  static constexpr int QT_BYTES = BQ4 * D * 2;  // a Q or dO tile
  static constexpr int Q_OFF = 2 * KV_BYTES;                // Q stages
  static constexpr int O_OFF = Q_OFF + ST * QT_BYTES;       // dO stages
  static constexpr int ROW_OFF = O_OFF + ST * QT_BYTES;     // lse·log2e, Δ
  static constexpr int BAR_OFF = ROW_OFF + ST * 2 * BQ4 * 4;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * ST) * 8 + 1024;
};

// X (64 keys x 64 queries) = A (this group's K or V rows) · B (a Q or dO
// tile)ᵀ over d, both K-major; `ob` is the tile's stage offset (start
// address >> 4). Issued and committed as one group.
template <int D>
__device__ __forceinline__ void issue_kq(float (&x)[BQ4 / 2], uint64_t da,
                                         uint64_t db, uint32_t ob) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns inside a 64-column tile: +32 bytes; next tile: +rows·128
    const uint32_t oa = ((kk >> 2) * BKEY * 128 + (kk & 3) * 32) >> 4;
    const uint32_t o = ob + (((kk >> 2) * BQ4 * 128 + (kk & 3) * 32) >> 4);
    sm90::wgmma_ss_n64(x, da + oa, db + o, kk > 0);
  }
  sm90::wgmma_commit();
}

// acc (64 keys x d) += A (registers: Pᵀ or dSᵀ, 64 keys x 64 queries) ·
// B (a dO or Q tile, MN-major: 16 query rows = +2048 bytes); committed
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2],
                                          const uint32_t (&a)[BQ4 / 16][4],
                                          uint64_t db) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BQ4 / 16; ++kk)
    sm90::wgmma_rs<D>(acc, a[kk], db + ((kk * 16 * 128) >> 4), 1);
  sm90::wgmma_commit();
}

// Pᵀ = 2^(Sᵀ·sl2 − lse·log2 e) in place, 0 where the key is masked for the
// query (only `edge` tiles test); ls holds the tile's lse·log2 e
__device__ __forceinline__ void k4_p(float (&sa)[BQ4 / 2], const float* ls,
                                     bool edge, int c0, int tg, int kvlen,
                                     int causal, int q_off, int q0,
                                     float sl2) {
#pragma unroll
  for (int c = 0; c < BQ4 / 8; ++c) {
    const int qi = c * 8 + tg * 2;
    const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * c + 2 * i + j;
        float p = sm90::ex2(fmaf(sa[e], sl2, -(j ? l2.y : l2.x)));
        if (edge) {
          const int key = c0 + 8 * i;
          if (key >= kvlen || (causal && key > q_off + q0 + qi + j)) p = 0.f;
        }
        sa[e] = p;
      }
  }
}

// dSᵀ = Pᵀ∘(dPᵀ − Δ) in place of dPᵀ; dl holds the tile's Δ
__device__ __forceinline__ void k4_ds(const float (&sa)[BQ4 / 2],
                                      float (&dp)[BQ4 / 2], const float* dl,
                                      int tg) {
#pragma unroll
  for (int c = 0; c < BQ4 / 8; ++c) {
    const float2 d2 = *reinterpret_cast<const float2*>(dl + c * 8 + tg * 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dp[4 * c + 2 * i] = sa[4 * c + 2 * i] * (dp[4 * c + 2 * i] - d2.x);
      dp[4 * c + 2 * i + 1] =
          sa[4 * c + 2 * i + 1] * (dp[4 * c + 2 * i + 1] - d2.y);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(K4_THREADS, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, const int* __restrict__ kv_lens,
                   int sq, int sk, int h, int nkv, int causal, int q_off,
                   float scale, int group) {
  using C = Dkv<D>;
  constexpr int ST = C::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = sm90::align1024(smem_raw);
  uint8_t* Ks = sm;
  uint8_t* Vs = sm + C::KV_BYTES;
  uint8_t* Qs = sm + C::Q_OFF;                 // stage s at s·QT_BYTES
  uint8_t* Os = sm + C::O_OFF;
  float* rows = reinterpret_cast<float*>(sm + C::ROW_OFF);  // stage s at
                                                            // s·2·BQ4
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;

  // (batch, kv head) units in groups whose heads' Q and dO stay in L2, the
  // heaviest key blocks (under causal masking the first: they see the most
  // queries) first inside a group
  const int nkt = (sk + BKEY - 1) / BKEY;
  const sm90::BlockOrder ord =
      sm90::block_order(blockIdx.x, gridDim.x / nkt, nkt, group);
  const int k0 = ord.tile * BKEY;
  const int kh = ord.unit % nkv, bi = ord.unit / nkv;
  const int n_rep = h / nkv;
  int kvlen = sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[bi], sk));
  // the first query row that can see a key of this block
  const int nqt = (sq + BQ4 - 1) / BQ4;
  const int qt0 = k0 >= kvlen ? nqt
                              : (causal ? max(0, k0 - q_off) : 0) / BQ4;
  const int per_head = max(0, nqt - qt0);

  if (threadIdx.x == 0) {
    sm90::mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full[s], 32);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // warp-uniform for the compiler, so that setmaxnreg applies per group
  const int wg = __shfl_sync(0xffffffff, threadIdx.x >> 7, 0);
  if (wg == 2) {
    // ---- producer: warp 8 streams, warps 9-11 only give up registers ----
    sm90::setmaxnreg_dec<24>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 288 && per_head > 0) {
      if (lane == 0) {
        sm90::tma_prefetch_map(&mq);
        sm90::tma_prefetch_map(&mo);
        sm90::mbar_arrive_tx(kvbar, 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          sm90::tma_load_4d(Ks + c * BKEY * 128, &mk, kvbar, c * 64, kh, k0,
                            bi);
          sm90::tma_load_4d(Vs + c * BKEY * 128, &mv, kvbar, c * 64, kh, k0,
                            bi);
        }
      }
      int it = 0;
      for (int r = 0; r < n_rep; ++r) {
        const int hi = kh * n_rep + r;
        const float* lb = lse + ((long)bi * h + hi) * sq;
        const float* db = delta + ((long)bi * h + hi) * sq;
        for (int qt = qt0; qt < nqt; ++qt, ++it) {
          const int s = it % ST, q0 = qt * BQ4;
          sm90::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          float* ls = rows + s * 2 * BQ4;
          for (int i = lane; i < BQ4; i += 32) {
            const int q = q0 + i;
            const float l = q < sq ? lb[q] : NEG_INF;
            ls[i] = l > NEG_INF * 0.5f ? l * 1.4426950408889634f : INFINITY;
            ls[BQ4 + i] = q < sq ? db[q] : 0.f;
          }
          if (lane == 0) {
            sm90::mbar_arrive_tx(&full[s], 2 * C::QT_BYTES);
#pragma unroll
            for (int c = 0; c < C::NCH; ++c) {
              sm90::tma_load_4d(Qs + s * C::QT_BYTES + c * BQ4 * 128, &mq,
                                &full[s], c * 64, hi, q0, bi);
              sm90::tma_load_4d(Os + s * C::QT_BYTES + c * BQ4 * 128, &mo,
                                &full[s], c * 64, hi, q0, bi);
            }
          } else {
            sm90::mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    // ---- consumers: keys k0 + 64·wg … +63 ----
    sm90::setmaxnreg_inc<240>();
    const int t = threadIdx.x & 127, wl = t >> 5, lane = t & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int kw0 = k0 + wg * 64;              // the group's first key
    const int c0 = kw0 + wl * 16 + g;          // keys of the rows i = 0, 1
    const float sl2 = scale * 1.4426950408889634f;

    float dva[D / 2], dka[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dva[i] = dka[i] = 0.f;

    if (per_head > 0) {
      // K-major descriptors (K, V rows of this group as A; Q, dO as B) and
      // MN-major ones (dO, Q as B of the dv/dk products); a stage is
      // +QT_BYTES >> 4 on the start address
      const uint64_t dK = sm90::desc_sw128(Ks + wg * 64 * 128, 16, 1024);
      const uint64_t dV = sm90::desc_sw128(Vs + wg * 64 * 128, 16, 1024);
      const uint64_t dQ = sm90::desc_sw128(Qs, 16, 1024);
      const uint64_t dO = sm90::desc_sw128(Os, 16, 1024);
      const uint64_t dQt = sm90::desc_sw128(Qs, BQ4 * 128, 1024);
      const uint64_t dOt = sm90::desc_sw128(Os, BQ4 * 128, 1024);
      constexpr uint32_t STAGE = C::QT_BYTES >> 4;

      sm90::mbar_wait(kvbar, 0);
      // tile it is query tile qt0 + it % per_head of head it / per_head; a
      // group whose keys no row of the tile can see skips it
      const int n = n_rep * per_head;
      auto skip = [&](int it) {
        return kw0 >= kvlen ||
               (causal && kw0 > q_off + (qt0 + it % per_head) * BQ4 + BQ4 - 1);
      };
      // Each pass is self-contained (its products are waited for inside
      // it): no wgmma is in flight across the loop edge, which would make
      // ptxas serialise them. The two consumer groups overlap each other.
      for (int it = 0; it < n; ++it) {
        const int s = it % ST;
        const int q0 = (qt0 + it % per_head) * BQ4;
        sm90::mbar_wait(&full[s], (it / ST) & 1);
        if (!skip(it)) {
          float sa[BQ4 / 2], dp[BQ4 / 2];
          uint32_t pa[BQ4 / 16][4], da[BQ4 / 16][4];
          const float* ls = rows + s * 2 * BQ4;   // lse·log2 e, then Δ
          const bool edge = kw0 + 63 >= kvlen ||
                            (causal && kw0 + 63 > q_off + q0);
          const uint32_t so = s * STAGE;
          issue_kq<D>(sa, dK, dQ, so);   // Sᵀ
          issue_kq<D>(dp, dV, dO, so);   // dPᵀ
          sm90::wgmma_wait<0>();
          sm90::fence_regs(sa);
          sm90::fence_regs(dp);
          k4_p(sa, ls, edge, c0, tg, kvlen, causal, q_off, q0, sl2);
          k4_ds(sa, dp, ls + BQ4, tg);
          sm90::pack_a<BQ4>(dp, da);
          sm90::pack_a<BQ4>(sa, pa);
          issue_acc<D>(dva, pa, dOt + so);
          issue_acc<D>(dka, da, dQt + so);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(dva);
          sm90::fence_regs(dka);
        }
        sm90::mbar_arrive(&empty[s]);
      }
    }

    const long kv_rs = (long)nkv * D;
    const long kv_base = (long)bi * sk * kv_rs + (long)kh * D;
    bf16* dkb = dk + kv_base;
    bf16* dvb = dv + kv_base;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = c0 + 8 * i;
      if (key < sk) {
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const int col = c * 8 + tg * 2;
          *reinterpret_cast<uint32_t*>(dkb + key * kv_rs + col) =
              pack_f2(dka[4 * c + 2 * i] * scale,
                      dka[4 * c + 2 * i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvb + key * kv_rs + col) =
              pack_f2(dva[4 * c + 2 * i], dva[4 * c + 2 * i + 1]);
        }
      }
    }
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* kv_lens, int b, int sq, int sk, int h, int nkv,
               int causal, int q_off, float scale, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mo;
  int err = sm90_map_bshd(&mq, q, b, sq, h, D, BQ4);
  if (!err) err = sm90_map_bshd(&mo, dout, b, sq, h, D, BQ4);
  if (!err) err = sm90_map_bshd(&mk, k, b, sk > 1 ? sk : 1, nkv, D, BKEY);
  if (!err) err = sm90_map_bshd(&mv, v, b, sk > 1 ? sk : 1, nkv, D, BKEY);
  if (err) return err;
  auto kern = flash_bwd_dkv_sm90<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Dkv<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  // a (batch, kv head) unit streams its n_rep heads' Q and dO
  const int group = sm90_group((long long)(h / nkv) * sq * D * 4);
  const int grid = ((sk + BKEY - 1) / BKEY) * nkv * b;
  kern<<<grid, K4_THREADS, Dkv<D>::SMEM, st>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, (const int*)kv_lens, sq, sk, h, nkv, causal, q_off, scale,
      group);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, kv_lens, b, sq,
                           sk, h, nkv, causal, q_off, scale, st);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, kv_lens, b, sq,
                          sk, h, nkv, causal, q_off, scale, st);
  return (int)cudaErrorInvalidValue;
}
