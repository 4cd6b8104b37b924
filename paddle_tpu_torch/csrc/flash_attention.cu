// Flash-attention forward for Hopper (sm_90a): blockwise online softmax,
// bf16 tensor-core products (mma.sync m16n8k16) with fp32 accumulation.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py::_fwd_kernels
// (pallas_call at :648) on the serving path: causal with an explicit query
// offset (k_pos <= q_off + i), GQA by indexing kv head hi / rep (k and v are
// never repeated), per-batch kv_lens, and fully-masked rows giving 0.
//
// What bounds it on the H100: at prefill shapes (sq ~ sk ~ 1k, d = 128) the
// work is ~4·d FLOPs per (query, key) pair against ~4·d bytes per query row,
// so it is compute bound: tensor-core rate, 989 TFLOP/s bf16 dense. The design
// keeps the (sq, sk) score matrix out of device memory (one 64×64 tile of it
// lives in registers at a time), skips every k tile past the causal or
// kv_len limit, and feeds Q from registers and K/V from padded shared memory
// (row stride d+8 bf16, so the B-fragment reads of K hit 32 distinct banks).
// It is a first, simple kernel: synchronous tile loads, mma.sync instead of
// wgmma, no TMA and no warp specialisation.
//
// Layouts: q (b, sq, h, d), k/v (b, sk, nkv, d), out (b, sq, h, d), all
// bf16 and contiguous; lse (b, h, sq) fp32; kv_lens (b,) int32 or null.
// Grid (ceil(sq/64), h, b); 128 threads = 4 warps, 16 query rows each.

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

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ kv_lens,
                 int sq, int sk, int h, int nkv, int causal, int q_off,
                 float scale) {
  constexpr int LD = D + 8;  // padded smem row (bf16 elements)
  __shared__ __align__(16) bf16 Ks[BK * LD];
  __shared__ __align__(16) bf16 Vs[BK * LD];

  const int qt = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int kh = hi / (h / nkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const long q_rs = (long)h * D;
  const long kv_rs = (long)nkv * D;
  const bf16* qb = q + (long)bi * sq * q_rs + (long)hi * D;
  const bf16* kb = k + (long)bi * sk * kv_rs + (long)kh * D;
  const bf16* vb = v + (long)bi * sk * kv_rs + (long)kh * D;

  int kvlen = sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[bi], sk));
  const int r0 = qt * BQ + warp * 16 + g;  // rows held in c0/c1 ...
  const int r1 = r0 + 8;                   // ... and in c2/c3

  // Q as A fragments, straight from device memory (read once).
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    qf[kk][0] = r0 < sq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_rs + c) : 0u;
    qf[kk][1] = r1 < sq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_rs + c) : 0u;
    qf[kk][2] = r0 < sq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_rs + c + 8) : 0u;
    qf[kk][3] = r1 < sq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_rs + c + 8) : 0u;
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // k tiles that can hold a visible key for any row of this block
  int kend = kvlen;
  if (causal) {
    const int last_q = min(qt * BQ + BQ - 1, sq - 1);
    kend = min(kend, q_off + last_q + 1);
  }
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int idx = tid; idx < BK * CH; idx += 128) {
      const int r = idx / CH, c = (idx % CH) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < sk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (long)(k0 + r) * kv_rs + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (long)(k0 + r) * kv_rs + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LD + c]) = kv4;
      *reinterpret_cast<uint4*>(&Vs[r * LD + c]) = vv4;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows × 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* kp = &Ks[(n * 8 + g) * LD + kk * 16 + tg * 2];
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(kp);
        bfr[1] = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma16816(s[n], qf[kk], bfr);
      }
    }

    // scale + mask, then the online-softmax update
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + n * 8 + tg * 2 + j;
        const bool ok0 = kc < kvlen && (!causal || kc <= q_off + r0);
        const bool ok1 = kc < kvlen && (!causal || kc <= q_off + r1);
        s[n][j] = ok0 ? s[n][j] * scale : NEG_INF;
        s[n][2 + j] = ok1 ? s[n][2 + j] * scale : NEG_INF;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
    // rows with no visible key yet keep m at NEG_INF: their p must be 0
    const bool dead0 = mx0 <= NEG_INF * 0.5f, dead1 = mx1 <= NEG_INF * 0.5f;
    const float a0 = __expf(m0 - mx0), a1 = __expf(m1 - mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[n][j] = dead0 ? 0.f : __expf(s[n][j] - mx0);
        s[n][2 + j] = dead1 ? 0.f : __expf(s[n][2 + j] - mx1);
        rs0 += s[n][j];
        rs1 += s[n][2 + j];
      }
    }
    l0 = l0 * a0 + rs0;  // per-thread partial row sums, reduced at the end
    l1 = l1 * a1 + rs1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= a0; o[dn][1] *= a0;
      o[dn][2] *= a1; o[dn][3] *= a1;
    }

    // O += P V: the S accumulators of two adjacent key octets form one
    // 16-key A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const bf16* vp = &Vs[(kk * 16 + tg * 2) * LD + dn * 8 + g];
        uint32_t bfr[2];
        bfr[0] = pack_b2(vp[0], vp[LD]);
        bfr[1] = pack_b2(vp[8 * LD], vp[9 * LD]);
        mma16816(o[dn], pa, bfr);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  bf16* ob = out + (long)bi * sq * q_rs + (long)hi * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + tg * 2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_rs + c) =
          pack_f2(o[dn][0] * inv0, o[dn][1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_rs + c) =
          pack_f2(o[dn][2] * inv1, o[dn][3] * inv1);
  }
  if (tg == 0) {
    float* lb = lse + ((long)bi * h + hi) * sq;
    if (r0 < sq) lb[r0] = m0 + logf(l0 == 0.f ? 1.f : l0);
    if (r1 < sq) lb[r1] = m1 + logf(l1 == 0.f ? 1.f : l1);
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, const void* kv_lens,
                                   int b, int sq, int sk, int h, int nkv,
                                   int d, int causal, int q_off, float scale,
                                   void* stream) {
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* qp = (const bf16*)q;
  const bf16* kp = (const bf16*)k;
  const bf16* vp = (const bf16*)v;
  if (d == 128) {
    flash_fwd_kernel<128><<<grid, 128, 0, st>>>(
        qp, kp, vp, (bf16*)out, (float*)lse, (const int*)kv_lens, sq, sk, h,
        nkv, causal, q_off, scale);
  } else if (d == 64) {
    flash_fwd_kernel<64><<<grid, 128, 0, st>>>(
        qp, kp, vp, (bf16*)out, (float*)lse, (const int*)kv_lens, sq, sk, h,
        nkv, causal, q_off, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
