// Row sums of the flash-attention general mode's dead rows, for Hopper
// (sm_90a): out[b, o, :] = scale · Σ x[b, r, hq, :] over the rows r of the
// query heads hq of group o (o·G … o·G + G - 1), every row or only those
// a bit mask selects.
//
// Replaces no TPU kernel. A row that a bool mask hides at every key the
// structured masks leave it (a "dead" row, csrc/attn_mask.cuh) has a
// closed form when there is no dropout: its output is the mean of v over
// all sk keys, and its backward gives dO / sk to every key's dv. K1 and K4
// take such rows off their tile walks and read these sums instead (K1: the
// mean of v, x = v (b, sk, nkv, d), G = 1, every row, scale 1 / sk; K4: the
// sum of the dead rows' dO over a kv head's query heads, x = dO (b, sq, h,
// d), G = h / nkv, the rows of `bits`). The reference computes the same
// values in its dense softmax (paddle_tpu/ops/flash_attention.py
// `_xla_attention`, :99-141). Launched only for a call that has a dead row.
//
// What bounds it on the H100: it reads x once (the dead rows only, with
// bits) and writes b·groups·d fp32: memory bound, 3.35 TB/s. Design: a
// (batch, group)'s G·R rows are split over `nsplit` blocks (so that about
// two blocks a SM run at train_mistral_pad's 16 units), each of 256 threads
// as d / 8 column groups of 16 bytes (8 bf16) by 256 / (d / 8) row lanes,
// each lane summing its rows in fp32 in order and the lanes' sums added in
// a fixed order through shared memory; with nsplit > 1 each block writes
// its partial sum, and the unit's last block to finish (a ticket counter,
// reset by it) adds the partials in split order. No atomics on the sums:
// two launches give equal bits.
//
// Layouts: x (b, R, NH, d) bf16 contiguous (16-byte aligned); out (b,
// groups, d) fp32; part (b·groups·nsplit, d) fp32 scratch and ticket
// (b·groups,) int32 zeros (nsplit > 1); bits (or null: every row) 64 rows
// a word, (b, hq) at bits + b·bsb + hq·bsh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int D>
__global__ void __launch_bounds__(THREADS)
row_sums_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                float* __restrict__ part, int* __restrict__ ticket,
                const unsigned long long* __restrict__ bits, long long bsb,
                long long bsh, int R, int NH, int groups, int nsplit,
                float scale) {
  constexpr int CG = D / 8;             // 16-byte column groups a row
  constexpr int RL = THREADS / CG;      // row lanes
  __shared__ float lanes[RL][D];
  __shared__ int last;
  const int u = blockIdx.x / nsplit, sp = blockIdx.x % nsplit;
  const int bi = u / groups, o = u % groups;
  const int G = NH / groups;
  // this block's rows of the unit's G·R (head-major)
  const long long total = (long long)G * R;
  const long long per = (total + nsplit - 1) / nsplit;
  const long long lo = sp * per, hi = min(total, lo + per);
  const int cg = threadIdx.x % CG, rl = threadIdx.x / CG;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (long long f = lo + rl; f < hi; f += RL) {
    const int gi = (int)(f / R), r = (int)(f - (long long)gi * R);
    const int hq = o * G + gi;
    if (bits != nullptr &&
        !((__ldg(bits + bi * bsb + hq * bsh + (r >> 6)) >> (r & 63)) & 1ull))
      continue;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        x + (((long long)bi * R + r) * NH + hq) * D + cg * 8));
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f2 = __bfloat1622float2(p[k]);
      acc[2 * k] += f2.x;
      acc[2 * k + 1] += f2.y;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) lanes[rl][cg * 8 + k] = acc[k];
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float sum = 0.f;
    for (int l = 0; l < RL; ++l) sum += lanes[l][c];
    if (nsplit == 1)
      out[(long long)u * D + c] = sum * scale;
    else
      part[((long long)u * nsplit + sp) * D + c] = sum;
  }
  if (nsplit == 1) return;
  // the unit's last block to finish adds the partials in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket + u, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float sum = 0.f;
    for (int k = 0; k < nsplit; ++k)
      sum += __ldcg(part + ((long long)u * nsplit + k) * D + c);
    out[(long long)u * D + c] = sum * scale;
  }
  if (threadIdx.x == 0) ticket[u] = 0;
}

}  // namespace

// x (b, R, NH, d) bf16, out (b, groups, d) fp32, bits (or null) the rows'
// selection, 64 rows a word at bits + b·bsb + hq·bsh; d 64, 128 or 256,
// NH a multiple of groups; nsplit > 1: part (b·groups·nsplit·d fp32) and
// ticket (b·groups int32, zeros) the scratch
extern "C" int attn_row_sums(const void* x, void* out, void* part,
                             void* ticket, const void* bits, long long bsb,
                             long long bsh, int b, int R, int NH, int groups,
                             int d, int nsplit, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (groups <= 0 || NH % groups || b <= 0 || R < 0 || nsplit < 1 ||
      (nsplit > 1 && (part == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int grid = b * groups * nsplit;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* bw = (const unsigned long long*)bits;
#define ROW_SUMS(D)                                                         \
  row_sums_kernel<D><<<grid, THREADS, 0, st>>>(xb, (float*)out,             \
                                               (float*)part, (int*)ticket,  \
                                               bw, bsb, bsh, R, NH, groups, \
                                               nsplit, scale)
  if (d == 64)
    ROW_SUMS(64);
  else if (d == 128)
    ROW_SUMS(128);
  else if (d == 256)
    ROW_SUMS(256);
  else
    return (int)cudaErrorInvalidValue;
#undef ROW_SUMS
  return (int)cudaGetLastError();
}
