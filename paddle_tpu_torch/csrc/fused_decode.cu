// Fused decode step for Hopper (sm_90a): one token through every layer of
// a llama stack, bf16 weights, bf16 KV cache, fp32 residual stream.
//
// Replaces the TPU kernel paddle_tpu/ops/fused_decode.py::_fused_decode_pallas
// (pallas_call at :940), llama arch, bf16 mode. Per layer, on one stream,
// issued by one C call for the whole stack:
//   1. skinny GEMM  qkv = rms(x, ln1) @ wqkv            (RMSNorm rows)
//   2. rope + cache append at pos + attention over the filled prefix [0, pos]
//      (the split-KV attention section: one launch)
//   3. skinny GEMM  x += attn @ wo                       (residual epilogue)
//   4. skinny GEMM  act = silu(rms(x, ln2) @ wg) * (rms(x, ln2) @ wu)
//   5. skinny GEMM  x += act @ wd                        (residual epilogue)
// A skinny GEMM is three launches: a row kernel that writes the normalised
// bf16 rows (RMSNorm; the o-proj and down products read their bf16 input as
// it is), the split-K partial products on the product engine below, and an
// epilogue that sums the partials in a fixed order and applies the residual
// add or SwiGLU (gate and up are one engine launch over two weights) —
// 1 + 11 launches per layer.
// Casts sit where fused_decode_reference puts them: activations are rounded
// to bf16 before each product, products accumulate in fp32, q/k/v and the
// residual stay fp32, k and v are rounded to bf16 by the cache append.
//
// What bounds it on the H100: bytes. At b <= 64 every weight element is used
// at most 64 times, far below the ~295 FLOP/byte ridge, so a step can take
// no less than (all layer weights + the filled KV prefix) / 3.35 TB/s.
// Attention reads only the filled prefix, never the unfilled tail (split
// over the KV length into 512-key chunks on persistent blocks, below). No
// CUDA graph, no persistent megakernel.
//
// The product engine (engine_kernel; K2, K5 and K6's attention half). The
// weight stream has to keep ~3.35 TB/s in flight, and a register GEMM that
// unpacks every weight element and issues b FMAs for it on the CUDA cores
// is bound by the instructions it issues long before that (on an H100 such
// a GEMM's products ran at about 1.1 TB/s at b = 8). The engine moves the arithmetic onto the
// tensor cores and the loads onto the TMA, so no thread touches a weight
// element on its way to a product:
//  * Operands swapped: the weight tile is wgmma's A (64 output columns x 16
//    of the contraction, MN-major as (in, out) stores it, tnspA = 1), the
//    activation rows are B (K-major, N = the rows rounded up to 8, 16, 32
//    or 64), so the accumulator is 64 x N fp32 a warpgroup (<= 32 registers
//    a thread) and rows up to 64 cost the stream nothing.
//  * One persistent block per SM walks the product's units (128 output
//    columns x one contraction split; SwiGLU's gate and up are two unit
//    sets of one launch). One producer warp issues TMA loads of 64 (bf16)
//    or 128 (int8) contraction rows x 128 columns of the weight (one 3-d
//    map per weight stack, the layer a coordinate) and the matching columns
//    of the rows (a 2-d map) into a ring of 4-12 stages (64-200 KB of
//    weights in flight per SM), with full and empty mbarriers; consumer
//    warpgroups, one per 64 columns (int8: two, see below), issue the
//    wgmmas. The ring runs across unit boundaries, so one unit's partial
//    store overlaps the next unit's loads.
//  * Each launch is the programmatic dependent of the kernel before it (the
//    norm rows, the attention or the SwiGLU/GELU epilogue, which let it
//    start at once): its first ring's worth of weight tiles streams while
//    that kernel runs, and only the rows wait for it (griddepcontrol).
//  * The splits are chosen on the host so that the busiest SM's share of
//    the weight stream (whole waves of units) plus the partials' traffic
//    is least; the partials ws[ks][row][col] are summed in a fixed order by
//    the epilogue kernels, with no atomics, so two launches give the same
//    bits and K5 gives K2's.
//  * Int8 weights (K2's int8 modes): the TMA loads the int8 tile (half the
//    bytes, 128 contraction rows a stage); a consumer group turns its 64
//    columns into a bf16 tile in shared memory, exactly (|q| <= 127 fits a
//    bf16), then fence.proxy.async and a group barrier, and runs the bf16
//    wgmma on it; a second group barrier after the wgmmas keeps the next
//    stage's conversion off the copy until all four warps have read it. Four groups, two a column half taking the stages in turn,
//    so one converts while the other multiplies; each writes its own
//    partial set, and the epilogue sums the 2 x ks sets in a fixed order.
//    A shared-memory copy rather than a register A operand: the register
//    form needs the tile transposed into the A fragment, which the MN-major
//    tile does not give without a byte shuffle per element. The
//    per-out-channel scale stays in the epilogue, after the fixed-order sum.
//
// Two entry points share every launch above: fused_decode_llama (K2) over
// the contiguous cache (L, b, S, 2*nkv*hd) at one position, and
// fused_paged_decode_llama (K5, the serving engine's step) over the paged
// pool (L, NB, BT, 2*nkv*hd) through per-row block tables and positions.
// Only step 2's addressing differs (the key policies ContigKV / PagedKV of
// the split-KV attention). K5's bound is bytes as well: the layer weights
// plus each row's own filled KV.
//
// A third entry point, fused_paged_verify_llama (K7, speculative decoding's
// verify step), runs up to 64 tail rows (b rows x K1 tail tokens) through
// the same stack: the same products on the engine, norm-row and epilogue
// kernels, over M = b*K1 rows, and the same split-KV attention kernel with
// its appends and merge as kernels of their own (see the K7 section). A
// fourth,
// fused_decode_moe (K6, the MoE step), runs K2's attention half and then
// the routed and shared experts on an mma.sync tensor-core GEMM (see the
// K6 section).
//
// Row caps: one launch of K2, K5 or K7 takes at most 64 rows (the engine's
// widest wgmma N), K6 at most 8 rows and 64 (row, choice) pairs. A step
// with more rows is run by the Python wrappers as consecutive launches
// over groups of rows on one stream (ops/fused_decode.py, row_groups);
// the rows are independent through the whole stack, so a group computes
// what the whole batch would, up to the split choices eplan makes by the
// group's row count. The contiguous cache's entry points take the cache's
// batch extent `cb` apart from the group's rows b, so a group reads and
// appends its rows in place (layer stride cb*S*2*nkv*hd).
//
// The gpt mode of K2, K5 and K7 (fused_decode_gpt, fused_paged_decode_gpt,
// fused_paged_verify_gpt; the TPU kernels' arch="gpt" branches): LayerNorm
// with bias, biases on all four products, no rope, a tanh-GELU FFN with no
// up-projection. It adds kernels beside the llama ones and changes none of
// theirs: a LayerNorm kernel (layernorm_rows_kernel) writes the bf16 rows
// the product engine reads, as the RMSNorm kernel does for llama; bias
// epilogues (bias_epilogue_kernel) add each product's bias after the
// fixed-order split-K sum, never in a partial; and the attention kernel
// takes a compile-time ROPE flag, false here. See the gpt section near the
// end.
//
// The int8 modes of K2, K5 and K7 (the TPU kernels' `int8` and `kvq`
// branches; the llama entry points with scale rows, the llama and gpt
// entry points with kv scales). Int8 weights (llama): int8 stacks
// stream through the product engine's int8 path (above); the
// per-out-channel scale multiplies each output once, after the fixed-order
// split-K sum, in the epilogue: qkv, the o-proj before its residual add,
// gate and up before SwiGLU, down before its residual add (the reference's
// y * s after the full dot). Int8 KV (llama, gpt, and K6's moe): a cache
// policy (ContigKV<int8_t>) makes the attention kernel store the append as
// rint(v / scale) clipped to +-127 and read keys and values as int8 (TMA
// boxes of int8, widened to bf16 in shared memory, exactly); since a scale
// is one value per (layer, kv head), the k scale folds into the staged q
// and the v scale multiplies the attention output once. The int8 pool of
// K5 and K7 (PagedKV<int8_t>, VerifyKV<int8_t>) is the same with per-row
// scales (a serving slot calibrates its own, (L, b, 2*nkv*hd)): the append
// quantizes with the row's scales (K7's appends kernel too), and its k
// scale folds into that row's q and its v scale into that row's output.
// Bound: bytes, as the bf16 mode's, with half the weight and KV bytes.

#include "hopper_sm90.cuh"

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1e30f)

namespace {

enum { MODE_QKV = 0, MODE_SWIGLU = 1, MODE_RESID = 2 };
// the gpt mode's bias epilogues: qkv + b; x + (o + b); (x + d) + b;
// bf16(gelu_tanh(g + b))
enum { MODE_QKV_B = 3, MODE_ORES_B = 4, MODE_FRES_B = 5, MODE_GELU_B = 6 };

constexpr int GT = 256;  // threads per GEMM block
constexpr int NWG = GT / 32;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NWG; ++w) s += red[w];
  return s;
}

// Sum the ks partials of each output in a fixed order (deterministic) and
// apply MODE's epilogue: store fp32 (qkv), add into the fp32 residual
// (optionally writing its bf16 copy), or SwiGLU into bf16 activations. SC
// (int8 weights) first multiplies each sum by its out channel's scale
// (sc0; sc1 for SwiGLU's up; out columns a row).
template <int MODE, bool SC = false>
__global__ void gemm_epilogue_kernel(const float* __restrict__ ws0,
                                     const float* __restrict__ ws1, int ks,
                                     int n, float* __restrict__ yf,
                                     bf16* __restrict__ yb,
                                     const float* __restrict__ sc0 = nullptr,
                                     const float* __restrict__ sc1 = nullptr,
                                     int out = 1) {
  sm90::griddep_launch_dependents();   // the next product's weights may load
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < ks; ++k) s += ws0[(long)k * n + i];
  if (SC) s *= sc0[i % out];
  if (MODE == MODE_QKV) {
    yf[i] = s;
  } else if (MODE == MODE_RESID) {
    const float nx = yf[i] + s;
    yf[i] = nx;
    if (yb != nullptr) yb[i] = __float2bfloat16(nx);
  } else {
    float u = 0.f;
    for (int k = 0; k < ks; ++k) u += ws1[(long)k * n + i];
    if (SC) u *= sc1[i % out];
    const float sg = s * (1.f / (1.f + expf(-s)));  // silu in fp32
    yb[i] = __float2bfloat16(sg * u);
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// ---- mma.sync building blocks (the split-KV attention, K6's experts) ---------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; ok == false writes 16 zero
// bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the transpose of an 8 x 8 b16 matrix in mma's fragment layout (thread
// t holds row t/4, columns 2 (t%4) and 2 (t%4) + 1) across the warp
__device__ __forceinline__ unsigned movmatrix_trans(unsigned a) {
  unsigned d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// RMSNorm of each row into bf16, one block per row, the plain version's
// rounding bf16(bf16(x * rstd) * w): the rows K2's, K5's, K6's and K7's
// products read.
__global__ void __launch_bounds__(GT)
rms_rows_kernel(const float* __restrict__ xf, const bf16* __restrict__ lnw,
                bf16* __restrict__ xn, int in, float eps) {
  sm90::griddep_launch_dependents();   // the next product's weights may load
  __shared__ float tmp[NWG];
  const float* x = xf + (long)blockIdx.x * in;
  float ss = 0.f;
  for (int k = threadIdx.x; k < in; k += GT) ss += x[k] * x[k];
  ss = block_sum(ss, tmp);
  const float rstd = 1.f / sqrtf(ss / (float)in + eps);
  for (int k = threadIdx.x; k < in; k += GT)
    xn[(long)blockIdx.x * in + k] = __float2bfloat16(
        bf16_round(x[k] * rstd) * __bfloat162float(lnw[k]));
}

// ---------------------------------------------------------------------------
// The product engine (see the note at the top): split-K partial products
// ws[z][ks][row][col] of Y(rows, out) = X(rows, in) @ W_z(in, out) for rows
// <= 64, one launch per product (z = 0; SwiGLU's gate and up z = 0, 1).
// ---------------------------------------------------------------------------

constexpr int EKP = 128;        // contraction rows a split is a multiple of
constexpr int ECOLS = 128;      // output columns per unit (2 x 64)
constexpr int ERING = 216 * 1024;   // shared memory for the ring (+ copies)

// The rows rounded up to wgmma's N: 8, 16, 32 or 64 (0: more than 64).
constexpr int erows(int b) {
  return b <= 8 ? 8 : b <= 16 ? 16 : b <= 32 ? 32 : b <= 64 ? 64 : 0;
}

// The weight types: the consumer warpgroups, the contraction rows of a
// stage (EK), the bytes of its weight tile (EK x ECOLS) and of the
// consumer groups' bf16 copies (int8 only: one EK x 64 tile a group). The
// int8 path's consumers convert before they multiply, so it runs two
// groups a column half that take the stages in turn (one converts while
// the other's wgmmas run), and its stages are twice as deep as bf16 ones,
// so the copy's fixed costs a stage (the proxy fence, the group barrier)
// fall on as many weight bytes.
template <class W>
struct EngW;
template <>
struct EngW<bf16> {
  static constexpr bool I8 = false;
  static constexpr int CG = 2;   // consumer warpgroups: one per 64 columns
  static constexpr int PSETS = 1;   // partial sets a split writes
  static constexpr int EK = 64;
  static constexpr int WBYTES = EK * ECOLS * 2;
  static constexpr int CBUF = 0;
};
template <>
struct EngW<int8_t> {
  static constexpr bool I8 = true;
  static constexpr int CG = 4;   // two per 64 columns: even and odd stages
  static constexpr int PSETS = 2;   // the even and the odd stages' sums
  static constexpr int EK = 128;
  static constexpr int WBYTES = EK * ECOLS;
  static constexpr int CBUF = CG * EK * 64 * 2;
};

// threads of an engine block: the consumer warpgroups, then the producer
// warp
template <class W>
constexpr int ethreads() {
  return EngW<W>::CG * 128 + 32;
}

// Shared memory: [bf16 copies][stage 0: W tile, X tiles][stage 1]...
// [full and empty barriers]; every region 1024-byte aligned (a W tile is
// EK rows of 128 bytes per 64 (bf16) or 128 (int8) columns, an X tile N
// rows of 128 bytes per 64 contraction columns).
template <int N, class W>
struct ELayout {
  static constexpr int XBYTES = N * EngW<W>::EK * 2;
  static constexpr int STAGE = EngW<W>::WBYTES + XBYTES;
  static constexpr int ST = (ERING - EngW<W>::CBUF) / STAGE;
  static constexpr int BAR_OFF = EngW<W>::CBUF + ST * STAGE;
  static constexpr int SMEM = BAR_OFF + 2 * ST * 8 + 1024;
};

// A product's walk: ks contraction splits of kper rows (a multiple of EKP),
// nct column tiles, units = nz * nct * ks; unit u is weight z = u / (nct *
// ks), column tile (u % (nct * ks)) % nct, split (u % (nct * ks)) / nct.
struct EPlan {
  int ks, kper, nct, units, in;
};

// A block's walk over its chunks (one stage each): unit u = blockIdx.x,
// blockIdx.x + gridDim.x, ...; in a unit, contraction rows k = k0, k0 + EK,
// ... below k1.
struct ECursor {
  const EPlan& p;
  int u, z, n0, k, k1;
  __device__ explicit ECursor(const EPlan& p_) : p(p_) {
    start(blockIdx.x);
  }
  __device__ void start(int uu) {
    u = uu;
    const int per_z = p.nct * p.ks, r = u % per_z;
    z = u / per_z;
    n0 = (r % p.nct) * ECOLS;
    k = (r / p.nct) * p.kper;
    k1 = min(p.in, k + p.kper);
  }
  __device__ void next(int ek) {
    k += ek;
    if (k >= k1) start(u + gridDim.x);
  }
};

// 16 int8 weights (one row, 16 columns) to 16 bf16, exactly: byte q, biased
// to u = q ^ 0x80 (= q + 128), becomes the mantissa of 2^23 (one byte
// permute), and (2^23 + u) - (2^23 + 128) = q, then a bf16 pair per two.
__device__ __forceinline__ void int8x16_to_bf16(const uint4& v, uint4& lo,
                                                uint4& hi) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                         v.z ^ 0x80808080u, v.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t x = w[i / 2];
    const int b0 = (i % 2) * 2;
    const float f0 = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | b0)) -
                     8388736.f;
    const float f1 =
        __int_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | (b0 + 1))) -
        8388736.f;
    o[i] = sm90::pack_f2(f0, f1);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

template <int N, class W>
__global__ void __launch_bounds__(ethreads<W>(), 1)
engine_kernel(const __grid_constant__ CUtensorMap w0,
              const __grid_constant__ CUtensorMap w1,
              const __grid_constant__ CUtensorMap xm, float* __restrict__ ws0,
              float* __restrict__ ws1, const EPlan p, int layer, int rows,
              int out) {
  using Ly = ELayout<N, W>;
  constexpr int ST = Ly::ST;
  constexpr bool I8 = EngW<W>::I8;
  constexpr int EK = EngW<W>::EK;
  extern __shared__ uint8_t esm_raw[];
  uint8_t* sm = sm90::align1024(esm_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Ly::BAR_OFF);
  uint64_t* empty = full + ST;
  uint8_t* stages = sm + EngW<W>::CBUF;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int per_z = p.nct * p.ks;
  // warp-uniform for the compiler: the producer warp and the groups
  const int warp = __shfl_sync(0xffffffff, threadIdx.x >> 5, 0);

  if (warp == EngW<W>::CG * 4) {
    // ---- producer: one thread issues every load ----
    if ((threadIdx.x & 31) == 0) {
      sm90::tma_prefetch_map(&w0);
      sm90::tma_prefetch_map(&w1);
      sm90::tma_prefetch_map(&xm);
      // The weights are never written, so the first ring's worth of weight
      // tiles loads while the kernel before this one still runs (launched
      // as its programmatic dependent); the rows it writes load only after
      // griddep_wait. Two cursors walk the block's chunks: w for the
      // weight tiles, x for the rows.
      ECursor w(p), x(p);
      int total = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int k0 = (u % per_z) / p.nct * p.kper;
        total += (min(p.in, k0 + p.kper) - k0 + EK - 1) / EK;
      }
      const int pre = total < ST ? total : ST;
      auto load_w = [&](int it) {
        const int s = it % ST;
        sm90::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        uint8_t* stg = stages + s * Ly::STAGE;
        const CUtensorMap* wm = w.z ? &w1 : &w0;
        if (I8) {
          sm90::mbar_arrive_tx(&full[s], Ly::STAGE);
          sm90::tma_load_3d(stg, wm, &full[s], w.n0, w.k, layer);
        } else {
          // a second 64-column tile wholly past `out` is not loaded (its
          // group's products are never stored)
          const bool two = w.n0 + 64 < out;
          sm90::mbar_arrive_tx(&full[s], Ly::STAGE - (two ? 0 : EK * 128));
          sm90::tma_load_3d(stg, wm, &full[s], w.n0, w.k, layer);
          if (two)
            sm90::tma_load_3d(stg + EK * 128, wm, &full[s], w.n0 + 64, w.k,
                              layer);
        }
        w.next(EK);
      };
      auto load_x = [&](int it) {
        const int s = it % ST;
        uint8_t* stg = stages + s * Ly::STAGE;
#pragma unroll
        for (int xb = 0; xb < EK / 64; ++xb)
          sm90::tma_load_2d(stg + EngW<W>::WBYTES + xb * N * 128, &xm,
                            &full[s], x.k + 64 * xb, 0);
        x.next(EK);
      };
      for (int it = 0; it < pre; ++it) load_w(it);
      sm90::griddep_wait();
      for (int it = 0; it < pre; ++it) load_x(it);
      for (int it = pre; it < total; ++it) {
        load_w(it);
        load_x(it);
      }
    }
    return;
  }

  // ---- consumers: group g owns columns n0 + 64 half ... + 63 of a unit;
  // int8: groups g and g + 2 take the even and the odd ring stages ----
  const int g = warp >> 2, half = g & 1, par = g >> 1;
  const int t = threadIdx.x & 127, wl = t >> 5, lane = t & 31;
  // Every partial store comes after the kernel before this one (the last
  // reader of ws0/ws1, e.g. the SwiGLU epilogue before the down product).
  // A store after a full barrier is, since the rows load after the
  // producer's wait; an int8 group that a unit leaves no stage stores zeros
  // without one, so the consumers wait too (nothing to do before the rows
  // land anyway).
  sm90::griddep_wait();
  uint8_t* cb = sm + g * (EK * 128);   // int8: the group's bf16 copy
  float d[N / 2];
  int it = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int z = u / per_z, r = u % per_z;
    const int n0 = (r % p.nct) * ECOLS, ksi = r / p.nct;
    const int k0 = ksi * p.kper, k1 = min(p.in, k0 + p.kper);
    bool any = false;
    for (int k = k0; k < k1; k += EK, ++it) {
      // int8: a stage belongs to one group pair for good (by its index, not
      // by the chunk's place in its unit), so a group waits on every fill
      // of its stages in order. Were it to skip a fill of one of them, its
      // parity wait for the next fill would pass while the skipped fill is
      // still in flight (the barrier two phases behind reads as done): a
      // read of the wrong tile, an early release, and in time a ring that
      // never fills (a hang of the int8 products).
      if (I8 && ((it % ST) & 1) != par) continue;
      const int s = it % ST;
      uint8_t* stg = stages + s * Ly::STAGE;
      sm90::mbar_wait(&full[s], (it / ST) & 1);
      const uint8_t* wt = stg + half * EK * 128;
      if (I8) {
        // raw tile: EK rows of 128 int8 columns; the copy: EK rows of this
        // group's 64 columns in bf16; both 128-byte swizzled (16-byte chunk
        // c of row r at c ^ (r % 8): the raw reads spread over the banks)
#pragma unroll
        for (int i = 0; i < EK / 32; ++i) {
          const int idx = t + 128 * i, kr = idx >> 2, j = idx & 3;
          const uint4 v = *reinterpret_cast<const uint4*>(
              stg + kr * 128 + (((half * 4 + j) ^ (kr & 7)) << 4));
          uint4 lo, hi;
          int8x16_to_bf16(v, lo, hi);
          uint8_t* row = cb + kr * 128;
          *reinterpret_cast<uint4*>(row + (((2 * j) ^ (kr & 7)) << 4)) = lo;
          *reinterpret_cast<uint4*>(row + (((2 * j + 1) ^ (kr & 7)) << 4)) =
              hi;
        }
        sm90::fence_proxy_async();
        sm90::bar_sync(1 + g, 128);    // the group's copy is whole
        wt = cb;
      }
      // A: the weight tile, MN-major, 16 contraction rows = +2048 bytes; B:
      // the X tiles, K-major, 16 columns = +32 bytes, the next 64 columns
      // the next tile (+N x 128 bytes)
      const uint64_t da = sm90::desc_sw128(wt, EK * 128, 1024);
      const uint64_t db = sm90::desc_sw128(stg + EngW<W>::WBYTES, 16, 1024);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < EK / 16; ++kk)
        sm90::wgmma_tn<N>(d, da + ((kk * 2048) >> 4),
                          db + (((kk / 4) * N * 128 + (kk % 4) * 32) >> 4),
                          any || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(d);
      // int8: a warp's wgmma_wait covers only its own 16 rows of the A
      // tile, but the next conversion rewrites all of the group's copy, so
      // the group meets once every warp's share is read (a barrier rather
      // than a second copy: the ring keeps the shared memory)
      if (I8) sm90::bar_sync(1 + g, 128);
      sm90::mbar_arrive(&empty[s]);   // the stage (its X tile too) is read
      any = true;
    }
    if (!any) {   // int8: a unit may leave one group pair no stage
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
    }
    // d[4c + 2i + j]: column n0 + 64 half + 16 wl + lane/4 + 8i, row 8c +
    // 2 (lane % 4) + j; int8: split ksi's chunks in even and odd stages are
    // partial sets 2 ksi and 2 ksi + 1
    float* o = (z ? ws1 : ws0) + (long)(I8 ? 2 * ksi + par : ksi) * rows * out;
    const int col = n0 + half * 64 + wl * 16 + (lane >> 2);
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 8 * c + 2 * (lane & 3) + j, m = col + 8 * i;
          if (n < rows && m < out) o[(long)n * out + m] = d[4 * c + 2 * i + j];
        }
  }
}

// The split of a product of `rows` rows over nz weights: of the split
// counts that leave no split empty, the one whose busiest SM streams the
// least weight (whole waves of units over the SMs, each unit kper rows of
// 128 bf16 columns) plus its share of the partials' traffic (written once,
// read once by the epilogue); the fewer splits on a tie.
EPlan eplan(int rows, int in, int out, int nz) {
  const int nct = (out + ECOLS - 1) / ECOLS;
  const int chunks = (in + EKP - 1) / EKP;
  const int sms = num_sms();
  EPlan best{1, chunks * EKP, nct, nz * nct, in};
  double bcost = 1e300;
  for (int ks = 1; ks <= chunks && ks <= 256; ++ks) {
    const int kc = (chunks + ks - 1) / ks;
    if ((chunks + kc - 1) / kc != ks) continue;   // a split would be empty
    const long units = (long)nz * nct * ks;
    const long waves = (units + sms - 1) / sms;
    const double cost = (double)waves * kc * EKP * ECOLS * 2 +
                        (double)ks * nz * rows * out * 8 / sms;
    if (cost < bcost) {
      bcost = cost;
      best = EPlan{ks, kc * EKP, nct, (int)units, in};
    }
  }
  return best;
}

// Launch k on st as the programmatic dependent of the kernel before it: k
// may start once every block of that kernel has run
// griddep_launch_dependents (or exited), and reads what it writes only
// after griddep_wait.
template <class... P, class... A>
cudaError_t launch_dependent(void (*k)(P...), dim3 grid, int threads,
                             int smem, cudaStream_t st, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k, args...);
}

template <int N, class W>
cudaError_t elaunch(const CUtensorMap& w0, const CUtensorMap& w1,
                    const CUtensorMap& x, const EPlan& p, int layer,
                    float* ws0, float* ws1, int rows, int out,
                    cudaStream_t st) {
  constexpr int smem = ELayout<N, W>::SMEM;
  static bool opted_in = false;  // above 48 KB needs the opt-in, once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        engine_kernel<N, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  // the programmatic dependent of the kernel before (its rows' writer):
  // see the producer
  cudaError_t e = launch_dependent(
      engine_kernel<N, W>, dim3(p.units < num_sms() ? p.units : num_sms()),
      ethreads<W>(), smem, st, w0, w1, x, ws0, ws1, p, layer, rows, out);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// One product's partials: W-typed weight maps w0 (and w1, SwiGLU's up,
// when the plan has nz = 2), the rows' map x (box rows = erows(rows)).
template <class W>
cudaError_t eproduct(const CUtensorMap& w0, const CUtensorMap& w1,
                     const CUtensorMap& x, const EPlan& p, int layer,
                     float* ws0, float* ws1, int rows, int out,
                     cudaStream_t st) {
  switch (erows(rows)) {
    case 8: return elaunch<8, W>(w0, w1, x, p, layer, ws0, ws1, rows, out, st);
    case 16: return elaunch<16, W>(w0, w1, x, p, layer, ws0, ws1, rows, out, st);
    case 32: return elaunch<32, W>(w0, w1, x, p, layer, ws0, ws1, rows, out, st);
    case 64: return elaunch<64, W>(w0, w1, x, p, layer, ws0, ws1, rows, out, st);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one engine block, by N and weight type.
int engine_smem(int n, bool int8) {
  switch (n) {
    case 8: return int8 ? ELayout<8, int8_t>::SMEM : ELayout<8, bf16>::SMEM;
    case 16: return int8 ? ELayout<16, int8_t>::SMEM : ELayout<16, bf16>::SMEM;
    case 32: return int8 ? ELayout<32, int8_t>::SMEM : ELayout<32, bf16>::SMEM;
    case 64: return int8 ? ELayout<64, int8_t>::SMEM : ELayout<64, bf16>::SMEM;
  }
  return -1;
}

// The tensor maps of one C call: the five weight stacks (null stacks get
// none) and the three bf16 row buffers the products read (xn, attn, act).
struct EMaps {
  CUtensorMap wqkv, wo, wg, wu, wd, xn, attn, act;
};


// x (bf16) -> y (fp32), one thread per value; the first nz threads also
// zero the split attention's counters (FUSE) for the step's first layer.
__global__ void bf16_to_f32_kernel(const bf16* __restrict__ x,
                                   float* __restrict__ y, int n,
                                   int* __restrict__ zero, int nz) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nz) zero[i] = 0;
  if (i < n) y[i] = __bfloat162float(x[i]);
}

// One skinny GEMM on the engine: partials of the rows behind map x against
// the layer's weight w0 (and w1, SwiGLU's up) -> MODE's epilogue. W is the
// weight type (bf16, or int8 with the per-out-channel scale rows sc0 /
// sc1).
template <int MODE, class W = bf16>
cudaError_t gemm(const CUtensorMap& w0, const CUtensorMap& w1,
                 const CUtensorMap& x, int l, float* yf, bf16* yb,
                 float* ws0, float* ws1, int b, int in, int out,
                 cudaStream_t st, const float* sc0 = nullptr,
                 const float* sc1 = nullptr) {
  const EPlan p = eplan(b, in, out, MODE == MODE_SWIGLU ? 2 : 1);
  cudaError_t e = eproduct<W>(w0, w1, x, p, l, ws0, ws1, b, out, st);
  if (e != cudaSuccess) return e;
  const int n = b * out;
  gemm_epilogue_kernel<MODE, EngW<W>::I8>
      <<<(n + 255) / 256, 256, 0, st>>>(ws0, ws1, p.ks * EngW<W>::PSETS, n,
                                        yf, yb, sc0, sc1, out);
  return cudaGetLastError();
}

// Floats of the partials of a product of b rows (nz weights' worth), psets
// partial sets a split.
long eparts(int b, int in, int out, int nz = 1, int psets = 1) {
  return (long)eplan(b, in, out, nz).ks * psets * b * out;
}

// Floats of the normalised bf16 rows (b, h) at the head of K2/K5's llama
// workspace, kept 256-byte aligned (the rows' TMA map and the partials).
long xn_floats(int b, int h) {
  return (((long)b * h + 1) / 2 + 63) & ~63L;
}

// Floats of workspace one llama step needs: the normalised rows, the
// partial sums of the widest product, then the up-projection's partials
// (room for the int8 path's two partial sets a split).
long ws_layout(int b, int h, int dq, int dqkv, int ffn, long* n0) {
  constexpr int ps = EngW<int8_t>::PSETS;
  const long up = eparts(b, h, ffn, 2, ps);
  long a = eparts(b, h, dqkv, 1, ps);
  a = a > eparts(b, dq, h, 1, ps) ? a : eparts(b, dq, h, 1, ps);
  a = a > up ? a : up;
  a = a > eparts(b, ffn, h, 1, ps) ? a : eparts(b, ffn, h, 1, ps);
  *n0 = a;
  return xn_floats(b, h) + a + up;
}

// The operands of one decode step through the stack, shared by K2 and K5.
// xn (b, h) holds the normalised bf16 rows the qkv and gate/up products
// read (RMSNorm for llama, LayerNorm for gpt). The gpt mode's operands
// follow, null for llama: the LayerNorm biases and the four product biases
// (wg is fc_in and wd fc_out; wu is unused).
// The int8-weight mode reads the five weight pointers as int8 and takes the
// scale rows sqkv (L, dqkv), so, sg, su, sd (null for bf16 weights).
// count: the decode attention's ncount counters, zeroed by the step's first
// kernel (null for K7).
struct Stack {
  const bf16 *x_in, *ln1, *wqkv, *wo, *ln2, *wg, *wu, *wd;
  bf16* x_out;
  float *xf, *qkv, *ws;
  bf16 *attn, *act;
  int L, b, h, nh, nkv, hd, ffn;
  float eps;
  bool gpt = false;
  const bf16 *ln1_b = nullptr, *bqkv = nullptr, *bo = nullptr,
             *ln2_b = nullptr, *bg = nullptr, *bd = nullptr;
  bf16* xn = nullptr;
  const float *sqkv = nullptr, *so = nullptr, *sg = nullptr, *su = nullptr,
              *sd = nullptr;
  int* count = nullptr;
  int ncount = 0;
};

// The maps of a's weight stacks (int8: int8 stacks) and row buffers.
int emaps(EMaps* m, const Stack& a, bool int8) {
  const int dq = a.nh * a.hd, dqkv = dq + 2 * a.nkv * a.hd;
  const int n = erows(a.b);
  if (n == 0) return (int)cudaErrorInvalidValue;
  int e = 0;
  auto w = [&](CUtensorMap* mp, const bf16* base, int in, int out) {
    if (e == 0 && base != nullptr)
      e = sm90_map_wstack(mp, base, a.L, in, out, int8, int8 ? ECOLS : 64,
                          int8 ? EngW<int8_t>::EK : EngW<bf16>::EK);
  };
  auto x = [&](CUtensorMap* mp, const bf16* base, int cols) {
    if (e == 0 && base != nullptr) e = sm90_map_rows(mp, base, a.b, cols, n);
  };
  w(&m->wqkv, a.wqkv, a.h, dqkv);
  w(&m->wo, a.wo, dq, a.h);
  w(&m->wg, a.wg, a.h, a.ffn);
  w(&m->wu, a.wu, a.h, a.ffn);
  w(&m->wd, a.wd, a.ffn, a.h);
  x(&m->xn, a.xn, a.h);
  x(&m->attn, a.attn, dq);
  x(&m->act, a.act, a.ffn);
  return e;
}

// Layer l's row of a scale-row stack (null stays null).
const float* srow(const float* rows, int l, int per) {
  return rows ? rows + (long)l * per : nullptr;
}

// ---------------------------------------------------------------------------
// The split-KV attention: K2's, K5's and K6's decode attention and K7's
// verify attention, one kernel over three key layouts, on tensor cores.
//
// Replaces the attention of paddle_tpu/ops/fused_decode.py::
// _fused_decode_pallas (pallas_call at :940; its bf16 and int8 caches),
// _fused_decode_moe_pallas (:1464), _fused_paged_decode_pallas (:2267) and
// _fused_paged_verify_pallas (:3055). Row bi brings K1 tokens at positions
// pos .. pos+K1-1 (a decode row: K1 = 1); its K1*rep queries per kv head g
// (query q is token q/rep, head g*rep + q%rep) attend over the row's keys
// [0, tmax], tmax = min(pos + K1 - 1, the cache's last key), query q
// limited to keys <= min(pos + q/rep, the cache's last key), so a verify
// token sees the tail tokens before it and not those after. The keys come
// from one of three layouts (the policies below): the paged pool through
// the rows' block tables (K5, K7), the contiguous (L, cb, S, 2*nkv*hd)
// cache (K2, K6), and its int8 form with per-(layer, kv head) lane scales
// (K2's int8 KV modes; the k scale folds into q, the v scale multiplies
// the output once).
//
// What bounds it on the H100: bytes, each row's filled KV read once (0.66
// ms of K2's bound at Llama-2-7B, b = 4, pos 1056; 0.88 ms of K5's and
// K7's at b = 8 rows over ~700 cached tokens). The kernel this replaced
// walked a row's whole prefix in one block per (kv head, row), one key row
// a warp at a time on the CUDA cores (an FMA chain, a 5-step shuffle sum
// and an exp per key), four keys in flight a warp: at b = 4 its 128 blocks
// on 132 SMs each walked 1,057 keys alone, the longest row of a mixed
// batch set the pace, and few bytes were in flight per SM (K5's attention
// 2.8x its bound, K7's old one 5.3x). Here:
//  * The products run on tensor cores: mma.sync m16n8k16 with 16 queries
//    as M, in FlashAttention-2's register layout (S = Q Kᵀ from ldmatrix'd
//    K; P reused from the S accumulator as the A operand of O += P V, V
//    through ldmatrix.trans). q and P are each split into bf16 terms: K7
//    a pair (hi + lo, about 16 significant bits), the decode steps three
//    (hi + mid + lo, fp32's 24 bits), so the scores and the weighted sum
//    are the fp32 products summed in fp32 and the bf16 output rounds where
//    the fp32 plain version's does (with a pair, the ~2^-18 relative error
//    of each term moved about one attention output in a thousand across a
//    bf16 rounding boundary, and at Mixtral-8x7B width with a decisive
//    router that moved x_out past the check's tolerance on some draws). A
//    decode item has at most 8 queries (one in an MHA model): they are the
//    N of its products, Sᵀ = K Qᵀ with 16 keys as M and Oᵀ += Vᵀ Pᵀ with
//    16 head dims as M (Pᵀ from Sᵀ's accumulator by movmatrix.trans), so
//    the three terms cost no more tensor work than K7's pair over 16
//    padded queries.
//  * The KV length is split into VA_CHUNK-key chunks, so a row's prefix
//    spreads over many SMs. The work list of (row, chunk, kv head, 16
//    queries) items comes from the positions on the device (no host sync):
//    persistent blocks, as many as fit on the SMs, take items round-robin,
//    every row's full chunks first and the shorter last chunks after; an
//    item's result depends on its inputs only, so the bits do not depend on
//    which block takes it, and the chunks are merged in a fixed order with
//    no atomics in the sums. 512-key chunks measured faster than 128, 256,
//    384 and 1024 (fewer item starts against enough items to fill the SMs).
//  * Keys stream through a VA_ST-stage ring of 64-key stages, 16 keys a
//    warp, loaded by one thread with TMA onto the stage's mbarrier: the
//    paged pool in boxes of gcd(BT, 64) key rows (a box never crosses a
//    pool block, each box's block id from the table), the contiguous cache
//    in 64-row boxes of one (layer, row) slab of a 3-d map (rows past S read
//    as zeros); bf16 boxes 128-byte swizzled, int8 boxes a head wide and
//    unswizzled. 16-byte cp.async pieces from every thread, the paged
//    fallback for block sizes that are not a multiple of 8, held the kernel
//    far below the bytes' rate even with no compute (the SM's outstanding
//    small requests cap the bytes in flight).
//  * Int8 keys and values: all four warps widen a landed stage to bf16 in
//    shared memory (|v| <= 127 is exact in bf16's 8-bit significand) before
//    the products read it; the k scale is folded into q before its hi/lo
//    split.
//  * Online softmax in fp32 in the log2 domain (q pre-scaled by scale *
//    log2 e, ex2.approx as K1); the causal limits are applied on the edge
//    tiles only; the four warps' (m, l, O) meet through shared memory in
//    warp order.
//  * A decode step (K2, K5, K6; policies with FUSE) is one launch a layer:
//    the item holding a row's last key for head g first writes that head's
//    append (rope'd k and v at pos, rounded to the cache's type) and makes
//    it visible to the TMA (fence.proxy.async.global, then the block's
//    barrier) before its loads; a row of one chunk writes its output
//    directly, and otherwise every item writes its chunk's (m, l, O) and
//    bumps the (row, head)'s counter, and the block that brings it to the
//    item count merges the chunks in chunk order (through L2) and resets it
//    for the next layer. K7 (VerifyKV) keeps three launches: its K1 appends
//    may fall in two chunks, so a separate kernel writes them first and a
//    merge kernel runs after; each is the programmatic dependent of the
//    kernel before it.
// ---------------------------------------------------------------------------

constexpr int VA_T = 128;        // threads of an attention block (4 warps)
constexpr int VA_KT = 64;        // keys a ring stage (16 a warp)
constexpr int VA_ST = 3;         // ring stages
constexpr int VA_CHUNK = 512;    // keys a work item (a multiple of VA_KT)
constexpr int VA_MAXB = 64;      // rows of one launch
constexpr float LOG2E = 1.4426950408889634f;

// The append's store: bf16, or int8 as rint(v / scale) clipped to +-127
// (rint rounds half to even, as the reference's round; IEEE division).
__device__ __forceinline__ void put_kv(bf16* p, float v, float) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void put_kv(int8_t* p, float v, float s) {
  *p = (int8_t)fminf(fmaxf(rintf(v / s), -127.f), 127.f);
}

// What the key layouts share: the map the keys load through, the rope rows
// (null in the gpt mode), the chunk partials and the fused decode's
// counters.
struct SplitKV {
  CUtensorMap map;
  const float* cos;
  const float* sin;
  float* part;            // (b, nkv, nch, K1*rep) x O[HD], then x (m, l)
  int* count;             // FUSE: (b, nkv) items done, 0 between launches
  int b, K1, dkv2, nch;   // rows, tokens a row, cache row width, chunks
};

// The paged pool (K5; T = int8_t: the int8 pool): the map covers the whole
// pool (L*NB*BT rows, dkv2 columns) in boxes of `box` rows (box > 0) by 64
// columns (bf16, 128-byte swizzle) or a head (int8, unswizzled); row bi's
// key t is pool[tables[bi, t/BT], t%BT]; (b, K1, HD) rope rows. The int8
// pool's scales are per row (a serving slot's own calibration): row bi's
// lane scales of the layer at scales + bi*dkv2.
template <class T_>
struct PagedKV : SplitKV {
  using T = T_;
  static constexpr bool FUSE = true;
  static constexpr bool CONTIG = false;
  T* kv;                  // the layer's slab (NB, BT, dkv2)
  const float* scales;    // int8: the layer's (b, dkv2) lane scales, else null
  const int* tables;      // (b, MB)
  const int* positions;   // (b,)
  int MB, BT;
  int box;                // gcd(BT, 64) when BT % 8 == 0 (TMA), else 0
  int lrow0;              // the layer's first row in the pool
  __device__ int position(int bi) const { return positions[bi]; }
  __device__ int key_cap() const { return MB * BT - 1; }
  __device__ const float* rope_row(const float* r, int m, int hd) const {
    return r + (long)m * hd;
  }
  __device__ float lane_scale(int bi, int lane) const {
    return sizeof(T) == 1 ? scales[(long)bi * dkv2 + lane] : 1.f;
  }
  // an append past the table (block index >= MB) goes to scratch block 0;
  // the table is never read at MB or beyond
  __device__ T* append_row(int bi, int t) const {
    const int cb = t / BT;
    const int bid = cb < MB ? tables[(long)bi * MB + cb] : 0;
    return kv + ((long)bid * BT + t % BT) * dkv2;
  }
  // the pool row of key t of a row whose table row is tab
  __device__ long key_row(const int* tab, int t) const {
    return (long)__ldg(tab + t / BT) * BT + t % BT;
  }
  // K5 writes no append that lands in scratch block 0 (an idle row's):
  // the idle row's chunk items all read block 0, and its own append there
  // would race with them
  __device__ bool keeps_append(int bi, int t) const {
    const int cb = t / BT;
    return cb < MB && tables[(long)bi * MB + cb] != 0;
  }
};

// K7's view of the pool: K1-token tails, appends and merge in kernels of
// their own.
template <class T_>
struct VerifyKV : PagedKV<T_> {
  static constexpr bool FUSE = false;
};

// The contiguous cache (K2, K6; T = int8_t: K2's int8 KV mode): the map
// covers the launch's rows of the cache as ((L-1)*cb + b) slabs of S rows
// (sm90_map_kv over the group's first row: slab l*cb + bi is layer l, row
// bi); one position and one (HD) rope row for every row.
template <class T_>
struct ContigKV : SplitKV {
  using T = T_;
  static constexpr bool FUSE = true;
  static constexpr bool CONTIG = true;
  T* kv;                  // the layer's rows (b, S, dkv2), row stride S*dkv2
  const float* scales;    // int8: the layer's lane scales (2*dkv), else null
  int S, pos, z0;         // cache length, the rows' position, slab of row 0
  __device__ int position(int) const { return pos; }
  __device__ int key_cap() const { return S - 1; }
  __device__ const float* rope_row(const float* r, int, int) const {
    return r;
  }
  __device__ float lane_scale(int, int lane) const {
    return sizeof(T) == 1 ? scales[lane] : 1.f;
  }
  __device__ T* append_row(int bi, int t) const {
    return kv + ((long)bi * S + t) * dkv2;
  }
  __device__ bool keeps_append(int, int) const { return true; }
};

// Shared memory of one attention block, by head_dim, cache type and the
// bf16 terms NT of a query (byte offsets after the 1024-byte alignment):
// the ring of VA_ST slots (a stage's K then V, as loaded), int8's bf16 copy
// of the stage being read, the queries' NT terms, the rows' first work
// items (two lists), the ring's barriers, the merge flag. After an item's
// walk the ring holds the four warps' (O, m, l).
template <int HD, class T, int NT>
struct VaLayout {
  static constexpr int TILE = VA_KT * HD;                  // K (or V) values
  static constexpr int SLOT = 2 * TILE * (int)sizeof(T);
  static constexpr int CVT = sizeof(T) == 1 ? 2 * TILE * 2 : 0;
  static constexpr int Q = VA_ST * SLOT + CVT;
  static constexpr int LISTS = Q + NT * 16 * HD * 2;
  static constexpr int BARS = LISTS + 2 * (VA_MAXB + 8) * 4;
  static constexpr int FLAG = BARS + VA_ST * 8;
  static constexpr int SMEM = 1024 + FLAG + 16;
  static_assert(Q >= (4 * 16 * HD + 2 * 4 * 16) * 4, "(O, m, l) fit the ring");
};

// The bf16 terms of a query and of P: three for the decode policies
// (FUSE), two for K7's (see the kernel).
template <class KV>
__host__ __device__ constexpr int va_terms() {
  return KV::FUSE ? 3 : 2;
}

// Dynamic shared memory of one attention block at head_dim hd (64 or 128):
// the decode steps' over a bf16 or an int8 cache (verify false), K7's
// (verify true); -1 otherwise.
int split_smem(int hd, bool int8, bool verify) {
  if (hd != 64 && hd != 128) return -1;
  if (verify) {
    if (hd == 64) return int8 ? VaLayout<64, int8_t, 2>::SMEM
                              : VaLayout<64, bf16, 2>::SMEM;
    return int8 ? VaLayout<128, int8_t, 2>::SMEM : VaLayout<128, bf16, 2>::SMEM;
  }
  if (hd == 64) return int8 ? VaLayout<64, int8_t, 3>::SMEM
                            : VaLayout<64, bf16, 3>::SMEM;
  return int8 ? VaLayout<128, int8_t, 3>::SMEM : VaLayout<128, bf16, 3>::SMEM;
}

// The K1 appends of row bi, kv head g (K7): rope k with each token's own
// rope row (ROPE; the gpt mode takes k as it is), round k and v to the
// pool's type (int8: with the row's own lane scales), write them through
// the table. Several idle rows (tables all scratch) may write one scratch
// address: only their thrown-away outputs can read it. Launched behind the
// qkv epilogue (it reads qkv after griddep_wait).
template <int HD, bool ROPE, class T>
__global__ void verify_append_kernel(const float* __restrict__ qkv,
                                     const VerifyKV<T> kv, int nkv, int rep) {
  sm90::griddep_launch_dependents();   // the attention may launch
  sm90::griddep_wait();
  const int g = blockIdx.x, bi = blockIdx.y, K1 = kv.K1;
  const int dkv = nkv * HD, dq = dkv * rep, dqkv = dq + 2 * dkv;
  const int pos = kv.positions[bi];
  for (int i = threadIdx.x; i < K1 * HD; i += blockDim.x) {
    const int j = i / HD, d = i % HD, m = bi * K1 + j;
    const float* kh = qkv + (long)m * dqkv + dq + g * HD;
    T* dst = kv.append_row(bi, pos + j) + g * HD + d;
    float kval = kh[d];
    if (ROPE) {
      const float* cr = kv.cos + (long)m * HD;
      const float* sr = kv.sin + (long)m * HD;
      const float rot = d < HD / 2 ? -kh[d + HD / 2] : kh[d - HD / 2];
      kval = kh[d] * cr[d] + rot * sr[d];
    }
    put_kv(dst, kval, kv.lane_scale(bi, g * HD + d));
    put_kv(dst + dkv, kh[dkv + d], kv.lane_scale(bi, dkv + g * HD + d));
  }
}

// two floats -> a hi bf16x2 and the lo bf16x2 of what hi leaves
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = sm90::pack_f2(x - hf.x, y - hf.y);
}

// two floats -> three bf16x2 terms hi + mid + lo that sum to them exactly
// (fp32's 24 significant bits, 8 a term; each difference is exact in fp32)
__device__ __forceinline__ void split3(float x, float y, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 md = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(md);
  hi = *reinterpret_cast<const unsigned*>(&h);
  mid = *reinterpret_cast<const unsigned*>(&md);
  lo = sm90::pack_f2(rx - mf.x, ry - mf.y);
}

// Element row r, 16-byte chunk ch of an R-row, HD-wide bf16 tile (a
// stage's K or V, R = VA_KT; the queries, R = 16): HD/64 sub-tiles of 64
// columns (a TMA box's 128-byte rows), one after the other, 16-byte chunks
// XOR-swizzled by r % 8 as TMA's 128-byte swizzle leaves them (the 8 rows
// one ldmatrix reads fall in distinct banks).
template <int R>
__device__ __forceinline__ bf16* va_at(bf16* tile, int r, int ch) {
  return tile + (ch >> 3) * (R * 64) + r * 64 + (((ch & 7) ^ (r & 7)) << 3);
}

// The queries of (row bi, kv head g) — warp w of nw takes queries w, w +
// nw, ... — each combine the partials of the row's nc chunks in chunk
// order and write attn (rows bi*K1 + token, dq) in bf16, times vs where VS
// (the int8 cache's v scale). Lane i holds chunks i, i + 32, ...: the max
// and the weighted l sum over lanes (a fixed xor tree), then each chunk's
// weight is broadcast from its lane while every lane sums HD/32 of O. L2:
// the partials were written by other blocks of this launch and are read
// through L2 (ld.global.cg), never from a stale L1 line.
template <int HD, bool L2, bool VS>
__device__ __forceinline__ void merge_chunks(
    const float* __restrict__ part, long otot, long p0, int nc, int NQ,
    int K1, int rep, int dq, int g, int bi, float vs,
    bf16* __restrict__ attn, int warp, int nw, int lane) {
  auto ld = [](const float* p) {
    if constexpr (L2) return __ldcg(p);
    else return *p;
  };
  const float* ml = part + otot;
  for (int q = warp; q < NQ; q += nw) {
    float M = NEG_INF;
    for (int c = lane; c < nc; c += 32)
      M = fmaxf(M, ld(ml + (p0 + (long)c * NQ + q) * 2));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffff, M, o));
    float A[HD / 32], Ls = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) A[j] = 0.f;
    for (int c0 = 0; c0 < nc; c0 += 32) {
      float e = 0.f;
      if (c0 + lane < nc) {
        const long pi = p0 + (long)(c0 + lane) * NQ + q;
        e = sm90::ex2(ld(ml + pi * 2) - M);
        Ls += ld(ml + pi * 2 + 1) * e;
      }
      const int n = min(32, nc - c0);
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float w = __shfl_sync(0xffffffff, e, i);
        const float* op = part + (p0 + (long)(c0 + i) * NQ + q) * HD;
#pragma unroll
        for (int j = 0; j < HD / 32; ++j) A[j] += ld(op + lane + 32 * j) * w;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      Ls += __shfl_xor_sync(0xffffffff, Ls, o);
    bf16* out = attn + (long)(bi * K1 + q / rep) * dq +
                (g * rep + q % rep) * HD;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) {
      float o = A[j] / Ls;
      if (VS) o *= vs;
      out[lane + 32 * j] = __float2bfloat16(o);
    }
  }
}

// The attention of the work items (see the section's note). Items come in
// two lists: first every row's chunks but its last (each VA_CHUNK keys),
// then every row's last chunk (at most VA_CHUNK keys), so the blocks start
// on the full chunks and the short ones fill the tail.
template <int HD, bool ROPE, class KV>
__global__ void __launch_bounds__(VA_T)
split_attn_kernel(const float* __restrict__ qkv,
                  const __grid_constant__ KV kv, bf16* __restrict__ attn,
                  int nkv, int rep, float qscale) {
  using T = typename KV::T;
  // DEC, the decode policies: at most 8 queries an item (rep <= 8), the N
  // of the products (see the DEC branch below); q and P are each NT = 3
  // bf16 terms (fp32's 24 bits), so the scores and the weighted sum are
  // fp32 products summed in fp32 and the bf16 output rounds as the fp32
  // plain version's does. K7 (NT = 2: hi + lo, about 16 bits; its queries
  // as M) keeps its bits.
  constexpr bool DEC = KV::FUSE;
  constexpr int NT = va_terms<KV>();
  using Ly = VaLayout<HD, T, NT>;
  constexpr bool Q8 = sizeof(T) == 1;
  constexpr int CPR = HD / 8;   // 16-byte chunks of a bf16 key row
  constexpr int KS = HD / 16;   // k16 steps over the head
  constexpr int TILE = Ly::TILE;
  extern __shared__ uint8_t vsm_raw[];
  uint8_t* vsm = sm90::align1024(vsm_raw);
  bf16* cvt = reinterpret_cast<bf16*>(vsm + VA_ST * Ly::SLOT);  // int8
  bf16* qt = reinterpret_cast<bf16*>(vsm + Ly::Q);          // [NT][16][HD]
  int* full = reinterpret_cast<int*>(vsm + Ly::LISTS);         // [b + 1]
  int* last = full + VA_MAXB + 8;                              // [b + 1]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vsm + Ly::BARS);
  int* flag = reinterpret_cast<int*>(vsm + Ly::FLAG);
  bool tma = true;
  if constexpr (!KV::CONTIG) tma = kv.box > 0;
  // after an item's walk the ring holds the four warps' (O, m, l)
  float* ro = reinterpret_cast<float*>(vsm);       // [4][16][HD]
  float* rm = ro + 4 * 16 * HD;                    // [4][16]
  float* rl = rm + 4 * 16;                         // [4][16]
  sm90::griddep_launch_dependents();   // the merge or the o-proj may launch
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane >> 2, lc = lane & 3;
  const int dkv = nkv * HD, dq = dkv * rep, dqkv = dq + 2 * dkv;
  const int NQ = kv.K1 * rep, QG = (NQ + 15) / 16, per = nkv * QG;
  const int tcap = kv.key_cap();
  const long otot = (long)kv.b * nkv * kv.nch * NQ * HD;
  auto last_key = [&](int bi) {
    return min(kv.position(bi) + kv.K1 - 1, tcap);
  };
  // row bi's full-chunk items start at full[bi], its last chunk's at
  // last[bi] (after all the full ones); the positions are uploaded before
  // the step, so this overlaps the kernel before
  if (tid < kv.b) {
    full[tid + 1] = (last_key(tid) / VA_CHUNK) * per;
    last[tid + 1] = per;
  }
  __syncthreads();
  if (tid == 0) {
    full[0] = 0;
    for (int i = 1; i <= kv.b; ++i) full[i] += full[i - 1];
    last[0] = full[kv.b];
    for (int i = 1; i <= kv.b; ++i) last[i] += last[i - 1];
    for (int st = 0; st < VA_ST; ++st) sm90::mbar_init(&bars[st], 1);
    sm90::mbar_init_fence();
    if (tma) sm90::tma_prefetch_map(&kv.map);
  }
  __syncthreads();
  const int items = last[kv.b];
  // ring stages issued and consumed so far over the block's items: stage
  // n sits in slot n % VA_ST (TMA: its barrier's phase n / VA_ST)
  int issued = 0, used = 0;
  // K7: qkv (its epilogue) and the tail keys (the appends kernel) are
  // complete before any load. FUSE: the keys below pos were written by
  // kernels that are complete when this launch starts (the qkv epilogue
  // before it is an ordinary launch), so a block's first loads may go out
  // before griddep_wait; qkv and the appends wait for it.
  bool waited = !KV::FUSE;
  if (waited) sm90::griddep_wait();
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const bool is_last = it >= full[kv.b];
    const int* first = is_last ? last : full;
    int bi = 0;
    while (first[bi + 1] <= it) ++bi;
    const int r0 = it - first[bi];
    const int z = r0 % QG, g = (r0 / QG) % nkv;
    const int pos = kv.position(bi), tmax = last_key(bi);
    const int c = is_last ? tmax / VA_CHUNK : r0 / per;
    const int k0 = c * VA_CHUNK, k1 = min(k0 + VA_CHUNK, tmax + 1);
    const int nst = (k1 - k0 + VA_KT - 1) / VA_KT;
    const int q0 = z * 16, nq = min(16, NQ - q0);
    const int lmin = min(pos + q0 / rep, tcap);   // the block's least limit
    const int* tab = nullptr;
    if constexpr (!KV::CONTIG) tab = kv.tables + (long)bi * kv.MB;

    // stage s of the item: keys k0 + 64 s ..., K and V of head g, into
    // slot `issued % VA_ST`. TMA: one thread loads the stage onto the
    // slot's barrier — the contiguous cache as one 64-row box of the row's
    // slab (two 64-column boxes a K or V at head_dim 128 in bf16); the pool
    // in boxes of kv.box rows (a box never crosses a pool block), 64
    // columns each, a box wholly past k1 loading k1 - 1's box again
    // (finite, and masked). Else (the pool, BT % 8 != 0) every thread
    // copies 16-byte pieces by cp.async, keys past k1 as zeros.
    auto load = [&](int s) {
      const int slot = issued % VA_ST;
      ++issued;
      T* ks = reinterpret_cast<T*>(vsm + slot * Ly::SLOT);
      T* vs = ks + TILE;
      if (tma) {
        if (tid != 0) return;
        sm90::mbar_arrive_tx(&bars[slot], Ly::SLOT);
        if constexpr (KV::CONTIG) {
          const int t = k0 + s * VA_KT, zs = kv.z0 + bi;
          if constexpr (Q8) {
            sm90::tma_load_3d(ks, &kv.map, &bars[slot], g * HD, t, zs);
            sm90::tma_load_3d(vs, &kv.map, &bars[slot], dkv + g * HD, t, zs);
          } else {
#pragma unroll
            for (int hh = 0; hh < HD / 64; ++hh) {
              sm90::tma_load_3d(ks + hh * VA_KT * 64, &kv.map, &bars[slot],
                                g * HD + hh * 64, t, zs);
              sm90::tma_load_3d(vs + hh * VA_KT * 64, &kv.map, &bars[slot],
                                dkv + g * HD + hh * 64, t, zs);
            }
          }
        } else {
          for (int r = 0; r < VA_KT; r += kv.box) {
            const int t = k0 + s * VA_KT + r;
            const int tb = t < k1 ? t : (k1 - 1) / kv.box * kv.box;
            const int row = kv.lrow0 + (int)kv.key_row(tab, tb);
            if constexpr (Q8) {   // a head-wide int8 box: rows of HD bytes
              sm90::tma_load_3d(ks + r * HD, &kv.map, &bars[slot], g * HD,
                                row, 0);
              sm90::tma_load_3d(vs + r * HD, &kv.map, &bars[slot],
                                dkv + g * HD, row, 0);
            } else {
#pragma unroll
              for (int hh = 0; hh < HD / 64; ++hh) {
                sm90::tma_load_2d(ks + hh * VA_KT * 64 + r * 64, &kv.map,
                                  &bars[slot], g * HD + hh * 64, row);
                sm90::tma_load_2d(vs + hh * VA_KT * 64 + r * 64, &kv.map,
                                  &bars[slot], dkv + g * HD + hh * 64, row);
              }
            }
          }
        }
        return;
      }
      if constexpr (!KV::CONTIG) {
        if constexpr (Q8) {   // int8 rows of HD bytes, as the TMA lands them
          constexpr int CR = HD / 16;
#pragma unroll
          for (int i = tid; i < VA_KT * CR; i += VA_T) {
            const int r = i / CR, ch = i % CR, t = k0 + s * VA_KT + r;
            const bool ok = t < k1;
            const T* src = kv.kv;
            if (ok) src += kv.key_row(tab, t) * kv.dkv2 + g * HD + ch * 16;
            cp_async16(ks + r * HD + ch * 16, src, ok);
            cp_async16(vs + r * HD + ch * 16, ok ? src + dkv : src, ok);
          }
        } else {
#pragma unroll
          for (int i = tid; i < VA_KT * CPR; i += VA_T) {
            const int r = i / CPR, ch = i % CPR, t = k0 + s * VA_KT + r;
            const bool ok = t < k1;
            const bf16* src = kv.kv;
            if (ok) src += kv.key_row(tab, t) * kv.dkv2 + g * HD + ch * 8;
            cp_async16(va_at<VA_KT>(ks, r, ch), src, ok);
            cp_async16(va_at<VA_KT>(vs, r, ch), ok ? src + dkv : src, ok);
          }
        }
        cp_async_commit();
      }
    };
    // FUSE: the item holding the row's last key for head g writes the
    // head's append at pos before any of its loads (no other item reads
    // key pos of head g). An idle paged row (its table all scratch) writes
    // none: its thrown-away output reads block 0 as it is, so two launches
    // agree bit for bit
    if (KV::FUSE && is_last && z == 0 && kv.keeps_append(bi, pos)) {
      if (!waited) {
        sm90::griddep_wait();
        waited = true;
      }
      const float* kh = qkv + (long)bi * dqkv + dq + g * HD;
      T* dst = kv.append_row(bi, pos) + g * HD;
      const float* cr = ROPE ? kv.rope_row(kv.cos, bi, HD) : nullptr;
      const float* sr = ROPE ? kv.rope_row(kv.sin, bi, HD) : nullptr;
      for (int d = tid; d < HD; d += VA_T) {
        float kval = kh[d];
        if (ROPE) {
          const float rot = d < HD / 2 ? -kh[d + HD / 2] : kh[d - HD / 2];
          kval = kh[d] * cr[d] + rot * sr[d];
        }
        put_kv(dst + d, kval, kv.lane_scale(bi, g * HD + d));
        put_kv(dst + dkv + d, kh[dkv + d],
               kv.lane_scale(bi, dkv + g * HD + d));
      }
      sm90::fence_proxy_async_global();   // ... before the TMA reads it
    }
    // every thread is done with the previous item's ro, and its generic
    // writes there are ordered before the loads that refill the ring
    sm90::fence_proxy_async();
    __syncthreads();
    for (int s = 0; s < VA_ST - 1; ++s) {
      if (s < nst) load(s);
      else if (!tma) cp_async_commit();
    }
    if (!waited) {
      sm90::griddep_wait();
      waited = true;
    }
    // the queries: rope'd, scaled into the log2 domain (and by the int8
    // cache's k scale), split into NT bf16 terms (rows past nq are zeros,
    // never written out). A thread takes one head dim of RPT rows and
    // issues all their loads before it uses any.
    {
      constexpr int RPT = 16 * HD / VA_T;
      const int d = tid % HD, r0 = tid / HD;
      const float qs = Q8 ? qscale * kv.lane_scale(bi, g * HD) : qscale;
      float qv[RPT], rv[RPT], cv[RPT], sv[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int qi = r0 + (VA_T / HD) * j, q = q0 + qi;
        qv[j] = rv[j] = cv[j] = sv[j] = 0.f;
        if (qi < nq) {
          const int m = bi * kv.K1 + q / rep;
          const float* qh = qkv + (long)m * dqkv + (g * rep + q % rep) * HD;
          qv[j] = qh[d];
          if (ROPE) {
            rv[j] = d < HD / 2 ? -qh[d + HD / 2] : qh[d - HD / 2];
            cv[j] = kv.rope_row(kv.cos, m, HD)[d];
            sv[j] = kv.rope_row(kv.sin, m, HD)[d];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int qi = r0 + (VA_T / HD) * j;
        const float v = (ROPE ? qv[j] * cv[j] + rv[j] * sv[j] : qv[j]) * qs;
        const bf16 hi = __float2bfloat16(v);
        const float r1 = v - __bfloat162float(hi);
        const bf16 mid = __float2bfloat16(r1);
        va_at<16>(qt, qi, d >> 3)[d & 7] = hi;
        va_at<16>(qt + 16 * HD, qi, d >> 3)[d & 7] = mid;
        if (NT == 3)
          va_at<16>(qt + 32 * HD, qi, d >> 3)[d & 7] =
              __float2bfloat16(r1 - __bfloat162float(mid));
      }
    }
    __syncthreads();   // the queries are staged
    // stage s: wait until it has landed for every thread (so s-1 is
    // consumed), issue the load VA_ST - 1 stages ahead, and (int8) widen it
    // into the bf16 copy; returns the stage's bf16 K tile (V follows it)
    auto stage = [&](int s) {
      const int slot = used % VA_ST;
      if (tma)
        sm90::mbar_wait(&bars[slot], (used / VA_ST) & 1);
      else
        cp_async_wait<VA_ST - 2>();
      ++used;
      __syncthreads();
      if (s + VA_ST - 1 < nst) load(s + VA_ST - 1);
      else if (!tma) cp_async_commit();
      bf16* ks = reinterpret_cast<bf16*>(vsm + slot * Ly::SLOT);
      if constexpr (Q8) {
        // the int8 stage (rows of HD bytes) widened into the bf16 copy, 16
        // values a thread at a time (the copy of stage s-1 is read: the
        // barrier above)
        const int8_t* raw = reinterpret_cast<const int8_t*>(ks);
#pragma unroll
        for (int i = tid; i < 2 * TILE / 16; i += VA_T) {
          const int kv2 = i / (TILE / 16), r = (i % (TILE / 16)) / (HD / 16),
                    j = i % (HD / 16);
          const uint4 v = *reinterpret_cast<const uint4*>(
              raw + kv2 * TILE + r * HD + 16 * j);
          uint4 lo, hi;
          int8x16_to_bf16(v, lo, hi);
          bf16* tile = cvt + kv2 * TILE;
          *reinterpret_cast<uint4*>(va_at<VA_KT>(tile, r, 2 * j)) = lo;
          *reinterpret_cast<uint4*>(va_at<VA_KT>(tile, r, 2 * j + 1)) = hi;
        }
        __syncthreads();            // the copy is whole
        ks = cvt;
      }
      return ks;
    };
    if constexpr (DEC) {
      // The decode items: at most 8 queries, the N of the products. Sᵀ (16
      // keys x 8 queries) = K Qᵀ with the warp's keys as mma's M, and Oᵀ
      // (16 head dims x 8 queries) += Vᵀ Pᵀ with the head dims as M, so no
      // product pads the queries to 16. Pᵀ comes from Sᵀ's accumulator by
      // movmatrix.trans. Each q and P value is NT = 3 bf16 terms.
      // qf[t][kk]: q term t, queries 0..7 (row lr), dims 16 kk + 2 lc (+8)
      unsigned qf[NT][KS][2];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int kk = 0; kk < KS; kk += 2) {
          unsigned r4[4];
          ldsm_x4(r4, va_at<16>(qt + t * 16 * HD, lane & 7,
                                2 * kk + (lane >> 3)));
          qf[t][kk][0] = r4[0];
          qf[t][kk][1] = r4[1];
          qf[t][kk + 1][0] = r4[2];
          qf[t][kk + 1][1] = r4[3];
        }
      // this thread's two query columns (2 lc, 2 lc + 1) and their limits
      int lim[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = 2 * lc + j;
        lim[j] = qi < nq ? min(pos + (q0 + qi) / rep, tcap) : 0x7fffffff;
      }
      // oT[mt][e]: head dim 16 mt + lr + 8 (e / 2), query 2 lc + e % 2
      float oT[HD / 16][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oT[mt][e] = 0.f;
      for (int s = 0; s < nst; ++s) {
        const bf16* ks = stage(s);
        const bf16* vs = ks + TILE;
        const int t0 = k0 + s * VA_KT + 16 * warp;   // this warp's first key
        if (t0 > tmax) continue;
        // Sᵀ, each q term into its own accumulator (short chains)
        float sa[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[t][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          unsigned ka[4];
          ldsm_x4(ka, va_at<VA_KT>(const_cast<bf16*>(ks),
                                   16 * warp + (lane & 7) +
                                       8 * ((lane >> 3) & 1),
                                   2 * kk + (lane >> 4)));
#pragma unroll
          for (int t = 0; t < NT; ++t)
            mma16816(sa[t], ka, qf[t][kk][0], qf[t][kk][1]);
        }
        // sc[e]: key t0 + lr + 8 (e / 2), query 2 lc + e % 2
        float sc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[e] = sa[0][e] + (sa[1][e] + sa[NT - 1][e]);
        if (t0 + 15 > lmin) {       // an edge tile: the causal limits
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (t0 + lr + 8 * (e >> 1) > lim[e & 1]) sc[e] = -INFINITY;
        }
        float al[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {   // query 2 lc + j: its 16 keys
          float mx = fmaxf(sc[j], sc[2 + j]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 16));
          const float mn = fmaxf(m[j], mx);
          al[j] = sm90::ex2(m[j] - mn);
          m[j] = mn;
          sc[j] = sm90::ex2(sc[j] - mn);
          sc[2 + j] = sm90::ex2(sc[2 + j] - mn);
          l[j] = l[j] * al[j] + (sc[j] + sc[2 + j]);
        }
#pragma unroll
        for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) oT[mt][e] *= al[e & 1];
        // Pᵀ as the B operand: P's bf16 terms for keys 0..7 and 8..15,
        // each 8 x 8 block transposed (query lr, keys 2 lc, 2 lc + 1)
        unsigned pb[NT][2];
        split3(sc[0], sc[1], pb[0][0], pb[1][0], pb[NT - 1][0]);
        split3(sc[2], sc[3], pb[0][1], pb[1][1], pb[NT - 1][1]);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          pb[t][0] = movmatrix_trans(pb[t][0]);
          pb[t][1] = movmatrix_trans(pb[t][1]);
        }
#pragma unroll
        for (int mt = 0; mt < HD / 16; ++mt) {
          unsigned va[4];   // Vᵀ: head dims 16 mt .. + 15 x the 16 keys
          ldsm_x4_trans(va, va_at<VA_KT>(const_cast<bf16*>(vs),
                                         16 * warp + (lane & 7) +
                                             8 * (lane >> 4),
                                         2 * mt + ((lane >> 3) & 1)));
#pragma unroll
          for (int t = 0; t < NT; ++t)
            mma16816(oT[mt], va, pb[t][0], pb[t][1]);
        }
      }
      if (!tma) cp_async_wait<0>();
      __syncthreads();   // every warp is done with the ring: it becomes ro
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l[j] += __shfl_xor_sync(0xffffffff, l[j], 4);
        l[j] += __shfl_xor_sync(0xffffffff, l[j], 8);
        l[j] += __shfl_xor_sync(0xffffffff, l[j], 16);
        const int row = warp * 16 + 2 * lc + j;
#pragma unroll
        for (int mt = 0; mt < HD / 16; ++mt) {
          ro[row * HD + 16 * mt + lr] = oT[mt][j];
          ro[row * HD + 16 * mt + lr + 8] = oT[mt][2 + j];
        }
        if (lr == 0) {
          rm[row] = m[j];
          rl[row] = l[j];
        }
      }
    } else {
      unsigned qf[NT][KS][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int r = (lane & 7) + 8 * ((lane >> 3) & 1);
          const int ch = 2 * kk + (lane >> 4);
          ldsm_x4(qf[t][kk], va_at<16>(qt + t * 16 * HD, r, ch));
        }
      // this thread's two query rows (lr, lr + 8) and their key limits
      int lim[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = lr + 8 * i;
        lim[i] = qi < nq ? min(pos + (q0 + qi) / rep, tcap) : 0x7fffffff;
      }
      float o[HD / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
      for (int s = 0; s < nst; ++s) {
        bf16* ks = stage(s);
        bf16* vs = ks + TILE;
        const int t0 = k0 + s * VA_KT + 16 * warp;   // this warp's first key
        if (t0 > tmax) continue;
        // S (16 queries x 16 keys) = (q_hi + q_lo) K^T, hi and lo into
        // separate accumulators (two short dependency chains, not one long)
        float sa[NT][2][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sa[t][j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          unsigned kb[4];
          ldsm_x4(kb, va_at<VA_KT>(ks,
                                   16 * warp + (lane & 7) + 8 * (lane >> 4),
                                   2 * kk + ((lane >> 3) & 1)));
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            mma16816(sa[t][0], qf[t][kk], kb[0], kb[1]);
            mma16816(sa[t][1], qf[t][kk], kb[2], kb[3]);
          }
        }
        float sc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = sa[0][j][e] + sa[1][j][e];
        // sc[j][e]: query lr + 8 (e / 2), key t0 + 8 j + 2 lc + e % 2
        if (t0 + 15 > lmin) {       // an edge tile: the causal limits
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (t0 + 8 * j + 2 * lc + (e & 1) > lim[e >> 1])
                sc[j][e] = -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = fmaxf(fmaxf(sc[0][2 * i], sc[0][2 * i + 1]),
                           fmaxf(sc[1][2 * i], sc[1][2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
          const float mn = fmaxf(m[i], mx);
          const float al = sm90::ex2(m[i] - mn);
          m[i] = mn;
          l[i] *= al;
#pragma unroll
          for (int n = 0; n < HD / 8; ++n) {
            o[n][2 * i] *= al;
            o[n][2 * i + 1] *= al;
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            sc[j][2 * i] = sm90::ex2(sc[j][2 * i] - mn);
            sc[j][2 * i + 1] = sm90::ex2(sc[j][2 * i + 1] - mn);
            l[i] += sc[j][2 * i] + sc[j][2 * i + 1];
          }
        }
        // P as the A operand (keys 0..15 of the warp's tile), hi and lo
        unsigned pf[NT][4];
        split2(sc[0][0], sc[0][1], pf[0][0], pf[1][0]);
        split2(sc[0][2], sc[0][3], pf[0][1], pf[1][1]);
        split2(sc[1][0], sc[1][1], pf[0][2], pf[1][2]);
        split2(sc[1][2], sc[1][3], pf[0][3], pf[1][3]);
#pragma unroll
        for (int n2 = 0; n2 < HD / 16; ++n2) {
          unsigned vb[4];
          ldsm_x4_trans(vb, va_at<VA_KT>(vs,
                                         16 * warp + (lane & 7) +
                                             8 * ((lane >> 3) & 1),
                                         2 * n2 + (lane >> 4)));
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            mma16816(o[2 * n2], pf[t], vb[0], vb[1]);
            mma16816(o[2 * n2 + 1], pf[t], vb[2], vb[3]);
          }
        }
      }
      if (!tma) cp_async_wait<0>();
      __syncthreads();   // every warp is done with the ring: it becomes ro
      // o[n][e]: query lr + 8 (e / 2), head dim 8 n + 2 lc + e % 2
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffff, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffff, l[i], 2);
        const int row = warp * 16 + lr + 8 * i;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<float2*>(ro + row * HD + 8 * n + 2 * lc) =
              make_float2(o[n][2 * i], o[n][2 * i + 1]);
        if (lc == 0) {
          rm[row] = m[i];
          rl[row] = l[i];
        }
      }
    }
    __syncthreads();
    // the item's partial: the four warps merged in warp order. FUSE, a row
    // of one chunk: its output, at once.
    const int nc = tmax / VA_CHUNK + 1;
    const bool direct = KV::FUSE && nc == 1;
    const float vsc = Q8 ? kv.lane_scale(bi, dkv + g * HD) : 1.f;
    const long pq = ((long)(bi * nkv + g) * kv.nch + c) * NQ + q0;
    for (int i = tid; i < nq * HD; i += VA_T) {
      const int qi = i / HD, d = i % HD;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < 4; ++w) M = fmaxf(M, rm[w * 16 + qi]);
      float A = 0.f, Ls = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float e = sm90::ex2(rm[w * 16 + qi] - M);
        A += ro[(w * 16 + qi) * HD + d] * e;
        Ls += rl[w * 16 + qi] * e;
      }
      if (direct) {
        const int q = q0 + qi;
        float ov = A / Ls;
        if (Q8) ov *= vsc;
        attn[(long)(bi * kv.K1 + q / rep) * dq + (g * rep + q % rep) * HD +
             d] = __float2bfloat16(ov);
        continue;
      }
      kv.part[(pq + qi) * HD + d] = A;
      if (d == 0) {
        kv.part[otot + (pq + qi) * 2] = M;
        kv.part[otot + (pq + qi) * 2 + 1] = Ls;
      }
    }
    if (KV::FUSE && !direct) {
      // the last of the (row, head)'s items to finish merges them: every
      // item's partial is in L2 before its count (the fence), and the
      // merging block reads them after seeing the full count
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        int* cnt = kv.count + bi * nkv + g;
        const bool lastb = atomicAdd(cnt, 1) == nc * QG - 1;
        if (lastb) {
          *cnt = 0;   // for the next layer's launch
          __threadfence();
        }
        *flag = lastb;
      }
      __syncthreads();
      if (*flag)
        merge_chunks<HD, true, Q8>(kv.part, otot,
                                   (long)(bi * nkv + g) * kv.nch * NQ, nc,
                                   NQ, kv.K1, rep, dq, g, bi, vsc, attn,
                                   warp, VA_T / 32, lane);
    }
    // (the next item's barrier frees the ring for its loads)
  }
}

// K7's merge, per (kv head g, row bi): merge_chunks over the row's chunks,
// four warps. Launched behind the attention (its partials are read after
// griddep_wait).
template <int HD, class T>
__global__ void __launch_bounds__(128)
split_merge_kernel(const VerifyKV<T> kv, bf16* __restrict__ attn, int nkv,
                   int rep) {
  sm90::griddep_launch_dependents();   // the o-proj's weights may load
  sm90::griddep_wait();
  const int g = blockIdx.x, bi = blockIdx.y;
  const int NQ = kv.K1 * rep;
  const int tmax = min(kv.positions[bi] + kv.K1 - 1, kv.key_cap());
  // the int8 pool: the row's v scale on the merged output, once
  merge_chunks<HD, false, sizeof(T) == 1>(
      kv.part, (long)kv.b * nkv * kv.nch * NQ * HD,
      (long)(bi * nkv + g) * kv.nch * NQ, tmax / VA_CHUNK + 1, NQ, kv.K1,
      rep, nkv * rep * HD, g, bi, kv.lane_scale(bi, nkv * HD + g * HD),
      attn, threadIdx.x >> 5, 4, threadIdx.x & 31);
}

// Floats of the attention's chunk partials: (O, m, l) per (row, kv head,
// chunk, query), chunks of a key span S (the cache's length, or the
// table's MB*BT).
long split_part_floats(int b, int K1, int nkv, int rep, int hd, int S) {
  const long nch = (S + VA_CHUNK - 1) / VA_CHUNK;
  return (long)b * nkv * nch * K1 * rep * (hd + 2);
}

// A decode step's workspace (K2, K5, K6): the products' `prod` floats,
// then (256-byte aligned) the attention's chunk partials for b rows over a
// key span S, then the (b, nkv) counters. Returns its floats; with ws,
// also where the partials and the counters sit.
long decode_ws(long prod, int b, int nkv, int rep, int hd, int S,
               float* ws = nullptr, float** part = nullptr,
               int** count = nullptr) {
  const long p0 = (prod + 63) & ~63L;
  const long pf = split_part_floats(b, 1, nkv, rep, hd, S);
  if (ws != nullptr) {
    *part = ws + p0;
    *count = reinterpret_cast<int*>(ws + p0 + pf);
  }
  return p0 + pf + (long)b * nkv;
}

// One layer's attention over kv: the split kernel, as the programmatic
// dependent of the qkv epilogue (FUSE: one launch); K7 also its appends
// before it and its merge after, each the programmatic dependent of the
// kernel before it.
template <int HD, bool ROPE, class KV>
cudaError_t split_attention(const Stack& a, const KV& kv, cudaStream_t st) {
  using T = typename KV::T;
  const int rep = a.nh / a.nkv;
  if (kv.b < 1 || kv.b > VA_MAXB ||
      (KV::FUSE && (kv.K1 != 1 || rep > 8)))   // DEC: at most 8 queries
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if constexpr (!KV::FUSE) {
    e = launch_dependent(verify_append_kernel<HD, ROPE, T>,
                         dim3(a.nkv, kv.b), 128, 0, st, (const float*)a.qkv,
                         kv, a.nkv, rep);
    if (e != cudaSuccess) return e;
  }
  const int smem = VaLayout<HD, T, va_terms<KV>()>::SMEM;
  static int per_sm = 0;   // blocks an SM holds; the opt-in above 48 KB, once
  if (per_sm == 0) {
    e = cudaFuncSetAttribute(split_attn_kernel<HD, ROPE, KV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, split_attn_kernel<HD, ROPE, KV>, VA_T, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) per_sm = 1;
  }
  const long items = (long)kv.b * kv.nch * a.nkv * ((kv.K1 * rep + 15) / 16);
  const long cap = (long)num_sms() * per_sm;
  e = launch_dependent(split_attn_kernel<HD, ROPE, KV>,
                       dim3((int)(items < cap ? items : cap)), VA_T, smem,
                       st, (const float*)a.qkv, kv, a.attn, a.nkv, rep,
                       LOG2E / sqrtf((float)HD));
  if (e != cudaSuccess) return e;
  if constexpr (!KV::FUSE)
    e = launch_dependent(split_merge_kernel<HD, T>, dim3(a.nkv, kv.b), 128,
                         0, st, kv, a.attn, a.nkv, rep);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The attention of one layer (rope + append + attention) at head_dim 64 or
// 128 over any of the policies above.
template <bool ROPE, class KV>
cudaError_t layer_attention(const Stack& a, const KV& kv, cudaStream_t st) {
  return a.hd == 128 ? split_attention<128, ROPE>(a, kv, st)
         : a.hd == 64 ? split_attention<64, ROPE>(a, kv, st)
                      : cudaErrorInvalidValue;
}

// The attention half of layer l (K2's, K5's and K6's): RMSNorm rows into
// a.xn, the qkv product, rope + append + attention over kv, o-proj with the
// residual epilogue into a.xf — 6 launches on `st`.
template <class W = bf16, class KV>
cudaError_t attention_half(const Stack& a, const EMaps& m, int l,
                           const KV& kv, float* ws0, float* ws1,
                           cudaStream_t st) {
  const int b = a.b, h = a.h, hd = a.hd;
  const int dq = a.nh * hd, dkv = a.nkv * hd, dqkv = dq + 2 * dkv;
  rms_rows_kernel<<<b, GT, 0, st>>>(a.xf, a.ln1 + (long)l * h, a.xn, h,
                                    a.eps);
  cudaError_t e = gemm<MODE_QKV, W>(m.wqkv, m.wqkv, m.xn, l, a.qkv, nullptr,
                                    ws0, ws1, b, h, dqkv, st,
                                    srow(a.sqkv, l, dqkv));
  if (e != cudaSuccess) return e;
  e = layer_attention<true>(a, kv, st);
  if (e != cudaSuccess) return e;
  return gemm<MODE_RESID, W>(m.wo, m.wo, m.attn, l, a.xf, nullptr, ws0, ws1,
                             b, dq, h, st, srow(a.so, l, h));
}

// ---------------------------------------------------------------------------
// The gpt mode of K2 and K5 (the arch="gpt" branches of _fused_decode_pallas,
// paddle_tpu/ops/fused_decode.py:645-660, :717-723, :865-873, :907-921, and
// of _fused_paged_decode_pallas). Per layer, 11 launches as llama's:
//   1. LayerNorm of the b rows into bf16 xn (ln1, ln1_b)
//   2. qkv = xn @ wqkv, epilogue + bqkv (fp32)
//   3. append + attention, no rope
//   4. x += (attn @ wo + bo)
//   5. LayerNorm into xn (ln2, ln2_b)
//   6. act = bf16(gelu_tanh(xn @ wg + bg)), one weight (no up-projection)
//   7. x = (x + act @ wd) + bd
// The products run on the engine, as llama's, over the LayerNorm rows and
// the bf16 attention and GELU rows. Bound: bytes, as llama's.
// ---------------------------------------------------------------------------

// LayerNorm of each fp32 row into bf16, one block per row: a two-pass fp32
// mean and variance (E[x^2] - mean^2 loses digits on a residual stream with
// a large mean), then bf16(bf16(bf16(y) * w) + b), the rounding of the plain
// version's y.to(w.dtype) * w + b in bf16.
__global__ void __launch_bounds__(GT)
layernorm_rows_kernel(const float* __restrict__ xf,
                      const bf16* __restrict__ lnw,
                      const bf16* __restrict__ lnb, bf16* __restrict__ xn,
                      int in, float eps) {
  sm90::griddep_launch_dependents();   // the next product's weights may load
  __shared__ float tmp[NWG];
  const float* x = xf + (long)blockIdx.x * in;
  float s = 0.f;
  for (int k = threadIdx.x; k < in; k += GT) s += x[k];
  const float mean = block_sum(s, tmp) / (float)in;
  float ss = 0.f;
  for (int k = threadIdx.x; k < in; k += GT) {
    const float c = x[k] - mean;
    ss += c * c;
  }
  const float rstd = 1.f / sqrtf(block_sum(ss, tmp) / (float)in + eps);
  for (int k = threadIdx.x; k < in; k += GT) {
    const float yw = bf16_round(bf16_round((x[k] - mean) * rstd) *
                                __bfloat162float(lnw[k]));
    xn[(long)blockIdx.x * in + k] =
        __float2bfloat16(yw + __bfloat162float(lnb[k]));
  }
}

// Sum the ks partials of each output in a fixed order, then add the
// product's bias in MODE's place: qkv + b (fp32); the o-proj residual
// x + (o + b) and the fc_out residual (x + d) + b (the reference's orders,
// optionally writing x's bf16 copy); fc_in's bf16(gelu_tanh(g + b)) in fp32
// with the reference's constant form 0.5 g (1 + tanh(sqrt(2/pi)(g +
// 0.044715 g^3))).
template <int MODE>
__global__ void bias_epilogue_kernel(const float* __restrict__ ws, int ks,
                                     int n, int out,
                                     const bf16* __restrict__ bias,
                                     float* __restrict__ yf,
                                     bf16* __restrict__ yb) {
  sm90::griddep_launch_dependents();   // the next product's weights may load
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < ks; ++k) s += ws[(long)k * n + i];
  const float bv = __bfloat162float(bias[i % out]);
  if (MODE == MODE_QKV_B) {
    yf[i] = s + bv;
  } else if (MODE == MODE_ORES_B || MODE == MODE_FRES_B) {
    const float nx = MODE == MODE_ORES_B ? yf[i] + (s + bv) : (yf[i] + s) + bv;
    yf[i] = nx;
    if (yb != nullptr) yb[i] = __float2bfloat16(nx);
  } else {
    const float g = s + bv;
    const float c = 0.7978845608028654f;   // sqrt(2 / pi)
    yb[i] = __float2bfloat16(
        0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g))));
  }
}

template <int MODE>
cudaError_t bias_epilogue(const float* ws, int ks, int rows, int out,
                          const bf16* bias, float* yf, bf16* yb,
                          cudaStream_t st) {
  const int n = rows * out;
  bias_epilogue_kernel<MODE><<<(n + 255) / 256, 256, 0, st>>>(ws, ks, n, out,
                                                              bias, yf, yb);
  return cudaGetLastError();
}

// One skinny GEMM of the gpt mode: the engine's partials of the rows
// behind map x against the layer's weight w, then MODE's bias epilogue.
template <int MODE>
cudaError_t gemm_bias(const CUtensorMap& w, const CUtensorMap& x, int l,
                      const bf16* bias, float* yf, bf16* yb, float* ws,
                      int b, int in, int out, cudaStream_t st) {
  const EPlan p = eplan(b, in, out, 1);
  cudaError_t e = eproduct<bf16>(w, w, x, p, l, ws, ws, b, out, st);
  if (e != cudaSuccess) return e;
  return bias_epilogue<MODE>(ws, p.ks, b, out, bias, yf, yb, st);
}

// Floats of the gpt mode's split-K workspace: the widest of its four
// one-weight products' partial sums.
long gws_layout(int b, int h, int dq, int dqkv, int ffn) {
  const long p[4] = {eparts(b, h, dqkv), eparts(b, dq, h), eparts(b, h, ffn),
                     eparts(b, ffn, h)};
  long a = 0;
  for (long v : p) a = v > a ? v : a;
  return a;
}

// Layer l of the gpt mode over kv (steps 1-7 above) — 11 launches on `st`.
template <class KV>
cudaError_t gpt_layer(const Stack& a, const EMaps& m, int l, const KV& kv,
                      cudaStream_t st) {
  const int b = a.b, h = a.h, hd = a.hd, ffn = a.ffn;
  const int dq = a.nh * hd, dkv = a.nkv * hd, dqkv = dq + 2 * dkv;
  float* ws = a.ws;
  layernorm_rows_kernel<<<b, GT, 0, st>>>(a.xf, a.ln1 + (long)l * h,
                                          a.ln1_b + (long)l * h, a.xn, h,
                                          a.eps);
  cudaError_t e = gemm_bias<MODE_QKV_B>(m.wqkv, m.xn, l,
                                        a.bqkv + (long)l * dqkv, a.qkv,
                                        nullptr, ws, b, h, dqkv, st);
  if (e != cudaSuccess) return e;
  e = layer_attention<false>(a, kv, st);
  if (e != cudaSuccess) return e;
  e = gemm_bias<MODE_ORES_B>(m.wo, m.attn, l, a.bo + (long)l * h, a.xf,
                             nullptr, ws, b, dq, h, st);
  if (e != cudaSuccess) return e;
  layernorm_rows_kernel<<<b, GT, 0, st>>>(a.xf, a.ln2 + (long)l * h,
                                          a.ln2_b + (long)l * h, a.xn, h,
                                          a.eps);
  e = gemm_bias<MODE_GELU_B>(m.wg, m.xn, l, a.bg + (long)l * ffn, nullptr,
                             a.act, ws, b, h, ffn, st);
  if (e != cudaSuccess) return e;
  return gemm_bias<MODE_FRES_B>(m.wd, m.act, l, a.bd + (long)l * h, a.xf,
                                l == a.L - 1 ? a.x_out : nullptr, ws, b, ffn,
                                h, st);
}

// Per layer: the attention half over layer_kv(l), then gate/up and down —
// 1 + 11L launches on `st` (the gpt mode: gpt_layer, also 11 a layer). W is
// the llama weight type; the llama mode's normalised rows sit at the head
// of a.ws (ws_layout). The tensor maps are encoded once here, for the whole
// stack. Returns the first CUDA error.
template <class W = bf16, class LayerKV>
cudaError_t decode_stack(const Stack& a_in, LayerKV layer_kv,
                         cudaStream_t st) {
  const int L = a_in.L, b = a_in.b, h = a_in.h, hd = a_in.hd, ffn = a_in.ffn;
  const int dq = a_in.nh * hd, dkv = a_in.nkv * hd, dqkv = dq + 2 * dkv;
  if (b < 1 || b > 64) return cudaErrorInvalidValue;
  Stack a = a_in;
  float* ws0 = a.ws;
  float* ws1 = nullptr;
  if (!a.gpt) {
    long n0;
    ws_layout(b, h, dq, dqkv, ffn, &n0);
    a.xn = reinterpret_cast<bf16*>(a.ws);
    ws0 = a.ws + xn_floats(b, h);
    ws1 = ws0 + n0;
  }
  EMaps m;
  const int me = emaps(&m, a, EngW<W>::I8);
  if (me != 0) return (cudaError_t)me;
  bf16_to_f32_kernel<<<(b * h + 255) / 256, 256, 0, st>>>(
      a.x_in, a.xf, b * h, a.count, a.ncount);
  cudaError_t e = cudaGetLastError();
  for (int l = 0; l < L && e == cudaSuccess; ++l) {
    if (a.gpt) {
      e = gpt_layer(a, m, l, layer_kv(l), st);
      continue;
    }
    e = attention_half<W>(a, m, l, layer_kv(l), ws0, ws1, st);
    if (e != cudaSuccess) break;
    rms_rows_kernel<<<b, GT, 0, st>>>(a.xf, a.ln2 + (long)l * h, a.xn, h,
                                      a.eps);
    e = gemm<MODE_SWIGLU, W>(m.wg, m.wu, m.xn, l, nullptr, a.act, ws0, ws1,
                             b, h, ffn, st, srow(a.sg, l, ffn),
                             srow(a.su, l, ffn));
    if (e != cudaSuccess) break;
    e = gemm<MODE_RESID, W>(m.wd, m.wd, m.act, l, a.xf,
                            l == L - 1 ? a.x_out : nullptr, ws0, ws1, b, ffn,
                            h, st, srow(a.sd, l, h));
  }
  return e;
}

// ---------------------------------------------------------------------------
// K6's tensor-core GEMM (its routed and shared experts): mma.sync m16n8k16
// bf16 -> fp32 over rows padded to 16, one block per (64 output columns,
// contraction split, operand set z), the weight tile and the rows streamed
// through shared memory by cp.async in 16-byte pieces, four stages deep.
// Split-K partials are summed in a fixed order by the epilogue kernels.
// ---------------------------------------------------------------------------

constexpr int VT = 256;      // threads per GEMM block (8 warps)
constexpr int VN = 64;       // output columns per block
constexpr int VK = 64;       // contraction rows per pipeline stage
constexpr int VSTAGES = 4;   // shared-memory stages (three loads ahead)

// Element (r, c) of a 64-wide bf16 tile in shared memory whose 16-byte
// chunks are XOR-swizzled by the row: the 8 rows one ldmatrix reads (rows
// r0..r0+7, one chunk) land in 8 different bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

// Where a tensor-core product block (blockIdx.z = z) finds its operands:
// the weight W(z) (in, out), activation row r (nullptr: a zero row) and
// the partial-sum row of split ks for row r (nullptr: not stored).
// prepare() runs first in every block, with every thread, over a small
// shared array; a block whose prepare() returns false exits.
//
// DenseOps, K6's shared experts: one activation matrix A (M, in), the
// weight w0 and the partial sums o0 (ks, M, out); z = 1 takes w1 and o1
// (two weights against the same rows in one launch).
struct DenseOps {
  static constexpr int CTX = 1;
  const bf16* A;
  const bf16* w0;
  const bf16* w1;
  float* o0;
  float* o1;
  int M, in;
  __device__ bool prepare(int, int*) const { return true; }
  __device__ const bf16* a_row(int, const int*, int r) const {
    return r < M ? A + (long)r * in : nullptr;
  }
  __device__ const bf16* w(int z, const int*) const { return z ? w1 : w0; }
  __device__ float* out_row(int z, const int*, int ks, int r, int out) const {
    return r < M ? (z ? o1 : o0) + ((long)ks * M + r) * out : nullptr;
  }
};

// Stage c of a block's contraction range: W rows [kc, kc+VK) x the block's
// 64 columns, and the MP activation rows' matching VK columns; what lies
// past the range, the columns or the rows reads as zero.
template <int MP, class Ops>
__device__ __forceinline__ void tc_load_stage(
    bf16* sw, bf16* sa, const Ops& ops, const int* ctx,
    const bf16* __restrict__ W, int out, int n0, int kc, int k1) {
  for (int i = threadIdx.x; i < VK * VN / 8; i += VT) {
    const int r = i >> 3, col = (i & 7) << 3;
    const bool ok = kc + r < k1 && n0 + col < out;
    cp_async16(sw + swz(r, col), ok ? W + (long)(kc + r) * out + n0 + col : W,
               ok);
  }
  for (int i = threadIdx.x; i < MP * VK / 8; i += VT) {
    const int r = i >> 3, col = (i & 7) << 3;
    const bf16* ar = ops.a_row(blockIdx.z, ctx, r);
    const bool ok = ar != nullptr && kc + col < k1;
    cp_async16(sa + swz(r, col), ok ? ar + kc + col : W, ok);
  }
}

// Partial products ws[ks][m][col] of y(M, out) = A(M, in) @ W(in, out),
// M <= 16*MT, over the contraction rows [ks*kper, (ks+1)*kper), with the
// operands Ops gives for blockIdx.z. Warp w owns columns (w%4)*16 .. +16
// of the block's 64 and the k16 steps {2*(w/4), 2*(w/4)+1} of every 64-row
// stage; the two k halves are added through shared memory at the end (a
// fixed order).
template <int MT, class Ops>
__global__ void __launch_bounds__(VT)
tc_gemm_partial_kernel(const Ops ops, int in, int out, int kper) {
  constexpr int MP = MT * 16;
  __shared__ int ctx[Ops::CTX];
  if (!ops.prepare(blockIdx.z, ctx)) return;
  const bf16* __restrict__ W = ops.w(blockIdx.z, ctx);
  extern __shared__ __align__(16) unsigned char vsm[];
  bf16* sw = reinterpret_cast<bf16*>(vsm);   // [VSTAGES][VK][VN]
  bf16* sa = sw + VSTAGES * VK * VN;         // [VSTAGES][MP][VK]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * VN;
  const int k0 = blockIdx.y * kper, k1 = min(in, k0 + kper);
  const int nch = (k1 - k0 + VK - 1) / VK;
  const int nq = warp & 3, kh = warp >> 2;
  const int lr = lane & 7, lm = lane >> 3;

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;

#pragma unroll
  for (int s = 0; s < VSTAGES - 1; ++s) {
    if (s < nch)
      tc_load_stage<MP>(sw + s * VK * VN, sa + s * MP * VK, ops, ctx, W, out,
                        n0, k0 + s * VK, k1);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<VSTAGES - 2>();   // stage c has landed
    __syncthreads();                // ... for every thread; c-1 is consumed
    const int cn = c + VSTAGES - 1;
    if (cn < nch) {
      const int sn = cn % VSTAGES;
      tc_load_stage<MP>(sw + sn * VK * VN, sa + sn * MP * VK, ops, ctx, W,
                        out, n0, k0 + cn * VK, k1);
    }
    cp_async_commit();
    const int st = c % VSTAGES;
    const bf16* w = sw + st * VK * VN;
    const bf16* a = sa + st * MP * VK;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int kb = (kh * 2 + kk) * 16;
      // B fragments of the warp's two n8 tiles: W is stored (k, n), so
      // ldmatrix.trans hands each thread (k = 2c, 2c+1; n = g)
      unsigned bfr[4];
      ldsm_x4_trans(bfr, w + swz(kb + (lm & 1) * 8 + lr,
                                 nq * 16 + (lm >> 1) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned afr[4];
        ldsm_x4(afr, a + swz(mt * 16 + (lm & 1) * 8 + lr,
                             kb + (lm >> 1) * 8));
        mma16816(acc[mt][0], afr, bfr[0], bfr[1]);
        mma16816(acc[mt][1], afr, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the stages are free: reuse them for the k halves

  float* red = reinterpret_cast<float*>(vsm);   // [MT*8][4 nq][32 lanes]
  if (kh == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((mt * 2 + t) * 4 + e) * 128 + nq * 32 + lane] = acc[mt][t][e];
  }
  __syncthreads();
  if (kh == 0) {
    const int g = lane >> 2, cq = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = acc[mt][t][e] +
                 red[((mt * 2 + t) * 4 + e) * 128 + nq * 32 + lane];
        const int col = n0 + nq * 16 + t * 8 + cq * 2;
        const int r0 = mt * 16 + g;
        if (col < out) {
          float* o = ops.out_row(blockIdx.z, ctx, blockIdx.y, r0, out);
          if (o != nullptr)
            *reinterpret_cast<float2*>(o + col) = make_float2(v[0], v[1]);
          o = ops.out_row(blockIdx.z, ctx, blockIdx.y, r0 + 8, out);
          if (o != nullptr)
            *reinterpret_cast<float2*>(o + col) = make_float2(v[2], v[3]);
        }
      }
  }
}

// Contraction splits of a tensor-core product over `slots` independent
// (weight, rows) pairs: about three blocks per SM in all, each split at
// least four stages long.
struct VSplit {
  int ks, kper;
};

VSplit vsplit(int in, int out, int slots = 1) {
  const int tiles = (out + VN - 1) / VN * slots;
  int ks = (3 * num_sms() + tiles - 1) / tiles;
  ks = max(1, min(ks, in / (4 * VK)));
  int kper = (in + ks - 1) / ks;
  kper = (kper + VK - 1) / VK * VK;
  return VSplit{(in + kper - 1) / kper, kper};
}

// Dynamic shared memory of one tensor-core product block of MT row tiles.
constexpr int tc_smem(int mt) {
  return VSTAGES * (VK * VN + mt * 16 * VK) * (int)sizeof(bf16);
}

// One launch of gz product blocks' worth of tiles (blockIdx.z < gz).
template <int MT, class Ops>
cudaError_t tc_launch(const Ops& ops, int in, int out, const VSplit& s,
                      int gz, cudaStream_t st) {
  const int smem = tc_smem(MT);
  static bool opted_in = false;  // above 48 KB needs the opt-in, once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        tc_gemm_partial_kernel<MT, Ops>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  tc_gemm_partial_kernel<MT, Ops><<<dim3((out + VN - 1) / VN, s.ks, gz), VT,
                                    smem, st>>>(ops, in, out, s.kper);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7 — the paged verify step (speculative decoding's scoring pass).
//
// Replaces paddle_tpu/ops/fused_decode.py::_fused_paged_verify_pallas
// (pallas_call at :3055), llama and gpt archs, bf16 or (llama) int8
// weights, a bf16 or an int8 pool.
// Each of b rows brings a tail of K1 tokens (its last sampled token and k
// proposals) at positions pos .. pos+K1-1; all M = b*K1 tail rows (row m =
// bi*K1 + j, the (b, K1, h) layout of x) go through decode_stack together,
// as M one-token rows of K2/K5: the same norm rows, products on the engine
// (N = M rounded up to 8 ... 64) and epilogues, and the split-KV attention
// as a VerifyKV policy (the split-KV attention section above: the K1
// appends of every row through its block table — a block index >= MB goes
// to scratch block 0 — then the attention with query j limited to pos+j,
// then the merge, three launches). 1 + 13L
// launches, both modes. Casts as in K5: bf16 activations into each
// product, fp32 accumulators and residual, k/v rounded to the pool's type
// at the append.
//
// What bounds it on the H100: bytes, as K5 — every layer weight once per
// step plus each row's filled KV — while the products do K1 times K5's
// work, still far below the card's bf16 rate.
// ---------------------------------------------------------------------------

// Floats of the products' share of a step's workspace over M rows: K2/K5's
// layout (the llama mode's normalised rows at its head), or the gpt mode's.
long prod_floats(int M, int h, int nh, int nkv, int hd, int ffn, bool gpt) {
  const int dq = nh * hd, dqkv = dq + 2 * nkv * hd;
  long n0;
  return gpt ? gws_layout(M, h, dq, dqkv, ffn)
             : ws_layout(M, h, dq, dqkv, ffn, &n0);
}

// Floats of K7's workspace: its products' over M = b*K1 rows, 256-byte
// aligned, then the attention's chunk partials over the table's span S =
// MB*BT. *prod receives the products' share.
long verify_ws(int b, int K1, int h, int nh, int nkv, int hd, int ffn,
               int S, bool gpt, long* prod) {
  const long p = (prod_floats(b * K1, h, nh, nkv, hd, ffn, gpt) + 63) & ~63L;
  *prod = p;
  return p + split_part_floats(b, K1, nkv, nh / nkv, hd, S);
}

// K5's and K7's stack over the pool (L, NB, BT, 2*nkv*hd) with the paged
// policy KV (PagedKV: K5, b decode rows; VerifyKV: K7, a holds the M =
// b*K1 tail rows, a.b == b*K1 <= 64) and the weight type W (the llama
// mode's; the gpt mode takes bf16): the attention's TMA map of the whole
// pool, in boxes of gcd(BT, 64) rows (block_tokens not a multiple of 8:
// cp.async instead), and its partials (and K5's counters) in a.ws. The
// int8 pool (KV::T = int8_t) takes its per-row lane scales kvs: row bi of
// layer l at kvs + (l*sb + bi)*2*nkv*hd, sb the scales' row extent (a
// launch over a group of rows of a wider step passes its first row's
// scales and the whole step's sb).
template <class W, class KV>
cudaError_t paged_stack(const Stack& a_in, int b, int K1, void* pool,
                        const float* kvs, int sb, const int* tables,
                        const int* positions, const float* cosr,
                        const float* sinr, int NB, int BT, int MB,
                        cudaStream_t st) {
  using T = typename KV::T;
  if (b < 1 || K1 < 1 || a_in.b != b * K1) return cudaErrorInvalidValue;
  if ((sizeof(T) == 1) != (kvs != nullptr) || (kvs != nullptr && sb < b))
    return cudaErrorInvalidValue;
  Stack a = a_in;
  const int dkv2 = 2 * a.nkv * a.hd;
  KV v{};
  if (KV::FUSE) {
    decode_ws(prod_floats(b, a.h, a.nh, a.nkv, a.hd, a.ffn, a.gpt), b,
              a.nkv, a.nh / a.nkv, a.hd, MB * BT, a.ws, &v.part, &v.count);
    a.count = v.count;
    a.ncount = b * a.nkv;
  } else {
    long prod;
    verify_ws(b, K1, a.h, a.nh, a.nkv, a.hd, a.ffn, MB * BT, a.gpt, &prod);
    v.part = a.ws + prod;
  }
  v.box = BT % 8 == 0 ? (BT & -BT) < 64 ? (BT & -BT) : 64 : 0;
  if (v.box > 0) {
    // int8: one slab of the pool's rows, head-wide unswizzled boxes
    const int e =
        sizeof(T) == 1
            ? sm90_map_kv(&v.map, pool, 1, a.L * NB * BT, dkv2, true, a.hd,
                          v.box)
            : sm90_map_rows(&v.map, pool, a.L * NB * BT, dkv2, v.box);
    if (e != 0) return (cudaError_t)e;
  }
  v.tables = tables;
  v.positions = positions;
  v.cos = cosr;
  v.sin = sinr;
  v.b = b;
  v.K1 = K1;
  v.MB = MB;
  v.BT = BT;
  v.dkv2 = dkv2;
  v.nch = (MB * BT + VA_CHUNK - 1) / VA_CHUNK;
  auto layer_kv = [=](int l) {
    KV w = v;
    w.kv = static_cast<T*>(pool) + (long)l * NB * BT * dkv2;
    w.scales = kvs != nullptr ? kvs + (long)l * sb * dkv2 : nullptr;
    w.lrow0 = l * NB * BT;
    return w;
  };
  return decode_stack<W>(a, layer_kv, st);
}

// paged_stack dispatched on the weight type (a.sqkv non-null: int8 weights)
// and the pool type (kvs non-null: the int8 pool), KV = PagedKV (K5) or
// VerifyKV (K7).
template <template <class> class KV>
cudaError_t paged_modes(const Stack& a, int b, int K1, void* pool,
                        const void* kvs, int sb, const void* tables,
                        const void* positions, const void* cosr,
                        const void* sinr, int NB, int BT, int MB,
                        void* stream) {
  const float* sc = (const float*)kvs;
  const int* tab = (const int*)tables;
  const int* ps = (const int*)positions;
  const float* cr = (const float*)cosr;
  const float* sr = (const float*)sinr;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool w8 = a.sqkv != nullptr;
  if (kvs != nullptr)
    return w8 ? paged_stack<int8_t, KV<int8_t>>(a, b, K1, pool, sc, sb, tab,
                                                ps, cr, sr, NB, BT, MB, st)
              : paged_stack<bf16, KV<int8_t>>(a, b, K1, pool, sc, sb, tab, ps,
                                              cr, sr, NB, BT, MB, st);
  return w8 ? paged_stack<int8_t, KV<bf16>>(a, b, K1, pool, nullptr, sb, tab,
                                            ps, cr, sr, NB, BT, MB, st)
            : paged_stack<bf16, KV<bf16>>(a, b, K1, pool, nullptr, sb, tab,
                                          ps, cr, sr, NB, BT, MB, st);
}

// The contiguous policy over the launch's b rows of a cache (L, cb, S,
// 2*nkv*hd) at kv (T = int8_t: the int8 cache with kv scales kvs, (L,
// 2*nkv*hd) fp32), one position and rope row for all: the cache's 3-d map
// and the partials and counters in a->ws (after the products' `prod`
// floats); a->count is set. Layer l's view: contig_layer.
template <class T>
int contig_kv(ContigKV<T>* v, Stack* a, long prod, void* kv, int S, int cb,
              int pos, const float* cosr, const float* sinr) {
  const int dkv2 = 2 * a->nkv * a->hd;
  *v = ContigKV<T>{};
  const int e = sm90_map_kv(&v->map, kv, (a->L - 1) * cb + a->b, S, dkv2,
                            sizeof(T) == 1, a->hd, VA_KT);
  if (e != 0) return e;
  decode_ws(prod, a->b, a->nkv, a->nh / a->nkv, a->hd, S, a->ws, &v->part,
            &v->count);
  a->count = v->count;
  a->ncount = a->b * a->nkv;
  v->cos = cosr;
  v->sin = sinr;
  v->b = a->b;
  v->K1 = 1;
  v->dkv2 = dkv2;
  v->nch = (S + VA_CHUNK - 1) / VA_CHUNK;
  v->kv = (T*)kv;
  v->S = S;
  v->pos = pos;
  return 0;
}

// Layer l of a contiguous policy over a cache of cb rows a layer (kvs: the
// int8 cache's (L, 2*nkv*hd) lane scales, else null).
template <class T>
ContigKV<T> contig_layer(ContigKV<T> v, int l, int cb, const float* kvs) {
  v.kv += (long)l * cb * v.S * v.dkv2;
  v.z0 = l * cb;
  v.scales = kvs != nullptr ? kvs + (long)l * v.dkv2 : nullptr;
  return v;
}

// ---------------------------------------------------------------------------
// K6 — the MoE decode step (Mixtral / DeepSeekMoE).
//
// Replaces paddle_tpu/ops/fused_decode.py::_fused_decode_moe_pallas
// (pallas_call at :1464), bf16 weights, a bf16 or an int8 KV cache (the
// TPU kernel's kv_scales mode, :1049-1120: K2's ContigKV<int8_t> policy
// over the (L, 2*nkv*hd) lane scales, so the attention half is K2's int8
// KV mode line for line): llama attention, a top-k
// router, the routed experts' SwiGLU and, where the model has them, the
// DeepSeekMoE shared experts, one token per row over the flat cache
// (L, b, S, 2*nkv*hd). Per layer, on one stream, from one C call:
//   1. the attention half of K2 (attention_half: RMSNorm rows into xn, the
//      qkv product on K2's engine, rope + append + attention, o-proj +
//      residual)
//   2. the router, one block per row: xn2 = bf16(rms(x) * ln2) (the bf16
//      value both the router and the experts read), fp32 logits against
//      the (E, h) gate, fp32 softmax, k argmaxes in turn (the lowest index
//      wins a tie, as lax.top_k), weights renormalised with the floor at
//      1e-9; ids and weights go to the (L, b, k) outputs
//   3. shared experts (optional): gate and up in one tensor-core launch,
//      K5's SwiGLU epilogue, down
//   4. routed experts: gate and up in one launch over (distinct-expert
//      slot, column tile, split), K5's SwiGLU epilogue into (b*k, f), down
//      over (slot, column tile, split) into fp32 partials per (row, choice)
//   5. the combine, one thread per (row, column), in a fixed order with no
//      atomics: x += Σ_c w[r,c] * d[r,c] (c in order), then x += shared
// 1 + 11L launches, 1 + 14L with shared experts. Casts as in the plain
// version: bf16 xn2 and activations into each product, fp32 accumulators,
// residual and router.
//
// What bounds it on the H100: bytes. At b <= 8 every weight is used at
// most b times: a step can take no less than (attention, gate and shared
// weights + the distinct routed experts that step uses + the filled KV) /
// 3.35 TB/s. The TPU kernel streams one (row, choice) slot's expert at a
// time through a sequential grid, so an expert two rows choose streams
// twice. Here every block of the expert products finds its own expert: it
// reads the layer's (b, k) ids from device memory and takes the z-th
// distinct one in first-appearance order (the rows that chose it, and at
// which choice, come with it); a slot past the distinct count exits. So
// each routed expert is streamed once per layer for all the rows that
// chose it (one 16-row tensor-core tile holds them), and the host never
// reads the routing: no sync inside a step. The products run on the
// mma.sync tensor-core GEMM above (with a cp.async pipeline). First design:
// no overlap of the shared and routed products, no persistent kernel. A
// launch takes up to MOE_MAX_B rows and MOE_MAX_PAIRS (row, choice) pairs;
// a wider step runs as consecutive launches over groups of rows (the
// Python wrapper), each reading and appending its rows of the cache in
// place (cb: the cache's batch extent).
// ---------------------------------------------------------------------------

constexpr int MOE_MAX_B = 8;       // rows per launch
constexpr int MOE_MAX_PAIRS = 64;  // routed (row, choice) pairs per launch

// A layer's routed experts for one tensor-core product launch. gridDim.z =
// 2 * nslot for gate and up (z >= nslot takes w1 and o1), nslot for down.
// Slot z % nslot is the layer's (z % nslot)-th distinct routed expert in
// first-appearance order over the (b, k) ids, or empty. Row r of the
// product is batch row r when it chose that expert (at choice c_r), else a
// zero row that is not stored; gathered rows read activation row r*k + c_r
// (down: the (b*k, f) SwiGLU output), others row r (gate/up: xn2). Output
// row r goes to partial row r*k + c_r of (ks, b*k, out).
struct MoEOps {
  static constexpr int CTX = 1 + MOE_MAX_B + 2 * MOE_MAX_PAIRS;
  const int* ids;    // (b, k) this layer's routed ids
  const bf16* a;     // (b, in), or (b*k, in) when gathered
  const bf16* w0;    // (E, in, out) this layer's stack
  const bf16* w1;
  float* o0;         // (ks, b*k, out)
  float* o1;
  int b, k, nslot, in, out;
  bool gathered;

  // ctx: [0] the slot's expert (-1: empty), [1 + r] row r's choice of it
  // (-1: none), then the ids and their first-appearance flags
  __device__ bool prepare(int z, int* ctx) const {
    const int n = b * k, slot = z % nslot, t = threadIdx.x;
    int* idv = ctx + 1 + MOE_MAX_B;
    int* first = idv + MOE_MAX_PAIRS;
    if (t < n) idv[t] = ids[t];
    if (t == 0) ctx[0] = -1;
    __syncthreads();
    if (t < n) {
      int f = 1;
      for (int j = 0; j < t; ++j) f &= idv[j] != idv[t];
      first[t] = f;
    }
    __syncthreads();
    if (t < n && first[t]) {
      int rank = 0;
      for (int j = 0; j < t; ++j) rank += first[j];
      if (rank == slot) ctx[0] = idv[t];
    }
    __syncthreads();
    if (t < b) {
      int c = -1;
      for (int cc = 0; cc < k; ++cc)
        if (idv[t * k + cc] == ctx[0]) c = cc;
      ctx[1 + t] = c;
    }
    __syncthreads();
    return ctx[0] >= 0;
  }
  __device__ const bf16* a_row(int, const int* ctx, int r) const {
    if (r >= b || ctx[1 + r] < 0) return nullptr;
    return a + (long)(gathered ? r * k + ctx[1 + r] : r) * in;
  }
  __device__ const bf16* w(int z, const int* ctx) const {
    return (z >= nslot ? w1 : w0) + (long)ctx[0] * in * out;
  }
  __device__ float* out_row(int z, const int* ctx, int ks, int r,
                            int) const {
    if (r >= b || ctx[1 + r] < 0) return nullptr;
    return (z >= nslot ? o1 : o0) +
           ((long)ks * b * k + r * k + ctx[1 + r]) * out;
  }
};

// The router of one layer, one block per row bi (step 2 above). Dynamic
// shared memory: xn2 as fp32 (h), then the E logits / probabilities.
__global__ void __launch_bounds__(GT)
moe_router_kernel(const float* __restrict__ xf, const bf16* __restrict__ ln2,
                  const bf16* __restrict__ gate, bf16* __restrict__ xn,
                  int* __restrict__ ids, float* __restrict__ wts, int h,
                  int E, int k, float eps) {
  extern __shared__ float rsm[];
  __shared__ float tmp[NWG];
  __shared__ float vals[MOE_MAX_PAIRS];
  float* xs = rsm;
  float* lg = rsm + h;
  const int bi = blockIdx.x, tid = threadIdx.x, warp = tid >> 5,
            lane = tid & 31;
  const float* x = xf + (long)bi * h;
  float ss = 0.f;
  for (int i = tid; i < h; i += GT) ss += x[i] * x[i];
  ss = block_sum(ss, tmp);
  const float rstd = 1.f / sqrtf(ss / (float)h + eps);
  for (int i = tid; i < h; i += GT) {
    const bf16 v = __float2bfloat16(bf16_round(x[i] * rstd) *
                                    __bfloat162float(ln2[i]));
    xn[(long)bi * h + i] = v;
    xs[i] = __bfloat162float(v);
  }
  __syncthreads();
  for (int e = warp; e < E; e += NWG) {
    const bf16* g = gate + (long)e * h;
    float s = 0.f;
#pragma unroll 4
    for (int i = lane * 8; i < h; i += 256) {   // 16-byte loads (h % 8 == 0)
      float gf[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(g + i)), gf);
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(xs[i + j], gf[j], s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffff, s, o);
    if (lane == 0) lg[e] = s;
  }
  __syncthreads();
  if (warp != 0) return;
  float m = -INFINITY;
  for (int e = lane; e < E; e += 32) m = fmaxf(m, lg[e]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffff, m, o));
  float sum = 0.f;
  for (int e = lane; e < E; e += 32) sum += expf(lg[e] - m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffff, sum, o);
  for (int e = lane; e < E; e += 32) lg[e] = expf(lg[e] - m) / sum;
  __syncwarp();
  for (int c = 0; c < k; ++c) {
    float bv = -2.f;   // probabilities are >= 0; a chosen one becomes -1
    int bix = E;
    for (int e = lane; e < E; e += 32)
      if (lg[e] > bv) {
        bv = lg[e];
        bix = e;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffff, bv, o);
      const int oi = __shfl_xor_sync(0xffffffff, bix, o);
      if (ov > bv || (ov == bv && oi < bix)) {
        bv = ov;
        bix = oi;
      }
    }
    if (lane == 0) {
      ids[bi * k + c] = bix;
      vals[c] = bv;
      lg[bix] = -1.f;
    }
    __syncwarp();
  }
  if (lane == 0) {
    float tot = 0.f;
    for (int c = 0; c < k; ++c) tot += vals[c];
    tot = fmaxf(tot, 1e-9f);
    for (int c = 0; c < k; ++c) wts[bi * k + c] = vals[c] / tot;
  }
}

// x += Σ_c w[r,c] * d[r,c] (c in order; d summed over its splits in order),
// then x += the shared experts' output (summed likewise); the last layer
// also writes x_out in bf16. One thread per (row, column).
__global__ void moe_combine_kernel(const float* __restrict__ dpart, int ksd,
                                   const float* __restrict__ wts,
                                   const float* __restrict__ spart, int kss,
                                   float* __restrict__ xf,
                                   bf16* __restrict__ x_out, int b, int k,
                                   int h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b * h) return;
  const int r = i / h, col = i % h;
  float routed = 0.f;
  for (int c = 0; c < k; ++c) {
    float d = 0.f;
    for (int s = 0; s < ksd; ++s)
      d += dpart[((long)s * b * k + r * k + c) * h + col];
    routed += wts[r * k + c] * d;
  }
  float nx = xf[i] + routed;
  if (spart != nullptr) {
    float sh = 0.f;
    for (int s = 0; s < kss; ++s) sh += spart[((long)s * b + r) * h + col];
    nx += sh;
  }
  xf[i] = nx;
  if (x_out != nullptr) x_out[i] = __float2bfloat16(nx);
}

// The splits of K6's products and its workspace, in floats: the attention
// half's partials, then the routed gate, up and down partials
// and the shared ones, each region even (float2 stores).
struct MoEPlan {
  VSplit gu, dn, sgu, sdn;
  long attn, g, u, d, sg, su, sd, total;
};

MoEPlan moe_plan(int b, int h, int dq, int dqkv, int k, int f, int fs) {
  MoEPlan p;
  const int nslot = b * k, fsw = fs > 0 ? fs : 8;
  p.gu = vsplit(h, f, 2 * nslot);
  p.dn = vsplit(f, h, nslot);
  p.sgu = vsplit(h, fsw, 2);
  p.sdn = vsplit(fsw, h);
  auto even = [](long n) { return (n + 1) & ~1L; };
  long a = eparts(b, h, dqkv);
  a = a > eparts(b, dq, h) ? a : eparts(b, dq, h);
  const long sh = fs > 0 ? 1 : 0;
  p.attn = 0;
  p.g = p.attn + even(a);
  p.u = p.g + even((long)p.gu.ks * nslot * f);
  p.d = p.u + even((long)p.gu.ks * nslot * f);
  p.sg = p.d + even((long)p.dn.ks * nslot * h);
  p.su = p.sg + sh * even((long)p.sgu.ks * b * fs);
  p.sd = p.su + sh * even((long)p.sgu.ks * b * fs);
  p.total = p.sd + sh * even((long)p.sdn.ks * b * h);
  return p;
}

struct MoEArgs {
  const bf16 *gate, *weg, *weu, *wed, *wsg, *wsu, *wsd;
  int* ids;      // (L, b, k)
  float* wts;    // (L, b, k)
  bf16 *xn, *act, *sact;
  int E, k, f, fs;
};

template <class T>
cudaError_t moe_stack(const Stack& a_in, const MoEArgs& m, T* kv,
                      const float* kvs, const float* cosr, const float* sinr,
                      int S, int cb, int pos, cudaStream_t st) {
  Stack a = a_in;
  const int L = a.L, b = a.b, h = a.h, hd = a.hd, k = m.k, f = m.f,
            fs = m.fs, E = m.E;
  const int dq = a.nh * hd, dkv = a.nkv * hd, dqkv = dq + 2 * dkv;
  const int nslot = b * k;
  if (b < 1 || b > MOE_MAX_B || cb < b || k < 1 || k > E ||
      nslot > MOE_MAX_PAIRS ||
      h + E > 12000)   // the router's shared memory stays under 48 KB
    return cudaErrorInvalidValue;
  const MoEPlan p = moe_plan(b, h, dq, dqkv, k, f, fs);
  float* ws0 = a.ws + p.attn;
  ContigKV<T> kv0;   // the attention's partials follow the plan's total
  const int ce = contig_kv(&kv0, &a, p.total, kv, S, cb, pos, cosr, sinr);
  if (ce != 0) return (cudaError_t)ce;
  EMaps maps;   // the attention half's: wqkv, wo, xn (the router's), attn
  const int me = emaps(&maps, a, false);
  if (me != 0) return (cudaError_t)me;
  bf16_to_f32_kernel<<<(b * h + 255) / 256, 256, 0, st>>>(
      a.x_in, a.xf, b * h, a.count, a.ncount);
  cudaError_t e = cudaGetLastError();
  for (int l = 0; l < L && e == cudaSuccess; ++l) {
    e = attention_half(a, maps, l, contig_layer(kv0, l, cb, kvs), ws0, ws0,
                       st);
    if (e != cudaSuccess) break;
    int* ids = m.ids + (long)l * nslot;
    float* wts = m.wts + (long)l * nslot;
    moe_router_kernel<<<b, GT, (h + E) * (int)sizeof(float), st>>>(
        a.xf, a.ln2 + (long)l * h, m.gate + (long)l * E * h, m.xn, ids, wts,
        h, E, k, a.eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) break;
    if (fs > 0) {
      const bf16* wsdl = m.wsd + (long)l * fs * h;
      e = tc_launch<1>(DenseOps{m.xn, m.wsg + (long)l * h * fs,
                                m.wsu + (long)l * h * fs, a.ws + p.sg,
                                a.ws + p.su, b, h},
                       h, fs, p.sgu, 2, st);
      if (e != cudaSuccess) break;
      gemm_epilogue_kernel<MODE_SWIGLU><<<(b * fs + 255) / 256, 256, 0, st>>>(
          a.ws + p.sg, a.ws + p.su, p.sgu.ks, b * fs, nullptr, m.sact);
      e = tc_launch<1>(DenseOps{m.sact, wsdl, wsdl, a.ws + p.sd, a.ws + p.sd,
                                b, fs},
                       fs, h, p.sdn, 1, st);
      if (e != cudaSuccess) break;
    }
    const long estride = (long)E * h * f;
    const MoEOps gu{ids, m.xn, m.weg + l * estride, m.weu + l * estride,
                    a.ws + p.g, a.ws + p.u, b, k, nslot, h, f, false};
    e = tc_launch<1>(gu, h, f, p.gu, 2 * nslot, st);
    if (e != cudaSuccess) break;
    gemm_epilogue_kernel<MODE_SWIGLU><<<(nslot * f + 255) / 256, 256, 0,
                                        st>>>(a.ws + p.g, a.ws + p.u,
                                              p.gu.ks, nslot * f, nullptr,
                                              m.act);
    const MoEOps dn{ids, m.act, m.wed + l * estride, m.wed + l * estride,
                    a.ws + p.d, a.ws + p.d, b, k, nslot, f, h, true};
    e = tc_launch<1>(dn, f, h, p.dn, nslot, st);
    if (e != cudaSuccess) break;
    moe_combine_kernel<<<(b * h + 255) / 256, 256, 0, st>>>(
        a.ws + p.d, p.dn.ks, wts, fs > 0 ? a.ws + p.sd : nullptr, p.sdn.ks,
        a.xf, l == L - 1 ? a.x_out : nullptr, b, k, h);
    e = cudaGetLastError();
  }
  return e;
}

Stack make_stack(const void* x_in, void* x_out, const void* ln1,
                 const void* wqkv, const void* wo, const void* ln2,
                 const void* wg, const void* wu, const void* wd, void* xf,
                 void* qkv, void* attn, void* act, void* ws, int L, int b,
                 int h, int nh, int nkv, int hd, int ffn, float eps) {
  return Stack{(const bf16*)x_in, (const bf16*)ln1, (const bf16*)wqkv,
               (const bf16*)wo,   (const bf16*)ln2, (const bf16*)wg,
               (const bf16*)wu,   (const bf16*)wd,  (bf16*)x_out,
               (float*)xf,        (float*)qkv,      (float*)ws,
               (bf16*)attn,       (bf16*)act,       L, b, h, nh, nkv, hd,
               ffn,               eps};
}

// The gpt mode's Stack: the twelve stacks in build_fused_params_gpt's order
// (ln1, ln1_b, wqkv, bqkv, wo, bo, ln2, ln2_b, wg, bg, wd, bd).
Stack make_gpt_stack(const void* x_in, void* x_out, const void* ln1,
                     const void* ln1_b, const void* wqkv, const void* bqkv,
                     const void* wo, const void* bo, const void* ln2,
                     const void* ln2_b, const void* wg, const void* bg,
                     const void* wd, const void* bd, void* xf, void* xn,
                     void* qkv, void* attn, void* act, void* ws, int L, int b,
                     int h, int nh, int nkv, int hd, int ffn, float eps) {
  Stack a = make_stack(x_in, x_out, ln1, wqkv, wo, ln2, wg, nullptr, wd, xf,
                       qkv, attn, act, ws, L, b, h, nh, nkv, hd, ffn, eps);
  a.gpt = true;
  a.ln1_b = (const bf16*)ln1_b;
  a.bqkv = (const bf16*)bqkv;
  a.bo = (const bf16*)bo;
  a.ln2_b = (const bf16*)ln2_b;
  a.bg = (const bf16*)bg;
  a.bd = (const bf16*)bd;
  a.xn = (bf16*)xn;
  return a;
}

}  // namespace

// K2's stack over the contiguous policy of cache type T (W: the llama
// mode's weight type; the gpt mode takes bf16): the policy's partials and
// counters after the products' share of a.ws.
template <class W, class T>
cudaError_t contig_stack(Stack a, void* kv, const void* kvs, int S, int cb,
                         int pos, const void* cosr, const void* sinr,
                         cudaStream_t st) {
  ContigKV<T> v;
  const int e = contig_kv(
      &v, &a, prod_floats(a.b, a.h, a.nh, a.nkv, a.hd, a.ffn, a.gpt), kv, S,
      cb, pos, (const float*)cosr, (const float*)sinr);
  if (e != 0) return (cudaError_t)e;
  const float* sc = (const float*)kvs;
  return decode_stack<W>(
      a, [=](int l) { return contig_layer(v, l, cb, sc); }, st);
}

// Floats of K2's and K5's llama workspace for b rows over a key span S
// (K2: the cache length; K5: the table's MB*BT).
extern "C" long fused_decode_llama_workspace(int b, int h, int nh, int nkv,
                                             int hd, int ffn, int S) {
  return decode_ws(prod_floats(b, h, nh, nkv, hd, ffn, false), b, nkv,
                   nh / nkv, hd, S);
}

// K2 — one decode step through all L layers. Stacked weights (L, ...) as
// built by build_fused_params; kv holds the b rows of a cache (L, cb, S,
// 2*nkv*hd), cb >= b (a group of rows of a wider batch: the layer stride
// is cb*S*2*nkv*hd), updated in place at `pos`. Scratch: xf (b,h) f32,
// qkv (b,dqkv) f32, attn (b,dq) bf16, act (b,ffn) bf16, ws
// (fused_decode_llama_workspace floats). The int8
// modes: scale rows sqkv, so, sg, su, sd ((L, out) fp32 each) make the five
// weight stacks int8; kv scales kvs ((L, 2*nkv*hd) fp32) make kv int8. Null
// pointers select bf16. Returns the first CUDA error, 0 on success.
extern "C" int fused_decode_llama(
    const void* x_in, void* x_out, const void* ln1, const void* wqkv,
    const void* wo, const void* ln2, const void* wg, const void* wu,
    const void* wd, const void* sqkv, const void* so, const void* sg,
    const void* su, const void* sd, void* kv, const void* kvs,
    const void* cosr, const void* sinr, void* xf, void* qkv, void* attn,
    void* act, void* ws, int L, int b, int h, int nh, int nkv, int hd,
    int ffn, int S, int cb, int pos, float eps, void* stream) {
  if (cb < b) return (int)cudaErrorInvalidValue;
  Stack a = make_stack(x_in, x_out, ln1, wqkv, wo, ln2, wg, wu, wd, xf, qkv,
                       attn, act, ws, L, b, h, nh, nkv, hd, ffn, eps);
  a.sqkv = (const float*)sqkv;
  a.so = (const float*)so;
  a.sg = (const float*)sg;
  a.su = (const float*)su;
  a.sd = (const float*)sd;
  const bool w8 = sqkv != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  if (kvs != nullptr)
    return (int)(w8 ? contig_stack<int8_t, int8_t>(a, kv, kvs, S, cb, pos,
                                                   cosr, sinr, st)
                    : contig_stack<bf16, int8_t>(a, kv, kvs, S, cb, pos,
                                                 cosr, sinr, st));
  return (int)(w8 ? contig_stack<int8_t, bf16>(a, kv, nullptr, S, cb, pos,
                                               cosr, sinr, st)
                  : contig_stack<bf16, bf16>(a, kv, nullptr, S, cb, pos,
                                             cosr, sinr, st));
}

// K5 — one decode step through all L layers over the PAGED pool. Replaces
// the TPU kernel paddle_tpu/ops/fused_decode.py::_fused_paged_decode_pallas
// (pallas_call at :2267), llama arch, bf16 or int8 weights, a bf16 or an
// int8 pool. The products are K2's; only the attention's addressing
// differs: row bi appends at pool[l, tables[bi, pos/BT], pos%BT] for its
// own pos = positions[bi] and reads key t from pool[l, tables[bi, t/BT],
// t%BT] for t <= pos. Positions, block tables and the (b, hd) rope rows are
// read from device memory, so a step uploads nothing. kv_pool (L, NB, BT,
// 2*nkv*hd) is updated in place, except that an idle row's append (its
// block is scratch block 0) is not written; scratch as for
// fused_decode_llama. The int8 modes: scale rows sqkv, so, sg, su, sd
// ((L, out) fp32 each) make the five weight stacks int8, as K2's; per-row
// kv scales kvs (row bi of layer l at kvs + (l*sb + bi)*2*nkv*hd, fp32;
// the reference's (L, b, 2*nkv*hd) kv_scales with sb = b) make the pool
// int8: the append is rint(kv / scale) clipped to +-127 with the row's own
// scales, and the row's keys and values are read with them. Null pointers
// select bf16. Callers keep every positions[bi] below MB*BT (the engine
// clamps at max_seq_len - 1).
extern "C" int fused_paged_decode_llama(
    const void* x_in, void* x_out, const void* ln1, const void* wqkv,
    const void* wo, const void* ln2, const void* wg, const void* wu,
    const void* wd, const void* sqkv, const void* so, const void* sg,
    const void* su, const void* sd, void* kv_pool, const void* kvs,
    const void* tables, const void* positions, const void* cosr,
    const void* sinr, void* xf, void* qkv, void* attn, void* act, void* ws,
    int L, int b, int h, int nh, int nkv, int hd, int ffn, int NB, int BT,
    int MB, int sb, float eps, void* stream) {
  Stack a = make_stack(x_in, x_out, ln1, wqkv, wo, ln2, wg, wu, wd, xf, qkv,
                       attn, act, ws, L, b, h, nh, nkv, hd, ffn, eps);
  a.sqkv = (const float*)sqkv;
  a.so = (const float*)so;
  a.sg = (const float*)sg;
  a.su = (const float*)su;
  a.sd = (const float*)sd;
  return (int)paged_modes<PagedKV>(a, b, 1, kv_pool, kvs, sb, tables,
                                   positions, cosr, sinr, NB, BT, MB, stream);
}

extern "C" long fused_paged_verify_workspace(int b, int K1, int h, int nh,
                                             int nkv, int hd, int ffn, int S,
                                             int gpt) {
  long prod;
  return verify_ws(b, K1, h, nh, nkv, hd, ffn, S, gpt != 0, &prod);
}

// K7 — one verify step through all L layers for b rows of K1 tail tokens
// (see the K7 section above). x_in/x_out (b, K1, h) bf16; kv_pool
// (L, NB, BT, 2*nkv*hd) updated in place at positions[bi] + j, j < K1;
// tables (b, MB) and positions (b,) int32 and the (b, K1, hd) rope rows
// read on the device. Scratch as for K2 over M = b*K1 rows: xf (M, h)
// f32, qkv (M, dqkv) f32, attn (M, dq) bf16, act (M, ffn) bf16, ws
// (fused_paged_verify_workspace(..., S = MB*BT, gpt = 0) floats); M <= 64.
// The int8 modes as K5's: scale rows sqkv ... sd make the weights int8, the
// per-row kv scales kvs (sb rows a layer) the pool int8 (row bi's K1
// appends quantized with its own scales). Returns the first CUDA error, 0
// on success.
extern "C" int fused_paged_verify_llama(
    const void* x_in, void* x_out, const void* ln1, const void* wqkv,
    const void* wo, const void* ln2, const void* wg, const void* wu,
    const void* wd, const void* sqkv, const void* so, const void* sg,
    const void* su, const void* sd, void* kv_pool, const void* kvs,
    const void* tables, const void* positions, const void* cosr,
    const void* sinr, void* xf, void* qkv, void* attn, void* act, void* ws,
    int L, int b, int K1, int h, int nh, int nkv, int hd, int ffn, int NB,
    int BT, int MB, int sb, float eps, void* stream) {
  Stack a = make_stack(x_in, x_out, ln1, wqkv, wo, ln2, wg, wu, wd, xf, qkv,
                       attn, act, ws, L, b * K1, h, nh, nkv, hd, ffn, eps);
  a.sqkv = (const float*)sqkv;
  a.so = (const float*)so;
  a.sg = (const float*)sg;
  a.su = (const float*)su;
  a.sd = (const float*)sd;
  return (int)paged_modes<VerifyKV>(a, b, K1, kv_pool, kvs, sb, tables,
                                    positions, cosr, sinr, NB, BT, MB,
                                    stream);
}

extern "C" long fused_decode_moe_workspace(int b, int h, int nh, int nkv,
                                           int hd, int k, int f, int fs,
                                           int S) {
  return decode_ws(moe_plan(b, h, nh * hd, (nh + 2 * nkv) * hd, k, f, fs).total,
                   b, nkv, nh / nkv, hd, S);
}

// K6 — one MoE decode step through all L layers (see the K6 section above).
// Stacked weights as built by build_fused_params_moe: gate (L, E, h), weg /
// weu (L, E, h, f), wed (L, E, f, h); wsg / wsu (L, h, fs) and wsd
// (L, fs, h) when fs > 0 (nullptr otherwise). kv (L, b, S, 2*nkv*hd) is
// updated in place at `pos`; non-null kv scales kvs ((L, 2*nkv*hd) fp32,
// the reference's (L, 1, 2*nkv*hd) kv_scales) make it int8: K2's int8 KV
// mode (ContigKV<int8_t>), the append rint(kv / scale) clipped to +-127,
// keys and values read with the lane scales. Outputs: x_out (b, h) bf16,
// the routing ids
// (L, b, k) int32 and weights (L, b, k) fp32. Scratch: xf (b, h) f32, qkv
// (b, dqkv) f32, attn (b, dq) bf16, xn (b, h) bf16, act (b*k, f) bf16, sact
// (b, fs) bf16, ws (fused_decode_moe_workspace floats). b <= 8, b*k <= 64;
// kv holds the b rows of a cache (L, cb, S, 2*nkv*hd), cb >= b, as K2's.
// Returns the first CUDA error, 0 on success.
extern "C" int fused_decode_moe(
    const void* x_in, void* x_out, const void* ln1, const void* wqkv,
    const void* wo, const void* ln2, const void* gate, const void* weg,
    const void* weu, const void* wed, const void* wsg, const void* wsu,
    const void* wsd, void* kv, const void* kvs, const void* cosr,
    const void* sinr, void* ids,
    void* wts, void* xf, void* qkv, void* attn, void* xn, void* act,
    void* sact, void* ws, int L, int b, int h, int nh, int nkv, int hd, int E,
    int k, int f, int fs, int S, int cb, int pos, float eps, void* stream) {
  Stack a = make_stack(x_in, x_out, ln1, wqkv, wo, ln2, nullptr, nullptr,
                       nullptr, xf, qkv, attn, nullptr, ws, L, b, h, nh, nkv,
                       hd, 0, eps);
  a.xn = (bf16*)xn;   // the router's rows; the attention half's first
  const MoEArgs m{(const bf16*)gate, (const bf16*)weg, (const bf16*)weu,
                  (const bf16*)wed,  (const bf16*)wsg, (const bf16*)wsu,
                  (const bf16*)wsd,  (int*)ids,        (float*)wts,
                  (bf16*)xn,         (bf16*)act,       (bf16*)sact,
                  E,                 k,                f,
                  fs};
  const cudaStream_t st = (cudaStream_t)stream;
  if (kvs != nullptr)
    return (int)moe_stack(a, m, (int8_t*)kv, (const float*)kvs,
                          (const float*)cosr, (const float*)sinr, S, cb, pos,
                          st);
  return (int)moe_stack(a, m, (bf16*)kv, nullptr, (const float*)cosr,
                        (const float*)sinr, S, cb, pos, st);
}

// ---------------------------------------------------------------------------
// The gpt mode's entry points (see the gpt section): K2, K5 and K7 with
// LayerNorm + bias, biased products, no rope and the tanh-GELU FFN. The
// stacks come in build_fused_params_gpt's order; no rope rows are taken.
// Scratch as for the llama entry points plus xn (rows, h) bf16, the
// LayerNorm rows; K2/K5's ws holds fused_decode_gpt_workspace floats, K7's
// fused_paged_verify_workspace(..., gpt = 1) floats.
// ---------------------------------------------------------------------------

extern "C" long fused_decode_gpt_workspace(int b, int h, int nh, int nkv,
                                           int hd, int ffn, int S) {
  return decode_ws(prod_floats(b, h, nh, nkv, hd, ffn, true), b, nkv,
                   nh / nkv, hd, S);
}

// K2, gpt mode — one decode step through all L layers over the b rows of
// a contiguous cache (L, cb, S, 2*nkv*hd), updated in place at `pos`;
// 1 + 11L launches.
// Non-null kv scales kvs ((L, 2*nkv*hd) fp32) make kv int8 (the int8 KV
// mode); the gpt mode takes bf16 weights only, as the reference's.
extern "C" int fused_decode_gpt(
    const void* x_in, void* x_out, const void* ln1, const void* ln1_b,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* ln2, const void* ln2_b, const void* wg, const void* bg,
    const void* wd, const void* bd, void* kv, const void* kvs, void* xf,
    void* xn, void* qkv, void* attn, void* act, void* ws, int L, int b, int h,
    int nh, int nkv, int hd, int ffn, int S, int cb, int pos, float eps,
    void* stream) {
  if (cb < b) return (int)cudaErrorInvalidValue;
  const Stack a = make_gpt_stack(x_in, x_out, ln1, ln1_b, wqkv, bqkv, wo, bo,
                                 ln2, ln2_b, wg, bg, wd, bd, xf, xn, qkv,
                                 attn, act, ws, L, b, h, nh, nkv, hd, ffn,
                                 eps);
  const cudaStream_t st = (cudaStream_t)stream;
  if (kvs != nullptr)
    return (int)contig_stack<bf16, int8_t>(a, kv, kvs, S, cb, pos, nullptr,
                                           nullptr, st);
  return (int)contig_stack<bf16, bf16>(a, kv, nullptr, S, cb, pos, nullptr,
                                       nullptr, st);
}

// K5, gpt mode — the same step over the paged pool (L, NB, BT, 2*nkv*hd)
// through per-row block tables and positions read on the device; K2's
// products and attention code, so K5 gives K2's bits at equal positions.
// Non-null per-row kv scales kvs (sb rows a layer, as the llama mode's)
// make the pool int8; the gpt mode takes bf16 weights only, as the
// reference's.
extern "C" int fused_paged_decode_gpt(
    const void* x_in, void* x_out, const void* ln1, const void* ln1_b,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* ln2, const void* ln2_b, const void* wg, const void* bg,
    const void* wd, const void* bd, void* kv_pool, const void* kvs,
    const void* tables, const void* positions, void* xf, void* xn, void* qkv,
    void* attn, void* act, void* ws, int L, int b, int h, int nh, int nkv,
    int hd, int ffn, int NB, int BT, int MB, int sb, float eps,
    void* stream) {
  const Stack a = make_gpt_stack(x_in, x_out, ln1, ln1_b, wqkv, bqkv, wo, bo,
                                 ln2, ln2_b, wg, bg, wd, bd, xf, xn, qkv,
                                 attn, act, ws, L, b, h, nh, nkv, hd, ffn,
                                 eps);
  return (int)paged_modes<PagedKV>(a, b, 1, kv_pool, kvs, sb, tables,
                                   positions, nullptr, nullptr, NB, BT, MB,
                                   stream);
}

// K7, gpt mode — one verify step for b rows of K1 tail tokens (M = b*K1 <=
// 64) over the paged pool, appends at positions[bi] + j; 1 + 13L launches;
// kvs as K5's gpt mode.
extern "C" int fused_paged_verify_gpt(
    const void* x_in, void* x_out, const void* ln1, const void* ln1_b,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* ln2, const void* ln2_b, const void* wg, const void* bg,
    const void* wd, const void* bd, void* kv_pool, const void* kvs,
    const void* tables, const void* positions, void* xf, void* xn, void* qkv,
    void* attn, void* act, void* ws, int L, int b, int K1, int h, int nh,
    int nkv, int hd, int ffn, int NB, int BT, int MB, int sb, float eps,
    void* stream) {
  const Stack a = make_gpt_stack(x_in, x_out, ln1, ln1_b, wqkv, bqkv, wo, bo,
                                 ln2, ln2_b, wg, bg, wd, bd, xf, xn, qkv,
                                 attn, act, ws, L, b * K1, h, nh, nkv, hd,
                                 ffn, eps);
  return (int)paged_modes<VerifyKV>(a, b, K1, kv_pool, kvs, sb, tables,
                                    positions, nullptr, nullptr, NB, BT, MB,
                                    stream);
}

// The dynamic shared memory a block of these kernels asks for: kind 0 the
// split-KV attention of the decode steps K2, K5 and K6 (a = head_dim; b = 1
// over the int8 cache or pool), 1 K6's tensor-core product (a = 16-row
// tiles), 2 the same attention kernel as K7 launches it (a = head_dim; b =
// 1 over the int8 pool), 3 the
// product engine (a = its N: 8, 16, 32 or 64; b = 1 for int8 weights). -1
// for an unknown kind. The launchers compute their requests with the same
// functions, so a caller can hold them to the device's opt-in budget.
extern "C" int fused_decode_dynamic_smem(int kind, int a, int b, int) {
  switch (kind) {
    case 0: return split_smem(a, b != 0, false);
    case 1: return tc_smem(a);
    case 2: return split_smem(a, b != 0, true);
    case 3: return engine_smem(a, b != 0);
  }
  return -1;
}
