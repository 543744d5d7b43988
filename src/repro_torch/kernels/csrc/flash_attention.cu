// Blockwise (flash) attention forward on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel): causal, sliding-window and softcapped GQA attention over
// q (B, Hq, S, D) and k, v (B, Hkv, S, D), online softmax in float32,
// output in q's type.
//
// Bound on this card: operations at prefill lengths (4·D FLOP for every
// (row, column) pair the masks keep, against 2·S·D·2 bytes a head read and
// written): 0.834 ms at the starcoder2-3b prefill (8, 24, 4096, 128) bf16
// causal on the bf16 tensor-core peak; bytes only for short sequences.
//
// Two bodies behind one launch function:
//
// bf16 storage (the serving path): the tensor-core body `tc::fa_tc`.
//   One CTA owns 128 q rows of one (b, q head) and runs three warpgroups:
//   two consumers of 64 rows each and a producer. The producer's first
//   thread issues TMA loads (128-byte swizzle, zero fill past S): Q once,
//   then K and V as (BK x D) bf16 tiles through a ring of full/empty
//   mbarriers (three stages for D <= 128, two for D = 256); K/V are read
//   in place for KV head h / group, never replicated. Each consumer
//   computes S = Q·Kᵀ with wgmma (m64nBKk16, both operands K-major in
//   shared memory, float32 accumulation: bf16 x bf16 products are exact
//   in float32), applies scale and softcap to the float32 scores (without
//   a softcap, scale enters the exponent's FMA), masks (causal, window,
//   ragged tail) only the tiles that straddle an edge, and runs the online
//   softmax in registers (a row lives in 4 threads: quad shuffles), with
//   the reference's NEG sentinel and l == 0 -> 1 rule. O += P·V takes P
//   from registers as the A operand, split as P_hi = bf16(P) and
//   P_lo = bf16(P - P_hi), two wgmmas into the same float32 accumulator,
//   so P keeps about 16 bits of mantissa; V is the MN-major B operand
//   (transpose bit). Rounding P once to bf16, as a stock flash kernel
//   does, would miss the plain version by about 2^-9 of the output's
//   scale, outside the bf16 tolerance; the split costs 1.5x the FLOPs of
//   a single-pass kernel (QKᵀ once, PV twice). Tile j+1's QKᵀ and tile
//   j's P·V are issued as one batch of asynchronous wgmmas; the other
//   consumer's batch covers this one's softmax. The epilogue divides by l,
//   rounds once to bf16 and stores 16-byte rows through shared memory.
//   Q tiles run longest first, so the causal tail is short.
//   BK = 128 for D <= 128, 64 for D = 256.
//
// float32 storage (not on the serving path): the SIMT body `simt::fa_fwd`:
//   one CTA per (b, q head, 64-row q tile), K/V tiles staged as float32,
//   both products in SIMT float32 loops.
//
// Kv tiles that the causal or window bound masks entirely are never
// loaded.
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3e38f;  // the reference's mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, s;
  int causal;
  int window;   // <= 0: no window
  float cap;    // <= 0: no softcap
  float scale;
};

// ---------------------------------------------------------------------------
// float32 storage: the SIMT body.
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16: tx picks columns, ty rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1) +
         2 * kBQ * 4 + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_fwd(Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int NC = D / 16;  // accumulator columns per thread
  float* qs = smem;                 // (BQ, DP) scaled q
  float* ks = qs + kBQ * DP;        // (BK, DP)
  float* vs = ks + kBK * DP;        // (BK, D)
  float* ps = vs + kBK * D;         // (BQ, PP) scores, then p
  float* red_max = ps + kBQ * PP;   // (BQ, 4) partial row maxima
  float* red_sum = red_max + kBQ * 4;  // (BQ, 4) partial row sums
  float* m_s = red_sum + kBQ * 4;   // (BQ,) running max
  float* l_s = m_s + kBQ;           // (BQ,) running sum
  float* a_s = l_s + kBQ;           // (BQ,) this tile's rescale

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s_len = p.s;
  const int hk = h / (p.hq / p.hkv);
  const long long q_base = (static_cast<long long>(b) * p.hq + h) * s_len * D;
  const long long kv_base =
      (static_cast<long long>(b) * p.hkv + hk) * s_len * D;
  const T* q = static_cast<const T*>(p.q) + q_base;
  const T* k = static_cast<const T*>(p.k) + kv_base;
  const T* v = static_cast<const T*>(p.v) + kv_base;
  T* o = static_cast<T*>(p.o) + q_base;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    qs[r * DP + c] =
        row < s_len ? to_f32(q[static_cast<long long>(row) * D + c]) * p.scale
                    : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  // Kv tiles the block-level bound leaves: causal stops after the tile's
  // last row, a window starts at its first row's earliest visible column.
  int k_end = s_len;
  if (p.causal) k_end = min(s_len, q0 + kBQ);
  int k_beg = 0;
  if (p.window > 0) k_beg = max(0, q0 - p.window + 1);
  k_beg = (k_beg / kBK) * kBK;
  __syncthreads();

  for (int k0 = k_beg; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int col = k0 + r;
      const bool in = col < s_len;
      const long long off = static_cast<long long>(col) * D + c;
      ks[r * DP + c] = in ? to_f32(k[off]) : 0.f;
      vs[r * D + c] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // Scores of rows ty + 16i against columns tx + 16j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qa[i] * kb[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int row = q0 + r, col = k0 + c;
        float s = sc[i][j];
        if (p.cap > 0.f) s = p.cap * tanhf(s / p.cap);
        bool keep = col < s_len;
        if (p.causal) keep = keep && col <= row;
        if (p.window > 0) keep = keep && col > row - p.window;
        ps[r * PP + c] = keep ? s : kNeg;
      }
    }
    __syncthreads();

    // Online softmax: four threads a row, sixteen columns each.
    const int r = tid / 4, part = tid % 4;
    float mx = kNeg;
    for (int c = part * 16; c < part * 16 + 16; ++c)
      mx = fmaxf(mx, ps[r * PP + c]);
    red_max[r * 4 + part] = mx;
    __syncthreads();
    const float m_prev = m_s[r];
    const float m_new =
        fmaxf(m_prev, fmaxf(fmaxf(red_max[r * 4], red_max[r * 4 + 1]),
                            fmaxf(red_max[r * 4 + 2], red_max[r * 4 + 3])));
    float sum = 0.f;
    for (int c = part * 16; c < part * 16 + 16; ++c) {
      const float s = ps[r * PP + c];
      const float e = s == kNeg ? 0.f : expf(s - m_new);
      ps[r * PP + c] = e;
      sum += e;
    }
    red_sum[r * 4 + part] = sum;
    __syncthreads();
    if (part == 0) {
      const float alpha = expf(m_prev - m_new);
      l_s[r] = alpha * l_s[r] + ((red_sum[r * 4] + red_sum[r * 4 + 1]) +
                                 (red_sum[r * 4 + 2] + red_sum[r * 4 + 3]));
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ v for rows ty + 16i, columns tx + 16j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pr[i] * vv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= s_len) continue;
    const float l = l_s[r];
    const float denom = l > 0.f ? l : 1.f;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      store(o + static_cast<long long>(row) * D + tx + 16 * j,
            acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + kBQ - 1) / kBQ, p.hq, b);
  fa_fwd<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(p, b, stream);
    case 128: return launch<T, 128>(p, b, stream);
    case 256: return launch<T, 256>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 storage: the tensor-core body.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;      // q rows per CTA: two consumer warpgroups
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 128 : 64;  // kv rows per tile
  static constexpr int STAGES = D <= 128 ? 3 : 2;  // K/V ring depth
  static constexpr int CH = D / 64;  // 64-column (128-byte) chunks a row
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: the (64 x rows x 1) box at (c0, c1, c2) of a 3-d tensor map into
// shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. Addresses,
// leading and stride byte offsets are in bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x on the special-function unit (denormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads or reuses of registers that an
// asynchronous wgmma owns across its wait.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S += A·B, A (64 x 16) and B (64 x 16) both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S += A·B, A (64 x 16) and B (128 x 16) both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A·B, A (64 x 16) from registers, B (16 x 64) MN-major in shared
// memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A·B, A (64 x 16) from registers, B (16 x 128) MN-major in shared
// memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A·B, A (64 x 16) from registers, B (16 x 256) MN-major in shared
// memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Split two float32 values into bf16 hi and lo halves: x ~= hi + lo with
// about 16 bits of mantissa.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_tc(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, Params p) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  constexpr int CH = C::CH;
  constexpr int NS = BK / 2;   // score accumulators a thread (m64nBK)
  constexpr int NO = D / 2;    // output accumulators a thread (m64nD)
  constexpr int KS = BK / 16;  // k-steps of P·V
  constexpr int kStages = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full;
  __shared__ uint64_t k_full[kStages];
  __shared__ uint64_t v_full[kStages];
  __shared__ uint64_t kv_empty[kStages];
  // Tiles are 1024-byte aligned: the 128-byte swizzle repeats every 8 rows.
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;  // CH chunks of (128 rows x 128 B)
  uint8_t* ks = qs + C::Q_BYTES;  // kStages x CH chunks of (BK x 128 B)
  uint8_t* vs = ks + kStages * C::KV_BYTES;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest q tiles first
  const int q0 = qt * kBQ;
  const int hk = h / (p.hq / p.hkv);
  int k_end = p.s;
  if (p.causal) k_end = min(p.s, q0 + kBQ);
  int k_beg = 0;
  if (p.window > 0) k_beg = max(0, q0 - p.window + 1);
  k_beg = (k_beg / BK) * BK;
  const int n_tiles = (k_end - k_beg + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    // It gives up registers so that each consumer thread can hold 240
    // (24 x 128 + 240 x 256 fits the SM's 65536).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      const int bh_q = b * p.hq + h;
      const int bh_kv = b * p.hkv + hk;
      mbar_expect_tx(&q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        tma_load(qs + c * kBQ * 128, &tq, &q_full, 64 * c, q0, bh_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&kv_empty[s], ((it / kStages) & 1) ^ 1);
        const int k0 = k_beg + it * BK;
        uint8_t* kd = ks + s * C::KV_BYTES;
        uint8_t* vd = vs + s * C::KV_BYTES;
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load(kd + c * BK * 128, &tk, &k_full[s], 64 * c, k0, bh_kv);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load(vd + c * BK * 128, &tv, &v_full[s], 64 * c, k0, bh_kv);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    // Tile j+1's S = Q·Kᵀ and tile j's O += P·V go to the tensor cores as
    // one batch; while this warpgroup runs the softmax the other one's
    // batch keeps the tensor cores busy. (Waiting for S alone with
    // wait_group 1, to run the softmax under this warpgroup's own P·V,
    // makes ptxas serialize every wgmma: warning C7514.) Tiles that the
    // masks empty for this warpgroup's rows run with every score at NEG
    // (p = 0, the rescale 1).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int t = tid % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int wg_row0 = q0 + 64 * wg;
    const int row_lo = wg_row0 + 16 * (t / 32) + lane / 4;  // accumulators
    const int row_hi = row_lo + 8;                          // 0,1 and 2,3
    uint8_t* q_wg = qs + wg * 64 * 128;

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;
    float sc[NS];
    uint32_t ph[KS][4], pl[KS][4];

    // S = Q·Kᵀ for the tile in stage s (asynchronous; committed).
    auto issue_s = [&](int s) {
      const uint8_t* kt = ks + s * C::KV_BYTES;
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const int c = kc / 4, off = (kc % 4) * 32;
        wgmma_ss(sc, smem_desc(q_wg + c * kBQ * 128 + off, 16, 1024),
                 smem_desc(kt + c * BK * 128 + off, 16, 1024), kc > 0);
      }
      wg_commit();
    };
    // Softcap the scores of the tile at k0, mask them (only where the tile
    // straddles an edge), update m and l, turn the scores into p; returns
    // the rescale of O in a_lo, a_hi. Without a softcap the raw scores are
    // kept (scale > 0 keeps their order) and scale enters the exponent's
    // FMA.
    const float pre = p.cap > 0.f ? p.scale / p.cap : 0.f;
    const float c = (p.cap > 0.f ? 1.f : p.scale) * kLog2e;
    auto softmax = [&](int k0, float& a_lo, float& a_hi) {
      const bool edge = k0 + BK > p.s ||
                        (p.causal && k0 + BK - 1 > wg_row0) ||
                        (p.window > 0 && k0 <= wg_row0 + 63 - p.window);
      if (p.cap > 0.f) {
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] = p.cap * tanhf(sc[i] * pre);
      }
      if (edge) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
          const int row = (i & 2) ? row_hi : row_lo;
          bool keep = col < p.s;
          if (p.causal) keep = keep && col <= row;
          if (p.window > 0) keep = keep && col > row - p.window;
          sc[i] = keep ? sc[i] : kNeg;
        }
      }
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (i & 2) mx_hi = fmaxf(mx_hi, sc[i]);
        else mx_lo = fmaxf(mx_lo, sc[i]);
      }
      mx_lo = quad_max(mx_lo);
      mx_hi = quad_max(mx_hi);
      a_lo = ex2((m_lo - mx_lo) * c);
      a_hi = ex2((m_hi - mx_hi) * c);
      m_lo = mx_lo;
      m_hi = mx_hi;
      const float ms_lo = mx_lo * c, ms_hi = mx_hi * c;
      float sum_lo = 0.f, sum_hi = 0.f;
      if (edge) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const float x = sc[i];
          const float e =
              x == kNeg ? 0.f : ex2(fmaf(x, c, (i & 2) ? -ms_hi : -ms_lo));
          sc[i] = e;
          if (i & 2) sum_hi += e;
          else sum_lo += e;
        }
      } else {  // no score is NEG
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const float e = ex2(fmaf(sc[i], c, (i & 2) ? -ms_hi : -ms_lo));
          sc[i] = e;
          if (i & 2) sum_hi += e;
          else sum_lo += e;
        }
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
    };
    // P as the A operand: k-step kk covers score accumulators 8kk..8kk+7,
    // which are exactly its four A registers; hi and lo halves.
    auto split_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], ph[kk][j],
                     pl[kk][j]);
    };

    mbar_wait(&q_full, 0);
    {
      mbar_wait(&k_full[0], 0);
      issue_s(0);
      wg_wait0();
      hold(sc);
      float a_lo, a_hi;
      softmax(k_beg, a_lo, a_hi);  // O is still 0: no rescale
      split_p();
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const bool more = it + 1 < n_tiles;
      if (more) {
        const int s1 = (it + 1) % kStages;
        mbar_wait(&k_full[s1], ((it + 1) / kStages) & 1);
        issue_s(s1);
      }
      mbar_wait(&v_full[s], (it / kStages) & 1);
      {
        const uint8_t* vt = vs + s * C::KV_BYTES;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          // 16 kv rows from row 16kk; the next 64 columns sit BK rows on.
          const uint64_t dv = smem_desc(vt + kk * 16 * 128, BK * 128, 1024);
          wgmma_rs(o, ph[kk], dv);
          wgmma_rs(o, pl[kk], dv);
        }
        wg_commit();
      }
      wg_wait0();
      hold(sc);
      hold(o);
      hold(ph);
      hold(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[s]);
      if (more) {
        float a_lo, a_hi;
        softmax(k_beg + (it + 1) * BK, a_lo, a_hi);
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? a_hi : a_lo;
        split_p();
      }
    }

    // Epilogue: O / l rounded once to bf16, staged in this warpgroup's
    // own Q rows (the same 128-byte swizzle), then 16-byte row stores.
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    const float d_lo = l_lo > 0.f ? l_lo : 1.f;
    const float d_hi = l_hi > 0.f ? l_hi : 1.f;
    const int r_lo = row_lo - wg_row0, r_hi = row_hi - wg_row0;
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      const int col = 8 * i + 2 * quad;
      const int c = col / 64, g = (col % 64) / 8;
      uint8_t* chunk = q_wg + c * kBQ * 128;
      *reinterpret_cast<uint32_t*>(chunk + r_lo * 128 +
                                   ((g ^ (r_lo % 8)) * 16) + (col % 8) * 2) =
          pack_bf16(o[4 * i] / d_lo, o[4 * i + 1] / d_lo);
      *reinterpret_cast<uint32_t*>(chunk + r_hi * 128 +
                                   ((g ^ (r_hi % 8)) * 16) + (col % 8) * 2) =
          pack_bf16(o[4 * i + 2] / d_hi, o[4 * i + 3] / d_hi);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                         (static_cast<long long>(b) * p.hq + h) *
                             static_cast<long long>(p.s) * D;
    constexpr int VPR = D / 8;  // 16-byte pieces a row
    for (int u = t; u < 64 * VPR; u += 128) {
      const int r = u / VPR, v = u % VPR;
      const int row = wg_row0 + r;
      if (row >= p.s) continue;
      const int c = v / 8, g = v % 8;
      const uint4 val = *reinterpret_cast<const uint4*>(
          q_wg + c * kBQ * 128 + r * 128 + ((g ^ (r % 8)) * 16));
      *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * D +
                                8 * v) = val;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// the library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A bf16 (bh, s, d) tensor as a 3-d map with (64 x rows x 1) boxes,
// 128-byte swizzle, zeros past s.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int bh,
              int s, int d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  using C = Cfg<D>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, p.q, b * p.hq, p.s, D, kBQ) ||
      !make_map(enc, &tk, p.k, b * p.hkv, p.s, D, C::BK) ||
      !make_map(enc, &tv, p.v, b * p.hkv, p.s, D, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.hq, b, (p.s + kBQ - 1) / kBQ);
  fa_tc<D><<<grid, kThreads, C::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<64>(p, b, stream);
    case 128: return launch<128>(p, b, stream);
    case 256: return launch<256>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace

// dtype: 0 = float32 (SIMT body), 1 = bfloat16 (tensor-core body).
// window <= 0 and cap <= 0 mean none. The wrapper has checked shapes,
// types, contiguity, 16-byte aligned bases and d in {64, 128, 256};
// s >= 1 and b, hq, hkv >= 1 with hq % hkv == 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int s, int d, int dtype,
                                      int causal, int window, float cap,
                                      float scale, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p{q, k, v, o, hq, hkv, s, causal, window, cap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? tc::dispatch(p, b, d, st)
                                     : simt::dispatch<float>(p, b, d, st);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
