// Blockwise (flash) attention forward on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel): causal, sliding-window and softcapped GQA attention over
// q (B, Hq, S, D) and k, v (B, Hkv, S, D), online softmax in float32,
// output in q's type. Storage is bf16 or f32; every product and sum is
// float32.
//
// Bound on this card: operations at prefill lengths (4·S²·D/2 FLOP per
// head under the causal mask against 2·S·D·2 bytes per head read and
// written), bytes only for short sequences.
//
// Design. The TPU kernel walked a (B, Hq, q-block, kv-block) grid whose kv
// axis ran in order on one core, carrying (m, l, acc) in VMEM. Here one
// CTA owns one (b, q-head, 64-row q tile) and walks its kv tiles in a loop,
// so the carry never leaves the block: m and l per row in shared memory,
// the (64, D) accumulator in registers (4 rows x D/16 columns a thread).
// The KV head is h / group, read in place, never replicated. The q tile is
// scaled in float32 once as it is staged; each 64-row K/V tile is staged
// in shared memory as float32 (K rows padded by one word so the score
// loop reads without bank conflicts). Kv tiles that the causal or window
// bound masks entirely are never visited; the ragged tail (S not a
// multiple of 64) is masked, never assumed away. Both products run in the
// block's own SIMT loops (no library call, no tensor cores yet).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16: tx picks columns, ty rows
constexpr float kNeg = -3e38f;  // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and cap <= 0 mean none.
// The wrapper has checked shapes, types, contiguity and d in {64, 128,
// 256}; s >= 1 and b, hq, hkv >= 1 with hq % hkv == 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int s, int d, int dtype,
                                      int causal, int window, float cap,
                                      float scale, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p{q, k, v, o, hq, hkv, s, causal, window, cap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(p, b, d, st)
                                     : dispatch<float>(p, b, d, st);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
