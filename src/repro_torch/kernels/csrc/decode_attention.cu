// Flash-decoding attention on Hopper (sm_90a): one new token per sequence
// against its KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention (_decode_kernel): q (B, Hq, D) attends over
// k/v caches (B, Hkv, S, D) up to each sequence's length (lengths (B,)
// i32, read from device memory), with an optional sliding window and
// logit softcap and GQA. Online softmax in float32; output in q's type.
//
// Bound on this card: bytes. Every cache row up to the length is read once
// (2·D values a row for K and V) for 4·group·D FLOP a row, far below the
// card's operations-per-byte line.
//
// Design. The TPU kernel ran a (B, Hq, kv-block) grid, one q head per grid
// row, so each cache block was read once per q head. Here one CTA owns one
// (b, KV head) and serves all `group` q heads that share it: each 64-row
// K/V block is read from device memory once, with 16-byte vector loads,
// staged in shared memory as float32, and every q head's scores, softmax
// update and p·V run against the staged copy. The carry (m, l and the
// (group, D) accumulator) lives in shared memory, each entry updated by
// the one thread that owns it. The length comes from device memory, so the
// host never reads it; blocks at or past the length, or wholly before the
// window, are never visited, and the last partial block is masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;        // cache rows per block
constexpr int kThreads = 256;
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
  const int* lengths;
  void* o;
  int hq, hkv, s, d;
  int window;   // <= 0: no window
  float cap;    // <= 0: no softcap
  float scale;
};

int smem_floats(int group, int d) {
  return group * d            // qs
         + kBK * (d + 1)      // ks
         + kBK * d            // vs
         + group * kBK        // ps
         + group * d          // acc
         + 3 * group;         // m, l, alpha
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_fwd(Params p) {
  extern __shared__ float smem[];
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte load
  const int d = p.d;
  const int dp = d + 1;
  const int group = p.hq / p.hkv;
  float* qs = smem;                  // (group, d) scaled q
  float* ks = qs + group * d;        // (BK, dp)
  float* vs = ks + kBK * dp;         // (BK, d)
  float* ps = vs + kBK * d;          // (group, BK) scores, then p
  float* acc = ps + group * kBK;     // (group, d)
  float* m_s = acc + group * d;      // (group,)
  float* l_s = m_s + group;          // (group,)
  float* a_s = l_s + group;          // (group,)

  const int tid = threadIdx.x;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int s_len = p.s;
  const int length = p.lengths[b];
  const int end = min(length, s_len);
  // col > length - 1 - window  <=>  col >= length - window
  const int lo = p.window > 0 ? max(0, length - p.window) : 0;

  const long long q_base =
      (static_cast<long long>(b) * p.hq + static_cast<long long>(hk) * group) *
      d;
  const long long kv_base =
      (static_cast<long long>(b) * p.hkv + hk) * static_cast<long long>(s_len) *
      d;
  const T* q = static_cast<const T*>(p.q) + q_base;
  const uint4* k = reinterpret_cast<const uint4*>(static_cast<const T*>(p.k) +
                                                  kv_base);
  const uint4* v = reinterpret_cast<const uint4*>(static_cast<const T*>(p.v) +
                                                  kv_base);
  T* o = static_cast<T*>(p.o) + q_base;

  for (int i = tid; i < group * d; i += kThreads) {
    qs[i] = to_f32(q[i]) * p.scale;
    acc[i] = 0.f;
  }
  if (tid < group) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int vec_per_row = d / kVec;
  for (int k0 = (lo / kBK) * kBK; k0 < end; k0 += kBK) {
    const int rows = min(kBK, s_len - k0);
    for (int i = tid; i < rows * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row, c = (i % vec_per_row) * kVec;
      const long long off = static_cast<long long>(k0 + r) * vec_per_row +
                            i % vec_per_row;
      alignas(16) T kv[kVec];
      alignas(16) T vv[kVec];
      *reinterpret_cast<uint4*>(kv) = k[off];
      *reinterpret_cast<uint4*>(vv) = v[off];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ks[r * dp + c + e] = to_f32(kv[e]);
        vs[r * d + c + e] = to_f32(vv[e]);
      }
    }
    __syncthreads();

    for (int i = tid; i < group * kBK; i += kThreads) {
      const int g = i / kBK, j = i % kBK;
      const int col = k0 + j;
      bool keep = j < rows && col < length;
      if (p.window > 0) keep = keep && col >= lo;
      float s = 0.f;
      if (keep) {
        const float* qg = qs + g * d;
        const float* kr = ks + j * dp;
        for (int e = 0; e < d; ++e) s += qg[e] * kr[e];
        if (p.cap > 0.f) s = p.cap * tanhf(s / p.cap);
      }
      ps[i] = keep ? s : kNeg;
    }
    __syncthreads();

    if (tid < group) {
      float* row = ps + tid * kBK;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int j = 0; j < kBK; ++j) m_new = fmaxf(m_new, row[j]);
      float sum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float e = row[j] == kNeg ? 0.f : expf(row[j] - m_new);
        row[j] = e;
        sum += e;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = alpha * l_s[tid] + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

    // Rows at or past the length carry p = 0 and are left out of p @ v.
    const int live = min(rows, end - k0);
    for (int i = tid; i < group * d; i += kThreads) {
      const int g = i / d, c = i % d;
      const float* pg = ps + g * kBK;
      float a = acc[i] * a_s[g];
      for (int j = 0; j < live; ++j) a += pg[j] * vs[j * d + c];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < group * d; i += kThreads) {
    const float l = l_s[i / d];
    store(o + i, acc[i] / (l > 0.f ? l : 1.f));
  }
}

template <typename T>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  const int smem =
      smem_floats(p.hq / p.hkv, p.d) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.hkv, b);
  decode_fwd<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper refuses a shape
// above the card's 227 KB a block).
extern "C" int decode_attention_smem_bytes(int group, int d) {
  return smem_floats(group, d) * static_cast<int>(sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and cap <= 0 mean none.
// The wrapper has checked shapes, types, contiguity, 16-byte alignment of
// the caches and d % (16 / element size) == 0.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       void* o, int b, int hq, int hkv, int s,
                                       int d, int dtype, int window, float cap,
                                       float scale, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p{q, k, v, lengths, o, hq, hkv, s, d, window, cap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch<__nv_bfloat16>(p, b, st)
                                     : launch<float>(p, b, st);
  return static_cast<int>(err);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
