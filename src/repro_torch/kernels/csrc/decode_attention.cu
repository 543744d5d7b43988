// Flash-decoding attention on Hopper (sm_90a): one new token per sequence
// against its KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention (_decode_kernel): q (B, Hq, D) attends over
// k/v caches (B, Hkv, S, D) up to each sequence's length (lengths (B,)
// i32, read from device memory, never by the host), with an optional
// sliding window and logit softcap and GQA. Online softmax in float32;
// output in q's type.
//
// Bound on this card: bytes. Every cache row up to the length is read once
// (2·D values a row for K and V) for 4·group·D FLOP a row, far below the
// card's operations-per-byte line: 0.0102 ms at the starcoder2-3b decode
// (q (8, 24, 128) against 4224-row bf16 caches).
//
// Two bodies behind one launch function:
//
// bf16 storage with D in {64, 128, 256} (the serving path): split-KV.
//   The grid is (Hkv x q-head tiles of 16, B, splits): the wrapper cuts the
//   cache into `splits` chunks of `chunk` rows (a multiple of 64) from the
//   host-known cache length S alone, aiming at about three CTAs per SM, so
//   a batch of 16 (sequence, KV head) pairs still fills the card. A CTA
//   (four warps) serves the 16 q heads of its tile that share the KV head
//   (zero padded past the group), so each cache row is read once per tile.
//   It streams its chunk in 64-row bf16 tiles through a two-stage cp.async
//   ring (16-byte pieces, XOR-swizzled rows, zeros outside the live rows);
//   warp w takes rows 16w..16w+15 of each tile. Scores are mma.sync
//   m16n8k16 (q heads x cache rows, bf16 operands, float32 accumulation,
//   exact products), then scale and softcap in float32, the mask, and the
//   online softmax in registers with quad shuffles. P·V keeps p in float32
//   through the hi/lo split (P_hi = bf16(p), P_lo = bf16(p - P_hi), two
//   mma.syncs into one float32 accumulator), as rounding p once to bf16
//   would miss the plain version's tolerance. The four warps' (m, l, acc)
//   merge in shared memory into one partial per (q head, split) in a
//   float32 scratch; a split that starts at or past the length, or ends
//   before the window, writes m = NEG, l = 0 and exits. A second kernel of
//   the same launch rescales the partials by exp(m_i - m) and divides by
//   l (l == 0 -> 1).
//
// float32 storage, or another head dim: the SIMT body `simt::decode_fwd`:
//   one CTA per (b, KV head), K/V staged as float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3e38f;  // the reference's mask value

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

// ---------------------------------------------------------------------------
// float32 storage or another head dim: the SIMT body.
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBK = 64;        // cache rows per block
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}


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

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 storage, D in {64, 128, 256}: split-KV with mma.sync.
// ---------------------------------------------------------------------------
namespace split {

constexpr int kThreads = 128;  // four warps
constexpr int kTile = 64;      // cache rows a ring stage
constexpr int kStages = 2;
constexpr int kHeads = 16;     // q heads a CTA: the mma's M
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int smem_bytes() {
  // K and V rings (reused to merge the warps), then q.
  return kStages * 2 * kTile * D * 2 + kHeads * D * 2;
}

struct Split {
  float* part_o;   // (B, Hq, splits, D) unnormalised accumulators
  float* part_ml;  // (B, Hq, splits, 2) running max and sum
  int splits, chunk, mtiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a·b, m16n8k16, bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

// Byte offset of 16-byte piece c of row r in a (rows x D) bf16 tile whose
// pieces are XOR-swizzled by r % 8 (conflict-free ldmatrix).
template <int D>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return r * D * 2 + ((c ^ (r % 8)) * 16);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_split(Params p, Split sp) {
  constexpr int VPR = D / 8;        // 16-byte pieces a row
  constexpr int TILE_BYTES = kTile * D * 2;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float m_w[4][kHeads];
  __shared__ float l_w[4][kHeads];
  uint8_t* k_ring = smem;
  uint8_t* v_ring = smem + kStages * TILE_BYTES;
  uint8_t* q_tile = v_ring + kStages * TILE_BYTES;  // (16, D)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, quad = lane % 4;
  const int group = p.hq / p.hkv;
  const int hk = blockIdx.x / sp.mtiles;
  const int mt = blockIdx.x % sp.mtiles;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int h0 = hk * group + mt * kHeads;
  const int nh = min(kHeads, group - mt * kHeads);
  const int length = p.lengths[b];
  const int end = min(length, p.s);
  // col > length - 1 - window  <=>  col >= length - window
  const int lo = p.window > 0 ? max(0, length - p.window) : 0;
  const int c_beg = split * sp.chunk;
  const int beg = max(c_beg, lo);
  const int stop = min(c_beg + sp.chunk, end);
  const long long part0 =
      (static_cast<long long>(b) * p.hq + h0) * sp.splits + split;
  if (beg >= stop) {
    if (tid < nh) {
      sp.part_ml[(part0 + static_cast<long long>(tid) * sp.splits) * 2] = kNeg;
      sp.part_ml[(part0 + static_cast<long long>(tid) * sp.splits) * 2 + 1] =
          0.f;
    }
    return;
  }
  const int t_beg = c_beg + ((beg - c_beg) / kTile) * kTile;
  const int n_tiles = (stop - t_beg + kTile - 1) / kTile;

  const long long kv_base =
      (static_cast<long long>(b) * p.hkv + hk) * static_cast<long long>(p.s) *
      D;
  const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(p.k) + kv_base;
  const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(p.v) + kv_base;

  auto load = [&](int i) {
    const int r0 = t_beg + i * kTile;
    const uint32_t kd = smem_u32(k_ring + (i % kStages) * TILE_BYTES);
    const uint32_t vd = smem_u32(v_ring + (i % kStages) * TILE_BYTES);
    for (int u = tid; u < kTile * VPR; u += kThreads) {
      const int r = u / VPR, c = u % VPR;
      const int pos = r0 + r;
      const bool live = pos >= beg && pos < stop;
      const long long off = live ? static_cast<long long>(pos) * D + c * 8 : 0;
      cp_async16(kd + tile_off<D>(r, c), kc + off, live);
      cp_async16(vd + tile_off<D>(r, c), vc + off, live);
    }
  };
  load(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // q (16 heads x D, zeros past the group's live heads) in shared memory,
  // read as the A operand by ldmatrix.
  {
    const uint4* q = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.q) +
        (static_cast<long long>(b) * p.hq + h0) * D);
    for (int u = tid; u < kHeads * VPR; u += kThreads) {
      const int r = u / VPR, c = u % VPR;
      *reinterpret_cast<uint4*>(q_tile + tile_off<D>(r, c)) =
          r < nh ? q[r * VPR + c] : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load(i + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int pos0 = t_beg + i * kTile + 16 * warp;
    if (pos0 < stop && pos0 + 16 > beg) {
      const uint8_t* kt = k_ring + (i % kStages) * TILE_BYTES;
      const uint8_t* vt = v_ring + (i % kStages) * TILE_BYTES;
      const int r0 = 16 * warp;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t qa[4], kb[4];
        ldsm_x4(smem_u32(q_tile + tile_off<D>(((lane / 8) % 2) * 8 + lane % 8,
                                              2 * ks + lane / 16)),
                qa);
        ldsm_x4(smem_u32(kt + tile_off<D>(r0 + (lane / 16) * 8 + lane % 8,
                                          2 * ks + (lane / 8) % 2)),
                kb);
        mma16816(sc[0], qa, kb[0], kb[1]);
        mma16816(sc[1], qa, kb[2], kb[3]);
      }
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * p.scale;
          if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
          const int col = pos0 + 8 * n + 2 * quad + (e & 1);
          x = col >= beg && col < stop ? x : kNeg;
          sc[n][e] = x;
          if (e & 2) mx_hi = fmaxf(mx_hi, x);
          else mx_lo = fmaxf(mx_lo, x);
        }
      mx_lo = quad_max(mx_lo);
      mx_hi = quad_max(mx_hi);
      const float a_lo = exp2f((m_lo - mx_lo) * kLog2e);
      const float a_hi = exp2f((m_hi - mx_hi) * kLog2e);
      m_lo = mx_lo;
      m_hi = mx_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[n][e];
          const float mx = (e & 2) ? mx_hi : mx_lo;
          const float pe = x == kNeg ? 0.f : exp2f((x - mx) * kLog2e);
          sc[n][e] = pe;
          if (e & 2) sum_hi += pe;
          else sum_lo += pe;
        }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
      uint32_t ph[4], pl[4];
      split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
      split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
      split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
      split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t vb[4];
        ldsm_x4_t(smem_u32(vt + tile_off<D>(r0 + ((lane / 8) % 2) * 8 +
                                                lane % 8,
                                            2 * j + lane / 16)),
                  vb);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[2 * j][e] *= (e & 2) ? a_hi : a_lo;
          o[2 * j + 1][e] *= (e & 2) ? a_hi : a_lo;
        }
        mma16816(o[2 * j], ph, vb[0], vb[1]);
        mma16816(o[2 * j], pl, vb[0], vb[1]);
        mma16816(o[2 * j + 1], ph, vb[2], vb[3]);
        mma16816(o[2 * j + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();
  }

  // Merge the four warps: m, l per (warp, q head), then the accumulators
  // rescaled to the CTA's max, summed through shared memory.
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  if (quad == 0) {
    m_w[warp][g] = m_lo;
    m_w[warp][g + 8] = m_hi;
    l_w[warp][g] = l_lo;
    l_w[warp][g + 8] = l_hi;
  }
  __syncthreads();
  float mc_lo = kNeg, mc_hi = kNeg;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    mc_lo = fmaxf(mc_lo, m_w[w][g]);
    mc_hi = fmaxf(mc_hi, m_w[w][g + 8]);
  }
  const float f_lo = exp2f((m_lo - mc_lo) * kLog2e);
  const float f_hi = exp2f((m_hi - mc_hi) * kLog2e);
  float* acc = reinterpret_cast<float*>(smem);  // (4 warps, 16 heads, D)
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * quad;
    float* lo_row = acc + (warp * kHeads + g) * D + col;
    float* hi_row = acc + (warp * kHeads + g + 8) * D + col;
    *reinterpret_cast<float2*>(lo_row) =
        make_float2(o[n][0] * f_lo, o[n][1] * f_lo);
    *reinterpret_cast<float2*>(hi_row) =
        make_float2(o[n][2] * f_hi, o[n][3] * f_hi);
  }
  __syncthreads();
  for (int u = tid; u < nh * D; u += kThreads) {
    const int r = u / D, c = u % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) sum += acc[(w * kHeads + r) * D + c];
    sp.part_o[(part0 + static_cast<long long>(r) * sp.splits) * D + c] = sum;
  }
  if (tid < nh) {
    float m = kNeg;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, m_w[w][tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      l += l_w[w][tid] * exp2f((m_w[w][tid] - m) * kLog2e);
    const long long i = (part0 + static_cast<long long>(tid) * sp.splits) * 2;
    sp.part_ml[i] = m;
    sp.part_ml[i + 1] = l;
  }
}

// out[b, h] = sum_i acc_i exp(m_i - m) / sum_i l_i exp(m_i - m), over the
// splits with l_i > 0; one CTA per (b, q head). The first warp turns the
// (m_i, l_i) into weights in shared memory, then every thread sums its
// columns' partials with independent loads.
__global__ void __launch_bounds__(kThreads)
    decode_combine(Params p, Split sp) {
  extern __shared__ float w[];  // (splits,) weights exp(m_i - m), or 0
  __shared__ float denom;
  const long long bh = blockIdx.x;
  const float* ml = sp.part_ml + bh * sp.splits * 2;
  const float* po = sp.part_o + bh * sp.splits * p.d;
  const int tid = threadIdx.x;
  if (tid < 32) {
    float m = kNeg;
    for (int i = tid; i < sp.splits; i += 32)
      if (ml[2 * i + 1] > 0.f) m = fmaxf(m, ml[2 * i]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int i = tid; i < sp.splits; i += 32) {
      const float wi = ml[2 * i + 1] > 0.f ? expf(ml[2 * i] - m) : 0.f;
      w[i] = wi;
      l += ml[2 * i + 1] * wi;
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (tid == 0) denom = l > 0.f ? l : 1.f;
  }
  __syncthreads();
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + bh * p.d;
  for (int c = tid; c < p.d; c += kThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < sp.splits; ++i)
      acc += w[i] == 0.f ? 0.f : po[static_cast<long long>(i) * p.d + c] * w[i];
    out[c] = __float2bfloat16(acc / denom);
  }
}

template <int D>
cudaError_t launch(const Params& p, const Split& sp, int b,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.hkv * sp.mtiles, b, sp.splits);
  decode_split<D><<<grid, kThreads, smem, stream>>>(p, sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<<<b * p.hq, kThreads, sp.splits * sizeof(float), stream>>>(
      p, sp);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, const Split& sp, int b,
                     cudaStream_t stream) {
  switch (p.d) {
    case 64: return launch<64>(p, sp, b, stream);
    case 128: return launch<128>(p, sp, b, stream);
    case 256: return launch<256>(p, sp, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace split
}  // namespace

// Shared memory the SIMT body needs, in bytes (the wrapper refuses a shape
// above the card's 227 KB a block; the split body needs at most 128 KB).
extern "C" int decode_attention_smem_bytes(int group, int d) {
  return simt::smem_floats(group, d) * static_cast<int>(sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and cap <= 0 mean none.
// splits > 0 selects the split body (bf16, d in {64, 128, 256}) with
// float32 scratch part_o (b * hq * splits * d) and part_ml
// (b * hq * splits * 2), `chunk` cache rows a split (a multiple of 64) and
// ceil(group / 16) q-head tiles a KV head; splits == 0 the SIMT body. The
// wrapper has checked shapes, types, contiguity, 16-byte alignment of the
// caches and d % (16 / element size) == 0.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       void* o, float* part_o, float* part_ml,
                                       int b, int hq, int hkv, int s, int d,
                                       int dtype, int window, float cap,
                                       float scale, int splits, int chunk,
                                       int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p{q, k, v, lengths, o, hq, hkv, s, d, window, cap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (splits > 0) {
    if (dtype != 1 || chunk <= 0 || chunk % split::kTile)
      return static_cast<int>(cudaErrorInvalidValue);
    const int group = hq / hkv;
    split::Split sp{part_o, part_ml, splits, chunk,
                    (group + split::kHeads - 1) / split::kHeads};
    err = split::dispatch(p, sp, b, st);
  } else {
    err = dtype == 1 ? simt::launch<__nv_bfloat16>(p, b, st)
                     : simt::launch<float>(p, b, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
