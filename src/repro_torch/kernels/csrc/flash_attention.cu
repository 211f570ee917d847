// Causal online-softmax attention (FlashAttention) with GQA.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the TPU
// Pallas kernel _kernel).  q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D) with any
// strides over B, H, T and D contiguous; out (B, Hq, Tq, D) contiguous in
// q's dtype.  A q head h reads kv head h / (Hq / Hkv): the shared kv rows
// are never repeated in memory.  Math is f32 throughout, with the
// reference's NEG_INF = −1e30 running max start and max(l, 1e−30)
// denominator; query i sits at position q_offset + i and sees keys
// 0 … q_offset + i (all keys when not causal).
//
// What bounds it on the H100: at the prefill shapes of the main path
// (Tq ≈ Tk ≈ 200, D = 64) the work is small and latency-bound; at long
// prompts it is bound by operations.  Design: one thread per query row
// keeps q and the output accumulator in registers; a block of 64 rows
// stages key/value tiles in shared memory (every thread reads the same
// key row: a broadcast, no bank conflicts).  Scores are taken 16 keys at a
// time, so the running max and the rescale of the accumulator happen once
// per 16 keys.  Key tiles past the last query of the block are skipped
// (the causal block skip), and ragged Tq/Tk tails are masked in the
// kernel, so any prompt length and a cache longer than the prompt work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows (threads) per block
constexpr int kSub = 16; // keys per online-softmax step
constexpr float kNegInf = -1e30f;

// Element i of a bf16 or f32 array.  The dtype is a runtime flag rather
// than a template parameter: loads sit outside the inner loops, and one
// instantiation per head_dim keeps the build short.
__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store(void* p, long long i, int bf16,
                                      float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

template <int D>
__global__ void __launch_bounds__(kBQ)
flash_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                       const void* __restrict__ v, void* __restrict__ out,
                       int q_bf16, int kv_bf16, int Hq, int Hkv, int Tq,
                       int Tk, long long qsb,
                       long long qsh, long long qst, long long ksb,
                       long long ksh, long long kst, long long vsb,
                       long long vsh, long long vst, float sm_scale,
                       int causal, int q_offset) {
  constexpr int BKV = 4096 / D;  // 32 KiB of f32 keys + values
  __shared__ float ks[BKV][D];
  __shared__ float vs[BKV][D];

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + threadIdx.x;
  const bool live = qi < Tq;
  const int qpos = q_offset + qi;
  // last key any row of this block may see
  const int last_key = causal ? min(Tk - 1, q_offset + min(q0 + kBQ, Tq) - 1)
                              : Tk - 1;

  float qr[D], acc[D];
  const long long qrow = b * qsb + h * qsh + (long long)(live ? qi : 0) * qst;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? load(q, qrow + d, q_bf16) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const long long kbase = b * ksb + kvh * ksh;
  const long long vbase = b * vsb + kvh * vsh;
  for (int k0 = 0; k0 <= last_key; k0 += BKV) {
    const int nk = min(BKV, last_key + 1 - k0);
    for (int i = threadIdx.x; i < nk * D; i += kBQ) {
      int j = i / D, d = i - j * D;
      ks[j][d] = load(k, kbase + (long long)(k0 + j) * kst + d, kv_bf16);
      vs[j][d] = load(v, vbase + (long long)(k0 + j) * vst + d, kv_bf16);
    }
    __syncthreads();
    // keys this row sees in the tile: [0, jmax)
    int jmax = nk;
    if (causal) jmax = min(jmax, qpos - k0 + 1);
    if (!live) jmax = 0;
    for (int j0 = 0; j0 < jmax; j0 += kSub) {
      float s[kSub];
      float mt = m;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        s[u] = kNegInf;
        if (j0 + u < jmax) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j0 + u][d], dot);
          s[u] = dot * sm_scale;
          mt = fmaxf(mt, s[u]);
        }
      }
      float alpha = expf(m - mt);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        if (j0 + u < jmax) {
          float p = expf(s[u] - mt);
          l += p;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j0 + u][d], acc[d]);
        }
      }
      m = mt;
    }
    __syncthreads();
  }
  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    const long long orow = ((long long)bh * Tq + qi) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) store(out, orow + d, q_bf16, acc[d] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int q_bf16,
           int kv_bf16, int B, int Hq, int Hkv, int Tq, int Tk,
           const long long* qs, const long long* kstr, const long long* vstr,
           float sm_scale, int causal, int q_offset, cudaStream_t stream) {
  dim3 grid((Tq + kBQ - 1) / kBQ, B * Hq);
  flash_attention_kernel<D><<<grid, kBQ, 0, stream>>>(
      q, k, v, out, q_bf16, kv_bf16, Hq, Hkv, Tq, Tk, qs[0], qs[1], qs[2],
      kstr[0], kstr[1], kstr[2], vstr[0], vstr[1], vstr[2], sm_scale, causal,
      q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Returns the CUDA error code (0 = ok).
// Strides are in elements, (batch, head, time) for each of q, k, v.
extern "C" int qmoe_flash_attention(
    const void* q, const void* k, const void* v, void* out, int q_bf16,
    int kv_bf16, int B, int Hq, int Hkv, int Tq, int Tk, int D,
    long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, float sm_scale, int causal, int q_offset, int device,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // This library links its own CUDA runtime: select the tensors' device.
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long qs[3] = {qsb, qsh, qst};
  const long long kstr[3] = {ksb, ksh, kst};
  const long long vstr[3] = {vsb, vsh, vst};
  if (D == 64)
    return launch<64>(q, k, v, out, q_bf16, kv_bf16, B, Hq, Hkv, Tq, Tk, qs,
                      kstr, vstr, sm_scale, causal, q_offset, s);
  if (D == 128)
    return launch<128>(q, k, v, out, q_bf16, kv_bf16, B, Hq, Hkv, Tq, Tk, qs,
                       kstr, vstr, sm_scale, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
