// Causal online-softmax attention (FlashAttention) with GQA.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the TPU
// Pallas kernel _kernel).  q (B, Hq, Tq, Dqk), k (B, Hkv, Tk, Dqk), v
// (B, Hkv, Tk, Dv) with any strides over B, H, T and the head dim
// contiguous; out (B, Hq, Tq, Dv) contiguous in q's dtype.  A q head h
// reads kv head h / (Hq / Hkv): the shared kv rows are never repeated in
// memory.  Math is f32 throughout, with the
// reference's NEG_INF = −1e30 running max start and max(l, 1e−30)
// denominator; query i sits at position q_offset + i and sees keys
// 0 … q_offset + i (all keys when not causal).
//
// What bounds it on the H100: at the prefill shapes of the main paths
// (Tq ≈ Tk ≈ 200; D = 64 for Llama-3.2-1B, Dqk/Dv = 192/128 for
// DeepSeek-V2-Lite's MLA) the work is small and latency-bound; at long
// prompts it is bound by operations.  Design: one thread per query row
// (LANES threads for MLA's wide rows, see below) keeps q and the output
// accumulator in registers; a block of 64 rows stages key/value tiles in
// shared memory (every row reads the same key row: a broadcast, no bank
// conflicts).  Scores are taken 16 keys at a
// time, so the running max and the rescale of the accumulator happen once
// per 16 keys.  Key tiles past the last query of the block are skipped
// (the causal block skip), and ragged Tq/Tk tails are masked in the
// kernel, so any prompt length and a cache longer than the prompt work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kSub = 16; // keys per online-softmax step
constexpr float kNegInf = -1e30f;

// Element i of a bf16 or f32 array.  The dtype is a runtime flag rather
// than a template parameter: loads sit outside the inner loops, and one
// instantiation per head-dim pair keeps the build short.
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

// DQK: the q/k head dim; DV: the v (and output) head dim.  LANES threads
// share one query row: each keeps every LANES-th element of the row's q and
// output accumulator (element d = i · LANES + part), the score's partial
// dot products are summed across the row's lanes by shuffles, and each lane
// updates its own accumulator elements.  LANES = 1 keeps a whole row in one
// thread (head dims 64 and 128); MLA's 192 + 128 values per row would not
// fit in one thread's registers, so it takes LANES = 2 (96 + 64 per
// thread, 254 registers, no spills; at the DeepSeek-V2-Lite prefill 4%
// faster than LANES = 4 on an H100 80GB HBM3 at 700 W, PERF.md).
template <int DQK, int DV, int LANES>
__global__ void __launch_bounds__(kBQ * LANES)
flash_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                       const void* __restrict__ v, void* __restrict__ out,
                       int q_bf16, int kv_bf16, int Hq, int Hkv, int Tq,
                       int Tk, long long qsb,
                       long long qsh, long long qst, long long ksb,
                       long long ksh, long long kst, long long vsb,
                       long long vsh, long long vst, float sm_scale,
                       int causal, int q_offset) {
  // 32 KiB of f32 keys + values, in whole steps of kSub keys
  constexpr int BKV = 8192 / (DQK + DV) / kSub * kSub;
  constexpr int QPL = DQK / LANES, VPL = DV / LANES;
  static_assert(BKV >= kSub && QPL * LANES == DQK && VPL * LANES == DV,
                "head dims must split evenly over the lanes");
  __shared__ float ks[BKV][DQK];
  __shared__ float vs[BKV][DV];

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int part = threadIdx.x % LANES;
  const int qi = q0 + threadIdx.x / LANES;
  const bool live = qi < Tq;
  const int qpos = q_offset + qi;
  // the lanes of one row: a group of LANES neighbours in the warp
  const unsigned gmask =
      (LANES == 32 ? 0xffffffffu : ((1u << LANES) - 1u))
      << ((threadIdx.x & 31) & ~(LANES - 1));
  // last key any row of this block may see
  const int last_key = causal ? min(Tk - 1, q_offset + min(q0 + kBQ, Tq) - 1)
                              : Tk - 1;

  float qr[QPL], acc[VPL];
  const long long qrow = b * qsb + h * qsh + (long long)(live ? qi : 0) * qst;
#pragma unroll
  for (int i = 0; i < QPL; ++i)
    qr[i] = live ? load(q, qrow + i * LANES + part, q_bf16) : 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const long long kbase = b * ksb + kvh * ksh;
  const long long vbase = b * vsb + kvh * vsh;
  for (int k0 = 0; k0 <= last_key; k0 += BKV) {
    const int nk = min(BKV, last_key + 1 - k0);
    for (int i = threadIdx.x; i < nk * DQK; i += kBQ * LANES) {
      int j = i / DQK, d = i - j * DQK;
      ks[j][d] = load(k, kbase + (long long)(k0 + j) * kst + d, kv_bf16);
      if (DQK == DV)
        vs[j][d] = load(v, vbase + (long long)(k0 + j) * vst + d, kv_bf16);
    }
    if (DQK != DV) {
      for (int i = threadIdx.x; i < nk * DV; i += kBQ * LANES) {
        int j = i / DV, d = i - j * DV;
        vs[j][d] = load(v, vbase + (long long)(k0 + j) * vst + d, kv_bf16);
      }
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
          for (int i = 0; i < QPL; ++i)
            dot = fmaf(qr[i], ks[j0 + u][i * LANES + part], dot);
#pragma unroll
          for (int o = 1; o < LANES; o <<= 1)
            dot += __shfl_xor_sync(gmask, dot, o);
          s[u] = dot * sm_scale;
          mt = fmaxf(mt, s[u]);
        }
      }
      float alpha = expf(m - mt);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        if (j0 + u < jmax) {
          float p = expf(s[u] - mt);
          l += p;
#pragma unroll
          for (int i = 0; i < VPL; ++i)
            acc[i] = fmaf(p, vs[j0 + u][i * LANES + part], acc[i]);
        }
      }
      m = mt;
    }
    __syncthreads();
  }
  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    const long long orow = ((long long)bh * Tq + qi) * DV;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      store(out, orow + i * LANES + part, q_bf16, acc[i] / denom);
  }
}

template <int DQK, int DV, int LANES>
int launch(const void* q, const void* k, const void* v, void* out, int q_bf16,
           int kv_bf16, int B, int Hq, int Hkv, int Tq, int Tk,
           const long long* qs, const long long* kstr, const long long* vstr,
           float sm_scale, int causal, int q_offset, cudaStream_t stream) {
  dim3 grid((Tq + kBQ - 1) / kBQ, B * Hq);
  flash_attention_kernel<DQK, DV, LANES><<<grid, kBQ * LANES, 0, stream>>>(
      q, k, v, out, q_bf16, kv_bf16, Hq, Hkv, Tq, Tk, qs[0], qs[1], qs[2],
      kstr[0], kstr[1], kstr[2], vstr[0], vstr[1], vstr[2], sm_scale, causal,
      q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Returns the CUDA error code (0 = ok).
// Strides are in elements, (batch, head, time) for each of q, k, v.  Head
// dims (Dqk, Dv): (64, 64), (128, 128) and MLA's (192, 128).
extern "C" int qmoe_flash_attention(
    const void* q, const void* k, const void* v, void* out, int q_bf16,
    int kv_bf16, int B, int Hq, int Hkv, int Tq, int Tk, int Dqk, int Dv,
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
#define QMOE_ARGS q, k, v, out, q_bf16, kv_bf16, B, Hq, Hkv, Tq, Tk, qs, \
                  kstr, vstr, sm_scale, causal, q_offset, s
  if (Dqk == 64 && Dv == 64) return launch<64, 64, 1>(QMOE_ARGS);
  if (Dqk == 128 && Dv == 128) return launch<128, 128, 1>(QMOE_ARGS);
  if (Dqk == 192 && Dv == 128) return launch<192, 128, 2>(QMOE_ARGS);
#undef QMOE_ARGS
  return (int)cudaErrorInvalidValue;
}
