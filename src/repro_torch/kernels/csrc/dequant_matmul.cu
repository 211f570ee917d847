// W8A16 dequant × matmul against a dense uint8 weight.
//
// Replaces repro/kernels/dequant_matmul.py::dequant_matmul (the TPU Pallas
// kernel _kernel):
//
//   y[m, n] = s[n] · (Σ_k bf16(x[m, k]) · q[n, k] − z[n] · Σ_k bf16(x[m, k]))
//
// On the compressed main path it is the tied LM head of Llama-3.2 (a
// QuantLinear: 128 256 × 2048 uint8, 263 MB) at M = batch, every prefill
// and decode step.  There it is a GEMV over the weight, bound by memory
// bytes: the weight is read once, with 16-byte loads where K allows.
// Design: the same block layout and affine epilogue as the fused kernel
// (matmul_common.cuh); K is walked in 512-byte chunks and split over
// gridDim.z when N/128 × M/BM blocks would leave the card idle.  Ragged M,
// N and K are masked in the kernel, never padded in device memory.
#include "matmul_common.cuh"

namespace {

constexpr int kKC = 512;  // K chunk held in shared memory

template <int RPT, typename TOut>
__global__ void __launch_bounds__(qmoe::kThreads)
dequant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint8_t* __restrict__ wq,
                      const float* __restrict__ scale,
                      const float* __restrict__ zero, TOut* __restrict__ out,
                      float* __restrict__ part, float* __restrict__ sxpart,
                      int M, int N, int K, int chunks_per_split) {
  constexpr int BM = 2 * RPT;
  constexpr int qstride = kKC + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                                     // 128 × qstride
  float* xs = reinterpret_cast<float*>(smem + qmoe::kBN * qstride);  // BM × kKC
  float* sumx = xs + BM * kKC;                                   // BM

  const int tid = threadIdx.x;
  const int n = tid % qmoe::kBN, g = tid / qmoe::kBN;
  const int n0 = blockIdx.x * qmoe::kBN;
  const int m0 = blockIdx.y * BM;
  const int nkc = (K + kKC - 1) / kKC;
  const int c0 = blockIdx.z * chunks_per_split;
  const int c1 = min(c0 + chunks_per_split, nkc);
  const bool vec = (K & 15) == 0;

  if (tid < BM) sumx[tid] = 0.f;
  __syncthreads();
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int c = c0; c < c1; ++c) {
    const int k0 = c * kKC;
    const int kc = min(kKC, K - k0);
    const int kc4 = (kc + 3) & ~3;
    if (vec) {  // 16-byte loads; kc is a multiple of 16 here
      const int per_row = kc >> 4;
#pragma unroll 4
      for (int i = tid; i < qmoe::kBN * per_row; i += qmoe::kThreads) {
        int r = i / per_row, c16 = i - r * per_row;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + r < N)
          v = __ldg(reinterpret_cast<const uint4*>(
              wq + (long long)(n0 + r) * K + k0 + 16 * c16));
        uint32_t* dst = reinterpret_cast<uint32_t*>(qs + r * qstride + 16 * c16);
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      }
    } else {
      for (int i = tid; i < qmoe::kBN * kc4; i += qmoe::kThreads) {
        int r = i / kc4, cc = i - r * kc4;
        uint8_t v = 0;
        if (n0 + r < N && cc < kc) v = wq[(long long)(n0 + r) * K + k0 + cc];
        qs[r * qstride + cc] = v;
      }
    }
    qmoe::load_x_tile(x, M, K, m0, k0, kc, kc4, BM, kKC, xs);
    __syncthreads();
    qmoe::add_row_sums(xs, BM, kc4, kKC, sumx);
    qmoe::dot_chunk<RPT>(qs + n * qstride, xs, kKC, kc4, g, acc);
    __syncthreads();
  }
  qmoe::finish_block<RPT, TOut>(acc, sumx, scale, zero, out, part, sxpart,
                                M, N, m0, n0 + n, g, blockIdx.z);
}

template <int RPT, typename TOut>
int launch(const void* x, const void* wq, const void* scale,
           const void* zero, void* out, void* part, void* sxpart, int M,
           int N, int K, int splits, cudaStream_t stream) {
  constexpr int BM = 2 * RPT;
  size_t smem = (size_t)qmoe::kBN * (kKC + 4) +
                (size_t)BM * kKC * sizeof(float) + BM * sizeof(float);
  auto kern = dequant_matmul_kernel<RPT, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int nkc = (K + kKC - 1) / kKC;
  int chunks_per_split = (nkc + splits - 1) / splits;
  dim3 grid((N + qmoe::kBN - 1) / qmoe::kBN, (M + BM - 1) / BM, splits);
  kern<<<grid, qmoe::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<TOut*>(out),
      splits > 1 ? static_cast<float*>(part) : nullptr,
      static_cast<float*>(sxpart), M, N, K, chunks_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return qmoe::launch_splitk_epilogue(
      static_cast<const float*>(part), static_cast<const float*>(sxpart),
      static_cast<const float*>(scale), static_cast<const float*>(zero), out,
      sizeof(TOut) == 2, M, N, splits, stream);
}

}  // namespace

// C entry point, bound with ctypes.  Returns the CUDA error code (0 = ok).
extern "C" int qmoe_dequant_matmul(const void* x, const void* wq,
                                   const void* scale, const void* zero,
                                   void* out, void* part, void* sxpart,
                                   int out_bf16, int M, int N, int K,
                                   int splits, int rpt, int device,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // This library links its own CUDA runtime: select the tensors' device.
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
#define QMOE_ARGS x, wq, scale, zero, out, part, sxpart, M, N, K, splits, s
  if (rpt == 2)
    return out_bf16 ? launch<2, __nv_bfloat16>(QMOE_ARGS)
                    : launch<2, float>(QMOE_ARGS);
  if (rpt == 8)
    return out_bf16 ? launch<8, __nv_bfloat16>(QMOE_ARGS)
                    : launch<8, float>(QMOE_ARGS);
#undef QMOE_ARGS
  return (int)cudaErrorInvalidValue;
}
