// 1-nearest neighbour over a masked reference set, for sm_90a.
//
// Replaces autoposeestimation_tpu/ops/knn.py::_nn_kernel (wrapper
// nn_pallas). For each query q_i and the valid references r_j:
//     d2_ij = (|q_i|^2 + |r_j|^2) - 2 q_i.r_j
//     idx_i = the first j of the minimum of d2_ij,  out_i = max(min_j d2_ij, 0)
// with |v|^2 = (x x + y y) + z z (each product rounded), q.r =
// fma(qz, rz, fma(qy, ry, qx rx)) and no other contraction: the same
// roundings as the plain version (ops/knn.py::nn_plain), so that both pick
// the same neighbour, near-ties included. An invalid reference has |r|^2 =
// +inf and never wins; with none valid the result is index 0, d2 = +inf.
//
// Bound: operations. N*M pairs of 3 FMA-class instructions plus a compare
// against 20 bytes per query and 13 per reference. Design (a simple first
// kernel): one thread per query and one warp per block, so N = 4096
// queries already spread over 128 SMs; the block stages the references in
// tiles of kTile through shared memory as float4 (x, y, z, |r|^2), |r|^2
// computed once per staged reference and set to +inf where invalid; every
// thread reads each staged reference as a broadcast and keeps its running
// (min, argmin) in registers, strict < in reference order, so the first
// index wins. Nothing but (idx, d2) reaches device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;
constexpr int kTile = 2048;  // references per shared tile: 32 KB

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ query,          // (N, 3)
          const float* __restrict__ ref,            // (M, 3)
          const unsigned char* __restrict__ valid,  // (M,) or null
          int* __restrict__ out_idx,                // (N,)
          float* __restrict__ out_d2,               // (N,)
          int n, int m) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (i < n) {
    qx = query[3 * i];
    qy = query[3 * i + 1];
    qz = query[3 * i + 2];
  }
  const float qq = sq_norm(qx, qy, qz);
  float best = INFINITY;
  int best_j = 0;
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < count; k += kThreads) {
      const int j = base + k;
      const float x = ref[3 * j], y = ref[3 * j + 1], z = ref[3 * j + 2];
      const bool ok = valid == nullptr || valid[j] != 0;
      tile[k] = make_float4(x, y, z, ok ? sq_norm(x, y, z) : INFINITY);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < count; ++k) {
      const float4 r = tile[k];
      const float qr = __fmaf_rn(qz, r.z, __fmaf_rn(qy, r.y,
                                                    __fmul_rn(qx, r.x)));
      const float d2 = __fsub_rn(__fadd_rn(qq, r.w), __fmul_rn(2.0f, qr));
      if (d2 < best) {
        best = d2;
        best_j = base + k;
      }
    }
  }
  if (i < n) {
    out_idx[i] = best_j;
    out_d2[i] = fmaxf(best, 0.0f);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int nn_search(const float* query, const float* ref, const unsigned char* valid,
              int* out_idx, float* out_d2, int n, int m, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  nn_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, ref, valid, out_idx, out_d2, n, m);
  return static_cast<int>(cudaGetLastError());
}

const char* nn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
