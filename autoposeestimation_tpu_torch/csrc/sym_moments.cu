// Symmetric ADD-S matched-distance moments, forward only, for sm_90a.
//
// Replaces autoposeestimation_tpu/ops/pallas_addloss.py::_moments_kernel
// (wrapper _moments_fwd). For each sample b and candidate pose c
// (rotation R, translation t) and each model point i:
//     pred_i = R m_i + t,   dmin_i = min_j ||pred_i - target_j||
// and per candidate the mean dis = sum_i dmin_i / M and the centered
// two-pass sample variance var = sum_i (dmin_i - dis)^2 / max(M - 1, 1).
//
// Bound: operations. B*N*M*M point pairs (2e9 at the evaluation shape
// 8 x 1000 x 500) against ~0.5 MB of inputs and outputs. The least work is
// the expansion form ||t||^2 - 2 p.t (3 FMA) plus a min per pair; this
// kernel uses the direct form (p - t)^2 (3 sub, 1 mul, 2 FMA, 1 min), which
// avoids the expansion's cancellation at small distances, and accepts
// ~1.75x the instructions. Design: one block per (sample, tile of
// candidates); the sample's targets and model points are staged once in
// shared memory as float4 and reused by every candidate of the tile; each
// thread keeps kPts predicted points in registers, so each broadcast
// shared-memory read of a target feeds kPts distance evaluations; dmin
// stays in shared memory for the second (centering) pass. Nothing but the
// (B, N) moments reaches device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kPts = 4;                  // model points per thread per pass
constexpr int kCandidatesPerBlock = 8;

// Sum over the block; every thread gets the result. Starts with a barrier,
// so callers may reuse `scratch` right after a previous call.
__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < (kThreads / 32) ? scratch[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) scratch[32] = s;
  }
  __syncthreads();
  return scratch[32];
}

__global__ void __launch_bounds__(kThreads)
sym_moments_kernel(const float* __restrict__ rot,     // (B, N, 3, 3)
                   const float* __restrict__ pred_t,  // (B, N, 3)
                   const float* __restrict__ model,   // (B, M, 3)
                   const float* __restrict__ target,  // (B, M, 3)
                   float* __restrict__ dis,           // (B, N)
                   float* __restrict__ var,           // (B, N)
                   int n, int m) {
  extern __shared__ float4 smem[];
  float4* tgt = smem;                                   // M
  float4* mdl = smem + m;                               // M
  float* dmin = reinterpret_cast<float*>(smem + 2 * m); // M
  __shared__ float scratch[33];

  const int b = blockIdx.y;
  const float* tb = target + static_cast<size_t>(b) * m * 3;
  const float* mb = model + static_cast<size_t>(b) * m * 3;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    tgt[j] = make_float4(tb[3 * j], tb[3 * j + 1], tb[3 * j + 2], 0.0f);
    mdl[j] = make_float4(mb[3 * j], mb[3 * j + 1], mb[3 * j + 2], 0.0f);
  }
  __syncthreads();

  const float inv_m = 1.0f / static_cast<float>(m);
  const float inv_m1 = 1.0f / static_cast<float>(m > 1 ? m - 1 : 1);
  const int c_begin = static_cast<int>(blockIdx.x) * kCandidatesPerBlock;
  const int c_end = min(n, c_begin + kCandidatesPerBlock);
  for (int c = c_begin; c < c_end; ++c) {
    const size_t bc = static_cast<size_t>(b) * n + c;
    const float* r = rot + bc * 9;
    const float r00 = r[0], r01 = r[1], r02 = r[2];
    const float r10 = r[3], r11 = r[4], r12 = r[5];
    const float r20 = r[6], r21 = r[7], r22 = r[8];
    const float tx = pred_t[bc * 3], ty = pred_t[bc * 3 + 1],
                tz = pred_t[bc * 3 + 2];

    float local = 0.0f;
    for (int base = 0; base < m; base += kThreads * kPts) {
      float px[kPts], py[kPts], pz[kPts], best[kPts];
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        const float4 p = i < m ? mdl[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        px[k] = fmaf(r00, p.x, fmaf(r01, p.y, fmaf(r02, p.z, tx)));
        py[k] = fmaf(r10, p.x, fmaf(r11, p.y, fmaf(r12, p.z, ty)));
        pz[k] = fmaf(r20, p.x, fmaf(r21, p.y, fmaf(r22, p.z, tz)));
        best[k] = INFINITY;
      }
      for (int j = 0; j < m; ++j) {
        const float4 t = tgt[j];
#pragma unroll
        for (int k = 0; k < kPts; ++k) {
          const float dx = px[k] - t.x, dy = py[k] - t.y, dz = pz[k] - t.z;
          best[k] = fminf(best[k], fmaf(dx, dx, fmaf(dy, dy, dz * dz)));
        }
      }
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        if (i < m) {
          const float d = sqrtf(fmaxf(best[k], 0.0f));
          dmin[i] = d;
          local += d;
        }
      }
    }
    // block_sum's leading barrier also publishes dmin to the second pass
    const float mean = block_sum(local, scratch) * inv_m;
    float sq = 0.0f;
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const float dd = dmin[i] - mean;
      sq = fmaf(dd, dd, sq);
    }
    const float total = block_sum(sq, scratch);
    if (threadIdx.x == 0) {
      dis[bc] = mean;
      var[bc] = total * inv_m1;
    }
    __syncthreads();  // dmin is rewritten by the next candidate
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch needs for `m` points.
size_t sym_moments_smem_bytes(int m) {
  return static_cast<size_t>(m) * (2 * sizeof(float4) + sizeof(float));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int sym_moments_fwd(const float* rot, const float* pred_t, const float* model,
                    const float* target, float* dis, float* var, int b, int n,
                    int m, void* stream) {
  const size_t smem = sym_moments_smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      sym_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kCandidatesPerBlock - 1) / kCandidatesPerBlock, b);
  sym_moments_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      rot, pred_t, model, target, dis, var, n, m);
  return static_cast<int>(cudaGetLastError());
}

const char* sym_moments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
