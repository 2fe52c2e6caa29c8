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
// 8 x 1000 x 500) against ~0.5 MB of inputs and outputs; the least work is
// the expansion form's 3 FMA and a min a pair, 4 FP32 lane instructions
// (0.239 ms on an H100 at 1980 MHz). The direct form (p - t)^2 costs 7.
//
// Design: the expansion form's instructions with the direct form's
// accuracy at small distances.
//  * Centred frame. A shift moves no distance, so the block of candidate c
//    works relative to the candidate's own translation t: p_i = R m_i and
//    q_j = target_j - t, each rounded once. |p|^2 and |q|^2 are then of
//    the order of the object's radius squared, not of the camera depth's
//    (0.36 m^2 at 0.6 m), and so is the rounding of the scan below.
//  * Expansion scan with a group minimum. Targets are staged as float4
//    (-2q, |q|^2); per pair the scan computes s_j = p.(-2q_j) + |q_j|^2
//    (= |p - q_j|^2 - |p|^2) in 3 FFMA and folds each group of kGroup
//    targets with fminf. Per point and group, selects keep the least group
//    value and the first group that reached it (strict <: the group of the
//    first target at the minimum), so the scan branches on nothing but its
//    own end; |p|^2 is never needed. Targets are padded to a multiple of
//    kGroup with members whose s is +inf (-2q = 0, |q|^2 = +inf).
//  * Direct-form recompute in the winning group. After the scan each point
//    computes (p - q_j)^2 in direct form over the real targets of its
//    group (q_j = -0.5 (-2q_j), exact) and keeps the least. Wherever that
//    group holds the nearest target, the value is the direct form's; a
//    wrong pick needs two targets in different groups whose d2 differ by
//    less than the centred scan's rounding (~1e-9 m^2 at 0.1 m from the
//    candidate), and then costs less than that difference. Lane l visits
//    the group's members from (u + l) mod kGroup on, so the lanes of a
//    quarter warp read distinct banks. With no finite s (overflowing
//    inputs) the winning group stays 0.
//  * One block of kThreads threads per (candidate, sample): grid (N, B),
//    8,000 blocks at the evaluation shape, handed to SMs as they free up,
//    so no candidates run in series and the last wave is short. Thread
//    tid holds the points i = base + k kThreads + tid (k < kPts) in
//    registers, and each staged target is one broadcast float4 that feeds
//    kPts independent chains. dmin stays in shared memory for the mean and
//    the centred second pass.
// The compiled scan loop runs 4.44 instructions a pair (56 registers, 9
// blocks per SM). On an H100, kPts 8 at 64 threads, kGroup 32, and a
// register cap for 10 or 12 blocks per SM were each as fast or slower.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPts = 4;                  // model points per thread per pass
constexpr int kGroup = 16;               // targets per group minimum

// Targets staged for `m`: padded to a multiple of kGroup.
__host__ __device__ inline int padded_targets(int m) {
  return (m + kGroup - 1) / kGroup * kGroup;
}

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
    float s = lane < kWarps ? scratch[lane] : 0.0f;
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
  const int m_pad = padded_targets(m);
  float4* tgt = smem;                                       // m_pad
  float* dmin = reinterpret_cast<float*>(smem + m_pad);     // M
  __shared__ float scratch[33];

  const int b = blockIdx.y;
  const size_t bc = static_cast<size_t>(b) * n + blockIdx.x;
  const float tx = pred_t[bc * 3], ty = pred_t[bc * 3 + 1],
              tz = pred_t[bc * 3 + 2];
  // the targets in the candidate's frame: (-2q, |q|^2), q = target - t
  const float* tb = target + static_cast<size_t>(b) * m * 3;
  for (int j = threadIdx.x; j < m_pad; j += kThreads) {
    if (j >= m) {
      tgt[j] = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
      continue;
    }
    const float qx = tb[3 * j] - tx, qy = tb[3 * j + 1] - ty,
                qz = tb[3 * j + 2] - tz;
    tgt[j] = make_float4(-2.0f * qx, -2.0f * qy, -2.0f * qz,
                         fmaf(qx, qx, fmaf(qy, qy, qz * qz)));
  }
  __syncthreads();

  const float* r = rot + bc * 9;
  const float r00 = r[0], r01 = r[1], r02 = r[2];
  const float r10 = r[3], r11 = r[4], r12 = r[5];
  const float r20 = r[6], r21 = r[7], r22 = r[8];
  const float* mb = model + static_cast<size_t>(b) * m * 3;
  const int lane = threadIdx.x & 31;
  const float inv_m = 1.0f / static_cast<float>(m);
  const float inv_m1 = 1.0f / static_cast<float>(m > 1 ? m - 1 : 1);

  float local = 0.0f;
  for (int base = 0; base < m; base += kThreads * kPts) {
    float px[kPts], py[kPts], pz[kPts], best[kPts];
    int first[kPts];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int i = base + k * kThreads + threadIdx.x;
      float mx = 0.0f, my = 0.0f, mz = 0.0f;
      if (i < m) {
        mx = mb[3 * i];
        my = mb[3 * i + 1];
        mz = mb[3 * i + 2];
      }
      px[k] = fmaf(r00, mx, fmaf(r01, my, r02 * mz));
      py[k] = fmaf(r10, mx, fmaf(r11, my, r12 * mz));
      pz[k] = fmaf(r20, mx, fmaf(r21, my, r22 * mz));
      best[k] = INFINITY;
      first[k] = 0;
    }
    // the scan: no branch on data
    for (int g = 0; g < m_pad; g += kGroup) {
      float low[kPts];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4 t = tgt[g + u];
#pragma unroll
        for (int k = 0; k < kPts; ++k) {
          const float s = fmaf(px[k], t.x, fmaf(py[k], t.y,
                                                fmaf(pz[k], t.z, t.w)));
          low[k] = u == 0 ? s : fminf(low[k], s);
        }
      }
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        first[k] = low[k] < best[k] ? g : first[k];
        best[k] = fminf(best[k], low[k]);
      }
    }
    // the direct form over the real targets of each point's group
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      float d2 = INFINITY;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int j = first[k] + ((u + lane) & (kGroup - 1));
        const float4 t = tgt[j];
        const float dx = fmaf(0.5f, t.x, px[k]);   // p - q
        const float dy = fmaf(0.5f, t.y, py[k]);
        const float dz = fmaf(0.5f, t.z, pz[k]);
        const float e = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
        d2 = j < m ? fminf(d2, e) : d2;
      }
      const int i = base + k * kThreads + threadIdx.x;
      if (i < m) {
        const float d = sqrtf(d2);
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
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch needs for `m` points.
size_t sym_moments_smem_bytes(int m) {
  return static_cast<size_t>(padded_targets(m)) * sizeof(float4)
      + static_cast<size_t>(m) * sizeof(float);
}

// The blocks that one SM holds at once with `m` points, from the registers
// and shared memory of the compiled kernel, or minus a CUDA error code.
int sym_moments_blocks_per_sm(int m) {
  const size_t smem = sym_moments_smem_bytes(m);
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      sym_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sym_moments_kernel, kThreads, smem);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
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
  sym_moments_kernel<<<dim3(n, b), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      rot, pred_t, model, target, dis, var, n, m);
  return static_cast<int>(cudaGetLastError());
}

const char* sym_moments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
