// Symmetric ADD-S matched-distance moments plus their gradient precursors,
// for sm_90a: the training forward of the symmetric pose loss.
//
// Replaces autoposeestimation_tpu/ops/pallas_addloss.py::_train_kernel
// (wrapper _moments_train_pallas). For each sample b and candidate pose c
// (rotation R, translation t) and each model point m_i:
//     pred_i   = R m_i + t
//     dmin2_i  = min_j d2_ij,   dmin_i = sqrt(max(dmin2_i, 0))
//     matched_i = mean of every target j with d2_ij <= dmin2_i (ties average)
//     u_i      = (pred_i - matched_i) / sqrt(max(|pred_i - matched_i|^2,
//                                                1e-24))
//     dis = sum_i dmin_i / M,  var = sum_i (dmin_i - dis)^2 / (M - 1)
//     std = max(sqrt(var), 1e-12)
//     w_i = clip((dmin_i - dis) / ((M - 1) std), +-1/sqrt(M - 1))
// and writes the row [A_t = sum u_i / M, B_t = sum w_i u_i,
// A_r = u^T model / M, B_r = (w u)^T model (row-major), dis, var, 0 x 6].
// The backward of the loss is a linear combination of these 24 precursors.
//
// Two modes, each the function of the JAX kernel in that mode:
//   * f32 (bf16 = 0): d2 in direct form (p - t)^2, matched targets in f32;
//   * bf16 (bf16 = 1, the training default): d2 in the expansion form
//     [p, 1, |p|^2] . [-2t, |t|^2, 1] over operands rounded to bf16 (round
//     to nearest even), the five exact products summed in that order in
//     f32, and the matched targets rounded to bf16 as well. The ~3 %
//     moment noise of that rounding is the function being ported.
// The candidate transform and |p|^2 use explicitly rounded operations in
// the order of the plain version (ops/addloss.py::moments_train_plain), so
// bf16 mode agrees with it up to summation order.
//
// Bound: operations. B*N*M*M point pairs (2e9 at the training shape
// 8 x 1000 x 500) against ~0.5 MB of inputs and 1 MB of output; the least
// work is the forward kernel's 4 FP32 instructions a pair. Design: one block
// per (sample, tile of candidates); the sample's targets and model points
// sit in shared memory as float4 and are reused by every candidate of the
// tile; each thread keeps kPts model points in registers, and ONE scan over
// the targets keeps, per point, the running minimum together with the sum
// and count of the targets at that minimum (reset when d2 < best, added
// when d2 == best), which is exactly the d2 <= dmin2 indicator average with
// no second scan. Per-point (u, dmin) stay in shared memory for three block
// reductions: the sum of dmin, the centered sum of squares, and one
// reduction of the 24 precursors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPts = 4;                  // model points per thread per pass
constexpr int kCandidatesPerBlock = 8;
constexpr int kPre = 24;                 // precursor columns
constexpr int kCols = 32;                // columns of an output row

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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ((a0 b0 + a1 b1) + a2 b2), every step rounded (no contraction)
__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
sym_moments_train_kernel(const float* __restrict__ rot,     // (B, N, 3, 3)
                         const float* __restrict__ pred_t,  // (B, N, 3)
                         const float* __restrict__ model,   // (B, M, 3)
                         const float* __restrict__ target,  // (B, M, 3)
                         float* __restrict__ out,           // (B, N, 32)
                         int n, int m) {
  extern __shared__ float4 smem[];
  // f32 mode (t, 0); bf16 mode (-2 bf16(t), bf16(|t|^2))
  float4* tgt = smem;                                   // M
  float4* mdl = smem + m;                               // M: (m_i, 0)
  float4* pt = smem + 2 * m;                            // M: (u_i, dmin_i)
  __shared__ float scratch[33];
  __shared__ float pre[kWarps][kPre];

  const int b = blockIdx.y;
  const float* tb = target + static_cast<size_t>(b) * m * 3;
  const float* mb = model + static_cast<size_t>(b) * m * 3;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float x = tb[3 * j], y = tb[3 * j + 1], z = tb[3 * j + 2];
    if (kBf16) {
      tgt[j] = make_float4(-2.0f * bf16_round(x), -2.0f * bf16_round(y),
                           -2.0f * bf16_round(z),
                           bf16_round(dot3_rn(x, y, z, x, y, z)));
    } else {
      tgt[j] = make_float4(x, y, z, 0.0f);
    }
    mdl[j] = make_float4(mb[3 * j], mb[3 * j + 1], mb[3 * j + 2], 0.0f);
  }
  __syncthreads();

  const float inv_m = static_cast<float>(1.0 / m);
  const float inv_m1 = static_cast<float>(1.0 / (m > 1 ? m - 1 : 1));
  const float wcap = static_cast<float>(1.0 / sqrt(m > 1 ? m - 1.0 : 1.0));
  // bf16 mode sums -2 bf16(t): scale back by -1/2 (exact)
  const float src_scale = kBf16 ? -0.5f : 1.0f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
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
      float qx[kPts], qy[kPts], qz[kPts], pp[kPts], best[kPts];
      float sx[kPts], sy[kPts], sz[kPts], cnt[kPts];
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        const float4 p = i < m ? mdl[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float px = __fadd_rn(dot3_rn(r00, r01, r02, p.x, p.y, p.z), tx);
        const float py = __fadd_rn(dot3_rn(r10, r11, r12, p.x, p.y, p.z), ty);
        const float pz = __fadd_rn(dot3_rn(r20, r21, r22, p.x, p.y, p.z), tz);
        if (kBf16) {
          qx[k] = bf16_round(px);
          qy[k] = bf16_round(py);
          qz[k] = bf16_round(pz);
          pp[k] = bf16_round(dot3_rn(px, py, pz, px, py, pz));
        } else {
          qx[k] = px;
          qy[k] = py;
          qz[k] = pz;
          pp[k] = 0.0f;
        }
        best[k] = INFINITY;
        sx[k] = sy[k] = sz[k] = cnt[k] = 0.0f;
      }
      for (int j = 0; j < m; ++j) {
        const float4 t = tgt[j];
#pragma unroll
        for (int k = 0; k < kPts; ++k) {
          float d2;
          if (kBf16) {
            // bf16 x bf16 products are exact in f32: FMA == mul + add
            d2 = __fmaf_rn(qz[k], t.z,
                           __fmaf_rn(qy[k], t.y, __fmul_rn(qx[k], t.x)));
            d2 = __fadd_rn(__fadd_rn(d2, t.w), pp[k]);
          } else {
            const float dx = qx[k] - t.x, dy = qy[k] - t.y, dz = qz[k] - t.z;
            d2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
          }
          if (d2 <= best[k]) {
            if (d2 < best[k]) {
              best[k] = d2;
              sx[k] = sy[k] = sz[k] = cnt[k] = 0.0f;
            }
            sx[k] += t.x;
            sy[k] += t.y;
            sz[k] += t.z;
            cnt[k] += 1.0f;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        if (i < m) {
          const float4 p = mdl[i];
          const float px = __fadd_rn(dot3_rn(r00, r01, r02, p.x, p.y, p.z),
                                     tx);
          const float py = __fadd_rn(dot3_rn(r10, r11, r12, p.x, p.y, p.z),
                                     ty);
          const float pz = __fadd_rn(dot3_rn(r20, r21, r22, p.x, p.y, p.z),
                                     tz);
          const float dx = px - sx[k] * src_scale / cnt[k];
          const float dy = py - sy[k] * src_scale / cnt[k];
          const float dz = pz - sz[k] * src_scale / cnt[k];
          // u is normalized by the direct |pred - matched|, not by dmin
          const float dn = sqrtf(fmaxf(dot3_rn(dx, dy, dz, dx, dy, dz),
                                       1e-24f));
          const float d = sqrtf(fmaxf(best[k], 0.0f));
          pt[i] = make_float4(dx / dn, dy / dn, dz / dn, d);
          local += d;
        }
      }
    }
    // block_sum's leading barrier also publishes pt to the reductions
    const float dis = block_sum(local, scratch) * inv_m;
    float sq = 0.0f;
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const float dd = pt[i].w - dis;
      sq = fmaf(dd, dd, sq);
    }
    const float var = block_sum(sq, scratch) * inv_m1;
    const float stdv = fmaxf(sqrtf(var), 1e-12f);

    float acc[kPre];
#pragma unroll
    for (int v = 0; v < kPre; ++v) acc[v] = 0.0f;
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const float4 q = pt[i];
      const float4 p = mdl[i];
      const float w = fminf(fmaxf((q.w - dis) * inv_m1 / stdv, -wcap), wcap);
      const float u[3] = {q.x, q.y, q.z};
      const float mp[3] = {p.x, p.y, p.z};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[a] += u[a];
        acc[3 + a] += w * u[a];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          acc[6 + 3 * a + e] = fmaf(u[a], mp[e], acc[6 + 3 * a + e]);
          acc[15 + 3 * a + e] = fmaf(w * u[a], mp[e], acc[15 + 3 * a + e]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kPre; ++v) {
      float s = acc[v];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) pre[warp][v] = s;
    }
    __syncthreads();
    if (threadIdx.x < kCols) {
      const int col = threadIdx.x;
      float val = 0.0f;
      if (col < kPre) {
        for (int w = 0; w < kWarps; ++w) val += pre[w][col];
        if (col < 3 || (col >= 6 && col < 15)) val *= inv_m;  // A_t, A_r
      } else if (col == kPre) {
        val = dis;
      } else if (col == kPre + 1) {
        val = var;
      }
      out[bc * kCols + col] = val;
    }
    __syncthreads();  // pt and pre are rewritten by the next candidate
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch needs for `m` points.
size_t sym_moments_train_smem_bytes(int m) {
  return static_cast<size_t>(m) * 3 * sizeof(float4);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int sym_moments_train(const float* rot, const float* pred_t,
                      const float* model, const float* target, float* out,
                      int b, int n, int m, int bf16, void* stream) {
  const size_t smem = sym_moments_train_smem_bytes(m);
  const auto kernel = bf16 ? sym_moments_train_kernel<true>
                           : sym_moments_train_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kCandidatesPerBlock - 1) / kCandidatesPerBlock, b);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rot, pred_t, model, target, out, n, m);
  return static_cast<int>(cudaGetLastError());
}

const char* sym_moments_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
