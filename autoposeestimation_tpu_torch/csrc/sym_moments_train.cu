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
// work is 4 FP32 lane instructions a pair in f32 mode and, in bf16 mode,
// the min and tie compare, 2 a pair (0.239 and 0.120 ms on an H100 at
// 1980 MHz). The per-pair arithmetic is the function (the tie set the matched targets average over
// depends on every rounding), so it runs on the FP32 lanes: f32 mode
// 3 fsub, fmul, 2 ffma; bf16 mode fmul, 2 ffma, fadd (+ |t|^2) and, per
// point once a group, the fadd of |p|^2. With the group minimum the
// compiled scan loop issues 5.6 instructions a pair in bf16 mode and 7.6
// in f32 mode, and branches on nothing but its own end.
//
// No tensor cores: an MMA sums the expansion's products in its own order
// and width, so its d2 differs from this one in the last bits and flips
// the exact-tie set, and with it the matched-target average that the
// gradient precursors are made of.
//
// Design: one block of kThreads threads per (candidate, sample); the
// sample's targets and model points sit in shared memory as float4.
// Thread tid holds the model points i = base + k kThreads + tid (k < kPts)
// in registers, and each staged target is one broadcast float4 that feeds
// kPts independent chains.
//  * Minimum first, on the value the minimum needs. Per point and target
//    the scan computes s_j (bf16 mode: s_j = (q.(-2t)) + |t|^2, the d2 of
//    the expansion without its last + |p|^2; f32 mode: s_j = d2_j) and
//    folds each group of kGroup targets with fminf, one instruction a
//    pair. Round-to-nearest addition is monotone, so min_j fl(s_j + pp) =
//    fl(min_j s_j + pp): the + |p|^2 is paid once a group.
//  * Tie bookkeeping once a group, with selects and no branch: per point
//    the least group value bestd, the first group whose value is less
//    than all before it (strict <: the group of the first target at the
//    final minimum) and the last group whose value is <= bestd at the time
//    (the last group holding a target at the final minimum). A group holds
//    a target at the minimum exactly when its value equals it.
//  * Exact tie collection after the scan: a point recomputes d2 from its
//    first to its last group in increasing j (usually one group; exact
//    ties across groups, as mirror-symmetric or duplicated targets give,
//    span more) and sums the targets with d2 == bestd from zero, taking
//    the minimum's bits from the first of them. That is the running-tie
//    scan's sum (reset at each new minimum, added at each equal one) in its
//    order, so every row equals that scan's bit for bit. With no finite
//    d2 the first group stays 0, and the last is the last holding +inf.
//  * Targets are padded to a multiple of kGroup with members whose value
//    is +inf, which the collection never visits.
//  * One block per (candidate, sample): grid (N, B). At the training shape
//    that is 8,000 blocks, 7.6 per slot of the card (60-62 registers a
//    thread and 24.7 KB of shared memory hold 8 blocks on an SM); blocks
//    are handed to SMs as they free up, so the busiest SM gets 61 of them
//    against a mean of 60.6, where runs of candidates per block would
//    leave whole SMs idle at the end.
// Per candidate, per-point (u, dmin) stay in shared memory for three block
// reductions: the sum of dmin, the centered sum of squares, and one
// reduction of the 24 precursors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPts = 4;                  // model points per thread per pass
constexpr int kGroup = 16;               // targets per group minimum
constexpr int kPre = 24;                 // precursor columns
constexpr int kCols = 32;                // columns of an output row

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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ((a0 b0 + a1 b1) + a2 b2), every step rounded (no contraction)
__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// The scan's value of point q and staged target t: bf16 mode
// (q.(-2t)) + |t|^2 (bf16 x bf16 products are exact in f32, so each FMA
// is the product and an add), whose fl(. + |p|^2) is d2; f32 mode d2.
template <bool kBf16>
__device__ __forceinline__ float pair_value(float qx, float qy, float qz,
                                            float4 t) {
  if (kBf16) {
    return __fadd_rn(
        __fmaf_rn(qz, t.z, __fmaf_rn(qy, t.y, __fmul_rn(qx, t.x))), t.w);
  }
  const float dx = qx - t.x, dy = qy - t.y, dz = qz - t.z;
  return fmaf(dx, dx, fmaf(dy, dy, dz * dz));
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
  const int m_pad = padded_targets(m);
  // f32 mode (t, 0); bf16 mode (-2 bf16(t), bf16(|t|^2)); padded to m_pad
  // with members whose value is +inf
  float4* tgt = smem;                                   // m_pad
  float4* mdl = smem + m_pad;                           // M: (m_i, 0)
  float4* pt = smem + m_pad + m;                        // M: (u_i, dmin_i)
  __shared__ float scratch[33];
  __shared__ float pre[kWarps][kPre];

  const int b = blockIdx.y;
  const float* tb = target + static_cast<size_t>(b) * m * 3;
  const float* mb = model + static_cast<size_t>(b) * m * 3;
  for (int j = threadIdx.x; j < m_pad; j += kThreads) {
    if (j >= m) {
      tgt[j] = kBf16 ? make_float4(0.0f, 0.0f, 0.0f, INFINITY)
                     : make_float4(INFINITY, 0.0f, 0.0f, 0.0f);
      continue;
    }
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
  const size_t bc = static_cast<size_t>(b) * n + blockIdx.x;
  const float* r = rot + bc * 9;
  const float r00 = r[0], r01 = r[1], r02 = r[2];
  const float r10 = r[3], r11 = r[4], r12 = r[5];
  const float r20 = r[6], r21 = r[7], r22 = r[8];
  const float tx = pred_t[bc * 3], ty = pred_t[bc * 3 + 1],
              tz = pred_t[bc * 3 + 2];

  float local = 0.0f;
  for (int base = 0; base < m; base += kThreads * kPts) {
    float qx[kPts], qy[kPts], qz[kPts], pp[kPts], bestd[kPts];
    int first[kPts], last[kPts];
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
      bestd[k] = INFINITY;
      first[k] = last[k] = 0;
    }
    // the scan: no branch on data
    for (int g = 0; g < m_pad; g += kGroup) {
      float low[kPts];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4 t = tgt[g + u];
#pragma unroll
        for (int k = 0; k < kPts; ++k) {
          const float v = pair_value<kBf16>(qx[k], qy[k], qz[k], t);
          low[k] = u == 0 ? v : fminf(low[k], v);
        }
      }
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        const float d = kBf16 ? __fadd_rn(low[k], pp[k]) : low[k];
        first[k] = d < bestd[k] ? g : first[k];
        last[k] = d <= bestd[k] ? g : last[k];
        bestd[k] = fminf(bestd[k], d);
      }
    }
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int i = base + k * kThreads + threadIdx.x;
      if (i < m) {
        // the targets at the minimum, in increasing j
        const int hi = min(last[k] + kGroup, m);
        float best = INFINITY, sx = 0.0f, sy = 0.0f, sz = 0.0f,
              cnt = 0.0f;
        for (int j = first[k]; j < hi; ++j) {
          const float4 t = tgt[j];
          float d2 = pair_value<kBf16>(qx[k], qy[k], qz[k], t);
          if (kBf16) d2 = __fadd_rn(d2, pp[k]);
          if (d2 == bestd[k]) {
            if (cnt == 0.0f) best = d2;
            sx += t.x;
            sy += t.y;
            sz += t.z;
            cnt += 1.0f;
          }
        }
        const float4 p = mdl[i];
        const float px = __fadd_rn(dot3_rn(r00, r01, r02, p.x, p.y, p.z),
                                   tx);
        const float py = __fadd_rn(dot3_rn(r10, r11, r12, p.x, p.y, p.z),
                                   ty);
        const float pz = __fadd_rn(dot3_rn(r20, r21, r22, p.x, p.y, p.z),
                                   tz);
        const float dx = px - sx * src_scale / cnt;
        const float dy = py - sy * src_scale / cnt;
        const float dz = pz - sz * src_scale / cnt;
        // u is normalized by the direct |pred - matched|, not by dmin
        const float dn = sqrtf(fmaxf(dot3_rn(dx, dy, dz, dx, dy, dz),
                                     1e-24f));
        const float d = sqrtf(fmaxf(best, 0.0f));
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
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch needs for `m` points.
size_t sym_moments_train_smem_bytes(int m) {
  return static_cast<size_t>(padded_targets(m) + 2 * m) * sizeof(float4);
}

// The blocks of this mode that one SM holds at once with `m` points, from
// the registers and shared memory of the compiled kernel, or minus a CUDA
// error code.
int sym_moments_train_blocks_per_sm(int m, int bf16) {
  const auto kernel = bf16 ? sym_moments_train_kernel<true>
                           : sym_moments_train_kernel<false>;
  const size_t smem = sym_moments_train_smem_bytes(m);
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
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
  kernel<<<dim3(n, b), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rot, pred_t, model, target, out, n, m);
  return static_cast<int>(cudaGetLastError());
}

const char* sym_moments_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
