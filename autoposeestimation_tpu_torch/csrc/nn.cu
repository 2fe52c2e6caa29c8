// 1-nearest neighbour over a masked reference set, for sm_90a.
//
// Replaces autoposeestimation_tpu/ops/knn.py::_nn_kernel (:119-152, wrapper
// nn_pallas). For each query q_i and the valid references r_j:
//     d2_ij = (|q_i|^2 + |r_j|^2) - 2 q_i.r_j
//     idx_i = the first j of the minimum of d2_ij,  out_i = max(min_j d2_ij, 0)
// with |v|^2 = (x x + y y) + z z (each product rounded), q.r =
// fma(qz, rz, fma(qy, ry, qx rx)) and no other contraction: the same
// roundings as the plain version (ops/knn.py::nn_plain), so that both pick
// the same neighbour, near-ties included. The last step is written
// fma(-2, q.r, |q|^2 + |r|^2): 2 q.r is exact in f32, so that is the plain
// version's (|q|^2 + |r|^2) - 2 q.r with its one rounding, for every input
// whose 2 q.r does not overflow (coordinates below ~1e19). An invalid
// reference has |r|^2 = +inf and never wins; with none valid the result is
// index 0, d2 = +inf.
//
// No tensor cores: a TF32 or split-bf16 mma rounds q.r otherwise than this
// fma chain and flips near-ties, which ICP amplifies into another cloud.
// So the bound is the FP32 lanes: 5 instructions per (query, reference)
// pair (fmul, fma, fma, fadd, fma) at 128 lanes per SM per clock; the bytes
// (12 per query and 13 per reference in, 8 per query out) are far below it.
//
// Design:
//  * Register blocking. A thread holds kQueries queries with their |q|^2 and
//    running minimum. Each staged reference is one broadcast float4
//    (x, y, z, |r|^2) read from shared memory and feeds kQueries independent
//    chains, which hides the FMA latency and divides the shared loads per
//    pair by kQueries.
//  * Minimum first, index after. Per group of kGroup references a query
//    takes the group's minimum with fminf (one instruction a pair) and
//    compares it with its best once (strict <, remembering the group),
//    where a compare and two selects per pair would cost three. Once a tile
//    is scanned, a query whose best came from it recomputes that group's d2
//    in order and takes the first reference equal to the minimum: the same
//    bits, so ties within a group go to the earlier reference and ties
//    between groups to the earlier group, the first index of the minimum as
//    a scan with strict < gives it. The compiled group loop issues ~6.7
//    instructions a pair: the 5 above, the fminf and shares of the group's
//    compare, the shared loads and the loop.
//  * Blocks of kThreads threads (four warps, one per scheduler of an SM),
//    kThreads * kQueries queries each.
//  * References split across the grid. blockIdx.y = s picks the contiguous
//    range [floor(s M / S), floor((s + 1) M / S)) of the references.
//    nn_splits chooses S per call so that every SM holds at least two
//    blocks, eight warps, where M allows ranges of kMinRange; nn_search
//    uses the same S. A block scans its range in increasing index,
//    staging it through shared memory (|r|^2 =
//    +inf for an invalid reference, the tile padded to a multiple of kGroup
//    with +inf), and writes its raw (unclamped) minimum and first index per
//    query to the scratch (S, N).
//  * nn_merge_kernel takes a query's S partials in range order with strict
//    <, then clamps: the first index of the global minimum, the same as one
//    scan over all references (an empty or all-invalid range leaves +inf,
//    which never wins). kMergeLanes lanes share a query: each takes every
//    kMergeLanes-th range in order, and shuffles combine the lanes' minima
//    with ties going to the earlier range, which is the same order. It is
//    launched as a programmatic dependent of the scan (Hopper's
//    griddepcontrol), so its launch overlaps the scan; it waits for the
//    scan's partials before reading them.
// Nothing but the partials and (idx, d2) reaches device memory; every block
// reads its range (under 100 KB of references on the main path) from L2.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kQueries = 4;
constexpr int kBlockQueries = kThreads * kQueries;
constexpr int kTile = 1024;  // references per shared tile: 16 KB
constexpr int kGroup = 8;    // references per minimum; tiles padded to it
constexpr int kMergeLanes = 8;  // merge threads per query
constexpr int kMergeThreads = 256;
constexpr int kMinRange = 16;    // fewest references in one range
constexpr int kMaxDevices = 64;

// the SM count of each device, read once (0: not read yet)
std::atomic<int> sm_counts[kMaxDevices];

// S for an (n, m) call on a card of `sms` SMs: from the least S that gives
// every SM two blocks (eight warps) up to twice that, the first S of least
// busiest-SM share ceil(blocks S / sms) / S; at least kMinRange references
// a range.
int choose_splits(int n, int m, int sms) {
  const long long blocks = (n + kBlockQueries - 1) / kBlockQueries;
  if (blocks == 0) return 1;
  const long long least = (2LL * sms + blocks - 1) / blocks;
  long long splits = least, share = (blocks * least + sms - 1) / sms;
  for (long long s = least + 1; s <= 2 * least; ++s) {
    const long long busiest = (blocks * s + sms - 1) / sms;
    if (busiest * splits < share * s) {  // busiest / s < share / splits
      splits = s;
      share = busiest;
    }
  }
  return static_cast<int>(
      std::max(1LL, std::min(splits, 1LL * m / kMinRange)));
}

// S of an (n, m) call on `device`, or minus a CUDA error code.
int splits_on(int n, int m, int device) {
  if (device < 0 || device >= kMaxDevices)
    return -static_cast<int>(cudaErrorInvalidDevice);
  int sms = sm_counts[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    sm_counts[device].store(sms, std::memory_order_relaxed);
  }
  return choose_splits(n, m, sms);
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// d2 of query (x, y, z) with |q|^2 = qq and a staged reference r.
__device__ __forceinline__ float pair_d2(float x, float y, float z, float qq,
                                         float4 r) {
  const float qr = __fmaf_rn(z, r.z, __fmaf_rn(y, r.y, __fmul_rn(x, r.x)));
  return __fmaf_rn(-2.0f, qr, __fadd_rn(qq, r.w));
}

__global__ void __launch_bounds__(kThreads)
nn_partial_kernel(const float* __restrict__ query,          // (N, 3)
                  const float* __restrict__ ref,            // (M, 3)
                  const unsigned char* __restrict__ valid,  // (M,) or null
                  int2* __restrict__ partial,               // (S, N)
                  int n, int m, int splits) {
  __shared__ float4 tile[kTile];
  const int begin = static_cast<int>(
      static_cast<long long>(blockIdx.y) * m / splits);
  const int end = static_cast<int>(
      static_cast<long long>(blockIdx.y + 1) * m / splits);
  const int first = blockIdx.x * kBlockQueries + threadIdx.x;
  // the merge, this grid's programmatic dependent, may launch once every
  // block got here; it waits for this grid to finish before it reads
  asm volatile("griddepcontrol.launch_dependents;");
  float qx[kQueries], qy[kQueries], qz[kQueries], qq[kQueries];
  float best[kQueries];
  int best_j[kQueries], group[kQueries];
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int i = first + k * kThreads;
    qx[k] = qy[k] = qz[k] = 0.0f;
    if (i < n) {
      qx[k] = query[3 * i];
      qy[k] = query[3 * i + 1];
      qz[k] = query[3 * i + 2];
    }
    best[k] = INFINITY;
    best_j[k] = 0;
    group[k] = -1;
  }
  bool norms = false;  // |q|^2 after the first staging, which the loads overlap
  for (int base = begin; base < end; base += kTile) {
    const int count = min(kTile, end - base);
    const int padded = (count + kGroup - 1) / kGroup * kGroup;
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < padded; k += kThreads) {
      float4 r = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
      if (k < count) {
        const int j = base + k;
        const float x = ref[3 * j], y = ref[3 * j + 1], z = ref[3 * j + 2];
        const bool ok = valid == nullptr || valid[j] != 0;
        r = make_float4(x, y, z, ok ? sq_norm(x, y, z) : INFINITY);
      }
      tile[k] = r;
    }
    __syncthreads();
    if (!norms) {
#pragma unroll
      for (int q = 0; q < kQueries; ++q) qq[q] = sq_norm(qx[q], qy[q], qz[q]);
      norms = true;
    }
    for (int k = 0; k < padded; k += kGroup) {
      float4 r[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) r[u] = tile[k + u];
#pragma unroll
      for (int q = 0; q < kQueries; ++q) {
        float low = pair_d2(qx[q], qy[q], qz[q], qq[q], r[0]);
#pragma unroll
        for (int u = 1; u < kGroup; ++u)
          low = fminf(low, pair_d2(qx[q], qy[q], qz[q], qq[q], r[u]));
        if (low < best[q]) {
          best[q] = low;
          group[q] = k;
        }
      }
    }
    // the first reference of the winning group at the minimum (fminf
    // returns one of its operands, so one is equal)
#pragma unroll
    for (int q = 0; q < kQueries; ++q) {
      if (group[q] >= 0) {
        for (int u = group[q]; u < group[q] + kGroup; ++u) {
          const float d2 = pair_d2(qx[q], qy[q], qz[q], qq[q], tile[u]);
          if (d2 == best[q]) {
            best[q] = d2;
            best_j[q] = base + u;
            break;
          }
        }
        group[q] = -1;
      }
    }
  }
  int2* out = partial + static_cast<size_t>(blockIdx.y) * n;
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int i = first + k * kThreads;
    if (i < n) out[i] = make_int2(__float_as_int(best[k]), best_j[k]);
  }
}

__global__ void __launch_bounds__(kMergeThreads)
nn_merge_kernel(const int2* __restrict__ partial,  // (S, N)
                int* __restrict__ out_idx,         // (N,)
                float* __restrict__ out_d2,        // (N,)
                int n, int splits) {
  const int t = blockIdx.x * kMergeThreads + threadIdx.x;
  const int i = t / kMergeLanes;
  const int lane = t % kMergeLanes;
  float best = INFINITY;
  int best_s = splits;  // no range taken
  int best_j = 0;
  // the scan's partials are complete and visible after this
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (i < n) {
#pragma unroll 4
    for (int s = lane; s < splits; s += kMergeLanes) {
      const int2 p = partial[static_cast<size_t>(s) * n + i];
      const float d2 = __int_as_float(p.x);
      if (d2 < best) {
        best = d2;
        best_s = s;
        best_j = p.y;
      }
    }
  }
  // the minimum over the query's lanes, ties to the earlier range
#pragma unroll
  for (int offset = kMergeLanes / 2; offset > 0; offset /= 2) {
    const float other = __shfl_xor_sync(0xffffffffu, best, offset);
    const int other_s = __shfl_xor_sync(0xffffffffu, best_s, offset);
    const int other_j = __shfl_xor_sync(0xffffffffu, best_j, offset);
    if (other < best || (other == best && other_s < best_s)) {
      best = other;
      best_s = other_s;
      best_j = other_j;
    }
  }
  if (i < n && lane == 0) {
    out_idx[i] = best_j;
    out_d2[i] = fmaxf(best, 0.0f);
  }
}

cudaError_t launch(const float* query, const float* ref,
                   const unsigned char* valid, int2* partial, int* out_idx,
                   float* out_d2, int n, int m, int splits, cudaStream_t s) {
  const dim3 grid((n + kBlockQueries - 1) / kBlockQueries, splits);
  nn_partial_kernel<<<grid, kThreads, 0, s>>>(query, ref, valid, partial, n,
                                              m, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute dependent;
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(
      (static_cast<long long>(n) * kMergeLanes + kMergeThreads - 1) /
      kMergeThreads));
  config.blockDim = dim3(kMergeThreads);
  config.stream = s;
  config.attrs = &dependent;
  config.numAttrs = 1;
  const cudaError_t merged = cudaLaunchKernelEx(
      &config, nn_merge_kernel, static_cast<const int2*>(partial), out_idx,
      out_d2, n, splits);
  if (merged != cudaSuccess) return merged;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The ranges S of an (n, m) call on `device`: nn_search needs a scratch of
// S * n entries of 8 bytes. Minus a CUDA error code if the device's SM
// count cannot be read.
int nn_splits(int n, int m, int device) { return splits_on(n, m, device); }

// Launches the scan over nn_splits(n, m, device) ranges of the references
// and the merge on `stream` of `device` (made current for the launches);
// `partial` is the (S, n) scratch. Returns the first CUDA error, else 0.
int nn_search(const float* query, const float* ref, const unsigned char* valid,
              void* partial, int* out_idx, float* out_d2, int n, int m,
              int device, void* stream) {
  const int splits = splits_on(n, m, device);
  if (splits < 0) return -splits;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(query, ref, valid, static_cast<int2*>(partial), out_idx,
               out_d2, n, m, splits, static_cast<cudaStream_t>(stream));
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

const char* nn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
