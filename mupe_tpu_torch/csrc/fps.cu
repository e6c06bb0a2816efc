// Farthest-point sampling: K greedy max-min rounds over points [N, D].
//
// Replaces the TPU kernel mupe_tpu/ops/fps_pallas.py `_fps_kernel` (the
// AEG history buffer's downsampling, reached from envs/genbuffer.py
// `update_history`).  It computes the same selection: idx[0] = start; each
// further round takes the argmax of the running min squared distance to the
// selected points (the lowest index on ties) and folds in that point's
// distances; invalid points hold -inf and are never chosen while a valid one
// is left.  Each squared distance is summed over j = 0..D-1 in order with
// __fsub_rn / __fmul_rn / __fadd_rn (no FMA contraction), so the distances,
// and the indices, are bit-identical to the plain version's
// (mupe_tpu_torch/ops/fps.py `reference_fps`).  D is the true width (27 for
// the AEG task), not the TPU's lane padding to 128.
//
// What bounds it on an H100: the K rounds are a chain, each waiting on the
// previous round's argmax over all N points.  The work, (K-1) * N * D * 3
// flops (3.7 GFLOP at N = 9,096, D = 27, K = 5,000), would take 0.055 ms at
// the f32 peak, but one round's latency (a pass over the points, a block-wide
// argmax, two barriers) bounds it long before that.  Design, simple first:
// one block of 1024 threads loops over the K rounds, so there is no launch
// per round and no host sync; each thread owns rows tid, tid + 1024, ...; the
// running min distance (36 KB at N = 9,096) lives in shared memory and the
// chosen row is staged there each round.  The points (982 KB) do not fit the
// SM, so they are read every round from L2: the kernel first copies them
// into a column-major scratch [D, N] (from the wrapper), so that a warp's
// load of column j is 32 neighbouring floats, one cache line, where the
// row-major rows would touch 32 lines.  The argmax is a warp shuffle over
// (value, index) pairs and then one warp over the 32 warp winners.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 1024;

struct FPSArgs {
  const float* points;   // [N, D]
  const uint8_t* valid;  // [N]
  const int* start;      // [1]
  float* cols;           // [D, N] scratch: the points, column-major
  int* out;              // [K]
  int N, D, K;
};

// (v, i) beats (bv, bi): larger value, or the same value at a lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) fps_kernel(const __grid_constant__ FPSArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* mind = reinterpret_cast<float*>(smem_raw);  // [N] running min distance
  float* row = mind + a.N;                           // [D] the chosen point
  float* wv = row + a.D;                             // [WARPS] warp winners
  int* wi = reinterpret_cast<int*>(wv + WARPS);      // [WARPS]
  int* cur_s = wi + WARPS;                           // [1] this round's point

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < a.N; i += THREADS) mind[i] = a.valid[i] ? INFINITY : -INFINITY;
  for (int e = tid; e < a.N * a.D; e += THREADS) {
    const int i = e / a.D;
    a.cols[(size_t)(e - i * a.D) * a.N + i] = __ldg(a.points + e);
  }
  if (tid == 0) *cur_s = *a.start;
  __syncthreads();  // also makes the block's writes to cols visible to it

  for (int r = 0; r < a.K; ++r) {
    const int cur = *cur_s;
    if (tid == 0) a.out[r] = cur;
    if (r == a.K - 1) break;
    for (int j = tid; j < a.D; j += THREADS) row[j] = a.cols[(size_t)j * a.N + cur];
    __syncthreads();

    float bv = -INFINITY;
    int bi = a.N;
    for (int i = tid; i < a.N; i += THREADS) {
      // plain loads: cols was written by this kernel (no read-only path)
      const float* p = a.cols + i;
      float d = 0.f;  // 0 + sq_0 == sq_0 exactly
#pragma unroll 4
      for (int j = 0; j < a.D; ++j) {
        const float diff = __fsub_rn(p[(size_t)j * a.N], row[j]);
        d = __fadd_rn(d, __fmul_rn(diff, diff));
      }
      // invalid points start at -inf and stay there
      const float v = fminf(mind[i], d);
      mind[i] = v;
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      float v = wv[lane];
      int i = wi[lane];
      warp_argmax(v, i);
      if (lane == 0) *cur_s = i;
    }
    __syncthreads();
  }
}

}  // namespace

// points [N, D] f32, valid [N] u8 (nonzero = valid), start [1] i32, cols
// [D, N] f32 scratch, out [K] i32; all device pointers.  1 <= K <= N.
// Returns a cudaError_t.
extern "C" int mupe_fps(const float* points, const uint8_t* valid, const int* start, int N,
                        int D, int K, float* cols, int* out, void* stream) {
  if (N < 1 || D < 1 || D > MAX_D || K < 1 || K > N) return (int)cudaErrorInvalidValue;
  FPSArgs args = {points, valid, start, cols, out, N, D, K};
  const size_t smem = (size_t)(N + D + WARPS) * sizeof(float) + (WARPS + 1) * sizeof(int);
  cudaError_t err =
      cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
