// The FPS kernel's round without its distance pass, to time the chain's
// floor: every thread brings a fixed candidate that moves with the round,
// and the cluster runs mupe_tpu_torch/csrc/fps.cu's `exchange` (the block
// argmax, the pushes of the block's candidate and row into every block's
// inbox, the wait on the block's mbarrier, the winner's pick) K - 1 times,
// in a cluster of the resident instance's size and shared memory.  Its time
// over K - 1 is what a round of the FPS kernel costs with no points.
//
// Built and timed by scripts/time_torch_fps.py (not part of the package).

#include "../mupe_tpu_torch/csrc/fps.cu"

namespace {

__global__ void __launch_bounds__(MAX_THREADS, 1)
    empty_round_kernel(const __grid_constant__ FPSArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const Layout L = carve(smem, a.D, C, a.res);
  const int tid = threadIdx.x, lo = rank * a.rows;
  const int n = max(0, min(a.N, lo + a.rows) - lo);
  for (int j = tid; j < pad4(a.D); j += blockDim.x) L.row0[j] = 0.f;
  exchange_init(cluster, L);
  const float* row = L.row0;
  uint32_t phases = 0;
  for (int r = 1; r < a.K; ++r) {
    const float bv = tid < n ? (float)((lo + tid + r) % a.N) : -INFINITY;
    const int bi = tid < n ? lo + tid : INT_MAX;
    const float* prev = row;
    const int w = exchange(L, C, rank, a.N, a.D, a.rows, r & 1, phases, row, bv, bi,
                           [&](int, int j) { return prev[j]; });
    if (rank == 0 && tid == 0) a.out[r] = w;
  }
  cluster.sync();
}

}  // namespace

// K - 1 empty rounds over N rows of width D in one cluster of C blocks, at
// the threads and shared memory of the FPS kernel's instance `inst` for
// (N, D, C), the winners into out [K] (device).  Returns a cudaError_t.
extern "C" int mupe_fps_empty_rounds(int N, int D, int K, int C, int inst, int* out,
                                     void* stream) {
  if (N < 1 || D < 1 || D > MAX_D || K < 2 || C < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(N, D, C, inst, &p);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(empty_round_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(empty_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const FPSArgs a = {nullptr, nullptr, nullptr, nullptr, out, N, D, K, p.rows, p.res};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, empty_round_kernel, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
