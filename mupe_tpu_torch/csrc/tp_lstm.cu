// TP-net forward: a T-step LSTM(F -> 64) over each history window, gates in
// (i, f, g, o) order, then Dense(64 -> O) and tanh.
//
// Replaces the TPU kernels mupe_tpu/ops/tp_lstm.py `_tp_fwd_kernel_t`
// (batch-in-lanes layout) and `_tp_fwd_kernel` (the same math with the
// hidden width lane-padded to 128).  It computes `_fwd_steps_t` +
// `_head_t` (tp_lstm.py:377-419): bf16 matmul operands with f32 sums, the
// bias added in f32 after both products, f32 gates and f32 c / h state.
// The hidden width is the true 64; the input is [N, T, F] row-major.  The
// recurrence is the warp tile of tp_tile.cuh in its forward-only mode, the
// code that stage A of the backward (tp_lstm_bwd.cu) runs, so the backward
// differentiates the h bits this kernel gives.
//
// Any F, T and O: up to 64 inputs and 64 outputs the register instances,
// past them the generic one (tp_tile.cuh), its shared memory sized per call
// (F = 91, O = 120: ~102 KB; past ~290 inputs wi and wfc stay in device
// memory).
//
// What bounds it on an H100: the recurrence.  A window costs T * 4H * (F + H)
// = 204,800 multiply-adds at T=10, F=16, H=64 and reads 640 bytes, so the
// tensor cores' rate bounds it; in practice the gates' activations (five
// transcendentals a (window, unit) pair a step, on the CUDA cores) and, at
// the rollout's N = 4,096 (256 tiles, under two blocks an SM), the chain of T
// dependent steps.  Design: a block of four warps a tile of 16 windows
// (mma.sync m16n8k16; warp w computes hidden units 16 w .. 16 w + 15, and
// the tile's h passes between the warps through shared memory once a step),
// a persistent grid of blocks that convert the f32 weights to bf16 into
// shared memory once; one launch a call, no host-side tensor work (x and the
// leaves are read as f32 and rounded in the kernel).  Windows past N run on
// zeros and are never stored.

#include "tp_tile.cuh"

namespace {

struct TPFwdArgs {
  const float* x;  // [N, T, F]
  TPLeaves l;
  float* y;        // [N, O]
  int N, T, F, O, n_tiles;
  int gw;          // the generic instance: wi and wfc read from device memory
};

template <int FKT>
__global__ void __launch_bounds__(TP_THREADS, 4) tp_lstm_fwd_kernel(const __grid_constant__ TPFwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  TPSmem s;
  const bool gw = FKT == 0 && a.gw;
  tp_carve(smem, &s, FKT > 0 ? FKT : (a.F + 15) / 16, FKT > 0 ? TP_OPASS : tp_op(a.O), false,
           gw);
  const int j = threadIdx.x;
  tp_fill(s, a.l, a.F, a.O, gw, j);
  __syncthreads();
  const int warp = j >> 5;
  const int lane = j & 31;
  const int q = lane & 3;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const TPRows r = {tile * TP_ROWS + (lane >> 2), tile * TP_ROWS + (lane >> 2) + 8,
                      a.N, a.T, a.F, a.O};
    tp_forward_steps<FKT>(s, a.x, r, nullptr, tile, warp, lane);
    const int n_pass = FKT > 0 ? 1 : s.op / TP_OPASS;
    for (int p = 0; p < n_pass; ++p) {
      float z[2][4];
      tp_head(z, s, a.T, a.O, p, warp, lane);
#pragma unroll
      for (int sub = 0; sub < 2; ++sub)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int o = p * TP_OPASS + warp * 16 + sub * 8 + 2 * q + (v & 1);
          const int row = v < 2 ? r.ra : r.rb;
          if (o < a.O && row < a.N) a.y[(size_t)row * a.O + o] = tanhf(z[sub][v] + s.bfc[o]);
        }
    }
    __syncthreads();  // every warp has read h_T before the next tile writes it
  }
}

// Per device, set up once: each register instance's shared-memory attribute
// and its resident blocks an SM, so that a call does no host work but its
// launch; the generic instance (F > 64 or O > 64) is set up per call for its
// shared memory.
constexpr int TP_MAX_DEVICES = 64;

struct TPFwdPlan {
  void (*kernel)(TPFwdArgs);
  size_t smem;
  int per_sm;
  int gw;
};

template <int FKT>
cudaError_t fwd_plan_of(TPFwdPlan& p, int F, int O) {
  p.kernel = tp_lstm_fwd_kernel<FKT>;
  const int nkt = FKT > 0 ? FKT : (F + 15) / 16, op = FKT > 0 ? TP_OPASS : tp_op(O);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return err;
  p.smem = tp_carve(nullptr, nullptr, nkt, op, false);
  p.gw = FKT == 0 && p.smem > (size_t)optin;
  if (p.gw) p.smem = tp_carve(nullptr, nullptr, nkt, op, false, true);
  err = cudaFuncSetAttribute(p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, p.kernel, TP_THREADS, p.smem);
}

cudaError_t fwd_plan(int F, int O, TPFwdPlan* plan, int* sms) {
  static TPFwdPlan plans[TP_MAX_DEVICES][TP_MAX_FKT];
  static int sm_count[TP_MAX_DEVICES] = {};  // 0: the device not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= TP_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    int n = 0;
    if ((err = fwd_plan_of<1>(plans[dev][0], 0, 0)) != cudaSuccess ||
        (err = fwd_plan_of<2>(plans[dev][1], 0, 0)) != cudaSuccess ||
        (err = fwd_plan_of<3>(plans[dev][2], 0, 0)) != cudaSuccess ||
        (err = fwd_plan_of<4>(plans[dev][3], 0, 0)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    sm_count[dev] = n;
  }
  *sms = sm_count[dev];
  if (F <= 16 * TP_MAX_FKT && O <= TP_OPASS) {
    *plan = plans[dev][(F + 15) / 16 - 1];
  } else if ((err = fwd_plan_of<0>(*plan, F, O)) != cudaSuccess) {
    return err;
  }
  return plan->per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace

// x [N, T, F], wi [F, 4*64], wh [64, 4*64], b [4*64], wfc [64, O], bfc [O],
// y [N, O]; all f32 device pointers.  Returns a cudaError_t.
extern "C" int mupe_tp_lstm_forward(const float* x, int N, int T, int F, const float* wi,
                                    const float* wh, const float* b, const float* wfc,
                                    const float* bfc, int O, float* y, void* stream) {
  if (N < 0 || T < 1 || F < 1 || O < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  TPFwdPlan plan;
  int sms = 0;
  cudaError_t err = fwd_plan(F, O, &plan, &sms);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (N + TP_ROWS - 1) / TP_ROWS;
  int blocks = sms * plan.per_sm;
  if (blocks > n_tiles) blocks = n_tiles;
  TPFwdArgs args = {x, {wi, wh, b, wfc, bfc}, y, N, T, F, O, n_tiles, plan.gw};
  plan.kernel<<<blocks, TP_THREADS, plan.smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
