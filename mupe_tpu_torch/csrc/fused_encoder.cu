// Encoder + linear head forward (PartialAttentionEncoder) for one or two
// networks over the same packed observation rows.
//
// Replaces the TPU kernels mupe_tpu/ops/fused_encoder.py `_fwd_kernel`
// (one network, the bootstrap value) and `_pair_fwd_kernel` (actor and
// critic together, the rollout's act).  It computes `_forward_core`
// (fused_encoder.py:278-364) row by row:
//   per-token embed -> LN0 -> q (query token only), k, v (all tokens)
//   -> single-query softmax over the tokens -> out-proj + residual -> LN1
//   -> tanh-GELU FFN + residual -> LN2 -> linear head.
//
// Numerics follow `_forward_core` exactly at its rounding points: every
// matmul operand is rounded to bf16 and summed in f32 (`_mm`, the head
// included); the embeds, h_all, ks_all and vs_all are bf16 values; h0 (the
// query token's LN0 output) stays f32 for the residual; q, the scores, the
// softmax and the LayerNorm statistics (var = E[x^2] - m^2, eps 1e-6) are f32.
//
// What bounds it on an H100: arithmetic.  A row costs ~270K multiply-adds
// per network (the k/v projections of all tokens are 3/4 of it) and reads
// 56 floats, so the kernel sits far above the memory roofline.  Both
// networks' weights (~210K floats) stay resident in the 50 MB L2.
// Design: one block of 128 threads per tile of TR rows and per network
// (blockIdx.y), thread j owning feature column j.  All activations of the
// tile live in shared memory (bf16 where the reference rounds, f32
// elsewhere); matmul operands are read as 8 bf16 values per 16-byte
// shared load and multiplied by weights streamed from L1/L2 with FMA.
// Cross-column reductions (LayerNorm, scores, head) are warp shuffles.
// Rows past S in the last tile are computed on zeros and never stored.
// The tile code is `tile_forward` / `tile_head` of encoder_tile.cuh, which
// the forward + loss kernel runs too.
// Tensor-core products (mma.sync / wgmma) are left for a later change.

#include "encoder_tile.cuh"

namespace {

struct NetParams {
  const float* leaf[MAX_LEAVES];
  float* out;
  int head_dim;
};

struct EncoderArgs {
  const float* x;
  int S;
  float scale;
  TokenLayout lay;
  NetParams net[2];
};

__global__ void __launch_bounds__(NTHREADS)
    encoder_fwd_kernel(const __grid_constant__ EncoderArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileBufs B = fwd_bufs(smem_raw, args.lay.n_tokens, args.lay.obs_pad);
  const NetParams& net = args.net[blockIdx.y];
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * TR;
  load_rows(B.xs, args.x, args.S, args.lay, row0, j);
  __syncthreads();
  tile_forward(args.lay, net.leaf, args.scale, B, j);
  // the head; ragged rows never stored
  const int base = 2 * args.lay.n_groups;
  tile_head(B.Y2b, net.leaf[base + 18], net.leaf[base + 19], net.head_dim,
            net.out + (size_t)row0 * net.head_dim, net.head_dim, args.S - row0, j);
}

}  // namespace

// x: [S, obs_dim] f32; leaves: n_nets * n_leaves device pointers (canonical
// order of mupe_tpu_torch/ops/fused_encoder.py); outs: n_nets device
// pointers to [S, head_dims[i]] f32.  Returns a cudaError_t.
extern "C" int mupe_encoder_forward(const float* x, int S, int obs_dim, int n_groups,
                                    const int* group_k, const int* group_d, int n_nets,
                                    const void* const* leaves, int n_leaves,
                                    float* const* outs, const int* head_dims,
                                    void* stream) {
  if (n_nets < 1 || n_nets > 2 || n_groups < 1 || n_groups > MAX_GROUPS ||
      n_leaves != 2 * n_groups + N_FIXED || obs_dim < 1 || obs_dim > MAX_OBS || S < 0)
    return (int)cudaErrorInvalidValue;
  EncoderArgs args = {};
  if (!make_layout(obs_dim, n_groups, group_k, group_d, args.lay))
    return (int)cudaErrorInvalidValue;
  args.x = x;
  args.S = S;
  args.scale = (float)(1.0 / 11.313708498984761);  // 1 / sqrt(E)
  for (int n = 0; n < n_nets; ++n) {
    if (head_dims[n] < 1 || head_dims[n] > MAX_HEAD) return (int)cudaErrorInvalidValue;
    for (int l = 0; l < n_leaves; ++l)
      args.net[n].leaf[l] = static_cast<const float*>(leaves[n * n_leaves + l]);
    args.net[n].out = outs[n];
    args.net[n].head_dim = head_dims[n];
  }
  if (S == 0) return (int)cudaSuccess;
  const size_t smem = fwd_smem_bytes(args.lay.n_tokens, args.lay.obs_pad);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + TR - 1) / TR, n_nets);
  encoder_fwd_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
