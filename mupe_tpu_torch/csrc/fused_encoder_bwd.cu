// Encoder + linear head backward (PartialAttentionEncoder) for one or two
// networks over the same packed observation rows: the parameter gradients of
// sum(out . dout), summed over the rows.  The cotangent for the rows is not
// computed (observations are data).
//
// Replaces the TPU kernels mupe_tpu/ops/fused_encoder.py `_bwd_kernel` (one
// network, gridDim.y = 1) and `_pair_bwd_kernel` (actor and critic in one
// launch, gridDim.y = 2).  Per row tile it recomputes `_forward_core`
// (fused_encoder.py:278-364) and runs `_backward_core` (:377-463) at its
// rounding points: both operands of every `_mm_tn` / `_mm_nt` are bf16
// (dout included), the k and v cotangent blocks are bf16, LN0's normalised
// value is bf16, the LayerNorm backward, q, the scores, the softmax and its
// backward are f32, and the bias and LayerNorm column sums add f32 values.
//
// What bounds it on an H100: arithmetic, then the gradient traffic.  A row
// costs ~810K multiply-adds per network (the forward again, then twice its
// products), and the 106,244 gradients of a network (425 KB) do not fit a
// block's shared memory.  The TPU kernel adds each tile's gradients into
// VMEM-resident outputs because a Pallas grid runs in order; CUDA blocks do
// not, and float atomics would make the sums depend on scheduling.  Design:
// a persistent grid of as many blocks as fit on the card; block b walks the
// row tiles b, b + G, ... (8 rows each, the forward kernel's tile code) and
// adds each tile's gradients, thread j owning column j, into its own slice of
// a [G, P] workspace in device memory.  A second kernel then sums the slices
// in block order, so two launches on the same inputs give the same bits.
// The tile's activations stay in shared memory; weights stream from L1/L2,
// the products with a transposed weight reading a transposed copy that the
// wrapper makes, so that every product's weight reads are coalesced.
// Rows past S run on zero rows with a zero cotangent and add exact zeros.
// The tile code is `tile_forward<true>` and `tile_backward` of
// encoder_tile.cuh.  Tensor-core products are left for a later change.

#include "encoder_tile.cuh"

namespace {

struct BwdNet {
  const float* leaf[MAX_LEAVES];
  const float* wt[N_T];  // W^T [E][E] of wq, wk, wv, wo, w1, w2
  const float* dout;  // [S, head_dim]
  float* ws;          // [G][P] per-block gradient slices
  int off[MAX_LEAVES];  // offset of each leaf's gradient in a slice
  int head_dim;
  int P;
};

struct BwdArgs {
  const float* x;
  int S;
  int n_tiles;
  float scale;
  TokenLayout lay;
  BwdNet net[2];
};

__global__ void __launch_bounds__(NTHREADS)
    encoder_bwd_kernel(const __grid_constant__ BwdArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TokenLayout& lay = args.lay;
  const BwdBufs B = bwd_bufs(smem_raw, lay.n_tokens, lay.obs_pad);
  const BwdNet& net = args.net[blockIdx.y];
  const int hd = net.head_dim;
  const int j = threadIdx.x;
  float* ws = net.ws + (size_t)blockIdx.x * net.P;
  for (int p = j; p < net.P; p += NTHREADS) ws[p] = 0.f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < args.n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    load_rows(B.t.xs, args.x, args.S, lay, row0, j);
    for (int idx = j; idx < TR * hd; idx += NTHREADS) {
      const int r = idx / hd;
      const int o = idx - r * hd;
      const int row = row0 + r;
      B.DOUT[r * MAX_HEAD + o] = row < args.S ? net.dout[(size_t)row * hd + o] : 0.f;
    }
    __syncthreads();
    tile_forward<true>(lay, net.leaf, args.scale, B.t, j);
    tile_backward(lay, net.leaf, net.wt, net.off, hd, args.scale, B, ws, j);
  }
}

bool net_offsets(const TokenLayout& lay, const int* group_d, int hd, BwdNet& net) {
  net.head_dim = hd;
  return leaf_offsets(lay, group_d, hd, net.off, &net.P);
}

// Blocks per network of the persistent grid (`persistent_blocks`).
cudaError_t grid_blocks(int n_tokens, int obs_pad, int n_nets, int S, int* blocks) {
  return persistent_blocks(encoder_bwd_kernel, bwd_smem_bytes(n_tokens, obs_pad), n_nets, S,
                           blocks);
}

}  // namespace

// Writes to *blocks the number of per-network blocks (= workspace slices)
// that mupe_encoder_backward wants for these shapes.  Returns a cudaError_t.
extern "C" int mupe_encoder_backward_blocks(int n_groups, int n_tokens, int obs_dim, int n_nets,
                                            int S, int* blocks) {
  if (n_groups < 1 || n_groups > MAX_GROUPS || n_tokens < 1 || n_tokens > MAX_TOK ||
      obs_dim < 1 || obs_dim > MAX_OBS || n_nets < 1 || n_nets > 2 || S < 0)
    return (int)cudaErrorInvalidValue;
  return (int)grid_blocks(n_tokens, (obs_dim + 3) / 4 * 4, n_nets, S, blocks);
}

// x: [S, obs_dim] f32; leaves: n_nets * n_leaves device pointers (canonical
// order of mupe_tpu_torch/ops/fused_encoder.py); douts: n_nets pointers to
// [S, head_dims[i]] f32; wts: n_nets * 6 pointers to the transposes [E, E] of
// wq, wk, wv, wo, w1, w2; grads: n_nets pointers to flat f32 gradient vectors
// of n_params[i] floats (the leaves' gradients concatenated in canonical
// order); ws: f32 workspace of blocks * sum(n_params) floats, blocks as
// mupe_encoder_backward_blocks gave it.  Returns a cudaError_t.
extern "C" int mupe_encoder_backward(const float* x, int S, int obs_dim, int n_groups,
                                     const int* group_k, const int* group_d, int n_nets,
                                     const void* const* leaves, int n_leaves,
                                     const float* const* douts, const int* head_dims,
                                     const void* const* wts, float* const* grads,
                                     const int* n_params, float* ws, int blocks, void* stream) {
  if (n_nets < 1 || n_nets > 2 || n_leaves != 2 * n_groups + N_FIXED || S < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  BwdArgs args = {};
  if (!make_layout(obs_dim, n_groups, group_k, group_d, args.lay))
    return (int)cudaErrorInvalidValue;
  args.x = x;
  args.S = S;
  args.n_tiles = (S + TR - 1) / TR;
  args.scale = (float)(1.0 / 11.313708498984761);  // 1 / sqrt(E)
  size_t ws_off = 0;
  for (int n = 0; n < n_nets; ++n) {
    BwdNet& net = args.net[n];
    if (!net_offsets(args.lay, group_d, head_dims[n], net) || net.P != n_params[n])
      return (int)cudaErrorInvalidValue;
    for (int l = 0; l < n_leaves; ++l)
      net.leaf[l] = static_cast<const float*>(leaves[n * n_leaves + l]);
    for (int w = 0; w < N_T; ++w) net.wt[w] = static_cast<const float*>(wts[n * N_T + w]);
    net.dout = douts[n];
    net.ws = ws + ws_off;
    ws_off += (size_t)blocks * net.P;
  }
  const size_t smem = bwd_smem_bytes(args.lay.n_tokens, args.lay.obs_pad);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  encoder_bwd_kernel<<<dim3(blocks, n_nets), NTHREADS, smem, s>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int n = 0; n < n_nets; ++n) {
    err = sum_slices(args.net[n].ws, blocks, args.net[n].P, grads[n], s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
