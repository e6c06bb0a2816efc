// Encoder + linear head backward (PartialAttentionEncoder) for one or two
// networks over the same packed observation rows, stage A: the forward
// recomputed and the chain of data gradients per row tile, on the tensor
// cores; the parameter gradients of sum(out . dout) that are column sums
// (biases, LayerNorm) or the head's go straight to the gradient vectors, and
// the bf16 operands of every `_mm_tn` weight product go to staging buffers,
// which stage B (weight_grad.cu) multiplies.  The cotangent for the rows is
// not computed (observations are data).
//
// Replaces the TPU kernels mupe_tpu/ops/fused_encoder.py `_bwd_kernel` (one
// network, gridDim.y = 1) and `_pair_bwd_kernel` (actor and critic in one
// launch, gridDim.y = 2), with weight_grad.cu.  Per row tile it recomputes
// `_forward_core` (fused_encoder.py:278-364) and runs `_backward_core`
// (:377-463) at its rounding points: both operands of every `_mm_tn` /
// `_mm_nt` are bf16 (dout included), the k and v cotangent blocks are bf16,
// LN0's normalised value is bf16, the LayerNorm backward, q, the scores, the
// softmax and its backward are f32, and the bias and LayerNorm column sums
// add f32 values.  The tile code is `tc_forward` / `tc_backward` of
// encoder_bwd_tile.cuh.
//
// What bounds it on an H100: with the weight products moved to stage B, a
// row costs ~540K multiply-adds per network on the tensor cores (the forward
// again and the backward's data products) and writes 8 KB of staged bf16
// operands; 0.16 ms for the pair at S = 49,152 at the bf16 peak.  In
// practice the chain of ~45 dependent steps a tile, each a small product or
// a row reduction between __syncthreads, bounds it, at the issue rate of
// the CUDA cores' share (LayerNorm, softmax, the attention sums, staging):
// a block holds one 16-row tile in ~225 KB of shared memory (the residuals,
// the two weight slots), so one block of 8 warps runs per SM; where 16 rows
// do not fit (7 or 8 tokens, or wide embeds), the tile has 8; past 8 tokens
// (up to 16) the 8-row tile keeps LN0's n in a per-block scratch in device
// memory (32 KB a block, in L2), which brings it from ~236 KB to ~203 KB;
// past 16 tokens or 160 columns, or a group wider than 128, the embed kernel
// writes every token's bf16 embed (and stages the x slices) and the
// streamed 8-row tile (~165 KB) recomputes LN0 from it in each of its
// passes over the chunks of 8 tokens (encoder_bwd_tile.cuh).  Design: a
// persistent grid of one block per SM (shared by the networks); block b
// walks the row tiles b, b + G, ... and keeps its column sums in registers,
// written once to its two slices of a [2G, P] workspace that
// `sum_segments_kernel` sums in block order: two launches on the same inputs
// give the same bits, without float atomics.  Rows past S run on zero rows
// with a zero cotangent; their staged values are zeros.

#include "encoder_bwd_tile.cuh"

namespace {

struct ANet {
  const float* leaf[MAX_LEAVES];  // f32 leaves, canonical order
  WSeq seq;                       // the bf16 weights a tile loads, in order
  const __nv_bfloat16* wh;        // bf16 head weight [E][hd]
  const float* dout;              // [S, hd]
  __nv_bfloat16* st[N_STAGED + MAX_GROUPS];  // staged operands, then the groups' x slices
  float* ws;                      // [G][colsum_floats] per-block slices
  int head_dim;
};

struct AArgs {
  const float* x;
  __nv_bfloat16* n0;  // past TOK_NARROW tokens: each block's scratch for LN0's n
  int S;
  int s_pad;
  int n_tiles;
  float scale;
  TcLayout L;     // the tile instances'
  GroupLayout G;  // the streamed one's
  ANet net[2];
  StreamNet sn[2];
};

// A tile's head cotangent into B.DOUT (f32) and B.DOb (bf16), zeros past hd
// and past S.
template <int TA>
__device__ __forceinline__ void load_dout(const TcBufs& B, const float* dout, int hd, int S,
                                          int row0, int j) {
  for (int idx = j; idx < TA * MAX_HEAD; idx += NTA) {
    const int r = idx / MAX_HEAD;
    const int o = idx - r * MAX_HEAD;
    const int row = row0 + r;
    const float d = o < hd && row < S ? dout[(size_t)row * hd + o] : 0.f;
    B.DOUT[idx] = d;
    B.DOb[idx] = __float2bfloat16_rn(d);
  }
}

template <int TA, int NTM>
__global__ void __launch_bounds__(NTA, 1)
    encoder_bwd_stage_a(const __grid_constant__ AArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout& L = a.L;
  const ANet& net = a.net[blockIdx.y];
  TcBufs B;
  tc_carve<TA, false, NTM>(smem, L.lay.n_tokens, L.xw, &B);
  if (NTM > TOK_NARROW)
    B.N0b = a.n0 + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * NTM * TA * E;
  const int j = threadIdx.x;
  const int hd = net.head_dim;
  load_head(B.WH[0], net.wh, hd, j);
  ColSums cs;
  colsums_zero(cs);
  Ring R;
  R.start(smem, net.seq, j);
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int row0 = tile * TA;
    tc_load_rows<TA>(L, B, a.x, a.S, row0, net.st + N_STAGED, a.s_pad, j);
    load_dout<TA>(B, net.dout, hd, a.S, row0, j);
    __syncthreads();
    tc_forward<TA, false, NTM>(L, net.leaf, a.scale, B, R, net.seq, net.st, a.s_pad, row0, a.S,
                               j);
    tc_backward<TA, NTM>(L, net.leaf, B.WH[0], hd, a.scale, B, R, net.seq, net.st, a.s_pad,
                         row0, a.S, cs, j);
  }
  cp_async_wait<0>();
  colsums_store(cs, net.ws + (size_t)blockIdx.x * 2 * colsum_floats(L.lay.n_groups, hd),
                L.lay.n_groups, hd, j);
}

__global__ void __launch_bounds__(NTA, 1)
    encoder_bwd_stage_a_stream(const __grid_constant__ AArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ANet& net = a.net[blockIdx.y];
  const StreamNet& sn = a.sn[blockIdx.y];
  TcBufs B;
  ts_carve<false>(smem, &B);
  const int j = threadIdx.x;
  const int hd = net.head_dim;
  load_head(B.WH[0], net.wh, hd, j);
  ColSums cs;
  colsums_zero(cs);
  Ring R;
  R.start(smem, net.seq, j);
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int row0 = tile * TS_ROWS;
    B.P = sn.p + (size_t)tile * TS_ROWS * a.G.n_tokens;
    B.DS = sn.ds + (size_t)tile * TS_ROWS * a.G.n_tokens;
    load_dout<TS_ROWS>(B, net.dout, hd, a.S, row0, j);
    ts_forward<false>(a.G, net.leaf, a.scale, B, R, net.seq, sn.e, net.st, a.s_pad, row0, a.S, j);
    ts_backward(a.G, net.leaf, B.WH[0], hd, a.scale, B, R, net.seq, sn.e, net.st, a.s_pad, row0,
                a.S, cs, j);
  }
  cp_async_wait<0>();
  colsums_store(cs, net.ws + (size_t)blockIdx.x * 2 * colsum_floats(a.G.n_groups, hd),
                a.G.n_groups, hd, j);
}

// The stage-A instance for these tile rows and tokens.
void (*stage_a_kernel(int ta, int n_tokens))(AArgs) {
  if (n_tokens > TOK_NARROW) return encoder_bwd_stage_a<8, MAX_TOK>;
  return ta == 16 ? encoder_bwd_stage_a<16, TOK_NARROW> : encoder_bwd_stage_a<8, TOK_NARROW>;
}

// The stage-A kernel for these groups (tile or streamed: `*tile`), its tile
// rows and shared memory; false on bad shapes.
bool stage_a_plan(int obs_dim, int n_groups, const int* group_k, const int* group_d, TcLayout& L,
                  bool* tile, void (**kernel)(AArgs), int* ta, size_t* smem) {
  *tile = tile_layout(obs_dim, n_groups, group_k, group_d, L);
  if (*tile) {
    if (!stage_a_layout(obs_dim, n_groups, group_k, group_d, 0, L, ta, smem)) return false;
    *kernel = stage_a_kernel(*ta, L.lay.n_tokens);
    return true;
  }
  *kernel = encoder_bwd_stage_a_stream;
  *ta = TS_ROWS;
  *smem = ts_carve<false>(nullptr, nullptr);
  return *smem <= (size_t)smem_optin();
}

}  // namespace

// Writes to *blocks the number of per-network blocks (= workspace slices)
// that mupe_encoder_bwd_operands wants for these shapes (s_pad: the staged
// rows, a multiple of 32 and at least S).  Returns a cudaError_t.
extern "C" int mupe_encoder_bwd_blocks(int obs_dim, int n_groups, const int* group_k,
                                       const int* group_d, int n_nets, int s_pad, int* blocks) {
  TcLayout L;
  GroupLayout G;
  bool tile = false;
  void (*kernel)(AArgs) = nullptr;
  size_t smem = 0;
  int ta = 0;
  if (n_nets < 1 || n_nets > 2 || s_pad < 0 || s_pad % 32 ||
      !make_group_layout(obs_dim, n_groups, group_k, group_d, G) ||
      !stage_a_plan(obs_dim, n_groups, group_k, group_d, L, &tile, &kernel, &ta, &smem))
    return (int)cudaErrorInvalidValue;
  return (int)stage_a_blocks(kernel, smem, ta, n_nets, s_pad, blocks);
}

// Writes to *bytes the streaming scratch that mupe_encoder_bwd_operands
// wants for these groups, n_nets networks and s_pad rows: 0 where the tile
// instances take them.  Returns a cudaError_t.
extern "C" int mupe_encoder_bwd_scratch(int obs_dim, int n_groups, const int* group_k,
                                        const int* group_d, int n_nets, int s_pad,
                                        long long* bytes) {
  TcLayout L;
  GroupLayout G;
  if (!make_group_layout(obs_dim, n_groups, group_k, group_d, G))
    return (int)cudaErrorInvalidValue;
  *bytes = tile_layout(obs_dim, n_groups, group_k, group_d, L)
               ? 0 : (long long)(n_nets * stream_bytes(G.n_tokens, s_pad, true));
  return (int)cudaSuccess;
}

// x: [S, obs_dim] f32 (s_pad >= S staged rows, a multiple of 32); leaves:
// n_nets * n_leaves device pointers (canonical order of
// mupe_tpu_torch/ops/fused_encoder.py; the weights 16-byte aligned); wbf:
// n_nets * 8 bf16 copies: the embeds' weights stacked (each group's rows
// padded to a multiple of 16 with zero rows), wq, wk, wv, wo, w1, w2, wh;
// douts: n_nets pointers to [S, head_dims[i]] f32; staged: n_nets * (11 +
// n_groups) bf16 buffers: h, dk, dv, de [n_tok, s_pad, 128], att, y1, f, dq,
// dr1, dpre1, dr2 [s_pad, 128], then per group its tokens' x slices [k,
// s_pad, round16(d)]; grads: n_nets flat f32 gradient vectors of n_params[i]
// floats, of which this fills every leaf but the weights of the staged
// products; ws: f32 workspace of 2 * blocks * sum(colsum floats) floats
// (two slices a block), blocks as mupe_encoder_bwd_blocks gave it, then past
// 8 tokens of the tile instances n_nets * blocks * 16 * 8 * 128 bf16 values
// of scratch; scratch: the bytes that mupe_encoder_bwd_scratch gives (none
// for the tile instances).  Returns a cudaError_t.
extern "C" int mupe_encoder_bwd_operands(const float* x, int S, int s_pad, int obs_dim,
                                         int n_groups, const int* group_k, const int* group_d,
                                         int n_nets, const void* const* leaves, int n_leaves,
                                         const void* const* wbf, const float* const* douts,
                                         const int* head_dims, void* const* staged,
                                         float* const* grads, const int* n_params, float* ws,
                                         int blocks, void* scratch, void* stream) {
  AArgs a = {};
  bool tile = false;
  void (*kernel)(AArgs) = nullptr;
  size_t smem = 0;
  int ta = 0;
  if (n_nets < 1 || n_nets > 2 || n_leaves != 2 * n_groups + N_FIXED || S < 0 || s_pad < S ||
      s_pad % 32 || blocks < 1 || !make_group_layout(obs_dim, n_groups, group_k, group_d, a.G) ||
      !stage_a_plan(obs_dim, n_groups, group_k, group_d, a.L, &tile, &kernel, &ta, &smem) ||
      (!tile && !scratch))
    return (int)cudaErrorInvalidValue;
  a.x = x;
  a.S = S;
  a.s_pad = s_pad;
  a.n_tiles = s_pad / ta;
  a.scale = (float)(1.0 / 11.313708498984761);  // 1 / sqrt(E)
  EmbedArgs e = {};
  e.x = x;
  e.S = S;
  e.s_pad = s_pad;
  e.G = a.G;
  SegArgs seg = {};
  size_t ws_off = 0;
  const int nb = N_BW;
  const int ns = N_STAGED + n_groups;
  for (int n = 0; n < n_nets; ++n) {
    ANet& net = a.net[n];
    int off[MAX_LEAVES], P = 0;
    if (!leaf_offsets(n_groups, group_d, head_dims[n], off, &P) || P != n_params[n])
      return (int)cudaErrorInvalidValue;
    for (int l = 0; l < n_leaves; ++l)
      net.leaf[l] = static_cast<const float*>(leaves[n * n_leaves + l]);
    const __nv_bfloat16* const* wb = reinterpret_cast<const __nv_bfloat16* const*>(wbf) + n * nb;
    for (int i = 0; i < ns; ++i) net.st[i] = static_cast<__nv_bfloat16*>(staged[n * ns + i]);
    if (tile) {
      seq_append(net.seq, a.L, wb, true);
    } else {
      ts_seq_append(net.seq, nullptr, wb, n_groups, true);
      a.sn[n] = stream_net(scratch, n * stream_bytes(a.G.n_tokens, s_pad, true), a.G.n_tokens,
                           s_pad, true);
      if (!embed_net(e, n, net.leaf, a.sn[n].e, net.st + N_STAGED))
        return (int)cudaErrorInvalidValue;
    }
    net.wh = wb[B_H];
    net.dout = douts[n];
    net.head_dim = head_dims[n];
    net.ws = ws + ws_off;
    colsum_segments(seg, net.ws, 2 * blocks, n_groups, head_dims[n], off, grads[n]);
    ws_off += (size_t)2 * blocks * colsum_floats(n_groups, head_dims[n]);
  }
  a.n0 = reinterpret_cast<__nv_bfloat16*>(ws + ws_off);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!tile && (err = launch_embed(e, n_nets, s)) != cudaSuccess) return (int)err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  kernel<<<dim3(blocks, n_nets), NTA, smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sum_segments(seg, s);
}
