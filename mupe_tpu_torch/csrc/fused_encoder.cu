// Encoder + linear head forward (PartialAttentionEncoder) for one or two
// networks over the same packed observation rows, on the tensor cores.
//
// Replaces the TPU kernels mupe_tpu/ops/fused_encoder.py `_fwd_kernel`
// (one network, the bootstrap value) and `_pair_fwd_kernel` (actor and
// critic together, the rollout's act).  It computes `_forward_core`
// (fused_encoder.py:278-364) for a tile of rows:
//   per-token embed -> LN0 -> q (query token only), k, v (all tokens)
//   -> single-query softmax over the tokens -> out-proj + residual -> LN1
//   -> tanh-GELU FFN + residual -> LN2 -> linear head.
//
// Numerics follow `_forward_core` at its rounding points: every matmul
// operand is rounded to bf16 and summed in f32 (`_mm`, the head included);
// the embeds, h_all, ks_all and vs_all are bf16 values; h0 (the query
// token's LN0 output) stays f32 for the residual; q, the scores, the softmax
// and the LayerNorm statistics (var = E[x^2] - m^2, eps 1e-6) are f32.  The
// tile code is `tc_forward` / `tc_head` of encoder_bwd_tile.cuh in its
// forward-only mode: the products run on the tensor cores (mma.sync
// m16n8k16) exactly as in the backward's recomputed forward, so the backward
// differentiates the outputs this kernel gives.
//
// What bounds it on an H100: a row costs ~270K multiply-adds per network
// (the k/v projections of all tokens are 3/4 of it) and reads 56 floats, so
// its bound is the tensor cores' rate; in practice the tile's chain of ~20
// steps between __syncthreads and its weight fills.  Design: one block of 8
// warps per tile of TA rows and per network (blockIdx.y).  The weights are
// read from the f32 leaves (~100K floats a network, resident in L2) and
// rounded to bf16 as they fill one shared-memory slot (`Slot`), so a call
// makes no copy of them; without the backward's residuals a 16-row tile
// takes ~111 KB of shared memory at up to 6 tokens, so two blocks share an
// SM and one computes while the other fills its slot.  Specs whose 16-row
// tile does not allow two blocks an SM (7 or 8 tokens, wide embeds) take
// 8-row tiles; specs of 9 to 16 tokens an instance of the 8-row tile sized
// for 16 (~118 KB at 16 tokens, one block an SM).  Past the tile instances'
// limits (more than 16 tokens or 160 columns, a group wider than 128) a
// first launch writes every token's bf16 embed to device memory and the
// streamed instance reads it a chunk of 8 tokens at a time
// (encoder_bwd_tile.cuh), in 8-row tiles of ~83 KB, two blocks an SM.  Rows
// past S are computed on zeros and never stored.

#include "encoder_bwd_tile.cuh"

namespace {

struct FNet {
  const float* leaf[MAX_LEAVES];
  WSeq seq;  // the f32 weights a tile loads, in order
  float* out;
  int head_dim;
};

struct FArgs {
  const float* x;
  int S;
  int s_pad;
  float scale;
  TcLayout L;      // the tile instances'
  GroupLayout G;   // the streamed one's
  FNet net[2];
  StreamNet sn[2];
};

template <int TA, int NTM>
__global__ void __launch_bounds__(NTA, 2) encoder_fwd_kernel(const __grid_constant__ FArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout& L = a.L;
  const FNet& net = a.net[blockIdx.y];
  TcBufs B;
  tc_carve<TA, true, NTM>(smem, L.lay.n_tokens, L.xw, &B);
  Slot src = {reinterpret_cast<__nv_bfloat16*>(smem), 0};
  const int j = threadIdx.x;
  const int hd = net.head_dim;
  const int base = 2 * L.lay.n_groups;
  const int row0 = blockIdx.x * TA;
  load_head(B.WH[0], net.leaf[base + 18], hd, j);
  tc_load_rows<TA>(L, B, a.x, a.S, row0, nullptr, 0, j);
  tc_forward<TA, true, NTM>(L, net.leaf, a.scale, B, src, net.seq, nullptr, 0, row0, a.S, j);
  tc_head<TA>(B, B.WH[0], net.leaf[base + 19], hd, net.out + (size_t)row0 * hd, hd,
              a.S - row0, j);
}

__global__ void __launch_bounds__(NTA, 2)
    encoder_fwd_stream_kernel(const __grid_constant__ FArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FNet& net = a.net[blockIdx.y];
  TcBufs B;
  ts_carve<true>(smem, &B);
  B.P = a.sn[blockIdx.y].p + (size_t)blockIdx.x * TS_ROWS * a.G.n_tokens;
  Slot src = {reinterpret_cast<__nv_bfloat16*>(smem), 0};
  const int j = threadIdx.x;
  const int hd = net.head_dim;
  const int base = 2 * a.G.n_groups;
  const int row0 = blockIdx.x * TS_ROWS;
  load_head(B.WH[0], net.leaf[base + 18], hd, j);
  ts_forward<true>(a.G, net.leaf, a.scale, B, src, net.seq, a.sn[blockIdx.y].e, nullptr, a.s_pad,
                   row0, a.S, j);
  tc_head<TS_ROWS>(B, B.WH[0], net.leaf[base + 19], hd, net.out + (size_t)row0 * hd, hd,
                   a.S - row0, j);
}

// Sets, once a device, every instance's shared-memory attribute to the most a
// block may have, so that no later call lowers it below another spec's
// carve; then picks the tile height by arithmetic: up to TOK_NARROW tokens
// 16 rows where two such blocks fit an SM's shared memory (their registers
// do, by the launch bounds), else 8; past it 8 rows of the MAX_TOK
// instance.  A call does no host work but its launch after the first.
constexpr int FWD_MAX_DEVICES = 64;

cudaError_t fwd_tile_rows(const TcLayout& L, int* ta) {
  static int sm_bytes[FWD_MAX_DEVICES] = {};  // 0: the device not set up yet
  static int reserved[FWD_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= FWD_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_bytes[dev] == 0) {
    int optin = 0, per_sm = 0, res = 0;
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&res, cudaDevAttrReservedSharedMemoryPerBlock, dev)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(encoder_fwd_kernel<16, TOK_NARROW>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(encoder_fwd_kernel<8, TOK_NARROW>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(encoder_fwd_kernel<8, MAX_TOK>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(encoder_fwd_stream_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess)
      return err;
    reserved[dev] = res;
    sm_bytes[dev] = per_sm;
  }
  const size_t s16 = tc_carve<16, true, TOK_NARROW>(nullptr, L.lay.n_tokens, L.xw, nullptr);
  *ta = L.lay.n_tokens <= TOK_NARROW && 2 * (s16 + reserved[dev]) <= (size_t)sm_bytes[dev] ? 16
                                                                                          : 8;
  return cudaSuccess;
}

}  // namespace

// Writes to *bytes the streaming scratch that mupe_encoder_forward wants for
// these groups, n_nets networks and s_pad rows: 0 where the tile instances
// take them.  Returns a cudaError_t.
extern "C" int mupe_encoder_forward_scratch(int obs_dim, int n_groups, const int* group_k,
                                            const int* group_d, int n_nets, int s_pad,
                                            long long* bytes) {
  TcLayout L;
  GroupLayout G;
  if (!make_group_layout(obs_dim, n_groups, group_k, group_d, G))
    return (int)cudaErrorInvalidValue;
  *bytes = tile_layout(obs_dim, n_groups, group_k, group_d, L)
               ? 0 : (long long)(n_nets * stream_bytes(G.n_tokens, s_pad, false));
  return (int)cudaSuccess;
}

// x: [S, obs_dim] f32; leaves: n_nets * n_leaves device pointers (canonical
// order of mupe_tpu_torch/ops/fused_encoder.py; the weights 16-byte
// aligned); outs: n_nets device pointers to [S, head_dims[i]] f32; scratch:
// the bytes that mupe_encoder_forward_scratch gives for s_pad rows (s_pad >=
// S, a multiple of 32; none for the tile instances).  Returns a cudaError_t.
extern "C" int mupe_encoder_forward(const float* x, int S, int s_pad, int obs_dim, int n_groups,
                                    const int* group_k, const int* group_d, int n_nets,
                                    const void* const* leaves, int n_leaves,
                                    float* const* outs, const int* head_dims, void* scratch,
                                    void* stream) {
  if (n_nets < 1 || n_nets > 2 || n_groups < 1 || n_groups > MAX_GROUPS ||
      n_leaves != 2 * n_groups + N_FIXED || S < 0 || s_pad < S || s_pad % 32)
    return (int)cudaErrorInvalidValue;
  FArgs a = {};
  if (!make_group_layout(obs_dim, n_groups, group_k, group_d, a.G))
    return (int)cudaErrorInvalidValue;
  const bool tile = tile_layout(obs_dim, n_groups, group_k, group_d, a.L);
  if (!tile && !scratch) return (int)cudaErrorInvalidValue;
  a.x = x;
  a.S = S;
  a.s_pad = s_pad;
  a.scale = (float)(1.0 / 11.313708498984761);  // 1 / sqrt(E)
  EmbedArgs e = {};
  e.x = x;
  e.S = S;
  e.s_pad = s_pad;
  e.G = a.G;
  for (int n = 0; n < n_nets; ++n) {
    if (head_dims[n] < 1 || head_dims[n] > MAX_HEAD) return (int)cudaErrorInvalidValue;
    FNet& net = a.net[n];
    for (int l = 0; l < n_leaves; ++l)
      net.leaf[l] = static_cast<const float*>(leaves[n * n_leaves + l]);
    if (tile) {
      seq_append_f32(net.seq, a.L, net.leaf);
    } else {
      ts_seq_append(net.seq, net.leaf, nullptr, n_groups, false);
      a.sn[n] = stream_net(scratch, n * stream_bytes(a.G.n_tokens, s_pad, false), a.G.n_tokens,
                           s_pad, false);
      if (!embed_net(e, n, net.leaf, a.sn[n].e, nullptr)) return (int)cudaErrorInvalidValue;
    }
    for (int p = 0; p < net.seq.n_parts; ++p)  // the slot's float4 loads
      if (reinterpret_cast<uintptr_t>(net.seq.part[p].src) % 16)
        return (int)cudaErrorInvalidValue;
    net.out = outs[n];
    net.head_dim = head_dims[n];
  }
  if (S == 0) return (int)cudaSuccess;
  int ta = 0;
  cudaError_t err = fwd_tile_rows(a.L, &ta);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tile) {
    if ((err = launch_embed(e, n_nets, s)) != cudaSuccess) return (int)err;
    encoder_fwd_stream_kernel<<<dim3((S + TS_ROWS - 1) / TS_ROWS, n_nets), NTA,
                                ts_carve<true>(nullptr, nullptr), s>>>(a);
    return (int)cudaGetLastError();
  }
  const dim3 grid((S + ta - 1) / ta, n_nets);
  const int n_tokens = a.L.lay.n_tokens;
  if (n_tokens > TOK_NARROW)
    encoder_fwd_kernel<8, MAX_TOK><<<grid, NTA,
        tc_carve<8, true, MAX_TOK>(nullptr, n_tokens, a.L.xw, nullptr), s>>>(a);
  else if (ta == 16)
    encoder_fwd_kernel<16, TOK_NARROW><<<grid, NTA,
        tc_carve<16, true, TOK_NARROW>(nullptr, n_tokens, a.L.xw, nullptr), s>>>(a);
  else
    encoder_fwd_kernel<8, TOK_NARROW><<<grid, NTA,
        tc_carve<8, true, TOK_NARROW>(nullptr, n_tokens, a.L.xw, nullptr), s>>>(a);
  return (int)cudaGetLastError();
}
