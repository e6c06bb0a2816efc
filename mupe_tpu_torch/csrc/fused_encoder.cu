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
// Tensor-core products (mma.sync / wgmma) are left for a later change.

#include "common.cuh"

namespace {

struct NetParams {
  const float* leaf[MAX_LEAVES];
  float* out;
  int head_dim;
};

struct EncoderArgs {
  const float* x;
  int S;
  int obs_dim;
  int obs_pad;
  int n_groups;
  int n_tokens;
  float scale;
  int tok_off[MAX_TOK];
  int tok_dim[MAX_TOK];
  int tok_group[MAX_TOK];
  NetParams net[2];
};

__global__ void __launch_bounds__(NTHREADS)
    encoder_fwd_kernel(const __grid_constant__ EncoderArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = args.n_tokens;
  const int ntr = nt * TR;
  __nv_bfloat16* Hb = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ntr][E]
  __nv_bfloat16* Kb = Hb + ntr * E;                                 // [ntr][E]
  __nv_bfloat16* Vb = Kb + ntr * E;                                 // [ntr][E]
  __nv_bfloat16* Rb = Vb + ntr * E;  // [TR][E] rounded operand of the next matmul
  float* xs = reinterpret_cast<float*>(Rb + TR * E);  // [TR][obs_pad]
  float* H0 = xs + TR * args.obs_pad;                 // [TR][E] h0, then r1 / y1
  float* Q = H0 + TR * E;                             // [TR][E] q, then r2
  float* P = Q + TR * E;                              // [TR][MAX_TOK]

  const NetParams& net = args.net[blockIdx.y];
  const float* const* L = net.leaf;
  const int base = 2 * args.n_groups;
  const float* g0 = L[base + 0];
  const float* b0 = L[base + 1];
  const float* wq = L[base + 2];
  const float* bq = L[base + 3];
  const float* wk = L[base + 4];
  const float* bk = L[base + 5];
  const float* wv = L[base + 6];
  const float* bv = L[base + 7];
  const float* wo = L[base + 8];
  const float* bo = L[base + 9];
  const float* g1 = L[base + 10];
  const float* b1 = L[base + 11];
  const float* w1 = L[base + 12];
  const float* bf1 = L[base + 13];
  const float* w2 = L[base + 14];
  const float* bf2 = L[base + 15];
  const float* g2 = L[base + 16];
  const float* b2 = L[base + 17];
  const float* wh = L[base + 18];
  const float* bh = L[base + 19];

  const int j = threadIdx.x;
  const int warp = j >> 5;
  const int lane = j & 31;
  const int nwarps = NTHREADS / 32;
  const int row0 = blockIdx.x * TR;

  // 1. the tile's observation rows, rounded to bf16 (operands of the embeds)
  for (int idx = j; idx < TR * args.obs_dim; idx += NTHREADS) {
    const int r = idx / args.obs_dim;
    const int c = idx - r * args.obs_dim;
    const int row = row0 + r;
    xs[r * args.obs_pad + c] =
        row < args.S ? bf16r(args.x[(size_t)row * args.obs_dim + c]) : 0.f;
  }
  __syncthreads();

  // 2. per-token embeds -> bf16, token-major rows t*TR + r
  for (int t = 0; t < nt; ++t) {
    const int g = args.tok_group[t];
    const int off = args.tok_off[t];
    const int d = args.tok_dim[t];
    const float* wg = L[2 * g];
    const float bgj = __ldg(L[2 * g + 1] + j);
    float acc[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float w = bf16r(__ldg(wg + c * E + j));
#pragma unroll
      for (int r = 0; r < TR; ++r) acc[r] = fmaf(xs[r * args.obs_pad + off + c], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) Hb[(t * TR + r) * E + j] = __float2bfloat16_rn(acc[r] + bgj);
  }
  __syncthreads();

  // 3. LN0 over every token row, in place; token 0's f32 output kept as h0
  for (int rt = warp; rt < ntr; rt += nwarps) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(Hb[rt * E + lane * 4 + i]);
    ln_row(v, g0, b0, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Hb[rt * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
      if (rt < TR) H0[rt * E + lane * 4 + i] = v[i];
    }
  }
  __syncthreads();

  // 4. q from the query token (its bf16 rounding is h_all's)
  {
    const float* const W[1] = {wq};
    float acc[1][TR];
    mm_tile<1>(Hb, 0, W, j, acc);
    const float bqj = __ldg(bq + j);
#pragma unroll
    for (int r = 0; r < TR; ++r) Q[r * E + j] = acc[0][r] + bqj;
  }
  // 5. k and v of every token, rounded to bf16
  {
    const float* const W[2] = {wk, wv};
    const float bkj = __ldg(bk + j);
    const float bvj = __ldg(bv + j);
    for (int t = 0; t < nt; ++t) {
      float acc[2][TR];
      mm_tile<2>(Hb, t * TR, W, j, acc);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        Kb[(t * TR + r) * E + j] = __float2bfloat16_rn(acc[0][r] + bkj);
        Vb[(t * TR + r) * E + j] = __float2bfloat16_rn(acc[1][r] + bvj);
      }
    }
  }
  __syncthreads();

  // 6. scores q . k_t * scale
  for (int p = warp; p < TR * nt; p += nwarps) {
    const int r = p / nt;
    const int t = p - r * nt;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane * 4 + i;
      s = fmaf(Q[r * E + c], __bfloat162float(Kb[(t * TR + r) * E + c]), s);
    }
    s = warp_sum(s);
    if (lane == 0) P[r * MAX_TOK + t] = s * args.scale;
  }
  __syncthreads();

  // 7. softmax over the tokens, in the reference's order
  if (j < TR) {
    float* p = P + j * MAX_TOK;
    float smax = p[0];
    for (int t = 1; t < nt; ++t) smax = fmaxf(smax, p[t]);
    float e[MAX_TOK];
    float denom = 0.f;
    for (int t = 0; t < nt; ++t) {
      e[t] = expf(p[t] - smax);
      denom = t == 0 ? e[0] : denom + e[t];
    }
    const float recip = 1.0f / denom;
    for (int t = 0; t < nt; ++t) p[t] = e[t] * recip;
  }
  __syncthreads();

  // 8. attention output sum_t a_t v_t, rounded for the out-projection
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    float att = P[r * MAX_TOK] * __bfloat162float(Vb[r * E + j]);
    for (int t = 1; t < nt; ++t)
      att = fmaf(P[r * MAX_TOK + t], __bfloat162float(Vb[(t * TR + r) * E + j]), att);
    Rb[r * E + j] = __float2bfloat16_rn(att);
  }
  __syncthreads();

  // 9. out-projection + residual: r1 = h0 + o (into H0)
  {
    const float* const W[1] = {wo};
    float acc[1][TR];
    mm_tile<1>(Rb, 0, W, j, acc);
    const float boj = __ldg(bo + j);
#pragma unroll
    for (int r = 0; r < TR; ++r) H0[r * E + j] += acc[0][r] + boj;
  }
  __syncthreads();

  // 10. LN1: y1 f32 in H0, bf16 copy in Rb
  for (int r = warp; r < TR; r += nwarps) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = H0[r * E + lane * 4 + i];
    ln_row(v, g1, b1, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      H0[r * E + lane * 4 + i] = v[i];
      Rb[r * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
    }
  }
  __syncthreads();

  // 11. FFN first layer + tanh-GELU, rounded for the second layer
  {
    const float* const W[1] = {w1};
    float acc[1][TR];
    mm_tile<1>(Rb, 0, W, j, acc);
    const float bj = __ldg(bf1 + j);
    __syncthreads();  // every thread has read Rb
#pragma unroll
    for (int r = 0; r < TR; ++r) Rb[r * E + j] = __float2bfloat16_rn(gelu_tanh(acc[0][r] + bj));
  }
  __syncthreads();

  // 12. FFN second layer + residual: r2 = y1 + g2out (into Q)
  {
    const float* const W[1] = {w2};
    float acc[1][TR];
    mm_tile<1>(Rb, 0, W, j, acc);
    const float bj = __ldg(bf2 + j);
#pragma unroll
    for (int r = 0; r < TR; ++r) Q[r * E + j] = H0[r * E + j] + (acc[0][r] + bj);
  }
  __syncthreads();

  // 13. LN2, rounded for the head
  for (int r = warp; r < TR; r += nwarps) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = Q[r * E + lane * 4 + i];
    ln_row(v, g2, b2, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) Rb[r * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
  }
  __syncthreads();

  // 14. linear head (bf16 operands, f32 sum), ragged rows never stored
  const int hd = net.head_dim;
  for (int p = warp; p < TR * hd; p += nwarps) {
    const int r = p / hd;
    const int o = p - r * hd;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = lane * 4 + i;
      s = fmaf(__bfloat162float(Rb[r * E + k]), bf16r(__ldg(wh + k * hd + o)), s);
    }
    s = warp_sum(s);
    const int row = row0 + r;
    if (lane == 0 && row < args.S) net.out[(size_t)row * hd + o] = s + __ldg(bh + o);
  }
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
  args.x = x;
  args.S = S;
  args.obs_dim = obs_dim;
  args.obs_pad = (obs_dim + 3) / 4 * 4;
  args.n_groups = n_groups;
  args.scale = (float)(1.0 / 11.313708498984761);  // 1 / sqrt(E)
  int t = 0, off = 0;
  for (int g = 0; g < n_groups; ++g) {
    for (int i = 0; i < group_k[g]; ++i) {
      if (t >= MAX_TOK) return (int)cudaErrorInvalidValue;
      args.tok_off[t] = off;
      args.tok_dim[t] = group_d[g];
      args.tok_group[t] = g;
      off += group_d[g];
      ++t;
    }
  }
  if (off != obs_dim || t < 1) return (int)cudaErrorInvalidValue;
  args.n_tokens = t;
  for (int n = 0; n < n_nets; ++n) {
    if (head_dims[n] < 1 || head_dims[n] > MAX_HEAD) return (int)cudaErrorInvalidValue;
    for (int l = 0; l < n_leaves; ++l)
      args.net[n].leaf[l] = static_cast<const float*>(leaves[n * n_leaves + l]);
    args.net[n].out = outs[n];
    args.net[n].head_dim = head_dims[n];
  }
  if (S == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(3 * t * TR + TR) * E * sizeof(__nv_bfloat16) +
                      (size_t)TR * args.obs_pad * sizeof(float) +
                      (size_t)2 * TR * E * sizeof(float) +
                      (size_t)TR * MAX_TOK * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + TR - 1) / TR, n_nets);
  encoder_fwd_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
