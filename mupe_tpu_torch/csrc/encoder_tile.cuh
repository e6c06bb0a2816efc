// One tile of TR rows of the encoder + linear head (PartialAttentionEncoder),
// forward only, on the CUDA cores, as __device__ functions shared by the
// forward kernel (fused_encoder.cu) and the forward + PPO loss kernel
// (fused_encoder_loss.cu `pair_fwd_loss_kernel`), so a network's outputs are
// the same bits whichever of them computes them.  (The backward's tile, on
// the tensor cores, is encoder_bwd_tile.cuh.)
//
// `tile_forward` is `_forward_core` (mupe_tpu/ops/fused_encoder.py:278-364)
// up to LN2 at its rounding points; `tile_head` the linear head.  One block
// of 128 threads per tile, thread j owning feature column j; the tile's
// activations live in shared memory.
#pragma once

#include "common.cuh"

namespace {

// Where one tile's forward keeps its values: Hb, Kb, Vb, xs, H0, Q and P,
// one [TR][E] bf16 operand buffer (ATTb = Y1b = Fb = Y2b) and R2 = Q.
struct TileBufs {
  __nv_bfloat16* Hb;    // [ntr][E] embeds, then h_all
  __nv_bfloat16* Kb;    // [ntr][E] k
  __nv_bfloat16* Vb;    // [ntr][E] v
  __nv_bfloat16* ATTb;  // [TR][E] attention output
  __nv_bfloat16* Y1b;   // [TR][E] LN1 output
  __nv_bfloat16* Fb;    // [TR][E] GELU output
  __nv_bfloat16* Y2b;   // [TR][E] LN2 output, the head's operand
  float* xs;            // [TR][obs_pad] the rows, bf16 values
  float* Q;             // [TR][E] q
  float* H0;            // [TR][E] h0, then r1, then y1
  float* R2;            // [TR][E] r2
  float* P;             // [TR][MAX_TOK] scores, then softmax weights
};

// The layout: Hb, Kb, Vb, one operand buffer (bf16), then xs, H0, Q and P
// (f32).
__host__ __device__ inline size_t fwd_smem_bytes(int n_tokens, int obs_pad) {
  return (size_t)(3 * n_tokens * TR + TR) * E * sizeof(__nv_bfloat16) +
         (size_t)TR * obs_pad * sizeof(float) + (size_t)2 * TR * E * sizeof(float) +
         (size_t)TR * MAX_TOK * sizeof(float);
}

__device__ __forceinline__ TileBufs fwd_bufs(unsigned char* smem, int n_tokens, int obs_pad) {
  const int ntr = n_tokens * TR;
  TileBufs b = {};
  b.Hb = reinterpret_cast<__nv_bfloat16*>(smem);
  b.Kb = b.Hb + ntr * E;
  b.Vb = b.Kb + ntr * E;
  b.ATTb = b.Y1b = b.Fb = b.Y2b = b.Vb + ntr * E;
  b.xs = reinterpret_cast<float*>(b.ATTb + TR * E);
  b.H0 = b.xs + TR * obs_pad;
  b.Q = b.R2 = b.H0 + TR * E;
  b.P = b.Q + TR * E;
  return b;
}

// The tile's observation rows, rounded to bf16 (operands of the embeds);
// rows past S are zeros.
__device__ __forceinline__ void load_rows(float* xs, const float* __restrict__ x, int S,
                                          const TokenLayout& lay, int row0, int j) {
  for (int idx = j; idx < TR * lay.obs_dim; idx += NTHREADS) {
    const int r = idx / lay.obs_dim;
    const int c = idx - r * lay.obs_dim;
    const int row = row0 + r;
    xs[r * lay.obs_pad + c] = row < S ? bf16r(x[(size_t)row * lay.obs_dim + c]) : 0.f;
  }
}

// `_forward_core` for the tile up to LN2's output (B.Y2b), from the rows in
// B.xs (loaded and synchronised by the caller).  L: the network's leaves in
// canonical order.  Ends synchronised.
__device__ __forceinline__ void tile_forward(const TokenLayout& lay, const float* const* L,
                                             float scale, const TileBufs& B, int j) {
  const int nt = lay.n_tokens;
  const int ntr = nt * TR;
  const int op = lay.obs_pad;
  const int base = 2 * lay.n_groups;
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
  const int warp = j >> 5;
  const int lane = j & 31;
  const int nwarps = NTHREADS / 32;

  // per-token embeds -> bf16, token-major rows t*TR + r
  for (int t = 0; t < nt; ++t) {
    const int g = lay.tok_group[t];
    const int toff = lay.tok_off[t];
    const float* wg = L[2 * g];
    const float bgj = __ldg(L[2 * g + 1] + j);
    float acc[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[r] = 0.f;
    for (int c = 0; c < lay.tok_dim[t]; ++c) {
      const float w = bf16r(__ldg(wg + c * E + j));
#pragma unroll
      for (int r = 0; r < TR; ++r) acc[r] = fmaf(B.xs[r * op + toff + c], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) B.Hb[(t * TR + r) * E + j] = __float2bfloat16_rn(acc[r] + bgj);
  }
  __syncthreads();

  // LN0 over every token row, in place; token 0's f32 output kept as h0
  for (int rt = warp; rt < ntr; rt += nwarps) {
    float v[4], n[4], inv;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(B.Hb[rt * E + lane * 4 + i]);
    ln_row_n(v, n, inv, g0, b0, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      B.Hb[rt * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
      if (rt < TR) B.H0[rt * E + lane * 4 + i] = v[i];
    }
  }
  __syncthreads();

  {  // q from the query token (its bf16 rounding is h_all's)
    const float* const W[1] = {wq};
    float acc[1][TR];
    mm_tile<1>(B.Hb, 0, W, j, acc);
    const float bqj = __ldg(bq + j);
#pragma unroll
    for (int r = 0; r < TR; ++r) B.Q[r * E + j] = acc[0][r] + bqj;
  }
  {  // k and v of every token, rounded to bf16
    const float* const W[2] = {wk, wv};
    const float bkj = __ldg(bk + j);
    const float bvj = __ldg(bv + j);
    for (int t = 0; t < nt; ++t) {
      float acc[2][TR];
      mm_tile<2>(B.Hb, t * TR, W, j, acc);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        B.Kb[(t * TR + r) * E + j] = __float2bfloat16_rn(acc[0][r] + bkj);
        B.Vb[(t * TR + r) * E + j] = __float2bfloat16_rn(acc[1][r] + bvj);
      }
    }
  }
  __syncthreads();

  // scores q . k_t * scale
  for (int p = warp; p < TR * nt; p += nwarps) {
    const int r = p / nt;
    const int t = p - r * nt;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane * 4 + i;
      s = fmaf(B.Q[r * E + c], __bfloat162float(B.Kb[(t * TR + r) * E + c]), s);
    }
    s = warp_sum(s);
    if (lane == 0) B.P[r * MAX_TOK + t] = s * scale;
  }
  __syncthreads();

  if (j < TR) {  // softmax over the tokens, in the reference's order
    float* p = B.P + j * MAX_TOK;
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

#pragma unroll
  for (int r = 0; r < TR; ++r) {  // attention output sum_t a_t v_t, rounded
    float att = B.P[r * MAX_TOK] * __bfloat162float(B.Vb[r * E + j]);
    for (int t = 1; t < nt; ++t)
      att = fmaf(B.P[r * MAX_TOK + t], __bfloat162float(B.Vb[(t * TR + r) * E + j]), att);
    B.ATTb[r * E + j] = __float2bfloat16_rn(att);
  }
  __syncthreads();

  {  // out-projection + residual: r1 = h0 + o (into H0)
    const float* const W[1] = {wo};
    float acc[1][TR];
    mm_tile<1>(B.ATTb, 0, W, j, acc);
    const float boj = __ldg(bo + j);
#pragma unroll
    for (int r = 0; r < TR; ++r) B.H0[r * E + j] += acc[0][r] + boj;
  }
  __syncthreads();

  for (int r = warp; r < TR; r += nwarps) {  // LN1: y1 f32 in H0, bf16 in Y1b
    float v[4], n[4], inv;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = B.H0[r * E + lane * 4 + i];
    ln_row_n(v, n, inv, g1, b1, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      B.H0[r * E + lane * 4 + i] = v[i];
      B.Y1b[r * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
    }
  }
  __syncthreads();

  {  // FFN first layer + tanh-GELU, rounded for the second layer
    const float* const W[1] = {w1};
    float acc[1][TR];
    mm_tile<1>(B.Y1b, 0, W, j, acc);
    const float bj = __ldg(bf1 + j);
    __syncthreads();  // Fb is Y1b: every thread has read it
#pragma unroll
    for (int r = 0; r < TR; ++r) B.Fb[r * E + j] = __float2bfloat16_rn(gelu_tanh(acc[0][r] + bj));
  }
  __syncthreads();

  {  // FFN second layer + residual: r2 = y1 + FFN(y1) (into R2)
    const float* const W[1] = {w2};
    float acc[1][TR];
    mm_tile<1>(B.Fb, 0, W, j, acc);
    const float bj = __ldg(bf2 + j);
#pragma unroll
    for (int r = 0; r < TR; ++r) B.R2[r * E + j] = B.H0[r * E + j] + (acc[0][r] + bj);
  }
  __syncthreads();

  for (int r = warp; r < TR; r += nwarps) {  // LN2, rounded for the head
    float v[4], n[4], inv;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = B.R2[r * E + lane * 4 + i];
    ln_row_n(v, n, inv, g2, b2, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) B.Y2b[r * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
  }
  __syncthreads();
}

// The linear head over the tile's LN2 output (bf16 operands, f32 sum):
// out[r * stride + o] for the first `rows` rows of the tile.
__device__ __forceinline__ void tile_head(const __nv_bfloat16* Y2b, const float* wh,
                                          const float* bh, int hd, float* out, int stride,
                                          int rows, int j) {
  const int warp = j >> 5;
  const int lane = j & 31;
  const int nwarps = NTHREADS / 32;
  for (int p = warp; p < TR * hd; p += nwarps) {
    const int r = p / hd;
    const int o = p - r * hd;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = lane * 4 + i;
      s = fmaf(__bfloat162float(Y2b[r * E + k]), bf16r(__ldg(wh + k * hd + o)), s);
    }
    s = warp_sum(s);
    if (lane == 0 && r < rows) out[(size_t)r * stride + o] = s + __ldg(bh + o);
  }
}

}  // namespace
