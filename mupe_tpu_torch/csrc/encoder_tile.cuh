// One tile of TR rows of the encoder + linear head (PartialAttentionEncoder),
// forward and backward, as __device__ functions shared by every encoder
// kernel: the forward (fused_encoder.cu), the backward (fused_encoder_bwd.cu)
// and the forward + PPO loss kernels (fused_encoder_loss.cu).  All of them
// run this code, so a network's activations and gradients are the same bits
// whichever kernel computes them.
//
// `tile_forward` is `_forward_core` (mupe_tpu/ops/fused_encoder.py:278-364)
// up to LN2 at its rounding points; `tile_head` the linear head;
// `tile_backward` is `_backward_core` (:377-463) from the residuals that
// `tile_forward<true>` keeps.  One block of 128 threads per tile, thread j
// owning feature column j; the tile's activations live in shared memory.
#pragma once

#include "common.cuh"

namespace {

// The transposed weights that the backward's `_mm_nt` products read, so that
// they stream coalesced through `mm_tile` as the forward's products do.
enum { T_Q, T_K, T_V, T_O, T_1, T_2, N_T };

// Where one tile's forward keeps its values.  The forward alone (KEEP =
// false) uses Hb, Kb, Vb, xs, H0, Q and P, one [TR][E] bf16 operand buffer
// (ATTb = Y1b = Fb = Y2b) and R2 = Q.  With KEEP it also keeps the
// backward's residuals: N0b, N1, N2, PRE1, inv0-inv2, the four operand
// buffers apart, and R2 apart from Q.
struct TileBufs {
  __nv_bfloat16* Hb;    // [ntr][E] embeds, then h_all
  __nv_bfloat16* N0b;   // [ntr][E] LN0's n, bf16 (KEEP)
  __nv_bfloat16* Kb;    // [ntr][E] k
  __nv_bfloat16* Vb;    // [ntr][E] v
  __nv_bfloat16* ATTb;  // [TR][E] attention output
  __nv_bfloat16* Y1b;   // [TR][E] LN1 output
  __nv_bfloat16* Fb;    // [TR][E] GELU output
  __nv_bfloat16* Y2b;   // [TR][E] LN2 output, the head's operand
  float* xs;            // [TR][obs_pad] the rows, bf16 values
  float* Q;             // [TR][E] q
  float* H0;            // [TR][E] h0, then r1, then y1
  float* N1;            // [TR][E] (KEEP)
  float* N2;            // [TR][E] (KEEP)
  float* PRE1;          // [TR][E] (KEEP)
  float* R2;            // [TR][E] r2
  float* inv0;          // [MAX_TOK * TR] (KEEP)
  float* inv1;          // [TR] (KEEP)
  float* inv2;          // [TR] (KEEP)
  float* P;             // [TR][MAX_TOK] scores, then softmax weights
};

// The forward kernel's layout: Hb, Kb, Vb, one operand buffer (bf16), then
// xs, H0, Q and P (f32).
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

// The backward's layout: the forward's residuals and the backward's
// cotangent buffers.
struct BwdBufs {
  TileBufs t;          // with KEEP; t.R2 (r2) is G
  __nv_bfloat16* Rb;   // [TR][E] rounded cotangent operand
  float* G2;           // [TR][E] dpre1, then dq
  float* DH;           // [TR][E] datt, then one token's dh -> de
  float* DS;           // [TR][MAX_TOK] das, then dss
  float* DOUT;         // [TR][MAX_HEAD] the head's cotangent
};

__host__ __device__ inline size_t bwd_smem_bytes(int n_tokens, int obs_pad) {
  const int ntr = n_tokens * TR;
  return (size_t)(4 * ntr + 5 * TR) * E * sizeof(__nv_bfloat16) +
         (size_t)TR * obs_pad * sizeof(float) + (size_t)8 * TR * E * sizeof(float) +
         (size_t)(MAX_TOK * TR + 2 * TR + 2 * TR * MAX_TOK + TR * MAX_HEAD) * sizeof(float);
}

__device__ __forceinline__ BwdBufs bwd_bufs(unsigned char* smem, int n_tokens, int obs_pad) {
  const int ntr = n_tokens * TR;
  BwdBufs b;
  TileBufs& t = b.t;
  t.Hb = reinterpret_cast<__nv_bfloat16*>(smem);
  t.N0b = t.Hb + ntr * E;
  t.Kb = t.N0b + ntr * E;
  t.Vb = t.Kb + ntr * E;
  t.ATTb = t.Vb + ntr * E;
  t.Y1b = t.ATTb + TR * E;
  t.Fb = t.Y1b + TR * E;
  t.Y2b = t.Fb + TR * E;
  b.Rb = t.Y2b + TR * E;
  t.xs = reinterpret_cast<float*>(b.Rb + TR * E);
  t.Q = t.xs + TR * obs_pad;
  t.H0 = t.Q + TR * E;
  t.N1 = t.H0 + TR * E;
  t.N2 = t.N1 + TR * E;
  t.PRE1 = t.N2 + TR * E;
  t.R2 = t.PRE1 + TR * E;
  b.G2 = t.R2 + TR * E;
  b.DH = b.G2 + TR * E;
  t.inv0 = b.DH + TR * E;
  t.inv1 = t.inv0 + MAX_TOK * TR;
  t.inv2 = t.inv1 + TR;
  t.P = t.inv2 + TR;
  b.DS = t.P + TR * MAX_TOK;
  b.DOUT = b.DS + TR * MAX_TOK;
  return b;
}

// The backward's memory seen by a forward alone (KEEP = false): the
// residual buffers are left untouched.
__device__ __forceinline__ TileBufs fwd_view(const BwdBufs& b) {
  TileBufs f = b.t;
  f.ATTb = f.Y1b = f.Fb = f.Y2b = b.Rb;
  f.R2 = f.Q;
  return f;
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
template <bool KEEP>
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
      if (KEEP) B.N0b[rt * E + lane * 4 + i] = __float2bfloat16_rn(n[i]);
      if (rt < TR) B.H0[rt * E + lane * 4 + i] = v[i];
    }
    if (KEEP && lane == 0) B.inv0[rt] = inv;
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
      if (KEEP) B.N1[r * E + lane * 4 + i] = n[i];
      B.Y1b[r * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
    }
    if (KEEP && lane == 0) B.inv1[r] = inv;
  }
  __syncthreads();

  {  // FFN first layer + tanh-GELU, rounded for the second layer
    const float* const W[1] = {w1};
    float acc[1][TR];
    mm_tile<1>(B.Y1b, 0, W, j, acc);
    const float bj = __ldg(bf1 + j);
    if (!KEEP) __syncthreads();  // Fb is Y1b: every thread has read it
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float pre = acc[0][r] + bj;
      if (KEEP) B.PRE1[r * E + j] = pre;
      B.Fb[r * E + j] = __float2bfloat16_rn(gelu_tanh(pre));
    }
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
    for (int i = 0; i < 4; ++i) {
      if (KEEP) B.N2[r * E + lane * 4 + i] = n[i];
      B.Y2b[r * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
    }
    if (KEEP && lane == 0) B.inv2[r] = inv;
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

// ws[k * E + j] += sum_r A[r][k] * D[r][j] over `nrows` rows (`_mm_tn`):
// A and D bf16 [nrows][E] in shared memory; thread j owns column j.
__device__ __forceinline__ void tn_accum(const __nv_bfloat16* A, const __nv_bfloat16* D,
                                         int nrows, int j, float* ws) {
  for (int k = 0; k < E; k += 8) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int r = 0; r < nrows; ++r) {
      const float d = __bfloat162float(D[r * E + j]);
      float a[8];
      unpack8(*reinterpret_cast<const uint4*>(A + r * E + k), a);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(a[i], d, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) ws[(k + i) * E + j] += acc[i];
  }
}

// LayerNorm backward of one row held by a warp (`_ln_bwd`): dy <- dx.
__device__ __forceinline__ void ln_bwd_row(float (&dy)[4], const float (&n)[4], float inv,
                                           const float* __restrict__ g, int lane) {
  float dn[4];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dn[i] = dy[i] * __ldg(g + lane * 4 + i);
    s1 += dn[i];
    s2 += dn[i] * n[i];
  }
  const float m1 = warp_sum(s1) / float(E);
  const float m2 = warp_sum(s2) / float(E);
#pragma unroll
  for (int i = 0; i < 4; ++i) dy[i] = inv * (dn[i] - m1 - n[i] * m2);
}

__device__ __forceinline__ float dgelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float t = tanhf(c * (x + 0.044715f * x * x * x));
  const float dinner = c * (1.0f + 3.0f * 0.044715f * x * x);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * dinner;
}

// Offsets of each leaf's gradient in a network's flat gradient vector
// (canonical order) and its length P; false if the head is too wide.
inline bool leaf_offsets(const TokenLayout& lay, const int* group_d, int hd, int* off, int* P) {
  if (hd < 1 || hd > MAX_HEAD) return false;
  int sizes[MAX_LEAVES];
  int n = 0;
  for (int g = 0; g < lay.n_groups; ++g) {
    sizes[n++] = group_d[g] * E;
    sizes[n++] = E;
  }
  const int fixed[N_FIXED] = {E, E, E * E, E, E * E, E, E * E, E, E * E, E,
                              E, E, E * E, E, E * E, E, E, E, E * hd, hd};
  for (int i = 0; i < N_FIXED; ++i) sizes[n++] = fixed[i];
  int o = 0;
  for (int i = 0; i < n; ++i) {
    off[i] = o;
    o += sizes[i];
  }
  *P = o;
  return true;
}

// Blocks per network of a persistent grid over the row tiles: as many as are
// resident on the card at once (for `kernel` at `smem` bytes of dynamic
// shared memory, which this sets as its limit), shared by `n_nets`
// networks, and no more than there are tiles.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, size_t smem, int n_nets, int S, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_tiles = (S + TR - 1) / TR;
  int b = sms * per_sm / n_nets;
  if (b > n_tiles) b = n_tiles;
  *blocks = b < 1 ? 1 : b;
  return cudaSuccess;
}

// `_backward_core` for the tile: adds the parameter gradients of
// sum(out . DOUT) over the tile's rows into ws (one gradient slice, leaf
// offsets `off`), from the residuals of `tile_forward<true>` and the head's
// cotangent in B.DOUT.  wt: the transposes of wq, wk, wv, wo, w1, w2.  Ends
// synchronised.
__device__ __forceinline__ void tile_backward(const TokenLayout& lay, const float* const* L,
                                              const float* const* wt, const int* off, int hd,
                                              float scale, const BwdBufs& B, float* ws, int j) {
  const TileBufs& T = B.t;
  const int nt = lay.n_tokens;
  const int ntr = nt * TR;
  const int op = lay.obs_pad;
  const int base = 2 * lay.n_groups;
  const float* g0 = L[base + 0];
  const float* g1 = L[base + 10];
  const float* g2 = L[base + 16];
  const float* wh = L[base + 18];
  __nv_bfloat16* Hb = T.Hb;
  __nv_bfloat16* N0b = T.N0b;
  __nv_bfloat16* Kb = T.Kb;
  __nv_bfloat16* Vb = T.Vb;
  __nv_bfloat16* Rb = B.Rb;
  float* G = T.R2;
  float* G2 = B.G2;
  float* DH = B.DH;
  float* DS = B.DS;
  const float* P = T.P;
  const float* DOUT = B.DOUT;
  const int warp = j >> 5;
  const int lane = j & 31;
  const int nwarps = NTHREADS / 32;

  // head: dwh, dbh, dy2
  for (int o = 0; o < hd; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < TR; ++r)
      acc = fmaf(__bfloat162float(T.Y2b[r * E + j]), bf16r(DOUT[r * MAX_HEAD + o]), acc);
    ws[off[base + 18] + j * hd + o] += acc;
  }
  if (j < hd) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < TR; ++r) acc += DOUT[r * MAX_HEAD + j];
    ws[off[base + 19] + j] += acc;
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    float acc = 0.f;
    for (int o = 0; o < hd; ++o)
      acc = fmaf(bf16r(DOUT[r * MAX_HEAD + o]), bf16r(__ldg(wh + j * hd + o)), acc);
    G[r * E + j] = acc;
  }
  __syncthreads();
  {  // LN2 scale and bias gradients (column sums of dy2 * n2 and dy2)
    float dg = 0.f, db = 0.f;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      dg += G[r * E + j] * T.N2[r * E + j];
      db += G[r * E + j];
    }
    ws[off[base + 16] + j] += dg;
    ws[off[base + 17] + j] += db;
  }
  __syncthreads();
  for (int r = warp; r < TR; r += nwarps) {  // dr2 = LN2 backward
    float dy[4], n[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dy[i] = G[r * E + lane * 4 + i];
      n[i] = T.N2[r * E + lane * 4 + i];
    }
    ln_bwd_row(dy, n, T.inv2[r], g2, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      G[r * E + lane * 4 + i] = dy[i];
      Rb[r * E + lane * 4 + i] = __float2bfloat16_rn(dy[i]);
    }
  }
  __syncthreads();
  {  // FFN second layer: dw2, dbf2, then dpre1
    float db = 0.f;
#pragma unroll
    for (int r = 0; r < TR; ++r) db += G[r * E + j];
    ws[off[base + 15] + j] += db;
    tn_accum(T.Fb, Rb, TR, j, ws + off[base + 14]);
    const float* const W[1] = {wt[T_2]};
    float acc[1][TR];
    mm_tile<1>(Rb, 0, W, j, acc);
#pragma unroll
    for (int r = 0; r < TR; ++r) G2[r * E + j] = acc[0][r] * dgelu_tanh(T.PRE1[r * E + j]);
  }
  __syncthreads();
  {  // FFN first layer: dbf1, dw1, dy1 = dr2 + dpre1 w1^T
    float db = 0.f;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      db += G2[r * E + j];
      Rb[r * E + j] = __float2bfloat16_rn(G2[r * E + j]);
    }
    ws[off[base + 13] + j] += db;
  }
  __syncthreads();
  tn_accum(T.Y1b, Rb, TR, j, ws + off[base + 12]);
  {
    const float* const W[1] = {wt[T_1]};
    float acc[1][TR];
    mm_tile<1>(Rb, 0, W, j, acc);
#pragma unroll
    for (int r = 0; r < TR; ++r) G[r * E + j] = G[r * E + j] + acc[0][r];
  }
  __syncthreads();
  {  // LN1 scale and bias gradients
    float dg = 0.f, db = 0.f;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      dg += G[r * E + j] * T.N1[r * E + j];
      db += G[r * E + j];
    }
    ws[off[base + 10] + j] += dg;
    ws[off[base + 11] + j] += db;
  }
  __syncthreads();
  for (int r = warp; r < TR; r += nwarps) {  // dr1 = LN1 backward
    float dy[4], n[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dy[i] = G[r * E + lane * 4 + i];
      n[i] = T.N1[r * E + lane * 4 + i];
    }
    ln_bwd_row(dy, n, T.inv1[r], g1, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      G[r * E + lane * 4 + i] = dy[i];
      Rb[r * E + lane * 4 + i] = __float2bfloat16_rn(dy[i]);
    }
  }
  __syncthreads();
  {  // out-projection: dbo, dwo, datt
    float db = 0.f;
#pragma unroll
    for (int r = 0; r < TR; ++r) db += G[r * E + j];
    ws[off[base + 9] + j] += db;
    tn_accum(T.ATTb, Rb, TR, j, ws + off[base + 8]);
    const float* const W[1] = {wt[T_O]};
    float acc[1][TR];
    mm_tile<1>(Rb, 0, W, j, acc);
#pragma unroll
    for (int r = 0; r < TR; ++r) DH[r * E + j] = acc[0][r];
  }
  __syncthreads();
  for (int p = warp; p < TR * nt; p += nwarps) {  // das_t = datt . v_t
    const int r = p / nt;
    const int t = p - r * nt;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane * 4 + i;
      s += DH[r * E + c] * __bfloat162float(Vb[(t * TR + r) * E + c]);
    }
    s = warp_sum(s);
    if (lane == 0) DS[r * MAX_TOK + t] = s;
  }
  __syncthreads();
  if (j < TR) {  // softmax backward: dss_t = a_t (das_t - sum_u a_u das_u)
    const float* a = P + j * MAX_TOK;
    float* d = DS + j * MAX_TOK;
    float wsum = a[0] * d[0];
    for (int t = 1; t < nt; ++t) wsum = wsum + a[t] * d[t];
    for (int t = 0; t < nt; ++t) d[t] = a[t] * (d[t] - wsum);
  }
  __syncthreads();
  {  // dq, and the bf16 k / v cotangents (each thread its own column)
    float dbq = 0.f, dbk = 0.f, dbv = 0.f;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float* d = DS + r * MAX_TOK;
      float dq = d[0] * __bfloat162float(Kb[r * E + j]);
      for (int t = 1; t < nt; ++t) dq = dq + d[t] * __bfloat162float(Kb[(t * TR + r) * E + j]);
      dq = dq * scale;
      G2[r * E + j] = dq;
      Rb[r * E + j] = __float2bfloat16_rn(dq);
      dbq += dq;
      const float qj = T.Q[r * E + j];
      const float datt = DH[r * E + j];
      for (int t = 0; t < nt; ++t) {
        const __nv_bfloat16 dk = __float2bfloat16_rn(d[t] * qj * scale);
        const __nv_bfloat16 dv = __float2bfloat16_rn(P[r * MAX_TOK + t] * datt);
        Kb[(t * TR + r) * E + j] = dk;
        Vb[(t * TR + r) * E + j] = dv;
      }
    }
    for (int rt = 0; rt < ntr; ++rt) {
      dbk += __bfloat162float(Kb[rt * E + j]);
      dbv += __bfloat162float(Vb[rt * E + j]);
    }
    ws[off[base + 3] + j] += dbq;
    ws[off[base + 5] + j] += dbk;
    ws[off[base + 7] + j] += dbv;
    // dwq, dwk, dwv read only this thread's column of the cotangents
    tn_accum(Hb, Rb, TR, j, ws + off[base + 2]);
    tn_accum(Hb, Kb, ntr, j, ws + off[base + 4]);
    tn_accum(Hb, Vb, ntr, j, ws + off[base + 6]);
  }
  // per token: dh = dk wk^T + dv wv^T (+ dr1 + dq wq^T for the query token),
  // then LN0 backward and the token's embed gradients
  float dg0 = 0.f, db0 = 0.f;
  for (int t = 0; t < nt; ++t) {
    __syncthreads();
    {
      const float* const Wk[1] = {wt[T_K]};
      const float* const Wv[1] = {wt[T_V]};
      float acck[1][TR], accv[1][TR];
      mm_tile<1>(Kb, t * TR, Wk, j, acck);
      mm_tile<1>(Vb, t * TR, Wv, j, accv);
      float dh[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) dh[r] = acck[0][r] + accv[0][r];
      if (t == 0) {
        const float* const Wq[1] = {wt[T_Q]};
        float accq[1][TR];
        mm_tile<1>(Rb, 0, Wq, j, accq);
#pragma unroll
        for (int r = 0; r < TR; ++r) dh[r] = (dh[r] + G[r * E + j]) + accq[0][r];
      }
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        DH[r * E + j] = dh[r];
        dg0 += dh[r] * __bfloat162float(N0b[(t * TR + r) * E + j]);
        db0 += dh[r];
      }
    }
    __syncthreads();
    for (int r = warp; r < TR; r += nwarps) {  // de = LN0 backward
      float dy[4], n[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dy[i] = DH[r * E + lane * 4 + i];
        n[i] = __bfloat162float(N0b[(t * TR + r) * E + lane * 4 + i]);
      }
      ln_bwd_row(dy, n, T.inv0[t * TR + r], g0, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) DH[r * E + lane * 4 + i] = dy[i];
    }
    __syncthreads();
    {  // the token's embed: dWg += xs_t^T de, dbg += colsum(de)
      const int g = lay.tok_group[t];
      const int toff = lay.tok_off[t];
      float de[TR];
      float db = 0.f;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        de[r] = DH[r * E + j];
        db += de[r];
      }
      float* wsg = ws + off[2 * g];
      for (int c = 0; c < lay.tok_dim[t]; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < TR; ++r) acc = fmaf(T.xs[r * op + toff + c], bf16r(de[r]), acc);
        wsg[c * E + j] += acc;
      }
      ws[off[2 * g + 1] + j] += db;
    }
  }
  ws[off[base + 0] + j] += dg0;
  ws[off[base + 1] + j] += db0;
  __syncthreads();
}

}  // namespace
