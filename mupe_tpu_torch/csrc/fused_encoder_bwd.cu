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
// Tensor-core products are left for a later change.

#include "common.cuh"

namespace {

// The transposed weights that the backward's `_mm_nt` products read, so that
// they stream coalesced through `mm_tile` as the forward's products do.
enum { T_Q, T_K, T_V, T_O, T_1, T_2, N_T };

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

size_t bwd_smem_bytes(int n_tokens, int obs_pad) {
  const int ntr = n_tokens * TR;
  return (size_t)(4 * ntr + 5 * TR) * E * sizeof(__nv_bfloat16) +
         (size_t)TR * obs_pad * sizeof(float) + (size_t)8 * TR * E * sizeof(float) +
         (size_t)(MAX_TOK * TR + 2 * TR + 2 * TR * MAX_TOK + TR * MAX_HEAD) * sizeof(float);
}

__global__ void __launch_bounds__(NTHREADS)
    encoder_bwd_kernel(const __grid_constant__ BwdArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TokenLayout& lay = args.lay;
  const int nt = lay.n_tokens;
  const int ntr = nt * TR;
  const int op = lay.obs_pad;
  __nv_bfloat16* Hb = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ntr][E] h_all
  __nv_bfloat16* N0b = Hb + ntr * E;   // [ntr][E] LN0's n, bf16
  __nv_bfloat16* Kb = N0b + ntr * E;   // [ntr][E] k, then its cotangent
  __nv_bfloat16* Vb = Kb + ntr * E;    // [ntr][E] v, then its cotangent
  __nv_bfloat16* ATTb = Vb + ntr * E;  // [TR][E] attention output
  __nv_bfloat16* Y1b = ATTb + TR * E;  // [TR][E] LN1 output
  __nv_bfloat16* Fb = Y1b + TR * E;    // [TR][E] GELU output
  __nv_bfloat16* Y2b = Fb + TR * E;    // [TR][E] LN2 output
  __nv_bfloat16* Rb = Y2b + TR * E;    // [TR][E] rounded cotangent operand
  float* xs = reinterpret_cast<float*>(Rb + TR * E);  // [TR][op]
  float* Q = xs + TR * op;     // [TR][E] q
  float* H0 = Q + TR * E;      // [TR][E] h0, then r1, then y1
  float* N1 = H0 + TR * E;     // [TR][E]
  float* N2 = N1 + TR * E;     // [TR][E]
  float* PRE1 = N2 + TR * E;   // [TR][E]
  float* G = PRE1 + TR * E;    // [TR][E] r2; dy2 -> dr2; dy1 -> dr1
  float* G2 = G + TR * E;      // [TR][E] dpre1, then dq
  float* DH = G2 + TR * E;     // [TR][E] datt, then one token's dh -> de
  float* inv0 = DH + TR * E;   // [MAX_TOK * TR]
  float* inv1 = inv0 + MAX_TOK * TR;
  float* inv2 = inv1 + TR;
  float* P = inv2 + TR;        // [TR][MAX_TOK] softmax weights
  float* DS = P + TR * MAX_TOK;  // [TR][MAX_TOK] das, then dss
  float* DOUT = DS + TR * MAX_TOK;  // [TR][MAX_HEAD]

  const BwdNet& net = args.net[blockIdx.y];
  const float* const* L = net.leaf;
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
  const float* wh = L[base + 18];
  const int* off = net.off;
  const int hd = net.head_dim;

  const int j = threadIdx.x;
  const int warp = j >> 5;
  const int lane = j & 31;
  const int nwarps = NTHREADS / 32;
  float* ws = net.ws + (size_t)blockIdx.x * net.P;
  for (int p = j; p < net.P; p += NTHREADS) ws[p] = 0.f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < args.n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    // ------------------------------------------------ forward, residuals kept
    for (int idx = j; idx < TR * lay.obs_dim; idx += NTHREADS) {
      const int r = idx / lay.obs_dim;
      const int c = idx - r * lay.obs_dim;
      const int row = row0 + r;
      xs[r * op + c] = row < args.S ? bf16r(args.x[(size_t)row * lay.obs_dim + c]) : 0.f;
    }
    for (int idx = j; idx < TR * hd; idx += NTHREADS) {
      const int r = idx / hd;
      const int o = idx - r * hd;
      const int row = row0 + r;
      DOUT[r * MAX_HEAD + o] = row < args.S ? net.dout[(size_t)row * hd + o] : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {  // per-token embeds
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
        for (int r = 0; r < TR; ++r) acc[r] = fmaf(xs[r * op + toff + c], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < TR; ++r) Hb[(t * TR + r) * E + j] = __float2bfloat16_rn(acc[r] + bgj);
    }
    __syncthreads();

    for (int rt = warp; rt < ntr; rt += nwarps) {  // LN0
      float v[4], n[4], inv;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(Hb[rt * E + lane * 4 + i]);
      ln_row_n(v, n, inv, g0, b0, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Hb[rt * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
        N0b[rt * E + lane * 4 + i] = __float2bfloat16_rn(n[i]);
        if (rt < TR) H0[rt * E + lane * 4 + i] = v[i];
      }
      if (lane == 0) inv0[rt] = inv;
    }
    __syncthreads();

    {  // q, k, v
      const float* const W[1] = {wq};
      float acc[1][TR];
      mm_tile<1>(Hb, 0, W, j, acc);
      const float bqj = __ldg(bq + j);
#pragma unroll
      for (int r = 0; r < TR; ++r) Q[r * E + j] = acc[0][r] + bqj;
    }
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

    for (int p = warp; p < TR * nt; p += nwarps) {  // scores
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
    if (j < TR) {  // softmax over the tokens
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
#pragma unroll
    for (int r = 0; r < TR; ++r) {  // attention output
      float att = P[r * MAX_TOK] * __bfloat162float(Vb[r * E + j]);
      for (int t = 1; t < nt; ++t)
        att = fmaf(P[r * MAX_TOK + t], __bfloat162float(Vb[(t * TR + r) * E + j]), att);
      ATTb[r * E + j] = __float2bfloat16_rn(att);
    }
    __syncthreads();
    {  // r1 = h0 + out-projection
      const float* const W[1] = {wo};
      float acc[1][TR];
      mm_tile<1>(ATTb, 0, W, j, acc);
      const float boj = __ldg(bo + j);
#pragma unroll
      for (int r = 0; r < TR; ++r) H0[r * E + j] += acc[0][r] + boj;
    }
    __syncthreads();
    for (int r = warp; r < TR; r += nwarps) {  // LN1
      float v[4], n[4], inv;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = H0[r * E + lane * 4 + i];
      ln_row_n(v, n, inv, g1, b1, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        H0[r * E + lane * 4 + i] = v[i];
        N1[r * E + lane * 4 + i] = n[i];
        Y1b[r * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
      }
      if (lane == 0) inv1[r] = inv;
    }
    __syncthreads();
    {  // FFN first layer + GELU
      const float* const W[1] = {w1};
      float acc[1][TR];
      mm_tile<1>(Y1b, 0, W, j, acc);
      const float bj = __ldg(bf1 + j);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float pre = acc[0][r] + bj;
        PRE1[r * E + j] = pre;
        Fb[r * E + j] = __float2bfloat16_rn(gelu_tanh(pre));
      }
    }
    __syncthreads();
    {  // r2 = y1 + FFN second layer
      const float* const W[1] = {w2};
      float acc[1][TR];
      mm_tile<1>(Fb, 0, W, j, acc);
      const float bj = __ldg(bf2 + j);
#pragma unroll
      for (int r = 0; r < TR; ++r) G[r * E + j] = H0[r * E + j] + (acc[0][r] + bj);
    }
    __syncthreads();
    for (int r = warp; r < TR; r += nwarps) {  // LN2
      float v[4], n[4], inv;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = G[r * E + lane * 4 + i];
      ln_row_n(v, n, inv, g2, b2, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        N2[r * E + lane * 4 + i] = n[i];
        Y2b[r * E + lane * 4 + i] = __float2bfloat16_rn(v[i]);
      }
      if (lane == 0) inv2[r] = inv;
    }
    __syncthreads();

    // ------------------------------------------------ backward
    // head: dwh, dbh, dy2
    for (int o = 0; o < hd; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < TR; ++r)
        acc = fmaf(__bfloat162float(Y2b[r * E + j]), bf16r(DOUT[r * MAX_HEAD + o]), acc);
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
        dg += G[r * E + j] * N2[r * E + j];
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
        n[i] = N2[r * E + lane * 4 + i];
      }
      ln_bwd_row(dy, n, inv2[r], g2, lane);
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
      tn_accum(Fb, Rb, TR, j, ws + off[base + 14]);
      const float* const W[1] = {net.wt[T_2]};
      float acc[1][TR];
      mm_tile<1>(Rb, 0, W, j, acc);
#pragma unroll
      for (int r = 0; r < TR; ++r) G2[r * E + j] = acc[0][r] * dgelu_tanh(PRE1[r * E + j]);
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
    tn_accum(Y1b, Rb, TR, j, ws + off[base + 12]);
    {
      const float* const W[1] = {net.wt[T_1]};
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
        dg += G[r * E + j] * N1[r * E + j];
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
        n[i] = N1[r * E + lane * 4 + i];
      }
      ln_bwd_row(dy, n, inv1[r], g1, lane);
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
      tn_accum(ATTb, Rb, TR, j, ws + off[base + 8]);
      const float* const W[1] = {net.wt[T_O]};
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
        dq = dq * args.scale;
        G2[r * E + j] = dq;
        Rb[r * E + j] = __float2bfloat16_rn(dq);
        dbq += dq;
        const float qj = Q[r * E + j];
        const float datt = DH[r * E + j];
        for (int t = 0; t < nt; ++t) {
          const __nv_bfloat16 dk = __float2bfloat16_rn(d[t] * qj * args.scale);
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
        const float* const Wk[1] = {net.wt[T_K]};
        const float* const Wv[1] = {net.wt[T_V]};
        float acck[1][TR], accv[1][TR];
        mm_tile<1>(Kb, t * TR, Wk, j, acck);
        mm_tile<1>(Vb, t * TR, Wv, j, accv);
        float dh[TR];
#pragma unroll
        for (int r = 0; r < TR; ++r) dh[r] = acck[0][r] + accv[0][r];
        if (t == 0) {
          const float* const Wq[1] = {net.wt[T_Q]};
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
        ln_bwd_row(dy, n, inv0[t * TR + r], g0, lane);
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
          for (int r = 0; r < TR; ++r) acc = fmaf(xs[r * op + toff + c], bf16r(de[r]), acc);
          wsg[c * E + j] += acc;
        }
        ws[off[2 * g + 1] + j] += db;
      }
    }
    ws[off[base + 0] + j] += dg0;
    ws[off[base + 1] + j] += db0;
    __syncthreads();
  }
}

bool net_offsets(const TokenLayout& lay, const int* group_d, int hd, BwdNet& net) {
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
  int off = 0;
  for (int i = 0; i < n; ++i) {
    net.off[i] = off;
    off += sizes[i];
  }
  net.P = off;
  net.head_dim = hd;
  return true;
}

// Blocks per network of the persistent grid: as many as are resident on the
// card at once, shared by the networks, and no more than there are tiles.
cudaError_t grid_blocks(int n_tokens, int obs_pad, int n_nets, int S, int* blocks) {
  const size_t smem = bwd_smem_bytes(n_tokens, obs_pad);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, encoder_bwd_kernel,
                                                           NTHREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_tiles = (S + TR - 1) / TR;
  int b = sms * per_sm / n_nets;
  if (b > n_tiles) b = n_tiles;
  *blocks = b < 1 ? 1 : b;
  return cudaSuccess;
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
