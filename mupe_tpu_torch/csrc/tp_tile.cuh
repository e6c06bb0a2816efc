// The TP-LSTM's tensor-core warp tile: a T-step LSTM(F -> 64), gates in
// (i, f, g, o) order, over 16 history windows, as __device__ functions
// shared by the forward kernel (tp_lstm.cu) and stage A of the backward
// (tp_lstm_bwd.cu), so that both compute the same h bits.
//
// It computes `_fwd_steps_t` + `_head_t` (mupe_tpu/ops/tp_lstm.py:377-419)
// and, in the backward, the BPTT of `_tp_bwd_kernel_t` (:428-505) at their
// rounding points: bf16 x, h, wi, wh and wfc operands with f32 sums, the
// bias added after both products, f32 gates and c; dz and each step's gate
// cotangent rounded to bf16 before they meet a product.
//
// Instances: FKT = 1-4 input k-tiles of 16 (F <= 64), x's fragments held
// in registers and loaded a step ahead, and one 64-output pass of the head
// (O <= 64); FKT = 0 takes any F and O: its k-tiles looped, each x
// fragment loaded where the product takes it, the head in passes of 64
// outputs, and where wi and wfc would not fit a block's shared memory
// (F past ~290) their B fragments read from the f32 leaves in device
// memory and rounded as the fill rounds them (`gw`).  Any T: the
// recurrence is a loop.
//
// A block of four warps owns a tile of 16 windows, mma.sync m16n8k16's M;
// warp w owns hidden units 16 w .. 16 w + 15.  A step's gate product
// [x_t | h_{t-1}] [wi; wh] (K = F padded to 16, plus 64) is split by those
// units: warp w computes the i, f, g and o n-tiles of its 16 units, so each
// thread holds all four gates of the same (window, unit) pairs in its
// accumulators and keeps their c in registers.  h_t, rounded to bf16, goes
// from the accumulator layout into a double-buffered [16][64] shared tile,
// which every warp reads back with ldmatrix as the next step's A fragments
// after the step's one __syncthreads.  So a step's latency is a quarter of
// the product and of the gates' activations, and a thread carries a
// quarter of the state.  The weights sit in shared memory as bf16
// (converted once a block from the f32 leaves) and are read with ldmatrix:
// .trans for [x | h] W, plain for the BPTT's dh = dg wh^T, whose A
// fragments the warps exchange the same way (each writes its units' gate
// cotangents, each reads all of them for its units' dh).
#pragma once

#include "common.cuh"

namespace {

constexpr int TH = 64;               // hidden width
constexpr int TG = 4 * TH;           // gate columns
constexpr int TP_WARPS = 4;          // warps a block
constexpr int TP_THREADS = 32 * TP_WARPS;
constexpr int TP_ROWS = 16;          // windows a warp tile (mma's M)
constexpr int TP_MAX_FKT = 4;        // the register instances' input k-tiles
constexpr int TP_OPASS = 64;         // outputs a head pass (16 a warp)
constexpr int TP_DBL = 4 * 16 + 8;   // padded row of a warp's gate-cotangent sums (its columns)

// A block's shared memory for nkt input k-tiles and op head columns (O
// padded to TP_OPASS; the register instances: nkt = FKT, op = TP_OPASS);
// with gw, wi and wfc stay in device memory (gwi, gwfc).
struct TPSmem {
  __nv_bfloat16* W;    // [16 nkt + 64][TG] swizzled: wi (rows F .. 16 nkt zero), then wh;
                       // with gw wh alone
  __nv_bfloat16* WFC;  // [64][op] swizzled: wfc, outputs past O zero (none with gw)
  float* b;            // [TG]
  float* bfc;          // [op], zero past O
  __nv_bfloat16* H;    // [2][16][64] swizzled: h_t of the tile, double-buffered by step
  float* dbl;          // backward: [warps][4][TP_DBL] partial sums of the warp's dg columns
  float* dbfcl;        // backward: [warps][4][dbfc_ld] partial sums of its dz columns
  __nv_bfloat16* DG;   // backward: [2][16][TG] swizzled: a step's bf16 dg, double-buffered
  __nv_bfloat16* DZ;   // backward: [16][op] swizzled: the head's bf16 dz
  int nkt;
  int op;
  int dbfc_ld;         // 16 a head pass, + 8
  int wh0;             // wh's first row in W
  const float* gwi;    // with gw: wi [F][TG] f32 in device memory, else null
  const float* gwfc;   // with gw: wfc [64][O] f32 in device memory, else null
  int F, O;
};

__host__ __device__ inline size_t tp_align16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline int tp_op(int O) { return (O + TP_OPASS - 1) / TP_OPASS * TP_OPASS; }

__host__ __device__ inline size_t tp_carve(unsigned char* base, TPSmem* s, int nkt, int op,
                                           bool bwd, bool gw = false) {
  size_t o = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + o;
    o += tp_align16(bytes);
    return p;
  };
  const int dbfc_ld = 16 * (op / TP_OPASS) + 8;
  unsigned char* w = take((size_t)((gw ? 0 : 16 * nkt) + TH) * TG * 2);
  unsigned char* wfc = gw ? nullptr : take((size_t)TH * op * 2);
  unsigned char* b = take((size_t)TG * 4);
  unsigned char* bfc = take((size_t)op * 4);
  unsigned char* h = take((size_t)2 * TP_ROWS * TH * 2);
  unsigned char* dbl = bwd ? take((size_t)TP_WARPS * 4 * TP_DBL * 4) : nullptr;
  unsigned char* dbfcl = bwd ? take((size_t)TP_WARPS * 4 * dbfc_ld * 4) : nullptr;
  unsigned char* dg = bwd ? take((size_t)2 * TP_ROWS * TG * 2) : nullptr;
  unsigned char* dz = bwd ? take((size_t)TP_ROWS * op * 2) : nullptr;
  if (s) {
    s->nkt = nkt;
    s->op = op;
    s->dbfc_ld = dbfc_ld;
    s->wh0 = gw ? 0 : 16 * nkt;
    s->gwi = s->gwfc = nullptr;
    s->F = s->O = 0;
    s->W = reinterpret_cast<__nv_bfloat16*>(w);
    s->WFC = reinterpret_cast<__nv_bfloat16*>(wfc);
    s->b = reinterpret_cast<float*>(b);
    s->bfc = reinterpret_cast<float*>(bfc);
    s->H = reinterpret_cast<__nv_bfloat16*>(h);
    s->dbl = reinterpret_cast<float*>(dbl);
    s->dbfcl = reinterpret_cast<float*>(dbfcl);
    s->DG = reinterpret_cast<__nv_bfloat16*>(dg);
    s->DZ = reinterpret_cast<__nv_bfloat16*>(dz);
  }
  return o;
}

struct TPLeaves {
  const float* wi;   // [F, 4H]
  const float* wh;   // [H, 4H]
  const float* b;    // [4H]
  const float* wfc;  // [H, O]
  const float* bfc;  // [O]
};

// The block's weights into shared memory, rounded to bf16 as the reference
// rounds them (with gw: wh, b and bfc; wi and wfc stay in device memory);
// the caller synchronises.
__device__ __forceinline__ void tp_fill(TPSmem& s, const TPLeaves& l, int F, int O, bool gw,
                                        int j) {
  s.F = F;
  s.O = O;
  s.gwi = gw ? l.wi : nullptr;
  s.gwfc = gw ? l.wfc : nullptr;
  const int KX = s.wh0;
  for (int idx = j; idx < (KX + TH) * (TG / 2); idx += TP_THREADS) {
    const int r = idx / (TG / 2);
    const int c = (idx - r * (TG / 2)) * 2;
    const float* src = r >= KX ? l.wh + (size_t)(r - KX) * TG + c
                       : r < F ? l.wi + (size_t)r * TG + c : nullptr;
    *reinterpret_cast<__nv_bfloat162*>(s.W + swzw(r, c, TG)) =
        src ? __floats2bfloat162_rn(__ldg(src), __ldg(src + 1)) : __floats2bfloat162_rn(0.f, 0.f);
  }
  for (int idx = j; !gw && idx < TH * s.op; idx += TP_THREADS) {
    const int r = idx / s.op;
    const int c = idx - r * s.op;
    s.WFC[swzw(r, c, s.op)] = __float2bfloat16_rn(c < O ? __ldg(l.wfc + r * O + c) : 0.f);
  }
  for (int c = j; c < TG; c += TP_THREADS) s.b[c] = __ldg(l.b + c);
  for (int c = j; c < s.op; c += TP_THREADS) s.bfc[c] = c < O ? __ldg(l.bfc + c) : 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The B fragments of two n-tiles (b[0..1]: columns c0 .. c0 + 7, b[2..3]:
// c0 + 8 .. c0 + 15) of rows k0 .. k0 + 15 of a matrix M[k][c] = w[k sk + c
// sc] in device memory, zero past kmax rows and cmax columns, rounded to
// bf16: the fragments ldmatrix gives from the same values in shared memory.
__device__ __forceinline__ void tp_b_global(uint32_t (&b)[4], const float* __restrict__ w,
                                            int sk, int sc, int kmax, int cmax, int k0, int c0,
                                            int lane) {
  const int k = k0 + 2 * (lane & 3);
  const int n = lane >> 2;
  auto v = [&](int kk, int cc) {
    return kk < kmax && cc < cmax ? __ldg(w + (size_t)kk * sk + (size_t)cc * sc) : 0.f;
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 8 * h + n;
    b[2 * h] = pack_bf16(v(k, c), v(k + 1, c));
    b[2 * h + 1] = pack_bf16(v(k + 8, c), v(k + 9, c));
  }
}

// 1 / (1 + e^-v), the reciprocal correctly rounded (the bits of 1.0f / ...).
__device__ __forceinline__ float tp_sigmoid(float v) { return __frcp_rn(1.0f + expf(-v)); }

// Staging of the backward (stage A) for a chunk of windows, n_pad rows a
// step: the bf16 operands of stage B's weight products, and the f32 c of
// every step for the BPTT.
struct TPStage {
  __nv_bfloat16* xs;  // [T][n_pad][16 nkt] x_t
  __nv_bfloat16* hs;  // [T][n_pad][64] h_1 .. h_T
  __nv_bfloat16* dg;  // [T][n_pad][TG] the gate cotangents
  __nv_bfloat16* dz;  // [n_pad][op] the head's cotangent, op = O padded to 8
  float4* cs;         // [n_pad / 16][T][8][32] c in fragment order
  int n_pad;
  int op;
};

// Where a thread of a tile reads and writes: its rows (windows) ra = n0 +
// lane / 4 and rb = ra + 8, the window count and shapes.
struct TPRows {
  int ra, rb;
  int N, T, F, O;
};

// The A fragment of x_t's k-tile kt for the warp's rows, rounded to bf16
// (zeros past F and past N).  x: [N, T, F] f32.
__device__ __forceinline__ void tp_x_frag(uint32_t (&xf)[4], const float* __restrict__ x,
                                          const TPRows& r, int t, int kt, int q) {
  auto ld = [&](int row, int c) {
    return row < r.N && c < r.F ? __ldg(x + ((size_t)row * r.T + t) * r.F + c) : 0.f;
  };
  const int c0 = kt * 16 + 2 * q;
  xf[0] = pack_bf16(ld(r.ra, c0), ld(r.ra, c0 + 1));
  xf[1] = pack_bf16(ld(r.rb, c0), ld(r.rb, c0 + 1));
  xf[2] = pack_bf16(ld(r.ra, c0 + 8), ld(r.ra, c0 + 9));
  xf[3] = pack_bf16(ld(r.rb, c0 + 8), ld(r.rb, c0 + 9));
}

template <int FKT>
__device__ __forceinline__ void tp_x_frags(uint32_t (&xf)[FKT][4], const float* __restrict__ x,
                                           const TPRows& r, int t, int q) {
#pragma unroll
  for (int kt = 0; kt < FKT; ++kt) tp_x_frag(xf[kt], x, r, t, kt, q);
}

// Pass p of a step's gate product: acc[g][s] is the n-tile of gate g over
// hidden units 16 p + 8 s .. + 7, summed over [x_t | h_{t-1}] [wi; wh]
// (the bias not yet added).
template <int FKT>
__device__ __forceinline__ void tp_gate_pass(float (&acc)[4][2][4], const uint32_t (&xf)[FKT][4],
                                             const uint32_t (&hf)[4][4], const TPSmem& s, int p,
                                             int lane) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[g][h][v] = 0.f;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = p * 16 + (lane >> 4) * 8;
  auto ktile = [&](const uint32_t(&a)[4], int row0) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t b[4];
      ldsm_x4_t(b, s.W + swzw(row0 + lrow, g * TH + lcol, TG));
      mma_bf16(acc[g][0], a, b[0], b[1]);
      mma_bf16(acc[g][1], a, b[2], b[3]);
    }
  };
#pragma unroll
  for (int kt = 0; kt < FKT; ++kt) ktile(xf[kt], kt * 16);
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) ktile(hf[kt], 16 * FKT + kt * 16);
}

// tp_gate_pass for the generic instance (FKT = 0): x's s.nkt k-tiles looped,
// each fragment loaded where the product takes it; with `st` warp kt % 4
// stages k-tile kt of x_t.
__device__ __forceinline__ void tp_gate_pass_rt(float (&acc)[4][2][4], const float* __restrict__ x,
                                                const TPRows& r, int t,
                                                const uint32_t (&hf)[4][4], const TPSmem& s,
                                                int p, const TPStage* st, int lane) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[g][h][v] = 0.f;
  const int q = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = p * 16 + (lane >> 4) * 8;
  auto ktile = [&](const uint32_t(&a)[4], int row0) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t b[4];
      ldsm_x4_t(b, s.W + swzw(row0 + lrow, g * TH + lcol, TG));
      mma_bf16(acc[g][0], a, b[0], b[1]);
      mma_bf16(acc[g][1], a, b[2], b[3]);
    }
  };
  const int fk = 16 * s.nkt;
  for (int kt = 0; kt < s.nkt; ++kt) {
    uint32_t xf[4];
    tp_x_frag(xf, x, r, t, kt, q);
    if (st && (kt & 3) == p)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (i & 1) ? r.rb : r.ra;
        const int col = kt * 16 + (i >> 1) * 8 + 2 * q;
        *reinterpret_cast<uint32_t*>(st->xs + ((size_t)t * st->n_pad + row) * fk + col) = xf[i];
      }
    if (s.gwi) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint32_t b[4];
        tp_b_global(b, s.gwi, TG, 1, s.F, TG, kt * 16, g * TH + p * 16, lane);
        mma_bf16(acc[g][0], xf, b[0], b[1]);
        mma_bf16(acc[g][1], xf, b[2], b[3]);
      }
    } else {
      ktile(xf, kt * 16);
    }
  }
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) ktile(hf[kt], s.wh0 + kt * 16);
}

// The four gates of value v of n-tile pair (p, sub): the bias added after
// both products, then the activations.
struct Gates {
  float i, f, g, o;
};

__device__ __forceinline__ Gates tp_gates(const float (&acc)[4][2][4], const float2 (&bg)[4],
                                          int sub, int v) {
  const int e = v & 1;
  auto bias = [&](int g) { return e ? bg[g].y : bg[g].x; };
  Gates r;
  r.i = tp_sigmoid(acc[0][sub][v] + bias(0));
  r.f = tp_sigmoid(acc[1][sub][v] + bias(1));
  r.g = tanhf(acc[2][sub][v] + bias(2));
  r.o = tp_sigmoid(acc[3][sub][v] + bias(3));
  return r;
}

// The bias pairs of the thread's columns in n-tile pair (p, sub).
__device__ __forceinline__ void tp_bias(float2 (&bg)[4], const TPSmem& s, int p, int sub, int q) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
    bg[g] = *reinterpret_cast<const float2*>(s.b + g * TH + p * 16 + sub * 8 + 2 * q);
}

// A fragments of a swizzled bf16 [16][w] tile in shared memory, k-tiles
// k0 .. k0 + NK - 1.
template <int NK>
__device__ __forceinline__ void tp_a_frags(uint32_t (&a)[NK][4], const __nv_bfloat16* tile,
                                           int w, int k0, int lane) {
#pragma unroll
  for (int kt = 0; kt < NK; ++kt)
    ldsm_x4(a[kt], tile + swzw(lane & 15, (k0 + kt) * 16 + (lane >> 4) * 8, w));
}

// The forward over T steps for the tile's 16 windows, warp `warp`'s units;
// ends synchronised, with h_T in s.H + ((T - 1) & 1) * 16 * 64.  With st
// (the backward's stage A) every step's x_t, h_t and c_t are staged (tile:
// the tile's index in the chunk).
template <int FKT>
__device__ __forceinline__ void tp_forward_steps(const TPSmem& s, const float* __restrict__ x,
                                                 const TPRows& r, const TPStage* st, int tile,
                                                 int warp, int lane) {
  const int q = lane & 3;
  float c[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) c[u][v] = 0.f;
  constexpr int NX = FKT > 0 ? FKT : 1;
  uint32_t xn[NX][4];  // the next step's x, loaded a step ahead (FKT > 0)
  if constexpr (FKT > 0) tp_x_frags<FKT>(xn, x, r, 0, q);
  for (int t = 0; t < r.T; ++t) {
    uint32_t xf[NX][4], hf[4][4];
    if constexpr (FKT > 0) {
#pragma unroll
      for (int kt = 0; kt < FKT; ++kt)
#pragma unroll
        for (int i = 0; i < 4; ++i) xf[kt][i] = xn[kt][i];
      if (t + 1 < r.T) tp_x_frags<FKT>(xn, x, r, t + 1, q);
      if (st && warp < FKT) {  // warp w stages x's k-tile w
        constexpr int FK = 16 * FKT;
#pragma unroll
        for (int kt = 0; kt < FKT; ++kt)
          if (kt == warp)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = (i & 1) ? r.rb : r.ra;
              const int col = kt * 16 + (i >> 1) * 8 + 2 * q;
              *reinterpret_cast<uint32_t*>(st->xs + ((size_t)t * st->n_pad + row) * FK + col) =
                  xf[kt][i];
            }
      }
    }
    if (t > 0) {
      tp_a_frags<4>(hf, s.H + ((t - 1) & 1) * TP_ROWS * TH, TH, 0, lane);
    } else {
#pragma unroll
      for (int kt = 0; kt < 4; ++kt)
#pragma unroll
        for (int i = 0; i < 4; ++i) hf[kt][i] = 0u;
    }
    float acc[4][2][4];
    if constexpr (FKT > 0)
      tp_gate_pass<FKT>(acc, xf, hf, s, warp, lane);
    else
      tp_gate_pass_rt(acc, x, r, t, hf, s, warp, st, lane);
    __nv_bfloat16* hn = s.H + (t & 1) * TP_ROWS * TH;
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      float2 bg[4];
      tp_bias(bg, s, warp, sub, q);
      float h[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const Gates G = tp_gates(acc, bg, sub, v);
        c[sub][v] = G.f * c[sub][v] + G.i * G.g;
        h[v] = G.o * tanhf(c[sub][v]);
      }
      const int col = warp * 16 + sub * 8 + 2 * q;
      const uint32_t lo = pack_bf16(h[0], h[1]), hi = pack_bf16(h[2], h[3]);
      *reinterpret_cast<uint32_t*>(hn + swzw(lane >> 2, col, TH)) = lo;
      *reinterpret_cast<uint32_t*>(hn + swzw((lane >> 2) + 8, col, TH)) = hi;
      if (st) {
        st->cs[(((size_t)tile * r.T + t) * 8 + 2 * warp + sub) * 32 + lane] =
            make_float4(c[sub][0], c[sub][1], c[sub][2], c[sub][3]);
        *reinterpret_cast<uint32_t*>(st->hs + ((size_t)t * st->n_pad + r.ra) * TH + col) = lo;
        *reinterpret_cast<uint32_t*>(st->hs + ((size_t)t * st->n_pad + r.rb) * TH + col) = hi;
      }
    }
    __syncthreads();
  }
}

// The head's pre-activation z = bf16(h_T) bf16(wfc) (bias not added) for
// the tile's rows and warp `warp`'s outputs of head pass p: n-tile s covers
// outputs 64 p + 16 warp + 8 s .. + 7 (zeros past O).
__device__ __forceinline__ void tp_head(float (&z)[2][4], const TPSmem& s, int T, int O, int p,
                                        int warp, int lane) {
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int v = 0; v < 4; ++v) z[o][v] = 0.f;
  if (p * TP_OPASS + warp * 16 >= O) return;
  uint32_t hf[4][4];
  tp_a_frags<4>(hf, s.H + ((T - 1) & 1) * TP_ROWS * TH, TH, 0, lane);
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    uint32_t b[4];
    if (s.gwfc)
      tp_b_global(b, s.gwfc, s.O, 1, TH, s.O, kt * 16, p * TP_OPASS + warp * 16, lane);
    else
      ldsm_x4_t(b, s.WFC + swzw(kt * 16 + lrow, p * TP_OPASS + warp * 16 + (lane >> 4) * 8, s.op));
    mma_bf16(z[0], hf[kt], b[0], b[1]);
    mma_bf16(z[1], hf[kt], b[2], b[3]);
  }
}

}  // namespace
