// The encoder's tensor-core tile: one tile of TA rows (16, or 8 where a
// 16-row tile does not fit a block's shared memory) of the encoder + linear
// head (PartialAttentionEncoder), as __device__ functions shared by the
// forward kernel (fused_encoder.cu), stage A of the backward
// (fused_encoder_bwd.cu) and the forward + loss + actor-backward kernel
// (fused_encoder_loss.cu).
//
// `tc_forward` is `_forward_core` (mupe_tpu/ops/fused_encoder.py:278-364) to
// LN2 at its rounding points: with FWD (the forward kernel) it keeps only
// what the forward reads; otherwise it also keeps the residuals that
// `tc_backward` reads.  `tc_backward` is `_backward_core` (:377-463) without
// its `_mm_tn` weight products: it writes their bf16 operands to staging
// buffers in device memory (weight_grad.cu sums them, stage B) and keeps the
// column sums (biases, LayerNorm) and the head's gradient in registers
// across the block's tiles.
//
// Every product runs on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 sums), computed transposed, out^T = W^T X^T: the 128 output features
// are mma's M (each of the 8 warps takes 16), the tile's rows its N (8 a
// step).  The weights reach shared memory one matrix at a time, in the order
// the products take them (`WSeq`): the backward's from bf16 copies that the
// wrapper makes, through two slots filled by cp.async while the previous
// product runs (`Ring`); the forward's from the f32 leaves themselves,
// converted to bf16 as one slot is filled (`Slot`; two blocks share an SM and
// hide each other's fills).  Each warp loads its fragments of a matrix into
// registers with ldmatrix (.trans for the forward's X W, plain for the
// backward's dY W^T, so no transposed copy exists).  The k and v products and
// their backward take every token's rows against one load of the weight.
// The embeds' K is padded to 16 with zeros, exactly; their stacked weights
// take one or two ring entries of at most 128 rows.  LayerNorm, softmax, GELU
// and their backwards stay f32 on the CUDA cores.  A block has 8 warps: each
// takes 16 features of a product; thread j owns column j % 128 of half the
// tile's rows (j / 128 says which half); warps own rows for the row
// reductions.
#pragma once

#include "common.cuh"

namespace {

constexpr int NTA = 256;    // threads a block: 8 warps; two threads a column, each half the rows
constexpr int FP = E + 4;   // f32 row stride (conflict-free mma epilogues)
constexpr int MAX_BINS = 2;  // ring entries of the stacked embed weights
// weight loads per tile (agrad: two forwards, a backward)
constexpr int MAX_SEQ = 2 * (MAX_BINS + 6) + 6;
constexpr int MAX_PARTS = MAX_SEQ + 2 * MAX_GROUPS;
constexpr int MAX_XW = 448;  // the rows' bf16 width: obs_dim <= 160 plus each token's padding
// Instances take up to NTM tokens: TOK_NARROW (the tiles of up to 8 tokens,
// 16 or 8 rows) or MAX_TOK (8 rows).  Past TOK_NARROW a backward tile keeps
// LN0's n in device memory, in a per-block scratch, not in shared memory.
constexpr int TOK_NARROW = 8;
constexpr int N_FIXED_COLS = 12;  // column-sum leaves after the groups' biases
// bf16 weight copies of a network: the embeds' (every group's, stacked, each
// K padded to 16 with zero rows), then these
enum { B_Q = 1, B_K, B_V, B_O, B_1, B_2, B_H, N_BW };
// staged operands (token-major [n_tok][S_pad][E] or [S_pad][E]), then the
// groups' x slices [k][S_pad][KP]
enum { S_H, S_DK, S_DV, S_DE, S_ATT, S_Y1, S_F, S_DQ, S_DR1, S_DPRE1, S_DR2, N_STAGED };

// The token layout with the embeds' K padded to 16: token t reads columns
// xcol[t] .. xcol[t] + kp[t] of the tile's bf16 rows Xb (xw wide).  Group
// g's stacked embed weight sits in ring entry g_bin[g] from row g_roff[g].
struct TcLayout {
  TokenLayout lay;
  int kp[MAX_TOK];
  int xcol[MAX_TOK];
  int tok_in_group[MAX_TOK];
  int xw;
  int g_kp[MAX_GROUPS];
  int g_bin[MAX_GROUPS];
  int g_roff[MAX_GROUPS];
  int bin_rows[MAX_BINS];
  int n_bins;
};

inline bool make_tc_layout(const TokenLayout& lay, TcLayout& L) {
  L.lay = lay;
  int c = 0;
  int seen[MAX_GROUPS] = {0, 0, 0, 0};
  for (int t = 0; t < lay.n_tokens; ++t) {
    L.kp[t] = (lay.tok_dim[t] + 15) / 16 * 16;
    L.xcol[t] = c;
    L.tok_in_group[t] = seen[lay.tok_group[t]]++;
    L.g_kp[lay.tok_group[t]] = L.kp[t];
    c += L.kp[t];
  }
  L.xw = (c + 63) / 64 * 64;
  // the groups' weights in order, a new entry where the next one would pass
  // 128 rows; more than two entries are refused (`kernel_spec_ok` in
  // ops/fused_encoder.py applies the same rule)
  L.n_bins = 1;
  L.bin_rows[0] = L.bin_rows[1] = 0;
  for (int g = 0; g < lay.n_groups; ++g) {
    if (L.g_kp[g] > E) return false;
    if (L.bin_rows[L.n_bins - 1] + L.g_kp[g] > E) {
      if (L.n_bins == MAX_BINS) return false;
      ++L.n_bins;
    }
    L.g_bin[g] = L.n_bins - 1;
    L.g_roff[g] = L.bin_rows[L.n_bins - 1];
    L.bin_rows[L.n_bins - 1] += L.g_kp[g];
  }
  return L.xw <= MAX_XW;
}

// One block of rows of a weight matrix in a slot: `rows` rows (a multiple
// of 16), the first `valid` read from src ([valid][E] row-major), the rest
// zeros.
struct WPart {
  const void* src;
  int valid;
  int rows;
};

// The weight matrices a tile loads, in the order its products take them:
// entry i is parts first[i] .. first[i + 1] - 1, stacked in the slot.
struct WSeq {
  WPart part[MAX_PARTS];
  int first[MAX_SEQ + 1];
  int len;
  int n_parts;
};

// Appends a part to the open entry of a zero-initialised sequence.
inline void seq_part(WSeq& s, const void* src, int valid, int rows) {
  s.part[s.n_parts++] = {src, valid, rows};
}

inline void seq_close(WSeq& s) { s.first[++s.len] = s.n_parts; }

// The sequence of one network's forward (embeds, q, k, v, o, w1, w2), and
// with `bwd` its backward's (w2, w1, o, q, k, v), appended to `s`, from the
// wrapper's bf16 copies `wb` (the embeds stacked, each group's rows padded to
// 16 with zero rows).
inline void seq_append(WSeq& s, const TcLayout& L, const __nv_bfloat16* const* wb, bool bwd) {
  int r0 = 0;
  for (int b = 0; b < L.n_bins; ++b) {
    seq_part(s, wb[0] + (size_t)r0 * E, L.bin_rows[b], L.bin_rows[b]);
    seq_close(s);
    r0 += L.bin_rows[b];
  }
  const int fwd[6] = {B_Q, B_K, B_V, B_O, B_1, B_2};
  const int back[6] = {B_2, B_1, B_O, B_Q, B_K, B_V};
  for (int i = 0; i < 6; ++i) {
    seq_part(s, wb[fwd[i]], E, E);
    seq_close(s);
  }
  for (int i = 0; bwd && i < 6; ++i) {
    seq_part(s, wb[back[i]], E, E);
    seq_close(s);
  }
}

// The forward's sequence from the network's f32 leaves (canonical order):
// each group's embed weight [d][E] a part of its entry, d rows read and its K
// padded to 16 with zeros.
inline void seq_append_f32(WSeq& s, const TcLayout& L, const float* const* leaf) {
  for (int b = 0; b < L.n_bins; ++b) {
    for (int g = 0; g < L.lay.n_groups; ++g) {
      if (L.g_bin[g] != b) continue;
      int t = 0;
      while (L.lay.tok_group[t] != g) ++t;
      seq_part(s, leaf[2 * g], L.lay.tok_dim[t], L.g_kp[g]);
    }
    seq_close(s);
  }
  const int base = 2 * L.lay.n_groups;
  const int fwd[6] = {2, 4, 6, 8, 12, 14};  // wq, wk, wv, wo, w1, w2
  for (int i = 0; i < 6; ++i) {
    seq_part(s, leaf[base + fwd[i]], E, E);
    seq_close(s);
  }
}

// The backward's weight slots: `take` returns the slot holding the next
// matrix of the sequence (waiting for its copy) and starts the copy of the
// one after it into the other slot, whose previous matrix every warp has by
// then loaded into registers (the __syncthreads in between).
struct Ring {
  __nv_bfloat16* slot[2];
  int cur;
  int i;

  __device__ __forceinline__ void issue(__nv_bfloat16* dst, const WSeq& s, int e, int j) {
    int r0 = 0;
    for (int p = s.first[e]; p < s.first[e + 1]; ++p) {
      const WPart w = s.part[p];
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(w.src);
      for (int idx = j; idx < w.rows * (E / 8); idx += NTA) {
        const int r = idx >> 4;
        const int c = (idx & 15) * 8;
        cp_async16(dst + swz(r0 + r, c), src + (r < w.valid ? r * E + c : 0),
                   r < w.valid ? 16 : 0);
      }
      r0 += w.rows;
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void start(unsigned char* smem, const WSeq& s, int j) {
    slot[0] = reinterpret_cast<__nv_bfloat16*>(smem);
    slot[1] = slot[0] + E * E;
    cur = 0;
    i = 0;
    issue(slot[0], s, 0, j);
  }

  __device__ __forceinline__ const __nv_bfloat16* take(const WSeq& s, int j) {
    cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16* w = slot[cur];
    cur ^= 1;
    i = i + 1 == s.len ? 0 : i + 1;  // the next tile starts the sequence again
    issue(slot[cur], s, i, j);
    return w;
  }
};

// The forward's one slot: `take` waits until every warp has its fragments of
// the previous matrix, fills the slot with the next one from its f32 source
// (plain loads, rounded to bf16 as the reference rounds the weights), and
// returns it.
struct Slot {
  __nv_bfloat16* w;
  int i;

  __device__ __forceinline__ const __nv_bfloat16* take(const WSeq& s, int j) {
    __syncthreads();
    int r0 = 0;
    for (int p = s.first[i]; p < s.first[i + 1]; ++p) {
      const WPart part = s.part[p];
      const float* src = static_cast<const float*>(part.src);
#pragma unroll 4
      for (int idx = j; idx < part.rows * (E / 8); idx += NTA) {
        const int r = idx >> 4;
        const int c = (idx & 15) * 8;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
        if (r < part.valid) {
          a = __ldg(reinterpret_cast<const float4*>(src + r * E + c));
          b = __ldg(reinterpret_cast<const float4*>(src + r * E + c + 4));
        }
        __align__(16) __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y),
                                            __floats2bfloat162_rn(a.z, a.w),
                                            __floats2bfloat162_rn(b.x, b.y),
                                            __floats2bfloat162_rn(b.z, b.w)};
        *reinterpret_cast<uint4*>(w + swz(r0 + r, c)) = *reinterpret_cast<const uint4*>(h);
      }
      r0 += part.rows;
    }
    i = i + 1 == s.len ? 0 : i + 1;
    __syncthreads();
    return w;
  }
};

// Fragments (A operands) of the warp's 16 output features for nks k-steps.
// Forward, out = X W: A = W^T, from the slot W[k][m] with .trans.
__device__ __forceinline__ void frags_fwd(const __nv_bfloat16* W, int nks, uint32_t (&fr)[8][4],
                                          int warp, int lane) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    if (ks < nks)
      ldsm_x4_t(fr[ks], W + swz(ks * 16 + (lane & 7) + ((lane >> 4) << 3),
                                warp * 16 + ((lane >> 3) & 1) * 8));
}

// Backward, dx = dy W^T: A = W, from the slot W[m][k] as it is.
__device__ __forceinline__ void frags_bwd(const __nv_bfloat16* W, uint32_t (&fr)[8][4], int warp,
                                          int lane) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    ldsm_x4(fr[ks], W + swz(warp * 16 + (lane & 15), ks * 16 + (lane >> 4) * 8));
}

// The output feature of value v of an m16n8 fragment for the warp's 16.
__device__ __forceinline__ int frag_feature(int warp, int lane, int v) {
  return warp * 16 + (lane >> 2) + 8 * (v >> 1);
}

// acc += a b for one k-step of 16, the step's sum taken by the tensor core
// from zero and added to acc on the CUDA cores (round to nearest), so that
// the tensor core's truncating accumulation spans one step, not a product's
// 8.  Its sums still part from the plain version's (cuBLAS, f32) more than
// the CUDA-core kernels' did: the gradients' mean errors sit 1.2-1.5x higher
// (scripts/torch_tolerance_survey.py).
__device__ __forceinline__ void mma_step(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a, b0, b1);
#pragma unroll
  for (int v = 0; v < 4; ++v) acc[v] += t[v];
}

// Runs the warp's part of out^T = A X^T over n_rows rows of X (bf16 [row][k]
// in shared memory, xw wide, K from column xcol) and calls
// epi(row, feature, value) for each of its outputs.
template <class Epi>
__device__ __forceinline__ void tc_run(const uint32_t (&fr)[8][4], int nks,
                                       const __nv_bfloat16* X, int xw, int xcol, int n_rows,
                                       int warp, int lane, Epi epi) {
  for (int nb = 0; nb < n_rows / 8; ++nb) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (ks < nks) {
        uint32_t b[2];
        ldsm_x2(b, X + swzw(nb * 8 + (lane & 7), xcol + ks * 16 + ((lane >> 3) & 1) * 8, xw));
        mma_step(acc, fr[ks], b[0], b[1]);
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v)
      epi(nb * 8 + 2 * (lane & 3) + (v & 1), frag_feature(warp, lane, v), acc[v]);
  }
}

// The tile's buffers in shared memory (bf16 ones swizzled, E wide unless
// said otherwise).  With FWD the residuals of the backward are absent (null),
// v takes k's bytes and pre1 q's.
struct TcBufs {
  __nv_bfloat16* Hb;   // [ntr] embeds, then h_all; its bytes hold G, G2 after the k/v products
  __nv_bfloat16* N0b;  // [ntr] LN0's n (device memory past TOK_NARROW tokens)
  __nv_bfloat16* Kb;   // [ntr] k, then dk
  __nv_bfloat16* Vb;   // [ntr] v, then dv
  __nv_bfloat16* Xb;   // [TA][xw] the rows, bf16, each token's K padded to 16
  __nv_bfloat16* OPb;  // [TA] att, then y1, then f
  __nv_bfloat16* Y2b;  // [TA] LN2's output
  __nv_bfloat16* Rb;   // [TA] the rounded cotangent operand
  __nv_bfloat16* DOb;  // [TA][8] the head's cotangent, bf16 (not swizzled)
  __nv_bfloat16* WH[2];  // [E][8] bf16 head weights, zero past the head (not swizzled)
  float* Q;            // [TA][FP] q
  float* H0;           // [TA][FP] h0, r1, y1; then datt, dh
  float* N1;
  float* N2;
  float* PRE1;
  float* G;            // [TA][FP] r2, dy2, dr2, dy1, dr1 (in Hb's bytes)
  float* G2;           // [TA][FP] dpre1, dq, dq wq^T (in Hb's bytes)
  float* inv0;         // [ntr]
  float* inv1;         // [TA]
  float* inv2;         // [TA]
  float* P;            // [TA][NTM] scores, then softmax weights
  float* DS;           // [TA][NTM]
  float* DOUT;         // [TA][MAX_HEAD] the head's cotangent, f32
  float* ACC;          // streamed tiles: [TA][FP] att, then dq, summed a chunk at a time
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Carves a block's shared memory: the weight slots (two, or one with FWD),
// then the buffers; fills `b` unless null (past TOK_NARROW tokens the caller
// points b->N0b at its scratch).  Returns the bytes.
template <int TA, bool FWD, int NTM>
__host__ __device__ inline size_t tc_carve(unsigned char* base, int n_tokens, int xw,
                                           TcBufs* b) {
  const size_t ntr = (size_t)n_tokens * TA;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + o;
    o += align16(bytes);
    return p;
  };
  auto bf = [](unsigned char* p) { return reinterpret_cast<__nv_bfloat16*>(p); };
  auto f32 = [](unsigned char* p) { return reinterpret_cast<float*>(p); };
  take((size_t)(FWD ? 1 : 2) * E * E * 2);
  const size_t h = ntr * E * 2, g = (size_t)2 * TA * FP * 4;
  unsigned char* hb = take(h > g ? h : g);
  unsigned char* n0b = FWD || NTM > TOK_NARROW ? nullptr : take(ntr * E * 2);
  unsigned char* kb = take(ntr * E * 2);
  unsigned char* vb = FWD ? kb : take(ntr * E * 2);
  unsigned char* xb = take((size_t)TA * xw * 2);
  unsigned char* opb = take((size_t)TA * E * 2);
  unsigned char* y2b = take((size_t)TA * E * 2);
  unsigned char* rb = FWD ? nullptr : take((size_t)TA * E * 2);
  unsigned char* dob = FWD ? nullptr : take((size_t)TA * 8 * 2);
  unsigned char* wh0 = take((size_t)E * 8 * 2);
  unsigned char* wh1 = FWD ? nullptr : take((size_t)E * 8 * 2);
  unsigned char* q = take((size_t)TA * FP * 4);
  unsigned char* h0 = take((size_t)TA * FP * 4);
  unsigned char* n1 = FWD ? nullptr : take((size_t)TA * FP * 4);
  unsigned char* n2 = FWD ? nullptr : take((size_t)TA * FP * 4);
  unsigned char* pre1 = FWD ? q : take((size_t)TA * FP * 4);
  unsigned char* inv0 = FWD ? nullptr : take(ntr * 4);
  unsigned char* inv1 = FWD ? nullptr : take((size_t)TA * 4);
  unsigned char* inv2 = FWD ? nullptr : take((size_t)TA * 4);
  unsigned char* pp = take((size_t)TA * NTM * 4);
  unsigned char* ds = FWD ? nullptr : take((size_t)TA * NTM * 4);
  unsigned char* dout = FWD ? nullptr : take((size_t)TA * MAX_HEAD * 4);
  if (b) {
    b->Hb = bf(hb);
    b->G = f32(hb);
    b->G2 = b->G + TA * FP;
    b->N0b = bf(n0b);
    b->Kb = bf(kb);
    b->Vb = bf(vb);
    b->Xb = bf(xb);
    b->OPb = bf(opb);
    b->Y2b = bf(y2b);
    b->Rb = bf(rb);
    b->DOb = bf(dob);
    b->WH[0] = bf(wh0);
    b->WH[1] = bf(wh1);
    b->Q = f32(q);
    b->H0 = f32(h0);
    b->N1 = f32(n1);
    b->N2 = f32(n2);
    b->PRE1 = f32(pre1);
    b->inv0 = f32(inv0);
    b->inv1 = f32(inv1);
    b->inv2 = f32(inv2);
    b->P = f32(pp);
    b->DS = f32(ds);
    b->DOUT = f32(dout);
    b->ACC = nullptr;
  }
  return o;
}

// The head's weights [E][hd] (bf16 copy or f32 leaf) into a bf16 [E][8]
// buffer, zeros past hd.
__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

template <class T>
__device__ __forceinline__ void load_head(__nv_bfloat16* WH, const T* wh, int hd, int j) {
  for (int idx = j; idx < E * 8; idx += NTA) {
    const int k = idx >> 3;
    const int o = idx & 7;
    WH[idx] = o < hd ? to_bf16(wh[k * hd + o]) : __float2bfloat16_rn(0.f);
  }
}

// The tile's rows into Xb as bf16, each token's K padded to 16 with zeros,
// rows past S zeros; with `xs` (the groups' staged slices), staged too.
template <int TA>
__device__ __forceinline__ void tc_load_rows(const TcLayout& L, const TcBufs& B,
                                             const float* __restrict__ x, int S, int row0,
                                             __nv_bfloat16* const* xs, size_t s_pad, int j) {
  const TokenLayout& lay = L.lay;
  for (int idx = j; idx < TA * L.xw; idx += NTA) {
    const int r = idx / L.xw;
    const int c = idx - r * L.xw;
    const int row = row0 + r;
    int t = 0;
    while (t + 1 < lay.n_tokens && c >= L.xcol[t + 1]) ++t;
    const int k = c - L.xcol[t];
    const bool in = c < L.xcol[t] + L.kp[t];
    const float v = in && k < lay.tok_dim[t] && row < S
                        ? x[(size_t)row * lay.obs_dim + lay.tok_off[t] + k] : 0.f;
    const __nv_bfloat16 b = __float2bfloat16_rn(v);
    B.Xb[swzw(r, c, L.xw)] = b;
    if (xs && in)
      xs[lay.tok_group[t]][((size_t)L.tok_in_group[t] * s_pad + row) * L.kp[t] + k] = b;
  }
}

// LN0 over the rows of nc tokens from t0 (token-major rows tl * TA + r of
// B.Hb, in place; two rows a warp at a time): with `h0`, token 0's f32
// output into B.H0; with `sth`, h staged (rows past S as zeros); with
// `keep_n`, LN0's n (bf16) into B.N0b and its inv into B.inv0.
template <int TA>
__device__ __forceinline__ void tc_ln0(const float* g0, const float* b0, const TcBufs& B, int t0,
                                       int nc, int row0, int S, bool h0, __nv_bfloat16* sth,
                                       size_t s_pad, bool keep_n, int j) {
  const int warp = j >> 5;
  const int lane = j & 31;
  const int nwarps = NTA / 32;
  const int ntr = nc * TA;
  for (int rt0 = warp; rt0 < ntr; rt0 += 2 * nwarps) {
    const bool two = rt0 + nwarps < ntr;
    float v[2][4], n[2][4], inv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c0 = swz(u == 0 || two ? rt0 + u * nwarps : rt0, lane * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[u][i] = __bfloat162float(B.Hb[c0 + i]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) ln_row_n(v[u], n[u], inv[u], g0, b0, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      const int rt = rt0 + u * nwarps;
      const int c0 = swz(rt, lane * 4);
      const int t = t0 + rt / TA;
      const int row = row0 + rt % TA;
      __align__(8) __nv_bfloat16 h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = __float2bfloat16_rn(row < S ? v[u][i] : 0.f);
        B.Hb[c0 + i] = __float2bfloat16_rn(v[u][i]);
        if (keep_n) B.N0b[c0 + i] = __float2bfloat16_rn(n[u][i]);
        if (h0 && rt < TA) B.H0[rt * FP + lane * 4 + i] = v[u][i];
      }
      if (sth)
        *reinterpret_cast<uint2*>(sth + ((size_t)t * s_pad + row) * E + lane * 4) =
            *reinterpret_cast<const uint2*>(h);
      if (keep_n && lane == 0) B.inv0[rt] = inv[u];
    }
  }
}

// out[r * stride + t0 + tl] = (A_r . X_{tl, r}) * mul for the tile's TA rows
// and nc tokens whose rows are token-major in X (row tl * TA + r): the
// scores q . k_t * scale and the backward's das_t = datt . v_t; A: f32
// [TA][FP], X: bf16 (swizzled); four (row, token) pairs a warp at a time.
template <int TA>
__device__ __forceinline__ void tc_row_dots(const float* A, const __nv_bfloat16* X, int nc,
                                            float mul, float* out, int stride, int t0, int j) {
  const int warp = j >> 5;
  const int lane = j & 31;
  const int nwarps = NTA / 32;
  for (int p0 = warp; p0 < TA * nc; p0 += 4 * nwarps) {
    float sc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = min(p0 + u * nwarps, TA * nc - 1);
      const int r = p / nc;
      const int kc = swz((p - r * nc) * TA + r, lane * 4);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s = fmaf(A[r * FP + lane * 4 + i], __bfloat162float(X[kc + i]), s);
      sc[u] = s;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) sc[u] = warp_sum(sc[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = p0 + u * nwarps;
      if (lane == 0 && p < TA * nc) {
        const int r = p / nc;
        out[r * stride + t0 + p - r * nc] = sc[u] * mul;
      }
    }
  }
}

// A row's softmax over its nt scores p, in place, in the reference's order.
__device__ __forceinline__ void tc_softmax(float* p, int nt) {
  float smax = p[0];
  for (int t = 1; t < nt; ++t) smax = fmaxf(smax, p[t]);
  float denom = 0.f;
  for (int t = 0; t < nt; ++t) {
    const float ex = expf(p[t] - smax);
    p[t] = ex;
    denom = t == 0 ? ex : denom + ex;
  }
  const float recip = 1.0f / denom;
  for (int t = 0; t < nt; ++t) p[t] = p[t] * recip;
}

// A row's softmax backward, in place: d_t = a_t (d_t - sum_u a_u d_u).
__device__ __forceinline__ void tc_softmax_bwd(const float* a, float* d, int nt) {
  float wsum = a[0] * d[0];
  for (int t = 1; t < nt; ++t) wsum = wsum + a[t] * d[t];
  for (int t = 0; t < nt; ++t) d[t] = a[t] * (d[t] - wsum);
}

template <int TA, bool FWD, class Src>
__device__ __forceinline__ void tc_forward_rows(const float* const* fixed, const TcBufs& B,
                                                Src& src, const WSeq& seq,
                                                __nv_bfloat16* const* st, int row0, int S,
                                                int j);

// `_forward_core` for the tile to LN2's output (B.Y2b), from the rows in
// B.Xb (loaded and synchronised by the caller); leaf: the network's f32
// leaves in canonical order; src: the weight slots (Ring or Slot) walking
// `seq`.  With `st` (the network's staging buffers), the tile's h_all, att,
// y1 and f are staged (rows past S as zeros).  Ends synchronised.
template <int TA, bool FWD, int NTM, class Src>
__device__ __forceinline__ void tc_forward(const TcLayout& L, const float* const* leaf,
                                           float scale, const TcBufs& B, Src& src,
                                           const WSeq& seq, __nv_bfloat16* const* st,
                                           size_t s_pad, int row0, int S, int j) {
  const TokenLayout& lay = L.lay;
  const int nt = lay.n_tokens;
  const int ntr = nt * TA;
  const int base = 2 * lay.n_groups;
  const float* g0 = leaf[base + 0];
  const float* b0 = leaf[base + 1];
  const float* bq = leaf[base + 3];
  const float* bk = leaf[base + 5];
  const float* bv = leaf[base + 7];
  const int warp = j >> 5;
  const int lane = j & 31;
  const int c = j & (E - 1);               // the thread's column
  const int rb = (j >> 7) * (TA / 2);      // and its half of the rows
  const int re = rb + TA / 2;
  uint32_t fr[8][4];

  {  // per-token embeds -> bf16 e (token-major rows t * TA + r), group by
     // group, each group's weight in its ring entry (rows a multiple of 16 apart)
    const __nv_bfloat16* W = nullptr;
    int bin = -1;
    for (int g = 0; g < lay.n_groups; ++g) {
      if (L.g_bin[g] != bin) {
        bin = L.g_bin[g];
        W = src.take(seq, j);
      }
      int t0 = 0;
      while (lay.tok_group[t0] != g) ++t0;
      frags_fwd(W + L.g_roff[g] * E, L.g_kp[g] / 16, fr, warp, lane);
      const float* bg = leaf[2 * g + 1];
      for (int t = t0; t < nt && lay.tok_group[t] == g; ++t)
        tc_run(fr, L.kp[t] / 16, B.Xb, L.xw, L.xcol[t], TA, warp, lane,
               [&](int r, int m, float v) {
                 B.Hb[swz(t * TA + r, m)] = __float2bfloat16_rn(v + __ldg(bg + m));
               });
    }
  }
  __syncthreads();

  // LN0 over every token row, in place; token 0's f32 output kept as h0
  tc_ln0<TA>(g0, b0, B, 0, nt, row0, S, true, st ? st[S_H] : nullptr, s_pad, !FWD, j);

  {  // q from the query token (its bf16 rounding is h_all's)
    const __nv_bfloat16* W = src.take(seq, j);
    frags_fwd(W, 8, fr, warp, lane);
    tc_run(fr, 8, B.Hb, E, 0, TA, warp, lane,
           [&](int r, int m, float v) { B.Q[r * FP + m] = v + __ldg(bq + m); });
  }
  // v of every token, rounded to bf16, one weight load
  auto v_all = [&]() {
    const __nv_bfloat16* W = src.take(seq, j);
    frags_fwd(W, 8, fr, warp, lane);
    tc_run(fr, 8, B.Hb, E, 0, ntr, warp, lane, [&](int r, int m, float v) {
      B.Vb[swz(r, m)] = __float2bfloat16_rn(v + __ldg(bv + m));
    });
  };
  {  // k of every token, rounded to bf16, one weight load
    const __nv_bfloat16* W = src.take(seq, j);
    frags_fwd(W, 8, fr, warp, lane);
    tc_run(fr, 8, B.Hb, E, 0, ntr, warp, lane, [&](int r, int m, float v) {
      B.Kb[swz(r, m)] = __float2bfloat16_rn(v + __ldg(bk + m));
    });
  }
  if (!FWD) v_all();  // right after k; with FWD, v takes k's bytes after the scores
  __syncthreads();

  tc_row_dots<TA>(B.Q, B.Kb, nt, scale, B.P, NTM, 0, j);  // the scores q . k_t * scale
  __syncthreads();

  if (j < TA) tc_softmax(B.P + j * NTM, nt);
  if (FWD) v_all();  // into k's bytes: the scores read them before the take's __syncthreads
  __syncthreads();

  for (int r = rb; r < re; ++r) {  // attention output sum_t a_t v_t, rounded
    float att = B.P[r * NTM] * __bfloat162float(B.Vb[swz(r, c)]);
    for (int t = 1; t < nt; ++t)
      att = fmaf(B.P[r * NTM + t], __bfloat162float(B.Vb[swz(t * TA + r, c)]), att);
    const __nv_bfloat16 a = __float2bfloat16_rn(att);
    B.OPb[swz(r, c)] = a;
    if (st) st[S_ATT][(size_t)(row0 + r) * E + c] = row0 + r < S ? a : __float2bfloat16_rn(0.f);
  }
  tc_forward_rows<TA, FWD>(leaf + base, B, src, seq, st, row0, S, j);
}

// `_forward_core` from the attention output (bf16 in B.OPb, h0 in B.H0) to
// LN2's output (B.Y2b): the part of a tile's forward that the tokens do not
// enter; fixed: the network's leaves after the groups' pairs.  Ends
// synchronised.
template <int TA, bool FWD, class Src>
__device__ __forceinline__ void tc_forward_rows(const float* const* fixed, const TcBufs& B,
                                                Src& src, const WSeq& seq,
                                                __nv_bfloat16* const* st, int row0, int S,
                                                int j) {
  const float* bo = fixed[9];
  const float* g1 = fixed[10];
  const float* b1 = fixed[11];
  const float* bf1 = fixed[13];
  const float* bf2 = fixed[15];
  const float* g2 = fixed[16];
  const float* b2 = fixed[17];
  const int warp = j >> 5;
  const int lane = j & 31;
  const int nwarps = NTA / 32;
  const int c = j & (E - 1);               // the thread's column
  const int rb = (j >> 7) * (TA / 2);      // and its half of the rows
  const int re = rb + TA / 2;
  uint32_t fr[8][4];

  {  // out-projection + residual: r1 = h0 + o (into H0)
    const __nv_bfloat16* W = src.take(seq, j);
    frags_fwd(W, 8, fr, warp, lane);
    tc_run(fr, 8, B.OPb, E, 0, TA, warp, lane,
           [&](int r, int m, float v) { B.H0[r * FP + m] += v + __ldg(bo + m); });
  }
  __syncthreads();

  for (int r = warp; r < TA; r += nwarps) {  // LN1: y1 f32 in H0, bf16 in OPb
    float v[4], n[4], inv;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = B.H0[r * FP + lane * 4 + i];
    ln_row_n(v, n, inv, g1, b1, lane);
    const int row = row0 + r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      B.H0[r * FP + lane * 4 + i] = v[i];
      if (!FWD) B.N1[r * FP + lane * 4 + i] = n[i];
      const __nv_bfloat16 y = __float2bfloat16_rn(v[i]);
      B.OPb[swz(r, lane * 4 + i)] = y;
      if (st) st[S_Y1][(size_t)row * E + lane * 4 + i] = row < S ? y : __float2bfloat16_rn(0.f);
    }
    if (!FWD && lane == 0) B.inv1[r] = inv;
  }

  {  // FFN first layer; then tanh-GELU, rounded for the second layer
    const __nv_bfloat16* W = src.take(seq, j);
    frags_fwd(W, 8, fr, warp, lane);
    tc_run(fr, 8, B.OPb, E, 0, TA, warp, lane,
           [&](int r, int m, float v) { B.PRE1[r * FP + m] = v + __ldg(bf1 + m); });
  }
  __syncthreads();
  for (int r = rb; r < re; ++r) {
    const __nv_bfloat16 f = __float2bfloat16_rn(gelu_tanh(B.PRE1[r * FP + c]));
    B.OPb[swz(r, c)] = f;
    if (st) st[S_F][(size_t)(row0 + r) * E + c] = row0 + r < S ? f : __float2bfloat16_rn(0.f);
  }

  {  // FFN second layer + residual: r2 = y1 + FFN(y1) (into G)
    const __nv_bfloat16* W = src.take(seq, j);
    frags_fwd(W, 8, fr, warp, lane);
    tc_run(fr, 8, B.OPb, E, 0, TA, warp, lane, [&](int r, int m, float v) {
      B.G[r * FP + m] = B.H0[r * FP + m] + (v + __ldg(bf2 + m));
    });
  }
  __syncthreads();

  for (int r = warp; r < TA; r += nwarps) {  // LN2, rounded for the head
    float v[4], n[4], inv;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = B.G[r * FP + lane * 4 + i];
    ln_row_n(v, n, inv, g2, b2, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!FWD) B.N2[r * FP + lane * 4 + i] = n[i];
      B.Y2b[swz(r, lane * 4 + i)] = __float2bfloat16_rn(v[i]);
    }
    if (!FWD && lane == 0) B.inv2[r] = inv;
  }
  __syncthreads();
}

// The linear head over the tile's LN2 output on the tensor cores (bf16
// operands, f32 sum): out[r * stride + o] = y2 wh + bh for o < hd and the
// first n_store rows.  Warp w < TA / 8 takes rows 8w .. 8w + 7.  The caller
// synchronises.
template <int TA>
__device__ __forceinline__ void tc_head(const TcBufs& B, const __nv_bfloat16* WH,
                                        const float* bh, int hd, float* out, int stride,
                                        int n_store, int j) {
  const int warp = j >> 5;
  const int lane = j & 31;
  if (warp >= TA / 8) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t a2[2], b[2];
    ldsm_x2_t(a2, WH + (ks * 16 + (lane & 15)) * 8);  // W_h^T: features 0-7, k and k + 8
    const uint32_t a[4] = {a2[0], 0u, a2[1], 0u};
    ldsm_x2(b, B.Y2b + swz(warp * 8 + (lane & 7), ks * 16 + ((lane >> 3) & 1) * 8));
    mma_bf16(acc, a, b[0], b[1]);
  }
  const int o = lane >> 2;
  if (o < hd)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = warp * 8 + 2 * (lane & 3) + e;
      if (r < n_store) out[r * stride + o] = acc[e] + __ldg(bh + o);
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

// A block's column sums over its tiles (a thread's column over its half of
// the rows) and its fragments of the head's weight gradient dwh = y2^T dout.
struct ColSums {
  float fixed[N_FIXED_COLS];  // g0, b0, bq, bk, bv, bo, g1, b1, bf1, bf2, g2, b2
  float bg[MAX_GROUPS];
  float bh;
  float wh[4];  // the warp's 16 features of dwh
};

__device__ __forceinline__ void colsums_zero(ColSums& c) {
#pragma unroll
  for (int i = 0; i < N_FIXED_COLS; ++i) c.fixed[i] = 0.f;
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g) c.bg[g] = 0.f;
  c.bh = 0.f;
#pragma unroll
  for (int v = 0; v < 4; ++v) c.wh[v] = 0.f;
}

enum { C_G0, C_B0, C_BQ, C_BK, C_BV, C_BO, C_G1, C_B1, C_BF1, C_BF2, C_G2, C_B2 };

// Floats in a block's slice of column sums: the groups' biases, the fixed
// column-sum leaves, the head's weight and bias.
__host__ __device__ inline int colsum_floats(int n_groups, int hd) {
  return (n_groups + N_FIXED_COLS) * E + E * hd + hd;
}

// The block's two slices (one a half of the threads: its half of the rows'
// column sums and its warps' features of dwh), at the end of its tiles;
// `slices` points at the first.
__device__ __forceinline__ void colsums_store(const ColSums& c, float* slices, int n_groups,
                                              int hd, int j) {
  const int warp = j >> 5;
  const int lane = j & 31;
  const int col = j & (E - 1);
  const int half = j >> 7;
  float* slice = slices + (size_t)half * colsum_floats(n_groups, hd);
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g)
    if (g < n_groups) slice[g * E + col] = c.bg[g];
#pragma unroll
  for (int i = 0; i < N_FIXED_COLS; ++i) slice[(n_groups + i) * E + col] = c.fixed[i];
  float* wh = slice + (n_groups + N_FIXED_COLS) * E;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int o = 2 * (lane & 3) + (v & 1);
    if (o < hd) wh[frag_feature(warp, lane, v) * hd + o] = c.wh[v];
  }
  // zeros for the features of the other half's warps, and for its bh
  for (int idx = col; idx < (E / 2) * hd; idx += E) wh[(1 - half) * (E / 2) * hd + idx] = 0.f;
  if (col < hd) wh[E * hd + col] = half == 0 ? c.bh : 0.f;
}

// The segments that sum a network's slices ([slices][colsum_floats], two a
// block) in order into its flat gradient vector (leaf offsets `off`).
inline void colsum_segments(SegArgs& a, const float* ws, int blocks, int n_groups, int hd,
                            const int* off, float* grad) {
  const int P = colsum_floats(n_groups, hd);
  const int base = 2 * n_groups;
  const int fixed[N_FIXED_COLS] = {0, 1, 3, 5, 7, 9, 10, 11, 13, 15, 16, 17};
  for (int g = 0; g < n_groups; ++g)
    a.seg[a.n++] = {ws + g * E, grad + off[2 * g + 1], blocks, P, E};
  for (int i = 0; i < N_FIXED_COLS; ++i)
    a.seg[a.n++] = {ws + (n_groups + i) * E, grad + off[base + fixed[i]], blocks, P, E};
  const int wh = (n_groups + N_FIXED_COLS) * E;
  a.seg[a.n++] = {ws + wh, grad + off[base + 18], blocks, P, E * hd};
  a.seg[a.n++] = {ws + wh + E * hd, grad + off[base + 19], blocks, P, hd};
}

// One token's part of the backward, after its bf16 dk and dv are in B.Kb and
// B.Vb (rows tl * TA + r; fr, fv: wk's and wv's fragments): dh = dk wk^T + dv
// wv^T (for token 0 plus (dh + T0a) + T0b: dr1 and dq wq^T) into DH, LN0's
// scale and bias sums, LN0's backward (n and inv from B.N0b and B.inv0 at
// the same rows), then de: group g's bias sum and de staged as token t.
// Ends synchronised.
template <int TA>
__device__ __forceinline__ void tc_token_backward(const uint32_t (&fr)[8][4],
                                                  const uint32_t (&fv)[8][4], const TcBufs& B,
                                                  int tl, int t, int g, const float* T0a,
                                                  const float* T0b, float* DH, const float* g0,
                                                  __nv_bfloat16* const* st, size_t s_pad,
                                                  int row0, int S, ColSums& cs, int j) {
  const int warp = j >> 5;
  const int lane = j & 31;
  const int nwarps = NTA / 32;
  const int c = j & (E - 1);               // the thread's column
  const int rb = (j >> 7) * (TA / 2);      // and its half of the rows
  const int re = rb + TA / 2;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int nb = 0; nb < TA / 8; ++nb) {
    float ak[4] = {0.f, 0.f, 0.f, 0.f};
    float av[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t bk2[2], bv2[2];
      const int rr = tl * TA + nb * 8 + (lane & 7);
      const int kc = ks * 16 + ((lane >> 3) & 1) * 8;
      ldsm_x2(bk2, B.Kb + swz(rr, kc));
      ldsm_x2(bv2, B.Vb + swz(rr, kc));
      mma_step(ak, fr[ks], bk2[0], bk2[1]);
      mma_step(av, fv[ks], bv2[0], bv2[1]);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = nb * 8 + 2 * (lane & 3) + (v & 1);
      const int m = frag_feature(warp, lane, v);
      float dh = ak[v] + av[v];
      if (t == 0) dh = (dh + T0a[r * FP + m]) + T0b[r * FP + m];
      DH[r * FP + m] = dh;
    }
  }
  __syncthreads();
  for (int r = rb; r < re; ++r) {  // LN0 scale and bias gradients
    const float dh = DH[r * FP + c];
    cs.fixed[C_G0] += dh * __bfloat162float(B.N0b[swz(tl * TA + r, c)]);
    cs.fixed[C_B0] += dh;
  }
  __syncthreads();
  for (int r = warp; r < TA; r += nwarps) {  // de = LN0 backward
    float dy[4], n[4];
    const int nc = swz(tl * TA + r, lane * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dy[i] = DH[r * FP + lane * 4 + i];
      n[i] = __bfloat162float(B.N0b[nc + i]);
    }
    ln_bwd_row(dy, n, B.inv0[tl * TA + r], g0, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) DH[r * FP + lane * 4 + i] = dy[i];
  }
  __syncthreads();
  {  // the token's embed bias gradient and its staged de
    float db = 0.f;
    for (int r = rb; r < re; ++r) {
      const float de = DH[r * FP + c];
      db += de;
      const int row = row0 + r;
      st[S_DE][((size_t)t * s_pad + row) * E + c] = row < S ? __float2bfloat16_rn(de) : zero;
    }
#pragma unroll
    for (int gg = 0; gg < MAX_GROUPS; ++gg)
      if (gg == g) cs.bg[gg] += db;
  }
  __syncthreads();
}

// `_backward_core` for the tile from the head to the attention output's
// cotangent datt (into B.H0; dr1 f32 in B.G): the part of a tile's backward
// that the tokens do not enter, from the residuals of `tc_forward_rows` and
// the head's cotangent in B.DOUT (f32) and B.DOb (bf16, zeros past hd and
// past S); fixed: the network's leaves after the groups' pairs.  Stages dr2,
// dpre1 and dr1, adds its column sums and dwh into `cs`.  Ends synchronised.
template <int TA>
__device__ __forceinline__ void tc_backward_rows(const float* const* fixed,
                                                 const __nv_bfloat16* WH, int hd,
                                                 const TcBufs& B, Ring& R, const WSeq& seq,
                                                 __nv_bfloat16* const* st, int row0, int S,
                                                 ColSums& cs, int j) {
  const float* g1 = fixed[10];
  const float* g2 = fixed[16];
  const int warp = j >> 5;
  const int lane = j & 31;
  const int nwarps = NTA / 32;
  const int c = j & (E - 1);               // the thread's column
  const int rb = (j >> 7) * (TA / 2);      // and its half of the rows
  const int re = rb + TA / 2;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  float* G = B.G;
  float* G2 = B.G2;
  float* DH = B.H0;
  uint32_t fr[8][4];

  {  // head: dwh += y2^T dout (fragments kept across tiles; K = the tile's
     // rows, the second k half zeros for an 8-row tile), dbh, dy2 = dout wh^T
    uint32_t a[4] = {0u, 0u, 0u, 0u}, b[2] = {0u, 0u};
    if (TA == 16) {
      ldsm_x4_t(a, B.Y2b + swz((lane & 7) + ((lane >> 4) << 3),
                               warp * 16 + ((lane >> 3) & 1) * 8));
      ldsm_x2_t(b, B.DOb + (lane & 15) * 8);
    } else {
      uint32_t a2[2];
      ldsm_x2_t(a2, B.Y2b + swz(lane & 7, warp * 16 + ((lane >> 3) & 1) * 8));
      a[0] = a2[0];
      a[1] = a2[1];
      b[0] = ldsm_x1_t(B.DOb + (lane & 7) * 8);
    }
    mma_bf16(cs.wh, a, b[0], b[1]);
  }
  if (j < hd) {  // the tile's sum first: a block's sum of ~400 rows one by one strays
    float t = 0.f;  // by ~10x the plain version's pairwise error where it cancels
    for (int r = 0; r < TA; ++r) t += B.DOUT[r * MAX_HEAD + j];
    cs.bh += t;
  }
  {
    uint32_t a2[2];
    ldsm_x2(a2, WH + (warp * 16 + (lane & 15)) * 8);
    const uint32_t a[4] = {a2[0], a2[1], 0u, 0u};
#pragma unroll
    for (int nb = 0; nb < TA / 8; ++nb) {
      const uint32_t b = ldsm_x1(B.DOb + (nb * 8 + (lane & 7)) * 8);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(acc, a, b, 0u);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        G[(nb * 8 + 2 * (lane & 3) + (v & 1)) * FP + frag_feature(warp, lane, v)] = acc[v];
    }
  }
  __syncthreads();
  for (int r = rb; r < re; ++r) {  // LN2 scale and bias gradients
    cs.fixed[C_G2] += G[r * FP + c] * B.N2[r * FP + c];
    cs.fixed[C_B2] += G[r * FP + c];
  }
  __syncthreads();
  for (int r = warp; r < TA; r += nwarps) {  // dr2 = LN2 backward
    float dy[4], n[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dy[i] = G[r * FP + lane * 4 + i];
      n[i] = B.N2[r * FP + lane * 4 + i];
    }
    ln_bwd_row(dy, n, B.inv2[r], g2, lane);
    const int row = row0 + r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      G[r * FP + lane * 4 + i] = dy[i];
      const __nv_bfloat16 d = __float2bfloat16_rn(dy[i]);
      B.Rb[swz(r, lane * 4 + i)] = d;
      st[S_DR2][(size_t)row * E + lane * 4 + i] = row < S ? d : zero;
    }
  }
  {  // FFN second layer: dbf2, then dpre1 = dr2 w2^T * gelu'(pre1)
    const __nv_bfloat16* W = R.take(seq, j);
    for (int r = rb; r < re; ++r) cs.fixed[C_BF2] += G[r * FP + c];
    frags_bwd(W, fr, warp, lane);
    tc_run(fr, 8, B.Rb, E, 0, TA, warp, lane, [&](int r, int m, float v) {
      G2[r * FP + m] = v * dgelu_tanh(B.PRE1[r * FP + m]);
    });
  }
  __syncthreads();
  for (int r = rb; r < re; ++r) {  // dbf1; dpre1 rounded for the first layer
    const float d = G2[r * FP + c];
    cs.fixed[C_BF1] += d;
    const __nv_bfloat16 b = __float2bfloat16_rn(d);
    B.Rb[swz(r, c)] = b;
    st[S_DPRE1][(size_t)(row0 + r) * E + c] = row0 + r < S ? b : zero;
  }
  {  // FFN first layer: dy1 = dr2 + dpre1 w1^T
    const __nv_bfloat16* W = R.take(seq, j);
    frags_bwd(W, fr, warp, lane);
    tc_run(fr, 8, B.Rb, E, 0, TA, warp, lane,
           [&](int r, int m, float v) { G[r * FP + m] = G[r * FP + m] + v; });
  }
  __syncthreads();
  for (int r = rb; r < re; ++r) {  // LN1 scale and bias gradients
    cs.fixed[C_G1] += G[r * FP + c] * B.N1[r * FP + c];
    cs.fixed[C_B1] += G[r * FP + c];
  }
  __syncthreads();
  for (int r = warp; r < TA; r += nwarps) {  // dr1 = LN1 backward
    float dy[4], n[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dy[i] = G[r * FP + lane * 4 + i];
      n[i] = B.N1[r * FP + lane * 4 + i];
    }
    ln_bwd_row(dy, n, B.inv1[r], g1, lane);
    const int row = row0 + r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      G[r * FP + lane * 4 + i] = dy[i];
      const __nv_bfloat16 d = __float2bfloat16_rn(dy[i]);
      B.Rb[swz(r, lane * 4 + i)] = d;
      st[S_DR1][(size_t)row * E + lane * 4 + i] = row < S ? d : zero;
    }
  }
  {  // out-projection: dbo, datt = dr1 wo^T (into DH)
    const __nv_bfloat16* W = R.take(seq, j);
    for (int r = rb; r < re; ++r) cs.fixed[C_BO] += G[r * FP + c];
    frags_bwd(W, fr, warp, lane);
    tc_run(fr, 8, B.Rb, E, 0, TA, warp, lane,
           [&](int r, int m, float v) { DH[r * FP + m] = v; });
  }
  __syncthreads();
}

// `_backward_core` for the tile, without its weight products, from the
// residuals of `tc_forward` and the head's cotangent in B.DOUT (f32) and
// B.DOb (bf16, zeros past hd and past S): the staged operands of the weight
// products into `st` (rows past S as zeros), the column sums and dwh into
// `cs`.  WH: the head's bf16 weights.  Ends synchronised.
template <int TA, int NTM>
__device__ __forceinline__ void tc_backward(const TcLayout& L, const float* const* leaf,
                                            const __nv_bfloat16* WH, int hd, float scale,
                                            const TcBufs& B, Ring& R, const WSeq& seq,
                                            __nv_bfloat16* const* st, size_t s_pad, int row0,
                                            int S, ColSums& cs, int j) {
  const TokenLayout& lay = L.lay;
  const int nt = lay.n_tokens;
  const int base = 2 * lay.n_groups;
  const float* g0 = leaf[base + 0];
  const int warp = j >> 5;
  const int lane = j & 31;
  const int c = j & (E - 1);               // the thread's column
  const int rb = (j >> 7) * (TA / 2);      // and its half of the rows
  const int re = rb + TA / 2;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  float* G = B.G;
  float* G2 = B.G2;
  float* DH = B.H0;
  uint32_t fr[8][4];

  tc_backward_rows<TA>(leaf + base, WH, hd, B, R, seq, st, row0, S, cs, j);
  tc_row_dots<TA>(DH, B.Vb, nt, 1.0f, B.DS, NTM, 0, j);  // das_t = datt . v_t
  __syncthreads();
  if (j < TA) tc_softmax_bwd(B.P + j * NTM, B.DS + j * NTM, nt);
  __syncthreads();
  {  // dq, and the bf16 k / v cotangents in place of k and v (each thread its column)
    float dbq = 0.f, dbk = 0.f, dbv = 0.f;
    for (int r = rb; r < re; ++r) {
      const int row = row0 + r;
      float d[NTM], a[NTM], kk[NTM];
#pragma unroll
      for (int t = 0; t < NTM; ++t)
        if (t < nt) {
          d[t] = B.DS[r * NTM + t];
          a[t] = B.P[r * NTM + t];
          kk[t] = __bfloat162float(B.Kb[swz(t * TA + r, c)]);
        }
      float dq = d[0] * kk[0];
#pragma unroll
      for (int t = 1; t < NTM; ++t)
        if (t < nt) dq = dq + d[t] * kk[t];
      dq = dq * scale;
      const __nv_bfloat16 dqb = __float2bfloat16_rn(dq);
      B.Rb[swz(r, c)] = dqb;
      st[S_DQ][(size_t)row * E + c] = row < S ? dqb : zero;
      dbq += dq;
      const float qj = B.Q[r * FP + c];
      const float datt = DH[r * FP + c];
#pragma unroll
      for (int t = 0; t < NTM; ++t)
        if (t < nt) {
          const __nv_bfloat16 dk = __float2bfloat16_rn(d[t] * qj * scale);
          const __nv_bfloat16 dv = __float2bfloat16_rn(a[t] * datt);
          B.Kb[swz(t * TA + r, c)] = dk;
          B.Vb[swz(t * TA + r, c)] = dv;
          dbk += __bfloat162float(dk);
          dbv += __bfloat162float(dv);
          const size_t at = ((size_t)t * s_pad + row) * E + c;
          st[S_DK][at] = row < S ? dk : zero;
          st[S_DV][at] = row < S ? dv : zero;
        }
    }
    cs.fixed[C_BQ] += dbq;
    cs.fixed[C_BK] += dbk;
    cs.fixed[C_BV] += dbv;
  }
  {  // dq wq^T (into G2), for the query token's dh
    const __nv_bfloat16* W = R.take(seq, j);
    frags_bwd(W, fr, warp, lane);
    tc_run(fr, 8, B.Rb, E, 0, TA, warp, lane,
           [&](int r, int m, float v) { G2[r * FP + m] = v; });
  }
  // per token: dh = dk wk^T + dv wv^T (+ dr1 + dq wq^T for the query token),
  // then LN0 backward and the token's staged de; wk and wv stay in registers
  uint32_t fv[8][4];
  const __nv_bfloat16* W = R.take(seq, j);
  frags_bwd(W, fr, warp, lane);
  W = R.take(seq, j);
  frags_bwd(W, fv, warp, lane);
  for (int t = 0; t < nt; ++t)
    tc_token_backward<TA>(fr, fv, B, t, t, lay.tok_group[t], G, G2, DH, g0, st, s_pad, row0, S,
                          cs, j);
}

// ---------------------------------------------------------------- streamed tokens
// Past the tile instances' limits (more than MAX_TOK tokens, more than
// MAX_OBS columns, a group wider than 128 features, or embed weights that
// need more than two ring entries) the kernels stream the tokens through a
// tile of TS_ROWS rows in chunks of TS_CHUNK tokens.  `encoder_embed_kernel`
// first writes every token's bf16 embed e (the reference rounds it there) to
// device memory, [n_tok][s_pad][E] a network, its K (any group width) in
// slabs of 128 on the tensor cores; the tile then reads e a chunk at a time
// and recomputes LN0 from it in each pass over the chunks.  A row's scores
// and softmax weights (and the backward's das / dss) sit in device memory,
// [n_tok] f32 a row, so no shared-memory size depends on the tokens or the
// columns.  The passes keep the reference's rounding points and its
// summation orders: the softmax's max and denominator, att = sum_t a_t v_t,
// wsum = sum_t a_t das_t and dq = sum_t dss_t k_t in token order, each
// running sum carried across the chunks in f32.
constexpr int TS_ROWS = 8;   // a streamed tile's rows
constexpr int TS_CHUNK = 8;  // tokens a chunk
constexpr int EMB_ROWS = 64;  // rows an embed block

// The token groups of a streamed spec: group g has k[g] tokens of d[g]
// features (K padded to kp[g], a multiple of 16), from column col[g] of the
// observation row, tokens tok0[g] .. tok0[g] + k[g] - 1.
struct GroupLayout {
  int obs_dim;
  int n_groups;
  int n_tokens;
  int k[MAX_GROUPS];
  int d[MAX_GROUPS];
  int kp[MAX_GROUPS];
  int col[MAX_GROUPS];
  int tok0[MAX_GROUPS];
};

inline bool make_group_layout(int obs_dim, int n_groups, const int* group_k, const int* group_d,
                              GroupLayout& G) {
  if (n_groups < 1 || n_groups > MAX_GROUPS) return false;
  G.obs_dim = obs_dim;
  G.n_groups = n_groups;
  int t = 0, c = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (group_k[g] < 1 || group_d[g] < 1) return false;
    G.k[g] = group_k[g];
    G.d[g] = group_d[g];
    G.kp[g] = (group_d[g] + 15) / 16 * 16;
    G.col[g] = c;
    G.tok0[g] = t;
    t += group_k[g];
    c += group_k[g] * group_d[g];
  }
  G.n_tokens = t;
  return c == obs_dim;
}

// Whether a spec runs the tile instances (else the streamed one).
inline bool tile_layout(int obs_dim, int n_groups, const int* group_k, const int* group_d,
                        TcLayout& L) {
  TokenLayout lay;
  return make_layout(obs_dim, n_groups, group_k, group_d, lay) && make_tc_layout(lay, L);
}

__host__ __device__ inline int token_group(const GroupLayout& G, int t) {
  int g = 0;
  while (g + 1 < G.n_groups && t >= G.tok0[g + 1]) ++g;
  return g;
}

// Bytes of one network's streaming scratch: e [n_tok][s_pad][E] bf16, then
// the rows' scores / softmax weights [s_pad][n_tok] f32 and, for a backward,
// das / dss [s_pad][n_tok] f32.
inline size_t stream_bytes(int n_tokens, size_t s_pad, bool bwd) {
  return (size_t)n_tokens * s_pad * E * 2 + (size_t)(bwd ? 2 : 1) * s_pad * n_tokens * 4;
}

struct StreamNet {
  __nv_bfloat16* e;
  float* p;
  float* ds;  // null for a forward
};

// A network's scratch at `offset` bytes into the call's.
inline StreamNet stream_net(void* scratch, size_t offset, int n_tokens, size_t s_pad, bool bwd) {
  unsigned char* b = static_cast<unsigned char*>(scratch) + offset;
  StreamNet s;
  s.e = reinterpret_cast<__nv_bfloat16*>(b);
  s.p = reinterpret_cast<float*>(b + (size_t)n_tokens * s_pad * E * 2);
  s.ds = bwd ? s.p + s_pad * n_tokens : nullptr;
  return s;
}

struct EmbedNet {
  const float* w[MAX_GROUPS];  // the groups' f32 embed weights [d][E] (16-byte aligned)
  const float* b[MAX_GROUPS];  // and biases [E]
  __nv_bfloat16* e;            // [n_tok][s_pad][E]
  __nv_bfloat16* xs[MAX_GROUPS];  // with a backward: the groups' staged x slices [k][s_pad][kp]
};

struct EmbedArgs {
  const float* x;  // [S, obs_dim]
  int S;
  int s_pad;
  GroupLayout G;
  EmbedNet net[2];
};

constexpr size_t EMB_SMEM = (size_t)(E + EMB_ROWS) * E * 2;

// e = bf16(bf16(x_t) bf16(W_g) + b_g) for token blockIdx.y over EMB_ROWS rows
// (rows past S computed on zeros, as the tile computes them), network
// blockIdx.z: the tile's embed product (one k-step's sum a mma, added in
// order) over K in slabs of 128 rows of W_g, each rounded to bf16 as it
// fills shared memory; the slab's x columns staged too where xs is given.
__global__ void __launch_bounds__(NTA) encoder_embed_kernel(const __grid_constant__ EmbedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem);  // [E][E] a slab, swizzled
  __nv_bfloat16* X = W + E * E;  // [EMB_ROWS][E] the rows' slab, then the outputs
  const EmbedNet& net = a.net[blockIdx.z];
  const GroupLayout& G = a.G;
  const int t = blockIdx.y;
  const int g = token_group(G, t);
  const int i = t - G.tok0[g];
  const int d = G.d[g];
  const int kp = G.kp[g];
  const int col0 = G.col[g] + i * d;
  const int row0 = blockIdx.x * EMB_ROWS;
  const int j = threadIdx.x;
  const int warp = j >> 5;
  const int lane = j & 31;
  __nv_bfloat16* xs = net.xs[g];
  float acc[EMB_ROWS / 8][4];
#pragma unroll
  for (int nb = 0; nb < EMB_ROWS / 8; ++nb)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[nb][v] = 0.f;
  for (int k0 = 0; k0 < kp; k0 += E) {
    const int kw = min(E, kp - k0);
    __syncthreads();  // every warp has its fragments of the previous slab
    for (int idx = j; idx < kw * (E / 8); idx += NTA) {
      const int r = idx >> 4;
      const int c = (idx & 15) * 8;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (k0 + r < d) {
        const float* src = net.w[g] + (size_t)(k0 + r) * E + c;
        lo = __ldg(reinterpret_cast<const float4*>(src));
        hi = __ldg(reinterpret_cast<const float4*>(src + 4));
      }
      __align__(16) __nv_bfloat162 h[4] = {
          __floats2bfloat162_rn(lo.x, lo.y), __floats2bfloat162_rn(lo.z, lo.w),
          __floats2bfloat162_rn(hi.x, hi.y), __floats2bfloat162_rn(hi.z, hi.w)};
      *reinterpret_cast<uint4*>(W + swz(r, c)) = *reinterpret_cast<const uint4*>(h);
    }
    for (int idx = j; idx < EMB_ROWS * kw; idx += NTA) {
      const int r = idx / kw;
      const int c = idx - r * kw;
      const int row = row0 + r;
      const int k = k0 + c;
      const float v = k < d && row < a.S ? a.x[(size_t)row * G.obs_dim + col0 + k] : 0.f;
      const __nv_bfloat16 b = __float2bfloat16_rn(v);
      X[swz(r, c)] = b;
      if (xs && row < a.s_pad) xs[((size_t)i * a.s_pad + row) * kp + k] = b;
    }
    __syncthreads();
    uint32_t fr[8][4];
    frags_fwd(W, kw / 16, fr, warp, lane);
#pragma unroll
    for (int nb = 0; nb < EMB_ROWS / 8; ++nb)
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        if (ks < kw / 16) {
          uint32_t b[2];
          ldsm_x2(b, X + swz(nb * 8 + (lane & 7), ks * 16 + ((lane >> 3) & 1) * 8));
          mma_step(acc[nb], fr[ks], b[0], b[1]);
        }
  }
  __syncthreads();
  const float* bg = net.b[g];
#pragma unroll
  for (int nb = 0; nb < EMB_ROWS / 8; ++nb)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int m = frag_feature(warp, lane, v);
      X[swz(nb * 8 + 2 * (lane & 3) + (v & 1), m)] = __float2bfloat16_rn(acc[nb][v] + __ldg(bg + m));
    }
  __syncthreads();
  for (int idx = j; idx < EMB_ROWS * (E / 8); idx += NTA) {
    const int r = idx >> 4;
    const int c = (idx & 15) * 8;
    if (row0 + r < a.s_pad)
      *reinterpret_cast<uint4*>(net.e + ((size_t)t * a.s_pad + row0 + r) * E + c) =
          *reinterpret_cast<const uint4*>(X + swz(r, c));
  }
}

// Fills the embed launch's arguments for network n from its f32 leaves
// (canonical order) and its streaming scratch; xs: its staged x slices, or
// null.  False if a weight is not 16-byte aligned.
inline bool embed_net(EmbedArgs& a, int n, const float* const* leaf, __nv_bfloat16* e,
                      __nv_bfloat16* const* xs) {
  EmbedNet& net = a.net[n];
  for (int g = 0; g < a.G.n_groups; ++g) {
    net.w[g] = leaf[2 * g];
    net.b[g] = leaf[2 * g + 1];
    net.xs[g] = xs ? xs[g] : nullptr;
    if (reinterpret_cast<uintptr_t>(net.w[g]) % 16) return false;
  }
  net.e = e;
  return true;
}

inline cudaError_t launch_embed(const EmbedArgs& a, int n_nets, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(encoder_embed_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)EMB_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s_pad + EMB_ROWS - 1) / EMB_ROWS, a.G.n_tokens, n_nets);
  encoder_embed_kernel<<<grid, NTA, EMB_SMEM, stream>>>(a);
  return cudaGetLastError();
}

// A streamed tile's shared memory (TcBufs' names; the chunk's token rows
// TS_CHUNK x TS_ROWS, no x rows); P and DS are set per tile to the rows'
// scratch.  Returns the bytes.
template <bool FWD>
__host__ __device__ inline size_t ts_carve(unsigned char* base, TcBufs* b) {
  constexpr int TA = TS_ROWS;
  const size_t ntr = (size_t)TS_CHUNK * TA;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + o;
    o += align16(bytes);
    return p;
  };
  auto bf = [](unsigned char* p) { return reinterpret_cast<__nv_bfloat16*>(p); };
  auto f32 = [](unsigned char* p) { return reinterpret_cast<float*>(p); };
  take((size_t)(FWD ? 1 : 2) * E * E * 2);
  const size_t h = ntr * E * 2, g = (size_t)2 * TA * FP * 4;
  unsigned char* hb = take(h > g ? h : g);
  unsigned char* n0b = FWD ? nullptr : take(ntr * E * 2);
  unsigned char* kb = take(ntr * E * 2);
  unsigned char* vb = FWD ? kb : take(ntr * E * 2);
  unsigned char* opb = take((size_t)TA * E * 2);
  unsigned char* y2b = take((size_t)TA * E * 2);
  unsigned char* rb = FWD ? nullptr : take((size_t)TA * E * 2);
  unsigned char* dob = FWD ? nullptr : take((size_t)TA * 8 * 2);
  unsigned char* wh0 = take((size_t)E * 8 * 2);
  unsigned char* wh1 = FWD ? nullptr : take((size_t)E * 8 * 2);
  unsigned char* q = take((size_t)TA * FP * 4);
  unsigned char* h0 = take((size_t)TA * FP * 4);
  unsigned char* n1 = FWD ? nullptr : take((size_t)TA * FP * 4);
  unsigned char* n2 = FWD ? nullptr : take((size_t)TA * FP * 4);
  unsigned char* pre1 = FWD ? q : take((size_t)TA * FP * 4);
  unsigned char* acc = take((size_t)TA * FP * 4);
  unsigned char* inv0 = FWD ? nullptr : take(ntr * 4);
  unsigned char* inv1 = FWD ? nullptr : take((size_t)TA * 4);
  unsigned char* inv2 = FWD ? nullptr : take((size_t)TA * 4);
  unsigned char* dout = FWD ? nullptr : take((size_t)TA * MAX_HEAD * 4);
  if (b) {
    b->Hb = bf(hb);
    b->G = f32(hb);
    b->G2 = b->G + TA * FP;
    b->N0b = bf(n0b);
    b->Kb = bf(kb);
    b->Vb = bf(vb);
    b->Xb = nullptr;
    b->OPb = bf(opb);
    b->Y2b = bf(y2b);
    b->Rb = bf(rb);
    b->DOb = bf(dob);
    b->WH[0] = bf(wh0);
    b->WH[1] = bf(wh1);
    b->Q = f32(q);
    b->H0 = f32(h0);
    b->N1 = f32(n1);
    b->N2 = f32(n2);
    b->PRE1 = f32(pre1);
    b->ACC = f32(acc);
    b->inv0 = f32(inv0);
    b->inv1 = f32(inv1);
    b->inv2 = f32(inv2);
    b->P = nullptr;
    b->DS = nullptr;
    b->DOUT = f32(dout);
  }
  return o;
}

// The weights a streamed tile loads, in order: the forward's wq, wk, wv, wo,
// w1, w2 (its embeds are the embed kernel's), and with `bwd` the
// backward's w2, w1, wo, then wv (das), wk (dq), wq (dq wq^T), wk and wv
// (dh); from the f32 leaves (`leaf`, a forward's Slot) or the bf16 copies
// (`wb`, the backward's Ring).
inline void ts_seq_append(WSeq& s, const float* const* leaf, const __nv_bfloat16* const* wb,
                          int n_groups, bool bwd) {
  const int fwd_leaf[6] = {2, 4, 6, 8, 12, 14};
  const int fwd_bw[6] = {B_Q, B_K, B_V, B_O, B_1, B_2};
  const int back[8] = {B_2, B_1, B_O, B_V, B_K, B_Q, B_K, B_V};
  for (int i = 0; i < 6; ++i) {
    seq_part(s, leaf ? static_cast<const void*>(leaf[2 * n_groups + fwd_leaf[i]])
                     : static_cast<const void*>(wb[fwd_bw[i]]), E, E);
    seq_close(s);
  }
  for (int i = 0; bwd && i < 8; ++i) {
    seq_part(s, wb[back[i]], E, E);
    seq_close(s);
  }
}

// The chunk's e rows (tokens t0 .. t0 + nc - 1, token-major rows tl * TS_ROWS
// + r) into B.Hb.
__device__ __forceinline__ void ts_load_chunk(const __nv_bfloat16* e, size_t s_pad, int t0, int nc,
                                              int row0, const TcBufs& B, int j) {
  for (int idx = j; idx < nc * TS_ROWS * (E / 8); idx += NTA) {
    const int lr = idx >> 4;
    const int c = (idx & 15) * 8;
    const int t = t0 + lr / TS_ROWS;
    const int r = lr % TS_ROWS;
    *reinterpret_cast<uint4*>(B.Hb + swz(lr, c)) =
        *reinterpret_cast<const uint4*>(e + ((size_t)t * s_pad + row0 + r) * E + c);
  }
}

// A chunk's pass to LN0 from the embed scratch: load, LN0, synchronised.
__device__ __forceinline__ void ts_chunk_ln0(const float* g0, const float* b0, const TcBufs& B,
                                             const __nv_bfloat16* e, size_t s_pad, int t0, int nc,
                                             int row0, int S, bool h0, __nv_bfloat16* sth,
                                             bool keep_n, int j) {
  ts_load_chunk(e, s_pad, t0, nc, row0, B, j);
  __syncthreads();
  tc_ln0<TS_ROWS>(g0, b0, B, t0, nc, row0, S, h0, sth, s_pad, keep_n, j);
  __syncthreads();
}

// `_forward_core` for a streamed tile to LN2's output, from the network's
// embeds `e` (the embed kernel's); B.P: the tile's [TS_ROWS][n_tok] scores.
// With `st`, h_all, att, y1 and f staged.  Ends synchronised.
template <bool FWD, class Src>
__device__ __forceinline__ void ts_forward(const GroupLayout& G, const float* const* leaf,
                                           float scale, const TcBufs& B, Src& src,
                                           const WSeq& seq, const __nv_bfloat16* e,
                                           __nv_bfloat16* const* st, size_t s_pad, int row0,
                                           int S, int j) {
  constexpr int TA = TS_ROWS;
  const int nt = G.n_tokens;
  const int base = 2 * G.n_groups;
  const float* g0 = leaf[base + 0];
  const float* b0 = leaf[base + 1];
  const float* bq = leaf[base + 3];
  const float* bk = leaf[base + 5];
  const float* bv = leaf[base + 7];
  const int warp = j >> 5;
  const int lane = j & 31;
  const int c = j & (E - 1);
  const int rb = (j >> 7) * (TA / 2);
  const int re = rb + TA / 2;
  uint32_t fr[8][4];

  // pass 1: q from token 0, then every token's score q . k_t * scale, k a
  // chunk at a time (wk's fragments kept across the chunks)
  for (int t0 = 0; t0 < nt; t0 += TS_CHUNK) {
    const int nc = min(TS_CHUNK, nt - t0);
    ts_chunk_ln0(g0, b0, B, e, s_pad, t0, nc, row0, S, t0 == 0, st ? st[S_H] : nullptr, false,
                 j);
    if (t0 == 0) {
      const __nv_bfloat16* W = src.take(seq, j);
      frags_fwd(W, 8, fr, warp, lane);
      tc_run(fr, 8, B.Hb, E, 0, TA, warp, lane,
             [&](int r, int m, float v) { B.Q[r * FP + m] = v + __ldg(bq + m); });
      W = src.take(seq, j);
      frags_fwd(W, 8, fr, warp, lane);
    }
    tc_run(fr, 8, B.Hb, E, 0, nc * TA, warp, lane, [&](int r, int m, float v) {
      B.Kb[swz(r, m)] = __float2bfloat16_rn(v + __ldg(bk + m));
    });
    __syncthreads();
    tc_row_dots<TA>(B.Q, B.Kb, nc, scale, B.P, nt, t0, j);
    __syncthreads();
  }

  if (j < TA) tc_softmax(B.P + j * nt, nt);

  // pass 2: att = sum_t a_t v_t in token order, v a chunk at a time
  {
    const __nv_bfloat16* W = src.take(seq, j);
    frags_fwd(W, 8, fr, warp, lane);
  }
  for (int t0 = 0; t0 < nt; t0 += TS_CHUNK) {
    const int nc = min(TS_CHUNK, nt - t0);
    ts_chunk_ln0(g0, b0, B, e, s_pad, t0, nc, row0, S, false, nullptr, false, j);
    tc_run(fr, 8, B.Hb, E, 0, nc * TA, warp, lane, [&](int r, int m, float v) {
      B.Vb[swz(r, m)] = __float2bfloat16_rn(v + __ldg(bv + m));
    });
    __syncthreads();
    for (int r = rb; r < re; ++r) {
      const float* pr = B.P + r * nt + t0;
      float att = t0 == 0 ? pr[0] * __bfloat162float(B.Vb[swz(r, c)]) : B.ACC[r * FP + c];
      for (int tl = t0 == 0 ? 1 : 0; tl < nc; ++tl)
        att = fmaf(pr[tl], __bfloat162float(B.Vb[swz(tl * TA + r, c)]), att);
      B.ACC[r * FP + c] = att;
    }
    __syncthreads();
  }
  for (int r = rb; r < re; ++r) {  // the attention output, rounded
    const __nv_bfloat16 a = __float2bfloat16_rn(B.ACC[r * FP + c]);
    B.OPb[swz(r, c)] = a;
    if (st) st[S_ATT][(size_t)(row0 + r) * E + c] = row0 + r < S ? a : __float2bfloat16_rn(0.f);
  }
  tc_forward_rows<TA, FWD>(leaf + base, B, src, seq, st, row0, S, j);
}

// `_backward_core` for a streamed tile, without its weight products, after
// `ts_forward`: `tc_backward_rows`, then the attention's and LN0's backward
// a chunk at a time (B.DS: the tile's [TS_ROWS][n_tok] das / dss): pass A
// das_t = datt . v_t; the softmax backward; pass B dq = sum_t dss_t k_t;
// dq wq^T; pass C dk_t, dv_t, dh_t = dk_t wk^T + dv_t wv^T (+ dr1 + dq wq^T
// for token 0), LN0's backward, de staged.  Ends synchronised.
__device__ __forceinline__ void ts_backward(const GroupLayout& G, const float* const* leaf,
                                            const __nv_bfloat16* WH, int hd, float scale,
                                            const TcBufs& B, Ring& R, const WSeq& seq,
                                            const __nv_bfloat16* e, __nv_bfloat16* const* st,
                                            size_t s_pad, int row0, int S, ColSums& cs, int j) {
  constexpr int TA = TS_ROWS;
  const int nt = G.n_tokens;
  const int base = 2 * G.n_groups;
  const float* g0 = leaf[base + 0];
  const float* b0 = leaf[base + 1];
  const float* bk = leaf[base + 5];
  const float* bv = leaf[base + 7];
  const int warp = j >> 5;
  const int lane = j & 31;
  const int c = j & (E - 1);
  const int rb = (j >> 7) * (TA / 2);
  const int re = rb + TA / 2;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  float* DATT = B.H0;  // datt, from tc_backward_rows
  float* DR1 = B.N1;   // dr1 (tc_backward_rows leaves it in B.G, under the chunks' e)
  float* DQW = B.N2;   // dq wq^T
  float* DH = B.PRE1;  // a token's dh, then de
  uint32_t fr[8][4];

  tc_backward_rows<TA>(leaf + base, WH, hd, B, R, seq, st, row0, S, cs, j);
  for (int idx = j; idx < TA * E; idx += NTA) DR1[(idx >> 7) * FP + (idx & (E - 1))] =
      B.G[(idx >> 7) * FP + (idx & (E - 1))];

  // pass A: das_t = datt . v_t, v recomputed a chunk at a time
  {
    const __nv_bfloat16* W = R.take(seq, j);
    frags_fwd(W, 8, fr, warp, lane);
  }
  for (int t0 = 0; t0 < nt; t0 += TS_CHUNK) {
    const int nc = min(TS_CHUNK, nt - t0);
    ts_chunk_ln0(g0, b0, B, e, s_pad, t0, nc, row0, S, false, nullptr, false, j);
    tc_run(fr, 8, B.Hb, E, 0, nc * TA, warp, lane, [&](int r, int m, float v) {
      B.Vb[swz(r, m)] = __float2bfloat16_rn(v + __ldg(bv + m));
    });
    __syncthreads();
    tc_row_dots<TA>(DATT, B.Vb, nc, 1.0f, B.DS, nt, t0, j);
    __syncthreads();
  }
  if (j < TA) tc_softmax_bwd(B.P + j * nt, B.DS + j * nt, nt);

  // pass B: dq = sum_t dss_t k_t in token order, k recomputed a chunk at a time
  {
    const __nv_bfloat16* W = R.take(seq, j);
    frags_fwd(W, 8, fr, warp, lane);
  }
  for (int t0 = 0; t0 < nt; t0 += TS_CHUNK) {
    const int nc = min(TS_CHUNK, nt - t0);
    ts_chunk_ln0(g0, b0, B, e, s_pad, t0, nc, row0, S, false, nullptr, false, j);
    tc_run(fr, 8, B.Hb, E, 0, nc * TA, warp, lane, [&](int r, int m, float v) {
      B.Kb[swz(r, m)] = __float2bfloat16_rn(v + __ldg(bk + m));
    });
    __syncthreads();
    for (int r = rb; r < re; ++r) {
      const float* d = B.DS + r * nt + t0;
      float dq = t0 == 0 ? d[0] * __bfloat162float(B.Kb[swz(r, c)]) : B.ACC[r * FP + c];
      for (int tl = t0 == 0 ? 1 : 0; tl < nc; ++tl)
        dq = dq + d[tl] * __bfloat162float(B.Kb[swz(tl * TA + r, c)]);
      B.ACC[r * FP + c] = dq;
    }
    __syncthreads();
  }
  {
    float dbq = 0.f;
    for (int r = rb; r < re; ++r) {
      const int row = row0 + r;
      const float dq = B.ACC[r * FP + c] * scale;
      const __nv_bfloat16 dqb = __float2bfloat16_rn(dq);
      B.Rb[swz(r, c)] = dqb;
      st[S_DQ][(size_t)row * E + c] = row < S ? dqb : zero;
      dbq += dq;
    }
    cs.fixed[C_BQ] += dbq;
  }
  {  // dq wq^T, for token 0's dh
    const __nv_bfloat16* W = R.take(seq, j);
    frags_bwd(W, fr, warp, lane);
    tc_run(fr, 8, B.Rb, E, 0, TA, warp, lane,
           [&](int r, int m, float v) { DQW[r * FP + m] = v; });
  }

  // pass C: per chunk dk, dv (staged), then per token dh, LN0's backward, de
  uint32_t fv[8][4];
  {
    const __nv_bfloat16* W = R.take(seq, j);
    frags_bwd(W, fr, warp, lane);
    W = R.take(seq, j);
    frags_bwd(W, fv, warp, lane);
  }
  float dbk = 0.f, dbv = 0.f;
  for (int t0 = 0; t0 < nt; t0 += TS_CHUNK) {
    const int nc = min(TS_CHUNK, nt - t0);
    ts_chunk_ln0(g0, b0, B, e, s_pad, t0, nc, row0, S, false, nullptr, true, j);
    for (int r = rb; r < re; ++r) {
      const int row = row0 + r;
      const float qj = B.Q[r * FP + c];
      const float datt = DATT[r * FP + c];
      for (int tl = 0; tl < nc; ++tl) {
        const int t = t0 + tl;
        const __nv_bfloat16 dk = __float2bfloat16_rn(B.DS[r * nt + t] * qj * scale);
        const __nv_bfloat16 dv = __float2bfloat16_rn(B.P[r * nt + t] * datt);
        B.Kb[swz(tl * TA + r, c)] = dk;
        B.Vb[swz(tl * TA + r, c)] = dv;
        dbk += __bfloat162float(dk);
        dbv += __bfloat162float(dv);
        const size_t at = ((size_t)t * s_pad + row) * E + c;
        st[S_DK][at] = row < S ? dk : zero;
        st[S_DV][at] = row < S ? dv : zero;
      }
    }
    __syncthreads();
    for (int tl = 0; tl < nc; ++tl)
      tc_token_backward<TA>(fr, fv, B, tl, t0 + tl, token_group(G, t0 + tl), DR1, DQW, DH, g0,
                            st, s_pad, row0, S, cs, j);
  }
  cs.fixed[C_BK] += dbk;
  cs.fixed[C_BV] += dbv;
}

inline int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return optin;
}

// Fills `L`, the tile height and the shared-memory size of a stage-A kernel
// for these groups (extra_row: bytes the kernel adds a tile row): up to
// TOK_NARROW tokens the 16-row tile where it fits a block's shared memory,
// else the 8-row one; past it the 8-row tile of MAX_TOK tokens (LN0's n in
// a per-block scratch of MAX_TOK x 8 rows of E bf16 values in device memory,
// after the kernel's workspace); false if the shapes exceed the
// kernels' limits (those of make_layout, the embeds' weights in two ring
// entries, the rows MAX_XW bf16 wide).
inline bool stage_a_layout(int obs_dim, int n_groups, const int* group_k, const int* group_d,
                           size_t extra_row, TcLayout& L, int* ta, size_t* smem) {
  TokenLayout lay;
  if (n_groups < 1 || n_groups > MAX_GROUPS ||
      !make_layout(obs_dim, n_groups, group_k, group_d, lay) || !make_tc_layout(lay, L))
    return false;
  const size_t optin = (size_t)smem_optin();
  if (lay.n_tokens > TOK_NARROW) {
    *ta = 8;
    *smem = tc_carve<8, false, MAX_TOK>(nullptr, lay.n_tokens, L.xw, nullptr) + 8 * extra_row;
    return *smem <= optin;
  }
  *ta = 16;
  *smem = tc_carve<16, false, TOK_NARROW>(nullptr, lay.n_tokens, L.xw, nullptr) + 16 * extra_row;
  if (*smem > optin) {
    *ta = 8;
    *smem = tc_carve<8, false, TOK_NARROW>(nullptr, lay.n_tokens, L.xw, nullptr) + 8 * extra_row;
  }
  return *smem <= optin;
}

// Blocks per network of a persistent stage-A grid: as many as are resident on
// the card at once, shared by `n_nets` networks, no more than there are tiles.
template <typename Kernel>
inline cudaError_t stage_a_blocks(Kernel kernel, size_t smem, int ta, int n_nets, int s_pad,
                                  int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTA, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_tiles = s_pad / ta;
  int b = sms * per_sm / n_nets;
  if (b > n_tiles) b = n_tiles;
  *blocks = b < 1 ? 1 : b;
  return cudaSuccess;
}

}  // namespace
