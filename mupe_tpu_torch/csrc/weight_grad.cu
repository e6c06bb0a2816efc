// Stage B of the encoder backward and of the TP-LSTM backward: the weight
// products dW = A^T D, summed over the staged rows, as one split-K GEMM
// launch for every product of one or two networks (or of the TP net), then
// a fixed-order sum of the blocks' partial products.
//
// Replaces the TPU kernels mupe_tpu/ops/fused_encoder.py `_bwd_kernel`,
// `_pair_bwd_kernel` and `_pair_fwd_loss_agrad_kernel` together with the
// stage-A kernels (fused_encoder_bwd.cu, fused_encoder_loss.cu): their
// weight-gradient products, `_mm_tn` of `_backward_core` (:377-463), bf16
// operands (stage A rounds and stages them) and f32 sums:
//   wq: h_all[token 0]^T dq    wk: h_all^T dk (K = n_tok S)   wv: h_all^T dv
//   wo: att^T dr1              w1: y1^T dpre1                 w2: f^T dr2
//   each group's embed: its tokens' x slices^T de (K = k S, M = d padded to 16);
// and with tp_lstm_bwd.cu, mupe_tpu/ops/tp_lstm.py `_tp_bwd_kernel_t` and
// `_tp_bwd_kernel`: their weight products (:485-503), summed over the steps
// and windows, D = the bf16 gate cotangents [T N][256] in two 128-column
// halves (D's row stride and the output's given per product):
//   wi: x_t^T dg_t (K = T N)   wh: h_{t-1}^T dg_t (K = (T - 1) N)   wfc: h_T^T dz.
//
// What bounds it on an H100: the bytes.  A product reads K x (M + 128) bf16
// values and does K x M x 128 multiply-adds: 64 flops a byte at M = 128,
// under the card's ~295 (bf16 peak over memory rate).  At S = 49,152 a
// network stages ~0.4 GB, ~0.12 ms at 3.35 TB/s.  Design: each block takes a
// fixed K-chunk of one product (the wrapper's split, `split_k` in
// ops/fused_encoder.py: chunks of a multiple of 32 rows) and writes its
// [M][128] f32 partial; `sum_segments_kernel` adds a product's partials in
// chunk order, so repeat launches give the same bits.  A block of 8 warps
// computes the whole 128 x 128 output of its chunk on the tensor cores
// (mma.sync m16n8k16; each warp 32 x 64), its operands streamed through a
// 4-stage ring of 32-row tiles in shared memory by cp.async, A^T and D
// loaded with ldmatrix.trans from their row-major staging.  mma.sync rather
// than wgmma: at 64 flops a byte the stage needs ~a fifth of mma.sync's
// rate, and both operands are MN-major, the layout wgmma's descriptors make
// hardest to get right.  Staged rows past S are zeros in D and add zeros.

#include "common.cuh"

namespace {

constexpr int WG_THREADS = 256;
constexpr int WG_KSTEP = 32;  // staged rows per pipeline stage
constexpr int WG_STAGES = 4;
constexpr int WG_MAX_PROD = 32;  // a launch's products (the wrapper splits more)
constexpr size_t WG_SMEM = (size_t)WG_STAGES * 2 * WG_KSTEP * E * 2;

struct WgProd {
  const __nv_bfloat16* a;  // [k_rows][sa], its first lda columns read
  const __nv_bfloat16* d;  // [k_rows][ldd], its first n columns read
  float* part;             // [n_chunks][m][E] partial products
  int lda;                 // A's width: M padded to 16 (16, 32, ... 128)
  int sa;                  // A's row stride
  int m;                   // output rows kept (M)
  int ldd;                 // D's row stride
  int n;                   // D's columns (a multiple of 8, at most E; zeros past them)
  int k_rows;              // K, a multiple of WG_KSTEP
  int chunk;               // rows a block takes, a multiple of WG_KSTEP
  int first_block;
};

struct WgArgs {
  WgProd p[WG_MAX_PROD];
  int n_prod;
};

// One pipeline stage: rows [k, k + WG_KSTEP) of A (its lda columns) and D into
// the stage's two [WG_KSTEP][E] tiles (swizzled).
__device__ __forceinline__ void wg_load(const WgProd& p, int k, __nv_bfloat16* sa,
                                        __nv_bfloat16* sd, int tid) {
  const int ca = p.lda / 8;
  for (int idx = tid; idx < WG_KSTEP * ca; idx += WG_THREADS) {
    const int r = idx / ca;
    const int c = (idx - r * ca) * 8;
    cp_async16(sa + swz(r, c), p.a + (size_t)(k + r) * p.sa + c, 16);
  }
  for (int idx = tid; idx < WG_KSTEP * (E / 8); idx += WG_THREADS) {
    const int r = idx >> 4;
    const int c = (idx & 15) * 8;
    const bool in = c < p.n;
    cp_async16(sd + swz(r, c), in ? p.d + (size_t)(k + r) * p.ldd + c : p.d, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(WG_THREADS)
    weight_grad_kernel(const __grid_constant__ WgArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  int pi = 0;
  while (pi + 1 < args.n_prod && args.p[pi + 1].first_block <= (int)blockIdx.x) ++pi;
  const WgProd& p = args.p[pi];
  const int c = blockIdx.x - p.first_block;
  const int k0 = c * p.chunk;
  const int k1 = min(k0 + p.chunk, p.k_rows);
  const int n_steps = (k1 - k0) / WG_KSTEP;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = (warp & 3) * 32;  // the warp's 32 output rows
  const int n0 = (warp >> 2) * 64;  // and 64 output columns
  const bool active = m0 < p.lda;
  const int n_mi = p.lda - m0 >= 32 ? 2 : 1;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][nb][v] = 0.f;

  auto stage_a = [&](int s) { return tiles + (size_t)s * 2 * WG_KSTEP * E; };
  auto stage_d = [&](int s) { return tiles + (size_t)s * 2 * WG_KSTEP * E + WG_KSTEP * E; };
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < n_steps) wg_load(p, k0 + s * WG_KSTEP, stage_a(s), stage_d(s), tid);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();
    const int nxt = i + WG_STAGES - 1;
    if (nxt < n_steps)
      wg_load(p, k0 + nxt * WG_KSTEP, stage_a(nxt % WG_STAGES), stage_d(nxt % WG_STAGES), tid);
    cp_async_commit();
    const __nv_bfloat16* sa = stage_a(i % WG_STAGES);
    const __nv_bfloat16* sd = stage_d(i % WG_STAGES);
    if (active) {
#pragma unroll
      for (int ks = 0; ks < WG_KSTEP / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (mi < n_mi)  // A^T from A[k][m]: .trans
            ldsm_x4_t(a[mi], sa + swz(ks * 16 + (lane & 7) + ((lane >> 4) << 3),
                                      m0 + mi * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int nb = 0; nb < 8; nb += 2) {
          uint32_t b[4];  // D[k][n] as the column-major B: .trans; two n-blocks
          ldsm_x4_t(b, sd + swz(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                n0 + nb * 8 + (lane >> 4) * 8));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            if (mi < n_mi) {
              mma_bf16(acc[mi][nb], a[mi], b[0], b[1]);
              mma_bf16(acc[mi][nb + 1], a[mi], b[2], b[3]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  float* out = p.part + (size_t)c * p.m * E;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mi * 16 + (lane >> 2) + 8 * h;
        const int col = n0 + nb * 8 + 2 * (lane & 3);
        if (mi < n_mi && row < p.m && col < p.n)
          *reinterpret_cast<float2*>(out + (size_t)row * E + col) =
              make_float2(acc[mi][nb][2 * h], acc[mi][nb][2 * h + 1]);
      }
}

}  // namespace

// n_prod products; for product i: a[i] bf16 [k_rows[i]][sa[i]] of which the
// first lda[i] columns are read, d[i] bf16
// [k_rows[i]][ldd[i]] of which the first n[i] columns are read, out[i] f32
// [m[i]][min(n[i], ldo[i])] with row stride ldo[i] (the leaf's gradient, or
// its column block, overwritten with sum_k a[k][:m]^T d[k][:n]), K split
// into chunks of chunk[i] rows (k_rows and chunk multiples of 32, lda a
// multiple of 16 and at most 128, sa a multiple of 8 and at least lda, m <=
// lda, n a multiple of 8 and at most 128, ldd a multiple of 8 and at least
// n); ws: f32 workspace of
// sum_i ceil(k_rows[i] / chunk[i]) * m[i] * 128 floats.  Products with
// k_rows = 0 get zeros.  Returns a cudaError_t.
extern "C" int mupe_weight_grads(int n_prod, const void* const* a, const void* const* d,
                                 const int* lda, const int* sa, const int* m, const int* ldd,
                                 const int* n,
                                 const int* ldo, const int* k_rows, const int* chunk,
                                 float* const* out, float* ws, void* stream) {
  if (n_prod < 1 || n_prod > WG_MAX_PROD) return (int)cudaErrorInvalidValue;
  WgArgs args = {};
  SegArgs seg = {};
  int blocks = 0;
  size_t ws_off = 0;
  for (int i = 0; i < n_prod; ++i) {
    if (lda[i] < 16 || lda[i] > E || lda[i] % 16 || sa[i] < lda[i] || sa[i] % 8 || m[i] < 1 ||
        m[i] > lda[i] || k_rows[i] < 0 ||
        k_rows[i] % WG_KSTEP || chunk[i] < WG_KSTEP || chunk[i] % WG_KSTEP || n[i] < 8 ||
        n[i] > E || n[i] % 8 || ldd[i] < n[i] || ldd[i] % 8 || ldo[i] < 1)
      return (int)cudaErrorInvalidValue;
    const int n_chunks = (k_rows[i] + chunk[i] - 1) / chunk[i];
    const int width = n[i] < ldo[i] ? n[i] : ldo[i];
    float* part = ws + ws_off;
    if (n_chunks > 0)
      args.p[args.n_prod++] = {static_cast<const __nv_bfloat16*>(a[i]),
                               static_cast<const __nv_bfloat16*>(d[i]), part, lda[i], sa[i], m[i],
                               ldd[i], n[i], k_rows[i], chunk[i], blocks};
    seg.seg[seg.n++] = {part, out[i], n_chunks, m[i] * E, m[i] * width, width, E, ldo[i]};
    blocks += n_chunks;
    ws_off += (size_t)n_chunks * m[i] * E;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (blocks > 0) {
    err = cudaFuncSetAttribute(weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)WG_SMEM);
    if (err != cudaSuccess) return (int)err;
    weight_grad_kernel<<<blocks, WG_THREADS, WG_SMEM, s>>>(args);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)sum_segments(seg, s);
}
