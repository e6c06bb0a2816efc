// The encoder pair forward with the PPO loss's per-row gradient math in the
// same kernel, for the in-kernel-loss update (MAPPOCfg.use_inkernel_loss):
//
//   pair_fwd_loss_kernel (direct_mode "fwdloss"): both networks' forward,
//     then per row the PPO-clip and clipped-Huber math: dmu [S, A], both
//     value-branch cotangents dv1, dv2 [S] and a stats row [S, 9 + A];
//   pair_fwd_loss_agrad_kernel (direct_mode "agrad"): the same without dmu
//     leaving the block, followed by the actor's backward with dout = dmu,
//     as stage A of the encoder backward: the actor's column-sum and head
//     gradients, and the staged operands of its weight products, which
//     stage B (weight_grad.cu) multiplies.
//
// Replaces the TPU kernels mupe_tpu/ops/fused_encoder.py
// `_pair_fwd_loss_kernel` with `_loss_math` (fused_encoder.py:568-681) and
// `_pair_fwd_loss_agrad_kernel` (:730-777).  Both run the tensor-core tile
// code of encoder_bwd_tile.cuh: the fwdloss kernel its forward-only mode,
// the forward kernel's own instance (fused_encoder.cu), so its mean and value
// are `encoder_pair_forward`'s bits; the agrad kernel the backward's mode for
// both forwards and the actor's backward, whose forward arithmetic is the
// same, so the two kernels' dv1, dv2 and stats are the same bits too.
// `_loss_math` runs per row in f32, one rounding per operation (`__fmul_rn`
// and kin, so that no multiply-add is contracted), with the reference's
// forms: z = (act - mean) / exp(log_std), the log-ratio clamped to +-20
// before exp and a zero gradient where it saturates, `in_clip` with strict
// inequalities, the ratio's gradient taken on surr1 <= surr2, both value
// branches (dv2 zero where |v - v_old| > eps).  The critic's branch is chosen
// outside, from the batch means of the stats.
//
// What bounds it on an H100: the fwdloss kernel is the pair forward's work
// (~270K multiply-adds a row a network on the tensor cores, bound by the
// tile's chain of dependent steps) plus ~100 flops and ~25 floats of loss
// inputs and outputs a row; the agrad kernel adds the actor's backward chain
// (~270K more a row) and 8 KB of staged operands a row, and like the
// backward's stage A it is bound by its chain of dependent steps at one
// 16-row tile (8 warps) per SM (~226 KB of shared memory; 8 rows where 16 do
// not fit).  Design: the loss needs a row's mean and value in one block, so
// one block runs the critic's forward first, keeping its value in shared
// memory, then the actor's in the same buffers; one thread a row then runs
// the loss.  The fwdloss kernel is the forward kernel's grid (a block a tile,
// two blocks an SM where the tile allows, the f32 weights rounded into one
// slot) and stages nothing; the agrad kernel is the backward's persistent
// grid (block b walks the tiles b, b + G, ...) and keeps the actor's column
// sums in registers, written once to its two slices of a [2G, P] workspace
// that `sum_segments_kernel` sums in block order: repeat launches give the
// same bits, and there are no float atomics.  Past the tile instances'
// limits both stream the tokens (encoder_bwd_tile.cuh).  Rows past S are
// computed on zeros and never stored.

#include "encoder_bwd_tile.cuh"

namespace {

constexpr int N_STATS = 9;        // stats columns before the A dlog_std columns
constexpr int LW = MAX_HEAD + 4;  // a row's loss inputs: act [A], logp_old, adv, v_old, ret
constexpr int L_LOGP = MAX_HEAD, L_ADV = MAX_HEAD + 1, L_VOLD = MAX_HEAD + 2,
              L_RET = MAX_HEAD + 3;

struct LossArgs {
  const float* act;       // [S, A]
  const float* logp_old;  // [S]
  const float* adv;       // [S]
  const float* v_old;     // [S]
  const float* ret;       // [S]
  const float* log_std;   // [A]
  float* dmu;             // [S, A] (fwdloss only)
  float* dv1;             // [S]
  float* dv2;             // [S]
  float* stats;           // [S, N_STATS + A]
  // the f32 constants, rounded from the reference's doubles by the caller:
  // clip eps, 1 - eps, 1 + eps, huber delta, delta / 2, 1 / S, -A / S,
  // log(2 pi) / 2
  float eps, lo, hi, delta, half_delta, inv_s, neg_a_inv_s, log_sqrt_2pi;
  int A;
};

struct FwdLossArgs {
  const float* x;
  int S;
  int s_pad;
  float scale;
  TcLayout L;                   // the tile instances'
  GroupLayout G;                // the streamed one's
  StreamNet sn[2];              // streamed: the actor's scratch, the critic's
  const float* la[MAX_LEAVES];  // actor leaves
  const float* lc[MAX_LEAVES];  // critic leaves
  WSeq seq;  // the critic's forward, then the actor's (agrad: and its backward)
  LossArgs loss;
};

struct AgradArgs {
  FwdLossArgs f;
  __nv_bfloat16* n0;  // past TOK_NARROW tokens: each block's scratch for LN0's n
  const __nv_bfloat16* wh_a;  // bf16 head weights [E][A], [E][1]
  const __nv_bfloat16* wh_c;
  __nv_bfloat16* st[N_STAGED + MAX_GROUPS];  // the actor's staged operands, x slices
  float* ws;  // [G][colsum_floats] per-block slices
  int n_tiles;
};

// The tile's loss inputs, LW floats a row for `rows` rows (`nth` threads);
// rows past S are zeros.
__device__ __forceinline__ void load_loss_rows(float* lin, const LossArgs& a, int S, int row0,
                                               int rows, int nth, int j) {
  const int w = a.A + 4;
  for (int idx = j; idx < rows * w; idx += nth) {
    const int r = idx / w;
    const int c = idx - r * w;
    const int row = row0 + r;
    float v = 0.f;
    if (row < S) {
      if (c < a.A) v = a.act[(size_t)row * a.A + c];
      else if (c == a.A) v = a.logp_old[row];
      else if (c == a.A + 1) v = a.adv[row];
      else if (c == a.A + 2) v = a.v_old[row];
      else v = a.ret[row];
    }
    lin[r * LW + (c < a.A ? c : MAX_HEAD + c - a.A)] = v;
  }
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float huber(float d, float delta, float half_delta) {
  const float ad = fabsf(d);
  return ad <= delta ? __fmul_rn(__fmul_rn(0.5f, d), d)
                     : __fmul_rn(delta, __fsub_rn(ad, half_delta));
}

// `_loss_math` for one row: `mean` [A] and `vout` from the networks, `lin`
// the row's loss inputs.  dmu [A] into `dmu`; with `store`, dv1, dv2 and the
// stats row into global memory at `row`.
__device__ __forceinline__ void loss_row(const LossArgs& a, const float* mean, float vout,
                                         const float* lin, float* dmu, bool store, int row) {
  const int A = a.A;
  float z[MAX_HEAD], sig[MAX_HEAD];
  float logp = 0.f;
  for (int d = 0; d < A; ++d) {
    const float ls = __ldg(a.log_std + d);
    sig[d] = expf(ls);
    z[d] = __fdiv_rn(__fsub_rn(lin[d], mean[d]), sig[d]);
    const float term =
        __fsub_rn(__fsub_rn(__fmul_rn(-0.5f, __fmul_rn(z[d], z[d])), ls), a.log_sqrt_2pi);
    logp = d == 0 ? term : __fadd_rn(logp, term);
  }
  const float adv = lin[L_ADV];
  const float log_ratio = __fsub_rn(logp, lin[L_LOGP]);
  const float lr_c = clampf(log_ratio, -20.f, 20.f);
  const float ratio = expf(lr_c);
  const float surr1 = __fmul_rn(ratio, adv);
  const float surr2 = __fmul_rn(clampf(ratio, a.lo, a.hi), adv);
  const bool in_clip = ratio > a.lo && ratio < a.hi;
  const float g_ratio = __fmul_rn(adv, (surr1 <= surr2 || in_clip) ? 1.f : 0.f);
  // zero gradient where the clamp saturates (its cotangent is zero there)
  const float unsat = (log_ratio > -20.f && log_ratio < 20.f) ? 1.f : 0.f;
  const float dlogp = __fmul_rn(__fmul_rn(__fmul_rn(a.neg_a_inv_s, g_ratio), ratio), unsat);
  for (int d = 0; d < A; ++d) dmu[d] = __fdiv_rn(__fmul_rn(dlogp, z[d]), sig[d]);
  if (!store) return;

  const float ret = lin[L_RET];
  const float dvo = __fsub_rn(vout, lin[L_VOLD]);
  const float d1 = __fsub_rn(vout, ret);
  const float d2 = __fsub_rn(__fadd_rn(lin[L_VOLD], clampf(dvo, -a.eps, a.eps)), ret);
  a.dv1[row] = __fmul_rn(a.inv_s, clampf(d1, -a.delta, a.delta));
  a.dv2[row] = __fmul_rn(__fmul_rn(a.inv_s, clampf(d2, -a.delta, a.delta)),
                         fabsf(dvo) <= a.eps ? 1.f : 0.f);
  float* st = a.stats + (size_t)row * (N_STATS + A);
  st[0] = fminf(surr1, surr2);
  st[1] = ratio;
  st[2] = __fmul_rn(ratio, ratio);
  st[3] = huber(d1, a.delta, a.half_delta);
  st[4] = huber(d2, a.delta, a.half_delta);
  st[5] = __fmul_rn(d1, d1);
  st[6] = ret;
  st[7] = __fmul_rn(ret, ret);
  st[8] = lr_c;
  for (int d = 0; d < A; ++d)
    st[N_STATS + d] = __fmul_rn(dlogp, __fsub_rn(__fmul_rn(z[d], z[d]), 1.f));
}

// The fwdloss kernel's tail: per row (thread j < rows) the loss math on the
// actor's mean (MEAN) and the critic's value (VOUT), dmu to global memory.
__device__ __forceinline__ void fwd_loss_rows(const LossArgs& a, const float* MEAN,
                                              const float* VOUT, const float* LIN, int S,
                                              int row0, int rows, int j) {
  const int row = row0 + j;
  if (j < rows && row < S) {
    float dmu[MAX_HEAD];
    loss_row(a, MEAN + j * MAX_HEAD, VOUT[j], LIN + j * LW, dmu, true, row);
    for (int d = 0; d < a.A; ++d) a.dmu[(size_t)row * a.A + d] = dmu[d];
  }
}

// Shared memory a fwdloss tile row adds: VOUT, MEAN [MAX_HEAD], LIN [LW].
constexpr size_t FWDLOSS_ROW_SMEM = (size_t)(1 + MAX_HEAD + LW) * 4;

template <int TA, int NTM>
__global__ void __launch_bounds__(NTA, 2)
    pair_fwd_loss_kernel(const __grid_constant__ FwdLossArgs f) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout& L = f.L;
  TcBufs B;
  const size_t tc_bytes = tc_carve<TA, true, NTM>(smem, L.lay.n_tokens, L.xw, &B);
  float* VOUT = reinterpret_cast<float*>(smem + tc_bytes);
  float* MEAN = VOUT + TA;           // [TA][MAX_HEAD]
  float* LIN = MEAN + TA * MAX_HEAD;  // [TA][LW]
  Slot src = {reinterpret_cast<__nv_bfloat16*>(smem), 0};
  const int base = 2 * L.lay.n_groups;
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * TA;
  tc_load_rows<TA>(L, B, f.x, f.S, row0, nullptr, 0, j);
  load_loss_rows(LIN, f.loss, f.S, row0, TA, NTA, j);
  // the critic first (its value kept in VOUT), then the actor with its mean in MEAN
  load_head(B.WH[0], f.lc[base + 18], 1, j);
  tc_forward<TA, true, NTM>(L, f.lc, f.scale, B, src, f.seq, nullptr, 0, row0, f.S, j);
  tc_head<TA>(B, B.WH[0], f.lc[base + 19], 1, VOUT, 1, TA, j);
  __syncthreads();
  load_head(B.WH[0], f.la[base + 18], f.loss.A, j);
  tc_forward<TA, true, NTM>(L, f.la, f.scale, B, src, f.seq, nullptr, 0, row0, f.S, j);
  tc_head<TA>(B, B.WH[0], f.la[base + 19], f.loss.A, MEAN, MAX_HEAD, TA, j);
  __syncthreads();
  fwd_loss_rows(f.loss, MEAN, VOUT, LIN, f.S, row0, TA, j);
}

__global__ void __launch_bounds__(NTA, 2)
    pair_fwd_loss_stream_kernel(const __grid_constant__ FwdLossArgs f) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TA = TS_ROWS;
  TcBufs B;
  const size_t tc_bytes = ts_carve<true>(smem, &B);
  float* VOUT = reinterpret_cast<float*>(smem + tc_bytes);
  float* MEAN = VOUT + TA;
  float* LIN = MEAN + TA * MAX_HEAD;
  Slot src = {reinterpret_cast<__nv_bfloat16*>(smem), 0};
  const int base = 2 * f.G.n_groups;
  const size_t p_off = (size_t)blockIdx.x * TA * f.G.n_tokens;
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * TA;
  load_loss_rows(LIN, f.loss, f.S, row0, TA, NTA, j);
  load_head(B.WH[0], f.lc[base + 18], 1, j);
  B.P = f.sn[1].p + p_off;
  ts_forward<true>(f.G, f.lc, f.scale, B, src, f.seq, f.sn[1].e, nullptr, f.s_pad, row0, f.S, j);
  tc_head<TA>(B, B.WH[0], f.lc[base + 19], 1, VOUT, 1, TA, j);
  __syncthreads();
  load_head(B.WH[0], f.la[base + 18], f.loss.A, j);
  B.P = f.sn[0].p + p_off;
  ts_forward<true>(f.G, f.la, f.scale, B, src, f.seq, f.sn[0].e, nullptr, f.s_pad, row0, f.S, j);
  tc_head<TA>(B, B.WH[0], f.la[base + 19], f.loss.A, MEAN, MAX_HEAD, TA, j);
  __syncthreads();
  fwd_loss_rows(f.loss, MEAN, VOUT, LIN, f.S, row0, TA, j);
}

// The agrad kernel's loss step: the mean in B.DOUT becomes the actor's
// cotangent dmu (f32 in DOUT, bf16 in DOb, zeros past A and past S).
__device__ __forceinline__ void agrad_loss_rows(const LossArgs& a, const TcBufs& B,
                                                const float* VOUT, const float* LIN, int S,
                                                int row0, int rows, int j) {
  if (j < rows) {
    const int row = row0 + j;
    float dmu[MAX_HEAD];
    loss_row(a, B.DOUT + j * MAX_HEAD, VOUT[j], LIN + j * LW, dmu, row < S, row);
    for (int d = 0; d < MAX_HEAD; ++d) {
      const float v = d < a.A && row < S ? dmu[d] : 0.f;
      B.DOUT[j * MAX_HEAD + d] = v;
      B.DOb[j * 8 + d] = __float2bfloat16_rn(v);
    }
  }
}

template <int TA, int NTM>
__global__ void __launch_bounds__(NTA, 1)
    pair_fwd_loss_agrad_kernel(const __grid_constant__ AgradArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLossArgs& f = a.f;
  const TcLayout& L = f.L;
  TcBufs B;
  const size_t tc_bytes = tc_carve<TA, false, NTM>(smem, L.lay.n_tokens, L.xw, &B);
  if (NTM > TOK_NARROW) B.N0b = a.n0 + (size_t)blockIdx.x * NTM * TA * E;
  float* VOUT = reinterpret_cast<float*>(smem + tc_bytes);
  float* LIN = VOUT + TA;  // [TA][LW]
  const int G = L.lay.n_groups;
  const int base = 2 * G;
  const int A = f.loss.A;
  const int j = threadIdx.x;
  load_head(B.WH[0], a.wh_a, A, j);
  load_head(B.WH[1], a.wh_c, 1, j);
  ColSums cs;
  colsums_zero(cs);
  Ring R;
  R.start(smem, f.seq, j);
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int row0 = tile * TA;
    tc_load_rows<TA>(L, B, f.x, f.S, row0, a.st + N_STAGED, f.s_pad, j);
    load_loss_rows(LIN, f.loss, f.S, row0, TA, NTA, j);
    __syncthreads();
    // the critic first (its value kept in VOUT), then the actor with its mean in DOUT
    tc_forward<TA, false, NTM>(L, f.lc, f.scale, B, R, f.seq, nullptr, f.s_pad, row0, f.S, j);
    tc_head<TA>(B, B.WH[1], f.lc[base + 19], 1, VOUT, 1, TA, j);
    tc_forward<TA, false, NTM>(L, f.la, f.scale, B, R, f.seq, a.st, f.s_pad, row0, f.S, j);
    tc_head<TA>(B, B.WH[0], f.la[base + 19], A, B.DOUT, MAX_HEAD, TA, j);
    __syncthreads();
    agrad_loss_rows(f.loss, B, VOUT, LIN, f.S, row0, TA, j);
    __syncthreads();
    tc_backward<TA, NTM>(L, f.la, B.WH[0], A, f.scale, B, R, f.seq, a.st, f.s_pad, row0, f.S, cs,
                         j);
  }
  cp_async_wait<0>();
  colsums_store(cs, a.ws + (size_t)blockIdx.x * 2 * colsum_floats(G, A), G, A, j);
}

__global__ void __launch_bounds__(NTA, 1)
    pair_fwd_loss_agrad_stream_kernel(const __grid_constant__ AgradArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TA = TS_ROWS;
  const FwdLossArgs& f = a.f;
  TcBufs B;
  const size_t tc_bytes = ts_carve<false>(smem, &B);
  float* VOUT = reinterpret_cast<float*>(smem + tc_bytes);
  float* LIN = VOUT + TA;
  const int G = f.G.n_groups;
  const int base = 2 * G;
  const int A = f.loss.A;
  const int j = threadIdx.x;
  load_head(B.WH[0], a.wh_a, A, j);
  load_head(B.WH[1], a.wh_c, 1, j);
  ColSums cs;
  colsums_zero(cs);
  Ring R;
  R.start(smem, f.seq, j);
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int row0 = tile * TA;
    const size_t p_off = (size_t)tile * TA * f.G.n_tokens;
    load_loss_rows(LIN, f.loss, f.S, row0, TA, NTA, j);
    B.P = f.sn[1].p + p_off;
    ts_forward<false>(f.G, f.lc, f.scale, B, R, f.seq, f.sn[1].e, nullptr, f.s_pad, row0, f.S, j);
    tc_head<TA>(B, B.WH[1], f.lc[base + 19], 1, VOUT, 1, TA, j);
    B.P = f.sn[0].p + p_off;
    B.DS = f.sn[0].ds + p_off;
    ts_forward<false>(f.G, f.la, f.scale, B, R, f.seq, f.sn[0].e, a.st, f.s_pad, row0, f.S, j);
    tc_head<TA>(B, B.WH[0], f.la[base + 19], A, B.DOUT, MAX_HEAD, TA, j);
    __syncthreads();
    agrad_loss_rows(f.loss, B, VOUT, LIN, f.S, row0, TA, j);
    __syncthreads();
    ts_backward(f.G, f.la, B.WH[0], A, f.scale, B, R, f.seq, f.sn[0].e, a.st, f.s_pad, row0,
                f.S, cs, j);
  }
  cp_async_wait<0>();
  colsums_store(cs, a.ws + (size_t)blockIdx.x * 2 * colsum_floats(G, A), G, A, j);
}

constexpr size_t AGRAD_ROW_SMEM = (size_t)(1 + LW) * 4;  // a tile row's VOUT, LIN

// The agrad instance for these tile rows and tokens.
void (*agrad_kernel(int ta, int n_tokens))(AgradArgs) {
  if (n_tokens > TOK_NARROW) return pair_fwd_loss_agrad_kernel<8, MAX_TOK>;
  return ta == 16 ? pair_fwd_loss_agrad_kernel<16, TOK_NARROW>
                  : pair_fwd_loss_agrad_kernel<8, TOK_NARROW>;
}

// The agrad kernel for these groups (tile or streamed), its tile rows and
// shared memory; false on bad shapes.
bool agrad_plan(int obs_dim, int n_groups, const int* group_k, const int* group_d,
                void (**kernel)(AgradArgs), int* ta, size_t* smem) {
  TcLayout L;
  if (tile_layout(obs_dim, n_groups, group_k, group_d, L)) {
    if (!stage_a_layout(obs_dim, n_groups, group_k, group_d, AGRAD_ROW_SMEM, L, ta, smem))
      return false;
    *kernel = agrad_kernel(*ta, L.lay.n_tokens);
    return true;
  }
  *kernel = pair_fwd_loss_agrad_stream_kernel;
  *ta = TS_ROWS;
  *smem = ts_carve<false>(nullptr, nullptr) + TS_ROWS * AGRAD_ROW_SMEM;
  return *smem <= (size_t)smem_optin();
}

// Fills everything but the outputs, the sequence and the scratch: the
// layout (`*tile`: whether the tile instances take the groups); false on bad
// shapes.
bool fill_args(FwdLossArgs& f, bool* tile, const float* x, int S, int s_pad, int obs_dim,
               int n_groups, const int* group_k, const int* group_d, const void* const* leaves,
               int n_leaves, int action_dim, const void* const* rows, const float* consts) {
  if (n_groups < 1 || n_groups > MAX_GROUPS || n_leaves != 2 * n_groups + N_FIXED || S < 0 ||
      s_pad < S || s_pad % 32 || action_dim < 1 || action_dim > MAX_HEAD ||
      !make_group_layout(obs_dim, n_groups, group_k, group_d, f.G))
    return false;
  *tile = tile_layout(obs_dim, n_groups, group_k, group_d, f.L);
  f.x = x;
  f.S = S;
  f.s_pad = s_pad;
  f.scale = (float)(1.0 / 11.313708498984761);  // 1 / sqrt(E)
  for (int l = 0; l < n_leaves; ++l) {
    f.la[l] = static_cast<const float*>(leaves[l]);
    f.lc[l] = static_cast<const float*>(leaves[n_leaves + l]);
  }
  LossArgs& a = f.loss;
  a.act = static_cast<const float*>(rows[0]);
  a.logp_old = static_cast<const float*>(rows[1]);
  a.adv = static_cast<const float*>(rows[2]);
  a.v_old = static_cast<const float*>(rows[3]);
  a.ret = static_cast<const float*>(rows[4]);
  a.log_std = static_cast<const float*>(rows[5]);
  a.eps = consts[0];
  a.lo = consts[1];
  a.hi = consts[2];
  a.delta = consts[3];
  a.half_delta = consts[4];
  a.inv_s = consts[5];
  a.neg_a_inv_s = consts[6];
  a.log_sqrt_2pi = consts[7];
  a.A = action_dim;
  return true;
}

// Streamed: both networks' embeds into their scratch (actor 0, critic 1),
// the actor's x slices staged where `xs` is given.
cudaError_t fwd_loss_embeds(FwdLossArgs& f, void* scratch, bool bwd, __nv_bfloat16* const* xs,
                            cudaStream_t stream) {
  EmbedArgs e = {};
  e.x = f.x;
  e.S = f.S;
  e.s_pad = f.s_pad;
  e.G = f.G;
  for (int n = 0; n < 2; ++n) {
    f.sn[n] = stream_net(scratch, n * stream_bytes(f.G.n_tokens, f.s_pad, bwd), f.G.n_tokens,
                         f.s_pad, bwd && n == 0);
    if (!embed_net(e, n, n == 0 ? f.la : f.lc, f.sn[n].e, n == 0 ? xs : nullptr))
      return cudaErrorInvalidValue;
  }
  return launch_embed(e, 2, stream);
}

// The fwdloss instance and tile rows for these groups: the forward kernel's
// rule (fused_encoder.cu `fwd_tile_rows`, with the loss's rows added).
template <int TA, int NTM>
size_t fwdloss_smem(const TcLayout& L) {
  return tc_carve<TA, true, NTM>(nullptr, L.lay.n_tokens, L.xw, nullptr) + TA * FWDLOSS_ROW_SMEM;
}

cudaError_t fwdloss_plan(const FwdLossArgs& f, bool tile, void (**kernel)(FwdLossArgs), int* ta,
                         size_t* smem) {
  int dev = 0, per_sm = 0, res = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&res, cudaDevAttrReservedSharedMemoryPerBlock, dev)) !=
          cudaSuccess)
    return err;
  if (!tile) {
    *kernel = pair_fwd_loss_stream_kernel;
    *ta = TS_ROWS;
    *smem = ts_carve<true>(nullptr, nullptr) + TS_ROWS * FWDLOSS_ROW_SMEM;
  } else if (f.L.lay.n_tokens > TOK_NARROW) {
    *kernel = pair_fwd_loss_kernel<8, MAX_TOK>;
    *ta = 8;
    *smem = fwdloss_smem<8, MAX_TOK>(f.L);
  } else if (2 * (fwdloss_smem<16, TOK_NARROW>(f.L) + res) <= (size_t)per_sm) {
    *kernel = pair_fwd_loss_kernel<16, TOK_NARROW>;
    *ta = 16;
    *smem = fwdloss_smem<16, TOK_NARROW>(f.L);
  } else {
    *kernel = pair_fwd_loss_kernel<8, TOK_NARROW>;
    *ta = 8;
    *smem = fwdloss_smem<8, TOK_NARROW>(f.L);
  }
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

// Writes to *bytes the streaming scratch that mupe_encoder_fwd_loss (bwd =
// 0) or mupe_encoder_fwd_loss_agrad (bwd = 1) wants for these groups and
// s_pad rows: 0 where the tile instances take them.  Returns a cudaError_t.
extern "C" int mupe_encoder_fwd_loss_scratch(int obs_dim, int n_groups, const int* group_k,
                                             const int* group_d, int s_pad, int bwd,
                                             long long* bytes) {
  TcLayout L;
  GroupLayout G;
  if (!make_group_layout(obs_dim, n_groups, group_k, group_d, G))
    return (int)cudaErrorInvalidValue;
  *bytes = tile_layout(obs_dim, n_groups, group_k, group_d, L)
               ? 0 : (long long)(stream_bytes(G.n_tokens, s_pad, bwd != 0) +
                                 stream_bytes(G.n_tokens, s_pad, false));
  return (int)cudaSuccess;
}

// x: [S, obs_dim] f32 (s_pad >= S, a multiple of 32); leaves: the actor's
// n_leaves device pointers, then the critic's (canonical order of
// mupe_tpu_torch/ops/fused_encoder.py; actor head action_dim wide, critic
// head 1; the weights 16-byte aligned); rows: device pointers to act [S, A],
// logp_old [S], adv [S], v_old [S], ret [S], log_std [A]; consts: host
// array of eps, 1 - eps, 1 + eps, delta, delta / 2, 1 / S, -A / S,
// log(2 pi) / 2; outs: device pointers to dmu [S, A], dv1 [S], dv2 [S],
// stats [S, 9 + A], all f32; scratch: the bytes that
// mupe_encoder_fwd_loss_scratch gives (none for the tile instances).
// Returns a cudaError_t.
extern "C" int mupe_encoder_fwd_loss(const float* x, int S, int s_pad, int obs_dim, int n_groups,
                                     const int* group_k, const int* group_d,
                                     const void* const* leaves, int n_leaves, int action_dim,
                                     const void* const* rows, const float* consts,
                                     float* const* outs, void* scratch, void* stream) {
  FwdLossArgs f = {};
  bool tile = false;
  if (!fill_args(f, &tile, x, S, s_pad, obs_dim, n_groups, group_k, group_d, leaves, n_leaves,
                 action_dim, rows, consts) ||
      (!tile && !scratch))
    return (int)cudaErrorInvalidValue;
  f.loss.dmu = outs[0];
  f.loss.dv1 = outs[1];
  f.loss.dv2 = outs[2];
  f.loss.stats = outs[3];
  if (tile) {
    seq_append_f32(f.seq, f.L, f.lc);
    seq_append_f32(f.seq, f.L, f.la);
  } else {
    ts_seq_append(f.seq, f.lc, nullptr, n_groups, false);
    ts_seq_append(f.seq, f.la, nullptr, n_groups, false);
  }
  for (int p = 0; p < f.seq.n_parts; ++p)  // the slot's float4 loads
    if (reinterpret_cast<uintptr_t>(f.seq.part[p].src) % 16) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!tile && (err = fwd_loss_embeds(f, scratch, false, nullptr, s)) != cudaSuccess)
    return (int)err;
  void (*kernel)(FwdLossArgs) = nullptr;
  int ta = 0;
  size_t smem = 0;
  if ((err = fwdloss_plan(f, tile, &kernel, &ta, &smem)) != cudaSuccess) return (int)err;
  kernel<<<(S + ta - 1) / ta, NTA, smem, s>>>(f);
  return (int)cudaGetLastError();
}

// Writes to *blocks the number of blocks (= workspace slices) that
// mupe_encoder_fwd_loss_agrad wants for these shapes (s_pad as for
// mupe_encoder_bwd_blocks).  Returns a cudaError_t.
extern "C" int mupe_encoder_fwd_loss_agrad_blocks(int obs_dim, int n_groups, const int* group_k,
                                                  const int* group_d, int s_pad, int* blocks) {
  GroupLayout G;
  void (*kernel)(AgradArgs) = nullptr;
  size_t smem = 0;
  int ta = 0;
  if (s_pad < 0 || s_pad % 32 || !make_group_layout(obs_dim, n_groups, group_k, group_d, G) ||
      !agrad_plan(obs_dim, n_groups, group_k, group_d, &kernel, &ta, &smem))
    return (int)cudaErrorInvalidValue;
  return (int)stage_a_blocks(kernel, smem, ta, 1, s_pad, blocks);
}

// As mupe_encoder_fwd_loss, with outs: dv1 [S], dv2 [S], stats [S, 9 + A];
// and stage A of the actor's backward: wbf, the actor's then the critic's
// 8 bf16 weight copies (as mupe_encoder_bwd_operands takes them);
// staged, the actor's 11 + n_groups staging buffers (s_pad rows, as
// mupe_encoder_bwd_operands); grads, the actor's flat f32 gradient vector of
// n_params floats, of which this fills every leaf but the weights of the
// staged products; ws, an f32 workspace of 2 * blocks * colsum floats (two
// slices a block), blocks as mupe_encoder_fwd_loss_agrad_blocks gave it,
// then past 8 tokens of the tile instances blocks * 16 * 8 * 128 bf16
// values of scratch; scratch: the bytes that mupe_encoder_fwd_loss_scratch
// gives.  Returns a cudaError_t.
extern "C" int mupe_encoder_fwd_loss_agrad(const float* x, int S, int s_pad, int obs_dim,
                                           int n_groups, const int* group_k, const int* group_d,
                                           const void* const* leaves, int n_leaves,
                                           int action_dim, const void* const* rows,
                                           const float* consts, float* const* outs,
                                           const void* const* wbf, void* const* staged,
                                           float* grads, int n_params, float* ws, int blocks,
                                           void* scratch, void* stream) {
  AgradArgs a = {};
  FwdLossArgs& f = a.f;
  bool tile = false;
  void (*kernel)(AgradArgs) = nullptr;
  size_t smem = 0;
  int ta = 0;
  if (blocks < 1 ||
      !fill_args(f, &tile, x, S, s_pad, obs_dim, n_groups, group_k, group_d, leaves, n_leaves,
                 action_dim, rows, consts) ||
      (!tile && !scratch) ||
      !agrad_plan(obs_dim, n_groups, group_k, group_d, &kernel, &ta, &smem))
    return (int)cudaErrorInvalidValue;
  int off[MAX_LEAVES], P = 0;
  if (!leaf_offsets(n_groups, group_d, action_dim, off, &P) || P != n_params)
    return (int)cudaErrorInvalidValue;
  f.loss.dv1 = outs[0];
  f.loss.dv2 = outs[1];
  f.loss.stats = outs[2];
  const __nv_bfloat16* const* wb = reinterpret_cast<const __nv_bfloat16* const*>(wbf);
  const int nb = N_BW;
  if (tile) {
    seq_append(f.seq, f.L, wb + nb, false);
    seq_append(f.seq, f.L, wb, true);
  } else {
    ts_seq_append(f.seq, nullptr, wb + nb, n_groups, false);
    ts_seq_append(f.seq, nullptr, wb, n_groups, true);
  }
  a.wh_a = wb[B_H];
  a.wh_c = wb[nb + B_H];
  for (int i = 0; i < N_STAGED + n_groups; ++i) a.st[i] = static_cast<__nv_bfloat16*>(staged[i]);
  a.ws = ws;
  a.n_tiles = s_pad / ta;
  SegArgs seg = {};
  colsum_segments(seg, ws, 2 * blocks, n_groups, action_dim, off, grads);
  a.n0 = reinterpret_cast<__nv_bfloat16*>(ws + (size_t)2 * blocks * colsum_floats(n_groups,
                                                                                 action_dim));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!tile && (err = fwd_loss_embeds(f, scratch, true, a.st + N_STAGED, s)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  kernel<<<blocks, NTA, smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sum_segments(seg, s);
}
