// The encoder pair forward with the PPO loss's per-row gradient math in the
// same kernel, for the in-kernel-loss update (MAPPOCfg.use_inkernel_loss):
//
//   pair_fwd_loss_kernel (direct_mode "fwdloss"): both networks' forward,
//     then per row the PPO-clip and clipped-Huber math: dmu [S, A], both
//     value-branch cotangents dv1, dv2 [S] and a stats row [S, 9 + A];
//   pair_fwd_loss_agrad_kernel (direct_mode "agrad"): the same without dmu
//     leaving the block, followed by the actor's backward with dout = dmu:
//     the actor's parameter gradients, summed over the rows.
//
// Replaces the TPU kernels mupe_tpu/ops/fused_encoder.py
// `_pair_fwd_loss_kernel` with `_loss_math` (fused_encoder.py:568-681) and
// `_pair_fwd_loss_agrad_kernel` (:730-777).  The networks run the tile code
// of encoder_tile.cuh that the forward and backward kernels run, so their
// values are those kernels' bits.  `_loss_math` runs per row in f32, one
// rounding per operation (`__fmul_rn` and kin, so that no multiply-add is
// contracted), with the reference's forms: z = (act - mean) / exp(log_std),
// the log-ratio clamped to +-20 before exp and a zero gradient where it
// saturates, `in_clip` with strict inequalities, the ratio's gradient taken
// on surr1 <= surr2, both value branches (dv2 zero where |v - v_old| > eps).
// The critic's branch is chosen outside, from the batch means of the stats.
//
// What bounds it on an H100: arithmetic, as the encoder kernels: ~540K
// multiply-adds a row for the two forwards (fwdloss) and ~1.1M with the
// actor's backward (agrad); the loss math is ~100 flops a row and the rows'
// loss inputs and outputs ~25 floats.  Design: the pair forward of the
// existing kernel splits the networks across blockIdx.y, which cannot serve
// here: the loss needs a row's mean and value in one block.  So one block
// (128 threads, TR rows) runs the critic first, keeping its value [TR] in
// shared memory, then the actor in the same buffers; one thread a row then
// runs the loss.  Rows past S are computed on zeros and never stored.  The
// agrad kernel is the backward kernel's persistent grid (block b walks the
// tiles b, b + G, ...; the critic's forward runs in the backward's buffers
// before the actor's forward + backward take them) and adds the actor's
// gradients into its own slice of a [G, P] workspace, which
// `sum_slices_kernel` sums in block order: repeat launches give the same
// bits, and there are no float atomics.  Tensor cores are left for later.

#include "encoder_tile.cuh"

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
  float scale;
  TokenLayout lay;
  const float* la[MAX_LEAVES];  // actor leaves
  const float* lc[MAX_LEAVES];  // critic leaves
  LossArgs loss;
};

struct AgradArgs {
  FwdLossArgs f;
  const float* wt[N_T];  // the actor's W^T of wq, wk, wv, wo, w1, w2
  int off[MAX_LEAVES];   // offset of each actor leaf's gradient in a slice
  int P;
  int n_tiles;
  float* ws;  // [G][P] per-block gradient slices
};

// The tile's loss inputs, LW floats a row; rows past S are zeros.
__device__ __forceinline__ void load_loss_rows(float* lin, const LossArgs& a, int S, int row0,
                                               int j) {
  const int w = a.A + 4;
  for (int idx = j; idx < TR * w; idx += NTHREADS) {
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

__global__ void __launch_bounds__(NTHREADS)
    pair_fwd_loss_kernel(const __grid_constant__ FwdLossArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TokenLayout& lay = args.lay;
  const TileBufs B = fwd_bufs(smem_raw, lay.n_tokens, lay.obs_pad);
  float* VOUT = reinterpret_cast<float*>(smem_raw + fwd_smem_bytes(lay.n_tokens, lay.obs_pad));
  float* MEAN = VOUT + TR;           // [TR][MAX_HEAD]
  float* LIN = MEAN + TR * MAX_HEAD;  // [TR][LW]
  const int base = 2 * lay.n_groups;
  const int A = args.loss.A;
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * TR;
  load_rows(B.xs, args.x, args.S, lay, row0, j);
  load_loss_rows(LIN, args.loss, args.S, row0, j);
  __syncthreads();
  tile_forward<false>(lay, args.lc, args.scale, B, j);
  tile_head(B.Y2b, args.lc[base + 18], args.lc[base + 19], 1, VOUT, 1, TR, j);
  __syncthreads();
  tile_forward<false>(lay, args.la, args.scale, B, j);
  tile_head(B.Y2b, args.la[base + 18], args.la[base + 19], A, MEAN, MAX_HEAD, TR, j);
  __syncthreads();
  const int row = row0 + j;
  if (j < TR && row < args.S) {
    float dmu[MAX_HEAD];
    loss_row(args.loss, MEAN + j * MAX_HEAD, VOUT[j], LIN + j * LW, dmu, true, row);
    for (int d = 0; d < A; ++d) args.loss.dmu[(size_t)row * A + d] = dmu[d];
  }
}

__global__ void __launch_bounds__(NTHREADS)
    pair_fwd_loss_agrad_kernel(const __grid_constant__ AgradArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdLossArgs& f = args.f;
  const TokenLayout& lay = f.lay;
  const BwdBufs B = bwd_bufs(smem_raw, lay.n_tokens, lay.obs_pad);
  const TileBufs C = fwd_view(B);  // the critic's forward, in the backward's buffers
  float* VOUT = reinterpret_cast<float*>(smem_raw + bwd_smem_bytes(lay.n_tokens, lay.obs_pad));
  float* LIN = VOUT + TR;  // [TR][LW]
  const int base = 2 * lay.n_groups;
  const int A = f.loss.A;
  const int j = threadIdx.x;
  float* ws = args.ws + (size_t)blockIdx.x * args.P;
  for (int p = j; p < args.P; p += NTHREADS) ws[p] = 0.f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < args.n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    load_rows(B.t.xs, f.x, f.S, lay, row0, j);
    load_loss_rows(LIN, f.loss, f.S, row0, j);
    __syncthreads();
    // the critic first: its values die before the actor's forward + backward
    tile_forward<false>(lay, f.lc, f.scale, C, j);
    tile_head(C.Y2b, f.lc[base + 18], f.lc[base + 19], 1, VOUT, 1, TR, j);
    __syncthreads();
    tile_forward<true>(lay, f.la, f.scale, B.t, j);
    tile_head(B.t.Y2b, f.la[base + 18], f.la[base + 19], A, B.DOUT, MAX_HEAD, TR, j);
    __syncthreads();
    if (j < TR) {  // the mean in DOUT becomes the actor's cotangent dmu
      const int row = row0 + j;
      float dmu[MAX_HEAD];
      loss_row(f.loss, B.DOUT + j * MAX_HEAD, VOUT[j], LIN + j * LW, dmu, row < f.S, row);
      for (int d = 0; d < A; ++d) B.DOUT[j * MAX_HEAD + d] = row < f.S ? dmu[d] : 0.f;
    }
    __syncthreads();
    tile_backward(lay, f.la, args.wt, args.off, A, f.scale, B, ws, j);
  }
}

size_t fwd_loss_smem(const TokenLayout& lay) {
  return fwd_smem_bytes(lay.n_tokens, lay.obs_pad) + (size_t)(TR + TR * MAX_HEAD + TR * LW) * 4;
}

size_t agrad_smem(int n_tokens, int obs_pad) {
  return bwd_smem_bytes(n_tokens, obs_pad) + (size_t)(TR + TR * LW) * 4;
}

// Fills everything but the outputs and the workspace; false on bad shapes.
bool fill_args(FwdLossArgs& f, const float* x, int S, int obs_dim, int n_groups,
               const int* group_k, const int* group_d, const void* const* leaves, int n_leaves,
               int action_dim, const void* const* rows, const float* consts) {
  if (n_groups < 1 || n_groups > MAX_GROUPS || n_leaves != 2 * n_groups + N_FIXED || S < 0 ||
      action_dim < 1 || action_dim > MAX_HEAD ||
      !make_layout(obs_dim, n_groups, group_k, group_d, f.lay))
    return false;
  f.x = x;
  f.S = S;
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

}  // namespace

// x: [S, obs_dim] f32; leaves: the actor's n_leaves device pointers, then the
// critic's (canonical order of mupe_tpu_torch/ops/fused_encoder.py; actor
// head action_dim wide, critic head 1); rows: device pointers to act [S, A],
// logp_old [S], adv [S], v_old [S], ret [S], log_std [A]; consts: host
// array of eps, 1 - eps, 1 + eps, delta, delta / 2, 1 / S, -A / S,
// log(2 pi) / 2; outs: device pointers to dmu [S, A], dv1 [S], dv2 [S],
// stats [S, 9 + A], all f32.  Returns a cudaError_t.
extern "C" int mupe_encoder_fwd_loss(const float* x, int S, int obs_dim, int n_groups,
                                     const int* group_k, const int* group_d,
                                     const void* const* leaves, int n_leaves, int action_dim,
                                     const void* const* rows, const float* consts,
                                     float* const* outs, void* stream) {
  FwdLossArgs args = {};
  if (!fill_args(args, x, S, obs_dim, n_groups, group_k, group_d, leaves, n_leaves, action_dim,
                 rows, consts))
    return (int)cudaErrorInvalidValue;
  args.loss.dmu = outs[0];
  args.loss.dv1 = outs[1];
  args.loss.dv2 = outs[2];
  args.loss.stats = outs[3];
  if (S == 0) return (int)cudaSuccess;
  const size_t smem = fwd_loss_smem(args.lay);
  cudaError_t err = cudaFuncSetAttribute(
      pair_fwd_loss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pair_fwd_loss_kernel<<<(S + TR - 1) / TR, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return (int)cudaGetLastError();
}

// Writes to *blocks the number of blocks (= workspace slices) that
// mupe_encoder_fwd_loss_agrad wants for these shapes.  Returns a cudaError_t.
extern "C" int mupe_encoder_fwd_loss_agrad_blocks(int n_groups, int n_tokens, int obs_dim, int S,
                                                  int* blocks) {
  if (n_groups < 1 || n_groups > MAX_GROUPS || n_tokens < 1 || n_tokens > MAX_TOK ||
      obs_dim < 1 || obs_dim > MAX_OBS || S < 0)
    return (int)cudaErrorInvalidValue;
  return (int)persistent_blocks(pair_fwd_loss_agrad_kernel,
                                agrad_smem(n_tokens, (obs_dim + 3) / 4 * 4), 1, S, blocks);
}

// As mupe_encoder_fwd_loss, with outs: dv1 [S], dv2 [S], stats [S, 9 + A];
// and the actor's gradients: wts, 6 device pointers to the transposes [E, E]
// of its wq, wk, wv, wo, w1, w2; grads, a flat f32 vector of n_params floats
// (the leaves' gradients concatenated in canonical order); ws, an f32
// workspace of blocks * n_params floats, blocks as
// mupe_encoder_fwd_loss_agrad_blocks gave it.  Returns a cudaError_t.
extern "C" int mupe_encoder_fwd_loss_agrad(const float* x, int S, int obs_dim, int n_groups,
                                           const int* group_k, const int* group_d,
                                           const void* const* leaves, int n_leaves,
                                           int action_dim, const void* const* rows,
                                           const float* consts, float* const* outs,
                                           const void* const* wts, float* grads, int n_params,
                                           float* ws, int blocks, void* stream) {
  AgradArgs args = {};
  if (blocks < 1 || !fill_args(args.f, x, S, obs_dim, n_groups, group_k, group_d, leaves,
                               n_leaves, action_dim, rows, consts))
    return (int)cudaErrorInvalidValue;
  if (!leaf_offsets(args.f.lay, group_d, action_dim, args.off, &args.P) || args.P != n_params)
    return (int)cudaErrorInvalidValue;
  args.f.loss.dv1 = outs[0];
  args.f.loss.dv2 = outs[1];
  args.f.loss.stats = outs[2];
  for (int w = 0; w < N_T; ++w) args.wt[w] = static_cast<const float*>(wts[w]);
  args.n_tiles = (S + TR - 1) / TR;
  args.ws = ws;
  const size_t smem = agrad_smem(args.f.lay.n_tokens, args.f.lay.obs_pad);
  cudaError_t err = cudaFuncSetAttribute(
      pair_fwd_loss_agrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_fwd_loss_agrad_kernel<<<blocks, NTHREADS, smem, s>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sum_slices(ws, blocks, n_params, grads, s);
}
