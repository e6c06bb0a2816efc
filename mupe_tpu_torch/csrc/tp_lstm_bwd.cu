// TP-net backward, stage A: the gradients of sum(y . dy) for the T-step
// LSTM(F -> 64) + Dense(64 -> O) + tanh of csrc/tp_lstm.cu, summed over the
// windows, for (wi [F, 4H], wh [H, 4H], b [4H], wfc [H, O], bfc [O]).  The
// cotangent for the windows is not computed (they are data).
//
// Replaces the TPU kernels mupe_tpu/ops/tp_lstm.py `_tp_bwd_kernel_t`
// (batch-in-lanes layout) and `_tp_bwd_kernel` (the same math with the
// hidden width lane-padded to 128), with stage B (weight_grad.cu).  Per
// tile of 16 windows it runs the forward of tp_tile.cuh (the forward
// kernel's code, so the same h bits), keeping every step's c, then the head
// and the BPTT of `_tp_bwd_kernel_t` (tp_lstm.py:428-505) at its rounding
// points: dz is rounded to bf16 before dh and dwfc, each step's gate
// cotangent dg is rounded to bf16 before dh, dwh and dwi, and db and dbfc
// add the unrounded f32 values.  The BPTT recomputes each step's gates with
// the forward's own code from x_t and the staged h_{t-1} (bit-identical),
// forms dg in registers and computes dh = bf16(dg) bf16(wh)^T on the tensor
// cores, dg's A fragments read back from the tile's shared copy.  The weight
// products dwi = sum x_t^T dg_t, dwh = sum h_{t-1}^T dg_t and dwfc = h_T^T dz
// are left to stage B: this kernel stages their bf16 operands (x_t, h_t,
// dg_t, dz) in device memory, with c in f32 for its own BPTT.
//
// Any F, T and O, as the forward kernel: up to 64 inputs and 64 outputs the
// register instances, past them the generic one (F = 91, O = 120: ~129 KB
// of shared memory; past ~290 inputs wi and wfc stay in device memory).
//
// What bounds it on an H100: a window costs ~3x the forward's multiply-adds
// (the forward, the recomputed gates, dh) on the tensor cores and writes
// ~0.7 KB of staged bf16 operands a step (dg 512 B), so the bytes (~1.6 GB at
// N = 241,664, T = 10, written here and read by stage B) and the gates'
// transcendentals (twice the forward's) bound it.  Design: the forward
// kernel's persistent grid of 4-warp blocks (a block a 16-window tile, warp
// w its hidden units 16 w .. 16 w + 15, block b walking the tiles b, b + G,
// ...); a BPTT step's gate cotangents pass between the warps through shared
// memory (each warp's units of dh take every gate column), once a step; the
// column sums db and dbfc gather in per-warp shared-memory rows (a lane
// pair's rows summed by one shuffle), which the block sums in a fixed order
// into its slice of a [G, 256 + O]
// workspace, and `sum_segments_kernel` sums the slices in block order: two
// launches give the same bits, without float atomics.  Windows past N run on
// zeros with a zero cotangent: their dg and dz are zeros and add nothing.

#include "tp_tile.cuh"

namespace {

struct TPBwdArgs {
  const float* x;   // [N, T, F]
  const float* dy;  // [N, O]
  TPLeaves l;
  TPStage st;
  float* ws;        // [G][TG + O] per-block slices: db, dbfc
  int N, T, F, O, n_tiles;
  int gw;           // the generic instance: wi and wfc read from device memory
};

template <int FKT>
__global__ void __launch_bounds__(TP_THREADS, 3) tp_lstm_bwd_kernel(const __grid_constant__ TPBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  TPSmem s;
  const bool gw = FKT == 0 && a.gw;
  tp_carve(smem, &s, FKT > 0 ? FKT : (a.F + 15) / 16, FKT > 0 ? TP_OPASS : tp_op(a.O), true,
           gw);
  const int j = threadIdx.x;
  tp_fill(s, a.l, a.F, a.O, gw, j);
  for (int i = j; i < TP_WARPS * 4 * TP_DBL; i += TP_THREADS) s.dbl[i] = 0.f;
  for (int i = j; i < TP_WARPS * 4 * s.dbfc_ld; i += TP_THREADS) s.dbfcl[i] = 0.f;
  __syncthreads();
  const int warp = j >> 5;
  const int lane = j & 31;
  const int q = lane & 3;
  const bool summer = lane < 16;  // rows lane / 4 and lane / 4 + 4 summed by the shuffle
  float* dbl = s.dbl + (warp * 4 + (lane >> 2)) * TP_DBL;
  float* dbfcl = s.dbfcl + (warp * 4 + (lane >> 2)) * s.dbfc_ld;
  const TPStage& st = a.st;
  const int O = a.O;
  const int n_ok = (O + 15) / 16;  // k-tiles of the head's outputs
  const int n_pass = FKT > 0 ? 1 : s.op / TP_OPASS;

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const TPRows r = {tile * TP_ROWS + (lane >> 2), tile * TP_ROWS + (lane >> 2) + 8,
                      a.N, a.T, a.F, O};
    tp_forward_steps<FKT>(s, a.x, r, &st, tile, warp, lane);

    // head, the warp's outputs of each pass: y = tanh(bf16(h_T) bf16(wfc) +
    // bfc), dz = dy (1 - y^2); dbfc; dz staged and shared; then the warp's
    // units of dh = bf16(dz) bf16(wfc)^T
    for (int p = 0; p < n_pass; ++p) {
      float z[2][4];
      tp_head(z, s, a.T, O, p, warp, lane);
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        const int o0 = p * TP_OPASS + warp * 16 + sub * 8 + 2 * q;
        float dz[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int o = o0 + (v & 1);
          const int row = v < 2 ? r.ra : r.rb;
          const float yv = tanhf(z[sub][v] + s.bfc[o]);
          const float d = o < O && row < a.N ? a.dy[(size_t)row * O + o] : 0.f;
          dz[v] = d * (1.0f - yv * yv);
        }
        if (o0 - 2 * q < O) {
          float s0 = dz[0] + dz[2], s1 = dz[1] + dz[3];
          s0 += __shfl_xor_sync(0xffffffffu, s0, 16);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
          if (summer) {
            float2* pp = reinterpret_cast<float2*>(dbfcl + p * 16 + sub * 8 + 2 * q);
            const float2 old = *pp;
            *pp = make_float2(old.x + s0, old.y + s1);
          }
        }
        const uint32_t lo = pack_bf16(dz[0], dz[1]), hi = pack_bf16(dz[2], dz[3]);
        *reinterpret_cast<uint32_t*>(s.DZ + swzw(lane >> 2, o0, s.op)) = lo;
        *reinterpret_cast<uint32_t*>(s.DZ + swzw((lane >> 2) + 8, o0, s.op)) = hi;
        if (o0 - 2 * q < st.op) {
          *reinterpret_cast<uint32_t*>(st.dz + (size_t)r.ra * st.op + o0) = lo;
          *reinterpret_cast<uint32_t*>(st.dz + (size_t)r.rb * st.op + o0) = hi;
        }
      }
    }
    __syncthreads();
    float dh[2][4], dc[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) dh[u][v] = dc[u][v] = 0.f;
    auto dz_ktile = [&](int kt) {
      uint32_t da[4], b[4];
      ldsm_x4(da, s.DZ + swzw(lane & 15, kt * 16 + (lane >> 4) * 8, s.op));
      if (s.gwfc)  // B[k = output][c = unit] = wfc[unit][output]
        tp_b_global(b, s.gwfc, 1, O, O, TH, kt * 16, warp * 16, lane);
      else
        ldsm_x4(b, s.WFC + swzw(warp * 16 + (lane & 7) + (lane >> 4) * 8,
                                kt * 16 + ((lane >> 3) & 1) * 8, s.op));
      mma_bf16(dh[0], da, b[0], b[1]);
      mma_bf16(dh[1], da, b[2], b[3]);
    };
    if constexpr (FKT > 0) {
#pragma unroll
      for (int kt = 0; kt < 4; ++kt)
        if (kt < n_ok) dz_ktile(kt);
    } else {
      for (int kt = 0; kt < n_ok; ++kt) dz_ktile(kt);
    }

    // backpropagation through time, the warp's units
    constexpr int NX = FKT > 0 ? FKT : 1;
    uint32_t xn[NX][4];  // the next step's x (t - 1), loaded a step ahead (FKT > 0)
    if constexpr (FKT > 0) tp_x_frags<FKT>(xn, a.x, r, a.T - 1, q);
    for (int t = a.T - 1; t >= 0; --t) {
      uint32_t xf[NX][4], hp[4][4];
      if constexpr (FKT > 0) {
#pragma unroll
        for (int kt = 0; kt < FKT; ++kt)
#pragma unroll
          for (int i = 0; i < 4; ++i) xf[kt][i] = xn[kt][i];
        if (t > 0) tp_x_frags<FKT>(xn, a.x, r, t - 1, q);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = (i & 1) ? r.rb : r.ra;
          const int col = p * 16 + (i >> 1) * 8 + 2 * q;
          hp[p][i] = t > 0 ? *reinterpret_cast<const uint32_t*>(
                                 st.hs + ((size_t)(t - 1) * st.n_pad + row) * TH + col)
                           : 0u;
        }
      float acc[4][2][4];
      if constexpr (FKT > 0)
        tp_gate_pass<FKT>(acc, xf, hp, s, warp, lane);
      else
        tp_gate_pass_rt(acc, a.x, r, t, hp, s, warp, nullptr, lane);
      __nv_bfloat16* dgs = s.DG + (t & 1) * TP_ROWS * TG;
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        float2 bg[4];
        tp_bias(bg, s, warp, sub, q);
        const int u = 2 * warp + sub;
        const float4 ct = st.cs[(((size_t)tile * a.T + t) * 8 + u) * 32 + lane];
        const float4 cp = t > 0 ? st.cs[(((size_t)tile * a.T + t - 1) * 8 + u) * 32 + lane]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        const float c_t[4] = {ct.x, ct.y, ct.z, ct.w};
        const float c_p[4] = {cp.x, cp.y, cp.z, cp.w};
        float dg[4][4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const Gates G = tp_gates(acc, bg, sub, v);
          const float tc = tanhf(c_t[v]);
          const float d_o = dh[sub][v] * tc;
          dc[sub][v] = dc[sub][v] + dh[sub][v] * G.o * (1.0f - tc * tc);
          const float di = dc[sub][v] * G.g;
          const float dgg = dc[sub][v] * G.i;
          const float df = dc[sub][v] * c_p[v];
          dc[sub][v] = dc[sub][v] * G.f;
          dg[0][v] = di * G.i * (1.0f - G.i);
          dg[1][v] = df * G.f * (1.0f - G.f);
          dg[2][v] = dgg * (1.0f - G.g * G.g);
          dg[3][v] = d_o * G.o * (1.0f - G.o);
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s0 = dg[g][0] + dg[g][2], s1 = dg[g][1] + dg[g][3];
          s0 += __shfl_xor_sync(0xffffffffu, s0, 16);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
          const int col = g * TH + u * 8 + 2 * q;
          if (summer) {
            float2* pp = reinterpret_cast<float2*>(dbl + g * 16 + sub * 8 + 2 * q);
            const float2 old = *pp;
            *pp = make_float2(old.x + s0, old.y + s1);
          }
          const uint32_t lo = pack_bf16(dg[g][0], dg[g][1]), hi = pack_bf16(dg[g][2], dg[g][3]);
          *reinterpret_cast<uint32_t*>(dgs + swzw(lane >> 2, col, TG)) = lo;
          *reinterpret_cast<uint32_t*>(dgs + swzw((lane >> 2) + 8, col, TG)) = hi;
          *reinterpret_cast<uint32_t*>(st.dg + ((size_t)t * st.n_pad + r.ra) * TG + col) = lo;
          *reinterpret_cast<uint32_t*>(st.dg + ((size_t)t * st.n_pad + r.rb) * TG + col) = hi;
        }
      }
      __syncthreads();
      // dh = bf16(dg) bf16(wh)^T for the warp's units, over every gate column
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) dh[u][v] = 0.f;
#pragma unroll
      for (int kt = 0; kt < TG / 16; ++kt) {
        uint32_t da[4], b[4];
        ldsm_x4(da, dgs + swzw(lane & 15, kt * 16 + (lane >> 4) * 8, TG));
        ldsm_x4(b, s.W + swzw(s.wh0 + warp * 16 + (lane & 7) + (lane >> 4) * 8,
                              kt * 16 + ((lane >> 3) & 1) * 8, TG));
        mma_bf16(dh[0], da, b[0], b[1]);
        mma_bf16(dh[1], da, b[2], b[3]);
      }
    }
  }

  // the block's slice: db, then dbfc, each summed over its warps' rows in order
  __syncthreads();
  float* ws = a.ws + (size_t)blockIdx.x * (TG + O);
  for (int col = j; col < TG; col += TP_THREADS) {  // gate g, unit 16 w + k: warp w's g * 16 + k
    const int w = (col % TH) / 16;
    const float* p = s.dbl + w * 4 * TP_DBL + (col / TH) * 16 + col % 16;
    ws[col] = ((p[0] + p[TP_DBL]) + p[2 * TP_DBL]) + p[3 * TP_DBL];
  }
  const int ld = s.dbfc_ld;
  for (int o = j; o < O; o += TP_THREADS) {  // pass p, warp w's output k: its row's p * 16 + k
    const float* p = s.dbfcl + ((o % TP_OPASS) / 16) * 4 * ld + (o / TP_OPASS) * 16 + o % 16;
    ws[TG + o] = ((p[0] + p[ld]) + p[2 * ld]) + p[3 * ld];
  }
}

constexpr int TP_MAX_DEVICES = 64;

struct TPBwdPlan {
  void (*kernel)(TPBwdArgs);
  size_t smem;
  int per_sm;
  int gw;
};

template <int FKT>
cudaError_t bwd_plan_of(TPBwdPlan& p, int F, int O) {
  p.kernel = tp_lstm_bwd_kernel<FKT>;
  const int nkt = FKT > 0 ? FKT : (F + 15) / 16, op = FKT > 0 ? TP_OPASS : tp_op(O);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return err;
  p.smem = tp_carve(nullptr, nullptr, nkt, op, true);
  p.gw = FKT == 0 && p.smem > (size_t)optin;
  if (p.gw) p.smem = tp_carve(nullptr, nullptr, nkt, op, true, true);
  err = cudaFuncSetAttribute(p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, p.kernel, TP_THREADS, p.smem);
}

// The instance for F inputs and O outputs and its grid for n_tiles warp
// tiles: the register instances set up once a device, the generic one (F >
// 64 or O > 64) per call.
cudaError_t bwd_plan(int F, int O, int n_tiles, TPBwdPlan* plan, int* blocks) {
  static TPBwdPlan plans[TP_MAX_DEVICES][TP_MAX_FKT];
  static int sm_count[TP_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= TP_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    int n = 0;
    if ((err = bwd_plan_of<1>(plans[dev][0], 0, 0)) != cudaSuccess ||
        (err = bwd_plan_of<2>(plans[dev][1], 0, 0)) != cudaSuccess ||
        (err = bwd_plan_of<3>(plans[dev][2], 0, 0)) != cudaSuccess ||
        (err = bwd_plan_of<4>(plans[dev][3], 0, 0)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    sm_count[dev] = n;
  }
  if (F <= 16 * TP_MAX_FKT && O <= TP_OPASS) {
    *plan = plans[dev][(F + 15) / 16 - 1];
  } else if ((err = bwd_plan_of<0>(*plan, F, O)) != cudaSuccess) {
    return err;
  }
  if (plan->per_sm < 1) return cudaErrorInvalidConfiguration;
  int b = sm_count[dev] * plan->per_sm;
  if (b > n_tiles) b = n_tiles;
  *blocks = b < 1 ? 1 : b;
  return cudaSuccess;
}

bool shapes_ok(int T, int F, int O) { return T >= 1 && F >= 1 && O >= 1; }

}  // namespace

// Writes to *blocks the number of blocks (= workspace slices of 256 + O
// floats) that mupe_tp_lstm_bwd_operands wants for n_pad staged windows.
// Returns a cudaError_t.
extern "C" int mupe_tp_lstm_bwd_blocks(int n_pad, int T, int F, int O, int* blocks) {
  if (n_pad < 0 || n_pad % 32 || !shapes_ok(T, F, O)) return (int)cudaErrorInvalidValue;
  TPBwdPlan plan;
  return (int)bwd_plan(F, O, n_pad / TP_ROWS, &plan, blocks);
}

// x [N, T, F], dy [N, O], wi [F, 4*64], wh [64, 4*64], b [4*64], wfc [64, O],
// bfc [O] (f32); n_pad >= N staged windows, a multiple of 32; the staging
// (bf16): xs [T][n_pad][16 ceil(F / 16)], hs [T][n_pad][64] (h_1 .. h_T),
// dg [T][n_pad][256], dz [n_pad][8 ceil(O / 8)] (any T, F, O); cs: f32 scratch of
// n_pad * T * 64 floats (16-byte aligned); db [256] and dbfc [O]: where the
// bias gradients go (f32, overwritten); ws: f32 workspace of blocks * (256 +
// O) floats, blocks as mupe_tp_lstm_bwd_blocks gave it.  Returns a
// cudaError_t.
extern "C" int mupe_tp_lstm_bwd_operands(const float* x, const float* dy, int N, int n_pad,
                                         int T, int F, const float* wi, const float* wh,
                                         const float* b, const float* wfc, const float* bfc,
                                         int O, void* xs, void* hs, void* dg, void* dz, void* cs,
                                         float* db, float* dbfc, float* ws, int blocks,
                                         void* stream) {
  if (N < 0 || n_pad < N || n_pad % 32 || !shapes_ok(T, F, O) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  TPBwdPlan plan;
  int want = 0;
  cudaError_t err = bwd_plan(F, O, n_pad / TP_ROWS, &plan, &want);
  if (err != cudaSuccess) return (int)err;
  if (blocks != want) return (int)cudaErrorInvalidValue;
  TPBwdArgs args = {x, dy, {wi, wh, b, wfc, bfc},
                    {static_cast<__nv_bfloat16*>(xs), static_cast<__nv_bfloat16*>(hs),
                     static_cast<__nv_bfloat16*>(dg), static_cast<__nv_bfloat16*>(dz),
                     static_cast<float4*>(cs), n_pad, (O + 7) / 8 * 8},
                    ws, N, T, F, O, n_pad / TP_ROWS, plan.gw};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pad > 0) {
    plan.kernel<<<blocks, TP_THREADS, plan.smem, s>>>(args);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  SegArgs seg = {};
  seg.seg[seg.n++] = {ws, db, n_pad > 0 ? blocks : 0, TG + O, TG};
  seg.seg[seg.n++] = {ws + TG, dbfc, n_pad > 0 ? blocks : 0, TG + O, O};
  return (int)sum_segments(seg, s);
}
