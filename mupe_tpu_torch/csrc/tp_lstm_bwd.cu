// TP-net backward: the gradients of sum(y . dy) for the T-step LSTM(F -> 64)
// + Dense(64 -> O) + tanh of csrc/tp_lstm.cu, summed over the windows, for
// (wi [F, 4H], wh [H, 4H], b [4H], wfc [H, O], bfc [O]).  The cotangent for
// the windows is not computed (they are data).
//
// Replaces the TPU kernels mupe_tpu/ops/tp_lstm.py `_tp_bwd_kernel_t`
// (batch-in-lanes layout) and `_tp_bwd_kernel` (the same math with the
// hidden width lane-padded to 128).  It computes `_tp_bwd_kernel_t`'s
// recompute + BPTT (tp_lstm.py:428-505) on [N, T, F] row-major input at its
// rounding points: dz is rounded to bf16 before dwfc and dh, each step's gate
// cotangent is rounded to bf16 before dwh, dwi and dh, and db and dbfc add
// the unrounded f32 values.
//
// What bounds it on an H100: the recurrence's arithmetic.  A window costs
// about 3x the forward's 204,800 multiply-adds and reads 700 bytes.  Design:
// a persistent grid; each block of 256 threads (one per gate column) walks
// tiles of TB windows (8; 4 for inputs wider than 16, whose dwi takes 64
// registers a thread and whose tile would not fit shared memory at 8).  Per
// tile it runs the forward, keeping h (bf16, the matmul operand) and c (f32)
// of every step in shared memory, then walks the
// steps backwards, recomputing each step's gate pre-activations from x_t and
// h_{t-1} with the forward's own code (so the gates are bit-identical) rather
// than storing them.  Thread g accumulates column g of dwh, dwi and db in
// registers across all of its block's tiles, and the head's dwfc and dbfc in
// shared memory; at the end the block writes its slice of a [G, P]
// workspace, and a second kernel sums the slices in block order, so the
// result does not depend on scheduling (no float atomics).  Windows past N
// run on zeros with a zero cotangent and add exact zeros.

#include "common.cuh"

namespace {

constexpr int H = 64;
constexpr int G4 = 4 * H;         // gate columns == threads per block
constexpr int NARROW_F = 16;      // inputs up to this wide take 8-window tiles
constexpr int MAX_F = 64;
constexpr int MAX_T = 32;
constexpr int MAX_O = 64;
constexpr int WH_LD = G4 + 2;     // padded bf16 row stride of wh in shared memory

struct TPBwdArgs {
  const float* x;    // [N, T, F]
  const float* dy;   // [N, O]
  const float* wi;   // [F, 4H]
  const float* wh;   // [H, 4H]
  const float* b;    // [4H]
  const float* wfc;  // [H, O]
  const float* bfc;  // [O]
  float* ws;         // [G][P]
  int N, T, F, O, n_tiles, P;
};

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + expf(-v)); }

struct Smem {
  float* Cs;    // [T+1][TB][H] cell state after each step
  float* Gs;    // [TB][4H] gate pre-activations, then their cotangents
  float* DH;    // [TB][H] cotangent of h
  float* DZ;    // [TB][O]
  float* DWFC;  // [H][O] block accumulator
  float* DBFC;  // [O]
  __nv_bfloat16* Wi;   // [F][4H]
  __nv_bfloat16* Whs;  // [H][WH_LD]
  __nv_bfloat16* DGb;  // [TB][4H]
  __nv_bfloat16* Hs;   // [T+1][TB][H] h after each step
  __nv_bfloat16* Xs;   // [TB][T*F]
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <int TB>
__host__ __device__ inline size_t carve(unsigned char* base, int T, int F, int O, Smem* s) {
  size_t o = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + o;
    o += align16(bytes);
    return p;
  };
  unsigned char* cs = take((size_t)(T + 1) * TB * H * 4);
  unsigned char* gs = take((size_t)TB * G4 * 4);
  unsigned char* dh = take((size_t)TB * H * 4);
  unsigned char* dz = take((size_t)TB * O * 4);
  unsigned char* dwfc = take((size_t)H * O * 4);
  unsigned char* dbfc = take((size_t)O * 4);
  unsigned char* wi = take((size_t)F * G4 * 2);
  unsigned char* whs = take((size_t)H * WH_LD * 2);
  unsigned char* dgb = take((size_t)TB * G4 * 2);
  unsigned char* hs = take((size_t)(T + 1) * TB * H * 2);
  unsigned char* xs = take((size_t)TB * T * F * 2);
  if (s) {
    s->Cs = reinterpret_cast<float*>(cs);
    s->Gs = reinterpret_cast<float*>(gs);
    s->DH = reinterpret_cast<float*>(dh);
    s->DZ = reinterpret_cast<float*>(dz);
    s->DWFC = reinterpret_cast<float*>(dwfc);
    s->DBFC = reinterpret_cast<float*>(dbfc);
    s->Wi = reinterpret_cast<__nv_bfloat16*>(wi);
    s->Whs = reinterpret_cast<__nv_bfloat16*>(whs);
    s->DGb = reinterpret_cast<__nv_bfloat16*>(dgb);
    s->Hs = reinterpret_cast<__nv_bfloat16*>(hs);
    s->Xs = reinterpret_cast<__nv_bfloat16*>(xs);
  }
  return o;
}

// Gs[w][g] = (x_t W_i + h_{t-1} W_h)[w][g] + b[g] for the tile's windows:
// bf16 operands, f32 sums, the bias added after both products.
template <int TB>
__device__ __forceinline__ void gate_preacts(const Smem& s, int t, int T, int F, int g,
                                             float bg) {
  const int TF = T * F;
  float ax[TB], ah[TB];
#pragma unroll
  for (int w = 0; w < TB; ++w) ax[w] = ah[w] = 0.f;
  for (int f = 0; f < F; ++f) {
    const float wif = __bfloat162float(s.Wi[f * G4 + g]);
#pragma unroll
    for (int w = 0; w < TB; ++w)
      ax[w] = fmaf(__bfloat162float(s.Xs[w * TF + t * F + f]), wif, ax[w]);
  }
  const __nv_bfloat16* hp = s.Hs + (size_t)t * TB * H;
#pragma unroll
  for (int k = 0; k < H; k += 8) {
    float wk[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) wk[i] = __bfloat162float(s.Whs[(k + i) * WH_LD + g]);
#pragma unroll
    for (int w = 0; w < TB; ++w) {
      float hv[8];
      unpack8(*reinterpret_cast<const uint4*>(hp + w * H + k), hv);
#pragma unroll
      for (int i = 0; i < 8; ++i) ah[w] = fmaf(hv[i], wk[i], ah[w]);
    }
  }
#pragma unroll
  for (int w = 0; w < TB; ++w) s.Gs[w * G4 + g] = (ax[w] + ah[w]) + bg;
}

// TB windows a tile, inputs up to MAXF wide (dwi's registers).
template <int TB, int MAXF>
__global__ void __launch_bounds__(G4, 1) tp_lstm_bwd_kernel(const __grid_constant__ TPBwdArgs a) {
  constexpr int PAIRS = TB * H / G4;  // (window, hidden) pairs per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s;
  carve<TB>(smem_raw, a.T, a.F, a.O, &s);
  const int g = threadIdx.x;
  const int T = a.T, F = a.F, O = a.O, TF = T * F;

  for (int f = 0; f < F; ++f) s.Wi[f * G4 + g] = __float2bfloat16_rn(__ldg(a.wi + f * G4 + g));
  for (int k = 0; k < H; ++k)
    s.Whs[k * WH_LD + g] = __float2bfloat16_rn(__ldg(a.wh + k * G4 + g));
  for (int idx = g; idx < H * O; idx += G4) s.DWFC[idx] = 0.f;
  if (g < O) s.DBFC[g] = 0.f;
  const float bg = __ldg(a.b + g);
  float dwh[H], dwi[MAXF], db = 0.f;
#pragma unroll
  for (int k = 0; k < H; ++k) dwh[k] = 0.f;
#pragma unroll
  for (int f = 0; f < MAXF; ++f) dwi[f] = 0.f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int w0 = tile * TB;
    for (int idx = g; idx < TB * TF; idx += G4) {
      const int w = idx / TF;
      const int c = idx - w * TF;
      const int n = w0 + w;
      s.Xs[idx] = __float2bfloat16_rn(n < a.N ? a.x[(size_t)n * TF + c] : 0.f);
    }
    for (int idx = g; idx < TB * H; idx += G4) {
      s.Hs[idx] = __float2bfloat16_rn(0.f);
      s.Cs[idx] = 0.f;
    }
    __syncthreads();

    // forward, keeping h and c of every step
    for (int t = 0; t < T; ++t) {
      gate_preacts<TB>(s, t, T, F, g, bg);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const int idx = g + p * G4;
        const int w = idx / H;
        const int hc = idx - w * H;
        const float* gw = s.Gs + w * G4;
        const float gi = sigmoidf_(gw[hc]);
        const float gf = sigmoidf_(gw[H + hc]);
        const float gg = tanhf(gw[2 * H + hc]);
        const float go = sigmoidf_(gw[3 * H + hc]);
        const float c = gf * s.Cs[(size_t)t * TB * H + idx] + gi * gg;
        s.Cs[(size_t)(t + 1) * TB * H + idx] = c;
        s.Hs[(size_t)(t + 1) * TB * H + idx] = __float2bfloat16_rn(go * tanhf(c));
      }
      __syncthreads();
    }

    // head: y = tanh(bf16(h_T) bf16(wfc) + bfc), dz = dy (1 - y^2)
    const __nv_bfloat16* hT = s.Hs + (size_t)T * TB * H;
    for (int idx = g; idx < TB * O; idx += G4) {
      const int w = idx / O;
      const int o = idx - w * O;
      const int n = w0 + w;
      float acc = 0.f;
      for (int k = 0; k < H; ++k)
        acc = fmaf(__bfloat162float(hT[w * H + k]), bf16r(__ldg(a.wfc + k * O + o)), acc);
      const float y = tanhf(acc + __ldg(a.bfc + o));
      const float dyv = n < a.N ? a.dy[(size_t)n * O + o] : 0.f;
      s.DZ[w * O + o] = dyv * (1.0f - y * y);
    }
    __syncthreads();
    for (int idx = g; idx < H * O; idx += G4) {  // dwfc += bf16(h_T)^T bf16(dz)
      const int k = idx / O;
      const int o = idx - k * O;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < TB; ++w)
        acc = fmaf(__bfloat162float(hT[w * H + k]), bf16r(s.DZ[w * O + o]), acc);
      s.DWFC[idx] += acc;
    }
    if (g < O) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < TB; ++w) acc += s.DZ[w * O + g];
      s.DBFC[g] += acc;
    }
    for (int idx = g; idx < TB * H; idx += G4) {  // dh = bf16(dz) bf16(wfc)^T
      const int w = idx / H;
      const int k = idx - w * H;
      float acc = 0.f;
      for (int o = 0; o < O; ++o)
        acc = fmaf(bf16r(s.DZ[w * O + o]), bf16r(__ldg(a.wfc + k * O + o)), acc);
      s.DH[idx] = acc;
    }
    __syncthreads();

    // backpropagation through time
    float dc[PAIRS];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) dc[p] = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      gate_preacts<TB>(s, t, T, F, g, bg);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const int idx = g + p * G4;
        const int w = idx / H;
        const int hc = idx - w * H;
        float* gw = s.Gs + w * G4;
        const float gi = sigmoidf_(gw[hc]);
        const float gf = sigmoidf_(gw[H + hc]);
        const float gg = tanhf(gw[2 * H + hc]);
        const float go = sigmoidf_(gw[3 * H + hc]);
        const float c_t = s.Cs[(size_t)(t + 1) * TB * H + idx];
        const float c_prev = s.Cs[(size_t)t * TB * H + idx];
        const float dh = s.DH[idx];
        const float tc = tanhf(c_t);
        const float d_o = dh * tc;
        dc[p] = dc[p] + dh * go * (1.0f - tc * tc);
        const float di = dc[p] * gg;
        const float dgg = dc[p] * gi;
        const float df = dc[p] * c_prev;
        dc[p] = dc[p] * gf;
        gw[hc] = di * gi * (1.0f - gi);
        gw[H + hc] = df * gf * (1.0f - gf);
        gw[2 * H + hc] = dgg * (1.0f - gg * gg);
        gw[3 * H + hc] = d_o * go * (1.0f - go);
      }
      __syncthreads();
      // column g: db (unrounded), then dwh and dwi from the bf16 cotangent
      float dgv[TB];
      float dsum = 0.f;
#pragma unroll
      for (int w = 0; w < TB; ++w) {
        const float v = s.Gs[w * G4 + g];
        dsum += v;
        const __nv_bfloat16 vb = __float2bfloat16_rn(v);
        s.DGb[w * G4 + g] = vb;
        dgv[w] = __bfloat162float(vb);
      }
      db += dsum;
      const __nv_bfloat16* hp = s.Hs + (size_t)t * TB * H;
#pragma unroll
      for (int k = 0; k < H; k += 8) {
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
        for (int w = 0; w < TB; ++w) {
          float hv[8];
          unpack8(*reinterpret_cast<const uint4*>(hp + w * H + k), hv);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(hv[i], dgv[w], acc[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) dwh[k + i] += acc[i];
      }
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        if (f < F) {
          float acc = 0.f;
#pragma unroll
          for (int w = 0; w < TB; ++w)
            acc = fmaf(__bfloat162float(s.Xs[w * TF + t * F + f]), dgv[w], acc);
          dwi[f] += acc;
        }
      }
      __syncthreads();
      {  // dh[w][k] = sum_g bf16(dg)[w][g] bf16(wh)[k][g], PAIRS windows a thread
        const int k = g & (H - 1);
        const int w0 = (g / H) * PAIRS;
        float acc[PAIRS];
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) acc[p] = 0.f;
        for (int c = 0; c < G4; c += 2) {
          const float2 wv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(s.Whs + k * WH_LD + c));
#pragma unroll
          for (int p = 0; p < PAIRS; ++p) {
            const float2 d = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(s.DGb + (w0 + p) * G4 + c));
            acc[p] = fmaf(d.x, wv.x, acc[p]);
            acc[p] = fmaf(d.y, wv.y, acc[p]);
          }
        }
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) s.DH[(w0 + p) * H + k] = acc[p];
      }
      __syncthreads();
    }
  }

  // this block's slice, in the flat order (wi, wh, b, wfc, bfc)
  float* ws = a.ws + (size_t)blockIdx.x * a.P;
#pragma unroll
  for (int f = 0; f < MAXF; ++f)
    if (f < F) ws[f * G4 + g] = dwi[f];
#pragma unroll
  for (int k = 0; k < H; ++k) ws[F * G4 + k * G4 + g] = dwh[k];
  ws[(F + H) * G4 + g] = db;
  const int off_fc = (F + H + 1) * G4;
  for (int idx = g; idx < H * O; idx += G4) ws[off_fc + idx] = s.DWFC[idx];
  if (g < O) ws[off_fc + H * O + g] = s.DBFC[g];
}

// The kernel for these shapes and its shared memory: 8-window tiles for
// inputs up to 16 wide (the main path's), else 4.
struct Plan {
  void (*kernel)(TPBwdArgs);
  int tb;
  size_t smem;
};

Plan plan_for(int T, int F, int O) {
  if (F <= NARROW_F)
    return {tp_lstm_bwd_kernel<8, NARROW_F>, 8, carve<8>(nullptr, T, F, O, nullptr)};
  return {tp_lstm_bwd_kernel<4, MAX_F>, 4, carve<4>(nullptr, T, F, O, nullptr)};
}

bool shapes_ok(int T, int F, int O) {
  return T >= 1 && T <= MAX_T && F >= 1 && F <= MAX_F && O >= 1 && O <= MAX_O;
}

}  // namespace

// Writes to *blocks the number of blocks (= workspace slices) that
// mupe_tp_lstm_backward wants for N windows.  Returns a cudaError_t.
extern "C" int mupe_tp_lstm_backward_blocks(int N, int T, int F, int O, int* blocks) {
  if (N < 0 || !shapes_ok(T, F, O)) return (int)cudaErrorInvalidValue;
  const Plan plan = plan_for(T, F, O);
  cudaError_t err = cudaFuncSetAttribute(
      plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plan.kernel, G4,
                                                           plan.smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (N + plan.tb - 1) / plan.tb;
  int b = sms * per_sm;
  if (b > n_tiles) b = n_tiles;
  *blocks = b < 1 ? 1 : b;
  return (int)cudaSuccess;
}

// x [N, T, F], dy [N, O], wi [F, 4*64], wh [64, 4*64], b [4*64], wfc [64, O],
// bfc [O]; grad: flat f32 [F*256 + 64*256 + 256 + 64*O + O] in the order
// (wi, wh, b, wfc, bfc); ws: f32 [blocks * that size], blocks as
// mupe_tp_lstm_backward_blocks gave it.  Returns a cudaError_t.
extern "C" int mupe_tp_lstm_backward(const float* x, const float* dy, int N, int T, int F,
                                     const float* wi, const float* wh, const float* b,
                                     const float* wfc, const float* bfc, int O, float* grad,
                                     float* ws, int blocks, void* stream) {
  if (N < 0 || !shapes_ok(T, F, O) || blocks < 1) return (int)cudaErrorInvalidValue;
  const Plan plan = plan_for(T, F, O);
  const int P = (F + H + 1) * G4 + H * O + O;
  TPBwdArgs args = {x, dy, wi, wh, b, wfc, bfc, ws, N, T, F, O, (N + plan.tb - 1) / plan.tb, P};
  cudaError_t err = cudaFuncSetAttribute(
      plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  plan.kernel<<<blocks, G4, plan.smem, s>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  SegArgs seg = {};
  seg.seg[seg.n++] = {ws, grad, blocks, P, P};
  return (int)sum_segments(seg, s);
}
