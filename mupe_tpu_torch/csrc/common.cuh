// Helpers shared by the kernels: the encoder tiles' building blocks (the
// tiles themselves are in encoder_tile.cuh) -- one block of 128 threads per
// tile of TR rows, thread j owning feature column j, activations in shared
// memory and bf16 where the reference rounds -- and the fixed-order sum of
// the backward kernels' per-block gradient slices (also tp_lstm_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int E = 128;         // embed width == feed-forward width
constexpr int NTHREADS = 128;  // one thread per feature column
constexpr int TR = 8;          // rows per tile
constexpr int MAX_TOK = 8;
constexpr int MAX_GROUPS = 4;
constexpr int MAX_OBS = 128;
constexpr int MAX_HEAD = 8;
constexpr int N_FIXED = 20;  // leaves after the per-group (W, b) pairs
constexpr int MAX_LEAVES = 2 * MAX_GROUPS + N_FIXED;
constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&a)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    a[2 * i] = f.x;
    a[2 * i + 1] = f.y;
  }
}

// acc[w][m] = sum_k A[m0 + m][k] * bf16(W[w][k][j]) for TR rows, NW weight
// matrices sharing the same A rows.  A: bf16 [*, E] in shared memory;
// W: f32 [E, E] row-major (in, out) in global memory.
template <int NW>
__device__ __forceinline__ void mm_tile(const __nv_bfloat16* A, int m0,
                                        const float* const (&W)[NW], int j,
                                        float (&acc)[NW][TR]) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int m = 0; m < TR; ++m) acc[w][m] = 0.f;
  for (int k = 0; k < E; k += 8) {
    float wv[NW][8];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < 8; ++i) wv[w][i] = bf16r(__ldg(W[w] + (k + i) * E + j));
#pragma unroll
    for (int m = 0; m < TR; ++m) {
      const uint4 raw = *reinterpret_cast<const uint4*>(A + (m0 + m) * E + k);
      float a[8];
      unpack8(raw, a);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[w][m] = fmaf(a[i], wv[w][i], acc[w][m]);
    }
  }
}

// LayerNorm of one 128-wide row held by a warp, 4 values per lane:
// v <- n * g + b with n = (v - mean) * inv; n and inv are returned too.
__device__ __forceinline__ void ln_row_n(float (&v)[4], float (&n)[4], float& inv_out,
                                         const float* __restrict__ g,
                                         const float* __restrict__ b, int lane) {
  const float s = warp_sum(v[0] + v[1] + v[2] + v[3]);
  const float ss = warp_sum(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]);
  const float m = s / float(E);
  const float var = ss / float(E) - m * m;
  const float inv = 1.0f / sqrtf(var + LN_EPS);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane * 4 + i;
    n[i] = (v[i] - m) * inv;
    v[i] = n[i] * __ldg(g + c) + __ldg(b + c);
  }
  inv_out = inv;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float inner = c * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// Token layout of the packed observation row, shared by both kernels.
struct TokenLayout {
  int obs_dim;
  int obs_pad;
  int n_groups;
  int n_tokens;
  int tok_off[MAX_TOK];
  int tok_dim[MAX_TOK];
  int tok_group[MAX_TOK];
};

// Fills `lay` from the group sizes; false if they exceed the kernel's limits.
inline bool make_layout(int obs_dim, int n_groups, const int* group_k, const int* group_d,
                        TokenLayout& lay) {
  if (n_groups < 1 || n_groups > MAX_GROUPS || obs_dim < 1 || obs_dim > MAX_OBS) return false;
  lay.obs_dim = obs_dim;
  lay.obs_pad = (obs_dim + 3) / 4 * 4;
  lay.n_groups = n_groups;
  int t = 0, off = 0;
  for (int g = 0; g < n_groups; ++g) {
    for (int i = 0; i < group_k[g]; ++i) {
      if (t >= MAX_TOK) return false;
      lay.tok_off[t] = off;
      lay.tok_dim[t] = group_d[g];
      lay.tok_group[t] = g;
      off += group_d[g];
      ++t;
    }
  }
  lay.n_tokens = t;
  return off == obs_dim && t >= 1;
}

// out[p] = sum over b = 0 .. n_slices-1, in that order, of ws[b * P + p]:
// the fixed-order second pass of the backward kernels' reductions.
__global__ void sum_slices_kernel(const float* __restrict__ ws, int n_slices, int P,
                                  float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int b = 0; b < n_slices; ++b) s += ws[(size_t)b * P + p];
  out[p] = s;
}

inline cudaError_t sum_slices(const float* ws, int n_slices, int P, float* out,
                              cudaStream_t stream) {
  sum_slices_kernel<<<(P + 255) / 256, 256, 0, stream>>>(ws, n_slices, P, out);
  return cudaGetLastError();
}

}  // namespace
