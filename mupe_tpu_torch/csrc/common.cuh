// Helpers shared by the kernels: the encoder tile's building blocks (the
// tile itself is in encoder_bwd_tile.cuh: LayerNorm, GELU, the token
// layout, the gradient vector's leaf offsets), the tensor-core primitives
// (mma.sync, ldmatrix, cp.async) of the encoder and TP-LSTM tiles
// (tp_tile.cuh) and of the weight-gradient stage, and the fixed-order sums
// of the backward kernels' per-block gradient slices and partial products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int E = 128;  // embed width == feed-forward width
constexpr int MAX_TOK = 16;
constexpr int MAX_GROUPS = 4;
constexpr int MAX_OBS = 160;
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

// Token layout of the packed observation row of the tile instances (at most
// MAX_TOK tokens over MAX_OBS columns).
struct TokenLayout {
  int obs_dim;
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

// Offsets of each leaf's gradient in a network's flat gradient vector
// (canonical order) and its length P; false if the head is too wide.
inline bool leaf_offsets(int n_groups, const int* group_d, int hd, int* off, int* P) {
  if (hd < 1 || hd > MAX_HEAD) return false;
  int sizes[MAX_LEAVES];
  int n = 0;
  for (int g = 0; g < n_groups; ++g) {
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

// ---------------------------------------------------------------- tensor cores
// A bf16 [rows][w] buffer in shared memory (w a multiple of 64) keeps its
// 16-byte chunks XOR-swizzled by the row: chunk c of row r sits at c ^ (r & 7),
// so that the eight row addresses of an ldmatrix fall in distinct banks.
__device__ __forceinline__ int swzw(int r, int c, int w) {
  return r * w + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

__device__ __forceinline__ int swz(int r, int c) { return swzw(r, c, E); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: lane l gives the address of a row of one 8x8 b16 matrix (lanes
// 0-7 the first matrix's rows, 8-15 the second's, ...); thread t gets row
// t / 4, columns 2 (t % 4) and 2 (t % 4) + 1 of each, or with .trans those
// of the transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ uint32_t ldsm_x1(const void* p) {
  uint32_t r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(smem_u32(p))
               : "memory");
  return r;
}

__device__ __forceinline__ uint32_t ldsm_x1_t(const void* p) {
  uint32_t r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(smem_u32(p))
               : "memory");
  return r;
}

// d += a b for one m16n8k16 tile: bf16 operands, f32 sums (a row-major
// 16x16, b column-major 16x8; d: rows t / 4 and t / 4 + 8, columns 2 (t % 4)
// and 2 (t % 4) + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; the bytes past `src_bytes` are
// filled with zeros (0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- fixed-order sums
// dst[e] = sum over b = 0 .. n_slices-1, in that order, of src[b * stride + e],
// for e < len: one segment of a gradient vector.  With width > 0 the segment
// is a matrix of len / width rows: element (r, c) is read at r * src_ld + c
// of a slice and written at r * dst_ld + c.
struct Seg {
  const float* src;
  float* dst;
  int n_slices;
  int stride;
  int len;
  int width;
  int src_ld;
  int dst_ld;
};

constexpr int MAX_SEGS = 64;

struct SegArgs {
  Seg seg[MAX_SEGS];
  int n;
};

__global__ void sum_segments_kernel(const __grid_constant__ SegArgs a) {
  const Seg& g = a.seg[blockIdx.y];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < g.len; e += gridDim.x * blockDim.x) {
    int si = e, di = e;
    if (g.width > 0) {
      const int r = e / g.width;
      const int c = e - r * g.width;
      si = r * g.src_ld + c;
      di = r * g.dst_ld + c;
    }
    float s = 0.f;
    for (int b = 0; b < g.n_slices; ++b) s += g.src[(size_t)b * g.stride + si];
    g.dst[di] = s;
  }
}

inline cudaError_t sum_segments(const SegArgs& a, cudaStream_t stream) {
  if (a.n < 1 || a.n > MAX_SEGS) return a.n == 0 ? cudaSuccess : cudaErrorInvalidValue;
  int len = 1;
  for (int i = 0; i < a.n; ++i) len = a.seg[i].len > len ? a.seg[i].len : len;
  const int bx = (len + 255) / 256 < 64 ? (len + 255) / 256 : 64;
  sum_segments_kernel<<<dim3(bx, a.n), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
