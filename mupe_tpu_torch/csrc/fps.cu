// Farthest-point sampling: K greedy max-min rounds over points [N, D].
//
// Replaces the TPU kernel mupe_tpu/ops/fps_pallas.py `_fps_kernel` (the
// AEG history buffer's downsampling, reached from envs/genbuffer.py
// `update_history`).  It computes the same selection: idx[0] = start; each
// further round takes the argmax of the running min squared distance to the
// selected points (the lowest index on ties) and folds in that point's
// distances; invalid points hold -inf and are never chosen while a valid one
// is left.  Each squared distance is summed over j = 0..D-1 in order with
// __fsub_rn / __fmul_rn / __fadd_rn (no FMA contraction) by one thread, so
// the distances, and the indices, are bit-identical to the plain version's
// (mupe_tpu_torch/ops/fps.py `reference_fps`) however the rows are split.
// D is the true width (27 for the AEG task), not the TPU's lane padding.
//
// What bounds it on an H100: the K rounds are a chain, each waiting on the
// previous round's argmax over all N points.  The work, (K-1) * N * D * 3
// flops (3.7 GFLOP at N = 9,096, D = 27, K = 5,000), would take 0.055 ms at
// the f32 peak; a round's latency bounds it long before that.  So a round is
// spread over one thread-block cluster of C blocks (16 where the card
// schedules it, else 8) on neighbouring SMs, and the points stay on chip:
//
// - block b owns rows [b*R, (b+1)*R), R = ceil(N / C); each thread owns rows
//   tid, tid + T, ... of that range, two at a time with their sums
//   interleaved;
// - a block copies the first rows of its range once into its shared memory
//   (as many as fit beside the exchange's buffers), row-major, padded to
//   float4s with zeros (which add exactly 0 to a distance) at a stride of 4
//   mod 8 floats, so a quarter warp's float4 loads fall in 8 distinct bank
//   groups; the running min distance sits beside them.  Where all R rows
//   fit, that is the whole kernel (the resident instance: N up to 31,408 at
//   D = 27 and C = 16);
// - past that (the streamed instance) the rest of the range is copied once
//   into a column-major device scratch [D + 1, N] (the last row holds the
//   running min) and read every round, from L2 while it fits its 50 MB, so
//   a warp's load of column j is one cache line; a round's reads from L2 go
//   through C SMs' ports, not one, and only for the rows past the shared
//   memory;
// - the register instance (D <= 32 and R <= 1,024, the AEG's pool among
//   them): each thread also keeps its two rows and their minima in
//   registers, read from shared memory once, so a round reads only the
//   chosen row from shared memory;
// - a round: every thread folds the chosen row into its rows' minima and
//   keeps its best (value, index); a warp argmax (two `redux.sync`: the
//   largest value's ordered bits, then the lowest index holding it), then
//   every warp over the warp winners (one block barrier), gives the block's
//   candidate; the block pushes it and its row, 16 bytes a store
//   (`st.async`), into entry `rank` of every block's inbox in distributed
//   shared memory, each store counted on the receiving block's mbarrier; a
//   block waits on its own mbarrier alone (no cluster barrier, no remote
//   load), then every warp picks the same winner from its C entries (larger
//   value, then lower index: exact and associative, so the split moves no
//   bit) and the next round reads the winner's row where it landed in the
//   inbox.  Inboxes, mbarriers and warp winners alternate by round parity: a
//   block pushes round r + 2 only once every block has pushed round r + 1,
//   which each does only after its block barrier of round r + 1, past its
//   last read of round r's inbox.  Block 0 writes out[r].
//
// The exchange sets the chain's floor (the empty round of
// scripts/fps_empty_round.cu; PERF.md has its times): pushes waited on
// locally cost less than a cluster barrier followed by remote loads, and
// two `redux.sync` less than a 5-step shuffle argmax.

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_D = 1024;
constexpr int G = 2;                // rows a thread sums together
constexpr int ROWS_PER_THREAD = 2;  // the block's threads: ceil(R / this), whole warps
// the register instance: each thread's G rows of up to REG_QUADS float4s in
// registers, so at most REG_THREADS threads (R <= G * REG_THREADS)
constexpr int REG_QUADS = 8;
constexpr int REG_THREADS = 512;
enum Instance { STREAMED = 0, RESIDENT = 1, REGISTERS = 2 };

struct FPSArgs {
  const float* points;   // [N, D]
  const uint8_t* valid;  // [N]
  const int* start;      // [1]
  float* cols;           // streamed: [D + 1, N] scratch (the points column-major, the min)
  int* out;              // [K]
  int N, D, K;
  int rows;  // R, the rows a block owns (the last blocks may own fewer or none)
  int res;   // the first rows of its range that a block holds in shared memory
};

// D padded to whole float4s; a row's stride in shared memory: that, plus 4
// where it is a multiple of 8, so that a quarter warp's float4 loads of 8
// rows fall in 8 distinct 16-byte bank groups.  The pads hold zeros, which
// add exactly 0 to a distance.
__host__ __device__ inline int pad4(int D) { return (D + 3) / 4 * 4; }
__host__ __device__ inline int row_stride(int D) { return pad4(D) % 8 ? pad4(D) : pad4(D) + 4; }
// An inbox entry: (value, index, 0, 0), then the row padded to float4s.
__host__ __device__ inline int entry_floats(int D) { return 4 + pad4(D); }

// The block's shared memory, in floats: two mbarriers (one a round parity),
// the inbox [2][C] entries, the start row, the warp winners [2][32] (by
// parity), then its first `res` rows [res][stride] and their running min.
__host__ __device__ inline size_t fixed_floats(int D, int C) {
  return 4 + 2 * (size_t)C * entry_floats(D) + pad4(D) + 128;
}
__host__ __device__ inline size_t smem_floats(int D, int C, int res) {
  return fixed_floats(D, C) + (size_t)res * (row_stride(D) + 1);
}

struct Layout {
  uint64_t* bar;  // [2]
  float* inbox;   // [2][C][entry]
  float* row0;    // [pad4(D)]
  float* wv;      // [2][32]
  int* wi;        // [2][32]
  float* pts;     // [res][stride], 16-byte aligned
  float* mind;    // [res]
};

__device__ __forceinline__ Layout carve(float* smem, int D, int C, int res) {
  Layout L;
  L.bar = reinterpret_cast<uint64_t*>(smem);
  L.inbox = smem + 4;
  L.row0 = L.inbox + 2 * C * entry_floats(D);
  L.wv = L.row0 + pad4(D);
  L.wi = reinterpret_cast<int*>(L.wv + 64);
  L.pts = reinterpret_cast<float*>(L.wi + 64);
  L.mind = L.pts + (size_t)res * row_stride(D);
  return L;
}

// (v, i) beats (bv, bi): larger value, or the same value at a lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// f32 bits as a u32 whose order is the floats' order (no NaN here)
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// every lane ends with the warp's best pair: the largest value (one
// reduction over its ordered bits), then the lowest index holding it
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  const unsigned key = ordered(v);
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  i = (int)__reduce_min_sync(0xffffffffu, key == top ? (unsigned)i : 0xffffffffu);
  v = __uint_as_float((top & 0x80000000u) ? (top ^ 0x80000000u) : ~top);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of the same shared-memory word in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes into another block's shared memory, counted on its mbarrier
__device__ __forceinline__ void send16(uint32_t dst, uint32_t bar, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(dst),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Before the first round: the mbarriers set up and visible to the cluster.
__device__ __forceinline__ void exchange_init(cg::cluster_group& cluster, const Layout& L) {
  if (threadIdx.x == 0) {
    bar_init(L.bar);
    bar_init(L.bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
}

// One round's exchange.  Each thread brings its best (bv, bi) (bi = INT_MAX
// for none).  The block's candidate and its row go, 16 bytes a store, into
// entry `rank` of every block's inbox of this parity, counted on that
// block's mbarrier; once this block's mbarrier has all C entries, every warp
// picks the winner from them.  Returns the winner; `row` then points at its
// row (in the inbox, until the round after next overwrites it).
// `row_of(i, j)` is coordinate j of the block's own row i.
template <class RowOf>
__device__ __forceinline__ int exchange(const Layout& L, int C, int rank, int N, int D,
                                        int rows, int parity, uint32_t& phases,
                                        const float*& row, float bv, int bi, RowOf row_of) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float* wv = L.wv + 32 * parity;
  int* wi = L.wi + 32 * parity;
  warp_argmax(bv, bi);
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  bv = lane < nwarps ? wv[lane] : -INFINITY;
  bi = lane < nwarps ? wi[lane] : INT_MAX;
  warp_argmax(bv, bi);  // every warp: the block's candidate
  const int ef = entry_floats(D), pieces = ef / 4;
  float* inbox = L.inbox + (size_t)parity * C * ef;
  if (tid == 0) bar_expect(L.bar + parity, (uint32_t)(C * ef * 4));
  const uint32_t mine = smem_u32(inbox + rank * ef), bar = smem_u32(L.bar + parity);
  for (int t = tid; t < C * pieces; t += blockDim.x) {
    const int to = t / pieces, q = t - to * pieces;
    float4 v;
    if (q == 0) {
      v = make_float4(bv, __int_as_float(bi), 0.f, 0.f);
    } else {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * (q - 1) + u;
        x[u] = (bi < N && j < D) ? row_of(bi, j) : 0.f;
      }
      v = make_float4(x[0], x[1], x[2], x[3]);
    }
    send16(map_rank(mine + 16 * q, to), map_rank(bar, to), v);
  }
  bar_wait(L.bar + parity, (phases >> parity) & 1u);
  phases ^= 1u << parity;
  float wv2 = -INFINITY;
  int wi2 = INT_MAX;
  if (lane < C) {
    wv2 = inbox[lane * ef];
    wi2 = __float_as_int(inbox[lane * ef + 1]);
  }
  warp_argmax(wv2, wi2);  // every warp: the cluster's winner (some block has a row)
  row = inbox + (wi2 / rows) * ef + 4;
  return wi2;
}

__device__ __forceinline__ float add_sq(float d, float p, float r) {
  const float diff = __fsub_rn(p, r);
  return __fadd_rn(d, __fmul_rn(diff, diff));
}

// d plus the four squared differences of p and r, in order
__device__ __forceinline__ float add_sq4(float d, float4 p, float4 r) {
  return add_sq(add_sq(add_sq(add_sq(d, p.x, r.x), p.y, r.y), p.z, r.z), p.w, r.w);
}

template <bool REG>
__global__ void __launch_bounds__(REG ? REG_THREADS : MAX_THREADS, 1)
    fps_kernel(const __grid_constant__ FPSArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const Layout L = carve(smem, a.D, C, a.res);
  const int tid = threadIdx.x, nt = blockDim.x, D = a.D, S = row_stride(D);
  const int lo = rank * a.rows;
  const int n = max(0, min(a.N, lo + a.rows) - lo);  // this block's rows
  const int nres = min(n, a.res);                    // ... in shared memory
  const size_t N = a.N;
  float* cmin = a.cols ? a.cols + (size_t)D * N + lo : nullptr;  // streamed rows' min

  for (int e = tid; e < nres * S; e += nt) {
    const int i = e / S, j = e - i * S;
    L.pts[e] = j < D ? __ldg(a.points + (size_t)(lo + i) * D + j) : 0.f;
  }
  for (size_t e = (size_t)nres * D + tid; e < (size_t)n * D; e += nt) {
    const int i = (int)(e / D), j = (int)(e - (size_t)i * D);
    a.cols[(size_t)j * N + lo + i] = __ldg(a.points + (size_t)lo * D + e);
  }
  for (int i = tid; i < n; i += nt) {
    const float m = a.valid[lo + i] ? INFINITY : -INFINITY;
    if (i < nres)
      L.mind[i] = m;
    else
      cmin[i] = m;
  }
  const int s = __ldg(a.start);
  for (int j = tid; j < pad4(D); j += nt)
    L.row0[j] = j < D ? __ldg(a.points + (size_t)s * D + j) : 0.f;
  if (rank == 0 && tid == 0) a.out[0] = s;
  exchange_init(cluster, L);  // also a block barrier: the rows and row0 are in place

  const int nq = pad4(D) / 4;
  float4 pr[REG ? G : 1][REG ? REG_QUADS : 1];  // the register instance's rows
  float md[G];                                  // ... and their running min
  if constexpr (REG) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = min(tid + g * nt, nres - 1);
      const float4* p4 = reinterpret_cast<const float4*>(L.pts + i * S);
#pragma unroll
      for (int q = 0; q < REG_QUADS; ++q)
        pr[g][q] = q < nq && nres > 0 ? p4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      md[g] = tid + g * nt < nres ? L.mind[tid + g * nt] : -INFINITY;
    }
  }

  const float* row = L.row0;
  uint32_t phases = 0;
  for (int r = 1; r < a.K; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    if constexpr (REG) {
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) d[g] = 0.f;  // 0 + sq_0 == sq_0 exactly
#pragma unroll
      for (int q = 0; q < REG_QUADS; ++q) {
        if (q < nq) {
          const float4 rq = r4[q];
#pragma unroll
          for (int g = 0; g < G; ++g) d[g] = add_sq4(d[g], pr[g][q], rq);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float v = fminf(md[g], d[g]);  // invalid points start at -inf and stay there
        md[g] = v;
        if (tid + g * nt < nres && better(v, lo + tid + g * nt, bv, bi)) {
          bv = v;
          bi = lo + tid + g * nt;
        }
      }
    } else {
      auto fold = [&](int i, float d, float* m) {
        const float v = fminf(*m, d);  // invalid points start at -inf and stay there
        *m = v;
        if (better(v, lo + i, bv, bi)) {
          bv = v;
          bi = lo + i;
        }
      };
      // G of the thread's rows at a time, their sums interleaved so that their
      // loads are in flight together (a row past the range repeats its last,
      // unused).  Rows in shared memory: float4 loads, the pads adding 0.
      for (int i0 = tid; i0 < nres; i0 += G * nt) {
        const float4* p4[G];
        float d[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          p4[g] = reinterpret_cast<const float4*>(L.pts + min(i0 + g * nt, nres - 1) * S);
          d[g] = 0.f;  // 0 + sq_0 == sq_0 exactly
        }
#pragma unroll 2
        for (int q = 0; q < pad4(D) / 4; ++q) {
          const float4 rq = r4[q];
#pragma unroll
          for (int g = 0; g < G; ++g) d[g] = add_sq4(d[g], p4[g][q], rq);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (i0 + g * nt < nres) fold(i0 + g * nt, d[g], L.mind + i0 + g * nt);
      }
      // the rest from the column-major scratch (plain loads: this kernel wrote it)
      for (int i0 = nres + tid; i0 < n; i0 += G * nt) {
        const float* p[G];
        float d[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          p[g] = a.cols + lo + min(i0 + g * nt, n - 1);
          d[g] = 0.f;
        }
#pragma unroll 4
        for (int j = 0; j < D; ++j) {
          const float rj = row[j];
#pragma unroll
          for (int g = 0; g < G; ++g) d[g] = add_sq(d[g], p[g][(size_t)j * N], rj);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (i0 + g * nt < n) fold(i0 + g * nt, d[g], cmin + i0 + g * nt);
      }
    }
    const int w = exchange(L, C, rank, a.N, D, a.rows, r & 1, phases, row, bv, bi,
                           [&](int i, int j) {
                             return i - lo < nres ? L.pts[(i - lo) * S + j]
                                                  : __ldg(a.points + (size_t)i * D + j);
                           });
    if (rank == 0 && tid == 0) a.out[r] = w;
  }
  cluster.sync();  // every block's last stores have landed before any block leaves
}

struct Plan {
  int rows, res, threads;
  size_t smem;
};

// The launch of an instance for N points of width D in a cluster of C
// blocks: each block's rows, those it holds in shared memory (all of them,
// or for the streamed instance as many as fit), its threads.  Refuses an
// instance that the shape does not fit.
cudaError_t make_plan(int N, int D, int C, int inst, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long long room = optin / (long long)sizeof(float) - (long long)fixed_floats(D, C);
  p->rows = (N + C - 1) / C;
  const long long fit = room < 0 ? 0 : room / (row_stride(D) + 1);
  const int per = ROWS_PER_THREAD;
  p->threads = std::min(MAX_THREADS, std::max(32, (p->rows + per * 32 - 1) / (per * 32) * 32));
  if (room < 0 || inst < STREAMED || inst > REGISTERS || (inst != STREAMED && fit < p->rows) ||
      (inst == REGISTERS && (pad4(D) > 4 * REG_QUADS || p->threads > REG_THREADS)))
    return cudaErrorInvalidValue;
  p->res = (int)std::min<long long>(p->rows, fit);
  p->smem = smem_floats(D, C, p->res) * sizeof(float);
  return cudaSuccess;
}

// Set the kernel's attributes and fill a launch of one cluster of C blocks.
template <bool REG>
cudaError_t prepare(const Plan& p, int C, cudaStream_t stream, cudaLaunchAttribute* attr,
                    cudaLaunchConfig_t* cfg) {
  cudaError_t err =
      cudaFuncSetAttribute(fps_kernel<REG>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fps_kernel<REG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C);
  cfg->blockDim = dim3(p.threads);
  cfg->dynamicSmemBytes = p.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <bool REG>
cudaError_t clusters(const Plan& p, int C, int* count) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err = prepare<REG>(p, C, 0, attr, &cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, fps_kernel<REG>, &cfg);
}

template <bool REG>
cudaError_t launch(const Plan& p, int C, const FPSArgs& a, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err = prepare<REG>(p, C, stream, attr, &cfg);
  return err != cudaSuccess ? err : cudaLaunchKernelEx(&cfg, fps_kernel<REG>, a);
}

}  // namespace

// How many clusters of C blocks of instance `inst` (0 streamed, 1 resident,
// 2 registers) the card can hold at once for N points of width D (0: it
// cannot launch one).  Returns a cudaError_t.
extern "C" int mupe_fps_clusters(int N, int D, int C, int inst, int* count) {
  if (N < 1 || D < 1 || D > MAX_D || C < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(N, D, C, inst, &p);
  if (err == cudaSuccess)
    err = inst == REGISTERS ? clusters<true>(p, C, count) : clusters<false>(p, C, count);
  return (int)err;
}

// points [N, D] f32, valid [N] u8 (nonzero = valid), start [1] i32, cols
// [D + 1, N] f32 scratch (streamed only, else null), out [K] i32; all device
// pointers.  1 <= K <= N; one cluster of C blocks of instance `inst`.
// Returns a cudaError_t.
extern "C" int mupe_fps(const float* points, const uint8_t* valid, const int* start, int N,
                        int D, int K, int C, int inst, float* cols, int* out, void* stream) {
  if (N < 1 || D < 1 || D > MAX_D || K < 1 || K > N || C < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(N, D, C, inst, &p);
  if (err == cudaSuccess && inst == STREAMED && !cols) err = cudaErrorInvalidValue;
  const FPSArgs a = {points, valid, start, cols, out, N, D, K, p.rows, p.res};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (err == cudaSuccess)
    err = inst == REGISTERS ? launch<true>(p, C, a, s) : launch<false>(p, C, a, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
