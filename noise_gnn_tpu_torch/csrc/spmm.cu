// CSR segment-sum / segment-mean SpMM for Hopper (sm_90a), edge-balanced.
//
//   out[v] = scale(v) * sum_{u in N_in(v)} x[u],   scale = 1/max(deg(v), 1)
//            for mean, 1 for sum; rows with no in-edges give 0.
//
// Replaces the Pallas TPU kernel noise_gnn_tpu/ops/pallas_spmm.py:147
// (_reduce_kernel_chunked) together with the XLA gather that feeds it
// (pallas_spmm.py:56-83, :481-501). It ports the semantics, not the TPU
// schedule: the one-hot MXU reduce, chunk maps, super-groups, aliased output
// and gather padding all served the TPU's gather engine and have no use here.
//
// Bound on the H100: memory. The least a call must move is x, the indices
// and indptr read once and out written once (products F = 512 bf16: 5.3 GB,
// 1.6 ms at 3.35 TB/s). A gather from random sources reads one source row
// per EDGE, and only rows the 50 MB L2 still holds come without a trip to
// device memory: at most E * F * itemsize bytes (products F = 512 bf16:
// 63.3 GB, 18.9 ms at 3.35 TB/s). The design answers what kept a
// one-warp-per-row kernel from that rate:
//
// 1. Hub rows set the tail. A warp that owns a whole row walks a hub's
//    thousands of edges alone (arxiv's largest in-degree is 3380, products'
//    7411). Here the wrapper (ops/spmm.py::segment_schedule) cuts every
//    row's edge range once per graph into segments of at most S edges and
//    orders them longest first, and one warp takes one segment. A row of one
//    segment is scaled, cast and written directly. A row of several writes
//    one fp32 partial per segment to scratch, and spmm_combine_kernel sums
//    each such row's partials in segment order, scales, casts and writes it.
//    There are no float atomics, so every call gives the same bits.
// 2. Loads in flight cost registers, and registers cost resident warps.
//    Each lane stages its pieces of the next U source rows in a ring in
//    shared memory, filled with cp.async: as soon as slot u has been added,
//    the copy of the edge U slots ahead is issued into it, so kLoadsPerLane
//    vector loads stay in flight per lane whatever the row width, and the
//    registers hold only the sums. A lane reads back only what it copied, so
//    it waits on its own copy groups and never on the warp. The segment's
//    next 32 source indices are loaded 32 edges before they are needed.
// 3. Narrow rows leave lanes idle. A row of at most 32 vectors is taken by
//    groups of 8 or 16 lanes, each group a different edge, and the groups'
//    sums are combined with shuffles in a fixed order at the end (products'
//    200-byte leaf rows are 25 vectors: 16-lane groups, 2 vectors a lane).
// 4. A source table several times the L2 is re-read from device memory at
//    every edge. Where a 256-byte column slice of every source row fits in
//    the L2 (arxiv at F = 512 f32: 347 MB, a slice 43 MB), the grid runs
//    slice-major (col_slices), so the L2 serves the re-reads. Products'
//    2.45 M rows leave no slice that fits; there the gather runs at the
//    memory rate of its per-edge bytes.
//
// Loads are as wide as alignment allows: the vector width V is the widest
// with F % V == 0 and both base pointers aligned (products' raw F = 100 in
// bf16 is a 200-byte row, so it takes 8-byte loads). Row offsets src * F are
// int64. No [E, F] message buffer exists.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int B> struct Raw;
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<4> { using T = unsigned int; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// p[i] = v[i] * s for i < V, in aligned pieces of at most 16 bytes.
template <typename Tout, int V>
__device__ __forceinline__ void store_scaled(Tout* __restrict__ p, const float* v, float s) {
  constexpr int kBytes = V * (int)sizeof(Tout);
  constexpr int kPiece = kBytes > 16 ? 16 : kBytes;
  constexpr int kPer = kPiece / (int)sizeof(Tout);
  using R = typename Raw<kPiece>::T;
#pragma unroll
  for (int k = 0; k < V / kPer; ++k) {
    R r;
    Tout* e = reinterpret_cast<Tout*>(&r);
#pragma unroll
    for (int i = 0; i < kPer; ++i) e[i] = from_f32<Tout>(v[k * kPer + i] * s);
    *reinterpret_cast<R*>(p + k * kPer) = r;
  }
}

constexpr int kWarpsPerBlock = 8;
constexpr int kLoadsPerLane = 4;  // vector loads each lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy one B-byte vector from device memory to shared memory without
// waiting: cp.async (16-byte pieces skip L1, .cg). cp.async takes no 2-byte
// piece, so a 2-byte vector is copied by a plain load and store.
template <int B> __device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  } else if constexpr (B == 2) {
    *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(B)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Edges each lane keeps in flight for T vectors a lane in groups of L lanes:
// kLoadsPerLane loads, and a round (G * U edges) within a batch of 32.
__host__ __device__ constexpr int edges_in_flight(int L, int T) {
  return T >= kLoadsPerLane ? 1 : (kLoadsPerLane / T > L ? L : kLoadsPerLane / T);
}

// One warp per (column slice, segment), slice-major. The warp's lanes form
// G = 32 / L groups of L lanes; in every round group g takes edges g,
// g + G, ..., g + (U - 1) G of the round's G * U edges, and lane l of a
// group owns vectors l, l + L, ..., l + (T - 1) L of the current column
// pass. Slice c of `slices` takes column passes c, c + slices, ...
template <typename Tin, typename Tout, int V, int L, int T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_segment_kernel(const int32_t* __restrict__ indices, const Tin* __restrict__ x,
                    const int64_t* __restrict__ seg_start, const int32_t* __restrict__ seg_len,
                    const int32_t* __restrict__ seg_dst, Tout* __restrict__ out,
                    float* __restrict__ partial, int64_t nseg, int64_t f, int mean,
                    int slices) {
  using R = typename Raw<V * sizeof(Tin)>::T;
  constexpr int U = edges_in_flight(L, T);
  constexpr int G = 32 / L;
  constexpr int kRound = G * U;  // edges per round
  static_assert(32 % kRound == 0, "a round must lie within one batch of 32 indices");
  const int lane = threadIdx.x & 31;
  const int g = lane / L;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t c = w / nseg, s = w - c * nseg;
  if (c >= slices) return;  // uniform across the warp
  const int32_t* idx = indices + seg_start[s];
  const int len = seg_len[s];
  const int dst = seg_dst[s];
  const int64_t nvec = f / V;
  const int rounds = (len + kRound - 1) / kRound;

  for (int64_t vbase = c * L * T; vbase < nvec; vbase += (int64_t)L * T * slices) {
    int col[T];  // element offset of each owned vector in a row
    bool live[T];
    float acc[T][V];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int64_t vi = vbase + t * L + lane % L;
      live[t] = vi < nvec;
      col[t] = (int)(vi * V);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[t][i] = 0.0f;
    }
    // this lane's ring: slot u's vector t at ring[(u * T + t) * 32]; a lane
    // reads back only what it copied itself, so its own waits suffice
    extern __shared__ __align__(16) unsigned char smem_raw[];
    R* ring = reinterpret_cast<R*>(smem_raw) + (threadIdx.x >> 5) * (U * T * 32) + lane;
    // source indices of edges [32 b, 32 b + 32) and of the batch after
    int cur = lane < len ? idx[lane] : 0;
    int nxt = 32 + lane < len ? idx[32 + lane] : 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = u * G + g;
      const int64_t src = __shfl_sync(kFull, cur, k);
      if (k < len) {
        const Tin* row = x + src * f;
#pragma unroll
        for (int t = 0; t < T; ++t)
          if (live[t]) cp_async<sizeof(R)>(ring + (u * T + t) * 32, row + col[t]);
      }
      cp_commit();
    }
    for (int r = 0; r < rounds; ++r) {
      const int k0 = r * kRound, k1 = k0 + kRound;
      const bool turn = (k1 & 31) == 0;  // the next round starts the next batch
      const int from = turn ? nxt : cur;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = u * G + g;
        cp_wait<U - 1>();
        if (k0 + k < len) {
#pragma unroll
          for (int t = 0; t < T; ++t) {
            if (!live[t]) continue;
            const R r = ring[(u * T + t) * 32];
            const Tin* e = reinterpret_cast<const Tin*>(&r);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[t][i] += to_f32(e[i]);
          }
        }
        const int64_t src = __shfl_sync(kFull, from, (k1 + k) & 31);
        if (k1 + k < len) {
          const Tin* row = x + src * f;
#pragma unroll
          for (int t = 0; t < T; ++t)
            if (live[t]) cp_async<sizeof(R)>(ring + (u * T + t) * 32, row + col[t]);
        }
        cp_commit();
      }
      if (turn) {
        cur = nxt;
        nxt = k1 + 32 + lane < len ? idx[k1 + 32 + lane] : 0;
      }
    }
    if constexpr (G > 1) {
      // the groups' sums, in a fixed butterfly order
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int o = L; o < 32; o <<= 1) acc[t][i] += __shfl_xor_sync(kFull, acc[t][i], o);
    }
    if (g != 0) continue;
    if (dst >= 0) {  // the row's only segment: scale, cast, write
      const float scale = mean ? 1.0f / (float)(len > 1 ? len : 1) : 1.0f;
      Tout* o = out + (int64_t)dst * f;
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (live[t]) store_scaled<Tout, V>(o + col[t], acc[t], scale);
    } else {  // one segment of a split row: its fp32 partial
      float* p = partial + (int64_t)(-1 - dst) * f;
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (live[t]) store_scaled<float, V>(p + col[t], acc[t], 1.0f);
    }
  }
}

// One warp per split row: the sum of its partials in segment order, scaled,
// cast and written.
template <typename Tout>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_combine_kernel(const int64_t* __restrict__ indptr, const int32_t* __restrict__ comb_row,
                    const int64_t* __restrict__ comb_ptr, const float* __restrict__ partial,
                    Tout* __restrict__ out, int64_t nsplit, int64_t f, int mean) {
  const int lane = threadIdx.x & 31;
  const int64_t j = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= nsplit) return;
  const int64_t row = comb_row[j];
  const int64_t p0 = comb_ptr[j], p1 = comb_ptr[j + 1];
  const int64_t deg = indptr[row + 1] - indptr[row];
  const float scale = mean ? 1.0f / (float)(deg > 1 ? deg : 1) : 1.0f;
  for (int64_t c = lane; c < f; c += 32) {
    float sum = 0.0f;
    for (int64_t p = p0; p < p1; ++p) sum += partial[p * f + c];
    out[row * f + c] = from_f32<Tout>(sum * scale);
  }
}

struct Args {
  const int64_t* indptr;
  const int32_t* indices;
  const void* x;
  const int64_t* seg_start;
  const int32_t* seg_len;
  const int32_t* seg_dst;
  int64_t nseg;
  const int32_t* comb_row;
  const int64_t* comb_ptr;
  int64_t nsplit;
  float* partial;
  void* out;
  int64_t f;
  int mean;
  cudaStream_t stream;
  int64_t n_src;
  int slices;
};

template <typename Tin, typename Tout, int V, int L, int T>
cudaError_t launch(const Args& a) {
  const int64_t blocks = (a.nseg * a.slices + kWarpsPerBlock - 1) / kWarpsPerBlock;
  constexpr int U = edges_in_flight(L, T);
  constexpr int smem = kWarpsPerBlock * U * T * 32 * V * (int)sizeof(Tin);  // the warps' rings
  static_assert(smem <= 48 * 1024, "the rings must fit the default dynamic shared memory");
  spmm_segment_kernel<Tin, Tout, V, L, T><<<(unsigned)blocks, kWarpsPerBlock * 32, smem, a.stream>>>(
      a.indices, static_cast<const Tin*>(a.x), a.seg_start, a.seg_len, a.seg_dst,
      static_cast<Tout*>(a.out), a.partial, a.nseg, a.f, a.mean, a.slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 0) return err;
  const int64_t cblocks = (a.nsplit + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_combine_kernel<Tout><<<(unsigned)cblocks, kWarpsPerBlock * 32, 0, a.stream>>>(
      a.indptr, a.comb_row, a.comb_ptr, a.partial, static_cast<Tout*>(a.out), a.nsplit, a.f,
      a.mean);
  return cudaGetLastError();
}

// Column slices. Where the source table is over four times the L2 but a
// slice of kSliceBytes of every source row fits in it, the grid runs
// slice-major: every segment over slice 0's columns, then over slice 1's,
// and so on, so the warps resident together read one slice, which the L2
// then serves to every edge after the first that reads a row.
constexpr int64_t kL2Bytes = 50000000;
constexpr int64_t kSliceBytes = 256;

int col_slices(int64_t n_src, int64_t row_bytes) {
  if (n_src * row_bytes <= 4 * kL2Bytes || n_src * kSliceBytes > kL2Bytes) return 1;
  return (int)((row_bytes + kSliceBytes - 1) / kSliceBytes);
}

// (L, T) from the number of vectors a warp covers: groups of 8 or 16 lanes
// for at most 8, 16 or 32 vectors, else whole warps with 2 or 4 vectors a
// lane per column pass.
template <typename Tin, typename Tout, int V>
cudaError_t launch_lt(Args a) {
  const int64_t nvec = a.f / V;
  a.slices = col_slices(a.n_src, a.f * (int64_t)sizeof(Tin));
  const int64_t per = (nvec + a.slices - 1) / a.slices;
  if (per <= 8) return launch<Tin, Tout, V, 8, 1>(a);
  if (per <= 16) return launch<Tin, Tout, V, 16, 1>(a);
  if (per <= 32) return launch<Tin, Tout, V, 16, 2>(a);
  if (per <= 64) return launch<Tin, Tout, V, 32, 2>(a);
  return launch<Tin, Tout, V, 32, 4>(a);
}

template <typename Tin, typename Tout>
cudaError_t launch_v(const Args& a, int v) {
  if constexpr (sizeof(Tin) == 2) {
    if (v == 8) return launch_lt<Tin, Tout, 8>(a);
  }
  if (v == 4) return launch_lt<Tin, Tout, 4>(a);
  if (v == 2) return launch_lt<Tin, Tout, 2>(a);
  return launch_lt<Tin, Tout, 1>(a);
}

}  // namespace

// Plain C entry point (bound with ctypes). indptr int64 [n_rows + 1],
// indices int32 [E]; x [N_src, f] and out [n_rows, f] row-major contiguous,
// float32 (flag 0) or bfloat16 (flag 1). The schedule (ops/spmm.py::
// segment_schedule): seg_start int64, seg_len int32 and seg_dst int32 [nseg]
// (seg_dst = the output row, or -1 - the segment's partial slot), comb_row
// int32 [nsplit] and comb_ptr int64 [nsplit + 1]; partial fp32 [comb_ptr
// [nsplit], f] is scratch. Launches on `stream`, does not synchronise, and
// returns the first cudaGetLastError() of the launches (0 = success).
extern "C" int ngt_spmm_segments(const void* indptr, const void* indices, const void* x,
                                 const void* seg_start, const void* seg_len, const void* seg_dst,
                                 long long nseg, const void* comb_row, const void* comb_ptr,
                                 long long nsplit, void* partial, void* out, long long n_src,
                                 long long f, int x_bf16, int out_bf16, int mean, int device,
                                 void* stream) {
  if (nseg <= 0 || f <= 0) return 0;
  int cur = -1;
  cudaGetDevice(&cur);
  if (cur != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const int in_size = x_bf16 ? 2 : 4;
  const int out_size = out_bf16 ? 2 : 4;
  int v = 16 / in_size;  // widest load: 16 bytes
  while (v > 1) {
    const int out_piece = v * out_size > 16 ? 16 : v * out_size;
    const bool ok = f % v == 0 && reinterpret_cast<uintptr_t>(x) % (v * in_size) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % out_piece == 0;
    if (ok) break;
    v >>= 1;
  }
  Args a{static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(indices), x,
         static_cast<const int64_t*>(seg_start), static_cast<const int32_t*>(seg_len),
         static_cast<const int32_t*>(seg_dst), nseg, static_cast<const int32_t*>(comb_row),
         static_cast<const int64_t*>(comb_ptr), nsplit, static_cast<float*>(partial), out, f,
         mean, static_cast<cudaStream_t>(stream), n_src};
  cudaError_t err;
  if (x_bf16 && out_bf16) err = launch_v<__nv_bfloat16, __nv_bfloat16>(a, v);
  else if (x_bf16) err = launch_v<__nv_bfloat16, float>(a, v);
  else if (out_bf16) err = launch_v<float, __nv_bfloat16>(a, v);
  else err = launch_v<float, float>(a, v);
  return (int)err;
}
