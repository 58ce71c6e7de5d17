// The similarity top-k rewire's segment extrema and chosen segments, for
// Hopper (sm_90a), in float32 FFMA.
//
// Replaces no TPU kernel: the JAX package leaves the rewire's blocks to XLA
// (noise_gnn_tpu/augment/rewire.py, ops/sddmm.py::hier_topk), and so did the
// port, which formed each [2048, N] f32 similarity block hp[rows] @ hn.T
// with cuBLAS, negated a copy, wrote the exclusions into both and read each
// once more for its 128-column segment maxima: ~6.5 GB of traffic a block,
// to give 2 x block x N / 128 maxima, and every cosine computed twice (the
// product is symmetric). Added for the TE step's rewire (N = 159,232, D =
// 256, 78 blocks a step; ops/sddmm.py's fused route, augment/rewire.py).
//
// Bound on the H100: operations. The whole step's maxima need the upper
// half of hn hn^T, N^2 D = 6.49e12 FLOP (97 ms at 67 TFLOP/s of f32 FFMA);
// their writes are 1.6 GB (0.5 ms). Tensor cores are not an option: the
// picks must be the ones the cuBLAS product gives, bit for bit, and many
// are pairs of duplicated leaves whose cosines differ in the last ulp.
//
// Arithmetic: every similarity is one FMA chain over k = 0 ... D - 1 in
// order, from +0.0: acc = fmaf(hn[r, k], hn[c, k], acc). That is what the
// FFMA SGEMM computes for hp[rows] @ hn.T at these shapes (no split-K, one
// accumulator an output), and since the product commutes, (r, c) and (c, r)
// get the same bits.
//
// ngt_rewire_extrema (mode 0) writes, per row r of [row0, row_hi) and per
// segment J, the maximum of sim (ext_pos) and, where ext_neg is given, of
// -sim (ext_neg) over the segment's columns other than r and excl[r], in
// the floats' total order (-0.0 below +0.0): on the int32 image
// key = b ^ ((b >> 31) & 0x7fffffff), and key(-x) = ~key(x), so the maximum
// of -sim is ~(the least key of sim). The design:
//
// 1. Symmetry. The work list holds the 128 x 128 tiles (I, J) with J >= I
//    where both lie in the range, and every J outside it (one rank's part
//    of a mesh). A tile's row extrema fill row tile I's entries of segment
//    J; where J lies in the range and J != I its column extrema fill row
//    tile J's entries of segment I. The list runs in bands of 8 row tiles,
//    J-major inside a band, so the ~264 tiles in flight share 8 A tiles
//    and ~33 B tiles in the L2. A block finds its t-th tile by arithmetic
//    (band_tile, whose plain version is ops/sddmm.py::tile_of): no list
//    lives in device memory.
// 2. Persistent blocks, two an SM, walk the list with a stride of the grid.
//    k-slices of 16 rows of hn^T (one 512-byte row of 128 floats per k and
//    operand) stream through a 4-stage cp.async ring in shared memory; the
//    next tile's first slices are in flight while a tile's epilogue runs.
// 3. Each thread holds an 8 x 8 register tile (rows ty*4 + {0..3} and
//    64 + ty*4 + {0..3}, columns likewise with tx): 64 FFMA per four 16-byte
//    shared loads.
// 4. The epilogue reduces in registers: a row's 8 values, then the 16
//    threads of a row by shuffles; a column's 8 values, the two threads of a
//    warp by a shuffle, the 8 warps through 8 KB of shared memory. The
//    similarities never reach device memory.
//
// mode 1 writes the similarities themselves, sim[r - row0, c], from the same
// main loop (a check of the arithmetic against cuBLAS; not on the main path).
//
// ngt_topk_keys writes ops/sddmm.py::stable_topk's int64 keys (order key,
// complement of the index) in one pass, where torch ops took eight over
// the rewire's 1e9 keys a step.
//
// ngt_rewire_values gives the rewire's second stage the 128 values of each
// chosen segment (row r, segment J; sim or -sim, excluded entries -inf, rows
// >= N -inf whole), from the same FMA chain, so bit-equal to the block's.
// The entries come sorted by J and cut into chunks of at most 64 of one J
// (ops/sddmm.py::value_chunks): a chunk is one 64 x 128 tile whose A rows are
// the entries' rows of hn and whose B is column tile J of hn^T, so each B
// tile is read about once a call. ~2 x 31,846 segments a block: 3.3e11 FLOP
// a step against 6.5e12 for the extrema.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;     // tile side, the segment width
constexpr int kBK = 16;        // k rows of one ring stage of the extrema kernel
constexpr int kVBK = 16;       // and of the values kernel
constexpr int kStages = 4;     // ring depth of the extrema kernel
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;     // entries of one values chunk
constexpr int kVStages = 3;    // ring depth of the values kernel
constexpr int kAPad = kVBK + 4; // a values chunk's A row: k values, padded
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the float's int32 image in the floats' total order, and back
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// a thread's i-th row (or column) of a tile: two runs of 4, 64 apart
__device__ __forceinline__ int sub(int t, int i) { return (i < 4 ? 0 : 64) + t * 4 + (i & 3); }

struct ExtArgs {
  const float* hnt;  // [D, N]
  long long ntiles, n;
  int d, band;
  long long row0, row_hi;  // the rows' range (whole tiles)
  const int* excl_pos;
  const int* excl_neg;  // null: pos only
  float* ext_pos;       // [rows, N / 128], row r at r - row0
  float* ext_neg;
  float* sim;  // mode 1: [rows, N]
};

struct ExtSmem {
  float a[kStages][kBK][kTile];
  float b[kStages][kBK][kTile];
  int cmax[kWarps][kTile];
  int cmin[kWarps][kTile];
};

// k-slice ks of tiles I (A) and J (B) into ring stage st: kBK rows of 128
// floats each, kBK / 8 x 16 bytes a thread and operand; rows k >= D are
// skipped
__device__ __forceinline__ void load_slice(ExtSmem& s, int st, const ExtArgs& p, int I, int J,
                                           int ks, int tid) {
  const int k0 = ks * kBK;
#pragma unroll
  for (int q = 0; q < kBK * kTile / 4 / kThreads; ++q) {
    const int c = tid + q * kThreads;
    const int k = c >> 5, v = (c & 31) * 4;
    if (k0 + k < p.d) {
      const float* row = p.hnt + (long long)(k0 + k) * p.n;
      cp16(&s.a[st][k][v], row + (long long)I * kTile + v);
      cp16(&s.b[st][k][v], row + (long long)J * kTile + v);
    }
  }
}

struct Tile {
  int i, j;
};

// tiles before band g of full bands: each has tri(G) + G (T - G) - G^2 g
__device__ __forceinline__ long long band_off(long long g, long long a, long long b) {
  return g * a - b * g * (g - 1) / 2;
}

// the t-th tile of the extrema's work list (ops/sddmm.py::tile_of): bands
// of G row tiles from t_lo; in band g (rows I0 ... I0 + nI - 1) first the
// triangle J in [I0, I0 + nI), I <= J, J-major; then every J of [0, t_lo)
// and [I0 + nI, T), nI tiles each
__device__ Tile band_tile(long long t, const ExtArgs& p) {
  const long long nt = p.n / kTile, lo = p.row0 / kTile, hi = p.row_hi / kTile, g_ = p.band;
  const long long a = g_ * (g_ + 1) / 2 + g_ * (nt - g_), b = g_ * g_;
  const long long full = (hi - lo) / g_;
  long long g = full;
  if (t < band_off(full, a, b)) {  // off(g) <= t: g below the root of a quadratic
    const double h = (double)a + 0.5 * (double)b;
    g = (long long)((h - sqrt(h * h - 2.0 * (double)b * (double)t)) / (double)b);
    g = g < 0 ? 0 : (g > full - 1 ? full - 1 : g);
    while (g + 1 < full && band_off(g + 1, a, b) <= t) ++g;
    while (g > 0 && band_off(g, a, b) > t) --g;
  }
  const long long i0 = lo + g * g_, ni = min(g_, hi - i0);
  long long u = t - band_off(g, a, b);
  if (u < ni * (ni + 1) / 2) {
    long long jj = 0;
    while ((jj + 1) * (jj + 2) / 2 <= u) ++jj;
    return {(int)(i0 + u - jj * (jj + 1) / 2), (int)(i0 + jj)};
  }
  u -= ni * (ni + 1) / 2;
  const long long col = u / ni;
  return {(int)(i0 + u % ni), (int)(col < lo ? col : i0 + ni + col - lo)};
}

// mode 1's list: every J of every row tile of the range, row-major
template <int kMode> __device__ __forceinline__ Tile tile_at(long long t, const ExtArgs& p) {
  if constexpr (kMode == 1) {
    const long long nt = p.n / kTile;
    return {(int)(p.row0 / kTile + t / nt), (int)(t % nt)};
  } else {
    return band_tile(t, p);
  }
}

__device__ __forceinline__ void prologue(ExtSmem& s, const ExtArgs& p, Tile tl, int kt_n,
                                         int tid) {
  const int I = tl.i, J = tl.j;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < kt_n) load_slice(s, st, p, I, J, st, tid);
    cp_commit();
  }
}

// acc[i][j] = fmaf(a[i], b[j], acc[i][j]) over the stage's k in order
template <bool kWhole>
__device__ __forceinline__ void fma_slice(const ExtSmem& s, int st, int kc, int tx, int ty,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    if (!kWhole && kk >= kc) break;
    const float4 a0 = *reinterpret_cast<const float4*>(&s.a[st][kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&s.a[st][kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s.b[st][kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&s.b[st][kk][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <bool kNeg>
__device__ __forceinline__ void row_extrema(const ExtArgs& p, int I, int J, int tx, int ty,
                                            const float (&acc)[8][8]) {
  const long long nseg = p.n / kTile;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = I * kTile + sub(ty, i);
    const int ep = p.excl_pos[r];
    const int en = kNeg ? p.excl_neg[r] : 0;
    int mx = INT_MIN, mn = INT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = J * kTile + sub(tx, j);
      const int key = order_key(acc[i][j]);
      if (c != r && c != ep) mx = max(mx, key);
      if (kNeg && c != r && c != en) mn = min(mn, key);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      mx = max(mx, __shfl_xor_sync(kFull, mx, off));
      if (kNeg) mn = min(mn, __shfl_xor_sync(kFull, mn, off));
    }
    if (tx == 0) {
      const long long o = (r - p.row0) * nseg + J;
      p.ext_pos[o] = from_key(mx);
      if (kNeg) p.ext_neg[o] = from_key(~mn);
    }
  }
}

// the column extrema of tile (I, J), I != J: row c of tile J, segment I
template <bool kNeg>
__device__ __forceinline__ void col_extrema(ExtSmem& s, const ExtArgs& p, int I, int J, int tid,
                                            const float (&acc)[8][8]) {
  const int tx = tid & 15, ty = tid >> 4, warp = tid >> 5, lane = tid & 31;
  const long long nseg = p.n / kTile;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cl = sub(tx, j);
    const int c = J * kTile + cl;
    const int ep = p.excl_pos[c];
    const int en = kNeg ? p.excl_neg[c] : 0;
    int mx = INT_MIN, mn = INT_MAX;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = I * kTile + sub(ty, i);  // never c: I != J
      const int key = order_key(acc[i][j]);
      if (r != ep) mx = max(mx, key);
      if (kNeg && r != en) mn = min(mn, key);
    }
    mx = max(mx, __shfl_xor_sync(kFull, mx, 16));
    if (kNeg) mn = min(mn, __shfl_xor_sync(kFull, mn, 16));
    if (lane < 16) {
      s.cmax[warp][cl] = mx;
      if (kNeg) s.cmin[warp][cl] = mn;
    }
  }
  __syncthreads();
  if (tid < kTile) {
    int mx = s.cmax[0][tid], mn = kNeg ? s.cmin[0][tid] : 0;
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      mx = max(mx, s.cmax[w][tid]);
      if (kNeg) mn = min(mn, s.cmin[w][tid]);
    }
    const long long o = ((long long)J * kTile + tid - p.row0) * nseg + I;
    p.ext_pos[o] = from_key(mx);
    if (kNeg) p.ext_neg[o] = from_key(~mn);
  }
}

// kMode 0: extrema (kNeg: both signs); 1: the similarities written out
template <int kMode, bool kNeg>
__global__ void __launch_bounds__(kThreads, 2) extrema_kernel(const ExtArgs p) {
  extern __shared__ __align__(16) unsigned char raw[];
  ExtSmem& s = *reinterpret_cast<ExtSmem*>(raw);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt_n = (p.d + kBK - 1) / kBK;
  const long long t_lo = p.row0 / kTile, t_hi = p.row_hi / kTile;
  long long t = blockIdx.x;
  if (t >= p.ntiles) return;
  Tile tl = tile_at<kMode>(t, p);
  prologue(s, p, tl, kt_n, tid);
  for (; t < p.ntiles; t += gridDim.x) {
    const int I = tl.i, J = tl.j;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int kt = 0; kt < kt_n; ++kt) {
      cp_wait<kStages - 2>();
      __syncthreads();  // slice kt is in; every warp is done with slice kt - 1
      const int nxt = kt + kStages - 1;
      if (nxt < kt_n) load_slice(s, nxt % kStages, p, I, J, nxt, tid);
      cp_commit();
      const int kc = min(kBK, p.d - kt * kBK);
      if (kc == kBK) fma_slice<true>(s, kt % kStages, kc, tx, ty, acc);
      else fma_slice<false>(s, kt % kStages, kc, tx, ty, acc);
    }
    __syncthreads();  // the ring is free: start the next tile's slices
    if (t + gridDim.x < p.ntiles) {
      tl = tile_at<kMode>(t + gridDim.x, p);
      prologue(s, p, tl, kt_n, tid);
    }
    if constexpr (kMode == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* o = p.sim + ((long long)I * kTile + sub(ty, i) - p.row0) * p.n +
                   (long long)J * kTile;
        *reinterpret_cast<float4*>(o + tx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(o + 64 + tx * 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    } else {
      row_extrema<kNeg>(p, I, J, tx, ty, acc);
      if (J != I && J >= t_lo && J < t_hi) col_extrema<kNeg>(s, p, I, J, tid, acc);
    }
  }
}

template <int kMode, bool kNeg> cudaError_t launch_extrema(const ExtArgs& p, cudaStream_t stream) {
  const int smem = (int)sizeof(ExtSmem);
  auto kern = extrema_kernel<kMode, kNeg>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long grid = std::min(p.ntiles, (long long)sms * std::max(per_sm, 1));
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ values

struct ValArgs {
  const float* hn;   // [N, D]
  const float* hnt;  // [D, N]
  const int* row;    // sorted entries: row (may be >= N), column tile,
  const int* seg;    //   excluded column (-1 none), negated, output row
  const int* excl;
  const int* neg;
  const int* dst;
  const int* starts;  // chunks: first sorted entry, entries (0: none)
  const int* lens;
  long long n;
  int d;
  float* out;  // [entries, 128]
};

struct ValSmem {
  float a[kVStages][kChunk][kAPad];
  float b[kVStages][kVBK][kTile];
};

template <bool kVec>
__device__ __forceinline__ void load_values_slice(ValSmem& s, int st, const ValArgs& p,
                                                  const int* rows, int J, int ks, int tid) {
  const int k0 = ks * kVBK;
  if (kVec) {  // D % 4 == 0 and hn 16-byte aligned: a 16-byte piece a thread
    const int e = tid >> 2, q = (tid & 3) * 4;
    if (k0 + q < p.d) cp16(&s.a[st][e][q], p.hn + (long long)rows[e] * p.d + k0 + q);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = tid + u * kThreads;
      const int e = c >> 4, k = c & 15;
      if (k0 + k < p.d) cp4(&s.a[st][e][k], p.hn + (long long)rows[e] * p.d + k0 + k);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c = tid + q * kThreads;
    const int k = c >> 5, v = (c & 31) * 4;
    if (k0 + k < p.d)
      cp16(&s.b[st][k][v], p.hnt + (long long)(k0 + k) * p.n + (long long)J * kTile + v);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) values_kernel(const ValArgs p) {
  __shared__ __align__(16) ValSmem s;
  __shared__ int rows[kChunk];
  const int len = p.lens[blockIdx.x];
  if (len == 0) return;
  const int e0 = p.starts[blockIdx.x];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int J = p.seg[e0];
  if (tid < kChunk) {
    const int r = p.row[e0 + (tid < len ? tid : 0)];
    rows[tid] = r < p.n ? r : (int)p.n - 1;  // rows past N load row N - 1, give -inf
  }
  __syncthreads();
  const int kt_n = (p.d + kVBK - 1) / kVBK;
#pragma unroll
  for (int st = 0; st < kVStages - 1; ++st) {
    if (st < kt_n) load_values_slice<kVec>(s, st, p, rows, J, st, tid);
    cp_commit();
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_wait<kVStages - 2>();
    __syncthreads();
    const int nxt = kt + kVStages - 1;
    if (nxt < kt_n) load_values_slice<kVec>(s, nxt % kVStages, p, rows, J, nxt, tid);
    cp_commit();
    const int st = kt % kVStages;
    const int kc = min(kVBK, p.d - kt * kVBK);
#pragma unroll
    for (int kk = 0; kk < kVBK; ++kk) {
      if (kk >= kc) break;
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[st][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.b[st][kk][64 + tx * 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = s.a[st][ty * 4 + i][kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = ty * 4 + i;
    if (e >= len) continue;
    const int r = p.row[e0 + e], ex = p.excl[e0 + e], ng = p.neg[e0 + e];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = J * kTile + sub(tx, j);
      const float x = ng ? -acc[i][j] : acc[i][j];
      v[j] = (r >= p.n || c == r || c == ex) ? __int_as_float((int)0xff800000) : x;
    }
    float* o = p.out + (long long)p.dst[e0 + e] * kTile;
    *reinterpret_cast<float4*>(o + tx * 4) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 64 + tx * 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// ------------------------------------------------------------------- keys

// stable_topk's int64 keys in one pass: the float's order key in the high
// word, the complement of its index along the last axis (len) in the low
__global__ void keys_kernel(const float* __restrict__ x, long long len, long long total,
                            long long* __restrict__ key) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total; i += step) {
    const unsigned long long hi = (unsigned)order_key(x[i]);
    key[i] = (long long)((hi << 32) | (0xffffffffull - (unsigned long long)(i % len)));
  }
}

cudaError_t set_device(int device) {
  int cur = -1;
  cudaGetDevice(&cur);
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

extern "C" int ngt_rewire_extrema(const void* hnt, long long ntiles, long long band,
                                  long long n, long long d, long long row0, long long row_hi,
                                  long long mode, const void* excl_pos, const void* excl_neg,
                                  void* ext_pos, void* ext_neg, void* sim, int device,
                                  void* stream) {
  if (ntiles <= 0) return 0;
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return (int)err;
  ExtArgs p{static_cast<const float*>(hnt), ntiles, n, (int)d, (int)band, row0, row_hi,
            static_cast<const int*>(excl_pos), static_cast<const int*>(excl_neg),
            static_cast<float*>(ext_pos), static_cast<float*>(ext_neg), static_cast<float*>(sim)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1) err = launch_extrema<1, false>(p, st);
  else if (excl_neg != nullptr) err = launch_extrema<0, true>(p, st);
  else err = launch_extrema<0, false>(p, st);
  return (int)err;
}

extern "C" int ngt_rewire_values(const void* hn, const void* hnt, const void* row,
                                 const void* seg, const void* excl, const void* neg,
                                 const void* dst, const void* starts, const void* lens,
                                 long long nchunks, long long n, long long d, void* out,
                                 int device, void* stream) {
  if (nchunks <= 0) return 0;
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return (int)err;
  ValArgs p{static_cast<const float*>(hn), static_cast<const float*>(hnt),
            static_cast<const int*>(row), static_cast<const int*>(seg),
            static_cast<const int*>(excl), static_cast<const int*>(neg),
            static_cast<const int*>(dst), static_cast<const int*>(starts),
            static_cast<const int*>(lens), n, (int)d, static_cast<float*>(out)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(hn) % 16 == 0;
  if (vec) values_kernel<true><<<(unsigned)nchunks, kThreads, 0, st>>>(p);
  else values_kernel<false><<<(unsigned)nchunks, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int ngt_topk_keys(const void* x, long long len, long long total, void* key,
                             int device, void* stream) {
  if (total <= 0) return 0;
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = std::min((total + kThreads - 1) / kThreads, 132LL * 16);
  keys_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), len, total, static_cast<long long*>(key));
  return (int)cudaGetLastError();
}
