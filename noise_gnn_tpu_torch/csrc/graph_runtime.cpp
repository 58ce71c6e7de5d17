// Host graph runtime of the PyTorch/CUDA port (noise_gnn_tpu_torch).
//
// The port's own copy of the JAX package's csrc/graph_runtime.cpp, with the
// same code, so that both packages build the same CSR bit for bit: the
// dst-major CSR by a counting sort (stable in src order within a row), the
// per-edge row array of a CSR, a host fanout sampler with the device
// sampler's policy, an FNV-1a checksum and balanced label propagation.
//
// Exposed via a plain C ABI consumed from Python with ctypes
// (noise_gnn_tpu_torch/native/__init__.py), which builds it with g++ at
// first use into build/kernels/ (noise_gnn_tpu_torch/ops/cuda_build.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 2 : static_cast<int>(n);
}

template <typename F>
void parallel_for(int64_t n, F&& fn) {
  int nt = std::min<int64_t>(hardware_threads(), std::max<int64_t>(n / 65536, 1));
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(lo + per, n);
    if (lo >= hi) break;
    ts.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// COO -> dst-major CSR via counting sort (stable in src order within a row).
// indptr: [n+1] int64 out; indices: [e] int32 out (source node per slot).
void ngt_coo_to_csr(const int32_t* src, const int32_t* dst, int64_t e,
                    int32_t n, int64_t* indptr, int32_t* indices) {
  std::vector<std::atomic<int64_t>> counts(n);
  for (auto& c : counts) c.store(0, std::memory_order_relaxed);
  parallel_for(e, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      counts[dst[i]].fetch_add(1, std::memory_order_relaxed);
  });
  indptr[0] = 0;
  for (int32_t i = 0; i < n; ++i)
    indptr[i + 1] = indptr[i] + counts[i].load(std::memory_order_relaxed);
  std::vector<int64_t> cursor(indptr, indptr + n);
  for (int64_t i = 0; i < e; ++i) indices[cursor[dst[i]]++] = src[i];
}

// Expand a dst-major CSR's indptr into its per-edge dst row array:
// dst[k] = r for indptr[r] <= k < indptr[r+1]. Parallel over rows.
void ngt_expand_rows(const int64_t* indptr, int32_t n, int32_t* dst) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r)
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
        dst[k] = static_cast<int32_t>(r);
  });
}

// Host fanout sampling of one hop: for each frontier node, `fanout` slots.
// deg <= fanout: offsets 0..deg-1 (exact, no replacement), rest masked;
// deg  > fanout: fanout i.i.d. uniform picks — same policy as the on-device
// sampler (ops/sampler.py) so host and device agree statistically.
// children/mask: [n_frontier * fanout] out.
void ngt_sample_hop(const int64_t* indptr, const int32_t* indices,
                    const int32_t* frontier, const uint8_t* frontier_mask,
                    int64_t n_frontier, int32_t fanout, uint64_t seed,
                    int32_t* children, uint8_t* mask) {
  parallel_for(n_frontier, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::mt19937_64 rng(seed * 0x9e3779b97f4a7c15ULL + i);
      int32_t node = frontier[i];
      int64_t s = indptr[node], deg = indptr[node + 1] - s;
      bool valid = frontier_mask == nullptr || frontier_mask[i];
      for (int32_t j = 0; j < fanout; ++j) {
        int64_t off;
        bool ok = valid && deg > 0;
        if (deg <= fanout) {
          off = j;
          ok = ok && j < deg;
        } else {
          off = static_cast<int64_t>(rng() % static_cast<uint64_t>(deg));
        }
        children[i * fanout + j] = ok ? indices[s + off] : 0;
        mask[i * fanout + j] = ok ? 1 : 0;
      }
    }
  });
}

// Balanced label propagation for shard locality (the JAX package's
// parallel/halo.py locality_order runs it): `iters` rounds where every node adopts
// the shard most of its (in+out) neighbors live on, votes scaled by each
// shard's remaining capacity (target/size) and the current shard's vote
// boosted by `sticky` to damp oscillation. part: [n] int32 in/out.
void ngt_label_prop(const int32_t* src, const int32_t* dst, int64_t e,
                    int32_t n, int32_t d, int32_t iters, float sticky,
                    int32_t* part) {
  std::vector<std::atomic<int32_t>> counts(static_cast<size_t>(n) * d);
  std::vector<int64_t> sizes(d);
  for (int32_t it = 0; it < iters; ++it) {
    parallel_for(static_cast<int64_t>(n) * d, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i)
        counts[i].store(0, std::memory_order_relaxed);
    });
    parallel_for(e, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        counts[static_cast<size_t>(dst[i]) * d + part[src[i]]].fetch_add(
            1, std::memory_order_relaxed);
        counts[static_cast<size_t>(src[i]) * d + part[dst[i]]].fetch_add(
            1, std::memory_order_relaxed);
      }
    });
    std::fill(sizes.begin(), sizes.end(), 0);
    for (int32_t i = 0; i < n; ++i) ++sizes[part[i]];
    std::vector<float> balance(d);
    double target = static_cast<double>(n) / d;
    for (int32_t k = 0; k < d; ++k)
      balance[k] = static_cast<float>(target / std::max<int64_t>(sizes[k], 1));
    parallel_for(n, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        int32_t cur = part[i], best = 0;
        float best_score = -1.0f;
        for (int32_t k = 0; k < d; ++k) {
          float s = static_cast<float>(
                        counts[static_cast<size_t>(i) * d + k].load(
                            std::memory_order_relaxed)) *
                    balance[k];
          if (k == cur) s *= sticky;
          if (s > best_score) {
            best_score = s;
            best = k;
          }
        }
        part[i] = best;
      }
    });
  }
}

// FNV-1a checksum over an int32 buffer (fast integrity probe for packed
// layouts shipped across processes).
uint64_t ngt_hash_i32(const int32_t* data, int64_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (int64_t i = 0; i < n; ++i) {
    h ^= static_cast<uint32_t>(data[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

}  // extern "C"
