// Random row gather of the ray cache's train shards (apps/cache.py), on the
// host. The generator and the distribution are those of the JAX package's
// host library: std::mt19937_64 seeded with the shard's number and
// std::uniform_int_distribution<int64_t> over the rows, drawn with
// replacement, so that both packages cache the same rows of an image.
//
// Built with the host compiler at first use (ops/host_rows.py), loaded
// through ctypes.

#include <cstdint>
#include <cstring>
#include <random>

extern "C" {

// rows: [n, width] float32; out: [batch, width].
void dexnerf_gather_random_rows(const float* rows, int64_t n, int32_t width,
                                int64_t seed, int32_t batch, float* out) {
  std::mt19937_64 rng(static_cast<uint64_t>(seed));
  std::uniform_int_distribution<int64_t> dist(0, n - 1);
  for (int32_t i = 0; i < batch; ++i) {
    const int64_t idx = dist(rng);
    std::memcpy(out + static_cast<int64_t>(i) * width, rows + idx * width,
                static_cast<size_t>(width) * sizeof(float));
  }
}

}  // extern "C"
