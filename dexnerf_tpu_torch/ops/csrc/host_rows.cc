// Host-side ops of the data path, on the host CPU.
//
// - dexnerf_gather_random_rows: the random row gather of the ray cache's
//   train shards (apps/cache.py). The generator and the distribution are
//   those of the JAX package's host library: std::mt19937_64 seeded with the
//   shard's number and std::uniform_int_distribution<int64_t> over the rows,
//   drawn with replacement, so that both packages cache the same rows of an
//   image.
// - dexnerf_gather_rows: the rows of given indices, of any row size in
//   bytes (the host-streamed store's batches, data/host_store.py: f32 ray
//   rows, u8 rgb, f32 depth), so that the gather runs without the GIL.
// - dexnerf_pack_rays: [n, 12] store rows from origins, directions and rgb,
//   the viewdirs as d * (1 / sqrt(fma(dz, dz, fma(dx, dx, dy * dy)))), the
//   contraction the JAX package's -march=native build makes.
// - dexnerf_searchsorted_right, dexnerf_sample_pdf_interp: the two halves of
//   the host-side sample_pdf (the lerp an explicit fused multiply-add, as
//   that build contracts it).
//
// Built with the host compiler at first use (ops/host_rows.py), loaded
// through ctypes (whose calls release the GIL).

#include <cmath>
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

// src: [n rows of row_bytes]; idx: [batch] row numbers; out: [batch rows].
void dexnerf_gather_rows(const uint8_t* src, int64_t row_bytes, const int64_t* idx,
                         int64_t batch, uint8_t* out) {
  for (int64_t i = 0; i < batch; ++i) {
    std::memcpy(out + i * row_bytes, src + idx[i] * row_bytes,
                static_cast<size_t>(row_bytes));
  }
}

// ro, rd, rgb: [n, 3]; out: [n, 12] (origin, direction, viewdir, rgb).
void dexnerf_pack_rays(const float* ro, const float* rd, const float* rgb, int64_t n,
                       float* out) {
  for (int64_t i = 0; i < n; ++i) {
    float* row = out + i * 12;
    std::memcpy(row, ro + i * 3, 3 * sizeof(float));
    std::memcpy(row + 3, rd + i * 3, 3 * sizeof(float));
    const float dx = rd[i * 3], dy = rd[i * 3 + 1], dz = rd[i * 3 + 2];
    const float inv = 1.0f / std::sqrt(std::fma(dz, dz, std::fma(dx, dx, dy * dy)));
    row[6] = dx * inv;
    row[7] = dy * inv;
    row[8] = dz * inv;
    std::memcpy(row + 9, rgb + i * 3, 3 * sizeof(float));
  }
}

// For each row b and query j: out[b, j] = #{entries of cdf[b, :] <= u[b, j]}.
// cdf: [B, M] ascending per row; u: [B, N]; out: [B, N].
void dexnerf_searchsorted_right(const float* cdf, const float* u, int32_t B, int32_t M,
                                int32_t N, int32_t* out) {
  for (int32_t b = 0; b < B; ++b) {
    const float* row = cdf + static_cast<int64_t>(b) * M;
    const float* q = u + static_cast<int64_t>(b) * N;
    int32_t* o = out + static_cast<int64_t>(b) * N;
    for (int32_t j = 0; j < N; ++j) {
      int32_t lo = 0, hi = M;
      const float v = q[j];
      while (lo < hi) {
        const int32_t mid = (lo + hi) >> 1;
        if (row[mid] <= v) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      o[j] = lo;
    }
  }
}

// The inverse-CDF lerp of sample_pdf given the searchsorted indices: below
// and above clamped to the row, a denominator under 1e-5 taken as 1
// (reference nerf_helpers.py:291-303), the lerp one fused multiply-add as the
// JAX package's -march=native build contracts it. cdf, bins: [B, M]; u,
// inds, out: [B, N].
void dexnerf_sample_pdf_interp(const float* cdf, const float* bins, const float* u,
                               const int32_t* inds, int32_t B, int32_t M, int32_t N,
                               float* out) {
  for (int32_t b = 0; b < B; ++b) {
    const float* c = cdf + static_cast<int64_t>(b) * M;
    const float* z = bins + static_cast<int64_t>(b) * M;
    const float* q = u + static_cast<int64_t>(b) * N;
    const int32_t* id = inds + static_cast<int64_t>(b) * N;
    float* o = out + static_cast<int64_t>(b) * N;
    for (int32_t j = 0; j < N; ++j) {
      int32_t below = id[j] - 1;
      if (below < 0) below = 0;
      int32_t above = id[j];
      if (above > M - 1) above = M - 1;
      const float c0 = c[below], c1 = c[above];
      float denom = c1 - c0;
      if (denom < 1e-5f) denom = 1.0f;
      const float t = (q[j] - c0) / denom;
      o[j] = std::fma(t, z[above] - z[below], z[below]);
    }
  }
}

}  // extern "C"
