// Hierarchical resampling between the coarse and fine passes, and the
// inverse-CDF op it is built on, for NVIDIA Hopper (sm_90a).
//
// resample_kernel replaces dexnerf_tpu/ops/resample_pallas.py::
// _make_resample_kernel (make_fused_resample): per ray, the CDF of the
// coarse weights[1:-1] + 1e-5 over the coarse midpoints, the inverse
// transform of the fine uniforms u, the stable merge of the coarse and fine
// depths (coarse first on ties) and dists = diff(z) * |d| with a last
// interval of 1e10 * |d|; the same values as hierarchical_z_vals followed
// by ray_dists on the same draws.
// sample_pdf_kernel replaces dexnerf_tpu/ops/sample_pdf_pallas.py::
// _sample_pdf_kernel (sample_pdf_pallas): weights + 1e-5 -> PDF -> CDF,
// rank = count(cdf <= u) (searchsorted right), lerp between the
// bracketing bins, denominators below 1e-5 taken as 1, and u at or past
// cdf[-1] (u == 1.0 on the deterministic grid) on the last bin.
//
// What bounds them on the H100: bytes. resample at 8192 rays x (64 + 64)
// samples reads and writes ~14.7 MB (4.4 us at 3.35 TB/s); sample_pdf at
// 8192 x 64 ~8.3 MB (2.5 us). A ray's work is a few hundred instructions,
// shared-memory loads and shuffles for ~62 rays an SM, so the design counts
// them: every rank is a binary search, and no search step meets a bank
// twice where the queries allow it.
//
// Design: one warp per ray; CTAs of kResampleWarps / kPdfWarps warps, each
// warp taking rays warp, warp + W, ... where W is the warps of one wave
// (occupancy), and loading its next ray's row into registers before it
// works on the current one. The TPU kernel's bf16 selector matmuls stood in
// for a gather and a sort, which the TPU lacks. Here:
// - Rows are loaded with vector loads (8 or 16 bytes) where a row's length
//   allows it, scalar loads otherwise; a lane holds coarse depths, draws
//   and sorted fine depths l*P .. l*P + P - 1, and weights 32 c + l.
// - The CDF is a warp prefix scan in f32 in a fixed order (bitwise
//   repeatable; the order of the first design, so a non-decreasing CDF has
//   the same bits as before). A Hillis-Steele scan is a tree of sums, not
//   a running one, so where a PDF entry is within the scan's roundings of
//   zero an entry can round below the one before it (a near-delta ray of
//   weight 100). A vote finds such a chunk of 32 entries and a suffix
//   minimum over it makes the CDF non-decreasing by construction: it
//   changes no entry of a chunk that was already in order, and the next
//   chunk, whose entries are this chunk's last plus a non-negative sum,
//   cannot fall below it. The search then returns count(cdf <= u) on the
//   CDF it searches. Rows of compositing weights (total <= 8) cannot dip
//   and skip the check (see warp_cdf).
// - Each draw is ranked by a binary search over the CDF in shared memory
//   (padded with +inf to 2^LOG - 1 entries: ceil(log2(M + 2)) loads in
//   place of the first design's M + 1 compares), and its bracketing
//   entries are read directly.
// - The fine depths are sorted in registers by a warp bitonic sort (padded
//   with +inf to 32 P), and the merge places coarse depth m at m +
//   #{fine < z_c[m]} and sorted fine depth k at k + #{coarse <= z_f[k]},
//   each count a binary search, each lane querying entries 32 c + l so that
//   a step's 32 queries span half a row: coarse first on ties, and equal
//   fine depths are the same bits, so the merged row is the first design's
//   permutation and z, dists and sample_pdf equal its outputs bit for bit
//   wherever the CDF was non-decreasing.
// The lerp and the differences use __fmul_rn/__fadd_rn/__fsub_rn (no
// contraction), as the plain PyTorch version computes them.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// warps per CTA: both time below 8 warps a CTA at 8192 and 65536 rays
// (perf_tools/resample_variants.py: warps8, pdf_warps8)
constexpr int kResampleWarps = 4, kPdfWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ constexpr int log2_of(int p) {  // p a power of two
  int g = 0;
  while ((1 << g) < p) ++g;
  return g;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// A load from shared memory by 32-bit address (volatile: it stays behind
// the __syncwarp that publishes what it reads).
__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// A warp's row of shared memory for resample_kernel<CP, FP>, offsets in
// floats, each region a multiple of 4 floats (16 bytes). Each searched
// array holds 2^LOG - 1 entries, +inf past the data, LOG fixed by CP and FP
// (sc <= 32 CP, sf <= 32 FP): #{coarse <= z} has sc + 1 outcomes, 64 CP
// entries; #{cdf <= u} over the M + 1 = sc - 1 entries, 32 CP; #{fine < z},
// 64 FP. At 64 + 64 no search takes a load more than it needs.
template <int CP, int FP>
struct ResampleLayout {
  static constexpr int kLogC = log2_of(64 * CP), kLogCdf = log2_of(32 * CP);
  static constexpr int kLogF = log2_of(64 * FP);
  static constexpr int zs = 0;                      // [64 CP - 1] coarse depths
  static constexpr int cdf = zs + 64 * CP;          // [32 CP - 1]
  static constexpr int bins = cdf + 32 * CP;        // [32 CP - 2] coarse midpoints
  static constexpr int fs = bins + 32 * CP;         // [64 FP - 1] sorted fine depths
  static constexpr int zm = fs + 64 * FP;           // [sc + sf] merged
  static __host__ __device__ int per_warp(int sc, int sf) { return zm + round4(sc + sf); }
};

// The same for sample_pdf_kernel: the CDF (M + 1 entries, searched in order
// over 2^LOG - 1) and the bins.
__host__ __device__ inline int pdf_per_warp(int log_len, int M) {
  return round4((1 << log_len) - 1) + round4(M + 1);
}

// v[j] = j < avail ? p[j] : fill, with vector loads where all P are there
// and p is aligned to them.
template <int P>
__device__ __forceinline__ void load_run(const float* p, int avail, float (&v)[P], float fill) {
  constexpr int V = P >= 4 ? 4 : P;
  if (avail >= P && aligned(p, 4 * V)) {
#pragma unroll
    for (int q = 0; q < P; q += V) {
      if constexpr (V == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p + q);
        v[q] = t.x; v[q + 1] = t.y; v[q + 2] = t.z; v[q + 3] = t.w;
      } else if constexpr (V == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p + q);
        v[q] = t.x; v[q + 1] = t.y;
      } else {
        v[q] = p[q];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = j < avail ? p[j] : fill;
  }
}

// p[j] = v[j] for j < avail, with vector stores where all P fit.
template <int P>
__device__ __forceinline__ void store_run(float* p, int avail, const float (&v)[P]) {
  constexpr int V = P >= 4 ? 4 : P;
  if (avail >= P && aligned(p, 4 * V)) {
#pragma unroll
    for (int q = 0; q < P; q += V) {
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(p + q) = make_float2(v[q], v[q + 1]);
      } else {
        p[q] = v[q];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < avail) p[j] = v[j];
  }
}

// cdf[j + 1] = sum_{i <= j} pdf_i for j < M, pdf = (w + 1e-5) / sum(w + 1e-5),
// from the warp's non-negative weights in registers (w[c] is weight
// 32 c + lane), made non-decreasing where the scan was not (see the note);
// cdf[0] = 0 is init_cdf's. The chunks of 32 are scanned side by side, then
// carried in order. The whole warp, then __syncwarp.
template <int CP>
__device__ __forceinline__ void warp_cdf(const float (&w)[CP], int M, float* cdf) {
  const int lane = threadIdx.x & 31;
  float p[CP];
  float total = 0.f;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    p[c] = __fadd_rn(w[c], 1e-5f);
    if (32 * c + lane < M) total = __fadd_rn(total, p[c]);
  }
  // butterfly: every lane ends with the same bits (each step adds a pair
  // of equal partial sums in either order)
  for (int x = 16; x > 0; x >>= 1) total = __fadd_rn(total, __shfl_xor_sync(kFull, total, x));
  float v[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) v[c] = 32 * c + lane < M ? __fdiv_rn(p[c], total) : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      if (32 * c < M) {
        const float t = __shfl_up_sync(kFull, v[c], o);
        if (lane >= o) v[c] = __fadd_rn(v[c], t);
      }
    }
  }
  float carry = 0.f;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    if (32 * c < M) {
      v[c] = __fadd_rn(v[c], carry);
      carry = __shfl_sync(kFull, v[c], 31);  // lane 31 keeps its own value
    }
  }
  // Neighbours of a chunk share the carry, so an entry falls below the one
  // before it only where their two sums of at most 5 roundings each (in all
  // under 10 u = 6e-7 of the chunk's sum, <= 1) exceed the PDF entry
  // between them. With a total of at most 8 every entry is at least
  // 1e-5 / 8 = 1.25e-6: compositing weights (sum <= 1) skip the check.
  bool dip = false;
  if (total > 8.f) {
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      if (32 * c < M) {
        const float before = __shfl_up_sync(kFull, v[c], 1);
        dip |= lane > 0 && 32 * c + lane < M && v[c] < before;
      }
    }
  }
  if (__any_sync(kFull, dip)) {  // a suffix minimum over each chunk
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      if (32 * c < M) {
        float m = 32 * c + lane < M ? v[c] : inf_f();
        for (int o = 1; o < 32; o <<= 1) {
          const float t = __shfl_down_sync(kFull, m, o);
          if (lane + o < 32) m = fminf(m, t);
        }
        v[c] = m;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const int i = 32 * c + lane + 1;
    if (i <= M) cdf[i] = v[c];
  }
  __syncwarp();
}

// cdf[0] = 0 and +inf past M over 2^LOG - 1 entries (once per warp).
template <int LOG>
__device__ __forceinline__ void init_cdf(int M, float* cdf) {
  const int lane = threadIdx.x & 31;
  for (int i = M + 1 + lane; i < (1 << LOG) - 1; i += 32) cdf[i] = inf_f();
  if (lane == 0) cdf[0] = 0.f;
}

// pos[j] = #{k : a[k] < v[j]} (kStrict) or #{k : a[k] <= v[j]} over a
// non-decreasing a of 2^LOG - 1 entries in shared memory (+inf past the
// data): LOG loads each, at constant offsets from a 32-bit address, the P
// searches interleaved.
template <int LOG, int P, bool kStrict>
__device__ __forceinline__ void search(const float* a, const float (&v)[P], int (&pos)[P]) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(a);
  unsigned at[P];
#pragma unroll
  for (int j = 0; j < P; ++j) at[j] = base - 4u;  // entry -1
#pragma unroll
  for (int step = (1 << LOG) >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float x = lds(at[j] + 4u * step);
      if (kStrict ? x < v[j] : x <= v[j]) at[j] += 4u * step;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) pos[j] = ((int)(at[j] - base) >> 2) + 1;
}

// The inverse transform of each u[j] through cdf [M + 1] (searched over
// 2^LOG - 1 entries) over bins [M + 1].
template <int LOG, int P>
__device__ __forceinline__ void inverse_cdf(const float* cdf, const float* bins, int M,
                                            const float (&u)[P], float (&out)[P]) {
  int rank[P];
  search<LOG, P, false>(cdf, u, rank);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int r = min(rank[j], M + 1);  // +inf past the data counts only for u = +inf
    const int below = max(r - 1, 0), above = min(r, M);
    const float c0 = cdf[below], b0 = bins[below];
    float denom = __fsub_rn(cdf[above], c0);
    if (denom < 1e-5f) denom = 1.f;
    const float t = __fdiv_rn(__fsub_rn(u[j], c0), denom);
    out[j] = __fadd_rn(b0, __fmul_rn(t, __fsub_rn(bins[above], b0)));
  }
}

// Ascending sort of the warp's 32 P values, lane l holding entries
// l*P .. l*P + P - 1: the bitonic network in the form whose comparators all
// put the smaller value first (each merge opens by pairing i with
// i ^ (k - 1)), partners within a lane for strides below P and across
// lanes by shuffle above, where one bit of the lane says which of the two
// keeps the smaller. Each exchange is a min or a max: a permutation of any
// input without NaN.
template <int P>
__device__ __forceinline__ void warp_sort(float (&v)[P]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32 * P; k <<= 1) {
    if (k <= P) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int pj = j ^ (k - 1);
        if (pj > j) {
          const float lo = fminf(v[j], v[pj]), hi = fmaxf(v[j], v[pj]);
          v[j] = lo;
          v[pj] = hi;
        }
      }
    } else {
      const bool keep_lo = (lane & (k / (2 * P))) == 0;
      float o[P];
#pragma unroll
      for (int j = 0; j < P; ++j) o[j] = __shfl_xor_sync(kFull, v[P - 1 - j], k / P - 1);
#pragma unroll
      for (int j = 0; j < P; ++j) v[j] = keep_lo ? fminf(v[j], o[j]) : fmaxf(v[j], o[j]);
    }
#pragma unroll
    for (int s = k >> 2; s > 0; s >>= 1) {
      if (s < P) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int pj = j ^ s;
          if (pj > j) {
            const float lo = fminf(v[j], v[pj]), hi = fmaxf(v[j], v[pj]);
            v[j] = lo;
            v[pj] = hi;
          }
        }
      } else {
        const bool keep_lo = (lane & (s / P)) == 0;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float o = __shfl_xor_sync(kFull, v[j], s / P);
          v[j] = keep_lo ? fminf(v[j], o) : fmaxf(v[j], o);
        }
      }
    }
  }
}

// z_out / d_out of one ray from its merged row zm [s] (s <= MAXS) in
// shared memory.
template <int MAXS>
__device__ __forceinline__ void write_row(const float* zm, int s, float norm, float* zo,
                                          float* dout) {
  const int lane = threadIdx.x & 31;
  if ((s & 3) == 0 && aligned(zo, 16) && aligned(dout, 16)) {
    const int quads = s >> 2;
#pragma unroll
    for (int base = 0; base < MAXS / 4; base += 32) {  // the same trips on every lane
      if (base >= quads) break;
      const int q = base + lane, i = 4 * q;
      const float4 a = q < quads ? reinterpret_cast<const float4*>(zm)[q]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      float next = __shfl_down_sync(kFull, a.x, 1);
      if (lane == 31 && i + 4 < s) next = zm[i + 4];
      if (q < quads) {
        float4 d;
        d.x = __fmul_rn(__fsub_rn(a.y, a.x), norm);
        d.y = __fmul_rn(__fsub_rn(a.z, a.y), norm);
        d.z = __fmul_rn(__fsub_rn(a.w, a.z), norm);
        d.w = __fmul_rn(i + 4 < s ? __fsub_rn(next, a.w) : 1e10f, norm);
        reinterpret_cast<float4*>(zo)[q] = a;
        reinterpret_cast<float4*>(dout)[q] = d;
      }
    }
  } else {
#pragma unroll
    for (int base = 0; base < MAXS; base += 32) {
      const int i = base + lane;
      if (i < s) {
        const float zi = zm[i];
        zo[i] = zi;
        dout[i] = __fmul_rn(i + 1 < s ? __fsub_rn(zm[i + 1], zi) : 1e10f, norm);
      }
    }
  }
}

// One ray's inputs in a lane's registers: coarse depths lane*CP + c (+inf
// past sc), weights[1:-1] 32 c + lane (the scan's order), draws
// lane*FP + j, |d|.
template <int CP, int FP>
struct RayRow {
  float z[CP], w[CP], u[FP], norm;

  __device__ __forceinline__ void load(const float* __restrict__ zc, const float* __restrict__ wt,
                                       const float* __restrict__ ud,
                                       const float* __restrict__ dn, long long ray, int sc,
                                       int sf) {
    const int lane = threadIdx.x & 31, M = sc - 2;
    load_run<CP>(zc + ray * sc + lane * CP, sc - lane * CP, z, inf_f());
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      const int i = 32 * c + lane;
      w[c] = i < M ? wt[ray * sc + 1 + i] : 0.f;
    }
    load_run<FP>(ud + ray * sf + lane * FP, sf - lane * FP, u, 0.f);
    norm = dn[ray];
  }
};

// CP: coarse depths per lane (32 CP >= sc); FP: fine depths per lane
// (32 FP >= sf); both powers of two. Each warp loads its next ray's row
// before it works on the current one.
template <int CP, int FP>
__global__ void __launch_bounds__(32 * kResampleWarps)
resample_kernel(const float* __restrict__ zc, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dn,
                float* __restrict__ z_out, float* __restrict__ d_out, int n_rays, int sc,
                int sf) {
  extern __shared__ __align__(16) float smem[];
  using L = ResampleLayout<CP, FP>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = sc - 2, s = sc + sf;
  float* row = smem + warp * L::per_warp(sc, sf);
  float* zs = row + L::zs;
  float* cdf = row + L::cdf;
  float* bins = row + L::bins;
  float* fs = row + L::fs;
  float* zm = row + L::zm;
  for (int i = 32 * CP + lane; i < 64 * CP - 1; i += 32) zs[i] = inf_f();
  for (int i = 32 * FP + lane; i < 64 * FP - 1; i += 32) fs[i] = inf_f();
  init_cdf<L::kLogCdf>(M, cdf);
  const long long stride = (long long)gridDim.x * kResampleWarps;
  long long ray = (long long)blockIdx.x * kResampleWarps + warp;
  RayRow<CP, FP> next;
  if (ray < n_rays) next.load(zc, w, u, dn, ray, sc, sf);
  for (; ray < n_rays; ray += stride) {
    const RayRow<CP, FP> r = next;
    if (ray + stride < n_rays) next.load(zc, w, u, dn, ray + stride, sc, sf);
    __syncwarp();  // the previous ray's reads are done
    store_run<CP>(zs + lane * CP, CP, r.z);
    // midpoints lane*CP + c: the next depth is this lane's or the next lane's first
    const float after = __shfl_down_sync(kFull, r.z[0], 1);
    float mid[CP];
#pragma unroll
    for (int c = 0; c < CP; ++c)
      mid[c] = __fmul_rn(0.5f, __fadd_rn(c + 1 < CP ? r.z[c + 1] : after, r.z[c]));
    store_run<CP>(bins + lane * CP, M + 1 - lane * CP, mid);
    warp_cdf<CP>(r.w, M, cdf);  // its __syncwarp publishes zs and bins too
    float zf[FP];
    inverse_cdf<L::kLogCdf, FP>(cdf, bins, M, r.u, zf);
#pragma unroll
    for (int j = 0; j < FP; ++j)
      if (lane * FP + j >= sf) zf[j] = inf_f();
    warp_sort<FP>(zf);
    store_run<FP>(fs + lane * FP, FP, zf);
    __syncwarp();
    // the merge queries coarse 32 c + lane and sorted fine 32 j + lane, so
    // that one step's 32 searches span half a row and meet no bank twice
    float qc[CP], qf[FP];
#pragma unroll
    for (int c = 0; c < CP; ++c) qc[c] = zs[32 * c + lane];  // +inf past sc
#pragma unroll
    for (int j = 0; j < FP; ++j) qf[j] = fs[32 * j + lane];  // +inf past sf
    int pc[CP], pf[FP];
    search<L::kLogF, CP, true>(fs, qc, pc);
    search<L::kLogC, FP, false>(zs, qf, pf);
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      const int m = 32 * c + lane;
      if (m < sc) zm[m + pc[c]] = qc[c];
    }
#pragma unroll
    for (int j = 0; j < FP; ++j) {
      const int k = 32 * j + lane;
      if (k < sf) zm[k + min(pf[j], sc)] = qf[j];
    }
    __syncwarp();
    write_row<32 * (CP + FP)>(zm, s, r.norm, z_out + ray * s, d_out + ray * s);
  }
}

// One ray's inputs for sample_pdf_kernel in a lane's registers: bins and
// weights 32 c + lane, the first trip's draws lane*V + j.
template <int CP, int V>
struct PdfRow {
  float b[CP + 1], w[CP], u[V];

  __device__ __forceinline__ void load(const float* __restrict__ bins,
                                       const float* __restrict__ wt,
                                       const float* __restrict__ ud, long long ray, int M,
                                       int n) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int c = 0; c <= CP; ++c) {
      const int i = 32 * c + lane;
      b[c] = i <= M ? bins[ray * (M + 1) + i] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      const int i = 32 * c + lane;
      w[c] = i < M ? wt[ray * M + i] : 0.f;
    }
    load_run<V>(ud + ray * n + lane * V, n - lane * V, u, 0.f);
  }
};

// CP: weights per lane (32 CP >= M); LOG: the CDF searched over 2^LOG - 1
// entries (2^LOG >= M + 2); V: draws per lane per trip. Each warp loads its
// next ray's row before it works on the current one.
template <int CP, int LOG, int V>
__global__ void __launch_bounds__(32 * kPdfWarps)
sample_pdf_kernel(const float* __restrict__ bins, const float* __restrict__ weights,
                  const float* __restrict__ u, float* __restrict__ out, int n_rays, int M,
                  int n) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cdf = smem + warp * pdf_per_warp(LOG, M);  // [2^LOG - 1], +inf past M
  float* bs = cdf + round4((1 << LOG) - 1);         // [M + 1]
  init_cdf<LOG>(M, cdf);
  const long long stride = (long long)gridDim.x * kPdfWarps;
  long long ray = (long long)blockIdx.x * kPdfWarps + warp;
  PdfRow<CP, V> next;
  if (ray < n_rays) next.load(bins, weights, u, ray, M, n);
  for (; ray < n_rays; ray += stride) {
    const PdfRow<CP, V> r = next;
    if (ray + stride < n_rays) next.load(bins, weights, u, ray + stride, M, n);
    __syncwarp();  // the previous ray's reads are done
#pragma unroll
    for (int c = 0; c <= CP; ++c)
      if (32 * c + lane <= M) bs[32 * c + lane] = r.b[c];
    warp_cdf<CP>(r.w, M, cdf);  // its __syncwarp publishes bs too
    const float* ur = u + ray * n;
    float* orow = out + ray * n;
    float res[V];
    inverse_cdf<LOG, V>(cdf, bs, M, r.u, res);
    store_run<V>(orow + lane * V, n - lane * V, res);
    for (int j = 32 * V + lane * V; j < n; j += 32 * V) {  // rows of more than 32 V draws
      float uv[V];
      load_run<V>(ur + j, n - j, uv, 0.f);
      inverse_cdf<LOG, V>(cdf, bs, M, uv, res);
      store_run<V>(orow + j, n - j, res);
    }
  }
}

// CTAs of `warps` warps for n_rays rays, each warp taking rays warp,
// warp + W, ...: W the warps of one wave of resident CTAs, cut to as few
// rays a warp as that allows so that no SM takes a second, partial round.
// Sets the kernel's shared-memory limit first.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int warps, size_t smem, int n_rays, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long wave = (long long)per_sm * sms * warps;
  const long long rays_per_warp = (n_rays + wave - 1) / wave;
  const long long needed = (n_rays + rays_per_warp - 1) / rays_per_warp;
  *grid = (int)((needed + warps - 1) / warps);
  return cudaSuccess;
}

template <int CP, int FP>
cudaError_t launch_resample(const float* zc, const float* w, const float* u, const float* dn,
                            float* z_out, float* d_out, int n_rays, int sc, int sf,
                            cudaStream_t stream) {
  const size_t smem = sizeof(float) * kResampleWarps * ResampleLayout<CP, FP>::per_warp(sc, sf);
  int grid = 0;
  cudaError_t err = prepare(resample_kernel<CP, FP>, kResampleWarps, smem, n_rays, &grid);
  if (err != cudaSuccess) return err;
  resample_kernel<CP, FP><<<grid, 32 * kResampleWarps, smem, stream>>>(
      zc, w, u, dn, z_out, d_out, n_rays, sc, sf);
  return cudaGetLastError();
}

template <int CP>
cudaError_t resample_fine(int fp, const float* zc, const float* w, const float* u,
                          const float* dn, float* z_out, float* d_out, int n_rays, int sc,
                          int sf, cudaStream_t stream) {
  switch (fp) {
    case 1: return launch_resample<CP, 1>(zc, w, u, dn, z_out, d_out, n_rays, sc, sf, stream);
    case 2: return launch_resample<CP, 2>(zc, w, u, dn, z_out, d_out, n_rays, sc, sf, stream);
    case 4: return launch_resample<CP, 4>(zc, w, u, dn, z_out, d_out, n_rays, sc, sf, stream);
    case 8: return launch_resample<CP, 8>(zc, w, u, dn, z_out, d_out, n_rays, sc, sf, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int CP, int LOG, int V>
cudaError_t launch_sample_pdf(const float* bins, const float* weights, const float* u,
                              float* out, int n_rays, int M, int n, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kPdfWarps * pdf_per_warp(LOG, M);
  int grid = 0;
  cudaError_t err = prepare(sample_pdf_kernel<CP, LOG, V>, kPdfWarps, smem, n_rays, &grid);
  if (err != cudaSuccess) return err;
  sample_pdf_kernel<CP, LOG, V><<<grid, 32 * kPdfWarps, smem, stream>>>(
      bins, weights, u, out, n_rays, M, n);
  return cudaGetLastError();
}

// 2^LOG = 32 CP where M + 2 fits (63 bins: 6 loads a draw), else 64 CP.
template <int CP>
cudaError_t sample_pdf_draws(int per_lane, const float* bins, const float* weights,
                             const float* u, float* out, int n_rays, int M, int n,
                             cudaStream_t stream) {
  constexpr int kLog = log2_of(32 * CP);
  if (M + 2 <= 32 * CP) {
    if (per_lane == 4)
      return launch_sample_pdf<CP, kLog, 4>(bins, weights, u, out, n_rays, M, n, stream);
    if (per_lane == 2)
      return launch_sample_pdf<CP, kLog, 2>(bins, weights, u, out, n_rays, M, n, stream);
    return launch_sample_pdf<CP, kLog, 1>(bins, weights, u, out, n_rays, M, n, stream);
  }
  if (per_lane == 4)
    return launch_sample_pdf<CP, kLog + 1, 4>(bins, weights, u, out, n_rays, M, n, stream);
  if (per_lane == 2)
    return launch_sample_pdf<CP, kLog + 1, 2>(bins, weights, u, out, n_rays, M, n, stream);
  return launch_sample_pdf<CP, kLog + 1, 1>(bins, weights, u, out, n_rays, M, n, stream);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`. Arrays are contiguous float32 on the card.

// out [n_rays, n] from bins [n_rays, M + 1], weights [n_rays, M], u [n_rays, n].
int dexnerf_sample_pdf(const float* bins, const float* weights, const float* u, float* out,
                       int n_rays, int M, int n, void* stream) {
  if (M < 1 || M + 1 > 512 || n < 1 || n_rays < 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  // 2 or 4 draws a lane (8- or 16-byte accesses) where the row has them
  const int per_lane = (n % 4 == 0 && n >= 128) ? 4 : (n % 2 == 0 && n >= 64) ? 2 : 1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (pow2_at_least((M + 31) / 32)) {
    case 1: return (int)sample_pdf_draws<1>(per_lane, bins, weights, u, out, n_rays, M, n, s);
    case 2: return (int)sample_pdf_draws<2>(per_lane, bins, weights, u, out, n_rays, M, n, s);
    case 4: return (int)sample_pdf_draws<4>(per_lane, bins, weights, u, out, n_rays, M, n, s);
    case 8: return (int)sample_pdf_draws<8>(per_lane, bins, weights, u, out, n_rays, M, n, s);
    case 16: return (int)sample_pdf_draws<16>(per_lane, bins, weights, u, out, n_rays, M, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// z_out, d_out [n_rays, sc + sf] from z_coarse, weights [n_rays, sc]
// (z_coarse ascending per ray), u [n_rays, sf] and dir_norms [n_rays].
int dexnerf_resample(const float* zc, const float* w, const float* u, const float* dn,
                     float* z_out, float* d_out, int n_rays, int sc, int sf, void* stream) {
  if (sc < 3 || sc > 256 || sf < 1 || sf > 256 || n_rays < 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int fp = pow2_at_least((sf + 31) / 32);
  auto s = static_cast<cudaStream_t>(stream);
  switch (pow2_at_least((sc + 31) / 32)) {
    case 1: return (int)resample_fine<1>(fp, zc, w, u, dn, z_out, d_out, n_rays, sc, sf, s);
    case 2: return (int)resample_fine<2>(fp, zc, w, u, dn, z_out, d_out, n_rays, sc, sf, s);
    case 4: return (int)resample_fine<4>(fp, zc, w, u, dn, z_out, d_out, n_rays, sc, sf, s);
    case 8: return (int)resample_fine<8>(fp, zc, w, u, dn, z_out, d_out, n_rays, sc, sf, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
