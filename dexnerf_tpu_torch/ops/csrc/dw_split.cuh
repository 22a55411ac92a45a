// The work split and slot reduction shared by the two weight-gradient
// kernels (fused_train_loss_bf16.cu's train_dw_bf16_kernel and dw_tf32.cu's
// dw_tf32_kernel), and the run-time lookup of the TMA tensor-map encoder
// both use. ops/fused_train_loss.py::dw_spans mirrors the split.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>

namespace {

constexpr int kDwMaxUnits = 36;  // num_trunk + 4 for 32 layers

// Work of one dW launch: the units laid end to end, unit u covering the
// positions [n_st pre_u, n_st (pre_u + cost_u)) of T = n_st total_cost
// (stage j of u at n_st pre_u + j cost_u); CTA b owns [b T / G, (b + 1) T / G),
// so every CTA reads the same bytes. The CTA owning position p:
__host__ __device__ inline int dw_owner(long long p, long long T, int G) {
  return (int)(((p + 1) * G - 1) / T);
}

// CTA b's part of unit u: its slot (piece) among the CTAs owning a part of
// u, in order, and its stages [j0, j1) (possibly none: the slot is written
// all the same). False if b owns no part of u.
__host__ __device__ inline bool dw_span(int n_st, int pre, int cost, int total, int G, int b,
                                        int* piece, int* j0, int* j1) {
  const long long T = (long long)n_st * total, S = (long long)n_st * pre;
  const long long E = S + (long long)n_st * cost;
  const int first = dw_owner(S, T, G);
  if (b < first || b > dw_owner(E - 1, T, G)) return false;
  const long long lo = (long long)b * T / G, hi = (long long)(b + 1) * T / G;
  const long long a0 = lo > S ? (lo - S + cost - 1) / cost : 0;
  const long long a1 = hi > S ? (hi - S + cost - 1) / cost : 0;
  *piece = b - first;
  *j0 = (int)(a0 < n_st ? a0 : n_st);
  *j1 = (int)(a1 < n_st ? a1 : n_st);
  return true;
}

// The slots unit u has in a launch over n_st stages.
__host__ __device__ inline int dw_pieces(int n_st, int pre, int cost, int total, int G) {
  const long long T = (long long)n_st * total, S = (long long)n_st * pre;
  return dw_owner(S + (long long)n_st * cost - 1, T, G) - dw_owner(S, T, G) + 1;
}

// A plan's unit table for the reduction (passed by value).
struct DwSpans {
  int n_units, total_cost, grid, max_pieces;
  int pre[kDwMaxUnits], cost[kDwMaxUnits];
};

// The table of a plan of n_units units, unit u of cost cost_of(u).
template <class CostOf>
inline DwSpans dw_spans_of(int n_units, int total_cost, int grid, int max_pieces,
                           CostOf cost_of) {
  DwSpans sp;
  sp.n_units = n_units;
  sp.total_cost = total_cost;
  sp.grid = grid;
  sp.max_pieces = max_pieces;
  for (int u = 0, pre = 0; u < kDwMaxUnits; ++u) {
    sp.pre[u] = pre;
    sp.cost[u] = u < n_units ? cost_of(u) : 0;
    pre += sp.cost[u];
  }
  return sp;
}

// A plan launched in parts (each its own launch on its own slots): each
// part's unit table and slots.
constexpr int kDwMaxParts = 8;
struct DwParts {
  DwSpans sp[kDwMaxParts];
  const float* partial[kDwMaxParts];
};

// Entry i of the gradient (thread i of a reduce kernel): the sum over the
// dW slots of its unit (map[i] = -1 - (part kDwMaxUnits + unit)), in chunk
// order and slot order, or over the n_aux_parts rows of aux at entry
// map[i], in row order.
__device__ __forceinline__ void reduce_slots(const DwParts& parts, int n_chunks, int n_st_full,
                                             int n_st_last, long long n_params, const float* aux,
                                             int n_aux_parts, int n_aux, const int* map,
                                             float* grad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  const int j = map[i];
  float s = 0.f;
  if (j < 0) {
    const int part = (-1 - j) / kDwMaxUnits, u = (-1 - j) % kDwMaxUnits;
    const DwSpans& sp = parts.sp[part];
    for (int c = 0; c < n_chunks; ++c) {
      const int n_st = c + 1 < n_chunks ? n_st_full : n_st_last;
      const int pieces = dw_pieces(n_st, sp.pre[u], sp.cost[u], sp.total_cost, sp.grid);
      const float* q = parts.partial[part] + (long long)c * sp.max_pieces * n_params + i;
      for (int k = 0; k < pieces; ++k) s += q[k * n_params];
    }
  } else {
    for (int q = 0; q < n_aux_parts; ++q) s += aux[(size_t)q * n_aux + j];
  }
  grad[i] = s;
}

// cuTensorMapEncodeTiled, looked up once through the runtime (no -lcuda)
typedef CUresult (*PFN_encodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver call needs a context current on the calling thread. A thread
// whose first CUDA work this is has none (autograd's device thread running
// kernel 3's backward, when the scratch comes from the allocator's cache:
// CUDA_ERROR_INVALID_CONTEXT), so the thread's device is set first, which
// makes its primary context current.
inline cudaError_t tensor_map_encoder(PFN_encodeTiled* out) {
  int dev = 0;
  cudaError_t cur = cudaGetDevice(&dev);
  if (cur == cudaSuccess) cur = cudaSetDevice(dev);
  if (cur != cudaSuccess) return cur;
  static PFN_encodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_encodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

}  // namespace
