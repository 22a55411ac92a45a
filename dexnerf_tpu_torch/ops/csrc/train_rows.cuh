// The f32 training scratch's layout, filled by kernel 4's f32 pass and
// kernel 3's f32 field backward (fused_train_loss.cu); dw_tf32.cu reads the
// scratch through tensor maps built from it (ops/_weight_grads.py,
// dexnerf_train_rows).
#pragma once

namespace {

// Scratch rows, feature-major: row = feature, one column per sample (ray
// r's sample s at column r s_pad + s of its chunk). act: e (dx rows),
// a_0..a_nt (H each: layer1's output, then the trunk's), feat (H), y
// (H/2). dlt: delta_0..delta_nt (H each), feat (H), sigma (1), y (H/2),
// rgb (3). Offsets are in floats for k columns; ops/_weight_grads.py reads
// them (k = 1) through dexnerf_train_rows.
struct Rows {
  long long k;
  int dx, H, nt;
  __host__ __device__ long long e() const { return 0; }
  __host__ __device__ long long a(int i) const { return (long long)(dx + i * H) * k; }
  __host__ __device__ long long feat() const { return (long long)(dx + (nt + 1) * H) * k; }
  __host__ __device__ long long y() const { return feat() + (long long)H * k; }
  __host__ __device__ long long act_end() const { return y() + (long long)(H / 2) * k; }
  __host__ __device__ long long d(int i) const { return (long long)i * H * k; }
  __host__ __device__ long long dfeat() const { return (long long)(nt + 1) * H * k; }
  __host__ __device__ long long dsig() const { return (long long)(nt + 2) * H * k; }
  __host__ __device__ long long dy() const { return dsig() + k; }
  __host__ __device__ long long drgb(int c) const { return dy() + (long long)(H / 2 + c) * k; }
  __host__ __device__ long long dlt_end() const { return drgb(3); }
};

}  // namespace
