// Native host-side voxelizer for the data-loading pipeline.
//
// The reference delegates quantization to MinkowskiEngine's C++ extension
// (`ME.utils.sparse_quantize`, called per scan in every __getitem__ —
// utils/dataset_remission_mean_teacher.py:965-1002). Here the host hot loop is
// a single C++ pass: pack voxel keys, radix-ish sort (std::sort on 64-bit
// keys), first-occurrence unique + inverse map. Exposed through a C ABI for
// ctypes.
//
// Built at first use by gcdlss_tpu_torch/data/native_voxelizer.py with the
// host compiler (-O3 -fPIC -std=c++17 -shared) into build/voxelizer/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Quantize points [n,3] float32 at voxel_size.
// Outputs (caller-allocated):
//   coords_out   [n*3] int32  — unique voxel coords, sorted by packed key
//   unique_out   [n]   int64  — first-occurrence point index per voxel
//   inverse_out  [n]   int64  — point -> voxel row
// Returns the number of unique voxels (m <= n).
int64_t gcdlss_sparse_quantize(const float* points, int64_t n,
                               float voxel_size, int32_t* coords_out,
                               int64_t* unique_out, int64_t* inverse_out) {
  constexpr int64_t kOff = 1 << 20;  // field offset, 21-bit coords
  struct Entry {
    uint64_t key;
    int64_t idx;
  };
  std::vector<Entry> entries(n);
  std::vector<int32_t> q(n * 3);
  const float inv = 1.0f / voxel_size;
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = (int64_t)std::floor(points[i * 3 + 0] * inv);
    int64_t y = (int64_t)std::floor(points[i * 3 + 1] * inv);
    int64_t z = (int64_t)std::floor(points[i * 3 + 2] * inv);
    q[i * 3 + 0] = (int32_t)x;
    q[i * 3 + 1] = (int32_t)y;
    q[i * 3 + 2] = (int32_t)z;
    entries[i].key = ((uint64_t)(x + kOff) << 42) | ((uint64_t)(y + kOff) << 21) |
                     (uint64_t)(z + kOff);
    entries[i].idx = i;
  }
  std::sort(entries.begin(), entries.end(), [](const Entry& a, const Entry& b) {
    return a.key < b.key || (a.key == b.key && a.idx < b.idx);
  });
  int64_t m = -1;
  uint64_t prev = entries.empty() ? 0 : entries[0].key + 1;  // != first key
  for (int64_t s = 0; s < n; ++s) {
    const Entry& e = entries[s];
    if (s == 0 || e.key != prev) {
      ++m;
      unique_out[m] = e.idx;
      std::memcpy(coords_out + m * 3, q.data() + e.idx * 3, 3 * sizeof(int32_t));
      prev = e.key;
    }
    inverse_out[e.idx] = m;
  }
  return m + 1;
}

// Read a KITTI .bin scan + .label file and apply a learning-map LUT in one
// native pass (drops the per-point python loop of the reference's loader).
//   scan: float32 [n,4] buffer; labels_raw: int32 [n]
//   lut: int32 [lut_len] raw-label -> train-label (-1 ignore)
// Writes sem_out [n] (mapped), inst_out [n]. Returns n.
int64_t gcdlss_decode_labels(const int32_t* labels_raw, int64_t n,
                             const int32_t* lut, int64_t lut_len,
                             int32_t* sem_out, int32_t* inst_out) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t raw = labels_raw[i];
    int32_t sem = raw & 0xFFFF;
    inst_out[i] = (int32_t)((uint32_t)raw >> 16);
    sem_out[i] = (sem >= 0 && sem < lut_len) ? lut[sem] : -1;
  }
  return n;
}

}  // extern "C"
