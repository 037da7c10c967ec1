// Native point-cloud host ops (the port's own copy of the JAX package's
// native/src/pointcloud.cpp; the source is the same below this header).
//
// The host-side fusion/export path handles millions of points per sequence
// (per-chunk clouds -> voxel fusion -> merged PLY).  These are its hot host
// ops, exposed over a C ABI for ctypes:
//
//   - voxel_downsample: average points/colors per occupied voxel
//   - write_ply / read_ply header probe: zero-copy binary PLY I/O
//   - write_3dgs_splats: the anisotropic 3DGS exporter in one pass
//
// Built at first use by da3slam_tpu_torch/native/__init__.py:
// g++ -O3 -march=native -shared -fPIC pointcloud.cpp -o pointcloud_<hash>.so

#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <thread>
#include <unordered_map>
#include <vector>
#include <string>

extern "C" {

// Voxel-grid downsample with per-voxel averaging.
// pts [n*3] float32, cols [n*3] uint8 (may be null).
// out_pts / out_cols must have capacity for n points.
// Returns the number of output voxels (<= n), or -1 on error.
int64_t voxel_downsample(const float* pts, const uint8_t* cols, int64_t n,
                         float voxel, float* out_pts, uint8_t* out_cols) {
  if (n <= 0 || voxel <= 0.f) return -1;
  struct Acc {
    double x = 0, y = 0, z = 0;
    double r = 0, g = 0, b = 0;
    int64_t count = 0;
  };
  std::unordered_map<uint64_t, Acc> grid;
  grid.reserve(static_cast<size_t>(n / 4 + 16));

  const double inv = 1.0 / voxel;
  for (int64_t i = 0; i < n; ++i) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    // 21-bit signed voxel coords packed into one 64-bit key
    const int64_t vx = static_cast<int64_t>(std::floor(x * inv)) & 0x1FFFFF;
    const int64_t vy = static_cast<int64_t>(std::floor(y * inv)) & 0x1FFFFF;
    const int64_t vz = static_cast<int64_t>(std::floor(z * inv)) & 0x1FFFFF;
    const uint64_t key = (static_cast<uint64_t>(vx) << 42) |
                         (static_cast<uint64_t>(vy) << 21) |
                         static_cast<uint64_t>(vz);
    Acc& a = grid[key];
    a.x += x; a.y += y; a.z += z;
    if (cols) {
      a.r += cols[3 * i]; a.g += cols[3 * i + 1]; a.b += cols[3 * i + 2];
    }
    a.count++;
  }

  int64_t m = 0;
  for (const auto& kv : grid) {
    const Acc& a = kv.second;
    const double c = static_cast<double>(a.count);
    out_pts[3 * m] = static_cast<float>(a.x / c);
    out_pts[3 * m + 1] = static_cast<float>(a.y / c);
    out_pts[3 * m + 2] = static_cast<float>(a.z / c);
    if (cols && out_cols) {
      out_cols[3 * m] = static_cast<uint8_t>(a.r / c + 0.5);
      out_cols[3 * m + 1] = static_cast<uint8_t>(a.g / c + 0.5);
      out_cols[3 * m + 2] = static_cast<uint8_t>(a.b / c + 0.5);
    }
    ++m;
  }
  return m;
}

// Binary little-endian PLY writer (xyz f32 [+ rgb u8]).  Returns 0 on
// success.  Streams straight from the caller's buffers - no Python-side
// interleaving copy.
int write_ply(const char* path, const float* pts, const uint8_t* cols,
              int64_t n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::string header = "ply\nformat binary_little_endian 1.0\n";
  header += "element vertex " + std::to_string(n) + "\n";
  header += "property float x\nproperty float y\nproperty float z\n";
  if (cols)
    header += "property uchar red\nproperty uchar green\nproperty uchar blue\n";
  header += "end_header\n";
  std::fwrite(header.data(), 1, header.size(), f);

  if (!cols) {
    std::fwrite(pts, sizeof(float), static_cast<size_t>(3 * n), f);
  } else {
    // interleave in 64k-point chunks to stay cache-friendly
    const int64_t CHUNK = 65536;
    std::vector<uint8_t> buf(static_cast<size_t>(CHUNK) * 15);
    for (int64_t start = 0; start < n; start += CHUNK) {
      const int64_t cnt = (n - start < CHUNK) ? (n - start) : CHUNK;
      uint8_t* p = buf.data();
      for (int64_t i = 0; i < cnt; ++i) {
        std::memcpy(p, pts + 3 * (start + i), 12);
        std::memcpy(p + 12, cols + 3 * (start + i), 3);
        p += 15;
      }
      std::fwrite(buf.data(), 1, static_cast<size_t>(cnt) * 15, f);
    }
  }
  std::fclose(f);
  return 0;
}

// Read the vertex data of a binary PLY written by write_ply.
// First call with pts == nullptr to get the point count and has_color flag
// (packed: count * 2 + has_color); then call again with buffers.
int64_t read_ply(const char* path, float* pts, uint8_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  int64_t n = -1;
  bool has_color = false, binary = false;
  while (std::fgets(line, sizeof(line), f)) {
    if (std::strncmp(line, "format binary_little_endian", 27) == 0) binary = true;
    if (std::sscanf(line, "element vertex %" SCNd64, &n) == 1) {}
    if (std::strstr(line, "property uchar red")) has_color = true;
    if (std::strncmp(line, "end_header", 10) == 0) break;
  }
  if (n < 0 || !binary) { std::fclose(f); return -1; }
  if (!pts) { std::fclose(f); return n * 2 + (has_color ? 1 : 0); }

  if (!has_color) {
    size_t got = std::fread(pts, sizeof(float), static_cast<size_t>(3 * n), f);
    std::fclose(f);
    return (got == static_cast<size_t>(3 * n)) ? n : -1;
  }
  const int64_t CHUNK = 65536;
  std::vector<uint8_t> buf(static_cast<size_t>(CHUNK) * 15);
  for (int64_t start = 0; start < n; start += CHUNK) {
    const int64_t cnt = (n - start < CHUNK) ? (n - start) : CHUNK;
    if (std::fread(buf.data(), 1, static_cast<size_t>(cnt) * 15, f) !=
        static_cast<size_t>(cnt) * 15) { std::fclose(f); return -1; }
    const uint8_t* p = buf.data();
    for (int64_t i = 0; i < cnt; ++i) {
      std::memcpy(pts + 3 * (start + i), p, 12);
      if (cols) std::memcpy(cols + 3 * (start + i), p + 12, 3);
      p += 15;
    }
  }
  std::fclose(f);
  return n;
}

// --------------------------------------------------------------------------
// 3D-Gaussian-Splatting PLY writer.
//
// Fuses the whole host-side splat pipeline (inout/export3d.py's
// _splat_frames + _rotmat_to_quat_np + filtering + serialization — the
// align+export hot path, ~0.7 s in NumPy's ~20 array passes at 0.5M splats)
// into ONE streaming pass per pixel: tangent frames from the point-grid
// gradients, Shepperd quaternion, confidence→opacity, conf/depth/finite
// filtering, and the 17-float INRIA record, written slab-parallel.

namespace {

constexpr float kShC0 = 0.28209479177387814f;  // Y_0^0

struct SplatParams {
  float conf_threshold;
  float opacity_scale;
  float max_ratio;
};

// One pixel -> one optional 17-float record (x y z nx ny nz f_dc0..2
// opacity scale0..2 rot0..3).  Returns true if the splat is kept.
inline bool splat_record(const float* pts, const uint8_t* cols,
                         const float* conf, const float* depth,
                         int64_t H, int64_t W, int64_t h, int64_t w,
                         const SplatParams& sp, float* rec) {
  const int64_t i = h * W + w;
  const float c = conf[i];
  const float d = depth[i];
  const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
  if (c < sp.conf_threshold || d <= 1e-6f) return false;
  if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z))
    return false;

  // np.gradient semantics: central differences interior, one-sided edges
  auto grad = [&](int64_t ia, int64_t ib, float scale, float* out) {
    out[0] = (pts[3 * ib] - pts[3 * ia]) * scale;
    out[1] = (pts[3 * ib + 1] - pts[3 * ia + 1]) * scale;
    out[2] = (pts[3 * ib + 2] - pts[3 * ia + 2]) * scale;
  };
  float tu[3], tv[3];
  if (w == 0)           grad(i, i + 1, 1.0f, tu);
  else if (w == W - 1)  grad(i - 1, i, 1.0f, tu);
  else                  grad(i - 1, i + 1, 0.5f, tu);
  if (h == 0)           grad(i, i + W, 1.0f, tv);
  else if (h == H - 1)  grad(i - W, i, 1.0f, tv);
  else                  grad(i - W, i + W, 0.5f, tv);

  const float len_u = std::sqrt(tu[0] * tu[0] + tu[1] * tu[1] + tu[2] * tu[2]);
  const float len_v = std::sqrt(tv[0] * tv[0] + tv[1] * tv[1] + tv[2] * tv[2]);
  float n[3] = {tu[1] * tv[2] - tu[2] * tv[1], tu[2] * tv[0] - tu[0] * tv[2],
                tu[0] * tv[1] - tu[1] * tv[0]};
  const float n_len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);

  // scales (cap anisotropy at max_ratio of the smaller tangent footprint)
  const float base = std::fmin(len_u, len_v);
  const float cap = sp.max_ratio * std::fmax(base, 1e-12f);
  const float s[3] = {std::fmin(len_u, cap), std::fmin(len_v, cap),
                      0.1f * base};

  // rotation: columns e1 = tu/|tu|, e3 = n/|n|, e2 = e3 x e1
  float q[4] = {1.f, 0.f, 0.f, 0.f};
  if (len_u > 1e-12f && len_v > 1e-12f && n_len > 1e-12f) {
    const float iu = 1.0f / len_u, in = 1.0f / n_len;
    const float e1[3] = {tu[0] * iu, tu[1] * iu, tu[2] * iu};
    const float e3[3] = {n[0] * in, n[1] * in, n[2] * in};
    const float e2[3] = {e3[1] * e1[2] - e3[2] * e1[1],
                         e3[2] * e1[0] - e3[0] * e1[2],
                         e3[0] * e1[1] - e3[1] * e1[0]};
    // R columns are (e1, e2, e3): R[r][c]
    const float m00 = e1[0], m01 = e2[0], m02 = e3[0];
    const float m10 = e1[1], m11 = e2[1], m12 = e3[1];
    const float m20 = e1[2], m21 = e2[2], m22 = e3[2];
    const float tr = m00 + m11 + m22;
    // Shepperd: pick the largest of the four squared components
    const float lead[4] = {1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                           1 - m00 - m11 + m22};
    int best = 0;
    for (int k = 1; k < 4; ++k)
      if (lead[k] > lead[best]) best = k;
    switch (best) {
      case 0:
        q[0] = 1 + tr;       q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
        break;
      case 1:
        q[0] = m21 - m12; q[1] = 1 + m00 - m11 - m22; q[2] = m01 + m10; q[3] = m02 + m20;
        break;
      case 2:
        q[0] = m02 - m20; q[1] = m01 + m10; q[2] = 1 - m00 + m11 - m22; q[3] = m12 + m21;
        break;
      default:
        q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21; q[3] = 1 - m00 - m11 + m22;
    }
    const float qn = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    const float iq = 1.0f / std::fmax(qn, 1e-12f);
    q[0] *= iq; q[1] *= iq; q[2] *= iq; q[3] *= iq;
  }

  // confidence -> opacity: 1 - exp(-scale * max(conf - 0.4, 0))
  float op = 1.0f - std::exp(-sp.opacity_scale * std::fmax(c - 0.4f, 0.0f));
  op = std::fmin(std::fmax(op, 1e-4f), 1.0f - 1e-4f);

  rec[0] = x; rec[1] = y; rec[2] = z;
  rec[3] = rec[4] = rec[5] = 0.0f;  // normals (unused in the 3DGS layout)
  const float inv255 = 1.0f / 255.0f;
  rec[6] = (cols[3 * i] * inv255 - 0.5f) / kShC0;
  rec[7] = (cols[3 * i + 1] * inv255 - 0.5f) / kShC0;
  rec[8] = (cols[3 * i + 2] * inv255 - 0.5f) / kShC0;
  rec[9] = std::log(op / (1.0f - op));
  rec[10] = std::log(std::fmax(s[0], 1e-8f));
  rec[11] = std::log(std::fmax(s[1], 1e-8f));
  rec[12] = std::log(std::fmax(s[2], 1e-8f));
  rec[13] = q[0]; rec[14] = q[1]; rec[15] = q[2]; rec[16] = q[3];
  return true;
}

}  // namespace

// pts [V*H*W*3] f32 world-point grid, cols [V*H*W*3] u8, conf/depth [V*H*W]
// f32 (all already strided by the caller).  Writes the standard INRIA 3DGS
// binary PLY; record order matches the NumPy path (view-major, row-major).
// Returns the number of splats written, or -1 on error.
int64_t write_3dgs_splats(const char* path, const float* pts,
                          const uint8_t* cols, const float* conf,
                          const float* depth, int64_t V, int64_t H, int64_t W,
                          float conf_threshold, float opacity_scale,
                          float max_ratio) {
  if (V <= 0 || H < 2 || W < 2) return -1;
  const SplatParams sp{conf_threshold, opacity_scale, max_ratio};

  // slab-parallel over views x row-bands into per-slab buffers (records are
  // variable-count per row, so each slab compacts locally and the writer
  // concatenates in order)
  unsigned hw_threads = std::thread::hardware_concurrency();
  int n_threads = static_cast<int>(hw_threads ? hw_threads : 1);
  if (n_threads > 16) n_threads = 16;
  const int64_t total_rows = V * H;
  if (n_threads > total_rows) n_threads = static_cast<int>(total_rows);

  std::vector<std::vector<float>> slabs(static_cast<size_t>(n_threads));
  auto work = [&](int tid) {
    const int64_t r0 = total_rows * tid / n_threads;
    const int64_t r1 = total_rows * (tid + 1) / n_threads;
    std::vector<float>& out = slabs[static_cast<size_t>(tid)];
    out.reserve(static_cast<size_t>(r1 - r0) * static_cast<size_t>(W) * 17 / 2);
    float rec[17];
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t v = r / H, h = r % H;
      const float* vp = pts + v * H * W * 3;
      const uint8_t* vc = cols + v * H * W * 3;
      const float* vf = conf + v * H * W;
      const float* vd = depth + v * H * W;
      for (int64_t w = 0; w < W; ++w) {
        if (splat_record(vp, vc, vf, vd, H, W, h, w, sp, rec))
          out.insert(out.end(), rec, rec + 17);
      }
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(n_threads));
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& t : threads) t.join();
  }

  int64_t n = 0;
  for (const auto& s : slabs) n += static_cast<int64_t>(s.size() / 17);

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::string header = "ply\nformat binary_little_endian 1.0\n";
  header += "element vertex " + std::to_string(n) + "\n";
  static const char* props[] = {
      "x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2",
      "opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2",
      "rot_3"};
  for (const char* p : props)
    header += std::string("property float ") + p + "\n";
  header += "end_header\n";
  std::fwrite(header.data(), 1, header.size(), f);
  for (const auto& s : slabs)
    if (!s.empty()) std::fwrite(s.data(), sizeof(float), s.size(), f);
  std::fclose(f);
  return n;
}

}  // extern "C"
