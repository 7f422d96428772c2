// mesh_to_sdf_tpu native runtime components (C ABI, loaded via ctypes).
//
// The reference is 100% native (Rust). The device compute path here is
// JAX/Pallas; this library provides the native host-side runtime around it:
//   - GLB container framing + glTF accessor decoding (the data-loader core,
//     ≙ mesh_to_sdf_client/src/gltf's vendored parallel loader),
//   - the versioned msgpack SDF container codec (≙ mesh_to_sdf/src/serde.rs,
//     byte-compatible with the Python msgpack implementation),
//   - Morton-code computation + argsort (spatial preprocessing feeding the
//     tile-culling kernels, ≙ the role of R-tree/BVH build in the reference).
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>
#include <thread>

extern "C" {

// ---------------------------------------------------------------- GLB framing
// Splits a GLB v2 container. Returns 0 on success; fills (json_off, json_len,
// bin_off, bin_len). bin_off/len are 0 when no BIN chunk exists.
int m2s_glb_chunks(const uint8_t* data, uint64_t len, uint64_t* json_off,
                   uint64_t* json_len, uint64_t* bin_off, uint64_t* bin_len) {
  if (len < 12) return -1;
  uint32_t magic, version, total;
  std::memcpy(&magic, data, 4);
  std::memcpy(&version, data + 4, 4);
  std::memcpy(&total, data + 8, 4);
  if (magic != 0x46546C67u) return -2;
  if (version != 2) return -3;
  *json_off = *json_len = *bin_off = *bin_len = 0;
  uint64_t off = 12;
  uint64_t end = std::min<uint64_t>(total, len);
  while (off + 8 <= end) {
    uint32_t clen, ctype;
    std::memcpy(&clen, data + off, 4);
    std::memcpy(&ctype, data + off + 4, 4);
    off += 8;
    if (off + clen > len) return -4;
    if (ctype == 0x4E4F534Au) {  // 'JSON'
      *json_off = off;
      *json_len = clen;
    } else if (ctype == 0x004E4942u) {  // 'BIN'
      *bin_off = off;
      *bin_len = clen;
    }
    off += clen;
  }
  return *json_len ? 0 : -5;
}

// ------------------------------------------------------- accessor extraction
// Gathers a (count, ncomp) array from a possibly-strided glTF bufferView and
// converts to f32 (component types 5120..5126). Returns 0 on success.
int m2s_accessor_to_f32(const uint8_t* buf, uint64_t buf_len, uint64_t base,
                        uint64_t stride, uint32_t count, uint32_t ncomp,
                        uint32_t component_type, float* out) {
  uint32_t esize;
  switch (component_type) {
    case 5120: case 5121: esize = 1; break;
    case 5122: case 5123: esize = 2; break;
    case 5125: case 5126: esize = 4; break;
    default: return -1;
  }
  uint64_t item = (uint64_t)esize * ncomp;
  if (stride == 0) stride = item;
  if (count && base + (uint64_t)(count - 1) * stride + item > buf_len) return -2;
  for (uint32_t i = 0; i < count; ++i) {
    const uint8_t* p = buf + base + (uint64_t)i * stride;
    for (uint32_t c = 0; c < ncomp; ++c) {
      const uint8_t* q = p + (uint64_t)c * esize;
      float v;
      switch (component_type) {
        case 5120: v = (float)*(const int8_t*)q; break;
        case 5121: v = (float)*q; break;
        case 5122: { int16_t t; std::memcpy(&t, q, 2); v = (float)t; } break;
        case 5123: { uint16_t t; std::memcpy(&t, q, 2); v = (float)t; } break;
        case 5125: { uint32_t t; std::memcpy(&t, q, 4); v = (float)t; } break;
        default:   { std::memcpy(&v, q, 4); } break;
      }
      out[(uint64_t)i * ncomp + c] = v;
    }
  }
  return 0;
}

// Same but into uint32 (for index accessors; no float round-trip).
int m2s_accessor_to_u32(const uint8_t* buf, uint64_t buf_len, uint64_t base,
                        uint64_t stride, uint32_t count,
                        uint32_t component_type, uint32_t* out) {
  uint32_t esize;
  switch (component_type) {
    case 5121: esize = 1; break;
    case 5123: esize = 2; break;
    case 5125: esize = 4; break;
    default: return -1;
  }
  if (stride == 0) stride = esize;
  if (count && base + (uint64_t)(count - 1) * stride + esize > buf_len) return -2;
  for (uint32_t i = 0; i < count; ++i) {
    const uint8_t* p = buf + base + (uint64_t)i * stride;
    switch (component_type) {
      case 5121: out[i] = *p; break;
      case 5123: { uint16_t t; std::memcpy(&t, p, 2); out[i] = t; } break;
      default:   { uint32_t t; std::memcpy(&t, p, 4); out[i] = t; } break;
    }
  }
  return 0;
}

// ----------------------------------------------------------------- Morton
static inline uint64_t spread21(uint64_t x) {
  x &= 0x1FFFFF;
  x = (x | (x << 32)) & 0x1F00000000FFFFull;
  x = (x | (x << 16)) & 0x1F0000FF0000FFull;
  x = (x | (x << 8)) & 0x100F00F00F00F00Full;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

// 63-bit Morton codes for n points (xyz interleaved f32), normalized to the
// provided bbox. out_codes must hold n uint64.
void m2s_morton3d(const float* pts, uint64_t n, const float* bbox_min,
                  const float* bbox_max, uint64_t* out_codes) {
  float sx = bbox_max[0] > bbox_min[0] ? 2097151.0f / (bbox_max[0] - bbox_min[0]) : 0.f;
  float sy = bbox_max[1] > bbox_min[1] ? 2097151.0f / (bbox_max[1] - bbox_min[1]) : 0.f;
  float sz = bbox_max[2] > bbox_min[2] ? 2097151.0f / (bbox_max[2] - bbox_min[2]) : 0.f;
  for (uint64_t i = 0; i < n; ++i) {
    float x = (pts[i * 3 + 0] - bbox_min[0]) * sx;
    float y = (pts[i * 3 + 1] - bbox_min[1]) * sy;
    float z = (pts[i * 3 + 2] - bbox_min[2]) * sz;
    uint64_t xi = (uint64_t)std::max(0.0f, std::min(x, 2097151.0f));
    uint64_t yi = (uint64_t)std::max(0.0f, std::min(y, 2097151.0f));
    uint64_t zi = (uint64_t)std::max(0.0f, std::min(z, 2097151.0f));
    out_codes[i] = spread21(xi) | (spread21(yi) << 1) | (spread21(zi) << 2);
  }
}

// argsort of n uint64 keys into out_perm (uint32). Multithreaded merge sort
// for large n (the reference parallelizes its index builds with rayon;
// std::thread is the analog here).
void m2s_argsort_u64(const uint64_t* keys, uint64_t n, uint32_t* out_perm) {
  for (uint64_t i = 0; i < n; ++i) out_perm[i] = (uint32_t)i;
  auto cmp = [keys](uint32_t a, uint32_t b) { return keys[a] < keys[b]; };
  unsigned hw = std::thread::hardware_concurrency();
  if (n < (1u << 16) || hw < 2) {
    std::sort(out_perm, out_perm + n, cmp);
    return;
  }
  unsigned parts = std::min<unsigned>(hw, 8);
  std::vector<uint64_t> bounds(parts + 1);
  for (unsigned p = 0; p <= parts; ++p) bounds[p] = n * p / parts;
  std::vector<std::thread> threads;
  for (unsigned p = 0; p < parts; ++p)
    threads.emplace_back([&, p] {
      std::sort(out_perm + bounds[p], out_perm + bounds[p + 1], cmp);
    });
  for (auto& t : threads) t.join();
  std::vector<uint32_t> tmp(n);
  for (uint64_t width = 1; width < parts; width *= 2) {
    for (unsigned p = 0; p + width < parts; p += 2 * width) {
      std::merge(out_perm + bounds[p], out_perm + bounds[p + width],
                 out_perm + bounds[p + width],
                 out_perm + bounds[std::min<uint64_t>(p + 2 * width, parts)],
                 tmp.begin() + bounds[p], cmp);
      std::copy(tmp.begin() + bounds[p],
                tmp.begin() + bounds[std::min<uint64_t>(p + 2 * width, parts)],
                out_perm + bounds[p]);
    }
  }
}

// -------------------------------------------------------------- seed binning
// Rasterizes triangle grid-window [lo_cell, hi_cell] ranges into per-cell
// gather lists (the reference preheap's rasterization, grid.rs:383-456, done
// with host integers; consumed by ops/cpt.py::seed_from_bins on device).
// Layout contract matches the numpy implementation in ops/cpt.py::
// build_seed_bins: a cell with c candidates occupies ceil(c/k) consecutive
// rows; empty slots = T; padding rows' cell = N; rows padded to a power of
// two (>= 8). The entry table is K-MAJOR: entry[(col, row)] with shape
// (k, R_pad) — the long row axis is minor (see SeedBins).
namespace {
std::vector<int32_t> g_bins_entry;
std::vector<int32_t> g_bins_rows;
std::vector<int32_t> g_bins_cellrow;
}  // namespace

// Returns R_pad (rows) and writes n_rounds; 0 on failure. Fetch the arrays
// with m2s_copy_seed_bins (entry: R_pad*k int32, rows_cell: R_pad int32).
uint64_t m2s_seed_bins(const int32_t* lo_cell,  // (T, 3) clipped
                       const int32_t* hi_cell,  // (T, 3) clipped
                       uint64_t T, const uint32_t* counts, uint32_t k,
                       uint32_t* n_rounds) {
  const int64_t ny = counts[1], nz = counts[2];
  const int64_t N = (int64_t)counts[0] * ny * nz;
  // Pass 1: count entries.
  uint64_t E = 0;
  for (uint64_t t = 0; t < T; ++t) {
    const int32_t* lo = lo_cell + 3 * t;
    const int32_t* hi = hi_cell + 3 * t;
    int64_t wx = hi[0] - lo[0] + 1, wy = hi[1] - lo[1] + 1,
            wz = hi[2] - lo[2] + 1;
    if (wx > 0 && wy > 0 && wz > 0) E += (uint64_t)(wx * wy * wz);
  }
  uint64_t R_pad = 8;
  if (E == 0) {
    g_bins_entry.assign(R_pad * k, (int32_t)T);
    g_bins_rows.assign(R_pad, (int32_t)std::min<int64_t>(N, INT32_MAX));
    g_bins_cellrow.assign((size_t)N, -1);
    *n_rounds = 0;
    return R_pad;
  }
  // Pass 2: expand (cell, tri) pairs.
  std::vector<int32_t> flat(E), tri(E);
  uint64_t e = 0;
  for (uint64_t t = 0; t < T; ++t) {
    const int32_t* lo = lo_cell + 3 * t;
    const int32_t* hi = hi_cell + 3 * t;
    for (int32_t x = lo[0]; x <= hi[0]; ++x)
      for (int32_t y = lo[1]; y <= hi[1]; ++y) {
        int64_t base = ((int64_t)x * ny + y) * nz;
        for (int32_t z = lo[2]; z <= hi[2]; ++z) {
          flat[e] = (int32_t)(base + z);
          tri[e] = (int32_t)t;
          ++e;
        }
      }
  }
  // LSD radix sort by cell id (2 × 16-bit passes), carrying tri.
  std::vector<int32_t> flat2(E), tri2(E);
  {
    std::vector<uint32_t> hist(65536 + 1);
    for (int pass = 0; pass < 2; ++pass) {
      int shift = pass * 16;
      std::fill(hist.begin(), hist.end(), 0);
      for (uint64_t i = 0; i < E; ++i)
        ++hist[((uint32_t)flat[i] >> shift) & 0xFFFF];
      uint32_t sum = 0;
      for (size_t b = 0; b < 65536; ++b) {
        uint32_t c = hist[b];
        hist[b] = sum;
        sum += c;
      }
      for (uint64_t i = 0; i < E; ++i) {
        uint32_t b = ((uint32_t)flat[i] >> shift) & 0xFFFF;
        uint32_t p = hist[b]++;
        flat2[p] = flat[i];
        tri2[p] = tri[i];
      }
      flat.swap(flat2);
      tri.swap(tri2);
    }
  }
  // Pass 3: row layout. First count rows.
  uint64_t R = 0, d_max = 1;
  for (uint64_t i = 0; i < E;) {
    uint64_t j = i;
    while (j < E && flat[j] == flat[i]) ++j;
    uint64_t c = j - i, rows = (c + k - 1) / k;
    R += rows;
    if (rows > d_max) d_max = rows;
    i = j;
  }
  R_pad = 8;
  while (R_pad < R) R_pad <<= 1;
  g_bins_entry.assign(R_pad * k, (int32_t)T);
  g_bins_rows.assign(R_pad, (int32_t)std::min<int64_t>(N, INT32_MAX));
  g_bins_cellrow.assign((size_t)N, -1);
  uint64_t row = 0;
  for (uint64_t i = 0; i < E;) {
    uint64_t j = i;
    while (j < E && flat[j] == flat[i]) ++j;
    g_bins_cellrow[(size_t)(uint32_t)flat[i]] = (int32_t)row;
    for (uint64_t p = i; p < j; ++p) {
      uint64_t r = row + (p - i) / k, col = (p - i) % k;
      g_bins_entry[col * R_pad + r] = tri[p];
      g_bins_rows[r] = flat[i];
    }
    row += (j - i + k - 1) / k;
    i = j;
  }
  uint32_t rounds = 0;
  while ((1ull << rounds) < d_max) ++rounds;
  *n_rounds = rounds;
  return R_pad;
}

void m2s_copy_seed_bins(int32_t* entry_out, int32_t* rows_out,
                        int32_t* cellrow_out) {
  std::memcpy(entry_out, g_bins_entry.data(),
              g_bins_entry.size() * sizeof(int32_t));
  std::memcpy(rows_out, g_bins_rows.data(),
              g_bins_rows.size() * sizeof(int32_t));
  std::memcpy(cellrow_out, g_bins_cellrow.data(),
              g_bins_cellrow.size() * sizeof(int32_t));
  g_bins_entry.clear();
  g_bins_entry.shrink_to_fit();
  g_bins_rows.clear();
  g_bins_rows.shrink_to_fit();
  g_bins_cellrow.clear();
  g_bins_cellrow.shrink_to_fit();
}

// ------------------------------------------------------------ msgpack codec
// Minimal msgpack writer for the SDF container (schema-specific; byte-equal
// to Python msgpack.packb of the same envelope, use_bin_type=True).
namespace {
struct Writer {
  std::vector<uint8_t> out;
  bool ok = true;  // cleared when a value cannot be represented
  void u8(uint8_t v) { out.push_back(v); }
  void be16(uint16_t v) { u8(v >> 8); u8(v & 0xFF); }
  void be32(uint32_t v) { be16(v >> 16); be16(v & 0xFFFF); }
  void be64(uint64_t v) { be32((uint32_t)(v >> 32)); be32((uint32_t)v); }
  void map(uint32_t n) {
    if (n <= 15) u8(0x80 | n);
    else { u8(0xDE); be16((uint16_t)n); }
  }
  void str(const std::string& s) {
    size_t n = s.size();
    if (n <= 31) u8(0xA0 | (uint8_t)n);
    else if (n <= 0xFF) { u8(0xD9); u8((uint8_t)n); }
    else { u8(0xDA); be16((uint16_t)n); }
    out.insert(out.end(), s.begin(), s.end());
  }
  void uint(uint64_t v) {
    if (v <= 0x7F) u8((uint8_t)v);
    else if (v <= 0xFF) { u8(0xCC); u8((uint8_t)v); }
    else if (v <= 0xFFFF) { u8(0xCD); be16((uint16_t)v); }
    else if (v <= 0xFFFFFFFFull) { u8(0xCE); be32((uint32_t)v); }
    else { u8(0xCF); be64(v); }
  }
  void sint(int64_t v) {
    if (v >= 0) { uint((uint64_t)v); return; }
    if (v >= -32) u8((uint8_t)(int8_t)v);
    else { u8(0xD1); be16((uint16_t)(int16_t)v); }
  }
  void f64(double v) {
    u8(0xCB);
    uint64_t bits;
    std::memcpy(&bits, &v, 8);
    for (int i = 7; i >= 0; --i) u8((bits >> (8 * i)) & 0xFF);
  }
  void bin(const uint8_t* p, uint64_t n) {
    // msgpack bin32 caps payloads below 2^32 bytes; anything larger is an
    // error, never a silent wrap (matches the Python encoder, which raises).
    if (n >= (1ull << 32)) { ok = false; return; }
    if (n <= 0xFF) { u8(0xC4); u8((uint8_t)n); }
    else if (n <= 0xFFFF) { u8(0xC5); be16((uint16_t)n); }
    else { u8(0xC6); be32((uint32_t)n); }
    out.insert(out.end(), p, p + n);
  }
  void arr(uint32_t n) {
    if (n <= 15) u8(0x90 | n);
    else { u8(0xDC); be16((uint16_t)n); }
  }
  void array_record(const char* dtype, const std::vector<uint64_t>& shape,
                    const uint8_t* data, uint64_t nbytes) {
    map(3);
    str("dtype"); str(dtype);
    str("shape"); arr((uint32_t)shape.size());
    for (auto s : shape) uint(s);
    str("data"); bin(data, nbytes);
  }
};
}  // namespace

static std::vector<uint8_t> g_last_packed;

// Packs a Grid SDF container; returns the byte length (fetch via
// m2s_copy_packed). distances: nx*ny*nz f32.
uint64_t m2s_pack_grid_sdf(const float* first_cell, const float* cell_size,
                           const uint32_t* cell_count, const float* distances) {
  Writer w;
  uint64_t n = (uint64_t)cell_count[0] * cell_count[1] * cell_count[2];
  w.map(3);
  w.str("magic"); w.str("mesh_to_sdf_tpu");
  w.str("version"); w.uint(1);
  w.str("sdf");
  w.map(3);
  w.str("kind"); w.str("grid");
  w.str("grid");
  w.map(3);
  w.str("first_cell"); w.arr(3);
  for (int i = 0; i < 3; ++i) w.f64((double)first_cell[i]);
  w.str("cell_size"); w.arr(3);
  for (int i = 0; i < 3; ++i) w.f64((double)cell_size[i]);
  w.str("cell_count"); w.arr(3);
  for (int i = 0; i < 3; ++i) w.uint(cell_count[i]);
  w.str("distances");
  w.array_record("<f4", {n}, (const uint8_t*)distances, n * 4);
  if (!w.ok) return 0;  // payload exceeds msgpack bin32 — caller raises
  g_last_packed = std::move(w.out);
  return g_last_packed.size();
}

uint64_t m2s_pack_generic_sdf(const float* query_points, const float* distances,
                              uint64_t count) {
  Writer w;
  w.map(3);
  w.str("magic"); w.str("mesh_to_sdf_tpu");
  w.str("version"); w.uint(1);
  w.str("sdf");
  w.map(3);
  w.str("kind"); w.str("generic");
  w.str("query_points");
  w.array_record("<f4", {count, 3}, (const uint8_t*)query_points, count * 12);
  w.str("distances");
  w.array_record("<f4", {count}, (const uint8_t*)distances, count * 4);
  if (!w.ok) return 0;  // payload exceeds msgpack bin32 — caller raises
  g_last_packed = std::move(w.out);
  return g_last_packed.size();
}

void m2s_copy_packed(uint8_t* out) {
  std::memcpy(out, g_last_packed.data(), g_last_packed.size());
  g_last_packed.clear();
  g_last_packed.shrink_to_fit();
}

int m2s_version() { return 1; }

}  // extern "C"
