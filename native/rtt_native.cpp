// Native runtime components for ray_tracer.
//
// The reference's host runtime is Rust (scene assembly, asset parsing,
// src/core/scene.rs + src/core/resource.rs); this system keeps its
// compute path in XLA/Pallas and implements the host-side hot paths here in
// C++: a fast Wavefront-OBJ parser (text parsing is the slowest host stage
// for large models) and Morton ordering of triangle centroids. Loaded via ctypes
// (ray_tracer/utils/native.py) with a pure-Python fallback when the
// shared library hasn't been built.
//
// Build: make -C native        (g++ -O2 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Corner {
  int32_t v, t, n;
  bool operator==(const Corner& o) const {
    return v == o.v && t == o.t && n == o.n;
  }
};

struct CornerHash {
  size_t operator()(const Corner& c) const {
    size_t h = static_cast<uint32_t>(c.v);
    h = h * 1000003u ^ static_cast<uint32_t>(c.t + 1);
    h = h * 1000003u ^ static_cast<uint32_t>(c.n + 1);
    return h;
  }
};

struct ObjObject {
  std::string name;
  std::string material;
  std::vector<float> positions;  // deduped, 3 per vertex
  std::vector<float> normals;    // 3 per vertex (zeros if absent)
  std::vector<float> uvs;        // 2 per vertex (zeros if absent)
  std::vector<uint32_t> indices;
  bool has_normals = true;
  bool has_uvs = true;
};

struct ObjFile {
  std::vector<ObjObject> objects;
  std::string mtllib;
};

// Parse one float/int token quickly; strtod handles the formats OBJ uses.
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

void finish_object(ObjFile& f, ObjObject& cur,
                   std::unordered_map<Corner, uint32_t, CornerHash>& remap) {
  if (!cur.indices.empty()) {
    f.objects.push_back(std::move(cur));
  }
  cur = ObjObject();
  remap.clear();
}

// Area-weighted smooth normals for objects without vn records.
void smooth_normals(ObjObject& o) {
  size_t nv = o.positions.size() / 3;
  o.normals.assign(nv * 3, 0.0f);
  for (size_t i = 0; i + 2 < o.indices.size(); i += 3) {
    uint32_t a = o.indices[i], b = o.indices[i + 1], c = o.indices[i + 2];
    const float* pa = &o.positions[3 * a];
    const float* pb = &o.positions[3 * b];
    const float* pc = &o.positions[3 * c];
    float e1[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
    float e2[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                  e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    for (uint32_t vi : {a, b, c}) {
      o.normals[3 * vi] += n[0];
      o.normals[3 * vi + 1] += n[1];
      o.normals[3 * vi + 2] += n[2];
    }
  }
  for (size_t i = 0; i < nv; ++i) {
    float* n = &o.normals[3 * i];
    float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len > 1e-12f) {
      n[0] /= len;
      n[1] /= len;
      n[2] /= len;
    }
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parser
// ---------------------------------------------------------------------------

void* rtt_obj_load(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::string text(size, '\0');
  if (std::fread(&text[0], 1, size, fp) != static_cast<size_t>(size)) {
    std::fclose(fp);
    return nullptr;
  }
  std::fclose(fp);

  auto* file = new ObjFile();
  std::vector<float> vs, vns, vts;
  ObjObject cur;
  std::unordered_map<Corner, uint32_t, CornerHash> remap;
  std::vector<Corner> face;

  const char* p = text.data();
  const char* end = p + text.size();
  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);
    if (q + 1 < line_end && q[0] == 'v' &&
        (q[1] == ' ' || q[1] == '\t')) {
      char* r = const_cast<char*>(q + 1);
      for (int k = 0; k < 3; ++k) vs.push_back(std::strtof(r, &r));
    } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n') {
      char* r = const_cast<char*>(q + 2);
      for (int k = 0; k < 3; ++k) vns.push_back(std::strtof(r, &r));
    } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 't') {
      char* r = const_cast<char*>(q + 2);
      float u = std::strtof(r, &r);
      float v = std::strtof(r, &r);
      vts.push_back(u);
      vts.push_back(1.0f - v);  // flip to v-down convention (texture.py)
    } else if (q < line_end && q[0] == 'f') {
      face.clear();
      bool face_bad = false;
      const char* r = q + 1;
      while (r < line_end) {
        r = skip_ws(r, line_end);
        if (r >= line_end) break;
        char* after = nullptr;
        long vi = std::strtol(r, &after, 10);
        if (after == r) break;
        Corner c{0, -1, -1};
        c.v = vi > 0 ? static_cast<int32_t>(vi - 1)
                     : static_cast<int32_t>(vs.size() / 3 + vi);
        r = after;
        if (r < line_end && *r == '/') {
          ++r;
          if (r < line_end && *r != '/') {
            long ti = std::strtol(r, &after, 10);
            c.t = ti > 0 ? static_cast<int32_t>(ti - 1)
                         : static_cast<int32_t>(vts.size() / 2 + ti);
            r = after;
          }
          if (r < line_end && *r == '/') {
            ++r;
            long ni = std::strtol(r, &after, 10);
            if (after != r) {
              c.n = ni > 0 ? static_cast<int32_t>(ni - 1)
                           : static_cast<int32_t>(vns.size() / 3 + ni);
              r = after;
            }
          }
        }
        // position index must be in range (normals/uvs are checked at
        // insertion below); a malformed/truncated `f` line would otherwise
        // read out of bounds — skip the whole face instead
        if (c.v < 0 || static_cast<size_t>(3 * c.v + 2) >= vs.size())
          face_bad = true;
        face.push_back(c);
      }
      // fan triangulation + (v, vt, vn) dedup — tobj's
      // triangulate+single_index semantics (resource.rs:60-63)
      if (face.size() >= 3 && !face_bad) {
        for (size_t k = 1; k + 1 < face.size(); ++k) {
          for (const Corner& c : {face[0], face[k], face[k + 1]}) {
            auto it = remap.find(c);
            uint32_t idx;
            if (it == remap.end()) {
              idx = static_cast<uint32_t>(cur.positions.size() / 3);
              remap.emplace(c, idx);
              cur.positions.insert(cur.positions.end(),
                                   &vs[3 * c.v], &vs[3 * c.v] + 3);
              if (c.n >= 0 && static_cast<size_t>(3 * c.n + 2) < vns.size()) {
                cur.normals.insert(cur.normals.end(),
                                   &vns[3 * c.n], &vns[3 * c.n] + 3);
              } else {
                cur.normals.insert(cur.normals.end(), {0.f, 0.f, 0.f});
                cur.has_normals = false;
              }
              if (c.t >= 0 && static_cast<size_t>(2 * c.t + 1) < vts.size()) {
                cur.uvs.insert(cur.uvs.end(), &vts[2 * c.t],
                               &vts[2 * c.t] + 2);
              } else {
                cur.uvs.insert(cur.uvs.end(), {0.f, 0.f});
                cur.has_uvs = false;
              }
            } else {
              idx = it->second;
            }
            cur.indices.push_back(idx);
          }
        }
      }
    } else if (q + 6 <= line_end && std::strncmp(q, "usemtl", 6) == 0) {
      cur.material.assign(skip_ws(q + 6, line_end),
                          line_end - skip_ws(q + 6, line_end));
      while (!cur.material.empty() &&
             (cur.material.back() == '\r' || cur.material.back() == ' '))
        cur.material.pop_back();
    } else if (q + 6 <= line_end && std::strncmp(q, "mtllib", 6) == 0) {
      file->mtllib.assign(skip_ws(q + 6, line_end),
                          line_end - skip_ws(q + 6, line_end));
      while (!file->mtllib.empty() &&
             (file->mtllib.back() == '\r' || file->mtllib.back() == ' '))
        file->mtllib.pop_back();
    } else if (q < line_end && (q[0] == 'o' || q[0] == 'g')) {
      std::string mtl = cur.material;
      finish_object(*file, cur, remap);
      const char* name = skip_ws(q + 1, line_end);
      cur.name.assign(name, line_end - name);
      while (!cur.name.empty() &&
             (cur.name.back() == '\r' || cur.name.back() == ' '))
        cur.name.pop_back();
      cur.material = mtl;
    }
    p = line_end + 1;
  }
  finish_object(*file, cur, remap);

  for (auto& o : file->objects) {
    if (!o.has_normals) smooth_normals(o);
  }
  return file;
}

int rtt_obj_num_objects(void* h) {
  return static_cast<int>(static_cast<ObjFile*>(h)->objects.size());
}

void rtt_obj_counts(void* h, int obj, int64_t* n_verts, int64_t* n_indices,
                    int* has_uvs) {
  const auto& o = static_cast<ObjFile*>(h)->objects[obj];
  *n_verts = static_cast<int64_t>(o.positions.size() / 3);
  *n_indices = static_cast<int64_t>(o.indices.size());
  *has_uvs = o.has_uvs ? 1 : 0;
}

void rtt_obj_strings(void* h, int obj, char* name, char* material,
                     char* mtllib, int buflen) {
  const auto* f = static_cast<ObjFile*>(h);
  const auto& o = f->objects[obj];
  std::snprintf(name, buflen, "%s", o.name.c_str());
  std::snprintf(material, buflen, "%s", o.material.c_str());
  std::snprintf(mtllib, buflen, "%s", f->mtllib.c_str());
}

void rtt_obj_fill(void* h, int obj, float* pos, float* nrm, float* uv,
                  uint32_t* idx) {
  const auto& o = static_cast<ObjFile*>(h)->objects[obj];
  std::memcpy(pos, o.positions.data(), o.positions.size() * sizeof(float));
  std::memcpy(nrm, o.normals.data(), o.normals.size() * sizeof(float));
  std::memcpy(uv, o.uvs.data(), o.uvs.size() * sizeof(float));
  std::memcpy(idx, o.indices.data(), o.indices.size() * sizeof(uint32_t));
}

void rtt_obj_free(void* h) { delete static_cast<ObjFile*>(h); }

// ---------------------------------------------------------------------------
// Morton ordering (feeds the Pallas cluster-culling kernel)
// ---------------------------------------------------------------------------

static inline uint64_t spread10(uint64_t x) {
  x = (x | (x << 16)) & 0x030000FFull;
  x = (x | (x << 8)) & 0x0300F00Full;
  x = (x | (x << 4)) & 0x030C30C3ull;
  x = (x | (x << 2)) & 0x09249249ull;
  return x;
}

void rtt_morton_order(const float* centroids, int64_t n, int64_t* order) {
  if (n <= 0) return;
  double lo[3] = {centroids[0], centroids[1], centroids[2]};
  double hi[3] = {centroids[0], centroids[1], centroids[2]};
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      double v = centroids[3 * i + k];
      lo[k] = std::min(lo[k], v);
      hi[k] = std::max(hi[k], v);
    }
  }
  double ext[3];
  for (int k = 0; k < 3; ++k) ext[k] = std::max(hi[k] - lo[k], 1e-12);

  std::vector<std::pair<uint64_t, int64_t>> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t code = 0;
    uint64_t q[3];
    for (int k = 0; k < 3; ++k) {
      double t = (centroids[3 * i + k] - lo[k]) / ext[k] * 1023.0;
      q[k] = static_cast<uint64_t>(std::max(0.0, std::min(1023.0, t)));
    }
    code = (spread10(q[0]) << 2) | (spread10(q[1]) << 1) | spread10(q[2]);
    keys[i] = {code, i};
  }
  std::stable_sort(keys.begin(), keys.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  for (int64_t i = 0; i < n; ++i) order[i] = keys[i].second;
}

}  // extern "C"
