// tiray_native: host-side native runtime for ti_raytrace_tpu.
//
// The render compute path is JAX/XLA/Pallas; this library covers the
// host-side ingest work the reference delegated to native pip packages
// (pywavefront / cv2, SURVEY.md §2.9): a fast Wavefront OBJ/MTL parser
// that produces per-material triangle soup, plus a morton-code kernel
// for the cluster/LBVH builders.  Exposed through a plain C ABI and
// consumed via ctypes (ti_raytrace_tpu/io/native.py).
//
// Parsing semantics mirror ti_raytrace_tpu/io/obj.py exactly (material
// declaration order, fan triangulation, negative/relative indices);
// tests assert byte-level equivalence of the two loaders.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Material {
  std::string name;
  float diffuse[3] = {0.8f, 0.8f, 0.8f};   // pywavefront defaults
  float emissive[3] = {0.f, 0.f, 0.f};
  float shininess = 0.f;                   // Ns
  float optical_density = 1.f;             // Ni
  float transparency = 1.f;                // d
  std::string texture;
};

struct Corner {
  int32_t v, t, n;
};

struct Mesh {
  std::vector<Material> materials;
  std::unordered_map<std::string, int32_t> mat_index;
  std::vector<std::vector<Corner>> faces_flat;  // per material: 3 corners/tri
  std::vector<float> positions;  // xyz
  std::vector<float> normals;
  std::vector<float> uvs;        // uv
  std::string error;
};

int32_t get_or_add_material(Mesh* m, const std::string& name) {
  auto it = m->mat_index.find(name);
  if (it != m->mat_index.end()) return it->second;
  Material mat;
  mat.name = name;
  m->materials.push_back(mat);
  m->faces_flat.emplace_back();
  int32_t idx = static_cast<int32_t>(m->materials.size()) - 1;
  m->mat_index[name] = idx;
  return idx;
}

std::string dirname_of(const std::string& path) {
  size_t k = path.find_last_of("/\\");
  return k == std::string::npos ? std::string(".") : path.substr(0, k);
}

// Split a line into whitespace tokens (in place, fast path).
int tokenize(char* line, char** tok, int max_tok) {
  int n = 0;
  char* p = line;
  while (*p && n < max_tok) {
    while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') ++p;
    if (!*p) break;
    tok[n++] = p;
    while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
    if (*p) *p++ = '\0';
  }
  return n;
}

void parse_mtl(Mesh* m, const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return;
  char line[4096];
  int32_t cur = -1;
  char* tok[16];
  while (std::fgets(line, sizeof(line), f)) {
    int n = tokenize(line, tok, 16);
    if (n == 0) continue;
    if (std::strcmp(tok[0], "newmtl") == 0 && n > 1) {
      cur = get_or_add_material(m, tok[1]);
    } else if (cur < 0) {
      continue;
    } else if (std::strcmp(tok[0], "Kd") == 0 && n >= 4) {
      for (int i = 0; i < 3; ++i) m->materials[cur].diffuse[i] = std::strtof(tok[1 + i], nullptr);
    } else if (std::strcmp(tok[0], "Ke") == 0 && n >= 4) {
      for (int i = 0; i < 3; ++i) m->materials[cur].emissive[i] = std::strtof(tok[1 + i], nullptr);
    } else if (std::strcmp(tok[0], "Ns") == 0 && n >= 2) {
      m->materials[cur].shininess = std::strtof(tok[1], nullptr);
    } else if (std::strcmp(tok[0], "Ni") == 0 && n >= 2) {
      m->materials[cur].optical_density = std::strtof(tok[1], nullptr);
    } else if (std::strcmp(tok[0], "d") == 0 && n >= 2) {
      m->materials[cur].transparency = std::strtof(tok[1], nullptr);
    } else if (std::strcmp(tok[0], "Tr") == 0 && n >= 2) {
      m->materials[cur].transparency = 1.f - std::strtof(tok[1], nullptr);
    } else if (std::strcmp(tok[0], "map_Kd") == 0 && n >= 2) {
      m->materials[cur].texture = tok[1];
    }
  }
  std::fclose(f);
}

// Parse one face corner "v[/vt[/vn]]" with 1-based/negative indices.
Corner parse_corner(const char* s, size_t nv, size_t nt, size_t nn) {
  Corner c{-1, -1, -1};
  char* end;
  long v = std::strtol(s, &end, 10);
  c.v = static_cast<int32_t>(v > 0 ? v - 1 : static_cast<long>(nv) + v);
  if (*end == '/') {
    const char* p = end + 1;
    if (*p != '/' && *p) {
      long t = std::strtol(p, &end, 10);
      c.t = static_cast<int32_t>(t > 0 ? t - 1 : static_cast<long>(nt) + t);
      p = end;
    }
    if (*p == '/') {
      long nrm = std::strtol(p + 1, &end, 10);
      c.n = static_cast<int32_t>(nrm > 0 ? nrm - 1 : static_cast<long>(nn) + nrm);
    }
  }
  return c;
}

}  // namespace

extern "C" {

// Opaque handle API -----------------------------------------------------

void* tiray_obj_load(const char* path) {
  auto* m = new Mesh();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    m->error = "cannot open file";
    return m;
  }
  char line[8192];
  char* tok[256];
  int32_t cur_mat = -1;
  std::string base = dirname_of(path);

  while (std::fgets(line, sizeof(line), f)) {
    // keep a copy for mtllib filenames with spaces
    std::string raw(line);
    int n = tokenize(line, tok, 256);
    if (n == 0 || tok[0][0] == '#') continue;
    if (std::strcmp(tok[0], "v") == 0 && n >= 4) {
      for (int i = 0; i < 3; ++i) m->positions.push_back(std::strtof(tok[1 + i], nullptr));
    } else if (std::strcmp(tok[0], "vn") == 0 && n >= 4) {
      for (int i = 0; i < 3; ++i) m->normals.push_back(std::strtof(tok[1 + i], nullptr));
    } else if (std::strcmp(tok[0], "vt") == 0 && n >= 3) {
      for (int i = 0; i < 2; ++i) m->uvs.push_back(std::strtof(tok[1 + i], nullptr));
    } else if (std::strcmp(tok[0], "mtllib") == 0 && n >= 2) {
      size_t k = raw.find("mtllib");
      std::string name = raw.substr(k + 7);
      while (!name.empty() && (name.back() == '\n' || name.back() == '\r' ||
                               name.back() == ' '))
        name.pop_back();
      size_t s0 = name.find_first_not_of(" \t");
      if (s0 != std::string::npos) name = name.substr(s0);
      parse_mtl(m, base + "/" + name);
    } else if (std::strcmp(tok[0], "usemtl") == 0) {
      cur_mat = get_or_add_material(m, n >= 2 ? tok[1] : "");
    } else if (std::strcmp(tok[0], "f") == 0 && n >= 4) {
      if (cur_mat < 0) cur_mat = get_or_add_material(m, "__default__");
      size_t nv = m->positions.size() / 3;
      size_t nt = m->uvs.size() / 2;
      size_t nn = m->normals.size() / 3;
      Corner c0 = parse_corner(tok[1], nv, nt, nn);
      Corner prev = parse_corner(tok[2], nv, nt, nn);
      auto& out = m->faces_flat[cur_mat];
      for (int i = 3; i < n; ++i) {
        Corner cur = parse_corner(tok[i], nv, nt, nn);
        out.push_back(c0);
        out.push_back(prev);
        out.push_back(cur);
        prev = cur;
      }
    }
  }
  std::fclose(f);
  return m;
}

void tiray_obj_free(void* h) { delete static_cast<Mesh*>(h); }

const char* tiray_obj_error(void* h) {
  return static_cast<Mesh*>(h)->error.c_str();
}

int32_t tiray_obj_num_materials(void* h) {
  return static_cast<int32_t>(static_cast<Mesh*>(h)->materials.size());
}

int32_t tiray_obj_material_tris(void* h, int32_t mat) {
  return static_cast<int32_t>(static_cast<Mesh*>(h)->faces_flat[mat].size() / 3);
}

// Fill material scalar params: [Kd(3), Ke(3), Ns, Ni, d] -> out[9]
void tiray_obj_material_params(void* h, int32_t mat, float* out) {
  const Material& m = static_cast<Mesh*>(h)->materials[mat];
  std::memcpy(out + 0, m.diffuse, 3 * sizeof(float));
  std::memcpy(out + 3, m.emissive, 3 * sizeof(float));
  out[6] = m.shininess;
  out[7] = m.optical_density;
  out[8] = m.transparency;
}

const char* tiray_obj_material_name(void* h, int32_t mat) {
  return static_cast<Mesh*>(h)->materials[mat].name.c_str();
}

int32_t tiray_obj_material_has_texture(void* h, int32_t mat) {
  return static_cast<Mesh*>(h)->materials[mat].texture.empty() ? 0 : 1;
}

// Gather a material's triangle soup into caller buffers:
//   pos (T*9 floats), nrm (T*9), uv (T*6); missing attrs are zeros.
void tiray_obj_material_soup(void* h, int32_t mat, float* pos, float* nrm,
                             float* uv) {
  Mesh* m = static_cast<Mesh*>(h);
  const auto& corners = m->faces_flat[mat];
  size_t T = corners.size() / 3;
  size_t nvn = m->normals.size() / 3;
  size_t nvt = m->uvs.size() / 2;
  size_t nvp = m->positions.size() / 3;
  for (size_t t = 0; t < T; ++t) {
    for (int c = 0; c < 3; ++c) {
      const Corner& k = corners[3 * t + c];
      float* P = pos + 9 * t + 3 * c;
      if (k.v >= 0 && static_cast<size_t>(k.v) < nvp)
        std::memcpy(P, &m->positions[3 * k.v], 3 * sizeof(float));
      else
        P[0] = P[1] = P[2] = 0.f;
      float* N = nrm + 9 * t + 3 * c;
      if (k.n >= 0 && static_cast<size_t>(k.n) < nvn)
        std::memcpy(N, &m->normals[3 * k.n], 3 * sizeof(float));
      else
        N[0] = N[1] = N[2] = 0.f;
      float* U = uv + 6 * t + 2 * c;
      if (k.t >= 0 && static_cast<size_t>(k.t) < nvt)
        std::memcpy(U, &m->uvs[2 * k.t], 2 * sizeof(float));
      else
        U[0] = U[1] = 0.f;
    }
  }
}

// Morton codes (30-bit) for cluster/LBVH builds: centroids normalized by
// [lo, hi] per axis; out[i] = interleaved code (uint32).
void tiray_morton3d(const float* centroids, int64_t n, const float* lo,
                    const float* hi, uint32_t* out) {
  float inv[3];
  for (int a = 0; a < 3; ++a) {
    float span = hi[a] - lo[a];
    inv[a] = span > 1e-12f ? 1.0f / span : 0.0f;
  }
  auto expand = [](uint32_t x) {
    x = (x | (x << 16)) & 0x030000FFu;
    x = (x | (x << 8)) & 0x0300F00Fu;
    x = (x | (x << 4)) & 0x030C30C3u;
    x = (x | (x << 2)) & 0x09249249u;
    return x;
  };
  for (int64_t i = 0; i < n; ++i) {
    uint32_t q[3];
    for (int a = 0; a < 3; ++a) {
      float v = (centroids[3 * i + a] - lo[a]) * inv[a] * 1024.0f;
      if (v < 0.f) v = 0.f;
      if (v > 1023.f) v = 1023.f;
      q[a] = static_cast<uint32_t>(v);
    }
    out[i] = expand(q[0]) | (expand(q[1]) << 1) | (expand(q[2]) << 2);
  }
}

}  // extern "C"
