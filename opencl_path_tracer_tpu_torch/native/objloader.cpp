// Copy of opencl_path_tracer_tpu/native/objloader.cpp; only its build note differs.
// Fast OBJ/MTL loader (native host runtime component).
//
// The reference vendors tinyobjloader (tiny_obj_loader.h, 1922 LoC C++)
// and consumes it at main.cpp:552-617. This is a from-scratch loader with
// a C ABI for ctypes: it parses v/vn/vt/f/usemtl/mtllib/o/g, triangulates
// polygons with a fan, tracks per-face material ids (-1 before any
// usemtl, like tinyobj), and surfaces the standard MTL fields plus the
// reference's custom keys Kn/Kk/Tp (main.cpp:568-571) from the
// unknown-parameter namespace. Mirrors the semantics of the Python
// loader in io/obj.py; tests assert byte-equivalent output.
//
// Build: at first use by opencl_path_tracer_tpu_torch/native/__init__.py.

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Material {
  std::string name;
  float kd[3] = {0, 0, 0};
  float ks[3] = {0, 0, 0};
  float ke[3] = {0, 0, 0};
  float kn[3] = {0, 0, 0};   // custom: per-channel IOR
  float kk[3] = {0, 0, 0};   // custom: extinction
  float ns = 1.0f;
  int tp = -1;               // custom: material type
  int has_kn = 0, has_kk = 0, has_tp = 0;
};

struct Shape {
  std::string name;
  std::vector<int> v_idx;    // 3 per triangle
  std::vector<int> n_idx;
  std::vector<int> t_idx;
  std::vector<int> mat_ids;  // per triangle
  std::vector<int> nfv;      // original face vertex counts
};

struct Mesh {
  std::vector<float> vertices;   // 3 per vertex
  std::vector<float> normals;
  std::vector<float> texcoords;  // 2 per vt
  std::vector<Shape> shapes;
  std::vector<Material> materials;
  std::string error;
};

// Fast whitespace tokenizer over a mutable line buffer.
int tokenize(char* line, char** toks, int max_toks) {
  int n = 0;
  char* p = line;
  while (*p && n < max_toks) {
    while (*p && std::isspace((unsigned char)*p)) ++p;
    if (!*p) break;
    toks[n++] = p;
    while (*p && !std::isspace((unsigned char)*p)) ++p;
    if (*p) *p++ = '\0';
  }
  return n;
}

void parse_floats(char** toks, int ntoks, float* out, int n) {
  for (int i = 0; i < n; ++i)
    out[i] = (i < ntoks) ? std::strtof(toks[i], nullptr) : 0.0f;
}

void load_mtl(const std::string& path, Mesh* mesh,
              std::unordered_map<std::string, int>* name_to_id) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return;
  char line[4096];
  char* toks[64];
  Material* cur = nullptr;
  while (std::fgets(line, sizeof line, f)) {
    int n = tokenize(line, toks, 64);
    if (n == 0 || toks[0][0] == '#') continue;
    const char* key = toks[0];
    if (!std::strcmp(key, "newmtl")) {
      mesh->materials.emplace_back();
      cur = &mesh->materials.back();
      cur->name = n > 1 ? toks[1] : "";
      (*name_to_id)[cur->name] = (int)mesh->materials.size() - 1;
    } else if (!cur) {
      continue;
    } else if (!std::strcmp(key, "Kd")) {
      parse_floats(toks + 1, n - 1, cur->kd, 3);
    } else if (!std::strcmp(key, "Ks")) {
      parse_floats(toks + 1, n - 1, cur->ks, 3);
    } else if (!std::strcmp(key, "Ke")) {
      parse_floats(toks + 1, n - 1, cur->ke, 3);
    } else if (!std::strcmp(key, "Kn")) {
      parse_floats(toks + 1, n - 1, cur->kn, 3);
      cur->has_kn = 1;
    } else if (!std::strcmp(key, "Kk")) {
      parse_floats(toks + 1, n - 1, cur->kk, 3);
      cur->has_kk = 1;
    } else if (!std::strcmp(key, "Ns")) {
      cur->ns = n > 1 ? std::strtof(toks[1], nullptr) : 0.0f;
    } else if (!std::strcmp(key, "Tp")) {
      cur->tp = n > 1 ? std::atoi(toks[1]) : 0;
      cur->has_tp = 1;
    }
  }
  std::fclose(f);
}

// "v", "v/vt", "v//vn", "v/vt/vn"; negative = relative (OBJ spec).
void parse_face_token(const char* tok, int vc, int tc, int nc,
                      int* vi, int* ti, int* ni) {
  *vi = *ti = *ni = -1;
  int field = 0;
  const char* p = tok;
  while (*p && field < 3) {
    if (*p == '/') {
      ++field;
      ++p;
      continue;
    }
    long idx = std::strtol(p, (char**)&p, 10);
    int counts[3] = {vc, tc, nc};
    int val = idx > 0 ? (int)idx - 1 : counts[field] + (int)idx;
    if (field == 0) *vi = val;
    else if (field == 1) *ti = val;
    else *ni = val;
  }
}

}  // namespace

extern "C" {

void* ptx_load_obj(const char* path, const char* mtl_dir) {
  Mesh* mesh = new Mesh();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    mesh->error = std::string("cannot open ") + path;
    return mesh;
  }
  std::string dir = mtl_dir ? mtl_dir : "";
  if (dir.empty()) {
    std::string s(path);
    size_t k = s.find_last_of("/\\");
    dir = (k == std::string::npos) ? "." : s.substr(0, k);
  }

  std::unordered_map<std::string, int> mat_ids;
  Shape cur;
  int cur_mat = -1;
  char line[8192];
  char* toks[256];

  auto flush = [&]() {
    if (!cur.v_idx.empty()) mesh->shapes.push_back(std::move(cur));
    cur = Shape();
  };

  while (std::fgets(line, sizeof line, f)) {
    int n = tokenize(line, toks, 256);
    if (n == 0 || toks[0][0] == '#') continue;
    const char* key = toks[0];
    if (!std::strcmp(key, "v")) {
      float v[3];
      parse_floats(toks + 1, n - 1, v, 3);
      mesh->vertices.insert(mesh->vertices.end(), v, v + 3);
    } else if (!std::strcmp(key, "vn")) {
      float v[3];
      parse_floats(toks + 1, n - 1, v, 3);
      mesh->normals.insert(mesh->normals.end(), v, v + 3);
    } else if (!std::strcmp(key, "vt")) {
      float v[2];
      parse_floats(toks + 1, n - 1, v, 2);
      mesh->texcoords.insert(mesh->texcoords.end(), v, v + 2);
    } else if (!std::strcmp(key, "f")) {
      int vc = (int)mesh->vertices.size() / 3;
      int tc = (int)mesh->texcoords.size() / 2;
      int nc = (int)mesh->normals.size() / 3;
      int fv = n - 1;
      if (fv < 3) continue;
      std::vector<int> vi(fv), ti(fv), ni(fv);
      for (int i = 0; i < fv; ++i)
        parse_face_token(toks[1 + i], vc, tc, nc, &vi[i], &ti[i],
                         &ni[i]);
      cur.nfv.push_back(fv);
      for (int k = 1; k < fv - 1; ++k) {
        int order[3] = {0, k, k + 1};
        for (int j = 0; j < 3; ++j) {
          cur.v_idx.push_back(vi[order[j]]);
          cur.t_idx.push_back(ti[order[j]]);
          cur.n_idx.push_back(ni[order[j]]);
        }
        cur.mat_ids.push_back(cur_mat);
      }
    } else if (!std::strcmp(key, "o") || !std::strcmp(key, "g")) {
      flush();
      cur.name = n > 1 ? toks[1] : "";
    } else if (!std::strcmp(key, "usemtl")) {
      std::string name = n > 1 ? toks[1] : "";
      auto it = mat_ids.find(name);
      cur_mat = it == mat_ids.end() ? -1 : it->second;
    } else if (!std::strcmp(key, "mtllib")) {
      for (int i = 1; i < n; ++i)
        load_mtl(dir + "/" + toks[i], mesh, &mat_ids);
    }
  }
  flush();
  std::fclose(f);
  return mesh;
}

const char* ptx_mesh_error(void* m) {
  return ((Mesh*)m)->error.c_str();
}

void ptx_mesh_counts(void* m, int* nv, int* nn, int* nt, int* nshapes,
                     int* nmats) {
  Mesh* mesh = (Mesh*)m;
  *nv = (int)mesh->vertices.size() / 3;
  *nn = (int)mesh->normals.size() / 3;
  *nt = (int)mesh->texcoords.size() / 2;
  *nshapes = (int)mesh->shapes.size();
  *nmats = (int)mesh->materials.size();
}

void ptx_mesh_vertices(void* m, float* out) {
  Mesh* mesh = (Mesh*)m;
  std::memcpy(out, mesh->vertices.data(),
              mesh->vertices.size() * sizeof(float));
}

int ptx_shape_tri_count(void* m, int s) {
  return (int)((Mesh*)m)->shapes[s].mat_ids.size();
}

const char* ptx_shape_name(void* m, int s) {
  return ((Mesh*)m)->shapes[s].name.c_str();
}

// out_vidx: 3*T ints; out_mat: T ints.
void ptx_shape_indices(void* m, int s, int* out_vidx, int* out_mat) {
  Shape& sh = ((Mesh*)m)->shapes[s];
  std::memcpy(out_vidx, sh.v_idx.data(), sh.v_idx.size() * sizeof(int));
  std::memcpy(out_mat, sh.mat_ids.data(),
              sh.mat_ids.size() * sizeof(int));
}

const char* ptx_material_name(void* m, int i) {
  return ((Mesh*)m)->materials[i].name.c_str();
}

// floats: kd(3) ks(3) ke(3) kn(3) kk(3) ns -> 16 floats; ints: tp,
// has_kn, has_kk, has_tp -> 4 ints.
void ptx_material(void* m, int i, float* fout, int* iout) {
  Material& mat = ((Mesh*)m)->materials[i];
  std::memcpy(fout + 0, mat.kd, 3 * sizeof(float));
  std::memcpy(fout + 3, mat.ks, 3 * sizeof(float));
  std::memcpy(fout + 6, mat.ke, 3 * sizeof(float));
  std::memcpy(fout + 9, mat.kn, 3 * sizeof(float));
  std::memcpy(fout + 12, mat.kk, 3 * sizeof(float));
  fout[15] = mat.ns;
  iout[0] = mat.tp;
  iout[1] = mat.has_kn;
  iout[2] = mat.has_kk;
  iout[3] = mat.has_tp;
}

void ptx_mesh_free(void* m) { delete (Mesh*)m; }

}  // extern "C"
