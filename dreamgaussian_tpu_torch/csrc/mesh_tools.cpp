// Native mesh toolchain: cleanup + quadric edge-collapse decimation.
//
// The port's own copy of dreamgaussian_tpu/native/mesh_tools.cpp (same
// algorithms), built and loaded by dreamgaussian_tpu_torch/native.py. It
// stands in for DreamGaussian's pymeshlab dependency: meshing is a host-side
// post-process, so it lives in C++. Exposed through a plain C ABI and
// loaded with ctypes — no pybind11 required.
//
// Components:
//  - weld_vertices: merge vertices closer than eps (uniform grid hash).
//  - clean_mesh: weld + drop degenerate faces + drop unreferenced verts +
//    drop connected components smaller than a fraction of the largest.
//  - decimate_mesh: Garland-Heckbert quadric edge collapse to a target
//    face count, with a simple link-condition check to preserve manifolds.
//  - laplacian_smooth: uniform-weight smoothing.
//  - isotropic_remesh: Botsch-Kobbelt split/collapse/flip/tangential-relax
//    toward a uniform target edge length (pymeshlab's
//    meshing_isotropic_explicit_remeshing, target length 0.015 in the
//    export).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <algorithm>
#include <array>
#include <functional>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3() = default;
  Vec3(double a, double b, double c) : x(a), y(b), z(c) {}
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
};

// Symmetric 4x4 quadric (10 coefficients) for v^T Q v error.
struct Quadric {
  double m[10] = {0};  // a2 ab ac ad b2 bc bd c2 cd d2
  void addPlane(double a, double b, double c, double d, double w = 1.0) {
    m[0] += w * a * a; m[1] += w * a * b; m[2] += w * a * c; m[3] += w * a * d;
    m[4] += w * b * b; m[5] += w * b * c; m[6] += w * b * d;
    m[7] += w * c * c; m[8] += w * c * d; m[9] += w * d * d;
  }
  void add(const Quadric& o) { for (int i = 0; i < 10; i++) m[i] += o.m[i]; }
  double eval(const Vec3& v) const {
    return m[0]*v.x*v.x + 2*m[1]*v.x*v.y + 2*m[2]*v.x*v.z + 2*m[3]*v.x
         + m[4]*v.y*v.y + 2*m[5]*v.y*v.z + 2*m[6]*v.y
         + m[7]*v.z*v.z + 2*m[8]*v.z + m[9];
  }
};

struct GridHash {
  double inv_cell;
  std::unordered_map<uint64_t, std::vector<int>> cells;
  explicit GridHash(double cell) : inv_cell(1.0 / cell) {}
  static uint64_t key(int64_t x, int64_t y, int64_t z) {
    uint64_t h = 1469598103934665603ull;
    for (int64_t v : {x, y, z}) {
      h ^= static_cast<uint64_t>(v) + 0x9e3779b97f4a7c15ull;
      h *= 1099511628211ull;
    }
    return h;
  }
  void insert(const Vec3& p, int idx) {
    cells[key(ll(p.x), ll(p.y), ll(p.z))].push_back(idx);
  }
  int64_t ll(double v) const { return (int64_t)std::floor(v * inv_cell); }
};

}  // namespace

extern "C" {

// Weld + degenerate-face removal + small-component removal.
// Returns 0 on success. Caller allocates out arrays at input sizes;
// out_nv/out_nf receive the reduced counts.
int clean_mesh(const double* verts, int nv, const int32_t* faces, int nf,
               double weld_eps, double min_comp_frac,
               double* out_verts, int32_t* out_nv,
               int32_t* out_faces, int32_t* out_nf) {
  std::vector<Vec3> V(nv);
  for (int i = 0; i < nv; i++) V[i] = {verts[3*i], verts[3*i+1], verts[3*i+2]};

  // 1. Weld: map each vertex to the first vertex within eps.
  std::vector<int> remap(nv);
  {
    GridHash grid(std::max(weld_eps, 1e-12));
    double eps2 = weld_eps * weld_eps;
    for (int i = 0; i < nv; i++) {
      int found = -1;
      int64_t cx = grid.ll(V[i].x), cy = grid.ll(V[i].y), cz = grid.ll(V[i].z);
      for (int64_t dx = -1; dx <= 1 && found < 0; dx++)
        for (int64_t dy = -1; dy <= 1 && found < 0; dy++)
          for (int64_t dz = -1; dz <= 1 && found < 0; dz++) {
            auto it = grid.cells.find(GridHash::key(cx+dx, cy+dy, cz+dz));
            if (it == grid.cells.end()) continue;
            for (int j : it->second) {
              Vec3 d = V[i] - V[j];
              if (d.dot(d) <= eps2) { found = j; break; }
            }
          }
      if (found < 0) { grid.insert(V[i], i); remap[i] = i; }
      else remap[i] = found;
    }
  }

  // 2. Remap faces, drop degenerates.
  std::vector<std::array<int,3>> F;
  F.reserve(nf);
  for (int i = 0; i < nf; i++) {
    int a = remap[faces[3*i]], b = remap[faces[3*i+1]], c = remap[faces[3*i+2]];
    if (a == b || b == c || a == c) continue;
    F.push_back({a, b, c});
  }

  // 3. Connected components over face adjacency (shared vertices).
  std::vector<int> comp(nv, -1);
  int ncomp = 0;
  {
    // union-find on vertices through faces
    std::vector<int> parent(nv);
    for (int i = 0; i < nv; i++) parent[i] = i;
    std::function<int(int)> find = [&](int x) {
      while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
      return x;
    };
    for (auto& f : F) {
      int a = find(f[0]), b = find(f[1]), c = find(f[2]);
      parent[b] = a; parent[c] = a;
    }
    std::unordered_map<int,int> roots;
    for (auto& f : F)
      for (int k = 0; k < 3; k++) {
        int r = find(f[k]);
        if (!roots.count(r)) roots[r] = ncomp++;
        comp[f[k]] = roots[r];
      }
    // face count per component
    std::vector<int64_t> csize(ncomp, 0);
    for (auto& f : F) csize[comp[f[0]]]++;
    int64_t biggest = 0;
    for (auto s : csize) biggest = std::max(biggest, s);
    int64_t thresh = (int64_t)(min_comp_frac * (double)biggest);
    std::vector<std::array<int,3>> F2;
    F2.reserve(F.size());
    for (auto& f : F)
      if (csize[comp[f[0]]] >= thresh) F2.push_back(f);
    F.swap(F2);
  }

  // 4. Drop unreferenced vertices + compact.
  std::vector<int> newid(nv, -1);
  int nv2 = 0;
  for (auto& f : F)
    for (int k = 0; k < 3; k++)
      if (newid[f[k]] < 0) newid[f[k]] = nv2++;
  for (int i = 0; i < nv; i++)
    if (newid[i] >= 0) {
      out_verts[3*newid[i]] = V[i].x;
      out_verts[3*newid[i]+1] = V[i].y;
      out_verts[3*newid[i]+2] = V[i].z;
    }
  for (size_t i = 0; i < F.size(); i++)
    for (int k = 0; k < 3; k++) out_faces[3*i+k] = newid[F[i][k]];
  *out_nv = nv2;
  *out_nf = (int32_t)F.size();
  return 0;
}

// Quadric edge-collapse decimation to ~target_faces.
int decimate_mesh(const double* verts, int nv, const int32_t* faces, int nf,
                  int target_faces,
                  double* out_verts, int32_t* out_nv,
                  int32_t* out_faces, int32_t* out_nf) {
  std::vector<Vec3> V(nv);
  for (int i = 0; i < nv; i++) V[i] = {verts[3*i], verts[3*i+1], verts[3*i+2]};
  std::vector<std::array<int,3>> F(nf);
  for (int i = 0; i < nf; i++) F[i] = {faces[3*i], faces[3*i+1], faces[3*i+2]};

  std::vector<Quadric> Q(nv);
  std::vector<std::unordered_set<int>> vfaces(nv);  // faces using vertex
  auto faceQuadric = [&](int fi) {
    auto& f = F[fi];
    Vec3 n = (V[f[1]] - V[f[0]]).cross(V[f[2]] - V[f[0]]);
    double area = 0.5 * n.norm();
    if (area < 1e-14) return;
    Vec3 un = n * (1.0 / n.norm());
    double d = -un.dot(V[f[0]]);
    Quadric q; q.addPlane(un.x, un.y, un.z, d, area);
    for (int k = 0; k < 3; k++) Q[f[k]].add(q);
  };
  for (int i = 0; i < nf; i++) {
    faceQuadric(i);
    for (int k = 0; k < 3; k++) vfaces[F[i][k]].insert(i);
  }

  // neighbor sets
  std::vector<std::unordered_set<int>> nbr(nv);
  for (auto& f : F)
    for (int k = 0; k < 3; k++) {
      nbr[f[k]].insert(f[(k+1)%3]);
      nbr[f[k]].insert(f[(k+2)%3]);
    }

  struct Cand { double cost; int u, v; uint64_t stamp; };
  struct CandCmp { bool operator()(const Cand& a, const Cand& b) const {
    return a.cost > b.cost; } };
  std::priority_queue<Cand, std::vector<Cand>, CandCmp> heap;
  std::vector<uint64_t> stamp(nv, 0);

  auto pushEdge = [&](int u, int v) {
    if (u > v) std::swap(u, v);
    Quadric q = Q[u]; q.add(Q[v]);
    // candidate positions: midpoint, u, v (skip 4x4 solve for robustness)
    Vec3 mid = (V[u] + V[v]) * 0.5;
    double cu = q.eval(V[u]), cv = q.eval(V[v]), cm = q.eval(mid);
    double c = std::min({cu, cv, cm});
    heap.push({c, u, v, stamp[u] + stamp[v]});
  };
  for (int u = 0; u < nv; u++)
    for (int v : nbr[u]) if (u < v) pushEdge(u, v);

  std::vector<bool> vdead(nv, false), fdead(nf, false);
  int alive_faces = nf;

  auto collapse = [&](int u, int v) {
    // target position
    Quadric q = Q[u]; q.add(Q[v]);
    Vec3 mid = (V[u] + V[v]) * 0.5;
    double cu = q.eval(V[u]), cv = q.eval(V[v]), cm = q.eval(mid);
    Vec3 pos = (cm <= cu && cm <= cv) ? mid : (cu <= cv ? V[u] : V[v]);
    V[u] = pos;
    Q[u] = q;
    vdead[v] = true;
    // faces of v: retarget or kill
    for (int fi : std::vector<int>(vfaces[v].begin(), vfaces[v].end())) {
      if (fdead[fi]) continue;
      auto& f = F[fi];
      bool hasU = (f[0] == u || f[1] == u || f[2] == u);
      for (int k = 0; k < 3; k++) if (f[k] == v) f[k] = u;
      if (hasU || f[0] == f[1] || f[1] == f[2] || f[0] == f[2]) {
        fdead[fi] = true; alive_faces--;
        for (int k = 0; k < 3; k++) vfaces[f[k]].erase(fi);
        continue;
      }
      vfaces[u].insert(fi);
    }
    // merge neighbors
    for (int w : nbr[v]) {
      if (w == u || vdead[w]) continue;
      nbr[w].erase(v); nbr[w].insert(u); nbr[u].insert(w);
    }
    nbr[u].erase(v);
    stamp[u]++;
    for (int w : nbr[u]) if (!vdead[w]) pushEdge(u, w);
  };

  while (alive_faces > target_faces && !heap.empty()) {
    Cand c = heap.top(); heap.pop();
    int u = c.u, v = c.v;
    if (vdead[u] || vdead[v]) continue;
    if (c.stamp != stamp[u] + stamp[v]) continue;  // stale
    if (!nbr[u].count(v)) continue;
    // link condition: shared neighbors must be exactly the wing vertices
    int shared = 0;
    for (int w : nbr[u]) if (nbr[v].count(w)) shared++;
    if (shared > 2) continue;  // would pinch the mesh
    collapse(u, v);
  }

  // compact
  std::vector<int> newid(nv, -1);
  int nv2 = 0;
  int nf2 = 0;
  for (int i = 0; i < nf; i++) {
    if (fdead[i]) continue;
    for (int k = 0; k < 3; k++) {
      int& vid = F[i][k];
      if (newid[vid] < 0) {
        newid[vid] = nv2++;
        out_verts[3*newid[vid]] = V[vid].x;
        out_verts[3*newid[vid]+1] = V[vid].y;
        out_verts[3*newid[vid]+2] = V[vid].z;
      }
    }
    out_faces[3*nf2] = newid[F[i][0]];
    out_faces[3*nf2+1] = newid[F[i][1]];
    out_faces[3*nf2+2] = newid[F[i][2]];
    nf2++;
  }
  *out_nv = nv2;
  *out_nf = nf2;
  return 0;
}

// Uniform Laplacian smoothing, n_iter passes with factor lam.
int laplacian_smooth(double* verts, int nv, const int32_t* faces, int nf,
                     int n_iter, double lam) {
  std::vector<std::vector<int>> nbr(nv);
  {
    std::vector<std::unordered_set<int>> s(nv);
    for (int i = 0; i < nf; i++)
      for (int k = 0; k < 3; k++) {
        int a = faces[3*i+k], b = faces[3*i+(k+1)%3];
        s[a].insert(b); s[b].insert(a);
      }
    for (int i = 0; i < nv; i++) nbr[i].assign(s[i].begin(), s[i].end());
  }
  std::vector<double> nv_pos(3 * nv);
  for (int it = 0; it < n_iter; it++) {
    for (int i = 0; i < nv; i++) {
      if (nbr[i].empty()) {
        for (int d = 0; d < 3; d++) nv_pos[3*i+d] = verts[3*i+d];
        continue;
      }
      double acc[3] = {0, 0, 0};
      for (int j : nbr[i])
        for (int d = 0; d < 3; d++) acc[d] += verts[3*j+d];
      for (int d = 0; d < 3; d++) {
        double mean = acc[d] / (double)nbr[i].size();
        nv_pos[3*i+d] = verts[3*i+d] + lam * (mean - verts[3*i+d]);
      }
    }
    std::memcpy(verts, nv_pos.data(), sizeof(double) * 3 * nv);
  }
  return 0;
}

// Isotropic explicit remeshing (Botsch & Kobbelt 2004): per iteration,
// (1) split edges > 4/3 L at their midpoint, (2) collapse edges < 4/5 L
// when manifold-safe and not creating overlong edges, (3) flip edges
// that reduce the squared deviation of vertex valences from 6, (4) move
// each vertex toward its neighbor centroid WITHIN its tangent plane.
// Caller provides output capacities; splitting stops when they would
// be exceeded (the python wrapper sizes them from the target length).
int isotropic_remesh(const double* verts, int nv_in, const int32_t* faces,
                     int nf_in, double target_len, int n_iter,
                     double* out_verts, int32_t cap_v, int32_t* out_nv,
                     int32_t* out_faces, int32_t cap_f, int32_t* out_nf) {
  std::vector<Vec3> V(nv_in);
  for (int i = 0; i < nv_in; i++)
    V[i] = {verts[3*i], verts[3*i+1], verts[3*i+2]};
  std::vector<std::array<int,3>> F(nf_in);
  for (int i = 0; i < nf_in; i++)
    F[i] = {faces[3*i], faces[3*i+1], faces[3*i+2]};
  std::vector<bool> fdead(nf_in, false);
  const double hi = 4.0 / 3.0 * target_len, hi2 = hi * hi;
  const double lo = 4.0 / 5.0 * target_len, lo2 = lo * lo;

  auto ekey = [](int a, int b) -> uint64_t {
    if (a > b) std::swap(a, b);
    return ((uint64_t)a << 32) | (uint32_t)b;
  };

  for (int iter = 0; iter < n_iter; iter++) {
    // ---- 1. splits -------------------------------------------------
    {
      fdead.resize(F.size(), false);
      // edge -> adjacent face list (<= 2 for manifold edges)
      std::unordered_map<uint64_t, std::vector<int>> e2f;
      for (size_t fi = 0; fi < F.size(); fi++) {
        if (fdead[fi]) continue;
        for (int k = 0; k < 3; k++)
          e2f[ekey(F[fi][k], F[fi][(k+1)%3])].push_back((int)fi);
      }
      std::vector<bool> ftouched(F.size(), false);
      for (auto& kv : e2f) {
        int a = (int)(kv.first >> 32), b = (int)(uint32_t)kv.first;
        Vec3 d = V[a] - V[b];
        if (d.dot(d) <= hi2) continue;
        bool skip = false;
        for (int fi : kv.second)
          if (fdead[fi] || ftouched[fi]) { skip = true; break; }
        if (skip) continue;
        if ((int)V.size() + 1 > cap_v ||
            (int)F.size() + (int)kv.second.size() > cap_f) continue;
        int m = (int)V.size();
        V.push_back((V[a] + V[b]) * 0.5);
        for (int fi : kv.second) {
          auto f = F[fi];
          fdead[fi] = true;
          ftouched[fi] = true;
          // split f into (x, a, m) + (x, m, b) preserving orientation
          for (int k = 0; k < 3; k++) {
            int u = f[k], v = f[(k+1)%3], w = f[(k+2)%3];
            if ((u == a && v == b) || (u == b && v == a)) {
              F.push_back({u, m, w});
              F.push_back({m, v, w});
              fdead.push_back(false); fdead.push_back(false);
              ftouched.push_back(true); ftouched.push_back(true);
              break;
            }
          }
        }
      }
    }
    // ---- 2. collapses ----------------------------------------------
    {
      int nv = (int)V.size();
      std::vector<bool> vdead(nv, false), vtouched(nv, false);
      std::vector<std::unordered_set<int>> nbrs(nv);
      std::vector<std::vector<int>> vf(nv);
      for (size_t fi = 0; fi < F.size(); fi++) {
        if (fdead[fi]) continue;
        for (int k = 0; k < 3; k++) {
          nbrs[F[fi][k]].insert(F[fi][(k+1)%3]);
          nbrs[F[fi][k]].insert(F[fi][(k+2)%3]);
          vf[F[fi][k]].push_back((int)fi);
        }
      }
      for (int u = 0; u < nv; u++) {
        if (vdead[u] || vtouched[u]) continue;
        for (int v : std::vector<int>(nbrs[u].begin(), nbrs[u].end())) {
          if (v <= u || vdead[v] || vtouched[v]) continue;
          Vec3 d = V[u] - V[v];
          if (d.dot(d) >= lo2) continue;
          // link condition
          int shared = 0;
          for (int w : nbrs[u]) if (nbrs[v].count(w)) shared++;
          if (shared > 2) continue;
          // no overlong result edges from the midpoint
          Vec3 mid = (V[u] + V[v]) * 0.5;
          bool bad = false;
          for (int w : nbrs[u]) { Vec3 e = V[w] - mid;
            if (w != v && e.dot(e) > hi2) { bad = true; break; } }
          for (int w : nbrs[v]) { Vec3 e = V[w] - mid;
            if (!bad && w != u && e.dot(e) > hi2) { bad = true; } }
          if (bad) continue;
          // collapse v into u at midpoint
          V[u] = mid;
          vdead[v] = true;
          vtouched[u] = true;
          for (int fi : vf[v]) {
            if (fdead[fi]) continue;
            auto& f = F[fi];
            bool hasU = (f[0]==u || f[1]==u || f[2]==u);
            for (int k = 0; k < 3; k++) if (f[k] == v) f[k] = u;
            if (hasU || f[0]==f[1] || f[1]==f[2] || f[0]==f[2])
              fdead[fi] = true;
            else vf[u].push_back(fi);
          }
          for (int w : nbrs[v]) {
            if (w == u || vdead[w]) continue;
            nbrs[w].erase(v); nbrs[w].insert(u); nbrs[u].insert(w);
            vtouched[w] = true;
          }
          nbrs[u].erase(v);
          break;  // one collapse per u per pass
        }
      }
    }
    // ---- 3. valence flips ------------------------------------------
    {
      std::unordered_map<uint64_t, std::vector<std::pair<int,int>>> e2f;
      std::vector<int> val((int)V.size(), 0);
      std::unordered_set<uint64_t> edges;
      for (size_t fi = 0; fi < F.size(); fi++) {
        if (fdead[fi]) continue;
        for (int k = 0; k < 3; k++) {
          e2f[ekey(F[fi][k], F[fi][(k+1)%3])].push_back({(int)fi, k});
          edges.insert(ekey(F[fi][k], F[fi][(k+1)%3]));
        }
      }
      for (auto e : edges) {
        int a = (int)(e >> 32), b = (int)(uint32_t)e;
        val[a]++; val[b]++;
      }
      std::vector<bool> ftouched(F.size(), false);
      auto dev = [](int v) { return (v - 6) * (v - 6); };
      for (auto& kv : e2f) {
        if (kv.second.size() != 2) continue;
        auto [f1, k1] = kv.second[0];
        auto [f2, k2] = kv.second[1];
        if (fdead[f1] || fdead[f2] || ftouched[f1] || ftouched[f2]) continue;
        int a = F[f1][k1], b = F[f1][(k1+1)%3];
        int c = F[f1][(k1+2)%3];            // wing in f1
        int d = -1;                          // wing in f2
        for (int k = 0; k < 3; k++)
          if (F[f2][k] != a && F[f2][k] != b) d = F[f2][k];
        if (d < 0 || c == d) continue;
        if (edges.count(ekey(c, d))) continue;  // flipped edge exists
        int before = dev(val[a]) + dev(val[b]) + dev(val[c]) + dev(val[d]);
        int after = dev(val[a]-1) + dev(val[b]-1) + dev(val[c]+1)
                  + dev(val[d]+1);
        if (after >= before) continue;
        // orientation-preserving flip: f1=(a,b,c) -> (a,d,c),
        // f2 (contains b,a) -> (b,c,d) ... rebuild explicitly:
        F[f1] = {c, a, d};
        F[f2] = {d, b, c};
        ftouched[f1] = ftouched[f2] = true;
        val[a]--; val[b]--; val[c]++; val[d]++;
        edges.erase(ekey(a, b));
        edges.insert(ekey(c, d));
      }
    }
    // ---- 4. tangential relaxation ----------------------------------
    {
      int nv = (int)V.size();
      std::vector<Vec3> centroid(nv), nrm(nv);
      std::vector<int> cnt(nv, 0);
      for (size_t fi = 0; fi < F.size(); fi++) {
        if (fdead[fi]) continue;
        auto& f = F[fi];
        Vec3 n = (V[f[1]] - V[f[0]]).cross(V[f[2]] - V[f[0]]);
        for (int k = 0; k < 3; k++) {
          nrm[f[k]] = nrm[f[k]] + n;
          centroid[f[k]] = centroid[f[k]] + V[f[(k+1)%3]] + V[f[(k+2)%3]];
          cnt[f[k]] += 2;
        }
      }
      for (int i = 0; i < nv; i++) {
        if (cnt[i] == 0) continue;
        Vec3 c = centroid[i] * (1.0 / cnt[i]);
        Vec3 n = nrm[i];
        double nn = n.dot(n);
        Vec3 g = c - V[i];
        if (nn > 1e-24) g = g - n * (g.dot(n) / nn);
        V[i] = V[i] + g * 0.5;
      }
    }
  }

  // compact
  int nv2 = 0, nf2 = 0;
  std::vector<int> newid((int)V.size(), -1);
  for (size_t fi = 0; fi < F.size(); fi++) {
    if (fdead[fi]) continue;
    if (nf2 >= cap_f) break;
    for (int k = 0; k < 3; k++) {
      int vid = F[fi][k];
      if (newid[vid] < 0) {
        if (nv2 >= cap_v) return 1;
        newid[vid] = nv2++;
        out_verts[3*newid[vid]] = V[vid].x;
        out_verts[3*newid[vid]+1] = V[vid].y;
        out_verts[3*newid[vid]+2] = V[vid].z;
      }
      out_faces[3*nf2+k] = newid[vid];
    }
    nf2++;
  }
  *out_nv = nv2;
  *out_nf = nf2;
  return 0;
}

}  // extern "C"
