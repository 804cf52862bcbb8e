// Native scene-building kernels: OBJ parsing and binned-SAH BVH construction.
//
// The reference does its heavy host-side scene work in native code (Rust:
// world.rs mesh assembly, spatial/bvh.rs builder). Here the equivalents are
// C++ with a C ABI consumed from Python via ctypes; the Python versions in
// meshes.py / bvh.py remain as fallbacks.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libscene.so scene_build.cpp

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Binned-SAH BVH build (semantics of the reference's spatial/bvh.rs:36-155:
// 6 buckets over the largest centroid axis, cost = sum(area*count)/root_area,
// even-split fallback for degenerate axes), flattened depth-first with
// subtree-size skip links (bvh.rs:250-276).
//
// Inputs:  prim_min/prim_max: [count * 3] float32 AABBs
// Outputs (caller-allocated, capacity 2*count-1):
//   bbox_min/bbox_max: [nodes * 3], subtree_size: [nodes], prim_index: [nodes]
// Returns the number of nodes written, or -1 on error.
// ---------------------------------------------------------------------------

struct BuildPrim {
    float lo[3];
    float hi[3];
    float centroid[3];
    int32_t index;
};

struct Aabb {
    float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};

    void grow(const float* plo, const float* phi) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], plo[a]);
            hi[a] = std::max(hi[a], phi[a]);
        }
    }
    void grow_point(const float* p) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], p[a]);
            hi[a] = std::max(hi[a], p[a]);
        }
    }
    float area() const {
        float d[3] = {std::max(hi[0] - lo[0], 0.0f),
                      std::max(hi[1] - lo[1], 0.0f),
                      std::max(hi[2] - lo[2], 0.0f)};
        return 2.0f * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2]);
    }
};

static constexpr int kBuckets = 6;
static constexpr float kDistEpsilon = 1e-4f;

struct BvhOut {
    float* bbox_min;
    float* bbox_max;
    int32_t* subtree;
    int32_t* prim;
    int32_t cursor = 0;
};

// Emits the subtree over prims[first..last) depth-first; returns node count.
static int32_t build_range(std::vector<BuildPrim>& prims, int32_t first,
                           int32_t last, BvhOut& out) {
    const int32_t pos = out.cursor++;
    Aabb bounds;
    Aabb centroids;
    for (int32_t i = first; i < last; ++i) {
        bounds.grow(prims[i].lo, prims[i].hi);
        centroids.grow_point(prims[i].centroid);
    }
    std::memcpy(out.bbox_min + pos * 3, bounds.lo, 12);
    std::memcpy(out.bbox_max + pos * 3, bounds.hi, 12);

    if (last - first == 1) {
        out.subtree[pos] = 0;
        out.prim[pos] = prims[first].index;
        return 1;
    }
    out.prim[pos] = -1;

    int axis = 0;
    float extent = 0.0f;
    for (int a = 0; a < 3; ++a) {
        const float e = centroids.hi[a] - centroids.lo[a];
        if (e > extent) {
            extent = e;
            axis = a;
        }
    }

    int32_t mid;
    if (extent < kDistEpsilon) {
        mid = first + (last - first) / 2;  // degenerate: even split
    } else {
        // bucket stats
        int32_t counts[kBuckets] = {0};
        Aabb bucket_bounds[kBuckets];
        const float scale = kBuckets / extent;
        auto bucket_of = [&](const BuildPrim& p) {
            int b = static_cast<int>((p.centroid[axis] - centroids.lo[axis]) * scale);
            return std::min(b, kBuckets - 1);
        };
        for (int32_t i = first; i < last; ++i) {
            const int b = bucket_of(prims[i]);
            counts[b]++;
            bucket_bounds[b].grow(prims[i].lo, prims[i].hi);
        }
        // best split by SAH cost
        float best_cost = FLT_MAX;
        int best_split = 1;
        const float root_area = std::max(bounds.area(), 1e-30f);
        for (int split = 1; split < kBuckets; ++split) {
            Aabb left, right;
            int32_t cl = 0, cr = 0;
            for (int b = 0; b < split; ++b) {
                if (counts[b]) {
                    left.grow(bucket_bounds[b].lo, bucket_bounds[b].hi);
                    cl += counts[b];
                }
            }
            for (int b = split; b < kBuckets; ++b) {
                if (counts[b]) {
                    right.grow(bucket_bounds[b].lo, bucket_bounds[b].hi);
                    cr += counts[b];
                }
            }
            const float cost = ((cl ? left.area() * cl : 0.0f) +
                                (cr ? right.area() * cr : 0.0f)) /
                               root_area;
            if (cost < best_cost) {
                best_cost = cost;
                best_split = split;
            }
        }
        auto it = std::partition(
            prims.begin() + first, prims.begin() + last,
            [&](const BuildPrim& p) { return bucket_of(p) < best_split; });
        mid = static_cast<int32_t>(it - prims.begin());
        if (mid == first || mid == last) {
            // all prims landed on one side: fall back to a median split
            mid = first + (last - first) / 2;
            std::nth_element(prims.begin() + first, prims.begin() + mid,
                             prims.begin() + last,
                             [&](const BuildPrim& a, const BuildPrim& b) {
                                 return a.centroid[axis] < b.centroid[axis];
                             });
        }
    }

    const int32_t left_nodes = build_range(prims, first, mid, out);
    const int32_t right_nodes = build_range(prims, mid, last, out);
    out.subtree[pos] = left_nodes + right_nodes;
    return left_nodes + right_nodes + 1;
}

int32_t pyrite_build_bvh(const float* prim_min, const float* prim_max,
                         int32_t count, float* bbox_min, float* bbox_max,
                         int32_t* subtree, int32_t* prim_index) {
    if (count <= 0) return 0;
    std::vector<BuildPrim> prims(count);
    for (int32_t i = 0; i < count; ++i) {
        for (int a = 0; a < 3; ++a) {
            prims[i].lo[a] = prim_min[i * 3 + a];
            prims[i].hi[a] = prim_max[i * 3 + a];
            prims[i].centroid[a] = 0.5f * (prims[i].lo[a] + prims[i].hi[a]);
        }
        prims[i].index = i;
    }
    BvhOut out{bbox_min, bbox_max, subtree, prim_index};
    build_range(prims, 0, count, out);
    return out.cursor;
}

// ---------------------------------------------------------------------------
// OBJ parsing: positions / texcoords / normals plus triangle index triples
// grouped by object name. Two-call protocol:
//   1) pyrite_obj_load(path) -> handle (parses the file)
//   2) inspect counts, copy arrays out, free
// ---------------------------------------------------------------------------

struct ObjGroup {
    std::string name;
    std::vector<int64_t> faces;  // [tri][3 verts][3 indices v,vt,vn]
};

struct ObjFile {
    std::vector<float> positions;
    std::vector<float> texcoords;
    std::vector<float> normals;
    std::vector<ObjGroup> groups;
};

static int64_t parse_index(const char* tok, size_t len, int64_t count) {
    if (len == 0) return -1;
    const int64_t v = std::strtoll(std::string(tok, len).c_str(), nullptr, 10);
    return v > 0 ? v - 1 : count + v;
}

void* pyrite_obj_load(const char* path) {
    FILE* f = std::fopen(path, "r");
    if (!f) return nullptr;
    auto* obj = new ObjFile();
    obj->groups.push_back({"default", {}});

    char line[4096];
    while (std::fgets(line, sizeof(line), f)) {
        char* s = line;
        while (*s == ' ' || *s == '\t') ++s;
        if (s[0] == 'v' && s[1] == ' ') {
            float x = 0, y = 0, z = 0;
            std::sscanf(s + 2, "%f %f %f", &x, &y, &z);
            obj->positions.insert(obj->positions.end(), {x, y, z});
        } else if (s[0] == 'v' && s[1] == 't') {
            float u = 0, v = 0;
            std::sscanf(s + 3, "%f %f", &u, &v);
            obj->texcoords.insert(obj->texcoords.end(), {u, v});
        } else if (s[0] == 'v' && s[1] == 'n') {
            float x = 0, y = 0, z = 0;
            std::sscanf(s + 3, "%f %f %f", &x, &y, &z);
            obj->normals.insert(obj->normals.end(), {x, y, z});
        } else if ((s[0] == 'o' || s[0] == 'g') && (s[1] == ' ' || s[1] == '\t')) {
            char name[1024] = {0};
            std::sscanf(s + 2, "%1023s", name);
            obj->groups.push_back({name, {}});
        } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
            // split vertices; keep triangles only (reference world.rs:218-231)
            std::vector<std::string> verts;
            char* tok = std::strtok(s + 2, " \t\r\n");
            while (tok) {
                verts.emplace_back(tok);
                tok = std::strtok(nullptr, " \t\r\n");
            }
            if (verts.size() == 3) {
                auto& faces = obj->groups.back().faces;
                for (const auto& vert : verts) {
                    size_t p1 = vert.find('/');
                    size_t p2 = p1 == std::string::npos
                                    ? std::string::npos
                                    : vert.find('/', p1 + 1);
                    const int64_t nv =
                        static_cast<int64_t>(obj->positions.size() / 3);
                    const int64_t nt =
                        static_cast<int64_t>(obj->texcoords.size() / 2);
                    const int64_t nn =
                        static_cast<int64_t>(obj->normals.size() / 3);
                    int64_t vi = parse_index(vert.c_str(),
                                             p1 == std::string::npos ? vert.size() : p1,
                                             nv);
                    int64_t ti = -1, ni = -1;
                    if (p1 != std::string::npos) {
                        const size_t t_len =
                            (p2 == std::string::npos ? vert.size() : p2) - p1 - 1;
                        ti = parse_index(vert.c_str() + p1 + 1, t_len, nt);
                        if (p2 != std::string::npos) {
                            ni = parse_index(vert.c_str() + p2 + 1,
                                             vert.size() - p2 - 1, nn);
                        }
                    }
                    faces.insert(faces.end(), {vi, ti, ni});
                }
            }
        }
    }
    std::fclose(f);
    return obj;
}

void pyrite_obj_counts(void* handle, int64_t* out) {
    auto* obj = static_cast<ObjFile*>(handle);
    out[0] = static_cast<int64_t>(obj->positions.size() / 3);
    out[1] = static_cast<int64_t>(obj->texcoords.size() / 2);
    out[2] = static_cast<int64_t>(obj->normals.size() / 3);
    int64_t ngroups = 0;
    for (auto& g : obj->groups)
        if (!g.faces.empty()) ngroups++;
    out[3] = ngroups;
}

void pyrite_obj_vertices(void* handle, float* positions, float* texcoords,
                         float* normals) {
    auto* obj = static_cast<ObjFile*>(handle);
    std::memcpy(positions, obj->positions.data(),
                obj->positions.size() * sizeof(float));
    std::memcpy(texcoords, obj->texcoords.data(),
                obj->texcoords.size() * sizeof(float));
    std::memcpy(normals, obj->normals.data(),
                obj->normals.size() * sizeof(float));
}

int64_t pyrite_obj_group_info(void* handle, int64_t group, char* name,
                              int64_t name_cap) {
    auto* obj = static_cast<ObjFile*>(handle);
    int64_t seen = 0;
    for (auto& g : obj->groups) {
        if (g.faces.empty()) continue;
        if (seen == group) {
            std::snprintf(name, name_cap, "%s", g.name.c_str());
            return static_cast<int64_t>(g.faces.size() / 9);
        }
        seen++;
    }
    return -1;
}

void pyrite_obj_group_faces(void* handle, int64_t group, int64_t* faces) {
    auto* obj = static_cast<ObjFile*>(handle);
    int64_t seen = 0;
    for (auto& g : obj->groups) {
        if (g.faces.empty()) continue;
        if (seen == group) {
            std::memcpy(faces, g.faces.data(), g.faces.size() * sizeof(int64_t));
            return;
        }
        seen++;
    }
}

void pyrite_obj_free(void* handle) { delete static_cast<ObjFile*>(handle); }

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Clustered BVH build for wavefront traversal: identical SAH recursion, but
// recursion stops at <= leaf_size primitives; leaves store a contiguous range
// into the emitted primitive permutation. The traversal then alternates
// single-node AABB tests with dense (vectorizable) leaf sweeps — the right
// trade for a vector machine where incoherent per-node chases are expensive
// but 64-wide primitive tests are nearly free.
//
// Outputs (caller-allocated, capacity 2*ceil(count/1)-1):
//   bbox_min/bbox_max [nodes*3], subtree [nodes],
//   leaf_start [nodes] (-1 inner), leaf_count [nodes] (0 inner),
//   perm [count]: primitive permutation (leaf ranges index this order)
// ---------------------------------------------------------------------------

struct ClusterOut {
    float* bbox_min;
    float* bbox_max;
    int32_t* subtree;
    int32_t* leaf_start;
    int32_t* leaf_count;
    int32_t cursor = 0;
};

static int32_t build_cluster_range(std::vector<BuildPrim>& prims, int32_t first,
                                   int32_t last, int32_t leaf_size,
                                   ClusterOut& out) {
    const int32_t pos = out.cursor++;
    Aabb bounds;
    Aabb centroids;
    for (int32_t i = first; i < last; ++i) {
        bounds.grow(prims[i].lo, prims[i].hi);
        centroids.grow_point(prims[i].centroid);
    }
    std::memcpy(out.bbox_min + pos * 3, bounds.lo, 12);
    std::memcpy(out.bbox_max + pos * 3, bounds.hi, 12);

    if (last - first <= leaf_size) {
        out.subtree[pos] = 0;
        out.leaf_start[pos] = first;
        out.leaf_count[pos] = last - first;
        return 1;
    }
    out.leaf_start[pos] = -1;
    out.leaf_count[pos] = 0;

    int axis = 0;
    float extent = 0.0f;
    for (int a = 0; a < 3; ++a) {
        const float e = centroids.hi[a] - centroids.lo[a];
        if (e > extent) {
            extent = e;
            axis = a;
        }
    }

    int32_t mid;
    if (extent < kDistEpsilon) {
        mid = first + (last - first) / 2;
    } else {
        int32_t counts[kBuckets] = {0};
        Aabb bucket_bounds[kBuckets];
        const float scale = kBuckets / extent;
        auto bucket_of = [&](const BuildPrim& p) {
            int b = static_cast<int>((p.centroid[axis] - centroids.lo[axis]) * scale);
            return std::min(b, kBuckets - 1);
        };
        for (int32_t i = first; i < last; ++i) {
            const int b = bucket_of(prims[i]);
            counts[b]++;
            bucket_bounds[b].grow(prims[i].lo, prims[i].hi);
        }
        float best_cost = FLT_MAX;
        int best_split = 1;
        const float root_area = std::max(bounds.area(), 1e-30f);
        for (int split = 1; split < kBuckets; ++split) {
            Aabb left, right;
            int32_t cl = 0, cr = 0;
            for (int b = 0; b < split; ++b)
                if (counts[b]) {
                    left.grow(bucket_bounds[b].lo, bucket_bounds[b].hi);
                    cl += counts[b];
                }
            for (int b = split; b < kBuckets; ++b)
                if (counts[b]) {
                    right.grow(bucket_bounds[b].lo, bucket_bounds[b].hi);
                    cr += counts[b];
                }
            const float cost = ((cl ? left.area() * cl : 0.0f) +
                                (cr ? right.area() * cr : 0.0f)) /
                               root_area;
            if (cost < best_cost) {
                best_cost = cost;
                best_split = split;
            }
        }
        auto it = std::partition(
            prims.begin() + first, prims.begin() + last,
            [&](const BuildPrim& p) { return bucket_of(p) < best_split; });
        mid = static_cast<int32_t>(it - prims.begin());
        if (mid == first || mid == last) {
            mid = first + (last - first) / 2;
            std::nth_element(prims.begin() + first, prims.begin() + mid,
                             prims.begin() + last,
                             [&](const BuildPrim& a, const BuildPrim& b) {
                                 return a.centroid[axis] < b.centroid[axis];
                             });
        }
    }

    const int32_t left_nodes =
        build_cluster_range(prims, first, mid, leaf_size, out);
    const int32_t right_nodes =
        build_cluster_range(prims, mid, last, leaf_size, out);
    out.subtree[pos] = left_nodes + right_nodes;
    return left_nodes + right_nodes + 1;
}

int32_t pyrite_build_bvh_clustered(const float* prim_min, const float* prim_max,
                                   int32_t count, int32_t leaf_size,
                                   float* bbox_min, float* bbox_max,
                                   int32_t* subtree, int32_t* leaf_start,
                                   int32_t* leaf_count, int32_t* perm) {
    if (count <= 0) return 0;
    std::vector<BuildPrim> prims(count);
    for (int32_t i = 0; i < count; ++i) {
        for (int a = 0; a < 3; ++a) {
            prims[i].lo[a] = prim_min[i * 3 + a];
            prims[i].hi[a] = prim_max[i * 3 + a];
            prims[i].centroid[a] = 0.5f * (prims[i].lo[a] + prims[i].hi[a]);
        }
        prims[i].index = i;
    }
    ClusterOut out{bbox_min, bbox_max, subtree, leaf_start, leaf_count};
    build_cluster_range(prims, 0, count, leaf_size, out);
    for (int32_t i = 0; i < count; ++i) perm[i] = prims[i].index;
    return out.cursor;
}

}  // extern "C"
