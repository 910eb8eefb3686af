// Native scene renderer: ray-traced primitives with a z-buffer-free
// closest-hit loop. Replaces the reference's OpenGL/GLFW viewer
// (reference: src/deepmimic_env.py:527-538) for offscreen rgb_array
// rendering — no GL context needed, fast enough for eval videos.
//
// Supported geoms: plane(0, checkerboard), sphere(2), capsule(3),
// cylinder(5, drawn as capsule), box(6). Mesh geoms(7) should be
// passed as their proxy capsules by the caller.
//
// Build: g++ -O2 -fopenmp -shared -fPIC rasterizer.cpp -o librasterizer.so
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Vec3 {
    float x, y, z;
};

inline Vec3 v3(float x, float y, float z) { return {x, y, z}; }
inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(Vec3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(Vec3 a, Vec3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float norm(Vec3 a) { return std::sqrt(dot(a, a)); }
inline Vec3 normalize(Vec3 a) {
    float n = norm(a);
    return n > 1e-12f ? a * (1.0f / n) : v3(0, 0, 1);
}

struct Hit {
    float t;
    Vec3 n;
    int geom;
};

// ray-sphere
bool hit_sphere(Vec3 o, Vec3 d, Vec3 c, float r, float* t, Vec3* n) {
    Vec3 oc = o - c;
    float b = dot(oc, d);
    float cc = dot(oc, oc) - r * r;
    float disc = b * b - cc;
    if (disc < 0) return false;
    float s = std::sqrt(disc);
    float tt = -b - s;
    if (tt < 1e-4f) tt = -b + s;
    if (tt < 1e-4f) return false;
    *t = tt;
    *n = normalize(o + d * tt - c);
    return true;
}

// ray-capsule: segment p0..p1, radius r (cheap: sample closest approach)
bool hit_capsule(Vec3 o, Vec3 d, Vec3 p0, Vec3 p1, float r,
                 float* t, Vec3* n) {
    Vec3 ba = p1 - p0;
    Vec3 oa = o - p0;
    float baba = dot(ba, ba);
    float bard = dot(ba, d);
    float baoa = dot(ba, oa);
    float rdoa = dot(d, oa);
    float oaoa = dot(oa, oa);
    float a = baba - bard * bard;
    float b = baba * rdoa - baoa * bard;
    float c = baba * oaoa - baoa * baoa - r * r * baba;
    float h = b * b - a * c;
    if (h >= 0.0f) {
        float tt = (-b - std::sqrt(h)) / std::max(a, 1e-9f);
        float y = baoa + tt * bard;
        if (y > 0.0f && y < baba && tt > 1e-4f) {  // cylinder body
            *t = tt;
            Vec3 p = o + d * tt;
            Vec3 axis_pt = p0 + ba * (y / baba);
            *n = normalize(p - axis_pt);
            return true;
        }
    }
    // caps
    float t0, t1;
    Vec3 n0, n1;
    bool h0 = hit_sphere(o, d, p0, r, &t0, &n0);
    bool h1 = hit_sphere(o, d, p1, r, &t1, &n1);
    if (!h0 && !h1) return false;
    if (h0 && (!h1 || t0 < t1)) { *t = t0; *n = n0; } else { *t = t1; *n = n1; }
    return true;
}

// ray-box (oriented): rotate ray into box frame (R columns = axes)
bool hit_box(Vec3 o, Vec3 d, Vec3 c, const float* R, Vec3 half,
             float* t, Vec3* n) {
    // local = R^T (p - c)
    Vec3 rel = o - c;
    Vec3 lo = {dot(rel, v3(R[0], R[3], R[6])), dot(rel, v3(R[1], R[4], R[7])),
               dot(rel, v3(R[2], R[5], R[8]))};
    Vec3 ld = {dot(d, v3(R[0], R[3], R[6])), dot(d, v3(R[1], R[4], R[7])),
               dot(d, v3(R[2], R[5], R[8]))};
    float tmin = -1e30f, tmax = 1e30f;
    int axis = 0;
    float sgn = 1;
    const float lov[3] = {lo.x, lo.y, lo.z};
    const float ldv[3] = {ld.x, ld.y, ld.z};
    const float hv[3] = {half.x, half.y, half.z};
    for (int i = 0; i < 3; i++) {
        if (std::fabs(ldv[i]) < 1e-9f) {
            if (std::fabs(lov[i]) > hv[i]) return false;
            continue;
        }
        float inv = 1.0f / ldv[i];
        float t0 = (-hv[i] - lov[i]) * inv;
        float t1 = (hv[i] - lov[i]) * inv;
        float s = -1;
        if (t0 > t1) { std::swap(t0, t1); s = 1; }
        if (t0 > tmin) { tmin = t0; axis = i; sgn = s; }
        tmax = std::min(tmax, t1);
        if (tmin > tmax) return false;
    }
    if (tmin < 1e-4f) return false;
    *t = tmin;
    Vec3 ln = v3(0, 0, 0);
    if (axis == 0) ln.x = sgn;
    if (axis == 1) ln.y = sgn;
    if (axis == 2) ln.z = sgn;
    // world normal = R * ln
    *n = v3(R[0] * ln.x + R[1] * ln.y + R[2] * ln.z,
            R[3] * ln.x + R[4] * ln.y + R[5] * ln.z,
            R[6] * ln.x + R[7] * ln.y + R[8] * ln.z);
    return true;
}

// ray-triangle (Moller-Trumbore), one-sided culling off
bool hit_tri(Vec3 o, Vec3 d, const float* v0f, const float* v1f,
             const float* v2f, float* t, Vec3* n) {
    Vec3 v0 = v3(v0f[0], v0f[1], v0f[2]);
    Vec3 e1 = v3(v1f[0], v1f[1], v1f[2]) - v0;
    Vec3 e2 = v3(v2f[0], v2f[1], v2f[2]) - v0;
    Vec3 p = cross(d, e2);
    float det = dot(e1, p);
    if (std::fabs(det) < 1e-12f) return false;
    float inv = 1.0f / det;
    Vec3 s = o - v0;
    float u = dot(s, p) * inv;
    if (u < 0.0f || u > 1.0f) return false;
    Vec3 q = cross(s, e1);
    float v = dot(d, q) * inv;
    if (v < 0.0f || u + v > 1.0f) return false;
    float tt = dot(e2, q) * inv;
    if (tt < 1e-4f) return false;
    *t = tt;
    Vec3 nn = normalize(cross(e1, e2));
    if (dot(nn, d) > 0) nn = nn * -1.0f;  // face the camera
    *n = nn;
    return true;
}

// slab test against an axis-aligned box (in local frame) centered at 0
bool hit_aabb(Vec3 lo_, Vec3 ld, Vec3 half) {
    float tmin = -1e30f, tmax = 1e30f;
    const float lov[3] = {lo_.x, lo_.y, lo_.z};
    const float ldv[3] = {ld.x, ld.y, ld.z};
    const float hv[3] = {half.x, half.y, half.z};
    for (int i = 0; i < 3; i++) {
        if (std::fabs(ldv[i]) < 1e-9f) {
            if (std::fabs(lov[i]) > hv[i]) return false;
            continue;
        }
        float inv = 1.0f / ldv[i];
        float t0 = (-hv[i] - lov[i]) * inv;
        float t1 = (hv[i] - lov[i]) * inv;
        if (t0 > t1) std::swap(t0, t1);
        tmin = std::max(tmin, t0);
        tmax = std::min(tmax, t1);
        if (tmin > tmax) return false;
    }
    return tmax > 1e-4f;
}

// convex-hull mesh in the geom frame: AABB cull then brute-force tris
bool hit_mesh(Vec3 o, Vec3 d, Vec3 c, const float* R, const float* tris,
              int ntri, Vec3 aabb_half, float* t, Vec3* n) {
    Vec3 rel = o - c;
    Vec3 lo = {dot(rel, v3(R[0], R[3], R[6])), dot(rel, v3(R[1], R[4], R[7])),
               dot(rel, v3(R[2], R[5], R[8]))};
    Vec3 ld = {dot(d, v3(R[0], R[3], R[6])), dot(d, v3(R[1], R[4], R[7])),
               dot(d, v3(R[2], R[5], R[8]))};
    if (!hit_aabb(lo, ld, aabb_half)) return false;
    float best = 1e30f;
    Vec3 bn = v3(0, 0, 1);
    for (int i = 0; i < ntri; i++) {
        float tt;
        Vec3 nn;
        if (hit_tri(lo, ld, tris + 9 * i, tris + 9 * i + 3,
                    tris + 9 * i + 6, &tt, &nn) && tt < best) {
            best = tt;
            bn = nn;
        }
    }
    if (best >= 1e30f) return false;
    *t = best;
    // world normal = R * local normal
    *n = v3(R[0] * bn.x + R[1] * bn.y + R[2] * bn.z,
            R[3] * bn.x + R[4] * bn.y + R[5] * bn.z,
            R[6] * bn.x + R[7] * bn.y + R[8] * bn.z);
    return true;
}

}  // namespace

extern "C" {

// geom_type: MuJoCo enum (0 plane, 2 sphere, 3 capsule, 5 cylinder,
// 6 box, 7 mesh); anything else is skipped. Mesh geoms read their
// triangle soup (geom-frame coords) from tri_verts[9*tri_off[g] ..]
// with tri_cnt[g] triangles and an AABB half-extent in mesh_aabb[3g..]
// for early-out culling; pass tri_cnt=NULL to skip mesh support.
void render_scene_mesh(const float* geom_xpos, const float* geom_xmat,
                       const int32_t* geom_type, const float* geom_size,
                       const float* geom_rgba, int ngeom,
                       const float* tri_verts, const int32_t* tri_off,
                       const int32_t* tri_cnt, const float* mesh_aabb,
                       const float* cam_pos_in, const float* cam_target_in,
                       float fov_deg, int width, int height,
                       uint8_t* out_rgb) {
    Vec3 cam = v3(cam_pos_in[0], cam_pos_in[1], cam_pos_in[2]);
    Vec3 tgt = v3(cam_target_in[0], cam_target_in[1], cam_target_in[2]);
    Vec3 fwd = normalize(tgt - cam);
    Vec3 up0 = v3(0, 0, 1);
    Vec3 right = normalize(cross(fwd, up0));
    Vec3 up = cross(right, fwd);
    float aspect = (float)width / (float)height;
    float tanf2 = std::tan(fov_deg * 3.14159265f / 360.0f);
    Vec3 light = normalize(v3(-0.4f, 0.3f, 0.85f));

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
    for (int py = 0; py < height; py++) {
        for (int px = 0; px < width; px++) {
            float u = (2.0f * (px + 0.5f) / width - 1.0f) * tanf2 * aspect;
            float v = (1.0f - 2.0f * (py + 0.5f) / height) * tanf2;
            Vec3 d = normalize(fwd + right * u + up * v);

            float best_t = 1e30f;
            Vec3 best_n = v3(0, 0, 1);
            int best_g = -1;
            for (int g = 0; g < ngeom; g++) {
                const float* P = geom_xpos + 3 * g;
                const float* R = geom_xmat + 9 * g;
                const float* S = geom_size + 3 * g;
                Vec3 c = v3(P[0], P[1], P[2]);
                float t;
                Vec3 n;
                bool hit = false;
                switch (geom_type[g]) {
                    case 0: {  // plane: z=plane through c with normal R z
                        Vec3 pn = v3(R[2], R[5], R[8]);
                        float denom = dot(d, pn);
                        if (std::fabs(denom) > 1e-6f) {
                            t = dot(c - cam, pn) / denom;
                            if (t > 1e-4f) { n = pn; hit = true; }
                        }
                        break;
                    }
                    case 2:
                        hit = hit_sphere(cam, d, c, S[0], &t, &n);
                        break;
                    case 3:
                    case 5: {
                        Vec3 axis = v3(R[2], R[5], R[8]);
                        Vec3 p0 = c - axis * S[1];
                        Vec3 p1 = c + axis * S[1];
                        hit = hit_capsule(cam, d, p0, p1, S[0], &t, &n);
                        break;
                    }
                    case 6:
                        hit = hit_box(cam, d, c, R, v3(S[0], S[1], S[2]),
                                      &t, &n);
                        break;
                    case 7:
                        if (tri_cnt && tri_cnt[g] > 0) {
                            hit = hit_mesh(
                                cam, d, c, R, tri_verts + 9 * tri_off[g],
                                tri_cnt[g],
                                v3(mesh_aabb[3 * g], mesh_aabb[3 * g + 1],
                                   mesh_aabb[3 * g + 2]),
                                &t, &n);
                        }
                        break;
                    default:
                        break;
                }
                if (hit && t < best_t) {
                    best_t = t;
                    best_n = n;
                    best_g = g;
                }
            }

            float rcol, gcol, bcol;
            if (best_g < 0) {  // sky gradient
                float k = 0.5f + 0.5f * d.z;
                rcol = 0.55f + 0.25f * k;
                gcol = 0.70f + 0.20f * k;
                bcol = 0.90f;
            } else {
                const float* col = geom_rgba + 4 * best_g;
                float lam = std::max(dot(best_n, light), 0.0f);
                float shade = 0.35f + 0.65f * lam;
                rcol = col[0] * shade;
                gcol = col[1] * shade;
                bcol = col[2] * shade;
                if (geom_type[best_g] == 0) {  // checker
                    Vec3 p = cam + d * best_t;
                    int cx = (int)std::floor(p.x) + 1000;
                    int cy = (int)std::floor(p.y) + 1000;
                    float ck = ((cx + cy) & 1) ? 1.0f : 0.82f;
                    rcol *= ck;
                    gcol *= ck;
                    bcol *= ck;
                }
            }
            uint8_t* px_out = out_rgb + 3 * (py * width + px);
            px_out[0] = (uint8_t)std::min(255.0f, rcol * 255.0f);
            px_out[1] = (uint8_t)std::min(255.0f, gcol * 255.0f);
            px_out[2] = (uint8_t)std::min(255.0f, bcol * 255.0f);
        }
    }
}

// primitive-only entry point (meshes must be pre-substituted by proxy
// capsules by the caller)
void render_scene(const float* geom_xpos, const float* geom_xmat,
                  const int32_t* geom_type, const float* geom_size,
                  const float* geom_rgba, int ngeom,
                  const float* cam_pos_in, const float* cam_target_in,
                  float fov_deg, int width, int height,
                  uint8_t* out_rgb) {
    render_scene_mesh(geom_xpos, geom_xmat, geom_type, geom_size,
                      geom_rgba, ngeom, nullptr, nullptr, nullptr, nullptr,
                      cam_pos_in, cam_target_in, fov_deg, width, height,
                      out_rgb);
}

}  // extern "C"
