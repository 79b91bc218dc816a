// Copy of tpurt/native/objparse.cpp, unchanged; tpurt_torch/native builds it
// into its own _build/ directory.
//
// Native Wavefront-OBJ fast path — semantics-exact twin of
// tpurt/io/obj.load_mesh's parsing loop.
//
// Replicated exactly (tests/test_native_obj.py pins array equality
// against the Python parser on fixtures and adversarial files):
//   * only lines starting "v ", "vn ", "f " are records (the Python
//     startswith checks — "v\t" is NOT a vertex record there either);
//   * whitespace-run token splitting;
//   * numbers via strtod (Python's float() also parses to the nearest
//     double, so values are bit-identical; vertices stay f64);
//   * OBJ 1-based indices, negatives resolved against the CURRENT
//     vertex/normal count (interleaved v/f blocks matter);
//   * polygon fan triangulation (0, k, k+1);
//   * a face corner's vn comes only from an i/j/k or i//k triple with a
//     non-empty third field; face_vn rows exist only when all three
//     corners have one, and ANY incomplete triangle clears the global
//     all_vn flag (the A.5 all-or-nothing rule lives in Python).
//
// Any malformed record makes the parse return nonzero, and the caller
// falls back to the pure-Python parser — which raises the same
// exception the old code would have (the native path never changes
// error behavior, only speed).
//
// Build: g++ -O2 -shared -fPIC -o _objparse.so objparse.cpp

#include <cctype>
#include <cstdlib>
#include <cstring>

namespace {

struct Cursor {
    const char* p;
    const char* end;
};

inline bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\f' || c == '\v';
}

// advance to the next line start (past '\n'); returns false at EOF
inline bool next_line(Cursor& c) {
    while (c.p < c.end && *c.p != '\n') ++c.p;
    if (c.p < c.end) ++c.p;
    return c.p < c.end;
}

// skip spaces within a line; false if line (or buffer) ended
inline bool skip_ws(Cursor& c) {
    while (c.p < c.end && is_space(*c.p)) ++c.p;
    return c.p < c.end && *c.p != '\n';
}

inline bool parse_double(Cursor& c, double* out) {
    if (!skip_ws(c)) return false;
    char* e = nullptr;
    *out = strtod(c.p, &e);
    if (e == c.p) return false;
    c.p = e;
    return true;
}

// one face token: i[/j[/k]]; *vn = -(1<<60) marks "no vn field"
inline bool parse_corner(Cursor& c, long long nv, long long nn,
                         long long* v, long long* vn) {
    char* e = nullptr;
    long long i = strtoll(c.p, &e, 10);
    if (e == c.p) return false;
    c.p = e;
    *v = i > 0 ? i - 1 : nv + i;
    *vn = -(1LL << 60);
    if (c.p < c.end && *c.p == '/') {
        ++c.p;  // texture field (ignored)
        while (c.p < c.end && *c.p != '/' && *c.p != '\n'
               && !is_space(*c.p))
            ++c.p;
        if (c.p < c.end && *c.p == '/') {
            ++c.p;
            long long n = strtoll(c.p, &e, 10);
            if (e != c.p) {  // non-empty third field
                c.p = e;
                *vn = n > 0 ? n - 1 : nn + n;
            }
        }
    }
    // token must end at whitespace / newline / EOF
    return c.p >= c.end || *c.p == '\n' || is_space(*c.p);
}

inline int record_kind(const Cursor& c) {
    // exact startswith("v ") / ("vn ") / ("f ")
    long long left = c.end - c.p;
    if (left >= 2 && c.p[0] == 'f' && c.p[1] == ' ') return 2;
    if (left >= 2 && c.p[0] == 'v' && c.p[1] == ' ') return 0;
    if (left >= 3 && c.p[0] == 'v' && c.p[1] == 'n' && c.p[2] == ' ')
        return 1;
    return -1;
}

}  // namespace

extern "C" {

// Pass 1: count records. ntri counts fan triangles. Returns 0 on
// success (counting never fails: malformed records surface in pass 2).
long long obj_count(const char* buf, long long len, long long* nv,
                    long long* nn, long long* ntri) {
    Cursor c{buf, buf + len};
    *nv = *nn = *ntri = 0;
    if (len == 0) return 0;
    bool more = true;
    while (more) {
        int kind = record_kind(c);
        if (kind == 0) {
            ++*nv;
        } else if (kind == 1) {
            ++*nn;
        } else if (kind == 2) {
            c.p += 2;
            long long corners = 0;
            while (skip_ws(c)) {
                ++corners;
                while (c.p < c.end && !is_space(*c.p) && *c.p != '\n')
                    ++c.p;
            }
            if (corners >= 3) *ntri += corners - 2;
        }
        more = next_line(c);
    }
    return 0;
}

// Pass 2: fill caller-allocated arrays (sizes from obj_count).
// face_vn rows get -1 on triangles lacking full vn; *all_vn clears on
// any such triangle. Returns 0 ok, nonzero = malformed (caller falls
// back to the Python parser for identical error behavior).
long long obj_parse(const char* buf, long long len, double* verts,
                    double* norms, long long* faces, long long* face_vn,
                    long long* all_vn) {
    Cursor c{buf, buf + len};
    long long nv = 0, nn = 0, nt = 0;
    *all_vn = 1;
    if (len == 0) return 1;  // Python raises "no faces" — let it
    bool more = true;
    while (more) {
        int kind = record_kind(c);
        if (kind == 0) {
            c.p += 2;
            for (int k = 0; k < 3; ++k)
                if (!parse_double(c, verts + nv * 3 + k)) return 2;
            ++nv;
        } else if (kind == 1) {
            c.p += 3;
            for (int k = 0; k < 3; ++k)
                if (!parse_double(c, norms + nn * 3 + k)) return 3;
            ++nn;
        } else if (kind == 2) {
            c.p += 2;
            long long v[64], n[64];  // fan corners (clamped below)
            long long cnt = 0;
            while (skip_ws(c)) {
                if (cnt >= 64) return 4;  // absurd polygon: fallback
                if (!parse_corner(c, nv, nn, &v[cnt], &n[cnt])) return 5;
                ++cnt;
            }
            if (cnt < 3) return 6;  // Python appends no tri but also no
            // error... (a 2-corner face is silently a no-op there) —
            // handled below by falling back, which reproduces it.
            for (long long k = 1; k + 1 < cnt; ++k) {
                faces[nt * 3 + 0] = v[0];
                faces[nt * 3 + 1] = v[k];
                faces[nt * 3 + 2] = v[k + 1];
                bool has = n[0] != -(1LL << 60) && n[k] != -(1LL << 60)
                           && n[k + 1] != -(1LL << 60);
                if (has) {
                    face_vn[nt * 3 + 0] = n[0];
                    face_vn[nt * 3 + 1] = n[k];
                    face_vn[nt * 3 + 2] = n[k + 1];
                } else {
                    face_vn[nt * 3 + 0] = face_vn[nt * 3 + 1] =
                        face_vn[nt * 3 + 2] = -1;
                    *all_vn = 0;
                }
                ++nt;
            }
        }
        more = next_line(c);
    }
    if (nt == 0) return 7;  // Python raises ValueError — let it
    return 0;
}

}  // extern "C"
