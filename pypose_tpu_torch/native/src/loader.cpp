// Dataset tokenizers for pypose_tpu_torch: g2o pose graphs and BAL
// bundle-adjustment problems.
//
// Counterpart of pypose_tpu/native/src/loader.cpp.  A real BAL problem
// (trafalgar: 65,132 points, 225,911 observations) or a 100k-pose g2o
// graph takes seconds to tokenize in Python; here the whole file is read
// into one buffer and scanned with strtod/strtoll.  The C ABI is consumed
// through ctypes: a parse returns a handle that owns the arrays, a copy
// fills caller-allocated numpy buffers, and a free releases the handle.
// Unlike the reference's parse, a token that is not a number where one is
// expected, or a file that ends early, is an error (code -2), not a 0.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libppt_loader.so loader.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct G2O {
    std::vector<int64_t> vertex_ids;
    std::vector<double> vertices;   // 7 per vertex
    std::vector<int64_t> edges;     // 2 per edge
    std::vector<double> measures;   // 7 per edge
    std::vector<double> infos;      // 21 per edge (upper triangular)
};

struct BAL {
    std::vector<int64_t> cam_idx, pt_idx;
    std::vector<double> pixels;     // 2 per obs
    std::vector<double> cameras;    // 9 per cam
    std::vector<double> points;     // 3 per pt
};

class Scanner {
  public:
    explicit Scanner(const char* path) {
        FILE* f = std::fopen(path, "rb");
        if (!f) return;
        std::fseek(f, 0, SEEK_END);
        long n = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        if (n < 0) {
            std::fclose(f);
            return;
        }
        buf_.resize(static_cast<size_t>(n) + 1);
        size_t got = std::fread(buf_.data(), 1, static_cast<size_t>(n), f);
        buf_[got] = '\0';
        std::fclose(f);
        p_ = buf_.data();
        ok_ = true;
    }
    bool ok() const { return ok_; }
    // false once a number was expected and none was there
    bool good() const { return good_; }
    bool next_token(const char** tok, size_t* len) {
        while (*p_ == ' ' || *p_ == '\t' || *p_ == '\r' || *p_ == '\n')
            ++p_;
        if (*p_ == '\0') return false;
        const char* start = p_;
        while (*p_ && *p_ != ' ' && *p_ != '\t' && *p_ != '\r' &&
               *p_ != '\n')
            ++p_;
        *tok = start;
        *len = static_cast<size_t>(p_ - start);
        return true;
    }
    double next_double() {
        char* end = nullptr;
        double v = std::strtod(p_, &end);
        if (end == p_) good_ = false;
        p_ = end;
        return v;
    }
    int64_t next_int() {
        char* end = nullptr;
        long long v = std::strtoll(p_, &end, 10);
        if (end == p_) good_ = false;
        p_ = end;
        return static_cast<int64_t>(v);
    }
    // the rest of the current line: comments and other record types
    // (FIX, VERTEX_SE2, ...); a comment may itself name a record
    void skip_line() {
        while (*p_ && *p_ != '\n') ++p_;
    }

  private:
    std::vector<char> buf_;
    const char* p_ = nullptr;
    bool ok_ = false;
    bool good_ = true;
};

template <typename T>
void copy_out(T* dst, const std::vector<T>& src) {
    if (!src.empty()) std::memcpy(dst, src.data(), src.size() * sizeof(T));
}

}  // namespace

extern "C" {

// ---- g2o ------------------------------------------------------------------
// Returns a handle (null on error: *err = -1 unreadable, -2 malformed) and
// the vertex and edge counts.
void* ppt_g2o_parse(const char* path, int64_t* n_vertices, int64_t* n_edges,
                    int* err) {
    Scanner sc(path);
    if (!sc.ok()) {
        *err = -1;
        return nullptr;
    }
    auto* g = new G2O();
    const char* tok;
    size_t len;
    while (sc.good() && sc.next_token(&tok, &len)) {
        if (len == 15 && std::strncmp(tok, "VERTEX_SE3:QUAT", 15) == 0) {
            g->vertex_ids.push_back(sc.next_int());
            for (int i = 0; i < 7; ++i)
                g->vertices.push_back(sc.next_double());
        } else if (len == 13 && std::strncmp(tok, "EDGE_SE3:QUAT", 13) == 0) {
            g->edges.push_back(sc.next_int());
            g->edges.push_back(sc.next_int());
            for (int i = 0; i < 7; ++i)
                g->measures.push_back(sc.next_double());
            for (int i = 0; i < 21; ++i)
                g->infos.push_back(sc.next_double());
        } else {
            sc.skip_line();
        }
    }
    if (!sc.good()) {
        delete g;
        *err = -2;
        return nullptr;
    }
    *n_vertices = static_cast<int64_t>(g->vertex_ids.size());
    *n_edges = static_cast<int64_t>(g->edges.size() / 2);
    *err = 0;
    return g;
}

void ppt_g2o_copy(void* handle, int64_t* vertex_ids, double* vertices,
                  int64_t* edges, double* measures, double* infos) {
    const G2O* g = static_cast<const G2O*>(handle);
    copy_out(vertex_ids, g->vertex_ids);
    copy_out(vertices, g->vertices);
    copy_out(edges, g->edges);
    copy_out(measures, g->measures);
    copy_out(infos, g->infos);
}

void ppt_g2o_free(void* handle) { delete static_cast<G2O*>(handle); }

// ---- BAL ------------------------------------------------------------------
// Header ``C P O``; O lines ``cam pt u v``; 9 numbers a camera; 3 a point.
void* ppt_bal_parse(const char* path, int64_t* n_cams, int64_t* n_pts,
                    int64_t* n_obs, int* err) {
    Scanner sc(path);
    if (!sc.ok()) {
        *err = -1;
        return nullptr;
    }
    int64_t C = sc.next_int(), P = sc.next_int(), O = sc.next_int();
    if (!sc.good() || C < 0 || P < 0 || O < 0) {
        *err = -2;
        return nullptr;
    }
    auto* b = new BAL();
    b->cam_idx.reserve(O);
    b->pt_idx.reserve(O);
    b->pixels.reserve(2 * O);
    for (int64_t i = 0; i < O && sc.good(); ++i) {
        b->cam_idx.push_back(sc.next_int());
        b->pt_idx.push_back(sc.next_int());
        b->pixels.push_back(sc.next_double());
        b->pixels.push_back(sc.next_double());
    }
    b->cameras.reserve(9 * C);
    for (int64_t i = 0; i < 9 * C && sc.good(); ++i)
        b->cameras.push_back(sc.next_double());
    b->points.reserve(3 * P);
    for (int64_t i = 0; i < 3 * P && sc.good(); ++i)
        b->points.push_back(sc.next_double());
    if (!sc.good()) {
        delete b;
        *err = -2;
        return nullptr;
    }
    *n_cams = C;
    *n_pts = P;
    *n_obs = O;
    *err = 0;
    return b;
}

void ppt_bal_copy(void* handle, int64_t* cam_idx, int64_t* pt_idx,
                  double* pixels, double* cameras, double* points) {
    const BAL* b = static_cast<const BAL*>(handle);
    copy_out(cam_idx, b->cam_idx);
    copy_out(pt_idx, b->pt_idx);
    copy_out(pixels, b->pixels);
    copy_out(cameras, b->cameras);
    copy_out(points, b->points);
}

void ppt_bal_free(void* handle) { delete static_cast<BAL*>(handle); }

}  // extern "C"
