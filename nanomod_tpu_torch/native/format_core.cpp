// Threaded sign-test / meanstd text formatter.
//
// The reference writes its results table one interpreted-Python %-format
// line at a time (ref bin/scripts/myDetect.py:522-545); at E. coli scale
// (9M positions x 14 columns) that is ~40 s of pure formatting.  This core
// renders the identical bytes with snprintf across threads (~10x).
//
// Byte-compat notes vs CPython's %-formatting (which generated the golden
// fixtures): both produce correctly-rounded fixed-precision decimal, both
// print >=2 exponent digits for %E; CPython renders every NaN as
// "nan"/"NAN" REGARDLESS of sign while glibc prints "-nan" for negative
// NaN, so non-finite values are special-cased.  Parity is pinned by
// tests/test_detect_e2e.py::test_native_formatter_parity over adversarial
// values and by the golden byte tests.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// %.3f with CPython NaN/inf rendering
inline int fmt_f(char* out, double v) {
    if (std::isnan(v)) { std::memcpy(out, "nan", 3); return 3; }
    if (std::isinf(v)) {
        if (v < 0) { std::memcpy(out, "-inf", 4); return 4; }
        std::memcpy(out, "inf", 3); return 3;
    }
    return std::snprintf(out, 512, "%.3f", v);  // FLOAT_MAX -> ~315 chars
}

// %.3E with CPython NaN/inf rendering
inline int fmt_e(char* out, double v) {
    if (std::isnan(v)) { std::memcpy(out, "NAN", 3); return 3; }
    if (std::isinf(v)) {
        if (v < 0) { std::memcpy(out, "-INF", 4); return 4; }
        std::memcpy(out, "INF", 3); return 3;
    }
    return std::snprintf(out, 64, "%.3E", v);   // <= ~13 chars
}

struct Row {
    // shared column pointers
    const char* const* prefixes;   // per-key "chrom strand" C strings
    const int32_t* gid;
    const int64_t* pos;            // 0-based; rendered 1-based
    const char* base;              // one char per row
    const int32_t* cov1;
    const int32_t* cov2;
    const double* stu; const double* pu;
    const double* stt; const double* pt;
    const double* stks; const double* pks;
    const double* stc; const double* pc;   // may be null
};

inline int render_row(char* p, const Row& r, int64_t i) {
    char* q = p;
    const char* pre = r.prefixes[r.gid[i]];
    size_t plen = std::strlen(pre);
    std::memcpy(q, pre, plen); q += plen;
    q += std::snprintf(q, 64, " %lld %c %d %d ",
                       (long long)(r.pos[i] + 1), r.base[i],
                       r.cov1[i], r.cov2[i]);
    q += fmt_f(q, r.stu[i]); *q++ = ' ';
    q += fmt_e(q, r.pu[i]);  *q++ = ' ';
    q += fmt_f(q, r.stt[i]); *q++ = ' ';
    q += fmt_e(q, r.pt[i]);  *q++ = ' ';
    q += fmt_f(q, r.stks[i]); *q++ = ' ';
    q += fmt_e(q, r.pks[i]);
    if (r.stc != nullptr) {
        *q++ = ' ';
        q += fmt_f(q, r.stc[i]); *q++ = ' ';
        q += fmt_e(q, r.pc[i]);
    }
    *q++ = '\n';
    return (int)(q - p);
}

// worst-case row: 14 x %.3f(FLOAT_MAX) ~ 316 chars each
constexpr int kMaxRow = 8192;

// render [lo, hi) rows into a growing string with fn(buf, i) -> len
template <typename F>
std::string render_chunk(int64_t lo, int64_t hi, F fn) {
    std::string s;
    s.reserve((size_t)(hi - lo) * 96);
    char buf[kMaxRow];
    for (int64_t i = lo; i < hi; ++i) {
        int len = fn(buf, i);
        s.append(buf, (size_t)len);
    }
    return s;
}

template <typename F>
int64_t threaded_write(const char* path, int64_t n, int nthreads, F fn) {
    if (nthreads < 1) nthreads = 1;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    std::vector<std::string> parts((size_t)nthreads);
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
        int64_t lo = (int64_t)t * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        threads.emplace_back([&parts, t, lo, hi, &fn]() {
            parts[(size_t)t] = render_chunk(lo, hi, fn);
        });
    }
    for (auto& th : threads) th.join();
    FILE* f = std::fopen(path, "wb");
    if (f == nullptr) return -1;
    int64_t total = 0;
    for (auto& s : parts) {
        if (!s.empty() && std::fwrite(s.data(), 1, s.size(), f) != s.size()) {
            std::fclose(f);
            return -1;
        }
        total += (int64_t)s.size();
    }
    std::fclose(f);
    return total;
}

}  // namespace

extern "C" {

// Renders + writes the full _sign_test.txt; returns bytes written or -1.
int64_t format_sign_test(const char* const* prefixes, const int32_t* gid,
                         const int64_t* pos, const char* base,
                         const int32_t* cov1, const int32_t* cov2,
                         const double* stu, const double* pu,
                         const double* stt, const double* pt,
                         const double* stks, const double* pks,
                         const double* stc, const double* pc,
                         int has_comb, int64_t n, int nthreads,
                         const char* path) {
    Row r{prefixes, gid, pos, base, cov1, cov2,
          stu, pu, stt, pt, stks, pks,
          has_comb ? stc : nullptr, has_comb ? pc : nullptr};
    return threaded_write(path, n, nthreads, [&r](char* buf, int64_t i) {
        return render_row(buf, r, i);
    });
}

// meanstd rows: "chrom strand pos base m1 s1 m2 s2" (pos 0-based,
// ref myDetect.py:540-544); mstd is [n, 4] row-major.
int64_t format_meanstd(const char* const* prefixes, const int32_t* gid,
                       const int64_t* pos, const char* base,
                       const double* mstd, int64_t n, int nthreads,
                       const char* path) {
    return threaded_write(path, n, nthreads, [&](char* buf, int64_t i) {
        char* q = buf;
        const char* pre = prefixes[gid[i]];
        size_t plen = std::strlen(pre);
        std::memcpy(q, pre, plen); q += plen;
        q += std::snprintf(q, 64, " %lld %c ", (long long)pos[i], base[i]);
        for (int c = 0; c < 4; ++c) {
            q += fmt_f(q, mstd[i * 4 + c]);
            *q++ = (c == 3) ? '\n' : ' ';
        }
        return (int)(q - buf);
    });
}

}  // extern "C"
