// Batch alignment traceback walker.
//
// Walks the 4-bit traceback codes produced by the banded DP
// (nanomod_tpu/resquiggle/banded.py banded_sw) for a whole batch of reads.
// Port of banded.traceback (the Python walker is the specification;
// tests/test_native.py compares them).
//
// Build: g++ -O3 -shared -fPIC -o libtraceback.so traceback.cpp

#include <cstdint>

#include <thread>
#include <vector>

namespace {
constexpr int H_ZERO = 0, H_DIAG = 1, H_E = 2, H_F = 3;

// One walk of the 4-bit codes; Packed=true reads two cells per byte
// (low nibble = even k), matching banded.pack_tb's device-side packing.
template <bool Packed>
int64_t walk(const uint8_t* tb, int64_t wbytes, int64_t best_i,
             int64_t best_k, int64_t w, int32_t* ops_type, int32_t* ops_a,
             int32_t* ops_b, int64_t cap) {
    int64_t n = 0;
    int64_t i = best_i, k = best_k;
    int state = 0;          // 0=H, 1=E, 2=F
    while (i >= 0 && n < cap) {
        const uint8_t* row = tb + i * wbytes;
        uint8_t bits = Packed
            ? (uint8_t)((row[k >> 1] >> ((k & 1) * 4)) & 0xF)
            : row[k];
        int src = bits & 0b11;
        if (state == 0) {
            if (src == H_ZERO) break;
            if (src == H_DIAG) {
                ops_type[n] = 0;
                ops_a[n] = (int32_t)i;
                ops_b[n] = (int32_t)(i + k);
                ++n;
                i -= 1;
                if (i < 0) break;
            } else if (src == H_E) {
                state = 1;
            } else {
                state = 2;
            }
        } else if (state == 1) {
            ops_type[n] = 2;
            ops_a[n] = (int32_t)(i + k);
            ops_b[n] = -1;
            ++n;
            state = (bits & 0b100) ? 1 : 0;
            k -= 1;
            if (k < 0) break;
        } else {
            ops_type[n] = 1;
            ops_a[n] = (int32_t)i;
            ops_b[n] = -1;
            ++n;
            bool up_ext = bits & 0b1000;
            i -= 1;
            k += 1;
            if (k >= w || i < 0) break;
            state = up_ext ? 2 : 0;
        }
    }
    // reverse into 5'->3' order
    for (int64_t a = 0, b = n - 1; a < b; ++a, --b) {
        int32_t t;
        t = ops_type[a]; ops_type[a] = ops_type[b]; ops_type[b] = t;
        t = ops_a[a]; ops_a[a] = ops_a[b]; ops_a[b] = t;
        t = ops_b[a]; ops_b[a] = ops_b[b]; ops_b[b] = t;
    }
    return n;
}
}  // namespace

extern "C" int64_t traceback_one(
    const uint8_t* tb,      // [M, W] row-major
    int64_t m, int64_t w,
    int64_t best_i, int64_t best_k,
    // outputs (caller-allocated, capacity cap):
    int32_t* ops_type,      // 0=M (read i aligned to ref j), 1=I, 2=D
    int32_t* ops_a,         // read index (M, I) or ref j (D)
    int32_t* ops_b,         // ref j for M ops, -1 otherwise
    int64_t cap) {
    (void)m;
    return walk<false>(tb, w, best_i, best_k, w, ops_type, ops_a, ops_b, cap);
}

// Decode device-walk op codes (banded.walk_device: 0 stop, 1 M, 2 I, 3 D,
// 3'->5' walk order) into the (type, a, b) op arrays of traceback_batch.
// codes is [B, S] row-major; outputs are [B, cap] with out_n[b] counts.
// codes_packed != 0: codes rows are 2-bit-packed 4 steps/byte
// (banded.pack_codes2), row stride s/4 bytes; s is still the step count.
extern "C" void decode_walk_batch(
    const uint8_t* codes, int64_t bsz, int64_t s,
    const int32_t* best_i, const int32_t* best_k,
    int32_t* ops_type, int32_t* ops_a, int32_t* ops_b,
    int64_t cap, int64_t* out_n, int nthreads, int codes_packed) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > bsz) nthreads = (int)bsz;
    const int64_t stride = codes_packed ? s / 4 : s;
    auto run = [&](int64_t lo, int64_t hi) {
        for (int64_t b = lo; b < hi; ++b) {
            const uint8_t* row = codes + b * stride;
            int32_t* ot = ops_type + b * cap;
            int32_t* oa = ops_a + b * cap;
            int32_t* ob = ops_b + b * cap;
            int64_t i = best_i[b], k = best_k[b], n = 0;
            for (int64_t t = 0; t < s && n < cap; ++t) {
                uint8_t c = codes_packed
                    ? (uint8_t)((row[t >> 2] >> ((t & 3) * 2)) & 3)
                    : row[t];
                if (c == 0) break;
                if (c == 1) {
                    ot[n] = 0; oa[n] = (int32_t)i; ob[n] = (int32_t)(i + k);
                    ++n; i -= 1;
                } else if (c == 2) {
                    ot[n] = 1; oa[n] = (int32_t)i; ob[n] = -1;
                    ++n; i -= 1; k += 1;
                } else {
                    ot[n] = 2; oa[n] = (int32_t)(i + k); ob[n] = -1;
                    ++n; k -= 1;
                }
            }
            for (int64_t a = 0, z = n - 1; a < z; ++a, --z) {
                int32_t t;
                t = ot[a]; ot[a] = ot[z]; ot[z] = t;
                t = oa[a]; oa[a] = oa[z]; oa[z] = t;
                t = ob[a]; ob[a] = ob[z]; ob[z] = t;
            }
            out_n[b] = n;
        }
    };
    if (nthreads == 1) {
        run(0, bsz);
        return;
    }
    std::vector<std::thread> pool;
    int64_t chunk = (bsz + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < bsz ? lo + chunk : bsz;
        if (lo >= hi) break;
        pool.emplace_back(run, lo, hi);
    }
    for (auto& th : pool) th.join();
}

// Whole-batch traceback: tb is [B, M, wbytes] row-major; when packed != 0,
// wbytes = W/2 with two 4-bit cells per byte (low nibble = even k), else
// wbytes = W.  Outputs are [B, cap] row-major; out_n[b] receives the op
// count for read b.
extern "C" void traceback_batch(
    const uint8_t* tb, int64_t bsz, int64_t m, int64_t wbytes, int packed,
    const int32_t* best_i, const int32_t* best_k,
    int32_t* ops_type, int32_t* ops_a, int32_t* ops_b,
    int64_t cap, int64_t* out_n, int nthreads) {
    const int64_t w = packed ? wbytes * 2 : wbytes;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > bsz) nthreads = (int)bsz;
    auto run = [&](int64_t lo, int64_t hi) {
        for (int64_t b = lo; b < hi; ++b) {
            const uint8_t* tbr = tb + b * m * wbytes;
            int32_t* ot = ops_type + b * cap;
            int32_t* oa = ops_a + b * cap;
            int32_t* ob = ops_b + b * cap;
            out_n[b] = packed
                ? walk<true>(tbr, wbytes, best_i[b], best_k[b], w,
                             ot, oa, ob, cap)
                : walk<false>(tbr, wbytes, best_i[b], best_k[b], w,
                              ot, oa, ob, cap);
        }
    };
    if (nthreads == 1) {
        run(0, bsz);
        return;
    }
    std::vector<std::thread> pool;
    int64_t chunk = (bsz + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < bsz ? lo + chunk : bsz;
        if (lo >= hi) break;
        pool.emplace_back(run, lo, hi);
    }
    for (auto& th : pool) th.join();
}
