// Batch k-mer seeding in C++ — the band finder for the banded-DP aligner.
//
// Python-side seeding (resquiggle/seed.py best_band: strided k-mer
// sampling, binary search into the sorted genome k-mer index, diagonal
// voting with a pooled window) costs ~0.43 ms/read in numpy call overhead;
// this port runs the identical algorithm on a thread pool over the
// concatenated sequence buffer the native prepare already produces.
// Replaces the seeding/chaining role of bwa/minimap2
// (ref myRefBaseSignalAnnotation.py:406-417).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

typedef int64_t i64;
typedef int32_t i32;

int code_of(char c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return 4;
    }
}

struct StrandBest {
    i64 center = 0;
    int votes = 0;
};

// densest-window vote over the diagonals of one strand orientation
StrandBest vote(std::vector<i64>& diags, int band_slack) {
    StrandBest out;
    if (diags.empty()) return out;
    std::sort(diags.begin(), diags.end());
    size_t j = 0;
    size_t best_i = 0, best_j = 0;
    int best = 0;
    for (size_t i = 0; i < diags.size(); i++) {
        while (diags[i] - diags[j] > 2 * band_slack) j++;
        int cnt = (int)(i - j + 1);
        if (cnt > best) { best = cnt; best_i = i; best_j = j; }
    }
    out.votes = best;
    // median of the winning window (matches np.median for odd counts;
    // even counts use the lower-middle + upper-middle average, floored)
    size_t lo = best_j, hi = best_i;
    size_t m = (hi - lo + 1);
    if (m % 2)
        out.center = diags[lo + m / 2];
    else
        out.center = (diags[lo + m / 2 - 1] + diags[lo + m / 2]) / 2;
    return out;
}

void seed_one(const char* seq, i64 len,
              const i64* codes_idx, const i64* pos_idx, i64 n_index,
              int k, int max_hits, int target, int band_slack,
              char* strand_out, i64* center_out, i32* votes_out) {
    *strand_out = '?';
    *center_out = 0;
    *votes_out = 0;
    i64 n_kmers = len - k + 1;
    if (n_kmers <= 0 || n_index == 0) return;
    i64 stride = n_kmers / target;
    if (stride < 1) stride = 1;

    std::vector<int> c(len);
    for (i64 i = 0; i < len; i++) c[i] = code_of(seq[i]);

    std::vector<i64> diags;
    StrandBest best[2];
    for (int s = 0; s < 2; s++) {
        diags.clear();
        for (i64 off = 0; off < n_kmers; off += stride) {
            i64 q = 0;
            bool bad = false;
            for (int j = 0; j < k; j++) {
                // '-' orientation: k-mer of the reverse complement
                int cc = s == 0 ? c[off + j] : 3 - c[len - 1 - (off + j)];
                if (cc > 3 || cc < 0) { bad = true; break; }
                q = q * 4 + cc;
            }
            if (bad) continue;
            const i64* lo = std::lower_bound(codes_idx, codes_idx + n_index, q);
            const i64* hi = std::upper_bound(lo, codes_idx + n_index, q);
            i64 cnt = hi - lo;
            if (cnt == 0 || cnt > max_hits) continue;
            for (const i64* p = lo; p != hi; ++p)
                diags.push_back(pos_idx[p - codes_idx] - off);
        }
        best[s] = vote(diags, band_slack);
    }
    int which = best[1].votes > best[0].votes ? 1 : 0;
    if (best[which].votes == 0) return;
    *strand_out = which == 0 ? '+' : '-';
    *center_out = best[which].center;
    *votes_out = best[which].votes;
}

}  // namespace

extern "C" {

// Seed n_reads sequences (concatenated, offsets[n_reads+1]) against the
// sorted genome k-mer index.  Outputs per read: strand '+'/'-'/'?'
// (? = unseeded), the best diagonal-window center in GLOBAL index
// coordinates, and its vote count.
void nm_seed_batch(const char* seqs, const i64* offsets, i64 n_reads,
                   const i64* sorted_codes, const i64* sorted_pos,
                   i64 n_index, int k, int max_hits, int target,
                   int band_slack, int nthreads,
                   char* strand_out, i64* center_out, i32* votes_out) {
    std::atomic<i64> next(0);
    int nt = std::max(1, std::min(nthreads, 32));
    auto worker = [&]() {
        for (;;) {
            i64 i = next.fetch_add(1);
            if (i >= n_reads) return;
            seed_one(seqs + offsets[i], offsets[i + 1] - offsets[i],
                     sorted_codes, sorted_pos, n_index, k, max_hits,
                     target, band_slack,
                     strand_out + i, center_out + i, votes_out + i);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 0; t < nt - 1; t++) ts.emplace_back(worker);
    worker();
    for (auto& t : ts) t.join();
}

}  // extern "C"
