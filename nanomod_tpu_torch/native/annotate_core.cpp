// Native indel-correction core.
//
// C++ implementation of the per-read resquiggle correction
// (mirrors nanomod_tpu/resquiggle/annotate.py, which reimplements the
// reference's fix_repeat_del / group_indel / find_sp / annotate1 —
// ref bin/scripts/myRefBaseSignalAnnotation.py:756-1391).  The Python
// version is the behavioral specification; tests/test_native.py checks the
// two produce identical output on randomized reads.
//
// Build: g++ -O3 -shared -fPIC -o libannotate_core.so annotate_core.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <map>
#include <algorithm>
#include <thread>

namespace {

inline bool is_acgt(char c) {
    switch (c) {
        case 'A': case 'C': case 'G': case 'T':
        case 'a': case 'c': case 'g': case 't':
        case 'N': case 'n':
            return true;   // ref myCom.py:23 — N counts as a nucleotide
        default:
            return false;
    }
}

inline bool is_gap_symbol(char c) { return c == '-' || c == '+' || c == '*'; }

inline double round3(double x) {
    // match numpy round-half-to-even at 3 decimals
    double scaled = x * 1000.0;
    double r = std::nearbyint(scaled);
    return r / 1000.0;
}

struct Group {
    int64_t start_ev, end_ev, last_col;
    int leftnum, rightnum;
};

struct Ctx {
    const char* refbase;
    char* readbase;           // mutated in place ('~' marking)
    int64_t n_cols;
    const int64_t* ev_start;
    const int64_t* ev_length;
    int64_t n_events;
    int strand;               // 0='+', 1='-'
    const double* raw;
    int64_t raw_len;
    int min_num_signal;
    int resegment_signal_wind;
    double more_signal_perc;
};

// raw span of genome events [g1, g2] (annotate.py GenomeEvents.raw_span)
inline void raw_span(const Ctx& c, int64_t g1, int64_t g2,
                     int64_t* lo, int64_t* hi) {
    if (c.strand == 0) {
        *lo = c.ev_start[g1];
        *hi = c.ev_start[g2] + c.ev_length[g2];
    } else {
        *lo = c.ev_start[g2];
        *hi = c.ev_start[g1] + c.ev_length[g1];
    }
}

// indel_pos map: col -> (event_ind, kind) ; also performs '~' marking
// (mark_repeat_indels / ref fix_repeat_del :1160-1221)
void mark_repeat_indels(Ctx& c, std::map<int64_t, std::pair<int64_t, int>>& indel_pos) {
    int64_t event_ind = -1;
    bool last_is_repeat = false;
    int64_t last_non_indel = 0;
    for (int64_t bmi = 0; bmi < c.n_cols; ++bmi) {
        char rb = c.readbase[bmi];
        char fb = c.refbase[bmi];
        if (is_acgt(rb)) {
            event_ind += 1;
            if (fb == '-') indel_pos[bmi] = {event_ind, 1};
        }
        if (rb != '-') {
            last_non_indel = bmi;
            last_is_repeat = false;
            if (rb == '*') indel_pos[bmi] = {event_ind, 0};
        } else {
            if (fb == c.refbase[last_non_indel] && is_acgt(fb)) {
                if (last_non_indel == bmi - 1 &&
                    c.readbase[last_non_indel] == c.refbase[last_non_indel])
                    last_is_repeat = true;
            } else {
                last_is_repeat = false;
            }
            if (is_acgt(fb))
                indel_pos[bmi] = {event_ind, last_is_repeat ? 0 : -1};
        }
    }
    // '~' marking for 5-mer periodic repeat contexts (ref :1207-1212)
    for (int64_t bmi = 3; bmi + 2 < c.n_cols; ++bmi) {
        if (is_gap_symbol(c.readbase[bmi])) {
            if (std::memcmp(c.refbase + bmi - 2, c.refbase + bmi - 3, 5) == 0) {
                c.readbase[bmi] = '~';
                if (is_gap_symbol(c.readbase[bmi - 1]))
                    c.readbase[bmi - 1] = '~';
            }
        }
    }
}

// expected event count for columns [lo, hi] (annotate.py _expectna)
int64_t expectna(const Ctx& c, int64_t lo, int64_t hi) {
    int64_t cnt = 0;
    for (int64_t bmi = lo; bmi <= hi; ++bmi) {
        if (bmi < 0) continue;
        if (bmi >= c.n_cols) break;
        if (c.refbase[bmi] == '-') continue;
        if (c.readbase[bmi] == '~' && bmi > 0 && c.readbase[bmi - 1] == '~')
            continue;
        cnt += 1;
    }
    return cnt;
}

// group_indels (ref group_indel :1225-1306)
void group_indels(const Ctx& c,
                  const std::map<int64_t, std::pair<int64_t, int>>& indel_pos,
                  std::map<int64_t, Group>& groups) {
    // stage 1: merge indel columns <= 2 apart
    std::map<int64_t, std::pair<int64_t, int64_t>> intervals;
    int64_t pre = -1;
    for (auto& kv : indel_pos) {
        int64_t ipk = kv.first;
        if (pre < 0 || !(ipk - intervals[pre].second <= 2)) {
            intervals[ipk] = {ipk, ipk};
            pre = ipk;
        } else {
            intervals[pre].second = ipk;
        }
    }

    int64_t pre_ipk = -1;           // -1 == None
    std::vector<int64_t> lastipk;
    for (auto& kv : intervals) {
        int64_t i1pk = kv.second.first;
        int64_t i2pk = kv.second.second;
        int leftnum = 0, rightnum = 0;
        int64_t start_ev, end_ev;
        auto ip1 = indel_pos.at(i1pk);
        auto ip2 = indel_pos.at(i2pk);
        if (c.refbase[i1pk] == '-') {
            if (ip1.first - 1 >= 0) { start_ev = ip1.first - 1; leftnum = 1; }
            else start_ev = 0;
        } else {
            start_ev = ip1.first; leftnum = 1;
            if (start_ev < 0) { start_ev = 0; leftnum = 0; }
        }
        if (ip2.first + 1 < c.n_events) { end_ev = ip2.first + 1; rightnum = 1; }
        else end_ev = c.n_events - 1;

        while (true) {
            int64_t lo, hi;
            raw_span(c, std::max<int64_t>(start_ev, 0), end_ev, &lo, &hi);
            int64_t numsignals = hi - lo;
            if (numsignals >= 1) {
                int64_t ena = expectna(c, i1pk - leftnum, i2pk + rightnum);
                int64_t extra = (ena * c.more_signal_perc < 1.0)
                                    ? 1
                                    : (int64_t)(ena * c.more_signal_perc + 0.5);
                if (numsignals > (ena + extra) * c.min_num_signal) break;
            }
            bool at_left_stop =
                (start_ev == 0 ||
                 (pre_ipk >= 0 && start_ev <= groups[pre_ipk].end_ev));
            if (at_left_stop && end_ev == c.n_events - 1) break;
            if ((pre_ipk < 0 && start_ev > 0) ||
                (pre_ipk >= 0 && start_ev > groups[pre_ipk].end_ev)) {
                start_ev -= 1;
                leftnum += 1;
            } else if (pre_ipk >= 0) {
                // merge backward into the previous group
                Group& pg = groups[pre_ipk];
                start_ev = pg.start_ev;
                i1pk = pre_ipk;
                leftnum = pg.leftnum;
                groups.erase(pre_ipk);
                pre_ipk = lastipk.back();
                lastipk.pop_back();
            }
            if (end_ev < c.n_events - 1) {
                rightnum += 1;
                while (true) {
                    int64_t col = i2pk + rightnum;
                    if (col >= c.n_cols) {
                        rightnum -= 1;
                        end_ev = c.n_events - 1;
                        break;
                    }
                    bool rb_ok = is_acgt(c.readbase[col]);
                    bool fb_ok = is_acgt(c.refbase[col]);
                    if (rb_ok && fb_ok) { end_ev += 1; break; }
                    if (rb_ok && !fb_ok) { end_ev += 1; rightnum += 1; }
                    else if (!rb_ok && fb_ok) { rightnum += 1; }
                    else break;
                }
            }
        }

        if (pre_ipk < 0 || start_ev > groups[pre_ipk].end_ev) {
            groups[i1pk] = {start_ev, end_ev, i2pk, leftnum, rightnum};
            lastipk.push_back(pre_ipk);
            pre_ipk = i1pk;
        } else if (start_ev <= groups[pre_ipk].end_ev) {
            if (end_ev >= groups[pre_ipk].end_ev) {
                Group& pg = groups[pre_ipk];
                pg.end_ev = end_ev;
                pg.last_col = i2pk;
                pg.rightnum = rightnum;
            }
        }
    }
}

// find_split_points (ref find_sp :1000-1094); returns true on success
bool find_split_points(const double* pv, int64_t n, int64_t ena,
                       int wind, int min_num_signal,
                       std::vector<int64_t>& out) {
    out.clear();
    int64_t lo = wind, hi = n - wind + 1;
    if (hi <= lo || ena < 1) return false;
    if (ena == 1) return true;   // zero splits needed
    int64_t m = hi - lo;
    std::vector<double> cs(n + 1, 0.0);
    for (int64_t i = 0; i < n; ++i) cs[i + 1] = cs[i] + pv[i];
    std::vector<std::pair<double, int64_t>> scored(m);
    for (int64_t t = 0; t < m; ++t) {
        int64_t i = lo + t;
        double left = (cs[i] - cs[i - wind]) / wind;
        double right = (cs[i + wind] - cs[i]) / wind;
        double s = std::fabs(left - right);
        // match np.round(x, 9)
        s = std::nearbyint(s * 1e9) / 1e9;
        scored[t] = {s, i};
    }
    // stable sort by descending score (ties keep ascending i)
    std::stable_sort(scored.begin(), scored.end(),
                     [](const auto& a, const auto& b) { return a.first > b.first; });
    for (auto& sc : scored) {
        int64_t cand = sc.second;
        bool close = false;
        for (int64_t sp : out)
            if (cand - sp > -min_num_signal && cand - sp < min_num_signal) {
                close = true;
                break;
            }
        if (close) continue;
        out.push_back(cand);
        if ((int64_t)out.size() == ena - 1) break;
    }
    if ((int64_t)out.size() < ena - 1) return false;
    std::sort(out.begin(), out.end());
    return true;
}

// numpy's pairwise summation (umath pairwise_sum, PW_BLOCKSIZE=128),
// reproduced exactly so means/stds match np.mean/np.std bit-for-bit
// (rounding to 3 decimals amplifies 1-ulp differences on quantized signal).
// F maps element i -> summand (identity for the mean, squared deviation
// for the variance).
template <typename F>
double pairwise_sum(F f, int64_t off, int64_t n) {
    if (n < 8) {
        double res = 0.0;
        for (int64_t i = 0; i < n; ++i) res += f(off + i);
        return res;
    } else if (n <= 128) {
        double r[8];
        for (int j = 0; j < 8; ++j) r[j] = f(off + j);
        int64_t i;
        for (i = 8; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += f(off + i + j);
        double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                     ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += f(off + i);
        return res;
    } else {
        int64_t n2 = n / 2;
        n2 -= n2 % 8;
        return pairwise_sum(f, off, n2) + pairwise_sum(f, off + n2, n - n2);
    }
}

void seg_mean_std(const double* v, int64_t lo, int64_t hi,
                  double* mean, double* std) {
    if (hi <= lo) { *mean = 0.0; *std = 0.0; return; }
    int64_t n = hi - lo;
    double m = pairwise_sum([&](int64_t i) { return v[i]; }, lo, n) / n;
    double ss = pairwise_sum(
        [&](int64_t i) { double d = v[i] - m; return d * d; }, lo, n);
    *mean = round3(m);
    *std = round3(std::sqrt(ss / n));
}

// Core correction over prepared column arrays; shared by the per-read
// extern entry and the batched ops-decoding entry below.
int run_core(Ctx& c,
             double* out_mean, double* out_std,
             int64_t* out_start, int64_t* out_len, uint8_t* out_valid,
             int64_t* signalnum_hist) {
    const int64_t n_cols = c.n_cols;
    const double* raw = c.raw;
    const int strand = c.strand;
    const int min_num_signal = c.min_num_signal;
    const int resegment_signal_wind = c.resegment_signal_wind;

    std::map<int64_t, std::pair<int64_t, int>> indel_pos;
    mark_repeat_indels(c, indel_pos);

    std::map<int64_t, Group> groups;
    group_indels(c, indel_pos, groups);

    std::memset(out_valid, 0, n_cols);
    std::vector<int64_t> ev_of_col(n_cols, -1);

    // pass 1: outside groups, 1:1 event <-> column (ref annotate1 :775-810)
    int64_t bmi = 0, event_ind = -1;
    auto put_plain = [&](int64_t col, int64_t ev) {
        int64_t lo = c.ev_start[ev], hi = c.ev_start[ev] + c.ev_length[ev];
        double m, s;
        seg_mean_std(raw, lo, hi, &m, &s);
        out_mean[col] = m; out_std[col] = s;
        out_start[col] = lo; out_len[col] = hi - lo;
        out_valid[col] = 1;
        ev_of_col[col] = ev;
    };
    for (auto& g : groups) {
        int64_t gipk = g.first;
        const Group& gr = g.second;
        int64_t lo_col = gipk - gr.leftnum > -1 ? gipk - gr.leftnum : 0;
        while (bmi < lo_col) {
            event_ind += 1;
            put_plain(bmi, event_ind);
            bmi += 1;
        }
        while (bmi < gr.last_col + gr.rightnum + 1 && bmi < n_cols) {
            if (is_acgt(c.readbase[bmi])) event_ind += 1;
            if (is_acgt(c.refbase[bmi])) {
                ev_of_col[bmi] = event_ind;
                out_valid[bmi] = 1;   // placeholder; pass 2 fills values
                out_mean[bmi] = 0.0; out_std[bmi] = 0.0;
                out_start[bmi] = 0; out_len[bmi] = 0;
            }
            bmi += 1;
        }
    }
    while (bmi < n_cols) {
        event_ind += 1;
        put_plain(bmi, event_ind);
        bmi += 1;
    }

    // pass 2: resegment within each group (ref annotate1 :815-978)
    std::vector<int64_t> split_pos;
    for (auto& g : groups) {
        int64_t gipk = g.first;
        const Group& gr = g.second;
        int64_t mstart1, mend2;
        raw_span(c, gr.start_ev, gr.end_ev, &mstart1, &mend2);
        const double* pv = raw + mstart1;
        int64_t npv = mend2 - mstart1;
        int64_t ena = expectna(c, gipk - gr.leftnum, gr.last_col + gr.rightnum);

        bool ok = false;
        int currsw = resegment_signal_wind;
        for (currsw = resegment_signal_wind; currsw > 1; --currsw) {
            ok = find_split_points(pv, npv, ena, currsw, min_num_signal,
                                   split_pos);
            if (ok) break;
        }
        double all_mean = 0.0, all_std = 0.0;
        if (ok) {
            if (currsw >= 0 && currsw < 32) signalnum_hist[currsw] += 1;
        } else {
            signalnum_hist[1] += 1;
            seg_mean_std(pv, 0, npv, &all_mean, &all_std);
        }

        int64_t b2 = gipk - gr.leftnum;
        if (b2 < 0) b2 = 0;
        int64_t spind = (strand == 1 && ok) ? (int64_t)split_pos.size() - 1 : -1;

        auto segment = [&](int64_t sp, double* m, double* s,
                           int64_t* st, int64_t* ln) {
            if (!ok) {
                *m = all_mean; *s = all_std;
                *st = mstart1; *ln = mend2 - mstart1;
                return;
            }
            int64_t start_in_pv = sp == -1 ? 0 : split_pos[sp];
            int64_t end_in_pv = (sp == (int64_t)split_pos.size() - 1)
                                    ? npv
                                    : split_pos[sp + 1];
            seg_mean_std(pv, start_in_pv, end_in_pv, m, s);
            *st = mstart1 + start_in_pv;
            *ln = end_in_pv - start_in_pv;
        };
        auto advance = [&]() { spind += (strand == 0) ? 1 : -1; };
        auto assign = [&](int64_t col) {
            double m, s;
            int64_t st, ln;
            segment(spind, &m, &s, &st, &ln);
            out_mean[col] = m; out_std[col] = s;
            out_start[col] = st; out_len[col] = ln;
            out_valid[col] = 1;
        };

        while (b2 < gr.last_col + gr.rightnum + 1) {
            if (b2 >= n_cols) break;
            char rb = c.readbase[b2];
            if (c.refbase[b2] == '-') { b2 += 1; continue; }
            if (rb == '~') {
                if (b2 > 0 && c.readbase[b2 - 1] == '~') {
                    out_mean[b2] = out_mean[b2 - 1];
                    out_std[b2] = out_std[b2 - 1];
                    out_start[b2] = out_start[b2 - 1];
                    out_len[b2] = out_len[b2 - 1];
                    out_valid[b2] = out_valid[b2 - 1];
                    ev_of_col[b2] = ev_of_col[b2 - 1];
                } else {
                    assign(b2);
                }
                if (b2 < n_cols - 1 && c.readbase[b2 + 1] != '~') advance();
                b2 += 1;
            } else if (is_acgt(rb) || rb == '-') {
                assign(b2);
                b2 += 1;
                while (b2 < n_cols && c.readbase[b2] == '+') {
                    assign(b2);
                    b2 += 1;
                }
                advance();
            } else if (rb == '*') {
                assign(b2);
                b2 += 1;
                while (b2 < n_cols && c.readbase[b2] == '*') {
                    assign(b2);
                    b2 += 1;
                }
                if (b2 < n_cols && is_acgt(c.readbase[b2])) {
                    assign(b2);
                    b2 += 1;
                }
                advance();
            } else {
                break;
            }
        }
    }
    return 0;
}

inline char comp_base(char b) {
    switch (b) {
        case 'A': return 'T'; case 'C': return 'G';
        case 'G': return 'C'; case 'T': return 'A';
        case 'a': return 't'; case 'c': return 'g';
        case 'g': return 'c'; case 't': return 'a';
        default: return b;   // '-', '~', '*', '+', N map to self
    }
}

}  // namespace

extern "C" int annotate_core(
    const char* refbase_in, char* readbase_io, int64_t n_cols,
    const int64_t* ev_start, const int64_t* ev_length, int64_t n_events,
    int strand, const double* raw, int64_t raw_len,
    int min_num_signal, int resegment_signal_wind, double more_signal_perc,
    // outputs (caller-allocated, length n_cols):
    double* out_mean, double* out_std,
    int64_t* out_start, int64_t* out_len, uint8_t* out_valid,
    // histogram (length 32) of successful resegment windows; index 1 = fallback
    int64_t* signalnum_hist) {
    Ctx c{refbase_in, readbase_io, n_cols, ev_start, ev_length, n_events,
          strand, raw, raw_len, min_num_signal, resegment_signal_wind,
          more_signal_perc};
    return run_core(c, out_mean, out_std, out_start, out_len, out_valid,
                    signalnum_hist);
}

// ---------------------------------------------------------------------------
// Batched path: device-walk codes -> alignment columns -> correction ->
// write-ready payload arrays, one call per DP batch, C++ threads across
// reads.  Replaces the per-read Python annotate_one (pipeline.py) on the
// hot path: the decode (traceback.cpp semantics), the vectorized CIGAR
// expansion (ref myRefBaseSignalAnnotation.py:537-588), the per-base event
// window gather, run_core, and the output assembly of
// save_annotation (ref :689-749) all happen here without touching Python
// per read.
//
// Per-read inputs come as pointer tables (no host-side concatenation):
//   codes [B, S]: device-walk op codes, 3'->5' (0 stop, 1 M, 2 I, 3 D)
//   seq_ptr[b]/seq_len[b]: fwd-strand basecall (ASCII)
//   ev_start_ptr/ev_length_ptr[b]: per-basecall-base event windows, int64,
//       ORIGINAL basecall orientation, length seq_len[b]
//   sig_ptr[b]/sig_len[b]: normalized signal, float64
//   gen_ptr[b]/gen_len[b]: the read's chromosome sequence (ASCII)
// Outputs (worst-case S columns per read, caller-allocated):
//   ev_rows [B, S, 25]: packed CORRECTED_EVENTS_DTYPE rows
//       (<f8 mean, <f8 stdev, <u4 start, <u4 length, S1 base),
//       genome-ascending, reverse-complemented for '-' strand
//       (ref save_annotation :699-702); ev_n[b] = row count
//   read_al / genome_al [B, S]: alignment column chars (complemented +
//       reversed for '-'); al_n[b] = column count
//   meta [B, 8]: first_match_pos, clip_start, clip_end, num_ins, num_del,
//       num_match, num_mismatch, 0
//   hist [B, 32]: per-read resegment-window histogram
//   status [B]: 0 ok, 1 incorrect alignment, 2 skipped (accept[b] == 0)
extern "C" void annotate_codes_batch(
    const uint8_t* codes, int64_t bsz, int64_t s,
    const int32_t* best_i, const int32_t* best_k,
    const uint8_t* accept, const int64_t* win_start,
    const char** gen_ptr, const int64_t* gen_len,
    const char** seq_ptr, const int64_t* seq_len,
    const int64_t** ev_start_ptr, const int64_t** ev_length_ptr,
    const double** sig_ptr, const int64_t* sig_len,
    const uint8_t* strands,
    int min_num_signal, int resegment_signal_wind, double more_signal_perc,
    uint8_t* ev_rows, int64_t* ev_n,
    uint8_t* read_al, uint8_t* genome_al, int64_t* al_n,
    int64_t* meta, int64_t* hist, int32_t* status, int nthreads,
    int codes_packed) {
    // codes_packed != 0: rows are 2-bit packed 4 steps/byte
    // (banded.pack_codes2); s stays the step count
    if (nthreads < 1) nthreads = 1;
    if (nthreads > bsz) nthreads = (int)bsz;
    const int64_t cstride = codes_packed ? s / 4 : s;

    auto run = [&](int64_t lo_b, int64_t hi_b) {
        // per-thread scratch, reused across reads
        std::vector<int8_t> ot;
        std::vector<int64_t> oa, ob;
        std::vector<char> refb, readb;
        std::vector<int64_t> ev_s, ev_l;
        std::vector<double> col_mean, col_std;
        std::vector<int64_t> col_start, col_len;
        std::vector<uint8_t> col_valid;

        for (int64_t b = lo_b; b < hi_b; ++b) {
            ev_n[b] = 0; al_n[b] = 0;
            std::memset(meta + b * 8, 0, 8 * sizeof(int64_t));
            std::memset(hist + b * 32, 0, 32 * sizeof(int64_t));
            if (!accept[b]) { status[b] = 2; continue; }

            // decode walk codes (3'->5'), matching traceback.cpp
            const uint8_t* row = codes + b * cstride;
            ot.clear(); oa.clear(); ob.clear();
            {
                int64_t i = best_i[b], k = best_k[b];
                for (int64_t t = 0; t < s; ++t) {
                    uint8_t c = codes_packed
                        ? (uint8_t)((row[t >> 2] >> ((t & 3) * 2)) & 3)
                        : row[t];
                    if (c == 0) break;
                    if (c == 1) {
                        ot.push_back(0); oa.push_back(i); ob.push_back(i + k);
                        i -= 1;
                    } else if (c == 2) {
                        ot.push_back(1); oa.push_back(i); ob.push_back(-1);
                        i -= 1; k += 1;
                    } else {
                        ot.push_back(2); oa.push_back(i + k); ob.push_back(-1);
                        k -= 1;
                    }
                }
                std::reverse(ot.begin(), ot.end());
                std::reverse(oa.begin(), oa.end());
                std::reverse(ob.begin(), ob.end());
            }
            int64_t n = (int64_t)ot.size();
            if (n == 0 || n > s) { status[b] = 1; continue; }

            // aligned read span + first exact-match genome position
            int64_t r0 = INT64_MAX, r1 = -1, fm = -1;
            for (int64_t t = 0; t < n; ++t) {
                if (ot[t] != 2) {
                    if (oa[t] < r0) r0 = oa[t];
                    if (oa[t] > r1) r1 = oa[t];
                }
                if (fm < 0 && ot[t] == 0) fm = ob[t];
            }
            if (r1 < 0 || fm < 0) { status[b] = 1; continue; }
            const int64_t ws = win_start[b];
            const char* G = gen_ptr[b];
            const int64_t GL = gen_len[b];
            const char* SQ = seq_ptr[b];
            const int64_t m_total = seq_len[b];
            const int st = strands[b];

            // columns (vectorized CIGAR expansion in the Python path)
            refb.resize(n); readb.resize(n);
            int64_t numins = 0, numdel = 0, nummis = 0;
            bool oob = false;
            for (int64_t t = 0; t < n; ++t) {
                if (ot[t] == 0) {
                    int64_t g = ob[t] + ws;
                    if (g < 0 || g >= GL) { oob = true; break; }
                    refb[t] = G[g]; readb[t] = SQ[oa[t]];
                    if (refb[t] != readb[t]) nummis++;
                } else if (ot[t] == 1) {
                    refb[t] = '-'; readb[t] = SQ[oa[t]]; numins++;
                } else {
                    int64_t g = oa[t] + ws;
                    if (g < 0 || g >= GL) { oob = true; break; }
                    refb[t] = G[g]; readb[t] = '-'; numdel++;
                }
            }
            if (oob) { status[b] = 1; continue; }

            // genome-forward event windows for the aligned read span
            int64_t n_aligned = r1 - r0 + 1;
            const int64_t* ES = ev_start_ptr[b];
            const int64_t* EL = ev_length_ptr[b];
            ev_s.resize(n_aligned); ev_l.resize(n_aligned);
            for (int64_t j = 0; j < n_aligned; ++j) {
                int64_t orig = st == 0 ? r0 + j : m_total - 1 - r0 - j;
                ev_s[j] = ES[orig]; ev_l[j] = EL[orig];
            }

            col_mean.assign(n, 0.0); col_std.assign(n, 0.0);
            col_start.assign(n, 0); col_len.assign(n, 0);
            col_valid.assign(n, 0);
            Ctx c{refb.data(), readb.data(), n, ev_s.data(), ev_l.data(),
                  n_aligned, st, sig_ptr[b], sig_len[b], min_num_signal,
                  resegment_signal_wind, more_signal_perc};
            run_core(c, col_mean.data(), col_std.data(), col_start.data(),
                     col_len.data(), col_valid.data(), hist + b * 32);

            // assemble output events (genome-ascending '+', descending '-')
            uint8_t* rows = ev_rows + b * s * 25;
            int64_t nr = 0;
            auto emit = [&](int64_t col) {
                uint8_t* p = rows + nr * 25;
                double m = col_mean[col], sd = col_std[col];
                uint32_t stt = (uint32_t)col_start[col];
                uint32_t ln = (uint32_t)col_len[col];
                std::memcpy(p, &m, 8);
                std::memcpy(p + 8, &sd, 8);
                std::memcpy(p + 16, &stt, 4);
                std::memcpy(p + 20, &ln, 4);
                p[24] = st == 0 ? refb[col] : comp_base(refb[col]);
                nr++;
            };
            if (st == 0) {
                for (int64_t t = 0; t < n; ++t)
                    if (col_valid[t]) emit(t);
            } else {
                for (int64_t t = n - 1; t >= 0; --t)
                    if (col_valid[t]) emit(t);
            }
            if (nr == 0) { status[b] = 1; continue; }
            ev_n[b] = nr;

            // alignment strings (readbase mutated by run_core '~' marks)
            uint8_t* ra = read_al + b * s;
            uint8_t* ga = genome_al + b * s;
            if (st == 0) {
                std::memcpy(ra, readb.data(), n);
                std::memcpy(ga, refb.data(), n);
            } else {
                for (int64_t t = 0; t < n; ++t) {
                    ra[t] = (uint8_t)comp_base(readb[n - 1 - t]);
                    ga[t] = (uint8_t)comp_base(refb[n - 1 - t]);
                }
            }
            al_n[b] = n;

            int64_t* mt = meta + b * 8;
            mt[0] = ws + fm;                         // first_match_pos
            mt[1] = st == 0 ? r0 : m_total - 1 - r1; // clipped_start
            mt[2] = st == 0 ? m_total - 1 - r1 : r0; // clipped_end
            mt[3] = numins; mt[4] = numdel;
            mt[5] = n - nummis - numins - numdel;    // num_matches
            mt[6] = nummis;
            status[b] = 0;
        }
    };

    if (nthreads == 1) { run(0, bsz); return; }
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
