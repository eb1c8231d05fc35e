// mtr_host — native host runtime for mtr.
//
// Implements the sequential per-read logic that surrounds the device
// kernels: DI local-extrema pairing, redundant-range removal, greedy De
// Bruijn walks with tie-break lookahead, move-tensor tracebacks, unit
// polishing, and interval chaining.  Each function mirrors its oracle
// (NumPy) counterpart bit-for-bit; the oracle cites the reference C
// line numbers.  Exposed through a plain C ABI for ctypes.
//
// Build: make -C native   (produces libmtr_host.so)

#include <cstdint>
#include <cstring>
#if defined(__AVX512F__)
#include <immintrin.h>
#endif
#include <vector>
#include <unordered_map>
#include <thread>
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <random>

// ---------------------------------------------------------------------------
// Stage timers (-c observability): real measured sections matching the
// reference's accumulators (mTR.h:142-143) — time_initialize_input_string
// (init_inputString, consensus.c:39-59), time_count_table
// (generate_freqNode*, consensus.c:73-127), and the walk remainder.
// Disabled by default (one relaxed load per query); enabled by the CLI's
// -c flag via mtr_stage_timers().
// ---------------------------------------------------------------------------
namespace {
std::atomic<int64_t> g_init_ns(0), g_count_ns(0), g_walk_ns(0);
std::atomic<int> g_timers_on(0);
inline int64_t now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}
}  // namespace

// ---------------------------------------------------------------------------
// Persistent worker pool.  Spawning std::thread per batch call would
// destroy each worker's thread_local scratch (count tables, DP buffers)
// between calls; on hosts with lazy (post-copy / uffd) memory every
// re-allocated page costs a ~30 us first-touch fault, which dwarfed the
// actual compute.  Workers here live for the process, so scratch stays
// resident and warm.  run(n, fn) executes fn(tid) for tid in [0, n);
// tid 0 runs on the caller's thread.
// ---------------------------------------------------------------------------
namespace {

class WorkPool {
public:
    static WorkPool& inst() {
        // intentionally leaked: detached workers may still reference the
        // mutex/cv during interpreter shutdown
        static WorkPool* p = new WorkPool();
        return *p;
    }

    void run(int n_threads, const std::function<void(int)>& fn) {
        if (n_threads <= 1) { fn(0); return; }
        // dispatches are not reentrant (single task slot); serialize
        // concurrent callers (e.g. future multi-threaded batchers)
        std::lock_guard<std::mutex> run_lk(run_mu_);
        ensure(n_threads - 1);
        {
            std::unique_lock<std::mutex> lk(mu_);
            task_ = &fn;
            want_ = n_threads - 1;
            done_ = 0;
            gen_++;
        }
        cv_.notify_all();
        fn(0);
        std::unique_lock<std::mutex> lk(mu_);
        cv_done_.wait(lk, [&] { return done_ == want_; });
        task_ = nullptr;
    }

private:
    void ensure(int n_workers) {
        // workers are detached daemons: the pool is a static singleton and
        // joinable threads in its destructor would std::terminate at exit
        while (n_workers_ < n_workers) {
            int tid = n_workers_ + 1;
            std::thread([this, tid] { worker(tid); }).detach();
            n_workers_++;
        }
    }

    void worker(int tid) {
        uint64_t seen = 0;
        for (;;) {
            const std::function<void(int)>* task;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [&] { return gen_ != seen; });
                seen = gen_;
                if (tid > want_) {  // not part of this dispatch
                    continue;
                }
                task = task_;
            }
            (*task)(tid);
            {
                std::unique_lock<std::mutex> lk(mu_);
                done_++;
            }
            cv_done_.notify_one();
        }
    }

    int n_workers_ = 0;
    std::mutex run_mu_;
    std::mutex mu_;
    std::condition_variable cv_, cv_done_;
    const std::function<void(int)>* task_ = nullptr;
    uint64_t gen_ = 0;
    int want_ = 0, done_ = 0;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// 1. DI local-extrema pairing (mirrors oracle/directional_index.py
//    put_local_maximum; reference fill_directional_index.c:467-503)
// ---------------------------------------------------------------------------
void mtr_extrema_pair(const double* di_tmp, int64_t di_len, int64_t w,
                      double* di, int64_t* di_end, int64_t* di_w) {
    double local_max = -1.0;
    int64_t local_max_i = -1;
    for (int64_t i = 0; i < di_len; i++) {
        if (local_max < di_tmp[i]) { local_max = di_tmp[i]; local_max_i = i; }
        if (local_max_i + w < i && local_max_i >= 0 &&
            di[local_max_i] < local_max && 0.0 < local_max) {
            double local_min = 1.0;
            int64_t local_min_j = local_max_i;
            for (int64_t j = local_max_i; j < di_len; j++) {
                if (local_min > di_tmp[j]) { local_min = di_tmp[j]; local_min_j = j; }
                if (local_min_j + w < j) {
                    di[local_max_i] = local_max;
                    di_w[local_max_i] = w;
                    di_end[local_max_i] = local_min_j + w;
                    i = local_min_j + w;
                    break;
                }
            }
            local_max = -1.0;
        }
    }
}

// ---------------------------------------------------------------------------
// 2. redundant-range removal (oracle remove_redundant_ranges;
//    reference fill_directional_index.c:505-546)
// ---------------------------------------------------------------------------
void mtr_remove_redundant(double* di, int64_t* di_end, int64_t input_len,
                          double min_jaccard) {
    for (int64_t i = 0; i < input_len; i++) {
        int64_t i_begin = i;
        int64_t i_end = di_end[i];
        double i_di = di[i];
        if (!(0.0 < i_di)) continue;
        for (int64_t j = i + 1; j <= i_end; j++) {
            int64_t j_begin = j;
            int64_t j_end = di_end[j];
            double j_di = di[j];
            if (!(0.0 < j_di)) continue;
            double jac = (double)(std::min(i_end, j_end) - std::max(i_begin, j_begin)) /
                         (double)(std::max(i_end, j_end) - std::min(i_begin, j_begin));
            if (min_jaccard < jac) {
                if (i_di < j_di) { di[i] = -1.0; di_end[i] = -1; break; }
                di[j] = -1.0; di_end[j] = -1;
            } else {
                if (i_begin >= j_begin && i_end <= j_end && i_di < j_di) {
                    di[i] = -1.0; di_end[i] = -1; break;
                }
                if (i_begin <= j_begin && i_end >= j_end && i_di > j_di) {
                    di[j] = -1.0; di_end[j] = -1;
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// 2b. sliding-window L1 distance for the DI numerator
//     D[i] = sum_v |count_v(vals[i:i+w]) - count_v(vals[i+w:i+2w])|
//     Incremental histogram updates, O(n) total (oracle sliding_l1).
// ---------------------------------------------------------------------------
void mtr_sliding_l1(const int32_t* vals, int64_t n_out, int64_t w, int64_t* D) {
    if (n_out <= 0) return;
    int64_t n_pos = n_out + 2 * w - 1;
    int32_t vmax = 0;
    for (int64_t i = 0; i < n_pos; i++) if (vals[i] > vmax) vmax = vals[i];
    std::vector<int32_t> h1(vmax + 1, 0), h2(vmax + 1, 0);
    int64_t d = 0;
    for (int64_t i = 0; i < w; i++) { h1[vals[i]]++; h2[vals[i + w]]++; }
    for (int32_t v = 0; v <= vmax; v++) d += std::abs(h1[v] - h2[v]);
    D[0] = d;
    auto upd = [&](std::vector<int32_t>& ha, std::vector<int32_t>& hb,
                   int32_t v, int32_t delta) {
        d -= std::abs(ha[v] - hb[v]);
        ha[v] += delta;
        d += std::abs(ha[v] - hb[v]);
    };
    for (int64_t i = 1; i < n_out; i++) {
        // window1 [i, i+w): drop vals[i-1], add vals[i-1+w]
        upd(h1, h2, vals[i - 1], -1);
        upd(h1, h2, vals[i - 1 + w], +1);
        // window2 [i+w, i+2w): drop vals[i-1+w], add vals[i-1+2w]
        upd(h2, h1, vals[i - 1 + w], -1);
        upd(h2, h1, vals[i - 1 + 2 * w], +1);
        D[i] = d;
    }
}

// ---------------------------------------------------------------------------
// 2c. Full Manhattan directional-index pass for one read
//     (fill_directional_index_with_end, fill_directional_index.c:549-602),
//     replacing the per-(k,w) Python round trips.  Mutates the persistent
//     input_w_rand arena buffer in place — its stale tail is read by wide
//     windows, a reference quirk required for bit-identical output.
//     MT19937: std::mt19937 seeded with 0 matches init_genrand(0) exactly
//     (same Knuth seeding and tempering); random_base = draw & 3... the
//     reference uses genrand_int32() % 4 (fill_directional_index.c:131),
//     identical for unsigned draws.
// ---------------------------------------------------------------------------
void mtr_fill_di(int32_t* buf, int64_t l4_cap /* reference's array size:
                 caps the random fill exactly like min(L+4rsl, 1 Mbp);
                 the actual buffer is larger (arena headroom) */,
                 const int32_t* org,
                 int64_t L, int64_t rsl, int manhattan,
                 double* di, int64_t* di_end, int64_t* di_w) {
    const int64_t di_len = L + 2 * rsl;
    for (int64_t i = 0; i < di_len; i++) { di[i] = -1.0; di_end[i] = -1; di_w[i] = -1; }

    static thread_local std::vector<double> di_tmp_v;
    static thread_local std::vector<int64_t> D_v;
    static thread_local std::vector<int32_t> h1_v, h2_v, h0_v;
    di_tmp_v.resize(di_len);
    double* di_tmp = di_tmp_v.data();

    const int ks[3] = {1, 3, 5};
    for (int ki = 0; ki < 3; ki++) {
        const int k = ks[ki];
        const int64_t max_w = (k == 1) ? 20 : (k == 3) ? 80 : 10240;
        // --- init_input_w_rand (fill_directional_index.c:137-169) ---
        // The reference reseeds MT19937(0) per (read, k) pass, so every
        // pass consumes a PREFIX of one fixed stream: cache the stream
        // once (grown on demand) instead of re-drawing ~600k values
        // three times per read.
        const int64_t l4 = std::min(L + 4 * rsl, l4_cap);
        static thread_local std::vector<int32_t> mt_stream;
        const int64_t need = l4 + 2 * rsl;
        if ((int64_t)mt_stream.size() < need) {
            std::mt19937 mt(0);
            mt_stream.resize(need);
            for (int64_t i = 0; i < need; i++)
                mt_stream[i] = (int32_t)(mt() & 3u);
        }
        // draws l4..l4+rsl overwrite the prefix; draws l4+rsl.. fill the
        // post-read flank — identical consumption order to the reference
        std::memcpy(buf, mt_stream.data(), (size_t)l4 * 4);
        std::memcpy(buf, mt_stream.data() + l4, (size_t)rsl * 4);
        std::memcpy(buf + rsl, org, (size_t)L * 4);
        std::memcpy(buf + rsl + L, mt_stream.data() + l4 + rsl,
                    (size_t)rsl * 4);
        // in-place rolling k-mer codes over [0, L+2rsl-k+1); reads of
        // buf[i+k-1] always precede the write at i (i+k-1 >= i)
        const int64_t n_codes = L + 2 * rsl - k + 1;
        if (n_codes > 0) {
            int64_t p4k1 = 1;
            for (int t = 0; t < k - 1; t++) p4k1 *= 4;
            int64_t code = 0;
            for (int t = 0; t < k; t++) code = code * 4 + buf[t];
            for (int64_t i = 0; i < n_codes; i++) {
                int64_t next = 0;
                if (i + 1 < n_codes) next = (code % p4k1) * 4 + buf[i + k];
                buf[i] = (int32_t)code;
                code = next;
            }
        }
        // --- (k, w) sweep ---
        for (int64_t w = 5; w <= max_w && w < L / 2; w *= 2) {
            const int64_t n_i = di_len - w - rsl - k + 1;
            for (int64_t i = 0; i < di_len; i++) di_tmp[i] = -1.0;
            if (n_i > 0 && manhattan) {
                const int64_t n_out = n_i + w;
                const int64_t n_pos = n_out + 2 * w - 1;
                int32_t vmax = 0;
                for (int64_t i = 0; i < n_pos; i++) if (buf[i] > vmax) vmax = buf[i];
                if ((int64_t)h1_v.size() < vmax + 1) { h1_v.resize(vmax + 1); h2_v.resize(vmax + 1); }
                std::fill(h1_v.begin(), h1_v.begin() + vmax + 1, 0);
                std::fill(h2_v.begin(), h2_v.begin() + vmax + 1, 0);
                D_v.resize(n_out);
                int64_t* D = D_v.data();
                int32_t* h1 = h1_v.data();
                int32_t* h2 = h2_v.data();
                int64_t d = 0;
                for (int64_t i = 0; i < w; i++) { h1[buf[i]]++; h2[buf[i + w]]++; }
                for (int32_t v = 0; v <= vmax; v++) d += std::abs(h1[v] - h2[v]);
                D[0] = d;
                auto upd = [&](int32_t* ha, int32_t* hb, int32_t v, int32_t delta) {
                    d -= std::abs(ha[v] - hb[v]);
                    ha[v] += delta;
                    d += std::abs(ha[v] - hb[v]);
                };
                for (int64_t i = 1; i < n_out; i++) {
                    upd(h1, h2, buf[i - 1], -1);
                    upd(h1, h2, buf[i - 1 + w], +1);
                    upd(h2, h1, buf[i - 1 + w], -1);
                    upd(h2, h1, buf[i - 1 + 2 * w], +1);
                    D[i] = d;
                }
                // true division: reciprocal-multiply would not be
                // bit-identical to the reference's / (2*w)
                const double dw = (double)(2 * w);
                for (int64_t i = 0; i < n_i; i++)
                    di_tmp[w + i] = (double)(D[i] - D[i + w]) / dw;
            } else if (n_i > 0) {
                // Pearson mode (-p): DI = P12 - P01 over three adjacent
                // w-windows, with the zero-SD guard
                // (fill_directional_index.c:298-450).  Integer window
                // sums maintained incrementally (exact, order-free);
                // float combining matches the oracle/reference ops.
                const int64_t n_pos = n_i + 3 * w - 1;
                int32_t vmax = 0;
                for (int64_t i = 0; i < n_pos; i++) if (buf[i] > vmax) vmax = buf[i];
                if ((int64_t)h0_v.size() < vmax + 1) h0_v.resize(vmax + 1);
                if ((int64_t)h1_v.size() < vmax + 1) h1_v.resize(vmax + 1);
                if ((int64_t)h2_v.size() < vmax + 1) h2_v.resize(vmax + 1);
                std::fill(h0_v.begin(), h0_v.begin() + vmax + 1, 0);
                std::fill(h1_v.begin(), h1_v.begin() + vmax + 1, 0);
                std::fill(h2_v.begin(), h2_v.begin() + vmax + 1, 0);
                int32_t* h0 = h0_v.data();
                int32_t* h1 = h1_v.data();
                int32_t* h2 = h2_v.data();
                int64_t q0 = 0, q1 = 0, q2 = 0, ip01 = 0, ip12 = 0;
                for (int64_t i = 0; i < w; i++) {
                    h0[buf[i]]++; h1[buf[i + w]]++; h2[buf[i + 2 * w]]++;
                }
                for (int32_t v = 0; v <= vmax; v++) {
                    q0 += (int64_t)h0[v] * h0[v];
                    q1 += (int64_t)h1[v] * h1[v];
                    q2 += (int64_t)h2[v] * h2[v];
                    ip01 += (int64_t)h0[v] * h1[v];
                    ip12 += (int64_t)h1[v] * h2[v];
                }
                double n4k = 1.0;
                for (int t = 0; t < k; t++) n4k *= 4.0;
                const double s2 = (double)w * (double)w;
                auto emit = [&](int64_t i) {
                    double sd0 = std::sqrt((double)q0 * n4k - s2);
                    double sd1 = std::sqrt((double)q1 * n4k - s2);
                    double sd2 = std::sqrt((double)q2 * n4k - s2);
                    double p01 = (sd0 * sd1 > 0.0)
                        ? ((double)ip01 * n4k - s2) / (sd0 * sd1) : 0.0;
                    double p12 = (sd1 * sd2 > 0.0)
                        ? ((double)ip12 * n4k - s2) / (sd1 * sd2) : 0.0;
                    di_tmp[w + i] = p12 - p01;
                };
                emit(0);
                // per-window mutation: adjust q/ip sums around each change
                auto mut0 = [&](int32_t v, int32_t d) {
                    q0 += (int64_t)d * (2 * h0[v] + d);
                    ip01 += (int64_t)d * h1[v];
                    h0[v] += d;
                };
                auto mut1 = [&](int32_t v, int32_t d) {
                    q1 += (int64_t)d * (2 * h1[v] + d);
                    ip01 += (int64_t)d * h0[v];
                    ip12 += (int64_t)d * h2[v];
                    h1[v] += d;
                };
                auto mut2 = [&](int32_t v, int32_t d) {
                    q2 += (int64_t)d * (2 * h2[v] + d);
                    ip12 += (int64_t)d * h1[v];
                    h2[v] += d;
                };
                for (int64_t i = 1; i < n_i; i++) {
                    mut0(buf[i - 1], -1);
                    mut0(buf[i - 1 + w], +1);
                    mut1(buf[i - 1 + w], -1);
                    mut1(buf[i - 1 + 2 * w], +1);
                    mut2(buf[i - 1 + 2 * w], -1);
                    mut2(buf[i - 1 + 3 * w], +1);
                    emit(i);
                }
            }
            mtr_extrema_pair(di_tmp, di_len, w, di, di_end, di_w);
        }
    }
    // de-shift flanks back to read coordinates (:587-597)
    for (int64_t i = 0; i < L; i++) {
        di[i] = di[rsl + i];
        di_end[i] = di_end[rsl + i] - rsl;
        di_w[i] = di_w[rsl + i];
    }
    for (int64_t i = L; i < di_len; i++) { di[i] = -1.0; di_end[i] = -1; di_w[i] = -1; }
    mtr_remove_redundant(di, di_end, L, 0.98);
}

// ---------------------------------------------------------------------------
// 3. DBG walks (oracle walk_candidates; reference consensus.c:269-582)
// ---------------------------------------------------------------------------
namespace {

constexpr int MAX_PERIOD = 500;
constexpr int MIN_NUM_FREQ_UNIT = 5;
constexpr int MAX_TIEBREAKS = 1024;
constexpr int MAX_NUM_MAXNODES = 100;

// Flat open-addressing k-mer counter with epoch-stamped slots: clearing
// between queries is O(1) (bump the epoch), and the (key, stamp) pair
// packs into ONE u64 so the common probe is a single load (k-mer codes
// fit 32 bits: 4^15 = 2^30).  Thread-local; grows to the largest query
// seen.  Large tables (tens of kb ranges) are memory-latency bound, so
// the build loop prefetches slots a fixed code-stream distance ahead.
struct CountTable {
    std::vector<uint64_t> keystamp;  // key (low 32) | stamp (high 32)
    std::vector<int32_t> vals;
    uint32_t epoch = 0;
    uint64_t mask = 0;

    void reset(size_t width) {
        size_t want = 16;
        while (want < width * 2) want <<= 1;
        if (want > keystamp.size()) {
            keystamp.assign(want, 0);
            vals.assign(want, 0);
            epoch = 0;
        }
        mask = keystamp.size() - 1;
        if (++epoch == 0) {  // stamp wrap: hard clear
            std::fill(keystamp.begin(), keystamp.end(), 0ull);
            epoch = 1;
        }
    }

    inline size_t slot(int64_t node) const {
        uint64_t h = (uint64_t)node * 0x9E3779B97F4A7C15ull;
        return (size_t)(h & mask);
    }

    inline void prefetch(int64_t node) const {
        __builtin_prefetch(&keystamp[slot(node)], 1);
    }

    inline int64_t add(int64_t node) {  // returns new count
        size_t s = slot(node);
        const uint64_t want = ((uint64_t)epoch << 32) | (uint32_t)node;
        for (;;) {
            uint64_t ks = keystamp[s];
            if ((uint32_t)(ks >> 32) != epoch) {
                keystamp[s] = want;
                vals[s] = 1;
                return 1;
            }
            if (ks == want) return ++vals[s];
            s = (s + 1) & mask;
        }
    }

    inline int64_t freq(int64_t node) const {
        size_t s = slot(node);
        const uint64_t want = ((uint64_t)epoch << 32) | (uint32_t)node;
        for (;;) {
            uint64_t ks = keystamp[s];
            if ((uint32_t)(ks >> 32) != epoch) return 0;
            if (ks == want) return vals[s];
            s = (s + 1) & mask;
        }
    }

    inline void dec(int64_t node) {
        size_t s = slot(node);
        const uint64_t want = ((uint64_t)epoch << 32) | (uint32_t)node;
        for (;;) {
            uint64_t ks = keystamp[s];
            if ((uint32_t)(ks >> 32) != epoch) return;
            if (ks == want) { vals[s]--; return; }
            s = (s + 1) & mask;
        }
    }
};

// Build the value multiset of the range [qs, qe]: k-mer codes at
// positions [qs, min(qe, L-k+1)) then raw bases up to qe inclusive
// (oracle query_kmer_values).
static void query_vals(const int32_t* org, int64_t input_len, int k,
                       int64_t qs, int64_t qe, std::vector<int64_t>& vals) {
    vals.clear();
    vals.reserve(qe - qs + 1);
    int64_t km_end = std::min(qe, input_len - k + 1);
    if (km_end < qs) km_end = qs;
    // rolling codes
    int64_t code = 0;
    int64_t p4k1 = 1;
    for (int i = 0; i < k - 1; i++) p4k1 *= 4;
    for (int64_t i = qs; i < km_end; i++) {
        if (i == qs) {
            code = 0;
            for (int j = 0; j < k; j++) code = code * 4 + org[i + j];
        } else {
            code = (code % p4k1) * 4 + org[i + k - 1];
        }
        vals.push_back(code);
    }
    for (int64_t i = km_end; i <= qe; i++) vals.push_back(org[i]);
}

struct WalkOut {
    int found = 0;
    int period = 0;
    int32_t unit[MAX_PERIOD];
    int32_t scores[MAX_PERIOD];
};

// Successor memo for the greedy walk.  In the l >= 10 regime the step
// (node -> next node, freq(node)) is a pure function of the CountTable
// state — which is frozen during a query's walk phase — so the up-to-
// 100 start-node walks share one memo instead of re-running the
// k-level tie-tree lookahead (4^m candidate probes on zero-count
// frontiers) every time their paths converge.  Epoch-stamped like
// CountTable; fixed capacity with an insert cap (overflow falls back
// to direct evaluation, never wrong, never rehashes).
struct SuccCache {
    static constexpr size_t CAP = 1 << 17;
    std::vector<uint64_t> keystamp;  // node (low 32) | stamp (high 32)
    std::vector<uint64_t> val;       // next (high 32) | freq (low 32)
    uint32_t epoch = 0;
    size_t used = 0;

    void reset() {
        if (keystamp.empty()) {
            keystamp.assign(CAP, 0);
            val.assign(CAP, 0);
        }
        used = 0;
        if (++epoch == 0) {
            std::fill(keystamp.begin(), keystamp.end(), 0ull);
            epoch = 1;
        }
    }

    static inline size_t slot(int64_t node) {
        return (size_t)(((uint64_t)node * 0x9E3779B97F4A7C15ull) &
                        (CAP - 1));
    }

    inline bool get(int64_t node, uint64_t* out) const {
        size_t s = slot(node);
        const uint64_t want = ((uint64_t)epoch << 32) | (uint32_t)node;
        for (;;) {
            uint64_t ks = keystamp[s];
            if ((uint32_t)(ks >> 32) != epoch) return false;
            if (ks == want) { *out = val[s]; return true; }
            s = (s + 1) & (CAP - 1);
        }
    }

    inline void put(int64_t node, uint64_t v) {
        if (used > CAP / 2) return;  // cap load factor; stay correct
        size_t s = slot(node);
        const uint64_t want = ((uint64_t)epoch << 32) | (uint32_t)node;
        for (;;) {
            uint64_t ks = keystamp[s];
            if ((uint32_t)(ks >> 32) != epoch) {
                keystamp[s] = want;
                val[s] = v;
                used++;
                return;
            }
            if (ks == want) { val[s] = v; return; }
            s = (s + 1) & (CAP - 1);
        }
    }
};

// Shared lookahead (oracle _lookahead_step).  Returns chosen digits and
// C's post-loop value of m.
static void lookahead(const CountTable& t, int64_t node, int k, bool forward,
                      int max_lookahead, const int64_t* pow4,
                      int64_t* out_digits, int* out_m) {
    static thread_local std::vector<int64_t> list_tb, ties;
    list_tb.assign(1, 0);
    int64_t max_digits = 0;
    int m = 1;
    for (; m <= max_lookahead; m++) {
        int64_t max_count = -1;
        max_digits = 0;
        ties.clear();
        for (int64_t prev : list_tb) {
            for (int j = 0; j < 4; j++) {
                int64_t cand, tmp_node;
                if (forward) {
                    cand = 4 * prev + j;
                    tmp_node = pow4[m] * (node % pow4[k - m]) + cand;
                } else {
                    cand = (int64_t)j * pow4[m - 1] + prev;
                    tmp_node = cand * pow4[k - m] + node / pow4[m];
                }
                int64_t c = t.freq(tmp_node);
                if (max_count < c) {
                    max_count = c;
                    max_digits = cand;
                    ties.clear();
                    ties.push_back(cand);
                } else if (max_count == c && (int)ties.size() < MAX_TIEBREAKS) {
                    ties.push_back(cand);
                }
            }
        }
        bool stop = forward ? (ties.size() == 1) : (ties.size() <= 1);
        if (stop) break;
        list_tb = ties;
    }
    if (m > max_lookahead) m = max_lookahead + 1;
    *out_digits = max_digits;
    *out_m = m;
}

static void walk_forward(const CountTable& t, int64_t qs, int64_t qe,
                         int64_t node0, int k, const int64_t* pow4,
                         SuccCache& sc, WalkOut& o) {
    int64_t node = node0;
    int actual = 0;
    int64_t lmax = std::min((int64_t)MAX_PERIOD, (qe - qs) / MIN_NUM_FREQ_UNIT);
    int l = 0;
    for (; l < lmax; l++) {
        o.unit[l] = (int32_t)(node / pow4[k - 1]);
        if (l < 10) {  // lookahead-1 regime: cheap, not memoized
            o.scores[l] = (int32_t)t.freq(node);
            int64_t digits; int m;
            lookahead(t, node, k, true, 1, pow4, &digits, &m);
            node = 4 * (node % pow4[k - 1]) + digits / pow4[m - 1];
        } else {
            uint64_t packed;
            if (sc.get(node, &packed)) {
                o.scores[l] = (int32_t)(uint32_t)packed;
                node = (int64_t)(packed >> 32);
            } else {
                int32_t f = (int32_t)t.freq(node);
                int64_t digits; int m;
                lookahead(t, node, k, true, k, pow4, &digits, &m);
                int64_t nxt =
                    4 * (node % pow4[k - 1]) + digits / pow4[m - 1];
                sc.put(node, ((uint64_t)nxt << 32) | (uint32_t)f);
                o.scores[l] = f;
                node = nxt;
            }
        }
        if (node == node0) {
            actual = l + 1;
            if (actual >= MAX_PERIOD) actual = 0;
            break;
        }
    }
    o.period = actual;
    o.found = (actual != 0);
}

static void walk_backward(const CountTable& t, int64_t qs, int64_t qe,
                          int64_t node0, int k, const int64_t* pow4,
                          SuccCache& sc, WalkOut& o) {
    int64_t node = node0;
    int actual = 0;
    int64_t lmax = std::min((int64_t)MAX_PERIOD, (qe - qs) / MIN_NUM_FREQ_UNIT);
    for (int l = 0; l < lmax; l++) {
        int64_t prev = node;
        if (l < 10) {
            int64_t digits; int m;
            lookahead(t, node, k, false, 1, pow4, &digits, &m);
            node = (digits % 4) * pow4[k - 1] + node / 4;
        } else {
            uint64_t packed;
            if (sc.get(prev, &packed)) {
                node = (int64_t)(packed >> 32);
            } else {
                int64_t digits; int m;
                lookahead(t, node, k, false, k, pow4, &digits, &m);
                node = (digits % 4) * pow4[k - 1] + node / 4;
                sc.put(prev, ((uint64_t)node << 32));
            }
        }
        o.unit[l] = (int32_t)(node / pow4[k - 1]);
        o.scores[l] = (int32_t)t.freq(node);
        if (node == node0) {
            actual = l + 1;
            if (actual >= MAX_PERIOD) actual = 0;
            break;
        }
    }
    if (actual == 0) { o.found = 0; o.period = 0; return; }
    std::reverse(o.unit, o.unit + actual);
    std::reverse(o.scores, o.scores + actual);
    o.found = (actual < MAX_PERIOD);
    o.period = (actual < MAX_PERIOD) ? actual : 0;
}

}  // namespace

// One (range, k) query.  Mirrors oracle walk_candidates: up to one
// candidate per direction (first looping start node), plus the
// last-backward-attempt foundLoop return value.  out_pure_max (may be
// null) receives the max count seen during the PURE k-mer phase of
// the table build (before the raw-base tail) — the quantity that
// bounds every larger k's reachable max_freq (see the ascending-k
// early-out in mtr_dbg_walk_batch2).
int mtr_dbg_walk(const int32_t* org, int64_t input_len, int64_t qs, int64_t qe,
                 int k,
                 int* fwd_found, int* fwd_period, int32_t* fwd_unit, int32_t* fwd_scores,
                 int* bwd_found, int* bwd_period, int32_t* bwd_unit, int32_t* bwd_scores,
                 int64_t* out_pure_max) {
    *fwd_found = 0; *bwd_found = 0; *fwd_period = 0; *bwd_period = 0;
    int64_t pow4[16];
    pow4[0] = 1;
    for (int i = 1; i <= 15; i++) pow4[i] = pow4[i - 1] * 4;

    const bool timed = g_timers_on.load(std::memory_order_relaxed);
    int64_t t0 = timed ? now_ns() : 0;

    static thread_local std::vector<int64_t> vals;
    static thread_local CountTable t;
    int64_t max_freq = -1;
    int64_t pure_max = 0;  // max count over the k-mer phase only
    int64_t t1 = t0;
    if (timed) {
        // exact per-stage attribution (-c): separate vals pass (the
        // reference's init_inputString) and count pass
        query_vals(org, input_len, k, qs, qe, vals);
        t1 = now_ns();
        t.reset(vals.size());
        int64_t km_count = std::max((int64_t)0,
                                    std::min(qe, input_len - k + 1) - qs);
        for (size_t vi = 0; vi < vals.size(); vi++) {
            int64_t c = t.add(vals[vi]);
            if (c > max_freq) max_freq = c;
            if ((int64_t)vi < km_count && c > pure_max) pure_max = c;
        }
    } else {
        // fast path: rolling codes feed the table directly (one pass,
        // no vals memory traffic); vals is only materialized if the
        // max-node list will actually be consulted
        t.reset(qe - qs + 1);
        int64_t km_end = std::min(qe, input_len - k + 1);
        if (km_end < qs) km_end = qs;
        int64_t p4k1 = 1;
        for (int i = 0; i < k - 1; i++) p4k1 *= 4;
        // a second rolling code D positions ahead drives slot prefetch:
        // large tables are memory-latency bound and the future code
        // stream is fully known
        const int64_t D = 16;
        int64_t code = 0, lead = 0;
        for (int64_t i = qs; i < km_end; i++) {
            if (i == qs) {
                code = 0;
                for (int j = 0; j < k; j++) code = code * 4 + org[i + j];
                if (qs + D < km_end) {
                    lead = 0;
                    for (int j = 0; j < k; j++)
                        lead = lead * 4 + org[qs + D + j];
                    t.prefetch(lead);
                }
            } else {
                code = (code % p4k1) * 4 + org[i + k - 1];
                if (i + D < km_end) {
                    lead = (lead % p4k1) * 4 + org[i + D + k - 1];
                    t.prefetch(lead);
                }
            }
            int64_t c = t.add(code);
            if (c > max_freq) max_freq = c;
        }
        pure_max = std::max(max_freq, (int64_t)0);
        for (int64_t i = km_end; i <= qe; i++) {
            int64_t c = t.add(org[i]);
            if (c > max_freq) max_freq = c;
        }
    }
    if (out_pure_max) *out_pure_max = pure_max;
    // max-node list in first-occurrence order; counts are decremented in
    // the live table (the reference never restores them — consensus.c:
    // 156-164, 199-222 — so the walk sees maxFreq-1 for listed nodes).
    // The list is only CONSULTED when max_freq > 5 (consensus.c:532);
    // below that the table is discarded unwalked, so the scan is skipped.
    static thread_local std::vector<int64_t> max_nodes;
    max_nodes.clear();
    if (max_freq > MIN_NUM_FREQ_UNIT) {
        if (!timed) query_vals(org, input_len, k, qs, qe, vals);
        const size_t nvals = vals.size();
        for (size_t ii = 0; ii < nvals; ii++) {
            if (ii + 16 < nvals) t.prefetch(vals[ii + 16]);
            int64_t v = vals[ii];
            if (t.freq(v) == max_freq) {
                max_nodes.push_back(v);
                t.dec(v);
                if ((int)max_nodes.size() >= MAX_NUM_MAXNODES) break;
            }
        }
    }

    int64_t t2 = timed ? now_ns() : 0;
    if (timed) {
        g_init_ns.fetch_add(t1 - t0, std::memory_order_relaxed);
        g_count_ns.fetch_add(t2 - t1, std::memory_order_relaxed);
    }

    int found = 0;
    if (max_freq > MIN_NUM_FREQ_UNIT) {
        WalkOut o;
        static thread_local SuccCache succ_f, succ_b;
        succ_f.reset();
        succ_b.reset();
        for (int dir = 0; dir < 2; dir++) {
            for (int64_t node : max_nodes) {
                o.found = 0; o.period = 0;
                if (dir == 0) walk_forward(t, qs, qe, node, k, pow4,
                                           succ_f, o);
                else          walk_backward(t, qs, qe, node, k, pow4,
                                            succ_b, o);
                found = o.found;
                if (o.period >= MAX_PERIOD) found = 0;
                if (found == 1) {
                    if (dir == 0) {
                        *fwd_found = 1; *fwd_period = o.period;
                        std::memcpy(fwd_unit, o.unit, o.period * 4);
                        std::memcpy(fwd_scores, o.scores, o.period * 4);
                    } else {
                        *bwd_found = 1; *bwd_period = o.period;
                        std::memcpy(bwd_unit, o.unit, o.period * 4);
                        std::memcpy(bwd_scores, o.scores, o.period * 4);
                    }
                    break;  // first loop ends this direction
                }
            }
        }
    }
    if (timed) g_walk_ns.fetch_add(now_ns() - t2, std::memory_order_relaxed);
    return found;
}

void mtr_stage_timers(int enable) {
    g_timers_on.store(enable, std::memory_order_relaxed);
}

// out3 = {init_ns, count_ns, walk_ns}; reset != 0 zeroes the accumulators
void mtr_stage_read(int64_t* out3, int reset) {
    out3[0] = g_init_ns.load(std::memory_order_relaxed);
    out3[1] = g_count_ns.load(std::memory_order_relaxed);
    out3[2] = g_walk_ns.load(std::memory_order_relaxed);
    if (reset) { g_init_ns = 0; g_count_ns = 0; g_walk_ns = 0; }
}

// Batched walks with worker threads (queries are independent).
void mtr_dbg_walk_batch(const int32_t* const* orgs, const int64_t* input_lens,
                        const int64_t* qss, const int64_t* qes, const int32_t* ks,
                        int64_t n,
                        int* fwd_found, int* fwd_period, int32_t* fwd_units, int32_t* fwd_scores,
                        int* bwd_found, int* bwd_period, int32_t* bwd_units, int32_t* bwd_scores,
                        int* found_last, int n_threads) {
    if (n_threads < 1) n_threads = std::max(1u, std::thread::hardware_concurrency());
    auto work = [&](int tid) {
        for (int64_t i = tid; i < n; i += n_threads) {
            found_last[i] = mtr_dbg_walk(
                orgs[i], input_lens[i], qss[i], qes[i], ks[i],
                &fwd_found[i], &fwd_period[i],
                fwd_units + i * MAX_PERIOD, fwd_scores + i * MAX_PERIOD,
                &bwd_found[i], &bwd_period[i],
                bwd_units + i * MAX_PERIOD, bwd_scores + i * MAX_PERIOD,
                nullptr);
        }
    };
    if (n_threads <= 1 || n < 2) { work(0); return; }
    WorkPool::inst().run(n_threads, work);
}

// Compact-output batched walks.  Only a few percent of queries yield a
// looping unit, so dense (n, 500) unit/score outputs would consume ~8 KB
// of fresh memory per query (expensive on lazy-memory hosts).  Here a
// found walk claims one row of (units_out, scores_out) via an atomic
// counter; per-query fwd_row/bwd_row hold the claimed row or -1.  Reads
// are addressed as a table + per-query index so callers can reuse one
// pointer array per batch of reads.  Returns the number of rows needed;
// if it exceeds cap the caller must retry with a larger buffer (rows
// beyond cap are counted but not written).
int64_t mtr_dbg_walk_batch2(const int32_t* const* org_table, const int64_t* len_table,
                            const int32_t* read_idx, const int32_t* qss,
                            const int32_t* qes, const int32_t* ks, int64_t n,
                            int32_t* fwd_row, int32_t* bwd_row,
                            int32_t* fwd_period, int32_t* bwd_period,
                            int32_t* found_last,
                            int32_t* units_out, int32_t* scores_out,
                            int64_t cap, int n_threads) {
    if (n_threads < 1) n_threads = std::max(1u, std::thread::hardware_concurrency());
    std::atomic<int64_t> next_row(0);
    // Ascending-k early-out.  Callers emit each range's k sweep as a
    // consecutive ascending run (pipeline._collect_queries).  The pure
    // k-mer max P is non-increasing in k (every k-mer occurrence
    // contains its (k-1)-prefix), and the raw-base tail of length
    // t(k) = qe - min(qe, L-k+1) + 1 can raise any value's count by at
    // most t (an A^(k-1)X k-mer colliding with a raw base <= 3).  A
    // walk happens only when max_freq > MIN_NUM_FREQ_UNIT, so once
    // P + t(k) <= MIN_NUM_FREQ_UNIT every remaining larger k of the
    // run is provably unwalked: emit found=0 without building its
    // table.  Threads claim whole runs (atomic cursor) so the bound
    // always comes from the same range.
    std::vector<int64_t> run_start;
    run_start.reserve((size_t)(n / 4) + 16);
    for (int64_t i = 0; i < n; i++) {
        if (i == 0 || read_idx[i] != read_idx[i - 1] ||
            qss[i] != qss[i - 1] || qes[i] != qes[i - 1] ||
            ks[i] <= ks[i - 1])
            run_start.push_back(i);
    }
    const int64_t n_runs = (int64_t)run_start.size();
    std::atomic<int64_t> run_cursor(0);
    auto work = [&](int tid) {
        (void)tid;
        WalkOut scratch[2];
        int ff, fp, bf, bp;
        for (;;) {
            int64_t r = run_cursor.fetch_add(1, std::memory_order_relaxed);
            if (r >= n_runs) break;
            const int64_t lo = run_start[r];
            const int64_t hi = (r + 1 < n_runs) ? run_start[r + 1] : n;
            const int64_t L = len_table[read_idx[lo]];
            int64_t bound = INT64_MAX;  // pure k-mer max of this run
            for (int64_t i = lo; i < hi; i++) {
                int64_t tail =
                    qes[i] - std::min<int64_t>(qes[i], L - ks[i] + 1) + 1;
                if (bound != INT64_MAX &&
                    bound + tail <= MIN_NUM_FREQ_UNIT) {
                    found_last[i] = 0;
                    fwd_period[i] = 0;
                    bwd_period[i] = 0;
                    fwd_row[i] = -1;
                    bwd_row[i] = -1;
                    continue;
                }
                int64_t pure_max = 0;
                found_last[i] = mtr_dbg_walk(
                    org_table[read_idx[i]], L,
                    qss[i], qes[i], ks[i],
                    &ff, &fp, scratch[0].unit, scratch[0].scores,
                    &bf, &bp, scratch[1].unit, scratch[1].scores,
                    &pure_max);
                if (pure_max < bound) bound = pure_max;
                fwd_period[i] = fp;
                bwd_period[i] = bp;
                fwd_row[i] = -1;
                bwd_row[i] = -1;
                if (ff) {
                    int64_t row =
                        next_row.fetch_add(1, std::memory_order_relaxed);
                    if (row < cap) {
                        std::memcpy(units_out + row * MAX_PERIOD,
                                    scratch[0].unit, fp * 4);
                        std::memcpy(scores_out + row * MAX_PERIOD,
                                    scratch[0].scores, fp * 4);
                        fwd_row[i] = (int32_t)row;
                    }
                }
                if (bf) {
                    int64_t row =
                        next_row.fetch_add(1, std::memory_order_relaxed);
                    if (row < cap) {
                        std::memcpy(units_out + row * MAX_PERIOD,
                                    scratch[1].unit, bp * 4);
                        std::memcpy(scores_out + row * MAX_PERIOD,
                                    scratch[1].scores, bp * 4);
                        bwd_row[i] = (int32_t)row;
                    }
                }
            }
        }
    };
    if (n_threads <= 1 || n < 2) work(0);
    else WorkPool::inst().run(n_threads, work);
    return next_row.load();
}

// ---------------------------------------------------------------------------
// 4/5. move-tensor tracebacks (oracle ops/wrap_dp.py traceback_from_moves /
//      consensus_from_moves; reference wrap_around_DP.c:294-333)
// ---------------------------------------------------------------------------
void mtr_traceback_counts(const uint8_t* moves, int64_t u_pad,
                          int64_t max_i, int64_t max_j,
                          const int32_t* rep, const int32_t* unit, int64_t unit_len,
                          int64_t* out5, int64_t* i_final) {
    int64_t i = max_i, j = max_j;
    if (j == 0) j = unit_len;
    int64_t m = 0, x = 0, ins = 0, del = 0;
    while (i > 0) {
        uint8_t mv = moves[i * u_pad + (j - 1)];
        if (mv == 0) break;
        if (mv == 1) { if (rep[i - 1] == unit[j - 1]) m++; else x++; i--; j--; }
        else if (mv == 2) { del++; j--; }
        else { ins++; i--; }
        if (j == 0) j = unit_len;
    }
    out5[0] = m; out5[1] = x; out5[2] = ins; out5[3] = del; out5[4] = m + x + del;
    *i_final = i;
}

void mtr_traceback_consensus(const uint8_t* moves, int64_t u_pad,
                             int64_t max_i, int64_t max_j,
                             const int32_t* rep, int64_t unit_len,
                             int64_t* consensus /*(500,5)*/, int64_t* missing /*(500,4)*/) {
    int64_t i = max_i, j = max_j;
    if (j == 0) j = unit_len;
    while (i > 0) {
        uint8_t mv = moves[i * u_pad + (j - 1)];
        if (mv == 0) break;
        if (mv == 1) { consensus[j * 5 + rep[i - 1]]++; i--; j--; }
        else if (mv == 2) { consensus[j * 5 + 4]++; j--; }
        else { missing[j * 4 + rep[i - 1]]++; i--; }
        if (j == 0) j = unit_len;
    }
}

void mtr_traceback_counts_batch(const uint8_t* const* moves, const int64_t* u_pads,
                                const int64_t* max_is, const int64_t* max_js,
                                const int32_t* const* reps, const int32_t* const* units,
                                const int64_t* unit_lens, int64_t n,
                                int64_t* out5s /* n x 5 */, int64_t* i_finals,
                                int n_threads) {
    if (n_threads < 1) n_threads = std::max(1u, std::thread::hardware_concurrency());
    auto work = [&](int tid) {
        for (int64_t i = tid; i < n; i += n_threads)
            mtr_traceback_counts(moves[i], u_pads[i], max_is[i], max_js[i],
                                 reps[i], units[i], unit_lens[i],
                                 out5s + i * 5, &i_finals[i]);
    };
    if (n_threads <= 1 || n < 2) { work(0); return; }
    WorkPool::inst().run(n_threads, work);
}

// ---------------------------------------------------------------------------
// 5b. unit polishing (oracle polish_repeat; reference consensus.c:610-704)
//     Returns the revised period, or -1 when polishing bails (j_revised
//     underflow) leaving the unit unchanged.
// ---------------------------------------------------------------------------
static int64_t score_for_alignment(int64_t start, int k, int64_t best_node,
                                   int64_t rep_period, const int32_t* int_unit,
                                   const CountTable& t, const int64_t* pow4) {
    int64_t tmp_node = best_node;
    int64_t s = 0;
    for (int64_t j = start; 0 <= j && start - k < j; j--) {
        tmp_node = (int64_t)int_unit[j % rep_period] * pow4[k - 1] + tmp_node / 4;
        s += t.freq(tmp_node);
    }
    return s;
}

static bool suspicious(const int32_t* scores, int k, int64_t j) {
    int cnt = 0;
    for (int i = 0; i < k - 1 && 0 <= j - i; i++)
        if (scores[j - i] < 2) cnt++;
    return (k - 1) * 0.8 < (double)cnt;
}

int mtr_polish(const int32_t* org, int64_t input_len, int64_t rep_start,
               int64_t rep_end, int k, const int32_t* unit_in,
               const int32_t* scores_in, int period_in, int32_t* unit_out) {
    if (period_in <= k) return period_in;  // no polish (returns unchanged)
    int64_t pow4[16];
    pow4[0] = 1;
    for (int i = 1; i <= 15; i++) pow4[i] = pow4[i - 1] * 4;

    static thread_local std::vector<int64_t> vals;
    query_vals(org, input_len, k, rep_start, rep_end, vals);
    static thread_local CountTable t;
    t.reset(vals.size());
    for (int64_t v : vals) t.add(v);

    int64_t rep_period = period_in;
    int32_t revised[MAX_PERIOD];
    int64_t j_revised = MAX_PERIOD - 1;

    int64_t ref_node = 0;
    for (int i = 0; i < k; i++)
        ref_node = (int64_t)unit_in[i] * pow4[k - 1 - i] + ref_node;
    int64_t best_node = ref_node;

    int64_t j = rep_period - 1;
    while (0 <= j) {
        ref_node = (int64_t)unit_in[j] * pow4[k - 1] + best_node / 4;
        int64_t tmp_best = t.freq(ref_node);
        best_node = ref_node;
        if (scores_in[j] == 1 && suspicious(scores_in, k, j)) {
            for (int l = 0; l < 4; l++) {
                int64_t alt = (ref_node + (int64_t)(l - unit_in[j]) * pow4[k - 1]) % pow4[k];
                if (tmp_best < t.freq(alt)) { tmp_best = t.freq(alt); best_node = alt; }
            }
            if (best_node == ref_node) {
                revised[j_revised--] = unit_in[j--];
            } else {
                int64_t sd = score_for_alignment(j, k, best_node, rep_period, unit_in, t, pow4);
                int64_t ss = score_for_alignment(j - 1, k, best_node, rep_period, unit_in, t, pow4);
                int64_t si = -1;
                // (j-1) % rep_period: python semantics (the oracle reads
                // int_unit[-1] = last base on the j==0 edge — see
                // oracle/consensus.py polish_repeat docstring)
                int64_t jm = ((j - 1) % rep_period + rep_period) % rep_period;
                if (best_node / pow4[k - 1] == unit_in[jm])
                    si = score_for_alignment(j - 2, k, best_node, rep_period, unit_in, t, pow4);
                revised[j_revised--] = (int32_t)(best_node / pow4[k - 1]);
                int64_t mx = std::max(std::max(sd, ss), si);
                if (mx == sd) { /* keep j */ }
                else if (mx == ss) j -= 1;
                else j -= 2;
            }
        } else {
            revised[j_revised--] = unit_in[j--];
        }
        if (j_revised < 0) return -1;  // fails to revise: unit unchanged
    }
    int out_period = (int)((MAX_PERIOD - 1) - j_revised);
    std::memcpy(unit_out, revised + j_revised + 1, out_period * 4);
    return out_period;
}

// ---------------------------------------------------------------------------
// 6. wrap-around DP on host — scalar fill + traceback mirroring
//    wrap_around_DP.c:222-354 bit-for-bit (same recurrence, row-major
//    first-occurrence argmax, traceback precedence M > X > D > I).
//    Used as the device-kernel fallback and as a cross-check engine.
// ---------------------------------------------------------------------------
namespace {

struct DPOut {
    int64_t m = 0, x = 0, ins = 0, del = 0, scanned = 0;
    int64_t i_final = 0, max_i = 0;
};

// mode 0: counts only; mode 1: consensus/missing accumulation
#if defined(__AVX512F__)
// Vectorized row fill (16 int32 lanes).  The within-row deletion chain
// v[j] = max(base[j], v[j-1]-ip) — broken at match cells, which take
// diag+mg unconditionally but still feed the chain — is resolved with
// an encoding the device engines share in spirit: a
// single inclusive prefix-MAX over enc = base + ip*j + seg*SEGK, where
// seg counts match cells at positions <= j.  A chain l -> j is legal
// iff no match lies in (l, j], i.e. seg[l] == seg[j]; any illegal lane
// decodes SEGK (~4M) too low and loses automatically — no masks, no
// segment edges.  Cross-block state is two scalars (seg count, running
// enc max).  Decoded values are bit-identical to the scalar loop, so
// the traceback below is unchanged.
static const int32_t SEGK_SHIFT = 22;  // 500 * 2^22 + enc < 2^31

static inline __m512i shl_lanes(__m512i x, __m512i fill, int n) {
    switch (n) {  // result[j] = x[j-n] for j >= n else fill[j]
        case 1: return _mm512_alignr_epi32(x, fill, 15);
        case 2: return _mm512_alignr_epi32(x, fill, 14);
        case 4: return _mm512_alignr_epi32(x, fill, 12);
        default: return _mm512_alignr_epi32(x, fill, 8);
    }
}

static void wrap_dp_fill_avx512(const int32_t* rep, int64_t rep_len,
                                const int32_t* unit, int64_t unit_len,
                                int32_t mg, int32_t mp, int32_t ip,
                                int32_t* D, int64_t stride,
                                int64_t* o_max, int64_t* o_mi, int64_t* o_mj) {
    const int64_t nb = (unit_len + 15) / 16;
    const __m512i vmg = _mm512_set1_epi32(mg);
    const __m512i vmp = _mm512_set1_epi32(mp);
    const __m512i vip = _mm512_set1_epi32(ip);
    const __m512i vzero = _mm512_setzero_si512();
    const __m512i vmin = _mm512_set1_epi32(INT32_MIN);
    const __m512i iota = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8,
                                           9, 10, 11, 12, 13, 14, 15);
    int64_t max_wrd = 0, max_i = 0, max_j = 0;
    // per-block ip*j vectors and tail masks (unit_len <= 500 -> <= 32)
    __m512i ipj[32];
    __mmask16 vmask[32];
    for (int64_t b = 0; b < nb; b++) {
        int64_t jb = 1 + b * 16;
        ipj[b] = _mm512_mullo_epi32(
            _mm512_add_epi32(iota, _mm512_set1_epi32((int32_t)jb)), vip);
        int64_t rem = unit_len - jb + 1;
        vmask[b] = rem >= 16 ? (__mmask16)0xFFFF
                             : (__mmask16)((1u << rem) - 1u);
    }
    for (int64_t i = 1; i <= rep_len; i++) {
        const __m512i vri = _mm512_set1_epi32(rep[i - 1]);
        int32_t* cur = D + i * stride;
        const int32_t* prev = D + (i - 1) * stride;
        int32_t carry_seg = 0;
        __m512i carry_max = vmin;
        __m512i rowmaxv = vzero;
        for (int64_t b = 0; b < nb; b++) {
            const int64_t jb = 1 + b * 16;
            const __m512i diag = _mm512_loadu_si512(prev + jb - 1);
            const __m512i up = _mm512_loadu_si512(prev + jb);
            // masked: the unit row is only unit_len (<= 500) slots and
            // a plain tail load could cross the allocation end
            const __m512i uv = _mm512_maskz_loadu_epi32(
                vmask[b], unit + jb - 1);
            const __mmask16 eq = _mm512_cmpeq_epi32_mask(vri, uv);
            __m512i mis = _mm512_max_epi32(
                _mm512_sub_epi32(diag, vmp), _mm512_sub_epi32(up, vip));
            mis = _mm512_max_epi32(mis, vzero);
            const __m512i base = _mm512_mask_blend_epi32(
                eq, mis, _mm512_add_epi32(diag, vmg));
            // seg = prefix count of match lanes (incl. self) + carry
            __m512i s = _mm512_maskz_mov_epi32(eq, _mm512_set1_epi32(1));
            s = _mm512_add_epi32(s, shl_lanes(s, vzero, 1));
            s = _mm512_add_epi32(s, shl_lanes(s, vzero, 2));
            s = _mm512_add_epi32(s, shl_lanes(s, vzero, 4));
            s = _mm512_add_epi32(s, shl_lanes(s, vzero, 8));
            const __m512i seg = _mm512_add_epi32(
                s, _mm512_set1_epi32(carry_seg));
            const __m512i segk = _mm512_slli_epi32(seg, SEGK_SHIFT);
            __m512i enc = _mm512_add_epi32(
                _mm512_add_epi32(base, ipj[b]), segk);
            // invalid tail lanes must not poison the prefix max
            enc = _mm512_mask_mov_epi32(vmin, vmask[b], enc);
            __m512i m = _mm512_max_epi32(enc, shl_lanes(enc, vmin, 1));
            m = _mm512_max_epi32(m, shl_lanes(m, vmin, 2));
            m = _mm512_max_epi32(m, shl_lanes(m, vmin, 4));
            m = _mm512_max_epi32(m, shl_lanes(m, vmin, 8));
            m = _mm512_max_epi32(m, carry_max);
            const __m512i R = _mm512_max_epi32(
                base, _mm512_sub_epi32(_mm512_sub_epi32(m, ipj[b]), segk));
            _mm512_mask_storeu_epi32(cur + jb, vmask[b], R);
            rowmaxv = _mm512_max_epi32(
                rowmaxv, _mm512_maskz_mov_epi32(vmask[b], R));
            if (b + 1 < nb) {
                alignas(64) int32_t tmp[16];
                _mm512_storeu_si512(tmp, m);
                carry_max = _mm512_set1_epi32(tmp[15]);
                _mm512_storeu_si512(tmp, seg);
                carry_seg = tmp[15];
            }
        }
        cur[0] = cur[unit_len];  // wrap column
        const int32_t rowmax = _mm512_reduce_max_epi32(rowmaxv);
        if (rowmax > max_wrd) {  // first row, then first j, as in C
            max_wrd = rowmax;
            max_i = i;
            const __m512i vr = _mm512_set1_epi32(rowmax);
            for (int64_t b = 0; b < nb; b++) {
                const int64_t jb = 1 + b * 16;
                __mmask16 hit = _mm512_mask_cmpeq_epi32_mask(
                    vmask[b],
                    _mm512_maskz_loadu_epi32(vmask[b], cur + jb), vr);
                if (hit) {
                    max_j = jb + __builtin_ctz((unsigned)hit);
                    break;
                }
            }
        }
    }
    *o_max = max_wrd; *o_mi = max_i; *o_mj = max_j;
}
#endif  // __AVX512F__

static void wrap_dp_one(const int32_t* rep /*1-origin via rep[i-1]*/, int64_t rep_len,
                        const int32_t* unit, int64_t unit_len,
                        int32_t mg, int32_t mp, int32_t ip, int mode,
                        DPOut* out, int64_t* consensus /*(500,5)*/,
                        int64_t* missing /*(500,4)*/,
                        std::vector<int32_t>& Dbuf) {
    int64_t stride = unit_len + 1;
    // +16 slack: the vector path's unaligned `up` loads can read up to
    // 15 lanes past the final row when unit_len < 13 (values masked)
    Dbuf.assign((rep_len + 1) * stride + 16, 0);
    int32_t* D = Dbuf.data();
    int64_t max_wrd = 0, max_i = 0, max_j = 0;
#if defined(__AVX512F__)
    // the seg encoding needs base + ip*j < 2^22 (see above); mg = 1
    // schemes cover reps to 4 Mbp, mg = 5 only occurs in coverage-
    // bounded polish re-scoring — the guard is belt and braces
    if (unit_len >= 1 &&
        rep_len * (int64_t)mg + ip * (unit_len + 1) < (1 << SEGK_SHIFT)) {
        // the unit array is only guaranteed for unit_len entries; the
        // tail-masked loads may touch up to 15 lanes past it, which is
        // safe because callers pass 500-slot unit rows (mtr_wrap_dp_
        // batch layout) — assert the contract statically at the call
        wrap_dp_fill_avx512(rep, rep_len, unit, unit_len, mg, mp, ip,
                            D, stride, &max_wrd, &max_i, &max_j);
    } else
#endif
    for (int64_t i = 1; unit_len >= 1 && i <= rep_len; i++) {
        int32_t ri = rep[i - 1];
        int32_t* cur = D + i * stride;
        const int32_t* prev = D + (i - 1) * stride;
        // j == 1 has no insertion-from-left candidate (j > 1 guard in
        // wrap_around_DP.c:269-274); peeled so the main loop is
        // branchless — the match/mismatch branch is ~70/30 and
        // data-dependent, so cmov beats prediction by ~20%
        {
            int32_t diag = prev[0];
            int32_t mis = std::max(std::max(diag - mp, prev[1] - ip), 0);
            int32_t v = (ri == unit[0]) ? diag + mg : mis;
            cur[1] = v;
            if (max_wrd < v) { max_wrd = v; max_i = i; max_j = 1; }
        }
        for (int64_t j = 2; j <= unit_len; j++) {
            int32_t diag = prev[j - 1];
            int32_t a = diag - mp;
            int32_t b = prev[j] - ip;
            int32_t c = cur[j - 1] - ip;
            int32_t mis = a > b ? a : b;
            mis = c > mis ? c : mis;
            mis = mis > 0 ? mis : 0;
            int32_t v = (ri == unit[j - 1]) ? diag + mg : mis;
            cur[j] = v;
            if (max_wrd < v) { max_wrd = v; max_i = i; max_j = j; }
        }
        cur[0] = cur[unit_len];  // wrap column
    }
    int64_t i = max_i, j = max_j;
    if (j == 0) j = unit_len;
    int64_t v = max_wrd;
    while (i > 0 && D[i * stride + j] > 0) {
        const int32_t* prev = D + (i - 1) * stride;
        const int32_t* cur = D + i * stride;
        if (rep[i - 1] == unit[j - 1] && v == prev[j - 1] + mg) {
            if (mode) consensus[j * 5 + rep[i - 1]]++;
            else { out->m++; out->scanned++; }
            v -= mg; i--; j--;
        } else if (rep[i - 1] != unit[j - 1] && v == prev[j - 1] - mp) {
            if (mode) consensus[j * 5 + rep[i - 1]]++;
            else { out->x++; out->scanned++; }
            v += mp; i--; j--;
        } else if (v == cur[j - 1] - ip) {
            if (mode) consensus[j * 5 + 4]++;
            else { out->del++; out->scanned++; }
            v += ip; j--;
        } else if (v == prev[j] - ip) {
            if (mode) missing[j * 4 + rep[i - 1]]++;
            else out->ins++;
            v += ip; i--;
        } else {
            break;  // v == 0
        }
        if (j == 0) j = unit_len;
    }
    out->i_final = i;
    out->max_i = max_i;
}

}  // namespace

// Batched host DP.  Layout per job:
//   units: (n, 500) int32, unit_lens (n,), schemes (n, 3) int32
//   outputs counts: (n, 7) int64 [m, x, ins, del, scanned, i_final, max_i]
//   consensus mode: consensus (n, 500, 5) int64, missing (n, 500, 4) int64
void mtr_wrap_dp_batch(const int32_t* const* orgs, const int64_t* qss,
                       const int64_t* qes, const int32_t* units,
                       const int32_t* unit_lens, const int32_t* schemes,
                       const int32_t* modes, int64_t n,
                       int64_t* counts, int64_t* consensus, int64_t* missing,
                       int n_threads) {
    if (n_threads < 1) n_threads = std::max(1u, std::thread::hardware_concurrency());
    auto work = [&](int tid) {
        std::vector<int32_t> Dbuf;
        for (int64_t q = tid; q < n; q += n_threads) {
            int64_t rep_len = qes[q] - qss[q] + 1;
            const int32_t* rep = orgs[q] + qss[q] + 1;
            DPOut o;
            int64_t* cons_q = modes[q] ? consensus + q * 2500 : nullptr;
            int64_t* miss_q = modes[q] ? missing + q * 2000 : nullptr;
            wrap_dp_one(rep, rep_len, units + q * 500, unit_lens[q],
                        schemes[q * 3], schemes[q * 3 + 1], schemes[q * 3 + 2],
                        modes[q], &o, cons_q, miss_q, Dbuf);
            int64_t* c = counts + q * 7;
            c[0] = o.m; c[1] = o.x; c[2] = o.ins; c[3] = o.del;
            c[4] = o.scanned; c[5] = o.i_final; c[6] = o.max_i;
        }
    };
    if (n_threads <= 1 || n < 2) { work(0); return; }
    WorkPool::inst().run(n_threads, work);
}

}  // extern "C"
