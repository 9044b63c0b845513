// Port of tntblast_tpu/native/frag_search.cpp: the same search; a device
// result's kept seeds reach a context in one call a panel group
// (tnt_frag_inject_block), the evaluation filter factored out of
// tnt_frag_set_evals so that both use it; a work item's assays run in one
// call (tnt_frag_search_panel).
// Fragment-level assay search: the host-side hot loop.
//
// Implements, natively, the per-(fragment, assay) search pipeline the
// Python layer orchestrates: k-mer seeding (reference seq_hash.h),
// unique-diagonal dedup + candidate window evaluation with per-fragment
// melt caches (reference bind_oligo.cpp), seed culling and PCR/TaqMan
// pairing (reference amplicon_search.cpp), hybridization probe search
// (reference probe_search.cpp) and padlock/MIPS ligation pairing
// (reference padlock_search.cpp).
//
// Ordering contracts: the reference keeps oligo_info records in
// std::list and sorts with std::list::sort under comparators that are
// not all strict weak orders (sort_by_oligo_loc switches keys between
// bound and unbound entries, amplicon_search.cpp:12-26).  Records here
// live in flat vectors (no per-node allocation), sorted with an explicit
// port of libstdc++'s binary-counter mergesort (list_sort_vec below) so
// the output permutation is the reference's for ANY comparator.
//
// This translation unit #includes melt_engine.cpp (anonymous-namespace
// internals are shared); the build compiles only this file.

#include "melt_engine.cpp"

#include <unordered_map>
#include <map>
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <x86intrin.h>

namespace {

// mask bits (reference tntblast.h:147-154)
enum { OM_F = 1, OM_R = 2, OM_P = 4,
       OM_PLUS = 8, OM_MINUS = 16, OM_VALID = 32 };

constexpr int NUM_FLANK_BASE_C = 4;   // reference tntblast.h:76
constexpr int DB_MAX_ATGC_C = 3;      // A,C,G,T db codes (seq.h:12-16)

// db code -> melt code, plus strand / complement (constants.py maps;
// reference bind_oligo.cpp:187-254). 255 = dropped (gap/unknown).
static const uint8_t DB2MELT_PLUS[18] = {
    0, 1, 2, 3, 4,          // A C G T I
    7, 8, 9, 10, 11,        // M R S V W
    12, 13, 14, 15, 16, 17, // Y H K D B N
    255, 255};
static const uint8_t DB2MELT_COMP[18] = {
    3, 2, 1, 0, 4,          // T G C A I
    14, 12, 9, 16, 11,      // K Y S B W
    8, 15, 7, 13, 10, 17,   // R D M H V N
    255, 255};

struct OligoInfoC {
    int loc_5 = 0, loc_3 = 0;
    float tm = -1.0f, dH = -1.0f, dS = -1.0f;
    unsigned anchor_5 = 0, anchor_3 = 0, num_mm = 0, num_gap = 0;
    std::string alignment;
    unsigned query_loc = 0, target_loc = 0;
    unsigned char mask = 0;

    OligoInfoC() = default;
    OligoInfoC(unsigned q, unsigned t, unsigned char m)
        : query_loc(q), target_loc(t), mask(m) {}
};

// oligo_info::operator< (reference tntblast.h:230-242)
inline bool bound_less(const OligoInfoC& a, const OligoInfoC& b)
{
    if (a.loc_5 != b.loc_5) return a.loc_5 < b.loc_5;
    if (a.loc_3 != b.loc_3) return a.loc_3 < b.loc_3;
    return a.tm > b.tm;
}

// sort_by_bound_match (reference bind_oligo.cpp:49-82)
inline bool bound_match_less(const OligoInfoC& a, const OligoInfoC& b)
{
    if (a.loc_5 != b.loc_5) return a.loc_5 < b.loc_5;
    if (a.loc_3 != b.loc_3) return a.loc_3 < b.loc_3;
    if (a.tm == b.tm) {
        if (a.num_mm == b.num_mm)
            return a.alignment.size() > b.alignment.size();
        return a.num_mm > b.num_mm;
    }
    return a.tm > b.tm;
}

// sort_by_oligo_loc (reference amplicon_search.cpp:12-26)
inline bool oligo_loc_less(const OligoInfoC& a, const OligoInfoC& b)
{
    if ((a.loc_5 + a.loc_3) == 0 || (b.loc_5 + b.loc_3) == 0)
        return a.target_loc < b.target_loc;
    if (a.loc_5 == b.loc_5) return a.loc_3 < b.loc_3;
    return a.loc_5 < b.loc_5;
}

// libstdc++ std::list::sort (binary-counter bottom-up mergesort; ties in
// merge keep the first operand) realized over flat vectors.  The output
// permutation — not merely a sorted order — is the hit-list contract,
// because sort_by_oligo_loc is not a strict weak order (see
// utils/listsort.py for the verified Python port this mirrors).
using OligoVec = std::vector<OligoInfoC>;
using IdxVec = std::vector<int32_t>;

template <class Less>
void list_merge_idx(const OligoVec& items, IdxVec& a, IdxVec& b, IdxVec& out,
                    Less less)
{
    out.clear();
    size_t i = 0, j = 0;
    const size_t na = a.size(), nb = b.size();
    while (i < na && j < nb) {
        if (less(items[b[j]], items[a[i]])) out.push_back(b[j++]);
        else out.push_back(a[i++]);
    }
    while (i < na) out.push_back(a[i++]);
    while (j < nb) out.push_back(b[j++]);
}

// The merge network runs over int32 indices (the records are ~120 bytes
// with a std::string; moving them through every merge level dominated the
// profile); the final permutation applies in one pass.
template <class Less>
void list_sort_vec(OligoVec& items, Less less)
{
    const size_t n = items.size();
    if (n < 2) return;
    std::vector<IdxVec> counter;
    IdxVec carry, tmp;
    for (size_t x = 0; x < n; ++x) {
        carry.clear();
        carry.push_back((int32_t)x);
        size_t i = 0;
        while (i < counter.size() && !counter[i].empty()) {
            list_merge_idx(items, counter[i], carry, tmp, less);
            carry.swap(tmp);
            counter[i].clear();
            ++i;
        }
        if (i == counter.size()) counter.emplace_back(std::move(carry));
        else counter[i].swap(carry);
    }
    IdxVec result;
    for (auto& run : counter) {
        if (run.empty()) continue;
        list_merge_idx(items, run, result, tmp, less);
        result.swap(tmp);
    }
    OligoVec out;
    out.reserve(n);
    for (const int32_t idx : result) out.push_back(std::move(items[idx]));
    items.swap(out);
}

// ---------------------------------------------------------------------------
// Seeding (reference seq_hash.h; semantics mirrored from search/seed.py)

struct FragIndex {
    int word_len = 0;
    int64_t n = 0;                       // fragment length (db codes)
    const uint8_t* seq = nullptr;
    std::vector<int64_t> bucket_start;   // 4^w + 1
    std::vector<uint32_t> pos_by_word;   // positions grouped by word, asc
    bool built = false;

    void build()
    {
        if (built) return;
        built = true;
        const int w = word_len;
        const int64_t nbuckets = (int64_t)1 << (2 * w);
        bucket_start.assign(nbuckets + 1, 0);
        if (n < w) return;

        // valid word at p iff bases [p, p+w-1] are all A/C/G/T.
        // One fused pass computes words (uint16: 2w <= 16 for w <= 8)
        // and bucket counts; fragments are < 4 GiB so positions are u32.
        const int64_t nw = n - w + 1;
        std::vector<uint16_t> words(nw);
        std::vector<uint8_t> ok(nw, 0);
        int run = 0;
        uint32_t word = 0;
        const uint32_t mask = (uint32_t)(nbuckets - 1);
        for (int64_t i = 0; i < n; ++i) {
            const int b = seq[i];
            if (b <= DB_MAX_ATGC_C) {
                word = ((word << 2) | (uint32_t)b) & mask;
                ++run;
            } else {
                run = 0;
            }
            if (i >= w - 1 && run >= w) {
                words[i - w + 1] = (uint16_t)word;
                ok[i - w + 1] = 1;
                ++bucket_start[word + 1];
            }
        }
        for (int64_t b = 0; b < nbuckets; ++b)
            bucket_start[b + 1] += bucket_start[b];
        pos_by_word.resize((size_t)bucket_start[nbuckets]);
        std::vector<int64_t> fill(bucket_start.begin(),
                                  bucket_start.end() - 1);
        for (int64_t p = 0; p < nw; ++p)
            if (ok[p]) pos_by_word[fill[words[p]]++] = (uint32_t)p;
    }
};

// Oligo word list in reference scan order (search/seed.py oligo_word_list):
// plus = 5'->3' scan, complement = 3'->5' complemented scan.
static void oligo_word_list(const std::vector<uint8_t>& codes, int w,
                            bool complement, std::vector<int64_t>& out)
{
    out.clear();
    const int64_t mask = ((int64_t)1 << (2 * w)) - 1;
    uint64_t word = 0;
    int run = 0;
    const int n = (int)codes.size();
    if (complement) {
        for (int i = n - 1; i >= 0; --i) {
            const int b = codes[i];
            if (b <= DB_MAX_ATGC_C) {
                word = ((word << 2) | (unsigned)(3 - b)) & 0xFFFFFFFFu;
                ++run;
            } else run = 0;
            if (run >= w) out.push_back((int64_t)(word & (uint64_t)mask));
        }
    } else {
        for (int i = 0; i < n; ++i) {
            const int b = codes[i];
            if (b <= DB_MAX_ATGC_C) {
                word = ((word << 2) | (unsigned)b) & 0xFFFFFFFFu;
                ++run;
            } else run = 0;
            if (run >= w) out.push_back((int64_t)(word & (uint64_t)mask));
        }
    }
}

// find_seeds + unique_diagonal_seeds (search/seed.py:102-141): first hit in
// (word k asc, target pos asc) iteration order per diagonal delta=k-pos,
// representatives sorted by delta ascending.
static void unique_diagonal_seeds(FragIndex& fi,
                                  const std::vector<uint8_t>& oligo_codes,
                                  bool complement,
                                  std::vector<std::pair<int64_t, int64_t>>& out)
{
    out.clear();
    fi.build();
    std::vector<int64_t> words;
    oligo_word_list(oligo_codes, fi.word_len, complement, words);
    if (words.empty()) return;

    std::vector<std::pair<int64_t, int64_t>> hits;  // (k, pos)
    for (size_t k = 0; k < words.size(); ++k) {
        const int64_t wv = words[k];
        const int64_t s = fi.bucket_start[wv], e = fi.bucket_start[wv + 1];
        for (int64_t j = s; j < e; ++j)
            hits.emplace_back((int64_t)k, fi.pos_by_word[j]);
    }
    if (hits.empty()) return;
    std::stable_sort(hits.begin(), hits.end(),
                     [](const std::pair<int64_t, int64_t>& a,
                        const std::pair<int64_t, int64_t>& b) {
                         return (a.first - a.second) < (b.first - b.second);
                     });
    int64_t last_delta = 0;
    bool first = true;
    for (const auto& h : hits) {
        const int64_t d = h.first - h.second;
        if (first || d != last_delta) {
            out.push_back(h);
            last_delta = d;
            first = false;
        }
    }
}

// ---------------------------------------------------------------------------
// Per-fragment melt caches (reference BindCacheKey/Value tntblast.h:248-324;
// semantics mirrored from search/bind.py: values truncated at the filter
// stage they failed under at evaluation time).

struct Filt {
    float min_tm, max_tm, min_dg, max_dg;
    int clamp_5, clamp_3, max_mm, max_gap, max_poly_degen;
};

struct CacheVal {
    float tm = 0, dg = 0, dH = 0, dS = 0;
    int anchor_5 = 0, anchor_3 = 0;
    int target_5 = 0, target_3 = 0;
    int num_mm = 0, num_gap = 0, max_poly_degen = 0;
    std::string align;
    // Device-screen stub (screen.py ScreenStub): records the filter bounds
    // the conservative proof was run against; lookups under *weaker*
    // bounds must re-evaluate instead of reusing the proof.
    bool stub = false;
    bool stub_fail_tm = false, stub_fail_dg = false;
    float stub_min_tm = 0, stub_max_dg = 0, stub_conc = 0;

    bool stub_covers(const Filt& filt, float conc) const
    {
        if (stub_fail_tm && conc == stub_conc && filt.min_tm >= stub_min_tm)
            return true;
        if (stub_fail_dg && filt.max_dg <= stub_max_dg)
            return true;
        return false;
    }
};

// Screening verdicts for one (oligo, strand) slot, keyed by window start
// (parallel/screen_service.py attaches them before the assay searches).
struct VerdictSlot {
    float min_tm = 0, max_dg = 0, conc = 0;
    std::unordered_map<int64_t, uint8_t> flags;   // bit0 fail_tm, bit1 fail_dg
};

// Device-computed exact evaluation of a trusted gapless window
// (ops/eval_gapless_jax.py): pre-salt dH/dS accumulators plus the
// alignment metadata the filter cascade needs.  flags bit0 = trusted,
// bit1 = the engine would report tm = 0 for this window.
struct EvalRec {
    uint8_t flags = 0;
    uint8_t num_base = 0, mm = 0, align_len = 0;
    uint8_t fm_q = 0, fm_t = 0, lm_q = 0, lm_t = 0;
    uint8_t anchor5 = 0, anchor3 = 0;
    float dH = 0, dS = 0;
};

// Device-computed, pre-screened seed list for one (oligo, strand) slot
// (parallel/panel.py): the unique-diagonal seeds minus those the device
// DP screen proved hit-free under (min_tm, max_dg, conc).  Only honored
// when the search's filter matches the proof conditions exactly;
// otherwise the host enumerates seeds itself (cached_seeds).
struct SeedSlot {
    float min_tm = 0, max_dg = 0, conc = 0;
    std::vector<std::pair<int64_t, int64_t>> seeds;   // (q_off, t_pos)
    // eval-filtered slots (tnt_frag_set_evals) are only honored when the
    // search's FULL filter matches the one the pruning ran under
    bool filtered = false;
    float filt9[9] = {0};
};

struct CacheKey {
    const void* oligo_id;   // interned oligo identity (codes pointer)
    int64_t start, stop;
    bool operator==(const CacheKey& o) const
    {
        return oligo_id == o.oligo_id && start == o.start && stop == o.stop;
    }
};
struct CacheKeyHash {
    size_t operator()(const CacheKey& k) const
    {
        size_t h = std::hash<const void*>()(k.oligo_id);
        h = h * 1000003u ^ std::hash<int64_t>()(k.start);
        h = h * 1000003u ^ std::hash<int64_t>()(k.stop);
        return h;
    }
};
using MeltCache = std::unordered_map<CacheKey, CacheVal, CacheKeyHash>;

// Oligo string interning: bind caches key on the oligo *sequence*
// (reference BindCacheKey::oligo); two assays sharing a primer share
// entries.  Intern melt-code strings so the cache key is a stable pointer.
struct OligoIntern {
    std::unordered_map<std::string, std::unique_ptr<std::vector<uint8_t>>> map;
    const std::vector<uint8_t>* get(const uint8_t* codes, int n)
    {
        std::string key((const char*)codes, (size_t)n);
        auto it = map.find(key);
        if (it == map.end()) {
            auto v = std::unique_ptr<std::vector<uint8_t>>(
                new std::vector<uint8_t>(codes, codes + n));
            it = map.emplace(std::move(key), std::move(v)).first;
        }
        return it->second.get();
    }
};

// ---------------------------------------------------------------------------
// Hit record returned to the Python layer (it builds hybrid_sig objects,
// amplicon strings and masking from these).

enum HitFlags {
    HF_PRIMER_PLUS = 1,   // primer_strand == PLUS
    HF_SWAP_F = 2,        // forward_oligo := reverse_oligo (single-primer R/R)
    HF_SWAP_R = 4,        // reverse_oligo := forward_oligo (single-primer F/F)
    HF_HAS_PROBE = 8,     // probe fields valid
    HF_PROBE_PLUS = 16,   // probe_strand == PLUS
    HF_HAS_PRIMERS = 32,  // primer fields valid
};

struct HitRec {
    int32_t flags = 0;
    int32_t amp_start = 0, amp_stop = 0;
    int32_t probe_start = 0, probe_stop = 0;
    float f_tm = 0, f_dH = 0, f_dS = 0;
    float r_tm = 0, r_dH = 0, r_dS = 0;
    float p_tm = 0, p_dH = 0, p_dS = 0;
    int32_t f_mm = 0, f_gap = 0, f_clamp = 0;
    int32_t r_mm = 0, r_gap = 0, r_clamp = 0;
    int32_t p_mm = 0, p_gap = 0;
    std::string f_align, r_align, p_align;
};

struct FragCtx {
    Engine* eng = nullptr;
    MeltState* st = nullptr;     // dedicated DP state (single caller thread)
    std::vector<uint8_t> seq;    // fragment db codes
    FragIndex index;
    MeltCache cache_plus, cache_minus;
    OligoIntern intern;
    std::unordered_map<const void*, QueryLUT> lut_cache;  // per oligo
    // host-screen tables: delta_g at a screening temperature, and the
    // per-(oligo, temperature) score-only LUTs
    std::map<int32_t, std::vector<int>> cond_dg_cache;  // key: T * 1e4
    std::map<std::pair<const void*, int32_t>, QueryLUT> cond_lut_cache;
    // (oligo, minus) -> seeds: computed for candidate export, reused by
    // the search (identical enumeration both times)
    std::unordered_map<const void*,
        std::vector<std::pair<int64_t, int64_t>>> seed_cache[2];
    std::unordered_map<const void*, VerdictSlot> verdicts[2];
    std::unordered_map<const void*, SeedSlot> injected[2];
    std::vector<HitRec> hits;    // results of the last search call
    int64_t align_bytes = 0;
    int64_t screened = 0, evaluated = 0;   // observability counters
    int64_t dev_evaluated = 0;             // windows resolved by device eval
    // phase cycle counters (reference PROFILE analogue): index build,
    // seed enumeration, window extract+cache, DP, traceback+rescore,
    // sort/cull, pairing
    int64_t t_index = 0, t_seed = 0, t_extract = 0, t_dp = 0, t_tm = 0,
            t_sort = 0, t_pair = 0, t_screen = 0;

    ~FragCtx() { delete st; }
};

struct PhaseTimer {
    int64_t* acc;
    uint64_t t0;
    explicit PhaseTimer(int64_t* a) : acc(a), t0(__rdtsc()) {}
    ~PhaseTimer() { *acc += (int64_t)(__rdtsc() - t0); }
};

// Cached unique-diagonal seeds per (oligo, strand)
struct FragCtx;
static const std::vector<std::pair<int64_t, int64_t>>& cached_seeds(
    FragCtx& ctx, const std::vector<uint8_t>* oligo, bool minus);

static const std::vector<std::pair<int64_t, int64_t>>& cached_seeds(
    FragCtx& ctx, const std::vector<uint8_t>* oligo, bool minus)
{
    auto& m = ctx.seed_cache[minus ? 1 : 0];
    auto it = m.find(oligo);
    if (it == m.end()) {
        {
            PhaseTimer pt(&ctx.t_index);
            ctx.index.build();
        }
        PhaseTimer pt(&ctx.t_seed);
        std::vector<std::pair<int64_t, int64_t>> seeds;
        unique_diagonal_seeds(ctx.index, *oligo, !minus, seeds);
        it = m.emplace(oligo, std::move(seeds)).first;
    }
    return it->second;
}

// Does an injected slot's proof cover this bind call?  Screen-only
// slots need (min_tm, max_dg, conc) equality; eval-FILTERED slots were
// pruned under a full cascade and need the complete filter to match.
// Exact float equality is intentional — both sides compute these from
// the same Options fields through the same float32 conversions.
static bool slot_matches(const SeedSlot& ss, const Filt& f, float conc)
{
    if (ss.conc != conc) return false;
    if (!ss.filtered)
        return ss.min_tm == f.min_tm && ss.max_dg == f.max_dg;
    return ss.filt9[0] == f.min_tm && ss.filt9[1] == f.max_tm
        && ss.filt9[2] == f.min_dg && ss.filt9[3] == f.max_dg
        && ss.filt9[4] == (float)f.clamp_5
        && ss.filt9[5] == (float)f.clamp_3
        && ss.filt9[6] == (float)f.max_mm
        && ss.filt9[7] == (float)f.max_gap
        && ss.filt9[8] == (float)f.max_poly_degen;
}

static const std::vector<std::pair<int64_t, int64_t>>& seeds_for(
    FragCtx& ctx, const std::vector<uint8_t>* oligo, bool minus,
    const Filt& filt, float conc, bool* prescreened = nullptr)
{
    auto& inj = ctx.injected[minus ? 1 : 0];
    auto it = inj.find(oligo);
    if (it != inj.end() && slot_matches(it->second, filt, conc)) {
        if (prescreened) *prescreened = true;
        return it->second.seeds;
    }
    if (prescreened) *prescreened = false;
    return cached_seeds(ctx, oligo, minus);
}

// window_codes (search/bind.py:121-127)
static void window_codes(const FragCtx& ctx, int64_t start, int64_t stop,
                         bool minus, std::vector<uint8_t>& out)
{
    out.clear();
    if (minus) {
        for (int64_t i = stop - 1; i >= start; --i) {
            const uint8_t c = DB2MELT_COMP[ctx.seq[i]];
            if (c != 255) out.push_back(c);
        }
    } else {
        for (int64_t i = start; i < stop; ++i) {
            const uint8_t c = DB2MELT_PLUS[ctx.seq[i]];
            if (c != 255) out.push_back(c);
        }
    }
}

// bind_oligo_to_{plus,minus}_strand (reference bind_oligo.cpp:124-1530;
// control flow mirrored from search/bind.py:222-330).
//   oligo_mask < 0: direct-from-seed variant.
//   oligo_mask >= 0: consume pre-matched entries from info_list.
static void bind_oligo(FragCtx& ctx, OligoVec& info_list,
                       const std::vector<uint8_t>* oligo,
                       bool minus, float strand_conc, const Filt& filt,
                       int oligo_mask, bool use_cache)
{
    const int window = (int)oligo->size();
    const int target_length = window + 2 * NUM_FLANK_BASE_C;
    const int64_t seq_size = (int64_t)ctx.seq.size();

    MeltCache local_cache;
    MeltCache& cache = use_cache
        ? (minus ? ctx.cache_minus : ctx.cache_plus) : local_cache;

    OligoVec entries;
    OligoVec keep_rest;
    const bool direct = oligo_mask < 0;
    // Device-prescreened slot under these exact conditions?  (Covers both
    // the direct path, whose seeds_for returns the injected list, and the
    // pre-matched-list path, whose entries derive from the same list.)
    bool device_prescreened = false;
    {
        auto& inj = ctx.injected[minus ? 1 : 0];
        auto iit = inj.find(oligo);
        device_prescreened = (iit != inj.end()
            && slot_matches(iit->second, filt, strand_conc));
    }

    if (direct) {
        const auto& seeds = seeds_for(ctx, oligo, minus, filt, strand_conc);
        entries.reserve(seeds.size());
        for (const auto& s : seeds)
            entries.emplace_back((unsigned)s.first, (unsigned)s.second, 0);
    } else {
        const unsigned char want =
            (unsigned char)(oligo_mask | (minus ? OM_MINUS : OM_PLUS));
        for (auto& e : info_list) {
            if ((e.mask & want) == want)
                entries.push_back(std::move(e));
            else
                keep_rest.push_back(std::move(e));
        }
        // reference push_front: matching entries end up in reverse order
        std::reverse(entries.begin(), entries.end());
        info_list.clear();
    }

    // Window key per entry + evaluation of cache misses, in entry order
    // (matches search/bind.py's miss pass; evaluation order does not affect
    // results — each window is independent — but cache-stage semantics do).
    struct Key { int64_t start, stop; };
    std::vector<Key> keys;
    keys.reserve(entries.size());
    for (const auto& e : entries) {
        int64_t start = (int64_t)e.target_loc
            - ((int64_t)e.query_loc + NUM_FLANK_BASE_C);
        if (start < 0) start = 0;
        int64_t stop = start + target_length;
        if (stop > seq_size) stop = seq_size;
        keys.push_back({start, stop});
    }

    MeltState& st = *ctx.st;

    // Finish one evaluated window: filter-stage cascade + cache store
    // (search/bind.py _compute_stage / _make_cache_value; reference
    // bind_oligo.cpp:261-428).
    auto store_result = [&](const Key& kk, float tm) {
        CacheVal v;
        v.tm = tm;
        const float dg = st.curr.dH - ctx.eng->base_T * st.curr.dS;
        const int a5 = (int)anchor5_query(st);
        const int a3 = (int)anchor3_query(st);
        const int mm = (int)num_mismatch_of(st.curr, (unsigned)st.q_len);
        const int gp = (int)num_gap_of(st.curr);
        const int dg_run = (int)max_contig_degen_of(st.curr);

        int stage;
        if (tm < filt.min_tm || tm > filt.max_tm) stage = 0;
        else if (dg < filt.min_dg || dg > filt.max_dg) stage = 1;
        else if (a5 < filt.clamp_5) stage = 2;
        else if (a3 < filt.clamp_3) stage = 3;
        else if (mm > filt.max_mm) stage = 4;
        else if (gp > filt.max_gap) stage = 5;
        else if (dg_run > filt.max_poly_degen) stage = 6;
        else stage = 7;

        if (stage >= 1) v.dg = dg;
        if (stage >= 2) v.anchor_5 = a5;
        if (stage >= 3) v.anchor_3 = a3;
        if (stage >= 4) v.num_mm = mm;
        if (stage >= 5) v.num_gap = gp;
        if (stage >= 6) v.max_poly_degen = dg_run;
        if (stage >= 7) {
            v.dH = st.curr.dH;
            v.dS = st.curr.dS;
            // target plus-strand extents (search/bind.py _window_locs;
            // reference bind_oligo.cpp:364-379 / 1068-1083)
            const int qr0 = st.curr.fm_q, qr1 = st.curr.lm_q;
            const int tr0 = st.curr.lm_t, tr1 = st.curr.fm_t;
            if (minus) {
                v.target_5 = (int)(kk.start
                    + (kk.stop - kk.start - 1 - tr1) - qr0);
                v.target_3 = (int)(kk.start
                    + (kk.stop - kk.start - 1 - tr0) + (window - 1) - qr1);
            } else {
                v.target_5 = (int)(kk.start + tr0 - ((window - 1) - qr1));
                v.target_3 = (int)(kk.start + tr1 + qr0);
            }
            v.align = render_alignment(st, HETERO_DIMER);
        }
        cache.emplace(CacheKey{oligo, kk.start, kk.stop}, std::move(v));
    };

    // Collect unevaluated windows (deduped; first occurrence wins, as in
    // the incremental evaluation order)
    const VerdictSlot* vs = nullptr;
    if (use_cache) {
        auto vit = ctx.verdicts[minus ? 1 : 0].find(oligo);
        if (vit != ctx.verdicts[minus ? 1 : 0].end()) vs = &vit->second;
    }

    struct MissItem { Key key; std::vector<uint8_t> win; };
    std::vector<MissItem> misses;
    std::unordered_map<int64_t, bool> pending;
    PhaseTimer* ext_t = new PhaseTimer(&ctx.t_extract);
    for (const auto& kk : keys) {
        const CacheKey ck{oligo, kk.start, kk.stop};
        auto cit = cache.find(ck);
        if (cit != cache.end()) {
            if (!cit->second.stub) continue;
            if (cit->second.stub_covers(filt, strand_conc)) continue;
            cache.erase(cit);   // stale proof: re-evaluate exactly
        }
        // window width <= MAX_SEQUENCE_LENGTH + 8 < 4096, so this packing
        // is collision-free
        const int64_t pk = (kk.start << 12) | (kk.stop - kk.start);
        if (!pending.emplace(pk, true).second) continue;

        // Device-screen verdict: a provably hit-free window becomes a
        // stub cache entry instead of an exact evaluation (screen.py
        // soundness argument; stubs never satisfy the filter cascade).
        if (vs != nullptr) {
            auto fit = vs->flags.find(kk.start);
            if (fit != vs->flags.end()) {
                const bool fail_tm = fit->second & 1;
                const bool fail_dg = fit->second & 2;
                const bool cov =
                    (fail_tm && strand_conc == vs->conc
                     && filt.min_tm >= vs->min_tm)
                    || (fail_dg && filt.max_dg <= vs->max_dg);
                if (cov) {
                    CacheVal v;
                    v.stub = true;
                    v.stub_fail_tm = fail_tm;
                    v.stub_fail_dg = fail_dg;
                    v.stub_min_tm = vs->min_tm;
                    v.stub_max_dg = vs->max_dg;
                    v.stub_conc = vs->conc;
                    cache.emplace(ck, std::move(v));
                    ++ctx.screened;
                    continue;
                }
            }
        }
        MissItem mi;
        mi.key = kk;
        window_codes(ctx, kk.start, kk.stop, minus, mi.win);
        misses.push_back(std::move(mi));
    }
    delete ext_t;

    // ---- Host screening pass -------------------------------------------
    // The same conservative proof as the device screen (screen.py,
    // test_screen_slack.py), run natively: a score-only DP at each
    // screening temperature; a window whose dp(T) fails the derived
    // min-score can never satisfy the filter and becomes a stub, skipping
    // the full DP + traceback + exact re-scoring.  This inverts the
    // reference's evaluate-everything control flow (bind_oligo.cpp:261-362)
    // into screen-then-evaluate — the SURVEY §7.3 design — on the host.
    // 0 = always off, 1 = always on, 2 (default, unset) = adaptive:
    // disable once the measured prune rate shows the screen costs more
    // than the evaluations it saves (Engine::screen_disabled).
    static const int host_screen_mode = []() {
        const char* e = getenv("TNTBLAST_TPU_HOST_SCREEN");
        if (e && e[0] == '0') return 0;
        if (e && e[0] == '1') return 1;
        return 2;
    }();
    bool do_host_screen = host_screen_mode != 0 && !device_prescreened
                          && !misses.empty();
    if (host_screen_mode == 2
            && ctx.eng->screen_disabled.load(std::memory_order_relaxed))
        do_host_screen = false;
    // Skip when the seed list was already device-prescreened under the
    // identical conditions: re-screening kept windows can drop nothing.
    const int64_t scr_cyc0 = ctx.t_screen;
    if (do_host_screen) {
        PhaseTimer pt_screen(&ctx.t_screen);
        struct Cond { float T; Score ms; uint8_t flag; };  // 1=tm, 2=dg
        Cond conds[2];
        int n_cond = 0;
        const Engine& eng = *ctx.eng;
        // slack: with the SCREENING table (update_dp_param_screen) the
        // exact re-scorer can beat the reachable path energy only by the
        // O(1) terminal terms bounded constructively in screen_bound.py
        // (< 0.5 kcal/mol over the operating range; the engine carries
        // the computed bound, default 1.0 = a safe over-bound).  The
        // previous corpus-fitted 4.0/7.0 constants over the REAL table
        // were unsound: mismatch clusters routed through gap pairs
        // overcharge linearly in cluster size (docs/screen_bound.md).
        const double slack = eng.screen_slack;
        const double R = 1.9872e-3;               // reference nuc_cruc.h:33
        if (filt.min_tm > 0 && strand_conc > 0) {
            const double tk = (double)filt.min_tm + 273.15;
            const double bound = tk * R * log((double)strand_conc) + slack;
            const double init_dg =
                (double)eng.t.init_H - tk * (double)eng.t.init_S;
            const double ms = ceil((init_dg - bound) * 10000.0);
            if (ms > 0)
                conds[n_cond++] = {(float)tk,
                    (Score)std::min(ms, 1e9), 1};
        }
        {
            const double ts = (double)eng.base_T;
            const double bound = (double)filt.max_dg + slack;
            const double init_dg =
                (double)eng.t.init_H - ts * (double)eng.t.init_S;
            const double ms = ceil((init_dg - bound) * 10000.0);
            if (ms > 0)
                conds[n_cond++] = {(float)ts,
                    (Score)std::min(ms, 1e9), 2};
        }
        if (n_cond > 0) {
            const QueryLUT* luts[2];
            for (int c = 0; c < n_cond; ++c) {
                const int32_t tkey = (int32_t)lrint(conds[c].T * 10000.0f);
                QueryLUT& lut = ctx.cond_lut_cache[{oligo, tkey}];
                if (lut.wq != (int)oligo->size()) {
                    auto& dg = ctx.cond_dg_cache[tkey];
                    if (dg.empty()) {
                        dg.resize(NUM_BP * NUM_BP);
                        // screening table: event charges are admissible
                        // lower bounds (docs/screen_bound.md)
                        update_dp_param_screen(eng, conds[c].T, dg.data());
                    }
                    build_query_lut_dg(oligo->data(), (int)oligo->size(),
                                       dg.data(), lut);
                }
                luts[c] = &lut;
            }

            // group same-length windows into lanes (as the exact pass)
            std::vector<int> sorder(misses.size());
            for (size_t k = 0; k < sorder.size(); ++k) sorder[k] = (int)k;
            std::stable_sort(sorder.begin(), sorder.end(),
                             [&](int a, int b) {
                return misses[a].win.size() < misses[b].win.size();
            });
            std::vector<uint8_t> fail(misses.size(), 0);
            Score scores[DP_LANES];
            const uint8_t* tgts[DP_LANES];
            size_t g0 = 0;
            while (g0 < sorder.size()) {
                const int t_len = (int)misses[sorder[g0]].win.size();
                size_t g1 = g0;
                while (g1 < sorder.size()
                       && (int)misses[sorder[g1]].win.size() == t_len)
                    ++g1;
                if (t_len == 0) { g0 = g1; continue; }
                for (size_t c0 = g0; c0 < g1; c0 += DP_LANES) {
                    const int n = (int)std::min((size_t)DP_LANES, g1 - c0);
                    for (int l = 0; l < n; ++l)
                        tgts[l] = misses[sorder[c0 + l]].win.data();
                    for (int l = n; l < DP_LANES; ++l) tgts[l] = tgts[0];
                    for (int c = 0; c < n_cond; ++c) {
                        dp_batch_score(*luts[c], tgts, t_len, n, scores);
                        for (int l = 0; l < n; ++l)
                            if (scores[l] < conds[c].ms)
                                fail[sorder[c0 + l]] |= conds[c].flag;
                    }
                }
                g0 = g1;
            }

            // failing windows -> stubs; survivors stay for the exact pass
            std::vector<MissItem> kept;
            kept.reserve(misses.size());
            for (size_t k = 0; k < misses.size(); ++k) {
                if (!fail[k]) {
                    kept.push_back(std::move(misses[k]));
                    continue;
                }
                CacheVal v;
                v.stub = true;
                v.stub_fail_tm = (fail[k] & 1) != 0;
                v.stub_fail_dg = (fail[k] & 2) != 0;
                v.stub_min_tm = filt.min_tm;
                v.stub_max_dg = filt.max_dg;
                v.stub_conc = strand_conc;
                cache.emplace(CacheKey{oligo, misses[k].key.start,
                                       misses[k].key.stop}, std::move(v));
                ++ctx.screened;
            }
            const long long tested = (long long)misses.size();
            const long long pruned = tested - (long long)kept.size();
            misses.swap(kept);
            const Engine& eng_s = *ctx.eng;
            const long long tot = tested + eng_s.screen_tested.fetch_add(
                tested, std::memory_order_relaxed);
            const long long pr = pruned + eng_s.screen_pruned.fetch_add(
                pruned, std::memory_order_relaxed);
            const long long sc = (ctx.t_screen - scr_cyc0)
                + eng_s.screen_cycles.fetch_add(
                    ctx.t_screen - scr_cyc0, std::memory_order_relaxed);
            // Measured break-even (the decision only moves work, never
            // output): screening pays iff its cost per tested window is
            // below the full-evaluation cost it saves, i.e.
            //   sc/tot < (eval_cycles/eval_windows) * (pr/tot)
            // Decide after a 24k/8k-window sample of both sides.
            const long long ew = eng_s.eval_windows.load(
                std::memory_order_relaxed);
            const long long ec = eng_s.eval_cycles.load(
                std::memory_order_relaxed);
            if (host_screen_mode == 2 && tot >= 24000 && ew >= 8000
                    && (double)sc * (double)ew > (double)ec * (double)pr)
                eng_s.screen_disabled.store(true,
                                            std::memory_order_relaxed);
        }
    }

    ctx.evaluated += (int64_t)misses.size();
    const int64_t eval_cyc0 = ctx.t_dp + ctx.t_tm;
    const int64_t eval_n0 = (int64_t)misses.size();

    if (!misses.empty()) {
        st.set_query(oligo->data(), (int)oligo->size());
        st.strand_conc = strand_conc;
    }

    if (!misses.empty() && !ctx.eng->dinkelbach) {
        // Batched DP: group same-length windows into SIMD lanes; the
        // per-lane traceback/enumeration runs on the lane-strided
        // matrices (melt_engine.cpp align_dimer_batch), bit-identical to
        // the scalar path.
        QueryLUT& lut = ctx.lut_cache[oligo];
        if (lut.wq != (int)oligo->size())
            build_query_lut(st, lut);

        std::vector<int> order(misses.size());
        for (size_t k = 0; k < order.size(); ++k) order[k] = (int)k;
        std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
            return misses[a].win.size() < misses[b].win.size();
        });

        Score scores[DP_LANES];
        std::vector<int64_t> cells[DP_LANES];
        const uint8_t* tgts[DP_LANES];
        size_t g0 = 0;
        while (g0 < order.size()) {
            const int t_len = (int)misses[order[g0]].win.size();
            size_t g1 = g0;
            while (g1 < order.size()
                   && (int)misses[order[g1]].win.size() == t_len)
                ++g1;
            if (t_len == 0) {
                // empty window (all bases dropped): scalar semantics
                for (size_t k = g0; k < g1; ++k) {
                    MissItem& mi = misses[order[k]];
                    st.target.clear();
                    const float tm = approximate_tm_heterodimer(st);
                    store_result(mi.key, tm);
                }
                g0 = g1;
                continue;
            }
            for (size_t c0 = g0; c0 < g1; c0 += DP_LANES) {
                const int n = (int)std::min((size_t)DP_LANES, g1 - c0);
                for (int l = 0; l < n; ++l)
                    tgts[l] = misses[order[c0 + l]].win.data();
                for (int l = n; l < DP_LANES; ++l) tgts[l] = tgts[0];
                {
                    PhaseTimer pt(&ctx.t_dp);
                    align_dimer_batch(st, lut, tgts, t_len, n, scores,
                                      cells);
                }
                PhaseTimer pt_tm(&ctx.t_tm);
                for (int l = 0; l < n; ++l) {
                    MissItem& mi = misses[order[c0 + l]];
                    st.lane = l;
                    st.target.assign(mi.win.begin(), mi.win.end());
                    st.mode = HETERO_DIMER;
                    st.curr.clear();
                    st.max_cells = cells[l];
                    st.max_score = scores[l];
                    const float tm = tm_dimer(st, false, HETERO_DIMER);
                    st.curr.dp_dg = -(float)scores[l] / 10000.0f;
                    store_result(mi.key, tm);
                }
            }
            g0 = g1;
        }
    } else {
        for (const auto& mi : misses) {
            st.target.assign(mi.win.begin(), mi.win.end());
            const float tm = approximate_tm_heterodimer(st);
            store_result(mi.key, tm);
        }
    }

    if (eval_n0 > 0) {
        // feed the adaptive host-screen break-even with the measured
        // full-evaluation cost per window (Engine::screen_disabled)
        ctx.eng->eval_windows.fetch_add(eval_n0,
                                        std::memory_order_relaxed);
        ctx.eng->eval_cycles.fetch_add(
            (ctx.t_dp + ctx.t_tm) - eval_cyc0,
            std::memory_order_relaxed);
    }

    // Survivor pass (filter cascade against cached values)
    PhaseTimer pt_sort(&ctx.t_sort);
    OligoVec survivors;
    {
        auto eit = entries.begin();
        auto kit = keys.begin();
        for (; eit != entries.end(); ++eit, ++kit) {
            const CacheKey ck{oligo, kit->start, kit->stop};
            const CacheVal& v = cache.find(ck)->second;
            if (v.stub) continue;   // screened out (provably hit-free)
            if (v.tm < filt.min_tm || v.tm > filt.max_tm) continue;
            if (v.dg < filt.min_dg || v.dg > filt.max_dg) continue;
            if (v.anchor_5 < filt.clamp_5 || v.anchor_3 < filt.clamp_3)
                continue;
            if (v.num_mm > filt.max_mm) continue;
            if (v.num_gap > filt.max_gap) continue;
            if (v.max_poly_degen > filt.max_poly_degen) continue;
            OligoInfoC s = *eit;
            s.loc_5 = v.target_5;
            s.loc_3 = v.target_3;
            s.tm = v.tm; s.dH = v.dH; s.dS = v.dS;
            s.anchor_5 = (unsigned)v.anchor_5;
            s.anchor_3 = (unsigned)v.anchor_3;
            s.num_mm = (unsigned)v.num_mm;
            s.num_gap = (unsigned)v.num_gap;
            s.alignment = v.align;
            survivors.push_back(std::move(s));
        }
    }

    if (direct) {
        info_list.clear();
        if (survivors.empty()) return;
        list_sort_vec(survivors, bound_less);
    } else {
        if (survivors.empty()) {
            info_list = std::move(keep_rest);
            return;
        }
        list_sort_vec(survivors, bound_match_less);
    }

    // dedupe keeping highest-Tm per (loc_5, loc_3) — consecutive after sort
    OligoVec out = std::move(keep_rest);
    auto sit = survivors.begin();
    out.push_back(std::move(*sit));
    ++sit;
    for (; sit != survivors.end(); ++sit) {
        const OligoInfoC& last = out.back();
        if (!(last.loc_5 == sit->loc_5 && last.loc_3 == sit->loc_3))
            out.push_back(std::move(*sit));
    }
    info_list = std::move(out);
}

// match_oligo_to_{minus,plus}_strand (reference bind_oligo.cpp:84-122);
// filt/conc identify the slot's screening conditions for seeds_for.
static void match_oligo(FragCtx& ctx, OligoVec& info_list,
                        const std::vector<uint8_t>* oligo,
                        unsigned char mask, bool minus,
                        const Filt& filt, float conc)
{
    const auto& seeds = seeds_for(ctx, oligo, minus, filt, conc);
    const unsigned char strand =
        (unsigned char)(minus ? OM_MINUS : OM_PLUS);
    for (const auto& s : seeds)
        info_list.emplace_back((unsigned)s.first, (unsigned)s.second,
                               (unsigned char)(mask | strand));
}

// cull_oligo_match (reference amplicon_search.cpp:679-765; semantics
// mirrored from search/assays.py:27-75 including the one-ahead strand
// counting quirk).
static void cull_oligo_match(OligoVec& match_list,
                             int max_amplicon_len, bool has_probe,
                             bool single_primer_pcr,
                             unsigned* n_minus, unsigned* n_plus)
{
    const unsigned threshold = (unsigned)(max_amplicon_len + 50);
    list_sort_vec(match_list, oligo_loc_less);
    std::vector<OligoInfoC*> items;
    items.reserve(match_list.size());
    for (auto& e : match_list) {
        e.mask &= (unsigned char)~OM_VALID;
        items.push_back(&e);
    }

    const size_t n = items.size();
    for (size_t fi = 0; fi < n; ++fi) {
        OligoInfoC* f = items[fi];
        if (f->mask & (OM_PLUS | OM_P)) continue;
        for (size_t ri = fi + 1; ri < n; ++ri) {
            OligoInfoC* r = items[ri];
            const unsigned diff = r->target_loc - f->target_loc;  // unsigned wrap
            if (diff > threshold) break;
            if (r->mask & (OM_MINUS | OM_P)) continue;
            if (!single_primer_pcr
                && (f->mask & (OM_R | OM_F)) == (r->mask & (OM_R | OM_F)))
                continue;
            if (has_probe) {
                for (size_t pi = fi + 1; pi < ri; ++pi) {
                    OligoInfoC* p = items[pi];
                    if (p->mask & OM_P) {
                        p->mask |= OM_VALID;
                        f->mask |= OM_VALID;
                        r->mask |= OM_VALID;
                    }
                }
            } else {
                f->mask |= OM_VALID;
                r->mask |= OM_VALID;
            }
        }
    }

    {
        OligoVec kept;
        kept.reserve(match_list.size());
        for (auto& e : match_list)
            if (e.mask & OM_VALID) kept.push_back(std::move(e));
        match_list.swap(kept);
    }

    if (n_minus) {
        // reference post-increment read: count the NEXT element's strand
        *n_minus = *n_plus = 0;
        if (!match_list.empty()) {
            auto it = match_list.begin();
            ++it;
            for (; it != match_list.end(); ++it) {
                if (it->mask & OM_MINUS) ++*n_minus;
                if (it->mask & OM_PLUS) ++*n_plus;
            }
        }
    }
}

struct AssayParams {
    int assay_format;           // 0 PCR, 1 PROBE, 2 PADLOCK, 3 MIPS
    const std::vector<uint8_t>* fwd;
    const std::vector<uint8_t>* rev;
    const std::vector<uint8_t>* prb;
    float fconc, rconc, pconc;
    Filt primer_filt, probe_filt;
    int max_len;                // amplicon cap (PCR) / ligation gap cap
    bool single_primer_pcr;
    int min_max_primer_clamp;   // < 0 disables
    int target_strand;          // 1 plus, 2 minus, 3 both
};

static void fill_pair_hit(HitRec& h, const OligoInfoC& f, const OligoInfoC& r,
                          int32_t flags)
{
    // _build_hit (search/assays.py:232-261; reference
    // amplicon_search.cpp:443-543): fo/ro ordering by strand role
    const OligoInfoC* fo = &f;
    const OligoInfoC* ro = &r;
    if ((f.mask & OM_R) && (r.mask & OM_F)) { fo = &r; ro = &f; }
    h.flags = flags | HF_HAS_PRIMERS;
    if (f.mask & OM_F) h.flags |= HF_PRIMER_PLUS;
    if ((f.mask & OM_R) && (r.mask & OM_R)) h.flags |= HF_SWAP_F;
    if ((f.mask & OM_F) && (r.mask & OM_F)) h.flags |= HF_SWAP_R;
    h.amp_start = f.loc_5;
    h.amp_stop = r.loc_3;
    h.f_tm = fo->tm; h.f_dH = fo->dH; h.f_dS = fo->dS;
    h.r_tm = ro->tm; h.r_dH = ro->dH; h.r_dS = ro->dS;
    h.f_mm = (int32_t)fo->num_mm; h.f_gap = (int32_t)fo->num_gap;
    h.r_mm = (int32_t)ro->num_mm; h.r_gap = (int32_t)ro->num_gap;
    h.f_clamp = (int32_t)fo->anchor_3;
    h.r_clamp = (int32_t)ro->anchor_3;
    h.f_align = fo->alignment;
    h.r_align = ro->alignment;
}

// amplicon() (reference amplicon_search.cpp:58-677; control flow mirrored
// from search/assays.py:98-229)
static void search_amplicon(FragCtx& ctx, const AssayParams& ap)
{
    const bool has_probe = ap.prb != nullptr;
    const bool apply_mmc = ap.min_max_primer_clamp >= 0;
    OligoVec match_list;

    match_oligo(ctx, match_list, ap.fwd, OM_F, true,
                ap.primer_filt, ap.fconc);
    match_oligo(ctx, match_list, ap.rev, OM_R, true,
                ap.primer_filt, ap.rconc);
    const size_t num_minus = match_list.size();
    if (num_minus == 0) return;
    match_oligo(ctx, match_list, ap.fwd, OM_F, false,
                ap.primer_filt, ap.fconc);
    match_oligo(ctx, match_list, ap.rev, OM_R, false,
                ap.primer_filt, ap.rconc);
    if (match_list.size() == num_minus) return;
    const size_t num_plus = match_list.size();
    if (has_probe) {
        match_oligo(ctx, match_list, ap.prb, OM_P, true,
                    ap.probe_filt, ap.pconc);
        match_oligo(ctx, match_list, ap.prb, OM_P, false,
                    ap.probe_filt, ap.pconc);
        if (match_list.size() == num_plus) return;
    }

    unsigned sc_minus = 0, sc_plus = 0;
    {
        PhaseTimer pt(&ctx.t_sort);
        cull_oligo_match(match_list, ap.max_len, has_probe,
                         ap.single_primer_pcr, &sc_minus, &sc_plus);
    }

    struct BindStep {
        const std::vector<uint8_t>* oligo;
        int mask; float conc; bool minus;
    };
    BindStep order[4];
    if (sc_minus < sc_plus) {
        order[0] = {ap.fwd, OM_F, ap.fconc, true};
        order[1] = {ap.rev, OM_R, ap.rconc, true};
        order[2] = {ap.fwd, OM_F, ap.fconc, false};
        order[3] = {ap.rev, OM_R, ap.rconc, false};
    } else {
        order[0] = {ap.fwd, OM_F, ap.fconc, false};
        order[1] = {ap.rev, OM_R, ap.rconc, false};
        order[2] = {ap.fwd, OM_F, ap.fconc, true};
        order[3] = {ap.rev, OM_R, ap.rconc, true};
    }
    for (int i = 0; i < 4; ++i) {
        bind_oligo(ctx, match_list, order[i].oligo, order[i].minus,
                   order[i].conc, ap.primer_filt, order[i].mask, true);
        if (i < 3) {
            PhaseTimer pt(&ctx.t_sort);
            cull_oligo_match(match_list, ap.max_len, has_probe,
                             ap.single_primer_pcr, nullptr, nullptr);
            if (match_list.empty()) return;
        }
    }

    if (has_probe) {
        cull_oligo_match(match_list, ap.max_len, has_probe,
                         ap.single_primer_pcr, nullptr, nullptr);
        if (match_list.empty()) return;
        bind_oligo(ctx, match_list, ap.prb, true, ap.pconc,
                   ap.probe_filt, OM_P, true);
        bind_oligo(ctx, match_list, ap.prb, false, ap.pconc,
                   ap.probe_filt, OM_P, true);
    }

    PhaseTimer pt_pair(&ctx.t_pair);
    list_sort_vec(match_list, oligo_loc_less);
    std::vector<OligoInfoC*> items;
    items.reserve(match_list.size());
    for (auto& e : match_list) items.push_back(&e);

    const size_t n = items.size();
    for (size_t fi = 0; fi < n; ++fi) {
        OligoInfoC* f = items[fi];
        if (f->mask & (OM_PLUS | OM_P)) continue;
        for (size_t ri = fi + 1; ri < n; ++ri) {
            OligoInfoC* r = items[ri];
            if (r->mask & (OM_MINUS | OM_P)) continue;
            if (!ap.single_primer_pcr
                && (f->mask & (OM_R | OM_F)) == (r->mask & (OM_R | OM_F)))
                continue;
            if (f->loc_3 >= r->loc_5) continue;
            if ((r->loc_3 - f->loc_5 + 1) > ap.max_len) continue;
            if (apply_mmc
                && (int)std::max(f->anchor_3, r->anchor_3)
                       <= ap.min_max_primer_clamp)
                continue;

            if (has_probe) {
                for (size_t pi = fi + 1; pi < ri; ++pi) {
                    OligoInfoC* p = items[pi];
                    if (!(p->mask & OM_P)) continue;
                    if (!(p->loc_5 >= f->loc_5 && p->loc_3 <= r->loc_3))
                        continue;
                    // TaqMan hydrolysis: probe must not overlap the primer
                    // bound to its own strand (amplicon_search.cpp:404-441)
                    if ((p->mask & (OM_PLUS | OM_MINUS))
                        == (f->mask & (OM_PLUS | OM_MINUS))) {
                        if (p->loc_5 <= f->loc_3) continue;
                    } else {
                        if (p->loc_3 >= r->loc_5) continue;
                    }
                    HitRec h;
                    fill_pair_hit(h, *f, *r, HF_HAS_PROBE
                        | ((p->mask & OM_PLUS) ? HF_PROBE_PLUS : 0));
                    h.probe_start = p->loc_5;
                    h.probe_stop = p->loc_3;
                    h.p_tm = p->tm; h.p_dH = p->dH; h.p_dS = p->dS;
                    h.p_mm = (int32_t)p->num_mm;
                    h.p_gap = (int32_t)p->num_gap;
                    h.p_align = p->alignment;
                    ctx.hits.push_back(std::move(h));
                }
            } else {
                HitRec h;
                fill_pair_hit(h, *f, *r, 0);
                ctx.hits.push_back(std::move(h));
            }
        }
    }
}

// hybrid() (reference probe_search.cpp:67-230; search/assays.py:266-311)
static void search_hybrid(FragCtx& ctx, const AssayParams& ap)
{
    for (int pass = 0; pass < 2; ++pass) {
        const bool minus = (pass == 0);
        if (minus && !(ap.target_strand & 2)) continue;
        if (!minus && !(ap.target_strand & 1)) continue;
        OligoVec bound;
        bind_oligo(ctx, bound, ap.prb, minus, ap.pconc, ap.probe_filt,
                   -1, /*use_cache=*/false);
        for (const auto& e : bound) {
            HitRec h;
            h.flags = HF_HAS_PROBE | (minus ? 0 : HF_PROBE_PLUS);
            h.probe_start = e.loc_5;
            h.probe_stop = e.loc_3;
            h.p_tm = e.tm; h.p_dH = e.dH; h.p_dS = e.dS;
            h.p_mm = (int32_t)e.num_mm;
            h.p_gap = (int32_t)e.num_gap;
            h.p_align = e.alignment;
            ctx.hits.push_back(std::move(h));
        }
    }
}

// padlock() (reference padlock_search.cpp:62-361; search/assays.py:316-383)
static void search_padlock(FragCtx& ctx, const AssayParams& ap)
{
    Filt up_filt = ap.probe_filt;    // clamp_3 forced 0 by caller
    Filt down_filt = ap.probe_filt;  // clamp_5 forced 0 by caller
    up_filt.clamp_3 = 0;
    down_filt.clamp_5 = 0;

    for (int pass = 0; pass < 2; ++pass) {
        const bool minus = (pass == 0);
        if (minus && !(ap.target_strand & 2)) continue;
        if (!minus && !(ap.target_strand & 1)) continue;
        OligoVec upstream, downstream;
        bind_oligo(ctx, upstream, ap.rev, minus, ap.rconc, up_filt,
                   -1, true);
        bind_oligo(ctx, downstream, ap.fwd, minus, ap.fconc, down_filt,
                   -1, true);
        for (const auto& up : upstream) {
            for (const auto& down : downstream) {
                const int gap = minus ? (up.loc_5 - down.loc_3 - 1)
                                      : (down.loc_5 - up.loc_3 - 1);
                if (gap < 0 || gap > ap.max_len) continue;
                HitRec h;
                h.flags = HF_HAS_PRIMERS | (minus ? 0 : HF_PRIMER_PLUS);
                h.amp_start = minus ? down.loc_5 : up.loc_5;
                h.amp_stop = minus ? up.loc_3 : down.loc_3;
                h.f_tm = down.tm; h.f_dH = down.dH; h.f_dS = down.dS;
                h.r_tm = up.tm; h.r_dH = up.dH; h.r_dS = up.dS;
                h.f_mm = (int32_t)down.num_mm;
                h.f_gap = (int32_t)down.num_gap;
                h.r_mm = (int32_t)up.num_mm;
                h.r_gap = (int32_t)up.num_gap;
                h.f_align = down.alignment;
                h.r_align = up.alignment;
                h.f_clamp = (int32_t)down.anchor_3;
                h.r_clamp = (int32_t)up.anchor_5;   // ligation clamps
                ctx.hits.push_back(std::move(h));
            }
        }
    }
}

static Filt to_filt(const float* f)
{
    Filt out;
    out.min_tm = f[0]; out.max_tm = f[1];
    out.min_dg = f[2]; out.max_dg = f[3];
    out.clamp_5 = (int)f[4]; out.clamp_3 = (int)f[5];
    out.max_mm = (int)f[6]; out.max_gap = (int)f[7];
    out.max_poly_degen = (int)f[8];
    return out;
}

// One assay over the fragment, its hits appended to ctx.hits.
static void search_one(FragCtx& ctx, int assay_format,
                       const uint8_t* f_codes, int f_len,
                       const uint8_t* r_codes, int r_len,
                       const uint8_t* p_codes, int p_len,
                       float fconc, float rconc, float pconc,
                       const Filt& primer_filt, const Filt& probe_filt,
                       int max_len, int single_primer_pcr,
                       int min_max_primer_clamp, int target_strand)
{
    AssayParams ap;
    ap.assay_format = assay_format;
    ap.fwd = f_len ? ctx.intern.get(f_codes, f_len) : nullptr;
    ap.rev = r_len ? ctx.intern.get(r_codes, r_len) : nullptr;
    ap.prb = p_len ? ctx.intern.get(p_codes, p_len) : nullptr;
    ap.fconc = fconc; ap.rconc = rconc; ap.pconc = pconc;
    ap.primer_filt = primer_filt;
    ap.probe_filt = probe_filt;
    ap.max_len = max_len;
    ap.single_primer_pcr = single_primer_pcr != 0;
    ap.min_max_primer_clamp = min_max_primer_clamp;
    ap.target_strand = target_strand;

    switch (assay_format) {
        case 0: search_amplicon(ctx, ap); break;
        case 1: search_hybrid(ctx, ap); break;
        case 2: case 3: search_padlock(ctx, ap); break;
        default: break;
    }
}

static void count_align_bytes(FragCtx& ctx)
{
    ctx.align_bytes = 0;
    for (const auto& h : ctx.hits)
        ctx.align_bytes += (int64_t)(h.f_align.size() + h.r_align.size()
                                     + h.p_align.size());
}

}  // namespace

// ===========================================================================
// C ABI
// ===========================================================================

extern "C" {

void* tnt_frag_create(void* eng_ptr, const uint8_t* db_codes, int64_t n,
                      int word_len)
{
    Engine* e = (Engine*)eng_ptr;
    FragCtx* ctx = new FragCtx();
    ctx->eng = e;
    ctx->st = new MeltState();
    ctx->st->eng = e;
    state_set_temperature(*ctx->st, e->base_T);
    ctx->seq.assign(db_codes, db_codes + n);
    ctx->index.word_len = word_len;
    ctx->index.n = n;
    ctx->index.seq = ctx->seq.data();
    return ctx;
}

void tnt_frag_destroy(void* ctx_ptr) { delete (FragCtx*)ctx_ptr; }

// Run one assay search over the fragment. filt arrays:
// [min_tm, max_tm, min_dg, max_dg, clamp5, clamp6, max_mm, max_gap,
//  max_poly_degen] (clamps/counts passed as float, converted to int).
// Returns the number of hits (fetch with tnt_frag_fetch).
int64_t tnt_frag_search(
    void* ctx_ptr, int assay_format,
    const uint8_t* f_codes, int f_len,
    const uint8_t* r_codes, int r_len,
    const uint8_t* p_codes, int p_len,
    float fconc, float rconc, float pconc,
    const float* primer_filt9, const float* probe_filt9,
    int max_len, int single_primer_pcr, int min_max_primer_clamp,
    int target_strand)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    ctx.hits.clear();
    search_one(ctx, assay_format, f_codes, f_len, r_codes, r_len,
               p_codes, p_len, fconc, rconc, pconc, to_filt(primer_filt9),
               to_filt(probe_filt9), max_len, single_primer_pcr,
               min_max_primer_clamp, target_strand);
    count_align_bytes(ctx);
    return (int64_t)ctx.hits.size();
}

// Run assays idx[0], ..., idx[n_idx - 1] of a panel over the fragment, in
// that order, each as tnt_frag_search runs it, into one hit list (fetch
// it with tnt_frag_fetch): one call, so the caller releases the
// interpreter's lock once for all of a work item's assays.  Assay a has
// the format formats[a] (a format tnt_frag_search does not search finds
// nothing), the oligos codes[ends[3 a - 1]:ends[3 a]] (forward),
// [ends[3 a]:ends[3 a + 1]] (reverse) and [ends[3 a + 1]:ends[3 a + 2]]
// (probe), with ends[-1] = 0 and an empty oligo absent, the
// concentrations conc[3 a..3 a + 2] and the length max_len[a]; the
// filters and the last three numbers are the search's, as
// tnt_frag_search takes them.  counts[k] = the hits of assay idx[k], in
// list order; counts[n_idx] = their alignment bytes.  Returns the hits.
int64_t tnt_frag_search_panel(
    void* ctx_ptr, int64_t n_idx, const int32_t* idx,
    const int32_t* formats, const uint8_t* codes, const int64_t* ends,
    const float* conc, const int32_t* max_len,
    const float* primer_filt9, const float* probe_filt9,
    int single_primer_pcr, int min_max_primer_clamp, int target_strand,
    int64_t* counts)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    ctx.hits.clear();
    const Filt primer_filt = to_filt(primer_filt9);
    const Filt probe_filt = to_filt(probe_filt9);
    for (int64_t k = 0; k < n_idx; ++k) {
        const int64_t a = idx[k];
        const int64_t* e = ends + 3 * a;
        const int64_t f0 = a ? e[-1] : 0;
        const size_t before = ctx.hits.size();
        search_one(ctx, formats[a],
                   codes + f0, (int)(e[0] - f0),
                   codes + e[0], (int)(e[1] - e[0]),
                   codes + e[1], (int)(e[2] - e[1]),
                   conc[3 * a], conc[3 * a + 1], conc[3 * a + 2],
                   primer_filt, probe_filt, max_len[a], single_primer_pcr,
                   min_max_primer_clamp, target_strand);
        counts[k] = (int64_t)(ctx.hits.size() - before);
    }
    count_align_bytes(ctx);
    counts[n_idx] = ctx.align_bytes;
    return (int64_t)ctx.hits.size();
}

int64_t tnt_frag_align_bytes(void* ctx_ptr)
{
    return ((FragCtx*)ctx_ptr)->align_bytes;
}

// Export the candidate windows of one (oligo, strand) slot for device
// screening: the exact seed list the search will use (cached, so the two
// enumerations are identical).  For each seed: starts_out = plus-strand
// window start; elig_out = 1 when the device may screen it (full-length,
// pure-ACGT window); windows_out rows hold the oriented window codes
// padded to wt_max with 4 (the kernel's HUGE-cost pad letter).
// Returns the seed count (call with cap=0 to size buffers).
int64_t tnt_frag_candidates(void* ctx_ptr, const uint8_t* oligo_codes,
                            int olen, int minus, int wt_max,
                            int32_t* starts_out, uint8_t* elig_out,
                            uint8_t* windows_out, int64_t cap)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    const std::vector<uint8_t>* oligo = ctx.intern.get(oligo_codes, olen);
    const auto& seeds = cached_seeds(ctx, oligo, minus != 0);
    const int64_t n = (int64_t)seeds.size();
    if (cap < n) return n;

    const int64_t seq_size = (int64_t)ctx.seq.size();
    const int wt = olen + 2 * NUM_FLANK_BASE_C;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t q = seeds[i].first, t = seeds[i].second;
        int64_t start = t - (q + NUM_FLANK_BASE_C);
        bool ok = start >= 0 && start + wt <= seq_size && wt <= wt_max;
        if (start < 0) start = 0;
        int64_t stop = std::min(start + wt, seq_size);
        starts_out[i] = (int32_t)start;
        if (ok) {
            for (int64_t j = start; j < stop; ++j)
                if (ctx.seq[j] > DB_MAX_ATGC_C) { ok = false; break; }
        }
        elig_out[i] = ok ? 1 : 0;
        uint8_t* row = windows_out + i * wt_max;
        std::memset(row, 4, (size_t)wt_max);
        if (ok) {
            if (minus) {
                for (int k = 0; k < wt; ++k)
                    row[k] = (uint8_t)(3 - ctx.seq[stop - 1 - k]);
            } else {
                std::memcpy(row, ctx.seq.data() + start, (size_t)wt);
            }
        }
    }
    return n;
}

// Attach device-screen verdicts for one slot (flags: bit0 fail_tm,
// bit1 fail_dg — only provably hit-free candidates need entries).
void tnt_frag_set_verdicts(void* ctx_ptr, const uint8_t* oligo_codes,
                           int olen, int minus,
                           float min_tm, float max_dg, float conc,
                           const int32_t* starts, const uint8_t* flags,
                           int64_t n)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    const std::vector<uint8_t>* oligo = ctx.intern.get(oligo_codes, olen);
    VerdictSlot& vs = ctx.verdicts[minus ? 1 : 0][oligo];
    vs.min_tm = min_tm;
    vs.max_dg = max_dg;
    vs.conc = conc;
    for (int64_t i = 0; i < n; ++i)
        if (flags[i]) vs.flags[starts[i]] = flags[i];
}

// Inject a device-computed, pre-screened seed list for one (oligo,
// strand) slot (parallel/panel.py).  q/t arrays hold (query word offset,
// target position) pairs in reference order (ascending diagonal delta);
// n_screened feeds the observability counter.  The list is honored only
// by searches whose filter matches (min_tm, max_dg, conc) exactly.
void tnt_frag_set_seeds(void* ctx_ptr, const uint8_t* oligo_codes,
                        int olen, int minus,
                        float min_tm, float max_dg, float conc,
                        const int32_t* q, const int32_t* t, int64_t n,
                        int64_t n_screened)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    const std::vector<uint8_t>* oligo = ctx.intern.get(oligo_codes, olen);
    SeedSlot& ss = ctx.injected[minus ? 1 : 0][oligo];
    ss.min_tm = min_tm;
    ss.max_dg = max_dg;
    ss.conc = conc;
    ss.seeds.clear();
    ss.seeds.reserve((size_t)n);
    for (int64_t i = 0; i < n; ++i)
        ss.seeds.emplace_back((int64_t)q[i], (int64_t)t[i]);
    ctx.screened += n_screened;
}

void tnt_frag_stats(void* ctx_ptr, int64_t* screened, int64_t* evaluated)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    *screened = ctx.screened;
    *evaluated = ctx.evaluated;
}

void tnt_frag_stats2(void* ctx_ptr, int64_t* dev_evaluated)
{
    *dev_evaluated = ((FragCtx*)ctx_ptr)->dev_evaluated;
}

// Does a TRUSTED window fail the full filter cascade f by the device's
// gapless evaluation of it?  w0-w4 are its 5-word packed layout of
// parallel/device_search.py (w0 flags/counts, w1 ranges, w2 anchors, w3/w4
// = f32 bit patterns of dH/dS).
static bool eval_fails(const Engine& eng, int olen, const Filt& f,
                       float conc, int32_t w0, int32_t w1, int32_t w2,
                       int32_t w3, int32_t w4)
{
    if (w0 & 2) {
        // the engine would report tm = 0 for this window: rejected
        // at stage 0 whenever a positive Tm threshold is in force
        return f.min_tm > 0.0f;
    }
    EvalRec er;
    er.num_base = (uint8_t)((w0 >> 2) & 0xFF);
    er.mm = (uint8_t)((w0 >> 10) & 0x3F);
    er.fm_q = (uint8_t)(w1 & 0xFF);
    er.lm_q = (uint8_t)((w1 >> 16) & 0xFF);
    er.anchor5 = (uint8_t)(w2 & 0xFF);
    er.anchor3 = (uint8_t)((w2 >> 8) & 0xFF);
    std::memcpy(&er.dH, &w3, 4);
    std::memcpy(&er.dS, &w4, 4);
    // salt + Tm exactly as evaluate_alignment's tail
    float dSs = er.dS;
    dSs += eng.t.SALT * (0.5f * er.num_base - 1) * log(eng.na);
    const float tm = std::max(
        0.0f, er.dH / (NC_R * log(conc) + dSs) - NC_ZERO_C);
    const float dgv = er.dH - eng.base_T * dSs;
    const int q_aligned = (int)er.lm_q - (int)er.fm_q + 1;
    const int mm_tot = (int)er.mm + (olen - q_aligned);
    return (tm < f.min_tm || tm > f.max_tm)
        || (dgv < f.min_dg || dgv > f.max_dg)
        || ((int)er.anchor5 < f.clamp_5)
        || ((int)er.anchor3 < f.clamp_3)
        || (mm_tot > f.max_mm)
        || (0 > f.max_gap) || (0 > f.max_poly_degen);
}

// Drop from an injected slot the seeds whose trusted windows fail the
// slot's full filter cascade filt9, and mark the slot filtered under it.
// Seed i's evaluation is word r of w[r] at index base + step * i.
static void filter_slot(FragCtx& ctx, SeedSlot& ss, int olen,
                        const float* filt9, float conc,
                        const int32_t* const w[5], int64_t base,
                        int64_t step)
{
    Filt f;
    f.min_tm = filt9[0]; f.max_tm = filt9[1];
    f.min_dg = filt9[2]; f.max_dg = filt9[3];
    f.clamp_5 = (int)filt9[4]; f.clamp_3 = (int)filt9[5];
    f.max_mm = (int)filt9[6]; f.max_gap = (int)filt9[7];
    f.max_poly_degen = (int)filt9[8];

    const int64_t n = (int64_t)ss.seeds.size();
    std::vector<std::pair<int64_t, int64_t>> kept;
    kept.reserve((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t j = base + step * i;
        if (!(w[0][j] & 1)) {             // untrusted: host evaluates
            kept.push_back(ss.seeds[i]);
            continue;
        }
        if (eval_fails(*ctx.eng, olen, f, conc, w[0][j], w[1][j], w[2][j],
                       w[3][j], w[4][j]))
            ++ctx.dev_evaluated;
        else
            kept.push_back(ss.seeds[i]);
    }
    ss.seeds.swap(kept);
    ss.filtered = true;
    for (int k = 0; k < 9; ++k) ss.filt9[k] = filt9[k];
}

// Filter an injected seed slot by the device's gapless evaluations
// (must be called AFTER tnt_frag_set_seeds for the same slot, with
// arrays parallel to the injected seed list).  A seed whose window is
// TRUSTED and provably fails the slot's full filter cascade is removed
// before the search ever builds match lists — the same soundness
// argument as the screen (a window that cannot bind can never appear in
// a bound list nor enable a pairing), applied with bit-exact device
// evaluation.  ev rows are the 5-word packed layout of
// parallel/device_search.py (w0 flags/counts, w1 ranges, w2 anchors,
// w3/w4 = f32 bit patterns of dH/dS).  Filtered slots are only honored
// by searches whose complete filter matches filt9 (slot_matches).
void tnt_frag_set_evals(void* ctx_ptr, const uint8_t* oligo_codes,
                        int olen, int minus,
                        const float* filt9, float conc,
                        const int32_t* q, const int32_t* t,
                        const int32_t* w0, const int32_t* w1,
                        const int32_t* w2, const int32_t* w3,
                        const int32_t* w4, int64_t n)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    const std::vector<uint8_t>* oligo = ctx.intern.get(oligo_codes, olen);
    auto it = ctx.injected[minus ? 1 : 0].find(oligo);
    if (it == ctx.injected[minus ? 1 : 0].end()) return;
    SeedSlot& ss = it->second;
    if ((int64_t)ss.seeds.size() != n) return;   // arrays must parallel
    const int32_t* const w[5] = {w0, w1, w2, w3, w4};
    filter_slot(ctx, ss, olen, filt9, conc, w, 0, 1);
}

// Inject one panel group's device result for this fragment in one call:
// for each of its n_slots slots, in order, what tnt_frag_set_seeds and
// (with eval_on, on a non-empty list) tnt_frag_set_evals do for that
// slot.  Slot s is the oligo codes[ends[s - 1]:ends[s]] (ends[-1] = 0) on
// strand minus[s], under filter filt9[9 s:9 s + 9] and concentration
// conc[s].  Its kept entries are the run [runs[2 s], runs[2 s + 1]) of
// the batch's kept block (9 rows of `stride` int32: row 2 p, row 3 kmin,
// rows 4-8 the evaluation words), in ascending p: the seeds are the
// (kmin, p + kmin) pairs of the run in reverse, ascending diagonal delta
// as the reference sorts them.  counts[s] is the slot's candidates before
// the screen.  out[0..2] += the slots filled, the seeds handed over and
// the seeds dropped by the evaluations.
void tnt_frag_inject_block(void* ctx_ptr, int64_t n_slots,
                           const uint8_t* codes, const int64_t* ends,
                           const uint8_t* minus, const float* filt9,
                           const float* conc, const int32_t* block,
                           int64_t stride, const int64_t* runs,
                           const int32_t* counts, int eval_on,
                           int64_t* out)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    const int32_t* p = block + 2 * stride;
    const int32_t* kmin = block + 3 * stride;
    const int32_t* const w[5] = {block + 4 * stride, block + 5 * stride,
                                 block + 6 * stride, block + 7 * stride,
                                 block + 8 * stride};
    const int64_t dropped0 = ctx.dev_evaluated;
    for (int64_t s = 0; s < n_slots; ++s) {
        const int64_t c0 = s ? ends[s - 1] : 0;
        const int olen = (int)(ends[s] - c0);
        const std::vector<uint8_t>* oligo = ctx.intern.get(codes + c0, olen);
        SeedSlot& ss = ctx.injected[minus[s] ? 1 : 0][oligo];
        const float* f9 = filt9 + 9 * s;
        ss.min_tm = f9[0];
        ss.max_dg = f9[3];
        ss.conc = conc[s];
        const int64_t a = runs[2 * s], b = runs[2 * s + 1];
        ss.seeds.clear();
        ss.seeds.reserve((size_t)(b - a));
        for (int64_t i = b - 1; i >= a; --i)
            ss.seeds.emplace_back((int64_t)kmin[i],
                                  (int64_t)p[i] + (int64_t)kmin[i]);
        ctx.screened += (int64_t)counts[s] - (b - a);
        out[1] += b - a;
        if (eval_on && b > a)
            filter_slot(ctx, ss, olen, f9, conc[s], w, b - 1, -1);
    }
    out[0] += n_slots;
    out[2] += ctx.dev_evaluated - dropped0;
}

// One (oligo, strand) slot as injected (tests): its number of seeds, and
// up to n_max (q_off, t_pos) pairs into q and t; meta[0..12] = min_tm,
// max_dg, conc, filtered, filt9.  -1 where the slot has none.
int64_t tnt_frag_slot_seeds(void* ctx_ptr, const uint8_t* oligo_codes,
                            int olen, int minus, int64_t* q, int64_t* t,
                            int64_t n_max, float* meta)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    const std::vector<uint8_t>* oligo = ctx.intern.get(oligo_codes, olen);
    auto it = ctx.injected[minus ? 1 : 0].find(oligo);
    if (it == ctx.injected[minus ? 1 : 0].end()) return -1;
    const SeedSlot& ss = it->second;
    for (int64_t i = 0; i < (int64_t)ss.seeds.size() && i < n_max; ++i) {
        q[i] = ss.seeds[i].first;
        t[i] = ss.seeds[i].second;
    }
    meta[0] = ss.min_tm; meta[1] = ss.max_dg; meta[2] = ss.conc;
    meta[3] = ss.filtered ? 1.0f : 0.0f;
    for (int k = 0; k < 9; ++k) meta[4 + k] = ss.filt9[k];
    return (int64_t)ss.seeds.size();
}


// Phase cycle counters (rdtsc): [index, seed, extract, dp, tm, sort, pair]
void tnt_frag_profile(void* ctx_ptr, int64_t* out8)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    out8[0] = ctx.t_index; out8[1] = ctx.t_seed; out8[2] = ctx.t_extract;
    out8[3] = ctx.t_screen; out8[4] = ctx.t_dp; out8[5] = ctx.t_tm;
    out8[6] = ctx.t_sort; out8[7] = ctx.t_pair;
}

// Fetch the hits of the last search call.
//   ints:   n x 13 [flags, amp_start, amp_stop, p_start, p_stop,
//                   f_mm, f_gap, f_clamp, r_mm, r_gap, r_clamp, p_mm, p_gap]
//   floats: n x 9  [f_tm, f_dH, f_dS, r_tm, r_dH, r_dS, p_tm, p_dH, p_dS]
//   aligns: 3 strings per hit (f, r, p) packed; offsets 3n+1 entries.
void tnt_frag_fetch(void* ctx_ptr, int32_t* ints, float* floats,
                    char* align_buf, int64_t* align_off)
{
    FragCtx& ctx = *(FragCtx*)ctx_ptr;
    int64_t pos = 0;
    int64_t k = 0;
    for (const auto& h : ctx.hits) {
        int32_t* I = ints + 13 * k;
        I[0] = h.flags;
        I[1] = h.amp_start; I[2] = h.amp_stop;
        I[3] = h.probe_start; I[4] = h.probe_stop;
        I[5] = h.f_mm; I[6] = h.f_gap; I[7] = h.f_clamp;
        I[8] = h.r_mm; I[9] = h.r_gap; I[10] = h.r_clamp;
        I[11] = h.p_mm; I[12] = h.p_gap;
        float* F = floats + 9 * k;
        F[0] = h.f_tm; F[1] = h.f_dH; F[2] = h.f_dS;
        F[3] = h.r_tm; F[4] = h.r_dH; F[5] = h.r_dS;
        F[6] = h.p_tm; F[7] = h.p_dH; F[8] = h.p_dS;
        const std::string* strs[3] = {&h.f_align, &h.r_align, &h.p_align};
        for (int s = 0; s < 3; ++s) {
            align_off[3 * k + s] = pos;
            std::memcpy(align_buf + pos, strs[s]->data(), strs[s]->size());
            pos += (int64_t)strs[s]->size();
        }
        ++k;
    }
    align_off[3 * k] = pos;
}

}  // extern "C"
