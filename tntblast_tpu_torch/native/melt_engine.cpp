// Copy of tntblast_tpu/native/melt_engine.cpp with the package name changed.
// tntblast_tpu_torch native melt engine.
//
// Exact reimplementation of the reference NucCruc semantics (reference:
// nuc_cruc.{h,cpp}, nuc_cruc_anchor.cpp, nuc_cruc_output.cpp) as a batched,
// thread-parallel C library with a flat C ABI (driven from Python via
// ctypes, and reused by the TPU pipeline for traceback + exact re-scoring
// of DP results computed on-device).
//
// Design notes (fresh implementation, structure-of-arrays, no class
// hierarchy; the *numerical semantics* follow the reference bit-for-bit):
//  - Thermodynamic tables are injected at engine creation from the Python
//    thermo module (single source of truth, see tntblast_tpu_torch/thermo).
//  - Scores are fixed-point int (-dG * 10000, truncated) like the
//    reference; all thermodynamic accumulation is float32 in the same
//    operation order.
//  - Each worker thread owns a MeltState with a persistent 1024-slot query
//    buffer. The reference indexes one element past the live query when a
//    co-optimal path walks into the matrix boundary (nuc_cruc.cpp:1530 with
//    last_i == 0 wraps through its CircleBuffer); we reproduce those
//    semantics deterministically (stale slots persist across set_query,
//    initial fill = base A, matching fresh zeroed pages).
//
// Alphabet (matches tntblast_tpu_torch.constants): A,C,G,T,I=0..4, E=5, GAP=6,
// degenerate M,R,S,V,W,Y,H,K,D,B,N=7..17.

#include <math.h>  // before <cmath>: float log/exp overloads resolve as in the reference build

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <atomic>
#include <cmath>
#include <string>
#include <vector>
#include <deque>
#include <thread>
#include <algorithm>
#include <unordered_map>

namespace {

typedef int32_t Score;

enum { A = 0, C = 1, G = 2, T = 3, I = 4, E = 5, GAP = 6,
       M = 7, R = 8, S_ = 9, V = 10, W = 11, Y = 12, H = 13,
       K = 14, D = 15, B = 16, N = 17 };

const int NUM_BASE = 7;
const int NUM_BP = 49;
const int NUM_ALPHA = 18;

// trace bits (reference nuc_cruc.h:62-73)
const uint8_t im1_jm1 = 1 << 0;
const uint8_t im1_j = 1 << 1;
const uint8_t i_jm1 = 1 << 2;
const uint8_t invalid_trace = 1 << 3;
const uint8_t query_target = im1_jm1;
const uint8_t query_gap = im1_j;
const uint8_t gap_target = i_jm1;

inline bool path_split(uint8_t x)
{
    return ((x & im1_jm1) + ((x & im1_j) >> 1) + ((x & i_jm1) >> 2)) > 1;
}

const float NC_ZERO_C = 273.15f;
const float NC_R = 1.9872e-3f;

const int QBUF_SIZE = 1024;

// ---------------------------------------------------------------------------
// Degenerate-base resolution (reference nuc_cruc.cpp:14-213). The published
// behavior includes the case-B fallthrough into case N; encode the full
// 18x18 decision table once.
int8_t RESOLVE[NUM_ALPHA][NUM_ALPHA];   // RESOLVE[base][other] -> real base
int16_t BEST_PAIR[NUM_ALPHA][NUM_ALPHA];  // best_base_pair(a, b)

int8_t resolve_one(int base, int q)
{
    switch (base) {
        case M: return (q == T) ? A : (q == G) ? C : A;
        case R: return (q == T) ? A : (q == C) ? G : A;
        case S_: return (q == G) ? C : (q == C) ? G : G;
        case V: return (q == G) ? C : (q == C) ? G : (q == T) ? A : A;
        case W: return (q == A) ? T : (q == T) ? A : A;
        case Y: return (q == G) ? C : (q == A) ? T : T;
        case H: return (q == T) ? A : (q == G) ? C : (q == A) ? T : A;
        case K: return (q == C) ? G : (q == A) ? T : T;
        case D: return (q == C) ? G : (q == T) ? A : (q == A) ? T : A;
        case B:  // falls through to N's rules in the reference (missing break)
        case N: return (q == A) ? T : (q == T) ? A : (q == G) ? C : (q == C) ? G : A;
        default: return (int8_t)base;  // A,C,G,T,I,E,GAP resolve to themselves
    }
}

void init_static_tables()
{
    for (int a = 0; a < NUM_ALPHA; ++a)
        for (int b = 0; b < NUM_ALPHA; ++b)
            RESOLVE[a][b] = resolve_one(a, b);
    for (int a = 0; a < NUM_ALPHA; ++a)
        for (int b = 0; b < NUM_ALPHA; ++b)
            BEST_PAIR[a][b] = (int16_t)(RESOLVE[a][b] * NUM_BASE + RESOLVE[b][a]);
}

inline int best_pair(int a, int b) { return BEST_PAIR[a][b]; }

// is_complemetary_base (reference nuc_cruc_anchor.cpp:8-139): bitmask overlap
// between the query base set and the complement of the target base set.
uint8_t BASE_SET[NUM_ALPHA];       // which of {A,T,G,C} a code can be
uint8_t COMP_SET[NUM_ALPHA];       // complement set

void init_complement_sets()
{
    const uint8_t MA = 1, MT = 2, MG = 4, MC = 8;
    auto set_of = [&](int b) -> uint8_t {
        switch (b) {
            case A: return MA; case C: return MC; case G: return MG; case T: return MT;
            case I: case N: return MA | MT | MG | MC;
            case E: case GAP: return 0;
            case M: return MA | MC;
            case R: return MG | MA;
            case S_: return MG | MC;
            case V: return MG | MC | MA;
            case W: return MA | MT;
            case Y: return MT | MC;
            case H: return MA | MC | MT;
            case K: return MG | MT;
            case D: return MG | MA | MT;
            case B: return MG | MT | MC;
        }
        return 0;
    };
    auto comp_of = [&](int b) -> uint8_t {
        // Complement sets exactly as written in the reference (including the
        // literal Y -> {A,G} mapping).
        switch (b) {
            case A: return MT; case C: return MG; case G: return MC; case T: return MA;
            case I: case N: return MA | MT | MG | MC;
            case E: case GAP: return 0;
            case M: return MT | MG;
            case R: return MC | MT;
            case S_: return MC | MG;
            case V: return MC | MG | MT;
            case W: return MT | MA;
            case Y: return MA | MG;
            case H: return MT | MG | MA;
            case K: return MC | MA;
            case D: return MC | MT | MA;
            case B: return MC | MA | MG;
        }
        return 0;
    };
    for (int b = 0; b < NUM_ALPHA; ++b) { BASE_SET[b] = set_of(b); COMP_SET[b] = comp_of(b); }
}

inline bool is_comp_base(int query, int target)
{
    return (BASE_SET[query] & COMP_SET[target]) != 0;
}

inline bool is_virtual(int b) { return b == E || b == GAP; }
inline bool is_real(int b) { return b <= I; }

// ---------------------------------------------------------------------------

struct Tables {
    float param_H[NUM_BP * NUM_BP];
    float param_S[NUM_BP * NUM_BP];
    float loop_term_H[NUM_BP * NUM_BP];
    float loop_term_S[NUM_BP * NUM_BP];
    float hp_term_H[NUM_BP * NUM_BP];
    float hp_term_S[NUM_BP * NUM_BP];
    float loop_S[513];
    float bulge_S[513];
    float hairpin_S[513];
    float special_H[131];
    float special_S[131];
    // special loop sequences, char codes over "ACGTE", 5 or 6 long
    char special_seq[131][8];
    float supp[12];
    float supp_salt[4];
    float init_H, init_S, AT_H, AT_S, sym_S, SALT, asym_S, bulge_AT_S;
    uint8_t wc[NUM_BP];
};

enum SuppIdx { LOOP_H = 0, LOOP_Sx, BULGE_H, BULGE_Sx,
               TM_AT_H, TM_AT_S, TM_GC_H, TM_GC_S, TM_I_H, TM_I_S,
               TMM_H, TMM_S };
enum SaltIdx { LOOP_SALT = 0, BULGE_SALT, TM_SALT, TMM_SALT };

enum Mode { HETERO_DIMER = 0, HOMO_DIMER = 1, HAIRPIN = 2 };

struct Alignment {
    bool valid = false;
    float dH = 0.0f, dS = 0.0f, tm = 0.0f, dp_dg = 0.0f;
    std::deque<uint8_t> q, t;
    int fm_q = 0, fm_t = 0;   // first_match (5' query pos, 3'-side target pos)
    int lm_q = 0, lm_t = 0;   // last_match

    void clear()
    {
        valid = false; dH = dS = tm = dp_dg = 0.0f;
        q.clear(); t.clear();
    }
};

struct TraceBranch {
    uint8_t* mask_ptr;
    uint8_t cur;

    explicit TraceBranch(uint8_t& m) : mask_ptr(&m)
    {
        if (m & im1_jm1) cur = im1_jm1;
        else if (m & im1_j) cur = im1_j;
        else cur = i_jm1;
    }
    bool next_trace()
    {
        while ((cur = (uint8_t)(cur << 1)) < invalid_trace) {
            if (cur & *mask_ptr) return true;
        }
        return false;
    }
};

struct Engine;

// Per-thread mutable state; one DP problem at a time.
struct MeltState {
    const Engine* eng = nullptr;

    // Persistent query buffer (stale-slot semantics; see header comment).
    uint8_t qbuf[QBUF_SIZE];
    int q_len = 0;
    std::vector<uint8_t> target;

    // DP matrices, stride = t_cols (t_len + 1).  In batched mode the
    // matrices hold L lanes interleaved (cell-major, lane-minor); the
    // scalar paths run with L = 1, lane = 0.
    std::vector<Score> M_, Iq_, It_;
    std::vector<uint8_t> Mt_, Iqt_, Itt_;
    int rows = 0, cols = 0;
    int L = 1, lane = 0;

    std::vector<int64_t> max_cells;  // linear index i*cols + j
    Score max_score = -1;

    Alignment curr;
    Mode mode = HETERO_DIMER;

    // Per-state override of the engine temperature (Dinkelbach)
    float target_T = 0.0f;
    int delta_g[NUM_BP * NUM_BP];
    float strand_conc = -1.0f;

    MeltState() { std::memset(qbuf, 0, sizeof(qbuf)); }

    inline uint8_t q_at(int i) const { return qbuf[((unsigned)i) % QBUF_SIZE]; }
    inline uint8_t t_at(int i) const { return target[i]; }

    void set_query(const uint8_t* q, int n)
    {
        q_len = n;
        for (int i = 0; i < n; ++i) qbuf[i] = q[i];
    }
};

struct Engine {
    Tables t;
    float base_T = 310.15f;   // user temperature
    float na = 0.05f;
    bool dangle5 = false, dangle3 = false;
    bool dinkelbach = false;
    // constructive screening slack (screen_bound.slack_bound, set from
    // Python after engine creation; 1.0 is a safe over-bound default)
    float screen_slack = 1.0f;
    // Adaptive host-screen statistics (frag_search.cpp): the score-only
    // screening DP at two conditions costs ~0.74x of the full
    // evaluation it can save, so it only pays above a ~70% prune rate.
    // Once a meaningful sample shows the rate below that, the screen is
    // disabled for this engine's remaining lifetime — output-invariant
    // either way (the screen only ever skips work, never changes it).
    mutable std::atomic<long long> screen_tested{0};
    mutable std::atomic<long long> screen_pruned{0};
    mutable std::atomic<long long> screen_cycles{0};
    mutable std::atomic<long long> eval_windows{0};
    mutable std::atomic<long long> eval_cycles{0};
    mutable std::atomic<bool> screen_disabled{false};
    std::vector<MeltState*> states;  // per worker thread

    ~Engine() { for (auto* s : states) delete s; }
};

// update_dp_param (reference nuc_cruc.cpp:340-487)
void update_dp_param(const Engine& eng, float target_T, int* delta_g)
{
    const Tables& t = eng.t;
    const float salt_correction = t.SALT * log(eng.na);

    const float loop_sc = salt_correction * t.supp_salt[LOOP_SALT];
    const float bulge_sc = salt_correction * t.supp_salt[BULGE_SALT];
    const float term_match_sc = salt_correction * t.supp_salt[TM_SALT];
    const float term_mismatch_sc = salt_correction * t.supp_salt[TMM_SALT];

    for (int i = 0; i < NUM_BP * NUM_BP; ++i)
        delta_g[i] = (Score)((t.param_H[i] - target_T * (t.param_S[i] + salt_correction)) * 10000.0f);

    const int AT = A * NUM_BASE + T, TA = T * NUM_BASE + A;
    const int CG = C * NUM_BASE + G, GC = G * NUM_BASE + C;

    for (int i = A; i <= I; ++i) {
        for (int j = A; j <= I; ++j) {
            const int curr = i * NUM_BASE + j;
            for (int k = A; k <= I; ++k) {
                const int prev1 = k * NUM_BASE + GAP;
                const int prev2 = GAP * NUM_BASE + k;
                Score v;
                if (t.wc[curr]) {
                    if (curr == AT || curr == TA)
                        v = (Score)((t.supp[TM_AT_H] - target_T * (t.supp[TM_AT_S] + term_match_sc)) * 10000.0f);
                    else if (curr == GC || curr == CG)
                        v = (Score)((t.supp[TM_GC_H] - target_T * (t.supp[TM_GC_S] + term_match_sc)) * 10000.0f);
                    else
                        v = (Score)((t.supp[TM_I_H] - target_T * (t.supp[TM_I_S] + term_match_sc)) * 10000.0f);
                } else {
                    v = (Score)((t.supp[TMM_H] - target_T * (t.supp[TMM_S] + term_mismatch_sc)) * 10000.0f);
                }
                v = std::max((Score)0, v);
                delta_g[curr * NUM_BP + prev1] = delta_g[prev1 * NUM_BP + curr] = v;
                delta_g[curr * NUM_BP + prev2] = delta_g[prev2 * NUM_BP + curr] = v;
            }
            for (int k = A; k <= I; ++k) {
                for (int l = A; l <= I; ++l) {
                    const int prev = k * NUM_BASE + l;
                    if (!t.wc[curr] && !t.wc[prev]) {
                        Score v = (Score)((t.supp[LOOP_H] - target_T * (t.supp[LOOP_Sx] + loop_sc)) * 10000.0f);
                        delta_g[curr * NUM_BP + prev] = std::max((Score)0, v);
                    }
                }
            }
        }
    }
    for (int i = A; i <= I; ++i) {
        for (int j = A; j <= I; ++j) {
            Score v = (Score)((t.supp[BULGE_H] - target_T * (t.supp[BULGE_Sx] + bulge_sc)) * 10000.0f);
            v = std::max((Score)0, v);
            delta_g[(i * NUM_BASE + GAP) * NUM_BP + (j * NUM_BASE + GAP)] = v;
            delta_g[(GAP * NUM_BASE + i) * NUM_BP + (GAP * NUM_BASE + j)] = v;
        }
    }
}

// Screening variant of the table (docs/screen_bound.md): every entry the
// table build above OVERRIDES with a fitted, zero-clamped event charge
// (terminal-match/mismatch next to a gap or boundary, interior LOOP
// pairs, BULGE gap extensions) is replaced by 0 — an admissible lower
// bound of the exact evaluator's event cost, whose loop/bulge penalties
// are all >= 0 (loop-terminal swaps cancel exactly: the tstack files are
// empty so param_loop_terminal == param).  A screening DP over this
// table can never overcharge an event, so the residual slack collapses
// to O(1) terminal terms (screen_slack_bound) instead of growing with
// event size — the corpus-fitted 4.0/7.0 constants were violated by
// large mismatch clusters routed through gap pairs (improvement 5.16
// measured; unbounded in window size).
void update_dp_param_screen(const Engine& eng, float target_T, int* delta_g)
{
    update_dp_param(eng, target_T, delta_g);
    for (int i = A; i <= I; ++i) {
        for (int j = A; j <= I; ++j) {
            const int curr = i * NUM_BASE + j;
            for (int k = A; k <= I; ++k) {
                const int prev1 = k * NUM_BASE + GAP;
                const int prev2 = GAP * NUM_BASE + k;
                delta_g[curr * NUM_BP + prev1] = 0;
                delta_g[prev1 * NUM_BP + curr] = 0;
                delta_g[curr * NUM_BP + prev2] = 0;
                delta_g[prev2 * NUM_BP + curr] = 0;
            }
            for (int k = A; k <= I; ++k) {
                for (int l = A; l <= I; ++l) {
                    const int prev = k * NUM_BASE + l;
                    if (!eng.t.wc[curr] && !eng.t.wc[prev])
                        delta_g[curr * NUM_BP + prev] = 0;
                }
            }
        }
    }
    for (int i = A; i <= I; ++i) {
        for (int j = A; j <= I; ++j) {
            delta_g[(i * NUM_BASE + GAP) * NUM_BP + (j * NUM_BASE + GAP)] = 0;
            delta_g[(GAP * NUM_BASE + i) * NUM_BP + (GAP * NUM_BASE + j)] = 0;
        }
    }
}

void state_set_temperature(MeltState& st, float T)
{
    st.target_T = T;
    update_dp_param(*st.eng, T, st.delta_g);
}

// ---------------------------------------------------------------------------
// DP (reference align_dimer, nuc_cruc.cpp:492-696).  Query rows are the
// reversed query; target columns are the target in 5'->3' order.
void ensure_dp(MeltState& st, int q_len, int t_len)
{
    st.rows = q_len + 1;
    st.cols = t_len + 1;
    st.L = 1;
    st.lane = 0;
    size_t need = (size_t)st.rows * st.cols;
    if (st.M_.size() < need) {
        st.M_.resize(need); st.Iq_.resize(need); st.It_.resize(need);
        st.Mt_.resize(need); st.Iqt_.resize(need); st.Itt_.resize(need);
    }
    // Boundary cells (row 0 and column 0) stay at -1 / invalid, matching the
    // reference's constructor-initialized halo.
    for (int j = 0; j < st.cols; ++j) {
        st.M_[j] = st.Iq_[j] = st.It_[j] = -1;
        st.Mt_[j] = st.Iqt_[j] = st.Itt_[j] = invalid_trace;
    }
    for (int i = 1; i < st.rows; ++i) {
        size_t k = (size_t)i * st.cols;
        st.M_[k] = st.Iq_[k] = st.It_[k] = -1;
        st.Mt_[k] = st.Iqt_[k] = st.Itt_[k] = invalid_trace;
    }
}

Score align_dimer(MeltState& st, bool homo)
{
    st.max_cells.clear();
    const int query_len = st.q_len;
    const uint8_t* qb = st.qbuf;
    const int target_len = homo ? query_len : (int)st.target.size();
    const uint8_t* tb = homo ? st.qbuf : st.target.data();
    const int* dg = st.delta_g;

    ensure_dp(st, query_len, target_len);
    const int cols = st.cols;

    Score max_score = -1;

    for (int i = 1; i <= query_len; ++i) {
        const int qbase = qb[query_len - i];
        const int prev_q = (i == 1) ? GAP : qb[query_len - (i - 1)];
        size_t row = (size_t)i * cols;
        size_t prow = row - cols;
        for (int j = 1; j <= target_len; ++j) {
            const int tbase = tb[j - 1];
            const int prev_t = (j == 1) ? GAP : tb[j - 2];

            const int cur_bp = best_pair(tbase, qbase);

            // M state: all three predecessors live in the diagonal cell
            int pb = best_pair(prev_t, prev_q);
            const Score dg1 = std::max((Score)0, st.M_[prow + j - 1]) - dg[pb * NUM_BP + cur_bp];
            pb = best_pair(prev_t, GAP);
            const Score dg2 = std::max((Score)0, st.Iq_[prow + j - 1]) - dg[pb * NUM_BP + cur_bp];
            pb = best_pair(GAP, prev_q);
            const Score dg3 = std::max((Score)0, st.It_[prow + j - 1]) - dg[pb * NUM_BP + cur_bp];

            Score m; uint8_t mt;
            if (dg1 >= dg2) {
                if (dg1 >= dg3) {
                    m = dg1; mt = im1_jm1;
                    if (dg1 == dg2) mt |= i_jm1;
                    if (dg1 == dg3) mt |= im1_j;
                } else { m = dg3; mt = im1_j; }
            } else {
                if (dg2 >= dg3) {
                    m = dg2; mt = i_jm1;
                    if (dg2 == dg3) mt |= im1_j;
                } else { m = dg3; mt = im1_j; }
            }
            st.M_[row + j] = m; st.Mt_[row + j] = mt;

            // I_query state (gap in query, consumes target base): left cell
            int cur_gap = best_pair(tbase, GAP);
            pb = best_pair(prev_t, qbase);
            Score ins = std::max((Score)0, st.M_[row + j - 1]) - dg[pb * NUM_BP + cur_gap];
            pb = best_pair(prev_t, GAP);
            Score ext = std::max((Score)0, st.Iq_[row + j - 1]) - dg[pb * NUM_BP + cur_gap];
            if (ins >= ext) {
                st.Iq_[row + j] = ins;
                st.Iqt_[row + j] = (uint8_t)(im1_jm1 | ((ins == ext) ? i_jm1 : 0));
            } else { st.Iq_[row + j] = ext; st.Iqt_[row + j] = i_jm1; }

            // I_target state (gap in target, consumes query base): upper cell
            cur_gap = best_pair(GAP, qbase);
            pb = best_pair(tbase, prev_q);
            ins = std::max((Score)0, st.M_[prow + j]) - dg[pb * NUM_BP + cur_gap];
            pb = best_pair(GAP, prev_q);
            ext = std::max((Score)0, st.It_[prow + j]) - dg[pb * NUM_BP + cur_gap];
            if (ins >= ext) {
                st.It_[row + j] = ins;
                st.Itt_[row + j] = (uint8_t)(im1_jm1 | ((ins == ext) ? im1_j : 0));
            } else { st.It_[row + j] = ext; st.Itt_[row + j] = im1_j; }

            if (m >= max_score) {
                if (m > max_score) {
                    max_score = m;
                    st.max_cells.clear();
                }
                st.max_cells.push_back((int64_t)row + j);
            }
        }
    }
    st.max_score = max_score;
    return max_score;
}

// Hairpin DP (reference align_hairpin, nuc_cruc.cpp:771-971): query against
// itself restricted to j < max_stem_len - (i - 1), >= 3-base loop.
Score align_hairpin(MeltState& st)
{
    st.max_cells.clear();
    const int query_len = st.q_len;
    const uint8_t* qb = st.qbuf;
    const int* dg = st.delta_g;
    const int steric_limit = 4;
    const int max_stem_len = query_len - steric_limit;

    ensure_dp(st, query_len, query_len);
    const int cols = st.cols;
    Score max_score = -1;

    for (int i = 1; i <= max_stem_len; ++i) {
        const int qbase = qb[query_len - i];
        const int prev_q = (i == 1) ? GAP : qb[query_len - (i - 1)];
        const int upper_j = max_stem_len - (i - 1);
        size_t row = (size_t)i * cols;
        size_t prow = row - cols;
        for (int j = 0; j < upper_j; ++j) {
            // X cell is matrix (i, j+1); target base index j
            const int tbase = qb[j];
            const int prev_t = (j == 0) ? GAP : qb[j - 1];
            const int cur_bp = best_pair(tbase, qbase);

            int pb = best_pair(prev_t, prev_q);
            const Score dg1 = std::max((Score)0, st.M_[prow + j]) - dg[pb * NUM_BP + cur_bp];
            pb = best_pair(prev_t, GAP);
            const Score dg2 = std::max((Score)0, st.Iq_[prow + j]) - dg[pb * NUM_BP + cur_bp];
            pb = best_pair(GAP, prev_q);
            const Score dg3 = std::max((Score)0, st.It_[prow + j]) - dg[pb * NUM_BP + cur_bp];

            Score m; uint8_t mt;
            if (dg1 >= dg2) {
                if (dg1 >= dg3) {
                    m = dg1; mt = im1_jm1;
                    if (dg1 == dg2) mt |= i_jm1;
                    if (dg1 == dg3) mt |= im1_j;
                } else { m = dg3; mt = im1_j; }
            } else {
                if (dg2 >= dg3) {
                    m = dg2; mt = i_jm1;
                    if (dg2 == dg3) mt |= im1_j;
                } else { m = dg3; mt = im1_j; }
            }
            st.M_[row + j + 1] = m; st.Mt_[row + j + 1] = mt;

            int cur_gap = best_pair(tbase, GAP);
            pb = best_pair(prev_t, qbase);
            Score ins = std::max((Score)0, st.M_[row + j]) - dg[pb * NUM_BP + cur_gap];
            pb = best_pair(prev_t, GAP);
            Score ext = std::max((Score)0, st.Iq_[row + j]) - dg[pb * NUM_BP + cur_gap];
            if (ins >= ext) {
                st.Iq_[row + j + 1] = ins;
                st.Iqt_[row + j + 1] = (uint8_t)(im1_jm1 | ((ins == ext) ? i_jm1 : 0));
            } else { st.Iq_[row + j + 1] = ext; st.Iqt_[row + j + 1] = i_jm1; }

            cur_gap = best_pair(GAP, qbase);
            pb = best_pair(tbase, prev_q);
            ins = std::max((Score)0, st.M_[prow + j + 1]) - dg[pb * NUM_BP + cur_gap];
            pb = best_pair(GAP, prev_q);
            ext = std::max((Score)0, st.It_[prow + j + 1]) - dg[pb * NUM_BP + cur_gap];
            if (ins >= ext) {
                st.It_[row + j + 1] = ins;
                st.Itt_[row + j + 1] = (uint8_t)(im1_jm1 | ((ins == ext) ? im1_j : 0));
            } else { st.It_[row + j + 1] = ext; st.Itt_[row + j + 1] = im1_j; }

            if (m >= max_score) {
                if (m > max_score) {
                    max_score = m;
                    st.max_cells.clear();
                }
                st.max_cells.push_back((int64_t)row + j + 1);
            }
        }
    }
    st.max_score = max_score;
    return max_score;
}

// ---------------------------------------------------------------------------
// Traceback (reference nuc_cruc.cpp:1409-1618): follow the stored trace
// masks from a max cell, branching at path splits via the trace stack;
// zero-score cells either get counted (first pass) or truncate the path.
void trace_back(MeltState& st, int64_t cell, bool homo,
                std::deque<TraceBranch>& stack, int& zero_count, Alignment& al)
{
    const int cols = st.cols;
    const int query_len = st.q_len;
    const uint8_t* tb = homo ? st.qbuf : st.target.data();

    int last_i = (int)(cell / cols);
    int last_j = (int)(cell % cols);

    al.fm_q = query_len - last_i;
    al.fm_t = last_j - 1;

    int truncate_at_zero = 0;
    bool count_zeros = false;
    if (zero_count < 0) { zero_count = 0; count_zeros = true; }
    else { truncate_at_zero = zero_count--; }

    static uint8_t first_match = query_target;
    uint8_t* match_ptr = &first_match;

    while (true) {
        bool valid_alignment = true;
        uint8_t local_match;

        if (path_split(*match_ptr)) {
            // Identity is by trace-byte address, as in the reference.
            auto it = std::find_if(stack.begin(), stack.end(),
                [&](const TraceBranch& b) { return b.mask_ptr == match_ptr; });
            if (it == stack.end()) {
                stack.push_back(TraceBranch(*match_ptr));
                local_match = stack.back().cur;
            } else {
                local_match = it->cur;
            }
        } else {
            local_match = *match_ptr;
        }

        size_t idx = ((size_t)last_i * cols + last_j) * st.L + st.lane;

        switch (local_match) {
            case query_target:
                if (last_i > query_len || last_j < 1) { valid_alignment = false; }
                else {
                    if (st.M_[idx] < 0) valid_alignment = false;
                    else if (st.M_[idx] == 0) {
                        if (count_zeros) ++zero_count;
                        else { if (--truncate_at_zero == 0) valid_alignment = false; }
                    }
                    al.q.push_back(st.q_at(query_len - last_i));
                    al.t.push_back(tb[last_j - 1]);
                    al.lm_q = query_len - last_i;
                    al.lm_t = last_j - 1;
                    match_ptr = &st.Mt_[idx];
                    --last_i; --last_j;
                }
                break;
            case gap_target:
                if (last_j < 1) { valid_alignment = false; }
                else {
                    if (st.Iq_[idx] < 0) valid_alignment = false;
                    al.q.push_back(GAP);
                    al.t.push_back(tb[last_j - 1]);
                    al.lm_q = query_len - last_i + 1;
                    al.lm_t = last_j - 1;
                    match_ptr = &st.Iqt_[idx];
                    --last_j;
                }
                break;
            case query_gap:
                if (last_i > query_len) { valid_alignment = false; }
                else {
                    if (st.It_[idx] < 0) valid_alignment = false;
                    al.q.push_back(st.q_at(query_len - last_i));
                    al.t.push_back(GAP);
                    al.lm_q = query_len - last_i;
                    al.lm_t = last_j;
                    match_ptr = &st.Itt_[idx];
                    --last_i;
                }
                break;
            default:
                // invalid_trace in the walk: corrupted path
                return;
        }
        if (!valid_alignment) break;
    }
}

// ---------------------------------------------------------------------------
// Batched heterodimer DP: evaluates up to DP_LANES windows sharing one
// query in int32 SIMD lanes, writing lane-interleaved matrices so the
// scalar traceback/enumeration runs unchanged per lane (st.L / st.lane).
//
// The pair-of-pairs score lookups dg[bp(pt,pq)*49 + bp(tb,qb)] collapse,
// for a fixed query row, into five 324-entry LUTs indexed by the target
// pair tp = pt*18 + tb — one gather per cost instead of two dependent
// table walks. The LUT depends only on (query, delta_g) and is cached per
// bind call. Cell arithmetic and trace-bit tie semantics are identical to
// align_dimer (reference nuc_cruc.cpp:508-693); results are bit-equal.

const int DP_LANES = 8;

struct QueryLUT {
    int wq = 0;
    // per row r (1-based row i -> index i-1): 5 x 324 int32
    std::vector<int32_t> mm, mq, mt, qi, ti;
    std::vector<int32_t> te;       // per row scalar
    std::vector<int32_t> qe;       // global 324
};

void build_query_lut_dg(const uint8_t* q, int q_len, const int* dg,
                        QueryLUT& lut)
{
    lut.wq = q_len;
    lut.mm.resize((size_t)q_len * 324);
    lut.mq.resize((size_t)q_len * 324);
    lut.mt.resize((size_t)q_len * 324);
    lut.qi.resize((size_t)q_len * 324);
    lut.ti.resize((size_t)q_len * 324);
    lut.te.resize(q_len);
    lut.qe.resize(324);
    for (int pt = 0; pt < NUM_ALPHA; ++pt)
        for (int tb = 0; tb < NUM_ALPHA; ++tb)
            lut.qe[pt * NUM_ALPHA + tb] =
                dg[best_pair(pt, GAP) * NUM_BP + best_pair(tb, GAP)];
    for (int i = 1; i <= q_len; ++i) {
        const int qbase = q[q_len - i];
        const int prev_q = (i == 1) ? GAP : q[q_len - (i - 1)];
        int32_t* mm = &lut.mm[(size_t)(i - 1) * 324];
        int32_t* mq = &lut.mq[(size_t)(i - 1) * 324];
        int32_t* mt = &lut.mt[(size_t)(i - 1) * 324];
        int32_t* qi = &lut.qi[(size_t)(i - 1) * 324];
        int32_t* ti = &lut.ti[(size_t)(i - 1) * 324];
        const int cur_bp_gq = best_pair(GAP, qbase);
        const int bp_gap_pq = best_pair(GAP, prev_q);
        for (int pt = 0; pt < NUM_ALPHA; ++pt) {
            const int bp_pt_pq = best_pair(pt, prev_q);
            const int bp_pt_gap = best_pair(pt, GAP);
            const int bp_pt_qb = best_pair(pt, qbase);
            for (int tb = 0; tb < NUM_ALPHA; ++tb) {
                const int tp = pt * NUM_ALPHA + tb;
                const int cur = best_pair(tb, qbase);
                mm[tp] = dg[bp_pt_pq * NUM_BP + cur];
                mq[tp] = dg[bp_pt_gap * NUM_BP + cur];
                mt[tp] = dg[bp_gap_pq * NUM_BP + cur];
                qi[tp] = dg[bp_pt_qb * NUM_BP + best_pair(tb, GAP)];
                ti[tp] = dg[best_pair(tb, prev_q) * NUM_BP + cur_bp_gq];
            }
        }
        lut.te[i - 1] = dg[bp_gap_pq * NUM_BP + cur_bp_gq];
    }
}

void build_query_lut(const MeltState& st, QueryLUT& lut)
{
    build_query_lut_dg(st.qbuf, st.q_len, st.delta_g, lut);
}

void ensure_dp_batch(MeltState& st, int q_len, int t_len)
{
    st.rows = q_len + 1;
    st.cols = t_len + 1;
    st.L = DP_LANES;
    st.lane = 0;
    size_t need = (size_t)st.rows * st.cols * DP_LANES;
    if (st.M_.size() < need) {
        st.M_.resize(need); st.Iq_.resize(need); st.It_.resize(need);
        st.Mt_.resize(need); st.Iqt_.resize(need); st.Itt_.resize(need);
    }
    for (int j = 0; j < st.cols; ++j) {
        for (int l = 0; l < DP_LANES; ++l) {
            size_t k = (size_t)j * DP_LANES + l;
            st.M_[k] = st.Iq_[k] = st.It_[k] = -1;
            st.Mt_[k] = st.Iqt_[k] = st.Itt_[k] = invalid_trace;
        }
    }
    for (int i = 1; i < st.rows; ++i) {
        for (int l = 0; l < DP_LANES; ++l) {
            size_t k = ((size_t)i * st.cols) * DP_LANES + l;
            st.M_[k] = st.Iq_[k] = st.It_[k] = -1;
            st.Mt_[k] = st.Iqt_[k] = st.Itt_[k] = invalid_trace;
        }
    }
}

#if defined(__x86_64__) || defined(_M_X64)
#define TNT_HAVE_AVX2_DISPATCH 1
#include <immintrin.h>

__attribute__((target("avx2"), always_inline)) inline
void pack_store_u8(uint8_t* dst, __m256i x)
{
    __m128i lo = _mm256_castsi256_si128(x);
    __m128i hi = _mm256_extracti128_si256(x, 1);
    __m128i p16 = _mm_packus_epi32(lo, hi);
    __m128i p8 = _mm_packus_epi16(p16, p16);
    _mm_storel_epi64((__m128i*)dst, p8);
}

__attribute__((target("avx2")))
void dp_batch_rows_avx2(MeltState& st, const QueryLUT& lut,
                        const int32_t* tpv, const int32_t* qev, int t_len)
{
    const int q_len = st.q_len;
    const int cols = st.cols;
    Score* Mv = st.M_.data();
    Score* Iqv = st.Iq_.data();
    Score* Itv = st.It_.data();
    uint8_t* Mtv = st.Mt_.data();
    uint8_t* Iqtv = st.Iqt_.data();
    uint8_t* Ittv = st.Itt_.data();

    const __m256i zero = _mm256_setzero_si256();
    const __m256i one = _mm256_set1_epi32(im1_jm1);
    const __m256i two = _mm256_set1_epi32(im1_j);
    const __m256i four = _mm256_set1_epi32(i_jm1);

    for (int i = 1; i <= q_len; ++i) {
        const size_t row = (size_t)i * cols;
        const size_t prow = row - cols;
        const int32_t* mm = &lut.mm[(size_t)(i - 1) * 324];
        const int32_t* mq = &lut.mq[(size_t)(i - 1) * 324];
        const int32_t* mt = &lut.mt[(size_t)(i - 1) * 324];
        const int32_t* qi = &lut.qi[(size_t)(i - 1) * 324];
        const int32_t* ti = &lut.ti[(size_t)(i - 1) * 324];
        const __m256i vte = _mm256_set1_epi32(lut.te[i - 1]);

        __m256i diagM = _mm256_loadu_si256(
            (const __m256i*)(Mv + prow * DP_LANES));
        __m256i diagIq = _mm256_loadu_si256(
            (const __m256i*)(Iqv + prow * DP_LANES));
        __m256i diagIt = _mm256_loadu_si256(
            (const __m256i*)(Itv + prow * DP_LANES));
        __m256i mprev = _mm256_loadu_si256(
            (const __m256i*)(Mv + row * DP_LANES));
        __m256i iqprev = _mm256_loadu_si256(
            (const __m256i*)(Iqv + row * DP_LANES));

        for (int j = 1; j <= t_len; ++j) {
            const __m256i upM = _mm256_loadu_si256(
                (const __m256i*)(Mv + (prow + j) * DP_LANES));
            const __m256i upIq = _mm256_loadu_si256(
                (const __m256i*)(Iqv + (prow + j) * DP_LANES));
            const __m256i upIt = _mm256_loadu_si256(
                (const __m256i*)(Itv + (prow + j) * DP_LANES));
            const __m256i vtp = _mm256_loadu_si256(
                (const __m256i*)(tpv + (size_t)(j - 1) * DP_LANES));

            const __m256i dgmm = _mm256_i32gather_epi32(mm, vtp, 4);
            const __m256i dgmq = _mm256_i32gather_epi32(mq, vtp, 4);
            const __m256i dgmt = _mm256_i32gather_epi32(mt, vtp, 4);
            const __m256i dgqi = _mm256_i32gather_epi32(qi, vtp, 4);
            const __m256i dgti = _mm256_i32gather_epi32(ti, vtp, 4);
            const __m256i dgqe = _mm256_loadu_si256(
                (const __m256i*)(qev + (size_t)(j - 1) * DP_LANES));

            // M state (diagonal predecessors)
            const __m256i a1 = _mm256_sub_epi32(
                _mm256_max_epi32(diagM, zero), dgmm);
            const __m256i a2 = _mm256_sub_epi32(
                _mm256_max_epi32(diagIq, zero), dgmq);
            const __m256i a3 = _mm256_sub_epi32(
                _mm256_max_epi32(diagIt, zero), dgmt);
            const __m256i lt12 = _mm256_cmpgt_epi32(a2, a1);  // a1 <  a2
            const __m256i gt31 = _mm256_cmpgt_epi32(a3, a1);  // a1 <  a3
            const __m256i gt32 = _mm256_cmpgt_epi32(a3, a2);  // a2 <  a3
            const __m256i eq12 = _mm256_cmpeq_epi32(a1, a2);
            const __m256i eq13 = _mm256_cmpeq_epi32(a1, a3);
            const __m256i eq23 = _mm256_cmpeq_epi32(a2, a3);
            const __m256i m = _mm256_max_epi32(a1, _mm256_max_epi32(a2, a3));
            const __m256i case1 = _mm256_andnot_si256(
                lt12, _mm256_andnot_si256(gt31, _mm256_set1_epi32(-1)));
            const __m256i case2 = _mm256_andnot_si256(lt12, gt31);
            const __m256i case3 = _mm256_andnot_si256(gt32, lt12);
            const __m256i case4 = _mm256_and_si256(lt12, gt32);
            __m256i mtrace = _mm256_and_si256(case1, _mm256_or_si256(
                one, _mm256_or_si256(_mm256_and_si256(eq12, four),
                                     _mm256_and_si256(eq13, two))));
            mtrace = _mm256_or_si256(mtrace, _mm256_and_si256(
                _mm256_or_si256(case2, case4), two));
            mtrace = _mm256_or_si256(mtrace, _mm256_and_si256(
                case3, _mm256_or_si256(four, _mm256_and_si256(eq23, two))));

            // I_query state (left predecessors, current row)
            const __m256i ins = _mm256_sub_epi32(
                _mm256_max_epi32(mprev, zero), dgqi);
            const __m256i ext = _mm256_sub_epi32(
                _mm256_max_epi32(iqprev, zero), dgqe);
            const __m256i ltq = _mm256_cmpgt_epi32(ext, ins);  // ins < ext
            const __m256i eqq = _mm256_cmpeq_epi32(ins, ext);
            const __m256i iq = _mm256_max_epi32(ins, ext);
            __m256i iqtrace = _mm256_andnot_si256(ltq, _mm256_or_si256(
                one, _mm256_and_si256(eqq, four)));
            iqtrace = _mm256_or_si256(iqtrace, _mm256_and_si256(ltq, four));

            // I_target state (up predecessors)
            const __m256i ins2 = _mm256_sub_epi32(
                _mm256_max_epi32(upM, zero), dgti);
            const __m256i ext2 = _mm256_sub_epi32(
                _mm256_max_epi32(upIt, zero), vte);
            const __m256i ltt = _mm256_cmpgt_epi32(ext2, ins2);
            const __m256i eqt = _mm256_cmpeq_epi32(ins2, ext2);
            const __m256i it = _mm256_max_epi32(ins2, ext2);
            __m256i ittrace = _mm256_andnot_si256(ltt, _mm256_or_si256(
                one, _mm256_and_si256(eqt, two)));
            ittrace = _mm256_or_si256(ittrace, _mm256_and_si256(ltt, two));

            _mm256_storeu_si256((__m256i*)(Mv + (row + j) * DP_LANES), m);
            _mm256_storeu_si256((__m256i*)(Iqv + (row + j) * DP_LANES), iq);
            _mm256_storeu_si256((__m256i*)(Itv + (row + j) * DP_LANES), it);
            pack_store_u8(Mtv + (row + j) * DP_LANES, mtrace);
            pack_store_u8(Iqtv + (row + j) * DP_LANES, iqtrace);
            pack_store_u8(Ittv + (row + j) * DP_LANES, ittrace);

            diagM = upM; diagIq = upIq; diagIt = upIt;
            mprev = m; iqprev = iq;
        }
    }
}
#endif  // x86_64

// Portable lane-scalar fallback with identical arithmetic.
void dp_batch_rows_scalar(MeltState& st, const QueryLUT& lut,
                          const int32_t* tpv, const int32_t* qev, int t_len)
{
    const int q_len = st.q_len;
    const int cols = st.cols;
    for (int i = 1; i <= q_len; ++i) {
        const size_t row = (size_t)i * cols;
        const size_t prow = row - cols;
        const int32_t* mm = &lut.mm[(size_t)(i - 1) * 324];
        const int32_t* mq = &lut.mq[(size_t)(i - 1) * 324];
        const int32_t* mt = &lut.mt[(size_t)(i - 1) * 324];
        const int32_t* qi = &lut.qi[(size_t)(i - 1) * 324];
        const int32_t* ti = &lut.ti[(size_t)(i - 1) * 324];
        const int32_t te = lut.te[i - 1];
        for (int j = 1; j <= t_len; ++j) {
            for (int l = 0; l < DP_LANES; ++l) {
                const int tp = tpv[(size_t)(j - 1) * DP_LANES + l];
                const size_t c = (row + j) * DP_LANES + l;
                const size_t d = (prow + j - 1) * DP_LANES + l;
                const size_t u = (prow + j) * DP_LANES + l;
                const size_t lft = (row + j - 1) * DP_LANES + l;
                auto relu = [](Score x) { return x > 0 ? x : 0; };
                const Score a1 = relu(st.M_[d]) - mm[tp];
                const Score a2 = relu(st.Iq_[d]) - mq[tp];
                const Score a3 = relu(st.It_[d]) - mt[tp];
                Score m; uint8_t mtr;
                if (a1 >= a2) {
                    if (a1 >= a3) {
                        m = a1; mtr = im1_jm1;
                        if (a1 == a2) mtr |= i_jm1;
                        if (a1 == a3) mtr |= im1_j;
                    } else { m = a3; mtr = im1_j; }
                } else {
                    if (a2 >= a3) {
                        m = a2; mtr = i_jm1;
                        if (a2 == a3) mtr |= im1_j;
                    } else { m = a3; mtr = im1_j; }
                }
                st.M_[c] = m; st.Mt_[c] = mtr;
                const Score ins = relu(st.M_[lft]) - qi[tp];
                const Score ext = relu(st.Iq_[lft])
                    - qev[(size_t)(j - 1) * DP_LANES + l];
                if (ins >= ext) {
                    st.Iq_[c] = ins;
                    st.Iqt_[c] = (uint8_t)(im1_jm1 | ((ins == ext) ? i_jm1 : 0));
                } else { st.Iq_[c] = ext; st.Iqt_[c] = i_jm1; }
                const Score ins2 = relu(st.M_[u]) - ti[tp];
                const Score ext2 = relu(st.It_[u]) - te;
                if (ins2 >= ext2) {
                    st.It_[c] = ins2;
                    st.Itt_[c] = (uint8_t)(im1_jm1 | ((ins2 == ext2) ? im1_j : 0));
                } else { st.It_[c] = ext2; st.Itt_[c] = im1_j; }
            }
        }
    }
}

bool dp_batch_avx2_available()
{
#ifdef TNT_HAVE_AVX2_DISPATCH
    static const bool ok = __builtin_cpu_supports("avx2");
    return ok;
#else
    return false;
#endif
}

// Run the batched DP for n_lanes windows (same query already in st.qbuf,
// same t_len).  Fills lane-interleaved matrices; reports per-lane
// max_score and max_cells (linear cell indices, scan order — identical to
// the scalar align_dimer collection, reference nuc_cruc.cpp:680-691).
void align_dimer_batch(MeltState& st, const QueryLUT& lut,
                       const uint8_t* const* targets, int t_len, int n_lanes,
                       Score* max_scores,
                       std::vector<int64_t>* max_cells)
{
    const int q_len = st.q_len;
    ensure_dp_batch(st, q_len, t_len);
    const int cols = st.cols;

    // target-pair vector per (column, lane) + the query-independent
    // gap-extension cost (both precomputable once per batch)
    static thread_local std::vector<int32_t> tpv, qev;
    tpv.resize((size_t)t_len * DP_LANES);
    qev.resize((size_t)t_len * DP_LANES);
    for (int j = 1; j <= t_len; ++j) {
        for (int l = 0; l < DP_LANES; ++l) {
            const uint8_t* t = targets[l < n_lanes ? l : 0];
            const int pt = (j == 1) ? GAP : t[j - 2];
            const int tb = t[j - 1];
            const int tp = pt * NUM_ALPHA + tb;
            tpv[(size_t)(j - 1) * DP_LANES + l] = tp;
            qev[(size_t)(j - 1) * DP_LANES + l] = lut.qe[tp];
        }
    }

#ifdef TNT_HAVE_AVX2_DISPATCH
    if (dp_batch_avx2_available())
        dp_batch_rows_avx2(st, lut, tpv.data(), qev.data(), t_len);
    else
#endif
        dp_batch_rows_scalar(st, lut, tpv.data(), qev.data(), t_len);

    // Per-lane max collection, scan order.  Two passes: find each lane's
    // max (vectorized across lanes), then append only matching cells —
    // equivalent to the reference's running-max push (a strictly greater
    // score clears the list, so the final list holds exactly the cells
    // equal to the final max, in scan order; nuc_cruc.cpp:680-691).
    Score vmax[DP_LANES];
    for (int l = 0; l < DP_LANES; ++l) vmax[l] = -1;
    for (int i = 1; i <= q_len; ++i) {
        const Score* rowp = st.M_.data() + ((size_t)i * cols + 1) * DP_LANES;
        for (int j = 0; j < t_len; ++j)
            for (int l = 0; l < DP_LANES; ++l) {
                const Score m = rowp[(size_t)j * DP_LANES + l];
                if (m > vmax[l]) vmax[l] = m;
            }
    }
    for (int l = 0; l < n_lanes; ++l) {
        max_scores[l] = vmax[l];
        max_cells[l].clear();
    }
    for (int i = 1; i <= q_len; ++i) {
        const size_t row = (size_t)i * cols;
        const Score* rowp = st.M_.data() + (row + 1) * DP_LANES;
        for (int j = 0; j < t_len; ++j)
            for (int l = 0; l < n_lanes; ++l)
                if (rowp[(size_t)j * DP_LANES + l] == vmax[l])
                    max_cells[l].push_back((int64_t)(row + 1 + j));
    }
}

// ---------------------------------------------------------------------------
// Score-only batched DP: the host screening kernel.  Identical recurrence
// to dp_batch_rows_* but keeps only two rolling rows and a running max —
// no trace bits, no matrix retention — so it costs a fraction of the full
// DP.  Used to evaluate the conservative screen dp(T) >= min_score at the
// screening temperatures (screen.py proof; slack covers exact-vs-path,
// and this DP computes dp(T) exactly, so no extra margin is needed).

#ifdef TNT_HAVE_AVX2_DISPATCH
__attribute__((target("avx2")))
void dp_batch_score_rows_avx2(const QueryLUT& lut, const int32_t* tpv,
                              const int32_t* qev, int q_len, int t_len,
                              Score* vmax_out)
{
    static thread_local std::vector<Score> buf;
    const size_t stride = (size_t)(t_len + 1) * DP_LANES;
    buf.resize(6 * stride);
    Score* prevM = buf.data();
    Score* prevIq = prevM + stride;
    Score* prevIt = prevIq + stride;
    Score* curM = prevIt + stride;
    Score* curIq = curM + stride;
    Score* curIt = curIq + stride;
    for (size_t k = 0; k < 3 * stride; ++k) buf[k] = -1;

    const __m256i zero = _mm256_setzero_si256();
    const __m256i neg1 = _mm256_set1_epi32(-1);
    __m256i vmax = neg1;

    for (int i = 1; i <= q_len; ++i) {
        const int32_t* mm = &lut.mm[(size_t)(i - 1) * 324];
        const int32_t* mq = &lut.mq[(size_t)(i - 1) * 324];
        const int32_t* mt = &lut.mt[(size_t)(i - 1) * 324];
        const int32_t* qi = &lut.qi[(size_t)(i - 1) * 324];
        const int32_t* ti = &lut.ti[(size_t)(i - 1) * 324];
        const __m256i vte = _mm256_set1_epi32(lut.te[i - 1]);

        __m256i diagM = neg1, diagIq = neg1, diagIt = neg1;
        __m256i mprev = neg1, iqprev = neg1;
        _mm256_storeu_si256((__m256i*)curM, neg1);
        _mm256_storeu_si256((__m256i*)curIq, neg1);
        _mm256_storeu_si256((__m256i*)curIt, neg1);

        for (int j = 1; j <= t_len; ++j) {
            const __m256i upM = _mm256_loadu_si256(
                (const __m256i*)(prevM + (size_t)j * DP_LANES));
            const __m256i upIq = _mm256_loadu_si256(
                (const __m256i*)(prevIq + (size_t)j * DP_LANES));
            const __m256i upIt = _mm256_loadu_si256(
                (const __m256i*)(prevIt + (size_t)j * DP_LANES));
            const __m256i vtp = _mm256_loadu_si256(
                (const __m256i*)(tpv + (size_t)(j - 1) * DP_LANES));

            const __m256i dgmm = _mm256_i32gather_epi32(mm, vtp, 4);
            const __m256i dgmq = _mm256_i32gather_epi32(mq, vtp, 4);
            const __m256i dgmt = _mm256_i32gather_epi32(mt, vtp, 4);
            const __m256i dgqi = _mm256_i32gather_epi32(qi, vtp, 4);
            const __m256i dgti = _mm256_i32gather_epi32(ti, vtp, 4);
            const __m256i dgqe = _mm256_loadu_si256(
                (const __m256i*)(qev + (size_t)(j - 1) * DP_LANES));

            const __m256i a1 = _mm256_sub_epi32(
                _mm256_max_epi32(diagM, zero), dgmm);
            const __m256i a2 = _mm256_sub_epi32(
                _mm256_max_epi32(diagIq, zero), dgmq);
            const __m256i a3 = _mm256_sub_epi32(
                _mm256_max_epi32(diagIt, zero), dgmt);
            const __m256i m = _mm256_max_epi32(a1, _mm256_max_epi32(a2, a3));

            const __m256i ins = _mm256_sub_epi32(
                _mm256_max_epi32(mprev, zero), dgqi);
            const __m256i ext = _mm256_sub_epi32(
                _mm256_max_epi32(iqprev, zero), dgqe);
            const __m256i iq = _mm256_max_epi32(ins, ext);

            const __m256i ins2 = _mm256_sub_epi32(
                _mm256_max_epi32(upM, zero), dgti);
            const __m256i ext2 = _mm256_sub_epi32(
                _mm256_max_epi32(upIt, zero), vte);
            const __m256i it = _mm256_max_epi32(ins2, ext2);

            _mm256_storeu_si256((__m256i*)(curM + (size_t)j * DP_LANES), m);
            _mm256_storeu_si256((__m256i*)(curIq + (size_t)j * DP_LANES),
                                iq);
            _mm256_storeu_si256((__m256i*)(curIt + (size_t)j * DP_LANES),
                                it);
            vmax = _mm256_max_epi32(vmax, m);

            diagM = upM; diagIq = upIq; diagIt = upIt;
            mprev = m; iqprev = iq;
        }
        std::swap(prevM, curM);
        std::swap(prevIq, curIq);
        std::swap(prevIt, curIt);
    }
    _mm256_storeu_si256((__m256i*)vmax_out, vmax);
}
#endif  // TNT_HAVE_AVX2_DISPATCH

void dp_batch_score_rows_scalar(const QueryLUT& lut, const int32_t* tpv,
                                const int32_t* qev, int q_len, int t_len,
                                Score* vmax_out)
{
    static thread_local std::vector<Score> buf;
    const size_t stride = (size_t)(t_len + 1) * DP_LANES;
    buf.resize(6 * stride);
    Score* prevM = buf.data();
    Score* prevIq = prevM + stride;
    Score* prevIt = prevIq + stride;
    Score* curM = prevIt + stride;
    Score* curIq = curM + stride;
    Score* curIt = curIq + stride;
    for (size_t k = 0; k < 3 * stride; ++k) buf[k] = -1;
    Score vmax[DP_LANES];
    for (int l = 0; l < DP_LANES; ++l) vmax[l] = -1;
    auto relu = [](Score x) { return x > 0 ? x : 0; };

    for (int i = 1; i <= q_len; ++i) {
        const int32_t* mm = &lut.mm[(size_t)(i - 1) * 324];
        const int32_t* mq = &lut.mq[(size_t)(i - 1) * 324];
        const int32_t* mt = &lut.mt[(size_t)(i - 1) * 324];
        const int32_t* qi = &lut.qi[(size_t)(i - 1) * 324];
        const int32_t* ti = &lut.ti[(size_t)(i - 1) * 324];
        const int32_t te = lut.te[i - 1];
        for (int l = 0; l < DP_LANES; ++l)
            curM[l] = curIq[l] = curIt[l] = -1;
        for (int j = 1; j <= t_len; ++j) {
            for (int l = 0; l < DP_LANES; ++l) {
                const int tp = tpv[(size_t)(j - 1) * DP_LANES + l];
                const size_t c = (size_t)j * DP_LANES + l;
                const size_t d = (size_t)(j - 1) * DP_LANES + l;
                const Score a1 = relu(prevM[d]) - mm[tp];
                const Score a2 = relu(prevIq[d]) - mq[tp];
                const Score a3 = relu(prevIt[d]) - mt[tp];
                Score m = a1 > a2 ? a1 : a2;
                if (a3 > m) m = a3;
                const Score ins = relu(curM[d]) - qi[tp];
                const Score ext = relu(curIq[d])
                    - qev[(size_t)(j - 1) * DP_LANES + l];
                const Score ins2 = relu(prevM[c]) - ti[tp];
                const Score ext2 = relu(prevIt[c]) - te;
                curM[c] = m;
                curIq[c] = ins > ext ? ins : ext;
                curIt[c] = ins2 > ext2 ? ins2 : ext2;
                if (m > vmax[l]) vmax[l] = m;
            }
        }
        std::swap(prevM, curM);
        std::swap(prevIq, curIq);
        std::swap(prevIt, curIt);
    }
    for (int l = 0; l < DP_LANES; ++l) vmax_out[l] = vmax[l];
}

// Max DP score per lane for n_lanes same-length windows against the
// (query, delta_g) baked into `lut` — no MeltState needed.
void dp_batch_score(const QueryLUT& lut, const uint8_t* const* targets,
                    int t_len, int n_lanes, Score* scores)
{
    static thread_local std::vector<int32_t> tpv, qev;
    tpv.resize((size_t)t_len * DP_LANES);
    qev.resize((size_t)t_len * DP_LANES);
    for (int j = 1; j <= t_len; ++j) {
        for (int l = 0; l < DP_LANES; ++l) {
            const uint8_t* t = targets[l < n_lanes ? l : 0];
            const int pt = (j == 1) ? GAP : t[j - 2];
            const int tp = pt * NUM_ALPHA + t[j - 1];
            tpv[(size_t)(j - 1) * DP_LANES + l] = tp;
            qev[(size_t)(j - 1) * DP_LANES + l] = lut.qe[tp];
        }
    }
    Score out[DP_LANES];
#ifdef TNT_HAVE_AVX2_DISPATCH
    if (dp_batch_avx2_available())
        dp_batch_score_rows_avx2(lut, tpv.data(), qev.data(), lut.wq,
                                 t_len, out);
    else
#endif
        dp_batch_score_rows_scalar(lut, tpv.data(), qev.data(), lut.wq,
                                   t_len, out);
    for (int l = 0; l < n_lanes; ++l) scores[l] = out[l];
}

// ---------------------------------------------------------------------------
// Exact alignment re-scoring (reference evaluate_alignment,
// nuc_cruc.cpp:1620-2299).
bool evaluate_alignment(MeltState& st, Alignment& al, Mode mode)
{
    const Tables& tt = st.eng->t;
    const int PAIR__ = GAP * NUM_BASE + GAP;  // "__"
    const int AT = A * NUM_BASE + T, TA = T * NUM_BASE + A;
    const int CG = C * NUM_BASE + G, GC = G * NUM_BASE + C;
    const int GT = G * NUM_BASE + T, TG = T * NUM_BASE + G;
    const int EE = E * NUM_BASE + E;

    int terminal_bp = PAIR__;
    int last_last_bp = PAIR__;
    int last_bp = PAIR__;
    int cur_bp = PAIR__;

    if (mode != HAIRPIN) {
        al.dH = tt.init_H;
        al.dS = tt.init_S + ((mode == HOMO_DIMER) ? tt.sym_S : 0.0f);
    }

    unsigned num_query_gap = 0, num_target_gap = 0, num_mismatch = 0;
    unsigned num_base = 0;
    bool terminal_5 = false;

    const size_t align_size = al.q.size();
    size_t ai = 0;  // iterator position

    cur_bp = best_pair(al.q[0], al.t[0]);
    if (tt.wc[cur_bp]) {
        terminal_5 = true;
        if (cur_bp == AT || cur_bp == TA) { al.dH += tt.AT_H; al.dS += tt.AT_S; }
    }
    num_base += is_virtual(al.q[0]) ? 0 : 1;
    num_base += is_virtual(al.t[0]) ? 0 : 1;

    for (ai = 1; ai < align_size; ++ai) {
        last_last_bp = last_bp;
        last_bp = cur_bp;
        cur_bp = best_pair(al.q[ai], al.t[ai]);

        const bool align_start = (ai == 1);
        const bool align_stop = (ai == align_size - 1);

        const bool in_loop_or_bulge = (al.q[ai] == GAP) || (al.t[ai] == GAP) ||
            (!tt.wc[last_bp] && !tt.wc[cur_bp]);

        if (!in_loop_or_bulge) {
            const bool last_non_virtual =
                (last_bp / NUM_BASE) < E && (last_bp % NUM_BASE) < E;
            const bool cur_non_virtual =
                (cur_bp / NUM_BASE) < E && (cur_bp % NUM_BASE) < E;
            if (align_start && !tt.wc[last_bp] && last_non_virtual) {
                // Frayed end at the beginning: sum of the two dangling-end
                // configurations.
                const int tq = last_bp / NUM_BASE;
                const int tr = last_bp % NUM_BASE;
                int tp = best_pair(tq, E);
                al.dH += tt.param_H[tp * NUM_BP + cur_bp];
                al.dS += tt.param_S[tp * NUM_BP + cur_bp];
                tp = best_pair(E, tr);
                al.dH += tt.param_H[tp * NUM_BP + cur_bp];
                al.dS += tt.param_S[tp * NUM_BP + cur_bp];
            } else if (align_stop && !tt.wc[cur_bp] && cur_non_virtual) {
                int tp = best_pair(al.q[ai], E);
                al.dH += tt.param_H[last_bp * NUM_BP + tp];
                al.dS += tt.param_S[last_bp * NUM_BP + tp];
                tp = best_pair(E, al.t[ai]);
                al.dH += tt.param_H[last_bp * NUM_BP + tp];
                al.dS += tt.param_S[last_bp * NUM_BP + tp];
            } else {
                al.dH += tt.param_H[last_bp * NUM_BP + cur_bp];
                al.dS += tt.param_S[last_bp * NUM_BP + cur_bp];
            }
            num_base += is_virtual(al.q[ai]) ? 0 : 1;
            num_base += is_virtual(al.t[ai]) ? 0 : 1;
        }

        if (tt.wc[cur_bp] || cur_bp == EE) {
            terminal_bp = cur_bp;
            if (!terminal_5) {
                terminal_5 = true;
                if (cur_bp == AT || cur_bp == TA) { al.dH += tt.AT_H; al.dS += tt.AT_S; }
            }

            const unsigned max_gap = std::max(num_query_gap, num_target_gap);

            if (num_mismatch > 1 || (max_gap > 0 && num_mismatch == 1)) {
                // Closing an internal loop
                const unsigned gap_difference = (num_query_gap > num_target_gap)
                    ? num_query_gap - num_target_gap : num_target_gap - num_query_gap;
                const unsigned loop_size = num_mismatch * 2 + gap_difference;

                if (loop_size == 2 &&
                    (last_bp == GT || last_bp == TG) &&
                    (last_last_bp == GT || last_last_bp == TG)) {
                    al.dH += tt.param_H[last_last_bp * NUM_BP + last_bp];
                    al.dS += tt.param_S[last_last_bp * NUM_BP + last_bp];
                    num_base += 2;
                } else {
                    al.dS += tt.loop_S[loop_size];
                    al.dS += gap_difference * tt.asym_S;

                    long rhs_q = (long)ai - 1, rhs_t = (long)ai - 1;

                    // Remove the stack contribution added above for the right
                    // terminal pair; replace with loop-terminal parameters.
                    al.dH -= tt.param_H[last_bp * NUM_BP + cur_bp];
                    al.dS -= tt.param_S[last_bp * NUM_BP + cur_bp];

                    const bool last_has_gap =
                        (last_bp % NUM_BASE == GAP) || (last_bp / NUM_BASE >= GAP);
                    if (!last_has_gap) {
                        al.dH += tt.loop_term_H[last_bp * NUM_BP + cur_bp];
                        al.dS += tt.loop_term_S[last_bp * NUM_BP + cur_bp];
                    } else {
                        int mm_bp = PAIR__;
                        if (last_bp / NUM_BASE == GAP) {
                            // walk back on the query strand for a real base
                            while (true) {
                                if (!is_virtual(al.q[rhs_q])) {
                                    mm_bp = best_pair(al.q[rhs_q], last_bp % NUM_BASE);
                                    break;
                                }
                                if (rhs_q == 0) break;
                                --rhs_q;
                            }
                        } else {  // target side gap
                            while (true) {
                                if (!is_virtual(al.t[rhs_t])) {
                                    mm_bp = best_pair(last_bp / NUM_BASE, al.t[rhs_t]);
                                    break;
                                }
                                if (rhs_t == 0) break;
                                --rhs_t;
                            }
                        }
                        al.dH += tt.loop_term_H[mm_bp * NUM_BP + cur_bp];
                        al.dS += tt.loop_term_S[mm_bp * NUM_BP + cur_bp];
                    }

                    // Left terminal mismatch: walk back to the closest WC
                    // pair, then read ahead past any gaps.
                    long lhs_q = (long)ai - 1, lhs_t = (long)ai - 1;
                    while (true) {
                        const int pm_bp = best_pair(al.q[lhs_q], al.t[lhs_t]);
                        if (tt.wc[pm_bp]) {
                            ++lhs_q; ++lhs_t;
                            if (al.q[lhs_q] != GAP && al.t[lhs_t] != GAP) {
                                const int mm_bp = best_pair(al.q[lhs_q], al.t[lhs_t]);
                                al.dH -= tt.param_H[pm_bp * NUM_BP + mm_bp];
                                al.dS -= tt.param_S[pm_bp * NUM_BP + mm_bp];
                            } else {
                                num_base += 2;
                                while (al.q[lhs_q] == GAP) ++lhs_q;
                                while (al.t[lhs_t] == GAP) ++lhs_t;
                            }
                            const int mm_bp = best_pair(al.q[lhs_q], al.t[lhs_t]);
                            al.dH += tt.loop_term_H[pm_bp * NUM_BP + mm_bp];
                            al.dS += tt.loop_term_S[pm_bp * NUM_BP + mm_bp];
                            break;
                        }
                        if (lhs_q == 0) break;
                        --lhs_q; --lhs_t;
                    }

                    if (rhs_q != lhs_q) ++num_base;
                    if (rhs_t != lhs_t) ++num_base;
                }
            } else if (num_query_gap || num_target_gap) {
                // Closing a bulge
                const unsigned bulge_size = (num_query_gap > num_target_gap)
                    ? num_query_gap : num_target_gap;
                if (bulge_size == 1) {
                    al.dH += tt.param_H[last_last_bp * NUM_BP + cur_bp];
                    al.dS += tt.param_S[last_last_bp * NUM_BP + cur_bp];
                }
                al.dS += tt.bulge_S[bulge_size];
                // UNAFOLD compatibility: no AT-closing penalty on single-base
                // bulges (reference UNAFOLD_COMPATIBILITY branch).
                if (bulge_size != 1 && (al.q[ai] == A || al.q[ai] == T))
                    al.dS += tt.bulge_AT_S;
                if (bulge_size != 1) {
                    // has_AT_initiation: walk back past gaps
                    long qi = (long)ai, ti2 = (long)ai;
                    do { --qi; --ti2; }
                    while (qi != 0 && ti2 != 0 && (al.q[qi] == GAP || al.t[ti2] == GAP));
                    const int bp = best_pair(al.q[qi], al.t[ti2]);
                    if (bp == AT || bp == TA) al.dS += tt.bulge_AT_S;
                }
            }
            num_query_gap = num_target_gap = 0;
            num_mismatch = 0;
        } else {
            num_mismatch += (!is_virtual(al.q[ai]) && !is_virtual(al.t[ai])) ? 1 : 0;
        }
        num_query_gap += (al.q[ai] == GAP) ? 1 : 0;
        num_target_gap += (al.t[ai] == GAP) ? 1 : 0;
    }

    if (terminal_bp == AT || terminal_bp == TA) { al.dH += tt.AT_H; al.dS += tt.AT_S; }

    if (al.dH >= 0.0f) return false;

    const float heterodimer_inv_alpha = 1.0f;
    al.dS += tt.SALT * (0.5f * num_base - 1) * log(st.eng->na);

    float tm;
    if (mode == HAIRPIN) tm = al.dH / al.dS - NC_ZERO_C;
    else tm = al.dH / (NC_R * log(st.strand_conc * heterodimer_inv_alpha) + al.dS) - NC_ZERO_C;
    al.tm = std::max(0.0f, tm);
    return true;
}

// find_loop_index (reference nuc_cruc.cpp:2619-2869): exact lookup of the 5-
// or 6-base closing loop sequence among the special-loop table entries of
// that exact length.
int find_loop_index(const MeltState& st, int m_start, int m_len)
{
    static const char* base_name = "ACGTE";
    char buf[8];
    for (int k = 0; k < m_len; ++k) {
        const int b = st.q_at(m_start + k);
        buf[k] = (b <= 4) ? base_name[b] : '?';
    }
    buf[m_len] = 0;
    const Tables& tt = st.eng->t;
    for (int i = 0; i < 131; ++i) {
        if ((int)std::strlen(tt.special_seq[i]) == m_len &&
            std::memcmp(tt.special_seq[i], buf, m_len) == 0)
            return i;
    }
    return -1;
}

// evaluate_hairpin_alignment (reference nuc_cruc.cpp:2301-2394)
bool evaluate_hairpin_alignment(MeltState& st, Alignment& al)
{
    const Tables& tt = st.eng->t;
    const int AT = A * NUM_BASE + T, TA = T * NUM_BASE + A;
    const int last_3 = al.fm_q;
    const int last_5 = al.fm_t;
    const unsigned hairpin_loop_len = (unsigned)(last_3 - last_5 - 1);

    al.dH = 0.0f;
    al.dS = 0.0f;
    al.dS += tt.hairpin_S[hairpin_loop_len < 513 ? hairpin_loop_len : 512];

    const int last_bp = best_pair(st.q_at(last_5), st.q_at(last_3));
    int cur_bp;

    switch (hairpin_loop_len) {
        case 3: {
            const int loop_index = find_loop_index(st, last_5, 5);
            if (loop_index >= 0) {
                al.dH += tt.special_H[loop_index];
                al.dS += tt.special_S[loop_index];
            }
            if (last_bp == AT || last_bp == TA) al.dS += tt.bulge_AT_S;
            break;
        }
        case 4: {
            const int loop_index = find_loop_index(st, last_5, 6);
            if (loop_index >= 0) {
                al.dH += tt.special_H[loop_index];
                al.dS += tt.special_S[loop_index];
            }
            // fall through: terminal mismatch
        }
        default:
            cur_bp = best_pair(st.q_at(last_5 + 1), st.q_at(last_3 - 1));
            al.dH += tt.hp_term_H[last_bp * NUM_BP + cur_bp];
            al.dS += tt.hp_term_S[last_bp * NUM_BP + cur_bp];
            break;
    }
    return evaluate_alignment(st, al, HAIRPIN);
}

// ---------------------------------------------------------------------------
// Co-optimal path enumeration (reference enumerate_dimer_alignments,
// nuc_cruc.cpp:973-1170).
void enumerate_dimer_alignments(MeltState& st, int64_t max_cell, bool homo,
                                Alignment& best, Mode mode)
{
    const Tables& tt = st.eng->t;
    bool first_time = true;
    std::deque<TraceBranch> stack;
    int zero_count = -1;
    unsigned trace_count = 0;
    const unsigned max_dp_path_enum = 16;

    float best_dg = best.dH - st.target_T * best.dS;
    const int query_len = st.q_len;
    const int target_len = homo ? query_len : (int)st.target.size();
    const uint8_t* tb = homo ? st.qbuf : st.target.data();

    while (true) {
        if (!first_time && stack.empty() && zero_count <= 0) break;
        if (max_dp_path_enum < trace_count) break;
        ++trace_count;
        first_time = false;

        Alignment local;
        trace_back(st, max_cell, homo, stack, zero_count, local);

        // Trim frayed (non-WC) ends
        while (!local.q.empty() &&
               !tt.wc[best_pair(local.q.back(), local.t.back())]) {
            if (!is_virtual(local.q.back())) --local.lm_q;
            if (!is_virtual(local.t.back())) ++local.lm_t;
            local.q.pop_back();
            local.t.pop_back();
        }
        while (!local.q.empty() &&
               !tt.wc[best_pair(local.q.front(), local.t.front())]) {
            if (!is_virtual(local.q.front())) ++local.fm_q;
            if (!is_virtual(local.t.front())) --local.fm_t;
            local.q.pop_front();
            local.t.pop_front();
        }

        if (zero_count == 0 && !stack.empty()) {
            while (!stack.empty() && !stack.back().next_trace()) stack.pop_back();
            zero_count = -1;
        }

        // Dangling-end / frayed-end attachment at the 5'-query side
        if (st.eng->dangle5 &&
            (local.fm_q != 0 || local.fm_t != target_len - 1)) {
            if (local.fm_q == 0) local.q.push_front(E);
            else { --local.fm_q; local.q.push_front(st.q_at(local.fm_q)); }
            if (local.fm_t == target_len - 1) local.t.push_front(E);
            else { ++local.fm_t; local.t.push_front(tb[local.fm_t]); }
        }
        // ... and at the 3'-query side
        if (st.eng->dangle3 &&
            (local.lm_q != query_len - 1 || local.lm_t != 0)) {
            if (local.lm_q == query_len - 1) local.q.push_back(E);
            else { ++local.lm_q; local.q.push_back(st.q_at(local.lm_q)); }
            if (local.lm_t == 0) local.t.push_back(E);
            else { --local.lm_t; local.t.push_back(tb[local.lm_t]); }
        }

        if (local.q.size() < 3) continue;

        if (evaluate_alignment(st, local, mode)) {
            const float local_dg = local.dH - st.target_T * local.dS;
            if (!best.valid || local_dg < best_dg) {
                best = local;
                best.valid = true;
                best_dg = local_dg;
            }
        }
    }
}

// enumerate_hairpin_alignments (reference nuc_cruc.cpp:1172-1407)
void enumerate_hairpin_alignments(MeltState& st, int64_t max_cell, Alignment& best)
{
    const Tables& tt = st.eng->t;
    const unsigned min_hairpin_size = 3;
    bool first_time = true;
    std::deque<TraceBranch> stack;
    int zero_count = -1;
    unsigned trace_count = 0;
    const unsigned max_dp_path_enum = 16;

    float best_dg = best.dH - st.target_T * best.dS;
    const int query_len = st.q_len;
    const int AT = A * NUM_BASE + T, TA = T * NUM_BASE + A;
    const int CG = C * NUM_BASE + G, GC = G * NUM_BASE + C;

    while (true) {
        if (!first_time && stack.empty() && zero_count <= 0) break;
        if (max_dp_path_enum < trace_count) break;
        ++trace_count;
        first_time = false;

        Alignment local;
        trace_back(st, max_cell, true, stack, zero_count, local);

        while (!local.q.empty() &&
               !tt.wc[best_pair(local.q.back(), local.t.back())]) {
            if (!is_virtual(local.q.back())) --local.lm_q;
            if (!is_virtual(local.t.back())) ++local.lm_t;
            local.q.pop_back();
            local.t.pop_back();
        }
        while (!local.q.empty() &&
               !tt.wc[best_pair(local.q.front(), local.t.front())]) {
            if (!is_virtual(local.q.front())) ++local.fm_q;
            if (!is_virtual(local.t.front())) --local.fm_t;
            local.q.pop_front();
            local.t.pop_front();
        }

        if (zero_count == 0 && !stack.empty()) {
            while (!stack.empty() && !stack.back().next_trace()) stack.pop_back();
            zero_count = -1;
        }

        // First evaluation: before the dangling-end handling
        if (local.q.size() >= min_hairpin_size && evaluate_hairpin_alignment(st, local)) {
            const float local_dg = local.dH - st.target_T * local.dS;
            if (!best.valid || local_dg < best_dg) {
                best = local; best.valid = true; best_dg = local_dg;
            }
        }

        // Attach dangling/frayed bases on the open (3') side of the stem
        if (local.lm_t != 0 || local.lm_q != query_len - 1) {
            if (local.lm_t == 0) local.t.push_back(E);
            else { --local.lm_t; local.t.push_back(st.q_at(local.lm_t)); }
            if (local.lm_q == query_len - 1) local.q.push_back(E);
            else { ++local.lm_q; local.q.push_back(st.q_at(local.lm_q)); }
        }

        const size_t align_size = local.q.size();
        if (align_size < 3) continue;

        if (align_size >= min_hairpin_size && evaluate_hairpin_alignment(st, local)) {
            const float local_dg = local.dH - st.target_T * local.dS;
            if (!best.valid || local_dg < best_dg) {
                best = local; best.valid = true; best_dg = local_dg;
            }
        }

        if (align_size <= 3) continue;

        // Try removing an A-T closing pair (penalized) and re-evaluate
        const int last_3 = local.fm_q;
        const int last_5 = local.fm_t;
        const int last_bp = best_pair(st.q_at(last_5), st.q_at(last_3));
        if (last_bp == GC || last_bp == CG) continue;

        ++local.fm_q;
        --local.fm_t;
        local.q.pop_front();
        local.t.pop_front();

        if (evaluate_hairpin_alignment(st, local)) {
            const float local_dg = local.dH - st.target_T * local.dS;
            if (!best.valid || local_dg < best_dg) {
                best = local; best.valid = true; best_dg = local_dg;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Accessors over the completed alignment (reference nuc_cruc_anchor.cpp).

unsigned anchor5_query(const MeltState& st)
{
    const Alignment& al = st.curr;
    const int target_len = (int)st.target.size();
    const int query_len = st.q_len;
    unsigned anchor = 0;
    int query_index = 0;
    int target_index = al.fm_q + al.fm_t;
    if (!al.t.empty() && al.t.front() == E) return anchor;
    if (!al.q.empty() && al.q.front() == E) --target_index;
    if (target_index >= target_len) return anchor;
    while (true) {
        if (query_index >= query_len || target_index < 0) return anchor;
        if (!is_comp_base(st.q_at(query_index), st.t_at(target_index))) return anchor;
        ++anchor; ++query_index; --target_index;
    }
}

unsigned anchor3_query(const MeltState& st)
{
    const Alignment& al = st.curr;
    const int target_len = (int)st.target.size();
    const int query_len = st.q_len;
    unsigned anchor = 0;
    int query_index = query_len - 1;
    int target_index = (al.lm_q + al.lm_t + 1) - query_len;
    if (!al.t.empty() && al.t.back() == E) return anchor;
    if (!al.q.empty() && al.q.back() == E) ++target_index;
    if (target_index >= target_len || target_index < 0) return anchor;
    while (true) {
        if (query_index < 0 || target_index >= target_len) return anchor;
        if (!is_comp_base(st.q_at(query_index), st.t_at(target_index))) return anchor;
        ++anchor; --query_index; ++target_index;
    }
}

unsigned num_gap_of(const Alignment& al)
{
    unsigned n = 0;
    for (uint8_t b : al.q) n += (b == GAP);
    for (uint8_t b : al.t) n += (b == GAP);
    return n;
}

unsigned num_mismatch_of(const Alignment& al, unsigned query_len)
{
    unsigned mm = 0, aligned = 0;
    for (size_t i = 0; i < al.q.size(); ++i) {
        if (!is_virtual(al.q[i])) {
            if (!is_virtual(al.t[i]) && !is_comp_base(al.q[i], al.t[i])) ++mm;
            ++aligned;
        }
    }
    if (query_len < aligned) return mm;  // defensive; reference throws
    return mm + (query_len - aligned);
}

unsigned max_contig_degen_of(const Alignment& al)
{
    unsigned best = 0, run = 0;
    for (uint8_t b : al.t) {
        if (b >= M && b <= N) { ++run; best = std::max(best, run); }
        else run = 0;
    }
    return best;
}

// Alignment rendering (reference nuc_cruc_output.cpp operator<<); the exact
// text is part of the hit-list contract.
const char* BASE_MAP = "ACGTI$-MRSVWYHKDBN";

std::string render_alignment(const MeltState& st, Mode mode)
{
    const Alignment& al = st.curr;
    std::string s;
    if (mode == HAIRPIN) {
        s += "5' ";
        for (auto it = al.t.rbegin(); it != al.t.rend(); ++it) s += BASE_MAP[*it];
        s += "\n   ";
        {
            auto qi = al.q.rbegin();
            auto ti = al.t.rbegin();
            for (; qi != al.q.rend(); ++qi, ++ti)
                s += is_comp_base(*qi, *ti) ? '|' : ' ';
        }
        s += "\n3' ";
        for (auto it = al.q.rbegin(); it != al.q.rend(); ++it) s += BASE_MAP[*it];
    } else {
        // For homodimers the target buffer IS the query (reference
        // tm_dimer(query, query, HOMO_DIMER), nuc_cruc.cpp:2481): resolve
        // target reads against the query's stale-slot buffer.
        const bool homo = (mode == HOMO_DIMER);
        const int query_len = st.q_len;
        const int target_len = homo ? st.q_len : (int)st.target.size();
        auto t_read = [&](int i) -> uint8_t {
            return homo ? st.q_at(i) : st.t_at(i);
        };
        const int prefix_len = std::max(0, std::min(al.fm_q, target_len - 1 - al.fm_t));
        const int suffix_len = std::max(0, std::min(query_len - 1 - al.lm_q, al.lm_t));

        s += "5' ";
        for (int i = 0; i < prefix_len; ++i)
            s += BASE_MAP[st.q_at(al.fm_q - prefix_len + i)];
        for (uint8_t b : al.q) s += BASE_MAP[b];
        for (int i = 0; i < suffix_len; ++i)
            s += BASE_MAP[st.q_at(al.lm_q + 1 + i)];
        s += " 3'\n   ";

        for (int i = 0; i < prefix_len; ++i)
            s += is_comp_base(st.q_at(al.fm_q - prefix_len + i),
                              t_read(al.fm_t + prefix_len - i)) ? ':' : ' ';
        for (size_t i = 0; i < al.q.size(); ++i)
            s += is_comp_base(al.t[i], al.q[i]) ? '|' : ' ';
        for (int i = 0; i < suffix_len; ++i)
            s += is_comp_base(st.q_at(al.lm_q + 1 + i),
                              t_read(al.lm_t - i - 1)) ? ':' : ' ';
        s += "\n3' ";

        for (int i = prefix_len; i > 0; --i) s += BASE_MAP[t_read(al.fm_t + i)];
        for (uint8_t b : al.t) s += BASE_MAP[b];
        for (int i = 1; i <= suffix_len; ++i) s += BASE_MAP[t_read(al.lm_t - i)];
        s += " 5'";
    }
    return s;
}

// ---------------------------------------------------------------------------
// Top-level melt computations (reference approximate_tm_* incl. Dinkelbach).

float tm_dimer(MeltState& st, bool homo, Mode mode)
{
    for (int64_t cell : st.max_cells)
        enumerate_dimer_alignments(st, cell, homo, st.curr, mode);
    return st.curr.tm;
}

float approximate_tm_heterodimer(MeltState& st)
{
    st.mode = HETERO_DIMER;
    if (st.eng->dinkelbach) {
        const float init_T = st.eng->base_T;
        float q = -999999.9f, last_q = q, local_tm = 0.0f;
        Score max_score = 0;
        state_set_temperature(st, NC_ZERO_C);
        do {
            st.curr.clear();
            max_score = align_dimer(st, false);
            local_tm = tm_dimer(st, false, HETERO_DIMER);
            last_q = q;
            q = st.curr.dH - st.target_T * st.curr.dS;
            state_set_temperature(st, NC_ZERO_C + local_tm);
        } while (q < 0.0 && q > last_q);
        state_set_temperature(st, init_T);
        st.curr.dp_dg = -(float)max_score / 10000.0f;
        return local_tm;
    }
    st.curr.clear();
    const Score max_score = align_dimer(st, false);
    const float tm = tm_dimer(st, false, HETERO_DIMER);
    st.curr.dp_dg = -(float)max_score / 10000.0f;
    return tm;
}

float approximate_tm_homodimer(MeltState& st)
{
    st.mode = HOMO_DIMER;
    if (st.eng->dinkelbach) {
        const float init_T = st.eng->base_T;
        float q = -999999.9f, last_q = q, local_tm = 0.0f;
        Score max_score = 0;
        state_set_temperature(st, NC_ZERO_C);
        do {
            st.curr.clear();
            max_score = align_dimer(st, true);
            local_tm = tm_dimer(st, true, HOMO_DIMER);
            last_q = q;
            q = st.curr.dH - st.target_T * st.curr.dS;
            state_set_temperature(st, NC_ZERO_C + local_tm);
        } while (q < 0.0 && q > last_q);
        state_set_temperature(st, init_T);
        st.curr.dp_dg = -(float)max_score / 10000.0f;
        return local_tm;
    }
    st.curr.clear();
    const Score max_score = align_dimer(st, true);
    const float tm = tm_dimer(st, true, HOMO_DIMER);
    st.curr.dp_dg = -(float)max_score / 10000.0f;
    return tm;
}

float approximate_tm_hairpin(MeltState& st)
{
    st.mode = HAIRPIN;
    if (st.eng->dinkelbach) {
        const float init_T = st.eng->base_T;
        float q = -999999.9f, last_q = q, local_tm = 0.0f;
        Score max_score = 0;
        state_set_temperature(st, NC_ZERO_C);
        do {
            st.curr.clear();
            max_score = align_hairpin(st);
            for (int64_t cell : st.max_cells)
                enumerate_hairpin_alignments(st, cell, st.curr);
            local_tm = st.curr.tm;
            last_q = q;
            q = st.curr.dH - st.target_T * st.curr.dS;
            state_set_temperature(st, NC_ZERO_C + local_tm);
        } while (q < 0.0 && q > last_q);
        state_set_temperature(st, init_T);
        st.curr.dp_dg = -(float)max_score / 10000.0f;
        return local_tm;
    }
    st.curr.clear();
    const Score max_score = align_hairpin(st);
    for (int64_t cell : st.max_cells)
        enumerate_hairpin_alignments(st, cell, st.curr);
    st.curr.dp_dg = -(float)max_score / 10000.0f;
    return st.curr.tm;
}

}  // namespace

// ===========================================================================
// C ABI
// ===========================================================================

extern "C" {

void* tnt_engine_create(
    const float* param_H, const float* param_S,
    const float* loop_term_H, const float* loop_term_S,
    const float* hp_term_H, const float* hp_term_S,
    const float* loop_S, const float* bulge_S, const float* hairpin_S,
    const float* special_H, const float* special_S,
    const char* special_seqs,      // 131 x 8 bytes, NUL padded
    const float* supp, const float* supp_salt,
    const float* scalars8,         // initH,initS,atH,atS,symS,salt,asymS,bulgeAtS
    const uint8_t* wc,
    float target_T, float na, int dangle5, int dangle3, int dinkelbach,
    int n_threads)
{
    static bool statics_ready = false;
    if (!statics_ready) {
        init_static_tables();
        init_complement_sets();
        statics_ready = true;
    }

    Engine* e = new Engine();
    Tables& t = e->t;
    std::memcpy(t.param_H, param_H, sizeof(t.param_H));
    std::memcpy(t.param_S, param_S, sizeof(t.param_S));
    std::memcpy(t.loop_term_H, loop_term_H, sizeof(t.loop_term_H));
    std::memcpy(t.loop_term_S, loop_term_S, sizeof(t.loop_term_S));
    std::memcpy(t.hp_term_H, hp_term_H, sizeof(t.hp_term_H));
    std::memcpy(t.hp_term_S, hp_term_S, sizeof(t.hp_term_S));
    std::memcpy(t.loop_S, loop_S, sizeof(t.loop_S));
    std::memcpy(t.bulge_S, bulge_S, sizeof(t.bulge_S));
    std::memcpy(t.hairpin_S, hairpin_S, sizeof(t.hairpin_S));
    std::memcpy(t.special_H, special_H, sizeof(t.special_H));
    std::memcpy(t.special_S, special_S, sizeof(t.special_S));
    std::memcpy(t.special_seq, special_seqs, sizeof(t.special_seq));
    std::memcpy(t.supp, supp, sizeof(t.supp));
    std::memcpy(t.supp_salt, supp_salt, sizeof(t.supp_salt));
    t.init_H = scalars8[0]; t.init_S = scalars8[1];
    t.AT_H = scalars8[2]; t.AT_S = scalars8[3];
    t.sym_S = scalars8[4]; t.SALT = scalars8[5];
    t.asym_S = scalars8[6]; t.bulge_AT_S = scalars8[7];
    std::memcpy(t.wc, wc, sizeof(t.wc));

    e->base_T = target_T;
    e->na = na;
    e->dangle5 = dangle5 != 0;
    e->dangle3 = dangle3 != 0;
    e->dinkelbach = dinkelbach != 0;

    if (n_threads < 1) n_threads = 1;
    for (int i = 0; i < n_threads; ++i) {
        MeltState* st = new MeltState();
        st->eng = e;
        state_set_temperature(*st, e->base_T);
        e->states.push_back(st);
    }
    return e;
}

void tnt_engine_destroy(void* eng) { delete (Engine*)eng; }

// Expose the engine's DP score table for cross-checking against the Python
// thermo module and for building the Pallas kernel inputs.
void tnt_engine_set_screen_slack(void* eng_ptr, float slack)
{
    ((Engine*)eng_ptr)->screen_slack = slack;
}

void tnt_engine_delta_g_screen(void* eng_ptr, float target_T, int32_t* out)
{
    Engine& e = *(Engine*)eng_ptr;
    int dg[NUM_BP * NUM_BP];
    update_dp_param_screen(e, target_T, dg);
    for (int i = 0; i < NUM_BP * NUM_BP; ++i) out[i] = dg[i];
}

void tnt_engine_delta_g(void* eng, float target_T, int32_t* out)
{
    update_dp_param(*(Engine*)eng, target_T, out);
}

// Batch melt evaluation.
//   mode: 0=heterodimer (query vs target window), 1=homodimer, 2=hairpin
//   Sequences are melt-code arrays (A..N as defined above); for heterodimer
//   the target is the engine-facing 5'->3' strand (the caller performs any
//   reverse complementation).
// Returns 0 on success, or the required align-buffer size if it overflowed.
int64_t tnt_eval_batch(
    void* eng_ptr, int mode, int64_t n,
    const uint8_t* q_data, const int64_t* q_off, const int32_t* q_len,
    const uint8_t* t_data, const int64_t* t_off, const int32_t* t_len,
    const float* strand_conc,
    float* tm, float* dH, float* dS, float* dg, float* dp_dg,
    int32_t* anchor5, int32_t* anchor3,
    int32_t* num_mm, int32_t* num_gap, int32_t* max_degen,
    int32_t* q_range, int32_t* t_range,  // n*2 each
    uint8_t* valid,
    char* align_buf, int64_t* align_off, int64_t align_cap,
    int n_threads)
{
    Engine& e = *(Engine*)eng_ptr;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > (int)e.states.size()) n_threads = (int)e.states.size();

    std::vector<std::string> aligns((size_t)n);

    auto worker = [&](int w) {
        MeltState& st = *e.states[w];
        for (int64_t k = w; k < n; k += n_threads) {
            st.set_query(q_data + q_off[k], q_len[k]);
            if (mode == 0) {
                st.target.assign(t_data + t_off[k], t_data + t_off[k] + t_len[k]);
            } else {
                st.target.clear();
            }
            st.strand_conc = strand_conc[k];

            float v_tm;
            Mode md;
            if (mode == 0) { v_tm = approximate_tm_heterodimer(st); md = HETERO_DIMER; }
            else if (mode == 1) { v_tm = approximate_tm_homodimer(st); md = HOMO_DIMER; }
            else { v_tm = approximate_tm_hairpin(st); md = HAIRPIN; }

            tm[k] = v_tm;
            dH[k] = st.curr.dH;
            dS[k] = st.curr.dS;
            dg[k] = st.curr.dH - e.base_T * st.curr.dS;
            dp_dg[k] = st.curr.dp_dg + e.t.init_H - e.base_T * e.t.init_S;
            valid[k] = st.curr.valid ? 1 : 0;
            if (mode == 0) {
                anchor5[k] = (int32_t)anchor5_query(st);
                anchor3[k] = (int32_t)anchor3_query(st);
            } else {
                anchor5[k] = anchor3[k] = 0;
            }
            num_mm[k] = (int32_t)num_mismatch_of(st.curr, (unsigned)st.q_len);
            num_gap[k] = (int32_t)num_gap_of(st.curr);
            max_degen[k] = (int32_t)max_contig_degen_of(st.curr);
            q_range[2 * k] = st.curr.fm_q;
            q_range[2 * k + 1] = st.curr.lm_q;
            t_range[2 * k] = st.curr.lm_t;
            t_range[2 * k + 1] = st.curr.fm_t;
            aligns[k] = render_alignment(st, md);
        }
    };

    if (n_threads == 1) worker(0);
    else {
        std::vector<std::thread> pool;
        for (int w = 0; w < n_threads; ++w) pool.emplace_back(worker, w);
        for (auto& th : pool) th.join();
    }

    // Pack alignment strings
    int64_t pos = 0;
    for (int64_t k = 0; k < n; ++k) {
        align_off[k] = pos;
        pos += (int64_t)aligns[k].size();
    }
    align_off[n] = pos;
    if (pos > align_cap) return pos;  // caller must retry with larger buffer
    for (int64_t k = 0; k < n; ++k)
        std::memcpy(align_buf + align_off[k], aligns[k].data(), aligns[k].size());
    return 0;
}

// Evaluate an explicitly provided alignment (reference tm_from_align /
// tm_pm_duplex): query/target alignment rows as melt codes.
void tnt_eval_alignment(
    void* eng_ptr, int64_t n,
    const uint8_t* q_data, const uint8_t* t_data,
    const int64_t* off, const int32_t* len,
    const float* strand_conc,
    float* tm, float* dH, float* dS, uint8_t* ok)
{
    Engine& e = *(Engine*)eng_ptr;
    MeltState& st = *e.states[0];
    for (int64_t k = 0; k < n; ++k) {
        st.strand_conc = strand_conc[k];
        Alignment al;
        for (int32_t i = 0; i < len[k]; ++i) {
            al.q.push_back(q_data[off[k] + i]);
            al.t.push_back(t_data[off[k] + i]);
        }
        const bool good = evaluate_alignment(st, al, HETERO_DIMER);
        ok[k] = good ? 1 : 0;
        tm[k] = al.tm;
        dH[k] = al.dH;
        dS[k] = al.dS;
    }
}

}  // extern "C"
