// The kept-seed compaction of the device seed+screen step, as two launches
// of hand-written kernels for the Hopper SM (sm_90a): from the pooled
// stream's screening scores and routing, the keep flags, the first bkcap
// kept entries in stream order with their gathers and representative word
// index, and the step's header and kept block.
//
// Replaces no Pallas kernel.  In the JAX package this stage is the keep
// flags of run_chunk (tntblast_tpu/parallel/device_search.py:727-731) and
// the kept-seed compaction, kmin and header of panel_step_core (:854-884),
// fused by XLA inside the jitted step.  Its plain PyTorch version
// (ops/kept.py::kept_reference) is a cumsum and a scatter compaction, a
// dozen gathers, a (bkcap, max_words) kmin and two concatenations.
//
// What it computes, over the pooled stream of Bp entries (i in stream
// order; num_cond screening conditions; n fragments, num_os slots):
//   keep[i] = (AND over c < num_cond of best[c][i] >= thr[c][s] or
//     thr[c][s] == INT_MIN, s = clamp(slot[i], 0, num_os), or needs_host[i])
//     and ent_valid[i];
//   n_kept = the number of kept entries (may exceed bkcap);
//   the first bkcap kept entries in stream order (jnp.nonzero(keep,
//     size=bkcap)), and for each at place j of the kept block (9, bkcap):
//     row 0 order[i], 1 slot[i], 2 p[i], 3 kmin, the smallest k < max_words
//     with p + k in [0, nw_pos), word_valid and ow[slot][k] >= 0 and word ==
//     ow[slot][k] at fragment frag[i]'s position p + k, or max_words; rows
//     4-8 the evaluator's five words ev[i] (zeros without the evaluator);
//     zeros from n_kept to bkcap;
//   header = [n_kept, overflow | input_over (n), zeros (num_os), n_cand (n),
//     counts (n x num_os)].
// best is (rows, Bp), rows >= num_cond; only its first num_cond rows are
// read.
//
// The pooled prefix.  Only the first n_pool = sum of clamp(n_cand, 0, cap)
// entries (cap = Bp / n) can be valid: the pool puts every fragment's
// candidates first and keys the rest num_os, which the decode marks
// invalid (the JAX step's ent_valid = slot < num_os, :629).  So n_kept <=
// n_pool, every block reads n_cand and computes n_pool, and nothing past the
// prefix is read.
//
// The two launches (KEPT_THREADS threads a block):
//  1. head: one block writes the header (n_kept as 0, which launch 2
//     overwrites when the pool is not empty) and resets what launch 2 reads
//     before writing (its tile counter and its tiles' look-back status
//     words), so that every call, and every replay of a CUDA graph of one,
//     starts from zero.  (The look-back state lives in the call's scratch,
//     which another graph of the card's graph pool may overwrite between
//     replays: it cannot carry from one call to the next.)
//  2. kept: the blocks take tickets from the tile counter: the first
//     `tiles` tickets are the stream's tiles of KEPT_TILE entries in order,
//     the rest fill tiles.  A tile at or past the pooled prefix exits (no
//     tile reads its status word).  A tile's threads read its pooled entries
//     strided (entry x = k * KEPT_THREADS + t in round k, coalesced; every
//     load of a round that needs no other load issued together) and leave
//     the keep flags, slots, p and fragments in shared memory; a warp's
//     round is a group of 32 entries whose flags one ballot gathers.  The
//     first warp scans the groups' popcounts and publishes the tile's count
//     at once, before anything else (one phase a link of the look-back
//     chain: every later tile can sum it).  Then each thread finds kmin for
//     its kept entries, all of them at once: KMIN_BATCH word indices (ow,
//     word, word_valid) of every entry still without a match a round, their
//     loads issued together, so that a round costs one latency however
//     many of the thread's entries are kept.  (Two warp forms, 32 lanes
//     or a segment of 8 lanes an entry with one ballot a load, measured
//     slower: a warp works through its kept entries a few at a time;
//     tools/compact_steps.py keeps them as design steps.)  Tiles of 1024
//     entries spread the bench step's 97225 pooled entries over 95 blocks.
//     The first warp then places the tile in the kept block by a
//     single-pass decoupled look-back over the earlier tiles (status words
//     holding state and count in one 64-bit word; a tile waits only on
//     tiles of lower tickets, which started before it and never wait on
//     it) and publishes its inclusive count; the last pooled tile writes
//     n_kept.  Each thread issues its kept entries' gathers (order, the
//     evaluator's words) before the barrier that hands on the place, then
//     stores their nine rows below bkcap: the kept lanes of a group store
//     consecutive places.
//     A fill tile zeroes KEPT_FILL places of the nine rows: those at or
//     past n_pool at once (no entry there can be kept), those in [n_kept,
//     n_pool) once the last pooled tile's inclusive count is out; it exits
//     as soon as any tile's published inclusive count covers its range.
// Integer arithmetic throughout: the kernel equals the plain version bit for
// bit by construction.
//
// What the kernel relies on.  ent_valid is false past n_pool and a kept
// entry (ent_valid) has a slot in [0, num_os) and a fragment in [0, n), as
// the pool and the decode give them; Bp = n * cap; num_os <= 64 (the
// panel's groups hold 64 slots at most).  The scratch needs no initial
// value: launch 1 resets what launch 2 reads.
//
// What bounds it on the H100: bytes.  A bench step (Bp 360448, 97225
// pooled, 2 conditions, bkcap 270336) reads the pooled entries' validity,
// routing, slots and scores, the kept entries' order, p, frag, ev and
// words, and writes the 9.7 MB kept block: about 15 MB, 4.5 us at 3.35e12
// B/s.  What holds it above that is latency: a few dependent phases a tile
// over one wave of blocks.
//
// The host build (-DKEPT_HOST, tests/test_torch_kept.py, g++ behind
// tests/cuda_host_shim/cuda_runtime.h): launch 2 block by block, so the
// tiles run in ticket order and a look-back never waits (one that would is
// a fault the launch returns); odd tiles but the last pooled one keep their
// own counts in their status words, so that later look-backs sum counts
// back to an inclusive word, as on the card.  A block's threads run phase
// by phase through the thread loops below, which run over one thread on
// the card (BLOCK_THREADS); a warp's phase runs once a warp (WARP_LANES),
// and its ballot, scans, the look-back and the fill's wait have host forms
// that compute the same values from shared memory.  A thread's gathers and
// stores are one thread loop with the barrier between them: the place
// they wait for comes from an earlier phase, so on the host the barrier
// has nothing to wait for.

#include <cuda_runtime.h>
#include <stdint.h>

#define KEPT_THREADS 256
#define KEPT_WARPS (KEPT_THREADS / 32)
#define KEPT_ITEMS 4                            // entries a thread
#define KEPT_TILE (KEPT_THREADS * KEPT_ITEMS)   // entries a tile
#define KEPT_GROUPS (KEPT_TILE / 32)            // a warp's rounds, 32 entries
#define KEPT_GPL ((KEPT_GROUPS + 31) / 32)      // groups a lane scans
#define KEPT_FILL 4096                          // places a fill tile zeroes
#define KEPT_ROWS 9                             // rows of the kept block
#define EV_WORDS 5                              // the evaluator's words
#define KMIN_BATCH 8                            // word indices an entry
                                                // loads at once
#define MAX_SLOTS 64                            // ops/kept.py MAX_SLOTS
#define THR_OFF (-2147483647)                   // device_search.INT_MIN

// A tile's look-back status: state in bits 62-63 (0 not yet, 1 its own
// count, 2 every count up to it), the count below.
#define ST_AGGREGATE (1ull << 62)
#define ST_INCLUSIVE (2ull << 62)
#define ST_COUNT (ST_AGGREGATE - 1)

struct KeptArgs {
    const int* best;                    // (rows, Bp)
    const int *slot, *p, *frag, *order; // (Bp,)
    const uint8_t *needs_host, *ent_valid;
    const int* ev;                      // (Bp, 5), or null
    const int* word;                    // (n * nw_pos,)
    const uint8_t* word_valid;
    const int* ow;                      // (num_os, max_words)
    const int* thr;                     // (num_cond, num_os + 1)
    const uint8_t *overflow, *input_over;   // (n,)
    const int *n_cand, *counts;         // (n,), (n, num_os)
    int* header;
    int* block;                         // (9, bkcap)
    unsigned long long* status;         // scratch: a tile's look-back word
    unsigned* ticket;                   // scratch: the tile counter
    int Bp, n, cap, num_os, num_cond, max_words, nw_pos, bkcap;
    int tiles, fills;
};

// Launch 2's block.  Entry x = k * KEPT_THREADS + t of a tile is entry x
// of the tile in stream order; group g = x / 32 is warp g % KEPT_WARPS's
// round g / KEPT_WARPS.
struct KeptShared {
    uint8_t flag[KEPT_TILE];            // keep flags
    int sl[KEPT_TILE], p[KEPT_TILE], f[KEPT_TILE];  // 0 past the pool
    int kmin[KEPT_TILE];                // of the kept entries
    unsigned mask[KEPT_GROUPS];         // a group's keep flags by lane
    int pre[KEPT_GROUPS];               // kept entries before the group
    int tile, n_pool, total;
    long long excl;                     // kept entries before the tile; a
                                        // fill tile's first place to zero
};

__host__ __device__ __forceinline__ int clampi(int x, int lo, int hi)
{
    return min(max(x, lo), hi);
}

#ifdef KEPT_HOST
#define BLOCK_THREADS KEPT_THREADS      // the host thread plays every thread
#define WARP_LANES 1                    // and a warp's phase once a warp
#define THREAD(i) (i)

static void status_store(unsigned long long* at, unsigned long long v)
{
    *at = v;
}

// A status word once its tile has published state `ready` or later.
// Played in ticket order, every earlier tile has published: a word that
// is not ready is a fault the launch returns.
static unsigned long long status_wait(const unsigned long long* at,
                                      unsigned ready)
{
    const unsigned long long v = *at;
    if ((unsigned)(v >> 62) < ready) host_fault = cudaErrorLaunchFailure;
    return v;
}

// Tile j's inclusive count into its status word; played in ticket order,
// odd tiles but the last pooled one keep their own counts (see the file's
// head).
static void publish_inclusive(const KeptArgs& a, int j, int last,
                              unsigned long long incl)
{
    if (j % 2 == 0 || j == last)
        status_store(a.status + j, ST_INCLUSIVE | incl);
}

// The sum of the earlier tiles' counts back to the first inclusive one.
static long long lookback(const KeptArgs& a, int j)
{
    long long prior = 0;
    for (int k = j - 1; k >= 0; --k) {
        const unsigned long long v = status_wait(a.status + k, 1);
        prior += (long long)(v & ST_COUNT);
        if ((v >> 62) == 2) break;
    }
    return prior;
}

// The pooled entries: sum of clamp(n_cand, 0, cap).
static int pooled_entries(const KeptArgs& a)
{
    int c = 0;
    for (int f = 0; f < a.n; ++f) c += clampi(a.n_cand[f], 0, a.cap);
    return c;
}

// The keep flags of group x / 32 as a warp's ballot would gather them.
static unsigned group_mask(const KeptShared& s, int x)
{
    unsigned m = 0;
    for (int l = 0; l < 32; ++l)
        m |= (unsigned)(s.flag[(x & ~31) + l] != 0) << l;
    return m;
}

// The groups' exclusive prefix of kept entries into s.pre, their sum into
// s.total.
static void scan_groups(KeptShared& s)
{
    int sum = 0;
    for (int g = 0; g < KEPT_GROUPS; ++g) {
        s.pre[g] = sum;
        sum += __popc(s.mask[g]);
    }
    s.total = sum;
}

// The last pooled tile's inclusive count (n_kept): played in ticket order,
// it has published.
static long long fill_wait(const KeptArgs& a, int last, long long hi)
{
    (void)hi;
    return (long long)(status_wait(a.status + last, 2) & ST_COUNT);
}
#else
#define BLOCK_THREADS 1                 // a thread plays itself
#define WARP_LANES 32                   // a warp's phase on its 32 lanes
#define THREAD(i) ((int)threadIdx.x)

// A status word carries all a tile hands on (state and count in one
// 64-bit word, read and written whole), so relaxed loads and stores at the
// card's scope order enough.
__device__ __forceinline__ unsigned long long status_load(
    const unsigned long long* at)
{
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(at));
    return v;
}

__device__ __forceinline__ void status_store(unsigned long long* at,
                                             unsigned long long v)
{
    asm volatile("st.relaxed.gpu.u64 [%0], %1;" :: "l"(at), "l"(v));
}

// A status word once its tile has published state `ready` or later (1:
// its own count, 2: its inclusive count); spins.
__device__ __forceinline__ unsigned long long status_wait(
    const unsigned long long* at, unsigned ready)
{
    unsigned long long v = status_load(at);
    while ((unsigned)(v >> 62) < ready) v = status_load(at);
    return v;
}

__device__ __forceinline__ void publish_inclusive(const KeptArgs& a, int j,
                                                  int last,
                                                  unsigned long long incl)
{
    (void)last;
    status_store(a.status + j, ST_INCLUSIVE | incl);
}

// Tile j's look-back by the lanes of one warp: reads the 32 earlier
// tiles' words at once, each lane waiting for its own, and sums them back
// to the nearest inclusive one (before tile 0, an inclusive 0), 32 more at
// a time until it finds one; returns that sum.
__device__ long long lookback(const KeptArgs& a, int j)
{
    const int lane = (int)threadIdx.x & 31;
    long long prior = 0;
    for (int end = j;; end -= 32) {
        const int k = end - 1 - lane;
        const unsigned long long v =
            k >= 0 ? status_wait(a.status + k, 1) : ST_INCLUSIVE;
        const unsigned incl = __ballot_sync(0xffffffffu, (v >> 62) == 2);
        const int near = incl != 0 ? __ffs((int)incl) - 1 : 31;
        long long c = lane <= near ? (long long)(v & ST_COUNT) : 0;
        for (int d = 16; d > 0; d >>= 1)
            c += __shfl_xor_sync(0xffffffffu, c, d);
        prior += c;
        if (incl != 0) return prior;
    }
}

// The pooled entries, by the lanes of one warp.
__device__ int pooled_entries(const KeptArgs& a)
{
    int c = 0;
    for (int f = (int)threadIdx.x & 31; f < a.n; f += 32)
        c += clampi(a.n_cand[f], 0, a.cap);
    for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(0xffffffffu, c, d);
    return c;
}

__device__ __forceinline__ unsigned group_mask(const KeptShared& s, int x)
{
    return __ballot_sync(0xffffffffu, s.flag[x] != 0);
}

// The groups' exclusive prefix into s.pre and their sum into s.total, by
// the lanes of one warp (KEPT_GPL consecutive groups a lane, a shuffle
// scan over the lanes).
__device__ void scan_groups(KeptShared& s)
{
    const int lane = (int)threadIdx.x & 31;
    int c[KEPT_GPL], sum = 0;
#pragma unroll
    for (int i = 0; i < KEPT_GPL; ++i) {
        const int g = lane * KEPT_GPL + i;
        c[i] = g < KEPT_GROUPS ? __popc(s.mask[g]) : 0;
        sum += c[i];
    }
    int x = sum;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    int run = x - sum;
#pragma unroll
    for (int i = 0; i < KEPT_GPL; ++i) {
        const int g = lane * KEPT_GPL + i;
        if (g < KEPT_GROUPS) s.pre[g] = run;
        run += c[i];
    }
    if (lane == 31) s.total = x;
    __syncwarp();
}

// A fill tile's wait, by the lanes of one warp: the last pooled tile's
// inclusive count (n_kept), or `hi` as soon as any of the 32 last pooled
// tiles has published an inclusive count of hi or more (every place below
// hi is then a kept entry's).
__device__ long long fill_wait(const KeptArgs& a, int last, long long hi)
{
    const int k = last - ((int)threadIdx.x & 31);
    for (;;) {
        const unsigned long long v = k >= 0 ? status_load(a.status + k) : 0;
        const bool incl = (v >> 62) == 2;
        const unsigned got = __ballot_sync(0xffffffffu, incl);
        if (got & 1u)
            return (long long)(__shfl_sync(0xffffffffu, v, 0) & ST_COUNT);
        if (__ballot_sync(0xffffffffu,
                          incl && (long long)(v & ST_COUNT) >= hi) != 0)
            return hi;
        __nanosleep(64);
    }
}
#endif

// ---- launch 1: the header and the look-back's reset ------------------------

__device__ void head_block(const KeptArgs& a)
{
    int* h = a.header + 1;
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int x = t; x < a.n; x += KEPT_THREADS) {
            h[x] = (a.overflow[x] | a.input_over[x]) != 0;
            h[a.n + a.num_os + x] = a.n_cand[x];
        }
        for (int x = t; x < a.num_os; x += KEPT_THREADS) h[a.n + x] = 0;
        for (int x = t; x < a.n * a.num_os; x += KEPT_THREADS)
            h[2 * a.n + a.num_os + x] = a.counts[x];
        for (int x = t; x < a.tiles; x += KEPT_THREADS) a.status[x] = 0;
        if (t == 0) {
            *a.ticket = 0;
            a.header[0] = 0;
        }
    }
}

// ---- launch 2: the kept entries --------------------------------------------

// The keep flags of a thread's KEPT_ITEMS entries of tile base `base`
// (entry x = k * KEPT_THREADS + t in round k), and their slots, p and
// fragments, into shared memory.  Past the pool nothing is read.  Every
// load that needs no other is issued for all rounds together (validity,
// routing, slot, p, fragment and the first condition's score), then each
// condition's thresholds and the next scores: a thread waits a few load
// latencies, not a chain of them a round.
__device__ __forceinline__ void keep_flags(const KeptArgs& a, KeptShared& s,
                                           int base, int t)
{
    int e[KEPT_ITEMS], sl[KEPT_ITEMS], sc[KEPT_ITEMS], p[KEPT_ITEMS];
    int f[KEPT_ITEMS];
    bool in[KEPT_ITEMS], ok[KEPT_ITEMS], nh[KEPT_ITEMS], pass[KEPT_ITEMS];
#pragma unroll
    for (int k = 0; k < KEPT_ITEMS; ++k) {
        e[k] = base + k * KEPT_THREADS + t;
        in[k] = e[k] < s.n_pool;
        ok[k] = in[k] && a.ent_valid[e[k]] != 0;
        nh[k] = in[k] && a.needs_host[e[k]] != 0;
        sl[k] = in[k] ? a.slot[e[k]] : 0;
        p[k] = in[k] ? a.p[e[k]] : 0;
        f[k] = in[k] ? a.frag[e[k]] : 0;
        sc[k] = in[k] ? a.best[e[k]] : 0;
        pass[k] = true;
    }
    for (int c = 0; c < a.num_cond; ++c) {
        int th[KEPT_ITEMS], nxt[KEPT_ITEMS];
#pragma unroll
        for (int k = 0; k < KEPT_ITEMS; ++k) {
            th[k] = a.thr[c * (a.num_os + 1) + clampi(sl[k], 0, a.num_os)];
            nxt[k] = in[k] && c + 1 < a.num_cond
                ? a.best[(size_t)(c + 1) * a.Bp + e[k]] : 0;
        }
#pragma unroll
        for (int k = 0; k < KEPT_ITEMS; ++k) {
            pass[k] = pass[k] && (th[k] == THR_OFF || sc[k] >= th[k]);
            sc[k] = nxt[k];
        }
    }
#pragma unroll
    for (int k = 0; k < KEPT_ITEMS; ++k) {
        const int x = k * KEPT_THREADS + t;
        s.flag[x] = ok[k] && (nh[k] || pass[k]);
        s.sl[x] = sl[k];
        s.p[x] = p[k];
        s.f[x] = f[k];
    }
}

// kmin of thread t's kept entries (x = k * KEPT_THREADS + t) into
// s.kmin, all of them at once: KMIN_BATCH word indices of every entry
// still without a match a round, the loads of all of them issued together
// (each clamped into its row, so that none waits on a test), so that a
// round costs one load's latency whatever the thread's count of kept
// entries.
__device__ __forceinline__ void kmin_rows(const KeptArgs& a, KeptShared& s,
                                          int t)
{
    const int* ow[KEPT_ITEMS];
    size_t row[KEPT_ITEMS];
    int p[KEPT_ITEMS], km[KEPT_ITEMS];
    bool kept[KEPT_ITEMS], open[KEPT_ITEMS];
#pragma unroll
    for (int k = 0; k < KEPT_ITEMS; ++k) {
        const int x = k * KEPT_THREADS + t;
        kept[k] = open[k] = s.flag[x] != 0;
        km[k] = a.max_words;
        p[k] = s.p[x];
        row[k] = (size_t)s.f[x] * a.nw_pos;
        ow[k] = a.ow + (size_t)clampi(s.sl[x], 0, a.num_os - 1)
            * a.max_words;
    }
    for (int k0 = 0; k0 < a.max_words; k0 += KMIN_BATCH) {
        bool more = false;
#pragma unroll
        for (int k = 0; k < KEPT_ITEMS; ++k) more = more || open[k];
        if (!more) break;
        int o[KEPT_ITEMS][KMIN_BATCH], w[KEPT_ITEMS][KMIN_BATCH];
        uint8_t v[KEPT_ITEMS][KMIN_BATCH];
#pragma unroll
        for (int k = 0; k < KEPT_ITEMS; ++k)
#pragma unroll
            for (int u = 0; u < KMIN_BATCH; ++u) {
                const size_t q = row[k]
                    + clampi(p[k] + k0 + u, 0, a.nw_pos - 1);
                o[k][u] = open[k] ? ow[k][min(k0 + u, a.max_words - 1)] : -1;
                w[k][u] = open[k] ? a.word[q] : 0;
                v[k][u] = open[k] ? a.word_valid[q] : 0;
            }
#pragma unroll
        for (int k = 0; k < KEPT_ITEMS; ++k)
#pragma unroll
            for (int u = 0; u < KMIN_BATCH; ++u) {
                const int kk = k0 + u, q = p[k] + kk;
                if (open[k] && kk < a.max_words && q >= 0 && q < a.nw_pos
                    && o[k][u] >= 0 && v[k][u] != 0 && w[k][u] == o[k][u]) {
                    km[k] = kk;
                    open[k] = false;
                }
            }
    }
    // the flags held from the start, not s.flag read again: g++ 12.2 at
    // -O1 and -O2 dropped the stores of that form in the host build
#pragma unroll
    for (int k = 0; k < KEPT_ITEMS; ++k)
        if (kept[k]) s.kmin[k * KEPT_THREADS + t] = km[k];
}

// The places KEPT_ROWS rows of the kept block hold from lo to hi, zeroed
// by thread t's share.
__device__ __forceinline__ void zero_places(const KeptArgs& a, long long lo,
                                            long long hi, int t)
{
    for (int r = 0; r < KEPT_ROWS; ++r)
        for (long long j = lo + t; j < hi; j += KEPT_THREADS)
            a.block[(size_t)r * a.bkcap + j] = 0;
}

// Fill tile q: places [q * KEPT_FILL, +KEPT_FILL) below bkcap, from n_kept
// on.  Those at or past the pool first, with no wait.
__device__ void fill_tile(const KeptArgs& a, KeptShared& s, int q)
{
    const long long lo = (long long)q * KEPT_FILL;
    const long long hi = min(lo + KEPT_FILL, (long long)a.bkcap);
    const long long np = s.n_pool;
    for (int i = 0; i < BLOCK_THREADS; ++i)
        zero_places(a, max(lo, np), hi, THREAD(i));
    if (lo >= min(np, hi)) return;
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t < WARP_LANES) {
            const long long nk = fill_wait(a, (int)((np - 1) / KEPT_TILE),
                                           hi);
            if (t == 0) s.excl = nk;
        }
    }
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i)
        zero_places(a, max(lo, s.excl), min(hi, np), THREAD(i));
}

// Thread t's kept entries of the tile: their gathers (order and the
// evaluator's words, the loads in flight together), then, past the
// barrier that hands on the tile's place, their nine rows below bkcap.
__device__ __forceinline__ void kept_rows(const KeptArgs& a, KeptShared& s,
                                          int base, int t)
{
    int order[KEPT_ITEMS], ev[KEPT_ITEMS][EV_WORDS];
#pragma unroll
    for (int k = 0; k < KEPT_ITEMS; ++k) {
        const int x = k * KEPT_THREADS + t;
        const bool kept = s.flag[x] != 0;
        order[k] = kept ? a.order[base + x] : 0;
#pragma unroll
        for (int w = 0; w < EV_WORDS; ++w)
            ev[k][w] = kept && a.ev != nullptr
                ? a.ev[(size_t)(base + x) * EV_WORDS + w] : 0;
    }
    __syncthreads();
    const size_t row = a.bkcap;
#pragma unroll
    for (int k = 0; k < KEPT_ITEMS; ++k) {
        const int x = k * KEPT_THREADS + t, g = x / 32;
        if (s.flag[x] == 0) continue;
        const long long at = s.excl + s.pre[g]
            + __popc(s.mask[g] & ((1u << (x & 31)) - 1u));
        if (at >= a.bkcap) continue;
        int* out = a.block + at;
        out[0] = order[k];
        out[row] = s.sl[x];
        out[2 * row] = s.p[x];
        out[3 * row] = s.kmin[x];
#pragma unroll
        for (int w = 0; w < EV_WORDS; ++w) out[(4 + w) * row] = ev[k][w];
    }
}

__device__ void kept_tile(const KeptArgs& a, KeptShared& s, int j)
{
    const int base = j * KEPT_TILE;
    const int last = (s.n_pool - 1) / KEPT_TILE;     // the last pooled tile
    for (int i = 0; i < BLOCK_THREADS; ++i) keep_flags(a, s, base, THREAD(i));
    __syncthreads();
    // each group's flags by one ballot
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int k = 0; k < KEPT_ITEMS; ++k) {
            const int x = k * KEPT_THREADS + t;
            const unsigned m = group_mask(s, x);
            if ((x & 31) == 0) s.mask[x / 32] = m;
        }
    }
    __syncthreads();
    // the first warp: the groups' prefix, the tile's count published
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t < WARP_LANES) {
            scan_groups(s);
            if (t == 0)
                status_store(a.status + j, (j == 0 ? ST_INCLUSIVE
                                                   : ST_AGGREGATE)
                                               | (unsigned long long)s.total);
        }
    }
    // every thread: kmin of its kept entries
    for (int i = 0; i < BLOCK_THREADS; ++i) kmin_rows(a, s, THREAD(i));
    // the first warp: the tile's place, its inclusive count, n_kept
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t < WARP_LANES) {
            const long long excl = j == 0 ? 0 : lookback(a, j);
            if (t == 0) {
                s.excl = excl;
                if (j > 0)
                    publish_inclusive(a, j, last, (unsigned long long)(
                                          excl + s.total));
                if (j == last) a.header[0] = (int)(excl + s.total);
            }
        }
    }
    for (int i = 0; i < BLOCK_THREADS; ++i) kept_rows(a, s, base, THREAD(i));
}

__device__ void kept_block(const KeptArgs& a, KeptShared& s)
{
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t == 0) s.tile = (int)atomicAdd(a.ticket, 1u);
        if (t < WARP_LANES) {
            const int np = pooled_entries(a);
            if (t == 0) s.n_pool = np;
        }
    }
    __syncthreads();
    if (s.tile >= a.tiles)
        fill_tile(a, s, s.tile - a.tiles);
    else if (s.tile * KEPT_TILE < s.n_pool)
        kept_tile(a, s, s.tile);
    // a tile past the pooled prefix: nothing to read, and no tile reads
    // its status word
}

#ifdef KEPT_HOST
// the CPU tests' build: launch 2 block by block
static int run(const KeptArgs& a, int device, void* stream)
{
    (void)device;
    (void)stream;
    static KeptShared s;
    host_fault = 0;
    head_block(a);
    for (int b = 0; b < a.tiles + a.fills && host_fault == 0; ++b)
        kept_block(a, s);
    return host_fault;
}
#else
__global__ void __launch_bounds__(KEPT_THREADS) kept_head_kernel(
    const KeptArgs a)
{
    head_block(a);
}

__global__ void __launch_bounds__(KEPT_THREADS) kept_kernel(const KeptArgs a)
{
    __shared__ KeptShared s;
    kept_block(a, s);
}

// Queues the two launches on `stream` on card `device` (made current for
// the launches and restored); 0 or a CUDA error.
static int run(const KeptArgs& a, int device, void* stream)
{
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    kept_head_kernel<<<1, KEPT_THREADS, 0, st>>>(a);
    int rc = (int)cudaGetLastError();
    if (rc == 0) {
        kept_kernel<<<(unsigned)(a.tiles + a.fills), KEPT_THREADS, 0, st>>>(
            a);
        rc = (int)cudaGetLastError();
    }
    if (cur != device) {
        err = cudaSetDevice(cur);
        if (rc == 0 && err != cudaSuccess) rc = (int)err;
    }
    return rc;
}
#endif

// ---- the C entry points ----------------------------------------------------

// A panel's part of the arguments, checked once: its oligo words and
// thresholds, the static shapes and the card.  The step's call fills in
// the rest.
struct KeptPlan {
    KeptArgs a;
    int device;
};

extern "C" int kept_plan_bytes() { return (int)sizeof(KeptPlan); }

// Fills `plan` (kept_plan_bytes() bytes, 8-byte aligned); 0, or
// cudaErrorInvalidValue where a shape is refused.
extern "C" int kept_plan(void* plan, const void* ow, const void* thr,
                         int num_os, int num_cond, int max_words, int nw_pos,
                         int device)
{
    if (num_os < 1 || num_os > MAX_SLOTS || num_cond < 1 || max_words < 1
        || nw_pos < 1)
        return (int)cudaErrorInvalidValue;
    KeptPlan* pl = (KeptPlan*)plan;
    KeptArgs a = {};
    a.ow = (const int*)ow;
    a.thr = (const int*)thr;
    a.num_os = num_os;
    a.num_cond = num_cond;
    a.max_words = max_words;
    a.nw_pos = nw_pos;
    pl->a = a;
    pl->device = device;
    return 0;
}

// int32 words of scratch a call on a stream of Bp entries needs: a status
// word (two) a tile and the tile counter.
extern "C" long long kept_scratch_words(int Bp)
{
    return 2LL * ((Bp + KEPT_TILE - 1) / KEPT_TILE) + 1;
}

// The step's call: the kept entries of a pooled stream of Bp entries on n
// fragments of Bp / n candidates each, under a plan, on the plan's card,
// on `stream`.  Pointers: best (rows, Bp), rows >= num_cond, slot, p,
// frag, order (Bp,), needs_host, ent_valid (Bp,) bytes, ev (Bp, 5) or
// null, word (n * nw_pos,), word_valid (n * nw_pos,) bytes, overflow,
// input_over (n,) bytes, n_cand (n,), counts (n, num_os); the outputs
// header (1 + 2n + num_os + n * num_os,) and block (9, bkcap);
// kept_scratch_words(Bp) int32 words of scratch (on 8 bytes), any values.
// 0, cudaErrorInvalidValue for a shape outside the kernel's range (Bp not
// a multiple of n among them) or misaligned scratch, or a launch's CUDA
// error.
extern "C" int kept_launch_plan(
    const void* plan, const void* best, const void* slot, const void* p,
    const void* frag, const void* order, const void* needs_host,
    const void* ent_valid, const void* ev, const void* word,
    const void* word_valid, const void* overflow, const void* input_over,
    const void* n_cand, const void* counts, void* header, void* block,
    void* scratch, int Bp, int n, int bkcap, void* stream)
{
    KeptArgs a = ((const KeptPlan*)plan)->a;
    if (Bp < 1 || n < 1 || Bp % n != 0 || bkcap < 1 || bkcap > Bp
        || (uintptr_t)scratch % 8 != 0)
        return (int)cudaErrorInvalidValue;
    a.best = (const int*)best;
    a.slot = (const int*)slot;
    a.p = (const int*)p;
    a.frag = (const int*)frag;
    a.order = (const int*)order;
    a.needs_host = (const uint8_t*)needs_host;
    a.ent_valid = (const uint8_t*)ent_valid;
    a.ev = (const int*)ev;
    a.word = (const int*)word;
    a.word_valid = (const uint8_t*)word_valid;
    a.overflow = (const uint8_t*)overflow;
    a.input_over = (const uint8_t*)input_over;
    a.n_cand = (const int*)n_cand;
    a.counts = (const int*)counts;
    a.header = (int*)header;
    a.block = (int*)block;
    a.Bp = Bp;
    a.n = n;
    a.cap = Bp / n;
    a.bkcap = bkcap;
    a.tiles = (Bp + KEPT_TILE - 1) / KEPT_TILE;
    a.fills = (bkcap + KEPT_FILL - 1) / KEPT_FILL;
    a.status = (unsigned long long*)scratch;
    a.ticket = (unsigned*)(a.status + a.tiles);
    return run(a, ((const KeptPlan*)plan)->device, stream);
}
