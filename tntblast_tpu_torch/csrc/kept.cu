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
// The two launches (KEPT_THREADS threads a block):
//  1. head: one block writes the header but n_kept and resets what launch
//     2 reads before writing (its tile counter and its tiles' look-back
//     status words), so that every call, and every replay of a CUDA graph
//     of one, starts from zero.
//  2. kept: the blocks take tickets from the tile counter: the first
//     `tiles` tickets are the stream's tiles of KEPT_TILE entries in order,
//     the rest fill tiles.  A tile's threads read its entries strided (entry
//     k * KEPT_THREADS + t of the tile in round k, coalesced; each kind of
//     load for all rounds at once) and leave their keep flags in shared
//     memory in stream order; a thread counts its 8
//     consecutive flags, a block scan places them, and the kept entries'
//     offsets in the tile go to a list in stream order.  The tile's place in
//     the kept block comes from a single-pass decoupled look-back over the
//     earlier tiles (status words holding state and count in one 64-bit
//     word; a tile waits only on tiles of lower tickets, which started before
//     it and never wait on it).  Then the block walks its list, a thread an
//     entry, consecutive threads at consecutive places: the gathers (a
//     thread's entries' all at once), kmin's word loads (KMIN_BATCH word
//     indices at a time, their loads in flight together, up to the batch of
//     the first match) and the nine rows, below bkcap.
//     The last tile writes n_kept.  A fill tile zeroes KEPT_FILL places of
//     the nine rows from n_kept on: it waits for the last tile's inclusive
//     count (the last tile took a lower ticket, so it runs).
// Integer arithmetic throughout: the kernel equals the plain version bit for
// bit by construction.
//
// What the kernel relies on.  A kept entry (ent_valid) has a slot in [0,
// num_os) and a fragment in [0, n), as the pool and the decode give them;
// num_os <= 64 (the panel's groups hold 64 slots at most).  The scratch
// needs no initial value: launch 1 resets what launch 2 reads.
//
// What bounds it on the H100: bytes.  A bench step (Bp 360448, 2
// conditions, bkcap 270336) reads best (2.9 MB), slot (1.4 MB), needs_host
// and ent_valid (0.7 MB), the kept entries' order, p, frag, ev and words,
// and writes the 9.7 MB kept block: about 14 MB, 4.2 us at 3.35e12 B/s.
//
// The host build (-DKEPT_HOST, tests/test_torch_kept.py, g++ behind
// tests/cuda_host_shim/cuda_runtime.h): launch 2 block by block, so the
// tiles run in ticket order and a look-back never waits (one that would is
// a fault the launch returns); odd tiles but the last keep their own counts
// in their status words, so that later look-backs sum counts back to an
// inclusive word, as on the card.  A block's threads run phase by phase
// through the thread loops below, which run over one thread on the card
// (BLOCK_THREADS); the block scan and the look-back have host forms.

#include <cuda_runtime.h>
#include <stdint.h>

#define KEPT_THREADS 256
#define KEPT_WARPS (KEPT_THREADS / 32)
#define KEPT_ITEMS 8                            // entries a thread
#define KEPT_TILE (KEPT_THREADS * KEPT_ITEMS)   // entries a tile
#define KEPT_FILL 4096                          // places a fill tile zeroes
#define KEPT_ROWS 9                             // rows of the kept block
#define EV_WORDS 5                              // the evaluator's words
#define KMIN_BATCH 8                            // kmin's loads at once
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
    int Bp, n, num_os, num_cond, max_words, nw_pos, bkcap;
    int tiles, fills;
};

// Launch 2's block.
struct KeptShared {
    uint8_t flag[KEPT_TILE];            // keep flags, stream order
    int list[KEPT_TILE];                // kept offsets in the tile, in order
    int part[KEPT_THREADS];
    int wsum[KEPT_WARPS];
    int tile, total;
    long long excl;                     // kept entries before the tile
};

__host__ __device__ __forceinline__ int clampi(int x, int lo, int hi)
{
    return min(max(x, lo), hi);
}

#ifdef KEPT_HOST
#define BLOCK_THREADS KEPT_THREADS      // the host thread plays every thread
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
// odd tiles but the last keep their own counts (see the file's head).
static void publish_inclusive(const KeptArgs& a, int j,
                              unsigned long long incl)
{
    if (j % 2 == 0 || j == a.tiles - 1)
        status_store(a.status + j, ST_INCLUSIVE | incl);
}

// Tile j's look-back: publishes its own count, then sums the earlier
// tiles' counts back to the first inclusive one; returns that sum.
static long long lookback(const KeptArgs& a, int j, int own)
{
    long long prior = 0;
    if (j == 0) return prior;
    status_store(a.status + j, ST_AGGREGATE | (unsigned long long)own);
    for (int k = j - 1; k >= 0; --k) {
        const unsigned long long v = status_wait(a.status + k, 1);
        prior += (long long)(v & ST_COUNT);
        if ((v >> 62) == 2) break;
    }
    return prior;
}

// Exclusive prefix of s.part over the block's threads, in place; the sum
// into s.total.
static void scan_parts(KeptShared& s)
{
    int sum = 0;
    for (int t = 0; t < KEPT_THREADS; ++t) {
        const int v = s.part[t];
        s.part[t] = sum;
        sum += v;
    }
    s.total = sum;
}
#else
#define BLOCK_THREADS 1                 // a thread plays itself
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
                                                  unsigned long long incl)
{
    status_store(a.status + j, ST_INCLUSIVE | incl);
}

// Tile j's look-back by the lanes of one warp: publishes its own count,
// then reads the 32 earlier tiles' words at once, each lane waiting for
// its own, and sums them back to the nearest inclusive one (before tile 0,
// an inclusive 0), 32 more at a time until it finds one; returns that sum.
__device__ long long lookback(const KeptArgs& a, int j, int own)
{
    const int lane = (int)threadIdx.x & 31;
    long long prior = 0;
    if (j == 0) return prior;
    if (lane == 0)
        status_store(a.status + j, ST_AGGREGATE | (unsigned long long)own);
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

// Exclusive prefix of s.part over the block's threads, in place (a warp
// scan by shuffles, then the warps' sums); the sum into s.total.
__device__ void scan_parts(KeptShared& s)
{
    const int t = (int)threadIdx.x, lane = t & 31, wp = t >> 5;
    const int v = s.part[t];
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) s.wsum[wp] = x;
    __syncthreads();
    if (t < 32) {
        const int ws = t < KEPT_WARPS ? s.wsum[t] : 0;
        int e = ws;
        for (int d = 1; d < KEPT_WARPS; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, e, d);
            if (lane >= d) e += y;
        }
        if (t < KEPT_WARPS) s.wsum[t] = e - ws;
        if (t == KEPT_WARPS - 1) s.total = e;
    }
    __syncthreads();
    s.part[t] = x - v + s.wsum[wp];
    __syncthreads();
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
        if (t == 0) *a.ticket = 0;
    }
}

// ---- launch 2: the kept entries --------------------------------------------

// The keep flags of a thread's KEPT_ITEMS entries of tile base `base`
// (entry base + k * KEPT_THREADS + t in round k) into s.flag.  Each kind
// of load is issued for all the rounds together (validity; then the valid
// entries' routing and slots, predicated; then each condition's scores and
// thresholds), so a thread waits a few load latencies, not a chain of them
// a round.
__device__ __forceinline__ void keep_flags(const KeptArgs& a, KeptShared& s,
                                           int base, int t)
{
    int e[KEPT_ITEMS];
    bool ok[KEPT_ITEMS], nh[KEPT_ITEMS], pass[KEPT_ITEMS];
    int sl[KEPT_ITEMS];
#pragma unroll
    for (int k = 0; k < KEPT_ITEMS; ++k) {
        e[k] = min(base + k * KEPT_THREADS + t, a.Bp - 1);
        ok[k] = base + k * KEPT_THREADS + t < a.Bp && a.ent_valid[e[k]] != 0;
    }
#pragma unroll
    for (int k = 0; k < KEPT_ITEMS; ++k) {
        nh[k] = ok[k] && a.needs_host[e[k]] != 0;
        sl[k] = ok[k] ? clampi(a.slot[e[k]], 0, a.num_os) : 0;
        pass[k] = true;
    }
    for (int c = 0; c < a.num_cond; ++c) {
        int sc[KEPT_ITEMS], th[KEPT_ITEMS];
#pragma unroll
        for (int k = 0; k < KEPT_ITEMS; ++k) {
            sc[k] = ok[k] ? a.best[(size_t)c * a.Bp + e[k]] : 0;
            th[k] = a.thr[c * (a.num_os + 1) + sl[k]];
        }
#pragma unroll
        for (int k = 0; k < KEPT_ITEMS; ++k)
            pass[k] = pass[k] && (th[k] == THR_OFF || sc[k] >= th[k]);
    }
#pragma unroll
    for (int k = 0; k < KEPT_ITEMS; ++k)
        s.flag[k * KEPT_THREADS + t] = ok[k] && (nh[k] || pass[k]);
}

// The smallest word index k of kept entry (slot s, diagonal p, fragment
// f) whose target word matches the oligo's, or max_words.  KMIN_BATCH
// indices at a time, their loads issued together (clamped into the rows,
// so that none waits on a test): a batch costs one load's latency, not
// one a word.
__device__ __forceinline__ int kmin_of(const KeptArgs& a, int s, int p, int f)
{
    const int* ow = a.ow + (size_t)clampi(s, 0, a.num_os - 1) * a.max_words;
    const int* word = a.word + (size_t)f * a.nw_pos;
    const uint8_t* valid = a.word_valid + (size_t)f * a.nw_pos;
    for (int k0 = 0; k0 < a.max_words; k0 += KMIN_BATCH) {
        int o[KMIN_BATCH], w[KMIN_BATCH], v[KMIN_BATCH];
#pragma unroll
        for (int u = 0; u < KMIN_BATCH; ++u) {
            const int q = clampi(p + k0 + u, 0, a.nw_pos - 1);
            o[u] = ow[min(k0 + u, a.max_words - 1)];
            w[u] = word[q];
            v[u] = valid[q];
        }
#pragma unroll
        for (int u = 0; u < KMIN_BATCH; ++u) {
            const int k = k0 + u, q = p + k;
            if (k < a.max_words && q >= 0 && q < a.nw_pos && o[u] >= 0
                && v[u] != 0 && w[u] == o[u])
                return k;
        }
    }
    return a.max_words;
}

__device__ void fill_tile(const KeptArgs& a, KeptShared& s, int q)
{
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t == 0)
            s.excl = (long long)(status_wait(a.status + a.tiles - 1, 2)
                                 & ST_COUNT);
    }
    __syncthreads();
    const long long lo = max((long long)q * KEPT_FILL, s.excl);
    const long long hi = min((long long)(q + 1) * KEPT_FILL,
                             (long long)a.bkcap);
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int r = 0; r < KEPT_ROWS; ++r)
            for (long long j = lo + t; j < hi; j += KEPT_THREADS)
                a.block[(size_t)r * a.bkcap + j] = 0;
    }
}

// The tile's place in the kept block (the look-back, by the first warp on
// the card) into s.excl, its inclusive count published; the last tile
// writes n_kept.
__device__ void place_tile(const KeptArgs& a, KeptShared& s, int j)
{
#ifndef KEPT_HOST
    if (threadIdx.x >= 32) return;
#endif
    const long long excl = lookback(a, j, s.total);
#ifndef KEPT_HOST
    if (threadIdx.x != 0) return;
#endif
    s.excl = excl;
    publish_inclusive(a, j, (unsigned long long)(excl + s.total));
    if (j == a.tiles - 1) a.header[0] = (int)(excl + s.total);
}

// Thread t's kept entries of the tile (places x = t + u * KEPT_THREADS of
// its first m): their gathers first, the loads in flight together (the
// stores after them might alias them for all the compiler knows), then
// each one's kmin and its nine rows.
__device__ __forceinline__ void kept_rows(const KeptArgs& a, KeptShared& s,
                                          int base, int m, int t)
{
    int e[KEPT_ITEMS], order[KEPT_ITEMS], sl[KEPT_ITEMS], p[KEPT_ITEMS];
    int f[KEPT_ITEMS], ev[KEPT_ITEMS][EV_WORDS];
#pragma unroll
    for (int u = 0; u < KEPT_ITEMS; ++u) {
        const bool live = t + u * KEPT_THREADS < m;
        e[u] = live ? base + s.list[t + u * KEPT_THREADS] : 0;
        order[u] = live ? a.order[e[u]] : 0;
        sl[u] = live ? a.slot[e[u]] : 0;
        p[u] = live ? a.p[e[u]] : 0;
        f[u] = live ? a.frag[e[u]] : 0;
#pragma unroll
        for (int w = 0; w < EV_WORDS; ++w)
            ev[u][w] = live && a.ev != nullptr
                ? a.ev[(size_t)e[u] * EV_WORDS + w] : 0;
    }
    const size_t row = a.bkcap;
#pragma unroll
    for (int u = 0; u < KEPT_ITEMS; ++u) {
        if (t + u * KEPT_THREADS >= m) break;
        int* out = a.block + (s.excl + t + u * KEPT_THREADS);
        out[0] = order[u];
        out[row] = sl[u];
        out[2 * row] = p[u];
        out[3 * row] = kmin_of(a, sl[u], p[u], f[u]);
#pragma unroll
        for (int w = 0; w < EV_WORDS; ++w) out[(4 + w) * row] = ev[u][w];
    }
}

__device__ void kept_tile(const KeptArgs& a, KeptShared& s, int j)
{
    const int base = j * KEPT_TILE;
    // the tile's keep flags, read strided, left in stream order
    for (int i = 0; i < BLOCK_THREADS; ++i) keep_flags(a, s, base, THREAD(i));
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        int c = 0;
        for (int k = 0; k < KEPT_ITEMS; ++k) c += s.flag[t * KEPT_ITEMS + k];
        s.part[t] = c;
    }
    __syncthreads();
    scan_parts(s);
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        int at = s.part[t];
        for (int k = 0; k < KEPT_ITEMS; ++k)
            if (s.flag[t * KEPT_ITEMS + k]) s.list[at++] = t * KEPT_ITEMS + k;
    }
    place_tile(a, s, j);
    __syncthreads();
    // the kept entries, a thread an entry, below bkcap
    const long long room = a.bkcap - s.excl;
    const int m = (int)min((long long)s.total, max(room, 0ll));
    for (int i = 0; i < BLOCK_THREADS; ++i)
        kept_rows(a, s, base, m, THREAD(i));
}

__device__ void kept_block(const KeptArgs& a, KeptShared& s)
{
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t == 0) s.tile = (int)atomicAdd(a.ticket, 1u);
    }
    __syncthreads();
    if (s.tile < a.tiles)
        kept_tile(a, s, s.tile);
    else
        fill_tile(a, s, s.tile - a.tiles);
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
// fragments, under a plan, on the plan's card, on `stream`.  Pointers: best
// (rows, Bp), rows >= num_cond, slot, p, frag, order (Bp,), needs_host,
// ent_valid (Bp,) bytes, ev (Bp, 5) or null, word (n * nw_pos,),
// word_valid (n * nw_pos,) bytes, overflow, input_over (n,) bytes, n_cand
// (n,), counts (n, num_os); the outputs header (1 + 2n +
// num_os + n * num_os,) and block (9, bkcap); kept_scratch_words(Bp) int32
// words of scratch (on 8 bytes), any values.  0, cudaErrorInvalidValue for
// a shape outside the kernel's range or misaligned scratch, or a launch's
// CUDA error.
extern "C" int kept_launch_plan(
    const void* plan, const void* best, const void* slot, const void* p,
    const void* frag, const void* order, const void* needs_host,
    const void* ent_valid, const void* ev, const void* word,
    const void* word_valid, const void* overflow, const void* input_over,
    const void* n_cand, const void* counts, void* header, void* block,
    void* scratch, int Bp, int n, int bkcap, void* stream)
{
    KeptArgs a = ((const KeptPlan*)plan)->a;
    if (Bp < 1 || n < 1 || bkcap < 1 || bkcap > Bp
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
    a.bkcap = bkcap;
    a.tiles = (Bp + KEPT_TILE - 1) / KEPT_TILE;
    a.fills = (bkcap + KEPT_FILL - 1) / KEPT_FILL;
    a.status = (unsigned long long*)scratch;
    a.ticket = (unsigned*)(a.status + a.tiles);
    return run(a, ((const KeptPlan*)plan)->device, stream);
}
