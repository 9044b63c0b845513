// The pooled candidate stream of the device seed+screen step, as three
// launches of hand-written kernels for the Hopper SM (sm_90a): every
// fragment's seed candidates in one slot-major stream, without a sort.
//
// Replaces no Pallas kernel.  In the JAX package this stage is the stable
// argsort by slot and its gathers in panel_step_core
// (tntblast_tpu/parallel/device_search.py:468-492), fused by XLA inside the
// jitted step.  Its plain PyTorch version (ops/pool.py::pool_reference) is a
// stable torch.sort of n x cap keys and four gathers.
//
// What it computes, for n fragments of cap candidates each (Bp = n * cap
// entries, entry f * cap + r is rank r of fragment f):
//   valid[f * cap + r] = r < clamp(n_cand[f], 0, cap) (n_cand is the true
//     count, which may exceed cap: the seed stage truncates at cap);
//   key = slot of a valid entry, num_os of an invalid one;
//   the entries in the order of a stable sort by key: the valid entries
//     slot-major, fragment-major within a slot, rank order within a
//     (fragment, slot); then the invalid tail (key num_os) in index order;
//   slot_str, p_str, frag_str, order_str: each entry's key, p, fragment and
//     index at its place in that order.
// A counting sort does it:
//  1. count: grid (tiles of POOL_TILE ranks, n).  A block counts its
//     tile's valid entries by slot (shared atomics) and writes the counts
//     into hist, laid out (slot, fragment, tile): the order of the pool.
//  2. scan: one block of POOL_SCAN_THREADS threads turns hist into its
//     exclusive prefix in that order (a thread sums a run, POOL_SCAN_BATCH
//     loads in flight at once, a block scan of the runs' sums, a thread
//     rewrites its run), and writes the number of valid entries, n_pool.
//     hist[s][f][j] is then the place of the first entry of slot s in tile
//     j of fragment f.
//  3. scatter: grid as in 1.  Rank r = j * POOL_TILE + k * POOL_THREADS +
//     t (round k, thread t), so that the 32 lanes of a warp in one round
//     hold 32 consecutive ranks, a group, and the tile's 64 groups come in
//     rank order.  In a group the lanes holding one key find each other
//     (match_any): an entry's rank among its key's lanes below it, and the
//     key's count in the group from its lowest lane.  A scan over the
//     groups for each slot (four segments of 16 groups a slot, 256
//     threads) starts at the slot's hist and gives each (group, slot) its
//     first place; an entry's place is that plus its rank in the group.
//     An invalid entry's place is closed: n_pool, the invalid entries of
//     the fragments before it (cap - clamp(n_cand, 0, cap) each) and its
//     rank past n_cand.  Every entry writes its four values at its place
//     and its valid flag at its index.
// Integer arithmetic throughout: the kernel equals the plain version bit for
// bit by construction.
//
// What the kernel relies on.  The seed stage's contract: a valid entry's
// slot lies in [0, num_os) (a slot outside would address past the counts),
// num_os <= MAX_SLOTS (the panel's groups hold 64 slots at most).  Scratch
// needs no initial value: launch 1 writes every count launch 2 reads, and
// launch 2 every prefix and n_pool launch 3 reads, so a CUDA graph's
// replays need no reset between them.
//
// What bounds it on the H100: bytes.  A bench step (8 fragments, cap 45056,
// Bp 360448) reads slot and p (2.9 MB; launch 3 reads slot again from L2)
// and writes the four streams and valid (6.1 MB): about 9 MB, 2.7 us at
// 3.35e12 B/s.  hist is 40 x 8 x 22 words.  Three launches and launch 2's
// single block are latency, which the graphed step pays once.
//
// The host build (-DPOOL_HOST, tests/test_torch_pool.py, g++ behind
// tests/cuda_host_shim/cuda_runtime.h): every launch block by block, a
// block's threads phase by phase through the thread loops below, which run
// over one thread on the card (BLOCK_THREADS).  What a thread carries across
// a barrier lives in the block's shared struct.  The warp match and the
// block scan have host forms that compute the same values from shared
// memory; shared atomics are plain adds.

#include <cuda_runtime.h>
#include <stdint.h>

#define POOL_THREADS 256
#define POOL_WARPS (POOL_THREADS / 32)
#define POOL_ITEMS 8                            // rounds a thread
#define POOL_TILE (POOL_THREADS * POOL_ITEMS)   // ranks a block
#define POOL_GROUPS (POOL_TILE / 32)            // runs of 32 ranks a tile
#define POOL_SEGS (POOL_THREADS / MAX_SLOTS)    // a slot's scan segments
#define POOL_SCAN_THREADS 1024
#define POOL_SCAN_WARPS (POOL_SCAN_THREADS / 32)
#define POOL_SCAN_BATCH 8       // counts a scan thread loads at once
#define MAX_SLOTS 64        // ops/pool.py MAX_SLOTS

static_assert(POOL_GROUPS % POOL_SEGS == 0, "whole segments of groups");

struct PoolArgs {
    const int *slot, *p, *n_cand;       // (n, cap), (n, cap), (n,)
    int *slot_str, *p_str, *frag_str, *order_str;   // (Bp,)
    uint8_t* valid;                     // (n, cap)
    int* hist;                          // scratch: (num_os, n, tiles)
    int* n_pool;                        // scratch: one word
    int n, cap, num_os, tiles;
};

// Launch 1's block: its tile's counts by slot.
struct CountShared {
    int hist[MAX_SLOTS];
};

// Launch 2's block: each thread's run sum, then its run's first prefix.
struct ScanShared {
    int part[POOL_SCAN_THREADS];
    int wsum[POOL_SCAN_WARPS];
    int total;
};

// Launch 3's block: each group's count of a slot, then its first place;
// each entry's key and rank in its group.
struct ScatterShared {
    int place[POOL_GROUPS][MAX_SLOTS];
    int seg[POOL_SEGS][MAX_SLOTS];
    int key[POOL_TILE];                 // -1 past cap
    uint8_t rank[POOL_TILE];
    int ncomp, tail;                    // valid ranks; the tail's first place
};

__host__ __device__ __forceinline__ int clampi(int x, int lo, int hi)
{
    return min(max(x, lo), hi);
}

#ifdef POOL_HOST
#define BLOCK_THREADS POOL_THREADS      // the host thread plays every thread
#define SCAN_BLOCK_THREADS POOL_SCAN_THREADS
#define THREAD(i) (i)

// The lanes of a group holding `key` (the host has stored every lane's).
static unsigned match_peers(const int* group_keys, int key)
{
    unsigned m = 0;
    for (int l = 0; l < 32; ++l)
        if (group_keys[l] == key) m |= 1u << l;
    return m;
}

// Exclusive prefix of s.part over the block's threads, in place; the sum
// into s.total.
static void scan_parts(ScanShared& s)
{
    int sum = 0;
    for (int t = 0; t < POOL_SCAN_THREADS; ++t) {
        const int v = s.part[t];
        s.part[t] = sum;
        sum += v;
    }
    s.total = sum;
}
#else
#define BLOCK_THREADS 1                 // a thread plays itself
#define SCAN_BLOCK_THREADS 1
#define THREAD(i) ((int)threadIdx.x)

__device__ __forceinline__ unsigned match_peers(const int*, int key)
{
    return __match_any_sync(0xffffffffu, key);
}

// Exclusive prefix of s.part over the block's threads, in place (a warp
// scan by shuffles, then the warps' sums); the sum into s.total.
__device__ void scan_parts(ScanShared& s)
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
        const int ws = s.wsum[t];
        int e = ws;
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, e, d);
            if (lane >= d) e += y;
        }
        s.wsum[t] = e - ws;
        if (t == 31) s.total = e;
    }
    __syncthreads();
    s.part[t] = x - v + s.wsum[wp];
    __syncthreads();
}
#endif

// ---- launch 1: a tile's counts by slot -------------------------------------

__device__ void count_block(const PoolArgs& a, CountShared& s, int f, int j)
{
    const int ncomp = clampi(a.n_cand[f], 0, a.cap);
    const int* slot = a.slot + (size_t)f * a.cap;
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int x = t; x < a.num_os; x += POOL_THREADS) s.hist[x] = 0;
    }
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int k = 0; k < POOL_ITEMS; ++k) {
            const int r = j * POOL_TILE + k * POOL_THREADS + t;
            if (r < ncomp) atomicAdd(&s.hist[slot[r]], 1);
        }
    }
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int x = t; x < a.num_os; x += POOL_THREADS)
            a.hist[((size_t)x * a.n + f) * a.tiles + j] = s.hist[x];
    }
}

// ---- launch 2: the counts' exclusive prefix in pool order -----------------

// A thread's run of counts, POOL_SCAN_BATCH at a time, their loads
// issued together (a batch costs one load's latency, not one a count).
__device__ __forceinline__ void load_batch(const int* hist, int x, int end,
                                           int (&v)[POOL_SCAN_BATCH])
{
#pragma unroll
    for (int u = 0; u < POOL_SCAN_BATCH; ++u)
        v[u] = x + u < end ? hist[x + u] : 0;
}

__device__ void scan_block(const PoolArgs& a, ScanShared& s)
{
    const int V = a.num_os * a.n * a.tiles;
    const int per = (V + POOL_SCAN_THREADS - 1) / POOL_SCAN_THREADS;
    for (int i = 0; i < SCAN_BLOCK_THREADS; ++i) {
        const int t = THREAD(i), end = min(V, (t + 1) * per);
        int sum = 0;
        for (int x = t * per; x < end; x += POOL_SCAN_BATCH) {
            int v[POOL_SCAN_BATCH];
            load_batch(a.hist, x, end, v);
            for (int u = 0; u < POOL_SCAN_BATCH; ++u) sum += v[u];
        }
        s.part[t] = sum;
    }
    __syncthreads();
    scan_parts(s);
    for (int i = 0; i < SCAN_BLOCK_THREADS; ++i) {
        const int t = THREAD(i), end = min(V, (t + 1) * per);
        int run = s.part[t];
        for (int x = t * per; x < end; x += POOL_SCAN_BATCH) {
            int v[POOL_SCAN_BATCH];
            load_batch(a.hist, x, end, v);
            for (int u = 0; u < POOL_SCAN_BATCH && x + u < end; ++u) {
                a.hist[x + u] = run;
                run += v[u];
            }
        }
        if (t == 0) *a.n_pool = s.total;
    }
}

// ---- launch 3: every entry at its place ------------------------------------

__device__ void scatter_block(const PoolArgs& a, ScatterShared& s, int f,
                              int j)
{
    const size_t row = (size_t)f * a.cap;
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int x = t; x < POOL_GROUPS * MAX_SLOTS; x += POOL_THREADS)
            (&s.place[0][0])[x] = 0;
        if (t == 0) {
            // the invalid entries of the fragments before f come first
            int before = 0;
            for (int g = 0; g < f; ++g)
                before += a.cap - clampi(a.n_cand[g], 0, a.cap);
            s.ncomp = clampi(a.n_cand[f], 0, a.cap);
            s.tail = *a.n_pool + before;
        }
    }
    __syncthreads();
    // each rank's key, then its rank among its key's lanes of its group
    // and, from the key's lowest lane, the key's count in the group
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int k = 0; k < POOL_ITEMS; ++k) {
            const int r = j * POOL_TILE + k * POOL_THREADS + t;
            s.key[k * POOL_THREADS + t] = r >= a.cap ? -1
                : r < s.ncomp ? a.slot[row + r] : a.num_os;
        }
    }
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int k = 0; k < POOL_ITEMS; ++k) {
            const int x = k * POOL_THREADS + t, lane = t & 31;
            const int key = s.key[x];
            const unsigned peers = match_peers(s.key + (x & ~31), key);
            const int below = __popc(peers & ((1u << lane) - 1u));
            s.rank[x] = (uint8_t)below;
            if (below == 0 && key >= 0 && key < a.num_os)
                s.place[x / 32][key] = __popc(peers);
        }
    }
    __syncthreads();
    // each slot's groups scanned in rank order: a segment's sum, then the
    // places from the slot's first one in the tile
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i), sl = t % MAX_SLOTS, q = t / MAX_SLOTS;
        if (sl < a.num_os) {
            int sum = 0;
            for (int g = q * (POOL_GROUPS / POOL_SEGS);
                 g < (q + 1) * (POOL_GROUPS / POOL_SEGS); ++g)
                sum += s.place[g][sl];
            s.seg[q][sl] = sum;
        }
    }
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i), sl = t % MAX_SLOTS, q = t / MAX_SLOTS;
        if (sl < a.num_os) {
            int run = a.hist[((size_t)sl * a.n + f) * a.tiles + j];
            for (int b = 0; b < q; ++b) run += s.seg[b][sl];
            for (int g = q * (POOL_GROUPS / POOL_SEGS);
                 g < (q + 1) * (POOL_GROUPS / POOL_SEGS); ++g) {
                const int c = s.place[g][sl];
                s.place[g][sl] = run;
                run += c;
            }
        }
    }
    __syncthreads();
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        // every round's p first, the loads in flight together (the stores
        // below might alias them for all the compiler knows)
        int pv[POOL_ITEMS];
#pragma unroll
        for (int k = 0; k < POOL_ITEMS; ++k) {
            const int x = k * POOL_THREADS + t;
            pv[k] = s.key[x] >= 0 ? a.p[row + j * POOL_TILE + x] : 0;
        }
#pragma unroll
        for (int k = 0; k < POOL_ITEMS; ++k) {
            const int x = k * POOL_THREADS + t, key = s.key[x];
            if (key < 0) continue;
            const int r = j * POOL_TILE + x;
            const int at = key < a.num_os ? s.place[x / 32][key] + s.rank[x]
                                          : s.tail + (r - s.ncomp);
            a.slot_str[at] = key;
            a.p_str[at] = pv[k];
            a.frag_str[at] = f;
            a.order_str[at] = (int)(row + r);
            a.valid[row + r] = key < a.num_os;
        }
    }
}

#ifdef POOL_HOST
// the CPU tests' build: every launch block by block
static int run(const PoolArgs& a, int device, void* stream)
{
    (void)device;
    (void)stream;
    static CountShared cs;
    static ScanShared ss;
    static ScatterShared xs;
    for (int f = 0; f < a.n; ++f)
        for (int j = 0; j < a.tiles; ++j) count_block(a, cs, f, j);
    scan_block(a, ss);
    for (int f = 0; f < a.n; ++f)
        for (int j = 0; j < a.tiles; ++j) scatter_block(a, xs, f, j);
    return 0;
}
#else
__global__ void __launch_bounds__(POOL_THREADS) pool_count_kernel(
    const PoolArgs a)
{
    __shared__ CountShared s;
    count_block(a, s, (int)blockIdx.y, (int)blockIdx.x);
}

__global__ void __launch_bounds__(POOL_SCAN_THREADS) pool_scan_kernel(
    const PoolArgs a)
{
    __shared__ ScanShared s;
    scan_block(a, s);
}

__global__ void __launch_bounds__(POOL_THREADS) pool_scatter_kernel(
    const PoolArgs a)
{
    __shared__ ScatterShared s;
    scatter_block(a, s, (int)blockIdx.y, (int)blockIdx.x);
}

// Queues the three launches on `stream` on card `device` (made current for
// the launches and restored); 0 or a CUDA error.
static int run(const PoolArgs& a, int device, void* stream)
{
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid((unsigned)a.tiles, (unsigned)a.n);
    pool_count_kernel<<<grid, POOL_THREADS, 0, st>>>(a);
    int rc = (int)cudaGetLastError();
    if (rc == 0) {
        pool_scan_kernel<<<1, POOL_SCAN_THREADS, 0, st>>>(a);
        rc = (int)cudaGetLastError();
    }
    if (rc == 0) {
        pool_scatter_kernel<<<grid, POOL_THREADS, 0, st>>>(a);
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

// A panel's part of the arguments, checked once: the static shapes and the
// card.  The step's call fills in the rest.
struct PoolPlan {
    PoolArgs a;
    int device;
};

extern "C" int pool_plan_bytes() { return (int)sizeof(PoolPlan); }

// Fills `plan` (pool_plan_bytes() bytes, 8-byte aligned); 0, or
// cudaErrorInvalidValue where a shape is refused.
extern "C" int pool_plan(void* plan, int num_os, int cap, int device)
{
    if (num_os < 1 || num_os > MAX_SLOTS || cap < 1 || cap > (1 << 24))
        return (int)cudaErrorInvalidValue;
    PoolPlan* pl = (PoolPlan*)plan;
    PoolArgs a = {};
    a.num_os = num_os;
    a.cap = cap;
    a.tiles = (cap + POOL_TILE - 1) / POOL_TILE;
    pl->a = a;
    pl->device = device;
    return 0;
}

// int32 words of scratch a call on n fragments needs under a plan: the
// counts and n_pool.
extern "C" long long pool_scratch_words(const void* plan, int n)
{
    const PoolArgs& a = ((const PoolPlan*)plan)->a;
    return (long long)a.num_os * n * a.tiles + 1;
}

// The step's call: pools n fragments' candidates under a plan, on the
// plan's card, on `stream`.  Pointers: slot, p (n, cap), n_cand (n,), the
// outputs slot_str, p_str, frag_str, order_str (n * cap,) and valid (n,
// cap) bytes, and pool_scratch_words(plan, n) int32 words of scratch, any
// values.  0, cudaErrorInvalidValue for n outside [1, 65535] or a stream
// past 2^31 entries, or a launch's CUDA error.
extern "C" int pool_launch_plan(
    const void* plan, const void* slot, const void* p, const void* n_cand,
    void* slot_str, void* p_str, void* frag_str, void* order_str,
    void* valid, void* scratch, int n, void* stream)
{
    PoolArgs a = ((const PoolPlan*)plan)->a;
    if (n < 1 || n > 65535 || (long long)n * a.cap > 0x7fffffffLL
        || (long long)a.num_os * n * a.tiles > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    a.slot = (const int*)slot;
    a.p = (const int*)p;
    a.n_cand = (const int*)n_cand;
    a.slot_str = (int*)slot_str;
    a.p_str = (int*)p_str;
    a.frag_str = (int*)frag_str;
    a.order_str = (int*)order_str;
    a.valid = (uint8_t*)valid;
    a.hist = (int*)scratch;
    a.n_pool = a.hist + (size_t)a.num_os * n * a.tiles;
    a.n = n;
    return run(a, ((const PoolPlan*)plan)->device, stream);
}
