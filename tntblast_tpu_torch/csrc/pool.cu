// The pooled candidate stream of the device seed+screen step, as two
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
// A counting sort does it, in two launches over the grid (tiles of
// POOL_TILE ranks, n):
//  1. count: a block counts its tile's valid entries by slot (shared
//     atomics) and writes the counts into hist, laid out (slot, fragment,
//     tile): the order of the pool.  A tile past the fragment's candidates
//     writes zeros and reads nothing.
//  2. scatter.  A tile without a valid rank takes a lean path: its entries'
//     places are closed-form (n_pool, the invalid entries of the fragments
//     before it, cap - clamp(n_cand, 0, cap) each, and the rank past
//     n_cand), so it copies p and writes its index, key and fragment
//     coalesced, with no shared table.  A tile with valid ranks:
//     - the place of its slot s's first entry is the sum of hist below
//       index s * (n * tiles) + f * tiles + j, its point.  The block sums
//       hist from L2 itself (no launch of its own for the prefix): a thread
//       sums a run of the counts, 16 bytes a load (POOL_PASS counts of it
//       in flight, the bench step's 56 in one pass), and notes the partial
//       sum at any point inside its run; a block scan of the runs' sums
//       adds the runs before.  Its loads go out with the tile's key loads.
//     - rank r = j * POOL_TILE + k * POOL_THREADS + t (round k, thread t),
//       so that the 32 lanes of a warp in one round hold 32 consecutive
//       ranks, a group, and the tile's groups come in rank order.  In a
//       group the lanes holding one key find each other (match_any): an
//       entry's rank among its key's lanes below it, and the key's count in
//       the group from its lowest lane.  A scan over the groups for each
//       slot (four segments a slot, 256 threads) and one over the slots
//       give each valid entry its position in the tile's own slot-major
//       order: a local counting sort into at most 64 runs, staged in shared
//       memory (p and the rank in the tile).
//     - the staged runs go out with consecutive threads at consecutive
//       places (a slot's run of the tile is consecutive in the pool), so a
//       warp stores each of the four streams in at most two runs; the
//       tile's invalid ranks at their closed-form places, and every rank's
//       valid flag at its index.
// Integer arithmetic throughout: the kernel equals the plain version bit for
// bit by construction.
//
// What the kernel relies on.  The seed stage's contract: a valid entry's
// slot lies in [0, num_os) (a slot outside would address past the counts),
// num_os <= MAX_SLOTS (the panel's groups hold 64 slots at most).  Scratch
// needs no initial value: launch 1 writes every count launch 2 reads, so a
// CUDA graph's replays need no reset between them; it lies on 16 bytes.
//
// What bounds it on the H100: bytes.  A bench step (8 fragments, cap 45056,
// Bp 360448, 97225 pooled) reads the pooled entries' slots and every p and
// writes the four streams and valid (7.96 MB): 2.4 us at 3.35e12 B/s.
// hist is 40 x 8 x 44 words (56 KB), which each of the 98 tiles of 1024
// ranks with valid ranks reads from L2 (tiles of 1024, not 2048, spread
// those tiles over most of the card's 132 SMs).  Two launches and a tile's
// chain of phases are latency, which the graphed step pays once; the
// count table's read is the longest phase (tools/compact_steps.py
// --timeline).
//
// The host build (-DPOOL_HOST, tests/test_torch_pool.py, g++ behind
// tests/cuda_host_shim/cuda_runtime.h): every launch block by block, a
// block's threads phase by phase through the thread loops below, which run
// over one thread on the card (BLOCK_THREADS), a warp's phase once a warp
// (WARP_LANES).  What a thread carries across a barrier lives in the
// block's shared struct.  The warp match and the scans have host forms that
// compute the same values from shared memory; shared atomics are plain
// adds.

#include <cuda_runtime.h>
#include <stdint.h>

#define POOL_THREADS 256
#define POOL_WARPS (POOL_THREADS / 32)
#define POOL_ITEMS 4                            // rounds a thread
#define POOL_TILE (POOL_THREADS * POOL_ITEMS)   // ranks a block
#define POOL_GROUPS (POOL_TILE / 32)            // runs of 32 ranks a tile
#define POOL_SEGS (POOL_THREADS / MAX_SLOTS)    // a slot's scan segments
#define POOL_PASS 64        // counts a prefix thread loads at once
#define MAX_SLOTS 64        // ops/pool.py MAX_SLOTS

static_assert(POOL_GROUPS % POOL_SEGS == 0, "whole segments of groups");

struct PoolArgs {
    const int *slot, *p, *n_cand;       // (n, cap), (n, cap), (n,)
    int *slot_str, *p_str, *frag_str, *order_str;   // (Bp,)
    uint8_t* valid;                     // (n, cap)
    int* hist;                          // scratch: (num_os, n, tiles)
    int n, cap, num_os, tiles;
    int chunk;                          // hist counts a prefix thread sums
};

// Launch 1's block: its tile's counts by slot.
struct CountShared {
    int hist[MAX_SLOTS];
};

// Launch 2's block.
struct ScatterShared {
    int place[POOL_GROUPS][MAX_SLOTS];  // a group's count of a slot, then
                                        // its first position in the tile
    int seg[POOL_SEGS][MAX_SLOTS];
    int pv[POOL_TILE];                  // p of each rank
    int st_p[POOL_TILE];                // staged in the tile's pool order
    uint16_t st_x[POOL_TILE];           // the staged entries' ranks - j * TILE
    int8_t key[POOL_TILE];              // slot, num_os past n_cand, -1 past
                                        // cap
    uint8_t rank[POOL_TILE];            // among the group's lanes of its key
    int chunk[POOL_THREADS];            // a prefix thread's run sum, then
                                        // the sum of the runs before it
    int wsum[POOL_WARPS];
    int part[MAX_SLOTS];                // a point's partial sum in its run
    int base[MAX_SLOTS];                // the pool place of the tile's first
                                        // entry of a slot
    int loc[MAX_SLOTS];                 // its position in the tile's order
    int ncomp, tail, n_pool;            // valid ranks; the tail's first place
};

__host__ __device__ __forceinline__ int clampi(int x, int lo, int hi)
{
    return min(max(x, lo), hi);
}

#ifdef POOL_HOST
#define BLOCK_THREADS POOL_THREADS      // the host thread plays every thread
#define WARP_LANES 1                    // and a warp's phase once a warp
#define THREAD(i) (i)

// The lanes of a group holding `key` (the host has stored every lane's).
static unsigned match_peers(const int8_t* group_keys, int key)
{
    unsigned m = 0;
    for (int l = 0; l < 32; ++l)
        if (group_keys[l] == key) m |= 1u << l;
    return m;
}

// Fragment f's offsets: the candidates of every fragment (n_pool) and the
// invalid entries of the fragments before f.
static void fragment_sums(const PoolArgs& a, int f, int* n_pool, int* before)
{
    int np = 0, bf = 0;
    for (int g = 0; g < a.n; ++g) {
        const int c = clampi(a.n_cand[g], 0, a.cap);
        np += c;
        if (g < f) bf += a.cap - c;
    }
    *n_pool = np;
    *before = bf;
}

// Exclusive prefix of s.chunk over the block's threads, in place.
static void scan_chunks(ScatterShared& s)
{
    int sum = 0;
    for (int t = 0; t < POOL_THREADS; ++t) {
        const int v = s.chunk[t];
        s.chunk[t] = sum;
        sum += v;
    }
}

// Each slot's count in the tile (the sum of its segments) and their
// exclusive prefix over the slots into s.loc.
static void scan_slots(ScatterShared& s, int num_os)
{
    int sum = 0;
    for (int sl = 0; sl < num_os; ++sl) {
        s.loc[sl] = sum;
        for (int q = 0; q < POOL_SEGS; ++q) sum += s.seg[q][sl];
    }
}
#else
#define BLOCK_THREADS 1                 // a thread plays itself
#define WARP_LANES 32                   // a warp's phase on its 32 lanes
#define THREAD(i) ((int)threadIdx.x)

__device__ __forceinline__ unsigned match_peers(const int8_t*, int key)
{
    return __match_any_sync(0xffffffffu, key);
}

// Fragment f's offsets, by the lanes of one warp.
__device__ void fragment_sums(const PoolArgs& a, int f, int* n_pool,
                              int* before)
{
    int np = 0, bf = 0;
    for (int g = (int)threadIdx.x & 31; g < a.n; g += 32) {
        const int c = clampi(a.n_cand[g], 0, a.cap);
        np += c;
        if (g < f) bf += a.cap - c;
    }
    for (int d = 16; d > 0; d >>= 1) {
        np += __shfl_xor_sync(0xffffffffu, np, d);
        bf += __shfl_xor_sync(0xffffffffu, bf, d);
    }
    *n_pool = np;
    *before = bf;
}

// Exclusive prefix of s.chunk over the block's threads, in place (a warp
// scan by shuffles, then the warps' sums).
__device__ void scan_chunks(ScatterShared& s)
{
    const int t = (int)threadIdx.x, lane = t & 31, wp = t >> 5;
    const int v = s.chunk[t];
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) s.wsum[wp] = x;
    __syncthreads();
    if (t < 32) {
        const int ws = t < POOL_WARPS ? s.wsum[t] : 0;
        int e = ws;
        for (int d = 1; d < POOL_WARPS; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, e, d);
            if (lane >= d) e += y;
        }
        if (t < POOL_WARPS) s.wsum[t] = e - ws;
    }
    __syncthreads();
    s.chunk[t] = x - v + s.wsum[wp];
}

// Each slot's count in the tile and their exclusive prefix over the slots
// into s.loc, by the lanes of one warp (two slots a lane).
__device__ void scan_slots(ScatterShared& s, int num_os)
{
    const int lane = (int)threadIdx.x & 31;
    int c[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int sl = 2 * lane + i;
        c[i] = 0;
        if (sl < num_os)
            for (int q = 0; q < POOL_SEGS; ++q) c[i] += s.seg[q][sl];
    }
    const int sum = c[0] + c[1];
    int x = sum;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    s.loc[2 * lane] = x - sum;
    s.loc[2 * lane + 1] = x - sum + c[0];
}
#endif

// ---- launch 1: a tile's counts by slot -------------------------------------

__device__ void count_block(const PoolArgs& a, CountShared& s, int f, int j)
{
    const int ncomp = clampi(a.n_cand[f], 0, a.cap);
    const int* slot = a.slot + (size_t)f * a.cap;
    int* out = a.hist + (size_t)f * a.tiles + j;
    const size_t stride = (size_t)a.n * a.tiles;
    if (j * POOL_TILE >= ncomp) {       // no valid rank: zeros
        for (int i = 0; i < BLOCK_THREADS; ++i) {
            const int t = THREAD(i);
            for (int x = t; x < a.num_os; x += POOL_THREADS)
                out[x * stride] = 0;
        }
        return;
    }
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
            out[x * stride] = s.hist[x];
    }
}

// ---- launch 2: every entry at its place ------------------------------------

// A tile without a valid rank: its entries at their closed-form places,
// every rank's p first (the loads in flight together).
__device__ __forceinline__ void tail_tile(const PoolArgs& a,
                                          const ScatterShared& s, int f,
                                          int j, int t)
{
    const size_t row = (size_t)f * a.cap;
    int pv[POOL_ITEMS];
#pragma unroll
    for (int k = 0; k < POOL_ITEMS; ++k) {
        const int r = j * POOL_TILE + k * POOL_THREADS + t;
        pv[k] = r < a.cap ? a.p[row + r] : 0;
    }
#pragma unroll
    for (int k = 0; k < POOL_ITEMS; ++k) {
        const int r = j * POOL_TILE + k * POOL_THREADS + t;
        if (r >= a.cap) break;
        const int at = s.tail + (r - s.ncomp);
        a.slot_str[at] = a.num_os;
        a.p_str[at] = pv[k];
        a.frag_str[at] = f;
        a.order_str[at] = (int)(row + r);
        a.valid[row + r] = 0;
    }
}

// Thread t's share of a tile with valid ranks: its ranks' keys and p into
// shared memory, and its run of the counts (POOL_PASS at a time, 16 bytes
// a load, all in flight with the key loads): the run's sum into s.chunk[t]
// and, for each slot whose point lies in the run, the sum of the run below
// it into s.part.
__device__ __forceinline__ void tile_loads(const PoolArgs& a,
                                           ScatterShared& s, int f, int j,
                                           int t)
{
    const size_t row = (size_t)f * a.cap;
    int key[POOL_ITEMS], pv[POOL_ITEMS];
#pragma unroll
    for (int k = 0; k < POOL_ITEMS; ++k) {
        const int r = j * POOL_TILE + k * POOL_THREADS + t;
        key[k] = r >= a.cap ? -1 : r < s.ncomp ? a.slot[row + r] : a.num_os;
        pv[k] = r < a.cap ? a.p[row + r] : 0;
    }
    const int V = a.num_os * a.n * a.tiles, NT = a.n * a.tiles;
    const int fj = f * a.tiles + j;
    const int c0 = min(t * a.chunk, V), c1 = min(c0 + a.chunk, V);
    // the first slot whose point lies at c0 or past it
    int sl = c0 <= fj ? 0 : (c0 - fj + NT - 1) / NT;
    int run = 0;
    for (int x0 = c0; x0 < c1; x0 += POOL_PASS) {
        int v[POOL_PASS];
#pragma unroll
        for (int q = 0; q < POOL_PASS / 4; ++q) {
            const int x = x0 + 4 * q;
            if (x + 4 <= c1) {
                const int4 w = *reinterpret_cast<const int4*>(a.hist + x);
                v[4 * q] = w.x;
                v[4 * q + 1] = w.y;
                v[4 * q + 2] = w.z;
                v[4 * q + 3] = w.w;
            } else {
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    v[4 * q + u] = x + u < c1 ? a.hist[x + u] : 0;
            }
        }
        for (; sl < a.num_os && sl * NT + fj < min(x0 + POOL_PASS, c1);
             ++sl) {
            const int d = sl * NT + fj - x0;
            int below = run;
#pragma unroll
            for (int q = 0; q < POOL_PASS; ++q)
                if (q < d) below += v[q];
            s.part[sl] = below;
        }
#pragma unroll
        for (int q = 0; q < POOL_PASS; ++q) run += v[q];
    }
    s.chunk[t] = run;
#pragma unroll
    for (int k = 0; k < POOL_ITEMS; ++k) {
        const int x = k * POOL_THREADS + t;
        s.key[x] = (int8_t)key[k];
        s.pv[x] = pv[k];
    }
}

__device__ void scatter_block(const PoolArgs& a, ScatterShared& s, int f,
                              int j)
{
    const size_t row = (size_t)f * a.cap;
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t < WARP_LANES) {
            int np, before;
            fragment_sums(a, f, &np, &before);
            if (t == 0) {
                s.ncomp = clampi(a.n_cand[f], 0, a.cap);
                s.n_pool = np;
                s.tail = np + before;
            }
        }
    }
    __syncthreads();
    if (j * POOL_TILE >= s.ncomp) {     // the lean path
        for (int i = 0; i < BLOCK_THREADS; ++i)
            tail_tile(a, s, f, j, THREAD(i));
        return;
    }
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        tile_loads(a, s, f, j, t);
        for (int x = t; x < POOL_GROUPS * MAX_SLOTS; x += POOL_THREADS)
            (&s.place[0][0])[x] = 0;
    }
    __syncthreads();
    // each rank's rank among its key's lanes of its group and, from the
    // key's lowest lane, the key's count in the group
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
    // the runs' sums before each run; each slot's segments of groups
    scan_chunks(s);
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
    // the slots' positions in the tile and places in the pool
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        if (t < WARP_LANES) scan_slots(s, a.num_os);
        if (t < a.num_os) {
            const int point = t * a.n * a.tiles + f * a.tiles + j;
            s.base[t] = s.chunk[point / a.chunk] + s.part[t];
        }
    }
    __syncthreads();
    // each slot's groups scanned in rank order from the slot's position
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i), sl = t % MAX_SLOTS, q = t / MAX_SLOTS;
        if (sl < a.num_os) {
            int run = s.loc[sl];
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
    // the valid entries staged in the tile's order
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int k = 0; k < POOL_ITEMS; ++k) {
            const int x = k * POOL_THREADS + t, key = s.key[x];
            if (key < 0 || key >= a.num_os) continue;
            const int at = s.place[x / 32][key] + s.rank[x];
            s.st_p[at] = s.pv[x];
            s.st_x[at] = (uint16_t)x;
        }
    }
    __syncthreads();
    // the runs out, consecutive threads at consecutive places; the invalid
    // ranks at their closed-form places; every rank's valid flag
    const int nv = min(s.ncomp - j * POOL_TILE, POOL_TILE);
    for (int i = 0; i < BLOCK_THREADS; ++i) {
        const int t = THREAD(i);
        for (int y = t; y < nv; y += POOL_THREADS) {
            const int x = s.st_x[y], key = s.key[x];
            const int at = s.base[key] + (y - s.loc[key]);
            a.slot_str[at] = key;
            a.p_str[at] = s.st_p[y];
            a.frag_str[at] = f;
            a.order_str[at] = (int)(row + j * POOL_TILE + x);
        }
        for (int k = 0; k < POOL_ITEMS; ++k) {
            const int x = k * POOL_THREADS + t, r = j * POOL_TILE + x;
            if (r >= a.cap) break;
            a.valid[row + r] = r < s.ncomp;
            if (r < s.ncomp) continue;
            const int at = s.tail + (r - s.ncomp);
            a.slot_str[at] = a.num_os;
            a.p_str[at] = s.pv[x];
            a.frag_str[at] = f;
            a.order_str[at] = (int)(row + r);
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
    static ScatterShared xs;
    for (int f = 0; f < a.n; ++f)
        for (int j = 0; j < a.tiles; ++j) count_block(a, cs, f, j);
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

__global__ void __launch_bounds__(POOL_THREADS) pool_scatter_kernel(
    const PoolArgs a)
{
    __shared__ ScatterShared s;
    scatter_block(a, s, (int)blockIdx.y, (int)blockIdx.x);
}

// Queues the two launches on `stream` on card `device` (made current for
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
// counts.
extern "C" long long pool_scratch_words(const void* plan, int n)
{
    const PoolArgs& a = ((const PoolPlan*)plan)->a;
    return (long long)a.num_os * n * a.tiles;
}

// The step's call: pools n fragments' candidates under a plan, on the
// plan's card, on `stream`.  Pointers: slot, p (n, cap), n_cand (n,), the
// outputs slot_str, p_str, frag_str, order_str (n * cap,) and valid (n,
// cap) bytes, and pool_scratch_words(plan, n) int32 words of scratch on 16
// bytes, any values.  0, cudaErrorInvalidValue for n outside [1, 65535], a
// stream past 2^31 entries or misaligned scratch, or a launch's CUDA error.
extern "C" int pool_launch_plan(
    const void* plan, const void* slot, const void* p, const void* n_cand,
    void* slot_str, void* p_str, void* frag_str, void* order_str,
    void* valid, void* scratch, int n, void* stream)
{
    PoolArgs a = ((const PoolPlan*)plan)->a;
    if (n < 1 || n > 65535 || (long long)n * a.cap > 0x7fffffffLL
        || (long long)a.num_os * n * a.tiles > 0x7fffffffLL
        || (uintptr_t)scratch % 16 != 0)
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
    a.n = n;
    // a prefix thread's run: the counts over the block's threads, whole
    // 16-byte loads
    const long long V = (long long)a.num_os * n * a.tiles;
    a.chunk = (int)(((V + POOL_THREADS - 1) / POOL_THREADS + 3) / 4 * 4);
    return run(a, ((const PoolPlan*)plan)->device, stream);
}
