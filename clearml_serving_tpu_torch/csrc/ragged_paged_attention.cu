// Ragged paged attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel clearml_serving_tpu/ops/paged_attention.py::
// ragged_paged_attention (body _ragged_attention_kernel, pallas_call at
// :881). Same contract: one launch attends rows at mixed phases (prefill
// chunks, decode tokens) over the paged pools. The flat token axis is
// q-block aligned: every row's segment starts at a multiple of kQB, so each
// q block belongs to one row, named by block_rows / block_q0.
//
//   q            [T, Hkv, G, D]  bf16, T % kQB == 0
//   k/v pools    [Hkv, N, P, D]  bf16, or int8 with f32 scales [Hkv, N, P]
//   page_table   [R, PP]         int32 (entries past a row's causal bound
//                                 are never read and may hold anything)
//   kv_lens      [R]             tokens present per row, this step included
//   row_starts   [R]             flat index of each row's first query
//   row_lens     [R]             query tokens per row (0 = idle)
//   block_rows   [T/kQB]         owning row per q block, -1 = no row
//   block_q0     [T/kQB]         in-row index of the block's first query
//   tree_anc     [T, DMAX]       optional int32 ancestor lists (below)
//   out          [T, Hkv, G, D]  bf16; every element is written every call
//
// Query i of row r attends KV positions < kv_lens[r] - row_lens[r] + i + 1.
// Queries with q0 + i >= row_lens[r] and blocks no row owns give zeros.
//
// Draft-tree verify rows (the TPU kernel's `tree` branch, :701-722): with
// tree_anc, a query whose tree_anc[t, 0] is not -2 sees, inside that same
// causal limit, only the row's history (in-row offset t - base < 0) and the
// in-row offsets listed in its own tree_anc row (-1 pads). Queries with
// tree_anc[t, 0] == -2 stay plain causal. The node order is parent before
// child, so the causal limit still bounds every ancestor: trees change the
// mask inside the tiles already loaded, never the page walk, the split or
// the order of any sum. The variant is a template parameter (TREE). Each
// thread reads the lists of its two fragment rows once into a plain flag
// and a 64-bit mask of allowed offsets 0..63; a listed offset of 64 or more
// (a row of more than 64 nodes) is found by scanning the list, a path no
// verify row of the engine takes. Only tiles that reach past the row's
// history test the tree, so a verify row's mask applies only in the span
// that holds its in-row keys. The mask moves no bytes: a tree launch has
// the bound of the same plain launch.
//
// The kernel applies D**-0.5 itself (the caller folds any query_scale into q).
// For int8 pools the K scale multiplies the f32 scores per key, the V scale
// multiplies the probabilities before the PV product, and the softmax
// denominator sums the unscaled probabilities, as in the TPU kernel
// (:680-744). Scales are read through the page table with the tile they
// belong to, not pre-gathered per row as the TPU does (:839-860).
//
// What bounds each kind of row. A decode row (and a verify row of up to
// kQB queries) reads its K/V once for 4*G*D FLOPs per key and query, so
// launches of mostly such rows are bound by bytes (3.35 TB/s); a 1024-token
// row walked by one CTA is a latency chain, not a stream. A prefill chunk
// of n tokens does n*G times the FLOPs per byte: a 512-token chunk at
// history 1536 is ~15 GFLOP against ~17 MB, so the tensor cores bound it.
//
// Design. The TPU kernel walks a q block's pages one grid step after
// another on one core; here:
//
// 1. The key range of a short row is split across CTAs (flash-decoding, as
//    csrc/paged_attention.cu). A row of 1..kQB live queries owns one live q
//    block (decode rows, multi-step decode rows, verify rows of spec_k + 1
//    <= 8). Its keys may be cut into spans. ops/paged_attention.py::
//    ragged_split_plan gives S slots a row and the least span, `span`
//    tokens (a multiple of 64, no shorter than 256), from shapes alone (no
//    device value is read on the host, so a call can be captured in a CUDA
//    graph). The grid is (T/kQB + R*(S-1), Hkv): CTA x < T/kQB takes q
//    block x (and span 0 of a split row); CTA T/kQB + r*(S-1) + s-1 takes
//    span s of row r, whose block row_starts[r] names. Not a (T/kQB, Hkv,
//    S) grid: its CTAs would be mostly empty (only R of the T/kQB blocks
//    can split), and an empty CTA still holds its shared memory while it
//    reads the row map. Whether a row splits, into how many spans and how
//    wide, is decided on the device from row_lens, kv_lens and the row map
//    (row_split), by every CTA of the row and by the combine alike: a
//    short row splits only when its keys exceed 3 spans and a span past
//    the launch's longest prefill chunk (whose q blocks bound the launch
//    anyway), into spans of equal width, fewer and wider when many rows
//    split, so that a launch holds about 128 split CTAs. A slot past the
//    row's spans exits at once, and a row that does not split writes its
//    output directly. Rows of more than kQB queries (prefill chunks) are
//    not split: each of their q blocks walks its keys in one CTA.
// 2. Every CTA keeps several tiles in flight with no block barrier per
//    tile. Its compute warps are kMT m-tiles (16 rows of (query, head)
//    pairs each) times kKG = 2 key groups (1 at D = 256 and GP = 8, see
//    Tiling); key group k takes every other 32-key step of the CTA's
//    range, two 16-key stages a step, through its own ring of kStages = 6
//    stages, each with a full and an empty mbarrier,
//    and its warps run their own online softmax. One more warp only copies:
//    it walks the groups' steps, and before refilling a stage waits on its
//    empty barrier (one arrival per m-tile that holds a live query: a
//    decode row's CTA runs one m-tile, its other compute warps idle). Its
//    lane 0 fetches a stage with Hopper's bulk tensor copies (TMA): the
//    pool is a 2-D tensor of Hkv*N*P rows, a stage side one to four boxes of
//    16 rows by 128 bytes (64 for int8 at D=64), written with the swizzle of
//    that width so that ldmatrix and word reads of 8 rows at one column hit
//    8 different banks; for int8 one 1-D bulk copy each brings the stage's
//    16 K and V scales. A stage lies in one page (16 divides both page
//    sizes), so every side is one box column of contiguous pool rows: no
//    16-byte cp.async is needed. The key groups' states are merged once, in
//    group order, at the end of the CTA. The tensor maps are encoded per
//    call and cached by pool address (as csrc/paged_attention.cu does).
//    Development timings on an H100 (clock64 per phase of a step, one warp
//    a scheduler) showed each warp's step as a latency chain of a few
//    hundred cycles per phase (wait, QK, softmax, PV); the copy warp took
//    ~450 cycles a step off the compute warps that had issued copies
//    themselves, 32-key steps and two QK chains shortened the rest, and a
//    third CTA an SM (a cap of 136 registers a thread, below the ~168 the
//    kernel takes) ran slower.
// 3. QK^T and PV on mma.sync m16n8k16 (bf16 in, f32 sums), bf16 fragments
//    by ldmatrix (.trans for V), the score fragments reused in registers as
//    PV's A operand. The softmax runs in the log2 domain (log2 e folded
//    into the score scale, the exponentials on the hardware's ex2), and a
//    warp skips rescaling its sums when no row's maximum moved. int8 codes
//    become bf16 (exactly) a 32-bit word of four codes at a time, by bit
//    operations and a bf16x2 subtraction (i8pair_to_bf16x2, as
//    csrc/paged_attention.cu), not through float conversions.
//    At D = 256 (Gemma's head_dim) a warp's output accumulator is 128 f32
//    registers a thread; the query fragments would add 64 more, so the CTA
//    copies its queries into shared memory once (after the rings, QFrags)
//    and QK^T walks the head dim in k-step pairs, reading each pair's
//    fragments there, with the step's score tiles inside the pair.
// 4. A split row's CTAs write f32 partials (acc unnormalised, m, l) indexed
//    by row: [R, Hkv, S, kQB, G, D] and [R, Hkv, S, kQB, G] twice, 9.4 MB at
//    the engine's shapes (R 8, Hkv 8, S 9, G 4, D 128). Indexed by flat
//    token they would take 46 MB. ragged_attention_combine_kernel, grid
//    (R, Hkv), merges a split row's spans in split order with no atomics:
//    out = sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s (M the largest m_s),
//    in one pass that rescales as it goes, a sum of 0 giving 0; it also
//    writes the zeros of the block's dead queries. Two calls give the same
//    bits. Both grids are launched as programmatic dependents
//    (launch_dependent), so the combine's launch overlaps the attention
//    grid's run; each of its CTAs waits for the attention grid before it
//    returns, even in a call where no row splits, so the kernel that
//    follows a call depends on both grids.
//
// What is left (PERF.md): a call has a fixed cost of several microseconds
// (two grids, three dependent reads of the row map and page table before
// the first copy, the partials' round trip), and chunk rows are bound by
// each warp's dependent chain per step (the softmax's shuffles and
// exponentials, then PV) at 8 compute warps an SM, not by the tensor
// cores: a development build of QK^T and PV on wgmma ran no faster, and
// one that gave a CTA two q blocks of a chunk row ran slower.
//
// Page-table entries past a CTA's key bound are never read, and no page
// past it is copied; the last tile may bring rows of its own page past the
// bound (a box is 16 rows). There the V rows are zeroed in shared memory
// (a row never written could hold NaN, and 0 * NaN is NaN in the product),
// their V scales read as 0, and their scores are selected to -inf and their
// probabilities to 0, so those K rows and scales reach no sum.
//
// Kernel names: ragged_attention_kernel and ragged_attention_combine_kernel
// (chip_smoke.py's profile sums the ragged attention by the prefix
// "ragged_attention_", the decode kernel by its own two names).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kQB = 8;       // query tokens per q block (ops/paged_attention.py RAGGED_QB)
constexpr int kTile = 16;    // keys per stage: the rows of a TMA box, inside one page
constexpr int kChunk = 2 * kTile;  // keys a warp takes per step: two stages
constexpr int kStages = 6;   // ring stages per key group (three steps)
constexpr int kMaxG = 8;
constexpr int kSpanQuantum = 64;  // a split's span is a multiple of this (ops SPLIT_QUANTUM)
constexpr int kSplitMinSpans = 3;  // a row splits only past this many spans' keys
constexpr int kSplitCtas = 128;    // split CTAs a launch aims at, all rows and heads
constexpr int kCombineThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <bool INT8>
struct KvType {
  using T = __nv_bfloat16;
};
template <>
struct KvType<true> {
  using T = int8_t;
};

static_assert(kStages % 2 == 0, "a step takes two stages");

// GP: the query-head count rounded up to 1, 2, 4 or 8. The CTA's rows are
// (query, head) pairs, row = query * GP + head, padded to one 16-row mma
// tile when kQB * GP < 16. kMT m-tiles times kKG key groups of compute
// warps, and one copy warp. kKG is 2, but 1 at D = 256 and GP = 8: a warp
// there holds a 128-register output accumulator, and 9 warps put 3 on one
// of the SM's four register files (16384 registers each), capping a thread
// at 168 registers, so the kernel spilled (ptxas: 340-632 bytes); 5 warps
// put at most 2 on each, leaving 255.
template <int GP, int D>
struct Tiling {
  static constexpr int kM = kQB * GP;
  static constexpr int kMT = kM >= 16 ? kM / 16 : 1;
  static constexpr int kKG = (D > 128 && GP == 8) ? 1 : 2;  // key groups per CTA
  static constexpr int kWarps = kMT * kKG;  // compute warps
  static constexpr int kThreads = 32 * (kWarps + 1);
  static constexpr int kRows = kMT * 16;  // rows of the merge area per key group
  static_assert(kSpanQuantum % (kKG * kChunk) == 0,
                "a span deals its steps evenly to the key groups");
};

// Shared-memory layout of one ring stage: the tile's K rows, its V rows,
// then (int8) its K and V scales. Each side is kBoxes TMA boxes of kTile
// rows by kBoxBytes (128, or an int8 row of 64), written with the swizzle
// of that width. Stages start on 1024-byte boundaries (the swizzle's
// period).
template <int D, bool INT8>
struct Stage {
  using T = typename KvType<INT8>::T;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kBoxBytes = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kBoxes = kRowBytes / kBoxBytes;
  static constexpr int kBoxInner = kBoxBytes / static_cast<int>(sizeof(T));  // elements
  static constexpr int kBoxSmem = kTile * kBoxBytes;
  static constexpr int kSide = kBoxes * kBoxSmem;
  static constexpr int kScaleOff = 2 * kSide;
  static constexpr int kBytes = (kScaleOff + (INT8 ? 2 * kTile * 4 : 0) + 1023) / 1024 * 1024;
  static_assert(kBoxBytes == 128 || kBoxBytes == 64, "a swizzle of 128 or 64 bytes");
};

// Where a compute warp keeps its m-tile's query fragments. Up to D = 128
// in registers, read once: D / 4 registers a thread. At D = 256 they would
// take 64 registers beside the 128 of the output accumulator and the 32 of
// a step's scores, past the 224 a thread of a GP = 8 CTA (288 threads) may
// hold, so the CTA copies its queries into shared memory once and each
// QK^T k-step pair reads its fragments there (8 registers a thread).
template <int D>
struct QFrags {
  static constexpr bool kInSmem = D > 128;
  // a row of D bf16 plus 16 bytes: 8 rows at one column hit 8 different
  // 4-bank groups (stride 132 words), so a warp's fragment read is
  // conflict-free
  static constexpr int kRowBytes = 2 * D + 16;
};

// Dynamic shared memory of a CTA: the key groups' rings, then (at D = 256)
// the queries, [kRows][QFrags::kRowBytes]; the rings are reused after the
// loop for the merge of the groups' states ([kKG][kRows] m and l, then
// [kKG][kRows][D] acc, f32); plus alignment slack. At D = 256 in bf16 that
// is at most 192 KB of rings (two key groups, GP <= 4: 16 KB of queries)
// or 96 KB and 33 KB of queries (one key group, GP = 8), under the 227 KB a
// CTA may take.
template <int D, bool INT8, int GP>
struct Smem {
  using Tl = Tiling<GP, D>;
  static constexpr int kRing = Stage<D, INT8>::kBytes * kStages;
  static constexpr int kQ = QFrags<D>::kInSmem ? Tl::kRows * QFrags<D>::kRowBytes : 0;
  static constexpr int kMerge = Tl::kKG * Tl::kRows * (2 + D) * 4;
  static constexpr int kBytes =
      (Tl::kKG * kRing + kQ > kMerge ? Tl::kKG * kRing + kQ : kMerge) + 1024;
  // the static barriers and the reduction's words take the rest
  static_assert(kBytes + 512 <= 227 * 1024, "a CTA takes at most 227 KB of shared memory");
};

// Byte offset of byte c of row r of one side of a stage: box c / kBoxBytes,
// its 16-byte chunk index XOR the row's bits, as TMA's swizzle writes it
// (r & 7 for 128-byte box rows, (r >> 1) & 3 for 64-byte ones).
template <int D, bool INT8>
__device__ __forceinline__ int swz(int r, int c) {
  using St = Stage<D, INT8>;
  const int cb = c % St::kBoxBytes;
  const int x = St::kBoxBytes == 128 ? (r & 7) : ((r >> 1) & 3);
  return (c / St::kBoxBytes) * St::kBoxSmem + r * St::kBoxBytes +
         ((((cb >> 4) ^ x) << 4) | (cb & 15));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One 2-D TMA box into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// One contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory; completion counts on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 2^x by the hardware's approximation (MUFU.EX2; x <= 0 here, results below
// 2^-126 flush to 0): the softmax's exponentials, in the log2 domain.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16 pair, `lo` in the low half (the lower k or n index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two int8 codes, in bits 0-7 and 16-23 of x (other bits ignored), as a
// bf16 pair, exactly, with two LOP3s and one bf16x2 subtraction: code c
// becomes the bf16 0x4300 | (c & 0x7F), that is 128 + (c & 127), minus 128
// for c >= 0 and 256 for c < 0 (the bf16 0x4300 | sign << 7).
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t x) {
  const uint32_t v = (x & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (x & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b on one m16n8k16 tile: a [16 x 16] bf16 row-major fragment,
// b [16 x 8] bf16 column fragment, c [16 x 8] f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// The head dim of column n (0..7) of output tile dt: plain for bf16 pools;
// int8 pools interleave four tiles over 32 dims, so a lane's column in
// tiles 4q .. 4q + 3 is one 4-byte word of a V row (dims 32q + 4n .. +3).
template <bool INT8>
__device__ __forceinline__ int out_col(int dt, int n) {
  return INT8 ? (dt / 4) * 32 + n * 4 + dt % 4 : dt * 8 + n;
}

// The ragged row map and the split, as the kernels read them.
struct RowMap {
  const int* page_table;
  const int* kv_lens;
  const int* row_starts;
  const int* row_lens;
  const int* block_rows;
  const int* block_q0;
  int n_blocks, n_rows, pages_per_seq, capacity, splits, span;
};

// Partials of a call: acc [R, Hkv, S, kQB, G, D] f32 (unnormalised), m and
// l [R, Hkv, S, kQB, G] f32 (m in log2 units).
struct Partials {
  float* acc;
  float* m;
  float* l;
};

// What every CTA of a launch reads of the whole row map to decide its
// splits: the keys of the longest prefill chunk (a row of more than kQB
// queries), or 0, and the number of short rows (1..kQB queries) holding
// more than kSplitMinSpans spans' keys. Called by every thread of a CTA of
// kThreads threads; `red` holds two ints per warp.
struct LaunchFacts {
  int chunk;
  int long_rows;
};

template <int kThreads>
__device__ __forceinline__ LaunchFacts launch_facts(const RowMap& m, int (*red)[2]) {
  int keys = 0, rows = 0;
  for (int r = threadIdx.x; r < m.n_rows; r += kThreads) {
    const int n = m.row_lens[r];
    const int bound = max(0, min(m.kv_lens[r], m.capacity));
    if (n > kQB) {
      keys = max(keys, bound);
    } else if (n >= 1 && bound > static_cast<long long>(kSplitMinSpans) * m.span) {
      ++rows;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    keys = max(keys, __shfl_xor_sync(0xffffffffu, keys, o));
    rows += __shfl_xor_sync(0xffffffffu, rows, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5][0] = keys;
    red[threadIdx.x >> 5][1] = rows;
  }
  __syncthreads();
  LaunchFacts f{0, 0};
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    f.chunk = max(f.chunk, red[w][0]);
    f.long_rows += red[w][1];
  }
  return f;
}

// A row's split: n spans of `width` keys each (the last may be shorter),
// or n = 1 (not split). Only a row of 1..kQB live queries whose one live
// block is the block row_starts names (start is its flat start; blk_row /
// blk_q0 that block's map entries) splits, and only when its keys exceed
// both kSplitMinSpans spans and a span past the launch's longest prefill
// chunk: a shorter row's one CTA takes no longer than the split's fixed
// cost (the combine grid and the partials' round trip), and a chunk's q
// blocks bound the launch anyway. It is cut into at most
// ceil(keys / span) spans, and at most max(2, kSplitCtas / (long rows *
// hkv)), of equal width rounded up to kSpanQuantum: many long rows take
// few long spans, one or two take spans of `span`. Timings on an H100
// (PERF.md, scripts/ragged_split_profile.py) chose both constants. The
// row's CTAs and the combine pass the same facts, so they agree.
struct Split {
  int n;
  int width;
};

__device__ __forceinline__ Split row_split(const RowMap& m, int r, int row_len, int kv_len,
                                           int start, int blk_row, int blk_q0,
                                           const LaunchFacts& f, int hkv) {
  const Split whole{1, 0};
  if (row_len < 1 || row_len > kQB || start < 0 || (start & (kQB - 1)) != 0 ||
      start / kQB >= m.n_blocks || blk_row != r || blk_q0 != 0) {
    return whole;
  }
  const int bound = max(0, min(kv_len, m.capacity));
  if (bound <= max(static_cast<long long>(f.chunk) + m.span,
                   static_cast<long long>(kSplitMinSpans) * m.span)) {
    return whole;
  }
  const int cap = max(2, kSplitCtas / max(1, f.long_rows * hkv));
  const int n = min((bound + m.span - 1) / m.span, cap);
  const int width = ((bound + n - 1) / n + kSpanQuantum - 1) / kSpanQuantum * kSpanQuantum;
  return Split{(bound + width - 1) / width, width};
}

// One query's draft-tree visibility: `plain` (no tree mask), or the
// allowed in-row offsets 0..63 as bits of `allow`, with `wide` set when its
// list also names offsets past 63 (found by scanning `anc`).
struct TreeRow {
  bool plain;
  bool wide;
  unsigned long long allow;
  const int* anc;
};

template <int D, bool INT8, int GP, bool TREE>
__global__ void __launch_bounds__(Tiling<GP, D>::kThreads)
    ragged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                            const RowMap map, const int* __restrict__ tree_anc,
                            __nv_bfloat16* __restrict__ out, Partials part, int hkv, int groups,
                            int n_pages, int page_shift, int tree_width, float score_scale) {
  using Tl = Tiling<GP, D>;
  using St = Stage<D, INT8>;
  using Qf = QFrags<D>;
  constexpr int kKG = Tl::kKG;
  constexpr int kKSteps = D / 16;  // QK^T k-steps over the head dim
  constexpr int kDT = D / 8;       // 8-column output tiles
  constexpr int kNT = kChunk / 8;  // 8-key score tiles per step
  static_assert(kTile == 16, "PV takes one 16-key k-step per stage");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full_bars[kKG * kStages];
  __shared__ __align__(8) uint64_t empty_bars[kKG * kStages];
  __shared__ int facts_red[Tl::kThreads / 32][2];

  // launched as a programmatic dependent (launch_dependent): wait for the
  // stream's previous kernel before touching global memory; then let the
  // combine kernel be scheduled (it waits for this grid to finish)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int h = blockIdx.y;
  const int tid = threadIdx.x;

  // which block, row and span this CTA takes (the first reads of the row
  // map are issued ahead of the launch-wide reduction, which overlaps them)
  int blk = -1, row = -1, split = 0, q0 = 0, row_len = 0, kv_len = 0, start = -1;
  Split sp{1, 0};
  if (static_cast<int>(blockIdx.x) < map.n_blocks) {
    blk = blockIdx.x;
    row = map.block_rows[blk];
    q0 = map.block_q0[blk];
  } else {
    const int i = blockIdx.x - map.n_blocks;
    row = i / (map.splits - 1);
    split = 1 + i % (map.splits - 1);
    row_len = map.row_lens[row];
    kv_len = map.kv_lens[row];
    start = map.row_starts[row];
  }
  const LaunchFacts facts = launch_facts<Tl::kThreads>(map, facts_red);
  if (split == 0) {
    if (row >= 0 && row < map.n_rows) {
      row_len = map.row_lens[row];
      kv_len = map.kv_lens[row];
      start = map.row_starts[row];
      if (start == blk * kQB) {
        sp = row_split(map, row, row_len, kv_len, start, row, q0, facts, hkv);
      }
    }
  } else {
    if (start >= 0 && (start & (kQB - 1)) == 0 && start / kQB < map.n_blocks) {
      blk = start / kQB;
      sp = row_split(map, row, row_len, kv_len, start, map.block_rows[blk], map.block_q0[blk],
                     facts, hkv);
    }
    if (split >= sp.n) return;  // past the row's spans, or a row that does not split
  }
  const bool direct = sp.n == 1;  // this CTA writes the block's output itself
  const int base = kv_len - row_len;  // absolute position of the row's query 0
  // the keys this CTA walks, [t_begin, t_end), and the causal bound of the
  // block's last live query (tokens past the table's capacity do not exist,
  // as in the reference)
  int t_begin = 0, t_end = 0, key_bound = 0;
  if (!direct) {
    key_bound = max(0, min(kv_len, map.capacity));
    t_begin = split * sp.width;
    t_end = min(t_begin + sp.width, key_bound);
  } else if (q0 < row_len) {
    key_bound = max(0, min(min(kv_len, base + q0 + kQB), map.capacity));
    t_end = key_bound;
  }
  if (direct && t_end == 0) {
    // an unowned block, a block with no live query or no key: zeros
    constexpr int kVecs = D / 8;  // 16-byte stores per (token, head) row
    for (int c = tid; c < kQB * groups * kVecs; c += Tl::kThreads) {
      const int i = c / (groups * kVecs);
      const int rest = c % (groups * kVecs);
      const size_t tok = static_cast<size_t>(blk) * kQB + i;
      reinterpret_cast<uint4*>(out + (tok * hkv + h) * groups * D)[rest] =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool producer = warp == Tl::kWarps;  // the copy warp
  const int mt = producer ? Tl::kMT : warp % Tl::kMT;  // a compute warp's 16-row m-tile
  const int kg = producer ? 0 : warp / Tl::kMT;        // and key group
  const int gid = lane >> 2;      // mma fragment row (and row + 8)
  const int tig = lane & 3;       // mma fragment column pair
  const int page_size = 1 << page_shift;
  // live queries of the block, and the m-tiles that hold them
  const int nq = q0 < row_len ? min(kQB, row_len - q0) : 0;
  const int live_mt = min(Tl::kMT, (nq * GP + 15) / 16);
  const int n_chunks = (t_end - t_begin + kChunk - 1) / kChunk;
  // key group g's steps: 32-key chunks c = g, g + kKG, ..., each two
  // 16-key stages (a second stage wholly past the range is neither fetched
  // nor read)
  auto steps_of = [&](int g) { return n_chunks > g ? (n_chunks - g + kKG - 1) / kKG : 0; };
  const int my_steps = steps_of(kg);
  const bool consumer = mt < live_mt;
  constexpr int kSteps = kStages / 2;  // steps in flight per key group

  unsigned char* stages = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  auto ring_of = [&](int g) { return stages + g * kStages * St::kBytes; };
  unsigned char* ring = ring_of(kg);
  const uint32_t full0 = smem_u32(&full_bars[kg * kStages]);
  const uint32_t empty0 = smem_u32(&empty_bars[kg * kStages]);
  if (tid == 0) {
    for (int s = 0; s < kKG * kStages; ++s) {
      mbar_init(smem_u32(&full_bars[s]), 1);
      mbar_init(smem_u32(&empty_bars[s]), live_mt);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // at D = 256, the block's (query, head) rows into shared memory after the
  // rings, 16 bytes a thread at a time (rows past the block's and heads
  // past `groups` are zero)
  unsigned char* const q_smem = stages + kKG * kStages * St::kBytes;
  if constexpr (Qf::kInSmem) {
    constexpr int kVecs = D / 8;  // 16-byte pieces of a row
    for (int c = tid; c < Tl::kRows * kVecs; c += Tl::kThreads) {
      const int r = c / kVecs;
      const int v = c % kVecs;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < Tl::kM && r % GP < groups) {
        const size_t tok = static_cast<size_t>(blk) * kQB + r / GP;
        x = reinterpret_cast<const uint4*>(q + ((tok * hkv + h) * groups + r % GP) * D)[v];
      }
      *reinterpret_cast<uint4*>(q_smem + r * Qf::kRowBytes + v * 16) = x;
    }
  }
  __syncthreads();

  // this thread's two fragment rows (lo, hi = lo + 8) of the warp's m-tile
  const int r_lo = mt * 16 + gid;
  const int r_hi = r_lo + 8;
  auto live_row = [&](int r) { return r < Tl::kM && r % GP < groups && q0 + r / GP < row_len; };
  // keys t < limit are visible to the row's query; 0 for dead rows
  auto limit = [&](int r) -> int {
    return live_row(r) ? min(base + q0 + r / GP + 1, key_bound) : 0;
  };
  const int lim_lo = limit(r_lo);
  const int lim_hi = limit(r_hi);

  // draft-tree rows: each fragment row's ancestor list, read once
  auto tree_row = [&](int r) -> TreeRow {
    TreeRow t{true, false, 0ull, nullptr};
    if (!live_row(r)) return t;  // dead row: limit 0
    const int* a = tree_anc + (static_cast<size_t>(blk) * kQB + r / GP) * tree_width;
    if (a[0] == -2) return t;
    t.plain = false;
    t.anc = a;
    for (int i = 0; i < tree_width; ++i) {
      const int off = a[i];
      if (off >= 0 && off < 64) {
        t.allow |= 1ull << off;
      } else if (off >= 64) {
        t.wide = true;
      }
    }
    return t;
  };
  TreeRow tr_lo{true, false, 0ull, nullptr};
  TreeRow tr_hi{true, false, 0ull, nullptr};
  if constexpr (TREE) {
    // only a range that reaches the row's own keys tests a tree: the spans
    // of a verify row's history read no ancestor list
    if (consumer && t_end > base) {
      tr_lo = tree_row(r_lo);
      tr_hi = tree_row(r_hi);
    }
  }
  // key t, inside a fragment row's causal limit, passes its tree mask
  auto tree_visible = [&](int t, const TreeRow& m) -> bool {
    if (m.plain) return true;
    const int off = t - base;  // in-row offset; < 0 is the row's history
    if (off < 0) return true;
    if (off < 64) return (m.allow >> off) & 1ull;
    if (!m.wide) return false;
    for (int i = 0; i < tree_width; ++i) {
      if (m.anc[i] == off) return true;
    }
    return false;
  };

  const int* table = map.page_table + static_cast<size_t>(row) * map.pages_per_seq;
  const int head_rows = h * n_pages * page_size;  // < 2^31: checked on the host
  // Start the copies of group g's i-th step into its stages 2 (i % kSteps)
  // and + 1 (each stage's 16 pool rows as kBoxes TMA boxes a side, and for
  // int8 its 16 K and V scales), once the group's warps have freed them
  // (step i - kSteps). Called by the whole copy warp with i = 0, 1, 2, ...
  // in order per group; lane 0 issues. `pages` holds, one stage per lane,
  // the pages of the group's next 16 steps, read together (a read before
  // each copy would add a round trip to each).
  auto fetch = [&](int g, int i, int& pages) {
    const int g_steps = steps_of(g);
    if ((i & 15) == 0) {
      const int j = i + (lane >> 1);
      const int t = t_begin + (g + j * kKG) * kChunk + (lane & 1) * kTile;
      pages = j < g_steps && t < t_end ? table[t >> page_shift] : 0;
    }
    const int page0 = __shfl_sync(0xffffffffu, pages, (i & 15) * 2);
    const int page1 = __shfl_sync(0xffffffffu, pages, (i & 15) * 2 + 1);
    if (lane != 0) return;
    const int t0 = t_begin + (g + i * kKG) * kChunk;
    const uint32_t g_full0 = smem_u32(&full_bars[g * kStages]);
    const uint32_t g_empty0 = smem_u32(&empty_bars[g * kStages]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int th = t0 + half * kTile;
      if (th >= t_end) break;
      const int st = 2 * (i % kSteps) + half;
      if (i >= kSteps) mbar_wait(g_empty0 + 8 * st, ((i / kSteps) + 1) & 1);
      const int row0 =
          head_rows + ((half ? page1 : page0) << page_shift) + (th & (page_size - 1));
      const uint32_t bar = g_full0 + 8 * st;
      mbar_expect_tx(bar, 2 * St::kSide + (INT8 ? 2 * kTile * 4 : 0));
      const uint32_t dst = smem_u32(ring_of(g) + st * St::kBytes);
#pragma unroll
      for (int bx = 0; bx < St::kBoxes; ++bx) {
        tma_load_2d(dst + bx * St::kBoxSmem, &kmap, bar, bx * St::kBoxInner, row0);
        tma_load_2d(dst + St::kSide + bx * St::kBoxSmem, &vmap, bar, bx * St::kBoxInner, row0);
      }
      if constexpr (INT8) {
        bulk_copy(dst + St::kScaleOff, k_scale + row0, kTile * 4, bar);
        bulk_copy(dst + St::kScaleOff + kTile * 4, v_scale + row0, kTile * 4, bar);
      }
    }
  };
  // the m-tile's rows as mma A fragments, for every k-step of D (dead rows
  // and heads past `groups` are zero). A k-step's 16 head dims are taken in
  // the order the B fragments hold them: bf16 K comes by ldmatrix in plain
  // order (pairs tig*2, +1 and tig*2 + 8, +9); an int8 lane reads one 32-bit
  // word of dims tig*4 .. tig*4 + 3, so its fragment pairs are those.
  uint32_t qf[Qf::kInSmem ? 1 : kKSteps][4];
  if constexpr (!Qf::kInSmem) {
    auto q_row = [&](int r) -> const __nv_bfloat16* {
      if (!consumer || r >= Tl::kM || r % GP >= groups) return nullptr;
      const size_t tok = static_cast<size_t>(blk) * kQB + r / GP;
      return q + ((tok * hkv + h) * groups + r % GP) * D;
    };
    const __nv_bfloat16* qlo = q_row(r_lo);
    const __nv_bfloat16* qhi = q_row(r_hi);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int c0 = ks * 16 + (INT8 ? tig * 4 : tig * 2);
      const int c1 = c0 + (INT8 ? 2 : 8);
      qf[ks][0] = qlo ? *reinterpret_cast<const uint32_t*>(qlo + c0) : 0u;
      qf[ks][1] = qhi ? *reinterpret_cast<const uint32_t*>(qhi + c0) : 0u;
      qf[ks][2] = qlo ? *reinterpret_cast<const uint32_t*>(qlo + c1) : 0u;
      qf[ks][3] = qhi ? *reinterpret_cast<const uint32_t*>(qhi + c1) : 0u;
    }
  }

  if (producer) {
    // the copy warp walks the groups' steps in turn, each refill waiting
    // for its stages to be freed; the compute warps never issue a copy
    int pages[kKG] = {};
    for (int i = 0; i < steps_of(0); ++i) {
#pragma unroll
      for (int g = 0; g < kKG; ++g) {
        if (i < steps_of(g)) fetch(g, i, pages[g]);
      }
    }
  }

  float m_lo = -INFINITY, m_hi = -INFINITY;  // running maxima (log2 units)
  float l_lo = 0.f, l_hi = 0.f;
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  }

  for (int i = 0; consumer && i < my_steps; ++i) {
    const int t0 = t_begin + (kg + i * kKG) * kChunk;
    const int rows = min(kChunk, t_end - t0);  // keys of the step inside the range
    const bool two = rows > kTile;             // its second stage holds keys
    const int st0 = 2 * (i % kSteps);
    const uint32_t parity = (i / kSteps) & 1;
    unsigned char* const stage0 = ring + st0 * St::kBytes;
    unsigned char* const stage1 = stage0 + St::kBytes;
    mbar_wait(full0 + 8 * st0, parity);
    if (two) mbar_wait(full0 + 8 * (st0 + 1), parity);
    __syncwarp();
    if constexpr (!INT8) {
      if (rows != kChunk && rows != kTile) {
        // the range's last step: zero the V rows past it in its last stage
        // (every warp of the group writes the same zeros, each before its
        // own reads)
        unsigned char* last = two ? stage1 : stage0;
        const int valid = two ? rows - kTile : rows;
        for (int c = lane; c < (kTile - valid) * (St::kRowBytes / 16); c += 32) {
          const int r = valid + c / (St::kRowBytes / 16);
          const int col = c % (St::kRowBytes / 16);
          *reinterpret_cast<uint4*>(last + St::kSide + swz<D, INT8>(r, col * 16)) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        // order these writes before the TMA that refills the stage
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
      }
    }

    // scores S = Q K^T, [16 rows x 32 keys]: score tile nt holds keys nt*8
    // .. +7, rows (nt & 1) * 8 .. of stage nt / 2; for bf16 pools odd
    // k-steps sum into s2, so two mma chains run side by side per tile (int8
    // pools, whose widening already interleaves with the chain, keep one)
    float s[kNT][4], s2[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s2[nt][e] = 0.f;
    }
    if constexpr (Qf::kInSmem) {
      // a k-step pair's query fragments from shared memory, then every
      // score tile's mma of those k-steps: the tiles' chains interleave,
      // so one chain a tile (s2 stays zero)
      const unsigned char* const q_lo = q_smem + r_lo * Qf::kRowBytes;
      const unsigned char* const q_hi = q_smem + r_hi * Qf::kRowBytes;
      auto q_frag = [&](int ks, uint32_t(&f)[4]) {
        const int c0 = 2 * (ks * 16 + (INT8 ? tig * 4 : tig * 2));
        const int c1 = c0 + (INT8 ? 4 : 16);
        f[0] = *reinterpret_cast<const uint32_t*>(q_lo + c0);
        f[1] = *reinterpret_cast<const uint32_t*>(q_hi + c0);
        f[2] = *reinterpret_cast<const uint32_t*>(q_lo + c1);
        f[3] = *reinterpret_cast<const uint32_t*>(q_hi + c1);
      };
#pragma unroll 1
      for (int kp = 0; kp < kKSteps / 2; ++kp) {
        uint32_t qa[4], qb[4];
        q_frag(2 * kp, qa);
        q_frag(2 * kp + 1, qb);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (nt >= 2 && !two) continue;
          const unsigned char* stage = nt < 2 ? stage0 : stage1;
          const int kr = (nt & 1) * 8;
          if constexpr (INT8) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const uint32_t w = __byte_perm(
                  *reinterpret_cast<const uint32_t*>(
                      stage + swz<D, INT8>(kr + gid, (2 * kp + j) * 16 + tig * 4)),
                  0u, 0x3120u);
              mma_bf16(s[nt], j ? qb : qa, i8pair_to_bf16x2(w), i8pair_to_bf16x2(w >> 8));
            }
          } else {
            uint32_t bfr[4];
            ldmatrix_x4(bfr, smem_u32(stage) +
                                 swz<D, INT8>(kr + (lane & 7), kp * 64 + (lane >> 3) * 16));
            mma_bf16(s[nt], qa, bfr[0], bfr[1]);
            mma_bf16(s[nt], qb, bfr[2], bfr[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt >= 2 && !two) continue;
        const unsigned char* stage = nt < 2 ? stage0 : stage1;
        const int kr = (nt & 1) * 8;
        if constexpr (INT8) {
#pragma unroll
          for (int ks = 0; ks < kKSteps; ++ks) {
            // codes c0..c3 of dims tig*4 ..: bytes (c0, c2, c1, c3), so the
            // pairs (c0, c1) and, shifted by 8, (c2, c3) sit in bits 0-7, 16-23
            const uint32_t w = __byte_perm(
                *reinterpret_cast<const uint32_t*>(stage + swz<D, INT8>(kr + gid,
                                                                        ks * 16 + tig * 4)),
                0u, 0x3120u);
            mma_bf16(s[nt], qf[ks], i8pair_to_bf16x2(w), i8pair_to_bf16x2(w >> 8));
          }
        } else {
          // matrices j = 0..3: keys kr.. x head-dim columns 8j.. of a
          // 32-column slab: the B fragments of two k-steps
#pragma unroll
          for (int kp = 0; kp < kKSteps / 2; ++kp) {
            uint32_t bfr[4];
            ldmatrix_x4(bfr, smem_u32(stage) +
                                 swz<D, INT8>(kr + (lane & 7), kp * 64 + (lane >> 3) * 16));
            mma_bf16(s[nt], qf[2 * kp], bfr[0], bfr[1]);
            mma_bf16(s2[nt], qf[2 * kp + 1], bfr[2], bfr[3]);
          }
        }
      }
    }

    // scale (log2 units), mask past each row's causal limit (and, in a step
    // that holds in-row keys, by the tree of a row that has one), online
    // softmax in f32; a key the tree masks is -inf here, so its probability
    // below is 0
    const bool tree_step = TREE && t0 + kChunk > base && !(tr_lo.plain && tr_hi.plain);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = nt * 8 + tig * 2 + e;  // key column in the step
        const int t = t0 + kc;
        float a = (s[nt][e] + s2[nt][e]) * score_scale;
        float b = (s[nt][2 + e] + s2[nt][2 + e]) * score_scale;
        if constexpr (INT8) {
          const float k_s =
              reinterpret_cast<const float*>((nt < 2 ? stage0 : stage1) + St::kScaleOff)[kc % kTile];
          a *= k_s;
          b *= k_s;
        }
        bool vis_lo = t < lim_lo;
        bool vis_hi = t < lim_hi;
        if (tree_step) {
          vis_lo = vis_lo && tree_visible(t, tr_lo);
          vis_hi = vis_hi && tree_visible(t, tr_hi);
        }
        s[nt][e] = vis_lo ? a : -INFINITY;
        s[nt][2 + e] = vis_hi ? b : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[nt][e]);
        mx_hi = fmaxf(mx_hi, s[nt][2 + e]);
      }
    }
    // a row's values live in the four lanes of one quad
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
    }
    // finite even for a row with no visible key yet (its l stays 0)
    const float mn_lo = fmaxf(m_lo, fmaxf(mx_lo, -1e30f));
    const float mn_hi = fmaxf(m_hi, fmaxf(mx_hi, -1e30f));
    const float corr_lo = exp2_approx(m_lo - mn_lo);
    const float corr_hi = exp2_approx(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + nt * 8 + tig * 2 + e;
        s[nt][e] = t < lim_lo ? exp2_approx(s[nt][e] - mn_lo) : 0.f;
        s[nt][2 + e] = t < lim_hi ? exp2_approx(s[nt][2 + e] - mn_hi) : 0.f;
        sum_lo += s[nt][e];
        sum_hi += s[nt][2 + e];
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o);
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
    // rescale the sums only when a row's maximum moved (once a long row's
    // maximum settles, most steps skip it)
    if (__any_sync(0xffffffffu, corr_lo != 1.f || corr_hi != 1.f)) {
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        acc[dt][0] *= corr_lo;
        acc[dt][1] *= corr_lo;
        acc[dt][2] *= corr_hi;
        acc[dt][3] *= corr_hi;
      }
    }

    // O += P V, one 16-key k-step per stage: the probabilities (int8: times
    // the key's V scale, 0 past the range) become its A fragment
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half == 1 && !two) break;
      const unsigned char* stage = half ? stage1 : stage0;
      float vs0 = 1.f, vs1 = 1.f, vs8 = 1.f, vs9 = 1.f;
      if constexpr (INT8) {
        const float* vs_s = reinterpret_cast<const float*>(stage + St::kScaleOff) + kTile;
        const int valid = rows - half * kTile;
        const int kc = tig * 2;
        vs0 = kc < valid ? vs_s[kc] : 0.f;
        vs1 = kc + 1 < valid ? vs_s[kc + 1] : 0.f;
        vs8 = kc + 8 < valid ? vs_s[kc + 8] : 0.f;
        vs9 = kc + 9 < valid ? vs_s[kc + 9] : 0.f;
      }
      const float(&p0)[4] = s[2 * half];
      const float(&p1)[4] = s[2 * half + 1];
      const uint32_t pa[4] = {pack_bf16(p0[0] * vs0, p0[1] * vs1),
                              pack_bf16(p0[2] * vs0, p0[3] * vs1),
                              pack_bf16(p1[0] * vs8, p1[1] * vs9),
                              pack_bf16(p1[2] * vs8, p1[3] * vs9)};
      if constexpr (INT8) {
        // a lane reads 32-bit words of its four key rows (tig*2, +1, +8,
        // +9): output tile dt's column gid is head dim out_col(dt, gid), so
        // the word at dims 32*(dt/4) + 4*gid serves the lane's column in
        // tiles 4*(dt/4) .. +3
        const unsigned char* vt = stage + St::kSide;
        auto word = [&](int r, int c) {
          return *reinterpret_cast<const uint32_t*>(vt + swz<D, INT8>(r, c));
        };
#pragma unroll
        for (int dq = 0; dq < kDT / 4; ++dq) {
          const int c = dq * 32 + gid * 4;
          const uint32_t w0 = word(tig * 2, c), w1 = word(tig * 2 + 1, c);
          const uint32_t w8 = word(tig * 2 + 8, c), w9 = word(tig * 2 + 9, c);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // byte j of two rows into bits 0-7 and 16-23
            const uint32_t sel = j | ((4 + j) << 8);
            mma_bf16(acc[4 * dq + j], pa, i8pair_to_bf16x2(__byte_perm(w0, w1, sel)),
                     i8pair_to_bf16x2(__byte_perm(w8, w9, sel)));
          }
        }
      } else {
        // transposed matrices: keys 8*(j & 1).. x columns of output tiles
        // dp*2 + (j >> 1): the B fragments of two output tiles
        const uint32_t v0 = smem_u32(stage + St::kSide);
        const int vr = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, v0 + swz<D, INT8>(vr, dp * 32 + (lane >> 4) * 16));
          mma_bf16(acc[2 * dp], pa, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
        }
      }
    }
    __syncwarp();  // every lane is done with this step's stages
    if (lane == 0) {
      mbar_arrive(empty0 + 8 * st0);
      if (two) mbar_arrive(empty0 + 8 * (st0 + 1));
    }
  }

  // merge the key groups' states in group order (the rings are free: every
  // copy started has been waited for)
  __syncthreads();
  float* m_w = reinterpret_cast<float*>(stages);  // [kKG][kRows]
  float* l_w = m_w + kKG * Tl::kRows;             // [kKG][kRows]
  float* a_w = l_w + kKG * Tl::kRows;             // [kKG][kRows][D]
  if (!producer) {
    const int w_lo = kg * Tl::kRows + r_lo;
    const int w_hi = kg * Tl::kRows + r_hi;
    if (tig == 0) {
      m_w[w_lo] = m_lo;
      l_w[w_lo] = l_lo;
      m_w[w_hi] = m_hi;
      l_w[w_hi] = l_hi;
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = out_col<INT8>(dt, tig * 2 + e);
        a_w[w_lo * D + col] = acc[dt][e];
        a_w[w_hi * D + col] = acc[dt][2 + e];
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < Tl::kM * (D / 4); c += Tl::kThreads) {
    const int r = c / (D / 4);
    const int d = (c % (D / 4)) * 4;
    const int g = r % GP;
    const int i = r / GP;
    if (g >= groups) continue;
    float mx_all = -INFINITY;
#pragma unroll
    for (int k = 0; k < kKG; ++k) {
      if (l_w[k * Tl::kRows + r] > 0.f) mx_all = fmaxf(mx_all, m_w[k * Tl::kRows + r]);
    }
    float l_sum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kKG; ++k) {
      const float lk = l_w[k * Tl::kRows + r];
      if (lk > 0.f) {
        const float wt = exp2_approx(m_w[k * Tl::kRows + r] - mx_all);
        const float4 x = *reinterpret_cast<const float4*>(a_w + (k * Tl::kRows + r) * D + d);
        l_sum += wt * lk;
        a.x += wt * x.x;
        a.y += wt * x.y;
        a.z += wt * x.z;
        a.w += wt * x.w;
      }
    }
    if (direct) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (l_sum > 0.f) o = make_float4(a.x / l_sum, a.y / l_sum, a.z / l_sum, a.w / l_sum);
      const size_t tok = static_cast<size_t>(blk) * kQB + i;
      __nv_bfloat162* orow =
          reinterpret_cast<__nv_bfloat162*>(out + ((tok * hkv + h) * groups + g) * D + d);
      orow[0] = __floats2bfloat162_rn(o.x, o.y);
      orow[1] = __floats2bfloat162_rn(o.z, o.w);
    } else {
      const size_t p =
          ((static_cast<size_t>(row) * hkv + h) * map.splits + split) * kQB * groups +
          i * groups + g;
      *reinterpret_cast<float4*>(part.acc + p * D + d) = a;
      if (d == 0) {
        part.m[p] = mx_all;
        part.l[p] = l_sum;
      }
    }
  }
}

// A split row's output: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M)
// l_s over its spans (M the largest m_s of a live span), merged in split
// order in one pass that rescales as it goes; a query with no live span, and
// the block's dead queries, give zeros. A span with l = 0 (no visible key)
// weighs 0. Every span's partials were written by its CTA, so the loads do
// not depend on each other or on the merge: one L2 round trip, not one per
// span. Rows that do not split exit.
template <int D>
__global__ void __launch_bounds__(kCombineThreads)
    ragged_attention_combine_kernel(const RowMap map, Partials part,
                                    __nv_bfloat16* __restrict__ out, int hkv, int groups) {
  __shared__ int facts_red[kCombineThreads / 32][2];
  const int row = blockIdx.x;
  const int h = blockIdx.y;
  // launched as a programmatic dependent of the attention grid: every CTA
  // waits for that grid (its partials and its direct outputs) before any
  // return, so this grid completes only after it, and a kernel launched as
  // a dependent of this one may read any of `out` once its own wait returns
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const LaunchFacts facts = launch_facts<kCombineThreads>(map, facts_red);
  const int start = map.row_starts[row];
  if (start < 0 || (start & (kQB - 1)) != 0 || start / kQB >= map.n_blocks) return;
  const int blk = start / kQB;
  const int row_len = map.row_lens[row];
  const int spans = row_split(map, row, row_len, map.kv_lens[row], start, map.block_rows[blk],
                              map.block_q0[blk], facts, hkv).n;
  if (spans <= 1) return;
  const size_t row0 = (static_cast<size_t>(row) * hkv + h) * map.splits * kQB * groups;
  const int stride = kQB * groups;  // one span's (query, head) entries
  for (int c = threadIdx.x; c < kQB * groups * (D / 4); c += kCombineThreads) {
    const int i = c / (groups * (D / 4));
    const int g = (c / (D / 4)) % groups;
    const int d = (c % (D / 4)) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < row_len) {
      const size_t p0 = row0 + i * groups + g;
      float mx = -INFINITY, l_sum = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int s = 0; s < spans; ++s) {
        const size_t p = p0 + static_cast<size_t>(s) * stride;
        const float l = __ldcg(part.l + p);
        const float m = __ldcg(part.m + p);
        const float4 x = __ldcg(reinterpret_cast<const float4*>(part.acc + p * D + d));
        if (l > 0.f) {
          const float mn = fmaxf(mx, m);
          const float c_old = exp2_approx(mx - mn);
          const float c_new = exp2_approx(m - mn);
          l_sum = l_sum * c_old + l * c_new;
          a.x = a.x * c_old + x.x * c_new;
          a.y = a.y * c_old + x.y * c_new;
          a.z = a.z * c_old + x.z * c_new;
          a.w = a.w * c_old + x.w * c_new;
          mx = mn;
        }
      }
      if (l_sum > 0.f) o = make_float4(a.x / l_sum, a.y / l_sum, a.z / l_sum, a.w / l_sum);
    }
    const size_t tok = static_cast<size_t>(blk) * kQB + i;
    __nv_bfloat162* orow =
        reinterpret_cast<__nv_bfloat162*>(out + ((tok * hkv + h) * groups + g) * D + d);
    orow[0] = __floats2bfloat162_rn(o.x, o.y);
    orow[1] = __floats2bfloat162_rn(o.z, o.w);
  }
}

constexpr int kMaxDevices = 64;

// Shared memory above 48 KB needs the kernel to opt in, once per device.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// cuTensorMapEncodeTiled (libcuda), looked up at run time, so the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A pool [Hkv, N, P, D] as a 2-D tensor of Hkv * N * P rows of D elements,
// read in boxes of kTile rows by kBoxInner elements with the swizzle of the
// box rows' width (Stage).
template <int D, bool INT8>
cudaError_t pool_map(CUtensorMap* map, const void* pool, long long rows) {
  using St = Stage<D, INT8>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(St::kRowBytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(St::kBoxInner),
                             static_cast<cuuint32_t>(kTile)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(
      map, INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(pool), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      St::kBoxBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The last kMapCacheSize pool maps encoded, per (D, dtype): a map depends
// only on the pool's address and row count (D and the dtype fix the rest),
// so a hit is always right, and an engine's calls (one K and one V pool per
// layer) skip the encoding's host time.
constexpr int kMapCacheSize = 128;

template <int D, bool INT8>
cudaError_t cached_pool_map(CUtensorMap* map, const void* pool, long long rows) {
  struct Entry {
    const void* pool;
    long long rows;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry entries[kMapCacheSize] = {};
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : entries) {
    if (e.pool == pool && e.rows == rows) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = pool_map<D, INT8>(map, pool, rows);
  if (err != cudaSuccess) return err;
  entries[next] = Entry{pool, rows, *map};
  next = (next + 1) % kMapCacheSize;
  return cudaSuccess;
}

// Launches `kernel` as a programmatic dependent of the stream's previous
// kernel: its CTAs may be scheduled while that kernel finishes, and the
// kernel's griddepcontrol.wait, ahead of any global memory access, holds
// them until the previous kernel has completed and its stores are visible.
template <typename... Params, typename... Ts>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                             cudaStream_t stream, Ts... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  const void* tree_anc;
  void* out;
  RowMap map;
  Partials part;
  int hkv, groups, n_pages, page_shift, tree_width;
};

template <int D, bool INT8, int GP, bool TREE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Tl = Tiling<GP, D>;
  constexpr int kSmem = Smem<D, INT8, GP>::kBytes;
  static bool done[kMaxDevices] = {};
  auto kernel = ragged_attention_kernel<D, INT8, GP, TREE>;
  cudaError_t err = opt_in(kernel, kSmem, done);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.hkv) * a.n_pages * (1 << a.page_shift);
  CUtensorMap kmap, vmap;
  err = cached_pool_map<D, INT8>(&kmap, a.k_pool, rows);
  if (err != cudaSuccess) return err;
  err = cached_pool_map<D, INT8>(&vmap, a.v_pool, rows);
  if (err != cudaSuccess) return err;
  const float score_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D))) * kLog2e;
  const dim3 grid(a.map.n_blocks + a.map.n_rows * (a.map.splits - 1), a.hkv);
  err = launch_dependent(kernel, grid, Tl::kThreads, kSmem, stream,
                         static_cast<const __nv_bfloat16*>(a.q), kmap, vmap,
                         static_cast<const float*>(a.k_scale),
                         static_cast<const float*>(a.v_scale), a.map,
                         static_cast<const int*>(a.tree_anc),
                         static_cast<__nv_bfloat16*>(a.out), a.part, a.hkv, a.groups, a.n_pages,
                         a.page_shift, a.tree_width, score_scale);
  if (err != cudaSuccess || a.map.splits == 1 || a.map.n_rows == 0) return err;
  return launch_dependent(ragged_attention_combine_kernel<D>, dim3(a.map.n_rows, a.hkv),
                          kCombineThreads, 0, stream, a.map, a.part,
                          static_cast<__nv_bfloat16*>(a.out), a.hkv, a.groups);
}

template <int D, bool INT8, bool TREE>
cudaError_t launch_g(const Args& a, cudaStream_t stream) {
  if (a.groups <= 1) return launch<D, INT8, 1, TREE>(a, stream);
  if (a.groups <= 2) return launch<D, INT8, 2, TREE>(a, stream);
  if (a.groups <= 4) return launch<D, INT8, 4, TREE>(a, stream);
  return launch<D, INT8, 8, TREE>(a, stream);
}

template <int D, bool INT8>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  return a.tree_anc ? launch_g<D, INT8, true>(a, stream) : launch_g<D, INT8, false>(a, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launches
// (0 on success); the Python wrapper has checked shapes, types and gates.
// tree_anc null selects the plain causal kernel; otherwise tree_width is
// its DMAX (1..64). part_acc [R, Hkv, splits, kQB, G, D] and part_m / part_l
// [R, Hkv, splits, kQB, G] are f32 scratch (null when splits is 1); splits
// and span come from ops/paged_attention.py::ragged_split_plan: span a
// positive multiple of 64 and splits * span covering pages_per_seq *
// page_size, with no split wholly past it.
extern "C" int tpu_torch_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* page_table, const void* kv_lens, const void* row_starts,
    const void* row_lens, const void* block_rows, const void* block_q0, const void* tree_anc,
    void* out, void* part_acc, void* part_m, void* part_l, int n_blocks, int hkv, int groups,
    int head_dim, int n_pages, int page_size, int pages_per_seq, int n_rows, int kv_int8,
    int tree_width, int splits, int span, void* stream) {
  const long long capacity = static_cast<long long>(pages_per_seq) * page_size;
  if (groups < 1 || groups > kMaxG || (page_size != 16 && page_size != 32) ||
      (head_dim != 64 && head_dim != 128 && head_dim != 256) ||
      (tree_anc != nullptr && (tree_width < 1 || tree_width > 64)) || span <= 0 ||
      span % kSpanQuantum != 0 || splits < 1 || static_cast<long long>(splits) * span < capacity ||
      static_cast<long long>(splits - 1) * span >= (capacity > 0 ? capacity : 1) ||
      capacity > 0x7fffffffLL || hkv > 65535 || n_rows < 0 ||
      static_cast<long long>(n_blocks) + static_cast<long long>(n_rows) * (splits - 1) >
          0x7fffffffLL ||
      (splits > 1 && n_rows > 0 && part_acc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks * hkv == 0) return static_cast<int>(cudaSuccess);
  // pool rows are int32 TMA coordinates
  if (static_cast<long long>(hkv) * n_pages * page_size > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // TMA and bulk copies read 16-byte-aligned pools and 64-byte scale
  // segments; outputs and partials take 16-byte stores
  if (!aligned16(k_pool) || !aligned16(v_pool) || !aligned16(out) ||
      (part_acc != nullptr && !aligned16(part_acc)) ||
      (kv_int8 && (!aligned16(k_scale) || !aligned16(v_scale)))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const Args a{q,
               k_pool,
               v_pool,
               k_scale,
               v_scale,
               tree_anc,
               out,
               RowMap{static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
                      static_cast<const int*>(row_starts), static_cast<const int*>(row_lens),
                      static_cast<const int*>(block_rows), static_cast<const int*>(block_q0),
                      n_blocks, n_rows, pages_per_seq, static_cast<int>(capacity), splits, span},
               Partials{static_cast<float*>(part_acc), static_cast<float*>(part_m),
                        static_cast<float*>(part_l)},
               hkv,
               groups,
               n_pages,
               page_size == 16 ? 4 : 5,
               tree_width};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 256) {
    err = kv_int8 ? launch_t<256, true>(a, s) : launch_t<256, false>(a, s);
  } else if (head_dim == 128) {
    err = kv_int8 ? launch_t<128, true>(a, s) : launch_t<128, false>(a, s);
  } else {
    err = kv_int8 ? launch_t<64, true>(a, s) : launch_t<64, false>(a, s);
  }
  return static_cast<int>(err);
}
