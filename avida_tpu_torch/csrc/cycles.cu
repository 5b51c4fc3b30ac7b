// The cycle interpreter for Hopper: every CPU cycle of one update in one
// launch, one thread per organism, each organism's tape and dynamically
// indexed state staged in shared memory where it fits (note 7).
//
// Replaces the Pallas kernel of avida_tpu/ops/pallas_cycles.py
// (_make_kernel and its inner kernel, :382 / :415, launched by
// _launch_packed, run_packed and run_packed_stacked) and computes, bit for
// bit, the function of csrc/cycles_simple.cu, the first port, on the same
// planes (see avida_tpu_torch/ops/cycles.py for the layout and the plain
// PyTorch version both kernels are held to).  No path launches the first
// port; chip_smoke.py times it beside this kernel.
//
// What bounds it.  A launch must read tape_t, ivec and fvec's phenotype
// rows once and write the words it changes: about 0.03 ms at 320x320
// (L = 384) at 3.35 TB/s.  The work is per-organism integer control flow,
// tens of cycles an organism, each a chain of dependent table and tape
// reads ending in a switch that diverges across a warp: read latency and
// divergence set the time, not bytes.  Staging costs a fixed share: the
// whole tile is read (about 0.03 ms of device memory time a 320x320
// launch) where an organism touches a few rows an update, which a young
// population running its ancestor in lockstep does not hide (PERF.md,
// section 6).  There is no matrix product in an integer interpreter, so
// tensor cores and wgmma have no role here.
//
// Design, against what held the first port back:
// 1. A CTA takes C lanes (a template argument: 32, 64 or 128), a divisor
//    of the reference's B-lane block, chosen by the wrapper
//    (ops/cycles.py::cta_plan) so that two CTAs share an SM wherever the
//    tile allows; the first port ran one 512-thread block an SM, 1.5
//    waves at 320x320.  The B/C CTAs of one reference block form a
//    thread block cluster.  The block's two maxima -- the grant that sets
//    the trip count and the bound of the pending-write value row -- are
//    reduced after the cycle loop: each CTA pushes its (trips, bound)
//    pair into every CTA's shared memory (distributed shared memory) and
//    arrives on the split cluster barrier, writes its results back, and
//    waits only then.  The loop itself needs no block-wide value (a
//    lane's cycle count follows from its own grant).  The random stream
//    hashes the lane's offset inside its reference block, as the
//    reference's interpret mode does.
// 2. The CTA's [LP, C] tile of tape_t is staged in shared memory with one
//    cp.async.bulk per row (C contiguous int32) counted on an mbarrier;
//    the stacks and reaction counters come on a second mbarrier, waited
//    for where an instruction first touches them.  Word w of lane t sits
//    at tile[w * C + t], in bank t mod 32 for any w, so a tape read at
//    any head position is one conflict-free shared access instead of a
//    device memory sector per thread.  The written rows go back with
//    coalesced stores, one 32-bit store per lane and row (tape rows
//    tracked in groups, ivec rows by kind).
// 3. h-search is a shift-and matcher: one pass over the tape with a
//    bitmask of label_len bits, four positions per 32-bit shared read,
//    instead of a rescan of the label at every start position.
// 4. The site-flag bitplanes, the stacks, the read label and the reaction
//    counters (ivec rows 38-67 and IV_EXEC_BM..iv_dyn + 4R) are rows of
//    the same tile, loaded with it and written back once; registers, heads
//    and the label under decode are scalars selected without local arrays
//    (ptxas reports no stack frame).
// 5. The opcode and reaction tables and the nop decode come into shared
//    memory with the tile, as two more bulk copies (ops/cycles.py
//    _build_tables gives the layout; the reaction block is sized by R).
// 6. Running a CTA's organisms in order of their grant was measured on
//    the six paths of chip_smoke.py and dropped: the tile column must stay
//    the organism's own, so sorted threads' columns collide in banks, and
//    the ranking costs a pass over the CTA; it was slower on five paths
//    and within 1% on the sixth (PERF.md, section 6).  Thread t runs
//    lane t.
// 7. Any tape height and any reaction count.  Where the whole tile does
//    not fit a CTA's shared memory, the wrapper's plan (ops/cycles.py
//    cta_plan, the template argument S) keeps row groups in device
//    memory and the kernel reads and writes them there in place, through
//    the same accessors: from S = 1 the 4R reaction counters (touched
//    only at IO and divide), from S = 2 the tape words too (a read at a
//    head position is then one sector a lane, and h-search's pass reads
//    the tape from L2 or device memory), from S = 3 the site-flag
//    bitplanes and the reaction table as well.  The read label, the
//    stacks, the opcode tables and the nop decode are staged at every
//    level.  Rows kept in device memory are neither bulk-copied nor
//    counted on an mbarrier, nor written back.  Past 32 reactions
//    (cycles_kernel_wide, held by the second compilation of this
//    source: AVIDA_CYCLES_WIDE, at the end) the reactions are decided 32
//    at a time: the paid bits of reactions 32j..32j+31 are one word, word 0
//    in a register and the rest in a scratch plane the wrapper
//    allocates; each requisite word is read off the counters as they
//    stood at the start of the cycle, and the bonus is then applied
//    reaction by reaction in order.  Up to 32 (cycles_kernel) the IO
//    block is one word of bits and the parameters are those the kernel
//    took before it held any reaction count (PERF.md, section 6,
//    measured both).
//
// Built with -fmad=false: merit and fitness are float32 products that
// must round exactly as the reference's do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef AVIDA_CYCLES_WIDE
#define AVIDA_CYCLES_WIDE 0
#endif

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int IV_MEM_LEN = 0, IV_ACTIVE_STACK = 1, IV_READ_LABEL_LEN = 2,
              IV_INPUT_PTR = 3, IV_INPUT_BUF_N = 4, IV_OUTPUT_BUF = 5,
              IV_TIME_USED = 6, IV_CPU_CYCLES = 7, IV_GEST_START = 8,
              IV_GEST_TIME = 9, IV_EXEC_SIZE = 10, IV_CHILD_COPIED = 11,
              IV_GENERATION = 12, IV_NUM_DIVIDES = 13, IV_OFF_START = 14,
              IV_OFF_LEN = 15, IV_OFF_COPIED = 16, IV_INSTS_EXEC = 17,
              IV_FLAGS = 18, IV_GENOME_LEN = 19, IV_MAX_EXEC = 20,
              IV_GRANTED = 21, IV_COPIED_SIZE = 22, IV_REGS = 23,
              IV_HEADS = 26, IV_SP = 30, IV_INPUT_BUF = 32, IV_INPUTS = 35,
              IV_READ_LABEL = 38, IV_STACKS = 48, IV_PW_POS = 68,
              IV_PW_VAL = 69, IV_PZ_START = 70, IV_PZ_END = 71,
              IV_COST_WAIT = 72, IV_FT_LO = 73, IV_FT_HI = 74,
              IV_OFF_SEX = 75, IV_EXEC_BM = 76;
constexpr int FV_MERIT = 0, FV_CUR_BONUS = 1, FV_FITNESS = 2,
              FV_LAST_BONUS = 3, FV_LAST_MERIT_BASE = 4;
constexpr int FLAG_MAL = 1, FLAG_ALIVE = 2, FLAG_DIVPEND = 4,
              FLAG_STERILE = 8, FLAG_NEWDIV = 16;
constexpr int MOD_REG = 1, MOD_HEAD = 2, MOD_LABEL = 3;
constexpr int SEM_IF_N_EQU = 3, SEM_IF_LESS = 4, SEM_IF_LABEL = 5,
              SEM_MOV_HEAD = 6, SEM_JMP_HEAD = 7, SEM_GET_HEAD = 8,
              SEM_SET_FLOW = 9, SEM_SHIFT_R = 10, SEM_SHIFT_L = 11,
              SEM_INC = 12, SEM_DEC = 13, SEM_PUSH = 14, SEM_POP = 15,
              SEM_SWAP_STK = 16, SEM_SWAP = 17, SEM_ADD = 18, SEM_SUB = 19,
              SEM_NAND = 20, SEM_H_COPY = 21, SEM_H_ALLOC = 22,
              SEM_H_DIVIDE = 23, SEM_IO = 24, SEM_H_SEARCH = 25,
              SEM_H_DIVIDE_SEX = 26;
constexpr int HEAD_IP = 0, HEAD_READ = 1, HEAD_WRITE = 2, HEAD_FLOW = 3;
constexpr int MAX_LABEL = 10;
constexpr int TAB_INSTS = 64;   // table slots per opcode table
constexpr int RX = 16;          // table ints per reaction entry
// opcode tables, TAB_INSTS slots each, in this order (csrc/cycles_simple.cu
// documents the layout); tables 6 and 7, is_nop and nop_mod, reach this
// kernel folded into the nop decode.  Then the reaction block: RX ints a
// reaction (min, max, type, value, the requisite and no-requisite masks'
// first words, 8 words of logic-id mask), then past 32 reactions each
// reaction's further mask words (RW - 1 requisite, RW - 1 no-requisite),
// padded to 4 ints; then the nop decode: a nop's register, -1 for any
// other opcode
constexpr int T_META = 0, T_COST = 1, T_FT_COST = 2, T_ADDL = 3,
              T_PROB_FAIL = 4, T_MUT_CDF = 5, T_REACTIONS = 8;
constexpr int T_OPS = T_REACTIONS * TAB_INSTS;   // the opcode tables' ints
// shared memory: the staged rows, then the staged tables, 8 ints of
// reductions and mbarriers, and the cluster's 8 slots
constexpr int MAX_C = 128;         // lanes per CTA
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int MAX_STAGE = 3;       // staging levels 0-3 (see note 7)
constexpr int LBL_ROWS = 30;       // ivec rows 38-67: read label, stacks
constexpr int SMEM_PER_CTA = 232448;
static_assert(IV_STACKS == IV_READ_LABEL + MAX_LABEL
              && IV_PW_POS == IV_STACKS + 20, "rows 38-67 are one range");
// the staged ivec row groups, as bits of a written-groups mask (the
// site-flag bitplanes are always written back)
constexpr unsigned I_LABEL = 1, I_STACK = 2, I_DYN = 4;

struct Params {
  int n_pad, LP, LW, L0, ni, R, iv_copied, iv_dyn, num_steps;
  int require_alloc, merit_method, inherit_merit, gen_inc, divide_method;
  int min_genome_len, copy_mut_on;
  int has_costs, has_prob_fail, has_addl, weighted_mut;
  float copy_mut_prob, size_range, min_exe_lines, min_copied_lines;
  float default_bonus, const_merit;
  float size_range_inv;     // float32 1 / size_range: XLA's CPU compiler
                            // divides by the constant as this product
  int C, K, rows, gshift;   // CTA lanes, cluster CTAs, staged rows, log2
                            // tape rows per dirty-mask bit
};

// the reaction block's layout for R reactions (ops/cycles.py mask_words,
// reaction_ints, reaction_smem_ints): 32-bit words of a requisite mask,
// the block's ints in the table, its room in shared memory
__host__ __device__ __forceinline__ int mask_words(int R) {
  return (R + 31) / 32;
}

__host__ __device__ __forceinline__ int reaction_ints(int R) {
  return (RX * R + 2 * R * (mask_words(R) - 1) + 3) & ~3;
}

__host__ __device__ __forceinline__ int reaction_smem_ints(int R) {
  return reaction_ints(R) > RX * 32 ? reaction_ints(R) : RX * 32;
}

__device__ __forceinline__ unsigned hash24(unsigned seed, int s, int tag,
                                           unsigned lane) {
  unsigned x = seed + (unsigned)s * 0x9E3779B9u + (unsigned)tag * 40503u
               + lane;
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  return (x ^ (x >> 16)) & 0xFFFFFFu;
}

__device__ __forceinline__ int adjust1(int pos, int mlen) {
  return pos >= mlen ? pos - mlen : pos;
}

// cHeadCPU::fullAdjust on a 32-bit wrapped position
__device__ __forceinline__ int adjust(int pos, int mlen) {
  return pos < 0 ? 0 : pos % mlen;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ unsigned range_mask(int w, int lo, int hi) {
  int lo_w = min(max(lo - 32 * w, 0), 32);
  int hi_w = min(max(hi - 32 * w, 0), 32);
  unsigned m_lo = lo_w >= 32 ? 0u : (0xFFFFFFFFu << lo_w);
  unsigned m_hi = hi_w >= 32 ? 0u : (0xFFFFFFFFu << hi_w);
  return m_lo & ~m_hi;
}

__device__ __forceinline__ int logic_id(unsigned i0, unsigned i1,
                                        unsigned i2, int n_in,
                                        unsigned out) {
  int lo[8];
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    unsigned m = ((c & 1) ? i0 : ~i0) & ((c & 2) ? i1 : ~i1)
                 & ((c & 4) ? i2 : ~i2);
    int cnt = __popc(m), ones = __popc(m & out);
    ok = ok && (ones == 0 || ones == cnt);
    lo[c] = ones > 0;
  }
  if (n_in < 1) lo[1] = lo[0];
  if (n_in < 2) lo[2] = lo[0];
  if (n_in < 2) lo[3] = lo[1];
  if (n_in < 3) {
#pragma unroll
    for (int c = 0; c < 4; ++c) lo[4 + c] = lo[c];
  }
  int logic = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) logic |= lo[c] << c;
  return ok ? logic : -1;
}

// r[i] of three registers without a local array
__device__ __forceinline__ int sel3(int a, int b, int c, int i) {
  return i == 0 ? a : (i == 1 ? b : (i == 2 ? c : 0));
}

__device__ __forceinline__ void set3(int& a, int& b, int& c, int i, int v) {
  if (i == 0) a = v;
  else if (i == 1) b = v;
  else if (i == 2) c = v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(phase) : "memory");
  } while (!done);
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this CTA's shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the cluster barrier, split: arrive (without or with release of this
// thread's writes) and wait (acquiring every other thread's)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the reference block's trip count for largest grant g: g capped by
// num_steps, rounded up to even (two cycles a trip), 0 when nothing runs
__device__ __forceinline__ long long trip_count(int g, int num_steps) {
  const long long b = min((long long)g, (long long)num_steps);
  return b > 0 ? (b + 1) / 2 * 2 : 0;
}

// the largest value of v over the CTA, into *slot (initially 0)
__device__ __forceinline__ void cta_max(int v, int* slot) {
  v = __reduce_max_sync(~0u, v);
  if ((threadIdx.x & 31) == 0) atomicMax(slot, v);
}


// The kernel's body.  C, the CTA's lanes, and S, the staging level (note
// 7), are template arguments: every address of a staged row is then a
// shift and an add, and every row group's address space is known where
// it is read.  kWide (more than 32 reactions) selects the IO block that
// decides reactions 32 at a time; up to 32 the block is one word of
// bits, and the kernel (cycles_kernel) takes the parameters it took
// before it held any reaction count: the wide block's code in the cycle
// loop, and the wide kernel's scratch pointer and plan fields in its
// parameters, each slowed the narrow populations' launches (PERF.md,
// section 6)
template <int C, int S, bool kWide>
__device__ __forceinline__ void
cycles_body(int32_t* __restrict__ tape, int32_t* __restrict__ off,
            int32_t* __restrict__ ivec, float* __restrict__ fvec,
            const int32_t* __restrict__ seeds,
            const int32_t* __restrict__ tab,
            int32_t* __restrict__ scratch, Params P) {
  // which row groups live in shared memory at this level
  constexpr bool kCnt = S < 1;     // the 4R reaction counters
  constexpr bool kTape = S < 2;    // the tape words
  constexpr bool kFlags = S < 3;   // the site-flag bitplanes, the reactions
  extern __shared__ __align__(16) int32_t smem[];
  const size_t N = (size_t)P.n_pad;
  const int R = P.R, LW = P.LW, RW = mask_words(R);
  const int rx_ints = reaction_ints(R);
  int32_t* tile = smem;
  int* s_tab = smem + P.rows * C;
  // the reaction block, staged after the opcode tables or read in the
  // table itself, and the nop decode, staged after the room of the
  // reaction block (32 entries up to 32 reactions: a fixed offset)
  const int rx_smem = kWide ? reaction_smem_ints(R) : RX * 32;
  const int* rx = (kFlags ? s_tab : tab) + T_OPS;
  int* s_nop = s_tab + T_OPS + (kFlags ? rx_smem : 0);
  // [0] the CTA's largest grant, [1] its pending-write bound, [2] tape row
  // groups written, [3] ivec row groups written (I_LABEL, I_STACK, I_DYN);
  // then two mbarriers -- the rows every cycle reads (tape, read label,
  // site flags) with the tables, and the late rows, the stacks and
  // reaction counters, which only some instructions touch -- then one
  // (trips, bound) slot per CTA of the cluster
  int* s_red = s_nop + TAB_INSTS;
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_red + 4);
  uint64_t* bar_late = reinterpret_cast<uint64_t*>(s_red + 6);
  unsigned long long* s_slot =
      reinterpret_cast<unsigned long long*>(s_red + 8);
  // staged rows: the tape words (kTape), ivec rows 38-67, then IV_EXEC_BM
  // onwards: the bitplanes (kFlags) and the counters (kCnt)
  const int R_LBL = kTape ? P.LP : 0, R_STK = R_LBL + MAX_LABEL;
  const int R_EBM = R_LBL + LBL_ROWS, R_DYN = R_EBM + 2 * LW;
  const int t = threadIdx.x;
  const size_t c0 = (size_t)blockIdx.x * C;
  const unsigned rank = blockIdx.x % P.K;          // the CTA in its cluster
  const unsigned seed = (unsigned)seeds[blockIdx.x / P.K];
  const int L = P.LP * 4;
  cg::cluster_group cluster = cg::this_cluster();

  if (t == 0) {
    mbar_init(bar, 1);
    mbar_init(bar_late, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    s_red[0] = s_red[1] = s_red[2] = s_red[3] = 0;
  }
  __syncthreads();
  // the cluster barrier's first phase: this CTA has started (waited on
  // before any CTA writes into another's shared memory)
  cluster_arrive_relaxed();
  // ---- stage the staged rows and the tables: one bulk copy per row,
  // counted on the mbarrier of its kind
  auto row_src = [&](int r) -> const int32_t* {
    return (r < R_LBL ? tape + (size_t)r * N
            : r < R_EBM ? ivec + (size_t)(IV_READ_LABEL + r - R_LBL) * N
                        : ivec + (size_t)(IV_EXEC_BM + r - R_EBM) * N) + c0;
  };
  if (t < 32) {
    const int late_rows = 2 * MAX_LABEL + (kCnt ? 4 * R : 0);
    // the opcode tables with the reaction block where it is staged, and
    // the nop decode
    const uint32_t head_bytes = 4 * (T_OPS + (kFlags ? rx_ints : 0));
    const uint32_t tab_bytes = head_bytes + 4 * TAB_INSTS;
    if (t == 0) {
      mbar_expect_tx(bar, (uint32_t)((P.rows - late_rows) * C * 4)
                              + tab_bytes);
      mbar_expect_tx(bar_late, (uint32_t)(late_rows * C * 4));
    }
    __syncwarp();
    for (int r = t; r < P.rows; r += 32) {
      const bool late = (r >= R_STK && r < R_EBM) || (kCnt && r >= R_DYN);
      bulk_load(tile + r * C, row_src(r), (uint32_t)(C * 4),
                late ? bar_late : bar);
    }
    if (t == 0) {
      bulk_load(s_tab, tab, head_bytes, bar);
      bulk_load(s_nop, tab + T_OPS + rx_ints, 4 * TAB_INSTS, bar);
    }
  }
  const int o = t;                 // the organism of this thread
  const size_t lane = c0 + o;
  const unsigned tlane = rank * C + o;
#define IV(r) ivec[(size_t)(r) * N + lane]
#define FV(r) fvec[(size_t)(r) * N + lane]
#define T(r) tile[(r) * C + o]
  // the row groups a plan may keep in device memory, read and written in
  // place wherever they live: tape word w, bitplane words w, counter k
  // (cur_task r, cur_reaction R + r, last_task 2R + r, exe_total 3R + r)
  auto TW = [&](int w) -> int32_t& {
    if constexpr (kTape) return T(w);
    else return tape[(size_t)w * N + lane];
  };
  auto EBM = [&](int w) -> int32_t& {
    if constexpr (kFlags) return T(R_EBM + w);
    else return IV(IV_EXEC_BM + w);
  };
  auto CBM = [&](int w) -> int32_t& {
    if constexpr (kFlags) return T(R_EBM + LW + w);
    else return IV(P.iv_copied + w);
  };
  auto CNT = [&](int k) -> int32_t& {
    if constexpr (kCnt) return T(R_DYN + k);
    else return IV(P.iv_dyn + k);
  };
  auto tbyte = [&](int pos) -> uint8_t& {
    if constexpr (kTape)
      return reinterpret_cast<uint8_t*>(tile)[4 * ((pos >> 2) * C + o)
                                              + (pos & 3)];
    else
      return reinterpret_cast<uint8_t*>(tape)[
          4 * ((size_t)(pos >> 2) * N + lane) + (pos & 3)];
  };

  // the organism's cycles: its grant, capped by the reference block's
  // trip count, which is its largest grant capped by num_steps and
  // rounded up to even (the reference runs two cycles a trip); a grant
  // above the cap meets the block's trip count, a grant below it never
  // does, so the block's maximum is not needed here
  const int granted = IV(IV_GRANTED);
  const int nexec = granted <= P.num_steps
      ? granted : (int)min((long long)granted,
                           ((long long)P.num_steps + 1) / 2 * 2);
  int mem_len = IV(IV_MEM_LEN), active_stack = IV(IV_ACTIVE_STACK);
  int rl_len = IV(IV_READ_LABEL_LEN), in_ptr = IV(IV_INPUT_PTR);
  int ibuf_n = IV(IV_INPUT_BUF_N), out_buf = IV(IV_OUTPUT_BUF);
  int time_used = IV(IV_TIME_USED), cpu_cycles = IV(IV_CPU_CYCLES);
  int gest_start = IV(IV_GEST_START), gest_time = IV(IV_GEST_TIME);
  int exec_size = IV(IV_EXEC_SIZE), child_copied = IV(IV_CHILD_COPIED);
  int generation = IV(IV_GENERATION), num_divides = IV(IV_NUM_DIVIDES);
  int off_start = IV(IV_OFF_START), off_len = IV(IV_OFF_LEN);
  int off_copied = IV(IV_OFF_COPIED), insts = IV(IV_INSTS_EXEC);
  int flags = IV(IV_FLAGS), gsize = IV(IV_GENOME_LEN);
  int max_exec = IV(IV_MAX_EXEC), copied_sz = IV(IV_COPIED_SIZE);
  int off_sex = IV(IV_OFF_SEX), pw_val = IV(IV_PW_VAL);
  int cost_wait = IV(IV_COST_WAIT);
  unsigned ft_lo = (unsigned)IV(IV_FT_LO), ft_hi = (unsigned)IV(IV_FT_HI);
  int r0 = IV(IV_REGS), r1 = IV(IV_REGS + 1), r2 = IV(IV_REGS + 2);
  int h_ip = IV(IV_HEADS + HEAD_IP), h_rd = IV(IV_HEADS + HEAD_READ);
  int h_wr = IV(IV_HEADS + HEAD_WRITE), h_fl = IV(IV_HEADS + HEAD_FLOW);
  int sp0 = IV(IV_SP), sp1 = IV(IV_SP + 1);
  int ib0 = IV(IV_INPUT_BUF), ib1 = IV(IV_INPUT_BUF + 1);
  int ib2 = IV(IV_INPUT_BUF + 2);
  const int in0 = IV(IV_INPUTS), in1 = IV(IV_INPUTS + 1);
  const int in2 = IV(IV_INPUTS + 2);
  float merit = FV(FV_MERIT), cur_bonus = FV(FV_CUR_BONUS);
  float fitness = FV(FV_FITNESS), last_bonus = FV(FV_LAST_BONUS);
  float last_mb = FV(FV_LAST_MERIT_BASE);

  auto byte_at = [&](int pos) -> int { return tbyte(pos); };
  auto op_at = [&](int pos) -> int {
    return min(byte_at(pos) & 63, P.ni - 1);
  };
  mbar_wait(bar, 0);
  // the late rows: waited for where an instruction first touches them
  bool late_in = false;
  auto need_late = [&]() {
    if (!late_in) {
      mbar_wait(bar_late, 0);
      late_in = true;
    }
  };

  // the memory length and the reach of the tape writes of the lane's
  // last two cycles feed the reference's row-tile bound of the block's
  // final cycle (see the pending-write value row below)
  int last_exec = -1, written = 0, mlen_last = 1, pend_cur = 0,
      pend_before = 0;
  unsigned dirty = 0;             // tape row groups this lane wrote
  unsigned idirty = 0;            // staged ivec row groups it wrote
  for (int s = 0; s < nexec; ++s) {
    if (!(flags & FLAG_ALIVE) || (flags & FLAG_DIVPEND)) break;
    last_exec = s;
    const int mlen = max(mem_len, 1);
    mlen_last = mlen;
    const int ip = h_ip, rp = h_rd, wp = h_wr;
    const int cur_op = op_at(ip);
    const int meta = s_tab[T_META * TAB_INSTS + cur_op];
    const int defop = (meta >> 16) & 0xFF;

    // cost engine: a cost-c instruction waits c - 1 cycles and executes
    // on the last; ft_cost is a one-time surcharge per opcode
    bool eff = true;
    if (P.has_costs) {
      const unsigned ft_bit = cur_op < 32 ? (ft_lo >> cur_op) & 1u
                                          : (ft_hi >> (cur_op - 32)) & 1u;
      const int total = max(s_tab[T_COST * TAB_INSTS + cur_op], 1)
                        + (ft_bit ? 0 : s_tab[T_FT_COST * TAB_INSTS + cur_op]);
      eff = cost_wait == 1 || (cost_wait == 0 && total <= 1);
      cost_wait = cost_wait > 0 ? cost_wait - 1 : (total > 1 ? total - 1 : 0);
      if (eff && !ft_bit) {
        if (cur_op < 32) ft_lo |= 1u << cur_op;
        else ft_hi |= 1u << (cur_op - 32);
      }
    }
    // execution failure: costs paid, flagged executed, the IP advances;
    // the effect and the modifier's consumption are suppressed
    bool failed = false;
    if (P.has_prob_fail && eff) {
      const float u = (float)hash24(seed, s, 2, tlane) * (1.0f / 16777216.0f);
      failed = u < __int_as_float(s_tab[T_PROB_FAIL * TAB_INSTS + cur_op]);
    }
    const int sem = eff && !failed ? (meta & 0xFF) : -1;
    // the modifier keys off execution, not eff (a waiting cycle flags its
    // modifier nop executed too)
    const int mod = failed ? 0 : (meta >> 8) & 0xFF;
    const int next_pos = adjust1(ip + 1, mlen);
    auto window = [&](int k) -> int {
      int p = ip + 1 + k;
      return op_at(p >= mlen ? p - mlen : p);
    };

    // operand (nop modifier) and label: label nop k's complement code in
    // bits 2k..2k+1 of lbl, and the shift-and masks of h-search, bit k of
    // 16-bit field c set where the label's k-th code is c
    bool has_mod = false;
    int operand = defop, consumed = 0, label_len = 0;
    unsigned lbl = 0;
    unsigned long long cmask = 0;
    if (mod == MOD_REG || mod == MOD_HEAD) {
      const int nm = s_nop[window(0)];
      has_mod = nm >= 0;
      if (has_mod) { operand = nm; consumed = 1; }
    } else if (mod == MOD_LABEL) {
      for (int k = 0; k < MAX_LABEL; ++k) {
        if (k + 1 > mlen - 1) break;
        const int v = s_nop[window(k)];
        if (v < 0) break;
        const int c = v >= 2 ? v - 2 : v + 1;
        lbl |= (unsigned)c << (2 * k);
        cmask |= 1ull << (16 * c + k);
        label_len = k + 1;
      }
      consumed = label_len;
    }
    const int val = sel3(r0, r1, r2, operand);
    const int nr = operand + 1;
    const int next_reg = nr >= 3 ? nr - 3 : nr;
    const int val2 = sel3(r0, r1, r2, next_reg);
    const int bx = r1, cx = r2;
    const int hsel0 = mod == MOD_HEAD ? operand : HEAD_IP;
    const int head_sel = hsel0 == HEAD_IP ? h_ip : hsel0 == HEAD_READ ? h_rd
                         : hsel0 == HEAD_WRITE ? h_wr : h_fl;
    const int eff_head_pos = hsel0 == HEAD_IP ? adjust1(ip + consumed, mlen)
                                              : head_sel;
    const int old_len = mlen;
    const int flow0 = h_fl;

    int skip = 0, pz_e = 0;
    bool copy_m = false, alloc_m = false, div_m = false;
    int set_head = -1, set_head_pos = 0;   // head hsel0's new position
    int nh_rd = h_rd, nh_wr = h_wr, nh_fl = h_fl;
    int ip_new = adjust1(adjust1(ip + consumed + 1, mlen), mlen);
    const int read_inst = op_at(rp);
    written = read_inst;

    switch (sem) {
      case SEM_IF_N_EQU: skip = val == val2; break;
      case SEM_IF_LESS: skip = val >= val2; break;
      case SEM_IF_LABEL: {
        bool m = rl_len == label_len;
        for (int k = 0; k < label_len; ++k)
          m = m && T(R_LBL + k) == (int)((lbl >> (2 * k)) & 3u);
        skip = !m;
        break;
      }
      case SEM_MOV_HEAD:
        set_head = hsel0;
        set_head_pos = flow0;
        if (hsel0 == HEAD_IP) ip_new = flow0;
        break;
      case SEM_JMP_HEAD: {
        int jp = adjust(wrap_add(eff_head_pos, cx), mlen);
        set_head = hsel0;
        set_head_pos = jp;
        if (hsel0 == HEAD_IP) ip_new = adjust1(jp + 1, mlen);
        break;
      }
      case SEM_GET_HEAD: r2 = eff_head_pos; break;
      case SEM_SET_FLOW: nh_fl = adjust(val, mlen); break;
      case SEM_SHIFT_R: set3(r0, r1, r2, operand, val >> 1); break;
      case SEM_SHIFT_L:
        set3(r0, r1, r2, operand, (int)((unsigned)val << 1));
        break;
      case SEM_INC: set3(r0, r1, r2, operand, wrap_add(val, 1)); break;
      case SEM_DEC: set3(r0, r1, r2, operand, wrap_add(val, -1)); break;
      case SEM_ADD: set3(r0, r1, r2, operand, wrap_add(bx, cx)); break;
      case SEM_SUB:
        set3(r0, r1, r2, operand, (int)((unsigned)bx - (unsigned)cx));
        break;
      case SEM_NAND: set3(r0, r1, r2, operand, ~(bx & cx)); break;
      case SEM_PUSH: {
        need_late();
        int spa = active_stack != 0 ? sp1 : sp0;
        int sp_push = spa == 0 ? 9 : spa - 1;
        T(R_STK + active_stack * 10 + sp_push) = val;
        idirty |= I_STACK;
        if (active_stack != 0) sp1 = sp_push; else sp0 = sp_push;
        break;
      }
      case SEM_POP: {
        need_late();
        int spa = active_stack != 0 ? sp1 : sp0;
        int slot = R_STK + active_stack * 10 + spa;
        set3(r0, r1, r2, operand, T(slot));
        T(slot) = 0;
        idirty |= I_STACK;
        const int sp_new = spa == 9 ? 0 : spa + 1;
        if (active_stack != 0) sp1 = sp_new; else sp0 = sp_new;
        break;
      }
      case SEM_SWAP_STK: active_stack = 1 - active_stack; break;
      case SEM_SWAP:
        set3(r0, r1, r2, operand, val2);
        set3(r0, r1, r2, next_reg, val);
        break;
      case SEM_H_COPY: {
        copy_m = true;
        if (P.copy_mut_on) {
          float u = (float)hash24(seed, s, 0, tlane) * (1.0f / 16777216.0f);
          if (u < P.copy_mut_prob) {
            const unsigned r = hash24(seed, s, 1, tlane);
            if (P.weighted_mut) {
              // inverse CDF over the float32 cumulative weights
              const float ui = (float)r * (1.0f / 16777216.0f);
              const int* cdf = s_tab + T_MUT_CDF * TAB_INSTS;
              written = 0;
              for (int k = 0; k < P.ni - 1; ++k)
                written += ui >= __int_as_float(cdf[k]);
            } else {
              written = (int)(r % (unsigned)P.ni);
            }
          }
        }
        const int rn = s_nop[read_inst];
        if (rn >= 0) {
          if (rl_len < MAX_LABEL) {
            T(R_LBL + rl_len) = rn;
            rl_len++;
            idirty |= I_LABEL;
          }
        } else {
          rl_len = 0;
        }
        nh_rd = adjust1(rp + 1, mlen);
        nh_wr = adjust1(wp + 1, mlen);
        break;
      }
      case SEM_H_ALLOC: {
        int size = min((int)(P.size_range * (float)old_len), P.L0 - old_len);
        bool ok = size >= 1;
        if (P.require_alloc) ok = ok && !(flags & FLAG_MAL);
        ok = ok && old_len <= (int)((float)size * P.size_range);
        if (ok) {
          alloc_m = true;
          pz_e = old_len + size;
          mem_len = pz_e;
          r0 = old_len;
          flags |= FLAG_MAL;
        }
        break;
      }
      case SEM_H_SEARCH: {
        // shift-and: bit k of D is set at position p where the label's
        // first k + 1 codes spell the tape's codes ending at p; the first
        // p with bit label_len - 1 set ends the first match (a nop's code
        // is its register, any other byte's 3, which no label code is)
        int head = adjust1(ip + label_len, mlen);
        const int ip_after = head;
        if (label_len > 0) {
          const unsigned hit = 1u << (label_len - 1);
          unsigned D = 0;
          bool found = false;
          for (int w = 0; 4 * w < mlen && !found; ++w) {
            const unsigned word = (unsigned)TW(w);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int p = 4 * w + b;
              const unsigned byte = (word >> (8 * b)) & 0xFFu;
              const int c = byte < TAB_INSTS ? (s_nop[byte] & 3) : 3;
              D = ((D << 1) | 1u)
                  & (unsigned)(cmask >> (16 * c)) & 0xFFFFu;
              if (p < mlen && (D & hit) && !found) {
                head = p;
                found = true;
              }
            }
          }
        }
        r1 = head - ip_after;
        r2 = label_len;
        nh_fl = adjust1(head + 1, mlen);
        break;
      }
      case SEM_H_DIVIDE:
      case SEM_H_DIVIDE_SEX: {
        const int parent_size = rp;
        const int child_end = wp == 0 ? mlen : wp;
        const int child_size = child_end - parent_size;
        int exec_count = 0, copied_count = 0;
        const bool ipx = (EBM(ip >> 5) >> (ip & 31)) & 1u;
#pragma unroll 1
        for (int w = 0; w < LW; ++w) {
          exec_count += __popc((unsigned)EBM(w)
                               & range_mask(w, 0, parent_size));
          copied_count += __popc((unsigned)CBM(w)
                                 & range_mask(w, parent_size, child_end));
        }
        if (!ipx && ip < parent_size) exec_count += 1;
        const float fsize = (float)gsize;
        const int min_sz = max(P.min_genome_len,
                               (int)(fsize * P.size_range_inv));
        const int max_sz = min(P.L0, (int)(fsize * P.size_range));
        const bool viable =
            !(flags & FLAG_STERILE) && child_size >= min_sz
            && child_size <= max_sz && parent_size >= min_sz
            && parent_size <= max_sz
            && exec_count >= (int)((float)parent_size * P.min_exe_lines)
            && copied_count >= (int)((float)child_size * P.min_copied_lines);
        if (!viable) break;
        div_m = true;
        off_start = rp;
        off_len = child_size;
        off_sex = sem == SEM_H_DIVIDE_SEX;
        float merit_base;
        const int least = min(min(gsize, copied_sz), exec_count);
        switch (P.merit_method) {
          case 0: merit_base = P.const_merit; break;
          case 1: merit_base = (float)copied_sz; break;
          case 2: merit_base = (float)exec_count; break;
          case 3: merit_base = (float)gsize; break;
          case 4: merit_base = (float)least; break;
          default: merit_base = sqrtf((float)least); break;
        }
        const float new_merit =
            P.inherit_merit ? __fmul_rn(merit_base, cur_bonus) : merit_base;
        const int gestation = time_used + 1 - gest_start;
        merit = new_merit;
        fitness = __fdiv_rn(new_merit, (float)max(gestation, 1));
        gest_time = gestation;
        last_bonus = cur_bonus;
        last_mb = merit_base;
        exec_size = exec_count;
        child_copied = copied_count;
        off_copied = copied_count;
        cur_bonus = P.default_bonus;
        generation += P.gen_inc;
        num_divides += 1;
        break;
      }
      case SEM_IO: {
        const int value_in = sel3(in0, in1, in2, in_ptr % 3);
        const int i0 = ibuf_n > 0 ? ib0 : 0;
        const int i1 = ibuf_n > 1 ? ib1 : 0;
        const int i2 = ibuf_n > 2 ? ib2 : 0;
        const int lid = logic_id(i0, i1, i2, ibuf_n, (unsigned)val);
        float bonus = cur_bonus, add_sum = 0.0f;
        if (lid >= 0) {
          // every requisite reads the counters as they stood at the
          // start of the cycle, so decide all reactions before counting
          need_late();
          if constexpr (!kWide) {
            unsigned done = 0, paid = 0, had = 0;
            for (int d = 0; d < R; ++d)
              if (CNT(R + d) != 0) had |= 1u << d;
            for (int r = 0; r < R; ++r) {
              const int* rt = rx + r * RX;
              if (!((rt[6 + (lid >> 5)] >> (lid & 31)) & 1)) continue;
              done |= 1u << r;
              const int tc = CNT(r);
              if (tc >= rt[0] && tc < rt[1]
                  && ((unsigned)rt[4] & ~had) == 0
                  && ((unsigned)rt[5] & had) == 0)
                paid |= 1u << r;
            }
            if (done) idirty |= I_DYN;
            for (int r = 0; r < R; ++r) {
              if (!((done >> r) & 1u)) continue;
              CNT(r) += 1;
              CNT(3 * R + r) += 1;
              if (!((paid >> r) & 1u)) continue;
              CNT(R + r) += 1;
              const int* rt = rx + r * RX;
              const float v = __int_as_float(rt[3]);
              if (rt[2] == 2) bonus = __fmul_rn(bonus, v);
              else if (rt[2] == 1) {
                if (v != 0.0f) bonus = __fmul_rn(bonus, v);
              }
              else add_sum = __fadd_rn(add_sum, v);
            }
          } else {
            // reactions 32j..32j+31: word j of the paid bits, word 0 in
            // a register, the rest in the scratch plane.  Does reaction
            // r's logic-id mask hold `lid`; are its requisites met on the
            // counters as they stand (the cycle's start: no counter moves
            // before every reaction is decided), a mask word k's
            // reactions read only where the word is not 0
            auto performs = [&](int r) -> bool {
              return (rx[r * RX + 6 + (lid >> 5)] >> (lid & 31)) & 1;
            };
            auto requisites_met = [&](int r) -> bool {
              const int* more = rx + RX * R + 2 * (RW - 1) * r;
#pragma unroll 1
              for (int k = 0; k < RW; ++k) {
                const unsigned req =
                    (unsigned)(k == 0 ? rx[r * RX + 4] : more[k - 1]);
                const unsigned noreq =
                    (unsigned)(k == 0 ? rx[r * RX + 5] : more[RW + k - 2]);
                if (!(req | noreq)) continue;
                unsigned had = 0;
                const int d_end = min(R, 32 * k + 32);
#pragma unroll 1
                for (int d = 32 * k; d < d_end; ++d)
                  if (CNT(R + d) != 0) had |= 1u << (d & 31);
                if ((req & ~had) || (noreq & had)) return false;
              }
              return true;
            };
            bool done = false;
            unsigned paid0 = 0;
#pragma unroll 1
            for (int j = 0; j < RW; ++j) {
              unsigned paid = 0;
              const int r_end = min(R, 32 * j + 32);
#pragma unroll 1
              for (int r = 32 * j; r < r_end; ++r) {
                if (!performs(r)) continue;
                done = true;
                const int tc = CNT(r);
                if (tc >= rx[r * RX] && tc < rx[r * RX + 1]
                    && requisites_met(r))
                  paid |= 1u << (r & 31);
              }
              if (j == 0) paid0 = paid;
              else scratch[(size_t)(j - 1) * N + lane] = (int32_t)paid;
            }
            if (done) idirty |= I_DYN;
            // then count and reward, reaction by reaction in order: the
            // bonus is a chain of float32 products and one sum, never
            // reassociated
#pragma unroll 1
            for (int j = 0; j < RW; ++j) {
              const unsigned paid = j == 0
                  ? paid0 : (unsigned)scratch[(size_t)(j - 1) * N + lane];
              const int r_end = min(R, 32 * j + 32);
#pragma unroll 1
              for (int r = 32 * j; r < r_end; ++r) {
                if (!performs(r)) continue;
                CNT(r) += 1;
                CNT(3 * R + r) += 1;
                if (!((paid >> (r & 31)) & 1u)) continue;
                CNT(R + r) += 1;
                const int* rt = rx + r * RX;
                const float v = __int_as_float(rt[3]);
                if (rt[2] == 2) bonus = __fmul_rn(bonus, v);
                else if (rt[2] == 1) {
                  if (v != 0.0f) bonus = __fmul_rn(bonus, v);
                }
                else add_sum = __fadd_rn(add_sum, v);
              }
            }
          }
        }
        cur_bonus = __fadd_rn(bonus, add_sum);
        in_ptr += 1;
        ib2 = ib1;
        ib1 = ib0;
        ib0 = value_in;
        ibuf_n = min(ibuf_n + 1, 3);
        out_buf = val;
        set3(r0, r1, r2, operand, value_in);
        break;
      }
      default: break;
    }

    // IP, heads, site flags, tape
    if (div_m) ip_new = 0;
    else ip_new = skip ? adjust1(adjust1(ip + consumed + 2, mlen), mlen)
                       : ip_new;
    h_rd = nh_rd;
    h_wr = nh_wr;
    h_fl = nh_fl;
    if (set_head == HEAD_READ) h_rd = set_head_pos;
    else if (set_head == HEAD_WRITE) h_wr = set_head_pos;
    else if (set_head == HEAD_FLOW) h_fl = set_head_pos;
    h_ip = eff ? ip_new : ip;
    if (eff) EBM(ip >> 5) |= 1u << (ip & 31);
    if (has_mod || label_len > 0)
      EBM(next_pos >> 5) |= 1u << (next_pos & 31);
    if (copy_m) {
      CBM(wp >> 5) |= 1u << (wp & 31);
      tbyte(wp) = (uint8_t)written;
      dirty |= 1u << ((wp >> 2) >> P.gshift);
    }
    if (alloc_m) {
#pragma unroll 1
      for (int w = old_len >> 5; w <= (pz_e - 1) >> 5; ++w) {
        const unsigned m = range_mask(w, old_len, pz_e);
        EBM(w) &= ~m;
        CBM(w) &= ~m;
      }
      const int w_lo = old_len >> 2, w_hi = (pz_e - 1) >> 2;
#pragma unroll 1
      for (int w = w_lo; w <= w_hi; ++w) {
        const int lo = max(old_len - 4 * w, 0), hi = min(pz_e - 4 * w, 4);
        const unsigned keep = (lo > 0 ? 0xFFFFFFFFu >> (32 - 8 * lo) : 0u)
                              | (hi < 4 ? 0xFFFFFFFFu << (8 * hi) : 0u);
        TW(w) &= keep;
      }
      dirty |= (0xFFFFFFFFu >> (31 - (w_hi >> P.gshift)))
               & (0xFFFFFFFFu << (w_lo >> P.gshift));
    }
    if (div_m) {
      need_late();
      mem_len = rp;
      h_ip = h_rd = h_wr = h_fl = 0;
      r0 = r1 = r2 = 0;
#pragma unroll 1
      for (int k = 0; k < 20; ++k) T(R_STK + k) = 0;
      sp0 = sp1 = 0;
      active_stack = 0;
      rl_len = 0;
      flags &= ~FLAG_MAL;
      if (P.has_costs) { cost_wait = 0; ft_lo = ft_hi = 0; }
#pragma unroll 1
      for (int w = 0; w < LW; ++w) EBM(w) = CBM(w) = 0;
#pragma unroll 1
      for (int r = 0; r < R; ++r) {
        CNT(2 * R + r) = CNT(r);
        CNT(r) = 0;
        CNT(R + r) = 0;
      }
      flags |= FLAG_DIVPEND | FLAG_NEWDIV;
      idirty |= I_STACK | I_DYN;
    }

    pend_before = pend_cur;
    pend_cur = max(copy_m ? wp + 1 : 0, pz_e);

    // time and death
    time_used += 1;
    // addl_time_cost is charged on eff, failures included
    if (P.has_addl && eff) time_used += s_tab[T_ADDL * TAB_INSTS + cur_op];
    cpu_cycles += 1;
    insts += 1;
    if (div_m) {
      if (P.divide_method != 0) { time_used = 0; cpu_cycles = 0; gest_start = 0; }
      else gest_start = time_used;
    }
    if (max_exec > 0 && time_used >= max_exec) flags &= ~FLAG_ALIVE;
  }

  // The pending-write value row holds the value the reference computed in
  // the block's last cycle, executed or not (pallas_cycles.py:1171).  A
  // lane idle in that cycle read its READ-head word through the
  // reference's row-tile traversal, which covers only the 16-row tiles
  // below the live extent of that cycle's executing lanes and pending
  // writes (pallas_cycles.py:536-586); outside it the word reads 0.  Both
  // the block's trip count and that extent are reduced over the cluster:
  // each CTA computes them as if it were the block ((trips, bound) under
  // its own largest grant), and the block's pair is the largest pair
  // (a CTA whose trip count is below the block's has no lane in the
  // block's last two cycles, so its bound does not count).
  mbar_wait(bar_late, 0);   // every bulk copy has landed before write-back
  cta_max(granted, &s_red[0]);
  __syncthreads();
  const long long trips_cta = trip_count(s_red[0], P.num_steps);
  cta_max(last_exec == trips_cta - 1 ? max(mlen_last, pend_before)
          : last_exec == trips_cta - 2 ? max(1, pend_cur) : 1, &s_red[1]);
  dirty = __reduce_or_sync(~0u, dirty);
  idirty = __reduce_or_sync(~0u, idirty);
  if ((t & 31) == 0) {
    atomicOr(reinterpret_cast<unsigned*>(&s_red[2]), dirty);
    atomicOr(reinterpret_cast<unsigned*>(&s_red[3]), idirty);
  }
  __syncthreads();
  cluster_wait();     // every CTA of the cluster has started
  if (t < P.K)        // push this CTA's pair into every CTA's slot
    *cluster.map_shared_rank(&s_slot[rank], t) =
        ((unsigned long long)trips_cta << 32) | (unsigned)s_red[1];
  cluster_arrive();   // released: read after the matching wait below

  // ---- write back once: the scalars of the organism
  IV(IV_MEM_LEN) = mem_len; IV(IV_ACTIVE_STACK) = active_stack;
  IV(IV_READ_LABEL_LEN) = rl_len; IV(IV_INPUT_PTR) = in_ptr;
  IV(IV_INPUT_BUF_N) = ibuf_n; IV(IV_OUTPUT_BUF) = out_buf;
  IV(IV_TIME_USED) = time_used; IV(IV_CPU_CYCLES) = cpu_cycles;
  IV(IV_GEST_START) = gest_start; IV(IV_GEST_TIME) = gest_time;
  IV(IV_EXEC_SIZE) = exec_size; IV(IV_CHILD_COPIED) = child_copied;
  IV(IV_GENERATION) = generation; IV(IV_NUM_DIVIDES) = num_divides;
  IV(IV_OFF_START) = off_start; IV(IV_OFF_LEN) = off_len;
  IV(IV_OFF_COPIED) = off_copied; IV(IV_INSTS_EXEC) = insts;
  IV(IV_FLAGS) = flags; IV(IV_OFF_SEX) = off_sex;
  IV(IV_COST_WAIT) = cost_wait;
  IV(IV_FT_LO) = (int)ft_lo; IV(IV_FT_HI) = (int)ft_hi;
  IV(IV_REGS) = r0; IV(IV_REGS + 1) = r1; IV(IV_REGS + 2) = r2;
  IV(IV_INPUT_BUF) = ib0; IV(IV_INPUT_BUF + 1) = ib1;
  IV(IV_INPUT_BUF + 2) = ib2;
  IV(IV_HEADS + HEAD_IP) = h_ip; IV(IV_HEADS + HEAD_READ) = h_rd;
  IV(IV_HEADS + HEAD_WRITE) = h_wr; IV(IV_HEADS + HEAD_FLOW) = h_fl;
  IV(IV_SP) = sp0; IV(IV_SP + 1) = sp1;
  IV(IV_PW_POS) = -1;
  IV(IV_PZ_START) = 0;
  IV(IV_PZ_END) = 0;
  FV(FV_MERIT) = merit; FV(FV_CUR_BONUS) = cur_bonus;
  FV(FV_FITNESS) = fitness; FV(FV_LAST_BONUS) = last_bonus;
  FV(FV_LAST_MERIT_BASE) = last_mb;

  // ---- offspring extraction for an organism that divided in this launch
  if (flags & FLAG_NEWDIV) {
#pragma unroll 1
    for (int w = 0; w < P.LP; ++w) {
      unsigned word = 0;
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * w + b;
        if (j < off_len)
          word |= (unsigned)byte_at((off_start + j) % L) << (8 * b);
      }
      off[(size_t)w * N + lane] = (int32_t)word;
    }
  }
#undef IV
#undef FV
#undef T

  // ---- the staged rows, coalesced: the tape row groups and ivec row
  // groups some lane of the CTA wrote, and the site-flag bitplanes (rows
  // kept in device memory were written there in place)
  const unsigned dmask = (unsigned)s_red[2], imask = (unsigned)s_red[3];
  if (kTape) {
#pragma unroll 1
    for (int w = 0; w < P.LP; ++w)
      if ((dmask >> (w >> P.gshift)) & 1u)
        tape[(size_t)w * N + c0 + t] = tile[w * C + t];
  }
#pragma unroll 1
  for (int r = R_LBL; r < P.rows; ++r) {
    const unsigned group = r < R_STK ? I_LABEL : r < R_EBM ? I_STACK
                           : r < R_DYN ? 0u : I_DYN;
    if (group && !(imask & group)) continue;
    const size_t row = r < R_EBM ? (size_t)(IV_READ_LABEL + r - R_LBL)
                                 : (size_t)(IV_EXEC_BM + r - R_EBM);
    ivec[row * N + c0 + t] = tile[r * C + t];
  }

  // ---- the block's pair, once every CTA of the cluster has pushed its own
  cluster_wait();
  unsigned long long pair = 0;
  for (int r = 0; r < P.K; ++r) pair = max(pair, s_slot[r]);
  const long long trips = (long long)(pair >> 32);
  const int bound_w = ((int)(pair & 0xFFFFFFFFu) + 3) >> 2;
  if (trips > 0) {
    pw_val = last_exec == trips - 1
        ? written
        : ((h_rd >> 2) / 16 * 16 < bound_w ? op_at(h_rd) : 0);
  }
  ivec[(size_t)IV_PW_VAL * N + lane] = pw_val;
}

// up to 32 reactions: the parameters the kernel took before it held any
// reaction count
template <int C, int S>
__global__ void __launch_bounds__(MAX_C)
cycles_kernel(int32_t* __restrict__ tape, int32_t* __restrict__ off,
              int32_t* __restrict__ ivec, float* __restrict__ fvec,
              const int32_t* __restrict__ seeds,
              const int32_t* __restrict__ tab, Params P) {
  cycles_body<C, S, false>(tape, off, ivec, fvec, seeds, tab, nullptr, P);
}

// past 32 reactions: and the scratch plane of the paid words past the first
template <int C, int S>
__global__ void __launch_bounds__(MAX_C)
cycles_kernel_wide(int32_t* __restrict__ tape, int32_t* __restrict__ off,
                   int32_t* __restrict__ ivec, float* __restrict__ fvec,
                   const int32_t* __restrict__ seeds,
                   const int32_t* __restrict__ tab,
                   int32_t* __restrict__ scratch, Params P) {
  cycles_body<C, S, true>(tape, off, ivec, fvec, seeds, tab, scratch, P);
}

// The launch's Params, staging level and dynamic shared memory from the
// ints of ops/cycles.py::_int_params (csrc/cycles_simple.cu's 20, then
// the plan's CTA width C and staging level); -1 on a plan this source
// cannot run
int configure(const int32_t* pi, const float* pf, int block, Params& P,
              int& stage, size_t& smem) {
  P.n_pad = pi[0]; P.LP = pi[1]; P.LW = pi[2]; P.L0 = pi[3]; P.ni = pi[4];
  P.R = pi[5]; P.iv_copied = pi[6]; P.iv_dyn = pi[7]; P.num_steps = pi[8];
  P.require_alloc = pi[9]; P.merit_method = pi[10];
  P.inherit_merit = pi[11]; P.gen_inc = pi[12]; P.divide_method = pi[13];
  P.min_genome_len = pi[14]; P.copy_mut_on = pi[15];
  P.has_costs = pi[16]; P.has_prob_fail = pi[17]; P.has_addl = pi[18];
  P.weighted_mut = pi[19];
  if (pf) {
    P.copy_mut_prob = pf[0]; P.size_range = pf[1]; P.min_exe_lines = pf[2];
    P.min_copied_lines = pf[3]; P.default_bonus = pf[4];
    P.const_merit = pf[5]; P.size_range_inv = pf[6];
  }
  P.C = pi[20];
  stage = pi[21];
  if ((P.C != 32 && P.C != 64 && P.C != MAX_C) || block % P.C
      || block / P.C > MAX_CLUSTER || P.n_pad % block || stage < 0
      || stage > MAX_STAGE || P.ni > TAB_INSTS || P.R < 0
      || P.iv_copied != IV_EXEC_BM + P.LW
      || P.iv_dyn != IV_EXEC_BM + 2 * P.LW)
    return -1;
  P.K = block / P.C;
  // ops/cycles.py: staged_rows, plan_smem_bytes
  P.rows = LBL_ROWS + (stage < 2 ? P.LP : 0) + (stage < 3 ? 2 * P.LW : 0)
           + (stage < 1 ? 4 * P.R : 0);
  P.gshift = 0;
  while ((P.LP - 1) >> P.gshift >= 32) ++P.gshift;
  smem = 4 * ((size_t)P.rows * P.C + T_OPS + TAB_INSTS
              + (stage < 3 ? reaction_smem_ints(P.R) : 0) + 24);
  return smem > (size_t)SMEM_PER_CTA ? -1 : 0;
}

void launch_config(const Params& P, size_t smem, cudaStream_t stream,
                   cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  cfg = {};
  cfg.gridDim = dim3(P.n_pad / P.C);
  cfg.blockDim = dim3(P.C);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// the kernel K<C, stage> of the plan, its shared memory set; `out` gets
// cudaOccupancyMaxActiveClusters where given, else the launch runs
template <template <int> class K, class... Args>
int run(const Params& P, int stage, size_t smem, void* stream, int* out,
        Args... args) {
  const auto kern = P.C == 128 ? K<128>::at(stage)
                    : P.C == 64 ? K<64>::at(stage) : K<32>::at(stage);
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(P, smem, (cudaStream_t)stream, cfg, attr);
  if (out) return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kern,
                                                      &cfg);
  if constexpr (sizeof...(Args) == 0) {
    return -1;
  } else {
    err = (int)cudaLaunchKernelEx(&cfg, kern, args...);
    if (err != 0) return err;
    return (int)cudaGetLastError();
  }
}

template <int C>
struct Narrow {
  static auto at(int stage) {
    return stage == 0 ? cycles_kernel<C, 0> : stage == 1 ? cycles_kernel<C, 1>
           : stage == 2 ? cycles_kernel<C, 2> : cycles_kernel<C, 3>;
  }
};

template <int C>
struct Wide {
  static auto at(int stage) {
    return stage == 0 ? cycles_kernel_wide<C, 0>
           : stage == 1 ? cycles_kernel_wide<C, 1>
           : stage == 2 ? cycles_kernel_wide<C, 2> : cycles_kernel_wide<C, 3>;
  }
};

// The launch of the plan in pi, or with `out` its occupancy query: the
// kernels of up to 32 reactions (kWide false) or past 32; -1 for a
// reaction count the other compilation holds
template <bool kWide>
int launch(void* tape, void* off, void* ivec, void* fvec, const void* seeds,
           const void* tab, void* scratch, const int32_t* pi,
           const float* pf, int block, void* stream, int* out) {
  Params P;
  int stage;
  size_t smem;
  const int err = configure(pi, pf, block, P, stage, smem);
  if (err != 0) return err;
  if ((mask_words(P.R) > 1) != kWide) return -1;
  if constexpr (kWide) {
    if (out) return run<Wide>(P, stage, smem, stream, out);
    if (scratch == nullptr) return -1;
    return run<Wide>(P, stage, smem, stream, nullptr, (int32_t*)tape,
                     (int32_t*)off, (int32_t*)ivec, (float*)fvec,
                     (const int32_t*)seeds, (const int32_t*)tab,
                     (int32_t*)scratch, P);
  } else {
    if (out) return run<Narrow>(P, stage, smem, stream, out);
    return run<Narrow>(P, stage, smem, stream, nullptr, (int32_t*)tape,
                       (int32_t*)off, (int32_t*)ivec, (float*)fvec,
                       (const int32_t*)seeds, (const int32_t*)tab, P);
  }
}

}  // namespace

// This source is compiled twice, in parallel (ops/cycles.py UNITS): with
// AVIDA_CYCLES_WIDE 0 it holds the kernels of up to 32 reactions and the
// entry points below, with AVIDA_CYCLES_WIDE 1 those past 32 reactions
// and the same entry points suffixed _wide; the wrapper calls the pair
// that holds its reaction count.  Two compilations build in 20.0 s where
// one took 36.3 s (PERF.md, section 6), and the build is on the path of
// chip_smoke.py's time limit.
#if AVIDA_CYCLES_WIDE
#define AVIDA_ENTRY(name) name##_wide
#else
#define AVIDA_ENTRY(name) name
#endif

// pi holds the 20 ints of csrc/cycles_simple.cu's interface, then the
// plan's CTA width C and staging level (ops/cycles.py::cta_plan);
// `block` is the reference's B; `scratch` is an int32 plane of
// (R + 31) / 32 - 1 rows of n_pad lanes (unused, and may be null, at up
// to 32 reactions)
extern "C" int AVIDA_ENTRY(avida_cycles_launch)(
    void* tape, void* off, void* ivec, void* fvec, const void* seeds,
    const void* tab, void* scratch, const int32_t* pi, const float* pf,
    int block, void* stream) {
  return launch<AVIDA_CYCLES_WIDE != 0>(tape, off, ivec, fvec, seeds, tab,
                                        scratch, pi, pf, block, stream,
                                        nullptr);
}

// cudaOccupancyMaxActiveClusters of the plan in pi (as for
// avida_cycles_launch, one block of lanes) into *out
extern "C" int AVIDA_ENTRY(avida_cycles_clusters)(const int32_t* pi,
                                                  int block, int* out) {
  return launch<AVIDA_CYCLES_WIDE != 0>(nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, pi,
                                        nullptr, block, nullptr, out);
}
