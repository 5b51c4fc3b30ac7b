// The first port of the cycle interpreter (kept as the yardstick of
// csrc/cycles.cu): every CPU cycle of one update in one launch, one
// thread per organism.  No path launches it; chip_smoke.py times it beside
// the Hopper kernel on the same planes and holds both to the plain
// version.
//
// Replaces the Pallas kernel of avida_tpu/ops/pallas_cycles.py
// (_make_kernel, launched by _launch_packed / run_packed) and computes the
// same function on the same plane layout (see avida_tpu_torch/ops/cycles.py
// for the layout and the plain PyTorch version this kernel is held to).
//
// Design.  A thread loads its organism's scalars (registers, heads, stacks,
// read label, site-flag bitplanes, phenotype) into registers and local
// arrays once, runs its cycles, and writes them back once.  The tape is
// read and written in device memory at the organism's own head positions;
// tape writes are applied immediately (the TPU kernel deferred them one
// cycle only to merge its whole-tape passes).  The block of B threads is
// the reference's B-lane block: its trip count is the block's largest
// granted budget (rounded up to even, the reference runs two cycles per
// trip), and the random stream is the reference's interpret-mode counter
// hash over (block seed, cycle, tag, thread index).
//
// What bounds it: at 320x320 (L=384) a launch must read tape_t, ivec and
// the phenotype rows of fvec (~97 MB, ~0.03 ms at 3.35 TB/s) and write
// only the words it changes (scalar rows of live lanes, tape bytes at
// copy and allocate, off_t of dividing lanes); chip_smoke.py counts those
// per run.  The work is per-organism integer control flow (tens of cycles
// per update) with scattered tape reads, which sets the real time.  Built
// with -fmad=false: merit and fitness are float32 products that must
// round exactly as the reference's do.

#include <cstdint>
#include <cuda_runtime.h>

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
constexpr int MAX_LW = 32;      // tape height <= 1024
constexpr int MAX_R = 32;       // reactions
constexpr int TAB_INSTS = 64;   // table slots per opcode table
constexpr int RX = 16;          // table ints per reaction
// opcode tables, TAB_INSTS slots each, in this order
constexpr int T_META = 0, T_COST = 1, T_FT_COST = 2, T_ADDL = 3,
              T_PROB_FAIL = 4, T_MUT_CDF = 5, T_IS_NOP = 6, T_NOP_MOD = 7,
              T_REACTIONS = 8;

struct Params {
  int n_pad, LP, LW, L0, ni, R, iv_copied, iv_dyn, num_steps;
  int require_alloc, merit_method, inherit_merit, gen_inc, divide_method;
  int min_genome_len, copy_mut_on;
  int has_costs, has_prob_fail, has_addl, weighted_mut;
  float copy_mut_prob, size_range, min_exe_lines, min_copied_lines;
  float default_bonus, const_merit;
  float size_range_inv;     // float32 1 / size_range: XLA's CPU compiler
                            // divides by the constant as this product
};

// table layout (built by the wrapper): 8 opcode tables of TAB_INSTS ints
// -- metadata sem | mod_kind << 8 | default_op << 16, cost, ft_cost,
// addl_time_cost, prob_fail (float32 bits), the cumulative mutation
// weights (float32 bits), is_nop, nop_mod -- then RX ints per reaction:
// min_tc, max_tc, type, value (float bits; pow stores 2**value), req mask,
// noreq mask, 8 words of the 256-bit logic-id mask.

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
  if (n_in < 3)
    for (int c = 0; c < 4; ++c) lo[4 + c] = lo[c];
  int logic = 0;
  for (int c = 0; c < 8; ++c) logic |= lo[c] << c;
  return ok ? logic : -1;
}

__global__ void __launch_bounds__(512)
cycles_simple_kernel(int32_t* __restrict__ tape, int32_t* __restrict__ off,
              int32_t* __restrict__ ivec, float* __restrict__ fvec,
              const int32_t* __restrict__ seeds,
              const int32_t* __restrict__ tab, Params P) {
  const int N = P.n_pad;
  // nop decode table: the nop's register for a nop opcode, -1 otherwise
  __shared__ int s_nop[TAB_INSTS];
  if (threadIdx.x < TAB_INSTS) {
    const int k = threadIdx.x;
    s_nop[k] = (k < P.ni && tab[T_IS_NOP * TAB_INSTS + k])
                   ? tab[T_NOP_MOD * TAB_INSTS + k] : -1;
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned tlane = threadIdx.x;
  const unsigned seed = (unsigned)seeds[blockIdx.x];
  const int L = P.LP * 4;
#define IV(r) ivec[(size_t)(r) * N + lane]
#define FV(r) fvec[(size_t)(r) * N + lane]

  // ---- block trip count: the block's largest grant, two cycles a trip
  __shared__ int s_max[32];
  int granted = IV(IV_GRANTED);
  int g = granted;
  for (int o = 16; o > 0; o >>= 1) g = max(g, __shfl_xor_sync(~0u, g, o));
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = g;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < (blockDim.x >> 5) ? s_max[threadIdx.x] : 0;
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
    if (threadIdx.x == 0) s_max[0] = v;
  }
  __syncthreads();
  long long bmax = min((long long)s_max[0], (long long)P.num_steps);
  long long trips = bmax > 0 ? (bmax + 1) / 2 * 2 : 0;
  int nexec = (int)min((long long)granted, trips);

  // ---- per-organism state into registers / local arrays
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
  int regs[3], heads[4], sp[2], ibuf[3], inputs[3], rlabel[MAX_LABEL];
  int stacks[20];
  unsigned ebm[MAX_LW], cbm[MAX_LW];
  for (int k = 0; k < 3; ++k) {
    regs[k] = IV(IV_REGS + k);
    ibuf[k] = IV(IV_INPUT_BUF + k);
    inputs[k] = IV(IV_INPUTS + k);
  }
  for (int k = 0; k < 4; ++k) heads[k] = IV(IV_HEADS + k);
  sp[0] = IV(IV_SP);
  sp[1] = IV(IV_SP + 1);
  for (int k = 0; k < MAX_LABEL; ++k) rlabel[k] = IV(IV_READ_LABEL + k);
  for (int k = 0; k < 20; ++k) stacks[k] = IV(IV_STACKS + k);
  for (int w = 0; w < P.LW; ++w) {
    ebm[w] = (unsigned)IV(IV_EXEC_BM + w);
    cbm[w] = (unsigned)IV(P.iv_copied + w);
  }
  float merit = FV(FV_MERIT), cur_bonus = FV(FV_CUR_BONUS);
  float fitness = FV(FV_FITNESS), last_bonus = FV(FV_LAST_BONUS);
  float last_mb = FV(FV_LAST_MERIT_BASE);

  auto byte_at = [&](int pos) -> int {
    unsigned w = (unsigned)tape[(size_t)(pos >> 2) * N + lane];
    return (int)((w >> ((pos & 3) * 8)) & 0xFFu);
  };
  auto op_at = [&](int pos) -> int {
    return min(byte_at(pos) & 63, P.ni - 1);
  };

  // need_last / pend_prev feed the reference's row-tile bound of the
  // block's final cycle (see the pending-write value row below)
  int last_exec = -1, written = 0, need_last = 1, pend_prev = 0;
  for (int s = 0; s < nexec; ++s) {
    if (!(flags & FLAG_ALIVE) || (flags & FLAG_DIVPEND)) break;
    last_exec = s;
    const int mlen = max(mem_len, 1);
    if (s == trips - 1) need_last = mlen;
    const int ip = heads[HEAD_IP], rp = heads[HEAD_READ];
    const int wp = heads[HEAD_WRITE];
    const int cur_op = op_at(ip);
    const int meta = tab[T_META * TAB_INSTS + cur_op];
    const int defop = (meta >> 16) & 0xFF;

    // cost engine: a cost-c instruction waits c - 1 cycles and executes
    // on the last; ft_cost is a one-time surcharge per opcode
    bool eff = true;
    if (P.has_costs) {
      const unsigned ft_bit = cur_op < 32 ? (ft_lo >> cur_op) & 1u
                                          : (ft_hi >> (cur_op - 32)) & 1u;
      const int total = max(tab[T_COST * TAB_INSTS + cur_op], 1)
                        + (ft_bit ? 0 : tab[T_FT_COST * TAB_INSTS + cur_op]);
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
      failed = u < __int_as_float(tab[T_PROB_FAIL * TAB_INSTS + cur_op]);
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

    // operand (nop modifier) and label
    bool has_mod = false;
    int operand = defop, consumed = 0, label_len = 0;
    int lbl_c[MAX_LABEL];
    if (mod == MOD_REG || mod == MOD_HEAD) {
      const int nm = s_nop[window(0)];
      has_mod = nm >= 0;
      if (has_mod) { operand = nm; consumed = 1; }
    } else if (mod == MOD_LABEL) {
      for (int k = 0; k < MAX_LABEL; ++k) {
        if (k + 1 > mlen - 1) break;
        const int v = s_nop[window(k)];
        if (v < 0) break;
        lbl_c[k] = v >= 2 ? v - 2 : v + 1;
        label_len = k + 1;
      }
      consumed = label_len;
    }
    const int val = operand < 3 ? regs[operand] : 0;
    const int nr = operand + 1;
    const int next_reg = nr >= 3 ? nr - 3 : nr;
    const int val2 = next_reg < 3 ? regs[next_reg] : 0;
    const int bx = regs[1], cx = regs[2];
    const bool ipx = (ebm[ip >> 5] >> (ip & 31)) & 1u;
    const int hsel0 = mod == MOD_HEAD ? operand : HEAD_IP;
    const int eff_head_pos = hsel0 == HEAD_IP ? adjust1(ip + consumed, mlen)
                                              : heads[hsel0];
    const int old_len = mlen;
    const int flow0 = heads[HEAD_FLOW];

    int skip = 0, pz_e = 0;
    bool copy_m = false, alloc_m = false, div_m = false;
    int new_heads[4] = {heads[0], heads[1], heads[2], heads[3]};
    int ip_new = adjust1(adjust1(ip + consumed + 1, mlen), mlen);
    const int read_inst = op_at(rp);
    written = read_inst;

    switch (sem) {
      case SEM_IF_N_EQU: skip = val == val2; break;
      case SEM_IF_LESS: skip = val >= val2; break;
      case SEM_IF_LABEL: {
        bool m = rl_len == label_len;
        for (int k = 0; k < label_len; ++k) m = m && rlabel[k] == lbl_c[k];
        skip = !m;
        break;
      }
      case SEM_MOV_HEAD:
        new_heads[hsel0] = flow0;
        if (hsel0 == HEAD_IP) ip_new = flow0;
        break;
      case SEM_JMP_HEAD: {
        int jp = adjust(wrap_add(eff_head_pos, cx), mlen);
        new_heads[hsel0] = jp;
        if (hsel0 == HEAD_IP) ip_new = adjust1(jp + 1, mlen);
        break;
      }
      case SEM_GET_HEAD: regs[2] = eff_head_pos; break;
      case SEM_SET_FLOW: new_heads[HEAD_FLOW] = adjust(val, mlen); break;
      case SEM_SHIFT_R: if (operand < 3) regs[operand] = val >> 1; break;
      case SEM_SHIFT_L:
        if (operand < 3) regs[operand] = (int)((unsigned)val << 1);
        break;
      case SEM_INC: if (operand < 3) regs[operand] = wrap_add(val, 1); break;
      case SEM_DEC: if (operand < 3) regs[operand] = wrap_add(val, -1); break;
      case SEM_ADD: if (operand < 3) regs[operand] = wrap_add(bx, cx); break;
      case SEM_SUB:
        if (operand < 3) regs[operand] = (int)((unsigned)bx - (unsigned)cx);
        break;
      case SEM_NAND: if (operand < 3) regs[operand] = ~(bx & cx); break;
      case SEM_PUSH: {
        int spa = sp[active_stack != 0];
        int sp_push = spa == 0 ? 9 : spa - 1;
        stacks[active_stack * 10 + sp_push] = val;
        sp[active_stack != 0] = sp_push;
        break;
      }
      case SEM_POP: {
        int spa = sp[active_stack != 0];
        int slot = active_stack * 10 + spa;
        if (operand < 3) regs[operand] = stacks[slot];
        stacks[slot] = 0;
        sp[active_stack != 0] = spa == 9 ? 0 : spa + 1;
        break;
      }
      case SEM_SWAP_STK: active_stack = 1 - active_stack; break;
      case SEM_SWAP:
        if (operand < 3) regs[operand] = val2;
        regs[next_reg] = val;
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
              const int32_t* cdf = tab + T_MUT_CDF * TAB_INSTS;
              written = 0;
              for (int k = 0; k < P.ni - 1; ++k)
                written += ui >= __int_as_float(cdf[k]);
            } else {
              written = (int)(r % (unsigned)P.ni);
            }
          }
        }
        if (s_nop[read_inst] >= 0) {
          if (rl_len < MAX_LABEL) {
            rlabel[rl_len] = s_nop[read_inst];
            rl_len++;
          }
        } else {
          rl_len = 0;
        }
        new_heads[HEAD_READ] = adjust1(rp + 1, mlen);
        new_heads[HEAD_WRITE] = adjust1(wp + 1, mlen);
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
          regs[0] = old_len;
          flags |= FLAG_MAL;
        }
        break;
      }
      case SEM_H_SEARCH: {
        int head = adjust1(ip + label_len, mlen);
        const int ip_after = head;
        if (label_len > 0) {
          for (int q = 0; q + label_len <= mlen; ++q) {
            bool m = true;
            for (int k = 0; k < label_len && m; ++k) {
              const int byte = byte_at(q + k);
              const int c = byte < TAB_INSTS ? s_nop[byte] : -1;
              m = (c < 0 ? 3 : c) == lbl_c[k];
            }
            if (m) { head = q + label_len - 1; break; }
          }
        }
        regs[1] = head - ip_after;
        regs[2] = label_len;
        new_heads[HEAD_FLOW] = adjust1(head + 1, mlen);
        break;
      }
      case SEM_H_DIVIDE:
      case SEM_H_DIVIDE_SEX: {
        const int parent_size = rp;
        const int child_end = wp == 0 ? mlen : wp;
        const int child_size = child_end - parent_size;
        int exec_count = 0, copied_count = 0;
        for (int w = 0; w < P.LW; ++w) {
          exec_count += __popc(ebm[w] & range_mask(w, 0, parent_size));
          copied_count += __popc(cbm[w] & range_mask(w, parent_size,
                                                     child_end));
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
        const int ptr_mod = in_ptr % 3;
        const int value_in = inputs[ptr_mod];
        const int i0 = ibuf_n > 0 ? ibuf[0] : 0;
        const int i1 = ibuf_n > 1 ? ibuf[1] : 0;
        const int i2 = ibuf_n > 2 ? ibuf[2] : 0;
        const int lid = logic_id(i0, i1, i2, ibuf_n, (unsigned)val);
        float bonus = cur_bonus, add_sum = 0.0f;
        if (lid >= 0) {
          // every requisite reads the counters as they stood at the
          // start of the cycle, so decide all reactions before counting
          const int R = P.R;
          unsigned done = 0, paid = 0, had = 0;
          for (int d = 0; d < R; ++d)
            if (IV(P.iv_dyn + R + d) != 0) had |= 1u << d;
          for (int r = 0; r < R; ++r) {
            const int32_t* rt = tab + T_REACTIONS * TAB_INSTS + r * RX;
            if (!((rt[6 + (lid >> 5)] >> (lid & 31)) & 1)) continue;
            done |= 1u << r;
            const int tc = IV(P.iv_dyn + r);
            if (tc >= rt[0] && tc < rt[1]
                && ((unsigned)rt[4] & ~had) == 0
                && ((unsigned)rt[5] & had) == 0)
              paid |= 1u << r;
          }
          for (int r = 0; r < R; ++r) {
            if (!((done >> r) & 1u)) continue;
            IV(P.iv_dyn + r) += 1;
            IV(P.iv_dyn + 3 * R + r) += 1;
            if (!((paid >> r) & 1u)) continue;
            IV(P.iv_dyn + R + r) += 1;
            const int32_t* rt = tab + T_REACTIONS * TAB_INSTS + r * RX;
            const float v = __int_as_float(rt[3]);
            if (rt[2] == 2) bonus = __fmul_rn(bonus, v);
            else if (rt[2] == 1) { if (v != 0.0f) bonus = __fmul_rn(bonus, v); }
            else add_sum = __fadd_rn(add_sum, v);
          }
        }
        cur_bonus = __fadd_rn(bonus, add_sum);
        in_ptr += 1;
        ibuf[2] = ibuf[1];
        ibuf[1] = ibuf[0];
        ibuf[0] = value_in;
        ibuf_n = min(ibuf_n + 1, 3);
        out_buf = val;
        if (operand < 3) regs[operand] = value_in;
        break;
      }
      default: break;
    }

    // IP, site flags, tape
    if (div_m) ip_new = 0;
    else ip_new = skip ? adjust1(adjust1(ip + consumed + 2, mlen), mlen)
                       : ip_new;
    new_heads[HEAD_IP] = eff ? ip_new : ip;
    for (int k = 0; k < 4; ++k) heads[k] = new_heads[k];
    if (eff) ebm[ip >> 5] |= 1u << (ip & 31);
    if (has_mod || label_len > 0) ebm[next_pos >> 5] |= 1u << (next_pos & 31);
    if (copy_m) {
      cbm[wp >> 5] |= 1u << (wp & 31);
      int32_t* wa = tape + (size_t)(wp >> 2) * N + lane;
      const int sh = (wp & 3) * 8;
      *wa = (int32_t)(((unsigned)*wa & ~(0xFFu << sh))
                      | ((unsigned)written << sh));
    }
    if (alloc_m) {
      for (int w = 0; w < P.LW; ++w) {
        const unsigned m = range_mask(w, old_len, pz_e);
        ebm[w] &= ~m;
        cbm[w] &= ~m;
      }
      for (int p = old_len; p < pz_e; ++p) {
        int32_t* wa = tape + (size_t)(p >> 2) * N + lane;
        *wa = (int32_t)((unsigned)*wa & ~(0xFFu << ((p & 3) * 8)));
      }
    }
    if (div_m) {
      mem_len = rp;
      for (int k = 0; k < 4; ++k) heads[k] = 0;
      for (int k = 0; k < 3; ++k) regs[k] = 0;
      for (int k = 0; k < 20; ++k) stacks[k] = 0;
      sp[0] = sp[1] = 0;
      active_stack = 0;
      rl_len = 0;
      flags &= ~FLAG_MAL;
      if (P.has_costs) { cost_wait = 0; ft_lo = ft_hi = 0; }
      for (int w = 0; w < P.LW; ++w) ebm[w] = cbm[w] = 0;
      for (int r = 0; r < P.R; ++r) {
        IV(P.iv_dyn + 2 * P.R + r) = IV(P.iv_dyn + r);
        IV(P.iv_dyn + r) = 0;
        IV(P.iv_dyn + P.R + r) = 0;
      }
      flags |= FLAG_DIVPEND | FLAG_NEWDIV;
    }

    if (s == trips - 2) pend_prev = max(copy_m ? wp + 1 : 0, pz_e);

    // time and death
    time_used += 1;
    // addl_time_cost is charged on eff, failures included
    if (P.has_addl && eff) time_used += tab[T_ADDL * TAB_INSTS + cur_op];
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
  // writes (pallas_cycles.py:536-586); outside it the word reads 0.
  const bool ran_last = last_exec == trips - 1;
  int bound = max(ran_last ? need_last : 1, pend_prev);
  for (int o = 16; o > 0; o >>= 1)
    bound = max(bound, __shfl_xor_sync(~0u, bound, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = bound;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < (blockDim.x >> 5) ? s_max[threadIdx.x] : 0;
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
    if (threadIdx.x == 0) s_max[0] = v;
  }
  __syncthreads();
  const int bound_w = (s_max[0] + 3) >> 2;
  if (trips > 0) {
    const int rp = heads[HEAD_READ];
    pw_val = ran_last ? written
                      : ((rp >> 2) / 16 * 16 < bound_w ? op_at(rp) : 0);
  }

  // ---- write back once
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
  for (int k = 0; k < 3; ++k) {
    IV(IV_REGS + k) = regs[k];
    IV(IV_INPUT_BUF + k) = ibuf[k];
  }
  for (int k = 0; k < 4; ++k) IV(IV_HEADS + k) = heads[k];
  IV(IV_SP) = sp[0];
  IV(IV_SP + 1) = sp[1];
  for (int k = 0; k < MAX_LABEL; ++k) IV(IV_READ_LABEL + k) = rlabel[k];
  for (int k = 0; k < 20; ++k) IV(IV_STACKS + k) = stacks[k];
  for (int w = 0; w < P.LW; ++w) {
    IV(IV_EXEC_BM + w) = (int)ebm[w];
    IV(P.iv_copied + w) = (int)cbm[w];
  }
  IV(IV_PW_POS) = -1;
  IV(IV_PW_VAL) = pw_val;
  IV(IV_PZ_START) = 0;
  IV(IV_PZ_END) = 0;
  FV(FV_MERIT) = merit; FV(FV_CUR_BONUS) = cur_bonus;
  FV(FV_FITNESS) = fitness; FV(FV_LAST_BONUS) = last_bonus;
  FV(FV_LAST_MERIT_BASE) = last_mb;

  // ---- offspring extraction for a lane that divided in this launch
  if (flags & FLAG_NEWDIV) {
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
}

}  // namespace

extern "C" int avida_cycles_launch_simple(void* tape, void* off,
                                          void* ivec, void* fvec,
                                          const void* seeds,
                                          const void* tab,
                                          const int32_t* pi,
                                          const float* pf, int block,
                                          void* stream) {
  Params P;
  P.n_pad = pi[0]; P.LP = pi[1]; P.LW = pi[2]; P.L0 = pi[3]; P.ni = pi[4];
  P.R = pi[5]; P.iv_copied = pi[6]; P.iv_dyn = pi[7]; P.num_steps = pi[8];
  P.require_alloc = pi[9]; P.merit_method = pi[10];
  P.inherit_merit = pi[11]; P.gen_inc = pi[12]; P.divide_method = pi[13];
  P.min_genome_len = pi[14]; P.copy_mut_on = pi[15];
  P.has_costs = pi[16]; P.has_prob_fail = pi[17]; P.has_addl = pi[18];
  P.weighted_mut = pi[19];
  P.copy_mut_prob = pf[0]; P.size_range = pf[1]; P.min_exe_lines = pf[2];
  P.min_copied_lines = pf[3]; P.default_bonus = pf[4];
  P.const_merit = pf[5]; P.size_range_inv = pf[6];
  if (P.LW > MAX_LW || P.R > MAX_R || block > 512 || block % 32
      || P.n_pad % block)
    return -1;
  cycles_simple_kernel<<<P.n_pad / block, block, 0, (cudaStream_t)stream>>>(
      (int32_t*)tape, (int32_t*)off, (int32_t*)ivec, (float*)fvec,
      (const int32_t*)seeds, (const int32_t*)tab, P);
  return (int)cudaGetLastError();
}
