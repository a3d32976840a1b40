// The substeps of one specialized loop iteration, in one launch.
//
// Replaces no TPU kernel. It replaces two XLA device functions of the
// JAX package: mythril_tpu/laser/batch/specialize.py:fused_substep (and
// sym_fused_substep, :423) and mythril_tpu/laser/batch/blockjit.py:
// block_substep (and sym_block_substep, :598). An iteration of the
// specialized loop runs one full step, then `depth` substeps: fuse_depth
// - 1 fused ones or block_depth block ones. In eager PyTorch one substep
// is dozens of launches (gathers, selects, limb arithmetic, scatters),
// so six of them an iteration would add about as many launches as the
// loop saves. A substep touches only its own lane's state, and a lane it
// skips keeps that state, so every later substep of the iteration skips
// it too: one thread a lane, looping over the substeps and stopping at
// the first it skips, computes exactly what the batch-wide sequence of
// substeps computes.
//
// Semantics (the JAX substeps', bit for bit):
//   - a lane executes when RUNNING, pc < code length, its table row
//     allows it (fuse mode: row == 1; block mode: row != 0), sp >= pops,
//     sp + net_sp <= min(stack_cap, 1024), (gas_min + the op's static
//     minimum) mod 2**32 <= gas_budget, and its op is not unhandled (the
//     pruned-phase table, block mode only, when given);
//   - PUSH writes its immediate at sp, DUPn the copy at sp, SWAPn the
//     deep value at sp - 1 and the old top at the deep slot, the ALU
//     family (block mode) its result at sp - pops; any other marked op
//     writes nothing; pc, sp and the static gas bounds advance (mod
//     2**32), and the pc's coverage bit is set in an int32 word;
//   - symbolic lanes (stack_tid given) move tids as values move (PUSH
//     and ALU results are concrete, 0) and skip an ALU op with a tainted
//     operand, or one that wraps by the JAX package's test: exact for
//     ADD and SUB, (hi_a | hi_b) & nz_a & nz_b for MUL.
// Lanes executed and heads entered (ROW_HEAD rows executed) accumulate in
// counts[0] and counts[1] with integer atomics, so the sums do not depend
// on the order of the lanes; nothing is read back to the host.
//
// Bound: bytes, by the class of each executed op: PUSHn reads its
// opcode and n immediate bytes and writes one stack slot (64 B), DUPn
// reads one slot and writes one, SWAPn reads two and writes two, an ALU
// op reads its operands and writes one, POP and JUMPDEST move no slot;
// each reads a table byte and sets a coverage bit, and a symbolic lane
// moves a 4-byte tid with each slot. A lane not RUNNING reads only its
// status; a RUNNING one reads its pc/sp/gas words and writes them back
// if it executed. The arithmetic is at most one 16-limb ALU op a
// substep. This first design is simple and correct: one thread a lane,
// its limbs in registers, each substep reloading what it reads. Making
// it fast is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 16;
constexpr uint32_t kMask = 0xFFFFu;
constexpr long long kM32 = 0xFFFFFFFFll;
constexpr int kThreads = 128;

struct Params {
  const uint8_t* ops;  // [n_codes, ops_w] code bytes, zero-padded by 33
  long long ops_w;
  long long n_codes;
  const int32_t* code_len;  // [n_codes]
  const uint8_t* tbl;       // [n_codes, tbl_w] fuse / block-program rows
  long long tbl_w;
  const int32_t* code_id;  // [n]
  int32_t* pc;             // [n], updated
  const int32_t* status;   // [n]
  int32_t* sp;             // [n], updated
  long long* gas_min;      // [n] uint32 values, updated
  long long* gas_max;      // [n] uint32 values, updated
  const long long* gas_budget;  // [n]
  int32_t* stack;               // [n, stack_cap, 16] limbs, updated
  long long stack_cap;
  int32_t* stack_tid;  // [n, stack_cap] or null (concrete lanes)
  int32_t* pc_seen;    // [n, words] coverage bitmap or null
  long long words;
  const uint8_t* unhandled;  // [256] pruned opcodes or null
  const int32_t* meta;       // [256, 6]: valid, supported, pops, net_sp, gas_min, gas_max
  long long* counts;         // [2]: lanes executed, heads entered
  long long n;
  long long depth;
  long long block;  // 0: fuse mode, 1: block mode
};

__device__ __forceinline__ long long clampll(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ void load_word(const int32_t* slot, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) w[i] = static_cast<uint32_t>(slot[i]);
}

__device__ __forceinline__ void store_word(int32_t* slot, const uint32_t* w) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) slot[i] = static_cast<int32_t>(w[i]);
}

__device__ __forceinline__ bool ult(const uint32_t* a, const uint32_t* b) {
  for (int i = kLimbs - 1; i >= 0; --i)
    if (a[i] != b[i]) return a[i] < b[i];
  return false;
}

__device__ __forceinline__ bool slt(const uint32_t* a, const uint32_t* b) {
  uint32_t sa = a[kLimbs - 1] >> 15, sb = b[kLimbs - 1] >> 15;
  if (sa != sb) return sa > sb;
  return ult(a, b);
}

__device__ __forceinline__ bool any_from(const uint32_t* a, int from) {
  uint32_t acc = 0;
  for (int i = from; i < kLimbs; ++i) acc |= a[i];
  return acc != 0;
}

__device__ __forceinline__ void set_bool(uint32_t* r, bool v) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r[i] = 0;
  r[0] = v ? 1u : 0u;
}

// The shift amount as the port's u256.shift_amount: a high limb set
// saturates it; any value >= 256 shifts everything out.
__device__ __forceinline__ uint32_t shift_amount(const uint32_t* a) {
  return any_from(a, 1) ? kMask : a[0];
}

__device__ void shl(const uint32_t* b, uint32_t s, uint32_t* r) {
  int q = static_cast<int>(s >> 4), bs = static_cast<int>(s & 15);
  for (int i = 0; i < kLimbs; ++i) {
    int j = i - q;
    uint32_t v1 = (s < 256 && j >= 0) ? b[j] : 0;
    uint32_t v2 = (s < 256 && j - 1 >= 0) ? b[j - 1] : 0;
    r[i] = ((v1 << bs) | (bs ? v2 >> (16 - bs) : 0)) & kMask;
  }
}

__device__ void lshr(const uint32_t* b, uint32_t s, uint32_t* r) {
  int q = static_cast<int>(s >> 4), bs = static_cast<int>(s & 15);
  for (int i = 0; i < kLimbs; ++i) {
    int j = i + q;
    uint32_t v1 = (s < 256 && j < kLimbs) ? b[j] : 0;
    uint32_t v2 = (s < 256 && j + 1 < kLimbs) ? b[j + 1] : 0;
    r[i] = ((v1 >> bs) | (bs ? v2 << (16 - bs) : 0)) & kMask;
  }
}

__device__ void ashr(const uint32_t* b, uint32_t s, uint32_t* r) {
  uint32_t s_cl = s < 256 ? s : 256;
  lshr(b, s_cl, r);
  if (b[kLimbs - 1] >> 15) {
    int fill_from = 256 - static_cast<int>(s_cl);
    for (int i = 0; i < kLimbs; ++i) {
      int start = static_cast<int>(clampll(fill_from - 16 * i, 0, 16));
      r[i] |= (0x10000u - (1u << start)) & kMask;
    }
  }
}

__device__ void byte_op(const uint32_t* i, const uint32_t* x, uint32_t* r) {
  bool big = any_from(i, 1) || i[0] >= 32;
  for (int k = 0; k < kLimbs; ++k) r[k] = 0;
  if (!big) {
    uint32_t pos = 31 - i[0];
    r[0] = (x[pos / 2] >> (8 * (pos % 2))) & 0xFFu;
  }
}

__device__ void signextend(const uint32_t* k, const uint32_t* x, uint32_t* r) {
  bool big = any_from(k, 1) || k[0] >= 31;
  if (big) {
    for (int i = 0; i < kLimbs; ++i) r[i] = x[i];
    return;
  }
  int t = 8 * static_cast<int>(k[0]) + 7;
  uint32_t sign = (x[t / 16] >> (t % 16)) & 1u;
  for (int i = 0; i < kLimbs; ++i) {
    int nbits = static_cast<int>(clampll(t + 1 - 16 * i, 0, 16));
    uint32_t low = ((1u << nbits) - 1u) & kMask;
    r[i] = sign ? (x[i] | (low ^ kMask)) : (x[i] & low);
  }
}

// The ALU family's result, the full step's expressions. Returns false
// for an op outside it.
__device__ bool alu(int op, const uint32_t* a, const uint32_t* b, uint32_t* r) {
  switch (op) {
    case 0x01: {  // ADD
      uint32_t c = 0;
      for (int i = 0; i < kLimbs; ++i) {
        uint32_t s = a[i] + b[i] + c;
        r[i] = s & kMask;
        c = s >> 16;
      }
      return true;
    }
    case 0x03: {  // SUB
      int32_t br = 0;
      for (int i = 0; i < kLimbs; ++i) {
        int32_t s = static_cast<int32_t>(a[i]) - static_cast<int32_t>(b[i]) - br;
        br = s < 0;
        r[i] = static_cast<uint32_t>(s + (br << 16)) & kMask;
      }
      return true;
    }
    case 0x02: {  // MUL, mod 2**256
      unsigned long long acc = 0;
      for (int k = 0; k < kLimbs; ++k) {
        for (int i = 0; i <= k; ++i)
          acc += static_cast<unsigned long long>(a[i]) * b[k - i];
        r[k] = static_cast<uint32_t>(acc & kMask);
        acc >>= 16;
      }
      return true;
    }
    case 0x16:  // AND
      for (int i = 0; i < kLimbs; ++i) r[i] = a[i] & b[i];
      return true;
    case 0x17:  // OR
      for (int i = 0; i < kLimbs; ++i) r[i] = a[i] | b[i];
      return true;
    case 0x18:  // XOR
      for (int i = 0; i < kLimbs; ++i) r[i] = a[i] ^ b[i];
      return true;
    case 0x19:  // NOT
      for (int i = 0; i < kLimbs; ++i) r[i] = a[i] ^ kMask;
      return true;
    case 0x10: set_bool(r, ult(a, b)); return true;   // LT
    case 0x11: set_bool(r, ult(b, a)); return true;   // GT
    case 0x12: set_bool(r, slt(a, b)); return true;   // SLT
    case 0x13: set_bool(r, slt(b, a)); return true;   // SGT
    case 0x14: {                                        // EQ
      bool eq = true;
      for (int i = 0; i < kLimbs; ++i) eq = eq && a[i] == b[i];
      set_bool(r, eq);
      return true;
    }
    case 0x15: set_bool(r, !any_from(a, 0)); return true;  // ISZERO
    case 0x1A: byte_op(a, b, r); return true;                // BYTE
    case 0x1B: shl(b, shift_amount(a), r); return true;      // SHL
    case 0x1C: lshr(b, shift_amount(a), r); return true;     // SHR
    case 0x1D: ashr(b, shift_amount(a), r); return true;     // SAR
    case 0x0B: signextend(a, b, r); return true;             // SIGNEXTEND
    default: return false;
  }
}

__device__ __forceinline__ bool is_alu(int op) {
  return (op >= 0x01 && op <= 0x03) || op == 0x0B || (op >= 0x10 && op <= 0x1D);
}

// The JAX package's wrap test for the symbolic lanes' ALU ops.
__device__ bool wraps(int op, const uint32_t* a, const uint32_t* b) {
  if (op == 0x01) {  // ADD: ~a < b
    uint32_t na[kLimbs];
    for (int i = 0; i < kLimbs; ++i) na[i] = a[i] ^ kMask;
    return ult(na, b);
  }
  if (op == 0x03) return ult(a, b);  // SUB
  if (op == 0x02)                    // MUL, coarse
    return (any_from(a, kLimbs / 2) || any_from(b, kLimbs / 2)) && any_from(a, 0) &&
           any_from(b, 0);
  return false;
}

__global__ void __launch_bounds__(kThreads) substep_kernel(const __grid_constant__ Params p) {
  long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= p.n || p.status[lane] != 0) return;  // 0: Status.RUNNING
  long long cid = clampll(p.code_id[lane], 0, p.n_codes - 1);
  const long long clen = p.code_len[cid];
  const uint8_t* code = p.ops + cid * p.ops_w;
  const uint8_t* trow = p.tbl + cid * p.tbl_w;
  int32_t* st = p.stack + lane * p.stack_cap * kLimbs;
  int32_t* tid = p.stack_tid ? p.stack_tid + lane * p.stack_cap : nullptr;
  const long long top_slot = p.stack_cap - 1;
  const long long limit = p.stack_cap < 1024 ? p.stack_cap : 1024;
  long long pc = p.pc[lane], sp = p.sp[lane];
  long long gmin = p.gas_min[lane], gmax = p.gas_max[lane];
  const long long budget = p.gas_budget[lane];
  long long executed = 0, heads = 0;

  for (long long k = 0; k < p.depth; ++k) {
    if (pc >= clen) break;
    const int row = trow[clampll(pc, 0, p.tbl_w - 1)];
    if (p.block ? row == 0 : row != 1) break;
    const long long pcs = clampll(pc, 0, p.ops_w - 33);
    const int op = code[pcs];
    const int32_t* m = p.meta + op * 6;
    const long long pops = m[2], net = m[3];
    if (sp < pops || sp + net > limit) break;
    if (((gmin + m[4]) & kM32) > budget) break;
    if (p.unhandled && p.unhandled[op]) break;

    const bool push = op >= 0x60 && op <= 0x7F;
    const bool dup = op >= 0x80 && op <= 0x8F;
    const bool swap = op >= 0x90 && op <= 0x9F;
    const bool alu_op = p.block && is_alu(op);
    const long long ia = clampll(sp - 1, 0, top_slot);
    uint32_t res[kLimbs];
    long long res_idx = -1;
    int32_t res_tid = 0;
    if (alu_op) {
      uint32_t a[kLimbs], b[kLimbs];
      const long long ib = clampll(sp - 2, 0, top_slot);
      load_word(st + ia * kLimbs, a);
      load_word(st + ib * kLimbs, b);
      if (tid) {
        const bool unary = op == 0x15 || op == 0x19;  // ISZERO, NOT
        const bool concrete = unary ? tid[ia] == 0 : (tid[ia] == 0 && tid[ib] == 0);
        if (!concrete || wraps(op, a, b)) break;
      }
      alu(op, a, b, res);
      res_idx = clampll(sp - pops, 0, top_slot);
    } else if (push) {
      const int nb = op - 0x5F;
      for (int l = 0; l < kLimbs; ++l) {
        uint32_t lo = 2 * l < nb ? code[pcs + nb - 2 * l] : 0;
        uint32_t hi = 2 * l + 1 < nb ? code[pcs + nb - 2 * l - 1] : 0;
        res[l] = lo | (hi << 8);
      }
      res_idx = clampll(sp, 0, top_slot);
    } else if (dup) {
      const long long src = clampll(sp - 1 - (op - 0x80), 0, top_slot);
      load_word(st + src * kLimbs, res);
      res_idx = clampll(sp, 0, top_slot);
      if (tid) res_tid = tid[src];
    } else if (swap) {
      const long long deep = clampll(sp - 1 - (op - 0x8F), 0, top_slot);
      uint32_t top[kLimbs];
      load_word(st + ia * kLimbs, top);
      load_word(st + deep * kLimbs, res);
      store_word(st + deep * kLimbs, top);
      res_idx = ia;
      if (tid) {
        res_tid = tid[deep];
        tid[deep] = tid[ia];
      }
    }
    if (res_idx >= 0) {
      store_word(st + res_idx * kLimbs, res);
      if (tid) tid[res_idx] = res_tid;
    }
    if (p.pc_seen) {
      int32_t* word = p.pc_seen + lane * p.words + clampll(pc / 32, 0, p.words - 1);
      *word = static_cast<int32_t>(static_cast<uint32_t>(*word) | (1u << (pc & 31)));
    }
    pc += 1 + (push ? op - 0x5F : 0);
    sp += net;
    gmin = (gmin + m[4]) & kM32;
    gmax = (gmax + m[5]) & kM32;
    ++executed;
    heads += row == 3;  // ROW_HEAD
  }
  if (executed) {
    p.pc[lane] = static_cast<int32_t>(pc);
    p.sp[lane] = static_cast<int32_t>(sp);
    p.gas_min[lane] = gmin;
    p.gas_max[lane] = gmax;
    atomicAdd(reinterpret_cast<unsigned long long*>(p.counts),
              static_cast<unsigned long long>(executed));
    if (heads)
      atomicAdd(reinterpret_cast<unsigned long long*>(p.counts + 1),
                static_cast<unsigned long long>(heads));
  }
}

}  // namespace

extern "C" int substep_run(const char* params, void* stream) {
  Params p = *reinterpret_cast<const Params*>(params);
  if (p.n <= 0 || p.depth <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((p.n + kThreads - 1) / kThreads);
  substep_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int substep_params_bytes() { return static_cast<int>(sizeof(Params)); }
