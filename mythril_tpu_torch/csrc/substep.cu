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
//     2**32), and the pc's coverage bit is set in an int32 word; the
//     code window's pc clips to ops_w - 33, the table's to tbl_w - 1,
//     every slot index to [0, stack_cap - 1];
//   - symbolic lanes (stack_tid given) move tids as values move (PUSH
//     and ALU results are concrete, 0) and skip an ALU op with a tainted
//     operand, or one that wraps by the JAX package's test: exact for
//     ADD and SUB, (hi_a | hi_b) & nz_a & nz_b for MUL.
// Lanes executed and heads entered (ROW_HEAD rows executed) are summed
// over each warp and added to counts[0] and counts[1] with integer
// atomics, so the sums do not depend on the order of the lanes; nothing
// is read back to the host.
//
// Bound: bytes (chip_smoke.py:substep_traffic): each input slot of an
// executed substep read once, each output slot written once (64 B, and
// a 4-byte tid on a symbolic lane), the code and table bytes decoded,
// the lane words, a coverage word read and written. A launch at 16384
// lanes moves 2-3 MB, under a microsecond at the card's memory rate, so
// what bounds the kernel is latency: the chain of dependent reads a lane
// makes. The first design walked that chain once a substep (table byte,
// opcode, meta row, then each slot as 16 scalar 4-byte reads 8 KB from
// the neighbouring thread's, and a read-modify-write of the coverage
// word), six times an iteration in block mode. A half-warp a lane (one
// limb a thread, slots as coalesced 64-byte accesses) shortens the
// chain but runs each lane's scalar work (decode, clips, slot lookups)
// on 16 threads: at 16384 lanes it issued so many warp instructions
// that it was slower than the first design (PERF.md).
//
// This design, one thread a lane, 32 lanes a block:
//   - the block copies the meta table (and the pruned table) to shared
//     memory while its lanes' words load; each lane then reads its code
//     length, first table byte and first opcode together;
//   - the iteration is decoded first: pc, sp and gas do not depend on
//     the stack's values, so the decode (a table byte and an opcode a
//     substep, read together through the read-only cache, and the op's
//     meta row from shared memory) names every slot the iteration can
//     touch, at most two a substep: a slot map of at most 2 * depth
//     entries, found through a byte index over the only slots an
//     iteration can reach (one shared read a lookup). Copying each
//     lane's 33 * depth code and table bytes to shared memory first was
//     slower: 16-byte cp.async pieces scattered over 32 lanes' windows
//     cost more to issue than the reads they replace (PERF.md);
//   - every input slot is then copied to shared memory as four 16-byte
//     cp.async copies, with its tid and the coverage words the decoded
//     pcs fall in, all in flight together: the lane waits for one memory
//     latency, not one a substep, and nothing it stores is read back
//     through memory;
//   - the substeps run on shared memory (a slot as four 16-byte quads,
//     thread-minor, so a warp's quad accesses do not conflict), stopping
//     at the first symbolic skip; each decoded substep carries its
//     operand and output entries, so the run does no lookup; an ALU op
//     (out of line, on 16 limbs in registers) reads its operands from
//     and writes its result to the map;
//   - each slot that changed is written back once, with its last value,
//     as four 16-byte stores; each coverage word run once; the lane
//     words once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 16;
constexpr int kQuads = kLimbs / 4;  // a slot as four 16-byte quads
constexpr uint32_t kMask = 0xFFFFu;
constexpr long long kM32 = 0xFFFFFFFFll;
constexpr int kThreads = 32;  // one warp a block, one thread a lane
constexpr int kReach = 33;    // pc advances at most 33 a substep (PUSH32)
constexpr int kMaxDepth = 8;
// coverage words an iteration's pcs can fall in
constexpr int kMaxSpan = (kReach * (kMaxDepth - 1) + 31) / 32 + 1;

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
  int32_t* stack;               // [n, stack_cap, 16] limbs, updated; 16-byte aligned
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

// The most an op lowers sp (CALL and CALLCODE pop 7 and push 1, LOG4
// pops 6): the slots an iteration can touch lie in [sp - kMaxDrop *
// (depth - 1) - 17, sp + depth - 1] (DUP16 reads sp - 17), clipped.
constexpr int kMaxDrop = 6;

__host__ __device__ constexpr int span_of(long long depth) {
  return static_cast<int>((kReach * (depth - 1) + 31) / 32 + 1);
}

// Bytes of a lane's slot index: the slots above, rounded to an odd
// number of 4-byte words so the lanes' rows fall in different banks.
__host__ __device__ constexpr int index_bytes(long long depth) {
  return 4 * ((((kMaxDrop + 1) * depth + 11 + 3) / 4) | 1);
}

// Dynamic shared memory, by depth: the meta rows' pops, net_sp, gas_min
// and gas_max as int4 [256] and the pruned table [256]; then the slot
// map's values [2 * depth][kQuads][kThreads] uint4, its tids and keys
// (slot indices) [2 * depth][kThreads], each substep's decoded record
// [depth][kThreads], the coverage words [span][kThreads], and each
// lane's slot index [kThreads][index bytes] (a slot's entry, 0xFF for
// none).
__host__ __device__ constexpr size_t shared_bytes(long long depth) {
  return static_cast<size_t>(256 * 16 + 256 + 2 * depth * kQuads * kThreads * 16 +
                             2 * 2 * depth * kThreads * 4 + depth * kThreads * 4 +
                             span_of(depth) * kThreads * 4 + kThreads * index_bytes(depth));
}

__device__ __forceinline__ long long clampll(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The lane's slot map in shared memory: entry e's quads, its tid, its
// key (the slot index).
struct Slots {
  uint4* vals;
  int32_t* tids;
  int32_t* keys;

  __device__ __forceinline__ uint4* quad(int e, int q) const {
    return vals + (e * kQuads + q) * kThreads + threadIdx.x;
  }
  __device__ __forceinline__ int32_t& tid(int e) const { return tids[e * kThreads + threadIdx.x]; }
  __device__ __forceinline__ int32_t& key(int e) const { return keys[e * kThreads + threadIdx.x]; }
  __device__ __forceinline__ void load(int e, uint32_t* w) const {
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const uint4 v = *quad(e, q);
      w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z, w[4 * q + 3] = v.w;
    }
  }
  __device__ __forceinline__ void store(int e, const uint32_t* w) const {
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      *quad(e, q) = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  }
  __device__ __forceinline__ void copy(int from, int to) const {
#pragma unroll
    for (int q = 0; q < kQuads; ++q) *quad(to, q) = *quad(from, q);
  }
  // limb i (0 <= i < 16, known only at run time) of entry e
  __device__ __forceinline__ uint32_t limb(int e, int i) const {
    return reinterpret_cast<const uint32_t*>(quad(e, i >> 2))[i & 3];
  }
};

__device__ __forceinline__ bool ult(const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int i = kLimbs - 1; i >= 0; --i)
    if (a[i] != b[i]) return a[i] < b[i];
  return false;
}

__device__ __forceinline__ bool slt(const uint32_t* a, const uint32_t* b) {
  const uint32_t sa = a[kLimbs - 1] >> 15, sb = b[kLimbs - 1] >> 15;
  if (sa != sb) return sa > sb;
  return ult(a, b);
}

__device__ __forceinline__ bool any_from(const uint32_t* a, int from) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) acc |= i >= from ? a[i] : 0u;
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

// Shifts, BYTE and SIGNEXTEND index the second operand's limbs by a
// value known only at run time: they read them from its entry `eb`.
__device__ void shl(const Slots& m, int eb, uint32_t s, uint32_t* r) {
  const int q = static_cast<int>(s >> 4), bs = static_cast<int>(s & 15);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int j = i - q;
    const uint32_t v1 = (s < 256 && j >= 0) ? m.limb(eb, j) : 0;
    const uint32_t v2 = (s < 256 && j - 1 >= 0) ? m.limb(eb, j - 1) : 0;
    r[i] = ((v1 << bs) | (bs ? v2 >> (16 - bs) : 0)) & kMask;
  }
}

__device__ void lshr(const Slots& m, int eb, uint32_t s, uint32_t* r) {
  const int q = static_cast<int>(s >> 4), bs = static_cast<int>(s & 15);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int j = i + q;
    const uint32_t v1 = (s < 256 && j < kLimbs) ? m.limb(eb, j) : 0;
    const uint32_t v2 = (s < 256 && j + 1 < kLimbs) ? m.limb(eb, j + 1) : 0;
    r[i] = ((v1 >> bs) | (bs ? v2 << (16 - bs) : 0)) & kMask;
  }
}

__device__ void ashr(const Slots& m, int eb, const uint32_t* b, uint32_t s, uint32_t* r) {
  const uint32_t s_cl = s < 256 ? s : 256;
  lshr(m, eb, s_cl, r);
  if (b[kLimbs - 1] >> 15) {
    const int fill_from = 256 - static_cast<int>(s_cl);
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
      const int start = static_cast<int>(clampll(fill_from - 16 * i, 0, 16));
      r[i] |= (0x10000u - (1u << start)) & kMask;
    }
  }
}

__device__ void byte_op(const Slots& m, int eb, const uint32_t* i, uint32_t* r) {
  const bool big = any_from(i, 1) || i[0] >= 32;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) r[k] = 0;
  if (!big) {
    const uint32_t pos = 31 - i[0];
    r[0] = (m.limb(eb, static_cast<int>(pos / 2)) >> (8 * (pos % 2))) & 0xFFu;
  }
}

__device__ void signextend(const Slots& m, int eb, const uint32_t* k, const uint32_t* x,
                           uint32_t* r) {
  const bool big = any_from(k, 1) || k[0] >= 31;
  if (big) {
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) r[i] = x[i];
    return;
  }
  const int t = 8 * static_cast<int>(k[0]) + 7;
  const uint32_t sign = (m.limb(eb, t / 16) >> (t % 16)) & 1u;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int nbits = static_cast<int>(clampll(t + 1 - 16 * i, 0, 16));
    const uint32_t low = ((1u << nbits) - 1u) & kMask;
    r[i] = sign ? (x[i] | (low ^ kMask)) : (x[i] & low);
  }
}

// The ALU family's result, the full step's expressions; b is entry eb.
__device__ void alu(int op, const uint32_t* a, const uint32_t* b, const Slots& m, int eb,
                    uint32_t* r) {
  switch (op) {
    case 0x01: {  // ADD
      uint32_t c = 0;
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) {
        const uint32_t s = a[i] + b[i] + c;
        r[i] = s & kMask;
        c = s >> 16;
      }
      return;
    }
    case 0x03: {  // SUB
      int32_t br = 0;
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) {
        const int32_t s = static_cast<int32_t>(a[i]) - static_cast<int32_t>(b[i]) - br;
        br = s < 0;
        r[i] = static_cast<uint32_t>(s + (br << 16)) & kMask;
      }
      return;
    }
    case 0x02: {  // MUL, mod 2**256
      unsigned long long acc = 0;
#pragma unroll
      for (int k = 0; k < kLimbs; ++k) {
#pragma unroll
        for (int i = 0; i <= k; ++i) acc += static_cast<unsigned long long>(a[i]) * b[k - i];
        r[k] = static_cast<uint32_t>(acc & kMask);
        acc >>= 16;
      }
      return;
    }
    case 0x16:  // AND
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) r[i] = a[i] & b[i];
      return;
    case 0x17:  // OR
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) r[i] = a[i] | b[i];
      return;
    case 0x18:  // XOR
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) r[i] = a[i] ^ b[i];
      return;
    case 0x19:  // NOT
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) r[i] = a[i] ^ kMask;
      return;
    case 0x10: set_bool(r, ult(a, b)); return;  // LT
    case 0x11: set_bool(r, ult(b, a)); return;  // GT
    case 0x12: set_bool(r, slt(a, b)); return;  // SLT
    case 0x13: set_bool(r, slt(b, a)); return;  // SGT
    case 0x14: {                                 // EQ
      uint32_t diff = 0;
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) diff |= a[i] ^ b[i];
      set_bool(r, diff == 0);
      return;
    }
    case 0x15: set_bool(r, !any_from(a, 0)); return;      // ISZERO
    case 0x1A: byte_op(m, eb, a, r); return;                // BYTE
    case 0x1B: shl(m, eb, shift_amount(a), r); return;      // SHL
    case 0x1C: lshr(m, eb, shift_amount(a), r); return;     // SHR
    case 0x1D: ashr(m, eb, b, shift_amount(a), r); return;  // SAR
    default: signextend(m, eb, a, b, r); return;            // SIGNEXTEND (0x0B)
  }
}

__device__ __forceinline__ bool is_alu(int op) {
  return (op >= 0x01 && op <= 0x03) || op == 0x0B || (op >= 0x10 && op <= 0x1D);
}

// The JAX package's wrap test for the symbolic lanes' ALU ops.
__device__ __forceinline__ bool wraps(int op, const uint32_t* a, const uint32_t* b) {
  if (op == 0x01) {  // ADD: ~a < b, that is a carry out of the top limb
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) c = (a[i] + b[i] + c) >> 16;
    return c != 0;
  }
  if (op == 0x03) return ult(a, b);  // SUB
  if (op == 0x02)                    // MUL, coarse
    return (any_from(a, kLimbs / 2) || any_from(b, kLimbs / 2)) && any_from(a, 0) &&
           any_from(b, 0);
  return false;
}

// An ALU substep on the slot map: entries ia and ib to entry out; false
// where a symbolic lane skips it. Out of line, so the substep loop stays
// short for the lanes that run no ALU op.
__device__ __noinline__ bool alu_step(int op, const Slots m, int ia, int ib, int out,
                                      bool symbolic) {
  uint32_t a[kLimbs], b[kLimbs], r[kLimbs];
  m.load(ia, a);
  m.load(ib, b);
  if (symbolic && (m.tid(ia) != 0 || m.tid(ib) != 0 || wraps(op, a, b))) return false;
  alu(op, a, b, m, ib, r);
  m.store(out, r);
  return true;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool is_push(int op) { return op >= 0x60 && op <= 0x7F; }

// A byte through the read-only cache, issued where it stands (the
// decode wants a substep's table byte and opcode in flight together).
__device__ __forceinline__ int ldg_u8(const uint8_t* at) {
  uint32_t v;
  asm volatile("ld.global.nc.u8 %0, [%1];\n" : "=r"(v) : "l"(at));
  return static_cast<int>(v);
}

// A decoded substep: its op, whether its row is a block head, its
// operand entries and output entry (kNone for none), packed in one int.
constexpr int kNone = 31;
__device__ __forceinline__ int pack(int op, bool head, int ia, int ib, int out) {
  return op | head << 8 | ia << 10 | ib << 15 | out << 20;
}

// The lane's words, read together.
struct Lane {
  int status, code_id, pc, sp;
  long long gas_min, gas_max, gas_budget;
};

// One RUNNING lane's iteration. `meta` and `unhandled` are the shared
// copies (unhandled null where the launch prunes nothing). Returns the
// substeps it ran; adds the heads it entered to `heads`.
__device__ int run_lane(const Params& p, long long lane, const Lane& w, const int4* meta,
                        const uint8_t* unhandled, const Slots& m, int32_t* rec, uint32_t* cov,
                        uint8_t* idx, int& heads) {
  const int t = static_cast<int>(threadIdx.x);
  const long long cid = clampll(w.code_id, 0, p.n_codes - 1);
  const int pc0 = w.pc, sp0 = w.sp;
  const long long gmin0 = w.gas_min, gmax0 = w.gas_max, budget = w.gas_budget;
  const uint8_t* code = p.ops + cid * p.ops_w;
  const uint8_t* trow = p.tbl + cid * p.tbl_w;
  // the code length, the first table byte and the first opcode together
  const long long clen = p.code_len[cid];
  const int row0 = ldg_u8(trow + clampll(pc0, 0, p.tbl_w - 1));
  const int op0 = ldg_u8(code + clampll(pc0, 0, p.ops_w - 33));
  const long long top_slot = p.stack_cap - 1;
  const long long limit = p.stack_cap < 1024 ? p.stack_cap : 1024;
  const long long w0 = clampll(pc0 >> 5, 0, p.words - 1);

  // decode: the substeps that can run, and the slots they touch; an
  // entry is read where its value comes from the launch's input. The
  // lane's slot index maps a clipped slot to its entry.
  const long long lo = clampll(sp0 - kMaxDrop * (p.depth - 1) - 17, 0, top_slot);
  const int index = index_bytes(p.depth);
  idx += t * index;
  for (int i = 0; i < index / 4; ++i) reinterpret_cast<uint32_t*>(idx)[i] = 0xFFFFFFFFu;
  int n_keys = 0;
  uint32_t load = 0;
  // the entry of a slot, made (and read first where `read`) if new
  auto touch = [&](long long slot, bool read) {
    const long long s = clampll(slot, 0, top_slot);
    const int e = idx[s - lo];
    if (e != 0xFF) return e;
    idx[s - lo] = static_cast<uint8_t>(n_keys);
    m.key(n_keys) = static_cast<int32_t>(s);
    load |= static_cast<uint32_t>(read) << n_keys;
    return n_keys++;
  };
  int pc = pc0, sp = sp0, n_dec = 0;
  long long gmin = gmin0;
  uint32_t dec_words = 0;  // coverage words, relative to w0, of the decoded pcs
  for (int k = 0; k < p.depth; ++k) {
    const int row = k ? ldg_u8(trow + clampll(pc, 0, p.tbl_w - 1)) : row0;
    const int op = k ? ldg_u8(code + clampll(pc, 0, p.ops_w - 33)) : op0;
    if (pc >= clen || (p.block ? row == 0 : row != 1)) break;
    const int4 mr = meta[op];  // pops, net_sp, gas_min, gas_max
    const int pops = mr.x, net = mr.y, g_lo = mr.z;
    if (sp < pops || sp + net > limit) break;
    if (((gmin + g_lo) & kM32) > budget) break;
    if (unhandled && unhandled[op]) break;
    int ia = kNone, ib = kNone, out = kNone;
    if (is_push(op)) {
      out = touch(sp, false);
    } else if (op >= 0x80 && op <= 0x8F) {  // DUP: source, copy
      ia = touch(sp - 1 - (op - 0x80), true);
      out = touch(sp, false);
    } else if (op >= 0x90 && op <= 0x9F) {  // SWAP: top, deep
      ia = touch(sp - 1, true);
      ib = touch(sp - 1 - (op - 0x8F), true);
    } else if (p.block && is_alu(op)) {
      ia = touch(sp - 1, true);
      ib = op == 0x15 || op == 0x19 ? ia : touch(sp - 2, true);  // ISZERO, NOT: unary
      out = touch(sp - pops, false);
    }
    rec[k * kThreads + t] = pack(op, row == 3, ia, ib, out);  // 3: ROW_HEAD
    dec_words |= 1u << (clampll(pc >> 5, 0, p.words - 1) - w0);
    pc += 1 + (is_push(op) ? op - 0x5F : 0);
    sp += net;
    gmin = (gmin + g_lo) & kM32;
    ++n_dec;
  }
  if (!n_dec) return 0;

  // the input slots, their tids and the coverage words, all in flight
  int32_t* st = p.stack + lane * p.stack_cap * kLimbs;
  int32_t* tids = p.stack_tid ? p.stack_tid + lane * p.stack_cap : nullptr;
  for (int e = 0; e < n_keys; ++e) {
    if (!((load >> e) & 1u)) continue;
    const int32_t* src = st + m.key(e) * kLimbs;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) cp_async16(m.quad(e, q), src + 4 * q);
    if (tids) cp_async4(&m.tid(e), tids + m.key(e));
  }
  int32_t* seen = p.pc_seen ? p.pc_seen + lane * p.words + w0 : nullptr;
  if (seen) {
#pragma unroll
    for (int i = 0; i < kMaxSpan; ++i)
      if ((dec_words >> i) & 1u) cp_async4(cov + i * kThreads + t, seen + i);
  }
  cp_async_wait_all();

  // run the decoded substeps on the map, to the first symbolic skip
  uint32_t dirty = 0, ran_words = 0;
  long long gmax = gmax0;
  gmin = gmin0, pc = pc0, sp = sp0;
  int ran = 0;
  for (; ran < n_dec; ++ran) {
    const int rv = rec[ran * kThreads + t];
    const int op = rv & 0xFF;
    const int ia = (rv >> 10) & 31, ib = (rv >> 15) & 31;
    int out = (rv >> 20) & 31, out_tid = 0;
    const int4 mr = meta[op];
    const int net = mr.y, g_lo = mr.z, g_hi = mr.w;
    if (is_push(op)) {  // the immediate, big-endian
      const int nb = op - 0x5F;
      const uint8_t* imm = code + clampll(pc, 0, p.ops_w - 33) + nb;
      uint32_t r[kLimbs];
#pragma unroll
      for (int l = 0; l < kLimbs; ++l) {
        const uint32_t lo = 2 * l < nb ? __ldg(imm - 2 * l) : 0;
        const uint32_t hi = 2 * l + 1 < nb ? __ldg(imm - 2 * l - 1) : 0;
        r[l] = lo | (hi << 8);
      }
      m.store(out, r);
    } else if (op >= 0x80 && op <= 0x8F) {  // DUP
      m.copy(ia, out);
      out_tid = m.tid(ia);
    } else if (op >= 0x90 && op <= 0x9F) {  // SWAP: the top gets the deep value
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const uint4 v = *m.quad(ia, q);
        *m.quad(ia, q) = *m.quad(ib, q);
        *m.quad(ib, q) = v;
      }
      out = ia;
      out_tid = m.tid(ib);
      m.tid(ib) = m.tid(ia);
      dirty |= 1u << ib;
    } else if (out != kNone) {  // an ALU op (block mode)
      if (!alu_step(op, m, ia, ib, out, tids != nullptr)) break;
    }
    if (out != kNone) {
      m.tid(out) = out_tid;
      dirty |= 1u << out;
    }
    if (seen) {
      const int w = static_cast<int>(clampll(pc >> 5, 0, p.words - 1) - w0);
      cov[w * kThreads + t] |= 1u << (pc & 31);
      ran_words |= 1u << w;
    }
    heads += (rv >> 8) & 1;
    pc += 1 + (is_push(op) ? op - 0x5F : 0);
    sp += net;
    gmin = (gmin + g_lo) & kM32;
    gmax = (gmax + g_hi) & kM32;
  }
  if (!ran) return 0;

  // write back: each changed slot once, with its last value
  for (int e = 0; e < n_keys; ++e) {
    if (!((dirty >> e) & 1u)) continue;
    uint4* dst = reinterpret_cast<uint4*>(st + m.key(e) * kLimbs);
#pragma unroll
    for (int q = 0; q < kQuads; ++q) dst[q] = *m.quad(e, q);
    if (tids) tids[m.key(e)] = m.tid(e);
  }
  if (seen) {
#pragma unroll
    for (int i = 0; i < kMaxSpan; ++i)
      if ((ran_words >> i) & 1u) seen[i] = static_cast<int32_t>(cov[i * kThreads + t]);
  }
  p.pc[lane] = pc;
  p.sp[lane] = sp;
  p.gas_min[lane] = gmin;
  p.gas_max[lane] = gmax;
  return ran;
}

__global__ void __launch_bounds__(kThreads) substep_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long depth = p.depth;
  int4* meta = reinterpret_cast<int4*>(smem);
  uint8_t* unhandled = reinterpret_cast<uint8_t*>(meta + 256);
  uint4* vals = reinterpret_cast<uint4*>(unhandled + 256);
  int32_t* tids = reinterpret_cast<int32_t*>(vals + 2 * depth * kQuads * kThreads);
  int32_t* keys = tids + 2 * depth * kThreads;
  int32_t* rec = keys + 2 * depth * kThreads;
  uint32_t* cov = reinterpret_cast<uint32_t*>(rec + depth * kThreads);
  uint8_t* idx = reinterpret_cast<uint8_t*>(cov + span_of(depth) * kThreads);
  // the meta rows (columns 2-5 of [256, 6]: two 8-byte copies each) and
  // the pruned table to shared memory while the lanes' words load: the
  // decode then reads no row of them from memory
  for (int op = threadIdx.x; op < 256; op += kThreads) {
    cp_async8(meta + op, p.meta + op * 6 + 2);
    cp_async8(reinterpret_cast<int32_t*>(meta + op) + 2, p.meta + op * 6 + 4);
  }
  if (p.unhandled)
    for (int i = threadIdx.x; i < 256 / 16; i += kThreads)
      cp_async16(unhandled + 16 * i, p.unhandled + 16 * i);
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Lane w{1, 0, 0, 0, 0, 0, 0};
  if (lane < p.n)
    w = Lane{p.status[lane], p.code_id[lane], p.pc[lane], p.sp[lane], p.gas_min[lane],
             p.gas_max[lane], p.gas_budget[lane]};
  cp_async_wait_all();
  __syncthreads();
  int ran = 0, heads = 0;
  if (w.status == 0)  // Status.RUNNING
    ran = run_lane(p, lane, w, meta, p.unhandled ? unhandled : nullptr,
                   Slots{vals, tids, keys}, rec, cov, idx, heads);
  const unsigned all = 0xFFFFFFFFu;
  const unsigned warp_ran = __reduce_add_sync(all, static_cast<unsigned>(ran));
  const unsigned warp_heads = __reduce_add_sync(all, static_cast<unsigned>(heads));
  if (threadIdx.x == 0 && warp_ran) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p.counts), warp_ran);
    if (warp_heads) atomicAdd(reinterpret_cast<unsigned long long*>(p.counts + 1), warp_heads);
  }
}

}  // namespace

extern "C" int substep_run(const char* params, void* stream) {
  Params p = *reinterpret_cast<const Params*>(params);
  if (p.n <= 0 || p.depth <= 0) return 0;
  if (p.depth > kMaxDepth || reinterpret_cast<uintptr_t>(p.stack) % 16 ||
      reinterpret_cast<uintptr_t>(p.meta) % 8 || reinterpret_cast<uintptr_t>(p.unhandled) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((p.n + kThreads - 1) / kThreads);
  substep_kernel<<<blocks, kThreads, shared_bytes(p.depth), static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int substep_params_bytes() { return static_cast<int>(sizeof(Params)); }

extern "C" int substep_max_depth() { return kMaxDepth; }
