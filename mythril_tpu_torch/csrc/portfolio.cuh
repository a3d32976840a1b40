// The portfolio solver's device half for NVIDIA Hopper (sm_90a): a flat
// tensor program over 16-bit limbs, evaluated for K candidate
// assignments (portfolio_eval, portfolio.cu), and the diversified
// stochastic local search over Q programs in one launch (portfolio_sls,
// portfolio_sls.cu). This header holds what both share: the evaluator,
// the program's staging into shared memory and the accessors.
//
// Replaces: the XLA device code of the JAX package's
// mythril_tpu/laser/smt/solver/portfolio.py, which is not a Pallas
// kernel but a `lax.scan` over the program's nodes with a 29-way
// `lax.switch` per node (`eval_program` and `score`, :517-625) inside a
// `lax.while_loop` of mutate, evaluate and accept (`search`, :635-812),
// vmapped over Q stacked programs by `_sls_batch` (:999-1004). In eager
// PyTorch each node of each step is several launches; here a whole
// evaluation, and a whole search, is one launch.
//
// Design: a group of kGroup = 4 threads evaluates one candidate (a
// "slot") at a time, node after node; the lanes split the limbs of the
// nodes whose limbs are independent and lane 0 computes the nodes with a
// chain across their limbs. Every slot of a block runs the same program,
// so the switch on the node's opcode never diverges; only the
// data-dependent loops do (udiv/urem start at each candidate's own top
// numerator bit). L (16, 32, 64 or 128 limbs of 16 bits) is a template
// parameter. Each kernel has two compile-time variants, chosen per
// launch by the host-side plan (ops/portfolio_eval.py:eval_plan,
// ops/portfolio_sls.py:sls_plan) from the real node count, L, K, V and
// the 227 KB a block may hold:
//
// - shared (kSmem): the program (8 ints a node, the constant pool as
//   uint16, the roots) is staged into dynamic shared memory once per
//   block, and each slot's node values live there as uint16 limbs, laid
//   out [rows, L, slots] so that the threads of a warp touch
//   neighbouring halfwords. The candidates (portfolio_eval: the block's
//   tile of X, read from [V, K, L] with coalesced loads; portfolio_sls:
//   the block's candidates) live there too.
// - global: a program too large for that keeps its node values and
//   candidates in device-memory scratch ([rows, L, slots], uint32) and
//   reads the program where the caller left it.
//
// A slot's value rows are the program's n nodes, then four scratch rows:
// a zero row (an argument that is not an earlier node reads zeros, as in
// the plain version), the moved variable's old row (the search), and the
// running remainder and its trial subtraction of the bit-serial division
// at L >= 64 (below that they stay in registers, as 32-bit words).
//
// portfolio_eval: blocks of up to 32 slots (128 threads), one candidate
// each, so that K = 4096 spreads over the whole card. Output: solved [K]
// and the soft score [K]. It serves device_enumerate (K = 4096 a chunk),
// rank_impact_vars ((V + 1) * 16 probes in one launch) and debug_eval.
//
// portfolio_sls: one query's K candidates spread over a thread-block
// cluster of 1, 2, 4 or 8 blocks (one cluster per query, launched with
// cudaLaunchKernelEx), T slots a block, each searching m candidates in
// turn: candidate k = rank * T m + j T + slot. A candidate's search
// state (score, best, stall, Luby pair) sits in shared memory; lane 0 of
// its group moves it and keeps the state. The JAX while_loop becomes a
// loop inside the cluster: after every step each block ORs its threads'
// solved flags (__syncthreads_or) into a shared flag and every block
// reads all the cluster's flags through distributed shared memory after
// cluster.sync(), so the search stops after the first step at which any
// candidate of the query is solved, as the JAX `cond` does. The
// solved-first argmax is reduced within each block, then across the
// cluster's blocks in rank order, which is candidate order (ties to the
// first lane). The random bits come from a counter-based hash keyed by
// (seed + query, step, lane, draw), the same one the plain PyTorch
// version computes (ops/portfolio_sls.py), and every noisy accept
// compares a draw with a per-lane integer threshold from the host:
// kernel and plain version are bit-equal on the same inputs. Its launch
// bounds ask for one block an SM: without that minimum ptxas held the
// search to 96-128 registers and spilled.
//
// Bound on an H100 SXM (700 W): operations. A node costs about 2-12
// int32 operations a limb, mul L(L+1)/2 multiply-adds more, udiv/urem
// 4(L+1)+3 per numerator bit (ops/portfolio_eval.py:node_ops); an
// evaluation is the sum over the program's nodes, for each candidate,
// over 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 Tops/s. The bytes are
// what the function must move, over 3.35 TB/s: X and the program read
// once, solved and score (or the winners) written once. For the
// frontier's programs the operations bound is the larger. An evaluation
// is a dependent chain of node after node, and K = 4096 candidates are
// about 8 warps an SM, so the kernels are bound by that chain's latency:
// the design keeps every node value one shared-memory access away (not
// an L2 round trip), issues a node's loads before its stores, splits a
// node's limbs over four lanes, and starts a division at the first
// numerator bit at which the remainder can reach the divisor (a 256-bit
// word over 2**224, the dispatcher's selector, takes 32 steps, not 256).
// The bound's count charges a division the same bitlen(a) - bitlen(b) + 1
// steps (none where b = 0 or a is the shorter).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// the dynamic shared memory of both kernels (the layouts below)
extern __shared__ __align__(16) char dyn_smem[];

namespace {

constexpr uint32_t kMask16 = 0xFFFFu;
constexpr int kFull = 1 << 10;  // soft-score scale per constraint

enum Op {
  kConst = 0, kVar, kAdd, kSub, kMul, kUdiv, kUrem, kAnd, kOr, kXor, kNot,
  kShl, kLshr, kAshr, kConcat, kExtract, kZext, kSext, kIte, kEq, kUlt,
  kUle, kSlt, kSle, kBand, kBor, kBnot, kBxor, kImplies
};

// a slot's scratch rows after the program's n node rows
enum { kZeroRow = 0, kBackupRow, kRemRow, kTrialRow, kScratchRows };

// The threads that share one candidate's evaluation: lane g of the group
// owns limbs g, g + kGroup, g + 2 kGroup, ... (neighbouring lanes on
// neighbouring limbs, so a warp's accesses stay conflict-free). A node
// whose limbs are independent (constants, variables, the bitwise ops,
// shifts, concat and extract, ite, and the bool words of eq, the
// compares and the bool ops) is split over the group; a node with a
// chain across its limbs (add, sub, sext, mul, udiv, urem) is computed by
// lane 0 alone. Each node ends with __syncwarp().
constexpr int kGroup = 4;

// candidates a block (each kGroup threads): portfolio_eval's at most, and
// portfolio_sls's at most by L (the plans in ops/ hold the same numbers)
constexpr int kEvalSlots = 32;
template <int L>
constexpr int sls_max_slots() { return L <= 32 ? 64 : 32; }

// one node of the program, as the evaluator reads it: arguments that are
// not earlier nodes point at the zero row; aw is the width of argument 0
struct Node {
  int op, w, a0, a1, a2, i0, i1, aw;
};

__device__ __forceinline__ Node make_node(const int* op, const int* args, const int* imms,
                                          const int* width, int i, int n, int N) {
  Node r;
  r.op = op[i];
  r.w = width[i];
  const int a0 = args[3 * i], a1 = args[3 * i + 1], a2 = args[3 * i + 2];
  r.aw = (a0 >= 0 && a0 < N) ? width[a0] : 1;
  const int zero = n + kZeroRow;
  r.a0 = (a0 >= 0 && a0 < i) ? a0 : zero;
  r.a1 = (a1 >= 0 && a1 < i) ? a1 : zero;
  r.a2 = (a2 >= 0 && a2 < i) ? a2 : zero;
  r.i0 = imms[2 * i];
  r.i1 = imms[2 * i + 1];
  return r;
}

// a program staged in shared memory: nodes [n] x 8 ints, pool [C, L]
// uint16, roots [R] (the node index, -1 where masked off)
template <int L>
struct SmemProg {
  const int4* nodes;
  const uint16_t* pool;
  const int* roots;
  int R;
  __device__ __forceinline__ Node node(int i) const {
    const int4 x = nodes[2 * i], y = nodes[2 * i + 1];
    return Node{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  }
  __device__ __forceinline__ uint32_t pool_at(int row, int l) const {
    return pool[row * L + l];
  }
  __device__ __forceinline__ int root(int r) const { return roots[r]; }
};

// a program read where the caller left it (the global variant)
template <int L>
struct GlobalProg {
  const int *op, *args, *imms, *width, *pool, *roots, *rmask;
  int n, N, R;
  __device__ __forceinline__ Node node(int i) const {
    return make_node(op, args, imms, width, i, n, N);
  }
  __device__ __forceinline__ uint32_t pool_at(int row, int l) const {
    return (uint32_t)pool[row * L + l];
  }
  __device__ __forceinline__ int root(int r) const { return rmask[r] ? roots[r] : -1; }
};

// one candidate's rows: element (row, l) at p[row * rs + l * ls]. The
// index is int: the wrappers refuse a scratch whose index would not fit.
template <typename E>
struct Col {
  E* p;
  int rs, ls;
  __device__ __forceinline__ uint32_t ld(int row, int l) const {
    return (uint32_t)p[row * rs + l * ls];
  }
  __device__ __forceinline__ void st(int row, int l, uint32_t x) const {
    p[row * rs + l * ls] = (E)x;
  }
};

// portfolio.py width_mask: limb l of a width-w value
__device__ __forceinline__ uint32_t wmask(int w, int l) {
  int bits = w - 16 * l;
  if (bits >= 16) return kMask16;
  if (bits <= 0) return 0u;
  return (1u << bits) - 1u;
}

// a node's mask: a width-1 node keeps limb 1, its soft score
__device__ __forceinline__ uint32_t nmask(int w, int l) {
  return (w == 1 && l == 1) ? kMask16 : wmask(w, l);
}

// u256.shift_amount: any limb above the first set saturates to 0xFFFF
template <int L, class V>
__device__ __forceinline__ uint32_t shift_amount(const V& v, int b) {
  uint32_t hi = 0u;
#pragma unroll 4
  for (int l = 1; l < L; ++l) hi |= v.ld(b, l);
  return hi != 0u ? kMask16 : v.ld(b, 0);
}

// limb l of (row << s) and of (row >> s) over L limbs; s >= 16 L gives 0
template <int L, class V>
__device__ __forceinline__ uint32_t shl_limb(const V& v, int a, int l, uint32_t s) {
  if (s >= 16u * L) return 0u;
  const int ls = (int)(s >> 4), bs = (int)(s & 15u);
  const int i1 = l - ls;
  const uint32_t v1 = i1 >= 0 ? v.ld(a, i1) : 0u;
  const uint32_t v2 = i1 - 1 >= 0 ? v.ld(a, i1 - 1) : 0u;
  return ((v1 << bs) | (v2 >> (16 - bs))) & kMask16;
}

template <int L, class V>
__device__ __forceinline__ uint32_t lshr_limb(const V& v, int a, int l, uint32_t s) {
  if (s >= 16u * L) return 0u;
  const int ls = (int)(s >> 4), bs = (int)(s & 15u);
  const int i1 = l + ls;
  const uint32_t v1 = i1 < L ? v.ld(a, i1) : 0u;
  const uint32_t v2 = i1 + 1 < L ? v.ld(a, i1 + 1) : 0u;
  return ((v1 >> bs) | (v2 << (16 - bs))) & kMask16;
}

// (A ^ x) < (B ^ x) unsigned, x pool row `xrow` (-1: plain A < B); every
// limb's load is issued at once and the compare folds from the bottom
template <int L, class V, class P>
__device__ __forceinline__ bool ult(const V& v, const P& P_, int a, int b, int xrow) {
  bool lt = false;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    uint32_t al = v.ld(a, l), bl = v.ld(b, l);
    if (xrow >= 0) {
      const uint32_t x = P_.pool_at(xrow, l);
      al ^= x;
      bl ^= x;
    }
    lt = al < bl || (al == bl && lt);
  }
  return lt;
}

// udiv/urem of one candidate: bit-serial long division, from the first
// numerator bit at which the remainder can reach the divisor (the
// numerator's bits above it are the remainder's start); x / 0 and x % 0
// are 0. The remainder has L + 1 limbs; each bit shifts it left,
// brings in the numerator bit and subtracts the divisor where the borrow
// chain says it is not smaller (one pass: the compare is the chain's
// last borrow). At L <= 32 the remainder and the divisor sit in
// registers as 32-bit words; above, the remainder and its trial
// difference sit in the slot's scratch rows (`sel` picks which row
// holds the current one).
template <int L, class V>
__device__ __forceinline__ void udivmod(const V& v, int a, int b, int i, bool want_rem, int w,
                                        int n) {
  // the top set bits of the numerator and of the divisor
  int top = -1, dtop = -1;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    const uint32_t al = v.ld(a, l), bl = v.ld(b, l);
    if (al != 0u) top = 16 * l + 31 - __clz(al);
    if (bl != 0u) dtop = 16 * l + 31 - __clz(bl);
  }
  const bool dz = dtop < 0;  // x / 0 and x % 0 are 0
  // No subtraction can happen before the remainder holds as many bits as
  // the divisor: the numerator's bits above bit `start` go into it at
  // once (they leave q at 0), and the loop runs from bit `start` down.
  // A numerator shorter than the divisor is the remainder as it is.
  const int start = (dz || top < 0) ? -1 : top - dtop;
  const uint32_t pre = (uint32_t)(start + 1 > 0 ? start + 1 : 0);
  const int start_limb = start >= 0 ? start >> 4 : -1;
  if constexpr (L <= 32) {
    // the remainder and the divisor as 32-bit words (two limbs each),
    // one more word for the remainder's top bit: half the carry chain of
    // 16-bit limbs, and the same integers
    constexpr int W = L / 2 + 1;
    uint32_t d[W], r[W];
#pragma unroll
    for (int j = 0; j < W - 1; ++j) {
      d[j] = v.ld(b, 2 * j) | (v.ld(b, 2 * j + 1) << 16);
      r[j] = dz ? 0u
                : lshr_limb<L>(v, a, 2 * j, pre) | (lshr_limb<L>(v, a, 2 * j + 1, pre) << 16);
    }
    d[W - 1] = 0u;
    r[W - 1] = 0u;
#pragma unroll 1
    for (int li = L - 1; li >= 0; --li) {
      uint32_t qw = 0u;
      if (li <= start_limb) {
        const uint32_t word = v.ld(a, li);
        const int hi = li == start_limb ? (start & 15) : 15;
#pragma unroll 1
        for (int bit = hi; bit >= 0; --bit) {
          uint32_t cin = (word >> bit) & 1u;
#pragma unroll
          for (int j = 0; j < W; ++j) {
            const uint32_t x = r[j];
            r[j] = (x << 1) | cin;
            cin = x >> 31;
          }
          uint32_t t[W];
          uint32_t c = 1u;
#pragma unroll
          for (int j = 0; j < W; ++j) {
            const unsigned long long s = (unsigned long long)r[j] + (uint32_t)~d[j] + c;
            t[j] = (uint32_t)s;
            c = (uint32_t)(s >> 32);
          }
#pragma unroll
          for (int j = 0; j < W; ++j) r[j] = c ? t[j] : r[j];
          qw |= c << bit;
        }
      }
      if (!want_rem) v.st(i, li, qw & nmask(w, li));
    }
    if (want_rem) {
#pragma unroll
      for (int l = 0; l < L; ++l) v.st(i, l, ((r[l >> 1] >> (16 * (l & 1))) & kMask16) & nmask(w, l));
    }
  } else {
    const int R0 = n + kRemRow, R1 = n + kTrialRow;
#pragma unroll 4
    for (int l = 0; l < L; ++l) v.st(R0, l, dz ? 0u : lshr_limb<L>(v, a, l, pre));
    uint32_t rtop = 0u, ttop = 0u;
    bool sel = false;  // false: the remainder is row R0, true: row R1
#pragma unroll 1
    for (int li = L - 1; li >= 0; --li) {
      uint32_t qw = 0u;
      if (li <= start_limb) {
        const uint32_t word = v.ld(a, li);
        const int hi = li == start_limb ? (start & 15) : 15;
#pragma unroll 1
        for (int bit = hi; bit >= 0; --bit) {
          // shift the current remainder into R0 and its difference with
          // the divisor into R1, then keep the one the borrow picks
          const int cur = sel ? R1 : R0;
          const uint32_t top_in = sel ? ttop : rtop;
          uint32_t cin = (word >> bit) & 1u, c = 1u;
#pragma unroll 4
          for (int l = 0; l < L; ++l) {
            const uint32_t x = v.ld(cur, l);
            const uint32_t sh = ((x << 1) | cin) & kMask16;
            cin = x >> 15;
            const uint32_t s = sh + (kMask16 - v.ld(b, l)) + c;
            v.st(R0, l, sh);
            v.st(R1, l, s & kMask16);
            c = s >> 16;
          }
          const uint32_t shtop = ((top_in << 1) | cin) & kMask16;
          const uint32_t s = shtop + kMask16 + c;
          rtop = shtop;
          ttop = s & kMask16;
          sel = (s >> 16) != 0u;
          if (sel) qw |= 1u << bit;
        }
      }
      if (!want_rem) v.st(i, li, qw & nmask(w, li));
    }
    if (want_rem) {
      const int cur = sel ? R1 : R0;
#pragma unroll 4
      for (int l = 0; l < L; ++l) v.st(i, l, v.ld(cur, l) & nmask(w, l));
    }
  }
}

// A node's limbs in chunks of kChunk: `f(c0, o)` computes limbs c0 ..
// c0 + kChunk - 1 into registers, loading everything it reads before it
// computes, then the chunk is masked and stored. No store comes between
// a chunk's loads (the compiler cannot tell the rows apart, so a store
// would hold back every later load): the loads go out together and a
// node costs about one shared-memory round trip, not one per limb.
constexpr int kChunk = 16;

template <int L, class V, class F>
__device__ __forceinline__ void put_chunks(const V& v, int i, int w, F&& f) {
#pragma unroll 1
  for (int c0 = 0; c0 < L; c0 += kChunk) {
    uint32_t o[kChunk];
    f(c0, o);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v.st(i, c0 + j, o[j] & nmask(w, c0 + j));
  }
}

// limbs c0 .. c0 + kChunk - 1 of a row into registers
template <class V>
__device__ __forceinline__ void ld_chunk(const V& v, int row, int c0, uint32_t* out) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) out[j] = v.ld(row, c0 + j);
}

// a node's own limbs: `f(l)` for each limb l this lane owns, computed
// (loads first) then masked and stored, kSub limbs at a time
template <int L, class V, class F>
__device__ __forceinline__ void put_own(const V& v, int i, int w, int g, F&& f) {
  constexpr int kOwn = L / kGroup, kSub = kOwn < 8 ? kOwn : 8;
#pragma unroll 1
  for (int j0 = 0; j0 < kOwn; j0 += kSub) {
    uint32_t o[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) o[j] = f((j0 + j) * kGroup + g);
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int l = (j0 + j) * kGroup + g;
      v.st(i, l, o[j] & nmask(w, l));
    }
  }
}

// Evaluate one candidate's whole program (its first n nodes) into its
// value rows `v` and return (solved, score) over the roots, as lane g of
// the candidate's group (every lane of the warp runs it, in step). X
// gives the candidate's variables: (v, l) at x.ld(v, l).
template <int L, class P, class V, class X>
__device__ __forceinline__ void eval_program(const P& p, const X& x, const V& v, int n, int g,
                                             bool* solved, int* score) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const Node nd = p.node(i);
    const int w = nd.w, A = nd.a0, B = nd.a1, Cc = nd.a2;
    if (nd.op == kAdd || nd.op == kSub || nd.op == kMul || nd.op == kUdiv || nd.op == kUrem ||
        nd.op == kSext) {
      // a chain across the limbs: lane 0 computes the whole node
      if (g == 0) {
        switch (nd.op) {
          case kAdd:
          case kSub: {
            // a + b, or a + ~b + 1
            const bool sub = nd.op == kSub;
            uint32_t c = sub ? 1u : 0u;
            put_chunks<L>(v, i, w, [&](int c0, uint32_t* o) {
              uint32_t a[kChunk], b[kChunk];
              ld_chunk(v, A, c0, a);
              ld_chunk(v, B, c0, b);
#pragma unroll
              for (int j = 0; j < kChunk; ++j) {
                const uint32_t t = a[j] + (sub ? kMask16 - b[j] : b[j]) + c;
                o[j] = t & kMask16;
                c = t >> 16;
              }
            });
            break;
          }
          case kMul: {
            // the low L limbs of the product: schoolbook, one output
            // limb at a time with a running 64-bit carry; at L <= 32 both
            // operands are first loaded into registers
            if constexpr (L <= 32) {
              uint32_t ra[L], rb[L];
#pragma unroll
              for (int l = 0; l < L; ++l) {
                ra[l] = v.ld(A, l);
                rb[l] = v.ld(B, l);
              }
              unsigned long long c = 0ull;
#pragma unroll
              for (int l = 0; l < L; ++l) {
                unsigned long long acc = c;
#pragma unroll
                for (int j = 0; j <= l; ++j) acc += (unsigned long long)ra[j] * rb[l - j];
                v.st(i, l, (uint32_t)(acc & kMask16) & nmask(w, l));
                c = acc >> 16;
              }
            } else {
              unsigned long long c = 0ull;
#pragma unroll 4
              for (int l = 0; l < L; ++l) {
                unsigned long long acc = c;
                for (int j = 0; j <= l; ++j)
                  acc += (unsigned long long)v.ld(A, j) * v.ld(B, l - j);
                v.st(i, l, (uint32_t)(acc & kMask16) & nmask(w, l));
                c = acc >> 16;
              }
            }
            break;
          }
          case kUdiv:
          case kUrem:
            udivmod<L>(v, A, B, i, nd.op == kUrem, w, n);
            break;
          case kSext: {
            // (a ^ signbit) - signbit
            uint32_t c = 1u;
            put_chunks<L>(v, i, w, [&](int c0, uint32_t* o) {
              uint32_t a[kChunk], k[kChunk];
              ld_chunk(v, A, c0, a);
#pragma unroll
              for (int j = 0; j < kChunk; ++j) k[j] = p.pool_at(nd.i0, c0 + j);
#pragma unroll
              for (int j = 0; j < kChunk; ++j) {
                const uint32_t t = (a[j] ^ k[j]) + (kMask16 - k[j]) + c;
                o[j] = t & kMask16;
                c = t >> 16;
              }
            });
            break;
          }
        }
      }
      __syncwarp();
      continue;
    }
    switch (nd.op) {
      case kConst:
        put_own<L>(v, i, w, g, [&](int l) { return p.pool_at(nd.i0, l); });
        break;
      case kVar:
        put_own<L>(v, i, w, g, [&](int l) { return x.ld(nd.i0, l); });
        break;
      case kAnd:
        put_own<L>(v, i, w, g, [&](int l) { return v.ld(A, l) & v.ld(B, l); });
        break;
      case kOr:
        put_own<L>(v, i, w, g, [&](int l) { return v.ld(A, l) | v.ld(B, l); });
        break;
      case kXor:
        put_own<L>(v, i, w, g, [&](int l) { return v.ld(A, l) ^ v.ld(B, l); });
        break;
      case kNot:
        put_own<L>(v, i, w, g, [&](int l) { return v.ld(A, l) ^ kMask16; });
        break;
      case kZext:
        put_own<L>(v, i, w, g, [&](int l) { return v.ld(A, l); });
        break;
      case kIte: {
        const int src = v.ld(A, 0) != 0u ? B : Cc;
        put_own<L>(v, i, w, g, [&](int l) { return v.ld(src, l); });
        break;
      }
      case kShl: {
        const uint32_t s = shift_amount<L>(v, B);
        put_own<L>(v, i, w, g, [&](int l) { return shl_limb<L>(v, A, l, s); });
        break;
      }
      case kLshr: {
        const uint32_t s = shift_amount<L>(v, B);
        put_own<L>(v, i, w, g, [&](int l) { return lshr_limb<L>(v, A, l, s); });
        break;
      }
      case kConcat:
        put_own<L>(v, i, w, g, [&](int l) {
          return shl_limb<L>(v, A, l, (uint32_t)nd.i0) | v.ld(B, l);
        });
        break;
      case kExtract:
        put_own<L>(v, i, w, g, [&](int l) { return lshr_limb<L>(v, A, l, (uint32_t)nd.i0); });
        break;
      case kAshr: {
        // lshr | sign fill at the node's width (pool row i0 the sign
        // bit, pool row i1 all ones); every lane reads the sign
        const uint32_t s = shift_amount<L>(v, B);
        bool neg = false;
#pragma unroll 4
        for (int l = 0; l < L; ++l) neg = neg || ((v.ld(A, l) & p.pool_at(nd.i0, l)) != 0u);
        put_own<L>(v, i, w, g, [&](int l) {
          uint32_t r = lshr_limb<L>(v, A, l, s);
          if (neg) {
            // limb l of (pool row i1) >> s
            uint32_t fill = 0u;
            if (s < 16u * L) {
              const int ls = (int)(s >> 4), bs = (int)(s & 15u);
              const int j1 = l + ls;
              const uint32_t v1 = j1 < L ? p.pool_at(nd.i1, j1) : 0u;
              const uint32_t v2 = j1 + 1 < L ? p.pool_at(nd.i1, j1 + 1) : 0u;
              fill = ((v1 >> bs) | (v2 << (16 - bs))) & kMask16;
            }
            r |= (fill ^ kMask16) & p.pool_at(nd.i1, l);
          }
          return r;
        });
        break;
      }
      default: {
        // a bool word (limb 0 the truth, limb 1 the soft score); eq sums
        // its differing bits over the group, the compares and the bool
        // ops are computed by every lane
        bool hard = false;
        int soft = 0;
        switch (nd.op) {
          case kEq: {
            // hard: every limb equal; soft: the bit-level Hamming credit
            // over all L limbs, against the first argument's width
            int diff = 0;
#pragma unroll
            for (int j = 0; j < L / kGroup; ++j) {
              const int l = j * kGroup + g;
              diff += __popc(v.ld(A, l) ^ v.ld(B, l));
            }
#pragma unroll
            for (int o = 1; o < kGroup; o <<= 1) diff += __shfl_xor_sync(0xFFFFFFFFu, diff, o);
            const int aw = nd.aw > 1 ? nd.aw : 1;
            hard = diff == 0;
            soft = ((aw - (diff < aw ? diff : aw)) * kFull) / aw;
            break;
          }
          case kUlt:
            hard = ult<L>(v, p, A, B, -1);
            soft = hard ? kFull : 0;
            break;
          case kUle:
            hard = !ult<L>(v, p, B, A, -1);
            soft = hard ? kFull : 0;
            break;
          case kSlt:
            hard = ult<L>(v, p, A, B, nd.i0);
            soft = hard ? kFull : 0;
            break;
          case kSle:
            hard = !ult<L>(v, p, B, A, nd.i0);
            soft = hard ? kFull : 0;
            break;
          case kBand: {
            const int sa = (int)v.ld(A, 1), sb = (int)v.ld(B, 1);
            hard = v.ld(A, 0) != 0u && v.ld(B, 0) != 0u;
            soft = sa < sb ? sa : sb;
            break;
          }
          case kBor: {
            const int sa = (int)v.ld(A, 1), sb = (int)v.ld(B, 1);
            hard = v.ld(A, 0) != 0u || v.ld(B, 0) != 0u;
            soft = sa > sb ? sa : sb;
            break;
          }
          case kBnot:
            hard = v.ld(A, 0) == 0u;
            soft = kFull - (int)v.ld(A, 1);
            break;
          case kBxor:
            hard = (v.ld(A, 0) != 0u) != (v.ld(B, 0) != 0u);
            soft = hard ? kFull : 0;
            break;
          case kImplies: {
            const int sa = kFull - (int)v.ld(A, 1), sb = (int)v.ld(B, 1);
            hard = v.ld(A, 0) == 0u || v.ld(B, 0) != 0u;
            soft = sa > sb ? sa : sb;
            break;
          }
          default:  // an unknown opcode: zero
            break;
        }
        const bool word = nd.op >= kEq && nd.op <= kImplies;
        put_own<L>(v, i, w, g, [&](int l) {
          return !word ? 0u : l == 0 ? (uint32_t)hard : l == 1 ? (uint32_t)soft : 0u;
        });
        break;
      }
    }
    __syncwarp();
  }
  bool hard = true;
  int soft = 0;
  for (int r = 0; r < p.R; ++r) {
    const int node = p.root(r);
    if (node < 0) continue;
    hard = hard && v.ld(node, 0) != 0u;
    soft += (int)v.ld(node, 1);
  }
  *solved = hard;
  *score = soft;
}

// ---------------------------------------------------------------------------
// shared-memory layouts. The kernels carve their dynamic shared memory by
// these functions and the C entries refuse a launch whose `smem` falls
// short of them; the plans' counts (ops/portfolio_eval.py:eval_smem_bytes,
// ops/portfolio_sls.py:sls_smem_bytes) must equal them, which chip_smoke.py
// checks through the exported portfolio_eval_smem / portfolio_sls_smem.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int align16(long long x) { return (int)((x + 15) / 16 * 16); }

// a staged program: nodes [n] x 8 ints, then the pool [C, L] as uint16,
// then the roots [R]
__host__ __device__ inline int program_pool_at(int n) { return align16((long long)n * 32); }
__host__ __device__ inline int program_roots_at(int n, int C, int L) {
  return program_pool_at(n) + align16((long long)C * L * 2);
}
__host__ __device__ inline int program_bytes(int n, int C, int R, int L) {
  return program_roots_at(n, C, L) + align16((long long)R * 4);
}

// the value rows of `slots` candidates: [n + kScratchRows, L, slots] uint16
__host__ __device__ inline int value_rows_bytes(int n, int L, int slots) {
  return align16((long long)slots * (n + kScratchRows) * L * 2);
}

// Stage a program into shared memory (program_bytes of it): nodes, pool
// and roots, from the caller's arrays.
template <int L>
__device__ __forceinline__ void stage_program(char* base, const int* op, const int* args,
                                             const int* imms, const int* width,
                                             const int* pool, const int* roots,
                                             const int* rmask, int n, int N, int C, int R,
                                             SmemProg<L>* out) {
  int4* nodes = reinterpret_cast<int4*>(base);
  uint16_t* pl = reinterpret_cast<uint16_t*>(base + program_pool_at(n));
  int* rt = reinterpret_cast<int*>(base + program_roots_at(n, C, L));
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Node nd = make_node(op, args, imms, width, i, n, N);
    nodes[2 * i] = make_int4(nd.op, nd.w, nd.a0, nd.a1);
    nodes[2 * i + 1] = make_int4(nd.a2, nd.i0, nd.i1, nd.aw);
  }
  for (int e = threadIdx.x; e < C * L; e += blockDim.x) pl[e] = (uint16_t)pool[e];
  for (int r = threadIdx.x; r < R; r += blockDim.x) rt[r] = rmask[r] ? roots[r] : -1;
  out->nodes = nodes;
  out->pool = pl;
  out->roots = rt;
  out->R = R;
}

template <class Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return 0;
}

}  // namespace
