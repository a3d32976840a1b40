// The portfolio solver's device half for NVIDIA Hopper (sm_90a): a flat
// tensor program over 16-bit limbs, evaluated for K candidate
// assignments (portfolio_eval), and the diversified stochastic local
// search over Q programs in one launch (portfolio_sls).
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
// Design: one thread per candidate. The node values live in a scratch
// tensor laid out [N, L, K] (one query's slice), so that the 32 threads
// of a warp, which hold 32 neighbouring candidates, read and write each
// limb of a node as one coalesced 128-byte access. Limbs are uint32
// holding 16 bits, L (16, 32, 64 or 128) is a template parameter. Every
// thread of a block runs the same program, so the switch on the node's
// opcode never diverges; only the data-dependent loops do (udiv/urem
// start at each thread's own top numerator bit). The program arrays are
// read through the read-only cache, the same address by every thread.
//
// portfolio_eval: a grid over K for one program, X as [V, K, L]; it
// serves device_enumerate (K = 4096 a chunk), rank_impact_vars (K = 16)
// and debug_eval. Output: solved [K] and the soft score [K].
//
// portfolio_sls: one block per query, min(K, 256) threads, each looping
// over its candidates (k, k + 256, ...). The JAX while_loop becomes a
// loop inside the block that stops when __syncthreads_or(solved) is
// true or `steps` is reached, as the JAX `cond` does; then the final
// score and the solved-first argmax (ties to the first lane).
// The random bits come from a counter-based hash keyed by (seed + query,
// step, lane, draw), the same one the plain PyTorch version computes
// (ops/portfolio_sls.py), and every noisy accept compares a draw with a
// per-lane integer threshold from the host: kernel and plain version
// are bit-equal on the same inputs. A candidate lives in a scratch
// tensor [V, L, K], its moved variable's old row in [L, K] (restored
// when the move is refused) and its search state (score, best, stall,
// Luby pair) in [5, K].
//
// Bound on an H100 SXM (700 W): operations. A node costs about 3 int32
// operations a limb (add, sub, the bitwise ops, the shifts, compares),
// mul L(L+1)/2 multiply-adds, udiv/urem 4 L+5 per numerator bit; an
// evaluation is the sum over the program's nodes, for each candidate,
// over 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 Tops/s. The bytes are
// what the function must move, over 3.35 TB/s: X and the program read
// once, solved and score (or the winners) written once; the [N, L, K]
// node-value scratch is this design's, not the function's, and one
// query's fits in the 50 MB L2. For the frontier's programs the
// operations bound is the larger.
// At the explorer's Q of a few to a few hundred blocks of 64 threads the
// card holds far fewer warps than it can schedule, so a search is bound
// by the latency of its dependent node loads, not by either rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMask16 = 0xFFFFu;
constexpr int kFull = 1 << 10;  // soft-score scale per constraint

enum Op {
  kConst = 0, kVar, kAdd, kSub, kMul, kUdiv, kUrem, kAnd, kOr, kXor, kNot,
  kShl, kLshr, kAshr, kConcat, kExtract, kZext, kSext, kIte, kEq, kUlt,
  kUle, kSlt, kSle, kBand, kBor, kBnot, kBxor, kImplies
};

// One query's program: the flat arrays of portfolio.py's `Program`.
struct Prog {
  const int* op;     // [N]
  const int* args;   // [N, 3]
  const int* imms;   // [N, 2]
  const int* width;  // [N]
  const int* pool;   // [C, L]
  const int* roots;  // [R]
  const int* rmask;  // [R]
  int n_nodes;       // nodes evaluated (the real ones; padding is unread)
  int n_roots;       // R
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
template <int L>
__device__ __forceinline__ uint32_t shift_amount(const uint32_t* b, int K) {
  for (int l = 1; l < L; ++l)
    if (b[(size_t)l * K] != 0u) return kMask16;
  return b[0];
}

// limb l of (src << s) and of (src >> s) over L limbs; s >= 16 L gives 0
template <int L>
__device__ __forceinline__ uint32_t shl_limb(const uint32_t* src, int K, int l, uint32_t s) {
  if (s >= 16u * L) return 0u;
  int ls = (int)(s >> 4), bs = (int)(s & 15u);
  int i1 = l - ls;
  uint32_t v1 = i1 >= 0 ? src[(size_t)i1 * K] : 0u;
  uint32_t v2 = i1 - 1 >= 0 ? src[(size_t)(i1 - 1) * K] : 0u;
  return ((v1 << bs) | (v2 >> (16 - bs))) & kMask16;
}

template <int L>
__device__ __forceinline__ uint32_t lshr_limb(const uint32_t* src, int K, int l, uint32_t s) {
  if (s >= 16u * L) return 0u;
  int ls = (int)(s >> 4), bs = (int)(s & 15u);
  int i1 = l + ls;
  uint32_t v1 = i1 < L ? src[(size_t)i1 * K] : 0u;
  uint32_t v2 = i1 + 1 < L ? src[(size_t)(i1 + 1) * K] : 0u;
  return ((v1 >> bs) | (v2 << (16 - bs))) & kMask16;
}

// (a ^ x) < (b ^ x) unsigned, x a pool row (nullptr: plain a < b)
template <int L>
__device__ __forceinline__ bool ult(const uint32_t* a, const uint32_t* b, int K,
                                    const int* x) {
  for (int l = L - 1; l >= 0; --l) {
    uint32_t al = a[(size_t)l * K], bl = b[(size_t)l * K];
    if (x != nullptr) {
      al ^= (uint32_t)x[l];
      bl ^= (uint32_t)x[l];
    }
    if (al != bl) return al < bl;
  }
  return false;
}

// store a bool word: limb 0 the truth, limb 1 the soft score
template <int L>
__device__ __forceinline__ void put_bool(uint32_t* out, int K, int w, bool hard, int soft) {
  out[0] = (uint32_t)hard & nmask(w, 0);
  if (L > 1) out[(size_t)K] = (uint32_t)soft & nmask(w, 1);
  for (int l = 2; l < L; ++l) out[(size_t)l * K] = 0u;
}

__device__ __forceinline__ int soft_of(const uint32_t* x, int K) {
  return (int)x[(size_t)K];
}

// udiv/urem of one candidate: bit-serial long division from the top set
// bit of the numerator (the bits above it leave q and r at 0); x / 0 and
// x % 0 are 0
template <int L>
__device__ __noinline__ void udivmod(const uint32_t* a, const uint32_t* b, int K, bool want_rem,
                        uint32_t* out, int w) {
  uint32_t d[L + 1], r[L + 1], q[L];
  bool dz = true;
  int top = -1;
  for (int l = 0; l < L; ++l) {
    d[l] = b[(size_t)l * K];
    dz = dz && d[l] == 0u;
    r[l] = 0u;
    q[l] = 0u;
    uint32_t al = a[(size_t)l * K];
    if (al != 0u) top = 16 * l + 31 - __clz(al);
  }
  d[L] = 0u;
  r[L] = 0u;
  if (!dz) {
    for (int j = top; j >= 0; --j) {
      uint32_t bit = (a[(size_t)(j >> 4) * K] >> (j & 15)) & 1u;
      for (int l = L; l >= 1; --l) r[l] = ((r[l] << 1) | (r[l - 1] >> 15)) & kMask16;
      r[0] = ((r[0] << 1) | bit) & kMask16;
      bool ge = true;
      for (int l = L; l >= 0; --l) {
        if (r[l] != d[l]) {
          ge = r[l] > d[l];
          break;
        }
      }
      if (ge) {
        uint32_t borrow = 1u;
        for (int l = 0; l <= L; ++l) {
          uint32_t t = r[l] + (kMask16 - d[l]) + borrow;
          r[l] = t & kMask16;
          borrow = t >> 16;
        }
        q[j >> 4] |= 1u << (j & 15);
      }
    }
  }
  for (int l = 0; l < L; ++l) {
    uint32_t v = dz ? 0u : (want_rem ? r[l] : q[l]);
    out[(size_t)l * K] = v & nmask(w, l);
  }
}

// Evaluate one candidate's whole program into `vals` (this thread's
// column of an [N, L, K] scratch: element (i, l) at (i * L + l) * K) and
// return (solved, score) over the roots. X is this thread's column of
// the assignment: variable v, limb l at v * xv + l * xl. Not inlined:
// the search calls it three times, and one copy per limb count keeps
// the build time and the register count down.
template <int L>
__device__ __noinline__ void eval_program(const Prog& p, const uint32_t* X, long long xv, long long xl,
                             uint32_t* vals, int K, bool* solved, int* score) {
  for (int i = 0; i < p.n_nodes; ++i) {
    const int opc = __ldg(p.op + i);
    const int w = __ldg(p.width + i);
    const int a0 = __ldg(p.args + 3 * i), a1 = __ldg(p.args + 3 * i + 1),
              a2 = __ldg(p.args + 3 * i + 2);
    const int i0 = __ldg(p.imms + 2 * i), i1 = __ldg(p.imms + 2 * i + 1);
    uint32_t* out = vals + (size_t)i * L * K;
    const uint32_t* A = vals + (size_t)a0 * L * K;
    const uint32_t* B = vals + (size_t)a1 * L * K;
    const uint32_t* C = vals + (size_t)a2 * L * K;
    const int* k0 = p.pool + (size_t)i0 * L;
    const int* k1 = p.pool + (size_t)i1 * L;
    switch (opc) {
      case kConst:
        for (int l = 0; l < L; ++l) out[(size_t)l * K] = (uint32_t)__ldg(k0 + l) & nmask(w, l);
        break;
      case kVar:
        for (int l = 0; l < L; ++l)
          out[(size_t)l * K] = X[i0 * xv + l * xl] & nmask(w, l);
        break;
      case kAdd: {
        uint32_t c = 0u;
        for (int l = 0; l < L; ++l) {
          uint32_t t = A[(size_t)l * K] + B[(size_t)l * K] + c;
          out[(size_t)l * K] = t & kMask16 & nmask(w, l);
          c = t >> 16;
        }
        break;
      }
      case kSub: {
        uint32_t c = 1u;
        for (int l = 0; l < L; ++l) {
          uint32_t t = A[(size_t)l * K] + (kMask16 - B[(size_t)l * K]) + c;
          out[(size_t)l * K] = t & kMask16 & nmask(w, l);
          c = t >> 16;
        }
        break;
      }
      case kMul: {
        // the low L limbs of the product: schoolbook, one output limb at
        // a time with a running 64-bit carry
        unsigned long long c = 0ull;
        for (int l = 0; l < L; ++l) {
          unsigned long long acc = c;
          for (int j = 0; j <= l; ++j)
            acc += (unsigned long long)A[(size_t)j * K] * B[(size_t)(l - j) * K];
          out[(size_t)l * K] = (uint32_t)(acc & kMask16) & nmask(w, l);
          c = acc >> 16;
        }
        break;
      }
      case kUdiv:
      case kUrem:
        udivmod<L>(A, B, K, opc == kUrem, out, w);
        break;
      case kAnd:
        for (int l = 0; l < L; ++l)
          out[(size_t)l * K] = (A[(size_t)l * K] & B[(size_t)l * K]) & nmask(w, l);
        break;
      case kOr:
        for (int l = 0; l < L; ++l)
          out[(size_t)l * K] = (A[(size_t)l * K] | B[(size_t)l * K]) & nmask(w, l);
        break;
      case kXor:
        for (int l = 0; l < L; ++l)
          out[(size_t)l * K] = (A[(size_t)l * K] ^ B[(size_t)l * K]) & nmask(w, l);
        break;
      case kNot:
        for (int l = 0; l < L; ++l) out[(size_t)l * K] = (A[(size_t)l * K] ^ kMask16) & nmask(w, l);
        break;
      case kShl: {
        uint32_t s = shift_amount<L>(B, K);
        for (int l = 0; l < L; ++l) out[(size_t)l * K] = shl_limb<L>(A, K, l, s) & nmask(w, l);
        break;
      }
      case kLshr: {
        uint32_t s = shift_amount<L>(B, K);
        for (int l = 0; l < L; ++l) out[(size_t)l * K] = lshr_limb<L>(A, K, l, s) & nmask(w, l);
        break;
      }
      case kAshr: {
        // lshr | sign fill at the node's width (k0 the sign bit, k1 all ones)
        uint32_t s = shift_amount<L>(B, K);
        bool neg = false;
        for (int l = 0; l < L; ++l) neg = neg || ((A[(size_t)l * K] & (uint32_t)__ldg(k0 + l)) != 0u);
        for (int l = 0; l < L; ++l) {
          uint32_t v = lshr_limb<L>(A, K, l, s);
          if (neg) {
            // limb l of k1 >> s, from the pool row (stride 1)
            uint32_t fill = 0u;
            if (s < 16u * L) {
              int ls = (int)(s >> 4), bs = (int)(s & 15u);
              int j1 = l + ls;
              uint32_t v1 = j1 < L ? (uint32_t)__ldg(k1 + j1) : 0u;
              uint32_t v2 = j1 + 1 < L ? (uint32_t)__ldg(k1 + j1 + 1) : 0u;
              fill = ((v1 >> bs) | (v2 << (16 - bs))) & kMask16;
            }
            v |= (fill ^ kMask16) & (uint32_t)__ldg(k1 + l);
          }
          out[(size_t)l * K] = v & nmask(w, l);
        }
        break;
      }
      case kConcat:
        for (int l = 0; l < L; ++l)
          out[(size_t)l * K] = (shl_limb<L>(A, K, l, (uint32_t)i0) | B[(size_t)l * K]) & nmask(w, l);
        break;
      case kExtract:
        for (int l = 0; l < L; ++l) out[(size_t)l * K] = lshr_limb<L>(A, K, l, (uint32_t)i0) & nmask(w, l);
        break;
      case kZext:
        for (int l = 0; l < L; ++l) out[(size_t)l * K] = A[(size_t)l * K] & nmask(w, l);
        break;
      case kSext: {
        // (a ^ signbit) - signbit
        uint32_t c = 1u;
        for (int l = 0; l < L; ++l) {
          uint32_t kl = (uint32_t)__ldg(k0 + l);
          uint32_t t = (A[(size_t)l * K] ^ kl) + (kMask16 - kl) + c;
          out[(size_t)l * K] = t & kMask16 & nmask(w, l);
          c = t >> 16;
        }
        break;
      }
      case kIte: {
        const uint32_t* src = A[0] != 0u ? B : C;
        for (int l = 0; l < L; ++l) out[(size_t)l * K] = src[(size_t)l * K] & nmask(w, l);
        break;
      }
      case kEq: {
        // hard: every limb equal; soft: the bit-level Hamming credit over
        // all L limbs, against the first argument's width
        bool hard = true;
        int diff = 0;
        for (int l = 0; l < L; ++l) {
          uint32_t x = A[(size_t)l * K] ^ B[(size_t)l * K];
          hard = hard && x == 0u;
          diff += __popc(x);
        }
        int aw = __ldg(p.width + a0);
        aw = aw > 1 ? aw : 1;
        int soft = ((aw - (diff < aw ? diff : aw)) * kFull) / aw;
        put_bool<L>(out, K, w, hard, soft);
        break;
      }
      case kUlt: {
        bool h = ult<L>(A, B, K, nullptr);
        put_bool<L>(out, K, w, h, h ? kFull : 0);
        break;
      }
      case kUle: {
        bool h = !ult<L>(B, A, K, nullptr);
        put_bool<L>(out, K, w, h, h ? kFull : 0);
        break;
      }
      case kSlt: {
        bool h = ult<L>(A, B, K, k0);
        put_bool<L>(out, K, w, h, h ? kFull : 0);
        break;
      }
      case kSle: {
        bool h = !ult<L>(B, A, K, k0);
        put_bool<L>(out, K, w, h, h ? kFull : 0);
        break;
      }
      case kBand: {
        int sa = soft_of(A, K), sb = soft_of(B, K);
        put_bool<L>(out, K, w, A[0] != 0u && B[0] != 0u, sa < sb ? sa : sb);
        break;
      }
      case kBor: {
        int sa = soft_of(A, K), sb = soft_of(B, K);
        put_bool<L>(out, K, w, A[0] != 0u || B[0] != 0u, sa > sb ? sa : sb);
        break;
      }
      case kBnot:
        put_bool<L>(out, K, w, A[0] == 0u, kFull - soft_of(A, K));
        break;
      case kBxor: {
        bool h = (A[0] != 0u) != (B[0] != 0u);
        put_bool<L>(out, K, w, h, h ? kFull : 0);
        break;
      }
      case kImplies: {
        int sa = kFull - soft_of(A, K), sb = soft_of(B, K);
        put_bool<L>(out, K, w, A[0] == 0u || B[0] != 0u, sa > sb ? sa : sb);
        break;
      }
      default:
        for (int l = 0; l < L; ++l) out[(size_t)l * K] = 0u;
        break;
    }
  }
  bool hard = true;
  int soft = 0;
  for (int r = 0; r < p.n_roots; ++r) {
    if (__ldg(p.rmask + r) == 0) continue;
    const uint32_t* v = vals + (size_t)__ldg(p.roots + r) * L * K;
    hard = hard && v[0] != 0u;
    soft += (int)v[(size_t)K];
  }
  *solved = hard;
  *score = soft;
}

template <int L>
__global__ void portfolio_eval_kernel(Prog p, const uint32_t* X, int K, uint32_t* vals,
                                      int* solved, int* score) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  bool s;
  int sc;
  // X is [V, K, L]
  eval_program<L>(p, X + (size_t)k * L, (long long)K * L, 1, vals + k, K, &s, &sc);
  solved[k] = s;
  score[k] = sc;
}

// ---------------------------------------------------------------------------
// the counter-based generator (ops/portfolio_sls.py computes the same)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// the stream of (key, step, lane): one hash, then one mix per draw
__device__ __forceinline__ uint32_t stream_of(uint32_t key, uint32_t step, uint32_t lane) {
  uint32_t h = mix32(lane + 0x9E3779B9u);
  h = mix32(h ^ step);
  return mix32(h ^ key);
}

__device__ __forceinline__ uint32_t draw(uint32_t h, uint32_t d) {
  return mix32(h ^ ((d + 1u) * 0x85EBCA6Bu));
}

constexpr uint32_t kInitStep = 0xFFFFFFFFu;
constexpr int kInitDraw = 8;
// Threads per query block. Without a bound the kernel held 158 to 255
// registers a thread by L (ptxas, sm_90a), so a block of more than
// about 256 threads could not launch; with this one it holds 128 to 255.
// A thread searches candidates k, k + 256, ...: K is unbounded.
constexpr int kSlsThreads = 256;
// a candidate's search state, rows of a [kStateRows, K] scratch
enum { kCur = 0, kBest, kStall, kLubU, kLubV, kStateRows };

template <int L>
__global__ void __launch_bounds__(kSlsThreads) portfolio_sls_kernel(
    const int* op, const int* args, const int* imms, const int* width, const int* pool,
    const int* roots, const int* rmask, const int* var_width, const int* n_vars,
    const int* n_consts, const int* n_nodes, const long long* thresholds, int K, int N, int C,
    int R, int V, uint32_t seed, int steps, int n_greedy, int n_seeded, int restart_base,
    uint32_t* vals_all, uint32_t* x_all, uint32_t* backup_all, int* state_all,
    int* solved_out, int* winners, int* steps_out) {
  __shared__ int s_key[kSlsThreads];
  __shared__ int s_idx[kSlsThreads];
  __shared__ int s_win;
  const int q = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  Prog p;
  p.op = op + (size_t)q * N;
  p.args = args + (size_t)q * N * 3;
  p.imms = imms + (size_t)q * N * 2;
  p.width = width + (size_t)q * N;
  p.pool = pool + (size_t)q * C * L;
  p.roots = roots + (size_t)q * R;
  p.rmask = rmask + (size_t)q * R;
  p.n_nodes = n_nodes[q];
  p.n_roots = R;
  const int* vw = var_width + (size_t)q * V;
  const int nv = n_vars[q] > 1 ? n_vars[q] : 1;
  const int nc = n_consts[q] > 1 ? n_consts[q] : 1;
  const uint32_t key = seed + (uint32_t)q;
  // candidate k's column of each scratch: values [N, L, K], candidates
  // [V, L, K] ((v, l) at (v L + l) K), the moved row [L, K], the state
  uint32_t* const vals_q = vals_all + (size_t)q * N * L * K;
  uint32_t* const x_q = x_all + (size_t)q * V * L * K;
  uint32_t* const bk_q = backup_all + (size_t)q * L * K;
  int* const st = state_all + (size_t)q * kStateRows * K;
  const long long xv = (long long)L * K, xl = K;

  // the candidate pool: random limbs, lane 0 zero, lane 1 one, lanes
  // 2 .. 2 + n_seeded from the constant pool (cycling per variable)
  bool any = false;
  for (int k = t; k < K; k += T) {
    uint32_t* X = x_q + k;
    const uint32_t h = stream_of(key, kInitStep, (uint32_t)k);
    for (int v = 0; v < V; ++v) {
      int w = __ldg(vw + v);
      for (int l = 0; l < L; ++l) {
        uint32_t x;
        if (k == 0) {
          x = 0u;
        } else if (k == 1) {
          x = l == 0 ? 1u : 0u;
        } else if (k < 2 + n_seeded) {
          x = (uint32_t)__ldg(p.pool + (size_t)(((k - 2) + v) % nc) * L + l);
        } else {
          x = draw(h, (uint32_t)(kInitDraw + v * L + l)) & kMask16;
        }
        X[v * xv + l * xl] = x & wmask(w, l);
      }
    }
    bool solved;
    int score;
    eval_program<L>(p, X, xv, xl, vals_q + k, K, &solved, &score);
    st[kCur * K + k] = score;
    st[kBest * K + k] = score;
    st[kStall * K + k] = 0;
    st[kLubU * K + k] = 1;
    st[kLubV * K + k] = 1;
    any = any || solved;
  }
  int it = 0;
  bool done = __syncthreads_or(any) != 0;
  while (it < steps && !done) {
    any = false;
    for (int k = t; k < K; k += T) {
      uint32_t* X = x_q + k;
      uint32_t* bk = bk_q + k;
      const bool greedy = k < n_greedy;
      const uint32_t h = stream_of(key, (uint32_t)it, (uint32_t)k);
      const uint32_t r0 = draw(h, 0), r1 = draw(h, 1), r2 = draw(h, 2), r3 = draw(h, 3),
                     r4 = draw(h, 4), r5 = draw(h, 5);
      const int v = (int)(r0 % (uint32_t)nv);
      const int kind_full = (int)(r1 % 6u);
      const int kind =
          greedy ? (kind_full % 3 == 0 ? 0 : (kind_full % 3 == 1 ? 3 : 4)) : kind_full;
      const int w = __ldg(vw + v);
      const int cap = (w + 15) / 16 > 1 ? (w + 15) / 16 : 1;
      const int limb = (int)((r2 % (uint32_t)L) % (uint32_t)cap);
      const uint32_t bits = r3 & kMask16;
      const int cidx = (int)((r4 % (uint32_t)(C > 1 ? C : 1)) % (uint32_t)nc);
      uint32_t* row = X + v * xv;
      for (int l = 0; l < L; ++l) bk[(size_t)l * K] = row[l * xl];
      if (kind <= 2) {
        uint32_t cv = row[limb * xl];
        row[limb * xl] = kind == 0 ? (cv ^ (1u << (bits & 15u))) : (kind == 1 ? bits : 0u);
      } else if (kind == 5) {
        for (int l = 0; l < L; ++l) row[l * xl] = (uint32_t)__ldg(p.pool + (size_t)cidx * L + l);
      } else {
        // whole-variable increment (3) or decrement (4)
        uint32_t c = kind == 3 ? 0u : 1u;
        for (int l = 0; l < L; ++l) {
          uint32_t one = l == 0 ? 1u : 0u;
          uint32_t t2 = kind == 3 ? row[l * xl] + one + c : row[l * xl] + (kMask16 - one) + c;
          row[l * xl] = t2 & kMask16;
          c = t2 >> 16;
        }
      }
      for (int l = 0; l < L; ++l) row[l * xl] &= wmask(w, l);
      bool nsolved;
      int nscore;
      eval_program<L>(p, X, xv, xl, vals_q + k, K, &nsolved, &nscore);
      int cur = st[kCur * K + k], best = st[kBest * K + k], stall = st[kStall * K + k];
      int lub_u = st[kLubU * K + k], lub_v = st[kLubV * K + k];
      const bool accept = nscore >= cur || r5 < (uint32_t)thresholds[k] || nsolved;
      if (accept) {
        cur = nscore;
      } else {
        for (int l = 0; l < L; ++l) row[l * xl] = bk[(size_t)l * K];
      }
      const bool improved = nscore > best;
      best = nscore > best ? nscore : best;
      stall = (improved || nsolved) ? 0 : stall + 1;
      // Luby restarts: a lane stalled past its budget reseeds every
      // variable with a multiplicative mix of this step's draw
      const bool restart = stall >= lub_v * restart_base && !nsolved;
      if (restart) {
        for (int vv = 0; vv < V; ++vv) {
          int ww = __ldg(vw + vv);
          for (int l = 0; l < L; ++l) {
            uint32_t mix = (bits * 0x9E3779B9u) ^ ((uint32_t)(l + 1) * 0x85EBCA6Bu);
            X[vv * xv + l * xl] = (X[vv * xv + l * xl] ^ mix) & wmask(ww, l);
          }
        }
        cur = -(1 << 30);
        stall = 0;
        const bool last = (lub_u & -lub_u) == lub_v;
        if (last) lub_u += 1;
        lub_v = last ? 1 : lub_v * 2;
      }
      st[kCur * K + k] = cur;
      st[kBest * K + k] = best;
      st[kStall * K + k] = stall;
      st[kLubU * K + k] = lub_u;
      st[kLubV * K + k] = lub_v;
      any = any || nsolved;
    }
    ++it;
    done = __syncthreads_or(any) != 0;
  }
  // solved first, then the best soft score (at most R * 1024, below
  // 2**30); ties to the first lane: each thread scans its candidates in
  // order, thread 0 merges the threads by key, then by index
  int my_key = 0, my_idx = -1;
  for (int k = t; k < K; k += T) {
    bool solved;
    int score;
    eval_program<L>(p, x_q + k, xv, xl, vals_q + k, K, &solved, &score);
    const int kk = score + (solved ? (1 << 30) : 0);
    if (my_idx < 0 || kk > my_key) {
      my_key = kk;
      my_idx = k;
    }
  }
  s_key[t] = my_key;
  s_idx[t] = my_idx;
  __syncthreads();
  if (t == 0) {
    int bi = 0;
    for (int j = 1; j < T; ++j)
      if (s_key[j] > s_key[bi] || (s_key[j] == s_key[bi] && s_idx[j] < s_idx[bi])) bi = j;
    s_win = s_idx[bi];
    solved_out[q] = s_key[bi] >= (1 << 30);
    steps_out[q] = it;
  }
  __syncthreads();
  const uint32_t* xw = x_q + s_win;
  for (int e = t; e < V * L; e += T) winners[(size_t)q * V * L + e] = (int)xw[(size_t)e * K];
}

template <int L>
int launch_eval(const Prog& p, const uint32_t* X, int K, uint32_t* vals, int* solved,
                int* score, cudaStream_t stream) {
  const int threads = 128;
  portfolio_eval_kernel<L><<<(K + threads - 1) / threads, threads, 0, stream>>>(
      p, X, K, vals, solved, score);
  return (int)cudaGetLastError();
}

template <int L>
int launch_sls(int Q, int K, const int* op, const int* args, const int* imms,
               const int* width, const int* pool, const int* roots, const int* rmask,
               const int* var_width, const int* n_vars, const int* n_consts,
               const int* n_nodes, const long long* thresholds, int N, int C, int R, int V,
               uint32_t seed, int steps, int n_greedy, int n_seeded, int restart_base,
               uint32_t* vals, uint32_t* xs, uint32_t* backup, int* state, int* solved_out,
               int* winners, int* steps_out, cudaStream_t stream) {
  const int threads = K < kSlsThreads ? K : kSlsThreads;
  portfolio_sls_kernel<L><<<Q, threads, 0, stream>>>(
      op, args, imms, width, pool, roots, rmask, var_width, n_vars, n_consts, n_nodes,
      thresholds, K, N, C, R, V, seed, steps, n_greedy, n_seeded, restart_base, vals, xs,
      backup, state, solved_out, winners, steps_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Evaluate one program for K candidates. X is int32 [V, K, L] (16-bit
// limbs), vals an int32 scratch of N * L * K elements; solved and score
// are int32 [K].
extern "C" int portfolio_eval(int L, int n_nodes, int R, int K, const int* op,
                              const int* args, const int* imms, const int* width,
                              const int* pool, const int* roots, const int* rmask,
                              const int* X, int* vals, int* solved, int* score,
                              cudaStream_t stream) {
  if (K <= 0) return 0;
  Prog p = {op, args, imms, width, pool, roots, rmask, n_nodes, R};
  const uint32_t* x = reinterpret_cast<const uint32_t*>(X);
  uint32_t* v = reinterpret_cast<uint32_t*>(vals);
  switch (L) {
    case 16: return launch_eval<16>(p, x, K, v, solved, score, stream);
    case 32: return launch_eval<32>(p, x, K, v, solved, score, stream);
    case 64: return launch_eval<64>(p, x, K, v, solved, score, stream);
    case 128: return launch_eval<128>(p, x, K, v, solved, score, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The diversified SLS over Q stacked programs, one block of
// min(K, 256) threads each. Program arrays are int32 [Q, ...] as
// portfolio.py stacks them; thresholds int64 [K] (the per-lane noise
// accept threshold out of 2**32); scratch: vals Q * N * L * K, xs
// Q * V * L * K, backup Q * L * K, state Q * 5 * K int32. Outputs:
// solved [Q], winners [Q, V, L], steps [Q].
extern "C" int portfolio_sls(int L, int Q, int K, int N, int C, int R, int V,
                             const int* op, const int* args, const int* imms,
                             const int* width, const int* pool, const int* roots,
                             const int* rmask, const int* var_width, const int* n_vars,
                             const int* n_consts, const int* n_nodes,
                             const long long* thresholds, unsigned int seed, int steps,
                             int n_greedy, int n_seeded, int restart_base, int* vals,
                             int* xs, int* backup, int* state, int* solved_out, int* winners,
                             int* steps_out, cudaStream_t stream) {
  if (Q <= 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  uint32_t* v = reinterpret_cast<uint32_t*>(vals);
  uint32_t* x = reinterpret_cast<uint32_t*>(xs);
  uint32_t* b = reinterpret_cast<uint32_t*>(backup);
#define PORTFOLIO_SLS_CASE(LL)                                                          \
  case LL:                                                                              \
    return launch_sls<LL>(Q, K, op, args, imms, width, pool, roots, rmask, var_width,   \
                          n_vars, n_consts, n_nodes, thresholds, N, C, R, V, seed,      \
                          steps, n_greedy, n_seeded, restart_base, v, x, b, state,      \
                          solved_out, winners, steps_out, stream);
  switch (L) {
    PORTFOLIO_SLS_CASE(16)
    PORTFOLIO_SLS_CASE(32)
    PORTFOLIO_SLS_CASE(64)
    PORTFOLIO_SLS_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PORTFOLIO_SLS_CASE
}
