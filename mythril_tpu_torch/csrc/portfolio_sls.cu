// portfolio_sls: the diversified stochastic local search over Q
// compiled programs in one launch on NVIDIA Hopper (sm_90a), a query's
// candidates over a thread-block cluster. The evaluator, the design
// and the bound are in portfolio.cuh.

#include <type_traits>

#include "portfolio.cuh"

namespace {

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
// a candidate's search state, rows of a [kStateRows, B] shared array
enum { kCur = 0, kBest, kStall, kLubU, kLubV, kStateRows };
enum { kPhaseInit = 0, kPhaseStep, kPhaseFinal };
// the block's control words in shared memory: two solved flags, the
// argmax's key and lane, the winner (every shared byte is dynamic, so
// the layout's count is the launch's)
constexpr int kCtlBytes = 32;

// A search block's dynamic shared memory: [the staged program], the
// variable widths, the search state [kStateRows, per_block], the
// argmax's scratch (an int2 a thread), the control words, [the
// candidates [V, L, per_block] and the slots' value rows, uint16]; the
// bracketed regions only in the shared variant. `total` bytes in all.
struct SlsLayout {
  int vw, st, red, ctl, xs, vals, total;
};

__host__ __device__ inline SlsLayout sls_layout(int n, int L, int V, int C, int R, int slots,
                                                int per_block, bool shared) {
  SlsLayout o;
  o.vw = shared ? program_bytes(n, C, R, L) : 0;
  o.st = o.vw + align16((long long)V * 4);
  o.red = o.st + align16((long long)kStateRows * per_block * 4);
  o.ctl = o.red + align16((long long)slots * kGroup * 8);
  o.xs = o.ctl + kCtlBytes;
  o.vals = o.xs + (shared ? align16((long long)V * L * per_block * 2) : 0);
  o.total = o.vals + (shared ? value_rows_bytes(n, L, slots) : 0);
  return o;
}

// ---------------------------------------------------------------------------
// portfolio_sls
// ---------------------------------------------------------------------------

struct SlsArgs {
  const int *op, *args, *imms, *width, *pool, *roots, *rmask, *var_width, *n_vars, *n_consts,
      *n_nodes;
  const long long* thresholds;  // [K]
  uint32_t* xs;    // global variant: candidates [Q, V, L, cluster x per-block]
  uint32_t* vals;  // global variant: value rows [Q, N + 4, L, cluster x slots]
  int* solved_out;
  int* winners;  // [Q, V, L]
  int* steps_out;
  int K, N, C, R, V;
  uint32_t seed;
  int steps, n_greedy, n_seeded, restart_base;
  int slots;       // T: candidates a block searches at once, kGroup threads each
  int per_thread;  // m: candidates a slot searches in turn
};

template <int L, bool kSmem>
__global__ void __launch_bounds__(sls_max_slots<L>() * kGroup, 1) portfolio_sls_kernel(SlsArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int Cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int q = blockIdx.x / Cs, t = threadIdx.x, NT = blockDim.x;
  // this thread's slot and its lane in the slot's group
  const int T = a.slots, s0 = t / kGroup, g = t % kGroup;
  const int m = a.per_thread, B = T * m;
  const int Kp = Cs * B;  // the cluster's lanes: K and the slots past it
  const int K = a.K, V = a.V, C = a.C;
  const int N = a.N, R = a.R;
  // the layout holds N nodes a query; a count past it is not the caller's
  // to give, and is held to N
  const int n = a.n_nodes[q] < N ? a.n_nodes[q] : N;
  const int* op = a.op + (size_t)q * N;
  const int* args = a.args + (size_t)q * N * 3;
  const int* imms = a.imms + (size_t)q * N * 2;
  const int* width = a.width + (size_t)q * N;
  const int* pool = a.pool + (size_t)q * C * L;
  const int* roots = a.roots + (size_t)q * R;
  const int* rmask = a.rmask + (size_t)q * R;

  // shared regions (sls_layout, at this query's node count)
  char* base = dyn_smem;
  const SlsLayout lay = sls_layout(n, L, V, C, R, T, B, kSmem);
  SmemProg<L> sp;
  if constexpr (kSmem)
    stage_program<L>(base, op, args, imms, width, pool, roots, rmask, n, N, C, R, &sp);
  int* vw = reinterpret_cast<int*>(base + lay.vw);
  int* st = reinterpret_cast<int*>(base + lay.st);
  int2* red = reinterpret_cast<int2*>(base + lay.red);
  // the block's solved flags (double-buffered), its argmax and the winner
  int* const s_flag = reinterpret_cast<int*>(base + lay.ctl);
  int& s_bkey = s_flag[2];
  int& s_bidx = s_flag[3];
  int& s_win = s_flag[4];
  for (int v = t; v < V; v += NT) vw[v] = a.var_width[(size_t)q * V + v];

  // the variant's storage: uint16 rows in shared memory, or uint32 rows
  // in the device-memory scratch
  using E = typename std::conditional<kSmem, uint16_t, uint32_t>::type;
  // the candidates' variables: (v, l) of slot c (shared) or lane k
  // (global) at xbase[c or k + (v L + l) xstride]
  E* xbase;
  int xstride;
  Col<E> val;  // this slot's value rows
  if constexpr (kSmem) {
    xbase = reinterpret_cast<uint16_t*>(base + lay.xs);
    xstride = B;
    val = Col<E>{reinterpret_cast<uint16_t*>(base + lay.vals) + s0, L * T, T};
  } else {
    const int G = Cs * T;
    xbase = a.xs + (size_t)q * V * L * Kp;
    xstride = Kp;
    val = Col<E>{a.vals + (size_t)q * (N + kScratchRows) * L * G + rank * T + s0, L * G, G};
  }
  for (int l = g; l < L; l += kGroup) val.st(n + kZeroRow, l, 0u);
  __syncthreads();

  const int nv = a.n_vars[q] > 1 ? a.n_vars[q] : 1;
  const int nc = a.n_consts[q] > 1 ? a.n_consts[q] : 1;
  const uint32_t key = a.seed + (uint32_t)q;
  int it = 0, phase = kPhaseInit, round = 0;
  int my_key = 0, my_idx = -1;
  for (;;) {
    bool any = false;
    for (int j = 0; j < m; ++j) {
      // every slot runs, past K too (a group's lanes evaluate in step
      // with the warp's other groups); only a live one keeps state
      const int c = j * T + s0;    // the candidate's slot in the block
      const int k = rank * B + c;  // its lane
      const bool live = k < K;
      const Col<E> xc{xbase + (kSmem ? c : k), L * xstride, xstride};
      const int bk = n + kBackupRow;
      uint32_t r3 = 0u, r5 = 0u;
      int v = 0;
      if (g != 0) {
        // lane 0 of the group moves the candidate
      } else if (phase == kPhaseInit) {
        // the candidate pool: random limbs, lane 0 zero, lane 1 one,
        // lanes 2 .. 2 + n_seeded from the constant pool (cycling per
        // variable)
        const uint32_t h = stream_of(key, kInitStep, (uint32_t)k);
        for (int vv = 0; vv < V; ++vv) {
          const int w = vw[vv];
#pragma unroll 4
          for (int l = 0; l < L; ++l) {
            uint32_t x;
            if (k == 0) {
              x = 0u;
            } else if (k == 1) {
              x = l == 0 ? 1u : 0u;
            } else if (k < 2 + a.n_seeded) {
              x = (uint32_t)pool[(size_t)(((k - 2) + vv) % nc) * L + l];
            } else {
              x = draw(h, (uint32_t)(kInitDraw + vv * L + l)) & kMask16;
            }
            xc.st(vv, l, x & wmask(w, l));
          }
        }
      } else if (phase == kPhaseStep && live) {
        const bool greedy = k < a.n_greedy;
        const uint32_t h = stream_of(key, (uint32_t)it, (uint32_t)k);
        const uint32_t r0 = draw(h, 0), r1 = draw(h, 1), r2 = draw(h, 2), r4 = draw(h, 4);
        r3 = draw(h, 3);
        r5 = draw(h, 5);
        v = (int)(r0 % (uint32_t)nv);
        const int kind_full = (int)(r1 % 6u);
        const int kind =
            greedy ? (kind_full % 3 == 0 ? 0 : (kind_full % 3 == 1 ? 3 : 4)) : kind_full;
        const int w = vw[v];
        const int cap = (w + 15) / 16 > 1 ? (w + 15) / 16 : 1;
        const int limb = (int)((r2 % (uint32_t)L) % (uint32_t)cap);
        const uint32_t bits = r3 & kMask16;
        const int cidx = (int)((r4 % (uint32_t)(C > 1 ? C : 1)) % (uint32_t)nc);
#pragma unroll 4
        for (int l = 0; l < L; ++l) val.st(bk, l, xc.ld(v, l));
        if (kind <= 2) {
          const uint32_t cv = xc.ld(v, limb);
          xc.st(v, limb, kind == 0 ? (cv ^ (1u << (bits & 15u))) : (kind == 1 ? bits : 0u));
        } else if (kind == 5) {
#pragma unroll 4
          for (int l = 0; l < L; ++l) xc.st(v, l, (uint32_t)pool[(size_t)cidx * L + l]);
        } else {
          // whole-variable increment (3) or decrement (4)
          uint32_t cy = kind == 3 ? 0u : 1u;
#pragma unroll 4
          for (int l = 0; l < L; ++l) {
            const uint32_t one = l == 0 ? 1u : 0u;
            const uint32_t x = xc.ld(v, l);
            const uint32_t t2 = kind == 3 ? x + one + cy : x + (kMask16 - one) + cy;
            xc.st(v, l, t2 & kMask16);
            cy = t2 >> 16;
          }
        }
#pragma unroll 4
        for (int l = 0; l < L; ++l) xc.st(v, l, xc.ld(v, l) & wmask(w, l));
      }
      __syncwarp();
      bool ns;
      int nsc;
      if constexpr (kSmem) {
        eval_program<L>(sp, xc, val, n, g, &ns, &nsc);
      } else {
        const GlobalProg<L> gp{op, args, imms, width, pool, roots, rmask, n, N, R};
        eval_program<L>(gp, xc, val, n, g, &ns, &nsc);
      }
      // every lane of the group has (ns, nsc); lane 0 keeps the state.
      // The next candidate's move waits for this evaluation's lanes: the
      // evaluation ends in __syncwarp()
      if (g != 0 || !live) {
        ns = false;
      } else if (phase == kPhaseInit) {
        st[kCur * B + c] = nsc;
        st[kBest * B + c] = nsc;
        st[kStall * B + c] = 0;
        st[kLubU * B + c] = 1;
        st[kLubV * B + c] = 1;
      } else if (phase == kPhaseStep) {
        int cur = st[kCur * B + c], best = st[kBest * B + c], stall = st[kStall * B + c];
        int lub_u = st[kLubU * B + c], lub_v = st[kLubV * B + c];
        const bool accept = nsc >= cur || r5 < (uint32_t)a.thresholds[k] || ns;
        if (accept) {
          cur = nsc;
        } else {
#pragma unroll 4
          for (int l = 0; l < L; ++l) xc.st(v, l, val.ld(bk, l));
        }
        const bool improved = nsc > best;
        best = nsc > best ? nsc : best;
        stall = (improved || ns) ? 0 : stall + 1;
        // Luby restarts: a lane stalled past its budget reseeds every
        // variable with a multiplicative mix of this step's draw
        const bool restart = stall >= lub_v * a.restart_base && !ns;
        if (restart) {
          const uint32_t bits = r3 & kMask16;
          for (int vv = 0; vv < V; ++vv) {
            const int ww = vw[vv];
#pragma unroll 4
            for (int l = 0; l < L; ++l) {
              const uint32_t mix = (bits * 0x9E3779B9u) ^ ((uint32_t)(l + 1) * 0x85EBCA6Bu);
              xc.st(vv, l, (xc.ld(vv, l) ^ mix) & wmask(ww, l));
            }
          }
          cur = -(1 << 30);
          stall = 0;
          const bool last = (lub_u & -lub_u) == lub_v;
          if (last) lub_u += 1;
          lub_v = last ? 1 : lub_v * 2;
        }
        st[kCur * B + c] = cur;
        st[kBest * B + c] = best;
        st[kStall * B + c] = stall;
        st[kLubU * B + c] = lub_u;
        st[kLubV * B + c] = lub_v;
      } else {
        // solved first, then the best soft score (at most R * 1024,
        // below 2**30); a slot's candidates come in lane order, so a
        // strict compare keeps the first lane of a tie
        const int kk = nsc + (ns ? (1 << 30) : 0);
        if (my_idx < 0 || kk > my_key) {
          my_key = kk;
          my_idx = k;
        }
      }
      any = any || ns;
    }
    if (phase == kPhaseFinal) break;
    if (phase == kPhaseStep) ++it;
    // any candidate of the query solved: this block's threads, then the
    // cluster's blocks through distributed shared memory. The flag is
    // double-buffered: a block writes slot round & 1 again only after the
    // next round's cluster.sync, which every reader of it has passed.
    const int blk = __syncthreads_or(any);
    if (t == 0) s_flag[round & 1] = blk;
    cluster.sync();
    bool done = false;
    for (int r = 0; r < Cs; ++r) done = done || *cluster.map_shared_rank(&s_flag[round & 1], r);
    ++round;
    phase = (it < a.steps && !done) ? kPhaseStep : kPhaseFinal;
  }
  // the solved-first argmax: the block's slots, then the cluster's
  // blocks in rank order (candidate order), ties to the first lane
  red[t] = make_int2(my_key, my_idx);
  __syncthreads();
  if (t == 0) {
    int bkey = 0, bidx = -1;
    for (int j = 0; j < NT; ++j) {
      const int2 e = red[j];
      if (e.y >= 0 && (bidx < 0 || e.x > bkey || (e.x == bkey && e.y < bidx))) {
        bkey = e.x;
        bidx = e.y;
      }
    }
    s_bkey = bkey;
    s_bidx = bidx;
  }
  cluster.sync();
  if (t == 0) {
    int bkey = 0, bidx = -1;
    for (int r = 0; r < Cs; ++r) {
      const int e_key = *cluster.map_shared_rank(&s_bkey, r);
      const int e_idx = *cluster.map_shared_rank(&s_bidx, r);
      if (e_idx >= 0 && (bidx < 0 || e_key > bkey)) {
        bkey = e_key;
        bidx = e_idx;
      }
    }
    s_win = bidx;
    if (rank == 0) {
      a.solved_out[q] = bkey >= (1 << 30);
      a.steps_out[q] = it;
    }
  }
  __syncthreads();
  const int win = s_win;
  if (win / B == rank) {
    const int c = win - rank * B;
    for (int e = t; e < V * L; e += NT) {
      const int vv = e / L, l = e - vv * L;
      const int slot = kSmem ? c : win;
      a.winners[(size_t)q * V * L + e] = (int)xbase[slot + (vv * L + l) * xstride];
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <int L>
int launch_sls(const SlsArgs& a, int Q, int smem_variant, int cluster, int smem,
               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(Q * cluster));
  cfg.blockDim = dim3((unsigned)(a.slots * kGroup));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int rc;
  if (smem_variant) {
    rc = set_smem(portfolio_sls_kernel<L, true>, smem);
    if (rc) return rc;
    rc = (int)cudaLaunchKernelEx(&cfg, portfolio_sls_kernel<L, true>, a);
  } else {
    rc = set_smem(portfolio_sls_kernel<L, false>, smem);
    if (rc) return rc;
    rc = (int)cudaLaunchKernelEx(&cfg, portfolio_sls_kernel<L, false>, a);
  }
  const int last = (int)cudaGetLastError();
  return rc ? rc : last;
}

}  // namespace

// A search block's dynamic shared bytes (ops/portfolio_sls.py
// :sls_smem_bytes counts the same): `slots` candidate slots, `per_block`
// candidates, n nodes; `shared` 1 for the shared variant.
extern "C" int portfolio_sls_smem(int L, int n, int V, int C, int R, int slots, int per_block,
                                  int shared) {
  return sls_layout(n, L, V, C, R, slots, per_block, shared != 0).total;
}

// The diversified SLS over Q stacked programs, one cluster of `cluster`
// blocks per query, each block searching `slots` candidates at once
// (kGroup threads each; a multiple of 32 / kGroup) and each slot
// `per_thread` candidates in turn (ops/portfolio_sls.py:sls_plan).
// Program arrays are int32 [Q, ...] as portfolio.py stacks them, N nodes
// a query (at least each query's count); thresholds int64 [K] (the
// per-lane noise accept threshold out of 2**32). `smem` must hold
// portfolio_sls_smem's bytes at N nodes. The global variant takes
// scratch: xs Q * V * L * (cluster * slots * per_thread), vals
// Q * (N + 4) * L * (cluster * slots) int32. Outputs: solved [Q],
// winners [Q, V, L], steps [Q].
extern "C" int portfolio_sls(int L, int Q, int K, int N, int C, int R, int V,
                             const int* op, const int* args, const int* imms,
                             const int* width, const int* pool, const int* roots,
                             const int* rmask, const int* var_width, const int* n_vars,
                             const int* n_consts, const int* n_nodes,
                             const long long* thresholds, unsigned int seed, int steps,
                             int n_greedy, int n_seeded, int restart_base, int smem_variant,
                             int cluster, int slots, int per_thread, int smem, int* xs,
                             int* vals, int* solved_out, int* winners, int* steps_out,
                             cudaStream_t stream) {
  if (Q <= 0) return 0;
  if (K <= 0 || cluster < 1 || cluster > 8 || slots < 1 || per_thread < 1 ||
      (slots * kGroup) % 32 != 0 || (long long)cluster * slots * per_thread < K ||
      smem < portfolio_sls_smem(L, N, V, C, R, slots, slots * per_thread, smem_variant))
    return (int)cudaErrorInvalidValue;
  SlsArgs a{op, args, imms, width, pool, roots, rmask, var_width, n_vars, n_consts, n_nodes,
            thresholds, reinterpret_cast<uint32_t*>(xs), reinterpret_cast<uint32_t*>(vals),
            solved_out, winners, steps_out, K, N, C, R, V, seed, steps, n_greedy,
            n_seeded, restart_base, slots, per_thread};
  switch (L) {
    case 16:
      if (slots > sls_max_slots<16>()) return (int)cudaErrorInvalidValue;
      return launch_sls<16>(a, Q, smem_variant, cluster, smem, stream);
    case 32:
      if (slots > sls_max_slots<32>()) return (int)cudaErrorInvalidValue;
      return launch_sls<32>(a, Q, smem_variant, cluster, smem, stream);
    case 64:
      if (slots > sls_max_slots<64>()) return (int)cudaErrorInvalidValue;
      return launch_sls<64>(a, Q, smem_variant, cluster, smem, stream);
    case 128:
      if (slots > sls_max_slots<128>()) return (int)cudaErrorInvalidValue;
      return launch_sls<128>(a, Q, smem_variant, cluster, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
