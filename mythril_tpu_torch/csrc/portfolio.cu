// portfolio_eval: a compiled program evaluated for K candidates on
// NVIDIA Hopper (sm_90a). The evaluator, the design and the bound are
// in portfolio.cuh.

#include "portfolio.cuh"

namespace {

// ---------------------------------------------------------------------------
// portfolio_eval
// ---------------------------------------------------------------------------

struct EvalArgs {
  const int *op, *args, *imms, *width, *pool, *roots, *rmask;
  const int* X;  // [V, K, L]
  uint32_t* vals;  // global variant: [n + 4, L, blocks x slots]
  int* solved;
  int* score;
  int n, N, C, R, V, K;
  int slots;  // candidates a block: kGroup threads each
};

// the shared variant's dynamic shared memory: the staged program, the
// block's tile of X [V, L, slots] (uint16) at `xs`, the slots' value rows
// at `vals`; `total` bytes in all
struct EvalLayout {
  int xs, vals, total;
};

__host__ __device__ inline EvalLayout eval_layout(int n, int L, int V, int C, int R, int slots) {
  EvalLayout o;
  o.xs = program_bytes(n, C, R, L);
  o.vals = o.xs + align16((long long)V * L * slots * 2);
  o.total = o.vals + value_rows_bytes(n, L, slots);
  return o;
}

template <int L, bool kSmem>
__global__ void __launch_bounds__(kEvalSlots * kGroup) portfolio_eval_kernel(EvalArgs a) {
  const int T = a.slots, NT = blockDim.x, t = threadIdx.x;
  const int c = t / kGroup, g = t % kGroup;
  const int k0 = blockIdx.x * T, k = k0 + c;
  bool solved;
  int score;
  // a slot past K evaluates too (every lane of a warp runs the program in
  // step) and writes nothing
  if constexpr (kSmem) {
    const EvalLayout lay = eval_layout(a.n, L, a.V, a.C, a.R, T);
    SmemProg<L> p;
    stage_program<L>(dyn_smem, a.op, a.args, a.imms, a.width, a.pool, a.roots, a.rmask, a.n,
                     a.N, a.C, a.R, &p);
    // the block's tile of X as [V, L, T] halfwords, read coalesced
    uint16_t* xs = reinterpret_cast<uint16_t*>(dyn_smem + lay.xs);
    uint16_t* vs = reinterpret_cast<uint16_t*>(dyn_smem + lay.vals);
    for (int e = t; e < a.V * T * L; e += NT) {
      const int v = e / (T * L), rem = e - v * T * L, kk = rem / L, l = rem - kk * L;
      const int kg = k0 + kk;
      xs[(v * L + l) * T + kk] =
          kg < a.K ? (uint16_t)a.X[((long long)v * a.K + kg) * L + l] : (uint16_t)0;
    }
    const Col<uint16_t> val{vs + c, L * T, T};
    for (int l = g; l < L; l += kGroup) val.st(a.n + kZeroRow, l, 0u);
    __syncthreads();
    const Col<uint16_t> x{xs + c, L * T, T};
    eval_program<L>(p, x, val, a.n, g, &solved, &score);
  } else {
    GlobalProg<L> p{a.op, a.args, a.imms, a.width, a.pool, a.roots, a.rmask, a.n, a.N, a.R};
    const int Kp = gridDim.x * T;
    const Col<uint32_t> val{a.vals + k, L * Kp, Kp};
    for (int l = g; l < L; l += kGroup) val.st(a.n + kZeroRow, l, 0u);
    __syncwarp();
    const Col<const int> x{a.X + (long long)(k < a.K ? k : a.K - 1) * L, a.K * L, 1};
    eval_program<L>(p, x, val, a.n, g, &solved, &score);
  }
  if (g == 0 && k < a.K) {
    a.solved[k] = solved;
    a.score[k] = score;
  }
}

template <int L>
int launch_eval(const EvalArgs& a, int smem_variant, int smem, cudaStream_t stream) {
  const int blocks = (a.K + a.slots - 1) / a.slots, threads = a.slots * kGroup;
  int rc;
  if (smem_variant) {
    rc = set_smem(portfolio_eval_kernel<L, true>, smem);
    if (rc) return rc;
    portfolio_eval_kernel<L, true><<<blocks, threads, smem, stream>>>(a);
  } else {
    portfolio_eval_kernel<L, false><<<blocks, threads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The shared variant's dynamic shared bytes at `slots` candidates a block
// (ops/portfolio_eval.py:eval_smem_bytes counts the same).
extern "C" int portfolio_eval_smem(int L, int n_nodes, int V, int C, int R, int slots) {
  return eval_layout(n_nodes, L, V, C, R, slots).total;
}

// Evaluate one program for K candidates. X is int32 [V, K, L] (16-bit
// limbs); solved and score are int32 [K]. The plan (ops/portfolio_eval.py
// :eval_plan) gives the variant (1: shared memory), the candidates a
// block (`slots`, a multiple of 32 / kGroup; kGroup threads each) and
// the dynamic shared bytes, which must hold portfolio_eval_smem's; the
// global variant takes `vals`, an int32 scratch of (n_nodes + 4) * L *
// (blocks * slots) elements.
extern "C" int portfolio_eval(int L, int n_nodes, int R, int K, int N, int C, int V,
                              int smem_variant, int slots, int smem, const int* op,
                              const int* args, const int* imms, const int* width,
                              const int* pool, const int* roots, const int* rmask,
                              const int* X, int* vals, int* solved, int* score,
                              cudaStream_t stream) {
  if (K <= 0) return 0;
  if (slots <= 0 || slots > kEvalSlots || (slots * kGroup) % 32 != 0 || n_nodes < 0 ||
      n_nodes > N || (smem_variant && smem < portfolio_eval_smem(L, n_nodes, V, C, R, slots)))
    return (int)cudaErrorInvalidValue;
  EvalArgs a{op, args, imms, width, pool, roots, rmask, X, reinterpret_cast<uint32_t*>(vals),
             solved, score, n_nodes, N, C, R, V, K, slots};
  switch (L) {
    case 16: return launch_eval<16>(a, smem_variant, smem, stream);
    case 32: return launch_eval<32>(a, smem_variant, smem, stream);
    case 64: return launch_eval<64>(a, smem_variant, smem, stream);
    case 128: return launch_eval<128>(a, smem_variant, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
