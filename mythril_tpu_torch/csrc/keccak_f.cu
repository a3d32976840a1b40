// keccak-f[1600] for NVIDIA Hopper (sm_90a), one thread per message.
//
// Replaces: the JAX package's Pallas kernel ops/keccak_pallas.py:_kernel
// (reached through _keccak_f_blocks / keccak_f_pallas) and its bit-exact
// XLA twin ops/keccak.py:keccak_f, which the JAX step kernel's SHA3
// phase calls. The Pallas kernel lays the batch on the TPU's 128-wide
// lane axis ([25, M] lo/hi uint32 planes, 512 messages per grid step).
// Here every thread holds one message's 25 64-bit lanes in registers
// (50 x 32-bit) for all 24 rounds; the rounds are unrolled, so the
// rotation amounts and the round constants are immediates, and a 64-bit
// rotate lowers to two funnel shifts.
//
// Layout: in/out are [n, 25] uint64 (a PyTorch int64 tensor), message i
// at in[25*i .. 25*i+24]. The wrapper (ops/keccak_cuda.py) allocates the
// output and passes the current stream; the kernel allocates nothing.
//
// Bound on an H100 SXM (3.35 TB/s, 700 W) at the main path's
// n = 16384: bytes 2 x 200 B x n = 6.55 MB -> 1.96 us. Operations, in
// 32-bit ALU instructions with Hopper's 3-input LOP3 (any function of
// three operands in one instruction) and a 64-bit rotate as two funnel
// shifts, per round and message: theta 20 (five 5-way column XORs, two
// LOP3 per 32-bit half) + 10 (rotate of each column parity by 1) + 50
// (a ^ C[x-1] ^ rol(C[x+1], 1), one LOP3 per half); rho 48 (24
// rotates); chi 50 (b ^ (~c & d), one LOP3 per half). That is 178 x 24
// rounds, plus iota's 37 (one XOR per nonzero 32-bit half of the 24
// round constants): 4309 per message, 7.06e7 at n = 16384. Against the
// card's INT32 rate (132 SMs x 64 lanes x 1.98 GHz = 16.7 Tops/s) that
// is 4.2 us: the kernel is bound by operations, at about twice its byte
// bound. (chip_smoke.py computes both bounds from the run's own n and
// counts the compiled kernel's SASS instructions beside them.)
//
// Later work, not here: the loads and stores are strided by 200 B per
// thread (uncoalesced); a [25, n] transposed layout or a shared-memory
// stage would coalesce them. A fused absorb+permute sponge kernel would
// keep the state on chip across SHA3 blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint64_t rol64(uint64_t v, int n) {
  return n == 0 ? v : ((v << n) | (v >> (64 - n)));
}

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// rotation of source lane x + 5*y (keccak's rho offsets); called with
// the unrolled loops' constant index, so it folds to an immediate
__device__ __forceinline__ constexpr int rho_rot(int i) {
  switch (i) {
    case 0: return 0;   case 1: return 1;   case 2: return 62;  case 3: return 28;
    case 4: return 27;  case 5: return 36;  case 6: return 44;  case 7: return 6;
    case 8: return 55;  case 9: return 20;  case 10: return 3;  case 11: return 10;
    case 12: return 43; case 13: return 25; case 14: return 39; case 15: return 41;
    case 16: return 45; case 17: return 15; case 18: return 21; case 19: return 8;
    case 20: return 18; case 21: return 2;  case 22: return 61; case 23: return 56;
    default: return 14;
  }
}

__global__ void __launch_bounds__(128)
keccak_f1600_kernel(const uint64_t* __restrict__ in,
                    uint64_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t* src = in + 25 * i;
  uint64_t a[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) a[k] = src[k];

#pragma unroll
  for (int rnd = 0; rnd < 24; ++rnd) {
    // theta
    uint64_t c[5], d[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rol64(c[(x + 1) % 5], 1);
    // rho + pi: b[y + 5*((2x + 3y) % 5)] = rol(a[x + 5y], rot)
    uint64_t b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] =
            rol64(a[x + 5 * y] ^ d[x], rho_rot(x + 5 * y));
    // chi
#pragma unroll
    for (int y = 0; y < 5; ++y)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^
                       (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    // iota
    a[0] ^= kRC[rnd];
  }

  uint64_t* dst = out + 25 * i;
#pragma unroll
  for (int k = 0; k < 25; ++k) dst[k] = a[k];
}

}  // namespace

extern "C" int keccak_f1600(const uint64_t* in, uint64_t* out, long long n,
                            cudaStream_t stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const long long grid = (n + block - 1) / block;
  keccak_f1600_kernel<<<(unsigned)grid, block, 0, stream>>>(in, out, n);
  return (int)cudaGetLastError();
}
