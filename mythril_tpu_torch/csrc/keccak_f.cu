// keccak-256 for NVIDIA Hopper (sm_90a): the bare permutation
// (keccak_f1600) and the whole SHA3 sponge of the EVM step
// (keccak_sponge), sharing one __device__ permutation.
//
// Replaces:
// - keccak_f1600: the JAX package's Pallas kernel
//   mythril_tpu/ops/keccak_pallas.py:44 (_kernel, reached through
//   _keccak_f_blocks :85 / keccak_f_pallas) and its bit-exact XLA twin
//   mythril_tpu/ops/keccak.py:keccak_f. The Pallas kernel lays the batch
//   on the TPU's 128-wide lane axis ([25, M] lo/hi uint32 planes, 512
//   messages per grid step).
// - keccak_sponge: the same Pallas kernel together with the absorb
//   around it in the JAX step's SHA3 phase (do_sha3,
//   mythril_tpu/laser/batch/step.py:845-903), which the port used to run
//   as ~30 PyTorch launches per block for all 8 blocks of every lane.
//
// Both keep one message's 25 64-bit lanes in one thread's registers for
// all 24 rounds; the rounds are unrolled, so the rotation amounts and the
// round constants are immediates, and a 64-bit rotate lowers to two
// funnel shifts.
//
// keccak_f1600: in/out are [n, 25] uint64 (a PyTorch int64 tensor). A
// block of 128 threads stages its 128 messages' [128, 25] u64 tile
// (25,600 B, contiguous in device memory) through shared memory with
// 16-byte loads and stores, so device memory sees coalesced accesses
// instead of 25 loads and stores strided by 200 B per thread. The odd
// row stride of 25 words keeps each thread's 64-bit shared reads
// conflict-free.
//
// keccak_sponge: mem is [N, C] uint8 with row pitch `pitch` bytes; off,
// len are int32 [N], ok is bool [N]; out is [N, 16] int32, the digest as
// a u256 limb word (limb k = digest bytes 30-2k, 31-2k, big-endian), zero
// where ok is not set. One launch hashes every lane:
// - a lane absorbs only its own n_blocks = (len + 136) / 136 blocks (1-8;
//   a lane outside ok, or with len outside [0, 136 * max_blocks), writes
//   zero and absorbs nothing); its state stays in registers across them;
// - the bytes read are those of [clamp(off, 0, C), min(C, off + len)),
//   as the plain version masks them: a lane with len 0 reads nothing,
//   whatever its offset;
// - rate bytes reach the permuting thread through coalesced loads: the
//   warp stages its 32 lanes' windows (35 aligned 32-bit words each, 139
//   bytes at any alignment) into shared memory, 32 consecutive words of
//   one row per load instruction; each thread then funnel-shifts its own
//   unaligned 136 bytes into 17 lanes (row stride 37 words, odd, so those
//   reads are conflict-free). The next block's words are loaded into
//   registers while the current block permutes;
// - padding (0x01 at len, 0x80 at the last byte of the last block, 0x81
//   where they meet) is XORed in registers; the digest is written as the
//   limb word, so no squeeze or conversion launch follows.
//
// Bounds on an H100 SXM (3.35 TB/s; INT32 ALU 132 SMs x 64 lanes x 1.98
// GHz = 16.7 Tops/s; 700 W). Operations, in 32-bit ALU instructions with
// Hopper's 3-input LOP3 and a 64-bit rotate as two funnel shifts, per
// round and message: theta 20 (five 5-way column XORs, two LOP3 per
// 32-bit half) + 10 (rotate of each column parity by 1) + 50 (a ^ C[x-1]
// ^ rol(C[x+1], 1), one LOP3 per half); rho 48 (24 rotates); chi 50 (b ^
// (~c & d), one LOP3 per half). That is 178 x 24 rounds, plus iota's 37
// (one XOR per nonzero 32-bit half of the round constants): 4309 per
// permutation.
// - keccak_f1600 at n = 16384: 7.06e7 operations, 4.2 us; bytes 2 x 200 B
//   x n = 6.55 MB, 1.96 us: bound by operations.
// - keccak_sponge: 4309 x the sum of n_blocks over ok lanes, against the
//   bytes sum(len) + 9 B per lane (off, len, ok) + 64 B per ok lane. The
//   main path's 3-block SHA3 over 16384 lanes: 2.12e8 operations, 12.7 us,
//   against 6.4 MB, 1.9 us; its 1-block mapping-slot hash 4.2 us: bound by
//   operations. One thread per message leaves about one warp per SM
//   scheduler at 16384 lanes, so the permutation's dependent instructions
//   are hidden only by its own instruction-level parallelism.
// (chip_smoke.py computes these bounds from its own inputs.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRate = 136;        // keccak-256 rate, bytes per block
constexpr int kRateLanes = 17;    // 64-bit lanes per block
constexpr int kWinWords = 35;     // 32-bit words covering 136 B at any alignment
constexpr int kWinStride = 37;    // odd: conflict-free reads of a thread's own row
constexpr int kTile = 128;        // messages per keccak_f1600 block
constexpr int kSpongeWarps = 2;   // warps per keccak_sponge block

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

// keccak-f[1600] on 25 lanes held in registers (every index is a
// constant once the loops unroll)
__device__ __forceinline__ void permute(uint64_t (&a)[25]) {
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
}

// copy `words` u64 between device and shared memory, 16 bytes per
// access where both sides are 16-byte aligned (the tile's offset in
// device memory is a multiple of 25,600 B, so that is the base pointer)
__device__ __forceinline__ void copy_tile(uint64_t* dst, const uint64_t* src,
                                          int words, bool vec) {
  if (vec) {
    const int pairs = words >> 1;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int v = threadIdx.x; v < pairs; v += blockDim.x) d[v] = s[v];
    if ((words & 1) && threadIdx.x == 0) dst[words - 1] = src[words - 1];
  } else {
    for (int v = threadIdx.x; v < words; v += blockDim.x) dst[v] = src[v];
  }
}

__global__ void __launch_bounds__(kTile)
keccak_f1600_kernel(const uint64_t* __restrict__ in,
                    uint64_t* __restrict__ out, long long n) {
  __shared__ __align__(16) uint64_t tile[kTile * 25];
  const long long first = (long long)blockIdx.x * kTile;
  const int msgs = (int)min((long long)kTile, n - first);
  const int words = msgs * 25;
  const bool vec = ((reinterpret_cast<uintptr_t>(in) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  copy_tile(tile, in + first * 25, words, vec);
  __syncthreads();
  const int m = threadIdx.x;
  if (m < msgs) {
    uint64_t a[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) a[k] = tile[25 * m + k];
    permute(a);
#pragma unroll
    for (int k = 0; k < 25; ++k) tile[25 * m + k] = a[k];
  }
  __syncthreads();
  copy_tile(out + first * 25, tile, words, vec);
}

// The j-th of the warp's 32 x kWinWords staged words for block k: the
// aligned 32-bit word at (start & ~3) + 4w of lane q / kWinWords, where
// start = lo + kRate * k. Bytes outside the lane's readable range [lo,
// hi) read as zero; a word wholly inside it is one 4-byte load, one that
// straddles an end is read byte by byte.
__device__ __forceinline__ uint32_t window_word(const uintptr_t* lo_s,
                                                const uintptr_t* hi_s,
                                                int q, int k) {
  const int j = q / kWinWords;
  const int w = q - j * kWinWords;
  const uintptr_t lo = lo_s[j], hi = hi_s[j];
  const uintptr_t a4 = ((lo + (uintptr_t)kRate * k) & ~(uintptr_t)3) + 4 * w;
  if (a4 >= lo && a4 + 4 <= hi) return *reinterpret_cast<const uint32_t*>(a4);
  uint32_t v = 0;
  if (a4 < hi && a4 + 4 > lo) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (a4 + b >= lo && a4 + b < hi)
        v |= (uint32_t)(*reinterpret_cast<const uint8_t*>(a4 + b)) << (8 * b);
  }
  return v;
}

__global__ void __launch_bounds__(32 * kSpongeWarps)
keccak_sponge_kernel(const uint8_t* __restrict__ mem, long long pitch,
                     long long cap, const int* __restrict__ off,
                     const int* __restrict__ len,
                     const uint8_t* __restrict__ ok, int* __restrict__ out,
                     long long n, int max_blocks) {
  __shared__ uint32_t win_s[kSpongeWarps][32 * kWinStride];
  __shared__ uintptr_t lo_s[kSpongeWarps][32], hi_s[kSpongeWarps][32];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  int nb = 0, l = 0;
  uintptr_t lo = 0, hi = 0;
  if (i < n) {
    l = len[i];
    const long long o = off[i];
    if (ok[i] && l >= 0 && l < kRate * max_blocks) {
      nb = (l + kRate) / kRate;
      const long long base = min(max(o, 0LL), cap);
      lo = reinterpret_cast<uintptr_t>(mem + i * pitch) + base;
      hi = lo + (min(cap, base + l) - base);
    }
  }
  lo_s[warp][t] = lo;
  hi_s[warp][t] = hi;
  __syncwarp();
  const int nb_max = __reduce_max_sync(0xffffffffu, nb);

  uint64_t a[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) a[k] = 0;
  uint32_t next[kWinWords];
  if (nb_max > 0) {
#pragma unroll
    for (int it = 0; it < kWinWords; ++it)
      next[it] = window_word(lo_s[warp], hi_s[warp], it * 32 + t, 0);
  }
  uint32_t* win = win_s[warp];
  const uint32_t* mine = win + t * kWinStride;
  const int shift = 8 * (int)(lo & 3);  // the same for every block: 136 % 4 == 0
  for (int k = 0; k < nb_max; ++k) {
#pragma unroll
    for (int it = 0; it < kWinWords; ++it) {
      const int q = it * 32 + t;
      const int j = q / kWinWords;
      win[j * kWinStride + (q - j * kWinWords)] = next[it];
    }
    __syncwarp();
    if (k + 1 < nb_max) {
      // in flight while block k permutes
#pragma unroll
      for (int it = 0; it < kWinWords; ++it)
        next[it] = window_word(lo_s[warp], hi_s[warp], it * 32 + t, k + 1);
    }
    if (k < nb) {
      const int p = l - kRate * k;  // the 0x01 byte's place, in this block if < kRate
      const bool last = k == nb - 1;
#pragma unroll
      for (int r = 0; r < kRateLanes; ++r) {
        const uint32_t w0 = mine[2 * r], w1 = mine[2 * r + 1], w2 = mine[2 * r + 2];
        uint64_t x = (uint64_t)__funnelshift_r(w0, w1, shift) |
                     ((uint64_t)__funnelshift_r(w1, w2, shift) << 32);
        if ((p >> 3) == r) x ^= 1ULL << (8 * (p & 7));
        if (r == kRateLanes - 1 && last) x ^= 0x80ULL << 56;
        a[r] ^= x;
      }
      permute(a);
    }
    __syncwarp();  // every thread has read its row before the next store
  }

  if (i < n) {
    // limb k = digest bytes (30 - 2k, 31 - 2k); digest byte m is byte
    // m % 8 of lane m / 8
    uint32_t limb[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int m = 30 - 2 * k;
      const uint32_t v = nb ? (uint32_t)(a[m >> 3] >> (8 * (m & 7))) & 0xFFFFu : 0u;
      limb[k] = ((v & 0xFFu) << 8) | (v >> 8);
    }
    int4* dst = reinterpret_cast<int4*>(out + 16 * i);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = make_int4((int)limb[4 * q], (int)limb[4 * q + 1],
                         (int)limb[4 * q + 2], (int)limb[4 * q + 3]);
  }
}

}  // namespace

extern "C" int keccak_f1600(const uint64_t* in, uint64_t* out, long long n,
                            cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long grid = (n + kTile - 1) / kTile;
  keccak_f1600_kernel<<<(unsigned)grid, kTile, 0, stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

// out must be 16-byte aligned (the wrapper allocates it).
extern "C" int keccak_sponge(const uint8_t* mem, long long pitch, long long cap,
                             const int* off, const int* len, const uint8_t* ok,
                             int* out, long long n, int max_blocks,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  const int block = 32 * kSpongeWarps;
  const long long grid = (n + block - 1) / block;
  keccak_sponge_kernel<<<(unsigned)grid, block, 0, stream>>>(
      mem, pitch, cap, off, len, ok, out, n, max_blocks);
  return (int)cudaGetLastError();
}
