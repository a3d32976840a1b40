// Per-lane slot write for NVIDIA Hopper (sm_90a): for every lane whose
// mask is set, buf[lane, idx[lane], :] = val[lane, :], in place, for up to
// 8 tables that share one (idx, mask) in one launch.
//
// Replaces: the TPU kernel `kernel` inside make_pallas_write,
// tools/pallas_stack_probe.py:62 (pallas_call at :86, wrapper `write` at
// :93), the in-place form of the step's consolidated stack write, and
// the one-hot merges it stands for in the JAX package
// (mythril_tpu/laser/batch/): step.py's stack
// write (result slot + SWAP's deep slot), storage journal and branch
// journal, and symbolic.py's `_scatter2` (stack, storage and branch
// tids) and evidence-bank writes. On the TPU the form was a dead end:
// Mosaic cannot tile a [1, 1, W] block. On Hopper it is a plain scatter.
//
// Entry: slot_write_many(ntab, desc, idx, mask, idx2, mask2, n, stream).
// `desc` holds kDescWords int64 per table (buffer and value pointers,
// byte strides, slot count, the row's vector count and width); the host
// entry copies it into the kernel's parameter struct, which the launch
// passes by value: no host-to-device copy, no allocation. A second write
// (idx2, mask2, each table's val2) is allowed with one table only: where
// both land on one slot the second wins (the JAX step's nesting, where
// the result slot wins over SWAP's deep slot). An index outside [0, S)
// writes nothing, like the one-hot merge. Strides are in bytes, so one
// entry serves [N, S, W] and [N, S] buffers of 1-, 4- and 8-byte
// elements, and a value that is a strided view (a column of a gather)
// needs no copy.
//
// Layout: a block holds whole lanes, one thread per (lane, vector of a
// table's row); the host picks each table's vector width, the largest of
// 16, 8, 4, 2, 1 bytes that divides the row and every base and stride
// where the row is contiguous (a 64 B int32 stack row is four int4),
// the element size elsewhere. Each thread first issues its value load,
// which does not depend on the index; one thread per lane loads the
// lane's idx and mask into shared memory at the same time, so every
// lane's idx/mask is read once for all its tables and the whole write
// costs one round trip to device memory, not two. Then the block syncs
// and each thread stores its vector where its lane's write is on. Value
// loads of lanes whose mask is off are wasted reads; they cost less
// than a second round trip. (The first design read idx and mask, then
// the value, one 4-byte element per thread, one launch per table.)
//
// Bound on an H100 SXM (3.35 TB/s, 700 W): bytes. The function must read
// every lane's index (8 B) and mask (1 B) once, and for each table and
// lane whose write is on read the value row and write the row: n x 9 B +
// sum over tables of 2 x written x row bytes. A [16384, 128, 16] int32
// stack write with every mask set is 2.245 MB, 0.67 us; the 8 evidence
// tables of the symbolic step (5 x 4 B, 2 x 64 B and 8 B rows) 5.259 MB
// (16384 x (9 + 2 x 156) B), 1.57 us, with every mask set. A launch costs more than the stack write, so one
// table per launch is bound by launch latency; a launch for a group of
// tables pays it once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTables = 8;
constexpr int kDescWords = 13;
constexpr int kLanesThreads = 256;  // target threads per block
constexpr int kMaxThreads = 1024;   // one lane's vectors must fit one block

struct Table {
  char* buf;
  const char* val;
  const char* val2;
  long long b_lane, b_slot, b_vec;  // bytes
  long long v_lane, v_vec, v2_lane, v2_vec;
  long long slots;
  int vecs;   // vectors per row
  int width;  // bytes per vector: 1, 2, 4, 8 or 16
};

struct Params {
  Table tab[kMaxTables];
  int first[kMaxTables + 1];  // a lane's vectors of table t: [first[t], first[t + 1])
  const long long* idx;
  const uint8_t* mask;
  const long long* idx2;  // null without a second write
  const uint8_t* mask2;
  long long n;
  int ntab;
  int per_lane;  // first[ntab]
  int lanes;     // lanes per block
};

__device__ __forceinline__ uint4 load_vec(const char* p, int width) {
  uint4 r = make_uint4(0, 0, 0, 0);
  switch (width) {
    case 16: r = *reinterpret_cast<const uint4*>(p); break;
    case 8: {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      r.x = v.x;
      r.y = v.y;
      break;
    }
    case 4: r.x = *reinterpret_cast<const uint32_t*>(p); break;
    case 2: r.x = *reinterpret_cast<const uint16_t*>(p); break;
    default: r.x = *reinterpret_cast<const uint8_t*>(p); break;
  }
  return r;
}

__device__ __forceinline__ void store_vec(char* p, int width, uint4 v) {
  switch (width) {
    case 16: *reinterpret_cast<uint4*>(p) = v; break;
    case 8: *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<uint32_t*>(p) = v.x; break;
    case 2: *reinterpret_cast<uint16_t*>(p) = (uint16_t)v.x; break;
    default: *reinterpret_cast<uint8_t*>(p) = (uint8_t)v.x; break;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
slot_write_kernel(const __grid_constant__ Params p) {
  __shared__ long long idx_s[kLanesThreads], idx2_s[kLanesThreads];
  __shared__ bool ok_s[kLanesThreads], ok2_s[kLanesThreads];
  const int local = threadIdx.x / p.per_lane;
  const int c = threadIdx.x - local * p.per_lane;
  const long long lane = (long long)blockIdx.x * p.lanes + local;
  const bool live = lane < p.n;
  const bool two = p.idx2 != nullptr;

  int t = 0;
#pragma unroll
  for (int k = 1; k < kMaxTables; ++k) t += (k < p.ntab && c >= p.first[k]);
  const Table& tb = p.tab[t];
  const int v = c - p.first[t];

  uint4 val = make_uint4(0, 0, 0, 0), val2 = val;
  if (live) {
    val = load_vec(tb.val + lane * tb.v_lane + v * tb.v_vec, tb.width);
    if (two) val2 = load_vec(tb.val2 + lane * tb.v2_lane + v * tb.v2_vec, tb.width);
    if (c == 0) {
      // the slot bound is each table's own, checked below
      const long long i1 = p.idx[lane];
      ok_s[local] = p.mask[lane] != 0 && i1 >= 0;
      idx_s[local] = i1;
      if (two) {
        const long long i2 = p.idx2[lane];
        ok2_s[local] = p.mask2[lane] != 0 && i2 >= 0;
        idx2_s[local] = i2;
      }
    }
  }
  __syncthreads();
  if (!live) return;
  const long long i1 = idx_s[local];
  bool ok1 = ok_s[local] && i1 < tb.slots;
  char* row = tb.buf + lane * tb.b_lane + v * tb.b_vec;
  if (two) {
    const long long i2 = idx2_s[local];
    const bool ok2 = ok2_s[local] && i2 < tb.slots;
    if (ok2) store_vec(row + i2 * tb.b_slot, tb.width, val2);
    ok1 = ok1 && !(ok2 && i1 == i2);
  }
  if (ok1) store_vec(row + i1 * tb.b_slot, tb.width, val);
}

}  // namespace

// desc: ntab x kDescWords int64 per table: buf, val, val2, b_lane, b_slot,
// b_vec, v_lane, v_vec, v2_lane, v2_vec, slots, vecs, width. idx2/mask2
// null for a single write. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a table count outside [1, 8], a second
// write with more than one table, or a lane wider than one block.
extern "C" int slot_write_many(int ntab, const long long* desc,
                               const long long* idx, const uint8_t* mask,
                               const long long* idx2, const uint8_t* mask2,
                               long long n, cudaStream_t stream) {
  if (ntab < 1 || ntab > kMaxTables || (idx2 != nullptr && ntab != 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Params p = {};
  int total = 0;
  for (int t = 0; t < ntab; ++t) {
    const long long* d = desc + t * kDescWords;
    Table& tb = p.tab[t];
    tb.buf = reinterpret_cast<char*>(d[0]);
    tb.val = reinterpret_cast<const char*>(d[1]);
    tb.val2 = reinterpret_cast<const char*>(d[2]);
    tb.b_lane = d[3];
    tb.b_slot = d[4];
    tb.b_vec = d[5];
    tb.v_lane = d[6];
    tb.v_vec = d[7];
    tb.v2_lane = d[8];
    tb.v2_vec = d[9];
    tb.slots = d[10];
    tb.vecs = (int)d[11];
    tb.width = (int)d[12];
    if (tb.vecs <= 0) return (int)cudaErrorInvalidValue;
    p.first[t] = total;
    total += tb.vecs;
  }
  if (total > kMaxThreads) return (int)cudaErrorInvalidValue;
  for (int t = ntab; t <= kMaxTables; ++t) p.first[t] = total;
  p.idx = idx;
  p.mask = mask;
  p.idx2 = idx2;
  p.mask2 = mask2;
  p.n = n;
  p.ntab = ntab;
  p.per_lane = total;
  p.lanes = total >= kLanesThreads ? 1 : kLanesThreads / total;
  const long long grid = (n + p.lanes - 1) / p.lanes;
  slot_write_kernel<<<(unsigned)grid, p.lanes * total, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
