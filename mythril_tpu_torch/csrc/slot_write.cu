// Per-lane slot write for NVIDIA Hopper (sm_90a): for every lane whose
// mask is set, buf[lane, idx[lane], :] = val[lane, :], in place.
//
// Replaces: the TPU kernel `kernel` inside make_pallas_write,
// tools/pallas_stack_probe.py:62 (pallas_call at :86, wrapper `write` at
// :93), the in-place form of the step's consolidated stack write, and
// the one-hot merges it stands for in the JAX package: step.py's stack
// write (result slot + SWAP's deep slot) and symbolic.py's `_scatter2`
// (stack, storage-journal and branch-journal tids) and evidence-bank
// writes. On the TPU the form was a dead end: Mosaic cannot tile a
// [1, 1, W] block. On Hopper it is a plain scatter.
//
// Layout: one thread per (lane, element of the row); the W threads of a
// lane are consecutive, so a lane's row is written coalesced. Each
// thread reads its lane's mask and index (one or two pairs), picks the
// winning write and stores. Up to two writes per lane: where both land
// on one slot the second wins (the JAX step's nesting, where the result
// slot wins over SWAP's deep slot). An index outside [0, S) writes
// nothing, like the one-hot merge. No read of the buffer, no temporary,
// no allocation. Strides are in bytes, so one entry serves [N, S, W]
// and [N, S] buffers of 1-, 4- and 8-byte elements, and a value that is
// a strided view (a column of a gather) needs no copy.
//
// Bound on an H100 SXM (3.35 TB/s, 700 W): bytes. At N = 16384 a stack
// write (W = 16 int32) reads 0.15 MB of indices and masks, and for each
// lane whose mask is set reads its value row and writes its row (1 MB
// each with every mask set): at most 2.2 MB, about 0.67 us. A launch costs
// more than that, so the kernel is bound by launch latency; its point is
// to replace the ~4 PyTorch launches of a gather + where + index_put
// with one, on a step that is host-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
slot_write_kernel(char* __restrict__ buf, long long n, long long s, long long w,
                  long long b_lane, long long b_slot, long long b_elem,
                  const long long* __restrict__ idx1,
                  const uint8_t* __restrict__ mask1,
                  const char* __restrict__ val1, long long v1_lane,
                  long long v1_elem,
                  const long long* __restrict__ idx2,
                  const uint8_t* __restrict__ mask2,
                  const char* __restrict__ val2, long long v2_lane,
                  long long v2_elem) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * w) return;
  long long lane = t / w;
  long long e = t - lane * w;
  long long i1 = idx1[lane];
  bool ok1 = mask1[lane] != 0 && i1 >= 0 && i1 < s;
  long long i2 = -1;
  bool ok2 = false;
  if (idx2 != nullptr) {
    i2 = idx2[lane];
    ok2 = mask2[lane] != 0 && i2 >= 0 && i2 < s;
  }
  char* row = buf + lane * b_lane + e * b_elem;
  if (ok2)
    *reinterpret_cast<T*>(row + i2 * b_slot) =
        *reinterpret_cast<const T*>(val2 + lane * v2_lane + e * v2_elem);
  if (ok1 && !(ok2 && i1 == i2))
    *reinterpret_cast<T*>(row + i1 * b_slot) =
        *reinterpret_cast<const T*>(val1 + lane * v1_lane + e * v1_elem);
}

}  // namespace

// idx2/mask2/val2 are null for a single write. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an element size other
// than 1, 4 or 8 bytes.
extern "C" int slot_write(void* buf, int elem_bytes, long long n, long long s,
                          long long w, long long b_lane, long long b_slot,
                          long long b_elem, const long long* idx1,
                          const uint8_t* mask1, const void* val1,
                          long long v1_lane, long long v1_elem,
                          const long long* idx2, const uint8_t* mask2,
                          const void* val2, long long v2_lane,
                          long long v2_elem, cudaStream_t stream) {
  if (n <= 0 || w <= 0) return 0;
  const int block = 256;
  const long long grid = (n * w + block - 1) / block;
  char* b = static_cast<char*>(buf);
  const char* a1 = static_cast<const char*>(val1);
  const char* a2 = static_cast<const char*>(val2);
#define SLOT_WRITE_LAUNCH(T)                                                 \
  slot_write_kernel<T><<<(unsigned)grid, block, 0, stream>>>(                \
      b, n, s, w, b_lane, b_slot, b_elem, idx1, mask1, a1, v1_lane, v1_elem, \
      idx2, mask2, a2, v2_lane, v2_elem)
  switch (elem_bytes) {
    case 1: SLOT_WRITE_LAUNCH(uint8_t); break;
    case 4: SLOT_WRITE_LAUNCH(uint32_t); break;
    case 8: SLOT_WRITE_LAUNCH(uint64_t); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SLOT_WRITE_LAUNCH
  return (int)cudaGetLastError();
}
