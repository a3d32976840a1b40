"""Batched keccak-256 on tensors: the plain PyTorch permutation and the
sponge around it.

The state is ``[..., 25]`` int64, one 64-bit lane per element
(lane i = x + 5*y). The JAX package holds each lane as a (lo, hi) pair
of uint32 because a TPU has no 64-bit integers; `interop.lanes_from_lohi`
and `lanes_to_lohi` convert. int64 shifts in PyTorch are arithmetic, so
every right shift of a lane is masked to its low bits.

`keccak_f` and `keccak_sponge_plain` here are the plain versions of the
hand-written CUDA kernels in csrc/keccak_f.cu. Callers go through
`ops.keccak_cuda.keccak_f` and `ops.keccak_cuda.keccak_sponge`, which run
these functions for a CPU tensor and the kernels for a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from mythril_tpu_torch.support.keccak import RC as _RC_INT
from mythril_tpu_torch.support.keccak import _ROT

_RATE = 136
_RATE_LANES = _RATE // 8
#: blocks the SHA3 sponge absorbs at most: 136 * 8 - 1 = 1087 bytes
SPONGE_MAX_BLOCKS = 8

#: round constants as int64 bit patterns
_RC = [rc - (1 << 64) if rc >> 63 else rc for rc in _RC_INT]

# rho + pi as one gather: destination lane y + 5*((2x + 3y) % 5) takes
# source lane x + 5*y rotated left by _ROT[x][y]
_PI_SRC = np.zeros(25, np.int64)
_RHO = np.zeros(25, np.int64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _RHO[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _ROT[_x][_y]


def _rol(v, n):
    """Rotate int64 lanes left by n (a python int or a tensor of ints in
    [0, 64)). The right shift is arithmetic on int64, so its result is
    masked to the n bits that wrap around."""
    if isinstance(n, int):
        if n == 0:
            return v
        return (v << n) | ((v >> (64 - n)) & ((1 << n) - 1))
    mask = (torch.ones_like(n) << n) - 1
    return (v << n) | ((v >> ((64 - n) % 64)) & mask)


def keccak_f(state):
    """keccak-f[1600] on [..., 25] int64 lanes (plain PyTorch)."""
    dev = state.device
    pi_src = torch.as_tensor(_PI_SRC, device=dev)
    rho = torch.as_tensor(_RHO, device=dev)
    s = state
    for rnd in range(24):
        grid = s.unflatten(-1, (5, 5))  # [..., y, x]
        # theta
        c = grid[..., 0, :] ^ grid[..., 1, :] ^ grid[..., 2, :] ^ grid[..., 3, :] ^ grid[..., 4, :]
        d = torch.roll(c, 1, -1) ^ _rol(torch.roll(c, -1, -1), 1)
        a = (grid ^ d.unsqueeze(-2)).flatten(-2)
        # rho + pi
        b = _rol(a[..., pi_src], rho).unflatten(-1, (5, 5))
        # chi
        out = b ^ (~torch.roll(b, -1, -1) & torch.roll(b, -2, -1))
        s = out.flatten(-2)  # a fresh tensor: iota may update it in place
        # iota
        s[..., 0] ^= _RC[rnd]
    return s


def absorb_lanes(block):
    """[..., 8k] uint8 bytes -> [..., k] int64 little-endian lanes. The
    eight byte fields do not overlap, so their sum is their OR (a top
    byte >= 0x80 wraps the int64 to the lane's bit pattern)."""
    by = block.to(torch.int64).unflatten(-1, (-1, 8))
    shifts = 8 * torch.arange(8, device=block.device, dtype=torch.int64)
    return (by << shifts).sum(-1)


def squeeze_bytes(lanes):
    """[..., k] int64 lanes -> [..., 8k] uint8 little-endian bytes. The
    mask keeps each byte exact under the arithmetic right shift."""
    shifts = 8 * torch.arange(8, device=lanes.device, dtype=torch.int64)
    return ((lanes.unsqueeze(-1) >> shifts) & 0xFF).flatten(-2).to(torch.uint8)


def keccak_sponge_plain(mem, off, length, ok):
    """The plain version of the SHA3 sponge kernel: keccak-256 of
    mem[lane, off:off+length] where ok[lane], as a u256 limb word
    [N, 16] int32, zero elsewhere (the EVM step's SHA3 phase).

    Every lane absorbs all SPONGE_MAX_BLOCKS blocks, masked to its own
    count; the digest is captured when the lane's last block has been
    permuted. Offsets are clamped to [0, C] and bytes past the row read
    as zero, so a lane of length 0 reads nothing; a length outside
    [0, 136 * SPONGE_MAX_BLOCKS) never captures a digest and gives zero."""
    from mythril_tpu_torch.ops import u256

    n, cap = mem.shape
    dev = mem.device
    # per-lane padded length in rate blocks (>= 1)
    n_blocks = (length + 1 + _RATE - 1) // _RATE
    last_pad = n_blocks * _RATE - 1  # absolute 0x80 position
    base = off.clamp(0, cap)[:, None]
    state = torch.zeros((n, 25), dtype=torch.int64, device=dev)
    final = state
    for blk in range(SPONGE_MAX_BLOCKS):
        pos = blk * _RATE + torch.arange(_RATE, device=dev)[None, :]
        block_idx = base + pos
        inb = (pos < length[:, None]) & (block_idx < cap)
        raw = torch.gather(mem, 1, block_idx.clamp(0, cap - 1).long())
        raw = torch.where(inb, raw, 0)
        # multi-rate padding: 0x01 at len, 0x80 at the final byte
        raw = raw | torch.where(pos == length[:, None], 0x01, 0).to(torch.uint8)
        raw = raw | torch.where(pos == last_pad[:, None], 0x80, 0).to(torch.uint8)
        active_blk = (blk < n_blocks)[:, None]
        absorbed = state.clone()
        absorbed[:, :_RATE_LANES] ^= absorb_lanes(raw)
        permuted = keccak_f(absorbed)
        state = torch.where(active_blk, permuted, state)
        final = torch.where((n_blocks == blk + 1)[:, None], state, final)
    word = u256.bytes_to_word(squeeze_bytes(final[:, :4]))
    return torch.where(ok[:, None], word, 0)


def keccak256(msg, device=None):
    """Batched keccak-256. msg: [..., L] uint8 tensor (or bytes) ->
    [..., 32] uint8.

    A tensor is hashed where it lies; bytes go to `device`, which is the
    card unless the caller names the CPU. The permutation goes through
    the wrapper, so on a CUDA tensor it is the hand-written kernel."""
    from mythril_tpu_torch.ops import keccak_cuda
    from mythril_tpu_torch.support.accel import resolve_device

    if not isinstance(msg, torch.Tensor):
        msg = torch.as_tensor(np.frombuffer(bytes(msg), dtype=np.uint8).copy(),
                              device=resolve_device(device))
    elif device is not None:
        msg = msg.to(device)
    length = msg.shape[-1]
    batch = msg.shape[:-1]
    # pad to the next multiple of RATE; when only one byte is free the
    # 0x01 and 0x80 markers land on the same byte (0x81)
    padded_len = (length // _RATE + 1) * _RATE
    pad = torch.zeros(batch + (padded_len - length,), dtype=torch.uint8,
                      device=msg.device)
    pad[..., 0] = 0x01
    pad[..., -1] |= 0x80
    data = torch.cat([msg.to(torch.uint8), pad], dim=-1)
    state = torch.zeros(batch + (25,), dtype=torch.int64, device=msg.device)
    for off in range(0, padded_len, _RATE):
        state[..., :_RATE_LANES] ^= absorb_lanes(data[..., off : off + _RATE])
        state = keccak_cuda.keccak_f(state.contiguous())
    return squeeze_bytes(state[..., :4])


def keccak256_word(msg, device=None):
    """keccak-256 of [..., L] uint8 returned as a u256 limb word [..., 16]."""
    from mythril_tpu_torch.ops import u256

    return u256.bytes_to_word(keccak256(msg, device=device))
