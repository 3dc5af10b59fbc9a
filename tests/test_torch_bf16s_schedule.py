"""The schedule of the bf16-storage fused kernel (``csrc/whvi_bf16s.cu``),
run in numpy on the CPU.

The kernel cannot run here, but its index arithmetic can: this file
mirrors ``Bf16sShape``, ``RowIo`` and ``Bf16sExchange`` (design constants
read from the source), simulates one launch's blocks thread by thread
(register windows, butterflies on register bits, the fp32 and bf16
exchanges through their swizzled buffers, the five roundings) and holds
the result bit for bit against the plain version, at every width the
kernel takes. It also checks that every exchange is a bijection between
registers and slots, and that at the scaling path's widths no warp's
shared-memory access has a bank conflict (32 banks of 4 bytes, 16-byte
accesses served a quarter-warp at a time).
"""

import os
import re

import numpy as np
import pytest
import torch

from tools import kernel_variants
from whvi_tpu_torch.ops import fwht_cuda as fc

SOURCE = os.path.join(fc.CSRC, "whvi_bf16s.cu")
IO = -1  # the I/O window, kIo


def _constants(source: str = SOURCE) -> dict:
    with open(source) as f:
        text = f.read()
    found = re.findall(r"constexpr (?:int|bool) (kBf16s\w+) = (\w+);", text)
    return {k: v == "true" if v in ("true", "false") else int(v) for k, v in found}


class Shape:
    """``Bf16sShape<L>``."""

    def __init__(self, L: int, c: dict):
        want = c["kBf16sLargeLog2Regs"] if L >= c["kBf16sLargeFromLog2D"] else c["kBf16sLog2Regs"]
        self.L, self.r = L, min(L, want)
        self.R = 1 << self.r
        self.tpr = 1 << (L - self.r)
        self.block = max(self.tpr, c["kBf16sMinBlock"])
        self.rows = self.block // self.tpr
        self.last = L - self.r
        self.top_io = self.last + 3
        self.io = c["kBf16sIoSchedule"] and self.tpr > 1
        self.w0 = not c["kBf16sIoSchedule"] and self.tpr > 1
        if self.tpr == 1:
            self.windows = 1
        elif self.io:
            self.windows = -(-(self.top_io - 3) // self.r) + 2
        else:
            self.windows = -(-L // self.r)
        self.first, self.end = self.window(0), self.window(self.windows - 1)
        self.w_in = IO if self.w0 and c["kBf16sLoadViaIo"] else self.first
        self.w_out = IO if self.w0 and c["kBf16sStoreViaIo"] else self.end
        self.fp32_buffers = 0 if self.tpr == 1 else c["kBf16sFp32Buffers"]
        self.buf32 = 4 * (self.slot32((self.rows << L) - 1) + 1 if self.io else self.rows << L)

    def lo(self, k: int) -> int:
        if k >= self.windows:
            return self.L
        if not self.io:
            return k * self.r
        return 0 if k == 0 else self.top_io if k == self.windows - 1 else 3 + (k - 1) * self.r

    def window(self, k: int) -> int:
        if self.tpr == 1:
            return 0
        if not self.io:
            return min(k * self.r, self.last)
        if k in (0, self.windows - 1):
            return IO
        return max(min(self.lo(k), self.top_io - self.r), 0)

    def reg_bit(self, w: int, s: int) -> int:
        return (s if s < 3 else s - self.top_io + 3) if w == IO else s - w

    def reg_index(self, w: int, j):
        if self.tpr == 1:
            return j
        if w == IO:
            return (j & 7) | ((j >> 3) << self.top_io)
        return j << w

    def lane_index(self, w: int, t, q):
        if self.tpr == 1:
            e = 0 * t
        elif w == IO:
            e = t << 3
        else:
            e = (t & ((1 << w) - 1)) | ((t >> w) << (w + self.r))
        return e | (q << self.L)

    def slot32(self, e):
        if self.io:
            return e + 4 * (e >> 5) + 4 * (e >> (self.r + 2))
        return e ^ (((e >> self.r) & 7) << 2)

    def join32(self, lane, reg):
        return lane + reg if self.io else lane ^ reg

    def slot16(self, e):
        return e ^ (((e >> self.r) & 7) << 3)

    def row_offsets(self, w: int, t):
        """``RowIo<L, w>``: element offset in its row of each register of
        thread t, (threads, R)."""
        j = np.arange(self.R)
        if self.tpr == 1:
            return np.broadcast_to(j, (len(t), self.R))
        if w in (0, IO):  # groups of 8: group(t, g) + k
            g, k = j >> 3, j & 7
            if w == IO:
                return 8 * (g[None] * self.tpr + t[:, None]) + k[None]
            return (t[:, None] << self.r) + 8 * g[None] + k[None]
        assert w == self.last
        return t[:, None] + (j[None] << self.last)  # single(t, j)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()


class Block:
    """One block's threads: v (threads, R) float32 and the buffers, with
    the order of writes, barriers and reads into each buffer."""

    def __init__(self, S: Shape):
        self.S = S
        tid = np.arange(S.block)
        self.t, self.q = tid % S.tpr, tid // S.tpr
        self.j = np.arange(S.R)
        self.accesses = []  # (width bytes, byte addresses (threads, accesses))
        self.events = []  # ("write" | "read", buffer) or ("sync",)
        self.n32 = 0  # fp32 exchanges so far

    def _slots(self, slot, join, w, step):
        S, j = self.S, self.j[::step]
        lane = slot(S.lane_index(w, self.t, self.q))
        got = join(lane[:, None], slot(S.reg_index(w, j))[None])  # as the kernel joins them
        want = slot(S.lane_index(w, self.t, self.q)[:, None] | S.reg_index(w, j)[None])
        assert np.array_equal(got, want), "slot() does not join the lane's and the register's parts"
        return got

    def move(self, v, w_from, w_to, bf16: bool, after32: bool = False):
        S = self.S
        if bf16:
            slot, join, elem, group, buf = S.slot16, np.bitwise_xor, 2, 8, "bf16"
            assert np.array_equal(v, _bf16(v)), "a bf16 exchange carries an unrounded value"
        else:
            slot, join, elem, group = S.slot32, S.join32, 4, 4
            buf = f"fp32-{self.n32 % S.fp32_buffers}"
            if after32 and S.fp32_buffers == 1:
                self.events.append(("sync",))
            self.n32 += 1
        ws = group if w_from in (0, IO) else 1
        rs = group if w_to in (0, IO) else 1
        size = S.buf32 // 4 if not bf16 else S.rows << S.L
        data = np.full(size, np.nan, dtype=np.float32)
        base = self._slots(slot, join, w_from, ws)
        addr = (base[:, :, None] + np.arange(ws)).reshape(len(self.t), -1)
        assert len(np.unique(addr)) == addr.size == S.rows << S.L, "the writes are not one-to-one"
        assert (base % ws == 0).all(), "a vector access is not aligned"
        data[addr] = v
        self.accesses.append((elem * ws, elem * base))
        self.events += [("write", buf), ("sync",), ("read", buf)]
        base = self._slots(slot, join, w_to, rs)
        addr = (base[:, :, None] + np.arange(rs)).reshape(len(self.t), -1)
        self.accesses.append((elem * rs, elem * base))
        out = data[addr]
        assert not np.isnan(out).any()
        return out

    def check_hazards(self):
        """Every write into a buffer follows a barrier after its last read."""
        synced = set()  # buffers read before the last barrier
        pending = set()  # buffers read since the last barrier
        for ev in self.events:
            if ev[0] == "sync":
                synced |= pending
                pending = set()
            elif ev[0] == "read":
                pending.add(ev[1])
            else:
                assert ev[1] not in pending, f"write into {ev[1]} races its earlier reads"


def _butterfly(v, k):
    j = np.arange(v.shape[1])
    lo = j[(j >> k) & 1 == 0]
    a, b = v[:, lo].copy(), v[:, lo | (1 << k)].copy()
    v[:, lo], v[:, lo | (1 << k)] = a + b, a - b


def _transform(v, blk: Block, after32: bool):
    S = blk.S
    for k in range(S.windows):
        for s in range(S.lo(k), S.lo(k + 1)):
            _butterfly(v, S.reg_bit(S.window(k), s))
        if k + 1 < S.windows:
            v = blk.move(v, S.window(k), S.window(k + 1), bf16=False, after32=after32 or k > 0)
    return v


def simulate(L: int, c: dict, s1, u, s2, x):
    """y, i1, i2 (n_rows, D) float32 of bf16 values, as the kernel's blocks
    compute them; the operands are (n_rows, D) float32 of bf16 values."""
    S = Shape(L, c)
    n_rows = x.shape[0]
    outs = [np.zeros_like(x) for _ in range(3)]
    blocks = []
    for b0 in range(0, n_rows, S.rows):
        blk = Block(S)
        row = b0 + blk.q
        active = row < n_rows
        rr = np.minimum(row, n_rows - 1)[:, None]

        def read(a, w):
            return np.where(active[:, None], a[rr, S.row_offsets(w, blk.t)], 0).astype(np.float32)

        def write(a, w, v):
            off = S.row_offsets(w, blk.t)
            a[rr[active], off[active]] = v[active]

        v = _bf16(read(x, S.w_in) * read(s2, S.w_in))  # t0 = R(s2 x)
        if S.w_in != S.first:
            v = blk.move(v, S.w_in, S.first, bf16=True)
        v = _bf16(_transform(v, blk, False))  # i1
        mid = S.end != S.first
        if mid:
            v = blk.move(v, S.end, S.first, bf16=True)
        write(outs[1], S.first, v)
        v = _bf16(v * read(u, S.first))  # t1
        v = _bf16(_transform(v, blk, not mid))  # i2
        if S.w_out != S.end:
            v = blk.move(v, S.end, S.w_out, bf16=True)
        write(outs[2], S.w_out, v)
        write(outs[0], S.w_out, _bf16(v * read(s1, S.w_out)))  # y
        blk.check_hazards()
        blocks.append(blk)
    return outs, blocks


def wavefronts(width: int, addrs: np.ndarray) -> tuple[int, int]:
    """(wavefronts, the fewest possible) of one warp's access of ``width``
    bytes a thread at byte addresses ``addrs`` (32,): 32 banks of 4 bytes;
    a 16-byte access is served a quarter-warp a wavefront, 8 bytes a half."""
    per = 32 if width <= 4 else 32 // (width // 4)
    total = 0
    for p in range(0, 32, per):
        banks: dict[int, set] = {}
        for a in addrs[p:p + per]:
            for k in range(max(width, 4) // 4):
                word = int(a) // 4 + k
                banks.setdefault(word % 32, set()).add(word)
        total += max(len(w) for w in banks.values())
    return total, 32 // per


CONSTANTS = _constants()


def test_the_source_declares_every_design_constant():
    assert set(CONSTANTS) == {
        "kBf16sLog2Regs", "kBf16sLargeLog2Regs", "kBf16sLargeFromLog2D", "kBf16sMinBlock",
        "kBf16sRegCap", "kBf16sLargeRegCap", "kBf16sIoSchedule", "kBf16sFp32Buffers",
        "kBf16sPrefetch", "kBf16sLoadViaIo", "kBf16sStoreViaIo",
    }


def _equals_plain(L: int, c: dict) -> None:
    """y, i1, i2 of the simulated kernel equal fused_plain's on bf16 storage,
    over two blocks' rows (the last block part idle)."""
    S = Shape(L, c)
    D, n_rows = 1 << L, (2 * S.rows - 1 if S.rows > 1 else 2)
    rng = np.random.default_rng(L)
    ops = [torch.from_numpy(rng.standard_normal((n_rows, D)).astype(np.float32)).to(torch.bfloat16)
           for _ in range(4)]
    got, _ = simulate(L, c, *(a.float().numpy() for a in ops))
    want = fc.fused_plain(*ops, True)
    for g, w in zip(got, want):
        assert torch.equal(torch.from_numpy(g).to(torch.bfloat16), w)


@pytest.mark.parametrize("L", range(1, 15))
def test_schedule_is_the_plain_version_bit_for_bit(L):
    _equals_plain(L, CONSTANTS)


# the design variants of tools/kernel_variants.py that set the kernel's
# switches (the diagnostic ones compute wrong results on purpose;
# no_swizzle edits a slot function, not a switch)
SWITCH_VARIANTS = [
    name for name, edits in kernel_variants.VARIANTS.items()
    if name not in (*kernel_variants.DIAGNOSTIC, "no_swizzle")
    and any(f == kernel_variants.BF16S for f, _, _ in edits)
]


@pytest.mark.parametrize("name", SWITCH_VARIANTS)
def test_variant_schedules_are_the_plain_version_bit_for_bit(name, tmp_path):
    """Every schedule the variants tool times (the window-0 schedule and its
    bf16 exchanges in and out, two fp32 buffers, other register counts and
    block sizes) computes the plain version, barriers in place."""
    src = kernel_variants.make_sources(name, str(tmp_path))
    c = _constants(os.path.join(src, "whvi_bf16s.cu"))
    assert c != CONSTANTS
    for L in (5, 9, 12, 13, 14):
        _equals_plain(L, c)


@pytest.mark.parametrize("L", [12, 13, 14])
def test_exchanges_are_free_of_bank_conflicts(L):
    """At the scaling path's widths (and K1's D=16384) every warp's access
    of either buffer takes the fewest wavefronts its width allows."""
    S = Shape(L, CONSTANTS)
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((S.rows, 1 << L)).astype(np.float32))
    _, blocks = simulate(L, CONSTANTS, x, x, x, x)
    n_fp32 = 2 * (S.windows - 1)
    n_bf16 = (S.w_in != S.first) + (S.end != S.first) + (S.w_out != S.end)
    assert len(blocks[0].accesses) == 2 * (n_fp32 + n_bf16)
    for width, addr in blocks[0].accesses:
        for warp in range(S.block // 32):
            for col in range(addr.shape[1]):
                got, best = wavefronts(width, addr[32 * warp:32 * warp + 32, col])
                assert got == best, (L, width, warp, col)
