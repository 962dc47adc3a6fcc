"""Host->device streaming of a train split larger than the device's budget
(port of the JAX package's ``data/streaming.py``).

The device-resident path gathers every batch from a split that lives on
the card whole, which caps the split at device memory. Above the budget
(``-hbm_budget_gb``; 0: 60 % of the card's memory, 8 GiB on the CPU, as
``device_budget_bytes`` resolves it) the split stays in pinned host memory
and the steps take their rows from BLOCKS of K steps (``-stream_block_steps``,
0: 64): the rows of a block are gathered on the host into a pinned staging
buffer and copied to the card on a side stream while the previous block
computes, two blocks in flight. The compute stream waits on each copy's
event before its first step; each block is marked as used by the compute
stream (``record_stream``), so the allocator reuses its memory only after
its last step has run, and a staging buffer is refilled only after its
copy has ended.

A streamed epoch takes the resident epoch's permutation and hands each step
the same rows (``feed``: its block, and the positions of its rows there),
so a streamed run computes bit for bit what a resident run does. Every
data rank streams the whole batch, as under the replicated layout.
On the CPU a block is the host gather itself (no copy, no stream).
"""

import numpy as np
import torch

DEFAULT_BUDGET_BYTES = 8 << 30
BLOCK_STEPS = 64
RESIDENT_SHARE = 0.6  # of device memory a resident train split may take


def split_nbytes(data):
    """Bytes of a split's {loc: {mod: array}}."""
    return sum(a.nbytes for mods in data.values() for a in mods.values())


def device_budget_bytes(args, device):
    """-hbm_budget_gb in bytes, or with 0 60 % of ``device``'s memory (8 GiB
    where it is not a card)."""
    gb = float(getattr(args, "hbm_budget_gb", 0) or 0)
    if gb > 0:
        return int(gb * (1 << 30))
    if device.type == "cuda":
        return int(RESIDENT_SHARE * torch.cuda.get_device_properties(device).total_memory)
    return DEFAULT_BUDGET_BYTES


class BlockStream:
    """The train split on the host, fed to ``device`` in blocks of
    ``block_steps`` steps. ``data`` {loc: {mod: numpy [N, ...]}} and
    ``labels`` numpy [N] are taken over (pinned, on a card)."""

    def __init__(self, data, labels, device, block_steps=0):
        self.device = torch.device(device)
        self.block_steps = block_steps or BLOCK_STEPS
        self.cuda = self.device.type == "cuda"
        as_tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        self.data = {loc: {m: as_tensor(a) for m, a in mods.items()} for loc, mods in data.items()}
        self.labels = as_tensor(np.asarray(labels).astype(np.int64))
        if self.cuda:  # pin_memory raises where the host cannot pin
            self.data = {loc: {m: a.pin_memory() for m, a in mods.items()}
                         for loc, mods in self.data.items()}
            self.labels = self.labels.pin_memory()
            self.copy_stream = torch.cuda.Stream(self.device)
            self._staging = [None, None]  # two pinned buffers, a block each
            self._copied = [None, None]  # the event of each buffer's last copy
        self._turn = 0

    def _tensors(self):
        return [a for mods in self.data.values() for a in mods.values()] + [self.labels]

    def _pack(self, flat):
        out, i = {}, 0
        for loc, mods in self.data.items():
            out[loc] = {}
            for m in mods:
                out[loc][m] = flat[i]
                i += 1
        return out, flat[i]

    def _stage(self, rows):
        """The host rows gathered into the next pinned buffer, once its last
        copy has ended."""
        j, n = self._turn, rows.shape[0]
        self._turn ^= 1
        if self._copied[j] is not None:
            self._copied[j].synchronize()
        if self._staging[j] is None or self._staging[j][0].shape[0] < n:
            self._staging[j] = [torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                                            pin_memory=True) for t in self._tensors()]
        bufs = [buf[:n] for buf in self._staging[j]]
        for t, buf in zip(self._tensors(), bufs):
            torch.index_select(t, 0, rows, out=buf)
        return j, bufs

    def start(self, rows):
        """Begin the transfer of one block (int64 host rows [n]) -> a handle
        for ``wait``."""
        if not self.cuda:
            return [t.index_select(0, rows) for t in self._tensors()], None
        j, bufs = self._stage(rows)
        with torch.cuda.stream(self.copy_stream):
            dev = [buf.to(self.device, non_blocking=True) for buf in bufs]
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self._copied[j] = done
        return dev, done

    def wait(self, handle):
        """The block of a ``start`` handle, usable on the current stream:
        (data {loc: {mod: [n, ...]}}, labels [n])."""
        flat, done = handle
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for t in flat:
                t.record_stream(compute)
        return self._pack(flat)

    def feed(self, steps):
        """(data, labels, idx) of each step of ``steps`` (int64 host rows
        [S, B]), in order: its block and its rows' positions there. Block
        b + 1 is started once block b's first step has been handed out."""
        steps = torch.as_tensor(steps, dtype=torch.int64)
        S, B = steps.shape
        K = min(self.block_steps, S)
        starts = list(range(0, S, K))
        local = {}
        nxt = self.start(steps[:K].reshape(-1))
        for n, s0 in enumerate(starts):
            k = min(K, S - s0)
            data, labels = self.wait(nxt)
            if k not in local:
                local[k] = torch.arange(k * B, device=self.device).view(k, B)
            for j in range(k):
                yield data, labels, local[k][j]
                if j == 0 and n + 1 < len(starts):
                    s1 = starts[n + 1]
                    nxt = self.start(steps[s1:s1 + K].reshape(-1))
