"""Paged KV cache: a shared block pool and per-lane block tables (the port of
llamatpu/runtime/paged_cache.py).

Device side: one packed pool [L, NBLK, KV, BS, hd + vhd] (K in the first hd
entries of a row, V in the rest). A lane's row at absolute position s lives
in block tables[lane, s // BS] at offset s % BS. Writes are one index write
per layer for all lanes and rows (`paged_write_stacked`, IN PLACE: the JAX
package carried the pool through its layer scan); decode attention reads the
pool through the tables (K8, ops/attention.py); prefill gathers a dense lane
view (`paged_gather`) and takes the plain masked attention.

Host side: `BlockAllocator`, a free list that grows each lane's table on
demand and recycles blocks when lanes finish, with block-level prefix
caching. Full blocks are content-addressed by a chained digest of the token
prefix they complete (`block_hashes`); a new request whose prompt starts
with a cached chain maps those blocks into its table read-only (refcounted)
and prefills only from the first novel position. Released lanes register
their verified full blocks at refcount 0 (evictable, least recently used
first). The LAST pool block is the trash block: every unallocated table
entry points at it, so padded prefill tails and parked lanes write there.

An int8 pool keeps one f32 scale per (position, KV head) for K and V in a
scale pool [L, NBLK, KV, 2, BS] (row 0 = K), indexed by the same block ids:
a shared prefix block and the trash block carry their scale rows with them.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from llamatpu_torch.models.config import ModelConfig


def block_hashes(tokens, block_size: int) -> list[bytes]:
    """Chained content digests, one per FULL block: hash i commits to
    tokens[0 : (i+1)*block_size] (chain = prev digest || block tokens as
    int32 bytes), so a match at block i implies the whole prefix matches."""
    out: list[bytes] = []
    prev = b""
    for i in range(len(tokens) // block_size):
        blk = np.asarray(tokens[i * block_size:(i + 1) * block_size], np.int32).tobytes()
        prev = hashlib.blake2b(prev + blk, digest_size=16).digest()
        out.append(prev)
    return out


@dataclass
class PagedKVCache:
    kv_pool: torch.Tensor  # [L, NBLK, KV, BS, hd + vhd], written in place
    block_size: int
    scale: torch.Tensor | None = None  # int8 pools: [L, NBLK, KV, 2, BS] f32

    @property
    def n_blocks(self) -> int:
        return self.kv_pool.shape[1]

    @property
    def quantized(self) -> bool:
        return self.scale is not None


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int = 16,
                     dtype=torch.bfloat16, device: str | torch.device = "cuda") -> PagedKVCache:
    if dtype not in (torch.bfloat16, torch.float32, torch.int8):
        raise NotImplementedError(f"{dtype} paged KV pool: the port keeps bf16, f32 or int8")
    if block_size & (block_size - 1):
        raise ValueError(f"block size {block_size} is not a power of two")
    kv = torch.zeros((cfg.n_layers, n_blocks, cfg.n_kv_heads, block_size,
                      cfg.head_dim + cfg.v_head_dim), dtype=dtype, device=device)
    scale = None
    if dtype == torch.int8:
        scale = torch.zeros((cfg.n_layers, n_blocks, cfg.n_kv_heads, 2, block_size),
                            dtype=torch.float32, device=device)
    return PagedKVCache(kv, block_size, scale)


def _slots(pool: torch.Tensor, tables: torch.Tensor, pos_vec: torch.Tensor, t: int,
           block_size: int):
    """(block ids [B*T], offsets [B*T]) of rows pos_vec[b] + 0..t-1. A row
    past the table (the padded tail of a final prefill chunk) goes to the
    trash block, as the JAX package's out-of-range gather and scatter drop it."""
    shift = block_size.bit_length() - 1
    positions = pos_vec.to(device=pool.device, dtype=torch.long)[:, None] \
        + torch.arange(t, device=pool.device)[None, :]
    idx = positions >> shift
    maxblk = tables.shape[1]
    blks = torch.gather(tables.to(device=pool.device, dtype=torch.long), 1,
                        idx.clamp(max=maxblk - 1))
    blks = torch.where(idx < maxblk, blks, torch.full_like(blks, pool.shape[-4] - 1))
    return blks.reshape(-1), (positions & (block_size - 1)).reshape(-1)


def paged_write_stacked(pool: torch.Tensor, li: int, new: torch.Tensor, tables: torch.Tensor,
                        pos_vec: torch.Tensor, block_size: int) -> torch.Tensor:
    """Write new [B, T, KV, hd + vhd] rows into the STACKED pool
    [L, NBLK, KV, BS, hd + vhd] at layer li, rows pos_vec[b] + 0..T-1 of each
    lane through its table row (tables [B, MAXBLK]): one index write, cast to
    the pool dtype, IN PLACE. Returns the pool."""
    b, t, kv, w = new.shape
    blks, offs = _slots(pool, tables, pos_vec, t, block_size)
    pool[li][blks, :, offs] = new.reshape(b * t, kv, w).to(pool.dtype)
    return pool


def paged_write_scale_stacked(spool: torch.Tensor, li: int, s_new: torch.Tensor,
                              tables: torch.Tensor, pos_vec: torch.Tensor,
                              block_size: int) -> torch.Tensor:
    """Write s_new [B, T, KV, 2] (K and V scale per row and head) into the
    STACKED scale pool [L, NBLK, KV, 2, BS] at layer li, at the slots
    `paged_write_stacked` gives the rows, in place. Returns the scale pool."""
    b, t, kv, _ = s_new.shape
    blks, offs = _slots(spool, tables, pos_vec, t, block_size)
    spool[li][blks, :, :, offs] = s_new.reshape(b * t, kv, 2).to(spool.dtype)
    return spool


def paged_gather_scale(spool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Dense scale-row lane view matching paged_gather: one layer's scale
    pool [NBLK, KV, 2, BS] and tables [B, MAXBLK] -> [B, KV, 2, MAXBLK*BS]."""
    g = spool[tables.to(device=spool.device, dtype=torch.long)]  # [B, MAXBLK, KV, 2, BS]
    b, mb, kv, two, bs = g.shape
    return g.permute(0, 2, 3, 1, 4).reshape(b, kv, two, mb * bs)


def paged_gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Dense head-major lane view: one layer's pool [NBLK, KV, BS, W] and
    tables [B, MAXBLK] -> [B, KV, MAXBLK*BS, W] (a copy)."""
    g = pool[tables.to(device=pool.device, dtype=torch.long)]   # [B, MAXBLK, KV, BS, W]
    b, mb, kv, bs, w = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, kv, mb * bs, w)


class BlockAllocator:
    """Host-side free-list allocator with per-lane tables and the prefix
    cache (semantics of llamatpu/runtime/paged_cache.py `BlockAllocator`).

    A lane's table is [shared cached blocks][private blocks]. Shared blocks
    are refcounted and never written (writers start at the first private,
    block-aligned position). Cached blocks at refcount 0 live in an LRU and
    are evicted (hash unregistered, block reused) only when the free list
    runs dry. `tables` is the host copy [n_lanes, max_blocks_per_lane] int32
    that the engines send to the device."""

    def __init__(self, n_blocks: int, n_lanes: int, max_blocks_per_lane: int):
        if n_blocks < 2:
            raise ValueError("need at least one usable block + the trash block")
        self.n_blocks = n_blocks
        self.trash_block = n_blocks - 1
        self.max_blocks_per_lane = max_blocks_per_lane
        self._free = list(range(n_blocks - 2, -1, -1))
        self._lane_shared: dict[int, list[int]] = {i: [] for i in range(n_lanes)}
        self._lane_blocks: dict[int, list[int]] = {i: [] for i in range(n_lanes)}
        self._cached: dict[bytes, int] = {}       # chain hash -> block id
        self._block_hash: dict[int, bytes] = {}   # block id -> chain hash
        self._ref: dict[int, int] = {}            # block id -> live refcount
        self._lru: OrderedDict[int, None] = OrderedDict()  # refcount-0 cached blocks
        self.tables = np.full((n_lanes, max_blocks_per_lane), self.trash_block, np.int32)

    def free_blocks(self) -> int:
        """Blocks allocatable right now (truly free + evictable cached)."""
        return len(self._free) + len(self._lru)

    def cached_blocks(self) -> int:
        return len(self._cached)

    def lane_len_capacity(self, lane: int, block_size: int) -> int:
        return (len(self._lane_shared[lane]) + len(self._lane_blocks[lane])) * block_size

    def can_allocate(self, n: int) -> bool:
        return self.free_blocks() >= n

    def _pop_free(self) -> int | None:
        if self._free:
            return self._free.pop()
        if self._lru:  # evict the coldest cached block
            blk, _ = self._lru.popitem(last=False)
            h = self._block_hash.pop(blk)
            del self._cached[h]
            self._ref.pop(blk, None)
            return blk
        return None

    def acquire_prefix(self, lane: int, hashes: list[bytes], max_blocks: int) -> int:
        """Map the longest cached chain into this lane's table (read-only,
        refcounted). Returns the number of shared blocks mapped. Call before
        any ensure() for the lane (shared blocks lead the table)."""
        if self._lane_shared[lane] or self._lane_blocks[lane]:
            raise RuntimeError(f"lane {lane} already holds blocks")
        n = 0
        for h in hashes[:max_blocks]:
            blk = self._cached.get(h)
            if blk is None:
                break
            self._ref[blk] = self._ref.get(blk, 0) + 1
            self._lru.pop(blk, None)
            self._lane_shared[lane].append(blk)
            self.tables[lane, n] = blk
            n += 1
        return n

    def ensure(self, lane: int, n_positions: int, block_size: int) -> bool:
        """Grow the lane's table to cover n_positions; False if the pool is
        exhausted (the blocks taken so far stay with the lane)."""
        need = -(-n_positions // block_size)
        have = len(self._lane_shared[lane]) + len(self._lane_blocks[lane])
        if need > self.max_blocks_per_lane:
            return False
        while have < need:
            blk = self._pop_free()
            if blk is None:
                return False
            self._lane_blocks[lane].append(blk)
            self.tables[lane, have] = blk
            have += 1
        return True

    def release(self, lane: int, hashes: list[bytes] | None = None) -> None:
        """Free the lane. `hashes` (chain digests of the lane's VERIFIED token
        history) registers the lane's private full blocks into the prefix
        cache; without it (or for blocks past the verified history, or
        already cached under the same hash) blocks return to the free list."""
        shared = self._lane_shared[lane]
        for blk in shared:
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                del self._ref[blk]
                self._lru[blk] = None  # stays cached, now evictable
        n_shared = len(shared)
        for j, blk in enumerate(self._lane_blocks[lane]):
            idx = n_shared + j
            h = hashes[idx] if hashes is not None and idx < len(hashes) else None
            if h is not None and h not in self._cached:
                self._cached[h] = blk
                self._block_hash[blk] = h
                self._lru[blk] = None
            else:
                self._free.append(blk)
        self._lane_shared[lane] = []
        self._lane_blocks[lane] = []
        self.tables[lane, :] = self.trash_block
