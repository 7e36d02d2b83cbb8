"""Launch geometry of the two group-by kernels (csrc/limb_sums.cu,
csrc/fused_limb_sums.cu), computed on the host and passed to the kernels
as an argument, so that the CPU tests can check it.

Both kernels run one persistent grid of thread-block clusters over the
rows of a FAMILY of `segments` equal-length inputs (kernel A takes
S >= 1 of them in one launch; kernel B one). Their shared machinery
(csrc/group_table.cuh) reads the input in tiles of `tile_rows` rows: each
tile holds every slot plane's bytes for its rows, brought into a ring of
`stages` shared-memory buffers by 1-D bulk asynchronous copies (one per
slot and tile, completion on an mbarrier).

The work is a sequence of `units`: segment by segment, each segment's
tiles in groups of `unit_tiles` (one tile per CTA of a cluster; one tile
in the split mode below, which every CTA of the cluster reads). Cluster q
walks the contiguous range of units [q * units // clusters,
(q + 1) * units // clusters); at its step j, unit u = start + j is tile

    t = (u % seg_units) * unit_tiles (+ rank)   of segment u // seg_units

(`tile_of`), so every tile of every segment is read by exactly one CTA
(one cluster, in the split mode), once, and a cluster's table holds the
sums of one segment at a time: it is flushed into that segment's output
whenever the next unit belongs to another segment. Rows past the last
full tile of each segment (`tail_rows`, fewer than one tile plus 16
bytes' worth) are read from device memory directly and added into the
output by global atomics.

The per-group int32 counters live in shared memory in one of four modes:

  private  every CTA keeps the whole P x G table (it fits one CTA); at a
           flush the cluster sums its C tables through distributed shared
           memory in int64 and adds the sums to the output once, so the
           output sees 1/C of the additions of C lone blocks.
  split    the planes are split across the cluster's C CTAs: CTA r keeps
           planes [r * TP, (r + 1) * TP) of every group (TP = ceil(P / C)).
           Tile t goes to cluster q at step j when t = j * clusters + q;
           CTA 0 multicasts it into the ring of every CTA of the cluster,
           and each CTA adds its own planes of every row, all in its own
           shared memory. Each input byte is still read from device memory
           once; the filter and group ids are evaluated C times.
  shared   the table is split across the cluster's C CTAs by group range:
           group g lives in CTA g // TG at local group g % TG (TG =
           ceil(G / C)), for every plane, and a row's adds go to that CTA's
           table through distributed shared memory. Each CTA flushes its
           own part.
  global   beyond the cluster's capacity: one 64-bit global atomic per row
           and plane, straight into the output.

`plan` takes the first that fits: private, then split, then shared, then
global. A table is flushed (in int64) and re-zeroed after at most
`epoch_iters` loop steps, so the rows feeding one table between flushes
stay below FLUSH_ROWS and every int32 counter of 7-bit values stays exact.
The last flush adds contiguous ranges of int64 sums to the output with bulk
reductions, so the output must be 16-byte aligned with OUT_SLACK spare
int64s past its last counter (`output_len`). A family's output is S
consecutive (P, G) blocks. Segment s of each slot plane must start a
multiple of 16 bytes after segment 0 (the caller pads n to make it so),
so every segment shares segment 0's copy layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

THREADS = 1024
# the portable cluster size limit
MAX_CLUSTER = 8
# shared memory one CTA may use (232,448 bytes on an H100), less 3 KB left
# for the kernels' static shared memory (the slot table, and the fused
# kernel's scalar vector)
SMEM_MAX = 232_448 - 3072
MAX_SLOTS = 48
# an int32 counter of values <= 127 is exact for this many rows
FLUSH_ROWS = ((1 << 31) - 1) // 127
STAGE_TARGET_BYTES = 32 * 1024
# a stage may grow past the target up to this, to give every thread rows
MAX_STAGE_BYTES = 64 * 1024
# a thread reads 4 consecutive rows a step: 128 rows keep a warp's rows
# whole
ROWS_PER_STEP = 4
MIN_TILE_ROWS = 32 * ROWS_PER_STEP
MAX_TILE_ROWS = 16384
STAGES = (3, 2)
# the mbarriers at the start of shared memory, a "full" and an "empty" one
# per stage (csrc kMaxStages of each), then a junk word per lane
MAX_STAGES = 4
BARRIER_BYTES = 256
# the split mode halves its tiles down to this many rows to keep a ring of
# max(STAGES) stages beside its table
MIN_SPLIT_TILE_ROWS = 1024
# a CTA (a cluster, in the split mode) takes at least this many tiles, so
# small inputs do not spread thin
MIN_TILES_PER_CTA = 2
H100_SMS = 132
# int32 counters of at most this many groups see lanes of a warp collide:
# the kernels sum equal groups within the warp first
WARP_AGG_MAX_GROUPS = 128

MODES = {"global": 0, "private": 1, "shared": 2, "split": 3}
# int64s the output keeps past its P x G counters for the flush's padding
OUT_SLACK = 2

ActiveClusters = Callable[[int, int], int]


@dataclass(frozen=True)
class Geometry:
    n: int
    planes: int
    groups: int
    widths: tuple        # bytes per row of each slot plane
    mis: tuple           # each slot plane's address modulo 16
    tile_rows: int
    full_rows: int       # rows [0, full_rows) go through the tiles
    stages: int
    copy_bytes: tuple    # bytes of each slot's bulk copy per tile
    smem_off: tuple      # where each slot's copy lands within a stage
    stage_bytes: int
    mode: str
    cluster: int
    clusters: int
    iters: int           # the most loop steps of a cluster
    epoch_iters: int     # loop steps between flushes
    table_planes: int    # planes of one CTA's table
    table_groups: int    # groups of one CTA's table
    table_off: int
    ring_off: int
    smem_bytes: int
    warp_agg: bool
    segments: int = 1

    @property
    def tiles(self) -> int:
        """Whole tiles of one segment."""
        return self.full_rows // self.tile_rows

    @property
    def unit_tiles(self) -> int:
        return 1 if self.mode == "split" else self.cluster

    @property
    def seg_units(self) -> int:
        return -(-self.tiles // self.unit_tiles)

    @property
    def units(self) -> int:
        return self.segments * self.seg_units

    def unit_range(self, q: int) -> tuple:
        """The units [start, end) cluster q walks."""
        return (q * self.units // self.clusters,
                (q + 1) * self.units // self.clusters)

    @property
    def tail_rows(self) -> int:
        return self.n - self.full_rows

    @property
    def table_counters(self) -> int:
        return self.table_planes * self.table_groups

    @property
    def tx_bytes(self) -> int:
        return sum(self.copy_bytes)

    @property
    def row_off(self) -> tuple:
        """Where row 0 of each slot sits within a stage."""
        return tuple(o + m for o, m in zip(self.smem_off, self.mis))

    @property
    def vec_mask(self) -> int:
        """Bit s set when slot s's rows in a stage start on a multiple of 4
        rows, so the kernels read 4 rows of it with one vector load."""
        return sum(1 << s for s, (r, w)
                   in enumerate(zip(self.row_off, self.widths))
                   if r % (4 * w) == 0)

    @property
    def tg_inv(self) -> int:
        """ceil(2^32 / table_groups): the kernels find a group's CTA as
        (g * tg_inv) >> 32 == g // table_groups."""
        return -(-(1 << 32) // self.table_groups) if self.mode == "shared" else 0

    @property
    def ctas(self) -> int:
        return self.clusters * self.cluster

    def tile_of(self, j: int, q: int, rank: int):
        """(segment, tile) CTA `rank` of cluster `q` reads at loop step j,
        or None when it reads none then; the kernels use the same
        formula."""
        start, end = self.unit_range(q)
        u = start + j
        if u >= end:
            return None
        t = (u % self.seg_units) * self.unit_tiles
        if self.mode != "split":
            t += rank
        return (u // self.seg_units, t) if t < self.tiles else None

    def feeders(self) -> int:
        """CTAs whose rows add into one table."""
        return self.cluster if self.mode == "shared" else 1

    def rows_per_flush(self) -> int:
        """The most rows that feed one table between two flushes, counting
        the tail rows as if they did (they go to the output directly); 0
        without a table."""
        if self.mode == "global":
            return 0
        steps = min(self.epoch_iters, self.iters)
        return steps * self.feeders() * self.tile_rows + self.tail_rows

    def owner(self, p: int, g: int) -> tuple:
        """(rank, counter index in that CTA's table) of output counter
        (p, g): the CTA that holds it (shared, split) or flushes it
        (private)."""
        if self.mode == "shared":
            tg = self.table_groups
            return g // tg, p * tg + g % tg
        if self.mode == "split":
            tp = self.table_planes
            return p // tp, (p % tp) * self.groups + g
        if self.mode == "private":
            # the flush sums the table four counters (one int4) at a time
            i = p * self.groups + g
            per = -(-(-(-self.table_counters // 4)) // self.cluster)
            return (i // 4) // per, i
        raise ValueError("the global mode keeps no table")


def output_len(planes: int, groups: int) -> int:
    """int64s to allocate for a (planes, groups) output of the kernels."""
    return planes * groups + OUT_SLACK


def _align(x: int, a: int = 128) -> int:
    return -(-x // a) * a


def tile_rows_for(widths) -> int:
    """Rows of one tile: a power of two, about STAGE_TARGET_BYTES a stage,
    and at least one step of every thread where MAX_STAGE_BYTES allows."""
    row_bytes = max(1, sum(widths))
    rows = MIN_TILE_ROWS
    while rows < MAX_TILE_ROWS:
        bigger = 2 * rows * row_bytes
        if bigger > MAX_STAGE_BYTES or (bigger > STAGE_TARGET_BYTES
                                        and rows >= ROWS_PER_STEP * THREADS):
            break
        rows *= 2
    return rows


def full_rows_for(n: int, tile_rows: int, widths, mis) -> int:
    """The most whole tiles' rows whose 16-byte-aligned bulk copies end
    inside every slot plane: a copy never reads past row n - 1."""
    rows = tile_rows * (n // tile_rows)
    while rows > 0 and any(_align(m + rows * w, 16) > m + n * w
                           for w, m in zip(widths, mis)):
        rows -= tile_rows
    return rows


def _layout(widths, mis, tile_rows):
    """Per slot: the bulk copy's size (the tile's bytes, plus 16 when the
    plane is not 16-byte aligned: the copy starts at the aligned address
    below) and its offset in a stage."""
    copy, off, at = [], [], 0
    for w, m in zip(widths, mis):
        nbytes = tile_rows * w + (16 if m else 0)
        copy.append(nbytes)
        off.append(at)
        at += nbytes
    return tuple(copy), tuple(off), _align(at)


def _ideal_active(sms: int) -> ActiveClusters:
    return lambda cluster, smem: sms // cluster


def plan(n: int, planes: int, groups: int, widths, mis=None, *,
         segments: int = 1, sms: int = H100_SMS,
         active_clusters: Optional[ActiveClusters] = None) -> Geometry:
    """The geometry of one launch over `segments` inputs of n rows each,
    of `planes` sums into `groups` groups per segment, reading slot planes
    of the given byte widths whose addresses (segment 0's) are `mis` modulo
    16. `active_clusters(cluster, smem_bytes)` is how many such clusters
    the card holds at once (the CUDA occupancy query on the card;
    sms // cluster by default). Raises when no cluster of the chosen shape
    can be scheduled."""
    widths = tuple(int(w) for w in widths)
    mis = tuple(int(m) for m in (mis if mis is not None else (0,) * len(widths)))
    if not 0 < len(widths) <= MAX_SLOTS or len(mis) != len(widths):
        raise ValueError(f"geometry: {len(widths)} slot planes, at most {MAX_SLOTS}")
    if any(w not in (1, 2, 4) or m % w or not 0 <= m < 16
           for w, m in zip(widths, mis)):
        raise ValueError(f"geometry: widths {widths} / offsets {mis}")
    if n < 0 or planes < 1 or groups < 1 or segments < 1:
        raise ValueError(f"geometry: n={n} planes={planes} groups={groups} "
                         f"segments={segments}")
    active = active_clusters or _ideal_active(sms)

    def ring(tile_rows, counters):
        """(stages, smem bytes) of the deepest ring of tiles of `tile_rows`
        that fits beside a table of `counters`; stages 0 when none does."""
        stage_bytes = _layout(widths, mis, tile_rows)[2]
        for s in STAGES:
            smem = BARRIER_BYTES + _align(4 * counters) + s * stage_bytes
            if smem <= SMEM_MAX:
                return s, smem
        return 0, 0

    def tiles_of(tile_rows):
        return full_rows_for(n, tile_rows, widths, mis) // tile_rows

    def want(tile_rows):
        """CTAs (clusters, in the split mode) that get MIN_TILES_PER_CTA."""
        return max(1, -(-segments * tiles_of(tile_rows) // MIN_TILES_PER_CTA))

    tile_rows = tile_rows_for(widths)
    mode, cluster, table_planes, table_groups = "global", 1, 0, 0
    stages, smem = ring(tile_rows, 0)
    if ring(tile_rows, planes * groups)[0]:
        mode, table_planes, table_groups = "private", planes, groups
        stages, smem = ring(tile_rows, planes * groups)
        # the largest cluster (the fewest additions into the output at the
        # flush) that keeps at least 95% of the most CTAs any size keeps busy
        ctas = {}
        for c in (MAX_CLUSTER, 4, 2, 1):
            fit = active(c, smem)
            if fit > 0:
                ctas[c] = min(fit, -(-want(tile_rows) // c)) * c
        if ctas:  # else the check below raises
            most = max(ctas.values())
            cluster = max(c for c, k in ctas.items() if k >= 0.95 * most)
    else:
        # split by plane: the smallest cluster whose CTAs each hold their
        # planes beside a ring of max(STAGES) stages, halving the tiles
        for c in (2, 4, MAX_CLUSTER):
            tp = -(-planes // c)
            if -(-planes // tp) < c:
                continue  # a CTA would hold no plane
            rows = tile_rows
            while rows >= MIN_SPLIT_TILE_ROWS:
                s, sm = ring(rows, tp * groups)
                if s == max(STAGES):
                    break
                rows //= 2
            if rows >= MIN_SPLIT_TILE_ROWS and active(c, sm) > 0:
                mode, cluster, tile_rows = "split", c, rows
                table_planes, table_groups, stages, smem = tp, groups, s, sm
                break
        if mode == "global":
            # split by group: the smallest cluster whose CTAs hold the table
            # between them
            for c in (2, 4, MAX_CLUSTER):
                tg = -(-groups // c)
                s, sm = ring(tile_rows, planes * tg)
                if s:
                    mode, cluster, table_planes, table_groups = (
                        "shared", c, planes, tg)
                    stages, smem = s, sm
                    if active(c, sm) > 0:
                        break
    copy, off, stage_bytes = _layout(widths, mis, tile_rows)
    full = full_rows_for(n, tile_rows, widths, mis)
    tiles = full // tile_rows
    fit = active(cluster, smem)
    if fit <= 0:
        raise RuntimeError(
            f"geometry: no cluster of {cluster} CTAs with {smem} bytes of "
            "shared memory can be scheduled on this card")
    unit_tiles = 1 if mode == "split" else cluster
    units = segments * -(-tiles // unit_tiles)
    clusters = min(fit, want(tile_rows) if mode == "split"
                   else -(-want(tile_rows) // cluster), max(1, units))
    iters = -(-units // clusters)
    feeders = cluster if mode == "shared" else 1
    epoch_iters = max(1, (FLUSH_ROWS - (n - full)) // (feeders * tile_rows))
    counters = table_planes * table_groups
    return Geometry(
        n=n, planes=planes, groups=groups, widths=widths, mis=mis,
        tile_rows=tile_rows, full_rows=full, stages=stages, copy_bytes=copy,
        smem_off=off, stage_bytes=stage_bytes, mode=mode, cluster=cluster,
        clusters=clusters, iters=iters, epoch_iters=epoch_iters,
        table_planes=table_planes, table_groups=table_groups,
        table_off=BARRIER_BYTES, ring_off=BARRIER_BYTES + _align(4 * counters),
        smem_bytes=smem,
        warp_agg=(mode == "private" and groups <= WARP_AGG_MAX_GROUPS),
        segments=segments)
