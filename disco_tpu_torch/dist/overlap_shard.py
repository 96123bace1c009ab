"""The sharded overlap superstep over a mesh of shards (the counterpart of
disco_tpu/dist/overlap_shard.py).

It replaces the reference's two distribution modes:

- BuildGraphMPI (replicated index, partitioned reads, reference:
  src/BuildGraphMPI/src/OverlapGraph.cpp:294-295): the query axis is cut
  over the shards, the reads are replicated.
- BuildGraphMPIRMA (partitioned hash data and one-sided MPI_Get with
  software caches, reference: src/BuildGraphMPIRMA/src/HashTable.cpp:
  92-119, 648-708): the fingerprint table is sharded by key (owner = the
  unsigned key mod n), and each superstep routes query codes to their
  owner with one `all_to_all`; the answers come back the same way.
- The reference's asynchronous marked-bitmap gossip
  (BuildGraphMPI/src/OverlapGraph.cpp:204-290) becomes an `all_gather` a
  superstep.

disco_tpu runs the superstep under `jax.shard_map`; here the mesh
(dist/mesh.py) is a process's local shards, each piece between two
collectives is a function of one shard's tensors, and the collectives take
and return the list of the local shards' tensors (copies in one process,
`torch.distributed` calls across processes).  The engines walk the local
shards only, with their global ids where the table or payload layout
needs them.  Everything has a fixed
shape: queries are binned into per-peer blocks of `route_cap` slots
(overflow is counted, and dist.builder re-runs such a chunk exactly), hits
are capped at `hit_cap` a query.  Each shard's verification is K1's rows
route (the `fused_compare_dual_rows` wrapper: on a card, a compaction of
the grid's live lanes and a check that reads both rows by index, with no
host synchronisation; on the CPU its plain version).

Keys are uint64 on the host and int64 with the sign bit flipped on the
devices (`overlap.device.flip_keys`): torch has no uint64 `%` or
`searchsorted`.  So the table is sharded on the host in numpy; a query's
owner is its code mod n in unsigned arithmetic, the host's uint64 `%` for
host codes (`key_owner`) and, for codes made on a device, the mod taken
from the code's two 32-bit halves (`code_owner`).

Two front ends feed the superstep: `make_step` takes a chunk's host arrays
(qread, qj, qcode, marked), as disco_tpu's step does; `make_chunk_step`
makes each shard's windows, codes and owners on its device from the
reads' window offsets and the rows of the reads its slice touches
(`shard_windows`), so that no host array holds an entry a window.
`compact` then lists each shard's kept lanes on its device, and only
those leave it."""
from dataclasses import dataclass

import numpy as np
import torch

from ..index.table import FingerprintTable
from ..io.readstore import ReadStore
from ..overlap.device import (_M32, _SIGN64, _window_codes,
                              candidate_checks, candidate_checks_rows,
                              flip_keys, window_offsets)
from ..overlap.verify import as_words, make_packed_all
from ..utils.logging import count
from .mesh import Mesh, all_gather, all_to_all, gather_host

PAD_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)
_PAD_FLIPPED = int(flip_keys(np.array([PAD_KEY]))[0])   # the int64 maximum


def key_owner(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """The shard that owns each uint64 key (or query code): key mod n, in
    unsigned arithmetic, as int32."""
    return (np.asarray(keys, np.uint64) % np.uint64(n_shards)).astype(
        np.int32)


def code_owner(flipped: torch.Tensor, n_shards: int) -> torch.Tensor:
    """`key_owner` of sign-flipped int64 codes on their device: the uint64
    code u = hi * 2^32 + lo mod n as ((hi mod n) (2^32 mod n) + lo mod n)
    mod n, every term non-negative and under n^2 (int64 `%` of the flipped
    key would take the signed value's residue)."""
    u = flipped ^ _SIGN64
    hi, lo = (u >> 32) & _M32, u & _M32
    return ((hi % n_shards) * ((1 << 32) % n_shards) + lo % n_shards) \
        .remainder(n_shards).to(torch.int32)


def shard_windows(woff: np.ndarray, packed, a: int, b: int, lanes: int,
                  k: int, n_shards: int, device):
    """One shard's step inputs for the global windows [a, b), padded to
    `lanes`, made on `device`: (qread, qj) int32, the sign-flipped codes
    int64 and the owners int32 (`code_owner`); a pad lane has read 0, j -1
    and the pad key, as the host front end pads.  `woff` holds the reads'
    window offsets (`overlap.device.window_offsets`, int64, past 2^31); the
    host hands the device the offsets and packed rows of the reads
    [a, b) touches alone, O(reads) and not O(windows).  `packed` is the
    store's forward rows (any array that slices by read)."""
    w = torch.arange(a, a + lanes, dtype=torch.int64, device=device)
    real = w < b
    if b > a:
        r0, r1 = (int(r) for r in np.searchsorted(woff, [a, b - 1],
                                                  side="right") - 1)
        offs = torch.from_numpy(np.ascontiguousarray(
            woff[r0:r1 + 2], np.int64)).to(device)
        rows = as_words(packed[r0:r1 + 1], device)
        w = w.clamp_max(b - 1)
        li = torch.searchsorted(offs, w, right=True) - 1
        qj = w - offs[li]
        code = _window_codes(rows, li, qj, k)
        qread = li + r0
    else:                      # a slice past the set's last window
        qread = qj = code = torch.zeros_like(w)
    qread = torch.where(real, qread, 0).to(torch.int32)
    qj = torch.where(real, qj, -1).to(torch.int32)
    code = torch.where(real, code, _PAD_FLIPPED)
    return qread, qj, code, code_owner(code, n_shards)


class _Scatter:
    """Scatter of kept rows to their rank in a zeroed (out_cap,) vector,
    dropping ranks >= out_cap (XLA's mode="drop").  Dropped rows land in
    one extra slot that is cut off, so no count is read back to the
    host."""

    def __init__(self, keep, out_cap):
        pos = torch.cumsum(keep, 0) - 1
        self.idx = torch.where(keep & (pos < out_cap), pos, out_cap)
        self.out_cap = out_cap

    def __call__(self, vals, dtype=torch.int64):
        out = torch.zeros(self.out_cap + 1, dtype=dtype,
                          device=self.idx.device)
        out.scatter_(0, self.idx, vals.to(dtype))
        return out[:self.out_cap]


def compact(qread, qj, out):
    """Each local shard's kept lanes of a step (`edge_ok | cont_ok`) in
    lane order, window then slot, listed on its device: rows (lanes, 4)
    int32 [r1, j, r2, orient | typ << 2 | edge_ok << 3 | cont_ok << 4],
    the first `count` of them live, and meta (2,) int64 [count, the
    shard's overflow].  `qread`, `qj` are the step's per-shard inputs, `out`
    its outputs.  No count is read back: the caller reads every shard's
    meta at once, then only the live rows leave the device."""
    rows, metas = [], []
    for d, (r2, orient, typ, edge_ok, cont_ok) in enumerate(zip(*out[:5])):
        h = r2.shape[1]
        keep = (edge_ok | cont_ok).reshape(-1)
        code = (orient | (typ << 2) | (edge_ok.to(torch.int32) << 3)
                | (cont_ok.to(torch.int32) << 4)).reshape(-1)
        scat = _Scatter(keep, keep.shape[0])
        rows.append(torch.stack([
            scat(qread[d][:, None].expand(-1, h).reshape(-1), torch.int32),
            scat(qj[d][:, None].expand(-1, h).reshape(-1), torch.int32),
            scat(r2.reshape(-1), torch.int32),
            scat(code, torch.int32)], 1))
        metas.append(torch.stack([keep.sum(), out[5][d].reshape(()).to(
            torch.int64)]))
    return rows, metas


def _exchange(mesh: Mesh, xs, counter: str):
    """`all_to_all` of the local shards' tensors `xs`, their bytes as sent
    (each whole tensor, its padded slots included) added to the recorder's
    counter `counter`: from their shapes, so nothing is read from a
    device."""
    count(counter, sum(x.numel() * x.element_size() for x in xs))
    return all_to_all(mesh, xs)


def _bin_by_owner(owner, n_bins, cap):
    """Scatter indices [0, Q) into an (n_bins, cap) slot matrix by owner id.
    Entries with owner >= n_bins are skipped (callers use owner = n_bins as
    a "route nowhere" sentinel).  Returns (slots int32, -1 padding;
    overflow, the real entries that did not fit their bin)."""
    q = owner.shape[0]
    dev = owner.device
    owner = owner.to(torch.int32).clamp_max(n_bins)
    sowner, order = torch.sort(owner, stable=True)
    start = torch.searchsorted(
        sowner, torch.arange(n_bins, dtype=torch.int32, device=dev))
    in_range = sowner < n_bins
    rank = torch.arange(q, device=dev) - start[sowner.clamp_max(n_bins - 1)]
    valid = (rank < cap) & in_range
    # entries that do not fit land in one extra slot, cut off below
    # (XLA's mode="drop")
    idx = torch.where(valid, sowner.to(torch.int64) * cap + rank,
                      n_bins * cap)
    slots = torch.full((n_bins * cap + 1,), -1, dtype=torch.int32,
                       device=dev)
    slots.scatter_(0, idx, order.to(torch.int32))
    overflow = in_range.sum() - valid.sum()
    return slots[:-1].view(n_bins, cap), overflow


def _scatter_rows(slots, n_rows, vals):
    """vals (n * cap, ...) back to the rows that `slots` routed them from;
    unused slots go to one extra row, cut off (XLA's mode="drop")."""
    flat = slots.reshape(-1).to(torch.int64)
    src = torch.where(flat >= 0, flat, n_rows)
    out = vals.new_zeros((n_rows + 1, *vals.shape[1:]))
    out[src] = vals
    return out[:n_rows]


def gather(mesh: Mesh, out):
    """A step's per-shard outputs as disco_tpu's global arrays, on the
    host (`mesh.gather_host`): the (Q, H) grids r2, orient, typ, edge_ok,
    cont_ok, the overflows (n_shards,) and the marked unions (n_shards,
    N)."""
    return tuple(gather_host(mesh, x) for x in out)


@dataclass
class ShardedOverlapEngine:
    """Device-sharded candidate lookup and verification.

    The host shards the sorted fingerprint table by key owner (key mod
    n_shards) and pads the shards to equal length; the superstep does bin
    -> all_to_all -> local searchsorted -> all_to_all -> verify."""
    mesh: Mesh
    n_words: int
    k: int
    hit_cap: int
    route_cap: int
    keys: np.ndarray    # (n_shards, M_pad) uint64, each row sorted
    read: np.ndarray    # (n_shards, M_pad) int32
    orient: np.ndarray  # (n_shards, M_pad) int32
    typ: np.ndarray     # (n_shards, M_pad) int32
    sizes: np.ndarray   # (n_shards,) int32: real (unpadded) entry counts
    # prune candidates touching marked (contained) reads with the gathered
    # mask: Disco's superReadID == 0 work pruning (reference:
    # src/BuildGraph/src/OverlapGraph.cpp:435-436); safe with stale marks
    # (pruning lags, never wrong), see dist.builder
    prune_marked: bool = False

    @classmethod
    def build(cls, store: ReadStore, table: FingerprintTable, mesh: Mesh,
              hit_cap: int = 8, route_cap: int = 4096,
              prune_marked: bool = False) -> "ShardedOverlapEngine":
        n_shards = mesh.size
        owner = key_owner(table.keys, n_shards)
        m_pad = max(int(np.bincount(owner, minlength=n_shards).max()), 1)
        keys = np.full((n_shards, m_pad), PAD_KEY)
        read = np.zeros((n_shards, m_pad), np.int32)
        orient = np.zeros((n_shards, m_pad), np.int32)
        typ = np.zeros((n_shards, m_pad), np.int32)
        sizes = np.zeros(n_shards, np.int32)
        for s in range(n_shards):
            sel = owner == s
            m = int(sel.sum())
            keys[s, :m] = table.keys[sel]   # globally sorted => row sorted
            read[s, :m] = table.read[sel]
            orient[s, :m] = table.orient[sel]
            typ[s, :m] = table.typ[sel]
            sizes[s] = m
        return cls(mesh=mesh, n_words=store.n_words, k=table.k,
                   hit_cap=hit_cap, route_cap=route_cap, keys=keys,
                   read=read, orient=orient, typ=typ, sizes=sizes,
                   prune_marked=prune_marked)

    # ------------------------------------------------------------------
    def _table_shards(self):
        """Each local shard's (keys flipped int64, read, orient, typ, size)
        on its device."""
        def dev(x, d):
            return torch.from_numpy(np.ascontiguousarray(x)).to(d)

        return [(dev(flip_keys(self.keys[s]), d), dev(self.read[s], d),
                 dev(self.orient[s], d), dev(self.typ[s], d),
                 int(self.sizes[s]))
                for s, d in zip(self.mesh.shards, self.mesh.devices)]

    def _inputs(self, qread, qj, qcode, marked):
        """Host chunk arrays -> per-shard tensors: qread, qj (int32), the
        flipped codes (int64) and owners (int32, from the uint64 codes),
        and the marked blocks."""
        m = self.mesh
        return (m.split(np.ascontiguousarray(qread, np.int32)),
                m.split(np.ascontiguousarray(qj, np.int32)),
                m.split(flip_keys(qcode)),
                m.split(key_owner(qcode, m.size)),
                m.split(np.ascontiguousarray(marked, np.int32)))

    def _route(self, qj, qcode, qowner):
        """Per shard: bin the queries by their code's owner; pad windows
        (qj < 0, the chunk-tail filler) route nowhere, or they would all
        share the pad code's owner and flood one peer's slots."""
        n = self.mesh.size
        owner = torch.where(qj < 0, n, qowner)
        slots, overflow = _bin_by_owner(owner, n, self.route_cap)
        slot_valid = slots >= 0
        codes_out = torch.where(
            slot_valid, qcode[slots.clamp_min(0).to(torch.int64)], _SIGN64)
        return slots, overflow, codes_out, slot_valid

    def _lookup(self, codes_in, valid_in, shard):
        """Per shard: the local table lookup, clamped to the shard's real
        entry count: the pad entries share the key 0xFF..FF (the int64
        maximum once flipped), which a genuine poly-T window can hash to,
        so an unclamped hi would sweep the pad run into its bucket."""
        lkeys, lread, lorient, ltyp, lsize = shard
        flat = codes_in.reshape(-1)
        lo = torch.searchsorted(lkeys, flat).clamp_max(lsize)
        hi = torch.searchsorted(lkeys, flat, right=True).clamp_max(lsize)
        tpos = lo[:, None] + torch.arange(self.hit_cap, device=lo.device)
        hit_valid = (tpos < hi[:, None]) & valid_in.reshape(-1)[:, None]
        overflow = ((hi - lo) > self.hit_cap).sum()
        tpos = tpos.clamp(0, lkeys.shape[0] - 1)

        def take(col):
            return torch.where(hit_valid, col[tpos], 0).to(torch.int32)

        return take(lread), take(lorient), take(ltyp), hit_valid, overflow

    def _candidates(self, qread, qj, qcode, qowner, marked, shards):
        """Steps 1-5 of the superstep, over the local shards: the marked
        union, the route out, the lookup, the answers back, and their
        scatter to the query rows, pruned by the union.  Returns per local
        shard (r2, orient, typ, valid, overflow) and the unions."""
        mesh = self.mesh
        # 1. union of the marked bitmaps (replaces the async gossip)
        unions = all_gather(mesh, marked)
        # 2. route query codes to their owner shards
        routed = [self._route(j, c, o) for j, c, o in zip(qj, qcode, qowner)]
        codes_in = _exchange(mesh, [r[2] for r in routed],
                             "dist.route_bytes")
        valid_in = _exchange(mesh, [r[3] for r in routed],
                             "dist.route_bytes")
        # 3. local table lookup
        hits = [self._lookup(c, v, sh)
                for c, v, sh in zip(codes_in, valid_in, shards)]
        # 4. answers ride back to the querying shard
        back = [_exchange(mesh, [h[i] for h in hits], "dist.route_bytes")
                for i in range(4)]
        out = []
        for d in range(len(routed)):
            slots, overflow = routed[d][0], routed[d][1] + hits[d][4]
            # 5. scatter answers back to the query rows (the slot matrix is
            #    the routing permutation)
            q_local = qread[d].shape[0]
            r2, orient, typ, valid = (_scatter_rows(slots, q_local, b[d])
                                      for b in back)
            if self.prune_marked:
                u = unions[d]
                valid &= (u[qread[d].to(torch.int64)] == 0)[:, None]
                valid &= u[r2.to(torch.int64)] == 0
            out.append((r2, orient, typ, valid, overflow))
        return out, unions

    def _superstep(self, packed_all, lengths, qread, qj, qcode, qowner,
                   marked, shards):
        """The replicated-payload superstep over the local shards (their
        inputs as lists).  Per-shard outputs: hit grids (Qs, H), overflow
        (1,), marked union (1, N)."""
        cands, unions = self._candidates(qread, qj, qcode, qowner, marked,
                                         shards)
        h = self.hit_cap
        outs = []
        for d, (r2, orient, typ, valid, overflow) in enumerate(cands):
            # 6. verify locally (shared geometry, reference:
            #    src/BuildGraph/src/OverlapGraph.cpp:517-595)
            edge_ok, cont_ok = candidate_checks(
                packed_all[d], lengths[d], qread[d].repeat_interleave(h),
                qj[d].repeat_interleave(h), r2.reshape(-1),
                orient.reshape(-1), valid.reshape(-1), k=self.k)
            outs.append((r2, orient, typ, edge_ok.view_as(r2),
                         cont_ok.view_as(r2), overflow[None],
                         unions[d][None, :]))
        return tuple(list(x) for x in zip(*outs))

    def _runner(self, store: ReadStore, q_chunk: int):
        """run(qread, qj, qcode, qowner, marked), each a list over the local
        shards, -> the step's per-shard outputs.  The packed rows and
        lengths are held once per distinct device, the table shards by
        their shards."""
        shards = self._table_shards()
        packed_all = self.mesh.replicate(
            make_packed_all(store.packed, store.packed_rc))
        lengths = self.mesh.replicate(
            np.ascontiguousarray(store.lengths, np.int32))

        def run(*inputs):
            return self._superstep(packed_all, lengths, *inputs, shards)
        return run

    def make_step(self, store: ReadStore):
        """Returns step(qread, qj, qcode, marked) over host arrays (qcode
        uint64; marked padded to a multiple of the shard count): the
        per-shard outputs (r2, orient, typ, edge_ok, cont_ok, overflow,
        marked union), each a list over the shards (`gather` makes them
        disco_tpu's global arrays)."""
        run = self._runner(store, None)

        def step(qread, qj, qcode, marked):
            return run(*self._inputs(qread, qj, qcode, marked))
        return step

    def make_chunk_step(self, store: ReadStore, q_chunk: int):
        """The step over global window ranges of the store: returns
        (windows, run).  windows(s, e) makes each local shard's inputs for
        the windows [s, e) of chunks of `q_chunk` (shard g takes
        [s + g * q_chunk / n, ...)) on its device (`shard_windows`): what
        `make_step` receives from `window_codes` slices.  run(inputs,
        marked) takes them and the host's marked array and gives
        `make_step`'s outputs."""
        mesh = self.mesh
        lanes = q_chunk // mesh.size
        woff = window_offsets(store.lengths, self.k)
        run = self._runner(store, q_chunk)

        def windows(s, e):
            per_shard = [shard_windows(woff, store.packed, s + g * lanes,
                                       min(s + (g + 1) * lanes, e), lanes,
                                       self.k, mesh.size, d)
                         for g, d in zip(mesh.shards, mesh.devices)]
            return tuple(list(x) for x in zip(*per_shard))

        def run_chunk(inputs, marked):
            return run(*inputs, mesh.split(np.ascontiguousarray(marked,
                                                                np.int32)))
        return windows, run_chunk


def fetch_cap_for(q_chunk: int, n_shards: int, hit_cap: int) -> int:
    """The default fetch-slot capacity a peer pair: the ids of a shard's
    slice spread about uniformly under round-robin ownership; 2x headroom,
    rounded up to 8."""
    ids = (q_chunk // n_shards) * (1 + hit_cap)
    return -(-(2 * ids) // (8 * n_shards)) * 8


# ---------------------------------------------------------------------------
# Dist-mem mode: read payload partitioned across the mesh
# ---------------------------------------------------------------------------
@dataclass
class DistMemOverlapEngine(ShardedOverlapEngine):
    """The BuildGraphMPIRMA equivalent with a partitioned read store.

    Disco's RMA mode partitions the hash DATA table, which holds the packed
    read sequences, across ranks and fetches remote reads on demand with
    MPI_Get and software caches (reference:
    src/BuildGraphMPIRMA/src/HashTable.cpp:92-119,422-435,648-708).  Here
    the packed payload (forward and rc rows) is sharded round-robin by read
    id (owner = read % n_shards; round-robin because a superstep's query
    slice covers a contiguous read range, which blocked ownership would send
    to one owner), and each superstep fetches the rows it needs with one
    all_to_all pair.

    Held per shard: its table shard and its payload block; per distinct
    device: the read lengths.  Device memory is O(N/n) payload a shard plus
    O(chunk * hit_cap) superstep state."""

    @staticmethod
    def payload_block(store: ReadStore, shard: int, n_shards: int):
        """Shard `shard`'s payload, (2 * block, Wp) uint32: the forward rows
        of the reads {r : r % n_shards == shard} in read order, zero-padded
        to `block` = ceil(N / n_shards) rows, over their rc rows."""
        block = -(-store.n_reads // n_shards)
        out = np.zeros((2 * block, store.packed.shape[1]), np.uint32)
        own = store.packed[shard::n_shards]
        out[:len(own)] = own
        out[block:block + len(own)] = store.packed_rc[shard::n_shards]
        return out

    @classmethod
    def shard_payload(cls, store: ReadStore, n_shards: int):
        """Host payload layout: reads permuted so that shard s's contiguous
        block holds exactly the reads {r : r % n_shards == s}, padded to
        n_shards * block rows.  Returns (packed_sh, packed_rc_sh, block)."""
        block = -(-store.n_reads // n_shards)
        blocks = [cls.payload_block(store, s, n_shards)
                  for s in range(n_shards)]
        return (np.concatenate([b[:block] for b in blocks]),
                np.concatenate([b[block:] for b in blocks]), block)

    # ------------------------------------------------------------------
    def _fetch_rows(self, row_ids, payload, n_reads, block, fetch_cap):
        """Exchange-fetch packed rows by global row id in [0, 2N) for the
        local shards: ids [0, N) are forward rows, [N, 2N) rc rows, id < 0
        none; read r is owned by shard r % n_shards, whose payload holds
        its forward rows then its rc rows (2 * block, Wp); each peer pair
        has `fetch_cap` request slots.  Returns per local shard ((R, Wp)
        rows, overflow)."""
        mesh = self.mesh
        n = mesh.size
        routed = []
        for ids in row_ids:
            ids = ids.to(torch.int64)
            rid = ids.abs() % n_reads
            owner = torch.where(ids < 0, n, rid % n)
            slots, overflow = _bin_by_owner(owner, n, fetch_cap)
            req = torch.where(slots >= 0,
                              ids[slots.clamp_min(0).to(torch.int64)], 0)
            routed.append((slots, overflow, req.to(torch.int32)))
        req_in = _exchange(mesh, [r[2] for r in routed], "dist.fetch_bytes")
        # owner-local gather
        rows = []
        for req, pay in zip(req_in, payload):
            local = ((req % n_reads) // n).clamp(0, block - 1)
            rows.append(pay[(local + block * (req >= n_reads)).to(
                torch.int64)])
        rows_back = _exchange(mesh, rows, "dist.fetch_bytes")
        wp = payload[0].shape[-1]
        # scatter the replies to request order
        return [(_scatter_rows(slots, ids.shape[0], back.reshape(-1, wp)),
                 overflow)
                for (slots, overflow, _), ids, back in zip(routed, row_ids,
                                                           rows_back)]

    def _superstep_dm(self, payload, lengths, qread, qj, qcode, qowner,
                      marked, shards, n_reads, block, fetch_cap):
        """The dist-mem superstep: the key-owner lookup of the base engine,
        the payload row fetch, and the local check over fetched rows."""
        cands, unions = self._candidates(qread, qj, qcode, qowner, marked,
                                         shards)
        # the fetch ids: read1's forward row and each valid candidate's
        # forward or rc row; candidates pruned by the union cost no
        # exchange either
        ids = []
        for d, (r2, orient, _, valid, _) in enumerate(cands):
            rows2_id = torch.where(orient >= 2, r2 + n_reads, r2)
            rows2_id = torch.where(valid, rows2_id, -1)
            q_ids = torch.where(qj[d] < 0, -1, qread[d])      # pads: none
            if self.prune_marked:
                q_ids = torch.where(
                    unions[d][qread[d].to(torch.int64)] == 0, q_ids, -1)
            ids.append(torch.cat([q_ids, rows2_id.reshape(-1)]))
        fetched = self._fetch_rows(ids, payload, n_reads, block,
                                   fetch_cap)
        outs = []
        for d, (r2, orient, typ, valid, overflow) in enumerate(cands):
            rows, f_overflow = fetched[d]
            q_local = r2.shape[0]
            edge_ok, cont_ok = candidate_checks_rows(
                rows[:q_local], rows[q_local:].view(q_local, self.hit_cap, -1),
                lengths[d], qread[d], qj[d], r2, orient, valid, k=self.k)
            outs.append((r2, orient, typ, edge_ok, cont_ok,
                         (overflow + f_overflow)[None], unions[d][None, :]))
        return tuple(list(x) for x in zip(*outs))

    def _runner(self, store: ReadStore, q_chunk: int):
        """The dist-mem superstep over the local shards' inputs (the base
        engine's `_runner`) for chunks of `q_chunk` windows.  Shard s holds
        only its block of the payload, forward rows over rc rows."""
        n = self.mesh.size
        block = -(-store.n_reads // n)
        fetch_cap = fetch_cap_for(q_chunk, n, self.hit_cap)
        payload = [as_words(self.payload_block(store, s, n), d)
                   for s, d in zip(self.mesh.shards, self.mesh.devices)]
        shards = self._table_shards()
        lengths = self.mesh.replicate(
            np.ascontiguousarray(store.lengths, np.int32))

        def run(*inputs):
            return self._superstep_dm(payload, lengths, *inputs, shards,
                                      store.n_reads, block, fetch_cap)
        return run

    def make_step(self, store: ReadStore, q_chunk: int):
        """Returns (step, payload): `payload` = (packed_sh, packed_rc_sh),
        the host layout of `shard_payload`; step(qread, qj, qcode, marked)
        over chunks of `q_chunk` windows gives the base engine's outputs."""
        run = self._runner(store, q_chunk)

        def step(qread, qj, qcode, marked):
            return run(*self._inputs(qread, qj, qcode, marked))
        return step, self.shard_payload(store, self.mesh.size)[:2]
