"""Pure-Python LMDB (Lightning Memory-Mapped Database) file access (the
port's own copy of ``dali_tpu/_lmdb.py``).

The reference reads Caffe/Caffe2 datasets through liblmdb
(``dali/operators/reader/loader/lmdb.h:23`` LMDB wrapper; readers
``reader/caffe_reader_op.cc``, ``reader/caffe2_reader_op.cc``). The port links
no liblmdb: the format is simple enough that shipping a read-only parser
beats a hard dependency: an LMDB environment is a copy-on-write B+tree inside a
single memory-mapped file, so reading is mmap + pointer walking — a good match
for the host side of an input pipeline (zero-copy payload slices out of the
map).

Layout facts used here (64-bit, little-endian, the only variant in practice):

* pages 0 and 1 are meta pages; the live one has the larger ``mm_txnid``
* ``MDB_meta``: magic ``0xBEEFC0DE``, version 1, two ``MDB_db`` records
  (FREE_DBI and MAIN_DBI); the page size hides in ``mm_dbs[0].md_pad``
* page header (16 bytes): pgno u64, pad u16, flags u16, lower u16, upper u16
  (overflow pages reuse lower+upper as a u32 page count)
* node: lo u16, hi u16, flags u16, ksize u16, key bytes, data —
  leaf data size = lo | hi<<16; branch child pgno = lo | hi<<16 | flags<<32
* node flag ``F_BIGDATA`` (0x01): leaf data is a u64 pgno of an overflow chain
  (one header on the first page, payload contiguous across the chain)

Also includes a minimal writer (sorted input, fresh file) — enough to create
datasets/fixtures without liblmdb; the files it produces are valid LMDB
environments readable by the real library.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterable, List, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
F_BIGDATA = 0x01

_PAGEHDR = 16
_DB = struct.Struct("<IHHQQQQQ")  # md_pad, md_flags, md_depth, branch, leaf, ovf, entries, root
_META_HEAD = struct.Struct("<IIQQ")  # magic, version, address, mapsize


class LmdbFile:
    """Read-only LMDB environment (main DB only, default comparator)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = open(path, "rb")
        self._map = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        (self.psize, _, _, _, _, _, _, _) = _DB.unpack_from(meta, _META_HEAD.size)
        (_, _, self.depth, _, _, _, self.entries, self.root) = _DB.unpack_from(
            meta, _META_HEAD.size + _DB.size
        )

    def _pick_meta(self) -> bytes:
        best = None
        best_txn = -1
        for pg in (0, 1):
            # try both common page sizes for the second meta page
            for psize in (4096, 8192, 16384, 32768, 65536):
                off = pg * psize + _PAGEHDR
                if off + 128 > len(self._map):
                    continue
                magic, version, _, _ = _META_HEAD.unpack_from(self._map, off)
                if magic != MDB_MAGIC or version != MDB_VERSION:
                    continue
                real_psize = _DB.unpack_from(self._map, off + _META_HEAD.size)[0]
                if pg == 1 and psize != real_psize:
                    continue
                txnid = struct.unpack_from("<Q", self._map, off + _META_HEAD.size + 2 * _DB.size + 8)[0]
                if txnid > best_txn:
                    best_txn = txnid
                    best = bytes(self._map[off : off + _META_HEAD.size + 2 * _DB.size + 16])
                break
        if best is None:
            raise ValueError(f"{self.path}: not an LMDB file (no valid meta page)")
        return best

    # -- page access ------------------------------------------------------------------
    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _page_flags(self, pgno: int) -> int:
        return struct.unpack_from("<H", self._map, self._page(pgno) + 10)[0]

    def _numkeys(self, pgno: int) -> int:
        lower = struct.unpack_from("<H", self._map, self._page(pgno) + 12)[0]
        if lower < _PAGEHDR or lower > self.psize:
            raise ValueError(f"{self.path}: corrupt LMDB page {pgno} (bad bounds)")
        return (lower - _PAGEHDR) // 2

    def _node_off(self, pgno: int, i: int) -> int:
        base = self._page(pgno)
        ptr = struct.unpack_from("<H", self._map, base + _PAGEHDR + 2 * i)[0]
        return base + ptr

    def _node(self, pgno: int, i: int):
        off = self._node_off(pgno, i)
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._map, off)
        key = bytes(self._map[off + 8 : off + 8 + ksize])
        return lo, hi, flags, ksize, key, off

    def _leaf_value(self, pgno: int, i: int) -> bytes:
        lo, hi, flags, ksize, _, off = self._node(pgno, i)
        dsize = lo | (hi << 16)
        data_off = off + 8 + ksize
        if flags & F_BIGDATA:
            (ovf,) = struct.unpack_from("<Q", self._map, data_off)
            start = self._page(ovf) + _PAGEHDR
            return bytes(self._map[start : start + dsize])
        return bytes(self._map[data_off : data_off + dsize])

    def _child_pgno(self, pgno: int, i: int) -> int:
        lo, hi, flags, _, _, _ = self._node(pgno, i)
        return lo | (hi << 16) | (flags << 32)

    # -- public API --------------------------------------------------------------------
    def keys(self) -> List[bytes]:
        """All keys in order (one full tree walk)."""
        out: List[bytes] = []
        if self.root == P_INVALID:
            return out
        # visited-page guard: a corrupted tree with a page cycle (or a branch
        # pointing back up) must raise, not walk forever
        max_pages = len(self._map) // self.psize + 1
        seen = set()
        stack = [self.root]
        while stack:
            pg = stack.pop()
            if pg in seen:
                raise ValueError(f"{self.path}: corrupt LMDB B+tree (page cycle at {pg})")
            seen.add(pg)
            if len(seen) > max_pages:
                raise ValueError(f"{self.path}: corrupt LMDB B+tree (page count overflow)")
            fl = self._page_flags(pg)
            n = self._numkeys(pg)
            if fl & P_BRANCH:
                stack.extend(self._child_pgno(pg, i) for i in range(n - 1, -1, -1))
            elif fl & P_LEAF:
                out.extend(self._node(pg, i)[4] for i in range(n))
        return out

    def get(self, key: bytes) -> bytes:
        """Value for ``key`` (binary search down the B+tree, memcmp order)."""
        if self.root == P_INVALID:
            raise KeyError(key)
        pg = self.root
        depth = 0
        while self._page_flags(pg) & P_BRANCH:
            depth += 1
            if depth > 64:  # LMDB trees are <=32 deep; a cycle would loop forever
                raise ValueError(f"{self.path}: corrupt LMDB B+tree (descent cycle)")
            n = self._numkeys(pg)
            lo_i, hi_i = 1, n  # node 0 is the leftmost child (empty key)
            while lo_i < hi_i:
                mid = (lo_i + hi_i) // 2
                if self._node(pg, mid)[4] <= key:
                    lo_i = mid + 1
                else:
                    hi_i = mid
            pg = self._child_pgno(pg, lo_i - 1)
        n = self._numkeys(pg)
        lo_i, hi_i = 0, n
        while lo_i < hi_i:
            mid = (lo_i + hi_i) // 2
            k = self._node(pg, mid)[4]
            if k == key:
                return self._leaf_value(pg, mid)
            if k < key:
                lo_i = mid + 1
            else:
                hi_i = mid
        raise KeyError(key)

    def items(self):
        for k in self.keys():
            yield k, self.get(k)

    def close(self):
        self._map.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_lmdb(path: str, items: Iterable[Tuple[bytes, bytes]], psize: int = 4096):
    """Write a fresh single-transaction LMDB environment containing ``items``
    (sorted by key internally). Produces the ``data.mdb`` layout liblmdb
    creates: meta pages 0/1, leaf pages, one branch level if needed, overflow
    chains for large values."""
    items = sorted(((bytes(k), bytes(v)) for k, v in items), key=lambda kv: kv[0])
    for k, _ in items:
        if len(k) > 511:
            raise ValueError("LMDB keys are limited to 511 bytes")
    pages: List[bytearray] = [bytearray(psize), bytearray(psize)]  # metas, filled last

    def new_page() -> int:
        pages.append(bytearray(psize))
        return len(pages) - 1

    def page_header(pgno, flags, lower, upper, ovf_pages=None):
        p = pages[pgno]
        struct.pack_into("<Q", p, 0, pgno)
        struct.pack_into("<HH", p, 8, 0, flags)
        if ovf_pages is not None:
            struct.pack_into("<I", p, 12, ovf_pages)
        else:
            struct.pack_into("<HH", p, 12, lower, upper)

    max_inline = (psize - _PAGEHDR) // 2 - 8  # conservative BIGDATA threshold
    n_overflow = 0

    # 1. pack leaves
    leaves: List[Tuple[int, bytes]] = []  # (pgno, first_key)
    cur: List[Tuple[bytes, bytes, bool, int]] = []  # key, data-or-pgno, big, dsize
    cur_bytes = _PAGEHDR

    def node_size(k, d):
        return 2 + 8 + len(k) + len(d)  # ptr slot + header + key + data

    def flush_leaf():
        nonlocal cur, cur_bytes
        if not cur:
            return
        pg = new_page()
        n = len(cur)
        lower = _PAGEHDR + 2 * n
        upper = psize
        for i, (k, d, big, dsize) in enumerate(cur):
            nsz = 8 + len(k) + len(d)
            upper -= nsz
            struct.pack_into("<H", pages[pg], _PAGEHDR + 2 * i, upper)
            struct.pack_into(
                "<HHHH", pages[pg], upper, dsize & 0xFFFF, (dsize >> 16) & 0xFFFF,
                F_BIGDATA if big else 0, len(k)
            )
            pages[pg][upper + 8 : upper + 8 + len(k)] = k
            pages[pg][upper + 8 + len(k) : upper + 8 + len(k) + len(d)] = d
        page_header(pg, P_LEAF, lower, upper)
        leaves.append((pg, cur[0][0]))
        cur, cur_bytes = [], _PAGEHDR

    for k, v in items:
        if len(v) > max_inline:
            n_ovf = -(-(len(v) + _PAGEHDR) // psize)
            start = new_page()
            page_header(start, P_OVERFLOW, 0, 0, ovf_pages=n_ovf)
            remaining = memoryview(v)
            first = min(len(v), psize - _PAGEHDR)
            pages[start][_PAGEHDR : _PAGEHDR + first] = remaining[:first]
            remaining = remaining[first:]
            while len(remaining):
                pg = new_page()
                chunk = min(len(remaining), psize)
                pages[pg][:chunk] = remaining[:chunk]
                remaining = remaining[chunk:]
            n_overflow += n_ovf
            entry = (k, struct.pack("<Q", start), True, len(v))
        else:
            entry = (k, v, False, len(v))
        sz = node_size(k, entry[1])
        if cur and cur_bytes + sz > psize:
            flush_leaf()
        cur.append(entry)
        cur_bytes += sz
    flush_leaf()

    # 2. branch root if more than one leaf
    if not leaves:
        root, depth = P_INVALID, 0
        n_branch = 0
    elif len(leaves) == 1:
        root, depth = leaves[0][0], 1
        n_branch = 0
    else:
        root = new_page()
        n = len(leaves)
        lower = _PAGEHDR + 2 * n
        upper = psize
        need = lower + sum(8 + (0 if i == 0 else len(k)) for i, (_, k) in enumerate(leaves))
        if need > psize:
            raise ValueError(
                f"write_lmdb: {n} leaf pages exceed one branch page "
                "(single-level tree writer); split the dataset or raise psize"
            )
        for i, (pg, first_key) in enumerate(leaves):
            k = b"" if i == 0 else first_key  # node 0: leftmost child, empty key
            nsz = 8 + len(k)
            upper -= nsz
            struct.pack_into("<H", pages[root], _PAGEHDR + 2 * i, upper)
            struct.pack_into(
                "<HHHH", pages[root], upper, pg & 0xFFFF, (pg >> 16) & 0xFFFF,
                (pg >> 32) & 0xFFFF, len(k)
            )
            pages[root][upper + 8 : upper + 8 + len(k)] = k
        page_header(root, P_BRANCH, lower, upper)
        depth, n_branch = 2, 1

    # 3. meta pages (both get txnid 1 / 0 so page 0 is live)
    for pg, txn in ((0, 1), (1, 0)):
        page_header(pg, P_META, 0, 0)
        off = _PAGEHDR
        _META_HEAD.pack_into(pages[pg], off, MDB_MAGIC, MDB_VERSION, 0, len(pages) * psize)
        off += _META_HEAD.size
        _DB.pack_into(pages[pg], off, psize, 0, 0, 0, 0, 0, 0, P_INVALID)  # FREE_DBI
        off += _DB.size
        _DB.pack_into(
            pages[pg], off, 0, 0, depth, n_branch, len(leaves), n_overflow, len(items), root
        )
        off += _DB.size
        struct.pack_into("<QQ", pages[pg], off, len(pages) - 1, txn)  # last_pg, txnid

    if os.path.isdir(path) or path.endswith(os.sep):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "data.mdb")
    with open(path, "wb") as f:
        for p in pages:
            f.write(p)
    return path
