# Copy of tntblast_tpu/io/lmdb.py with the package name changed.
"""Native LMDB (Lightning Memory-Mapped Database) file access.

NCBI BLAST v5 databases index accessions with LMDB environments
(`<base>.ndb`, plus taxonomy LMDBs); the reference reaches them through
the NCBI toolkit's CSeqDB (reference sequence_data.cpp:28-240, compile-
gated behind USE_BLAST_DB).  This environment has no liblmdb or NCBI
toolkit, so this module implements the LMDB on-disk format directly:

  * `LmdbEnv` — a read-only parser of the standard LMDB data file
    (meta pages, branch/leaf B-tree pages, named sub-databases,
    overflow values).  64-bit little-endian layout, the format
    `mdb_env_open` writes.
  * `write_env` — a minimal single-transaction writer (sorted inserts,
    sub-databases, multi-level branch pages) used to build v5 index
    fixtures; it emits standard LMDB files that `LmdbEnv` (or any stock
    liblmdb) can open.

Only the features BLAST v5 indices need are implemented: no DUPSORT
trees (values that must hold many OIDs are stored as packed arrays),
no free-list reuse, no write transactions on existing files.
"""

import struct

# page flags (lmdb.h)
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# node flags
F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

PAGEHDRSZ = 16
MAGIC = 0xBEEFC0DE
DATA_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

_DB_FMT = "<IHHQQQQQ"          # MDB_db: pad, flags, depth, branch, leaf,
_DB_SIZE = struct.calcsize(_DB_FMT)  # overflow, entries, root  (48 bytes)


class LmdbError(ValueError):
    pass


class LmdbEnv:
    """Read-only LMDB environment over one data file."""

    def __init__(self, path, page_size=4096):
        self.data = open(path, "rb").read()
        self.page_size = page_size
        metas = []
        for pg in (0, 1):
            try:
                metas.append(self._meta(pg))
            except LmdbError:
                pass
        if not metas:
            raise LmdbError(f"{path}: no valid LMDB meta page")
        self.meta = max(metas, key=lambda m: m["txnid"])

    def _unpack(self, fmt, off):
        """struct.unpack_from with structural damage mapped to LmdbError
        (truncated or corrupted files must fail loudly and typed)."""
        try:
            return struct.unpack_from(fmt, self.data, off)
        except struct.error as e:
            raise LmdbError(f"truncated/corrupt LMDB file: {e}") from None

    def _meta(self, pg):
        off = pg * self.page_size + PAGEHDRSZ
        magic, version = self._unpack("<II", off)
        if magic != MAGIC:
            raise LmdbError("bad magic")
        if version != DATA_VERSION:
            raise LmdbError(f"unsupported LMDB data version {version}")
        off += 8 + 8 + 8                      # magic+version, address, mapsize
        dbs = []
        for _ in range(2):
            vals = self._unpack(_DB_FMT, off)
            dbs.append({"flags": vals[1], "depth": vals[2],
                        "entries": vals[6], "root": vals[7]})
            off += _DB_SIZE
        last_pg, txnid = self._unpack("<QQ", off)
        return {"main": dbs[1], "txnid": txnid, "last_pg": last_pg}

    # -- page walking ---------------------------------------------------
    def _page(self, pgno):
        off = pgno * self.page_size
        if off + PAGEHDRSZ > len(self.data):
            raise LmdbError(f"page {pgno} out of range")
        flags, lower, upper = self._unpack("<HHH", off + 10)
        return off, flags, lower

    def _nodes(self, pgno):
        """Yield (key, node_flags, data_bytes_or_pgno) for one page."""
        off, flags, lower = self._page(pgno)
        if flags & P_LEAF2:
            raise LmdbError("LEAF2 (dupfixed) pages not supported")
        n = (lower - PAGEHDRSZ) // 2
        if n < 0 or n > self.page_size // 2:
            raise LmdbError(f"corrupt page header: {n} nodes")
        ptrs = self._unpack(f"<{n}H", off + PAGEHDRSZ)
        out = []
        for p in ptrs:
            base = off + p
            lo, hi, nflags, ksize = self._unpack("<HHHH", base)
            key = self.data[base + 8:base + 8 + ksize]
            if flags & P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                out.append((key, P_BRANCH, child))
            else:
                dsize = lo | (hi << 16)
                dstart = base + 8 + ksize
                if nflags & F_BIGDATA:
                    (ovpg,) = self._unpack("<Q", dstart)
                    oof, oflags, _ = self._page(ovpg)
                    if not oflags & P_OVERFLOW:
                        raise LmdbError("bad overflow page")
                    data = self.data[oof + PAGEHDRSZ:
                                     oof + PAGEHDRSZ + dsize]
                else:
                    data = self.data[dstart:dstart + dsize]
                out.append((key, nflags, data))
        return out

    def _tree_items(self, root, _depth=0):
        if root == P_INVALID:
            return
        if _depth > 64:          # corrupted branch cycles must terminate
            raise LmdbError("B-tree deeper than 64 levels (corrupt?)")
        _, flags, _ = self._page(root)
        if flags & P_BRANCH:
            for _, _, child in self._nodes(root):
                yield from self._tree_items(child, _depth + 1)
        else:
            for key, nflags, data in self._nodes(root):
                if nflags & F_DUPDATA:
                    raise LmdbError("DUPSORT values not supported")
                yield key, nflags, data

    # -- public API -----------------------------------------------------
    def sub_dbs(self):
        """Names of the named sub-databases in the main tree."""
        out = []
        for key, nflags, data in self._tree_items(self.meta["main"]["root"]):
            if nflags & F_SUBDATA:
                out.append(key.decode("latin1"))
        return out

    def _sub_root(self, name):
        want = name.encode() if isinstance(name, str) else name
        for key, nflags, data in self._tree_items(self.meta["main"]["root"]):
            if key == want and nflags & F_SUBDATA:
                if len(data) < _DB_SIZE:
                    raise LmdbError("corrupt sub-db record")
                vals = struct.unpack_from(_DB_FMT, data, 0)
                return vals[7]
        return None

    def items(self, db=None):
        """All (key, value) pairs of a sub-database (or the main tree)."""
        root = (self.meta["main"]["root"] if db is None
                else self._sub_root(db))
        if root is None:
            raise LmdbError(f"no sub-database {db!r}")
        for key, nflags, data in self._tree_items(root):
            if not nflags & F_SUBDATA:
                yield key, data

    def get(self, key, db=None):
        """Value for `key` (bytes) or None.  B-tree descent, not a scan."""
        want = key.encode() if isinstance(key, str) else key
        root = (self.meta["main"]["root"] if db is None
                else self._sub_root(db))
        if root is None:
            raise LmdbError(f"no sub-database {db!r}")
        pgno = root
        depth = 0
        while pgno != P_INVALID:
            depth += 1
            if depth > 64:       # corrupted branch cycles must terminate
                raise LmdbError("B-tree deeper than 64 levels (corrupt?)")
            _, flags, _ = self._page(pgno)
            nodes = self._nodes(pgno)
            if flags & P_BRANCH:
                child = nodes[0][2]
                for k, _, c in nodes[1:]:
                    if want >= k:
                        child = c
                    else:
                        break
                pgno = child
            else:
                for k, nflags, data in nodes:
                    if k == want and not nflags & F_SUBDATA:
                        return data
                return None
        return None


# ---------------------------------------------------------------------------
# Writer

def _node_bytes(key, data, flags=0):
    lo = len(data) & 0xFFFF
    hi = len(data) >> 16
    raw = struct.pack("<HHHH", lo, hi, flags, len(key)) + key + data
    return raw + (b"\x00" * (len(raw) & 1))          # 2-byte alignment


def _branch_node(key, pgno):
    raw = struct.pack("<HHHH", pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                      (pgno >> 32) & 0xFFFF, len(key)) + key
    return raw + (b"\x00" * (len(raw) & 1))


class _Writer:
    def __init__(self, page_size=4096):
        self.page_size = page_size
        self.pages = [None, None]            # meta pages 0/1 filled last

    def _emit(self, flags, nodes):
        """Pack node byte-strings into one page; returns pgno."""
        ps = self.page_size
        lower = PAGEHDRSZ + 2 * len(nodes)
        body_len = sum(len(n) for n in nodes)
        if lower + body_len > ps:
            raise LmdbError("page overflow in writer")
        page = bytearray(ps)
        upper = ps
        ptrs = []
        for n in nodes:
            upper -= len(n)
            page[upper:upper + len(n)] = n
            ptrs.append(upper)
        pgno = len(self.pages)
        struct.pack_into("<QHHHH", page, 0, pgno, 0, flags, lower, upper)
        struct.pack_into(f"<{len(ptrs)}H", page, PAGEHDRSZ, *ptrs)
        self.pages.append(bytes(page))
        return pgno

    def _emit_overflow(self, data):
        ps = self.page_size
        npg = -(-(len(data) + PAGEHDRSZ) // ps)
        pgno = len(self.pages)
        blob = bytearray(npg * ps)
        struct.pack_into("<QHHI", blob, 0, pgno, 0, P_OVERFLOW, npg)
        blob[PAGEHDRSZ:PAGEHDRSZ + len(data)] = data
        for i in range(npg):
            self.pages.append(bytes(blob[i * ps:(i + 1) * ps]))
        return pgno

    def build_tree(self, items, node_flags=0):
        """items: sorted [(key, value)]; returns (root_pgno, depth,
        n_branch, n_leaf).  Values larger than a half page spill to
        overflow pages."""
        ps = self.page_size
        leaf_nodes = []
        for k, v in items:
            if 8 + len(k) + len(v) > (ps - PAGEHDRSZ) // 2:
                # big value -> overflow pages; the node keeps the true
                # data size but its payload is the overflow pgno
                ovpg = self._emit_overflow(v)
                raw = struct.pack("<HHHH", len(v) & 0xFFFF, len(v) >> 16,
                                  node_flags | F_BIGDATA,
                                  len(k)) + k + struct.pack("<Q", ovpg)
                n = raw + (b"\x00" * (len(raw) & 1))
            else:
                n = _node_bytes(k, v, node_flags)
            leaf_nodes.append((k, n))

        # pack leaves
        level = []          # (first_key, pgno)
        cur = []
        used = PAGEHDRSZ
        n_leaf = 0
        for k, n in leaf_nodes:
            if cur and used + 2 + len(n) > ps:
                level.append((cur[0][0], self._emit(P_LEAF,
                                                    [x[1] for x in cur])))
                n_leaf += 1
                cur, used = [], PAGEHDRSZ
            cur.append((k, n))
            used += 2 + len(n)
        level.append((cur[0][0] if cur else b"",
                      self._emit(P_LEAF, [x[1] for x in cur])))
        n_leaf += 1

        depth = 1
        n_branch = 0
        while len(level) > 1:
            nxt = []
            cur = []
            used = PAGEHDRSZ
            for i, (k, pgno) in enumerate(level):
                bk = b"" if not cur else k     # leftmost key is empty
                n = _branch_node(bk, pgno)
                if cur and used + 2 + len(n) > ps:
                    nxt.append((cur[0][0],
                                self._emit(P_BRANCH, [x[1] for x in cur])))
                    n_branch += 1
                    cur, used = [], PAGEHDRSZ
                    n = _branch_node(b"", pgno)
                cur.append((k, n))
                used += 2 + len(n)
            nxt.append((cur[0][0], self._emit(P_BRANCH,
                                              [x[1] for x in cur])))
            n_branch += 1
            level = nxt
            depth += 1
        return level[0][1], depth, n_branch, n_leaf


def write_env(path, dbs, page_size=4096):
    """Write an LMDB environment: dbs = {name: {key_bytes: value_bytes}}.
    Emits the standard format (two meta pages + B-tree pages)."""
    w = _Writer(page_size)
    main_items = []
    for name in sorted(dbs):
        items = sorted((k if isinstance(k, bytes) else k.encode(),
                        v if isinstance(v, bytes) else v)
                       for k, v in dbs[name].items())
        root, depth, nb, nl = w.build_tree(items)
        dbrec = struct.pack(_DB_FMT, 0, 0, depth, nb, nl, 0,
                            len(items), root)
        main_items.append((name.encode(), dbrec))

    main_nodes = [_node_bytes(k, v, F_SUBDATA) for k, v in main_items]
    main_root = w._emit(P_LEAF, main_nodes)

    free_db = struct.pack(_DB_FMT, 0, 0, 0, 0, 0, 0, 0, P_INVALID)
    main_db = struct.pack(_DB_FMT, 0, 0, 1, 0, 1, 0,
                          len(main_items), main_root)

    last_pg = len(w.pages) - 1
    for pg, txnid in ((0, 1), (1, 1)):
        page = bytearray(page_size)
        struct.pack_into("<QHHHH", page, 0, pg, 0, P_META,
                         PAGEHDRSZ, page_size)
        off = PAGEHDRSZ
        struct.pack_into("<II", page, off, MAGIC, DATA_VERSION)
        off += 8
        struct.pack_into("<QQ", page, off, 0, page_size * (last_pg + 1))
        off += 16
        page[off:off + _DB_SIZE] = free_db
        off += _DB_SIZE
        page[off:off + _DB_SIZE] = main_db
        off += _DB_SIZE
        struct.pack_into("<QQ", page, off, last_pg, txnid)
        w.pages[pg] = bytes(page)

    with open(path, "wb") as fh:
        for p in w.pages:
            fh.write(p)
