// Native FAST5 (HDF5) writer for the Annotate write-back hot path.
//
// A from-scratch, append-only mini-HDF5 *writer* specialised for the one
// mutation this framework performs on FAST5 files: inserting/replacing the
// corrected-annotation group (ref layout myRefBaseSignalAnnotation.py:689-742,
// group names myCom.py:48-59).  The h5py/libhdf5 path costs ~2.1 ms/file on
// the bench host (HDF5's global lock serialises it process-wide); this
// writer runs lock-free on a thread pool and deflates the datasets in the
// same C++ pass.
//
// Strategy: SHADOW REBUILD.  All new objects (groups, datasets, B-trees,
// heaps, compressed chunks) are appended past EOF in one contiguous tail;
// the only in-place patches are (a) the parent group's symbol-table message
// body (2 addresses), (b) the parent's cached symbol-table-entry scratch if
// present, and (c) the superblock end-of-file address.  A crash before the
// patches leaves the file untouched (bytes past the recorded EOF are
// invisible to HDF5 readers); replaced objects leak file space exactly like
// libhdf5's own unlink (no free-space tracking), matching the reference's
// delete-and-recreate behavior.
//
// Scope (everything else returns a status for the h5py fallback):
//   superblock v0/v1 with 8-byte offsets/lengths, v1 object headers,
//   old-style (symbol-table) groups — which is what MinKNOW/albacore and
//   default h5py produce.  New-style files (v2/v3 superblock, link-message
//   groups) fall back.
//
// Exposed C API (ctypes): batch write over a std::thread pool.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>
#include <thread>
#include <atomic>
#include <stdexcept>

#include <zlib.h>
#ifndef NO_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

typedef uint64_t u64;
typedef uint32_t u32;
typedef uint16_t u16;
typedef uint8_t u8;
typedef int64_t i64;

const u64 UNDEF = ~0ULL;

struct ParseError : std::runtime_error {
    explicit ParseError(const char* m) : std::runtime_error(m) {}
};

// ---------------------------------------------------------------------------
// Read side (minimal: superblock, v1 object headers, symbol-table groups)
// ---------------------------------------------------------------------------

struct Buf {
    const u8* p;
    u64 n;
    u64 get(u64 off, int nbytes) const {
        if (off + nbytes > n) throw ParseError("read past end of file");
        u64 v = 0;
        for (int i = 0; i < nbytes; i++) v |= (u64)p[off + i] << (8 * i);
        return v;
    }
    u8 u8_(u64 off) const { return (u8)get(off, 1); }
    u16 u16_(u64 off) const { return (u16)get(off, 2); }
    u32 u32_(u64 off) const { return (u32)get(off, 4); }
    u64 u64_(u64 off) const { return get(off, 8); }
    const u8* at(u64 off, u64 len) const {
        if (off + len > n) throw ParseError("slice past end of file");
        return p + off;
    }
};

struct Super {
    u64 sb_at = 0;          // superblock file offset (0/512/...)
    int version = 0;
    u64 base = 0;
    u64 eof = 0;
    u64 eof_fileoff = 0;    // file offset of the EOF field (for patching)
    u64 root_header = UNDEF;
    u64 root_entry_fileoff = UNDEF;  // root symbol-table entry (v0/v1)
    int leaf_k = 4, intern_k = 16;
    int istore_k = 32;               // chunk-btree K (libhdf5 default, fixed in v0)
};

Super read_superblock(const Buf& b) {
    static const u8 sig[8] = {0x89, 'H', 'D', 'F', '\r', '\n', 0x1a, '\n'};
    u64 at = UNDEF;
    for (u64 cand : {0ULL, 512ULL, 1024ULL, 2048ULL}) {
        if (cand + 8 <= b.n && memcmp(b.p + cand, sig, 8) == 0) { at = cand; break; }
    }
    if (at == UNDEF) throw ParseError("not an HDF5 file");
    Super s;
    s.sb_at = at;
    int ver = b.u8_(at + 8);
    s.version = ver;
    if (ver != 0 && ver != 1) throw ParseError("superblock v2+: fallback");
    if (b.u8_(at + 13) != 8 || b.u8_(at + 14) != 8)
        throw ParseError("non-8-byte offsets: fallback");
    s.leaf_k = (int)b.u16_(at + 16);
    s.intern_k = (int)b.u16_(at + 18);
    u64 off = at + 24;
    if (ver == 1) {
        s.istore_k = (int)b.u16_(at + 24);
        off += 4;                      // indexed-storage K + reserved
    }
    s.base = b.u64_(off);
    s.eof_fileoff = off + 16;          // base, freespace, EOF, driver
    s.eof = b.u64_(s.eof_fileoff);
    u64 entry = off + 32;              // root group symbol table entry
    s.root_entry_fileoff = entry;
    s.root_header = b.u64_(entry + 8); // link name offset, then header addr
    if (s.leaf_k < 1 || s.leaf_k > 64 || s.intern_k < 1 || s.intern_k > 1024)
        throw ParseError("bad btree K");
    return s;
}

struct GroupInfo {
    u64 header_addr = UNDEF;       // relative to base
    u64 btree = UNDEF, heap = UNDEF;
    u64 stab_body_fileoff = UNDEF; // file offset of the STAB message body
};

// walk a v1 object header; find the symbol-table message (0x0011)
GroupInfo read_group_header(const Buf& b, const Super& s, u64 hdr_addr) {
    GroupInfo g;
    g.header_addr = hdr_addr;
    u64 h = hdr_addr + s.base;
    int ver = b.u8_(h);
    if (ver != 1) throw ParseError("v2 object header: fallback");
    int nmsg = b.u16_(h + 2);
    u32 hsize = b.u32_(h + 8);
    u64 m = h + 16;
    u64 end = m + hsize;
    for (int i = 0; i < nmsg; i++) {
        if (m + 8 > end) throw ParseError("header overrun");
        u16 type = b.u16_(m);
        u16 sz = b.u16_(m + 2);
        u64 body = m + 8;
        if (type == 0x0010) {          // continuation
            u64 caddr = b.u64_(body);
            u64 clen = b.u64_(body + 8);
            m = caddr + s.base;
            end = m + clen;
            continue;
        }
        if (type == 0x0011) {          // symbol table
            g.stab_body_fileoff = body;
            g.btree = b.u64_(body);
            g.heap = b.u64_(body + 8);
        }
        m = body + sz;
    }
    if (g.btree == UNDEF) throw ParseError("not a symbol-table group");
    return g;
}

std::string heap_name(const Buf& b, const Super& s, u64 heap_addr, u64 name_off) {
    u64 h = heap_addr + s.base;
    if (memcmp(b.at(h, 4), "HEAP", 4) != 0) throw ParseError("bad local heap");
    u64 data = b.u64_(h + 24) + s.base;
    const char* nm = (const char*)b.at(data + name_off, 1);
    return std::string(nm, strnlen(nm, b.n - (data + name_off)));
}

struct Child {
    std::string name;
    u64 header_addr;               // relative to base
    u64 entry_fileoff;             // SNOD entry file offset (for cache patch)
    u32 cache_type;
};

void collect_children(const Buf& b, const Super& s, u64 btree_addr,
                      u64 heap_addr, std::vector<Child>& out) {
    u64 t = btree_addr + s.base;
    if (memcmp(b.at(t, 4), "TREE", 4) != 0) throw ParseError("bad btree");
    if (b.u8_(t + 4) != 0) throw ParseError("not a group btree");
    int level = b.u8_(t + 5);
    int used = b.u16_(t + 6);
    u64 m = t + 8 + 16;            // skip left/right siblings
    m += 8;                        // key0
    for (int i = 0; i < used; i++) {
        u64 child = b.u64_(m); m += 8;
        m += 8;                    // key_{i+1}
        if (level > 0) {
            collect_children(b, s, child, heap_addr, out);
            continue;
        }
        u64 snod = child + s.base;
        if (memcmp(b.at(snod, 4), "SNOD", 4) != 0) throw ParseError("bad SNOD");
        int nsym = b.u16_(snod + 6);
        u64 e = snod + 8;
        for (int k = 0; k < nsym; k++) {
            Child c;
            c.entry_fileoff = e;
            c.name = heap_name(b, s, heap_addr, b.u64_(e));
            c.header_addr = b.u64_(e + 8);
            c.cache_type = b.u32_(e + 16);
            out.push_back(std::move(c));
            e += 40;               // linkoff(8) hdr(8) cache(4) res(4) scratch(16)
        }
    }
}

// ---------------------------------------------------------------------------
// Write side: append-buffer emitters for the HDF5 structures we create
// ---------------------------------------------------------------------------

struct WBuf {
    std::vector<u8> v;
    u64 tail_base;                 // file offset where v[0] will land
    u64 base;                      // HDF5 base address (addr = fileoff - base)

    u64 here() const { return tail_base + v.size() - base; }  // HDF5 address
    void u8_(u8 x) { v.push_back(x); }
    void u16_(u16 x) { for (int i = 0; i < 2; i++) v.push_back((u8)(x >> (8 * i))); }
    void u32_(u32 x) { for (int i = 0; i < 4; i++) v.push_back((u8)(x >> (8 * i))); }
    void u64_(u64 x) { for (int i = 0; i < 8; i++) v.push_back((u8)(x >> (8 * i))); }
    void bytes(const void* p, u64 n) {
        const u8* q = (const u8*)p;
        v.insert(v.end(), q, q + n);
    }
    void zeros(u64 n) { v.insert(v.end(), n, 0); }
    void pad_to(u64 align) {
        while (v.size() % align) v.push_back(0);
    }
    void patch_u64(u64 pos_in_buf, u64 x) {
        for (int i = 0; i < 8; i++) v[pos_in_buf + i] = (u8)(x >> (8 * i));
    }
};

u64 pad8(u64 n) { return (n + 7) & ~7ULL; }

// ---- datatype encodings (byte-identical to h5py/libhdf5 output) ----------

void dt_f64(std::vector<u8>& o) {
    const u8 e[] = {0x11, 0x20, 0x3f, 0x00, 8, 0, 0, 0,           // float v1
                    0x00, 0x00, 0x40, 0x00,                       // off 0, prec 64
                    0x34, 0x0b, 0x00, 0x34, 0xff, 0x03, 0x00, 0x00};
    o.insert(o.end(), e, e + sizeof(e));
}

void dt_fixed(std::vector<u8>& o, int size_bytes, bool is_signed) {
    o.push_back(0x10);                      // fixed-point v1
    o.push_back(is_signed ? 0x08 : 0x00);   // LE, unpadded, sign bit
    o.push_back(0); o.push_back(0);
    u32 sz = (u32)size_bytes;
    for (int i = 0; i < 4; i++) o.push_back((u8)(sz >> (8 * i)));
    o.push_back(0); o.push_back(0);                               // bit offset
    u16 prec = (u16)(size_bytes * 8);
    o.push_back((u8)prec); o.push_back((u8)(prec >> 8));          // precision
}

void dt_string(std::vector<u8>& o, u64 n) {
    o.push_back(0x13);                      // string v1
    o.push_back(0x01);                      // null-padded
    o.push_back(0); o.push_back(0);
    u32 sz = (u32)n;
    for (int i = 0; i < 4; i++) o.push_back((u8)(sz >> (8 * i)));
}

// the corrected-events compound dtype (ref myRefBaseSignalAnnotation.py:702):
// [('norm_mean','<f8'),('norm_stdev','<f8'),('start','<u4'),('length','<u4'),
//  ('base','S1')], packed itemsize 25
const u32 EV_ITEMSIZE = 25;

void compound_member(std::vector<u8>& o, const char* name, u32 byte_off,
                     void (*emit_base)(std::vector<u8>&)) {
    u64 nlen = strlen(name) + 1;
    u64 npad = pad8(nlen);
    o.insert(o.end(), (const u8*)name, (const u8*)name + nlen);
    o.insert(o.end(), npad - nlen, 0);
    for (int i = 0; i < 4; i++) o.push_back((u8)(byte_off >> (8 * i)));
    o.insert(o.end(), 28, 0);               // dims/perm/reserved (scalar member)
    emit_base(o);
}

void dt_u32_(std::vector<u8>& o) { dt_fixed(o, 4, false); }
void dt_s1_(std::vector<u8>& o) { dt_string(o, 1); }

void dt_events_compound(std::vector<u8>& o) {
    o.push_back(0x16);                      // compound v1
    o.push_back(5); o.push_back(0); o.push_back(0);   // 5 members
    for (int i = 0; i < 4; i++) o.push_back((u8)(EV_ITEMSIZE >> (8 * i)));
    compound_member(o, "norm_mean", 0, dt_f64);
    compound_member(o, "norm_stdev", 8, dt_f64);
    compound_member(o, "start", 16, dt_u32_);
    compound_member(o, "length", 20, dt_u32_);
    compound_member(o, "base", 24, dt_s1_);
}

void ds_simple1d(std::vector<u8>& o, u64 n) {
    const u8 h[] = {1, 1, 1, 0, 0, 0, 0, 0};          // v1, rank 1, maxdims
    o.insert(o.end(), h, h + 8);
    for (int i = 0; i < 8; i++) o.push_back((u8)(n >> (8 * i)));
    for (int i = 0; i < 8; i++) o.push_back((u8)(n >> (8 * i)));  // max = cur
}

void ds_scalar(std::vector<u8>& o) {
    const u8 h[] = {1, 0, 0, 0, 0, 0, 0, 0};
    o.insert(o.end(), h, h + 8);
}

// ---- object header assembly ----------------------------------------------

struct Msg {
    u16 type;
    u8 flags;
    std::vector<u8> body;
};

u64 emit_object_header(WBuf& w, const std::vector<Msg>& msgs) {
    u64 hsize = 0;
    for (auto& m : msgs) hsize += 8 + pad8(m.body.size());
    w.pad_to(8);
    u64 addr = w.here();
    w.u8_(1); w.u8_(0);                    // version 1
    w.u16_((u16)msgs.size());
    w.u32_(1);                             // reference count
    w.u32_((u32)hsize);
    w.u32_(0);                             // pad to 16
    for (auto& m : msgs) {
        w.u16_(m.type);
        w.u16_((u16)pad8(m.body.size()));
        w.u8_(m.flags); w.u8_(0); w.u8_(0); w.u8_(0);
        w.bytes(m.body.data(), m.body.size());
        w.zeros(pad8(m.body.size()) - m.body.size());
    }
    return addr;
}

Msg msg_stab(u64 btree, u64 heap) {
    Msg m{0x0011, 0, {}};
    for (int i = 0; i < 8; i++) m.body.push_back((u8)(btree >> (8 * i)));
    for (int i = 0; i < 8; i++) m.body.push_back((u8)(heap >> (8 * i)));
    return m;
}

Msg msg_attr_scalar_i64(const char* name, i64 value) {
    Msg m{0x000C, 0, {}};
    auto& o = m.body;
    u64 nlen = strlen(name) + 1;
    std::vector<u8> dt; dt_fixed(dt, 8, true);
    o.push_back(1); o.push_back(0);
    o.push_back((u8)nlen); o.push_back((u8)(nlen >> 8));
    o.push_back((u8)dt.size()); o.push_back((u8)(dt.size() >> 8));
    o.push_back(8); o.push_back(0);                    // scalar dataspace size
    o.insert(o.end(), (const u8*)name, (const u8*)name + nlen);
    o.insert(o.end(), pad8(nlen) - nlen, 0);
    o.insert(o.end(), dt.begin(), dt.end());
    o.insert(o.end(), pad8(dt.size()) - dt.size(), 0);
    std::vector<u8> ds; ds_scalar(ds);
    o.insert(o.end(), ds.begin(), ds.end());
    u64 uv = (u64)value;
    for (int i = 0; i < 8; i++) o.push_back((u8)(uv >> (8 * i)));
    return m;
}

Msg msg_attr_scalar_str(const char* name, const std::string& value) {
    Msg m{0x000C, 0, {}};
    auto& o = m.body;
    u64 nlen = strlen(name) + 1;
    u64 vlen = value.size() ? value.size() : 1;        // S0 is invalid
    std::vector<u8> dt; dt_string(dt, vlen);
    o.push_back(1); o.push_back(0);
    o.push_back((u8)nlen); o.push_back((u8)(nlen >> 8));
    o.push_back((u8)dt.size()); o.push_back((u8)(dt.size() >> 8));
    o.push_back(8); o.push_back(0);
    o.insert(o.end(), (const u8*)name, (const u8*)name + nlen);
    o.insert(o.end(), pad8(nlen) - nlen, 0);
    o.insert(o.end(), dt.begin(), dt.end());
    o.insert(o.end(), pad8(dt.size()) - dt.size(), 0);
    std::vector<u8> ds; ds_scalar(ds);
    o.insert(o.end(), ds.begin(), ds.end());
    o.insert(o.end(), (const u8*)value.data(), (const u8*)value.data() + value.size());
    o.insert(o.end(), pad8(vlen) - value.size(), 0);
    return m;
}

// ---- symbol-table emission (heap + SNODs + btree) -------------------------

struct NamedChild { std::string name; u64 header_addr; };

// Emit a complete symbol table for `kids` (sorted by name inside); returns
// (btree_addr, heap_addr).  SNOD/btree nodes are allocated at full capacity
// (2K entries) so libhdf5 can insert into them later.
std::pair<u64, u64> emit_symbol_table(WBuf& w, std::vector<NamedChild> kids,
                                      int leaf_k, int intern_k) {
    std::sort(kids.begin(), kids.end(),
              [](const NamedChild& a, const NamedChild& b) { return a.name < b.name; });
    // local heap: 8-byte empty name, then each name padded to 8, then a
    // 32-byte free block so future libhdf5 inserts have room
    std::vector<u64> name_off(kids.size());
    u64 used = 8;
    for (size_t i = 0; i < kids.size(); i++) {
        name_off[i] = used;
        used += pad8(kids[i].name.size() + 1);
    }
    u64 free_off = used;
    u64 seg_size = used + 32;
    w.pad_to(8);
    u64 heap_addr = w.here();
    w.bytes("HEAP", 4); w.u8_(0); w.zeros(3);
    w.u64_(seg_size);
    w.u64_(free_off);
    u64 data_addr_pos = w.v.size();
    w.u64_(0);                              // data segment address (patched)
    w.patch_u64(data_addr_pos, w.here());
    w.zeros(8);                             // empty name at offset 0
    for (size_t i = 0; i < kids.size(); i++) {
        w.bytes(kids[i].name.data(), kids[i].name.size());
        w.zeros(pad8(kids[i].name.size() + 1) - kids[i].name.size());
    }
    w.u64_(1);                              // free block: no next
    w.u64_(32);                             // free block size
    w.zeros(16);

    // SNODs: split into nodes of up to 2*leaf_k entries (half-fill when
    // splitting so later inserts don't immediately split again)
    u64 cap = 2 * (u64)leaf_k;
    u64 per = kids.size() <= cap ? (kids.size() ? kids.size() : 0) : (u64)leaf_k;
    std::vector<u64> snod_addr;
    std::vector<u64> snod_maxname;          // heap offset of largest name
    for (u64 lo = 0; lo < kids.size(); lo += per) {
        u64 hi = std::min(lo + per, (u64)kids.size());
        w.pad_to(8);
        u64 sa = w.here();
        w.bytes("SNOD", 4);
        w.u8_(1); w.u8_(0);
        w.u16_((u16)(hi - lo));
        for (u64 i = lo; i < hi; i++) {
            w.u64_(name_off[i]);
            w.u64_(kids[i].header_addr);
            w.u32_(0);                      // cache type 0 (no scratch)
            w.u32_(0);
            w.zeros(16);
        }
        w.zeros((cap - (hi - lo)) * 40);    // full-capacity node
        snod_addr.push_back(sa);
        snod_maxname.push_back(name_off[hi - 1]);
        if (per == 0) break;
    }
    if (snod_addr.empty()) {                // empty group: one empty SNOD
        w.pad_to(8);
        u64 sa = w.here();
        w.bytes("SNOD", 4); w.u8_(1); w.u8_(0); w.u16_(0);
        w.zeros(cap * 40);
        snod_addr.push_back(sa);
        snod_maxname.push_back(0);
    }
    if (snod_addr.size() > 2 * (u64)intern_k)
        throw ParseError("too many children: fallback");

    // group B-tree, level 0, full-capacity node
    w.pad_to(8);
    u64 btree_addr = w.here();
    w.bytes("TREE", 4);
    w.u8_(0);                               // node type: group
    w.u8_(0);                               // level
    w.u16_((u16)snod_addr.size());
    w.u64_(UNDEF); w.u64_(UNDEF);           // siblings
    w.u64_(0);                              // key0: empty name
    for (size_t i = 0; i < snod_addr.size(); i++) {
        w.u64_(snod_addr[i]);
        w.u64_(snod_maxname[i]);            // key_{i+1}: largest name in child
    }
    u64 full = 2 * (u64)intern_k;
    w.zeros((full - snod_addr.size()) * 16);
    return {btree_addr, heap_addr};
}

// ---- dataset emission -----------------------------------------------------

// zlib-format compress via libdeflate when available (2.3x zlib's speed at
// a slightly BETTER ratio on event payloads — measured 0.36 vs 0.84 ms per
// 50 KB at level 1), zlib as fallback.  Both produce standard zlib streams
// for the HDF5 deflate filter.
void zlib_chunk(const u8* data, u64 raw, int zlevel, std::vector<u8>& comp) {
#ifndef NO_LIBDEFLATE
    thread_local struct LD {
        libdeflate_compressor* c = nullptr;
        int level = -1;
        ~LD() { if (c) libdeflate_free_compressor(c); }
    } ld;
    if (ld.c == nullptr || ld.level != zlevel) {
        if (ld.c) libdeflate_free_compressor(ld.c);
        ld.c = libdeflate_alloc_compressor(zlevel);
        ld.level = zlevel;
    }
    if (ld.c != nullptr) {
        size_t bound = libdeflate_zlib_compress_bound(ld.c, raw);
        comp.resize(bound);
        size_t osz = libdeflate_zlib_compress(ld.c, data, raw,
                                              comp.data(), bound);
        if (osz != 0) { comp.resize(osz); return; }
    }
#endif
    uLongf bound = compressBound((uLong)raw);
    comp.resize(bound);
    if (compress2(comp.data(), &bound, data, (uLong)raw, zlevel) != Z_OK)
        throw ParseError("deflate failed");
    comp.resize(bound);
}

// Emit a 1-chunk deflate-compressed chunked dataset; returns header address.
u64 emit_dataset(WBuf& w, const u8* data, u64 nrows, u32 itemsize,
                 void (*emit_dtype)(std::vector<u8>&), int zlevel,
                 int istore_k) {
    // compress the single chunk
    u64 raw = nrows * itemsize;
    std::vector<u8> comp;
    zlib_chunk(data, raw, zlevel, comp);

    w.pad_to(8);
    u64 chunk_addr = w.here();
    w.bytes(comp.data(), comp.size());

    // chunk B-tree (node type 1): one child, key1 = past-the-end.
    // The node MUST be allocated at libhdf5's full node size for this K —
    // on unlink libhdf5 frees that whole extent, and an undersized node
    // would put overlapping extents on the free list (measured corruption).
    w.pad_to(8);
    u64 btree_addr = w.here();
    w.bytes("TREE", 4);
    w.u8_(1); w.u8_(0);
    w.u16_(1);
    w.u64_(UNDEF); w.u64_(UNDEF);
    w.u32_((u32)comp.size()); w.u32_(0);    // key0: stored size, filter mask
    w.u64_(0); w.u64_(0);                   // key0 offsets: dim0=0, elem=0
    w.u64_(chunk_addr);
    w.u32_(0); w.u32_(0);                   // key1
    w.u64_(nrows); w.u64_(0);
    u64 keysize = 4 + 4 + 8 * 2;            // 1-D data: ndims+1 = 2 offsets
    u64 full_node = 24 + (2 * (u64)istore_k + 1) * keysize
                    + 2 * (u64)istore_k * 8;
    u64 written = 24 + 2 * keysize + 8;
    w.zeros(full_node - written);

    std::vector<Msg> msgs;
    { Msg m{0x0001, 0, {}}; ds_simple1d(m.body, nrows); msgs.push_back(std::move(m)); }
    { Msg m{0x0003, 1, {}}; emit_dtype(m.body); msgs.push_back(std::move(m)); }
    { Msg m{0x0005, 1, {0x02, 0x03, 0x02, 0x01, 0, 0, 0, 0}}; msgs.push_back(std::move(m)); }
    { Msg m{0x000B, 1, {}};                 // filter pipeline: deflate
      auto& o = m.body;
      o = {1, 1, 0, 0, 0, 0, 0, 0,
           1, 0, 8, 0, 1, 0, 1, 0,
           'd', 'e', 'f', 'l', 'a', 't', 'e', 0};
      u32 lvl = (u32)zlevel;
      for (int i = 0; i < 4; i++) o.push_back((u8)(lvl >> (8 * i)));
      o.insert(o.end(), 4, 0);
      msgs.push_back(std::move(m)); }
    { Msg m{0x0008, 0, {}};                 // layout v3 chunked
      auto& o = m.body;
      o.push_back(3); o.push_back(2); o.push_back(2);
      for (int i = 0; i < 8; i++) o.push_back((u8)(btree_addr >> (8 * i)));
      u32 cd = (u32)nrows;
      for (int i = 0; i < 4; i++) o.push_back((u8)(cd >> (8 * i)));
      for (int i = 0; i < 4; i++) o.push_back((u8)(itemsize >> (8 * i)));
      msgs.push_back(std::move(m)); }
    return emit_object_header(w, msgs);
}

// ---------------------------------------------------------------------------
// Per-file write
// ---------------------------------------------------------------------------

struct Payload {
    const u8* ev; u64 ev_n;
    const u8* ra; u64 ra_n;
    const u8* ga; u64 ga_n;
    const char* chrom;
    const char* strand;
    const char* bcinfo;
    i64 start, clip_s, clip_e, n_ins, n_del, n_match, n_mm;
};

// group/dataset names (ref myCom.py:48-59 via io/fast5.py)
const char* ANALYSES = "Analyses";
const char* CORRECTED = "NanomoCorrected_000";
const char* BC_TEMPLATE = "BaseCalled_template";
const char* ALIGNMENT = "Alignment";
const char* EVENTS = "Events";
const char* READ_AL = "read_alignment";
const char* GENOME_AL = "genome_alignment";

bool f5w_debug() {
    static int v = -1;
    if (v < 0) v = getenv("F5W_DEBUG") ? 1 : 0;
    return v == 1;
}

int write_one(const char* path, const Payload& pl, int zlevel) {
    if (pl.ev_n == 0 || pl.ra_n == 0 || pl.ga_n == 0) return -10;
    FILE* f = fopen(path, "r+b");
    if (!f) return -1;
    std::vector<u8> file;
    try {
        if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -1; }
        long fsz = ftell(f);
        if (fsz <= 0) { fclose(f); return -1; }
        file.resize((u64)fsz);
        if (fseek(f, 0, SEEK_SET) != 0 ||
            fread(file.data(), 1, file.size(), f) != file.size()) {
            fclose(f); return -1;
        }
        Buf b{file.data(), file.size()};
        Super s = read_superblock(b);
        u64 eof_abs = s.base + s.eof;      // addresses are relative to base
        if (eof_abs > file.size()) { fclose(f); return -3; }

        GroupInfo root = read_group_header(b, s, s.root_header);
        std::vector<Child> root_kids;
        collect_children(b, s, root.btree, root.heap, root_kids);

        // locate /Analyses (create it if absent)
        const Child* analyses = nullptr;
        for (auto& c : root_kids)
            if (c.name == ANALYSES) { analyses = &c; break; }

        GroupInfo parent;                  // the group whose table we rebuild
        std::vector<Child> kids;           // its current children
        const Child* parent_entry = nullptr;   // SNOD entry pointing at it
        bool parent_is_root = (analyses == nullptr);
        if (!parent_is_root) {
            parent = read_group_header(b, s, analyses->header_addr);
            collect_children(b, s, parent.btree, parent.heap, kids);
            parent_entry = analyses;
        } else {
            parent = root;
            kids = root_kids;
        }

        WBuf w;
        w.tail_base = (eof_abs + 7) & ~7ULL;
        w.base = s.base;                   // addresses relative to this

        // datasets
        auto dbg = [&](const char* what) {
            if (f5w_debug())
                fprintf(stderr, "f5w %-12s ends at %llu\n", what,
                        (unsigned long long)(w.tail_base + w.v.size()));
        };
        u64 ev_hdr = emit_dataset(w, pl.ev, pl.ev_n, EV_ITEMSIZE,
                                  dt_events_compound, zlevel, s.istore_k);
        dbg("ev");
        u64 ra_hdr = emit_dataset(w, pl.ra, pl.ra_n, 1, dt_s1_, zlevel,
                                  s.istore_k);
        dbg("ra");
        u64 ga_hdr = emit_dataset(w, pl.ga, pl.ga_n, 1, dt_s1_, zlevel,
                                  s.istore_k);
        dbg("ga");

        // Alignment group: symbol table + attrs
        //   (attr order mirrors io/fast5.py write_corrected_events)
        auto al_tab = emit_symbol_table(
            w, {{GENOME_AL, ga_hdr}, {READ_AL, ra_hdr}}, s.leaf_k, s.intern_k);
        std::vector<Msg> al_msgs;
        al_msgs.push_back(msg_stab(al_tab.first, al_tab.second));
        al_msgs.push_back(msg_attr_scalar_i64("mapped_start", pl.start));
        al_msgs.push_back(msg_attr_scalar_str("mapped_strand", pl.strand));
        al_msgs.push_back(msg_attr_scalar_str("mapped_chrom", pl.chrom));
        al_msgs.push_back(msg_attr_scalar_i64("clipped_bases_start", pl.clip_s));
        al_msgs.push_back(msg_attr_scalar_i64("clipped_bases_end", pl.clip_e));
        al_msgs.push_back(msg_attr_scalar_i64("num_insertions", pl.n_ins));
        al_msgs.push_back(msg_attr_scalar_i64("num_deletions", pl.n_del));
        al_msgs.push_back(msg_attr_scalar_i64("num_matches", pl.n_match));
        al_msgs.push_back(msg_attr_scalar_i64("num_mismatches", pl.n_mm));
        al_msgs.push_back(msg_attr_scalar_str("Bcinfo", pl.bcinfo));
        u64 al_hdr = emit_object_header(w, al_msgs);
        dbg("al");

        // BaseCalled_template group
        auto bt_tab = emit_symbol_table(
            w, {{ALIGNMENT, al_hdr}, {EVENTS, ev_hdr}}, s.leaf_k, s.intern_k);
        u64 bt_hdr = emit_object_header(w, {msg_stab(bt_tab.first, bt_tab.second)});
        dbg("bt");

        // NanomoCorrected_000 group
        auto nc_tab = emit_symbol_table(
            w, {{BC_TEMPLATE, bt_hdr}}, s.leaf_k, s.intern_k);
        u64 nc_hdr = emit_object_header(w, {msg_stab(nc_tab.first, nc_tab.second)});
        dbg("nc");

        u64 target_hdr = nc_hdr;
        const char* target_name = CORRECTED;
        if (parent_is_root) {
            // also create the Analyses group itself
            auto an_tab = emit_symbol_table(
                w, {{CORRECTED, nc_hdr}}, s.leaf_k, s.intern_k);
            target_hdr = emit_object_header(
                w, {msg_stab(an_tab.first, an_tab.second)});
            target_name = ANALYSES;
        }

        // rebuild the parent's symbol table with the target upserted
        std::vector<NamedChild> nk;
        bool replaced = false;
        for (auto& c : kids) {
            if (c.name == target_name) { nk.push_back({c.name, target_hdr}); replaced = true; }
            else nk.push_back({c.name, c.header_addr});
        }
        if (!replaced) nk.push_back({target_name, target_hdr});
        auto new_tab = emit_symbol_table(w, nk, s.leaf_k, s.intern_k);
        dbg("parent_tab");

        w.pad_to(8);
        u64 new_eof_abs = w.tail_base + w.v.size();

        // --- all validation done; apply the three patches + tail ---
        if (fseek(f, (long)w.tail_base, SEEK_SET) != 0 ||
            fwrite(w.v.data(), 1, w.v.size(), f) != w.v.size()) {
            fclose(f); return -4;
        }
        u8 two_addr[16];
        for (int i = 0; i < 8; i++) two_addr[i] = (u8)(new_tab.first >> (8 * i));
        for (int i = 0; i < 8; i++) two_addr[8 + i] = (u8)(new_tab.second >> (8 * i));
        if (fseek(f, (long)parent.stab_body_fileoff, SEEK_SET) != 0 ||
            fwrite(two_addr, 1, 16, f) != 16) { fclose(f); return -4; }
        // patch the cached (btree, heap) scratch of the entry pointing at
        // the parent, else libhdf5 keeps using the stale cached table
        u64 scratch_off = UNDEF;
        if (parent_is_root) {
            if (b.u32_(s.root_entry_fileoff + 16) == 1)
                scratch_off = s.root_entry_fileoff + 24;
        } else if (parent_entry->cache_type == 1) {
            scratch_off = parent_entry->entry_fileoff + 24;
        }
        if (scratch_off != UNDEF) {
            if (fseek(f, (long)scratch_off, SEEK_SET) != 0 ||
                fwrite(two_addr, 1, 16, f) != 16) { fclose(f); return -4; }
        }
        u64 new_eof_rel = new_eof_abs - s.base;
        u8 eofb[8];
        for (int i = 0; i < 8; i++) eofb[i] = (u8)(new_eof_rel >> (8 * i));
        if (fseek(f, (long)s.eof_fileoff, SEEK_SET) != 0 ||
            fwrite(eofb, 1, 8, f) != 8) { fclose(f); return -4; }
        fclose(f);
        return 0;
    } catch (const ParseError&) {
        fclose(f);
        return -2;                         // structural surprise: h5py fallback
    } catch (const std::exception&) {
        fclose(f);
        return -5;
    }
}

}  // namespace

extern "C" {

// Batch write of corrected annotations.  Array arguments are concatenated
// across files with exclusive prefix offsets (length nfiles+1).  status_out:
// 0 = written, negative = not written (use the h5py fallback).
int f5w_write_batch(const char** paths, int nfiles,
                    const u8* ev_bytes, const i64* ev_offsets,
                    const u8* ra_bytes, const i64* ra_offsets,
                    const u8* ga_bytes, const i64* ga_offsets,
                    const char** chroms, const char** strands,
                    const char** bcinfos,
                    const i64* starts, const i64* clip_s, const i64* clip_e,
                    const i64* n_ins, const i64* n_del,
                    const i64* n_match, const i64* n_mm,
                    int zlevel, int nthreads,
                    int32_t* status_out) {
    std::atomic<int> next(0);
    int nt = std::max(1, std::min(nthreads, 32));
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= nfiles) return;
            Payload pl;
            pl.ev = ev_bytes + ev_offsets[i] * EV_ITEMSIZE;
            pl.ev_n = (u64)(ev_offsets[i + 1] - ev_offsets[i]);
            pl.ra = ra_bytes + ra_offsets[i];
            pl.ra_n = (u64)(ra_offsets[i + 1] - ra_offsets[i]);
            pl.ga = ga_bytes + ga_offsets[i];
            pl.ga_n = (u64)(ga_offsets[i + 1] - ga_offsets[i]);
            pl.chrom = chroms[i];
            pl.strand = strands[i];
            pl.bcinfo = bcinfos[i];
            pl.start = starts[i];
            pl.clip_s = clip_s[i]; pl.clip_e = clip_e[i];
            pl.n_ins = n_ins[i]; pl.n_del = n_del[i];
            pl.n_match = n_match[i]; pl.n_mm = n_mm[i];
            status_out[i] = (int32_t)write_one(paths[i], pl, zlevel);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 0; t < nt - 1; t++) ts.emplace_back(worker);
    worker();
    for (auto& t : ts) t.join();
    return 0;
}

}  // extern "C"
