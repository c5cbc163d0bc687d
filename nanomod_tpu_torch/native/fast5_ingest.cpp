// Native FAST5 (HDF5) ingest for the detect hot path.
//
// A from-scratch, read-only mini-HDF5 parser specialised for FAST5 files:
// superblock v0/v1/v2/v3, v1/v2 object headers, v1 B-trees + local heaps +
// symbol-table groups, global heaps (vlen string attributes), compound /
// fixed / float / string datatypes, contiguous + chunked layouts with
// deflate and shuffle filters.  No libhdf5 dependency, no global locks —
// files parse fully in parallel on a std::thread pool (the HDF5 C library
// is not thread-safe, which is exactly why the reference's h5py ingest
// (ref bin/scripts/myDetect.py:547-633, myFast5.py:92-126) cannot scale;
// this reader replaces it for the corrected-events read path).
//
// Exposed C API (ctypes): batch read of the NanomoCorrected_000 annotation
// (ref layout: myRefBaseSignalAnnotation.py:689-742, myCom.py:48-59) from
// many FAST5s into flat, concatenated column buffers.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
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

const u64 UNDEF = ~0ULL;

struct ParseError : std::runtime_error {
    explicit ParseError(const char* m) : std::runtime_error(m) {}
};

// ---------------------------------------------------------------------------
// Byte-buffer reader (little-endian, bounds-checked)
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
    int sizeoff = 8, sizelen = 8;
    u64 base = 0;
    u64 root_header = UNDEF;
};

u64 rdoff(const Buf& b, u64 off, const Super& s) { return b.get(off, s.sizeoff); }
u64 rdlen(const Buf& b, u64 off, const Super& s) { return b.get(off, s.sizelen); }

Super read_superblock(const Buf& b) {
    static const u8 sig[8] = {0x89, 'H', 'D', 'F', '\r', '\n', 0x1a, '\n'};
    // signature may be at 0, 512, 1024, ... (we only check 0 and 512)
    u64 at = UNDEF;
    for (u64 cand : {0ULL, 512ULL, 1024ULL, 2048ULL}) {
        if (cand + 8 <= b.n && memcmp(b.p + cand, sig, 8) == 0) { at = cand; break; }
    }
    if (at == UNDEF) throw ParseError("not an HDF5 file");
    Super s;
    int ver = b.u8_(at + 8);
    if (ver == 0 || ver == 1) {
        s.sizeoff = b.u8_(at + 13);
        s.sizelen = b.u8_(at + 14);
        u64 off = at + 24;
        if (ver == 1) off += 4;
        s.base = rdoff(b, off, s);
        off += 4 * s.sizeoff;            // base, freespace, eof, driver info
        // root group symbol table entry: name offset, object header address
        off += s.sizeoff;                // link name offset
        s.root_header = rdoff(b, off, s);
    } else if (ver == 2 || ver == 3) {
        s.sizeoff = b.u8_(at + 9);
        s.sizelen = b.u8_(at + 10);
        u64 off = at + 12;
        s.base = rdoff(b, off, s);
        off += 3 * s.sizeoff;            // base, sb-extension, eof
        s.root_header = rdoff(b, off, s);
    } else {
        throw ParseError("unsupported superblock version");
    }
    if (s.sizeoff < 1 || s.sizeoff > 8 || s.sizelen < 1 || s.sizelen > 8)
        throw ParseError("bad offset/length size");
    return s;
}

// ---------------------------------------------------------------------------
// Datatype / dataspace
// ---------------------------------------------------------------------------

struct Member {
    std::string name;
    u32 offset = 0;
    int cls = -1;          // 0 fixed, 1 float, 3 string, 9 vlen
    u32 size = 0;
    bool signed_ = false;
};

struct Dtype {
    int cls = -1;          // HDF5 class
    u32 size = 0;
    bool signed_ = false;
    bool vlen_string = false;
    std::vector<Member> members;   // compound
};

// parse a datatype at `off`, advancing `off` past it
Dtype parse_dtype(const Buf& b, u64& off) {
    Dtype t;
    u8 cv = b.u8_(off);
    int version = cv >> 4;
    t.cls = cv & 0x0f;
    u32 bits0 = b.u8_(off + 1) | (b.u8_(off + 2) << 8) | (b.u8_(off + 3) << 16);
    t.size = b.u32_(off + 4);
    u64 prop = off + 8;
    switch (t.cls) {
        case 0:  // fixed-point: bit offset + precision
            t.signed_ = (bits0 >> 3) & 1;
            off = prop + 4;
            break;
        case 1:  // float: 12 bytes of properties
            off = prop + 12;
            break;
        case 3:  // string (fixed-length)
            off = prop;
            break;
        case 6: {  // compound
            int nmembers = bits0 & 0xffff;
            u64 m = prop;
            for (int i = 0; i < nmembers; i++) {
                Member mem;
                if (version < 3) {
                    // null-terminated name padded to multiple of 8
                    const char* nm = (const char*)b.at(m, 1);
                    u64 maxlen = b.n - m;
                    u64 l = strnlen(nm, maxlen);
                    mem.name.assign(nm, l);
                    m += ((l + 8) / 8) * 8;
                    mem.offset = b.u32_(m); m += 4;
                    if (version == 1) {
                        m += 1 + 3 + 4 + 4 + 16;   // rank/reserved/perm/reserved/dims
                    }
                } else {
                    const char* nm = (const char*)b.at(m, 1);
                    u64 l = strnlen(nm, b.n - m);
                    mem.name.assign(nm, l);
                    m += l + 1;
                    // byte offset: minimal bytes needed for datatype size
                    int nb = 1;
                    u32 sz = t.size;
                    while (sz > 255) { nb++; sz >>= 8; }
                    mem.offset = (u32)b.get(m, nb); m += nb;
                }
                Dtype sub = parse_dtype(b, m);
                mem.cls = sub.cls;
                mem.size = sub.size;
                mem.signed_ = sub.signed_;
                t.members.push_back(mem);
            }
            off = m;
            break;
        }
        case 9: {  // variable-length
            u64 m = prop;
            Dtype base = parse_dtype(b, m);
            t.vlen_string = ((bits0 & 0x0f) == 1) || base.cls == 3;
            off = m;
            break;
        }
        default:
            // skip classes we don't need (time, bitfield, opaque, ref, enum, array)
            off = prop;
            break;
    }
    return t;
}

struct Dspace {
    std::vector<u64> dims;
    u64 npoints() const {
        u64 v = 1;
        for (u64 d : dims) v *= d;
        return v;
    }
};

Dspace parse_dspace(const Buf& b, u64 off, const Super& s) {
    Dspace d;
    u8 version = b.u8_(off);
    if (version == 1) {
        int nd = b.u8_(off + 1);
        u64 m = off + 8;
        for (int i = 0; i < nd; i++) { d.dims.push_back(rdlen(b, m, s)); m += s.sizelen; }
    } else if (version == 2) {
        int nd = b.u8_(off + 1);
        u64 m = off + 4;
        for (int i = 0; i < nd; i++) { d.dims.push_back(rdlen(b, m, s)); m += s.sizelen; }
    } else {
        throw ParseError("unsupported dataspace version");
    }
    return d;
}

// ---------------------------------------------------------------------------
// Object header messages
// ---------------------------------------------------------------------------

struct Filter { u16 id; std::vector<u32> cd; };

struct Attr {
    std::string name;
    Dtype dtype;
    Dspace dspace;
    u64 data_off = 0;      // offset of raw attribute data in file
};

struct Object {
    // group side
    u64 btree = UNDEF, heap = UNDEF;            // v1 symbol-table group
    std::vector<std::pair<std::string, u64>> links;  // v2 link messages
    // dataset side
    Dtype dtype;
    Dspace dspace;
    int layout_class = -1;                      // 0 compact, 1 contiguous, 2 chunked
    u64 data_addr = UNDEF;                      // contiguous addr / chunk btree addr
    u64 data_size = 0;                          // contiguous size / compact size
    u64 compact_off = 0;
    std::vector<u32> chunk_dims;                // incl. trailing element size
    int chunk_index = 0;                        // 0 = v1 btree; else layout-v4 type
    u64 single_chunk_size = 0;                  // v4 single-chunk-with-filter
    std::vector<Filter> filters;
    std::vector<Attr> attrs;
    bool has_dspace = false;
};

void parse_attr_msg(const Buf& b, u64 off, const Super& s, Object& obj) {
    u8 version = b.u8_(off);
    u16 name_sz = b.u16_(off + 2);
    u16 dt_sz = b.u16_(off + 4);
    u16 ds_sz = b.u16_(off + 6);
    Attr a;
    if (version == 1) {
        u64 m = off + 8;
        const char* nm = (const char*)b.at(m, name_sz);
        a.name.assign(nm, strnlen(nm, name_sz));
        m += ((name_sz + 7) / 8) * 8;
        u64 dt_off = m;
        a.dtype = parse_dtype(b, dt_off);
        m += ((dt_sz + 7) / 8) * 8;
        a.dspace = parse_dspace(b, m, s);
        m += ((ds_sz + 7) / 8) * 8;
        a.data_off = m;
    } else if (version == 2 || version == 3) {
        u64 m = off + 8;
        if (version == 3) m += 1;   // name character-set encoding
        const char* nm = (const char*)b.at(m, name_sz);
        a.name.assign(nm, strnlen(nm, name_sz));
        m += name_sz;
        u64 dt_off = m;
        a.dtype = parse_dtype(b, dt_off);
        m += dt_sz;
        a.dspace = parse_dspace(b, m, s);
        m += ds_sz;
        a.data_off = m;
    } else {
        return;  // ignore unknown attribute versions
    }
    obj.attrs.push_back(a);
}

void parse_filter_msg(const Buf& b, u64 off, Object& obj) {
    u8 version = b.u8_(off);
    int nf = b.u8_(off + 1);
    u64 m = off + (version == 1 ? 8 : 2);
    for (int i = 0; i < nf; i++) {
        Filter f;
        f.id = b.u16_(m); m += 2;
        u16 name_len = 0;
        if (version == 1 || f.id >= 256) { name_len = b.u16_(m); m += 2; }
        m += 2;                      // flags
        u16 ncd = b.u16_(m); m += 2;
        if (version == 1) m += ((name_len + 7) / 8) * 8;
        else m += name_len;
        for (int c = 0; c < ncd; c++) { f.cd.push_back(b.u32_(m)); m += 4; }
        if (version == 1 && (ncd % 2) == 1) m += 4;  // pad
        obj.filters.push_back(f);
    }
}

void parse_layout_msg(const Buf& b, u64 off, const Super& s, Object& obj) {
    u8 version = b.u8_(off);
    if (version == 3) {
        obj.layout_class = b.u8_(off + 1);
        u64 m = off + 2;
        if (obj.layout_class == 0) {          // compact
            obj.data_size = b.u16_(m); m += 2;
            obj.compact_off = m;
        } else if (obj.layout_class == 1) {   // contiguous
            obj.data_addr = rdoff(b, m, s); m += s.sizeoff;
            obj.data_size = rdlen(b, m, s);
        } else if (obj.layout_class == 2) {   // chunked
            int nd = b.u8_(m); m += 1;
            obj.data_addr = rdoff(b, m, s); m += s.sizeoff;
            for (int i = 0; i < nd; i++) { obj.chunk_dims.push_back(b.u32_(m)); m += 4; }
        }
    } else if (version == 4) {
        // v4 (libver 'latest'): per-index-type chunked storage
        obj.layout_class = b.u8_(off + 1);
        u64 m = off + 2;
        if (obj.layout_class == 0) {
            obj.data_size = b.u16_(m); m += 2;
            obj.compact_off = m;
        } else if (obj.layout_class == 1) {
            obj.data_addr = rdoff(b, m, s); m += s.sizeoff;
            obj.data_size = rdlen(b, m, s);
        } else if (obj.layout_class == 2) {
            u8 flags = b.u8_(m); m += 1;
            int nd = b.u8_(m); m += 1;      // rank+1 (elem size last), as in v3
            int enc = b.u8_(m); m += 1;
            for (int i = 0; i < nd; i++) {
                obj.chunk_dims.push_back((u32)b.get(m, enc)); m += enc;
            }
            obj.chunk_index = b.u8_(m); m += 1;
            if (obj.chunk_index == 1) {            // single chunk
                if (flags & 0x02) {                // filtered single chunk
                    obj.single_chunk_size = rdlen(b, m, s); m += s.sizelen;
                    m += 4;                        // filter mask
                }
            } else if (obj.chunk_index == 3) {     // fixed array
                m += 1;                            // page bits
            } else if (obj.chunk_index == 4) {     // extensible array
                m += 6;
            } else if (obj.chunk_index == 5) {     // v2 btree
                m += 6;
            }
            obj.data_addr = rdoff(b, m, s);
        }
    } else if (version == 1 || version == 2) {
        int nd = b.u8_(off + 1);
        obj.layout_class = b.u8_(off + 2);
        u64 m = off + 8;
        if (obj.layout_class != 0) { obj.data_addr = rdoff(b, m, s); m += s.sizeoff; }
        for (int i = 0; i < nd; i++) { obj.chunk_dims.push_back(b.u32_(m)); m += 4; }
        if (obj.layout_class == 1) obj.data_size = b.u32_(m);
    } else {
        throw ParseError("unsupported layout version");
    }
}

void parse_link_msg(const Buf& b, u64 off, const Super& s, Object& obj) {
    u8 version = b.u8_(off);
    if (version != 1) return;
    u8 flags = b.u8_(off + 1);
    u64 m = off + 2;
    u8 ltype = 0;
    if (flags & 0x08) { ltype = b.u8_(m); m += 1; }
    if (flags & 0x04) m += 8;          // creation order
    if (flags & 0x10) m += 1;          // charset
    int lsz = 1 << (flags & 0x03);
    u64 name_len = b.get(m, lsz); m += lsz;
    const char* nm = (const char*)b.at(m, name_len);
    std::string name(nm, name_len);
    m += name_len;
    if (ltype == 0) obj.links.emplace_back(name, rdoff(b, m, s));
}

void parse_messages_v1(const Buf& b, const Super& s, u64 off, u64 span, Object& obj,
                       std::vector<std::pair<u64, u64>>& continuations);

void parse_one_msg(const Buf& b, const Super& s, u16 type, u64 body, Object& obj,
                   std::vector<std::pair<u64, u64>>& continuations) {
    switch (type) {
        case 0x0001: obj.dspace = parse_dspace(b, body, s); obj.has_dspace = true; break;
        case 0x0003: { u64 m = body; obj.dtype = parse_dtype(b, m); break; }
        case 0x0006: parse_link_msg(b, body, s, obj); break;
        case 0x0008: parse_layout_msg(b, body, s, obj); break;
        case 0x000B: parse_filter_msg(b, body, obj); break;
        case 0x000C: parse_attr_msg(b, body, s, obj); break;
        case 0x0010: {
            u64 coff = rdoff(b, body, s);
            u64 clen = rdlen(b, body + s.sizeoff, s);
            continuations.emplace_back(coff, clen);
            break;
        }
        case 0x0011:
            obj.btree = rdoff(b, body, s);
            obj.heap = rdoff(b, body + s.sizeoff, s);
            break;
        default: break;
    }
}

void parse_messages_v1(const Buf& b, const Super& s, u64 off, u64 span, Object& obj,
                       std::vector<std::pair<u64, u64>>& continuations) {
    u64 end = off + span;
    while (off + 8 <= end) {
        u16 type = b.u16_(off);
        u16 size = b.u16_(off + 2);
        u64 body = off + 8;
        if (body + size > end) break;
        parse_one_msg(b, s, type, body, obj, continuations);
        off = body + size;
    }
}

Object read_object_header(const Buf& b, const Super& s, u64 addr) {
    Object obj;
    std::vector<std::pair<u64, u64>> continuations;
    addr += s.base;
    u8 v = b.u8_(addr);
    if (v == 1) {
        u64 hsize = b.u32_(addr + 8);
        parse_messages_v1(b, s, addr + 16, hsize, obj, continuations);
        for (size_t i = 0; i < continuations.size(); i++) {
            parse_messages_v1(b, s, continuations[i].first + s.base,
                              continuations[i].second, obj, continuations);
        }
    } else if (memcmp(b.at(addr, 4), "OHDR", 4) == 0) {
        // version 2 object header
        u8 flags = b.u8_(addr + 5);
        u64 m = addr + 6;
        if (flags & 0x20) m += 16;                // access/mod/change/birth times
        if (flags & 0x10) m += 4;                 // max compact / min dense attrs
        int csz = 1 << (flags & 0x03);
        u64 chunk0 = b.get(m, csz); m += csz;
        u64 end = m + chunk0;
        bool track_order = (flags & 0x04) != 0;
        // messages: type(1), size(2), flags(1), [creation order(2)]
        std::vector<std::pair<u64, u64>> conts;   // (start,end) of v2 blocks
        conts.emplace_back(m, end);
        for (size_t ci = 0; ci < conts.size(); ci++) {
            u64 o = conts[ci].first, e = conts[ci].second;
            while (o + 4 <= e) {
                u8 type = b.u8_(o);
                u16 size = b.u16_(o + 1);
                o += 4;
                if (track_order) o += 2;
                if (o + size > e) break;
                if (type == 0x10) {
                    u64 coff = rdoff(b, o, s) + s.base;
                    u64 clen = rdlen(b, o + s.sizeoff, s);
                    // continuation block v2: "OCHK" + messages + 4-byte checksum
                    if (clen > 8 && memcmp(b.at(coff, 4), "OCHK", 4) == 0)
                        conts.emplace_back(coff + 4, coff + clen - 4);
                } else {
                    std::vector<std::pair<u64, u64>> dummy;
                    parse_one_msg(b, s, type, o, obj, dummy);
                    for (auto& d : dummy) {
                        u64 coff = d.first + s.base;
                        if (memcmp(b.at(coff, 4), "OCHK", 4) == 0)
                            conts.emplace_back(coff + 4, coff + d.second - 4);
                    }
                }
                o += size;
            }
        }
    } else {
        throw ParseError("unsupported object header");
    }
    return obj;
}

// ---------------------------------------------------------------------------
// Group traversal (v1 symbol tables + v2 link messages)
// ---------------------------------------------------------------------------

std::string heap_name(const Buf& b, const Super& s, u64 heap_addr, u64 name_off) {
    u64 h = heap_addr + s.base;
    if (memcmp(b.at(h, 4), "HEAP", 4) != 0) throw ParseError("bad local heap");
    u64 data = rdoff(b, h + 8 + 2 * s.sizelen, s) + s.base;
    const char* nm = (const char*)b.at(data + name_off, 1);
    return std::string(nm, strnlen(nm, b.n - (data + name_off)));
}

// search a v1 group btree for a child named `want`; returns header address or UNDEF
u64 btree_find(const Buf& b, const Super& s, u64 btree_addr, u64 heap_addr,
               const std::string& want) {
    u64 t = btree_addr + s.base;
    if (memcmp(b.at(t, 4), "TREE", 4) != 0) throw ParseError("bad btree");
    int level = b.u8_(t + 5);
    int used = b.u16_(t + 6);
    u64 m = t + 8 + 2 * s.sizeoff;   // skip siblings
    // keys/children: key0 child0 key1 child1 ... key_used
    m += s.sizelen;                   // key0
    for (int i = 0; i < used; i++) {
        u64 child = rdoff(b, m, s); m += s.sizeoff;
        m += s.sizelen;               // key_{i+1}
        if (level > 0) {
            u64 r = btree_find(b, s, child, heap_addr, want);
            if (r != UNDEF) return r;
        } else {
            u64 snod = child + s.base;
            if (memcmp(b.at(snod, 4), "SNOD", 4) != 0) throw ParseError("bad SNOD");
            int nsym = b.u16_(snod + 6);
            u64 e = snod + 8;
            for (int k = 0; k < nsym; k++) {
                u64 name_off = rdoff(b, e, s);
                u64 hdr = rdoff(b, e + s.sizeoff, s);
                if (heap_name(b, s, heap_addr, name_off) == want) return hdr;
                e += 2 * s.sizeoff + 4 + 4 + 16;
            }
        }
    }
    return UNDEF;
}

u64 find_child(const Buf& b, const Super& s, const Object& grp, const std::string& name) {
    if (grp.btree != UNDEF && grp.heap != UNDEF)
        return btree_find(b, s, grp.btree, grp.heap, name);
    for (auto& l : grp.links)
        if (l.first == name) return l.second;
    return UNDEF;
}

// resolve a slash path from the root; returns object-header address or UNDEF
u64 resolve_path(const Buf& b, const Super& s, const char* path) {
    u64 cur = s.root_header;
    std::string p(path);
    size_t i = 0;
    while (i < p.size()) {
        while (i < p.size() && p[i] == '/') i++;
        if (i >= p.size()) break;
        size_t j = p.find('/', i);
        if (j == std::string::npos) j = p.size();
        std::string comp = p.substr(i, j - i);
        Object grp = read_object_header(b, s, cur);
        cur = find_child(b, s, grp, comp);
        if (cur == UNDEF) return UNDEF;
        i = j;
    }
    return cur;
}

// ---------------------------------------------------------------------------
// Dataset reading (contiguous / chunked+deflate+shuffle)
// ---------------------------------------------------------------------------

void unshuffle(std::vector<u8>& data, u32 elem) {
    if (elem <= 1 || data.size() % elem) return;
    u64 cnt = data.size() / elem;
    std::vector<u8> out(data.size());
    for (u32 e = 0; e < elem; e++)
        for (u64 i = 0; i < cnt; i++)
            out[i * elem + e] = data[e * cnt + i];
    data.swap(out);
}

bool inflate_buf(const u8* src, u64 srclen, std::vector<u8>& dst) {
#ifndef NO_LIBDEFLATE
    // libdeflate decompresses ~2-3x zlib's speed; the output size is
    // exactly known (HDF5 chunk byte count), which is its required mode.
    thread_local struct LD {
        libdeflate_decompressor* d = nullptr;
        ~LD() { if (d) libdeflate_free_decompressor(d); }
    } ld;
    if (ld.d == nullptr) ld.d = libdeflate_alloc_decompressor();
    if (ld.d != nullptr) {
        size_t got = 0;
        libdeflate_result r = libdeflate_zlib_decompress(
            ld.d, src, srclen, dst.data(), dst.size(), &got);
        if (r == LIBDEFLATE_SUCCESS && got == dst.size())
            return true;
        // Anything else — BAD_DATA, INSUFFICIENT_SPACE, or a legitimately
        // SHORT output (the zlib path below accepts Z_STREAM_END with
        // leftover avail_out, so a short chunk must not fail here; ADVICE
        // r4) — falls through to zlib as the semantics-defining backend.
    }
#endif
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return false;
    zs.next_in = const_cast<u8*>(src);
    zs.avail_in = (uInt)srclen;
    zs.next_out = dst.data();
    zs.avail_out = (uInt)dst.size();
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return rc == Z_STREAM_END || (rc == Z_OK && zs.avail_out == 0);
}

void decode_chunk(const Buf& b, const Super& s, const Object& obj,
                  u64 addr, u64 stored, u32 fmask,
                  std::vector<u8>& out, u64 dst_off, u64 chunk_bytes,
                  u64 total_bytes);

// walk a v1 chunk btree, copying decompressed chunks into `out`
void read_chunks(const Buf& b, const Super& s, const Object& obj, u64 node_addr,
                 std::vector<u8>& out, u64 total_bytes) {
    u64 t = node_addr + s.base;
    if (memcmp(b.at(t, 4), "TREE", 4) != 0) throw ParseError("bad chunk btree");
    int level = b.u8_(t + 5);
    int used = b.u16_(t + 6);
    int nd = (int)obj.chunk_dims.size();       // ndims+1 (elem size last)
    u64 keysz = 4 + 4 + 8ULL * nd;
    u64 m = t + 8 + 2 * s.sizeoff;
    u32 elem = obj.chunk_dims.back();
    u64 chunk_rows = 1;
    for (int i = 0; i + 1 < nd; i++) chunk_rows *= obj.chunk_dims[i];
    u64 chunk_bytes = chunk_rows * elem;

    for (int i = 0; i < used; i++) {
        u64 key = m;                            // key i
        u64 child = rdoff(b, m + keysz, s);
        m += keysz + s.sizeoff;
        if (level > 0) {
            read_chunks(b, s, obj, child, out, total_bytes);
            continue;
        }
        u32 stored = b.u32_(key);
        u32 fmask = b.u32_(key + 4);
        // chunk offset in dataset space (first dim only — FAST5 data is 1-D)
        u64 off0 = b.u64_(key + 8);
        decode_chunk(b, s, obj, child, stored, fmask, out, off0 * elem,
                     chunk_bytes, total_bytes);
    }
}

// decode one filtered/unfiltered chunk into out[dst_off : dst_off+want]
void decode_chunk(const Buf& b, const Super& s, const Object& obj,
                  u64 addr, u64 stored, u32 fmask,
                  std::vector<u8>& out, u64 dst_off, u64 chunk_bytes,
                  u64 total_bytes) {
    if (dst_off >= total_bytes) return;
    u64 want = std::min(chunk_bytes, total_bytes - dst_off);
    const u8* src = b.at(addr + s.base, stored);
    std::vector<u8> tmp(chunk_bytes);
    bool deflated = false, shuffled = false;
    for (size_t fi = 0; fi < obj.filters.size(); fi++) {
        if ((fmask >> fi) & 1) continue;
        if (obj.filters[fi].id == 1) deflated = true;
        if (obj.filters[fi].id == 2) shuffled = true;
    }
    if (deflated) {
        if (!inflate_buf(src, stored, tmp)) throw ParseError("inflate failed");
    } else {
        if (stored > chunk_bytes) throw ParseError("chunk too large");
        memcpy(tmp.data(), src, stored);
    }
    if (shuffled) unshuffle(tmp, obj.chunk_dims.back());
    memcpy(out.data() + dst_off, tmp.data(), want);
}

// v4 fixed-array index ("FAHD" header + "FADB" data block), non-paged
void read_fixed_array(const Buf& b, const Super& s, const Object& obj,
                      std::vector<u8>& out, u64 chunk_bytes, u64 total_bytes) {
    u64 h = obj.data_addr + s.base;
    if (memcmp(b.at(h, 4), "FAHD", 4) != 0) throw ParseError("bad fixed array");
    int client = b.u8_(h + 5);                  // 0 = chunks, 1 = filtered chunks
    int entry_size = b.u8_(h + 6);
    int page_bits = b.u8_(h + 7);
    u64 nentries = rdlen(b, h + 8, s);
    u64 db = rdoff(b, h + 8 + s.sizelen, s) + s.base;
    if (memcmp(b.at(db, 4), "FADB", 4) != 0) throw ParseError("bad FA data block");
    u64 m = db + 6 + s.sizeoff;                 // sig+ver+client+header addr
    if (nentries > (1ULL << page_bits))
        throw ParseError("paged fixed array unsupported");
    for (u64 i = 0; i < nentries; i++) {
        u64 addr = rdoff(b, m, s);
        u64 stored = chunk_bytes;
        u32 fmask = 0;
        if (client == 1) {
            int szlen = entry_size - s.sizeoff - 4;
            stored = b.get(m + s.sizeoff, szlen);
            fmask = b.u32_(m + s.sizeoff + szlen);
        }
        m += entry_size;
        if (addr == UNDEF || addr + s.base >= b.n) continue;
        decode_chunk(b, s, obj, addr, stored, fmask, out,
                     i * chunk_bytes, chunk_bytes, total_bytes);
    }
}

// read full dataset raw bytes (row-major, element size = dtype size)
std::vector<u8> read_dataset(const Buf& b, const Super& s, const Object& obj) {
    u64 nbytes = obj.dspace.npoints() * obj.dtype.size;
    std::vector<u8> out(nbytes);
    if (obj.layout_class == 1) {                 // contiguous
        if (obj.data_addr == UNDEF) return out;  // unallocated → zeros
        memcpy(out.data(), b.at(obj.data_addr + s.base, nbytes), nbytes);
    } else if (obj.layout_class == 2) {          // chunked
        if (obj.data_addr == UNDEF) return out;
        u32 elem = obj.chunk_dims.back();
        u64 chunk_rows = 1;
        for (size_t i = 0; i + 1 < obj.chunk_dims.size(); i++)
            chunk_rows *= obj.chunk_dims[i];
        u64 chunk_bytes = chunk_rows * elem;
        switch (obj.chunk_index) {
            case 0:                              // v1 btree
                read_chunks(b, s, obj, obj.data_addr, out, nbytes);
                break;
            case 1: {                            // single chunk
                u64 stored = obj.single_chunk_size ? obj.single_chunk_size
                                                   : chunk_bytes;
                decode_chunk(b, s, obj, obj.data_addr, stored, 0, out, 0,
                             chunk_bytes, nbytes);
                break;
            }
            case 2: {                            // implicit: contiguous chunks
                u64 nchunks = (nbytes + chunk_bytes - 1) / chunk_bytes;
                for (u64 i = 0; i < nchunks; i++)
                    decode_chunk(b, s, obj, obj.data_addr + i * chunk_bytes,
                                 chunk_bytes, 0, out, i * chunk_bytes,
                                 chunk_bytes, nbytes);
                break;
            }
            case 3:                              // fixed array
                read_fixed_array(b, s, obj, out, chunk_bytes, nbytes);
                break;
            default:
                throw ParseError("unsupported chunk index type");
        }
    } else if (obj.layout_class == 0) {          // compact
        memcpy(out.data(), b.at(obj.compact_off, obj.data_size),
               std::min(nbytes, obj.data_size));
    } else {
        throw ParseError("no layout");
    }
    return out;
}

// ---------------------------------------------------------------------------
// Attribute value extraction
// ---------------------------------------------------------------------------

std::string attr_string(const Buf& b, const Super& s, const Attr& a) {
    if (a.dtype.cls == 3) {
        const char* v = (const char*)b.at(a.data_off, a.dtype.size);
        return std::string(v, strnlen(v, a.dtype.size));
    }
    if (a.dtype.cls == 9 && a.dtype.vlen_string) {
        u32 len = b.u32_(a.data_off);
        u64 gcol = rdoff(b, a.data_off + 4, s) + s.base;
        u32 idx = b.u32_(a.data_off + 4 + s.sizeoff);
        if (memcmp(b.at(gcol, 4), "GCOL", 4) != 0) throw ParseError("bad global heap");
        u64 m = gcol + 8 + s.sizelen;
        u64 end = gcol + rdlen(b, gcol + 8, s);
        while (m + 8 + s.sizelen <= end) {
            u16 oi = b.u16_(m);
            u64 osz = rdlen(b, m + 8, s);
            u64 data = m + 8 + s.sizelen;
            if (oi == idx) {
                const char* v = (const char*)b.at(data, osz);
                return std::string(v, std::min<u64>(len, osz));
            }
            if (oi == 0) break;
            m = data + ((osz + 7) / 8) * 8;
        }
        throw ParseError("global heap object not found");
    }
    throw ParseError("attribute is not a string");
}

int64_t attr_int(const Buf& b, const Attr& a) {
    if (a.dtype.cls != 0) throw ParseError("attribute is not an integer");
    u64 raw = b.get(a.data_off, (int)a.dtype.size);
    if (a.dtype.signed_ && a.dtype.size < 8) {
        u64 sign = 1ULL << (8 * a.dtype.size - 1);
        if (raw & sign) raw |= ~((sign << 1) - 1);
    }
    return (int64_t)raw;
}

const Attr* find_attr(const Object& o, const char* name) {
    for (auto& a : o.attrs)
        if (a.name == name) return &a;
    return nullptr;
}

// ---------------------------------------------------------------------------
// Corrected-read extraction (the detect ingest payload)
// ---------------------------------------------------------------------------

struct CorrectedRead {
    bool ok = false;
    std::string err;
    std::string chrom;
    int64_t map_start = 0;
    char strand = '+';
    // column arrays, length n
    std::vector<double> norm_mean, norm_stdev;
    std::vector<u32> ev_start, ev_length;
    std::vector<char> base;
};

void extract_field(const std::vector<u8>& rows, u64 n, u32 stride,
                   const Member& m, double* out) {
    for (u64 i = 0; i < n; i++) {
        const u8* p = rows.data() + i * stride + m.offset;
        if (m.cls == 1 && m.size == 8) { double v; memcpy(&v, p, 8); out[i] = v; }
        else if (m.cls == 1 && m.size == 4) { float v; memcpy(&v, p, 4); out[i] = v; }
        else if (m.cls == 0) {
            u64 raw = 0;
            for (u32 k = 0; k < m.size && k < 8; k++) raw |= (u64)p[k] << (8 * k);
            out[i] = (double)raw;
        }
    }
}

CorrectedRead parse_corrected(const u8* data, u64 size) {
    CorrectedRead r;
    try {
        Buf b{data, size};
        Super s = read_superblock(b);
        u64 al_addr = resolve_path(
            b, s, "Analyses/NanomoCorrected_000/BaseCalled_template/Alignment");
        u64 ev_addr = resolve_path(
            b, s, "Analyses/NanomoCorrected_000/BaseCalled_template/Events");
        if (al_addr == UNDEF || ev_addr == UNDEF) {
            r.err = "no corrected group";
            return r;
        }
        Object al = read_object_header(b, s, al_addr);
        const Attr* ac = find_attr(al, "mapped_chrom");
        const Attr* as = find_attr(al, "mapped_start");
        const Attr* at = find_attr(al, "mapped_strand");
        if (!ac || !as || !at) { r.err = "missing mapping attrs"; return r; }
        r.chrom = attr_string(b, s, *ac);
        r.map_start = attr_int(b, *as);
        std::string st = attr_string(b, s, *at);
        r.strand = st.empty() ? '+' : st[0];

        Object ev = read_object_header(b, s, ev_addr);
        if (ev.dtype.cls != 6 || !ev.has_dspace) { r.err = "bad events dataset"; return r; }
        u64 n = ev.dspace.npoints();
        std::vector<u8> rows = read_dataset(b, s, ev);
        u32 stride = ev.dtype.size;

        r.norm_mean.resize(n); r.norm_stdev.resize(n);
        r.ev_start.resize(n); r.ev_length.resize(n); r.base.resize(n);
        std::vector<double> tmp(n);
        for (auto& m : ev.dtype.members) {
            if (m.name == "norm_mean") extract_field(rows, n, stride, m, r.norm_mean.data());
            else if (m.name == "norm_stdev") extract_field(rows, n, stride, m, r.norm_stdev.data());
            else if (m.name == "start") {
                extract_field(rows, n, stride, m, tmp.data());
                for (u64 i = 0; i < n; i++) r.ev_start[i] = (u32)tmp[i];
            } else if (m.name == "length") {
                extract_field(rows, n, stride, m, tmp.data());
                for (u64 i = 0; i < n; i++) r.ev_length[i] = (u32)tmp[i];
            } else if (m.name == "base") {
                for (u64 i = 0; i < n; i++)
                    r.base[i] = (char)rows[i * stride + m.offset];
            }
        }
        r.ok = true;
    } catch (const std::exception& e) {
        r.err = e.what();
        r.ok = false;
    }
    return r;
}

CorrectedRead parse_corrected_file(const char* path) {
    CorrectedRead r;
    FILE* f = fopen(path, "rb");
    if (!f) { r.err = "cannot open"; return r; }
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<u8> buf(sz > 0 ? sz : 0);
    if (sz > 0 && fread(buf.data(), 1, sz, f) != (size_t)sz) {
        fclose(f);
        r.err = "short read";
        return r;
    }
    fclose(f);
    return parse_corrected(buf.data(), buf.size());
}

// ---------------------------------------------------------------------------
// Raw-read prepare (the Annotate ingest payload): parse raw signal +
// basecall tables, extract per-base events (albacore1/2 + guppy dialects,
// ref myRefBaseSignalAnnotation.py:141-310) and apply the median/MAD
// normalization (ref :245-259) — the native fast path for
// resquiggle/pipeline.prepare_batch.  signal/events.py and
// signal/normalize.py are the Python specification; outputs match
// bit-for-bit (np.median two-middle averaging, np.round half-even).
// ---------------------------------------------------------------------------

void btree_children(const Buf& b, const Super& s, u64 btree_addr,
                    u64 heap_addr,
                    std::vector<std::pair<std::string, u64>>& out) {
    u64 t = btree_addr + s.base;
    if (memcmp(b.at(t, 4), "TREE", 4) != 0) throw ParseError("bad btree");
    int level = b.u8_(t + 5);
    int used = b.u16_(t + 6);
    u64 m = t + 8 + 2 * s.sizeoff + s.sizelen;
    for (int i = 0; i < used; i++) {
        u64 child = rdoff(b, m, s); m += s.sizeoff + s.sizelen;
        if (level > 0) {
            btree_children(b, s, child, heap_addr, out);
        } else {
            u64 snod = child + s.base;
            if (memcmp(b.at(snod, 4), "SNOD", 4) != 0) throw ParseError("bad SNOD");
            int nsym = b.u16_(snod + 6);
            u64 e = snod + 8;
            for (int k = 0; k < nsym; k++) {
                u64 name_off = rdoff(b, e, s);
                u64 hdr = rdoff(b, e + s.sizeoff, s);
                out.emplace_back(heap_name(b, s, heap_addr, name_off), hdr);
                e += 2 * s.sizeoff + 4 + 4 + 16;
            }
        }
    }
}

std::vector<std::pair<std::string, u64>> list_children(
        const Buf& b, const Super& s, const Object& grp) {
    std::vector<std::pair<std::string, u64>> out;
    if (grp.btree != UNDEF && grp.heap != UNDEF)
        btree_children(b, s, grp.btree, grp.heap, out);
    for (auto& l : grp.links) out.push_back(l);
    std::sort(out.begin(), out.end());
    return out;
}

double attr_double(const Buf& b, const Attr& a) {
    if (a.dtype.cls == 1) {
        if (a.dtype.size == 8) { double v; memcpy(&v, b.at(a.data_off, 8), 8); return v; }
        if (a.dtype.size == 4) { float v; memcpy(&v, b.at(a.data_off, 4), 4); return (double)v; }
    }
    if (a.dtype.cls == 0) return (double)attr_int(b, a);
    throw ParseError("attribute is not numeric");
}

std::string global_heap_string(const Buf& b, const Super& s, u64 data_off) {
    u32 len = b.u32_(data_off);
    u64 gcol = rdoff(b, data_off + 4, s) + s.base;
    u32 idx = b.u32_(data_off + 4 + s.sizeoff);
    if (memcmp(b.at(gcol, 4), "GCOL", 4) != 0) throw ParseError("bad global heap");
    u64 m = gcol + 8 + s.sizelen;
    u64 end = gcol + rdlen(b, gcol + 8, s);
    while (m + 8 + s.sizelen <= end) {
        u16 oi = b.u16_(m);
        u64 osz = rdlen(b, m + 8, s);
        u64 data = m + 8 + s.sizelen;
        if (oi == idx) {
            const char* v = (const char*)b.at(data, osz);
            return std::string(v, std::min<u64>(len, osz));
        }
        if (oi == 0) break;
        m = data + ((osz + 7) / 8) * 8;
    }
    throw ParseError("global heap object not found");
}

// whole-dataset string (fixed-length scalar or vlen scalar)
std::string dataset_string(const Buf& b, const Super& s, const Object& obj) {
    std::vector<u8> raw = read_dataset(b, s, obj);
    if (obj.dtype.cls == 3) {
        const char* v = (const char*)raw.data();
        return std::string(v, strnlen(v, raw.size()));
    }
    if (obj.dtype.cls == 9 && obj.dtype.vlen_string) {
        // scalar vlen: the (len, heap addr, idx) triple lives at the data
        // location; resolve it against the file buffer
        if (obj.layout_class == 1 && obj.data_addr != UNDEF)
            return global_heap_string(b, s, obj.data_addr + s.base);
        if (obj.layout_class == 0)
            return global_heap_string(b, s, obj.compact_off);
        throw ParseError("unsupported vlen dataset layout");
    }
    throw ParseError("dataset is not a string");
}

struct RawPrepared {
    int err = 0;                  // 0 ok, 1..8 taxonomy, 9 = python fallback
    std::string id_line;          // fastq header line (sans '@')
    std::string seq;              // one base per event
    std::vector<int64_t> ev_start, ev_length;
    std::vector<double> norm_signal;
};

// error taxonomy codes (see prepare_bind.py PREP_ERRORS)
enum {
    E_OK = 0, E_OPEN = 1, E_CHANNEL = 2, E_RAWSIG = 3, E_FASTQ = 4,
    E_EVENTS = 5, E_TRIM_LEFT = 6, E_TRIM_RIGHT = 7, E_FIRST_INDEX = 8,
    E_FALLBACK = 9, E_NANOCORR = 10,
};

inline double round_dec(double x, double scale) {
    return std::nearbyint(x * scale) / scale;
}

// numpy pairwise summation (see annotate_core.cpp) — exact np.sum order
template <typename F>
double pw_sum(F f, int64_t off, int64_t n) {
    if (n < 8) {
        double res = 0.0;
        for (int64_t i = 0; i < n; ++i) res += f(off + i);
        return res;
    } else if (n <= 128) {
        double r[8];
        for (int j = 0; j < 8; ++j) r[j] = f(off + j);
        int64_t i;
        for (i = 8; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += f(off + i + j);
        double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                     ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += f(off + i);
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pw_sum(f, off, n2) + pw_sum(f, off + n2, n - n2);
}

// 5-mer code (A=0 C=1 G=2 T=3, first char most significant); -1 = non-ACGT
inline int kmer5_code(const char* s) {
    int code = 0;
    for (int i = 0; i < 5; i++) {
        char c = s[i];
        int v;
        if (c == 'A' || c == 'a') v = 0;
        else if (c == 'C' || c == 'c') v = 1;
        else if (c == 'G' || c == 'g') v = 2;
        else if (c == 'T' || c == 't') v = 3;
        else return -1;
        code = code * 4 + v;
    }
    return code;
}

// weighted 2x2 least-squares shift/scale (ref get_cur_shift_scale :86-113;
// Python spec signal/normalize.kmer_shift_scale).  Sums use numpy pairwise
// order; the solve replicates LAPACK dgesv's partial-pivot LU on 2x2.
// Returns false on singular (-> "Cannot nanopore correction").
bool kmer_shift_scale_native(const std::vector<double>& means,
                             const std::vector<double>& levels,
                             const std::vector<double>& weights,
                             double* shift, double* scale) {
    int64_t n = (int64_t)means.size();
    double sw = pw_sum([&](int64_t i) { return weights[i]; }, 0, n);
    double swm = pw_sum([&](int64_t i) { return weights[i] * levels[i]; },
                        0, n);
    double swmm = pw_sum(
        [&](int64_t i) { return (weights[i] * levels[i]) * levels[i]; },
        0, n);
    double swe = pw_sum([&](int64_t i) { return means[i] * weights[i]; },
                        0, n);
    double swem = pw_sum(
        [&](int64_t i) { return (means[i] * weights[i]) * levels[i]; },
        0, n);
    // solve [[sw, swm], [swm, swmm]] x = [swe, swem]
    double a11 = sw, a12 = swm, a21 = swm, a22 = swmm, b1 = swe, b2 = swem;
    bool swap = std::fabs(a21) > std::fabs(a11);
    if (swap) {
        std::swap(a11, a21);
        std::swap(a12, a22);
        std::swap(b1, b2);
    }
    if (a11 == 0.0) return false;
    double l = a21 / a11;
    double u22 = a22 - l * a12;
    if (u22 == 0.0) return false;
    double x2 = (b2 - l * b1) / u22;
    double x1 = (b1 - a12 * x2) / a11;
    *shift = x1;
    *scale = x2;
    return true;
}

// np.median on a scratch copy (partial sort; even n averages two middles)
double median_of(std::vector<double>& scratch) {
    size_t n = scratch.size();
    if (n == 0) return 0.0;
    size_t h = n / 2;
    std::nth_element(scratch.begin(), scratch.begin() + h, scratch.end());
    double hi = scratch[h];
    if (n % 2 == 1) return hi;
    double lo = *std::max_element(scratch.begin(), scratch.begin() + h);
    return (lo + hi) / 2.0;
}

// mnormalized (ref :245-259): stats over [lo,hi), transform whole array,
// winsorize at ±5 MAD, round to 3 decimals.  nth_element path — used when
// the raw values are not small-range integers (k-mer-calibrated signal).
void mad_normalize_sel(std::vector<double>& raw, int64_t lo, int64_t hi) {
    std::vector<double> scratch(raw.begin() + lo, raw.begin() + hi);
    double mshift = median_of(scratch);
    for (auto& v : scratch) v = std::fabs(v - mshift);
    double mscale = median_of(scratch);
    for (auto& v : raw) v = (v - mshift) / mscale;
    scratch.assign(raw.begin() + lo, raw.begin() + hi);
    double med = median_of(scratch);
    for (auto& v : scratch) v = std::fabs(v - med);
    double mad = median_of(scratch);
    double cl = med - 5.0 * mad, ch = med + 5.0 * mad;
    for (auto& v : raw) {
        if (v < cl) v = cl;
        else if (v > ch) v = ch;
        v = round_dec(v, 1000.0);
    }
}

// np.median over a value-ascending (value, count) multiset: walk the
// cumulative counts to the middle element(s); even n averages the two
// middles exactly like np.median over the expanded array.
double median_from_pairs(const std::vector<std::pair<double, int64_t>>& ps,
                         int64_t total) {
    int64_t i_lo = (total - 1) / 2, i_hi = total / 2;   // equal when odd
    double v_lo = 0.0, v_hi = 0.0;
    int64_t c = 0;
    for (const auto& p : ps) {
        int64_t c2 = c + p.second;
        if (c <= i_lo && i_lo < c2) v_lo = p.first;
        if (c <= i_hi && i_hi < c2) { v_hi = p.first; break; }
        c = c2;
    }
    return (v_lo + v_hi) / 2.0;
}

// Integer-domain mad_normalize: raw DAC values are exact small-range
// integers (int16/int32 ADC counts), so every median reduces to a walk of
// one value histogram — O(n) instead of four nth_element passes, which
// dominated the prepare CPU (gprof: 81% in median_of).  Bit-identical to
// mad_normalize_sel / the Python spec: medians select the same elements
// (the transform is order-preserving), and every derived quantity is
// computed with the same fp expressions, in the same order, as the
// whole-array path.  Falls back to the selection path when values are
// non-integral or the range exceeds 1<<17.
void mad_normalize(std::vector<double>& raw, int64_t lo, int64_t hi,
                   bool int_domain = true) {
    int64_t n = hi - lo;
    if (!int_domain || n <= 0) { mad_normalize_sel(raw, lo, hi); return; }
    double dmin = raw[lo], dmax = raw[lo];
    bool ints = true;
    for (int64_t i = lo; i < hi; i++) {
        double v = raw[i];
        if (v != std::floor(v)) { ints = false; break; }
        if (v < dmin) dmin = v;
        if (v > dmax) dmax = v;
    }
    if (!ints || dmax - dmin > (double)(1 << 17)) {
        mad_normalize_sel(raw, lo, hi);
        return;
    }
    int64_t base = (int64_t)dmin, width = (int64_t)dmax - base + 1;
    thread_local std::vector<int64_t> hist;
    if ((int64_t)hist.size() < width) hist.resize(width);
    std::fill(hist.begin(), hist.begin() + width, 0);
    for (int64_t i = lo; i < hi; i++) hist[(int64_t)raw[i] - base]++;
    std::vector<std::pair<double, int64_t>> vals;   // ascending by value
    vals.reserve(256);
    for (int64_t b = 0; b < width; b++)
        if (hist[b]) vals.emplace_back((double)(base + b), hist[b]);
    double mshift = median_from_pairs(vals, n);
    // round 1 MAD: |v - mshift|, same expression as the array path
    std::vector<std::pair<double, int64_t>> dev(vals.size());
    for (size_t i = 0; i < vals.size(); i++)
        dev[i] = {std::fabs(vals[i].first - mshift), vals[i].second};
    std::sort(dev.begin(), dev.end());
    double mscale = median_from_pairs(dev, n);
    // round 2 median: the normalization (v - mshift) / mscale is
    // monotone, so the middle elements are the same; transform only them
    // (bit-equal to transforming all, then selecting)
    for (auto& p : vals) p.first = (p.first - mshift) / mscale;
    double med = median_from_pairs(vals, n);
    for (size_t i = 0; i < vals.size(); i++)
        dev[i] = {std::fabs(vals[i].first - med), vals[i].second};
    std::sort(dev.begin(), dev.end());
    double mad = median_from_pairs(dev, n);
    double cl = med - 5.0 * mad, ch = med + 5.0 * mad;
    for (auto& v : raw) {
        v = (v - mshift) / mscale;
        if (v < cl) v = cl;
        else if (v > ch) v = ch;
        v = round_dec(v, 1000.0);
    }
}

struct EventCols {
    std::vector<double> mean, stdv, start, length;
    std::vector<double> move;
    std::vector<char> center;      // model_state[2]
    std::vector<int> kcode;        // 5-mer code of model_state (-1 non-ACGT)
    u64 n = 0;
};

bool load_event_table(const Buf& b, const Super& s, const Object& ev,
                      EventCols& c, bool want_model) {
    if (ev.dtype.cls != 6 || !ev.has_dspace) return false;
    u64 n = ev.dspace.npoints();
    std::vector<u8> rows = read_dataset(b, s, ev);
    u32 stride = ev.dtype.size;
    c.n = n;
    bool has_move = false, has_start = false, has_len = false, has_state = false;
    bool has_mean = false;
    for (auto& m : ev.dtype.members) {
        if (m.name == "move") {
            c.move.resize(n); extract_field(rows, n, stride, m, c.move.data());
            has_move = true;
        } else if (m.name == "start") {
            c.start.resize(n); extract_field(rows, n, stride, m, c.start.data());
            has_start = true;
        } else if (m.name == "length") {
            c.length.resize(n); extract_field(rows, n, stride, m, c.length.data());
            has_len = true;
        } else if (m.name == "mean" && want_model) {
            c.mean.resize(n); extract_field(rows, n, stride, m, c.mean.data());
            has_mean = true;
        } else if (m.name == "model_state") {
            c.center.resize(n);
            if (want_model) c.kcode.resize(n);
            for (u64 i = 0; i < n; i++) {
                const char* st = (const char*)rows.data() + i * stride + m.offset;
                c.center[i] = st[2];
                if (want_model)
                    c.kcode[i] = m.size >= 5 ? kmer5_code(st) : -1;
            }
            has_state = true;
        }
    }
    if (want_model && !has_mean) return false;
    return has_move && has_start && has_len && has_state;
}

RawPrepared parse_raw(const u8* data, u64 size, const char* bc1d,
                      const char* bc2s, const double* model_levels,
                      const double* model_invvars) {
    RawPrepared r;
    try {
        Buf b{data, size};
        Super s = read_superblock(b);

        // channel info (sampling_rate used by the albacore1 dialect)
        u64 ch_addr = resolve_path(b, s, "UniqueGlobalKey/channel_id");
        if (ch_addr == UNDEF) { r.err = E_CHANNEL; return r; }
        Object ch = read_object_header(b, s, ch_addr);
        double sampling_rate = 0.0;
        if (const Attr* a = find_attr(ch, "sampling_rate"))
            sampling_rate = attr_double(b, *a);

        // raw signal: first (name-sorted) read under Raw/Reads
        u64 rr_addr = resolve_path(b, s, "Raw/Reads");
        if (rr_addr == UNDEF) { r.err = E_RAWSIG; return r; }
        Object rr = read_object_header(b, s, rr_addr);
        auto kids = list_children(b, s, rr);
        if (kids.empty()) { r.err = E_RAWSIG; return r; }
        Object rd = read_object_header(b, s, kids[0].second);
        int64_t raw_start_time = 0;
        if (const Attr* a = find_attr(rd, "start_time"))
            raw_start_time = attr_int(b, *a);
        u64 sig_addr = find_child(b, s, rd, "Signal");
        if (sig_addr == UNDEF) { r.err = E_RAWSIG; return r; }
        Object sig = read_object_header(b, s, sig_addr);
        if (!sig.has_dspace || sig.dtype.cls != 0) { r.err = E_RAWSIG; return r; }
        u64 nsig = sig.dspace.npoints();
        std::vector<u8> sraw = read_dataset(b, s, sig);
        std::vector<double> raw(nsig);
        if (sig.dtype.size == 2) {
            for (u64 i = 0; i < nsig; i++) {
                int16_t v; memcpy(&v, sraw.data() + 2 * i, 2);
                raw[i] = (double)v;
            }
        } else if (sig.dtype.size == 4) {
            for (u64 i = 0; i < nsig; i++) {
                int32_t v; memcpy(&v, sraw.data() + 4 * i, 4);
                raw[i] = (double)v;
            }
        } else { r.err = E_FALLBACK; return r; }

        // fastq
        std::string base = std::string("Analyses/") + bc1d + "/" + bc2s;
        u64 fq_addr = resolve_path(b, s, (base + "/Fastq").c_str());
        if (fq_addr == UNDEF) { r.err = E_FASTQ; return r; }
        std::string fq = dataset_string(
            b, s, read_object_header(b, s, fq_addr));
        size_t l0 = fq.find('\n');
        if (l0 == std::string::npos) { r.err = E_FASTQ; return r; }
        size_t l1 = fq.find('\n', l0 + 1);
        if (l1 == std::string::npos) l1 = fq.size();
        r.id_line = fq.substr(fq[0] == '@' ? 1 : 0,
                              l0 - (fq[0] == '@' ? 1 : 0));
        std::string fq_seq = fq.substr(l0 + 1, l1 - l0 - 1);

        // basecaller sniffing (ref :50-63)
        std::string name, version;
        u64 bc_addr = resolve_path(b, s, (std::string("Analyses/") + bc1d).c_str());
        if (bc_addr != UNDEF) {
            Object bco = read_object_header(b, s, bc_addr);
            if (const Attr* a = find_attr(bco, "name")) name = attr_string(b, s, *a);
            if (const Attr* a = find_attr(bco, "version")) version = attr_string(b, s, *a);
        }

        if (name.find("Guppy") != std::string::npos) {
            // move table at stride 2 (ref getMove_Info :261-310)
            u64 mv_addr = resolve_path(b, s, (base + "/Move").c_str());
            if (mv_addr == UNDEF) { r.err = E_EVENTS; return r; }
            Object mv = read_object_header(b, s, mv_addr);
            std::vector<u8> mraw = read_dataset(b, s, mv);
            u64 nmv = mv.dspace.npoints();
            u32 msz = mv.dtype.size;
            std::string bcnum = std::string(bc1d);
            size_t us = bcnum.rfind('_');
            std::string seg = "Analyses/Segmentation_" +
                (us == std::string::npos ? bcnum : bcnum.substr(us + 1)) +
                "/Summary/segmentation";
            int64_t first = 0;
            u64 seg_addr = resolve_path(b, s, seg.c_str());
            if (seg_addr == UNDEF) { r.err = E_EVENTS; return r; }
            Object sego = read_object_header(b, s, seg_addr);
            if (const Attr* a = find_attr(sego, "first_sample_template"))
                first = attr_int(b, *a);
            else { r.err = E_EVENTS; return r; }
            const int stride = 2;
            std::vector<int64_t> pivots;
            pivots.push_back(first);
            for (u64 i = 1; i < nmv; i++) {
                u64 v = 0;
                for (u32 k = 0; k < msz && k < 8; k++)
                    v |= (u64)mraw[i * msz + k] << (8 * k);
                if (v == 1) pivots.push_back((int64_t)(stride * i) + first);
            }
            pivots.push_back((int64_t)nsig);
            u64 nseg = pivots.size() - 1;
            if (nseg > fq_seq.size()) nseg = fq_seq.size();
            r.ev_start.resize(nseg); r.ev_length.resize(nseg);
            for (u64 i = 0; i < nseg; i++) {
                r.ev_start[i] = pivots[i];
                r.ev_length[i] = pivots[i + 1] - pivots[i];
            }
            r.seq = fq_seq.substr(0, nseg);
        } else {
            u64 ev_addr = resolve_path(b, s, (base + "/Events").c_str());
            if (ev_addr == UNDEF) { r.err = E_EVENTS; return r; }
            EventCols c;
            bool want_model = model_levels != nullptr;
            if (!load_event_table(b, s, read_object_header(b, s, ev_addr), c,
                                  want_model)
                    || c.n == 0) {
                r.err = E_EVENTS; return r;
            }
            if (want_model) {
                // nanopolish-style calibration over ALL event rows
                // (ref get_cur_shift_scale :86-113, applied at :111)
                std::vector<double> levels(c.n), weights(c.n);
                for (u64 i = 0; i < c.n; i++) {
                    int kc = c.kcode[i];
                    if (kc < 0) { r.err = E_NANOCORR; return r; }
                    levels[i] = model_levels[kc];
                    weights[i] = model_invvars[kc];
                }
                double shift, scale;
                if (!kmer_shift_scale_native(c.mean, levels, weights,
                                             &shift, &scale)) {
                    r.err = E_NANOCORR; return r;
                }
                // true division per element (np broadcasting semantics:
                // raw/scale - shift/scale, ref normalize.py :68)
                double off2 = shift / scale;
                for (u64 i = 0; i < raw.size(); i++)
                    raw[i] = round_dec(raw[i] / scale - off2, 1e6);
            }
            int major = 0;
            if (!version.empty()) major = atoi(version.c_str());
            if (major >= 2) {
                // albacore 2.x: sample-indexed (ref :226-240)
                for (u64 i = 0; i < c.n; i++) {
                    if (i == 0 || c.move[i] > 0) {
                        r.ev_start.push_back((int64_t)c.start[i]);
                        r.ev_length.push_back((int64_t)c.length[i]);
                        r.seq.push_back(c.center[i]);
                    } else {
                        r.ev_length.back() += (int64_t)c.length[i];
                    }
                }
            } else {
                // albacore 1.x: time-indexed with move-0 trimming (ref :141-224)
                if (sampling_rate <= 0.0) { r.err = E_FALLBACK; return r; }
                int64_t lo = -1, hi = -1;
                for (u64 i = 0; i < c.n; i++)
                    if (c.move[i] > 0) { if (lo < 0) lo = i; hi = i; }
                if (lo < 0 || lo > hi - 20) { r.err = E_TRIM_LEFT; return r; }
                if (hi < lo + 20) { r.err = E_TRIM_RIGHT; return r; }
                int64_t first = (int64_t)std::nearbyint(
                    c.start[lo] * sampling_rate) - raw_start_time;
                if (first < -2) { r.err = E_FIRST_INDEX; return r; }
                if (first < 0) first = 0;
                // group by move>0 (row lo forced), sum truncated sample lengths
                std::vector<int64_t> lens;
                for (int64_t i = lo; i <= hi; i++) {
                    int64_t sl = (int64_t)(c.length[i] * sampling_rate);
                    if (i == lo || c.move[i] > 0) {
                        lens.push_back(sl);
                        r.seq.push_back(c.center[i]);
                    } else {
                        lens.back() += sl;
                    }
                }
                int64_t pos = first;
                for (auto ln : lens) {
                    r.ev_start.push_back(pos);
                    r.ev_length.push_back(ln);
                    pos += ln;
                }
            }
        }

        if (r.ev_start.empty()) { r.err = E_EVENTS; return r; }
        int64_t span_lo = r.ev_start.front();
        int64_t span_hi = r.ev_start.back() + r.ev_length.back();
        if (span_hi > (int64_t)nsig || span_lo < 0 || span_hi <= span_lo) {
            r.err = E_RAWSIG; return r;
        }
        // no k-mer calibration -> raw is untouched integer ADC counts
        mad_normalize(raw, span_lo, span_hi,
                      /*int_domain=*/model_levels == nullptr);
        r.norm_signal = std::move(raw);
        r.err = E_OK;
    } catch (const std::exception&) {
        r.err = E_FALLBACK;
    }
    return r;
}

RawPrepared parse_raw_file(const char* path, const char* bc1d,
                           const char* bc2s, const double* model_levels,
                           const double* model_invvars) {
    RawPrepared r;
    FILE* f = fopen(path, "rb");
    if (!f) { r.err = E_OPEN; return r; }
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<u8> buf(sz > 0 ? sz : 0);
    if (sz > 0 && fread(buf.data(), 1, sz, f) != (size_t)sz) {
        fclose(f);
        r.err = E_FALLBACK;
        return r;
    }
    fclose(f);
    return parse_raw(buf.data(), buf.size(), bc1d, bc2s, model_levels,
                     model_invvars);
}

// ---------------------------------------------------------------------------
// Batch API (ctypes surface)
// ---------------------------------------------------------------------------

struct Batch {
    std::vector<CorrectedRead> reads;
};

}  // namespace

extern "C" {

// Read n FAST5 files on `nthreads` threads.  Returns an opaque handle.
void* f5_batch_read(const char** paths, int64_t n, int nthreads) {
    Batch* batch = new Batch();
    batch->reads.resize(n);
    if (nthreads < 1) nthreads = 1;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            batch->reads[i] = parse_corrected_file(paths[i]);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < nthreads; t++) ts.emplace_back(worker);
    worker();
    for (auto& t : ts) t.join();
    return batch;
}

// Per-file event counts (-1 = failed/missing) into n-length array; returns
// total events over successful files.
int64_t f5_batch_sizes(void* h, int64_t* n_events) {
    Batch* b = (Batch*)h;
    int64_t total = 0;
    for (size_t i = 0; i < b->reads.size(); i++) {
        if (b->reads[i].ok) {
            n_events[i] = (int64_t)b->reads[i].norm_mean.size();
            total += n_events[i];
        } else {
            n_events[i] = -1;
        }
    }
    return total;
}

// Fill caller-allocated buffers.  Event columns are concatenated over
// successful files in order; offsets[i] gives each file's slice start
// (offsets has n+1 entries).  chroms is n*64 bytes (NUL-padded).
void f5_batch_fill(void* h, double* norm_mean, double* norm_stdev,
                   uint32_t* ev_start, uint32_t* ev_length, char* base,
                   int64_t* offsets, int64_t* map_start, char* strands,
                   char* chroms) {
    Batch* b = (Batch*)h;
    int64_t off = 0;
    for (size_t i = 0; i < b->reads.size(); i++) {
        offsets[i] = off;
        CorrectedRead& r = b->reads[i];
        map_start[i] = r.ok ? r.map_start : -1;
        strands[i] = r.ok ? r.strand : '?';
        memset(chroms + i * 64, 0, 64);
        if (!r.ok) continue;
        size_t cl = std::min<size_t>(r.chrom.size(), 63);
        memcpy(chroms + i * 64, r.chrom.data(), cl);
        int64_t n = (int64_t)r.norm_mean.size();
        memcpy(norm_mean + off, r.norm_mean.data(), n * sizeof(double));
        memcpy(norm_stdev + off, r.norm_stdev.data(), n * sizeof(double));
        memcpy(ev_start + off, r.ev_start.data(), n * sizeof(uint32_t));
        memcpy(ev_length + off, r.ev_length.data(), n * sizeof(uint32_t));
        memcpy(base + off, r.base.data(), n);
        off += n;
    }
    offsets[b->reads.size()] = off;
}

void f5_batch_free(void* h) { delete (Batch*)h; }

// --- raw-read prepare batch (Annotate ingest) ------------------------------

struct RawBatch {
    std::vector<RawPrepared> reads;
};

// model_levels/model_invvars: 1024-entry 5-mer tables (A=0..T=3, first
// char most significant) enabling nanopolish-style calibration; pass null
// to skip.
void* f5_prepare_batch(const char** paths, int64_t n, const char* bc1d,
                       const char* bc2s, const double* model_levels,
                       const double* model_invvars, int nthreads) {
    RawBatch* batch = new RawBatch();
    batch->reads.resize(n);
    if (nthreads < 1) nthreads = 1;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            batch->reads[i] = parse_raw_file(paths[i], bc1d, bc2s,
                                             model_levels, model_invvars);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < nthreads; t++) ts.emplace_back(worker);
    worker();
    for (auto& t : ts) t.join();
    return batch;
}

// per-read error code + element counts; returns 0
int64_t f5_prepare_sizes(void* h, int32_t* err, int64_t* n_ev,
                         int64_t* n_sig, int64_t* id_len) {
    RawBatch* b = (RawBatch*)h;
    for (size_t i = 0; i < b->reads.size(); i++) {
        RawPrepared& r = b->reads[i];
        err[i] = r.err;
        // failed reads contribute nothing to the concatenated buffers
        n_ev[i] = r.err == E_OK ? (int64_t)r.ev_start.size() : 0;
        n_sig[i] = r.err == E_OK ? (int64_t)r.norm_signal.size() : 0;
        id_len[i] = r.err == E_OK ? (int64_t)r.id_line.size() : 0;
    }
    return 0;
}

// fill concatenated outputs (caller computes offsets from the size arrays)
void f5_prepare_fill(void* h, double* norm_signal, int64_t* ev_start,
                     int64_t* ev_length, char* seq, char* ids) {
    RawBatch* b = (RawBatch*)h;
    u64 so = 0, eo = 0, io = 0;
    for (size_t i = 0; i < b->reads.size(); i++) {
        RawPrepared& r = b->reads[i];
        if (r.err != E_OK) continue;
        memcpy(norm_signal + so, r.norm_signal.data(),
               r.norm_signal.size() * 8);
        so += r.norm_signal.size();
        memcpy(ev_start + eo, r.ev_start.data(), r.ev_start.size() * 8);
        memcpy(ev_length + eo, r.ev_length.data(), r.ev_length.size() * 8);
        memcpy(seq + eo, r.seq.data(), r.seq.size());
        eo += r.ev_start.size();
        memcpy(ids + io, r.id_line.data(), r.id_line.size());
        io += r.id_line.size();
    }
}

void f5_prepare_free(void* h) { delete (RawBatch*)h; }

}  // extern "C"
