// Port-only source (not a copy of the reference's): a raw basecalled FAST5
// writer without libhdf5, for the scale tools on a machine with no h5py.
//
// It writes, as a whole new file, what the reference's
// tools/scale_fullchain.py gen_raw_group and tests/fixtures.py
// write_raw_fixture write with h5py:
//
//   /UniqueGlobalKey/channel_id     attrs digitisation, offset, range,
//                                   sampling_rate (f64), and where given
//                                   channel_number (variable-length ASCII)
//   /Raw/Reads/Read_<n>             attrs start_time (i64, where given) and
//                                   read_id (variable-length UTF-8)
//   /Raw/Reads/Read_<n>/Signal      int16 [samples]
//   /Analyses/<basecall group>      attrs name, version (variable-length
//                                   ASCII: h5py's type for bytes)
//   .../<template>/Events           albacore2 compound [events]: mean <f8,
//                                   stdv <f8, start <u8, length <u8,
//                                   model_state S5, move <i4 (41 bytes)
//   .../<template>/Fastq            scalar variable-length ASCII string
//
// in the layout h5py gives a file by default and the native readers and
// the corrected writer parse: superblock v0, v1 object headers, old-style
// (symbol-table) groups, contiguous datasets, one global heap collection
// for the variable-length strings.  rw_write_empty writes a file that holds
// only its root group, as h5py.File(path, "w") leaves one, for the corrected
// writer to fill.  It compiles the port's copy of
// fast5_write.cpp into the same unit and reuses its emitters (symbol
// tables, object headers, datatypes), so the seven copied sources stay
// byte-equal to the reference's.  The library is rebuilt when this file or
// fast5_write.cpp is newer than it (native/build.py _DEPS).
#include "fast5_write.cpp"

namespace {

// albacore2 basecall events ('<f8', '<f8', '<u8', '<u8', 'S5', '<i4')
const u32 RAW_EV_ITEMSIZE = 41;

void dt_i16_(std::vector<u8>& o) { dt_fixed(o, 2, true); }
void dt_u64_(std::vector<u8>& o) { dt_fixed(o, 8, false); }
void dt_i32_(std::vector<u8>& o) { dt_fixed(o, 4, true); }
void dt_s5_(std::vector<u8>& o) { dt_string(o, 5); }

void dt_albacore2_events(std::vector<u8>& o) {
    o.push_back(0x16);                      // compound v1
    o.push_back(6); o.push_back(0); o.push_back(0);   // 6 members
    for (int i = 0; i < 4; i++) o.push_back((u8)(RAW_EV_ITEMSIZE >> (8 * i)));
    compound_member(o, "mean", 0, dt_f64);
    compound_member(o, "stdv", 8, dt_f64);
    compound_member(o, "start", 16, dt_u64_);
    compound_member(o, "length", 24, dt_u64_);
    compound_member(o, "model_state", 32, dt_s5_);
    compound_member(o, "move", 37, dt_i32_);
}

// an attribute message: name, datatype, scalar dataspace, value bytes
Msg attr_msg(const char* name, const std::vector<u8>& dt, const u8* value,
             u64 vsize) {
    Msg m{0x000C, 0, {}};
    auto& o = m.body;
    u64 nlen = strlen(name) + 1;
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
    o.insert(o.end(), value, value + vsize);
    o.insert(o.end(), pad8(vsize) - vsize, 0);
    return m;
}

Msg msg_attr_scalar_f64(const char* name, double value) {
    std::vector<u8> dt; dt_f64(dt);
    u8 v[8];
    memcpy(v, &value, 8);
    return attr_msg(name, dt, v, 8);
}

// h5py's variable-length string type (an object of a global heap
// collection): UTF-8 for str values, ASCII for bytes values
std::vector<u8> dt_vlen_str(bool utf8) {
    std::vector<u8> dt = {0x19, 0x01, (u8)(utf8 ? 0x01 : 0x00), 0x00,
                          16, 0, 0, 0};     // vlen v1: string, null-terminated
    dt_fixed(dt, 1, false);                 // base: unsigned char
    return dt;
}

// a heap ID: the string's length, the collection's address, the object
void vlen_ref(u8* v, u64 len, u64 gcol, u32 index) {
    u32 l = (u32)len;
    memcpy(v, &l, 4);
    memcpy(v + 4, &gcol, 8);
    memcpy(v + 12, &index, 4);
}

Msg msg_attr_vlen_str(const char* name, bool utf8, u64 len, u64 gcol,
                      u32 index) {
    u8 v[16];
    vlen_ref(v, len, gcol, index);
    return attr_msg(name, dt_vlen_str(utf8), v, 16);
}

// a global heap collection holding `objs` as objects 1, 2, ... and then its
// free space; at least 4096 bytes, the smallest collection libhdf5 makes.
// Returns its address.
u64 emit_global_heap(WBuf& w, const std::vector<std::string>& objs) {
    u64 used = 16;                          // the collection's header
    for (auto& o : objs) used += 16 + pad8(o.size());
    const u64 size = std::max<u64>(4096, used + 16);
    w.pad_to(8);
    u64 addr = w.here();
    w.bytes("GCOL", 4); w.u8_(1); w.zeros(3);
    w.u64_(size);
    for (size_t i = 0; i < objs.size(); i++) {
        w.u16_((u16)(i + 1)); w.u16_(1); w.u32_(0);   // one reference
        w.u64_(objs[i].size());
        w.bytes(objs[i].data(), objs[i].size());
        w.zeros(pad8(objs[i].size()) - objs[i].size());
    }
    w.u16_(0); w.u16_(0); w.u32_(0);        // the free space (object 0)
    w.u64_(size - used);
    w.zeros(size - used - 16);
    return addr;
}

// a contiguous dataset: the data, then its object header; a scalar of one
// row when `scalar`, else rank 1 of `nrows` rows
u64 emit_contiguous(WBuf& w, const u8* data, u64 nrows, u32 itemsize,
                    const std::vector<u8>& dtype, bool scalar) {
    const u64 size = nrows * itemsize;
    w.pad_to(8);
    u64 data_addr = w.here();
    w.bytes(data, size);
    std::vector<Msg> msgs;
    { Msg m{0x0001, 0, {}};
      if (scalar) ds_scalar(m.body); else ds_simple1d(m.body, nrows);
      msgs.push_back(std::move(m)); }
    msgs.push_back(Msg{0x0003, 1, dtype});
    // fill value v2: late allocation, fill if set, the default value
    msgs.push_back(Msg{0x0005, 1, {0x02, 0x02, 0x02, 0x01, 0, 0, 0, 0}});
    { Msg m{0x0008, 0, {}};                 // layout v3, contiguous
      auto& o = m.body;
      o.push_back(3); o.push_back(1);
      for (int i = 0; i < 8; i++) o.push_back((u8)(data_addr >> (8 * i)));
      for (int i = 0; i < 8; i++) o.push_back((u8)(size >> (8 * i)));
      msgs.push_back(std::move(m)); }
    return emit_object_header(w, msgs);
}

std::vector<u8> dtype_of(void (*emit)(std::vector<u8>&)) {
    std::vector<u8> o;
    emit(o);
    return o;
}

struct RawRead {
    i64 read_number;
    const char* read_id;
    const u8* signal; u64 n_signal;         // int16
    const u8* events; u64 n_events;         // RAW_EV_ITEMSIZE a row
    const u8* fastq; u64 n_fastq;
    const double* channel;                  // digitisation, offset, range,
                                            // sampling_rate
    const char* channel_number;             // nullptr: no such attribute
    bool has_start_time;
    i64 start_time;
};

struct Names {
    const char* basecall_group;
    const char* template_group;
    const char* bc_name;
    const char* bc_version;
};

const int LEAF_K = 4, INTERN_K = 16;        // libhdf5's defaults

// an old-style group: its symbol table, then its object header (the
// symbol-table message, then `attrs`); returns the header's address
u64 group(WBuf& w, std::vector<NamedChild> kids, std::vector<Msg> attrs = {}) {
    auto tab = emit_symbol_table(w, std::move(kids), LEAF_K, INTERN_K);
    std::vector<Msg> msgs{msg_stab(tab.first, tab.second)};
    for (auto& m : attrs) msgs.push_back(std::move(m));
    return emit_object_header(w, msgs);
}

const u64 SB = 96;                          // superblock v0, 8-byte sizes

// the root group (its symbol table, then its object header) and the
// superblock; the whole file into `out`
void finish_file(WBuf& w, std::vector<NamedChild> kids, std::vector<u8>& out) {
    auto root_tab = emit_symbol_table(w, std::move(kids), LEAF_K, INTERN_K);
    u64 root = emit_object_header(w, {msg_stab(root_tab.first,
                                               root_tab.second)});
    w.pad_to(8);
    const u64 eof = w.v.size();

    // superblock v0
    std::vector<u8>& v = w.v;
    const u8 sig8[8] = {0x89, 'H', 'D', 'F', '\r', '\n', 0x1a, '\n'};
    memcpy(v.data(), sig8, 8);
    const u8 vers[8] = {0, 0, 0, 0, 0, 8, 8, 0};  // versions, sizes
    memcpy(v.data() + 8, vers, 8);
    v[16] = (u8)LEAF_K;                     // group leaf and internal K (u16)
    v[18] = (u8)INTERN_K;
    // consistency flags (4 bytes) stay 0
    w.patch_u64(24, 0);                     // base address
    w.patch_u64(32, UNDEF);                 // free-space info
    w.patch_u64(40, eof);                   // end of file
    w.patch_u64(48, UNDEF);                 // no storage-layer block
    w.patch_u64(56, 0);                     // root entry: link name offset
    w.patch_u64(64, root);                  // root object header
    v[72] = 1;                              // cache type 1: btree, heap
    w.patch_u64(80, root_tab.first);
    w.patch_u64(88, root_tab.second);
    out.swap(v);
}

int save(const char* path, const std::vector<u8>& out) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    const bool ok = fwrite(out.data(), 1, out.size(), f) == out.size();
    return (fclose(f) == 0 && ok) ? 0 : -4;
}

int write_raw(const char* path, const RawRead& r, const Names& nm) {
    if (r.n_signal == 0 || r.n_events == 0 || r.n_fastq == 0) return -10;
    std::vector<u8> out;
    try {
        WBuf w;
        w.tail_base = 0;
        w.base = 0;
        w.zeros(SB);

        // the variable-length strings, as h5py stores str and bytes
        std::string rid(r.read_id), fq((const char*)r.fastq, r.n_fastq);
        std::vector<std::string> strings{rid, nm.bc_name, nm.bc_version, fq};
        if (r.channel_number) strings.push_back(r.channel_number);
        u64 gcol = emit_global_heap(w, strings);

        // /Raw/Reads/Read_<n> (attribute order as h5py sets them)
        u64 sig = emit_contiguous(w, r.signal, r.n_signal, 2,
                                  dtype_of(dt_i16_), false);
        std::vector<Msg> rd_attrs;
        if (r.has_start_time)
            rd_attrs.push_back(msg_attr_scalar_i64("start_time",
                                                   r.start_time));
        rd_attrs.push_back(msg_attr_vlen_str("read_id", true, rid.size(),
                                             gcol, 1));
        u64 rd = group(w, {{"Signal", sig}}, std::move(rd_attrs));
        std::string read_name = "Read_" + std::to_string(r.read_number);
        u64 raw = group(w, {{"Reads", group(w, {{read_name, rd}})}});

        // /UniqueGlobalKey/channel_id
        std::vector<Msg> ch_attrs{
            msg_attr_scalar_f64("digitisation", r.channel[0]),
            msg_attr_scalar_f64("offset", r.channel[1]),
            msg_attr_scalar_f64("range", r.channel[2]),
            msg_attr_scalar_f64("sampling_rate", r.channel[3])};
        if (r.channel_number)
            ch_attrs.push_back(msg_attr_vlen_str(
                "channel_number", false, strlen(r.channel_number), gcol, 5));
        u64 ch = group(w, {}, std::move(ch_attrs));
        u64 ug = group(w, {{"channel_id", ch}});

        // /Analyses/<basecall group>/<template>/{Events, Fastq}
        u64 ev = emit_contiguous(w, r.events, r.n_events, RAW_EV_ITEMSIZE,
                                 dtype_of(dt_albacore2_events), false);
        u8 fq_ref[16];                      // a scalar vlen string
        vlen_ref(fq_ref, fq.size(), gcol, 4);
        u64 fqd = emit_contiguous(w, fq_ref, 1, 16, dt_vlen_str(false), true);
        u64 bt = group(w, {{"Events", ev}, {"Fastq", fqd}});
        u64 bc = group(w, {{nm.template_group, bt}},
                       {msg_attr_vlen_str("name", false,
                                          strlen(nm.bc_name), gcol, 2),
                        msg_attr_vlen_str("version", false,
                                          strlen(nm.bc_version), gcol, 3)});
        u64 an = group(w, {{nm.basecall_group, bc}});
        finish_file(w, {{"UniqueGlobalKey", ug}, {"Raw", raw},
                        {"Analyses", an}}, out);
    } catch (const ParseError&) {
        return -2;
    } catch (const std::exception&) {
        return -5;
    }
    return save(path, out);
}

int write_empty(const char* path) {
    std::vector<u8> out;
    try {
        WBuf w;
        w.tail_base = 0;
        w.base = 0;
        w.zeros(SB);
        finish_file(w, {}, out);
    } catch (const std::exception&) {
        return -5;
    }
    return save(path, out);
}

}  // namespace

extern "C" {

// Write nfiles raw FAST5s.  Signals, events and fastq texts are
// concatenated across files with exclusive prefix offsets (nfiles + 1: rows
// of int16, rows of 41 bytes, bytes); channel holds 4 doubles a file;
// channel_numbers[i] may be null (no such attribute), and start_times[i]
// is written where has_start_time[i].  status_out: 0 written, negative not
// written.
int rw_write_batch(const char** paths, int nfiles, const i64* read_numbers,
                   const char** read_ids,
                   const u8* signal, const i64* signal_offsets,
                   const u8* events, const i64* event_offsets,
                   const u8* fastq, const i64* fastq_offsets,
                   const double* channel, const char** channel_numbers,
                   const i64* start_times, const u8* has_start_time,
                   const char* basecall_group, const char* template_group,
                   const char* bc_name, const char* bc_version,
                   int nthreads, int32_t* status_out) {
    const Names nm{basecall_group, template_group, bc_name, bc_version};
    std::atomic<int> next(0);
    int nt = std::max(1, std::min(nthreads, 32));
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= nfiles) return;
            RawRead r;
            r.read_number = read_numbers[i];
            r.read_id = read_ids[i];
            r.signal = signal + 2 * signal_offsets[i];
            r.n_signal = (u64)(signal_offsets[i + 1] - signal_offsets[i]);
            r.events = events + RAW_EV_ITEMSIZE * event_offsets[i];
            r.n_events = (u64)(event_offsets[i + 1] - event_offsets[i]);
            r.fastq = fastq + fastq_offsets[i];
            r.n_fastq = (u64)(fastq_offsets[i + 1] - fastq_offsets[i]);
            r.channel = channel + 4 * (i64)i;
            r.channel_number = channel_numbers[i];
            r.has_start_time = has_start_time[i] != 0;
            r.start_time = start_times[i];
            status_out[i] = (int32_t)write_raw(paths[i], r, nm);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 0; t < nt - 1; t++) ts.emplace_back(worker);
    worker();
    for (auto& t : ts) t.join();
    return 0;
}

// Write a file holding only its root group; 0 written, negative not.
int rw_write_empty(const char* path) { return write_empty(path); }

}  // extern "C"
