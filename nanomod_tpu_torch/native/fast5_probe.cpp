// Port-only source (not a copy of the reference's): does a FAST5 hold an
// HDF5 object at a path, answered without libhdf5, for Annotate --resume
// (the reference asks h5py: nanomod_tpu/io/fast5.py has_corrected_group).
//
// It compiles the port's copy of fast5_ingest.cpp into the same unit and
// reuses its HDF5 parser (read_superblock, resolve_path), so the seven
// copied sources stay byte-equal to the reference's.  The library is
// rebuilt when this file or fast5_ingest.cpp is newer than it
// (native/build.py _DEPS).
#include "fast5_ingest.cpp"

namespace {

// 1: the path resolves; 0: it does not, or the file does not open or is
// not an HDF5 file (h5py raises OSError there, which has_corrected_group
// answers with False); -1: the parser failed on an HDF5 file (h5py must
// decide)
int8_t probe_file(const char* path, const char* obj) {
    FILE* f = fopen(path, "rb");
    if (!f) return 0;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<u8> buf(sz > 0 ? sz : 0);
    const bool whole = sz <= 0 || fread(buf.data(), 1, sz, f) == (size_t)sz;
    fclose(f);
    if (!whole) return -1;
    Buf b{buf.data(), (u64)buf.size()};
    Super s;
    try {
        s = read_superblock(b);
    } catch (const std::exception& e) {
        return strcmp(e.what(), "not an HDF5 file") == 0 ? 0 : -1;
    }
    try {
        return resolve_path(b, s, obj) == UNDEF ? 0 : 1;
    } catch (const std::exception&) {
        return -1;
    }
}

}  // namespace

extern "C" void f5_has_object(const char** paths, int64_t n, const char* obj,
                              int nthreads, int8_t* out) {
    if (nthreads < 1) nthreads = 1;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            out[i] = probe_file(paths[i], obj);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < nthreads; t++) ts.emplace_back(worker);
    worker();
    for (auto& t : ts) t.join();
}
