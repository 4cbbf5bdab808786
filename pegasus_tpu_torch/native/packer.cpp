// Native host runtime of the port: crc64 columns, the SST sidecars
// (bloom multi-probe, perfect-hash build and probe), the dcz/dcz2
// block codec's key rebuild, region filter and encoded subset, and the
// scan path's response assembly.
//
// The port's own copy of these functions of
// pegasus_tpu/native/packer.cpp, copied verbatim so that a diff against
// the reference stays reviewable: pegasus_crc64 (packer.cpp:91),
// pegasus_crc32 (:97), pegasus_crc64_rows (:106),
// pegasus_bloom_probe_multi (:120), pegasus_phash_build (:203),
// pegasus_phash_probe_multi (:314), pegasus_cblock_decode_keys (:397),
// pegasus_region_filter (:430), pegasus_cblock_subset (:629),
// pegasus_gather_page (:1041) and pegasus_scan_serve_batch (:1082).
// The record packer (pegasus_pack_records) is not part of the port:
// ops/record_block builds columns with numpy.
//
// Build (pegasus_tpu_torch/native/__init__.py, at first use):
//   g++ -O3 -shared -fPIC -std=c++17 packer.cpp -o libpegasus_native.so -ldl
// ABI: plain C, consumed via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <dlfcn.h>

namespace {

constexpr int kPolyBits[] = {63, 61, 59, 58, 56, 55, 52, 49, 48, 47, 46, 44,
                             41, 37, 36, 34, 32, 31, 28, 26, 23, 22, 19, 16,
                             13, 12, 10, 9,  6,  4,  3,  0};

struct Crc64Table {
  uint64_t entries[256];
  Crc64Table() {
    uint64_t poly = 0;
    for (int bit : kPolyBits) poly |= 1ULL << (63 - bit);
    for (uint32_t i = 0; i < 256; ++i) {
      uint64_t k = i;
      for (int j = 0; j < 8; ++j) k = (k & 1) ? (k >> 1) ^ poly : k >> 1;
      entries[i] = k;
    }
  }
};

// C++11 guarantees thread-safe once-initialization of local statics —
// concurrent first calls from several partition threads are safe
const Crc64Table& table() {
  static const Crc64Table t;
  return t;
}

inline uint64_t crc64(const uint8_t* data, int64_t len, uint64_t init) {
  const Crc64Table& t = table();
  uint64_t crc = ~init;
  for (int64_t i = 0; i < len; ++i)
    crc = t.entries[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

struct Crc32cTable {
  uint32_t entries[256];
  Crc32cTable() {
    // CRC-32C (Castagnoli), reflected poly 0x82F63B78 — derived from
    // the polynomial spec, same construction as the Python twin
    // (pegasus_tpu/base/crc.py); golden vectors pin equivalence.
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t k = i;
      for (int j = 0; j < 8; ++j)
        k = (k & 1) ? (k >> 1) ^ 0x82F63B78u : k >> 1;
      entries[i] = k;
    }
  }
};

const Crc32cTable& table32() {
  static const Crc32cTable t;
  return t;
}

inline uint32_t crc32c(const uint8_t* data, int64_t len, uint32_t init) {
  const Crc32cTable& t = table32();
  uint32_t crc = ~init;
  for (int64_t i = 0; i < len; ++i)
    crc = t.entries[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

}  // namespace

extern "C" {

// Scalar crc64 (compatibility checks / tests).
uint64_t pegasus_crc64(const uint8_t* data, int64_t len) {
  return crc64(data, len, 0);
}

// CRC-32C over a buffer — the WAL/SST/wire framing checksum hot loop
// (the Python table loop runs ~2 MB/s; this runs at memory speed).
uint32_t pegasus_crc32(const uint8_t* data, int64_t len, uint32_t init) {
  return crc32c(data, len, init);
}

// Batched crc64 over n zero-padded byte rows (uint8[n, width], row i
// holding lens[i] valid bytes) — one ctypes call hashes a whole
// point-read flush's probe keys for the bloom-filter pass, where the
// numpy per-byte loop pays ~10us of dispatch per byte POSITION and a
// scalar call pays ~1us of ctypes overhead per KEY.
void pegasus_crc64_rows(const uint8_t* rows, const int64_t* lens, int64_t n,
                        int64_t width, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = crc64(rows + i * width, lens[i], 0);
}

// Multi-filter bloom probe: out[i * n_filters + t] = 1 iff hash i may
// be present in filter t. Filters are the power-of-two double-hashed
// blooms of storage/bloom.py (g_j = (h + j*delta) & mask, delta =
// ((h>>17)|1) & mask). One call answers a whole point-read flush
// against EVERY L0 table and L1 run of a partition — the per-key
// python probe walk costs ~1.4us per (key, filter) pair, which at
// deep-L0 rivals the block probes the filter exists to skip.
// bits_addrs: n_filters raw pointers to each filter's bit bytes.
void pegasus_bloom_probe_multi(const uint64_t* bits_addrs,
                               const uint64_t* masks, const int32_t* ks,
                               int64_t n_filters, const uint64_t* hashes,
                               int64_t n_keys, uint8_t* out) {
  for (int64_t i = 0; i < n_keys; ++i) {
    const uint64_t h = hashes[i];
    uint8_t* row = out + i * n_filters;
    for (int64_t t = 0; t < n_filters; ++t) {
      const uint8_t* bits =
          reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(bits_addrs[t]));
      const uint64_t mask = masks[t];
      uint64_t idx = h & mask;
      const uint64_t delta = ((h >> 17) | 1) & mask;
      uint8_t ok = 1;
      for (int32_t j = 0; j < ks[t]; ++j) {
        if (!((bits[idx >> 3] >> (idx & 7)) & 1)) {
          ok = 0;
          break;
        }
        idx = (idx + delta) & mask;
      }
      row[t] = ok;
    }
  }
}

// ---- perfect-hash (CHD) two-level SST index -------------------------
//
// The build/probe twins of storage/phash.py (which documents the
// layout: mix -> bucket/p0/delta, entry = fp(10) | loc(22), EMPTY =
// 0xFFFFFFFF). Both sides MUST stay bit-identical to the Python
// fallback — the mixer, geometry, bucket order and displacement search
// are part of the on-disk format (the seed is stored in the index
// header and a file built by either path must probe identically under
// the other).

namespace {

constexpr uint64_t kPhashGolden = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t kPhashMixK = 0xFF51AFD7ED558CCDULL;
constexpr uint32_t kPhashEmpty = 0xFFFFFFFFu;
constexpr int kPhashFpBits = 10;
constexpr int kPhashLocBits = 22;

inline uint64_t phash_mix(uint64_t h, uint64_t seed) {
  uint64_t x = h ^ (kPhashGolden * (seed + 1));
  x ^= x >> 33;
  x *= kPhashMixK;
  return x ^ (x >> 29);
}

// Lemire multiply-shift reduction of a 32-bit value onto [0, range):
// one multiply where a `%` costs a 20-40-cycle divide — the probe
// pays three of these per (key, table) pair, so divisions were the
// measured kernel bottleneck. range < 2^32, v32 < 2^32: exact in u64.
inline uint64_t phash_r32(uint64_t v32, uint64_t range) {
  return (v32 * range) >> 32;
}

// the (bucket, base position, step) triple of one mixed hash — shared
// verbatim by build and probe (and mirrored bit-for-bit by the Python
// fallback in storage/phash.py: these formulas are FORMAT, the stored
// seed/ts/nb only mean anything under them). With a PRIME ts every
// delta in [1, ts-1] is coprime, so (p0 + d*delta) % ts walks the
// whole table — the one remaining division is the modular step the
// displacement search exploits.
inline void phash_bpd(uint64_t x, uint64_t ts, uint64_t nb,
                      uint64_t* bucket, uint64_t* p0, uint64_t* delta) {
  *bucket = phash_r32(x >> 32, nb);
  *p0 = phash_r32(x & 0xFFFFFFFFull, ts);
  *delta = 1 + phash_r32((x >> 17) & 0xFFFFFFFFull, ts - 1);
}

}  // namespace

// CHD construction: bucket the n (hash, loc) pairs, place buckets in
// decreasing-size order (ties by bucket id), and for each bucket find
// the smallest displacement d (uint16) whose positions are distinct
// and empty. Returns 0 on success (-1: some bucket unplaceable or an
// entry collided with the empty sentinel — the caller reseeds, then
// stamps the run "no phash"). One call builds a whole run's index —
// the writer-side "one vectorized pass" contract (the Python loop
// form pays ~n/4 interpreter iterations; this pays none).
int32_t pegasus_phash_build(const uint64_t* hashes, const uint32_t* locs,
                            int64_t n, uint64_t seed, int64_t ts,
                            int64_t nb, uint16_t* disp_out,
                            uint32_t* slots_out) {
  if (n <= 0 || ts < 3 || nb < 1) return -1;
  int64_t* bucket = static_cast<int64_t*>(malloc(sizeof(int64_t) * n));
  int64_t* p0 = static_cast<int64_t*>(malloc(sizeof(int64_t) * n));
  int64_t* delta = static_cast<int64_t*>(malloc(sizeof(int64_t) * n));
  uint32_t* entry = static_cast<uint32_t*>(malloc(sizeof(uint32_t) * n));
  int64_t* counts = static_cast<int64_t*>(calloc(nb + 1, sizeof(int64_t)));
  int64_t* starts = static_cast<int64_t*>(malloc(sizeof(int64_t) * (nb + 1)));
  int64_t* order = static_cast<int64_t*>(malloc(sizeof(int64_t) * n));
  int64_t* border = static_cast<int64_t*>(malloc(sizeof(int64_t) * nb));
  bool ok = bucket && p0 && delta && entry && counts && starts && order &&
            border;
  int32_t rc = -1;
  if (ok) {
    ok = true;
    for (int64_t i = 0; i < n; ++i) {
      const uint64_t x = phash_mix(hashes[i], seed);
      uint64_t b_, p_, d_;
      phash_bpd(x, static_cast<uint64_t>(ts), static_cast<uint64_t>(nb),
                &b_, &p_, &d_);
      bucket[i] = static_cast<int64_t>(b_);
      p0[i] = static_cast<int64_t>(p_);
      delta[i] = static_cast<int64_t>(d_);
      const uint32_t fp =
          static_cast<uint32_t>(x >> (64 - kPhashFpBits));
      entry[i] = (fp << kPhashLocBits) | locs[i];
      if (entry[i] == kPhashEmpty) ok = false;  // sentinel clash: reseed
      counts[bucket[i]]++;
    }
    if (ok) {
      // counting sort: keys grouped by bucket, stable in file order
      starts[0] = 0;
      for (int64_t b = 0; b < nb; ++b) starts[b + 1] = starts[b] + counts[b];
      {
        int64_t* cur = static_cast<int64_t*>(
            malloc(sizeof(int64_t) * nb));
        if (cur == nullptr) {
          ok = false;
        } else {
          std::memcpy(cur, starts, sizeof(int64_t) * nb);
          for (int64_t i = 0; i < n; ++i) order[cur[bucket[i]]++] = i;
          free(cur);
        }
      }
    }
    if (ok) {
      for (int64_t b = 0; b < nb; ++b) border[b] = b;
      std::sort(border, border + nb, [&](int64_t a, int64_t b2) {
        if (counts[a] != counts[b2]) return counts[a] > counts[b2];
        return a < b2;
      });
      for (int64_t s = 0; s < ts; ++s) slots_out[s] = kPhashEmpty;
      std::memset(disp_out, 0, sizeof(uint16_t) * nb);
      int64_t pos[64];  // bucket sizes are ~4 at the default geometry
      for (int64_t bi = 0; bi < nb && ok; ++bi) {
        const int64_t b = border[bi];
        const int64_t c = counts[b];
        if (c == 0) continue;
        if (c > 64) {
          ok = false;  // pathological bucket: reseed / fall back
          break;
        }
        const int64_t* ks = order + starts[b];
        bool placed = false;
        for (int64_t d = 0; d < 65536 && !placed; ++d) {
          bool fits = true;
          for (int64_t j = 0; j < c && fits; ++j) {
            const int64_t k = ks[j];
            pos[j] = (p0[k] + d * delta[k]) % ts;
            if (slots_out[pos[j]] != kPhashEmpty) fits = false;
            for (int64_t j2 = 0; j2 < j && fits; ++j2)
              if (pos[j2] == pos[j]) fits = false;
          }
          if (!fits) continue;
          for (int64_t j = 0; j < c; ++j)
            slots_out[pos[j]] = entry[ks[j]];
          disp_out[b] = static_cast<uint16_t>(d);
          placed = true;
        }
        if (!placed) ok = false;
      }
      if (ok) rc = 0;
    }
  }
  free(bucket);
  free(p0);
  free(delta);
  free(entry);
  free(counts);
  free(starts);
  free(order);
  free(border);
  return rc;
}

// Multi-index perfect-hash probe: out[i * n_tables + t] is the packed
// loc of hash i in index t, or 0xFFFFFFFF for a definitive absent.
// The sibling of pegasus_bloom_probe_multi: one call answers a whole
// point-read flush's candidacy AND location matrix against every
// indexed run of a partition — ONE slot gather per (key, run) pair
// where the bloom pays up to k=7 bit probes and still leaves the
// block bisect to do.
// `hit_out` (uint8[n_keys * n_tables]) carries the candidacy verdict
// separately from the loc matrix: the planner's per-cell consumption
// indexes it as python BYTES (the exact C-speed read shape the bloom
// matrix uses — numpy scalar boxing or memoryview unpacking per cell
// measurably lost to it at L0 depth 16), touching the loc matrix only
// for the rare located cells.
void pegasus_phash_probe_multi(const uint64_t* slots_addrs,
                               const uint64_t* disp_addrs,
                               const uint64_t* ts_arr,
                               const uint64_t* nb_arr,
                               const uint64_t* seeds, int64_t n_tables,
                               const uint64_t* hashes, int64_t n_keys,
                               uint32_t* out, uint8_t* hit_out) {
  for (int64_t i = 0; i < n_keys; ++i) {
    const uint64_t h = hashes[i];
    uint32_t* row = out + i * n_tables;
    uint8_t* hrow = hit_out + i * n_tables;
    for (int64_t t = 0; t < n_tables; ++t) {
      const uint32_t* slots = reinterpret_cast<const uint32_t*>(
          static_cast<uintptr_t>(slots_addrs[t]));
      const uint16_t* disp = reinterpret_cast<const uint16_t*>(
          static_cast<uintptr_t>(disp_addrs[t]));
      const uint64_t ts = ts_arr[t];
      const uint64_t x = phash_mix(h, seeds[t]);
      uint64_t b_, p0, delta;
      phash_bpd(x, ts, nb_arr[t], &b_, &p0, &delta);
      const uint64_t pos = (p0 + disp[b_] * delta) % ts;
      const uint32_t e = slots[pos];
      const bool hit =
          e != kPhashEmpty &&
          (e >> kPhashLocBits) ==
              static_cast<uint32_t>(x >> (64 - kPhashFpBits));
      row[t] = hit ? (e & ((1u << kPhashLocBits) - 1)) : kPhashEmpty;
      hrow[t] = hit ? 1 : 0;
    }
  }
}


// Rebuild the zero-padded key matrix of a dcz-encoded block (see
// storage/block_codec.py): per row, the 2-byte big-endian hashkey
// header + the dictionary entry + the sortkey heap slice, memcpy'd
// into a pre-zeroed uint8[n, width] matrix. Rows whose hk_idx is the
// 0xFFFFFFFF sentinel are malformed originals stored raw in the
// sortkey heap and copy back verbatim (no header synthesis).
void pegasus_cblock_decode_keys(const uint8_t* dict_heap,
                                const uint32_t* dict_offs,
                                const uint32_t* hk_idx,
                                const uint8_t* sk_heap,
                                const int64_t* sk_offs,
                                const int32_t* key_len, int64_t n,
                                int64_t width, uint8_t* keys_out) {
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* row = keys_out + i * width;
    const int64_t s0 = sk_offs[i];
    const int64_t sl = sk_offs[i + 1] - s0;
    const uint32_t d = hk_idx[i];
    if (d == 0xFFFFFFFFu) {
      std::memcpy(row, sk_heap + s0, sl);
      continue;
    }
    const uint32_t h0 = dict_offs[d];
    const uint32_t hl = dict_offs[d + 1] - h0;
    row[0] = static_cast<uint8_t>(hl >> 8);
    row[1] = static_cast<uint8_t>(hl & 0xFF);
    std::memcpy(row + 2, dict_heap + h0, hl);
    std::memcpy(row + 2 + hl, sk_heap + s0, sl);
    (void)key_len;
  }
}

// Pattern-filter a column of ragged byte regions (the direct-compute
// probe over a dcz block's sortkey heap, or its hashkey dictionary):
// out[i] = 1 iff region i matches. Semantics mirror the device
// match_filter kernel (ops/predicates.py): an empty pattern matches
// everything; a region shorter than the pattern never matches; types
// are 1=anywhere, 2=prefix, 3=postfix (0=no-filter handled by the
// caller).
void pegasus_region_filter(const uint8_t* heap, const int64_t* offs,
                           int64_t n, const uint8_t* pat, int64_t plen,
                           int32_t ftype, uint8_t* out) {
  if (plen == 0) {
    std::memset(out, 1, static_cast<size_t>(n));
    return;
  }
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* r = heap + offs[i];
    const int64_t rl = offs[i + 1] - offs[i];
    uint8_t ok = 0;
    if (rl >= plen) {
      if (ftype == 2) {  // prefix
        ok = std::memcmp(r, pat, plen) == 0;
      } else if (ftype == 3) {  // postfix
        ok = std::memcmp(r + rl - plen, pat, plen) == 0;
      } else {  // anywhere
        for (int64_t t = 0; t + plen <= rl; ++t) {
          if (r[t] == pat[0] && std::memcmp(r + t, pat, plen) == 0) {
            ok = 1;
            break;
          }
        }
      }
    }
    out[i] = ok;
  }
}

// ---- encoded-domain block subsetting (compaction drop path) ---------
//
// zlib/zstd via dlopen: the value heap of a dcz block may be
// compressed, and the subset must inflate -> gather -> re-compress.
// Linking -lz/-lzstd at build time would make the WHOLE library's
// availability depend on a dev symlink; resolving the .so at first
// use keeps every other kernel alive when a compressor is absent (the
// caller falls back to the Python gather path on rc=-2).
typedef int (*z_uncompress_t)(uint8_t*, unsigned long*, const uint8_t*,
                              unsigned long);
typedef int (*z_compress2_t)(uint8_t*, unsigned long*, const uint8_t*,
                             unsigned long, int);
typedef unsigned long (*z_bound_t)(unsigned long);

namespace {

struct ZlibFns {
  z_uncompress_t uncompress_ = nullptr;
  z_compress2_t compress2_ = nullptr;
  z_bound_t bound_ = nullptr;
  ZlibFns() {
    void* h = dlopen("libz.so.1", RTLD_NOW | RTLD_LOCAL);
    if (h == nullptr) h = dlopen("libz.so", RTLD_NOW | RTLD_LOCAL);
    if (h != nullptr) {
      uncompress_ = reinterpret_cast<z_uncompress_t>(
          dlsym(h, "uncompress"));
      compress2_ = reinterpret_cast<z_compress2_t>(
          dlsym(h, "compress2"));
      bound_ = reinterpret_cast<z_bound_t>(dlsym(h, "compressBound"));
    }
  }
  bool ok() const {
    return uncompress_ != nullptr && compress2_ != nullptr &&
           bound_ != nullptr;
  }
};

const ZlibFns& zlib() {
  static ZlibFns z;  // thread-safe magic static
  return z;
}

// zstd via the same dlopen pattern: level-1 zstd runs ~6x faster than
// zlib-1 at a similar ratio, and compaction's inflate -> gather ->
// re-compress is exactly the path where that factor decides whether
// compressed output beats the disk. Decode handles BOTH heap modes
// (zlib-heap blocks written before the switch keep serving); encode
// prefers zstd and falls back to zlib when libzstd is absent.
typedef size_t (*zstd_compress_t)(void*, size_t, const void*, size_t,
                                  int);
typedef size_t (*zstd_decompress_t)(void*, size_t, const void*, size_t);
typedef size_t (*zstd_bound_t)(size_t);
typedef unsigned (*zstd_iserr_t)(size_t);

struct ZstdFns {
  zstd_compress_t compress_ = nullptr;
  zstd_decompress_t decompress_ = nullptr;
  zstd_bound_t bound_ = nullptr;
  zstd_iserr_t iserr_ = nullptr;
  ZstdFns() {
    void* h = dlopen("libzstd.so.1", RTLD_NOW | RTLD_LOCAL);
    if (h == nullptr) h = dlopen("libzstd.so", RTLD_NOW | RTLD_LOCAL);
    if (h != nullptr) {
      compress_ = reinterpret_cast<zstd_compress_t>(
          dlsym(h, "ZSTD_compress"));
      decompress_ = reinterpret_cast<zstd_decompress_t>(
          dlsym(h, "ZSTD_decompress"));
      bound_ = reinterpret_cast<zstd_bound_t>(
          dlsym(h, "ZSTD_compressBound"));
      iserr_ = reinterpret_cast<zstd_iserr_t>(dlsym(h, "ZSTD_isError"));
    }
  }
  bool ok() const {
    return compress_ != nullptr && decompress_ != nullptr &&
           bound_ != nullptr && iserr_ != nullptr;
  }
};

const ZstdFns& zstd() {
  static ZstdFns z;
  return z;
}

// mirror of block_codec._CBLK_HDR ("<IIQQQIIBBBBBBBx", 48 bytes).
// fmt: 0 = v1 (dcz), 2 = v2 (dcz2: FOR expire_ts + dict-indexed
// hash_lo) — was a zeroed pad byte before dcz2, so old blocks read v1.
#pragma pack(push, 1)
struct CBlkHdr {
  uint32_t n, key_width;
  uint64_t raw_heap, comp_heap, sk_bytes;
  uint32_t dict_n, dict_bytes;
  uint8_t klen_w, vlen_w, idx_w, flags_mode, ets_mode, heap_mode;
  uint8_t fmt, pad;
};
#pragma pack(pop)
static_assert(sizeof(CBlkHdr) == 48, "header layout drift");

// v2 (dcz2) section layouts do NOT keep uint32 sections 4-byte
// aligned (the FOR ets section is 4 + w*n bytes and the narrowed
// klen/vlen/idx columns precede the hash sections), so every u32
// section access goes through memcpy — a single mov on x86, defined
// behavior everywhere else
inline uint32_t ld_u32(const uint8_t* p, int64_t i) {
  uint32_t v;
  std::memcpy(&v, p + 4 * i, 4);
  return v;
}

inline void st_u32(uint8_t* p, int64_t i, uint32_t v) {
  std::memcpy(p + 4 * i, &v, 4);
}

inline int64_t narrow_at(const uint8_t* col, int w, int64_t i) {
  if (w == 1) return col[i];
  if (w == 2) {
    uint16_t v;
    std::memcpy(&v, col + 2 * i, 2);
    return v;
  }
  uint32_t v;
  std::memcpy(&v, col + 4 * i, 4);
  return v;
}

inline void narrow_put(uint8_t* col, int w, int64_t i, int64_t v) {
  if (w == 1) {
    col[i] = static_cast<uint8_t>(v);
  } else if (w == 2) {
    uint16_t x = static_cast<uint16_t>(v);
    std::memcpy(col + 2 * i, &x, 2);
  } else {
    uint32_t x = static_cast<uint32_t>(v);
    std::memcpy(col + 4 * i, &x, 4);
  }
}

constexpr int kHeapRaw = 0;
constexpr int kHeapZlib = 1;
constexpr int kHeapZstd = 2;
constexpr int kZlibLevel = 1;
constexpr int kZstdLevel = 1;

}  // namespace

// Subset a dcz-encoded block ENTIRELY in the encoded domain: keep[i]
// selects rows; the dictionary is re-built from the surviving rows'
// slots (order of first appearance — sorted keys keep equal hashkeys
// adjacent, so the remap is monotone), key/value length columns and
// the sortkey heap gather ragged, and the value heap subsets RAW or
// inflate->gather->re-compress for ZLIB/ZSTD heaps (the compression
// DECISION is inherited from the original block: a heap the encoder
// stored raw stays raw — no probing). `new_ets` (nullable, original indexing)
// replaces the TTL column; with `patch_value_headers` the 4-byte
// big-endian expire_ts header at the start of every kept value is
// rewritten to match (value_schema.h layout). This is the compaction
// drop path: one GIL-free pass replaces Python's decode -> gather ->
// re-encode round trip, whose many small numpy ops serialized the
// whole thread pool on the GIL.
//
// The kernel also emits everything the SST writer needs to append the
// result without re-parsing it on the GIL: per-kept-row crc64 full-key
// hashes for the bloom build (`out_hashes`, nullable — computed
// incrementally over header+dict+sortkey segments, no padded matrix),
// the first/last kept keys (`out_keys`, 2*key_width bytes), and
// `out_meta` = [kept_count, subset_raw_heap_len, first_key_len,
// last_key_len].
//
// Returns bytes written into `out`, or -1 (malformed input /
// out_cap too small), -2 (zlib unavailable for a deflated heap; the
// caller must fall back), -3 (heap inflate/deflate failed).
int64_t pegasus_cblock_subset(const uint8_t* raw, int64_t raw_len,
                              const uint8_t* keep,
                              const uint32_t* new_ets,
                              int32_t patch_value_headers, uint8_t* out,
                              int64_t out_cap, uint64_t* out_hashes,
                              uint8_t* out_keys, int64_t* out_meta) {
  if (raw_len < static_cast<int64_t>(sizeof(CBlkHdr))) return -1;
  CBlkHdr h;
  std::memcpy(&h, raw, sizeof(h));
  const int64_t n = h.n;
  const bool v2 = (h.fmt == 2);
  const int64_t sentinel = (1LL << (8 * h.idx_w)) - 1;
  // input section pointers (v1: ets? | hash | doffs | klen | vlen |
  // idx | flags? | dict | sk | heap; v2 moves the hash section after
  // flags — slot hashes + row-ordered overflow — and the ets section
  // may be FOR-encoded: u32 base + narrowed delta_plus1 per row)
  const uint8_t* p = raw + sizeof(CBlkHdr);
  const uint8_t* in_ets = nullptr;     // raw u32[n] (v1 mode!=0, v2 mode 4)
  const uint8_t* in_ets_d = nullptr;   // v2 FOR deltas
  uint32_t ets_base = 0;
  int ets_w = 0;
  if (v2 && (h.ets_mode == 1 || h.ets_mode == 2)) {
    std::memcpy(&ets_base, p, 4);
    p += 4;
    in_ets_d = p;
    ets_w = h.ets_mode;
    p += ets_w * n;
  } else if (h.ets_mode != 0) {
    in_ets = p;
    p += 4 * n;
  }
  const uint8_t* in_hash = nullptr;   // v1 per-row hash column
  if (!v2) {
    in_hash = p;
    p += 4 * n;
  }
  const uint8_t* in_doffs = p;
  p += 4 * (static_cast<int64_t>(h.dict_n) + 1);
  const uint8_t* in_klen = p;
  p += h.klen_w * n;
  const uint8_t* in_vlen = p;
  p += h.vlen_w * n;
  const uint8_t* in_idx = p;
  p += h.idx_w * n;
  const uint8_t* in_flags = nullptr;
  if (h.flags_mode != 0) {
    in_flags = p;
    p += n;
  }
  const uint8_t* in_slot_hash = nullptr;  // v2 per-dict-slot hash
  const uint8_t* in_over_hash = nullptr;  // v2 row-ordered overflow
  if (v2) {
    int64_t n_over = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t d = narrow_at(in_idx, h.idx_w, i);
      if (d == sentinel || ld_u32(in_doffs, d + 1) == ld_u32(in_doffs, d))
        ++n_over;
    }
    in_slot_hash = p;
    p += 4 * static_cast<int64_t>(h.dict_n);
    in_over_hash = p;
    p += 4 * n_over;
  }
  const uint8_t* in_dict = p;
  p += h.dict_bytes;
  const uint8_t* in_sk = p;
  p += h.sk_bytes;
  const uint8_t* in_heap = p;
  if (p + h.comp_heap > raw + raw_len) return -1;
  // per-row expire_ts independent of the stored encoding
  const auto ets_at = [&](int64_t i) -> uint32_t {
    if (in_ets != nullptr) return ld_u32(in_ets, i);
    if (in_ets_d != nullptr) {
      const int64_t d = narrow_at(in_ets_d, ets_w, i);
      return d == 0 ? 0 : ets_base + static_cast<uint32_t>(d) - 1;
    }
    return 0;
  };

  // pass 1: survivor geometry + monotone dictionary remap
  int64_t* remap = static_cast<int64_t*>(
      malloc(sizeof(int64_t) * (h.dict_n + 1)));
  if (remap == nullptr) return -1;
  for (int64_t d = 0; d <= h.dict_n; ++d) remap[d] = -1;
  int64_t m = 0, new_dict_n = 0, new_dict_bytes = 0, new_sk = 0,
          vsub = 0, out_over = 0;
  bool any_ets = false, any_flags = false;
  uint32_t e_min = 0xFFFFFFFFu, e_max = 0;
  {
    int64_t sk_off = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t kl = narrow_at(in_klen, h.klen_w, i);
      const int64_t d = narrow_at(in_idx, h.idx_w, i);
      const int64_t hk =
          (d == sentinel)
              ? 0
              : static_cast<int64_t>(ld_u32(in_doffs, d + 1)) -
                    ld_u32(in_doffs, d);
      const int64_t sl = (d == sentinel) ? kl : kl - 2 - hk;
      if (keep[i] != 0) {
        ++m;
        if (d != sentinel && remap[d] < 0) {
          remap[d] = new_dict_n++;
          new_dict_bytes += hk;
        }
        if (d == sentinel || hk == 0) ++out_over;
        new_sk += sl;
        vsub += narrow_at(in_vlen, h.vlen_w, i);
        const uint32_t e =
            (new_ets != nullptr) ? new_ets[i] : ets_at(i);
        if (e != 0) {
          any_ets = true;
          if (e < e_min) e_min = e;
          if (e > e_max) e_max = e;
        }
        any_flags = any_flags || (in_flags != nullptr && in_flags[i]);
      }
      sk_off += sl;
    }
    if (sk_off != static_cast<int64_t>(h.sk_bytes)) {
      free(remap);
      return -1;
    }
  }

  // inflate the value heap if compressed (subsetting needs raw bytes)
  const uint8_t* heap_raw = in_heap;
  uint8_t* inflated = nullptr;
  if (h.heap_mode == kHeapZlib || h.heap_mode == kHeapZstd) {
    const bool is_zstd = (h.heap_mode == kHeapZstd);
    if (is_zstd ? !zstd().ok() : !zlib().ok()) {
      free(remap);
      return -2;
    }
    inflated = static_cast<uint8_t*>(malloc(h.raw_heap ? h.raw_heap : 1));
    if (inflated == nullptr) {
      free(remap);
      return -3;
    }
    bool bad;
    if (is_zstd) {
      const size_t got = zstd().decompress_(inflated, h.raw_heap,
                                            in_heap, h.comp_heap);
      bad = zstd().iserr_(got) != 0 || got != h.raw_heap;
    } else {
      unsigned long dst = h.raw_heap;
      bad = zlib().uncompress_(inflated, &dst, in_heap, h.comp_heap) !=
                0 ||
            dst != h.raw_heap;
    }
    if (bad) {
      free(inflated);
      free(remap);
      return -3;
    }
    heap_raw = inflated;
  }

  // output header + section layout (output keeps the input's format
  // version: v1 in -> v1 out, v2 in -> v2 out with the FOR width
  // re-derived over the SURVIVOR values)
  CBlkHdr oh = h;
  oh.n = static_cast<uint32_t>(m);
  uint8_t out_ets_mode = 0;
  int64_t ets_sec = 0;
  if (any_ets) {
    if (v2) {
      const uint64_t spread =
          static_cast<uint64_t>(e_max) - e_min + 1;
      out_ets_mode = spread <= 0xFF ? 1 : (spread <= 0xFFFF ? 2 : 4);
      ets_sec = out_ets_mode == 4 ? 4 * m : 4 + out_ets_mode * m;
    } else {
      out_ets_mode = 4;
      ets_sec = 4 * m;
    }
  }
  oh.ets_mode = out_ets_mode;
  oh.flags_mode = any_flags ? 1 : 0;
  oh.dict_n = static_cast<uint32_t>(new_dict_n);
  oh.dict_bytes = static_cast<uint32_t>(new_dict_bytes);
  oh.sk_bytes = static_cast<uint64_t>(new_sk);
  oh.raw_heap = static_cast<uint64_t>(vsub);
  const int64_t hash_sec =
      v2 ? 4 * (new_dict_n + out_over) : 4 * m;
  const int64_t fixed = sizeof(CBlkHdr) + ets_sec + hash_sec +
                        4 * (new_dict_n + 1) + h.klen_w * m +
                        h.vlen_w * m + h.idx_w * m + (any_flags ? m : 0) +
                        new_dict_bytes + new_sk;
  if (fixed + vsub > out_cap) {
    free(inflated);
    free(remap);
    return -1;
  }
  uint8_t* q = out + sizeof(CBlkHdr);
  uint8_t* out_ets = nullptr;   // raw-u32 ets (v1, or v2 mode 4)
  uint8_t* out_ets_d = nullptr;  // v2 FOR deltas
  if (out_ets_mode == 4) {
    out_ets = q;
    q += 4 * m;
  } else if (out_ets_mode != 0) {
    std::memcpy(q, &e_min, 4);  // FOR base = min nonzero survivor
    q += 4;
    out_ets_d = q;
    q += out_ets_mode * m;
  }
  uint8_t* out_hash = nullptr;        // v1 per-row
  if (!v2) {
    out_hash = q;
    q += 4 * m;
  }
  uint8_t* out_doffs = q;
  q += 4 * (new_dict_n + 1);
  uint8_t* out_klen = q;
  q += h.klen_w * m;
  uint8_t* out_vlen = q;
  q += h.vlen_w * m;
  uint8_t* out_idx = q;
  q += h.idx_w * m;
  uint8_t* out_flags = nullptr;
  if (any_flags) {
    out_flags = q;
    q += m;
  }
  uint8_t* out_slot_hash = nullptr;   // v2 dict-slot hashes
  uint8_t* out_over_hash = nullptr;   // v2 overflow hashes
  if (v2) {
    out_slot_hash = q;
    q += 4 * new_dict_n;
    out_over_hash = q;
    q += 4 * out_over;
  }
  uint8_t* out_dict = q;
  q += new_dict_bytes;
  uint8_t* out_sk = q;
  q += new_sk;
  uint8_t* out_heap = q;  // raw subset lands here (ZLIB re-packs below)

  // dictionary: entries in new-slot order (+ v2 slot hashes riding
  // the same remap)
  st_u32(out_doffs, 0, 0);
  {
    uint32_t cur = 0;
    for (int64_t d = 0; d < h.dict_n; ++d) {
      const int64_t nd = remap[d];
      if (nd < 0) continue;
      const uint32_t len = ld_u32(in_doffs, d + 1) - ld_u32(in_doffs, d);
      std::memcpy(out_dict + cur, in_dict + ld_u32(in_doffs, d), len);
      cur += len;
      st_u32(out_doffs, nd + 1, cur);
      if (v2) st_u32(out_slot_hash, nd, ld_u32(in_slot_hash, d));
    }
  }

  // pass 2: gather survivors (+ bloom hashes and first/last keys)
  {
    int64_t j = 0, sk_off = 0, v_off = 0, osk = 0, ov = 0;
    int64_t in_over_seq = 0, out_over_seq = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t kl = narrow_at(in_klen, h.klen_w, i);
      const int64_t d = narrow_at(in_idx, h.idx_w, i);
      const int64_t hk =
          (d == sentinel)
              ? 0
              : static_cast<int64_t>(ld_u32(in_doffs, d + 1)) -
                    ld_u32(in_doffs, d);
      const int64_t sl = (d == sentinel) ? kl : kl - 2 - hk;
      const int64_t vl = narrow_at(in_vlen, h.vlen_w, i);
      const bool slot_derivable = (d != sentinel) && hk > 0;
      uint32_t hrow = 0;
      if (v2) {
        hrow = slot_derivable ? ld_u32(in_slot_hash, d)
                              : ld_u32(in_over_hash, in_over_seq++);
      } else {
        hrow = ld_u32(in_hash, i);
      }
      if (keep[i] != 0) {
        const uint32_t e =
            (new_ets != nullptr) ? new_ets[i] : ets_at(i);
        if (out_ets != nullptr) st_u32(out_ets, j, e);
        if (out_ets_d != nullptr)
          narrow_put(out_ets_d, out_ets_mode, j,
                     e == 0 ? 0 : static_cast<int64_t>(e) - e_min + 1);
        if (out_hash != nullptr) st_u32(out_hash, j, hrow);
        if (v2 && !slot_derivable)
          st_u32(out_over_hash, out_over_seq++, hrow);
        narrow_put(out_klen, h.klen_w, j, kl);
        narrow_put(out_vlen, h.vlen_w, j, vl);
        narrow_put(out_idx, h.idx_w, j,
                   (d == sentinel) ? sentinel : remap[d]);
        if (out_flags != nullptr)
          out_flags[j] = (in_flags != nullptr) ? in_flags[i] : 0;
        std::memcpy(out_sk + osk, in_sk + sk_off, sl);
        std::memcpy(out_heap + ov, heap_raw + v_off, vl);
        if (patch_value_headers != 0 && new_ets != nullptr && vl >= 4) {
          out_heap[ov] = static_cast<uint8_t>(e >> 24);
          out_heap[ov + 1] = static_cast<uint8_t>(e >> 16);
          out_heap[ov + 2] = static_cast<uint8_t>(e >> 8);
          out_heap[ov + 3] = static_cast<uint8_t>(e);
        }
        if (out_hashes != nullptr) {
          // crc64 over the row's real key bytes, segment-chained
          // (crc64(x, prev) continues prev thanks to the ~init/~final
          // construction) — identical to crc64_rows over the padded
          // matrix rows the writer would otherwise rebuild
          uint64_t c;
          if (d != sentinel) {
            const uint8_t hdr2[2] = {static_cast<uint8_t>(hk >> 8),
                                     static_cast<uint8_t>(hk & 0xFF)};
            c = crc64(hdr2, 2, 0);
            c = crc64(in_dict + ld_u32(in_doffs, d), hk, c);
            c = crc64(in_sk + sk_off, sl, c);
          } else {
            c = crc64(in_sk + sk_off, sl, 0);
          }
          out_hashes[j] = c;
        }
        if (out_keys != nullptr && out_meta != nullptr) {
          // overwrite the last-key slot on every kept row (the final
          // survivor wins); the first row ALSO fills the first-key
          // slot — a single-survivor subset must land in both
          uint8_t* dst = out_keys + h.key_width;
          if (d != sentinel) {
            dst[0] = static_cast<uint8_t>(hk >> 8);
            dst[1] = static_cast<uint8_t>(hk & 0xFF);
            std::memcpy(dst + 2, in_dict + ld_u32(in_doffs, d), hk);
            std::memcpy(dst + 2 + hk, in_sk + sk_off, sl);
          } else {
            std::memcpy(dst, in_sk + sk_off, sl);
          }
          if (j == 0) {
            std::memcpy(out_keys, dst, kl);
            out_meta[2] = kl;
          }
          out_meta[3] = kl;
        }
        osk += sl;
        ov += vl;
        ++j;
      }
      sk_off += sl;
      v_off += vl;
    }
  }
  if (out_meta != nullptr) {
    out_meta[0] = m;
    out_meta[1] = vsub;
  }
  free(inflated);
  free(remap);

  int64_t stored = vsub;
  oh.heap_mode = kHeapRaw;
  if (h.heap_mode != kHeapRaw && vsub > 0) {
    // the original encoder proved this heap compressible; re-compress
    // the subset and keep it when it still clears the 5% bar. zstd
    // when resolvable (even if the input heap was zlib — compaction
    // migrates old heaps forward), zlib otherwise.
    if (zstd().ok()) {
      const size_t bound = zstd().bound_(vsub);
      uint8_t* comp = static_cast<uint8_t*>(malloc(bound));
      if (comp != nullptr) {
        const size_t clen =
            zstd().compress_(comp, bound, out_heap, vsub, kZstdLevel);
        if (zstd().iserr_(clen) == 0 &&
            static_cast<int64_t>(clen) < (vsub * 95) / 100) {
          std::memcpy(out_heap, comp, clen);
          stored = static_cast<int64_t>(clen);
          oh.heap_mode = kHeapZstd;
        }
        free(comp);
      }
    } else if (zlib().ok()) {
      unsigned long bound = zlib().bound_(vsub);
      uint8_t* comp = static_cast<uint8_t*>(malloc(bound));
      if (comp != nullptr) {
        unsigned long clen = bound;
        if (zlib().compress2_(comp, &clen, out_heap, vsub,
                              kZlibLevel) == 0 &&
            static_cast<int64_t>(clen) < (vsub * 95) / 100) {
          std::memcpy(out_heap, comp, clen);
          stored = static_cast<int64_t>(clen);
          oh.heap_mode = kHeapZlib;
        }
        free(comp);
      }
    }
  }
  oh.comp_heap = static_cast<uint64_t>(stored);
  std::memcpy(out, &oh, sizeof(oh));
  return fixed + stored;
}

// Gather `m` selected rows of a columnar block into a packed response
// page: keys concatenated into key_blob, user-data (value minus `hdr`
// header bytes) into val_blob, with running offset columns.
//
// Role parity: the reference's response-assembly loop
// (src/server/pegasus_server_impl.cpp append_key_value_for_multi_get /
// validate_key_value_for_scan) copies each surviving record into the
// response one at a time in C++; our survivors are already columnar, so
// one call packs the whole page.
//
//   keys        uint8[.., key_width]  padded key rows
//   key_len     int32[..]
//   value_offs  uint32[..+1]          row i's value = heap[offs[i],offs[i+1])
//   take        int64[m]              row indices to gather (ascending)
//   hdr         value-header bytes to strip (user data starts after it)
//   key_offs    uint32[m+1]; [0] preset by the caller (chaining base)
//   val_offs    uint32[m+1]; [0] preset; pass val_blob=NULL to skip
//                            values (no_value mode) — offsets still run
// The caller sizes key_blob/val_blob exactly (numpy sums of the same
// columns); this routine only copies.
void pegasus_gather_page(const uint8_t* keys, int64_t key_width,
                         const int32_t* key_len, const uint32_t* value_offs,
                         const uint8_t* heap, const int64_t* take, int64_t m,
                         int32_t hdr, uint8_t* key_blob, uint32_t* key_offs,
                         uint8_t* val_blob, uint32_t* val_offs) {
  uint32_t kpos = key_offs[0];
  uint32_t vpos = val_offs[0];
  for (int64_t i = 0; i < m; ++i) {
    const int64_t row = take[i];
    const int32_t kl = key_len[row];
    std::memcpy(key_blob + kpos, keys + row * key_width, kl);
    kpos += static_cast<uint32_t>(kl);
    key_offs[i + 1] = kpos;
    const uint32_t v0 = value_offs[row];
    const uint32_t v1 = value_offs[row + 1];
    const uint32_t vl = v1 - v0 > static_cast<uint32_t>(hdr)
                            ? v1 - v0 - static_cast<uint32_t>(hdr)
                            : 0;
    if (val_blob != nullptr && vl > 0)
      std::memcpy(val_blob + vpos, heap + v0 + hdr, vl);
    vpos += val_blob != nullptr ? vl : 0;
    val_offs[i + 1] = vpos;
  }
}

// Serve a whole BATCH of scan requests' base-path assembly in one
// call. The caller passes a table of the batch's unique blocks
// (pointer columns) and each request's plan as CSR rows into that
// table; rows are packed into shared key/value arenas with running
// offset columns, one offsets window per request
// ([row_base[r], row_base[r] + count_r]).
//
// Per request r, rows are taken in plan order until wants[r] rows or
// `byte_budget` response bytes (keys + stripped values; keys only when
// no_values[r]). The FIRST row of a request is taken even when it
// alone exceeds the budget (forward-progress guarantee) as long as it
// fits the arenas.
//
// out_state[r]: 0 = plan exhausted, 1 = stopped at wants[r],
//               2 = stopped by the byte budget (truncated),
//               3 = arena capacity hit (caller re-serves r in Python).
void pegasus_scan_serve_batch(
    const uint64_t* keys_ptrs, const int64_t* widths,
    const uint64_t* keylen_ptrs,
    const uint64_t* entry_mask_ptrs,  // PER-ENTRY: flavors sharing a
                                      // block carry different masks
    const uint64_t* voffs_ptrs, const uint64_t* heap_ptrs,
    const uint64_t* ets_ptrs, int64_t n_reqs, const int64_t* entry_start,
    const int64_t* entry_block, const int64_t* entry_lo,
    const int64_t* entry_hi, const int64_t* wants,
    const uint8_t* no_values, int64_t byte_budget, int32_t hdr,
    uint8_t* key_blob, int64_t key_cap, uint8_t* val_blob,
    int64_t val_cap, uint32_t* key_offs, uint32_t* val_offs,
    const int64_t* row_base, uint32_t* ets_arena, int64_t* out_count,
    int64_t* out_bytes, int32_t* out_state) {
  uint32_t kpos = 0;
  uint32_t vpos = 0;
  for (int64_t r = 0; r < n_reqs; ++r) {
    const int64_t base = row_base[r];
    const int64_t want = wants[r];
    const int32_t no_value = no_values[r];
    int64_t count = 0;
    int64_t bytes = 0;
    int32_t state = 0;
    key_offs[base] = kpos;
    val_offs[base] = vpos;
    for (int64_t e = entry_start[r];
         e < entry_start[r + 1] && count < want && state == 0; ++e) {
      const int64_t b = entry_block[e];
      const uint8_t* keys = reinterpret_cast<const uint8_t*>(keys_ptrs[b]);
      const int64_t width = widths[b];
      const int32_t* key_len =
          reinterpret_cast<const int32_t*>(keylen_ptrs[b]);
      const uint8_t* mask =
          reinterpret_cast<const uint8_t*>(entry_mask_ptrs[e]);
      const uint32_t* voffs =
          reinterpret_cast<const uint32_t*>(voffs_ptrs[b]);
      const uint8_t* heap = reinterpret_cast<const uint8_t*>(heap_ptrs[b]);
      const uint32_t* ets = reinterpret_cast<const uint32_t*>(ets_ptrs[b]);
      const int64_t hi = entry_hi[e];
      for (int64_t row = entry_lo[e]; row < hi; ++row) {
        if (!mask[row]) continue;
        const int32_t kl = key_len[row];
        const uint32_t v0 = voffs[row];
        const uint32_t v1 = voffs[row + 1];
        const uint32_t vl = (!no_value && v1 - v0 > (uint32_t)hdr)
                                ? v1 - v0 - (uint32_t)hdr
                                : 0;
        const int64_t row_bytes = kl + (int64_t)vl;
        if ((uint64_t)kpos + (uint64_t)kl > (uint64_t)key_cap ||
            (uint64_t)vpos + (uint64_t)vl > (uint64_t)val_cap) {
          state = 3;  // arena full: this request re-serves in Python
          break;
        }
        if (count > 0 && bytes + row_bytes > byte_budget) {
          state = 2;
          break;
        }
        std::memcpy(key_blob + kpos, keys + row * width, kl);
        kpos += (uint32_t)kl;
        key_offs[base + count + 1] = kpos;
        if (vl > 0) std::memcpy(val_blob + vpos, heap + v0 + hdr, vl);
        vpos += vl;
        val_offs[base + count + 1] = vpos;
        if (ets_arena) ets_arena[base - r + count] = ets[row];
        bytes += row_bytes;
        ++count;
        if (count >= want) {
          state = 1;
          break;
        }
      }
    }
    out_count[r] = count;
    out_bytes[r] = bytes;
    out_state[r] = state;
  }
}

}  // extern "C"
