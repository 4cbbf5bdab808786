// Native host runtime of the port: the scan path's response assembly.
//
// The port's own copy of the two functions of
// pegasus_tpu/native/packer.cpp that the batched scan path calls,
// copied verbatim so that a diff against the reference stays reviewable:
// pegasus_gather_page (packer.cpp:1041) and pegasus_scan_serve_batch
// (:1082). The rest of the reference's library (crc64, bloom, phash,
// record packing, the codecs) belongs to later slices.
//
// Build (pegasus_tpu_torch/native/__init__.py, at first use):
//   g++ -O3 -shared -fPIC -std=c++17 packer.cpp -o libpegasus_native.so
// ABI: plain C, consumed via ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

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
