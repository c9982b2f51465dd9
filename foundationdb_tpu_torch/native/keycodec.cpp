// Bulk order-preserving key encoder — native twin of
// ops/keycode.encode_keys_plain, and the endpoint dictionary's host table.
//
// Encodes n variable-length byte-string keys into fixed-width uint32 lane
// rows: width/4 big-endian data lanes + one length lane (min(len, width+1)).
// Loaded via ctypes over a plain C ABI; built by
// foundationdb_tpu_torch/native/build.py.

#include <cstdint>

extern "C" {

// flat: concatenated key bytes; offs[n+1]: byte offsets into flat;
// out: n * (width/4 + 1) uint32, row-major.
void kc_encode(const uint8_t* flat, const int64_t* offs, int64_t n,
               int64_t width, uint32_t* out) {
    const int64_t nd = width / 4;       // data lanes
    const int64_t L = nd + 1;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* k = flat + offs[i];
        const int64_t len = offs[i + 1] - offs[i];
        const int64_t plen = len < width ? len : width;
        uint32_t* row = out + i * L;
        for (int64_t l = 0; l < nd; ++l) row[l] = 0;
        for (int64_t b = 0; b < plen; ++b)
            row[b >> 2] |= static_cast<uint32_t>(k[b]) << (8 * (3 - (b & 3)));
        row[nd] = static_cast<uint32_t>(len < width + 1 ? len : width + 1);
    }
}

static inline void encode_one(const uint8_t* k, int64_t len, int64_t width,
                              uint32_t* row) {
    const int64_t nd = width / 4;
    const int64_t plen = len < width ? len : width;
    for (int64_t l = 0; l < nd; ++l) row[l] = 0;
    for (int64_t b = 0; b < plen; ++b)
        row[b >> 2] |= static_cast<uint32_t>(k[b]) << (8 * (3 - (b & 3)));
    row[nd] = static_cast<uint32_t>(len < width + 1 ? len : width + 1);
}

// Whole-batch encoder: fills the four padded [B, R, L] uint32 lane arrays
// (sentinel rows where no range) straight from the batch's key blob.
//
// flat/offs: concatenated key bytes + offsets, in txn order:
//   txn0: r0.begin r0.end r1.begin r1.end ... w0.begin w0.end ...
// nr/nw: per-txn read/write range counts (n_txns entries).
// rb/re/wb/we: B*R*L uint32 outputs, L = width/4 + 1.
void kc_encode_batch(const uint8_t* flat, const int64_t* offs,
                     const int32_t* nr, const int32_t* nw, int64_t n_txns,
                     int64_t B, int64_t R, int64_t width,
                     uint32_t* rb, uint32_t* re, uint32_t* wb, uint32_t* we) {
    const int64_t L = width / 4 + 1;
    const int64_t row_words = R * L;
    for (int64_t i = 0; i < B * row_words; ++i)
        rb[i] = re[i] = wb[i] = we[i] = 0xFFFFFFFFu;
    int64_t key = 0;
    for (int64_t i = 0; i < n_txns; ++i) {
        uint32_t* rrb = rb + i * row_words;
        uint32_t* rre = re + i * row_words;
        for (int32_t j = 0; j < nr[i]; ++j) {
            encode_one(flat + offs[key], offs[key + 1] - offs[key], width,
                       rrb + j * L);
            ++key;
            encode_one(flat + offs[key], offs[key + 1] - offs[key], width,
                       rre + j * L);
            ++key;
        }
        uint32_t* rwb = wb + i * row_words;
        uint32_t* rwe = we + i * row_words;
        for (int32_t j = 0; j < nw[i]; ++j) {
            encode_one(flat + offs[key], offs[key + 1] - offs[key], width,
                       rwb + j * L);
            ++key;
            encode_one(flat + offs[key], offs[key + 1] - offs[key], width,
                       rwe + j * L);
            ++key;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Endpoint-id dictionary encoder (transfer compression for the device path).
//
// Shipping every range endpoint's lane vector (36B) each batch costs host
// packing and host-to-device bytes.  The device keeps a lane dictionary
// of D rows resident; the host keeps this
// mirror: an open-addressing hash table mapping endpoint bytes -> slot id.
// A batch ships u32 slot ids (4B per endpoint) plus lane updates for
// endpoints not yet on the device.  Slots are reused round-robin (the
// ring history stores materialized lanes, so reassigning a slot never
// corrupts old history); a slot referenced by the current group is never
// evicted (group stamps), so in-flight ids always gather the right lanes.

#include <cstdlib>
#include <cstring>

namespace {

struct KcEntry {        // one cache-line-friendly probe unit (16B)
    uint64_t h;             // 0 = empty, 1 = tombstone
    uint32_t id;
    uint32_t pad;
};

struct KcDict {
    int64_t slots;          // device capacity D; ids 1..slots-1 (0 = sentinel)
    int64_t table_cap;      // power of two
    KcEntry* table;         // packed hash+id: one miss per probe, not two
    uint8_t** slot_key;     // owned copy of each slot's endpoint bytes
    int32_t* slot_len;
    uint64_t* slot_stamp;   // group counter at last reference
    int64_t next_slot;
    uint64_t group;
    int64_t tombstones;
    int64_t live;
};

inline uint64_t kd_hash(const uint8_t* k, int64_t len) {
    uint64_t h = 1469598103934665603ull;            // FNV-1a 64
    for (int64_t i = 0; i < len; ++i) { h ^= k[i]; h *= 1099511628211ull; }
    if (h < 2) h += 2;                              // 0/1 reserved
    return h;
}

// find the entry for key; returns table index or -1
inline int64_t kd_find(KcDict* d, const uint8_t* k, int64_t len, uint64_t h) {
    const uint64_t mask = d->table_cap - 1;
    for (uint64_t i = h & mask;; i = (i + 1) & mask) {
        const uint64_t th = d->table[i].h;
        if (th == 0) return -1;
        if (th == h) {
            const uint32_t id = d->table[i].id;
            if (d->slot_len[id] == len &&
                memcmp(d->slot_key[id], k, len) == 0)
                return static_cast<int64_t>(i);
        }
    }
}

inline int64_t kd_find_insert_pos(KcDict* d, uint64_t h) {
    const uint64_t mask = d->table_cap - 1;
    for (uint64_t i = h & mask;; i = (i + 1) & mask) {
        const uint64_t th = d->table[i].h;
        if (th == 0 || th == 1) {
            if (th == 1) --d->tombstones;
            return static_cast<int64_t>(i);
        }
    }
}

void kd_rebuild(KcDict* d) {
    KcEntry* ot = d->table;
    const int64_t ocap = d->table_cap;
    d->table = static_cast<KcEntry*>(calloc(d->table_cap, sizeof(KcEntry)));
    d->tombstones = 0;
    for (int64_t i = 0; i < ocap; ++i) {
        if (ot[i].h > 1) {
            const int64_t j = kd_find_insert_pos(d, ot[i].h);
            d->table[j] = ot[i];
        }
    }
    free(ot);
}

void kd_remove(KcDict* d, uint32_t id) {
    const uint8_t* k = d->slot_key[id];
    if (!k) return;
    const uint64_t h = kd_hash(k, d->slot_len[id]);
    const int64_t i = kd_find(d, k, d->slot_len[id], h);
    if (i >= 0) {
        d->table[i].h = 1;                          // tombstone
        ++d->tombstones;
        --d->live;
    }
    free(d->slot_key[id]);
    d->slot_key[id] = nullptr;
    d->slot_len[id] = 0;
}

}  // namespace

extern "C" {

void* kc_dict_new(int64_t slots) {
    KcDict* d = static_cast<KcDict*>(calloc(1, sizeof(KcDict)));
    d->slots = slots;
    int64_t cap = 64;
    while (cap < slots * 4) cap <<= 1;
    d->table_cap = cap;
    d->table = static_cast<KcEntry*>(calloc(cap, sizeof(KcEntry)));
    d->slot_key = static_cast<uint8_t**>(calloc(slots, sizeof(uint8_t*)));
    d->slot_len = static_cast<int32_t*>(calloc(slots, 4));
    d->slot_stamp = static_cast<uint64_t*>(calloc(slots, 8));
    d->next_slot = 1;
    d->group = 1;
    return d;
}

void kc_dict_free(void* p) {
    KcDict* d = static_cast<KcDict*>(p);
    for (int64_t i = 0; i < d->slots; ++i) free(d->slot_key[i]);
    free(d->slot_key);
    free(d->slot_len);
    free(d->slot_stamp);
    free(d->table);
    free(d);
}

// New group boundary: ids handed out after this call may not evict slots
// referenced since this call (they share a device dispatch).
void kc_dict_group(void* p) {
    ++static_cast<KcDict*>(p)->group;
}

int64_t kc_dict_live(void* p) { return static_cast<KcDict*>(p)->live; }

}  // extern "C"

namespace {

// id for one endpoint with a precomputed hash; appends (slot, lanes) to
// the update buffers when the endpoint is not yet device-resident.
// Returns the id, or 0 with *overflow set when the update buffers are
// full (caller falls back).  The SINGLE home of the dictionary-insert
// invariants (round-robin slot allocation with group-stamp skip, evict,
// load-factor rebuild, lane-major update emit) — both the per-batch and
// the fused group paths go through here.
inline uint32_t kd_id_h(KcDict* d, const uint8_t* k, int64_t len,
                        uint64_t h, int64_t width, uint32_t* upd_slots,
                        uint32_t* upd_lanes, int64_t max_upd,
                        int64_t* n_upd, int* overflow) {
    const int64_t found = kd_find(d, k, len, h);
    if (found >= 0) {
        const uint32_t id = d->table[found].id;
        d->slot_stamp[id] = d->group;
        return id;
    }
    if (*n_upd >= max_upd) { *overflow = 1; return 0; }
    // allocate a slot round-robin, skipping slots referenced this group
    uint32_t id;
    for (;;) {
        if (d->next_slot >= d->slots) d->next_slot = 1;
        id = static_cast<uint32_t>(d->next_slot++);
        if (d->slot_stamp[id] != d->group) break;
    }
    kd_remove(d, id);
    if ((d->live + d->tombstones) * 2 > d->table_cap) kd_rebuild(d);
    const int64_t pos = kd_find_insert_pos(d, h);
    d->table[pos].h = h;
    d->table[pos].id = id;
    d->slot_key[id] = static_cast<uint8_t*>(malloc(len ? len : 1));
    memcpy(d->slot_key[id], k, len);
    d->slot_len[id] = static_cast<int32_t>(len);
    d->slot_stamp[id] = d->group;
    ++d->live;
    const int64_t L = width / 4 + 1;
    const int64_t u = (*n_upd)++;
    upd_slots[u] = id;
    uint32_t row[257];                  // supports width <= 1024 (checked
                                        // host-side in DictEncoder)
    encode_one(k, len, width, row);
    for (int64_t l = 0; l < L; ++l)
        upd_lanes[l * max_upd + u] = row[l];        // lane-major [L, max_upd]
    return id;
}

inline uint32_t kd_id(KcDict* d, const uint8_t* k, int64_t len,
                      int64_t width, uint32_t* upd_slots,
                      uint32_t* upd_lanes, int64_t max_upd,
                      int64_t* n_upd, int* overflow) {
    return kd_id_h(d, k, len, kd_hash(k, len), width, upd_slots, upd_lanes,
                   max_upd, n_upd, overflow);
}

}  // namespace

extern "C" {

// Whole-batch id encoder: same input layout as kc_encode_batch, but emits
// u32 id arrays [B*R] (0 = sentinel padding) + dictionary updates.
// Returns the new n_upd on success, or -(n_upd_partial + 1) if the update
// buffers overflowed — the partial updates are REAL table insertions and
// must still reach the device; the caller re-encodes this batch via the
// lanes path (callers sizing max_upd to the group's endpoint count never
// overflow).
int64_t kc_encode_batch_ids(void* dict, const uint8_t* flat,
                            const int64_t* offs, const int32_t* nr,
                            const int32_t* nw, int64_t n_txns, int64_t B,
                            int64_t R, int64_t width,
                            uint32_t* rbi, uint32_t* rei,
                            uint32_t* wbi, uint32_t* wei,
                            uint32_t* upd_slots, uint32_t* upd_lanes,
                            int64_t max_upd, int64_t n_upd0) {
    KcDict* d = static_cast<KcDict*>(dict);
    for (int64_t i = 0; i < B * R; ++i) rbi[i] = rei[i] = wbi[i] = wei[i] = 0;
    int64_t n_upd = n_upd0;
    int overflow = 0;
    int64_t key = 0;
    for (int64_t i = 0; i < n_txns; ++i) {
        for (int32_t j = 0; j < nr[i]; ++j) {
            rbi[i * R + j] = kd_id(d, flat + offs[key],
                                   offs[key + 1] - offs[key], width,
                                   upd_slots, upd_lanes, max_upd, &n_upd,
                                   &overflow);
            ++key;
            rei[i * R + j] = kd_id(d, flat + offs[key],
                                   offs[key + 1] - offs[key], width,
                                   upd_slots, upd_lanes, max_upd, &n_upd,
                                   &overflow);
            ++key;
        }
        for (int32_t j = 0; j < nw[i]; ++j) {
            wbi[i * R + j] = kd_id(d, flat + offs[key],
                                   offs[key + 1] - offs[key], width,
                                   upd_slots, upd_lanes, max_upd, &n_upd,
                                   &overflow);
            ++key;
            wei[i * R + j] = kd_id(d, flat + offs[key],
                                   offs[key + 1] - offs[key], width,
                                   upd_slots, upd_lanes, max_upd, &n_upd,
                                   &overflow);
            ++key;
        }
        if (overflow) return -(n_upd + 1);
    }
    return n_upd;
}

}  // extern "C"

namespace {

// Shared group walk for both id-encoder layouts.  with_ends=true emits
// the 4-segment [rb|re|wb|we] layout; false emits the compact 2-segment
// [rb|wb] layout (end keys never touch the dictionary).  Returns new
// n_upd or -(partial+1) on update-buffer overflow.
int64_t kd_encode_group(KcDict* d, const uint8_t* flat, const int64_t* offs,
                        const int32_t* nr, const int32_t* nw,
                        const int32_t* counts, int64_t K_real, int64_t K_pad,
                        int64_t B, int64_t R, int64_t width,
                        uint32_t* ids_out, uint32_t* upd_slots,
                        uint32_t* upd_lanes, int64_t max_upd,
                        bool with_ends) {
    const int64_t seg = K_pad * B * R;
    uint32_t* rbi = ids_out;
    uint32_t* rei = with_ends ? ids_out + seg : nullptr;
    uint32_t* wbi = with_ends ? ids_out + 2 * seg : ids_out + seg;
    uint32_t* wei = with_ends ? ids_out + 3 * seg : nullptr;
    int64_t n_upd = 0;
    int overflow = 0;
    int64_t key = 0, t = 0;
    for (int64_t k = 0; k < K_real; ++k) {
        const int64_t base = k * B * R;
        for (int32_t i = 0; i < counts[k]; ++i, ++t) {
            for (int32_t pass = 0; pass < 2; ++pass) {
                const int32_t cnt = pass == 0 ? nr[t] : nw[t];
                uint32_t* bi = pass == 0 ? rbi : wbi;
                uint32_t* ei = pass == 0 ? rei : wei;
                for (int32_t j = 0; j < cnt; ++j) {
                    bi[base + i * R + j] = kd_id(
                        d, flat + offs[key], offs[key + 1] - offs[key],
                        width, upd_slots, upd_lanes, max_upd, &n_upd,
                        &overflow);
                    ++key;
                    if (ei)
                        ei[base + i * R + j] = kd_id(
                            d, flat + offs[key], offs[key + 1] - offs[key],
                            width, upd_slots, upd_lanes, max_upd, &n_upd,
                            &overflow);
                    ++key;
                }
            }
            if (overflow) return -(n_upd + 1);
        }
    }
    return n_upd;
}

}  // namespace

extern "C" {

// Whole-GROUP id encoder: K_real batches' txns concatenated in one blob,
// one ctypes crossing per device dispatch instead of per batch (the
// per-batch Python walk + 9-arg ctypes conversion dominated encode).
//
// counts[K_real]: real txn count per batch.  nr/nw/offs cover the
// concatenated real txns in order.  ids_out: [4 * K_pad * B * R] u32,
// pre-zeroed by the caller (0 = sentinel slot), segment f of size
// K_pad*B*R holds field f (rb|re|wb|we) with batch k at offset k*B*R.
// Returns new n_upd or -(partial+1) on update-buffer overflow.
int64_t kc_encode_group_ids(void* dict, const uint8_t* flat,
                            const int64_t* offs, const int32_t* nr,
                            const int32_t* nw, const int32_t* counts,
                            int64_t K_real, int64_t K_pad, int64_t B,
                            int64_t R, int64_t width,
                            uint32_t* ids_out,
                            uint32_t* upd_slots, uint32_t* upd_lanes,
                            int64_t max_upd) {
    return kd_encode_group(static_cast<KcDict*>(dict), flat, offs, nr, nw,
                           counts, K_real, K_pad, B, R, width, ids_out,
                           upd_slots, upd_lanes, max_upd,
                           /*with_ends=*/true);
}
}  // extern "C"

namespace {

inline bool kd_is_point(const uint8_t* flat, const int64_t* offs,
                        int64_t key) {
    const int64_t blen = offs[key + 1] - offs[key];
    const int64_t elen = offs[key + 2] - offs[key + 1];
    return elen == blen + 1 &&
           flat[offs[key + 1] + blen] == 0 &&
           memcmp(flat + offs[key], flat + offs[key + 1],
                  static_cast<size_t>(blen)) == 0;
}

}  // namespace

extern "C" {

// Group id encoder v2 with point-range compression.  A "point" range is
// [k, k+'\0') — the canonical single-key conflict range; its end key's
// lane row is derivable on device from the begin's (same data lanes,
// length lane + 1), so when EVERY range in the group is a point, only
// begin ids ship: ids_out = [rb | wb], 2 segments, and end endpoints
// never enter the dictionary at all.  Mixed/range groups fall back to
// the 4-segment layout.  *compact_out reports which layout was written.
// Returns new n_upd or -(partial+1) on update-buffer overflow.
int64_t kc_encode_group_ids2(void* dict, const uint8_t* flat,
                             const int64_t* offs, const int32_t* nr,
                             const int32_t* nw, const int32_t* counts,
                             int64_t K_real, int64_t K_pad, int64_t B,
                             int64_t R, int64_t width,
                             uint32_t* ids_out,
                             uint32_t* upd_slots, uint32_t* upd_lanes,
                             int64_t max_upd, int64_t* compact_out) {
    KcDict* d = static_cast<KcDict*>(dict);
    // pass 1: is every range in the group a point?
    bool compact = true;
    {
        int64_t key = 0, t = 0;
        for (int64_t k = 0; k < K_real && compact; ++k) {
            for (int32_t i = 0; i < counts[k] && compact; ++i, ++t) {
                for (int32_t j = 0; j < nr[t] + nw[t]; ++j, key += 2) {
                    if (!kd_is_point(flat, offs, key)) { compact = false; break; }
                }
            }
            if (!compact) break;
        }
    }
    *compact_out = compact ? 1 : 0;
    if (!compact)
        return kc_encode_group_ids(dict, flat, offs, nr, nw, counts, K_real,
                                   K_pad, B, R, width, ids_out, upd_slots,
                                   upd_lanes, max_upd);
    return kd_encode_group(d, flat, offs, nr, nw, counts, K_real, K_pad,
                           B, R, width, ids_out, upd_slots, upd_lanes,
                           max_upd, /*with_ends=*/false);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused group encoder.  One native call per device dispatch does ALL
// host-side group assembly: walks the K wires' buffers directly (no Python
// blob concat / offset rebasing), decides point-compactness, encodes
// endpoint ids with software-prefetched hash probes, and writes ids +
// snapshots + commit versions into ONE fused u32 buffer that ships as a
// single host-to-device copy.

namespace {

struct KeyRef {
    const uint8_t* p;
    int64_t len;
    int64_t dst;            // index into ids_out
};

// chunked id assignment with table-line prefetch: pass 1 hashes (key bytes
// are sequential in the wire blob, so this also warms them for the memcmp
// confirm), pass 2 probes.  The large dictionary table (~10s of MB) makes
// every cold probe a cache+TLB miss; overlapping 32 of them via prefetch
// is worth ~2x on the hash-bound path.
inline int64_t kd_ids_chunked(KcDict* d, const KeyRef* refs, int64_t n,
                              int64_t width, uint32_t* ids_out,
                              uint32_t* upd_slots, uint32_t* upd_lanes,
                              int64_t max_upd, int64_t* n_upd,
                              int* overflow) {
    constexpr int64_t CHUNK = 32;
    uint64_t h[CHUNK];
    const uint64_t mask = d->table_cap - 1;
    for (int64_t base = 0; base < n; base += CHUNK) {
        const int64_t m = n - base < CHUNK ? n - base : CHUNK;
        for (int64_t j = 0; j < m; ++j) {
            h[j] = kd_hash(refs[base + j].p, refs[base + j].len);
            __builtin_prefetch(&d->table[h[j] & mask], 0, 1);
        }
        // second wave: for probable hits, prefetch the confirm data
        // (slot key bytes + stamp line) before the probe loop touches it
        for (int64_t j = 0; j < m; ++j) {
            const KcEntry& e = d->table[h[j] & mask];
            if (e.h == h[j]) {
                __builtin_prefetch(d->slot_key[e.id], 0, 1);
                __builtin_prefetch(&d->slot_stamp[e.id], 1, 1);
            }
        }
        for (int64_t j = 0; j < m; ++j) {
            const KeyRef& r = refs[base + j];
            const uint32_t id = kd_id_h(d, r.p, r.len, h[j], width,
                                        upd_slots, upd_lanes, max_upd,
                                        n_upd, overflow);
            if (*overflow) return 0;
            ids_out[r.dst] = id;
        }
    }
    return 0;
}

inline bool kd_wire_all_points(const uint8_t* blob, const int64_t* offs,
                               const int32_t* nr, const int32_t* nw,
                               const int32_t count) {
    int64_t key = 0;
    // offs are wire-local; key counts endpoint pairs
    for (int64_t t = 0; t < count; ++t) {
        const int32_t pairs = nr[t] + nw[t];
        for (int32_t j = 0; j < pairs; ++j, key += 2) {
            const int64_t blen = offs[key + 1] - offs[key];
            const int64_t elen = offs[key + 2] - offs[key + 1];
            if (!(elen == blen + 1 && blob[offs[key + 1] + blen] == 0 &&
                  memcmp(blob + offs[key], blob + offs[key + 1],
                         static_cast<size_t>(blen)) == 0))
                return false;
        }
    }
    return true;
}

}  // namespace

extern "C" {

// Fused group encoder.  Walks per-wire buffers (no concatenation):
//   blobs[k], offs_list[k], nr_list[k], nw_list[k], snaps_list[k] are
//   ALL per-wire pointers indexed by wire-local txn i; counts[k] gives
//   each wire's real txn count and versions[k] its commit version.
// fused layout (u32 words), written here:
//   [0, nids)            endpoint ids; nids = (compact?2:4)*K_pad*B*R
//   [off_pi, off_pi+npi) snapshots [K_pad*B] + versions [K_pad] as i64
//                        (u32 pairs, little-endian); off_pi = nids rounded
//                        up to even, npi = 2*(K_pad*B + K_pad)
// The caller appends the update region after off_pi+npi once n_upd is
// known (bucketed), then ships fused[:total] in ONE copy.
// Returns n_upd, or -(partial+1) on update-buffer overflow; *compact_out
// and *off_pi_out report the layout.
int64_t kc_encode_group_fused(
        void* dict, const uint8_t** blobs, const int64_t** offs_list,
        const int32_t** nr_list, const int32_t** nw_list,
        const int64_t** snaps_list,
        const int32_t* counts, const int64_t* versions,
        int64_t K_real, int64_t K_pad, int64_t B, int64_t R, int64_t width,
        uint32_t* fused, uint32_t* upd_slots, uint32_t* upd_lanes,
        int64_t max_upd, int64_t* compact_out, int64_t* off_pi_out) {
    KcDict* d = static_cast<KcDict*>(dict);
    // pass 1: compactness (every range in the group a point range)
    bool compact = true;
    for (int64_t k = 0; k < K_real && compact; ++k)
        compact = kd_wire_all_points(blobs[k], offs_list[k], nr_list[k],
                                     nw_list[k], counts[k]);
    *compact_out = compact ? 1 : 0;
    const int64_t seg = K_pad * B * R;
    const int64_t nids = (compact ? 2 : 4) * seg;
    const int64_t off_pi = (nids + 1) & ~int64_t(1);
    *off_pi_out = off_pi;
    memset(fused, 0, static_cast<size_t>(nids) * 4);        // 0 = sentinel

    // pi64 region: snapshots then versions, -1 padded
    int64_t* pi = reinterpret_cast<int64_t*>(fused + off_pi);
    for (int64_t i = 0; i < K_pad * B + K_pad; ++i) pi[i] = -1;
    for (int64_t k = 0; k < K_real; ++k) {
        for (int32_t i = 0; i < counts[k]; ++i)
            pi[k * B + i] = snaps_list[k][i];
        pi[K_pad * B + k] = versions[k];
    }

    // pass 2: ids via chunked prefetching lookup (dict keys only:
    // begins always; ends only in the 4-segment layout); each KeyRef's
    // dst is the absolute index into the segment layout
    int64_t n_upd = 0;
    int overflow = 0;
    // worst case per wire: B txns x 2 passes x R ranges x 2 endpoints
    KeyRef* refs = static_cast<KeyRef*>(
        malloc(static_cast<size_t>(4 * B * R) * sizeof(KeyRef)));
    for (int64_t k = 0; k < K_real; ++k) {
        const uint8_t* blob = blobs[k];
        const int64_t* offs = offs_list[k];
        const int32_t* nr = nr_list[k];
        const int32_t* nw = nw_list[k];
        const int64_t base = k * B * R;
        int64_t nref = 0;
        int64_t key = 0;
        for (int32_t i = 0; i < counts[k]; ++i) {
            for (int32_t pass = 0; pass < 2; ++pass) {
                const int32_t cnt = pass == 0 ? nr[i] : nw[i];
                const int64_t seg_b = pass == 0 ? 0 : (compact ? seg : 2 * seg);
                const int64_t seg_e = pass == 0 ? seg : 3 * seg;
                for (int32_t j = 0; j < cnt; ++j) {
                    refs[nref].p = blob + offs[key];
                    refs[nref].len = offs[key + 1] - offs[key];
                    refs[nref].dst = seg_b + base + i * R + j;
                    ++nref;
                    ++key;
                    if (!compact) {
                        refs[nref].p = blob + offs[key];
                        refs[nref].len = offs[key + 1] - offs[key];
                        refs[nref].dst = seg_e + base + i * R + j;
                        ++nref;
                    }
                    ++key;
                }
            }
        }
        kd_ids_chunked(d, refs, nref, width, fused, upd_slots, upd_lanes,
                       max_upd, &n_upd, &overflow);
        if (overflow) { free(refs); return -(n_upd + 1); }
    }
    free(refs);
    return n_upd;
}

}  // extern "C"
