// CPU conflict set — the sorted-structure baseline the TPU kernel competes
// against, and the "cpp" resolver backend.
//
// Role-equivalent of the reference's SkipList-based ConflictSet
// (REF:fdbserver/SkipList.cpp: ConflictBatch::addTransaction /
// detectConflicts / setOldestVersion), rebuilt from semantics, not code:
// instead of a probabilistic skip list of keys with per-node version
// arrays, we keep the canonical interval-version map — an ordered map from
// boundary key to the max write version of the segment starting there,
// covering the whole keyspace.  Check = walk the segments a read range
// overlaps; insert = range assignment (commit versions are monotonically
// increasing, so assignment == max-combine).  Same O(log n + k) class as
// the reference's structure, cache-friendly, and exact on raw byte keys.
//
// Batch semantics match ops/oracle.py exactly (tested): transactions are
// resolved in order; a committed txn's writes are visible to later txns in
// the same batch at the batch commit version.
//
// C ABI (ctypes-friendly), keys passed as one blob + (offset,len) pairs.

#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <string_view>

namespace {

struct ConflictSet {
    // boundary key -> version of segment [key, next_key); "" always present.
    // std::less<> enables heterogeneous string_view lookups (no copies on
    // the hot check path).
    std::map<std::string, int64_t, std::less<>> seg;
    int64_t oldest = 0;

    explicit ConflictSet(int64_t oldest_version) : oldest(oldest_version) {
        seg.emplace("", -1);
    }

    bool check_read(std::string_view b, std::string_view e, int64_t snap) const {
        // segment containing b: greatest boundary <= b
        auto it = seg.upper_bound(b);
        --it;  // safe: "" <= b always exists
        for (; it != seg.end() && std::string_view(it->first) < e; ++it) {
            // segment [it->first, next) intersects [b,e) by construction
            if (it->second > snap) return true;
        }
        return false;
    }

    void add_write(std::string_view bv, std::string_view ev, int64_t version) {
        if (bv >= ev) return;
        std::string b(bv), e(ev);
        // value in effect at e, to re-open the segment after the write
        auto ite = seg.upper_bound(std::string_view(e));
        --ite;
        int64_t at_e = ite->second;
        // erase boundaries inside [b, e), set [b] = version, [e] = at_e
        auto lo = seg.lower_bound(std::string_view(b));
        auto hi = seg.lower_bound(std::string_view(e));
        seg.erase(lo, hi);
        seg[b] = version;
        seg[e] = at_e;  // may overwrite nothing or re-add an erased boundary
    }

    void set_oldest(int64_t v) {
        if (v <= oldest) return;
        oldest = v;
        // compact: clamp stale versions to -1 and merge equal neighbors,
        // mirroring setOldestVersion's history eviction
        int64_t prev = INT64_MIN;
        for (auto it = seg.begin(); it != seg.end();) {
            if (it->second <= oldest && it->second != -1) it->second = -1;
            if (it->second == prev && it != seg.begin()) {
                it = seg.erase(it);
            } else {
                prev = it->second;
                ++it;
            }
        }
    }
};

inline std::string_view key_at(const uint8_t* blob, const int64_t* offs,
                               const int64_t* lens, int64_t i) {
    return std::string_view(reinterpret_cast<const char*>(blob) + offs[i],
                            static_cast<size_t>(lens[i]));
}

}  // namespace

extern "C" {

void* cs_create(int64_t oldest_version) { return new ConflictSet(oldest_version); }
void cs_destroy(void* p) { delete static_cast<ConflictSet*>(p); }
void cs_set_oldest(void* p, int64_t v) { static_cast<ConflictSet*>(p)->set_oldest(v); }
int64_t cs_get_oldest(void* p) { return static_cast<ConflictSet*>(p)->oldest; }
int64_t cs_segment_count(void* p) { return (int64_t)static_cast<ConflictSet*>(p)->seg.size(); }

// Resolve a batch.
//   ntxns                transactions, in commit order
//   snapshots[ntxns]     read versions
//   r_off[ntxns+1]       txn i's read ranges are r_off[i]..r_off[i+1] (exclusive)
//   w_off[ntxns+1]       same for write ranges
//   ranges: for range j, keys 2j (begin) and 2j+1 (end) index into
//   blob via key_offs/key_lens.  Read ranges and write ranges are two
//   separate range arrays over the same blob.
//   verdicts_out[ntxns]: 0 committed, 1 conflict, 2 too old
void cs_resolve(void* p, int32_t ntxns, const int64_t* snapshots,
                const int32_t* r_off, const int64_t* r_key_offs, const int64_t* r_key_lens,
                const int32_t* w_off, const int64_t* w_key_offs, const int64_t* w_key_lens,
                const uint8_t* blob, int64_t commit_version, int8_t* verdicts_out) {
    auto* cs = static_cast<ConflictSet*>(p);
    for (int32_t i = 0; i < ntxns; ++i) {
        if (snapshots[i] < cs->oldest) {
            verdicts_out[i] = 2;
            continue;
        }
        bool conflict = false;
        for (int32_t j = r_off[i]; j < r_off[i + 1] && !conflict; ++j) {
            auto b = key_at(blob, r_key_offs, r_key_lens, 2 * j);
            auto e = key_at(blob, r_key_offs, r_key_lens, 2 * j + 1);
            conflict = cs->check_read(b, e, snapshots[i]);
        }
        if (conflict) {
            verdicts_out[i] = 1;
        } else {
            verdicts_out[i] = 0;
            for (int32_t j = w_off[i]; j < w_off[i + 1]; ++j) {
                auto b = key_at(blob, w_key_offs, w_key_lens, 2 * j);
                auto e = key_at(blob, w_key_offs, w_key_lens, 2 * j + 1);
                cs->add_write(b, e, commit_version);
            }
        }
    }
}

}  // extern "C"

extern "C" {

// Resolve a batch in the resolver WIRE layout — the serialized form a
// commit proxy ships (one blob; per txn: nr read ranges' begin/end keys
// then nw write ranges', interleaved in txn order).  Identical verdict
// semantics to cs_resolve; offs[nkeys+1] are byte offsets into blob.
void cs_resolve_wire(void* p, int32_t ntxns, const int64_t* snapshots,
                     const int32_t* nr, const int32_t* nw,
                     const int64_t* offs, const uint8_t* blob,
                     int64_t commit_version, int8_t* verdicts_out) {
    auto* cs = static_cast<ConflictSet*>(p);
    int64_t key = 0;
    for (int32_t i = 0; i < ntxns; ++i) {
        if (snapshots[i] < cs->oldest) {
            verdicts_out[i] = 2;
            key += 2 * (static_cast<int64_t>(nr[i]) + nw[i]);
            continue;
        }
        bool conflict = false;
        for (int32_t j = 0; j < nr[i]; ++j, key += 2) {
            if (conflict) continue;
            auto b = std::string_view(
                reinterpret_cast<const char*>(blob) + offs[key],
                static_cast<size_t>(offs[key + 1] - offs[key]));
            auto e = std::string_view(
                reinterpret_cast<const char*>(blob) + offs[key + 1],
                static_cast<size_t>(offs[key + 2] - offs[key + 1]));
            conflict = cs->check_read(b, e, snapshots[i]);
        }
        if (conflict) {
            verdicts_out[i] = 1;
            key += 2 * static_cast<int64_t>(nw[i]);
        } else {
            verdicts_out[i] = 0;
            for (int32_t j = 0; j < nw[i]; ++j, key += 2) {
                auto b = std::string_view(
                    reinterpret_cast<const char*>(blob) + offs[key],
                    static_cast<size_t>(offs[key + 1] - offs[key]));
                auto e = std::string_view(
                    reinterpret_cast<const char*>(blob) + offs[key + 1],
                    static_cast<size_t>(offs[key + 2] - offs[key + 1]));
                cs->add_write(b, e, commit_version);
            }
        }
    }
}

}  // extern "C"
