// Native shared-memory object store ("plasma-lite" arena), copied from
// ray_tpu/_private/native/store.cc (the port imports nothing of ray_tpu and
// builds this file into ray_tpu_torch/_build/ itself).
//
// Instead of a store *server* process speaking a socket protocol, every
// client maps one arena file on tmpfs and mutates it directly under a
// process-shared robust mutex: the store's clients are all local, so a
// socket hop per create/get would be pure overhead. The verbs
// (create/seal/get/delete/contains/evict) are plasma's client API.
//
// Layout of the arena file:
//   [ArenaHeader | index: NSLOTS * IndexSlot | data region]
// Data region is managed by a first-fit free list with boundary tags
// (header+footer per block) so frees coalesce in O(1) with both physical
// neighbours — the same discipline dlmalloc uses, minus the size bins.
//
// Concurrency: one pthread mutex (PTHREAD_PROCESS_SHARED + ROBUST) in the
// header guards index + allocator. Object *payload* writes happen outside
// the lock between create() and seal(): the slot is CREATED (invisible to
// lookup) until sealed, the same create→seal visibility contract as plasma.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545053544f5245ull;  // "RTPSTORE"
constexpr uint32_t kVersion = 2;
constexpr uint32_t kIdLen = 48;        // "obj_" + 32 hex + NUL fits
constexpr uint32_t kNumSlots = 1 << 16;
constexpr uint64_t kAlign = 64;        // block + payload alignment
constexpr uint32_t kMaxPinners = 8;    // per-object pin-attribution slots

// Block tags. size includes header+footer. Low bit = allocated.
// Block layout: [head tag (8B) | pad to kAlign | payload | foot tag (8B)];
// blocks start kAlign-aligned and payloads begin at block+kAlign, so
// zero-copy numpy views really are cacheline-aligned.
constexpr uint64_t kAllocBit = 1ull;
constexpr uint64_t kTagSize = 8;       // one u64 tag at each end
constexpr uint64_t kPayloadOff = kAlign;  // payload offset within a block

enum SlotState : uint32_t {
  kEmpty = 0,
  kCreated = 1,
  kSealed = 2,
  kTombstone = 3,
  // Deleted while readers still hold pins: invisible to lookup, block stays
  // allocated until the last rts_pin(-1) drops refcnt to zero (the plasma
  // "delete defers until Release" contract, plasma/object_lifecycle_manager.h).
  kCondemned = 4,
};

struct PinEntry {
  uint32_t pid;             // owning process
  uint32_t count;           // pins held by that process (0 = slot free)
};

struct IndexSlot {
  uint32_t state;
  uint32_t refcnt;          // total pin count; eviction skips pinned objects
  uint64_t offset;          // payload offset from arena base
  uint64_t size;            // payload size in bytes
  uint64_t tick;            // LRU clock value of last lookup/seal
  uint32_t creator_pid;     // reclaims unsealed blocks when creator dies
  uint32_t pad_;
  // Pins attributed per process so a dead client's pins can be force-
  // released (rts_release_all) — the counterpart of plasma dropping a
  // disconnected client's references. Overflow pins (more than kMaxPinners
  // concurrent pinning processes) stay unattributed in refcnt and are not
  // reclaimable, matching the old behavior.
  PinEntry pinners[kMaxPinners];
  char id[kIdLen];
};

struct ArenaHeader {
  uint64_t magic;
  uint32_t version;
  uint32_t num_slots;
  pthread_mutex_t mutex;
  uint64_t capacity;        // bytes in data region
  uint64_t data_off;        // arena-relative start of data region
  uint64_t index_off;
  uint64_t used;            // bytes allocated (incl. tags)
  uint64_t tick;            // LRU clock
  uint64_t num_objects;
  uint64_t num_evictions;
  uint64_t free_head;       // arena-relative offset of first free block, 0=none
  // Set when a client died holding the mutex mid-mutation: allocator
  // metadata can no longer be trusted, so allocation/free/evict are refused
  // for the rest of the session. Sealed payloads and the index remain
  // readable (index writes are single-slot and idempotent).
  uint32_t poisoned;
};

struct Handle {
  int fd;
  uint8_t* base;
  uint64_t map_len;
  ArenaHeader* hdr;
  uint32_t pid;             // pin attribution identity of this client
};

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

inline uint64_t* tag_at(Handle* h, uint64_t off) {
  return reinterpret_cast<uint64_t*>(h->base + off);
}
// free blocks keep a next-pointer right after the head tag
inline uint64_t* next_ptr(Handle* h, uint64_t off) {
  return reinterpret_cast<uint64_t*>(h->base + off + kTagSize);
}

inline uint64_t block_size(uint64_t tag) { return tag & ~kAllocBit; }
inline bool block_alloc(uint64_t tag) { return tag & kAllocBit; }

void set_tags(Handle* h, uint64_t off, uint64_t size, bool alloc) {
  uint64_t tag = size | (alloc ? kAllocBit : 0);
  *tag_at(h, off) = tag;
  *tag_at(h, off + size - kTagSize) = tag;
}

IndexSlot* slots(Handle* h) {
  return reinterpret_cast<IndexSlot*>(h->base + h->hdr->index_off);
}

uint64_t hash_id(const char* id) {
  // FNV-1a
  uint64_t x = 1469598103934665603ull;
  for (const char* p = id; *p; ++p) x = (x ^ (uint64_t)(uint8_t)*p) * 1099511628211ull;
  return x;
}

// Find slot for id. If `for_insert`, returns the first reusable slot when
// the id is absent. Returns nullptr if absent and table is full / not insert.
IndexSlot* find_slot(Handle* h, const char* id, bool for_insert) {
  ArenaHeader* hdr = h->hdr;
  IndexSlot* tab = slots(h);
  uint64_t mask = hdr->num_slots - 1;
  uint64_t i = hash_id(id) & mask;
  IndexSlot* insert = nullptr;
  for (uint32_t probe = 0; probe < hdr->num_slots; ++probe, i = (i + 1) & mask) {
    IndexSlot* s = &tab[i];
    if (s->state == kEmpty) {
      if (for_insert) return insert ? insert : s;
      return nullptr;
    }
    if (s->state == kTombstone) {
      if (!insert) insert = s;
      continue;
    }
    if (strncmp(s->id, id, kIdLen) == 0) return s;
  }
  return for_insert ? insert : nullptr;
}

// -- pin attribution ----------------------------------------------------------

void pin_add(IndexSlot* s, uint32_t pid, uint32_t n) {
  s->refcnt += n;
  PinEntry* empty = nullptr;
  for (uint32_t i = 0; i < kMaxPinners; ++i) {
    PinEntry* e = &s->pinners[i];
    if (e->count != 0 && e->pid == pid) { e->count += n; return; }
    if (e->count == 0 && !empty) empty = e;
  }
  if (empty) { empty->pid = pid; empty->count = n; }
}

void pin_sub(IndexSlot* s, uint32_t pid, uint32_t n) {
  for (uint32_t i = 0; i < kMaxPinners; ++i) {
    PinEntry* e = &s->pinners[i];
    if (e->count != 0 && e->pid == pid) {
      e->count -= (n < e->count) ? n : e->count;
      break;
    }
  }
  if (s->refcnt >= n) s->refcnt -= n; else s->refcnt = 0;
}

void lock(Handle* h) {
  int rc = pthread_mutex_lock(&h->hdr->mutex);
  if (rc == EOWNERDEAD) {
    // A client died holding the lock, possibly mid-way through a
    // free-list/tag mutation. Recover the mutex but poison the allocator:
    // existing sealed objects stay readable, new allocation moves to the
    // caller's fallback path (per-object files).
    h->hdr->poisoned = 1;
    pthread_mutex_consistent(&h->hdr->mutex);
  }
}
void unlock(Handle* h) { pthread_mutex_unlock(&h->hdr->mutex); }

// -- free-list allocator ------------------------------------------------------

void freelist_push(Handle* h, uint64_t off) {
  *next_ptr(h, off) = h->hdr->free_head;
  h->hdr->free_head = off;
}

void freelist_remove(Handle* h, uint64_t off) {
  uint64_t* cur = &h->hdr->free_head;
  while (*cur) {
    if (*cur == off) {
      *cur = *next_ptr(h, off);
      return;
    }
    cur = next_ptr(h, *cur);
  }
}

// Allocate a block whose payload is >= payload_size bytes. Returns payload
// offset (arena-relative) or 0 on failure.
uint64_t alloc_block(Handle* h, uint64_t payload_size) {
  ArenaHeader* hdr = h->hdr;
  uint64_t need = align_up(payload_size + kPayloadOff + kTagSize, kAlign);
  // min block must hold tags + next pointer when freed
  if (need < kAlign) need = kAlign;
  uint64_t* cur = &hdr->free_head;
  while (*cur) {
    uint64_t off = *cur;
    uint64_t bsz = block_size(*tag_at(h, off));
    if (bsz >= need) {
      *cur = *next_ptr(h, off);  // unlink
      uint64_t rem = bsz - need;
      if (rem >= kAlign) {  // split
        set_tags(h, off + need, rem, false);
        freelist_push(h, off + need);
        bsz = need;
      }
      set_tags(h, off, bsz, true);
      hdr->used += bsz;
      return off + kPayloadOff;
    }
    cur = next_ptr(h, off);
  }
  return 0;
}

void free_block(Handle* h, uint64_t payload_off) {
  ArenaHeader* hdr = h->hdr;
  uint64_t off = payload_off - kPayloadOff;
  uint64_t size = block_size(*tag_at(h, off));
  hdr->used -= size;
  uint64_t data_end = hdr->data_off + hdr->capacity;
  // coalesce forward
  uint64_t next = off + size;
  if (next < data_end && !block_alloc(*tag_at(h, next))) {
    freelist_remove(h, next);
    size += block_size(*tag_at(h, next));
  }
  // coalesce backward
  if (off > hdr->data_off) {
    uint64_t prev_tag = *tag_at(h, off - kTagSize);
    if (!block_alloc(prev_tag)) {
      uint64_t prev = off - block_size(prev_tag);
      freelist_remove(h, prev);
      size += off - prev;
      off = prev;
    }
  }
  set_tags(h, off, size, false);
  freelist_push(h, off);
}

// Free a condemned slot once its last pin is gone. Caller holds the lock.
void maybe_reap_locked(Handle* h, IndexSlot* s) {
  if (s->state == kCondemned && s->refcnt == 0 && !h->hdr->poisoned) {
    free_block(h, s->offset);
    s->state = kTombstone;
    h->hdr->num_objects--;
  }
}

// Evict sealed, unpinned objects in LRU order until at least `goal` bytes
// are freed. Single pass over the index: collect candidates, sort by LRU
// tick, free in order (counterpart of plasma's eviction_policy.h LRU list).
// Caller holds the lock. Returns bytes freed.
uint64_t evict_locked(Handle* h, uint64_t goal) {
  ArenaHeader* hdr = h->hdr;
  if (hdr->poisoned) return 0;
  IndexSlot* tab = slots(h);
  struct Cand { uint64_t tick; uint32_t idx; };
  Cand* cands = new Cand[hdr->num_objects ? hdr->num_objects : 1];
  uint32_t n = 0;
  for (uint32_t i = 0; i < hdr->num_slots; ++i) {
    IndexSlot* s = &tab[i];
    if (s->state == kSealed && s->refcnt == 0) cands[n++] = {s->tick, i};
  }
  // insertion sort by tick ascending (candidate counts are modest; avoids
  // pulling <algorithm> into the shared header ABI surface)
  for (uint32_t i = 1; i < n; ++i) {
    Cand key = cands[i];
    uint32_t j = i;
    for (; j > 0 && cands[j - 1].tick > key.tick; --j) cands[j] = cands[j - 1];
    cands[j] = key;
  }
  uint64_t freed = 0;
  for (uint32_t i = 0; i < n && freed < goal; ++i) {
    IndexSlot* s = &tab[cands[i].idx];
    uint64_t before = hdr->used;
    free_block(h, s->offset);
    freed += before - hdr->used;
    s->state = kTombstone;
    hdr->num_objects--;
    hdr->num_evictions++;
  }
  delete[] cands;
  return freed;
}

}  // namespace

extern "C" {

// Open (or create+initialize) the arena at `path` with `capacity` data bytes.
// Creation must be externally serialized (the Python side holds a file lock).
void* rts_open(const char* path, uint64_t capacity, int create) {
  uint64_t index_bytes = (uint64_t)kNumSlots * sizeof(IndexSlot);
  uint64_t data_off = align_up(sizeof(ArenaHeader) + index_bytes, 4096);
  int fd = open(path, create ? (O_RDWR | O_CREAT) : O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  bool init = (st.st_size == 0);
  uint64_t map_len = init ? data_off + capacity : (uint64_t)st.st_size;
  if (init && ftruncate(fd, (off_t)map_len) != 0) { close(fd); return nullptr; }
  void* base = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }
  Handle* h = new Handle{fd, static_cast<uint8_t*>(base), map_len,
                         reinterpret_cast<ArenaHeader*>(base),
                         (uint32_t)getpid()};
  if (init) {
    ArenaHeader* hdr = h->hdr;
    memset(hdr, 0, sizeof(*hdr));
    hdr->version = kVersion;
    hdr->num_slots = kNumSlots;
    hdr->capacity = map_len - data_off;
    hdr->data_off = data_off;
    hdr->index_off = sizeof(ArenaHeader);
    memset(h->base + hdr->index_off, 0, index_bytes);
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hdr->mutex, &attr);
    pthread_mutexattr_destroy(&attr);
    set_tags(h, hdr->data_off, hdr->capacity, false);
    freelist_push(h, hdr->data_off);
    __sync_synchronize();
    hdr->magic = kMagic;  // published last: openers check magic
  } else if (h->hdr->magic != kMagic || h->hdr->version != kVersion) {
    munmap(base, map_len);
    close(fd);
    delete h;
    return nullptr;
  }
  return h;
}

void rts_close(void* vh) {
  Handle* h = static_cast<Handle*>(vh);
  if (!h) return;
  munmap(h->base, h->map_len);
  close(h->fd);
  delete h;
}

// Reserve space for an object. Returns payload offset, or 0 if out of space
// (after attempting eviction) / duplicate id / index full.
uint64_t rts_create(void* vh, const char* id, uint64_t size) {
  Handle* h = static_cast<Handle*>(vh);
  lock(h);
  if (h->hdr->poisoned) { unlock(h); return 0; }
  IndexSlot* s = find_slot(h, id, true);
  if (!s || (s->state != kEmpty && s->state != kTombstone)) {
    unlock(h);
    return 0;
  }
  uint64_t off = alloc_block(h, size);
  if (!off) {
    // mirror alloc_block's block-size formula or eviction frees too little
    uint64_t need = align_up(size + kPayloadOff + kTagSize, kAlign);
    if (evict_locked(h, need) >= need) off = alloc_block(h, size);
    if (!off) { unlock(h); return 0; }
  }
  s->state = kCreated;
  s->refcnt = 0;
  s->offset = off;
  s->size = size;
  s->tick = ++h->hdr->tick;
  s->creator_pid = h->pid;
  memset(s->pinners, 0, sizeof(s->pinners));
  strncpy(s->id, id, kIdLen - 1);
  s->id[kIdLen - 1] = '\0';
  h->hdr->num_objects++;
  unlock(h);
  return off;
}

int rts_seal(void* vh, const char* id) {
  Handle* h = static_cast<Handle*>(vh);
  lock(h);
  IndexSlot* s = find_slot(h, id, false);
  int rc = -1;
  if (s && s->state == kCreated) {
    s->state = kSealed;
    s->tick = ++h->hdr->tick;
    rc = 0;
  }
  unlock(h);
  return rc;
}

// Look up a sealed object. Returns payload offset (0 if absent) and fills
// *size. Touches the LRU clock.
uint64_t rts_lookup(void* vh, const char* id, uint64_t* size) {
  Handle* h = static_cast<Handle*>(vh);
  lock(h);
  IndexSlot* s = find_slot(h, id, false);
  uint64_t off = 0;
  if (s && s->state == kSealed) {
    off = s->offset;
    *size = s->size;
    s->tick = ++h->hdr->tick;
  }
  unlock(h);
  return off;
}

int rts_contains(void* vh, const char* id) {
  Handle* h = static_cast<Handle*>(vh);
  lock(h);
  IndexSlot* s = find_slot(h, id, false);
  int rc = (s && s->state == kSealed) ? 1 : 0;
  unlock(h);
  return rc;
}

// Delete an object. Pins are untouched: with no pins the block is freed
// immediately; with outstanding pins the slot is condemned — invisible to
// lookup, reclaimed when the last rts_pin(-1) lands (plasma's
// deferred-delete contract). Callers holding their own pin (the runtime's
// put-time owner pin) must release it before or after calling delete.
int rts_delete(void* vh, const char* id) {
  Handle* h = static_cast<Handle*>(vh);
  lock(h);
  IndexSlot* s = find_slot(h, id, false);
  int rc = -1;
  if (s && (s->state == kSealed || s->state == kCreated)) {
    if (s->refcnt == 0) {
      if (!h->hdr->poisoned) {
        free_block(h, s->offset);
        s->state = kTombstone;
      } else {
        s->state = kCondemned;  // space unreclaimable; keep it invisible
      }
      h->hdr->num_objects--;
    } else {
      // num_objects stays: decremented when the last pin frees the block
      s->state = kCondemned;
    }
    rc = 0;
  }
  unlock(h);
  return rc;
}

// Pin/unpin an object against eviction (plasma client Get/Release analog).
// Unpinning a condemned object to zero frees its block.
int rts_pin(void* vh, const char* id, int delta) {
  Handle* h = static_cast<Handle*>(vh);
  lock(h);
  IndexSlot* s = find_slot(h, id, false);
  int rc = -1;
  if (s && (s->state == kSealed || s->state == kCreated ||
            s->state == kCondemned)) {
    if (delta > 0) pin_add(s, h->pid, (uint32_t)delta);
    else pin_sub(s, h->pid, (uint32_t)(-delta));
    maybe_reap_locked(h, s);
    rc = (int)s->refcnt;
  }
  unlock(h);
  return rc;
}

// Atomic pin+lookup for readers: pins the object so delete/eviction cannot
// free the bytes under a live zero-copy view, then returns its offset.
uint64_t rts_acquire(void* vh, const char* id, uint64_t* size) {
  Handle* h = static_cast<Handle*>(vh);
  lock(h);
  IndexSlot* s = find_slot(h, id, false);
  uint64_t off = 0;
  if (s && s->state == kSealed) {
    pin_add(s, h->pid, 1);
    s->tick = ++h->hdr->tick;
    off = s->offset;
    *size = s->size;
  }
  unlock(h);
  return off;
}

// Force-release every pin a (dead) process holds and reclaim its unsealed
// creations. The counterpart of plasma releasing a disconnected client's
// references: without it, a crashed worker's put-time owner pins and
// reader pins condemn blocks forever. Returns the number of slots touched.
uint64_t rts_release_all(void* vh, uint32_t pid) {
  Handle* h = static_cast<Handle*>(vh);
  lock(h);
  IndexSlot* tab = slots(h);
  uint64_t touched = 0;
  for (uint32_t i = 0; i < h->hdr->num_slots; ++i) {
    IndexSlot* s = &tab[i];
    if (s->state != kSealed && s->state != kCreated &&
        s->state != kCondemned)
      continue;
    for (uint32_t j = 0; j < kMaxPinners; ++j) {
      PinEntry* e = &s->pinners[j];
      if (e->count != 0 && e->pid == pid) {
        uint32_t c = e->count;
        e->count = 0;
        s->refcnt = (s->refcnt >= c) ? s->refcnt - c : 0;
        maybe_reap_locked(h, s);
        touched++;
        break;
      }
    }
    if (s->state == kCreated && s->creator_pid == pid && s->refcnt == 0) {
      // crashed mid-put: the reservation would never be sealed or deleted
      if (!h->hdr->poisoned) {
        free_block(h, s->offset);
        s->state = kTombstone;
      } else {
        s->state = kCondemned;
      }
      h->hdr->num_objects--;
      touched++;
    }
  }
  unlock(h);
  return touched;
}

uint64_t rts_evict(void* vh, uint64_t nbytes) {
  Handle* h = static_cast<Handle*>(vh);
  lock(h);
  uint64_t freed = evict_locked(h, nbytes);
  unlock(h);
  return freed;
}

int rts_poisoned(void* vh) {
  Handle* h = static_cast<Handle*>(vh);
  return (int)h->hdr->poisoned;
}

// out[6] = {capacity, used, num_objects, num_evictions, data_off, map_len}
void rts_stats(void* vh, uint64_t* out) {
  Handle* h = static_cast<Handle*>(vh);
  lock(h);
  out[0] = h->hdr->capacity;
  out[1] = h->hdr->used;
  out[2] = h->hdr->num_objects;
  out[3] = h->hdr->num_evictions;
  out[4] = h->hdr->data_off;
  out[5] = h->map_len;
  unlock(h);
}

// Base pointer of this process's mapping (payload offsets are relative to it).
void* rts_base(void* vh) { return static_cast<Handle*>(vh)->base; }

}  // extern "C"
