// Shared-memory object store with mutable objects.
//
// Reference role: src/ray/object_manager/plasma/ (store/create/seal/get over
// shm) + the mutable-object support used by compiled-graph channels
// (experimental_mutable_object_provider.cc) [unverified]. Re-designed, not
// ported: one POSIX shm arena per "node", a fixed open-addressing object
// table and bump allocator inside the segment (all offsets, no pointers),
// process-shared pthread mutex/cond per mutable slot for the single-writer/
// multi-reader versioned-buffer protocol. The host-side channel substrate;
// device payloads stay in HBM and only control/small objects cross here.
//
// Build (ray_tpu_torch/_native/build.py): g++ -O2 -shared -fPIC -pthread
//        -std=c++17 object_store.cc task_queue.cc
//        -o libray_tpu_torch_native-<hash>.so -lrt

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52415954505553ULL;  // "RAYTPUS"

enum EntryState : uint32_t {
  kEmpty = 0,
  kCreated = 1,   // allocated, not sealed
  kSealed = 2,    // immutable, readable
  kMutable = 3,   // versioned mutable object
  kTombstone = 4, // deleted
};

struct MutableCtrl {
  pthread_mutex_t mu;
  pthread_cond_t cv;
  uint64_t version;        // incremented per committed write
  uint32_t num_readers;
  uint32_t reads_remaining; // readers yet to consume current version
  uint32_t closed;
  uint32_t pad;
  uint64_t payload_size;    // size of current version's payload
};

struct Entry {
  uint64_t id;        // 0 = empty
  uint32_t state;
  uint32_t pad;
  uint64_t offset;    // payload offset in arena
  uint64_t capacity;  // allocated bytes
  uint64_t size;      // sealed payload size
  uint64_t ctrl_offset;  // MutableCtrl offset (mutable objects)
};

// Reclaimed arena blocks (delete/destroy) for reuse: a best-fit free list
// with neighbor coalescing and end-of-arena giveback — the plasma-role
// answer to long-running stores, where a pure bump allocator would leak
// every staged argument and return payload forever.
struct FreeBlock {
  uint64_t offset;
  uint64_t size;  // aligned bytes
};

constexpr uint32_t kMaxFreeBlocks = 2048;

struct Header {
  uint64_t magic;
  uint64_t arena_size;
  uint64_t alloc_cursor;     // bump allocator cursor
  uint32_t max_objects;
  uint32_t free_count;       // live entries in the free list
  uint64_t used_objects;
  uint64_t free_bytes;       // total bytes parked in the free list
  pthread_mutex_t table_mu;  // protects table + allocator + free list
  // Free list, then entry table, then payload heap follow.
};

struct Store {
  Header* hdr;
  FreeBlock* freelist;
  Entry* table;
  uint8_t* base;
  uint64_t mapped_size;
  char name[256];
  int owner;
};

uint64_t align8(uint64_t v) { return (v + 7) & ~7ULL; }

Entry* find_slot(Store* s, uint64_t id, bool for_insert) {
  uint32_t n = s->hdr->max_objects;
  uint64_t h = id * 0x9E3779B97F4A7C15ULL;
  Entry* first_tomb = nullptr;
  for (uint32_t i = 0; i < n; i++) {
    Entry* e = &s->table[(h + i) % n];
    if (e->id == id && e->state != kEmpty && e->state != kTombstone)
      return e;
    if (e->state == kTombstone && for_insert && !first_tomb) first_tomb = e;
    if (e->state == kEmpty) return for_insert ? (first_tomb ? first_tomb : e)
                                              : nullptr;
  }
  return for_insert ? first_tomb : nullptr;
}

uint64_t arena_alloc(Store* s, uint64_t size) {
  // Caller holds table_mu. Best-fit from the free list, else bump; 0 on
  // exhaustion.
  Header* h = s->hdr;
  uint64_t need = align8(size);
  uint32_t best = UINT32_MAX;
  uint64_t best_size = ~0ULL;
  for (uint32_t i = 0; i < h->free_count; i++) {
    uint64_t fs = s->freelist[i].size;
    if (fs >= need && fs < best_size) {
      best = i;
      best_size = fs;
      if (fs == need) break;
    }
  }
  if (best != UINT32_MAX) {
    FreeBlock b = s->freelist[best];
    uint64_t rem = b.size - need;
    if (rem > 0) {
      // Keep the exact remainder (even slivers): absorbing it would make
      // the reserved size differ from the entry's recorded capacity, so
      // a later free would strand the tail bytes forever. Coalescing on
      // free merges slivers back into neighbors.
      s->freelist[best].offset = b.offset + need;
      s->freelist[best].size = rem;
      h->free_bytes -= need;
    } else {
      s->freelist[best] = s->freelist[--h->free_count];
      h->free_bytes -= need;
    }
    return b.offset;
  }
  uint64_t off = align8(h->alloc_cursor);
  if (off + need > h->arena_size) return 0;
  h->alloc_cursor = off + need;
  return off;
}

void arena_free(Store* s, uint64_t off, uint64_t size) {
  // Caller holds table_mu. Coalesce with free neighbors, give back blocks
  // that touch the bump cursor, park the rest in the free list.
  if (!off || !size) return;
  Header* h = s->hdr;
  uint64_t need = align8(size);
  for (uint32_t i = 0; i < h->free_count;) {
    FreeBlock* f = &s->freelist[i];
    if (f->offset + f->size == off) {
      off = f->offset;
      need += f->size;
      h->free_bytes -= f->size;
      *f = s->freelist[--h->free_count];
      i = 0;  // the grown block may now touch an already-scanned entry
      continue;
    }
    if (off + need == f->offset) {
      need += f->size;
      h->free_bytes -= f->size;
      *f = s->freelist[--h->free_count];
      i = 0;
      continue;
    }
    i++;
  }
  if (off + need == align8(h->alloc_cursor)) {
    h->alloc_cursor = off;  // retreat the bump cursor
    return;
  }
  if (h->free_count < kMaxFreeBlocks) {
    s->freelist[h->free_count].offset = off;
    s->freelist[h->free_count].size = need;
    h->free_count++;
    h->free_bytes += need;
  }
  // List full: the block leaks until the store is recreated.
}

void shared_mutex_init(pthread_mutex_t* mu) {
  pthread_mutexattr_t at;
  pthread_mutexattr_init(&at);
  pthread_mutexattr_setpshared(&at, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&at, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(mu, &at);
  pthread_mutexattr_destroy(&at);
}

void shared_cond_init(pthread_cond_t* cv) {
  pthread_condattr_t at;
  pthread_condattr_init(&at);
  pthread_condattr_setpshared(&at, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(cv, &at);
  pthread_condattr_destroy(&at);
}

int lock_robust(pthread_mutex_t* mu) {
  int rc = pthread_mutex_lock(mu);
  if (rc == EOWNERDEAD) {  // previous owner died: state is consistent
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  return rc;
}

timespec deadline_from_ms(int64_t timeout_ms) {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) { ts.tv_sec++; ts.tv_nsec -= 1000000000L; }
  return ts;
}

}  // namespace

extern "C" {

// Error codes.
enum {
  RTN_OK = 0,
  RTN_ERR_EXISTS = -1,
  RTN_ERR_NOT_FOUND = -2,
  RTN_ERR_FULL = -3,
  RTN_ERR_TIMEOUT = -4,
  RTN_ERR_CLOSED = -5,
  RTN_ERR_STATE = -6,
  RTN_ERR_SYS = -7,
};

void* rtn_store_create(const char* name, uint64_t arena_size,
                       uint32_t max_objects) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t table_bytes = sizeof(Entry) * (uint64_t)max_objects;
  uint64_t free_bytes_sz = align8(sizeof(FreeBlock) * (uint64_t)kMaxFreeBlocks);
  uint64_t total = align8(sizeof(Header)) + free_bytes_sz
                   + align8(table_bytes) + arena_size;
  if (ftruncate(fd, (off_t)total) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  Store* s = new Store();
  s->hdr = (Header*)mem;
  s->freelist = (FreeBlock*)((uint8_t*)mem + align8(sizeof(Header)));
  s->table = (Entry*)((uint8_t*)mem + align8(sizeof(Header)) + free_bytes_sz);
  s->base = (uint8_t*)s->table + align8(table_bytes);
  s->mapped_size = total;
  s->owner = 1;
  strncpy(s->name, name, sizeof(s->name) - 1);

  memset(s->hdr, 0, sizeof(Header));
  memset(s->freelist, 0, free_bytes_sz);
  memset(s->table, 0, table_bytes);
  s->hdr->magic = kMagic;
  s->hdr->arena_size = arena_size;
  s->hdr->alloc_cursor = 8;  // offset 0 is reserved: alloc returns 0 = fail
  s->hdr->max_objects = max_objects;
  shared_mutex_init(&s->hdr->table_mu);
  return s;
}

void* rtn_store_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* hdr = (Header*)mem;
  if (hdr->magic != kMagic) { munmap(mem, (size_t)st.st_size); return nullptr; }
  Store* s = new Store();
  s->hdr = hdr;
  uint64_t table_bytes = sizeof(Entry) * (uint64_t)hdr->max_objects;
  uint64_t free_bytes_sz = align8(sizeof(FreeBlock) * (uint64_t)kMaxFreeBlocks);
  s->freelist = (FreeBlock*)((uint8_t*)mem + align8(sizeof(Header)));
  s->table = (Entry*)((uint8_t*)mem + align8(sizeof(Header)) + free_bytes_sz);
  s->base = (uint8_t*)s->table + align8(table_bytes);
  s->mapped_size = (uint64_t)st.st_size;
  s->owner = 0;
  strncpy(s->name, name, sizeof(s->name) - 1);
  return s;
}

void rtn_store_close(void* handle) {
  Store* s = (Store*)handle;
  if (!s) return;
  int owner = s->owner;
  char name[256];
  strncpy(name, s->name, sizeof(name));
  munmap((void*)s->hdr, s->mapped_size);
  if (owner) shm_unlink(name);
  delete s;
}

uint64_t rtn_store_capacity(void* handle) {
  return ((Store*)handle)->hdr->arena_size;
}

uint64_t rtn_store_used(void* handle) {
  Header* h = ((Store*)handle)->hdr;
  return h->alloc_cursor - h->free_bytes;
}

uint64_t rtn_store_num_objects(void* handle) {
  return ((Store*)handle)->hdr->used_objects;
}

// ---- immutable objects ----------------------------------------------------

int rtn_put(void* handle, uint64_t id, const uint8_t* data, uint64_t len) {
  Store* s = (Store*)handle;
  lock_robust(&s->hdr->table_mu);
  Entry* existing = find_slot(s, id, false);
  if (existing) { pthread_mutex_unlock(&s->hdr->table_mu); return RTN_ERR_EXISTS; }
  Entry* e = find_slot(s, id, true);
  if (!e) { pthread_mutex_unlock(&s->hdr->table_mu); return RTN_ERR_FULL; }
  uint64_t off = arena_alloc(s, len);
  if (!off && len > 0) { pthread_mutex_unlock(&s->hdr->table_mu); return RTN_ERR_FULL; }
  e->id = id;
  e->offset = off;
  e->capacity = align8(len);  // what arena_alloc reserved (arena_free needs it)
  e->size = len;
  e->ctrl_offset = 0;
  e->state = kSealed;
  s->hdr->used_objects++;
  memcpy(s->base + off, data, len);
  pthread_mutex_unlock(&s->hdr->table_mu);
  return RTN_OK;
}

int rtn_get(void* handle, uint64_t id, uint8_t** out_ptr, uint64_t* out_len) {
  Store* s = (Store*)handle;
  lock_robust(&s->hdr->table_mu);
  Entry* e = find_slot(s, id, false);
  if (!e || e->state != kSealed) {
    pthread_mutex_unlock(&s->hdr->table_mu);
    return RTN_ERR_NOT_FOUND;
  }
  *out_ptr = s->base + e->offset;
  *out_len = e->size;
  pthread_mutex_unlock(&s->hdr->table_mu);
  return RTN_OK;
}

int rtn_contains(void* handle, uint64_t id) {
  Store* s = (Store*)handle;
  lock_robust(&s->hdr->table_mu);
  Entry* e = find_slot(s, id, false);
  int ok = (e != nullptr);
  pthread_mutex_unlock(&s->hdr->table_mu);
  return ok;
}

int rtn_delete(void* handle, uint64_t id) {
  Store* s = (Store*)handle;
  lock_robust(&s->hdr->table_mu);
  Entry* e = find_slot(s, id, false);
  if (!e) { pthread_mutex_unlock(&s->hdr->table_mu); return RTN_ERR_NOT_FOUND; }
  if (e->state == kMutable) {  // mutable objects go through rtn_mo_destroy
    pthread_mutex_unlock(&s->hdr->table_mu);
    return RTN_ERR_STATE;
  }
  e->state = kTombstone;
  arena_free(s, e->offset, e->capacity);
  s->hdr->used_objects--;
  pthread_mutex_unlock(&s->hdr->table_mu);
  return RTN_OK;
}

// ---- mutable objects (channel substrate) ----------------------------------

int rtn_mo_create(void* handle, uint64_t id, uint64_t max_size,
                  uint32_t num_readers) {
  Store* s = (Store*)handle;
  lock_robust(&s->hdr->table_mu);
  if (find_slot(s, id, false)) {
    pthread_mutex_unlock(&s->hdr->table_mu);
    return RTN_ERR_EXISTS;
  }
  Entry* e = find_slot(s, id, true);
  if (!e) { pthread_mutex_unlock(&s->hdr->table_mu); return RTN_ERR_FULL; }
  uint64_t ctrl_off = arena_alloc(s, sizeof(MutableCtrl));
  uint64_t pay_off = arena_alloc(s, max_size);
  if (!ctrl_off || (!pay_off && max_size > 0)) {
    pthread_mutex_unlock(&s->hdr->table_mu);
    return RTN_ERR_FULL;
  }
  MutableCtrl* c = (MutableCtrl*)(s->base + ctrl_off);
  memset(c, 0, sizeof(MutableCtrl));
  shared_mutex_init(&c->mu);
  shared_cond_init(&c->cv);
  c->num_readers = num_readers;
  e->id = id;
  e->offset = pay_off;
  e->capacity = max_size;
  e->size = 0;
  e->ctrl_offset = ctrl_off;
  e->state = kMutable;
  s->hdr->used_objects++;
  pthread_mutex_unlock(&s->hdr->table_mu);
  return RTN_OK;
}

static int mo_lookup(Store* s, uint64_t id, Entry** out_e, MutableCtrl** out_c) {
  lock_robust(&s->hdr->table_mu);
  Entry* e = find_slot(s, id, false);
  if (!e || e->state != kMutable) {
    pthread_mutex_unlock(&s->hdr->table_mu);
    return RTN_ERR_NOT_FOUND;
  }
  *out_e = e;
  *out_c = (MutableCtrl*)(s->base + e->ctrl_offset);
  pthread_mutex_unlock(&s->hdr->table_mu);
  return RTN_OK;
}

// Write blocks until every reader consumed the previous version (single
// outstanding version — the reference's mutable-object protocol).
int rtn_mo_write(void* handle, uint64_t id, const uint8_t* data,
                 uint64_t len, int64_t timeout_ms) {
  Store* s = (Store*)handle;
  Entry* e; MutableCtrl* c;
  int rc = mo_lookup(s, id, &e, &c);
  if (rc != RTN_OK) return rc;
  if (len > e->capacity) return RTN_ERR_FULL;
  timespec dl = deadline_from_ms(timeout_ms);
  lock_robust(&c->mu);
  while (c->reads_remaining > 0 && !c->closed) {
    if (pthread_cond_timedwait(&c->cv, &c->mu, &dl) == ETIMEDOUT) {
      pthread_mutex_unlock(&c->mu);
      return RTN_ERR_TIMEOUT;
    }
  }
  if (c->closed) { pthread_mutex_unlock(&c->mu); return RTN_ERR_CLOSED; }
  memcpy(s->base + e->offset, data, len);
  c->payload_size = len;
  c->version++;
  c->reads_remaining = c->num_readers;
  pthread_cond_broadcast(&c->cv);
  pthread_mutex_unlock(&c->mu);
  return RTN_OK;
}

// Read blocks until a version > last_seen exists; returns that version.
// Copies out under the lock (payload is overwritten by the next write).
int rtn_mo_read(void* handle, uint64_t id, uint64_t last_seen,
                uint8_t* out_buf, uint64_t buf_cap, uint64_t* out_len,
                uint64_t* out_version, int64_t timeout_ms) {
  Store* s = (Store*)handle;
  Entry* e; MutableCtrl* c;
  int rc = mo_lookup(s, id, &e, &c);
  if (rc != RTN_OK) return rc;
  timespec dl = deadline_from_ms(timeout_ms);
  lock_robust(&c->mu);
  while (c->version <= last_seen && !c->closed) {
    if (pthread_cond_timedwait(&c->cv, &c->mu, &dl) == ETIMEDOUT) {
      pthread_mutex_unlock(&c->mu);
      return RTN_ERR_TIMEOUT;
    }
  }
  if (c->version <= last_seen && c->closed) {
    pthread_mutex_unlock(&c->mu);
    return RTN_ERR_CLOSED;
  }
  if (c->closed == 2) {
    // Destroyed (payload arena reclaimed): no drain — the bytes at
    // e->offset may already belong to another object.
    pthread_mutex_unlock(&c->mu);
    return RTN_ERR_CLOSED;
  }
  if (c->payload_size > buf_cap) {
    pthread_mutex_unlock(&c->mu);
    return RTN_ERR_FULL;
  }
  memcpy(out_buf, s->base + e->offset, c->payload_size);
  *out_len = c->payload_size;
  *out_version = c->version;
  if (c->reads_remaining > 0) {
    c->reads_remaining--;
    if (c->reads_remaining == 0) pthread_cond_broadcast(&c->cv);
  }
  pthread_mutex_unlock(&c->mu);
  return RTN_OK;
}

int rtn_mo_close(void* handle, uint64_t id) {
  Store* s = (Store*)handle;
  Entry* e; MutableCtrl* c;
  int rc = mo_lookup(s, id, &e, &c);
  if (rc != RTN_OK) return rc;
  lock_robust(&c->mu);
  c->closed = 1;
  pthread_cond_broadcast(&c->cv);
  pthread_mutex_unlock(&c->mu);
  return RTN_OK;
}

int rtn_mo_destroy(void* handle, uint64_t id) {
  // Close + reclaim the payload arena. The MutableCtrl block (mutex/cv
  // memory a blocked peer may still reference) is intentionally leaked;
  // read/write after close observe `closed` under the ctrl mutex and
  // never touch the freed payload.
  Store* s = (Store*)handle;
  Entry* e; MutableCtrl* c;
  int rc = mo_lookup(s, id, &e, &c);
  if (rc != RTN_OK) return rc;
  lock_robust(&c->mu);
  c->closed = 2;  // destroyed: readers must not drain from the payload
  pthread_cond_broadcast(&c->cv);
  pthread_mutex_unlock(&c->mu);
  lock_robust(&s->hdr->table_mu);
  if (e->id == id && e->state == kMutable) {
    e->state = kTombstone;
    arena_free(s, e->offset, e->capacity);
    s->hdr->used_objects--;
  }
  pthread_mutex_unlock(&s->hdr->table_mu);
  return RTN_OK;
}

}  // extern "C"
