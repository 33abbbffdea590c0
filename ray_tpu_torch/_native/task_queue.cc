// Dependency-tracking ready queue — the scheduler hot loop in native code.
//
// Reference role: the raylet's LocalTaskManager/ClusterTaskManager dispatch
// queues (src/ray/raylet/scheduling/*.cc [unverified]). Re-designed for the
// wave model this framework uses: a task graph with in-degrees, a ready
// ring, and O(1) completion propagation over a CSR edge list — the host-side
// companion of the on-device lax.while_loop frontier executor (host side
// feeds waves; device side runs them).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <pthread.h>

namespace {

struct TaskQueue {
  uint32_t max_tasks;
  uint32_t max_edges;
  int32_t* indeg;        // per task
  uint8_t* done;
  // CSR edges: head[t]..head[t+1] gives consumer list.
  uint32_t* edge_src;    // staging before seal
  uint32_t* edge_dst;
  uint32_t num_edges;
  uint32_t* csr_head;    // size max_tasks+1
  uint32_t* csr_dst;
  int sealed;
  // Ready ring.
  uint32_t* ring;
  uint32_t ring_cap;
  uint32_t rhead, rtail;
  uint32_t num_tasks;
  uint32_t num_done;
  pthread_mutex_t mu;
  pthread_cond_t cv;
};

void push_ready(TaskQueue* q, uint32_t t) {
  q->ring[q->rtail % q->ring_cap] = t;
  q->rtail++;
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

void* rtn_tq_create(uint32_t max_tasks, uint32_t max_edges) {
  TaskQueue* q = new TaskQueue();
  memset(q, 0, sizeof(TaskQueue));
  q->max_tasks = max_tasks;
  q->max_edges = max_edges;
  q->indeg = new int32_t[max_tasks]();
  q->done = new uint8_t[max_tasks]();
  q->edge_src = new uint32_t[max_edges];
  q->edge_dst = new uint32_t[max_edges];
  q->csr_head = new uint32_t[max_tasks + 1]();
  q->csr_dst = new uint32_t[max_edges];
  q->ring_cap = max_tasks + 1;
  q->ring = new uint32_t[q->ring_cap];
  pthread_mutex_init(&q->mu, nullptr);
  pthread_cond_init(&q->cv, nullptr);
  return q;
}

void rtn_tq_destroy(void* handle) {
  TaskQueue* q = (TaskQueue*)handle;
  delete[] q->indeg;
  delete[] q->done;
  delete[] q->edge_src;
  delete[] q->edge_dst;
  delete[] q->csr_head;
  delete[] q->csr_dst;
  delete[] q->ring;
  pthread_mutex_destroy(&q->mu);
  pthread_cond_destroy(&q->cv);
  delete q;
}

int rtn_tq_add_task(void* handle, uint32_t task_id) {
  TaskQueue* q = (TaskQueue*)handle;
  if (task_id >= q->max_tasks || q->sealed) return -1;
  if (task_id + 1 > q->num_tasks) q->num_tasks = task_id + 1;
  return 0;
}

int rtn_tq_add_edge(void* handle, uint32_t src, uint32_t dst) {
  TaskQueue* q = (TaskQueue*)handle;
  if (q->sealed || q->num_edges >= q->max_edges) return -1;
  if (src >= q->max_tasks || dst >= q->max_tasks) return -1;
  q->edge_src[q->num_edges] = src;
  q->edge_dst[q->num_edges] = dst;
  q->num_edges++;
  q->indeg[dst]++;
  return 0;
}

int rtn_tq_seal(void* handle) {
  TaskQueue* q = (TaskQueue*)handle;
  if (q->sealed) return -1;
  // Build CSR: counting sort by src.
  for (uint32_t i = 0; i < q->num_edges; i++) q->csr_head[q->edge_src[i] + 1]++;
  for (uint32_t t = 0; t < q->num_tasks; t++) q->csr_head[t + 1] += q->csr_head[t];
  uint32_t* cursor = new uint32_t[q->num_tasks]();
  for (uint32_t i = 0; i < q->num_edges; i++) {
    uint32_t s = q->edge_src[i];
    q->csr_dst[q->csr_head[s] + cursor[s]] = q->edge_dst[i];
    cursor[s]++;
  }
  delete[] cursor;
  pthread_mutex_lock(&q->mu);
  q->sealed = 1;
  for (uint32_t t = 0; t < q->num_tasks; t++)
    if (q->indeg[t] == 0) push_ready(q, t);
  pthread_cond_broadcast(&q->cv);
  pthread_mutex_unlock(&q->mu);
  return 0;
}

// Mark tasks complete; newly-ready consumers enter the ring. Batched — the
// wave executor completes a whole wave per call.
int rtn_tq_complete(void* handle, const uint32_t* tasks, uint32_t n) {
  TaskQueue* q = (TaskQueue*)handle;
  pthread_mutex_lock(&q->mu);
  for (uint32_t i = 0; i < n; i++) {
    uint32_t t = tasks[i];
    if (t >= q->num_tasks || q->done[t]) continue;
    q->done[t] = 1;
    q->num_done++;
    for (uint32_t e = q->csr_head[t]; e < q->csr_head[t + 1]; e++) {
      uint32_t c = q->csr_dst[e];
      if (--q->indeg[c] == 0) push_ready(q, c);
    }
  }
  pthread_cond_broadcast(&q->cv);
  pthread_mutex_unlock(&q->mu);
  return 0;
}

// Pop up to max ready tasks (the next wave). Blocks up to timeout_ms when
// none ready and the graph is unfinished; returns count (0 = all done or
// timeout).
int rtn_tq_pop_wave(void* handle, uint32_t* out, uint32_t max,
                    int64_t timeout_ms) {
  TaskQueue* q = (TaskQueue*)handle;
  timespec dl = deadline_from_ms(timeout_ms);
  pthread_mutex_lock(&q->mu);
  while (q->rhead == q->rtail && q->num_done < q->num_tasks) {
    if (pthread_cond_timedwait(&q->cv, &q->mu, &dl) == ETIMEDOUT) {
      pthread_mutex_unlock(&q->mu);
      return 0;
    }
  }
  uint32_t n = 0;
  while (q->rhead != q->rtail && n < max) {
    out[n++] = q->ring[q->rhead % q->ring_cap];
    q->rhead++;
  }
  pthread_mutex_unlock(&q->mu);
  return (int)n;
}

uint32_t rtn_tq_num_done(void* handle) {
  TaskQueue* q = (TaskQueue*)handle;
  pthread_mutex_lock(&q->mu);
  uint32_t d = q->num_done;
  pthread_mutex_unlock(&q->mu);
  return d;
}

uint32_t rtn_tq_num_tasks(void* handle) {
  return ((TaskQueue*)handle)->num_tasks;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Dynamic dependency queue: incremental task adds (no seal), generation-
// tagged 64-bit handles so slots recycle safely. This is the live scheduler
// hot loop — the LocalScheduler feeds every submitted task through it when
// the native layer is available (reference role: LocalTaskManager's
// waiting/ready queues + DependencyManager counts, src/ray/raylet/
// local_task_manager.cc [unverified]).
//
// Handle layout: (generation << 32) | slot. A dep edge may only be added
// while the consumer is uncommitted; completion walks the producer's
// consumer list, decrements in-degrees, and frees the slot (gen++), so a
// stale handle can never alias a recycled slot.
// ---------------------------------------------------------------------------

namespace {

constexpr uint32_t kNil = 0xffffffffu;

struct DynQueue {
  uint32_t cap, edge_cap;
  int32_t* indeg;       // per slot
  uint32_t* gen;        // per slot generation
  uint8_t* state;       // 0=free, 1=allocated (deps still arriving), 2=committed
  uint32_t* head;       // per slot: first outgoing edge (consumers)
  uint32_t* enext;      // per edge
  uint32_t* edst;       // per edge: consumer slot
  uint32_t* egen;       // per edge: consumer generation at add time (edges
                        // into an aborted slot go stale instead of
                        // corrupting whatever recycled the slot)
  uint32_t* edge_free;  // stack
  uint32_t edge_free_top;
  uint32_t* slot_free;  // stack
  uint32_t slot_free_top;
  uint64_t* ring;       // ready handles
  uint32_t ring_cap, rhead, rtail;
  uint64_t num_pending, num_done;
  pthread_mutex_t mu;
  pthread_cond_t cv;
};

inline uint64_t dq_handle(DynQueue* q, uint32_t slot) {
  return ((uint64_t)q->gen[slot] << 32) | slot;
}

// Validates a handle; returns slot or kNil.
inline uint32_t dq_slot(DynQueue* q, uint64_t h) {
  uint32_t s = (uint32_t)h;
  if (s >= q->cap || q->state[s] == 0) return kNil;
  if (q->gen[s] != (uint32_t)(h >> 32)) return kNil;
  return s;
}

}  // namespace

extern "C" {

void* rtn_dq_create(uint32_t cap, uint32_t edge_cap) {
  DynQueue* q = new DynQueue();
  memset(q, 0, sizeof(DynQueue));
  q->cap = cap;
  q->edge_cap = edge_cap;
  q->indeg = new int32_t[cap]();
  q->gen = new uint32_t[cap]();
  q->state = new uint8_t[cap]();
  q->head = new uint32_t[cap];
  q->enext = new uint32_t[edge_cap];
  q->edst = new uint32_t[edge_cap];
  q->egen = new uint32_t[edge_cap];
  q->edge_free = new uint32_t[edge_cap];
  for (uint32_t i = 0; i < edge_cap; i++) q->edge_free[i] = edge_cap - 1 - i;
  q->edge_free_top = edge_cap;
  q->slot_free = new uint32_t[cap];
  for (uint32_t i = 0; i < cap; i++) q->slot_free[i] = cap - 1 - i;
  q->slot_free_top = cap;
  q->ring_cap = cap + 1;
  q->ring = new uint64_t[q->ring_cap];
  pthread_mutex_init(&q->mu, nullptr);
  pthread_cond_init(&q->cv, nullptr);
  return q;
}

void rtn_dq_destroy(void* handle) {
  DynQueue* q = (DynQueue*)handle;
  delete[] q->indeg;
  delete[] q->gen;
  delete[] q->state;
  delete[] q->head;
  delete[] q->enext;
  delete[] q->edst;
  delete[] q->egen;
  delete[] q->edge_free;
  delete[] q->slot_free;
  delete[] q->ring;
  pthread_mutex_destroy(&q->mu);
  pthread_cond_destroy(&q->cv);
  delete q;
}

// Allocate a task slot; returns handle, or 0 when full (0 is never a valid
// handle because gen starts at 1 for slot 0 on first reuse... guard: we
// bump gen at alloc so gen >= 1 always).
uint64_t rtn_dq_alloc(void* handle) {
  DynQueue* q = (DynQueue*)handle;
  pthread_mutex_lock(&q->mu);
  if (q->slot_free_top == 0) {
    pthread_mutex_unlock(&q->mu);
    return 0;
  }
  uint32_t s = q->slot_free[--q->slot_free_top];
  q->gen[s]++;            // gen >= 1: handle 0 stays invalid
  q->state[s] = 1;
  q->indeg[s] = 0;
  q->head[s] = kNil;
  q->num_pending++;
  uint64_t h = dq_handle(q, s);
  pthread_mutex_unlock(&q->mu);
  return h;
}

// Record consumer <- producer dependency. No-op (0) when the producer has
// already completed (stale handle). -1: bad consumer; -3: edge table full.
int rtn_dq_add_dep(void* handle, uint64_t task, uint64_t dep) {
  DynQueue* q = (DynQueue*)handle;
  pthread_mutex_lock(&q->mu);
  uint32_t t = dq_slot(q, task);
  if (t == kNil || q->state[t] != 1) {
    pthread_mutex_unlock(&q->mu);
    return -1;
  }
  uint32_t d = dq_slot(q, dep);
  if (d == kNil) {  // producer already done — dependency satisfied
    pthread_mutex_unlock(&q->mu);
    return 0;
  }
  if (q->edge_free_top == 0) {
    pthread_mutex_unlock(&q->mu);
    return -3;
  }
  uint32_t e = q->edge_free[--q->edge_free_top];
  q->edst[e] = t;
  q->egen[e] = q->gen[t];
  q->enext[e] = q->head[d];
  q->head[d] = e;
  q->indeg[t]++;
  pthread_mutex_unlock(&q->mu);
  return 0;
}

// All deps recorded: task becomes eligible; rings immediately if indeg==0.
int rtn_dq_commit(void* handle, uint64_t task) {
  DynQueue* q = (DynQueue*)handle;
  pthread_mutex_lock(&q->mu);
  uint32_t t = dq_slot(q, task);
  if (t == kNil || q->state[t] != 1) {
    pthread_mutex_unlock(&q->mu);
    return -1;
  }
  q->state[t] = 2;
  if (q->indeg[t] == 0) {
    q->ring[q->rtail] = dq_handle(q, t);
    if (++q->rtail == q->ring_cap) q->rtail = 0;
    pthread_cond_broadcast(&q->cv);
  }
  pthread_mutex_unlock(&q->mu);
  return 0;
}

// Task finished (outputs stored): ready its consumers, free the slot.
int rtn_dq_complete(void* handle, uint64_t task) {
  DynQueue* q = (DynQueue*)handle;
  pthread_mutex_lock(&q->mu);
  uint32_t t = dq_slot(q, task);
  if (t == kNil || q->state[t] != 2) {
    pthread_mutex_unlock(&q->mu);
    return -1;
  }
  uint32_t e = q->head[t];
  int woke = 0;
  while (e != kNil) {
    uint32_t c = q->edst[e];
    if (q->gen[c] == q->egen[e] &&
        --q->indeg[c] == 0 && q->state[c] == 2) {
      q->ring[q->rtail] = dq_handle(q, c);
      if (++q->rtail == q->ring_cap) q->rtail = 0;
      woke = 1;
    }
    uint32_t nxt = q->enext[e];
    q->edge_free[q->edge_free_top++] = e;
    e = nxt;
  }
  q->state[t] = 0;
  q->gen[t]++;  // invalidate stale handles
  q->slot_free[q->slot_free_top++] = t;
  q->num_pending--;
  q->num_done++;
  if (woke) pthread_cond_broadcast(&q->cv);
  pthread_mutex_unlock(&q->mu);
  return 0;
}

// Abandon an allocated-or-committed task that never ran (e.g. the caller
// hit the edge-table-full MemoryError mid-registration and is unwinding).
// Consumers' edges are released as satisfied; edges INTO this slot from
// still-pending producers go stale via the generation tag and are freed
// when those producers complete. Not counted in num_done.
int rtn_dq_abort(void* handle, uint64_t task) {
  DynQueue* q = (DynQueue*)handle;
  pthread_mutex_lock(&q->mu);
  uint32_t t = dq_slot(q, task);
  if (t == kNil) {
    pthread_mutex_unlock(&q->mu);
    return -1;
  }
  uint32_t e = q->head[t];
  int woke = 0;
  while (e != kNil) {
    uint32_t c = q->edst[e];
    if (q->gen[c] == q->egen[e] &&
        --q->indeg[c] == 0 && q->state[c] == 2) {
      q->ring[q->rtail] = dq_handle(q, c);
      if (++q->rtail == q->ring_cap) q->rtail = 0;
      woke = 1;
    }
    uint32_t nxt = q->enext[e];
    q->edge_free[q->edge_free_top++] = e;
    e = nxt;
  }
  q->state[t] = 0;
  q->gen[t]++;
  q->slot_free[q->slot_free_top++] = t;
  q->num_pending--;
  if (woke) pthread_cond_broadcast(&q->cv);
  pthread_mutex_unlock(&q->mu);
  return 0;
}

// Pop up to max ready handles; blocks up to timeout_ms when none ready.
int rtn_dq_pop(void* handle, uint64_t* out, uint32_t max, int64_t timeout_ms) {
  DynQueue* q = (DynQueue*)handle;
  timespec dl = deadline_from_ms(timeout_ms);
  pthread_mutex_lock(&q->mu);
  while (q->rhead == q->rtail) {
    if (pthread_cond_timedwait(&q->cv, &q->mu, &dl) == ETIMEDOUT) {
      pthread_mutex_unlock(&q->mu);
      return 0;
    }
  }
  uint32_t n = 0;
  while (q->rhead != q->rtail && n < max) {
    out[n++] = q->ring[q->rhead];
    if (++q->rhead == q->ring_cap) q->rhead = 0;
  }
  pthread_mutex_unlock(&q->mu);
  return (int)n;
}

// Wake any pop_wave blocked in cv (shutdown path).
void rtn_dq_wake(void* handle) {
  DynQueue* q = (DynQueue*)handle;
  pthread_mutex_lock(&q->mu);
  pthread_cond_broadcast(&q->cv);
  pthread_mutex_unlock(&q->mu);
}

uint64_t rtn_dq_num_pending(void* handle) {
  DynQueue* q = (DynQueue*)handle;
  pthread_mutex_lock(&q->mu);
  uint64_t v = q->num_pending;
  pthread_mutex_unlock(&q->mu);
  return v;
}

uint64_t rtn_dq_num_done(void* handle) {
  DynQueue* q = (DynQueue*)handle;
  pthread_mutex_lock(&q->mu);
  uint64_t v = q->num_done;
  pthread_mutex_unlock(&q->mu);
  return v;
}

}  // extern "C"
