// Native request-batching plane of the port's serving path
// (iinsvae_torch/runtime/batcher.py), a copy of the JAX package's
// runtime_native/iinsvae_batcher.cc.
//
// Concurrent client threads submit single CIR requests; a worker (the
// Python loop driving serving.Predictor on the card) pulls fixed-size
// batches — full batches immediately, partial batches after a deadline —
// and posts per-ticket results that wake exactly the waiting clients.
//
// Two changes from that copy. A submit that makes the first pending request
// wakes a worker, so a partial batch is flushed deadline_ms after it
// arrives and not when the worker's own wait ends. And a timed-out
// iins_batcher_wait gives up nothing: the ticket stays live and
// a later wait collects its result, so a caller may wait in slices (the
// socket fronts wait in 250 ms slices while a batch can take seconds: the
// first launch of each kernel builds its library). A caller that gives up
// on a ticket says so with iins_batcher_abandon, which frees a done slot at
// once and otherwise lets post() free it.
//
// Zero dependencies beyond libstdc++/pthreads: plain C ABI, caller-owned
// buffers, int64 sizes.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <chrono>
#include <mutex>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

enum SlotState : int { kFree = 0, kPending = 1, kInFlight = 2, kDone = 3 };

struct Slot {
  int64_t ticket = -1;
  int state = kFree;
  bool abandoned = false;    // the owner gave up (iins_batcher_abandon); post() frees it
  std::vector<double> cir;   // request payload (cir_len)
  double err = 0.0;          // posted results
  int64_t label = -1;
  std::vector<double> extra; // optional richer payload (n_extra doubles:
                             // env-class probabilities, reconstruction, ...)
  Clock::time_point arrival; // submit time (queue-latency stats)
  Clock::time_point done_at; // post time (grace-period reclaim)
};

struct Batcher {
  int64_t cir_len;
  int64_t n_extra;           // doubles per result beyond (err, label)
  int64_t batch_size;
  int64_t max_pending;       // slot-table capacity
  double deadline_ms;        // partial-batch flush deadline
  // A kDone slot may only be stolen by a submitter after this grace: a
  // result's owner may simply not have been scheduled yet (a client
  // starved of the interpreter lock under load), and stealing the slot at
  // once would drop its result. Giving up is explicit
  // (iins_batcher_abandon), so this is only the backstop for clients that
  // die between submit and wait. Configurable:
  // iins_batcher_set_reclaim_grace_ms.
  double reclaim_grace_ms = 60000.0;

  std::mutex mu;
  std::condition_variable pending_cv;  // worker waits: a batch is ready
  std::condition_variable done_cv;     // clients wait: results posted
  std::condition_variable space_cv;    // submitters wait: a slot freed
  std::condition_variable drained_cv;  // destroy waits: no thread inside
  std::vector<Slot> slots;
  int64_t next_ticket = 0;
  int64_t n_pending = 0;     // slots in kPending
  int64_t n_inside = 0;      // threads currently inside a blocking entry
  bool shutdown = false;
  Clock::time_point oldest_pending;  // arrival of the oldest kPending

  // Monotonic counters (guarded by mu) — see iins_batcher_stats for the
  // export order. Derived rates (occupancy, mean queue latency) are
  // computed caller-side from these.
  int64_t st_submitted = 0;      // accepted submits
  int64_t st_batches = 0;        // batches handed to the worker
  int64_t st_full_batches = 0;   // of those, at full batch_size
  int64_t st_rows = 0;           // rows dispatched across all batches
  int64_t st_posted = 0;         // result rows posted to live tickets
  int64_t st_reclaimed = 0;      // results dropped: abandoned or past the grace
  int64_t st_wait_timeouts = 0;  // tickets abandoned by their waiter
  int64_t st_queue_ns = 0;       // sum of submit->dispatch ns over st_rows

  explicit Batcher(int64_t len, int64_t nx, int64_t bs, int64_t cap,
                   double dl_ms)
      : cir_len(len), n_extra(nx), batch_size(bs), max_pending(cap),
        deadline_ms(dl_ms), slots(static_cast<size_t>(cap)) {
    for (auto& s : slots) {
      s.cir.resize(static_cast<size_t>(len));
      s.extra.resize(static_cast<size_t>(nx));
    }
  }

  Slot* find(int64_t ticket) {
    if (ticket < 0) return nullptr;
    Slot& s = slots[static_cast<size_t>(ticket % max_pending)];
    return s.ticket == ticket ? &s : nullptr;
  }

  void free_slot(Slot* s) {
    s->state = kFree;
    s->ticket = -1;
    s->abandoned = false;
  }
};

// RAII tracker of threads inside a blocking entry point. Construct/destroy
// with the Batcher mutex HELD (declare after the unique_lock so it unwinds
// before the lock releases); destroy() drains on it before deleting, so a
// shutdown can never free the mutex/condvars under a live waiter.
struct Inside {
  Batcher* b;
  explicit Inside(Batcher* bp) : b(bp) { ++b->n_inside; }
  ~Inside() {
    if (--b->n_inside == 0 && b->shutdown) b->drained_cv.notify_all();
  }
};

}  // namespace

extern "C" {

// n_extra: doubles per result beyond (err, label) — 0 for the basic
// payload; num_classes for env probabilities; + cir_len for the recon.
void* iins_batcher_create(int64_t cir_len, int64_t n_extra,
                          int64_t batch_size, int64_t max_pending,
                          double deadline_ms) {
  if (cir_len <= 0 || n_extra < 0 || batch_size <= 0 ||
      max_pending < batch_size)
    return nullptr;
  return new Batcher(cir_len, n_extra, batch_size, max_pending, deadline_ms);
}

int64_t iins_batcher_n_extra(void* h) {
  return static_cast<Batcher*>(h)->n_extra;
}

void iins_batcher_destroy(void* h) {
  auto* b = static_cast<Batcher*>(h);
  if (!b) return;
  {
    std::unique_lock<std::mutex> lk(b->mu);
    b->shutdown = true;
    b->pending_cv.notify_all();
    b->done_cv.notify_all();
    b->space_cv.notify_all();
    // every blocking entry re-checks shutdown on wake and unwinds; wait
    // until the last one is out before freeing the sync primitives
    b->drained_cv.wait(lk, [b] { return b->n_inside == 0; });
  }
  delete b;
}

// Submit ONE request with a bounded wait for ring space. Returns the
// ticket, -1 on shutdown, or -2 when no slot freed within wait_ms
// (wait_ms < 0 = wait forever). Callers that hold uncollected tickets of
// their own MUST use a finite wait and drain one of them on -2, or a full
// ring of mutually-blocked submitters deadlocks (see server.cc
// handle_conn for the canonical pattern).
int64_t iins_batcher_submit_wait(void* h, const double* cir, double wait_ms) {
  auto* b = static_cast<Batcher*>(h);
  std::unique_lock<std::mutex> lk(b->mu);
  Inside guard(b);
  const bool bounded = wait_ms >= 0;
  auto until = Clock::now() +
      std::chrono::duration<double, std::milli>(bounded ? wait_ms : 0.0);
  for (;;) {
    if (b->shutdown) return -1;
    int64_t t = b->next_ticket;
    Slot& s = b->slots[static_cast<size_t>(t % b->max_pending)];
    if (s.state == kDone &&
        std::chrono::duration<double, std::milli>(Clock::now() - s.done_at)
                .count() > b->reclaim_grace_ms) {
      // grace expired: the owner died between submit and wait — reclaim
      // the slot (result dropped) so the ring cannot deadlock. Results
      // younger than the grace are NEVER stolen: their owner may just not
      // have been scheduled yet.
      b->free_slot(&s);
      ++b->st_reclaimed;
    }
    if (s.state == kFree) {
      s.ticket = t;
      s.state = kPending;
      s.abandoned = false;
      std::memcpy(s.cir.data(), cir,
                  sizeof(double) * static_cast<size_t>(b->cir_len));
      b->next_ticket = t + 1;
      s.arrival = Clock::now();
      if (b->n_pending == 0) b->oldest_pending = s.arrival;
      ++b->n_pending;
      ++b->st_submitted;
      // wake a worker for a full batch, and for the first pending request
      // so that its deadline flush is timed from now (a worker asleep in a
      // long next_batch wait would otherwise see it only when that wait
      // ends, long after deadline_ms)
      if (b->n_pending == 1 || b->n_pending >= b->batch_size)
        b->pending_cv.notify_one();
      return t;
    }
    if (bounded && Clock::now() >= until) return -2;
    // sliced wait: a slot can become reclaimable by pure TIME PASSAGE
    // (grace expiry on a kDone slot whose owner died) with nobody left
    // to notify space_cv, so an unbounded wait here could deadlock the
    // ring. 100 ms slices bound that staleness; notifies still wake us
    // immediately.
    auto slice = Clock::now() + std::chrono::milliseconds(100);
    b->space_cv.wait_until(lk, bounded && until < slice ? until : slice);
  }
}

// Submit ONE request. Blocks while the slot table is full (natural
// back-pressure); returns the ticket, or -1 on shutdown.
int64_t iins_batcher_submit(void* h, const double* cir) {
  return iins_batcher_submit_wait(h, cir, -1.0);
}

// Grace before an uncollected kDone slot may be stolen by a submitter
// (see Batcher::reclaim_grace_ms). ms <= 0 restores steal-on-sight.
void iins_batcher_set_reclaim_grace_ms(void* h, double ms) {
  auto* b = static_cast<Batcher*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  b->reclaim_grace_ms = ms;
}

// Slot-table capacity (the submit back-pressure bound).
int64_t iins_batcher_capacity(void* h) {
  return static_cast<Batcher*>(h)->max_pending;
}

// Worker: pull up to batch_size pending requests. Returns immediately with
// a FULL batch when available; otherwise waits until the oldest pending
// request is deadline_ms old (or wait_ms elapses) and returns what exists.
// cir_out: (batch_size, cir_len) caller buffer; tickets_out: batch_size.
// Returns the count (0 = nothing pending within wait_ms), -1 on shutdown.
int64_t iins_batcher_next_batch(void* h, double* cir_out, int64_t* tickets_out,
                                double wait_ms) {
  auto* b = static_cast<Batcher*>(h);
  std::unique_lock<std::mutex> lk(b->mu);
  Inside guard(b);
  auto overall = Clock::now() + std::chrono::duration<double, std::milli>(wait_ms);
  for (;;) {
    if (b->shutdown) return -1;
    if (b->n_pending >= b->batch_size) break;
    if (b->n_pending > 0) {
      auto flush_at = b->oldest_pending +
          std::chrono::duration<double, std::milli>(b->deadline_ms);
      auto until = flush_at < overall ? flush_at : overall;
      if (Clock::now() >= until) break;  // deadline: take the partial batch
      b->pending_cv.wait_until(lk, until);
    } else {
      if (Clock::now() >= overall) return 0;
      b->pending_cv.wait_until(lk, overall);
    }
  }
  int64_t n = 0;
  auto now = Clock::now();
  // oldest-first: scan tickets upward from the smallest live one
  int64_t start = b->next_ticket - b->max_pending;
  if (start < 0) start = 0;
  for (int64_t t = start; t < b->next_ticket && n < b->batch_size; ++t) {
    Slot* s = b->find(t);
    if (s && s->state == kPending) {
      std::memcpy(cir_out + n * b->cir_len, s->cir.data(),
                  sizeof(double) * static_cast<size_t>(b->cir_len));
      tickets_out[n] = t;
      s->state = kInFlight;
      --b->n_pending;
      b->st_queue_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
          now - s->arrival).count();
      ++n;
    }
  }
  if (n > 0) {
    ++b->st_batches;
    if (n == b->batch_size) ++b->st_full_batches;
    b->st_rows += n;
  }
  // reset the deadline clock for whatever pending requests remain
  if (b->n_pending > 0) b->oldest_pending = now;
  return n;
}

// Worker: post results for a pulled batch; wakes the waiting clients.
// extra: (n, n_extra) row-major, or nullptr when n_extra == 0.
void iins_batcher_post(void* h, const int64_t* tickets, const double* err,
                       const int64_t* label, const double* extra, int64_t n) {
  auto* b = static_cast<Batcher*>(h);
  {
    std::lock_guard<std::mutex> lk(b->mu);
    for (int64_t i = 0; i < n; ++i) {
      Slot* s = b->find(tickets[i]);
      if (s && s->state == kInFlight) {
        if (s->abandoned) {
          // the owner gave up on this ticket — free the slot now instead
          // of parking a result nobody will collect
          b->free_slot(s);
          ++b->st_reclaimed;
          continue;
        }
        s->err = err[i];
        s->label = label[i];
        if (b->n_extra > 0 && extra)
          std::memcpy(s->extra.data(), extra + i * b->n_extra,
                      sizeof(double) * static_cast<size_t>(b->n_extra));
        s->state = kDone;
        s->done_at = Clock::now();
        ++b->st_posted;
      }
    }
  }
  b->done_cv.notify_all();
  // kDone slots are reclaimable by submit's grace branch, and abandoned
  // slots were just freed, so a submitter blocked on a full ring must be
  // re-woken here too
  b->space_cv.notify_all();
}

// Client: block until the ticket's results are posted (or wait_ms passes).
// Returns 1 on success (err/label/extra filled, slot freed), 0 on timeout,
// -1 on shutdown/unknown ticket. A timeout leaves the ticket live: wait
// again to collect it, or give it up with iins_batcher_abandon. extra_out:
// n_extra doubles, or nullptr to drop the richer payload.
int iins_batcher_wait(void* h, int64_t ticket, double* err, int64_t* label,
                      double* extra_out, double wait_ms) {
  auto* b = static_cast<Batcher*>(h);
  std::unique_lock<std::mutex> lk(b->mu);
  Inside guard(b);
  auto until = Clock::now() + std::chrono::duration<double, std::milli>(wait_ms);
  for (;;) {
    if (b->shutdown) return -1;
    Slot* s = b->find(ticket);
    if (!s) return -1;
    if (s->state == kDone) {
      *err = s->err;
      *label = s->label;
      if (b->n_extra > 0 && extra_out)
        std::memcpy(extra_out, s->extra.data(),
                    sizeof(double) * static_cast<size_t>(b->n_extra));
      b->free_slot(s);
      b->space_cv.notify_one();
      return 1;
    }
    if (Clock::now() >= until) return 0;
    b->done_cv.wait_until(lk, until);
  }
}

// Client: give up on a ticket (a waiter that stops waiting, a connection
// that closed). A posted result is dropped and its slot freed at once;
// a ticket still queued or in flight is marked, and post() frees its slot.
// Counted in wait_timeouts, and the dropped result in reclaimed.
void iins_batcher_abandon(void* h, int64_t ticket) {
  auto* b = static_cast<Batcher*>(h);
  {
    std::lock_guard<std::mutex> lk(b->mu);
    Slot* s = b->find(ticket);
    if (!s || s->abandoned) return;
    ++b->st_wait_timeouts;
    if (s->state != kDone) {
      s->abandoned = true;
      return;
    }
    b->free_slot(s);
    ++b->st_reclaimed;
  }
  b->space_cv.notify_all();
}

// Observability: current pending count (approximate outside the lock).
int64_t iins_batcher_pending(void* h) {
  auto* b = static_cast<Batcher*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  return b->n_pending;
}

// Observability: one consistent snapshot of the monotonic counters.
// out[9]: {submitted, batches, full_batches, rows_dispatched, rows_posted,
//          reclaimed, wait_timeouts, queue_ns_total, pending_now}.
// Derived caller-side: mean occupancy = rows/batches, mean queue latency =
// queue_ns_total / rows.
void iins_batcher_stats(void* h, int64_t* out) {
  auto* b = static_cast<Batcher*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  out[0] = b->st_submitted;
  out[1] = b->st_batches;
  out[2] = b->st_full_batches;
  out[3] = b->st_rows;
  out[4] = b->st_posted;
  out[5] = b->st_reclaimed;
  out[6] = b->st_wait_timeouts;
  out[7] = b->st_queue_ns;
  out[8] = b->n_pending;
}

}  // extern "C"
