// Socket listeners (unix-domain and TCP) in front of the request batcher
// (batcher.cc): the native IO plane of the port's serving front, a copy of
// the JAX package's runtime_native/iinsvae_server.cc whose wire protocol it
// keeps byte for byte, so clients of either package talk to servers of
// either.
//
// Wire protocol (little-endian, caller = any client):
//   request:  int64 n, then n * cir_len doubles
//   response: n * { double err, int64 label, n_extra doubles }
// Stats query: a header of n = -1 (no payload) returns the batcher's
// 9-counter snapshot (iins_batcher_stats order) and the server's count of
// rejected frames as 10 int64s; the connection then accepts further
// requests.
// A row whose result could not be produced (batcher shutdown, compute
// failure, per-ticket timeout) is reported honestly as err = NaN,
// label = -1 — never as a fabricated 0.0 prediction.
// n_extra is a property of the batcher the listener fronts (0 = basic
// payload; richer payloads carry env-class probabilities and/or the
// reconstructed CIR — runtime/batcher.py::serve_predictor). Each row is
// submitted to the batcher individually, so rows from many connections
// share batches. The per-connection thread pipelines: it keeps at most a
// bounded window of its own tickets outstanding and drains the oldest
// (streaming responses back in order) before submitting further rows, so
// a request larger than the batcher ring — or many concurrent
// connections — can never wedge submit on a ring made up of its own
// uncollected results.
//
// Three changes from the JAX package's copy: a drain waits in slices and
// abandons its ticket only when it gives up (its last slice, or shutdown),
// so a batch slower than one slice loses no row; a connection that ends
// with tickets outstanding abandons them, so their slots are freed at once
// instead of after the batcher's reclaim grace; and every blocking accept
// and read waits in poll() slices that re-check the stop flag, so stop
// never relies on shutdown() waking a thread blocked in accept() or read()
// (Linux does, other socket implementations need not; the receive timeout
// is kept by the same slices instead of SO_RCVTIMEO).
//
// Zero dependencies beyond pthreads/libc.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <cerrno>
#include <chrono>
#include <set>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/un.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {
int64_t iins_batcher_submit_wait(void* h, const double* cir, double wait_ms);
int iins_batcher_wait(void* h, int64_t ticket, double* err, int64_t* label,
                      double* extra_out, double wait_ms);
void iins_batcher_abandon(void* h, int64_t ticket);
int64_t iins_batcher_n_extra(void* h);
int64_t iins_batcher_capacity(void* h);
void iins_batcher_stats(void* h, int64_t* out);
}

namespace {

// a drain waits for its ticket in kDrainSlices slices of kDrainSliceMs (60 s)
constexpr int kDrainSlices = 240;
constexpr double kDrainSliceMs = 250.0;
// a blocking accept or read re-checks the stop flag every kPollMs
constexpr int kPollMs = 100;

struct Server {
  void* batcher;
  int64_t cir_len;
  int listen_fd = -1;
  // protocol bounds (iins_server_set_max_rows / _set_recv_timeout_ms):
  // a length-prefixed protocol dies by unbounded lengths and by peers
  // that stall mid-frame — cap the row count per request and time out
  // blocking reads so a silent client can't pin a handler thread forever
  std::atomic<int64_t> max_request_rows{1 << 20};
  std::atomic<int64_t> recv_timeout_ms{300000};  // 5 min default
  std::atomic<int64_t> rejected_frames{0};  // bad/oversized headers
  std::atomic<bool> running{true};
  std::thread acceptor;
  std::mutex mu;
  std::condition_variable drained_cv;  // stop() waits: all handlers exited
  std::set<int> conn_fds;
  int64_t n_active = 0;  // live handler threads (detached; see accept_loop)
};

// Wait until fd is readable (or has hung up): poll in kPollMs slices, false
// once the server stops or, with timeout_ms > 0, once timeout_ms pass.
bool wait_readable(const Server* s, int fd, int64_t timeout_ms) {
  const auto until = std::chrono::steady_clock::now() +
                     std::chrono::milliseconds(timeout_ms);
  for (;;) {
    if (!s->running.load()) return false;
    pollfd pfd{fd, POLLIN, 0};
    int r = poll(&pfd, 1, kPollMs);
    if (r > 0) return true;
    if (r < 0 && errno != EINTR) return false;
    if (timeout_ms > 0 && std::chrono::steady_clock::now() >= until)
      return false;
  }
}

// Read n bytes; every read waits at most timeout_ms for data (<= 0: no
// limit), so a peer stalling mid-frame is disconnected.
bool read_full(const Server* s, int fd, void* buf, size_t n,
               int64_t timeout_ms) {
  auto* p = static_cast<char*>(buf);
  while (n > 0) {
    if (!wait_readable(s, fd, timeout_ms)) return false;
    ssize_t r = read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void handle_conn(Server* s, int fd) {
  // per-row responses: defeat Nagle on TCP (harmless no-op on unix fds)
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // bound every blocking read: a peer stalling mid-frame (or connecting
  // and never sending) gets its connection closed at the timeout instead
  // of holding a handler thread + ring tickets forever
  const int64_t recv_ms = s->recv_timeout_ms.load();
  const int64_t nx = iins_batcher_n_extra(s->batcher);
  // outstanding-window bound: well under the ring so rows from many
  // concurrent connections still share it, and a single huge request
  // (n up to 1<<20 > the ring) drains itself instead of wedging submit
  const int64_t window =
      std::max<int64_t>(1, iins_batcher_capacity(s->batcher) / 8);
  std::vector<double> cir(static_cast<size_t>(s->cir_len));
  std::vector<double> row(2 + static_cast<size_t>(nx));

  // drain the oldest outstanding ticket and stream its response row;
  // failures (timeout/shutdown) are reported as err=NaN, label=-1
  auto drain_one = [&](std::deque<int64_t>& outstanding) {
    int64_t t = outstanding.front();
    outstanding.pop_front();
    double err = 0.0;
    int64_t label = -1;
    // wait in slices so server stop doesn't hang behind a full 60 s
    // per-ticket timeout; a timed-out slice keeps the ticket live, so a
    // batch that takes longer than a slice (the first launch of a kernel
    // builds it) still delivers its row. Give up only after the last
    // slice or at shutdown, and then abandon the ticket so its slot is
    // freed.
    int rc = t >= 0 ? 0 : -1;
    for (int k = 0; rc == 0 && k < kDrainSlices; ++k) {
      rc = iins_batcher_wait(s->batcher, t, &err, &label, row.data() + 2,
                             kDrainSliceMs);
      if (rc == 0 && !s->running.load()) break;
    }
    if (rc == 0) iins_batcher_abandon(s->batcher, t);
    if (rc != 1) {
      err = std::numeric_limits<double>::quiet_NaN();
      label = -1;
      std::memset(row.data() + 2, 0,
                  sizeof(double) * static_cast<size_t>(nx));
    }
    row[0] = err;
    std::memcpy(&row[1], &label, sizeof(int64_t));
    return write_full(fd, row.data(), sizeof(double) * row.size());
  };

  while (s->running.load()) {
    int64_t n = 0;
    if (!read_full(s, fd, &n, sizeof(n), recv_ms)) break;  // disconnect/idle timeout
    if (n == 0 || n < -1 || n > s->max_request_rows.load()) {
      // reject, count, close — never allocate or wait on a hostile length
      s->rejected_frames.fetch_add(1);
      break;
    }
    if (n == -1) {  // stats query: reply with the counter snapshot
      // 9 batcher counters + 1 server counter (rejected_frames) — keep
      // socket_stats_request (runtime/batcher.py) in lockstep
      int64_t st[10];
      iins_batcher_stats(s->batcher, st);
      st[9] = s->rejected_frames.load();
      if (!write_full(fd, st, sizeof(st))) break;
      continue;
    }
    std::deque<int64_t> outstanding;
    bool ok = true;
    for (int64_t i = 0; i < n && ok; ++i) {
      ok = read_full(s, fd, cir.data(), sizeof(double) * cir.size(), recv_ms);
      if (!ok) break;
      // never block in submit while holding a full window (or, on a
      // contended ring, ANY collectable ticket): drain ours first so the
      // ring always makes progress
      while (ok && static_cast<int64_t>(outstanding.size()) >= window)
        ok = drain_one(outstanding);
      int64_t t = -2;
      while (ok && t == -2) {
        t = iins_batcher_submit_wait(s->batcher, cir.data(), 100.0);
        if (t == -2 && !outstanding.empty()) ok = drain_one(outstanding);
        if (t == -2 && !s->running.load()) t = -1;
      }
      if (!ok) break;
      outstanding.push_back(t);  // t = -1 on shutdown -> NaN row on drain
    }
    while (ok && !outstanding.empty()) ok = drain_one(outstanding);
    if (!ok) {
      // the peer hung up or stalled mid-frame: nobody will collect the
      // rest of this frame's tickets, so free their slots now
      for (int64_t t : outstanding)
        if (t >= 0) iins_batcher_abandon(s->batcher, t);
      break;
    }
  }
  close(fd);
  std::lock_guard<std::mutex> lk(s->mu);
  s->conn_fds.erase(fd);
  if (--s->n_active == 0) s->drained_cv.notify_all();
}

void accept_loop(Server* s) {
  while (wait_readable(s, s->listen_fd, 0)) {
    int fd = accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (!s->running.load()) break;
      continue;
    }
    // handlers run detached (a long-lived daemon would otherwise
    // accumulate one joinable std::thread object per connection forever);
    // n_active + drained_cv give stop() its join point instead
    std::lock_guard<std::mutex> lk(s->mu);
    s->conn_fds.insert(fd);
    ++s->n_active;
    std::thread(handle_conn, s, fd).detach();
  }
}

}  // namespace

extern "C" {

// Start listening on a unix socket path; requests are batched through the
// given iins_batcher handle. Returns the server handle or nullptr.
void* iins_server_start(void* batcher, const char* sock_path,
                        int64_t cir_len) {
  int fd = socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, sock_path, sizeof(addr.sun_path) - 1);
  unlink(sock_path);
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 128) != 0) {
    close(fd);
    return nullptr;
  }
  auto* s = new Server;
  s->batcher = batcher;
  s->cir_len = cir_len;
  s->listen_fd = fd;
  s->acceptor = std::thread(accept_loop, s);
  return s;
}

// TCP listener with the same framed protocol (loopback/LAN clients —
// cross-host serving). port 0 = ephemeral; read it back with
// iins_server_port. Binds all interfaces; front with TLS termination
// (stunnel/envoy) for untrusted networks.
void* iins_server_start_tcp(void* batcher, int32_t port, int64_t cir_len) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 128) != 0) {
    close(fd);
    return nullptr;
  }
  auto* s = new Server;
  s->batcher = batcher;
  s->cir_len = cir_len;
  s->listen_fd = fd;
  s->acceptor = std::thread(accept_loop, s);
  return s;
}

// Bound TCP port of a server started with iins_server_start_tcp
// (resolves port 0 -> the kernel-assigned ephemeral port); -1 on error.
int32_t iins_server_port(void* h) {
  auto* s = static_cast<Server*>(h);
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len) != 0
      || addr.sin_family != AF_INET)
    return -1;
  return static_cast<int32_t>(ntohs(addr.sin_port));
}

// Cap on rows per request frame (default 1<<20). Headers above the cap
// (or <= 0 other than the stats op) are rejected: counted in
// iins_server_rejected and the connection is closed.
void iins_server_set_max_rows(void* h, int64_t rows) {
  if (rows > 0) static_cast<Server*>(h)->max_request_rows.store(rows);
}

// Per-read receive timeout for NEW connections (ms; <= 0 disables).
// Applied to connections accepted after the call.
void iins_server_set_recv_timeout_ms(void* h, int64_t ms) {
  static_cast<Server*>(h)->recv_timeout_ms.store(ms);
}

// Frames rejected so far (bad or oversized headers).
int64_t iins_server_rejected(void* h) {
  return static_cast<Server*>(h)->rejected_frames.load();
}

void iins_server_stop(void* h) {
  auto* s = static_cast<Server*>(h);
  if (!s) return;
  s->running.store(false);
  shutdown(s->listen_fd, SHUT_RDWR);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    for (int fd : s->conn_fds) shutdown(fd, SHUT_RDWR);
  }
  s->acceptor.join();
  close(s->listen_fd);
  // handlers are detached; wait until the last one has exited (each sees
  // running == false / its fd shut down and unwinds promptly)
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->drained_cv.wait(lk, [s] { return s->n_active == 0; });
  }
  delete s;
}

}  // extern "C"
