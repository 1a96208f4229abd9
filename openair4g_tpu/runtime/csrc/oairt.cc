// oairt — native runtime for the JAX LTE PHY framework.
//
// Reference parity (behavior, not code):
//   * SPSC IQ ring buffer  <- the openair0 device sample stream / RRH
//     ethernet front-haul (targets/ARCH/*, targets/RT/USER/rrh_gw.c) and
//     the lock-free FIFOs of openair2/UTIL/LFDS used by logger/VCD.
//   * ITTI message queues  <- common/utils/itti/intertask_interface.h:121
//     (itti_send_msg_to_task: per-task queues + blocking receive).
//   * Subframe scheduler   <- targets/RT/USER/lte-softmodem.c:993-1197
//     (per-subframe TX/RX worker threads paced by the 1 ms sample clock
//     under SCHED_DEADLINE; here: monotonic-clock pacing + per-subframe
//     worker pool + deadline-miss accounting).
//
// Exposed as a C ABI consumed via ctypes (openair4g_tpu/runtime/native.py).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

using Clock = std::chrono::steady_clock;

// ------------------------------------------------------------------ ring --
namespace {

struct RingBuf {
  std::vector<uint8_t> buf;
  size_t cap;
  std::atomic<size_t> head{0};  // write position (producer)
  std::atomic<size_t> tail{0};  // read position (consumer)
  explicit RingBuf(size_t c) : buf(c), cap(c) {}
};

}  // namespace

extern "C" {

void* rb_create(size_t capacity) { return new RingBuf(capacity); }
void rb_destroy(void* h) { delete static_cast<RingBuf*>(h); }

size_t rb_fill(void* h) {
  auto* r = static_cast<RingBuf*>(h);
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

size_t rb_space(void* h) {
  auto* r = static_cast<RingBuf*>(h);
  return r->cap - rb_fill(h);
}

// Single-producer write of n bytes; returns bytes written (0 or n — no
// partial writes, so a frame boundary never splits unexpectedly).
size_t rb_write(void* h, const void* data, size_t n) {
  auto* r = static_cast<RingBuf*>(h);
  if (rb_space(h) < n) return 0;
  size_t head = r->head.load(std::memory_order_relaxed);
  size_t pos = head % r->cap;
  size_t first = std::min(n, r->cap - pos);
  std::memcpy(r->buf.data() + pos, data, first);
  std::memcpy(r->buf.data(), static_cast<const uint8_t*>(data) + first,
              n - first);
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Single-consumer read of exactly n bytes (0 if not available).
size_t rb_read(void* h, void* out, size_t n) {
  auto* r = static_cast<RingBuf*>(h);
  if (rb_fill(h) < n) return 0;
  size_t tail = r->tail.load(std::memory_order_relaxed);
  size_t pos = tail % r->cap;
  size_t first = std::min(n, r->cap - pos);
  std::memcpy(out, r->buf.data() + pos, first);
  std::memcpy(static_cast<uint8_t*>(out) + first, r->buf.data(), n - first);
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

}  // extern "C"

// ------------------------------------------------------------------ itti --
namespace {

struct Message {
  int msg_id;
  std::vector<uint8_t> payload;
};

constexpr int kMaxTasks = 64;

struct MsgQueues {
  std::mutex mu[kMaxTasks];
  std::condition_variable cv[kMaxTasks];
  std::deque<Message> q[kMaxTasks];
};

}  // namespace

extern "C" {

void* mq_create() { return new MsgQueues(); }
void mq_destroy(void* h) { delete static_cast<MsgQueues*>(h); }

int mq_send(void* h, int task, int msg_id, const void* payload, size_t n) {
  if (task < 0 || task >= kMaxTasks) return -1;
  auto* m = static_cast<MsgQueues*>(h);
  {
    std::lock_guard<std::mutex> lk(m->mu[task]);
    Message msg;
    msg.msg_id = msg_id;
    msg.payload.assign(static_cast<const uint8_t*>(payload),
                       static_cast<const uint8_t*>(payload) + n);
    m->q[task].push_back(std::move(msg));
  }
  m->cv[task].notify_one();
  return 0;
}

// Blocks up to timeout_us; returns payload length (>= 0) or -1 on timeout.
long mq_recv(void* h, int task, int* msg_id, void* buf, size_t cap,
             long timeout_us) {
  if (task < 0 || task >= kMaxTasks) return -1;
  auto* m = static_cast<MsgQueues*>(h);
  std::unique_lock<std::mutex> lk(m->mu[task]);
  if (!m->cv[task].wait_for(lk, std::chrono::microseconds(timeout_us),
                            [&] { return !m->q[task].empty(); }))
    return -1;
  Message msg = std::move(m->q[task].front());
  m->q[task].pop_front();
  lk.unlock();
  *msg_id = msg.msg_id;
  size_t n = std::min(cap, msg.payload.size());
  std::memcpy(buf, msg.payload.data(), n);
  return static_cast<long>(n);
}

size_t mq_pending(void* h, int task) {
  auto* m = static_cast<MsgQueues*>(h);
  std::lock_guard<std::mutex> lk(m->mu[task]);
  return m->q[task].size();
}

}  // extern "C"

// ------------------------------------------------------------- scheduler --
extern "C" {
typedef int (*sf_cb)(int sf_idx, void* user);
}

namespace {

struct Worker {
  std::thread th;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<int> pending;
  bool stop = false;
};

struct Sched {
  long period_us;
  std::vector<Worker> workers;
  sf_cb cb = nullptr;
  void* user = nullptr;
  Clock::time_point t0;
  std::atomic<long> missed{0};
  std::atomic<long> done{0};
  std::atomic<long> cb_fail{0};
  std::mutex stat_mu;
  double sum_us = 0, max_us = 0;
  long n_stat = 0;

  Sched(int n_workers, long period) : period_us(period), workers(n_workers) {}
};

void worker_loop(Sched* s, int wid) {
  Worker& w = s->workers[wid];
  for (;;) {
    int sf;
    {
      std::unique_lock<std::mutex> lk(w.mu);
      w.cv.wait(lk, [&] { return w.stop || !w.pending.empty(); });
      if (w.stop && w.pending.empty()) return;
      sf = w.pending.front();
      w.pending.pop_front();
    }
    auto start = Clock::now();
    int rc = s->cb ? s->cb(sf, s->user) : 0;
    if (rc != 0) s->cb_fail.fetch_add(1);
    auto end = Clock::now();
    double us =
        std::chrono::duration_cast<std::chrono::nanoseconds>(end - start)
            .count() /
        1e3;
    // deadline: the subframe must finish before its successor's slot ends
    // (softmodem gives each worker one period of headroom per pipeline
    // stage; with W workers the budget is W periods)
    double budget = s->period_us * (double)s->workers.size();
    double lateness =
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            end - (s->t0 + std::chrono::microseconds((sf + 1) * s->period_us)))
            .count() /
        1e3;
    if (lateness > budget) s->missed.fetch_add(1);
    {
      std::lock_guard<std::mutex> lk(s->stat_mu);
      s->sum_us += us;
      s->max_us = std::max(s->max_us, us);
      s->n_stat++;
    }
    s->done.fetch_add(1);
  }
}

}  // namespace

extern "C" {

void* sched_create(int n_workers, long period_us) {
  return new Sched(n_workers, period_us);
}
void sched_destroy(void* h) { delete static_cast<Sched*>(h); }

// Paced dispatch of n_subframes; returns number completed. If realtime == 0
// the pacing sleep is skipped (free-run / max throughput mode).
long sched_run(void* h, sf_cb cb, void* user, int n_subframes, int realtime) {
  auto* s = static_cast<Sched*>(h);
  s->cb = cb;
  s->user = user;
  s->missed = 0;
  s->done = 0;
  s->t0 = Clock::now();
  int W = static_cast<int>(s->workers.size());
  for (int i = 0; i < W; i++) {
    s->workers[i].stop = false;
    s->workers[i].th = std::thread(worker_loop, s, i);
  }
  for (int sf = 0; sf < n_subframes; sf++) {
    if (realtime) {
      std::this_thread::sleep_until(
          s->t0 + std::chrono::microseconds(sf * s->period_us));
    }
    Worker& w = s->workers[sf % W];
    {
      std::lock_guard<std::mutex> lk(w.mu);
      w.pending.push_back(sf);
    }
    w.cv.notify_one();
  }
  for (int i = 0; i < W; i++) {
    {
      std::lock_guard<std::mutex> lk(s->workers[i].mu);
      s->workers[i].stop = true;
    }
    s->workers[i].cv.notify_one();
    s->workers[i].th.join();
  }
  return s->done.load();
}

long sched_missed(void* h) { return static_cast<Sched*>(h)->missed.load(); }
long sched_cb_fail(void* h) { return static_cast<Sched*>(h)->cb_fail.load(); }

double sched_mean_us(void* h) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> lk(s->stat_mu);
  return s->n_stat ? s->sum_us / s->n_stat : 0.0;
}

double sched_max_us(void* h) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> lk(s->stat_mu);
  return s->max_us;
}

}  // extern "C"
