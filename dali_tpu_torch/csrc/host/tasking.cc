// Host task scheduler — the native analogue of the reference's structured
// concurrency runtime (include/dali/core/exec/tasking/: Task task.h:267,
// Scheduler scheduler.h:173, Semaphore sync.h:156). Tasks carry explicit
// dependencies; a fixed worker pool executes them in dependency order.
// Counting semaphores bound stage parallelism the same way the reference
// bounds executor2 queues.
//
// The Python side submits whole batches through single C calls (see
// dali_tpu_decode_jpeg_batch in jpeg_decode.cc), so the per-sample fan-out
// never round-trips through the interpreter.

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Task {
  void (*fn)(void *) = nullptr;
  void *arg = nullptr;
  int remaining_deps = 0;
  bool done = false;
  std::vector<int64_t> dependents;
};

class Scheduler {
 public:
  explicit Scheduler(int threads) {
    if (threads < 1) threads = 1;
    for (int i = 0; i < threads; i++)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  int NumThreads() const { return (int)workers_.size(); }

  ~Scheduler() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto &t : workers_) t.join();
  }

  int64_t Submit(void (*fn)(void *), void *arg, const int64_t *deps, int ndeps) {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t id = next_id_++;
    Task &t = tasks_[id];
    t.fn = fn;
    t.arg = arg;
    for (int i = 0; i < ndeps; i++) {
      auto it = tasks_.find(deps[i]);
      if (it == tasks_.end() || it->second.done) continue;
      it->second.dependents.push_back(id);
      t.remaining_deps++;
    }
    pending_++;
    if (t.remaining_deps == 0) {
      ready_.push_back(id);
      cv_.notify_one();
    }
    return id;
  }

  void Wait(int64_t id) {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] {
      auto it = tasks_.find(id);
      return it == tasks_.end() || it->second.done;
    });
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return pending_ == 0; });
    // all settled: reclaim bookkeeping so ids don't accumulate
    tasks_.clear();
  }

 private:
  void WorkerLoop() {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_.wait(lk, [&] { return stop_ || !ready_.empty(); });
      if (stop_) return;
      int64_t id = ready_.front();
      ready_.pop_front();
      Task &t = tasks_[id];
      auto fn = t.fn;
      auto arg = t.arg;
      lk.unlock();
      fn(arg);
      lk.lock();
      Task &t2 = tasks_[id];
      t2.done = true;
      pending_--;
      for (int64_t dep : t2.dependents) {
        auto it = tasks_.find(dep);
        if (it != tasks_.end() && --it->second.remaining_deps == 0) {
          ready_.push_back(dep);
          cv_.notify_one();
        }
      }
      done_cv_.notify_all();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<int64_t> ready_;
  std::unordered_map<int64_t, Task> tasks_;
  std::vector<std::thread> workers_;
  int64_t next_id_ = 1;
  int pending_ = 0;
  bool stop_ = false;
};

struct Semaphore {
  std::mutex mu;
  std::condition_variable cv;
  int count;
};

}  // namespace

extern "C" {

void *dali_tpu_pool_create(int threads) { return new Scheduler(threads); }

int dali_tpu_pool_num_threads(void *pool) {
  return static_cast<Scheduler *>(pool)->NumThreads();
}

void dali_tpu_pool_destroy(void *p) { delete static_cast<Scheduler *>(p); }

int64_t dali_tpu_task_submit(void *pool, void (*fn)(void *), void *arg,
                             const int64_t *deps, int ndeps) {
  return static_cast<Scheduler *>(pool)->Submit(fn, arg, deps, ndeps);
}

void dali_tpu_task_wait(void *pool, int64_t id) {
  static_cast<Scheduler *>(pool)->Wait(id);
}

void dali_tpu_pool_wait_all(void *pool) {
  static_cast<Scheduler *>(pool)->WaitAll();
}

void *dali_tpu_sem_create(int count) {
  auto *s = new Semaphore();
  s->count = count;
  return s;
}

void dali_tpu_sem_destroy(void *s) { delete static_cast<Semaphore *>(s); }

void dali_tpu_sem_acquire(void *sp) {
  auto *s = static_cast<Semaphore *>(sp);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv.wait(lk, [&] { return s->count > 0; });
  s->count--;
}

void dali_tpu_sem_release(void *sp) {
  auto *s = static_cast<Semaphore *>(sp);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->count++;
  }
  s->cv.notify_one();
}

}  // extern "C"
