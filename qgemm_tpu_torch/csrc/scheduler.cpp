// Native continuous-batching slot scheduler.
//
// The TPU-native framework keeps compute in XLA, but the serving runtime's
// host-side state machine — request queue, slot free-list, per-slot
// positions, generated-token storage, finish rules (max_new_tokens / EOS /
// context limit) — is classic native-runtime territory (the reference's
// entire runtime is C++; SURVEY.md §2). This file implements that state
// machine behind a C ABI consumed via ctypes (serving/native.py); the
// Python engine delegates all bookkeeping here and only moves tensors.
//
// Thread-safety: a single mutex guards the whole scheduler; calls are
// cheap (microseconds) next to a decode step, so contention is nil.

#include <cstdint>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
  int64_t id;
  std::vector<int32_t> prompt;
  int32_t max_new_tokens;
  int32_t eos_token;  // -1 = none
  std::vector<int32_t> generated;
  std::vector<int32_t> stops;  // extra stop tokens (any match finishes)
};

struct Scheduler {
  int32_t max_slots;
  int32_t max_seq_len;
  std::deque<Request> waiting;
  std::unordered_map<int32_t, Request> slot_req;   // slot -> active request
  std::vector<int32_t> positions;                  // per slot
  std::vector<uint8_t> active;                     // per slot
  std::deque<Request> finished;
  int64_t steps = 0;
  std::mutex mu;

  Scheduler(int32_t slots, int32_t seq)
      : max_slots(slots), max_seq_len(seq),
        positions(slots, 0), active(slots, 0) {}

  int32_t free_slot() const {
    for (int32_t s = 0; s < max_slots; ++s)
      if (!active[s]) return s;
    return -1;
  }

  void finish_if_done(int32_t slot) {
    auto it = slot_req.find(slot);
    if (it == slot_req.end()) return;
    Request &r = it->second;
    bool last_stop = false;
    if (!r.generated.empty()) {
      int32_t last = r.generated.back();
      last_stop = (r.eos_token >= 0 && last == r.eos_token);
      for (size_t i = 0; !last_stop && i < r.stops.size(); ++i)
        last_stop = (last == r.stops[i]);
    }
    bool done =
        (int32_t)r.generated.size() >= r.max_new_tokens || last_stop ||
        positions[slot] >= max_seq_len - 1;
    if (done) {
      finished.push_back(std::move(r));
      slot_req.erase(it);
      active[slot] = 0;
    }
  }
};

}  // namespace

extern "C" {

void *qg_sched_create(int32_t max_slots, int32_t max_seq_len) {
  if (max_slots <= 0 || max_seq_len <= 0) return nullptr;
  return new Scheduler(max_slots, max_seq_len);
}

void qg_sched_destroy(void *h) { delete static_cast<Scheduler *>(h); }

// Enqueue a request. Returns 0, or -1 if it can never fit the context.
int qg_sched_submit(void *h, int64_t req_id, const int32_t *prompt,
                    int32_t plen, int32_t max_new_tokens, int32_t eos_token) {
  auto *s = static_cast<Scheduler *>(h);
  if (plen <= 0 || plen + max_new_tokens > s->max_seq_len) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  s->waiting.push_back(Request{req_id,
                               std::vector<int32_t>(prompt, prompt + plen),
                               max_new_tokens, eos_token, {}, {}});
  return 0;
}

// Attach extra STOP tokens to a waiting request (call right after submit;
// any generated token matching eos_token OR one of these finishes the
// request). Returns 0, or -1 if the request is not in the waiting queue.
int qg_sched_set_stops(void *h, int64_t req_id, const int32_t *stops,
                       int32_t n) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  for (auto &r : s->waiting)
    if (r.id == req_id) {
      r.stops.assign(stops, stops + n);
      return 0;
    }
  return -1;
}

// Same as qg_sched_submit but inserts at the FRONT of the waiting queue
// (used to requeue a backpressured admission without losing FIFO order).
int qg_sched_submit_front(void *h, int64_t req_id, const int32_t *prompt,
                          int32_t plen, int32_t max_new_tokens,
                          int32_t eos_token) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (plen + max_new_tokens > s->max_seq_len) return -1;
  s->waiting.push_front(Request{req_id,
                                std::vector<int32_t>(prompt, prompt + plen),
                                max_new_tokens, eos_token, {}, {}});
  return 0;
}

// Pop the next admissible request into a free slot. Returns the slot id and
// fills req_id/plen, or -1 when no free slot or nothing waiting. The caller
// must then prefill and call qg_sched_admitted with the first sampled token.
int32_t qg_sched_next_admission(void *h, int64_t *req_id, int32_t *plen) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (s->waiting.empty()) return -1;
  int32_t slot = s->free_slot();
  if (slot < 0) return -1;
  Request r = std::move(s->waiting.front());
  s->waiting.pop_front();
  *req_id = r.id;
  *plen = (int32_t)r.prompt.size();
  s->positions[slot] = (int32_t)r.prompt.size();
  s->active[slot] = 1;
  s->slot_req.emplace(slot, std::move(r));
  return slot;
}

// Copy the prompt of the request occupying `slot` into out (cap elements).
int32_t qg_sched_slot_prompt(void *h, int32_t slot, int32_t *out,
                             int32_t cap) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->slot_req.find(slot);
  if (it == s->slot_req.end()) return -1;
  int32_t n = (int32_t)it->second.prompt.size();
  if (n > cap) return -1;
  for (int32_t i = 0; i < n; ++i) out[i] = it->second.prompt[i];
  return n;
}

// Record the first token produced by the prefill of `slot`.
int qg_sched_admitted(void *h, int32_t slot, int32_t first_token) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->slot_req.find(slot);
  if (it == s->slot_req.end()) return -1;
  it->second.generated.push_back(first_token);
  s->finish_if_done(slot);
  return 0;
}

// Record one decode step: tokens[max_slots] are the sampled next tokens
// (garbage in inactive slots is ignored). Advances positions, appends to
// per-request transcripts, applies finish rules. Returns #finished now.
int32_t qg_sched_record_step(void *h, const int32_t *tokens) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  size_t fin_before = s->finished.size();
  for (int32_t slot = 0; slot < s->max_slots; ++slot) {
    if (!s->active[slot]) continue;
    s->positions[slot] += 1;
    s->slot_req.at(slot).generated.push_back(tokens[slot]);
    s->finish_if_done(slot);
  }
  s->steps += 1;
  return (int32_t)(s->finished.size() - fin_before);
}

// Record one SPECULATIVE round: each active slot appends its own accepted
// candidate block (variable length per slot). cands is [max_slots, width]
// row-major, produced[max_slots] the per-slot accepted count; finish rules
// (EOS / max_new / context limit) truncate mid-block and the remainder of
// that slot's block is ignored. accepted_out[max_slots] receives the
// per-slot count actually appended (post-truncation — the engine's token
// accounting and logprob alignment need it). One scheduler step.
// Returns #finished now.
int32_t qg_sched_record_block(void *h, const int32_t *cands,
                              const int32_t *produced, int32_t width,
                              int32_t *accepted_out) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  size_t fin_before = s->finished.size();
  for (int32_t slot = 0; slot < s->max_slots; ++slot) {
    accepted_out[slot] = 0;
    if (!s->active[slot]) continue;
    int32_t n = produced[slot];
    if (n > width) n = width;
    for (int32_t i = 0; i < n && s->active[slot]; ++i) {
      s->positions[slot] += 1;
      s->slot_req.at(slot).generated.push_back(cands[slot * width + i]);
      accepted_out[slot] += 1;
      s->finish_if_done(slot);
    }
  }
  s->steps += 1;
  return (int32_t)(s->finished.size() - fin_before);
}

void qg_sched_active_mask(void *h, uint8_t *out) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  for (int32_t i = 0; i < s->max_slots; ++i) out[i] = s->active[i];
}

void qg_sched_positions(void *h, int32_t *out) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  for (int32_t i = 0; i < s->max_slots; ++i) out[i] = s->positions[i];
}

int32_t qg_sched_num_waiting(void *h) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return (int32_t)s->waiting.size();
}

int32_t qg_sched_num_active(void *h) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  int32_t n = 0;
  for (auto a : s->active) n += a;
  return n;
}

int32_t qg_sched_num_finished(void *h) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return (int32_t)s->finished.size();
}

int64_t qg_sched_steps(void *h) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->steps;
}

// Id of the request occupying `slot`, or -1 when the slot is free (used by
// the engine's decode-fault recovery to error out every in-flight request).
int64_t qg_sched_slot_request(void *h, int32_t slot) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->slot_req.find(slot);
  return it == s->slot_req.end() ? -1 : it->second.id;
}

// Cancel a request by id. Waiting requests are dropped; an active request
// frees its slot immediately (its partial transcript moves to finished so
// the caller can still pop it). Returns 1 (cancelled from waiting),
// 2 (cancelled from a slot, *slot_out set), 0 (unknown/already finished).
int32_t qg_sched_cancel(void *h, int64_t req_id, int32_t *slot_out) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  for (auto it = s->waiting.begin(); it != s->waiting.end(); ++it) {
    if (it->id == req_id) {
      s->waiting.erase(it);
      return 1;
    }
  }
  for (auto &kv : s->slot_req) {
    if (kv.second.id == req_id) {
      int32_t slot = kv.first;
      s->finished.push_back(std::move(kv.second));
      s->slot_req.erase(slot);
      s->active[slot] = 0;
      if (slot_out) *slot_out = slot;
      return 2;
    }
  }
  return 0;
}

// Temporarily drop `slot` out of the active set WITHOUT touching its
// request (overlapped-admission decode ticks: the slot is mid-prefill, so
// interleaved record_step calls must neither advance its position nor
// append junk tokens). Pair with qg_sched_resume_slot. Returns 0, or -1
// when no request occupies the slot.
int qg_sched_suspend_slot(void *h, int32_t slot) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (slot < 0 || slot >= s->max_slots || !s->slot_req.count(slot))
    return -1;
  s->active[slot] = 0;
  return 0;
}

int qg_sched_resume_slot(void *h, int32_t slot) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (slot < 0 || slot >= s->max_slots || !s->slot_req.count(slot))
    return -1;
  s->active[slot] = 1;
  return 0;
}

// Preempt the ACTIVE request `req_id`: free its slot and REMOVE the
// request, copying its generated transcript into gen_out (cap elements).
// The over-commit paged engine resubmits a CONTINUATION request (prompt =
// original prompt + these tokens, max_new reduced) at the queue front —
// vLLM-style recompute preemption; re-admission recomputes via the
// prefix-cache compute-skip path. Returns #generated, -1 if the request
// is not active, -2 if cap is too small (no change).
int32_t qg_sched_preempt(void *h, int64_t req_id, int32_t *slot_out,
                         int32_t *gen_out, int32_t cap) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  for (auto &kv : s->slot_req) {
    if (kv.second.id == req_id) {
      int32_t slot = kv.first;
      Request &r = kv.second;
      int32_t n = (int32_t)r.generated.size();
      if (n > cap) return -2;
      for (int32_t i = 0; i < n; ++i) gen_out[i] = r.generated[i];
      if (slot_out) *slot_out = slot;
      s->slot_req.erase(slot);
      s->active[slot] = 0;
      return n;
    }
  }
  return -1;
}

// Pop the oldest finished request: fills req_id and copies its generated
// tokens into out (cap elements). Returns #tokens, -1 if none finished,
// -2 if cap too small (request stays queued).
int32_t qg_sched_pop_finished(void *h, int64_t *req_id, int32_t *out,
                              int32_t cap) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (s->finished.empty()) return -1;
  Request &r = s->finished.front();
  int32_t n = (int32_t)r.generated.size();
  if (n > cap) return -2;
  *req_id = r.id;
  for (int32_t i = 0; i < n; ++i) out[i] = r.generated[i];
  s->finished.pop_front();
  return n;
}

}  // extern "C"
