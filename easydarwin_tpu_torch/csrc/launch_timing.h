// The device timer's events, recorded by the launching entry point itself.
//
// ops/staging.py DeviceTimer times a wrapper call's kernels with a pair of
// timing CUDA events.  Recorded from Python around a launch, the pair also
// held every host pause between the records and the launch: a ctypes call
// gives the GIL up and takes it back, and beside busy Python threads taking
// it back can cost milliseconds, while the card, already past the start
// event, waits.  So ops/kernel_lib.py arms the calling thread with the
// timer's TimingPair (ed_timing_arm) just before it calls an entry point,
// and the entry point records the start event (the first launch of the
// pair only) just before its launch and the stop event just after, in the
// same host call: the pair holds the kernel and the launch call's own host
// time, nothing else.  Every launch consumes the arm, launched or failed; an
// entry point that launches nothing leaves it to the caller to clear.
#pragma once

#include <cuda_runtime.h>

// ops/kernel_lib.py TimingPair: the events (created on the timer's device
// by ed_timing_open) and what has been recorded into them.
struct TimingPair {
  cudaEvent_t start;
  cudaEvent_t stop;
  int started;                      // the start event has been recorded
  int stops;                        // stop events recorded (the last holds)
};

namespace ed_timing {

// The calling thread's armed pair, or null.  An inline function's static
// is one object across the library's sources.
inline TimingPair*& armed() {
  static thread_local TimingPair* pair = nullptr;
  return pair;
}

// Just before a launch on `s`: the pair's start event, once.
inline int start(cudaStream_t s) {
  TimingPair* t = armed();
  if (t == nullptr || t->started) return 0;
  const cudaError_t e = cudaEventRecord(t->start, s);
  if (e != cudaSuccess) {
    armed() = nullptr;
    return int(e);
  }
  t->started = 1;
  return 0;
}

// Just after a launch on `s` that returned `launched`: the stop event, and
// the arm consumed.
inline int stop(cudaStream_t s, cudaError_t launched) {
  TimingPair* t = armed();
  armed() = nullptr;
  if (launched != cudaSuccess || t == nullptr) return int(launched);
  const cudaError_t e = cudaEventRecord(t->stop, s);
  if (e == cudaSuccess) ++t->stops;
  return int(e);
}

}  // namespace ed_timing
