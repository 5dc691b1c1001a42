// Section stamps of a captured program: the device's global nanosecond
// timer written into a ring of rows, one row a replay.
//
// Replaces no TPU kernel: the JAX package names its sections by XLA's
// name stacks, which a profiler reads from the compiled program. A CUDA
// graph's replay carries no host ranges, so the port writes the time into
// device memory from inside the graph (utils/tracing.py, the ring's
// reader; export/captured.py, the capture that records the stamps).
//
// Bound on this card: the launch. One thread reads %globaltimer (a 64-bit
// count of nanoseconds, shared by every SM), reads the ring's cursor and
// writes two or three 8-byte words: nothing to speed up but the graph's
// kernel node itself, a few microseconds at most.
//
// Layout: the ring is `rows` rows of `width` int64 words, row r at
// ring + r * width: word 0 the program's key, words 1.. the stamps in
// slot order. The cursor is one int64 in device memory, the count of
// rows written; row n lands at n % rows, so a wrap keeps the newest rows.
// The stamp of slot 0 writes the key too; the last slot's stamp advances
// the cursor. Every stamp of one replay runs in stream order, so a row is
// written by one replay only, whatever the number of requests queued.

#include <cuda_runtime.h>

namespace {

__global__ void section_stamp_kernel(long long* ring, long long* cursor,
                                     int rows, int width, int slot,
                                     long long key, int last) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long n = *cursor;
  long long* row = ring + (n % rows) * width;
  if (slot == 0) row[0] = key;
  row[1 + slot] = static_cast<long long>(t);
  if (last) *cursor = n + 1;
}

}  // namespace

extern "C" int cm2_section_stamp(long long* ring, long long* cursor, int rows,
                                 int width, int slot, long long key, int last,
                                 void* stream) {
  if (rows <= 0 || slot < 0 || slot + 1 >= width) {
    return (int)cudaErrorInvalidValue;
  }
  section_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      ring, cursor, rows, width, slot, key, last);
  return (int)cudaGetLastError();
}
