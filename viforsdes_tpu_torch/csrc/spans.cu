// Device span markers (utils/profiling.py, DEVICE_SPANS).
//
// A marker is a one-thread kernel launched at a span boundary inside a
// captured training chunk: it writes the global timer (ns) into its slot of
// a ring buffer, fixed when the chunk is captured. Its name carries the span
// and whether it begins or ends it, spans::begin<id> or spans::end<id>, with
// id the span's index in DEVICE_SPANS, so a profiler trace alone tells the
// boundaries apart, and a dropped record moves no other one.
//
// span_mark also reports the nodes of the graph being captured on the stream
// before its marker (-1 when the stream is not capturing): the nodes between
// two markers are the work of the span between them.

#include <cuda_runtime.h>

namespace spans {

constexpr int kSpans = 12;  // len(DEVICE_SPANS)

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int Span>
__global__ void begin(unsigned long long* slot) { *slot = global_ns(); }

template <int Span>
__global__ void end(unsigned long long* slot) { *slot = global_ns(); }

template <int Span = 0>
cudaError_t launch(int span, int opens, unsigned long long* slot, cudaStream_t stream) {
  if constexpr (Span == kSpans) {
    return cudaErrorInvalidValue;
  } else {
    if (span != Span) return launch<Span + 1>(span, opens, slot, stream);
    if (opens) {
      begin<Span><<<1, 1, 0, stream>>>(slot);
    } else {
      end<Span><<<1, 1, 0, stream>>>(slot);
    }
    return cudaGetLastError();
  }
}

cudaError_t captured_nodes(cudaStream_t stream, long long* nodes) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) {
    *nodes = -1;
    return cudaSuccess;
  }
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes = static_cast<long long>(n);
  return err;
}

}  // namespace spans

extern "C" int span_mark(int span, int opens, unsigned long long* slot, long long* nodes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = spans::captured_nodes(s, nodes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(spans::launch(span, opens, slot, s));
}

extern "C" int span_captured_nodes(long long* nodes, void* stream) {
  return static_cast<int>(spans::captured_nodes(static_cast<cudaStream_t>(stream), nodes));
}
