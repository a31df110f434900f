// Layer markers for the device trace (utils/trace.py::segment).
//
// A segment of a step launches mark_begin_<name> on the current stream at
// its entry and mark_end_<name> at its exit: one thread that does nothing,
// so the profiler's device trace shows the layer's boundaries as kernel
// records named as written here, in stream order around the layer's own
// kernels. Launched while a CUDA graph is captured, the markers become
// nodes of the graph, and every replay runs them in the same order.
//
// TRACE_SEGMENTS holds utils/trace.py::SEGMENTS, each name spelled as a C
// identifier ('+' as '_'). The wrapper looks up both markers of every
// name of SEGMENTS by symbol when it loads the library, so a name missing
// here fails there.

#include <cuda_runtime.h>

#define TRACE_SEGMENTS(X)                                                   \
  X(voxelize) X(reader) X(backbone) X(neck) X(bbox_head) X(decode_nms)      \
  X(plan) X(dense_tail) X(targets) X(loss) X(backward) X(optimizer)

extern "C" {

#define TRACE_MARKERS(name)                                                 \
  __global__ void mark_begin_##name() {}                                    \
  __global__ void mark_end_##name() {}
TRACE_SEGMENTS(TRACE_MARKERS)
#undef TRACE_MARKERS

// Launches the marker kernel `fn` (one of the symbols above), one block of
// one thread, on `stream`; returns the launch's cudaError_t (0 on
// success).
int trace_mark_launch(const void* fn, void* stream) {
  return static_cast<int>(cudaLaunchKernel(fn, dim3(1), dim3(1), nullptr, 0,
                                           static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
