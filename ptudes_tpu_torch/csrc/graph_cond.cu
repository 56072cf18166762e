// The graph form's conditional nodes: JAX's device-side control flow
// (lax.while_loop, lax.cond) as CUDA graph WHILE and IF nodes.
//
// Replaces no Pallas kernel. It is the port of the control flow XLA
// compiles into the scan program: the candidate-refresh loop's while_loop
// around its lax.cond re-gather (ptudes_tpu/ops/icp.py:505-520), the
// every-iteration registration's while_loop (ptudes_tpu/ops/icp.py:670)
// and the exact insert's overflow fori_loop under one lax.cond
// (ptudes_tpu/ops/hashmap.py:505-518). models/graph.py drives it.
//
// Host side, while a stream is being captured (conditional nodes need
// CUDA 12.4 or later):
// - ptudes_cond_handle creates a conditional handle on the graph the
//   stream captures into (WHILE: default 1, so the first iteration always
//   runs, as in the eager loop; IF: default 0), reset to its default at
//   every launch of the graph;
// - ptudes_cond_open adds the WHILE or IF node after the stream's current
//   capture dependencies, makes the node the stream's only dependency and
//   starts capturing a body stream into the node's body graph; the
//   capturing stream may itself be a body stream (an IF inside a WHILE
//   body);
// - ptudes_cond_close ends the body's capture.
// Streams and graphs are driver objects, so PyTorch's stream handles pass
// through as they are although this library links its own runtime.
//
// Device side, graph_cond_kernel: one thread reads the predicate (a bool
// or an int32, true when nonzero), sets the handle from it
// (cudaGraphSetConditional) and counts into an int32 on the card: 1 a
// launch at the end of a WHILE body (the body's executions), the
// predicate before an IF node (the executions of its body). It is the
// last node of each WHILE body and the node before each IF node. Bound:
// one launch's latency; it moves 1-4 bytes in and 4 bytes out.
//
// Device side, stage_stamp_kernel: the stage clock (models/graph.py:
// StageClock). One thread reads %globaltimer (ns) and keeps, in an int64
// buffer on the card, each stage's ns and executions: a stamp closes the
// stage that is open (adding now - last to its ns) and opens `stage`
// (counting it unless kNoCount). kStart (a step's first stamp) also adds
// the gap from the previous step's end to a last accumulator and writes
// the gap's two ends into a ring; kEnd closes the step. The stamps sit
// between the nodes of a step, never inside a conditional body, so one
// interval holds every repeat of a WHILE or IF node. While the buffer's
// enabled word is 0 the kernel returns at once. kRead only writes the
// timer (the host's calibration against its own clock). Bound: one
// launch's latency; it moves a few words.
#include <cuda_runtime.h>

namespace {

__global__ void graph_cond_kernel(const void* pred, int pred_int,
                                  int* count, int add_value,
                                  cudaGraphConditionalHandle handle) {
  const unsigned value =
      pred_int ? (*static_cast<const int*>(pred) != 0)
               : (*static_cast<const unsigned char*>(pred) != 0);
  cudaGraphSetConditional(handle, value);
  *count += add_value ? static_cast<int>(value) : 1;
}

// the stage clock's layout (models/graph.py: StageClock's indices)
constexpr int kEnabled = 0, kLast = 1, kOpen = 2, kStepEnd = 3, kGaps = 4,
              kRead = 5, kAcc = 8;
constexpr int kStartFlag = 1, kEndFlag = 2, kNoCount = 4, kReadFlag = 8;

__device__ __forceinline__ long long global_timer() {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return now;
}

__global__ void stage_stamp_kernel(long long* clk, int stage, int flags,
                                   int n_stages, int ring) {
  if (flags & kReadFlag) {
    clk[kRead] = global_timer();
    return;
  }
  if (clk[kEnabled] == 0) return;
  const long long now = global_timer();
  long long* acc = clk + kAcc;             // ns by stage, the gap last
  long long* cnt = acc + n_stages + 1;     // executions, the same order
  long long* gaps = cnt + n_stages + 1;    // ring of (end of step, start)
  const long long open = clk[kOpen];
  if (open >= 0) acc[open] += now - clk[kLast];
  if ((flags & kStartFlag) && clk[kStepEnd] > 0) {
    acc[n_stages] += now - clk[kStepEnd];
    cnt[n_stages] += 1;
    const long long slot = clk[kGaps]++ % ring;
    gaps[2 * slot] = clk[kStepEnd];
    gaps[2 * slot + 1] = now;
  }
  if (flags & kEndFlag) {
    clk[kStepEnd] = now;
    clk[kOpen] = -1;
  } else {
    clk[kOpen] = stage;
    if (!(flags & kNoCount)) cnt[stage] += 1;
  }
  clk[kLast] = now;
}

}  // namespace

// kind: 0 IF, 1 WHILE (models/graph.py:IF, WHILE)
extern "C" int ptudes_graph_cond(const void* pred, int pred_int, int* count,
                                 int kind, unsigned long long handle,
                                 cudaStream_t stream) {
  if (kind != 0 && kind != 1) return cudaErrorInvalidValue;
  graph_cond_kernel<<<1, 1, 0, stream>>>(pred, pred_int, count, kind == 0,
                                         handle);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptudes_stage_stamp(long long* clk, int stage, int flags,
                                  int n_stages, int ring,
                                  cudaStream_t stream) {
  if (stage < 0 || stage >= n_stages || ring < 1) return cudaErrorInvalidValue;
  stage_stamp_kernel<<<1, 1, 0, stream>>>(clk, stage, flags, n_stages, ring);
  return static_cast<int>(cudaGetLastError());
}

// Loads the predicate and stamp kernels' code now, outside any capture
// (lazy module loading would otherwise load each at its first launch,
// inside one).
extern "C" int ptudes_graph_cond_load() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, graph_cond_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncGetAttributes(&attr, stage_stamp_kernel));
}

extern "C" int ptudes_stream_create(cudaStream_t* out) {
  return static_cast<int>(
      cudaStreamCreateWithFlags(out, cudaStreamNonBlocking));
}

static cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                                const cudaGraphNode_t** deps,
                                size_t* n_deps) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaError_t err =
      cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, n_deps);
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorIllegalState;
}

extern "C" int ptudes_cond_handle(cudaStream_t stream, int kind,
                                  unsigned long long* handle) {
  if (kind != 0 && kind != 1) return cudaErrorInvalidValue;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, kind == 1 ? 1u : 0u,
                                         cudaGraphCondAssignDefault);
  *handle = h;
  return static_cast<int>(err);
}

extern "C" int ptudes_cond_open(cudaStream_t stream, cudaStream_t body,
                                int kind, unsigned long long handle) {
  if (kind != 0 && kind != 1) return cudaErrorInvalidValue;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(
      stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeGlobal));
}

extern "C" int ptudes_cond_close(cudaStream_t body) {
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(body, &graph));
}
