// Programmatic dependent launch (PDL) on Hopper: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it in the stream is still running. Its prologue overlaps
// that kernel's tail; `pdl_wait()` (griddepcontrol.wait) then blocks until
// the kernel before it has completed and its memory is visible. A kernel
// that calls `pdl_launch_dependents()` (griddepcontrol.launch_dependents)
// lets the next PDL launch start once every block of it has called it (or
// exited); without the call that happens as its blocks exit. Launched
// without the attribute, both instructions do nothing.
//
// The rules every kernel launched by `launch_pdl` keeps:
//  1. Before `pdl_wait()` it reads only the graph's constant index vectors
//     (vertex_inc_ptr, vertex_inc_row, vertex_face): no kernel of a step
//     writes them.
//  2. It makes no global store of any kind before `pdl_wait()`: PyTorch's
//     caching allocator may give its output a block whose previous tensor
//     the kernel before it still reads.
//  3. Every block reaches `pdl_wait()` before it returns (no early return
//     above it), so that a later kernel's wait covers everything before this
//     one too.
// And data the kernel before it writes is read with coherent loads (no
// __restrict__ or __ldg on it): the read-only path's contract holds for the
// kernel's whole life, which now overlaps the writer.
//
// `gfd_set_pdl(0)` makes `launch_pdl` launch without the attribute, so that
// a kernel timed back to back alone does not overlap its own next launch,
// which no path does. Only measurement turns it off. Each library that
// includes this header is one source, so each has its own switch.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace gfd {

inline std::atomic<int> pdl_enabled{1};  // gfd_set_pdl's switch

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Host: launches `kernel` on `stream` with the PDL attribute (unless
// gfd_set_pdl(0) turned it off); returns the CUDA error code (0 on
// success), as the entry points do.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed =
      pdl_enabled.load(std::memory_order_relaxed);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return err != cudaSuccess ? err : last;
}

}  // namespace gfd

// Turns the PDL attribute of this library's launches on (the default) or
// off; returns 0.
extern "C" int gfd_set_pdl(int on) {
  gfd::pdl_enabled.store(on != 0);
  return 0;
}
