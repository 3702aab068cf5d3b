// Host entry points that share index shards between the processes of one
// host over CUDA IPC (parallel/peer_shards.py), and between the cards of
// one process by peer access (kt_peer_enable); no kernel.
//
// The counterpart of kaiju_tpu's put_global with the psum over the index
// axis (kaiju_tpu/parallel/multihost.py:55-65, parallel/sharded_fused.py:
// 35-36): a process uploads only the shards it holds, each into an
// allocation of its own (kt_peer_alloc), and publishes each one's IPC
// handle (kt_peer_handle); every other process maps it (kt_peer_open), so
// that the sharded kernels read the holder's rows through the pointer
// table of kt::ShardIx as they read their own.  An allocation of its own,
// not a tensor of PyTorch's caching allocator: the handle of a cached
// tensor names its whole segment, whose base the opener would get, and
// with expandable segments legacy IPC fails outright.
//
// Each call returns its cudaError_t (0 on success); kt_error_string, from
// fm_common.cuh, names it.
#include <cstring>

#include "fm_common.cuh"

static_assert(sizeof(cudaIpcMemHandle_t) == 64, "IPC handles of 64 bytes");

// bytes of device memory on card `device` at *ptr
KT_EXPORT int kt_peer_alloc(int device, size_t bytes, void** ptr) {
    cudaError_t e = cudaSetDevice(device);
    if (e == cudaSuccess) e = cudaMalloc(ptr, bytes);
    return e;
}

// the 64-byte IPC handle of an allocation of kt_peer_alloc
KT_EXPORT int kt_peer_handle(void* ptr, void* handle) {
    cudaIpcMemHandle_t h;
    cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
    if (e == cudaSuccess) std::memcpy(handle, &h, sizeof h);
    return e;
}

// another process's allocation, mapped for card `device` at *ptr; over
// NVLink when the allocation is on another card (peer access enabled
// here, the call fails where the two cards have none)
KT_EXPORT int kt_peer_open(int device, const void* handle, void** ptr) {
    cudaIpcMemHandle_t h;
    std::memcpy(&h, handle, sizeof h);
    cudaError_t e = cudaSetDevice(device);
    if (e == cudaSuccess)
        e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
    return e;
}

// unmap what kt_peer_open mapped
KT_EXPORT int kt_peer_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

// free an allocation of kt_peer_alloc
KT_EXPORT int kt_peer_free(void* ptr) { return cudaFree(ptr); }

// let kernels on card `reader` read allocations of card `holder` (over
// NVLink): peer access enabled while `reader` is current.  Access that is
// already enabled (PyTorch enables it for a copy between the cards) counts
// as success, its error cleared.  Returns cudaErrorPeerAccessUnsupported
// where the two cards have no peer access; the caller's current card is
// restored either way.
KT_EXPORT int kt_peer_enable(int reader, int holder) {
    int prev = 0;
    cudaError_t e = cudaGetDevice(&prev);
    if (e != cudaSuccess) return e;
    int can = 0;
    e = cudaDeviceCanAccessPeer(&can, reader, holder);
    if (e == cudaSuccess && !can) e = cudaErrorPeerAccessUnsupported;
    if (e == cudaSuccess) e = cudaSetDevice(reader);
    if (e == cudaSuccess) {
        e = cudaDeviceEnablePeerAccess(holder, 0);
        if (e == cudaErrorPeerAccessAlreadyEnabled) {
            cudaGetLastError();
            e = cudaSuccess;
        }
    }
    cudaError_t back = cudaSetDevice(prev);
    return e != cudaSuccess ? e : back;
}
