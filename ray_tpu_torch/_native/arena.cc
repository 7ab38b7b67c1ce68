// Shared-memory slab arena with a best-fit, coalescing free-list allocator.
//
// TPU-native equivalent of the reference's plasma allocation core
// (src/ray/object_manager/plasma/plasma_allocator.cc +
// dlmalloc.cc): one mmap'd arena per node under /dev/shm, objects are
// (offset, size) extents inside it. Allocation bookkeeping lives in the
// store daemon process (as in plasma, where dlmalloc state lives in the
// store); clients mmap the same file once and read extents zero-copy —
// attach-by-name replaces plasma's fd passing (fling.cc).
//
// Exposed as a C API for ctypes (no pybind11 in this image).
//
// Concurrency: the daemon's event loop is the only caller of alloc/free for
// a given arena; a mutex still guards each arena so bindings may call from
// any thread.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kAlign = 64;  // cache-line; also keeps numpy buffers aligned

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

struct Arena {
  std::string path;
  uint8_t* base = nullptr;
  uint64_t capacity = 0;
  bool owner = false;
  uint64_t used = 0;
  uint64_t n_allocs = 0;
  std::mutex mu;
  // Free extents: offset -> size (ordered, disjoint, coalesced).
  std::map<uint64_t, uint64_t> free_by_off;
  // size -> offset index for best-fit. Rebuilt incrementally.
  std::multimap<uint64_t, uint64_t> free_by_size;
  // Live allocations: offset -> size (needed by free()).
  std::map<uint64_t, uint64_t> live;

  void index_insert(uint64_t off, uint64_t size) {
    free_by_off[off] = size;
    free_by_size.emplace(size, off);
  }
  void index_erase(uint64_t off, uint64_t size) {
    free_by_off.erase(off);
    auto range = free_by_size.equal_range(size);
    for (auto it = range.first; it != range.second; ++it) {
      if (it->second == off) { free_by_size.erase(it); break; }
    }
  }
};

}  // namespace

extern "C" {

// Returns nullptr on failure; errno describes the failure.
Arena* rt_arena_create(const char* path, uint64_t capacity) {
  int fd = ::open(path, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (::ftruncate(fd, (off_t)capacity) != 0) {
    ::close(fd);
    ::unlink(path);
    return nullptr;
  }
  void* base = ::mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) {
    ::unlink(path);
    return nullptr;
  }
  Arena* a = new Arena();
  a->path = path;
  a->base = static_cast<uint8_t*>(base);
  a->capacity = capacity;
  a->owner = true;
  a->index_insert(0, capacity);
  return a;
}

Arena* rt_arena_attach(const char* path, uint64_t capacity) {
  int fd = ::open(path, O_RDWR);
  if (fd < 0) return nullptr;
  void* base = ::mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return nullptr;
  Arena* a = new Arena();
  a->path = path;
  a->base = static_cast<uint8_t*>(base);
  a->capacity = capacity;
  a->owner = false;
  return a;
}

void* rt_arena_base(Arena* a) { return a->base; }
uint64_t rt_arena_capacity(Arena* a) { return a->capacity; }
uint64_t rt_arena_used(Arena* a) {
  std::lock_guard<std::mutex> g(a->mu);
  return a->used;
}
uint64_t rt_arena_num_allocs(Arena* a) {
  std::lock_guard<std::mutex> g(a->mu);
  return a->n_allocs;
}

uint64_t rt_arena_largest_free(Arena* a) {
  std::lock_guard<std::mutex> g(a->mu);
  if (a->free_by_size.empty()) return 0;
  return a->free_by_size.rbegin()->first;
}

// Best-fit allocate. Returns 0 on success with *offset_out set; -1 if no
// free extent fits (caller should evict/spill and retry).
int rt_arena_alloc(Arena* a, uint64_t size, uint64_t* offset_out) {
  if (size == 0) size = kAlign;
  size = align_up(size);
  std::lock_guard<std::mutex> g(a->mu);
  auto it = a->free_by_size.lower_bound(size);
  if (it == a->free_by_size.end()) return -1;
  uint64_t block_size = it->first, off = it->second;
  a->index_erase(off, block_size);
  if (block_size > size) a->index_insert(off + size, block_size - size);
  a->live[off] = size;
  a->used += size;
  a->n_allocs += 1;
  *offset_out = off;
  return 0;
}

// Free a previously allocated extent, coalescing with neighbors.
// Returns the number of bytes released, or -1 if offset is not live.
int64_t rt_arena_free(Arena* a, uint64_t offset) {
  std::lock_guard<std::mutex> g(a->mu);
  auto lit = a->live.find(offset);
  if (lit == a->live.end()) return -1;
  uint64_t size = lit->second;
  a->live.erase(lit);
  a->used -= size;
  a->n_allocs -= 1;

  uint64_t off = offset;
  // Coalesce with successor.
  auto next = a->free_by_off.find(off + size);
  if (next != a->free_by_off.end()) {
    uint64_t nsize = next->second;
    a->index_erase(next->first, nsize);
    size += nsize;
  }
  // Coalesce with predecessor.
  auto succ = a->free_by_off.upper_bound(off);
  if (succ != a->free_by_off.begin()) {
    auto prev = std::prev(succ);
    if (prev->first + prev->second == off) {
      uint64_t poff = prev->first, psize = prev->second;
      a->index_erase(poff, psize);
      off = poff;
      size += psize;
    }
  }
  a->index_insert(off, size);
  return (int64_t)size;
}

// Copy helpers so the daemon can fill/read extents without exposing the
// base pointer through Python.
int rt_arena_write(Arena* a, uint64_t offset, const void* src, uint64_t n) {
  if (offset + n > a->capacity) return -1;
  std::memcpy(a->base + offset, src, n);
  return 0;
}

int rt_arena_read(Arena* a, uint64_t offset, void* dst, uint64_t n) {
  if (offset + n > a->capacity) return -1;
  std::memcpy(dst, a->base + offset, n);
  return 0;
}

void rt_arena_close(Arena* a, int unlink_file) {
  if (a->base) ::munmap(a->base, a->capacity);
  if (unlink_file && a->owner) ::unlink(a->path.c_str());
  delete a;
}

}  // extern "C"
