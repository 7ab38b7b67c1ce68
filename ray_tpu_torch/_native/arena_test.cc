// Unit tests for the arena allocator (mirrors the reference's C++-level test
// style, src/ray/object_manager/test/). Assert-based; exits 0
// on success.

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <unistd.h>

extern "C" {
struct Arena;
Arena* rt_arena_create(const char*, uint64_t);
Arena* rt_arena_attach(const char*, uint64_t);
void* rt_arena_base(Arena*);
uint64_t rt_arena_capacity(Arena*);
uint64_t rt_arena_used(Arena*);
uint64_t rt_arena_num_allocs(Arena*);
uint64_t rt_arena_largest_free(Arena*);
int rt_arena_alloc(Arena*, uint64_t, uint64_t*);
int64_t rt_arena_free(Arena*, uint64_t);
int rt_arena_write(Arena*, uint64_t, const void*, uint64_t);
int rt_arena_read(Arena*, uint64_t, void*, uint64_t);
void rt_arena_close(Arena*, int);
}

int main() {
  std::string path = "/dev/shm/rt-arena-test-" + std::to_string(::getpid());
  const uint64_t CAP = 1 << 20;
  Arena* a = rt_arena_create(path.c_str(), CAP);
  assert(a);
  assert(rt_arena_capacity(a) == CAP);
  assert(rt_arena_largest_free(a) == CAP);

  // Alignment + accounting.
  uint64_t o1, o2, o3;
  assert(rt_arena_alloc(a, 100, &o1) == 0);
  assert(o1 % 64 == 0);
  assert(rt_arena_used(a) == 128);  // 100 → 128 aligned
  assert(rt_arena_alloc(a, 64, &o2) == 0);
  assert(rt_arena_alloc(a, 1000, &o3) == 0);
  assert(o1 != o2 && o2 != o3);
  assert(rt_arena_num_allocs(a) == 3);

  // Free middle, realloc same size reuses the hole (best fit).
  assert(rt_arena_free(a, o2) == 64);
  uint64_t o4;
  assert(rt_arena_alloc(a, 64, &o4) == 0);
  assert(o4 == o2);

  // Coalescing: free all → one extent of full capacity.
  assert(rt_arena_free(a, o1) > 0);
  assert(rt_arena_free(a, o3) > 0);
  assert(rt_arena_free(a, o4) > 0);
  assert(rt_arena_used(a) == 0);
  assert(rt_arena_largest_free(a) == CAP);

  // Exhaustion → -1, then recover after free.
  uint64_t big;
  assert(rt_arena_alloc(a, CAP - 64, &big) == 0);
  uint64_t nope;
  assert(rt_arena_alloc(a, 128, &nope) == -1);
  assert(rt_arena_free(a, big) > 0);
  assert(rt_arena_alloc(a, 128, &nope) == 0);
  assert(rt_arena_free(a, nope) > 0);

  // Double free rejected.
  assert(rt_arena_free(a, nope) == -1);

  // Cross-"process" visibility: attach the same file, read what owner wrote.
  uint64_t off;
  assert(rt_arena_alloc(a, 256, &off) == 0);
  const char msg[] = "hello-from-owner";
  assert(rt_arena_write(a, off, msg, sizeof(msg)) == 0);
  Arena* b = rt_arena_attach(path.c_str(), CAP);
  assert(b);
  char buf[sizeof(msg)] = {0};
  assert(rt_arena_read(b, off, buf, sizeof(msg)) == 0);
  assert(std::strcmp(buf, msg) == 0);
  rt_arena_close(b, 0);

  // Fragmentation stress: interleaved alloc/free converges back to empty.
  uint64_t offs[128];
  for (int round = 0; round < 50; ++round) {
    int n = 0;
    for (int i = 0; i < 128; ++i) {
      uint64_t o;
      if (rt_arena_alloc(a, (uint64_t)((i * 37 + round * 13) % 4096 + 1), &o) == 0)
        offs[n++] = o;
    }
    for (int i = 0; i < n; i += 2) assert(rt_arena_free(a, offs[i]) > 0);
    for (int i = 1; i < n; i += 2) assert(rt_arena_free(a, offs[i]) > 0);
  }
  assert(rt_arena_free(a, off) > 0);
  assert(rt_arena_used(a) == 0);
  assert(rt_arena_largest_free(a) == CAP);

  rt_arena_close(a, 1);

  // Randomized alloc/free/write interleaving fuzz: 20k ops against a model
  // of live extents; every live extent's fill pattern must survive every
  // other operation (catches coalescing/offset bookkeeping corruption —
  // run under `make asan` for the sanitized build).
  {
    std::string fpath =
        "/dev/shm/rt-arena-fuzz-" + std::to_string(::getpid());
    const uint64_t FCAP = 1 << 20;
    Arena* f = rt_arena_create(fpath.c_str(), FCAP);
    assert(f);
    struct Live { uint64_t off, size; unsigned char tag; };
    std::vector<Live> live;
    uint64_t seed = 0x9e3779b97f4a7c15ull;
    auto rnd = [&]() {
      seed ^= seed << 13; seed ^= seed >> 7; seed ^= seed << 17;
      return seed;
    };
    unsigned char buf[4096];
    for (int i = 0; i < 20000; i++) {
      uint64_t r = rnd();
      if (live.empty() || (r % 100) < 55) {   // alloc-biased
        uint64_t size = 1 + (rnd() % 4096);
        uint64_t off;
        if (rt_arena_alloc(f, size, &off) == 0) {
          unsigned char tag = (unsigned char)(rnd() % 251);
          std::memset(buf, tag, sizeof(buf));
          assert(rt_arena_write(f, off, buf, size) == 0);
          live.push_back({off, size, tag});
        } else {
          // full: free half the live set and continue
          for (size_t k = 0; k < live.size() / 2 + 1 && !live.empty(); k++) {
            assert(rt_arena_free(f, live.back().off) >= 0);
            live.pop_back();
          }
        }
      } else {
        size_t idx = r % live.size();
        // verify the extent's pattern before freeing it
        unsigned char got[4096];
        assert(rt_arena_read(f, live[idx].off, got, live[idx].size) == 0);
        for (uint64_t b = 0; b < live[idx].size; b++)
          assert(got[b] == live[idx].tag);
        assert(rt_arena_free(f, live[idx].off) >= 0);
        live[idx] = live.back();
        live.pop_back();
      }
    }
    // final sweep: every surviving extent still intact
    for (auto& l : live) {
      unsigned char got[4096];
      assert(rt_arena_read(f, l.off, got, l.size) == 0);
      for (uint64_t b = 0; b < l.size; b++) assert(got[b] == l.tag);
      assert(rt_arena_free(f, l.off) >= 0);
    }
    assert(rt_arena_used(f) == 0);
    assert(rt_arena_largest_free(f) == FCAP);
    rt_arena_close(f, 1);
    std::printf("arena_test: fuzz (20k ops) passed\n");
  }

  std::printf("arena_test: all assertions passed\n");
  return 0;
}
