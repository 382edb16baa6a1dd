// Lock-free SPSC/SPMC ring buffer with wrap-free contiguous spans.
//
// device-native analog of the reference's disruptor-style CircularBuffer
// (core/include/gnuradio-4.0/CircularBuffer.hpp:75 double_mapped_memory_resource,
// :223 CircularBuffer, ClaimStrategy.hpp, Sequence.hpp): the same memfd_create +
// double-mmap trick maps the buffer twice back-to-back so any reserve/read span is
// contiguous in virtual memory (no wrap copies), with acquire/release atomic
// sequence cursors. Here it is the host-side data plane between producer threads
// (file/net/SDR readers), the scheduler's feed path, and DataSink consumers —
// the device-side "ring" is the jitted program's donated state + async dispatch.
//
// Build: g++ -O3 -shared -fPIC -std=c++20 ringbuf.cpp -o libgr4ring.so
//
// C ABI (ctypes-friendly). Single producer; 1..N consumers each with their own
// read cursor; producer publishes at the min of consumer positions + capacity.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

#include <climits>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

#ifndef MFD_CLOEXEC // pre-glibc-2.27 fallback
static int memfd_create(const char* name, unsigned int flags) {
    return (int)syscall(SYS_memfd_create, name, flags);
}
#define MFD_CLOEXEC 0x0001U
#endif

namespace {

constexpr std::size_t kCacheLine = 64;

struct alignas(kCacheLine) Cursor {          // ≈ gr::Sequence (Sequence.hpp:31)
    std::atomic<std::uint64_t> value{0};
    char pad[kCacheLine - sizeof(std::atomic<std::uint64_t>)];
};

struct Ring {
    std::uint8_t* base = nullptr;     // double-mapped region (2 × capacity)
    std::size_t capacity = 0;         // bytes (power of two, multiple of page)
    int fd = -1;
    Cursor head;                      // producer publish position (bytes, monotonic)
    Cursor reserved;                  // producer in-flight reserve position
    static constexpr int kMaxReaders = 8;
    Cursor tails[kMaxReaders];        // per-consumer release positions
    std::atomic<int> n_readers{0};    // claim counter (slot allocation)
    std::atomic<int> n_published{0};  // readers whose tail is initialized
    std::atomic<int> eos{0};
    // futex-backed progress epoch (≈ BlockingWaitStrategy, reference
    // WaitStrategy.hpp:54): bumped on every publish/release/EOS; blocked
    // waiters sleep in the kernel on it instead of sleep-polling. Wake
    // syscalls only fire when someone is actually parked (waiters counter).
    std::atomic<std::uint32_t> epoch{0};
    std::atomic<int> waiters{0};
};

void epoch_bump(Ring* r) {
    r->epoch.fetch_add(1, std::memory_order_release);
    if (r->waiters.load(std::memory_order_acquire) > 0)
        syscall(SYS_futex, (std::uint32_t*)&r->epoch, FUTEX_WAKE, INT_MAX,
                nullptr, nullptr, 0);
}

std::size_t round_up(std::size_t v, std::size_t m) { return (v + m - 1) / m * m; }

} // namespace

extern "C" {

// Create a ring of >= min_capacity bytes. Returns nullptr on failure.
Ring* gr4_ring_create(std::size_t min_capacity) {
    const std::size_t page = (std::size_t)sysconf(_SC_PAGESIZE);
    std::size_t cap = page;
    while (cap < min_capacity) cap <<= 1;          // power-of-two for masking
    cap = round_up(cap, page);

    int fd = memfd_create("gr4_ring", MFD_CLOEXEC);
    if (fd < 0) return nullptr;
    if (ftruncate(fd, (off_t)cap) != 0) { close(fd); return nullptr; }

    // reserve 2×cap of address space, then map the same pages twice (≈
    // double_mapped_memory_resource::do_allocate, CircularBuffer.hpp:75-170)
    void* addr = mmap(nullptr, 2 * cap, PROT_NONE,
                      MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (addr == MAP_FAILED) { close(fd); return nullptr; }
    void* lo = mmap(addr, cap, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_FIXED, fd, 0);
    void* hi = mmap((std::uint8_t*)addr + cap, cap, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_FIXED, fd, 0);
    if (lo == MAP_FAILED || hi == MAP_FAILED) {
        munmap(addr, 2 * cap); close(fd); return nullptr;
    }
    Ring* r = new (std::nothrow) Ring();
    if (!r) { munmap(addr, 2 * cap); close(fd); return nullptr; }
    r->base = (std::uint8_t*)addr;
    r->capacity = cap;
    r->fd = fd;
    return r;
}

void gr4_ring_destroy(Ring* r) {
    if (!r) return;
    munmap(r->base, 2 * r->capacity);
    close(r->fd);
    delete r;
}

std::size_t gr4_ring_capacity(Ring* r) { return r->capacity; }

// base of the double-mapped region (2 x capacity bytes contiguous) — lets the
// Python wrapper hold ONE persistent numpy view and turn reserve/read pointers
// into cheap slices instead of per-call buffer construction
std::uint8_t* gr4_ring_data(Ring* r) { return r->base; }

int gr4_ring_add_reader(Ring* r) {
    int id = r->n_readers.fetch_add(1, std::memory_order_acq_rel);
    if (id >= Ring::kMaxReaders) { r->n_readers.fetch_sub(1); return -1; }
    // Publish in claim order AFTER the tail is initialized: a producer's
    // min_tail only scans tails[0..n_published), so it can never observe a
    // zero-initialized tail (which would make head-tail exceed capacity and
    // underflow the free-space computation, granting an overwriting span).
    while (r->n_published.load(std::memory_order_acquire) != id) {
        // rare: another thread mid-registration; registration is setup-time
    }
    // new reader starts at the current head (sees only future data)
    r->tails[id].value.store(r->head.value.load(std::memory_order_acquire),
                             std::memory_order_relaxed);
    r->n_published.store(id + 1, std::memory_order_release);
    return id;
}

static std::uint64_t min_tail(Ring* r) {
    int n = r->n_published.load(std::memory_order_acquire);
    std::uint64_t head = r->head.value.load(std::memory_order_acquire);
    std::uint64_t m = head;  // with no readers, producer may run ahead freely
    for (int i = 0; i < n; ++i) {
        std::uint64_t t = r->tails[i].value.load(std::memory_order_acquire);
        if (t < m) m = t;
    }
    return m;
}

// Producer: contiguous writable span of up to n bytes. Returns ptr (or null) and
// *avail = granted bytes (≤ free space, ≤ n).  ≈ WriterSpan reserve
// (CircularBuffer.hpp:341-629, SingleProducerStrategy ClaimStrategy.hpp:37).
std::uint8_t* gr4_ring_reserve(Ring* r, std::size_t n, std::size_t* avail) {
    std::uint64_t head = r->head.value.load(std::memory_order_relaxed);
    std::uint64_t tail = min_tail(r);
    std::size_t used = (std::size_t)(head - tail);
    std::size_t free_b = used >= r->capacity ? 0 : r->capacity - used;
    std::size_t grant = n < free_b ? n : free_b;
    *avail = grant;
    if (grant == 0) return nullptr;
    r->reserved.value.store(head + grant, std::memory_order_release);
    return r->base + (head & (r->capacity - 1));
}

void gr4_ring_publish(Ring* r, std::size_t n) {
    r->head.value.fetch_add(n, std::memory_order_acq_rel);
    epoch_bump(r);
}

// Consumer: contiguous readable span. Returns ptr (or null), *avail = bytes.
// ≈ ReaderSpan get (CircularBuffer.hpp:632-870).
std::uint8_t* gr4_ring_read(Ring* r, int reader, std::size_t max_n,
                            std::size_t* avail) {
    std::uint64_t tail = r->tails[reader].value.load(std::memory_order_relaxed);
    std::uint64_t head = r->head.value.load(std::memory_order_acquire);
    std::size_t n = (std::size_t)(head - tail);
    if (max_n && n > max_n) n = max_n;
    *avail = n;
    if (n == 0) return nullptr;
    return r->base + (tail & (r->capacity - 1));
}

void gr4_ring_release(Ring* r, int reader, std::size_t n) {
    r->tails[reader].value.fetch_add(n, std::memory_order_acq_rel);
    epoch_bump(r);  // wake producers blocked on free space
}

std::size_t gr4_ring_readable(Ring* r, int reader) {
    return (std::size_t)(r->head.value.load(std::memory_order_acquire) -
                         r->tails[reader].value.load(std::memory_order_acquire));
}

std::size_t gr4_ring_writable(Ring* r) {
    std::size_t used = (std::size_t)(r->head.value.load(std::memory_order_acquire)
                                     - min_tail(r));
    return used >= r->capacity ? 0 : r->capacity - used;
}

void gr4_ring_set_eos(Ring* r) {
    r->eos.store(1, std::memory_order_release);
    epoch_bump(r);
}
int gr4_ring_eos(Ring* r) { return r->eos.load(std::memory_order_acquire); }

// -- multi-producer claim (≈ MultiProducerStrategy, ClaimStrategy.hpp:116) ----
// Producers CAS-claim disjoint byte ranges on the `reserved` cursor; publish
// completes in ticket order (each producer waits until `head` reaches its
// claim start, then advances it past its range). Ordered completion replaces
// the reference's per-slot AtomicBitset — simpler, and producer copies are
// similar-sized here so out-of-order completion windows are short.

std::uint8_t* gr4_ring_reserve_mp(Ring* r, std::size_t n, std::size_t* avail,
                                  std::uint64_t* ticket) {
    for (;;) {
        std::uint64_t claim = r->reserved.value.load(std::memory_order_acquire);
        std::uint64_t tail = min_tail(r);
        std::size_t used = (std::size_t)(claim - tail);
        std::size_t free_b = used >= r->capacity ? 0 : r->capacity - used;
        std::size_t grant = n < free_b ? n : free_b;
        if (grant == 0) { *avail = 0; return nullptr; }
        if (r->reserved.value.compare_exchange_weak(
                claim, claim + grant,
                std::memory_order_acq_rel, std::memory_order_acquire)) {
            *avail = grant;
            *ticket = claim;
            return r->base + (claim & (r->capacity - 1));
        }
    }
}

void gr4_ring_publish_mp(Ring* r, std::uint64_t ticket, std::size_t n) {
    int spins = 0;
    while (r->head.value.load(std::memory_order_acquire) != ticket) {
        if (++spins > 4096) {  // be polite under heavy producer contention
            struct timespec ts{0, 1000};
            nanosleep(&ts, nullptr);
        }
    }
    r->head.value.store(ticket + n, std::memory_order_release);
    epoch_bump(r);
}

// -- blocking waits (≈ BlockingWaitStrategy / TimeoutBlockingWaitStrategy,
// WaitStrategy.hpp:54,141). Callers MUST bind these through a GIL-releasing
// FFI view (ctypes CDLL) — they park the calling thread in the kernel.
// Returns 1 = condition met, 0 = EOS reached first, -1 = timed out.

static int wait_epoch(Ring* r, std::uint32_t seen, long remain_us) {
    struct timespec ts{remain_us / 1000000, (remain_us % 1000000) * 1000};
    r->waiters.fetch_add(1, std::memory_order_acq_rel);
    syscall(SYS_futex, (std::uint32_t*)&r->epoch, FUTEX_WAIT, seen,
            remain_us > 0 ? &ts : nullptr, nullptr, 0);
    r->waiters.fetch_sub(1, std::memory_order_acq_rel);
    return 0;
}

static long now_us() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1000000L + ts.tv_nsec / 1000;
}

int gr4_ring_wait_readable(Ring* r, int reader, std::size_t min_bytes,
                           long timeout_us) {
    const long deadline = now_us() + timeout_us;
    for (;;) {
        std::uint32_t seen = r->epoch.load(std::memory_order_acquire);
        std::uint64_t avail =
            r->head.value.load(std::memory_order_acquire) -
            r->tails[reader].value.load(std::memory_order_acquire);
        if (avail >= min_bytes) return 1;
        if (r->eos.load(std::memory_order_acquire)) return 0;
        long remain = deadline - now_us();
        if (remain <= 0) return -1;
        wait_epoch(r, seen, remain);
    }
}

int gr4_ring_wait_writable(Ring* r, std::size_t min_bytes, long timeout_us) {
    const long deadline = now_us() + timeout_us;
    for (;;) {
        std::uint32_t seen = r->epoch.load(std::memory_order_acquire);
        std::uint64_t head = r->head.value.load(std::memory_order_acquire);
        std::uint64_t tail = min_tail(r);
        std::size_t used = (std::size_t)(head - tail);
        std::size_t free_b = used >= r->capacity ? 0 : r->capacity - used;
        if (free_b >= min_bytes) return 1;
        if (r->eos.load(std::memory_order_acquire)) return 0;
        long remain = deadline - now_us();
        if (remain <= 0) return -1;
        wait_epoch(r, seen, remain);
    }
}

} // extern "C"
