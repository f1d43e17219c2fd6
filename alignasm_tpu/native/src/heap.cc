// Heap population + retention for hosts that tax demand faults.
//
// On virtual machines with dirty-page tracking the first write to a
// fresh anonymous page costs far more in hypervisor fault handling than
// one bulk MADV_POPULATE_WRITE of the same pages, which can put glibc's
// demand-faulted heap growth (the chunk-header store in _int_malloc's
// heap-extension path) at the top of a profile.  Three
// semantics-preserving measures:
//
//   1. retention mallopts (aln_tune_heap): freed memory stays mapped so
//      pages fault once per process, not once per run.  M_TOP_PAD is the
//      non-obvious one: glibc's heap_trim() ignores M_TRIM_THRESHOLD for
//      non-main (worker-thread) arenas and shrinks them with
//      MADV_DONTNEED — invisible in /proc/self/maps, refaulted next run.
//      A top pad >= HEAP_MAX_SIZE makes heap_trim's shrink amount
//      negative, so worker heaps are never given back.
//   2. a "page butler" thread that, while runs are active, scans
//      /proc/self/maps and populates newly-appeared anon-RW extents
//      before the workers demand-fault them page by page.
//   3. populate_range() for known big buffers (the PAF slurp) where
//      waiting for the next butler scan would be too late.
//
// All of it is advisory: if MADV_POPULATE_WRITE is unsupported the
// probes fail once and everything degrades to plain demand faulting.
// ALN_NO_BUTLER=1 disables the scanner thread.
#include <fcntl.h>
#include <malloc.h>
#include <pthread.h>
#include <sys/mman.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>

#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23
#endif

namespace aln {

namespace {

bool probe_populate() {
    void *p = mmap(nullptr, 4096, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return false;
    bool ok = madvise(p, 4096, MADV_POPULATE_WRITE) == 0;
    munmap(p, 4096);
    return ok;
}

bool populate_supported() {
    static const bool ok = probe_populate();
    return ok;
}

}  // namespace

// Populate [p, p+len) as if written (page-aligned superset).  Returns
// bytes requested from the kernel, 0 if unsupported or failed — callers
// fall back to ordinary demand faulting either way.
size_t populate_range(void *p, size_t len) {
    if (len == 0 || !populate_supported()) return 0;
    uintptr_t a = (uintptr_t) p & ~(uintptr_t) 4095;
    uintptr_t b = ((uintptr_t) p + len + 4095) & ~(uintptr_t) 4095;
    if (madvise((void *) a, b - a, MADV_POPULATE_WRITE) != 0) return 0;
    return b - a;
}

namespace {

struct Butler {
    std::mutex mu;
    std::condition_variable cv;
    int active = 0;
    bool thread_started = false;
    // region start -> address populated up to (high-water mark)
    std::unordered_map<uintptr_t, uintptr_t> mark;
    // cumulative commit cap: a runaway reservation-heavy process stops
    // getting populated long before it can matter (populate commits RAM)
    size_t budget = 32ull << 30;
    std::string buf;

    size_t scan() {
        size_t populated = 0;
        int fd = open("/proc/self/maps", O_RDONLY | O_CLOEXEC);
        if (fd < 0) return 0;
        buf.clear();
        char tmp[1 << 16];
        ssize_t k;
        while ((k = read(fd, tmp, sizeof tmp)) > 0) buf.append(tmp, (size_t) k);
        close(fd);

        std::unordered_map<uintptr_t, uintptr_t> next;
        next.reserve(mark.size() + 8);
        size_t pos = 0;
        while (pos < buf.size()) {
            size_t eol = buf.find('\n', pos);
            if (eol == std::string::npos) eol = buf.size();
            std::string_view line(buf.data() + pos, eol - pos);
            pos = eol + 1;
            // start-end perms offset dev inode [pathname]
            char *endp = nullptr;
            uintptr_t lo = strtoull(line.data(), &endp, 16);
            if (!endp || *endp != '-') continue;
            uintptr_t hi = strtoull(endp + 1, &endp, 16);
            if (!endp || *endp != ' ') continue;
            std::string_view rest(endp + 1, line.data() + line.size() - (endp + 1));
            if (rest.size() < 4 || rest.substr(0, 4) != "rw-p") continue;
            // anonymous private only: inode 0, path empty or [heap]
            // (named mappings are files; [stack] guards stay untouched)
            size_t sp = rest.find(' ');            // after perms
            size_t off_end = rest.find(' ', sp + 1);
            size_t dev_end = rest.find(' ', off_end + 1);
            size_t ino_end = rest.find(' ', dev_end + 1);
            if (ino_end == std::string_view::npos) ino_end = rest.size();
            std::string_view ino = rest.substr(dev_end + 1, ino_end - dev_end - 1);
            if (ino != "0") continue;
            std::string_view path = rest.substr(std::min(ino_end, rest.size()));
            while (!path.empty() && path.front() == ' ') path.remove_prefix(1);
            if (!path.empty() && path != "[heap]") continue;
            size_t len = hi - lo;
            if (len < (256u << 10) || len > (8ull << 30)) continue;
            uintptr_t from = lo;
            auto it = mark.find(lo);
            if (it != mark.end()) from = std::min(it->second, hi);
            if (from < hi && budget > 0) {
                size_t want = hi - from;
                if (want > budget) want = budget;
                size_t done = populate_range((void *) from, want);
                budget -= std::min(budget, done);
                populated += done;
                from += want;
            }
            next[lo] = from;
        }
        mark.swap(next);
        return populated;
    }

    void loop() {
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
            cv.wait(lk, [&] { return active > 0; });
            while (active > 0) {
                lk.unlock();
                size_t got = scan();
                // chase rapid heap growth (a first run faults ~GBs in a
                // few seconds): rescan immediately while making
                // progress, idle-poll only once growth stops
                if (got < (1u << 20))
                    std::this_thread::sleep_for(std::chrono::milliseconds(20));
                lk.lock();
            }
        }
    }
};

// intentionally leaked: the detached scanner thread may still be waiting
// on the condition variable when exit() runs static destructors, and
// destroying a cv/mutex with a waiter hangs the exiting main thread
Butler &g_butler = *new Butler;

bool butler_enabled() {
    static const bool on = [] {
        const char *e = getenv("ALN_NO_BUTLER");
        return !(e && e[0] && e[0] != '0') && populate_supported();
    }();
    return on;
}

// forked children inherit the counters but not the scanner thread; let
// them start their own on the next begin
void atfork_child() {
    g_butler.thread_started = false;
    g_butler.active = 0;
}

}  // namespace

void butler_begin() {
    if (!butler_enabled()) return;
    std::lock_guard<std::mutex> lk(g_butler.mu);
    if (!g_butler.thread_started) {
        g_butler.thread_started = true;
        static std::once_flag forkreg;
        std::call_once(forkreg, [] {
            pthread_atfork(nullptr, nullptr, atfork_child);
        });
        std::thread(&Butler::loop, &g_butler).detach();
    }
    g_butler.active++;
    g_butler.cv.notify_all();
}

void butler_end() {
    if (!butler_enabled()) return;
    std::lock_guard<std::mutex> lk(g_butler.mu);
    if (g_butler.active > 0) g_butler.active--;
}

}  // namespace aln

extern "C" {

void aln_tune_heap(void) {
    // keep freed parse/graph memory mapped instead of returning it to
    // the OS: where fresh pages fault through a hypervisor's
    // page-tracking layer, a repeated open (bench reps, resume chunks,
    // exporter reuse) re-faulting its working set dominates profiles.
    // M_TOP_PAD >= HEAP_MAX_SIZE additionally disables
    // glibc's MADV_DONTNEED shrinking of worker-thread arenas, which
    // ignores M_TRIM_THRESHOLD (see header comment).
    static std::once_flag tuned;
    std::call_once(tuned, [] {
        mallopt(M_MMAP_THRESHOLD, 1 << 30);
        mallopt(M_TRIM_THRESHOLD, 1 << 30);
        mallopt(M_TOP_PAD, 64 << 20);
    });
}

}  // extern "C"
