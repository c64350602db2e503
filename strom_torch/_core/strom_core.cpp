// strom_core — C++ io_uring read engine of strom_torch, the PyTorch port.
//
// The port's copy of strom/_core/strom_core.cpp, with the same C ABI: struct
// layouts, flag bits and function names. Where
// nvme_strom.ko builds NVMe READ requests on blk-mq queues whose PRPs point
// at pinned GPU BAR1 pages, strom_core issues O_DIRECT reads through io_uring
// into page-aligned host slabs registered with the ring (and with CUDA, by
// the delivery layer), from which the copy engine moves the bytes to the
// card.
//
// Deliberately liburing-free: the ring ABI is set up with raw syscalls so the
// engine builds on any box with <linux/io_uring.h> kernel headers.
//
// C ABI (consumed by strom_torch/engine/uring_engine.py via ctypes):
//   sc_create / sc_destroy               — pool + ring lifecycle (≙ MAP/UNMAP_GPU_MEMORY)
//   sc_register_file / sc_unregister_file— dual-fd (direct+buffered) file table
//   sc_submit_read                       — queue one read      (≙ MEMCPY_SSD2GPU_ASYNC)
//   sc_wait                              — reap completions    (≙ MEMCPY_WAIT)
//   sc_read_vectored                     — a whole gather list in one call
//   sc_register_dest / sc_unregister_dest— caller slabs in the buffer table
//   sc_get_stats                         — counters + latency histogram (≙ /proc/nvme-strom)
//   sc_set_fault_every                   — fault injection for tests
//   sc_jpeg_available / sc_jpeg_decode   — libjpeg-turbo decode (when built in)

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <vector>

// libjpeg-turbo decode, compiled in only when the build probe
// (strom_torch/_core/build.py) finds jpeglib.h with the turbo partial-decode
// API (jpeg_crop_scanline / jpeg_skip_scanlines) and links -ljpeg. Without
// the define sc_jpeg_available() reports 0 and Python keeps cv2/PIL.
#ifdef STROM_HAVE_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

#include <fcntl.h>
#include <linux/io_uring.h>
#include <linux/stat.h>
#include <linux/time_types.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <time.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------- syscalls
int sys_io_uring_setup(unsigned entries, struct io_uring_params *p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                       unsigned flags, const void *arg, size_t argsz) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete, flags,
                      arg, argsz);
}
int sys_io_uring_register(int fd, unsigned opcode, const void *arg,
                          unsigned nr_args) {
  return (int)syscall(__NR_io_uring_register, fd, opcode, arg, nr_args);
}

// struct statx grew stx_dio_mem_align/stx_dio_offset_align in kernel 6.1;
// build hosts with older uapi headers lack the fields but the syscall ABI is
// fixed (the kernel fills a 256-byte buffer at unchanging offsets) — a local
// mirror of the modern layout builds anywhere and runs identically: on a
// pre-6.1 kernel the dio fields simply stay zero and STATX_DIOALIGN never
// lands in stx_mask, which the caller already handles as "unknown".
struct sc_statx_timestamp {
  int64_t tv_sec;
  uint32_t tv_nsec;
  int32_t pad;
};
struct sc_statx {
  uint32_t stx_mask, stx_blksize;
  uint64_t stx_attributes;
  uint32_t stx_nlink, stx_uid, stx_gid;
  uint16_t stx_mode, spare0;
  uint64_t stx_ino, stx_size, stx_blocks, stx_attributes_mask;
  sc_statx_timestamp stx_atime, stx_btime, stx_ctime, stx_mtime;
  uint32_t stx_rdev_major, stx_rdev_minor, stx_dev_major, stx_dev_minor;
  uint64_t stx_mnt_id;
  uint32_t stx_dio_mem_align, stx_dio_offset_align;
  uint64_t spare3[12];
};
static_assert(sizeof(sc_statx) == 256, "statx ABI is a fixed 256 bytes");

// syscall numbers are per-architecture: only fill the gap on arches whose
// number we know; elsewhere (headers old AND arch unknown) skip the statx
// probe entirely — alignment falls back to the 4096 guess, same as a
// pre-4.11 kernel at runtime
#ifndef __NR_statx
#if defined(__x86_64__)
#define __NR_statx 332
#elif defined(__aarch64__)
#define __NR_statx 291
#else
#define SC_NO_STATX 1
#endif
#endif
#ifndef STATX_DIOALIGN
#define STATX_DIOALIGN 0x00002000U
#endif

// Sparse registered-buffer table (kernel 5.13+/5.19+): define the register
// opcodes/structs ourselves so the engine still COMPILES against older uapi
// headers (the file-header promise); at runtime an old kernel just fails the
// BUFFERS2 call and we fall back to legacy REGISTER_BUFFERS.
#ifndef IORING_RSRC_REGISTER_SPARSE
#define IORING_RSRC_REGISTER_SPARSE (1U << 0)
#endif
constexpr unsigned kRegisterBuffers2 = 15;       // IORING_REGISTER_BUFFERS2
constexpr unsigned kRegisterBuffersUpdate = 16;  // IORING_REGISTER_BUFFERS_UPDATE
struct sc_rsrc_register {  // ABI of struct io_uring_rsrc_register
  uint32_t nr;
  uint32_t flags;
  uint64_t resv2;
  uint64_t data;
  uint64_t tags;
};
struct sc_rsrc_update2 {  // ABI of struct io_uring_rsrc_update2
  uint32_t offset;
  uint32_t resv;
  uint64_t data;
  uint64_t tags;
  uint32_t nr;
  uint32_t resv2;
};

uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

constexpr uint32_t kMaxFiles = 1024;
constexpr int kHistBuckets = 24;  // log2 us buckets: 1us .. ~8s

struct FileEntry {
  int fd = -1;           // preferred fd (O_DIRECT when available)
  int fd_buffered = -1;  // page-cache fd for unaligned/tail fallback
  uint32_t mem_align = 4096;
  uint32_t offset_align = 4096;
  bool o_direct = false;
  bool in_use = false;
  bool writable = false;  // opened O_RDWR (the engine's write path)
};

struct OpSlot {
  uint64_t tag = 0;
  uint64_t submit_ns = 0;
  uint64_t offset = 0;
  uint8_t *addr = nullptr;  // destination (pool slot or caller slab)
  uint32_t length = 0;
  int32_t file_index = -1;
  bool in_use = false;
  bool is_write = false;  // IORING_OP_WRITE: no EOF topup, write accounting
};

}  // namespace

extern "C" {

struct sc_completion {
  uint64_t tag;
  int64_t res;  // bytes read (>=0) or -errno
};

struct sc_stats {
  uint64_t ops_submitted;
  uint64_t ops_completed;
  uint64_t ops_errored;
  uint64_t ops_faulted;
  uint64_t bytes_read;
  uint64_t unaligned_fallback_reads;
  uint64_t eof_topup_reads;
  uint64_t lat_count;
  uint64_t lat_total_us;
  uint64_t lat_hist[kHistBuckets];
  uint32_t in_flight;
  uint8_t fixed_buffers;  // 1 if IORING_REGISTER_BUFFERS active
  uint8_t fixed_files;    // 1 if IORING_REGISTER_FILES active
  uint8_t mlocked;        // 1 if pool mlock succeeded
  uint64_t chunk_retries; // vectored-read chunks transparently resubmitted
  uint8_t coop_taskrun;   // 1 if IORING_SETUP_COOP_TASKRUN active
  uint8_t sparse_table;   // 1 if external dest registration is available
  uint32_t ext_buffers;   // currently-registered external dest slabs
  uint64_t ops_fixed;     // ops that rode IORING_OP_READ_FIXED
  uint8_t sqpoll;         // 1 if IORING_SETUP_SQPOLL active
  uint32_t sqpoll_wakeup_errno;  // last fatal SQ_WAKEUP errno (0 = none)
  // residency-hybrid accounting for the vectored gather path: bytes served
  // through the page cache because the range was RESIDENT (cached_bytes) vs
  // bytes read from media O_DIRECT (media_bytes). ADVISORY under memory
  // pressure: residency is snapshotted upfront per gather
  // (anti-readahead-cascade), so pages evicted between the probe and the
  // buffered read still count as cached_bytes — the counters describe the
  // ROUTE chosen, not a guarantee of where the bytes were ultimately
  // served from. Data integrity is unaffected either way.
  uint64_t cached_bytes;
  uint64_t media_bytes;
  // resident_pages() probe syscalls issued (cachestat/mincore): watches for
  // the pathological mixed-segment case where per-chunk bitmap probing
  // would otherwise be invisible (bounded to <=
  // kMaxResidencyProbes groups per segment)
  uint64_t residency_probes;
  // write path: IORING_OP_WRITE ops completed and bytes landed
  // on media/page cache through this engine — appended at the struct tail
  // so older readers of the ABI see an unchanged prefix
  uint64_t ops_written;
  uint64_t bytes_written;
  // submission-boundary syscall accounting: io_uring_enter calls
  // made on the SUBMIT side only (wait-side enters are a different budget),
  // and how many of those were SQPOLL NEED_WAKEUP kicks. Under SQPOLL the
  // poller consumes published SQEs without any enter at all, so
  // enter_submit_calls / bytes moved is the measured A/B the sqpoll knob is
  // gated on. Appended at the struct tail (ABI prefix rule, see ops_written).
  uint64_t enter_submit_calls;
  uint64_t sqpoll_wakeups;
};

struct sc_engine {
  // ring
  int ring_fd = -1;
  struct io_uring_params params {};
  uint8_t *sq_ring = nullptr;
  size_t sq_ring_sz = 0;
  uint8_t *cq_ring = nullptr;
  size_t cq_ring_sz = 0;
  struct io_uring_sqe *sqes = nullptr;
  size_t sqes_sz = 0;
  // SQ pointers
  std::atomic<uint32_t> *sq_head = nullptr;
  std::atomic<uint32_t> *sq_tail = nullptr;
  uint32_t sq_mask = 0;
  uint32_t *sq_array = nullptr;
  // CQ pointers
  std::atomic<uint32_t> *cq_head = nullptr;
  std::atomic<uint32_t> *cq_tail = nullptr;
  uint32_t cq_mask = 0;
  struct io_uring_cqe *cqes = nullptr;

  // staging pool
  uint8_t *pool = nullptr;
  size_t pool_sz = 0;
  uint32_t num_buffers = 0;
  uint64_t buffer_size = 0;

  uint32_t queue_depth = 0;
  bool fixed_buffers = false;
  bool fixed_files = false;
  bool mlocked = false;
  bool coop_taskrun = false;
  bool sqpoll = false;
  std::atomic<uint32_t> *sq_flags = nullptr;  // kernel-written SQ ring flags
  bool has_ext_arg = false;  // IORING_FEAT_EXT_ARG (timed waits); 5.11+

  // sparse registered-buffer table (BUFFERS2, 5.13+): slots
  // [0, num_buffers) hold the internal staging pool, slots
  // [num_buffers, num_buffers + kExtBufSlots) are updatable at runtime so
  // delivery can register ITS slabs and ride READ_FIXED in the vectored
  // hot path (without them, registered buffers serve only the per-op
  // pool path, leaving the bulk gather on plain READ)
  static constexpr uint32_t kExtBufSlots = 64;
  bool sparse_table = false;
  uint64_t ext_len[kExtBufSlots] = {};  // 0 = slot free
  std::mutex ext_mu;

  FileEntry files[kMaxFiles];
  std::mutex files_mu;

  OpSlot *slots = nullptr;  // queue_depth entries; user_data = slot index
  uint32_t *free_slots = nullptr;
  uint32_t n_free = 0;
  std::mutex sq_mu;

  std::mutex cq_mu;
  // Synthetic completions (fault injection + rolled-back submissions) drained
  // by sc_wait. Guarded by cq_mu; grows on demand so a rollback can never be
  // dropped for lack of space (a dropped completion = a caller waiting
  // forever). Lock order rule: cq_mu is NEVER acquired while sq_mu is held —
  // submit paths stage completions locally and append after releasing sq_mu;
  // reap_locked (under cq_mu) returns slots under sq_mu only after the CQ
  // head is published.
  std::vector<sc_completion> synthetic;
  // mirrors synthetic.size(); readable without cq_mu (backpressure guards)
  std::atomic<uint32_t> synthetic_count{0};

  std::atomic<uint32_t> in_flight{0};
  std::atomic<uint64_t> fault_every{0};
  std::atomic<uint64_t> op_counter{0};

  // stats
  std::atomic<uint64_t> ops_submitted{0}, ops_completed{0}, ops_errored{0},
      ops_faulted{0}, bytes_read{0}, unaligned_fallback{0}, eof_topup{0},
      lat_count{0}, lat_total_us{0}, chunk_retries{0}, ops_fixed{0},
      ops_written{0}, bytes_written{0};
  std::atomic<uint64_t> lat_hist[kHistBuckets]{};
  // last non-transient errno from the SQPOLL SQ_WAKEUP enter (0 = none):
  // a dead/unwakeable poller otherwise presents only as a read timeout
  std::atomic<uint32_t> sqpoll_wakeup_errno{0};
  // submit-side io_uring_enter calls + SQPOLL wakeup kicks (sc_stats tail)
  std::atomic<uint64_t> enter_submit_calls{0}, sqpoll_wakeups{0};
  // residency hybrid (sc_create flags bit 5): route page-cache-RESIDENT
  // chunks of a vectored gather through the buffered fd (a memcpy from the
  // cache) instead of re-reading them from media O_DIRECT
  bool residency_hybrid = false;
  std::atomic<uint64_t> cached_bytes{0}, media_bytes{0};
  std::atomic<uint64_t> residency_probes{0};
};

// ---- page-cache residency probe (hybrid read path) -------------------------
// The reference's hybrid submit checks per-block page-cache residency and
// memcpy-serves warm blocks instead of re-reading flash. Userspace twin: cachestat(2) on kernels
// >= 6.5, else mincore(2) on a transient buffered mapping (neither probe
// populates the cache, so a cold file stays cold).
#ifndef __NR_cachestat
#define __NR_cachestat 451
#endif
struct sc_cachestat_range {
  uint64_t off, len;
};
struct sc_cachestat {
  uint64_t nr_cache, nr_dirty, nr_writeback, nr_evicted, nr_recently_evicted;
};

// process-wide probe capability: 0 untried, 1 cachestat, 2 mincore
static std::atomic<int> g_residency_probe{0};

// Resident page count of [off, off+len) on *fd* (a buffered fd), with the
// covering page count in *total_out*. Returns -1 when unprobeable.
static int64_t resident_pages(int fd, uint64_t off, uint64_t len,
                              uint64_t *total_out) {
  static const uint64_t ps = (uint64_t)sysconf(_SC_PAGESIZE);
  uint64_t start = off / ps * ps;
  uint64_t end = (off + len + ps - 1) / ps * ps;
  uint64_t npages = (end - start) / ps;
  if (total_out) *total_out = npages;
  if (npages == 0) return 0;
  int probe = g_residency_probe.load(std::memory_order_relaxed);
  if (probe <= 1) {
    sc_cachestat_range r{off, len};
    sc_cachestat cs;
    memset(&cs, 0, sizeof(cs));
    int err = 0;
    for (int attempt = 0; attempt < 3; ++attempt) {
      // EINTR/EAGAIN are retryable, not a verdict on whether the syscall
      // exists
      if (syscall(__NR_cachestat, fd, &r, &cs, 0) == 0) {
        if (probe == 0) g_residency_probe.store(1, std::memory_order_relaxed);
        return (int64_t)cs.nr_cache;
      }
      err = errno;
      if (err != EINTR && err != EAGAIN) break;
    }
    if (probe == 1) return -1;  // transient failure on a working probe
    if (err == ENOSYS || err == EPERM) {
      // the syscall genuinely isn't available (pre-6.5 kernel, or a
      // syscall-denying seccomp profile): demote to mincore permanently
      g_residency_probe.store(2, std::memory_order_relaxed);
    }
    // any other first-call failure: fall through to mincore for THIS call
    // but leave the state untried so cachestat gets another chance
  }
  void *m = mmap(nullptr, (size_t)(end - start), PROT_READ, MAP_SHARED, fd,
                 (off_t)start);
  if (m == MAP_FAILED) return -1;
  std::vector<unsigned char> vec(npages);
  int rc = mincore(m, (size_t)(end - start), vec.data());
  munmap(m, (size_t)(end - start));
  if (rc != 0) return -1;
  int64_t n = 0;
  for (unsigned char b : vec) n += (b & 1);
  return n;
}

static void record_latency(sc_engine *e, uint64_t us) {
  int b = 0;
  uint64_t v = us;
  while (v > 1 && b < kHistBuckets - 1) {
    v >>= 1;
    ++b;
  }
  e->lat_hist[b].fetch_add(1, std::memory_order_relaxed);
  e->lat_count.fetch_add(1, std::memory_order_relaxed);
  e->lat_total_us.fetch_add(us, std::memory_order_relaxed);
}

// flags bit0: mlock pool; bit1: register buffers; bit2: register files;
// bit3: IORING_SETUP_COOP_TASKRUN (falls back to 0 flags pre-5.19);
// bit4: IORING_SETUP_SQPOLL (falls back to bit3/plain when refused)
sc_engine *sc_create(uint32_t queue_depth, uint32_t num_buffers,
                     uint64_t buffer_size, uint32_t flags) {
  if (queue_depth == 0 || num_buffers == 0 || buffer_size == 0) {
    errno = EINVAL;
    return nullptr;
  }
  sc_engine *e = new sc_engine();
  e->queue_depth = queue_depth;
  e->num_buffers = num_buffers;
  e->buffer_size = buffer_size;
  e->pool_sz = (size_t)num_buffers * buffer_size;

  e->pool = (uint8_t *)mmap(nullptr, e->pool_sz, PROT_READ | PROT_WRITE,
                            MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (e->pool == MAP_FAILED) {
    e->pool = nullptr;
    delete e;
    return nullptr;
  }
  if (flags & 1u) e->mlocked = (mlock(e->pool, e->pool_sz) == 0);
  if (flags & 32u) e->residency_hybrid = true;

  memset(&e->params, 0, sizeof(e->params));
  e->ring_fd = -1;
  if (flags & 16u) {
    // SQPOLL: a kernel thread polls the SQ, so publishing a batch needs no
    // syscall unless the poller idled out (IORING_SQ_NEED_WAKEUP) — the
    // closest userspace analogue of the reference's in-kernel submission
    // path: no user->kernel crossing per IO. Mutually exclusive with
    // COOP_TASKRUN (task work needs the submitting task's context; SQPOLL
    // has none), so bit3 is ignored when the poller comes up. Falls back to
    // the bit3/plain setup when refused (pre-5.13 unprivileged, old
    // kernels, rlimit on kernel threads).
    e->params.flags = IORING_SETUP_SQPOLL;
    e->params.sq_thread_idle = 1000;  // ms of idle before the poller sleeps
    e->ring_fd = sys_io_uring_setup(queue_depth, &e->params);
    if (e->ring_fd >= 0) {
      e->sqpoll = true;
    } else {
      memset(&e->params, 0, sizeof(e->params));
    }
  }
  if (e->ring_fd < 0 && (flags & 8u)) {
    // COOP_TASKRUN (5.19+): completion task work runs at our next ring
    // entry instead of IPI-interrupting the submitting thread mid-fill —
    // the submit loop is the interruptee under load. DEFER_TASKRUN is
    // deliberately NOT used: it requires SINGLE_ISSUER and this engine
    // submits/reaps from arbitrary Python threads.
#ifndef IORING_SETUP_COOP_TASKRUN
#define IORING_SETUP_COOP_TASKRUN (1U << 8)
#endif
    e->params.flags = IORING_SETUP_COOP_TASKRUN;
    e->ring_fd = sys_io_uring_setup(queue_depth, &e->params);
    if (e->ring_fd < 0 && errno == EINVAL) {  // pre-5.19 kernel
      memset(&e->params, 0, sizeof(e->params));
      e->ring_fd = sys_io_uring_setup(queue_depth, &e->params);
    } else if (e->ring_fd >= 0) {
      e->coop_taskrun = true;
    }
  } else if (e->ring_fd < 0) {
    e->ring_fd = sys_io_uring_setup(queue_depth, &e->params);
  }
  if (e->ring_fd < 0) {
    munmap(e->pool, e->pool_sz);
    e->pool = nullptr;
    delete e;
    return nullptr;
  }

  // map SQ/CQ rings (+ SINGLE_MMAP handling) and the SQE array
  e->sq_ring_sz = e->params.sq_off.array + e->params.sq_entries * sizeof(uint32_t);
  e->cq_ring_sz =
      e->params.cq_off.cqes + e->params.cq_entries * sizeof(struct io_uring_cqe);
  if (e->params.features & IORING_FEAT_SINGLE_MMAP) {
    size_t sz = e->sq_ring_sz > e->cq_ring_sz ? e->sq_ring_sz : e->cq_ring_sz;
    e->sq_ring_sz = e->cq_ring_sz = sz;
  }
  e->sq_ring = (uint8_t *)mmap(nullptr, e->sq_ring_sz, PROT_READ | PROT_WRITE,
                               MAP_SHARED | MAP_POPULATE, e->ring_fd,
                               IORING_OFF_SQ_RING);
  if (e->sq_ring == MAP_FAILED) goto fail;
  if (e->params.features & IORING_FEAT_SINGLE_MMAP) {
    e->cq_ring = e->sq_ring;
  } else {
    e->cq_ring = (uint8_t *)mmap(nullptr, e->cq_ring_sz, PROT_READ | PROT_WRITE,
                                 MAP_SHARED | MAP_POPULATE, e->ring_fd,
                                 IORING_OFF_CQ_RING);
    if (e->cq_ring == MAP_FAILED) goto fail;
  }
  e->sqes_sz = e->params.sq_entries * sizeof(struct io_uring_sqe);
  e->sqes = (struct io_uring_sqe *)mmap(nullptr, e->sqes_sz,
                                        PROT_READ | PROT_WRITE,
                                        MAP_SHARED | MAP_POPULATE, e->ring_fd,
                                        IORING_OFF_SQES);
  if (e->sqes == MAP_FAILED) goto fail;

  e->sq_head = (std::atomic<uint32_t> *)(e->sq_ring + e->params.sq_off.head);
  e->sq_tail = (std::atomic<uint32_t> *)(e->sq_ring + e->params.sq_off.tail);
  e->sq_mask = *(uint32_t *)(e->sq_ring + e->params.sq_off.ring_mask);
  e->sq_array = (uint32_t *)(e->sq_ring + e->params.sq_off.array);
  e->sq_flags = (std::atomic<uint32_t> *)(e->sq_ring + e->params.sq_off.flags);
  e->cq_head = (std::atomic<uint32_t> *)(e->cq_ring + e->params.cq_off.head);
  e->cq_tail = (std::atomic<uint32_t> *)(e->cq_ring + e->params.cq_off.tail);
  e->cq_mask = *(uint32_t *)(e->cq_ring + e->params.cq_off.ring_mask);
  e->cqes = (struct io_uring_cqe *)(e->cq_ring + e->params.cq_off.cqes);

  if (flags & 2u) {
    struct iovec *iovs = new struct iovec[num_buffers];
    for (uint32_t i = 0; i < num_buffers; ++i) {
      iovs[i].iov_base = e->pool + (size_t)i * buffer_size;
      iovs[i].iov_len = buffer_size;
    }
    // preferred: sparse table with trailing runtime-updatable slots for
    // delivery slabs (sc_register_dest); legacy REGISTER_BUFFERS otherwise
    struct sc_rsrc_register rr;
    memset(&rr, 0, sizeof(rr));
    rr.nr = num_buffers + sc_engine::kExtBufSlots;
    rr.flags = IORING_RSRC_REGISTER_SPARSE;
    if (sys_io_uring_register(e->ring_fd, kRegisterBuffers2, &rr,
                              sizeof(rr)) == 0) {
      struct sc_rsrc_update2 up;
      memset(&up, 0, sizeof(up));
      up.offset = 0;
      up.data = (uint64_t)(uintptr_t)iovs;
      up.nr = num_buffers;
      // BUFFERS_UPDATE returns the number of entries updated, not 0
      e->fixed_buffers = (sys_io_uring_register(e->ring_fd,
                                                kRegisterBuffersUpdate,
                                                &up, sizeof(up)) >= 0);
      e->sparse_table = e->fixed_buffers;
    } else {
      e->fixed_buffers = (sys_io_uring_register(e->ring_fd,
                                                IORING_REGISTER_BUFFERS, iovs,
                                                num_buffers) == 0);
    }
    delete[] iovs;
  }
  if (flags & 4u) {
    // sparse fixed-file table; slots filled by sc_register_file
    int *fds = new int[kMaxFiles];
    for (uint32_t i = 0; i < kMaxFiles; ++i) fds[i] = -1;
    e->fixed_files = (sys_io_uring_register(e->ring_fd, IORING_REGISTER_FILES,
                                            fds, kMaxFiles) == 0);
    delete[] fds;
  }

#ifdef IORING_FEAT_EXT_ARG
  e->has_ext_arg = (e->params.features & IORING_FEAT_EXT_ARG) != 0;
#endif
  e->slots = new OpSlot[queue_depth];
  e->free_slots = new uint32_t[queue_depth];
  for (uint32_t i = 0; i < queue_depth; ++i) e->free_slots[i] = queue_depth - 1 - i;
  e->n_free = queue_depth;
  e->synthetic.reserve(queue_depth);
  return e;

fail : {
  int saved = errno;
  if (e->sqes && e->sqes != MAP_FAILED) munmap(e->sqes, e->sqes_sz);
  if (e->cq_ring && e->cq_ring != MAP_FAILED && e->cq_ring != e->sq_ring)
    munmap(e->cq_ring, e->cq_ring_sz);
  if (e->sq_ring && e->sq_ring != MAP_FAILED) munmap(e->sq_ring, e->sq_ring_sz);
  close(e->ring_fd);
  munmap(e->pool, e->pool_sz);
  delete e;
  errno = saved;
  return nullptr;
}
}

void sc_destroy(sc_engine *e) {
  if (!e) return;
  for (uint32_t i = 0; i < kMaxFiles; ++i) {
    if (e->files[i].in_use) {
      close(e->files[i].fd);
      close(e->files[i].fd_buffered);
    }
  }
  if (e->sqes) munmap(e->sqes, e->sqes_sz);
  if (e->cq_ring && e->cq_ring != e->sq_ring) munmap(e->cq_ring, e->cq_ring_sz);
  if (e->sq_ring) munmap(e->sq_ring, e->sq_ring_sz);
  if (e->ring_fd >= 0) close(e->ring_fd);
  if (e->pool) munmap(e->pool, e->pool_sz);
  delete[] e->slots;
  delete[] e->free_slots;
  delete e;
}

void *sc_pool_base(sc_engine *e) { return e->pool; }

// o_direct bits 0-2: 0 = buffered, 1 = required (else fall back), 2 = auto.
// Bit 3 (| 8): open the file READ-WRITE (the write path) — the caller
// creates/sizes the file first; both fds (direct + buffered) carry O_RDWR so
// aligned writes ride O_DIRECT and unaligned ones fall back buffered exactly
// like reads do.
int sc_register_file(sc_engine *e, const char *path, int o_direct) {
  bool writable = (o_direct & 8) != 0;
  o_direct &= 7;
  int base_flags = (writable ? O_RDWR : O_RDONLY) | O_CLOEXEC;
  int fd_buf = open(path, base_flags);
  if (fd_buf < 0) return -errno;

  uint32_t mem_align = 4096, offset_align = 4096;
  bool dio_known = false, dio_ok = true;
#ifndef SC_NO_STATX
  {
    struct sc_statx stx;
    memset(&stx, 0, sizeof(stx));
    if (syscall(__NR_statx, AT_FDCWD, path, 0, STATX_DIOALIGN, &stx) == 0 &&
        (stx.stx_mask & STATX_DIOALIGN)) {
      dio_known = true;
      if (stx.stx_dio_mem_align == 0 || stx.stx_dio_offset_align == 0) {
        dio_ok = false;
      } else {
        mem_align = stx.stx_dio_mem_align;
        offset_align = stx.stx_dio_offset_align;
      }
    }
  }
#endif

  int fd = -1;
  bool use_direct = false;
  if (o_direct != 0 && (!dio_known || dio_ok)) {
    fd = open(path, base_flags | O_DIRECT);
    if (fd >= 0) use_direct = true;
  }
  if (fd < 0) {
    fd = dup(fd_buf);
    if (fd < 0) {
      int err = -errno;
      close(fd_buf);
      return err;
    }
  }

  std::lock_guard<std::mutex> g(e->files_mu);
  for (uint32_t i = 0; i < kMaxFiles; ++i) {
    if (!e->files[i].in_use) {
      e->files[i] = FileEntry{fd,         fd_buf, mem_align, offset_align,
                              use_direct, true,   writable};
      if (e->fixed_files) {
        struct io_uring_files_update up;
        memset(&up, 0, sizeof(up));
        up.offset = i;
        up.fds = (uint64_t)(uintptr_t)&fd;
        if (sys_io_uring_register(e->ring_fd, IORING_REGISTER_FILES_UPDATE, &up,
                                  1) < 0) {
          e->fixed_files = false;  // degrade to plain fds for all ops
        }
      }
      return (int)i;
    }
  }
  close(fd);
  close(fd_buf);
  return -ENFILE;
}

int sc_unregister_file(sc_engine *e, int file_index) {
  if (file_index < 0 || file_index >= (int)kMaxFiles) return -EINVAL;
  std::lock_guard<std::mutex> g(e->files_mu);
  FileEntry &f = e->files[file_index];
  if (!f.in_use) return -EBADF;
  if (e->fixed_files) {
    int minus1 = -1;
    struct io_uring_files_update up;
    memset(&up, 0, sizeof(up));
    up.offset = (uint32_t)file_index;
    up.fds = (uint64_t)(uintptr_t)&minus1;
    sys_io_uring_register(e->ring_fd, IORING_REGISTER_FILES_UPDATE, &up, 1);
  }
  close(f.fd);
  close(f.fd_buffered);
  f = FileEntry{};
  return 0;
}

int sc_file_is_o_direct(sc_engine *e, int file_index) {
  if (file_index < 0 || file_index >= (int)kMaxFiles) return -EINVAL;
  std::lock_guard<std::mutex> g(e->files_mu);
  if (!e->files[file_index].in_use) return -EBADF;
  return e->files[file_index].o_direct ? 1 : 0;
}

uint32_t sc_in_flight(sc_engine *e) {
  return e->in_flight.load(std::memory_order_relaxed);
}

void sc_set_fault_every(sc_engine *e, uint64_t n) {
  e->fault_every.store(n, std::memory_order_relaxed);
}

// Fill one SQE + OpSlot. Caller holds sq_mu and guarantees n_free > 0.
static void fill_sqe_locked(sc_engine *e, const FileEntry &f, int file_index,
                            uint64_t offset, uint32_t length,
                            int64_t buf_index, uint32_t buf_offset,
                            uint8_t *addr, uint64_t tag,
                            bool force_buffered = false,
                            bool is_write = false) {
  uint32_t slot_idx = e->free_slots[--e->n_free];
  OpSlot &slot = e->slots[slot_idx];
  slot.tag = tag;
  slot.submit_ns = now_ns();
  slot.offset = offset;
  slot.addr = addr;
  slot.length = length;
  slot.file_index = file_index;
  slot.in_use = true;
  slot.is_write = is_write;

  bool aligned = (offset % f.offset_align == 0) &&
                 (length % f.offset_align == 0) &&
                 (((uintptr_t)addr) % f.mem_align == 0);
  // force_buffered: the residency hybrid routed this cache-warm chunk to the
  // buffered fd on purpose — a deliberate route, not an alignment fallback
  bool direct = f.o_direct && aligned && !force_buffered;
  if (f.o_direct && !aligned && !force_buffered)
    e->unaligned_fallback.fetch_add(1, std::memory_order_relaxed);

  uint32_t tail = e->sq_tail->load(std::memory_order_relaxed);
  uint32_t idx = tail & e->sq_mask;
  struct io_uring_sqe *sqe = &e->sqes[idx];
  memset(sqe, 0, sizeof(*sqe));
  // READ_FIXED for any addr INSIDE the registered entry (the kernel bounds-
  // checks addr against the entry's iovec) — gating on buf_offset == 0 kept
  // the fixed path off every partial-slot and external-slab read
  (void)buf_offset;
  if (is_write) {
    // the write twin of the read path: same fd routing, same
    // fixed-buffer eligibility. IORING_OP_WRITE carries addr/len inline
    // (no caller-lifetime iovec like WRITEV), which matters under SQPOLL
    // where the kernel may consume the SQE after this call returns.
    sqe->opcode = (direct && e->fixed_buffers && buf_index >= 0)
                      ? IORING_OP_WRITE_FIXED
                      : IORING_OP_WRITE;
    if (sqe->opcode == IORING_OP_WRITE_FIXED) {
      sqe->buf_index = (uint16_t)buf_index;
      e->ops_fixed.fetch_add(1, std::memory_order_relaxed);
    }
  } else {
    sqe->opcode = (direct && e->fixed_buffers && buf_index >= 0)
                      ? IORING_OP_READ_FIXED
                      : IORING_OP_READ;
    if (sqe->opcode == IORING_OP_READ_FIXED) {
      sqe->buf_index = (uint16_t)buf_index;
      e->ops_fixed.fetch_add(1, std::memory_order_relaxed);
    }
  }
  sqe->addr = (uint64_t)(uintptr_t)addr;
  sqe->len = length;
  sqe->off = offset;
  sqe->user_data = slot_idx;
  if (direct && e->fixed_files) {
    sqe->fd = file_index;
    sqe->flags |= IOSQE_FIXED_FILE;
  } else {
    sqe->fd = direct ? f.fd : f.fd_buffered;
  }

  e->sq_array[idx] = idx;
  e->sq_tail->store(tail + 1, std::memory_order_release);
}

// Hand k published SQEs to the kernel. Caller holds sq_mu and must append
// staged[0..EnterResult.failed) to e->synthetic under cq_mu AFTER releasing
// sq_mu (lock-order rule: never cq_mu under sq_mu).
//
// Transient errnos (EINTR/EAGAIN/EBUSY) are retried. On an unexpected fatal
// errno the kernel consumed none of the remaining SQEs, so they are rolled
// back — sq_tail is rewound, their slots freed, and each op is failed with a
// staged synthetic completion. The caller of sc_wait therefore sees the
// failure within one wait cycle instead of blocking forever on ops the
// kernel never saw.
struct EnterResult {
  uint32_t submitted;  // ops the kernel accepted
  uint32_t failed;     // ops rolled back; completions staged by the caller
};

static EnterResult ring_enter_submit(sc_engine *e, unsigned k,
                                     sc_completion *staged) {
  unsigned remaining = k;
  int fatal = 0;
  if (e->sqpoll) {
    // The poller thread consumes published SQEs on its own; enter only to
    // wake it when it idled out. No rollback arm exists here: once sq_tail
    // is published under SQPOLL the kernel may already be consuming, so
    // rewinding would race the poller.
    // full barrier between the sq_tail release-store (fill_sqe_locked) and
    // this flags load: release/acquire does not order an older store against
    // a younger load, and the poller's NEED_WAKEUP set + tail re-check can
    // otherwise interleave so that neither side sees the other — the app
    // skips the wakeup, the poller sleeps, the batch is never consumed
    // (io_uring_enter(2) mandates a smp_mb() here; liburing does the same)
    std::atomic_thread_fence(std::memory_order_seq_cst);
    if (e->sq_flags->load(std::memory_order_relaxed) & IORING_SQ_NEED_WAKEUP) {
      e->sqpoll_wakeups.fetch_add(1, std::memory_order_relaxed);
      for (;;) {
        e->enter_submit_calls.fetch_add(1, std::memory_order_relaxed);
        if (sys_io_uring_enter(e->ring_fd, 0, 0, IORING_ENTER_SQ_WAKEUP,
                               nullptr, 0) >= 0)
          break;
        if (errno == EINTR || errno == EAGAIN || errno == EBUSY) continue;
        // non-transient: the poller may be dead/unwakeable. Record the errno
        // so a stalled batch is diagnosable from stats() instead of
        // presenting only as sc_wait's bounded-timeout read timeout. The
        // batch itself is NOT rolled back (the poller may already be
        // consuming it — see the no-rollback rule above).
        e->sqpoll_wakeup_errno.store((uint32_t)errno,
                                     std::memory_order_relaxed);
        break;
      }
    }
    e->ops_submitted.fetch_add(k, std::memory_order_relaxed);
    e->in_flight.fetch_add(k, std::memory_order_relaxed);
    return EnterResult{k, 0};
  }
  while (fatal == 0 && remaining > 0) {
    e->enter_submit_calls.fetch_add(1, std::memory_order_relaxed);
    int ret = sys_io_uring_enter(e->ring_fd, remaining, 0, 0, nullptr, 0);
    if (ret >= 0) {
      remaining -= (unsigned)ret < remaining ? (unsigned)ret : remaining;
      continue;  // ret==0 is transient in non-SQPOLL mode; keep pushing
    }
    if (errno == EINTR || errno == EAGAIN || errno == EBUSY) continue;
    fatal = errno;
  }
  uint32_t failed = 0;
  if (remaining > 0) {
    // The failing io_uring_enter consumed nothing, so the last `remaining`
    // published SQEs are untouched by the kernel: rewind sq_tail over them
    // (we hold sq_mu; nobody else can have appended after us) and fail their
    // ops loudly.
    uint32_t tail = e->sq_tail->load(std::memory_order_relaxed);
    for (unsigned j = 0; j < remaining; ++j) {
      uint32_t idx = (tail - 1 - j) & e->sq_mask;
      uint32_t slot_idx = (uint32_t)e->sqes[idx].user_data;
      OpSlot &slot = e->slots[slot_idx];
      staged[failed++] = sc_completion{slot.tag, -(int64_t)fatal};
      slot.in_use = false;
      e->free_slots[e->n_free++] = slot_idx;
    }
    e->sq_tail->store(tail - remaining, std::memory_order_release);
    e->ops_errored.fetch_add(failed, std::memory_order_relaxed);
  }
  e->ops_submitted.fetch_add(k, std::memory_order_relaxed);
  // failed ops stay "in flight" until their synthetic completion is reaped —
  // same accounting as fault injection.
  e->in_flight.fetch_add(k, std::memory_order_relaxed);
  return EnterResult{k - failed, failed};
}

// Read into pool slot buf_index at buf_offset (READ_FIXED eligible).
int sc_submit_read(sc_engine *e, int file_index, uint64_t offset,
                   uint32_t length, uint32_t buf_index, uint32_t buf_offset,
                   uint64_t tag) {
  if (file_index < 0 || file_index >= (int)kMaxFiles) return -EINVAL;
  if ((uint64_t)buf_index >= e->num_buffers) return -EINVAL;
  if ((uint64_t)buf_offset + length > e->buffer_size) return -EINVAL;

  // fault injection: complete synthetically with -EIO
  uint64_t fe = e->fault_every.load(std::memory_order_relaxed);
  uint64_t opno = e->op_counter.fetch_add(1, std::memory_order_relaxed) + 1;
  if (fe > 0 && opno % fe == 0) {
    std::lock_guard<std::mutex> g(e->cq_mu);
    if (e->synthetic.size() >= e->queue_depth) return -EAGAIN;
    e->ops_faulted.fetch_add(1, std::memory_order_relaxed);
    e->ops_submitted.fetch_add(1, std::memory_order_relaxed);
    e->in_flight.fetch_add(1, std::memory_order_relaxed);
    e->synthetic.push_back(sc_completion{tag, -EIO});
    e->synthetic_count.store((uint32_t)e->synthetic.size(),
                             std::memory_order_relaxed);
    return 0;
  }

  FileEntry f;
  {
    std::lock_guard<std::mutex> g(e->files_mu);
    if (!e->files[file_index].in_use) return -EBADF;
    f = e->files[file_index];
  }

  uint8_t *addr = e->pool + (size_t)buf_index * e->buffer_size + buf_offset;

  sc_completion staged[1];
  EnterResult r;
  {
    std::lock_guard<std::mutex> g(e->sq_mu);
    if (e->n_free == 0) return -EAGAIN;
    fill_sqe_locked(e, f, file_index, offset, length, (int64_t)buf_index,
                    buf_offset, addr, tag);
    r = ring_enter_submit(e, 1, staged);
  }
  if (r.failed) {
    std::lock_guard<std::mutex> cg(e->cq_mu);
    e->synthetic.push_back(staged[0]);
    e->synthetic_count.store((uint32_t)e->synthetic.size(),
                             std::memory_order_relaxed);
  }
  return 0;
}

// Drain ready CQEs + synthetic completions into out[]; returns count.
// Caller holds cq_mu. Freed slots are returned to the SQ free list in ONE
// sq_mu acquisition, strictly AFTER the CQ head is published — so a
// submitter briefly holding sq_mu can never stall CQ-space publication
// (livelock under CQ-full), and the cq_mu→sq_mu nesting here is deadlock-free
// because no submit path acquires cq_mu while holding sq_mu.
static uint32_t reap_locked(sc_engine *e, sc_completion *out, uint32_t max) {
  uint32_t n = 0;
  while (n < max && !e->synthetic.empty()) {
    out[n++] = e->synthetic.back();
    e->synthetic.pop_back();
    e->in_flight.fetch_sub(1, std::memory_order_relaxed);
  }
  e->synthetic_count.store((uint32_t)e->synthetic.size(),
                           std::memory_order_relaxed);
  uint32_t head = e->cq_head->load(std::memory_order_relaxed);
  uint32_t tail = e->cq_tail->load(std::memory_order_acquire);
  uint32_t *freed = (uint32_t *)alloca(sizeof(uint32_t) * max);
  uint32_t n_freed = 0;
  while (n < max && head != tail) {
    struct io_uring_cqe *cqe = &e->cqes[head & e->cq_mask];
    uint32_t slot_idx = (uint32_t)cqe->user_data;
    OpSlot &slot = e->slots[slot_idx];
    int64_t res = cqe->res;
    head++;
    if (res >= 0 && (uint32_t)res < slot.length && slot.file_index >= 0 &&
        !slot.is_write) {
      // Short read. For O_DIRECT files this is the aligned-EOF case: top up
      // the unaligned tail through the page cache (≙ the reference's
      // page-cache fallback arm).
      FileEntry f;
      bool have = false;
      {
        std::lock_guard<std::mutex> fg(e->files_mu);
        if (e->files[slot.file_index].in_use) {
          f = e->files[slot.file_index];
          have = true;
        }
      }
      if (have && f.o_direct) {
        ssize_t extra = pread(f.fd_buffered, slot.addr + res, slot.length - res,
                              (off_t)(slot.offset + res));
        if (extra > 0) {
          res += extra;
          e->eof_topup.fetch_add(1, std::memory_order_relaxed);
        }
      }
    }
    if (res < 0)
      e->ops_errored.fetch_add(1, std::memory_order_relaxed);
    else {
      e->ops_completed.fetch_add(1, std::memory_order_relaxed);
      if (slot.is_write) {
        // short writes count NOTHING here: the Python retry rewrites the
        // WHOLE piece, whose full completion counts once — crediting the
        // partial res too would double-count the overlap (reads have no
        // such asymmetry: their short tail detours to the EOF topup)
        if ((uint32_t)res >= slot.length) {
          e->ops_written.fetch_add(1, std::memory_order_relaxed);
          e->bytes_written.fetch_add((uint64_t)res,
                                     std::memory_order_relaxed);
        }
      } else {
        e->bytes_read.fetch_add((uint64_t)res, std::memory_order_relaxed);
      }
      record_latency(e, (now_ns() - slot.submit_ns) / 1000);
    }
    out[n++] = sc_completion{slot.tag, res};
    slot.in_use = false;
    freed[n_freed++] = slot_idx;
    e->in_flight.fetch_sub(1, std::memory_order_relaxed);
  }
  e->cq_head->store(head, std::memory_order_release);
  if (n_freed > 0) {
    std::lock_guard<std::mutex> sg(e->sq_mu);
    for (uint32_t i = 0; i < n_freed; ++i)
      e->free_slots[e->n_free++] = freed[i];
  }
  return n;
}

// timeout_ms: <0 block until min_completions; 0 poll; >0 bounded wait.
int sc_wait(sc_engine *e, sc_completion *out, uint32_t max,
            uint32_t min_completions, int timeout_ms) {
  if (max == 0) return 0;
  if (min_completions > max) min_completions = max;
  uint32_t got = 0;
  uint64_t deadline =
      timeout_ms > 0 ? now_ns() + (uint64_t)timeout_ms * 1000000ull : 0;
  for (;;) {
    {
      std::lock_guard<std::mutex> g(e->cq_mu);
      got += reap_locked(e, out + got, max - got);
    }
    if (got >= min_completions || timeout_ms == 0) return (int)got;
    if (e->in_flight.load(std::memory_order_relaxed) == 0) return (int)got;
    if (timeout_ms > 0 && now_ns() >= deadline) return (int)got;

    unsigned want = min_completions - got;
    if (timeout_ms < 0) {
      // Bounded 100ms waits even for "block forever": synthetic completions
      // (fault injection, submission rollback) produce no kernel CQE, so an
      // unbounded GETEVENTS would never observe them — the reap at the top
      // of the loop must get a periodic chance to drain e->synthetic.
      if (e->has_ext_arg) {
        struct __kernel_timespec ts = {0, 100000000};  // 100ms
        struct io_uring_getevents_arg arg;
        memset(&arg, 0, sizeof(arg));
        arg.ts = (uint64_t)(uintptr_t)&ts;
        int ret = sys_io_uring_enter(e->ring_fd, 0, want,
                                     IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG,
                                     &arg, sizeof(arg));
        if (ret < 0 && errno != EINTR && errno != ETIME)
          return got > 0 ? (int)got : -errno;
      } else {
        struct timespec ts = {0, 500000};
        nanosleep(&ts, nullptr);
      }
    } else if (!e->has_ext_arg) {
      // Pre-5.11 kernels: no timed enter; poll the CQ at 500us granularity.
      struct timespec ts = {0, 500000};
      nanosleep(&ts, nullptr);
    } else {
      struct __kernel_timespec ts;
      uint64_t left = deadline - now_ns();
      ts.tv_sec = (int64_t)(left / 1000000000ull);
      ts.tv_nsec = (long long)(left % 1000000000ull);
      struct io_uring_getevents_arg arg;
      memset(&arg, 0, sizeof(arg));
      arg.ts = (uint64_t)(uintptr_t)&ts;
      int ret = sys_io_uring_enter(e->ring_fd, 0, want,
                                   IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG,
                                   &arg, sizeof(arg));
      if (ret < 0 && errno != EINTR && errno != ETIME)
        return got > 0 ? (int)got : -errno;
    }
  }
}

struct sc_raw_op {
  int32_t file_index;
  uint32_t length;
  uint64_t offset;
  uint64_t tag;
  void *addr;
  int32_t buf_index;  // registered-buffer table index for READ_FIXED
                      // (addr must lie inside that entry); -1 = plain READ
  int32_t op_flags;   // bit0 (SC_OP_BUFFERED): force the buffered fd —
                      // the residency hybrid routes cache-warm chunks here.
                      // bit1 (SC_OP_WRITE): IORING_OP_WRITE from addr
                      // — file must be registered writable
};
static constexpr int32_t SC_OP_BUFFERED = 1;
static constexpr int32_t SC_OP_WRITE = 2;

// Batch submit into caller-owned memory: one lock, one io_uring_enter for the
// whole vector (the per-op path costs one syscall per 128KiB block — at NVMe
// rates that is tens of thousands of syscalls/s this removes).
//
// Returns ops accepted, or -errno if the FIRST op is unacceptable. On a
// partial accept (< n), *stop_errno (if non-null) says why: 0 for
// backpressure (queue/synthetic budget — reap and resubmit the rest) vs the
// positive errno of the eligible-but-broken op (EINVAL/EBADF — resubmitting
// that op can never succeed).
//
// "Accepted" includes ops that will FAIL via a synthetic completion (fault
// injection, submission rollback) — the caller sees those failures in
// sc_wait, never as silently-missing ops.
int sc_submit_raw_batch(sc_engine *e, const sc_raw_op *ops, uint32_t n,
                        int32_t *stop_errno) {
  uint32_t accepted = 0;
  uint32_t filled = 0;
  int rc = 0;
  int32_t stop = 0;
  // Completions staged under sq_mu, appended to e->synthetic under cq_mu only
  // after sq_mu is released: reap_locked nests sq_mu inside cq_mu, so taking
  // cq_mu here while holding sq_mu would be a classic ABBA deadlock.
  std::vector<sc_completion> staged;
  {
    std::lock_guard<std::mutex> g(e->sq_mu);
    for (uint32_t i = 0; i < n; ++i) {
      const sc_raw_op &op = ops[i];
      if (op.file_index < 0 || op.file_index >= (int)kMaxFiles ||
          op.addr == nullptr) {
        rc = accepted ? (int)accepted : -EINVAL;
        stop = EINVAL;
        break;
      }
      // fault injection parity with the per-op path
      uint64_t fe = e->fault_every.load(std::memory_order_relaxed);
      uint64_t opno = e->op_counter.fetch_add(1, std::memory_order_relaxed) + 1;
      if (fe > 0 && opno % fe == 0) {
        // guard the SHARED backlog (synthetic_count), not just this call's
        // staging — parity with the per-op path's queue_depth cap
        if (staged.size() +
                e->synthetic_count.load(std::memory_order_relaxed) >=
            e->queue_depth)
          break;
        e->ops_faulted.fetch_add(1, std::memory_order_relaxed);
        e->ops_submitted.fetch_add(1, std::memory_order_relaxed);
        e->in_flight.fetch_add(1, std::memory_order_relaxed);
        staged.push_back(sc_completion{op.tag, -EIO});
        ++accepted;
        continue;
      }
      FileEntry f;
      {
        std::lock_guard<std::mutex> fg(e->files_mu);
        if (!e->files[op.file_index].in_use) {
          rc = accepted ? (int)accepted : -EBADF;
          stop = EBADF;
          break;
        }
        f = e->files[op.file_index];
      }
      if ((op.op_flags & SC_OP_WRITE) && !f.writable) {
        // a write against a read-only registration can never succeed:
        // fail it at the submission boundary with its true errno instead
        // of an async kernel EBADF the retry machinery would chew on
        rc = accepted ? (int)accepted : -EBADF;
        stop = EBADF;
        break;
      }
      if (e->n_free == 0) break;  // queue depth reached: caller reaps + resumes
      // honor a registered-buffer index only when it names a live table
      // entry; anything else degrades to plain READ instead of an async
      // kernel EINVAL
      int64_t bi = -1;
      if (op.buf_index >= 0 && e->fixed_buffers) {
        if ((uint32_t)op.buf_index < e->num_buffers) {
          bi = op.buf_index;
        } else if (e->sparse_table &&
                   (uint32_t)op.buf_index <
                       e->num_buffers + sc_engine::kExtBufSlots) {
          std::lock_guard<std::mutex> eg(e->ext_mu);
          if (e->ext_len[op.buf_index - e->num_buffers] != 0) bi = op.buf_index;
        }
      }
      fill_sqe_locked(e, f, op.file_index, op.offset, op.length, bi, 0,
                      (uint8_t *)op.addr, op.tag,
                      (op.op_flags & SC_OP_BUFFERED) != 0,
                      (op.op_flags & SC_OP_WRITE) != 0);
      ++filled;
      ++accepted;
    }
    if (filled) {
      size_t base = staged.size();
      staged.resize(base + filled);
      EnterResult r = ring_enter_submit(e, filled, staged.data() + base);
      staged.resize(base + r.failed);
    }
  }
  if (!staged.empty()) {
    std::lock_guard<std::mutex> cg(e->cq_mu);
    e->synthetic.insert(e->synthetic.end(), staged.begin(), staged.end());
    e->synthetic_count.store((uint32_t)e->synthetic.size(),
                             std::memory_order_relaxed);
  }
  if (stop_errno) *stop_errno = stop;
  return rc != 0 ? rc : (int)accepted;
}

struct sc_vec_seg {
  int32_t file_index;
  uint32_t length;
  uint64_t offset;       // byte offset in the file
  uint64_t dest_offset;  // byte offset in dest_base
};

// The native hot loop (≙ the reference's in-kernel per-chunk submit loop +
// IRQ completion path): execute a whole gather list with
// block-size chunking, queue-depth pipelining, transparent per-chunk retry
// and aligned-EOF topup — ONE call across the Python boundary per transfer.
// Returns total bytes read, or -errno on the first unrecoverable failure
// (-ENODATA = short read: range extends past EOF).
int64_t sc_read_vectored(sc_engine *e, const sc_vec_seg *segs, uint64_t n_segs,
                         void *dest_base, uint32_t block_size,
                         uint32_t retries, int32_t dest_buf_index) {
  if (block_size == 0 || dest_base == nullptr) return -EINVAL;
  struct Chunk {
    uint64_t offset, dest_off;
    uint32_t want, attempts;
    int32_t file_index;
    bool live;       // byte range claimed from the cursor, not yet retired
    bool submitted;  // currently in flight inside the engine
    bool buffered;   // residency hybrid routed this cache-warm chunk to the
                     // buffered fd (memcpy from page cache, not media)
    bool direct;     // this chunk actually rides O_DIRECT (file capable,
                     // aligned, not hybrid-routed): counts as media_bytes
  };
  uint32_t qd = e->queue_depth;
  Chunk *pend = new Chunk[qd];
  for (uint32_t i = 0; i < qd; ++i) pend[i].live = false;
  sc_raw_op *batch = new sc_raw_op[qd];
  sc_completion *comps = new sc_completion[qd > 64 ? qd : 64];
  uint64_t si = 0, within = 0;  // cursor into segs
  uint32_t n_live = 0;          // claimed chunks not yet retired
  uint32_t n_inflight = 0;      // subset of live actually submitted
  uint64_t total = 0;
  int64_t err = 0;

  // Residency snapshot (hybrid): EVERY segment is probed upfront, before any
  // read is submitted. Probing lazily at claim time lets the warm chunks'
  // buffered reads trigger kernel readahead that warms ranges AHEAD of the
  // cursor, cascading the whole gather onto the page-cache path — the cold
  // tail must stay O_DIRECT. Fully-warm and fully-cold segments (the common
  // cases) cost ONE probe syscall; mixed segments get a per-block_size-chunk
  // bitmap. seg_state: 0 direct (cold / hybrid off / unprobeable / file not
  // O_DIRECT), 1 buffered (warm), 2 consult seg_chunk_warm bitmap.
  std::vector<uint8_t> seg_state(n_segs, 0);
  std::vector<std::vector<uint8_t>> seg_chunk_warm(n_segs);
  // per-seg file meta, always collected: the cached/media counters must only
  // account bytes whose route is KNOWN (O_DIRECT-capable file, aligned
  // chunk) — a --buffered run or an unaligned fallback is neither cache-warm
  // service nor a media read, matching the Python engine's accounting
  std::vector<uint8_t> seg_odirect(n_segs, 0);
  std::vector<uint32_t> seg_oa(n_segs, 1), seg_ma(n_segs, 1);
  {
    std::vector<int> seg_fdb(n_segs, -1);
    int last_fi = -2, fdb = -1;
    bool od = false;
    uint32_t oa = 1, ma = 1;
    for (uint64_t i = 0; i < n_segs; ++i) {
      const sc_vec_seg &s = segs[i];
      if (s.file_index != last_fi) {
        last_fi = s.file_index;
        fdb = -1;
        od = false;
        oa = ma = 1;
        std::lock_guard<std::mutex> fg(e->files_mu);
        if (s.file_index >= 0 && s.file_index < (int)kMaxFiles &&
            e->files[s.file_index].in_use) {
          fdb = e->files[s.file_index].fd_buffered;
          od = e->files[s.file_index].o_direct;
          oa = e->files[s.file_index].offset_align;
          ma = e->files[s.file_index].mem_align;
        }
      }
      seg_odirect[i] = od ? 1 : 0;
      seg_oa[i] = oa ? oa : 1;
      seg_ma[i] = ma ? ma : 1;
      seg_fdb[i] = (e->residency_hybrid && od && s.length > 0) ? fdb : -1;
    }
    // Per-seg probe with mixed-range bitmap, probed in GROUPS so the probe
    // count stays bounded regardless of segment size (per-block_size
    // probing of a multi-GiB half-warm segment is ~8k syscalls/GiB — and
    // mmap/munmap pairs in mincore mode). At most
    // kMaxResidencyProbes groups per segment; a group is routed warm only
    // when FULLY resident, so coarser probing can only send warm bytes to
    // media (correct either way), never cold bytes to the cache path.
    auto probe_seg = [&](uint64_t i) {
      const sc_vec_seg &s = segs[i];
      uint64_t probes = 1;
      uint64_t tot = 0;
      int64_t res = resident_pages(seg_fdb[i], s.offset, s.length, &tot);
      if (res <= 0 || (uint64_t)res >= tot) {
        e->residency_probes.fetch_add(probes, std::memory_order_relaxed);
        if (res > 0) seg_state[i] = 1;  // fully warm; else cold/unprobeable
        return;
      }
      constexpr uint64_t kMaxResidencyProbes = 256;
      uint64_t nch = (s.length + block_size - 1) / block_size;
      uint64_t group = (nch + kMaxResidencyProbes - 1) / kMaxResidencyProbes;
      std::vector<uint8_t> &bm = seg_chunk_warm[i];
      bm.assign(nch, 0);
      for (uint64_t g0 = 0; g0 < nch; g0 += group) {
        uint64_t coff = s.offset + g0 * block_size;
        uint64_t remain = s.length - g0 * block_size;
        uint64_t glen = group * block_size;
        if (glen > remain) glen = remain;
        uint64_t t2 = 0;
        ++probes;
        int64_t r2 = resident_pages(seg_fdb[i], coff, glen, &t2);
        uint8_t warm = (r2 >= 0 && (uint64_t)r2 >= t2) ? 1 : 0;
        uint64_t gend = g0 + group < nch ? g0 + group : nch;
        for (uint64_t ci = g0; ci < gend; ++ci) bm[ci] = warm;
      }
      e->residency_probes.fetch_add(probes, std::memory_order_relaxed);
      seg_state[i] = 2;
    };
    // Probe coalescing: segs that are file-contiguous (a striped gather's
    // member chunks — member offsets run contiguously whatever the
    // submission order — or a coalesced extent list's split pieces) share
    // ONE probe over the whole run: a fully-warm or fully-cold verdict
    // applies to every seg in it, and only a mixed run pays per-seg probes.
    // Runs are found over a (file, offset)-sorted view so the striped
    // overlap-window submission order doesn't fragment them: a 4-member
    // striped gather drops from one probe per raid_chunk (~2k mmap+mincore
    // pairs per GiB) to one per member — the same probe shape as the raw
    // member read it is benchmarked against.
    std::vector<uint64_t> by_off;
    by_off.reserve(n_segs);
    for (uint64_t i = 0; i < n_segs; ++i)
      if (seg_fdb[i] >= 0) by_off.push_back(i);
    std::sort(by_off.begin(), by_off.end(), [&](uint64_t a, uint64_t b) {
      if (segs[a].file_index != segs[b].file_index)
        return segs[a].file_index < segs[b].file_index;
      return segs[a].offset < segs[b].offset;
    });
    for (size_t i = 0; i < by_off.size();) {
      size_t j = i + 1;
      uint64_t run_end = segs[by_off[i]].offset + segs[by_off[i]].length;
      while (j < by_off.size() &&
             segs[by_off[j]].file_index == segs[by_off[i]].file_index &&
             segs[by_off[j]].offset == run_end) {
        run_end += segs[by_off[j]].length;
        ++j;
      }
      if (j == i + 1) {
        probe_seg(by_off[i]);
        i = j;
        continue;
      }
      uint64_t tot = 0;
      int64_t res = resident_pages(seg_fdb[by_off[i]], segs[by_off[i]].offset,
                                   run_end - segs[by_off[i]].offset, &tot);
      e->residency_probes.fetch_add(1, std::memory_order_relaxed);
      if (res > 0 && (uint64_t)res >= tot) {
        for (size_t k = i; k < j; ++k) seg_state[by_off[k]] = 1;  // all warm
      } else if (res > 0) {
        // mixed run: fall back to per-seg probing (bounded groups within)
        for (size_t k = i; k < j; ++k) probe_seg(by_off[k]);
      }  // res <= 0: cold or unprobeable — every seg stays on the
         // O_DIRECT path, exactly what per-seg probing would conclude
      i = j;
    }
  }

  auto next_chunk = [&](Chunk &c) -> bool {
    while (si < n_segs && within >= segs[si].length) {
      ++si;
      within = 0;
    }
    if (si >= n_segs) return false;
    const sc_vec_seg &s = segs[si];
    // fully-WARM segments chunk 16x coarser: a buffered read of resident
    // pages is a memcpy, so per-op overhead (SQE fill, completion, slot
    // churn) dominates at media-tuned block sizes — fewer, larger ops move
    // the same bytes with less CPU. Mixed segments keep block_size (the
    // residency bitmap's granularity); cold segments keep the media tuning.
    uint32_t eff_block = block_size;
    if (!seg_state.empty() && seg_state[si] == 1) {
      uint64_t coarse = (uint64_t)block_size * 16;
      if (coarse > (64u << 20)) coarse = 64u << 20;  // and never u32 overflow
      if (coarse > block_size) eff_block = (uint32_t)coarse;
    }
    uint32_t take = s.length - within < eff_block
                        ? (uint32_t)(s.length - within)
                        : eff_block;
    c.offset = s.offset + within;
    c.dest_off = s.dest_offset + within;
    c.want = take;
    c.attempts = 0;
    c.file_index = s.file_index;
    c.live = true;
    c.submitted = false;
    uint8_t st = seg_state[si];
    bool aligned = c.offset % seg_oa[si] == 0 && take % seg_oa[si] == 0 &&
                   ((uintptr_t)dest_base + c.dest_off) % seg_ma[si] == 0;
    // hybrid routing only for aligned chunks, matching the Python engine:
    // unaligned chunks keep their existing fallback route (and its
    // unaligned_fallback accounting) whether warm or not
    c.buffered = aligned &&
                 (st == 1 ||
                  (st == 2 && seg_chunk_warm[si][within / block_size] != 0));
    c.direct = !c.buffered && aligned && seg_odirect[si] != 0;
    within += take;
    return true;
  };

  bool exhausted = false;
  while (!exhausted || n_live > 0) {
    // fill: requeue any live-but-unsubmitted chunks first (a previous batch
    // the engine only partially accepted — shared-ring backpressure), then
    // claim new chunks from the cursor. A partially-accepted batch must NOT
    // drop its tail: those byte ranges would silently never be read.
    uint32_t k = 0;
    for (uint32_t slot = 0; slot < qd; ++slot) {
      if (pend[slot].live && !pend[slot].submitted) {
        batch[k].file_index = pend[slot].file_index;
        batch[k].length = pend[slot].want;
        batch[k].offset = pend[slot].offset;
        batch[k].tag = slot;
        batch[k].addr = (uint8_t *)dest_base + pend[slot].dest_off;
        batch[k].buf_index = dest_buf_index;
        batch[k].op_flags = pend[slot].buffered ? SC_OP_BUFFERED : 0;
        ++k;
      }
    }
    while (!exhausted) {
      uint32_t slot = 0;  // each batch entry owns a distinct slot, so k <= qd
      while (slot < qd && pend[slot].live) ++slot;
      if (slot >= qd) break;
      if (!next_chunk(pend[slot])) {
        exhausted = true;
        break;
      }
      ++n_live;
      batch[k].file_index = pend[slot].file_index;
      batch[k].length = pend[slot].want;
      batch[k].offset = pend[slot].offset;
      batch[k].tag = slot;
      batch[k].addr = (uint8_t *)dest_base + pend[slot].dest_off;
      batch[k].buf_index = dest_buf_index;
      batch[k].op_flags = pend[slot].buffered ? SC_OP_BUFFERED : 0;
      ++k;
    }
    if (k > 0) {
      int acc = sc_submit_raw_batch(e, batch, k, nullptr);
      if (acc < 0) {
        err = acc;
        // un-claim everything in this batch; nothing of it was accepted
        for (uint32_t i = 0; i < k; ++i) {
          pend[batch[i].tag].live = false;
          --n_live;
        }
        break;
      }
      // first `acc` ops are in flight; the tail stays live+unsubmitted and
      // is resubmitted on the next loop iteration
      for (int i = 0; i < acc; ++i) pend[batch[i].tag].submitted = true;
      for (int i = acc; i < (int)k; ++i) pend[batch[i].tag].submitted = false;
      n_inflight += (uint32_t)acc;
    }
    if (n_live == 0) {
      if (exhausted) break;
      continue;
    }
    // If nothing of ours is in flight (another submitter owns the whole
    // queue depth), poll with a bounded wait so we retry submission instead
    // of blocking forever on completions that may all be foreign.
    int got = sc_wait(e, comps, qd > 64 ? qd : 64, 1, n_inflight > 0 ? -1 : 10);
    if (got < 0) {
      err = got;
      break;
    }
    for (int i = 0; i < got; ++i) {
      uint64_t slot = comps[i].tag;
      if (slot >= qd || !pend[slot].live || !pend[slot].submitted)
        continue;  // foreign tag: dropped
      Chunk &c = pend[slot];
      if (comps[i].res < 0) {
        if (c.attempts < retries) {
          ++c.attempts;
          e->chunk_retries.fetch_add(1, std::memory_order_relaxed);
          sc_raw_op rop{c.file_index, c.want, c.offset, slot,
                        (uint8_t *)dest_base + c.dest_off, dest_buf_index,
                        c.buffered ? SC_OP_BUFFERED : 0};
          int acc = sc_submit_raw_batch(e, &rop, 1, nullptr);
          if (acc == 1) continue;  // still in flight
          if (acc < 0) {
            err = acc;
            c.live = false;
            --n_live;
            --n_inflight;
          } else {
            // backpressure: requeue through the fill phase
            c.submitted = false;
            --n_inflight;
          }
        } else {
          if (err == 0) err = comps[i].res;
          c.live = false;
          --n_live;
          --n_inflight;
        }
      } else if ((uint32_t)comps[i].res < c.want) {
        if (err == 0) err = -ENODATA;  // short read: past EOF
        total += (uint64_t)comps[i].res;
        if (c.buffered)
          e->cached_bytes.fetch_add((uint64_t)comps[i].res,
                                    std::memory_order_relaxed);
        else if (c.direct)
          e->media_bytes.fetch_add((uint64_t)comps[i].res,
                                   std::memory_order_relaxed);
        c.live = false;
        --n_live;
        --n_inflight;
      } else {
        total += (uint64_t)comps[i].res;
        if (c.buffered)
          e->cached_bytes.fetch_add((uint64_t)comps[i].res,
                                    std::memory_order_relaxed);
        else if (c.direct)
          e->media_bytes.fetch_add((uint64_t)comps[i].res,
                                   std::memory_order_relaxed);
        c.live = false;
        --n_live;
        --n_inflight;
      }
    }
    if (err != 0) break;
  }
  // drain whatever is still in flight so the shared engine stays clean
  while (n_inflight > 0) {
    int got = sc_wait(e, comps, qd > 64 ? qd : 64, 1, 30000);
    if (got <= 0) break;
    for (int i = 0; i < got; ++i) {
      uint64_t slot = comps[i].tag;
      if (slot < qd && pend[slot].live && pend[slot].submitted) {
        pend[slot].live = false;
        --n_inflight;
      }
    }
  }
  delete[] pend;
  delete[] batch;
  delete[] comps;
  return err != 0 ? err : (int64_t)total;
}

// Register a caller-owned slab in an external registered-buffer slot so the
// vectored gather can ride READ_FIXED into it. Returns the TABLE index to
// pass as dest_buf_index (>= num_buffers), or -errno. The memory must stay
// mapped until sc_unregister_dest (or engine destruction — the ring's
// registration dies with it, but the kernel holds page pins until then).
int sc_register_dest(sc_engine *e, void *addr, uint64_t len) {
  if (addr == nullptr || len == 0) return -EINVAL;
  if (!e->sparse_table) return -EOPNOTSUPP;
  std::lock_guard<std::mutex> g(e->ext_mu);
  for (uint32_t i = 0; i < sc_engine::kExtBufSlots; ++i) {
    if (e->ext_len[i] != 0) continue;
    struct iovec iov;
    iov.iov_base = addr;
    iov.iov_len = len;
    struct sc_rsrc_update2 up;
    memset(&up, 0, sizeof(up));
    up.offset = e->num_buffers + i;
    up.data = (uint64_t)(uintptr_t)&iov;
    up.nr = 1;
    int rc = sys_io_uring_register(e->ring_fd, kRegisterBuffersUpdate,
                                   &up, sizeof(up));
    if (rc < 0) return -errno;
    e->ext_len[i] = len;
    return (int)(e->num_buffers + i);
  }
  return -ENOSPC;
}

int sc_unregister_dest(sc_engine *e, int index) {
  if (!e->sparse_table) return -EOPNOTSUPP;
  uint32_t i = (uint32_t)index - e->num_buffers;
  if (index < (int)e->num_buffers || i >= sc_engine::kExtBufSlots)
    return -EINVAL;
  std::lock_guard<std::mutex> g(e->ext_mu);
  if (e->ext_len[i] == 0) return -ENOENT;
  struct iovec iov;
  iov.iov_base = nullptr;  // empty iovec clears the slot
  iov.iov_len = 0;
  struct sc_rsrc_update2 up;
  memset(&up, 0, sizeof(up));
  up.offset = (uint32_t)index;
  up.data = (uint64_t)(uintptr_t)&iov;
  up.nr = 1;
  int rc = sys_io_uring_register(e->ring_fd, IORING_REGISTER_BUFFERS_UPDATE,
                                 &up, sizeof(up));
  if (rc < 0) return -errno;
  e->ext_len[i] = 0;
  return 0;
}

void sc_get_stats(sc_engine *e, sc_stats *s) {
  memset(s, 0, sizeof(*s));
  s->ops_submitted = e->ops_submitted.load(std::memory_order_relaxed);
  s->ops_completed = e->ops_completed.load(std::memory_order_relaxed);
  s->ops_errored = e->ops_errored.load(std::memory_order_relaxed);
  s->ops_faulted = e->ops_faulted.load(std::memory_order_relaxed);
  s->bytes_read = e->bytes_read.load(std::memory_order_relaxed);
  s->unaligned_fallback_reads =
      e->unaligned_fallback.load(std::memory_order_relaxed);
  s->eof_topup_reads = e->eof_topup.load(std::memory_order_relaxed);
  s->lat_count = e->lat_count.load(std::memory_order_relaxed);
  s->lat_total_us = e->lat_total_us.load(std::memory_order_relaxed);
  for (int i = 0; i < kHistBuckets; ++i)
    s->lat_hist[i] = e->lat_hist[i].load(std::memory_order_relaxed);
  s->in_flight = e->in_flight.load(std::memory_order_relaxed);
  s->fixed_buffers = e->fixed_buffers ? 1 : 0;
  s->fixed_files = e->fixed_files ? 1 : 0;
  s->mlocked = e->mlocked ? 1 : 0;
  s->chunk_retries = e->chunk_retries.load(std::memory_order_relaxed);
  s->coop_taskrun = e->coop_taskrun ? 1 : 0;
  s->sqpoll = e->sqpoll ? 1 : 0;
  s->sparse_table = e->sparse_table ? 1 : 0;
  s->ops_fixed = e->ops_fixed.load(std::memory_order_relaxed);
  uint32_t ext = 0;
  {
    std::lock_guard<std::mutex> g(e->ext_mu);
    for (uint32_t i = 0; i < sc_engine::kExtBufSlots; ++i)
      if (e->ext_len[i] != 0) ++ext;
  }
  s->ext_buffers = ext;
  s->sqpoll_wakeup_errno =
      e->sqpoll_wakeup_errno.load(std::memory_order_relaxed);
  s->cached_bytes = e->cached_bytes.load(std::memory_order_relaxed);
  s->media_bytes = e->media_bytes.load(std::memory_order_relaxed);
  s->residency_probes = e->residency_probes.load(std::memory_order_relaxed);
  s->ops_written = e->ops_written.load(std::memory_order_relaxed);
  s->bytes_written = e->bytes_written.load(std::memory_order_relaxed);
  s->enter_submit_calls =
      e->enter_submit_calls.load(std::memory_order_relaxed);
  s->sqpoll_wakeups = e->sqpoll_wakeups.load(std::memory_order_relaxed);
}

}  // extern "C"

// ------------------------------------------------------------- JPEG decode
// Direct libjpeg-turbo bindings: one C call decodes a JPEG straight into a
// caller buffer — none of cv2's per-call Mat setup,
// no BGR intermediate (libjpeg emits RGB natively), and access to the
// turbo-only partial-decode API so a RandomResizedCrop can decode ONLY the
// crop's scanlines (jpeg_skip_scanlines) and iMCU columns
// (jpeg_crop_scanline). The GIL is released for the whole call via ctypes,
// so the decode pool's threads scale exactly like the cv2 path did.

#ifdef STROM_HAVE_JPEG
namespace {

struct sc_jpeg_err {
  struct jpeg_error_mgr pub;
  jmp_buf jb;
};

void sc_jpeg_error_exit(j_common_ptr cinfo) {
  sc_jpeg_err *e = reinterpret_cast<sc_jpeg_err *>(cinfo->err);
  longjmp(e->jb, 1);
}

// corrupt-but-recoverable data (truncated entropy segment, bad restart
// marker) emits warnings through these; the decode pool's per-sample
// failure policy owns error reporting — a library printing to the
// consumer's stderr from 8 worker threads is not observability
void sc_jpeg_silence(j_common_ptr, int) {}
void sc_jpeg_no_output(j_common_ptr) {}

}  // namespace
#endif  // STROM_HAVE_JPEG

extern "C" {

int sc_jpeg_available(void) {
#ifdef STROM_HAVE_JPEG
  return 1;
#else
  return 0;
#endif
}

// Decode JPEG bytes [src, src+len) to packed RGB8 rows at *out* (row stride
// out_stride bytes; <= 0 packs rows contiguously at the decoded width).
// reduced in {1,2,4,8} maps to libjpeg's scale_denom (the IDCT does 1/d of
// the work). With roi_h > 0, only scanlines [roi_y, roi_y+roi_h) of the
// SCALED image are decoded, horizontally cropped to the iMCU-aligned
// superset of [roi_x, roi_x+roi_w) that jpeg_crop_scanline grants
// (x0 <= roi_x, width >= roi_w); rows land from *out* upward and the
// granted geometry is returned in got[] = {rows, cols, x0, y0}. Without an
// ROI, got[] carries the full scaled dims {oh, ow, 0, 0}. Progressive
// sources reject an ROI with -EOPNOTSUPP: the partial-scanline API
// silently produces wrong pixels on multi-scan files, so the caller must
// route those to a full decode (strom_torch/formats/jpeg.py does, off the
// SOF2 flag). Returns 0 on success; decode failures are -EIO, capacity
// mismatches -ERANGE, bad arguments -EINVAL, jpeg-less builds -ENOSYS.
int sc_jpeg_decode(const uint8_t *src, uint64_t len, uint8_t *out,
                   uint64_t out_cap, int64_t out_stride, int32_t reduced,
                   int32_t roi_y, int32_t roi_x, int32_t roi_h,
                   int32_t roi_w, int32_t got[4]) {
#ifndef STROM_HAVE_JPEG
  (void)src; (void)len; (void)out; (void)out_cap; (void)out_stride;
  (void)reduced; (void)roi_y; (void)roi_x; (void)roi_h; (void)roi_w;
  (void)got;
  return -ENOSYS;
#else
  if (!src || !out || !got || len < 4) return -EINVAL;
  if (reduced != 1 && reduced != 2 && reduced != 4 && reduced != 8)
    return -EINVAL;
  struct jpeg_decompress_struct cinfo;
  sc_jpeg_err jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = sc_jpeg_error_exit;
  jerr.pub.emit_message = sc_jpeg_silence;
  jerr.pub.output_message = sc_jpeg_no_output;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -EIO;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char *>(src),
               (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -EIO;
  }
  if (roi_h > 0 && cinfo.progressive_mode) {
    jpeg_destroy_decompress(&cinfo);
    return -EOPNOTSUPP;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = (unsigned)reduced;
  jpeg_start_decompress(&cinfo);
  JDIMENSION oh = cinfo.output_height, ow = cinfo.output_width;
  JDIMENSION x0 = 0, gw = ow, y0 = 0, gh = oh;
  if (roi_h > 0) {
    if (roi_y < 0 || roi_x < 0 || roi_w <= 0 ||
        (uint64_t)roi_y + (uint64_t)roi_h > oh ||
        (uint64_t)roi_x + (uint64_t)roi_w > ow) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return -EINVAL;
    }
    x0 = (JDIMENSION)roi_x;
    gw = (JDIMENSION)roi_w;
    jpeg_crop_scanline(&cinfo, &x0, &gw);
    y0 = (JDIMENSION)roi_y;
    gh = (JDIMENSION)roi_h;
    if (y0 != 0 && jpeg_skip_scanlines(&cinfo, y0) != y0) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return -EIO;
    }
  }
  int64_t stride = out_stride > 0 ? out_stride : (int64_t)gw * 3;
  if (stride < (int64_t)gw * 3 ||
      (uint64_t)stride * (gh > 0 ? gh - 1 : 0) + (uint64_t)gw * 3 >
          out_cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -ERANGE;
  }
  while (cinfo.output_scanline < y0 + gh) {
    JSAMPROW row = out + (int64_t)(cinfo.output_scanline - y0) * stride;
    if (jpeg_read_scanlines(&cinfo, &row, 1) != 1) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return -EIO;
    }
  }
  // a partial read (ROI) must not run the full-consumption epilogue:
  // abort discards the remaining entropy data without decoding it
  if (cinfo.output_scanline < cinfo.output_height)
    jpeg_abort_decompress(&cinfo);
  else
    jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  got[0] = (int32_t)gh;
  got[1] = (int32_t)gw;
  got[2] = (int32_t)x0;
  got[3] = (int32_t)y0;
  return 0;
#endif  // STROM_HAVE_JPEG
}

}  // extern "C"
