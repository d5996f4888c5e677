/* libshadow_shim.so — the managed-process side of phase 4.
 *
 * Reference analog: the LD_PRELOAD shim + seccomp SIGSYS trap of
 * SURVEY.md §2 "Shim" / §3.2-3.3, re-designed around a deliberately DUMB
 * shim: it knows nothing about syscall semantics. Every trapped syscall is
 * forwarded verbatim ({nr, args[6]}) over a fixed-fd socketpair to the
 * Python worker, which owns all emulation state and reads/writes this
 * process's memory directly via process_vm_readv/writev (the MemoryManager
 * equivalent, shadow_tpu/native/memory.py). Strict turn-taking falls out
 * of the blocking request/reply protocol: exactly one of {worker, managed
 * thread} runs at a time.
 *
 * v1 interposition set (documented in shadow_tpu/native/managed.py): the
 * seccomp filter TRAPS the simulation-relevant syscalls (time, sleep,
 * sockets, stdio writes, virtual fds, getrandom) and ALLOWS everything
 * else natively (memory management, dynamic linking, real file IO below
 * the virtual-fd base). This is inverted from upstream Shadow's trap-all
 * stance — chosen so unknown syscalls degrade to native behavior instead
 * of crashing — and is tightened per-family as emulation coverage grows.
 *
 * Time has a fast path: the worker maintains an mmap'd page holding the
 * emulated clock (ns since the UNIX epoch), updated before every turn
 * grant; interposed clock_gettime/gettimeofday/time read it without a
 * context switch (and without the vDSO, which seccomp cannot intercept).
 *
 * Wire protocol (host byte order, x86-64):
 *   request : uint64 nr; uint64 args[6];          (56 bytes)
 *   response: int64 ret;                          (8 bytes, -errno on error)
 *   handshake: request with nr = SHIM_HELLO, arg0 = getpid()
 */
#define _GNU_SOURCE
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <linux/audit.h>
#include <linux/filter.h>
#include <linux/seccomp.h>
#include <pthread.h>
#include <signal.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <stddef.h>
#include <stdio.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/prctl.h>
#include <sys/syscall.h>
#include <time.h>
#include <ucontext.h>

/* pre-5.9 glibc headers lack the close_range number; it is ABI-stable */
#ifndef SYS_close_range
#define SYS_close_range 436
#endif
#include <unistd.h>

#define SHIM_IPC_FD 995          /* worker dup2()s the socketpair here   */
#define SHIM_IPC_LOW 932         /* per-thread channels live in [LOW, 995] */
#define SHIM_VFD_BASE 0x100000   /* fds >= this are simulated sockets    */
#define SHIM_HELLO 0xFFFFFFFFu
/* thread-management pseudo-syscalls (worker analogs in native/managed.py) */
#define SHIM_SPAWN_THREAD 0xFFFFFFF0u
#define SHIM_THREAD_HELLO 0xFFFFFFF1u
#define SHIM_THREAD_JOIN 0xFFFFFFF2u
#define SHIM_THREAD_EXIT 0xFFFFFFF3u
#define SHIM_FORK_INTENT 0xFFFFFFF4u
#define SHIM_FORK_COMMIT 0xFFFFFFF5u
#define SHIM_RESOLVE 0xFFFFFFF6u /* arg0 = name ptr -> IPv4 as host u32 */
#define SHIM_AUDIT_NOTE 0xFFFFFFF7u /* arg0 = first-use unemulated nr */
/* worker reply sentinel: "re-issue this syscall natively through the
 * gadget" — the virtual-FS passthrough for paths the worker does not
 * virtualize (outside the errno range, so unambiguous) */
#define SHIM_RET_NATIVE (-1000000)

struct shim_req { uint64_t nr; uint64_t args[6]; };

static volatile int64_t *shim_time_page; /* [0] emulated ns since UNIX
  epoch; [1] this process's virtual pid (identity fast path — INVALID in
  forked children, which share the parent's page; see shim_is_fork) */
static int shim_is_fork; /* set in the child after the fork replay */
static int shim_active;
static long shim_real_pid, shim_real_tid; /* cached pre-seccomp: the trapped
                                             getpid/gettid return vpids */
/* each guest thread talks to the worker over its own channel (strict
 * turn-taking needs per-thread wakeups); main uses the spawn-time fd */
static __thread int shim_tls_fd = SHIM_IPC_FD;
/* a freshly cloned thread runs glibc bootstrap (set_robust_list, rseq)
 * BEFORE the shim trampoline pins its own channel; until then it must not
 * write on the (main thread's) default channel */
static __thread int shim_tls_ready;

/* ---- the syscall gadget -------------------------------------------------
 *
 * Audit mode (SHADOW_AUDIT=1, experimental.native_audit) inverts the trap
 * policy: the seccomp filter ALLOWS syscalls only when the reported
 * instruction pointer lies inside one fixed executable page — the shim's
 * syscall gadget — and TRAPS everything the guest issues itself, so every
 * natively-passed syscall number is observed and counted exactly once
 * (VERDICT r2 item #5: instrument the reality boundary). The page sits at
 * a fixed address so the BPF constants are
 * compile-time; it holds one stub translating the function-call ABI to
 * the syscall ABI:  gadget(nr, a1..a6) -> syscall(nr, a1..a6).
 * Outside audit mode the gadget is still used (one indirect call per raw
 * syscall) but the filter never consults the IP.
 *
 * COOPERATIVE-GUEST ASSUMPTION: the gadget page's address is fixed and
 * both filters ALLOW any syscall issued from it, so code that KNOWS the
 * address can jump there directly and bypass every trap. Audit mode's
 * "every native passthrough is observed" guarantee therefore holds for
 * guests that go through libc/the vDSO (everything we run), not for
 * adversarial code hunting the gadget. Upstream Shadow's shim has the
 * same property (its shim text is at a knowable address and its filter
 * must allow the shim's own raw syscalls); a simulator is not a sandbox.
 * Randomizing the page per process (and passing the address into the
 * BPF at install time) would narrow this to guessing, at the cost of a
 * filter rebuild per process — documented, deliberately not done. */
#define SHIM_GADGET_ADDR ((void *)0x5D5E00000000ul)
typedef long (*shim_gadget_fn)(long, long, long, long, long, long, long);
static shim_gadget_fn shim_gadget; /* == SHIM_GADGET_ADDR once mapped */
static int shim_audit_on;
static uint8_t shim_audit_seen[64]; /* nrs already reported (once each) */

/* raw syscalls only — the shim must not recurse through libc wrappers */
static long raw3(long nr, long a, long b, long c) {
  long ret;
  if (shim_gadget) return shim_gadget(nr, a, b, c, 0, 0, 0);
  __asm__ volatile("syscall"
                   : "=a"(ret)
                   : "a"(nr), "D"(a), "S"(b), "d"(c)
                   : "rcx", "r11", "memory");
  return ret;
}

static long raw5(long nr, long a, long b, long c, long d, long e) {
  long ret;
  if (shim_gadget) return shim_gadget(nr, a, b, c, d, e, 0);
  register long r10 __asm__("r10") = d;
  register long r8 __asm__("r8") = e;
  __asm__ volatile("syscall"
                   : "=a"(ret)
                   : "a"(nr), "D"(a), "S"(b), "d"(c), "r"(r10), "r"(r8)
                   : "rcx", "r11", "memory");
  return ret;
}

/* mov rax,rdi; mov rdi,rsi; mov rsi,rdx; mov rdx,rcx; mov r10,r8;
 * mov r8,r9; mov r9,[rsp+8]; syscall; ret */
static const uint8_t shim_gadget_stub[] = {
    0x48, 0x89, 0xf8, 0x48, 0x89, 0xf7, 0x48, 0x89, 0xd6,
    0x48, 0x89, 0xca, 0x4d, 0x89, 0xc2, 0x4d, 0x89, 0xc8,
    0x4c, 0x8b, 0x4c, 0x24, 0x08, 0x0f, 0x05, 0xc3};

/* 6-arg inline-asm fallback for the rare no-gadget case (sentinel
 * re-issues must still work; the filters allow these nrs by default when
 * no gadget page could be mapped — non-audit mode only) */
static long raw6_asm(long nr, long a, long b, long c, long d, long e,
                     long f) {
  long ret;
  register long r10 __asm__("r10") = d;
  register long r8 __asm__("r8") = e;
  register long r9 __asm__("r9") = f;
  __asm__ volatile("syscall"
                   : "=a"(ret)
                   : "a"(nr), "D"(a), "S"(b), "d"(c), "r"(r10), "r"(r8),
                     "r"(r9)
                   : "rcx", "r11", "memory");
  return ret;
}

static int shim_map_gadget(void) {
  void *page = mmap(SHIM_GADGET_ADDR, 4096, PROT_READ | PROT_WRITE,
                    MAP_PRIVATE | MAP_ANONYMOUS | MAP_FIXED_NOREPLACE, -1, 0);
  if (page != SHIM_GADGET_ADDR) {
    /* EEXIST: the page survived a fork (ctors do not re-run there, but a
     * dlopen-style reload could land here) — reuse it if it is ours */
    if (memcmp(SHIM_GADGET_ADDR, shim_gadget_stub,
               sizeof shim_gadget_stub) == 0) {
      shim_gadget = (shim_gadget_fn)SHIM_GADGET_ADDR;
      return 0;
    }
    return -1;
  }
  memcpy(page, shim_gadget_stub, sizeof shim_gadget_stub);
  if (mprotect(page, 4096, PROT_READ | PROT_EXEC) != 0) return -1;
  shim_gadget = (shim_gadget_fn)page;
  return 0;
}

static int write_all(const void *buf, size_t n) {
  const char *p = buf;
  while (n) {
    long r = raw3(SYS_write, shim_tls_fd, (long)p, (long)n);
    if (r < 0) { if (r == -EINTR) continue; return -1; }
    p += r; n -= (size_t)r;
  }
  return 0;
}

static int read_all(void *buf, size_t n) {
  char *p = buf;
  while (n) {
    long r = raw3(SYS_read, shim_tls_fd, (long)p, (long)n);
    if (r < 0) { if (r == -EINTR) continue; return -1; }
    if (r == 0) raw3(SYS_exit_group, 125, 0, 0); /* worker vanished */
    p += r; n -= (size_t)r;
  }
  return 0;
}

static int shim_poll_streak_reset(void); /* defined with the ring plane */

static int64_t forward(uint64_t nr, uint64_t a0, uint64_t a1, uint64_t a2,
                       uint64_t a3, uint64_t a4, uint64_t a5) {
  struct shim_req rq = {nr, {a0, a1, a2, a3, a4, a5}};
  int64_t ret = -ENOSYS;
  shim_poll_streak_reset();
  if (write_all(&rq, sizeof rq) != 0) return -EPIPE;
  if (read_all(&ret, sizeof ret) != 0) return -EPIPE;
  return ret;
}

/* receive one 8-byte reply carrying an SCM_RIGHTS fd on the caller's
 * channel; returns the fd (or -1) and stores the payload in *val_out */
static int shim_recv_fd(int64_t *val_out) {
  char cbuf[CMSG_SPACE(sizeof(int))];
  struct iovec iov = {val_out, 8};
  struct msghdr mh;
  memset(&mh, 0, sizeof mh);
  mh.msg_iov = &iov;
  mh.msg_iovlen = 1;
  mh.msg_control = cbuf;
  mh.msg_controllen = sizeof cbuf;
  long r = raw3(SYS_recvmsg, shim_tls_fd, (long)&mh, 0);
  if (r != 8) return -1;
  struct cmsghdr *c = CMSG_FIRSTHDR(&mh);
  if (!c || c->cmsg_type != SCM_RIGHTS) return -1;
  int fd;
  memcpy(&fd, CMSG_DATA(c), sizeof fd);
  return fd;
}

/* ---- shared-memory rings (native/shring.h) -----------------------------
 * The worker backs emulated pipes AND established stream sockets with a
 * memfd ring mapped here on first use (SHIM_RET_MAPRING reply +
 * SCM_RIGHTS; sockets get a pair, role 0 = RX, role 1 = TX). Non-blocking
 * reads/writes are then served entirely locally — zero worker round
 * trips; blocking edges (empty read, full/atomic-split/over-budget write,
 * EPIPE, errors) forward as before. Every in-shim SOCKET op is appended
 * to the clock page's oplog so the worker can replay the exact call
 * sequence against the simulated transport at the next fold — bit
 * determinism does not depend on the fast plane being on.
 * Strict turn-taking makes the shared state race-free. The buffer
 * pointer the guest passed is dereferenced directly (a bad pointer that
 * the kernel would EFAULT faults here instead — cooperative guests). */
#include "../shring.h"
/* The simulation boots at 2000-01-01T00:00:00Z (shadow_tpu/core/time.py
 * EMULATED_EPOCH); monotonic-family clocks originate at boot == sim
 * start (used by both the libc interposition and the raw SIGSYS path). */
#define SHIM_EMULATED_EPOCH_NS 946684800000000000LL
#define SHIM_RET_MAPRING (-1000001)
#define SHIM_RING_MAX 128

struct shim_ring_ent {
  long vfd;
  int role; /* 0 = read end, 1 = write end */
  volatile struct shring *h;
};
static struct shim_ring_ent shim_rings[SHIM_RING_MAX];

static volatile struct shring *shim_ring_find(long fd, int role) {
  for (int i = 0; i < SHIM_RING_MAX; i++)
    if (shim_rings[i].h && shim_rings[i].vfd == fd &&
        shim_rings[i].role == role)
      return shim_rings[i].h;
  return NULL;
}

static void shim_ring_unmap(int i) {
  raw3(SYS_munmap, (long)shim_rings[i].h,
       (long)(SHRING_HDR + shim_rings[i].h->cap), 0);
  shim_rings[i].h = NULL;
}

static void shim_ring_drop(long fd) {
  for (int i = 0; i < SHIM_RING_MAX; i++)
    if (shim_rings[i].h && shim_rings[i].vfd == fd) shim_ring_unmap(i);
}

static long raw6_asm(long, long, long, long, long, long, long);

static void shim_ring_install(long vfd, int role, int mfd) {
  shim_gadget_fn m = shim_gadget ? shim_gadget : raw6_asm;
  /* cap is parameterized (pipes: SHRING_CAP; sockets: the connection's
   * buffer size): learn the map size from the memfd itself */
  char st[144];
  long sz = 0;
  if (raw3(SYS_fstat, mfd, (long)st, 0) == 0)
    memcpy(&sz, st + 48, sizeof sz); /* struct stat.st_size (x86_64) */
  if (sz < SHRING_HDR + SHRING_CAP_MIN ||
      sz > SHRING_HDR + (long)SHRING_CAP_MAX) {
    raw3(SYS_close, mfd, 0, 0);
    return;
  }
  long p = m(9 /* mmap */, 0, sz, 3 /* RW */, 1 /* SHARED */, mfd, 0);
  raw3(SYS_close, mfd, 0, 0);
  if (p <= 0) return;
  volatile struct shring *h = (volatile struct shring *)p;
  uint32_t cap = h->cap;
  if (h->magic != SHRING_MAGIC || cap < SHRING_CAP_MIN ||
      cap > SHRING_CAP_MAX || (cap & (cap - 1)) != 0 ||
      (long)cap + SHRING_HDR != sz) {
    raw3(SYS_munmap, p, sz, 0);
    return;
  }
  int slot = -1;
  for (int i = 0; i < SHIM_RING_MAX; i++) {
    if (shim_rings[i].h && shim_rings[i].vfd == vfd &&
        shim_rings[i].role == role) {
      /* post-fork/duplicate re-offer: replace the inherited mapping */
      shim_ring_unmap(i);
      slot = i;
      break;
    }
    if (!shim_rings[i].h && slot < 0) slot = i;
  }
  if (slot < 0) { raw3(SYS_munmap, p, sz, 0); return; } /* full */
  shim_rings[slot].vfd = vfd;
  shim_rings[slot].role = role;
  shim_rings[slot].h = h;
}

static int shim_page_rw; /* the clock page mapped writable (counter slot) */

/* worker-granted master switch for the poll/time/socket fast paths
 * (0 under strace, syscall-latency modeling, SHADOW_TPU_SHIM_FASTPATH=0) */
static int shim_page_fast(void) {
  return shim_page_rw &&
         ((uint64_t)shim_time_page[SHIM_PAGE_FLAGS] & SHIM_PAGE_F_FAST);
}

static void shim_count_class(int word) {
  if (shim_page_rw) {
    shim_time_page[SHIM_PAGE_FASTOPS]++;
    shim_time_page[word]++;
  }
}

static void shim_ring_mark(volatile struct shring *h, int cls_word) {
  h->shim_ops++;
  h->dirty = 1; /* worker's wake scan is gated on the page counter */
  shim_count_class(cls_word);
}

/* append one socket op to the clock-page oplog (replayed by the worker,
 * in order, at the next fold). 0 = log full: caller must forward. */
static int shim_oplog_append(int op, long fd, uint64_t nbytes) {
  if (!shim_page_rw) return 0;
  uint64_t cnt = (uint64_t)shim_time_page[SHIM_PAGE_OPLOG_N];
  if (cnt >= SHIM_OPLOG_MAX) return 0;
  uint64_t idx = (uint64_t)fd - SHIM_VFD_BASE;
  shim_time_page[SHIM_OPLOG_OFF / 8 + cnt] =
      (int64_t)(nbytes | ((((uint64_t)op << 24) | idx) << 32));
  shim_time_page[SHIM_PAGE_OPLOG_N] = (int64_t)(cnt + 1);
  return 1;
}

/* local service; INT64_MIN = not serviceable here, forward to worker */
static int64_t shim_ring_read(long fd, uint64_t buf, uint64_t count,
                              int peek) {
  volatile struct shring *h = shim_ring_find(fd, 0);
  /* without a writable counter slot the worker cannot observe local
   * activity (wake scans would starve parked peers): forward everything */
  if (!h || !h->fast_ok || !shim_page_rw) return INT64_MIN;
  int sock = (h->flags & SHRING_F_SOCK) != 0;
  if (sock && (shim_is_fork || (h->flags & SHRING_F_ERR) ||
               !shim_page_fast()))
    return INT64_MIN; /* fork children / error state: worker owns it */
  if (!sock && peek) return INT64_MIN; /* MSG_PEEK on a plain pipe end */
  uint64_t avail = h->wpos - h->rpos;
  if (avail == 0) {
    if (sock && (h->flags & SHRING_F_HUP)) {
      /* drained + peer closed: EOF, exactly the worker's _vfd_recv */
      shim_ring_mark(h, SHIM_PAGE_CLS_RING_R);
      return 0;
    }
    return INT64_MIN; /* EOF / park / EAGAIN: worker's call */
  }
  uint64_t k = count < avail ? count : avail;
  if (k == 0) return 0;
  uint64_t cap = h->cap;
  uint64_t off = h->rpos % cap;
  uint64_t first = cap - off;
  if (first > k) first = k;
  memcpy((void *)buf, (const void *)(SHRING_DATA(h) + off), first);
  if (k > first)
    memcpy((void *)(buf + first), (const void *)SHRING_DATA(h), k - first);
  if (!peek) {
    if (sock && !shim_oplog_append(SHIM_OP_RECV, fd, k))
      return INT64_MIN; /* oplog full: rpos untouched, worker re-serves */
    h->rpos += k;
  }
  shim_ring_mark(h, SHIM_PAGE_CLS_RING_R);
  return (int64_t)k;
}

static int64_t shim_ring_write(long fd, uint64_t buf, uint64_t count) {
  volatile struct shring *h = shim_ring_find(fd, 1);
  if (!h || !h->fast_ok || !shim_page_rw) return INT64_MIN;
  int sock = (h->flags & SHRING_F_SOCK) != 0;
  if (sock) {
    /* HUP: the worker's _vfd_send returns EPIPE on peer_closed — forward.
     * Budget: only FULL writes complete locally (partial accepts and
     * parking are the worker's call); wbudget is exact for the whole
     * turn because transport state is frozen while the guest runs. */
    if (shim_is_fork || (h->flags & (SHRING_F_ERR | SHRING_F_HUP)) ||
        !shim_page_fast())
      return INT64_MIN;
    if (count == 0) return 0;
    if (h->wbudget < count) return INT64_MIN;
  } else {
    if (h->readers == 0) return INT64_MIN; /* EPIPE + SIGPIPE: worker */
    if (count == 0) return 0;
  }
  uint64_t cap = h->cap;
  uint64_t room = cap - (h->wpos - h->rpos);
  if (room < count) return INT64_MIN; /* partial/atomic/park: worker */
  if (sock && !shim_oplog_append(SHIM_OP_SEND, fd, count))
    return INT64_MIN; /* oplog full: nothing written yet, forward */
  uint64_t off = h->wpos % cap;
  uint64_t first = cap - off;
  if (first > count) first = count;
  memcpy((void *)(SHRING_DATA(h) + off), (const void *)buf, first);
  if (count > first)
    memcpy((void *)SHRING_DATA(h), (const void *)(buf + first),
           count - first);
  h->wpos += count;
  if (sock) h->wbudget -= count;
  shim_ring_mark(h, SHIM_PAGE_CLS_RING_W);
  return (int64_t)count;
}

/* ---- in-shim poll/ppoll over live ring state + the readiness page ------
 *
 * Mirrors the worker's _revents EXACTLY or forwards. Per entry:
 *   - ring-backed fds (a mapping exists for the needed role) use live
 *     ring state — the page bytes would be stale for fds the shim itself
 *     mutates between round trips;
 *   - everything else needs a VALID readiness byte (published by the
 *     worker on every service reply for watched, non-ring-backed vfds).
 * Any entry it cannot evaluate forwards the WHOLE call. Only a ready
 * result (n > 0) or a zero-timeout zero-ready result completes locally;
 * a would-block poll with a real timeout must park at the worker. */
#define SHIM_POLLIN 0x001
#define SHIM_POLLOUT 0x004
#define SHIM_POLLERR 0x008
#define SHIM_POLLHUP 0x010

/* consecutive in-shim polls without any worker round trip; forward after
 * a bound so a guest spinning on poll() still reaches the worker's spin
 * detector (reset inside forward()) */
static int shim_poll_streak;

static int shim_poll_streak_reset(void) {
  shim_poll_streak = 0;
  return 0;
}

static int64_t shim_poll_local(uint64_t fds_ptr, uint64_t nfds,
                               uint64_t t_arg, int is_ppoll) {
  if (shim_is_fork || !shim_page_fast() || nfds > 64 ||
      (nfds && !fds_ptr))
    return INT64_MIN;
  if (++shim_poll_streak > 1000) return INT64_MIN;
  int zero_timeout;
  if (is_ppoll) { /* timespec*; NULL = infinite; sigmask is ignored by
                     the worker twin, so it is ignored here too */
    if (t_arg == 0) {
      zero_timeout = 0;
    } else {
      int64_t sec, nsec;
      memcpy(&sec, (const void *)t_arg, 8);
      memcpy(&nsec, (const void *)(t_arg + 8), 8);
      zero_timeout = (sec == 0 && nsec == 0);
    }
  } else { /* poll: signed ms, negative = infinite */
    zero_timeout = ((int)t_arg == 0);
  }
  int16_t revs[64];
  int n = 0;
  for (uint64_t i = 0; i < nfds; i++) {
    int32_t fd;
    int16_t want;
    memcpy(&fd, (const void *)(fds_ptr + 8 * i), 4);
    memcpy(&want, (const void *)(fds_ptr + 8 * i + 4), 2);
    if (fd < 0) { revs[i] = 0; continue; } /* poll(2): ignored entry */
    volatile struct shring *h0 = shim_ring_find(fd, 0);
    volatile struct shring *h1 = shim_ring_find(fd, 1);
    int16_t r = 0;
    if (h0 || h1) {
      if ((h0 && !h0->fast_ok) || (h1 && !h1->fast_ok)) return INT64_MIN;
      uint32_t fl = h0 ? h0->flags : h1->flags;
      if (fl & SHRING_F_SOCK) {
        if (fl & SHRING_F_ERR) return INT64_MIN; /* POLLERR: worker */
        int hup = (fl & SHRING_F_HUP) != 0;
        /* _readable: rxbuf or peer_closed; _writable: budget, never
         * when peer closed (connect_err stays 0 while fast_ok holds) */
        if ((want & SHIM_POLLIN) &&
            (hup || (h0 && h0->wpos - h0->rpos > 0)))
          r |= SHIM_POLLIN;
        if ((want & SHIM_POLLOUT) && !hup && h1 && h1->wbudget > 0)
          r |= SHIM_POLLOUT;
        if (hup) r |= SHIM_POLLHUP;
        if ((want & SHIM_POLLIN) && !h0 && !hup)
          return INT64_MIN; /* RX ring not offered yet: cannot know */
        if ((want & SHIM_POLLOUT) && !h1 && !hup) return INT64_MIN;
      } else {
        /* pipe flavor: need the ring for each polled direction (a
         * missing role cannot be told apart from a wrong-direction
         * end, whose answer is a constant false — the worker knows) */
        if (want & SHIM_POLLIN) {
          if (!h0) return INT64_MIN;
          if (h0->wpos - h0->rpos > 0 || h0->writers == 0)
            r |= SHIM_POLLIN;
        }
        if (want & SHIM_POLLOUT) {
          if (!h1) return INT64_MIN;
          if (h1->cap - (h1->wpos - h1->rpos) > 0 || h1->readers == 0)
            r |= SHIM_POLLOUT;
        }
      }
    } else {
      /* readiness byte: VALID only for watched vfds with NO ring-capable
       * backing anywhere in the process (worker-maintained invariant) */
      long idx = (long)fd - SHIM_VFD_BASE;
      if (idx < 0 || idx >= SHIM_READY_LEN) return INT64_MIN;
      uint8_t b = ((volatile uint8_t *)shim_time_page)[SHIM_READY_OFF +
                                                       idx];
      if (!(b & SHIM_READY_VALID)) return INT64_MIN;
      if ((want & SHIM_POLLIN) && (b & SHIM_READY_IN)) r |= SHIM_POLLIN;
      if ((want & SHIM_POLLOUT) && (b & SHIM_READY_OUT))
        r |= SHIM_POLLOUT;
      if (b & SHIM_READY_HUP) r |= SHIM_POLLHUP;
      if (b & SHIM_READY_ERR) r |= SHIM_POLLERR;
    }
    if (r) n++;
    revs[i] = r;
  }
  if (n == 0 && !zero_timeout) return INT64_MIN; /* park at the worker */
  for (uint64_t i = 0; i < nfds; i++)
    memcpy((void *)(fds_ptr + 8 * i + 6), &revs[i], 2);
  shim_count_class(SHIM_PAGE_CLS_READY);
  return n;
}

/* the child re-reads its real pid from /proc (getpid is trapped and would
 * return the VIRTUAL pid; the cached parent ids are wrong post-fork).
 * raw3 rides the gadget, so this open is IP-allowed native and reads the
 * REAL kernel /proc — the worker's synthesized /proc/self/stat (vpid)
 * only serves guest-issued opens. The inline-asm no-gadget fallback
 * would trap here; that degraded mode predates the file surface and is
 * not used when the gadget page maps (it always does in practice). */
static void shim_refresh_real_ids(void) {
  int fd = (int)raw3(SYS_open, (long)"/proc/self/stat", 0, 0);
  if (fd < 0) return;
  char buf[64];
  long n = raw3(SYS_read, fd, (long)buf, (long)sizeof buf - 1);
  raw3(SYS_close, fd, 0, 0);
  if (n <= 0) return;
  buf[n] = 0;
  long pid = 0;
  for (char *p = buf; *p >= '0' && *p <= '9'; p++) pid = pid * 10 + (*p - '0');
  if (pid > 0) { shim_real_pid = pid; shim_real_tid = pid; }
}

/* ---- execve: worker-mediated respawn -----------------------------------
 *
 * Reference analog: managed processes exec'ing other binaries (SURVEY.md
 * §3.2 — Shadow keeps children managed across exec). Round 3 replaced the
 * old in-place re-exec (a magic-envp seccomp gate) because it cannot
 * coexist with the virtual file surface: the new image's dynamic linker
 * would trap on openat under the INHERITED filter before any SIGSYS
 * handler exists. Instead execve is forwarded like any syscall; the
 * worker spawns a REPLACEMENT managed process (fresh filter stack, same
 * process record / vpid / vfd table / stdio captures) and kills this one
 * while it blocks in the forward's read — a successful execve therefore
 * never returns, exactly like the real thing. Works from any thread and
 * under audit mode. */
static long shim_do_exec(const char *path, char **argv, char **envp) {
  return (long)forward(SYS_execve, (uint64_t)path, (uint64_t)argv,
                       (uint64_t)envp, 0, 0, 0);
}

/* Reference analog: managed-process fork (SURVEY.md §3.2 sibling path).
 * The worker mints the child's channel (FORK_INTENT -> SCM_RIGHTS fd),
 * the REAL fork runs here in the guest, the child rebinds the fresh
 * channel at the main slot and parks for its first turn, and the parent
 * reports the real child pid (FORK_COMMIT) in exchange for the child's
 * virtual pid. */
static long shim_do_fork(uint64_t nr, greg_t *g) {
  struct shim_req rq = {SHIM_FORK_INTENT, {0, 0, 0, 0, 0, 0}};
  if (write_all(&rq, sizeof rq) != 0) return -EAGAIN;
  int64_t eid = -1;
  int newfd = shim_recv_fd(&eid);
  if (newfd < 0 || eid < 0) return -EAGAIN;
  /* replay the clone through the GADGET (IP-allowed by both filters):
   * the old CLONE_IO marker allowance is gone, so a guest can no longer
   * mint an unmanaged child by setting that flag itself — every
   * fork-style clone from guest code traps into this protocol. Original
   * ctid/ptid args are preserved for glibc's TCB fixup. */
  long child;
  if (nr == SYS_clone)
    child = raw5(SYS_clone, (long)g[REG_RDI], (long)g[REG_RSI],
                 (long)g[REG_RDX], (long)g[REG_R10], (long)g[REG_R8]);
  else /* raw SYS_fork callers: synthesize fork-flavored clone flags */
    child = raw5(SYS_clone, 17 /*SIGCHLD*/, 0, 0, 0, 0);
  if (child < 0) {
    raw3(SYS_close, newfd, 0, 0);
    return child; /* worker-side embryo is reclaimed at process exit */
  }
  if (child == 0) {
    /* child: own fd table — rebind the fresh channel to the main slot,
     * and sever inherited per-thread channels by dup2'ing /dev/null over
     * them (close() on the IPC window is trapped — the worker must not
     * see channel traffic from this thread before its HELLO) */
    shim_is_fork = 1; /* the shared clock page's vpid is the parent's */
    /* socket rings are per-OWNER-process (the worker's oplog replay map
     * and wbudget refresh only track the page owner's fds): drop the
     * inherited mappings so every child socket op forwards. Pipe rings
     * stay — their state lives in the ring itself and is shared. */
    for (int i = 0; i < SHIM_RING_MAX; i++)
      if (shim_rings[i].h && (shim_rings[i].h->flags & SHRING_F_SOCK))
        shim_ring_unmap(i);
    raw3(SYS_dup2, newfd, SHIM_IPC_FD, 0);
    if (newfd != SHIM_IPC_FD) raw3(SYS_close, newfd, 0, 0);
    int nullfd = (int)raw3(SYS_open, (long)"/dev/null", 2 /*O_RDWR*/, 0);
    if (nullfd >= 0) {
      for (int fd = SHIM_IPC_LOW; fd < SHIM_IPC_FD; fd++)
        raw3(SYS_dup2, nullfd, fd, 0);
      raw3(SYS_close, nullfd, 0, 0);
    }
    shim_tls_fd = SHIM_IPC_FD;
    shim_tls_ready = 1;
    /* per-process audit: the child's boundary record starts empty (the
     * inherited bitmap would silently suppress its first-use notes) */
    memset(shim_audit_seen, 0, sizeof shim_audit_seen);
    shim_refresh_real_ids();
    forward(SHIM_THREAD_HELLO, 0, 0, 0, 0, 0, 0); /* first turn grant */
    return 0;
  }
  raw3(SYS_close, newfd, 0, 0);
  return forward(SHIM_FORK_COMMIT, (uint64_t)eid, (uint64_t)child,
                 0, 0, 0, 0); /* -> the child's virtual pid */
}

/* BEGIN GENERATED EMU BITMAP (tools/gen_bpf.py) */
static const uint8_t shim_emu_bitmap[64] = {
    0xd4, 0x40, 0xe0, 0x00, 0x8a, 0xff, 0xff, 0xef,
    0x00, 0x90, 0xbd, 0x02, 0x1f, 0x40, 0x00, 0x00,
    0x08, 0x00, 0x00, 0x00, 0x01, 0x00, 0x00, 0x04,
    0x00, 0x16, 0x20, 0x00, 0xf0, 0x03, 0x00, 0xe0,
    0xc6, 0xe9, 0x18, 0xde, 0x7f, 0x40, 0x00, 0x50,
    0x00, 0x10, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x98, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
};
/* END GENERATED EMU BITMAP */

/* would the worker emulate this trapped syscall? (mirrors the standard
 * filter's trap conditions; fd-conditional numbers check the vfd/IPC
 * ranges like the BPF does) */
static int shim_nr_emulated(long nr, const greg_t *g) {
  uint64_t a0 = (uint64_t)g[REG_RDI];
  int vfd = a0 >= SHIM_VFD_BASE && a0 < 0xFFFFF000u;
  switch (nr) {
  case SYS_read: case SYS_readv:
    return a0 == 0 || vfd;
  case SYS_write: case SYS_writev:
    return a0 <= 2 || vfd;
  case SYS_close:
    return vfd || (a0 >= SHIM_IPC_LOW && a0 <= SHIM_IPC_FD);
  case 9: { /* mmap: fd rides arg4; MAP_ANONYMOUS fd=-1 stays native */
    uint64_t a4 = (uint64_t)g[REG_R8];
    return a4 >= SHIM_VFD_BASE && a4 < 0xFFFFF000u;
  }
  /* BEGIN GENERATED VFD CASES (tools/gen_bpf.py) */
  case 16: case 72: case 32: case 5: case 8: case 217: case 77: case 74: case 75: case 81: case 17: case 18:  /* ioctl fcntl dup fstat lseek getdents64 ftruncate fsync fdatasync fchdir pread64 pwrite64 */
  /* END GENERATED VFD CASES */
    return vfd;
  default:
    return nr >= 0 && nr < 512 &&
           ((shim_emu_bitmap[nr >> 3] >> (nr & 7)) & 1);
  }
}

static void shim_audit_note(long nr) {
  if (!shim_tls_ready) return; /* pre-registration thread bootstrap:
                                  no channel to report on (uncounted) */
  if (nr >= 0 && nr < 512) {
    if ((shim_audit_seen[nr >> 3] >> (nr & 7)) & 1) return;
    shim_audit_seen[nr >> 3] |= (uint8_t)(1u << (nr & 7));
  } /* out-of-range (x32 etc.): the worker's per-process set dedups */
  forward(SHIM_AUDIT_NOTE, (uint64_t)nr, 0, 0, 0, 0, 0);
}

static void sigsys_handler(int signo, siginfo_t *info, void *vctx) {
  (void)signo;
  ucontext_t *ctx = vctx;
  greg_t *g = ctx->uc_mcontext.gregs;
  if (info->si_syscall == SYS_rt_sigprocmask) {
    /* handled purely locally (see below) — safe at ANY thread stage */
    goto sigprocmask;
  }
  if (!shim_tls_ready) {
    /* a freshly cloned thread runs glibc bootstrap BEFORE the trampoline
     * pins its own channel; its thread-local channel fd still points at
     * the MAIN thread's, so forwarding would interleave with (and steal
     * replies from) the spawner's own request stream — the race that
     * intermittently broke the 10th pthread_create of a burst. These are
     * glibc-internal setup calls: run them natively via the gadget. */
    g[REG_RAX] = (greg_t)shim_gadget(info->si_syscall, (long)g[REG_RDI],
                                     (long)g[REG_RSI], (long)g[REG_RDX],
                                     (long)g[REG_R10], (long)g[REG_R8],
                                     (long)g[REG_R9]);
    return;
  }
  if (info->si_syscall == SYS_fork ||
      (info->si_syscall == SYS_clone && !(g[REG_RDI] & 0x10000))) {
    if (info->si_syscall == SYS_clone && (g[REG_RDI] & 0x100 /*CLONE_VM*/)) {
      g[REG_RAX] = (greg_t)-ENOSYS; /* vfork-style shared-VM clone */
      return;
    }
    g[REG_RAX] = (greg_t)shim_do_fork((uint64_t)info->si_syscall, g);
    return;
  }
  if (info->si_syscall == SYS_execve) {
    g[REG_RAX] = (greg_t)shim_do_exec((const char *)g[REG_RDI],
                                      (char **)g[REG_RSI],
                                      (char **)g[REG_RDX]);
    return;
  }
  if (info->si_syscall == SYS_exit_group) {
    /* report the true code, then exit this thread for real; the worker
     * SIGKILLs any remaining threads (exit_group semantics) */
    forward(SYS_exit_group, (uint64_t)g[REG_RDI], 0, 0, 0, 0, 0);
    raw3(SYS_exit, (long)g[REG_RDI], 0, 0);
  }
  if (info->si_syscall == SYS_rt_sigprocmask) {
  sigprocmask:;
    /* Emulated SHIM-SIDE by editing the signal frame's uc_sigmask (the
     * mask sigreturn restores) — never with a real syscall, which would
     * re-trap forever. Crucially SIGSYS/SIGSEGV are ALWAYS left unblocked:
     * glibc's pthread_create blocks every signal around clone, and a
     * seccomp trap while SIGSYS is blocked force-kills the process. */
    uint64_t how = g[REG_RDI], set = g[REG_RSI], old = g[REG_RDX];
    uint64_t cur;
    memcpy(&cur, &ctx->uc_sigmask, 8);
    if (old) memcpy((void *)old, &cur, 8);
    if (set) {
      uint64_t m;
      memcpy(&m, (const void *)set, 8);
      if (how == SIG_BLOCK) cur |= m;
      else if (how == SIG_UNBLOCK) cur &= ~m;
      else if (how == SIG_SETMASK) cur = m;
      else { g[REG_RAX] = (greg_t)-EINVAL; return; }
      cur &= ~((1ULL << (SIGSYS - 1)) | (1ULL << (SIGSEGV - 1)));
      memcpy(&ctx->uc_sigmask, &cur, 8);
    }
    g[REG_RAX] = 0;
    return;
  }
  if (shim_audit_on && !shim_nr_emulated(info->si_syscall, g)) {
    /* reality boundary: the worker does not emulate this call. Report it
     * (once per number) and run it against the host kernel via the
     * gadget, exactly what the standard filter's default-ALLOW did —
     * except now it is observed. */
    shim_audit_note(info->si_syscall);
    g[REG_RAX] = (greg_t)shim_gadget(info->si_syscall, (long)g[REG_RDI],
                                     (long)g[REG_RSI], (long)g[REG_RDX],
                                     (long)g[REG_R10], (long)g[REG_R8],
                                     (long)g[REG_R9]);
    return;
  }
  /* identity fast path (shared clock page, no worker round trip):
   * getpid/gettid return the page's vpid (the worker's emulation returns
   * vpid for both), getppid is the constant 1 ("init of the simulated
   * world"). Forked children share the parent's page, so they forward. */
  if (info->si_syscall == SYS_getpid || info->si_syscall == SYS_gettid) {
    if (!shim_is_fork && shim_time_page && shim_time_page[1] > 0) {
      g[REG_RAX] = (greg_t)shim_time_page[1];
      shim_count_class(SHIM_PAGE_CLS_IDENT);
      return;
    }
  } else if (info->si_syscall == SYS_getppid) {
    g[REG_RAX] = 1;
    shim_count_class(SHIM_PAGE_CLS_IDENT);
    return;
  }
  /* raw time-family syscalls (static binaries / raw-syscall guests that
   * bypass the libc interposition) served from the clock page. The
   * monotonic-clock set and the sec/nsec split mirror the worker's
   * _service exactly; the (uint64_t)-1 sentinel stays a worker call. */
  if (shim_page_fast()) {
    if (info->si_syscall == SYS_clock_gettime && g[REG_RSI] &&
        (uint64_t)g[REG_RDI] != (uint64_t)-1) {
      int64_t ns = *shim_time_page;
      uint64_t clk = (uint64_t)g[REG_RDI];
      if (clk == 1 || clk == 2 || clk == 3 || clk == 4 || clk == 6 ||
          clk == 7)
        ns -= SHIM_EMULATED_EPOCH_NS; /* MONO_CLOCKS (worker twin) */
      int64_t *tp = (int64_t *)g[REG_RSI];
      tp[0] = ns / 1000000000;
      tp[1] = ns % 1000000000;
      shim_count_class(SHIM_PAGE_CLS_TIME);
      g[REG_RAX] = 0;
      return;
    }
    if (info->si_syscall == SYS_gettimeofday) {
      if (g[REG_RDI]) {
        int64_t ns = *shim_time_page;
        int64_t *tp = (int64_t *)g[REG_RDI];
        tp[0] = ns / 1000000000;
        tp[1] = (ns % 1000000000) / 1000;
      }
      shim_count_class(SHIM_PAGE_CLS_TIME);
      g[REG_RAX] = 0;
      return;
    }
    if (info->si_syscall == SYS_time) {
      int64_t secs = *shim_time_page / 1000000000;
      if (g[REG_RDI]) *(int64_t *)g[REG_RDI] = secs;
      shim_count_class(SHIM_PAGE_CLS_TIME);
      g[REG_RAX] = (greg_t)secs;
      return;
    }
    if (info->si_syscall == SYS_poll || info->si_syscall == SYS_ppoll) {
      int64_t r = shim_poll_local((uint64_t)g[REG_RDI],
                                  (uint64_t)g[REG_RSI],
                                  (uint64_t)g[REG_RDX],
                                  info->si_syscall == SYS_ppoll);
      if (r != INT64_MIN) { g[REG_RAX] = (greg_t)r; return; }
    }
  }
  /* shared-memory pipe fast path (zero round trips when it hits).
   * Covers vfds AND the trapped stdio fds — a shell pipeline dup2's
   * pipe ends onto 0/1, and those reads/writes trap (gen_bpf.py READ /
   * WRITE branches); the mapping's existence is what says "this fd is
   * currently a ring pipe" (offers ride its service replies, and every
   * close / dup2-over / close_range drops the entry). */
  {
    long fd0 = (long)g[REG_RDI];
    if (info->si_syscall == SYS_read &&
        (fd0 == 0 || fd0 >= SHIM_VFD_BASE)) {
      int64_t r = shim_ring_read(fd0, (uint64_t)g[REG_RSI],
                                 (uint64_t)g[REG_RDX], 0);
      if (r != INT64_MIN) { g[REG_RAX] = (greg_t)r; return; }
    } else if (info->si_syscall == SYS_recvfrom &&
               fd0 >= SHIM_VFD_BASE) {
      /* flags: the worker honors MSG_PEEK only and ignores the rest,
       * as does the src-address pair on connected streams — mirror it */
      int64_t r = shim_ring_read(fd0, (uint64_t)g[REG_RSI],
                                 (uint64_t)g[REG_RDX],
                                 ((uint64_t)g[REG_R10] & 2) != 0);
      if (r != INT64_MIN) { g[REG_RAX] = (greg_t)r; return; }
    } else if (info->si_syscall == SYS_write &&
               (fd0 == 1 || fd0 == 2 || fd0 >= SHIM_VFD_BASE)) {
      int64_t r = shim_ring_write(fd0, (uint64_t)g[REG_RSI],
                                  (uint64_t)g[REG_RDX]);
      if (r != INT64_MIN) { g[REG_RAX] = (greg_t)r; return; }
    } else if (info->si_syscall == SYS_sendto && fd0 >= SHIM_VFD_BASE) {
      /* dest-address/flags are ignored by the worker on connected
       * streams (_vfd_send takes fd/buf/len only) — mirror it */
      int64_t r = shim_ring_write(fd0, (uint64_t)g[REG_RSI],
                                  (uint64_t)g[REG_RDX]);
      if (r != INT64_MIN) { g[REG_RAX] = (greg_t)r; return; }
    } else if (info->si_syscall == SYS_close ||
               info->si_syscall == SYS_shutdown) {
      /* close drops both roles; shutdown conservatively drops them too
       * (a SHUT_RD end must EOF instead of serving buffered ring data —
       * subsequent ops forward and the worker owns the semantics) */
      shim_ring_drop(fd0); /* then forward */
    }
  }
  if ((info->si_syscall == SYS_dup2 || info->si_syscall == SYS_dup3) &&
      (long)g[REG_RSI] != (long)g[REG_RDI])
    shim_ring_drop((long)g[REG_RSI]); /* newfd implicitly closed
                                         (dup2(x,x) closes nothing) */
  if (info->si_syscall == SYS_close_range && !((long)g[REG_RDX] & 4)) {
    /* CLOSE_RANGE_CLOEXEC (flag 4) marks without closing */
    for (int i = 0; i < SHIM_RING_MAX; i++)
      if (shim_rings[i].h && shim_rings[i].vfd >= (long)g[REG_RDI] &&
          shim_rings[i].vfd <= (long)g[REG_RSI])
        shim_ring_unmap(i);
  }
  if (info->si_syscall == 9) {
    /* mmap of a virtualized file: the worker replies with the real
     * backing fd (host-tree fd or a memfd snapshot of synthesized
     * content) as SCM_RIGHTS; re-issue the map with it through the
     * gadget, then drop the temporary fd — the mapping holds the file */
    struct shim_req rq = {9, {(uint64_t)g[REG_RDI], (uint64_t)g[REG_RSI],
                              (uint64_t)g[REG_RDX], (uint64_t)g[REG_R10],
                              (uint64_t)g[REG_R8], (uint64_t)g[REG_R9]}};
    int64_t val = -EBADF;
    if (write_all(&rq, sizeof rq) != 0) {
      g[REG_RAX] = (greg_t)(int64_t)-EPIPE;
      return;
    }
    int mfd = shim_recv_fd(&val);
    if (mfd >= 0) {
      shim_gadget_fn reissue = shim_gadget ? shim_gadget : raw6_asm;
      long r = reissue(9, (long)g[REG_RDI], (long)g[REG_RSI],
                       (long)g[REG_RDX], (long)g[REG_R10], mfd,
                       (long)g[REG_R9]);
      raw3(SYS_close, mfd, 0, 0);
      g[REG_RAX] = (greg_t)r;
    } else {
      g[REG_RAX] = (greg_t)val; /* worker errno (no fd attached) */
    }
    return;
  }
  int64_t ret = forward((uint64_t)info->si_syscall, (uint64_t)g[REG_RDI],
                        (uint64_t)g[REG_RSI], (uint64_t)g[REG_RDX],
                        (uint64_t)g[REG_R10], (uint64_t)g[REG_R8],
                        (uint64_t)g[REG_R9]);
  while (ret == SHIM_RET_MAPRING) {
    /* a ring memfd + role follows, then either ANOTHER offer (socket
     * rings arrive as an RX+TX pair) or the real result of this op */
    int64_t role = 0;
    int mfd = shim_recv_fd(&role);
    if (mfd >= 0) shim_ring_install((long)g[REG_RDI], (int)role, mfd);
    int64_t fin = -EPIPE;
    if (read_all(&fin, sizeof fin) != 0) fin = -EPIPE;
    ret = fin;
  }
  if (ret == SHIM_RET_NATIVE) {
    /* the worker chose passthrough for this one (virtual-FS policy) */
    shim_gadget_fn reissue = shim_gadget ? shim_gadget : raw6_asm;
    ret = reissue(info->si_syscall, (long)g[REG_RDI], (long)g[REG_RSI],
                  (long)g[REG_RDX], (long)g[REG_R10], (long)g[REG_R8],
                  (long)g[REG_R9]);
  }
  g[REG_RAX] = (greg_t)ret;
}

/* ---- interposed time family (catches the vDSO paths) ------------------- */

static int64_t emulated_now_ns(void);

/* ---- TSC virtualization (reference analog: SURVEY.md §2 "TSC emulation")
 *
 * prctl(PR_SET_TSC, PR_TSC_SIGSEGV) makes rdtsc/rdtscp fault; this handler
 * decodes the two instruction forms and serves the emulated clock at a
 * fixed nominal 1 GHz (cycles == ns), so even guests that time via the raw
 * TSC — bypassing every syscall and vDSO path — observe simulated time.
 *
 * Guests that install their own SIGSEGV handler must keep working: the
 * shim interposes sigaction()/signal() (libc PLT calls — raw rt_sigaction
 * from a static binary bypasses this, a documented scope limit) and keeps
 * its handler installed, recording the guest's disposition. Non-TSC
 * SIGSEGVs are chained to the guest handler; with none registered, a
 * hardware fault crashes via re-execution under SIG_DFL, and a
 * software-raised SIGSEGV (raise/kill: si_code <= 0) is re-raised
 * explicitly since nothing would re-trigger it on return. */

static struct sigaction guest_segv; /* guest's requested disposition */

static int real_sigaction(int sig, const struct sigaction *act,
                          struct sigaction *old) {
  static int (*real)(int, const struct sigaction *, struct sigaction *);
  if (!real) {
    union { void *p; int (*f)(int, const struct sigaction *,
                              struct sigaction *); } u;
    u.p = dlsym(RTLD_NEXT, "sigaction");
    real = u.f;
  }
  return real(sig, act, old);
}

/* dispatch to the guest's handler under its requested signal mask */
static void chain_guest(int signo, siginfo_t *info, void *vctx) {
  sigset_t old;
  sigprocmask(SIG_BLOCK, &guest_segv.sa_mask, &old);
  if (guest_segv.sa_flags & SA_SIGINFO)
    guest_segv.sa_sigaction(signo, info, vctx);
  else
    guest_segv.sa_handler(signo);
  sigprocmask(SIG_SETMASK, &old, NULL); /* longjmp-outs restore their own */
}

static void sigsegv_handler(int signo, siginfo_t *info, void *vctx) {
  ucontext_t *ctx = vctx;
  greg_t *g = ctx->uc_mcontext.gregs;
  const uint8_t *ip = (const uint8_t *)g[REG_RIP];
  /* rdtsc = 0F 31 ; rdtscp = 0F 01 F9. A bogus RIP makes the ip[] reads
   * fault; SIGSEGV is blocked inside its own handler, so the kernel then
   * force-kills with the default action — the right outcome. */
  if (ip && ip[0] == 0x0f &&
      (ip[1] == 0x31 || (ip[1] == 0x01 && ip[2] == 0xf9))) {
    uint64_t ns = (uint64_t)emulated_now_ns();
    g[REG_RAX] = (greg_t)(ns & 0xffffffffu);
    g[REG_RDX] = (greg_t)(ns >> 32);
    if (ip[1] == 0x31) {
      g[REG_RIP] += 2;
    } else {
      g[REG_RCX] = 0; /* IA32_TSC_AUX: core 0 */
      g[REG_RIP] += 3;
    }
    return;
  }
  int hw_fault = info->si_code > 0; /* <=0: raise()/kill()/sigqueue() */
  if ((guest_segv.sa_flags & SA_SIGINFO) ||
      (guest_segv.sa_handler != SIG_DFL && guest_segv.sa_handler != SIG_IGN &&
       guest_segv.sa_handler != NULL)) {
    chain_guest(signo, info, vctx);
    return;
  }
  if (guest_segv.sa_handler == SIG_IGN && !hw_fault)
    return; /* ignoring a software-raised SIGSEGV is legal */
  /* default action (the kernel also force-kills SIG_IGN on a hardware
   * fault): restore the REAL kernel disposition — the interposed signal()
   * would only record it — then let re-execution (hardware) or an explicit
   * re-raise (software) deliver the fatal signal. */
  struct sigaction dfl;
  memset(&dfl, 0, sizeof dfl);
  dfl.sa_handler = SIG_DFL;
  real_sigaction(SIGSEGV, &dfl, NULL);
  if (!hw_fault)
    raw3(SYS_tgkill, shim_real_pid, shim_real_tid, SIGSEGV);
}

/* sigaction/signal interposition: SIGSEGV dispositions are recorded, not
 * installed — the shim's handler stays first and chains (above). */

static struct sigaction guest_sys; /* guest's requested SIGSYS disposition
                                      (recorded only — the shim's handler
                                      IS the syscall mechanism and must
                                      never be uninstalled; guests bulk-
                                      resetting handlers, e.g. CPython's
                                      subprocess child, would otherwise
                                      die on their next trapped call) */

int sigaction(int sig, const struct sigaction *act, struct sigaction *old) {
  if (!shim_active || (sig != SIGSEGV && sig != SIGSYS))
    return real_sigaction(sig, act, old);
  struct sigaction *slot = (sig == SIGSEGV) ? &guest_segv : &guest_sys;
  if (old) *old = *slot;
  if (act) *slot = *act;
  return 0;
}

sighandler_t signal(int sig, sighandler_t fn) {
  if (!shim_active || sig != SIGSEGV) {
    struct sigaction sa, osa;
    memset(&sa, 0, sizeof sa);
    sa.sa_handler = fn;
    sa.sa_flags = SA_RESTART;
    sigemptyset(&sa.sa_mask);
    if (sigaction(sig, &sa, &osa) != 0) return SIG_ERR;
    return osa.sa_handler;
  }
  sighandler_t prev = guest_segv.sa_handler;
  memset(&guest_segv, 0, sizeof guest_segv);
  guest_segv.sa_handler = fn;
  return prev;
}

static int64_t emulated_now_ns(void) {
  if (shim_time_page) return *shim_time_page;
  struct shim_req unused; (void)unused;
  /* no page mapped: ask the worker (slow path, still deterministic) */
  return forward(SYS_clock_gettime, (uint64_t)-1, 0, 0, 0, 0, 0);
}

/* The simulation boots at 2000-01-01T00:00:00Z; monotonic-family clocks
 * originate at boot == sim start, consistent with sysinfo's sim-second
 * uptime and Linux's near-zero monotonic origin (SHIM_EMULATED_EPOCH_NS
 * is defined beside the ring plane above, which also needs it). */
static int clk_is_monotonic(clockid_t clk) {
  return clk == CLOCK_MONOTONIC || clk == CLOCK_MONOTONIC_RAW ||
         clk == CLOCK_MONOTONIC_COARSE || clk == CLOCK_BOOTTIME ||
         clk == CLOCK_PROCESS_CPUTIME_ID || clk == CLOCK_THREAD_CPUTIME_ID;
}

/* the interposed family completes shim-locally in EVERY mode (it never
 * reaches the worker), so it counts unconditionally — keeping the
 * "syscalls" counter invariant across fast-plane on/off */
int clock_gettime(clockid_t clk, struct timespec *ts) {
  if (!shim_active) return (int)raw3(SYS_clock_gettime, clk, (long)ts, 0);
  int64_t ns = emulated_now_ns();
  if (clk_is_monotonic(clk)) ns -= SHIM_EMULATED_EPOCH_NS;
  ts->tv_sec = ns / 1000000000;
  ts->tv_nsec = ns % 1000000000;
  shim_count_class(SHIM_PAGE_CLS_TIME);
  return 0;
}

int gettimeofday(struct timeval *tv, void *tz) {
  (void)tz;
  if (!shim_active) return (int)raw3(SYS_gettimeofday, (long)tv, 0, 0);
  int64_t ns = emulated_now_ns();
  tv->tv_sec = ns / 1000000000;
  tv->tv_usec = (ns % 1000000000) / 1000;
  shim_count_class(SHIM_PAGE_CLS_TIME);
  return 0;
}

time_t time(time_t *out) {
  if (!shim_active) return (time_t)raw3(SYS_time, (long)out, 0, 0);
  time_t t = (time_t)(emulated_now_ns() / 1000000000);
  if (out) *out = t;
  shim_count_class(SHIM_PAGE_CLS_TIME);
  return t;
}

/* ---- guest threads ------------------------------------------------------
 *
 * Reference analog: ManagedThread (SURVEY.md §2). The worker enforces
 * strict one-runnable-thread turn-taking, so every thread needs its own
 * wakeup channel: pthread_create is interposed; the worker mints a fresh
 * socketpair and hands the guest end back as SCM_RIGHTS ancillary data on
 * the SPAWN reply; the new thread pins it at a reserved fd (995 - slot,
 * inside the seccomp-allowed [932, 995] window), checks in with
 * THREAD_HELLO (its reply is the first turn grant), runs the app start
 * routine, and announces THREAD_EXIT so joiners parked at the worker wake
 * in sim time. CLONE_THREAD clones run natively; futex is trapped and
 * emulated worker-side so lock handoffs between parked threads cannot
 * deadlock the turn-taking. Scope: up to 63 extra threads; raw clone(2)
 * users and fork are still rejected loudly. */

#define SHIM_MAX_THREADS 64
struct shim_tramp { void *(*fn)(void *); void *arg; int fd; };
static pthread_t shim_thread_ids[SHIM_MAX_THREADS]; /* slot -> pthread_t */

static long shim_spawn_channel(void) {
  struct shim_req rq = {SHIM_SPAWN_THREAD, {0, 0, 0, 0, 0, 0}};
  if (write_all(&rq, sizeof rq) != 0) return -1;
  int64_t slot = -1;
  int newfd = shim_recv_fd(&slot);
  if (newfd < 0 || slot < 0 || slot >= SHIM_MAX_THREADS) return -1;
  int want = SHIM_IPC_FD - (int)slot;
  if (newfd != want) {
    raw3(SYS_dup2, newfd, want, 0);
    raw3(SYS_close, newfd, 0, 0);
  }
  return slot;
}

/* trampoline args live in a static per-slot table, NOT a malloc block:
 * free() in the trampoline could contend the malloc arena lock and issue
 * futex(FUTEX_WAIT) either natively before shim_tls_ready (never woken —
 * the holder's FUTEX_WAKE is worker-emulated) or emulated before
 * THREAD_HELLO (protocol violation). Slots are only reused after the
 * prior thread exits, long after it copied its entry. */
static struct shim_tramp shim_tramp_slots[SHIM_MAX_THREADS];

static void *shim_thread_tramp(void *p) {
  struct shim_tramp t = *(struct shim_tramp *)p;
  shim_tls_fd = t.fd;
  shim_tls_ready = 1;
  forward(SHIM_THREAD_HELLO, 0, 0, 0, 0, 0, 0); /* blocks for first turn */
  void *r = t.fn(t.arg);
  forward(SHIM_THREAD_EXIT, (uint64_t)r, 0, 0, 0, 0, 0);
  return r;
}

/* ---- simulated name resolution ------------------------------------------
 *
 * Reference analog: Shadow resolves config host names to simulated IPs
 * for its guests. getaddrinfo is interposed: names the WORKER knows
 * (config host names) resolve to their simulated IPv4 without touching
 * /etc/hosts or DNS; everything else falls through to the real resolver.
 * Results we fabricate live in single-malloc blocks tracked in a small
 * registry so the interposed freeaddrinfo releases ours and forwards the
 * rest. */

#include <netdb.h>
#include <netinet/in.h>

struct shim_ai_block {
  struct addrinfo ai;
  struct sockaddr_in sa;
  char canon[256]; /* AI_CANONNAME storage (freed with the block) */
};

#define SHIM_AI_MAX 64
static struct addrinfo *shim_ai_live[SHIM_AI_MAX];

int getaddrinfo(const char *node, const char *service,
                const struct addrinfo *hints, struct addrinfo **res) {
  static int (*real)(const char *, const char *, const struct addrinfo *,
                     struct addrinfo **);
  if (!real) {
    union { void *p; int (*f)(const char *, const char *,
                              const struct addrinfo *,
                              struct addrinfo **); } u;
    u.p = dlsym(RTLD_NEXT, "getaddrinfo");
    real = u.f;
  }
  int family_ok = !hints || hints->ai_family == AF_UNSPEC ||
                  hints->ai_family == AF_INET;
  if (shim_active && node != NULL && family_ok) {
    int64_t ip = forward(SHIM_RESOLVE, (uint64_t)node, 0, 0, 0, 0, 0);
    if (ip >= 0) {
      long port = 0;
      if (service) {
        for (const char *p = service; *p; p++) {
          if (*p < '0' || *p > '9' || port > 65535) { port = -1; break; }
          port = port * 10 + (*p - '0');
        }
        if (port < 0 || port > 65535)
          return EAI_SERVICE; /* named services: not modeled */
      }
      struct shim_ai_block *b = calloc(1, sizeof *b);
      if (!b) return EAI_MEMORY;
      b->sa.sin_family = AF_INET;
      b->sa.sin_port = htons((uint16_t)port);
      b->sa.sin_addr.s_addr = htonl((uint32_t)ip);
      b->ai.ai_family = AF_INET;
      b->ai.ai_socktype = hints && hints->ai_socktype ? hints->ai_socktype
                                                      : SOCK_STREAM;
      b->ai.ai_protocol = 0;
      b->ai.ai_addrlen = sizeof b->sa;
      b->ai.ai_addr = (struct sockaddr *)&b->sa;
      if (hints && (hints->ai_flags & AI_CANONNAME)) {
        strncpy(b->canon, node, sizeof b->canon - 1);
        b->ai.ai_canonname = b->canon;
      }
      /* registry claim must be atomic (threaded resolvers) and must not
       * drop: an unregistered block reaching the REAL freeaddrinfo is
       * undefined behavior on allocator-layout-assuming libcs */
      int claimed = 0;
      for (int i = 0; i < SHIM_AI_MAX && !claimed; i++)
        claimed = __sync_bool_compare_and_swap(&shim_ai_live[i], NULL,
                                               &b->ai);
      if (!claimed) {
        free(b); /* registry full: degrade to the real resolver */
        return real(node, service, hints, res);
      }
      *res = &b->ai;
      return 0;
    }
  }
  return real(node, service, hints, res);
}

void freeaddrinfo(struct addrinfo *ai) {
  static void (*real)(struct addrinfo *);
  if (!real) {
    union { void *p; void (*f)(struct addrinfo *); } u;
    u.p = dlsym(RTLD_NEXT, "freeaddrinfo");
    real = u.f;
  }
  for (int i = 0; i < SHIM_AI_MAX; i++)
    if (__sync_bool_compare_and_swap(&shim_ai_live[i], ai, NULL)) {
      free(ai); /* the whole shim_ai_block in one allocation */
      return;
    }
  real(ai);
}

pid_t vfork(void) {
  /* vfork-as-fork: POSIX permits it, and the fork path (trapped clone ->
   * shim_do_fork) keeps the child managed; the parent just continues
   * instead of suspending. CPython's subprocess and shell spawn idioms
   * land here. */
  static pid_t (*realfork)(void);
  if (!realfork) {
    union { void *p; pid_t (*f)(void); } u;
    u.p = dlsym(RTLD_NEXT, "fork");
    realfork = u.f;
  }
  return realfork();
}

int pthread_create(pthread_t *out, const pthread_attr_t *attr,
                   void *(*fn)(void *), void *arg) {
  static int (*real)(pthread_t *, const pthread_attr_t *,
                     void *(*)(void *), void *);
  if (!real) {
    union { void *p; int (*f)(pthread_t *, const pthread_attr_t *,
                              void *(*)(void *), void *); } u;
    u.p = dlsym(RTLD_NEXT, "pthread_create");
    real = u.f;
  }
  if (!shim_active) return real(out, attr, fn, arg);
  long slot = shim_spawn_channel();
  if (slot < 0) return EAGAIN;
  struct shim_tramp *t = &shim_tramp_slots[slot];
  t->fn = fn;
  t->arg = arg;
  t->fd = SHIM_IPC_FD - (int)slot;
  int rc = real(out, attr, shim_thread_tramp, t);
  if (rc == 0) shim_thread_ids[slot] = *out;
  /* on failure the worker-side slot leaks; the process is dying anyway */
  return rc;
}

int pthread_join(pthread_t th, void **retval) {
  static int (*real)(pthread_t, void **);
  static int (*real_detach)(pthread_t);
  if (!real) {
    union { void *p; int (*f)(pthread_t, void **); } u;
    u.p = dlsym(RTLD_NEXT, "pthread_join");
    real = u.f;
    union { void *p; int (*f)(pthread_t); } v;
    v.p = dlsym(RTLD_NEXT, "pthread_detach");
    real_detach = v.f;
  }
  if (!shim_active) return real(th, retval);
  int slot = -1;
  for (int i = 1; i < SHIM_MAX_THREADS; i++)
    if (shim_thread_ids[i] == th) { slot = i; break; }
  if (slot < 0) return real(th, retval);
  int64_t rv = forward(SHIM_THREAD_JOIN, (uint64_t)slot, 0, 0, 0, 0, 0);
  if (retval) *retval = (void *)rv;
  shim_thread_ids[slot] = 0;
  /* the thread has (or is about to) exit natively; detach instead of a
   * real join — glibc's join would FUTEX_WAIT on the kernel-cleared tid,
   * a wake our trapped-futex emulation cannot observe */
  real_detach(th);
  return 0;
}

void pthread_exit(void *retval) {
  static void (*real)(void *) __attribute__((noreturn));
  if (!real) {
    union { void *p; void (*f)(void *) __attribute__((noreturn)); } u;
    u.p = dlsym(RTLD_NEXT, "pthread_exit");
    real = u.f;
  }
  if (shim_active && shim_tls_fd != SHIM_IPC_FD)
    forward(SHIM_THREAD_EXIT, (uint64_t)retval, 0, 0, 0, 0, 0);
  real(retval);
  __builtin_unreachable();
}

/* ---- seccomp filter ----------------------------------------------------- */

#define BPF_NR (offsetof(struct seccomp_data, nr))
#define BPF_ARG0 (offsetof(struct seccomp_data, args[0]))
#define BPF_ARG4 (offsetof(struct seccomp_data, args[4]))
#define BPF_ARG2LO (offsetof(struct seccomp_data, args[2]))
#define BPF_ARG2HI (offsetof(struct seccomp_data, args[2]) + 4)
#define BPF_ARCHF (offsetof(struct seccomp_data, arch))
#define BPF_IPLO (offsetof(struct seccomp_data, instruction_pointer))
#define BPF_IPHI (offsetof(struct seccomp_data, instruction_pointer) + 4)

#define LD(off) BPF_STMT(BPF_LD | BPF_W | BPF_ABS, (off))
#define RET(v) BPF_STMT(BPF_RET | BPF_K, (v))
#define JEQ(v, t, f) BPF_JUMP(BPF_JMP | BPF_JEQ | BPF_K, (v), (t), (f))
#define JGE(v, t, f) BPF_JUMP(BPF_JMP | BPF_JGE | BPF_K, (v), (t), (f))
#define JSET(v, t, f) BPF_JUMP(BPF_JMP | BPF_JSET | BPF_K, (v), (t), (f))

static int install_seccomp(void) {
  /* BEGIN GENERATED BPF (tools/gen_bpf.py) */
  struct sock_filter prog[] = {  /* 132 instructions */
      LD(BPF_ARCHF),
      JEQ(AUDIT_ARCH_X86_64, 0, 129),
      LD(BPF_IPHI),
      JEQ((uint32_t)((uintptr_t)SHIM_GADGET_ADDR >> 32), 0, 3),
      LD(BPF_IPLO),
      JGE((uint32_t)(uintptr_t)SHIM_GADGET_ADDR, 0, 1),
      JGE(((uint32_t)(uintptr_t)SHIM_GADGET_ADDR + 4096), 0, 124),
      LD(BPF_NR),
      JEQ(0, 98, 0),  /* read */
      JEQ(1, 102, 0),  /* write */
      JEQ(3, 111, 0),  /* close */
      JEQ(19, 95, 0),  /* readv */
      JEQ(20, 99, 0),  /* writev */
      JEQ(16, 113, 0),  /* ioctl */
      JEQ(72, 112, 0),  /* fcntl */
      JEQ(32, 111, 0),  /* dup */
      JEQ(5, 110, 0),  /* fstat */
      JEQ(8, 109, 0),  /* lseek */
      JEQ(217, 108, 0),  /* getdents64 */
      JEQ(77, 107, 0),  /* ftruncate */
      JEQ(74, 106, 0),  /* fsync */
      JEQ(75, 105, 0),  /* fdatasync */
      JEQ(81, 104, 0),  /* fchdir */
      JEQ(17, 103, 0),  /* pread64 */
      JEQ(18, 102, 0),  /* pwrite64 */
      JEQ(9, 99, 0),  /* mmap */
      JEQ(35, 103, 0),  /* nanosleep */
      JEQ(230, 102, 0),  /* clock_nanosleep */
      JEQ(228, 101, 0),  /* clock_gettime */
      JEQ(96, 100, 0),  /* gettimeofday */
      JEQ(201, 99, 0),  /* time */
      JEQ(318, 98, 0),  /* getrandom */
      JEQ(7, 97, 0),  /* poll */
      JEQ(271, 96, 0),  /* ppoll */
      JEQ(213, 95, 0),  /* epoll_create */
      JEQ(291, 94, 0),  /* epoll_create1 */
      JEQ(233, 93, 0),  /* epoll_ctl */
      JEQ(232, 92, 0),  /* epoll_wait */
      JEQ(281, 91, 0),  /* epoll_pwait */
      JEQ(288, 90, 0),  /* accept4 */
      JEQ(435, 89, 0),  /* clone3 */
      JEQ(39, 88, 0),  /* getpid */
      JEQ(110, 87, 0),  /* getppid */
      JEQ(186, 86, 0),  /* gettid */
      JEQ(283, 85, 0),  /* timerfd_create */
      JEQ(286, 84, 0),  /* timerfd_settime */
      JEQ(287, 83, 0),  /* timerfd_gettime */
      JEQ(284, 82, 0),  /* eventfd */
      JEQ(290, 81, 0),  /* eventfd2 */
      JEQ(202, 80, 0),  /* futex */
      JEQ(14, 79, 0),  /* rt_sigprocmask */
      JEQ(22, 78, 0),  /* pipe */
      JEQ(293, 77, 0),  /* pipe2 */
      JEQ(61, 76, 0),  /* wait4 */
      JEQ(231, 75, 0),  /* exit_group */
      JEQ(436, 74, 0),  /* close_range */
      JEQ(23, 73, 0),  /* select */
      JEQ(270, 72, 0),  /* pselect6 */
      JEQ(62, 71, 0),  /* kill */
      JEQ(63, 70, 0),  /* uname */
      JEQ(100, 69, 0),  /* times */
      JEQ(229, 68, 0),  /* clock_getres */
      JEQ(204, 67, 0),  /* sched_getaffinity */
      JEQ(99, 66, 0),  /* sysinfo */
      JEQ(98, 65, 0),  /* getrusage */
      JEQ(2, 64, 0),  /* open */
      JEQ(257, 63, 0),  /* openat */
      JEQ(85, 62, 0),  /* creat */
      JEQ(4, 61, 0),  /* stat */
      JEQ(6, 60, 0),  /* lstat */
      JEQ(332, 59, 0),  /* statx */
      JEQ(21, 58, 0),  /* access */
      JEQ(269, 57, 0),  /* faccessat */
      JEQ(439, 56, 0),  /* faccessat2 */
      JEQ(262, 55, 0),  /* newfstatat */
      JEQ(87, 54, 0),  /* unlink */
      JEQ(263, 53, 0),  /* unlinkat */
      JEQ(83, 52, 0),  /* mkdir */
      JEQ(258, 51, 0),  /* mkdirat */
      JEQ(84, 50, 0),  /* rmdir */
      JEQ(82, 49, 0),  /* rename */
      JEQ(264, 48, 0),  /* renameat */
      JEQ(316, 47, 0),  /* renameat2 */
      JEQ(89, 46, 0),  /* readlink */
      JEQ(267, 45, 0),  /* readlinkat */
      JEQ(80, 44, 0),  /* chdir */
      JEQ(79, 43, 0),  /* getcwd */
      JEQ(76, 42, 0),  /* truncate */
      JEQ(33, 41, 0),  /* dup2 */
      JEQ(292, 40, 0),  /* dup3 */
      JEQ(40, 39, 0),  /* sendfile */
      JEQ(131, 38, 0),  /* sigaltstack */
      JEQ(97, 37, 0),  /* getrlimit */
      JEQ(160, 36, 0),  /* setrlimit */
      JEQ(302, 35, 0),  /* prlimit64 */
      JEQ(282, 34, 0),  /* signalfd */
      JEQ(289, 33, 0),  /* signalfd4 */
      JEQ(275, 32, 0),  /* splice */
      JEQ(276, 31, 0),  /* tee */
      JEQ(253, 30, 0),  /* inotify_init */
      JEQ(294, 29, 0),  /* inotify_init1 */
      JEQ(254, 28, 0),  /* inotify_add_watch */
      JEQ(255, 27, 0),  /* inotify_rm_watch */
      JEQ(47, 13, 0),  /* recvmsg */
      JEQ(56, 15, 0),  /* clone */
      JGE(41, 0, 25),  /* socket */
      JGE(60, 24, 23),  /* clone_end */
      LD(BPF_ARG0),
      JGE(SHIM_IPC_LOW, 0, 1),
      JGE((SHIM_IPC_FD + 1), 0, 21),
      JEQ(0, 19, 0),  /* read */
      JGE(SHIM_VFD_BASE, 18, 19),
      LD(BPF_ARG0),
      JGE(SHIM_IPC_LOW, 0, 1),
      JGE((SHIM_IPC_FD + 1), 0, 16),
      JGE(3, 0, 14),  /* close */
      JGE(SHIM_VFD_BASE, 13, 14),
      LD(BPF_ARG0),
      JGE(SHIM_IPC_LOW, 0, 11),
      JGE((SHIM_IPC_FD + 1), 10, 11),
      LD(BPF_ARG0),
      JSET(65536, 9, 8),  /* CLONE_THREAD */
      LD(BPF_ARG0),
      JGE(SHIM_IPC_LOW, 0, 4),
      JGE((SHIM_IPC_FD + 1), 3, 5),
      LD(BPF_ARG4),
      JGE(0, 1, 1),  /* read */
      LD(BPF_ARG0),
      JGE(SHIM_VFD_BASE, 0, 2),
      JGE(4294963200, 1, 0),
      RET(SECCOMP_RET_TRAP),
      RET(SECCOMP_RET_ALLOW),
  };
  struct sock_filter prog_audit[] = {  /* 133 instructions */
      LD(BPF_ARCHF),
      JEQ(AUDIT_ARCH_X86_64, 0, 130),
      LD(BPF_IPHI),
      JEQ((uint32_t)((uintptr_t)SHIM_GADGET_ADDR >> 32), 0, 3),
      LD(BPF_IPLO),
      JGE((uint32_t)(uintptr_t)SHIM_GADGET_ADDR, 0, 1),
      JGE(((uint32_t)(uintptr_t)SHIM_GADGET_ADDR + 4096), 0, 125),
      LD(BPF_NR),
      JEQ(15, 123, 0),
      JEQ(0, 98, 0),  /* read */
      JEQ(1, 102, 0),  /* write */
      JEQ(3, 111, 0),  /* close */
      JEQ(19, 95, 0),  /* readv */
      JEQ(20, 99, 0),  /* writev */
      JEQ(16, 113, 0),  /* ioctl */
      JEQ(72, 112, 0),  /* fcntl */
      JEQ(32, 111, 0),  /* dup */
      JEQ(5, 110, 0),  /* fstat */
      JEQ(8, 109, 0),  /* lseek */
      JEQ(217, 108, 0),  /* getdents64 */
      JEQ(77, 107, 0),  /* ftruncate */
      JEQ(74, 106, 0),  /* fsync */
      JEQ(75, 105, 0),  /* fdatasync */
      JEQ(81, 104, 0),  /* fchdir */
      JEQ(17, 103, 0),  /* pread64 */
      JEQ(18, 102, 0),  /* pwrite64 */
      JEQ(9, 99, 0),  /* mmap */
      JEQ(35, 103, 0),  /* nanosleep */
      JEQ(230, 102, 0),  /* clock_nanosleep */
      JEQ(228, 101, 0),  /* clock_gettime */
      JEQ(96, 100, 0),  /* gettimeofday */
      JEQ(201, 99, 0),  /* time */
      JEQ(318, 98, 0),  /* getrandom */
      JEQ(7, 97, 0),  /* poll */
      JEQ(271, 96, 0),  /* ppoll */
      JEQ(213, 95, 0),  /* epoll_create */
      JEQ(291, 94, 0),  /* epoll_create1 */
      JEQ(233, 93, 0),  /* epoll_ctl */
      JEQ(232, 92, 0),  /* epoll_wait */
      JEQ(281, 91, 0),  /* epoll_pwait */
      JEQ(288, 90, 0),  /* accept4 */
      JEQ(435, 89, 0),  /* clone3 */
      JEQ(39, 88, 0),  /* getpid */
      JEQ(110, 87, 0),  /* getppid */
      JEQ(186, 86, 0),  /* gettid */
      JEQ(283, 85, 0),  /* timerfd_create */
      JEQ(286, 84, 0),  /* timerfd_settime */
      JEQ(287, 83, 0),  /* timerfd_gettime */
      JEQ(284, 82, 0),  /* eventfd */
      JEQ(290, 81, 0),  /* eventfd2 */
      JEQ(202, 80, 0),  /* futex */
      JEQ(14, 79, 0),  /* rt_sigprocmask */
      JEQ(22, 78, 0),  /* pipe */
      JEQ(293, 77, 0),  /* pipe2 */
      JEQ(61, 76, 0),  /* wait4 */
      JEQ(231, 75, 0),  /* exit_group */
      JEQ(436, 74, 0),  /* close_range */
      JEQ(23, 73, 0),  /* select */
      JEQ(270, 72, 0),  /* pselect6 */
      JEQ(62, 71, 0),  /* kill */
      JEQ(63, 70, 0),  /* uname */
      JEQ(100, 69, 0),  /* times */
      JEQ(229, 68, 0),  /* clock_getres */
      JEQ(204, 67, 0),  /* sched_getaffinity */
      JEQ(99, 66, 0),  /* sysinfo */
      JEQ(98, 65, 0),  /* getrusage */
      JEQ(2, 64, 0),  /* open */
      JEQ(257, 63, 0),  /* openat */
      JEQ(85, 62, 0),  /* creat */
      JEQ(4, 61, 0),  /* stat */
      JEQ(6, 60, 0),  /* lstat */
      JEQ(332, 59, 0),  /* statx */
      JEQ(21, 58, 0),  /* access */
      JEQ(269, 57, 0),  /* faccessat */
      JEQ(439, 56, 0),  /* faccessat2 */
      JEQ(262, 55, 0),  /* newfstatat */
      JEQ(87, 54, 0),  /* unlink */
      JEQ(263, 53, 0),  /* unlinkat */
      JEQ(83, 52, 0),  /* mkdir */
      JEQ(258, 51, 0),  /* mkdirat */
      JEQ(84, 50, 0),  /* rmdir */
      JEQ(82, 49, 0),  /* rename */
      JEQ(264, 48, 0),  /* renameat */
      JEQ(316, 47, 0),  /* renameat2 */
      JEQ(89, 46, 0),  /* readlink */
      JEQ(267, 45, 0),  /* readlinkat */
      JEQ(80, 44, 0),  /* chdir */
      JEQ(79, 43, 0),  /* getcwd */
      JEQ(76, 42, 0),  /* truncate */
      JEQ(33, 41, 0),  /* dup2 */
      JEQ(292, 40, 0),  /* dup3 */
      JEQ(40, 39, 0),  /* sendfile */
      JEQ(131, 38, 0),  /* sigaltstack */
      JEQ(97, 37, 0),  /* getrlimit */
      JEQ(160, 36, 0),  /* setrlimit */
      JEQ(302, 35, 0),  /* prlimit64 */
      JEQ(282, 34, 0),  /* signalfd */
      JEQ(289, 33, 0),  /* signalfd4 */
      JEQ(275, 32, 0),  /* splice */
      JEQ(276, 31, 0),  /* tee */
      JEQ(253, 30, 0),  /* inotify_init */
      JEQ(294, 29, 0),  /* inotify_init1 */
      JEQ(254, 28, 0),  /* inotify_add_watch */
      JEQ(255, 27, 0),  /* inotify_rm_watch */
      JEQ(47, 13, 0),  /* recvmsg */
      JEQ(56, 15, 0),  /* clone */
      JGE(41, 0, 24),  /* socket */
      JGE(60, 23, 23),  /* clone_end */
      LD(BPF_ARG0),
      JGE(SHIM_IPC_LOW, 0, 1),
      JGE((SHIM_IPC_FD + 1), 0, 21),
      JEQ(0, 19, 0),  /* read */
      JGE(SHIM_VFD_BASE, 18, 18),
      LD(BPF_ARG0),
      JGE(SHIM_IPC_LOW, 0, 1),
      JGE((SHIM_IPC_FD + 1), 0, 16),
      JGE(3, 0, 14),  /* close */
      JGE(SHIM_VFD_BASE, 13, 13),
      LD(BPF_ARG0),
      JGE(SHIM_IPC_LOW, 0, 11),
      JGE((SHIM_IPC_FD + 1), 10, 11),
      LD(BPF_ARG0),
      JSET(65536, 9, 8),  /* CLONE_THREAD */
      LD(BPF_ARG0),
      JGE(SHIM_IPC_LOW, 0, 4),
      JGE((SHIM_IPC_FD + 1), 3, 5),
      LD(BPF_ARG4),
      JGE(0, 1, 1),  /* read */
      LD(BPF_ARG0),
      JGE(SHIM_VFD_BASE, 0, 1),
      JGE(4294963200, 0, 0),
      RET(SECCOMP_RET_TRAP),
      RET(SECCOMP_RET_ALLOW),
  };
  /* END GENERATED BPF */
  struct sock_fprog fprog = {sizeof(prog) / sizeof(prog[0]), prog};
  struct sock_fprog fprog_audit = {
      sizeof(prog_audit) / sizeof(prog_audit[0]), prog_audit};
  if (prctl(PR_SET_NO_NEW_PRIVS, 1, 0, 0, 0) != 0) return -1;
  return (int)prctl(PR_SET_SECCOMP, SECCOMP_MODE_FILTER,
                    shim_audit_on ? &fprog_audit : &fprog);
}

/* ---- constructor -------------------------------------------------------- */

__attribute__((constructor)) static void shim_init(void) {
  const char *on = getenv("SHADOW_SHIM");
  if (!on || on[0] != '1') return; /* not under the simulator */
  /* THE GADGET PAGE COMES FIRST: after an execve the previous image's
   * seccomp filter is already live, and it traps file syscalls like the
   * open(2) below — but it ALLOWS any syscall issued from the fixed
   * gadget address, so mapping the gadget (mmap/mprotect are untrapped)
   * and routing raw syscalls through it makes the rest of this ctor
   * filter-proof. */
  shim_map_gadget(); /* shim_gadget stays NULL on failure: raw syscalls
                        fall back to the inline-asm path */
  /* real ids from /proc, NOT raw getpid (trapped: returns vpids) */
  shim_refresh_real_ids();

  const char *shm = getenv("SHADOW_TIME_SHM");
  if (shm) {
    /* RW: the shim reads the clock AND writes the fast-op counter slot
     * (shring.h SHIM_PAGE_FASTOPS). Falls back to RO (counter writes
     * gated on shim_page_rw) if the worker ever hands a sealed fd. */
    int fd = open(shm, O_RDWR);
    if (fd >= 0) {
      void *p = mmap(NULL, 4096, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
      if (p != MAP_FAILED) {
        shim_time_page = (volatile int64_t *)p;
        shim_page_rw = 1;
      }
      close(fd);
    }
    if (!shim_time_page) {
      fd = open(shm, O_RDONLY);
      if (fd >= 0) {
        void *p = mmap(NULL, 4096, PROT_READ, MAP_SHARED, fd, 0);
        if (p != MAP_FAILED) shim_time_page = (volatile int64_t *)p;
        close(fd);
      }
    }
  }

  struct sigaction sa;
  memset(&sa, 0, sizeof sa);
  sa.sa_sigaction = sigsys_handler;
  sa.sa_flags = SA_SIGINFO | SA_NODEFER;
  sigemptyset(&sa.sa_mask);
  if (sigaction(SIGSYS, &sa, NULL) != 0) _exit(124);

  /* TSC virtualization: raw rdtsc/rdtscp fault into sigsegv_handler and
   * read simulated time. Best-effort — PR_SET_TSC is x86-64-specific. */
  struct sigaction tsa;
  memset(&tsa, 0, sizeof tsa);
  tsa.sa_sigaction = sigsegv_handler;
  /* SA_ONSTACK: harmless without an altstack, required so guests that
   * sigaltstack() for stack-overflow recovery still get their handler */
  tsa.sa_flags = SA_SIGINFO | SA_ONSTACK;
  sigemptyset(&tsa.sa_mask);
  if (sigaction(SIGSEGV, &tsa, NULL) == 0)
    prctl(PR_SET_TSC, PR_TSC_SIGSEGV, 0, 0, 0);

  /* the gadget is now LOAD-BEARING (fork replay, RETRY_NATIVE
   * re-issues, audit): without it those paths would re-trap and corrupt
   * the worker protocol — fail loudly instead of running degraded */
  if (shim_gadget == NULL) _exit(122);
  const char *audit = getenv("SHADOW_AUDIT");
  shim_audit_on = audit && audit[0] == '1';

  shim_active = 1;
  shim_tls_ready = 1;
  /* handshake: block until the simulation's spawn event grants the turn */
  if (forward(SHIM_HELLO, (uint64_t)getpid(), 0, 0, 0, 0, 0) != 0) _exit(124);
  if (install_seccomp() != 0) _exit(123);
}
