/* shring.h — the shared-memory ring (worker <-> guest shim).
 *
 * Reference analog: upstream Shadow's shared-memory data channel
 * (SURVEY.md §2 "Shmem allocator" / shim-side syscall service, §3.3
 * latency budget): the byte buffer behind an emulated pipe OR an
 * ESTABLISHED stream socket lives in a memfd mapped into BOTH the Python
 * worker and the guest process, so the shim services non-blocking
 * reads/writes entirely locally — zero worker round trips — and only
 * blocking edges (empty read, over-budget write, errors) forward to the
 * worker.
 *
 * Concurrency: none needed. Strict turn-taking means exactly one of
 * {worker, any guest thread} runs at any instant, globally; all fields
 * are plain loads/stores (volatile keeps the compiler honest across the
 * blocking boundaries).
 *
 * Layout: one 4 KiB header page + cap data bytes. rpos/wpos are
 * free-running u64 byte counters (data index = pos % cap). cap is a
 * power of two chosen by the worker: SHRING_CAP for pipes, the
 * connection's next_pow2(max(recv_buffer, send_buffer)) for sockets.
 */
#ifndef SHRING_H
#define SHRING_H

#include <stddef.h>
#include <stdint.h>

#define SHRING_MAGIC 0x53524E47u /* "SRNG" */
#define SHRING_CAP 65536
#define SHRING_PIPE_BUF 4096 /* POSIX atomic-write bound (worker twin) */
/* parameterized caps: any power of two in [MIN, MAX] is a valid ring */
#define SHRING_CAP_MIN 4096
#define SHRING_CAP_MAX (1 << 24)

/* flags bits (worker-written; shim read-only) */
#define SHRING_F_HUP 1u  /* peer closed / EOF once drained (sockets) */
#define SHRING_F_ERR 2u  /* socket error pending: shim must forward */
#define SHRING_F_SOCK 4u /* ring backs a stream socket, not a pipe */

struct shring {
  volatile uint32_t magic;
  volatile uint32_t cap; /* power of two (layout check + modulo base) */
  volatile uint64_t rpos;
  volatile uint64_t wpos;
  /* maintained by the worker (end refcounts; EPIPE/EOF decisions) */
  volatile uint32_t readers;
  volatile uint32_t writers;
  /* worker sets when a thread/poller parks on this pipe; the shim then
   * marks dirty on every local op so the worker's wake scan is O(dirty) */
  volatile uint32_t has_waiters;
  volatile uint32_t dirty;
  /* worker gate: 0 disables shim-local service (strace mode,
   * model_unblocked_syscall_latency, overflow fallback, teardown) */
  volatile uint32_t fast_ok;
  volatile uint32_t flags; /* SHRING_F_* */
  /* shim-local ops on THIS ring (worker folds into per-pipe stats) */
  volatile uint64_t shim_ops;
  /* TX-role socket rings only: sender budget = send_buffer - buffered,
   * refreshed by the worker before every service reply (the TX ring is
   * drained by the fold that precedes servicing, so the budget is exact
   * for the whole guest turn — transport state is frozen mid-turn). */
  volatile uint64_t wbudget;
};

/* worker-twin offsets (shadow_tpu/native/managed.py packs by these) */
#define SHRING_OFF_MAGIC 0
#define SHRING_OFF_CAP 4
#define SHRING_OFF_RPOS 8
#define SHRING_OFF_WPOS 16
#define SHRING_OFF_READERS 24
#define SHRING_OFF_WRITERS 28
#define SHRING_OFF_HAS_WAITERS 32
#define SHRING_OFF_DIRTY 36
#define SHRING_OFF_FAST_OK 40
#define SHRING_OFF_FLAGS 44
#define SHRING_OFF_SHIM_OPS 48
#define SHRING_OFF_WBUDGET 56

_Static_assert(offsetof(struct shring, magic) == SHRING_OFF_MAGIC, "abi");
_Static_assert(offsetof(struct shring, cap) == SHRING_OFF_CAP, "abi");
_Static_assert(offsetof(struct shring, rpos) == SHRING_OFF_RPOS, "abi");
_Static_assert(offsetof(struct shring, wpos) == SHRING_OFF_WPOS, "abi");
_Static_assert(offsetof(struct shring, readers) == SHRING_OFF_READERS, "abi");
_Static_assert(offsetof(struct shring, writers) == SHRING_OFF_WRITERS, "abi");
_Static_assert(offsetof(struct shring, has_waiters) == SHRING_OFF_HAS_WAITERS,
               "abi");
_Static_assert(offsetof(struct shring, dirty) == SHRING_OFF_DIRTY, "abi");
_Static_assert(offsetof(struct shring, fast_ok) == SHRING_OFF_FAST_OK, "abi");
_Static_assert(offsetof(struct shring, flags) == SHRING_OFF_FLAGS, "abi");
_Static_assert(offsetof(struct shring, shim_ops) == SHRING_OFF_SHIM_OPS,
               "abi");
_Static_assert(offsetof(struct shring, wbudget) == SHRING_OFF_WBUDGET, "abi");

#define SHRING_HDR 4096
#define SHRING_SIZE (SHRING_HDR + SHRING_CAP)
#define SHRING_DATA(h) ((volatile uint8_t *)(h) + SHRING_HDR)

/* -- clock-page extension (the per-process 4 KiB SHADOW_TIME_SHM map) --
 *
 * u64 words (worker twin: shadow_tpu/native/managed.py):
 *   [0] emulated wall ns   [1] virtual pid (native/identity.py)
 *   [2] shim-local fast-op total (worker folds the delta into the
 *       "syscalls" + "shim_fast_syscalls" counters)
 *   [3] worker fold cursor for [2]
 *   [4] flags: bit0 = fast plane enabled (worker-written at page birth;
 *       0 under strace mode, model_unblocked_syscall_latency, or the
 *       SHADOW_TPU_SHIM_FASTPATH=0 escape hatch)
 *   [5..9] per-class fast-op counts (shim increments, worker reads then
 *       zeroes at fold): time, identity, ring read, ring write, readiness
 *   [15] oplog entry count (shim appends, worker zeroes after replay)
 *
 * bytes [256..1024): per-vfd readiness bytes, index = vfd - SHIM_VFD_BASE
 *   (worker publishes for WATCHED, non-ring-backed vfds only; the shim
 *   computes ring-backed fds' readiness from live ring state instead).
 *
 * bytes [1024..4088): socket-ring oplog — one u64 per in-shim socket op,
 *   low 32 bits = byte count, high 32 = (op << 24) | (vfd - VFD_BASE);
 *   op 1 = RECV (ring consume), 2 = SEND (ring append). The worker
 *   replays these IN ORDER at the next fold so the simulated transport
 *   sees the exact slow-path call sequence. A full oplog forces the shim
 *   to forward (never drop an entry).
 */
#define SHIM_PAGE_FASTOPS 2
#define SHIM_PAGE_CURSOR 3
#define SHIM_PAGE_FLAGS 4
#define SHIM_PAGE_CLS_TIME 5
#define SHIM_PAGE_CLS_IDENT 6
#define SHIM_PAGE_CLS_RING_R 7
#define SHIM_PAGE_CLS_RING_W 8
#define SHIM_PAGE_CLS_READY 9
#define SHIM_PAGE_OPLOG_N 15

#define SHIM_PAGE_F_FAST 1u

#define SHIM_READY_OFF 256
#define SHIM_READY_LEN 768
#define SHIM_READY_VALID 1u
#define SHIM_READY_IN 2u
#define SHIM_READY_OUT 4u
#define SHIM_READY_HUP 8u
#define SHIM_READY_ERR 16u

#define SHIM_OPLOG_OFF 1024
#define SHIM_OPLOG_MAX 383 /* (4088 - 1024) / 8 */
#define SHIM_OP_RECV 1
#define SHIM_OP_SEND 2

#endif /* SHRING_H */
